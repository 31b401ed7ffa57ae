"""Shared by the tooling parity tests (``test_torch_cost_analysis.py``,
``test_torch_dryrun.py``): the reference's dry-run module, imported so that
it cannot change this process's devices."""

import os

import jax


def reference_dryrun():
    """``repro.launch.dryrun``.  Importing it sets ``XLA_FLAGS`` to 512
    forced host devices (for its own CLI): JAX's backend is started first,
    so the flag cannot take effect here, and the variable is restored, so
    it cannot reach a later process either."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun
