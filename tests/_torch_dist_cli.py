"""The training CLI under ``torchrun``, for the tests (torch and numpy only:
no JAX, so the card machine runs it too).

As a script, one rank of a run:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/_torch_dist_cli.py LOG ARGV...

runs ``repro_torch.launch.train.main(ARGV)`` on this rank (the process
group from ``torchrun``'s environment, the ``env://`` branch of
``launch.mesh.init_distributed``) under
``torch.use_deterministic_algorithms(True)``, and appends every file the
rank writes -- each checkpoint commit and each ``numpy.save`` outside a
checkpoint's temporary directory -- to ``LOG.<rank>``, one path a line.
Exits with ``main``'s code.

As a module: ``Torchrun`` starts such a run (or ``python -m <module>``
under ``torchrun``, as a user types it), and ``check_trees`` /
``check_merged`` hold two runs' checkpoints against each other.
"""

import os
import sys

import numpy as np

from repro_torch.launch.torchrun import Child, child_env, torchrun_argv

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

G_FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors")
#: the global (g, opt) tree's leaves in the checkpoints' order
LEAVES = (G_FIELDS + ("active", "owner")
          + tuple(f"m_{k}" for k in sorted(G_FIELDS))
          + tuple(f"v_{k}" for k in sorted(G_FIELDS))
          + ("step", "grad_accum", "grad_count"))
EXACT = ("active", "owner", "step", "grad_count")


class Torchrun:
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc`` started at once (``launch.torchrun.Child``): of this file as the
    rank script (``log`` the write log's prefix), or with ``module`` of
    ``python -m module``; ``wait()`` -> (its standard output, the files each
    rank wrote, or None with ``module``).  A run past ``timeout`` seconds is
    stopped with its ranks; a non-zero exit raises."""

    def __init__(self, argv, *, nproc=2, log=None, module=None,
                 timeout=150.0):
        self.log, self.nproc = log, nproc
        entry = ["-m", module] if module else [os.path.abspath(__file__),
                                                log]
        self.child = Child(torchrun_argv(nproc, entry + list(argv)),
                           env=child_env(SRC), timeout=timeout)

    def kill(self):
        self.child.kill()

    def wait(self):
        out = self.child.wait()
        if self.log is None:
            return out, None
        writes = []
        for r in range(self.nproc):
            with open(f"{self.log}.{r}") as f:
                writes.append(f.read().split())
        return out, writes


def leaves(d):
    names = sorted(f for f in os.listdir(d) if f.startswith("arr_"))
    return [np.load(os.path.join(d, f)) for f in names]


def global_tree(root, step):
    """``fit_partitions``' global (P, N) checkpoint at ``step`` -> {leaf:
    array}."""
    arrs = leaves(os.path.join(root, f"step_{step:09d}"))
    assert len(arrs) == len(LEAVES)
    return dict(zip(LEAVES, arrs))


def check_share(name, dev, tol, share):
    assert np.mean(dev <= tol) >= share, (name, tol, np.sort(dev.ravel())[
        -10:])


def check_field(name, got, want, lr, steps, tol, share):
    """Every component within 2 * steps * lr (Adam's near-unit steps), the
    share ``share`` of them within ``tol``."""
    dev = np.abs(got.astype(np.float64) - want)
    assert dev.max() <= 2 * steps * lr, (name, dev.max())
    check_share(name, dev, tol, share)


def check_trees(got, want, lrs, steps, *, field_tol, field_share,
                moment_tol=None, moment_share=None):
    """Two global (P, N) trees: ``got`` on a mesh whose "part" size padded
    N past ``want``'s (the slots past it must be dead), ``want`` from world
    1.  The exact leaves equal, the trained fields by ``check_field``, the
    moments and densify sums (when ``moment_tol`` is given) the share
    ``moment_share`` within ``moment_tol`` of the field's largest
    magnitude."""
    n = want["means"].shape[1]
    assert not got["active"][:, n:].any(), "a padding slot went live"
    for name in LEAVES:
        x, y = got[name], want[name]
        if x.ndim >= 2:
            x = x[:, :n]
        assert x.shape == y.shape, (name, x.shape, y.shape)
        if name in EXACT:
            np.testing.assert_array_equal(x, y, err_msg=name)
        elif name in G_FIELDS:
            check_field(name, x, y, lrs[name], steps, field_tol, field_share)
        elif moment_tol is not None:
            check_share(name, np.abs(x.astype(np.float64) - y),
                        moment_tol * float(np.abs(y).max()), moment_share)


def check_merged(got_root, want_root, step, lrs, steps, *, field_tol,
                 field_share):
    """Two merged checkpoints: the same live splats and owners, each
    trained field by ``check_field``."""
    path = os.path.join("merged", f"step_{step:09d}")
    got, want = (dict(zip(G_FIELDS + ("active", "owner"),
                          leaves(os.path.join(r, path))))
                 for r in (got_root, want_root))
    np.testing.assert_array_equal(got["owner"][got["active"]],
                                  want["owner"][want["active"]])
    for name in G_FIELDS:
        check_field(name, got[name][got["active"]],
                    want[name][want["active"]], lrs[name], steps, field_tol,
                    field_share)


def _main(log, argv):
    import torch

    from repro_torch.launch import train
    from repro_torch.runtime.checkpoint import CheckpointManager

    path = f"{log}.{os.environ['RANK']}"
    open(path, "w").close()

    def note(p):
        with open(path, "a") as f:
            f.write(os.path.abspath(str(p)) + "\n")

    real_commit, real_save = CheckpointManager._commit, np.save

    def commit(tmp, final, manifest):
        note(final)
        return real_commit(tmp, final, manifest)

    def save(file, *a, **k):
        if ".tmp" not in os.path.dirname(str(file)):
            note(file)
        return real_save(file, *a, **k)

    CheckpointManager._commit = staticmethod(commit)
    np.save = save
    torch.use_deterministic_algorithms(True)
    return train.main(argv)


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1], sys.argv[2:]))
