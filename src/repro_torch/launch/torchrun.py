"""A program started as a child process and stopped with everything it
started: the training CLI under ``torchrun``, one process a card, as a user
launches it, or ``serve_gs`` on one card.

    out = Child(torchrun_argv(4, ["-m", "repro_torch.launch.train", "--gs",
                                  ...]), env=child_env(src)).wait()

``wait`` returns the child's standard output; a non-zero exit raises with
the tails of its output, and a child past its timeout is stopped and
``subprocess.TimeoutExpired`` raised.  ``torchrun`` puts each rank in a
session of its own, so stopping the launcher's process group alone would
leave the ranks running, holding the pipes until their group's timeout:
``kill`` sends SIGTERM to ``torchrun`` first, which stops its ranks, then
SIGKILL to whatever is left of its group.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Optional, Sequence

#: the variables ``torchrun`` sets for a rank: a child started from inside
#: a rank must not join that rank's group
RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
             "MASTER_PORT")


def child_env(src: Optional[str] = None) -> dict:
    """This process's environment without ``RANK_VARS``, with ``src`` (a
    checkout's ``src`` directory) first on ``PYTHONPATH``."""
    env = {k: v for k, v in os.environ.items() if k not in RANK_VARS}
    if src:
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                                   if env.get("PYTHONPATH") else "")
    return env


def torchrun_argv(nproc: int, entry: Sequence[str]) -> list:
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc`` and ``entry`` (``["-m", module, ...]`` or a script and its
    arguments)."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(nproc)] + list(entry)


class Child:
    """``argv`` started at once in a session of its own, its output
    piped."""

    def __init__(self, argv: Sequence[str], *, env: Optional[dict] = None,
                 timeout: float = 600.0):
        self.argv, self.timeout = list(argv), timeout
        self.proc = subprocess.Popen(
            self.argv, env=child_env() if env is None else env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)

    def kill(self):
        """Stop the child: SIGTERM (``torchrun`` stops its ranks on it),
        then SIGKILL to whatever is left of its process group."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.communicate()

    def wait(self) -> str:
        """-> the child's standard output, once it has exited 0."""
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise
        if self.proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(self.argv)} exited {self.proc.returncode}\n"
                f"--- its output's tail\n{out[-3000:]}\n"
                f"--- its errors' tail\n{err[-6000:]}")
        return out
