"""Start a world of ranks on one host, each a fresh interpreter.

The counterpart of ``torchrun --standalone`` for tests and smoke runs:
:func:`run_ranks` starts ``world`` processes of ``python argv...``, each
told its rank through torchrun's environment variables (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and bounds their
lifetime: a rank that fails or a deadline that passes kills the whole
world, so no rank is left waiting in a collective.  A rank joins with::

    initialize_distributed(f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ['MASTER_PORT']}",
                           int(os.environ["WORLD_SIZE"]),
                           int(os.environ["RANK"]))
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

__all__ = ["free_port", "run_ranks"]


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port no process listens on now (the OS picks it)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def run_ranks(world: int, argv, *, timeout: float, env=None,
              cwd=None) -> list:
    """Run ``python *argv`` as ranks 0 .. world - 1 and return each
    rank's output (stdout and stderr together).

    Raises ``RuntimeError`` with the end of every rank's output when a
    rank exits non-zero or ``timeout`` seconds pass; either way every
    rank still running is killed with its process group, here or on any
    other exit from this function."""
    env = dict(os.environ if env is None else env, WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = []
        try:
            for r, log in enumerate(logs):
                procs.append(subprocess.Popen(
                    [sys.executable, *map(str, argv)], cwd=cwd,
                    env=dict(env, RANK=str(r)),
                    stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
            deadline = time.monotonic() + timeout
            failed = None
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {codes[bad[0]]}"
                elif None not in codes:
                    break
                elif time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout} s"
                if failed:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    try:
                        os.killpg(p.pid, signal.SIGKILL)
                    except ProcessLookupError:   # exited meanwhile
                        pass
                    p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    if failed is not None:
        tails = "\n".join(f"--- rank {r} ---\n{out[-4000:]}"
                          for r, out in enumerate(outs))
        raise RuntimeError(f"run_ranks: {failed}\n{tails}")
    return outs
