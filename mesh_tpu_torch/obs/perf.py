"""Wedge-proof primitives of the perf harness (the first part of
mesh_tpu/obs/perf.py): ``call_with_timeout``, which bounds a call that may
never return by running it on an abandoned-if-stuck helper thread (the
serving ladder's rung attempts go through it), and ``reap_child``, the
escalating child-process teardown that never blocks on a pipe.

The reference's staged bench harness (``StageSpec``, ``run_stages``,
``bench_partial.json``) and its ``perfcheck`` regression gate are not
ported yet (ROADMAP.md, Queue 1).  Stdlib-only.
"""

import threading
import time

from ..errors import DeadlineExceeded
from .clock import monotonic

__all__ = ["call_with_timeout", "reap_child"]


def call_with_timeout(fn, timeout):
    """Run ``fn()`` on a daemon helper thread, waiting at most
    ``timeout`` seconds.  Raises DeadlineExceeded on timeout — the stuck
    thread is abandoned, not joined, because the whole point is that a
    wedged device call may never return.

    (serve/deadline.py re-exports it: the serving ladder's rung attempts
    run through this one wedge-proof primitive.)
    """
    box = {}
    done = threading.Event()

    def _run():
        try:
            box["result"] = fn()
        except BaseException as e:     # noqa: BLE001 — re-raised below
            box["error"] = e
        finally:
            done.set()

    worker = threading.Thread(target=_run, name="mesh-tpu-attempt",
                              daemon=True)
    worker.start()
    if not done.wait(timeout=max(float(timeout), 0.0)):
        raise DeadlineExceeded(
            "rung call still running after %.3fs slice" % timeout)
    if "error" in box:
        raise box["error"]
    return box["result"]


def reap_child(proc, term_grace_s=3.0, kill_grace_s=10.0,
               clock=monotonic, sleep=time.sleep):
    """Escalating child teardown that can never block the caller:
    SIGTERM -> bounded poll -> SIGKILL -> bounded poll -> abandon.

    Every wait is ``poll()`` (WNOHANG — it also reaps the zombie);
    nothing here reads a pipe, because a pipe held open by a wedged
    child (or its grandchild) is exactly what made the old
    ``kill(); communicate(timeout=10)`` teardown block.  Returns
    ``"terminated"`` / ``"killed"`` / ``"abandoned"`` — abandoned means
    the child survived SIGKILL (uninterruptible device I/O); the caller
    moves on and init never blocks on it again.
    """
    if proc.poll() is not None:
        return "terminated"
    try:
        proc.terminate()
    except OSError:
        pass
    deadline = clock() + term_grace_s
    while clock() < deadline:
        if proc.poll() is not None:
            return "terminated"
        sleep(0.05)
    try:
        proc.kill()
    except OSError:
        pass
    deadline = clock() + kill_grace_s
    while clock() < deadline:
        if proc.poll() is not None:
            return "killed"
        sleep(0.05)
    return "abandoned"
