"""Timing / profiling utilities (counterpart of mesh_tpu/utils/profiling.py).

Four pieces:

- ``host_sync(tree)``: wait for the CUDA work behind every tensor in a
  nested structure (dicts, lists, tuples): each card that holds one is
  synchronized once; CPU tensors and plain values are left alone.  The
  reference reads each JAX leaf back to the host instead.
- ``Timer``: a wall-clock context manager with optional sync on exit.
- ``time_fn(fn, ...)``: warmup + N pipelined repetitions with one final
  sync, the measurement loop of a benchmark.
- ``trace(log_dir)``: ``torch.profiler.profile`` with CPU and (where a
  card is present) CUDA activities, writing a Chrome trace into
  ``log_dir``.
"""

import contextlib
import itertools
import os
import time

import torch

__all__ = ["host_sync", "Timer", "time_fn", "trace"]


def _leaves(out):
    if isinstance(out, dict):
        for value in out.values():
            yield from _leaves(value)
    elif isinstance(out, (list, tuple)):
        for value in out:
            yield from _leaves(value)
    else:
        yield out


def host_sync(out):
    """Wait until every CUDA tensor in ``out`` is computed.

    Returns ``out`` unchanged, so it can wrap a call site inline:
    ``res = host_sync(fn(x))``.
    """
    devices = {leaf.device for leaf in _leaves(out)
               if torch.is_tensor(leaf) and leaf.device.type == "cuda"}
    for device in sorted(devices, key=str):
        torch.cuda.synchronize(device)
    return out


class Timer:
    """Wall-clock timer context manager.

    >>> with Timer("normals") as t:
    ...     out = t.watch(vert_normals(v, f))
    >>> t.elapsed  # seconds; sync=True (default) syncs `out` via t.watch

    ``elapsed`` is recorded even when the body raises (sync is skipped
    then — the watched output may be half-built), so a timing harness
    around flaky device code never reads back ``None``.  On success
    ``sync_elapsed`` holds the sync share of ``elapsed``: the
    launch-vs-device split the span tracer reports.
    """

    def __init__(self, name="", sync=True, log=None):
        self.name = name
        self.sync = sync
        self.log = log
        self.elapsed = None
        self.sync_elapsed = None
        self._watched = None

    def watch(self, out):
        """Register values to sync before the clock stops."""
        self._watched = out
        return out

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None and self.sync and self._watched is not None:
            t_sync = time.perf_counter()
            host_sync(self._watched)
            self.sync_elapsed = time.perf_counter() - t_sync
        self.elapsed = time.perf_counter() - self._t0
        if self.log is not None:
            self.log("%s: %.3f ms" % (self.name or "timer", self.elapsed * 1e3))
        return False


def time_fn(fn, reps=10, warmup=1):
    """Average seconds per call of ``fn()``.

    Runs ``warmup`` untimed calls (kernel builds, plan captures), then
    ``reps`` pipelined calls with a single sync at the end — the sync
    cost is amortized across the repetitions.  ``warmup=0`` measures
    cold start: the first timed call then includes the builds.
    """
    out = None
    for _ in range(warmup):
        out = fn()
    if warmup:
        host_sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    host_sync(out)
    return (time.perf_counter() - t0) / reps


_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block and write a Chrome trace (Perfetto /
    chrome://tracing) into ``log_dir``.

    Yields the ``torch.profiler.profile`` object; after the block its
    ``trace_path`` names the file written.

    >>> with trace("/tmp/torch-trace") as prof:
    ...     host_sync(workload())
    >>> prof.trace_path
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = os.fspath(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.trace_path = os.path.join(log_dir, "trace-%d-%d.json" % (
        os.getpid(), next(_TRACE_SEQ)))
    prof.export_chrome_trace(prof.trace_path)
