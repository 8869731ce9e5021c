"""Span tracer: nested, thread-aware spans over the serving hot path (a
copy of mesh_tpu/obs/trace.py, with its JAX hooks replaced by PyTorch's).

A span is one timed region with a name, attributes, and a parent — the
enclosing span on the SAME thread, or, for a span opened with an empty
stack under a bound request context, the request's root span.

Spans record wall time and, separately, device-sync time: ``watch(out)``
registers a tensor (or a dict, list or tuple of tensors) whose CUDA
devices are synchronized (``torch.cuda.synchronize``) just before the span
closes, with the sync cost reported as ``sync_elapsed``.

Gate: ``MESH_TPU_OBS`` (obs/clock.enabled).  Off — the default — means
``span()`` returns a shared no-op object: no allocation, no clock read,
no buffer append.

Finished spans land in a bounded in-memory ring (``TRACER.events()``)
and fan out to sinks: the trace tail (obs/context.py), the flight
recorder's ring (obs/recorder.py) and a JSON-lines file
(``MESH_TPU_OBS_JSONL=path`` or ``configure(jsonl=...)``, rotated past
``MESH_TPU_OBS_JSONL_MAX_MB``).  Under
``MESH_TPU_OBS_JAX_TRACE`` (the reference's knob name) each span also
opens a ``torch.profiler.record_function``, so a ``torch.profiler`` trace
shows the framework's phases on its timeline.

``timed_span`` is ``span`` that measures its elapsed time (device work
included, through ``watch``) even while tracing is off: the engine's
always-on dispatch latency reads it.  ``traced`` is the decorator form
of ``span``.
"""

import functools
import itertools
import json
import threading
from collections import deque

from .clock import enabled, env_flag, monotonic, wall
from .context import TRACE_TAIL, current_context

__all__ = [
    "Span", "Tracer", "TRACER", "span", "timed_span", "traced", "configure",
    "jsonl_sink", "device_sync",
]

#: torch.profiler.record_function bridge gate (adds real per-span cost on
#: the profiler timeline, so it is opt-in on top of MESH_TPU_OBS); the
#: reference's knob name
PROFILER_ENV = "MESH_TPU_OBS_JAX_TRACE"

#: default JSON-lines sink path gate
JSONL_ENV = "MESH_TPU_OBS_JSONL"

#: size bound (megabytes) on the live sink before rotation (unset = off)
JSONL_MAX_MB_ENV = "MESH_TPU_OBS_JSONL_MAX_MB"

#: rotated files kept as path.1..path.N (default 3)
JSONL_KEEP_ENV = "MESH_TPU_OBS_JSONL_KEEP"

_span_ids = itertools.count(1)


def _cuda_devices(out, found):
    """The CUDA devices of the tensors in ``out`` (a tensor, or a dict,
    list or tuple of them, nested), added to the set ``found``."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            _cuda_devices(item, found)
    elif getattr(out, "is_cuda", False):
        found.add(out.device)
    return found


def device_sync(out):
    """Wait for the work that produces ``out``: on each CUDA device holding
    one of its tensors, an event recorded on that device's current stream
    (where the tensors were made, or handed over to with a stream wait)
    and waited for.  Nothing device-wide: other streams' and threads' work
    is not waited for.  CPU tensors are ready when they are returned."""
    devices = _cuda_devices(out, set())
    if devices:
        import torch

        for device in devices:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            done.synchronize()


class Span(object):
    """One live traced region; use via ``with span("name", k=v) as sp:``."""

    __slots__ = (
        "name", "attrs", "span_id", "parent_id", "thread_name",
        "t_start", "wall_start", "elapsed", "sync_elapsed", "status",
        "_tracer", "_watched", "_prof_ctx",
    )

    def __init__(self, tracer, name, attrs):
        self.name = name
        self.attrs = attrs
        self.span_id = next(_span_ids)
        self.parent_id = None
        self.thread_name = None
        self.t_start = None
        self.wall_start = None
        self.elapsed = None
        self.sync_elapsed = None
        self.status = "ok"
        self._tracer = tracer
        self._watched = None
        self._prof_ctx = None

    def set(self, **attrs):
        """Attach/update attributes mid-span; returns self for chaining."""
        self.attrs.update(attrs)
        return self

    def watch(self, out):
        """Register tensors whose devices are synchronized before the span
        closes (the sync cost lands in ``sync_elapsed``).  Returns ``out`` unchanged
        so call sites can wrap a computation inline."""
        self._watched = out
        return out

    def __enter__(self):
        tracer = self._tracer
        stack = tracer._stack()
        ctx = current_context()
        if stack:
            self.parent_id = stack[-1].span_id
        elif ctx is not None and ctx.root_span_id is not None:
            # cross-thread linkage: a span opening with an empty stack
            # under a bound RequestContext parents under the request's
            # root span instead of rooting a per-thread forest
            self.parent_id = ctx.root_span_id
        if ctx is not None and "request_id" not in self.attrs:
            self.attrs["request_id"] = ctx.request_id
        stack.append(self)
        thread = threading.current_thread()
        self.thread_name = thread.name
        if env_flag(PROFILER_ENV):
            try:
                import torch

                self._prof_ctx = torch.profiler.record_function(self.name)
                self._prof_ctx.__enter__()
            except Exception:   # the bridge must never break the workload
                self._prof_ctx = None
        self.wall_start = wall()
        self.t_start = monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        t_end = monotonic()
        self.elapsed = t_end - self.t_start
        if exc_type is None and self._watched is not None:
            try:
                device_sync(self._watched)
            finally:
                t_sync = monotonic()
                self.sync_elapsed = t_sync - t_end
                self.elapsed = t_sync - self.t_start
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", exc_type.__name__)
        if self._prof_ctx is not None:
            try:
                self._prof_ctx.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:                  # unbalanced exit: be lenient
            stack.remove(self)
        self._tracer._finish(self)
        return False

    def to_dict(self):
        return {
            "kind": "span",
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": self.thread_name,
            "ts": self.wall_start,
            "t_mono": self.t_start,
            "elapsed_s": self.elapsed,
            "sync_elapsed_s": self.sync_elapsed,
            "status": self.status,
            "attrs": dict(self.attrs),
        }


class _NoopSpan(object):
    """The shared do-nothing span handed out while MESH_TPU_OBS is off."""

    __slots__ = ()
    elapsed = None
    sync_elapsed = None
    attrs = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def watch(self, out):
        return out


_NOOP = _NoopSpan()


class _TimedOnlySpan(object):
    """``timed_span()`` while tracing is off: measures ``elapsed`` (and the
    sync of ``watch``ed tensors) but records nothing anywhere."""

    __slots__ = ("elapsed", "sync_elapsed", "_t0", "_watched")

    def __init__(self):
        self.elapsed = None
        self.sync_elapsed = None
        self._watched = None

    def set(self, **attrs):
        return self

    def watch(self, out):
        self._watched = out
        return out

    def __enter__(self):
        self._t0 = monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        t_end = monotonic()
        self.elapsed = t_end - self._t0
        if exc_type is None and self._watched is not None:
            device_sync(self._watched)
            t_sync = monotonic()
            self.sync_elapsed = t_sync - t_end
            self.elapsed = t_sync - self._t0
        return False


class Tracer(object):
    """Per-process span collector: thread-local nesting stacks, a bounded
    ring of finished spans, and push sinks."""

    def __init__(self, max_events=4096):
        self._events = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sinks = []
        self._env_sink_checked = False

    # -- span lifecycle ------------------------------------------------

    def span(self, name, **attrs):
        return Span(self, name, attrs)

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _finish(self, span):
        event = span.to_dict()
        with self._lock:
            if not self._env_sink_checked:
                self._env_sink_checked = True
                self._install_env_sink_locked()
            self._events.append(event)
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink(event)
            except Exception:   # a broken sink must never break serving
                pass

    def _install_env_sink_locked(self):
        from ..utils import knobs

        path = knobs.get_str(JSONL_ENV, None)
        if path:
            self._sinks.append(jsonl_sink(path))

    # -- consumption ---------------------------------------------------

    def events(self):
        """Finished spans, oldest first (bounded ring)."""
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()

    def add_sink(self, sink):
        with self._lock:
            self._sinks.append(sink)
        return sink

    def remove_sink(self, sink):
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)


#: the process-wide tracer (one request path, one tracer)
TRACER = Tracer()

# tail sampling: finished spans carrying a request_id buffer in the
# trace tail until their ledger row closes and decides retention
# (obs/context.py; a span with no request_id costs one dict lookup)
TRACER.add_sink(TRACE_TAIL.record_span)


def span(name, **attrs):
    """A traced region — or THE no-op singleton while MESH_TPU_OBS is
    off, which is the whole overhead story: one env read, no object."""
    if not enabled():
        return _NOOP
    return TRACER.span(name, **attrs)


def timed_span(name, **attrs):
    """Like ``span``, but ``elapsed`` / ``sync_elapsed`` are measured even
    while tracing is off, so always-on latency counters never read raw
    clocks themselves; ``watch`` the outputs to cover their device work."""
    if not enabled():
        return _TimedOnlySpan()
    return TRACER.span(name, **attrs)


def traced(name=None, **attrs):
    """Decorator form: ``@traced`` or ``@traced("custom.name", k=v)``.

    Zero work beyond one env read per call while tracing is off.
    """
    def decorate(fn, label=None):
        label = label or getattr(fn, "__qualname__", fn.__name__)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with TRACER.span(label, **attrs):
                return fn(*args, **kwargs)
        return wrapper

    if callable(name):          # bare @traced
        return decorate(name)
    return lambda fn: decorate(fn, name)


def jsonl_sink(path, max_mb=None, keep=None):
    """A push sink appending one JSON line per finished span to ``path``
    (opened lazily, line-buffered under a lock; errors are swallowed —
    observability must never take serving down).

    Size-bounded: when the file would exceed ``max_mb`` megabytes
    (default ``MESH_TPU_OBS_JSONL_MAX_MB``, unset = unbounded), it is
    rotated to ``path.1`` … ``path.<keep>`` (default keep
    ``MESH_TPU_OBS_JSONL_KEEP`` or 3, oldest dropped) so long serving
    runs can't grow the live trace sink without limit.
    """
    import os

    from ..utils import knobs

    if max_mb is None:
        max_mb = knobs.get_float(JSONL_MAX_MB_ENV)
    if keep is None:
        keep = max(1, knobs.get_int(JSONL_KEEP_ENV))
    max_bytes = int(max_mb * 1024 * 1024) if max_mb else None
    lock = threading.Lock()
    state = {"fh": None}

    def rotate_locked():
        state["fh"].close()
        state["fh"] = None
        for i in range(keep - 1, 0, -1):
            src = "%s.%d" % (path, i)
            if os.path.exists(src):
                os.replace(src, "%s.%d" % (path, i + 1))
        os.replace(path, "%s.1" % path)

    def sink(event):
        line = json.dumps(event) + "\n"
        with lock:
            if state["fh"] is None:
                state["fh"] = open(path, "a", buffering=1)
            if (max_bytes is not None and state["fh"].tell()
                    and state["fh"].tell() + len(line) > max_bytes):
                rotate_locked()
                state["fh"] = open(path, "a", buffering=1)
            state["fh"].write(line)
    return sink


def configure(jsonl=None):
    """Programmatic sink setup (the env-var-free path for tests and
    embedding apps).  Returns the sink handle for ``remove_sink``."""
    if jsonl is not None:
        return TRACER.add_sink(jsonl_sink(jsonl))
    return None
