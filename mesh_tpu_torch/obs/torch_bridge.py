"""torch.monitor -> metrics-registry bridge (counterpart of
mesh_tpu/obs/jax_bridge.py).

The reference folds JAX's persistent compilation-cache events into the
registry.  The port's compile cache is ``_build``'s digest-keyed ``nvcc``
libraries under ``build/mesh_tpu_torch/``: ``_build.build`` logs one
``torch.monitor.Event`` named :data:`KERNEL_CACHE_EVENT` per kernel
library, with ``library``, ``hit`` (the library was on disk: 1, or
``nvcc`` built it: 0) and ``seconds`` (the digest check of a hit, the
``nvcc`` run of a miss).  Installed, the bridge answers "did this
process LOAD its kernels, or build them?" in the same snapshot as the
engine's own plan-cache counters:

- ``mesh_tpu_kernel_cache_hits_total{library}`` stands in for the
  reference's ``mesh_tpu_xla_cache_hits_total``;
- ``mesh_tpu_kernel_cache_misses_total{library}`` for its
  ``mesh_tpu_xla_cache_misses_total``;
- ``mesh_tpu_kernel_cache_seconds{outcome}`` (outcome ``hit`` or
  ``miss``) for its ``mesh_tpu_jax_event_duration_seconds``;
- ``mesh_tpu_torch_events_total{event}`` counts every other
  ``torch.monitor`` event, as the reference's ``mesh_tpu_jax_events_total``
  counts unmapped JAX events.

The guarantees are the reference's: installing is idempotent (one
handler per process), and a handler error never breaks a build (the
handler swallows its own errors; ``_build`` swallows what any handler
raises).  The handler is unregistered at exit: a ``torch.monitor``
handler still registered while the interpreter finalizes crashes it.
"""

import atexit
import logging
import threading

from .metrics import REGISTRY

__all__ = ["install_torch_monitoring_bridge", "KERNEL_CACHE_EVENT"]

_log = logging.getLogger(__name__)

#: the event ``_build.build`` logs once per kernel library
KERNEL_CACHE_EVENT = "mesh_tpu_torch.kernel_cache"

#: kernel-library durations reach minutes on a cold nvcc run
CACHE_SECONDS_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0,
                         20.0, 40.0, 80.0, 160.0, 320.0)

_install_lock = threading.Lock()
_handle = None


def install_torch_monitoring_bridge(registry=None):
    """Register the torch.monitor handler once per process.

    :returns: True when the handler is active (now or already).
    """
    global _handle
    registry = registry or REGISTRY
    with _install_lock:
        if _handle is not None:
            return True
        try:
            from torch import monitor
        except Exception as e:
            _log.debug("torch.monitor unavailable: %s", e)
            return False

        hits = registry.counter(
            "mesh_tpu_kernel_cache_hits_total",
            "Kernel libraries loaded from the build folder (no nvcc run).")
        misses = registry.counter(
            "mesh_tpu_kernel_cache_misses_total",
            "Kernel libraries built by nvcc (missing from the build "
            "folder).")
        seconds = registry.histogram(
            "mesh_tpu_kernel_cache_seconds",
            "Seconds per kernel library: the digest check of a hit, the "
            "nvcc run of a miss.", buckets=CACHE_SECONDS_BUCKETS)
        generic = registry.counter(
            "mesh_tpu_torch_events_total",
            "Other torch.monitor events, labeled by event name.")

        def on_event(event):
            try:
                if event.name == KERNEL_CACHE_EVENT:
                    data = event.data
                    hit = bool(data.get("hit"))
                    library = str(data.get("library", "?"))
                    (hits if hit else misses).inc(library=library)
                    seconds.observe(float(data.get("seconds", 0.0)),
                                    outcome="hit" if hit else "miss")
                else:
                    generic.inc(event=event.name)
            except Exception:   # monitoring must never break a build
                pass

        try:
            handle = monitor.register_event_handler(on_event)
        except Exception as e:
            _log.debug("torch.monitor handler registration failed: %s", e)
            return False
        atexit.register(_unregister, monitor, handle)
        _handle = handle
        return True


def _unregister(monitor, handle):
    global _handle
    try:
        monitor.unregister_event_handler(handle)
    except Exception:
        pass
    with _install_lock:
        if _handle is handle:
            _handle = None
