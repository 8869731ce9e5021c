"""Device choice, environment knobs, small array helpers and timing
utilities for the PyTorch port.  ``row`` / ``col`` / ``sparse`` (and the
``asarray_*`` helpers) and ``Timer`` / ``host_sync`` / ``time_fn`` /
``trace`` are lazy re-exports (PEP 562), so importing ``knobs`` never pays
for scipy or torch."""

_LAZY = {
    "row": "arrays", "col": "arrays", "sparse": "arrays",
    "asarray_f32": "arrays", "asarray_i32": "arrays",
    "Timer": "profiling", "host_sync": "profiling",
    "time_fn": "profiling", "trace": "profiling",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        value = getattr(
            importlib.import_module("." + _LAZY[name], __name__), name)
        globals()[name] = value     # cache: __getattr__ runs once per name
        return value
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
