"""The ``MESH_TPU_*`` environment knobs the port reads, and the routing
predicates built on them (counterpart of mesh_tpu/utils/knobs.py and
mesh_tpu/utils/dispatch.py, for the knobs of the closest-point ladder and
its MXU rung, the observability modules, the animated-mesh sessions, the
fit loss's data term, the query engine and the topology cache folder).

Every knob is declared in ``KNOBS`` with its type and default, and read
through the accessors below, which re-read ``os.environ`` on every call so
a caller (or a test) can flip a knob between calls.  The truthiness of a
flag and the fallback on a blank or malformed value are the reference's:
a flag set to ''/'0'/'false'/'no'/'off' is off, anything else on; an
int or float knob that does not parse reads as its default.
"""

import os

#: flag values that mean OFF (the reference's knob truthiness)
OFF_VALUES = ("", "0", "false", "no", "off")

#: name -> default (flags read by ``flag``, numbers by ``get_int`` /
#: ``get_float``, strings by ``get_str``)
KNOBS = {
    # the escape hatch to the reference's XLA forms (utils/dispatch.py)
    "MESH_TPU_FORCE_XLA": False,
    "MESH_TPU_SAFE_TILES": False,
    "MESH_TPU_NO_ACCEL": False,
    "MESH_TPU_ACCEL_KIND": "bvh",
    "MESH_TPU_BRUTE_MAX_FACES": None,
    "MESH_TPU_ACCEL_MIN_FACES": None,
    "MESH_TPU_BVH_STREAM": True,
    "MESH_TPU_BVH_STREAM_FORCE": False,
    "MESH_TPU_BVH_STREAM_BUFFERS": None,
    "MESH_TPU_BVH_STREAM_VMEM_MB": 12.0,
    # the MXU rung of the closest-point ladder (query/mxu_kernel.py)
    "MESH_TPU_MXU": False,
    "MESH_TPU_MXU_BF16": False,
    "MESH_TPU_MXU_CROSSOVER_FACES": None,
    # observability (obs/)
    "MESH_TPU_OBS": False,
    "MESH_TPU_OBS_JAX_TRACE": False,
    "MESH_TPU_RECORDER": True,
    "MESH_TPU_RECORDER_EVENTS": 2048,
    "MESH_TPU_LEDGER": True,
    "MESH_TPU_LEDGER_CAPACITY": 512,
    "MESH_TPU_REPLAY_TRACE": None,
    "MESH_TPU_TRACE_CONTEXT": True,
    "MESH_TPU_TRACE_TAIL": 64,
    # animated meshes (anim/)
    "MESH_TPU_ANIM": True,
    "MESH_TPU_ANIM_REFIT_MAX_INFLATION": None,
    # the fit loss's data term (parallel/fit.py)
    "MESH_TPU_VERTEX_CHAMFER": False,
    # the query engine (engine/)
    "MESH_TPU_NO_ENGINE": False,
    "MESH_TPU_COALESCE_WINDOW_MS": None,
    "MESH_TPU_FLEET_SHARD": True,
    "MESH_TPU_FLEET_SHARD_MIN_Q": None,
    # the crc32-keyed topology cache and the native reader's build
    # (topology/connectivity.py; the reference's $PSBODY_MESH_CACHE idea)
    "MESH_TPU_CACHE": None,
}

_UNSET = object()


def raw(name):
    """The raw environment value of a declared knob, or None; an
    undeclared name raises ``KeyError``."""
    if name not in KNOBS:
        raise KeyError("undeclared knob %r" % (name,))
    return os.environ.get(name)


def flag(name):
    """Unset: the declared default; set: off for ``OFF_VALUES``, else on."""
    value = raw(name)
    if value is None:
        return bool(KNOBS[name])
    return value.strip().lower() not in OFF_VALUES


def _parsed(name, default, parse):
    if default is _UNSET:
        default = KNOBS[name]
    value = raw(name)
    if value is None or not value.strip():
        return default
    try:
        return parse(value.strip())
    except ValueError:
        return default


def get_int(name, default=_UNSET):
    return _parsed(name, default, int)


def get_float(name, default=_UNSET):
    return _parsed(name, default, float)


def get_str(name, default=_UNSET):
    return _parsed(name, default, str)


#: the port's own default cache folder, beside its kernel builds: the
#: reference's pickles live under ``~/.mesh_tpu/cache``, so the two
#: packages' defaults never mix
DEFAULT_CACHE_FOLDER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "mesh_tpu_torch", "cache")


def cache_folder():
    """The topology cache folder: ``MESH_TPU_CACHE`` when set, else
    ``PSBODY_MESH_CACHE`` (the reference psbody name), else
    ``DEFAULT_CACHE_FOLDER``."""
    return get_str("MESH_TPU_CACHE") or (
        os.environ.get("PSBODY_MESH_CACHE") or DEFAULT_CACHE_FOLDER)


# -- routing predicates (mesh_tpu/utils/dispatch.py) --------------------------

def safe_tiles():
    """True when ``MESH_TPU_SAFE_TILES`` pins the closest-point kernels to
    their sliver-safe tile and forces the nondegeneracy check to False."""
    return flag("MESH_TPU_SAFE_TILES")


def tile_variant():
    """``"safe"`` under ``MESH_TPU_SAFE_TILES``, else ``"fast"``."""
    return "safe" if safe_tiles() else "fast"


def no_accel():
    """True when ``MESH_TPU_NO_ACCEL`` keeps the auto ladder off the BVH."""
    return flag("MESH_TPU_NO_ACCEL")


def accel_kind():
    """``"grid"`` when ``MESH_TPU_ACCEL_KIND=grid``, else ``"bvh"``."""
    value = (get_str("MESH_TPU_ACCEL_KIND") or "").lower()
    return "grid" if value == "grid" else "bvh"


def bvh_stream_enabled():
    """False when ``MESH_TPU_BVH_STREAM`` turns the streamed rope kernel
    off (then only the resident one serves, up to its legacy ceiling)."""
    return flag("MESH_TPU_BVH_STREAM")


def bvh_stream_force():
    """True when ``MESH_TPU_BVH_STREAM_FORCE`` pins the streamed rope
    kernel where the resident one would serve."""
    return flag("MESH_TPU_BVH_STREAM_FORCE")


def bvh_stream_buffers(default=2):
    """Leaf-ring depth of the streamed rope kernel:
    ``MESH_TPU_BVH_STREAM_BUFFERS`` when set, else ``default``; at least 2."""
    value = get_int("MESH_TPU_BVH_STREAM_BUFFERS")
    if value is None:
        value = default
    return max(2, int(value))


def bvh_stream_vmem_budget():
    """The byte budget (``MESH_TPU_BVH_STREAM_VMEM_MB``, MiB) that the
    resident rope kernel's face planes are measured against."""
    return int(float(get_float("MESH_TPU_BVH_STREAM_VMEM_MB")) * 1024 * 1024)


def mxu_enabled():
    """True when ``MESH_TPU_MXU`` opts the closest-point ladder into the
    MXU rung (the dot-product form of the tile, ``query/mxu_kernel.py``).
    Off by default: with the knob unset every route is the pre-MXU one."""
    return flag("MESH_TPU_MXU")


def mxu_bf16_enabled():
    """True when ``MESH_TPU_MXU_BF16`` puts the bf16 bound pass and the
    f32 exact repair in front of the MXU rung's scan; only consulted on
    calls already routed to the MXU rung."""
    return flag("MESH_TPU_MXU_BF16")


def vertex_chamfer():
    """True when ``MESH_TPU_VERTEX_CHAMFER`` pins the fit loss's data term to
    the min-over-vertices chamfer instead of the point-to-surface energy
    (``parallel/fit.py``); read when a step is built."""
    return flag("MESH_TPU_VERTEX_CHAMFER")


def no_engine():
    """True when ``MESH_TPU_NO_ENGINE`` routes the facades around the query
    engine (``engine/``) to their direct paths.  Read per call, so a
    misbehaving plan can be routed around without a restart."""
    return flag("MESH_TPU_NO_ENGINE")
