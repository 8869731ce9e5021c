"""The ``MESH_TPU_*`` environment-knob registry of the port, and the
routing predicates built on it (counterpart of mesh_tpu/utils/knobs.py
and mesh_tpu/utils/dispatch.py).

Every knob the port reads is declared here with the reference's name,
kind, default and section and a one-line doc, and read through the
accessors below: ``raw()`` raises ``KeyError`` on an undeclared name, so
a typo'd knob can never be read silently.  The accessors re-read
``os.environ`` on every call, so a caller (or a test) can flip a knob
between calls.  The truthiness of a flag and the fallback on a blank or
malformed value are the reference's: a flag set to
''/'0'/'false'/'no'/'off' is off, anything else on; an int or float knob
that does not parse reads as its default.

The path knobs whose reference default is a file or folder under
``~/.mesh_tpu`` declare None here: unset, the port resolves its own
location (``~/.mesh_tpu_torch/...``, or ``build/mesh_tpu_torch/cache``
for ``MESH_TPU_CACHE``), so the two packages never share a default file.
``render_markdown`` renders the table as the reference's configuration
page does.  Stdlib-only.
"""

import os

__all__ = [
    "Knob", "declared", "lookup", "raw", "flag", "get_int", "get_float",
    "get_str", "render_markdown", "OFF_VALUES", "KNOBS",
]

#: flag values that mean OFF (the reference's knob truthiness)
OFF_VALUES = ("", "0", "false", "no", "off")


class Knob(object):
    """One declared environment knob."""

    __slots__ = ("name", "kind", "default", "doc", "section", "prefix")

    def __init__(self, name, kind, default, doc, section, prefix=False):
        self.name = name
        self.kind = kind          # "flag" | "int" | "float" | "str" | "path"
        self.default = default
        self.doc = doc
        self.section = section
        self.prefix = prefix      # True: name is a prefix (MESH_TPU_X_<SUFFIX>)


#: declaration order is doc order
_REGISTRY = {}


def _declare(name, kind, default, doc, section, prefix=False):
    _REGISTRY[name] = Knob(name, kind, default, doc, section, prefix=prefix)
    return name


# -- core ------------------------------------------------------------------

_declare(
    "MESH_TPU_CACHE", "path", None,
    "Topology cache folder (the reference's $PSBODY_MESH_CACHE idea); "
    "unset: PSBODY_MESH_CACHE, else build/mesh_tpu_torch/cache beside the "
    "package.", "Core")

# -- dispatch escape hatches ----------------------------------------------

_declare(
    "MESH_TPU_FORCE_XLA", "flag", False,
    "Route every query entry point to the reference's XLA forms in plain "
    "PyTorch instead of the CUDA kernels (utils/dispatch.py; read per "
    "call).", "Dispatch")
_declare(
    "MESH_TPU_SAFE_TILES", "flag", False,
    "Pin every closest-point kernel to its sliver-safe tile variant and "
    "force the data-derived nondegeneracy check off.", "Dispatch")
_declare(
    "MESH_TPU_NO_ENGINE", "flag", False,
    "Bypass the shape-bucketed plan-cache engine: facades take their "
    "direct exact-shape paths.", "Dispatch")
_declare(
    "MESH_TPU_VERTEX_CHAMFER", "flag", False,
    "Pin parallel/fit.py's data term to the min-over-vertices chamfer "
    "instead of the point-to-surface energy (read at step-build time).",
    "Dispatch")
_declare(
    "MESH_TPU_NO_ACCEL", "flag", False,
    "Disable the spatial-index query paths (accel/): auto never routes "
    "to the index; callers fall back to brute/culled.", "Dispatch")
_declare(
    "MESH_TPU_ACCEL_KIND", "str", "bvh",
    "Which spatial index the accel facade builds: `bvh` (flattened rope "
    "LBVH, default) or `grid` (uniform grid); unknown values fall back "
    "to bvh.", "Dispatch")
_declare(
    "MESH_TPU_BRUTE_MAX_FACES", "int", None,
    "Face count up to which the auto strategy uses brute force "
    "(overrides the calibrated crossover; query/autotune.py).",
    "Dispatch")
_declare(
    "MESH_TPU_ACCEL_MIN_FACES", "int", None,
    "Face count at which the auto strategy switches to the spatial "
    "index (overrides the calibrated accel crossover).", "Dispatch")
_declare(
    "MESH_TPU_MXU", "flag", False,
    "Route the closest-point facades to the dot-product tile (the "
    "reference's MXU rung, csrc/mxu_*.cu) when the fast variant is "
    "eligible; off (default) keeps every route the pre-MXU one.",
    "Dispatch")
_declare(
    "MESH_TPU_MXU_BF16", "flag", False,
    "With MESH_TPU_MXU: run the bf16 bound pass before the f32 exact "
    "repair; off computes the dot-product pass in f32 directly.",
    "Dispatch")
_declare(
    "MESH_TPU_MXU_CROSSOVER_FACES", "int", None,
    "Face count at which the dot-product tile takes over (overrides the "
    "calibrated mxu crossover; query/autotune.py).", "Dispatch")
_declare(
    "MESH_TPU_BVH_STREAM", "flag", True,
    "Streamed rope-walk kill switch: on (default) lets meshes whose face "
    "planes exceed the resident budget run the streamed walk; off keeps "
    "the resident walk up to its ceiling.", "Dispatch")
_declare(
    "MESH_TPU_BVH_STREAM_FORCE", "flag", False,
    "Force the streamed rope walk even where the resident one would serve "
    "(A/B hatch; results are bit-identical).", "Dispatch")
_declare(
    "MESH_TPU_BVH_STREAM_BUFFERS", "int", None,
    "Leaf-ring depth of the streamed rope walk (min 2); unset uses the "
    "autotuned value, else 2.", "Dispatch")
_declare(
    "MESH_TPU_BVH_STREAM_VMEM_MB", "float", 12.0,
    "Byte budget (MiB) the accel facade measures the resident rope walk's "
    "face planes against when picking resident vs streamed (the "
    "reference's VMEM budget).", "Dispatch")
_declare(
    "MESH_TPU_COALESCE_WINDOW_MS", "float", None,
    "Hard pin for the executor's request-coalescing window in "
    "milliseconds (0 = drain immediately); setting it pins the "
    "`coalesce_window_ms` tunable (utils/tuning.py).", "Dispatch")

# -- observability -----------------------------------------------------------

_declare(
    "MESH_TPU_OBS", "flag", False,
    "Master gate for span tracing (metrics counters stay always-on); off "
    "means spans are no-ops.", "Observability")
_declare(
    "MESH_TPU_OBS_JSONL", "path", None,
    "Live span/metric JSON-lines sink path (obs/trace.py installs it on "
    "first span).", "Observability")
_declare(
    "MESH_TPU_OBS_JSONL_MAX_MB", "float", None,
    "Size cap (MiB) that rotates the JSONL sink; unset = unbounded.",
    "Observability")
_declare(
    "MESH_TPU_OBS_JSONL_KEEP", "int", 3,
    "Rotated JSONL generations to keep (oldest dropped).", "Observability")
_declare(
    "MESH_TPU_OBS_JAX_TRACE", "flag", False,
    "Also emit spans as torch.profiler record_function ranges onto the "
    "profiler's timeline (opt-in on top of MESH_TPU_OBS; the reference's "
    "name).", "Observability")
_declare(
    "MESH_TPU_RECORDER", "flag", True,
    "Always-on flight recorder kill switch: unset means ON; set to "
    "0/false/off to disable recording entirely.", "Observability")
_declare(
    "MESH_TPU_RECORDER_EVENTS", "int", 2048,
    "Flight-recorder ring capacity in events (min 16).", "Observability")
_declare(
    "MESH_TPU_INCIDENT_DIR", "path", None,
    "Directory for flight-recorder incident dumps; unset: "
    "~/.mesh_tpu_torch/incidents.", "Observability")
_declare(
    "MESH_TPU_INCIDENT_KEEP", "int", 32,
    "Incident dumps to keep before pruning the oldest (min 1).",
    "Observability")
_declare(
    "MESH_TPU_SLO_DRIVES_HEALTH", "flag", False,
    "Opt-in: a confirmed SLO fast-burn breach trips the serving "
    "HealthMonitor to degraded.", "Observability")
_declare(
    "MESH_TPU_LEDGER", "flag", True,
    "Always-on per-request latency ledger kill switch (obs/ledger.py): "
    "unset means ON; off skips stage stamping and the request-stage "
    "histogram.", "Observability")
_declare(
    "MESH_TPU_LEDGER_CAPACITY", "int", 512,
    "Ledger ring capacity in closed request records (min 16).",
    "Observability")
_declare(
    "MESH_TPU_LEDGER_TAIL", "int", 32,
    "How many newest ledger records ride along in each flight-recorder "
    "incident dump (min 1).", "Observability")
_declare(
    "MESH_TPU_REPLAY_TRACE", "path", None,
    "Stream every ledger close into a replayable traffic trace at this "
    "JSONL path (obs/replay.py schema v1).", "Observability")
_declare(
    "MESH_TPU_LOCK_WITNESS", "flag", False,
    "Wrap every threading.Lock/RLock/Condition created by mesh_tpu_torch "
    "modules to record real lock-acquisition orders, keyed by creation "
    "site (utils/lockwitness.py). Must be set before the first import.",
    "Observability")
_declare(
    "MESH_TPU_LOCK_WITNESS_FILE", "path", None,
    "Where the lock witness dumps its acquisition-order log (JSONL, "
    "written at process exit); unset: "
    "~/.mesh_tpu_torch/lock_witness.jsonl.", "Observability")
_declare(
    "MESH_TPU_TUNER", "flag", True,
    "Closed-loop tuner kill switch (utils/tuning.py + obs/controller.py): "
    "off freezes every tunable at its static default.", "Observability")
_declare(
    "MESH_TPU_TUNER_INTERVAL", "float", 15.0,
    "TunerController background evaluation interval in seconds.",
    "Observability")
_declare(
    "MESH_TPU_TUNER_AB_TOL", "float", 0.2,
    "Shadow A/B guard tolerance: a knob change whose hold-out window p99 "
    "regresses past `before * (1 + tol)` is auto-reverted.",
    "Observability")
_declare(
    "MESH_TPU_KNOB_TAIL", "int", 8,
    "How many newest `knob_change` events ride along in each incident "
    "dump's `knob_history` tail (min 1).", "Observability")
_declare(
    "MESH_TPU_TRACE_CONTEXT", "flag", True,
    "End-to-end request identity kill switch (obs/context.py): on mints a "
    "RequestContext per admission; off never mints one.", "Observability")
_declare(
    "MESH_TPU_TRACE_TAIL", "int", 64,
    "Tail-sampling ring capacity in retained request traces per process "
    "(min 4).", "Observability")
_declare(
    "MESH_TPU_TRACE_RESERVOIR", "int", 8,
    "Slots in the slow-ok reservoir inside the tail-sampling ring (0 "
    "disables it; misses/errors are always retained).", "Observability")

# -- serving ----------------------------------------------------------------

_declare(
    "MESH_TPU_SERVE_STATS", "path", None,
    "QueryService stats sink path (written on stop()); unset: "
    "~/.mesh_tpu_torch/serve_stats.json.", "Serving")
_declare(
    "MESH_TPU_SERVE_QUEUE", "int", 64,
    "Per-tenant admission queue bound (overridable per constructor).",
    "Serving")
_declare(
    "MESH_TPU_SERVE_DEADLINE_S", "float", 1.0,
    "Default request deadline in seconds.", "Serving")
_declare(
    "MESH_TPU_SERVE_WORKERS", "int", 1,
    "Queue-drain worker threads.", "Serving")
_declare(
    "MESH_TPU_SERVE_LADDER", "str", None,
    "Comma-separated degradation-ladder rung names "
    "(engine,culled,anchored,accel) to filter/reorder the default "
    "engine->culled->anchored ladder.", "Serving")
_declare(
    "MESH_TPU_SERVE_WEDGE_S", "float", 5.0,
    "In-flight seconds before the health watchdog counts a dispatch as "
    "wedged.", "Serving")

# -- store ------------------------------------------------------------------

_declare(
    "MESH_TPU_STORE_DIR", "path", None,
    "Content-addressed mesh-store root (the reference's layout); unset: "
    "~/.mesh_tpu_torch/store.", "Store")
_declare(
    "MESH_TPU_STORE_BLOCK_ROWS", "int", 262144,
    "Rows per chunked store block.", "Store")
_declare(
    "MESH_TPU_STORE_COMPACT", "flag", True,
    "Write the quantized uint16 compact vertex tier on ingest; off stores "
    "the exact tier only.", "Store")
_declare(
    "MESH_TPU_STORE_SIDECAR", "flag", True,
    "AccelIndex side-car consult/persist in accel get_index; off restores "
    "build-only behavior.", "Store")
_declare(
    "MESH_TPU_STORE_VERIFY", "flag", True,
    "CRC-verify every store block on read.", "Store")
_declare(
    "MESH_TPU_STORE_PAGE_CACHE_MB", "float", 256.0,
    "Byte budget (MiB) of the in-process digest-keyed page cache.",
    "Store")
_declare(
    "MESH_TPU_STORE_GC_MB", "float", 4096.0,
    "Default corpus size budget (MiB) for MeshStore.gc.", "Store")

# -- fleet ------------------------------------------------------------------

_declare(
    "MESH_TPU_FLEET", "flag", True,
    "Fleet router kill switch (fleet/router.py): on (default) routes by "
    "(op, topology digest, shape bucket) over the hash ring; off makes "
    "FleetRouter.submit a direct pass-through to its first replica.",
    "Fleet")
_declare(
    "MESH_TPU_FLEET_SPILL", "flag", True,
    "Spill-to-sibling admission: a primary replica rejecting with "
    "`queue_full` spills the request to the ring's second choice (one "
    "hop); off propagates the rejection.", "Fleet")
_declare(
    "MESH_TPU_FLEET_VNODES", "int", 64,
    "Virtual nodes per replica on the consistent-hash ring (changing it "
    "remaps keys).", "Fleet")
_declare(
    "MESH_TPU_FLEET_SHARD", "flag", True,
    "Sharded big-batch lane kill switch (engine/executor.py); the lane "
    "is also off while `shard_min_q` is unset (its default).", "Fleet")
_declare(
    "MESH_TPU_FLEET_SHARD_MIN_Q", "int", None,
    "Hard pin for the `shard_min_q` tunable: query count at which a "
    "coalesced closest-point batch takes the sharded big-batch lane.",
    "Fleet")

# -- animation ----------------------------------------------------------------

_declare(
    "MESH_TPU_ANIM", "flag", True,
    "Dynamic-mesh subsystem kill switch (anim/): on (default) avatar "
    "sessions refit the BVH per frame; off rebuilds it cold per frame.",
    "Animation")
_declare(
    "MESH_TPU_ANIM_REFIT_MAX_INFLATION", "float", None,
    "Hard pin for the `anim_refit_max_inflation` tunable: box-inflation "
    "ratio past which a session's refit trips a full rebuild.",
    "Animation")

# -- bench harness ------------------------------------------------------------

_declare(
    "MESH_TPU_BENCH_FAULT", "str", None,
    "Fault injection for the staged harness (obs/perf.py): "
    "`<stage>:hang|crash|error` (tests only).", "Bench harness")
_declare(
    "MESH_TPU_BENCH_PARTIAL", "path", None,
    "Relocate the incremental bench_partial.json written after every "
    "stage.", "Bench harness")
_declare(
    "MESH_TPU_BENCH_TIMEOUT_", "float", None,
    "Per-stage child timeout override in seconds "
    "(`MESH_TPU_BENCH_TIMEOUT_<STAGE>`).", "Bench harness", prefix=True)


#: name -> declared default, for every exact (non-prefix) knob
KNOBS = {k.name: k.default for k in _REGISTRY.values() if not k.prefix}


# -- accessors -------------------------------------------------------------

_UNSET = object()


def declared():
    """All declared knobs, in declaration (= doc) order."""
    return list(_REGISTRY.values())


def lookup(name):
    """The :class:`Knob` for ``name`` (exact, or a declared prefix knob);
    an undeclared name raises ``KeyError``."""
    try:
        return _REGISTRY[name]
    except KeyError:
        for knob in _REGISTRY.values():
            if knob.prefix and name.startswith(knob.name):
                return knob
        raise KeyError("undeclared knob %r (declare it in "
                       "mesh_tpu_torch/utils/knobs.py)" % (name,))


def raw(name):
    """The raw environment value of a declared knob, or None."""
    lookup(name)
    return os.environ.get(name)


def flag(name):
    """Unset: the declared default; set: off for ``OFF_VALUES``, else on."""
    knob = lookup(name)
    value = raw(name)
    if value is None:
        return bool(knob.default)
    return value.strip().lower() not in OFF_VALUES


def _parsed(name, default, parse):
    if default is _UNSET:
        default = lookup(name).default
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
    """String/path knob, stripped (paths are NOT expanded)."""
    return _parsed(name, default, str)


def render_markdown():
    """The knob table as markdown, one section per declared section (the
    reference's configuration page, for the port's knobs)."""
    lines = [
        "# Configuration knobs (mesh_tpu_torch)",
        "",
        "Every `MESH_TPU_*` environment variable the port reads, generated",
        "from the declaration table in `mesh_tpu_torch/utils/knobs.py`.",
        "Flags share one truthiness: explicitly set to ``''``/``0``/"
        "``false``/``no``/``off`` means",
        "OFF, anything else means ON, unset means the default below.  "
        "All knobs",
        "are re-read per call unless their doc says otherwise.",
        "",
    ]
    sections = []
    for knob in declared():
        if knob.section not in sections:
            sections.append(knob.section)
    for section in sections:
        lines += ["## %s" % section, "",
                  "| knob | type | default | effect |", "|---|---|---|---|"]
        for knob in declared():
            if knob.section != section:
                continue
            name = (knob.name + "<STAGE>") if knob.prefix else knob.name
            default = ("on" if knob.default else "off") \
                if knob.kind == "flag" else (
                "unset" if knob.default is None else "`%s`" % (knob.default,))
            lines.append("| `%s` | %s | %s | %s |"
                         % (name, knob.kind, default, knob.doc))
        lines.append("")
    return "\n".join(lines)


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
