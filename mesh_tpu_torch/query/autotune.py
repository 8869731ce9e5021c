"""Routing thresholds of the closest-point ladder and their calibrations
(counterpart of mesh_tpu/query/autotune.py).

The constants are routing thresholds in face counts and tile shapes, not
times, and keep the reference's values: brute force up to
``DEFAULT_CROSSOVER`` faces, the sphere-culled kernel above it, the BVH
rope kernels from ``ACCEL_DEFAULT_CROSSOVER`` faces, the streamed walk at
``STREAM_DEFAULT_TILES``, and under ``MESH_TPU_MXU`` the MXU rung from
``MXU_DEFAULT_CROSSOVER`` faces up to the brute-force ceiling.

Each accessor resolves override > tuned > measured > default: the
environment override when one parses; else the value the closed-loop tuner
actuated (``utils/tuning.py``; none unless a ``TunerController`` moved it);
else this card's saved measurement, read once a
process from its file under ``CACHE_DIR`` (named after the card, so a
measurement never serves another card or the CPU; a malformed or unusable
file is ignored); else the default.  The calibrations
(``calibrate_crossover``, ``calibrate_accel_crossover``,
``calibrate_stream_tiles``, ``calibrate_mxu_crossover``) time the routes
they choose between on the device, with the reference's selection rules,
set the process's measured value, and save it unless ``save=False`` or a
re-timed point disagrees with itself by more than 2x (unstable timings).
``CALIBRATIONS`` keeps each one's last run; ``retune_hooks`` hands the
saved calibrations to the tuner's background retune.
"""

import contextlib
import json
import logging
import os
import re
import time

import numpy as np
import torch

from ..utils import knobs
from ..utils.device import resolve_device
from ..utils.dispatch import pallas_default

log = logging.getLogger(__name__)

DEFAULT_CROSSOVER = 32768

ACCEL_DEFAULT_CROSSOVER = 131072

#: face count from which MESH_TPU_MXU routes the brute-force rung to the
#: MXU rung (the reference's conservative default)
MXU_DEFAULT_CROSSOVER = 8192

#: (tile_q, tile_f, n_buffers) of the streamed rope kernel, and the sweep
#: calibrate_stream_tiles ranks (tile_f a multiple of 128, n_buffers >= 2)
STREAM_DEFAULT_TILES = (128, 256, 2)
STREAM_SWEEP = ((128, 256, 2), (128, 256, 3), (128, 512, 2), (256, 256, 2))

#: where calibrations are saved: beside the kernel builds, which
#: .gitignore lists
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "mesh_tpu_torch", "autotune")

#: this process's measured values, once read from the cache or measured
#: (None: not looked up yet)
_measured = None
_accel_measured = None
_stream_measured = None
_mxu_measured = None

#: the record of each calibration's last run (what it saves)
CALIBRATIONS = {"crossover": {}, "accel_crossover": {}, "stream_tiles": {},
                "mxu_crossover": {}}
MXU_CALIBRATION = CALIBRATIONS["mxu_crossover"]


def _override(name, default):
    if knobs.raw(name):
        value = knobs.get_int(name)
        if value is not None:
            return value
        log.warning("ignoring malformed %s=%r (want an integer face count)",
                    name, knobs.raw(name))
    return default


def _tuned(name):
    """The tuner's live override (``utils/tuning.py``), consulted between
    the env override and the saved measurement: None when the tuner is
    off, the knob is env-pinned, or the controller never actuated it."""
    from ..utils import tuning

    return tuning.tuned_value(name)


def _cache_path(name, device="cuda"):
    """The file of calibration ``name`` for ``device``, named after the
    card."""
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return os.path.join(CACHE_DIR, "%s_%s_%s.json" % (
        name, dev.type, re.sub(r"[^A-Za-z0-9._-]+", "_", kind)))


def _read_saved(name, parse, default):
    """``parse`` of this card's saved calibration ``name``, or ``default``
    where there is no card, no file, or a value ``parse`` refuses."""
    if not torch.cuda.is_available():
        return default
    try:
        with open(_cache_path(name)) as fh:
            return parse(json.load(fh))
    except (OSError, ValueError, KeyError, TypeError):
        return default


def _positive(key):
    def parse(data):
        value = int(data[key])
        if value <= 0:
            raise ValueError(value)
        return value
    return parse


def _tiles(data):
    params = (int(data["tile_q"]), int(data["tile_f"]),
              int(data["n_buffers"]))
    if params[0] <= 0 or params[1] <= 0 or params[1] % 128 or params[2] < 2:
        raise ValueError(params)
    return params


def crossover_faces():
    """The face count up to which auto uses brute force: override
    (``MESH_TPU_BRUTE_MAX_FACES``) > measured (``calibrate_crossover``) >
    ``DEFAULT_CROSSOVER``; above it the culled kernel runs."""
    value = _override("MESH_TPU_BRUTE_MAX_FACES", None)
    if value is not None:
        return value
    global _measured
    if _measured is None:
        _measured = _read_saved("crossover", _positive("crossover_faces"),
                                DEFAULT_CROSSOVER)
    return _measured


def accel_crossover_faces():
    """The face count from which auto takes the spatial index: override
    (``MESH_TPU_ACCEL_MIN_FACES``) > tuned > measured
    (``calibrate_accel_crossover``) > ``ACCEL_DEFAULT_CROSSOVER``."""
    value = _override("MESH_TPU_ACCEL_MIN_FACES", None)
    if value is not None:
        return value
    tuned = _tuned("accel_min_faces")
    if tuned is not None:
        return int(tuned)
    global _accel_measured
    if _accel_measured is None:
        _accel_measured = _read_saved(
            "accel_crossover", _positive("accel_min_faces"),
            ACCEL_DEFAULT_CROSSOVER)
    return _accel_measured


def mxu_crossover_faces():
    """The face count from which ``MESH_TPU_MXU`` routes the brute-force
    rung to the MXU rung: override (``MESH_TPU_MXU_CROSSOVER_FACES``) >
    tuned > measured (``calibrate_mxu_crossover``) >
    ``MXU_DEFAULT_CROSSOVER``."""
    value = _override("MESH_TPU_MXU_CROSSOVER_FACES", None)
    if value is not None:
        return value
    tuned = _tuned("mxu_crossover")
    if tuned is not None:
        return int(tuned)
    global _mxu_measured
    if _mxu_measured is None:
        _mxu_measured = _read_saved(
            "mxu_crossover", _positive("mxu_crossover_faces"),
            MXU_DEFAULT_CROSSOVER)
    return _mxu_measured


def stream_tile_params():
    """``(tile_q, tile_f, n_buffers)`` for the streamed rope kernel:
    measured (``calibrate_stream_tiles``) > ``STREAM_DEFAULT_TILES``, with
    the ``MESH_TPU_BVH_STREAM_BUFFERS`` override (then the tuned
    ``stream_n_buffers``) on the ring depth."""
    global _stream_measured
    if _stream_measured is None:
        _stream_measured = _read_saved("stream_tiles", _tiles,
                                       STREAM_DEFAULT_TILES)
    tile_q, tile_f, n_buffers = _stream_measured
    tuned = _tuned("stream_n_buffers")
    if tuned is not None:
        n_buffers = int(tuned)
    return tile_q, tile_f, knobs.bvh_stream_buffers(default=n_buffers)


def retune_hooks():
    """The tuner's background-retune callables (obs/controller.py): each
    reads this card's saved calibration (the side-effect-free read of its
    file) and returns ``(value, evidence)`` for ``tuning.actuate``, or None
    where nothing was saved (publishing the default would be generation
    churn for no signal).  The calibrations themselves stay explicit."""

    def _from_file(name, key, floor):
        if not torch.cuda.is_available():
            return None
        path = _cache_path(name)
        try:
            with open(path) as fh:
                value = int(json.load(fh)[key])
            if value < floor:
                raise ValueError(value)
        except (OSError, ValueError, KeyError, TypeError):
            return None
        return value, {"source": path, "key": key}

    return {
        "accel_min_faces": lambda: _from_file(
            "accel_crossover", "accel_min_faces", 1),
        "stream_n_buffers": lambda: _from_file(
            "stream_tiles", "n_buffers", 2),
        "mxu_crossover": lambda: _from_file(
            "mxu_crossover", "mxu_crossover_faces", 1),
    }


def _time_calls(fn, reps, device):
    """Mean seconds per call of ``fn`` over ``reps`` calls after one
    warm-up, synchronizing the card before and after the timed calls."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def _stable(check_t, recheck):
    """The reference's guard: a re-timed point within 2x of itself."""
    return max(check_t, recheck) <= 2.0 * min(check_t, recheck)


def _first_win(wins, crossover_at):
    """The reference's selection over ``wins`` [(faces, t_incumbent,
    t_new)]: ``crossover_at(i)`` of the first ladder point from which the
    new route wins at every larger point, or None."""
    for i, (_, t_i, t_n) in enumerate(wins):
        if t_n < t_i and all(tn < ti for _, ti, tn in wins[i:]):
            return crossover_at(i)
    return None


def _finish(name, record, stable, save, dev):
    """Keep a calibration's run in ``CALIBRATIONS`` and save it, unless
    its timings were unstable or ``save`` is False."""
    record = dict(record, device=str(dev), stable=stable,
                  card=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
                  measured_at=time.strftime("%Y-%m-%dT%H:%M:%S"))
    CALIBRATIONS[name].clear()
    CALIBRATIONS[name].update(record)
    if not stable:
        log.warning("calibration %s: timings unstable (a re-timed point "
                    "moved more than 2x); not saving it", name)
    elif save:
        os.makedirs(CACHE_DIR, exist_ok=True)
        with open(_cache_path(name, dev), "w") as fh:
            json.dump(record, fh, indent=1)


def _queries(n_queries, dev):
    rng = np.random.RandomState(0)
    return torch.as_tensor(rng.randn(n_queries, 3).astype(np.float32),
                           device=dev)


def _on(dev, n_faces):
    v, f = _sphere_mesh(n_faces)
    return torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)


def calibrate_crossover(ladder=(8192, 16384, 32768, 65536, 131072),
                        n_queries=1024, reps=3, save=True, device="cuda"):
    """Measure the brute-vs-culled switch on ``device``: over
    ``_sphere_mesh`` meshes of the ``ladder``'s face counts and
    ``n_queries`` N(0, 1) queries, the facade's brute-force and culled
    routes (the kernels on the kernel route, with the nondegenerate flag a
    sphere earns; under ``MESH_TPU_FORCE_XLA`` the plain scan and the top-k
    cull).  Returns the largest face count for brute force: the ladder
    point below the first from which the culled route wins at every larger
    point (that point less one at the ladder's start), or twice the
    ladder's last when brute force always won."""
    from .closest_kernel import closest_point_kernel
    from .closest_point import closest_faces_and_points_t
    from .culled import closest_faces_and_points_culled
    from .culled_kernel import closest_point_culled_kernel

    dev = resolve_device(device)
    use_pallas = pallas_default(dev)
    pts = _queries(n_queries, dev)
    if use_pallas:
        def brute(vt, ft):
            return closest_point_kernel(vt, ft, pts, assume_nondegenerate=True)

        def culled(vt, ft):
            return closest_point_culled_kernel(vt, ft, pts,
                                               assume_nondegenerate=True)
    else:
        def brute(vt, ft):
            return closest_faces_and_points_t(vt, ft, pts)

        def culled(vt, ft):
            return closest_faces_and_points_culled(vt, ft, pts)

    wins, meshes = [], []
    for n_f in ladder:
        meshes.append(_on(dev, n_f))
        vt, ft = meshes[-1]
        wins.append((int(ft.shape[0]),
                     _time_calls(lambda: brute(vt, ft), reps, dev),
                     _time_calls(lambda: culled(vt, ft), reps, dev)))
    # the guard re-times the middle point on its own mesh
    check_t = wins[len(wins) // 2][1]
    vt, ft = meshes[len(wins) // 2]
    recheck = _time_calls(lambda: brute(vt, ft), reps, dev)
    crossover = _first_win(wins, lambda i: wins[i - 1][0] if i > 0
                           else max(1, wins[i][0] - 1))
    if crossover is None:
        crossover = 2 * wins[-1][0]
    global _measured
    _measured = crossover
    _finish("crossover", {
        "crossover_faces": crossover, "pallas": use_pallas,
        "n_queries": n_queries, "reps": reps,
        "ladder": [{"faces": n, "t_brute": tb, "t_culled": tc}
                   for n, tb, tc in wins]},
        _stable(check_t, recheck), save, dev)
    return crossover


@contextlib.contextmanager
def _knob(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def calibrate_accel_crossover(ladder=(32768, 65536, 131072, 262144, 524288),
                              n_queries=1024, reps=3, save=True,
                              device="cuda"):
    """Measure where the spatial index (``closest_faces_and_points_accel``
    of ``MESH_TPU_ACCEL_KIND``) starts beating the ladder's incumbent, the
    auto facade under ``MESH_TPU_NO_ACCEL=1``, on ``device``: the smallest
    ladder point from which the index wins at every larger point (auto
    takes it iff F >= the value), or twice the ladder's last.  Each
    route's index is built in its untimed warm-up call, and each point
    records the walk that served it (``variant``: ``resident``,
    ``stream`` or ``xla``)."""
    from ..accel.traverse import (
        closest_faces_and_points_accel,
        pallas_bvh_variant,
    )
    from .culled import closest_faces_and_points_auto

    dev = resolve_device(device)
    kind = knobs.accel_kind()
    use_pallas = pallas_default(dev)
    pts = _queries(n_queries, dev).cpu().numpy()

    def incumbent(v, f):
        with _knob("MESH_TPU_NO_ACCEL", "1"):
            return _time_calls(lambda: closest_faces_and_points_auto(
                v, f, pts, device=dev), reps, dev)

    wins, meshes = [], []
    for n_f in ladder:
        meshes.append(_sphere_mesh(n_f))
        v, f = meshes[-1]
        t_inc = incumbent(v, f)
        t_accel = _time_calls(lambda: closest_faces_and_points_accel(
            v, f, pts, kind=kind, device=dev), reps, dev)
        variant = (pallas_bvh_variant(f.shape[0])
                   if kind == "bvh" and use_pallas else None)
        wins.append((int(f.shape[0]), t_inc, t_accel, variant or "xla"))
    check_t = wins[len(wins) // 2][1]
    recheck = incumbent(*meshes[len(wins) // 2])
    crossover = _first_win([w[:3] for w in wins], lambda i: wins[i][0])
    if crossover is None:
        crossover = 2 * wins[-1][0]
    global _accel_measured
    _accel_measured = crossover
    _finish("accel_crossover", {
        "accel_min_faces": crossover, "kind": kind, "pallas": use_pallas,
        "n_queries": n_queries, "reps": reps,
        "ladder": [{"faces": n, "t_incumbent": ti, "t_accel": ta,
                    "variant": var} for n, ti, ta, var in wins]},
        _stable(check_t, recheck), save, dev)
    return crossover


def calibrate_stream_tiles(n_faces=262144, n_queries=1024, reps=3,
                           sweep=STREAM_SWEEP, save=True, device="cuda"):
    """Rank ``(tile_q, tile_f, n_buffers)`` configurations of the streamed
    rope walk on ``device`` over a ``_sphere_mesh(n_faces)`` and
    ``n_queries`` N(0, 1) queries (the kernel on the kernel route, its
    plain version under ``MESH_TPU_FORCE_XLA``), each configuration's
    coarse index built before its timing.  An entry the streamed kernel
    cannot take (its shared memory: ``rope_kernel.stream_fits``) is
    recorded as skipped.  Returns the fastest configuration."""
    from ..accel.build import get_index
    from ..accel.rope_kernel import (
        closest_point_bvh_stream_kernel,
        closest_point_bvh_stream_plain,
        stream_fits,
    )

    dev = resolve_device(device)
    use_pallas = pallas_default(dev)
    walk = (closest_point_bvh_stream_kernel if use_pallas
            else closest_point_bvh_stream_plain)
    pts = _queries(n_queries, dev)
    v, f = _sphere_mesh(n_faces)
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)

    def timing(tile_q, tile_f, n_buffers):
        index = get_index(v, f, kind="bvh", leaf_size=int(tile_f))
        return _time_calls(lambda: walk(
            vt, ft, pts, tile_q=tile_q, tile_f=tile_f, n_buffers=n_buffers,
            index=index, device=dev), reps, dev)

    timings, skipped = [], []
    for params in sweep:
        if stream_fits(*params):
            timings.append((timing(*params), tuple(params)))
        else:
            skipped.append(tuple(params))
    if not timings:
        raise ValueError("calibrate_stream_tiles: the streamed kernel takes "
                         "none of %r" % (sweep,))
    t_best, best = min(timings)
    recheck = timing(*best)
    global _stream_measured
    _stream_measured = best
    _finish("stream_tiles", {
        "tile_q": best[0], "tile_f": best[1], "n_buffers": best[2],
        "pallas": use_pallas, "n_faces": n_faces, "n_queries": n_queries,
        "reps": reps,
        "sweep": [{"tile_q": tq, "tile_f": tf, "n_buffers": nb, "t": t}
                  for t, (tq, tf, nb) in timings],
        "skipped": [{"tile_q": tq, "tile_f": tf, "n_buffers": nb}
                    for tq, tf, nb in skipped]},
        _stable(t_best, recheck), save, dev)
    return best


def calibrate_mxu_crossover(ladder=(2048, 8192, 32768, 131072),
                            n_queries=1024, reps=3, tile_q=256, tile_f=2048,
                            save=True, device="cuda"):
    """Measure where the MXU rung (``closest_point_mxu_kernel``) starts
    beating the brute-force kernel (``closest_point_kernel``, the fast
    tile) on ``device``, over ``_sphere_mesh`` meshes of the ``ladder``'s
    face counts and ``n_queries`` N(0, 1) queries: the smallest measured
    face count from which the MXU rung wins at every larger count, or
    twice the ladder's last when the brute-force kernel always won."""
    from .closest_kernel import closest_point_kernel
    from .mxu_kernel import closest_point_mxu_kernel

    dev = resolve_device(device)
    pts = _queries(n_queries, dev)

    def brute(vt, ft):
        return _time_calls(lambda: closest_point_kernel(
            vt, ft, pts, assume_nondegenerate=True), reps, dev)

    wins, meshes = [], []
    for n_f in ladder:
        meshes.append(_on(dev, n_f))
        vt, ft = meshes[-1]
        t_mxu = _time_calls(lambda: closest_point_mxu_kernel(
            vt, ft, pts, assume_nondegenerate=True, tile_q=tile_q,
            tile_f=tile_f, device=dev), reps, dev)
        wins.append((int(ft.shape[0]), brute(vt, ft), t_mxu))
    check_t = wins[len(wins) // 2][1]
    recheck = brute(*meshes[len(wins) // 2])
    crossover = _first_win(wins, lambda i: wins[i][0])
    if crossover is None:
        crossover = 2 * wins[-1][0]
    global _mxu_measured
    _mxu_measured = crossover
    _finish("mxu_crossover", {
        "mxu_crossover_faces": crossover, "tile_q": tile_q, "tile_f": tile_f,
        "n_queries": n_queries, "reps": reps,
        "ladder": [{"faces": n, "t_brute": tb, "t_mxu": tm}
                   for n, tb, tm in wins]},
        _stable(check_t, recheck), save, dev)
    return crossover


def _sphere_mesh(n_faces, seed=0):
    """Synthetic parametric sphere with ~n_faces triangles, float32 and
    int32, with the reference's vertex and face order."""
    n_ring = max(3, int(np.sqrt(n_faces / 2)))
    n_seg = max(3, n_faces // (2 * n_ring))
    theta = np.pi * np.arange(1, n_ring + 1) / (n_ring + 1)
    phi = 2 * np.pi * np.arange(n_seg) / n_seg
    v = np.stack([
        np.outer(np.sin(theta), np.cos(phi)),
        np.outer(np.sin(theta), np.sin(phi)),
        np.outer(np.cos(theta), np.ones(n_seg)),
    ], axis=-1).reshape(-1, 3)
    r = np.arange(n_ring - 1)[:, None]
    s = np.arange(n_seg)[None, :]
    s1 = (s + 1) % n_seg
    b0s, b1s, b1s1, b0s1 = (
        r * n_seg + s, (r + 1) * n_seg + s,
        (r + 1) * n_seg + s1, r * n_seg + s1,
    )
    faces = np.stack(
        [np.stack([b0s, b1s, b1s1], axis=-1),
         np.stack([b0s, b1s1, b0s1], axis=-1)],
        axis=2,
    ).reshape(-1, 3)
    return v.astype(np.float32), faces.astype(np.int32)
