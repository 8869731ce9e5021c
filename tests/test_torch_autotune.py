"""mesh_tpu_torch's routing thresholds and calibrations vs mesh_tpu, on the
CPU with faked timers.

Each calibration's routes are replaced, in both packages, by stand-ins that
name themselves and their mesh, and the timers (the port's ``_time_calls``,
the reference's ``_time_best``) call the stand-in once and look its time up
in one table: both packages are fed the same timings, however they order
their calls, and must pick the same crossover or tiles.  The accessors
resolve override > measured > default, and a malformed or unusable saved
measurement reads as the default; an unstable run is kept for the process
but not saved.
"""

import json

import numpy as np
import pytest
import torch

from mesh_tpu.accel import pallas_stream as jstream
from mesh_tpu.accel import traverse as jtraverse
from mesh_tpu.query import autotune as jautotune
from mesh_tpu.query import closest_point as jclosest
from mesh_tpu.query import culled as jculled
from mesh_tpu.query import pallas_closest as jpallas

from mesh_tpu_torch.accel import rope_kernel as rk
from mesh_tpu_torch.accel import traverse as ttraverse
from mesh_tpu_torch.query import autotune
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import culled as tculled
from mesh_tpu_torch.query import culled_kernel as qk
from mesh_tpu_torch.query import mxu_kernel as mk

MEASURED = ("_measured", "_accel_measured", "_stream_measured",
            "_mxu_measured")
OVERRIDES = ("MESH_TPU_BRUTE_MAX_FACES", "MESH_TPU_ACCEL_MIN_FACES",
             "MESH_TPU_MXU_CROSSOVER_FACES", "MESH_TPU_BVH_STREAM_BUFFERS",
             "MESH_TPU_FORCE_XLA", "MESH_TPU_ACCEL_KIND")


@pytest.fixture
def clean(monkeypatch, tmp_path):
    """No override set, nothing measured in either package, the caches in
    a fresh directory."""
    for name in OVERRIDES:
        monkeypatch.delenv(name, raising=False)
    for name in MEASURED:
        monkeypatch.setattr(autotune, name, None)
        monkeypatch.setattr(jautotune, name, None)
    monkeypatch.setattr(autotune, "CACHE_DIR", str(tmp_path / "port"))
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    monkeypatch.setattr(jautotune, "_cache_path",
                        lambda: str(ref_dir / "crossover_cpu.json"))
    monkeypatch.setattr(jautotune, "_stream_cache_path",
                        lambda: str(ref_dir / "stream_tiles_cpu.json"))
    return monkeypatch


def _stand_in(route):
    """A route that returns its name and its mesh's face count."""
    def run(v, f, *args, **kwargs):
        return route, int(np.shape(f)[0])
    return run


def _fake_timers(mp, table, recheck=1.0):
    """Both packages' timers: one call of the stand-in, its time from
    ``table[route](faces)``; ``recheck`` scales every call after the first
    of each (route, faces), so a re-timed point can disagree with itself."""
    def lookup(fn, seen):
        key = fn()
        scale = recheck if key in seen else 1.0
        seen.add(key)
        return table[key[0]](key[1]) * scale

    seen_port, seen_ref = set(), set()
    mp.setattr(autotune, "_time_calls",
               lambda fn, reps, dev: lookup(fn, seen_port))
    mp.setattr(jautotune, "_time_best", lambda fn, reps: lookup(fn, seen_ref))


LADDER = (80, 160, 320, 640, 1280)

#: incumbent and new route timings over the ladder's face counts
SCENARIOS = {
    "wins_from_middle": lambda n: (1.0, 2.0 if n < 300 else 0.5),
    "never_wins": lambda n: (1.0, 2.0),
    "always_wins": lambda n: (1.0, 0.5),
    "wins_then_loses_then_wins": lambda n: (
        1.0, 0.5 if n < 200 or n > 700 else 2.0),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_crossover_selection_matches_reference(clean, scenario):
    times = SCENARIOS[scenario]
    table = {"brute": lambda n: times(n)[0], "culled": lambda n: times(n)[1]}
    clean.setattr(ck, "closest_point_kernel", _stand_in("brute"))
    clean.setattr(qk, "closest_point_culled_kernel", _stand_in("culled"))
    clean.setattr(jclosest, "closest_faces_and_points", _stand_in("brute"))
    clean.setattr(jculled, "closest_faces_and_points_culled",
                  _stand_in("culled"))
    _fake_timers(clean, table)
    ref = jautotune.calibrate_crossover(ladder=LADDER, n_queries=8,
                                        save=False)
    got = autotune.calibrate_crossover(ladder=LADDER, n_queries=8,
                                       save=False, device="cpu")
    assert got == ref == autotune.crossover_faces()
    rec = autotune.CALIBRATIONS["crossover"]
    assert rec["crossover_faces"] == got and rec["stable"]
    assert [row["faces"] for row in rec["ladder"]] == [
        autotune._sphere_mesh(n)[1].shape[0] for n in LADDER]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_accel_crossover_selection_matches_reference(clean, scenario):
    times = SCENARIOS[scenario]
    table = {"auto": lambda n: times(n)[0], "accel": lambda n: times(n)[1]}
    clean.setattr(tculled, "closest_faces_and_points_auto",
                  _stand_in("auto"))
    clean.setattr(ttraverse, "closest_faces_and_points_accel",
                  _stand_in("accel"))
    clean.setattr(jculled, "closest_faces_and_points_auto",
                  _stand_in("auto"))
    clean.setattr(jtraverse, "closest_faces_and_points_accel",
                  _stand_in("accel"))
    _fake_timers(clean, table)
    ref = jautotune.calibrate_accel_crossover(ladder=LADDER, n_queries=8,
                                              save=False)
    got = autotune.calibrate_accel_crossover(ladder=LADDER, n_queries=8,
                                             save=False, device="cpu")
    assert got == ref == autotune.accel_crossover_faces()
    rec = autotune.CALIBRATIONS["accel_crossover"]
    # the port's CPU runs the kernel route: the resident walk's plain twin
    assert {row["variant"] for row in rec["ladder"]} == {"resident"}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_mxu_crossover_selection_matches_reference(clean, scenario):
    times = SCENARIOS[scenario]
    table = {"brute": lambda n: times(n)[0], "mxu": lambda n: times(n)[1]}
    clean.setattr(ck, "closest_point_kernel", _stand_in("brute"))
    clean.setattr(mk, "closest_point_mxu_kernel", _stand_in("mxu"))
    clean.setattr(jpallas, "closest_point_pallas", _stand_in("brute"))
    clean.setattr(jpallas, "closest_point_pallas_mxu", _stand_in("mxu"))
    _fake_timers(clean, table)
    ref = jautotune.calibrate_mxu_crossover(ladder=LADDER, n_queries=8,
                                            save=False)
    got = autotune.calibrate_mxu_crossover(ladder=LADDER, n_queries=8,
                                           save=False, device="cpu")
    assert got == ref == autotune.mxu_crossover_faces()


def _tile_stand_in(v, f, points, tile_q=128, tile_f=256, n_buffers=2,
                   **kwargs):
    return "stream", (tile_q, tile_f, n_buffers)


@pytest.mark.parametrize("best", [0, 1, 2, 3])
def test_stream_tiles_selection_matches_reference(clean, best):
    sweep = autotune.STREAM_SWEEP
    assert sweep == jautotune.STREAM_SWEEP
    table = {"stream": lambda key: 0.5 if key == sweep[best] else 1.0}
    clean.setattr(rk, "closest_point_bvh_stream_kernel", _tile_stand_in)
    clean.setattr(jstream, "closest_point_pallas_bvh_stream", _tile_stand_in)
    _fake_timers(clean, table)
    ref = jautotune.calibrate_stream_tiles(n_faces=600, n_queries=8,
                                           save=False)
    got = autotune.calibrate_stream_tiles(n_faces=600, n_queries=8,
                                          save=False, device="cpu")
    assert got == tuple(ref) == sweep[best]
    assert autotune.stream_tile_params() == got
    assert autotune.CALIBRATIONS["stream_tiles"]["skipped"] == []


def test_stream_tiles_skips_what_the_kernel_cannot_take(clean):
    too_big = (128, 4096, 16)        # a ring past the shared memory
    assert not rk.stream_fits(*too_big) and rk.stream_fits(128, 256, 2)
    clean.setattr(rk, "closest_point_bvh_stream_kernel", _tile_stand_in)
    _fake_timers(clean, {"stream": lambda key: 1.0})
    got = autotune.calibrate_stream_tiles(
        n_faces=600, n_queries=8, sweep=((128, 256, 2), too_big),
        device="cpu")
    rec = autotune.CALIBRATIONS["stream_tiles"]
    assert got == (128, 256, 2)
    assert rec["skipped"] == [{"tile_q": 128, "tile_f": 4096,
                               "n_buffers": 16}]
    assert [row["tile_f"] for row in rec["sweep"]] == [256]


@pytest.mark.parametrize("stable", [True, False])
def test_unstable_calibration_is_kept_but_not_saved(clean, stable):
    clean.setattr(ck, "closest_point_kernel", _stand_in("brute"))
    clean.setattr(qk, "closest_point_culled_kernel", _stand_in("culled"))
    _fake_timers(clean, {"brute": lambda n: 1.0, "culled": lambda n: 0.5},
                 recheck=1.0 if stable else 3.0)
    got = autotune.calibrate_crossover(ladder=LADDER, n_queries=8,
                                       device="cpu")
    assert autotune.crossover_faces() == got
    path = autotune._cache_path("crossover", "cpu")
    assert autotune.CALIBRATIONS["crossover"]["stable"] == stable
    assert (autotune.os.path.exists(path)) == stable
    if stable:
        with open(path) as fh:
            assert json.load(fh)["crossover_faces"] == got


@pytest.fixture
def fake_card(clean):
    """A card named "Fake Card" whose saved measurements the accessors
    read."""
    clean.setattr(torch.cuda, "is_available", lambda: True)
    clean.setattr(torch.cuda, "get_device_name", lambda *a: "Fake Card")
    autotune.os.makedirs(autotune.CACHE_DIR, exist_ok=True)
    return clean


def _save(name, record):
    with open(autotune._cache_path(name), "w") as fh:
        fh.write(record if isinstance(record, str) else json.dumps(record))


ACCESSORS = [
    ("crossover", "crossover_faces", "MESH_TPU_BRUTE_MAX_FACES",
     autotune.crossover_faces, autotune.DEFAULT_CROSSOVER),
    ("accel_crossover", "accel_min_faces", "MESH_TPU_ACCEL_MIN_FACES",
     autotune.accel_crossover_faces, autotune.ACCEL_DEFAULT_CROSSOVER),
    ("mxu_crossover", "mxu_crossover_faces", "MESH_TPU_MXU_CROSSOVER_FACES",
     autotune.mxu_crossover_faces, autotune.MXU_DEFAULT_CROSSOVER),
]


@pytest.mark.parametrize("name,key,env,accessor,default", ACCESSORS,
                         ids=[a[0] for a in ACCESSORS])
def test_override_beats_measured_beats_default(fake_card, name, key, env,
                                               accessor, default):
    assert autotune._cache_path(name).endswith(
        "%s_cuda_Fake_Card.json" % name)
    _save(name, {key: 777})
    assert accessor() == 777                      # measured, read once
    _save(name, {key: 888})
    assert accessor() == 777
    fake_card.setenv(env, "555")
    assert accessor() == 555                      # override
    fake_card.setenv(env, "many")
    assert accessor() == 777                      # malformed override


@pytest.mark.parametrize("record", ['{"x": 1}', "not json", {"v": -5},
                                    {"v": "12a"}])
@pytest.mark.parametrize("name,key,env,accessor,default", ACCESSORS,
                         ids=[a[0] for a in ACCESSORS])
def test_malformed_measurement_reads_as_default(fake_card, record, name, key,
                                                env, accessor, default):
    if isinstance(record, dict):
        record = {key: record["v"]}
    _save(name, record)
    assert accessor() == default


@pytest.mark.parametrize("record,want", [
    ({"tile_q": 256, "tile_f": 512, "n_buffers": 3}, (256, 512, 3)),
    ({"tile_q": 128, "tile_f": 200, "n_buffers": 2},
     autotune.STREAM_DEFAULT_TILES),
    ({"tile_q": 128, "tile_f": 256, "n_buffers": 1},
     autotune.STREAM_DEFAULT_TILES),
    ("{", autotune.STREAM_DEFAULT_TILES)])
def test_stream_tile_params_read_the_card(fake_card, record, want):
    _save("stream_tiles", record)
    assert autotune.stream_tile_params() == want
    fake_card.setenv("MESH_TPU_BVH_STREAM_BUFFERS", "5")
    assert autotune.stream_tile_params() == want[:2] + (5,)


def test_cpu_reads_no_measurement(clean):
    assert not torch.cuda.is_available()
    assert autotune.crossover_faces() == autotune.DEFAULT_CROSSOVER
    assert autotune.stream_tile_params() == autotune.STREAM_DEFAULT_TILES
