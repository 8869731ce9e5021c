"""mesh_tpu_torch.utils.profiling and the torch.monitor bridge on the CPU.

``Timer``, ``host_sync`` and ``time_fn`` keep the reference's contracts
(mesh_tpu/utils/profiling.py), with PyTorch's synchronization: a CPU
tensor needs none.  ``trace`` writes a Chrome trace naming the profiled
ops.  The bridge (obs/torch_bridge.py) folds ``_build``'s kernel-cache
events into the registry, installs once, and never lets a handler's
error break a build.
"""

import datetime
import json
import os

import numpy as np
import pytest
import torch

import mesh_tpu.utils as jutils
from mesh_tpu.utils.profiling import Timer as JTimer

import mesh_tpu_torch.obs as tobs
import mesh_tpu_torch.utils as tutils
from mesh_tpu_torch import _build
from mesh_tpu_torch.obs import torch_bridge
from mesh_tpu_torch.obs.metrics import Registry
from mesh_tpu_torch.utils.profiling import Timer, host_sync, time_fn, trace


def test_utils_exports_the_references_profiling_names():
    for name in ("Timer", "host_sync", "time_fn", "trace"):
        assert getattr(tutils, name) is not None
        assert hasattr(jutils, name)


def test_host_sync_returns_input_and_skips_cpu_and_plain_values():
    tree = {"a": torch.arange(4), "b": [torch.ones(2), 3.0, None],
            "c": (np.zeros(2), "x")}
    assert host_sync(tree) is tree
    assert host_sync([1, "x", None]) == [1, "x", None]


def test_timer_contract_matches_the_reference():
    lines = {}
    for name, cls, make in (("port", Timer, lambda: torch.arange(100)),
                            ("ref", JTimer, lambda: np.arange(100))):
        out = []
        with cls("named", log=out.append) as t:
            x = t.watch(make().sum())
        assert int(x) == 4950 and t.elapsed > 0
        assert t.sync_elapsed is not None and t.elapsed >= t.sync_elapsed
        lines[name] = out[0].split(":")[0]
        with cls("n") as t:
            pass
        assert t.elapsed >= 0 and t.sync_elapsed is None
        t = cls("boom")
        with pytest.raises(RuntimeError):
            with t:
                t.watch(make())
                raise RuntimeError("device flaked")
        assert t.elapsed is not None and t.sync_elapsed is None
    assert lines["port"] == lines["ref"] == "named"


def test_time_fn():
    v = torch.ones((64, 3))
    t = time_fn(lambda: (v * 2).sum(), reps=3, warmup=1)
    assert 0 < t < 10
    assert time_fn(lambda: np.ones(8).sum(), reps=2, warmup=0) >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "tr") as prof:
        host_sync(torch.mm(torch.ones(32, 32), torch.ones(32, 32)))
    with open(prof.trace_path) as fh:
        doc = json.load(fh)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "aten::mm" in names
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")


@pytest.fixture
def bridge():
    """The bridge installed into a private registry for the test."""
    from torch import monitor

    if torch_bridge._handle is not None:
        torch_bridge._unregister(monitor, torch_bridge._handle)
    registry = Registry()
    assert torch_bridge.install_torch_monitoring_bridge(registry)
    yield registry
    torch_bridge._unregister(monitor, torch_bridge._handle)


def test_bridge_counts_kernel_cache_events(bridge):
    assert tobs.install_jax_monitoring_bridge is \
        tobs.install_torch_monitoring_bridge
    assert tobs.install_jax_monitoring_bridge(Registry()) is True  # once
    _build._log_cache_event("closest_faces", True, 0.002)
    _build._log_cache_event("cull_records", True, 0.001)
    _build._log_cache_event("leaf_boxes", False, 21.5)
    from torch import monitor

    monitor.log_event(monitor.Event(
        name="other.event", timestamp=datetime.datetime.now(), data={}))
    snap = bridge.snapshot()
    hits = snap["mesh_tpu_kernel_cache_hits_total"]["series"]
    assert sorted(s["labels"]["library"] for s in hits) == [
        "closest_faces", "cull_records"]
    misses = snap["mesh_tpu_kernel_cache_misses_total"]["series"]
    assert [(s["labels"], s["value"]) for s in misses] == [
        ({"library": "leaf_boxes"}, 1)]
    seconds = {s["labels"]["outcome"]: s for s in
               snap["mesh_tpu_kernel_cache_seconds"]["series"]}
    assert seconds["miss"]["count"] == 1 and seconds["miss"]["sum"] == 21.5
    assert seconds["hit"]["count"] == 2
    assert snap["mesh_tpu_torch_events_total"]["series"] == [
        {"labels": {"event": "other.event"}, "value": 1}]


def test_a_handler_error_never_breaks_a_build(bridge):
    from torch import monitor

    def broken(event):
        raise RuntimeError("handler bug")

    handle = monitor.register_event_handler(broken)
    try:
        _build._log_cache_event("closest_faces", True, 0.001)
    finally:
        monitor.unregister_event_handler(handle)
    assert bridge.get("mesh_tpu_kernel_cache_hits_total").total() == 1


def test_build_logs_one_event_per_library(bridge, monkeypatch, tmp_path):
    """A build where every library is already on disk: one hit each."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_library_path",
                        lambda name: str(tmp_path / (name + ".so")))
    for name in _build.KERNELS:
        (tmp_path / (name + ".so")).write_bytes(b"")
    assert _build.build() == {}
    hits = bridge.get("mesh_tpu_kernel_cache_hits_total")
    assert hits.total() == len(_build.KERNELS)
    assert bridge.get("mesh_tpu_kernel_cache_misses_total").total() == 0
