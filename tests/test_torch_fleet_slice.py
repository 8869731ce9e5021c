"""The fleet slice end to end on the CPU: a three-replica ``FleetRouter``
over real ``QueryService`` replicas (the engine rung) and small icosphere
meshes, in both packages.

Every mesh digest must land on the same replica in both packages (the
ring and the routing key are the same functions of the same bytes), the
admission checksums must be equal, each ledger row must carry its
replica and routing key, and the answers must agree within the port's
contract: faces equal except at float64 ties, points within 1e-5.
"""

import types

import numpy as np
import pytest

import mesh_tpu
import mesh_tpu.fleet as jfleet
import mesh_tpu.obs as jobs
import mesh_tpu.serve as jserve
import mesh_tpu.serve.deadline as jdeadline

import mesh_tpu_torch
import mesh_tpu_torch.fleet as tfleet
import mesh_tpu_torch.obs as tobs
import mesh_tpu_torch.serve as tserve
import mesh_tpu_torch.serve.deadline as tdeadline

from .test_torch_anim import sphere
from .test_torch_fleet import FakeRecorder
from .test_torch_serve import _assert_serve_answers

PORT = types.SimpleNamespace(fleet=tfleet, serve=tserve, obs=tobs,
                             deadline=tdeadline,
                             mesh=lambda v, f: mesh_tpu_torch.Mesh(
                                 v, f, device="cpu"))
REF = types.SimpleNamespace(fleet=jfleet, serve=jserve, obs=jobs,
                            deadline=jdeadline,
                            mesh=lambda v, f: mesh_tpu.Mesh(v=v, f=f))

REPLICAS = ("replica-0", "replica-1", "replica-2")
N_MESHES = 6
REQUESTS_PER_MESH = 2


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in ("MESH_TPU_FLEET", "MESH_TPU_FLEET_SPILL",
                "MESH_TPU_FLEET_VNODES", "MESH_TPU_TRACE_CONTEXT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", str(tmp_path / "incidents"))
    monkeypatch.setenv("MESH_TPU_SERVE_STATS", str(tmp_path / "stats.json"))
    for pkg in (PORT, REF):
        pkg.obs.reset()
    yield
    for pkg in (PORT, REF):
        pkg.obs.reset()


@pytest.fixture(scope="module")
def meshes():
    """Six 320-face icospheres whose faces are in six different orders
    (six topology digests), each with its own queries."""
    v, f = sphere(2)
    rng = np.random.RandomState(27)
    out = []
    for i in range(N_MESHES):
        order = rng.permutation(len(f))
        vi = np.asarray(v * (1.0 + 0.1 * i), np.float32)
        q = np.asarray(rng.randn(64, 3) * 0.8, np.float32)
        out.append((vi, np.ascontiguousarray(f[order]), q))
    return out


def _fleet_run(pkg, meshes):
    router = pkg.fleet.FleetRouter(recorder=FakeRecorder())
    for name in REPLICAS:
        router.add_replica(name, pkg.serve.QueryService(
            workers=1, default_deadline_s=60.0,
            ladder=[pkg.serve.Rung("engine", pkg.deadline._rung_engine)],
            health=pkg.serve.HealthMonitor(watchdog=False)))
    objs = [pkg.mesh(v, f) for v, f, _ in meshes]
    try:
        primaries = [router.plan("closest_point", m, q)[1][0]
                     for m, (_, _, q) in zip(objs, meshes)]
        futures = [router.submit(m, q, tenant="t%d" % i)
                   for _ in range(REQUESTS_PER_MESH)
                   for i, (m, (_, _, q)) in enumerate(zip(objs, meshes))]
        answers = [fut.result(timeout=120.0) for fut in futures]
        rows = [(r["tenant"], r["replica"], r["routing_key"], r["rung"],
                 r["outcome"]) for r in pkg.obs.get_ledger().records()]
        return (primaries, router.admission_checksums(), sorted(rows),
                answers)
    finally:
        router.stop(write_stats=False)


def test_fleet_on_icospheres_matches_reference(meshes):
    primaries, sums, rows, answers = _fleet_run(PORT, meshes)
    jprimaries, jsums, jrows, janswers = _fleet_run(REF, meshes)
    assert primaries == jprimaries
    assert len(set(primaries)) > 1           # the digests spread out
    assert sums == jsums and set(sums) == set(primaries)
    assert rows == jrows
    assert len(rows) == N_MESHES * REQUESTS_PER_MESH
    for tenant, replica, key, rung, outcome in rows:
        i = int(tenant[1:])
        assert replica == primaries[i] and rung == "engine"
        assert outcome == "ok" and key.endswith("|64")
    for k, (out, ref) in enumerate(zip(answers, janswers)):
        v, f, q = meshes[k % N_MESHES]
        assert out.rung == ref.rung == "engine" and out.certified
        _assert_serve_answers(ref, out, v, f, q)
