"""mesh_tpu_torch.utils.lockwitness vs mesh_tpu.utils.lockwitness.

The wrapper and its shadow stacks are driven directly in both packages
(no global factory patching in this process): the same acquisition
sequences must record the same edge multisets and dump the same files.
One subprocess imports the port with ``MESH_TPU_LOCK_WITNESS=1``, sends
requests through a two-replica ``FleetRouter`` and dumps its edges: every
site is under ``mesh_tpu_torch/``, the order graph is acyclic, and the
router's lock is witnessed above the replicas' health monitors.
"""

import json
import os
import subprocess
import sys
import threading
import types

import pytest

from mesh_tpu.utils import lockwitness as jwit

from mesh_tpu_torch.utils import lockwitness as twit

PORT = types.SimpleNamespace(wit=twit, pkg="mesh_tpu_torch", name="port")
REF = types.SimpleNamespace(wit=jwit, pkg="mesh_tpu", name="ref")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_state():
    twit.reset()
    jwit.reset()
    yield
    twit.reset()
    jwit.reset()


def _same(fn):
    mine, theirs = fn(PORT), fn(REF)
    assert mine == theirs
    return mine


def _wrapped(pkg, name, factory=threading.Lock):
    return pkg.wit._WitnessedLock(factory(), "%s/%s" % (pkg.pkg, name))


def _norm(pkg, edges):
    """Edges with the package folder dropped from each site."""
    cut = len(pkg.pkg) + 1
    return {(a[cut:], b[cut:]): n for (a, b), n in edges.items()}


def test_nested_and_reentrant_orders_equal():
    def run(pkg):
        a = _wrapped(pkg, "a.py:1", threading.RLock)
        b = _wrapped(pkg, "b.py:2")
        c = _wrapped(pkg, "c.py:3")
        with a:
            with b:
                with c:
                    pass
                with a:          # re-entrant: not an ordering fact
                    pass
        with a:
            with b:
                pass
        with c:
            pass
        return _norm(pkg, pkg.wit.edges())

    assert _same(run) == {("a.py:1", "b.py:2"): 2, ("a.py:1", "c.py:3"): 1,
                          ("b.py:2", "c.py:3"): 1}


def test_edges_are_per_thread_and_condition_passthrough():
    def run(pkg):
        a = _wrapped(pkg, "a.py:1")
        b = _wrapped(pkg, "b.py:2")

        def other():
            with b:
                pass

        with a:
            t = threading.Thread(target=other)
            t.start()
            t.join()
        cond = threading.Condition(_wrapped(pkg, "c.py:3", threading.RLock))
        with cond:
            cond.notify_all()
        return _norm(pkg, pkg.wit.edges()), a.locked()

    assert _same(run) == ({}, False)


def test_dump_load_roundtrip_equal(tmp_path):
    def run(pkg):
        a = _wrapped(pkg, "a.py:1")
        b = _wrapped(pkg, "b.py:2")
        with a:
            with b:
                pass
        path = str(tmp_path / pkg.name / "wit.jsonl")
        pkg.wit.dump(path)
        with open(path, encoding="utf-8") as fh:
            text = fh.read().replace(pkg.pkg + "/", "")
        loaded = [((s[0].split("/", 1)[1], s[1]), (d[0].split("/", 1)[1],
                                                    d[1]), n)
                  for s, d, n in pkg.wit.load(path)]
        return text, loaded

    text, loaded = _same(run)
    assert loaded == [(("a.py", 1), ("b.py", 2), 1)]
    assert {"site": ["a.py", 1]} in [json.loads(ln)
                                     for ln in text.splitlines()]


def test_witness_file_default_is_the_ports(monkeypatch):
    monkeypatch.delenv("MESH_TPU_LOCK_WITNESS_FILE", raising=False)
    assert twit.witness_file().endswith(
        os.path.join(".mesh_tpu_torch", "lock_witness.jsonl"))
    monkeypatch.setenv("MESH_TPU_LOCK_WITNESS_FILE", "/x/w.jsonl")
    assert twit.witness_file() == "/x/w.jsonl"


_CHILD = r"""
import sys
import numpy as np

import mesh_tpu_torch
from mesh_tpu_torch.fleet import FleetRouter
from mesh_tpu_torch.serve import (HealthMonitor, QueryService, Rung,
                                  ServeResult)
from mesh_tpu_torch.utils import lockwitness
assert lockwitness.installed(), "witness knob did not install"

class Digest(object):
    def __init__(self, key):
        self.topology_key = key

def ok(mesh, points, chunk, timeout):
    return ServeResult(np.zeros((1, 4), np.uint32), np.zeros((4, 3)), "ok",
                       certified=True)

router = FleetRouter()
for name in ("w-a", "w-b"):
    router.add_replica(name, QueryService(
        ladder=[Rung("ok", ok)], health=HealthMonitor(watchdog=False),
        workers=2, default_deadline_s=30.0))
try:
    futures = [router.submit(Digest("d%d" % (i % 5)), np.zeros((4, 3)),
                             tenant="t%d" % (i % 2)) for i in range(12)]
    for fut in futures:
        fut.result(timeout=60)
finally:
    router.stop(write_stats=False)
print(lockwitness.dump(sys.argv[1]))
"""


def _acyclic(edges):
    graph = {}
    for src, dst, _ in edges:
        graph.setdefault(src, set()).add(dst)
    state = {}

    def visit(node):
        state[node] = 1
        for nxt in graph.get(node, ()):
            if state.get(nxt) == 1 or (nxt not in state and not visit(nxt)):
                return False
        state[node] = 2
        return True

    return all(state.get(n) == 2 or visit(n) for n in list(graph))


def test_witnessed_router_orders(tmp_path):
    path = str(tmp_path / "witness.jsonl")
    env = dict(os.environ, MESH_TPU_LOCK_WITNESS="1",
               MESH_TPU_LOCK_WITNESS_FILE=path,
               MESH_TPU_SERVE_STATS=str(tmp_path / "stats.json"),
               MESH_TPU_INCIDENT_DIR=str(tmp_path / "incidents"))
    proc = subprocess.run([sys.executable, "-c", _CHILD, path], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    edges = twit.load(path)
    with open(path, encoding="utf-8") as fh:
        sites = [json.loads(ln)["site"] for ln in fh if '"site"' in ln]
    assert edges and sites
    for rel, _ in sites:
        assert rel.startswith("mesh_tpu_torch/"), rel
    assert _acyclic(edges)
    assert any(src[0] == "mesh_tpu_torch/fleet/router.py"
               and dst[0] == "mesh_tpu_torch/serve/health.py"
               for src, dst, _ in edges), edges
