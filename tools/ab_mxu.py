#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's MXU rung (the dense scan ``mxu_faces``, the
bf16 bound pass, the repair ``mxu_repair``, and the ``Mesh`` calls over
them) in two checkouts, on one CUDA card, in one run.

    python3 tools/ab_mxu.py --other DIR [--pairs 4] [--rounds 5] [--reps 10]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``).  The inputs are made once, here, on the
card, with chip_smoke.py's seeds and shapes: phase 12's three sets, posed
body 0 with phase 4's 4096 N(0, 0.4) queries and the 32,512-face
``_sphere_mesh(32768)`` with 65,536 surface-proximal queries (patches of
256) and 65,536 N(0, 0.4) ones.  Each side then runs in a process of its
own, from its own checkout, ``--pairs`` times, the pairs alternating which
side runs first (other, this, this, other, ...).  A process times, per set
and in its drive's tail (``mesh_is_nondegenerate``): ``mxu_faces`` and
``mxu_repair`` on operands made beforehand (``faces``, ``repair``; the
repair's ub and cert from ``mxu_bound`` beforehand too); where the checkout
has the chunk cull, its operands are made beforehand as well,
``*_with_prologue`` time the call that makes them, ``prologue`` times
``mxu_cull_operands`` alone, ``*_split<n>`` each split of a warp's chunks
and ``*_every`` the every-face oracles.  The bound pass: ``bound`` is the
checkout's own (``mxu_bound_culled`` on the cull operands made beforehand
where it has the bound's chunk cull, else the every-face ``mxu_bound``),
``bound_every`` the every-face kernel, ``bound_with_prologue`` and
``bound_split<n>`` as above; ``repair_path`` times the repair's kernel chain
as a call makes it (the cull operands made once and shared by the bound
pass and the repair where the checkout has the bound's cull, the parent's
bound pass and repair with its own Morton order otherwise), and
``repair_path_split<n>`` the same with the bound pass at split n; the
bound variants' answers are the repair's faces from their ub and cert.
Then the ``Mesh`` calls of phase 12
under ``MESH_TPU_MXU=1`` (``dense_call``) and with ``MESH_TPU_MXU_BF16=1``
(``repair_call``) on one ``Mesh`` a set, as phase 12 calls it, the MXU
crossover pinned at its default of 8192 faces.  Kernels: CUDA events around ``--reps`` back-to-back calls; calls:
the host clock around ``--reps`` calls, each ending in its
numpy answers; ``--rounds`` rounds that interleave the variants, the
median over the rounds.  The first process of a side builds its kernels
(with ``-Xptxas -v``; the MXU kernels' register and spill lines are
printed).  Every face must equal every other of the same set, across
variants, processes and sides.  Prints one line per process and, last, one
JSON object with every reading, per variant the median of each side's
medians and the fastest round, and the card's name and power limit; exits
non-zero without a card or when two answers differ.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: what each side's process runs, from its own checkout
SIDE = r"""
import json, os, statistics, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
from mesh_tpu_torch import Mesh, _build
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import mxu_kernel as mk

inputs = torch.load(sys.argv[1])
reps, rounds, out_path = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
report = _build.build(verbose=True)
ptxas = ["%s: %s" % (name, line.strip())
         for name in ("mxu_faces", "mxu_repair", "mxu_bound",
                      "mxu_bound_culled")
         for line in report.get(name, {}).get("ptxas", "").splitlines()
         if "registers" in line or "spill" in line]
dev = torch.device("cuda")
culls = hasattr(mk, "mxu_cull_operands")
bounds = hasattr(mk, "mxu_bound_culled")
splits = (1, 4, 16, 64) if culls else ()
#: the bound pass's splits: 32 is the default at 65,536 queries
bound_splits = (1, 4, 16, 32, 64)


def kernel_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


variants, answers = [], {}
for label, (v, f, q) in inputs["sets"].items():
    v_np, f_np, q_np = v.numpy(), f.numpy(), q.numpy()
    tail = not ck.mesh_is_nondegenerate(v_np, f_np)
    vt, ft, qt = v.to(dev), f.to(dev), q.to(dev)
    p, rec, _, _, _ = mk.mxu_operands(vt, ft, qt, device=dev)
    ub, cert = mk.mxu_bound(p, rec)
    kw = {"degenerate_tail": tail}
    if culls:
        kw["cull"] = mk.mxu_cull_operands(p, rec, tail)
    got = {}
    for name, fn in (
            ("faces", lambda kw=kw, p=p, rec=rec: mk.mxu_faces(p, rec, **kw)),
            ("repair", lambda kw=kw, p=p, rec=rec, ub=ub, cert=cert:
             mk.mxu_repair(p, rec, ub, cert, **kw)[0])):
        variants.append(("%s %s" % (label, name), kernel_ms, fn))
        got[name] = fn()
    if culls:
        variants.append(("%s prologue" % label, kernel_ms,
                         lambda p=p, rec=rec, tail=tail:
                         mk.mxu_cull_operands(p, rec, tail)))
        for name, fn in (
                ("faces_with_prologue", lambda p=p, rec=rec, tail=tail:
                 mk.mxu_faces(p, rec, degenerate_tail=tail)),
                ("repair_with_prologue",
                 lambda p=p, rec=rec, ub=ub, cert=cert, tail=tail:
                 mk.mxu_repair(p, rec, ub, cert, degenerate_tail=tail)[0]),
                ("faces_every", lambda p=p, rec=rec, tail=tail:
                 mk.mxu_faces_every(p, rec, degenerate_tail=tail)),
                ("repair_every",
                 lambda p=p, rec=rec, ub=ub, cert=cert, tail=tail:
                 mk.mxu_repair_every(p, rec, ub, cert,
                                     degenerate_tail=tail)[0])):
            variants.append(("%s %s" % (label, name), kernel_ms, fn))
            got[name] = fn()
        for split in splits:
            for name, fn in (
                    ("faces", lambda kw=kw, p=p, rec=rec, split=split:
                     mk.mxu_faces(p, rec, split=split, **kw)),
                    ("repair", lambda kw=kw, p=p, rec=rec, ub=ub, cert=cert,
                     split=split: mk.mxu_repair(p, rec, ub, cert,
                                                split=split, **kw)[0])):
                key = "%s_split%d" % (name, split)
                variants.append(("%s %s" % (label, key), kernel_ms, fn))
                got[key] = fn()
    def via_repair(fn, p=p, rec=rec, tail=tail):
        ub_, cert_ = fn()[:2]
        return mk.mxu_repair(p, rec, ub_, cert_, degenerate_tail=tail)[0]

    def repair_path(p=p, rec=rec, tail=tail, split=None):
        if not bounds:
            ub_, cert_ = mk.mxu_bound(p, rec)
            return mk.mxu_repair(p, rec, ub_, cert_,
                                 degenerate_tail=tail)[0]
        cull = mk.mxu_cull_operands(p, rec, tail)
        ub_, cert_ = mk.mxu_bound_culled(p, rec, cull=cull, split=split)
        return mk.mxu_repair(p, rec, ub_, cert_, degenerate_tail=tail,
                             cull=cull)[0]

    entries = [("bound_every", lambda p=p, rec=rec: mk.mxu_bound(p, rec))]
    if bounds:
        entries += [
            ("bound", lambda p=p, rec=rec, kw=kw: mk.mxu_bound_culled(
                p, rec, cull=kw["cull"])),
            ("bound_with_prologue",
             lambda p=p, rec=rec: mk.mxu_bound_culled(p, rec))]
        entries += [("bound_split%d" % split,
                     lambda p=p, rec=rec, kw=kw, split=split:
                     mk.mxu_bound_culled(p, rec, cull=kw["cull"],
                                         split=split))
                    for split in bound_splits]
    else:
        entries.append(("bound", lambda p=p, rec=rec: mk.mxu_bound(p, rec)))
    for name, fn in entries:
        variants.append(("%s %s" % (label, name), kernel_ms, fn))
        got[name] = via_repair(fn)
    for name, split in [("repair_path", None)] + [
            ("repair_path_split%d" % s, s) for s in (bound_splits if bounds
                                                     else ())]:
        fn = (lambda split=split, repair_path=repair_path:
              repair_path(split=split))
        variants.append(("%s %s" % (label, name), kernel_ms, fn))
        got[name] = fn()
    mesh = Mesh(v_np, f_np, device=dev)
    for mode in ("dense_call", "repair_call"):
        def call(mesh=mesh, q_np=q_np, mode=mode):
            os.environ["MESH_TPU_MXU"] = "1"
            os.environ["MESH_TPU_MXU_CROSSOVER_FACES"] = "8192"
            if mode == "repair_call":
                os.environ["MESH_TPU_MXU_BF16"] = "1"
            else:
                os.environ.pop("MESH_TPU_MXU_BF16", None)
            return mesh.closest_faces_and_points(q_np)[0][0]
        variants.append(("%s %s" % (label, mode), call_ms, call))
        got[mode] = torch.as_tensor(call().astype(np.int64))
    n_q = q.shape[0]
    answers[label] = {k: x[:n_q].long().cpu() for k, x in got.items()}
times = {name: [] for name, _, _ in variants}
for _ in range(rounds):
    for name, timer, fn in variants:
        times[name].append(timer(fn))
torch.save(answers, out_path)
print(json.dumps({"ms": {k: statistics.median(v) for k, v in times.items()},
                  "rounds_ms": times, "culls": culls, "ptxas": ptxas}))
"""


def inputs():
    """chip_smoke.py phase 12's inputs on the CPU: posed body 0 and phase
    4's queries, the sphere's surface patches and N(0, 0.4) queries."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.query.autotune import _sphere_mesh

    dev = torch.device("cuda")
    model = synthetic_body_model(seed=0, device=dev)
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    rng.randn(cs.BATCH, cs.QUERIES_PER_MESH, 3)      # the main path's
    q1 = (rng.randn(1, cs.FACADE_QUERIES, 3) * 0.4).astype(np.float32)[0]
    verts, _ = lbs(model, betas, pose, device=dev)
    v_m, f_m = _sphere_mesh(cs.MXU_SPHERE_FACES)
    rng_m = np.random.RandomState(12)
    surface = cs.surface_patches(cs.MXU_QUERIES, rng_m)
    randn = (rng_m.randn(cs.MXU_QUERIES, 3) * 0.4).astype(np.float32)

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x, dtype))

    return {"sets": {
        "body0": (verts[0].cpu(), model.faces.cpu().to(torch.int32),
                  t(q1, np.float32)),
        "sphere_surface": (t(v_m, np.float32), t(f_m, np.int32),
                           t(surface, np.float32)),
        "sphere_randn": (t(v_m, np.float32), t(f_m, np.int32),
                         t(randn, np.float32))}}


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi failed: %s" % exc


def check_answers(paths):
    """The (set, variant) answers that differ from the first process's
    dense faces of the same set (empty when all agree)."""
    import torch

    runs = [torch.load(p) for p in paths]
    return sorted("%s %s" % (label, key) for run in runs
                  for label, got in run.items() for key, faces in got.items()
                  if not torch.equal(faces, runs[0][label]["faces"]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root directory")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_mxu: no CUDA card")
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "mesh_tpu_torch", "query",
                                       "mxu_kernel.py")):
        sys.exit("ab_mxu: %s holds no mesh_tpu_torch" % other)
    runs, outs = [], []
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs(), path)
        order = [("other", other), ("this", HERE)]
        for k, (side, root) in enumerate(
                [run for p in range(args.pairs)
                 for run in (order if p % 2 == 0 else order[::-1])]):
            out = os.path.join(tmp, "answers_%d.pt" % k)
            res = subprocess.run(
                [sys.executable, "-c", SIDE, path, str(args.reps),
                 str(args.rounds), out], cwd=root, capture_output=True,
                text=True, timeout=1200)
            if res.returncode:
                sys.stderr.write(res.stderr)
                sys.exit("ab_mxu: the %s side failed" % side)
            reading = json.loads(res.stdout.strip().splitlines()[-1])
            runs.append({"side": side, "readings": reading})
            outs.append(out)
            print("%s (%s): %s" % (side, root, ", ".join(
                "%s %.4f" % kv for kv in reading["ms"].items())), flush=True)
            for line in reading["ptxas"]:
                print("  %s ptxas: %s" % (side, line), flush=True)
        bad = check_answers(outs)
    summary, fastest = {}, {}
    for side in ("other", "this"):
        mine = [run["readings"] for run in runs if run["side"] == side]
        keys = sorted({k for r in mine for k in r["ms"]})
        summary[side] = {k: statistics.median(r["ms"][k] for r in mine
                                              if k in r["ms"])
                         for k in keys}
        fastest[side] = {k: min(min(r["rounds_ms"][k]) for r in mine
                                if k in r["rounds_ms"]) for k in keys}
    print(json.dumps({"card": card(), "reps": args.reps,
                      "rounds": args.rounds, "pairs": args.pairs,
                      "median_ms": summary, "min_round_ms": fastest,
                      "answers_agree": not bad, "differ": bad,
                      "runs": runs}))
    if bad:
        sys.exit("ab_mxu: answers differ: %s" % ", ".join(bad))


if __name__ == "__main__":
    main()
