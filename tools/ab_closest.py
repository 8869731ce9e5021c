#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's brute-force closest_faces kernel, exact
and fused, and of the main-path step, in two checkouts, on one CUDA card,
in one run.

    python3 tools/ab_closest.py --other DIR [--pairs 4] [--rounds 5]
                                [--reps 10]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``).  The inputs are made once, here, on the
card, with chip_smoke.py's seeds and shapes: phase 3's 256 posed
SMPL-sized bodies, 1024 N(0, 0.4) queries each.  Each side then runs in a
process of its own, from its own checkout, ``--pairs`` times, the pairs
alternating which side runs first (other, this, this, other, ...).  A
process times, in the main path's tile (fast, the degenerate tail as
``mesh_is_nondegenerate`` decides), ``argmin_faces`` with the exact and
the fused reduction on operands made beforehand (``exact``, ``fused``;
where the checkout has the chunk cull, its operands are made beforehand
too, and ``exact_with_prologue`` / ``fused_with_prologue`` time the call
that makes them), chip_smoke's main-path step (``lbs`` then
``batch_step``) and its fused step (``lbs``, vertex normals, then
``closest_point_kernel(reduction="fused")``): CUDA events around
``--reps`` back-to-back calls, in ``--rounds`` rounds that interleave the
variants, the median over the rounds.  The first process of a side builds
its kernels (with ``-Xptxas -v``; closest_faces' register and spill lines
are printed).  Every face must equal every other of the same variant,
across processes and sides.  Prints one line per process and, last, one
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
import json, statistics, sys
import torch
sys.path.insert(0, ".")
from mesh_tpu_torch import _build
from mesh_tpu_torch.batch import batch_step
from mesh_tpu_torch.geometry.vert_normals import vert_normals_t
from mesh_tpu_torch.models import lbs, synthetic_body_model
from mesh_tpu_torch.query import closest_kernel as ck

inputs = torch.load(sys.argv[1])
reps, rounds, out_path = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
report = _build.build(verbose=True)
ptxas = [line.strip() for line in report.get("closest_faces", {}).get(
    "ptxas", "").splitlines() if "registers" in line or "spill" in line]
dev = torch.device("cuda")
model = synthetic_body_model(seed=0, device=dev)
f = model.faces
betas, pose = inputs["betas"].to(dev), inputs["pose"].to(dev)
queries = inputs["queries"].to(dev)
nondegen = inputs["nondegen"]
variant, tail = "fast", not nondegen
verts, _ = lbs(model, betas, pose, device=dev)
pts, planes, _, _ = ck.closest_point_operands(verts, f, queries, variant)
culls = hasattr(ck, "cull_operands")
cull = ck.cull_operands(pts, planes, variant, tail) if culls else None
variants, answers = [], {}
for red in ("exact", "fused"):
    kw = {"reduction": red}
    if culls:
        kw["cull"] = cull
    variants.append((red, lambda kw=kw: ck.argmin_faces(
        pts, planes, variant, tail, **kw)))
    answers[red] = ck.argmin_faces(pts, planes, variant, tail, **kw).cpu()
    if culls:
        variants.append((red + "_with_prologue", lambda red=red:
                         ck.argmin_faces(pts, planes, variant, tail,
                                         reduction=red)))
def step():
    v, _ = lbs(model, betas, pose, device=dev)
    return batch_step(v, f, queries, assume_nondegenerate=nondegen,
                      tile_variant=variant)
def step_fused():
    v, _ = lbs(model, betas, pose, device=dev)
    normals = vert_normals_t(v, f)
    return normals, ck.closest_point_kernel(
        v, f, queries, assume_nondegenerate=nondegen, tile_variant=variant,
        reduction="fused")
variants += [("step", step), ("step_fused", step_fused)]
answers["step"] = step()[1]["face"].cpu()
answers["step_fused"] = step_fused()[1]["face"].cpu()
times = {name: [] for name, _ in variants}
for _ in range(rounds):
    for name, fn in variants:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / reps)
torch.save(answers, out_path)
print(json.dumps({"ms": {k: statistics.median(v) for k, v in times.items()},
                  "rounds_ms": times, "culls": culls, "ptxas": ptxas}))
"""


def inputs():
    """chip_smoke.py phase 3's inputs on the CPU: the betas, poses and
    queries of the 256 bodies, and whether the posed batch passes the
    nondegeneracy check (which picks the degenerate tail)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.query import closest_kernel as ck

    dev = torch.device("cuda")
    model = synthetic_body_model(seed=0, device=dev)
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    queries = torch.as_tensor(
        rng.randn(cs.BATCH, cs.QUERIES_PER_MESH, 3) * 0.4,
        dtype=torch.float32, device=dev)
    verts, _ = lbs(model, betas, pose, device=dev)
    return {"betas": betas.cpu(), "pose": pose.cpu(),
            "queries": queries.cpu(),
            "nondegen": ck.mesh_is_nondegenerate(
                verts.cpu().numpy(), model.faces.cpu().numpy())}


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi failed: %s" % exc


def check_answers(paths):
    """The answers that differ from the first process's (empty when all
    agree)."""
    import torch

    runs = [torch.load(p) for p in paths]
    return sorted({key for run in runs for key, got in run.items()
                   if not torch.equal(got, runs[0][key])})


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
        sys.exit("ab_closest: no CUDA card")
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "mesh_tpu_torch", "query",
                                       "closest_kernel.py")):
        sys.exit("ab_closest: %s holds no mesh_tpu_torch" % other)
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
                text=True, timeout=900)
            if res.returncode:
                sys.stderr.write(res.stderr)
                sys.exit("ab_closest: the %s side failed" % side)
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
        sys.exit("ab_closest: answers differ: %s" % ", ".join(bad))


if __name__ == "__main__":
    main()
