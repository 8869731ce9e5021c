#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's normal-weighted kernel
(normal_weighted_faces) and of the registration call around it, in two
checkouts, on one CUDA card, in one run.

    python3 tools/ab_nw.py --other DIR [--pairs 4] [--rounds 5] [--reps 10]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``).  The inputs are made once, here, on the
card, with chip_smoke.py's seeds and shapes: phase 8's posed body 0 (13,776
faces) and its 65,536 scan points with noisy normals, the planted miss
last.  Each side then runs in a process of its own, from its own checkout,
``--pairs`` times, the pairs alternating which side runs first (other,
this, this, other, ...).  A process times, with and without the degenerate
tail, ``argmin_normal_weighted`` on operands made beforehand (``kernel``;
where the checkout has the chunk cull, its operands are made beforehand
too, ``with_prologue`` times the call that makes them and ``prologue``
the operands alone), the every-face kernel (``every``: the checkout's
``argmin_normal_weighted_every``, or its ``argmin_normal_weighted`` where
it has no cull), each split of ``--splits`` in the drive's tail
(``split<n>``), and phase 8's warm ``AabbNormalsTree.nearest`` call
(``nearest``): CUDA events around ``--reps`` back-to-back calls, in
``--rounds`` rounds that interleave the variants, the median over the
rounds.  The first process of a side builds its kernels (with ``-Xptxas
-v``; the register and spill lines of normal_weighted_faces,
normal_weighted_faces_every and closest_faces are printed).  Every face
must equal every other of the same tail, across variants, processes and
sides.  Prints one line per process and, last, one JSON object with every
reading, per variant the median of each side's medians and the fastest
round, and the card's name and power limit; exits non-zero without a card
or when two answers differ.
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
from mesh_tpu_torch.mesh import Mesh
from mesh_tpu_torch.query import normal_weighted as nw

inputs = torch.load(sys.argv[1])
reps, rounds, out_path = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
splits = [int(s) for s in sys.argv[5].split(",")]
report = _build.build(verbose=True)
ptxas = {name: [line.strip() for line in report.get(name, {}).get(
    "ptxas", "").splitlines() if "registers" in line or "spill" in line]
    for name in ("normal_weighted_faces", "normal_weighted_faces_every",
                 "closest_faces")}
dev = torch.device("cuda")
v, f = inputs["verts0"].to(dev), inputs["faces"].to(dev)
pts, nrm = inputs["pts"].to(dev), inputs["nrm"].to(dev)
eps, drive_tail = inputs["eps"], not inputs["nondegen"]
ops = nw.normal_weighted_operands(v[None], f, pts[None], nrm[None])
p, n, planes = ops[0], ops[1], ops[2]
culls = hasattr(nw, "normal_weighted_cull_operands")
variants, answers = [], {}
for tail in (False, True):
    key = "[tail=%s]" % tail
    if culls:
        cull = nw.normal_weighted_cull_operands(p, planes, tail)
        kernel = (lambda tail=tail, cull=cull: nw.argmin_normal_weighted(
            p, n, planes, eps, tail, cull=cull))
        every = (lambda tail=tail: nw.argmin_normal_weighted_every(
            p, n, planes, eps, tail))
        variants += [
            ("with_prologue" + key, lambda tail=tail:
             nw.argmin_normal_weighted(p, n, planes, eps, tail)),
            ("prologue" + key, lambda tail=tail:
             nw.normal_weighted_cull_operands(p, planes, tail))]
        if tail == drive_tail:
            variants += [("split%d" % s, lambda s=s, tail=tail, cull=cull:
                          nw.argmin_normal_weighted(p, n, planes, eps, tail,
                                                    cull=cull, split=s))
                         for s in splits]
    else:
        kernel = every = (lambda tail=tail: nw.argmin_normal_weighted(
            p, n, planes, eps, tail))
    variants += [("kernel" + key, kernel), ("every" + key, every)]
    answers["kernel" + key] = kernel().cpu()
    answers["every" + key] = every().cpu()
    if culls and tail == drive_tail:
        for s in splits:
            answers["split%d%s" % (s, key)] = nw.argmin_normal_weighted(
                p, n, planes, eps, tail, split=s).cpu()
mesh = Mesh(inputs["verts0"].numpy(), inputs["faces"].numpy(), device=dev)
tree = mesh.compute_aabb_normals_tree()
pts_np, nrm_np = inputs["pts"].numpy(), inputs["nrm"].numpy()
variants.append(("nearest", lambda: tree.nearest(pts_np, nrm_np)))
answers["nearest"] = torch.as_tensor(
    tree.nearest(pts_np, nrm_np)[0].astype("int64"))
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
    """chip_smoke.py phase 8's inputs, made on the card and kept on the
    CPU: posed body 0, the faces, the scan points and normals, eps, and
    whether body 0 passes the nondegeneracy check (which picks the
    degenerate tail)."""
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
    verts, _ = lbs(model, betas[:1], pose[:1], device=dev)
    pts, nrm = cs.registration_inputs(verts[0], model.faces,
                                      np.random.RandomState(1))
    return {"verts0": verts[0].cpu(), "faces": model.faces.cpu(),
            "pts": pts.cpu(), "nrm": nrm.cpu(), "eps": cs.REG_EPS,
            "nondegen": ck.mesh_is_nondegenerate(
                verts[0].cpu().numpy(), model.faces.cpu().numpy())}


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi failed: %s" % exc


def check_answers(paths):
    """The answers that differ from the first process's or, within one
    process, from its kernel's faces of the same tail (empty when all
    agree)."""
    import torch

    runs = [torch.load(p) for p in paths]
    bad = {key for run in runs for key, got in run.items()
           if key in runs[0] and not torch.equal(got, runs[0][key])}
    for run in runs:
        for key, got in run.items():
            if key != "nearest" and not torch.equal(
                    got, run["kernel" + key[key.index("["):]]):
                bad.add(key)
    return sorted(bad)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root directory")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--splits", default="1,4,16,32,64")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_nw: no CUDA card")
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "mesh_tpu_torch", "query",
                                       "normal_weighted.py")):
        sys.exit("ab_nw: %s holds no mesh_tpu_torch" % other)
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
                 str(args.rounds), out, args.splits], cwd=root,
                capture_output=True, text=True, timeout=900)
            if res.returncode:
                sys.stderr.write(res.stderr)
                sys.exit("ab_nw: the %s side failed" % side)
            reading = json.loads(res.stdout.strip().splitlines()[-1])
            runs.append({"side": side, "readings": reading})
            outs.append(out)
            print("%s (%s): %s" % (side, root, ", ".join(
                "%s %.4f" % kv for kv in reading["ms"].items())), flush=True)
            for name, lines in reading["ptxas"].items():
                for line in lines:
                    print("  %s ptxas %s: %s" % (side, name, line),
                          flush=True)
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
        sys.exit("ab_nw: answers differ: %s" % ", ".join(bad))


if __name__ == "__main__":
    main()
