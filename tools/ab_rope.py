#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's resident rope walk kernel alone
(``rope_faces``, resident entry), and of the accel traversal around it on
avatar frames, in two checkouts, on one CUDA card, in one run.

    python3 tools/ab_rope.py --other DIR [--pairs 2] [--rounds 5] [--reps 10]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``).  The operands are made once, here, on
the card, with chip_smoke.py's seeds and shapes: the scan's
(``rope_operands`` on phase 6's 209,304-face sphere and 65,536 queries,
tile_q 128, tile_f 256: 512 query tiles), the same sphere with 139,264
queries made by the scan's recipe from another seed (``scan_1088``: 1,088
tiles, a grid of more than 8 blocks an SM), and phase 11's two anim
frames (``chip_smoke.anim_frame``: the SMPL-sized model and the
98,304-face one, 4096 queries each; ``chip_smoke.anim_rope_operands``
over the frame's refit index).  Each side then runs in a process of its
own, from its own checkout, ``--pairs`` times, the pairs alternating
which side runs first (other, this, this, other, ...).  A process times,
on every operand set, the resident entry at each sub-lane count its
``rope_argmin`` takes (``rk.LANES`` and its own pick; a checkout without
sub-lanes has its one resident launch), on the scan, first in each round,
the streamed entry (ring of 2), and on each anim frame the whole
traversal (``closest_faces_and_points_accel`` over the refit index, which
the process builds from the frame's rest keyframe and posed vertices with
its own ``get_index`` and ``refit_bvh``; ``traversal_launches`` counts
the resident kernel's launches a call): CUDA events around ``--reps``
back-to-back calls, in ``--rounds`` rounds that interleave the variants,
the median over the rounds.  The first process of a side builds its
kernels (with ``-Xptxas -v``; the rope kernels' register and spill lines
are printed; this checkout's are built first, here).  Every resident
answer (distances, sorted face positions, leaves per query tile) must
equal every other on the same operands, on both sides and at every
sub-lane count, the streamed entry's distances and faces must equal them,
and each traversal's faces, points and distances must equal the first
process's.  Prints one line per process and, last, one JSON object with
every reading, per variant the median of each side's medians and the
fastest round, and the card's name and power limit; exits non-zero
without a card or when two answers differ.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the operand keys the rope_faces wrappers read
OP_KEYS = ("pts_s", "seed", "boxes", "topo", "rows", "tile_q", "tile_f")

#: queries of the scan_1088 set: 1,088 query tiles of 128
BIG_SCAN_QUERIES = 1088 * 128

#: what each side's process runs, from its own checkout
SIDE = r"""
import json, statistics, sys
import torch
sys.path.insert(0, ".")
from mesh_tpu_torch import _build
from mesh_tpu_torch.accel import rope_kernel as rk
from mesh_tpu_torch.accel.build import get_index
from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
from mesh_tpu_torch.anim import refit as anim_refit

sets, frames = torch.load(sys.argv[1])
reps, rounds, out_path = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
report = _build.build(verbose=True)
ptxas = [line.strip() for line in
         report.get("rope_faces", {}).get("ptxas", "").splitlines()
         if "Compiling entry" in line or "registers" in line
         or "spill" in line]
lanes = list(rk.LANES) if hasattr(rk, "LANES") else []
variants, picked = [], {}
for name, ops in sets.items():
    ops = {k: v.cuda() if torch.is_tensor(v) else v for k, v in ops.items()}
    if name == "scan":
        # first in each round on both sides, after the same kind of call
        variants.append((name, "stream",
                         lambda ops=ops: rk.rope_argmin(ops, 2)))
    for s in lanes:
        variants.append((name, "resident_s%d" % s,
                         lambda ops=ops, s=s: rk.rope_argmin(ops, None,
                                                             lanes=s)))
    variants.append((name, "resident",
                     lambda ops=ops: rk.rope_argmin(ops, None)))
    if lanes:
        picked[name] = rk.resident_lanes(ops["tile_q"], ops["tile_f"])
dev = torch.device("cuda")
launches = {}
for name, fr in frames.items():
    v, q = fr["v"].to(dev), fr["q"].to(dev)
    f_dev = fr["faces"].to(dev).long()
    base = get_index(fr["rest"].numpy(), fr["faces"].numpy(), kind="bvh",
                     leaf_size=fr["leaf"])
    refit, _ = anim_refit.refit_bvh(base, v, f_dev, device=dev)

    def traversal(v=v, f_dev=f_dev, q=q, refit=refit):
        out = closest_faces_and_points_accel(v, f_dev, q, index=refit,
                                             device=dev)
        return [torch.as_tensor(out[k]) for k in ("face", "point", "sqdist")]

    before = rk.LAUNCHES["rope_faces_resident"]
    traversal()
    launches[name] = rk.LAUNCHES["rope_faces_resident"] - before
    variants.append((name, "traversal", traversal))
answers = {n + "/" + k: [t.cpu() for t in fn()] for n, k, fn in variants}
times = {n + "/" + k: [] for n, k, _ in variants}
for _ in range(rounds):
    for name, key, fn in variants:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times[name + "/" + key].append(start.elapsed_time(end) / reps)
torch.save(answers, out_path)
print(json.dumps({"ms": {k: statistics.median(v) for k, v in times.items()},
                  "rounds_ms": times, "lanes_picked": picked,
                  "traversal_launches": launches,
                  "ptxas": ptxas}))
"""


def operand_sets():
    """({name: operand dict on the CPU, OP_KEYS only}, {anim name: the
    frame's rest keyframe, posed vertices, queries, faces and leaf size on
    the CPU}): the two scans' and the two anim frames' rope operands, made
    on the card from chip_smoke.py's seeds, and the frames the traversal
    runs on."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.accel import rope_kernel as rk
    from mesh_tpu_torch.accel.traverse import RESIDENT_TILE_F
    from mesh_tpu_torch.anim import refit as anim_refit
    from mesh_tpu_torch.models import synthetic_body_model

    dev = torch.device("cuda")
    v_s, f_s, p_s = cs.scan_inputs()
    rng = np.random.RandomState(1)
    p_big = rng.randn(BIG_SCAN_QUERIES, 3)
    p_big /= np.linalg.norm(p_big, axis=1, keepdims=True)
    p_big *= 1.0 + 0.05 * rng.randn(BIG_SCAN_QUERIES, 1)
    sets = {"scan": rk.rope_operands(v_s, f_s, p_s, device=dev),
            "scan_1088": rk.rope_operands(v_s, f_s, p_big.astype(np.float32),
                                          device=dev)}
    frames = {}
    models = {"anim_smpl": (synthetic_body_model(seed=0, device=dev), 11),
              "anim_large": (cs.large_batch_inputs(dev)[0], 12)}
    for name, (model, seed) in models.items():
        _, v, q, rest, base, _, _, _ = cs.anim_frame(model, RESIDENT_TILE_F,
                                                     seed, dev)
        f_dev = model.faces.long()
        refit, _ = anim_refit.refit_bvh(base, v, f_dev, device=dev)
        sets[name] = cs.anim_rope_operands(v, f_dev, q, refit, dev)
        frames[name] = {"rest": torch.as_tensor(rest), "v": v.cpu(),
                        "q": q.cpu(), "faces": model.faces.cpu(),
                        "leaf": RESIDENT_TILE_F}
    return ({name: {k: ops[k].cpu() if torch.is_tensor(ops[k]) else ops[k]
                    for k in OP_KEYS} for name, ops in sets.items()}, frames)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi failed: %s" % exc


def check_answers(paths):
    """The variants whose answers differ on the same operands (empty when
    all agree): every resident answer must equal the first process's
    resident one, every streamed one the first process's streamed one, and
    the streamed distances and faces the resident ones, with at least as
    many leaves; every traversal answer must equal the first process's."""
    import torch

    runs = [torch.load(p) for p in paths]
    bad = set()
    for run in runs:
        for key, got in run.items():
            name, variant = key.split("/")
            if variant == "traversal":
                if not all(torch.equal(a, b)
                           for a, b in zip(got, runs[0][key])):
                    bad.add(key)
                continue
            res = runs[0][name + "/resident"]
            ref = runs[0][key] if variant == "stream" else res
            if not (all(torch.equal(a, b) for a, b in zip(got, ref))
                    and torch.equal(got[0], res[0])
                    and torch.equal(got[1], res[1])
                    and bool((got[2] >= res[2]).all())):
                bad.add(key)
    return sorted(bad)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root directory")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_rope: no CUDA card")
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "mesh_tpu_torch", "accel",
                                       "rope_kernel.py")):
        sys.exit("ab_rope: %s holds no mesh_tpu_torch" % other)
    sys.path.insert(0, HERE)
    from mesh_tpu_torch import _build

    # this checkout's kernels, built here (the operands need the leaf-box
    # kernel) with the register report
    report = _build.build(verbose=True)
    for line in report.get("rope_faces", {}).get("ptxas", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  this ptxas: %s" % line.strip(), flush=True)
    runs, outs = [], []
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        path = os.path.join(tmp, "operands.pt")
        torch.save(operand_sets(), path)
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
                sys.exit("ab_rope: the %s side failed" % side)
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
        summary[side] = {k: statistics.median(r["ms"][k] for r in mine)
                         for k in keys}
        fastest[side] = {k: min(min(r["rounds_ms"][k]) for r in mine)
                         for k in keys}
    print(json.dumps({"card": card(), "reps": args.reps,
                      "rounds": args.rounds, "pairs": args.pairs,
                      "median_ms": summary, "min_round_ms": fastest,
                      "lanes_picked": next(
                          run["readings"]["lanes_picked"] for run in runs
                          if run["side"] == "this"),
                      "answers_agree": not bad, "differ": bad,
                      "runs": runs}))
    if bad:
        sys.exit("ab_rope: answers differ: %s" % ", ".join(bad))


if __name__ == "__main__":
    main()
