#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's rope walk kernels alone (both entries of
``rope_faces`` and of ``rope_mxu_faces``, the latter f32 and bf16), of the
accel traversal around the resident ``rope_faces`` entry on avatar frames,
and of the scan's ``Mesh`` call, in two checkouts, on one CUDA card, in
one run, with a SASS comparison of the resident fast-tile walk.

    python3 tools/ab_rope.py --other DIR [--pairs 2] [--rounds 5] [--reps 10]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``).  The operands are made once, here, on
the card, with chip_smoke.py's seeds and shapes: the scan's
(``rope_operands`` on phase 6's 209,304-face sphere and 65,536 queries,
tile_q 128, tile_f 256: 512 query tiles; with the streamed entry's face
records, and the MXU walk's records), the same sphere with 139,264
queries made by the scan's recipe from another seed (``scan_1088``: 1,088
tiles, a grid of more than 8 blocks an SM), and phase 11's two anim
frames (``chip_smoke.anim_frame``: the SMPL-sized model and the
98,304-face one, 4096 queries each; ``chip_smoke.anim_rope_operands``
over the frame's refit index).  Each side then runs in a process of its
own, from its own checkout, ``--pairs`` times, the pairs alternating
which side runs first (other, this, this, other, ...).  A process times,
on every operand set, the resident ``rope_faces`` entry at each sub-lane
count its ``rope_argmin`` takes (``rk.LANES`` and its own pick; a
checkout without sub-lanes has its one resident launch); on the two scans
the streamed ``rope_faces`` entry and the streamed ``rope_mxu_faces``
entry, f32 and bf16, each at each sub-lane count and at the pick with a
ring of 2 (a checkout without streamed sub-lanes has its one streamed
launch) and at the pick with a ring of 4, and the resident
``rope_mxu_faces`` entry, f32 and bf16, at each sub-lane count and at the
pick (a checkout whose resident MXU entry refuses sub-lanes has its one
launch, the pick); on each anim frame the whole
traversal (``closest_faces_and_points_accel`` over the refit index, which
the process builds from the frame's rest keyframe and posed vertices with
its own ``get_index`` and ``refit_bvh``; ``traversal_launches`` counts
the resident kernel's launches a call); and on the scan the ``Mesh``
call (``Mesh.closest_faces_and_points``, the BVH rung's streamed walk;
``facade`` times it on the host clock up to ``torch.cuda.synchronize``,
after a first call that builds the index): CUDA events around ``--reps``
back-to-back calls, in ``--rounds`` rounds that interleave the variants
(on the scans the streamed entries first), the median over the rounds.
The first process of a side builds its kernels (with ``-Xptxas -v``; the
rope kernels' register and spill lines are printed; this checkout's are
built first, here).  Every answer must equal the first process's answer
of the same variant; on the same operands every resident answer
(distances, sorted face positions, leaves per query tile) must equal the
one at the pick, every streamed ``rope_faces`` answer at a ring of 2 the
one at the pick, with the resident distances and faces and at least as
many leaves (at a ring of 4 the same distances and faces), every
streamed MXU answer (distances, faces, leaves, full visits) the f32 one at
the pick of its ring, bf16 with the same distances, faces and leaves, and
every resident MXU answer the pick's of its mode, with the f32 pick's
distances, faces and leaves, the streamed walk's distances and faces and
at most its leaves.  Last, ``cuobjdump -sass`` of each side's
``rope_faces`` library: the SASS of ``rope_lanes_kernel<FastLanes, S>``
(the resident fast-tile walk) at each S, with its encodings, this side's
against the other's (``sass``: per S whether the two are identical).
Prints one line per process and, last, one JSON object with every
reading, per variant the median of each side's medians and the fastest
round, the SASS comparison, and the card's name and power limit; exits
non-zero without a card or when two answers differ.
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the operand keys the rope walk wrappers read
OP_KEYS = ("pts_s", "seed", "boxes", "topo", "rows", "recs", "tile_q",
           "tile_f")
MXU_KEYS = ("pts_s", "seed", "boxes", "topo", "rec", "p2", "tile_q",
            "tile_f")

#: queries of the scan_1088 set: 1,088 query tiles of 128
BIG_SCAN_QUERIES = 1088 * 128

#: the ring depths timed at the pick: the default and a deeper one
RINGS = (2, 4)

#: where the CUDA toolkit puts cuobjdump when it is not on PATH
TOOLKIT_CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"

#: the mangled name of rope_lanes_kernel<mt::FastLanes, S>, S captured
FAST_LANES_KERNEL = re.compile(r"rope_lanes_kernelI\w*?9FastLanesELi(\d+)E")

#: what each side's process runs, from its own checkout
SIDE = r"""
import json, statistics, sys, time
import torch
sys.path.insert(0, ".")
from mesh_tpu_torch import Mesh, _build
from mesh_tpu_torch.accel import rope_kernel as rk
from mesh_tpu_torch.accel.build import get_index
from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
from mesh_tpu_torch.anim import refit as anim_refit

sets, mxu_sets, frames, scan = torch.load(sys.argv[1])
reps, rounds, out_path = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
rings = [int(x) for x in sys.argv[5].split(",")]
report = _build.build(verbose=True)
ptxas = [line.strip() for name in ("rope_faces", "rope_mxu_faces")
         for line in report.get(name, {}).get("ptxas", "").splitlines()
         if "Compiling entry" in line or "registers" in line
         or "spill" in line]
lanes = list(rk.LANES) if hasattr(rk, "LANES") else []
pick = getattr(rk, "picked_lanes", getattr(rk, "resident_lanes", None))
# streamed sub-lanes: both streamed wrappers take lanes
stream_lanes = lanes if hasattr(rk, "picked_lanes") else []
libs = {name: _build._library_path(name)
        for name in ("rope_faces", "rope_mxu_faces")}
dev = torch.device("cuda")
variants, picked = [], {}
for name, ops in sets.items():
    ops = {k: v.cuda() if torch.is_tensor(v) else v for k, v in ops.items()}
    if name in mxu_sets:
        mops = {k: v.cuda() if torch.is_tensor(v) else v
                for k, v in mxu_sets[name].items()}
        # the streamed entries first in each round on both sides
        for s in stream_lanes:
            variants.append((name, "stream_s%d" % s, lambda ops=ops, s=s:
                             rk.rope_argmin(ops, rings[0], lanes=s)))
        for n_b in rings:
            variants.append((name, "stream_ring%d" % n_b,
                             lambda ops=ops, n_b=n_b: rk.rope_argmin(ops,
                                                                     n_b)))
        for mode, b in (("f32", False), ("bf16", True)):
            for s in stream_lanes:
                variants.append((name, "mxu_%s_s%d" % (mode, s),
                                 lambda mops=mops, s=s, b=b:
                                 rk.rope_mxu_argmin(mops, rings[0], b,
                                                    lanes=s)))
            for n_b in rings:
                variants.append((name, "mxu_%s_ring%d" % (mode, n_b),
                                 lambda mops=mops, n_b=n_b, b=b:
                                 rk.rope_mxu_argmin(mops, n_b, b)))
        # resident MXU sub-lanes, where the resident entry takes them
        try:
            rk._check_rope(mops, None, 2, mxu=True)
            resident_mxu_lanes = stream_lanes
        except ValueError:
            resident_mxu_lanes = []
        for mode, b in (("f32", False), ("bf16", True)):
            for s in resident_mxu_lanes:
                variants.append((name, "mxu_%s_resident_s%d" % (mode, s),
                                 lambda mops=mops, s=s, b=b:
                                 rk.rope_mxu_argmin(mops, None, b,
                                                    lanes=s)))
            variants.append((name, "mxu_%s_resident" % mode,
                             lambda mops=mops, b=b:
                             rk.rope_mxu_argmin(mops, None, b)))
    for s in lanes:
        variants.append((name, "resident_s%d" % s,
                         lambda ops=ops, s=s: rk.rope_argmin(ops, None,
                                                             lanes=s)))
    variants.append((name, "resident",
                     lambda ops=ops: rk.rope_argmin(ops, None)))
    if pick is not None:
        picked[name] = pick(ops["tile_q"], ops["tile_f"])
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
mesh = Mesh(scan["v"].numpy(), scan["f"].numpy(), device=dev)
scan_p = scan["p"].numpy()


def facade():
    faces, points = mesh.closest_faces_and_points(scan_p)
    return [torch.as_tensor(faces.astype("int64")), torch.as_tensor(points)]


answers = {n + "/" + k: [t.cpu() for t in fn()] for n, k, fn in variants}
answers["scan/facade"] = facade()       # the first call builds the index
times = {n + "/" + k: [] for n, k, _ in variants}
times["scan/facade"] = []
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
    # the Mesh call ends on the host (numpy answers): host clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        facade()
    torch.cuda.synchronize()
    times["scan/facade"].append((time.perf_counter() - t0) * 1e3 / reps)
torch.save(answers, out_path)
print(json.dumps({"ms": {k: statistics.median(v) for k, v in times.items()},
                  "rounds_ms": times, "lanes_picked": picked,
                  "traversal_launches": launches,
                  "ptxas": ptxas, "libs": libs}))
"""


def operand_sets():
    """({name: rope_faces operand dict on the CPU, OP_KEYS only}, {scan
    name: the MXU walk's operand dict, MXU_KEYS only}, {anim name: the
    frame's rest keyframe, posed vertices, queries, faces and leaf size on
    the CPU}, the scan's mesh and queries): the two scans' and the two anim
    frames' rope operands, made on the card from chip_smoke.py's seeds, and
    the frames the traversal runs on."""
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
    scans = {"scan": p_s, "scan_1088": p_big.astype(np.float32)}
    sets = {name: rk.rope_operands(v_s, f_s, p, device=dev, records=True)
            for name, p in scans.items()}
    mxu_sets = {name: rk.rope_operands(v_s, f_s, p, device=dev, mxu=True)
                for name, p in scans.items()}
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

    def host(d, keys):
        return {k: d[k].cpu() if torch.is_tensor(d[k]) else d[k]
                for k in keys if k in d}

    return ({name: host(ops, OP_KEYS) for name, ops in sets.items()},
            {name: host(ops, MXU_KEYS) for name, ops in mxu_sets.items()},
            frames, {"v": torch.as_tensor(v_s), "f": torch.as_tensor(f_s),
                     "p": torch.as_tensor(p_s)})


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi failed: %s" % exc


def check_answers(paths):
    """The variants whose answers differ (empty when all agree): every
    answer must equal the first process's of the same variant (the first
    that has it), and on the same operands among those: every resident
    ``rope_faces`` answer the one at the pick; every streamed
    ``rope_faces`` answer at a ring of 2 the one at the pick, with the
    resident distances and faces and at least as many leaves, at a ring of
    4 the same distances and faces with at least as many leaves; every
    streamed MXU answer the f32 one at the pick of its ring, bf16 with the
    same distances, faces and leaves, and at a ring of 4 the same distances
    and faces as at a ring of 2; every resident MXU answer the pick's of
    its mode, with the f32 pick's distances, faces and leaves, and the
    streamed f32 answer's distances and faces with at most its leaves."""
    import torch

    def same(a, b, n=None):
        return all(torch.equal(x, y) for x, y in list(zip(a, b))[:n])

    runs = [torch.load(p) for p in paths]
    first = {}          # each variant's answer in the first process with it
    for run in runs:
        for key, got in run.items():
            first.setdefault(key, got)
    bad = {key for run in runs for key, got in run.items()
           if not same(got, first[key])}
    for key, got in first.items():
        name, variant = key.split("/")
        res = first.get(name + "/resident")
        if variant.startswith("resident"):
            ok = same(got, res)
        elif variant.startswith("stream"):
            ring = (first[name + "/stream_ring2"]
                    if variant != "stream_ring4" else got)
            ok = (same(got, ring) and same(got, res, 2)
                  and bool((got[2] >= res[2]).all()))
        elif variant.startswith("mxu") and "resident" in variant:
            mode = variant.split("_")[1]
            stream = first[name + "/mxu_f32_ring2"]
            ok = (same(got, first["%s/mxu_%s_resident" % (name, mode)])
                  and same(got, first[name + "/mxu_f32_resident"], 3)
                  and same(got, stream, 2)
                  and bool((got[2] <= stream[2]).all()))
        elif variant.startswith("mxu"):
            mode = variant.split("_")[1]
            ring = variant.split("_")[-1] if "ring" in variant else "ring2"
            want = first["%s/mxu_%s_%s" % (name, mode, ring)]
            f32 = first["%s/mxu_f32_%s" % (name, ring)]
            base = first[name + "/mxu_f32_ring2"]
            ok = (same(got, want) and same(got, f32, 2)
                  and same(got, base, 2) and torch.equal(got[2], f32[2]))
        else:
            continue
        if not ok:
            bad.add(key)
    return sorted(bad)


def sass_functions(lib):
    """{mangled name: SASS lines with their encodings, addresses dropped}
    of every function in the shared library ``lib`` (``cuobjdump
    -sass``)."""
    tool = shutil.which("cuobjdump") or TOOLKIT_CUOBJDUMP
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, body = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            body = funcs.setdefault(head.group(1), [])
        elif body is not None and line.strip().startswith("....."):
            body = None                      # the end of a function
        elif body is not None and line.strip():
            body.append(" ".join(
                re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split()))
    return funcs


def compare_sass(this_lib, other_lib):
    """Per S, whether ``rope_lanes_kernel<FastLanes, S>`` has the same SASS
    (instructions and encodings) in both ``rope_faces`` libraries, with its
    instruction count on each side; an "error" entry if cuobjdump fails."""
    try:
        sides = [sass_functions(lib) for lib in (this_lib, other_lib)]
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": str(exc)}
    by_lanes = []
    for funcs in sides:
        found = {}
        for name, body in funcs.items():
            m = FAST_LANES_KERNEL.search(name)
            if m:
                found[int(m.group(1))] = body
        by_lanes.append(found)
    this, other = by_lanes
    out = {}
    for s in sorted(set(this) | set(other)):
        a, b = this.get(s), other.get(s)
        out[s] = {"identical": a is not None and a == b,
                  "this_lines": len(a or []), "other_lines": len(b or [])}
    return out


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
    for name in ("rope_faces", "rope_mxu_faces"):
        for line in report.get(name, {}).get("ptxas", "").splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
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
                 str(args.rounds), out, ",".join(map(str, RINGS))],
                cwd=root, capture_output=True, text=True, timeout=900)
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
    libs = {run["side"]: run["readings"]["libs"]["rope_faces"]
            for run in runs}
    sass = compare_sass(libs["this"], libs["other"])
    print("rope_lanes_kernel<FastLanes, S> SASS, this against other: %s"
          % json.dumps(sass), flush=True)
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
                      "sass": sass,
                      "runs": runs}))
    if bad:
        sys.exit("ab_rope: answers differ: %s" % ", ".join(bad))


if __name__ == "__main__":
    main()
