#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's any-hit kernels alone and of the whole
visibility step, in two checkouts, on one CUDA card, in one run.

    python3 tools/ab_ray.py --other DIR [--pairs 2] [--rounds 5] [--reps 10]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``).  The inputs are made once, here, on the
card, with chip_smoke.py's seeds and shapes: phase 7's 64 posed bodies
(the main path's first bodies, posed by ``lbs`` in one batch of 256) from
its four cameras (``phase7``), the rest template from the same cameras
(``rest``), and body 0 from camera 0 (``facade``, the shape of one
``Mesh.vertex_visibility`` call).  Each side then runs in a process of its
own, from its own checkout, ``--pairs`` times, the pairs alternating which
side runs first (other, this, this, other, ...).  A process times, on each
set, the every-face ``ray_any_hit`` kernel alone on the rays in vertex order
(``dense``), the ``ray_any_hit_culled`` kernel alone on the rays in each
mesh's vertex Morton order with its operands made beforehand (``culled``,
where the checkout has it), and ``visibility_step`` (vertex normals, rays,
the prologue, the kernel and the flags back in vertex order), and on
``phase7`` also chip_smoke's step, ``lbs`` then ``visibility_step``:
CUDA events around ``--reps`` back-to-back calls, in ``--rounds`` rounds
that interleave the variants, the median over the rounds.  The first
process of a side builds its kernels (with ``-Xptxas -v``; the ray kernels'
register and spill lines are printed).  Every blocked flag must equal
every other on the same set, across variants, processes and sides, and the
visibility and n.dir of every ``visibility_step`` the first process's (that
call takes vertex normals made on the CPU, since the card's ``index_add_``
sums them in a run-dependent order).  The
culled side also reports its cull statistics (the shares of warp-chunks
issued and of pairs its lanes evaluated, and the face positions that
blocked each ray, which must be the every-face kernel's first hits on the
sorted faces) and the CUDA kernels its prologue launches
(``torch.profiler``; null where the profiler sees none).  Prints one line
per process and, last, one JSON object with every reading, per variant the
median of each side's medians and the fastest round, and the card's name
and power limit; exits non-zero without a card or when two answers
differ.
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
from mesh_tpu_torch.batch import visibility_step
from mesh_tpu_torch.models import lbs, synthetic_body_model
from mesh_tpu_torch.query import ray_kernel as rk
from mesh_tpu_torch.query import visibility as vis

inputs = torch.load(sys.argv[1])
reps, rounds, out_path = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
report = _build.build(verbose=True)
ptxas = ["%s: %s" % (name, line.strip())
         for name in ("ray_any_hit", "ray_any_hit_culled")
         for line in report.get(name, {}).get("ptxas", "").splitlines()
         if "registers" in line or "spill" in line]
dev = torch.device("cuda")
culled = hasattr(rk, "ray_any_hit_culled")
model = synthetic_body_model(seed=0, device=dev)
cams = inputs["cams"].to(dev)
f = model.faces
variants, answers, stats, prologue = [], {}, {}, {}
for name, (verts, n_cams, normals) in inputs["sets"].items():
    verts, cam, normals = verts.to(dev), cams[:n_cams], normals.to(dev)
    origins, dirs = vis.visibility_rays(verts, cam, inputs["min_dist"])
    dirs = dirs.reshape(origins.shape).contiguous()
    tri = verts[..., f.long(), :]
    planes = rk.ray_planes(tri)
    variants.append((name, "dense", lambda o=origins, d=dirs, p=planes:
                     rk.ray_any_hit(o, d, p, t_lo=0.0)))
    answers[name + "/dense"] = rk.ray_any_hit(origins, dirs, planes,
                                              t_lo=0.0)[0].cpu()
    if culled:
        order = vis.vertex_order(verts)
        ops = rk.any_hit_operands(*vis.sort_rays(origins, dirs, order),
                                  tri)
        variants.append((name, "culled", lambda ops=ops:
                         rk.ray_any_hit_culled(ops, t_lo=0.0)))
        blocked, pairs, warp, first = rk.ray_any_hit_culled(
            ops, t_lo=0.0, with_stats=True)
        answers[name + "/culled"] = vis.unsort_flags(
            blocked, order, n_cams).reshape(blocked.shape).cpu()
        # the every-face kernel's first hits on the sorted faces
        tri_s = torch.gather(tri, 1, ops["face_ids"].long()[..., None, None]
                             .expand(tri.shape))
        sb, st = rk.ray_any_hit(ops["origins"], ops["dirs"],
                                rk.ray_planes(tri_s), t_lo=0.0)
        n_rays, n_faces = blocked.numel(), ops["n_faces"]
        stats[name] = {
            "first_hits_equal": bool(torch.equal(
                first, torch.where(sb, st - 1, torch.full_like(st, -1)))),
            "blocked_share": float(blocked.float().mean()),
            "pairs": int(pairs.sum()), "pairs_all": n_rays * n_faces,
            "pairs_dense": int(st.sum()),
            "warp_chunks": int(warp.sum()),
            "warp_chunks_all": warp.numel() * ops["chunks"].shape[1]}
        def prologue_call(verts=verts, origins=origins, dirs=dirs, tri=tri):
            order = vis.vertex_order(verts)
            return rk.any_hit_operands(*vis.sort_rays(origins, dirs, order),
                                       tri)
        prologue_call()
        torch.cuda.synchronize()
        try:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                prologue_call()
                torch.cuda.synchronize()
            prologue[name] = sum(
                e.count for e in prof.key_averages()
                if getattr(e, "device_type", None) is not None
                and "CUDA" in str(e.device_type)) or None
        except Exception as exc:  # the count is a report, not a check
            prologue[name] = "profiler failed: %s" % exc
    variants.append((name, "visibility_step", lambda v=verts, c=cam:
                     visibility_step(v, f, c, min_dist=inputs["min_dist"])))
    v_out, ndc = visibility_step(verts, f, cam, normals=normals,
                                 min_dist=inputs["min_dist"])
    answers[name + "/visibility_step"] = (~v_out).reshape(
        answers[name + "/dense"].shape).cpu()
    answers[name + "/ndc"] = ndc.cpu()
betas, pose = inputs["betas"].to(dev), inputs["pose"].to(dev)
def step():
    v, _ = lbs(model, betas, pose, device=dev)
    return visibility_step(v, f, cams, min_dist=inputs["min_dist"])
variants.append(("phase7", "step", step))
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
                  "rounds_ms": times, "culled": culled, "stats": stats,
                  "prologue_cuda_kernels": prologue, "ptxas": ptxas}))
"""


def inputs():
    """chip_smoke.py phase 7's inputs on the CPU: the three vertex sets with
    their camera counts, the cameras, ray offset, and the betas and pose of
    phase 7's step."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.geometry.vert_normals import vert_normals_t
    from mesh_tpu_torch.models import lbs, synthetic_body_model

    dev = torch.device("cuda")
    model = synthetic_body_model(seed=0, device=dev)
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    verts, _ = lbs(model, betas, pose, device=dev)
    n_c = len(cs.VIS_CAMERAS)
    sets = {"phase7": (verts[:cs.VIS_BATCH], n_c),
            "rest": (model.v_template[None], n_c), "facade": (verts[:1], 1)}
    # n.dir is compared with these normals, made on the CPU: the card's
    # index_add_ sums in a run-dependent order
    faces = model.faces.cpu()
    return {"sets": {k: (v.cpu(), c, vert_normals_t(v.cpu(), faces))
                     for k, (v, c) in sets.items()},
            "cams": torch.tensor(cs.VIS_CAMERAS, dtype=torch.float32),
            "min_dist": cs.VIS_MIN_DIST,
            "betas": betas[:cs.VIS_BATCH].cpu(),
            "pose": pose[:cs.VIS_BATCH].cpu()}


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi failed: %s" % exc


def check_answers(paths):
    """The answers that differ (empty when all agree): on each set every
    blocked flag (dense, culled, the negated visibility_step) must equal the
    first process's dense flags, and every n.dir the first process's."""
    import torch

    runs = [torch.load(p) for p in paths]
    bad = set()
    for run in runs:
        for key, got in run.items():
            name, variant = key.split("/")
            ref = runs[0][key if variant == "ndc" else name + "/dense"]
            if not torch.equal(got, ref):
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
        sys.exit("ab_ray: no CUDA card")
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "mesh_tpu_torch", "query",
                                       "ray_kernel.py")):
        sys.exit("ab_ray: %s holds no mesh_tpu_torch" % other)
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
                sys.exit("ab_ray: the %s side failed" % side)
            reading = json.loads(res.stdout.strip().splitlines()[-1])
            runs.append({"side": side, "readings": reading})
            outs.append(out)
            print("%s (%s): %s" % (side, root, ", ".join(
                "%s %.4f" % kv for kv in reading["ms"].items())), flush=True)
            for line in reading["ptxas"]:
                print("  %s ptxas: %s" % (side, line), flush=True)
            for name, st in reading["stats"].items():
                print("  %s %s: warp-chunks %d of %d (%.4f), pairs %d of %d "
                      "(%.4f; every-face kernel %d), first hits equal %s"
                      % (side, name, st["warp_chunks"], st["warp_chunks_all"],
                         st["warp_chunks"] / st["warp_chunks_all"],
                         st["pairs"], st["pairs_all"],
                         st["pairs"] / st["pairs_all"], st["pairs_dense"],
                         st["first_hits_equal"]), flush=True)
        bad = check_answers(outs)
    bad += sorted("%s/%s/first_hits" % (run["side"], name)
                  for run in runs
                  for name, st in run["readings"]["stats"].items()
                  if not st["first_hits_equal"])
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
        sys.exit("ab_ray: answers differ: %s" % ", ".join(bad))


if __name__ == "__main__":
    main()
