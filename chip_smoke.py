#!/usr/bin/env python3
"""Drive mesh_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; none catches its own):

1. probe: torch/CUDA versions, the card's name and power limit, and the
   build of every CUDA kernel from ``mesh_tpu_torch/csrc`` (nvcc, sm_90a);
2. kernels vs plain: each kernel against its plain PyTorch version on the
   same card tensors, at the main path's shapes (256 posed SMPL-sized
   bodies x 1024 queries; closest_faces in all four variants) and on one
   body with 4096 queries (all variants; the degenerate-tail variants also
   on a mesh with planted zero-area and collinear faces).  Built without
   FMA contraction, each kernel must pick exactly the faces (vertices) its
   plain version picks;
3. main path at full width: lbs -> vertex normals -> batched closest point
   for 256 bodies x 1024 queries, median step time over 10 reps, the
   faces checked against the plain version on the same batch;
4. facade: ``mesh_tpu_torch.Mesh`` closest faces/points, nearest vertices,
   vertex normals and the fused call on one body, with the reference's
   dtypes and shapes; the closest faces/points against the plain
   reconstruction-form scan.

Phases 3 and 4 are the two driven paths.  Kernel launch counts are set to
0 just before each and read just after it, and every kernel must have
launched on each path of ``KERNEL_PATHS``.  The last lines are the card's
name and power limit (nvidia-smi), one JSON line describing every kernel
with its launches per path, and ``{"ok": true, "device": ...}``.

Imports neither JAX nor mesh_tpu.  Needs one CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

_REPO = os.path.dirname(os.path.abspath(__file__))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

BATCH = 256
QUERIES_PER_MESH = 1024
FACADE_QUERIES = 4096
REPS = 10

#: H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
#: and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

#: operations per query-face pair of each closest_faces variant, counted in
#: csrc/closest_faces.cu: (tile_variant, degenerate_tail) -> ops
FACE_PAIR_OPS = {("fast", False): 88, ("fast", True): 119,
                 ("safe", False): 147, ("safe", True): 151}
VERTEX_PAIR_OPS = 10

VARIANTS = [("fast", False), ("fast", True), ("safe", False), ("safe", True)]

#: kernel -> the driven paths that must launch it; the first path's count
#: is the kernel's ``launches`` in the kernels line
KERNEL_PATHS = {"closest_faces": ("main_path", "facade"),
                "nearest_vertices": ("facade",)}


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError("check failed: " + what)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
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


def bound_ms(pairs, ops_per_pair, n_bytes):
    """(least milliseconds, "operations" or "bytes") for work of ``pairs``
    pairs at ``ops_per_pair`` moving ``n_bytes`` once."""
    ops = pairs * ops_per_pair / PEAK_FP32_OPS * 1e3
    mem = n_bytes / PEAK_BYTES * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def planted_degenerate(v, f, rng, n=64):
    """``v``/``f`` plus n zero-area faces (two equal corners) and n
    collinear faces (a new vertex at an edge's midpoint), and queries near
    them: (v2, f2, queries)."""
    picks = rng.choice(f.shape[0], n, replace=False)
    i, j = f[picks, 0], f[picks, 1]
    mids = (v[i].astype(np.float64) + v[j]) / 2.0
    new = v.shape[0] + np.arange(n)
    v2 = np.vstack([v, mids]).astype(np.float32)
    f2 = np.vstack([f, np.stack([i, i, j], 1), np.stack([i, j, new], 1)])
    near = mids + rng.randn(n, 3) * 0.01
    far = rng.randn(FACADE_QUERIES - n, 3) * 0.4
    return v2, f2.astype(np.int32), np.vstack([near, far]).astype(np.float32)


def compare_faces(ck, pts, planes, tri, center, variant, tail, timing):
    """Kernel vs plain for closest_faces on one operand set: identical
    faces, and the max abs point/sqdist difference after the epilogue."""
    k = ck.argmin_faces(pts, planes, variant, tail)
    p = ck.argmin_faces_plain(pts, planes, variant, tail)
    mism = int((k != p).sum())
    check(mism == 0, "closest_faces[%s, tail=%s]: %d of %d faces differ "
          "from the plain version" % (variant, tail, mism, k.numel()))
    rk = ck.winner_epilogue(k, tri, pts, center)
    rp = ck.winner_epilogue(p, tri, pts, center)
    err = max(float((rk["point"] - rp["point"]).abs().max()),
              float((rk["sqdist"] - rp["sqdist"]).abs().max()))
    out = {"variant": variant, "degenerate_tail": tail,
           "shape": list(pts.shape[:2]) + [planes.shape[-1]],
           "faces_identical": True, "max_abs_err": err}
    if timing:
        out["ms"] = cuda_ms(lambda: ck.argmin_faces(pts, planes, variant,
                                                    tail), reps=REPS)
        out["plain_ms"] = cuda_ms(lambda: ck.argmin_faces_plain(
            pts, planes, variant, tail), reps=1)
        n_b, n_q = pts.shape[:2]
        pairs = n_b * n_q * planes.shape[-1]
        n_bytes = 4 * (pts.numel() + planes.numel() + n_b * n_q)
        out["bound_ms"], out["bound_by"] = bound_ms(
            pairs, FACE_PAIR_OPS[(variant, tail)], n_bytes)
    log("  closest_faces[%s, tail=%s] %s: faces identical, max abs "
        "point/sqdist diff %.3g%s" % (
            variant, tail, out["shape"], err,
            "" if not timing else ", %.3f ms (plain %.1f ms, bound %.3f ms)"
            % (out["ms"], out["plain_ms"], out["bound_ms"])))
    return out


def compare_vertices(ck, pts, vplanes, timing):
    k = ck.argmin_vertices(pts, vplanes)
    p = ck.argmin_vertices_plain(pts, vplanes)
    mism = int((k != p).sum())
    check(mism == 0, "nearest_vertices: %d of %d indices differ from the "
          "plain version" % (mism, k.numel()))
    vt = vplanes.transpose(-1, -2)
    rows = torch.arange(pts.shape[0], device=pts.device)[:, None]

    def dist(idx):
        d = pts - vt[rows, idx.long()]
        return (d * d).sum(dim=-1).sqrt()

    out = {"shape": list(pts.shape[:2]) + [vplanes.shape[-1]],
           "indices_identical": True,
           "max_abs_err": float((dist(k) - dist(p)).abs().max())}
    if timing:
        out["ms"] = cuda_ms(lambda: ck.argmin_vertices(pts, vplanes),
                            reps=REPS)
        out["plain_ms"] = cuda_ms(
            lambda: ck.argmin_vertices_plain(pts, vplanes), reps=3)
        out["library_ms"] = cuda_ms(
            lambda: torch.cdist(pts, vt).argmin(dim=-1), reps=3)
        lib = torch.cdist(pts, vt).argmin(dim=-1)
        out["library_agree"] = float((lib == k.long()).float().mean())
        n_b, n_q = pts.shape[:2]
        pairs = n_b * n_q * vplanes.shape[-1]
        n_bytes = 4 * (pts.numel() + vplanes.numel() + n_b * n_q)
        out["bound_ms"], out["bound_by"] = bound_ms(pairs, VERTEX_PAIR_OPS,
                                                    n_bytes)
    log("  nearest_vertices %s: indices identical%s" % (
        out["shape"], "" if not timing else
        ", %.3f ms (plain %.2f ms, cdist+argmin %.2f ms, bound %.4f ms)"
        % (out["ms"], out["plain_ms"], out["library_ms"], out["bound_ms"])))
    return out


def check_facade_against_scan(v, f, q, faces, points):
    """The facade's faces [1, Q] and points [Q, 3] for body ``v`` against
    the plain reconstruction-form scan on the same tensors: squared
    distances within 1e-5, and faces equal except at ties, where the scan's
    own distances to the two faces are within 1e-6."""
    from mesh_tpu_torch.query.closest_point import closest_faces_and_points_t
    from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

    oracle = closest_faces_and_points_t(v, f, q)
    sq = ((q.double().cpu().numpy() - points) ** 2).sum(-1)
    gap = float(np.abs(sq - oracle["sqdist"].cpu().numpy()).max())
    check(gap <= 1e-5, "facade sqdist %.3g from the reconstruction-form "
          "scan" % gap)
    mine = torch.as_tensor(faces[0].astype(np.int64), device=v.device)
    theirs = oracle["face"].long()
    differ = mine != theirs
    n_diff, tie = int(differ.sum()), 0.0
    if n_diff:
        center = v.mean(dim=0)
        tri = (v - center)[f.long()]
        qc = (q - center)[differ]

        def sqd(idx):
            t = tri[idx]
            return closest_point_on_triangle(qc, t[:, 0], t[:, 1], t[:, 2])[1]

        tie = float((sqd(mine[differ]) - sqd(theirs[differ])).abs().max())
        check(tie <= 1e-6, "facade: %d faces differ from the scan's and are "
              "%.3g apart, not a tie" % (n_diff, tie))
    log("  facade vs reconstruction-form scan: sqdist within %.3g, %d faces "
        "differ, all at ties (max gap %.3g)" % (gap, n_diff, tie))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1

    from mesh_tpu_torch import Mesh, _build
    from mesh_tpu_torch.batch import batch_step
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query.closest_point import closest_faces_and_points_t

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # -- 1. probe ---------------------------------------------------------
    log("== probe")
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda, "devices", torch.cuda.device_count())
    log("card:", smi)
    t0 = time.perf_counter()
    report = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    for name, info in report.items():
        log("built %s in %.1f s" % (name, info["seconds"]))
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
    log("kernel build: %.1f s (all sources in parallel)" % build_s)

    # -- inputs (bench.py's north-star workload) ----------------------------
    model = synthetic_body_model(seed=0, device=dev)
    f = model.faces
    f_np = f.cpu().numpy()
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    queries = torch.as_tensor(rng.randn(BATCH, QUERIES_PER_MESH, 3) * 0.4,
                              dtype=torch.float32, device=dev)
    verts, _ = lbs(model, betas, pose, device=dev)
    posed = verts.cpu().numpy()
    nondegen = ck.mesh_is_nondegenerate(posed, f_np)
    main_variant = ("fast", not nondegen)
    log("posed batch %s nondegenerate: %s -> main path runs closest_faces"
        "[%s, tail=%s]" % (tuple(verts.shape), nondegen, *main_variant))

    # -- 2. kernels vs plain on the card -------------------------------------
    log("== kernels vs plain")
    face_runs = []
    for variant, tail in VARIANTS:
        pts, planes, tri, center = ck.closest_point_operands(
            verts, f, queries, variant)
        face_runs.append(compare_faces(ck, pts, planes, tri, center,
                                       variant, tail, timing=True))
        del pts, planes, tri, center
    body = verts[:1]
    q1 = torch.as_tensor(rng.randn(1, FACADE_QUERIES, 3) * 0.4,
                         dtype=torch.float32, device=dev)
    for variant, tail in VARIANTS:
        ops = ck.closest_point_operands(body, f, q1, variant)
        compare_faces(ck, *ops, variant, tail, timing=False)
    v2, f2, q2 = planted_degenerate(posed[0], f_np, rng)
    check(not ck.mesh_is_nondegenerate(v2, f2),
          "the planted mesh must fail the nondegeneracy check")
    v2t = torch.as_tensor(v2, device=dev)[None]
    f2t = torch.as_tensor(f2, device=dev)
    q2t = torch.as_tensor(q2, device=dev)[None]
    oracle = closest_faces_and_points_t(v2t[0], f2t, q2t[0])
    for variant in ("fast", "safe"):
        ops = ck.closest_point_operands(v2t, f2t, q2t, variant)
        compare_faces(ck, *ops, variant, True, timing=False)
        res = ck.closest_point_kernel(v2t, f2t, q2t, tile_variant=variant)
        gap = float((res["sqdist"][0] - oracle["sqdist"]).abs().max())
        check(gap <= 1e-5, "planted mesh, %s tile: sqdist %.3g from the "
              "reconstruction-form scan" % (variant, gap))
        log("  planted degenerate mesh (%d faces), %s tile with tail: "
            "sqdist within %.3g of the reconstruction-form scan"
            % (f2.shape[0], variant, gap))

    vmean = verts.mean(dim=-2, keepdim=True)
    vplanes = (verts - vmean).transpose(-1, -2).contiguous()
    vert_batch = compare_vertices(ck, (queries - vmean).contiguous(),
                                  vplanes, timing=True)
    b0mean = verts[:1].mean(dim=-2, keepdim=True)
    vert_facade = compare_vertices(
        ck, (q1 - b0mean).contiguous(),
        (verts[:1] - b0mean).transpose(-1, -2).contiguous(), timing=True)
    del vplanes

    # -- 3. main path at full width ------------------------------------------
    log("== main path: %d bodies x %d queries, %d faces each"
        % (BATCH, QUERIES_PER_MESH, f.shape[0]))
    for key in ck.LAUNCHES:
        ck.LAUNCHES[key] = 0

    def step():
        v, _ = lbs(model, betas, pose, device=dev)
        normals, res = batch_step(v, f, queries,
                                  assume_nondegenerate=nondegen,
                                  tile_variant=main_variant[0])
        checksum = (normals.sum() + res["point"].sum() + res["sqdist"].sum()
                    + res["face"].sum().to(torch.float32))
        return normals, res, checksum

    normals, res, checksum = step()         # warm-up
    float(checksum)
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        normals, res, checksum = step()
        end.record()
        float(checksum)
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    launches = {"main_path": dict(ck.LAUNCHES)}
    check(tuple(res["face"].shape) == (BATCH, QUERIES_PER_MESH)
          and res["face"].dtype == torch.int32, "face shape/dtype")
    check(tuple(res["point"].shape) == (BATCH, QUERIES_PER_MESH, 3),
          "point shape")
    check(tuple(normals.shape) == tuple(verts.shape), "normals shape")
    for name, t in (("normals", normals), ("point", res["point"]),
                    ("sqdist", res["sqdist"])):
        check(bool(torch.isfinite(t).all()), name + " not finite")
    check(bool(((res["face"] >= 0) & (res["face"] < f.shape[0])).all()),
          "face index out of range")
    # the same batch through the plain version: a sub-batch would center
    # with another reduction order on the card and move near-ties
    v_step, _ = lbs(model, betas, pose, device=dev)
    plain = ck.closest_point_plain(v_step, f, queries,
                                   assume_nondegenerate=nondegen,
                                   tile_variant=main_variant[0])
    check(bool((plain["face"] == res["face"]).all()),
          "main path faces differ from the plain version")
    oracle = closest_faces_and_points_t(v_step[0], f, queries[0, :256])
    gap = float((oracle["sqdist"] - res["sqdist"][0, :256]).abs().max())
    check(gap <= 1e-5, "main path sqdist %.3g from the reconstruction-form "
          "scan" % gap)
    unit = (normals * normals).sum(-1)
    check(bool(((unit - 1).abs() < 1e-5).all()), "normals not unit length")
    log("all %d meshes match the plain version; mesh 0 sqdist within %.3g "
        "of the reconstruction-form scan" % (BATCH, gap))

    n_queries = BATCH * QUERIES_PER_MESH
    log("main path step: median %.3f ms over %d reps (min %.3f, max %.3f), "
        "%.0f queries/s, checksum %.6g, on %s"
        % (step_ms, REPS, min(times), max(times),
           n_queries / (step_ms / 1e3), float(checksum), smi))

    # -- 4. facade ---------------------------------------------------------
    log("== facade: Mesh on one body, %d queries" % FACADE_QUERIES)
    q_np = q1[0].cpu().numpy()
    for key in ck.LAUNCHES:
        ck.LAUNCHES[key] = 0
    m = Mesh(posed[0], f_np, device=dev)
    faces_f, points_f = m.closest_faces_and_points(q_np)
    check(faces_f.dtype == np.uint32 and faces_f.shape == (1, FACADE_QUERIES),
          "facade faces dtype/shape %s %s" % (faces_f.dtype, faces_f.shape))
    check(points_f.dtype == np.float64
          and points_f.shape == (FACADE_QUERIES, 3), "facade points")
    check_facade_against_scan(verts[0], f, q1[0], faces_f, points_f)
    vn = m.estimate_vertex_normals()
    check(vn.dtype == np.float64 and vn.shape == posed[0].shape,
          "facade normals")
    vidx, vdist = m.closest_vertices(q_np)
    check(vidx.shape == (FACADE_QUERIES,) and vdist.dtype == np.float64,
          "facade closest_vertices")
    vc = posed[0].astype(np.float64)
    d_all = ((q_np[:, None, :].astype(np.float64) - vc[None]) ** 2).sum(-1)
    gap = np.abs(np.sqrt(d_all.min(1)) - vdist).max()
    check(gap <= 1e-5, "closest_vertices %.3g from the float64 brute force"
          % gap)
    n2, faces2, points2 = m.normals_and_closest_points(q_np)
    check(np.array_equal(faces2, faces_f)
          and np.allclose(points2, points_f, atol=1e-6)
          and np.allclose(n2, vn, atol=1e-6), "fused facade disagrees")
    launches["facade"] = dict(ck.LAUNCHES)
    for name, paths in KERNEL_PATHS.items():
        for path in paths:
            check(launches[path][name] > 0,
                  "kernel %s never launched on the %s path" % (name, path))
    log("facade ok; launches per path: %s" % launches)

    # per-stage breakdown of one main-path step, after the counted drive
    stages = {}
    stages["lbs"] = cuda_ms(lambda: lbs(model, betas, pose, device=dev), 3)
    stages["vert_normals"] = cuda_ms(lambda: batch_step(verts, f, None), 3)
    ops = ck.closest_point_operands(verts, f, queries, main_variant[0])
    stages["closest_prologue"] = cuda_ms(lambda: ck.closest_point_operands(
        verts, f, queries, main_variant[0]), 3)
    stages["closest_kernel"] = cuda_ms(lambda: ck.argmin_faces(
        ops[0], ops[1], main_variant[0], main_variant[1]), 3)
    best = ck.argmin_faces(ops[0], ops[1], *main_variant)
    stages["closest_epilogue"] = cuda_ms(
        lambda: ck.winner_epilogue(best, ops[2], ops[0], ops[3]), 3)
    del ops
    log("stage breakdown (ms, separate runs): " + ", ".join(
        "%s %.3f" % kv for kv in stages.items()))

    # -- kernels line, card line, result ---------------------------------------
    main = next(r for r in face_runs
                if (r["variant"], r["degenerate_tail"]) == main_variant)
    kernels = [
        {"name": "closest_faces", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/closest_faces.cu",
         "replaces": "mesh_tpu/query/pallas_closest.py:696",
         "launches": launches["main_path"]["closest_faces"],
         "launches_by_path": {p: launches[p]["closest_faces"]
                              for p in launches},
         "max_abs_err": max(r["max_abs_err"] for r in face_runs),
         "ms": main["ms"], "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
         "library_ms": None,
         "variant": "%s, tail=%s" % main_variant,
         "variants": face_runs},
        {"name": "nearest_vertices", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/nearest_vertices.cu",
         "replaces": "mesh_tpu/query/pallas_closest.py:577",
         "launches": launches["facade"]["nearest_vertices"],
         "launches_by_path": {p: launches[p]["nearest_vertices"]
                              for p in launches},
         "max_abs_err": vert_facade["max_abs_err"],
         "ms": vert_facade["ms"], "plain_ms": vert_facade["plain_ms"],
         "bound_ms": vert_facade["bound_ms"],
         "bound_by": vert_facade["bound_by"],
         "library_ms": vert_facade["library_ms"],
         "batch": vert_batch},
    ]
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "main_path_step_ms": step_ms,
                      "stages_ms": stages, "build_s": build_s}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
