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
   on a mesh with planted zero-area and collinear faces); culled_faces in
   all four variants on the large batch of phase 5, and both rope_faces
   entries on the scan of phase 6, each over all its query tiles;
   ray_any_hit on every ray of phase 7 (64 bodies x 4 cameras x 6890
   vertices), alongnormal_faces and normal_weighted_faces (with and without
   the degenerate tail) at phase 8's shapes, the tail variant also on the
   planted mesh; tri_tri_any_hit in both tiles at phase 9's shapes (1,552
   hand faces x 13,776 body faces), the segment tile also with the planted
   mesh's faces as queries against body 0; self_intersect in both tiles on
   every face of body 0 and of phase 5's body 0 (98,304 faces), and on a
   query range of each.  Built without FMA contraction, each kernel must
   pick exactly the faces (vertices, blocked flags, counts) its plain
   version picks, with the same tiles, leaves or pairs tested;
3. main path at full width: lbs -> vertex normals -> batched closest point
   for 256 bodies x 1024 queries, median step time over 10 reps, the
   faces checked against the plain version on the same batch;
4. facade: ``mesh_tpu_torch.Mesh`` closest faces/points, nearest vertices,
   vertex normals and the fused call on one body, with the reference's
   dtypes and shapes; the closest faces/points against the plain
   reconstruction-form scan;
5. large batch: ``batch_step`` on 64 posed bodies of a 98,304-face
   template (``_uv_sphere(256, 192)``) with 4096 surface-proximal queries
   each, which routes to the sphere-culled kernel; median step time over
   10 reps, and the result against the brute-force kernel on the same
   inputs (sqdist within 1e-5, faces equal except at ties);
6. scan: ``Mesh.closest_faces_and_points`` on a 209,304-face sphere with
   65,536 surface-proximal queries, which routes to the BVH rope kernels:
   the streamed entry by default (path ``scan``) and the resident one
   under ``MESH_TPU_BVH_STREAM_VMEM_MB=32`` (path ``scan_resident``); the
   two must be bit-identical, and both are held against the brute-force
   kernel; the host BVH build is timed apart from the cached calls;
7. visibility: ``visibility_step`` on 64 posed bodies from four cameras
   at (+-3, 0, 0) and (0, +-3, 0), vertex normals computed in the step,
   median step time over 10 reps; body 0's flags against a float64
   divided-form recompute (equal except on rays borderline at rounding
   level); on the rest template, a closed surface without folds, every
   back-facing vertex (n.dir < -0.2) must be blocked (the posed synthetic
   bodies fold through themselves, so there the count is only reported);
   then one body through ``Mesh.vertex_visibility`` (omnidirectional and
   with a sensor) and ``visible_mesh``;
8. registration: one posed body as a ``Mesh`` with 65,536 scan-like points
   carrying noisy face normals, through ``compute_aabb_normals_tree()
   .nearest`` and ``compute_aabb_tree().nearest_alongnormal`` (cold first
   call and median of 5 warm calls each), held against float64 dense
   recomputes; a planted miss must come back as 1e100;
9. contact: examples/hand_body_contact.py through the port: an SMPL-sized
   body and a MANO-sized hand (``synthetic_family_model``) posed by its
   recipe, ``compute_aabb_tree().intersections_indices`` (the gate's tile,
   and the segment tile under ``MESH_TPU_SAFE_TILES=1``: the same faces),
   ``tree.nearest`` and the signed gap from ``tri_normals``; the cold first
   call and the median of 5 warm calls of the step and of
   ``intersections_indices``; each tile's mask against a float64
   recompute of its own predicate (``decide64``: equal except on faces
   borderline within TOL_MOVE);
10. self_intersect: ``query.self_intersection_count`` on phase 3's and
   phase 5's posed body 0 (cold first call, median of 5 warm calls, the
   kernel alone in both tiles): 0 on each rest template (a closed UV
   sphere), above 0 posed; where the two tiles' involved faces differ,
   and on 512 faces (half involved), each tile against a float64
   recompute of its own predicate.

After phase 10, the four closest-point routes (brute, culled, resident and
streamed rope) are timed at phases 5 and 6's shapes: the crossover
evidence.

Phases 3-10 are the driven paths (phase 6 twice).  Kernel launch counts
are set to 0 just before each and read just after it, and every kernel
must have launched on each path of ``KERNEL_PATHS`` and on no other
path.  The last lines are the card's name and power limit (nvidia-smi),
one JSON line describing every kernel with its launches per path, and
``{"ok": true, "device": ...}``.

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

#: phase 5: a finer body template, (n_seg, n_ring) of _uv_sphere, scaled
#: to body proportions (49,154 vertices, 98,304 faces)
LARGE_TEMPLATE = (256, 192)
LARGE_BATCH = 64
LARGE_QUERIES = 4096
#: scan points: a random face, a random barycentric point, N(0, 5 mm)
SCAN_NOISE = 0.005

#: phase 6: bench.py's accel_stream_proxy recipe at 65,536 queries
SCAN_FACES = 210000
SCAN_QUERIES = 65536

#: phase 7: the main path's first bodies seen from four cameras around them
VIS_BATCH = 64
VIS_CAMERAS = ((3.0, 0.0, 0.0), (-3.0, 0.0, 0.0), (0.0, 3.0, 0.0),
               (0.0, -3.0, 0.0))
VIS_MIN_DIST = 1e-3
#: n.dir below this: a back-facing vertex, which a closed mesh must block
BACKFACING = -0.2
#: the facade's sensor for camera 0: x and y half-axes (0.05 along y, 0.2
#: along z) on a plane 1 in front of the camera, z axis towards the camera
FACADE_SENSOR = (0.0, 0.05, 0.0, 0.0, 0.0, 0.2, 1.0, 0.0, 0.0)

#: phase 8: scan registration of one posed body
REG_QUERIES = 65536
REG_EPS = 0.1
REG_NORMAL_NOISE = 0.1
#: queries held against the float64 dense blended minimum
REG_CHECK = 1024

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

#: operations per pair of the rope kernels: the fast tile with its tail
ROPE_PAIR_OPS = FACE_PAIR_OPS[("fast", True)]

#: operations per pair counted in csrc/ray_cost.cuh and the kernels over
#: it: any-hit (line_hit, the t_lo test, the exit test), along-normal
#: (line_hit, |tn|, the guard, the division, the miss select, the argmin),
#: normal-weighted (the fast tile + normal dot, sqrt, 1 - dot, times eps)
RAY_PAIR_OPS = 64
ALONG_PAIR_OPS = 67
NW_PAIR_OPS = {False: FACE_PAIR_OPS[("fast", False)] + 8,
               True: FACE_PAIR_OPS[("fast", True)] + 8}

#: operations per pair of the triangle-triangle tiles, counted in
#: csrc/tri_tri_cost.cuh; the self-intersection kernel adds 21 of its own
#: (9 vertex-id compares, 8 ors, the self test, two ands, the count's add)
TRI_PAIR_OPS = {"segment": 428, "moller": 232}
SELF_PAIR_OPS = {k: v + 21 for k, v in TRI_PAIR_OPS.items()}

#: phase 9: examples/hand_body_contact.py's recipe (hand offset from the
#: body axis, m; contact: a hand vertex within 1 cm of the body)
CONTACT_OFFSET = (0.26, 0.0, 0.1)
CONTACT_GAP = 0.01
#: the float64 checks' borderline band: a face whose float64 decision
#: flips when the segment tests' tolerances move by this much may differ
TOL_MOVE = 1e-6
#: phase 10: faces of each posed body held against float64 (half involved)
SELF_CHECK_FACES = 512

#: kernel -> the driven paths that must launch it (and no other path may);
#: the first path's count is the kernel's ``launches`` in the kernels line
KERNEL_PATHS = {"closest_faces": ("main_path", "facade", "contact"),
                "nearest_vertices": ("facade",),
                "culled_faces": ("large_batch",),
                "rope_faces_stream": ("scan",),
                "rope_faces_resident": ("scan_resident",),
                "ray_any_hit": ("visibility",),
                "alongnormal_faces": ("registration",),
                "normal_weighted_faces": ("registration",),
                "tri_tri_any_hit": ("contact",),
                "self_intersect": ("self_intersect",)}


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


class _Camera(object):
    """A camera as the facade reads one: an origin and a sensor's axes."""

    def __init__(self, origin, sensor_axis):
        self.origin = np.asarray(origin)
        self.sensor_axis = np.asarray(sensor_axis)


def kernel_counters():
    """The launch-count dicts of every kernel wrapper."""
    from mesh_tpu_torch.accel import rope_kernel as rk
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import culled_kernel as qk
    from mesh_tpu_torch.query import normal_weighted as nw
    from mesh_tpu_torch.query import ray_kernel as ray
    from mesh_tpu_torch.query import tri_tri_kernel as tk

    return (ck.LAUNCHES, qk.LAUNCHES, rk.LAUNCHES, ray.LAUNCHES, nw.LAUNCHES,
            tk.LAUNCHES, tk.TILE_LAUNCHES)


def reset_launches():
    for counts in kernel_counters():
        for key in counts:
            counts[key] = 0


def read_launches():
    out = {}
    for counts in kernel_counters():
        out.update(counts)
    return out


def timed(fn):
    """(fn(), milliseconds of this one call by CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def surface_queries(verts, faces, n_q, rng):
    """Scan-like points on a batch ``verts`` [B, V, 3]: per body, n_q
    random faces, random barycentric points and N(0, SCAN_NOISE) noise ->
    (points [B, Q, 3], picked faces [B, Q])."""
    n_b = verts.shape[0]
    dev = verts.device
    pick = torch.as_tensor(rng.randint(0, faces.shape[0], (n_b, n_q)),
                           device=dev)
    w = torch.as_tensor(rng.dirichlet([1.0, 1.0, 1.0], (n_b, n_q)),
                        dtype=torch.float32, device=dev)
    noise = torch.as_tensor(rng.randn(n_b, n_q, 3) * SCAN_NOISE,
                            dtype=torch.float32, device=dev)
    rows = torch.arange(n_b, device=dev)[:, None, None]
    tri = verts[rows, faces.long()[pick]]                 # [B, Q, 3, 3]
    points = torch.einsum("bqk,bqkx->bqx", w, tri) + noise
    return points.contiguous(), pick


def check_against_brute(name, v, f, q, faces, sqdist, brute):
    """A drive's faces and sqdist [B, Q] against the brute-force kernel's
    result on the same inputs (v [B, V, 3], q [B, Q, 3]): sqdist within
    1e-5, faces equal except at ties, where the two faces' distances in
    the brute kernel's frame are within 1e-6."""
    from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

    gap = float((sqdist - brute["sqdist"]).abs().max())
    check(gap <= 1e-5, "%s: sqdist %.3g from the brute kernel" % (name, gap))
    differ = faces.long() != brute["face"].long()
    n_diff, tie = int(differ.sum()), 0.0
    if n_diff:
        center = v.mean(dim=-2, keepdim=True)
        b, qi = differ.nonzero(as_tuple=True)
        vc = v - center
        qc = (q - center)[b, qi]

        def sqd(face):
            t = vc[b[:, None], f.long()[face.long()]]
            return closest_point_on_triangle(qc, t[:, 0], t[:, 1], t[:, 2])[1]

        tie = float((sqd(faces[b, qi]) - sqd(brute["face"][b, qi])).abs().max())
        check(tie <= 1e-6, "%s: %d faces differ from the brute kernel's and "
              "are %.3g apart, not a tie" % (name, n_diff, tie))
    log("  %s vs brute kernel: sqdist within %.3g, %d of %d faces differ, "
        "all at ties (max gap %.3g)" % (name, gap, n_diff, faces.numel(), tie))
    return {"sqdist_gap": gap, "faces_differ": n_diff, "tie_gap": tie}


def compare_culled(qk, ops, variant, tail, timing):
    """Kernel vs plain for culled_faces on one operand set: identical faces
    and tested tiles over every query tile."""
    k, kv = qk.argmin_culled(ops, variant, tail)
    (p, pv), plain_ms = timed(
        lambda: qk.argmin_culled_plain(ops, variant, tail))
    mism = int((k != p).sum())
    check(mism == 0 and bool((kv == pv).all()),
          "culled_faces[%s, tail=%s]: %d of %d faces (and %d tile counts) "
          "differ from the plain version" % (
              variant, tail, mism, k.numel(), int((kv != pv).sum())))
    rk_, rp = qk.culled_epilogue(ops, k), qk.culled_epilogue(ops, p)
    err = max(float((rk_["point"] - rp["point"]).abs().max()),
              float((rk_["sqdist"] - rp["sqdist"]).abs().max()))
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    n_ft = ops["fsph"].shape[1]
    tested = int(kv.sum())
    out = {"variant": variant, "degenerate_tail": tail,
           "shape": list(ops["seed"].shape) + [ops["planes"].shape[-1]],
           "faces_identical": True, "max_abs_err": err,
           "face_tiles_tested": tested, "face_tiles": kv.numel() * n_ft,
           "plain_ms": plain_ms}
    if timing:
        out["ms"] = cuda_ms(lambda: qk.argmin_culled(ops, variant, tail),
                            reps=REPS)
        n_bytes = 4 * (sum(ops[key].numel() for key in (
            "pts_s", "seed", "qsph", "fsph", "planes")) + k.numel()
            + kv.numel())
        out["bound_ms"], out["bound_by"] = bound_ms(
            tested * tile_q * tile_f, FACE_PAIR_OPS[(variant, tail)], n_bytes)
    log("  culled_faces[%s, tail=%s] %s: faces and tile counts identical, "
        "%d of %d face tiles tested, max abs point/sqdist diff %.3g, plain "
        "%.1f ms%s" % (variant, tail, out["shape"], tested, out["face_tiles"],
                       err, plain_ms, "" if not timing else
                       ", %.3f ms (bound %.3f ms)"
                       % (out["ms"], out["bound_ms"])))
    return out


def compare_rope(rk, ops, n_buffers):
    """Kernel vs plain for one rope_faces entry on one operand set:
    identical distances, faces and leaf counts over every query tile."""
    name = "rope_faces_stream" if n_buffers else "rope_faces_resident"
    kd, ki, kl = rk.rope_argmin(ops, n_buffers)
    (pd, pi, pl), plain_ms = timed(lambda: rk.rope_argmin_plain(ops,
                                                                n_buffers))
    check(torch.equal(ki, pi) and torch.equal(kl, pl) and torch.equal(kd, pd),
          "%s: %d of %d faces (and %d leaf counts) differ from the plain "
          "version" % (name, int((ki != pi).sum()), ki.numel(),
                       int((kl != pl).sum())))
    leaves = int(kl.sum())
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    n_leaves = ops["rows"].shape[-1] // tile_f
    out = {"shape": [ops["seed"].shape[0], ops["rows"].shape[-1]],
           "n_buffers": n_buffers, "faces_identical": True,
           "max_abs_err": float((kd - pd).abs().max()),
           "leaves_tested": leaves, "leaves": kl.numel() * n_leaves,
           "plain_ms": plain_ms,
           "ms": cuda_ms(lambda: rk.rope_argmin(ops, n_buffers), reps=REPS)}
    n_bytes = 4 * (sum(ops[key].numel() for key in (
        "pts_s", "seed", "boxes", "topo", "rows")) + 2 * kd.numel()
        + kl.numel())
    out["bound_ms"], out["bound_by"] = bound_ms(
        leaves * tile_q * tile_f, ROPE_PAIR_OPS, n_bytes)
    log("  %s %s: faces, distances and leaf counts identical, %d of %d "
        "leaves tested, %.3f ms (plain %.1f ms, bound %.3f ms)" % (
            name, out["shape"], leaves, out["leaves"], out["ms"], plain_ms,
            out["bound_ms"]))
    return out, (kd, ki, kl)


def large_batch_inputs(dev):
    """Phase 5's inputs: the finer-template body model, betas and pose for
    LARGE_BATCH bodies, the posed vertices and surface-proximal queries."""
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.models.body_model import _uv_sphere

    v, f = _uv_sphere(*LARGE_TEMPLATE)
    model = synthetic_body_model(
        seed=0, template=(v * np.array([0.3, 0.2, 0.9]), f), device=dev)
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(LARGE_BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(LARGE_BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    verts, _ = lbs(model, betas, pose, device=dev)
    queries, _ = surface_queries(verts, model.faces, LARGE_QUERIES, rng)
    return model, betas, pose, verts, queries


def scan_inputs():
    """Phase 6's mesh and queries: bench.py's parametric sphere and its
    surface-proximal points (unit directions pushed a few percent off)."""
    from mesh_tpu_torch.query.autotune import _sphere_mesh

    v, f = _sphere_mesh(SCAN_FACES)
    rng = np.random.RandomState(0)
    pts = rng.randn(SCAN_QUERIES, 3)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= 1.0 + 0.05 * rng.randn(SCAN_QUERIES, 1)
    return v, f, pts.astype(np.float32)


def drive_scan(path, v, f, pts, dev):
    """One scan path: the Mesh facade (first call cold, then warm calls)
    and the accel rung with its stats, counts reset just before and read
    just after."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
    from mesh_tpu_torch.query import culled as auto

    reset_launches()
    auto.STRATEGY.clear()
    m = Mesh(v, f, device=dev)
    t0 = time.perf_counter()
    faces, points = m.closest_faces_and_points(pts)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        faces2, points2 = m.closest_faces_and_points(pts)
        times.append((time.perf_counter() - t0) * 1e3)
    vt, ft = m.device_arrays()
    res, stats = closest_faces_and_points_accel(vt, ft, pts, with_stats=True,
                                                device=dev)
    launches = read_launches()
    check(dict(auto.STRATEGY) == {"accel_bvh": 6},
          "%s routes %s, not the BVH" % (path, auto.STRATEGY))
    check(faces.dtype == np.uint32 and faces.shape == (1, SCAN_QUERIES)
          and points.dtype == np.float64
          and points.shape == (SCAN_QUERIES, 3), "%s facade dtype/shape"
          % path)
    check(np.array_equal(faces, faces2) and np.array_equal(points, points2)
          and np.array_equal(faces[0], res["face"].astype(np.uint32))
          and np.array_equal(points, res["point"].astype(np.float64)),
          "%s: repeated calls disagree" % path)
    check(bool(np.isfinite(res["sqdist"]).all()), "%s sqdist not finite"
          % path)
    log("  %s: backend %s, %d pair tests (%.1f%% of Q x F), first facade "
        "call %.3f s (with the host BVH build), warm calls median %.3f ms "
        "(min %.3f, max %.3f)" % (
            path, stats["backend"], stats["pair_tests"],
            100.0 * stats["pair_tests"] / (SCAN_QUERIES * f.shape[0]),
            first_s, statistics.median(times), min(times), max(times)))
    return res, stats, launches, {
        "first_call_s": first_s, "warm_call_ms": statistics.median(times),
        "warm_call_ms_min": min(times), "warm_call_ms_max": max(times)}


def crossover(dev, large, scan):
    """Every closest-point route timed at both drives' shapes (ms, CUDA
    events around whole calls, 3 reps after a warm-up): brute force,
    culled, resident and streamed rope."""
    from mesh_tpu_torch.accel import rope_kernel as rk
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import culled_kernel as qk

    verts, f_l, q_l, nondegen = large
    v_s, f_s, p_s = scan
    n_b, n_q = q_l.shape[:2]
    shapes = [
        ("large_batch %d bodies x %d" % (n_b, n_q), verts, f_l, q_l, nondegen,
         False),
        ("large_batch body 0 x %d" % n_q, verts[0], f_l, q_l[0], nondegen,
         True),
        ("scan 1 x %d" % p_s.shape[0], torch.as_tensor(v_s, device=dev),
         torch.as_tensor(f_s, device=dev), torch.as_tensor(p_s, device=dev),
         True, True),
    ]
    rows = []
    for label, v, f, q, nd, single in shapes:
        row = {"shape": label, "faces": int(f.shape[0]),
               "brute": cuda_ms(lambda: ck.closest_point_kernel(
                   v, f, q, assume_nondegenerate=nd), 3),
               "culled": cuda_ms(lambda: qk.closest_point_culled_kernel(
                   v, f, q, assume_nondegenerate=nd), 3)}
        vb, qb = (v[None], q[None]) if single else (v, q)
        ops = qk.culled_operands(vb, f, qb)
        _, tested = qk.argmin_culled(ops, "fast", not nd)
        row["culled_face_tiles_tested"] = float(tested.sum()) / (
            tested.numel() * ops["fsph"].shape[1])
        del ops
        if single:
            row["rope_resident"] = cuda_ms(
                lambda: rk.closest_point_bvh_kernel(v, f, q, device=dev), 3)
            row["rope_stream"] = cuda_ms(
                lambda: rk.closest_point_bvh_stream_kernel(v, f, q,
                                                           device=dev), 3)
        rows.append(row)
        log("  crossover at %s (%d faces): %s; culled tests %.1f%% of its "
            "face tiles" % (label, row["faces"], ", ".join(
                "%s %.3f ms" % (k, row[k]) for k in (
                    "brute", "culled", "rope_resident", "rope_stream")
                if k in row), 100 * row["culled_face_tiles_tested"]))
    return rows


def compare_any_hit(ray, origins, dirs, planes):
    """Kernel vs plain for ray_any_hit on one operand set: identical blocked
    flags and pairs tested per ray, both timed."""
    kb, kt = ray.ray_any_hit(origins, dirs, planes, t_lo=0.0)
    (pb, pt), plain_ms = timed(
        lambda: ray.ray_any_hit_plain(origins, dirs, planes, t_lo=0.0))
    check(torch.equal(kb, pb) and torch.equal(kt, pt),
          "ray_any_hit: %d of %d blocked flags (and %d pair counts) differ "
          "from the plain version" % (int((kb != pb).sum()), kb.numel(),
                                      int((kt != pt).sum())))
    n_b, n_r = origins.shape[:2]
    tested = int(kt.sum())
    pairs = n_b * n_r * planes.shape[-1]
    out = {"shape": [n_b, n_r, planes.shape[-1]], "flags_identical": True,
           "max_abs_err": float((kb.int() - pb.int()).abs().max()),
           "blocked_share": float(kb.float().mean()),
           "pairs_tested": tested, "pairs": pairs, "plain_ms": plain_ms,
           "ms": cuda_ms(lambda: ray.ray_any_hit(origins, dirs, planes,
                                                 t_lo=0.0), reps=REPS)}
    n_bytes = 4 * (origins.numel() + dirs.numel() + planes.numel()
                   + 2 * kb.numel())
    out["bound_ms"], out["bound_by"] = bound_ms(tested, RAY_PAIR_OPS,
                                                n_bytes)
    log("  ray_any_hit %s: flags and pair counts identical, %.1f%% blocked, "
        "%d of %d pairs tested (%.1f%%), %.3f ms (plain %.1f ms, bound %.3f "
        "ms)" % (out["shape"], 100 * out["blocked_share"], tested, pairs,
                 100.0 * tested / pairs, out["ms"], plain_ms, out["bound_ms"]))
    return out


def compare_alongnormal(ray, pts, nrm, tri):
    """Kernel vs plain for alongnormal_faces: identical faces, and the
    epilogue's distances and points after each."""
    planes = ray.ray_planes(tri)
    k = ray.argmin_alongnormal(pts, nrm, planes)
    p, plain_ms = timed(lambda: ray.argmin_alongnormal_plain(pts, nrm,
                                                             planes))
    check(torch.equal(k, p), "alongnormal_faces: %d of %d faces differ from "
          "the plain version" % (int((k != p).sum()), k.numel()))
    dk = ray.alongnormal_epilogue(k, tri, pts, nrm)
    dp = ray.alongnormal_epilogue(p, tri, pts, nrm)
    check(torch.equal(dk[0], dp[0]), "alongnormal_faces: epilogue distances "
          "differ on identical faces")
    n_b, n_q = pts.shape[:2]
    out = {"shape": [n_b, n_q, planes.shape[-1]], "faces_identical": True,
           "max_abs_err": float((dk[2] - dp[2]).abs().max()),
           "hit_share": float(torch.isfinite(dk[0]).float().mean()),
           "plain_ms": plain_ms,
           "ms": cuda_ms(lambda: ray.argmin_alongnormal(pts, nrm, planes),
                         reps=REPS)}
    n_bytes = 4 * (pts.numel() + nrm.numel() + planes.numel() + k.numel())
    out["bound_ms"], out["bound_by"] = bound_ms(
        n_b * n_q * planes.shape[-1], ALONG_PAIR_OPS, n_bytes)
    log("  alongnormal_faces %s: faces identical, %.1f%% hit, %.3f ms "
        "(plain %.1f ms, bound %.3f ms)" % (
            out["shape"], 100 * out["hit_share"], out["ms"], plain_ms,
            out["bound_ms"]))
    return out


def compare_normal_weighted(nw, ops, tail, timing):
    """Kernel vs plain for normal_weighted_faces on one operand set:
    identical faces, and the epilogue's points after each."""
    pts, nrm, planes, tri, center = ops
    k = nw.argmin_normal_weighted(pts, nrm, planes, REG_EPS, tail)
    p, plain_ms = timed(lambda: nw.argmin_normal_weighted_plain(
        pts, nrm, planes, REG_EPS, tail))
    check(torch.equal(k, p), "normal_weighted_faces[tail=%s]: %d of %d "
          "faces differ from the plain version"
          % (tail, int((k != p).sum()), k.numel()))
    pk = nw.normal_weighted_epilogue(k, tri, pts, center)[1]
    pp = nw.normal_weighted_epilogue(p, tri, pts, center)[1]
    n_b, n_q = pts.shape[:2]
    out = {"degenerate_tail": tail, "shape": [n_b, n_q, planes.shape[-1]],
           "faces_identical": True,
           "max_abs_err": float((pk - pp).abs().max()), "plain_ms": plain_ms}
    if timing:
        out["ms"] = cuda_ms(lambda: nw.argmin_normal_weighted(
            pts, nrm, planes, REG_EPS, tail), reps=REPS)
        n_bytes = 4 * (pts.numel() + nrm.numel() + planes.numel()
                       + k.numel())
        out["bound_ms"], out["bound_by"] = bound_ms(
            n_b * n_q * planes.shape[-1], NW_PAIR_OPS[tail], n_bytes)
    log("  normal_weighted_faces[tail=%s] %s: faces identical, plain %.1f "
        "ms%s" % (tail, out["shape"], plain_ms, "" if not timing else
                  ", %.3f ms (bound %.3f ms)" % (out["ms"], out["bound_ms"])))
    return out


def registration_inputs(verts0, faces, rng):
    """Phase 8's queries on one posed body ``verts0`` [V, 3]: scan-like
    points, each with its face's unit normal perturbed by
    N(0, REG_NORMAL_NOISE) and renormalized; the last query is a planted
    miss: the line through (50, 0, 0) along y passes far from the body."""
    from mesh_tpu_torch.geometry.tri_normals import normalize_rows
    from mesh_tpu_torch.geometry.tri_normals import tri_normals_scaled_t

    pts, pick = surface_queries(verts0[None], faces, REG_QUERIES, rng)
    fn = normalize_rows(tri_normals_scaled_t(verts0, faces))[pick[0]]
    noise = torch.as_tensor(rng.randn(REG_QUERIES, 3) * REG_NORMAL_NOISE,
                            dtype=torch.float32, device=verts0.device)
    nrm = normalize_rows(fn + noise)
    pts, nrm = pts[0].clone(), nrm.contiguous()
    pts[-1] = torch.tensor([50.0, 0.0, 0.0])
    nrm[-1] = torch.tensor([0.0, 1.0, 0.0])
    return pts.contiguous(), nrm.contiguous()


def blended_min64(v, f, pts, nrm, faces):
    """Float64 dense check of the normal-weighted search: per query, the
    blended cost of the given face and the least over every face."""
    from mesh_tpu_torch.geometry.cross_product import cross3
    from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

    tri = v.double()[f.long()]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    fn = cross3(b - a, c - a)
    fn = fn / (fn * fn).sum(-1, keepdim=True).sqrt().clamp_min(1e-300)
    q, n = pts.double(), nrm.double()

    def cost(qq, nn, aa, bb, cc, ff):
        _, sq, _ = closest_point_on_triangle(qq, aa, bb, cc)
        return sq.sqrt() + REG_EPS * (1.0 - (nn * ff).sum(-1))

    fl = faces.long()
    mine = cost(q, n, a[fl], b[fl], c[fl], fn[fl])
    least = torch.cat([
        cost(q[i:i + 64, None], n[i:i + 64, None], a[None], b[None],
             c[None], fn[None]).min(dim=-1).values
        for i in range(0, q.shape[0], 64)])
    return mine, least


def any_hit64(origins, dirs, tri, t_lo=0.0, near=1e-5):
    """Float64 divided-form recompute of the any-hit test: per ray [R],
    whether some face is hit with t >= t_lo, and whether some face sits
    within ``near`` of the predicate's boundary (its tightest barycentric
    or ray-parameter slack), where float32 rounding may decide either
    way."""
    from mesh_tpu_torch.geometry.cross_product import cross3

    tri = tri.double()
    a = tri[None, :, 0]
    e1, e2 = tri[None, :, 1] - a, tri[None, :, 2] - a
    blocked, border = [], []
    for i in range(0, origins.shape[0], 256):
        o = origins[i:i + 256].double()[:, None]
        d = dirs[i:i + 256].double()[:, None]
        pvec = cross3(d, e2)
        det = (e1 * pvec).sum(-1)
        valid = det.abs() >= 1e-9
        inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
        s = o - a
        u = (s * pvec).sum(-1) * inv
        qvec = cross3(s, e1)
        v = (d * qvec).sum(-1) * inv
        t = (e2 * qvec).sum(-1) * inv
        slack = torch.minimum(torch.minimum(u + 1e-6, v + 1e-6),
                              torch.minimum(1.0 + 1e-6 - u - v, t - t_lo))
        blocked.append((valid & (slack >= 0)).any(dim=-1))
        border.append((valid & (slack.abs() <= near)).any(dim=-1))
    return torch.cat(blocked), torch.cat(border)


def alongnormal_hits64(v, f, pts, nrm):
    """Float64 dense recompute of the along-normal search in the divided
    form: (whether any face is hit [Q], least |t| |n| over the hits)."""
    from mesh_tpu_torch.query.ray import ray_triangle_hits

    tri = v.double()[f.long()]
    a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
    any_hit, least = [], []
    for i in range(0, pts.shape[0], 256):
        p = pts[i:i + 256].double()[:, None]
        n = nrm[i:i + 256].double()[:, None]
        t, hit = ray_triangle_hits(p, n, a, b, c)
        d = torch.where(hit, t.abs() * n.norm(dim=-1), float("inf"))
        any_hit.append(hit.any(dim=-1))
        least.append(d.min(dim=-1).values)
    return torch.cat(any_hit), torch.cat(least)


def compare_tri_tri(tk, qp, fp, algorithm, label, timing):
    """Kernel vs plain for tri_tri_any_hit on one operand set: identical
    flags and pairs tested per query, the plain version timed."""
    k, kt = tk.tri_tri_any_hit(qp, fp, algorithm)
    (p, pt), plain_ms = timed(
        lambda: tk.tri_tri_any_hit_plain(qp, fp, algorithm))
    check(torch.equal(k, p) and torch.equal(kt, pt),
          "tri_tri_any_hit[%s] on %s: %d of %d flags (and %d pair counts) "
          "differ from the plain version" % (
              algorithm, label, int((k != p).sum()), k.numel(),
              int((kt != pt).sum())))
    n_q, n_f = qp.shape[-1], fp.shape[-1]
    tested = int(kt.sum())
    out = {"tile": algorithm, "on": label, "shape": [n_q, n_f],
           "flags_identical": True, "max_abs_err": 0.0,
           "hit": int(k.sum()), "pairs_tested": tested, "pairs": n_q * n_f,
           "plain_ms": plain_ms}
    if timing:
        out["ms"] = cuda_ms(lambda: tk.tri_tri_any_hit(qp, fp, algorithm),
                            reps=REPS)
        n_bytes = 4 * (qp.numel() + fp.numel() + 2 * n_q)
        out["bound_ms"], out["bound_by"] = bound_ms(
            tested, TRI_PAIR_OPS[algorithm], n_bytes)
    log("  tri_tri_any_hit[%s] on %s %s: flags and pair counts identical, "
        "%d hit, %d of %d pairs tested, plain %.1f ms%s" % (
            algorithm, label, out["shape"], out["hit"], tested, n_q * n_f,
            plain_ms, "" if not timing else ", %.3f ms (bound %.4f ms)"
            % (out["ms"], out["bound_ms"])))
    return out


def compare_self(tk, tri, ids, algorithm, label):
    """Kernel vs plain for self_intersect on every face of a mesh against
    all its faces: identical per-face counts, both timed; the kernel on
    the query range [F / 4, F / 2) must give that slice of the counts."""
    qp, fp = tk.self_planes(tri, algorithm)
    n_f = tri.shape[0]
    k = tk.self_intersect_counts(qp, fp, ids, algorithm)
    p, plain_ms = timed(lambda: tk.self_intersect_counts_plain(
        qp, fp, ids, algorithm))
    check(torch.equal(k, p), "self_intersect[%s] on %s: %d of %d counts "
          "differ from the plain version" % (algorithm, label,
                                             int((k != p).sum()), k.numel()))
    r0, r1 = n_f // 4, n_f // 2
    check(torch.equal(tk.self_intersect_counts(qp, fp, ids, algorithm, r0,
                                               r1), k[r0:r1]),
          "self_intersect[%s] on %s: the query range [%d, %d) differs from "
          "the whole mesh's counts" % (algorithm, label, r0, r1))
    out = {"tile": algorithm, "on": label, "shape": [n_f, n_f],
           "counts_identical": True, "max_abs_err": 0.0,
           "involved": int((k > 0).sum()), "partners": int(k.sum()),
           "pairs": n_f * n_f, "plain_ms": plain_ms,
           "ms": cuda_ms(lambda: tk.self_intersect_counts(
               qp, fp, ids, algorithm), reps=3)}
    n_bytes = 4 * (qp.numel() + fp.numel() + ids.numel() + n_f)
    out["bound_ms"], out["bound_by"] = bound_ms(
        n_f * n_f, SELF_PAIR_OPS[algorithm], n_bytes)
    log("  self_intersect[%s] on %s %s: counts identical, %d faces "
        "involved, %d partners, %.3f ms (plain %.1f ms, bound %.4f ms)" % (
            algorithm, label, out["shape"], out["involved"], out["partners"],
            out["ms"], plain_ms, out["bound_ms"]))
    return out


def decide64(tile, q_tri, tri, q_ids=None, f_ids=None, q_index=None):
    """Float64 decision of ``tile``'s predicate for each query triangle
    [Q, 3, 3] against every face [F, 3, 3]: (any hit [Q], borderline [Q]),
    bool on the CPU.

    - segment: the divided segment form (query/ray.py tri_tri_intersects):
      a pair's slack is the best of its six segment tests' least margin
      (u, v, 1 - u - v, t, 1 - t, each with the 1e-9 tolerance; a test
      with |det| under 1e-9 counts -inf); a query hits iff its largest
      slack is >= 0, and moving every tolerance by TOL_MOVE flips that
      only where |slack| < TOL_MOVE: borderline.
    - moller: Moller's interval test on the triangles prescaled together
      into the unit box, as the tile's prologue does
      (tri_tri_intersects_moller); borderline where moving the plane
      thickening from 1e-9 to 0 or to 1e-9 + TOL_MOVE changes the
      decision.

    With ``q_ids`` / ``f_ids`` (vertex ids) and ``q_index`` (the queries'
    face indices), faces sharing a vertex with the query, or the query
    itself, are left out, as the self-intersection count does."""
    from mesh_tpu_torch.geometry.cross_product import cross3
    from mesh_tpu_torch.query import tri_tri_kernel as tk

    eps = 1e-9
    q_all, tri = q_tri.double(), tri.double()
    if tile == "moller":
        q_all, tri = tk.moller_prescale(q_all, tri)
        planes = tk.tri_planes(tri[None])
    hits, borders = [], []
    chunk = max(1, (1 << 22) // max(1, tri.shape[0]))
    for i in range(0, q_all.shape[0], chunk):
        q = q_all[i:i + chunk][:, None]                     # [c, 1, 3, 3]
        excluded = torch.zeros((q.shape[0], tri.shape[0]), dtype=torch.bool,
                               device=tri.device)
        if q_ids is not None:
            qi = q_ids[i:i + chunk].long()
            excluded = (qi[:, :, None, None] == f_ids.long()[None, None]).any(
                dim=1).any(dim=-1)
            excluded |= (q_index[i:i + chunk, None].long()
                         == torch.arange(tri.shape[0], device=tri.device))
        if tile == "moller":
            qp = tk.tri_planes(q)
            flags = [((tk.moller_hit(*(tuple(x[..., k] for k in range(3))
                                       for x in qp[:4]), qp[4],
                                     *(tuple(x[..., k] for k in range(3))
                                       for x in planes[:4]), planes[4], e)
                       & ~excluded).any(dim=-1))
                     for e in (eps, 0.0, eps + TOL_MOVE)]
            hits.append(flags[0])
            borders.append((flags[1] != flags[0]) | (flags[2] != flags[0]))
            continue
        m = tri[None]                                       # [1, F, 3, 3]
        pair = None
        for src, dst in ((q, m), (m, q)):
            a = dst[..., 0, :]
            e1, e2 = dst[..., 1, :] - a, dst[..., 2, :] - a
            for c in range(3):
                s0 = src[..., c, :]
                d = src[..., (c + 1) % 3, :] - s0
                pvec = cross3(d, e2)
                det = (e1 * pvec).sum(-1)
                valid = det.abs() >= eps
                inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
                sv = s0 - a
                u = (sv * pvec).sum(-1) * inv
                qvec = cross3(sv, e1)
                v = (d * qvec).sum(-1) * inv
                t = (e2 * qvec).sum(-1) * inv
                slack = torch.minimum(
                    torch.minimum(torch.minimum(u + eps, v + eps),
                                  1.0 + eps - (u + v)),
                    torch.minimum(t + eps, 1.0 + eps - t))
                slack = torch.where(valid, slack,
                                    torch.full_like(slack, -float("inf")))
                pair = slack if pair is None else torch.maximum(pair, slack)
        best = torch.where(excluded, torch.full_like(pair, -float("inf")),
                           pair).max(dim=-1).values
        hits.append(best >= 0)
        borders.append(best.abs() < TOL_MOVE)
    return torch.cat(hits).cpu(), torch.cat(borders).cpu()


def check_against64(name, flags, decided):
    """Per-query flags [Q] against a float64 decision (any hit [Q],
    borderline [Q]) of ``decide64``: equal except on borderline queries.
    Returns (flags that differ, borderline queries)."""
    exact, border = decided
    differ = flags.cpu() != exact
    off = differ & ~border
    check(not bool(off.any()), "%s: %d of %d flags differ from the float64 "
          "recompute away from the borderline band (queries %s)" % (
              name, int(off.sum()), flags.numel(),
              off.nonzero()[:5, 0].tolist()))
    return int(differ.sum()), int(border.sum())


def contact_inputs(dev):
    """Phase 9's meshes, as examples/hand_body_contact.py makes them: an
    SMPL-sized body (betas N(0, 0.3), rest pose) and a MANO-sized hand
    (pose N(0, 0.05)) offset against its flank -> (body_v, body_f, hand_v,
    hand_f) numpy, float32 vertices and uint32 faces."""
    from mesh_tpu_torch.models import lbs, synthetic_family_model

    body_model = synthetic_family_model("smpl", device=dev)
    hand_model = synthetic_family_model("mano", device=dev)
    rng = np.random.RandomState(0)
    body_v = lbs(body_model,
                 torch.as_tensor(rng.randn(1, body_model.num_betas) * 0.3,
                                 dtype=torch.float32, device=dev),
                 torch.zeros((1, body_model.num_joints, 3), device=dev),
                 device=dev)[0][0].cpu().numpy()
    hand_v = lbs(hand_model,
                 torch.zeros((1, hand_model.num_betas), device=dev),
                 torch.as_tensor(rng.randn(1, hand_model.num_joints, 3)
                                 * 0.05, dtype=torch.float32, device=dev),
                 device=dev)[0][0].cpu().numpy()
    hand_v = hand_v + np.array(CONTACT_OFFSET)
    return (body_v, body_model.faces.cpu().numpy().astype(np.uint32),
            hand_v, hand_model.faces.cpu().numpy().astype(np.uint32))


def contact_step(body, hand, dev):
    """examples/hand_body_contact.py steps 1-2 through the port: the
    intersecting hand faces, then the signed gap of every hand vertex to
    the body (closest point, signed by the closest face's normal)."""
    from mesh_tpu_torch.geometry import tri_normals

    tree = body.compute_aabb_tree()
    hit_faces = tree.intersections_indices(hand.v, hand.f)
    f_idx, points = tree.nearest(hand.v)
    gap = np.linalg.norm(np.asarray(hand.v) - points, axis=1)
    face_normals = tri_normals(body.v, body.f.astype(np.int32),
                               device=dev).cpu().numpy()
    inside = np.sum((np.asarray(hand.v) - points)
                    * face_normals[np.asarray(f_idx).ravel()], axis=1) < 0
    signed = np.where(inside, -gap, gap)
    return hit_faces, signed


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1

    from mesh_tpu_torch import Mesh, _build
    from mesh_tpu_torch.accel import rope_kernel as rk
    from mesh_tpu_torch.accel.build import build_bvh, clear_index_cache
    from mesh_tpu_torch.batch import batch_step, visibility_step
    from mesh_tpu_torch.geometry.cross_product import cross3
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import culled as auto
    from mesh_tpu_torch.query import culled_kernel as qk
    from mesh_tpu_torch.query import normal_weighted as nw
    from mesh_tpu_torch.query import ray_kernel as ray
    from mesh_tpu_torch.query import tri_tri_kernel as tk
    from mesh_tpu_torch.query.autotune import stream_tile_params
    from mesh_tpu_torch.query.closest_point import closest_faces_and_points_t
    from mesh_tpu_torch.query.visibility import visibility_rays

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

    # -- inputs of the large-mesh drives (phases 5 and 6) --------------------
    t0 = time.perf_counter()
    model_l, betas_l, pose_l, verts_l, queries_l = large_batch_inputs(dev)
    f_l = model_l.faces
    nondegen_l = ck.mesh_is_nondegenerate(verts_l.cpu().numpy(),
                                          f_l.cpu().numpy())
    variant_l = ("fast", not nondegen_l)
    v_s, f_s, p_s = scan_inputs()
    n_buffers = stream_tile_params()[2]
    log("large batch %s (%d faces) nondegenerate: %s -> culled_faces[%s, "
        "tail=%s]; scan mesh %d faces, %d queries; inputs %.1f s"
        % (tuple(verts_l.shape), f_l.shape[0], nondegen_l, *variant_l,
           f_s.shape[0], SCAN_QUERIES, time.perf_counter() - t0))

    # -- inputs of the visibility and registration drives (phases 7 and 8) --
    cams = torch.tensor(VIS_CAMERAS, dtype=torch.float32, device=dev)
    betas_v, pose_v = betas[:VIS_BATCH], pose[:VIS_BATCH]
    verts_v = verts[:VIS_BATCH]
    reg_pts, reg_nrm = registration_inputs(verts[0], f,
                                           np.random.RandomState(1))
    nondegen_r = ck.mesh_is_nondegenerate(posed[0], f_np)
    log("visibility: %d bodies x %d cameras; registration: body 0, %d "
        "queries, nondegenerate %s -> normal_weighted_faces[tail=%s]"
        % (VIS_BATCH, len(VIS_CAMERAS), REG_QUERIES, nondegen_r,
           not nondegen_r))

    # -- inputs of the contact and self-intersection drives (9 and 10) ------
    body_v, body_f, hand_v, hand_f = contact_inputs(dev)
    contact_tile = tk.ALGORITHMS[int(
        ck.mesh_is_nondegenerate(body_v, body_f)
        and ck.mesh_is_nondegenerate(hand_v, hand_f))]
    # float32, as the facade hands them to the kernels (hand_v is float64
    # after the offset, as in the example)
    hand_tri = torch.as_tensor(hand_v.astype(np.float32), device=dev)[
        torch.as_tensor(hand_f.astype(np.int64), device=dev)]
    body_tri = torch.as_tensor(body_v, device=dev)[
        torch.as_tensor(body_f.astype(np.int64), device=dev)]
    self_bodies = {
        "smpl_body0": (posed[0], f_np, model.v_template.cpu().numpy()),
        "large_body0": (verts_l[0].cpu().numpy(), f_l.cpu().numpy(),
                        model_l.v_template.cpu().numpy())}
    self_tiles = {k: tk.ALGORITHMS[int(ck.mesh_is_nondegenerate(v, f_))]
                  for k, (v, f_, _) in self_bodies.items()}
    log("contact: hand %d faces vs body %d faces -> tri_tri_any_hit[%s]; "
        "self-intersection tiles %s" % (hand_f.shape[0], body_f.shape[0],
                                        contact_tile, self_tiles))

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

    # culled_faces at phase 5's shapes (every query tile of all 64 bodies)
    culled_runs = []
    for variant, tail in VARIANTS:
        ops_l = qk.culled_operands(verts_l, f_l, queries_l, variant)
        culled_runs.append(compare_culled(qk, ops_l, variant, tail,
                                          timing=(variant, tail) == variant_l))
        del ops_l
    # both rope_faces entries at phase 6's shapes (every query tile)
    ops_s = rk.rope_operands(v_s, f_s, p_s, device=dev)
    rope_stream, (sd, si, sl) = compare_rope(rk, ops_s, n_buffers)
    rope_resident, (rd, ri, rl) = compare_rope(rk, ops_s, None)
    check(torch.equal(si, ri) and torch.equal(sd, rd)
          and bool((sl >= rl).all()), "rope_faces: the streamed entry is not "
          "bit-identical to the resident one, or tests fewer leaves")
    log("  rope_faces: streamed and resident entries bit-identical; %d vs "
        "%d leaves tested" % (int(sl.sum()), int(rl.sum())))
    # ray_any_hit at phase 7's shapes: every ray of every body and camera
    origins_v, dirs_v = visibility_rays(verts_v, cams, VIS_MIN_DIST)
    any_hit_run = compare_any_hit(
        ray, origins_v, dirs_v.reshape(origins_v.shape).contiguous(),
        ray.ray_planes(verts_v[..., f.long(), :]))
    del origins_v, dirs_v
    # alongnormal_faces and normal_weighted_faces at phase 8's shapes
    along_run = compare_alongnormal(ray, reg_pts[None], reg_nrm[None],
                                    verts[:1][..., f.long(), :])
    nw_ops = nw.normal_weighted_operands(verts[:1], f, reg_pts[None],
                                         reg_nrm[None])
    nw_runs = [compare_normal_weighted(nw, nw_ops, tail, timing=True)
               for tail in (False, True)]
    del nw_ops
    n2 = rng.randn(1, q2.shape[0], 3)
    n2t = torch.as_tensor(n2 / np.linalg.norm(n2, axis=-1, keepdims=True),
                          dtype=torch.float32, device=dev)
    planted = compare_normal_weighted(
        nw, nw.normal_weighted_operands(v2t, f2t, q2t, n2t), True,
        timing=False)
    planted["mesh"] = "planted degenerate"
    nw_runs.append(planted)
    # tri_tri_any_hit at phase 9's shapes in both tiles, and the segment
    # tile with the planted mesh's faces as the queries against body 0
    tri_runs = {alg: compare_tri_tri(tk, *tk.tri_tri_planes(
        hand_tri, body_tri, alg), alg, "hand vs body", timing=True)
        for alg in tk.ALGORITHMS}
    tri_runs["segment_planted"] = compare_tri_tri(
        tk, *tk.segment_planes(v2t[0][f2t.long()], verts[0][f.long()]),
        "segment", "planted mesh vs body 0", timing=False)
    # self_intersect on every face of phase 3's and phase 5's body 0, both
    # tiles
    self_runs = {}
    for key, (v_np, f_np_, _) in self_bodies.items():
        tri_b = torch.as_tensor(v_np, device=dev)[
            torch.as_tensor(f_np_.astype(np.int64), device=dev)]
        ids_b = torch.as_tensor(f_np_.astype(np.int32), device=dev)
        for alg in tk.ALGORITHMS:
            self_runs["%s[%s]" % (key, alg)] = compare_self(
                tk, tri_b, ids_b, alg, key)
        del tri_b, ids_b

    # -- 3. main path at full width ------------------------------------------
    log("== main path: %d bodies x %d queries, %d faces each"
        % (BATCH, QUERIES_PER_MESH, f.shape[0]))
    reset_launches()

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
    launches = {"main_path": read_launches()}
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
    reset_launches()
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
    launches["facade"] = read_launches()
    log("facade ok")

    # -- 5. large batch: batch_step through the culled kernel --------------
    log("== large batch: %d bodies x %d queries, %d faces each"
        % (LARGE_BATCH, LARGE_QUERIES, f_l.shape[0]))
    reset_launches()
    auto.STRATEGY.clear()

    def step_l():
        v, _ = lbs(model_l, betas_l, pose_l, device=dev)
        normals, res = batch_step(v, f_l, queries_l,
                                  assume_nondegenerate=nondegen_l,
                                  tile_variant=variant_l[0])
        checksum = (normals.sum() + res["point"].sum() + res["sqdist"].sum()
                    + res["face"].sum().to(torch.float32))
        return normals, res, checksum

    normals_l, res_l, checksum_l = step_l()         # warm-up
    float(checksum_l)
    times_l = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        normals_l, res_l, checksum_l = step_l()
        end.record()
        float(checksum_l)
        times_l.append(start.elapsed_time(end))
    step_l_ms = statistics.median(times_l)
    launches["large_batch"] = read_launches()
    check(dict(auto.STRATEGY) == {"culled": REPS + 1},
          "large batch routes %s, not the culled kernel" % auto.STRATEGY)
    check(tuple(res_l["face"].shape) == (LARGE_BATCH, LARGE_QUERIES)
          and res_l["face"].dtype == torch.int32
          and tuple(res_l["point"].shape) == (LARGE_BATCH, LARGE_QUERIES, 3)
          and tuple(normals_l.shape) == tuple(verts_l.shape),
          "large batch shapes/dtypes")
    for name, t in (("normals", normals_l), ("point", res_l["point"]),
                    ("sqdist", res_l["sqdist"])):
        check(bool(torch.isfinite(t).all()), "large batch %s not finite"
              % name)
    check(bool(((res_l["face"] >= 0) & (res_l["face"] < f_l.shape[0])).all()),
          "large batch face index out of range")
    v_step_l, _ = lbs(model_l, betas_l, pose_l, device=dev)
    brute_l = ck.closest_point_kernel(v_step_l, f_l, queries_l,
                                      assume_nondegenerate=nondegen_l)
    large_vs_brute = check_against_brute(
        "large batch", v_step_l, f_l, queries_l, res_l["face"],
        res_l["sqdist"], brute_l)
    del brute_l
    n_queries_l = LARGE_BATCH * LARGE_QUERIES
    log("large batch step: median %.3f ms over %d reps (min %.3f, max %.3f), "
        "%.0f queries/s, checksum %.6g, route culled, on %s"
        % (step_l_ms, REPS, min(times_l), max(times_l),
           n_queries_l / (step_l_ms / 1e3), float(checksum_l), smi))

    # -- 6. scan: the Mesh facade through the BVH rope kernels --------------
    log("== scan: Mesh on a %d-face sphere, %d queries"
        % (f_s.shape[0], SCAN_QUERIES))
    clear_index_cache()
    res_s, stats_s, launches["scan"], scan_calls = drive_scan(
        "scan", v_s, f_s, p_s, dev)
    budget = os.environ.get("MESH_TPU_BVH_STREAM_VMEM_MB")
    os.environ["MESH_TPU_BVH_STREAM_VMEM_MB"] = "32"
    try:
        clear_index_cache()
        res_r, stats_r, launches["scan_resident"], resident_calls = \
            drive_scan("scan_resident", v_s, f_s, p_s, dev)
    finally:
        if budget is None:
            del os.environ["MESH_TPU_BVH_STREAM_VMEM_MB"]
        else:
            os.environ["MESH_TPU_BVH_STREAM_VMEM_MB"] = budget
    check(stats_s["backend"] == "rope_stream"
          and stats_r["backend"] == "rope_resident",
          "scan backends %s / %s" % (stats_s["backend"], stats_r["backend"]))
    check(all(np.array_equal(res_s[k], res_r[k])
              for k in ("face", "part", "point", "sqdist")),
          "scan and scan_resident results are not bit-identical")
    check(stats_s["pair_tests"] >= stats_r["pair_tests"],
          "streamed pair tests below the resident walk's")
    log("  scan and scan_resident bit-identical (faces, parts, points, "
        "sqdist); pair tests %d streamed >= %d resident"
        % (stats_s["pair_tests"], stats_r["pair_tests"]))
    v_s_t = torch.as_tensor(v_s, device=dev)
    f_s_dev = torch.as_tensor(f_s, device=dev)
    p_s_t = torch.as_tensor(p_s, device=dev)
    brute_s = ck.closest_point_kernel(
        v_s_t[None], f_s_dev, p_s_t[None],
        assume_nondegenerate=ck.mesh_is_nondegenerate(v_s, f_s))
    scan_vs_brute = check_against_brute(
        "scan", v_s_t[None], f_s_dev, p_s_t[None],
        torch.as_tensor(res_s["face"], device=dev)[None],
        torch.as_tensor(res_s["sqdist"], device=dev)[None], brute_s)
    del brute_s

    # -- 7. visibility: visibility_step on the batch, then the facade ------
    log("== visibility: %d bodies x %d cameras x %d vertices, %d faces each"
        % (VIS_BATCH, len(VIS_CAMERAS), verts.shape[1], f.shape[0]))
    reset_launches()

    def step_v():
        v, _ = lbs(model, betas_v, pose_v, device=dev)
        vis, ndc = visibility_step(v, f, cams, min_dist=VIS_MIN_DIST)
        return vis, ndc, vis.sum().to(torch.float32) + ndc.sum()

    vis_v, ndc_v, checksum_v = step_v()             # warm-up
    float(checksum_v)
    times_v = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vis_v, ndc_v, checksum_v = step_v()
        end.record()
        float(checksum_v)
        times_v.append(start.elapsed_time(end))
    step_v_ms = statistics.median(times_v)
    rest_vis, rest_ndc = visibility_step(model.v_template[None], f, cams,
                                         min_dist=VIS_MIN_DIST)
    m_v = Mesh(posed[0], f_np, device=dev)
    omni = m_v.vertex_visibility(VIS_CAMERAS[0])
    sensed = m_v.vertex_visibility(_Camera(VIS_CAMERAS[0], FACADE_SENSOR))
    sub = m_v.visible_mesh(VIS_CAMERAS[0])
    launches["visibility"] = read_launches()
    n_v = verts.shape[1]
    check(tuple(vis_v.shape) == (VIS_BATCH, len(VIS_CAMERAS), n_v)
          and vis_v.dtype == torch.bool and ndc_v.shape == vis_v.shape
          and ndc_v.dtype == torch.float32, "visibility shapes/dtypes")
    check(bool(torch.isfinite(ndc_v).all()), "visibility n.dir not finite")
    share = vis_v.float().mean(dim=(0, 2)).tolist()
    rest_back = rest_ndc < BACKFACING
    rest_back_visible = int((rest_back & rest_vis).sum())
    check(rest_back_visible == 0, "visibility: %d back-facing vertices of "
          "the closed rest template are visible" % rest_back_visible)
    backfacing = ndc_v < BACKFACING
    backfacing_visible = int((backfacing & vis_v).sum())
    tri0 = verts_v[0][f.long()]
    fn0 = cross3(tri0[:, 1] - tri0[:, 0], tri0[:, 2] - tri0[:, 0])
    inward = int(((fn0 * (tri0.mean(dim=1) - verts_v[0].mean(dim=0))).sum(-1)
                  < 0).sum())
    origins0, dirs0 = visibility_rays(verts_v[:1], cams, VIS_MIN_DIST)
    blocked64, border64 = any_hit64(origins0[0], dirs0[0].reshape(-1, 3),
                                    tri0)
    differ64 = vis_v[0].reshape(-1) == blocked64
    check(not bool((differ64 & ~border64).any()),
          "visibility: %d of body 0's flags differ from the float64 "
          "recompute away from the boundary"
          % int((differ64 & ~border64).sum()))
    log("  visible share per camera %s; body 0 against float64: %d of %d "
        "flags differ, all on borderline rays; rest template: 0 of %d "
        "back-facing (n.dir < %g) vertices visible; posed batch: %d of %d "
        "back-facing vertices visible (body 0 has %d of %d faces turned "
        "towards its centroid: the posed surface folds)"
        % (["%.4f" % x for x in share], int(differ64.sum()),
           differ64.numel(), int(rest_back.sum()), BACKFACING,
           backfacing_visible, int(backfacing.sum()), inward, f.shape[0]))
    check(omni.dtype == np.uint32 and omni.shape == (n_v,),
          "facade visibility dtype/shape %s %s" % (omni.dtype, omni.shape))
    check(np.array_equal(omni.astype(bool), vis_v[0, 0].cpu().numpy()),
          "facade visibility differs from visibility_step on body 0")
    check(0 < int(sensed.sum()) < int(omni.sum())
          and not (sensed.astype(bool) & ~omni.astype(bool)).any(),
          "sensor visibility is not a proper subset of the omnidirectional")
    check(sub.v.shape[0] == int(omni.sum()) and sub.f.shape[0] > 0
          and int(sub.f.max()) < sub.v.shape[0], "visible_mesh")
    log("visibility step: median %.3f ms over %d reps (min %.3f, max %.3f), "
        "%.0f rays/s, on %s; facade: %d visible from camera 0, %d within the "
        "sensor, visible_mesh %d vertices / %d faces"
        % (step_v_ms, REPS, min(times_v), max(times_v),
           vis_v.numel() / (step_v_ms / 1e3), smi, int(omni.sum()),
           int(sensed.sum()), sub.v.shape[0], sub.f.shape[0]))

    # -- 8. registration: the normal-weighted and along-normal trees --------
    log("== registration: Mesh on body 0, %d scan points with normals"
        % REG_QUERIES)
    pts_np, nrm_np = reg_pts.cpu().numpy(), reg_nrm.cpu().numpy()
    m_r = Mesh(posed[0], f_np, device=dev)
    reset_launches()
    reg_calls = {}

    def timed_calls(name, first):
        """The first call (tree made inside it), then 5 warm calls."""
        t0 = time.perf_counter()
        query, out = first()
        reg_calls[name + "_first_call_s"] = time.perf_counter() - t0
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = query(pts_np, nrm_np)
            times.append((time.perf_counter() - t0) * 1e3)
            check(all(np.array_equal(x, y) for x, y in zip(out, again)),
                  "%s: repeated calls disagree" % name)
        reg_calls[name + "_warm_call_ms"] = statistics.median(times)
        reg_calls[name + "_warm_call_ms_min"] = min(times)
        reg_calls[name + "_warm_call_ms_max"] = max(times)
        return out

    def first_nw():
        tree = m_r.compute_aabb_normals_tree()
        return tree.nearest, tree.nearest(pts_np, nrm_np)

    def first_along():
        tree = m_r.compute_aabb_tree()
        return tree.nearest_alongnormal, tree.nearest_alongnormal(pts_np,
                                                                  nrm_np)

    nw_face, nw_point = timed_calls("normal_weighted", first_nw)
    an_d, an_f, an_p = timed_calls("alongnormal", first_along)
    launches["registration"] = read_launches()
    check(nw_face.dtype == np.uint32 and nw_face.shape == (REG_QUERIES, 1)
          and nw_point.dtype == np.float64
          and nw_point.shape == (REG_QUERIES, 3)
          and an_d.dtype == np.float64 and an_d.shape == (REG_QUERIES,)
          and an_f.dtype == np.uint32 and an_f.shape == (REG_QUERIES,)
          and an_p.dtype == np.float64 and an_p.shape == (REG_QUERIES, 3),
          "registration dtypes/shapes")
    check(bool(np.isfinite(nw_point).all()), "normal-weighted points")
    mine, least = blended_min64(
        verts[0], f, reg_pts[:REG_CHECK], reg_nrm[:REG_CHECK],
        torch.as_tensor(nw_face[:REG_CHECK, 0].astype(np.int64), device=dev))
    nw_gap = float((mine - least).max())
    check(nw_gap <= 1e-5, "normal-weighted winners' blended cost %.3g above "
          "the float64 dense minimum" % nw_gap)
    hit64, least64 = alongnormal_hits64(verts[0], f, reg_pts, reg_nrm)
    finite = torch.as_tensor(an_d < 1e100, device=dev)
    lost = int((hit64 & ~finite).sum())
    check(lost == 0, "along-normal: %d queries hit in float64 come back as "
          "misses" % lost)
    check(an_d[-1] == 1e100 and an_f[-1] == 0 and not an_p[-1].any(),
          "along-normal: the planted miss is not reported as 1e100")
    both = finite & hit64
    an_gap = float((torch.as_tensor(an_d, device=dev)[both]
                    - least64[both]).abs().max())
    registration = dict(
        reg_calls, nw_cost_gap64=nw_gap, along_hits=int(finite.sum()),
        along_hits64=int(hit64.sum()), along_dist_gap64=an_gap,
        nondegenerate=nondegen_r)
    log("  normal-weighted: winners within %.3g of the float64 dense "
        "blended minimum (first %d queries); along-normal: %d of %d hit "
        "(float64 dense: %d), none lost, distance within %.3g of the "
        "float64 nearest hit; planted miss -> 1e100"
        % (nw_gap, REG_CHECK, int(finite.sum()), REG_QUERIES,
           int(hit64.sum()), an_gap))
    log("registration calls (host clock, ms): %s" % ", ".join(
        "%s %.3f" % (k, v * (1e3 if k.endswith("_s") else 1.0))
        for k, v in reg_calls.items()))

    # -- 9. contact: examples/hand_body_contact.py through the port ---------
    log("== contact: hand %d faces vs body %d faces" % (hand_f.shape[0],
                                                       body_f.shape[0]))
    from mesh_tpu_torch.query import closest_kernel as ck_mod

    reset_launches()
    contact = {"tile": contact_tile}

    def host_ms(fn, first_key, warm_key):
        """The first call (cold), then the median of 5 warm calls, on the
        host clock."""
        t0 = time.perf_counter()
        out = fn()
        contact[first_key] = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = fn()
            times.append((time.perf_counter() - t0) * 1e3)
            check(all(np.array_equal(x, y) for x, y in zip(out, again)),
                  "contact: repeated calls disagree")
        contact[warm_key] = statistics.median(times)
        return out

    body = Mesh(body_v, body_f, device=dev)
    hand = Mesh(hand_v, hand_f, device=dev)
    hit_faces, signed = host_ms(lambda: contact_step(body, hand, dev),
                                "step_first_ms", "step_warm_ms")
    ck_mod._NONDEGEN_CACHE.clear()
    tree_c = Mesh(body_v, body_f, device=dev).compute_aabb_tree()
    (hit_again,) = host_ms(lambda: (tree_c.intersections_indices(
        hand_v, hand_f),), "intersections_first_ms", "intersections_warm_ms")
    check(np.array_equal(hit_again, hit_faces),
          "contact: intersections_indices differs between trees")
    safe = os.environ.get("MESH_TPU_SAFE_TILES")
    os.environ["MESH_TPU_SAFE_TILES"] = "1"
    try:
        hit_safe = tree_c.intersections_indices(hand_v, hand_f)
    finally:
        if safe is None:
            del os.environ["MESH_TPU_SAFE_TILES"]
        else:
            os.environ["MESH_TPU_SAFE_TILES"] = safe
    launches["contact"] = read_launches()
    n_hand = hand_f.shape[0]
    check(hit_faces.dtype == np.int64 and 0 < hit_faces.size < n_hand,
          "contact: %d of %d hand faces intersect: want some, not all"
          % (hit_faces.size, n_hand))
    check(np.array_equal(hit_safe, hit_faces), "contact: the segment tile "
          "(MESH_TPU_SAFE_TILES=1) finds %d faces, the %s tile %d"
          % (hit_safe.size, contact_tile, hit_faces.size))
    check(signed.shape == (hand_v.shape[0],) and bool(
        np.isfinite(signed).all()), "contact: signed gaps")
    masks, decided = {}, {}
    for name, idx in ((contact_tile, hit_faces), ("segment", hit_safe)):
        mask = torch.zeros(n_hand, dtype=torch.bool)
        mask[torch.as_tensor(idx)] = True
        masks[name] = mask
        decided[name] = decide64(name, hand_tri, body_tri)
    differ_c, border_c = check_against64("contact", masks[contact_tile],
                                         decided[contact_tile])
    check_against64("contact, segment tile", masks["segment"],
                    decided["segment"])
    in_contact = np.abs(signed) < CONTACT_GAP
    contact.update(
        intersecting=int(hit_faces.size), hand_faces=n_hand,
        intersecting64=int(decided[contact_tile][0].sum()),
        differ64=differ_c,
        borderline64=border_c, contact_vertices=int(in_contact.sum()),
        deepest_mm=float(-1000.0 * signed.min()) if (signed < 0).any()
        else 0.0,
        kernel_ms={alg: tri_runs[alg]["ms"] for alg in tk.ALGORITHMS})
    log("  gate -> %s tile; %d of %d hand faces intersect (segment tile "
        "the same; float64: %d, %d differ, %d borderline); %d contact "
        "vertices (< %g m), deepest penetration %.1f mm" % (
            contact_tile, hit_faces.size, n_hand, contact["intersecting64"],
            differ_c, border_c, contact["contact_vertices"], CONTACT_GAP,
            contact["deepest_mm"]))
    log("contact calls (host clock, ms): step first %.3f, warm %.3f; "
        "intersections_indices first %.3f, warm %.3f; kernel alone (phase "
        "2, CUDA events) %s, on %s" % (
            contact["step_first_ms"], contact["step_warm_ms"],
            contact["intersections_first_ms"],
            contact["intersections_warm_ms"],
            ", ".join("%s %.3f" % kv for kv in contact["kernel_ms"].items()),
            smi))

    # -- 10. self-intersection of the posed bodies ----------------------------
    log("== self_intersect: phase 3's and phase 5's posed body 0")
    from mesh_tpu_torch.query.ray import self_intersection_count

    reset_launches()
    self_int = {}
    for key, (v_np, f_np_, rest_np) in self_bodies.items():
        rec = {"faces": int(f_np_.shape[0]), "tile": self_tiles[key]}
        ck_mod._NONDEGEN_CACHE.clear()
        t0 = time.perf_counter()
        count = int(self_intersection_count(v_np, f_np_, device=dev))
        rec["first_ms"] = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = int(self_intersection_count(v_np, f_np_, device=dev))
            times.append((time.perf_counter() - t0) * 1e3)
            check(again == count, "%s: repeated counts disagree" % key)
        rec["warm_ms"] = statistics.median(times)
        rec["count"] = count
        rec["rest_count"] = int(self_intersection_count(rest_np, f_np_,
                                                        device=dev))
        vt_b = torch.as_tensor(v_np, device=dev)
        ft_b = torch.as_tensor(f_np_.astype(np.int64), device=dev)
        per_tile = {alg: tk.self_intersection_counts_kernel(vt_b, ft_b, alg)
                    for alg in tk.ALGORITHMS}
        tri_b = vt_b[ft_b]
        ids_b = ft_b.to(torch.int32).contiguous()
        rec["kernel_ms"] = {}
        for alg in tk.ALGORITHMS:
            qp_b, fp_b = tk.self_planes(tri_b, alg)
            rec["kernel_ms"][alg] = cuda_ms(lambda: tk.self_intersect_counts(
                qp_b, fp_b, ids_b, alg), reps=3)
            del qp_b, fp_b
        involved = {alg: c > 0 for alg, c in per_tile.items()}
        check(rec["rest_count"] == 0, "%s: the rest template (a closed UV "
              "sphere) has %d self-intersecting faces" % (key,
                                                          rec["rest_count"]))
        check(count > 0, "%s: the posed body does not self-intersect" % key)
        check(count == int(involved[self_tiles[key]].sum()),
              "%s: the facade's count is not its tile's" % key)
        tile_differ = (involved["moller"] != involved["segment"]).nonzero()[
            :, 0]
        rec["tile_counts"] = {alg: int(x.sum()) for alg, x in
                              involved.items()}
        rec["tiles_differ"] = int(tile_differ.numel())
        # each tile against its own float64 predicate, on the faces the
        # tiles disagree on and on 256 involved and 256 free faces
        rng_s = np.random.RandomState(2)
        inv_idx = involved[self_tiles[key]].nonzero()[:, 0].cpu().numpy()
        free_idx = (~involved[self_tiles[key]]).nonzero()[:, 0].cpu().numpy()
        half = SELF_CHECK_FACES // 2
        pick = torch.as_tensor(np.concatenate([
            rng_s.choice(inv_idx, min(half, inv_idx.size), replace=False),
            rng_s.choice(free_idx, min(half, free_idx.size), replace=False)]),
            device=dev)
        rec["checked64"] = int(pick.numel())
        rec["tiles_differ64"] = 0
        for label, faces in (("tiles differ", tile_differ), ("sample", pick)):
            if not faces.numel():
                continue
            dec = {alg: decide64(alg, tri_b[faces], tri_b, ids_b[faces], ids_b,
                                 faces) for alg in tk.ALGORITHMS}
            for alg in tk.ALGORITHMS:
                got = check_against64("%s, %s tile, %s" % (key, alg, label),
                                      involved[alg][faces], dec[alg])
                if label == "sample" and alg == self_tiles[key]:
                    rec["differ64"], rec["borderline64"] = got
            if label == "tiles differ":
                # the float64 predicates themselves disagree on these
                rec["tiles_differ64"] = int((dec["moller"][0]
                                             != dec["segment"][0]).sum())
        self_int[key] = rec
        log("  %s (%d faces): %d self-intersecting faces (%s tile; moller "
            "%d, segment %d, %d differ, the float64 predicates on %d of "
            "them), rest template 0; "
            "%d faces vs float64: %d differ, %d borderline; first call %.3f "
            "ms, warm %.3f ms (host clock), kernel alone %s ms, on %s" % (
                key, rec["faces"], count, self_tiles[key],
                rec["tile_counts"]["moller"], rec["tile_counts"]["segment"],
                rec["tiles_differ"], rec["tiles_differ64"], rec["checked64"],
                rec["differ64"],
                rec["borderline64"], rec["first_ms"], rec["warm_ms"],
                ", ".join("%s %.3f" % kv for kv in rec["kernel_ms"].items()),
                smi))
        del vt_b, ft_b, tri_b, ids_b, per_tile
    launches["self_intersect"] = read_launches()

    for name, paths in KERNEL_PATHS.items():
        for path, counts in launches.items():
            if path in paths:
                check(counts[name] > 0, "kernel %s never launched on the %s "
                      "path" % (name, path))
            else:
                check(counts[name] == 0, "kernel %s launched %d times on the "
                      "%s path, which does not use it"
                      % (name, counts[name], path))
    log("launches per path: %s" % launches)

    # -- crossover evidence ---------------------------------------------------
    log("== crossover: every route at both drives' shapes")
    crossover_rows = crossover(dev, (verts_l, f_l, queries_l, nondegen_l),
                               (v_s, f_s, p_s))

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
    stages_l = {}
    stages_l["lbs"] = cuda_ms(lambda: lbs(model_l, betas_l, pose_l,
                                          device=dev), 3)
    stages_l["vert_normals"] = cuda_ms(lambda: batch_step(verts_l, f_l, None),
                                       3)
    stages_l["culled_prologue"] = cuda_ms(lambda: qk.culled_operands(
        verts_l, f_l, queries_l, variant_l[0]), 3)
    ops_l = qk.culled_operands(verts_l, f_l, queries_l, variant_l[0])
    stages_l["culled_kernel"] = cuda_ms(lambda: qk.argmin_culled(
        ops_l, *variant_l), 3)
    best_l, _ = qk.argmin_culled(ops_l, *variant_l)
    stages_l["culled_epilogue"] = cuda_ms(
        lambda: qk.culled_epilogue(ops_l, best_l), 3)
    del ops_l
    log("large batch stage breakdown (ms, separate runs): " + ", ".join(
        "%s %.3f" % kv for kv in stages_l.items()))
    builds = []
    for _ in range(3):
        t0 = time.perf_counter()
        build_bvh(v_s, f_s, leaf_size=ops_s["tile_f"])
        builds.append((time.perf_counter() - t0) * 1e3)
    stages_s = {"host_bvh_build": statistics.median(builds)}
    stages_s["rope_prologue"] = cuda_ms(lambda: rk.rope_operands(
        v_s, f_s, p_s, device=dev), 3)
    stages_s["rope_stream_kernel"] = rope_stream["ms"]
    stages_s["rope_resident_kernel"] = rope_resident["ms"]
    stages_s["rope_epilogue"] = cuda_ms(
        lambda: rk._rope_epilogue(ops_s, si, sl), 3)
    log("scan stage breakdown (ms; build on the host clock, median of 3; "
        "the rest separate CUDA-event runs): " + ", ".join(
            "%s %.3f" % kv for kv in stages_s.items()))
    stages_v = {
        "lbs": cuda_ms(lambda: lbs(model, betas_v, pose_v, device=dev), 3),
        "vert_normals": cuda_ms(lambda: batch_step(verts_v, f, None), 3),
        "rays_and_planes": cuda_ms(lambda: (
            visibility_rays(verts_v, cams, VIS_MIN_DIST),
            ray.ray_planes(verts_v[..., f.long(), :])), 3),
        "ray_any_hit_kernel": any_hit_run["ms"]}
    log("visibility stage breakdown (ms, separate runs): " + ", ".join(
        "%s %.3f" % kv for kv in stages_v.items()))

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
    main_l = next(r for r in culled_runs
                  if (r["variant"], r["degenerate_tail"]) == variant_l)
    kernels.append(
        {"name": "culled_faces", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/culled_faces.cu",
         "replaces": "mesh_tpu/query/pallas_culled.py:288",
         "launches": launches["large_batch"]["culled_faces"],
         "launches_by_path": {p: launches[p]["culled_faces"]
                              for p in launches},
         "max_abs_err": max(r["max_abs_err"] for r in culled_runs),
         "ms": main_l["ms"], "plain_ms": main_l["plain_ms"],
         "bound_ms": main_l["bound_ms"], "bound_by": main_l["bound_by"],
         "library_ms": None,
         "variant": "%s, tail=%s" % variant_l,
         "variants": culled_runs})
    for name, run, path, replaces in (
            ("rope_faces_stream", rope_stream, "scan",
             "mesh_tpu/accel/pallas_stream.py:206"),
            ("rope_faces_resident", rope_resident, "scan_resident",
             "mesh_tpu/accel/pallas_bvh.py:214")):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "mesh_tpu_torch/csrc/rope_faces.cu",
             "replaces": replaces,
             "launches": launches[path][name],
             "launches_by_path": {p: launches[p][name] for p in launches},
             "max_abs_err": run["max_abs_err"],
             "ms": run["ms"], "plain_ms": run["plain_ms"],
             "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
             "library_ms": None, "detail": run})
    main_nw = nw_runs[0 if nondegen_r else 1]
    for name, run, path, source, replaces in (
            ("ray_any_hit", any_hit_run, "visibility", "ray_any_hit.cu",
             "mesh_tpu/query/pallas_ray.py:178"),
            ("alongnormal_faces", along_run, "registration",
             "alongnormal_faces.cu", "mesh_tpu/query/pallas_ray.py:231"),
            ("normal_weighted_faces", main_nw, "registration",
             "normal_weighted_faces.cu",
             "mesh_tpu/query/pallas_normal_weighted.py:78")):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "mesh_tpu_torch/csrc/" + source, "replaces": replaces,
             "launches": launches[path][name],
             "launches_by_path": {p: launches[p][name] for p in launches},
             "max_abs_err": (max(r["max_abs_err"] for r in nw_runs)
                             if run is main_nw else run["max_abs_err"]),
             "ms": run["ms"], "plain_ms": run["plain_ms"],
             "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
             "library_ms": None,
             "detail": nw_runs if run is main_nw else run})
    for name, runs, path, source, replaces, main_run in (
            ("tri_tri_any_hit", tri_runs, "contact", "tri_tri_any_hit.cu",
             "mesh_tpu/query/pallas_ray.py:754", tri_runs[contact_tile]),
            ("self_intersect", self_runs, "self_intersect",
             "self_intersect.cu", "mesh_tpu/query/pallas_ray.py:697",
             self_runs["smpl_body0[%s]" % self_tiles["smpl_body0"]])):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "mesh_tpu_torch/csrc/" + source, "replaces": replaces,
             "launches": launches[path][name],
             "launches_by_path": {p: launches[p][name] for p in launches},
             "launches_by_tile": {alg: launches[path]["%s[%s]" % (name, alg)]
                                  for alg in tk.ALGORITHMS},
             "max_abs_err": 0.0, "ms": main_run["ms"],
             "plain_ms": main_run["plain_ms"],
             "bound_ms": main_run["bound_ms"],
             "bound_by": main_run["bound_by"], "library_ms": None,
             "tile": main_run["tile"], "detail": runs})
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(smi, flush=True)
    print(json.dumps({
        "kernels": kernels, "main_path_step_ms": step_ms,
        "stages_ms": stages, "build_s": build_s,
        "large_batch": {"step_ms": step_l_ms, "step_ms_min": min(times_l),
                        "step_ms_max": max(times_l), "stages_ms": stages_l,
                        "vs_brute": large_vs_brute},
        "scan": {"stream": dict(stats_s, **scan_calls),
                 "resident": dict(stats_r, **resident_calls),
                 "stages_ms": stages_s, "vs_brute": scan_vs_brute},
        "crossover_ms": crossover_rows,
        "visibility": {"step_ms": step_v_ms, "step_ms_min": min(times_v),
                       "step_ms_max": max(times_v),
                       "visible_share_per_camera": share,
                       "backfacing_visible": backfacing_visible,
                       "rest_backfacing_visible": rest_back_visible,
                       "body0_flags_differ64": int(differ64.sum()),
                       "stages_ms": stages_v},
        "registration": registration, "contact": contact,
        "self_intersect": self_int}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
