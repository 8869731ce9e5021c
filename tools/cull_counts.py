#!/usr/bin/env python3
"""What the chunk culls of closest_faces (row 1), normal_weighted_faces
(row 7), alongnormal_faces (row 9) and tri_tri_any_hit (row 11) test,
counted on the CPU by their plain versions
(``closest_kernel.argmin_faces_culled_plain``,
``normal_weighted.argmin_normal_weighted_culled_plain``,
``ray_kernel.argmin_alongnormal_culled_plain``,
``tri_tri_kernel.tri_tri_any_hit_culled_plain``).

    python3 tools/cull_counts.py [--bodies 4] [--variant fast] [--tail]
    python3 tools/cull_counts.py --nw [--queries 65536] [--splits 1,32]
                                  [--eps 0.1]
    python3 tools/cull_counts.py --along [--queries 65536] [--splits 1,32]
    python3 tools/cull_counts.py --tri [--splits 1,4,16,32,64]

Row 1 (the default): the first bodies of chip_smoke.py's main path, its
bodies, poses and queries (seed 0, 1024 N(0, 0.4) queries a body), made
on the CPU.  Prints, as one JSON line each, the shares of the shipped
design (the box bound of ``cull_records``) and of a bounding-sphere bound
over the same corners, with the same rounding terms and seeds: chunks
folded by the mean warp and by the heaviest, chunks staged, and pairs each
lane needs.

Row 7 (``--nw``): chip_smoke.py phase 8's registration inputs on posed
body 0 (its scan points with noisy normals, the planted miss last; the
last ``--queries`` of them), eps ``--eps`` (the drive's 0.1; at 0 the
penalty is gone and only the distance term keeps chunks), the tail as the
drive picks it.
Prints one JSON line per split: the same shares, the heaviest warp's
chunks per split, and the shares without the warp that holds the planted
miss.

Row 9 (``--along``): the same phase 8 inputs (the last ``--queries`` of
them) against alongnormal_faces' operands (row 8's Morton-sorted faces and
records).  Prints one JSON line per split with the shipped seed (the faces
of the ray_kernel.SEED_CHUNKS nearest chunks) and query order (Morton
codes in the mesh's box), then at split 1 without the seed and with the
queries ordered in their own box (``closest_kernel.query_order``, rows 1
and 7's), then with seeds over each count of ``--seed-chunks`` chunks:
the shares of lanes whose seed is their best cost, of chunks folded by
the mean warp and by the heaviest, of chunks staged and of pairs each
lane needs, and per chunk
test the shares that find a miss and that fall back to the faces'
normals, with the bounds in milliseconds at 67e12 operations a second
(chip_smoke.py's operation counts).

Row 11 (``--tri``): chip_smoke.py phase 9's hand (1,552 faces) against
its body (13,776 faces), the Moller operands.  Prints one JSON line per
split and query order: the queries in their own index order (the shipped
design) and in the Morton order of their centroids; and one line with the
candidate faces compacted into dense chunks (index order, split 1): the
shares of candidate faces and of chunks holding one, of warp-chunks taken
(and the heaviest warp's chunks and candidate slots, summed over the
splits), of the pairs the warps issue (the candidate slots of the chunks they take
x 32 lanes), the pairs the lanes run and those reaching the interval part,
with the bounds in milliseconds at 67e12 operations a second
(chip_smoke.py's operation counts).

Every run must give the every-face faces (row 11: the every-pair flags and
first hits); it exits non-zero otherwise.  Counts only: no time comes from
here.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sphere_records(ck, planes, variant, records):
    """The records with fields 0-3 holding the bounding sphere (center,
    radius, widened as the box is) of each chunk's corners."""
    import torch

    n_b, n_rows, n_f = planes.shape
    pad = -n_f % ck.CULL_CHUNK
    if pad:
        planes = torch.cat(
            [planes, planes[..., -1:].expand(n_b, n_rows, pad)], dim=-1)
    rows = planes.reshape(n_b, n_rows, -1, ck.CULL_CHUNK)
    a = rows[:, 0:3]
    b, c = ((a + rows[:, 3:6], a + rows[:, 6:9]) if variant == "fast"
            else (rows[:, 3:6], rows[:, 6:9]))
    corners = torch.stack([a, b, c], dim=-1)          # [B, 3, C, 32, 3]
    cen = corners.mean(dim=(-2, -1))
    dist = ((corners - cen[..., None, None]) ** 2).sum(1).sqrt()
    rad = (dist.amax(dim=(-2, -1)) * (1.0 + 8 * ck._U)
           + corners.abs().amax(dim=(1, -2, -1)) * (4 * ck._U))
    out = records.clone()
    out[..., 0:3] = cen.transpose(1, 2)
    out[..., 3] = rad
    return out


def sphere_lb2(ck):
    """The sphere bound in ``_cull_lb2``'s form: max(|p - c| - r, 0)
    shrunk by 1e-3, squared, less the same rounding terms."""
    import torch

    def lb2_of(px, py, pz, rec):
        dx, dy, dz = px - rec[..., 0], py - rec[..., 1], pz - rec[..., 2]
        dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
        big = dist + 3.0 * rec[..., 3]
        lb = torch.clamp_min(dist - rec[..., 3], 0.0) * (1.0 - 1e-3)
        big2 = big * big
        t = big2 * rec[..., 11]
        lb2 = lb * lb - (big2 * rec[..., 7] + t * t)
        return torch.where(big <= ck.CULL_FAR, lb2,
                           torch.full_like(lb2, float("-inf")))

    return lb2_of


def nw_counts(args):
    """Row 7's lines (``--nw``)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import normal_weighted as nw

    model = synthetic_body_model(seed=0, device="cpu")
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32)[:1]
    pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32)[:1]
    verts, _ = lbs(model, betas, pose, device="cpu")
    f = model.faces
    pts, nrm = cs.registration_inputs(verts[0], f, np.random.RandomState(1))
    pts, nrm = pts[-args.queries:], nrm[-args.queries:]   # the miss last
    tail = not ck.mesh_is_nondegenerate(verts[0].numpy(), f.numpy())
    ops = nw.normal_weighted_operands(verts, f, pts[None], nrm[None])
    want = nw.argmin_normal_weighted_plain(ops[0], ops[1], ops[2],
                                           args.eps, tail)
    cull = nw.normal_weighted_cull_operands(ops[0], ops[2], tail)
    n_c = cull["records"].shape[1]
    n_f = f.shape[0]
    # the warp whose lanes hold the planted miss (the last query)
    miss = int((cull["qorder"][0] == pts.shape[0] - 1).nonzero()) // 32
    bad = []
    for split in [int(x) for x in args.splits.split(",")]:
        faces, warp, lane, stage = nw.argmin_normal_weighted_culled_plain(
            ops[0], ops[1], ops[2], cull, args.eps, tail, split)
        if not torch.equal(faces, want):
            bad.append(split)
        w, rest = warp[0].float(), torch.ones(warp.shape[1], dtype=bool)
        rest[miss] = False
        lanes = lane[0].float().view(-1)
        in_miss = torch.zeros_like(lanes, dtype=torch.bool)
        in_miss[miss * 32:(miss + 1) * 32] = True
        print(json.dumps({
            "row": 7, "kernel": "normal_weighted_faces",
            "queries": pts.shape[0], "faces": n_f, "eps": args.eps,
            "tail": tail, "split": split,
            "faces_every_face": torch.equal(faces, want),
            "warp_share": float(w.mean()) / n_c,
            "heaviest_warp_share": float(w.max()) / n_c,
            "heaviest_warp_chunks_per_split": float(w.max()) / split,
            "stage_share": float(stage[0].float().mean()) / n_c,
            "lane_share": float(lanes.mean()) / n_f,
            "miss_warp": miss, "miss_warp_share": float(w[miss]) / n_c,
            "miss_lane_share": float(lanes[miss * 32 + int(
                (cull["qorder"][0, miss * 32:(miss + 1) * 32]
                 == pts.shape[0] - 1).nonzero())]) / n_f,
            "warp_share_without_miss_warp": float(w[rest].mean()) / n_c,
            "heaviest_warp_share_without_miss_warp":
                float(w[rest].max()) / n_c,
            "lane_share_without_miss_warp":
                float(lanes[~in_miss].mean()) / n_f}), flush=True)
    if bad:
        sys.exit("cull_counts: row 7's faces differ from every face at "
                 "split %s" % bad)


def along_counts(args):
    """Row 9's lines (``--along``)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import ray_kernel as ray

    model = synthetic_body_model(seed=0, device="cpu")
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32)[:1]
    pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32)[:1]
    verts, _ = lbs(model, betas, pose, device="cpu")
    f = model.faces
    pts, nrm = cs.registration_inputs(verts[0], f, np.random.RandomState(1))
    pts = pts[-args.queries:][None].contiguous()       # the miss last
    nrm = nrm[-args.queries:][None].contiguous()
    tri = verts[..., f.long(), :]
    want = ray.argmin_alongnormal_plain(pts, nrm, ray.ray_planes(tri))
    cull = ray.alongnormal_cull_operands(tri)
    n_c, n_f, n_q = cull["chunks"].shape[1], f.shape[0], pts.shape[1]
    shipped = ray.SEED_CHUNKS
    splits = [int(x) for x in args.splits.split(",")]
    runs = [(split, True, "mesh box", shipped) for split in splits]
    runs += [(1, False, "mesh box", shipped), (1, True, "own box", shipped)]
    runs += [(splits[-1], True, "mesh box", int(m))
             for m in args.seed_chunks.split(",") if m]
    # each lane's best cost, at its sorted position in the shipped order
    qo = ray.along_query_order(pts, cull)[0].long()
    win = ray.ray_planes(tri)[0][:, want[0, qo].long()]
    best = ray._alongnormal_cost_tile(
        ray._xyz(pts[0, qo]), ray._xyz(nrm[0, qo]),
        *[tuple(win[3 * g + k, :, None] for k in range(3))
          for g in range(3)])[:, 0]
    lanes = ray._lane_terms(pts, nrm, qo[None], n_q)
    bad = []
    for split, seed, box, m in runs:
        qorder = (ray.along_query_order(pts, cull) if box == "mesh box"
                  else ck.query_order(pts))
        ray.SEED_CHUNKS = m
        try:
            faces, warp, lane, stage, misses, tests, fell, meets = (
                ray.argmin_alongnormal_culled_plain(
                    pts, nrm, cull, qorder, split, seed=seed,
                    with_tests=True))
            seed_best = float((ray.along_seeds_plain(
                lanes[0], lanes[1], cull)[0] == best).float().mean())
        finally:
            ray.SEED_CHUNKS = shipped
        if not torch.equal(faces, want):
            bad.append((split, seed, box, m))
        if not torch.equal(faces, want):
            bad.append((split, seed, box))
        w, l_, st, mi, te, fe, me = (int(x.sum()) for x in (
            warp, lane, stage, misses, tests, fell, meets))
        seeds = n_q * (n_c * cs.ALONG_SEED_SCAN_OPS + m * ray.ANY_HIT_CHUNK
                       * cs.ALONG_PAIR_OPS)
        around = (te * cs.ALONG_TEST_OPS + fe * cs.CULL_FACE_OPS
                  + me * cs.ALONG_BOUND_OPS + mi * cs.ALONG_MISS_OPS
                  + (seeds if seed else 0))
        print(json.dumps({
            "row": 9, "kernel": "alongnormal_faces", "queries": n_q,
            "faces": n_f, "chunks": n_c, "split": split, "seed": seed,
            "seed_chunks": m, "seed_is_best_share": seed_best,
            "query_order": box, "faces_every_face": torch.equal(faces, want),
            "warp_share": w / warp.numel() / n_c,
            "heaviest_warp_share": int(warp.max()) / n_c,
            "stage_share": st / warp.numel() / n_c,
            "lane_share": l_ / (n_q * n_f),
            "miss_share": mi / max(1, te), "fallback_share": fe / max(1, te),
            "meets_per_lane": me / n_q,
            "bound_ms": (l_ * cs.ALONG_PAIR_OPS + around)
                        / cs.PEAK_FP32_OPS * 1e3,
            "bound_issued_ms": (w * 32 * ray.ANY_HIT_CHUNK * cs.ALONG_PAIR_OPS
                                + around) / cs.PEAK_FP32_OPS * 1e3}),
            flush=True)
    if bad:
        sys.exit("cull_counts: row 9's faces differ from every face at %s"
                 % bad)


def tri_counts(args):
    """Row 11's lines (``--tri``)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.query import tri_tri_kernel as tk

    body_v, body_f, hand_v, hand_f = cs.contact_inputs(torch.device("cpu"))
    hand = torch.as_tensor(hand_v.astype(np.float32))[
        torch.as_tensor(hand_f.astype(np.int64))]
    body = torch.as_tensor(body_v)[torch.as_tensor(body_f.astype(np.int64))]
    qp, fp = tk.moller_planes(hand, body)
    want = tk.tri_tri_any_hit_plain(qp, fp, "moller")
    n_q, n_f = qp.shape[1], fp.shape[1]
    morton = tk.morton_face_order(qp[0:9].t().reshape(-1, 3, 3))
    cand = tk._mask_bits(tk.tri_any_hit_operands(qp, fp)["chunks"])[:n_f]
    runs = [("index", split, qp, fp, None)
            for split in (int(x) for x in args.splits.split(","))]
    runs += [("morton", split, qp[:, morton].contiguous(), fp, morton)
             for split in (int(x) for x in args.splits.split(","))]
    runs.append(("index, compacted", 1, qp, fp[:, cand].contiguous(), None))
    bad = []
    for order, split, q, f, perm in runs:
        ops = tk.tri_any_hit_operands(q, f)
        hit, tested, warp, lane = tk.tri_tri_any_hit_culled_plain(q, ops,
                                                                  split)
        if perm is not None:
            hit[perm], tested[perm] = hit.clone(), tested.clone()
        if f is fp:
            same = torch.equal(hit, want[0]) and torch.equal(tested, want[1])
        else:       # compacted: the flags, the first hits' faces mapped
            idx = cand.nonzero()[:, 0]
            first = torch.where(hit, idx[(tested - 1).clamp(min=0).long()],
                                n_f)
            same = (torch.equal(hit, want[0])
                    and torch.equal(torch.where(hit, first + 1, n_f).to(
                        torch.int32), want[1]))
        if not same:
            bad.append((order, split))
        bits = tk._mask_bits(ops["chunks"]).view(-1, tk.TRI_CHUNK)
        n_c = bits.shape[0]
        nonempty = int(bits.any(dim=1).sum())
        pairs, deep = (int(x) for x in lane.sum(dim=0))
        chunks, slots = (int(x) for x in warp.sum(dim=0))
        tests = n_q * nonempty * cs.SELF_BOX_OPS

        def ms(pairs_):
            return (tests + pairs_ * cs.MOLLER_SIDES_OPS
                    + deep * cs.MOLLER_INTERVAL_OPS) / cs.PEAK_FP32_OPS * 1e3

        print(json.dumps({
            "row": 11, "kernel": "tri_tri_any_hit", "queries": n_q,
            "faces": n_f, "query_order": order, "split": split,
            "flags_every_pair": same,
            "candidate_share": int(cand.sum()) / n_f,
            "chunks": n_c, "chunks_with_candidates": nonempty,
            "warp_share": chunks / (warp.shape[0] * n_c),
            "heaviest_warp_chunks": int(warp[:, 0].max()),
            "heaviest_warp_slots": int(warp[:, 1].max()),
            "issued_share": slots * tk.WARP / (n_q * n_f),
            "lane_share": pairs / (n_q * n_f),
            "deep_share": deep / (n_q * n_f),
            "bound_ms": ms(pairs), "bound_issued_ms": ms(slots * tk.WARP)}),
            flush=True)
    if bad:
        sys.exit("cull_counts: row 11's flags differ from every pair at %s"
                 % bad)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bodies", type=int, default=4)
    ap.add_argument("--variant", choices=("fast", "safe"), default="fast")
    ap.add_argument("--tail", action="store_true")
    ap.add_argument("--nw", action="store_true",
                    help="row 7 on phase 8's registration inputs")
    ap.add_argument("--along", action="store_true",
                    help="row 9 on phase 8's registration inputs")
    ap.add_argument("--tri", action="store_true",
                    help="row 11 on phase 9's hand and body")
    ap.add_argument("--queries", type=int, default=65536,
                    help="with --nw or --along: the last this many of "
                         "phase 8's queries (the planted miss among them)")
    ap.add_argument("--splits", default="1,32",
                    help="with --nw or --along: the splits to count, "
                         "comma-separated")
    ap.add_argument("--seed-chunks", default="",
                    help="with --along: seeds over this many chunks to "
                         "count too, at the last split, comma-separated")
    ap.add_argument("--eps", type=float, default=0.1,
                    help="with --nw: the penalty's weight (phase 8's 0.1)")
    args = ap.parse_args()
    if args.nw:
        return nw_counts(args)
    if args.along:
        return along_counts(args)
    if args.tri:
        return tri_counts(args)
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.query import closest_kernel as ck

    model = synthetic_body_model(seed=0, device="cpu")
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32)[:args.bodies]
    pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32)[:args.bodies]
    queries = torch.as_tensor(
        rng.randn(cs.BATCH, cs.QUERIES_PER_MESH, 3) * 0.4,
        dtype=torch.float32)[:args.bodies]
    verts, _ = lbs(model, betas, pose, device="cpu")
    pts, planes, _, _ = ck.closest_point_operands(verts, model.faces,
                                                  queries, args.variant)
    want = ck.argmin_faces_plain(pts, planes, args.variant, args.tail)
    cull = ck.cull_operands(pts, planes, args.variant, args.tail)
    n_c = cull["records"].shape[1]
    box_lb2 = ck._cull_lb2
    bad = []
    for bound in ("box", "sphere"):
        ops = cull
        if bound == "sphere":
            ops = dict(cull, records=sphere_records(
                ck, planes, args.variant, cull["records"]))
            ck._cull_lb2 = sphere_lb2(ck)
        try:
            faces, warp, lane, stage = ck.argmin_faces_culled_plain(
                pts, planes, ops, args.variant, args.tail)
        finally:
            ck._cull_lb2 = box_lb2
        if not torch.equal(faces, want):
            bad.append(bound)
        print(json.dumps({
            "bound": bound, "bodies": args.bodies, "variant": args.variant,
            "tail": args.tail, "faces_every_face": torch.equal(faces, want),
            "warp_share": float(warp.float().mean()) / n_c,
            "heaviest_warp_share": int(warp.max()) / n_c,
            "stage_share": float(stage.float().mean()) / n_c,
            "lane_share": float(lane.float().mean()) / planes.shape[-1]}),
            flush=True)
    if bad:
        sys.exit("cull_counts: faces differ from every face under %s" % bad)


if __name__ == "__main__":
    main()
