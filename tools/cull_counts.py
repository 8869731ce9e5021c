#!/usr/bin/env python3
"""What the chunk cull of closest_faces tests, counted on the CPU by its
plain version (``closest_kernel.argmin_faces_culled_plain``), on the first
bodies of chip_smoke.py's main path.

    python3 tools/cull_counts.py [--bodies 4] [--variant fast] [--tail]

The bodies, poses and queries are chip_smoke.py's (seed 0, 1024 N(0, 0.4)
queries a body), made on the CPU.  Prints, as one JSON line each, the
shares of the shipped design (the box bound of ``cull_records``) and of a
bounding-sphere bound over the same corners, with the same rounding terms
and seeds: chunks folded by the mean warp and by the heaviest, chunks
staged, and pairs each lane needs.  Both must give the every-face faces;
the run exits non-zero otherwise.  Counts only: no time comes from here.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bodies", type=int, default=4)
    ap.add_argument("--variant", choices=("fast", "safe"), default="fast")
    ap.add_argument("--tail", action="store_true")
    args = ap.parse_args()
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
