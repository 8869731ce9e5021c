#!/usr/bin/env python3
"""What the MXU rung's chunk culls test, counted on the CPU by the plain
versions of their design (``mxu_kernel.mxu_faces_culled_plain``,
``mxu_repair_culled_plain`` and the bound pass's ``mxu_bound_culled_plain``),
on chip_smoke.py phase 12's sphere sets.

    python3 tools/mxu_cull_counts.py [--queries 65536] [--split 1] [--tail]

The mesh and queries are chip_smoke.py's (``_sphere_mesh(32768)``, seed 12:
surface patches of 256, then N(0, 0.4) queries), the first ``--queries``
of each set, made on the CPU.  Prints, as one JSON line per set and scan,
the chunks folded by the mean warp and by the heaviest, the chunks staged,
the pairs each lane needs and, for the repair, the face tiles each query
tile runs; for the bound pass also the chunks each lane needs for its ub
test and for its cert test apart.  The faces must equal the every-face
plain versions', and the bound pass's ub and survivors the every-face
``mxu_bound_plain``'s; the run exits non-zero otherwise.  Counts only:
no time comes from here (the 65,536-query sets take a few minutes).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=65536)
    ap.add_argument("--split", type=int, default=1)
    ap.add_argument("--tail", action="store_true",
                    help="with the degenerate-face tail")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from mesh_tpu_torch.query import mxu_kernel as mk
    from mesh_tpu_torch.query.autotune import _sphere_mesh

    v, f = _sphere_mesh(cs.MXU_SPHERE_FACES)
    rng = np.random.RandomState(12)
    sets = {"sphere_surface": cs.surface_patches(cs.MXU_QUERIES, rng),
            "sphere_randn": (rng.randn(cs.MXU_QUERIES, 3) * 0.4).astype(
                np.float32)}
    bad = []
    for label, q in sets.items():
        p, rec, _, _, _ = mk.mxu_operands(v, f, q[:args.queries],
                                          device="cpu")
        cull = mk.mxu_cull_operands(p, rec, args.tail)
        n_c = -(-rec.shape[0] // mk.CULL_CHUNK)
        ub, cert = mk.mxu_bound_plain(p, rec)
        dense = mk.mxu_faces_culled_plain(
            p, rec, cull, degenerate_tail=args.tail, split=args.split)
        repair = mk.mxu_repair_culled_plain(
            p, rec, ub, cert, cull, degenerate_tail=args.tail,
            split=args.split)
        want = mk.mxu_faces_plain(p, rec, degenerate_tail=args.tail)
        want_r = mk.mxu_repair_plain(p, rec, ub, cert,
                                     degenerate_tail=args.tail)
        bound = mk._bound_culled(p, rec, cull, mk.TILE_F, args.split,
                                 apart=True)
        bound_ok = (torch.equal(bound[0], ub) and torch.equal(
            mk.survivors(bound[0], bound[1]), mk.survivors(ub, cert)))
        for scan, (faces, warp, lane, stage), ok, extra in (
                ("dense", dense, torch.equal(dense[0], want), {}),
                ("repair", (repair[0],) + repair[2:],
                 torch.equal(repair[0], want_r[0]),
                 {"tiles_run_per_query_tile": float(
                     repair[1].float().mean())}),
                ("bound", (None,) + bound[2:5], bound_ok,
                 {"lane_ub_chunk_share": float(bound[5].float().mean()) / n_c,
                  "lane_cert_chunk_share":
                      float(bound[6].float().mean()) / n_c})):
            bad += [] if ok else ["%s %s" % (label, scan)]
            print(json.dumps(dict(
                {"set": label, "scan": scan, "queries": int(p.shape[0]),
                 "split": args.split, "tail": args.tail,
                 "equal_every_face": ok,
                 "warp_share": float(warp.float().mean()) / n_c,
                 "heaviest_warp_share": int(warp.max()) / n_c,
                 "stage_share": float(stage.float().mean()) / n_c,
                 "lane_share": float(lane.float().mean()) / rec.shape[0]},
                **extra)), flush=True)
    if bad:
        sys.exit("mxu_cull_counts: answers differ from the every-face "
                 "plain versions: %s" % ", ".join(bad))


if __name__ == "__main__":
    main()
