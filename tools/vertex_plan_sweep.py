#!/usr/bin/env python3
"""The sweep behind ``closest_kernel.vertex_plan``: the nearest-vertex
kernel (nearest_vertices) at every plan it is built for, at shapes on both
sides of the plan's rule, on one CUDA card.

    python3 tools/vertex_plan_sweep.py [--rounds 5] [--reps 20]
                                       [--out chiprun_out/vertex_plan.json]

Runs on the checkout in the working directory.  The inputs are
chip_smoke.py phase 2's: its 256 posed bodies (6,890 vertices each) with
their 1024 queries, of which the first B bodies make a B x 1024 shape, and
body 0 with its 4096 facade queries (1 x 4096; 4 x 4096 takes bodies 0-3
with the facade's queries of each).  Each plan, (queries a thread, split)
for every queries a thread the kernel is built for and every split of 1
to ``VERTEX_MAX_SPLIT``, is timed as device time (``queued_ms``: ``--reps``
launches queued behind a spin) once a round, the plans of a shape in a
new random order each round, ``--rounds`` rounds.  Every plan's indices
must equal the plain version's first.

Prints, per shape, the plan ``vertex_plan`` picks on this card, the
fastest plan by median, and for each plan its median, least and most over
the rounds; then ``host_us``, the host's microseconds a call (the median
of 5 runs of 200 calls, fewer than the card's launch queue holds) of
the SM-count lookup uncached
(``torch.cuda.get_device_properties``) and cached (``_sm_count``) and of
enqueueing ``argmin_vertices`` at 1 x 4096; writes every reading to
``--out``; and prints the card's name and power limit.  It exits non-zero
without a card.
"""

import argparse
import json
import os
import statistics
import sys
import time

#: (meshes, queries a mesh) of the sweep: the facade's shape and 4 of it,
#: and B x 1024 from 8 meshes to the main path's batch, across the rule's
#: two thresholds (the query blocks of 2 queries a thread, 4 a mesh at
#: 1024, against an eighth and one and a half times the SMs)
SHAPES = ((1, 4096), (4, 4096), (8, 1024), (16, 1024), (24, 1024),
          (32, 1024), (40, 1024), (48, 1024), (64, 1024), (128, 1024),
          (256, 1024))


def host_us(fn, calls=200):
    """The median over 5 runs of the host's microseconds a call to run
    ``calls`` calls of ``fn``, the card drained before each run."""
    import torch

    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/vertex_plan.json")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("vertex_plan_sweep: no CUDA card")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from mesh_tpu_torch import _build
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.query import closest_kernel as ck

    _build.build()
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
    q1 = torch.as_tensor(rng.randn(1, cs.FACADE_QUERIES, 3) * 0.4,
                         dtype=torch.float32, device=dev)
    sms = ck._sm_count(dev)
    plans = [(per, split) for per in ck.VERTEX_PER_THREAD
             for split in range(1, ck.VERTEX_MAX_SPLIT + 1)]
    order = np.random.RandomState(1)
    report = {"card": cs.nvidia_smi(), "sms": sms, "rounds": args.rounds,
              "reps": args.reps, "shapes": {}}
    for n_b, n_q in SHAPES:
        v = verts[:n_b]
        q = q1.expand(n_b, -1, -1) if n_q == cs.FACADE_QUERIES else (
            queries[:n_b, :n_q])
        mean = v.mean(dim=-2, keepdim=True)
        pts = (q - mean).contiguous()
        vplanes = (v - mean).transpose(-1, -2).contiguous()
        want = ck.argmin_vertices_plain(pts, vplanes)
        for plan in plans:
            got = ck.argmin_vertices(pts, vplanes, _plan=plan)
            cs.check(torch.equal(got, want), "nearest_vertices at %d x %d, "
                     "plan %s: indices differ from the plain version"
                     % (n_b, n_q, plan))
        times = {plan: [] for plan in plans}
        for _ in range(args.rounds):
            for at in order.permutation(len(plans)):
                plan = plans[at]
                times[plan].append(cs.queued_ms(
                    lambda plan=plan: ck.argmin_vertices(pts, vplanes,
                                                         _plan=plan),
                    args.reps))
        med = {plan: statistics.median(t) for plan, t in times.items()}
        best = min(med, key=med.get)
        picked = ck.vertex_plan(n_b, n_q, vplanes.shape[-1], sms)
        name = "%dx%d" % (n_b, n_q)
        report["shapes"][name] = {
            "picked": list(picked), "picked_ms": med[picked],
            "best": list(best), "best_ms": med[best],
            "ms": {"%d,%d" % plan: [med[plan], min(t), max(t)]
                   for plan, t in times.items()},
            "rounds_ms": {"%d,%d" % plan: t for plan, t in times.items()}}
        print("%s: picked %s %.4f ms, fastest %s %.4f ms; per thread 2 / 4,"
              " split: median [least, most]" % (name, picked, med[picked],
                                                best, med[best]))
        for split in range(1, ck.VERTEX_MAX_SPLIT + 1):
            print("  %2d: %s" % (split, "   ".join(
                "%.4f [%.4f, %.4f]" % (med[(per, split)],
                                       min(times[(per, split)]),
                                       max(times[(per, split)]))
                for per in ck.VERTEX_PER_THREAD)))
    pts = (q1 - verts[:1].mean(dim=-2, keepdim=True)).contiguous()
    vplanes = (verts[:1] - verts[:1].mean(dim=-2, keepdim=True)).transpose(
        -1, -2).contiguous()
    report["host_us"] = {
        "sm_count_uncached": host_us(
            lambda: torch.cuda.get_device_properties(pts.device)
            .multi_processor_count),
        "sm_count_cached": host_us(lambda: ck._sm_count(pts.device)),
        "argmin_vertices_1x4096": host_us(
            lambda: ck.argmin_vertices(pts, vplanes))}
    print("host_us: %s" % json.dumps(report["host_us"]))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh)
    print(report["card"])
    print(json.dumps({name: {k: r[k] for k in ("picked", "picked_ms",
                                                "best", "best_ms")}
                      for name, r in report["shapes"].items()}))


if __name__ == "__main__":
    main()
