#!/usr/bin/env python3
"""Where the contact kernel's time goes (tri_tri_any_hit, the Moller tile),
on one CUDA card.

    python3 tools/tri_costs.py [--splits 1,16,32,64] [--reps 200]

Runs on the checkout in the working directory: its package and its
chip_smoke.py are imported from there, so the same tool times another
checkout when started from its root (``cd DIR && python3
/path/to/tools/tri_costs.py``), for example the parent unpacked with ``git
archive`` into ``build/parent``, or a copy with one constant changed; run
both in one call, alternating, to compare them.  The inputs are
chip_smoke.py phase 9's hand (1,552 faces) against its body (13,776
faces).  Prints one JSON line:

- ``kernel_ms``: where the checkout has the cull, the kernel alone per
  input set and split (``queued_ms``: launches queued behind a spin, into
  one first-hit buffer; the least of three runs of ``--reps``), on phase
  9's operands (``contact``), on chip_smoke.py's planted sets
  (``tri_planted``) and on phase 9's chunk records with every candidate
  mask cleared (``floor``: a launch that finds nothing to test);
- ``every_ms``: the every-pair kernel's wrapper per input set (CUDA
  events around ``--reps`` calls; device-bound);
- ``self_intersect_ms``: row 10's kernel alone on the body in its Morton
  order (queued), whose code the contact cull shares a header with;
- ``host_ms``: the host's time to enqueue each step of a contact call,
  the card drained before each: ``moller_planes`` (the Moller prologue),
  ``operands`` (``tri_any_hit_operands``), ``wrapper`` (the kernel's
  wrapper on operands made beforehand), ``every_wrapper`` (the every-pair
  path's wrapper);
- the card's name and power limit.

It exits non-zero without a card.  Times only: the answers are
chip_smoke.py's to check.
"""

import argparse
import json
import os
import statistics
import sys
import time


def host_ms(fn, reps):
    """The median over 5 runs of the host's time per call to enqueue
    ``reps`` calls of ``fn``, the card drained before each run."""
    import torch

    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", default="1,16,32,64")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("tri_costs: no CUDA card")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from mesh_tpu_torch import _build
    from mesh_tpu_torch.query import tri_tri_kernel as tk

    _build.build()
    dev = torch.device("cuda")
    body_v, body_f, hand_v, hand_f = cs.contact_inputs(dev)
    hand = torch.as_tensor(hand_v.astype(np.float32), device=dev)[
        torch.as_tensor(hand_f.astype(np.int64), device=dev)]
    body = torch.as_tensor(body_v, device=dev)[
        torch.as_tensor(body_f.astype(np.int64), device=dev)]
    qp, fp = tk.moller_planes(hand, body)
    splits = [int(s) for s in args.splits.split(",")]
    out = {"checkout": os.getcwd(), "card": cs.nvidia_smi(),
           "reps": args.reps}
    cull = hasattr(tk, "tri_any_hit_operands")
    sets = [("contact", qp, fp)]
    if cull:
        sets += cs.tri_planted(tk, qp, fp, np.random.RandomState(23))
    out["every_ms"] = {
        label: cs.cuda_ms(lambda q=q, f=f: tk.tri_tri_any_hit_every(
            q, f, "moller") if cull else tk.tri_tri_any_hit(q, f, "moller"),
            reps=args.reps // 10)
        for label, q, f in sets}
    if cull:
        def alone(q, f, ops, split):
            first = torch.empty(q.shape[1], dtype=torch.int32, device=dev)
            return min(cs.queued_ms(lambda: _build.launch(
                "tri_tri_any_hit", dev, q, ops["faces"], ops["chunks"],
                first, None, None, q.shape[1], f.shape[1],
                ops["chunks"].shape[0], split, 1, tk.T_LO, tk.T_HI),
                reps=args.reps) for _ in range(3))

        out["kernel_ms"] = {}
        for label, q, f in sets:
            ops = tk.tri_any_hit_operands(q, f)
            out["kernel_ms"][label] = {s: alone(q, f, ops, s)
                                       for s in splits}
        ops = tk.tri_any_hit_operands(qp, fp)
        empty = dict(ops, chunks=ops["chunks"].clone())
        empty["chunks"].view(torch.int32)[:, 7] = 0
        out["kernel_ms"]["floor"] = {s: alone(qp, fp, empty, s)
                                     for s in splits}
    # row 10 on the body, in its Morton order
    order = tk.morton_face_order(body)
    ids = torch.as_tensor(body_f.astype(np.int32), device=dev)[
        order].contiguous()
    sp, sf = tk.self_planes(body[order], "moller")
    frec, boxes = tk.self_kernel_operands(sf, ids, "moller")
    counts = torch.zeros(sf.shape[1], dtype=torch.int32, device=dev)
    out["self_intersect_ms"] = min(cs.queued_ms(lambda: _build.launch(
        "self_intersect", dev, sp, frec, boxes, counts, None, None,
        sf.shape[1], 0, sf.shape[1], 1, tk.T_LO, tk.T_HI), reps=20)
        for _ in range(3))
    steps = {"moller_planes": lambda: tk.moller_planes(hand, body),
             "every_wrapper": (lambda: tk.tri_tri_any_hit_every(
                 qp, fp, "moller")) if cull
             else (lambda: tk.tri_tri_any_hit(qp, fp, "moller"))}
    if cull:
        ops = tk.tri_any_hit_operands(qp, fp)
        steps["operands"] = lambda: tk.tri_any_hit_operands(qp, fp)
        steps["wrapper"] = lambda: tk.tri_tri_any_hit(qp, fp, "moller",
                                                      ops=ops)
    out["host_ms"] = {name: host_ms(fn, 100) for name, fn in steps.items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
