#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's self-intersection facade in two
checkouts, on one CUDA card, in one run.

    python3 tools/ab_self_intersect.py --other DIR [--pairs 10] [--reps 20]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  The inputs are made once, here, from fixed seeds: body 0 of
chip_smoke.py's SMPL-sized batch (13,776 faces) and of its large batch
(98,304 faces), each posed alone from the same draws.  Each side then runs
in a process of its own, from its own checkout, ``--pairs`` times, the
pairs alternating which side runs first (other, this, this, other, ...):
one first call (which builds the kernel), then ``--reps`` warm calls of
``mesh_tpu_torch.query.ray.self_intersection_count``, each timed on the
host clock (the call returns a device tensor, read with ``int``) and
with CUDA events around it.  Both sides must count the same faces.
Prints one line per process and, last, one JSON object with every
reading, per body the median of each side's warm-call medians, the pairs
this checkout won and the other's quartile spread, and the card's name
and power limit; exits non-zero without a card or when the counts
differ.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: chip_smoke.py's seeds and shapes: the SMPL-sized batch of 256 and the
#: large batch of 64 bodies on a (256, 192) UV-sphere template
BATCH, LARGE_BATCH, LARGE_TEMPLATE = 256, 64, (256, 192)

#: what each side's process runs, from its own checkout
SIDE = r"""
import json, statistics, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
from mesh_tpu_torch.query.ray import self_intersection_count

data = np.load(sys.argv[1])
reps = int(sys.argv[2])
out = {}
for key in ("smpl_body0", "large_body0"):
    v, f = data[key + "_v"], data[key + "_f"]
    t0 = time.perf_counter()
    count = int(self_intersection_count(v, f, device="cuda"))
    first = (time.perf_counter() - t0) * 1e3
    host, dev = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        again = int(self_intersection_count(v, f, device="cuda"))
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        dev.append(start.elapsed_time(end))
        assert again == count
    out[key] = {"faces": int(f.shape[0]), "count": count, "first_ms": first,
                "host_ms": statistics.median(host), "host_min_ms": min(host),
                "event_ms": statistics.median(dev)}
print(json.dumps(out))
"""


def bodies():
    """{key: (vertices [V, 3] float32, faces [F, 3] int64)} made on the
    CPU from chip_smoke.py's seeds."""
    import torch

    sys.path.insert(0, HERE)
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.models.body_model import _uv_sphere

    out = {}
    v, f = _uv_sphere(*LARGE_TEMPLATE)
    for key, template, n in (
            ("smpl_body0", None, BATCH),
            ("large_body0", (v * np.array([0.3, 0.2, 0.9]), f), LARGE_BATCH)):
        kw = {} if template is None else {"template": template}
        model = synthetic_body_model(seed=0, device="cpu", **kw)
        rng = np.random.RandomState(0)
        betas = rng.randn(n, model.num_betas) * 0.3
        pose = rng.randn(n, model.num_joints, 3) * 0.1
        verts, _ = lbs(model, torch.as_tensor(betas[:1], dtype=torch.float32),
                       torch.as_tensor(pose[:1], dtype=torch.float32),
                       device="cpu")
        out[key] = (verts[0].numpy().astype(np.float32),
                    model.faces.cpu().numpy().astype(np.int64))
    return out


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi failed: %s" % exc


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root directory")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_self_intersect: no CUDA card")
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "mesh_tpu_torch", "query",
                                       "ray.py")):
        sys.exit("ab_self_intersect: %s holds no mesh_tpu_torch" % other)
    runs = []
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        path = os.path.join(tmp, "bodies.npz")
        np.savez(path, **{"%s_%s" % (key, part): arr
                          for key, pair in bodies().items()
                          for part, arr in zip("vf", pair)})
        order = [("other", other), ("this", HERE)]
        for side, root in [run for k in range(args.pairs)
                           for run in (order if k % 2 == 0 else order[::-1])]:
            res = subprocess.run(
                [sys.executable, "-c", SIDE, path, str(args.reps)], cwd=root,
                capture_output=True, text=True, timeout=900)
            if res.returncode:
                sys.stderr.write(res.stderr)
                sys.exit("ab_self_intersect: the %s side failed" % side)
            reading = json.loads(res.stdout.strip().splitlines()[-1])
            runs.append({"side": side, "readings": reading})
            print("%s (%s): %s" % (side, root, ", ".join(
                "%s %d faces, count %d, host %.3f ms (min %.3f), events "
                "%.3f ms, first %.1f ms" % (
                    key, r["faces"], r["count"], r["host_ms"],
                    r["host_min_ms"], r["event_ms"], r["first_ms"])
                for key, r in reading.items())), flush=True)
    counts = {json.dumps({k: r["count"] for k, r in run["readings"].items()})
              for run in runs}
    summary = {}
    for key in runs[0]["readings"]:
        ms = {side: [run["readings"][key]["host_ms"] for run in runs
                     if run["side"] == side] for side in ("other", "this")}
        quart = statistics.quantiles(ms["other"], n=4) if len(
            ms["other"]) > 1 else [ms["other"][0]] * 3
        summary[key] = {
            "median_ms": {side: statistics.median(v) for side, v in
                          ms.items()},
            "this_wins": sum(t < o for t, o in zip(ms["this"], ms["other"])),
            "pairs": len(ms["this"]),
            "other_quartile_spread_ms": quart[2] - quart[0]}
    print(json.dumps({"card": card(), "reps": args.reps, "summary": summary,
                      "runs": runs, "counts_agree": len(counts) == 1}))
    if len(counts) != 1:
        sys.exit("ab_self_intersect: the two sides count different faces")


if __name__ == "__main__":
    main()
