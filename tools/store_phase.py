"""Phase 19 of chip_smoke.py and phase 14's diff repairs alone, on the card:
the kernels built, the main path's inputs, phase 4's facade queries and
phase 6's scan made as chip_smoke makes them, then check_diff_repairs and
drive_store_phase.

    python3 tools/store_phase.py

Needs one CUDA card; about 50 s with the build."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import chip_smoke as cs
from mesh_tpu_torch import _build
from mesh_tpu_torch.models import lbs, synthetic_body_model

t0 = time.perf_counter()
dev = torch.device("cuda")
smi = cs.nvidia_smi()
print("card:", smi, flush=True)
_build.build(verbose=False)
print("build %.1f s" % (time.perf_counter() - t0), flush=True)
model = synthetic_body_model(seed=0, device=dev)
rng = np.random.RandomState(0)
betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                        dtype=torch.float32, device=dev)
pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                       dtype=torch.float32, device=dev)
queries = torch.as_tensor(rng.randn(cs.BATCH, cs.QUERIES_PER_MESH, 3) * 0.4,
                          dtype=torch.float32, device=dev)
verts, _ = lbs(model, betas, pose, device=dev)
posed = verts.cpu().numpy()
q1_np = np.asarray(rng.randn(1, cs.FACADE_QUERIES, 3) * 0.4, np.float32)[0]
f_np = model.faces.cpu().numpy()
scans = cs.fit_inputs(model, verts[0].detach(), dev)
t1 = time.perf_counter()
rec14 = cs.check_diff_repairs(verts, model.faces, queries,
                              scans[cs.FIT_MAIN][0], dev)
print("diff repairs %.1f s: %s" % (time.perf_counter() - t1, rec14),
      flush=True)
v_s, f_s, _ = cs.scan_inputs()
rec, launches = cs.drive_store_phase({
    "scan": (v_s, f_s), "body": (posed[0], f_np), "facade_q": q1_np,
    "serve_q": np.asarray(np.random.RandomState(19).randn(
        cs.SERVE_QUERIES, 3) * 0.4, np.float32),
    "model": model}, dev, smi)
print("launches", {k: n for k, n in launches.items() if n})
print("store_phase ok %.1f s" % (time.perf_counter() - t0), flush=True)
