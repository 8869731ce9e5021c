"""Phases 18 and 20 of chip_smoke.py alone, on the card: the kernels built
with the torch.monitor bridge installed, the main path's body 0 and phase
5's large batch made as chip_smoke makes them, then drive_serve_phase
(whose closed-loop ledger phase 20's prof reads) and drive_fleet_phase.

    python3 tools/fleet_phase.py

Needs one CUDA card; about 2 minutes with the build."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import chip_smoke as cs
from mesh_tpu_torch import _build
from mesh_tpu_torch.models import lbs, synthetic_body_model
from mesh_tpu_torch.obs import install_torch_monitoring_bridge

t0 = time.perf_counter()
dev = torch.device("cuda")
smi = cs.nvidia_smi()
print("card:", smi, flush=True)
install_torch_monitoring_bridge()
_build.build(verbose=False)
bridge = cs.bridge_counts()
print("build %.1f s, kernel cache %s" % (time.perf_counter() - t0, bridge),
      flush=True)
model = synthetic_body_model(seed=0, device=dev)
rng = np.random.RandomState(0)
betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                        dtype=torch.float32, device=dev)
pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                       dtype=torch.float32, device=dev)
verts, _ = lbs(model, betas, pose, device=dev)
f_np = model.faces.cpu().numpy()
model_l, _, _, verts_l, queries_l = cs.large_batch_inputs(dev)
serve, launches = cs.drive_serve_phase(cs.serve_inputs(
    verts[0].cpu().numpy(), f_np, verts_l[0].cpu().numpy(),
    model_l.faces.cpu().numpy(), queries_l[0].cpu().numpy()), dev, smi)
print("serve launches", {k: n for k, n in launches.items() if n})
rec, launches = cs.drive_fleet_phase(dict(
    cs.fleet_inputs(model, dev), bridge=bridge,
    closed_ledger=cs.SERVE_CLOSED_LEDGER), dev, smi)
print("fleet launches", {k: n for k, n in launches.items() if n})
print("fleet_phase ok %.1f s" % (time.perf_counter() - t0), flush=True)
