"""Phase 21 of chip_smoke.py alone, on the card: the kernels built, the
main path's 256 posed bodies, phase 6's scan sphere and phase 14's
config-5 scan made as chip_smoke makes them, then drive_parallel_phase
(a world of chip_smoke.PARALLEL_RANKS ranks: on one card sharing it under
gloo, with a card a rank under NCCL; the engine's lane in this process).

    python3 tools/parallel_phase.py

Needs one CUDA card (four for NCCL); about 75 s of command with the
build."""
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
print("card:", smi, "torch", torch.__version__, flush=True)
_build.build(verbose=False)
print("build %.1f s" % (time.perf_counter() - t0), flush=True)
model = synthetic_body_model(seed=0, device=dev)
rng = np.random.RandomState(0)
betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                        dtype=torch.float32, device=dev)
pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                       dtype=torch.float32, device=dev)
verts, _ = lbs(model, betas, pose, device=dev)
cams = torch.tensor(cs.VIS_CAMERAS, dtype=torch.float32, device=dev)
v_s, f_s, _ = cs.scan_inputs()
scans = cs.fit_inputs(model, verts[0].detach(), dev)
inp, ref = cs.parallel_inputs(
    model, verts.cpu().numpy(), model.faces.cpu().numpy(), verts,
    verts[:cs.VIS_BATCH], cams, scans[cs.FIT_MAIN][0].cpu().numpy(),
    (v_s, f_s), dev)
print("inputs and references %.1f s" % (time.perf_counter() - t0),
      flush=True)
rec, launches = cs.drive_parallel_phase(inp, ref, dev, smi)
print("parallel launches", {k: n for k, n in launches.items() if n})
print("parallel_phase ok %.1f s" % (time.perf_counter() - t0), flush=True)
