#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's leaf-box kernel (leaf_boxes) and
nearest-vertex kernel (nearest_vertices), and of the calls around them, in
two checkouts, on one CUDA card, in one run.

    python3 tools/ab_leaf_vertices.py --other DIR [--pairs 4] [--rounds 5]
                                      [--reps 10]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``); the pairs, processes, medians and checks
are ``tools/ab_common.py``'s.  The inputs are chip_smoke.py's, made with
its seeds and shapes: phase 11's two rest keyframes (the SMPL-sized body
and the 98,304-face one) with the refit frame of each stream, and phase
3's 256 posed bodies with their 1024 queries and body 0's 4096.  A
process times, as device time behind a spin (``queued`` in
``tools/ab_common.py``):

- ``leaf_boxes_256`` and ``leaf_boxes_8``: the kernel alone on the
  98,304-face rest keyframe at leaves 256 (the anim sessions',
  ``RESIDENT_TILE_F``) and 8;
- ``vertices_1x4096`` and ``vertices_256x1024``: the kernel alone on body
  0 with its 4096 queries (the facade's shape) and on the whole batch;

and, with CUDA events around back-to-back calls (the host's launch path
included), ``vertices_call_1x4096`` (the kernel's wrapper on body 0),
``refit_smpl`` and ``refit_large`` (``refit_bvh`` of each stream's refit
frame over its keyframe's index at leaf 256, the anim refit stage) and
``closest_vertices`` (the warm ``Mesh.closest_vertices`` on body 0's
4096 queries, phase 4's call).  Where the checkout has them, the oracles
(``leaf_boxes_warp_*``, ``vertices_every_*``) run after the rest.  Every
answer must equal the first process's of the same name, across processes
and sides.  It reports the register and spill lines of both kernels and
both oracles, and both sides' SASS of the every-face oracles of rows 1, 7
and 9 (``SHARED``), which include ``argmin.cuh`` and must be identical.
"""

import os
import sys

from ab_common import parser, run, same_per_name, side_program

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the every-face oracles of rows 1, 7 and 9, which include csrc/argmin.cuh
#: as the retired nearest_vertices did: both sides' SASS of each is compared
SHARED = ("closest_faces_every", "normal_weighted_faces_every",
          "alongnormal_faces_every")

#: what each side's process runs, from its own checkout
SIDE = side_program(r"""
import numpy as np
from mesh_tpu_torch.accel import refit_kernel as fk
from mesh_tpu_torch.accel.build import build_bvh
from mesh_tpu_torch.accel.traverse import RESIDENT_TILE_F
from mesh_tpu_torch.anim import refit as anim_refit
from mesh_tpu_torch.mesh import Mesh
from mesh_tpu_torch.query import closest_kernel as ck

dev = torch.device("cuda")


def leaf_operand(rest, faces, v, leaf):
    # the leaf-box kernel's operand over rest's index at leaf, as
    # chip_smoke.refit_tri_s makes it
    index = build_bvh(rest, faces, leaf_size=leaf)
    arr = index.on(dev)
    f_t = torch.as_tensor(faces, device=dev).long()
    tri_s = (v - arr["center"])[f_t[arr["order"].long()]].contiguous()
    return index, tri_s, int(index.meta["n_leaves"])


for key in ("smpl", "large"):
    rest, faces = inputs[key + "_rest"].numpy(), inputs[key + "_faces"]
    v = inputs[key + "_frame"].to(dev)
    f_dev = faces.to(dev).long()
    index = build_bvh(rest, faces.numpy(), leaf_size=RESIDENT_TILE_F)
    name = "refit_" + key
    variants.append((name, lambda index=index, v=v, f_dev=f_dev:
                     anim_refit.refit_bvh(index, v, f_dev, device=dev)))
    refit, _ = anim_refit.refit_bvh(index, v, f_dev, device=dev)
    answers[name] = torch.as_tensor(np.concatenate(
        [refit.arrays["node_lo"], refit.arrays["node_hi"]]))
    if key != "large":
        continue
    rest_t = torch.as_tensor(rest, dtype=torch.float32, device=dev)
    for leaf in (RESIDENT_TILE_F, 8):
        _, tri_s, n_lv = leaf_operand(rest, faces.numpy(), rest_t, leaf)
        for tag, fn in (("leaf_boxes_%d", fk.leaf_boxes_kernel),
                        ("leaf_boxes_warp_%d",
                         getattr(fk, "leaf_boxes_warp_kernel", None))):
            if fn is None:
                continue
            name = tag % leaf
            call = (lambda fn=fn, tri_s=tri_s, n_lv=n_lv, leaf=leaf:
                    fn(tri_s, n_lv, leaf))
            (later if "warp" in name else variants).append((name, call))
            queued.add(name)
            answers[name] = torch.cat(call()).cpu()

verts = inputs["verts"].to(dev)
vmean = verts.mean(dim=-2, keepdim=True)
b0mean = verts[:1].mean(dim=-2, keepdim=True)
shapes = {
    "1x4096": ((inputs["q1"].to(dev) - b0mean).contiguous(),
               (verts[:1] - b0mean).transpose(-1, -2).contiguous()),
    "256x1024": ((inputs["queries"].to(dev) - vmean).contiguous(),
                 (verts - vmean).transpose(-1, -2).contiguous())}
for shape, (pts, vplanes) in shapes.items():
    for tag, fn in (("vertices_%s", ck.argmin_vertices),
                    ("vertices_every_%s",
                     getattr(ck, "argmin_vertices_every", None))):
        if fn is None:
            continue
        name = tag % shape
        call = lambda fn=fn, pts=pts, vplanes=vplanes: fn(pts, vplanes)
        (later if "every" in name else variants).append((name, call))
        queued.add(name)
        answers[name] = call().cpu()
        if name == "vertices_1x4096":
            # the same call back to back, host launch path included
            variants.append(("vertices_call_1x4096", call))
mesh = Mesh(inputs["verts"][0].numpy(), inputs["smpl_faces"].numpy(),
            device=dev)
q1 = inputs["q1"][0].numpy()
variants.append(("closest_vertices", lambda: mesh.closest_vertices(q1)))
answers["closest_vertices"] = torch.as_tensor(mesh.closest_vertices(q1)[0])
""", ptxas=("leaf_boxes", "leaf_boxes_warp", "nearest_vertices",
            "nearest_vertices_every"), sass=SHARED)


def inputs():
    """chip_smoke.py's inputs, made on the card and kept on the CPU:
    phase 11's rest keyframes, faces and refit frames of both streams, and
    phase 3's posed bodies, queries and body 0's facade queries."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.accel.traverse import RESIDENT_TILE_F
    from mesh_tpu_torch.models import lbs, synthetic_body_model

    dev = torch.device("cuda")
    model = synthetic_body_model(seed=0, device=dev)
    model_l = cs.large_batch_inputs(dev)[0]
    out = {}
    for key, m, seed in (("smpl", model, 11), ("large", model_l, 12)):
        _, v, _, rest, _, f_np, _, _ = cs.anim_frame(m, RESIDENT_TILE_F,
                                                     seed, dev)
        out[key + "_rest"] = torch.as_tensor(rest)
        out[key + "_faces"] = torch.as_tensor(f_np)
        out[key + "_frame"] = v.cpu()
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    queries = torch.as_tensor(
        rng.randn(cs.BATCH, cs.QUERIES_PER_MESH, 3) * 0.4,
        dtype=torch.float32)
    verts, _ = lbs(model, betas, pose, device=dev)
    q1 = torch.as_tensor(rng.randn(1, cs.FACADE_QUERIES, 3) * 0.4,
                         dtype=torch.float32)
    out.update(verts=verts.cpu(), queries=queries, q1=q1)
    return out


def main():
    args = parser(__doc__).parse_args()
    run("ab_leaf_vertices", args, SIDE, inputs, same_per_name, sass=SHARED,
        needs="mesh_tpu_torch/accel/refit_kernel.py")


if __name__ == "__main__":
    main()
