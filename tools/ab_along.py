#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's along-normal kernel (alongnormal_faces)
and of the registration call around it, in two checkouts, on one CUDA
card, in one run.

    python3 tools/ab_along.py --other DIR [--pairs 4] [--rounds 5]
                              [--reps 10] [--splits 1,4,8,16,32]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``); the pairs, processes, medians and checks
are ``tools/ab_common.py``'s.  The inputs are chip_smoke.py phase 8's,
made with its seeds and shapes: posed body 0 (13,776 faces) and its 65,536
scan points with noisy normals, the planted miss last.  A process times
``argmin_alongnormal`` on operands made beforehand (``kernel``: where the
checkout has the chunk cull, its face side and query order are made
beforehand; ``with_order`` times the call that makes the query order, as a
tree's warm call does, ``order`` the query order alone and ``face_side``
the face side alone, a tree's first call), the every-face kernel
(``every``: the checkout's ``argmin_alongnormal_every``, or its
``argmin_alongnormal`` where it has no cull), each split of ``--splits``
(``split<n>``), and phase 8's warm ``AabbTree.nearest_alongnormal`` call
(``nearest``).  It reports the register and spill lines of
alongnormal_faces, alongnormal_faces_every and of rows 8, 1 and 7
(``SHARED``), whose SASS must be the same on both sides: row 8's chunk
test moved into a shared header.  Every face must equal the first
process's kernel faces, across variants, processes and sides.
"""

import os
import sys

from ab_common import parser, run, same_as_first, side_program

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the kernels of rows 8, 1 and 7, whose code this change must leave as
#: it was: both sides' SASS of each is compared
SHARED = ("ray_any_hit_culled", "closest_faces", "normal_weighted_faces")

#: what each side's process runs, from its own checkout
SIDE = side_program(r"""
from mesh_tpu_torch.mesh import Mesh
from mesh_tpu_torch.query import ray_kernel as ray

splits = [int(s) for s in extra[0].split(",")]
dev = torch.device("cuda")
v, f = inputs["verts0"].to(dev), inputs["faces"].to(dev)
pts = inputs["pts"].to(dev)[None].contiguous()
nrm = inputs["nrm"].to(dev)[None].contiguous()
tri = v[None][..., f.long(), :]
planes = ray.ray_planes(tri)
if hasattr(ray, "alongnormal_cull_operands"):
    cull = ray.alongnormal_cull_operands(tri)
    qorder = ray.along_query_order(pts, cull)
    kernel = lambda: ray.argmin_alongnormal(pts, nrm, cull=cull,
                                            qorder=qorder)
    every = lambda: ray.argmin_alongnormal_every(pts, nrm, planes)
    variants += [
        ("with_order", lambda: ray.argmin_alongnormal(pts, nrm, cull=cull)),
        ("order", lambda: ray.along_query_order(pts, cull)),
        ("face_side", lambda: ray.alongnormal_cull_operands(tri))]
    variants += [("split%d" % s, lambda s=s: ray.argmin_alongnormal(
        pts, nrm, cull=cull, qorder=qorder, split=s)) for s in splits]
    for s in splits:
        answers["split%d" % s] = ray.argmin_alongnormal(
            pts, nrm, cull=cull, qorder=qorder, split=s).cpu()
else:
    kernel = every = lambda: ray.argmin_alongnormal(pts, nrm, planes)
variants += [("kernel", kernel), ("every", every)]
answers["kernel"] = kernel().cpu()
answers["every"] = every().cpu()
mesh = Mesh(inputs["verts0"].numpy(), inputs["faces"].numpy(), device=dev)
tree = mesh.compute_aabb_tree()
pts_np, nrm_np = inputs["pts"].numpy(), inputs["nrm"].numpy()
variants.append(("nearest", lambda: tree.nearest_alongnormal(pts_np,
                                                             nrm_np)))
answers["nearest"] = torch.as_tensor(
    tree.nearest_alongnormal(pts_np, nrm_np)[1].astype("int32"))[None]
""", ptxas=("alongnormal_faces", "alongnormal_faces_every") + SHARED,
    sass=SHARED)


def inputs():
    """chip_smoke.py phase 8's inputs, made on the card and kept on the
    CPU: posed body 0, the faces, the scan points and normals."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mesh_tpu_torch.models import lbs, synthetic_body_model

    dev = torch.device("cuda")
    model = synthetic_body_model(seed=0, device=dev)
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(cs.BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(cs.BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    verts, _ = lbs(model, betas[:1], pose[:1], device=dev)
    pts, nrm = cs.registration_inputs(verts[0], model.faces,
                                      np.random.RandomState(1))
    return {"verts0": verts[0].cpu(), "faces": model.faces.cpu(),
            "pts": pts.cpu(), "nrm": nrm.cpu()}


def main():
    ap = parser(__doc__)
    ap.add_argument("--splits", default="1,4,8,16,32")
    args = ap.parse_args()
    run("ab_along", args, SIDE, inputs, same_as_first("kernel"),
        extra=[args.splits], sass=SHARED,
        needs="mesh_tpu_torch/query/ray_kernel.py")


if __name__ == "__main__":
    main()
