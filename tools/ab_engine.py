#!/usr/bin/env python3
"""A/B timing of the steps and facade calls that the query engine, the
fixed-order vertex normals and the batch-invariant centering touch, in two
checkouts, on one CUDA card, in one run.

    python3 tools/ab_engine.py --other DIR [--pairs 4] [--rounds 5]
                               [--reps 5]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``); the pairs, processes and medians are
``tools/ab_common.py``'s.  The inputs are chip_smoke.py's, made with its
seeds and shapes: phase 3's 256 posed SMPL-sized bodies and their 1024
queries each, phase 4's 4096 queries, phase 5's 64 bodies of the
98,304-face template with their 4096 queries, phase 7's four cameras.  A
process times, with CUDA events around ``--reps`` back-to-back calls:

- ``normals``: ``vert_normals_t`` of the 256 bodies;
- ``main_step``, ``large_step``, ``visibility_step``: ``batch_step`` at
  phase 3's and phase 5's shapes and ``visibility_step`` on 64 bodies x 4
  cameras, the steps phases 3, 5 and 7 time (without lbs);
- ``mesh_q1500``: ``Mesh.closest_faces_and_points`` on body 0 with 1500
  queries; ``closest_256x1024``, ``fused_256x1024``, ``normals_256`` and
  ``visibility_64x4``: the numpy facades at phase 15's shapes, each call
  ending in its host copy (a checkout with the engine routes them through
  it);
- ``centering_256x1024``, ``centering_1x100000``: the closest-point
  prologue's centering and corner gather (``closest_kernel._center_inputs``)
  at phase 3's shape and at phase 14's 100,000-point scan; beside them,
  the same code on both sides, the vertex mean of 256 and of 1 body as one
  ``torch.mean`` (``mean_*``) and as a pairwise tree of slice adds
  (``tree_*``);
- ``fit_forward_*``, ``fit_value_and_grad_*``: ``fit.scan_to_model_loss``
  at zero parameters under ``no_tf32``, without and with its gradient, at
  phase 14's two scans (256 N(0, 0.3) points; 100,000 surface samples).

The two sides' answers may differ at distance ties (the centering's
rounding moved), so each side's answers are held to its own first
process's: this checkout's bit for bit (a failure), the other's only
reported (a checkout whose normals add with ``index_add_``'s atomics
differs from run to run).
"""

import os
import sys

from ab_common import parser, run, side_order, side_program

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: what each side's process runs, from its own checkout
SIDE = side_program(r"""
import numpy as np
from mesh_tpu_torch.batch import (
    batch_step,
    batched_closest_faces_and_points,
    batched_vertex_normals,
    batched_vertex_visibility,
    fused_normals_and_closest_points,
    visibility_step,
)
from mesh_tpu_torch.geometry.vert_normals import vert_normals_t
from mesh_tpu_torch.mesh import Mesh
from mesh_tpu_torch.models import synthetic_body_model
from mesh_tpu_torch.models.body_model import no_tf32
from mesh_tpu_torch.parallel import fit
from mesh_tpu_torch.query.closest_kernel import (
    _center_inputs,
    mesh_is_nondegenerate,
)

dev = torch.device("cuda")
verts, f = inputs["verts"].to(dev), inputs["faces"].to(dev)
queries = inputs["queries"].to(dev)
verts_l, f_l = inputs["verts_l"].to(dev), inputs["faces_l"].to(dev)
queries_l = inputs["queries_l"].to(dev)
cams = inputs["cams"].to(dev)
posed, f_np = inputs["verts"].numpy(), inputs["faces"].numpy()
q_np, cams_np = inputs["queries"].numpy(), inputs["cams"].numpy()
nd = mesh_is_nondegenerate(posed, f_np)
nd_l = mesh_is_nondegenerate(inputs["verts_l"].numpy(),
                             inputs["faces_l"].numpy())
body0 = Mesh(posed[0], f_np, device=dev)
q1500 = inputs["q_facade"].numpy()[:1500]
model = synthetic_body_model(seed=0, device=dev)
params = [torch.zeros(shape, dtype=torch.float32, device=dev,
                      requires_grad=True)
          for shape in ((1, model.num_betas), (1, model.num_joints, 3),
                        (1, 3))]
scans = {n: inputs["scan_" + n].to(dev) for n in ("256", "100k")}


def fit_forward(scan):
    with torch.no_grad(), no_tf32():
        return fit.scan_to_model_loss(model, *params, scan, device=dev)


def fit_value_and_grad(scan):
    with no_tf32():
        loss = fit.scan_to_model_loss(model, *params, scan, device=dev)
        return loss, torch.autograd.grad(loss, params)




def mean_tree(x):
    # the per-mesh vertex mean as a pairwise tree of slice adds
    n = x.shape[-2]
    while x.shape[-2] > 1:
        m = x.shape[-2]
        half = x[..., :m // 2, :] + x[..., m // 2:2 * (m // 2), :]
        x = torch.cat([half, x[..., m - 1:, :]], dim=-2) if m % 2 else half
    return x / n


variants += [
    ("normals", lambda: vert_normals_t(verts, f)),
    ("main_step", lambda: batch_step(verts, f, queries,
                                     assume_nondegenerate=nd)),
    ("large_step", lambda: batch_step(verts_l, f_l, queries_l,
                                      assume_nondegenerate=nd_l)),
    ("visibility_step", lambda: visibility_step(verts[:64], f, cams,
                                                min_dist=1e-3)),
    ("mesh_q1500", lambda: body0.closest_faces_and_points(q1500)),
    ("closest_256x1024", lambda: batched_closest_faces_and_points(
        (posed, f_np), q_np, device=dev)),
    ("fused_256x1024", lambda: fused_normals_and_closest_points(
        (posed, f_np), q_np, device=dev)),
    ("normals_256", lambda: batched_vertex_normals((posed, f_np),
                                                   device=dev)),
    ("visibility_64x4", lambda: batched_vertex_visibility(
        (posed[:64], f_np), cams_np, min_dist=1e-3, device=dev)),
    ("centering_256x1024", lambda: _center_inputs(verts, f, queries)),
    ("centering_1x100000", lambda: _center_inputs(verts[:1], f,
                                                  scans["100k"])),
    ("mean_256", lambda: verts.mean(dim=-2, keepdim=True)),
    ("mean_1", lambda: verts[:1].mean(dim=-2, keepdim=True)),
    ("tree_256", lambda: mean_tree(verts)),
    ("tree_1", lambda: mean_tree(verts[:1])),
]
for n, scan in scans.items():
    variants += [
        ("fit_forward_" + n, lambda scan=scan: fit_forward(scan)),
        ("fit_value_and_grad_" + n,
         lambda scan=scan: fit_value_and_grad(scan)),
    ]
normals_e, res = batch_step(verts, f, queries, assume_nondegenerate=nd)
answers["normals"] = normals_e.cpu()
answers["main_faces"] = res["face"].cpu()
answers["large_faces"] = batch_step(verts_l, f_l, queries_l,
                                    assume_nondegenerate=nd_l)[1][
                                        "face"].cpu()
answers["visibility"] = visibility_step(verts[:64], f, cams,
                                        min_dist=1e-3)[0].cpu()
answers["center"] = _center_inputs(verts, f, queries)[1].cpu()
answers["fit_loss_100k"] = fit_forward(scans["100k"]).cpu()
answers["mesh_q1500"] = torch.as_tensor(
    body0.closest_faces_and_points(q1500)[0].astype("int64"))
""")


def inputs():
    """chip_smoke.py's inputs of phases 3, 4, 5, 7 and 14, made on the
    card and kept on the CPU."""
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
    queries = torch.as_tensor(
        rng.randn(cs.BATCH, cs.QUERIES_PER_MESH, 3) * 0.4,
        dtype=torch.float32, device=dev)
    verts, _ = lbs(model, betas, pose, device=dev)
    q1 = torch.as_tensor(rng.randn(1, cs.FACADE_QUERIES, 3) * 0.4,
                         dtype=torch.float32)
    model_l, _, _, verts_l, queries_l = cs.large_batch_inputs(dev)
    scans = cs.fit_inputs(model, verts[0], dev)
    return {"scan_256": scans["bench_256"].cpu(),
            "scan_100k": scans["config5_100k"].cpu(),
"verts": verts.cpu(), "faces": model.faces.cpu(),
            "queries": queries.cpu(), "q_facade": q1[0],
            "verts_l": verts_l.cpu(), "faces_l": model_l.faces.cpu(),
            "queries_l": queries_l.cpu(),
            "cams": torch.tensor(cs.VIS_CAMERAS, dtype=torch.float32)}


def same_within_side(order):
    """A check of the answers: each process's answers against those of the
    first process of its own side (``order`` names each process's side).
    Prints the other side's differing names; returns this side's."""
    def check(paths):
        import torch

        first, bad = {}, {"this": set(), "other": set()}
        for side, path in zip(order, paths):
            got = torch.load(path)
            want = first.setdefault(side, got)
            bad[side].update(k for k in got
                             if not torch.equal(got[k], want[k]))
        print("answers that differ between the other side's processes: %s"
              % (sorted(bad["other"]) or "none"), flush=True)
        return sorted(bad["this"])
    return check


def main():
    ap = parser(__doc__)
    ap.set_defaults(reps=5)
    args = ap.parse_args()
    run("ab_engine", args, SIDE, inputs,
        same_within_side(side_order(args.pairs)))


if __name__ == "__main__":
    main()
