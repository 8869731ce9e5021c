#!/usr/bin/env python3
"""A/B timing of mesh_tpu_torch's contact kernel (tri_tri_any_hit, the
Moller tile) and of the contact calls around it, in two checkouts, on one
CUDA card, in one run.

    python3 tools/ab_tri_tri.py --other DIR [--pairs 4] [--rounds 5]
                                [--reps 10] [--splits 1,8,16,32,64]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, such as ``build/parent``); the pairs, processes, medians and checks
are ``tools/ab_common.py``'s.  The inputs are chip_smoke.py phase 9's, made
with its seeds and shapes: the MANO-sized hand (1,552 faces) against the
SMPL-sized body (13,776 faces), the Moller tile.  A process times
``tri_tri_any_hit`` on operands made beforehand (``kernel``: where the
checkout has the cull, its operands are made beforehand; ``with_operands``
times the call that makes them, as the facade's does, and ``operands`` the
operands alone, both after the variants that both sides have, with the
splits), the every-pair kernel (``every``: the checkout's
``tri_tri_any_hit_every``, or its ``tri_tri_any_hit`` where it has no
cull), each split of ``--splits`` (``split<n>``), row 10's
self-intersection kernel on the body (``self_intersect``) and row 1's
closest-face kernel on 65,536 N(0, 0.4) queries against it
(``closest_faces``, its cull operands made beforehand), which must not
move, and phase 9's warm calls: ``AabbTree.intersections_indices``
(``intersections``) and the contact step (``contact_step``: the
intersecting faces, then the signed gap).  It reports the register and
spill lines of the contact kernels and of rows 10 and 1 (``SHARED``), whose
SASS must be the same on both sides: row 10's margin moved into a shared
header.  Every flag and first hit must equal the first process's kernel's,
across variants, processes and sides, and every other answer the first
process's.
"""

import os
import sys

from ab_common import parser, run, side_program

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the kernels of rows 10 and 1, whose code this change must leave as it
#: was: both sides' SASS of each is compared
SHARED = ("self_intersect", "closest_faces")

#: the answers that hold a flag and a first hit per hand face, each equal
#: to the first process's kernel's
FLAGS = ("kernel", "every")

#: what each side's process runs, from its own checkout
SIDE = side_program(r"""
import numpy as np
import chip_smoke as cs
from mesh_tpu_torch.mesh import Mesh
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import tri_tri_kernel as tk

splits = [int(s) for s in extra[0].split(",")]
dev = torch.device("cuda")
# the faces as phase 9 holds them (uint32), the hand's vertices float64
body_v = inputs["body_v"].numpy()
body_f = inputs["body_f"].numpy().astype(np.uint32)
hand_v = inputs["hand_v"].numpy()
hand_f = inputs["hand_f"].numpy().astype(np.uint32)
hand_tri = torch.as_tensor(hand_v.astype(np.float32), device=dev)[
    torch.as_tensor(hand_f.astype(np.int64), device=dev)]
body_tri = torch.as_tensor(body_v, device=dev)[
    torch.as_tensor(body_f.astype(np.int64), device=dev)]
qp, fp = tk.tri_tri_planes(hand_tri, body_tri, "moller")


def flags(out):
    return torch.stack([out[0].to(torch.int32), out[1]]).cpu()


if hasattr(tk, "tri_any_hit_operands"):
    ops = tk.tri_any_hit_operands(qp, fp)
    kernel = lambda: tk.tri_tri_any_hit(qp, fp, "moller", ops=ops)
    every = lambda: tk.tri_tri_any_hit_every(qp, fp, "moller")
    later += [
        ("with_operands", lambda: tk.tri_tri_any_hit(qp, fp, "moller")),
        ("operands", lambda: tk.tri_any_hit_operands(qp, fp))]
    later += [("split%d" % s, lambda s=s: tk.tri_tri_any_hit(
        qp, fp, "moller", ops=ops, split=s)) for s in splits]
    for s in splits:
        answers["split%d" % s] = flags(tk.tri_tri_any_hit(
            qp, fp, "moller", ops=ops, split=s))
else:
    kernel = every = lambda: tk.tri_tri_any_hit(qp, fp, "moller")
variants += [("kernel", kernel), ("every", every)]
answers["kernel"] = flags(kernel())
answers["every"] = flags(every())

# row 10 on the body, in its Morton order, and row 1 on the hand's vertices
order = tk.morton_face_order(body_tri)
ids = torch.as_tensor(body_f.astype(np.int32), device=dev)[order].contiguous()
sp, sf = tk.self_planes(body_tri[order], "moller")
variants.append(("self_intersect",
                 lambda: tk.self_intersect_counts(sp, sf, ids, "moller")))
answers["self_intersect"] = tk.self_intersect_counts(sp, sf, ids,
                                                     "moller").cpu()
queries = torch.as_tensor(np.random.RandomState(0).randn(1, 65536, 3) * 0.4,
                          dtype=torch.float32, device=dev)
pts, planes, _, _ = ck.closest_point_operands(
    torch.as_tensor(body_v, device=dev)[None],
    torch.as_tensor(body_f.astype(np.int64), device=dev), queries, "fast")
tail = not ck.mesh_is_nondegenerate(body_v, body_f)
cull = ck.cull_operands(pts, planes, "fast", tail)
variants.append(("closest_faces", lambda: ck.argmin_faces(
    pts, planes, "fast", tail, cull=cull)))
answers["closest_faces"] = ck.argmin_faces(pts, planes, "fast", tail,
                                           cull=cull).cpu()

# phase 9's warm calls
body = Mesh(body_v, body_f, device=dev)
hand = Mesh(hand_v, hand_f, device=dev)
tree = body.compute_aabb_tree()
variants.append(("intersections",
                 lambda: tree.intersections_indices(hand_v, hand_f)))
answers["intersections"] = torch.as_tensor(
    tree.intersections_indices(hand_v, hand_f))
variants.append(("contact_step", lambda: cs.contact_step(body, hand, dev)))
hits, signed = cs.contact_step(body, hand, dev)
answers["contact_step"] = torch.as_tensor(signed)
""", ptxas=("tri_tri_any_hit", "tri_records") + SHARED, sass=SHARED)


def inputs():
    """chip_smoke.py phase 9's meshes, made on the card and kept on the
    CPU: the body's and the hand's vertices and faces."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    body_v, body_f, hand_v, hand_f = cs.contact_inputs(torch.device("cuda"))
    return {"body_v": torch.as_tensor(body_v),
            "body_f": torch.as_tensor(body_f.astype(np.int64)),
            "hand_v": torch.as_tensor(hand_v),
            "hand_f": torch.as_tensor(hand_f.astype(np.int64))}


def check(paths):
    """The names of the answers that differ: the flags and first hits of
    every variant from the first process's kernel's, every other answer
    from the first process's own."""
    import torch

    runs = [torch.load(p) for p in paths]
    bad = set()
    for got in runs:
        for name, value in got.items():
            want = runs[0]["kernel" if name in FLAGS
                           or name.startswith("split") else name]
            if not torch.equal(value, want):
                bad.add(name)
    return sorted(bad)


def main():
    ap = parser(__doc__)
    ap.add_argument("--splits", default="1,8,16,32,64")
    args = ap.parse_args()
    run("ab_tri_tri", args, SIDE, inputs, check, extra=[args.splits],
        sass=SHARED, needs="mesh_tpu_torch/query/tri_tri_kernel.py")


if __name__ == "__main__":
    main()
