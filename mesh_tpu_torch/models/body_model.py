"""Linear-blend-skinning body model, SMPL architecture (counterpart of
mesh_tpu/models/body_model.py: ``BodyModel``, ``lbs``, ``_uv_sphere``,
``smpl_sized_sphere``, ``synthetic_body_model``, ``_parametric_sphere``,
``MODEL_FAMILIES`` and ``synthetic_family_model``).

``BodyModel`` is an ``nn.Module`` whose weights are buffers, so ``.to()``
moves them together.  ``synthetic_body_model`` draws its weights with the
reference's numpy code, so one seed gives bit-identical arrays in both
packages.  Layout: V vertices, J joints, B shape coefficients.
"""

import contextlib

import numpy as np
import torch
from torch import nn

from ..geometry.rodrigues import rodrigues2rotmat_t
from ..utils.device import resolve_device

#: buffer names in the reference dataclass's field order
WEIGHT_NAMES = ("v_template", "shapedirs", "posedirs", "joint_regressor",
                "lbs_weights", "faces")


class BodyModel(nn.Module):
    """Model weights as buffers; ``parents`` is the static kinematic tree
    (``parents[0] == -1``).

    Buffers: v_template (V, 3), shapedirs (V, 3, B), posedirs
    (V, 3, 9*(J-1)), joint_regressor (J, V), lbs_weights (V, J), faces
    (F, 3) int32.
    """

    def __init__(self, v_template, shapedirs, posedirs, joint_regressor,
                 lbs_weights, faces, parents):
        super().__init__()
        for name, value in zip(WEIGHT_NAMES, (
                v_template, shapedirs, posedirs, joint_regressor,
                lbs_weights, faces)):
            self.register_buffer(name, value)
        self.parents = tuple(int(p) for p in parents)

    @property
    def num_vertices(self):
        return self.v_template.shape[0]

    @property
    def num_joints(self):
        return self.joint_regressor.shape[0]

    @property
    def num_betas(self):
        return self.shapedirs.shape[-1]


def body_model_from_arrays(arrays, parents, device="cuda", dtype=None):
    """A ``BodyModel`` from a dict of numpy arrays keyed by WEIGHT_NAMES.

    With ``dtype=None`` every array keeps its own dtype, so float32 weights
    arrive bit for bit; otherwise the float weights are cast to ``dtype``
    by numpy (faces are always int32)."""
    dev = resolve_device(device)
    tensors = []
    for name in WEIGHT_NAMES:
        a = np.asarray(arrays[name])
        if name == "faces":
            a = a.astype(np.int32)
        elif dtype is not None:
            a = a.astype(torch.empty((), dtype=dtype).numpy().dtype)
        tensors.append(torch.from_numpy(np.array(a, order="C")).to(dev))
    return BodyModel(*tensors, parents=parents)


def _with_homogeneous_row(R, t):
    """Stack (..., 3, 3) rotation and (..., 3) translation into (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)                # (..., 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _check_model_device(model, dev):
    have = model.v_template.device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError("the model's buffers are on %s, not on %s: move it "
                         "with model.to(device)" % (have, dev))


@contextlib.contextmanager
def _no_tf32():
    """Full float32 matmuls and cuDNN inside the block; the caller's TF32
    settings are restored on the way out."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def lbs(model, betas, pose, trans=None, device="cuda"):
    """Linear blend skinning forward pass.

    :param betas: (..., B) shape coefficients
    :param pose: (..., J, 3) axis-angle per joint (joint 0 = global rotation)
    :param trans: optional (..., 3) root translation
    :param device: where to run; the model must already live there
    :returns: (vertices (..., V, 3), joints (..., J, 3))

    The reference runs its products at ``Precision.HIGHEST``; here TF32 is
    off for matmuls and cuDNN during the call, so float32 products stay
    float32.
    """
    dev = resolve_device(device)
    _check_model_device(model, dev)
    with _no_tf32():
        return _lbs(model, betas, pose, trans, dev)


def _lbs(model, betas, pose, trans, dev):
    dtype = model.v_template.dtype
    betas = torch.as_tensor(betas, dtype=dtype, device=dev)
    pose = torch.as_tensor(pose, dtype=dtype, device=dev)

    # 1. shape blendshapes
    v_shaped = model.v_template + torch.einsum(
        "vcb,...b->...vc", model.shapedirs, betas)
    # 2. joint locations from the shaped body
    joints = torch.einsum("jv,...vc->...jc", model.joint_regressor, v_shaped)
    # 3. per-joint rotations + pose blendshapes
    R = rodrigues2rotmat_t(pose)                                # (..., J, 3, 3)
    eye = torch.eye(3, dtype=dtype, device=dev)
    pose_feature = (R[..., 1:, :, :] - eye).reshape(pose.shape[:-2] + (-1,))
    v_posed = v_shaped + torch.einsum(
        "vcp,...p->...vc", model.posedirs, pose_feature)
    # 4. forward kinematics down the static tree
    parents = model.parents
    world = [_with_homogeneous_row(R[..., 0, :, :], joints[..., 0, :])]
    for j in range(1, model.num_joints):
        local = _with_homogeneous_row(
            R[..., j, :, :], joints[..., j, :] - joints[..., parents[j], :])
        world.append(torch.matmul(world[parents[j]], local))
    G = torch.stack(world, dim=-3)                              # (..., J, 4, 4)
    posed_joints = G[..., :3, 3]
    # 5. remove the rest-pose joint offset: A_j = G_j - [0 | G_j[:3,:3] j_rest]
    correction = torch.einsum("...jab,...jb->...ja", G[..., :3, :3], joints)
    A = _with_homogeneous_row(G[..., :3, :3], G[..., :3, 3] - correction)
    # 6. skinning: blend joint transforms per vertex and apply
    T = torch.einsum("vj,...jab->...vab", model.lbs_weights, A)
    v_out = (torch.einsum("...vab,...vb->...va", T[..., :3, :3], v_posed)
             + T[..., :3, 3])
    if trans is not None:
        trans = torch.as_tensor(trans, dtype=dtype, device=dev)[..., None, :]
        v_out = v_out + trans
        posed_joints = posed_joints + trans
    return v_out, posed_joints


def _uv_sphere(n_seg, n_ring):
    """Unit UV-sphere: n_ring latitude rings x n_seg segments + 2 poles
    -> (n_seg * n_ring + 2 vertices, 2 * n_seg * n_ring faces)."""
    theta = np.pi * (np.arange(1, n_ring + 1)) / (n_ring + 1)
    phi = 2 * np.pi * np.arange(n_seg) / n_seg
    rings = np.stack(
        [
            np.outer(np.sin(theta), np.cos(phi)),
            np.outer(np.sin(theta), np.sin(phi)),
            np.outer(np.cos(theta), np.ones(n_seg)),
        ],
        axis=-1,
    ).reshape(-1, 3)
    v = np.vstack([[[0, 0, 1.0]], rings, [[0, 0, -1.0]]])
    faces = []
    for r in range(n_ring - 1):
        base0 = 1 + r * n_seg
        base1 = 1 + (r + 1) * n_seg
        for s in range(n_seg):
            s1 = (s + 1) % n_seg
            faces.append([base0 + s, base1 + s, base1 + s1])
            faces.append([base0 + s, base1 + s1, base0 + s1])
    for s in range(n_seg):  # pole fans
        s1 = (s + 1) % n_seg
        faces.append([0, 1 + s, 1 + s1])
        last = 1 + (n_ring - 1) * n_seg
        faces.append([len(v) - 1, last + s1, last + s])
    return v, np.array(faces, dtype=np.int32)


def smpl_sized_sphere():
    """A UV-sphere with exactly SMPL's vertex/face counts (6890 v, 13776 f):
    84 latitude rings x 82 segments + 2 poles."""
    v, f = _uv_sphere(82, 84)
    assert v.shape == (6890, 3) and f.shape == (13776, 3)
    return v, f


def synthetic_body_arrays(seed=0, n_betas=10, n_joints=24, template=None):
    """The reference's synthetic weights as float64 numpy arrays, plus the
    kinematic tree: ``(arrays keyed by WEIGHT_NAMES, parents)``.

    Joint centers lie along a chain inside the body; skinning weights are a
    softmax over vertex-to-joint distances; blendshape magnitudes roughly
    match SMPL's (cm scale)."""
    rng = np.random.RandomState(seed)
    if template is None:
        v, f = smpl_sized_sphere()
        v = v * np.array([0.3, 0.2, 0.9])  # body-ish proportions, meters
    else:
        v, f = template
    n_v = v.shape[0]

    # kinematic chain: root at centroid, children spread along +z
    parents = [-1] + [max(0, j - 1 + (0 if j < 3 else rng.randint(-2, 1)))
                      for j in range(1, n_joints)]
    z_span = np.linspace(v[:, 2].min(), v[:, 2].max(), n_joints)
    joint_centers = np.stack(
        [0.05 * rng.randn(n_joints), 0.05 * rng.randn(n_joints), z_span],
        axis=1)
    # joint regressor: normalized RBF of vertices around each center
    d2 = ((v[None, :, :] - joint_centers[:, None, :]) ** 2).sum(-1)
    reg = np.exp(-d2 / 0.02)
    joint_regressor = reg / reg.sum(axis=1, keepdims=True)
    # skinning weights: softmax over -distance to joints
    w = np.exp(-d2.T / 0.05)
    lbs_weights = w / w.sum(axis=1, keepdims=True)
    # smooth random blendshapes (low-frequency via joint-space mixing)
    shape_basis = reg.T @ rng.randn(n_joints, 3 * n_betas) * 0.5
    shapedirs = shape_basis.reshape(n_v, 3, n_betas) * 0.3
    posedirs = (reg.T @ rng.randn(n_joints, 3 * 9 * (n_joints - 1))).reshape(
        n_v, 3, 9 * (n_joints - 1)
    ) * 0.01
    arrays = dict(v_template=v, shapedirs=shapedirs, posedirs=posedirs,
                  joint_regressor=joint_regressor, lbs_weights=lbs_weights,
                  faces=f)
    return arrays, parents


def synthetic_body_model(seed=0, n_betas=10, n_joints=24, template=None,
                         dtype=torch.float32, device="cuda"):
    """A well-formed random body model for tests and benchmarks, with the
    same weights as mesh_tpu's ``synthetic_body_model(seed)``."""
    arrays, parents = synthetic_body_arrays(seed, n_betas, n_joints, template)
    return body_model_from_arrays(arrays, parents, device=device, dtype=dtype)


def _parametric_sphere(n_v_target):
    """A UV-sphere with exactly ``n_v_target`` vertices, proportioned like
    ``smpl_sized_sphere``: the near-square rings x segments + 2 grid not
    above the target (n_seg closest to sqrt(target)), then the remainder,
    at most n_seg - 1 vertices, by centroid face splits (1 face -> 3,
    projected back to the sphere)."""
    root = float(np.sqrt(max(n_v_target - 2, 1)))
    best = None
    for n_seg in range(3, 400):
        n_ring = (n_v_target - 2) // n_seg
        if n_ring >= 3:
            if best is None or abs(n_seg - root) < abs(best[0] - root):
                best = (n_seg, n_ring)
    if best is None:
        raise ValueError("n_v_target too small: %d" % n_v_target)
    n_seg, n_ring = best
    v, f = _uv_sphere(n_seg, n_ring)
    faces = f.tolist()
    v = list(v)
    n_extra = n_v_target - len(v)
    stride = max(1, len(faces) // max(n_extra, 1))
    for k in range(n_extra):
        fi = (k * stride) % len(faces)
        a, b, c = faces[fi]
        centroid = (np.asarray(v[a]) + v[b] + v[c]) / 3.0
        centroid = centroid / np.linalg.norm(centroid)
        new = len(v)
        v.append(centroid)
        faces[fi] = [a, b, new]
        faces.append([b, c, new])
        faces.append([c, a, new])
    v = np.asarray(v)
    assert len(v) == n_v_target
    return v, np.array(faces, dtype=np.int32)


#: (vertices, joints, betas) of the SMPL-family architectures that
#: ``synthetic_family_model`` reproduces
MODEL_FAMILIES = {
    "smpl": (6890, 24, 10),
    "smplx": (10475, 55, 10),
    "flame": (5023, 5, 100),
    "mano": (778, 16, 10),
}

#: template proportions (metres) of the families built on _parametric_sphere
_FAMILY_SCALE = {"smplx": [0.3, 0.2, 0.9], "flame": [0.09, 0.12, 0.1],
                 "mano": [0.04, 0.09, 0.02]}


def synthetic_family_model(family, seed=0, dtype=torch.float32,
                           device="cuda"):
    """A synthetic model with the exact (V, J, B) architecture of a named
    SMPL-family member ("smpl", "smplx", "flame", "mano"), with the same
    weights as mesh_tpu's ``synthetic_family_model(family, seed)``."""
    try:
        n_v, n_joints, n_betas = MODEL_FAMILIES[family]
    except KeyError:
        raise ValueError("unknown family %r (have %s)"
                         % (family, sorted(MODEL_FAMILIES))) from None
    template = None    # smpl: smpl_sized_sphere, as synthetic_body_model
    if family != "smpl":
        v, f = _parametric_sphere(n_v)
        template = (v * np.array(_FAMILY_SCALE[family]), f)
    return synthetic_body_model(seed=seed, n_betas=n_betas, n_joints=n_joints,
                                template=template, dtype=dtype, device=device)
