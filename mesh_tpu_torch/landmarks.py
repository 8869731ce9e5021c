"""Named landmark points on a mesh (counterpart of mesh_tpu/landmarks.py;
reference mesh/landmarks.py).

Landmarks live in two forms: raw xyz (`landm_raw_xyz`), and mesh-attached
forms that survive deformation — nearest vertex indices (`landm`) and
barycentric regressors (`landm_regressors`: name -> (3 vertex indices,
3 coefficients)).  Recomputing indices runs the closest-vertex and
closest-face kernels on the mesh's device through the Mesh facade
(landmarks.py:45-65 in the reference runs the C++ AABB stack here).
"""

import logging

import numpy as np

from .utils import col, sparse

log = logging.getLogger(__name__)


def landm_xyz_linear_transform(self, ordering=None):
    """Sparse (3L x 3V) matrix mapping flattened vertices to flattened
    landmark locations (reference landmarks.py:15-33)."""
    landmark_order = ordering if ordering else self.landm_names
    if not landmark_order:
        return np.zeros((0, 0))
    if hasattr(self, "landm_regressors") and self.landm_regressors:
        coeffs = np.hstack([self.landm_regressors[name][1] for name in landmark_order])
        indices = np.hstack([self.landm_regressors[name][0] for name in landmark_order])
        column_indices = np.hstack(
            [col(3 * indices + i) for i in range(3)]
        ).flatten()
        row_indices = np.hstack(
            [
                [3 * index, 3 * index + 1, 3 * index + 2]
                * len(self.landm_regressors[landmark_order[index]][0])
                for index in np.arange(len(landmark_order))
            ]
        )
        values = np.hstack([col(coeffs) for _ in range(3)]).flatten()
        return sparse(row_indices, column_indices, values,
                      3 * len(landmark_order), 3 * self.v.shape[0])
    elif hasattr(self, "landm"):
        indices = np.array([self.landm[name] for name in landmark_order])
        column_indices = np.hstack(
            [col(3 * indices + i) for i in range(3)]
        ).flatten()
        row_indices = np.arange(3 * len(landmark_order))
        return sparse(row_indices, column_indices, np.ones(len(column_indices)),
                      3 * len(landmark_order), 3 * self.v.shape[0])
    return np.zeros((0, 0))


def recompute_landmark_indices(self, landmark_fname=None, safe_mode=True):
    """Snap raw xyz landmarks to the mesh: nearest vertex index + barycentric
    regressor on the nearest face (reference landmarks.py:45-65)."""
    filtered_landmarks = dict(
        filter(
            lambda e: e[1] != [0.0, 0.0, 0.0],
            self.landm_raw_xyz.items(),
        )
        if (landmark_fname and safe_mode)
        else self.landm_raw_xyz.items()
    )
    if len(filtered_landmarks) != len(self.landm_raw_xyz):
        log.warning(
            "%d landmarks in file %s are positioned at (0.0, 0.0, 0.0)"
            " and were ignored",
            len(self.landm_raw_xyz) - len(filtered_landmarks), landmark_fname,
        )
    self.landm = {}
    self.landm_regressors = {}
    if filtered_landmarks:
        names = list(filtered_landmarks.keys())
        xyz = np.array(list(filtered_landmarks.values()), dtype=np.float64).reshape(-1, 3)
        closest, _ = self.closest_vertices(xyz)
        self.landm = dict(zip(names, np.asarray(closest).tolist()))
        if len(self.f):
            face_indices, closest_points = self.closest_faces_and_points(xyz)
            vertex_indices, coefficients = self.barycentric_coordinates_for_points(
                closest_points, face_indices
            )
            self.landm_regressors = dict(
                (name, (vertex_indices[i], coefficients[i]))
                for i, name in enumerate(names)
            )
        else:
            self.landm_regressors = dict(
                (name, (np.array([self.landm[name]]), np.array([1.0])))
                for name in names
            )


def landm_xyz(self, ordering=None):
    """Current landmark locations as a name -> xyz dict, evaluated through
    the sparse regressor so they track vertex deformation (reference
    landmarks.py:37-42)."""
    order = ordering if ordering else self.landm_names
    if not order:
        return {}
    locations = (
        landm_xyz_linear_transform(self, order) * np.asarray(self.v).flatten()
    ).reshape(-1, 3)
    return dict(zip(order, locations))


def set_landmarks_from_xyz(self, landm_raw_xyz):
    self.landm_raw_xyz = (
        landm_raw_xyz
        if hasattr(landm_raw_xyz, "keys")
        else dict((str(i), l) for i, l in enumerate(landm_raw_xyz))
    )
    self.recompute_landmark_indices()


def is_vertex(x):
    return hasattr(x, "__len__") and len(x) == 3


def is_index(x):
    return isinstance(x, (int, np.integer))


def set_landmarks_from_raw(self, landmarks):
    """Accept dicts or lists of xyz triples or vertex indices
    (reference landmarks.py:81-102)."""
    landmarks = (
        landmarks
        if hasattr(landmarks, "keys")
        else dict((str(i), l) for i, l in enumerate(landmarks))
    )
    if all(is_vertex(x) for x in landmarks.values()):
        landmarks = dict((i, np.array(l)) for i, l in landmarks.items())
        set_landmarks_from_xyz(self, landmarks)
    elif all(is_index(x) for x in landmarks.values()):
        self.landm = landmarks
        self.recompute_landmark_xyz()
    else:
        raise ValueError("Can't parse landmarks")
