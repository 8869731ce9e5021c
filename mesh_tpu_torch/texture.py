"""Texture handling (counterpart of mesh_tpu/texture.py; reference
mesh/texture.py).

Image IO stays host-side (cv2, imported only when an image is read: BGR
order, pow2-size snapping); the per-vertex UV gather `texture_rgb_vec` is
vectorized numpy as in the reference (texture.py:99-107).  The textured
templates ship with the port (``texture_path``).
"""

import os

import numpy as np

__all__ = ["texture_coordinates_by_vertex"]


def texture_coordinates_by_vertex(self):
    tc_by_vertex = [[] for _ in range(len(self.v))]
    for i, face in enumerate(np.asarray(self.f)):
        for j in (0, 1, 2):
            tc_by_vertex[face[j]].append(np.asarray(self.vt)[np.asarray(self.ft)[i][j]])
    return tc_by_vertex


def reload_texture_image(self):
    import cv2

    # loaded height x width x 3, BGR order (reference texture.py:26-36)
    self._texture_image = (
        cv2.imread(self.texture_filepath) if self.texture_filepath else None
    )
    texture_sizes = [32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384]
    im = self._texture_image
    if im is not None and (
        im.shape[0] != im.shape[1] or im.shape[0] not in texture_sizes
    ):
        closest = (np.abs(np.array(texture_sizes) - max(im.shape))).argmin()
        sz = texture_sizes[closest]
        self._texture_image = cv2.resize(im, (sz, sz))


def load_texture(self, texture_version):
    """Load a numbered textured-template OBJ from the package texture_path
    (reference texture.py:39-55)."""
    from . import texture_path
    from .mesh import Mesh

    lowres = os.path.join(
        texture_path, "textured_template_low_v%d.obj" % texture_version
    )
    highres = os.path.join(
        texture_path, "textured_template_high_v%d.obj" % texture_version
    )
    mesh_with_texture = Mesh(filename=lowres, device=self.device)
    if not np.all(mesh_with_texture.f.shape == self.f.shape):
        mesh_with_texture = Mesh(filename=highres, device=self.device)
    self.transfer_texture(mesh_with_texture)


def transfer_texture(self, mesh_with_texture):
    """Copy vt/ft from a topology-matched mesh, tolerating flipped or
    reordered faces (reference texture.py:58-87)."""
    if not np.all(mesh_with_texture.f.shape == self.f.shape):
        raise ValueError("Mesh topology mismatch")

    self.vt = np.asarray(mesh_with_texture.vt).copy()
    self.ft = np.asarray(mesh_with_texture.ft).copy()
    src_f = np.asarray(mesh_with_texture.f)
    dst_f = np.asarray(self.f)

    if not np.all(src_f == dst_f):
        if np.all(src_f == np.fliplr(dst_f)):
            self.ft = np.fliplr(self.ft)
        else:
            face_mapping = {}
            for ii, face in enumerate(dst_f):
                face_mapping[tuple(sorted(face))] = ii
            new_ft = np.zeros(dst_f.shape, dtype=np.uint32)
            for face, ft_row in zip(src_f, np.asarray(mesh_with_texture.ft)):
                key = tuple(sorted(face))
                if key not in face_mapping:
                    raise ValueError("Mesh topology mismatch")
                target = face_mapping[key]
                ids = np.array(
                    [np.where(dst_f[target] == f_id)[0][0] for f_id in face]
                )
                new_ft[target] = ft_row[ids]
            self.ft = new_ft

    self.texture_filepath = mesh_with_texture.texture_filepath
    self._texture_image = None


def set_texture_image(self, path_to_texture):
    self.texture_filepath = path_to_texture


def texture_rgb(self, texture_coordinate):
    h, w = np.array(self.texture_image.shape[:2]) - 1
    return np.double(
        self.texture_image[int(h * (1.0 - texture_coordinate[1]))][
            int(w * texture_coordinate[0])
        ]
    )[::-1]


def texture_rgb_vec(self, texture_coordinates):
    """Flat-index gather of RGB values for N texture coords, clipped to [0,1]
    (reference texture.py:99-107)."""
    h, w = np.array(self.texture_image.shape[:2]) - 1
    n_ch = self.texture_image.shape[2]
    d1 = (h * (1.0 - np.clip(texture_coordinates[:, 1], 0, 1))).astype(np.int64)
    d0 = (w * np.clip(texture_coordinates[:, 0], 0, 1)).astype(np.int64)
    flat_texture = self.texture_image.flatten()
    indices = np.hstack(
        [
            ((d1 * (w + 1) * n_ch) + (d0 * n_ch) + (2 - i)).reshape(-1, 1)
            for i in range(n_ch)
        ]
    )
    return flat_texture[indices]
