"""Analytic sphere primitive (counterpart of mesh_tpu/sphere.py; reference
mesh/sphere.py).

The reference hardcodes a 42-vertex icosphere table; here the same mesh is
generated: an icosahedron subdivided once with midpoints projected onto the
unit sphere (42 vertices, 80 faces).
"""

import numpy as np

from .colors import name_to_rgb
from .mesh import Mesh

__all__ = ["Sphere"]


def _icosphere(subdivisions=1):
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    v /= np.linalg.norm(v[0])
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        verts = list(v)
        midpoint_cache = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in midpoint_cache:
                m = (v[i] + v[j]) / 2.0
                m /= np.linalg.norm(m)
                midpoint_cache[key] = len(verts)
                verts.append(m)
            return midpoint_cache[key]

        new_f = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_f += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.array(verts)
        f = np.array(new_f, dtype=np.int64)
    return v, f


class Sphere(object):
    def __init__(self, center, radius):
        center = np.asarray(center)
        if center.flatten().shape != (3,):
            raise ValueError(
                "Center should have size(1,3) instead of %s" % (center.shape,)
            )
        self.center = center.flatten()
        self.radius = radius

    def __str__(self):
        return "%s:%s" % (self.center, self.radius)

    def to_mesh(self, color=name_to_rgb["red"], *, device="cuda"):
        """The sphere as a 42-vertex, 80-face Mesh on ``device``."""
        v, f = _icosphere(1)
        return Mesh(
            v=v * self.radius + self.center,
            f=f,
            vc=np.tile(color, (v.shape[0], 1)),
            device=device,
        )

    def has_inside(self, point):
        return np.linalg.norm(point - self.center) <= self.radius

    def intersects(self, sphere):
        return np.linalg.norm(sphere.center - self.center) < (self.radius + sphere.radius)

    def intersection_vol(self, sphere):
        """Lens volume of two overlapping spheres
        (mathworld.wolfram.com/Sphere-SphereIntersection.html)."""
        if not self.intersects(sphere):
            return 0
        d = np.linalg.norm(sphere.center - self.center)
        R, r = (
            (self.radius, sphere.radius)
            if self.radius > sphere.radius
            else (sphere.radius, self.radius)
        )
        if R >= (d + r):
            return (4 * np.pi * (r ** 3)) / 3
        return (
            np.pi
            * (R + r - d) ** 2
            * (d ** 2 + 2 * d * r - 3 * r * r + 2 * d * R + 6 * r * R - 3 * R * R)
        ) / (12 * d)
