"""Polyline primitive (counterpart of mesh_tpu/lines.py; reference
mesh/lines.py)."""

import numpy as np

from .colors import expand_colors


class Lines(object):
    """Collection of 3D line segments.

    Attributes: v (Vx3 vertices), e (Ex2 edges), optional vc/ec colors.
    """

    def __init__(self, v, e, vc=None, ec=None):
        self.v = np.asarray(v).copy()
        self.e = np.asarray(e).copy()
        for given, setter in ((vc, self.set_vertex_colors),
                              (ec, self.set_edge_colors)):
            if given is not None:
                setter(given)

    def colors_like(self, color, arr):
        """One rgb row per row of `arr`; scalar weights map through the jet
        colormap (reference lines.py:28-48 semantics)."""
        return expand_colors(color, np.asarray(arr).shape[0])

    def set_vertex_colors(self, vc):
        self.vc = expand_colors(vc, len(self.v))

    def set_edge_colors(self, ec):
        self.ec = expand_colors(ec, len(self.e))

    def write_obj(self, filename):
        """Wavefront export: `v` records then 1-based `l` segment records
        (reference lines.py:56-61 format)."""
        records = ["v %f %f %f\n" % tuple(xyz) for xyz in self.v]
        records += ["l %d %d\n" % (int(a) + 1, int(b) + 1) for a, b in self.e]
        with open(filename, "w") as fh:
            fh.writelines(records)
