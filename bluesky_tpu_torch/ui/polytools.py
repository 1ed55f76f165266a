"""Polygon triangulation for filled shapes (reference ui/polytools.py).

Port of ``bluesky_tpu/ui/polytools.py``: host code, copied unchanged.

The reference tessellates polygons with OpenGL GLU's tessellator
(polytools.py:16-26) into a triangle vertex buffer for the GL fill pass.
This framework draws headless (SVG/streams) but keeps the same capability
— a contour set to triangle buffer — with a pure-NumPy ear-clipping
triangulator instead of GLU, so filled AREA/POLY shapes can be rendered
by any backend (and tested without a GL context).

API mirrors the reference ``PolygonSet``: ``addContour`` accumulates
contours of the current polygon, ``bufsize``/``vbuf`` expose the triangle
buffer (flat [x0,y0, x1,y1, ...] like the GLU vertex callback produced).
Holes (nested contours) are not supported — the reference's use sites
(areafilter shapes, coastline fills) pass simple contours.
"""
from typing import List

import numpy as np


def _signed_area(pts):
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _any_point_in_tri(pts, a, b, c, eps=1e-12):
    """True if ANY of pts [k,2] lies inside/on triangle (a,b,c) —
    vectorized so the ear test is O(n) NumPy, not O(n) Python."""
    if len(pts) == 0:
        return False

    def cross(o, u, v):
        return (u[0] - o[0]) * (v[:, 1] - o[1]) \
            - (u[1] - o[1]) * (v[:, 0] - o[0])

    d1 = cross(a, b, pts)
    d2 = cross(b, c, pts)
    d3 = cross(c, a, pts)
    # Callers only test strictly convex CCW ears, so inside/on-edge is
    # "no edge sees the point on its right": all three cross products
    # non-negative (within eps).  A mixed-sign point is strictly outside
    # and must NOT veto the ear (collinear-vertex polygons would
    # otherwise bail early with a partial triangle buffer).
    inside = (d1 >= -eps) & (d2 >= -eps) & (d3 >= -eps)
    return bool(np.any(inside))


def earclip(contour) -> List[float]:
    """Triangulate a simple polygon; returns flat [x,y]*3 per triangle.

    contour: iterable of (x, y) or flat [x0, y0, x1, y1, ...].
    """
    pts = np.asarray(contour, float)
    if pts.ndim == 1:
        pts = pts.reshape(-1, 2)
    # Drop consecutive duplicates (incl. a closing repeat of the start)
    keep = np.ones(len(pts), bool)
    keep[1:] = np.any(pts[1:] != pts[:-1], axis=1)
    pts = pts[keep]
    if len(pts) > 1 and np.all(pts[0] == pts[-1]):
        pts = pts[:-1]
    n = len(pts)
    if n < 3:
        return []
    if _signed_area(pts) < 0.0:          # enforce CCW winding
        pts = pts[::-1]

    idx = list(range(n))
    tris: List[float] = []
    guard = 0
    while len(idx) > 3 and guard < 2 * n * n:
        guard += 1
        ear_found = False
        for k in range(len(idx)):
            i0, i1, i2 = (idx[k - 1], idx[k], idx[(k + 1) % len(idx)])
            a, b, c = pts[i0], pts[i1], pts[i2]
            # Convex corner?
            if (b[0] - a[0]) * (c[1] - a[1]) \
                    - (b[1] - a[1]) * (c[0] - a[0]) <= 0.0:
                continue
            # No other active vertex inside the candidate ear
            others = pts[[j for j in idx if j not in (i0, i1, i2)]]
            if _any_point_in_tri(others, a, b, c):
                continue
            tris.extend([*a, *b, *c])
            del idx[k]
            ear_found = True
            break
        if not ear_found:     # degenerate (self-intersecting) remainder
            break
    if len(idx) == 3:
        a, b, c = pts[idx[0]], pts[idx[1]], pts[idx[2]]
        tris.extend([*a, *b, *c])
    return tris


class PolygonSet:
    """Contour collection -> triangle vertex buffer (reference
    polytools.py:6-121, GLU tessellator replaced by ear clipping)."""

    def __init__(self):
        self.vbuf: List[float] = []

    def bufsize(self) -> int:
        return len(self.vbuf)

    def addContour(self, contour):
        """Triangulate one closed contour into the buffer."""
        self.vbuf.extend(earclip(contour))

    # The reference's begin/end/beginContour/endContour manage GLU
    # tessellator state; with ear clipping they are no-ops kept for
    # call-site compatibility.
    def begin(self):
        pass

    def end(self):
        pass

    def beginContour(self):
        pass

    def endContour(self):
        pass
