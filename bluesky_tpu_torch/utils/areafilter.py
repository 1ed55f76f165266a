"""Named geometric areas with vectorized inside-tests.

Parity with the reference ``bluesky/tools/areafilter.py:15-104``: named
BOX / CIRCLE / POLY / LINE shapes with optional altitude bounds, a
vectorized ``checkInside(name, lat, lon, alt)`` over aircraft arrays, and
shape mirroring to the screen object for display.

Port of ``bluesky_tpu/utils/areafilter.py``.  Divergences from the
reference, as in JAX:
* Shapes live in a registry object (no module-global mutable dict shared
  across sims) so parallel Simulation instances don't alias state; a
  module-level default registry keeps the reference's convenience API.
* Point-in-polygon is an explicit vectorized even-odd crossing test (the
  reference leans on ``matplotlib.path.Path.contains_points``).  Every
  shape's ``contains(lat, lon, alt)`` takes NumPy arrays (host samples
  at chunk edges) or tensors (a mask that stays on the state's device);
  the result is of the same kind.
"""
import numpy as np
import torch

from ..ops.geo import kwikdist_wrapped


class Shape:
    """Base: raw dict mirrors the reference Shape.raw for GUI streaming."""

    kind = "SHAPE"

    def __init__(self, name, coordinates, top=1e9, bottom=-1e9):
        self.name = name
        self.coordinates = list(coordinates)
        self.top = max(bottom, top)
        self.bottom = min(bottom, top)
        self.raw = dict(name=name, shape=self.kind.lower(),
                        coordinates=self.coordinates)

    def contains(self, lat, lon, alt):
        raise NotImplementedError


class Line(Shape):
    """Display-only: never contains anything (areafilter.py:52-58)."""
    kind = "LINE"

    def __init__(self, name, coordinates):
        super().__init__(name, coordinates)

    def contains(self, lat, lon, alt):
        return _false_like(lat)


class Box(Shape):
    kind = "BOX"

    def __init__(self, name, coordinates, top=1e9, bottom=-1e9):
        super().__init__(name, coordinates, top, bottom)
        lat0, lon0, lat1, lon1 = coordinates[:4]
        self.lat0, self.lat1 = min(lat0, lat1), max(lat0, lat1)
        self.lon0, self.lon1 = min(lon0, lon1), max(lon0, lon1)

    def contains(self, lat, lon, alt):
        return ((self.lat0 <= lat) & (lat <= self.lat1)
                & (self.lon0 <= lon) & (lon <= self.lon1)
                & (self.bottom <= alt) & (alt <= self.top))


class Circle(Shape):
    kind = "CIRCLE"

    def __init__(self, name, coordinates, top=1e9, bottom=-1e9):
        super().__init__(name, coordinates, top, bottom)
        self.clat, self.clon, self.r = coordinates[:3]   # radius in nm

    def contains(self, lat, lon, alt):
        dist = kwikdist_wrapped(self.clat, self.clon, lat, lon)
        return (dist <= self.r) & (self.bottom <= alt) & (alt <= self.top)


class Poly(Shape):
    kind = "POLY"

    def __init__(self, name, coordinates, top=1e9, bottom=-1e9):
        super().__init__(name, coordinates, top, bottom)
        pts = np.reshape(np.asarray(coordinates, np.float64), (-1, 2))
        self.plat = pts[:, 0]
        self.plon = pts[:, 1]

    def contains(self, lat, lon, alt):
        """Vectorized even-odd crossing test over all (point, edge) pairs:
        an [N, V] broadcast for V vertices and N points, tiny for
        realistic sector polygons, on the device of ``lat``."""
        y1, x1 = np.roll(self.plat, -1), np.roll(self.plon, -1)
        if isinstance(lat, torch.Tensor):
            t = lambda a: torch.as_tensor(a, dtype=lat.dtype,
                                          device=lat.device)
            y, x = lat[..., None], torch.as_tensor(lon)[..., None]
            y0, x0, y1, x1 = t(self.plat), t(self.plon), t(y1), t(x1)
            den = torch.where(y1 == y0, torch.full_like(y1, 1e-30), y1 - y0)
        else:
            y = np.asarray(lat)[..., None]        # [N,1] latitude  = "y"
            x = np.asarray(lon)[..., None]        # [N,1] longitude = "x"
            y0, x0 = self.plat, self.plon         # [V]
            den = np.where(y1 == y0, 1e-30, y1 - y0)
        # Edge straddles the point's horizontal line...
        straddle = (y0 <= y) != (y1 <= y)
        # ...and the crossing is to the east of the point.
        with np.errstate(divide="ignore", invalid="ignore"):
            xcross = x0 + (y - y0) * (x1 - x0) / den
        crossings = (straddle & (x < xcross)).sum(-1)
        inside = (crossings % 2) == 1
        return inside & (self.bottom <= alt) & (alt <= self.top)


def _false_like(lat):
    """An all-False mask of the shape and kind of ``lat``."""
    if isinstance(lat, torch.Tensor):
        return torch.zeros(lat.shape, dtype=torch.bool, device=lat.device)
    return np.zeros(np.shape(lat), dtype=bool)


class AreaRegistry:
    """Named-shape registry (replaces the reference module-global dict)."""

    _KINDS = {"BOX": Box, "CIRCLE": Circle, "LINE": Line}

    def __init__(self, scr=None):
        self.areas = {}
        self.scr = scr

    def hasArea(self, name):
        return name in self.areas

    def defineArea(self, name, areatype, coordinates, top=1e9, bottom=-1e9):
        """BOX/CIRCLE/POLY*/LINE factory (areafilter.py:15-27)."""
        areatype = areatype.upper()
        if areatype.startswith("POLY"):
            shape = Poly(name, coordinates, top, bottom)
        elif areatype == "LINE":
            shape = Line(name, coordinates)
        elif areatype in self._KINDS:
            shape = self._KINDS[areatype](name, coordinates, top, bottom)
        else:
            return False, f"Unknown area type {areatype}"
        self.areas[name] = shape
        if self.scr is not None:
            self.scr.objappend(areatype, name, coordinates)
        return True

    def checkInside(self, name, lat, lon, alt):
        """[N] bool: which points are inside the named area
        (areafilter.py:29-36).  Unknown name -> all-False."""
        area = self.areas.get(name)
        if area is None:
            return _false_like(lat)
        return area.contains(lat, lon, alt)

    def deleteArea(self, name):
        if name in self.areas:
            self.areas.pop(name)
            if self.scr is not None:
                self.scr.objappend("", name, None)
            return True
        return False

    def reset(self):
        """Clear all areas, including their screen mirrors."""
        for name in list(self.areas):
            self.deleteArea(name)


# Module-level default registry: the reference-convenience API for code
# that doesn't carry a Simulation (plugins use sim.areas instead).
_default = AreaRegistry()
hasArea = _default.hasArea
defineArea = _default.defineArea
checkInside = _default.checkInside
deleteArea = _default.deleteArea
reset = _default.reset
areas = _default.areas
