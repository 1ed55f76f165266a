"""The fleet of a configuration, drawn from a seed.

``draw(fleet, seed)`` reads the ``fleet`` parameters of a configuration
file.  ``geometry`` ``"global"``: latitudes area-uniform within
``+-asin(sin_lat_max)``, every longitude; ``"circle"``: uniform in a
disc of ``radius_deg`` degrees of latitude around ``center``, the
longitude offset divided by ``lon_scale``.  Altitudes [m], CAS [m/s]
and headings [deg] are uniform in their ranges.  The draws and their
order are those of the JAX package's ``bench.py`` ``_make_traffic``
(numpy's default generator), so seed 0 gives its fleet.
"""
import numpy as np


def draw(fleet: dict, seed: int) -> dict:
    """``dict(lat, lon, alt, spd, hdg)``, numpy float64 [n_aircraft]."""
    n = int(fleet["n_aircraft"])
    rng = np.random.default_rng(int(seed))
    if fleet["geometry"] == "global":
        s = float(fleet["sin_lat_max"])
        lat = np.degrees(np.arcsin(rng.uniform(-s, s, n)))
        lon = rng.uniform(-180.0, 180.0, n)
    elif fleet["geometry"] == "circle":
        clat, clon = fleet["center"]
        ang = rng.uniform(0, 2 * np.pi, n)
        r = float(fleet["radius_deg"]) * np.sqrt(rng.random(n))
        lat = clat + r * np.cos(ang)
        lon = clon + r * np.sin(ang) / float(fleet["lon_scale"])
    else:
        raise ValueError(f"unknown fleet geometry {fleet['geometry']!r}")
    alt = rng.uniform(*fleet["alt_m"], n)
    spd = rng.uniform(*fleet["cas_mps"], n)
    hdg = rng.uniform(*fleet["hdg_deg"], n)
    return dict(lat=lat, lon=lon, alt=alt, spd=spd, hdg=hdg)


def sample(n_active: int, size: int, seed: int) -> np.ndarray:
    """The aircraft a run's check compares, drawn from the seed: ``size``
    distinct indices of ``range(n_active)``, ascending."""
    rng = np.random.default_rng([int(seed), 1])
    if size >= n_active:
        return np.arange(n_active)
    return np.sort(rng.choice(n_active, size, replace=False))
