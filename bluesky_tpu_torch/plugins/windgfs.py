"""Wind field from NOAA GFS forecasts.

Parity with the reference ``plugins/windgfs.py``: download the GFS
0.25-degree grib slice for the simulated UTC time and area, extract the
u/v wind profiles, and load them into the simulation wind field.

The grib decode depends on the optional ``pygrib`` package, exactly
like the reference; the download uses stdlib urllib.  Without pygrib
(or network) the WINDGFS command reports the missing dependency and
the plugin stays loadable — the reference behaves the same when its
optional deps are absent.

Port of ``bluesky_tpu/plugins/windgfs.py``: the grid points go into the
state's wind tensors through the port's ``core/wind.add_point`` (in
place, on the state's device); the download is written under the
port's ``settings.log_path``.
"""
import os
import urllib.error
import urllib.request

import numpy as np

try:
    import pygrib
except ImportError:          # optional, like the reference
    pygrib = None

NOMADS_URL = ("https://nomads.ncep.noaa.gov/cgi-bin/"
              "filter_gfs_0p25.pl")


def init_plugin(sim):
    wgfs = WindGFS(sim)
    config = {
        "plugin_name": "WINDGFS",
        "plugin_type": "sim",
        "update_interval": 3600.0,
        "update": wgfs.update,
        "reset": wgfs.reset,
    }
    stackfunctions = {
        "WINDGFS": [
            "WINDGFS [lat0,lon0,lat1,lon1]",
            "[lat,lon,lat,lon]",
            wgfs.fetch,
            "Load a GFS wind field for the given area at the "
            "simulated time",
        ],
    }
    return config, stackfunctions


class WindGFS:
    def __init__(self, sim):
        self.sim = sim
        self.area = (48.0, -6.0, 56.0, 12.0)
        self.active = False

    def reset(self):
        self.active = False

    def fetch(self, lat0=None, lon0=None, lat1=None, lon1=None):
        """WINDGFS [area]: download + decode + install the wind field."""
        if pygrib is None:
            return False, ("WINDGFS needs the optional pygrib package "
                           "(not installed) — same dependency as the "
                           "reference plugin")
        if lat0 is not None:
            self.area = (lat0, lon0, lat1, lon1)
        utc = self.sim.utc
        ymd = utc.strftime("%Y%m%d")
        hour = (utc.hour // 6) * 6
        lat0, lon0, lat1, lon1 = self.area
        params = (f"?file=gfs.t{hour:02d}z.pgrb2.0p25.f000"
                  f"&lev_250_mb=on&lev_500_mb=on&lev_700_mb=on"
                  f"&lev_850_mb=on&var_UGRD=on&var_VGRD=on"
                  f"&subregion=&leftlon={lon0}&rightlon={lon1}"
                  f"&toplat={lat1}&bottomlat={lat0}"
                  f"&dir=%2Fgfs.{ymd}%2F{hour:02d}%2Fatmos")
        try:
            with urllib.request.urlopen(NOMADS_URL + params,
                                        timeout=30) as r:
                data = r.read()
        except (urllib.error.URLError, OSError) as e:
            return False, f"WINDGFS: download failed ({e})"
        from .. import settings
        tmp = os.path.join(settings.log_path, "gfs_wind.grb2")
        os.makedirs(settings.log_path, exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(data)
        return self._install(tmp)

    # Pressure level -> approximate ISA altitude [m]
    LEVELS = {850: 1457.0, 700: 3012.0, 500: 5574.0, 250: 10363.0}

    def _install(self, fname):
        grbs = pygrib.open(fname)
        u = {}
        v = {}
        lats = lons = None
        for grb in grbs:
            lev = grb.level
            if grb.shortName == "u":
                u[lev] = grb.values
            elif grb.shortName == "v":
                v[lev] = grb.values
            if lats is None:
                lats, lons = grb.latlons()
        grbs.close()
        if not u or lats is None:
            return False, "WINDGFS: no wind records in the grib file"
        # Subsample the grid into wind field points with altitude
        # profiles (core/wind.py add_point API)
        from ..core import wind as windmod
        st = self.sim.traf.state
        wind = st.wind
        step = max(1, lats.shape[0] // 4), max(1, lats.shape[1] // 4)
        npts = 0
        for i in range(0, lats.shape[0], step[0]):
            for j in range(0, lats.shape[1], step[1]):
                alts, dirs, spds = [], [], []
                for lev, alt in sorted(self.LEVELS.items(),
                                       key=lambda kv: kv[1]):
                    if lev not in u:
                        continue
                    uu, vv = u[lev][i, j], v[lev][i, j]
                    spd = float(np.hypot(uu, vv))
                    wdir = float((np.degrees(np.arctan2(uu, vv))
                                  + 180.0) % 360.0)
                    alts.append(alt)
                    dirs.append(wdir)
                    spds.append(spd)
                if alts:
                    wind = windmod.add_point(
                        wind, float(lats[i, j]), float(lons[i, j]),
                        dirs, spds, windalt=alts)
                    npts += 1
        self.sim.traf.state = st.replace(wind=wind)
        self.active = True
        return True, f"WINDGFS: wind field loaded ({npts} points)"

    def update(self):
        pass        # refresh handled by re-issuing WINDGFS
