"""Geovectoring: per-area speed/track/vertical-speed interval constraints.

Parity with the reference ``plugins/geovector.py``: for a named area
(BOX/POLY/CIRCLE), clamp each component of the commanded 3D velocity
vector of aircraft inside the area to an allowed interval — ground
speed [gsmin, gsmax] (given as CAS at the aircraft altitude), track
[trkmin, trkmax] (interval < 180 deg to stay unambiguous), vertical
speed [vsmin, vsmax] — applied in the preupdate hook each interval.

Port of ``bluesky_tpu/plugins/geovector.py``: the area test and the
clamps run on one host sample of the state per due hook
(``plugins.host_arrays``), the CAS limits through the port's ``ops/aero``
in float64 on the CPU, and each clamped column goes back into its state
tensor in place, on its device and in its dtype (one write per
constrained column).
"""
import numpy as np
import torch

from . import host_arrays
from ..ops import aero


def init_plugin(sim):
    gv = GeoVector(sim)
    config = {
        "plugin_name": "GEOVECTOR",
        "plugin_type": "sim",
        "update_interval": 1.0,
        "preupdate": gv.preupdate,
        "reset": gv.reset,
    }
    stackfunctions = {
        "GEOVECTOR": [
            "GEOVECTOR area,[gsmin,gsmax,trkmin,trkmax,vsmin,vsmax]",
            "txt,[spd,spd,hdg,hdg,vspd,vspd]",
            gv.defgeovec,
            "Define a geovector for an area defined with "
            "BOX/POLY(ALT)/CIRCLE",
        ],
        "DELGEOVECTOR": [
            "DELGEOVECTOR area",
            "txt",
            gv.delgeovec,
            "Remove the geovector from an area",
        ],
    }
    return config, stackfunctions


def _degto180(d):
    return (np.asarray(d) + 180.0) % 360.0 - 180.0


class GeoVector:
    def __init__(self, sim):
        self.sim = sim
        self.geovecs = []    # [area, gsmin, gsmax, trkmin, trkmax,
        #                       vsmin, vsmax]

    def reset(self):
        self.geovecs = []

    def defgeovec(self, area="", spdmin=None, spdmax=None, trkmin=None,
                  trkmax=None, vspdmin=None, vspdmax=None):
        """GEOVECTOR area,[constraints] (geovector.py defgeovec)."""
        if not area:
            return False, "We need an area"
        if all(v is None for v in (spdmin, spdmax, trkmin, trkmax,
                                   vspdmin, vspdmax)):
            # No values: report the current vector for the area
            for vec in self.geovecs:
                if vec[0] == area.upper():
                    return True, f"GEOVECTOR {area}: {vec[1:]}"
            return False, f"No geovector found for {area}"
        if not self.sim.areas.hasArea(area.upper()):
            return False, f"Area {area} not found"
        self.delgeovec(area)
        self.geovecs.append([area.upper(), spdmin, spdmax, trkmin,
                             trkmax, vspdmin, vspdmax])
        return True

    def delgeovec(self, area=""):
        n0 = len(self.geovecs)
        self.geovecs = [v for v in self.geovecs if v[0] != area.upper()]
        return True if len(self.geovecs) < n0 else \
            (False, f"No geovector found for {area}")

    # ------------------------------------------------------------- update
    def preupdate(self):
        """Apply every geovector (geovector.py applygeovec), one masked
        device write per constrained field."""
        if not self.geovecs:
            return
        sim = self.sim
        traf = sim.traf
        st = traf.state
        ac = st.ac
        names = ("lat", "lon", "alt", "active", "vs", "trk", "selspd",
                 "selvs", "selalt")
        host = dict(zip(names, host_arrays(*(getattr(ac, k)
                                             for k in names))))
        lat, lon, alt, active = (host[k] for k in names[:4])
        updates = {}

        def arr(name):
            updates[name] = host[name]
            return host[name]

        def tas2cas(tas):
            return aero.vtas2cas(
                torch.full((len(alt),), float(tas), dtype=torch.float64),
                torch.as_tensor(alt, dtype=torch.float64)).numpy()

        aptrk = None
        for (area, gsmin, gsmax, trkmin, trkmax,
             vsmin, vsmax) in self.geovecs:
            if not sim.areas.hasArea(area):
                continue
            inside = np.asarray(sim.areas.checkInside(
                area, lat, lon, alt)) & active
            if not inside.any():
                continue
            if gsmin is not None:
                casmin = tas2cas(gsmin)
                sel = inside & (arr("selspd") < casmin)
                arr("selspd")[sel] = casmin[sel]
            if gsmax is not None:
                casmax = tas2cas(gsmax)
                sel = inside & (arr("selspd") > casmax)
                arr("selspd")[sel] = casmax[sel]
            if trkmin is not None and trkmax is not None:
                if aptrk is None:
                    aptrk = host_arrays(st.ap.trk)[0]
                trk = host["trk"]
                usemin = inside & (_degto180(trk - trkmin) < 0.0)
                usemax = inside & (_degto180(trk - trkmax) > 0.0)
                aptrk[usemin] = trkmin
                aptrk[usemax] = trkmax
            if vsmin is not None:
                vs = host["vs"]
                sel = inside & (vs < vsmin)
                arr("selvs")[sel] = vsmin
                arr("selalt")[sel] = alt[sel] + np.sign(vsmin) * 200.0 \
                    * aero.ft
            if vsmax is not None:
                vs = host["vs"]
                sel = inside & (vs > vsmax)
                arr("selvs")[sel] = vsmax
                arr("selalt")[sel] = alt[sel] + np.sign(vsmax) * 200.0 \
                    * aero.ft

        for k, v in updates.items():
            col = getattr(ac, k)
            col.copy_(torch.as_tensor(v).to(col.device, col.dtype))
        if aptrk is not None:
            st.ap.trk.copy_(torch.as_tensor(aptrk).to(st.ap.trk.device,
                                                      st.ap.trk.dtype))
