"""ILS approach-gate plugin.

Parity with the reference ``plugins/ilsgate.py``: defines a triangular
POLYALT area (50 nm cone, +/-20 deg, below 4000 ft) pointing away from
a runway threshold, for approach-sequencing experiments.

The reference reads thresholds from ``navdb.rwythresholds`` (parsed
from apt.zip, which this data snapshot does not ship — the reference
would find nothing either).  Extension: an explicit
``ILSGATE name,lat,lon,hdg`` form defines the gate from a given
threshold so the capability works without the proprietary data.

Port of ``bluesky_tpu/plugins/ilsgate.py``: the cone's corners come
from the port's NumPy ``ops/hostgeo.qdrpos``.
"""
from ..ops import aero, hostgeo


def init_plugin(sim):
    gate = IlsGate(sim)
    config = {
        "plugin_name": "ILSGATE",
        "plugin_type": "sim",
        "update_interval": 0.0,
        "reset": gate.reset,
    }
    stackfunctions = {
        "ILSGATE": [
            "ILSGATE airport/RWYxx or ILSGATE name,lat,lon,hdg",
            "txt,[lat,lon,hdg]",
            gate.ilsgate,
            "Define an ILS approach area for a runway",
        ],
    }
    return config, stackfunctions


class IlsGate:
    CONE_LENGTH = 50.0      # [nm]
    CONE_ANGLE = 20.0       # [deg]

    def __init__(self, sim):
        self.sim = sim
        self.gates = []

    def reset(self):
        for name in self.gates:
            self.sim.areas.deleteArea(name)
        self.gates = []

    def ilsgate(self, rwyname, lat=None, lon=None, hdg=None):
        if lat is None:
            if "/" not in rwyname:
                return False, f"Argument is not a runway: {rwyname}"
            apt, rwy = rwyname.upper().split("/RW")
            rwy = rwy.lstrip("Y")
            thresholds = getattr(self.sim.navdb, "rwythresholds", {})
            thr = thresholds.get(apt, {}).get(rwy)
            if thr is None:
                return False, (f"Runway {rwyname} not in the navdata "
                               "(no apt.zip in this data snapshot); use "
                               "ILSGATE name,lat,lon,hdg")
            lat, lon, hdg = thr[0], thr[1], thr[2]
        name = "ILS" + rwyname.upper().replace("/", "")
        lat1, lon1 = (float(x) for x in hostgeo.qdrpos(
            lat, lon, hdg - 180.0 + self.CONE_ANGLE,
            self.CONE_LENGTH))   # dist in [nm]
        lat2, lon2 = (float(x) for x in hostgeo.qdrpos(
            lat, lon, hdg - 180.0 - self.CONE_ANGLE,
            self.CONE_LENGTH))
        coords = [float(lat), float(lon), lat1, lon1, lat2, lon2]
        self.sim.areas.defineArea(name, "POLY", coords,
                                  top=4000.0 * aero.ft, bottom=-1e9)
        self.gates.append(name)
        return True, f"ILS gate {name} defined"
