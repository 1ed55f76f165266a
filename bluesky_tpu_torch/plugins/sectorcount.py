"""Sector occupancy count plugin.

Parity with the reference ``plugins/sectorcount.py``: registered named
areas are polled each interval; occupancy counts plus entered/left
callsign sets are echoed and logged to the OCCUPANCYLOG event logger.

Port of ``bluesky_tpu/plugins/sectorcount.py``: the positions come to
the host in one copy per due update (``plugins.host_arrays``).
"""
import numpy as np

from . import host_arrays


def init_plugin(sim):
    sc = SectorCount(sim)
    config = {
        "plugin_name": "SECTORCOUNT",
        "plugin_type": "sim",
        "update_interval": 3.0,
        "update": sc.update,
        "reset": sc.reset,
    }
    stackfunctions = {
        "SECTORCOUNT": [
            "SECTORCOUNT LIST or ADD sectorname or REMOVE sectorname",
            "txt,[txt]",
            sc.command,
            "Add/remove/list sectors for occupancy count",
        ],
    }
    return config, stackfunctions


class SectorCount:
    def __init__(self, sim):
        self.sim = sim
        self.sectors = []
        self.previnside = []
        self.logger = sim.datalog.define_event(
            "OCCUPANCYLOG", "Sector count log: sector, count, "
            "entered, left")

    def reset(self):
        self.sectors = []
        self.previnside = []

    def command(self, sw, name=""):
        sw = sw.upper()
        if sw == "LIST":
            if not self.sectors:
                return True, "No sectors registered"
            return True, "Registered sectors: " + ", ".join(self.sectors)
        if sw == "ADD":
            if not self.sim.areas.hasArea(name.upper()):
                return False, f"Area {name} not found"
            if name.upper() in self.sectors:
                return True, f"Sector {name} already registered"
            self.sectors.append(name.upper())
            self.previnside.append(set())
            if not self.logger.active:
                self.logger.start(self.sim)
            return True, f"Added sector {name}"
        if sw == "REMOVE":
            if name.upper() not in self.sectors:
                return False, f"Sector {name} not registered"
            i = self.sectors.index(name.upper())
            self.sectors.pop(i)
            self.previnside.pop(i)
            return True, f"Removed sector {name}"
        return False, "SECTORCOUNT LIST/ADD/REMOVE"

    def update(self):
        if not self.sectors:
            return
        traf = self.sim.traf
        st = traf.state.ac
        lat, lon, alt, active = host_arrays(st.lat, st.lon, st.alt,
                                            st.active)
        for i, name in enumerate(self.sectors):
            inside = np.asarray(self.sim.areas.checkInside(
                name, lat, lon, alt)) & active
            ids = {traf.ids[k] for k in np.flatnonzero(inside)}
            arrived = ids - self.previnside[i]
            left = self.previnside[i] - ids
            self.previnside[i] = ids
            if arrived or left:
                self.logger.log(self.sim, [name], [len(ids)],
                                [",".join(sorted(arrived)) or "-"],
                                [",".join(sorted(left)) or "-"])
