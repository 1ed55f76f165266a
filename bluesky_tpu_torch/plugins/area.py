"""Experiment-area plugin: delete aircraft leaving the area, FLST log.

Parity with the reference ``plugins/area.py:47-219``: an experiment area
(existing shape name or ad-hoc box) from which exiting aircraft are
deleted, per-flight efficiency accumulators (2D/3D distance, work done),
the FLST flight-statistics event log written at deletion, and the
AREA / TAXI stack commands.

TPU-first divergences:
* Accumulators are [nmax] arrays on stable slots, integrated at the
  plugin's chunk-edge update from one host sample of gs/vs/alt/thrust —
  with the *actual* elapsed sim time since the previous update (the
  reference multiplies by its nominal dt, plugins/area.py:118-125, which
  drifts if the loop stalls).
* Exit detection is the vectorized areafilter check on the same host
  sample; deletions go through the Traffic facade (mask writes).

Port of ``bluesky_tpu/plugins/area.py``: the sample is one
device-to-host copy per due update (``plugins.host_arrays``), and a
second one of the logged columns only when aircraft leave.
"""
import numpy as np
import torch

from . import host_arrays
from ..utils import asnumpy

FLST_HEADER = (
    "FLST log - flight statistics: "
    "deletion time [s], callsign, spawn time [s], flight time [s], "
    "2D distance [m], 3D distance [m], work done [J], "
    "lat [deg], lon [deg], alt [m], TAS [m/s], VS [m/s], HDG [deg], "
    "ASAS active [bool], pilot alt [m], pilot TAS [m/s], "
    "pilot VS [m/s], pilot HDG [deg]")


def init_plugin(sim):
    area = Area(sim)

    config = {
        "plugin_name": "AREA",
        "plugin_type": "sim",
        "update_interval": area.dt,
        "update": area.update,
        "reset": area.reset,
    }
    stackfunctions = {
        "AREA": [
            "AREA Shapename/OFF or AREA lat,lon,lat,lon,[top,bottom]",
            "[float/txt,float,float,float,alt,alt]",
            area.set_area,
            "Define experiment area (area of interest)",
        ],
        "TAXI": [
            "TAXI ON/OFF [alt]: OFF auto deletes traffic below 1500 ft",
            "onoff,[alt]",
            area.set_taxi,
            "Ground/low-altitude mode: prevents auto-delete at 1500 ft",
        ],
    }
    return config, stackfunctions


class Area:
    def __init__(self, sim):
        self.sim = sim
        traf = sim.traf
        self.active = False
        self.dt = 0.5                  # [s] area-check interval
        self.name = None
        self.swtaxi = True             # True = no low-altitude auto-delete
        self.swtaxialt = 1500.0 * 0.3048
        nmax = traf.nmax
        self.inside = np.zeros(nmax, dtype=bool)
        self.oldalt = np.zeros(nmax)
        self.distance2d = np.zeros(nmax)
        self.distance3d = np.zeros(nmax)
        self.work = np.zeros(nmax)
        self.create_time = np.zeros(nmax)
        self.last_t = float(sim.simt)
        self.logger = sim.datalog.define_event("FLSTLOG", FLST_HEADER)
        traf.create_hooks.append(self.on_create)
        traf.delete_hooks.append(self.on_delete)

    # ---------------------------------------------------------- lifecycle
    def on_create(self, slots):
        slots = np.atleast_1d(np.asarray(slots))
        t = self.sim.simt
        ac = self.sim.traf.state.ac
        alt = asnumpy(ac.alt[torch.as_tensor(slots, device=ac.alt.device)])
        self.create_time[slots] = t
        self.oldalt[slots] = alt
        self.inside[slots] = False
        self.distance2d[slots] = 0.0
        self.distance3d[slots] = 0.0
        self.work[slots] = 0.0

    def on_delete(self, idx):
        for i in np.atleast_1d(np.asarray(idx)):
            self.inside[int(i)] = False

    def reset(self):
        self.active = False
        self.name = None
        self.inside[:] = False
        self.distance2d[:] = 0.0
        self.distance3d[:] = 0.0
        self.work[:] = 0.0
        self.logger.stop()
        self.last_t = float(self.sim.simt)

    # ------------------------------------------------------------- update
    def update(self):
        """Integrate efficiency metrics; delete aircraft that left the
        area, logging their FLST row (plugins/area.py:113-174)."""
        sim = self.sim
        traf = sim.traf
        t = sim.simt
        dt = max(0.0, t - self.last_t)
        self.last_t = t
        if not self.active and self.swtaxi:
            return
        st = traf.state
        active, gs, vs, alt, thrust, lat, lon = host_arrays(
            st.ac.active, st.ac.gs, st.ac.vs, st.ac.alt, st.perf.thrust,
            st.ac.lat, st.ac.lon)
        resultantspd = np.sqrt(gs * gs + vs * vs)
        self.distance2d += dt * gs * active
        self.distance3d += dt * resultantspd * active
        self.work += thrust * dt * resultantspd * active

        # Low-altitude auto-delete when taxi mode is off
        delmask = np.zeros_like(active)
        if not self.swtaxi:
            delmask |= active & (self.oldalt >= self.swtaxialt) \
                & (alt < self.swtaxialt)
            self.oldalt = alt.copy()

        if self.active and self.name is not None:
            inside = np.asarray(
                sim.areas.checkInside(self.name, lat, lon, alt)) & active
            leavers = self.inside & ~inside & active
            self.inside = inside
            delmask |= leavers

        delidx = np.where(delmask)[0]
        if len(delidx) == 0:
            return
        ids = [traf.ids[i] for i in delidx]
        st = traf.state
        cols = host_arrays(st.ac.tas, st.ac.hdg, st.asas.active,
                           st.pilot.alt, st.pilot.tas, st.pilot.vs,
                           st.pilot.hdg)
        tas, hdg, asas_on, palt, ptas, pvs, phdg = (c[delidx] for c in cols)
        self.logger.log(
            sim, ids,
            self.create_time[delidx],
            t - self.create_time[delidx],
            self.distance2d[delidx],
            self.distance3d[delidx],
            self.work[delidx],
            lat[delidx], lon[delidx], alt[delidx],
            tas, vs[delidx], hdg,
            asas_on,
            palt, ptas, pvs, phdg)
        traf.delete(delidx)

    # ------------------------------------------------------------ commands
    def set_area(self, *args):
        """AREA Shapename/OFF or AREA lat,lon,lat,lon,[top,bottom]
        (plugins/area.py:177-210)."""
        args = [a for a in args if a is not None]
        if not args:
            return True, ("Area is currently "
                          + ("ON" if self.active else "OFF")
                          + "\nCurrent Area name is: " + str(self.name))
        a0 = args[0]
        if isinstance(a0, str) and not _isfloat(a0) and len(args) == 1:
            name = a0.upper()
            if self.sim.areas.hasArea(name) or self.sim.areas.hasArea(a0):
                self.name = name if self.sim.areas.hasArea(name) else a0
                self.active = True
                self.inside[:] = False
                self.logger.start(self.sim)
                return True, f"Area is set to {self.name}"
            if name in ("OFF", "OF"):
                if self.name is not None:
                    self.sim.areas.deleteArea(self.name)
                self.logger.stop()
                self.active = False
                self.name = None
                return True, "Area is switched OFF"
            return False, ("Shapename unknown. Please create shapename "
                           "first or shapename is misspelled!")
        if len(args) >= 4:
            try:
                coords = [float(a) for a in args[:4]]
                bounds = [float(a) for a in args[4:6]]
            except (TypeError, ValueError):
                return False, ("Incorrect arguments\n"
                               "AREA Shapename/OFF or "
                               "AREA lat,lon,lat,lon,[top,bottom]")
            self.active = True
            self.name = "DELAREA"
            self.sim.areas.defineArea(self.name, "BOX", coords, *bounds)
            self.inside[:] = False
            self.logger.start(self.sim)
            return True, f"Area is ON. Area name is: {self.name}"
        return False, ("Incorrect arguments\nAREA Shapename/OFF or "
                       "AREA lat,lon,lat,lon,[top,bottom]")

    def set_taxi(self, flag, alt=None):
        """TAXI ON/OFF [alt] (plugins/area.py:212-215)."""
        self.swtaxi = bool(flag)
        if alt is not None:
            self.swtaxialt = float(alt)
        self.oldalt = asnumpy(self.sim.traf.state.ac.alt).copy()
        return True


def _isfloat(s):
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False
