"""Research traffic metrics: cell occupancy (CoCa) + conflict-geometry
complexity (HB two-circle method).

Capability parity with the reference ``traffic/metric.py`` (1.4k LoC of
research NumPy + matplotlib): the same measured quantities — per-cell
aircraft counts over the reference's 18x18x12 sector grid
(metric_Area:53-158 / metric_CoCa:160-505) and the Hoekstra-Bussink
conflict-geometry complexity inside a FIR circle (metric_HB:508-1300) —
restructured for array hardware (port of ``bluesky_tpu/core/metrics.py``):

* Cell occupancy is one ``digitize``-style binning over the padded
  aircraft arrays instead of per-aircraft Python loops.
* The HB complexity counts pairwise CPA encounters (t_cpa within the
  1800 s lookahead, CPA distance < 5 nm, altitude difference < 1000 ft)
  from the same broadcast geometry the CD kernel uses.
* Results log to a METLOG CSV via the datalog EventLogger instead of
  matplotlib figures; sampling happens at chunk edges on the host copy.
"""
import numpy as np

from ..ops import aero
from ..utils import asnumpy

NM = aero.nm
FT = aero.ft


class MetricsArea:
    """The reference metric sector grid (metric.py:53-66 defaults):
    ncells x ncells columns of `distance` nm, nlevels flight levels."""

    def __init__(self, lat=55.5, lon=1.7, ncells=18, nlevels=12,
                 cell_nm=20.0, fl_low=8500.0, fl_high=41500.0):
        self.lat0 = lat
        self.lon0 = lon
        self.ncells = ncells
        self.nlevels = nlevels
        self.cell_nm = cell_nm
        self.fl_low = fl_low
        self.fl_high = fl_high
        # Grid spans south/east from the anchor (bearingS/bearingE)
        self.dlat = -cell_nm / 60.0
        self.dlon = cell_nm / 60.0 / max(
            0.2, np.cos(np.radians(lat)))

    def cell_indices(self, lat, lon, alt):
        """[N] -> (i, j, k) cell indices; -1 outside the grid."""
        i = np.floor((lat - self.lat0) / self.dlat).astype(int)
        j = np.floor((lon - self.lon0) / self.dlon).astype(int)
        alt_ft = alt / FT
        k = np.floor((alt_ft - self.fl_low)
                     / ((self.fl_high - self.fl_low) / self.nlevels)
                     ).astype(int)
        inside = ((i >= 0) & (i < self.ncells) & (j >= 0)
                  & (j < self.ncells) & (k >= 0) & (k < self.nlevels))
        return np.where(inside, i, -1), np.where(inside, j, -1), \
            np.where(inside, k, -1), inside

    def cell_area_nm2(self):
        """Horizontal cell area [nm^2] (metric_Area.cellArea:99-107 —
        the reference derives it from the region corner points; the
        regular grid makes it the cell square)."""
        return self.cell_nm * self.cell_nm

    def cell_centroid(self, i, j):
        """(lat, lon) centre of column cell (i, j)
        (metric_Area.centroid_of_polygon:124-145 on a regular grid)."""
        return (self.lat0 + (i + 0.5) * self.dlat,
                self.lon0 + (j + 0.5) * self.dlon)


def coca_counts(area, lat, lon, alt, active):
    """Cell-occupancy histogram [ncells, ncells, nlevels] + summary
    (metric_CoCa.applyMetric:346-505, vectorized)."""
    i, j, k, inside = area.cell_indices(lat, lon, alt)
    sel = inside & active
    counts = np.zeros((area.ncells, area.ncells, area.nlevels), int)
    np.add.at(counts, (i[sel], j[sel], k[sel]), 1)
    return counts


def coca_cell_stats(dwell, hdg, spd_kts, vspd_fpm, window):
    """The reference's per-cell CoCa interaction statistics
    (metric_CoCa.applyMetric:346-447), for ONE cell's occupants.

    Inputs are the occupants' dwell times [s] within the reset window,
    headings [deg], speeds [kts] and vertical speeds [fpm]; ``window``
    is the reset window length (metric.py:186 resettime).  Returns the
    reference's 6 columns: [combined, occupancy, ac-, spd-, hdg-,
    vspd-interactions], with the combined metric
    c1 * (c2 + c3 + c4) of the normalized interaction terms
    (metric.py:442-447).  The peculiar shrinking-list accumulation is
    kept verbatim — it is the published quantity.
    """
    order = np.argsort(dwell)
    times = list(np.asarray(dwell, float)[order])
    headings = list(np.asarray(hdg, float)[order])
    speeds = list(np.asarray(spd_kts, float)[order])
    vspeeds = list(np.asarray(vspd_fpm, float)[order])
    actimes = list(times)
    # vertical-speed tri-state (metric.py:375-381)
    vspeeds = [0 if -500.0 <= v <= 500.0 else (1 if v > 500.0 else -1)
               for v in vspeeds]

    occupancy = sum(times) / window
    if len(times) < 2:
        return [0.0, occupancy, 0.0, 0.0, 0.0, 0.0]

    acint, spdint, hdgint, vspdint = [], [], [], []
    for _k in range(len(times)):
        aircraft = len(times)
        time_n = times[0] / window
        actime_n = actimes[0] / window
        acint.append(aircraft * (aircraft - 1) * actime_n ** aircraft)

        c = sum(1 for u in range(1, len(speeds))
                if abs(speeds[0] - speeds[u]) > 35.0)
        spdint.append(2 * c * time_n ** (c + 1))
        c = sum(1 for u in range(1, len(headings))
                if abs(headings[0] - headings[u]) > 20.0)
        hdgint.append(2 * c * time_n ** (c + 1))
        c = sum(1 for u in range(1, len(vspeeds))
                if vspeeds[0] != vspeeds[u])
        vspdint.append(2 * c * time_n ** (c + 1))

        for x in range(1, len(actimes)):
            actimes[x] = actimes[x] - actimes[0]
        del actimes[0], times[0], vspeeds[0], speeds[0], headings[0]

    pre = [sum(acint), sum(spdint), sum(hdgint), sum(vspdint)]
    occ = occupancy if occupancy > 0 else 1.0
    c1, c2, c3, c4 = (v / occ for v in pre)
    return [c1 * (c2 + c3 + c4), occupancy, c1, c2, c3, c4]


def hb_complexity(lat, lon, alt, tas, trk, active,
                  ctrlat, ctrlon, radius_nm,
                  dist_range_nm=5.0, alt_range_ft=1000.0,
                  time_lookahead=1800.0):
    """Two-circle conflict-geometry complexity (metric_HB:580-1300).

    Counts encounter pairs inside the FIR circle whose CPA lies within
    ``dist_range_nm`` / ``alt_range_ft`` inside the lookahead, and the
    per-aircraft share involved.  Returns (complexity, n_selected,
    compl_ac, sel, per_ac) where ``per_ac`` is each selected aircraft's
    encounter count — the per-aircraft complexity column of the
    reference's Metric-HB CSV rows (metric.py saveData:1004-1023).
    """
    from ..ops.geo import kwikdist_wrapped
    d_fir = kwikdist_wrapped(ctrlat, ctrlon, lat, lon)
    sel = active & (np.asarray(d_fir) < radius_nm)
    n = int(sel.sum())
    if n < 2:
        return 0, n, 0, sel, np.zeros(n, int)
    lat, lon = lat[sel], lon[sel]
    alt, tas, trk = alt[sel], tas[sel], trk[sel]

    # Flat-earth relative geometry (the HB method works in nm around
    # the FIR anchor, metric.py:595-612)
    coslat = np.cos(np.radians(ctrlat))
    x = (lon - ctrlon) * 60.0 * coslat          # [nm]
    y = (lat - ctrlat) * 60.0
    vx = tas / NM * np.sin(np.radians(trk))     # [nm/s]
    vy = tas / NM * np.cos(np.radians(trk))

    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    dvx = vx[None, :] - vx[:, None]
    dvy = vy[None, :] - vy[:, None]
    dv2 = dvx * dvx + dvy * dvy
    dv2 = np.where(dv2 < 1e-12, 1e-12, dv2)
    tcpa = -(dvx * dx + dvy * dy) / dv2
    dcpa2 = (dx + dvx * tcpa) ** 2 + (dy + dvy * tcpa) ** 2
    dalt = np.abs(alt[None, :] - alt[:, None]) / FT

    enc = ((tcpa > 0.0) & (tcpa < time_lookahead)
           & (dcpa2 < dist_range_nm ** 2) & (dalt < alt_range_ft))
    np.fill_diagonal(enc, False)
    complexity = int(enc.sum()) // 2            # unique pairs
    compl_ac = int(enc.any(axis=1).sum())
    return complexity, n, compl_ac, sel, enc.sum(axis=1)


class Metrics:
    """Coordinator (reference Metric:1311-1443): periodic evaluation of
    the selected metric, CSV logging, METRICS stack command."""

    NAMES = ("CoCa-Metric", "HB-Metric")

    def __init__(self, sim):
        self.sim = sim
        self.metric_number = -1      # -1 = off
        self.dt = 1.0
        self.tnext = 0.0
        self.area = MetricsArea()
        self.fir_circle_point = (52.6, 5.4)
        self.fir_circle_radius = 230.0     # [nm]
        self.coca_window = 5.0       # [s] reset window (metric.py:186)
        # per-slot (cell_key, entry simt) for the CoCa dwell times
        self._cell_entry = {}
        # latest scalar outputs, exposed to PLOT (plotter parent
        # 'metrics': e.g. "PLOT simt metrics.complexity")
        self.complexity = 0
        self.n_selected = 0
        self.compl_ac = 0
        self.coca_total = 0
        self.coca_max = 0
        self.coca_combined = 0.0
        # per-sim registry: W multi-world sims keep separate METLOGs
        self.logger = sim.datalog.define_event(
            "METLOG",
            "Metrics log: metric name, then metric-specific columns "
            "(CoCa cell rows: cell-id, n, centroid-lat/lon, combined, "
            "occupancy, ac-, spd-, hdg-, vspd-interactions, "
            "metric.py:346-447 + 99-145; HB "
            "aircraft rows: acid, lat, lon, alt_ft, spd_kts, trk, "
            "ntraf, compl, metric.py:1004-1023)")
        sim.plotter.register_data_parent(self, "metrics")

    # ------------------------------------------------------------ command
    def toggle(self, flag=None, dt=None):
        """METRICS OFF / METRICS n [dt] (Metric.toggle:1358-1387)."""
        if flag is None:
            state = "OFF" if self.metric_number < 0 \
                else self.NAMES[self.metric_number]
            return True, f"METRICS {state} (dt={self.dt})"
        if isinstance(flag, str) and flag.upper() in ("OFF", "0"):
            self.metric_number = -1
            self.logger.stop()       # flush + close our METLOG file
            return True, "Metrics OFF"
        try:
            num = int(float(flag))
        except (TypeError, ValueError):
            return False, "METRICS OFF or METRICS 1/2 [dt]"
        if num <= 0:
            self.metric_number = -1
            self.logger.stop()
            return True, "Metrics OFF"
        if num > len(self.NAMES):
            return False, "No such metric"
        if dt is not None:
            self.dt = float(dt)
        self.metric_number = num - 1
        self.tnext = self.sim.simt
        # (Re)open OUR file on every activation: the METLOG logger is
        # process-global (datalog registry), so "already active" may be
        # a different Simulation's leftover file — rotating guarantees
        # this sim's rows land in a file under the current log_path.
        # (Two sims logging METRICS concurrently in one process share
        # the registry entry and the later activation wins the file —
        # the reference's global datalog has the same property.)
        self.logger.stop()
        self.logger.start(self.sim)
        return True, (f"Activated {self.NAMES[self.metric_number]} "
                      f"({num}), dt={self.dt:.2f}")

    # ------------------------------------------------------------- update
    def update(self, edge=None):
        """Evaluate the active metric when due (chunk edges).

        ``edge`` is a retired ``ChunkEdge`` (simulation/pipeline.py):
        the pipelined loop passes it so every field below comes out of
        the fused telemetry pack — ONE device->host copy per edge
        instead of a dozen ``np.asarray`` pulls — and the sampling
        timestamp is the edge's own clock, not a blocking device read.
        Without it (synchronous edges) the live state is sampled as
        before."""
        if self.metric_number < 0:
            return
        t = edge.simt if edge is not None else self.sim.simt
        if t < self.tnext - 1e-9:
            return
        self.tnext = t + self.dt
        st = edge.fetch() if edge is not None else self.sim.traf.state.ac
        active = asnumpy(st.active)
        lat = asnumpy(st.lat)
        lon = asnumpy(st.lon)
        alt = asnumpy(st.alt)
        if self.metric_number == 0:
            counts = coca_counts(self.area, lat, lon, alt, active)
            self.last_counts = counts
            self.coca_total = int(counts.sum())
            self.coca_max = int(counts.max())
            # ---- per-cell statistics (metric_CoCa.applyMetric) ----
            i, j, k, inside = self.area.cell_indices(lat, lon, alt)
            trk = asnumpy(st.trk)
            cas = asnumpy(st.cas) / aero.kts
            vs = asnumpy(st.vs) / aero.fpm
            keys = (i * self.area.ncells + j) * self.area.nlevels + k
            occupants = {}
            idxs = np.flatnonzero(active & inside)
            for slot in idxs:
                key = int(keys[slot])
                # entries are validated by CALLSIGN: a reused slot must
                # not inherit the deleted occupant's cell-entry time
                acid = self.sim.traf.ids[slot]
                prev = self._cell_entry.get(slot)
                if prev is None or prev[0] != key or prev[2] != acid:
                    self._cell_entry[slot] = (key, t, acid)
                occupants.setdefault(key, []).append(slot)
            # drop stale entries (deleted aircraft / left the grid)
            live = set(int(s_) for s_ in idxs)
            self._cell_entry = {s_: v for s_, v in
                                self._cell_entry.items() if s_ in live}
            combined_sum = 0.0
            for key, slots in sorted(occupants.items()):
                dwell = [min(t - self._cell_entry[s_][1]
                             + self.dt, self.coca_window)
                         for s_ in slots]
                row = coca_cell_stats(dwell, trk[slots], cas[slots],
                                      vs[slots], self.coca_window)
                combined_sum += row[0]
                ci = key // (self.area.ncells * self.area.nlevels)
                cj = (key // self.area.nlevels) % self.area.ncells
                clat, clon = self.area.cell_centroid(ci, cj)
                self.logger.log(self.sim, ["CoCa"], [key], [len(slots)],
                                [round(clat, 4)], [round(clon, 4)],
                                *[[round(v, 6)] for v in row], simt=t)
            self.coca_combined = combined_sum
            self.last_coca_cells = occupants
        else:
            tas = asnumpy(st.tas)
            trk = asnumpy(st.trk)
            cx, n, cac, sel, per_ac = hb_complexity(
                lat, lon, alt, tas, trk, active,
                self.fir_circle_point[0], self.fir_circle_point[1],
                self.fir_circle_radius)
            self.last_hb = (cx, n, cac)
            self.complexity = cx
            self.n_selected = n
            self.compl_ac = cac
            # per-aircraft rows like the reference Metric-HB CSV
            # (metric.py saveData:1004-1023): acid, lat, lon, alt[ft],
            # spd[kts], trk, ntraf, compl
            idx = np.flatnonzero(sel)
            if len(idx):
                ids = [self.sim.traf.ids[s_] or f"#{s_}" for s_ in idx]
                self.logger.log(
                    self.sim, ["HB"] * len(idx), ids,
                    np.round(lat[idx], 5), np.round(lon[idx], 5),
                    np.round(alt[idx] / FT, 1),
                    np.round(tas[idx] / aero.kts, 1),
                    np.round(trk[idx], 1),
                    [n] * len(idx), per_ac, simt=t)
            else:
                # schema-stable empty row (same 8 columns as aircraft
                # rows, acid '-')
                self.logger.log(self.sim, ["HB"], ["-"], [0.0], [0.0],
                                [0.0], [0.0], [0.0], [n], [0], simt=t)

    def reset(self):
        self.metric_number = -1
        self.tnext = 0.0
        self._cell_entry = {}
        # PLOT-exposed scalars must not leak across scenarios
        self.complexity = 0
        self.n_selected = 0
        self.compl_ac = 0
        self.coca_total = 0
        self.coca_max = 0
        self.coca_combined = 0.0
