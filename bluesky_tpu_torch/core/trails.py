"""Aircraft trails: line-segment position history for display.

A host-side numpy copy of ``bluesky_tpu/core/trails.py`` (reference
``bluesky/traffic/trails.py:9-236``): per-aircraft last-sample anchors, a
growing buffer of (lat0, lon0, lat1, lon1, time, color) line pieces
appended every ``dttrail`` seconds while active, per-aircraft colors,
CLEAR/background handling and the TRAIL ON/OFF [dt] / TRAIL acid color
command.  Sampling happens at chunk edges from host copies of lat/lon,
never inside the step; slots are stable, so the anchors are [nmax]
arrays.
"""
import numpy as np


def _host(a):
    """A host numpy copy of a tensor (any device) or array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)

COLORLIST = {
    "BLUE": (0, 0, 255),
    "CYAN": (0, 255, 255),
    "RED": (255, 0, 0),
    "YELLOW": (255, 255, 0),
}


class Trails:
    def __init__(self, traf, dttrail=10.0):
        self.traf = traf
        self.active = False
        self.dt = dttrail
        self.tcol0 = 60.0                      # fade-to-old after [s]
        self.defcolor = COLORLIST["CYAN"]
        nmax = traf.nmax
        self.accolor = np.tile(np.asarray(self.defcolor, np.uint8),
                               (nmax, 1))     # [nmax,3]
        self.lastlat = np.zeros(nmax)
        self.lastlon = np.zeros(nmax)
        self.lasttim = np.zeros(nmax)
        # TRAIL ON requests a one-shot re-anchor before the first
        # segments (no stale segments from old positions).
        self._need_anchor = False
        self._clear_buffers()
        # Follow aircraft across slot permutations (the per-slot
        # anchors/colors are keyed by caller slot)
        traf.permute_hooks.append(self.permute_slots)

    def permute_slots(self, newslot):
        ns = np.asarray(newslot)
        inv = np.argsort(ns)                   # new slot -> old slot
        self.accolor = self.accolor[inv]
        self.lastlat = self.lastlat[inv]
        self.lastlon = self.lastlon[inv]
        self.lasttim = self.lasttim[inv]

    def _clear_buffers(self):
        # Foreground line pieces (streamed in ACDATA / drawn by a GUI)
        self.lat0 = np.array([])
        self.lon0 = np.array([])
        self.lat1 = np.array([])
        self.lon1 = np.array([])
        self.time = np.array([])
        self.col = np.zeros((0, 3), dtype=np.uint8)
        # Background copy (frozen picture on CLEAR, trails.py:156-175)
        self.bglat0 = np.array([])
        self.bglon0 = np.array([])
        self.bglat1 = np.array([])
        self.bglon1 = np.array([])
        self.bgtime = np.array([])
        self.bgcol = np.zeros((0, 3), dtype=np.uint8)
        # Segments added since the last ACDATA send (the stream sends
        # only deltas: screenio.py:216-222 newlat0.../clearnew)
        self.clearnew()

    def clearnew(self):
        self.newlat0 = np.array([])
        self.newlon0 = np.array([])
        self.newlat1 = np.array([])
        self.newlon1 = np.array([])

    # ------------------------------------------------------------ lifecycle
    def create(self, idx, lat, lon, t=0.0):
        """Anchor new aircraft at their spawn position (trails.py:64-69)."""
        idx = np.atleast_1d(idx)
        self.accolor[idx] = self.defcolor
        self.lastlat[idx] = np.atleast_1d(lat)
        self.lastlon[idx] = np.atleast_1d(lon)
        self.lasttim[idx] = t

    def delete(self, idx):
        # Stable slots: nothing to renumber; segments already in the buffer
        # stay visible like the reference's.
        pass

    def reset(self):
        self.active = False
        self._clear_buffers()
        self.lasttim[:] = 0.0

    # -------------------------------------------------------------- update
    def update(self, t, lat=None, lon=None, active=None):
        """Append segments for aircraft whose last anchor is > dt old.

        lat/lon/active: host samples of the state arrays; fetched from
        the live state only if not supplied.
        """
        active_mask = _host(self.traf.state.ac.active if active is None
                            else active)
        if lat is None:
            lat, lon = self.traf.state.ac.lat, self.traf.state.ac.lon
        lat, lon = _host(lat), _host(lon)
        if not self.active or self._need_anchor:
            self.lastlat = np.array(lat, copy=True)
            self.lastlon = np.array(lon, copy=True)
            self.lasttim[:] = t
            self._need_anchor = False
            return
        # >= with an fp-slack so chunk edges spaced exactly dt apart (the
        # Simulation clamps the chunk to the trail resolution) still sample.
        due = active_mask & ((t - self.lasttim) >= self.dt - 1e-6)
        idxs = np.where(due)[0]
        if len(idxs) == 0:
            return
        self.lat0 = np.append(self.lat0, self.lastlat[idxs])
        self.lon0 = np.append(self.lon0, self.lastlon[idxs])
        self.lat1 = np.append(self.lat1, lat[idxs])
        self.lon1 = np.append(self.lon1, lon[idxs])
        self.time = np.append(self.time, np.full(len(idxs), t))
        self.col = np.concatenate([self.col, self.accolor[idxs]], axis=0)
        self.newlat0 = np.append(self.newlat0, self.lastlat[idxs])
        self.newlon0 = np.append(self.newlon0, self.lastlon[idxs])
        self.newlat1 = np.append(self.newlat1, lat[idxs])
        self.newlon1 = np.append(self.newlon1, lon[idxs])
        if len(self.newlat0) > 10000:
            # Backlog bound (headless run with no consumer, or a GUI
            # stalled behind): drop the OLDEST deltas, keeping the
            # just-appended batch so an active consumer still renders
            self.newlat0 = self.newlat0[-10000:]
            self.newlon0 = self.newlon0[-10000:]
            self.newlat1 = self.newlat1[-10000:]
            self.newlon1 = self.newlon1[-10000:]
        self.lastlat[idxs] = lat[idxs]
        self.lastlon[idxs] = lon[idxs]
        self.lasttim[idxs] = t

    # ------------------------------------------------------------- command
    def setTrails(self, *args):
        """TRAIL ON/OFF [dt] or TRAIL acid color (stack.py:734-739)."""
        if not args or args[0] is None:
            return True, f"TRAIL is {'ON' if self.active else 'OFF'}"
        a0 = args[0]
        if isinstance(a0, bool):
            if a0 and not self.active:
                self._need_anchor = True    # fresh anchors, no stale
                #                             segments from old positions
            self.active = a0
            if len(args) > 1 and args[1] is not None:
                try:
                    self.dt = float(args[1])
                except (TypeError, ValueError):
                    return False, f"{args[1]}: expected trail dt"
            return True
        if a0 == "CLEAR":
            self.clear()
            return True
        # TRAIL acid color
        try:
            idx = int(a0)
        except (TypeError, ValueError):
            return False, f"{a0}: expected ON/OFF/CLEAR or acid"
        if len(args) < 2 or str(args[1]).upper() not in COLORLIST:
            return False, "Usage: TRAIL acid BLUE/RED/CYAN/YELLOW"
        self.accolor[idx] = COLORLIST[str(args[1]).upper()]
        return True

    def clear(self):
        """Move current picture to the background buffer (trails.py CLEAR)."""
        self.bglat0 = np.append(self.bglat0, self.lat0)
        self.bglon0 = np.append(self.bglon0, self.lon0)
        self.bglat1 = np.append(self.bglat1, self.lat1)
        self.bglon1 = np.append(self.bglon1, self.lon1)
        self.bgtime = np.append(self.bgtime, self.time)
        self.bgcol = np.concatenate([self.bgcol, self.col], axis=0)
        n = len(self.bglat0)
        self.lat0 = np.array([])
        self.lon0 = np.array([])
        self.lat1 = np.array([])
        self.lon1 = np.array([])
        self.time = np.array([])
        self.col = np.zeros((0, 3), dtype=np.uint8)
        return n
