"""Host-side flight-plan (route) management writing dense device tables.

Port of ``bluesky_tpu/core/route.py``.  The reference keeps one Python ``Route`` object per aircraft with parallel
lists of waypoints and does all FMS lookups through it at sim rate
(route.py:15-1109).  Here the *editing* stays host-side (stack commands are
host events, arriving between step chunks) but the *data* lives in the dense
``RouteArrays`` tables of the state that the FMS reads on the device —
editing a route is a slot-row write, not an object mutation.

Implemented with reference semantics:
* waypoint ordering rules of ``Route.addwpt`` (orig at front, dest at end,
  normal waypoints before dest; route.py:472-614 simplified: navdb fuzzy
  position text resolution lives in stack/argparser)
* ``calcfp`` altitude-constraint propagation: for each waypoint, the next
  altitude constraint at/after it and the along-route distance to that
  constraint (route.py:983-1041) -> ``wptoalt``/``wpxtoalt``
* ``direct``: activate a waypoint and aim guidance at it (route.py:635-705)
* ``findact``: closest-ahead waypoint choice (route.py:1043-1075)
"""
import os
from typing import List, Optional

import numpy as np
import torch

from ..ops import aero

# Waypoint types (reference route.py wptype coding, dumpRoute legend)
WPT_LATLON, WPT_NAV, WPT_ORIG, WPT_DEST, WPT_CALC, WPT_RWY = range(6)


class HostRoute:
    """Host mirror of one aircraft's flight plan (names + arrays)."""

    def __init__(self):
        self.name: List[str] = []
        self.lat: List[float] = []
        self.lon: List[float] = []
        self.alt: List[float] = []      # [m], -999 = none
        self.spd: List[float] = []      # CAS m/s or Mach, -999 = none
        self.wtype: List[int] = []
        self.flyby: List[float] = []
        self.iactwp = -1
        # Landing chain fired for this plan (reference
        # Route.flag_landed_runway, route.py:741-775)
        self.flag_landed = False
        # Turn mode for subsequently added waypoints (reference
        # Route.swflyby, route.py:50; toggled by ADDWPT FLYBY/FLYOVER)
        self.swflyby = True

    @property
    def nwp(self):
        return len(self.name)


class RouteManager:
    """All host routes + synchronisation into the device RouteArrays."""

    def __init__(self, traf, wmax: int):
        self.traf = traf
        self.wmax = wmax
        self.routes = {}   # slot -> HostRoute
        # Deleted aircraft must not leave a stale plan for a reused slot
        # (the reference's route is a traf child cleared by the delete
        # cascade, trafficarrays.py:111-120).  The hook list survives
        # RouteManager replacement (sim reset), so register one shared
        # trampoline per Traffic that always targets its CURRENT manager.
        if getattr(traf, "_route_delete_hooked", None) is not traf:
            traf.delete_hooks.append(
                lambda idx, t=traf: t._route_mgr.drop_slots(idx)
                if getattr(t, "_route_mgr", None) else None)
            # Spatial shard refreshes move aircraft between caller
            # slots (stripe re-bucketing); host route plans are keyed
            # by slot and must move with them.
            traf.permute_hooks.append(
                lambda ns, t=traf: t._route_mgr.permute_slots(ns)
                if getattr(t, "_route_mgr", None) else None)
            traf._route_delete_hooked = traf
        traf._route_mgr = self

    def permute_slots(self, newslot):
        """Re-key the host plans after a spatial slot re-bucketing
        (``newslot[old] = new``); device route rows were already
        permuted with the state."""
        self.routes = {int(newslot[s]): r for s, r in self.routes.items()}

    def drop_slots(self, idx):
        """Clear the host plans of deleted slots and blank their device
        route rows (stale waypoint tables must not greet a reused slot)."""
        import numpy as np
        for i in np.atleast_1d(np.asarray(idx)):
            i = int(i)
            if i in self.routes:
                self.routes[i] = HostRoute()
                self.sync(i)          # blank the device row
                del self.routes[i]    # (sync would setdefault it back)

    def route(self, idx: int) -> HostRoute:
        return self.routes.setdefault(idx, HostRoute())

    def clear(self, idx: int):
        self.routes.pop(idx, None)

    # ------------------------------------------------------------- editing
    def addwpt(self, idx: int, name: str, lat: float, lon: float,
               alt: float = -999.0, spd: float = -999.0,
               wtype: int = WPT_LATLON, flyby: Optional[float] = None,
               afterwp: Optional[str] = None, as_dest: bool = False) -> int:
        """Insert a waypoint with the reference's ordering rules.

        ``as_dest`` marks a runway threshold added BY the DEST command
        (wtype WPT_RWY but destination placement: replace any trailing
        DEST/RWY, go last).  ``flyby=None`` takes the route's current
        turn mode (ADDWPT FLYBY/FLYOVER keyword, reference route.py:50).
        Returns the insertion index, or -1 on error (unknown afterwp).
        """
        r = self.route(idx)
        name = name.upper()
        if flyby is None:
            flyby = 1.0 if r.swflyby else 0.0

        if afterwp is not None:
            names = [n.upper() for n in r.name]
            if afterwp.upper() not in names:
                return -1
            wpidx = names.index(afterwp.upper()) + 1
        elif wtype == WPT_ORIG:
            # Origin goes at the front, replacing an existing origin
            if r.nwp > 0 and r.wtype[0] == WPT_ORIG:
                self._pop(r, 0)
            wpidx = 0
        elif wtype == WPT_DEST or as_dest:
            # Destination goes at the end, replacing an existing dest
            # (which may itself be a runway threshold)
            if r.nwp > 0 and r.wtype[-1] in (WPT_DEST, WPT_RWY):
                self._pop(r, r.nwp - 1)
            wpidx = r.nwp
        else:
            # Normal waypoints go before the destination if there is one
            # (a trailing runway threshold IS the destination — reference
            # setdestorig runway branch)
            wpidx = r.nwp - 1 \
                if (r.nwp > 0 and r.wtype[-1] in (WPT_DEST, WPT_RWY)) \
                else r.nwp

        if r.nwp >= self.wmax:
            raise RuntimeError(
                f"route full for slot {idx} (wmax={self.wmax}); raise wmax")

        r.name.insert(wpidx, name)
        r.lat.insert(wpidx, float(lat))
        r.lon.insert(wpidx, float(lon))
        r.alt.insert(wpidx, float(alt))
        r.spd.insert(wpidx, float(spd))
        r.wtype.insert(wpidx, int(wtype))
        r.flyby.insert(wpidx, float(flyby))
        if r.iactwp >= wpidx:
            r.iactwp += 1
        if r.iactwp < 0:
            r.iactwp = 0
        self.sync(idx)
        return wpidx

    @staticmethod
    def _pop(r: HostRoute, i: int):
        for lst in (r.name, r.lat, r.lon, r.alt, r.spd, r.wtype, r.flyby):
            del lst[i]
        if r.iactwp > i:
            r.iactwp -= 1

    def delrte(self, idx: int) -> bool:
        """DELRTE: drop the complete route incl. orig/dest
        (route.py delrte)."""
        self.clear(idx)
        self.sync(idx)
        return True

    def addwpt_before(self, idx: int, beforewp: str, name: str,
                      lat: float, lon: float,
                      alt: float = -999.0, spd: float = -999.0) -> int:
        """BEFORE beforewp ADDWPT (route.py beforeaddwptStack): insert a
        waypoint in front of a named one.  Returns index or -1."""
        r = self.route(idx)
        names = [n.upper() for n in r.name]
        if beforewp.upper() not in names:
            return -1
        if r.nwp >= self.wmax:
            raise RuntimeError(
                f"route full for slot {idx} (wmax={self.wmax}); raise wmax")
        wpidx = names.index(beforewp.upper())
        r.name.insert(wpidx, name.upper())
        r.lat.insert(wpidx, float(lat))
        r.lon.insert(wpidx, float(lon))
        r.alt.insert(wpidx, float(alt))
        r.spd.insert(wpidx, float(spd))
        r.wtype.insert(wpidx, WPT_LATLON)
        r.flyby.insert(wpidx, 1.0 if r.swflyby else 0.0)
        if r.iactwp >= wpidx:
            r.iactwp += 1
        self.sync(idx)
        return wpidx

    def atwpt(self, idx: int, wpname: str, what: Optional[str] = None,
              value=None):
        """AT wpname [DEL] SPD/ALT [val]: show/edit/delete constraints
        at a route waypoint (route.py atwptStack).

        Returns (ok, message or None)."""
        r = self.route(idx)
        names = [n.upper() for n in r.name]
        if wpname.upper() not in names:
            return False, f"{wpname} not in route"
        i = names.index(wpname.upper())
        if what is None:
            alttxt = "-----" if r.alt[i] < 0 else f"{r.alt[i]:.0f} m"
            spdtxt = "-----" if r.spd[i] < 0 else f"{r.spd[i]:.2f}"
            return True, f"{wpname}: alt {alttxt}, spd {spdtxt}"
        w = what.upper()
        if w.count("/") == 1:
            # acid AT wpname alt"/"spd — both constraints in one token
            # (reference route.py:344-375; "---" deletes a constraint).
            # Parse BOTH halves before mutating: a bad spd half must not
            # leave a half-applied, unsynced constraint.
            from ..utils.units import txt2alt, txt2spd
            alttxt, spdtxt = w.split("/")
            try:
                newalt = r.alt[i] if not alttxt else (
                    -999.0 if alttxt.count("-") > 1 else float(txt2alt(alttxt)))
                newspd = r.spd[i] if not spdtxt else (
                    -999.0 if spdtxt.count("-") > 1 else float(txt2spd(spdtxt)))
            except Exception as e:
                return False, f"Could not parse {what} as alt/spd ({e})"
            r.alt[i] = newalt
            r.spd[i] = newspd
            self.sync(idx)
            return True, None
        if w == "DEL":
            which = (str(value).upper() if value is not None else "BOTH")
            if which in ("ALT", "BOTH"):
                r.alt[i] = -999.0
            if which in ("SPD", "BOTH"):
                r.spd[i] = -999.0
        elif w == "ALT":
            if value is None:
                return False, "AT wpname ALT value"
            r.alt[i] = float(value)
        elif w == "SPD":
            if value is None:
                return False, "AT wpname SPD value"
            r.spd[i] = float(value)
        else:
            return False, f"AT: unknown argument {what}"
        self.sync(idx)   # sync recomputes calcfp's constraint tables
        return True, None

    def dumproute(self, idx: int, acid: str,
                  path: Optional[str] = None) -> str:
        """DUMPRTE: append the route table to <log_path>/routelog.txt
        (route.py dumpRoute)."""
        if path is None:
            from .. import settings
            path = settings.log_path
        os.makedirs(path, exist_ok=True)
        fname = os.path.join(path, "routelog.txt")
        r = self.route(idx)
        with open(fname, "a") as f:
            f.write(f"\nRoute {acid}:\n")
            f.write("(name, lat, lon, alt, spd, active)\n")
            for i in range(r.nwp):
                f.write(f"{r.name[i]}, {r.lat[i]:.6f}, {r.lon[i]:.6f}, "
                        f"{r.alt[i]:.1f}, {r.spd[i]:.2f}, "
                        f"{i == r.iactwp}\n")
            f.write("***\n")
        return fname

    def delwpt(self, idx: int, name: str) -> bool:
        r = self.route(idx)
        if name == "*":
            self.routes[idx] = HostRoute()
            self.sync(idx)
            return True
        names = [n.upper() for n in r.name]
        if name.upper() not in names:
            return False
        # reference deletes the LAST matching occurrence (route.py:816-821)
        i = len(names) - 1 - names[::-1].index(name.upper())
        self._pop(r, i)
        r.iactwp = min(r.iactwp, r.nwp - 1)
        self.sync(idx)
        return True

    def direct(self, idx: int, name: str) -> bool:
        """DIRECT: jump the active waypoint to ``name`` and point guidance at
        it (route.py:635-705, condensed: the VNAV re-trigger happens at the
        next FMS tick from the synced tables)."""
        r = self.route(idx)
        names = [n.upper() for n in r.name]
        if name.upper() not in names:
            return False
        r.iactwp = names.index(name.upper())
        self.sync(idx, point_active=True)
        return True

    def findact(self, idx: int) -> int:
        """Closest-ahead waypoint (route.py:1043-1075)."""
        r = self.route(idx)
        if r.nwp <= 0:
            return -1
        if r.nwp == 1:
            return 0
        st = self.traf.state
        aclat = float(st.ac.lat[idx])
        aclon = float(st.ac.lon[idx])
        coslat = float(st.ac.coslat[idx])
        trk = float(st.ac.trk[idx])
        tas = float(st.ac.tas[idx])
        bank = float(st.ac.bank[idx])

        dy = np.asarray(r.lat) - aclat
        dx = (np.asarray(r.lon) - aclon) * coslat
        dist2 = dx * dx + dy * dy
        iwpnear = max(r.iactwp, int(np.argmin(dist2)))
        if iwpnear + 1 < r.nwp:
            qdr = np.degrees(np.arctan2(dx[iwpnear], dy[iwpnear]))
            delhdg = abs((trk - qdr + 180.0) % 360.0 - 180.0)
            time_turn = max(0.01, tas) * np.radians(delhdg) \
                / (aero.g0 * np.tan(bank))
            time_straight = np.sqrt(dist2[iwpnear]) * 60.0 * aero.nm \
                / max(0.01, tas)
            if time_turn > time_straight:
                iwpnear += 1
        return iwpnear

    # --------------------------------------------------------------- sync
    def calcfp(self, r: HostRoute):
        """Altitude-constraint lookahead tables (route.py:983-1041)."""
        n = r.nwp
        wpdistto = np.zeros(n)          # [nm] distance from wp i-1 to i
        for i in range(n - 1):
            from ..core.traffic import _np_vatmos  # noqa: F401 (host helpers)
            wpdistto[i + 1] = _host_qdrdist_nm(r.lat[i], r.lon[i],
                                               r.lat[i + 1], r.lon[i + 1])
        wptoalt = np.full(n, -999.0)
        wpxtoalt = np.ones(n)
        toalt, xtoalt = -999.0, 0.0
        for i in range(n - 1, -1, -1):
            if r.wtype[i] == WPT_DEST:
                toalt, xtoalt = 0.0, 0.0
            elif r.alt[i] >= 0:
                toalt, xtoalt = r.alt[i], 0.0
            else:
                xtoalt = xtoalt + wpdistto[i + 1] * aero.nm if i != n - 1 \
                    else 0.0
            wptoalt[i] = toalt
            wpxtoalt[i] = xtoalt
        return wptoalt, wpxtoalt

    def runway_final_slots(self):
        """Slots whose plan ends at a runway waypoint and whose landing
        chain has not fired — the candidates for _check_runway_landings."""
        return [(s, r) for s, r in self.routes.items()
                if r.nwp > 0 and r.wtype[-1] == WPT_RWY
                and not r.flag_landed]

    def sync(self, idx: int, point_active: bool = False):
        """Write one slot's host route into the device tables: one row
        of each ``[nmax, wmax]`` table, in place, in the state's dtype
        and on its device."""
        self.traf.flush()
        r = self.route(idx)
        st = self.traf.state
        rt = st.route
        W = self.wmax
        n = r.nwp

        def row(vals, fill):
            out = np.full(W, fill)
            out[:n] = vals
            return out

        wptoalt, wpxtoalt = self.calcfp(r)
        i = idx
        put = lambda arr, vals: arr[i].copy_(torch.as_tensor(
            vals, dtype=arr.dtype, device=arr.device))
        put(rt.wplat, row(r.lat, 89.99))
        put(rt.wplon, row(r.lon, 0.0))
        put(rt.wpalt, row(r.alt, -999.0))
        put(rt.wpspd, row(r.spd, -999.0))
        put(rt.wpflyby, row(r.flyby, 1.0))
        put(rt.wptoalt, row(wptoalt, -999.0))
        put(rt.wpxtoalt, row(wpxtoalt, 0.0))
        rt.nwp[i] = n
        rt.iactwp[i] = r.iactwp

        if point_active and 0 <= r.iactwp < n:
            k = r.iactwp
            actwp = st.actwp
            actwp.lat[i] = r.lat[k]
            actwp.lon[i] = r.lon[k]
            if r.alt[k] >= 0:
                actwp.nextaltco[i] = r.alt[k]
            actwp.spd[i] = r.spd[k]
            actwp.flyby[i] = r.flyby[k]
            actwp.xtoalt[i] = float(wpxtoalt[k])
            st.ac.swlnav[i] = True


def _host_qdrdist_nm(lat1, lon1, lat2, lon2):
    """Host float64 haversine distance [nm] (same math as ops/geo.qdrdist)."""
    a = 6378137.0
    b = 6356752.314245

    def rw(latd):
        la = np.radians(latd)
        cl, sl = np.cos(la), np.sin(la)
        an, bn = a * a * cl, b * b * sl
        ad, bd = a * cl, b * sl
        return np.sqrt((an * an + bn * bn) / (ad * ad + bd * bd))

    if lat1 * lat2 >= 0:
        r = rw(0.5 * (lat1 + lat2))
    else:
        r = 0.5 * (abs(lat1) * (rw(lat1) + a) + abs(lat2) * (rw(lat2) + a)) \
            / (abs(lat1) + abs(lat2))
    f1, f2 = np.radians(lat1), np.radians(lat2)
    g1, g2 = np.radians(lon1), np.radians(lon2)
    h = np.sin(0.5 * (f2 - f1)) ** 2 \
        + np.cos(f1) * np.cos(f2) * np.sin(0.5 * (g2 - g1)) ** 2
    return 2.0 * r * np.arctan2(np.sqrt(h), np.sqrt(1 - h)) / 1852.0
