"""Navdatabase queries (parity: bluesky/navdatabase/navdatabase.py:10-380).

Same query surface as the reference — getwpidx/getwpindices/getaptidx/
getinear/getinside/listairway/listconnections/defwpt — but name lookups go
through precomputed dicts of index lists (O(1)) and the nearest-point math
is a vectorized flat-earth metric over the whole arrays, instead of the
reference's repeated ``list.index`` scans.
"""
import os
from collections import defaultdict

import numpy as np

from .. import settings
from .loaders import load_navdata

NM = 1852.0


def _kwikdist_nm(lata, lona, latb, lonb):
    """Fast flat-earth distance [nm] with antimeridian wrap — via the
    compiled host geodesy core when built (reference runs these queries
    through its cgeo extension)."""
    from ..ops import hostgeo
    return hostgeo.kwikdist_wrapped(lata, lona, latb, lonb)


class Navdatabase:
    def __init__(self, navdata_path=None, cache_path=None):
        self.navdata_path = navdata_path or settings.navdata_path
        self.cache_path = cache_path if cache_path is not None \
            else settings.cache_path
        self.reset()

    def reset(self):
        have = self.navdata_path and os.path.isdir(self.navdata_path)
        if have:
            d = load_navdata(self.navdata_path, self.cache_path)
        else:
            # Standalone fallback: the compact self-authored world set
            # (builtin_data.py) instead of an empty database, so CRE/
            # DEST/ADDWPT by name work out of the box.
            from .builtin_data import load_builtin
            d = load_builtin()
            if not getattr(Navdatabase, "_warned_empty", False):
                Navdatabase._warned_empty = True
                print(f"navdb: no navigation data at "
                      f"{self.navdata_path or '(unset)'} — using the "
                      f"built-in minimal world set ({len(d['aptid'])} "
                      f"airports, {len(d['wpid'])} waypoints; "
                      "approximate positions, see docs/DATA.md)")
        self.wpid = list(d.get("wpid", []))
        self.wplat = np.asarray(d.get("wplat", np.zeros(0)), float)
        self.wplon = np.asarray(d.get("wplon", np.zeros(0)), float)
        self.wptype = list(d.get("wptype", []))
        self.aptid = list(d.get("aptid", []))
        self.aptname = list(d.get("aptname", []))
        self.aptlat = np.asarray(d.get("aptlat", np.zeros(0)), float)
        self.aptlon = np.asarray(d.get("aptlon", np.zeros(0)), float)
        self.aptmaxrwy = np.asarray(d.get("aptmaxrwy", np.zeros(0)), float)
        self.aptco = list(d.get("aptco", []))
        self.aptelev = np.asarray(d.get("aptelev", np.zeros(0)), float)
        self.awid = list(d.get("awid", []))
        self.awfromwpid = list(d.get("awfromwpid", []))
        self.awtowpid = list(d.get("awtowpid", []))
        self.awfromlat = np.asarray(d.get("awfromlat", np.zeros(0)), float)
        self.awfromlon = np.asarray(d.get("awfromlon", np.zeros(0)), float)
        self.awtolat = np.asarray(d.get("awtolat", np.zeros(0)), float)
        self.awtolon = np.asarray(d.get("awtolon", np.zeros(0)), float)
        self.firs = d.get("firs", {})
        self.countries = d.get("countries", {})
        # apt -> {rwy -> (lat, lon, bearing_deg)} displaced thresholds
        # (reference load_visuals_txt.navdata_load_rwythresholds; empty
        # when no apt.zip ships — defrwy() registers runways at runtime)
        self.rwythresholds = d.get("rwythresholds", {})
        # O(1) name -> [indices] maps
        self._wpmap = defaultdict(list)
        for i, name in enumerate(self.wpid):
            self._wpmap[name].append(i)
        self._aptmap = {name: i for i, name in enumerate(self.aptid)}
        self._awmap = defaultdict(list)
        for i, name in enumerate(self.awid):
            self._awmap[name].append(i)

    # -------------------------------------------------------------- queries
    def getwpidx(self, txt, reflat=999999.0, reflon=999999.0):
        """Index of waypoint `txt`; nearest to (reflat,reflon) if given
        (navdatabase.py:140-172 semantics)."""
        idx = self._wpmap.get(txt.upper())
        if not idx:
            return -1
        if not reflat < 99999.0 or len(idx) == 1:
            return idx[0]
        d = _kwikdist_nm(reflat, reflon, self.wplat[idx], self.wplon[idx])
        return idx[int(np.argmin(d))]

    def getwpindices(self, txt, reflat=999999.0, reflon=999999.0,
                     crit=1852.0):
        """All co-located indices of waypoint `txt` near the closest
        occurrence (navdatabase.py:174-205)."""
        idx = self._wpmap.get(txt.upper())
        if not idx:
            return [-1]
        if not reflat < 99999.0 or len(idx) == 1:
            return [idx[0]]
        d = _kwikdist_nm(reflat, reflon, self.wplat[idx], self.wplon[idx])
        imin = idx[int(np.argmin(d))]
        out = [imin]
        for i in idx:
            if i != imin and NM * _kwikdist_nm(
                    self.wplat[i], self.wplon[i],
                    self.wplat[imin], self.wplon[imin]) <= crit:
                out.append(i)
        return out

    def getaptidx(self, txt):
        return self._aptmap.get(txt.upper(), -1)

    def getinear(self, wlat, wlon, lat, lon):
        """Index of nearest point in (wlat,wlon) arrays to (lat,lon)."""
        f = np.cos(np.radians(lat))
        dlat = (wlat - lat + 180.0) % 360.0 - 180.0
        dlon = f * ((wlon - lon + 180.0) % 360.0 - 180.0)
        return int(np.argmin(dlat * dlat + dlon * dlon))

    def getwpinear(self, lat, lon):
        return self.getinear(self.wplat, self.wplon, lat, lon)

    def getapinear(self, lat, lon):
        return self.getinear(self.aptlat, self.aptlon, lat, lon)

    def getinside(self, wlat, wlon, lat0, lat1, lon0, lon1):
        """Indices of points inside a lat/lon box."""
        if lat1 < lat0:
            lat0, lat1 = lat1, lat0
        arr = (wlat >= lat0) & (wlat <= lat1) \
            & (wlon >= lon0) & (wlon <= lon1)
        return list(np.flatnonzero(arr))

    # -------------------------------------------------------------- airways
    def listairway(self, awid):
        """Ordered leg chains for an airway id (navdatabase.py:253-320)."""
        legs = self._awmap.get(awid.upper())
        if not legs:
            return []
        remaining = {(self.awfromwpid[i], self.awtowpid[i]) for i in legs}
        chains = []
        while remaining:
            frm, to = remaining.pop()
            chain = [frm, to]
            grown = True
            while grown:
                grown = False
                for a, b in list(remaining):
                    if a == chain[-1]:
                        chain.append(b)
                    elif b == chain[0]:
                        chain.insert(0, a)
                    elif a == chain[0]:
                        chain.insert(0, b)
                    elif b == chain[-1]:
                        chain.append(a)
                    else:
                        continue
                    remaining.discard((a, b))
                    grown = True
            chains.append(chain)
        return chains

    def listconnections(self, wpid, wplat=None, wplon=None):
        """(airway, other-endpoint) pairs touching waypoint wpid."""
        name = wpid.upper()
        out = []
        for i, aid in enumerate(self.awid):
            if self.awfromwpid[i] == name:
                out.append((aid, self.awtowpid[i]))
            elif self.awtowpid[i] == name:
                out.append((aid, self.awfromwpid[i]))
        # unique, stable order
        seen = set()
        uniq = []
        for pair in out:
            if pair not in seen:
                seen.add(pair)
                uniq.append(pair)
        return uniq

    # ------------------------------------------------------ user waypoints
    def defwpt(self, name, lat, lon, wptype="DEF"):
        """User-defined waypoint; redefining an existing user waypoint
        moves it (navdatabase.py:96-138 rejects duplicates; moving is the
        friendlier behavior and keeps scenario replay idempotent)."""
        name = name.upper()
        for i in self._wpmap.get(name, []):
            if self.wptype[i] == wptype:
                self.wplat[i] = lat
                self.wplon[i] = lon
                return True
        self.wpid.append(name)
        self.wplat = np.append(self.wplat, lat)
        self.wplon = np.append(self.wplon, lon)
        self.wptype.append(wptype)
        self._wpmap[name].append(len(self.wpid) - 1)
        return True

    # ------------------------------------------------------- text position
    def txt2pos(self, txt, reflat=999999.0, reflon=999999.0):
        """Resolve a named position to (lat, lon): airport first, then
        waypoint/navaid (parity: tools/position.py:6).  ``APT/RWNN`` (or
        RWYNN) resolves to the runway threshold when known."""
        if "/" in txt:
            apt, rwy = txt.split("/", 1)
            thr = self.getrwythreshold(apt, rwy)
            if thr is not None:
                return (thr[0], thr[1])
            if not self.rwythresholds.get(apt.upper()):
                # No threshold data for this AIRPORT at all (apt.zip
                # absent, no DEFRWY): degrade to the airport's own
                # position instead of failing hard (the reference raises
                # here, tools/position.py:52-60 — but it always ships
                # apt.zip).  When the airport HAS a threshold table, a
                # miss is a bad runway ident and stays an error.
                i = self.getaptidx(apt)
                if i >= 0:
                    return (float(self.aptlat[i]), float(self.aptlon[i]))
            # Not a resolvable runway (or a '/'-containing fix name):
            # fall through to the normal full-token lookup.
        i = self.getaptidx(txt)
        if i >= 0:
            return (float(self.aptlat[i]), float(self.aptlon[i]))
        i = self.getwpidx(txt, reflat, reflon)
        if i >= 0:
            return (float(self.wplat[i]), float(self.wplon[i]))
        return None

    # ------------------------------------------------------- runways
    def getrwythreshold(self, apt, rwy):
        """(lat, lon, bearing_deg) of a runway threshold, or None.

        Accepts RW06/RWY06/06 spellings (reference stores bare ids)."""
        table = self.rwythresholds.get(apt.upper())
        if not table:
            return None
        r = rwy.upper()
        for cand in (r, r.removeprefix("RWY"), r.removeprefix("RW")):
            if cand in table:
                return tuple(table[cand])
        return None

    def defrwy(self, apt, rwy, lat, lon, hdg):
        """Register a runway threshold at runtime — scenarios/tests can
        define runways when no apt.zip data ships (the reference's
        threshold database comes from an apt.zip absent from this
        snapshot; the loader in loaders.py reads it when present)."""
        key = rwy.upper().removeprefix("RWY").removeprefix("RW")
        self.rwythresholds.setdefault(apt.upper(), {})[key] = (
            float(lat), float(lon), float(hdg) % 360.0)
