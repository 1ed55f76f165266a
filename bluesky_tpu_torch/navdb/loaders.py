"""Text-format loaders for the navigation database
(parity: bluesky/navdatabase/load_navdata_txt.py, loadnavdata.py).

All loaders gate on file presence (this data snapshot has no awy.dat or
apt.zip, and user setups may lack everything) and return plain dicts of
numpy arrays / lists.  A pickled cache keyed by source mtimes makes
subsequent startups instant (parity: tools/cachefile.py).

Formats (x-plane lineage):
  fix.dat       ``lat lon ident`` per line
  nav.dat       ``type lat lon elev freq range var ident name...``
                (type 2 = NDB, 3 = VOR/DME, others ignored like the
                reference keeps only en-route aids)
  airports.dat  CSV ``code, name, lat, lon, class, maxrunway_ft, country,
                elev_ft`` with a # header
  awy.dat       ``fromwp fromlat fromlon towp tolat tolon ndir lowfl upfl
                awid[-awid2...]``
  fir/*.txt     ``Ndd.mm.ss.sss Eddd.mm.ss.sss`` polygon vertper line
"""
import os
import pickle

import numpy as np

CACHE_VERSION = 1


def _dms2deg(token: str) -> float:
    """'N052.16.00.000' -> 52.2667; S/W negative."""
    sign = -1.0 if token[0] in "SW" else 1.0
    d, m, s, ms = (token[1:].split(".") + ["0"] * 4)[:4]
    return sign * (float(d) + float(m) / 60.0 +
                   float(f"{s}.{ms}") / 3600.0)


def load_fix(path):
    wpid, wplat, wplon = [], [], []
    with open(path, errors="replace") as f:
        for line in f:
            fields = line.split()
            if len(fields) < 3:
                continue
            try:
                lat, lon = float(fields[0]), float(fields[1])
            except ValueError:
                continue
            wpid.append(fields[2].upper())
            wplat.append(lat)
            wplon.append(lon)
    return dict(wpid=wpid, wplat=np.array(wplat), wplon=np.array(wplon),
                wptype=["FIX"] * len(wpid))


def load_nav(path):
    """NDB (2) and VOR/DME (3) en-route navaids."""
    wpid, wplat, wplon, wptype, wpfreq = [], [], [], [], []
    with open(path, errors="replace") as f:
        for line in f:
            fields = line.split()
            if len(fields) < 9:
                continue
            if fields[0] not in ("2", "3"):
                continue
            try:
                lat, lon = float(fields[1]), float(fields[2])
                freq = float(fields[4])
            except ValueError:
                continue
            wpid.append(fields[7].upper())
            wplat.append(lat)
            wplon.append(lon)
            wptype.append("NDB" if fields[0] == "2" else "VOR")
            wpfreq.append(freq)
    return dict(wpid=wpid, wplat=np.array(wplat), wplon=np.array(wplon),
                wptype=wptype, wpfreq=wpfreq)


def load_airports(path):
    aptid, aptname, aptlat, aptlon = [], [], [], []
    aptmaxrwy, aptco, aptelev = [], [], []
    with open(path, errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = [c.strip() for c in line.split(",")]
            if len(fields) < 7:
                continue
            try:
                lat, lon = float(fields[2]), float(fields[3])
            except ValueError:
                continue
            aptid.append(fields[0].upper())
            aptname.append(fields[1])
            aptlat.append(lat)
            aptlon.append(lon)
            try:
                aptmaxrwy.append(float(fields[5]) * 0.3048)   # ft -> m
            except ValueError:
                aptmaxrwy.append(0.0)
            aptco.append(fields[6])
            try:
                aptelev.append(float(fields[7]) * 0.3048)
            except (IndexError, ValueError):
                aptelev.append(0.0)
    return dict(aptid=aptid, aptname=aptname, aptlat=np.array(aptlat),
                aptlon=np.array(aptlon), aptmaxrwy=np.array(aptmaxrwy),
                aptco=aptco, aptelev=np.array(aptelev))


def load_airways(path):
    awid, awfrom, awto = [], [], []
    awfromlat, awfromlon, awtolat, awtolon = [], [], [], []
    awndir, awlowfl, awupfl = [], [], []
    with open(path, errors="replace") as f:
        for line in f:
            fields = line.split()
            if len(fields) < 10:
                continue
            try:
                flat, flon = float(fields[1]), float(fields[2])
                tlat, tlon = float(fields[4]), float(fields[5])
                ndir, lofl, upfl = (int(fields[6]), int(fields[7]),
                                    int(fields[8]))
            except ValueError:
                continue
            # the id field may chain several airways: 'UL602-UL607'
            for aid in fields[9].split("-"):
                awid.append(aid.strip().upper())
                awfrom.append(fields[0].upper())
                awto.append(fields[3].upper())
                awfromlat.append(flat)
                awfromlon.append(flon)
                awtolat.append(tlat)
                awtolon.append(tlon)
                awndir.append(ndir)
                awlowfl.append(lofl)
                awupfl.append(upfl)
    return dict(awid=awid, awfromwpid=awfrom, awtowpid=awto,
                awfromlat=np.array(awfromlat), awfromlon=np.array(awfromlon),
                awtolat=np.array(awtolat), awtolon=np.array(awtolon),
                awndir=awndir, awlowfl=awlowfl, awupfl=awupfl)


def load_firs(dirpath):
    firs = {}
    for fname in sorted(os.listdir(dirpath)):
        if not fname.endswith(".txt"):
            continue
        lat, lon = [], []
        with open(os.path.join(dirpath, fname), errors="replace") as f:
            for line in f:
                fields = line.split()
                if len(fields) < 2:
                    continue
                try:
                    lat.append(_dms2deg(fields[0]))
                    lon.append(_dms2deg(fields[1]))
                except (ValueError, IndexError):
                    continue
        if lat:
            firs[fname[:-4].upper()] = np.column_stack([lat, lon])
    return firs


def load_countries(path):
    """CSV ``name,code,...`` -> {code: name}."""
    codes = {}
    with open(path, errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = [c.strip() for c in line.split(",")]
            if len(fields) >= 2 and 0 < len(fields[1]) <= 2:
                codes[fields[1].upper()] = fields[0]
    return codes


def load_rwythresholds(path):
    """apt -> {rwy -> (lat, lon, bearing)} from X-Plane apt.dat in apt.zip.

    Same source rows as the reference (load_visuals_txt.py:256-302):
    airport row '1 ... icao', runway row '100' with both runway ends —
    each end yields a threshold displaced along the runway bearing by its
    displacement distance.  Vectorized per-file parse is pointless here
    (one-time, cached); the displaced-threshold great-circle step uses
    the same spherical forward equations as the reference ``thrpoints``.
    """
    import math
    import zipfile
    rearth = 6371000.0
    out = {}
    cur = None

    def displaced(lat0, lon0, lat1, lon1, offset):
        """Threshold of the runway end at (lat0, lon0), displaced toward
        (lat1, lon1) by offset metres; returns (latd, lond, bearing_deg)."""
        la0, lo0 = math.radians(lat0), math.radians(lon0)
        la1, lo1 = math.radians(lat1), math.radians(lon1)
        dl = lo1 - lo0
        brg = math.atan2(math.sin(dl) * math.cos(la1),
                         math.cos(la0) * math.sin(la1)
                         - math.sin(la0) * math.cos(la1) * math.cos(dl))
        d = offset / rearth
        latd = math.asin(math.sin(la0) * math.cos(d)
                         + math.cos(la0) * math.sin(d) * math.cos(brg))
        lond = lo0 + math.atan2(
            math.sin(brg) * math.sin(d) * math.cos(la0),
            math.cos(d) - math.sin(la0) * math.sin(latd))
        return (math.degrees(latd), math.degrees(lond),
                math.degrees(brg) % 360.0)

    with zipfile.ZipFile(path) as zf, zf.open("apt.dat") as f:
        for raw in f:
            elems = raw.decode("ascii", errors="ignore").split()
            if not elems:
                continue
            if elems[0] == "1" and len(elems) > 4:
                cur = out.setdefault(elems[4], {})
            elif elems[0] == "100" and cur is not None and len(elems) > 20:
                if int(elems[2]) > 2:      # asphalt/concrete only
                    continue
                lat0, lon0, off0 = (float(elems[9]), float(elems[10]),
                                    float(elems[11]))
                lat1, lon1, off1 = (float(elems[18]), float(elems[19]),
                                    float(elems[20]))
                cur[elems[8]] = displaced(lat0, lon0, lat1, lon1, off0)
                cur[elems[17]] = displaced(lat1, lon1, lat0, lon0, off1)
    return out


def load_navdata(navdata_path, cache_path=None):
    """Load everything available under navdata_path, with pickle caching."""
    sources = {name: os.path.join(navdata_path, name)
               for name in ("fix.dat", "nav.dat", "airports.dat", "awy.dat",
                            "icao-countries.dat", "apt.zip")}
    sources["fir"] = os.path.join(navdata_path, "fir")
    stamps = {k: os.path.getmtime(p) for k, p in sources.items()
              if os.path.exists(p)}

    cachefile = None
    if cache_path:
        os.makedirs(cache_path, exist_ok=True)
        cachefile = os.path.join(cache_path, "navdata.p")
        if os.path.isfile(cachefile):
            try:
                with open(cachefile, "rb") as f:
                    cached = pickle.load(f)
                if cached.get("version") == CACHE_VERSION \
                        and cached.get("stamps") == stamps:
                    return cached["data"]
            except Exception:
                pass

    data = dict(wpid=[], wplat=np.zeros(0), wplon=np.zeros(0), wptype=[],
                aptid=[], aptname=[], aptlat=np.zeros(0),
                aptlon=np.zeros(0), aptmaxrwy=np.zeros(0), aptco=[],
                aptelev=np.zeros(0), awid=[], awfromwpid=[], awtowpid=[],
                awfromlat=np.zeros(0), awfromlon=np.zeros(0),
                awtolat=np.zeros(0), awtolon=np.zeros(0), awndir=[],
                awlowfl=[], awupfl=[], firs={}, countries={})
    if "fix.dat" in stamps:
        fix = load_fix(sources["fix.dat"])
        nav = load_nav(sources["nav.dat"]) if "nav.dat" in stamps \
            else dict(wpid=[], wplat=np.zeros(0), wplon=np.zeros(0),
                      wptype=[])
        data["wpid"] = fix["wpid"] + nav["wpid"]
        data["wplat"] = np.concatenate([fix["wplat"], nav["wplat"]])
        data["wplon"] = np.concatenate([fix["wplon"], nav["wplon"]])
        data["wptype"] = fix["wptype"] + nav["wptype"]
    if "airports.dat" in stamps:
        data.update(load_airports(sources["airports.dat"]))
    if "awy.dat" in stamps:
        data.update(load_airways(sources["awy.dat"]))
    if "fir" in stamps:
        data["firs"] = load_firs(sources["fir"])
    if "icao-countries.dat" in stamps:
        data["countries"] = load_countries(sources["icao-countries.dat"])
    if "apt.zip" in stamps:
        data["rwythresholds"] = load_rwythresholds(sources["apt.zip"])

    if cachefile:
        try:
            with open(cachefile, "wb") as f:
                pickle.dump({"version": CACHE_VERSION, "stamps": stamps,
                             "data": data}, f, protocol=4)
        except Exception:
            pass
    return data
