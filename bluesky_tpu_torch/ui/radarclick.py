"""Radar-click to command-line completion (reference ui/radarclick.py:10-191).

Translates a click at (lat, lon) on the radar into text appended to the
current command line — the nearest aircraft id, the clicked position, a
heading from the current reference point, the nearest airport, or the
nearest waypoint in the subject aircraft's route — driven by a per-command
click-argument signature table.  When the clicked argument completes the
command, the full line is returned for the stack.

Redesign notes: the reference reads the ``bs.traf``/``bs.navdb`` singletons
and the stack's module-level synonym dict; here everything is passed in via
the owning ``Simulation`` (no globals), and the nearest-point searches are
NumPy argmin over the flat-earth metric like the reference's
``tools.misc.findnearest``.

Port of ``bluesky_tpu/ui/radarclick.py``: the live positions come to the
host in one device-to-host copy (``_live``), the stack's ``cmdsplit`` and
the flat-earth distance are the port's (``stack.argparser``,
``ops.geo`` on float64 tensors).
"""
import math

import numpy as np

#: Which argument positions are clickable, per command
#: (reference radarclick.py:16-59; "-" = not clickable, "..." = the
#: one-but-last repeats, e.g. polygon vertices).
CLICKCMD = {
    "": "acid,-",
    "ADDWPT": "acid,latlon,-,-,wpinroute,-",
    "AFTER": "acid,wpinroute,-",
    "AT": "acid,wpinroute,-",
    "ALT": "acid,-",
    "AREA": "latlon,-,latlon",
    "ASAS": "acid,-",
    "BOX": "-,latlon,-,latlon",
    "CIRCLE": "-,latlon,-,dist",
    "CRE": "-,-,latlon,-,hdg,-,-",
    "DEFWPT": "-,latlon,-",
    "DEL": "acid,-",
    "DELWPT": "acid,wpinroute,-",
    "DELRTE": "acid,-",
    "DEST": "acid,apt",
    "DIRECT": "acid,wpinroute",
    "DIST": "latlon,-,latlon",
    "DUMPRTE": "acid",
    "ENG": "acid,-",
    "GETWIND": "latlon,-",
    "HDG": "acid,hdg",
    "LINE": "-,latlon,-,latlon",
    "LISTRTE": "acid,-",
    "LNAV": "acid,-",
    "MOVE": "acid,latlon,-,-,hdg",
    "NAVDISP": "acid",
    "NOM": "acid",
    "ND": "acid",
    "ORIG": "acid,apt",
    "PAN": "latlon",
    "POLY": "-,latlon,...",
    "POLYALT": "-,-,-,latlon,...",
    "POLYGON": "-,latlon,...",
    "POLYLINE": "-,latlon,...",
    "POS": "acid",
    "SSD": "acid,...",
    "SPD": "acid,-",
    "TRAIL": "acid,-",
    "VNAV": "acid,-",
    "VS": "acid,-",
    "WIND": "latlon,-",
    "WINDGFS": "latlon,-,latlon,-",
}


def findnearest(lat, lon, latarr, lonarr):
    """Index of the nearest point, flat-earth metric (reference
    tools/misc.py findnearest); -1 when the arrays are empty."""
    latarr = np.asarray(latarr, float)
    lonarr = np.asarray(lonarr, float)
    if latarr.size == 0:
        return -1
    d2 = (latarr - lat) ** 2 \
        + (np.cos(np.radians(lat)) * (lonarr - lon)) ** 2
    return int(np.argmin(d2))


def _live(sim):
    """(slots, ids, lats, lons) of live aircraft, the positions in one
    device-to-host copy."""
    from ..plugins import host_arrays
    slots = [s for s, i in enumerate(sim.traf.ids) if i is not None]
    ids = [sim.traf.ids[s] for s in slots]
    ac = sim.traf.state.ac
    lat, lon = host_arrays(ac.lat, ac.lon)
    return slots, ids, lat[slots], lon[slots]


def radarclick(cmdline, lat, lon, sim):
    """Process a click at (lat, lon) given the current command line.

    Returns ``(tostack, todisplay)``: text to send to the stack (when the
    click completes the command) and text to append to the visible command
    line ('\\n' = clear).  Mirrors reference radarclick.py:60-191.
    """
    todisplay = ""
    tostack = ""

    # Tokenize the way the stack does (commas AND spaces, reference
    # tools/misc.cmdsplit): a clicked "lat,lon " insertion counts as TWO
    # arguments, so multi-click commands (BOX/AREA/LINE/CRE...) advance
    # to the right click-argument.
    from ..stack.argparser import cmdsplit
    parts = cmdsplit(cmdline)
    cmd = parts[0].upper() if parts else ""
    args = parts[1:]
    numargs = len(args)

    slots, ids, aclat, aclon = _live(sim)

    # Double click on an aircraft label: POS command (radarclick.py:77-80)
    if numargs == 0 and cmd in ids:
        return "POS " + cmd, "\n"

    cmd = sim.stack.synonyms.get(cmd, cmd)
    lookup = CLICKCMD.get(cmd)
    if not lookup:
        return "", ""

    if cmdline and cmdline[-1] not in (" ", ","):
        todisplay = " "

    clickargs = lookup.lower().split(",")
    totargs = len(clickargs)
    curarg = numargs
    if clickargs[-1] == "...":        # repeating vertex argument
        totargs = 999
        curarg = min(curarg, len(clickargs) - 2)
    if curarg >= totargs:
        return "", ""
    clicktype = clickargs[curarg]

    if clicktype == "acid":
        idx = findnearest(lat, lon, aclat, aclon)
        if idx >= 0:
            todisplay += ids[idx] + " "

    elif clicktype == "latlon":
        todisplay += f"{round(lat, 6)},{round(lon, 6)} "

    elif clicktype == "dist":
        import torch
        from ..ops import geo
        try:
            latref, lonref = float(args[1]), float(args[2])
        except (IndexError, ValueError):
            return "", ""
        d = float(geo.kwikdist(*(torch.tensor(v, dtype=torch.float64)
                                 for v in (latref, lonref, lat, lon))))
        todisplay += str(round(d, 6))

    elif clicktype == "apt":
        navdb = getattr(sim, "navdb", None)
        if navdb is None or len(navdb.aptid) == 0:
            return "", ""
        idx = findnearest(lat, lon, navdb.aptlat, navdb.aptlon)
        if idx >= 0:
            todisplay += navdb.aptid[idx] + " "

    elif clicktype == "wpinroute":
        if not args or args[0].upper() not in ids:
            return "", ""
        slot = sim.traf.id2idx(args[0])
        r = sim.routes.route(slot)
        if r.nwp == 0:
            return "", ""
        iwp = findnearest(lat, lon, r.lat, r.lon)
        if iwp >= 0:
            todisplay += r.name[iwp] + " "

    elif clicktype == "hdg":
        # Heading from a command-specific reference point
        # (radarclick.py:155-183)
        try:
            if cmd == "CRE":
                reflat, reflon = float(args[2]), float(args[3])
            elif cmd == "MOVE":
                reflat, reflon = float(args[1]), float(args[2])
            else:
                if not args or args[0].upper() not in ids:
                    return "", ""
                k = slots.index(sim.traf.id2idx(args[0]))
                reflat, reflon = float(aclat[k]), float(aclon[k])
        except (IndexError, ValueError):
            return "", ""
        dy = lat - reflat
        dx = (lon - reflon) * math.cos(math.radians(reflat))
        hdg = math.degrees(math.atan2(dx, dy)) % 360.0
        todisplay += str(int(hdg)) + " "

    # Last argument clicked: complete the command (radarclick.py:186-189)
    if curarg + 1 >= totargs:
        tostack = cmdline + todisplay
        todisplay += "\n"
    return tostack, todisplay
