"""Text-to-SI unit converters (reference tools/misc.py:18-150).

Shared by the stack argument parser AND the core route layer (AT
alt/spd constraint syntax) — pure text -> number helpers with no
dependency on either layer, so neither has to import the other.
"""
import re

from ..ops import aero


def txt2alt(txt: str) -> float:
    """Altitude text -> metres: 'FL200' -> 20000 ft; bare number = feet
    (tools/misc.py:18-38)."""
    t = txt.upper().strip()
    if t.startswith("FL"):
        return float(t[2:]) * 100.0 * aero.ft
    return float(t) * aero.ft


def txt2spd(txt: str) -> float:
    """Speed text -> CAS [m/s] or Mach: 'M.8'/'M08'/'.8' -> 0.8 Mach,
    else knots CAS (tools/misc.py:66-92)."""
    t = txt.upper().strip()
    if t.startswith("M"):
        t = t[1:]
        m = float(t) if "." in t else float("0." + t.lstrip("0") or "0")
        return m
    v = float(t)
    if 0.1 < v < 1.0:
        return v          # Mach
    return v * aero.kts   # knots -> m/s CAS


def txt2vspd(txt: str) -> float:
    """Vertical speed text [fpm] -> m/s."""
    return float(txt) * aero.fpm


def txt2hdg(txt: str) -> float:
    return float(txt) % 360.0


def txt2time(txt: str) -> float:
    """'[HH:]MM:SS[.hh]' or plain seconds -> seconds."""
    parts = txt.strip().split(":")
    if len(parts) == 1:
        return float(parts[0])
    sec = float(parts[-1])
    mins = int(parts[-2]) if len(parts) >= 2 else 0
    hrs = int(parts[-3]) if len(parts) >= 3 else 0
    return hrs * 3600.0 + mins * 60.0 + sec


def txt2lat(txt: str) -> float:
    """Latitude text: decimal or N/S prefix/suffix, DMS with ' " separators."""
    return _txt2deg(txt, "NS")


def txt2lon(txt: str) -> float:
    return _txt2deg(txt, "EW")


def _txt2deg(txt: str, hemis: str) -> float:
    t = txt.upper().strip()
    sign = 1.0
    if t and t[0] in hemis:
        sign = -1.0 if t[0] in "SW" else 1.0
        t = t[1:]
    elif t and t[-1] in hemis:
        sign = -1.0 if t[-1] in "SW" else 1.0
        t = t[:-1]
    if "'" in t or '"' in t or "°" in t:
        parts = re.split(r"[°'\"]+", t)
        parts = [p for p in parts if p]
        deg = float(parts[0])
        minutes = float(parts[1]) if len(parts) > 1 else 0.0
        seconds = float(parts[2]) if len(parts) > 2 else 0.0
        return sign * (deg + minutes / 60.0 + seconds / 3600.0)
    return sign * float(t)
