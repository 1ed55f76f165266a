"""Typed command-argument parsing for the stack.

Parity with the reference parser utilities: ``Argparser`` argtype dispatch
(stack/stack.py:1467-1748) and the text converters in ``tools/misc.py``
(txt2alt :18, txt2spd :66, txt2lat/lon, cmdsplit :125) — reimplemented as
small pure functions keyed by argtype name.  Position text resolution
(``tools/position.py``) consults the navdatabase when one is attached.

Supported argtypes (subset used by the built-in command dict, same names as
the reference): txt (uppercased), word (case-preserving — use for
filenames), string, acid, wpinroute, float, int, onoff, alt, spd,
vspd, hdg, time, latlon, lat, lon, wpt, pandir, color.  A trailing
``...`` repeats the last group.  Optional args are marked with brackets in
the usage string and simply absent from the tail.
"""
import re
from typing import Any, List, Tuple



class NamedPos(tuple):
    """(lat, lon) that remembers the resolved position's name."""
    name = None


class ArgError(Exception):
    pass


def cmdsplit(cmdline: str) -> List[str]:
    """Split a command line on commas/spaces, preserving empty slots from
    adjacent commas (tools/misc.py:125-150)."""
    cmdline = cmdline.strip()
    if not cmdline:
        return []
    if ',' in cmdline:
        parts = [p.strip() for p in re.split(',', cmdline)]
        # allow spaces inside first arg block
        out = []
        for p in parts:
            if out:
                out.append(p)
            else:
                out.extend(p.split())
        return out
    return cmdline.split()


# Unit converters live in utils/units.py (shared with the core
# route layer); re-exported here for the argtype table and
# existing importers.
from ..utils.units import (txt2alt, txt2spd, txt2vspd,  # noqa: E402,F401
                           txt2hdg, txt2time, txt2lat, txt2lon)


_ISLATLON = re.compile(r"^[NSEW]?[-+]?[\d.]+[NSEW]?$")


class Argparser:
    """Parse an argument list against a comma-separated argtype spec."""

    def __init__(self, sim):
        self.sim = sim   # for acid lookup, navdb, reflat/lon

    def parse(self, argtypes: str, args: List[str]) -> List[Any]:
        """Returns converted argument values; raises ArgError on mismatch.

        Mirrors Argparser.parse (stack.py:1467-1560): optional args are
        bracketed in the spec ('[alt]'), a trailing '...' repeats the
        preceding group for any remaining arguments.  'latlon' consumes two
        numeric tokens (lat, lon) or one named-position token and yields a
        (lat, lon) tuple.
        """
        # Preprocess the spec: tokens split on commas; '[' opens an optional
        # region spanning tokens until the matching ']' (reference usage
        # strings group several optionals in one bracket, e.g.
        # "acid,latlon,[alt,spd,afterwp]"); '...' marks the rest repeating.
        tokens: List[Tuple[str, bool]] = []   # (argtype, optional)
        repeating = False
        depth = 0
        for raw in (argtypes.split(",") if argtypes else []):
            t = raw.strip()
            opens = t.count("[")
            closes = t.count("]")
            t = t.strip("[]").strip()
            was_optional = depth > 0 or opens > 0
            depth += opens - closes
            if t == "...":
                repeating = True
                continue
            if t:
                tokens.append((t, was_optional))

        out: List[Any] = []
        self._last_acid = -1       # reference position for named waypoints
        ai = 0
        si = 0
        while si < len(tokens) or (repeating and ai < len(args)):
            if si < len(tokens):
                st2, optional = tokens[si]
            else:
                st2, optional = tokens[-1] if tokens else ("string", True)
            if ai >= len(args) or args[ai] == "":
                if ai < len(args):    # empty placeholder token, e.g. "A,,B"
                    out.append(None)
                    ai += 1
                    si += 1
                    continue
                if optional or si >= len(tokens):
                    break
                raise ArgError(f"missing argument <{st2}>")
            if st2 == "string" and not repeating and si == len(tokens) - 1:
                # Greedy rest-of-line (reference stack.py 'string' argtype)
                # — only as the FINAL spec token; 'string,...' specs
                # (DELAY/SYN/PCALL) keep per-token parsing, their handlers
                # re-join or index the words.
                out.append(" ".join(a for a in args[ai:] if a != ""))
                ai = len(args)
            elif st2 == "latlon":
                val, consumed = self._parse_latlon(args, ai)
                out.append(val)
                ai += consumed
            elif st2 == "wppos":
                # Waypoint position for route editing: the FLYBY/FLYOVER
                # turn-mode keywords win over any same-named navdb fix
                # (reference route.py:77-92 checks the keyword BEFORE
                # resolving — there IS a US fix named FLYBY)
                kw = args[ai].strip().upper()
                if kw in ("FLYBY", "FLY-BY", "FLYOVER", "FLY-OVER"):
                    np_ = NamedPos((0.0, 0.0))
                    np_.name = kw
                    out.append(np_)
                    ai += 1
                else:
                    val, consumed = self._parse_latlon(args, ai)
                    out.append(val)
                    ai += consumed
            else:
                out.append(self.parse_arg(st2, args[ai], out))
                ai += 1
            si += 1
        if ai < len(args) and not repeating:
            raise ArgError(f"too many arguments: {' '.join(args[ai:])}")
        return out

    def _parse_latlon(self, args: List[str], ai: int):
        """(lat, lon) from two numeric tokens or one named position.

        Named positions come back as a NamedPos (a (lat, lon) tuple that
        also carries .name) so route commands can keep the waypoint name
        (reference wpt argtype keeps names, stack.py Argparser)."""
        t = args[ai].strip()
        if _ISLATLON.match(t.upper()) and any(c.isdigit() for c in t):
            if ai + 1 >= len(args):
                raise ArgError("latlon: missing longitude")
            return (txt2lat(t), txt2lon(args[ai + 1])), 2
        # Named position: navdb lookup if attached.  When an aircraft was
        # parsed earlier in this command its position disambiguates
        # duplicate waypoint names (reference position.py/getwpidx
        # semantics).
        navdb = getattr(self.sim, "navdb", None)
        if navdb is not None:
            reflat = reflon = 999999.0
            idx = self._last_acid
            if idx >= 0:
                ac = self.sim.traf.state.ac
                reflat = float(ac.lat[idx])    # single-element transfer
                reflon = float(ac.lon[idx])
            pos = navdb.txt2pos(t, reflat, reflon)
            if pos is not None:
                np_ = NamedPos((pos[0], pos[1]))
                np_.name = t.upper()
                return np_, 1
        raise ArgError(f"{t}: position not found")

    def parse_arg(self, argtype: str, txt: str, sofar: List[Any]):
        t = txt.strip()
        # Union types 'a/b' (reference e.g. 'acid/txt', 'float/txt'):
        # first alternative that parses wins.
        if "/" in argtype:
            err = None
            for alt in argtype.split("/"):
                try:
                    return self.parse_arg(alt.strip(), txt, sofar)
                except ArgError as e:
                    err = e
            raise err
        try:
            if argtype in ("txt", "string", "word"):
                return t.upper() if argtype == "txt" else t
            if argtype == "acid":
                idx = self.sim.traf.id2idx(t)
                if idx < 0:
                    raise ArgError(f"{t}: aircraft not found")
                self._last_acid = idx
                return idx
            if argtype == "wpinroute":
                return t.upper()
            if argtype == "float":
                return float(t)
            if argtype == "int":
                return int(float(t))
            if argtype == "onoff":
                u = t.upper()
                if u in ("ON", "TRUE", "YES", "1"):
                    return True
                if u in ("OFF", "FALSE", "NO", "0"):
                    return False
                raise ArgError(f"{t}: expected ON/OFF")
            if argtype == "alt":
                return txt2alt(t)
            if argtype == "spd":
                return txt2spd(t)
            if argtype == "vspd":
                return txt2vspd(t)
            if argtype == "hdg":
                return txt2hdg(t)
            if argtype == "time":
                return txt2time(t)
            if argtype == "lat":
                return txt2lat(t)
            if argtype == "lon":
                return txt2lon(t)
            if argtype == "latlon":
                # Either two numeric tokens (lat lon — caller passes lat here
                # and we signal to consume the next token), or a named
                # position resolved via the navdb.
                raise ArgError("latlon handled by parse()")
            if argtype == "wpt":
                return t.upper()
            if argtype == "pandir":
                u = t.upper()
                if u in ("LEFT", "RIGHT", "UP", "DOWN"):
                    return u
                raise ArgError(f"{t}: expected LEFT/RIGHT/UP/DOWN")
            if argtype == "color":
                return t.upper()
        except ArgError:
            raise
        except Exception as e:
            raise ArgError(f"{t}: invalid {argtype} ({e})")
        raise ArgError(f"unknown argtype {argtype}")
