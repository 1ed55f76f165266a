"""EUROCONTROL SO6 flight-plan -> BlueSky scenario converter.

Role parity with the reference's scenario-creation tooling
(`/root/reference/utils/Scenario-creator/so6_to_scn.py`, a bit-rotted
Tk-era script): turn an SO6 "m1" trajectory file into a runnable `.scn`
— one timed `CRE` per flight at its first segment plus `ADDWPT` route
waypoints with altitude/speed constraints for the remaining segment
ends, so the FMS flies the profile.

SO6 m1 format (one segment per line, space-separated, 20 fields):

  seg_name origin destination actype t_begin t_end fl_begin fl_end
  status callsign date_begin date_end lat_begin lon_begin lat_end
  lon_end flightid sequence length [parity]

with latitudes/longitudes in MINUTES of arc (divide by 60), flight
levels in FL, times ``HHMMSS``, dates ``YYMMDD``, segment length in nm.

Usage:  python -m bluesky_tpu_torch.utils.so6 flights.so6 [out.scn]

Port of ``bluesky_tpu/utils/so6.py``: pure host code, copied as it is;
the bearings and distances come from the port's ``ops/hostgeo`` (NumPy).
"""
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class _Flight:
    actype: str
    t0: int                      # [s] first segment start (absolute)
    segs: List[Tuple] = field(default_factory=list)
    # seg: (t_begin, t_end, fl0, fl1, lat0, lon0, lat1, lon1, len_nm)


def _hms(t: str) -> int:
    t = t.zfill(6)
    return int(t[0:2]) * 3600 + int(t[2:4]) * 60 + int(t[4:6])


def _fmt_t(sec: float) -> str:
    sec = max(0.0, sec)
    h, rem = divmod(int(sec), 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}.00"


def parse_so6(lines) -> Dict[str, _Flight]:
    """Parse SO6 text lines into per-flight segment lists.

    Key is ``callsign:flightid`` (SO6 repeats callsigns across days);
    malformed lines are skipped with a notice on stderr.
    """
    flights: Dict[str, _Flight] = {}
    for ln, line in enumerate(lines, 1):
        f = line.split()
        if not f or line.lstrip().startswith("#"):
            continue
        if len(f) < 19:
            print(f"so6: line {ln}: {len(f)} fields < 19 — skipped",
                  file=sys.stderr)
            continue
        try:
            actype = f[3]
            tb, te = _hms(f[4]), _hms(f[5])
            # date rollover: segments crossing midnight end "earlier"
            if te < tb:
                te += 86400
            fl0, fl1 = int(f[6]), int(f[7])
            callsign = f[9]
            lat0, lon0 = float(f[12]) / 60.0, float(f[13]) / 60.0
            lat1, lon1 = float(f[14]) / 60.0, float(f[15]) / 60.0
            fid = f[16]
            seq = int(f[17])
            length = float(f[18])
        except ValueError as e:
            print(f"so6: line {ln}: {e} — skipped", file=sys.stderr)
            continue
        key = f"{callsign}:{fid}"
        fl = flights.setdefault(key, _Flight(actype=actype, t0=tb))
        fl.segs.append((seq, tb, te, fl0, fl1, lat0, lon0, lat1, lon1,
                        length))
    for fl in flights.values():
        fl.segs.sort()
        # Midnight rollover ACROSS segments: walking the flight in
        # sequence order, a start time below the previous one means the
        # clock wrapped — shift the rest of the flight by whole days so
        # the timeline stays monotonic.
        off, prev_tb = 0, None
        segs = []
        for (seq, tb, te, *rest) in fl.segs:
            if prev_tb is not None and tb + off < prev_tb:
                off += 86400
            prev_tb = tb + off
            segs.append((seq, tb + off, te + off, *rest))
        fl.segs = segs
        fl.t0 = fl.segs[0][1]
    return flights


def convert(lines, rel_time: bool = True) -> List[str]:
    """SO6 lines -> scenario lines (``HH:MM:SS.00>CMD``).

    ``rel_time`` rebases the earliest segment start to scenario t=0
    (the usual replay case); False keeps absolute day times.
    """
    from ..ops import hostgeo
    flights = parse_so6(lines)
    if not flights:
        return []
    base = min(fl.t0 for fl in flights.values()) if rel_time else 0
    out: List[Tuple[float, str]] = []
    # SO6 repeats callsigns across flight ids (that is why flights are
    # keyed callsign:flightid) — but CRE needs a unique acid, or the
    # second flight's aircraft silently fails to spawn at replay time.
    # Repeated callsigns get a _2/_3... suffix, first occurrence keeps
    # the bare name; suffixes are checked against BOTH already-emitted
    # acids and every genuine callsign in the file, so a synthetic AB_2
    # can never collide with a real flight named AB_2.
    all_base = {k.split(":")[0] for k in flights}
    used: set = set()
    for key, fl in flights.items():
        cs = key.split(":")[0]
        acid = cs
        k = 2
        while acid in used or (acid != cs and acid in all_base):
            acid = f"{cs}_{k}"
            k += 1
        used.add(acid)
        if acid != cs:
            print(f"so6: duplicate callsign {cs!r} — emitting as "
                  f"{acid}", file=sys.stderr)
        _, tb, te, fl0, fl1, lat0, lon0, lat1, lon1, length = fl.segs[0]
        qdr, dist_nm = hostgeo.qdrdist(lat0, lon0, lat1, lon1)
        dur = max(te - tb, 1)
        gs_kts = (length if length > 0 else float(dist_nm)) * 3600.0 / dur
        t = fl.t0 - base
        out.append((t, f"CRE {acid} {fl.actype} {lat0:.6f} {lon0:.6f} "
                       f"{float(qdr) % 360.0:.1f} FL{fl0:03d} "
                       f"{min(gs_kts, 600.0):.0f}"))
        # route: every segment END becomes a waypoint with its FL (and
        # the segment speed), so VNAV/LNAV fly the profile
        for (_, tb, te, fl0, fl1, lat0, lon0, lat1, lon1,
             length) in fl.segs:
            dur = max(te - tb, 1)
            spd = (length * 3600.0 / dur) if length > 0 else 0.0
            spdarg = f" {min(spd, 600.0):.0f}" if spd > 0 else ""
            out.append((t + 0.01,
                        f"ADDWPT {acid} {lat1:.6f} {lon1:.6f} "
                        f"FL{fl1:03d}{spdarg}"))
        out.append((t + 0.02, f"LNAV {acid} ON"))
        out.append((t + 0.02, f"VNAV {acid} ON"))
    out.sort(key=lambda x: x[0])
    return [f"{_fmt_t(t)}>{cmd}" for t, cmd in out]


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    src = argv[0]
    dst = argv[1] if len(argv) > 1 else src.rsplit(".", 1)[0] + ".scn"
    with open(src) as f:
        scn = convert(f.readlines())
    with open(dst, "w") as f:
        f.write("\n".join(scn) + "\n")
    nfl = sum(1 for l in scn if ">CRE " in l)
    print(f"so6: {src} -> {dst} ({nfl} flights, {len(scn)} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
