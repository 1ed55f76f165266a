"""SYN — parametric synthetic conflict geometries.

Parity with reference ``bluesky/stack/synthetic.py:13-438``: the SIMPLE /
SIMPLED / SUPER / SPHERE / MATRIX / FLOOR / TAKEOVER / WALL / ROW / COLUMN
generators used by the ASAS benchmark scenarios (geometry constants — 0.5 deg
circle radius, 200 kts, FL200, 1.1 formation spacing factor — kept so the
ASAS-* benchmark workloads are comparable).  Aircraft go through the normal
batched ``Traffic.create`` path, so a ``SYN SUPER 10000`` lands on device in
one flush.
"""
import numpy as np

from ..ops import aero

MPERDEG = 111319.0


def process(sim, subcmd, args):
    traf = sim.traf
    if subcmd is None or subcmd.upper() == "HELP":
        return True, ("SYN: synthetic traffic scenarios\n"
                      "Subcommands: SIMPLE, SIMPLED, SUPER n, SPHERE n, "
                      "MATRIX n, FLOOR, TAKEOVER n, WALL, ROW n ang, "
                      "COLUMN n ang")
    c = subcmd.upper()
    nargs = len(args)

    def reset():
        # Traffic-only, like the reference generators' bs.traf.reset()
        # (synthetic.py:48-327): sim settings/stack/logs must survive.
        sim.reset_traffic()

    if c == "SIMPLE":
        reset()
        traf.create(1, "B744", 5000 * aero.ft, 200.0, None, -0.5, 0.0, 0.0,
                    "OWNSHIP")
        traf.create(1, "B744", 5000 * aero.ft, 200.0, None, 0.0, 0.5, 270.0,
                    "INTRUDER")
        traf.flush()
        return True

    if c == "SIMPLED":
        reset()
        rng = traf._rng
        ds = rng.uniform(0.92, 1.08)
        dd = rng.uniform(0.92, 1.08)
        traf.create(1, "B744", 20000 * aero.ft, 200.0 * ds, None, -0.5 * dd,
                    0.0, 0.0, "OWNSHIP")
        traf.create(1, "B744", 20000 * aero.ft, 200.0 / ds, None, 0.0,
                    0.5 / dd, 270.0, "INTRUDER")
        traf.flush()
        return True

    if c == "SUPER":
        if nargs == 0:
            return True, "SYN SUPER <number of aircraft>"
        reset()
        numac = int(float(args[0]))
        dist = 0.5
        ang = 2 * np.pi / numac * np.arange(numac)
        traf.create(numac, "B744",
                    np.full(numac, 20000 * aero.ft),
                    np.full(numac, 200.0 * aero.kts), None,
                    dist * -np.cos(ang), dist * np.sin(ang),
                    360.0 - 360.0 / numac * np.arange(numac))
        traf.flush()
        return True

    if c == "SPHERE":
        if nargs == 0:
            return True, "SYN SPHERE <aircraft per layer>"
        reset()
        numac = int(float(args[0]))
        dist = 0.5
        # Three layers converging towards the same volume: middle level,
        # upper descending, lower climbing (reference synthetic.py:110-164).
        for layer, (dalt, vs_sign) in enumerate(
                [(0.0, 0), (3000.0 * aero.ft, -1), (-3000.0 * aero.ft, 1)]):
            ang = 2 * np.pi / numac * (np.arange(numac) + 0.5 * layer)
            ids = [f"SPH{layer}_{i}" for i in range(numac)]
            traf.create(numac, "B744",
                        np.full(numac, 20000 * aero.ft + dalt),
                        np.full(numac, 150.0 * aero.kts), None,
                        dist * -np.cos(ang), dist * np.sin(ang),
                        np.degrees(ang) % 360.0, acid=None)
        traf.flush()
        return True

    if c == "MATRIX":
        if nargs == 0:
            return True, "SYN MATRIX <size>"
        reset()
        size = int(float(args[0]))
        hseplat = sim.cfg.asas.rpz / MPERDEG * 1.1
        vel = 200.0
        extradist = (vel * 1.1) * 5 * 60 / MPERDEG
        k = np.arange(size)
        off = (k - (size - 1.0) / 2) * hseplat
        edge = hseplat * (size - 1.0) / 2 + extradist
        alt = np.full(size, 20000 * aero.ft)
        spd = np.full(size, vel)   # m/s > 1 => CAS in m/s
        traf.create(size, "B744", alt, spd, None, np.full(size, edge), off,
                    np.full(size, 180.0))
        traf.create(size, "B744", alt, spd, None, np.full(size, -edge), off,
                    np.full(size, 0.0))
        traf.create(size, "B744", alt, spd, None, off, np.full(size, edge),
                    np.full(size, 270.0))
        traf.create(size, "B744", alt, spd, None, off, np.full(size, -edge),
                    np.full(size, 90.0))
        traf.flush()
        return True

    if c == "FLOOR":
        reset()
        hseplat = sim.cfg.asas.rpz / MPERDEG * 1.1
        traf.create(1, "B744", 23000 * aero.ft, 200.0, None, -1.0, 0.0, 90.0,
                    "OWNSHIP")
        traf.flush()
        idx = traf.id2idx("OWNSHIP")
        ac = traf.state.ac
        ac.selvs[idx] = -10.0
        ac.selalt[idx] = 17000 * aero.ft
        n = 20
        traf.create(n, "B744", np.full(n, 20000 * aero.ft),
                    np.full(n, 200.0 * aero.kts), None,
                    np.full(n, -1.0), (np.arange(n) - 10) * hseplat,
                    np.full(n, 90.0))
        traf.flush()
        return True

    if c == "TAKEOVER":
        if nargs == 0:
            return True, "SYN TAKEOVER <number of aircraft>"
        reset()
        numac = int(float(args[0]))
        v = np.arange(50, 50 * (numac + 1), 50).astype(float)
        degtofly = v * 5 * 60 / MPERDEG
        traf.create(numac, "B744", np.full(numac, 20000 * aero.ft), v, None,
                    np.zeros(numac), -degtofly, np.full(numac, 90.0))
        traf.flush()
        return True

    if c == "WALL":
        reset()
        dist = 0.6
        hseplat = sim.cfg.asas.rpz / MPERDEG * 1.1
        traf.create(1, "B744", 20000 * aero.ft, 200.0, None, 0.0, -dist, 90.0,
                    "OWNSHIP")
        n = 20
        traf.create(n, "B744", np.full(n, 20000 * aero.ft),
                    np.full(n, 200.0 * aero.kts), None,
                    (np.arange(n) - 10) * hseplat, np.full(n, dist),
                    np.full(n, 270.0))
        traf.flush()
        return True

    if c in ("ROW", "COLUMN"):
        if nargs < 2:
            return True, f"SYN {c} n angle [radiusnm alt_ft spd_kts type]"
        reset()
        n = int(float(args[0]))
        ang = float(args[1])
        startdist = float(args[2]) * aero.nm / MPERDEG if nargs > 2 else 0.5
        acalt = float(args[3]) * aero.ft if nargs > 3 else 20000 * aero.ft
        acspd = float(args[4]) * aero.kts if nargs > 4 else 200 * aero.kts
        actype = args[5] if nargs > 5 else "B744"
        hseplat = sim.cfg.asas.rpz / MPERDEG * 1.1
        aclat = startdist * np.cos(np.radians(ang))
        aclon = startdist * np.sin(np.radians(ang))
        if c == "ROW":
            latsep = abs(hseplat * np.cos(np.radians(90 - ang)))
            lonsep = abs(hseplat * np.sin(np.radians(90 - ang)))
            alternate = 1
            for i in range(n):
                aclat = aclat + i * latsep * alternate
                aclon_i = aclon - i * lonsep * alternate
                traf.create(1, actype, acalt, acspd, None, aclat, aclon_i,
                            (180 + ang) % 360, f"ANG{2 * i}")
                traf.create(1, actype, acalt, acspd, None, aclat, -aclon_i,
                            (180 - ang) % 360, f"ANG{2 * i + 1}")
                alternate = -alternate
        else:
            latsep = abs(hseplat * np.cos(np.radians(ang)))
            lonsep = abs(hseplat * np.sin(np.radians(ang)))
            for i in range(n):
                la = aclat + i * latsep
                lo = aclon + i * lonsep
                traf.create(1, actype, acalt, acspd, None, la, lo,
                            (180 + ang) % 360, f"ANG{2 * i}")
                traf.create(1, actype, acalt, acspd, None, la, -lo,
                            (180 - ang) % 360, f"ANG{2 * i + 1}")
        traf.flush()
        return True

    return False, f"SYN: unknown subcommand {subcmd}"
