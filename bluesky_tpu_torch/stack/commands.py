"""Built-in stack commands: the user/API surface of the simulator.

Port of ``bluesky_tpu/stack/commands.py``, which mirrors the reference
command dictionary (stack/stack.py:180-796) and synonym table
(stack.py:44-115).  Each entry is
``NAME: [usage, argtypes, function, helptext]``; functions return
True/False/None or (ok, echotext) exactly like the reference contract.

Traffic-state mutation happens through small per-slot writes into the
state's tensors, in place — these run at command cadence
(human/scenario rate), not step rate; bulk creation goes through the
batched ``Traffic.flush`` path instead.

On a networked worker (``simulation/simnode.SimNode``: the sim's
``node`` has an ``event_io`` socket) the serving-fabric commands send
their query or setting to the server as an event, and the worker echoes
the server's reply when it arrives: ADDNODES, METRICS DUMP, TRACE DUMP,
HEALTH, OPT's OPTRESULT, WORLDS, MITIGATE, SDC and HA.  On a detached
sim each answers locally with the JAX package's text.
"""
import numpy as np
import torch

from ..ops import aero
from ..core import wind as windmod
from . import synthetic
from ..utils import asnumpy
from .argparser import txt2alt, txt2spd


def register_all(stack):
    sim = stack.sim
    traf = sim.traf

    # ------------------------------------------------------------ helpers
    def st():
        return traf.state

    def setslot(field, idx, value):
        getattr(traf.state.ac, field)[idx] = value

    def acname(idx):
        return traf.ids[idx] or f"#{idx}"

    def server_node():
        """The sim's node when it is networked (it has an event socket
        to a server), else None."""
        node = getattr(sim, "node", None)
        if node is not None and getattr(node, "event_io", None) is not None:
            return node
        return None

    # ------------------------------------------------------- a/c commands
    def cre(acid, actype, pos, hdg=None, alt=None, spd=None):
        """CRE acid,type,latlon,hdg,alt,spd (traffic.py:192)."""
        lat, lon = pos
        ok, msg = traf.create(1, actype or "B744", alt, spd, None,
                              lat, lon, hdg, acid)
        if not ok:
            return False, msg
        traf.flush()
        return True

    def mcre(n, actype=None, alt=None, spd=None, dest=None):
        """MCRE n,[type,alt,spd,dest]: n random aircraft."""
        traf.area = sim.scr.getviewbounds()
        ok, msg = traf.create(n, actype or "B744", alt, spd, dest)
        traf.flush()
        return ok, msg

    def delete(idx):
        name = acname(idx)
        traf.delete(idx)
        return True, f"Deleted {name}"

    def delall():
        idxs = [i for i, v in enumerate(traf.ids) if v is not None]
        if idxs:
            traf.delete(idxs)
        return True

    def move(idx, pos, alt=None, hdg=None, spd=None, vspd=None):
        """MOVE acid,latlon,[alt,hdg,spd,vspd] (traffic.py:517)."""
        lat, lon = pos
        setslot("lat", idx, lat)
        setslot("lon", idx, lon)
        setslot("coslat", idx, float(np.cos(np.radians(lat))))
        if alt is not None:
            setslot("alt", idx, alt)
            setslot("selalt", idx, alt)
        if hdg is not None:
            setslot("hdg", idx, hdg)
            setslot("trk", idx, hdg)
        if spd is not None:
            setslot("selspd", idx, spd)
        if vspd is not None:
            setslot("selvs", idx, vspd)
        return True

    def selalt(idx, alt, vspd=None):
        """ALT acid,alt,[vspd] (autopilot.py:306-322)."""
        setslot("selalt", idx, alt)
        setslot("swvnav", idx, False)
        if vspd is not None:
            setslot("selvs", idx, vspd)
        else:
            delalt = alt - float(st().ac.alt[idx])
            cur = float(st().ac.selvs[idx])
            if cur * delalt < 0 and abs(cur) > 0.01:
                setslot("selvs", idx, 0.0)
        return True

    def selvspd(idx, vspd):
        """VS acid,vspd (autopilot.py:324-328)."""
        setslot("selvs", idx, vspd)
        setslot("swvnav", idx, False)
        return True

    def selhdg(idx, hdg):
        """HDG acid,hdg: heading select, LNAV off (autopilot.py:330-346)."""
        # Wind-corrected track happens continuously in the pilot module;
        # here we set the AP track like the reference's no-wind path.
        st().ap.trk[idx] = hdg
        setslot("swlnav", idx, False)
        return True

    def selspd(idx, spd):
        """SPD acid,spd(CASkt/Mach) (autopilot.py:348-358)."""
        setslot("selspd", idx, spd)
        setslot("swvnav", idx, False)
        return True

    def setvs_direct(idx, vspd):
        setslot("vs", idx, vspd)
        return True

    def pos(idx):
        """POS acid: info text (traffic.py poscommand)."""
        s = st()
        i = idx
        txt = (f"Info on {acname(i)} {traf.types[i]}\n"
               f"Pos: {float(s.ac.lat[i]):.4f}, {float(s.ac.lon[i]):.4f}\n"
               f"Hdg: {float(s.ac.hdg[i]):.0f}   Trk: {float(s.ac.trk[i]):.0f}\n"
               f"Alt: {float(s.ac.alt[i]) / aero.ft:.0f} ft\n"
               f"CAS: {float(s.ac.cas[i]) / aero.kts:.0f} kts   "
               f"TAS: {float(s.ac.tas[i]) / aero.kts:.0f} kts   "
               f"GS: {float(s.ac.gs[i]) / aero.kts:.0f} kts\n"
               f"VS: {float(s.ac.vs[i]) / aero.fpm:.0f} fpm")
        # POS also selects this aircraft's route for the ROUTEDATA
        # stream (reference traffic.py:587 poscommand -> scr.showroute)
        sim.scr.showroute(acname(i))
        return True, txt

    def defwpt(name, pos, wptype=None):
        """DEFWPT wpname,lat,lon[,type] (navdatabase.py defwpt)."""
        sim.navdb.defwpt(name, pos[0], pos[1], wptype or "DEF")
        # GUI mirror (reference navdatabase.py:136 -> scr.addnavwpt)
        sim.scr.addnavwpt(name.upper(), pos[0], pos[1])
        return True, f"Waypoint {name.upper()} defined at " \
                     f"{pos[0]:.4f}, {pos[1]:.4f}"

    def navdbinfo(txt):
        """WPTINFO name: resolve a named position via the navdb."""
        ndb = sim.navdb
        i = ndb.getaptidx(txt)
        if i >= 0:
            return True, (f"{txt.upper()}: airport {ndb.aptname[i]} at "
                          f"{ndb.aptlat[i]:.4f}, {ndb.aptlon[i]:.4f}, "
                          f"elev {ndb.aptelev[i]:.0f} m")
        i = ndb.getwpidx(txt)
        if i >= 0:
            return True, (f"{txt.upper()}: {ndb.wptype[i]} at "
                          f"{ndb.wplat[i]:.4f}, {ndb.wplon[i]:.4f}")
        return False, f"{txt}: not found in navdb"

    def dist(pos1, pos2):
        from ..core.route import _host_qdrdist_nm
        d = _host_qdrdist_nm(pos1[0], pos1[1], pos2[0], pos2[1])
        return True, f"Dist = {d:.3f} nm"

    def calc(*expr):
        try:
            allowed = {"__builtins__": {}, "abs": abs, "min": min, "max": max}
            value = eval(" ".join(str(e) for e in expr if e is not None),
                         allowed, {})
            return True, f"Ans = {value}"
        except Exception as e:
            return False, f"CALC error: {e}"

    # --------------------------------------------------------------- route
    def setlnav(idx, flag=None):
        """LNAV acid,[on/off] (autopilot.py:444-461)."""
        if flag is None:
            on = bool(st().ac.swlnav[idx])
            return True, f"{acname(idx)}: LNAV is {'ON' if on else 'OFF'}"
        if flag:
            r = sim.routes.route(idx)
            if r.nwp <= 0:
                return False, f"LNAV {acname(idx)}: no waypoints"
            if not bool(st().ac.swlnav[idx]):
                setslot("swlnav", idx, True)
                iact = sim.routes.findact(idx)
                if iact >= 0:
                    sim.routes.direct(idx, sim.routes.route(idx).name[iact])
        else:
            setslot("swlnav", idx, False)
        return True

    def setvnav(idx, flag=None):
        """VNAV acid,[on/off] (autopilot.py:463-485)."""
        if flag is None:
            on = bool(st().ac.swvnav[idx])
            return True, f"{acname(idx)}: VNAV is {'ON' if on else 'OFF'}"
        if flag:
            if not bool(st().ac.swlnav[idx]):
                return False, f"{acname(idx)}: VNAV ON requires LNAV ON"
            if sim.routes.route(idx).nwp <= 0:
                return False, f"VNAV {acname(idx)}: no waypoints"
            setslot("swvnav", idx, True)
            sim.routes.sync(idx, point_active=True)
        else:
            setslot("swvnav", idx, False)
        return True

    def addwpt(idx, pos, alt=None, spd=None, afterwp=None):
        """ADDWPT acid,(wpt/lat,lon),[alt,spd,afterwp] (route.py:472)."""
        from ..core.route import WPT_LATLON, WPT_RWY
        # FLYBY/FLYOVER are turn-mode KEYWORDS, not waypoints
        # (reference route.py:77-92; the wppos argtype preserves them)
        if _turnmode_kw(idx, pos):
            return True
        lat, lon = pos
        # navdb-resolved positions carry their name (NamedPos)
        name = getattr(pos, "name", None) \
            or f"WP{sim.routes.route(idx).nwp + 1:03d}"
        # APT/RWNN threshold waypoints are runway-typed (route.py:472
        # runway branch) so the landing chain can engage
        wtype = WPT_RWY if "/" in name else WPT_LATLON
        wpidx = sim.routes.addwpt(idx, name, lat, lon,
                                  alt if alt is not None else -999.0,
                                  spd if spd is not None else -999.0,
                                  wtype, None, afterwp)
        if wpidx < 0:
            return False, "ADDWPT: afterwp not found"
        # First waypoint: engage LNAV and aim at it (route.py addwpt behavior)
        r = sim.routes.route(idx)
        if r.nwp == 1 or not bool(st().ac.swlnav[idx]):
            sim.routes.direct(idx, r.name[r.iactwp if r.iactwp >= 0 else 0])
        return True

    def dest_orig(cmd, idx, pos=None):
        """DEST/ORIG acid,[apt[/rwy]/lat,lon] (autopilot.py:360-442)."""
        from ..core.route import WPT_DEST, WPT_ORIG, WPT_RWY
        r = sim.routes.route(idx)
        if pos is None:
            return True, f"{cmd} {acname(idx)}: (not set)"
        lat, lon = pos
        wtype = WPT_DEST if cmd == "DEST" else WPT_ORIG
        name = getattr(pos, "name", None) or cmd
        if cmd == "DEST" and "/" in name:
            # Runway destination (autopilot.py setdestorig runway branch):
            # the final waypoint is the displaced threshold, typed RWY so
            # the landing chain (sim._check_runway_landings) engages.
            wtype = WPT_RWY
        sim.routes.addwpt(idx, name if wtype == WPT_RWY else cmd,
                          lat, lon, 0.0,
                          float(st().ac.cas[idx]), wtype,
                          as_dest=(cmd == "DEST"))
        if cmd == "DEST":
            r = sim.routes.route(idx)
            if r.nwp == 1 or (r.nwp == 2 and r.wtype[0] == WPT_ORIG):
                setslot("swlnav", idx, True)
                setslot("swvnav", idx, True)
                # the new final waypoint may be named DEST or APT/RWNN
                sim.routes.direct(idx, r.name[-1])
        return True

    def delwpt(idx, name):
        ok = sim.routes.delwpt(idx, name)
        return (True,) if ok else (False, f"Waypoint {name} not found")

    def direct(idx, name):
        ok = sim.routes.direct(idx, name)
        return (True,) if ok else (False, f"Waypoint {name} not in route")

    def listrte(idx):
        r = sim.routes.route(idx)
        if r.nwp == 0:
            return True, f"{acname(idx)}: route is empty"
        lines = []
        for w in range(r.nwp):
            mark = "*" if w == r.iactwp else " "
            alttxt = f" FL{r.alt[w] / aero.ft / 100:.0f}" if r.alt[w] >= 0 else ""
            spdtxt = f" {r.spd[w] / aero.kts:.0f}kt" if r.spd[w] >= 0 else ""
            lines.append(f"{mark}{r.name[w]} ({r.lat[w]:.4f}, {r.lon[w]:.4f})"
                         f"{alttxt}{spdtxt}")
        return True, "\n".join(lines)

    # ---------------------------------------------------------------- ASAS
    def _setasas(**kw):
        sim.cfg = sim.cfg._replace(asas=sim.cfg.asas._replace(**kw))

    def asas_onoff(flag=None):
        if flag is None:
            return True, f"ASAS is {'ON' if sim.cfg.asas.swasas else 'OFF'}"
        _setasas(swasas=bool(flag))
        return True

    def reso(method=None):
        """RESO [method]: MVP/EBY/SWARM/SSD/OFF/ON (asas.py CRmethods
        registry, asas.py:41-55)."""
        if method is None:
            cfg = sim.cfg.asas
            return True, f"RESO {cfg.reso_method if cfg.reso_on else 'OFF'}"
        m = method.upper()
        if m == "ON":
            _setasas(reso_on=True)
            return True
        if m in ("MVP", "EBY", "SWARM", "SSD"):
            # Every resolver runs on every CD backend (reference
            # asas.py:41-55 keeps CD and CR orthogonal): MVP/EBY via
            # pair sums, SWARM via in-kernel neighbour sums, SSD from
            # the partner table (cr_ssd.resolve_from_partners).
            _setasas(reso_on=True, reso_method=m)
            return True
        if m in ("OFF", "NONE", "DONOTHING"):
            _setasas(reso_on=False)
            return True
        return False, (f"RESO method {method} not available "
                       "(have: MVP, EBY, SWARM, SSD, OFF)")

    def zoner(r=None):
        if r is None:
            return True, f"ZONER = {sim.cfg.asas.rpz / aero.nm:.2f} nm"
        _setasas(rpz=float(r) * aero.nm)
        return True

    def zonedh(h=None):
        if h is None:
            return True, f"ZONEDH = {sim.cfg.asas.hpz / aero.ft:.0f} ft"
        _setasas(hpz=float(h) * aero.ft)
        return True

    def rszoner(r=None):
        if r is None:
            return True, f"RSZONER = {sim.cfg.asas.rpz * sim.cfg.asas.resofach / aero.nm:.2f} nm"
        _setasas(resofach=float(r) * aero.nm / sim.cfg.asas.rpz)
        return True

    def rszonedh(h=None):
        if h is None:
            return True, "RSZONEDH"
        _setasas(resofacv=float(h) * aero.ft / sim.cfg.asas.hpz)
        return True

    def dtlook(t=None):
        if t is None:
            return True, f"DTLOOK = {sim.cfg.asas.dtlookahead:.0f} s"
        _setasas(dtlookahead=float(t))
        return True

    def dtnolook(t=None):
        if t is None:
            return True, f"DTNOLOOK = {sim.cfg.asas.dtasas:.2f} s"
        _setasas(dtasas=float(t))
        return True

    def rmethh(method=None):
        """RMETHH [SPD/HDG/BOTH/OFF]: horizontal resolution limiting."""
        if method is None:
            return True, "RMETHH"
        m = method.upper()
        if m in ("BOTH", "ON"):
            _setasas(swresohoriz=True, swresospd=True, swresohdg=True,
                     swresovert=False)
        elif m == "SPD":
            _setasas(swresohoriz=True, swresospd=True, swresohdg=False,
                     swresovert=False)
        elif m == "HDG":
            _setasas(swresohoriz=True, swresospd=False, swresohdg=True,
                     swresovert=False)
        elif m in ("OFF", "NONE"):
            _setasas(swresohoriz=False, swresospd=False, swresohdg=False)
        return True

    def rmethv(method=None):
        if method is None:
            return True, "RMETHV"
        m = method.upper()
        _setasas(swresovert=m in ("V/S", "VS", "ON", "BOTH"),
                 swresohoriz=False if m in ("V/S", "VS", "ON", "BOTH")
                 else sim.cfg.asas.swresohoriz)
        return True

    def noreso(acids=None):
        """NORESO acid,...: toggle no-avoidance list (asas.py:360-376)."""
        s = st()
        if acids is None:
            s.asas.noreso.fill_(False)
            return True
        idx = traf.id2idx(acids)
        if idx < 0:
            return False, f"{acids} not found"
        s.asas.noreso[idx] = not bool(s.asas.noreso[idx])
        return True

    def resooff(acids=None):
        s = st()
        if acids is None:
            s.asas.resooff.fill_(False)
            return True
        idx = traf.id2idx(acids)
        if idx < 0:
            return False, f"{acids} not found"
        s.asas.resooff[idx] = not bool(s.asas.resooff[idx])
        return True

    def vlimits(flag=None, spd=None):
        if flag is None:
            return True, (f"ASAS limits [{sim.cfg.asas.vmin / aero.kts:.0f};"
                          f"{sim.cfg.asas.vmax / aero.kts:.0f}] kts")
        if flag.upper() == "MAX":
            _setasas(vmax=spd * aero.nm / 3600.0 if spd else sim.cfg.asas.vmax)
        else:
            _setasas(vmin=spd * aero.nm / 3600.0 if spd else sim.cfg.asas.vmin)
        return True

    def confinfo():
        s = st()
        nconf = int(s.asas.nconf_cur)
        nlos = int(s.asas.nlos_cur)
        return True, f"Current conflicts: {nconf} (LoS: {nlos})"

    # ----------------------------------------------------- sim-control cmds
    def op():
        sim.op()
        return True

    def hold():
        sim.pause()
        return True

    def ff(t=None):
        sim.fastforward(t)
        return True

    def setdt(dt=None):
        if dt is None:
            return True, f"DT = {sim.cfg.simdt}"
        sim.setdt(dt)
        return True

    def setdtmult(m=None):
        if m is None:
            return True, f"DTMULT = {sim.dtmult}"
        sim.setdtmult(m)
        return True

    def reset():
        sim.reset()
        return True

    def quitsim():
        sim.stop()
        return True

    def echo(*txt):
        return True, " ".join(str(t) for t in txt if t is not None)

    def seed(value):
        traf._rng = np.random.default_rng(int(value))
        # the integer seed of the port's noise: the JAX key
        # PRNGKey(value) = [value >> 32, value & 0xFFFFFFFF] read as one
        # 64-bit word (core/state.py)
        traf.state = st().replace(rng=int(value) % 2 ** 64)
        return True

    def noise(flag=None):
        if flag is None:
            on = sim.cfg.noise.turb_active
            return True, f"Noise is {'ON' if on else 'OFF'}"
        sim.cfg = sim.cfg._replace(noise=sim.cfg.noise._replace(
            turb_active=bool(flag), adsb_transnoise=bool(flag),
            adsb_truncated=bool(flag)))
        return True

    def wind(pos, *args):
        """WIND lat,lon,dir,spd[,alt,dir,spd...] (windsim.py:8-53).

        Without altitude triples: a constant-profile point.  With them: an
        altitude-dependent profile point.
        """
        lat, lon = pos
        vals = [a for a in args if a is not None]
        try:
            if len(vals) == 2:
                newwind = windmod.add_point(st().wind, lat, lon,
                                            float(vals[0]), float(vals[1]) * aero.kts)
            elif len(vals) >= 3 and len(vals) % 3 == 0:
                alts, dirs, spds = [], [], []
                for k in range(0, len(vals), 3):
                    alts.append(float(vals[k]))
                    dirs.append(float(vals[k + 1]))
                    spds.append(float(vals[k + 2]) * aero.kts)
                newwind = windmod.add_point(st().wind, lat, lon, dirs, spds,
                                            windalt=alts)
            else:
                return False, "WIND: expected dir,spd or alt,dir,spd triples"
        except ValueError as e:
            return False, f"WIND: {e}"
        traf.state = st().replace(wind=newwind)
        sim.cfg = sim.cfg._replace(use_wind=True)
        return True

    def creconfs(acid, actype, targetidx, dpsi, cpa, tlosh, dh=None,
                 tlosv=None, spd=None):
        traf.creconfs(acid, actype, targetidx, dpsi, cpa, tlosh, dh, tlosv,
                      spd, pzr_nm=sim.cfg.asas.rpz / aero.nm,
                      pzh_ft=sim.cfg.asas.hpz / aero.ft)
        return True

    def benchmark(fname=None, t=None):
        return sim.benchmark(fname or "IC", t or 60.0)

    def scen(name):
        return stack.scen(name)

    def pcall(fname, *pargs):
        args = [str(a) for a in pargs if a is not None]
        rel = bool(args and args[0].upper() == "REL")
        if rel:
            args = args[1:]
        return stack.openfile(fname, args, mergeWithExisting=True,
                              t_offset=sim.simt if rel else 0.0)

    def schedule(t, *cmdwords):
        return stack.sched_cmd(
            t, " ".join(str(c) for c in cmdwords if c is not None),
            relative=False)

    def delay(dt, *cmdwords):
        return stack.sched_cmd(
            dt, " ".join(str(c) for c in cmdwords if c is not None),
            relative=True)

    def ic(fname=None):
        return stack.ic(fname or "")

    def saveic(fname=None):
        return stack.saveic(fname)

    def bank(idx, angle=None):
        if angle is None:
            return True, f"BANK {acname(idx)}: {np.degrees(float(st().ac.bank[idx])):.0f} deg"
        setslot("bank", idx, float(np.radians(angle)))
        setslot("aphi", idx, float(np.radians(angle)))
        return True

    def syn(subcmd=None, *args):
        return synthetic.process(sim, subcmd, [a for a in args if a is not None])

    # ----------------------------------- areas / conditionals / trails
    def _flat(*vals):
        """Flatten (lat, lon) tuples + scalars into the reference's flat
        coordinate list, dropping empty optionals."""
        out = []
        for v in vals:
            if v is None:
                continue
            if isinstance(v, tuple):
                out.extend(v)
            else:
                out.append(v)
        return out

    def boxcmd(name, p0, p1, top=None, bottom=None):
        """BOX name,lat,lon,lat,lon,[top,bottom] (stack.py:266-269)."""
        return sim.areas.defineArea(
            name, "BOX", _flat(p0, p1),
            top if top is not None else 1e9,
            bottom if bottom is not None else -1e9)

    def circlecmd(name, p, radius, top=None, bottom=None):
        """CIRCLE name,lat,lon,radius[nm],[top,bottom] (stack.py:290-293)."""
        return sim.areas.defineArea(
            name, "CIRCLE", _flat(p, radius),
            top if top is not None else 1e9,
            bottom if bottom is not None else -1e9)

    def polycmd(name, *pts):
        """POLY name,lat,lon,lat,lon,... (stack.py:577-580)."""
        coords = _flat(*pts)
        if len(coords) < 6:
            return False, "POLY needs at least 3 points"
        return sim.areas.defineArea(name, "POLY", coords)

    def polyaltcmd(name, top, bottom, *pts):
        """POLYALT name,top,bottom,lat,lon,... (stack.py:583-586)."""
        coords = _flat(*pts)
        if len(coords) < 6:
            return False, "POLYALT needs at least 3 points"
        return sim.areas.defineArea(name, "POLY", coords, top, bottom)

    def linecmd(name, *pts):
        """LINE/POLYLINE name,lat,lon,lat,lon[,...] (stack.py:469-472,
        589-592 — POLYLINE is a LINE shape with more points)."""
        coords = _flat(*pts)
        if len(coords) < 4:
            return False, "LINE needs at least 2 points"
        return sim.areas.defineArea(name, "LINE", coords)

    def delcmd(name):
        """DEL acid/ALL/WIND/shape (stack.py:321-327)."""
        u = str(name).upper()
        if u == "ALL":
            return delall()
        if u == "WIND":
            traf.state = st().replace(wind=windmod.make_windstate(
                dtype=traf.dtype, device=traf.device))
            return True, "Wind field cleared"
        i = traf.id2idx(u)
        if isinstance(i, int) and i >= 0:
            return delete(i)
        for nm_ in (name, u):
            if sim.areas.hasArea(nm_):
                sim.areas.deleteArea(nm_)
                return True, f"Deleted area {nm_}"
        return False, f"{name}: no such aircraft or area"

    def atalt(idx, targalt, cmdtxt):
        sim.cond.ataltcmd(idx, targalt, cmdtxt)
        return True, f"ATALT armed for {acname(idx)}"

    def atspd(idx, targspd, cmdtxt):
        sim.cond.atspdcmd(idx, targspd, cmdtxt)
        return True, f"ATSPD armed for {acname(idx)}"

    def trailcmd(a0=None, a1=None):
        """TRAIL ON/OFF [dt] or TRAIL acid color (stack.py:734-739)."""
        tr = traf.trails
        if a0 is None:
            return tr.setTrails()
        u = str(a0).upper()
        if u in ("ON", "TRUE", "YES", "1"):
            return tr.setTrails(True, a1)
        if u in ("OFF", "FALSE", "NO", "0"):
            return tr.setTrails(False)
        if u == "CLEAR":
            return tr.setTrails("CLEAR")
        idx = traf.id2idx(u)
        if isinstance(idx, int) and idx >= 0:
            return tr.setTrails(idx, a1)
        return False, "Usage: TRAIL ON/OFF,[dt] or TRAIL acid,color"

    # -------------------------------------------- route editing (FMS)
    _TURNMODE = ("FLYBY", "FLY-BY", "FLYOVER", "FLY-OVER")

    def _turnmode_kw(idx, pos):
        """FLYBY/FLYOVER keyword via any route-editing command toggles
        the route turn mode (reference routes all ADDWPT forms through
        addwptStack, route.py:77-92).  Returns True when handled."""
        if getattr(pos, "name", "") in _TURNMODE:
            sim.routes.route(idx).swflyby = \
                getattr(pos, "name", "") in ("FLYBY", "FLY-BY")
            return True
        return False

    def _resolve_wpt(token, idx):
        """wpt token -> (name, lat, lon): the 'latlon' argtype always
        yields a tuple — plain for numeric pairs, NamedPos (carrying the
        waypoint name) for navdb-resolved positions."""
        lat, lon = token
        name = getattr(token, "name", None) \
            or f"WP{sim.routes.route(idx).nwp + 1:03d}"
        return name, lat, lon

    def after(idx, afterwp, sub, wpt, alt=None, spd=None):
        """acid AFTER afterwp ADDWPT wpt,[alt,spd] (route.py
        afteraddwptStack)."""
        if str(sub).upper() != "ADDWPT":
            return False, "Syntax: acid AFTER wpname ADDWPT wpname"
        from ..core.route import WPT_LATLON
        if _turnmode_kw(idx, wpt):
            return True
        name, lat, lon = _resolve_wpt(wpt, idx)
        wpidx = sim.routes.addwpt(idx, name, lat, lon,
                                  alt if alt is not None else -999.0,
                                  spd if spd is not None else -999.0,
                                  WPT_LATLON, None, afterwp)
        if wpidx < 0:
            return False, f"AFTER: {afterwp} not in route"
        return True

    def before(idx, beforewp, sub, wpt, alt=None, spd=None):
        """acid BEFORE beforewp ADDWPT wpt,[alt,spd] (route.py
        beforeaddwptStack)."""
        if str(sub).upper() != "ADDWPT":
            return False, "Syntax: acid BEFORE wpname ADDWPT wpname"
        if _turnmode_kw(idx, wpt):
            return True
        name, lat, lon = _resolve_wpt(wpt, idx)
        wpidx = sim.routes.addwpt_before(
            idx, beforewp, name, lat, lon,
            alt if alt is not None else -999.0,
            spd if spd is not None else -999.0)
        if wpidx < 0:
            return False, f"BEFORE: {beforewp} not in route"
        return True

    def atwpt(idx, wpname, what=None, value=None):
        """acid AT wpname [DEL] SPD/ALT [val] (route.py atwptStack)."""
        if what is not None and str(what).upper() == "ALT" \
                and value is not None:
            value = txt2alt(str(value))
        elif what is not None and str(what).upper() == "SPD" \
                and value is not None:
            value = txt2spd(str(value))
        return sim.routes.atwpt(idx, wpname, what, value)

    def delrte(idx):
        sim.routes.delrte(idx)
        setslot("swlnav", idx, False)
        setslot("swvnav", idx, False)
        return True

    def dumprte(idx):
        fname = sim.routes.dumproute(idx, acname(idx))
        return True, f"Route written to {fname}"

    # ---------------------------------------------------- info / misc
    def airway(wp):
        """AIRWAY wp/airway (traffic.py airwaycmd)."""
        navdb = sim.navdb
        awid = wp.upper()
        segs = navdb.listairway(awid)
        if segs:
            txt = f"Airway {awid}: " + " - ".join(
                " ".join(leg) for leg in segs)
            return True, txt
        conns = navdb.listconnections(awid)
        if conns:
            return True, f"Connections of {awid}: " + ", ".join(
                f"{aw}>{wpto}" for aw, wpto in conns)
        return False, f"{wp}: no airway or connections found"

    def listac():
        ids = [i for i in traf.ids if i is not None]
        return True, "Aircraft: " + (", ".join(ids) if ids else "(none)")

    def getwind(pos, alt=None):
        lat, lon = pos
        at = lambda v: torch.tensor([v], dtype=traf.dtype,
                                    device=traf.device)
        vn, ve = windmod.getdata(st().wind, at(lat), at(lon),
                                 at(alt or 0.0))
        vn, ve = float(vn[0]), float(ve[0])
        spd = float(np.hypot(vn, ve))
        direc = float(np.degrees(np.arctan2(ve, vn)) % 360.0)
        # wind FROM direction (meteo convention, windsim.py get)
        return True, (f"Wind at ({lat:.4f}, {lon:.4f}): "
                      f"{(direc + 180.0) % 360.0:03.0f} deg, "
                      f"{spd / aero.kts:.1f} kts")

    def engcmd(idx, engid=None):
        """ENG acid,[engine_id] (perfbase engchange contract)."""
        actype = traf.types[idx] or "NA"
        avail = traf.coeffdb.get(actype).get("engines_avail", {})
        if engid is None:
            names = ", ".join(avail) if avail else "(no data)"
            return True, f"{acname(idx)} ({actype}) engines: {names}"
        e = avail.get(engid.upper())
        if e is None:
            return False, f"{engid}: not an engine of {actype}"
        from ..models.perf_coeffs import _ff_quadratic
        ffa, ffb, ffc = _ff_quadratic(e["ff_idl"], e["ff_app"],
                                      e["ff_co"], e["ff_to"])
        perf = st().perf
        perf.engthrust[idx] = e["thr"]
        perf.engbpr[idx] = e["bpr"]
        perf.ff_a[idx] = ffa
        perf.ff_b[idx] = ffb
        perf.ff_c[idx] = ffc
        return True, f"{acname(idx)}: engine set to {engid.upper()}"

    def nom(idx):
        """NOM acid: reset to nominal performance accel (traffic.nom)."""
        setslot("ax", idx, aero.kts)
        return True

    def cdcmd(path=None):
        """CD [path]: change the scenario folder (stack.py setscenpath)."""
        if path is None:
            return True, f"Scenario path: {stack.scenario_path}"
        import os as _os
        if not _os.path.isdir(path):
            return False, f"{path}: not a directory"
        stack.scenario_path = path
        return True

    def cdmethod(method=None):
        """CDMETHOD [method] (asas.SetCDmethod); detection backends map
        to SimConfig.cd_backend."""
        if method is None:
            return True, f"CDMETHOD {sim.cfg.cd_backend.upper()}"
        m = method.upper()
        table = {"STATEBASED": "dense", "DENSE": "dense",
                 "TILED": "tiled", "PALLAS": "pallas", "SPARSE": "sparse"}
        if m not in table:
            return False, (f"CDMETHOD {method} not available "
                           "(have: STATEBASED/DENSE, TILED, PALLAS, "
                           "SPARSE)")
        if table[m] != sim.cfg.cd_backend:
            # sort_perm semantics differ per backend (Morton permutation
            # vs stripe destinations); the identity layout is valid for
            # both, and Simulation.update force-refreshes on backend
            # change.  The partner tables are cleared too: caller-space
            # ids (partners) and sorted-space ids (partners_s) are not
            # interchangeable, and a later refresh would remap stale
            # sorted-space rows onto the wrong aircraft.  Hysteresis
            # re-establishes within one CD interval.
            asas = sim.traf.state.asas
            asas.sort_perm.copy_(torch.arange(
                asas.sort_perm.shape[0], dtype=torch.int32,
                device=asas.sort_perm.device))
            asas.partners.fill_(-1)
            asas.partners_s.fill_(-1)
        sim.cfg = sim.cfg._replace(cd_backend=table[m])
        return True

    def asasv(minmax=None, spd=None):
        """ASASV MAX/MIN SPD (asas.SetVLimits; TAS in kts)."""
        if minmax is None:
            c = sim.cfg.asas
            return True, (f"ASAS speed limits: {c.vmin / aero.kts:.0f}"
                          f"-{c.vmax / aero.kts:.0f} kts")
        mm = minmax.upper()
        if spd is None or mm not in ("MIN", "MAX"):
            return False, "Usage: ASASV MAX/MIN spd (kts)"
        if mm == "MIN":
            _setasas(vmin=float(spd) * aero.kts)
        else:
            _setasas(vmax=float(spd) * aero.kts)
        return True

    def priorules(flag=None, priocode=None):
        """PRIORULES [ON/OFF PRIOCODE] (asas.SetPrio + MVP.py:235-300)."""
        if flag is None:
            c = sim.cfg.asas
            return True, (f"PRIORULES {'ON' if c.swprio else 'OFF'} "
                          f"{c.priocode}")
        if sim.cfg.cd_backend != "dense" and flag:
            return False, ("PRIORULES needs the dense CD backend "
                           "(per-pair priority masks)")
        kw = dict(swprio=bool(flag))
        if priocode is not None:
            pc = priocode.upper()
            # FF*/LAY* feed the MVP priority masks (MVP.py:235-300);
            # RS1-RS9 select the SSD ruleset (SSD.py:429-558)
            if pc not in ("FF1", "FF2", "FF3", "LAY1", "LAY2",
                          "RS1", "RS2", "RS3", "RS4", "RS5", "RS6",
                          "RS7", "RS8", "RS9"):
                return False, (f"Priority code {priocode} not understood;"
                               " use FF1/FF2/FF3/LAY1/LAY2 (MVP) or "
                               "RS1..RS9 (SSD)")
            kw["priocode"] = pc
        _setasas(**kw)
        return True

    def rfach(factor=None):
        if factor is None:
            return True, f"RFACH {sim.cfg.asas.resofach}"
        _setasas(resofach=float(factor))
        return True

    def rfacv(factor=None):
        if factor is None:
            return True, f"RFACV {sim.cfg.asas.resofacv}"
        _setasas(resofacv=float(factor))
        return True

    # ------------------------------------------------- time / sim ctrl
    def timecmd(arg=None):
        return sim.setutc(arg) if arg is not None else (
            True, f"Simulation time: {sim.utc.isoformat(' ')}")

    def datecmd(*args):
        args = [a for a in args if a is not None]
        if not args:
            return True, f"Date: {sim.utc.date().isoformat()}"
        return sim.setutc(*args)

    def fixdt(flag, tend=None):
        return sim.setFixdt(flag, tend)

    # ------------------------------------------------- display state
    def pan(arg, lon=None):
        """PAN lat lon / acid / waypoint / LEFT/RIGHT/UP/DOWN
        (scr.pan; raw tokens, resolved here like the reference's
        pandir/latlon union)."""
        a = str(arg).upper()
        if lon is not None:
            try:
                return sim.scr.pan(float(a), float(lon))
            except ValueError:
                pass
        step = 0.5
        moves = {"LEFT": (0.0, -step), "RIGHT": (0.0, step),
                 "UP": (step, 0.0), "ABOVE": (step, 0.0),
                 "DOWN": (-step, 0.0)}
        if a in moves:
            dlat, dlon = moves[a]
            return sim.scr.pan(sim.scr.ctrlat + dlat,
                               sim.scr.ctrlon + dlon)
        i = traf.id2idx(a)
        if isinstance(i, int) and i >= 0:
            return sim.scr.pan(float(st().ac.lat[i]),
                               float(st().ac.lon[i]))
        pos = sim.navdb.txt2pos(a, sim.scr.ctrlat, sim.scr.ctrlon)
        if pos is not None:
            return sim.scr.pan(pos[0], pos[1])
        return False, f"PAN: {arg} not found"

    def zoom(factor):
        f = str(factor).upper()
        if f == "IN":
            return sim.scr.zoom(1.4142135623730951)
        if f == "OUT":
            return sim.scr.zoom(0.7071067811865475)
        try:
            return sim.scr.zoom(float(factor), True)
        except (TypeError, ValueError):
            return False, "Usage: ZOOM IN/OUT or factor"

    def swrad(sw, dt=None):
        return sim.scr.feature(sw, dt)

    def filteralt(flag, bottom=None, top=None):
        return sim.scr.filteralt(flag, bottom, top)

    def insedit(txt=""):
        return sim.scr.cmdline(txt)

    def nd(acid_txt=None):
        return sim.scr.shownd(acid_txt)

    def symbol():
        return sim.scr.symbol()

    def tmx():
        return True, "TMX command not (yet?) implemented."

    def screenshot(fname=None):
        """SCREENSHOT [fname]: SVG radar render of the current state
        (ui/radar.py — the headless RadarWidget)."""
        import os as _os
        from .. import settings as _settings
        from ..ui import radar
        if fname is None:
            _os.makedirs(_settings.log_path, exist_ok=True)
            fname = _os.path.join(_settings.log_path,
                                  f"radar_{sim.simt:08.1f}.svg")
        radar.render_sim(sim, fname)
        return True, f"Radar snapshot written to {fname}"

    def metricscmd(flag=None, dt=None):
        """Bare/OFF/1/2 keep the reference sector-metrics behavior;
        METRICS DUMP reads the sim's telemetry registry, plus
        (networked) the server's broker and fleet registries, which
        arrive as a METRICS event."""
        if flag is not None and str(flag).upper() == "DUMP":
            node = server_node()
            if node is not None:
                node.send_event(b"METRICS", None)  # -> server registries
                return True, ("sim registry:\n" + sim.obs.text()
                              + "\n(server+fleet registries requested "
                                "— echoed when the reply arrives)")
            return True, "sim registry:\n" + sim.obs.text()
        return sim.metrics.toggle(flag, dt)

    def tracecmd(sub=None, opt=None):
        """TRACE [ON [DEVICE]/OFF/DUMP]: the flight recorder
        (obs/trace.py) — bounded span ring dumped as Chrome/Perfetto
        trace-event JSON; merge dumps and tabulate them per chunk with
        scripts/torch_trace_report.py.  TRACE ON DEVICE also times the
        device spans on the card and reads the interval's counters."""
        rec = sim.recorder
        if sub is None:
            return True, (f"TRACE {'ON' if rec.enabled else 'OFF'}"
                          f"{' DEVICE' if rec.timing else ''} "
                          f"({len(rec)}/{rec.maxlen} events buffered)")
        s = str(sub).upper()
        if s in ("ON", "1", "TRUE"):
            if opt is not None and str(opt).upper() == "DEVICE":
                dev = sim.traf.state.device
                if dev.type != "cuda":
                    return False, ("TRACE ON DEVICE: device timing is "
                                   f"unavailable on {dev.type}")
                rec.enable(device=True)
                return True, "Flight recorder ON, device spans timed"
            if opt is not None:
                return False, "TRACE [ON [DEVICE]/OFF/DUMP]"
            rec.enable()
            return True, "Flight recorder ON"
        if s in ("OFF", "0", "FALSE"):
            rec.disable()
            return True, (f"Flight recorder OFF "
                          f"({len(rec)} buffered events kept)")
        if s == "DUMP":
            path = rec.dump(reason="manual", proc="sim")
            node = server_node()
            if node is not None:
                node.send_event(b"TRACE", None)  # server dumps its ring
            if path is None:
                return True, "TRACE DUMP: ring is empty, nothing written"
            return True, f"Trace written to {path}"
        return False, "TRACE [ON/OFF/DUMP]"

    def chunksteps(arg=None, onoff=None):
        """CHUNKSTEPS [n | PIPELINE ON/OFF]: interactive device-chunk
        length + async-pipeline toggle, with HEALTH-style readback."""
        if arg is None:
            ps = sim.pipe_stats
            reasons = ", ".join(
                f"{k}:{v}" for k, v in sorted(
                    ps["sync_reasons"].items())) or "-"
            return True, (
                f"CHUNKSTEPS {sim.chunk_steps} "
                f"(={sim.chunk_steps * sim.simdt:.2f} s sim/chunk, "
                f"pipeline {'ON' if sim.pipeline_enabled else 'OFF'}; "
                f"chunks: {ps['pipelined_chunks']} pipelined, "
                f"{ps['sync_chunks']} sync, "
                f"{ps['deferred_trips']} deferred guard trips; "
                f"sync fallbacks: {reasons})")
        if str(arg).upper() == "PIPELINE":
            if onoff is None:
                return True, (f"CHUNKSTEPS PIPELINE is "
                              f"{'ON' if sim.pipeline_enabled else 'OFF'}")
            sw = str(onoff).upper()
            if sw not in ("ON", "OFF", "TRUE", "FALSE", "1", "0"):
                return False, "CHUNKSTEPS PIPELINE ON/OFF"
            sim.pipeline_enabled = sw in ("ON", "TRUE", "1")
            if not sim.pipeline_enabled:
                sim.drain_pipeline()
            return True, (f"Chunk pipeline "
                          f"{'ON' if sim.pipeline_enabled else 'OFF'}")
        try:
            n = int(float(arg))
        except (TypeError, ValueError):
            return False, "CHUNKSTEPS [n | PIPELINE ON/OFF]"
        if n < 1:
            return False, f"CHUNKSTEPS: need n >= 1, got {n}"
        sim.chunk_steps = n
        note = "" if n in sim.CHUNK_LADDER else \
            " (off-ladder: compiles one extra scan program)"
        return True, (f"Chunk set to {n} steps "
                      f"(={n * sim.simdt:.2f} s sim){note}")

    def addnodes(n):
        """ADDNODES n: a server spawns n more workers (``sim.addnodes``
        when the embedder provides one, else the ADDNODES event of a
        networked worker)."""
        fn = getattr(sim, "addnodes", None)
        if fn is not None:
            fn(int(n))
            return True
        node = server_node()
        if node is not None:
            node.send_event(b"ADDNODES", int(n))  # empty route -> server
            return True, f"ADDNODES {int(n)} requested from the server"
        # informative no-op, not a syntax error
        return True, "ADDNODES: no server attached (headless sim)"

    def batchcmd(fname):
        """BATCH scenario: the sim's ``batch`` (a networked worker
        uploads the scenario to its server, which farms the pieces out);
        a headless sim has none."""
        fn = getattr(sim, "batch", None)
        if fn is None:
            return True, "BATCH: no server attached (headless sim)"
        return fn(fname)

    def optcmd(tend=None, iters=None, lr=None, restarts=None):
        """OPT [tend,iters,lr,restarts]: gradient-based trajectory
        optimization of the current fleet (``diff/``): Adam descent on
        per-aircraft lateral-waypoint/time offsets with gradients from
        torch.autograd through the checkpointed smooth rollout, verified
        against the hard LoS metric; the sim then HOLDs.  Defaults from
        the settings.opt_* knobs.  On a networked worker the result
        (optimized offsets and objective trace) is reported upstream as
        an OPTRESULT event the server journals against the in-flight
        BATCH piece; the sim then HOLDs, completing the piece."""
        if traf.ntraf == 0:
            return False, "OPT: no traffic to optimize"
        try:
            res = sim.optimize_trajectories(tend, iters, lr, restarts)
        except (ValueError, RuntimeError) as e:
            return False, f"OPT: {e}"
        node = server_node()
        if node is not None:
            slots = np.flatnonzero(asnumpy(st().ac.active)).tolist()
            node.send_event(b"OPTRESULT", res.to_payload(traf.ids, slots))
        sim.pause()      # leave OP: a BATCH piece completes here
        ok = res.bad == -1
        return ok, (
            f"OPT: objective {res.objective[0]:.3f} -> "
            f"{res.objective[-1]:.3f} in {res.iters} iters "
            f"({res.restarts} restart(s), best {res.best_restart}); "
            f"hard LoS {res.hard_los_before} -> {res.hard_los_after}; "
            f"max |lateral| {float(np.abs(res.lateral_m).max()):.0f} m, "
            f"max |tshift| {float(np.abs(res.tshift_s).max()):.1f} s"
            + ("" if ok else f"; GUARD TRIP word {res.bad}"))

    def gradcmd(tend=None):
        """GRAD [tend]: one checked value and gradient of the
        soft-LoS+fuel objective at zero offsets: reports the objective,
        the gradient norm and the (backward-extended) guard word without
        descending."""
        if traf.ntraf == 0:
            return False, "GRAD: no traffic"
        from .. import settings as _settings
        from ..diff import optimize as diffopt
        sim.drain_pipeline()
        traf.flush()
        try:
            v, gnorm, bad = diffopt.grad_once(
                st(), sim.cfg.asas,
                tend=float(tend) if tend is not None
                else getattr(_settings, "opt_tend", 600.0),
                simdt=getattr(_settings, "opt_simdt", 1.0),
                chunk=getattr(_settings, "opt_chunk", 50))
        except (ValueError, RuntimeError) as e:
            return False, f"GRAD: {e}"
        return bad == -1, (
            f"GRAD: objective {v:.4f}, |grad| {gnorm:.4g}, guard "
            + ("clean" if bad == -1 else f"TRIPPED (word {bad})"))

    def worldscmd(arg=None, val=None):
        """WORLDS [ON/OFF | MAX n]: multi-world BATCH packing, pieces
        packed into world-batches stepped as one stacked dispatch
        (``simulation/worlds.py``).  Bare WORLDS reads the server's
        packing state and counters back (networked) or the local
        settings a server would inherit (detached); ON/OFF and MAX n set
        them, and send them to the server when networked."""
        from .. import settings as _settings
        node = server_node()
        if arg is None:
            if node is not None:
                node.send_event(b"WORLDS", None)  # empty route -> server
                return True, "WORLDS requested from the server"
            return True, (
                f"detached sim: WORLDS packing "
                f"{'ON' if getattr(_settings, 'world_pack', False) else 'OFF'}"
                f", max {getattr(_settings, 'world_batch_max', 8)} "
                "pieces/dispatch (settings.world_pack / "
                "settings.world_batch_max; a server inherits these)")
        a = str(arg).upper()
        if a in ("ON", "OFF", "TRUE", "FALSE", "1", "0"):
            on = a in ("ON", "TRUE", "1")
            _settings.world_pack = on
            if node is not None:
                node.send_event(b"WORLDS", {"pack": on})
                return True, f"WORLDS packing {'ON' if on else 'OFF'} sent"
            return True, f"WORLDS packing {'ON' if on else 'OFF'}"
        if a == "MAX":
            try:
                n = int(float(val))
            except (TypeError, ValueError):
                return False, "WORLDS MAX n: need an integer n >= 1"
            if n < 1:
                return False, f"WORLDS MAX: need n >= 1, got {n}"
            _settings.world_batch_max = n
            if node is not None:
                node.send_event(b"WORLDS", {"max": n})
                return True, f"WORLDS max {n} pieces/dispatch sent"
            return True, f"WORLDS max {n} pieces/dispatch"
        return False, "WORLDS [ON/OFF | MAX n]"

    def mitigatecmd(arg=None):
        """MITIGATE [ON/OFF/STATUS]: the server's self-healing policy
        engine.  Bare MITIGATE / MITIGATE STATUS reads the engine state
        back from the server (networked) or reports the local settings
        default a server would inherit (detached)."""
        from .. import settings as _settings
        node = server_node()
        a = str(arg).upper() if arg is not None else ""
        if a in ("", "STATUS"):
            if node is not None:
                node.send_event(b"MITIGATE", None)  # empty route -> server
                return True, "MITIGATE status requested from the server"
            return True, (
                f"detached sim: mitigation "
                f"{'ON' if getattr(_settings, 'mitigate_enabled', False) else 'OFF'}"
                " (settings.mitigate_enabled; a server inherits this)")
        if a in ("ON", "OFF", "TRUE", "FALSE", "1", "0"):
            on = a in ("ON", "TRUE", "1")
            _settings.mitigate_enabled = on
            if node is not None:
                node.send_event(b"MITIGATE", {"enabled": on})
                return True, f"MITIGATE {'ON' if on else 'OFF'} sent"
            return True, f"MITIGATE {'ON' if on else 'OFF'}"
        return False, "MITIGATE [ON/OFF/STATUS]"

    def sdccmd(arg=None, val=None):
        """SDC [ON/OFF/STATUS | AUDIT rate]: the server's
        silent-data-corruption defense (fingerprints of redundant
        executions compared on completion).  Bare SDC / SDC STATUS reads
        the defense state back from the server (networked) or reports
        the local settings a server would inherit (detached)."""
        from .. import settings as _settings
        node = server_node()
        a = str(arg).upper() if arg is not None else ""
        if a in ("", "STATUS"):
            if node is not None:
                node.send_event(b"SDC", None)  # empty route -> server
                return True, "SDC status requested from the server"
            return True, (
                f"detached sim: SDC "
                f"{'ON' if getattr(_settings, 'sdc_enabled', False) else 'OFF'}"
                f", audit rate "
                f"{getattr(_settings, 'sdc_audit_rate', 0.0):g} "
                "(settings.sdc_enabled / settings.sdc_audit_rate; a "
                "server inherits these)")
        if a in ("ON", "OFF", "TRUE", "FALSE", "1", "0"):
            on = a in ("ON", "TRUE", "1")
            _settings.sdc_enabled = on
            if node is not None:
                node.send_event(b"SDC", {"enabled": on})
                return True, f"SDC {'ON' if on else 'OFF'} sent"
            return True, f"SDC {'ON' if on else 'OFF'}"
        if a == "AUDIT":
            try:
                rate = max(0.0, float(val))
            except (TypeError, ValueError):
                return False, "SDC AUDIT rate: need a fraction 0..1"
            _settings.sdc_audit_rate = rate
            if node is not None:
                node.send_event(b"SDC", {"audit_rate": rate})
                return True, f"SDC audit rate {rate:g} sent"
            return True, f"SDC audit rate {rate:g}"
        return False, "SDC [ON/OFF/STATUS | AUDIT rate]"

    def hacmd(arg=None):
        """HA [STATUS]: broker high availability (a warm-standby server
        takes over when the leader's lease goes stale).  Bare HA / HA
        STATUS reads the lease state back from the server (networked) or
        reports the local settings a server would inherit (detached)."""
        from .. import settings as _settings
        node = server_node()
        a = str(arg).upper() if arg is not None else ""
        if a in ("", "STATUS"):
            if node is not None:
                node.send_event(b"HA", None)  # empty route -> server
                return True, "HA status requested from the server"
            return True, (
                f"detached sim: HA standby "
                f"{'ON' if getattr(_settings, 'ha_standby', False) else 'OFF'}"
                f", lease ttl "
                f"{getattr(_settings, 'ha_lease_ttl', 10.0):g} s "
                "(settings.ha_standby / settings.ha_lease_ttl; a "
                "server inherits these)")
        return False, "HA [STATUS]"

    def faultcmd(*args):
        """FAULT: the chaos-injection harness (fault/harness.py): poison
        the state with NaN/Inf or a bit flip, set the guard policy,
        degrade the event transport, stall/kill/straggle the worker, kill
        a device group of the mesh, truncate snapshots."""
        from ..fault import harness
        return harness.fault_command(sim, *args)

    def profile(sub=None, arg=None, arg2=None):
        """PROFILE START [dir] / STOP / KERNELS [nsteps] / DEEP / DEVICE
        [n] [dir] / TRACE ...: a torch.profiler trace, the per-kernel
        timing reports (utils/profiler.py), a device-trace window over
        the next n chunks (obs/devprof.py), and TRACE, the flight
        recorder command."""
        from ..utils import profiler
        s = (sub or "KERNELS").upper()
        if s == "START":
            try:
                logdir = profiler.start_trace(arg or "output/torch-trace")
            except RuntimeError as e:
                return False, f"PROFILE START: {e}"
            return True, f"torch.profiler trace capturing to {logdir}"
        if s == "STOP":
            try:
                path = profiler.stop_trace()
            except RuntimeError as e:
                return False, f"PROFILE STOP: {e}"
            return True, f"torch.profiler trace stopped, written to {path}"
        if s == "TRACE":
            return tracecmd(arg, arg2)
        if s == "DEVICE":
            if sim.devprof.window_active:
                return False, ("PROFILE DEVICE: a window is already "
                               "active")
            try:
                n = int(float(arg)) if arg else 1
            except (TypeError, ValueError):
                return False, "PROFILE DEVICE [n_chunks] [dir]"
            if n < 1:
                return False, f"PROFILE DEVICE: need n >= 1, got {n}"
            logdir = sim.devprof.request_window(n, arg2)
            node = server_node()
            if node is not None:
                # the server journals the window (an audit record)
                node.send_event(b"DEVPROF", {"dir": logdir, "chunks": n})
            return True, (f"PROFILE DEVICE: tracing the next {n} "
                          f"chunk(s) to {logdir}")
        if s == "KERNELS":
            if traf.ntraf == 0:
                return False, "PROFILE KERNELS: no traffic"
            nsteps = int(float(arg)) if arg else 50
            return True, profiler.report(sim, nsteps)
        if s == "DEEP":
            if traf.ntraf == 0:
                return False, "PROFILE DEEP: no traffic"
            return True, profiler.deep_report(sim)
        return False, ("PROFILE START [dir] / STOP / KERNELS [nsteps] "
                       "/ DEEP / DEVICE [n] [dir] / TRACE [ON/OFF/DUMP]")

    def healthcmd():
        """HEALTH: serving-fabric introspection.  On a networked worker
        the server is queried and its reply echoed when it arrives; a
        detached sim reports its local state."""
        node = server_node()
        if node is not None:
            node.send_event(b"HEALTH", None)   # empty route -> server
            return True, "HEALTH requested from the server"
        ps = sim.pipe_stats
        mh = sim.mesh_health()
        mesh_line = ""
        if mh["mode"] != "off" or mh["epoch"] > 0:
            mesh_line = (f"\nmesh: epoch {mh['epoch']}, "
                         f"{mh['devices']} device(s), mode {mh['mode']}"
                         + (f" {mh['tiles']}" if mh.get("tiles") else "")
                         + f", last refresh {mh['last_refresh_ms']:g} ms"
                         + (" [DEGRADED]" if mh["degraded"] else ""))
        sh = sim.scan_health()
        sim_line = ""
        if sh.get("scanstats"):
            if sh.get("steps"):
                ms = sh.get("min_sep_m")
                sim_line = (
                    f"\nsim: last chunk {sh['steps']} steps, conflicts "
                    f"peak {sh['conf_peak']}/mean {sh['conf_mean']:g}, "
                    f"LoS peak {sh['los_peak']}, min sep "
                    + (f"{ms:g} m" if ms is not None else "n/a")
                    + f", clamp-sat {sh['clamp_sat_ratio']:.1%}"
                    + f", occ peak {sh['occ_peak']}"
                    + (f" (imbalance {sh['occ_imbalance']:g}x)"
                       if sh.get("occ_imbalance", 1.0) != 1.0 else ""))
            else:
                sim_line = "\nsim: scanstats ON (no chunk drained yet)"
        return True, (f"detached sim: state {sim.state_flag}, simt "
                      f"{sim.simt_planned:.1f} s, {traf.ntraf} aircraft, "
                      f"{sim._step_count} steps done, chunks "
                      f"{ps['pipelined_chunks']} pipelined/"
                      f"{ps['sync_chunks']} sync"
                      + mesh_line + sim_line
                      + f"\ncompiles: {sim.devprof.compile_summary()}")

    def shardcmd(mode=None, ndev=None, halo=None):
        """SHARD [OFF | REPLICATE [n] | SPATIAL [n [halo]] | TILE RxC]:
        the shard mode on a mesh of the visible devices (the GPUs, or one
        CPU), with its readback when called bare."""
        from ..parallel import sharding as shd
        usage = ("SHARD [OFF | REPLICATE [n] | SPATIAL [n [halo]] | "
                 "TILE RxC]")
        if mode is None:
            if sim.shard_mode == "off":
                ndev = len(shd.default_devices(sim.traf.device))
                return True, (f"SHARD OFF ({ndev} "
                              f"device(s) visible; modes: REPLICATE, "
                              "SPATIAL, TILE [sparse backend])")
            nd = sim._shard_ndev()
            msg = (f"SHARD {sim.shard_mode.upper()}: {nd} devices, "
                   f"backend {sim.cfg.cd_backend}")
            st = sim.shard_stats
            if sim.shard_mode in ("spatial", "tiles") and st:
                cnt = st.get("counts")
                imb = (float(cnt.max()) / max(float(cnt.mean()), 1e-9)
                       if cnt is not None and cnt.size else 0.0)
            if sim.shard_mode == "spatial" and st:
                msg += (
                    f"; stripes {st['nb_local']} blocks/device "
                    f"(nb={st['nb']}, extra={st['extra_blocks']}), "
                    f"occupancy {st['occupancy']:.0%} of shard cap, "
                    f"last-refresh imbalance {imb:.2f}x, "
                    f"halo {st['halo_blocks']} blocks/side "
                    f"(need {st['halo_need']}) = "
                    f"{st['halo_rows']} exchanged rows/interval, "
                    f"gsmax {st['gsmax']:.0f} m/s")
            elif sim.shard_mode == "tiles" and st:
                tr, tc = st["tile_shape"]
                msg += (
                    f"; tiles {tr}x{tc} lat x lon "
                    f"({st['nb_local']} blocks/tile, nb={st['nb']}, "
                    f"extra={st['extra_blocks']}), "
                    f"occupancy {st['occupancy']:.0%} of shard cap, "
                    f"last-refresh imbalance {imb:.2f}x, "
                    f"halo budgets {tuple(st['budgets'])} blocks/offset "
                    f"(need {tuple(st['needs'])}) = "
                    f"{st['halo_rows']} exchanged rows/interval, "
                    f"gsmax {st['gsmax']:.0f} m/s")
            return True, msg
        m = str(mode).upper()
        if m in ("TILE", "TILES"):
            tiles, nd = None, 0
            if ndev is not None:
                ts = str(ndev).lower()
                try:
                    if "x" in ts:
                        r, c = ts.split("x", 1)
                        tiles = (int(r), int(c))
                        nd = tiles[0] * tiles[1]
                    else:
                        nd = int(float(ndev))
                except ValueError:
                    return False, usage
            try:
                sim.set_shard("tiles", nd, tiles=tiles)
            except (ValueError, RuntimeError) as e:
                return False, f"SHARD TILE: {e}"
            return shardcmd()
        if m not in ("OFF", "REPLICATE", "SPATIAL"):
            return False, usage
        try:
            nd = int(float(ndev)) if ndev is not None else 0
            hb = int(float(halo)) if halo is not None else 0
            sim.set_shard(m.lower(), nd, halo_blocks=hb)
        except (ValueError, RuntimeError) as e:
            return False, f"SHARD {m}: {e}"
        return shardcmd()

    def scanstatscmd(flag=None):
        """SCANSTATS [ON/OFF]: in-scan telemetry — per-step device-side
        stats (conflict/LoS histograms, resolver engagement, envelope
        clamp saturation, min separation, stripe occupancy) folded
        through the chunk scan and drained at every edge.  Bare call
        reads back state + the newest chunk summary."""
        if flag is None:
            sh = sim.scan_health()
            if not sh.get("scanstats"):
                return True, "SCANSTATS OFF"
            if not sh.get("steps"):
                return True, "SCANSTATS ON (no chunk drained yet)"
            ms = sh.get("min_sep_m")
            hr = sh.get("alt_headroom_min_m")
            return True, (
                f"SCANSTATS ON: last chunk {sh['steps']} steps, "
                f"conflicts peak {sh['conf_peak']}/mean "
                f"{sh['conf_mean']:g}, LoS peak {sh['los_peak']}, "
                f"engaged peak {sh['engaged_peak']}, min sep "
                + (f"{ms:g} m" if ms is not None else "n/a")
                + ", headroom "
                + (f"{hr:g} m" if hr is not None else "n/a")
                + f", clamp-sat {sh['clamp_sat_ratio']:.1%}, occ peak "
                  f"{sh['occ_peak']}")
        on = str(flag).upper() in ("ON", "TRUE", "1", "YES")
        changed = sim.set_scanstats(on)
        state = "ON" if on else "OFF"
        return True, (f"SCANSTATS {state}"
                      + ("" if changed else " (unchanged)")
                      + (": next dispatch compiles the stats-carrying "
                         "chunk program" if changed and on else ""))

    def sortrefreshcmd(flag=None):
        """SORTREFRESH [ON/OFF]: in-scan sort refresh — the stripe
        re-sort (+ spatial re-bucket) folded into the compiled chunk
        instead of a host call at chunk edges.  Sparse backend only
        (tiled/pallas stays host-called).  Bare call reads back mode +
        retired refresh counters."""
        if flag is None:
            rh = sim.refresh_health()
            if not rh["inscan"]:
                return True, "SORTREFRESH OFF (host refresh at chunk edges)"
            mode = "active" if rh["active"] else \
                "armed (inactive: needs sparse backend)"
            t = rh["last_refresh_simt"]
            return True, (
                f"SORTREFRESH ON ({mode}): {rh['inscan_refreshes']} "
                f"in-scan refreshes retired, last at simt "
                + (f"{t:.1f} s" if t >= 0 else "n/a")
                + f", guard trips {rh['guard_trips']}")
        on = str(flag).upper() in ("ON", "TRUE", "1", "YES")
        changed = sim.set_inscan_refresh(on)
        state = "ON" if on else "OFF"
        return True, (f"SORTREFRESH {state}"
                      + ("" if changed else " (unchanged)")
                      + (": next dispatch compiles the refresh-carrying "
                         "chunk program" if changed and on else ""))

    def snapshot(sub, fname=None):
        """SNAPSHOT SAVE/LOAD fname: the binary state checkpoint
        (``simulation/snapshot.py``, format v4)."""
        import os
        from ..simulation import snapshot as snap
        s = str(sub).upper()
        if fname is None:
            return False, "SNAPSHOT SAVE/LOAD filename"
        if not fname.lower().endswith(".snap"):
            fname += ".snap"
        if s == "SAVE":
            # disk-full / bad path degrades to a command error instead
            # of raising out of the stack, symmetric with LOAD; the
            # atomic writer guarantees any previous good file survives
            try:
                out = snap.save(sim, fname)
            except OSError as e:
                return False, f"SNAPSHOT SAVE {fname}: {e}"
            return True, f"Snapshot written to {out}"
        if s == "LOAD":
            if not os.path.isfile(fname):
                return False, f"{fname}: not found"
            return snap.load(sim, fname)
        return False, "SNAPSHOT SAVE/LOAD filename"

    def fingerprintcmd(flag=None):
        """FINGERPRINT [ON/OFF]: device-side SDC state fingerprint — a
        cheap int32 bit-pattern fold over the guarded state leaves,
        threaded through the chunk-scan carry (jit-static: OFF traces
        identical HLO, ON adds no host syncs or collectives) and
        chained per piece.  The completion word ships to the server
        for redundant-execution comparison (SDC defense).  Bare call
        reads back state + the running chain."""
        if flag is None:
            if not sim.cfg.fingerprint:
                return True, "FINGERPRINT OFF"
            fp = sim.fp_summary()
            if fp is None:
                return True, "FINGERPRINT ON (no chunk drained yet)"
            return True, (f"FINGERPRINT ON: chain {fp['fp']} over "
                          f"{fp['chunks']} chunk(s) / {fp['steps']} "
                          f"step(s)")
        on = str(flag).upper() in ("ON", "TRUE", "1", "YES")
        changed = sim.set_fingerprint(on)
        state = "ON" if on else "OFF"
        return True, (f"FINGERPRINT {state}"
                      + ("" if changed else " (unchanged)")
                      + (": next dispatch compiles the fingerprint-"
                         "carrying chunk program"
                         if changed and on else ""))

    def ssdcmd(*args):
        """SSD ALL/CONFLICTS/OFF or SSD acid0,acid1,...: select which
        aircraft draw their solution-space disc on the radar (reference
        stack.py:697-700 -> scr.feature('SSD', args) -> the
        radarwidget.py:290-302 SSD view).  A single named aircraft
        additionally gets a textual occupancy report, so the view also
        works headless."""
        if not args:
            return True, "SSD ALL/CONFLICTS/OFF or SSD acid0,acid1,..."
        words = [str(a).upper() for a in args]
        # validate callsigns before toggling (keywords pass through);
        # a callsign already holding a disc may always be toggled OFF,
        # even after the aircraft was deleted — otherwise only SSD OFF
        # could ever clear its stale disc.
        acids = [w for w in words
                 if w not in ("ALL", "CONFLICTS", "OFF")]
        selected = getattr(sim.scr, "ssd_ownship", set())
        for a in acids:
            i = traf.id2idx(a)
            if (not isinstance(i, int) or i < 0) and a not in selected:
                return False, f"{a}: aircraft not found"
        sim.scr.show_ssd(*words)
        if len(acids) == 1 and len(words) == 1:
            a = acids[0]
            if a not in getattr(sim.scr, "ssd_ownship", set()):
                # toggle DEselected the disc: no occupancy report (it
                # would imply the disc is still active)
                return True, f"{a}: SSD disc deselected"
            from ..plugins import host_arrays
            from ..ui import radar
            ac = st().ac
            c = sim.cfg.asas
            i = traf.id2idx(a)
            lat, lon, gse, gsn, act, inc = host_arrays(
                ac.lat, ac.lon, ac.gseast, ac.gsnorth, ac.active,
                st().asas.inconf)
            conf = radar.ssd_disc(i, lat, lon, gse, gsn, act, c.vmin,
                                  c.vmax, c.rpz_m, c.dtlookahead)
        else:
            return True, f"SSD: {' '.join(words)}"
        occ = 100.0 * float(np.mean(conf))
        inconf = bool(inc[i])
        return True, (f"{acname(i)}: SSD disc selected; "
                      f"{'IN CONFLICT' if inconf else 'clear'}; "
                      f"{occ:.0f}% of the velocity envelope blocked")

    def doccmd(cmd=None):
        """DOC [command]: extended help (scr.show_cmd_doc)."""
        return helpcmd(cmd)

    def makedoc():
        """MAKEDOC: write command reference markdown (stack.py makedoc)."""
        import os as _os
        from .. import settings as _settings
        _os.makedirs(_settings.log_path, exist_ok=True)
        fname = _os.path.join(_settings.log_path, "commands.md")
        with open(fname, "w") as f:
            f.write("# Stack command reference\n\n")
            for name in sorted(stack.cmddict):
                usage, _, _, helptxt = stack.cmddict[name]
                f.write(f"## {name}\n\n    {usage}\n\n{helptxt}\n\n")
        return True, f"Command reference written to {fname}"

    def helpcmd(cmd=None):
        if cmd is None:
            names = ", ".join(sorted(stack.cmddict.keys()))
            return True, f"Commands: {names}"
        c = stack.synonyms.get(cmd.upper(), cmd.upper())
        if c in stack.cmddict:
            e = stack.cmddict[c]
            return True, f"{e[0]}\n{e[3]}"
        return False, f"Unknown command {cmd}"

    # ----------------------------------------------------------- dictionary
    stack.append_commands({
        "ADDWPT": ["ADDWPT acid,(wpname/FLYBY/FLYOVER/lat,lon),"
                   "[alt,spd,afterwp]",
                   "acid,wppos,[alt,spd,wpinroute]", addwpt,
                   "Add a waypoint to the route of an aircraft"],
        "ALT": ["ALT acid,alt,[vspd]", "acid,alt,[vspd]", selalt,
                "Altitude select command"],
        "ASAS": ["ASAS [ON/OFF]", "[onoff]", asas_onoff,
                 "Airborne separation assurance on/off"],
        "BANK": ["BANK acid,[angle deg]", "acid,[float]", bank,
                 "Set bank angle limit"],
        "BENCHMARK": ["BENCHMARK [scenfile,time]", "[word,time]", benchmark,
                      "Load a scenario and time a fast-forward run"],
        "CALC": ["CALC expression", "[string,...]", calc,
                 "Evaluate a simple expression"],
        "CRE": ["CRE acid,type,latlon,hdg,alt,spd",
                "txt,txt,latlon,[hdg,alt,spd]", cre, "Create an aircraft"],
        "CRECONFS": ["CRECONFS acid,type,targetacid,dpsi,cpa,tlosh,[dH,tlosv,spd]",
                     "txt,txt,acid,float,float,time,[alt,time,spd]", creconfs,
                     "Create an aircraft in conflict with target"],
        "ATALT": ["acid ATALT alt cmd", "acid,alt,string", atalt,
                  "When a/c passes given altitude, execute a command"],
        "ATSPD": ["acid ATSPD spd cmd", "acid,spd,string", atspd,
                  "When a/c reaches given speed, execute a command"],
        "BOX": ["BOX name,lat,lon,lat,lon,[top,bottom]",
                "txt,latlon,latlon,[alt,alt]", boxcmd,
                "Define a box-shaped area"],
        "CIRCLE": ["CIRCLE name,lat,lon,radius,[top,bottom]",
                   "txt,latlon,float,[alt,alt]", circlecmd,
                   "Define a circle-shaped area"],
        "POLY": ["POLY name,lat,lon,lat,lon, ...", "txt,latlon,...",
                 polycmd, "Define a polygon-shaped area"],
        "POLYALT": ["POLYALT name,top,bottom,lat,lon, ...",
                    "txt,alt,alt,latlon,...", polyaltcmd,
                    "Define a polygon-shaped area in 3D"],
        "LINE": ["LINE name,lat,lon,lat,lon", "txt,latlon,latlon,...",
                 linecmd, "Draw a (poly)line between points"],
        "TRAIL": ["TRAIL ON/OFF,[dt] OR TRAIL acid color",
                  "[txt],[txt]", trailcmd, "Toggle aircraft trails on/off"],
        "DEL": ["DEL acid/ALL/WIND/shape", "txt", delcmd,
                "Delete an aircraft, wind field or area"],
        "DELALL": ["DELALL", "", delall, "Delete all aircraft"],
        "DELAY": ["DELAY dt,COMMAND+ARGS", "time,string,...", delay,
                  "Schedule a command in dt seconds"],
        "DEFWPT": ["DEFWPT wpname,lat,lon,[type]", "txt,latlon,[txt]",
                   defwpt, "Define a user waypoint"],
        "WPTINFO": ["WPTINFO wpname", "txt", navdbinfo,
                    "Look up a waypoint/airport in the navdb"],
        "DELWPT": ["DELWPT acid,wpname", "acid,wpinroute", delwpt,
                   "Delete a waypoint from the route"],
        "DEST": ["DEST acid,latlon", "acid,[latlon]",
                 lambda idx, pos=None: dest_orig("DEST", idx, pos),
                 "Set destination"],
        "DIRECT": ["DIRECT acid,wpname", "acid,wpinroute", direct,
                   "Go direct to a waypoint in the route"],
        "DIST": ["DIST lat1,lon1,lat2,lon2", "latlon,latlon", dist,
                 "Distance between positions"],
        "DT": ["DT [dt]", "[float]", setdt, "Set simulation timestep"],
        "DTLOOK": ["DTLOOK [time]", "[time]", dtlook,
                   "Conflict detection lookahead time"],
        "DTMULT": ["DTMULT [mult]", "[float]", setdtmult,
                   "Sim speed multiplier"],
        "DTNOLOOK": ["DTNOLOOK [time]", "[time]", dtnolook,
                     "Conflict detection interval"],
        "ECHO": ["ECHO txt", "[string,...]", echo, "Echo text"],
        "FF": ["FF [time]", "[time]", ff, "Fast-forward [for time]"],
        "HDG": ["HDG acid,hdg", "acid,hdg", selhdg, "Heading select command"],
        "HELP": ["HELP [cmd]", "[txt]", helpcmd, "Command help"],
        "HOLD": ["HOLD", "", hold, "Pause the simulation"],
        "IC": ["IC [scenfile]", "[word]", ic, "Load/reload a scenario"],
        "LISTRTE": ["LISTRTE acid", "acid", listrte, "Show route"],
        "LNAV": ["LNAV acid,[ON/OFF]", "acid,[onoff]", setlnav,
                 "Lateral navigation on/off"],
        "MCRE": ["MCRE n,[type,alt,spd,dest]", "int,[txt,alt,spd,txt]", mcre,
                 "Create n random aircraft"],
        "MOVE": ["MOVE acid,latlon,[alt,hdg,spd,vspd]",
                 "acid,latlon,[alt,hdg,spd,vspd]", move,
                 "Instantly move an aircraft"],
        "NOISE": ["NOISE [ON/OFF]", "[onoff]", noise,
                  "Turbulence/ADS-B noise on/off"],
        "NORESO": ["NORESO [acid]", "[txt]", noreso,
                   "Toggle no-avoidance for an aircraft"],
        "OP": ["OP", "", op, "Start/resume the simulation"],
        "OPT": ["OPT [tend,iters,lr,restarts]",
                "[float,int,float,int]", optcmd,
                "Gradient-based trajectory optimization: descend on "
                "per-aircraft waypoint/time offsets to zero LoS "
                "(bluesky_tpu_torch/diff/)"],
        "GRAD": ["GRAD [tend]", "[float]", gradcmd,
                 "One checked value and gradient of the soft-LoS+fuel "
                 "objective (reports objective, |grad|, guard word)"],
        "ORIG": ["ORIG acid,latlon", "acid,[latlon]",
                 lambda idx, pos=None: dest_orig("ORIG", idx, pos),
                 "Set origin"],
        "PCALL": ["PCALL scenfile,[REL,args]", "word,[string,...]", pcall,
                  "Merge a scenario file [with %0-%n substitution]"],
        "POS": ["POS acid", "acid", pos, "Aircraft info"],
        "QUIT": ["QUIT", "", quitsim, "Stop the simulation"],
        "RESET": ["RESET", "", reset, "Reset the simulation"],
        "RESO": ["RESO [method]", "[txt]", reso,
                 "Conflict resolution method (MVP/OFF)"],
        "RESOOFF": ["RESOOFF [acid]", "[txt]", resooff,
                    "Toggle resolution off for an aircraft"],
        "RMETHH": ["RMETHH [SPD/HDG/BOTH/OFF]", "[txt]", rmethh,
                   "Horizontal resolution method limiting"],
        "RMETHV": ["RMETHV [V/S / OFF]", "[txt]", rmethv,
                   "Vertical resolution method limiting"],
        "RSZONER": ["RSZONER [radius nm]", "[float]", rszoner,
                    "Resolution zone radius"],
        "RSZONEDH": ["RSZONEDH [height ft]", "[float]", rszonedh,
                     "Resolution zone half-height"],
        "SAVEIC": ["SAVEIC filename", "[word]", saveic,
                   "Record scenario from current state"],
        "SCEN": ["SCEN name", "word", scen, "Name the current scenario"],
        "SCHEDULE": ["SCHEDULE time,COMMAND+ARGS", "time,string,...", schedule,
                     "Schedule a command at a sim time"],
        "SEED": ["SEED value", "int", seed, "Set random seed"],
        "SPD": ["SPD acid,spd", "acid,spd", selspd, "Speed select command"],
        "SSD": ["SSD ALL/CONFLICTS/OFF or SSD acid0,acid1,...",
                "[txt,...]", ssdcmd,
                "Show solution space diagram"],
        "SYN": ["SYN subcmd,args", "[txt,string,...]", syn,
                "Synthetic conflict geometries (SUPER/WALL/MATRIX/...)"],
        "VNAV": ["VNAV acid,[ON/OFF]", "acid,[onoff]", setvnav,
                 "Vertical navigation on/off"],
        "VS": ["VS acid,vspd", "acid,vspd", selvspd,
               "Vertical speed select command"],
        "WIND": ["WIND lat,lon,dir,spd[,alt,dir,spd...]",
                 "latlon,float,float,[float,...]", wind,
                 "Define a wind vector/profile at a position"],
        "ZONEDH": ["ZONEDH [height ft]", "[float]", zonedh,
                   "Protected zone half-height"],
        "ZONER": ["ZONER [radius nm]", "[float]", zoner,
                  "Protected zone radius"],
        "CHUNKSTEPS": ["CHUNKSTEPS [n | PIPELINE ON/OFF]", "[txt,txt]",
                       chunksteps,
                       "Interactive device-chunk length / async-pipeline "
                       "toggle (readback without args)"],
        "CONFINFO": ["CONFINFO", "", confinfo, "Current conflict counts"],
        "AFTER": ["acid AFTER afterwp ADDWPT (wpname/lat,lon),[alt,spd]",
                  "acid,wpinroute,txt,wppos,[alt,spd]", after,
                  "After waypoint, add a waypoint to route of aircraft"],
        "AIRWAY": ["AIRWAY wp/airway", "txt", airway,
                   "Get info on airway or connections of a waypoint"],
        "ASASV": ["ASASV MAX/MIN SPD (TAS in kts)", "[txt,float]", asasv,
                  "Airborne Separation Assurance System Speed limits"],
        "AT": ["acid AT wpname [DEL] SPD/ALT [spd/alt]",
               "acid,wpinroute,[txt,txt]", atwpt,
               "Edit, delete or show spd/alt constraints at a waypoint"],
        "BEFORE": ["acid BEFORE beforewp ADDWPT (wpname/lat,lon),[alt,spd]",
                   "acid,wpinroute,txt,wppos,[alt,spd]", before,
                   "Before waypoint, add a waypoint to route of aircraft"],
        "CD": ["CD [path]", "[txt]", cdcmd,
               "Change to a different scenario folder"],
        "CDMETHOD": ["CDMETHOD [method]", "[txt]", cdmethod,
                     "Set conflict detection method"],
        "DATE": ["DATE [day,month,year,HH:MM:SS.hh]", "[int,int,int,txt]",
                 datecmd, "Set simulation date"],
        "DELRTE": ["DELRTE acid", "acid", delrte,
                   "Delete the complete route/dest/orig of an aircraft"],
        "DOC": ["DOC [command]", "[txt]", doccmd,
                "Show extended help for a command"],
        "DUMPRTE": ["DUMPRTE acid", "acid", dumprte,
                    "Write route to output/routelog.txt"],
        "ENG": ["ENG acid,[engine_id]", "acid,[txt]", engcmd,
                "Specify a different engine type"],
        "FILTERALT": ["FILTERALT ON/OFF,[bottom,top]", "onoff,[alt,alt]",
                      filteralt,
                      "Display aircraft only in an altitude range"],
        "FIXDT": ["FIXDT ON/OFF [tend]", "onoff,[time]", fixdt,
                  "Fix the time step"],
        "GETWIND": ["GETWIND lat,lon,[alt]", "latlon,[alt]", getwind,
                    "Get wind at a specified position"],
        "INSEDIT": ["INSEDIT txt", "string", insedit,
                    "Insert text on the edit line in command window"],
        "LISTAC": ["LISTAC", "", listac,
                   "List all aircraft identifiers in the simulation"],
        "MAKEDOC": ["MAKEDOC", "", makedoc,
                    "Write the stack command reference to output/"],
        "ND": ["ND acid", "[txt]", nd,
               "Show navigation display with CDTI"],
        "NOM": ["NOM acid", "acid", nom,
                "Set nominal acceleration for this aircraft"],
        "PAN": ["PAN latlon/acid/airport/waypoint/LEFT/RIGHT/UP/DOWN",
                "txt,[txt]", pan,
                "Pan screen (move view) to a position or aircraft"],
        "PRIORULES": ["PRIORULES [ON/OFF PRIOCODE]", "[onoff,txt]",
                      priorules,
                      "Define priority rules (right of way) for "
                      "conflict resolution"],
        "RFACH": ["RFACH [factor]", "[float]", rfach,
                  "Set resolution factor horizontal (margin)"],
        "RFACV": ["RFACV [factor]", "[float]", rfacv,
                  "Set resolution factor vertical (margin)"],
        "SWRAD": ["SWRAD GEO/GRID/APT/VOR/WPT/LABEL/TRAIL/POLY [value]",
                  "txt,[float]", swrad,
                  "Switch on/off elements of the radar view"],
        "SYMBOL": ["SYMBOL", "", symbol, "Toggle aircraft symbol"],
        "TIME": ["TIME RUN(default)/HH:MM:SS.hh/REAL/UTC", "[txt]",
                 timecmd, "Set simulated clock time"],
        "TMX": ["TMX", "", tmx, "Stub for not-implemented TMX commands"],
        "PLOT": ["PLOT [x],y,[dt],[color]", "[txt,txt,float,txt]",
                 sim.plotter.plot,
                 "Create a plot of variables x versus y"],
        "METRICS": ["METRICS OFF/1/2 [dt] | DUMP", "[txt,float]",
                    metricscmd,
                    "Sector metrics: 1=CoCa cell occupancy, "
                    "2=HB conflict-geometry complexity; DUMP reads "
                    "the telemetry registry (sim + server + fleet)"],
        "PROFILE": ["PROFILE START [dir]/STOP/KERNELS [nsteps]/DEEP/"
                    "DEVICE [n] [dir]/TRACE [ON/OFF/DUMP]",
                    "[txt,word,word]", profile,
                    "torch.profiler trace capture, per-kernel timings, "
                    "device-trace windows and the flight recorder"],
        "TRACE": ["TRACE [ON/OFF/DUMP]", "[txt,txt]", tracecmd,
                  "Flight recorder: bounded span ring dumped as "
                  "Perfetto trace JSON (readback bare)"],
        "ADDNODES": ["ADDNODES number", "int", addnodes,
                     "Add a simulation instance/node"],
        "BATCH": ["BATCH filename", "string", batchcmd,
                  "Start a scenario file as batch simulation"],
        "MITIGATE": ["MITIGATE [ON/OFF/STATUS]", "[txt]", mitigatecmd,
                     "Self-healing serving: signal->actuator policy "
                     "engine behind rate limits, backoff and a budget "
                     "(readback bare)"],
        "SDC": ["SDC [ON/OFF/STATUS | AUDIT rate]", "[txt,txt]", sdccmd,
                "Silent-data-corruption defense: redundant-execution "
                "fingerprint voting + worker quarantine "
                "(readback bare)"],
        "HA": ["HA [STATUS]", "[txt]", hacmd,
               "Broker high availability: warm-standby lease state, "
               "epoch, takeover/adoption counters (readback bare)"],
        "WORLDS": ["WORLDS [ON/OFF | MAX n]", "[txt,txt]", worldscmd,
                   "Multi-world BATCH packing: world-batch size + "
                   "per-bucket packing on/off (readback bare)"],
        "SCREENSHOT": ["SCREENSHOT [fname.svg]", "[word]", screenshot,
                       "Render the radar picture to an SVG file"],
        "FAULT": ["FAULT NAN/INF [acid] | BITFLIP [STATE|PAYLOAD] | "
                  "GUARD ../RING .. | DROP/DUP/"
                  "DELAY p | NETOFF | STALL s | STRAGGLE f/STALL/OFF | "
                  "KILL | KILLSERVER [s] | PREEMPT [s] | MESHKILL [g] "
                  "| PARTITION [OFF] "
                  "| LOADSPIKE n [rate] | SNAPTRUNC f | LIST",
                  "[word,...]", faultcmd,
                  "Fault-injection harness (chaos testing)"],
        "HEALTH": ["HEALTH", "", healthcmd,
                   "Serving-fabric health: queue depth, worker "
                   "progress, hedges, drops"],
        "SHARD": ["SHARD [OFF | REPLICATE [n] | SPATIAL [n [halo]] | "
                  "TILE RxC]",
                  "[txt,txt,txt]", shardcmd,
                  "Multi-chip mode: replicated columns, spatial "
                  "latitude stripes, or 2-D lat x lon tiles with "
                  "corner-halo exchange (readback bare)"],
        "SCANSTATS": ["SCANSTATS [ON/OFF]", "[txt]", scanstatscmd,
                      "In-scan telemetry: per-step device-side stats "
                      "folded through the chunk scan (readback bare)"],
        "SORTREFRESH": ["SORTREFRESH [ON/OFF]", "[txt]", sortrefreshcmd,
                        "In-scan sort refresh: stripe re-sort folded "
                        "into the compiled chunk (readback bare)"],
        "SNAPSHOT": ["SNAPSHOT SAVE/LOAD fname", "txt,[word]", snapshot,
                     "Save/restore a binary state snapshot"],
        "FINGERPRINT": ["FINGERPRINT [ON/OFF]", "[txt]", fingerprintcmd,
                        "Device-side SDC state fingerprint folded "
                        "through the compiled chunk scan "
                        "(readback bare)"],
        "ZOOM": ["ZOOM IN/OUT or factor", "txt", zoom,
                 "Zoom display in/out"],
        "PLUGINS": ["PLUGINS LIST or PLUGINS LOAD/REMOVE plugin",
                    "[txt,txt]",
                    lambda cmd=None, name=None: sim.plugins.manage(
                        cmd or "LIST", name or ""),
                    "List, load or remove plugins"],
    })

    # Synonyms (reference stack.py:44-115 subset)
    stack.append_synonyms({
        "CREATE": "CRE", "DELETE": "DEL", "DIRECTTO": "DIRECT",
        "DIRTO": "DIRECT", "DISP": "SWRAD", "END": "QUIT", "EXIT": "QUIT",
        "FWD": "FF", "PAUSE": "HOLD", "STOP": "QUIT", "RUN": "OP",
        "RESUME": "OP", "START": "OP", "TURN": "HDG", "?": "HELP",
        "CONTINUE": "OP", "SAVE": "SAVEIC", "CLOSE": "QUIT",
        "DELROUTE": "DELRTE", "LOAD": "IC", "OPEN": "IC",
        "TRAILS": "TRAIL", "POLYGON": "POLY", "POLYLINE": "LINE",
        "POLYLINES": "LINE", "LINES": "LINE", "PLUGIN": "PLUGINS",
        "PLUG-INS": "PLUGINS", "PLUG-IN": "PLUGINS",
        # Full reference synonym table (stack.py:44-115)
        "AWY": "POS", "AIRPORT": "POS", "AIRWAYS": "AIRWAY",
        "CALL": "PCALL", "CHDIR": "CD", "DEBUG": "CALC",
        "DELWP": "DELWPT", "HEADING": "HDG", "HMETH": "RMETHH",
        "HRESOM": "RMETHH", "HRESOMETH": "RMETHH", "PRINT": "ECHO",
        "Q": "QUIT", "RTF": "DTMULT", "RUNWAYS": "POS",
        "RESOFACH": "RFACH", "RESOFACV": "RFACV", "SPEED": "SPD",
        "VMETH": "RMETHV", "VRESOM": "RMETHV", "VRESOMETH": "RMETHV",
        # Unimplemented TMX commands route to the TMX stub
        "BGPASAS": "TMX", "DFFLEVEL": "TMX", "FFLEVEL": "TMX",
        "FILTCONF": "TMX", "FILTTRED": "TMX", "FILTTAMB": "TMX",
        "GRAB": "TMX", "HDGREF": "TMX", "MOVIE": "TMX",
        "NAVDB": "TMX", "PREDASAS": "TMX", "RENAME": "TMX",
        "RETYPE": "TMX", "SWNLRPASAS": "TMX", "TRAFRECDT": "TMX",
        "TRAFLOGDT": "TMX", "TREACT": "TMX", "WINDGRID": "TMX",
        "METRIC": "METRICS",
    })

