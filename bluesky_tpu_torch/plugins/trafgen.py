"""Traffic generator plugin: sources/drains spawning flows of aircraft.

Parity with the reference ``plugins/trafgen.py`` + ``trafgenclasses.py``
(the Airspace Design Contest generator, and the named driver of the
10k/50k/100k density-sweep benchmark config — BASELINE.md config #3):
a spawn circle with 12 ``SEGM<brg>`` edge segments, named Source and
Drain objects (airports / waypoints / segments), per-object flow rates in
aircraft/hour, runway takeoff queues with a minimum takeoff interval,
aircraft-type pools, altitude/speed start windows, and random
destination/origin selection per spawn.

TPU-first divergences:
* Spawns are *batched*: each update draws the number of spawns per
  source from the exact Poisson law for ``gain*flow*dt`` (the reference
  Bernoulli-per-0.1 s tick caps every source at 10 a/c s^-1 and distorts
  high flows; Poisson is the limit the reference approximates) and issues
  ONE ``traf.create`` call for the whole batch, landing on device as one
  write.  High-density sweeps spin up in sim-minutes instead of hours.
* Follow-up guidance (DEST/ORIG/LNAV) is issued through the same stack
  command strings the reference emits — the stack remains the universal
  API surface.
* All state hangs off the plugin instance (one per Simulation), not
  module globals.

Port of ``bluesky_tpu/plugins/trafgen.py``: host code, copied as it is;
the spawn circle's points come from the port's ``ops/geo.kwikpos`` in
float64 on the CPU, as the JAX package computes them under x64.
"""
import numpy as np

NM = 1852.0


def init_plugin(sim):
    gen = TrafGen(sim)
    config = {
        "plugin_name": "TRAFGEN",
        "plugin_type": "sim",
        "update_interval": 0.1,
        "update": gen.update,
        "reset": gen.reset,
    }
    stackfunctions = {
        "TRAFGEN": [
            "TRAFGEN [location],cmd,[arg,arg,...]",
            "string",
            gen.command,
            "Traffic-generator (contest) command",
        ],
    }
    return config, stackfunctions


class Flowpoint:
    """Shared geometry/config of a Source or Drain endpoint."""

    def __init__(self, gen, name):
        self.gen = gen
        self.name = name.upper()
        self.flow = 0.0                  # [a/c per hour]
        self.actypes = ["B744"]
        self.startaltmin = None          # [ft]
        self.startaltmax = None
        self.startspdmin = None          # [kts CAS]
        self.startspdmax = None
        self.seg = self.name.startswith("SEGM")
        if self.seg:
            brg = float(self.name[4:])
            self.lat, self.lon = gen.segpos(brg)
            self.hdg = (brg + 180.0) % 360.0   # inward
            self.incircle = False
        else:
            pos = gen.resolve(self.name)
            if pos is None:
                raise ValueError(f"{name}: position not found")
            self.lat, self.lon = pos
            self.hdg = None
            self.incircle = gen.incircle(self.lat, self.lon)
            if not self.incircle:
                # Project to the circle edge segment toward the point
                # (trafgenclasses.py:58-64)
                brg = _bearing(gen.ctrlat, gen.ctrlon, self.lat, self.lon)
                self.lat, self.lon = gen.segpos(brg)
                self.hdg = (brg + 180.0) % 360.0
                self.seg = True
        # Runway queues (sources only)
        self.runways = []                # [(name, lat, lon, hdg)]
        self.rwyline = []                # queued takeoffs
        self.rwytotime = []              # last takeoff time
        self.dtakeoff = 90.0

    def setflow(self, val):
        self.flow = float(val)
        return True

    def addactypes(self, types):
        self.actypes = [t.upper() for t in types] or self.actypes
        return True

    def setalt(self, args):
        vals = [float(a.lstrip("FL")) * (100.0 if a.startswith("FL") else 1.0)
                for a in args]
        self.startaltmin = vals[0]
        self.startaltmax = vals[-1]
        return True

    def setspd(self, args):
        vals = [float(a) for a in args]
        self.startspdmin = vals[0]
        self.startspdmax = vals[-1]
        return True

    def sethdg(self, args):
        self.hdg = float(args[0]) % 360.0
        return True

    def setrunways(self, names):
        self.runways = []
        self.rwyline = []
        self.rwytotime = []
        navdb = self.gen.sim.navdb
        thresholds = getattr(navdb, "rwythresholds", {})
        for rwy in names:
            r = rwy.upper().removeprefix("RWY").removeprefix("RW")
            thr = thresholds.get(self.name, {}).get(r)
            if thr is not None:
                rlat, rlon, rhdg = thr[0], thr[1], thr[2]
            else:
                rlat, rlon = self.lat, self.lon
                try:
                    rhdg = 10.0 * float("".join(
                        c for c in r if c.isdigit()))
                except ValueError:
                    rhdg = 0.0
            self.runways.append((rwy.upper(), rlat, rlon, rhdg))
            self.rwyline.append(0)
            self.rwytotime.append(-999.0)
        return True

    def start_alt_spd(self, rng, n):
        """Per-spawn altitude [ft] / speed [kts] draws
        (trafgenclasses.py:358-364 defaults)."""
        if self.startaltmin is not None:
            alt = rng.uniform(self.startaltmin, self.startaltmax, n)
        else:
            alt = rng.integers(200, 301, n) * 100.0
        if self.startspdmin is not None:
            spd = rng.uniform(self.startspdmin, self.startspdmax, n)
        else:
            spd = rng.integers(250, 351, n).astype(float)
        return alt, spd


class Source(Flowpoint):
    def __init__(self, gen, name):
        super().__init__(gen, name)
        self.dest = []                   # [(name_or_None, lat, lon)]

    def adddest(self, args):
        for d in args:
            d = d.upper()
            if d.startswith("SEGM"):
                lat, lon = self.gen.segpos(float(d[4:]))
                self.dest.append((d, lat, lon))
            else:
                pos = self.gen.resolve(d)
                if pos is None:
                    return False
                self.dest.append((d, pos[0], pos[1]))
        return True


class Drain(Flowpoint):
    def __init__(self, gen, name):
        super().__init__(gen, name)
        self.orig = []                   # [(name, lat, lon, incircle)]

    def addorig(self, args):
        for o in args:
            o = o.upper()
            if o.startswith("SEGM"):
                lat, lon = self.gen.segpos(float(o[4:]))
                self.orig.append((o, lat, lon, False))
            else:
                pos = self.gen.resolve(o)
                if pos is None:
                    return False
                self.orig.append((o, pos[0], pos[1],
                                  self.gen.incircle(pos[0], pos[1])))
        return True


class TrafGen:
    def __init__(self, sim):
        self.sim = sim
        self.rng = np.random.default_rng(12345)
        self.reset()

    def reset(self):
        self.ctrlat = 52.6
        self.ctrlon = 5.4
        self.radius = 230.0              # [nm]
        self.gain = 1.0
        self.sources = {}
        self.drains = {}
        self.last_t = float(self.sim.simt)
        self._fltnr = 100
        # Draw the spawn circle like the reference reset() does
        self.sim.stack.stack(
            f"CIRCLE SPAWN,{self.ctrlat},{self.ctrlon},{self.radius}")

    # ----------------------------------------------------------- geometry
    def segpos(self, brg):
        """Position on the spawn circle at bearing brg from the centre."""
        import torch
        from ..ops.geo import kwikpos
        f64 = lambda x: torch.tensor(float(x), dtype=torch.float64)
        lat, lon = kwikpos(f64(self.ctrlat), f64(self.ctrlon),
                           f64(brg % 360.0), f64(self.radius))  # [nm]
        return float(lat), float(lon)

    def incircle(self, lat, lon):
        from ..ops.geo import kwikdist_wrapped
        return float(kwikdist_wrapped(np.float64(self.ctrlat),
                                      np.float64(self.ctrlon),
                                      np.float64(lat),
                                      np.float64(lon))) <= self.radius

    def resolve(self, name):
        """Named position via the navdb (airport first)."""
        try:
            return self.sim.navdb.txt2pos(name, self.ctrlat, self.ctrlon)
        except Exception:
            return None

    # ------------------------------------------------------------ command
    def command(self, cmdline=""):
        """TRAFGEN subcommand dispatch (trafgen.py:107-246)."""
        words = [w for w in cmdline.replace(",", " ").split() if w]
        if not words:
            return True, ("TRAFGEN CIRCLE/GAIN/SRC/DRN ... | sources: "
                          + ", ".join(self.sources)
                          + " | drains: " + ", ".join(self.drains))
        cmd = words[0].upper()
        args = words[1:]
        try:
            if cmd in ("CIRCLE", "CIRC"):
                self.ctrlat, self.ctrlon = float(args[0]), float(args[1])
                self.radius = float(args[2])
                self.sim.stack.stack("DEL SPAWN")
                self.sim.stack.stack(
                    f"CIRCLE SPAWN,{self.ctrlat},{self.ctrlon},"
                    f"{self.radius}")
                return True
            if cmd in ("GAIN", "FACTOR"):
                self.gain = float(args[0])
                return True
            if cmd in ("SRC", "SOURCE"):
                return self._object_cmd(self.sources, Source, args)
            if cmd in ("DRN", "DRAIN"):
                return self._object_cmd(self.drains, Drain, args)
        except (IndexError, ValueError) as e:
            return False, f"TRAFGEN {cmd}: bad arguments ({e})"
        return False, f"TRAFGEN: unknown subcommand {cmd}"

    def _object_cmd(self, table, cls, args):
        name = args[0].upper()
        sub = args[1].upper() if len(args) > 1 else ""
        subargs = args[2:]
        if name not in table:
            try:
                table[name] = cls(self, name)
            except ValueError as e:
                return False, f"TRAFGEN ERROR {e}"
        obj = table[name]
        ok = True
        if sub in ("RUNWAY", "RWY", "RUNWAYS"):
            ok = obj.setrunways(subargs)
        elif sub == "DEST":
            ok = obj.adddest(subargs)
        elif sub == "ORIG":
            ok = obj.addorig(subargs)
        elif sub == "FLOW":
            ok = obj.setflow(subargs[0])
        elif sub in ("TYPES", "TYPE"):
            ok = obj.addactypes(subargs)
        elif sub == "ALT":
            ok = obj.setalt(subargs)
        elif sub == "SPD":
            ok = obj.setspd(subargs)
        elif sub == "HDG":
            ok = obj.sethdg(subargs)
        elif sub:
            return False, f"TRAFGEN {name}: unknown subcommand {sub}"
        if not ok:
            return False, f"TRAFGEN {name} {sub}: error"
        return True

    # ------------------------------------------------------------- update
    def update(self):
        t = self.sim.simt
        dt = max(0.0, t - self.last_t)
        self.last_t = t
        if dt <= 0.0:
            return
        for src in self.sources.values():
            self._update_source(src, dt, t)
        for drn in self.drains.values():
            self._update_drain(drn, dt, t)

    def _spawn_count(self, obj, dt):
        lam = self.gain * obj.flow * dt / 3600.0
        return int(self.rng.poisson(lam)) if lam > 0.0 else 0

    def _acid(self, prefix):
        # Skip callsigns already flying (a fresh TrafGen after PLUGINS
        # REMOVE/LOAD restarts its counter while aircraft persist)
        while True:
            self._fltnr += 1
            acid = f"{prefix[:3]}{self._fltnr:04d}"
            if self.sim.traf.id2idx(acid) < 0:
                return acid

    def _update_source(self, src, dt, t):
        """Spawn from a source: runway queues or instant at position
        (trafgenclasses.py:252-396, batched)."""
        n_new = self._spawn_count(src, dt)
        stack = self.sim.stack
        if src.runways:
            # Queue arrivals on random runways, release per dtakeoff
            for _ in range(n_new):
                src.rwyline[self.rng.integers(len(src.runways))] += 1
            for i, (rwy, rlat, rlon, rhdg) in enumerate(src.runways):
                if src.rwyline[i] > 0 and t - src.rwytotime[i] \
                        > src.dtakeoff:
                    src.rwytotime[i] = t
                    src.rwyline[i] -= 1
                    acid = self._acid(src.name)
                    actype = src.actypes[self.rng.integers(
                        len(src.actypes))]
                    stack.stack(f"CRE {acid},{actype},{rlat},{rlon},"
                                f"{rhdg},0,0")
                    stack.stack(f"{acid} SPD 250")
                    stack.stack(f"{acid} ALT FL100")
                    stack.stack(f"{acid} HDG {rhdg}")
                    self._give_dest(stack, acid, src)
            return
        if n_new == 0:
            return
        # Instant spawns at the source point: ONE traf.create call for the
        # whole batch (single device write sweep on flush); only the
        # guidance follow-ups go through stack command strings.
        alt_ft, spd_kt = src.start_alt_spd(self.rng, n_new)
        if src.incircle and not src.seg:
            hdg = self.rng.uniform(0.0, 360.0, n_new)
        else:
            hdg = np.full(n_new, src.hdg if src.hdg is not None else 0.0)
        acids = [self._acid(src.name) for _ in range(n_new)]
        actypes = [src.actypes[self.rng.integers(len(src.actypes))]
                   for _ in range(n_new)]
        self.sim.traf.create(
            n_new, actypes, acalt=alt_ft * 0.3048,
            acspd=spd_kt * 0.514444, aclat=np.full(n_new, src.lat),
            aclon=np.full(n_new, src.lon), achdg=hdg, acid=acids)
        for k in range(n_new):
            self._give_dest(stack, acids[k], src)

    def _give_dest(self, stack, acid, src):
        if not src.dest:
            return
        name, dlat, dlon = src.dest[self.rng.integers(len(src.dest))]
        if name and not name.startswith("SEGM"):
            stack.stack(f"{acid} DEST {name}")
        else:
            stack.stack(f"{acid} DEST {dlat} {dlon}")
        stack.stack(f"{acid} LNAV ON")

    def _update_drain(self, drn, dt, t):
        """Spawn toward a drain from its origins (trafgenclasses.py:608-682,
        batched)."""
        n_new = self._spawn_count(drn, dt)
        if n_new == 0:
            return
        stack = self.sim.stack
        alt_ft, spd_kt = drn.start_alt_spd(self.rng, n_new)
        lats, lons, hdgs, acids, actypes = [], [], [], [], []
        for _ in range(n_new):
            if drn.orig:
                oname, olat, olon, oincirc = drn.orig[
                    self.rng.integers(len(drn.orig))]
                hdg = _bearing(olat, olon, drn.lat, drn.lon)
                if not oincirc:
                    olat, olon = self.segpos(
                        (_bearing(self.ctrlat, self.ctrlon, olat, olon)))
                    hdg = _bearing(olat, olon, drn.lat, drn.lon)
            else:
                brg = self.rng.uniform(0.0, 360.0)
                olat, olon = self.segpos(brg)
                hdg = (brg + 180.0) % 360.0
            lats.append(olat)
            lons.append(olon)
            hdgs.append(hdg)
            acids.append(self._acid(drn.name))
            actypes.append(drn.actypes[self.rng.integers(
                len(drn.actypes))])
        self.sim.traf.create(
            n_new, actypes, acalt=alt_ft * 0.3048,
            acspd=spd_kt * 0.514444, aclat=np.asarray(lats),
            aclon=np.asarray(lons), achdg=np.asarray(hdgs), acid=acids)
        for acid in acids:
            if not drn.seg:
                stack.stack(f"{acid} DEST {drn.name}")
            else:
                stack.stack(f"{acid} ADDWPT {drn.lat} {drn.lon}")
            stack.stack(f"{acid} LNAV ON")


def _bearing(lat1, lon1, lat2, lon2):
    """Flat-earth bearing [deg 0..360) (trafgenclasses kwikqdrdist use)."""
    dlat = lat2 - lat1
    dlon = (lon2 - lon1 + 180.0) % 360.0 - 180.0
    coslat = np.cos(np.radians(0.5 * (lat1 + lat2)))
    return float(np.degrees(np.arctan2(dlon * coslat, dlat)) % 360.0)
