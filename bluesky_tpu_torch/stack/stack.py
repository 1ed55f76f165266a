"""The command stack: parse, dispatch, scenario record/replay.

Parity with reference ``bluesky/stack/stack.py``: a pending-command list
drained each loop (process, stack.py:1359-1464), a command dictionary of
``name -> (usage, argtypes, function, help)`` (stack.py:180-796) with
synonyms (stack.py:44-115), timed scenario files ``HH:MM:SS.hh>CMD`` with
PCALL %0..%n argument substitution and REL/ABS offsets (openfile,
stack.py:1025-1115), due-command stacking per step (checkfile,
stack.py:1177-1183), DELAY/SCHEDULE insertion (sched_cmd, stack.py:1005-
1022), and SAVEIC command recording + state snapshot (stack.py:1185-1350).

The "acid first" fallback syntax (``KL204 LNAV ON``) and zoom shorthand are
kept.  Command registration is open: plugins and loggers append at runtime
via ``append_commands`` exactly like the reference (stack.py:837).
"""
import os
from typing import Dict, List, Optional, Tuple

from .argparser import Argparser, ArgError, cmdsplit


class Stack:
    def __init__(self, sim):
        self.sim = sim
        self.parser = Argparser(sim)
        self.cmdstack: List[Tuple[str, str]] = []    # (cmdline, sender)
        self.cmddict: Dict[str, list] = {}           # NAME -> [usage, types, fn, help]
        self.synonyms: Dict[str, str] = {}
        # Scenario replay state
        self.scentime: List[float] = []
        self.scencmd: List[str] = []
        self.scenname = ""
        self.scenfile = ""        # last IC path (bare-IC reload)
        # SAVEIC recording
        self.savefile = None
        self.saveict0 = 0.0
        from .. import settings
        self.scenario_path = settings.scenario_path
        from . import commands
        commands.register_all(self)

    # --------------------------------------------------------- registration
    def append_commands(self, newcommands: Dict[str, list]):
        """Add/override commands at runtime (plugins, loggers)."""
        self.cmddict.update({k.upper(): v for k, v in newcommands.items()})

    def append_synonyms(self, syns: Dict[str, str]):
        self.synonyms.update({k.upper(): v.upper() for k, v in syns.items()})

    def remove_commands(self, names):
        """Remove commands (plugin unload, reference stack remove_commands)."""
        for n in names:
            self.cmddict.pop(n.upper(), None)

    # ------------------------------------------------------------- stacking
    def stack(self, cmdline: str, sender: str = ""):
        """Append commandline(s) to the pending stack (stack.py:997-1003)."""
        for line in cmdline.split(";"):
            if line.strip():
                self.cmdstack.append((line.strip(), sender))

    def process(self):
        """Drain and execute all pending commands (stack.py:1359-1464).

        Reentrancy-safe: the pending list is detached BEFORE execution,
        so a command that stacks and processes further commands (plugins
        like STACKCHECK do) cannot re-execute the lines already being
        drained."""
        while self.cmdstack:
            pending, self.cmdstack = self.cmdstack, []
            for cmdline, sender in pending:
                self._exec_cmdline(cmdline, sender)

    def _exec_cmdline(self, cmdline: str, sender: str = ""):
        # let the screen proxy route echo output back to the issuer
        self.sim.scr.current_sender = sender
        echo = self.sim.scr.echo
        args = cmdsplit(cmdline)
        if not args:
            return
        cmd = args[0].upper()
        rest = args[1:]

        # "acid first" syntax: KL204 LNAV ON -> LNAV KL204 ON; a bare
        # acid line means POS acid (stack.py:1390-1396)
        if cmd not in self.cmddict and cmd not in self.synonyms \
                and self.sim.traf.id2idx(cmd) >= 0:
            if rest:
                cmd, rest = rest[0].upper(), [args[0]] + rest[1:]
            else:
                cmd, rest = "POS", [args[0]]

        cmd = self.synonyms.get(cmd, cmd)
        entry = self.cmddict.get(cmd)
        if entry is None:
            # zoom shorthand: '+++'/'--' zoom by sqrt(2)^(n+ - n-),
            # '=' counts as '+' (same key) — reference stack.py:1436-1443
            if cmd[0] in "+=-" and set(cmd) <= set("+=-"):
                nplus = cmd.count("+") + cmd.count("=")
                self.sim.scr.zoom(2.0 ** (0.5 * (nplus - cmd.count("-"))))
                # never SAVEIC-recorded: ZOOM is in SAVEIC_EXCLUDE
                return
            echo(f"Unknown command: {cmd}")
            return

        usage, argtypes, fn = entry[0], entry[1], entry[2]
        try:
            parsed = self.parser.parse(argtypes, rest)
        except ArgError as e:
            echo(f"{cmd}: {e}")
            echo(f"Usage: {usage}")
            return

        # Any command may mutate traffic/display state: the ACDATA
        # stream must stop serving the cached chunk-edge telemetry
        # (simulation/pipeline.py) until the next edge retires.
        self.sim._last_edge = None
        try:
            result = fn(*parsed)
        except TypeError as e:
            # wrong arity for optional-arg functions
            echo(f"{cmd}: {e}")
            echo(f"Usage: {usage}")
            return
        except Exception as e:  # noqa: BLE001 — a command bug/bad input
            # must never kill the sim node (stack lines arrive from
            # remote clients); echo the failure instead.
            echo(f"{cmd} failed: {type(e).__name__}: {e}")
            return
        # Result protocol like the reference: True/False/None or
        # (success, echotext)
        if isinstance(result, tuple):
            ok, msg = result[0], result[1] if len(result) > 1 else ""
            if msg:
                echo(msg)
            if not ok and usage:
                echo(f"Usage: {usage}")
        elif result is False:
            echo(f"Usage: {usage}")
        # SAVEIC recording of successful commands (stack.py:1400-1401)
        if self.savefile is not None and result is not False \
                and cmd not in SAVEIC_EXCLUDE:
            self.savecmd(cmdline)

    # ------------------------------------------------------- scenario files
    def openfile(self, fname: str, pcall_args: Optional[List[str]] = None,
                 mergeWithExisting: bool = False, t_offset: float = 0.0):
        """Load a .scn file into (scentime, scencmd) (stack.py:1025-1115).

        Lines: ``[HH:MM:]SS[.hh]>CMD ...``; blank lines/comments (#) skipped;
        ``%0..%n`` substituted from pcall_args.
        """
        path = self._find_scn(fname)
        if path is None:
            return False, f"Scenario file {fname} not found"
        scentime, scencmd = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if ">" not in line:
                    continue
                tstr, cmd = line.split(">", 1)
                cmd = cmd.strip()
                if pcall_args:
                    for i, a in enumerate(pcall_args):
                        cmd = cmd.replace(f"%{i}", a)
                try:
                    from .argparser import txt2time
                    t = txt2time(tstr.strip())
                except ValueError:
                    continue
                scentime.append(t + t_offset)
                scencmd.append(cmd)
        if mergeWithExisting:
            merged = sorted(zip(self.scentime + scentime,
                                range(len(self.scencmd) + len(scencmd)),
                                self.scencmd + scencmd))
            self.scentime = [m[0] for m in merged]
            self.scencmd = [m[2] for m in merged]
        else:
            self.scentime, self.scencmd = scentime, scencmd
        return True, None

    def set_scendata(self, scentime, scencmd):
        """Install a pre-parsed scenario (BATCH farm-out piece,
        simulation.py:225-230)."""
        self.scentime = list(scentime)
        self.scencmd = list(scencmd)

    def _find_scn(self, fname: str) -> Optional[str]:
        if not fname.lower().endswith(".scn"):
            fname += ".scn"
        from .. import settings
        cands = [fname, os.path.join(self.scenario_path, fname)]
        # the reference scenario library ships ~90 .scn files; search it
        # after the local dir (settings defaults it when mounted)
        if settings.ref_scenario_path:
            cands.append(os.path.join(settings.ref_scenario_path, fname))
        for c in cands:
            if os.path.isfile(c):
                return c
        # case-insensitive fallback (the library mixes .scn and .SCN)
        for d in (self.scenario_path, settings.ref_scenario_path):
            if d and os.path.isdir(d):
                low = fname.lower()
                for entry in os.listdir(d):
                    p = os.path.join(d, entry)
                    if entry.lower() == low and os.path.isfile(p):
                        return p
        return None

    def checkfile(self, simt: float):
        """Stack all scenario commands that are due (stack.py:1177-1183)."""
        while self.scencmd and self.scentime[0] <= simt + 1e-9:
            self.stack(self.scencmd.pop(0))
            self.scentime.pop(0)

    def next_trigger_time(self) -> Optional[float]:
        return self.scentime[0] if self.scentime else None

    def ic(self, fname: str = ""):
        """IC: reset and replay a scenario (stack.py:1139-1174)."""
        self.saveclose()
        if fname.upper() == "IC" or fname == "":
            # bare IC reloads the last scenario — by its ORIGINAL path,
            # which may live outside the search dirs
            fname = self.scenfile or self.scenname or "ic"
        ok, msg = self.openfile(fname)
        if not ok:
            return False, msg
        scentime, scencmd = self.scentime, self.scencmd
        self.sim.reset()
        self.scentime, self.scencmd = scentime, scencmd
        # scenname is the STEM, never a path — it is spliced into log
        # filenames (reference stack.py IC does the same strip);
        # scenfile keeps the reload path.
        self.scenfile = fname
        self.scenname = os.path.splitext(os.path.basename(fname))[0]
        return True, f"IC: loaded {fname}"

    def scen(self, name: str, mergetime: Optional[float] = None):
        self.scenname = name
        return True

    def sched_cmd(self, dt_or_time: float, cmdline: str, relative: bool):
        """DELAY/SCHEDULE: insert a command into the timed queue
        (stack.py:1005-1022)."""
        t = self.sim.simt + dt_or_time if relative else dt_or_time
        i = 0
        while i < len(self.scentime) and self.scentime[i] <= t:
            i += 1
        self.scentime.insert(i, t)
        self.scencmd.insert(i, cmdline)
        return True

    # ---------------------------------------------------------------- SAVEIC
    def saveic(self, fname: Optional[str] = None):
        """Snapshot current traffic as CRE/route commands + record onward
        commands (stack.py:1185-1321, condensed)."""
        if fname is None:
            return False, "SAVEIC needs a filename"
        if not fname.lower().endswith(".scn"):
            fname += ".scn"
        os.makedirs(self.scenario_path, exist_ok=True)
        path = os.path.join(self.scenario_path, fname)
        self.savefile = open(path, "w")
        self.saveict0 = self.sim.simt
        from ..ops import aero
        traf = self.sim.traf
        st = traf.state
        for slot, acid in enumerate(traf.ids):
            if acid is None:
                continue
            lat = float(st.ac.lat[slot])
            lon = float(st.ac.lon[slot])
            hdg = float(st.ac.hdg[slot])
            alt = float(st.ac.alt[slot])
            cas = float(st.ac.cas[slot])
            self.savecmd(
                f"CRE {acid} {traf.types[slot]} {lat:.6f} {lon:.6f} "
                f"{hdg:.1f} {alt / aero.ft:.0f} {cas / aero.kts:.0f}")
            r = self.sim.routes.routes.get(slot)
            if r is not None:
                for w in range(r.nwp):
                    altarg = f" {r.alt[w] / aero.ft:.0f}" if r.alt[w] >= 0 else ""
                    self.savecmd(f"ADDWPT {acid} {r.lat[w]:.6f} {r.lon[w]:.6f}"
                                 + altarg)
        return True, f"SAVEIC: recording to {path}"

    def savecmd(self, cmdline: str):
        if self.savefile is None:
            return
        t = self.sim.simt - self.saveict0
        h = int(t // 3600)
        m = int((t % 3600) // 60)
        s = t % 60
        self.savefile.write(f"{h:02d}:{m:02d}:{s:05.2f}>{cmdline}\n")

    def saveclose(self):
        if self.savefile is not None:
            self.savefile.close()
            self.savefile = None
        return True

    def reset(self):
        self.saveclose()
        self.cmdstack = []
        self.scentime, self.scencmd = [], []


# Commands never recorded by SAVEIC (reference stack.py:129-131
# defexcl: display commands and aircraft creation — the saveic snapshot
# already reconstructs the live fleet, and the reference additionally
# skips later CRE/MCRE/TRAFGEN by default)
SAVEIC_EXCLUDE = {"SAVEIC", "IC", "RESET", "QUIT", "STOP", "OP", "HOLD",
                  "PAUSE", "FF", "BENCHMARK", "SCEN", "PCALL",
                  "PAN", "ZOOM", "POS", "INSEDIT", "CALC",
                  "CRE", "MCRE", "TRAFGEN"}
