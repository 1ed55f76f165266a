"""Stack fuzz-tester: iterate every registered command inside a running
sim.

Parity with the reference ``plugins/stackcheck.py:15-418`` (a runtime
harness that walks the command dictionary and fires each command with
plausible arguments, watching for crashes).  Redesigned generically:
instead of the reference's hand-written per-command test list, arguments
are synthesized from each command's argtype spec, so new commands are
fuzzed automatically.  STACKCHECK runs the whole sweep in one call and
echoes a summary; commands that would end the run (QUIT/RESET/IC/...)
are skipped like the reference's exclude list.

Port of ``bluesky_tpu/plugins/stackcheck.py``, copied as it is.
"""

SKIP = {
    "QUIT", "RESET", "IC", "BATCH", "ADDNODES", "SAVEIC", "SCEN",
    "PCALL", "BENCHMARK", "STACKCHECK", "MAKEDOC", "SNAPSHOT",
    "PROFILE", "CD", "HOLD", "OP", "FF", "DELALL", "PLUGINS",
    # filesystem side effects (snapshots/logs/renders)
    "SCREENSHOT", "DUMPRTE", "SNAPLOG", "INSTLOG", "SKYLOG",
    "FLSTLOG", "OCCUPANCYLOG", "METLOG",
}

SAMPLE_ARGS = {
    "acid": "FUZZ1", "txt": "FUZZ1", "word": "fuzz", "string": "ECHO hi",
    "float": "1.5", "int": "2", "onoff": "ON", "alt": "FL100",
    "spd": "250", "vspd": "1000", "hdg": "90", "time": "60",
    "lat": "52.0", "lon": "4.0", "latlon": "52.0 4.0", "wpt": "52.0 4.0",
    "wppos": "52.0 4.0",
    "wpinroute": "WP001", "pandir": "LEFT", "color": "RED",
}


def init_plugin(sim):
    sc = StackCheck(sim)
    config = {
        "plugin_name": "STACKCHECK",
        "plugin_type": "sim",
        "update_interval": 0.0,
    }
    stackfunctions = {
        "STACKCHECK": [
            "STACKCHECK [command]",
            "[txt]",
            sc.run,
            "Fuzz every registered stack command (or one) with "
            "synthesized arguments",
        ],
    }
    return config, stackfunctions


class StackCheck:
    def __init__(self, sim):
        self.sim = sim
        self._running = False

    def _args_for(self, argtypes):
        out = []
        for tok in (argtypes or "").split(","):
            t = tok.strip().strip("[]").strip()
            if not t or t == "...":
                continue
            base = t.split("/")[0]
            out.append(SAMPLE_ARGS.get(base, "1"))
        return out

    def run(self, which=None):
        if self._running:       # re-entry guard (defense in depth)
            return True, "STACKCHECK already running"
        self._running = True
        try:
            return self._run(which)
        finally:
            self._running = False

    def _run(self, which):
        sim = self.sim
        stack = sim.stack
        # A test subject for acid-taking commands
        if sim.traf.id2idx("FUZZ1") < 0:
            sim.traf.create(1, "B744", 6000.0, 120.0, None, 52.0, 4.0,
                            90.0, "FUZZ1")
            sim.traf.flush()
            sim.routes.addwpt(sim.traf.id2idx("FUZZ1"), "WP001",
                              52.0, 5.0)
        names = [which.upper()] if which else sorted(stack.cmddict)
        failed = []
        tested = 0
        for name in names:
            if name in SKIP or name not in stack.cmddict:
                continue
            usage, argtypes, fn, _help = stack.cmddict[name]
            line = " ".join([name] + self._args_for(argtypes))
            # Capture this command's echoes via a tee — echobuf indices
            # are unreliable (ScreenIO bounds the buffer)
            collected = []
            orig_echo = sim.scr.echo

            def tee(text="", flags=0, _c=collected, _o=orig_echo):
                _c.append(text)
                return _o(text, flags)

            sim.scr.echo = tee
            try:
                stack.stack(line)
                stack.process()
            except Exception as e:  # noqa: BLE001 — fuzzing for crashes
                failed.append(f"{name}: {type(e).__name__}: {e}")
                continue
            finally:
                sim.scr.echo = orig_echo
            out = "\n".join(collected)
            if "failed:" in out:
                failed.append(f"{name}: {out.splitlines()[0]}")
            tested += 1
        msg = f"STACKCHECK: {tested} commands fired, {len(failed)} failed"
        if failed:
            msg += "\n" + "\n".join(failed[:20])
        return len(failed) == 0, msg
