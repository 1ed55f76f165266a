"""The port's stack against the JAX package's: the cases of
``tests/test_stack.py`` typed into both ``Simulation``s.

Each case drives the JAX ``Simulation`` and the port's
``Simulation(device="cpu")`` (32 slots, float64) with the same command
lines and sim-time horizons (wall-clock pacing off), then holds the
echo text, callsigns, types, host routes, configuration and state
against each other (``torch_parity.assert_sims_equal``: ints, bools and
partner sets equal, floats within 1e-9, the resolver commands within
1e-7).  Files a case writes are compared too: SAVEIC scenarios by
their text, SNAPSHOT files by name only (each package pickles its own
state classes; ``test_torch_snapshot.py`` holds what crosses).

The command surface: the port registers every command name and synonym
of the JAX package with the same usage text, and defers none: SCREENSHOT,
the last deferred command, writes the radar SVG JAX writes.
"""
import pytest

from torch_parity import (assert_sims_equal, assert_svg_close, no_pacing,
                          sim_do, sim_pair)


@pytest.fixture(autouse=True)
def _no_pacing(monkeypatch):
    no_pacing(monkeypatch)

ROUTE = ("CRE KL204 B744 52 4 90 FL200 250",
         "ADDWPT KL204 52.2 4.5 FL220", "ADDWPT KL204 52.4 5.0")

#: name -> steps: a tuple of command lines, a float (run to that simt),
#: or ("file", name, text) (written into the case's working directory)
CASES = {
    "cre_pos": [("CRE KL204 B744 52 4 90 FL200 250", "POS KL204"), 2.0,
                ("POS KL204",)],
    "duplicate_and_syntax": [
        ("CRE KL204 B744 52 4 90 FL200 250",),
        ("CRE KL204 B744 52 4 90 FL200 250",), ("CRE",), ("FOO BAR",),
        ("ALT NOBODY FL300",), ("SPD KL204",)],
    "acid_first": [("CRE KL204 B744 52 4 90 FL200 250", "KL204 ALT FL300",
                    "KL204"), 3.0],
    "alt_spd_hdg_vs": [
        ("CRE KL204 B744 52 4 90 FL200 250", "ALT KL204 FL300",
         "SPD KL204 280"), 2.0,
        ("SPD KL204 M.82", "HDG KL204 180", "VS KL204 1000"), 4.0],
    "del_delall_move": [
        ("CRE A1 B744 52 4 90 FL200 250", "CRE A2 B744 53 4 90 FL200 250",
         "MOVE A2 30 5 FL100 45 200 500"), 1.0,
        ("DEL A1", "LISTAC"), 2.0, ("DELALL", "LISTAC"), 3.0],
    "route_editing": [
        ROUTE + ("LISTRTE KL204",), 2.0,
        ("DELWPT KL204 WP002", "DIRECT KL204 WP001", "LISTRTE KL204",
         "LNAV KL204", "VNAV KL204 ON", "VNAV KL204"), 5.0,
        ("DELRTE KL204", "LNAV KL204 ON")],
    "dest_orig_lnav_vnav": [
        ("CRE KL204 B744 52 4 90 FL200 250", "ORIG KL204 51.9 3.9",
         "DEST KL204 52.5 6.0", "ADDWPT KL204 52.1 4.6 FL180 240",
         "LISTRTE KL204", "DEST KL204", "LNAV KL204 OFF",
         "LNAV KL204 ON", "VNAV KL204 ON"), 6.0,
        ("KL204 AT WP001 ALT FL160", "KL204 AT WP001", "LISTRTE KL204",
         "KL204 AFTER WP001 ADDWPT 52.3 5.2", "LISTRTE KL204"), 8.0],
    "asas_settings": [
        ("CRE A1 B744 52 4 90 FL200 250", "CRE A2 B744 52.01 4.3 270 FL200 250",
         "CRE A3 B744 52.1 4.1 180 FL201 250", "ZONER 3", "ZONEDH 800", "DTLOOK 120", "RESO OFF",
         "RESO", "RESO MVP", "ASAS OFF", "ASAS", "ASAS ON", "RESO BOGUS",
         "RSZONER 3.5", "RFACV 1.2", "RMETHH HDG", "ASASV MAX 300",
         "PRIORULES ON FF2", "PRIORULES", "CONFINFO"), 4.0,
        ("NORESO A1", "RESOOFF A2", "NORESO A3", "NORESO A1",
         "NORESO NOBODY"), 6.0,
        ("NORESO", "RESOOFF", "PRIORULES OFF", "CONFINFO"), 8.0],
    "syn_super_matrix_wall": [("SYN SUPER 8",), 2.0, ("SYN MATRIX 3",),
                              3.0, ("SYN WALL",), 4.0],
    "ic_schedule_delay": [
        ("file", "test.scn",
         "# comment\n00:00:00.00>CRE KL204 B744 52 4 90 FL200 250\n"
         "00:00:05.00>ALT KL204 FL300\n00:00:10.00>ECHO scenario done\n"),
        ("IC test",), 3.0,
        ("DELAY 2 ECHO later", "SCHEDULE 00:00:07 ECHO at7",
         "KL204 ATALT FL250 ECHO passed"), 12.0, ("POS KL204",)],
    "pcall": [
        ("file", "param.scn", "00:00:00.00>CRE %0 B744 52 4 90 FL200 250\n"),
        ("PCALL param ACX",), 1.0, ("POS ACX",)],
    "saveic": [(*ROUTE, "SAVEIC mysave"), 1.0,
               ("ALT KL204 FL300", "HDG KL204 100"), 2.0, ("SAVEIC",)],
    "wind_getwind": [
        ("CRE KL204 B744 52 4 90 FL200 250", "WIND 52 4 270 30",
         "GETWIND 52 4", "GETWIND 52.5 4.5 FL200"), 2.0,
        ("WIND 53 5 FL100 180 25 FL300 290 90", "GETWIND 52.5 4.5 FL200",
         "WIND 52 4 10"), 4.0, ("DEL WIND", "GETWIND 52 4")],
    "dt_dtmult": [("CRE KL204 B744 52 4 90 FL200 250", "DTMULT 5",
                   "DTMULT", "DT 0.1", "DT"), 2.0],
    "calc_dist": [("CALC 2 + 3", "CALC 2 ** ", "DIST 0 0 1 0",
                   "DIST 52 4 52.5 5.5", "ECHO hello world")],
    "seed_mcre": [("SEED 42", "MCRE 3"), 1.0, ("SEED 7", "MCRE 2 A320"),
                  2.0],
    "sim_control_toggles": [
        ("SYN SUPER 6", "ASAS ON", "SCANSTATS ON", "SORTREFRESH ON",
         "FINGERPRINT ON", "CHUNKSTEPS 5", "SCANSTATS"), 2.0,
        ("SCANSTATS", "SORTREFRESH", "CHUNKSTEPS", "HOLD"), 3.0,
        ("OP", "FF 2"), 6.0,
        ("OP", "CHUNKSTEPS PIPELINE OFF", "SCANSTATS OFF", "FINGERPRINT OFF",
         "CHUNKSTEPS 20"), 7.0, ("CHUNKSTEPS", "RESET", "CHUNKSTEPS")],
    # the detached sim: BATCH has no server, WORLDS reads and sets the
    # packing settings (restored after the case)
    "batch_worlds": [
        ("CRE KL204 B744 52 4 90 FL200 250", "BATCH myscen.scn", "WORLDS",
         "WORLDS ON", "WORLDS", "WORLDS MAX 32", "WORLDS"), 1.0,
        ("WORLDS MAX 0", "WORLDS MAX many", "WORLDS FOO", "WORLDS OFF",
         "WORLDS")],
    # SNAPSHOT SAVE/LOAD: each package writes and restores its own file
    "snapshot_save_load": [
        ROUTE + ("ALT KL204 FL300",), 2.0, ("SNAPSHOT SAVE mysnap",), 3.0,
        ("SNAPSHOT LOAD mysnap", "SNAPSHOT LOAD nosuch.snap", "SNAPSHOT",
         "SNAPSHOT FOO mysnap", "LISTRTE KL204", "OP"), 4.0],
}


def run_case(sim, steps):
    """The echo of every line of ``steps`` (runs and files add none)."""
    echo = []
    for step in steps:
        if isinstance(step, float):
            sim.run(until_simt=step)
            echo += sim.scr.echobuf
            sim.scr.echobuf.clear()
        elif step[0] == "file":
            with open(step[1], "w") as f:
                f.write(step[2])
        else:
            echo += sim_do(sim, *step)
    sim.stack.saveclose()
    return echo


@pytest.mark.parametrize("case", sorted(CASES))
def test_stack_case(case, tmp_path, monkeypatch):
    from bluesky_tpu import settings as jsettings
    from bluesky_tpu_torch import settings as tsettings
    for mod in (jsettings, tsettings):      # WORLDS sets these
        for knob in ("world_pack", "world_batch_max"):
            monkeypatch.setattr(mod, knob, getattr(mod, knob))
    jsim, tsim = sim_pair()
    out = {}
    for name, sim in (("jax", jsim), ("port", tsim)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        sim.stack.scenario_path = "."
        out[name] = run_case(sim, CASES[case])
    assert_sims_equal(jsim, tsim, out["jax"], out["port"])
    assert (tsettings.world_pack, tsettings.world_batch_max) \
        == (jsettings.world_pack, jsettings.world_batch_max)
    if case == "batch_worlds":
        assert "BATCH: no server attached (headless sim)" in out["port"]
        assert (tsettings.world_pack, tsettings.world_batch_max) \
            == (False, 32)
    jfiles = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == jfiles
    for f in jfiles:
        if f.endswith(".snap"):
            continue
        assert (tmp_path / "port" / f).read_text() \
            == (tmp_path / "jax" / f).read_text(), f
    if case == "snapshot_save_load":
        assert "Snapshot mysnap.snap restored: 1 aircraft at simt=2.00" \
            in out["port"]
        assert "nosuch.snap: not found" in out["port"]
    if case == "saveic":
        text = (tmp_path / "port" / "mysave.scn").read_text()
        assert "CRE KL204" in text and "ADDWPT KL204" in text \
            and "ALT KL204" in text


def test_command_surface():
    """Every JAX command name and synonym, with its usage text."""
    jsim, tsim = sim_pair()
    jst, tst = jsim.stack, tsim.stack
    assert sorted(tst.cmddict) == sorted(jst.cmddict)
    assert tst.synonyms == jst.synonyms
    for name, entry in jst.cmddict.items():
        assert tst.cmddict[name][0] == entry[0], name


def test_screenshot_is_not_deferred(tmp_path):
    """SCREENSHOT, the last deferred command, is ported with the radar:
    it writes the SVG the JAX package writes, on the same scenario, and
    answers with JAX's text."""
    jsim, tsim = sim_pair()
    files = []
    for tag, sim in (("jax", jsim), ("port", tsim)):
        sim_do(sim, *ROUTE, "BOX SECT 51 3 53 5", "POS KL204", "SSD KL204",
               "TRAIL ON 1", "OP")
        sim.run(until_simt=3.0)
        fname = str(tmp_path / f"{tag}.svg")
        files.append((sim_do(sim, f"SCREENSHOT {fname}"), fname))
    (jecho, jname), (techo, tname) = files
    assert techo == [f"Radar snapshot written to {tname}"]
    assert jecho == [f"Radar snapshot written to {jname}"]
    with open(tname) as f, open(jname) as g:
        got, want = f.read(), g.read()
    assert 'data-acid="KL204"' in got and "SECT" in got \
        and 'class="ssd"' in got
    assert_svg_close(got, want)


def test_plugins_left_deferred():
    """PLUGINS left ``DEFERRED`` with the plugin system: it answers as
    the JAX package's does, listing the shipped plugins, loading and
    removing one."""
    jsim, tsim = sim_pair()
    for line in ("PLUGINS", "PLUGINS LIST", "PLUGINS LOAD EXAMPLE",
                 "MYFUN ON", "PLUGINS LIST", "PLUGINS REMOVE EXAMPLE",
                 "PLUGINS LOAD NOSUCH"):
        jecho, techo = sim_do(jsim, line), sim_do(tsim, line)
        assert techo == jecho, line
        assert not any("ROADMAP" in e for e in techo)
    listed = sim_do(tsim, "PLUGINS LIST")[0]
    for name in ("AREA", "TRAFGEN", "ENSEMBLE", "STACKCHECK", "WINDGFS"):
        assert name in listed
    assert "MYFUN" not in tsim.stack.cmddict


#: the worker-side commands of the serving fabric, each with the lines
#: a user types on a detached sim
WORKER_CMDS = {
    "ADDNODES": ("ADDNODES 2", "ADDNODES"),
    "HA": ("HA", "HA STATUS", "HA ON"),
    "MITIGATE": ("MITIGATE", "MITIGATE ON", "MITIGATE STATUS",
                 "MITIGATE OFF", "MITIGATE X"),
    "SDC": ("SDC", "SDC ON", "SDC AUDIT 0.25", "SDC STATUS", "SDC AUDIT",
            "SDC OFF", "SDC X"),
}


@pytest.mark.parametrize("name", sorted(WORKER_CMDS))
def test_worker_commands_answer_as_jax_detached(name, monkeypatch):
    """ADDNODES, HA, MITIGATE and SDC left ``DEFERRED`` with the worker
    side of the network: on a detached sim each answers with the JAX
    package's text and sets the same settings."""
    from bluesky_tpu import settings as jsettings
    from bluesky_tpu_torch import settings as tsettings
    keys = ("mitigate_enabled", "sdc_enabled", "sdc_audit_rate",
            "ha_standby", "ha_lease_ttl")
    for mod in (jsettings, tsettings):
        for k in keys:
            monkeypatch.setattr(mod, k, getattr(mod, k))
    jsim, tsim = sim_pair()
    for line in WORKER_CMDS[name]:
        jecho, techo = sim_do(jsim, line), sim_do(tsim, line)
        assert techo == jecho, line
        assert not any("ROADMAP" in e for e in techo)
        for k in keys:
            assert getattr(tsettings, k) == getattr(jsettings, k), (line, k)


def test_opt_and_grad_are_not_deferred():
    """OPT and GRAD left ``DEFERRED`` with the differentiable mode: they
    are the JAX commands now, and answer as JAX's do without traffic."""
    jsim, tsim = sim_pair()
    for line in ("OPT", "GRAD", "OPT 100,2"):
        jecho, techo = sim_do(jsim, line), sim_do(tsim, line)
        assert techo == jecho
        assert not any("ROADMAP" in e for e in techo)
