"""The port's shared UI logic (``bluesky_tpu_torch/ui/radarclick.py``,
``console``, ``polytools``, ``palette``) against the JAX package's
(``tests/test_ui_tools.py``), on the CPU.

* radarclick: every click type (callsign, position, heading from an
  aircraft, from CRE's and MOVE's position, distance, airport,
  waypoint in route), a typed callsign (POS), synonyms, the two-corner
  BOX, the repeating POLY vertex, unknown commands and clicks past the
  last argument, on the same Simulation pair: equal ``(tostack,
  todisplay)``.
* console: the same key sequences give the same lines, history and
  submissions; IC/BATCH completion cycles the same way.
* polytools: the same triangle buffers; palette: the same registry,
  defaults and loaded files.
"""
import numpy as np
import pytest

from bluesky_tpu.ui import console as jconsole
from bluesky_tpu.ui import palette as jpalette
from bluesky_tpu.ui import polytools as jpoly
from bluesky_tpu.ui import radarclick as jclick
from bluesky_tpu_torch.ui import console as tconsole
from bluesky_tpu_torch.ui import palette as tpalette
from bluesky_tpu_torch.ui import polytools as tpoly
from bluesky_tpu_torch.ui import radarclick as tclick

from torch_parity import sim_do, sim_pair


@pytest.fixture(scope="module")
def pair():
    jsim, tsim = sim_pair(nmax=16)
    for sim in (jsim, tsim):
        sim_do(sim, "CRE KL204 B744 52.0 4.0 90 FL200 250",
               "CRE PH808 B744 53.0 5.0 180 FL100 220",
               "ADDWPT KL204 52.5 4.5", "ADDWPT KL204 52.8 4.9")
    return jsim, tsim


CLICKS = [
    ("", 52.01, 4.02), ("KL204", 52.0, 4.0), ("kl204", 52.0, 4.0),
    ("PAN ", 51.5, 3.25), ("PAN", 51.5, 3.25), ("HDG KL204 ", 52.0, 5.0),
    ("HDG KL204", 51.0, 3.0), ("HDG NOSUCH ", 52.0, 5.0),
    ("DIRECT KL204 ", 52.79, 4.89), ("DIRECT PH808 ", 52.79, 4.89),
    ("NOSUCH ", 52.0, 4.0), ("DELETE ", 52.99, 4.99),
    ("BOX A ", 50.0, 3.0), ("BOX A 50.0,3.0 ", 51.0, 4.0),
    ("POLY A 50,4 51,4 ", 51.0, 5.0), ("CRE AB1 B744 ", 52.5, 4.5),
    ("CRE AB1 B744 52.1,4.1 ", 52.6, 4.9),
    ("MOVE KL204 52.2,4.2 FL200 ", 52.0, 3.5),
    ("CIRCLE C1 52.0,4.0 ", 52.2, 4.3), ("CIRCLE C1 52,x ", 52.2, 4.3),
    ("DEST KL204 ", 52.3, 4.76), ("POS KL204 ", 52.0, 4.0),
    ("SSD KL204 ", 53.0, 5.0), ("SSD KL204 PH808 ", 52.0, 4.0),
    ("DIST 52,4 ", 52.5, 4.5), ("DIST 52,4 52.5,4.5 ", 52.5, 4.5),
]


@pytest.mark.parametrize("line,lat,lon", CLICKS)
def test_radarclick_equal(pair, line, lat, lon):
    jsim, tsim = pair
    got = tclick.radarclick(line, lat, lon, tsim)
    assert got == jclick.radarclick(line, lat, lon, jsim)
    if line == "":
        assert got == ("", "KL204 ")


def test_findnearest_equal():
    rng = np.random.default_rng(3)
    lat, lon = rng.uniform(50, 54, 40), rng.uniform(2, 8, 40)
    for q in rng.uniform(50, 54, (10, 2)):
        assert tclick.findnearest(q[0], q[1] + 1, lat, lon) \
            == jclick.findnearest(q[0], q[1] + 1, lat, lon)
    assert tclick.findnearest(52, 4, [], []) == -1
    assert tclick.CLICKCMD == jclick.CLICKCMD


KEYS = [("char", "O"), ("char", "P"), ("enter",), ("char", "X"), ("up",),
        ("down",), ("backspace",), ("set", "A"), ("enter",), ("set", "B"),
        ("enter",), ("up",), ("up",), ("up",), ("down",), ("append", "C "),
        ("append", "51.0,4.0 \n"), ("enter",), ("set", ""), ("enter",)]


def _drive(mod):
    sent, shown = [], []
    c = mod.Console(sent.append, shown.append)
    trace = []
    for key in KEYS:
        name, *arg = key
        fn = {"char": c.key_char, "enter": c.key_enter, "up": c.key_up,
              "down": c.key_down, "backspace": c.key_backspace,
              "set": c.set_cmdline, "append": c.append_cmdline}[name]
        fn(*arg)
        trace.append((c.command_line, c.history_pos,
                      list(c.command_history)))
    return sent, shown, trace


def test_console_equal():
    got = _drive(tconsole)
    assert got == _drive(jconsole)
    assert got[0] == ["OP", "A", "B"]


@pytest.mark.parametrize("lines", [
    ["IC dem", "IC dem", "IC oth"], ["IC so"], ["BATCH o"], ["OP"],
    ["IC nomatch"]])
def test_autocomplete_equal(tmp_path, lines):
    for name in ("demo1.scn", "demo2.scn", "Other.scn", "solo.scn"):
        (tmp_path / name).write_text("0:00:00.00>OP\n")
    ta = tconsole.Autocomplete(str(tmp_path))
    ja = jconsole.Autocomplete(str(tmp_path))
    for line in lines:
        assert ta.complete(line) == ja.complete(line), line
    assert tconsole.iglob(str(tmp_path / "D*")) \
        == jconsole.iglob(str(tmp_path / "D*"))


@pytest.mark.parametrize("contour", [
    [0, 0, 1, 0, 1, 1, 0, 1], [0, 0, 2, 0, 2, 1, 1, 1, 1, 2, 0, 2],
    [0, 0, 0, 1, 1, 1, 1, 0, 0, 0], [0, 0, 1, 0, 2, 0, 2, 2, 0, 2],
    [(0, 0), (3, 0), (3, 3), (2, 1), (1, 3), (0, 3)], [0, 0, 1, 1]])
def test_polytools_equal(contour):
    assert tpoly.earclip(contour) == jpoly.earclip(contour)
    tps, jps = tpoly.PolygonSet(), jpoly.PolygonSet()
    for ps in (tps, jps):
        ps.begin()
        ps.addContour(contour)
        ps.addContour([2, 2, 3, 2, 3, 3, 2, 3])
        ps.end()
    assert tps.vbuf == jps.vbuf and tps.bufsize() == jps.bufsize()


def test_palette_equal(tmp_path):
    assert tpalette._colours == jpalette._colours
    p = tmp_path / "pal"
    p.write_text("aircraft = (10, 20, 30)  # override\n"
                 "junk line without equals\n"
                 "bad = not_a_tuple\nnewcol = (1, 2, 3)\n")
    saved = [dict(m._colours) for m in (tpalette, jpalette)]
    try:
        for m in (tpalette, jpalette):
            assert m.load(str(p)) and not m.load(str(tmp_path / "none"))
            m.set_default_colours(aircraft=(1, 1, 1), extra=(4, 5, 6))
        assert tpalette._colours == jpalette._colours
        assert tpalette.aircraft == (10, 20, 30)
        assert tpalette.get("nope", (7, 7, 7)) == (7, 7, 7)
        with pytest.raises(AttributeError):
            tpalette.nope
    finally:
        for m, s in zip((tpalette, jpalette), saved):
            m._colours.clear()
            m._colours.update(s)
