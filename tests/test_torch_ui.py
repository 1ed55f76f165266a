"""The port's radar pictures (``bluesky_tpu_torch/ui/radar.py``) and
SCREENSHOT against the JAX package's (``tests/test_ui.py``), on the CPU.

* Host data: the same ACDATA dicts, shapes and routes through both
  packages' ``render_svg`` (with trails, conflicts and CPA lines, an
  empty frame, a fixed extent) and ``render_nd_acdata``, and the same
  SSD selections through ``compute_ssd_discs_acdata`` and ``ssd_disc``:
  equal text, equal discs.
* A live Simulation pair (float64, the same stack scenario):
  ``render_sim`` with trails, a route, a PAN/ZOOM view and each SSD
  selection, ``render_nd`` and ``render_plots``, and the SCREENSHOT
  file (named and default): equal SVGs, or their numbers within 1e-9
  where the float text differs.
* Each picture of a live sim reads the state in one device-to-host
  copy (``plugins.host_arrays``), SSD discs included.
"""
import os

import numpy as np
import pytest

from bluesky_tpu import settings as jsettings
from bluesky_tpu.network.guiclient import nodeData as JNodeData
from bluesky_tpu.ui import radar as jradar
from bluesky_tpu_torch import plugins as tplugins
from bluesky_tpu_torch import settings as tsettings
from bluesky_tpu_torch.network.guiclient import nodeData as TNodeData
from bluesky_tpu_torch.ui import radar as tradar

from torch_parity import assert_svg_close, no_pacing, sim_do, sim_pair

ACDATA = {
    "id": ["KL1", "KL2", "KL3"],
    "lat": np.array([52.0, 52.3, 51.7]),
    "lon": np.array([4.0, 4.4, 3.6]),
    "trk": np.array([90.0, 270.0, 10.0]),
    "alt": np.array([6096.0, 9144.0, 3000.0]),
    "gs": np.array([120.0, 150.0, 90.0]),
    "tas": np.array([130.0, 160.0, 95.0]),
    "inconf": np.array([False, True, True]),
    "tcpamax": np.array([0.0, 95.0, 40.0]),
    "traillat0": np.array([51.9, 52.2]), "traillon0": np.array([3.9, 4.5]),
    "traillat1": np.array([52.0, 52.3]), "traillon1": np.array([4.0, 4.4]),
}
SHAPES = {"SECT": ("POLY", [51.5, 3.5, 52.5, 3.5, 52.5, 4.5]),
          "CTR": ("CIRCLE", [52.0, 4.0, 10.0]),
          "RWY": ("LINE", [52.0, 4.0, 52.1, 4.1]),
          "GONE": ("BOX", None)}
ROUTE = {"wplat": [52.0, 52.5], "wplon": [4.5, 5.0],
         "wpname": ["WPA", "WP<B>"]}


@pytest.mark.parametrize("case", ["full", "empty", "extent", "title"])
def test_render_svg_equal_text(case):
    args = {"full": ((ACDATA, SHAPES, ROUTE, "test"), {}),
            "empty": (({}, {}, None), {}),
            "extent": ((ACDATA, None, None),
                       dict(extent=(51.0, 53.0, 3.0, 5.5))),
            "title": ((dict(ACDATA, id=["A&B", "<x>", 'q"']), {}, None,
                       "simt 3.0 s — 3 aircraft"), {})}[case]
    got = tradar.render_svg(*args[0], **args[1])
    assert got.startswith("<svg") and got.endswith("</svg>")
    assert got == jradar.render_svg(*args[0], **args[1])


def _nodes(acdata):
    out = []
    for cls in (JNodeData, TNodeData):
        nd = cls()
        nd.acdata = dict(acdata)
        out.append(nd)
    return out


@pytest.mark.parametrize("sel", [None, "KL1", "KL2", "GONE"])
def test_render_nd_acdata_equal_text(sel):
    jnd, tnd = _nodes(ACDATA)
    for nd in (jnd, tnd):
        nd.nd_acid = sel
        nd.routedata = {"acid": "KL1", "wplat": [52.1, 52.4],
                        "wplon": [4.2, 4.6]}
    got = tradar.render_nd_acdata(tnd)
    assert got == jradar.render_nd_acdata(jnd)
    if sel == "KL1":
        assert "KL2 +100" in got and "rng 40" in got


def test_ssd_disc_sampler_equal():
    lat = np.array([52.0, 52.0, 52.1, 53.5])
    lon = np.array([4.0, 4.3, 3.9, 4.0])
    gse = np.array([0.0, -120.0, 30.0, 0.0])
    gsn = np.array([100.0, 0.0, -90.0, 0.0])
    act = np.array([True, True, True, True])
    for i in range(4):
        kw = dict(vmin=51.4, vmax=92.6, rpz_m=9260.0, tlookahead=300.0)
        got = tradar.ssd_disc(i, lat, lon, gse, gsn, act, **kw)
        assert np.array_equal(got, jradar.ssd_disc(i, lat, lon, gse, gsn,
                                                   act, **kw))
    assert tradar.ssd_disc(0, lat, lon, gse, gsn, act, 51.4, 92.6, 9260.0,
                           300.0)[9].all()       # toward the intruder


@pytest.mark.parametrize("sel", [["AC1"], ["CONFLICTS"], ["ALL"], ["OFF"]])
def test_ssd_discs_acdata_equal(sel):
    acdata = {"id": ["AC1", "AC2", "AC3"],
              "lat": np.array([52.0, 52.0, 52.5]),
              "lon": np.array([4.0, 4.3, 4.1]),
              "trk": np.array([90.0, 270.0, 180.0]),
              "gs": np.array([120.0, 120.0, 100.0]),
              "inconf": np.array([True, True, False]),
              "asasrpz": 9260.0, "vmin": 51.4}
    jnd, tnd = _nodes(acdata)
    for nd in (jnd, tnd):
        nd.show_ssd(sel)
    assert (tnd.ssd_all, tnd.ssd_conflicts, tnd.ssd_ownship) \
        == (jnd.ssd_all, jnd.ssd_conflicts, jnd.ssd_ownship)
    got = tradar.compute_ssd_discs_acdata(
        tnd.acdata, tnd.ssd_all, tnd.ssd_conflicts, tnd.ssd_ownship)
    want = jradar.compute_ssd_discs_acdata(
        jnd.acdata, jnd.ssd_all, jnd.ssd_conflicts, jnd.ssd_ownship)
    if want is None:
        assert got is None
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g["conf"], w["conf"])
        assert {k: v for k, v in g.items() if k != "conf"} \
            == {k: v for k, v in w.items() if k != "conf"}
    assert tradar.render_svg(acdata, {}, None, ssd=got) \
        == jradar.render_svg(acdata, {}, None, ssd=want)


# ------------------------------------------------------- the live pictures
@pytest.fixture()
def pair(monkeypatch):
    no_pacing(monkeypatch)
    jsim, tsim = sim_pair(nmax=16)
    for sim in (jsim, tsim):
        sim_do(sim, "CRE AC1 B744 52 4.0 90 FL200 250",
               "CRE AC2 B744 52.02 4.8 268 FL205 245",
               "CRE AC3 A320 52.3 4.4 180 FL150 220",
               "ADDWPT AC3 52.0 4.5", "ADDWPT AC3 51.8 4.6",
               "BOX SECT 51.5 3.5 52.5 5", "CIRCLE CTR 52 4.4 10",
               "TRAIL ON 2", "ASAS ON", "OP", "FF 8")
        sim.run(until_simt=8.0)
    return jsim, tsim


def both(pair, *lines):
    jecho, techo = (sim_do(s, *lines) for s in pair)
    assert techo == jecho, lines
    return techo


def test_render_sim_trails_route_and_view(pair):
    jsim, tsim = pair
    got = tradar.render_sim(tsim)
    assert got.count('stroke="#2b8cbe"') >= 3       # trail segments
    assert "AC3" in got and "SECT" in got
    assert_svg_close(got, jradar.render_sim(jsim))
    assert (tsim.scr.ctrlat, tsim.scr.ctrlon, tsim.scr.scrzoom) == \
        pytest.approx((jsim.scr.ctrlat, jsim.scr.ctrlon, jsim.scr.scrzoom),
                      rel=1e-12)
    both(pair, "POS AC3")                      # selects the route
    got = tradar.render_sim(tsim)
    assert "WPT" in got or "stroke-dasharray=\"6 4\"" in got
    assert_svg_close(got, jradar.render_sim(jsim))
    both(pair, "PAN 52.1 4.3", "ZOOM 2")
    assert_svg_close(tradar.render_sim(tsim), jradar.render_sim(jsim))


def test_render_sim_ssd_selections(pair):
    jsim, tsim = pair
    echo = both(pair, "SSD AC1")
    assert "velocity envelope blocked" in echo[-1]
    for lines, n in ((("SSD AC1",), 0), (("SSD AC1",), 1),
                     (("SSD CONFLICTS",), None), (("SSD ALL",), 3),
                     (("SSD OFF",), 0), (("SSD NOSUCH",), 0)):
        both(pair, *lines)
        got = tradar.render_sim(tsim)
        if n is not None:
            assert got.count('class="ssd"') == n, lines
        assert_svg_close(got, jradar.render_sim(jsim))


@pytest.mark.parametrize("acid", ["AC1", "AC3", None])
def test_render_nd_live(pair, acid):
    jsim, tsim = pair
    if acid:
        both(pair, f"ND {acid}", "POS AC3")
    got = tradar.render_nd(tsim)
    assert_svg_close(got, jradar.render_nd(jsim))
    assert ("no aircraft selected" in got) == (acid is None)


def test_render_plots_live(pair):
    jsim, tsim = pair
    assert tradar.render_plots(tsim) == jradar.render_plots(jsim)
    both(pair, "PLOT simt ac.tas[0] 0.5", "PLOT simt ac.alt 1", "OP")
    for sim in pair:
        sim.run(until_simt=14.0)
    got = tradar.render_plots(tsim)
    assert got.count("<polyline") == 2
    assert_svg_close(got, jradar.render_plots(jsim))


def test_one_host_copy_per_picture(pair, monkeypatch):
    """``render_sim`` (with its SSD discs), ``render_nd``, the SSD
    command and a radar click each read the card once."""
    from bluesky_tpu_torch.ui import radarclick
    _, tsim = pair
    calls = []
    real = tplugins.host_arrays
    monkeypatch.setattr(tplugins, "host_arrays",
                        lambda *t: calls.append(len(t)) or real(*t))
    tsim.scr.show_ssd("ALL")
    tradar.render_sim(tsim)
    assert calls == [10]
    calls.clear()
    tsim.scr.shownd("AC1")
    tradar.render_nd(tsim)
    assert calls == [8]
    calls.clear()
    sim_do(tsim, "SSD AC2")
    assert calls == [6]
    calls.clear()
    radarclick.radarclick("HDG AC1 ", 52.0, 5.0, tsim)
    assert calls == [2]


@pytest.mark.parametrize("named", [True, False])
def test_screenshot_writes_jax_svg(pair, tmp_path, monkeypatch, named):
    jsim, tsim = pair
    files = []
    for pkg, sim, st in (("jax", jsim, jsettings), ("port", tsim, tsettings)):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.setattr(st, "log_path", str(d))
        fname = str(d / "radar.svg")
        echo = sim_do(sim, f"SCREENSHOT {fname}" if named else "SCREENSHOT")
        if not named:
            (fname,) = [str(d / n) for n in os.listdir(d)]
            assert os.path.basename(fname) == "radar_000008.0.svg"
        assert echo == [f"Radar snapshot written to {fname}"]
        with open(fname) as f:
            files.append(f.read())
    assert "AC1" in files[1] and "SECT" in files[1]
    assert_svg_close(files[1], files[0])
