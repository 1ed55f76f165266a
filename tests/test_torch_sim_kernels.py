"""The port's ``Simulation`` on the CD backends of the kernels (sparse,
pallas) against the JAX package's, on the CPU: the JAX Pallas kernels in
interpret mode, the port's through their plain PyTorch versions.

* SUPER 8 with ASAS ON for 10 s (one-second chunks, wall-clock pacing
  off) under each resolver with CDMETHOD SPARSE and PALLAS: callsigns,
  echo, configuration, flags, counts and partner sets equal; floats at
  the float32 bounds of ``tests/test_torch_slice.py`` (the kernels run
  in float32 in both packages).  Under EBY the JAX kernels evaluate the
  Eby pair in float32 and, on this exactly symmetric geometry, turn the
  fleet the mirror way from JAX's own dense and tiled backends (ROADMAP
  §C); the port's kernels evaluate it in float64, so the port is held
  against JAX's dense EBY run, which its dense and tiled runs equal.
* CDMETHOD switched on a live state (30 random aircraft), DENSE ->
  SPARSE -> PALLAS -> DENSE, a few seconds each: the sorted layout and
  partner tables are reset and refreshed, and every step stays JAX's.
"""
import pytest

from torch_parity import (assert_sim_states, assert_sims_equal, no_pacing,
                          sim_do, sim_pair)

SUPER8 = ("SYN SUPER 8", "ASAS ON")


@pytest.fixture(autouse=True)
def _no_pacing(monkeypatch):
    no_pacing(monkeypatch)


def run_pair(lines, seconds, pair=None, only=None):
    """``lines`` into both simulations (or the ``only`` one, 0 for JAX's
    and 1 for the port's), then one-second runs up to ``seconds``;
    returns the pair and their echo."""
    pair = pair or sim_pair()
    jsim, tsim = pair
    echo = []
    for sim in (pair if only is None else pair[only:only + 1]):
        out = sim_do(sim, *lines)
        t0 = int(round(sim.simt))
        for t in range(t0 + 1, t0 + seconds + 1):
            sim.run(until_simt=float(t))
        echo.append(out + sim.scr.echobuf)
        sim.scr.echobuf.clear()
    return jsim, tsim, echo


@pytest.mark.parametrize("cd", ["SPARSE", "PALLAS"])
@pytest.mark.parametrize("reso", ["MVP", "EBY", "SWARM", "SSD"])
def test_super8(reso, cd):
    lines = SUPER8 + (f"RESO {reso}", f"CDMETHOD {cd}")
    if reso != "EBY":
        jsim, tsim, (je, te) = run_pair(lines, 10)
        assert_sims_equal(jsim, tsim, je, te, f32_cd=True)
        return
    # the float64 witness: JAX's dense EBY (its tiled run is equal)
    jsim, _, _ = run_pair(SUPER8 + ("RESO EBY", "CDMETHOD DENSE"), 10,
                          only=0)
    _, tsim, _ = run_pair(lines, 10, only=1)
    assert tsim.traf.ids == jsim.traf.ids
    assert_sim_states(jsim, tsim, f32_cd=True, skip=(
        "asas.resopairs", "asas.partners", "asas.partners_s",
        "asas.sort_perm"))


def test_cdmethod_on_a_live_state():
    """30 random aircraft (MCRE: random altitudes, so no co-altitude
    mirror pairs and no vertical knife edge) in a 0.67 deg box, the CD
    backend switched under them."""
    pair = sim_pair()
    fleet = ("PAN 52 4", "ZOOM 3", "MCRE 30", "ASAS ON")
    for lines, seconds in ((fleet, 2), (("CDMETHOD SPARSE",), 3),
                           (("CDMETHOD PALLAS",), 3),
                           (("CDMETHOD DENSE",), 2)):
        jsim, tsim, (je, te) = run_pair(lines, seconds, pair)
        assert_sims_equal(jsim, tsim, je, te, f32_cd=True)
        assert int(tsim.traf.state.asas.nconf_cur) > 0
    assert tsim.simt == jsim.simt and round(tsim.simt) == 10
