"""The port's SO6 converter (``bluesky_tpu_torch/utils/so6.py``) against
the JAX package's (``bluesky_tpu/utils/so6.py``) on the same inputs.

* ``convert`` gives the same list of scenario lines, string for string,
  on ``scenario/sample.so6``, on the strings of ``tests/test_so6.py``
  (the midnight rollover among them) and on a file with a repeated
  callsign, with and without ``rel_time``;
* ``parse_so6`` gives the same flights and segments;
* ``python -m bluesky_tpu_torch.utils.so6`` writes the same file as the
  JAX converter's ``main``, and that file loads through the port's
  ``IC`` and creates every flight.
"""
import os
import subprocess
import sys

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from bluesky_tpu.utils import so6 as jso6
from bluesky_tpu_torch.utils import so6 as tso6

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "scenario", "sample.so6")

# the two flights of tests/test_so6.py
SO6 = """\
SEG1 EHAM EGLL B744 100000 100500 200 240 0 KL101 250731 250731 3138.6 285.6 3132.0 270.0 12345 1 45.0
SEG2 EHAM EGLL B744 100500 101200 240 240 0 KL101 250731 250731 3132.0 270.0 3120.0 240.0 12345 2 60.0
SEG3 LFPG EDDF A320 100200 100800 180 220 0 AF202 250731 250731 2940.6 153.0 2952.0 180.0 67890 1 50.0
"""
# the midnight rollover of tests/test_so6.py
NIGHT = (
    "S1 A B B744 235000 235900 200 200 0 NITE1 250731 250731 "
    "3138.6 285.6 3132.0 270.0 1 1 45.0\n"
    "S2 A B B744 000500 001200 200 200 0 NITE1 250731 250801 "
    "3132.0 270.0 3120.0 240.0 1 2 60.0\n")
# a callsign flying twice (two flight ids), a zero-length segment, a
# malformed line and a comment
REPEAT = SO6 + (
    "SEG4 EHAM EGLL B744 120000 120600 240 240 0 KL101 250731 250731 "
    "3138.6 285.6 3130.0 260.0 99 1 0.0\n"
    "garbage line\n"
    "# a comment\n")


def _sample_lines():
    with open(SAMPLE) as f:
        return f.readlines()


CASES = {"sample": _sample_lines, "two_flights": SO6.splitlines,
         "midnight": NIGHT.splitlines, "repeat": REPEAT.splitlines}


@pytest.mark.parametrize("rel_time", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_matches_jax(case, rel_time):
    lines = CASES[case]()
    want = jso6.convert(lines, rel_time=rel_time)
    got = tso6.convert(lines, rel_time=rel_time)
    assert got == want
    assert any(">CRE " in line for line in got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_matches_jax(case):
    lines = CASES[case]()
    want = jso6.parse_so6(lines)
    got = tso6.parse_so6(lines)
    assert list(got) == list(want)
    for key, fl in want.items():
        assert (got[key].actype, got[key].t0, got[key].segs) \
            == (fl.actype, fl.t0, fl.segs), key


def test_cli_writes_jax_file_and_ic_loads_it(tmp_path, monkeypatch):
    """The module entry point writes JAX's lines; IC of the result on a
    CPU Simulation creates every flight of the file (the last one 180 s
    after the first) by 200 sim-s."""
    src = tmp_path / "sample.so6"
    src.write_text(open(SAMPLE).read())
    jdst = tmp_path / "jax.scn"
    assert jso6.main([str(src), str(jdst)]) == 0
    tdst = tmp_path / "port.scn"
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "bluesky_tpu_torch.utils.so6", str(src),
         str(tdst)], capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "3 flights" in res.stdout
    assert tdst.read_text() == jdst.read_text()

    from torch_parity import no_pacing
    from bluesky_tpu_torch.simulation.sim import Simulation
    no_pacing(monkeypatch)
    sim = Simulation(nmax=16, dtype=torch.float64, device="cpu")
    sim.stack.stack(f"IC {tdst}")
    sim.stack.process()
    sim.stack.stack("OP; FF 200")
    sim.stack.process()
    sim.run(until_simt=200.0)
    flights = {line.split()[1] for line in tdst.read_text().splitlines()
               if ">CRE " in line}
    assert flights == {"KL101", "AF202", "LH303"}
    assert {i for i in sim.traf.ids if i} == flights
