"""The metric arithmetic: the rate over the whole window, the 95th
percentile over every chunk, the pair count against a brute force, the
trace reduction and the roofline's least time."""
import numpy as np
import pytest
import torch

from simbench import run, trace
from simbench.reference import pairs, roofline


def test_rate_counts_all_work_over_all_time():
    stamps = [0.1 * (k + 1) for k in range(10)]
    rate, p97, chunks, wall = run.window_metrics(stamps, 0.0, 1000, 20)
    assert chunks == 10 and wall == pytest.approx(1.0)
    assert rate == pytest.approx(1000 * 20 * 10 / 1.0)
    # a stall anywhere lengthens the window and lowers the rate
    slow = stamps[:4] + [s + 0.5 for s in stamps[4:]]
    assert run.window_metrics(slow, 0.0, 1000, 20)[0] < rate


def test_p97_covers_every_chunk_and_moves_with_one_stall():
    n = 40
    stamps = list(np.cumsum([0.1] * n))
    base = run.window_metrics(stamps, 0.0, 1, 1)[1]
    assert base == pytest.approx(100.0)
    for k in (0, 17, n - 1):        # the first gap is from the start
        gaps = [0.1] * n
        gaps[k] = 0.9
        p97 = run.window_metrics(list(np.cumsum(gaps)), 0.0, 1, 1)[1]
        assert p97 > 2 * base
        assert p97 == pytest.approx(
            run.quantile97([g * 1e3 for g in gaps]))


def _brute(cols, rpz, hpz, tl):
    lat, lon, alt, gs, vs = (cols[k].numpy() for k in ("lat", "lon", "alt",
                                                        "gs", "vs"))
    n = 0
    for i in range(lat.size):
        d = pairs.great_circle(torch.tensor(lat[i]), torch.tensor(lon[i]),
                               torch.tensor(lat), torch.tensor(lon),
                               6371000.0).numpy()
        hor = d <= rpz + (gs[i] + gs) * tl
        ver = np.abs(alt - alt[i]) <= hpz + np.maximum(
            np.abs(vs - vs[i]), 1e-6) * tl
        ok = hor & ver
        ok[i] = False
        n += int(ok.sum())
    return n


@pytest.mark.parametrize("spread", [0.3, 3.0, 60.0])
def test_pair_count_matches_brute_force(spread):
    rng = np.random.default_rng(3)
    n = 400
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    cols = dict(lat=t(rng.uniform(-spread, spread, n)),
                lon=t(rng.uniform(175.0 - spread, 175.0 + spread, n)),
                alt=t(rng.uniform(3000, 11000, n)),
                gs=t(rng.uniform(130, 240, n)),
                vs=t(np.where(rng.random(n) < 0.3, rng.normal(0, 5, n), 0)))
    cols["lon"] = torch.remainder(cols["lon"] + 180.0, 360.0) - 180.0
    active = torch.ones(n, dtype=torch.bool)
    got = pairs.count_needed(cols, active, 9260.0, 304.8, 300.0)
    assert got == _brute(cols, 9260.0, 304.8, 300.0) and got > 0


def test_trace_reduction():
    ev = [dict(ph="X", cat="user_annotation", name="w", ts=0, dur=100),
          dict(ph="X", cat="kernel", name="k1", ts=10, dur=20),
          dict(ph="X", cat="kernel", name="k2", ts=20, dur=20),
          dict(ph="X", cat="kernel", name="k1", ts=70, dur=10),
          dict(ph="X", cat="cuda_runtime", name="cudaEventSynchronize",
               ts=40, dur=25)]
    r = trace.reduce_trace(ev, "w")
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)
    assert r["device_s"] == pytest.approx(50e-6)
    assert r["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    assert r["idle_gaps"][0] == ["cudaEventSynchronize", pytest.approx(30e-6)]
    assert [g[1] for g in r["idle_gaps"]] == pytest.approx(
        [30e-6, 20e-6, 10e-6])


def test_roofline_least_time():
    t, bound = roofline.least_seconds(10 ** 9, 1000, 8)
    assert bound == "operations"
    assert t == pytest.approx(1e9 * 168 / 67e12)
    t, bound = roofline.least_seconds(0, 10 ** 6, 8)
    assert bound == "bytes"
    assert t == pytest.approx(roofline.interval_bytes(10 ** 6, 8) / 3.35e12)
