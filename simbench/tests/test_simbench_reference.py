"""The plain reference against the port on the CPU at a small size."""
import numpy as np
import pytest
import torch

from simbench import drive, fleet, run
from simbench.reference import cd as refcd, step as refstep
from simbench.tests import tiny


@pytest.mark.parametrize("sample", [drive.CHECK_SAMPLE, 256])
def test_tiny_cell_is_correct(tiny_root, monkeypatch, sample):
    # 4096 compares every aircraft of the tiny fleet, 256 a sample of it
    monkeypatch.setattr(drive, "CHECK_SAMPLE", sample)
    r = run.run(tiny.args(seed=2 ** 31 + 77), device="cpu",
                require_card=False, root=tiny_root)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert list(r)[-1] == "check"


def test_detection_matches_the_ports_dense_detect():
    from bluesky_tpu_torch.ops import cd as portcd
    cfgs = dict(rpz=9260.0, hpz=304.8, dtlookahead=300.0, resofach=1.05,
                resofacv=1.05)
    c = fleet.draw(dict(n_aircraft=300, geometry="circle", center=[52.6, 5.4],
                        radius_deg=0.4, lon_scale=0.6, alt_m=[3000, 11000],
                        cas_mps=[130, 240], hdg_deg=[0, 360]), 11)
    s = refstep.initial(c)
    n = s["lat"].numel()
    s.update(vs=torch.zeros(n, dtype=torch.float64),
             active=torch.ones(n, dtype=torch.bool),
             noreso=torch.zeros(n, dtype=torch.bool))
    d = refcd.detect(s, torch.arange(n), cfgs)
    port = portcd.detect(s["lat"], s["lon"], s["trk"], s["gs"], s["alt"],
                         s["vs"], s["active"], 9260.0, 304.8, 300.0)
    want = port.swconfl.sum(1).numpy()
    got = d["nconf"].numpy()
    diff = np.abs(got - want)
    assert got.sum() > 100
    assert np.all(diff <= d["unsure"].numpy())
    assert int((diff > 0).sum()) <= 3
