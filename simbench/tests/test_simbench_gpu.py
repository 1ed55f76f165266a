"""On the card: one short run of each cell through the command, its
last line the contract's, and the control failing on the cell's own
size.  Run there with ``python -m pytest simbench/tests -m gpu``."""
import json
import subprocess
import sys

import pytest

from simbench import cell

ROOT = cell.ROOT


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cell.manifest()["workloads"]])
def test_command_runs_a_cell(workload):
    _card()
    out = subprocess.run(
        [sys.executable, "simbench/run.py", "--workload", workload,
         "--seed", "2147483711", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    names = {m["name"] for m in cell.manifest()["end_to_end"]}
    assert set(r["metrics"]) == names
    assert list(r)[-1] == "check"


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    _card()
    import argparse
    from simbench import control
    w = cell.manifest()["workloads"][-1]["name"]
    a = argparse.Namespace(workload=w, seeds=[5], seconds=2.0, faulted=1)
    (r,) = list(control.readings(a))
    assert r["correct"]
    assert not (r["control_correct"] or r["half_speed_correct"]
                or r["unchanged_correct"])
