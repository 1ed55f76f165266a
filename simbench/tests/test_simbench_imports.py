"""Nothing the benchmark runs loads the JAX side, and the reference
loads nothing of the program."""
import json
import os
import subprocess
import sys


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = ["jax", "jaxlib", "flax", "bluesky_tpu"]

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {simbench_parent!r})
{body}
tops = sorted({{m.split(".")[0] for m in list(sys.modules)}})
print(json.dumps(tops))
"""


def _tops(body, tmp_root=None):
    code = PROBE.format(root=ROOT, simbench_parent=ROOT, body=body)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_the_jax_side(tiny_root):
    body = f"""
import torch
torch.set_num_threads(2)
import argparse
from simbench import run, control, trace, drive, check
from simbench.tests import tiny
r = run.run(tiny.args(seed=9), device="cpu", require_card=False,
            root={tiny_root!r})
for name in ("edge_host_ms", "step_ms", "asas_interval_ms",
             "sort_refresh_ms", "cd_roofline", "device_idle_pct"):
    from simbench import cell
    cell.reader(name, {tiny_root!r})
assert r["correct"]
"""
    tops = _tops(body)
    assert "bluesky_tpu_torch" in tops and "simbench" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    body = """
from simbench import check, fleet
from simbench.reference import aero, cd, pairs, roofline, step
"""
    tops = _tops(body)
    assert "simbench" in tops and "torch" in tops
    assert "bluesky_tpu_torch" not in tops
    assert not tops & set(FORBIDDEN)
