"""``correct`` comes out false when the timed path is broken underneath
a run (the look for a card skipped, the rest of the run driven as the
benchmark drives it), and when the control (the reference in bfloat16)
or a fault (``control.py``) stands in the program's place."""
import pytest
import torch

from simbench import control, run
from simbench.tests import tiny


def _run(root):
    r = run.run(tiny.args(seed=41), device="cpu", require_card=False,
                root=root)
    return r["correct"], {k: v["value"] for k, v in r["check"].items()}


def test_sound_run_is_correct(tiny_root):
    ok, nums = _run(tiny_root)
    assert ok, nums


def test_step_that_returns_its_state_unchanged(tiny_root, monkeypatch):
    from bluesky_tpu_torch.core import step as stepmod
    monkeypatch.setattr(stepmod, "_tail",
                        lambda state, cfg, simdt, gen, wn, we: state)
    ok, nums = _run(tiny_root)
    assert not ok and nums["pos_gap_m"] > 100.0
    assert nums["first_pos_gap_m"] > 100.0


def test_position_update_at_half_speed(tiny_root, monkeypatch):
    from bluesky_tpu_torch.core import kinematics
    orig = kinematics.update_position
    monkeypatch.setattr(kinematics, "update_position",
                        lambda ac, pilot, simdt: orig(ac, pilot, 0.5 * simdt))
    ok, nums = _run(tiny_root)
    assert not ok and nums["pos_gap_m"] > 50.0
    assert nums["first_pos_gap_m"] > 50.0


def test_half_of_the_fleet_left_out_of_detection(tiny_root, monkeypatch):
    from bluesky_tpu_torch.core import asas
    orig = asas.update_tiled

    def half(state, cfg, *a, **kw):
        ac = state.ac
        keep = torch.arange(ac.active.shape[0]) % 2 == 0
        sub = state.replace(ac=ac.replace(active=ac.active & keep))
        new, rd = orig(sub, cfg, *a, **kw)
        return new.replace(ac=ac), rd
    monkeypatch.setattr(asas, "update_tiled", half)
    ok, nums = _run(tiny_root)
    assert not ok and nums["conf_total_miss"] > 0


def test_an_answer_altered_where_it_is_produced(tiny_root, monkeypatch):
    from bluesky_tpu_torch.core import step as stepmod
    orig = stepmod._run_chunk

    def altered(*a, **kw):
        state, carry, simt, rp = orig(*a, **kw)
        state.ac.alt[3] += 10.0
        return state, carry, simt, rp
    monkeypatch.setattr(stepmod, "_run_chunk", altered)
    ok, nums = _run(tiny_root)
    assert not ok and nums["alt_gap_m"] >= 10.0


@pytest.mark.parametrize("seed", [3, 4])
def test_control_and_faults_fail(tiny_root, seed):
    import argparse
    a = argparse.Namespace(workload=tiny.CELL, seeds=[seed], seconds=1.0,
                           faulted=1)
    (r,) = list(control.readings(a, device="cpu", root=tiny_root,
                                 require_card=False))
    from simbench import cell
    limits = cell.load(tiny.CELL, tiny_root).limits
    assert r["correct"]
    assert not (r["control_correct"] or r["half_speed_correct"]
                or r["unchanged_correct"])
    failed = [k for k, v in r["control"].items() if v > limits[k]]
    assert len(failed) >= 3, r["control"]
    assert r["half_speed"]["pos_gap_m"] > limits["pos_gap_m"]
    assert r["unchanged"]["first_pos_gap_m"] > limits["first_pos_gap_m"]
