"""Snapshot files, autosave and preemption of the port's ``Simulation``
(``simulation/snapshot.py``), on the CPU, mirroring the JAX package's
``tests/test_durability.py`` (``TestSnapshotV3``, ``TestPreempt``):

* format v4: bit-exact resume (N steps == N/2 + save/load + N/2),
  torn-write and bit-flip rejection by the sha256 digest, v2 back-compat
  (tagged unverified, counted and recorded), a failed save is a command
  error, a failed re-save leaves the previous file whole, and the
  autosave knob;
* preemption: the run drains, writes a checksummed checkpoint that
  restores bit-exactly and pauses; RESET clears a stale notice; a
  notice raised from another thread (a signal handler's) while ``run``
  is going stops it at the next chunk edge.  The JAX tests raise these
  through FAULT PREEMPT and FAULT SNAPTRUNC, which the port does not
  have yet (ROADMAP A10): here the test calls ``request_preempt`` and
  truncates the file itself;
* partner tables K = 16 wide survive a save and load, and the resumed
  run stays bit-exact;
* ``WorldBatch.handle_preempt`` writes each active world's tagged file;
* across the packages: the port restores a JAX v4 file bit for bit, and
  JAX's ``load`` of a port file raises ``ValueError`` in its
  ``restore_blob`` (ROADMAP §C).
"""
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.simulation import snapshot
from bluesky_tpu_torch.simulation.sim import HOLD, Simulation

from torch_parity import jax_tree_to_numpy, no_pacing, scene, sim_do as do


@pytest.fixture(autouse=True)
def _no_pacing(monkeypatch):
    no_pacing(monkeypatch)


@pytest.fixture()
def sim():
    return Simulation(nmax=16, dtype=torch.float64, device="cpu")


def _other():
    return Simulation(nmax=16, dtype=torch.float64, device="cpu")


def _fleet(sim):
    """Three aircraft, one with a route leg and an armed ATALT: every
    kind of state the blob must carry (tensors, ids, routes, pending
    conditionals)."""
    for i in range(3):
        do(sim, f"CRE KL{i} B744 {52 + i} {4 + i} 90 FL{200 + 10 * i} 250")
    do(sim, "ADDWPT KL0 52.5 4.5", "ALT KL1 FL300",
       "KL1 ATALT FL250 ECHO reached")
    sim.op()
    sim.fastforward()


def _go(sim, until):
    sim.op()
    sim.fastforward()
    sim.run(until_simt=until)


def _assert_state_equal(a, b):
    """Bit-exact equality of the full restorable state."""
    sa, sb = state_to_numpy(a.traf.state), state_to_numpy(b.traf.state)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert a.traf.ids == b.traf.ids
    assert a.traf.types == b.traf.types
    ra, rb = a.routes.routes, b.routes.routes
    assert {i for i, r in ra.items() if r.nwp} \
        == {i for i, r in rb.items() if r.nwp}
    for i, r in ra.items():
        if r.nwp:
            for f in ("name", "lat", "lon", "alt", "spd", "wtype", "flyby",
                      "iactwp"):
                assert getattr(r, f) == getattr(rb[i], f), f"route[{i}].{f}"
    np.testing.assert_array_equal(a.cond.idx, b.cond.idx)
    np.testing.assert_array_equal(a.cond.target, b.cond.target)
    assert a.cond.cmd == b.cond.cmd


# ------------------------------------------------------------ format v4
def test_bit_exact_resume(sim, tmp_path):
    """N steps == N/2 steps + save/load + N/2 steps, to the bit."""
    fname = str(tmp_path / "half.snap")
    _fleet(sim)
    sim.run(until_simt=2.0)
    assert "written" in " ".join(do(sim, f"SNAPSHOT SAVE {fname}"))
    assert snapshot.peek_shard(fname) == (
        dict(mode="off", ndev=0, halo_blocks=0), None)
    _go(sim, 4.0)
    other = _other()
    ok, msg = snapshot.load(other, fname)
    assert ok, msg
    assert abs(other.simt - 2.0) < 1e-9
    _go(other, 4.0)
    assert other.simt == sim.simt
    _assert_state_equal(sim, other)


def test_torn_write_detected_by_checksum(sim, tmp_path):
    """A file cut to 90 % (a torn write) fails the sha256 check on load;
    the sim keeps stepping."""
    fname = tmp_path / "torn.snap"
    _fleet(sim)
    do(sim, f"SNAPSHOT SAVE {fname}")
    raw = fname.read_bytes()
    fname.write_bytes(raw[:int(len(raw) * 0.9)])
    assert "corrupt or truncated" in " ".join(
        do(sim, f"SNAPSHOT LOAD {fname}"))
    _go(sim, sim.simt + 1.0)
    assert sim.traf.ntraf == 3


def test_bitflip_rejected(sim, tmp_path):
    """A single flipped payload bit still unpickles; only the digest
    catches it, and the load refuses it."""
    fname = tmp_path / "flip.snap"
    _fleet(sim)
    do(sim, f"SNAPSHOT SAVE {fname}")
    raw = bytearray(fname.read_bytes())
    raw[-1] ^= 0x01
    fname.write_bytes(bytes(raw))
    assert "checksum mismatch" in " ".join(do(sim, f"SNAPSHOT LOAD {fname}"))


def test_v2_plain_pickle_backcompat(sim, tmp_path):
    """A blob saved as a bare pickle (format 2) keeps loading, tagged
    unverified: counted and recorded in the trace."""
    fname = str(tmp_path / "old.snap")
    _fleet(sim)
    blob = snapshot.state_blob(sim)
    blob["format"] = 2
    with open(fname, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
    assert snapshot.peek_shard(fname) == (None, None)
    other = _other()
    other.recorder.enable()
    ok, msg = snapshot.load(other, fname)
    assert ok, msg
    assert "UNVERIFIED" in msg
    assert other.traf.ids[:3] == ["KL0", "KL1", "KL2"]
    assert other.obs.get("snapshot_unverified").value == 1
    assert any(e["name"] == "snapshot_unverified"
               for e in other.recorder._ring)


def test_save_oserror_degrades_to_command_error(sim, tmp_path):
    """A bad path on SNAPSHOT SAVE is a command error, never an exception
    out of the stack."""
    _fleet(sim)
    out = " ".join(do(sim, f"SNAPSHOT SAVE {tmp_path}/no/such/dir/x.snap"))
    assert "SNAPSHOT SAVE" in out
    assert "failed:" not in out          # the stack's exception fallback
    _go(sim, sim.simt + 1.0)


def test_failed_resave_preserves_previous_file(sim, tmp_path, monkeypatch):
    """A save that dies mid-write (fsync raises: a full disk) leaves the
    previous good snapshot under the final name and no tmp file."""
    fname = str(tmp_path / "keep.snap")
    _fleet(sim)
    do(sim, f"SNAPSHOT SAVE {fname}")
    do(sim, "DEL KL2")

    def no_disk(fd):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(snapshot.os, "fsync", no_disk)
    out = " ".join(do(sim, f"SNAPSHOT SAVE {fname}"))
    assert "SNAPSHOT SAVE" in out and "No space left" in out
    monkeypatch.undo()
    no_pacing(monkeypatch)
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    other = _other()
    ok, msg = snapshot.load(other, fname)
    assert ok, msg
    assert other.traf.ntraf == 3


def test_autosnapshot_knob(sim, tmp_path, monkeypatch):
    """``snapshot_autosave_dt`` (off by default) persists a checkpoint
    periodically with the atomic writer."""
    from bluesky_tpu_torch import settings
    fname = str(tmp_path / "auto.snap")
    monkeypatch.setattr(settings, "snapshot_autosave_path", fname)
    assert sim.autosave_dt == 0.0
    sim.autosave_dt = 0.5
    _fleet(sim)
    sim.run(until_simt=2.0)
    assert os.path.isfile(fname)
    blob, err = snapshot.read_blob(fname)
    assert err is None and blob["format"] == snapshot.FORMAT
    assert snapshot.blob_simt(blob) >= 1.5
    other = _other()
    ok, msg = snapshot.load(other, fname)
    assert ok, msg
    assert other.traf.ntraf == 3
    sim.reset()
    assert sim._autosave_t == -float("inf")


# ------------------------------------------------------------ preemption
def test_embedded_preempt_checkpoints_and_resumes_bit_exact(
        sim, tmp_path, monkeypatch):
    """A preemption notice: the run drains the chunk, writes a valid
    checksummed checkpoint and pauses; the checkpoint restores
    bit-exactly and resumes."""
    from bluesky_tpu_torch import settings
    monkeypatch.setattr(settings, "preempt_snapshot_dir", str(tmp_path))
    _fleet(sim)
    sim.run(until_simt=1.0)
    assert sim.request_preempt() and sim.preempt_requested
    _go(sim, 60.0)                       # preempts long before 60 s
    assert sim.state_flag == HOLD and not sim.preempt_requested
    assert sim.simt < 59.0
    path = os.path.join(str(tmp_path), "preempt-sim.snap")
    assert any(path in e for e in sim.scr.echobuf)
    blob, err = snapshot.read_blob(path)
    assert err is None and blob["format"] == snapshot.FORMAT
    assert blob["world"] == ""
    other = _other()
    ok, msg = snapshot.load(other, path)
    assert ok, msg
    _assert_state_equal(sim, other)
    _go(other, other.simt + 1.0)
    assert other.simt > sim.simt


def test_reset_clears_stale_preempt_flag(sim):
    """A notice raised before a RESET must not fire into the fresh sim."""
    _fleet(sim)
    sim.request_preempt()
    assert sim.preempt_requested
    sim.reset()
    assert not sim.preempt_requested


def test_preempt_from_another_thread_stops_the_run(sim, tmp_path,
                                                  monkeypatch):
    """A notice raised from another thread 0.2 s into a long run (as a
    signal handler raises it) stops ``run`` at the next chunk edge with
    the checkpoint written."""
    from bluesky_tpu_torch import settings
    monkeypatch.setattr(settings, "preempt_snapshot_dir", str(tmp_path))
    _fleet(sim)
    timer = threading.Timer(0.2, sim.request_preempt)
    timer.start()
    try:
        _go(sim, 3600.0)
    finally:
        timer.cancel()
    assert sim.state_flag == HOLD and sim.simt < 3600.0
    blob, err = snapshot.read_blob(str(tmp_path / "preempt-sim.snap"))
    assert err is None and snapshot.blob_simt(blob) == sim.simt


# ------------------------------------------- partner width, worlds, JAX
def _wide_sim(kk=16):
    """A ``Simulation`` whose Traffic has no [N, N] ``resopairs`` and
    partner tables ``kk`` wide, 200 aircraft of the clump at one altitude
    in 256 slots, the sparse backend."""
    s = Simulation(nmax=256, device="cpu")
    s.traf.pair_matrix = False
    s.traf.k_partners = kk
    s.reset()
    return s


def test_k16_state_round_trip(tmp_path):
    """A K = 16 state (more than 8 partners in some rows) saved and
    loaded into another such sim is bit for bit the same, and both runs
    stay equal one more second."""
    sim = _wide_sim()
    lat, lon, hdg, alt, spd = scene(200, "clump", 3)
    sim.traf.create(200, "B744", np.full_like(alt, 9500.0), spd, None,
                    lat, lon, hdg)
    sim.traf.flush()
    do(sim, "CDMETHOD SPARSE", "ASAS ON")
    _go(sim, 1.5)
    table = state_to_numpy(sim.traf.state)["asas.partners_s"]
    assert table.shape[1] == 16 and ((table >= 0).sum(1) > 8).sum() > 50
    fname = str(tmp_path / "k16.snap")
    snapshot.save(sim, fname)
    other = _wide_sim()
    ok, msg = snapshot.load(other, fname)
    assert ok, msg
    _assert_state_equal(sim, other)
    assert other.cfg.cd_backend == "sparse"
    _go(sim, 2.5)
    _go(other, 2.5)
    _assert_state_equal(sim, other)


def test_worldbatch_preempt_writes_tagged_files(tmp_path, monkeypatch):
    """``WorldBatch.handle_preempt`` checkpoints each active world to
    ``preempt-<host>-<world>.snap``, its blob tagged with the world, and
    reports the finished world as done."""
    from bluesky_tpu_torch import settings
    from bluesky_tpu_torch.simulation.worlds import WorldBatch
    monkeypatch.setattr(settings, "preempt_snapshot_dir", str(tmp_path))
    pieces = [([0.0] * 2, [f"CRE W{i} B744 52 {4 + i} 90 FL200 250",
                           "FF 600"]) for i in range(3)]
    pieces[1] = ([0.0, 0.0, 1.0], ["CRE W1 B744 52 5 90 FL200 250",
                                   "FF 600", "HOLD"])
    wb = WorldBatch(pieces, simkw=dict(nmax=16, device="cpu"),
                    host_tag="node7")
    for _ in range(4):
        wb.step()
    info = wb.handle_preempt()
    assert info["done"] == [1]
    names = sorted(os.path.basename(p) for p in info["checkpoints"])
    assert names == ["preempt-node7-w00.snap", "preempt-node7-w02.snap"]
    assert "errors" not in info
    for i in (0, 2):
        blob, err = snapshot.read_blob(
            str(tmp_path / f"preempt-node7-w{i:02d}.snap"))
        assert err is None and blob["world"] == f"w{i:02d}"
        assert blob["ids"][0] == f"W{i}"
        assert wb.sims[i].state_flag == HOLD


@pytest.fixture(scope="module")
def jax_sim():
    """One small JAX ``Simulation`` (float64) with the three aircraft of
    ``_fleet``, run 1 s."""
    import time
    from bluesky_tpu.simulation.sim import Simulation as JSim
    sleep, time.sleep = time.sleep, lambda s: None
    try:
        js = JSim(nmax=16, dtype=jnp.float64)
        _fleet(js)
        js.run(until_simt=1.0)
    finally:
        time.sleep = sleep
    return js


def test_port_loads_a_jax_file(jax_sim, tmp_path):
    """A JAX v4 file restores into the port bit for bit: every state
    array, the ids, routes, conditionals and the sim time."""
    from bluesky_tpu.simulation import snapshot as jsnap
    fname = str(tmp_path / "jax.snap")
    jsnap.save(jax_sim, fname)
    t = _other()
    ok, msg = snapshot.load(t, fname)
    assert ok, msg
    want = jax_tree_to_numpy(jax_sim.traf.state)
    got = state_to_numpy(t.traf.state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert t.traf.ids == jax_sim.traf.ids
    assert t.simt == jax_sim.simt
    assert t.routes.routes[0].name == jax_sim.routes.routes[0].name
    assert t.cond.cmd == jax_sim.cond.cmd


def test_jax_load_of_a_port_file_raises(tmp_path):
    """JAX reads a port file's header and blob, but its ``restore_blob``
    tree-maps the blob onto its own ``SimState`` and raises ``ValueError``
    on the port's flat state dict (ROADMAP §C)."""
    from bluesky_tpu.simulation import snapshot as jsnap
    fname = str(tmp_path / "port.snap")
    from bluesky_tpu.simulation.sim import Simulation as JSim
    sim = _other()
    _fleet(sim)
    snapshot.save(sim, fname)
    blob, err = jsnap.read_blob(fname)
    assert err is None and isinstance(blob["state"], dict)
    with pytest.raises(ValueError, match="node type mismatch"):
        jsnap.load(JSim(nmax=16, dtype=jnp.float64), fname)
    with jax.default_device(jax.devices("cpu")[0]):
        assert jsnap.peek_shard(fname) == (
            dict(mode="off", ndev=0, halo_blocks=0), None)
