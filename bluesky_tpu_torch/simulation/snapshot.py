"""In-memory state snapshots: the blob of the full state plus its host
bookkeeping, and the snapshot ring the integrity guard rolls back to.

Port of ``bluesky_tpu/simulation/snapshot.py``, its in-memory half:
``state_blob``, ``restore_blob`` and ``SnapshotRing``.  A blob holds
every ``SimState`` tensor as a NumPy array (``core/state.state_to_numpy``
layout, owned by the blob), the host slot tables (ids, types), per-slot
routes, pending conditions and enough sim config to resume (simdt, ASAS
config, cd backend).  Restore requires a Traffic with the same
nmax/wmax.  The on-disk snapshot files (``save``, ``load``,
``read_blob``, ``write_blob``) and the restore onto a device mesh are
not ported (ROADMAP A6b, A9).

``SnapshotRing`` is a bounded ring of periodic captures the integrity
guard (``fault/guard.py``) rolls back to when a chunk trips the in-chunk
finite check.  Ring rollback restores traffic/routes/config but keeps
stack/datalog state (``reset_traffic`` semantics, not the full
``reset``), so logs record the recovery instead of being truncated by
it.
"""
import collections
import time

import numpy as np

from ..core.state import state_from_numpy, state_to_numpy

FORMAT = 4
COMPAT_FORMATS = (2, 3, 4)      # blob formats restore_blob accepts


def state_blob(sim, state=None) -> dict:
    """Snapshot the complete simulation state as a host-side dict.

    ``state`` overrides the state to copy: the pipelined chunk loop
    passes the kept (not donated) post-chunk state so the copy runs
    while the next chunk is in flight.  Host tables (ids/routes/cond)
    are read live — the pipeline only defers edges with no host-table
    mutations, so they match the passed state."""
    traf = sim.traf
    if state is None:
        traf.flush()
        state = traf.state
    state_np = state_to_numpy(state)
    if state.device.type == "cpu":
        # state_to_numpy shares memory with CPU tensors, which later
        # chunks and stack edits write in place: the blob owns copies
        state_np = {k: np.array(v, copy=True) for k, v in state_np.items()}
    routes = {i: dict(name=list(r.name), lat=list(r.lat),
                      lon=list(r.lon), alt=list(r.alt),
                      spd=list(r.spd), wtype=list(r.wtype),
                      flyby=list(r.flyby), iactwp=r.iactwp)
              for i, r in sim.routes.routes.items()}
    return dict(
        format=FORMAT,
        nmax=traf.nmax, wmax=traf.wmax,
        state=state_np,
        ids=list(traf.ids), types=list(traf.types),
        autoid=traf._autoid,
        world="",
        shard=dict(mode="off", ndev=0, halo_blocks=0),   # one device
        cfg=dict(simdt=sim.cfg.simdt, cd_backend=sim.cfg.cd_backend,
                 asas=sim.cfg.asas._asdict()),
        dtmult=sim.dtmult,
        routes=routes,
        # pending ATALT/ATSPD conditions are traffic-scoped state: both
        # restore paths reset them, so they must ride the blob or a
        # rollback silently disarms every deferred command
        cond=dict(idx=np.asarray(sim.cond.idx),
                  condtype=np.asarray(sim.cond.condtype),
                  target=np.asarray(sim.cond.target),
                  lastdif=np.asarray(sim.cond.lastdif),
                  cmd=list(sim.cond.cmd)),
    )


def blob_simt(blob) -> float:
    """The sim time a blob was captured at."""
    return float(blob["state"]["simt"])


def restore_blob(sim, blob, full_reset: bool = True):
    """Restore a state blob into the running simulation.

    ``full_reset=False`` is the rollback path: only traffic-scoped state
    is cleared (``reset_traffic``), so datalog/stack state — and with it
    the record of the fault that triggered the rollback — survives the
    restore.
    """
    if blob.get("format") not in COMPAT_FORMATS:
        return False, "unsupported snapshot format"
    traf = sim.traf
    if blob["nmax"] != traf.nmax or blob["wmax"] != traf.wmax:
        return False, (f"snapshot is nmax={blob['nmax']}/"
                       f"wmax={blob['wmax']}; this sim is "
                       f"nmax={traf.nmax}/wmax={traf.wmax}")
    if full_reset:
        sim.reset()
    else:
        sim.reset_traffic()
    traf = sim.traf
    # Device state: the same layout (the same nmax and wmax, one device)
    traf.state = state_from_numpy(blob["state"], device=traf.device)
    traf.ids = list(blob["ids"])
    traf.types = list(blob["types"])
    traf._id2slot = {acid: i for i, acid in enumerate(traf.ids)
                     if acid is not None}
    traf._autoid = blob["autoid"]
    # Host route tables
    for i, r in blob.get("routes", {}).items():
        hr = sim.routes.route(int(i))
        hr.name = list(r["name"])
        hr.lat = list(r["lat"])
        hr.lon = list(r["lon"])
        hr.alt = list(r["alt"])
        hr.spd = list(r["spd"])
        hr.wtype = list(r["wtype"])
        hr.flyby = list(r["flyby"])
        hr.iactwp = r["iactwp"]
    # Pending conditional commands
    cond = blob.get("cond")
    if cond is not None:
        sim.cond.idx = np.asarray(cond["idx"], dtype=np.int64)
        sim.cond.condtype = np.asarray(cond["condtype"], dtype=np.int64)
        sim.cond.target = np.asarray(cond["target"], dtype=np.float64)
        sim.cond.lastdif = np.asarray(cond["lastdif"], dtype=np.float64)
        sim.cond.cmd = list(cond["cmd"])
    # Config
    from ..core.asas import AsasConfig
    cfg = blob["cfg"]
    sim.cfg = sim.cfg._replace(simdt=cfg["simdt"],
                               cd_backend=cfg["cd_backend"],
                               asas=AsasConfig(**cfg["asas"]))
    sim.dtmult = blob["dtmult"]
    return True, (f"restored: {traf.ntraf} aircraft "
                  f"at simt={sim.simt:.2f}")


class SnapshotRing:
    """Bounded in-memory ring of periodic state snapshots.

    ``maybe_capture`` is called by the sim at chunk edges and captures
    every ``dt`` seconds of sim time (depth * dt is the rollback
    horizon).  ``rollback`` restores the newest snapshot with
    traffic-scoped reset semantics and POPS it from the ring, so a fault
    that recurs immediately degrades to progressively older snapshots
    instead of looping on one restore point forever.
    """

    def __init__(self, depth: int = 4, dt: float = 30.0):
        self.depth = max(1, int(depth))
        self.dt = float(dt)
        self._ring = collections.deque(maxlen=self.depth)
        self.t_last = -float("inf")

    def __len__(self):
        return len(self._ring)

    @property
    def simts(self):
        """Sim times of the held snapshots, oldest first."""
        return [blob_simt(b) for b in self._ring]

    def capture(self, sim, state=None, simt=None):
        """Capture now.  ``state``/``simt`` let the pipelined loop hand
        in the kept post-chunk state and planned edge clock so the copy
        overlaps the in-flight chunk."""
        t0 = time.perf_counter()
        with sim.recorder.span("snapshot_capture", world="",
                               off_path=state is not None):
            self._ring.append(state_blob(sim, state=state))
        sim.obs.get("sim_snapshot_capture_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        self.t_last = sim.simt if simt is None else float(simt)

    def newest(self):
        """The most recent snapshot blob, or None."""
        return self._ring[-1] if self._ring else None

    def maybe_capture(self, sim):
        """Capture if ``dt`` sim seconds have passed since the last one."""
        if self.dt > 0 and sim.simt - self.t_last >= self.dt - 1e-9:
            self.capture(sim)

    def rollback(self, sim):
        """Restore (and consume) the newest snapshot; (ok, msg)."""
        if not self._ring:
            return False, "snapshot ring is empty"
        blob = self._ring.pop()
        ok, msg = restore_blob(sim, blob, full_reset=False)
        self.t_last = sim.simt
        return ok, msg

    def clear(self):
        self._ring.clear()
        self.t_last = -float("inf")
