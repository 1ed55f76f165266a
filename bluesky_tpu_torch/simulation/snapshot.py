"""State snapshots: the blob of the full state plus its host
bookkeeping, the snapshot files of SNAPSHOT SAVE/LOAD, autosave and
preemption, and the snapshot ring the integrity guard rolls back to.

Port of ``bluesky_tpu/simulation/snapshot.py``.  A blob holds every
``SimState`` tensor as a NumPy array (``core/state.state_to_numpy``
layout, ``{dotted.path: ndarray}``, owned by the blob), the host slot
tables (ids, types), per-slot routes, pending conditions, the world tag
of a packed world, the capturing shard layout (one device: mode
``off``) and enough sim config to resume (simdt, ASAS config, cd
backend).  Restore requires a Traffic with the same nmax/wmax; the
partner tables keep the width the blob carries.  A blob of the live
state also carries the spatial sort's clock (``sort``: the sim time of
the last refresh and the backend it sorted for), so a restored sparse,
pallas or tiled run keeps the captured layout until its next due
refresh and resumes bit for bit; JAX's blob has no such key, and a
restore without it re-sorts at the next chunk, as JAX does.  A restore
onto another shard layout restarts the sorted-space caches; the
mesh-epoch recovery (``Simulation._handle_mesh_lost``) restores the
ring's newest blob onto the surviving shards that way.

On-disk format v4, as the JAX package writes it:

    BSTPUSNAP4\\n <sha256-hex>\\n <shard-layout json>\\n <pickled blob>

written atomically — tmp file in the same directory, flush + fsync,
``os.replace`` onto the final name — so a crash mid-save leaves at most
a stale tmp file, never a torn file under the final name.  ``load``
verifies the digest before unpickling, so a torn or bit-flipped file is
a command error, never a restore.  v3 files (digest, no shard line) and
plain-pickle v2 files keep loading; a v2 load is tagged ``unverified``,
counted and recorded in the trace.

Across the two packages: the JAX package pickles its state as its own
``bluesky_tpu.core.state`` classes, the port as the flat dict.  Files
are unpickled by ``_Unpickler``, which admits NumPy's array classes and
maps any ``bluesky_tpu`` class to a stand-in that only collects its
fields, never importing the JAX package; the collected tree is
flattened to the flat dict, so the port loads JAX's v2-v4 files.  JAX's
``load`` of a port file fails in its ``restore_blob``, which tree-maps
the blob onto its own ``SimState`` (ROADMAP §C).

``SnapshotRing`` is a bounded ring of periodic captures the integrity
guard (``fault/guard.py``) rolls back to when a chunk trips the in-chunk
finite check.  Ring rollback restores traffic/routes/config but keeps
stack/datalog state (``reset_traffic`` semantics, not the full
``reset``), so logs record the recovery instead of being truncated by
it.
"""
import collections
import hashlib
import io
import json
import os
import pickle
import time

import numpy as np
import torch

from ..core.state import (SORT_PAD, _tree_map, state_from_numpy,
                          state_to_numpy)

FORMAT = 4
COMPAT_FORMATS = (2, 3, 4)      # blob formats restore_blob accepts
MAGIC3 = b"BSTPUSNAP3\n"        # v3 file header (v2 = bare pickle)
MAGIC4 = b"BSTPUSNAP4\n"        # v4: + shard-layout header line


def shard_meta(sim) -> dict:
    """The sim's shard layout as plain-JSON metadata (it rides every blob
    and the v4 file header), so a restore onto another shard count or
    mode is detected without unpickling: mode, shards, halo blocks and,
    in the tiles mode, the tile shape and pinned budgets."""
    mesh = getattr(sim, "shard_mesh", None)
    cfg = getattr(sim, "cfg", None)
    meta = dict(mode=str(getattr(sim, "shard_mode", "off")),
                ndev=int(mesh.devices.size) if mesh is not None else 0,
                halo_blocks=int(getattr(cfg, "cd_halo_blocks", 0) or 0))
    if meta["mode"] == "tiles":
        meta["tiles"] = [int(t) for t in
                         tuple(getattr(cfg, "cd_tile_shape", ()) or ())]
        meta["tile_budgets"] = [int(b) for b in
                                getattr(cfg, "cd_tile_budgets", ())]
    return meta


def state_blob(sim, state=None) -> dict:
    """Snapshot the complete simulation state as a host-side dict.

    ``state`` overrides the state to copy: the pipelined chunk loop
    passes the kept (not donated) post-chunk state so the copy runs
    while the next chunk is in flight.  Host tables (ids/routes/cond)
    are read live — the pipeline only defers edges with no host-table
    mutations, so they match the passed state."""
    traf = sim.traf
    live = state is None
    if live:
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
    blob = dict(
        format=FORMAT,
        nmax=traf.nmax, wmax=traf.wmax,
        state=state_np,
        ids=list(traf.ids), types=list(traf.types),
        autoid=traf._autoid,
        # which world of a packed batch this blob captured (empty for a
        # standalone sim): the per-world preemption checkpoints carry it
        world=sim.world_tag,
        shard=shard_meta(sim),
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
    if live:
        # the sort clock belongs to the live state only: a pipelined
        # capture's state predates the refresh of the chunk in flight
        blob["sort"] = dict(simt=float(sim._sort_simt),
                            backend=sim._sort_backend)
    return blob


def _like(name, new, old):
    """``new`` in the dtype of ``old``: tensors cast, host clocks as
    ``old``'s NumPy scalar type; the rng seed as it is."""
    if isinstance(new, torch.Tensor):
        return new if new.dtype == old.dtype else new.to(old.dtype)
    if isinstance(old, np.generic):
        return type(old)(new)
    return new


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
    # Device state: the same nmax and wmax, one device; each leaf in the
    # running state's dtype (as JAX re-uploads with the current dtypes)
    old = traf.state
    traf.state = _tree_map(_like, state_from_numpy(blob["state"],
                                                   device=traf.device), old)
    # The sorted-space caches are keyed to the capturing layout: a blob
    # whose partner table is not the running mode's size, or that another
    # shard layout captured, restarts them from the identity sort and an
    # empty table of the running mode's size (JAX snapshot.py:156-200).
    asas = traf.state.asas
    bshard = blob.get("shard")
    cur = shard_meta(sim)
    n_exp = traf.nmax + SORT_PAD
    if cur["mode"] in ("spatial", "tiles") \
            and getattr(sim, "shard_mesh", None) is not None:
        from ..core.asas import spatial_table_size
        n_exp = spatial_table_size(traf.nmax, min(sim.cfg.cd_block, 256),
                                   cur["ndev"])
    if asas.partners_s.shape[0] != n_exp or (
            bshard is not None
            and (bshard.get("ndev"), bshard.get("mode"), bshard.get("tiles"))
            != (cur["ndev"], cur["mode"], cur.get("tiles"))):
        kk = asas.partners_s.shape[1] if asas.partners_s.shape[0] == n_exp \
            else old.asas.partners_s.shape[1]
        dev = old.asas.partners_s.device
        traf.state = traf.state.replace(asas=asas.replace(
            sort_perm=torch.arange(traf.nmax, dtype=torch.int32, device=dev),
            partners_s=torch.full((n_exp, kk), -1, dtype=torch.int32,
                                  device=dev)))
        sim._invalidate_sort()
    elif cur["mode"] != "off":
        # under a mesh the restored layout is consistent, but its
        # drift-margin clock is unknown: re-sort (re-bucket and
        # re-validate) before the next chunk
        sim._invalidate_sort()
    elif blob.get("sort") is not None:
        # the captured layout stays until its next due refresh
        sim._sort_simt = float(blob["sort"]["simt"])
        sim._sort_backend = blob["sort"]["backend"]
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


def write_blob(blob, fname):
    """Atomically persist a state blob: tmp file + fsync + rename.

    The tmp file lives in the destination directory (``os.replace``
    must not cross filesystems); any failure removes it, so the final
    name only ever holds a complete, checksummed snapshot — a previous
    good file survives a failed re-save untouched.  Raises ``OSError``
    on disk-full/bad-path; callers degrade to a command error."""
    payload = pickle.dumps(blob, protocol=pickle.HIGHEST_PROTOCOL)
    digest = hashlib.sha256(payload).hexdigest().encode("ascii")
    shard_line = json.dumps(
        blob.get("shard") or dict(mode="off", ndev=0, halo_blocks=0),
        sort_keys=True).encode("ascii")
    tmp = f"{fname}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC4 + digest + b"\n" + shard_line + b"\n" + payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return fname


def save(sim, fname):
    """Write an atomic, checksummed snapshot of the complete simulation
    state (format v4).  Raises ``OSError`` on disk-full/bad path — the
    SNAPSHOT stack command degrades it to a command error."""
    return write_blob(state_blob(sim), fname)


def _split_v4(raw):
    """Split a v4 byte stream into (digest, shard_meta, payload); raises
    on a malformed header (caught by the callers)."""
    digest_end = raw.index(b"\n", len(MAGIC4))
    digest = raw[len(MAGIC4):digest_end].decode("ascii")
    shard_end = raw.index(b"\n", digest_end + 1)
    shard = json.loads(raw[digest_end + 1:shard_end].decode("ascii"))
    if not isinstance(shard, dict):
        raise ValueError("shard header is not a JSON object")
    return digest, shard, raw[shard_end + 1:]


def peek_shard(fname):
    """A v4 snapshot's shard-layout header, without unpickling:
    ``(shard_dict, None)`` for v4 files, ``(None, None)`` for v2/v3
    (readable, layout unknown), ``(None, errmsg)`` for an unreadable or
    malformed file."""
    try:
        with open(fname, "rb") as f:
            head = f.read(64 * 1024)
        if not head.startswith(MAGIC4):
            return None, None
        _, shard, _ = _split_v4(head)
        return shard, None
    except (OSError, ValueError, UnicodeDecodeError) as exc:
        return None, (f"corrupt or truncated snapshot header "
                      f"({type(exc).__name__}: {exc})")


class _JaxNode:
    """Stand-in for a ``bluesky_tpu`` state class in a JAX snapshot: it
    only collects the fields pickle hands it."""

    def __setstate__(self, state):
        if isinstance(state, tuple):        # (dict, slots)
            d, slots = state
            state = {**(d or {}), **(slots or {})}
        self.__dict__.update(state)


#: The NumPy globals a snapshot's arrays and dtypes unpickle through
#: (NumPy 1 and 2 module names).
_NUMPY_GLOBALS = {
    (m, n) for m in ("numpy", "numpy.core.multiarray",
                     "numpy._core.multiarray", "numpy.core.numeric",
                     "numpy._core.numeric")
    for n in ("dtype", "ndarray", "_reconstruct", "_frombuffer", "scalar")}


class _Unpickler(pickle.Unpickler):
    """Admit NumPy's array classes and the JAX package's state classes
    (as ``_JaxNode`` stand-ins, never imported); refuse every other
    global."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if module == "bluesky_tpu" or module.startswith("bluesky_tpu."):
            return type(name, (_JaxNode,), {"__module__": module})
        raise pickle.UnpicklingError(f"global {module}.{name} is not "
                                     "allowed in a snapshot")


def _flat_state(node, prefix=""):
    """The ``state_to_numpy`` dict of a JAX state tree of ``_JaxNode``
    stand-ins: ``{dotted.path: ndarray}``."""
    out = {}
    for k, v in vars(node).items():
        if isinstance(v, _JaxNode):
            out.update(_flat_state(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unpickle(payload):
    blob = _Unpickler(io.BytesIO(payload)).load()
    if isinstance(blob, dict) and isinstance(blob.get("state"), _JaxNode):
        blob["state"] = _flat_state(blob["state"])
    return blob


def read_blob(fname):
    """Read and verify a snapshot file: ``(blob, None)`` or ``(None,
    errmsg)``.  v3/v4 files are checksum-verified before unpickling, so
    a bit-flipped payload that would still unpickle is rejected; v4
    files also surface the shard-layout header into ``blob["shard"]``;
    files without a magic are read as the v2 plain pickle, with no
    integrity check, and tagged ``blob["unverified"]``."""
    hdr_shard = None
    unverified = None
    try:
        with open(fname, "rb") as f:
            raw = f.read()
        if raw.startswith(MAGIC4):
            digest, hdr_shard, payload = _split_v4(raw)
            if hashlib.sha256(payload).hexdigest() != digest:
                return None, ("corrupt or truncated snapshot "
                              "(checksum mismatch)")
            blob = _unpickle(payload)
        elif raw.startswith(MAGIC3):
            header_end = raw.index(b"\n", len(MAGIC3))
            digest = raw[len(MAGIC3):header_end].decode("ascii")
            payload = raw[header_end + 1:]
            if hashlib.sha256(payload).hexdigest() != digest:
                return None, ("corrupt or truncated snapshot "
                              "(checksum mismatch)")
            blob = _unpickle(payload)
        else:
            blob = _unpickle(raw)           # v2: bare pickle, no digest
            unverified = "legacy v2 plain pickle, no checksum"
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
            MemoryError, ImportError, IndexError, KeyError, TypeError,
            UnicodeDecodeError, ValueError) as exc:
        return None, (f"corrupt or truncated snapshot "
                      f"({type(exc).__name__}: {exc})")
    if not isinstance(blob, dict) \
            or blob.get("format") not in COMPAT_FORMATS:
        return None, "unsupported snapshot format"
    if hdr_shard is not None:
        blob.setdefault("shard", hdr_shard)
    if unverified:
        blob["unverified"] = unverified
    return blob, None


def load(sim, fname):
    """Restore a snapshot into the running simulation.  A truncated,
    bit-flipped or corrupt file, or a state that does not fit this
    sim's layout, returns a command error instead of raising out of the
    stack."""
    blob, err = read_blob(fname)
    if blob is None:
        return False, f"{fname}: {err}"
    unverified = blob.get("unverified")
    if unverified:
        # a restore with no checksum is a silent-corruption blind spot:
        # count it and record it in the trace
        sim.obs.counter(
            "snapshot_unverified",
            help="snapshot restores with no checksum verification").inc()
        sim.recorder.instant("snapshot_unverified", cat="fault",
                             file=str(fname), why=str(unverified))
    try:
        ok, msg = restore_blob(sim, blob)
    except (KeyError, TypeError, ValueError) as exc:
        return False, (f"{fname}: snapshot does not fit this sim "
                       f"({type(exc).__name__}: {exc})")
    if ok and unverified:
        msg += (f" [UNVERIFIED: {unverified} — SNAPSHOT SAVE rewrites "
                f"it as v{FORMAT} with a digest]")
    return ok, (f"Snapshot {fname} {msg}" if ok else f"{fname}: {msg}")


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
        with sim.recorder.span("snapshot_capture", world=sim.world_tag,
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
