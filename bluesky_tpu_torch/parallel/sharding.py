"""Shard the sparse backend's CD&R over a device mesh.

Port of ``bluesky_tpu/parallel/sharding.py``.  A mesh here is a grid of
torch devices with named axes (``Mesh``): the 1-D ``("ac",)`` mesh of the
replicate and spatial modes, the 2-D ``("lat", "lon")`` mesh of the tiles
mode, or the ``("ens",)`` mesh of an ensemble.  A device may appear more
than once, so D shards can run on one card (every mesh form of the
walker on its real path) or, for the tests, on the CPU, as JAX's
virtual CPU mesh does.  Each shard also names the process (rank) that
owns it; by default the calling process owns them all.

The state stays whole on the mesh's first device (``shard_state``);
each ASAS interval gives each shard its slice of the work on its own
device (``ops/cd_sched.detect_resolve_sched``) and joins the results in
a fixed order of shards, so a mesh result is bit-equal to its
single-device reference.  The three decompositions:

* ``replicate``: shard d walks the row blocks d, d + D, ... against the
  replicated columns (sparse and pallas backends);
* ``spatial``: shard d owns a range of latitude stripes and exchanges
  halo blocks with its neighbours (``prepare_spatial``: the refresh
  re-buckets each aircraft into the caller rows of the shard that owns
  its stripe);
* ``tiles``: 2-D lat x lon tiles with the edge and corner exchange
  (``make_tile_mesh``, ``prepare_tiles``).

Several processes (``init_multihost``, on ``torch.distributed``): every
rank runs the same program on the whole replicated state, walks only
the shards it owns and all-gathers the shard results (``dist``); at each
chunk edge of a run across ranks the ranks compare a fingerprint of the
state (``check_replicas``).  Tested with gloo, in CPU processes and as
two processes sharing one card; NCCL across several cards is not
measured.

Mesh epochs: ``MeshGuard`` is the liveness sentinel a sharded
Simulation consults at every chunk dispatch, and ``MeshLostError`` what
it raises when a group of shards is dead; the Simulation then restores
its last snapshot onto the survivors (``Simulation._handle_mesh_lost``).
Ensembles: ``make_ensemble_mesh``, ``stack_replicas`` and
``ensemble_step_fn`` step whole replicas on each device of an
``("ens",)`` mesh, with no traffic between devices.
"""
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.state import SORT_PAD, SimState, _tree_map
from ..core.step import SimConfig
from . import dist

#: how often ``MeshGuard.guarded_ready`` polls the work it waits on [s]
_POLL_S = 0.0005


class Mesh:
    """A device mesh: ``devices`` an array of torch devices (one may
    repeat) whose axes are named ``axis_names``, and ``ranks`` the
    process that owns each shard (default: the calling process, a
    single-process mesh).  Hashable, so a ``SimConfig`` holding one keys
    the chunk executors.  ``guard`` is the ``MeshGuard`` bound to it, whose
    heartbeat-stamped wait the joins across processes use (not part of
    the key)."""

    def __init__(self, devices, axis_names, ranks=None):
        devs = [torch.device(d) for d in np.asarray(devices,
                                                     dtype=object).ravel()]
        shape = np.shape(np.asarray(devices, dtype=object))
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.devices = self.devices.reshape(shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"mesh of shape {shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if ranks is None:
            ranks = [dist.process_index()] * len(devs)
        ranks = np.asarray(ranks, dtype=np.int64).ravel()
        if ranks.size != len(devs):
            raise ValueError(f"{ranks.size} shard ranks for a mesh of "
                             f"{len(devs)} shards")
        self.ranks = ranks.reshape(shape)
        self.guard = None

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (tuple(str(d) for d in self.devices.ravel()),
                self.devices.shape, self.axis_names,
                tuple(int(r) for r in self.ranks.ravel()))

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()


def default_devices(device=None):
    """The devices a mesh spans when none are given, as JAX counts
    ``jax.devices()``: after ``init_multihost`` every rank's devices in
    rank order (``default_ranks`` their owners); else the visible GPUs
    for a state on a card (the default, ``resolve_device``: no card
    raises), one CPU for a state the caller asked onto the CPU
    (``device``)."""
    if dist.JOB["devices"] is not None:
        return list(dist.JOB["devices"])
    return dist.local_devices(resolve_device(device))


def default_ranks():
    """The owner of each device of ``default_devices()``: the ranks of
    the job after ``init_multihost``, else None (this process)."""
    ranks = dist.JOB["ranks"]
    return list(ranks) if ranks is not None else None


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, backend=None, device=None,
                   timeout=None):
    """Join a job of several processes (JAX ``init_multihost`` on
    ``jax.distributed``): ``torch.distributed.init_process_group`` over
    ``tcp://coordinator_address`` ("host:port") with ``num_processes``
    ranks, this one ``process_id``.  Call once per process, before any
    mesh is made; afterwards ``default_devices()`` lists every rank's
    devices in rank order and ``make_mesh()`` spans the job.

    ``device`` is this process's device (default CUDA,
    ``resolve_device``).  ``backend`` defaults to ``nccl`` for a CUDA
    device and ``gloo`` for the CPU; pass ``"gloo"`` for ranks that
    share one card (NCCL refuses two ranks on one GPU): its joins stage
    through pinned host memory.  ``timeout`` (s) is the process group's
    own collective timeout; by default longer than the MeshGuard's
    budget (``settings.mesh_dispatch_timeout`` +
    ``mesh_heartbeat_timeout`` + 60 s, or gloo's 30 minutes when the
    dispatch timeout is 0), so a collective on a dead peer surfaces
    through ``MeshGuard.guarded_ready`` first."""
    from .. import settings
    if timeout is None:
        budget = float(getattr(settings, "mesh_dispatch_timeout", 0.0))
        timeout = budget + float(getattr(
            settings, "mesh_heartbeat_timeout", 10.0)) + 60.0 \
            if budget > 0 else 1800.0
    return dist.join_job(coordinator_address, num_processes, process_id,
                         resolve_device(device), backend=backend,
                         timeout_s=timeout)


def make_mesh(n_devices=None, devices=None, ranks=None) -> Mesh:
    """1-D mesh over the aircraft axis ``"ac"``: the first ``n_devices``
    of ``devices`` (default ``default_devices()``, owned by
    ``default_ranks()``); ``ranks`` the owner of each (default this
    process)."""
    if devices is None:
        devices, ranks = default_devices(), default_ranks()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
        ranks = None if ranks is None else list(ranks)[:n_devices]
    return Mesh(devices, ("ac",), ranks=ranks)


def make_tile_mesh(tiles, devices=None, ranks=None) -> Mesh:
    """2-D ``("lat", "lon")`` mesh of the tiles decomposition: device
    (r, c) owns tile ``t = r * C + c``, so the row-major device order is
    the tile-major sorted layout's (``cd_sched.tile_sort_dest``)."""
    tR, tC = int(tiles[0]), int(tiles[1])
    if tR < 1 or tC < 1:
        raise ValueError(f"tile mesh shape must be positive, got "
                         f"{tR}x{tC}")
    if devices is None:
        devices, ranks = default_devices(), default_ranks()
    devices = list(devices)
    if len(devices) < tR * tC:
        raise ValueError(f"tile mesh {tR}x{tC} needs {tR * tC} devices, "
                         f"have {len(devices)}")
    grid = np.empty(tR * tC, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:tR * tC]]
    return Mesh(grid.reshape(tR, tC), ("lat", "lon"),
                ranks=None if ranks is None else list(ranks)[:tR * tC])


def home_device(mesh: Mesh) -> torch.device:
    """The device the state of a sharded run lives on: the mesh's first."""
    return mesh.devices.ravel()[0]


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """Place a state for a run on ``mesh``: whole, on its first device
    (the single controller gives each shard its slice per interval)."""
    dev = home_device(mesh)
    return _tree_map(lambda name, x: x.to(dev)
                     if isinstance(x, torch.Tensor) else x, state)


def _sized_tables(state: SimState, n_tot: int) -> SimState:
    """The state with an empty sorted-space partner table of ``n_tot``
    rows (entering a mode resets the engagement hysteresis: engaged pairs
    re-detect at the next interval)."""
    kk = state.asas.partners_s.shape[1]
    return state.replace(asas=state.asas.replace(partners_s=torch.full(
        (n_tot, kk), -1, dtype=torch.int32, device=state.device)))


def prepare_spatial(state: SimState, mesh: Mesh, acfg, block: int = 256,
                    halo_blocks: int = 0, put: bool = True):
    """Enter the spatial mode: size the sorted-space partner table to the
    shard-divisible padded layout, run the spatial refresh (stripe sort,
    caller-slot re-bucketing, halo check) and place the state on the
    mesh.  Returns ``(state, newslot, info)`` (``asas.refresh_spatial_shard``);
    raises ``RuntimeError`` for a geometry the mode cannot cover."""
    from ..core import asas as asasmod
    ndev = mesh.shape["ac"]
    n = state.nmax
    if n % ndev:
        raise ValueError(f"spatial mode: nmax={n} must divide into the "
                         f"{ndev}-device mesh")
    state = _sized_tables(state, asasmod.spatial_table_size(n, block, ndev))
    state, newslot, info = asasmod.refresh_spatial_shard(
        state, acfg, ndev, block=block, halo_blocks=halo_blocks)
    if put:
        state = shard_state(state, mesh)
    return state, newslot, info


def prepare_tiles(state: SimState, mesh: Mesh, acfg, tiles=None,
                  block: int = 256, budgets=(), put: bool = True):
    """Enter the tiles mode: size the sorted-space table to the R * C
    shard-divisible layout, run the tile refresh (tile-major sort,
    re-bucketing, corner-halo check; ``budgets`` () pins each offset's
    halo budget at 1.25x its need) and place the state on the mesh.
    ``tiles`` defaults to the mesh's ``("lat", "lon")`` shape.  Returns
    ``(state, newslot, info)``; pin ``info["budgets"]`` and
    ``info["tile_shape"]`` into ``SimConfig.cd_tile_budgets`` and
    ``cd_tile_shape``."""
    from ..core import asas as asasmod
    if tiles is None:
        shape = mesh.shape
        if "lat" not in shape or "lon" not in shape:
            raise ValueError(
                "prepare_tiles needs a ('lat', 'lon') mesh (build it "
                "with make_tile_mesh) or an explicit tiles=(R, C)")
        tiles = (shape["lat"], shape["lon"])
    tR, tC = int(tiles[0]), int(tiles[1])
    ndev = tR * tC
    n = state.nmax
    if n % ndev:
        raise ValueError(f"tiles mode: nmax={n} must divide into the "
                         f"{tR}x{tC}={ndev}-tile grid")
    state = _sized_tables(state, asasmod.spatial_table_size(n, block, ndev))
    state, newslot, info = asasmod.refresh_tile_shard(
        state, acfg, (tR, tC), block=block, budgets=tuple(budgets))
    if put:
        state = shard_state(state, mesh)
    return state, newslot, info


def unprepare_spatial(state: SimState) -> SimState:
    """Leave the spatial or tiles mode: the default-size sorted tables
    and the identity sort (the hysteresis resets, as on entering).  The
    caller slots keep their last bucketing."""
    n = state.nmax
    kk = state.asas.partners_s.shape[1]
    dev = state.device
    return state.replace(asas=state.asas.replace(
        partners_s=torch.full((n + SORT_PAD, kk), -1, dtype=torch.int32,
                              device=dev),
        sort_perm=torch.arange(n, dtype=torch.int32, device=dev)))


def sharded_step_fn(mesh: Mesh, cfg: SimConfig, nsteps: int = 1):
    """The chunk runner on ``mesh``: ``run(state, sort_t0=None)`` advances
    ``nsteps`` steps with ``cfg.cd_mesh`` set to the mesh (the pallas and
    sparse backends), returning the state, then the ScanStats,
    RefreshPack and FingerprintPack that ``cfg``'s flags ask for, as
    JAX's compiled function does.  The input is donated as in
    ``core/step.run_steps``.  On a mesh that spans processes every call
    ends at a chunk edge where the ranks compare the state's fingerprint
    (``check_replicas``, naming the call's ordinal as the chunk)."""
    if cfg.cd_backend in ("pallas", "sparse") and cfg.cd_mesh is None:
        cfg = cfg._replace(cd_mesh=mesh, cd_mesh_axis="ac"
                           if "ac" in mesh.shape else cfg.cd_mesh_axis)
    across = dist.spans_ranks(mesh.ranks.ravel())
    chunks = [0]

    def run(state, sort_t0=None):
        from ..core.step import _run_chunk
        state, carry, _, refresh = _run_chunk(state, cfg, nsteps,
                                              checked=False, sort_t0=sort_t0)
        if across:
            chunks[0] += 1
            check_replicas(state, chunks[0], mesh.guard)
        ret = (state,)
        if "st" in carry:
            ret += (carry["st"],)
        if refresh is not None:
            ret += (refresh,)
        if "fp" in carry:
            ret += (carry["fp"],)
        return ret[0] if len(ret) == 1 else ret

    return run


def check_replicas(state: SimState, chunk, guard=None) -> int:
    """The cross-rank fingerprint at a chunk edge: every rank folds its
    replicated state once (``obs/fingerprint``'s word over the guarded
    fields and the live mask) and the ranks all-gather the words.
    Raises ``RuntimeError`` naming ``chunk`` and each rank's word if any
    two differ: a replicated state that drifted (an atomic add in
    another order, a lost update) must not go on as rank 0's answer.
    Returns the word."""
    from ..obs import fingerprint as fpmod
    cfg = SimConfig()
    word = fpmod.combine(fpmod.fold(fpmod.init(state, cfg), state, cfg))
    words = dist.allgather_words(word, guard)
    if len(set(words)) > 1:
        raise RuntimeError(
            f"chunk {chunk}: the replicated state differs across ranks "
            f"(fingerprints {', '.join(format(w, '08x') for w in words)} "
            "in rank order)")
    return word


# --------------------------------------------------------------------------
# Ensembles (JAX ``make_ensemble_mesh``, ``ensemble_step_fn``,
# ``stack_replicas``): each device of an ("ens",) mesh owns whole
# replicas; there is no traffic between devices.
# --------------------------------------------------------------------------

def make_ensemble_mesh(n_devices=None, devices=None) -> Mesh:
    """1-D ``("ens",)`` mesh over the first ``n_devices`` of ``devices``
    (default ``default_devices()``; a device may repeat)."""
    devices = list(devices) if devices is not None else default_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, ("ens",))


def stack_replicas(states):
    """Stack equal-shape ``SimState``s along a leading replica axis (the
    world axis of ``core/state.stack_worlds``)."""
    from ..core.state import stack_worlds
    return stack_worlds(list(states))


def ensemble_step_fn(mesh: Mesh, cfg: SimConfig, nsteps: int = 1):
    """The ensemble runner: ``run(states)`` advances every replica of a
    stacked state (``stack_replicas``) ``nsteps`` steps.  Shard d of
    ``mesh`` owns the d-th contiguous group of R / D replicas; each
    distinct device steps the replicas of all its shards as one stacked
    chunk (``core/step.run_steps_worlds``), each replica giving its solo
    answer.  On a mesh of one device (repeated or not) the result is the
    chunk runner's own, which donates the state passed back to it as
    ``run_steps_worlds`` does; on several devices the groups are joined
    in replica order on the mesh's first device.  R must divide into the
    D shards (JAX's ``P("ens")`` sharding demands as much)."""
    devs = list(mesh.devices.ravel())

    def run(states):
        from ..core.step import run_steps_worlds
        n_rep = len(states.simt)
        if n_rep % len(devs):
            raise ValueError(f"{n_rep} replicas do not divide into the "
                             f"{len(devs)}-device ensemble mesh")
        per = n_rep // len(devs)
        groups = {}
        for d, dev in enumerate(devs):
            groups.setdefault(dev, []).extend(range(d * per, (d + 1) * per))
        if len(groups) == 1:
            return run_steps_worlds(_on(states, devs[0]), cfg, nsteps)
        done, order = [], []
        for dev, idx in groups.items():
            done.append(run_steps_worlds(_on(_take(states, idx), dev), cfg,
                                         nsteps))
            order += idx
        return _join(done, np.argsort(order), devs[0])

    return run


def _take(states, idx):
    """The replicas ``idx`` of a stacked state (a copy)."""
    return _tree_map(lambda name, x: x[idx] if isinstance(
        x, (torch.Tensor, np.ndarray)) else x, states)


def _join(parts, inv, home):
    """Stacked states ``parts`` concatenated along the replica axis on
    ``home`` and taken in the order ``inv``."""
    tinv = torch.as_tensor(inv, device=home)

    def cat(name, *xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat([x.to(home) for x in xs])[tinv]
        if xs[0] is None:
            return None
        return np.concatenate(xs)[inv]
    return _tree_map(cat, *parts)


def _on(state, dev):
    """``state`` with every tensor on ``dev``."""
    return _tree_map(lambda name, x: (x.to(dev) if isinstance(x, torch.Tensor)
                                      else x), state)


# --------------------------------------------------------------------------
# Mesh-epoch recovery: losing a group of shards ends the EPOCH, not the
# run.  MeshGuard is the liveness sentinel a sharded sim consults at
# every chunk dispatch; on a trip the sim tears the epoch down, restores
# the last checksummed snapshot onto the survivors and steps on degraded
# (simulation/sim._handle_mesh_lost).
# --------------------------------------------------------------------------

class MeshLostError(RuntimeError):
    """A group of shards of the active mesh is dead or unreachable.

    Carries the lost group indices (or, from a collective's timeout, the
    silent peer ranks) and the surviving devices, so the recovery layer
    can form a smaller mesh without asking a wedged runtime."""

    def __init__(self, msg, lost_groups=(), survivors=None):
        super().__init__(msg)
        self.lost_groups = tuple(lost_groups)
        self.survivors = list(survivors) if survivors is not None else []


class MeshGuard:
    """Liveness sentinel for one mesh epoch.

    Groups of shards model the unit of correlated failure.  A group is a
    list of shard POSITIONS of the mesh, never of device identities (a
    mesh may repeat one device): on a mesh spanning processes the
    groups are the shards of each rank (a host dying takes its whole
    group); on a single-process mesh the shards split into two contiguous
    halves, so ``FAULT MESHKILL 1`` on 8 shards kills shards 4-7 and the
    survivors are the devices of shards 0-3, in mesh order.

    Detection is two-pronged:

    * ``check()`` — the dispatch-time precheck: raises ``MeshLostError``
      for any group marked dead (``kill_group``, the FAULT MESHKILL
      injector).
    * ``guarded_ready(x)`` — waits on a chunk's device work (the CUDA
      stream of a tensor or state, or a collective's ``Work`` from
      ``async_op=True``) by polling while this process stamps its own
      heartbeat file; past ``timeout`` seconds, or when the wait fails
      with a peer's stamp stale, the peer stamps decide who died.
    """

    def __init__(self, mesh=None, heartbeat_dir=None, timeout=0.0,
                 hb_timeout=10.0):
        self.timeout = float(timeout)        # collective wait budget [s]
        self.hb_timeout = float(hb_timeout)  # peer stamp staleness [s]
        self.heartbeat_dir = heartbeat_dir
        self.epoch = 0
        self._killed = set()
        self.groups = []
        self.mesh = None
        self.set_mesh(mesh)

    # ------------------------------------------------------------ topology
    def set_mesh(self, mesh):
        """Bind a (new) mesh: recompute the groups, clear the kill marks
        (a re-formed survivor mesh starts its epoch healthy).  A mesh
        spanning processes waits on its joins through this guard."""
        if self.mesh is not None and self.mesh.guard is self:
            self.mesh.guard = None
        self.mesh = mesh
        self._killed = set()
        if mesh is None:
            self.groups = []
            return
        ranks = [int(r) for r in mesh.ranks.ravel()]
        self.groups = self._partition(list(range(len(ranks))), ranks)
        if len(set(ranks)) > 1:
            mesh.guard = self

    @staticmethod
    def _partition(shards, ranks=None):
        """Groups of shard positions: by owning rank when the shards span
        processes, else two contiguous halves (one group for one shard)."""
        if not shards:
            return []
        if ranks is not None and len(set(ranks)) > 1:
            by_rank = {}
            for i, r in zip(shards, ranks):
                by_rank.setdefault(r, []).append(i)
            return [by_rank[k] for k in sorted(by_rank)]
        if len(shards) < 2:
            return [list(shards)]
        half = (len(shards) + 1) // 2
        return [list(shards[:half]), list(shards[half:])]

    @property
    def survivors(self):
        """The devices of every still-live group, in mesh order (the
        shard positions themselves with no mesh bound)."""
        live = [i for k, g in enumerate(self.groups)
                if k not in self._killed for i in g]
        if self.mesh is None:
            return live
        devs = self.mesh.devices.ravel()
        return [devs[i] for i in live]

    # ---------------------------------------------------------- injection
    def kill_group(self, k):
        """Mark group ``k`` dead (the FAULT MESHKILL injector).  The fault
        surfaces at the next ``check()``/``guarded_ready()``, i.e. the
        next chunk dispatch: like a real host loss, nothing happens until
        the fabric next touches the mesh.  Returns the group's shard
        positions."""
        k = int(k)
        if not 0 <= k < len(self.groups):
            raise ValueError(f"no device group {k} "
                             f"(mesh has {len(self.groups)})")
        if len(self.groups) - len(self._killed | {k}) < 1:
            raise ValueError("cannot kill the last live device group")
        self._killed.add(k)
        return self.groups[k]

    # ---------------------------------------------------------- detection
    def check(self):
        """Dispatch-time precheck: raise MeshLostError if any group of
        the bound mesh is marked dead."""
        if self.mesh is None or not self._killed:
            return
        lost = sorted(self._killed)
        raise MeshLostError(
            f"mesh epoch {self.epoch}: device group(s) "
            f"{','.join(map(str, lost))} dead "
            f"({len(self.survivors)} device(s) survive)",
            lost_groups=lost, survivors=self.survivors)

    # ------------------------------------------------- cross-process pulse
    def _hb_path(self, pid=None):
        if not self.heartbeat_dir:
            return None
        if pid is None:
            pid = dist.process_index()
        return os.path.join(self.heartbeat_dir, f"meshhb-{pid}")

    def stamp(self):
        """Refresh this process's heartbeat file (mtime is the pulse)."""
        path = self._hb_path()
        if path is None:
            return
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(f"{time.time():.3f}\n")

    def stale_peers(self, hb_timeout=None):
        """Process indices whose heartbeat stamp is older than
        ``hb_timeout`` (missing stamps are NOT stale: a peer that never
        stamped may simply not have started)."""
        if not self.heartbeat_dir or not os.path.isdir(self.heartbeat_dir):
            return []
        budget = self.hb_timeout if hb_timeout is None else float(hb_timeout)
        me = dist.process_index()
        now = time.time()
        stale = []
        for name in sorted(os.listdir(self.heartbeat_dir)):
            if not name.startswith("meshhb-"):
                continue
            try:
                pid = int(name.split("-", 1)[1])
            except ValueError:
                continue
            if pid == me:
                continue
            try:
                age = now - os.path.getmtime(
                    os.path.join(self.heartbeat_dir, name))
            except OSError:
                continue
            if age > budget:
                stale.append(pid)
        return stale

    def guarded_ready(self, x):
        """Wait for ``x`` under the heartbeat-stamped timeout and return
        it: a collective's ``Work`` (polled with ``is_completed()``, never
        blocked in ``wait()``, which on gloo lasts the process group's
        own timeout), or a tensor or state whose CUDA stream work an event
        marks (CPU work is done when it returns).  Past ``timeout``
        seconds (0 = wait without a budget), or when the wait fails and a
        peer's stamp goes stale within ``hb_timeout`` of the failure, the
        epoch is declared lost (``MeshLostError``, the silent peers as
        ``lost_groups``); a failure with every peer alive re-raises."""
        self.check()
        done = _completion(x)
        if done is None:
            self.stamp()
            return x
        t0 = time.monotonic()
        beat = max(0.001, min(1.0, (self.timeout or 0.02) / 4.0))
        next_beat = t0
        err = None
        while True:
            try:
                if done():
                    break
            except Exception as e:  # noqa: BLE001 — the transport fails
                err = e             # in its own way; decided below
                break
            # poll the work every _POLL_S; stamp and read the peers'
            # stamps once a beat, so a finished wait costs at most a poll
            now = time.monotonic()
            if now >= next_beat:
                next_beat = now + beat
                self.stamp()
                if self.timeout > 0:
                    stale = self.stale_peers()
                    if stale or now - t0 > self.timeout:
                        self._mark_ranks(stale)
                        raise MeshLostError(
                            f"mesh epoch {self.epoch}: collective wait "
                            f"exceeded {self.timeout:.1f}s"
                            + (f", peer process(es) {stale} silent "
                               f"> {self.hb_timeout:.1f}s" if stale
                               else ""),
                            lost_groups=stale, survivors=self.survivors)
            time.sleep(_POLL_S)
        self.stamp()
        if err is None and hasattr(x, "is_completed"):
            try:
                x.wait()            # completed: surfaces a failed Work
            except Exception as e:  # noqa: BLE001
                err = e
        if err is not None:
            self.failed(err)
        return x

    def failed(self, err):
        """Decide a failed collective: a dead peer's socket closes at
        once, before its stamp ages, so wait the staleness budget out
        (stamping) and raise ``MeshLostError`` naming the silent peers,
        their groups marked dead; with every peer alive re-raise
        ``err``."""
        t1 = time.monotonic()
        stale = self.stale_peers()
        while not stale and time.monotonic() - t1 <= self.hb_timeout:
            self.stamp()
            time.sleep(0.05)
            stale = self.stale_peers()
        if not stale:
            raise err
        self._mark_ranks(stale)
        raise MeshLostError(
            f"mesh epoch {self.epoch}: collective failed ({err}) "
            f"with peer process(es) {stale} silent",
            lost_groups=stale, survivors=self.survivors) from err

    def _mark_ranks(self, ranks):
        """Mark dead the groups of shards that the processes ``ranks``
        own, so ``survivors`` leaves them out."""
        if self.mesh is None:
            return
        owner = self.mesh.ranks.ravel()
        self._killed |= {k for k, g in enumerate(self.groups)
                         if g and int(owner[g[0]]) in set(ranks)}


def _completion(x):
    """A poll for the device work behind ``x``: ``Work.is_completed``
    for a collective, a CUDA event's ``query`` for CUDA tensors (a
    state's, or one tensor's), None when nothing is pending (CPU)."""
    if hasattr(x, "is_completed"):
        return x.is_completed
    from ..core.graph import leaves
    devs = {t.device for _, t in leaves(x) if t.is_cuda}
    if not devs:
        return None
    events = []
    for dev in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return lambda: all(ev.query() for ev in events)
