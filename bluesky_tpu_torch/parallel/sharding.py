"""Shard the sparse backend's CD&R over a single-process device mesh.

Port of the in-process half of ``bluesky_tpu/parallel/sharding.py``.  A
mesh here is a grid of torch devices with named axes (``Mesh``): the
1-D ``("ac",)`` mesh of the replicate and spatial modes, or the 2-D
``("lat", "lon")`` mesh of the tiles mode.  A device may appear more
than once, so D shards can run on one card (every mesh form of the
walker on its real path) or, for the tests, on the CPU, as JAX's
virtual CPU mesh does.

One controller drives every shard.  The state stays whole on the mesh's
first device (``shard_state``); each ASAS interval gives each shard its
slice of the work on its own device (``ops/cd_sched.detect_resolve_sched``)
and joins the results in a fixed order of shards, so a mesh result is
bit-equal to its single-device reference.  The three decompositions:

* ``replicate``: shard d walks the row blocks d, d + D, ... against the
  replicated columns (sparse and pallas backends);
* ``spatial``: shard d owns a range of latitude stripes and exchanges
  halo blocks with its neighbours (``prepare_spatial``: the refresh
  re-buckets each aircraft into the caller rows of the shard that owns
  its stripe);
* ``tiles``: 2-D lat x lon tiles with the edge and corner exchange
  (``make_tile_mesh``, ``prepare_tiles``).

Several processes on ``torch.distributed`` (``init_multihost``),
``MeshGuard`` with its mesh epochs, and the ensemble functions are not
ported (ROADMAP A9, step 2).
"""
import numpy as np
import torch

from .. import resolve_device
from ..core.state import SORT_PAD, SimState, _tree_map
from ..core.step import SimConfig


class Mesh:
    """A single-process device mesh: ``devices`` an array of torch
    devices (one may repeat) whose axes are named ``axis_names``.
    Hashable, so a ``SimConfig`` holding one keys the chunk executors."""

    def __init__(self, devices, axis_names):
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

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (tuple(str(d) for d in self.devices.ravel()),
                self.devices.shape, self.axis_names)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()


def default_devices(device=None):
    """The devices a mesh spans when none are given, as JAX counts
    ``jax.devices()``: the visible GPUs for a state on a card (the
    default, ``resolve_device``: no card raises), one CPU for a state the
    caller asked onto the CPU (``device``)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def make_mesh(n_devices=None, devices=None) -> Mesh:
    """1-D mesh over the aircraft axis ``"ac"``: the first ``n_devices``
    of ``devices`` (default ``default_devices()``)."""
    devices = list(devices) if devices is not None else default_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, ("ac",))


def make_tile_mesh(tiles, devices=None) -> Mesh:
    """2-D ``("lat", "lon")`` mesh of the tiles decomposition: device
    (r, c) owns tile ``t = r * C + c``, so the row-major device order is
    the tile-major sorted layout's (``cd_sched.tile_sort_dest``)."""
    tR, tC = int(tiles[0]), int(tiles[1])
    if tR < 1 or tC < 1:
        raise ValueError(f"tile mesh shape must be positive, got "
                         f"{tR}x{tC}")
    devices = list(devices) if devices is not None else default_devices()
    if len(devices) < tR * tC:
        raise ValueError(f"tile mesh {tR}x{tC} needs {tR * tC} devices, "
                         f"have {len(devices)}")
    grid = np.empty(tR * tC, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:tR * tC]]
    return Mesh(grid.reshape(tR, tC), ("lat", "lon"))


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
    ``core/step.run_steps``."""
    if cfg.cd_backend in ("pallas", "sparse") and cfg.cd_mesh is None:
        cfg = cfg._replace(cd_mesh=mesh, cd_mesh_axis="ac"
                           if "ac" in mesh.shape else cfg.cd_mesh_axis)

    def run(state, sort_t0=None):
        from ..core.step import _run_chunk
        state, carry, _, refresh = _run_chunk(state, cfg, nsteps,
                                              checked=False, sort_t0=sort_t0)
        ret = (state,)
        if "st" in carry:
            ret += (carry["st"],)
        if refresh is not None:
            ret += (refresh,)
        if "fp" in carry:
            ret += (carry["fp"],)
        return ret[0] if len(ret) == 1 else ret

    return run
