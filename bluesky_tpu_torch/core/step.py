"""The simulation step and its chunk runners on tensors.

Port of ``bluesky_tpu/core/step.py``: the four CD backends (``dense``,
``tiled``, ``pallas``, ``sparse``), the resolvers MVP, EBY, SWARM and
SSD, the differentiable mode of the dense backend (``SimConfig.smooth``)
and the shard modes of the sparse backend on a single-process mesh
(``cd_mesh``, ``cd_shard_mode``; ``parallel/sharding.py``).
Pipeline order per step (reference traffic.py:383-423): atmosphere ->
ADS-B -> FMS (gated) -> ASAS CD&R (gated) -> AP/ASAS arbitration ->
performance update -> envelope limits -> airspeed -> groundspeed (wind)
-> position -> turbulence.

The FMS and ASAS gates are decided on the host from the state's host
clocks (``simt``, ``fms_t0``, ``asas_tnext``, numpy scalars in the
state's dtype), with the same expressions the JAX step evaluates on the
device, so every decision is the JAX one bit for bit and a chunk never
waits for the device to learn which branch to take (``next_clocks``).

The chunk runners (``run_steps``, ``run_steps_checked``,
``run_steps_edge``, ``run_steps_edge_keep``) share one chunk body, the
port's counterpart of JAX's ``lax.scan`` over ``step``: each step, then
the folds its flags ask for (the first-bad-step guard, ``ScanStats``,
the state fingerprint) and, before it, the in-scan sort refresh.  On a
CPU state the body runs the steps eagerly.  On a CUDA state the steps
without an ASAS interval replay captured CUDA graphs
(``core/graph.py``), and the ASAS steps and the refreshes run eagerly
between replays; no runner reads the device back to the host.

Donation: on a CUDA state a runner copies its input into the graph
buffers of its configuration (a tensor that already is the buffer is not
copied), and ``run_steps``, ``run_steps_checked`` and ``run_steps_edge``
return those buffers.  Passing a returned state (or one made from it,
say by the sort refresh) back in donates it, as JAX's donation does:
the chunk advances it in place, so it must not be read afterwards.  A
returned state that is not passed back stays valid: a chunk of another
state gets buffers of its own.  ``run_steps_edge_keep`` writes neither
its input nor any state returned before.  On the CPU every runner
returns new tensors.
"""
from typing import NamedTuple

import numpy as np
import torch

from . import asas as asasmod
from . import autopilot, kinematics, noise, perf as perfmod, pilot
from . import wind as windmod
from .asas import AsasConfig
from .noise import NoiseConfig
from .state import (SimState, stack_worlds, unstack_worlds,  # noqa: F401
                    world_slice)


class SimConfig(NamedTuple):
    """Simulation configuration (the fields of the JAX ``SimConfig``, with
    its defaults).  ``cd_backend``: ``"dense"``
    materialises [N, N] pair matrices (fine to ~16k aircraft; needs
    ``Traffic(pair_matrix=True)``), ``"tiled"`` streams [cd_block,
    cd_block] tiles with an [N, K] partner table, ``"pallas"`` is the
    tiled scheme on the CUDA tile kernels and ``"sparse"`` the
    segment-scheduled kernels with the stripe sort.  ``scanstats``,
    ``inscan_refresh`` and ``fingerprint`` add the chunk runners' folds
    (``obs/scanstats.py``, the sparse sort refresh on its
    ``sort_every * dtasas`` cadence, ``obs/fingerprint.py``); off, a
    chunk launches nothing for them.  ``smooth``: a
    ``diff.smooth.SmoothConfig`` swaps the hard gates of the dense step
    for the relaxations of the differentiable rollout (``diff/``); None,
    the default and the only value the Simulation sets, is the serving
    step bit for bit.

    The shard modes (``parallel/sharding.py``): ``cd_mesh`` a
    ``sharding.Mesh`` (None: one device) whose ``cd_mesh_axis`` the
    replicate and spatial modes split; ``cd_shard_mode`` ``"replicate"``
    (row blocks interleaved over the shards against replicated columns;
    sparse and pallas), ``"spatial"`` (shard-owned latitude stripes with
    a halo of ``cd_halo_blocks`` blocks a side, 0 one shard's) or
    ``"tiles"`` (lat x lon tiles of ``cd_tile_shape`` (R, C) with the
    per-offset halo budgets ``cd_tile_budgets``, () unpinned); the last
    two run on the sparse backend only."""
    simdt: float = 0.05          # [s] (reference simulation.py:15)
    fms_dt: float = autopilot.FMS_DT
    asas: AsasConfig = AsasConfig()
    noise: NoiseConfig = NoiseConfig()
    use_wind: bool = False
    cd_backend: str = "dense"
    cd_block: int = 512
    cd_mesh: object = None
    cd_mesh_axis: str = "ac"
    cd_shard_mode: str = "replicate"
    cd_halo_blocks: int = 0
    cd_tile_shape: tuple = ()
    cd_tile_budgets: tuple = ()
    smooth: object = None
    scanstats: bool = False
    inscan_refresh: bool = False
    fingerprint: bool = False


def check_config(cfg: SimConfig, state: SimState):
    """Raise for a configuration the port cannot run on ``state`` (the
    checks of the JAX step)."""
    if not cfg.asas.swasas:
        return
    if cfg.cd_backend not in ("dense", "tiled", "pallas", "sparse"):
        raise ValueError(
            f"Unknown SimConfig.cd_backend {cfg.cd_backend!r}; expected "
            "'dense', 'tiled', 'pallas' or 'sparse'.")
    if cfg.smooth is not None and cfg.cd_backend != "dense":
        raise ValueError(
            "SimConfig.smooth (differentiable mode) relaxes the dense "
            "CD&R path only: the tiled/pallas/sparse kernels carry integer "
            "partner tables that do not differentiate.  Use "
            "cd_backend='dense' (diff workloads run small-N).")
    if cfg.cd_shard_mode not in ("replicate", "spatial", "tiles"):
        raise ValueError(
            f"Unknown SimConfig.cd_shard_mode {cfg.cd_shard_mode!r}; "
            "expected 'replicate', 'spatial' or 'tiles'.")
    if cfg.cd_shard_mode in ("spatial", "tiles") \
            and cfg.cd_backend != "sparse":
        raise ValueError(
            f"cd_shard_mode='{cfg.cd_shard_mode}' is the sparse backend's "
            "domain decomposition (stripes/tiles are a property of the "
            "sorted schedule); use cd_backend='sparse'")
    if cfg.cd_shard_mode == "tiles" and (
            not cfg.cd_tile_shape or len(cfg.cd_tile_shape) != 2):
        raise ValueError(
            "cd_shard_mode='tiles' needs cd_tile_shape=(R, C) — set it "
            "via Simulation.set_shard / SHARD TILE RxC")
    if cfg.cd_backend == "dense" and state.asas.resopairs.numel() == 0:
        raise ValueError(
            "State was allocated with pair_matrix=False (no [N,N] "
            "resopairs) but SimConfig.cd_backend is 'dense'. Use "
            "SimConfig(cd_backend='tiled') or allocate "
            "Traffic(pair_matrix=True).")
    asasmod.require_resolver(cfg.asas)


class Clocks(NamedTuple):
    """The host side of a state: its clocks (numpy scalars in the
    state's dtype) and its noise seed."""
    simt: np.floating
    fms_t0: np.floating
    asas_tnext: np.floating
    rng: int


def fms_due(state, fms_dt: float) -> bool:
    """The FMS gate of the JAX step, on the host clocks in their dtype
    (``state``: a ``SimState`` or ``Clocks``)."""
    dt = state.simt.dtype.type
    simt, t0 = state.simt, state.fms_t0
    return bool((t0 + dt(fms_dt) < simt) | (simt < t0) | (simt < dt(fms_dt)))


def asas_due(state) -> bool:
    """The ASAS gate of the JAX step, on the host clocks."""
    return bool(state.simt >= state.asas_tnext)


def noise_on(cfg: SimConfig) -> bool:
    return bool(cfg.noise.turb_active or cfg.noise.adsb_transnoise)


def _next_seed(seed: int) -> int:
    """Advance the noise seed (a 64-bit LCG step)."""
    return (seed * 6364136223846793005 + 1442695040888963407) % 2 ** 64


def next_clocks(state, cfg: SimConfig):
    """One step's gate decisions and the host side after it: ``(fms,
    asas, Clocks)``.  ``state`` is a ``SimState`` or ``Clocks``; ``step``
    and the chunk runners both advance the host side through here."""
    dt = state.simt.dtype.type
    fms = fms_due(state, cfg.fms_dt)
    asas = bool(cfg.asas.swasas) and asas_due(state)
    return fms, asas, Clocks(
        simt=state.simt + dt(cfg.simdt),
        fms_t0=state.simt if fms else state.fms_t0,
        asas_tnext=state.asas_tnext + dt(cfg.asas.dtasas) if asas
        else state.asas_tnext,
        rng=_next_seed(state.rng) if noise_on(cfg) else state.rng)


def noise_seed(state) -> int:
    """The seed of a step's noise generator, from the pre-step ``rng``."""
    return state.rng % 2 ** 63


def step_body(state: SimState, cfg: SimConfig, fms: bool, asas: bool,
              simt, gen) -> SimState:
    """The device part of one step, with the gates decided: ``simt`` is
    the pre-step clock (a host scalar, or a 0-d tensor of the same value
    on the state's device), ``gen`` the noise generator (None without
    noise).  Leaves the host side of ``state`` as it was."""
    simdt = float(state.simt.dtype.type(cfg.simdt))

    # ---------- Atmosphere ----------
    state = state.replace(ac=kinematics.update_atmosphere(state.ac))

    # ---------- ADS-B broadcast model ----------
    state = state.replace(adsb=noise.adsb_update(
        state.adsb, state.ac, gen, simt, cfg.noise, smooth=cfg.smooth))

    # ---------- FMS / autopilot, gated at fms_dt ----------
    if fms:
        state = autopilot.update_fms(state)
    state = autopilot.update_continuous(state)

    # ---------- ASAS CD&R, gated at dtasas ----------
    if asas:
        if cfg.cd_backend == "dense":
            state, _cd = asasmod.update(state, cfg.asas, smooth=cfg.smooth)
        else:
            impl = asasmod.impl_for_backend(cfg.cd_backend)
            state, _rd = asasmod.update_tiled(
                state, cfg.asas, block=cfg.cd_block, impl=impl,
                mesh=cfg.cd_mesh, mesh_axis=cfg.cd_mesh_axis,
                shard_mode=cfg.cd_shard_mode,
                halo_blocks=cfg.cd_halo_blocks,
                tile_shape=cfg.cd_tile_shape or None,
                tile_budgets=cfg.cd_tile_budgets)

    # ---------- Pilot arbitration ----------
    if cfg.use_wind:
        windn, winde = windmod.getdata(state.wind, state.ac.lat,
                                       state.ac.lon, state.ac.alt)
    else:
        windn = winde = None
    return _tail(state, cfg, simdt, gen, windn, winde)


def _tail(state: SimState, cfg: SimConfig, simdt: float, gen, windn,
          winde) -> SimState:
    """The step after the ASAS interval: pilot arbitration, performance,
    envelope limits, kinematics and turbulence, per aircraft."""
    state = pilot.ap_or_asas(state, windn, winde)

    # ---------- Performance model update ----------
    new_perf, bank = perfmod.update(state.perf, state.ac.tas, state.ac.vs,
                                    state.ac.alt)
    state = state.replace(perf=new_perf, ac=state.ac.replace(bank=bank))

    # ---------- Envelope limits ----------
    state = pilot.apply_limits(state, smooth=cfg.smooth)

    # ---------- Kinematics ----------
    accel = perfmod.acceleration(state.perf.phase, state.ac.tas)
    ac = kinematics.update_airspeed(state.ac, state.pilot, accel, simdt,
                                    smooth=cfg.smooth)
    ac = kinematics.update_groundspeed(ac, windn, winde)
    ac = kinematics.update_position(ac, state.pilot, simdt)

    # ---------- Turbulence ----------
    ac = noise.turbulence_woosh(ac, gen, simdt, cfg.noise, smooth=cfg.smooth)

    # Freeze padding slots: inactive rows keep their values bit-exactly.
    live = ac.active
    frz = lambda new, old: torch.where(live, new, old)
    ac = ac.replace(
        lat=frz(ac.lat, state.ac.lat), lon=frz(ac.lon, state.ac.lon),
        alt=frz(ac.alt, state.ac.alt), hdg=frz(ac.hdg, state.ac.hdg),
        trk=frz(ac.trk, state.ac.trk), tas=frz(ac.tas, state.ac.tas),
        gs=frz(ac.gs, state.ac.gs), vs=frz(ac.vs, state.ac.vs))
    return state.replace(ac=ac)


def step(state: SimState, cfg: SimConfig) -> SimState:
    """Advance the simulation by one simdt (eagerly; no host read)."""
    check_config(cfg, state)
    fms, asas, clk = next_clocks(state, cfg)
    gen = None
    if noise_on(cfg):
        gen = torch.Generator(device=state.device)
        gen.manual_seed(noise_seed(state))
    out = step_body(state, cfg, fms, asas, state.simt, gen)
    return out.replace(**clk._asdict())


# --------------------------------------------------------------- multi-world
# World-batched stepping (JAX ``core/step.py:704-874``): a stacked state
# (``stack_worlds``) advances W independent scenarios per step.  The
# per-aircraft parts of the step run once on the W * N aircraft
# (``state.flatten_worlds``), the ASAS interval once for the whole stack
# (``asas.update`` on [W, N, N], ``asas.update_tiled`` with one kernel
# launch per pass for the group).  The gates stay hoisted, as in JAX:
# the host decides per world whether the FMS or ASAS branch is due, runs
# the branch when any world is, and a per-world select keeps the worlds
# that are not due bit for bit.  Per-world clocks may differ, so worlds
# at different sim times batch together.


def check_worlds_config(cfg: SimConfig):
    """World batching runs single-device configurations only: the shard
    modes put per-shard structure on the aircraft axis of one world."""
    if cfg.cd_mesh is not None \
            or cfg.cd_shard_mode in ("spatial", "tiles"):
        raise ValueError(
            "world-batched stepping runs single-device per world: "
            "cd_mesh must be None and cd_shard_mode != "
            "'spatial'/'tiles' (pack refuses sharded pieces — see "
            "WORLDS docs)")


def next_clocks_worlds(clk, cfg: SimConfig):
    """``next_clocks`` of a stacked state (or ``Clocks`` of [W] arrays):
    ``(fms [W], asas [W], Clocks)`` with numpy bool masks, each world's
    decision the one ``next_clocks`` takes for it alone."""
    dt = clk.simt.dtype.type
    simt, t0, tnext = clk.simt, clk.fms_t0, clk.asas_tnext
    fms = (t0 + dt(cfg.fms_dt) < simt) | (simt < t0) | (simt < dt(cfg.fms_dt))
    asas = (simt >= tnext) & bool(cfg.asas.swasas)
    rng = clk.rng
    if noise_on(cfg):
        with np.errstate(over="ignore"):     # the LCG step wraps mod 2**64
            rng = rng * np.uint64(6364136223846793005) \
                + np.uint64(1442695040888963407)
    return fms, asas, Clocks(
        simt=simt + dt(cfg.simdt), fms_t0=np.where(fms, simt, t0),
        asas_tnext=np.where(asas, tnext + dt(cfg.asas.dtasas), tnext),
        rng=rng)


def seed_worlds(gens, rng):
    """Seed one noise generator per world as ``step`` seeds a world alone
    (``noise_seed`` of its pre-step ``rng``), so world w's draws are the
    ones it makes run alone.  Returns ``gens``."""
    for g, r in zip(gens, rng, strict=True):
        g.manual_seed(int(r) % 2 ** 63)
    return gens


def host_to_device(a, device) -> torch.Tensor:
    """A host array (a per-world mask, clock or count) as a tensor on
    ``device``, copied without waiting for the device: through pinned
    memory on a card, whose allocator keeps the block until the copy is
    done."""
    t = torch.from_numpy(np.array(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)



def _wind_worlds(state: SimState, n: int):
    """The wind at every aircraft of a stacked state, world by world."""
    from .state import world_slice
    parts = [windmod.getdata(world_slice(state.wind, w), state.ac.lat[w],
                             state.ac.lon[w], state.ac.alt[w])
             for w in range(state.ac.lat.shape[0])]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def step_body_worlds(state: SimState, cfg: SimConfig, fms: bool,
                     asas: bool, fms_mask, asas_mask, simt,
                     gens) -> SimState:
    """The device part of one step of a stacked state, the gates decided:
    ``fms``/``asas`` whether any world is due, ``fms_mask``/``asas_mask``
    the [W] bool tensors of the worlds that are, ``simt`` the [W]
    pre-step clocks as a tensor on the device, ``gens`` the worlds'
    noise generators (None without noise)."""
    from .state import flatten_worlds, select_worlds, unflatten_worlds
    n = state.ac.lat.shape[1]
    simdt = float(state.simt.dtype.type(cfg.simdt))
    flat = flatten_worlds(state)
    flat = flat.replace(ac=kinematics.update_atmosphere(flat.ac))
    flat = flat.replace(adsb=noise.adsb_update(
        flat.adsb, flat.ac, gens, simt[:, None].expand(-1, n).reshape(-1),
        cfg.noise, smooth=cfg.smooth))
    if fms:
        flat = select_worlds(fms_mask, autopilot.update_fms(flat), flat)
    flat = autopilot.update_continuous(flat)
    if asas:
        state = unflatten_worlds(flat, state)
        if cfg.cd_backend == "dense":
            new, _cd = asasmod.update(state, cfg.asas, smooth=cfg.smooth)
        else:
            impl = asasmod.impl_for_backend(cfg.cd_backend)
            new, _rd = asasmod.update_tiled(state, cfg.asas,
                                            block=cfg.cd_block, impl=impl)
        flat = flatten_worlds(select_worlds(asas_mask, new, state))
    windn = winde = None
    if cfg.use_wind:
        windn, winde = _wind_worlds(state, n)
    return unflatten_worlds(_tail(flat, cfg, simdt, gens, windn, winde),
                            state)


def step_worlds(state: SimState, cfg: SimConfig) -> SimState:
    """One simdt for every world of a stacked state (eagerly; no host
    read).  World w of the result equals ``step`` of world w alone, bit
    for bit, noise included."""
    check_config(cfg, state)
    check_worlds_config(cfg)
    fms, asas, clk = next_clocks_worlds(state, cfg)
    dev = state.device
    gens = seed_worlds([torch.Generator(device=dev) for _ in state.rng],
                       state.rng) if noise_on(cfg) else None
    out = step_body_worlds(state, cfg, bool(fms.any()), bool(asas.any()),
                           host_to_device(fms, dev), host_to_device(asas, dev),
                           host_to_device(state.simt, dev), gens)
    return out.replace(**clk._asdict())

#: Per-aircraft fields the integrity check watches (JAX GUARD_FIELDS).
GUARD_FIELDS = ("lat", "lon", "alt", "tas", "gs", "vs")


def state_finite(state: SimState) -> torch.Tensor:
    """0-d bool tensor on the state's device ([W] for a stacked state):
    every guarded field is finite on the live rows (padding rows are
    excluded).  Reads nothing back to the host."""
    ac = state.ac
    bad = torch.zeros_like(ac.active)
    for f in GUARD_FIELDS:
        bad |= ~torch.isfinite(getattr(ac, f))
    return ~torch.any(bad & ac.active, dim=-1)


# ------------------------------------------------------------ the chunk body

def init_carry(state: SimState, cfg: SimConfig, checked: bool) -> dict:
    """The folds a chunk carries, fresh: ``bad`` (int32, -1) and the step
    index ``i`` for ``checked``, ``st`` (``ScanStats``) for
    ``cfg.scanstats``, ``fp`` (``FingerprintPack``) for
    ``cfg.fingerprint``; tensors on the state's device, with a leading
    [W] for a stacked state."""
    dev = state.device
    carry = {}
    if checked:
        carry["bad"] = torch.full(state.ac.active.shape[:-1], -1,
                                  dtype=torch.int32, device=dev)
        carry["i"] = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.scanstats:
        from ..obs import scanstats
        carry["st"] = scanstats.init(state, cfg)
    if cfg.fingerprint:
        from ..obs import fingerprint
        carry["fp"] = fingerprint.init(state, cfg)
    return carry


def fold_carry(carry: dict, state: SimState, cfg: SimConfig) -> dict:
    """The carry after one step, from the post-step ``state``: the first
    step whose state is not finite on a live row (its index in the
    chunk), the ScanStats and fingerprint folds.  Device tensors only."""
    out = {}
    if "bad" in carry:
        bad, i = carry["bad"], carry["i"]
        out["bad"] = torch.where(bad >= 0, bad,
                                 torch.where(state_finite(state), -1, i))
        out["i"] = i + 1
    if "st" in carry:
        from ..obs import scanstats
        out["st"] = scanstats.fold(carry["st"], state, cfg)
    if "fp" in carry:
        from ..obs import fingerprint
        out["fp"] = fingerprint.fold(carry["fp"], state, cfg)
    return out


class _EagerChunk:
    """The chunk body on the CPU: each step eagerly (``step``, or
    ``step_worlds`` for a stacked state), then the folds."""

    def __init__(self, state: SimState, cfg: SimConfig, checked: bool):
        from .state import is_stacked
        self.cfg, self.state = cfg, state
        self.carry = init_carry(state, cfg, checked)
        self._step = step_worlds if is_stacked(state) else step

    def step(self):
        self.state = self._step(self.state, self.cfg)
        self.carry = fold_carry(self.carry, self.state, self.cfg)

    def apply(self, fn):
        """Replace the state by ``fn(state)`` (the sort refresh)."""
        self.state = fn(self.state)

    def finish(self, keep: bool):
        return self.state, self.carry, _simt_tensor(self.state)


def _simt_tensor(state: SimState) -> torch.Tensor:
    """The host clock of ``state`` as a tensor on its device (0-d, or
    [W] for a stacked state)."""
    return host_to_device(state.simt, state.device)


def _graphed(state: SimState) -> bool:
    """Whether a chunk of ``state`` replays CUDA graphs (a CUDA state)."""
    return state.device.type == "cuda"


def executor(state: SimState, cfg: SimConfig, checked: bool = False,
             keep: bool = False):
    """The chunk executor of ``state``, loaded: ``graph.chunk`` (CUDA
    graphs, with its donation rules) on a CUDA state, ``_EagerChunk``
    otherwise.  Its ``step()`` advances one step with the folds,
    ``state`` is the current state and ``finish(keep)`` ends the chunk
    (``(state, carry, simt)``)."""
    from . import graph
    if _graphed(state):
        return graph.chunk(state, cfg, checked, keep)
    graph.eager_lookup(state, cfg, checked, keep)
    return _EagerChunk(state, cfg, checked)


# ---------------------------------------------------------- in-scan refresh

def inscan_refresh_active(cfg: SimConfig) -> bool:
    """True when this config folds the sort refresh into the chunk: the
    flag is on, the backend is 'sparse' (the tiled/pallas Morton refresh
    stays host-called) and ASAS runs.  Callers pivot output arity on
    it."""
    return bool(cfg.inscan_refresh and cfg.asas.swasas
                and cfg.cd_backend == "sparse")


class RefreshPack(NamedTuple):
    """The in-chunk refresh record, returned at the chunk edge.

    * ``sort_t``: sim time of the most recent refresh, a host scalar in
      the state's dtype (-1 = never); the next chunk takes it as
      ``sort_t0``.  The due gate is decided on the host, from the host
      clocks, like the FMS and ASAS gates.
    * ``count``: int32 refreshes fired in this chunk.
    * ``guard``: int32 guard word, the OR of bit 1 (a stripe holds more
      aircraft than its shard's caller rows), bit 2 (halo coverage or a
      tile budget violated) and bit 4 (a tile overloaded): a violating
      refresh is skipped on the device and the host falls back at the
      edge.
    * ``newslot``: the composed old -> new caller slot bijection of the
      chunk's spatial or tiles refreshes ([n] int32); empty ``[0]``
      otherwise.  The host applies it to its slot tables once per chunk.
    """
    sort_t: np.floating
    count: torch.Tensor
    guard: torch.Tensor
    newslot: torch.Tensor


def refresh_due(simt, sort_t, cfg: SimConfig) -> np.ndarray:
    """The refresh gate of the JAX chunk, on host scalars in the state's
    dtype ([W] arrays for a stacked state): never refreshed, or
    ``sort_every * dtasas`` elapsed.  A numpy bool (array)."""
    dt = np.asarray(simt).dtype.type
    period = dt(float(cfg.asas.sort_every * cfg.asas.dtasas))
    return np.asarray((sort_t < dt(0.0)) | (simt - sort_t >= period))


# --------------------------------------------------------------- the runners

def _run_chunk(state: SimState, cfg: SimConfig, nsteps: int, checked: bool,
               sort_t0=None, keep: bool = False):
    """The one chunk body of every runner: ``nsteps`` steps, each after
    the in-scan refresh when due and before the carry folds.  Returns
    ``(state, carry, simt, refresh)``: ``simt`` the end clock as a
    tensor on the device (the graph buffer's copy on a CUDA state),
    ``refresh`` a ``RefreshPack`` or None.  A stacked state steps every
    world (``step_worlds``); its refresh gate is per world."""
    from .state import is_stacked, select_worlds
    check_config(cfg, state)
    ex = executor(state, cfg, checked, keep)
    inscan = inscan_refresh_active(cfg)
    worlds = is_stacked(state)
    dt = state.simt.dtype
    sort_t = np.full(np.shape(state.simt), -1.0, dt) if sort_t0 is None \
        else np.array(sort_t0, dtype=dt)
    count = np.zeros(np.shape(state.simt), np.int32)
    block = min(cfg.cd_block, 256)
    refresh = lambda s: asasmod.inscan_sparse_refresh(s, cfg.asas,
                                                      block=block)
    shard = (not worlds) and cfg.cd_shard_mode in ("spatial", "tiles")
    i32 = dict(dtype=torch.int32, device=state.device)
    lead = np.shape(count)
    guard = torch.zeros(lead, **i32)
    newslot = torch.arange(state.nmax, **i32) if shard \
        else torch.zeros(lead + (0,), **i32)

    def shard_refresh(s):
        """The spatial or tiles refresh; its bijection and guard bits
        compose into the chunk's."""
        nonlocal newslot, guard
        if cfg.cd_shard_mode == "tiles":
            s2, ns, gbits = asasmod.inscan_tile_refresh(
                s, cfg.asas, cfg.cd_tile_shape, block=block,
                budgets=cfg.cd_tile_budgets)
        else:
            s2, ns, gbits = asasmod.inscan_spatial_refresh(
                s, cfg.asas, cfg.cd_mesh.shape[cfg.cd_mesh_axis],
                block=block, halo_blocks=cfg.cd_halo_blocks)
        newslot = ns[newslot.long()]
        guard = guard | gbits
        return s2

    for _ in range(nsteps):
        if inscan:
            simt = ex.state.simt
            due = refresh_due(simt, sort_t, cfg)
            if due.any():
                # sort_t advances on a guarded (skipped) refresh too: the
                # edge falls back anyway
                sort_t = np.where(due, simt, sort_t).astype(dt)
                count = count + due
                if worlds:
                    mask = host_to_device(due, state.device)
                    ex.apply(lambda s: select_worlds(mask, refresh(s), s))
                else:
                    ex.apply(shard_refresh if shard else refresh)
        ex.step()
    state, carry, simt = ex.finish(keep)
    rpack = None
    if inscan:
        rpack = RefreshPack(
            sort_t=sort_t if worlds else sort_t[()],
            count=host_to_device(count, state.device),
            guard=guard, newslot=newslot)
    return state, carry, simt, rpack


def run_steps(state: SimState, cfg: SimConfig, nsteps: int) -> SimState:
    """Advance ``nsteps`` steps (with the in-scan refresh when
    ``inscan_refresh_active(cfg)``).  On a CUDA state the input may be
    overwritten and the result lives in the graph buffers (module
    docstring)."""
    cfg = cfg._replace(scanstats=False, fingerprint=False)
    return _run_chunk(state, cfg, nsteps, checked=False)[0]


def run_steps_checked(state: SimState, cfg: SimConfig, nsteps: int):
    """``run_steps`` with the integrity guard folded in: returns
    ``(state, bad)``, ``bad`` an int32 0-d tensor on the device holding
    the index (0-based in the chunk) of the first step whose post-step
    state had a non-finite guarded value on a live row, or -1.  The
    index is a device counter, so nothing is read back."""
    cfg = cfg._replace(scanstats=False, fingerprint=False)
    state, carry, _, _ = _run_chunk(state, cfg, nsteps, checked=True)
    return state, carry["bad"]


class EdgeTelemetry(NamedTuple):
    """Packed chunk-edge telemetry: what the host's chunk-edge consumers
    read from the device.  Every field is a buffer of its own, never an
    alias of a state tensor, so it survives the next chunk."""
    simt: torch.Tensor       # [s] sim time at the chunk edge (0-d)
    bad: torch.Tensor        # int32 first bad step in chunk, -1 = clean
    nconf_cur: torch.Tensor  # int32 directional conflict count
    nlos_cur: torch.Tensor   # int32 directional LoS count
    active: torch.Tensor
    lat: torch.Tensor
    lon: torch.Tensor
    alt: torch.Tensor
    hdg: torch.Tensor
    trk: torch.Tensor
    tas: torch.Tensor
    gs: torch.Tensor
    cas: torch.Tensor
    vs: torch.Tensor
    inconf: torch.Tensor
    tcpamax: torch.Tensor
    asasn: torch.Tensor
    asase: torch.Tensor


def pack_telemetry(state: SimState, bad=None, simt=None) -> EdgeTelemetry:
    """Copy the edge fields of a post-chunk state into new buffers:
    ``simt`` a 0-d tensor (default: the host clock on the device), ``bad``
    the checked runner's word (default -1); every field gains a leading
    [W] for a stacked state."""
    ac, asas = state.ac, state.asas
    if bad is None:
        bad = torch.full(ac.active.shape[:-1], -1, dtype=torch.int32,
                         device=state.device)
    if simt is None:
        simt = _simt_tensor(state)
    c = torch.clone
    return EdgeTelemetry(
        simt=c(simt), bad=c(bad), nconf_cur=c(asas.nconf_cur),
        nlos_cur=c(asas.nlos_cur), active=c(ac.active), lat=c(ac.lat),
        lon=c(ac.lon), alt=c(ac.alt), hdg=c(ac.hdg), trk=c(ac.trk),
        tas=c(ac.tas), gs=c(ac.gs), cas=c(ac.cas), vs=c(ac.vs),
        inconf=c(asas.inconf), tcpamax=c(asas.tcpamax),
        asasn=c(asas.asasn), asase=c(asas.asase))


def _edge(state, cfg, nsteps, checked, sort_t0, keep):
    """``(state, telemetry)`` extended with the ScanStats pack when
    ``cfg.scanstats``, the ``RefreshPack`` when
    ``inscan_refresh_active(cfg)`` and the ``FingerprintPack`` when
    ``cfg.fingerprint``, in that order, as in JAX."""
    state, carry, simt, refresh = _run_chunk(state, cfg, nsteps, checked,
                                             sort_t0, keep)
    out = (state, pack_telemetry(state, carry.get("bad"), simt))
    if "st" in carry:
        out += (carry["st"],)
    if refresh is not None:
        out += (refresh,)
    if "fp" in carry:
        out += (carry["fp"],)
    return out


def run_steps_edge(state: SimState, cfg: SimConfig, nsteps: int,
                   checked: bool = False, sort_t0=None):
    """``run_steps`` (or the checked chunk, ``checked=True``) returning
    ``(state, EdgeTelemetry[, ScanStats][, RefreshPack]
    [, FingerprintPack])``; the packs are buffers of their own.
    ``sort_t0`` (host scalar, the previous chunk's ``RefreshPack.sort_t``)
    seeds the in-scan refresh gate.  The input is donated as in
    ``run_steps``."""
    return _edge(state, cfg, nsteps, checked, sort_t0, keep=False)


def run_steps_edge_keep(state: SimState, cfg: SimConfig, nsteps: int,
                        checked: bool = False, sort_t0=None):
    """``run_steps_edge`` without donation: the input's tensors, and every
    state a runner returned before, stay as they were."""
    return _edge(state, cfg, nsteps, checked, sort_t0, keep=True)



# ------------------------------------------------------- the world runners
# The runners above take a stacked state as they take a single one; these
# are the JAX package's names for that use (``run_steps_worlds*``), with
# the world axis required.  ``bad`` is then a [W] vector of first bad
# steps, so a trip names the (world, step) pair; the telemetry and packs
# gain a leading [W] (``world_slice`` demuxes them), and ``sort_t0`` is a
# [W] array of the worlds' last refresh times.


def _require_stacked(state: SimState):
    from .state import is_stacked
    if not is_stacked(state):
        raise ValueError("the world runners take a stacked state "
                         "(stack_worlds); use run_steps for one world")


def run_steps_worlds(state: SimState, cfg: SimConfig, nsteps: int):
    """``run_steps`` over a stacked state: W scenarios advance ``nsteps``
    steps together; world w equals its ``run_steps`` alone, bit for bit."""
    _require_stacked(state)
    return run_steps(state, cfg, nsteps)


def run_steps_worlds_checked(state: SimState, cfg: SimConfig, nsteps: int):
    """``run_steps_checked`` over a stacked state: ``(state, bad)`` with
    ``bad`` [W] int32, each world's first bad step or -1."""
    _require_stacked(state)
    return run_steps_checked(state, cfg, nsteps)


def run_steps_worlds_edge(state: SimState, cfg: SimConfig, nsteps: int,
                          checked: bool = False, sort_t0=None):
    """``run_steps_edge`` over a stacked state: the telemetry and packs
    carry a leading [W]."""
    _require_stacked(state)
    return run_steps_edge(state, cfg, nsteps, checked, sort_t0)


def run_steps_worlds_edge_keep(state: SimState, cfg: SimConfig, nsteps: int,
                               checked: bool = False, sort_t0=None):
    """``run_steps_worlds_edge`` without donation."""
    _require_stacked(state)
    return run_steps_edge_keep(state, cfg, nsteps, checked, sort_t0)
