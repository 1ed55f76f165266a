"""The simulation step on tensors.

Port of ``bluesky_tpu/core/step.py`` for the slice the port runs: one
device, the four CD backends (``dense``, ``tiled``, ``pallas``,
``sparse``), the resolvers MVP, EBY, SWARM and SSD.
Pipeline order per step (reference traffic.py:383-423): atmosphere ->
ADS-B -> FMS (gated) -> ASAS CD&R (gated) -> AP/ASAS arbitration ->
performance update -> envelope limits -> airspeed -> groundspeed (wind)
-> position -> turbulence.

The FMS and ASAS gates are decided on the host from the state's host
clocks (``simt``, ``fms_t0``, ``asas_tnext``, numpy scalars in the
state's dtype), with the same expressions the JAX step evaluates on the
device, so every decision is the JAX one bit for bit and a chunk never
waits for the device to learn which branch to take.  PyTorch runs
eagerly, so ``run_steps`` is a loop of ``step`` calls.
"""
from typing import NamedTuple

import torch

from . import asas as asasmod
from . import autopilot, kinematics, noise, perf as perfmod, pilot
from . import wind as windmod
from .asas import AsasConfig
from .noise import NoiseConfig
from .state import SimState

class SimConfig(NamedTuple):
    """Simulation configuration (the fields of the JAX ``SimConfig`` that
    the port reads, with its defaults; the mesh, shard-mode,
    differentiable, in-scan telemetry/refresh and fingerprint options are
    not ported).  ``cd_backend``: ``"dense"`` materialises [N, N] pair
    matrices (fine to ~16k aircraft; needs ``Traffic(pair_matrix=True)``),
    ``"tiled"`` streams [cd_block, cd_block] tiles with an [N, K] partner
    table, ``"pallas"`` is the tiled scheme on the CUDA tile kernels and
    ``"sparse"`` the segment-scheduled kernels with the stripe sort."""
    simdt: float = 0.05          # [s] (reference simulation.py:15)
    fms_dt: float = autopilot.FMS_DT
    asas: AsasConfig = AsasConfig()
    noise: NoiseConfig = NoiseConfig()
    use_wind: bool = False
    cd_backend: str = "dense"
    cd_block: int = 512


def check_config(cfg: SimConfig, state: SimState):
    """Raise for a configuration the port cannot run on ``state`` (the
    one-device checks of the JAX step)."""
    if not cfg.asas.swasas:
        return
    if cfg.cd_backend not in ("dense", "tiled", "pallas", "sparse"):
        raise ValueError(
            f"Unknown SimConfig.cd_backend {cfg.cd_backend!r}; expected "
            "'dense', 'tiled', 'pallas' or 'sparse'.")
    if cfg.cd_backend == "dense" and state.asas.resopairs.numel() == 0:
        raise ValueError(
            "State was allocated with pair_matrix=False (no [N,N] "
            "resopairs) but SimConfig.cd_backend is 'dense'. Use "
            "SimConfig(cd_backend='tiled') or allocate "
            "Traffic(pair_matrix=True).")
    asasmod.require_resolver(cfg.asas)


def fms_due(state: SimState, fms_dt: float) -> bool:
    """The FMS gate of the JAX step, on the host clocks in their dtype."""
    dt = state.simt.dtype.type
    simt, t0 = state.simt, state.fms_t0
    return bool((t0 + dt(fms_dt) < simt) | (simt < t0) | (simt < dt(fms_dt)))


def asas_due(state: SimState) -> bool:
    """The ASAS gate of the JAX step, on the host clocks."""
    return bool(state.simt >= state.asas_tnext)


def _next_seed(seed: int) -> int:
    """Advance the noise seed (a 64-bit LCG step)."""
    return (seed * 6364136223846793005 + 1442695040888963407) % 2 ** 64


def step(state: SimState, cfg: SimConfig) -> SimState:
    """Advance the simulation by one simdt."""
    check_config(cfg, state)
    dt = state.simt.dtype.type
    simt = state.simt
    simdt = float(dt(cfg.simdt))

    # ---------- Atmosphere ----------
    state = state.replace(ac=kinematics.update_atmosphere(state.ac))

    # ---------- ADS-B broadcast model ----------
    gen = None
    if cfg.noise.turb_active or cfg.noise.adsb_transnoise:
        gen = torch.Generator(device=state.device)
        gen.manual_seed(state.rng % 2 ** 63)
        state = state.replace(rng=_next_seed(state.rng))
    state = state.replace(adsb=noise.adsb_update(
        state.adsb, state.ac, gen, simt, cfg.noise))

    # ---------- FMS / autopilot, gated at fms_dt ----------
    if fms_due(state, cfg.fms_dt):
        state = autopilot.update_fms(state).replace(fms_t0=simt)
    state = autopilot.update_continuous(state)

    # ---------- ASAS CD&R, gated at dtasas ----------
    if cfg.asas.swasas and asas_due(state):
        if cfg.cd_backend == "dense":
            state, _cd = asasmod.update(state, cfg.asas)
        else:
            impl = asasmod.impl_for_backend(cfg.cd_backend)
            state, _rd = asasmod.update_tiled(state, cfg.asas,
                                              block=cfg.cd_block, impl=impl)
        state = state.replace(asas_tnext=state.asas_tnext
                              + dt(cfg.asas.dtasas))

    # ---------- Pilot arbitration ----------
    if cfg.use_wind:
        windn, winde = windmod.getdata(state.wind, state.ac.lat,
                                       state.ac.lon, state.ac.alt)
    else:
        windn = winde = None
    state = pilot.ap_or_asas(state, windn, winde)

    # ---------- Performance model update ----------
    new_perf, bank = perfmod.update(state.perf, state.ac.tas, state.ac.vs,
                                    state.ac.alt)
    state = state.replace(perf=new_perf, ac=state.ac.replace(bank=bank))

    # ---------- Envelope limits ----------
    state = pilot.apply_limits(state)

    # ---------- Kinematics ----------
    accel = perfmod.acceleration(state.perf.phase, state.ac.tas)
    ac = kinematics.update_airspeed(state.ac, state.pilot, accel, simdt)
    ac = kinematics.update_groundspeed(ac, windn, winde)
    ac = kinematics.update_position(ac, state.pilot, simdt)

    # ---------- Turbulence ----------
    ac = noise.turbulence_woosh(ac, gen, simdt, cfg.noise)

    # Freeze padding slots: inactive rows keep their values bit-exactly.
    live = ac.active
    frz = lambda new, old: torch.where(live, new, old)
    ac = ac.replace(
        lat=frz(ac.lat, state.ac.lat), lon=frz(ac.lon, state.ac.lon),
        alt=frz(ac.alt, state.ac.alt), hdg=frz(ac.hdg, state.ac.hdg),
        trk=frz(ac.trk, state.ac.trk), tas=frz(ac.tas, state.ac.tas),
        gs=frz(ac.gs, state.ac.gs), vs=frz(ac.vs, state.ac.vs))
    return state.replace(ac=ac, simt=simt + dt(cfg.simdt))


def run_steps(state: SimState, cfg: SimConfig, nsteps: int) -> SimState:
    """Advance ``nsteps`` steps."""
    check_config(cfg, state)
    for _ in range(nsteps):
        state = step(state, cfg)
    return state


#: Per-aircraft fields the integrity check watches (JAX GUARD_FIELDS).
GUARD_FIELDS = ("lat", "lon", "alt", "tas", "gs", "vs")


def state_finite(state: SimState) -> bool:
    """Every guarded field is finite on the live rows."""
    ac = state.ac
    bad = torch.zeros_like(ac.active)
    for f in GUARD_FIELDS:
        bad |= ~torch.isfinite(getattr(ac, f))
    return not bool((bad & ac.active).any())
