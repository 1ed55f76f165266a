"""The simulation state: a padded struct-of-arrays of tensors.

Port of ``bluesky_tpu/core/state.py``.  Every per-aircraft tensor has the
fixed shape ``[N_max]`` (waypoint tables ``[N_max, W_max]``) and a bool
``active`` mask marks live slots; create and delete are slot writes and
mask flips, never reshapes.  Callsigns and types stay in the host-side
``Traffic`` facade.

The sub-structures are ``@dataclass``es of tensors with a ``replace``.
Two fields differ from the JAX state on purpose:

* ``simt``, ``fms_t0`` and ``asas_tnext`` are host scalars (numpy, in the
  state's dtype).  The step decides its FMS and ASAS gates on the host
  from them, bit for bit as the JAX device expressions would, so a chunk
  never waits for the device to learn which branch to take.
* ``rng`` is an integer seed.  The JAX PRNG key has no torch counterpart;
  the noise paths (off by default) draw from a ``torch.Generator``
  seeded with it.  ``state_from_numpy``/``state_to_numpy`` map the key
  ``[hi, lo]`` to the seed ``hi << 32 | lo`` and back, bit-exactly.
"""
import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..ops import aero

#: worst-case extra padded slots of the sparse backend's stripe-sorted
#: layout: 32 pad blocks of <= 256 slots plus block rounding
#: (ops/cd_sched.stripe_sort_dest with block <= 256, extra_blocks = 32).
SORT_PAD = 33 * 256


class _Struct:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class AircraftArrays(_Struct):
    """Kinematic + autopilot-selection state, one row per aircraft slot."""
    active: torch.Tensor
    lat: torch.Tensor
    lon: torch.Tensor
    alt: torch.Tensor
    hdg: torch.Tensor
    trk: torch.Tensor
    tas: torch.Tensor
    gs: torch.Tensor
    gsnorth: torch.Tensor
    gseast: torch.Tensor
    cas: torch.Tensor
    mach: torch.Tensor
    vs: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    temp: torch.Tensor
    selspd: torch.Tensor
    selalt: torch.Tensor
    selvs: torch.Tensor
    swlnav: torch.Tensor
    swvnav: torch.Tensor
    apvsdef: torch.Tensor
    aphi: torch.Tensor
    ax: torch.Tensor
    bank: torch.Tensor
    swhdgsel: torch.Tensor
    swaltsel: torch.Tensor
    abco: torch.Tensor
    belco: torch.Tensor
    coslat: torch.Tensor


@dataclass
class ActWpArrays(_Struct):
    """Active-leg guidance state."""
    lat: torch.Tensor
    lon: torch.Tensor
    nextaltco: torch.Tensor
    xtoalt: torch.Tensor
    spd: torch.Tensor
    vs: torch.Tensor
    turndist: torch.Tensor
    flyby: torch.Tensor
    next_qdr: torch.Tensor


@dataclass
class AutopilotArrays(_Struct):
    """FMS guidance output state."""
    trk: torch.Tensor
    tas: torch.Tensor
    alt: torch.Tensor
    vs: torch.Tensor
    dist2vs: torch.Tensor
    swvnavvs: torch.Tensor
    vnavvs: torch.Tensor


@dataclass
class PilotArrays(_Struct):
    """AP-vs-ASAS arbitrated targets."""
    alt: torch.Tensor
    hdg: torch.Tensor
    trk: torch.Tensor
    vs: torch.Tensor
    tas: torch.Tensor


@dataclass
class AsasArrays(_Struct):
    """Conflict detection & resolution state.

    ``resopairs`` is the dense backend's [N, N] pair matrix ([0, 0]
    without ``pair_matrix``); ``partners`` the caller-space [N, K]
    partner table of the pallas and tiled backends; ``partners_s`` the
    sparse backend's table in the padded stripe-sorted slot space
    ([N + SORT_PAD, K] int32, -1 empty); ``sort_perm`` the cached sort
    (the stripe destinations, caller slot -> sorted slot, for sparse;
    the Morton permutation, sorted position -> caller slot, for pallas
    and tiled)."""
    trk: torch.Tensor
    tas: torch.Tensor
    vs: torch.Tensor
    alt: torch.Tensor
    active: torch.Tensor
    inconf: torch.Tensor
    tcpamax: torch.Tensor
    resopairs: torch.Tensor
    partners: torch.Tensor
    asasn: torch.Tensor
    asase: torch.Tensor
    noreso: torch.Tensor
    resooff: torch.Tensor
    nconf_cur: torch.Tensor
    nlos_cur: torch.Tensor
    sort_perm: torch.Tensor
    partners_s: torch.Tensor


@dataclass
class RouteArrays(_Struct):
    """Dense per-aircraft flight plans: [N_max, W_max] waypoint tables."""
    wplat: torch.Tensor
    wplon: torch.Tensor
    wpalt: torch.Tensor
    wpspd: torch.Tensor
    wpflyby: torch.Tensor
    wptoalt: torch.Tensor
    wpxtoalt: torch.Tensor
    nwp: torch.Tensor
    iactwp: torch.Tensor


@dataclass
class PerfArrays(_Struct):
    """OpenAP-style performance model columns and outputs."""
    mass: torch.Tensor
    sref: torch.Tensor
    engthrust: torch.Tensor
    engbpr: torch.Tensor
    ff_a: torch.Tensor
    ff_b: torch.Tensor
    ff_c: torch.Tensor
    engnum: torch.Tensor
    cd0_clean: torch.Tensor
    cd0_gd: torch.Tensor
    cd0_to: torch.Tensor
    cd0_ic: torch.Tensor
    cd0_ap: torch.Tensor
    cd0_ld: torch.Tensor
    k: torch.Tensor
    vminto: torch.Tensor
    vminic: torch.Tensor
    vminer: torch.Tensor
    vminap: torch.Tensor
    vminld: torch.Tensor
    vmaxto: torch.Tensor
    vmaxic: torch.Tensor
    vmaxer: torch.Tensor
    vmaxap: torch.Tensor
    vmaxld: torch.Tensor
    vsmin: torch.Tensor
    vsmax: torch.Tensor
    hmax: torch.Tensor
    axmax: torch.Tensor
    islifttype_rotor: torch.Tensor
    phase: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor
    thrust: torch.Tensor
    drag: torch.Tensor
    fuelflow: torch.Tensor


@dataclass
class SimState(_Struct):
    """Top-level simulation state (see the module docstring for the
    host-side clocks and the integer ``rng`` seed)."""
    ac: AircraftArrays
    actwp: ActWpArrays
    ap: AutopilotArrays
    pilot: PilotArrays
    asas: AsasArrays
    route: RouteArrays
    perf: PerfArrays
    adsb: Any
    wind: Any
    rng: int
    simt: np.floating
    fms_t0: np.floating
    asas_tnext: np.floating

    @property
    def nmax(self) -> int:
        return self.ac.lat.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ac.lat.device


def make_state(nmax: int = 64, wmax: int = 32, dtype=torch.float32,
               rng_seed: int = 0, pair_matrix: bool = True,
               k_partners: int = 8, device=None) -> SimState:
    """Allocate an empty padded simulation state on ``device`` (CUDA by
    default).  ``pair_matrix`` allocates the dense backend's [nmax, nmax]
    ``resopairs`` (else [0, 0]: large fleets on the blockwise backends
    pass False); the partner tables take ``k_partners`` columns (the
    CUDA kernels of the sparse and pallas backends take 8).  Padding
    slots hold benign values so the math stays NaN-free without
    branching."""
    dev = resolve_device(device)
    f = lambda: torch.zeros(nmax, dtype=dtype, device=dev)
    full = lambda v: torch.full((nmax,), v, dtype=dtype, device=dev)
    b = lambda: torch.zeros(nmax, dtype=torch.bool, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    rad25 = float(np.radians(25.0))

    ac = AircraftArrays(
        active=b(), lat=f(), lon=f(), alt=f(), hdg=f(), trk=f(),
        tas=f(), gs=f(), gsnorth=f(), gseast=f(), cas=f(), mach=f(), vs=f(),
        p=f(), rho=f(), temp=f(),
        selspd=f(), selalt=f(), selvs=f(),
        swlnav=b(), swvnav=b(),
        apvsdef=full(1500.0 * aero.fpm), aphi=full(rad25),
        ax=full(aero.kts), bank=full(rad25),
        swhdgsel=b(), swaltsel=b(),
        abco=b(), belco=torch.ones(nmax, dtype=torch.bool, device=dev),
        coslat=full(1.0),
    )
    actwp = ActWpArrays(
        lat=full(89.99), lon=f(), nextaltco=f(), xtoalt=f(),
        spd=full(-999.0), vs=f(), turndist=full(1.0), flyby=full(1.0),
        next_qdr=full(-999.0))
    ap = AutopilotArrays(trk=f(), tas=f(), alt=f(), vs=f(),
                         dist2vs=full(-999.0), swvnavvs=b(), vnavvs=f())
    pilot = PilotArrays(alt=f(), hdg=f(), trk=f(), vs=f(), tas=f())
    asas = AsasArrays(
        trk=f(), tas=f(), vs=f(), alt=f(),
        active=b(), inconf=b(), tcpamax=f(),
        resopairs=torch.zeros((nmax, nmax) if pair_matrix else (0, 0),
                              dtype=torch.bool, device=dev),
        partners=torch.full((nmax, k_partners), -1, **i32),
        asasn=f(), asase=f(), noreso=b(), resooff=b(),
        nconf_cur=torch.zeros((), **i32), nlos_cur=torch.zeros((), **i32),
        sort_perm=torch.arange(nmax, **i32),
        partners_s=torch.full((nmax + SORT_PAD, k_partners), -1, **i32))
    tab = lambda v: torch.full((nmax, wmax), v, dtype=dtype, device=dev)
    route = RouteArrays(
        wplat=tab(89.99), wplon=tab(0.0), wpalt=tab(-999.0),
        wpspd=tab(-999.0), wpflyby=tab(1.0), wptoalt=tab(-999.0),
        wpxtoalt=tab(0.0), nwp=torch.zeros(nmax, **i32),
        iactwp=torch.full((nmax,), -1, **i32))
    from ..models import perf_coeffs
    from . import noise, wind as windmod
    npd = torch.empty((), dtype=dtype).numpy().dtype.type
    return SimState(
        ac=ac, actwp=actwp, ap=ap, pilot=pilot, asas=asas, route=route,
        perf=perf_coeffs.empty_perf_arrays(nmax, dtype, dev),
        adsb=noise.make_adsb(nmax, dtype, dev),
        wind=windmod.make_windstate(dtype=dtype, device=dev),
        rng=int(rng_seed), simt=npd(0.0), fms_t0=npd(-999.0),
        asas_tnext=npd(0.0))


_CLOCKS = ("simt", "fms_t0", "asas_tnext")


def state_to_numpy(state: SimState) -> dict:
    """``{dotted.path: np.ndarray}`` of every leaf, in the layout of a JAX
    ``SimState`` flattened with ``tree_leaves_with_path`` (``rng`` as the
    two-word uint32 key)."""
    out = {}

    def walk(obj, prefix):
        for fld in dataclasses.fields(obj):
            v = getattr(obj, fld.name)
            key = prefix + fld.name
            if dataclasses.is_dataclass(v):
                walk(v, key + ".")
            elif isinstance(v, torch.Tensor):
                out[key] = v.detach().cpu().numpy()
            elif fld.name == "rng":      # [2], or [W, 2] for a stack
                v = np.asarray(v, dtype=np.uint64)
                out[key] = np.stack([v >> np.uint64(32),
                                     v & np.uint64(0xFFFFFFFF)],
                                    -1).astype(np.uint32)
            else:
                out[key] = np.asarray(v)

    walk(state, "")
    return out


def state_from_numpy(tree: dict, device=None) -> SimState:
    """Inverse of ``state_to_numpy``: build the port's state from a
    ``{dotted.path: np.ndarray}`` dict (e.g. a flattened JAX SimState) on
    ``device`` (CUDA by default).  Bit-exact."""
    dev = resolve_device(device)
    from . import noise, wind as windmod
    classes = dict(ac=AircraftArrays, actwp=ActWpArrays,
                   ap=AutopilotArrays, pilot=PilotArrays, asas=AsasArrays,
                   route=RouteArrays, perf=PerfArrays,
                   adsb=noise.AdsbArrays, wind=windmod.WindState)
    subs = {}
    for name, cls in classes.items():
        subs[name] = cls(**{
            fld.name: torch.from_numpy(
                np.array(tree[f"{name}.{fld.name}"], copy=True)).to(dev)
            for fld in dataclasses.fields(cls)})
    key = np.asarray(tree["rng"], np.uint64)
    rng = (key[..., 0] << np.uint64(32)) | key[..., 1]
    rng = int(rng) if rng.ndim == 0 else rng
    clocks = {c: np.asarray(tree[c])[()] for c in _CLOCKS}
    return SimState(rng=rng, **subs, **clocks)


# ------------------------------------------------------------- the world axis
# A stacked state (``stack_worlds``) holds W same-shape states: every
# tensor gains a leading [W] axis, the host clocks become [W] numpy
# arrays in the state's dtype and ``rng`` a [W] uint64 array, so worlds
# at different sim times batch together (JAX ``core/step.py:730-755``).


def _tree_map(fn, obj, *rest, name=""):
    """``obj`` (a dataclass, NamedTuple, tuple or leaf) with every leaf
    replaced by ``fn(name, leaf, *leaves of rest)``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _tree_map(fn, getattr(obj, f.name),
                              *[getattr(r, f.name) for r in rest],
                              name=f.name)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_tree_map(fn, getattr(obj, k),
                                     *[getattr(r, k) for r in rest], name=k)
                           for k in obj._fields])
    if isinstance(obj, (tuple, list)):
        return type(obj)(_tree_map(fn, *xs) for xs in zip(obj, *rest))
    return fn(name, obj, *rest)


def stack_worlds(states):
    """Stack same-shape states (or packs: any dataclass or NamedTuple of
    tensors and host scalars) into one with a leading [W] axis."""
    states = list(states)
    if not states:
        raise ValueError("stack_worlds: need at least one world")

    def stack(name, *xs):
        x = xs[0]
        if isinstance(x, torch.Tensor):
            return torch.stack(xs)
        if x is None:
            return None
        if name == "rng":
            return np.array([int(v) for v in xs], dtype=np.uint64)
        return np.stack([np.asarray(v) for v in xs])

    return _tree_map(stack, *states)


def world_slice(wtree, w: int):
    """World ``w``'s slice of any stacked state or pack (telemetry,
    ScanStats, FingerprintPack, RefreshPack): tensors ``x[w]``, host
    clocks their ``w``-th scalar, ``rng`` a Python int."""
    def take(name, x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return int(x[w]) if name == "rng" else x[w]
        return x
    return _tree_map(take, wtree)


def unstack_worlds(wstate):
    """Split a stacked state back into per-world states."""
    return [world_slice(wstate, w) for w in range(len(wstate.simt))]


def is_stacked(state) -> bool:
    """Whether ``state`` carries a leading world axis."""
    return state.ac.lat.ndim == 2


def flatten_worlds(state):
    """The stacked ``state`` as one fleet of W * N aircraft: every tensor
    of two or more dimensions has its world and aircraft axes merged (a
    view), the [W] per-world scalars stay.  The per-aircraft step
    functions run on it unchanged; partner ids keep their world-local
    values."""
    def flat(name, x):
        if isinstance(x, torch.Tensor) and x.ndim >= 2:
            return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
        return x
    return _tree_map(flat, state)


def unflatten_worlds(flat, like):
    """Inverse of ``flatten_worlds``: ``flat``'s tensors in the shapes
    of ``like``'s (a stacked state), its host side from ``like``."""
    def back(name, x, ref):
        if isinstance(ref, torch.Tensor):
            return x.reshape(ref.shape)
        return ref
    return _tree_map(back, flat, like)


def select_worlds(mask: torch.Tensor, new, old):
    """Per-world select: ``mask`` is a [W] bool tensor; the tensors of
    ``new`` and ``old`` (stacked or flattened, world-major) take the new
    values on the worlds where it is True and keep the old ones bit for
    bit elsewhere.  A tensor ``new`` shares with ``old`` is kept."""
    nw = mask.shape[0]

    def sel(name, a, b):
        if not isinstance(a, torch.Tensor) or a is b:
            return a
        m = mask.reshape(nw, 1)
        return torch.where(m, a.reshape(nw, -1), b.reshape(nw, -1)) \
            .reshape(a.shape)
    return _tree_map(sel, new, old)
