"""Shared helpers of the ``test_torch_*`` parity tests: moving a JAX
``SimState`` to numpy in the ``{dotted.path: array}`` layout the port's
``state_from_numpy`` reads, building the same scene in both packages
from numpy-seeded inputs, and comparing stepped states field by field.

The parity tests run on the CPU: JAX through its CPU backend (Pallas
kernels in interpret mode), the port with ``device="cpu"``, where each
kernel wrapper runs its plain PyTorch version.  JAX is imported only
where a helper needs it, so the GPU-only kernel tests can use this
module on a machine without JAX.

Importing it sets torch's intra-op threads to one for the test process.
The parity tests run at small sizes, where more threads gain nothing
(``tests/test_torch_work_items.py``: 25 s alone with one thread or
eight), while under the test runner's six workers eight spinning
OpenMP threads a worker oversubscribe the cores (the same file: 1024 s
in the full run; the whole run 1049 s against 345 s with one thread).
"""
import re

import numpy as np
import torch

torch.set_num_threads(1)

NM, FT = 1852.0, 0.3048


def jax_tree_to_numpy(state) -> dict:
    """``{dotted.path: np.ndarray}`` of every leaf of a JAX pytree."""
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        out[jax.tree_util.keystr(path).lstrip(".")] = np.asarray(leaf)
    return out


def scene(n, geom="box", seed=0):
    """Per-aircraft creation inputs (lat, lon, hdg, alt, cas) for ``n``
    aircraft, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    if geom == "clump":
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 0.6 * np.sqrt(rng.random(n))
        lat = 52.6 + r * np.cos(ang)
        lon = 5.4 + r * np.sin(ang) / 0.6
    elif geom == "equator":
        lat = rng.uniform(-2.0, 2.0, n)
        lon = rng.uniform(-3.0, 3.0, n)
    elif geom == "cluster":                 # conflicts in the first step
        lat = rng.uniform(51.85, 52.15, n)
        lon = rng.uniform(3.8, 4.2, n)
    else:                                   # a few stripes wide
        lat = rng.uniform(50.0, 55.0, n)
        lon = rng.uniform(2.0, 8.0, n)
    hdg = rng.uniform(0.0, 360.0, n)
    alt = rng.uniform(9000.0, 10500.0, n)
    spd = rng.uniform(130.0, 240.0, n)
    return lat, lon, hdg, alt, spd


def build_pair(nmax, n, geom="box", seed=0, dtype="float32",
               pair_matrix=False):
    """The same scene created through the JAX ``Traffic`` and the port's
    ``Traffic`` (on the CPU), with the [N, N] ``resopairs`` of the dense
    backend if ``pair_matrix``.  Returns ``(jax_state, torch_state)``."""
    import jax.numpy as jnp
    import torch
    from bluesky_tpu.core.traffic import Traffic as JTraffic
    from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
    lat, lon, hdg, alt, spd = scene(n, geom, seed)
    jt = JTraffic(nmax=nmax, dtype=getattr(jnp, dtype),
                  pair_matrix=pair_matrix)
    tt = TTraffic(nmax=nmax, dtype=getattr(torch, dtype),
                  pair_matrix=pair_matrix, device="cpu")
    for t in (jt, tt):
        t.create(n, "B744", alt, spd, None, lat, lon, hdg)
        t.flush()
    return jt.state, tt.state


def assert_trees_equal(a: dict, b: dict):
    """Bit-exact equality of two ``{path: array}`` dicts."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        assert x.shape == y.shape, (k, x.shape, y.shape)
        assert np.array_equal(x, y, equal_nan=True), k


def partner_sets(table):
    """Row-wise sets of the non-negative ids of a partner table."""
    return [frozenset(int(x) for x in row if x >= 0)
            for row in np.asarray(table)]


def slab64(cols, key, extra):
    """The ``cd_pallas`` slab fields of every aircraft of the CD columns
    ``cols`` (lat, lon, trk, gs, alt, vs, gseast, gsnorth, active,
    noreso), in float64 from the float32 inputs, with the ``tr`` row of
    ``key``: the cas column ``extra`` itself, or the tas/gs ratio of the
    tas column ``extra`` (``cd_pallas.tr_row`` in float64).  The float64
    witness of a kernel pass is ``cd_pallas.row_block_plain`` on it."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas, cd_tiled
    lat, lon, trk, gs, alt, vs, gse, gsn, act, noreso = (
        torch.from_numpy(np.asarray(a)).double() for a in cols)
    trkrad = torch.deg2rad(trk)
    ex = torch.from_numpy(np.asarray(extra)).double()
    f = cd_tiled.precompute_trig(lat, lon)
    f.update(u=gs * torch.sin(trkrad), v=gs * torch.cos(trkrad), alt=alt,
             vs=vs, gse=gse, gsn=gsn, trk=trk, active=act, noreso=noreso,
             tr=ex if key == "cas" else ex / torch.clamp_min(gs, 0.5))
    return torch.stack([f[k] for k in cd_pallas._FIELDS])


# ----------------------------------------------------- the Simulation pair

#: the resolver commands, the pilot targets that follow them and the
#: vertical speed that snaps to its target: the resolvers divide by
#: closure rates and times that cancel, which lifts the last-bit
#: differences of torch's and XLA's float64 arithmetic to ~1e-8
#: relative over ten intervals (``SIM_CMD_RTOL``)
SIM_CMD_FIELDS = ("asas.trk", "asas.tas", "asas.vs", "asas.alt",
                  "pilot.alt", "pilot.hdg", "pilot.trk", "pilot.vs",
                  "pilot.tas", "ac.vs", "adsb.vs")
SIM_RTOL = SIM_ATOL = 1e-9
SIM_CMD_RTOL = 1e-7


def no_pacing(monkeypatch):
    """Switch off the simulations' wall-clock pacing (``time.sleep`` in
    ``Simulation._plan_chunk``), which changes no state, so a case runs
    at the speed of its steps."""
    import time
    monkeypatch.setattr(time, "sleep", lambda s: None)


def sim_pair(nmax=32, **kw):
    """The JAX ``Simulation`` and the port's on the CPU, float64."""
    import jax.numpy as jnp
    import torch
    from bluesky_tpu.simulation.sim import Simulation as JSim
    from bluesky_tpu_torch.simulation.sim import Simulation as TSim
    return (JSim(nmax=nmax, dtype=jnp.float64, **kw),
            TSim(nmax=nmax, dtype=torch.float64, device="cpu", **kw))


def sim_do(sim, *lines):
    """Stack and process ``lines``; return and clear the echo."""
    for line in lines:
        sim.stack.stack(line)
    sim.stack.process()
    out = list(sim.scr.echobuf)
    sim.scr.echobuf.clear()
    return out


def _close(k, x, y, rtol, atol):
    d = np.abs(x - y)
    if k.endswith(("trk", "hdg")):
        d = np.minimum(d, 360.0 - d)
    ok = (d <= atol + rtol * np.abs(x)) | (np.isnan(x) & np.isnan(y))
    assert ok.all(), (k, float(np.nanmax(d)), np.flatnonzero(~ok)[:8])


def assert_sim_states(jsim, tsim, f32_cd=False, skip=()):
    """The two simulations' states, field by field: ints and bools
    equal, the sorted-space partner table as row sets; floats within
    rtol/atol ``SIM_RTOL``/``SIM_ATOL`` (the resolver commands
    ``SIM_CMD_FIELDS`` within ``SIM_CMD_RTOL``), or, with ``f32_cd``
    (the float32 CD kernels of the sparse and pallas backends ran), at
    the float32 bounds of ``tests/test_torch_slice.py``: lat/lon 1e-5
    deg, altitude 1e-2 m, the rest rtol 1e-4 / atol 1e-3."""
    from bluesky_tpu_torch.core.state import state_to_numpy
    a = jax_tree_to_numpy(jsim.traf.state)
    b = state_to_numpy(tsim.traf.state)
    assert sorted(a) == sorted(b)
    for k in a:
        if k in skip:
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        if k in ("asas.partners_s", "asas.partners"):
            assert partner_sets(x) == partner_sets(y), k
        elif x.dtype.kind != "f":
            assert np.array_equal(x, y), (k, np.flatnonzero(x != y)[:8])
        elif not f32_cd:
            _close(k, x, y, SIM_CMD_RTOL if k in SIM_CMD_FIELDS
                   else SIM_RTOL, SIM_ATOL)
        elif k.endswith((".lat", ".lon")):
            _close(k, x, y, 0.0, 1e-5)
        elif k.endswith(".alt"):
            _close(k, x, y, 0.0, 1e-2)
        else:
            _close(k, x, y, 1e-4, 1e-3)


def host_routes(sim):
    """Every slot's host route as plain tuples."""
    return {s: (r.name, r.lat, r.lon, r.alt, r.spd, r.wtype, r.flyby,
                r.iactwp, r.flag_landed, r.swflyby)
            for s, r in sim.routes.routes.items()}


def assert_sims_equal(jsim, tsim, jecho, techo, **kw):
    """Echo text, callsigns, types, routes, the configuration and the
    state of the two simulations agree (``assert_sim_states``)."""
    assert techo == jecho
    assert tsim.traf.ids == jsim.traf.ids
    assert tsim.traf.types == jsim.traf.types
    assert host_routes(tsim) == host_routes(jsim)
    for f in tsim.cfg._fields:
        t, j = getattr(tsim.cfg, f), getattr(jsim.cfg, f)
        if hasattr(t, "_asdict"):
            t, j = t._asdict(), j._asdict()
        assert t == j, f
    assert (tsim.dtmult, tsim.state_flag) == (jsim.dtmult, jsim.state_flag)
    assert tsim.simt == jsim.simt
    assert_sim_states(jsim, tsim, **kw)


# ------------------------------------------------- the differentiable mode

_DIFF_SCENES = {}


def diff_scene(n, leg_km=60.0):
    """JAX's ``diff.optimize.conflict_scene(n, leg_km=...)`` in float64 as
    ``(numpy tree, tree structure, AsasConfig)`` (made once per shape)."""
    key = (n, leg_km)
    if key not in _DIFF_SCENES:
        import jax
        import jax.numpy as jnp
        from bluesky_tpu.diff import optimize as jopt
        traf, acfg = jopt.conflict_scene(n, leg_km=leg_km, dtype=jnp.float64)
        _DIFF_SCENES[key] = (jax_tree_to_numpy(traf.state),
                             jax.tree_util.tree_structure(traf.state), acfg)
    return _DIFF_SCENES[key]


def diff_pair(n, leg_km=60.0):
    """``diff_scene`` as a new JAX state and a new port state on the CPU,
    bit-equal, with the JAX ``AsasConfig``."""
    import jax
    import jax.numpy as jnp
    from bluesky_tpu_torch.core.state import state_from_numpy
    tree, treedef, acfg = diff_scene(n, leg_km)
    jstate = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(v) for v in tree.values()])
    return jstate, state_from_numpy(tree, device="cpu"), acfg


def diff_params(n, seed, lat_sd=0.2, t_sd=0.05):
    """Seeded offsets ``{"lateral", "tshift"}`` for ``n`` slots."""
    rng = np.random.default_rng(seed)
    return {"lateral": rng.normal(0.0, lat_sd, n),
            "tshift": rng.normal(0.0, t_sd, n)}


def diff_close(name, got, want, rtol):
    """``got`` within ``rtol`` of ``want`` relative to ``want``'s largest
    finite entry, with the non-finite entries in the same places."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), name
    fin = np.isfinite(want)
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), 1e-300)
    err = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
    assert err <= rtol * scale, (name, err, scale)


# -------------------------------------------------------------- the pictures
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def assert_svg_close(got, want, tol=1e-9):
    """Two pictures (SVG text) equal, or, where the float text differs,
    every number within ``tol`` (relative above 1): the text between
    the numbers is equal and the numbers pair up."""
    if got == want:
        return
    assert _NUMBER.split(got) == _NUMBER.split(want), "the text differs"
    gn = [float(x) for x in _NUMBER.findall(got)]
    wn = [float(x) for x in _NUMBER.findall(want)]
    assert len(gn) == len(wn)
    bad = [(g, w) for g, w in zip(gn, wn)
           if abs(g - w) > tol * max(1.0, abs(w))]
    assert not bad, bad[:8]
