"""Noise-on parity by statistics (ROADMAP A10.8): the port's turbulence
and ADS-B noise against the JAX package's, on the CPU, in float64.

torch cannot reproduce JAX's threefry streams, so the two packages draw
different numbers from their seeds (JAX a ``PRNGKey``, the port a
seeded ``torch.Generator``) and can agree only in distribution.  The
same numpy-seeded state goes through each package's
``turbulence_woosh`` and ``adsb_update``; the displacements each draws
are recovered per axis and held

* each to its law, N(0, s) with s = sd * sqrt(dt) for the turbulence
  (flight, wing and vertical axes) and s = the ADS-B error (lat, lon,
  alt): a one-sample Kolmogorov-Smirnov test at level ``ALPHA``, the
  sample mean within 4 s / sqrt(n) of 0 and the sample standard
  deviation within 4 / sqrt(2 n) of s (relative; both four standard
  errors of the estimate);
* to each other: a two-sample KS test at ``ALPHA``.

Sample size n = ``NS`` aircraft a draw (every slot active), ``ALPHA`` =
1e-3.  The seeds are fixed (the state from ``torch_parity.scene``, JAX's
key and the port's generator from ``SEEDS``), so every test gives the
same verdict on every run.  ADS-B truncation: off, every aircraft
broadcasts; on (``adsb_trunctime`` 0.5 s, each slot's last broadcast
drawn from the seed), the aircraft whose window elapsed broadcast, the
same ones in both packages, and the rest keep their broadcast state bit
for bit.

A short noise-on chunk: ``run_steps`` of ``CHUNK`` steps from one
state with the turbulence and the ADS-B noise on, and without them, in
each package.  The spread of the noise-on positions around the
noise-off run (flight, wing and vertical axes, metres) is held between
the packages: a two-sample KS test at ``ALPHA`` and the standard
deviations within 4 / sqrt(n) (relative) of each other.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

from bluesky_tpu.core import noise as jnoise, step as jstep
from bluesky_tpu_torch.core import noise as tnoise, step as tstep
from bluesky_tpu_torch.core.state import state_to_numpy

from torch_parity import build_pair, jax_tree_to_numpy

NS = 8192
ALPHA = 1e-3
SEEDS = (11, 12, 13)
REARTH = 6371000.0
#: turbulence levels of the draws [m/s]: the defaults' wing and vertical
#: 0.1, and a flight-direction sd far above the default 1e-6 so that its
#: displacement is measured well above float64 rounding of the latitude
TURB = dict(turb_active=True, turb_sd_hf=0.3, turb_sd_hw=0.1,
            turb_sd_vert=0.1)
DT = 0.5
CHUNK = 20


@pytest.fixture(scope="module")
def pair():
    """The same NS aircraft in both packages, float64 (numpy)."""
    return build_pair(NS, NS, "box", 5, "float64")


def _ac_numpy(state):
    """lat, lon, alt, trk of a state's aircraft, numpy float64."""
    get = (lambda x: x.numpy()) if isinstance(state.ac.lat, torch.Tensor) \
        else np.asarray
    return [get(getattr(state.ac, k)) for k in ("lat", "lon", "alt", "trk")]


def _axes(before, after):
    """Displacements (flight, wing, vertical) in metres between two
    positions, the flight axis along ``before``'s track."""
    lat0, lon0, alt0, trk = before
    lat1, lon1, alt1, _ = after
    north = np.radians(lat1 - lat0) * REARTH
    east = np.radians(lon1 - lon0) * REARTH * np.cos(np.radians(lat0))
    t = np.radians(trk)
    return (np.cos(t) * north + np.sin(t) * east,
            -np.sin(t) * north + np.cos(t) * east, alt1 - alt0)


def _hold_law(name, x, sd):
    """``x`` drawn from N(0, sd), as the module docstring states."""
    n = x.size
    assert abs(x.mean()) < 4 * sd / np.sqrt(n), (name, x.mean(), sd)
    assert abs(x.std() / sd - 1.0) < 4 / np.sqrt(2 * n), (name, x.std(), sd)
    p = stats.kstest(x / sd, "norm").pvalue
    assert p > ALPHA, (name, p)


def _hold_same(name, a, b):
    p = stats.ks_2samp(a, b).pvalue
    assert p > ALPHA, (name, p)


def _turb(pair, seed):
    js, ts = pair
    jcfg = jnoise.NoiseConfig(**TURB)
    tcfg = tnoise.NoiseConfig(**TURB)
    jac = jnoise.turbulence_woosh(js.ac, jax.random.PRNGKey(seed), DT, jcfg)
    tac = tnoise.turbulence_woosh(ts.ac, torch.Generator().manual_seed(seed),
                                  DT, tcfg)
    jb, tb = _ac_numpy(js), _ac_numpy(ts)
    ja = [np.asarray(getattr(jac, k)) for k in ("lat", "lon", "alt", "trk")]
    ta = [getattr(tac, k).numpy() for k in ("lat", "lon", "alt", "trk")]
    return _axes(jb, ja), _axes(tb, ta)


@pytest.mark.parametrize("seed", SEEDS)
def test_turbulence_matches_jax_in_distribution(pair, seed):
    """Flight, wing and vertical turbulence displacements of one step of
    DT: each package's to N(0, sd * sqrt(DT)), and to each other."""
    jd, td = _turb(pair, seed)
    for axis, sd, a, b in zip(("flight", "wing", "vertical"),
                              (TURB["turb_sd_hf"], TURB["turb_sd_hw"],
                               TURB["turb_sd_vert"]), jd, td):
        s = sd * np.sqrt(DT)
        _hold_law(f"JAX {axis}", a, s)
        _hold_law(f"port {axis}", b, s)
        _hold_same(axis, a, b)


def _adsb(pair, seed, trunc):
    """One ``adsb_update`` in each package at simt 1 s: ``(up mask,
    (JAX lat, lon, alt errors), (the port's), kept)`` with ``kept`` True
    when the slots that did not broadcast kept their state bit for
    bit."""
    js, ts = pair
    kw = dict(adsb_transnoise=True, adsb_truncated=trunc,
              adsb_trunctime=0.5 if trunc else 0.0)
    rng = np.random.default_rng(seed)
    last = rng.uniform(0.0, 1.0, NS) if trunc else np.zeros(NS)
    old = rng.uniform(-1.0, 1.0, NS)
    jadsb = js.adsb.replace(lastupdate=jax.numpy.asarray(last),
                            lat=jax.numpy.asarray(old))
    tadsb = ts.adsb.replace(lastupdate=torch.from_numpy(last),
                            lat=torch.from_numpy(old.copy()))
    jn = jnoise.adsb_update(jadsb, js.ac, jax.random.PRNGKey(seed), 1.0,
                            jnoise.NoiseConfig(**kw))
    tn = tnoise.adsb_update(tadsb, ts.ac,
                            torch.Generator().manual_seed(seed), 1.0,
                            tnoise.NoiseConfig(**kw))
    up = last + kw["adsb_trunctime"] < 1.0
    jup = np.asarray(jn.lastupdate) != last
    tup = tn.lastupdate.numpy() != last
    if trunc:
        assert np.array_equal(jup, up) and np.array_equal(tup, up)
    errs = []
    for a, ac in ((jn, js.ac), (tn, ts.ac)):
        get = (lambda x: np.asarray(x)) if a is jn else (lambda x: x.numpy())
        errs.append(tuple(get(getattr(a, k))[up] - get(getattr(ac, k))[up]
                          for k in ("lat", "lon", "alt")))
    kept = (np.array_equal(np.asarray(jn.lat)[~up], old[~up])
            and np.array_equal(tn.lat.numpy()[~up], old[~up]))
    return up, errs[0], errs[1], kept


@pytest.mark.parametrize("trunc", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_adsb_noise_matches_jax_in_distribution(pair, seed, trunc):
    """ADS-B transmission errors (lat, lon in deg, alt in m) of one update:
    each package's to N(0, the configured error), and to each other;
    with truncation on, the broadcasting aircraft are those whose window
    elapsed and the rest keep their state."""
    up, jerr, terr, kept = _adsb(pair, seed, trunc)
    assert kept
    assert (0.2 * NS < up.sum() < 0.8 * NS) if trunc else up.all()
    c = tnoise.NoiseConfig()
    for axis, sd, a, b in zip(("lat", "lon", "alt"),
                              (c.adsb_err_latlon, c.adsb_err_latlon,
                               c.adsb_err_alt), jerr, terr):
        _hold_law(f"JAX {axis}", a, sd)
        _hold_law(f"port {axis}", b, sd)
        _hold_same(axis, a, b)


def _chunk(cfg_noise):
    """``run_steps`` of CHUNK steps from the same state in both packages,
    the noise as ``cfg_noise`` (None: off): the final (lat, lon, alt,
    trk) of each."""
    js, ts = build_pair(NS, NS, "box", 5, "float64")
    for pkg, npkg, st in ((jstep, jnoise, js), (tstep, tnoise, ts)):
        kw = {} if cfg_noise is None else dict(
            noise=npkg.NoiseConfig(**cfg_noise))
        # no CD: the chunk moves each aircraft on its own
        cfg = pkg.SimConfig(cd_backend="tiled", **kw)
        cfg = cfg._replace(asas=cfg.asas._replace(swasas=False))
        out = pkg.run_steps(st, cfg, CHUNK)
        if pkg is jstep:
            jout = out
        else:
            tout = out
    j, t = jax_tree_to_numpy(jout), state_to_numpy(tout)
    return ([j[f"ac.{k}"] for k in ("lat", "lon", "alt", "trk")],
            [t[f"ac.{k}"] for k in ("lat", "lon", "alt", "trk")])


def test_noise_on_chunk_spread_matches_jax():
    """A CHUNK-step chunk with the turbulence and the ADS-B noise on: the
    positions' spread around each package's noise-off chunk agrees
    between the packages on every axis."""
    j_off, t_off = _chunk(None)
    j_on, t_on = _chunk(dict(TURB, adsb_transnoise=True))
    jd, td = _axes(j_off, j_on), _axes(t_off, t_on)
    for axis, a, b in zip(("flight", "wing", "vertical"), jd, td):
        assert a.std() > 0 and b.std() > 0, axis
        assert abs(a.std() / b.std() - 1.0) < 4 / np.sqrt(NS), \
            (axis, a.std(), b.std())
        _hold_same(f"chunk {axis}", a, b)
