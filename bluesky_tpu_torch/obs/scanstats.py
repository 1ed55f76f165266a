"""In-chunk telemetry: per-step stats folded through the chunk runners.

Port of ``bluesky_tpu/obs/scanstats.py``.  ``EdgeTelemetry``
(``core/step.py``) packs only the last step's values; ``ScanStats`` is a
small accumulator pack folded once per step from the post-step state by
the chunk runner (``SimConfig.scanstats``) and returned once per chunk
next to the telemetry, with no host read inside the chunk.

Every field is a sum, min, max or histogram fold, so one 20-step chunk's
pack equals ``reduce_packs`` of twenty 1-step packs bit for bit.  The
``[P]`` fields keep per-shard partials: ``P`` is the shard count of the
configuration's mesh (``n_partials``), 1 without one.
``drain`` feeds a retired pack into the ``obs/metrics.py`` registry.
"""
from typing import NamedTuple

import numpy as np
import torch

#: Per-step conflict/LoS count bucket ladder (upper bounds; one extra
#: overflow bucket on device).
COUNT_BUCKETS = (0.0, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                 500.0, 1000.0, 2000.0, 5000.0)

#: Saturation epsilons: the envelope limits clip, so a saturated command
#: sits on the bound up to the CAS<->TAS round-trip error.
SAT_EPS_MS = 0.05        # [m/s] CAS round-trip tolerance at vmin/vmax
SAT_EPS_M = 0.5          # [m] altitude tolerance at hmax

_RE_M = 6371000.0        # mean-earth radius for the flat-earth distance


class ScanStats(NamedTuple):
    """Per-chunk accumulator pack (0-d int32 scalars and ``[P]``
    partials, on the state's device)."""
    steps: torch.Tensor           # [] int32 - steps folded
    conf_peak: torch.Tensor       # [] int32 - max per-step conflict count
    conf_sum: torch.Tensor        # [] int32 - sum of per-step counts
    conf_hist: torch.Tensor       # [B+1] int32 - bucketed per-step counts
    los_peak: torch.Tensor        # [] int32
    los_sum: torch.Tensor         # [] int32
    los_hist: torch.Tensor        # [B+1] int32
    engaged_peak: torch.Tensor    # [P] int32 - peak resolver-engaged rows
    occ_peak: torch.Tensor        # [P] int32 - peak per-stripe occupancy
    clamp_sat: torch.Tensor       # [P] int32 - envelope-saturated row-steps
    live_rowsteps: torch.Tensor   # [P] int32 - live row-steps
    min_sep_m: torch.Tensor       # [P] f32 - min engaged-pair separation
    headroom_min_m: torch.Tensor  # [P] f32 - min live-row (hmax - alt)


#: Host-side reduction schema (``reduce_packs`` and the fold oracle).
SUM_FIELDS = ("steps", "conf_sum", "conf_hist", "los_sum", "los_hist",
              "clamp_sat", "live_rowsteps")
MAX_FIELDS = ("conf_peak", "los_peak", "engaged_peak", "occ_peak")
MIN_FIELDS = ("min_sep_m", "headroom_min_m")


def n_partials(cfg, nmax: int) -> int:
    """How many per-shard partials the ``[P]`` folds keep: the size of
    ``cfg.cd_mesh`` on ``cfg.cd_mesh_axis`` when it divides nmax (the
    partials then align with the shards' caller rows), else 1.  A mesh
    that does not divide nmax is refused (the shard preparations
    guarantee it; only a hand-built config gets here)."""
    mesh = cfg.cd_mesh
    if mesh is None:
        return 1
    p = int(dict(mesh.shape).get(cfg.cd_mesh_axis, 1))
    if p <= 1:
        return 1
    if nmax % p:
        raise ValueError(
            f"scanstats: nmax={nmax} is not divisible by the {p}-device "
            "mesh — per-device partial folds need shard-aligned rows "
            "(prepare_spatial guarantees this)")
    return p


def init(state, cfg) -> ScanStats:
    """Fresh accumulators for one chunk, on the state's device; a stacked
    state (``core/step.stack_worlds``) gets a pack per world, every field
    with a leading [W]."""
    dev = state.ac.active.device
    _bounds(dev)
    lead = tuple(state.ac.active.shape[:-1])
    p = n_partials(cfg, int(state.ac.active.shape[-1]))
    nb = len(COUNT_BUCKETS) + 1
    i32 = dict(dtype=torch.int32, device=dev)
    z = lambda *shape: torch.zeros(lead + shape, **i32)
    inf_p = lambda: torch.full(lead + (p,), float("inf"),
                               dtype=torch.float32, device=dev)
    return ScanStats(
        steps=z(), conf_peak=z(), conf_sum=z(), conf_hist=z(nb),
        los_peak=z(), los_sum=z(), los_hist=z(nb),
        engaged_peak=z(p), occ_peak=z(p), clamp_sat=z(p),
        live_rowsteps=z(p), min_sep_m=inf_p(), headroom_min_m=inf_p())


def _dist_m(lat1, lon1, lat2, lon2):
    """Flat-earth (equirectangular) horizontal separation [m]."""
    from ..ops import geo
    coslat = torch.cos(geo.radians(0.5 * (lat1 + lat2)))
    dx = geo.radians(lon2 - lon1) * coslat * _RE_M
    dy = geo.radians(lat2 - lat1) * _RE_M
    return torch.hypot(dx, dy)


def _partner_min_sep(ac, idx):
    """[N] per-row min separation to the listed partner rows (-1 =
    empty slot); +inf where nothing is engaged (per world, [W, N], for
    a stacked state)."""
    from ..ops.cd_tiled import take_ids
    n = ac.lat.shape[-1]
    j = torch.clamp(idx, 0, n - 1).long()
    g = lambda a: take_ids(a, j)
    valid = (idx >= 0) & ac.active[..., :, None] & g(ac.active)
    d = _dist_m(ac.lat[..., :, None], ac.lon[..., :, None], g(ac.lat),
                g(ac.lon))
    return torch.where(valid, d, float("inf")).amin(-1)


def _min_sep(state, cfg, p: int):
    """[P] per-partial min separation among ENGAGED pairs (the pairs the
    resolver tracks), +inf where none is; the sparse backend's table is
    read through the caller-space translation of its sorted slots."""
    dev = state.ac.lat.device
    lead = tuple(state.ac.lat.shape[:-1])
    inf = torch.full(lead + (p,), float("inf"), dtype=torch.float32,
                     device=dev)
    if not cfg.asas.swasas:
        return inf
    ac, asas = state.ac, state.asas
    if cfg.cd_backend == "dense":
        if asas.resopairs.numel() == 0:
            return inf
        mask = (asas.resopairs & ac.active[..., :, None]
                & ac.active[..., None, :])
        d = _dist_m(ac.lat[..., :, None], ac.lon[..., :, None],
                    ac.lat[..., None, :], ac.lon[..., None, :])
        row = torch.where(mask, d, float("inf")).amin(-1)
    elif cfg.cd_backend == "sparse":
        from ..ops import cd_sched
        n = ac.lat.shape[-1]
        ptable = cd_sched.partners_to_caller(
            asas.sort_perm, asas.partners_s, n, asas.partners_s.shape[-2])
        row = _partner_min_sep(ac, ptable)
    else:                          # tiled / pallas: caller-space table
        if asas.partners.numel() == 0:
            return inf
        row = _partner_min_sep(ac, asas.partners)
    row = torch.where(ac.active, row, float("inf"))
    return row.reshape(*lead, p, -1).amin(-1).to(torch.float32)


def _bucket(count, bounds):
    """The histogram bucket of a count (0-d, or [W]) as a [..., 1] index:
    the number of bounds below it (``searchsorted`` with side='left')."""
    return torch.searchsorted(bounds, count.to(torch.float32)[..., None])


def fold(stats: ScanStats, state, cfg) -> ScanStats:
    """One step's fold (post-step state -> accumulators): reductions on
    the device only, no host read and no state write.  A stacked state
    folds each world into its own pack."""
    from ..ops import aero
    p = stats.occ_peak.shape[-1]
    ac, asas = state.ac, state.asas
    part = lambda x: x.reshape(*ac.active.shape[:-1], p, -1)

    nconf = asas.nconf_cur.to(torch.int32)
    nlos = asas.nlos_cur.to(torch.int32)
    bounds = _bounds(nconf.device)
    one = torch.ones(nconf.shape + (1,), dtype=torch.int32,
                     device=nconf.device)

    live = ac.active
    occ = part(live).sum(-1, dtype=torch.int32)
    engaged = part(asas.active & live).sum(-1, dtype=torch.int32)
    # the pilot targets are clipped by the envelope, so a binding
    # envelope leaves the commanded CAS or altitude on the bound
    cas_cmd = aero.vtas2cas(state.pilot.tas, state.pilot.alt)
    sat = live & ((cas_cmd <= state.perf.vmin + SAT_EPS_MS)
                  | (cas_cmd >= state.perf.vmax - SAT_EPS_MS)
                  | (state.pilot.alt >= state.perf.hmax - SAT_EPS_M))
    nsat = part(sat).sum(-1, dtype=torch.int32)
    headroom = torch.where(live, state.perf.hmax - ac.alt, float("inf"))
    hr_min = part(headroom).amin(-1).to(torch.float32)
    sep = _min_sep(state, cfg, p)

    return ScanStats(
        steps=stats.steps + 1,
        conf_peak=torch.maximum(stats.conf_peak, nconf),
        conf_sum=stats.conf_sum + nconf,
        conf_hist=stats.conf_hist.scatter_add(-1, _bucket(nconf, bounds),
                                              one),
        los_peak=torch.maximum(stats.los_peak, nlos),
        los_sum=stats.los_sum + nlos,
        los_hist=stats.los_hist.scatter_add(-1, _bucket(nlos, bounds), one),
        engaged_peak=torch.maximum(stats.engaged_peak, engaged),
        occ_peak=torch.maximum(stats.occ_peak, occ),
        clamp_sat=stats.clamp_sat + nsat,
        live_rowsteps=stats.live_rowsteps + occ,
        min_sep_m=torch.minimum(stats.min_sep_m, sep),
        headroom_min_m=torch.minimum(stats.headroom_min_m, hr_min))


#: ``COUNT_BUCKETS`` as a tensor, one per device
_BOUNDS = {}


def _bounds(device):
    """``COUNT_BUCKETS`` on ``device``, copied from the host once, by
    ``init``: a captured fold could not copy from the host."""
    b = _BOUNDS.get(device)
    if b is None:
        b = _BOUNDS[device] = torch.tensor(COUNT_BUCKETS,
                                           dtype=torch.float32,
                                           device=device)
    return b


# ------------------------------------------------------------------ host side

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def reduce_packs(packs):
    """Merge host-side chunk packs into one: sums add, peaks max, mins
    min (the oracle's 'twenty 1-step chunks == one 20-step chunk').
    Returns a ``ScanStats`` of numpy arrays."""
    packs = list(packs)
    if not packs:
        raise ValueError("reduce_packs: need at least one pack")
    out = {}
    for f in SUM_FIELDS:
        out[f] = np.sum([_np(getattr(q, f)) for q in packs], axis=0)
    for f in MAX_FIELDS:
        out[f] = np.max([_np(getattr(q, f)) for q in packs], axis=0)
    for f in MIN_FIELDS:
        out[f] = np.min([_np(getattr(q, f)) for q in packs], axis=0)
    return ScanStats(**out)


def summarize(pack) -> dict:
    """One pack as the HEALTH/heartbeat summary: partials collapse here
    (sum/max/min over [P]), non-finite mins map to None."""
    steps = int(_np(pack.steps))
    live = int(np.sum(_np(pack.live_rowsteps)))
    sat = int(np.sum(_np(pack.clamp_sat)))
    occ = _np(pack.occ_peak)
    min_sep = float(np.min(_np(pack.min_sep_m)))
    headroom = float(np.min(_np(pack.headroom_min_m)))
    return {
        "steps": steps,
        "conf_peak": int(_np(pack.conf_peak)),
        "conf_mean": round(float(_np(pack.conf_sum)) / max(steps, 1), 3),
        "los_peak": int(_np(pack.los_peak)),
        "engaged_peak": int(np.sum(_np(pack.engaged_peak))),
        "occ_peak": int(np.max(occ)) if occ.size else 0,
        "occ_imbalance": round(float(np.max(occ))
                               / max(float(np.mean(occ)), 1e-9), 3)
        if occ.size > 1 and float(np.mean(occ)) > 0 else 1.0,
        "clamp_sat_ratio": round(sat / live, 6) if live else 0.0,
        "min_sep_m": round(min_sep, 1) if np.isfinite(min_sep) else None,
        "alt_headroom_min_m": round(headroom, 1)
        if np.isfinite(headroom) else None,
    }


def merge_summaries(summaries):
    """Worst-case merge of ``summarize`` dicts across worlds or workers:
    steps add, peaks and ratios take the worst, minima the closest call;
    the mean re-weights by steps."""
    summaries = [s for s in summaries if s]
    if not summaries:
        return None
    steps = sum(int(s.get("steps", 0)) for s in summaries)
    wmean = (sum(float(s.get("conf_mean", 0.0))
                 * int(s.get("steps", 0)) for s in summaries)
             / steps) if steps else 0.0

    def _max(key):
        return max((s.get(key) or 0) for s in summaries)

    def _min(key):
        vals = [s[key] for s in summaries if s.get(key) is not None]
        return min(vals) if vals else None

    return {
        "steps": steps, "conf_peak": _max("conf_peak"),
        "conf_mean": round(wmean, 3), "los_peak": _max("los_peak"),
        "engaged_peak": _max("engaged_peak"),
        "occ_peak": _max("occ_peak"),
        "occ_imbalance": _max("occ_imbalance"),
        "clamp_sat_ratio": _max("clamp_sat_ratio"),
        "min_sep_m": _min("min_sep_m"),
        "alt_headroom_min_m": _min("alt_headroom_min_m"),
    }


#: Registry series the drain feeds (docs/OBSERVABILITY.md catalogue).
#: Counters and histograms add exactly across chunks; gauges are the last
#: chunk's.
SERIES_HELP = {
    "sim_scan_conf_per_step": "per-step conflict count (in-scan fold)",
    "sim_scan_los_per_step": "per-step LoS count (in-scan fold)",
    "sim_scan_steps": "steps folded by in-scan telemetry",
    "sim_scan_clamp_sat_rowsteps":
        "live row-steps with a binding perf envelope clamp",
    "sim_scan_live_rowsteps": "live row-steps folded (ratio denominator)",
    "sim_scan_conf_peak": "last chunk's peak per-step conflict count",
    "sim_scan_los_peak": "last chunk's peak per-step LoS count",
    "sim_scan_engaged_peak": "last chunk's peak resolver-engaged rows",
    "sim_scan_occupancy_peak": "last chunk's peak per-stripe occupancy",
    "sim_scan_min_sep_m": "last chunk's min engaged-pair separation [m]",
    "sim_scan_alt_headroom_min_m":
        "last chunk's min live-row ceiling headroom [m]",
    "sim_scan_clamp_sat_ratio":
        "last chunk's clamp-saturated fraction of live row-steps",
}


def drain(reg, pack) -> dict:
    """Fold one chunk's pack (host arrays or tensors) into a metrics
    ``Registry`` (``obs/metrics.py``): histogram bucket counts merge
    count-exactly, totals ride counters, last-chunk reductions land in
    gauges.  Returns the ``summarize`` dict."""
    s = summarize(pack)
    if s["steps"] == 0:
        return s
    hlp = SERIES_HELP
    reg.histogram("sim_scan_conf_per_step", buckets=COUNT_BUCKETS,
                  help=hlp["sim_scan_conf_per_step"]).add_counts(
        _np(pack.conf_hist).tolist(), float(_np(pack.conf_sum)))
    reg.histogram("sim_scan_los_per_step", buckets=COUNT_BUCKETS,
                  help=hlp["sim_scan_los_per_step"]).add_counts(
        _np(pack.los_hist).tolist(), float(_np(pack.los_sum)))
    reg.counter("sim_scan_steps", help=hlp["sim_scan_steps"]).inc(
        s["steps"])
    reg.counter("sim_scan_clamp_sat_rowsteps",
                help=hlp["sim_scan_clamp_sat_rowsteps"]).inc(
        int(np.sum(_np(pack.clamp_sat))))
    reg.counter("sim_scan_live_rowsteps",
                help=hlp["sim_scan_live_rowsteps"]).inc(
        int(np.sum(_np(pack.live_rowsteps))))
    g = lambda name, v: reg.gauge(name, help=hlp[name]).set(v)
    g("sim_scan_conf_peak", s["conf_peak"])
    g("sim_scan_los_peak", s["los_peak"])
    g("sim_scan_engaged_peak", s["engaged_peak"])
    g("sim_scan_occupancy_peak", s["occ_peak"])
    g("sim_scan_clamp_sat_ratio", s["clamp_sat_ratio"])
    if s["min_sep_m"] is not None:
        g("sim_scan_min_sep_m", s["min_sep_m"])
    if s["alt_headroom_min_m"] is not None:
        g("sim_scan_alt_headroom_min_m", s["alt_headroom_min_m"])
    return s
