"""What decides ``correct``: the first and the last chunk of the run,
worked out again by the plain reference, against what the program's
timed path left after each; and the fleet the program built, against
the reference's own construction from the same draws.

The first chunk (the first of the warm-up, through the window's own
``Simulation.step``) the reference runs from its own start: the fleet it
creates from the seed's draws, an empty partner table and a new
simulation's clocks, so nothing of it is the program's.  The last chunk
(one of the window's kind after it, started at an ASAS interval) it
runs from the program's own state before that chunk (``drive.PreState``:
the columns, the old partner table, the clocks), because a closed loop
of hundreds of simulated seconds amplifies rounding until no two
precisions agree.  ``compare`` returns each
compared number; ``judge`` holds them against the cell's limits.
"""
import numpy as np
import torch

from .reference import cd as refcd, step as refstep

#: the aircraft columns the start check compares
START = ("lat", "lon", "alt", "hdg", "trk", "tas", "gs", "gsnorth",
         "gseast", "cas", "mach", "selspd", "selalt")


def _cols(pre, dtype, device):
    """The pre-state columns as tensors: floats in ``dtype``, flags as
    bool."""
    out = {}
    for k, v in pre.items():
        if k in ("partners", "clocks"):
            continue
        t = torch.as_tensor(v, device=device)
        out[k] = t if t.dtype == torch.bool else t.to(dtype)
    return out


def store(s, dtype):
    """The columns as the configuration stores them between steps: each
    float column rounded to ``dtype`` (its arithmetic stays in the
    columns' own dtype)."""
    return {k: v.to(dtype).to(v.dtype) if v.is_floating_point() else v
            for k, v in s.items()}


def run_reference(pre, sample, config, nsteps, dtype=torch.float64,
                  device="cpu", store_dtype=None):
    """The reference's chunk of ``nsteps`` steps from the pre-state
    ``pre`` (``drive.PreState.numpy``) for the aircraft ``sample``: the
    whole fleet is stepped up to the ASAS interval (its intruders), the
    sampled aircraft after it.  The arithmetic is in ``dtype``; between
    steps the state is stored as the configuration states it
    (``store_dtype``, by default the configuration's dtype), as the
    program stores its own.  Returns a dict of the sampled aircraft's
    columns after the chunk plus ``unsure`` (their state met a
    threshold), ``cd_unsure`` (their interval had an unsure pair),
    ``totals`` ``(nconf, nlos, unsure)`` of the interval."""
    env = config["envelope"][config["fleet"]["actype"]]
    acfg = dict(config["asas"])
    store_dtype = store_dtype or getattr(torch, config["dtype"])
    np_dt = getattr(np, config["dtype"])
    s = _cols(pre, dtype, device)
    own = torch.as_tensor(sample, dtype=torch.long, device=device)
    partners = torch.as_tensor(pre["partners"], device=device)
    clk = dict(pre["clocks"])
    unsure = torch.zeros(s["lat"].shape, dtype=torch.int64, device=device)
    out = dict(totals=None, cd_unsure=torch.zeros(own.numel(),
                                                  dtype=torch.bool,
                                                  device=device))
    whole = True

    def asas_update(cur):
        nonlocal whole
        cur = dict(cur, state_unsure=unsure)
        asas, d = refcd.interval(cur, own, partners, acfg)
        out["totals"] = refcd.totals(cur, acfg)
        cur.pop("state_unsure")
        out["cd_unsure"] = d["unsure"] > 0
        sub = {k: v[own] for k, v in cur.items()}
        sub.update(asas)
        whole = False
        return sub

    for _ in range(nsteps):
        fms, asas, clk = refstep.next_gates(clk, config["simdt"],
                                            acfg["dtasas"], np_dt)
        was_whole = whole
        s, u = refstep.step(s, env, float(np_dt(config["simdt"])), fms,
                            asas_update if (asas and whole) else None)
        s = store(s, store_dtype)
        unsure = (unsure[own] if was_whole and not whole else unsure) | u
    if whole:                       # no interval in the chunk
        s = {k: v[own] for k, v in s.items()}
        unsure = unsure[own]
    s.update(unsure=unsure > 0, cd_unsure=out["cd_unsure"],
             totals=out["totals"])
    return s


def steps_to_interval(clk, config) -> int:
    """Steps that the clocks ``clk`` (``simt fms_t0 asas_tnext``) run
    before the step of the next ASAS interval."""
    np_dt = getattr(np, config["dtype"])
    k = 0
    while True:
        _, asas, clk = refstep.next_gates(clk, config["simdt"],
                                          config["asas"]["dtasas"], np_dt)
        if asas:
            return k
        k += 1


def _gap(a, b):
    return float(np.max(np.abs(a - b))) if np.size(a) else 0.0


def start_gap(start_prog, start_ref):
    """The widest relative gap of the ``START`` columns between the
    sampled aircraft as the program created them and as the reference
    did."""
    g = lambda d, k: np.asarray(d[k], np.float64)
    return max(float(np.max(np.abs(g(start_prog, k) - g(start_ref, k))
                            / np.maximum(np.abs(g(start_ref, k)), 1.0)))
               for k in START)


def numbers(post, ref):
    """The compared numbers of one chunk (a dict).  ``post``: the
    program's sampled rows after the chunk and its conflict totals;
    ``ref``: ``run_reference``'s result (numpy)."""
    g = lambda d, k: np.asarray(d[k], np.float64)
    cdok = ~ref["cd_unsure"]
    ok = cdok & ~ref["unsure"]
    inconf = ref["inconf"] & cdok
    nconf, nlos, unsure_pairs = ref["totals"] or (0, 0, 0)
    out = {}
    out["conf_total_miss"] = max(
        0, abs(post["nconf_cur"] - nconf) + abs(post["nlos_cur"] - nlos)
        - unsure_pairs)
    out["flag_miss"] = int(np.sum(((post["inconf"] != ref["inconf"])
                                   | (post["asas_active"]
                                      != ref["asas_active"])) & cdok))
    tp, tr = g(post, "tcpamax")[inconf], g(ref, "tcpamax")[inconf]
    out["tcpa_gap_rel"] = float(np.max(
        np.abs(tp - tr) / np.maximum(np.abs(tr), 10.0), initial=0.0))
    out["reso_gap_mps"] = max(_gap(g(post, k)[inconf], g(ref, k)[inconf])
                              for k in ("asase", "asasn", "asas_vs"))
    out["reso_alt_gap_m"] = _gap(g(post, "asas_alt")[inconf],
                                 g(ref, "asas_alt")[inconf])
    dlat = np.radians(g(post, "lat") - g(ref, "lat"))
    dlon = np.radians(g(post, "lon") - g(ref, "lon")) * np.cos(
        np.radians(g(ref, "lat")))
    out["pos_gap_m"] = float(np.max(6371000.0 * np.hypot(dlat, dlon)[ok],
                                    initial=0.0))
    out["alt_gap_m"] = _gap(g(post, "alt")[ok], g(ref, "alt")[ok])
    out["tas_gap_mps"] = _gap(g(post, "tas")[ok], g(ref, "tas")[ok])
    out["vs_gap_mps"] = _gap(g(post, "vs")[ok], g(ref, "vs")[ok])
    dh = np.abs((g(post, "hdg") - g(ref, "hdg") + 180.0) % 360.0 - 180.0)
    out["hdg_gap_deg"] = float(np.max(dh[ok], initial=0.0))
    return out


def compare(prog, ref):
    """Every compared number.  ``prog`` and ``ref`` each hold ``start``
    (the sampled aircraft as created), ``first`` and ``last`` (their rows
    after the run's first and last chunk; ``ref``'s from
    ``run_reference``)."""
    out = {"start_gap": start_gap(prog["start"], ref["start"])}
    out.update(numbers(prog["last"], ref["last"]))
    out.update({f"first_{k}": v
                for k, v in numbers(prog["first"], ref["first"]).items()})
    return out


def as_post(ref):
    """A reference's result in the place of the program's rows."""
    post = {k: v for k, v in ref.items()
            if k not in ("totals", "unsure", "cd_unsure")}
    post["nconf_cur"], post["nlos_cur"], _ = ref["totals"] or (0, 0, 0)
    return post


def cruise_only(pre) -> bool:
    """Whether every aircraft of the pre-state flies without a route:
    the reference's FMS is that of aircraft without one."""
    return not bool(np.any(pre["swlnav"] | pre["swvnav"]))


def excused(ref) -> dict:
    """How many compared aircraft the reference left out, and why."""
    return dict(excused_cd=int(np.sum(ref["cd_unsure"])),
                excused_state=int(np.sum(ref["unsure"] & ~ref["cd_unsure"])),
                compared=int(np.sum(~ref["cd_unsure"] & ~ref["unsure"])))


def to_numpy(ref):
    out = {}
    for k, v in ref.items():
        out[k] = v.detach().to("cpu").double().numpy() \
            if torch.is_tensor(v) and v.is_floating_point() else (
                v.detach().to("cpu").numpy() if torch.is_tensor(v) else v)
    return out


def start_reference(cols, sample, dtype=torch.float64):
    """The reference's construction of the sampled aircraft."""
    picked = {k: np.asarray(v)[sample] for k, v in cols.items()}
    return to_numpy(refstep.initial(picked, dtype=dtype))


def start_state(cols, sample, config, dtype=torch.float64, store_dtype=None):
    """The reference's own pre-state of the run's first chunk, in
    ``run_reference``'s form: the whole fleet as created from the drawn
    columns ``cols`` (computed in ``dtype``, stored in ``store_dtype``,
    by default the configuration's), no partners of the ownships
    ``sample``, a new simulation's clocks."""
    store_dtype = store_dtype or getattr(torch, config["dtype"])
    s = store(refstep.created(cols, dtype), store_dtype)
    s["partners"] = torch.full((len(sample), int(config["k_partners"])), -1,
                               dtype=torch.int64)
    s["clocks"] = dict(refstep.START_CLOCKS)
    return s


def judge(nums: dict, limits: dict):
    """``(correct, [(name, value, limit)])``: every number at or under
    its limit.  A number without a limit, or a limit without a number,
    fails."""
    rows = []
    ok = set(nums) == set(limits)
    for k in sorted(set(nums) | set(limits)):
        v, lim = nums.get(k), limits.get(k)
        rows.append((k, v, lim))
        ok &= v is not None and lim is not None and np.isfinite(v) \
            and v <= lim
    return bool(ok), rows
