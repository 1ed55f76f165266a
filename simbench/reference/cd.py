"""One ASAS interval of upstream BlueSky: state-based conflict
detection (``StateBased``), MVP resolution and resume-nav with a
partner table, for chosen ownships against the whole fleet.  Plain
PyTorch on columns of any float dtype.

The pair geometry is the haversine on the local WGS-84 radius of the
summed latitudes (upstream's ``qdrdist_matrix``; across the equator the
latitude-weighted radius), with the bearing's sine and cosine.  A pair
is in conflict when the horizontal and vertical windows of the zone
overlap after 0 and before the lookahead; in loss of separation when it
is inside the zone now.  Each ownship sums the MVP displacement of its
conflict pairs.  Its resolver stays engaged while a fresh conflict or an
old partner (the partner table before the interval) is not past its
closest point, in horizontal loss of separation, or bouncing.

Every pair also gets an ``unsure`` flag: a comparison that decides its
flags, its MVP branch or its resume test lies so close to its threshold
(a relative ``MARGIN``) that a lower precision could take the other
side while no other comparison settles it.  Counts may differ by such
pairs, and their ownships' commands are not compared.
"""
import torch

from . import aero, pairs as pairmod, step as refstep

MARGIN = 1e-5
BIG = 1e9


def radius(lat_o, lat_i):
    """Upstream's pair radius: ``rwgs84(lat_o + lat_i)`` in one
    hemisphere, the latitude-weighted mean across the equator."""
    same = aero.rwgs84(lat_o + lat_i)
    ro, ri = aero.rwgs84(lat_o), aero.rwgs84(lat_i)
    eps = torch.where(lat_o == 0.0, 1e-6, 0.0).to(lat_o.dtype)
    cross = 0.5 * (torch.abs(lat_o) * (ro + aero.A_WGS84)
                   + torch.abs(lat_i) * (ri + aero.A_WGS84)) / (
                       torch.abs(lat_o) + torch.abs(lat_i) + eps)
    return torch.where(lat_o * lat_i < 0.0, cross, same)


def _near(x, thr, scale):
    return torch.abs(x - thr) <= MARGIN * scale


def _unsure(conds):
    """A flag made of ``conds`` [(holds, near)]: unsure when some
    comparison is near its threshold and none of the others fails
    clearly."""
    fails = torch.zeros_like(conds[0][0])
    edge = torch.zeros_like(fails)
    for holds, close in conds:
        fails |= ~holds & ~close
        edge |= close
    return edge & ~fails


def keep_terms(o, i, cfg, widen=1.0):
    """Resume-nav's keep test of the pairs (flat-earth displacement):
    ``(keep, unsure)``, the margins of ``unsure`` times ``widen``."""
    cos_half = torch.cos(0.5 * aero.radians(i["lat"] + o["lat"]))
    de = aero.Rearth * aero.radians(i["lon"] - o["lon"]) * cos_half
    dn = aero.Rearth * aero.radians(i["lat"] - o["lat"])
    ve, vn = i["gseast"] - o["gseast"], i["gsnorth"] - o["gsnorth"]
    dot = de * ve + dn * vn
    hdist = torch.sqrt(de * de + dn * dn)
    dtrk = torch.abs(o["trk"] - i["trk"])
    past = dot > 0.0
    los = hdist < cfg["rpz"]
    bounce = (dtrk < 30.0) & (hdist < cfg["rpz"] * cfg["resofach"])
    keep = ~past | los | bounce
    w = widen
    unsure = (_near(dot, 0.0, w * (torch.abs(de * ve) + torch.abs(dn * vn)))
              | _near(hdist, cfg["rpz"], w * cfg["rpz"])
              | (torch.abs(dtrk - 30.0) <= w * 1e-3)
              | _near(hdist, cfg["rpz"] * cfg["resofach"], w * cfg["rpz"]))
    return keep, unsure


def pair_terms(o, i, cfg):
    """Detection, MVP and keep terms of the pairs (``o``, ``i``: dicts of
    aligned [P] columns of the ownships and intruders)."""
    rpz, hpz, tl = cfg["rpz"], cfg["hpz"], cfg["dtlookahead"]
    r = radius(o["lat"], i["lat"])
    p1, p2 = aero.radians(o["lat"]), aero.radians(i["lat"])
    dlon_deg = i["lon"] - o["lon"]
    dlon = aero.radians(dlon_deg - 360.0 * torch.round(dlon_deg / 360.0))
    h = (torch.sin(0.5 * (p2 - p1)) ** 2
         + torch.cos(p1) * torch.cos(p2) * torch.sin(0.5 * dlon) ** 2)
    dist = 2.0 * r * torch.asin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))
    qy = torch.sin(dlon) * torch.cos(p2)
    qx = (torch.cos(p1) * torch.sin(p2)
          - torch.sin(p1) * torch.cos(p2) * torch.cos(dlon))
    qn = torch.sqrt(qx * qx + qy * qy)
    sinq = torch.where(qn > 0, qy / qn, torch.zeros_like(qn))
    cosq = torch.where(qn > 0, qx / qn, torch.ones_like(qn))
    dx, dy = dist * sinq, dist * cosq
    tr = lambda c: (c["gs"] * torch.sin(aero.radians(c["trk"])),
                    c["gs"] * torch.cos(aero.radians(c["trk"])))
    (uo, vo), (ui, vi) = tr(o), tr(i)
    du, dv = ui - uo, vi - vo
    dv2 = du * du + dv * dv
    dv2 = torch.where(torch.abs(dv2) < 1e-6, torch.full_like(dv2, 1e-6), dv2)
    tcpa = -(du * dx + dv * dy) / dv2
    dcpa2 = dist * dist - tcpa * tcpa * dv2
    r2 = rpz * rpz
    swhor = dcpa2 < r2
    dtin = torch.sqrt(torch.clamp_min(r2 - dcpa2, 0.0) / dv2)
    tinhor = torch.where(swhor, tcpa - dtin, torch.full_like(tcpa, BIG))
    touthor = torch.where(swhor, tcpa + dtin, torch.full_like(tcpa, -BIG))
    dalt = i["alt"] - o["alt"]
    vrel_v = i["vs"] - o["vs"]
    dvs = torch.where(torch.abs(vrel_v) < 1e-6, torch.full_like(vrel_v, 1e-6),
                      vrel_v)
    hi, lo = -(dalt + hpz) / dvs, -(dalt - hpz) / dvs
    tin = torch.maximum(torch.minimum(hi, lo), tinhor)
    tout = torch.minimum(torch.maximum(hi, lo), touthor)
    conf = swhor & (tin <= tout) & (tout > 0.0) & (tin < tl)
    los = (dist < rpz) & (torch.abs(dalt) < hpz)
    unsure_conf = _unsure([
        (swhor, _near(dcpa2, r2, dist * dist + r2)),
        (tin <= tout, _near(tin, tout, torch.abs(tin) + torch.abs(tout) + tl)
         | _near(torch.abs(dalt), hpz, hpz)),
        (tout > 0.0, _near(tout, 0.0, torch.abs(tout) + tl)),
        (tin < tl, _near(tin, tl, torch.abs(tin) + tl))])
    unsure_los = _unsure([(dist < rpz, _near(dist, rpz, rpz)),
                          (torch.abs(dalt) < hpz,
                           _near(torch.abs(dalt), hpz, hpz))])

    # MVP (upstream ``MVP.py``): the displacement that moves the CPA out
    # of the zone with margin, in the time to CPA, and the vertical one
    rpz_m, hpz_m = rpz * cfg["resofach"], hpz * cfg["resofacv"]
    ve, vn = i["gseast"] - o["gseast"], i["gsnorth"] - o["gsnorth"]
    de_c, dn_c = dx + ve * tcpa, dy + vn * tcpa
    dabsh = torch.sqrt(de_c * de_c + dn_c * dn_c)
    ih = rpz_m - dabsh
    headon = dabsh <= 10.0
    safe = torch.clamp_min(dist, 1e-9)
    de_c = torch.where(headon, dy / safe * 10.0, de_c)
    dn_c = torch.where(headon, -dx / safe * 10.0, dn_c)
    dabsh = torch.where(headon, torch.full_like(dabsh, 10.0), dabsh)
    abstcpa = torch.clamp_min(torch.abs(tcpa), 1e-9)
    dve = ih * de_c / (abstcpa * dabsh)
    dvn = ih * dn_c / (abstcpa * dabsh)
    apply = (rpz_m < dist) & (dabsh < dist)
    err = torch.cos(torch.asin(torch.clamp(rpz_m / safe, -1.0, 1.0))
                    - torch.asin(torch.clamp(dabsh / safe, -1.0, 1.0)))
    err = torch.where(apply, err, torch.ones_like(err))
    err = torch.where(torch.abs(err) < 1e-9, torch.full_like(err, 1e-9), err)
    dve, dvn = dve / err, dvn / err
    has_dvs = torch.abs(vrel_v) > 0.0
    tsolv = torch.where(has_dvs, torch.abs(dalt / torch.where(
        has_dvs, vrel_v, torch.ones_like(vrel_v))), tin)
    iv = torch.where(has_dvs, torch.zeros_like(dalt) + hpz_m,
                     hpz_m - torch.abs(dalt))
    slow = tsolv > tl
    tsolv = torch.where(slow, tin, tsolv)
    iv = torch.where(slow, torch.zeros_like(iv) + hpz_m, iv)
    ts = torch.where(torch.abs(tsolv) < 1e-9, torch.full_like(tsolv, 1e-9),
                     tsolv)
    dvv = torch.where(has_dvs, iv / ts * -torch.sign(vrel_v), iv / ts)
    unsure_mvp = (_near(dabsh, 10.0, dist + torch.abs(tcpa) * 500.0)
                  | _near(dist, rpz_m, dist)
                  | _near(dabsh, dist, dist + torch.abs(tcpa) * 500.0)
                  | _near(tsolv, tl, tl))
    keep, unsure_keep = keep_terms(o, i, cfg)
    live = o["active"] & i["active"]
    conf, los = conf & live, los & live
    unsure = (unsure_conf | unsure_los | (
        (conf | unsure_conf) & (unsure_mvp | unsure_keep))) & live
    return dict(conf=conf, los=los, unsure=unsure, tcpa=tcpa, dve=dve,
                dvn=dvn, dvv=dvv, tsolv=tsolv, cand=conf & keep)


def _take(cols, idx):
    return {k: v[idx] for k, v in cols.items()}


def detect(cols, own_idx, cfg, slack=1e-3):
    """Per-ownship detection and MVP sums of ``own_idx`` [S] against
    every active aircraft of ``cols``.  Returns a dict of [S] tensors:
    ``nconf nlos unsure inconf tcpamax sdve sdvn sdvv tsolv cand``."""
    dev, dt = cols["lat"].device, cols["lat"].dtype
    s = own_idx.numel()
    slot = torch.full((cols["lat"].shape[0],), -1, dtype=torch.long,
                      device=dev)
    slot[own_idx] = torch.arange(s, device=dev)
    z = lambda: torch.zeros(s, dtype=dt, device=dev)
    zi = lambda: torch.zeros(s, dtype=torch.long, device=dev)
    out = dict(nconf=zi(), nlos=zi(), unsure=zi(), cand=zi(), sdve=z(),
               sdvn=z(), sdvv=z(), tcpamax=z(),
               tsolv=torch.full((s,), BIG, dtype=dt, device=dev))
    act = torch.nonzero(cols["active"], as_tuple=True)[0]
    shaky = cols.get("state_unsure")
    for io, ii in pairmod.batched(pairmod.needed(
            cols, own_idx, act, cfg["rpz"], cfg["hpz"], cfg["dtlookahead"],
            radius=pairmod.R_BAND, slack=slack)):
        t = pair_terms(_take(cols, io), _take(cols, ii), cfg)
        if shaky is not None:
            t["unsure"] = t["unsure"] | _shaky_pairs(cols, io, ii, shaky, cfg)
        k = slot[io]
        add = lambda name, v: out[name].index_add_(0, k, v)
        add("nconf", t["conf"].long())
        add("nlos", t["los"].long())
        add("unsure", t["unsure"].long())
        add("cand", t["cand"].long())
        m = t["conf"] & ~cols["noreso"][ii]
        zero = torch.zeros_like(t["dve"])
        add("sdve", torch.where(m, t["dve"], zero))
        add("sdvn", torch.where(m, t["dvn"], zero))
        add("sdvv", torch.where(m, t["dvv"], zero))
        out["tsolv"].scatter_reduce_(0, k, torch.where(
            m, t["tsolv"], torch.full_like(zero, BIG)), "amin")
        out["tcpamax"].scatter_reduce_(0, k, torch.where(
            t["conf"], t["tcpa"], zero), "amax")
    out["inconf"] = out["nconf"] > 0
    out["tcpamax"] = torch.clamp_min(out["tcpamax"], 0.0)
    return out


#: how far a pair's tests are loosened when one of its aircraft reached
#: this interval through a step whose branch the reference could not
#: decide (``step.step``'s unsure mask): a pair whose flags differ
#: between the loosened and the tightened tests may be flagged otherwise
#: in the program.  One step of the
#: other branch moves a speed by 0.025 m/s (7.5 m at the lookahead), a
#: track by ~0.2 degree (~250 m) or a vertical speed by 0.08 m/s (~25 m)
LOOSE_M = {refstep.SPEED: 10.0, refstep.HEADING: 300.0}
LOOSE_V_M = 30.0
LOOSE_S = 5.0


def _shaky_pairs(cols, io, ii, shaky, cfg):
    """Pairs with an unsure aircraft whose conflict or LoS flag differs
    between the loosened and the tightened tests, and conflict pairs with
    an aircraft whose vertical speed is unsure (MVP's vertical branch and
    solve time turn on the sign and size of the vertical closure)."""
    m = (shaky[io] | shaky[ii]) > 0
    out = torch.zeros_like(m)
    if bool(m.any()):
        sel = torch.nonzero(m, as_tuple=True)[0]
        bits = shaky[io[sel]] | shaky[ii[sel]]
        dh = sum(((bits & b) > 0).to(cols["lat"].dtype) * v
                 for b, v in LOOSE_M.items())
        dv = ((bits & refstep.VERTICAL) > 0).to(cols["lat"].dtype) * LOOSE_V_M
        o, i = _take(cols, io[sel]), _take(cols, ii[sel])
        t = [pair_terms(o, i, dict(cfg, rpz=cfg["rpz"] + k * dh,
                                   hpz=cfg["hpz"] + k * dv,
                                   dtlookahead=cfg["dtlookahead"]
                                   + k * LOOSE_S)) for k in (1.0, -1.0)]
        vertical = (bits & refstep.VERTICAL) > 0
        out[sel] = ((t[0]["conf"] != t[1]["conf"])
                    | (t[0]["los"] != t[1]["los"])
                    | (vertical & (t[0]["conf"] | t[1]["conf"])))
    return out


def totals(cols, cfg, slack=1e-3):
    """``(nconf, nlos, unsure)``: the fleet's conflict and LoS pairs
    (ordered) and the pairs among them or near them that are unsure."""
    act = torch.nonzero(cols["active"], as_tuple=True)[0]
    n = torch.zeros(3, dtype=torch.long, device=act.device)
    shaky = cols.get("state_unsure")
    for io, ii in pairmod.batched(pairmod.needed(
            cols, act, act, cfg["rpz"], cfg["hpz"], cfg["dtlookahead"],
            radius=pairmod.R_BAND, slack=slack)):
        t = pair_terms(_take(cols, io), _take(cols, ii), cfg)
        if shaky is not None:
            t["unsure"] = t["unsure"] | _shaky_pairs(cols, io, ii, shaky, cfg)
        n += torch.stack([t[k].sum() for k in ("conf", "los", "unsure")])
    return tuple(int(v) for v in n.tolist())


def resolve(d, own, cfg):
    """MVP commands (upstream ``MVP.resolve``) from the sums ``d`` of
    ``detect`` and the ownships' columns ``own``: a dict of ``asas_trk
    asas_tas asas_vs asas_alt asase asasn``."""
    dve = torch.where(own["resooff"], 0.0, -d["sdve"])
    dvn = torch.where(own["resooff"], 0.0, -d["sdvn"])
    dvv = torch.where(own["resooff"], 0.0, -0.5 * d["sdvv"])
    ve, vn, vv = dve + own["gseast"], dvn + own["gsnorth"], dvv + own["vs"]
    has = dve * dve + dvn * dvn > 0.0
    trk = torch.remainder(aero.degrees(torch.atan2(ve, vn)), 360.0)
    gs = torch.clamp(torch.sqrt(ve * ve + vn * vn), cfg["vmin"], cfg["vmax"])
    vs = torch.clamp(vv, cfg["vsmin"], cfg["vsmax"])
    zero = torch.zeros_like(gs)
    asase = torch.where(has, gs * torch.sin(aero.radians(trk)), zero)
    asasn = torch.where(has, gs * torch.cos(aero.radians(trk)), zero)
    selalt, alt = own["selalt"], own["alt"]
    signdvs = torch.sign(vs - own["ap_vs"] * torch.sign(selalt - alt))
    signalt = torch.sign(own["asas_alt"] - selalt)
    newalt = torch.where((signdvs == 0) | (signdvs == signalt),
                         own["asas_alt"], selalt)
    newalt = torch.where((d["tsolv"] < cfg["dtlookahead"])
                         & (torch.abs(dvv) > 0.0), vs * d["tsolv"] + alt,
                         newalt)
    return dict(asas_trk=trk, asas_tas=gs, asas_vs=vs, asas_alt=newalt,
                asase=asase, asasn=asasn)


def resume(cols, own_idx, partners, cfg):
    """Old partners ``partners`` [S, K] (slot ids, -1 none) of the
    ownships that resume-nav keeps: ``(any kept [S], unsure [S])``."""
    has = partners >= 0
    p = torch.clamp_min(partners, 0)
    o = {k: v[own_idx][:, None].expand_as(p) for k, v in cols.items()}
    i = {k: v[p] for k, v in cols.items()}
    keep, unsure = keep_terms(o, i, cfg)
    if "state_unsure" in cols:
        shaky = (o["state_unsure"] | i["state_unsure"]) > 0
        wide = keep_terms(o, i, cfg, widen=1e3)[1]
        unsure = unsure | (shaky & wide)
    live = has & o["active"] & i["active"] & (p != own_idx[:, None])
    return (keep & live).any(1), (unsure & live).any(1)


#: the perturbation of ``jitter``: positions by a centimetre, speeds by
#: 1e-5 m/s, tracks by 1e-5 degree, altitudes by a millimetre, about the
#: rounding that float32 arithmetic leaves in the pair quantities
JITTER = dict(pos_m=0.01, spd=1e-5, trk=1e-5, alt=1e-3)
#: an ownship's result is unsure when ``jitter`` moves a command more
#: than these (velocities m/s, altitude m) or tcpamax by that share
SENSITIVE = dict(vel=0.01, alt=1.0, tcpa=1e-3)


def _one(cols, own_idx, partners, cfg):
    d = detect(cols, own_idx, cfg)
    own = _take(cols, own_idx)
    cmd = resolve(d, own, cfg)
    upd = d["inconf"]
    asas = {k: torch.where(upd, v, own[k]) for k, v in cmd.items()}
    kept, unsure_old = resume(cols, own_idx, partners, cfg)
    asas["asas_active"] = ((d["cand"] > 0) | kept) & bool(cfg["reso_on"])
    asas["inconf"] = upd
    asas["tcpamax"] = d["tcpamax"]
    d["unsure"] = d["unsure"] + unsure_old.long()
    return asas, d


def jitter(cols, sign):
    """``cols`` with every aircraft moved by ``sign`` times ``JITTER`` in
    a fixed pseudo-random direction of its own (vertical speeds that are
    exactly 0 stay 0, as they do in any precision)."""
    n = cols["lat"].shape[0]
    g = torch.Generator(device="cpu").manual_seed(12345)
    r = lambda: (torch.rand(n, generator=g, dtype=torch.float64) * 2 - 1).to(
        cols["lat"].device, cols["lat"].dtype) * sign
    out = dict(cols)
    m_deg = 180.0 / (aero.Rearth * 3.141592653589793)
    out["lat"] = cols["lat"] + r() * JITTER["pos_m"] * m_deg
    out["lon"] = cols["lon"] + r() * JITTER["pos_m"] * m_deg / torch.clamp_min(
        torch.cos(aero.radians(cols["lat"])), 0.01)
    for k in ("gs", "gseast", "gsnorth"):
        out[k] = cols[k] + r() * JITTER["spd"]
    out["trk"] = cols["trk"] + r() * JITTER["trk"]
    out["alt"] = cols["alt"] + r() * JITTER["alt"]
    out["vs"] = torch.where(cols["vs"] != 0, cols["vs"] + r() * JITTER["spd"],
                            cols["vs"])
    return out


def interval(cols, own_idx, partners, cfg):
    """The interval for the ownships ``own_idx``: returns ``(asas, d)``,
    ``asas`` the resolver's columns after it (``asas_trk asas_tas
    asas_vs asas_alt asase asasn asas_active inconf tcpamax``) and ``d``
    the detection, with the ``unsure`` count of each ownship: its unsure
    pairs and old partners, plus one when its result is ill-conditioned,
    that is when ``jitter`` either way moves its flags, its commands or
    its tcpamax beyond ``SENSITIVE``.  MVP divides by the time to the
    closest point, so a pair near it makes a command that no float
    precision below the reference's decides."""
    asas, d = _one(cols, own_idx, partners, cfg)
    moved = torch.zeros_like(d["unsure"], dtype=torch.bool)
    for sign in (1.0, -1.0):
        a2, _ = _one(jitter(cols, sign), own_idx, partners, cfg)
        diff = lambda k: torch.abs(a2[k] - asas[k])
        moved |= (a2["inconf"] != asas["inconf"]) \
            | (a2["asas_active"] != asas["asas_active"])
        for k in ("asase", "asasn", "asas_vs"):
            moved |= diff(k) > SENSITIVE["vel"]
        moved |= diff("asas_alt") > SENSITIVE["alt"]
        moved |= diff("tcpamax") > SENSITIVE["tcpa"] * torch.clamp_min(
            asas["tcpamax"], 10.0)
    d["unsure"] = d["unsure"] + moved.long()
    return asas, d
