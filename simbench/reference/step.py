"""The per-aircraft step of upstream BlueSky for aircraft that cruise
without a route: the FMS and autopilot targets, the pilot's choice
between autopilot and ASAS, the OpenAP-style flight envelope, and the
airspeed, heading, vertical-speed and position updates of
``traffic.py``.  Plain PyTorch on columns of any float dtype.

A state is a dict of [n] columns: the aircraft's ``lat lon alt hdg trk
tas gs gsnorth gseast cas mach vs selspd selalt selvs apvsdef ax bank
active``, the autopilot's ``ap_trk ap_tas ap_alt ap_vs`` and the
resolver's ``asas_trk asas_tas asas_alt asas_vs asas_active``.  The
gates and the clocks are numpy scalars in the configuration's float
dtype, as the simulation keeps them.

``step`` also returns which aircraft met a branch of the bang-bang
controls (or of the envelope) so close to its threshold that the
rounding of the configuration's dtype could take the other branch:
their state is not compared.  It is a bit mask of what the other branch
would move: ``SPEED``, ``HEADING`` or ``VERTICAL``.
"""
import numpy as np
import torch

from . import aero

FMS_DT = 1.01          # [s] the FMS interval of upstream's autopilot
#: the clocks of a new simulation (upstream's ``sim.simt``,
#: ``autopilot.t0`` and ``asas.tnext``)
START_CLOCKS = dict(simt=0.0, fms_t0=-999.0, asas_tnext=0.0)

# flight phases (upstream ``performance/openap/phase.py``)
GD, IC, AP, CL, DE, CR = range(6)
# what an unsure branch would move
SPEED, HEADING, VERTICAL = 1, 2, 4


def next_gates(clocks, simdt, dtasas, dtype):
    """``(fms, asas, clocks)`` of one step: upstream's gates on the host
    clocks ``dict(simt, fms_t0, asas_tnext)`` in ``dtype`` (a numpy
    float type)."""
    t, t0, tn = (dtype(clocks[k]) for k in ("simt", "fms_t0", "asas_tnext"))
    fms = bool((t0 + dtype(FMS_DT) < t) | (t < t0) | (t < dtype(FMS_DT)))
    asas = bool(t >= tn)
    return fms, asas, dict(simt=t + dtype(simdt), fms_t0=t if fms else t0,
                           asas_tnext=tn + dtype(dtasas) if asas else tn)


def _near(x, thr, scale):
    """Whether ``x`` lies within ``scale`` of the threshold ``thr``."""
    return torch.abs(x - thr) <= scale


def phase_of(tas, vs, alt):
    """Flight phase of upstream's OpenAP phase rules (later ones win)."""
    roc = vs / aero.fpm
    hft = alt / aero.ft
    ph = torch.full(tas.shape, -1, dtype=torch.int64, device=tas.device)
    for cond, val in (
            ((hft <= 10) & (roc <= 100) & (roc >= -100), GD),
            ((hft >= 0) & (hft <= 1000) & (roc >= 0), IC),
            ((hft >= 0) & (hft <= 1000) & (roc <= 0), AP),
            ((hft >= 1000) & (roc >= 100), CL),
            ((hft >= 1000) & (roc <= -100), DE),
            ((hft >= 5000) & (roc <= 100) & (roc >= -100), CR)):
        ph = torch.where(cond, torch.full_like(ph, val), ph)
    unsure = (_near(roc, 100.0, 1e-3) | _near(roc, -100.0, 1e-3)
              | _near(hft, 1000.0, 1e-2) | _near(hft, 5000.0, 1e-2)
              | _near(hft, 10.0, 1e-2))
    return ph, unsure


def envelope(ph, env):
    """(vmin, vmax [CAS m/s], bank [rad]) of each phase, from the type's
    envelope ``env`` (a dict of the configuration's performance
    numbers)."""
    full = lambda v: torch.full(ph.shape, float(v), dtype=torch.float64,
                                device=ph.device)
    vmin = full(0.0)
    vmax = full(env["vmaxer"])
    for p, lo, hi in ((IC, "vminic", "vmaxic"), (AP, "vminap", "vmaxap")):
        vmin = torch.where(ph == p, full(env[lo]), vmin)
        vmax = torch.where(ph == p, full(env[hi]), vmax)
    er = (ph == CL) | (ph == CR) | (ph == DE)
    vmin = torch.where(er, full(env["vminer"]), vmin)
    bank = torch.where((ph == IC) | (ph == CR) | (ph == AP), full(35.0),
                       full(25.0))
    return vmin, vmax, aero.radians(bank)


def step(s, env, simdt, fms, asas_update=None):
    """One step of every aircraft of ``s``.  ``asas_update(s)`` (when the
    interval is due) returns ``s`` with the resolver's columns set.
    Returns ``(s, unsure)``, ``unsure`` the bit mask of each aircraft."""
    dt = simdt
    f = lambda v: v.to(s["lat"].dtype) if torch.is_tensor(v) else v
    s = dict(s)
    # FMS: without a route the autopilot holds the selected altitude and
    # takes the default vertical speed unless one is selected
    if fms:
        s["ap_vs"] = torch.where(torch.abs(s["selvs"]) > 0.1, s["selvs"],
                                 s["apvsdef"])
        s["ap_alt"] = s["selalt"]
    s["ap_tas"] = aero.vspd2tas(s["selspd"], s["alt"])
    if asas_update is not None:
        s = asas_update(s)

    # pilot: the resolver's targets while it is active, else the AP's
    act = s["asas_active"]
    trk_t = torch.where(act, s["asas_trk"], s["ap_trk"])
    tas_t = torch.where(act, s["asas_tas"], s["ap_tas"])
    alt_t = torch.where(act, s["asas_alt"], s["ap_alt"])
    vs_t = torch.abs(torch.where(act, s["asas_vs"], s["ap_vs"]))
    hdg_t = torch.remainder(trk_t, 360.0)

    # envelope (the phase of the state before this step's kinematics)
    ph, unsure_ph = phase_of(s["tas"], s["vs"], s["alt"])
    kind = lambda m, bit: m.to(torch.int64) * bit
    unsure = kind(unsure_ph, SPEED | HEADING | VERTICAL)
    vmin, vmax, bank = envelope(ph, env)
    vmin, vmax, bank = f(vmin), f(vmax), f(bank)
    allow_alt = torch.clamp_max(alt_t, float(env["hmax"]))
    cas_t = aero.vtas2cas(tas_t, allow_alt)
    allow_tas = aero.vcas2tas(torch.minimum(torch.maximum(cas_t, vmin), vmax),
                              allow_alt)
    vsmax, vsmin = float(env["vsmax"]), float(env["vsmin"])
    allow_vs = torch.where(vs_t > vsmax,
                           (1.0 - s["ax"] / float(env["axmax"])) * vsmax, vs_t)
    allow_vs = torch.where(vs_t < vsmin, torch.full_like(vs_t, vsmin),
                           allow_vs)
    unsure |= kind(_near(vs_t, vsmax, 1e-4) | _near(vs_t, vsmin, 1e-4),
                   VERTICAL)

    # airspeed: a fixed acceleration outside a one-knot dead band
    accel = torch.where(ph == GD, 2.0, 0.5).to(s["tas"].dtype)
    dspd = allow_tas - s["tas"]
    need_ax = torch.abs(dspd) > aero.kts
    # the acceleration also sets the envelope's climb rate while the
    # target rate is over it, so a speed branch moves the vertical too
    unsure |= kind(_near(torch.abs(dspd), aero.kts, 1e-3),
                   SPEED) * (1 + (vs_t > vsmax) * VERTICAL)
    ax = need_ax * torch.sign(dspd) * accel
    tas = s["tas"] + ax * dt
    # heading: the bank's turn rate until within two steps of the target
    turnrate = aero.degrees(aero.g0 * torch.tan(bank)
                            / torch.clamp_min(tas, 0.01))
    dhdg = torch.remainder(hdg_t - s["hdg"] + 180.0, 360.0) - 180.0
    swhdgsel = torch.abs(dhdg) > torch.abs(2.0 * dt * turnrate)
    unsure |= kind(_near(torch.abs(dhdg), torch.abs(2.0 * dt * turnrate),
                         1e-4) | _near(torch.abs(dhdg), 180.0, 1e-4), HEADING)
    hdg = torch.remainder(s["hdg"] + dt * turnrate * swhdgsel
                          * torch.sign(dhdg), 360.0)
    # vertical: toward the target altitude at the allowed rate, the
    # rate slewing at 300 fpm per second
    dalt = allow_alt - s["alt"]
    band = torch.clamp_min(torch.abs(2.0 * dt * torch.abs(s["vs"])),
                           10.0 * aero.ft)
    swaltsel = torch.abs(dalt) > band
    unsure |= kind(_near(torch.abs(dalt), band, 1e-3), VERTICAL)
    target_vs = swaltsel * torch.sign(dalt) * torch.abs(allow_vs)
    dvs = target_vs - s["vs"]
    need_az = torch.abs(dvs) > 300.0 * aero.fpm
    unsure |= kind(_near(torch.abs(dvs), 300.0 * aero.fpm, 1e-4), VERTICAL)
    vs = torch.where(need_az, s["vs"] + need_az * torch.sign(dvs)
                     * (300.0 * aero.fpm) * dt, target_vs)

    # ground speed without wind, then the position on the mean sphere
    hr = aero.radians(hdg)
    gsn, gse = tas * torch.cos(hr), tas * torch.sin(hr)
    alt = torch.where(swaltsel, s["alt"] + vs * dt, allow_alt)
    lat = s["lat"] + aero.degrees(dt * gsn / aero.Rearth)
    coslat = torch.cos(aero.radians(lat))
    lon = s["lon"] + aero.degrees(dt * gse / coslat / aero.Rearth)

    live = s["active"]
    keep = lambda new, k: torch.where(live, new, s[k])
    s.update(lat=keep(lat, "lat"), lon=keep(lon, "lon"),
             alt=keep(alt, "alt"), hdg=keep(hdg, "hdg"),
             trk=keep(hdg, "trk"), tas=keep(tas, "tas"), gs=keep(tas, "gs"),
             vs=keep(vs, "vs"), gsnorth=gsn, gseast=gse,
             cas=aero.vtas2cas(tas, s["alt"]),
             mach=aero.vtas2mach(tas, s["alt"]), ax=ax, bank=bank,
             coslat=coslat)
    return s, unsure * live


def initial(cols, dtype=torch.float64, device="cpu"):
    """The state upstream's ``Traffic.create`` gives aircraft created at
    ``cols`` (lat, lon, alt [m], spd [CAS m/s or Mach], hdg [deg]; numpy):
    the aircraft columns the step starts from."""
    t = lambda k: torch.as_tensor(np.asarray(cols[k], np.float64),
                                  device=device).to(dtype)
    lat, lon, alt, spd, hdg = (t(k) for k in ("lat", "lon", "alt", "spd",
                                              "hdg"))
    ismach = (spd > 0.1) & (spd < 1.0)
    tas = torch.where(ismach, spd * aero.vsound(alt), aero.vcas2tas(spd, alt))
    cas = torch.where(ismach, aero.vtas2cas(tas, alt), spd)
    hr = aero.radians(hdg)
    return dict(lat=lat, lon=lon, alt=alt, hdg=hdg, trk=hdg, tas=tas,
                gs=tas, gsnorth=tas * torch.cos(hr),
                gseast=tas * torch.sin(hr), cas=cas,
                mach=aero.vtas2mach(tas, alt), selspd=cas, selalt=alt,
                coslat=torch.cos(aero.radians(lat)))


def created(cols, dtype=torch.float64, device="cpu"):
    """Every column of ``step``'s state for aircraft created at ``cols``
    (``initial``), with the rest of upstream's ``Traffic.create``
    defaults: level flight at the created speed and altitude, the
    autopilot holding them, the resolver off."""
    s = initial(cols, dtype, device)
    s.pop("coslat")
    z = torch.zeros_like(s["lat"])
    no = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    s.update(vs=z, selvs=z, apvsdef=torch.full_like(z, 1500.0 * aero.fpm),
             ax=torch.full_like(z, aero.kts),
             bank=torch.full_like(z, float(np.radians(25.0))),
             active=~no, swlnav=no, swvnav=no,
             ap_trk=s["hdg"], ap_tas=s["tas"], ap_alt=s["alt"], ap_vs=z,
             asas_trk=s["hdg"], asas_tas=s["tas"], asas_alt=s["alt"],
             asas_vs=z, asas_active=no, asase=z, asasn=z, inconf=no,
             tcpamax=z, noreso=no, resooff=no)
    return s
