"""Legacy BlueSky (BS) performance coefficient database.

Parses the reference's conceptual-design XML files
(``data/performance/BS/{aircraft,engines}``) into per-type dicts, with
operation-for-operation parity to the reference ``CoeffBS``
(``traffic/performance/legacy/coeff_bs.py:31-363``): unit conversion
table, derived takeoff/landing minimum speeds (CS-25.107 factors or
clmax fallback), Raymer parasite drag from Cfe*Swet/Sref, Obert/Nita
induced-drag fallback for missing Oswald factors, ADS-B-statistical
ground accelerations, and the BPR-category SFC table for jet engines.

Structure divergence: per-type dicts (merged aircraft+engine view per
first-listed available engine) instead of 30 parallel lists — the slot
filler writes columns from one dict lookup.

Port of ``bluesky_tpu/models/coeff_bs.py``: host code, copied as it is
(the unit constants from the port's ``ops/aero``).
"""
import os
from math import pi, sqrt
from xml.etree import ElementTree
from typing import Dict, Optional

from ..ops import aero

# Unit conversion factors (coeff_bs.py:34-52)
_FACTORS = {
    "kg": 1.0, "t": 1000.0, "lbs": aero.lbs, "N": 1.0, "W": 1.0,
    "m": 1.0, "km": 1000.0, "inch": aero.inch, "ft": aero.ft,
    "sqm": 1.0, "sqft": aero.sqft, "sqin": 0.0254 * 0.0254,
    "m/s": 1.0, "km/h": 1.0 / 3.6, "kts": aero.kts, "fpm": aero.fpm,
    "kg/s": 1.0, "kg/m": 1.0 / 60.0, "mug/J": 1e-6, "mg/J": 1e-3,
    "kW": 1000.0, "kN": 1000.0, "": 1.0,
}

# Phase-dependent drag scaling, order TO/IC/CR/AP/LD/LD-gear
# (FAA 2005 SAGE; coeff_bs.py:98-102)
D_CD0_JET = [1.476, 1.143, 1.0, 1.957, 3.601, 1.037]
D_K_JET = [1.01, 1.071, 1.0, 0.992, 0.932, 1.0]
D_CD0_TP = [1.220, 1.0, 1.0, 1.279, 1.828, 0.496]
D_K_TP = [0.948, 1.0, 1.0, 0.94, 0.916, 1.0]

# Jet SFC by bypass-ratio category (Raymer p.36; coeff_bs.py:306-309)
SFC_BY_BPR_CAT = [14.1, 22.7, 25.5]


def _convert(node):
    unit = node.attrib.get("unit", "")
    return _FACTORS.get(unit, 1.0) * float(node.text)


def load_engines(path: str) -> Dict[str, dict]:
    """engines/*.xml -> {name: engine dict} (coeff_bs.py:291-330)."""
    out = {}
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".xml"):
            continue
        doc = ElementTree.parse(os.path.join(path, fname))
        name = doc.find("engines/engine").text
        etype = int(doc.find("engines/eng_type").text)
        d = dict(name=name, eng_type=etype)
        if etype == 1:      # jet
            d["thr"] = _convert(doc.find("engines/Thr"))
            d["bpr_cat"] = int(doc.find("engines/BPR_cat").text)
            d["sfc"] = SFC_BY_BPR_CAT[d["bpr_cat"]]
            for ff in ("ff_to", "ff_cl", "ff_cr", "ff_ap", "ff_id"):
                d[ff] = _convert(doc.find(f"ff/{ff}"))
        elif etype == 2:    # turboprop
            d["power"] = _convert(doc.find("engines/Power"))
            psfc_to = _convert(doc.find("SFC/SFC_TO"))
            d["psfc_to"] = psfc_to
            # Babikian cruise-PSFC fit (coeff_bs.py:327-329)
            d["psfc_cr"] = (0.7675 * psfc_to * 1e6 + 23.576) * 1e-6
        out[name] = d
    return out


def load_aircraft_file(fname: str) -> Optional[dict]:
    """One aircraft XML -> coefficient dict (coeff_bs.py:112-271)."""
    doc = ElementTree.parse(fname)
    d = {}
    d["actype"] = doc.find("ac_type").text
    etype = int(doc.find("engine/eng_type").text)
    d["eng_type"] = etype
    d["n_eng"] = float(doc.find("engine/num_eng").text)
    d["engines"] = [e.text for e in doc.findall("engine/eng")]

    mtow = _convert(doc.find("weights/MTOW"))
    mlw = _convert(doc.find("weights/MLW"))
    d["mtow"] = mtow
    span = _convert(doc.find("dimensions/span"))
    sref = _convert(doc.find("dimensions/wing_area"))
    swet = _convert(doc.find("dimensions/wetted_area"))
    d["sref"] = sref

    crma = float(doc.find("speeds/cr_MA").text)
    d["cr_mach"] = crma if crma != 0.0 else 0.8
    crspd = doc.find("speeds/cr_spd")
    d["cr_spd"] = _convert(crspd) if float(crspd.text) != 0.0 \
        else 250.0 * aero.kts

    # Ground accel/decel by engine type / engine count (coeff_bs.py:171-190)
    if etype == 2:
        d["gr_acc"], d["gr_dec"] = 2.12, 1.12
    elif d["n_eng"] == 2.0:
        d["gr_acc"], d["gr_dec"] = 1.94, 1.265
    else:
        d["gr_acc"], d["gr_dec"] = 1.68, 1.131

    # Minimum takeoff speed (coeff_bs.py:194-201)
    tospd = doc.find("speeds/to_spd")
    if float(tospd.text) == 0.0:
        clmax_to = float(doc.find("aerodynamics/clmax_to").text)
        d["vmto"] = sqrt((2.0 * aero.g0) / (sref * clmax_to))
    else:
        d["vmto"] = _convert(tospd) / (1.13 * sqrt(mtow / aero.rho0))
    d["clmax_cr"] = float(doc.find("aerodynamics/clmax_cr").text)

    # Minimum landing speed (coeff_bs.py:207-214)
    ldspd = doc.find("speeds/ld_spd")
    if float(ldspd.text) == 0.0:
        clmax_ld = float(doc.find("aerodynamics/clmax_ld").text)
        d["vmld"] = sqrt((2.0 * aero.g0) / (sref * clmax_ld))
    else:
        d["vmld"] = _convert(ldspd) / (1.23 * sqrt(mlw / aero.rho0))

    maxspd = doc.find("limits/max_spd")
    d["max_spd"] = _convert(maxspd) if float(maxspd.text) != 0.0 else 400.0
    maxma = doc.find("limits/max_MA")
    d["max_mach"] = float(maxma.text) if float(maxma.text) != 0.0 else 0.8
    maxalt = doc.find("limits/max_alt")
    d["max_alt"] = _convert(maxalt) if float(maxalt.text) != 0.0 \
        else 11000.0

    # Parasite drag (Raymer p.429) + induced drag (coeff_bs.py:241-251)
    cfe = float(doc.find("aerodynamics/Cfe").text)
    d["cd0"] = cfe * swet / sref
    oswald = float(doc.find("aerodynamics/oswald").text)
    ar = span * span / sref
    if oswald == 0.0:
        # Obert 2009 p.542 / Nita 2012 fallback
        d["k"] = 1.02 / (pi * ar) + 0.009
    else:
        d["k"] = 1.0 / (pi * oswald * ar)
    return d


def bs_to_generic(d: dict) -> dict:
    """Map a BS coefficient dict onto the generic PerfArrays column keys
    (the OpenAP-shaped slot schema in models/perf_coeffs.py).

    This gives the scanned step real per-type legacy data (mass, wing,
    thrust, drag polar with the SAGE phase scalings baked into the
    per-phase cd0 columns, fuel flows, envelope); the *full* legacy
    physics (ESF thrust/fuel regimes) lives in ops/perf_legacy.py /
    ops/perf_bada.py as golden-tested kernels.  Approximations are
    explicit below.
    """
    import math
    eng = d.get("engine", {})
    etype = d.get("eng_type", 1)
    scale = D_CD0_JET if etype == 1 else D_CD0_TP
    cd0 = d["cd0"]
    if etype == 1:
        engthr = eng.get("thr", 120000.0)
        ffs = dict(ff_idl=eng.get("ff_id", 0.1),
                   ff_app=eng.get("ff_ap", 0.3),
                   ff_co=eng.get("ff_cl", 0.9), ff_to=eng.get("ff_to", 1.2))
    else:
        # Turboprop: power-to-thrust at the Raymer propeller efficiency
        # and a representative 75 m/s climb-out speed (approximation —
        # the reference models TP thrust via power/speed continuously)
        power = eng.get("power", 2e6)
        engthr = 0.8 * power / 75.0
        psfc = eng.get("psfc_to", 0.7e-6)
        ffs = dict(ff_idl=psfc * power * 0.1, ff_app=psfc * power * 0.3,
                   ff_co=psfc * power * 0.85, ff_to=psfc * power)
    # Legacy vmto/vmld are CS-25 coefficients multiplied by
    # sqrt(mass/rho) at runtime; evaluated at MTOW, sea-level ISA here.
    sqmr = math.sqrt(d["mtow"] / aero.rho0)
    vminto = d["vmto"] * sqmr
    vminld = d["vmld"] * sqmr
    # Minimum clean-config speed from clmax_cr at MTOW/SL
    vmincr = math.sqrt(2.0 * d["mtow"] * aero.g0
                       / (aero.rho0 * d["clmax_cr"] * d["sref"]))
    return dict(
        # slot mass = 0.5*(oew+mtow); the legacy model flies at MTOW
        # (perfbs.py:128), so oew is set to mtow to reproduce that
        n_engines=int(d["n_eng"]), wa=d["sref"],
        mtow=d["mtow"], oew=d["mtow"],
        engthr=engthr, engbpr=6.0 if etype == 1 else 0.0,
        cd0_clean=cd0 * scale[2], cd0_gd=cd0 * scale[5],
        cd0_to=cd0 * scale[0], cd0_ic=cd0 * scale[1],
        cd0_ap=cd0 * scale[3], cd0_ld=cd0 * scale[4],
        k=d["k"],
        vminto=vminto, vmaxto=vminto * 1.4,
        vminic=vminto * 1.1, vmaxic=vminto * 1.5,
        vminer=vmincr, vmaxer=d["max_spd"],
        vminap=vminld * 1.1, vmaxap=vminld * 1.8,
        vminld=vminld, vmaxld=vminld * 1.5,
        vsmin=-3000.0 * aero.fpm, vsmax=2500.0 * aero.fpm,
        hmax=d["max_alt"], axmax=d["gr_acc"],
        **ffs)


def load_bs_dir(path: str) -> Dict[str, dict]:
    """Parse a BS-layout directory: {actype: merged aircraft+engine dict}.

    The first engine listed in the aircraft file that exists in the
    engine database is merged in (coeff_bs.py:258-262 "first engine is
    taken!").  Returns {} if the directory is missing.
    """
    acdir = os.path.join(path, "aircraft")
    endir = os.path.join(path, "engines")
    if not os.path.isdir(acdir) or not os.path.isdir(endir):
        return {}
    engines = load_engines(endir)
    out = {}
    for fname in sorted(os.listdir(acdir)):
        if not fname.endswith(".xml"):
            continue
        try:
            d = load_aircraft_file(os.path.join(acdir, fname))
        except (ElementTree.ParseError, AttributeError, ValueError):
            continue
        if d is None:
            continue
        eng = next((engines[e] for e in d["engines"] if e in engines),
                   None)
        if eng is not None:
            d["engine"] = eng
        out[d["actype"].upper()] = d
    return out
