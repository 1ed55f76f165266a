"""BADA 3 coefficient loader: SYNONYM.NEW + per-type OPF/APF files.

Parity with the reference ``traffic/performance/bada/coeff_bada.py:70-230``
(EEC Technical Report 14/04/24-44 file layout): the synonym table maps
ICAO type codes to coefficient files; each ``.OPF`` carries the mass,
envelope, aerodynamics, thrust, fuel and ground blocks; the optional
``.APF`` carries low/avg/high reference speed profiles.  BADA data is
proprietary and NOT shipped — ``load_bada_dir`` returns {} when the
directory has no SYNONYM.NEW, and everything here is exercised in tests
against synthetic files written in the exact BADA fixed-width format.

Structure divergence: coefficients land in plain per-type dicts (the
slot filler's common currency) instead of ACData attribute objects.

Port of ``bluesky_tpu/models/coeff_bada.py``: host code, copied as it
is (the unit constants from the port's ``ops/aero``).
"""
import os
import re
from glob import glob
from typing import Dict, Tuple

from .fwparser import FixedWidthParser, ParseError

SYN_FORMAT = ["CD, 1X, 1S, 1X, 4S, 3X, 18S, 1X, 25S, 1X, 6S, 2X, 1S"]

OPF_FORMAT = [
    # aircraft type block (1 data line)
    "CD, 3X, 6S, 9X, 1I, 12X, 9S, 17X, 1S",
    # mass block (1 data line)
    "CD, 2X, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F",
    # flight envelope block (1 data line)
    "CD, 2X, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F",
    # aerodynamics block (12 data lines)
    "CD, 2X, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F",
    "CD, 15X, 3X, 10F, 3X, 10F, 3X, 10F",
    "CD, 15X, 3X, 10F, 3X, 10F, 3X, 10F",
    "CD, 15X, 3X, 10F, 3X, 10F, 3X, 10F",
    "CD, 15X, 3X, 10F, 3X, 10F, 3X, 10F",
    "CD, 15X, 3X, 10F, 3X, 10F, 3X, 10F",
    "CD 50X",
    "CD 50X",
    "CD 50X",
    "CD, 31X, 10F",
    "CD 50X",
    "CD 50X",
    # engine thrust block (3 data lines)
    "CD, 2X, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F",
    "CD, 2X, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F",
    "CD, 2X, 3X, 10F, 3X, 10F",
    # fuel consumption block (3 data lines)
    "CD, 2X, 3X, 10F, 3X, 10F",
    "CD, 2X, 3X, 10F, 3X, 10F",
    "CD, 5X, 10F",
    # ground movement block (1 data line)
    "CD, 2X, 3X, 10F, 3X, 10F, 3X, 10F, 3X, 10F",
]

APF_FORMAT = [
    "CD, 2X, 3S, 1X, 2S, 4X, 15S",
    "CD, 25X, 3I, 1X, 3I, 1X, 2I, 10X, 3I, 1X, 3I, 1X, 2I, 2X, 2I, 1X, "
    "3I, 1X, 3I",
    "CD, 25X, 3I, 1X, 3I, 1X, 2I, 10X, 3I, 1X, 3I, 1X, 2I, 2X, 2I, 1X, "
    "3I, 1X, 3I",
    "CD, 25X, 3I, 1X, 3I, 1X, 2I, 10X, 3I, 1X, 3I, 1X, 2I, 2X, 2I, 1X, "
    "3I, 1X, 3I",
]

syn_parser = FixedWidthParser(SYN_FORMAT)
opf_parser = FixedWidthParser(OPF_FORMAT)
apf_parser = FixedWidthParser(APF_FORMAT)

# Global model constants (reference ACData class attrs, coeff_bada.py:155-166)
CVMIN = 1.3
CVMIN_TO = 1.2
CRED_TURBOPROP = 0.25
CRED_JET = 0.15
CRED_PISTON = 0.0
GR_ACC = 2.0   # from BADA.gpf


def parse_opf(fname: str) -> dict:
    """One .OPF file -> coefficient dict (cf. ACData.setOPFData,
    coeff_bada.py:167-199)."""
    data = opf_parser.parse(fname)
    d = {}
    d["actype"], d["neng"], d["engtype"], d["weightcat"] = data[0]
    d["actype"] = d["actype"].strip("_")
    (d["m_ref"], d["m_min"], d["m_max"], d["m_paymax"],
     d["mass_grad"]) = data[1]
    d["vmo"], d["mmo"], d["h_mo"], d["h_max"], d["temp_grad"] = data[2]
    d["S"], d["Clbo"], d["k"], d["CM16"] = data[3]
    for i, ph in enumerate(("cr", "ic", "to", "ap", "ld")):
        d[f"vstall_{ph}"], d[f"cd0_{ph}"], d[f"cd2_{ph}"] = data[4 + i]
    d["cd0_gear"] = data[12][0]
    d["ctc"] = data[15]
    (d["ctdes_low"], d["ctdes_high"], d["hp_des"], d["ctdes_app"],
     d["ctdes_land"]) = data[16]
    d["vdes_ref"], d["mdes_ref"] = data[17]
    d["cf1"], d["cf2"] = data[18]
    d["cf3"], d["cf4"] = data[19]
    # guard division by zero in fuel flow (perfbada.py:318-320)
    d["cf2"] = d["cf2"] if abs(d["cf2"]) > 1e-9 else 1.0
    d["cf4"] = d["cf4"] if abs(d["cf4"]) > 1e-9 else 1.0
    d["cf_cruise"] = data[20][0]
    d["tol"], d["ldl"], d["wingspan"], d["length"] = data[21]
    return d


def parse_apf(fname: str) -> dict:
    """One .APF file -> reference-speed profiles (ACData.setAPFData)."""
    data = apf_parser.parse(fname)
    cols = list(zip(*data[1:]))
    keys = ("cascl1", "cascl2", "mcl", "cascr1", "cascr2", "mcr",
            "mdes", "casdes2", "casdes1")
    d = {k: list(v) for k, v in zip(keys, cols)}
    for k in ("mcl", "mcr", "mdes"):
        d[k] = [m / 100.0 for m in d[k]]   # Mach stored *100 in BADA
    return d


def load_bada_dir(path: str) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """(synonyms, coefficient sets) from a BADA data directory.

    synonyms: {icao_code: {"file": ..., "is_equiv": ..., ...}};
    coeffs: {coeff_file_stem: dict}.  Empty dicts when SYNONYM.NEW is
    absent (the proprietary data is not shipped; coeff_bada.py:107-117).
    """
    synfile = os.path.join(path, "SYNONYM.NEW")
    if not os.path.isfile(synfile):
        return {}, {}
    synonyms = {}
    for row in syn_parser.parse(synfile):
        synonyms[row[1].strip()] = dict(
            is_equiv=(row[0] == "*"), accode=row[1].strip(),
            manufact=row[2].strip(), model=row[3].strip(),
            file=row[4].strip(), icao=(row[5].strip().upper() == "Y"))
    coeffs = {}
    for fname in sorted(glob(os.path.join(path, "*.OPF"))):
        try:
            d = parse_opf(fname)
            apf = fname[:-4] + ".APF"
            if os.path.isfile(apf):
                d.update(parse_apf(apf))
        except (ParseError, IndexError, ValueError):
            continue
        coeffs[d["actype"]] = d
    return synonyms, coeffs


def bada_to_generic(d: dict) -> dict:
    """Map a BADA OPF dict onto the generic PerfArrays column keys.

    Units per the BADA 3.12 manual: masses in tonnes, speeds in kt,
    altitudes in ft, wing area in m2.  Approximations are explicit: the
    engthr column takes the first max-climb thrust coefficient CTC1 (the
    sea-level static value for jets); fuel-flow anchors are evaluated
    from the TSFC law at representative speeds; the full BADA
    thrust/fuel regimes live in ops/perf_bada.py.
    """
    from ..ops import aero
    kts, ft = aero.kts, aero.ft
    jet = d["engtype"].strip().lower().startswith("jet")
    ctc1 = d["ctc"][0]
    engthr = ctc1 if jet else ctc1 / 75.0 * kts  # TP: kt·N at ~150 kt
    # TSFC eta [kg/(min·kN)] -> nominal flows at TO/climb-out/approach/
    # idle representative speeds (perfbada.py:483-520 law)
    def ff_at(tas_kt, thr_frac):
        eta = d["cf1"] * (1.0 + tas_kt / d["cf2"]) / 1000.0
        return eta * engthr * thr_frac / 60.0
    mass_kg = d["m_ref"] * 1000.0
    vminto = CVMIN_TO * d["vstall_to"] * kts
    vminic = CVMIN * d["vstall_ic"] * kts
    vmincr = CVMIN * d["vstall_cr"] * kts
    vminap = CVMIN * d["vstall_ap"] * kts
    vminld = CVMIN * d["vstall_ld"] * kts
    return dict(
        n_engines=int(d["neng"]), wa=d["S"],
        mtow=d["m_max"] * 1000.0, oew=2.0 * mass_kg - d["m_max"] * 1000.0,
        engthr=engthr / max(int(d["neng"]), 1),
        engbpr=6.0 if jet else 0.0,
        ff_to=ff_at(160.0, 1.0), ff_co=ff_at(250.0, 0.85),
        ff_app=ff_at(140.0, 0.3), ff_idl=ff_at(0.0, 0.07),
        cd0_clean=d["cd0_cr"], cd0_gd=d["cd0_cr"] + d["cd0_gear"],
        cd0_to=d["cd0_to"], cd0_ic=d["cd0_ic"],
        cd0_ap=d["cd0_ap"], cd0_ld=d["cd0_ld"] + d["cd0_gear"],
        k=d["cd2_cr"],
        vminto=vminto, vmaxto=vminto * 1.4,
        vminic=vminic, vmaxic=vminic * 1.5,
        vminer=vmincr, vmaxer=d["vmo"] * kts,
        vminap=vminap, vmaxap=vminap * 1.8,
        vminld=vminld, vmaxld=vminld * 1.5,
        vsmin=-3000.0 * aero.fpm, vsmax=2500.0 * aero.fpm,
        hmax=d["h_max"] * ft, axmax=GR_ACC)


def get_coefficients(synonyms, coeffs, actype):
    """Synonym-resolved lookup (coeff_bada.py:72-88); returns dict or
    None."""
    syn = synonyms.get(actype)
    if syn is None:
        return None
    # coefficient files are keyed by the actype stored inside the OPF
    hit = coeffs.get(actype)
    if hit is not None:
        return hit
    stem = re.sub(r"_+$", "", syn["file"])
    return coeffs.get(stem)
