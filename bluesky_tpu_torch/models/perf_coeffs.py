"""Aircraft performance coefficients: built-in defaults + OpenAP-dir loader.

Port of ``bluesky_tpu/models/perf_coeffs.py``: the BUILTIN tables, the
stdlib OpenAP directory parser and ``CoeffDB`` are host-side and copied
as they are; ``empty_perf_arrays`` allocates tensors.  ``CoeffDB``
reads the OpenAP layout, the BS XML database (``<perf_path>/BS``,
``models/coeff_bs.py``) or BADA (``<perf_path>/BADA``,
``models/coeff_bada.py``) as ``settings.performance_model`` says.
"""
import csv
import json
import os
from typing import Dict, Optional

import torch

# Flight-phase codes (reference openap/phase.py:4-12)
PH_NA, PH_TO, PH_IC, PH_CL, PH_CR, PH_DE, PH_AP, PH_LD, PH_GD = range(9)

KTS = 0.514444
FPM = 0.3048 / 60.0
FT = 0.3048

# Approximate built-in per-type coefficients.  Keys mirror what the OpenAP
# loader produces.  Envelope speeds are CAS [m/s], vs limits [m/s], hmax [m],
# axmax [m/s2]; thr is total static thrust of ONE engine [N]; mass is the
# midpoint of OEW and MTOW like the reference uses (perfoap.py:81).
_A320ISH = dict(
    n_engines=2, wa=122.6, mtow=78000.0, oew=42600.0,
    engthr=120000.0, engbpr=5.7,
    ff_idl=0.10, ff_app=0.32, ff_co=0.95, ff_to=1.17,
    cd0_clean=0.022, cd0_gd=0.055, cd0_to=0.077, cd0_ic=0.042,
    cd0_ap=0.052, cd0_ld=0.120, k=0.037,
    vminto=74.0, vmaxto=96.0, vminic=76.0, vmaxic=90.0,
    vminer=124.0, vmaxer=180.0, vminap=60.0, vmaxap=90.0,
    vminld=55.0, vmaxld=75.0,
    vsmin=-3000.0 * FPM, vsmax=2500.0 * FPM, hmax=12500.0,  # [m] ~FL410
    axmax=1.8,
)

def _variant(base, **kw):
    d = dict(base)
    d.update(kw)
    return d

BUILTIN: Dict[str, dict] = {
    'A320': dict(_A320ISH),
    'A319': _variant(_A320ISH, mtow=70000.0, oew=40800.0, wa=122.6),
    'A321': _variant(_A320ISH, mtow=89000.0, oew=48500.0, wa=122.6,
                     engthr=133000.0),
    'B738': _variant(_A320ISH, mtow=79010.0, oew=41413.0, wa=124.6,
                     engthr=121000.0, engbpr=5.1,
                     cd0_clean=0.020, k=0.040),
    'B744': _variant(_A320ISH, n_engines=4, mtow=396890.0, oew=178756.0,
                     wa=511.0, engthr=276000.0, engbpr=5.0,
                     ff_idl=0.23, ff_app=0.72, ff_co=2.11, ff_to=2.60,
                     cd0_clean=0.021, k=0.043,
                     vminer=140.0, vmaxer=190.0,
                     vsmax=2000.0 * FPM, hmax=13747.0,
                     axmax=1.5),
    'B77W': _variant(_A320ISH, mtow=351533.0, oew=167800.0, wa=436.8,
                     engthr=513000.0, engbpr=8.7,
                     ff_idl=0.30, ff_app=0.95, ff_co=2.85, ff_to=3.50,
                     cd0_clean=0.020, k=0.042, vsmax=2200.0 * FPM,
                     hmax=13140.0, axmax=1.5),
    'E190': _variant(_A320ISH, mtow=51800.0, oew=27720.0, wa=92.5,
                     engthr=82300.0, engbpr=5.0,
                     vminer=115.0, vmaxer=170.0, hmax=12497.0),
}
BUILTIN['NA'] = dict(_A320ISH)  # unknown-type fallback, like reference 'A320'
# fix hmax for the A320-family entries (12.5 km)
for _k in ('A320', 'A319', 'A321', 'B738', 'E190', 'NA'):
    BUILTIN[_k]['hmax'] = min(BUILTIN[_k].get('hmax', 12500.0), 12500.0)


def load_openap_dir(path: str) -> Dict[str, dict]:
    """Parse an OpenAP-layout data directory into per-type coefficient dicts.

    Layout (reference coeff.py:17-21): ``fixwing/aircraft.json``,
    ``fixwing/engines.csv``, ``fixwing/dragpolar.csv``, ``fixwing/wrap/*.csv``.
    Returns {} if the directory is missing; merge the result over BUILTIN.
    """
    fixwing = os.path.join(path, 'fixwing')
    acjson = os.path.join(fixwing, 'aircraft.json')
    if not os.path.exists(acjson):
        return {}

    with open(acjson) as f:
        acs = json.load(f)
    acs.pop('__comment', None)

    engines = {}
    with open(os.path.join(fixwing, 'engines.csv')) as f:
        for row in csv.DictReader(f):
            engines[row['name'].upper()] = row

    dragpolar = {}
    with open(os.path.join(fixwing, 'dragpolar.csv')) as f:
        for row in csv.DictReader(f):
            dragpolar[row['mdl'].upper()] = {
                k: float(v) for k, v in row.items() if k != 'mdl'}

    out = {}
    for mdl, ac in acs.items():
        mdl = mdl.upper()
        # First engine listed that matches the engines table (the reference
        # also uses the first engine, perfoap.py:74-76); all matches are
        # kept for the ENG acid,[engine] change command (perfbase
        # engchange contract).
        eng = None
        avail = {}
        for ename in ac.get('engines', []):
            ename = ename.strip().upper()
            matches = [e for n, e in engines.items() if n.startswith(ename)]
            if matches:
                avail[matches[-1]['name'].upper()] = matches[-1]
                if eng is None:
                    eng = matches[-1]
        if eng is None:
            continue

        d = dict(
            n_engines=int(ac['n_engines']), wa=float(ac['wa']),
            mtow=float(ac['mtow']), oew=float(ac['oew']),
            engthr=float(eng['thr']), engbpr=float(eng['bpr']),
            ff_idl=float(eng['ff_idl']), ff_app=float(eng['ff_app']),
            ff_co=float(eng['ff_co']), ff_to=float(eng['ff_to']),
            engines_avail={n: dict(thr=float(e['thr']),
                                   bpr=float(e['bpr']),
                                   ff_idl=float(e['ff_idl']),
                                   ff_app=float(e['ff_app']),
                                   ff_co=float(e['ff_co']),
                                   ff_to=float(e['ff_to']))
                           for n, e in avail.items()},
        )
        dp = dragpolar.get(mdl) or dragpolar.get('NA')
        if dp is None and dragpolar:
            # mean over all types, like reference coeff.py:37-38
            keys = next(iter(dragpolar.values())).keys()
            dp = {k: sum(v[k] for v in dragpolar.values()) / len(dragpolar)
                  for k in keys}
        if dp:
            d.update({k: dp[k] for k in
                      ('cd0_clean', 'cd0_gd', 'cd0_to', 'cd0_ic',
                       'cd0_ap', 'cd0_ld', 'k')})

        wrapfile = os.path.join(fixwing, 'wrap', mdl.lower() + '.csv')
        if os.path.exists(wrapfile):
            wrap = {}
            with open(wrapfile) as f:
                for row in csv.DictReader(f):
                    wrap[row['param']] = row
            try:
                # Envelope extraction mirrors reference coeff.py:95-140.
                d['vminto'] = float(wrap['to_v_lof']['min'])
                d['vmaxto'] = float(wrap['to_v_lof']['max'])
                d['vminic'] = float(wrap['ic_va_avg']['min'])
                d['vmaxic'] = float(wrap['ic_va_avg']['max'])
                d['vminer'] = min(float(wrap['cl_v_cas_const']['min']),
                                  float(wrap['cr_v_cas_mean']['min']),
                                  float(wrap['de_v_cas_const']['min']))
                # NB: the reference takes the MIN of the phase maxima
                # (coeff.py:91-94) — kept for parity.
                d['vmaxer'] = min(float(wrap['cl_v_cas_const']['max']),
                                  float(wrap['cr_v_cas_mean']['max']),
                                  float(wrap['de_v_cas_const']['max']))
                d['vminap'] = float(wrap['fa_va_avg']['min'])
                d['vmaxap'] = float(wrap['fa_va_avg']['max'])
                d['vminld'] = float(wrap['ld_v_app']['min'])
                d['vmaxld'] = float(wrap['ld_v_app']['max'])
                d['vsmax'] = max(float(wrap['ic_vz_avg']['max']),
                                 float(wrap['cl_vz_avg_pre_cas']['max']),
                                 float(wrap['cl_vz_avg_cas_const']['max']),
                                 float(wrap['cl_vz_avg_mach_const']['max']))
                d['vsmin'] = min(float(wrap['ic_vz_avg']['min']),
                                 float(wrap['de_vz_avg_after_cas']['min']),
                                 float(wrap['de_vz_avg_cas_const']['min']),
                                 float(wrap['de_vz_avg_mach_const']['min']))
                d['hmax'] = float(wrap['cr_h_max']['opt']) * 1000.0
                d['axmax'] = float(wrap['to_acc_tof']['max'])
            except KeyError:
                pass
        # Fill any missing keys from the generic default
        for k, v in _A320ISH.items():
            d.setdefault(k, v)
        d.setdefault('axmax', 1.8)
        out[mdl] = d
    return out


class CoeffDB:
    """Merged coefficient database: BUILTIN overridden by model data.

    ``model`` selects the source (reference traffic.py:39-52 switch):
    'openap' loads the OpenAP directory; 'bs'/'legacy' loads the BS
    conceptual-design XML database mapped onto the generic columns
    (models/coeff_bs.py bs_to_generic); 'bada' loads proprietary BADA
    OPF/APF data when present.  Unknown types fall back to 'NA'
    (the reference's default-B744 behavior, perfbs.py:115-121).
    """

    def __init__(self, openap_path: Optional[str] = None,
                 model: str = "openap", perf_path: Optional[str] = None):
        self.table = dict(BUILTIN)
        self.model = model
        self.bada_synonyms, self.bada_coeffs = {}, {}
        if model in ("bs", "legacy") and perf_path:
            from . import coeff_bs
            bsdir = os.path.join(perf_path, "BS")
            self.table.update({t: coeff_bs.bs_to_generic(d)
                               for t, d in
                               coeff_bs.load_bs_dir(bsdir).items()})
        elif model == "bada" and perf_path:
            from . import coeff_bada
            syn, coeffs = coeff_bada.load_bada_dir(
                os.path.join(perf_path, "BADA"))
            self.bada_synonyms, self.bada_coeffs = syn, coeffs
            for code in syn:
                d = coeff_bada.get_coefficients(syn, coeffs, code)
                if d is not None:
                    self.table[code.upper()] = coeff_bada.bada_to_generic(d)
        elif openap_path:
            loaded = load_openap_dir(openap_path)
            if not loaded:
                print(f"perf: no coefficient data at {openap_path} — "
                      "using the BUILTIN approximate set "
                      f"({len(BUILTIN)} types; unknown types map to 'NA')")
            self.table.update(loaded)

    def get(self, actype: str) -> dict:
        return self.table.get(actype.upper(), self.table['NA'])


def slot_values(coeffs: dict) -> dict:
    """PerfArrays column values for one aircraft from a coefficient dict."""
    ffa, ffb, ffc = _ff_quadratic(coeffs['ff_idl'], coeffs['ff_app'],
                                  coeffs['ff_co'], coeffs['ff_to'])
    return dict(
        mass=0.5 * (coeffs['oew'] + coeffs['mtow']),
        sref=coeffs['wa'],
        engthrust=coeffs['engthr'],
        engbpr=coeffs['engbpr'],
        engnum=float(coeffs['n_engines']),
        ff_a=ffa, ff_b=ffb, ff_c=ffc,
        cd0_clean=coeffs['cd0_clean'], cd0_gd=coeffs['cd0_gd'],
        cd0_to=coeffs['cd0_to'], cd0_ic=coeffs['cd0_ic'],
        cd0_ap=coeffs['cd0_ap'], cd0_ld=coeffs['cd0_ld'], k=coeffs['k'],
        vminto=coeffs['vminto'], vminic=coeffs['vminic'],
        vminer=coeffs['vminer'], vminap=coeffs['vminap'],
        vminld=coeffs['vminld'],
        vmaxto=coeffs['vmaxto'], vmaxic=coeffs['vmaxic'],
        vmaxer=coeffs['vmaxer'], vmaxap=coeffs['vmaxap'],
        vmaxld=coeffs['vmaxld'],
        vsmin=coeffs['vsmin'], vsmax=coeffs['vsmax'],
        hmax=coeffs['hmax'], axmax=coeffs['axmax'],
        islifttype_rotor=False,
    )


def _ff_quadratic(ffidl, ffapp, ffco, ffto):
    """Quadratic fuel-flow fit through the 4 ICAO points.

    The reference fits ff = a*tr^2 + b*tr + c through thrust-ratio points
    (0.07, 0.3, 0.85, 1.0) (openap/thrust.py compute_eng_ff_coeff).  A plain
    least-squares fit through the same points, computed host-side once per
    engine type.
    """
    import numpy as np
    x = np.array([0.07, 0.3, 0.85, 1.0])
    y = np.array([ffidl, ffapp, ffco, ffto])
    a, b, c = np.polyfit(x, y, 2)
    return float(a), float(b), float(c)


def empty_perf_arrays(nmax: int, dtype, device):
    """Allocate PerfArrays filled with the generic default coefficients."""
    from ..core.state import PerfArrays
    vals = slot_values(BUILTIN['NA'])

    def full(v):
        return torch.full((nmax,), float(v), dtype=dtype, device=device)

    return PerfArrays(
        mass=full(vals['mass']), sref=full(vals['sref']),
        engthrust=full(vals['engthrust']), engbpr=full(vals['engbpr']),
        ff_a=full(vals['ff_a']), ff_b=full(vals['ff_b']),
        ff_c=full(vals['ff_c']), engnum=full(vals['engnum']),
        cd0_clean=full(vals['cd0_clean']), cd0_gd=full(vals['cd0_gd']),
        cd0_to=full(vals['cd0_to']), cd0_ic=full(vals['cd0_ic']),
        cd0_ap=full(vals['cd0_ap']), cd0_ld=full(vals['cd0_ld']),
        k=full(vals['k']),
        vminto=full(vals['vminto']), vminic=full(vals['vminic']),
        vminer=full(vals['vminer']), vminap=full(vals['vminap']),
        vminld=full(vals['vminld']),
        vmaxto=full(vals['vmaxto']), vmaxic=full(vals['vmaxic']),
        vmaxer=full(vals['vmaxer']), vmaxap=full(vals['vmaxap']),
        vmaxld=full(vals['vmaxld']),
        vsmin=full(vals['vsmin']), vsmax=full(vals['vsmax']),
        hmax=full(vals['hmax']), axmax=full(vals['axmax']),
        islifttype_rotor=torch.zeros(nmax, dtype=torch.bool, device=device),
        phase=torch.zeros(nmax, dtype=torch.int32, device=device),
        vmin=full(0.0), vmax=full(vals['vmaxer']),
        thrust=full(0.0), drag=full(0.0), fuelflow=full(0.0),
    )
