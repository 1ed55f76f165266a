"""Pilot arbitration: AP or ASAS targets, then envelope limits.

Port of ``bluesky_tpu/core/pilot.py``.
"""
import torch

from ..ops import geo, ties
from . import perf as perfmod
from .state import SimState


def ap_or_asas(state: SimState, windn=None, winde=None) -> SimState:
    """Arbitrate desired states from ASAS (in conflict) or AP."""
    ac, ap, asas = state.ac, state.ap, state.asas
    if windn is not None:
        asastasnorth = asas.tas * torch.cos(geo.radians(asas.trk)) - windn
        asastaseast = asas.tas * torch.sin(geo.radians(asas.trk)) - winde
        asastas = torch.sqrt(asastasnorth ** 2 + asastaseast ** 2)
    else:
        asastas = asas.tas
    active = asas.active
    trk = torch.where(active, asas.trk, ap.trk)
    tas = torch.where(active, asastas, ap.tas)
    alt = torch.where(active, asas.alt, ap.alt)
    vs = torch.abs(torch.where(active, asas.vs, ap.vs))
    if windn is not None:
        vw = torch.sqrt(windn * windn + winde * winde)
        winddir = torch.atan2(winde, windn)
        drift = geo.radians(trk) - winddir
        steer = torch.asin(ties.clip(
            vw * torch.sin(drift) / ties.maximum(ac.tas, 0.001), -1.0, 1.0))
        hdg = (trk + geo.degrees(steer)) % 360.0
    else:
        hdg = trk % 360.0
    pilot = state.pilot.replace(trk=trk, tas=tas, alt=alt, vs=vs, hdg=hdg)
    return state.replace(pilot=pilot)


def apply_limits(state: SimState, smooth=None) -> SimState:
    """Clip pilot intents to the performance envelope (``smooth``: the
    straight-through clamp of ``perf.limits``)."""
    pilot = state.pilot
    tas, vs, alt = perfmod.limits(state.perf, pilot.tas, pilot.vs, pilot.alt,
                                  state.ac.ax, smooth=smooth)
    return state.replace(pilot=pilot.replace(tas=tas, vs=vs, alt=alt))
