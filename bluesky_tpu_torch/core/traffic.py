"""Host-side Traffic facade: create, delete and lookup over the device
state.

Port of ``bluesky_tpu/core/traffic.py``: the tensor ``SimState`` plus
host-only bookkeeping (callsigns, types, the id -> slot map, trails and
the create/delete/permute hooks).  Creations are queued and ``flush``
writes them into their slots in one batch per field; ``delete`` is a
mask flip that also purges the slot from every pair and partner table.
Both write in place: the state's tensors belong to this object.  Slots
are stable (the reference compacts arrays, traffic.py:365-381), which
keeps the [N, N] pair matrix valid.
"""
import os
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device, settings
from ..models import perf_coeffs
from ..ops import aero
from ..ops import geo
from .state import SimState, make_state
from .trails import Trails


class Traffic:
    """Host facade over a padded SimState on ``device`` (CUDA unless the
    caller asks for another device)."""

    def __init__(self, nmax: int = 64, wmax: int = 32, dtype=torch.float32,
                 openap_path: Optional[str] = None, rng_seed: int = 0,
                 area=(-1.0, 1.0, -1.0, 1.0), pair_matrix: bool = True,
                 k_partners: int = 8, device=None):
        self.device = resolve_device(device)
        self.nmax = nmax
        self.wmax = wmax
        self.dtype = dtype
        self.pair_matrix = pair_matrix
        self.k_partners = k_partners
        self.state: SimState = make_state(nmax, wmax, dtype, rng_seed,
                                          pair_matrix, k_partners,
                                          device=self.device)
        model = settings.performance_model
        if openap_path is None and model == "openap":
            cand = os.path.join(settings.perf_path, "OpenAP")
            if os.path.isdir(os.path.join(cand, "fixwing")):
                openap_path = cand
        self.coeffdb = perf_coeffs.CoeffDB(openap_path, model=model,
                                           perf_path=settings.perf_path)
        self.area = area  # default creation area (lat0, lat1, lon0, lon1)
        self._rng = np.random.default_rng(rng_seed)
        self.ids: List[Optional[str]] = [None] * nmax
        self.types: List[Optional[str]] = [None] * nmax
        self._id2slot = {}
        self._pending = []
        self._autoid = 0
        # Observers of an old -> new slot map (``apply_slot_permutation``;
        # defined before the trails, which subscribe at construction)
        self.permute_hooks = []
        self.trails = Trails(self)
        # Observers of deleted slot indices and of created slot arrays
        self.delete_hooks = []
        self.create_hooks = []

    def apply_slot_permutation(self, newslot):
        """Re-bucket the host bookkeeping after the device state moved
        aircraft between slots (``newslot[old] = new``): remap ids and
        types and fan out to ``permute_hooks``."""
        newslot = np.asarray(newslot)
        src = np.empty(self.nmax, dtype=np.intp)      # new -> old slot
        src[newslot] = np.arange(self.nmax, dtype=np.intp)
        self.ids = np.asarray(self.ids, dtype=object)[src].tolist()
        self.types = np.asarray(self.types, dtype=object)[src].tolist()
        self._id2slot = {i: int(newslot[s])
                         for i, s in self._id2slot.items()}
        for hook in self.permute_hooks:
            hook(newslot)

    @property
    def ntraf(self) -> int:
        return len(self._id2slot) + len(self._pending)

    def id2idx(self, acid):
        """Slot index of a callsign; -1 if unknown (traffic.py:485-501).
        ``#`` or ``*`` is the last created aircraft (-2 while creations
        are queued)."""
        if not isinstance(acid, str):
            return [self.id2idx(a) for a in acid]
        if acid in ('#', '*'):
            if self._pending:
                return -2
            slots = [s for s, i in enumerate(self.ids) if i is not None]
            return slots[-1] if slots else -1
        return self._id2slot.get(acid.upper(), -1)

    def create(self, n=1, actype="B744", acalt=None, acspd=None, dest=None,
               aclat=None, aclon=None, achdg=None, acid=None):
        """Queue creation of n aircraft (reference traffic.py:192-252)."""
        if acid is None:
            pre = chr(self._rng.integers(65, 91)) + chr(self._rng.integers(65, 91))
            acid = [f"{pre}{self._autoid + i:>05}" for i in range(n)]
            self._autoid += n
        elif isinstance(acid, str):
            if acid.upper() in self._id2slot:
                return False, acid + " already exists."
            acid = [acid.upper()]
        if isinstance(actype, str):
            actype = n * [actype]

        lat0, lat1, lon0, lon1 = self.area
        if aclat is None:
            aclat = self._rng.random(n) * (lat1 - lat0) + lat0
        if aclon is None:
            aclon = self._rng.random(n) * (lon1 - lon0) + lon0
        aclat = np.atleast_1d(np.asarray(aclat, dtype=np.float64))
        aclon = np.atleast_1d(np.asarray(aclon, dtype=np.float64))
        aclon = np.where(aclon > 180.0, aclon - 360.0, aclon)
        aclon = np.where(aclon < -180.0, aclon + 360.0, aclon)
        if achdg is None:
            achdg = self._rng.integers(1, 360, n).astype(np.float64)
        if acalt is None:
            acalt = self._rng.integers(2000, 39000, n) * aero.ft
        if acspd is None:
            acspd = self._rng.integers(250, 450, n) * aero.kts
        bc = lambda v: np.broadcast_to(
            np.atleast_1d(np.asarray(v, np.float64)), (n,))
        self._pending.append(dict(
            acid=[a.upper() for a in acid], actype=[t.upper() for t in actype],
            lat=aclat, lon=aclon, hdg=bc(achdg), alt=bc(acalt),
            spd=bc(acspd)))
        return True, None

    def _free_slots(self, n):
        free = [i for i, v in enumerate(self.ids) if v is None]
        if len(free) < n:
            raise RuntimeError(
                f"traffic full: need {n} slots, {len(free)} free "
                f"(nmax={self.nmax}); raise nmax")
        return np.asarray(free[:n])

    def flush(self):
        """Apply all queued creations in one batched write per field."""
        if not self._pending:
            return
        batch = self._pending
        self._pending = []
        ids = sum((b['acid'] for b in batch), [])
        types = sum((b['actype'] for b in batch), [])
        cat = lambda k: np.concatenate([b[k] for b in batch])
        lat, lon, hdg, alt, spd = (cat(k) for k in
                                   ("lat", "lon", "hdg", "alt", "spd"))
        n = len(ids)
        slots = self._free_slots(n)
        for s, i, t in zip(slots.tolist(), ids, types):
            self.ids[s] = i
            self.types[s] = t
            self._id2slot[i] = s

        st = self.state
        tas, cas, mach = _np_vcasormach(spd, alt)
        hdgrad = np.radians(hdg)
        gsnorth = tas * np.cos(hdgrad)
        gseast = tas * np.sin(hdgrad)
        p, rho, temp = _np_vatmos(alt)
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)

        def put(arr, val):
            arr[idx] = torch.as_tensor(np.asarray(val), dtype=arr.dtype,
                                       device=arr.device)

        full = lambda v: np.full(n, v)
        ac = st.ac
        for name, val in dict(
                active=True, lat=lat, lon=lon, alt=alt, hdg=hdg, trk=hdg,
                tas=tas, gs=tas, gsnorth=gsnorth, gseast=gseast, cas=cas,
                mach=mach, vs=np.zeros(n), p=p, rho=rho, temp=temp,
                selspd=cas, selalt=alt, selvs=np.zeros(n), swlnav=False,
                swvnav=False, abco=False, belco=True,
                apvsdef=full(1500.0 * aero.fpm), aphi=full(np.radians(25.0)),
                ax=full(aero.kts), bank=full(np.radians(25.0)),
                coslat=np.cos(np.radians(lat))).items():
            put(getattr(ac, name), val)
        for name, val in dict(trk=hdg, tas=tas, alt=alt, vs=np.zeros(n),
                              dist2vs=full(-999.0)).items():
            put(getattr(st.ap, name), val)
        for name, val in dict(
                lat=full(89.99), lon=np.zeros(n), spd=full(-999.0),
                turndist=np.ones(n), flyby=np.ones(n), next_qdr=full(-999.0),
                nextaltco=np.zeros(n), xtoalt=np.zeros(n)).items():
            put(getattr(st.actwp, name), val)
        for name, val in dict(trk=hdg, tas=tas, alt=alt, vs=np.zeros(n),
                              active=False).items():
            put(getattr(st.asas, name), val)
        for name, val in dict(lat=lat, lon=lon, alt=alt, trk=hdg, tas=tas,
                              gs=tas, lastupdate=np.zeros(n)).items():
            put(getattr(st.adsb, name), val)

        # Performance coefficients per type (perfoap.py:49-113): each
        # column is its types' values indexed by every aircraft's type, the
        # array a list of the per-aircraft values would give (that list
        # took ~30 appends an aircraft, most of a million-aircraft flush)
        uniq = {t: k for k, t in enumerate(dict.fromkeys(types))}
        vals = [perf_coeffs.slot_values(self.coeffdb.get(t)) for t in uniq]
        which = np.fromiter((uniq[t] for t in types), dtype=np.intp, count=n)
        for name in vals[0]:
            put(getattr(st.perf, name),
                np.asarray([v[name] for v in vals])[which])

        put(st.route.nwp, 0)
        put(st.route.iactwp, -1)
        self.trails.create(slots, lat, lon, t=float(st.simt))
        for hook in self.create_hooks:
            hook(slots)

    def delete(self, idx):
        """Deactivate slot(s) (cf. traffic.py:365-381), purging them from
        ``resopairs``, from the caller-space ``partners`` (their rows and
        every reference to them) and from the sorted-space ``partners_s``
        at ``sort_perm[idx]``, so a freed slot reused by ``create`` before
        the next ASAS interval carries no stale pair."""
        self.flush()
        idx = [int(i) for i in np.atleast_1d(np.asarray(idx))]
        for i in idx:
            if self.ids[i] is not None:
                del self._id2slot[self.ids[i]]
                self.ids[i] = None
                self.types[i] = None
        st = self.state
        t = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        st.ac.active[t] = False
        st.asas.active[t] = False
        rp = st.asas.resopairs
        if rp.numel():
            rp[t, :] = False
            rp[:, t] = False
        partners = st.asas.partners
        partners[t, :] = -1
        partners.masked_fill_(torch.isin(partners, t.to(torch.int32)), -1)
        sidx = st.asas.sort_perm[t].long()
        partners_s = st.asas.partners_s
        partners_s[sidx, :] = -1
        partners_s.masked_fill_(
            torch.isin(partners_s, sidx.to(torch.int32)), -1)
        for hook in self.delete_hooks:
            hook(idx)
        return True

    def reset(self):
        """Empty the traffic: a fresh state with a new seed from the
        facade's generator, cleared bookkeeping and trails."""
        seed = int(self._rng.integers(0, 2**31 - 1))
        self.state = make_state(self.nmax, self.wmax, self.dtype, seed,
                                self.pair_matrix, self.k_partners,
                                device=self.device)
        self.ids = [None] * self.nmax
        self.types = [None] * self.nmax
        self._id2slot = {}
        self._pending = []
        self._autoid = 0
        self.trails.reset()

    def creconfs(self, acid, actype, targetidx, dpsi, cpa, tlosh,
                 dh=None, tlosv=None, spd=None, pzr_nm=5.0, pzh_ft=1000.0):
        """Create an aircraft on a synthetic conflict course with the
        target slot (reference traffic.py:314-363): heading change
        ``dpsi`` [deg], closest approach ``cpa`` [nm] after ``tlosh`` [s],
        optionally ``dh`` [m] above it with a vertical LoS after
        ``tlosv``, at ground speed ``spd`` [m/s]."""
        self.flush()
        ac = self.state.ac
        getf = lambda a: float(a[targetidx])
        latref, lonref = getf(ac.lat), getf(ac.lon)
        altref = getf(ac.alt)
        trkref = np.radians(getf(ac.trk))
        gsref = getf(ac.gs)
        vsref = getf(ac.vs)
        cpa_m = cpa * aero.nm
        pzr = pzr_nm * aero.nm
        pzh = pzh_ft * aero.ft

        trk = trkref + np.radians(dpsi)
        gs = gsref if spd is None else spd
        if dh is None:
            acalt = altref
            acvs = 0.0
        else:
            acalt = altref + dh
            tlosv = tlosh if tlosv is None else tlosv
            acvs = vsref - np.sign(dh) * (abs(dh) - pzh) / tlosv

        gsn, gse = gs * np.cos(trk), gs * np.sin(trk)
        vreln = gsref * np.cos(trkref) - gsn
        vrele = gsref * np.sin(trkref) - gse
        vrel = np.sqrt(vreln * vreln + vrele * vrele)
        drelcpa = tlosh * vrel + (0 if cpa_m > pzr
                                  else np.sqrt(pzr * pzr - cpa_m * cpa_m))
        dist = np.sqrt(drelcpa * drelcpa + cpa_m * cpa_m)
        rd = drelcpa / dist
        rx = cpa_m / dist
        brn = np.degrees(np.arctan2(-rx * vreln + rd * vrele,
                                    rd * vreln + rx * vrele))
        # the projection in the state's dtype, on the host
        h = lambda v: torch.tensor(v, dtype=self.dtype)
        aclat, aclon = (float(x) for x in geo.qdrpos(
            h(latref), h(lonref), h(brn), h(dist / aero.nm)))
        acspd = float(_np_vtas2cas(np.hypot(gsn, gse), acalt))
        achdg = float(np.degrees(np.arctan2(gse, gsn)))
        self.create(1, actype, acalt, acspd, None, aclat, aclon, achdg, acid)
        self.flush()
        s = self._id2slot[acid.upper()]
        ac = self.state.ac
        ac.vs[s] = acvs
        ac.selalt[s] = altref
        ac.selvs[s] = acvs


# --- Host-side NumPy twins of the aero conversions used at creation time
# (float64, the same formulas as ops/aero.py)

def _np_vatmos(h):
    T = np.maximum(288.15 - 0.0065 * h, 216.65)
    rhotrop = 1.225 * (T / 288.15) ** 4.256848030018761
    dhstrat = np.maximum(0.0, h - 11000.0)
    rho = rhotrop * np.exp(-dhstrat / 6341.552161)
    return rho * 287.05287 * T, rho, T


def _np_vtas2cas(tas, h):
    p, rho, _ = _np_vatmos(h)
    qdyn = p * ((1.0 + rho * tas * tas / (7.0 * p)) ** 3.5 - 1.0)
    cas = np.sqrt(7.0 * aero.p0 / aero.rho0
                  * ((qdyn / aero.p0 + 1.0) ** (2.0 / 7.0) - 1.0))
    return np.where(tas < 0, -cas, cas)


def _np_vcas2tas(cas, h):
    p, rho, _ = _np_vatmos(h)
    qdyn = aero.p0 * ((1.0 + aero.rho0 * cas * cas / (7.0 * aero.p0)) ** 3.5
                      - 1.0)
    tas = np.sqrt(7.0 * p / rho * ((1.0 + qdyn / p) ** (2.0 / 7.0) - 1.0))
    return np.where(cas < 0, -tas, tas)


def _np_vcasormach(spd, h):
    a = np.sqrt(1.4 * 287.05287 * np.maximum(288.15 - 0.0065 * h, 216.65))
    ismach = (0.1 < spd) & (spd < 1.0)
    tas = np.where(ismach, spd * a, _np_vcas2tas(spd, h))
    cas = np.where(ismach, _np_vtas2cas(tas, h), spd)
    mach = np.where(ismach, spd, tas / a)
    return tas, cas, mach
