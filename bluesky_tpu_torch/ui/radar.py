"""SVG radar renderer: the headless stand-in for the Qt RadarWidget.

Draws the same picture ``ui/qtgl/radarwidget.py`` draws from the ACDATA
stream — aircraft chevrons rotated to track with callsign/FL labels,
trail segments, named area shapes (BOX/CIRCLE/POLY/LINE), and the
selected route polyline — as a standalone SVG string/file.

Pure host-side: input is plain dicts/arrays (an ACDATA frame, the
objdata shape registry, a ROUTEDATA frame), so both the sim process
(SCREENSHOT command) and a connected GuiClient (its nodeData mirror)
render through this one code path.

Port of ``bluesky_tpu/ui/radar.py``.  The pictures drawn from host data
are copies.  The ones drawn from a live Simulation (``render_sim``,
``compute_ssd_discs``, ``render_nd``) read the state columns each needs
in one device-to-host copy (``_columns``), which waits for the newest
dispatched chunk: they draw the state JAX draws at the same point of the
loop, ``sim.traf.state``, titled with ``sim.simt``.
"""
from xml.sax.saxutils import quoteattr, escape as _esc

import numpy as np


def _columns(sim, *names):
    """``{name: host array}`` of the named per-aircraft columns of the
    live state (``state.ac`` first, then ``state.asas``), in one
    device-to-host copy (``plugins.host_arrays``)."""
    from ..plugins import host_arrays
    st = sim.traf.state
    cols = [getattr(st.ac, n) if hasattr(st.ac, n) else getattr(st.asas, n)
            for n in names]
    return dict(zip(names, host_arrays(*cols)))

W, H = 1000, 800
BG = "#10141c"
COLORS = {
    "ac": "#37c837", "ac_conf": "#e8463c", "label": "#9fd49f",
    "trail": "#2b8cbe", "shape": "#b08d2f", "route": "#b05fd0",
    "grid": "#223",
}


def _extent(acdata, shapes):
    lats, lons = [], []
    if acdata and len(acdata.get("lat", [])):
        lats += list(np.atleast_1d(acdata["lat"]))
        lons += list(np.atleast_1d(acdata["lon"]))
    for _name, (kind, coords) in (shapes or {}).items():
        if coords is None:
            continue
        c = list(coords)
        if kind.upper() == "CIRCLE":
            clat, clon, r_nm = c[:3]
            dlat = r_nm / 60.0
            lats += [clat - dlat, clat + dlat]
            lons += [clon - 2 * dlat, clon + 2 * dlat]
        else:
            lats += c[0::2]
            lons += c[1::2]
    if not lats:
        return (-1.0, 1.0, -1.0, 1.0)
    lat0, lat1 = min(lats), max(lats)
    lon0, lon1 = min(lons), max(lons)
    padlat = max(0.05, 0.08 * (lat1 - lat0))
    padlon = max(0.05, 0.08 * (lon1 - lon0))
    return (lat0 - padlat, lat1 + padlat, lon0 - padlon, lon1 + padlon)


class _Proj:
    def __init__(self, extent):
        self.lat0, self.lat1, self.lon0, self.lon1 = extent

    def xy(self, lat, lon):
        x = (lon - self.lon0) / max(1e-9, self.lon1 - self.lon0) * W
        y = H - (lat - self.lat0) / max(1e-9, self.lat1 - self.lat0) * H
        return x, y


# ------------------------------------------------------------------
# SSD velocity-space discs (the reference RadarWidget's SSD view:
# radarwidget.py:290-302, 593-598 — a per-aircraft disc whose pixels
# are colored by a conflict test against every intruder, selected with
# the SSD stack command).  Here each selected aircraft gets an annular
# polar grid of candidate velocities (the vmin..vmax envelope ring of
# SSD.py:131-141), each cell colored red when flying that velocity
# would intrude within rpz_m inside the lookahead — the same VO
# predicate ops/cr_ssd.py resolves on, sampled host-side in NumPy so
# the overlay works on every CD backend and any fleet size (cost is
# O(intruders-in-ADS-B-range) per selected disc).
# ------------------------------------------------------------------

SSD_R_PX = 46          # disc outer radius on screen [px]
SSD_MAX_DISCS = 16     # drawing cap (ALL/CONFLICTS at large N)
_ADSB_MAX_M = 65.0 * 1852.0     # reference SSD.py:110 adsbmax


def ssd_disc(i, lat, lon, gseast, gsnorth, active, vmin, vmax, rpz_m,
             tlookahead, ntrk=36, nspd=5):
    """Sample ownship ``i``'s solution space: conf [ntrk, nspd] bool.

    Cell (t, s) covers track sector t of the annulus ring s between
    vmin and vmax; True = that candidate velocity conflicts with at
    least one intruder within ADS-B range (the cr_ssd._vo_masks CPA
    predicate, NumPy edition)."""
    from ..ops import hostgeo
    lat = np.asarray(lat, float)
    lon = np.asarray(lon, float)
    mask = np.asarray(active, bool).copy()
    mask[i] = False
    idx = np.flatnonzero(mask)
    trk_c = (np.arange(ntrk) + 0.5) * (360.0 / ntrk)
    spd_c = vmin + (np.arange(nspd) + 0.5) * ((vmax - vmin) / nspd)
    cve = (spd_c[None, :] * np.sin(np.radians(trk_c))[:, None]).ravel()
    cvn = (spd_c[None, :] * np.cos(np.radians(trk_c))[:, None]).ravel()
    if len(idx) == 0:
        return np.zeros((ntrk, nspd), bool)
    qdr, dist_nm = hostgeo.qdrdist(
        np.full(len(idx), lat[i]), np.full(len(idx), lon[i]),
        lat[idx], lon[idx])
    dist = np.asarray(dist_nm, float) * 1852.0
    near = dist < _ADSB_MAX_M
    if not near.any():
        return np.zeros((ntrk, nspd), bool)
    qdr = np.asarray(qdr, float)[near]
    dist = dist[near]
    dx = dist * np.sin(np.radians(qdr))        # ownship -> intruder east
    dy = dist * np.cos(np.radians(qdr))
    ge = np.asarray(gseast, float)[idx][near]
    gn = np.asarray(gsnorth, float)[idx][near]
    # w = v_j - u_candidate (StateBasedCD.py:39-40 convention)
    wve = ge[None, :] - cve[:, None]           # [C, M]
    wvn = gn[None, :] - cvn[:, None]
    dv2 = np.maximum(wve * wve + wvn * wvn, 1e-6)
    tcpa = -(wve * dx[None, :] + wvn * dy[None, :]) / dv2
    dcpa2 = (dx * dx + dy * dy)[None, :] - tcpa * tcpa * dv2
    r2 = rpz_m * rpz_m
    dtin = np.sqrt(np.maximum(0.0, r2 - dcpa2) / dv2)
    conf = (dcpa2 < r2) & (tcpa + dtin > 0.0) \
        & (tcpa - dtin < tlookahead)
    return np.any(conf, axis=1).reshape(ntrk, nspd)


def _ssd_disc_svg(x, y, conf, ve, vn, vmax, acid="", vmin=None):
    """One SSD disc as an SVG group at screen position (x, y)."""
    ntrk, nspd = conf.shape
    r0 = SSD_R_PX * 0.35               # vmin ring radius (fixed fraction)
    if vmin is None:
        vmin = 0.35 * vmax

    def vrad(v):
        """Speed -> radius with the SAME mapping as the annulus cells
        (vmin..vmax onto r0..R), linear from 0 below vmin — so the
        own-velocity vector tip lands in its true speed ring."""
        if v <= vmin:
            return r0 * v / max(vmin, 1.0)
        return r0 + (SSD_R_PX - r0) * min(
            (v - vmin) / max(vmax - vmin, 1.0), 1.15)

    v = float(np.hypot(ve, vn))
    scale = vrad(v) / max(v, 1.0)
    parts = [f'<g class="ssd" data-acid={quoteattr(str(acid))} '
             f'transform="translate({x:.1f},{y:.1f})" opacity="0.75">']

    def pt(ang_deg, r):
        a = np.radians(ang_deg)
        return f"{r * np.sin(a):.1f},{-r * np.cos(a):.1f}"

    step = 360.0 / ntrk
    for t in range(ntrk):
        a0, a1 = t * step, (t + 1) * step
        for s in range(nspd):
            ra = r0 + (SSD_R_PX - r0) * s / nspd
            rb = r0 + (SSD_R_PX - r0) * (s + 1) / nspd
            color = "#b03028" if conf[t, s] else "#1f7a2f"
            parts.append(
                f'<path d="M{pt(a0, ra)} L{pt(a0, rb)} '
                f'A{rb:.1f},{rb:.1f} 0 0 1 {pt(a1, rb)} '
                f'L{pt(a1, ra)} A{ra:.1f},{ra:.1f} 0 0 0 {pt(a0, ra)} Z" '
                f'fill="{color}" stroke="none"/>')
    # envelope rings + own velocity vector (radarwidget draws the
    # ownship speed vector over the disc)
    parts.append(f'<circle r="{SSD_R_PX:.1f}" fill="none" '
                 f'stroke="#889" stroke-width="0.8"/>')
    parts.append(f'<circle r="{r0:.1f}" fill="none" stroke="#889" '
                 f'stroke-width="0.8"/>')
    parts.append(f'<line x1="0" y1="0" x2="{ve * scale:.1f}" '
                 f'y2="{-vn * scale:.1f}" stroke="#fff" '
                 f'stroke-width="1.6"/>')
    parts.append("</g>")
    return "".join(parts)


def render_svg(acdata=None, shapes=None, routedata=None, title="",
               extent=None, ssd=None):
    """SVG text for one radar frame.

    acdata: dict with id/lat/lon/trk/alt (+ optional inconf,
    traillat0..) — the ACDATA schema; shapes: {name: (kind, coords)}
    — the objdata registry; routedata: the ROUTEDATA schema.
    ``extent`` (lat0, lat1, lon0, lon1) fixes the view window (the
    PAN/ZOOM state); default auto-fits the scene.  The extent rides on
    the root element (``data-extent``) so an interactive frontend can
    map clicks back to lat/lon, and each aircraft group carries its
    callsign (``data-acid``) for click-to-command.
    """
    ext = extent if extent is not None else _extent(acdata, shapes)
    proj = _Proj(ext)
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
        f'height="{H}" viewBox="0 0 {W} {H}" '
        f'data-extent="{ext[0]:.6f},{ext[1]:.6f},'
        f'{ext[2]:.6f},{ext[3]:.6f}">',
        f'<rect width="{W}" height="{H}" fill="{BG}"/>',
    ]
    # Graticule each whole degree
    for latg in range(int(np.floor(proj.lat0)), int(np.ceil(proj.lat1)) + 1):
        _, y = proj.xy(latg, proj.lon0)
        parts.append(f'<line x1="0" y1="{y:.1f}" x2="{W}" y2="{y:.1f}" '
                     f'stroke="{COLORS["grid"]}" stroke-width="1"/>')
    for long in range(int(np.floor(proj.lon0)), int(np.ceil(proj.lon1)) + 1):
        x, _ = proj.xy(proj.lat0, long)
        parts.append(f'<line x1="{x:.1f}" y1="0" x2="{x:.1f}" y2="{H}" '
                     f'stroke="{COLORS["grid"]}" stroke-width="1"/>')

    # Area shapes
    for name, (kind, coords) in (shapes or {}).items():
        if coords is None:
            continue
        k = kind.upper()
        c = list(coords)
        if k == "CIRCLE":
            x, y = proj.xy(c[0], c[1])
            _, y2 = proj.xy(c[0] + c[2] / 60.0, c[1])
            parts.append(
                f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{abs(y - y2):.1f}" '
                f'fill="none" stroke="{COLORS["shape"]}"/>')
        else:
            pts = " ".join(f"{proj.xy(la, lo)[0]:.1f},"
                           f"{proj.xy(la, lo)[1]:.1f}"
                           for la, lo in zip(c[0::2], c[1::2]))
            closed = "polygon" if k in ("POLY", "BOX") else "polyline"
            parts.append(f'<{closed} points="{pts}" fill="none" '
                         f'stroke="{COLORS["shape"]}"/>')
        la0, lo0 = c[0], c[1]
        x, y = proj.xy(la0, lo0)
        parts.append(f'<text x="{x + 4:.1f}" y="{y - 4:.1f}" '
                     f'fill="{COLORS["shape"]}" font-size="10">'
                     f'{_esc(str(name))}</text>')

    # Selected route
    if routedata and routedata.get("wplat"):
        pts = " ".join(
            f"{proj.xy(la, lo)[0]:.1f},{proj.xy(la, lo)[1]:.1f}"
            for la, lo in zip(routedata["wplat"], routedata["wplon"]))
        parts.append(f'<polyline points="{pts}" fill="none" '
                     f'stroke="{COLORS["route"]}" stroke-dasharray="6 4"/>')
        for la, lo, nm_ in zip(routedata["wplat"], routedata["wplon"],
                               routedata.get("wpname", [])):
            x, y = proj.xy(la, lo)
            parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="3" '
                         f'fill="{COLORS["route"]}"/>')
            parts.append(f'<text x="{x + 4:.1f}" y="{y + 10:.1f}" '
                         f'fill="{COLORS["route"]}" font-size="9">'
                         f'{_esc(str(nm_))}</text>')

    # SSD velocity-space discs (under the chevrons)
    for d in (ssd or []):
        x, y = proj.xy(d["lat"], d["lon"])
        parts.append(_ssd_disc_svg(x, y, d["conf"], d["ve"], d["vn"],
                                   d["vmax"], d.get("acid", ""),
                                   vmin=d.get("vmin")))

    if acdata:
        # Trails
        t0 = np.atleast_1d(acdata.get("traillat0", []))
        if len(t0):
            for la0, lo0, la1, lo1 in zip(
                    t0, np.atleast_1d(acdata["traillon0"]),
                    np.atleast_1d(acdata["traillat1"]),
                    np.atleast_1d(acdata["traillon1"])):
                x0, y0 = proj.xy(la0, lo0)
                x1, y1 = proj.xy(la1, lo1)
                parts.append(
                    f'<line x1="{x0:.1f}" y1="{y0:.1f}" x2="{x1:.1f}" '
                    f'y2="{y1:.1f}" stroke="{COLORS["trail"]}"/>')
        # Aircraft chevrons + labels
        ids = acdata.get("id", [])
        lat = np.atleast_1d(acdata.get("lat", []))
        lon = np.atleast_1d(acdata.get("lon", []))
        trk = np.atleast_1d(acdata.get("trk", np.zeros(len(lat))))
        alt = np.atleast_1d(acdata.get("alt", np.zeros(len(lat))))
        inconf = np.atleast_1d(acdata.get("inconf",
                                          np.zeros(len(lat), bool)))
        # CPA lines: in-conflict aircraft projected along track to the
        # closest-point-of-approach time (reference radarwidget.py:754
        # — lat1, lon1 = qdrpos(lat, lon, trk, tcpa*gs/nm))
        tcpa = np.atleast_1d(acdata.get("tcpamax", []))
        gs = np.atleast_1d(acdata.get("gs", []))
        if len(tcpa) == len(lat) and len(gs) == len(lat):
            from ..ops import hostgeo
            for i in np.flatnonzero(np.asarray(inconf[:len(lat)],
                                               bool)):
                d_nm = max(0.0, float(tcpa[i]) * float(gs[i]) / 1852.0)
                la1, lo1 = hostgeo.qdrpos(float(lat[i]), float(lon[i]),
                                          float(trk[i]), d_nm)
                x0, y0 = proj.xy(lat[i], lon[i])
                x1, y1 = proj.xy(la1, lo1)
                parts.append(
                    f'<line x1="{x0:.1f}" y1="{y0:.1f}" x2="{x1:.1f}" '
                    f'y2="{y1:.1f}" stroke="{COLORS["ac_conf"]}" '
                    f'stroke-width="1" stroke-dasharray="3 3"/>')
        for i in range(len(lat)):
            x, y = proj.xy(lat[i], lon[i])
            color = COLORS["ac_conf"] if (len(inconf) > i
                                          and inconf[i]) \
                else COLORS["ac"]
            label = str(ids[i]) if i < len(ids) else ""
            parts.append(
                f'<g transform="translate({x:.1f},{y:.1f}) '
                f'rotate({float(trk[i]):.0f})" '
                f'data-acid={quoteattr(label)}>'
                f'<path d="M0,-6 L4,6 L0,3 L-4,6 Z" fill="{color}"/>'
                f'<circle r="8" fill="transparent"/></g>')
            fl = int(round(float(alt[i]) / 0.3048 / 100.0))
            parts.append(f'<text x="{x + 6:.1f}" y="{y:.1f}" '
                         f'fill="{COLORS["label"]}" font-size="10">'
                         f'{_esc(label)} FL{fl:03d}</text>')

    if title:
        parts.append(f'<text x="10" y="20" fill="#ccc" font-size="13">'
                     f'{_esc(str(title))}</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def render_sim(sim, fname=None):
    """Render the current state of an embedded Simulation (the
    SCREENSHOT command path): builds an ACDATA-shaped frame from the
    state arrays + the screen's shape registry + the selected route."""
    traf = sim.traf
    names = ["active", "lat", "lon", "trk", "alt", "gs", "inconf",
             "tcpamax"]
    if _ssd_selected(sim.scr):          # the discs' columns, same copy
        names += ["gseast", "gsnorth"]
    cols = _columns(sim, *names)
    idx = np.flatnonzero(cols["active"])
    acdata = {
        "id": [traf.ids[i] for i in idx],
        "lat": cols["lat"][idx],
        "lon": cols["lon"][idx],
        "trk": cols["trk"][idx],
        "alt": cols["alt"][idx],
        "gs": cols["gs"][idx],
        "inconf": cols["inconf"][idx],
        "tcpamax": cols["tcpamax"][idx],
        "traillat0": traf.trails.lat0, "traillon0": traf.trails.lon0,
        "traillat1": traf.trails.lat1, "traillon1": traf.trails.lon1,
    }
    routedata = None
    acid = getattr(sim.scr, "route_acid", "")
    if acid:
        i = traf.id2idx(acid)
        if isinstance(i, int) and i >= 0:
            r = sim.routes.route(i)
            routedata = {"wplat": list(r.lat), "wplon": list(r.lon),
                         "wpname": list(r.name)}
    # Honor the PAN/ZOOM display state once the user has set it (the
    # reference RadarWidget's pan/zoom); before any PAN/ZOOM command
    # the view auto-fits the scene.
    extent = None
    if getattr(sim.scr, "user_view", False):
        lat0, lat1, lon0, lon1 = sim.scr.getviewbounds()
        # widen lon by the aspect ratio so degrees stay ~square
        c = (lon0 + lon1) / 2.0
        half = (lon1 - lon0) / 2.0 * (W / H)
        extent = (lat0, lat1, c - half, c + half)
    else:
        # Sync the auto-fitted view into the display state, so the
        # FIRST user ZOOM/PAN continues smoothly from what is on
        # screen instead of jumping to the (0,0) default center.
        a = _extent(acdata, sim.scr.objdata)
        sim.scr.ctrlat = (a[0] + a[1]) / 2.0
        sim.scr.ctrlon = (a[2] + a[3]) / 2.0
        sim.scr.scrzoom = 1.0 / max((a[1] - a[0]) / 2.0, 1e-6)
    svg = render_svg(acdata, sim.scr.objdata, routedata,
                     title=f"simt {sim.simt:.1f} s — "
                           f"{len(idx)} aircraft",
                     extent=extent, ssd=compute_ssd_discs(sim, cols))
    if fname:
        with open(fname, "w") as f:
            f.write(svg)
    return svg


def compute_ssd_discs_acdata(acdata, ssd_all, ssd_conflicts, ssd_ownship,
                             vmin=None, vmax=None, rpz_m=None,
                             tlookahead=None):
    """SSD disc data from an ACDATA-shaped mirror (the GuiClient path:
    the reference's GL client computes its discs from the same streamed
    arrays, radarwidget.py:728-765).  ASAS parameters come from the
    stream itself (ACDATA carries vmin/vmax/asasrpz/asasdtlook, so a
    server-side ZONER/DTLOOK change is mirrored — unlike the reference
    client's hard-coded display constants); explicit arguments override,
    and AsasConfig defaults back an old producer without the fields."""
    if not (ssd_all or ssd_conflicts or ssd_ownship):
        return None
    lat = np.atleast_1d(acdata.get("lat", []))
    if not len(lat):
        return None
    from ..core.asas import AsasConfig
    _c = AsasConfig()
    vmin = acdata.get("vmin", _c.vmin) if vmin is None else vmin
    vmax = acdata.get("vmax", _c.vmax) if vmax is None else vmax
    rpz_m = acdata.get("asasrpz", _c.rpz_m) if rpz_m is None else rpz_m
    tlookahead = acdata.get("asasdtlook", _c.dtlookahead) \
        if tlookahead is None else tlookahead
    lon = np.atleast_1d(acdata["lon"])
    trk = np.radians(np.atleast_1d(acdata.get("trk",
                                              np.zeros(len(lat)))))
    gs = np.atleast_1d(acdata.get("gs", np.zeros(len(lat))))
    gse, gsn = gs * np.sin(trk), gs * np.cos(trk)
    ids = list(acdata.get("id", []))
    inconf = np.atleast_1d(acdata.get("inconf", np.zeros(len(lat), bool)))
    active = np.ones(len(lat), bool)
    if ssd_all:
        sel = list(range(len(lat)))
    else:
        sel = []
        if ssd_conflicts:
            sel += list(np.flatnonzero(
                np.asarray(inconf[:len(lat)], bool)))
        sel += [i for i, a in enumerate(ids)
                if a in ssd_ownship and i not in sel]
    sel = sel[:SSD_MAX_DISCS]
    if not sel:
        return None
    return [{
        "lat": float(lat[i]), "lon": float(lon[i]),
        "conf": ssd_disc(int(i), lat, lon, gse, gsn, active,
                         vmin, vmax, rpz_m, tlookahead),
        "ve": float(gse[i]), "vn": float(gsn[i]),
        "vmin": vmin, "vmax": vmax,
        "acid": ids[i] if i < len(ids) else "",
    } for i in sel]


def _ssd_selected(scr):
    return bool(getattr(scr, "ssd_all", False)
                or getattr(scr, "ssd_conflicts", False)
                or getattr(scr, "ssd_ownship", None))


def compute_ssd_discs(sim, cols=None):
    """SSD disc data for the aircraft selected by the SSD command
    (scr.ssd_all / ssd_conflicts / ssd_ownship — reference
    radarwidget.py:751-765 selssd logic), capped at SSD_MAX_DISCS.
    ``cols``: host columns already copied for this picture
    (``render_sim``); read here in one copy when None."""
    scr = sim.scr
    if not _ssd_selected(scr):
        return None
    traf = sim.traf
    if cols is None:
        cols = _columns(sim, "active", "lat", "lon", "gseast", "gsnorth",
                        "inconf")
    active = cols["active"]
    if scr.ssd_all:
        sel = list(np.flatnonzero(active))
    else:
        # conflicts and named ownships COMBINE (reference
        # radarwidget.py:751-762 sets selssd for either condition)
        sel = []
        if scr.ssd_conflicts:
            sel += list(np.flatnonzero(active & cols["inconf"]))
        sel += [i for i in (traf.id2idx(a)
                            for a in sorted(scr.ssd_ownship))
                if isinstance(i, (int, np.integer)) and i >= 0
                and i not in sel]
    sel = sel[:SSD_MAX_DISCS]
    if not sel:
        return None
    c = sim.cfg.asas
    lat, lon = cols["lat"], cols["lon"]
    gse, gsn = cols["gseast"], cols["gsnorth"]
    return [{
        "lat": float(lat[i]), "lon": float(lon[i]),
        "conf": ssd_disc(int(i), lat, lon, gse, gsn, active,
                         c.vmin, c.vmax, c.rpz_m, c.dtlookahead),
        "ve": float(gse[i]), "vn": float(gsn[i]),
        "vmin": c.vmin, "vmax": c.vmax,
        "acid": traf.ids[int(i)],
    } for i in sel]


# --------------------------------------------------------------------------
# Navigation display: the reference's per-aircraft heading-up ND
# (ui/qtgl/nd.py:55-282) as an SVG — ownship chevron, the +-60 deg
# wedge with compass ticks, three intermediate range arcs, GS/TAS
# readout, surrounding traffic with relative-altitude tags, and the
# ownship route — selected with the SHOWND stack command.
# --------------------------------------------------------------------------

ND_W = ND_H = 400


def render_nd(sim, acid=None, range_nm=40.0):
    """SVG navigation display for one aircraft (default: SHOWND's) —
    rendered from live Simulation state."""
    acid = acid or getattr(sim.scr, "nd_acid", None)
    traf = sim.traf
    i = traf.id2idx(acid) if acid else -1
    if not isinstance(i, (int, np.integer)) or i < 0:
        return _render_nd_data(acid, None, None, None, range_nm)
    c = _columns(sim, "active", "lat", "lon", "trk", "gs", "tas", "alt",
                 "inconf")
    own = dict(lat=float(c["lat"][i]), lon=float(c["lon"][i]),
               trk=float(c["trk"][i]), gs=float(c["gs"][i]),
               tas=float(c["tas"][i]), alt=float(c["alt"][i]))
    active = c["active"]
    active[i] = False
    idx = np.flatnonzero(active)
    traffic = dict(
        id=[traf.ids[j] for j in idx],
        lat=c["lat"][idx], lon=c["lon"][idx], alt=c["alt"][idx],
        inconf=c["inconf"][idx])
    route = None
    if getattr(sim.scr, "route_acid", "") == acid:
        r = sim.routes.route(i)
        route = (list(r.lat), list(r.lon))
    return _render_nd_data(acid, own, traffic, route, range_nm)


def render_nd_acdata(nd, acid=None, range_nm=40.0):
    """ND from a GuiClient nodeData mirror (the networked-client path —
    the reference ND draws from the same streamed buffers,
    ui/qtgl/nd.py consuming the radarwidget's ACDATA state)."""
    acid = acid or getattr(nd, "nd_acid", None)
    ac = nd.acdata or {}
    ids = list(ac.get("id", []))
    if not acid or acid not in ids:
        return _render_nd_data(acid, None, None, None, range_nm)
    i = ids.index(acid)
    lat = np.atleast_1d(ac["lat"])
    lon = np.atleast_1d(ac["lon"])
    trk = np.atleast_1d(ac.get("trk", np.zeros(len(lat))))
    gs = np.atleast_1d(ac.get("gs", np.zeros(len(lat))))
    tas = np.atleast_1d(ac.get("tas", gs))
    alt = np.atleast_1d(ac.get("alt", np.zeros(len(lat))))
    inconf = np.atleast_1d(ac.get("inconf", np.zeros(len(lat), bool)))
    own = dict(lat=float(lat[i]), lon=float(lon[i]), trk=float(trk[i]),
               gs=float(gs[i]), tas=float(tas[i]), alt=float(alt[i]))
    keep = [j for j in range(len(lat)) if j != i]
    traffic = dict(id=[ids[j] for j in keep],
                   lat=lat[keep], lon=lon[keep], alt=alt[keep],
                   inconf=np.asarray(inconf)[keep])
    route = None
    rd = getattr(nd, "routedata", None) or {}
    if rd.get("wplat") and rd.get("acid", acid) == acid:
        route = (list(rd["wplat"]), list(rd["wplon"]))
    return _render_nd_data(acid, own, traffic, route, range_nm)


def _render_nd_data(acid, own, traffic, route, range_nm=40.0):
    """The ND picture from plain data (shared by the embedded and
    client paths).  ``own``: dict lat/lon/trk/gs/tas/alt; ``traffic``:
    dict of arrays id/lat/lon/alt/inconf (ownship already excluded);
    ``route``: (lats, lons) or None."""
    from ..ops import hostgeo
    cx, cy = ND_W / 2.0, ND_H * 0.78
    unit = (ND_H * 0.62) / 1.4          # 1.4 ND units = display range
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{ND_W}" '
        f'height="{ND_H}" viewBox="0 0 {ND_W} {ND_H}">',
        f'<rect width="{ND_W}" height="{ND_H}" fill="#000"/>',
    ]
    if own is None:
        parts.append('<text x="20" y="30" fill="#888" font-size="13">'
                     'ND: no aircraft selected (SHOWND acid)</text>'
                     '</svg>')
        return "\n".join(parts)

    olat, olon = own["lat"], own["lon"]
    otrk = own["trk"]
    ogs, otas = own["gs"], own["tas"]
    oalt = own["alt"]

    def arc(rad_units, lo=-60, hi=60, color="#ccc"):
        pts = []
        for a in range(lo, hi + 1, 2):
            r = rad_units * unit
            pts.append(f"{cx + r * np.sin(np.radians(a)):.1f},"
                       f"{cy - r * np.cos(np.radians(a)):.1f}")
        return (f'<polyline points="{" ".join(pts)}" fill="none" '
                f'stroke="{color}"/>')

    # wedge edge + intermediate range arcs (nd.py:99-113)
    parts.append(arc(1.4))
    for k in (1, 2, 3):
        parts.append(arc(k * 0.35, color="#444"))
    # compass ticks every 5 deg, heading labels every 30 (nd.py:124-152)
    for a in range(-60, 61, 5):
        hdg = (otrk + a) % 360.0
        big = abs(round(hdg)) % 30 < 2.5
        r0, r1 = 1.4 * unit, (1.46 if big else 1.42) * unit
        sa, ca = np.sin(np.radians(a)), np.cos(np.radians(a))
        parts.append(f'<line x1="{cx + r0 * sa:.1f}" '
                     f'y1="{cy - r0 * ca:.1f}" x2="{cx + r1 * sa:.1f}" '
                     f'y2="{cy - r1 * ca:.1f}" stroke="#ccc"/>')
        if big:
            parts.append(
                f'<text x="{cx + 1.52 * unit * sa:.1f}" '
                f'y="{cy - 1.5 * unit * ca:.1f}" fill="#ccc" '
                f'font-size="11" text-anchor="middle">'
                f'{int(round(hdg / 10.0)) % 36:02d}</text>')
    # GS/TAS readout (nd.py:158-159) + range note
    parts.append(f'<text x="8" y="16" fill="#ccc" font-size="11">GS'
                 f'<tspan fill="#3c3" dx="4">{ogs * 1.94384:.0f}'
                 f'</tspan>  TAS<tspan fill="#3c3" dx="4">'
                 f'{otas * 1.94384:.0f}</tspan></text>')
    parts.append(f'<text x="{ND_W - 8}" y="16" fill="#888" '
                 f'font-size="11" text-anchor="end">{_esc(str(acid))} '
                 f'rng {range_nm:.0f} nm</text>')

    def to_xy(lat, lon):
        qdr, dist = hostgeo.qdrdist(olat, olon, float(lat), float(lon))
        rel = np.radians(float(qdr) - otrk)
        r = float(dist) / range_nm * 1.4 * unit
        return cx + r * np.sin(rel), cy - r * np.cos(rel), float(dist)

    # ownship route, heading-up (the reference copies the route buffers)
    if route is not None:
        pts = []
        for la, lo in zip(*route):
            x, y, d = to_xy(la, lo)
            if d < range_nm * 1.6:
                pts.append(f"{x:.1f},{y:.1f}")
        if pts:
            parts.append(f'<polyline points="{" ".join(pts)}" '
                         f'fill="none" stroke="{COLORS["route"]}" '
                         f'stroke-dasharray="5 4"/>')

    # surrounding traffic (diamonds + relative altitude, TCAS-style)
    t_ids = traffic["id"] if traffic else []
    t_inconf = np.atleast_1d(traffic["inconf"]) if traffic else []
    for j in range(len(t_ids)):
        x, y, d = to_xy(traffic["lat"][j], traffic["lon"][j])
        if d > range_nm * 1.5:
            continue
        color = COLORS["ac_conf"] if (len(t_inconf) > j
                                      and t_inconf[j]) else "#fff"
        parts.append(f'<path d="M{x:.1f},{y - 5:.1f} l5,5 l-5,5 '
                     f'l-5,-5 Z" fill="none" stroke="{color}"/>')
        dalt_fl = (float(traffic["alt"][j]) - oalt) / 0.3048 / 100.0
        parts.append(f'<text x="{x + 7:.1f}" y="{y + 4:.1f}" '
                     f'fill="{color}" font-size="9">'
                     f'{_esc(str(t_ids[j]))} '
                     f'{"+" if dalt_fl >= 0 else "-"}'
                     f'{abs(dalt_fl):03.0f}</text>')

    # ownship symbol (nd.py:155 vown), fixed heading-up at the focus
    s = unit * 0.09
    parts.append(
        f'<g transform="translate({cx},{cy})" stroke="#ff0" fill="none">'
        f'<line x1="0" y1="0" x2="0" y2="{1.33 * s:.1f}"/>'
        f'<line x1="{-0.72 * s:.1f}" y1="{0.33 * s:.1f}" '
        f'x2="{0.72 * s:.1f}" y2="{0.33 * s:.1f}"/>'
        f'<line x1="{-0.24 * s:.1f}" y1="{1.11 * s:.1f}" '
        f'x2="{0.24 * s:.1f}" y2="{1.11 * s:.1f}"/></g>')
    parts.append("</svg>")
    return "\n".join(parts)


def render_plots(sim, width=640, row_h=160):
    """SVG chart sheet for the live PLOT registry — the headless
    analogue of the reference's matplotlib InfoWindow plot tabs
    (ui/qtgl/infowindow.py:34-109): one panel per PLOT command, drawn
    from the plotter's buffered series."""
    plots = [p for p in getattr(sim.plotter, "plots", [])
             if len(p.series[0]) >= 2]
    h = max(1, len(plots)) * row_h
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{h}" viewBox="0 0 {width} {h}">',
        f'<rect width="{width}" height="{h}" fill="{BG}"/>',
    ]
    if not plots:
        parts.append('<text x="16" y="28" fill="#888" font-size="12">'
                     'no plots — use e.g. PLOT simt ac.tas[0] 1'
                     '</text></svg>')
        return "\n".join(parts)
    m = 36                                   # panel margin

    def as_curve(samples):
        """Robust per-sample scalarization: unindexed PLOT variables
        buffer a (possibly ragged) vector per sample — chart the mean."""
        return np.array([float(np.mean(np.asarray(v, float)))
                         if np.size(v) else np.nan for v in samples])

    for k, p in enumerate(plots):
        xs = as_curve(p.series[0])
        ys = as_curve(p.series[1])
        keep = np.isfinite(xs) & np.isfinite(ys)
        xs, ys = xs[keep], ys[keep]
        y0 = k * row_h
        if len(xs) < 2:
            continue
        # more than ~2 samples per pixel is invisible: stride-downsample
        # so an hours-long fast-time run cannot bloat the sheet
        stride = max(1, len(xs) // (2 * (width - 2 * m)))
        xs, ys = xs[::stride], ys[::stride]
        x_lo, x_hi = float(xs.min()), float(xs.max())
        y_lo, y_hi = float(ys.min()), float(ys.max())
        xs_n = (xs - x_lo) / max(x_hi - x_lo, 1e-9)
        ys_n = (ys - y_lo) / max(y_hi - y_lo, 1e-9)
        px = m + xs_n * (width - 2 * m)
        py = y0 + row_h - m - ys_n * (row_h - 2 * m)
        pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(px, py))
        color = quoteattr(str(p.color or "#3c3"))
        parts += [
            f'<rect x="{m}" y="{y0 + m}" width="{width - 2 * m}" '
            f'height="{row_h - 2 * m}" fill="none" stroke="#334"/>',
            f'<polyline points="{pts}" fill="none" stroke={color} '
            f'stroke-width="1.5"/>',
            f'<text x="{m}" y="{y0 + m - 6}" fill="#9fd49f" '
            f'font-size="11">fig {p.fig}: '
            f'{_esc(p.y.varname)} vs {_esc(p.x.varname)}</text>',
            f'<text x="{m}" y="{y0 + row_h - m + 14}" fill="#678" '
            f'font-size="9">{x_lo:.4g}</text>',
            f'<text x="{width - m}" y="{y0 + row_h - m + 14}" '
            f'fill="#678" font-size="9" text-anchor="end">'
            f'{x_hi:.4g}</text>',
            f'<text x="{m - 4}" y="{y0 + row_h - m}" fill="#678" '
            f'font-size="9" text-anchor="end">{y_lo:.4g}</text>',
            f'<text x="{m - 4}" y="{y0 + m + 10}" fill="#678" '
            f'font-size="9" text-anchor="end">{y_hi:.4g}</text>',
        ]
    parts.append("</svg>")
    return "\n".join(parts)
