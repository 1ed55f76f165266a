"""Sim-side screen proxy: batches GUI state into network streams
(port of ``bluesky_tpu/simulation/screenio.py``; parity:
bluesky/simulation/qtgl/screenio.py:11-263).

Echo text is routed back to the client that issued the command; SIMINFO
(achieved sim rate, 1 Hz) and ACDATA (aircraft state subset, 5 Hz) are
published as streams.  ACDATA comes from the newest retired chunk
edge's telemetry, which the edge already copied to the host behind its
chunk (``ChunkEdge.acdata_arrays``): no device read and no wait on a
chunk in flight.  Without a retired edge (before the first chunk, after
a command that changed the state) the live state's fields are read in
one device-to-host copy (``_live_arrays``), not one per field.  Every
array sent is numpy, so the JAX package's clients decode the frames.
"""
import time

import numpy as np
import torch

ACDATA_DT = 0.2       # 5 Hz (screenio.py:18-21)
SIMINFO_DT = 1.0      # 1 Hz

#: The live-state fields of an ACDATA frame, by sub-state.
_LIVE_FIELDS = (("ac", ("active", "lat", "lon", "alt", "trk", "tas", "gs",
                        "cas", "vs")),
                ("asas", ("inconf", "tcpamax", "asasn", "asase",
                          "nconf_cur", "nlos_cur")))

from .sim import DisplayState


def _live_arrays(state) -> dict:
    """The live state's ACDATA fields as numpy arrays of their own
    dtypes, in one device-to-host copy: each field's bytes go into one
    flat uint8 tensor on the device, which is copied once and cut back
    into the fields on the host."""
    names, parts = [], []
    for sub, fields in _LIVE_FIELDS:
        for name in fields:
            t = getattr(getattr(state, sub), name).detach().reshape(-1)
            names.append((name, t.dtype, t.numel()))
            parts.append(t.contiguous().view(torch.uint8))
    flat = torch.cat(parts).cpu().numpy()
    out, off = {}, 0
    for name, dtype, n in names:
        npdt = torch.empty(0, dtype=dtype).numpy().dtype
        nb = n * npdt.itemsize
        out[name] = flat[off:off + nb].view(npdt)
        off += nb
    return out


class ScreenIO(DisplayState):
    """Duck-types simulation.sim.Screen; streams instead of buffering.

    Inherits the DisplayState surface (pan/zoom/feature/objappend/...)
    so every display stack command works in node mode too."""

    def __init__(self, sim, node):
        self.sim = sim
        self.node = node
        self.current_sender = ""      # set by the stack before echo calls
        self.echobuf = []             # bounded echo history
        self._init_display()
        self._nconf_prev = 0
        self._nconf_tot = 0
        self._nlos_prev = 0
        self._nlos_tot = 0
        self.samplecount = 0
        self.prevcount = 0
        self.prevtime = time.perf_counter()
        self.prevsimt = 0.0
        # Stream cadence is tracked locally, NOT via the process-global
        # Timer registry: with several nodes in one process a global timer
        # would fire this node's ZMQ sends from another node's thread
        # (pyzmq sockets are not thread-safe).  update() runs on this
        # node's own thread each loop iteration.
        now = time.perf_counter()
        self._next_siminfo = now + SIMINFO_DT
        self._next_acdata = now + ACDATA_DT

    def close(self):
        pass

    # ------------------------------------------------------------- commands
    def reset(self):
        """Sim RESET: clear display state + cumulative counters."""
        self._init_display()
        self._nconf_prev = self._nconf_tot = 0
        self._nlos_prev = self._nlos_tot = 0

    def objappend(self, objtype, objname, data):
        """Shape registry + broadcast to GUI clients (the reference
        mirrors shapes through events, guiclient nodeData.update)."""
        super().objappend(objtype, objname, data)
        # Wire format is the REFERENCE client's kwargs: nodeData
        # .update_poly_data(name, shape, coordinates) — guiclient.py:158
        # splats the event dict, so key names are API (coordinates=None
        # deletes the shape).
        self.node.send_event(b"SHAPE", {
            "name": objname, "shape": objtype,
            "coordinates": list(data) if data is not None else None},
            [b"*"])
        return True

    # Display-flag mirrors (reference screenio.py:132-160): the Qt
    # client's nodeData.setflag(**data) consumes these kwargs verbatim.
    def symbol(self):
        super().symbol()
        self.node.send_event(b"DISPLAYFLAG", {"flag": "SYM"}, [b"*"])
        return True

    def feature(self, sw, arg=None):
        super().feature(sw, arg)
        self.node.send_event(b"DISPLAYFLAG",
                             {"flag": sw, "args": arg}, [b"*"])
        return True

    def shownd(self, acid=None):
        """ND selection, mirrored to clients (the reference toggles the
        client-side ND via the SHOWND display event, screenio.py:132)."""
        super().shownd(acid)
        self.node.send_event(b"DISPLAYFLAG",
                             {"flag": "SHOWND", "args": acid}, [b"*"])
        return True

    def show_ssd(self, *args):
        """SSD disc selection, mirrored to clients the reference way
        (stack.py:697-700 feature('SSD', args) -> guiclient.py:270
        show_ssd)."""
        super().show_ssd(*args)
        self.node.send_event(b"DISPLAYFLAG",
                             {"flag": "SSD", "args": list(args)}, [b"*"])
        return True

    def filteralt(self, flag, bottom=None, top=None):
        super().filteralt(flag, bottom, top)
        self.node.send_event(
            b"DISPLAYFLAG",
            {"flag": "FILTERALT",
             "args": (flag, bottom, top) if flag else (False,)}, [b"*"])
        return True

    def addnavwpt(self, name, lat, lon):
        """Custom-waypoint mirror (reference screenio.py:147-150): key
        names are the reference nodeData.defwpt kwargs."""
        super().addnavwpt(name, lat, lon)
        self.node.send_event(b"DEFWPT", {"name": name, "lat": float(lat),
                                         "lon": float(lon)}, [b"*"])
        return True

    def echo(self, text="", flags=0):
        self.echobuf.append(text)
        if len(self.echobuf) > 1000:      # bounded history
            del self.echobuf[:-500]
        # ZMQ senders are comma-joined hex reply routes (multi-hop for
        # chained servers, see simnode STACKCMD); non-hex senders (the
        # TCP/telnet bridge uses 'tcpN') get their reply from the
        # bridge's own echobuf capture, so the event broadcasts instead.
        try:
            route = [bytes.fromhex(p)
                     for p in self.current_sender.split(",")] \
                if self.current_sender else None
        except ValueError:
            route = None
        self.node.send_event(b"ECHO", {"text": text, "flags": flags}, route)
        return True

    def update(self):
        self.samplecount += 1
        now = time.perf_counter()
        if now >= self._next_siminfo:
            self._next_siminfo = now + SIMINFO_DT
            self.send_siminfo()
        if now >= self._next_acdata:
            self._next_acdata = now + ACDATA_DT
            self.send_aircraft_data()
            if self.route_acid:
                self.send_route_data()

    # -------------------------------------------------------------- streams
    def send_siminfo(self):
        """Achieved sim speed etc at 1 Hz (screenio.py:185-192).

        Uses the planned clock: with a chunk in flight (pipelined
        stepping) a device read here would stall this node thread until
        the chunk drains."""
        now = time.perf_counter()
        simt = self.sim.simt_planned
        dt = max(now - self.prevtime, 1e-9)
        speed = (simt - self.prevsimt) / dt
        self.prevtime, self.prevsimt = now, simt
        self.node.send_stream(b"SIMINFO", {
            "speed": speed, "simdt": self.sim.simdt, "simt": simt,
            "ntraf": self.sim.traf.ntraf, "state": self.sim.state_flag,
            "scenname": getattr(self.sim.stack, "scenname", "")})

    def send_aircraft_data(self):
        """ACDATA stream at 5 Hz, shaped to what the reference Qt
        GuiClient consumes (screenio.py:194-239 producer,
        guiclient.py:93-296 consumer): per-aircraft state arrays,
        conflict flags/counters, ASAS resolution vectors and speed caps,
        and delta-encoded trail segments.

        Counter semantics divergence: the reference counts its host-side
        unique/cumulative pair SETS; here the current counts come from
        the device scalars (directional, halved) and the totals from a
        host accumulator of count increases — same monotonic meaning
        without an [N,N] transfer at 5 Hz.
        """
        sim = self.sim
        traf = sim.traf
        edge = sim._last_edge
        if edge is not None:
            # Fused edge telemetry: every per-aircraft field below comes
            # from the most recent retired chunk edge's pack — ONE bulk
            # device->host copy (cached on the edge), no per-field pulls
            # and no stall on an in-flight pipelined chunk.  Commands
            # that mutate state invalidate the cache (stack.py), falling
            # back to the live-state path until the next edge retires.
            idx, data = edge.acdata_arrays()
            data["simt"] = edge.simt
            data["id"] = [traf.ids[i] for i in idx]
            data["actype"] = [traf.types[i] for i in idx]
            nconf = int(np.asarray(edge.nconf_cur)) // 2   # -> pairs
            nlos = int(np.asarray(edge.nlos_cur)) // 2
        else:
            live = _live_arrays(traf.state)
            idx = np.flatnonzero(live.pop("active"))
            data = {"simt": sim.simt,
                    "id": [traf.ids[i] for i in idx],
                    "actype": [traf.types[i] for i in idx]}
            nconf = int(live.pop("nconf_cur")[0]) // 2   # -> pairs
            nlos = int(live.pop("nlos_cur")[0]) // 2
            for name, arr in live.items():
                data[name] = arr[idx]
        self._nconf_tot += max(0, nconf - self._nconf_prev)
        self._nlos_tot += max(0, nlos - self._nlos_prev)
        self._nconf_prev, self._nlos_prev = nconf, nlos
        data["nconf_cur"] = nconf
        data["nconf_tot"] = self._nconf_tot
        data["nlos_cur"] = nlos
        data["nlos_tot"] = self._nlos_tot
        data["vmin"] = sim.cfg.asas.vmin
        data["vmax"] = sim.cfg.asas.vmax
        # ASAS conflict geometry, so networked clients draw their SSD
        # discs with the server's ACTUAL ZONER/DTLOOK instead of the
        # defaults (the reference client hard-codes display constants —
        # a silent divergence this stream field closes)
        data["asasrpz"] = sim.cfg.asas.rpz_m
        data["asasdtlook"] = sim.cfg.asas.dtlookahead
        # Trails: only the segments added since the last send
        # (screenio.py:216-227)
        trails = traf.trails
        data["swtrails"] = trails.active
        data["traillat0"] = trails.newlat0
        data["traillon0"] = trails.newlon0
        data["traillat1"] = trails.newlat1
        data["traillon1"] = trails.newlon1
        trails.clearnew()
        data["traillastlat"] = trails.lastlat[idx]
        data["traillastlon"] = trails.lastlon[idx]
        data["translvl"] = getattr(traf, "translvl", 0.0)
        self.node.send_stream(b"ACDATA", data)

    def send_route_data(self, acid=""):
        """ROUTEDATA for the requested aircraft (screenio.py:241-263)."""
        traf = self.sim.traf
        acid = acid or self.route_acid
        if not acid:
            return
        i = traf.id2idx(acid)
        if i < 0:
            # Aircraft gone: acid-only frame clears the GUI's route
            # display (reference sends data with just 'acid' when idx<0)
            self.node.send_stream(b"ROUTEDATA", {"acid": acid})
            self.route_acid = ""
            return
        rte = self.sim.routes.route(i)
        st = traf.state.ac
        aclat, aclon = (float(v) for v in
                        torch.stack([st.lat[i], st.lon[i]]).tolist())
        self.node.send_stream(b"ROUTEDATA", {
            "acid": acid, "aclat": aclat, "aclon": aclon,
            "wplat": list(rte.lat), "wplon": list(rte.lon),
            "wpalt": list(rte.alt), "wpspd": list(rte.spd),
            "wpname": list(rte.name), "iactwp": rte.iactwp})

