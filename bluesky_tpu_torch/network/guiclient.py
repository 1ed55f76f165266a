"""GUI-side client: the per-node data mirror the radar draws from.

Parity with the reference ``ui/qtgl/guiclient.py:19-296``: a ``Client``
subclass that subscribes to the ACDATA/ROUTEDATA/SIMINFO streams and
maintains a ``nodeData`` mirror per connected sim node — last aircraft
frame, accumulated trail segments, shape registry (SHAPE events), the
selected route, echo history, and sim info.  The reference's
RadarWidget consumes exactly this mirror; here ``render_svg`` draws it
through ``ui/radar.py`` so a connected client can save radar frames
without Qt.

Port of ``bluesky_tpu/network/guiclient.py`` over the port's
``network/client.Client``: the mirror is host code, fed by the streams
of the port's server and workers (or the JAX package's: the wire format
is the same).
"""
from collections import defaultdict

import numpy as np

from ..ui import radar
from .client import Client

STREAM_TOPICS = [b"ACDATA", b"ROUTEDATA", b"SIMINFO"]


class nodeData:
    """Mirror of one sim node's display state (guiclient.py:93-296)."""

    def __init__(self):
        self.acdata = {}
        self.routedata = {}
        self.siminfo = {}
        self.shapes = {}          # name -> (kind, coords)
        self.echo_text = []
        self.custwpts = {}        # DEFWPT mirror: name -> (lat, lon)
        self.flags = {}           # DISPLAYFLAG mirror: flag -> last args
        self.ssd_all = False      # SSD disc selection mirror
        self.ssd_conflicts = False   # (reference guiclient.py:138-140)
        self.ssd_ownship = set()
        self.nd_acid = None       # SHOWND selection mirror
        # Accumulated trail picture (ACDATA carries deltas)
        self.traillat0 = np.array([])
        self.traillon0 = np.array([])
        self.traillat1 = np.array([])
        self.traillon1 = np.array([])

    MAX_TRAIL_SEGMENTS = 20000

    def show_ssd(self, arg):
        """SSD selection update (reference guiclient.py:283-296)."""
        arg = {str(a).upper() for a in (arg or [])}
        if "ALL" in arg:
            self.ssd_all, self.ssd_conflicts = True, False
        elif "CONFLICTS" in arg:
            self.ssd_all, self.ssd_conflicts = False, True
        elif "OFF" in arg:
            self.ssd_all, self.ssd_conflicts = False, False
            self.ssd_ownship = set()
        else:
            remove = self.ssd_ownship.intersection(arg)
            self.ssd_ownship = self.ssd_ownship.union(arg) - remove

    def setacdata(self, data):
        self.acdata = data
        if len(np.atleast_1d(data.get("traillat0", []))):
            self.traillat0 = np.append(self.traillat0,
                                       data["traillat0"])
            self.traillon0 = np.append(self.traillon0,
                                       data["traillon0"])
            self.traillat1 = np.append(self.traillat1,
                                       data["traillat1"])
            self.traillon1 = np.append(self.traillon1,
                                       data["traillon1"])
            if len(self.traillat0) > self.MAX_TRAIL_SEGMENTS:
                keep = self.MAX_TRAIL_SEGMENTS
                self.traillat0 = self.traillat0[-keep:]
                self.traillon0 = self.traillon0[-keep:]
                self.traillat1 = self.traillat1[-keep:]
                self.traillon1 = self.traillon1[-keep:]
        if not data.get("swtrails", False):
            self.traillat0 = np.array([])
            self.traillon0 = np.array([])
            self.traillat1 = np.array([])
            self.traillon1 = np.array([])


class GuiClient(Client):
    """Client + nodeData bookkeeping (guiclient.py:19-92)."""

    def __init__(self):
        super().__init__()
        self.nodedata = defaultdict(nodeData)
        self.event_received.connect(self._on_event)
        self.stream_received.connect(self._on_stream)

    def connect(self, **kw):
        super().connect(**kw)
        for topic in STREAM_TOPICS:
            self.subscribe(topic)

    def get_nodedata(self, nodeid=None):
        nodeid = nodeid or self.actnode()
        return self.nodedata[nodeid]

    # ------------------------------------------------------------ intake
    def _on_event(self, name, data, sender):
        nd = self.nodedata[sender]
        if name == b"ECHO":
            nd.echo_text.append(data.get("text", ""))
        elif name == b"SHAPE":
            # Reference wire format (screenio.py:171 / guiclient.py:158):
            # coordinates=None deletes the named shape.
            if data.get("coordinates") is not None:
                nd.shapes[data["name"]] = (data.get("shape"),
                                           data.get("coordinates"))
            else:
                nd.shapes.pop(data.get("name"), None)
        elif name == b"DEFWPT":
            nd.custwpts[data["name"]] = (data.get("lat"), data.get("lon"))
        elif name == b"DISPLAYFLAG":
            nd.flags[data.get("flag")] = data.get("args")
            if data.get("flag") == "SSD":
                nd.show_ssd(data.get("args"))
            elif data.get("flag") == "SHOWND":
                nd.nd_acid = data.get("args")

    def _on_stream(self, name, data, sender):
        nd = self.nodedata[sender]
        if name == b"ACDATA":
            nd.setacdata(data)
        elif name == b"ROUTEDATA":
            nd.routedata = data if data.get("wplat") else {}
        elif name == b"SIMINFO":
            nd.siminfo = data

    # ------------------------------------------------------------ output
    def render_svg(self, fname=None, nodeid=None):
        """Draw the mirrored radar picture (RadarWidget stand-in)."""
        nd = self.get_nodedata(nodeid)
        acdata = dict(nd.acdata)
        acdata["traillat0"] = nd.traillat0
        acdata["traillon0"] = nd.traillon0
        acdata["traillat1"] = nd.traillat1
        acdata["traillon1"] = nd.traillon1
        info = nd.siminfo
        title = (f"simt {info.get('simt', 0):.1f} s — "
                 f"{info.get('ntraf', 0)} aircraft — "
                 f"{info.get('speed', 0):.1f}x") if info else ""
        svg = radar.render_svg(acdata, nd.shapes, nd.routedata, title,
                               ssd=radar.compute_ssd_discs_acdata(
                                   nd.acdata, nd.ssd_all,
                                   nd.ssd_conflicts, nd.ssd_ownship))
        if fname:
            with open(fname, "w") as f:
                f.write(svg)
        return svg
