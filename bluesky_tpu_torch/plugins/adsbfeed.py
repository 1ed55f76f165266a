"""Mode-S/ADS-B live feed plugin (Beast/AVR TCP stream + pyModeS).

Parity with the reference ``plugins/adsbfeed.py`` + ``adsb_decoder.py``:
connect a raw TCP stream of Mode-S frames (dump1090-style), decode
identification/position/velocity messages, and drive the traffic
arrays from the decoded reports.

The decoder depends on the optional ``pyModeS`` package (same as the
reference); the transport and framing run on stdlib sockets.  Without
pyModeS the plugin loads but ADSBFEED reports the missing dependency —
mirroring the reference's optional-dependency behavior (e.g. SSD and
pyclipper).

Port of ``bluesky_tpu/plugins/adsbfeed.py``: a known aircraft's decoded
report is written into the state's tensors in place, on their device
and in their dtype.
"""
import socket
import threading
import time

try:
    import pyModeS as pms
except ImportError:          # optional, like the reference
    pms = None


def init_plugin(sim):
    feed = AdsbFeed(sim)
    config = {
        "plugin_name": "ADSBFEED",
        "plugin_type": "sim",
        "update_interval": 1.0,
        "preupdate": feed.update,
        "reset": feed.reset,
    }
    stackfunctions = {
        "ADSBFEED": [
            "ADSBFEED [ON/OFF or host[:port]]",
            "[txt]",
            feed.toggle,
            "Receive live Mode-S/ADS-B traffic from a raw TCP feed",
        ],
    }
    return config, stackfunctions


class AdsbFeed:
    def __init__(self, sim):
        self.sim = sim
        self.host = "127.0.0.1"
        self.port = 30002        # dump1090 raw output
        self.running = False
        self._thread = None
        self._lock = threading.Lock()
        self._frames = []        # raw hex frames from the reader thread
        self.acpos = {}          # icao -> dict(lat, lon, alt, spd, hdg,
        #                                        vs, callsign, t)

    # ------------------------------------------------------------ control
    def toggle(self, arg=None):
        if pms is None:
            return False, ("ADSBFEED needs the optional pyModeS package "
                           "(not installed) — same dependency as the "
                           "reference plugin")
        if arg is None:
            return True, f"ADSBFEED is {'ON' if self.running else 'OFF'}"
        a = str(arg).upper()
        if a in ("OFF", "FALSE", "0"):
            self.running = False
            return True, "ADSBFEED stopped"
        if a not in ("ON", "TRUE", "1"):
            host = str(arg)
            if ":" in host:
                host, port = host.rsplit(":", 1)
                self.port = int(port)
            self.host = host
        # Stop any existing reader before (re)connecting so a repeat ON
        # or a host switch never leaves two connections streaming
        if self._thread is not None and self._thread.is_alive():
            self.running = False
            self._thread.join(timeout=3)
        self.running = True
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()
        return True, f"ADSBFEED connecting to {self.host}:{self.port}"

    def reset(self):
        self.running = False
        self.acpos = {}

    # ------------------------------------------------------- reader thread
    def _reader(self):
        try:
            conn = socket.create_connection((self.host, self.port),
                                            timeout=5)
        except OSError as e:
            self.sim.scr.echo(f"ADSBFEED: connect failed: {e}")
            self.running = False
            return
        conn.settimeout(1.0)
        buf = b""
        while self.running:
            try:
                data = conn.recv(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            buf += data
            # dump1090 raw format: '*<hex>;\n'
            while b";" in buf:
                frame, buf = buf.split(b";", 1)
                frame = frame.strip().lstrip(b"*")
                if frame:
                    with self._lock:
                        self._frames.append(frame.decode("ascii",
                                                         "ignore"))
        conn.close()

    # ------------------------------------------------------------- update
    def update(self):
        """Decode buffered frames and sync the traffic arrays
        (adsb_decoder.py semantics: DF17 ident/position/velocity)."""
        if pms is None or not self.running:
            return
        with self._lock:
            frames, self._frames = self._frames, []
        now = time.time()
        for msg in frames:
            if len(msg) != 28 or pms.df(msg) != 17:
                continue
            icao = pms.adsb.icao(msg)
            tc = pms.adsb.typecode(msg)
            rec = self.acpos.setdefault(icao, {"t": now})
            rec["t"] = now
            if 1 <= tc <= 4:
                rec["callsign"] = pms.adsb.callsign(msg).strip("_")
            elif 9 <= tc <= 18:
                pos = pms.adsb.position_with_ref(
                    msg, rec.get("lat", 52.0), rec.get("lon", 4.0))
                if pos:
                    rec["lat"], rec["lon"] = pos
                rec["alt"] = (pms.adsb.altitude(msg) or 0) * 0.3048
            elif tc == 19:
                vel = pms.adsb.velocity(msg)
                if vel:
                    spd, hdg, vs, _ = vel
                    rec["spd"] = (spd or 0) * 0.514444
                    rec["hdg"] = hdg or 0.0
                    rec["vs"] = (vs or 0) * 0.00508
        self._sync(now)

    def _sync(self, now):
        traf = self.sim.traf
        stale = [k for k, r in self.acpos.items() if now - r["t"] > 30.0]
        for k in stale:
            r = self.acpos.pop(k)
            i = traf.id2idx(r.get("acid_used", ""))
            if isinstance(i, int) and i >= 0:
                traf.delete(i)
        for icao, r in self.acpos.items():
            if "lat" not in r or "spd" not in r:
                continue        # need a full state before creating
            acid = (r.get("callsign") or icao).upper()
            used = r.get("acid_used")
            if used is not None and used != acid:
                # ident frame arrived after creation under the hex icao:
                # retire the old slot so the airframe never duplicates
                old = traf.id2idx(used)
                if isinstance(old, int) and old >= 0:
                    traf.delete(old)
                r.pop("acid_used")
            i = traf.id2idx(acid)
            if not isinstance(i, int) or i < 0:
                if not any(v is None for v in traf.ids):
                    continue    # capacity full
                traf.create(1, "B744", r.get("alt", 0.0), r["spd"],
                            None, r["lat"], r["lon"], r.get("hdg", 0.0),
                            acid)
                traf.flush()
                r["acid_used"] = acid
            else:
                ac = traf.state.ac
                for name, v in (("lat", r["lat"]), ("lon", r["lon"]),
                                ("alt", r.get("alt", 0.0)),
                                ("hdg", r.get("hdg", 0.0)),
                                ("trk", r.get("hdg", 0.0)),
                                ("selspd", r["spd"]),
                                ("selvs", r.get("vs", 0.0))):
                    getattr(ac, name)[i] = float(v)
