"""Live ADS-B traffic replay from the OpenSky Network REST API.

Parity with the reference ``plugins/opensky.py:34-194``: poll the
``/states/all`` endpoint every interval, create aircraft for new
callsigns, MOVE existing ones to their reported state, and delete
OpenSky-owned aircraft not updated for 10 s.

Implementation uses stdlib ``urllib`` (the reference needs the
``requests`` package); in an offline environment the OPENSKY command
connects but every poll fails gracefully with an echo, exactly like
the reference when the network is down.

Port of ``bluesky_tpu/plugins/opensky.py``: the reported states of
known aircraft are written into the state's tensors in place, one
indexed write per column on the state's device and in its dtype.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import torch

API_URL = "https://opensky-network.org/api"


def init_plugin(sim):
    reader = OpenSkyListener(sim)
    config = {
        "plugin_name": "OPENSKY",
        "plugin_type": "sim",
        "update_interval": 6.0,
        "preupdate": reader.update,
        "reset": reader.reset,
    }
    stackfunctions = {
        "OPENSKY": [
            "OPENSKY [on/off]",
            "[onoff]",
            reader.toggle,
            "Select OpenSky as a data source for traffic",
        ],
    }
    return config, stackfunctions


class OpenSkyListener:
    def __init__(self, sim):
        self.sim = sim
        self.connected = False
        self.my_ac = {}          # acid -> last update wall time
        self._warned = False

    def reset(self):
        self.connected = False
        self.my_ac = {}

    def toggle(self, flag=None):
        if flag is None:
            return True, ("OPENSKY is "
                          f"{'ON' if self.connected else 'OFF'}")
        if flag:
            self.connected = True
            self.sim.op()
            return True, "Connecting to OpenSky"
        self.connected = False
        return True, "Stopping the requests"

    def get_states(self):
        req = urllib.request.Request(API_URL + "/states/all")
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                payload = json.load(r)
        except (urllib.error.URLError, OSError, ValueError) as e:
            if not self._warned:
                self.sim.scr.echo(f"OPENSKY: request failed ({e}); "
                                  "retrying each interval")
                self._warned = True
            return None
        states = payload.get("states")
        return list(zip(*states)) if states else None

    def update(self):
        if not self.connected:
            return
        states = self.get_states()
        if states is None:
            return
        (icao24, acid, _orig, _tpos, _tcontact, lon, lat, _galt,
         _ongnd, spd, hdg, vspd, _sens, baro_alt, *_rest) = states[:14]

        def f(x):
            return np.array([v if v is not None else np.nan for v in x],
                            np.float64)

        lat, lon, alt = f(lat), f(lon), f(baro_alt)
        hdg, vspd, spd = f(hdg), f(vspd), f(spd)
        # null callsigns fall back to the icao24 hex id (str(None) is
        # truthy — guard on the raw value)
        acid = np.array([(i or "").strip() or str(h) for i, h in
                         zip(acid, icao24)])
        valid = ~np.logical_or.reduce(
            [np.isnan(x) for x in (lat, lon, alt, hdg, vspd, spd)])

        traf = self.sim.traf
        idx = np.array([traf.id2idx(a) for a in acid])
        newac = (idx < 0) & valid
        other = (idx >= 0) & valid
        curtime = time.time()

        n_new = int(newac.sum())
        if n_new:
            free = sum(1 for v in traf.ids if v is None)
            if n_new > free:     # keep within the padded capacity
                extra = np.flatnonzero(newac)[free:]
                newac[extra] = False
                n_new = free
        if n_new:
            traf.create(n_new, "B744", alt[newac], spd[newac], None,
                        lat[newac], lon[newac], hdg[newac],
                        list(acid[newac]))
            traf.flush()
            for a in acid[newac]:
                self.my_ac[a] = curtime
        if other.any():
            ac = traf.state.ac
            j = torch.as_tensor(idx[other], device=ac.lat.device)

            def put(arr, val):
                arr[j] = torch.as_tensor(np.asarray(val, np.float64)).to(
                    arr.device, arr.dtype)

            for name, val in (("lat", lat), ("lon", lon), ("alt", alt),
                              ("hdg", hdg), ("trk", hdg), ("selspd", spd),
                              ("selvs", vspd)):
                put(getattr(ac, name), val[other])
            for a in acid[other]:
                if a in self.my_ac:
                    self.my_ac[a] = curtime
        # Drop OpenSky-owned aircraft silent for > 10 s
        dele = [a for a, t in self.my_ac.items()
                if curtime - t > 10.0 and traf.id2idx(a) >= 0]
        if dele:
            traf.delete([traf.id2idx(a) for a in dele])
            for a in dele:
                self.my_ac.pop(a, None)
