"""Example plugin: the template for writing bluesky_tpu_torch plugins.

Port of ``bluesky_tpu/plugins/example.py``, copied as it is.

Mirrors the reference ``plugins/example.py`` contract, adapted to this
framework's one difference: ``init_plugin(sim)`` receives the
Simulation handle (there are no global singletons) — reach traffic as
``sim.traf``, the stack as ``sim.stack``, areas as ``sim.areas``.
"""


def init_plugin(sim):
    ex = Example(sim)
    config = {
        # The name of your plugin
        "plugin_name": "EXAMPLE",
        # Only simulation plugins exist for now
        "plugin_type": "sim",
        # Update interval in seconds (hooks run at chunk edges)
        "update_interval": 1.0,
        # update() is called after the traffic step
        "update": ex.update,
        # preupdate() is called before the traffic step
        "preupdate": ex.preupdate,
        # reset() is called on simulation reset
        "reset": ex.reset,
    }
    stackfunctions = {
        "MYFUN": [
            "MYFUN ON/OFF",
            "[onoff]",
            ex.myfun,
            "Example plugin command: echo the flag you pass",
        ],
    }
    return config, stackfunctions


class Example:
    def __init__(self, sim):
        self.sim = sim
        self.n_updates = 0

    def update(self):
        self.n_updates += 1

    def preupdate(self):
        pass

    def reset(self):
        self.n_updates = 0

    def myfun(self, flag=True):
        return True, (f"MYFUN is {'ON' if flag else 'OFF'}; "
                      f"{self.n_updates} updates so far, "
                      f"{self.sim.traf.ntraf} aircraft flying")
