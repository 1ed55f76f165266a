"""Plugin system: discovery, loading, and per-plugin update scheduling.

Parity with the reference ``bluesky/tools/plugin.py:29-190``: plugin files
are recognised by AST scan for an ``init_plugin`` function (no import of
non-plugins), loaded on demand, and their ``preupdate`` / ``update`` /
``reset`` hooks run on per-plugin dt schedules; plugin stack commands are
appended to the command dictionary and removed on unload.  The
``PLUGINS LIST/LOAD/REMOVE`` stack command mirrors ``manage()``
(plugin.py:70-88).

Port of ``bluesky_tpu/plugins/__init__.py``: host code, copied with two
changes.  A plugin file found on ``settings.plugin_path`` loads as the
submodule ``bluesky_tpu_torch.plugins.<name>`` (``spec_from_file_location``
with the package-qualified name, nothing put on ``sys.path``), so it may
import the framework relatively as the shipped plugins do.  Plugins
read the state's tensors on the host through ``utils.asnumpy`` (a CUDA
tensor has no ``np.asarray``) and write into them in place, on their
device and in their dtype.

Divergences from the reference, as in the JAX package:
* ``init_plugin(sim)`` receives the Simulation object — there are no
  module-global singletons in this framework, so plugins reach traffic /
  stack / areas through the sim handle (reference plugins do
  ``from bluesky import traf, sim``).  Plugins written for the reference
  need that one-line signature change.
* Hooks run at *chunk edges*: preupdate before the device chunk, update
  after it.  The Simulation clamps the chunk so edges land at least every
  ``min(plugin dt)`` of sim time — the chunk on the device never calls
  into Python; a due hook makes its edge synchronous (sync reason
  ``plugin``), and with no hook due the pipelined chunks run on.
* ``importlib`` instead of the removed ``imp`` module.
"""
import ast
import importlib.util
import os
import sys
from glob import glob

from .. import settings

# Built-in plugins shipped with the framework live next to this file.
BUILTIN_PATH = os.path.dirname(__file__)


def host_arrays(*tensors):
    """Host NumPy copies of equal-length state columns in one
    device-to-host copy: the columns are stacked as float64 on their
    device (exact for the state's float32, float64, int32 and bool),
    copied once, and each row comes back in its column's own dtype.
    The copies never alias the state, on the CPU either."""
    import torch
    rows = torch.stack([t.to(torch.float64) for t in tensors]).cpu().numpy()
    return [rows[i].astype(torch.empty(0, dtype=t.dtype).numpy().dtype)
            for i, t in enumerate(tensors)]


class PluginDescription:
    def __init__(self, fname):
        self.fname = fname
        self.module_name = os.path.splitext(os.path.basename(fname))[0]
        self.plugin_doc = ""
        self.plugin_name = ""
        self.plugin_type = ""
        self.plugin_stack = []   # [(cmdname, helptext)]


def check_plugin(fname):
    """AST-scan a file for the init_plugin contract (plugin.py:29-67).

    Returns a PluginDescription or None.  Never imports the module; the
    config dict's plugin_name/plugin_type string constants are read from
    the parse tree.
    """
    try:
        with open(fname, "rb") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return None
    for item in tree.body:
        if not (isinstance(item, ast.FunctionDef)
                and item.name == "init_plugin"):
            continue
        plugin = PluginDescription(fname)
        plugin.plugin_doc = ast.get_docstring(tree) or ""
        ret_dicts = []
        ret_names = ["", ""]
        for iitem in reversed(item.body):
            if isinstance(iitem, ast.Return):
                if not (isinstance(iitem.value, (ast.Tuple, ast.List))
                        and len(iitem.value.elts) == 2):
                    return None
                ret_dicts = list(iitem.value.elts)
                ret_names = [el.id if isinstance(el, ast.Name) else ""
                             for el in ret_dicts]
            if isinstance(iitem, ast.Assign) \
                    and isinstance(iitem.value, ast.Dict) \
                    and isinstance(iitem.targets[0], ast.Name):
                for i in range(2):
                    if iitem.targets[0].id == ret_names[i]:
                        ret_dicts[i] = iitem.value
        if len(ret_dicts) != 2 or not all(
                isinstance(d, ast.Dict) for d in ret_dicts):
            return None
        cfg = {k.value: v for k, v in zip(ret_dicts[0].keys,
                                          ret_dicts[0].values)
               if isinstance(k, ast.Constant)}
        name = cfg.get("plugin_name")
        ptype = cfg.get("plugin_type")
        if not (isinstance(name, ast.Constant)
                and isinstance(ptype, ast.Constant)):
            return None
        plugin.plugin_name = str(name.value)
        plugin.plugin_type = str(ptype.value)
        for k, v in zip(ret_dicts[1].keys, ret_dicts[1].values):
            if isinstance(k, ast.Constant):
                doc = ""
                if isinstance(v, (ast.List, ast.Tuple)) and v.elts \
                        and isinstance(v.elts[-1], ast.Constant):
                    doc = str(v.elts[-1].value)
                plugin.plugin_stack.append((str(k.value).upper(), doc))
        return plugin
    return None


class PluginManager:
    """Per-Simulation plugin registry + hook scheduler."""

    def __init__(self, sim, mode="sim"):
        self.sim = sim
        self.mode = mode
        self.descriptions = {}
        self.active = {}
        # name -> [next_trigger_t, dt, fun]
        self.preupdate_funs = {}
        self.update_funs = {}
        self.reset_funs = {}
        self._hooks = {}         # name -> (create hooks, delete hooks)
        self.discover()

    # ----------------------------------------------------------- discovery
    def discover(self):
        """Scan the builtin package dir + settings.plugin_path
        (plugin.py:91-105)."""
        dirs = [BUILTIN_PATH]
        ext = os.path.abspath(settings.plugin_path)
        if os.path.isdir(ext) and ext != BUILTIN_PATH:
            dirs.append(ext)
        for d in dirs:
            for fname in sorted(glob(os.path.join(d, "*.py"))):
                if os.path.basename(fname) == "__init__.py":
                    continue
                p = check_plugin(fname)
                if p and p.plugin_type == self.mode:
                    self.descriptions[p.plugin_name.upper()] = p

    # ------------------------------------------------------------- manage
    def manage(self, cmd="LIST", name=""):
        """PLUGINS LIST/LOAD/REMOVE (plugin.py:70-88)."""
        cmd = (cmd or "LIST").upper()
        name = (name or "").upper()
        if cmd == "LIST":
            running = sorted(self.active)
            avail = sorted(set(self.descriptions) - set(self.active))
            text = "Currently running plugins: " + (", ".join(running)
                                                    or "-")
            text += ("\nAvailable plugins: " + ", ".join(avail)) if avail \
                else "\nNo additional plugins available."
            return True, text
        if cmd in ("LOAD", "ENABLE"):
            return self.load(name)
        if cmd in ("REMOVE", "UNLOAD", "DISABLE"):
            return self.remove(name)
        # bare name given -> load it
        return self.load(cmd)

    def load(self, name):
        if name in self.active:
            return False, f"Plugin {name} already loaded"
        descr = self.descriptions.get(name)
        if not descr:
            return False, f"Error loading plugin: plugin {name} not found."
        # Snapshot traffic hook lists so unload can strip what the plugin's
        # init adds (reference plugins attach via TrafficArrays parenting;
        # here via traf.create_hooks/delete_hooks).
        traf = self.sim.traf
        n_create_hooks = len(traf.create_hooks)
        n_delete_hooks = len(traf.delete_hooks)
        try:
            if os.path.dirname(os.path.abspath(descr.fname)) \
                    == BUILTIN_PATH:
                # Shipped plugins are real package submodules (they use
                # relative imports into the framework)
                mod = importlib.import_module(
                    f"{__name__}.{descr.module_name}")
            else:
                # External plugins load from file as submodules of this
                # package (relative imports into the framework work;
                # nothing goes on sys.path)
                spec = importlib.util.spec_from_file_location(
                    f"{__name__}.{descr.module_name}", descr.fname)
                mod = importlib.util.module_from_spec(spec)
                sys.modules[spec.name] = mod
                try:
                    spec.loader.exec_module(mod)
                except Exception:
                    sys.modules.pop(spec.name, None)
                    raise
            config, stackfuns = mod.init_plugin(self.sim)
        except Exception as e:
            # Strip any traffic hooks a half-initialized plugin attached
            del traf.create_hooks[n_create_hooks:]
            del traf.delete_hooks[n_delete_hooks:]
            return False, f"Failed to load {name}: {e}"
        self.active[name] = mod
        self._hooks[name] = (traf.create_hooks[n_create_hooks:],
                             traf.delete_hooks[n_delete_hooks:])
        dt = max(float(config.get("update_interval", 0.0)), self.sim.simdt)
        simt = self.sim.simt
        if config.get("preupdate"):
            self.preupdate_funs[name] = [simt + dt, dt,
                                         config["preupdate"]]
        if config.get("update"):
            self.update_funs[name] = [simt + dt, dt, config["update"]]
        if config.get("reset"):
            self.reset_funs[name] = config["reset"]
        self.sim.stack.append_commands(stackfuns)
        descr.plugin_stack = [(k.upper(), v[-1]) for k, v in
                              stackfuns.items()]
        # Loggers the plugin created get their auto stack command
        # (FLSTLOG ON/OFF...; datalog.py:106-110 contract)
        self.sim.datalog.register_stack_commands(self.sim)
        return True, f"Successfully loaded plugin {name}"

    def remove(self, name):
        if name not in self.active:
            return False, f"Plugin {name} not loaded"
        rst = self.reset_funs.pop(name, None)
        if rst:
            # Reference parity: remove() calls the plugin reset first "to
            # clear plugin state just in case" (plugin.py:147-151).
            rst()
        descr = self.descriptions[name]
        self.sim.stack.remove_commands([c for c, _ in descr.plugin_stack])
        self.active.pop(name)
        self.preupdate_funs.pop(name, None)
        self.update_funs.pop(name, None)
        # Strip the traffic hooks this plugin's init registered
        chooks, dhooks = self._hooks.pop(name, ([], []))
        traf = self.sim.traf
        traf.create_hooks = [h for h in traf.create_hooks
                             if h not in chooks]
        traf.delete_hooks = [h for h in traf.delete_hooks
                             if h not in dhooks]
        return True, f"Removed plugin {name}"

    # ---------------------------------------------------------- scheduling
    def min_dt(self):
        """Smallest hook interval of the active plugins (None if none):
        the Simulation clamps the device chunk to this."""
        dts = [f[1] for f in self.preupdate_funs.values()]
        dts += [f[1] for f in self.update_funs.values()]
        return min(dts) if dts else None

    def has_due(self, simt):
        """Any preupdate/update hook due at (or before) ``simt``?  The
        pipelined chunk loop asks this BEFORE dispatching: a due hook
        may read or mutate state, so its edge must run synchronously.
        Same epsilon as ``_run_due``."""
        return any(simt >= fun[0] - 1e-9
                   for funs in (self.preupdate_funs, self.update_funs)
                   for fun in funs.values())

    def _run_due(self, funs, simt):
        for fun in funs.values():
            if simt >= fun[0] - 1e-9:
                fun[0] += fun[1]
                # Catch up if more than one interval passed in a chunk
                if simt >= fun[0] - 1e-9:
                    fun[0] = simt + fun[1]
                fun[2]()

    def preupdate(self, simt):
        self._run_due(self.preupdate_funs, simt)

    def update(self, simt):
        self._run_due(self.update_funs, simt)

    def reset(self):
        """Reset trigger times + call plugin reset hooks (plugin.py:177-190)."""
        for fun in self.preupdate_funs.values():
            fun[0] = fun[1]
        for fun in self.update_funs.values():
            fun[0] = fun[1]
        for fun in self.reset_funs.values():
            fun()
