"""The FAULT stack command: chaos injection on a running sim/worker.

Port of ``bluesky_tpu/fault/harness.py``; every echo is JAX's text.

Usage (stack/commands.py registers it):

  FAULT                      status: guard, ring, transport faults, trips
  FAULT NAN [acid]           poison an aircraft's state with NaN
  FAULT INF [acid]           poison an aircraft's state with +Inf
  FAULT BITFLIP [STATE|PAYLOAD] [acid|bit]   flip ONE bit: STATE flips
                             a low mantissa bit of one aircraft's
                             latitude (stays finite — invisible to the
                             guard, caught ONLY by the SDC fingerprint
                             comparison); PAYLOAD corrupts the shipped
                             fingerprint word until RESET (wire model)
  FAULT GUARD ON/OFF         enable/disable the integrity guard
  FAULT GUARD QUARANTINE/ROLLBACK/HALT   set the recovery policy
  FAULT RING [depth] [dt]    report / configure the snapshot ring
  FAULT DROP p               drop outgoing event frames with prob p
  FAULT DUP p                duplicate outgoing event frames with prob p
  FAULT DELAY sec            delay outgoing event frames by sec
  FAULT NETOFF               remove transport faults
  FAULT STALL sec            stall this worker's event loop for sec
  FAULT STRAGGLE factor      throttle the chunk loop (factor extra
                             wall-s per sim-s): the merely-slow worker
  FAULT STRAGGLE STALL [sec] freeze progress (heartbeats keep flowing)
                             [for sec]; server-side hedging recovers
  FAULT STRAGGLE OFF         clear the straggle fault
  FAULT KILL                 SIGKILL this worker (no goodbye)
  FAULT KILLSERVER [delay]   SIGKILL the BROKER process [after delay s]
                             (head-node loss model): with broker HA
                             (network/ha.py) the warm standby takes the
                             lease over and the sweep continues; without
                             it, --resume-batch recovers at restart
  FAULT PREEMPT [delay]      preemption notice (SIGTERM model): drain
                             the chunk, checkpoint, notify, exit
  FAULT MESHKILL [group]     mark one device group of the active mesh
                             dead (host-loss model): the MeshGuard trips
                             mesh_lost at the next chunk dispatch and
                             the sim re-forms a survivor mesh
  FAULT PARTITION [OFF]      heartbeat-only network partition: PONGs
                             dropped, completions still delivered
  FAULT LOADSPIKE n [rate]   flood the server with n synthetic BATCH
                             pieces ([rate]/s; default one burst): the
                             queue-flood model — replay/exactly-once
                             accounting ignores the filler; admission
                             control + mitigation shedding respond
  FAULT SNAPTRUNC fname [keep]  truncate a snapshot file (torn write)
  FAULT LIST                 guard trip history

Transport faults need a networked worker (``sim.node``); on a detached
sim they return a command error instead of injecting nothing silently.
"""
from . import injectors


def _node(sim):
    """The sim's network endpoint, or None when there is no event
    socket to degrade (detached/embedded sims)."""
    node = getattr(sim, "node", None)
    return node if getattr(node, "event_io", None) is not None else None


def _status(sim):
    g = sim.guard
    lines = [f"guard: {'ON' if g.enabled else 'OFF'} "
             f"(policy {g.policy}), trips: {len(g.trips)}",
             f"ring: {len(sim.snap_ring)}/{sim.snap_ring.depth} "
             f"snapshots, dt={sim.snap_ring.dt:g} s"]
    node = _node(sim)
    sock = getattr(node, "event_io", None)
    if isinstance(sock, injectors.FlakySocket):
        lines.append(f"transport: drop={sock.p_drop:g} dup={sock.p_dup:g} "
                     f"delay={sock.delay_s:g}s (sent {sock.n_sent}, "
                     f"dropped {sock.n_dropped}, duped {sock.n_duped}, "
                     f"delayed {sock.n_delayed})")
    else:
        lines.append("transport: clean")
    if isinstance(sock, injectors.FlakySocket) and sock.drop_names:
        names = ",".join(n.decode("ascii", "replace")
                         for n in sock.drop_names)
        lines.append(f"partition: dropping [{names}] "
                     f"({sock.n_name_dropped} suppressed)")
    if getattr(sim, "straggle_stall", False):
        lines.append("straggle: STALLED (progress frozen)")
    elif getattr(sim, "straggle_factor", 0.0) > 0:
        lines.append(f"straggle: throttled +{sim.straggle_factor:g} "
                     f"wall s per sim s")
    mh = sim.mesh_health()
    if mh["mode"] != "off" or mh["epoch"] > 0:
        lines.append(f"mesh: epoch {mh['epoch']}, {mh['devices']} "
                     f"device(s), mode {mh['mode']}"
                     + (" [degraded]" if mh["degraded"] else ""))
    return True, "\n".join(lines)


def fault_command(sim, *args):
    if not args:
        return _status(sim)
    sub = str(args[0]).upper()
    rest = [str(a) for a in args[1:]]

    if sub in ("NAN", "INF"):
        value = float("nan") if sub == "NAN" else float("inf")
        try:
            slot, acid = injectors.inject_nonfinite(
                sim, rest[0] if rest else None, value)
        except ValueError as e:
            return False, str(e)
        return True, (f"FAULT: injected {sub} into {acid} (slot {slot}) — "
                      f"guard {'armed' if sim.guard.enabled else 'OFF'}")

    if sub == "BITFLIP":
        which = rest[0].upper() if rest else "STATE"
        if which == "PAYLOAD":
            try:
                bit = int(float(rest[1])) if len(rest) > 1 else 2
            except ValueError:
                return False, "FAULT BITFLIP PAYLOAD [bit]"
            mask = injectors.inject_bitflip(sim, "payload", bit=bit)
            return True, (f"FAULT: fingerprint wire corruption armed — "
                          f"shipped words XOR {mask:#010x} until RESET")
        acid = None
        if which == "STATE":
            acid = rest[1] if len(rest) > 1 else None
        else:
            acid = rest[0]         # FAULT BITFLIP <acid> shorthand
        try:
            slot, acid, old, new = injectors.inject_bitflip(
                sim, "state", acid=acid)
        except ValueError as e:
            return False, str(e)
        return True, (f"FAULT: flipped one mantissa bit of {acid} "
                      f"(slot {slot}) lat {old!r} -> {new!r} — finite, "
                      f"guard-invisible; only the SDC fingerprint "
                      f"comparison can catch it")

    if sub == "GUARD":
        if not rest:
            return True, (f"guard is {'ON' if sim.guard.enabled else 'OFF'}"
                          f" (policy {sim.guard.policy})")
        arg = rest[0].upper()
        if arg in ("ON", "TRUE", "1"):
            sim.guard.enabled = True
            return True, "guard ON"
        if arg in ("OFF", "FALSE", "0"):
            sim.guard.enabled = False
            return True, "guard OFF"
        if sim.guard.set_policy(arg):
            return True, f"guard policy {sim.guard.policy}"
        return False, "FAULT GUARD ON/OFF/QUARANTINE/ROLLBACK/HALT"

    if sub == "RING":
        ring = sim.snap_ring
        if rest:
            try:
                depth = int(float(rest[0]))
                if len(rest) > 1:
                    ring.dt = float(rest[1])
            except ValueError:
                return False, "FAULT RING [depth] [dt]"
            if depth != ring.depth:
                import collections
                ring.depth = max(1, depth)
                ring._ring = collections.deque(ring._ring,
                                               maxlen=ring.depth)
        ts = ", ".join(f"{t:.1f}" for t in ring.simts) or "-"
        return True, (f"ring: depth {ring.depth}, dt {ring.dt:g} s, "
                      f"held simt [{ts}]")

    if sub in ("DROP", "DUP", "DELAY"):
        node = _node(sim)
        if node is None:
            return False, f"FAULT {sub}: no network node (detached sim)"
        try:
            p = float(rest[0]) if rest else 0.0
        except ValueError:
            return False, f"FAULT {sub} value"
        kw = {"DROP": "p_drop", "DUP": "p_dup", "DELAY": "delay_s"}[sub]
        from .. import settings
        flaky = injectors.install_flaky(
            node, seed=int(getattr(settings, "fault_seed", 0)), **{kw: p})
        return True, (f"FAULT: event transport drop={flaky.p_drop:g} "
                      f"dup={flaky.p_dup:g} delay={flaky.delay_s:g}s")

    if sub in ("NETOFF", "OFF"):
        node = _node(sim)
        if node is not None and injectors.remove_flaky(node):
            return True, "FAULT: transport faults removed"
        return True, "FAULT: transport already clean"

    if sub == "STALL":
        try:
            sec = float(rest[0]) if rest else 1.0
        except ValueError:
            return False, "FAULT STALL seconds"
        injectors.stall(sec)
        return True, f"FAULT: stalled {sec:g} s"

    if sub == "STRAGGLE":
        arg = rest[0].upper() if rest else ""
        if arg in ("OFF", "0"):
            injectors.straggle(sim)
            return True, "FAULT: straggle cleared"
        if arg == "STALL":
            try:
                dur = float(rest[1]) if len(rest) > 1 else 0.0
            except ValueError:
                return False, "FAULT STRAGGLE STALL [seconds]"
            injectors.straggle(sim, stall_progress=True, stall_s=dur)
            return True, ("FAULT: progress stalled"
                          + (f" for {dur:g} s" if dur > 0 else "")
                          + " — heartbeats keep flowing; the server "
                            "hedges the piece after straggler_timeout")
        try:
            factor = float(arg) if arg else 1.0
        except ValueError:
            return False, "FAULT STRAGGLE factor | STALL [s] | OFF"
        injectors.straggle(sim, factor=factor)
        return True, (f"FAULT: chunk loop throttled — +{factor:g} wall "
                      f"s per sim s")

    if sub == "KILL":
        injectors.kill_self()          # no return: SIGKILL

    if sub == "KILLSERVER":
        node = _node(sim)
        pid = getattr(node, "server_pid", None)
        if not pid:
            return False, ("FAULT KILLSERVER: no broker pid known "
                           "(detached sim, or the server predates the "
                           "pid-carrying REGISTER ack)")
        try:
            delay = float(rest[0]) if rest else 0.0
        except ValueError:
            return False, "FAULT KILLSERVER [delay_s]"
        injectors.kill_server(pid, delay)
        return True, (f"FAULT: SIGKILL broker pid {pid}"
                      + (f" in {delay:g} s" if delay > 0 else "")
                      + " — the WAL is append-only, so a warm standby "
                        "(or --resume-batch) recovers the sweep "
                        "exactly-once")

    if sub == "PREEMPT":
        try:
            delay = float(rest[0]) if rest else 0.0
        except ValueError:
            return False, "FAULT PREEMPT [delay_s]"
        injectors.preempt(sim, delay)
        return True, (f"FAULT: preemption notice"
                      + (f" in {delay:g} s" if delay > 0 else "")
                      + " — the node will drain the current chunk, "
                        "write a final checkpoint and exit")

    if sub == "MESHKILL":
        if sim.shard_mode == "off" or sim.shard_mesh is None:
            return False, "FAULT MESHKILL: no active mesh (SHARD first)"
        try:
            group = int(float(rest[0])) if rest else 1
        except ValueError:
            return False, "FAULT MESHKILL [group]"
        try:
            devs = sim.mesh_guard.kill_group(group)
        except ValueError as e:
            return False, f"FAULT MESHKILL: {e}"
        return True, (f"FAULT: device group {group} ({len(devs)} "
                      f"device(s)) marked dead — mesh_lost trips at "
                      f"the next chunk dispatch")

    if sub == "PARTITION":
        node = _node(sim)
        if node is None:
            return False, "FAULT PARTITION: no network node (detached sim)"
        if rest and rest[0].upper() in ("OFF", "0"):
            injectors.partition(node, names=())
            return True, "FAULT: partition healed (heartbeats flowing)"
        flaky = injectors.partition(node)
        names = ",".join(n.decode("ascii", "replace")
                         for n in flaky.drop_names)
        return True, (f"FAULT: network partition — dropping [{names}]; "
                      f"worker alive, completions still delivered")

    if sub == "LOADSPIKE":
        node = _node(sim)
        if node is None:
            return False, "FAULT LOADSPIKE: no network node (detached sim)"
        try:
            n = int(float(rest[0])) if rest else 16
            rate = float(rest[1]) if len(rest) > 1 else 0.0
        except ValueError:
            return False, "FAULT LOADSPIKE n [rate]"
        sent = injectors.load_spike(node, n, rate)
        return True, (f"FAULT: load spike — {sent} synthetic piece(s) "
                      + (f"at {rate:g}/s" if rate > 0 else "in one burst")
                      + "; over-limit submissions bounce as BATCHREJECTED")

    if sub == "SNAPTRUNC":
        if not rest:
            return False, "FAULT SNAPTRUNC filename [keep_fraction]"
        import os
        fname = rest[0]
        if not fname.lower().endswith(".snap"):
            fname += ".snap"
        if not os.path.isfile(fname):
            return False, f"{fname}: not found"
        keep = float(rest[1]) if len(rest) > 1 else 0.5
        size = injectors.truncate_file(fname, keep)
        return True, f"FAULT: truncated {fname} to {size} bytes"

    if sub == "LIST":
        if not sim.guard.trips:
            return True, "no guard trips"
        return True, "\n".join(
            f"simt {t['simt']:.2f}: step {t['bad_step']}/{t['chunk']} "
            f"{t['action']} [{','.join(t['ids']) or '-'}]"
            for t in sim.guard.trips)

    return False, ("FAULT NAN/INF [acid] | BITFLIP [STATE|PAYLOAD] | "
                   "GUARD .. | RING .. | DROP/DUP/"
                   "DELAY p | NETOFF | STALL s | STRAGGLE f/STALL/OFF | "
                   "KILL | KILLSERVER [s] | PREEMPT [s] | MESHKILL [g] "
                   "| PARTITION [OFF] | "
                   "LOADSPIKE n [rate] | SNAPTRUNC f | LIST")
