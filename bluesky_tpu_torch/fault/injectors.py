"""Chaos injectors: state poisoning, flaky transport, process faults.

Port of ``bluesky_tpu/fault/injectors.py``.  Each injector models ONE
fault class; the FAULT stack command (``harness.py``) binds them to a
running sim or worker, and the tests drive them directly.  All are
deterministic under a seeded RNG so chaos runs replay.  The state
injectors write into the port's state tensors in place (on the card
too: a CUDA tensor takes an indexed write like any other).
"""
import os
import signal
import threading
import time

import numpy as np


# --------------------------------------------------------- state poisoning
def inject_nonfinite(sim, acid=None, value=float("nan"), fields=None):
    """Poison guarded state fields of one aircraft with NaN/Inf.

    Models silent device-state corruption (bad wind data, a kernel bug,
    a bitflip): the value is written straight into the device state, so
    the ONLY thing that can catch it is the in-chunk integrity guard.
    Returns (slot, acid) of the poisoned aircraft.
    """
    traf = sim.traf
    traf.flush()
    if acid:
        slot = traf.id2idx(str(acid))
        if not isinstance(slot, int) or slot < 0:
            raise ValueError(f"{acid}: aircraft not found")
    else:
        live = [i for i, v in enumerate(traf.ids) if v is not None]
        if not live:
            raise ValueError("no aircraft to poison")
        slot = live[0]
    from ..core.step import GUARD_FIELDS
    fields = tuple(fields or GUARD_FIELDS[:1] + ("tas",))
    ac = traf.state.ac
    for f in fields:
        getattr(ac, f)[slot] = value
    return slot, traf.ids[slot]


def inject_bitflip(sim, which="state", acid=None, bit=2):
    """Flip ONE bit — the silent-data-corruption model.

    ``which='state'``: flip a low mantissa bit of one live aircraft's
    latitude IN the device state.  The value stays finite, so the
    in-scan integrity guard (``isfinite``) can never catch it — only
    the state-fingerprint comparison across redundant executions does.
    Returns ``(slot, acid, old, new)``.

    ``which='payload'``: corrupt the fingerprint ON THE WIRE — every
    shipped summary word is XORed with ``1 << bit`` until the next
    RESET, while the device state and fold stay untouched (the
    readback/transport-corruption model).  Returns the active mask.
    """
    bit = int(bit)
    if str(which).lower().startswith("payload"):
        sim._fp_corrupt_mask ^= (1 << (bit % 32)) & 0xFFFFFFFF
        return sim._fp_corrupt_mask
    traf = sim.traf
    traf.flush()
    if acid:
        slot = traf.id2idx(str(acid))
        if not isinstance(slot, int) or slot < 0:
            raise ValueError(f"{acid}: aircraft not found")
    else:
        live = [i for i, v in enumerate(traf.ids) if v is not None]
        if not live:
            raise ValueError("no aircraft to corrupt")
        slot = live[0]
    lat = traf.state.ac.lat
    old = float(lat[slot].item())
    width = lat.element_size()
    u = np.array([old], dtype={4: np.float32, 8: np.float64}[width])
    iv = u.view({4: np.uint32, 8: np.uint64}[width])
    iv[0] ^= np.asarray(1, iv.dtype) << np.asarray(
        bit % (8 * width), iv.dtype)
    new = float(u[0])
    lat[slot] = new
    return slot, traf.ids[slot], old, new


# --------------------------------------------------------- flaky transport
class FlakySocket:
    """Transport-fault wrapper over a ZMQ socket: drop / duplicate /
    delay outgoing multipart frames with seeded probabilities.

    Installed over a Node/Client event socket by ``FAULT DROP/DUP/
    DELAY``; everything except ``send_multipart`` delegates to the
    wrapped socket, so the endpoint code never knows.  Delayed frames
    are buffered and released by the next send (or an explicit
    ``flush``), modelling reordering-free late delivery.  Counters
    (``n_sent/n_dropped/n_duped/n_delayed``) make the chaos observable.
    """

    def __init__(self, sock, p_drop=0.0, p_dup=0.0, delay_s=0.0, seed=0,
                 drop_names=()):
        self._sock = sock
        self.p_drop = float(p_drop)
        self.p_dup = float(p_dup)
        self.delay_s = float(delay_s)
        # selective drop by event name (the network-partition model:
        # heartbeats lost, everything else delivered) — frame layout is
        # [route..., name, payload], so the name rides frames[-2]
        self.drop_names = tuple(drop_names)
        self._rng = np.random.default_rng(seed)
        self._held = []            # [(release_time, frames, kwargs)]
        self.n_sent = 0
        self.n_dropped = 0
        self.n_duped = 0
        self.n_delayed = 0
        self.n_name_dropped = 0

    def __getattr__(self, name):
        return getattr(self._sock, name)

    @property
    def wrapped(self):
        return self._sock

    def flush(self, force=False):
        """Release every held frame whose delay has expired (all of
        them with ``force`` — the uninstall path must not lose frames
        that were merely late)."""
        now = time.monotonic()
        due = [h for h in self._held if force or h[0] <= now]
        self._held = [] if force else [h for h in self._held
                                       if h[0] > now]
        for _, frames, kwargs in due:
            self._sock.send_multipart(frames, **kwargs)
            self.n_sent += 1

    def send_multipart(self, frames, **kwargs):
        self.flush()
        if self.drop_names:
            fl = list(frames)
            name = fl[-2] if len(fl) >= 2 else (fl[0] if fl else b"")
            if name in self.drop_names:
                self.n_name_dropped += 1
                return
        if self.p_drop > 0 and self._rng.random() < self.p_drop:
            self.n_dropped += 1
            return
        if self.delay_s > 0:
            self._held.append((time.monotonic() + self.delay_s,
                               list(frames), kwargs))
            self.n_delayed += 1
            return
        self._sock.send_multipart(frames, **kwargs)
        self.n_sent += 1
        if self.p_dup > 0 and self._rng.random() < self.p_dup:
            self._sock.send_multipart(frames, **kwargs)
            self.n_duped += 1


def install_flaky(endpoint, attr="event_io", **kw):
    """Wrap ``endpoint.<attr>`` in a FlakySocket (idempotent: re-wrapping
    updates the probabilities on the existing wrapper)."""
    sock = getattr(endpoint, attr)
    if isinstance(sock, FlakySocket):
        sock.p_drop = float(kw.get("p_drop", sock.p_drop))
        sock.p_dup = float(kw.get("p_dup", sock.p_dup))
        sock.delay_s = float(kw.get("delay_s", sock.delay_s))
        if "drop_names" in kw:
            sock.drop_names = tuple(kw["drop_names"])
        return sock
    flaky = FlakySocket(sock, **kw)
    setattr(endpoint, attr, flaky)
    return flaky


def partition(endpoint, names=(b"PONG",), attr="event_io"):
    """Heartbeat-only network partition (FAULT PARTITION): the worker
    stays alive and keeps computing, its completions and state changes
    still arrive, but its PING replies are silently dropped — the
    half-dead link the server cannot distinguish from a dead worker.
    ``names=()`` heals the partition (other flaky settings survive)."""
    return install_flaky(endpoint, attr=attr, drop_names=tuple(names))


def remove_flaky(endpoint, attr="event_io"):
    """Undo ``install_flaky``: flush ALL held frames (even not-yet-due
    ones — restoring the transport must not lose them), restore the
    raw socket."""
    sock = getattr(endpoint, attr)
    if isinstance(sock, FlakySocket):
        sock.delay_s = 0.0
        sock.flush(force=True)
        setattr(endpoint, attr, sock.wrapped)
        return True
    return False


# ----------------------------------------------------------- process faults
def kill_self():
    """SIGKILL the current process — the poison-pill / OOM-killer model.
    No goodbye, no linger: the server must detect the death via child
    exit / PING silence and requeue this worker's BATCH piece."""
    os.kill(os.getpid(), signal.SIGKILL)


def kill_server(pid, delay_s: float = 0.0):
    """SIGKILL the BROKER process after ``delay_s`` — the head-node
    loss model (broker HA, network/ha.py).  The pid comes from the
    server's REGISTER ack (node.server_pid).  No goodbye, no journal
    shutdown marker: the warm standby must notice via lease silence,
    take over the sweep journal-fenced, and surviving workers must
    re-discover and re-REGISTER with their in-flight pieces."""
    pid = int(pid)
    if delay_s and float(delay_s) > 0:
        t = threading.Timer(float(delay_s), os.kill,
                            args=(pid, signal.SIGKILL))
        t.daemon = True
        t.start()
        return t
    os.kill(pid, signal.SIGKILL)
    return None


def preempt(sim, delay_s: float = 0.0):
    """Deliver a preemption notice to this sim after ``delay_s`` —
    the SIGTERM-from-the-scheduler model (spot/preemptible capacity
    being reclaimed).  Raises ``sim.preempt_requested``; the owning
    node drains the in-flight chunk, writes a final checksummed
    checkpoint, notifies the server and exits cleanly
    (simulation/simnode._preempt_shutdown) — an embedded sim
    checkpoints and pauses.  A real out-of-process SIGTERM lands in
    the same path via the node's signal handler."""
    if delay_s and float(delay_s) > 0:
        t = threading.Timer(float(delay_s), sim.request_preempt)
        t.daemon = True
        t.start()
        return t
    sim.request_preempt()
    return None


def stall(seconds: float):
    """Block the calling thread — the stuck-event-loop model (GC pause,
    NFS hang, a runaway host callback).  The node watchdog
    (network/node.py) is the detector."""
    time.sleep(float(seconds))


def straggle(sim, factor: float = 0.0, stall_progress: bool = False,
             stall_s: float = 0.0):
    """The merely-slow / stuck-but-alive worker model (the dominant
    throughput killer in multi-GPU traffic simulation, arXiv:2406.08496
    load imbalance) — the fault class PING silence can NOT detect,
    because the event loop keeps running and heartbeats keep flowing.

    ``factor`` throttles the chunk loop (each sim second costs
    ``factor`` extra wall seconds), sinking this worker's progress
    rate below the fleet median.  ``stall_progress`` freezes progress
    outright (the chunk loop spins without advancing simt) — with
    ``stall_s`` set, a timer releases the stall after that long.  The
    server's progress-heartbeat straggler detector is the detector;
    speculative hedging is the response.  ``factor=0`` and
    ``stall_progress=False`` clears the fault.  Both settings survive
    sim RESET on purpose: they model host slowness, not scenario
    state."""
    sim.straggle_factor = max(0.0, float(factor))
    sim.straggle_stall = bool(stall_progress)
    sim._straggle_debt = 0.0       # a new injection starts clean
    # generation stamp: a timed stall's auto-clear must not fire into a
    # LATER straggle injection (re-issuing an indefinite stall while an
    # old timer is pending would otherwise end it early)
    gen = getattr(sim, "_straggle_gen", 0) + 1
    sim._straggle_gen = gen
    if stall_progress and stall_s and float(stall_s) > 0:
        def _clear():
            if getattr(sim, "_straggle_gen", 0) == gen:
                sim.straggle_stall = False
        t = threading.Timer(float(stall_s), _clear)
        t.daemon = True
        t.start()
        return t
    return None


_spike_seq = [0]                   # distinct piece content per injection


def load_spike(node, n, rate=0.0, tag="LS"):
    """Flood the server with ``n`` SYNTHETIC BATCH pieces — the
    queue-flood / thundering-herd model that drives the admission and
    load-shedding path (server-side mitigation is the response).

    Pieces are tiny self-draining sweeps (SCEN/CRE/FF/HOLD, like a real
    mini-sweep) submitted with ``synthetic: true``: the journal marks
    their ``queued`` records so replay's exactly-once accounting skips
    them — a resumed sweep is never owed load-spike noise.  Over-limit
    submissions come back as normal ``BATCHREJECTED`` refusals (echoed
    by the node), which is precisely the overload being modelled.

    ``rate`` pieces/second paces the flood with one submission per
    piece (``rate<=0``: one burst submission carrying all n).  Pacing
    sleeps on the calling thread — the injecting worker's event loop
    stalls for ``n/rate`` seconds, capped at 30 s — so keep paced
    spikes short; the burst mode costs nothing.

    Returns the number of pieces submitted."""
    _spike_seq[0] += 1
    nonce = f"{os.getpid():x}-{_spike_seq[0]:x}"
    n = max(1, int(n))
    rate = float(rate)

    def _piece(i):
        name = f"{tag}{nonce}-{i:04d}"
        return ([0.0, 0.0, 0.0, 60.0],
                [f"SCEN {name}",
                 f"CRE {name} B744 {40 + (i % 20)} 4 90 FL200 250",
                 "FF", "HOLD"])

    if rate <= 0:
        scentime, scencmd = [], []
        for i in range(n):
            t, c = _piece(i)
            scentime += t
            scencmd += c
        node.send_event(b"BATCH", {"scentime": scentime,
                                   "scencmd": scencmd,
                                   "synthetic": True})
        return n
    n = min(n, max(1, int(rate * 30.0)))   # cap the loop-stall at 30 s
    for i in range(n):
        t, c = _piece(i)
        node.send_event(b"BATCH", {"scentime": t, "scencmd": c,
                                   "synthetic": True})
        if i + 1 < n:
            time.sleep(1.0 / rate)
    return n


# ------------------------------------------------------------- file faults
def truncate_file(fname: str, keep_fraction: float = 0.5) -> int:
    """Truncate a file (snapshot, log) to a fraction of its size —
    the torn-write / disk-full model.  Returns the new size."""
    size = os.path.getsize(fname)
    new = int(size * float(keep_fraction))
    with open(fname, "r+b") as f:
        f.truncate(new)
    return new
