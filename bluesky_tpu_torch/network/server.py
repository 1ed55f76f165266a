"""Broker + worker manager (port of ``bluesky_tpu/network/server.py``;
parity: bluesky/network/server.py:26-317).

Four sockets: client-facing ROUTER (events) + XPUB (streams), worker-facing
ROUTER (events) + XSUB (streams).  Streams pass through XSUB->XPUB;
subscription messages flow back XPUB->XSUB.  Events are source-routed
multipart ``[*route, name, payload]`` (see node.split_envelope): on each
forward the server pops the first route frame as the next-hop destination
and appends the arrival sender id to the tail, so the frames a receiver
sees are exactly the return route for its reply.  ``b'*'`` fans out to all
workers.

Server-directed events (empty route): REGISTER, ADDNODES, BATCH, QUIT,
STATECHANGE, PONG.  BATCH splits a multi-SCEN scenario and farms the
pieces out to idle workers, spawning more (up to max_nnodes) as needed —
the reference's scenario-ensemble parallelism (§2.10).  Spawned workers
are ``python -m bluesky_tpu_torch --sim`` processes; each gets the
server's ``--config-file``, so the server's device policy
(``settings.device``) is theirs too.

Hardening beyond the reference:
* **Worker liveness**: spawned workers get their id assigned
  (``--node-id``) so a dead child process maps straight back to its
  registration; external workers are probed with PING/PONG.  A dead
  worker's in-flight BATCH piece is requeued and a replacement is
  spawned — kill -9 a worker mid-batch and the batch still completes.
* **Durable BATCH sweeps** (docs/FAULT_TOLERANCE.md): every piece
  transition (queued/dispatched/completed/crashed/quarantined/
  preempted) is appended to a JSONL write-ahead journal
  (network/journal.py); ``--resume-batch <journal>`` replays it after a
  server crash or preemption to rebuild the queue with exactly-once
  completion semantics.  A ``PREEMPTED`` notice from a draining worker
  requeues its piece without a circuit-breaker strike, and
  ``BATCHQUARANTINE`` reports are replayed to late-joining clients.
* **Overload/straggler serving layer** (docs/FAULT_TOLERANCE.md rows
  #10/#11): workers piggyback per-piece progress (simt, chunks done)
  on their PONG replies; an in-flight piece whose progress stalls past
  ``straggler_timeout`` — or whose rate falls far below the fleet
  median — while heartbeats stay fresh is *hedged*: a second copy goes
  to an idle worker, first completion wins, the loser is cancelled
  (``BATCHCANCEL``), and the journal records ``hedged``/
  ``dup_completed`` so exactly-once survives a crash mid-hedge.
  Admission control bounds the pending queue (``batch_queue_max``,
  over-limit submissions get a structured ``BATCHREJECTED``), dispatch
  is round-robin per submitting client (one heavy client cannot starve
  the rest), the stream path is bounded (SNDHWM + drop counter) so a
  stalled GUI cannot back-pressure the broker, and ``HEALTH`` returns
  the whole picture machine-readably.
* **Server-to-server chaining** (reference server.py:213-225): a server
  started with ``upstream=(host, port)`` registers at another server's
  client port, mirrors that server's node table to its own clients
  (NODESCHANGED merge), and routes events for remote nodes over the
  link.  Multi-hop replies work because reply routes are the REVERSED
  accumulated sender tail (single-hop routes are palindromes, so the
  flat fabric is unaffected).
"""
import collections
import os
import statistics
import subprocess
import sys
import threading
import time

import zmq

from .common import DEFAULT_PORTS, make_id
from .discovery import Discovery
from .node import split_envelope
from .npcodec import packb, unpackb


def split_scenarios(scentime, scencmd):
    """Split a scenario command list into per-SCEN chunks
    (parity: server.py:26-32)."""
    starts = [i for i, cmd in enumerate(scencmd)
              if cmd.strip().upper().startswith("SCEN")]
    if not starts:
        return [(list(scentime), list(scencmd))] if scencmd else []
    # commands before the first SCEN are global setup: prepend to each piece
    pre_t, pre_c = scentime[:starts[0]], scencmd[:starts[0]]
    bounds = starts + [len(scencmd)]
    return [(pre_t + scentime[a:b], pre_c + scencmd[a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


class FairQueue:
    """Per-client round-robin queue of pending BATCH pieces.

    One flood-submitting client must not starve the others, so pieces
    are held in per-owner sub-queues and ``pop_next`` serves owners in
    rotation.  The *read* surface stays list-like (``len``/``bool``/
    ``iter``/``[i]`` over the flattened drain order) because operators,
    tests and the journal-replay path all inspect the queue like the
    plain list it replaces; mutation goes through ``push``/
    ``push_front``/``extend`` so every piece keeps its owner.
    """

    def __init__(self):
        self._queues = {}                  # owner -> deque of pieces
        self._rr = collections.deque()     # owner service rotation
        # queue-wait bookkeeping (docs/OBSERVABILITY.md): admission
        # stamp per piece object, read off at pop.  Keyed by id() —
        # the same list pair flows from push to dispatch unchanged.
        self._enq_t = {}                   # id(piece) -> monotonic stamp
        self.last_wait_s = None            # wait of the last pop_next

    def _ensure(self, owner):
        q = self._queues.get(owner)
        if q is None:
            q = self._queues[owner] = collections.deque()
            self._rr.append(owner)
        return q

    def push(self, piece, owner=b""):
        self._ensure(owner).append(piece)
        self._enq_t[id(piece)] = time.monotonic()

    def push_front(self, piece, owner=b""):
        """Requeue (crash/preempt/resume): the piece goes back to the
        FRONT of its owner's sub-queue, keeping sweep order."""
        self._ensure(owner).appendleft(piece)
        self._enq_t[id(piece)] = time.monotonic()

    def extend(self, pieces, owner=b""):
        self._ensure(owner).extend(pieces)
        now = time.monotonic()
        for p in pieces:
            self._enq_t[id(p)] = now

    def pop_next(self):
        """``(owner, piece)`` from the next owner in rotation with work
        pending, or ``None``.  The served owner moves to the back."""
        for _ in range(len(self._rr)):
            owner = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues.get(owner)
            if q:
                piece = q.popleft()
                t0 = self._enq_t.pop(id(piece), None)
                self.last_wait_s = (None if t0 is None
                                    else time.monotonic() - t0)
                return owner, piece
        return None

    def depth_by_owner(self):
        return {o: len(q) for o, q in self._queues.items() if q}

    def _flat(self):
        """Flattened round-robin drain order (what pop_next would
        yield), starting from the current rotation head.  Index
        pointers keep this O(total) — observers poll it."""
        qs = {o: list(q) for o, q in self._queues.items() if q}
        order = [o for o in self._rr if o in qs]
        idx = dict.fromkeys(order, 0)
        out = []
        remaining = sum(len(q) for q in qs.values())
        while remaining:
            for o in order:
                i = idx[o]
                if i < len(qs[o]):
                    out.append(qs[o][i])
                    idx[o] = i + 1
                    remaining -= 1
        return out

    def __len__(self):
        return sum(len(q) for q in self._queues.values())

    def __bool__(self):
        return any(self._queues.values())

    def __iter__(self):
        return iter(self._flat())

    def __getitem__(self, i):
        return self._flat()[i]


class WorldPack:
    """A packed world-batch assignment: n compatible BATCH pieces in
    flight on ONE worker, stepped there as a single stacked device
    program (simulation/worlds.py).  The server tracks per-world
    completion (``done``: world index -> status) from the worker's
    ``BATCHWORLD`` events so demux back to the individual pieces is
    exactly-once — a crash mid-pack requeues only the worlds whose
    pieces never completed."""

    def __init__(self, picks):
        self.owners = [o for o, _ in picks]
        self.pieces = [p for _, p in picks]
        self.done = {}                     # world index -> status str

    def __len__(self):
        return len(self.pieces)

    def remaining(self):
        """(world, owner, piece) for every world not yet demuxed."""
        return [(i, self.owners[i], self.pieces[i])
                for i in range(len(self.pieces)) if i not in self.done]


def _obs_counter(name, help=""):
    """Registry-backed broker counter exposed as a plain int attribute:
    reads stay ints (tests/operators compare with ``==``), writes
    (``+= 1``) land in ``self.obs`` so METRICS DUMP, the Prometheus
    export and HEALTH all read ONE source of truth."""
    def fget(self):
        return int(self.obs.counter(name, help=help).value)

    def fset(self, v):
        self.obs.counter(name, help=help)._set(v)
    return property(fget, fset)


class Server(threading.Thread):
    """Runs the broker loop in a thread (reference: Server(Thread))."""

    # broker counters, backed by the server metrics registry
    packed_pieces = _obs_counter(
        "server_packed_pieces", "pieces dispatched inside world-packs")
    world_batches = _obs_counter(
        "server_world_batches", "packed world-batch dispatches sent")
    worlds_refused_spatial = _obs_counter(
        "server_worlds_refused_spatial",
        "spatial-shard pieces kept out of packs")
    worlds_refused_opt = _obs_counter(
        "server_worlds_refused_opt", "OPT/GRAD pieces kept out of packs")
    worlds_failed = _obs_counter(
        "server_worlds_failed", "per-world failure reports")
    hedges_started = _obs_counter(
        "server_hedges_started", "speculative straggler re-dispatches")
    hedges_won_hedge = _obs_counter(
        "server_hedges_won_hedge", "hedge copy finished first")
    hedges_won_primary = _obs_counter(
        "server_hedges_won_primary", "primary recovered and won")
    hedges_cancelled = _obs_counter(
        "server_hedges_cancelled", "hedge losers that acked the cancel")
    dup_completions = _obs_counter(
        "server_dup_completions", "hedge losers that finished anyway")
    rejected_batches = _obs_counter(
        "server_rejected_batches", "BATCHREJECTED admission refusals")
    opt_results = _obs_counter(
        "server_opt_results", "OPTRESULT reports journaled")
    stream_drops = _obs_counter(
        "server_stream_drops", "stream frames dropped at SNDHWM")
    perf_regressions = _obs_counter(
        "server_perf_regressions",
        "serving SLO-watch perf_regression records journaled")
    sdc_suspects = _obs_counter(
        "server_sdc_suspects",
        "fingerprint mismatches journaled (sdc_suspect)")
    sdc_votes = _obs_counter(
        "server_sdc_votes", "2-of-3 re-execution votes resolved")
    sdc_audits = _obs_counter(
        "server_sdc_audits", "shadow audit re-executions dispatched")
    sdc_quarantined_workers = _obs_counter(
        "server_sdc_quarantined_workers",
        "workers quarantined by the SDC fingerprint vote")

    def __init__(self, headless=False, discoverable=False,
                 ports=None, max_nnodes=None, spawn_workers=True,
                 upstream=None, hb_interval=2.0, hb_timeout=30.0,
                 restart_crashed=True, max_piece_crashes=None,
                 journal_path=None, resume_journal=None,
                 straggler_timeout=None, hedge_enabled=None,
                 batch_queue_max=None, world_pack=None,
                 world_batch_max=None, mitigate_enabled=None,
                 sdc_enabled=None, sdc_audit_rate=None,
                 ha_role=None, ha_lease_ttl=None, ha_poll_dt=None,
                 ha_fence_strict=None):
        super().__init__(daemon=True)
        # Observability (docs/OBSERVABILITY.md): the broker's
        # own registry (counters above, demux/queue series below), the
        # FLEET registry that heartbeat metric deltas from every worker
        # merge into, and the per-process flight recorder.
        from ..obs.metrics import (DEFAULT_S_BUCKETS, Registry)
        from ..obs.trace import get_recorder
        self.obs = Registry()
        self.fleet = Registry()
        self.recorder = get_recorder()
        self.obs.histogram(
            "server_demux_ms",
            help="world-pack demux (BATCHWORLD/retirement) host ms")
        self.obs.histogram(
            "server_queue_wait_s", buckets=DEFAULT_S_BUCKETS,
            help="piece admission -> dispatch queue wait")
        self.obs.gauge("server_queue_depth",
                       help="pending BATCH pieces")
        self.server_id = make_id()
        self.headless = headless
        self.ports = dict(DEFAULT_PORTS, **(ports or {}))
        self.max_nnodes = max_nnodes or min(os.cpu_count() or 1, 8)
        self.spawn_workers = spawn_workers
        self.running = False
        self._stop_requested = False
        self.clients = []                  # connected client ids
        self.workers = {}                  # worker_id -> state int
        self.avail_workers = []            # idle worker ids (for BATCH)
        self.scenarios = FairQueue()       # pending BATCH pieces,
        #                                    round-robin per client
        self.processes = []                # spawned worker Popen handles
        self._pending_spawns = 0           # spawned but not yet REGISTERed
        # ----- liveness / restart
        self.hb_interval = hb_interval
        self.hb_timeout = hb_timeout
        self.restart_crashed = restart_crashed
        self.spawned = {}                  # worker_id -> Popen
        self.inflight = {}                 # worker_id -> BATCH piece
        self.inflight_owner = {}           # worker_id -> submitting client
        self.inflight_t = {}               # worker_id -> dispatch stamp
        self.last_seen = {}                # worker_id -> monotonic stamp
        self._next_hb = 0.0
        # ----- per-scenario circuit breaker: a piece that loses its
        # worker K consecutive times is poison (NaN bomb, OOM bait,
        # FAULT KILL) — quarantine + report it instead of requeueing it
        # into a crash loop that eats the whole worker pool forever.
        from .. import settings as _settings
        self.max_piece_crashes = max_piece_crashes \
            if max_piece_crashes is not None \
            else getattr(_settings, "batch_max_crashes", 3)
        self.piece_crashes = {}            # piece key -> consecutive losses
        self.quarantined = []              # circuit-broken pieces
        # BATCHQUARANTINE payloads replayed to late-joining clients on
        # REGISTER — capped so a long-lived server does not replay
        # unbounded quarantine history to every reattaching operator
        self.quarantine_reports = collections.deque(
            maxlen=max(1, int(getattr(_settings,
                                      "quarantine_report_cap", 64))))
        # ----- overload / straggler layer (docs/FAULT_TOLERANCE.md
        # rows #10/#11): per-worker progress from heartbeat PONGs,
        # speculative hedges, admission control + drop counters
        self.straggler_timeout = straggler_timeout \
            if straggler_timeout is not None \
            else getattr(_settings, "straggler_timeout", 30.0)
        self.hedge_enabled = hedge_enabled if hedge_enabled is not None \
            else getattr(_settings, "hedge_enabled", True)
        self.hedge_rate_factor = getattr(_settings,
                                         "hedge_rate_factor", 0.2)
        # serving SLO watch: journal a perf_regression audit
        # record when an in-flight piece's rolling rate drops below
        # perf_slo_factor x the fleet median (0 = off).  Deliberately
        # separate from hedging: the hedge MITIGATES, the SLO record
        # EXPLAINS — and it fires even with hedging off or no idle
        # worker to hedge onto.
        self.perf_slo_factor = float(getattr(_settings,
                                             "perf_slo_factor", 0.0))
        self._slo_flagged = set()          # (wid, piece key) journaled
        self._slo_recent = collections.deque(maxlen=8)
        self._slo_median = None            # last fleet-median FF rate
        self.batch_queue_max = batch_queue_max \
            if batch_queue_max is not None \
            else getattr(_settings, "batch_queue_max", 4096)
        self.hb_busy_multiplier = getattr(_settings,
                                          "hb_busy_multiplier", 10.0)
        # ----- multi-world packing (docs/PERF_ANALYSIS.md §multi-world):
        # compatible BATCH pieces are packed into world-batches — one
        # worker steps W scenarios per device dispatch — and demuxed
        # back per piece.  WORLDS stack/client command flips at runtime.
        self.world_pack = world_pack if world_pack is not None \
            else bool(getattr(_settings, "world_pack", False))
        self.world_batch_max = world_batch_max \
            if world_batch_max is not None \
            else int(getattr(_settings, "world_batch_max", 8))
        self.packed_pieces = 0             # pieces dispatched inside packs
        self.world_batches = 0             # packed dispatches sent
        self._pack_fill_sum = 0.0          # sum of per-dispatch fill
        self.worlds_refused_spatial = 0    # spatial pieces kept out of packs
        self.worlds_refused_opt = 0        # OPT/GRAD pieces kept out of packs
        self.worlds_failed = 0             # per-world failure reports
        self.worker_progress = {}          # wid -> {simt, chunks, rate,
        #                                    t (last report), advance_t}
        self.hedge_by = {}                 # primary wid -> hedge wid
        self.hedge_of = {}                 # hedge wid -> primary wid
        self._cancel_pending = {}          # cancelled loser wid -> piece
        self.hedges_started = 0
        self.hedges_won_hedge = 0          # hedge copy finished first
        self.hedges_won_primary = 0        # primary recovered and won
        self.hedges_cancelled = 0          # losers that acked the cancel
        self.dup_completions = 0           # losers that finished anyway
        self.rejected_batches = 0          # BATCHREJECTED sent
        self.opt_results = 0               # OPTRESULT reports journaled
        self.stream_drops = 0              # stream frames dropped at HWM
        self.perf_regressions = 0          # SLO-watch records journaled
        self._completion_stamps = collections.deque(maxlen=64)
        # ----- durable BATCH state: append-only JSONL journal (WAL)
        # replayed on restart (--resume-batch).  journal_path=None ->
        # settings-derived default (<log_path>/batch-<serverid>.jsonl,
        # or the resume journal itself so chained resumes keep one
        # file); journal_path="" disables journaling.  The file is only
        # created when the first BATCH record is appended.
        from .journal import BatchJournal
        self.resume_journal = resume_journal or None
        if journal_path is None:
            journal_path = self.resume_journal or os.path.join(
                getattr(_settings, "log_path", "output"),
                f"batch-{self.server_id.hex()}.jsonl")
        self.journal = BatchJournal(
            journal_path,
            fsync=getattr(_settings, "batch_journal_fsync", True)) \
            if journal_path else None
        # ----- broker high availability (network/ha.py):
        # warm-standby failover with journal-fenced leadership.  With
        # ha_role=None (and settings.ha_standby unset) every HA branch
        # is inert — no lease records, no wepoch stamping, no HA
        # HEALTH section: bit-identical to a build without HA.
        from . import ha as _ha
        if ha_role is None and bool(getattr(_settings, "ha_standby",
                                            False)):
            ha_role = "standby"
        self.ha_role = ha_role             # None | "leader" | "standby"
        self.ha_lease_ttl = float(
            getattr(_settings, "ha_lease_ttl", 10.0)
            if ha_lease_ttl is None else ha_lease_ttl)
        self.ha_poll_dt = float(
            getattr(_settings, "ha_poll_dt", 1.0)
            if ha_poll_dt is None else ha_poll_dt)
        self.ha_fence_strict = bool(
            getattr(_settings, "ha_fence_strict", True)
            if ha_fence_strict is None else ha_fence_strict)
        if self.ha_role and self.journal is None:
            # the journal IS the shared truth the standby tails — HA
            # without one has nothing to fence or replay
            print("server: HA needs a BATCH journal "
                  "(journal_path='' disables both) — HA disabled")
            self.ha_role = None
        self.ha_epoch = 0                  # lease epoch held/last seen
        self._ha_serving = self.ha_role != "standby"  # dispatch gate
        self._ha_lease_file = _ha.lease_path(self.journal.path) \
            if self.ha_role else None
        self._ha_tail = _ha.JournalTail(self.journal.path) \
            if self.ha_role == "standby" else None
        self._ha_limbo = []                # replayed owed pieces held
        #                                    for adoption during grace
        self._ha_pieces = {}               # content key -> piece (replay)
        self._ha_completed = {}            # content key -> completions
        self._ha_grace_until = 0.0         # adoption window end (mono)
        self._ha_next_renew = 0.0          # leader lease-renew stamp
        self._ha_next_poll = 0.0           # standby poll stamp
        self._ha_stale_since = None        # first sighting of a missing
        #                                    lease file (standby)
        self.ha_takeovers = 0              # leases this server acquired
        #                                    by succession
        self.ha_adoptions = 0              # pieces adopted in place
        self.ha_dedup_cancels = 0          # raced completions cancelled
        # ----- self-healing serving (network/mitigate.py): the policy
        # engine that turns sentinel flags into journaled actions.
        # Disabled (default) it is completely inert — journal and
        # HEALTH output stay bit-identical to a build without it.
        from .mitigate import MitigationEngine
        self.mitigator = MitigationEngine(self,
                                          enabled=mitigate_enabled)
        # ----- silent-data-corruption defense
        # (docs/FAULT_TOLERANCE.md §SDC): workers running with
        # SimConfig.fingerprint ship a per-piece state fingerprint on
        # completion (SDCFP precedes the STATECHANGE on the FIFO pair).
        # Redundant executions of the same content — hedge duplicates,
        # sampled shadow audits — must agree bit-for-bit; a mismatch
        # journals an audit-only ``sdc_suspect`` and triggers a third
        # re-execution whose 2-of-3 majority names the deviant worker
        # (``sdc_vote``), which the mitigation engine then quarantines
        # (its own gated ``mitigation`` record).
        self.sdc_enabled = bool(getattr(_settings, "sdc_enabled",
                                        False)) \
            if sdc_enabled is None else bool(sdc_enabled)
        self.sdc_audit_rate = float(
            getattr(_settings, "sdc_audit_rate", 0.0)
            if sdc_audit_rate is None else sdc_audit_rate)
        self._sdc_fps = collections.OrderedDict()  # piece key ->
        #                                            {wid hex: fp word}
        self._sdc_execs = {}               # wid -> {kind, key, piece}
        self._sdc_voted = set()            # keys with a vote placed
        self.sdc_quarantine = set()        # voted-deviant worker ids
        self.sdc_suspects = 0              # sdc_suspect records
        self.sdc_votes = 0                 # sdc_vote records
        self.sdc_audits = 0                # shadow audits dispatched
        self.sdc_quarantined_workers = 0   # workers quarantined
        self._audit_acc = 0.0              # deterministic sampling accum
        # journal growth watch: the WAL of an
        # unbounded sweep must warn before it fills the disk
        self.journal_warn_bytes = int(getattr(_settings,
                                              "journal_warn_bytes",
                                              64 * 1024 * 1024))
        self.obs.gauge("server_journal_bytes",
                       help="BATCH journal (WAL) size on disk")
        # ----- server-to-server chaining
        self.upstream = upstream           # (host, event_port) or None
        self.link = None                   # DEALER to the upstream server
        self.link_id = b""                 # upstream host id (after ack)
        self.remote_nodes = {}             # node_id -> upstream host id
        self.discovery = Discovery(self.server_id, is_client=False,
                                   port=self.ports["discovery"]) \
            if discoverable else None
        ctx = zmq.Context.instance()
        self.fe_event = ctx.socket(zmq.ROUTER)
        self.fe_stream = ctx.socket(zmq.XPUB)
        self.be_event = ctx.socket(zmq.ROUTER)
        self.be_stream = ctx.socket(zmq.XSUB)
        # event sockets get a short linger so final QUIT/NODESCHANGED sends
        # flush before close; stream sockets can drop in-flight data
        self.fe_event.setsockopt(zmq.LINGER, 500)
        self.be_event.setsockopt(zmq.LINGER, 500)
        self.fe_stream.setsockopt(zmq.LINGER, 0)
        self.be_stream.setsockopt(zmq.LINGER, 0)
        # Bounded stream buffering (row #11): SNDHWM caps the per-
        # subscriber queue, and XPUB_NODROP turns an over-HWM send into
        # EAGAIN instead of a silent per-peer drop — the forward loop
        # then drops the frame itself and COUNTS it (stream_drops), so
        # a stalled GUI client costs observable drops, never broker
        # back-pressure or unbounded memory.
        self.fe_stream.setsockopt(
            zmq.SNDHWM, int(getattr(_settings, "stream_sndhwm", 1000)))
        self.fe_stream.setsockopt(zmq.XPUB_NODROP, 1)

    # ----------------------------------------------------------- lifecycle
    def addnodes(self, count=1):
        """Spawn sim worker processes (parity: server.py:62-67).

        The worker id is assigned HERE and passed down (--node-id) so a
        child that dies without a goodbye (kill -9, OOM) maps straight
        back to its registration for requeue + restart.

        Port: the workers are ``bluesky_tpu_torch`` processes, and the
        server's config file (``settings.config_file``) goes down with
        ``--config-file``, so they run on the server's ``device``: a
        server configured with ``device = 'cpu'`` spawns CPU workers,
        one without the key spawns CUDA workers (which exit non-zero
        where there is no card, and are then reaped as crashed)."""
        if not self.spawn_workers:
            return
        from .. import settings as _settings
        cfg = getattr(_settings, "config_file", "")
        for _ in range(count):
            self._pending_spawns += 1
            wid = make_id()
            proc = subprocess.Popen(
                [sys.executable, "-m", "bluesky_tpu_torch", "--sim",
                 "--event-port", str(self.ports["wevent"]),
                 "--stream-port", str(self.ports["wstream"]),
                 "--node-id", wid.hex()]
                + (["--config-file", cfg] if cfg else []))
            self.processes.append(proc)
            self.spawned[wid] = proc

    def _spawn_for_backlog(self, count=None):
        """Spawn up to ``count`` workers (default: one per queued BATCH
        piece), capped by the max_nnodes headroom — the ONE place the
        headroom formula lives, so every requeue/replay/reap path
        spawns consistently."""
        headroom = self.max_nnodes - len(self.workers) \
            - self._pending_spawns
        n = max(0, min(len(self.scenarios) if count is None else count,
                       headroom))
        if n > 0:
            self.addnodes(n)

    def stop(self):
        self._stop_requested = True
        self.running = False

    # ------------------------------------------------------------- routing
    def _forward(self, sender, route, name, payload):
        """Pop next hop, append sender to the return tail, send."""
        if route and route[0] == b"*":
            # Fan out to every endpoint except the sender (stack.py's
            # b'*' semantics, server.py:302-307): workers AND clients.
            for wid in self.workers:
                if wid != sender:
                    self.be_event.send_multipart(
                        [wid, sender, name, payload])
            for cid in self.clients:
                if cid != sender:
                    self.fe_event.send_multipart(
                        [cid, sender, name, payload])
            return
        dest = route[0]
        tail = list(route[1:]) + [sender]
        if dest in self.workers:
            sock = self.be_event
        elif self.link is not None and (dest in self.remote_nodes
                                        or dest == self.link_id):
            # chained node: hop over the upstream link (the DEALER's own
            # identity is the implicit sender frame on the other side)
            self.link.send_multipart([dest] + tail + [name, payload])
            return
        else:
            sock = self.fe_event
        sock.send_multipart([dest] + tail + [name, payload])

    # --------------------------------------------------- circuit breaker
    @staticmethod
    def _piece_key(piece):
        scentime, scencmd = piece
        return (tuple(scentime), tuple(scencmd))

    @staticmethod
    def _piece_name(piece):
        if isinstance(piece, WorldPack):
            return (f"worlds[{len(piece.done)}/{len(piece)} done: "
                    + ", ".join(Server._piece_name(p)
                                for p in piece.pieces[:4])
                    + (", ..." if len(piece) > 4 else "") + "]")
        for cmd in piece[1]:
            c = cmd.strip()
            if c.upper().startswith("SCEN"):
                parts = c.split(None, 1)
                return parts[1] if len(parts) > 1 else c
        return f"<{len(piece[1])}-command piece>"

    @staticmethod
    def _piece_spatial(piece):
        """Does this piece request the spatial shard mode?  Spatial
        stripes are a per-world layout property and compose with the
        world axis later, not now — packing refuses such pieces with a
        structured echo (WORLDSREFUSED) and dispatches them solo."""
        return any("SHARD" in c.upper() and "SPATIAL" in c.upper()
                   for c in piece[1])

    @staticmethod
    def _piece_solo_reason(piece):
        """Reason string when a piece must dispatch UNPACKED, or None.

        * ``shard_mode=spatial`` — stripes compose with the world axis
          later, not now;
        * ``opt`` — an OPT piece's result event (``OPTRESULT``) and its
          journal record need the worker's own event socket, which the
          world sims of a packed assignment do not have; the optimizer
          already batches its multi-start particles on the world axis
          INTERNALLY (diff/optimize.py), so packing it again wins
          nothing.
        """
        if Server._piece_spatial(piece):
            return "shard_mode=spatial"
        for c in piece[1]:
            head = c.strip().upper().replace(",", " ").split(None, 1)
            if head and head[0] in ("OPT", "GRAD"):
                return "opt"
        return None

    def _report_clients(self, text, name=b"ECHO", data=None):
        """Fan a server-originated event out to every connected client
        (ECHO payload format matches ScreenIO's)."""
        payload = packb(data if data is not None
                        else {"text": text, "flags": 0})
        for cid in self.clients:
            self.fe_event.send_multipart([cid, name, payload])

    def _drop_hedge_links(self, wid):
        """Dissolve any hedge pairing ``wid`` is part of; returns the
        partner id if the partner is STILL running the piece (so the
        piece is not actually lost), else None."""
        partner = self.hedge_by.pop(wid, None)
        if partner is None:
            partner = self.hedge_of.pop(wid, None)
            self.hedge_by.pop(partner, None)
        else:
            self.hedge_of.pop(partner, None)
        return partner if partner is not None \
            and partner in self.inflight else None

    def _requeue_lost_piece(self, wid):
        """A worker was lost with a BATCH piece in flight: requeue the
        piece — unless it has now taken down a worker
        ``max_piece_crashes`` consecutive times, in which case it is
        circuit-broken: quarantined server-side and reported to every
        client (ECHO + a machine-readable BATCHQUARANTINE event)
        instead of being requeued into an infinite crash loop.

        A lost WORLD-PACK demuxes first: only the worlds whose pieces
        never completed (no ``BATCHWORLD`` ack, no ``completed``
        journal record) are requeued/striked — the finished worlds'
        pieces stay exactly-once done."""
        self._cancel_pending.pop(wid, None)
        self.sdc_quarantine.discard(wid)
        piece = self.inflight.pop(wid, None)
        owner = self.inflight_owner.pop(wid, b"")
        self.inflight_t.pop(wid, None)
        self.worker_progress.pop(wid, None)
        if self._sdc_execs.pop(wid, None) is not None:
            # a vote/audit re-execution lost its worker: the original
            # piece is already complete — neither a requeue nor a
            # circuit-breaker strike (the comparison is simply lost)
            print(f"server: SDC re-execution worker {wid.hex()} lost — "
                  f"comparison abandoned, piece stays complete")
            return
        if piece is None:
            return
        if isinstance(piece, WorldPack):
            lost = piece.remaining()
            print(f"server: packed worker {wid.hex()} lost — "
                  f"{len(piece.done)}/{len(piece)} world(s) were "
                  f"complete, requeueing {len(lost)}")
            # reversed: push_front per piece keeps the original order
            for _i, powner, p in reversed(lost):
                self._piece_failed(p, powner)
            return
        if self._drop_hedge_links(wid) is not None:
            # the hedge partner still runs a copy of this piece: the
            # piece is not lost, so neither a requeue nor a circuit-
            # breaker strike — one crashed half of a hedge must not
            # poison-count content the other half may yet complete
            print(f"server: hedged worker {wid.hex()} lost — partner "
                  f"still running the piece, no requeue")
            return
        self._piece_failed(piece, owner)

    def _piece_failed(self, piece, owner=b""):
        """One circuit-breaker strike against a piece (its worker died
        or its world failed): requeue it, or quarantine it once it has
        struck out ``max_piece_crashes`` consecutive times."""
        key = self._piece_key(piece)
        count = self.piece_crashes.get(key, 0) + 1
        self.piece_crashes[key] = count
        if count >= self.max_piece_crashes:
            self.piece_crashes.pop(key, None)
            self.quarantined.append(piece)
            pname = self._piece_name(piece)
            if self.journal:
                self.journal.quarantined(piece, count)
            msg = (f"BATCH piece '{pname}' quarantined: lost its worker "
                   f"{count} consecutive times (circuit breaker)")
            print(f"server: {msg}")
            data = {"piece": pname, "crashes": count,
                    "scencmd": list(piece[1])}
            self.quarantine_reports.append(data)
            self._report_clients(msg)
            self._report_clients(msg, name=b"BATCHQUARANTINE", data=data)
        else:
            # requeue BEFORE the journal append: the fsync is a real
            # disk wait, and observers polling inflight/scenarios must
            # never see the piece in neither
            self.scenarios.push_front(piece, owner)
            if self.journal:
                self.journal.crashed(piece, count)
        self._sweep_slo(piece)

    def _sweep_slo(self, piece):
        """Drop the SLO watch's bookkeeping for a piece leaving flight
        (completed, requeued or quarantined) so week-long soaks never
        grow ``_slo_flagged``/``_slo_recent`` unboundedly.  Sweeps
        every worker's entry for the piece — a completion/requeue ends
        the flight of ALL its copies (hedge halves included), and a
        re-dispatch re-flags on its own merit."""
        if not self._slo_flagged and not self._slo_recent:
            return
        from .journal import BatchJournal
        key = BatchJournal.piece_key(piece)
        for flag in [f for f in self._slo_flagged if f[1] == key]:
            self._slo_flagged.discard(flag)
        pname = self._piece_name(piece)
        kept = [r for r in self._slo_recent if r.get("piece") != pname]
        if len(kept) != len(self._slo_recent):
            self._slo_recent.clear()
            self._slo_recent.extend(kept)

    def _nodeschanged(self):
        """Notify clients; chained remote nodes are merged in (reference
        server.py:213-225 route-prefixed server table)."""
        data = packb({"host_id": self.server_id,
                      "nodes": list(self.workers)
                      + list(self.remote_nodes)})
        for cid in self.clients:
            self.fe_event.send_multipart([cid, b"NODESCHANGED", data])

    def _handle_server_event(self, sock, sender, name, payload):
        from_worker = sock is self.be_event
        if name == b"REGISTER":
            reg = unpackb(payload) if payload else None
            if from_worker:
                if sender not in self.workers:
                    self.workers[sender] = 0
                    self._pending_spawns = max(0, self._pending_spawns - 1)
                # broker-HA failover reconciliation: a surviving worker
                # re-REGISTERs with its in-flight piece report — fold it
                # BEFORE the availability check (an adopted piece puts
                # the worker in ``inflight``, which keeps it unavailable
                # exactly like any mid-BATCH worker)
                if isinstance(reg, dict):
                    self._ha_adopt(sender, reg.get("inflight"))
                # duplicated/late REGISTER frames (flaky transport) must
                # not double-book the worker: one mid-BATCH (in inflight
                # or state OP) stays unavailable, or piece B would
                # overwrite its in-flight piece A and silently drop A
                if sender not in self.avail_workers \
                        and sender not in self.inflight \
                        and sender not in self.sdc_quarantine \
                        and self.workers[sender] < 2:
                    self.avail_workers.append(sender)
                self._send_pending_scenario()
                self._nodeschanged()
            new_client = False
            if not from_worker and sender not in self.clients:
                # backoff clients re-send REGISTER until acked — every
                # resend must ack, but only the first may register
                self.clients.append(sender)
                new_client = True
            ack = {"host_id": self.server_id,
                   "nodes": list(self.workers)
                   + list(self.remote_nodes),
                   # broker pid: FAULT KILLSERVER's SIGKILL target
                   "pid": os.getpid()}
            if self.ha_role:
                # HA peers learn the lease terms from the ack: epoch
                # presence is what arms a node's failover detector, and
                # the discovery port is where it re-runs arbitration
                ack.update(epoch=int(self.ha_epoch),
                           role="leader" if self._ha_serving
                           else "standby",
                           lease_ttl=float(self.ha_lease_ttl),
                           discovery=self.ports["discovery"])
            sock.send_multipart([sender, b"REGISTER", packb(ack)])
            if new_client:
                # replay circuit-breaker verdicts so a late-joining /
                # reattaching operator still sees what the sweep dropped
                for data in self.quarantine_reports:
                    sock.send_multipart(
                        [sender, b"BATCHQUARANTINE", packb(data)])
        elif name == b"ADDNODES":
            count = unpackb(payload) if payload else 1
            self.addnodes(int(count or 1))
        elif name == b"STATECHANGE":
            state = unpackb(payload)
            if state == -1:
                self.workers.pop(sender, None)
                self.spawned.pop(sender, None)
                self.last_seen.pop(sender, None)
                if sender in self.avail_workers:
                    self.avail_workers.remove(sender)
                # a worker that quit with a piece still running gives it
                # back to the queue — through the circuit breaker: a
                # poison pill that makes its worker abort cleanly loops
                # exactly like one that SIGKILLs it
                self._requeue_lost_piece(sender)
                self._nodeschanged()
                # keep the batch draining if pieces are still queued
                if self.scenarios:
                    self._spawn_for_backlog()
            else:
                self.workers[sender] = state
                # worker dropped out of OP -> available for the next piece;
                # busy workers must not receive BATCH pieces
                # (parity: server.py:234-247)
                if state < 2:
                    if sender in self._sdc_execs:
                        # an SDC vote/audit re-execution retired: its
                        # piece is ALREADY complete — never journal a
                        # second ``completed`` (content-addressed keys
                        # would double-count a repeat-trial sweep);
                        # resolve the fingerprint comparison instead
                        self._finish_sdc_exec(sender)
                        return
                    piece = self.inflight.pop(sender, None)
                    if isinstance(piece, WorldPack):
                        # packed piece retired cleanly: per-world
                        # BATCHWORLD events arrived first (FIFO pair),
                        # so normally nothing remains — but a world the
                        # worker finished without reporting is counted
                        # completed exactly once HERE, never dropped
                        t0 = time.perf_counter()
                        self.inflight_owner.pop(sender, None)
                        self.inflight_t.pop(sender, None)
                        for i, _owner, p in piece.remaining():
                            piece.done[i] = "completed"
                            self.piece_crashes.pop(self._piece_key(p),
                                                   None)
                            if self.journal:
                                self.journal.completed(p, sender,
                                                       world=i)
                        self._completion_stamps.append(time.monotonic())
                        self._observe_demux(t0, kind="pack_retire",
                                            worker=sender.hex())
                    elif piece is not None:   # piece completed cleanly:
                        # reset its consecutive-crash count
                        self.inflight_owner.pop(sender, None)
                        self.inflight_t.pop(sender, None)
                        self.piece_crashes.pop(self._piece_key(piece),
                                               None)
                        self._completion_stamps.append(time.monotonic())
                        if self.journal:    # exactly-once: a resumed
                            # server will never requeue this piece
                            self.journal.completed(piece, sender)
                        self._resolve_hedge_win(sender, piece)
                        self._sweep_slo(piece)
                        self._maybe_sdc_audit(sender, piece)
                    elif sender in self._cancel_pending:
                        # the hedge LOSER finished before its cancel
                        # landed (its BATCHCANCELLED ack would have
                        # arrived first — DEALER/ROUTER pairs are FIFO):
                        # a duplicate completion.  Audit-journal it;
                        # replay does NOT count it as a completion.
                        dup = self._cancel_pending.pop(sender)
                        self.dup_completions += 1
                        if self.journal:
                            self.journal.dup_completed(dup, sender)
                        # redundant-execution voting: the loser ran the
                        # SAME content to completion — its fingerprint
                        # is a free comparison word against the winner's
                        self._sdc_compare(dup, via="hedge_dup")
                    if sender not in self.avail_workers \
                            and sender not in self.sdc_quarantine:
                        self.avail_workers.append(sender)
                        self._send_pending_scenario()
                elif sender in self.avail_workers:
                    self.avail_workers.remove(sender)
        elif name == b"PONG":
            # last_seen already stamped; a SimNode piggybacks progress
            # (simt, chunks done) on the reply — feed the straggler
            # detector so a stall is distinguishable from a long chunk
            data = unpackb(payload) if payload else None
            if isinstance(data, dict) and "simt" in data:
                self._note_progress(sender, data)
        elif name == b"BATCHWORLD" and from_worker:
            # per-world completion report from a packed assignment: the
            # demux leg of exactly-once — journal THAT piece completed
            # (or strike/requeue it on a per-world failure) while the
            # rest of the pack keeps running
            t0 = time.perf_counter()
            pack = self.inflight.get(sender)
            data = unpackb(payload) if payload else None
            if isinstance(pack, WorldPack) and isinstance(data, dict):
                i = int(data.get("world", -1))
                status = str(data.get("status", "completed"))
                if 0 <= i < len(pack) and i not in pack.done:
                    pack.done[i] = status
                    p = pack.pieces[i]
                    if status == "completed":
                        self.piece_crashes.pop(self._piece_key(p), None)
                        self._completion_stamps.append(time.monotonic())
                        if self.journal:
                            self.journal.completed(p, sender, world=i)
                    else:
                        self.worlds_failed += 1
                        self._report_clients(
                            f"world {i} of packed piece on worker "
                            f"{sender.hex()} {status} — piece striked")
                        self._piece_failed(p, pack.owners[i])
                    self._observe_demux(t0, kind="world", world=i,
                                        worker=sender.hex())
        elif name == b"OPTRESULT" and from_worker:
            # Trajectory-optimization result from an OPT BATCH piece
            # (diff/optimize.py via the OPT stack command): journal it
            # against the in-flight piece BEFORE the piece's completion
            # lands (the FIFO pair guarantees OPTRESULT precedes the
            # STATECHANGE out of OP), and fan a machine-readable
            # BATCHOPT report out to the clients.  The journal record
            # is audit data: replay ignores it for the queue math.
            data = unpackb(payload) if payload else None
            piece = self.inflight.get(sender)
            self.opt_results += 1
            if self.journal and piece is not None \
                    and not isinstance(piece, WorldPack):
                self.journal.opt_result(piece, sender, data)
            d = data if isinstance(data, dict) else {}
            msg = (f"OPT result from worker {sender.hex()}: objective "
                   f"{d.get('objective_first', '?')} -> "
                   f"{d.get('objective_last', '?')} in "
                   f"{d.get('iters', '?')} iters, hard LoS "
                   f"{d.get('hard_los_before', '?')} -> "
                   f"{d.get('hard_los_after', '?')}"
                   + (f", guard word {d['bad']}"
                      if d.get("bad", -1) != -1 else ""))
            print(f"server: {msg}")
            self._report_clients(msg)
            self._report_clients(msg, name=b"BATCHOPT", data=data)
        elif name == b"DEVPROF" and from_worker:
            # PROFILE DEVICE on a worker: journal the trace-window dir
            # (audit record; links the sweep's journal to the captured
            # device trace)
            data = unpackb(payload) if payload else None
            d = data if isinstance(data, dict) else {}
            if self.journal:
                self.journal.device_profile(sender,
                                            dir=d.get("dir", ""),
                                            chunks=d.get("chunks"))
            self._report_clients(
                f"worker {sender.hex()} device-profiling "
                f"{d.get('chunks', '?')} chunk(s) to {d.get('dir', '?')}")
        elif name == b"WORLDS":
            # WORLDS stack/client command: set the packing knobs
            # (payload dict) and/or read them back HEALTH-style
            data = unpackb(payload) if payload else None
            if isinstance(data, dict):
                if "pack" in data:
                    self.world_pack = bool(data["pack"])
                if "max" in data:
                    self.world_batch_max = max(1, int(data["max"]))
            sock.send_multipart(
                [sender, b"WORLDS", packb(self.worlds_payload())])
        elif name == b"MITIGATE":
            # MITIGATE stack/client command: flip the mitigation
            # engine (payload dict) and/or read its state back
            # HEALTH-style.  Disabling restores every actuator the
            # engine touched (mitigate.set_enabled).
            data = unpackb(payload) if payload else None
            if isinstance(data, dict) and "enabled" in data:
                self.mitigator.set_enabled(data["enabled"])
            sock.send_multipart(
                [sender, b"MITIGATE", packb(self.mitigator.payload())])
        elif name == b"SDCFP" and from_worker:
            # per-piece state fingerprint, shipped just BEFORE the
            # worker's STATECHANGE out of OP (FIFO pair: the piece is
            # still in ``inflight`` when this arrives) — record it for
            # the redundant-execution comparisons
            data = unpackb(payload) if payload else None
            piece = self.inflight.get(sender)
            if piece is None:
                # hedge loser: its piece left inflight when the winner
                # completed, but the cancelled copy still finished and
                # its word is exactly the comparison the dup path needs
                piece = self._cancel_pending.get(sender)
            if isinstance(data, dict) and piece is not None \
                    and not isinstance(piece, WorldPack):
                self._note_sdc_fp(sender, piece, data)
        elif name == b"SDC":
            # SDC stack/client command: flip the defense / set the
            # audit-sampling rate (payload dict) and/or read the state
            # back HEALTH-style
            data = unpackb(payload) if payload else None
            if isinstance(data, dict):
                if "enabled" in data:
                    self.sdc_enabled = bool(data["enabled"])
                if "audit_rate" in data:
                    self.sdc_audit_rate = max(
                        0.0, float(data["audit_rate"] or 0.0))
            sock.send_multipart(
                [sender, b"SDC", packb(self.sdc_payload())])
        elif name == b"HA":
            # HA STATUS stack/client command: broker-HA state readback
            # (role, epoch, lease age, takeover/adoption counters)
            sock.send_multipart(
                [sender, b"HA", packb(self.ha_payload())])
        elif name == b"BATCHCANCELLED" and from_worker:
            # hedge loser acked the cancel (it had NOT completed: a
            # completion would have arrived first on the FIFO pair)
            if self._cancel_pending.pop(sender, None) is not None:
                self.hedges_cancelled += 1
        elif name == b"HEALTH":
            sock.send_multipart(
                [sender, b"HEALTH", packb(self.health_payload())])
        elif name == b"METRICS":
            # METRICS DUMP (stack/commands.py): broker registry + the
            # fleet aggregate merged from worker heartbeat deltas
            sock.send_multipart(
                [sender, b"METRICS", packb(self.metrics_payload())])
        elif name == b"TRACE":
            # TRACE DUMP reached the broker: dump ITS ring too, so the
            # report merger gets the server half of the timeline
            path = self.recorder.dump(reason="manual", proc="server") \
                if self.recorder.enabled and len(self.recorder) else None
            sock.send_multipart(
                [sender, b"TRACE",
                 packb({"path": path,
                        "enabled": bool(self.recorder.enabled),
                        "events": len(self.recorder)})])
        elif name == b"PREEMPTED" and from_worker:
            # a preempted worker drained its chunk, wrote a checkpoint
            # and is exiting: requeue its piece WITHOUT a circuit-
            # breaker strike (preemption is capacity churn, not a piece
            # fault) — the follow-up STATECHANGE(-1) then finds nothing
            # in flight, so no crash is counted either
            data = unpackb(payload) if payload else None
            piece = self.inflight.pop(sender, None)
            owner = self.inflight_owner.pop(sender, b"")
            self.inflight_t.pop(sender, None)
            if isinstance(piece, WorldPack):
                # preemption mid-pack is capacity churn, not a piece
                # fault: requeue ONLY the unfinished worlds' pieces,
                # no circuit-breaker strikes (completed worlds were
                # already journaled by their BATCHWORLD events)
                for i, powner, p in reversed(piece.remaining()):
                    self.scenarios.push_front(p, powner)
                    if self.journal:
                        self.journal.preempted(p, sender, world=i)
                while self.avail_workers and self.scenarios:
                    self._send_pending_scenario()
                piece = None
            if piece is not None and self._drop_hedge_links(sender) \
                    is not None:
                # the hedge partner still runs this piece — a preempted
                # hedge half neither requeues nor re-dispatches
                piece = None
            if piece is not None:
                self.scenarios.push_front(piece, owner)
                if self.journal:
                    self.journal.preempted(piece, sender)
                self._sweep_slo(piece)
                # hand the piece straight to an idle worker if one is
                # available — the preempted worker's own STATECHANGE(-1)
                # only spawns replacements, it does not dispatch
                while self.avail_workers and self.scenarios:
                    self._send_pending_scenario()
            ck = (data or {}).get("checkpoint", "")
            msg = (f"worker {sender.hex()} preempted"
                   + (f" (checkpoint: {ck})" if ck else "")
                   + (" — piece requeued" if piece is not None else ""))
            print(f"server: {msg}")
            self._report_clients(msg)
        elif name == b"MESHLOST" and from_worker:
            # a sharded worker lost a device group mid-piece.  Two
            # shapes: recovered=True — the worker re-formed a survivor
            # mesh, restored its last checksummed snapshot and is STILL
            # running the same piece (audit records only, the piece
            # stays in flight); recovered=False — the worker could not
            # re-form a mesh: requeue WITHOUT a circuit-breaker strike,
            # PREEMPTED-style (device-group loss is capacity churn, not
            # a piece fault)
            data = unpackb(payload) if payload else None
            ev = data if isinstance(data, dict) else {}
            epoch = ev.get("epoch")
            lost = ev.get("lost_groups")
            if ev.get("recovered", True):
                piece = self.inflight.get(sender)
                if self.journal and piece is not None:
                    if isinstance(piece, WorldPack):
                        for i, _powner, p in piece.remaining():
                            self.journal.mesh_lost(p, sender, world=i,
                                                   epoch=epoch,
                                                   lost=lost)
                            self.journal.resharded(
                                p, sender, world=i, epoch=epoch,
                                ndev=ev.get("ndev"),
                                mode=ev.get("mode"))
                    else:
                        self.journal.mesh_lost(piece, sender,
                                               epoch=epoch, lost=lost)
                        self.journal.resharded(piece, sender,
                                               epoch=epoch,
                                               ndev=ev.get("ndev"),
                                               mode=ev.get("mode"))
                if ev.get("degraded") and piece is not None:
                    # mitigation: accept the degraded epoch instead of
                    # requeueing — journaled so the acceptance audits
                    self.mitigator.on_mesh_degraded(sender, piece,
                                                    epoch,
                                                    ev.get("ndev"))
                msg = (f"worker {sender.hex()} mesh epoch {epoch}: "
                       f"lost group(s) {lost}, resharded to "
                       f"{ev.get('ndev')} device(s) "
                       f"({ev.get('mode')})"
                       + (" [degraded]" if ev.get("degraded") else "")
                       + (", restored from snapshot"
                          if ev.get("restored") else "")
                       + " — piece continues")
            else:
                piece = self.inflight.pop(sender, None)
                owner = self.inflight_owner.pop(sender, b"")
                self.inflight_t.pop(sender, None)
                if isinstance(piece, WorldPack):
                    for i, powner, p in reversed(piece.remaining()):
                        self.scenarios.push_front(p, powner)
                        if self.journal:
                            self.journal.mesh_lost(p, sender, world=i,
                                                   epoch=epoch,
                                                   lost=lost)
                    while self.avail_workers and self.scenarios:
                        self._send_pending_scenario()
                    piece = None
                if piece is not None and self._drop_hedge_links(sender) \
                        is not None:
                    piece = None
                if piece is not None:
                    self.scenarios.push_front(piece, owner)
                    if self.journal:
                        self.journal.mesh_lost(piece, sender,
                                               epoch=epoch, lost=lost)
                    self._sweep_slo(piece)
                    while self.avail_workers and self.scenarios:
                        self._send_pending_scenario()
                msg = (f"worker {sender.hex()} mesh lost "
                       f"(epoch {epoch}, group(s) {lost}) — no "
                       f"survivor mesh"
                       + (", piece requeued" if piece is not None
                          else ""))
            print(f"server: {msg}")
            self._report_clients(msg)
        elif name == b"BATCH":
            data = unpackb(payload)
            if self.ha_role and not self._ha_serving:
                # warm standby: NEVER admit work before holding the
                # lease — admission would journal ``queued`` records
                # into a file the live leader still owns
                self.rejected_batches += 1
                sock.send_multipart(
                    [sender, b"BATCHREJECTED",
                     packb({"reason": "standby",
                            "epoch": int(self.ha_epoch)})])
                return
            pieces = split_scenarios(data["scentime"], data["scencmd"])
            # Admission control: a flood of submissions must not grow
            # the pending queue (and its journal) without bound.  The
            # over-limit submitter gets a structured refusal with the
            # queue state and a drain-rate-informed retry hint; the
            # queue and journal stay untouched.
            depth = len(self.scenarios)
            if self.batch_queue_max \
                    and depth + len(pieces) > self.batch_queue_max:
                self.rejected_batches += 1
                sock.send_multipart(
                    [sender, b"BATCHREJECTED",
                     packb({"queue_depth": depth,
                            "limit": self.batch_queue_max,
                            "submitted": len(pieces),
                            "retry_after": self._retry_after(
                                len(pieces))})])
                return
            if self.journal:
                # one flush+fsync for the whole submission — per-piece
                # syncs would stall the poll loop on large sweeps.
                # Synthetic pieces (FAULT LOADSPIKE chaos filler) are
                # marked so replay's exactly-once accounting skips
                # them: a resumed sweep is never owed load-spike noise.
                self.journal.queued_many(
                    pieces, synthetic=bool(data.get("synthetic")))
            self.scenarios.extend(pieces, owner=sender)
            while self.avail_workers and self.scenarios:
                self._send_pending_scenario()
            if self.scenarios:
                self._spawn_for_backlog()
        elif name == b"QUIT":
            for wid in self.workers:
                self.be_event.send_multipart([wid, b"QUIT", packb(None)])
            self.running = False
        elif from_worker:
            # unaddressed worker output (e.g. scenario-triggered ECHO with
            # no issuing client): fan out to every connected client
            for cid in self.clients:
                self.fe_event.send_multipart([cid, sender, name, payload])

    def _send_pending_scenario(self):
        if self.ha_role and not self._ha_serving:
            return                 # standby never dispatches pre-lease
        if not (self.avail_workers and self.scenarios):
            return
        wid = self.avail_workers.pop(0)
        # World packing (WORLDS command / settings.world_pack): fill up
        # to world_batch_max compatible pieces into ONE assignment.
        # Compatibility is per worker-bucket by construction (every
        # world sim shares the worker's nmax); a piece requesting
        # shard_mode=spatial never joins a pack — it dispatches solo
        # with a structured WORLDSREFUSED echo instead of a crash.
        wmax = max(1, int(self.world_batch_max)) if self.world_pack \
            else 1
        if wmax > 1 and self.avail_workers:
            # spread across the idle fleet: pack only the share the
            # OTHER idle workers can't take — packing exists to
            # oversubscribe one device, not to starve idle ones
            share = -(-len(self.scenarios)
                      // (len(self.avail_workers) + 1))
            wmax = max(1, min(wmax, share))
        picks = []
        # pack_fill span: the world-pack fill loop — compatibility
        # checks + fairness-queue pops — as one complete event of the
        # recorder; the solo path
        # (wmax == 1) untouched
        t_fill0 = time.perf_counter() \
            if wmax > 1 and self.recorder.enabled else None
        while len(picks) < wmax and self.scenarios:
            owner, piece = self.scenarios.pop_next()
            if self.scenarios.last_wait_s is not None:
                self.obs.get("server_queue_wait_s").observe(
                    self.scenarios.last_wait_s)
            solo_why = self._piece_solo_reason(piece) \
                if self.world_pack and wmax > 1 else None
            if solo_why and picks:
                # pack already filling: refuse the solo-only piece from
                # THIS pack with a structured echo — exactly once,
                # because the piece keeps its fairness turn and takes
                # the worker SOLO (a requeue would let the FairQueue
                # rotation re-refuse it on every pack fill); the
                # pieces already picked go back to their owners' queue
                # heads and pack on the next idle worker.  A solo-only
                # piece popped with the pack still empty just takes
                # the 1-piece solo path below: nothing was refused.
                if solo_why == "shard_mode=spatial":
                    self.worlds_refused_spatial += 1
                else:
                    self.worlds_refused_opt += 1
                pname = self._piece_name(piece)
                why_txt = ("requests shard_mode=spatial — refused from "
                           "the world-batch, dispatching it unpacked "
                           "(world-batching and spatial stripes compose "
                           "later, not now)"
                           if solo_why == "shard_mode=spatial" else
                           "is an OPT/GRAD piece — refused from the "
                           "world-batch, dispatching it unpacked (the "
                           "optimizer multi-starts on the world axis "
                           "internally and its OPTRESULT needs the "
                           "worker's own event socket)")
                msg = f"WORLDS: piece '{pname}' {why_txt}"
                print(f"server: {msg}")
                self._report_clients(msg)
                self._report_clients(
                    msg, name=b"WORLDSREFUSED",
                    data={"piece": pname, "reason": solo_why,
                          "scencmd": list(piece[1])})
                for powner, p in reversed(picks):
                    self.scenarios.push_front(p, powner)
                picks = [(owner, piece)]
                break
            picks.append((owner, piece))
            if solo_why:
                break    # solo-only piece dispatches alone, never packs
        if t_fill0 is not None:
            rec = self.recorder
            rec.complete("pack_fill", rec.wall_us(t_fill0),
                         (time.perf_counter() - t_fill0) * 1e6,
                         cat="server", wmax=wmax, npicks=len(picks),
                         worker=wid.hex())
        self.inflight_t[wid] = time.monotonic()
        prog = self.worker_progress.get(wid)
        if prog is not None:               # straggler clock restarts at
            prog["advance_t"] = self.inflight_t[wid]   # dispatch
        if len(picks) == 1:
            owner, piece = picks[0]
            self.inflight[wid] = piece     # held until the worker leaves OP
            self.inflight_owner[wid] = owner
            if self.journal:
                self.journal.dispatched(piece, wid)
            scentime, scencmd = piece
            self.be_event.send_multipart(
                [wid, b"BATCH", packb({"scentime": scentime,
                                       "scencmd": scencmd})])
            return
        pack = WorldPack(picks)
        self.inflight[wid] = pack
        self.inflight_owner[wid] = b""     # owners tracked per world
        self.packed_pieces += len(pack)
        self.world_batches += 1
        self._pack_fill_sum += len(pack) / wmax
        if self.journal:
            for i, (_owner, p) in enumerate(picks):
                self.journal.dispatched(p, wid, world=i,
                                        pack=len(pack))
        self.be_event.send_multipart(
            [wid, b"BATCH",
             packb({"worlds": [{"scentime": p[0], "scencmd": p[1]}
                               for _o, p in picks]})])

    # ------------------------------------------------------ broker HA
    def _ha_renew_dt(self):
        """Lease-renew cadence: well inside the ttl (a renewal must
        land several times per lease or a busy poll loop looks dead)."""
        return min(self.ha_poll_dt, max(self.ha_lease_ttl / 3.0, 0.05))

    def _ha_acquire(self):
        """Leader start-up: take the lease.  The epoch is one past the
        highest ever seen (journal lease records OR the lease file), so
        a restarted/promoted leader always fences its predecessor's
        late appends — and the lease record lands in the journal BEFORE
        any sweep record this leader writes."""
        from . import ha as _ha
        tail = _ha.JournalTail(self.journal.path)
        tail.poll()
        lease = _ha.read_lease(self._ha_lease_file) or {}
        seen = max(int(lease.get("epoch", 0) or 0), tail.epoch,
                   self.ha_epoch)
        self.ha_epoch = seen + 1
        self.journal.epoch = self.ha_epoch
        self.journal.lease(leader=self.server_id.hex(),
                           epoch=self.ha_epoch, ttl=self.ha_lease_ttl)
        _ha.write_lease(self._ha_lease_file, self.server_id.hex(),
                        self.ha_epoch, self.ha_lease_ttl)
        self._ha_next_renew = time.monotonic() + self._ha_renew_dt()
        print(f"server: HA leader {self.server_id.hex()} acquired "
              f"lease epoch {self.ha_epoch} "
              f"(ttl {self.ha_lease_ttl:g}s)")

    def _ha_renew(self, now):
        """Refresh the lease file's stamp (the journal record is the
        durable acquisition; renewal is file-only and cheap)."""
        from . import ha as _ha
        _ha.write_lease(self._ha_lease_file, self.server_id.hex(),
                        self.ha_epoch, self.ha_lease_ttl)
        self._ha_next_renew = now + self._ha_renew_dt()

    def _ha_standby_poll(self, now):
        """Standby heartbeat: tail the journal (warm replay state),
        watch the lease, and take over only after the leader has been
        silent for its full promised ttl."""
        from . import ha as _ha
        self._ha_tail.poll()
        lease = _ha.read_lease(self._ha_lease_file)
        if lease is not None:
            ep = int(lease.get("epoch", 0) or 0)
            if ep > self.ha_epoch:
                self.ha_epoch = ep         # track the live leader
        if not _ha.is_stale(lease, default_ttl=self.ha_lease_ttl):
            self._ha_stale_since = None
            return
        if lease is None:
            # no lease file at all: the leader may simply not have
            # started yet — demand a full ttl of OBSERVED absence
            if self._ha_stale_since is None:
                self._ha_stale_since = now
                return
            if now - self._ha_stale_since < self.ha_lease_ttl:
                return
        self._ha_takeover(lease)

    def _ha_takeover(self, stale_lease):
        """The lease went silent: become the leader.  Succession is
        journal-fenced — our own ``lease`` record (epoch N+1) is
        appended FIRST, so everything the deposed leader manages to
        append after it carries a stale ``wepoch`` and replay fences it
        off as audit-only.  Then the whole sweep state carries over
        from a full replay: quarantines, strikes, completions, and an
        owed-pieces limbo that surviving workers' re-REGISTERs adopt
        from during a grace window (leftovers requeue after it)."""
        from . import ha as _ha
        from .journal import BatchJournal
        old = int((stale_lease or {}).get("epoch", 0) or 0)
        self.ha_epoch = max(old, self._ha_tail.epoch,
                            self.ha_epoch) + 1
        self.ha_role = "leader"
        self._ha_serving = True
        self.ha_takeovers += 1
        self._ha_stale_since = None
        self.journal.epoch = self.ha_epoch
        self.journal.lease(leader=self.server_id.hex(),
                           epoch=self.ha_epoch, ttl=self.ha_lease_ttl)
        _ha.write_lease(self._ha_lease_file, self.server_id.hex(),
                        self.ha_epoch, self.ha_lease_ttl)
        now = time.monotonic()
        self._ha_next_renew = now + self._ha_renew_dt()
        try:
            state = BatchJournal.replay(
                self.journal.path,
                fence_strict=self.ha_fence_strict)
        except OSError as e:
            print(f"server: HA takeover replay failed ({e}) — "
                  f"serving with an empty queue")
            state = None
        if state is not None:
            self._ha_fold_state(state)
        self.journal.append("resumed", pending=len(self._ha_limbo),
                            completed=sum(self._ha_completed.values()),
                            quarantined=len(self.quarantined),
                            takeover=True)
        # adoption grace: long enough for every surviving worker to
        # notice the dead socket, re-discover and re-REGISTER.  A
        # worker only declares the server dead after 1.5x ttl of
        # silence, then probes (rate-limited to ttl/4) with a 0.5 s
        # collect window — 3x ttl from takeover covers that worst case
        # with slack; the 2 s floor absorbs scheduler jitter at tiny
        # ttls.
        grace = max(3.0 * self.ha_lease_ttl, 3.0 * self.hb_interval,
                    2.0)
        self._ha_grace_until = now + grace
        msg = (f"HA: standby {self.server_id.hex()} took over as "
               f"leader, epoch {self.ha_epoch} — "
               f"{len(self._ha_limbo)} owed piece(s) awaiting "
               f"adoption ({grace:g}s grace), "
               f"{sum(self._ha_completed.values())} already complete")
        print(f"server: {msg}")
        self._report_clients(msg)

    def _ha_fold_state(self, state):
        """Carry the deposed leader's sweep state over from replay:
        quarantines (with their client-visible reports), crash strikes,
        the owed-pieces multiset (held in LIMBO for worker adoption,
        not requeued yet), per-key completion counts for raced-
        completion dedupe, placed SDC votes, and worker quarantines
        from the mitigation decision history."""
        from .journal import BatchJournal
        for piece in state["quarantined"]:
            self.quarantined.append(piece)
            self.quarantine_reports.append(
                {"piece": self._piece_name(piece),
                 "crashes": state["quarantined_crashes"].get(
                     BatchJournal.piece_key(piece), 0),
                 "scencmd": list(piece[1]), "resumed": True})
        for piece in state["pending"]:
            jkey = BatchJournal.piece_key(piece)
            if jkey in state["crashes"]:
                self.piece_crashes[self._piece_key(piece)] = \
                    state["crashes"][jkey]
        self._ha_limbo = list(state["pending"])
        self._ha_pieces = {}
        for piece in state["pending"] + state["completed"]:
            self._ha_pieces.setdefault(
                BatchJournal.piece_key(piece), piece)
        self._ha_completed = dict(collections.Counter(
            BatchJournal.piece_key(p) for p in state["completed"]))
        for vote in state.get("sdc", {}).get("votes", []):
            if vote.get("key"):
                self._sdc_voted.add(vote["key"])
        for m in state.get("mitigations", []):
            try:
                wid = bytes.fromhex(m.get("target", ""))
            except ValueError:
                continue
            if m.get("action") == "quarantine_worker":
                self.sdc_quarantine.add(wid)
            elif m.get("action") == "release_worker":
                self.sdc_quarantine.discard(wid)

    def _ha_adopt(self, wid, report):
        """Fold one re-REGISTERing worker's in-flight report into the
        post-takeover reconciliation.  A report matching an owed limbo
        copy ADOPTS it: the piece keeps running where it is — no
        requeue, no breaker strike (the PREEMPTED capacity-churn model
        generalized to leadership churn), journaled ``adopted``.  A
        report whose content is already fully counted is a completion
        that raced the failover (or a surviving hedge twin): that copy
        is cancelled, and a completion that still lands dedupes through
        the existing ``dup_completed`` cancel path.  Inert (empty maps)
        unless a takeover populated the limbo."""
        if not isinstance(report, dict):
            return
        key = str(report.get("key") or "")
        if not key or wid in self.inflight:
            return                 # idempotent duplicate re-REGISTER
        if not (self._ha_limbo or self._ha_pieces):
            return
        from .journal import BatchJournal
        for i, piece in enumerate(self._ha_limbo):
            if BatchJournal.piece_key(piece) == key:
                self._ha_limbo.pop(i)
                self.inflight[wid] = piece
                self.inflight_owner[wid] = b""
                self.inflight_t[wid] = time.monotonic()
                self.ha_adoptions += 1
                if self.journal:
                    self.journal.adopted(piece, wid)
                msg = (f"HA: piece '{self._piece_name(piece)}' still "
                       f"running on surviving worker {wid.hex()} — "
                       f"adopted in place, no requeue")
                print(f"server: {msg}")
                self._report_clients(msg)
                return
        piece = self._ha_pieces.get(key)
        if piece is not None and self._ha_completed.get(key, 0) > 0:
            # every owed copy of this content is accounted for: the
            # completion raced the failover — cancel the survivor's
            # redundant copy (a completion beating the cancel lands as
            # an audit-only ``dup_completed``, exactly the hedge-loser
            # path)
            self._cancel_pending[wid] = piece
            self.ha_dedup_cancels += 1
            self.be_event.send_multipart(
                [wid, b"BATCHCANCEL", packb(None)])
            print(f"server: HA: worker {wid.hex()} reports already-"
                  f"counted piece '{self._piece_name(piece)}' — "
                  f"cancelled (raced-completion dedupe)")

    def _ha_release_limbo(self):
        """Adoption grace expired: requeue the owed copies nobody
        adopted (their workers died with the old leader) and kick the
        dispatch loop."""
        pieces, self._ha_limbo = self._ha_limbo, []
        self._ha_grace_until = 0.0
        if not pieces:
            return
        print(f"server: HA adoption grace over — requeueing "
              f"{len(pieces)} unadopted piece(s)")
        self.scenarios.extend(pieces)
        while self.avail_workers and self.scenarios:
            self._send_pending_scenario()
        if self.scenarios and self.spawn_workers:
            self._spawn_for_backlog()

    def ha_payload(self):
        """Machine-readable broker-HA state (the ``HA`` command and the
        HEALTH ``ha`` section), with a human ``text`` rendering — the
        HEALTH-style readback contract."""
        from . import ha as _ha
        if not self.ha_role:
            return {"enabled": False,
                    "text": "HA OFF: single-broker mode (settings."
                            "ha_standby / Server(ha_role=...) runs a "
                            "warm standby)"}
        lease = _ha.read_lease(self._ha_lease_file)
        d = {"enabled": True,
             "role": "leader" if self._ha_serving else "standby",
             "epoch": int(self.ha_epoch),
             "lease_ttl": float(self.ha_lease_ttl),
             "poll_dt": float(self.ha_poll_dt),
             "fence_strict": bool(self.ha_fence_strict),
             "lease_file": self._ha_lease_file,
             "lease_age": round(_ha.lease_age(lease), 3)
             if lease else None,
             "lease_leader": str(lease.get("leader", ""))
             if lease else None,
             "takeovers": self.ha_takeovers,
             "adoptions": self.ha_adoptions,
             "dedup_cancels": self.ha_dedup_cancels,
             "limbo": len(self._ha_limbo)}
        if self._ha_tail is not None:
            d["tail"] = {"records": self._ha_tail.records,
                         "leases": self._ha_tail.leases,
                         "epoch": self._ha_tail.epoch}
        d["text"] = (
            f"HA {d['role'].upper()}: epoch {d['epoch']}, lease ttl "
            f"{d['lease_ttl']:g}s"
            + (f", lease age {d['lease_age']:g}s"
               if d["lease_age"] is not None else ", no lease file")
            + f"; {d['takeovers']} takeover(s), "
              f"{d['adoptions']} adoption(s), "
              f"{d['dedup_cancels']} dedup cancel(s)"
            + (f", {d['limbo']} piece(s) in adoption limbo"
               if d["limbo"] else ""))
        return d

    # ------------------------------------------- stragglers / introspection
    def _note_progress(self, wid, data):
        """Fold a progress heartbeat (PONG payload from a SimNode) into
        the per-worker record: sim-time/chunk counters, the stamp of
        the last *advance*, and an EMA progress rate [sim s / wall s].
        A BATCH dispatch resets the sim (simt drops to 0), so chunk
        count — monotonic per worker process — is the advance signal;
        simt deltas feed the rate."""
        now = time.monotonic()
        # fleet telemetry: heartbeats piggyback the worker's metric
        # increments since its last report; merging deltas commutes,
        # so out-of-order arrivals from W workers aggregate exactly
        obs_delta = data.get("obs")
        if obs_delta:
            self.fleet.merge(obs_delta)
        simt = float(data.get("simt", 0.0))
        chunks = int(data.get("chunks", 0))
        prev = self.worker_progress.get(wid)
        if prev is None:
            self.worker_progress[wid] = {
                "simt": simt, "chunks": chunks, "rate": 0.0,
                "t": now, "advance_t": now,
                "state": data.get("state"),
                "ff": bool(data.get("ff", False)),
                "mesh": data.get("mesh"),
                "scan": data.get("scan"),
                "fp": data.get("fp")}
            return
        dt = now - prev["t"]
        if chunks > prev["chunks"] or simt > prev["simt"] + 1e-9:
            if dt > 1e-6 and simt > prev["simt"]:
                inst = (simt - prev["simt"]) / dt
                prev["rate"] = inst if prev["rate"] <= 0.0 \
                    else 0.5 * prev["rate"] + 0.5 * inst
            prev["advance_t"] = now
        prev.update(simt=simt, chunks=chunks, t=now,
                    state=data.get("state"),
                    ff=bool(data.get("ff", False)),
                    mesh=data.get("mesh", prev.get("mesh")),
                    scan=data.get("scan", prev.get("scan")),
                    fp=data.get("fp", prev.get("fp")))

    def _check_stragglers(self, now):
        """Speculative straggler re-dispatch: an in-flight piece whose
        worker keeps sending progress heartbeats (so it is alive — a
        worker blocked in a long first kernel build sends NONE and is left
        to the busy-PING budget) but whose progress has not advanced
        for ``straggler_timeout`` — or whose rate sits far below the
        fleet median — is hedged to an idle worker.  First completion
        wins; the loser is cancelled.

        With ``hedge_enabled`` off but the mitigation engine on, a
        detected straggler is handed to the engine instead: mitigation
        IS the operator typing the hedge, gated by its rate limits,
        backoff and budget (network/mitigate.py)."""
        if not (self.hedge_enabled or self.mitigator.enabled) \
                or self.straggler_timeout <= 0 \
                or not self.avail_workers:
            return
        fresh = 3.0 * self.hb_interval     # report recency window
        # The fleet-median rate is only meaningful across workers
        # running FULL SPEED (fast-forward sweep pieces): a wall-clock
        # paced piece reports ~dtmult sim-s/s by design, and hedging
        # it on "low rate" would burn a second worker on a copy that
        # cannot finish any earlier.  Stall detection (flat progress)
        # still covers non-FF pieces.
        median = self._fresh_ff_median(now)
        for wid, piece in list(self.inflight.items()):
            if not self.avail_workers:
                return
            if isinstance(piece, WorldPack):
                continue                   # packs are not hedged: a
                #                            second copy would duplicate
                #                            W pieces for one straggler
            if wid in self.hedge_by or wid in self.hedge_of:
                continue                   # one hedge per piece
            prog = self.worker_progress.get(wid)
            if prog is None or now - prog["t"] > fresh:
                continue                   # silent, not stalled
            age = now - self.inflight_t.get(wid, now)
            if age <= self.straggler_timeout:
                continue                   # dispatch grace period
            stalled = now - prog["advance_t"] > self.straggler_timeout
            slow = median is not None and prog.get("ff") \
                and prog["rate"] < self.hedge_rate_factor * median
            if stalled or slow:
                why = "stalled" if stalled else \
                    f"rate {prog['rate']:.2f} << median {median:.2f}"
                if self.hedge_enabled:
                    self._dispatch_hedge(wid, piece, why)
                else:
                    self.mitigator.on_straggler(wid, piece, why, now)

    def _fresh_ff_median(self, now):
        """Fleet-median progress rate over fresh fast-forward reports
        (the hedge detector's yardstick, shared by the SLO watch)."""
        fresh = 3.0 * self.hb_interval
        rates = [p["rate"] for w, p in self.worker_progress.items()
                 if w in self.inflight and p["rate"] > 0.0
                 and p.get("ff") and now - p["t"] <= fresh]
        return statistics.median(rates) if len(rates) >= 2 else None

    def _check_perf_slo(self, now):
        """Serving-side SLO watch: journal ONE
        ``perf_regression`` audit record per (worker, piece) whose
        rolling FF rate sits below ``perf_slo_factor`` x the fleet
        median.  Pure observation — the piece stays in flight and the
        queue math never sees the record; hedging (if enabled) remains
        the mitigation."""
        if self.perf_slo_factor <= 0.0:
            return
        median = self._fresh_ff_median(now)
        self._slo_median = median
        if median is None:
            return
        fresh = 3.0 * self.hb_interval
        from .journal import BatchJournal
        for wid, piece in list(self.inflight.items()):
            if isinstance(piece, WorldPack):
                continue               # pack rates aggregate W pieces
            prog = self.worker_progress.get(wid)
            if prog is None or now - prog["t"] > fresh \
                    or not prog.get("ff") or prog["rate"] <= 0.0:
                continue
            if now - self.inflight_t.get(wid, now) \
                    <= self.straggler_timeout:
                continue               # dispatch/build grace period
            if prog["rate"] >= self.perf_slo_factor * median:
                continue
            key = (wid, BatchJournal.piece_key(piece))
            if key in self._slo_flagged:
                continue               # once per (worker, piece)
            self._slo_flagged.add(key)
            self.perf_regressions += 1
            pname = self._piece_name(piece)
            self.recorder.instant("perf_regression", cat="server",
                                  piece=pname, worker=wid.hex(),
                                  rate=round(prog["rate"], 4),
                                  baseline=round(median, 4))
            if self.journal:
                self.journal.perf_regression(
                    piece, wid, rate=prog["rate"], baseline=median,
                    factor=self.perf_slo_factor)
            msg = (f"SLO: piece '{pname}' on worker {wid.hex()} "
                   f"running at {prog['rate']:.2f} sim-s/s vs fleet "
                   f"median {median:.2f} (< {self.perf_slo_factor:g}x)"
                   " — perf_regression journaled")
            print(f"server: {msg}")
            self._report_clients(msg)
            self._slo_recent.append(
                {"worker": wid.hex(), "piece": pname,
                 "rate": round(prog["rate"], 4),
                 "baseline": round(median, 4)})
            # mitigation: escalate a hedge for the flagged piece (the
            # engine gates with rate limit / backoff / budget; inert
            # when disabled)
            self.mitigator.on_perf_regression(wid, piece,
                                              prog["rate"], median,
                                              now)

    def _dispatch_hedge(self, wid, piece, why):
        """Send a second copy of ``wid``'s in-flight piece to an idle
        worker (first completion wins)."""
        hwid = self.avail_workers.pop(0)
        self.inflight[hwid] = piece
        self.inflight_owner[hwid] = self.inflight_owner.get(wid, b"")
        self.inflight_t[hwid] = time.monotonic()
        self.hedge_by[wid] = hwid
        self.hedge_of[hwid] = wid
        self.hedges_started += 1
        self.recorder.instant("hedge", cat="server",
                              piece=self._piece_name(piece),
                              primary=wid.hex(), hedge=hwid.hex(),
                              why=str(why))
        prog = self.worker_progress.get(hwid)
        if prog is not None:
            prog["advance_t"] = self.inflight_t[hwid]
        if self.journal:
            self.journal.hedged(piece, wid, hwid)
        pname = self._piece_name(piece)
        msg = (f"hedging BATCH piece '{pname}': worker {wid.hex()} "
               f"{why} — speculative copy to {hwid.hex()}")
        print(f"server: {msg}")
        self._report_clients(msg)
        scentime, scencmd = piece
        self.be_event.send_multipart(
            [hwid, b"BATCH", packb({"scentime": scentime,
                                    "scencmd": scencmd})])

    def _resolve_hedge_win(self, winner, piece):
        """First completion of a hedged piece wins: count who won and
        cancel the partner's still-running copy (``BATCHCANCEL``; the
        loser acks with ``BATCHCANCELLED``, or its own completion
        arrives first and is journaled as ``dup_completed``)."""
        if winner not in self.hedge_by and winner not in self.hedge_of:
            return
        was_hedge = winner in self.hedge_of
        partner = self._drop_hedge_links(winner)
        if was_hedge:
            self.hedges_won_hedge += 1
        else:
            self.hedges_won_primary += 1
        if partner is None:
            return                         # partner already gone
        self.inflight.pop(partner, None)
        self.inflight_owner.pop(partner, None)
        self.inflight_t.pop(partner, None)
        self._cancel_pending[partner] = piece
        self.be_event.send_multipart(
            [partner, b"BATCHCANCEL", packb(None)])
        print(f"server: hedge resolved — "
              f"{'hedge' if was_hedge else 'primary'} {winner.hex()} "
              f"won '{self._piece_name(piece)}', cancelling "
              f"{partner.hex()}")

    # ---------------------------------------------------- SDC defense
    def _note_sdc_fp(self, wid, piece, data):
        """Record one execution's completion fingerprint, keyed by the
        piece's CONTENT key — redundant executions of identical content
        (hedge copies, votes, shadow audits) land in the same map and
        must agree bit-for-bit (the device fold is order-sensitive and
        deterministic for a fixed scenario)."""
        if not self.sdc_enabled:
            return
        from .journal import BatchJournal
        key = BatchJournal.piece_key(piece)
        fps = self._sdc_fps.get(key)
        if fps is None:
            fps = self._sdc_fps[key] = {}
            while len(self._sdc_fps) > 256:  # bound week-long sweeps
                self._sdc_fps.popitem(last=False)
        fps[wid.hex()] = str(data.get("fp", ""))
        self.recorder.instant("sdc_fp", cat="server", worker=wid.hex(),
                              key=key, fp=fps[wid.hex()])

    def _sdc_compare(self, piece, via="hedge_dup"):
        """Compare every fingerprint recorded for ``piece``'s content:
        a disagreement journals an audit-only ``sdc_suspect`` and (once
        per key) places the 2-of-3 tie-break re-execution."""
        if not self.sdc_enabled:
            return
        from .journal import BatchJournal
        key = BatchJournal.piece_key(piece)
        fps = self._sdc_fps.get(key) or {}
        words = {f for f in fps.values() if f}
        if len(fps) < 2 or len(words) <= 1:
            return                 # agreement, or nothing to compare
        self.sdc_suspects += 1
        pname = self._piece_name(piece)
        self.recorder.instant("sdc_suspect", cat="server", piece=pname,
                              via=via, fps=dict(fps))
        if self.journal:
            self.journal.sdc_suspect(piece, fps=fps, via=via)
        msg = ("SDC: fingerprint mismatch on piece "
               f"'{pname}' ({via}): "
               + ", ".join(f"{w[:8]}:{f}"
                           for w, f in sorted(fps.items()))
               + " — suspect journaled")
        print(f"server: {msg}")
        self._report_clients(msg)
        if key not in self._sdc_voted:
            self._dispatch_sdc_exec(piece, "vote", key)

    def _dispatch_sdc_exec(self, piece, kind, key):
        """Place a ``vote``/``audit`` re-execution of ``piece`` on an
        idle worker that has NOT already reported a word for this key
        (a repeat on the same worker would overwrite its own entry and
        can never break a tie).  The copy is journaled ``queued`` with
        ``synthetic: true`` — replay must never owe it to a resumed
        sweep — and its completion is intercepted by
        ``_finish_sdc_exec``: it NEVER journals ``completed``
        (content-addressed keys: a second completion would corrupt
        repeat-trial multiset math)."""
        fps = self._sdc_fps.get(key) or {}
        wid = next((w for w in self.avail_workers
                    if w not in self.sdc_quarantine
                    and w.hex() not in fps), None)
        if wid is None:
            print(f"server: SDC {kind} wanted for piece "
                  f"'{self._piece_name(piece)}' but no fresh idle "
                  f"worker — comparison skipped")
            return False
        self.avail_workers.remove(wid)
        self.inflight[wid] = piece
        self.inflight_owner[wid] = b""
        self.inflight_t[wid] = time.monotonic()
        prog = self.worker_progress.get(wid)
        if prog is not None:
            prog["advance_t"] = self.inflight_t[wid]
        self._sdc_execs[wid] = {"kind": kind, "key": key,
                                "piece": piece}
        if kind == "vote":
            self._sdc_voted.add(key)
        else:
            self.sdc_audits += 1
        if self.journal:
            self.journal.queued(piece, synthetic=True)
            self.journal.dispatched(piece, wid)
        pname = self._piece_name(piece)
        self.recorder.instant("sdc_exec", cat="server", kind=kind,
                              worker=wid.hex(), piece=pname)
        msg = (f"SDC: dispatching {kind} re-execution of piece "
               f"'{pname}' to worker {wid.hex()}")
        print(f"server: {msg}")
        self._report_clients(msg)
        scentime, scencmd = piece
        self.be_event.send_multipart(
            [wid, b"BATCH", packb({"scentime": scentime,
                                   "scencmd": scencmd})])
        return True

    def _finish_sdc_exec(self, wid):
        """A vote/audit re-execution left OP: resolve the comparison.
        An audit copy raises the suspect (and the vote) on mismatch; a
        vote resolves 2-of-3 — the out-voted worker is named in the
        ``sdc_vote`` record and handed to the mitigation engine for
        quarantine (its own gated ``mitigation`` record)."""
        info = self._sdc_execs.pop(wid)
        self.inflight.pop(wid, None)
        self.inflight_owner.pop(wid, None)
        self.inflight_t.pop(wid, None)
        kind, key, piece = info["kind"], info["key"], info["piece"]
        fps = dict(self._sdc_fps.get(key) or {})
        if kind == "audit":
            self._sdc_compare(piece, via="audit")
        else:
            self.sdc_votes += 1
            counts = collections.Counter(
                f for f in fps.values() if f)
            top = counts.most_common(1)
            deviants = []
            if top and top[0][1] >= 2:
                maj = top[0][0]
                deviants = sorted(w for w, f in fps.items()
                                  if f != maj)
            deviant = ",".join(deviants)
            pname = self._piece_name(piece)
            self.recorder.instant("sdc_vote", cat="server",
                                  piece=pname, fps=dict(fps),
                                  deviant=deviant)
            if self.journal:
                self.journal.sdc_vote(piece, fps=fps, deviant=deviant)
            msg = (f"SDC: vote on piece '{pname}' resolved: "
                   + ", ".join(f"{w[:8]}:{f}"
                               for w, f in sorted(fps.items()))
                   + (f" — deviant {deviant}" if deviant
                      else " — no majority (all words differ)"))
            print(f"server: {msg}")
            self._report_clients(msg)
            for dhex in deviants:
                try:
                    dwid = bytes.fromhex(dhex)
                except ValueError:
                    continue
                self.mitigator.on_sdc_deviant(
                    dwid, piece,
                    why=f"out-voted 2-of-3 fingerprint vote on "
                        f"'{pname}'")
            self._sdc_fps.pop(key, None)  # verdict reached
        # the exec worker rejoins the pool — unless the vote it just
        # completed named IT the deviant and quarantined it
        if wid not in self.avail_workers \
                and wid not in self.sdc_quarantine \
                and wid not in self.inflight \
                and self.workers.get(wid, 0) < 2:
            self.avail_workers.append(wid)
            self._send_pending_scenario()

    def _maybe_sdc_audit(self, wid, piece):
        """Deterministically sample completed fast-forward pieces for a
        shadow re-execution at ``sdc_audit_rate`` (0 = off): corruption
        that never hits a hedge duplicate still gets caught.  Wall-
        clock paced pieces are skipped — re-running one doubles its
        full wall time for a single comparison word."""
        if not self.sdc_enabled or self.sdc_audit_rate <= 0.0:
            return
        from .journal import BatchJournal
        key = BatchJournal.piece_key(piece)
        if not self._sdc_fps.get(key):
            return     # no fingerprint shipped: nothing to compare to
        prog = self.worker_progress.get(wid)
        if prog is not None and not prog.get("ff"):
            return
        self._audit_acc += min(1.0, self.sdc_audit_rate)
        if self._audit_acc < 1.0:
            return
        self._audit_acc -= 1.0
        self._dispatch_sdc_exec(piece, "audit", key)

    def sdc_payload(self):
        """Machine-readable SDC-defense state (the ``SDC`` command and
        the HEALTH ``sdc`` section), with a human ``text`` rendering —
        the HEALTH-style readback contract."""
        d = {"enabled": bool(self.sdc_enabled),
             "audit_rate": float(self.sdc_audit_rate),
             "suspects": self.sdc_suspects,
             "votes": self.sdc_votes,
             "audits": self.sdc_audits,
             "quarantined_workers": sorted(
                 w.hex() for w in self.sdc_quarantine),
             "tracked_pieces": len(self._sdc_fps),
             "pending_execs": len(self._sdc_execs)}
        d["text"] = (
            f"SDC {'ON' if d['enabled'] else 'OFF'}: "
            f"{d['suspects']} suspect(s), {d['votes']} vote(s), "
            f"{d['audits']} audit(s), "
            f"{len(d['quarantined_workers'])} worker(s) quarantined"
            + (f", audit rate {d['audit_rate']:g}"
               if d["audit_rate"] else "")
            + (" [" + ", ".join(w[:8]
                                for w in d["quarantined_workers"])
               + "]" if d["quarantined_workers"] else ""))
        return d

    def _retry_after(self, n_new):
        """Retry hint for a BATCHREJECTED: time for ``n_new`` slots to
        drain at the recently observed completion rate, else the
        settings default."""
        from .. import settings as _settings
        now = time.monotonic()
        recent = [t for t in self._completion_stamps if now - t < 60.0]
        if len(recent) >= 2 and now - recent[0] > 1e-3:
            rate = len(recent) / (now - recent[0])
            return round(min(max(n_new / rate, 1.0), 600.0), 1)
        return float(getattr(_settings, "batch_retry_after", 5.0))

    def worlds_payload(self):
        """Machine-readable world-batch state (the ``WORLDS`` command):
        packing knobs + packed-dispatch counters, with a human ``text``
        rendering — the HEALTH-style readback contract."""
        avg_fill = self._pack_fill_sum / self.world_batches \
            if self.world_batches else 0.0
        # demux latency comes from the registry histogram (windowed
        # p50/p95, not just a lifetime running mean)
        dh = self.obs.get("server_demux_ms")
        d = {"pack": bool(self.world_pack),
             "batch_max": int(self.world_batch_max),
             "world_batches": self.world_batches,
             "packed_pieces": self.packed_pieces,
             "fill_ratio": round(avg_fill, 3),
             "refused_spatial": self.worlds_refused_spatial,
             "refused_opt": self.worlds_refused_opt,
             "opt_results": self.opt_results,
             "worlds_failed": self.worlds_failed,
             "demux_events": dh.count,
             "demux_ms_avg": round(dh.mean, 3),
             "demux_ms_p50": round(dh.percentile(0.5), 3),
             "demux_ms_p95": round(dh.percentile(0.95), 3)}
        d["text"] = (
            f"WORLDS: packing {'ON' if d['pack'] else 'OFF'}, max "
            f"{d['batch_max']} pieces/dispatch; {d['world_batches']} "
            f"world-batch(es) sent carrying {d['packed_pieces']} "
            f"piece(s), fill {d['fill_ratio']:.0%}; "
            f"{d['refused_spatial']} spatial + {d['refused_opt']} "
            f"OPT/GRAD refusal(s), "
            f"{d['worlds_failed']} world failure(s); demux "
            f"{d['demux_events']} event(s), avg {d['demux_ms_avg']:.2f} "
            f"ms, p95 {d['demux_ms_p95']:.2f} ms")
        return d

    def _observe_demux(self, t0, **tags):
        """Book one demux leg: the registry histogram (windowed
        p50/p95) + a demux span on the flight-recorder timeline."""
        now = time.perf_counter()
        self.obs.get("server_demux_ms").observe((now - t0) * 1e3)
        rec = self.recorder
        if rec.enabled:
            rec.complete("demux", rec.wall_us(t0), (now - t0) * 1e6,
                         cat="server", **tags)

    def metrics_payload(self):
        """Machine-readable telemetry (the ``METRICS DUMP`` command):
        the broker's own registry plus the fleet aggregate merged from
        worker heartbeat deltas, with a human ``text`` rendering."""
        self.obs.gauge("server_queue_depth").set(len(self.scenarios))
        d = {"server": self.obs.snapshot(),
             "fleet": self.fleet.snapshot()}
        fl = self.fleet.text()
        d["text"] = ("== server ==\n" + self.obs.text()
                     + ("\n== fleet (aggregated from worker "
                        "heartbeats) ==\n" + fl
                        if len(self.fleet) else ""))
        return d

    def health_payload(self):
        """Machine-readable serving-fabric health (the ``HEALTH``
        command): queue depth and per-client split, per-worker
        in-flight piece age / heartbeat staleness / progress rate,
        hedge + admission + stream-drop counters, plus a human-
        readable ``text`` rendering."""
        now = time.monotonic()
        workers = {}
        for wid, state in self.workers.items():
            w = {"state": state,
                 "hb_age": round(now - self.last_seen.get(wid, now), 3)}
            piece = self.inflight.get(wid)
            if piece is not None:
                w["piece"] = self._piece_name(piece)
                w["piece_age"] = round(
                    now - self.inflight_t.get(wid, now), 3)
                if wid in self.hedge_of:
                    w["hedge"] = "hedge"
                elif wid in self.hedge_by:
                    w["hedge"] = "hedged"
            prog = self.worker_progress.get(wid)
            if prog is not None:
                w["simt"] = round(prog["simt"], 3)
                w["rate"] = round(prog["rate"], 4)
                w["stalled_for"] = round(now - prog["advance_t"], 3)
                if isinstance(prog.get("mesh"), dict):
                    w["mesh"] = prog["mesh"]
                if isinstance(prog.get("scan"), dict):
                    w["scan"] = prog["scan"]
                if isinstance(prog.get("fp"), dict):
                    w["fp"] = prog["fp"]
            if wid in self.sdc_quarantine:
                w["quarantined"] = True
            workers[wid.hex()] = w
        # fleet mesh summary: the most advanced epoch any worker
        # reports (after a loss that is the worker that re-formed)
        mesh = None
        for w in workers.values():
            m = w.get("mesh")
            if isinstance(m, dict) and (
                    mesh is None
                    or m.get("epoch", 0) > mesh.get("epoch", 0)):
                mesh = m
        # fleet scan summary: worst case across workers (peaks max,
        # minima min) — same reduction the worlds pack applies
        from ..obs import scanstats as _scanstats
        scan = _scanstats.merge_summaries(
            [w["scan"] for w in workers.values()
             if isinstance(w.get("scan"), dict)])
        data = {
            "queue_depth": len(self.scenarios),
            "queue_limit": self.batch_queue_max,
            "queue_by_client": {o.hex(): n for o, n in
                                self.scenarios.depth_by_owner().items()},
            "inflight": len(self.inflight),
            "avail_workers": len(self.avail_workers),
            "workers": workers,
            "hedges": {"started": self.hedges_started,
                       "won_by_hedge": self.hedges_won_hedge,
                       "won_by_primary": self.hedges_won_primary,
                       "cancelled": self.hedges_cancelled,
                       "dup_completions": self.dup_completions},
            "rejected_batches": self.rejected_batches,
            "stream_drops": self.stream_drops,
            "quarantined": len(self.quarantined),
            "straggler_timeout": self.straggler_timeout,
            "hedge_enabled": bool(self.hedge_enabled),
            "worlds": {k: v for k, v in self.worlds_payload().items()
                       if k != "text"},
            # serving SLO watch + fleet compile telemetry:
            # the fleet counters arrive merged from worker heartbeat
            # obs deltas, so HEALTH shows recompiles fleet-wide
            "perf": {
                "slo_factor": self.perf_slo_factor,
                "regressions": self.perf_regressions,
                "fleet_median_rate": self._slo_median,
                "recent": list(self._slo_recent),
                "fleet_offladder_recompiles": int(getattr(
                    self.fleet.get("devprof_cache_misses_offladder"),
                    "value", 0) or 0),
                "fleet_ladder_warmups": int(getattr(
                    self.fleet.get("devprof_cache_misses_ladder"),
                    "value", 0) or 0),
            },
        }
        if mesh is not None:
            data["mesh"] = mesh
        if scan is not None:
            data["scan"] = scan
        # mitigation section ONLY while the engine is enabled: with
        # mitigate_enabled=0 the HEALTH payload must stay bit-identical
        # to a build without the engine (the audit-only contract)
        if self.mitigator.enabled:
            data["mitigation"] = {
                k: v for k, v in self.mitigator.payload().items()
                if k != "text"}
        # SDC section ONLY while the defense is enabled (same
        # audit-only contract as mitigation: sdc_enabled=0 keeps the
        # payload bit-identical to a build without the defense)
        if self.sdc_enabled:
            data["sdc"] = {k: v for k, v in self.sdc_payload().items()
                           if k != "text"}
        # broker-HA section ONLY while HA is configured (same contract:
        # ha_standby unset keeps HEALTH bit-identical to a build
        # without the subsystem)
        if self.ha_role:
            data["ha"] = {k: v for k, v in self.ha_payload().items()
                          if k != "text"}
        # journal growth watch: size + warn flag
        if self.journal is not None:
            jb = int(self.journal.size_bytes)
            self.obs.gauge("server_journal_bytes").set(jb)
            data["journal"] = {
                "path": self.journal.path, "bytes": jb,
                "warn_bytes": self.journal_warn_bytes,
                "warn": bool(self.journal_warn_bytes
                             and jb >= self.journal_warn_bytes)}
        data["text"] = self._health_text(data)
        return data

    @staticmethod
    def _health_text(d):
        lines = [f"queue: {d['queue_depth']}"
                 + (f"/{d['queue_limit']}" if d['queue_limit'] else "")
                 + f" pending ({len(d['queue_by_client'])} client(s)), "
                 f"{d['inflight']} in flight, "
                 f"{d['avail_workers']} idle worker(s)",
                 "hedges: {started} started, {won_by_hedge} won by "
                 "hedge, {won_by_primary} by primary, {cancelled} "
                 "cancelled, {dup_completions} duplicate "
                 "completion(s)".format(**d["hedges"]),
                 f"admission: {d['rejected_batches']} BATCH submission"
                 f"(s) rejected; stream drops: {d['stream_drops']}; "
                 f"quarantined: {d['quarantined']}"]
        w = d.get("worlds")
        if w:
            lines.append(
                f"worlds: packing {'ON' if w['pack'] else 'OFF'} "
                f"(max {w['batch_max']}), {w['world_batches']} "
                f"batch(es)/{w['packed_pieces']} packed piece(s), "
                f"fill {w['fill_ratio']:.0%}, "
                f"{w['refused_spatial']} spatial + "
                f"{w['refused_opt']} OPT/GRAD refusal(s), "
                f"{w['opt_results']} OPT result(s), "
                f"demux avg {w['demux_ms_avg']:.2f} ms")
        m = d.get("mesh")
        if m:
            lines.append(
                f"mesh: epoch {m.get('epoch', 0)}, "
                f"{m.get('devices', 0)} device(s), "
                f"mode {m.get('mode', 'off')}, last refresh "
                f"{m.get('last_refresh_ms', 0):g} ms"
                + (" [DEGRADED]" if m.get("degraded") else ""))
        sc = d.get("scan")
        if sc:
            ms = sc.get("min_sep_m")
            lines.append(
                f"sim: in-scan conflicts peak {sc.get('conf_peak', 0)}"
                f"/mean {sc.get('conf_mean', 0):g}, LoS peak "
                f"{sc.get('los_peak', 0)}, min sep "
                + (f"{ms:g} m" if ms is not None else "n/a")
                + f", clamp-sat {sc.get('clamp_sat_ratio', 0):.1%}, "
                  f"occ peak {sc.get('occ_peak', 0)}")
        mi = d.get("mitigation")
        if mi:
            b = mi.get("budget", {})
            taken = sum(mi.get("actions", {}).values())
            supp = sum(mi.get("suppressed", {}).values())
            lines.append(
                f"mitigation: ON, {taken} action(s), {supp} "
                "suppressed, budget "
                + (f"{b.get('remaining')}/{b.get('total')} left"
                   if b.get("total") else "unbounded")
                + (", SHEDDING" if mi.get("shed_active") else "")
                + (", REPACKED" if mi.get("repack_active") else ""))
        s = d.get("sdc")
        if s:
            lines.append(
                f"sdc: ON, {s['suspects']} suspect(s), "
                f"{s['votes']} vote(s), {s['audits']} audit(s), "
                f"{len(s['quarantined_workers'])} worker(s) "
                "quarantined"
                + (f", audit rate {s['audit_rate']:g}"
                   if s["audit_rate"] else "")
                + (" [" + ", ".join(w[:8] for w
                                    in s["quarantined_workers"]) + "]"
                   if s["quarantined_workers"] else ""))
        h = d.get("ha")
        if h:
            lines.append(
                f"ha: {h['role'].upper()}, epoch {h['epoch']}, lease "
                f"ttl {h['lease_ttl']:g}s"
                + (f", lease age {h['lease_age']:g}s"
                   if h.get("lease_age") is not None
                   else ", no lease file")
                + f", {h['takeovers']} takeover(s), "
                  f"{h['adoptions']} adoption(s), "
                  f"{h['dedup_cancels']} dedup cancel(s)"
                + (f", {h['limbo']} in limbo" if h.get("limbo")
                   else ""))
        j = d.get("journal")
        if j:
            lines.append(
                f"journal: {j['bytes']} bytes ({j['path']})"
                + (f" — WARNING: past journal_warn_bytes "
                   f"{j['warn_bytes']}" if j["warn"] else ""))
        p = d.get("perf")
        if p:
            med = p.get("fleet_median_rate")
            lines.append(
                "perf: SLO watch "
                + (f"{p['slo_factor']:g}x median"
                   if p["slo_factor"] else "OFF")
                + f", {p['regressions']} regression record(s)"
                + (f", fleet median {med:.2f} sim-s/s"
                   if isinstance(med, (int, float)) else "")
                + f"; compiles fleet-wide: "
                  f"{p['fleet_ladder_warmups']} ladder warm-up(s), "
                  f"{p['fleet_offladder_recompiles']} off-ladder")
        for wid, w in d["workers"].items():
            line = (f"  {wid[:8]}: state {w['state']}, "
                    f"hb {w['hb_age']:.1f}s ago")
            if "piece" in w:
                line += (f", piece '{w['piece']}' "
                         f"{w['piece_age']:.1f}s in flight"
                         + (f" [{w['hedge']}]" if "hedge" in w else ""))
            if "rate" in w:
                line += (f", rate {w['rate']:g} sim-s/s, last advance "
                         f"{w['stalled_for']:.1f}s ago")
            wm = w.get("mesh")
            if isinstance(wm, dict) and wm.get("mode", "off") != "off":
                line += (f", mesh e{wm.get('epoch', 0)} "
                         f"D{wm.get('devices', 0)} {wm.get('mode')}")
            ws = w.get("scan")
            if isinstance(ws, dict) and ws.get("steps"):
                line += (f", scan conf-peak {ws.get('conf_peak', 0)}")
            wf = w.get("fp")
            if isinstance(wf, dict) and wf.get("fp"):
                line += f", fp {wf['fp']}"
            if w.get("quarantined"):
                line += " [SDC-QUARANTINED]"
            lines.append(line)
        return "\n".join(lines)

    def _replay_journal(self):
        """--resume-batch: rebuild the sweep from the journal —
        completed pieces stay done (exactly-once), pieces in flight at
        crash time are requeued, quarantine decisions (and their
        client-visible reports) persist, crash counters carry over so
        a poison pill cannot reset its strikes by killing the server."""
        from .journal import BatchJournal
        try:
            state = BatchJournal.replay(self.resume_journal)
        except OSError as e:
            print(f"server: --resume-batch {self.resume_journal}: {e}")
            return
        for piece in state["quarantined"]:
            self.quarantined.append(piece)
            self.quarantine_reports.append(
                {"piece": self._piece_name(piece),
                 "crashes": state["quarantined_crashes"].get(
                     BatchJournal.piece_key(piece), 0),
                 "scencmd": list(piece[1]), "resumed": True})
        for piece in state["pending"]:
            jkey = BatchJournal.piece_key(piece)
            if jkey in state["crashes"]:
                self.piece_crashes[self._piece_key(piece)] = \
                    state["crashes"][jkey]
        self.scenarios.extend(state["pending"])
        if self.journal:
            self.journal.append("resumed",
                                pending=len(state["pending"]),
                                completed=len(state["completed"]),
                                quarantined=len(state["quarantined"]))
        print(f"server: resumed BATCH journal {self.resume_journal}: "
              f"{len(state['pending'])} piece(s) requeued, "
              f"{len(state['completed'])} already complete, "
              f"{len(state['quarantined'])} quarantined"
              + (f", {state['torn_lines']} torn line(s) skipped"
                 if state["torn_lines"] else ""))
        if self.scenarios and self.spawn_workers:
            self._spawn_for_backlog()

    # ------------------------------------------------- liveness / chaining
    def _reap_dead_workers(self):
        """PING registered workers and bury the dead: a spawned child
        whose process exited, or any worker silent past hb_timeout.
        The dead worker's in-flight piece is requeued and (for crashed
        children) a replacement is spawned."""
        now = time.monotonic()
        dead = []
        for wid in list(self.workers):
            proc = self.spawned.get(wid)
            # A worker mid-BATCH may be stuck in a long device chunk or
            # a first kernel build or graph capture without a
            # chance to pump events — give busy workers
            # hb_busy_multiplier x the silence budget before declaring
            # a pong-based death (process exit stays immediate for
            # spawned children).
            budget = self.hb_timeout * (
                self.hb_busy_multiplier if wid in self.inflight
                or self.workers.get(wid, 0) >= 2 else 1.0)
            if proc is not None and proc.poll() is not None:
                dead.append(wid)           # child exited without goodbye
            elif proc is None and now - self.last_seen.get(wid, now) \
                    > budget:
                dead.append(wid)           # external worker went silent
            else:
                self.be_event.send_multipart([wid, b"PING", packb(now)])
        # Spawned children that died BEFORE ever registering (startup
        # crash: import error, OOM) would otherwise leak their pending-
        # spawn slot and shrink the headroom forever.
        for wid, proc in list(self.spawned.items()):
            if wid not in self.workers and proc.poll() is not None:
                self.spawned.pop(wid, None)
                self._pending_spawns = max(0, self._pending_spawns - 1)
                print(f"server: spawned worker {wid.hex()} died before "
                      f"registering (exit {proc.returncode})")
                if self.restart_crashed and self.scenarios:
                    self._spawn_for_backlog(1)
        for wid in dead:
            print(f"server: worker {wid.hex()} died — "
                  f"{'requeueing piece, ' if wid in self.inflight else ''}"
                  f"removing from pool")
            self.workers.pop(wid, None)
            self.spawned.pop(wid, None)
            self.last_seen.pop(wid, None)
            if wid in self.avail_workers:
                self.avail_workers.remove(wid)
            self._requeue_lost_piece(wid)
            if self.restart_crashed and self.spawn_workers:
                self._spawn_for_backlog(1)
            while self.avail_workers and self.scenarios:
                self._send_pending_scenario()
        if dead:
            self._nodeschanged()

    def _handle_link(self, frames):
        """Events arriving over the upstream link (we are a client of
        the upstream server there)."""
        route, name, payload = split_envelope(frames)
        data = unpackb(payload) if payload else None
        if not route and name in (b"REGISTER", b"NODESCHANGED"):
            # upstream node table: mirror it to our clients with the
            # upstream as the routing hop (server.py:213-225)
            self.link_id = data["host_id"]
            self.remote_nodes = {bytes(nid): self.link_id
                                 for nid in data["nodes"]
                                 if bytes(nid) not in self.workers}
            self._nodeschanged()
        elif route:
            # reply/event for one of our endpoints: forward with the
            # upstream as the accumulated sender hop
            self._forward(self.link_id or b"", route, name, payload)

    # ------------------------------------------------------------ main loop
    def run(self):
        self.fe_event.bind(f"tcp://*:{self.ports['event']}")
        self.fe_stream.bind(f"tcp://*:{self.ports['stream']}")
        self.be_event.bind(f"tcp://*:{self.ports['wevent']}")
        self.be_stream.bind(f"tcp://*:{self.ports['wstream']}")
        poller = zmq.Poller()
        for sock in (self.fe_event, self.fe_stream, self.be_event,
                     self.be_stream):
            poller.register(sock, zmq.POLLIN)
        if self.discovery:
            poller.register(self.discovery.handle, zmq.POLLIN)
        if self.upstream:
            ctx = zmq.Context.instance()
            self.link = ctx.socket(zmq.DEALER)
            self.link.setsockopt(zmq.IDENTITY, self.server_id)
            self.link.setsockopt(zmq.LINGER, 0)
            self.link.connect(
                f"tcp://{self.upstream[0]}:{self.upstream[1]}")
            self.link.send_multipart([b"REGISTER", packb(None)])
            poller.register(self.link, zmq.POLLIN)
        self.running = not self._stop_requested
        if self.ha_role == "leader":
            # journal-fenced leadership: the lease record must precede
            # every sweep record this leader writes (resume included)
            self._ha_acquire()
        if self.resume_journal:
            self._replay_journal()
        if not self.headless:
            self.addnodes(1)
        while self.running:
            events = dict(poller.poll(100))
            now = time.monotonic()
            if self.ha_role:
                if self._ha_serving:
                    if now >= self._ha_next_renew:
                        self._ha_renew(now)
                    if self._ha_limbo and now >= self._ha_grace_until:
                        self._ha_release_limbo()
                elif now >= self._ha_next_poll:
                    self._ha_next_poll = now + self.ha_poll_dt
                    self._ha_standby_poll(now)
            if now >= self._next_hb:
                self._next_hb = now + self.hb_interval
                if self._ha_serving:
                    # a standby only WATCHES: reaping, hedging, SLO and
                    # mitigation resume on the new leader's first tick
                    self._reap_dead_workers()
                    self._check_stragglers(now)
                    self._check_perf_slo(now)
                    self.mitigator.tick(now)
                self.obs.gauge("server_queue_depth").set(
                    len(self.scenarios))
                if self.journal is not None:
                    self.obs.gauge("server_journal_bytes").set(
                        int(self.journal.size_bytes))
                self.obs.maybe_export()
            if self.link is not None and self.link in events:
                try:
                    self._handle_link(self.link.recv_multipart())
                except Exception as exc:
                    print(f"server: dropped malformed link message: "
                          f"{exc!r}")
            if self.be_stream in events:
                frames = self.be_stream.recv_multipart()
                try:
                    # NOBLOCK + XPUB_NODROP: a subscriber at its HWM
                    # (stalled GUI) surfaces as EAGAIN instead of a
                    # silent, uncountable per-peer drop
                    self.fe_stream.send_multipart(frames,
                                                  flags=zmq.NOBLOCK)
                except zmq.Again:
                    # count the drop, then re-send with the lossy flag
                    # temporarily restored: the saturated peer ALONE
                    # misses the frame — healthy subscribers must not
                    # go dark because one GUI stalled
                    self.stream_drops += 1
                    self.fe_stream.setsockopt(zmq.XPUB_NODROP, 0)
                    try:
                        self.fe_stream.send_multipart(
                            frames, flags=zmq.NOBLOCK)
                    except zmq.Again:
                        pass
                    finally:
                        self.fe_stream.setsockopt(zmq.XPUB_NODROP, 1)
            if self.fe_stream in events:    # subscription propagation
                self.be_stream.send_multipart(
                    self.fe_stream.recv_multipart())
            if self.discovery and (self.discovery.handle in events
                                   or self.discovery.handle.fileno()
                                   in events):
                kind, _ = self.discovery.recv_reqreply()
                if kind == "req":
                    if self.ha_role:
                        # HA arbitration: replies carry epoch + role so
                        # peers prefer the live leader over a deposed
                        # one (highest epoch) and skip warm standbys
                        self.discovery.send_reply(
                            self.ports["event"], self.ports["stream"],
                            epoch=self.ha_epoch,
                            role="leader" if self._ha_serving
                            else "standby",
                            # failed-over WORKERS must land on the
                            # worker-facing ROUTER, not the client one
                            wevent=self.ports["wevent"],
                            wstream=self.ports["wstream"])
                    else:
                        self.discovery.send_reply(self.ports["event"],
                                                  self.ports["stream"])
            for sock in (self.fe_event, self.be_event):
                if sock not in events:
                    continue
                frames = sock.recv_multipart()
                # a malformed message from one peer must not kill the broker
                try:
                    sender, rest = frames[0], frames[1:]
                    if sock is self.be_event:
                        self.last_seen[sender] = now   # any traffic counts
                    route, name, payload = split_envelope(rest)
                    if route:
                        self._forward(sender, route, name, payload)
                    else:
                        self._handle_server_event(sock, sender, name,
                                                  payload)
                except Exception as exc:
                    print(f"server: dropped malformed message: {exc!r}")
        # shutdown: tell workers to quit (covers stop() as well as the
        # client-QUIT path), then wait for them (server.py:311-317)
        for wid in self.workers:
            self.be_event.send_multipart([wid, b"QUIT", packb(None)])
        for proc in self.processes:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
        if self.journal:
            # clean-exit marker; queued-but-unfinished pieces stay
            # pending in the journal, so --resume-batch still works
            # after an orderly preemption shutdown
            self.journal.shutdown()
            self.journal.close()
        for sock in (self.fe_event, self.fe_stream, self.be_event,
                     self.be_stream):
            sock.close()
        if self.link is not None:
            self.link.close()
        if self.discovery:
            self.discovery.close()
