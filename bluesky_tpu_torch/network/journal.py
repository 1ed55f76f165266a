"""Crash-resumable BATCH journal: an append-only JSONL write-ahead log
(port of ``bluesky_tpu/network/journal.py``: the same calls write the
same bytes, and each package's ``replay`` reads the other's files).

The server's sweep state (``scenarios``/``inflight``/``piece_crashes``/
``quarantined`` in server.py) is in-memory; without a WAL a server crash
or preemption loses a multi-hour sweep.  Every state transition of a
BATCH piece is journaled BEFORE/AS it happens, and ``--resume-batch
<journal>`` replays the log on restart to rebuild the queue with
exactly-once completion semantics: completed pieces are not re-run,
pieces in flight at crash time are requeued, quarantine decisions
persist.

Record types (one JSON object per line, ``rec`` selects the type):

  ``queued``      {key, scentime, scencmd}  piece entered the queue (the
                                            only record carrying the
                                            full piece, so the journal
                                            alone can rebuild it)
  ``dispatched``  {key, worker}             piece handed to a worker
  ``completed``   {key, worker}             piece finished cleanly
  ``crashed``     {key, crashes}            piece lost its worker (one
                                            circuit-breaker strike)
  ``quarantined`` {key, piece, crashes}     circuit-broken: never requeue
  ``preempted``   {key, worker}             worker preempted mid-piece:
                                            requeue WITHOUT a strike
  ``mesh_lost``   {key, worker, epoch, lost}  a device group of the
                                            worker's sharded mesh died
                                            mid-piece (audit; if the
                                            worker could not recover the
                                            piece is requeued WITHOUT a
                                            strike, PREEMPTED-style)
  ``resharded``   {key, worker, epoch, ndev, mode}  the worker re-formed
                                            a survivor mesh and resumed
                                            the SAME piece from its last
                                            checksummed snapshot — audit
                                            only, queue math ignores it
  ``hedged``      {key, worker, hedge_worker}  speculative straggler
                                            re-dispatch: a SECOND copy
                                            of an in-flight piece went
                                            to ``hedge_worker`` (first
                                            completion wins)
  ``dup_completed`` {key, worker}           the hedge LOSER also finished
                                            after the winner's
                                            ``completed``: recorded for
                                            audit, NOT counted as a
                                            completion (a repeat-trial
                                            sweep queueing identical
                                            content twice must not have
                                            its second copy consumed by
                                            a hedge duplicate)
  ``opt_result``  {key, worker, result}     trajectory-optimization
                                            output of an OPT piece
                                            (diff/optimize.py: offsets,
                                            objective trace, hard-LoS
                                            before/after, guard word) —
                                            audit only, queue math
                                            ignores it
  ``perf_regression`` {key, worker, rate, baseline, factor}  serving
                                            SLO watch: an
                                            in-flight piece's rolling
                                            steps/s fell below
                                            ``perf_slo_factor`` x the
                                            fleet median — audit only,
                                            queue math/exactly-once
                                            unaffected; surfaced by
                                            replay for inspection
  ``mitigation``  {cause, signal, action, target, outcome}  the
                                            mitigation engine
                                            (network/mitigate.py) acted
                                            on a sentinel signal —
                                            hedge escalation, load
                                            shed/unshed, re-pack,
                                            accept-degraded.  AUDIT
                                            only: queue math and
                                            exactly-once never see it;
                                            replay surfaces the history
                                            under ``mitigations``.  May
                                            carry a piece ``key`` when
                                            the action targets one
                                            piece; shed/repack actions
                                            have none.
  ``sdc_suspect``  {key, fps, via}          SDC defense: two
                                            executions of the same piece
                                            reported DIFFERENT state
                                            fingerprints (``via`` names
                                            the comparison — hedge_dup
                                            or audit).  AUDIT only:
                                            queue math and exactly-once
                                            never see it; replay
                                            surfaces it under ``sdc``.
  ``sdc_vote``     {key, fps, deviant}      the 2-of-3 tie-break
                                            re-execution resolved: the
                                            fingerprint map names the
                                            deviant worker (hex id, or
                                            null when all three
                                            disagreed).  AUDIT only,
                                            surfaced under ``sdc``; the
                                            quarantine that follows is
                                            its own gated ``mitigation``
                                            record (action
                                            ``quarantine_worker``).
  ``device_profile`` {worker, dir, chunks}  PROFILE DEVICE window: the
                                            trace dir a worker
                                            captured (audit; links the
                                            journal to the Perfetto
                                            merge)
  ``lease``       {leader, epoch, ttl}      broker-HA leadership change
                                            (network/ha.py): ``leader``
                                            (server hex id) acquired
                                            lease ``epoch``.  Replay
                                            tracks the epoch in force
                                            positionally; records a
                                            writer appends after losing
                                            the lease are FENCED (see
                                            ``wepoch`` below).
  ``adopted``     {key, worker}             broker-HA failover: the new
                                            leader matched a replayed
                                            owed copy against a
                                            surviving worker's
                                            re-REGISTER in-flight
                                            report — the piece keeps
                                            running where it is (no
                                            requeue, no breaker strike;
                                            the PREEMPTED model
                                            generalized).  AUDIT only:
                                            the copy stays owed until
                                            its own ``completed``.
  ``resumed``     {pending, completed, quarantined}  replay marker
  ``shutdown``    {}                        clean server exit

Writer epochs (broker HA, network/ha.py): when a server holds an HA
lease it stamps every record it appends with ``wepoch`` (its lease
epoch — a distinct field from the MESH ``epoch`` that mesh_lost/
resharded already carry).  Replay folds the file positionally: a
``lease`` record raises the epoch in force, and any LATER
``dispatched``/``completed`` stamped with an older ``wepoch`` is a
deposed leader's late append — fenced off as audit-only (counted
under ``fenced``, never into the queue math) so a non-atomic
leadership handover cannot double-count or lose work.  Journals from
servers without HA carry no ``wepoch`` and replay exactly as before.

Packed world-batches (WORLDS packing, network/server.py): a pack of W
compatible pieces dispatches to ONE worker; its ``dispatched`` records
carry ``world`` (index in the pack) and ``pack`` (pack size), and each
per-world completion journals its OWN ``completed`` record (``world``
audit field) as the worker's BATCHWORLD events arrive.  Replay needs no
pack awareness: owed copies stay queued-minus-completed per content
key, so a crash mid-pack requeues exactly the worlds whose pieces never
completed.

Synthetic pieces (the ``FAULT LOADSPIKE`` chaos injector): their
``queued`` records carry ``synthetic: true`` and replay SKIPS them —
load-spike filler exercises admission/shedding but must never be owed
to a resumed sweep, so exactly-once accounting ignores the whole
lifecycle of a synthetic key (its dispatched/completed records fall
through the unknown-key filter).

Piece identity is content-addressed (sha256 over the canonical JSON of
``(scentime, scencmd)``), so keys are stable across restarts and across
servers.

Append atomicity: each record is ONE ``write()`` of a single line,
flushed (+ ``fsync`` unless ``batch_journal_fsync`` is off), so a crash
can only tear the final line — ``replay`` skips unparseable tails
instead of failing.  A whole BATCH submission's ``queued`` records
share one flush+fsync (``queued_many``): the WAL guarantee only needs
the batch durable before any dispatch.  A journal write failure (disk
full) disables the journal with a warning; it must never take the
broker down with it.
"""
import hashlib
import json
import os


class BatchJournal:
    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = bool(fsync)
        self._f = None
        self._dead = False        # set after a write failure
        self._bytes = 0           # WAL size incl. pre-resume content
        # broker-HA writer epoch (network/ha.py): None = HA off, no
        # stamping — journals stay byte-identical to a non-HA server's
        self.epoch = None

    @property
    def size_bytes(self) -> int:
        """Current WAL size in bytes (existing file at open + every
        line appended since) — the ``journal_bytes`` gauge's source, so
        HEALTH can warn before an unbounded sweep fills the disk."""
        return self._bytes

    # ------------------------------------------------------------ identity
    @staticmethod
    def piece_key(piece) -> str:
        """Content-addressed piece id, stable across restarts."""
        scentime, scencmd = piece
        blob = json.dumps([[float(t) for t in scentime],
                           [str(c) for c in scencmd]],
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]

    # ------------------------------------------------------------- writing
    def _open(self):
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # heal a crash-torn tail: if the existing file does not end
            # in a newline, the next append would glue onto the torn
            # line and be lost to replay — terminate it first so "a
            # crash can only tear the final line" stays true across
            # resumes
            try:
                with open(self.path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        with open(self.path, "ab") as fa:
                            fa.write(b"\n")
            except (OSError, ValueError):
                pass                      # absent or empty file
            try:
                self._bytes = os.path.getsize(self.path)
            except OSError:
                self._bytes = 0
            self._f = open(self.path, "a", encoding="utf-8")
        return self._f

    def _write(self, records):
        if self._dead or not records:
            return
        from ..obs.trace import get_recorder
        try:
            with get_recorder().span("journal_append", cat="server",
                                     nrecords=len(records),
                                     rec=records[0].get("rec", "?"),
                                     fsync=self.fsync):
                f = self._open()
                for r in records:
                    if self.epoch is not None:
                        r.setdefault("wepoch", int(self.epoch))
                    line = json.dumps(r, separators=(",", ":")) + "\n"
                    f.write(line)
                    self._bytes += len(line.encode("utf-8"))
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
        except OSError as e:
            self._dead = True
            print(f"batch journal: disabled after write failure "
                  f"({self.path}: {e})")

    def append(self, rec: str, **fields):
        self._write([dict(rec=rec, **fields)])

    @classmethod
    def _queued_rec(cls, piece, synthetic=False):
        scentime, scencmd = piece
        rec = dict(rec="queued", key=cls.piece_key(piece),
                   scentime=[float(t) for t in scentime],
                   scencmd=[str(c) for c in scencmd])
        if synthetic:
            # chaos filler (FAULT LOADSPIKE): replay must never owe it
            rec["synthetic"] = True
        return rec

    def queued(self, piece, synthetic=False):
        self._write([self._queued_rec(piece, synthetic)])

    def queued_many(self, pieces, synthetic=False):
        """Journal a whole BATCH submission with ONE flush+fsync — the
        WAL guarantee only needs the batch on disk before any dispatch,
        and per-piece fsyncs would stall the broker poll loop for large
        sweeps."""
        self._write([self._queued_rec(p, synthetic) for p in pieces])

    def dispatched(self, piece, worker: bytes = b"", world=None,
                   pack=None):
        """``world``/``pack`` mark a piece dispatched INSIDE a packed
        world-batch (world index, pack size) — audit detail only:
        replay folds packed pieces exactly like solo ones (queued minus
        completed per content key)."""
        rec = dict(key=self.piece_key(piece), worker=worker.hex())
        if world is not None:
            rec.update(world=int(world), pack=int(pack or 0))
        self.append("dispatched", **rec)

    def completed(self, piece, worker: bytes = b"", world=None):
        rec = dict(key=self.piece_key(piece), worker=worker.hex())
        if world is not None:
            rec["world"] = int(world)
        self.append("completed", **rec)

    def crashed(self, piece, crashes: int):
        self.append("crashed", key=self.piece_key(piece),
                    crashes=int(crashes))

    def quarantined(self, piece, crashes: int):
        self.append("quarantined", key=self.piece_key(piece),
                    crashes=int(crashes))

    def preempted(self, piece, worker: bytes = b"", world=None):
        rec = dict(key=self.piece_key(piece), worker=worker.hex())
        if world is not None:
            rec["world"] = int(world)
        self.append("preempted", **rec)

    def mesh_lost(self, piece, worker: bytes = b"", world=None,
                  epoch=None, lost=None):
        """A device group of the worker's sharded mesh died mid-piece.
        Audit record: queue math ignores it — an unrecovered loss also
        requeues the piece (push_front, no strike), and replay already
        counts that via queued - completed."""
        rec = dict(key=self.piece_key(piece), worker=worker.hex())
        if world is not None:
            rec["world"] = int(world)
        if epoch is not None:
            rec["epoch"] = int(epoch)
        if lost is not None:
            rec["lost"] = list(lost)
        self.append("mesh_lost", **rec)

    def resharded(self, piece, worker: bytes = b"", world=None,
                  epoch=None, ndev=None, mode=None):
        """The worker re-formed a survivor mesh (new epoch) and resumed
        the SAME piece from its last checksummed snapshot.  Audit only."""
        rec = dict(key=self.piece_key(piece), worker=worker.hex())
        if world is not None:
            rec["world"] = int(world)
        if epoch is not None:
            rec["epoch"] = int(epoch)
        if ndev is not None:
            rec["ndev"] = int(ndev)
        if mode is not None:
            rec["mode"] = str(mode)
        self.append("resharded", **rec)

    def hedged(self, piece, worker: bytes = b"",
               hedge_worker: bytes = b""):
        self.append("hedged", key=self.piece_key(piece),
                    worker=worker.hex(),
                    hedge_worker=hedge_worker.hex())

    def dup_completed(self, piece, worker: bytes = b""):
        self.append("dup_completed", key=self.piece_key(piece),
                    worker=worker.hex())

    def opt_result(self, piece, worker: bytes = b"", result=None):
        """Trajectory-optimization result of an OPT piece
        (diff/optimize.OptResult.to_payload: optimized offsets,
        objective trace, hard-LoS before/after, guard word).  AUDIT
        data: replay surfaces it under ``opt_results`` but the queue
        math ignores it (the piece's own ``completed`` record still
        governs exactly-once)."""
        self.append("opt_result", key=self.piece_key(piece),
                    worker=worker.hex(),
                    result=result if isinstance(result, dict) else None)

    def perf_regression(self, piece, worker: bytes = b"", rate=None,
                        baseline=None, factor=None):
        """Serving SLO watch: a worker's rolling per-piece
        progress rate dropped below ``perf_slo_factor`` x the fleet
        median.  AUDIT record — the piece stays in flight (hedging,
        not this record, is the mitigation) and replay's queue math
        ignores it; surfaced under ``perf_regressions``."""
        rec = dict(key=self.piece_key(piece), worker=worker.hex())
        if rate is not None:
            rec["rate"] = round(float(rate), 4)
        if baseline is not None:
            rec["baseline"] = round(float(baseline), 4)
        if factor is not None:
            rec["factor"] = float(factor)
        self.append("perf_regression", **rec)

    def mitigation(self, cause="", signal="", action="", target="",
                   outcome="", piece=None, worker: bytes = b""):
        """The mitigation engine (network/mitigate.py) took an action
        on a sentinel signal.  AUDIT record — replay surfaces the
        decision history under ``mitigations`` but the queue math and
        exactly-once accounting never see it.  ``piece`` (when the
        action targets one piece, e.g. a hedge escalation) adds the
        content key so the decision links to the piece's lifecycle."""
        rec = dict(cause=str(cause), signal=str(signal),
                   action=str(action), target=str(target),
                   outcome=str(outcome))
        if piece is not None:
            rec["key"] = self.piece_key(piece)
        if worker:
            rec["worker"] = worker.hex()
        self.append("mitigation", **rec)

    def sdc_suspect(self, piece, fps=None, via=""):
        """SDC defense: redundant executions of one piece
        disagreed on their state fingerprints.  ``fps`` maps worker hex
        id -> fingerprint hex word; ``via`` names the comparison that
        caught it (``hedge_dup`` — winner vs hedge loser — or ``audit``
        — original vs shadow re-execution).  AUDIT record: the piece's
        queue state is untouched (the winner's ``completed`` stands
        until a vote says otherwise); replay surfaces it under
        ``sdc``."""
        self.append("sdc_suspect", key=self.piece_key(piece),
                    fps=dict(fps or {}), via=str(via))

    def sdc_vote(self, piece, fps=None, deviant=""):
        """The 2-of-3 tie-break re-execution of a suspect piece
        resolved: ``fps`` holds all three fingerprints and ``deviant``
        the out-voted worker's hex id ('' when no majority formed —
        three distinct words name nobody).  AUDIT only, surfaced under
        ``sdc``; quarantine is the mitigation engine's own record."""
        self.append("sdc_vote", key=self.piece_key(piece),
                    fps=dict(fps or {}), deviant=str(deviant))

    def lease(self, leader="", epoch=0, ttl=0.0):
        """Broker-HA leadership acquisition (network/ha.py): ``leader``
        (server hex id) now holds lease ``epoch``.  The durable half of
        the lease file — replay uses it to fence a deposed leader's
        late appends (see the ``wepoch`` notes in the module
        docstring)."""
        self.append("lease", leader=str(leader), epoch=int(epoch),
                    ttl=float(ttl))

    def adopted(self, piece, worker: bytes = b""):
        """Broker-HA failover reconciliation: the new leader matched a
        replayed owed copy of this piece against ``worker``'s in-flight
        re-REGISTER report — the piece keeps running where it is.
        AUDIT record: no requeue, no strike, and the copy stays owed
        until its own ``completed`` lands."""
        self.append("adopted", key=self.piece_key(piece),
                    worker=worker.hex())

    def device_profile(self, worker: bytes = b"", dir="", chunks=None):
        """A worker opened a PROFILE DEVICE window: journal the
        trace dir so the sweep's record links to the captured trace.
        Audit only (no piece key — the window is per-worker)."""
        rec = dict(worker=worker.hex(), dir=str(dir))
        if chunks is not None:
            rec["chunks"] = int(chunks)
        self.append("device_profile", **rec)

    def shutdown(self):
        # clean-exit marker — only if this run ever journaled anything
        # (a server that never saw a BATCH must not litter log_path
        # with marker-only files)
        if self._f is not None:
            self.append("shutdown")

    def close(self):
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    # ------------------------------------------------------------- replay
    @staticmethod
    def replay(path: str, fence_strict: bool = True) -> dict:
        """Fold a journal into the queue state a restarted server needs.

        Returns a dict with ``pending`` (pieces to requeue, in original
        queue order — includes pieces that were dispatched/preempted/
        crashed but never completed), ``completed``, ``quarantined``
        piece lists, ``crashes``/``quarantined_crashes`` (journal key ->
        strike count) and ``torn_lines`` (unparseable records skipped —
        a crash mid-append can only tear the final line).  Raises
        ``OSError`` if the journal cannot be read at all.

        Keys are content-addressed, so a sweep that deliberately
        repeats an identical piece (repeat trials) shares one key
        across copies: replay uses MULTISET semantics — pending copies
        of a key = queued count - completed count — so N submissions
        still yield N runs.  Quarantine applies to the content (a
        poison piece is poison for every copy).

        Broker HA (network/ha.py): ``lease`` records raise the epoch in
        force positionally; a later ``dispatched``/``completed`` whose
        ``wepoch`` is older is a deposed leader's late append, counted
        under ``fenced`` and — with ``fence_strict`` (the default,
        settings.ha_fence_strict) — kept OUT of the queue math.
        ``fence_strict=False`` still surfaces the count but lets stale
        completions stand (forensic escape hatch: trust a deposed
        leader's work anyway).  The highest epoch/leader seen and the
        lease history come back under ``ha``.
        """
        pieces, order = {}, []
        n_queued, n_completed = {}, {}
        quarantined_keys = set()
        crashes, qcrashes = {}, {}
        opt_results = []
        perf_regressions = []
        mitigations = []
        sdc = dict(suspects=[], votes=[], quarantines=[])
        synthetic = 0
        torn = 0
        cur_epoch, leader = None, ""   # HA epoch in force (positional)
        leases = []
        fenced = 0
        # errors="replace": disk-level byte corruption must surface as
        # skipped torn lines, not a UnicodeDecodeError that escapes the
        # resume path's OSError handling
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    torn += 1
                    continue
                rec, key = r.get("rec"), r.get("key")
                # a record stamped with a writer epoch older than the
                # lease in force at this POINT of the file is a deposed
                # leader's late append (see module docstring)
                wep = r.get("wepoch")
                stale = (cur_epoch is not None and isinstance(wep, int)
                         and wep < cur_epoch)
                if rec == "lease":
                    ep = r.get("epoch")
                    if isinstance(ep, int) and \
                            (cur_epoch is None or ep >= cur_epoch):
                        cur_epoch = ep
                        leader = str(r.get("leader", ""))
                    leases.append({"leader": str(r.get("leader", "")),
                                   "epoch": ep,
                                   "ttl": r.get("ttl")})
                elif rec == "queued" and key:
                    if r.get("synthetic"):
                        # LOADSPIKE chaos filler: never owed to a
                        # resumed sweep — skipping the queued record
                        # makes the key unknown, so the copy's later
                        # dispatched/completed records fall through
                        # the unknown-key filter below too
                        synthetic += 1
                        continue
                    if key not in pieces:
                        order.append(key)
                    pieces[key] = (list(r.get("scentime", [])),
                                   list(r.get("scencmd", [])))
                    n_queued[key] = n_queued.get(key, 0) + 1
                elif rec == "mitigation":
                    # mitigation-engine decision (audit; surfaced even
                    # keyless — shed/repack actions target no piece)
                    m = {"key": key, "cause": r.get("cause", ""),
                         "signal": r.get("signal", ""),
                         "action": r.get("action", ""),
                         "target": r.get("target", ""),
                         "outcome": r.get("outcome", "")}
                    mitigations.append(m)
                    if m["action"] == "quarantine_worker":
                        # the SDC defense's actuation — cross-listed
                        # under ``sdc`` next to the suspicion/vote
                        # records that led to it
                        sdc["quarantines"].append(m)
                elif rec == "sdc_suspect":
                    # fingerprint mismatch (audit; surfaced BEFORE the
                    # unknown-key filter like mitigation — a suspect
                    # raised by a synthetic shadow audit still matters
                    # to the auditor even though its key is unowed)
                    sdc["suspects"].append(
                        {"key": key, "fps": r.get("fps", {}),
                         "via": r.get("via", "")})
                elif rec == "sdc_vote":
                    sdc["votes"].append(
                        {"key": key, "fps": r.get("fps", {}),
                         "deviant": r.get("deviant", "")})
                elif key not in pieces:
                    continue              # marker records / unknown key
                elif stale and rec in ("dispatched", "completed"):
                    # FENCED: a deposed leader's late append — surfaced
                    # for audit, kept out of the queue math (unless the
                    # fence_strict escape hatch says to trust it)
                    fenced += 1
                    if rec == "completed" and not fence_strict:
                        n_completed[key] = n_completed.get(key, 0) + 1
                        crashes.pop(key, None)
                elif rec in ("dispatched", "preempted", "hedged",
                             "dup_completed", "mesh_lost", "resharded",
                             "adopted"):
                    # owed copies = queued - completed.  A hedge is a
                    # duplicate of an already-dispatched copy, and a
                    # dup_completed is the hedge loser finishing after
                    # the winner — counting either as a dispatch or a
                    # completion would break exactly-once for repeat-
                    # trial sweeps (identical content queued N times).
                    # mesh_lost/resharded likewise narrate one copy's
                    # mesh-epoch transitions, never its queue state;
                    # adopted narrates a failover reconciliation (the
                    # copy stays owed until its own completed lands).
                    pass
                elif rec == "crashed":
                    crashes[key] = int(r.get("crashes",
                                             crashes.get(key, 0) + 1))
                elif rec == "completed":
                    n_completed[key] = n_completed.get(key, 0) + 1
                    crashes.pop(key, None)
                elif rec == "quarantined":
                    quarantined_keys.add(key)
                    qcrashes[key] = int(r.get("crashes", 0))
                    crashes.pop(key, None)
                elif rec == "opt_result":
                    # audit record of an OPT piece's optimization output
                    # — surfaced for inspection, ignored by queue math
                    opt_results.append({"key": key,
                                        "result": r.get("result")})
                elif rec == "perf_regression":
                    # serving SLO-watch audit record — the
                    # piece's queue state is untouched (exactly-once
                    # stays queued-minus-completed); surfaced so a
                    # resumed sweep can see which pieces ran slow
                    perf_regressions.append(
                        {"key": key, "worker": r.get("worker", ""),
                         "rate": r.get("rate"),
                         "baseline": r.get("baseline")})

        def owed(k):
            if k in quarantined_keys:
                return 0
            return max(0, n_queued.get(k, 0) - n_completed.get(k, 0))

        return dict(
            pending=[pieces[k] for k in order for _ in range(owed(k))],
            completed=[pieces[k] for k in order
                       for _ in range(min(n_queued.get(k, 0),
                                          n_completed.get(k, 0)))],
            quarantined=[pieces[k] for k in order
                         if k in quarantined_keys],
            crashes={k: c for k, c in crashes.items() if owed(k) > 0},
            quarantined_crashes=qcrashes,
            opt_results=opt_results,
            perf_regressions=perf_regressions,
            mitigations=mitigations,
            sdc=sdc,
            synthetic_skipped=synthetic,
            torn_lines=torn,
            fenced=fenced,
            ha=dict(epoch=cur_epoch, leader=leader, leases=leases),
        )
