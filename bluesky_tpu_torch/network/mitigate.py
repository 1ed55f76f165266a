"""Self-healing serving: the mitigation policy engine (port of
``bluesky_tpu/network/mitigate.py``).

The fabric has a sensing stack — fleet metric registry, serving
SLO watch, straggler detector, mesh-epoch guard, memory watermarks —
but every actuator was still a human typing a stack command.  This
module closes the loop: a policy engine on the server's health tick
maps structured sentinel signals to the actuators the fabric already
has.

Signals -> actions (docs/FAULT_TOLERANCE.md has the recovery matrix):

  ``perf_regression``   SLO watch flagged an in-flight piece running
                        far below the fleet median  -> escalate a
                        speculative hedge for THAT piece
  ``straggler``         flat progress past straggler_timeout with
                        hedging disabled               -> hedge anyway
  ``mesh_degraded``     a worker re-formed a survivor mesh below its
                        full device count  -> accept the degraded
                        epoch (piece continues; no requeue churn)
  ``queue_pressure``    pending depth past mitigate_shed_hi x the
                        admission limit  -> shed load (tighten
                        batch_queue_max so floods get drain-rate-
                        informed BATCHREJECTED hints); restore only
                        below mitigate_shed_lo (hysteresis)
  ``mem_watermark``     fleet live-bytes watermark past mitigate_mem_hi
                        x the budget  -> re-pack (shrink
                        world_batch_max for the next packs); restore
                        below mitigate_mem_lo
  ``sdc_deviant``       the SDC 2-of-3 fingerprint vote
                        (server._finish_sdc_exec) out-voted a worker
                        whose silently-corrupting device produced the
                        minority state fingerprint  -> quarantine the
                        worker (drain it from assignment — every piece
                        it would run is suspect); MITIGATE OFF
                        releases quarantined workers back to the pool

Every DEGRADING action passes three gates before it fires:

  1. a global mitigation budget (``mitigate_budget`` actions per server
     lifetime — a runaway policy must exhaust itself, not the fleet),
  2. a per-action token bucket (``mitigate_rate`` tokens refilled over
     ``mitigate_rate_window`` seconds),
  3. exponential per-(action, target) backoff (``mitigate_backoff_base``
     doubling to ``mitigate_backoff_cap``) — repeated firings against
     the same target space out instead of hammering it.

Restores (``unshed``/``unrepack``) bypass the gates: undoing a
degradation must never be blocked by an exhausted budget.  Shed/unshed
and repack/unrepack additionally use split thresholds (hysteresis) so
the engine never flaps around one boundary.

Every decision — taken or restored — is journaled as an audit-only
``mitigation`` record ``{cause, signal, action, target, outcome}``
(replay surfaces the history, exactly-once queue math never sees it),
emitted on the flight recorder, and counted in the server registry.
Disabled (the default), the engine is completely inert: no journal
records, no HEALTH section, no counters — a server with
``mitigate_enabled=0`` is bit-identical to one without the engine.
"""
import collections
import time


#: action names that degrade service and therefore pass the full gate
DEGRADING = ("hedge_escalate", "shed", "repack", "accept_degraded",
             "quarantine_worker")
#: restore actions — journaled + counted, never gated
RESTORING = ("unshed", "unrepack", "release_worker")


class TokenBucket:
    """Per-action rate limit: ``capacity`` tokens refilled continuously
    over ``window`` seconds (refill rate = capacity / window)."""

    def __init__(self, capacity, window):
        self.capacity = max(1.0, float(capacity))
        self.window = max(1e-6, float(window))
        self.tokens = self.capacity
        self._t = None

    def take(self, now):
        if self._t is not None:
            self.tokens = min(
                self.capacity,
                self.tokens + (now - self._t) * self.capacity
                / self.window)
        self._t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class MitigationEngine:
    """Policy engine bound to one Server; driven by ``tick()`` on the
    server's heartbeat cadence plus direct signal hooks from the
    detectors (`_check_perf_slo`, `_check_stragglers`, MESHLOST)."""

    def __init__(self, server, enabled=None):
        from .. import settings as _s
        self.server = server
        self.enabled = bool(getattr(_s, "mitigate_enabled", False)) \
            if enabled is None else bool(enabled)
        self.budget_total = int(getattr(_s, "mitigate_budget", 64))
        self.rate = float(getattr(_s, "mitigate_rate", 4))
        self.rate_window = float(getattr(_s, "mitigate_rate_window",
                                         60.0))
        self.backoff_base = float(getattr(_s, "mitigate_backoff_base",
                                          5.0))
        self.backoff_cap = float(getattr(_s, "mitigate_backoff_cap",
                                         300.0))
        self.shed_hi = float(getattr(_s, "mitigate_shed_hi", 0.8))
        self.shed_lo = float(getattr(_s, "mitigate_shed_lo", 0.3))
        self.shed_factor = float(getattr(_s, "mitigate_shed_factor",
                                         0.5))
        self.mem_budget = int(getattr(_s, "mitigate_mem_budget", 0))
        self.mem_hi = float(getattr(_s, "mitigate_mem_hi", 0.9))
        self.mem_lo = float(getattr(_s, "mitigate_mem_lo", 0.6))
        self.repack_factor = float(getattr(_s, "mitigate_repack_factor",
                                           0.5))
        self.budget_used = 0
        self._buckets = {}          # action -> TokenBucket
        self._backoff = {}          # (action, target) -> (next_ok, delay)
        self.actions = collections.Counter()      # action -> fired
        self.suppressed = collections.Counter()   # gate -> suppressions
        self.recent = collections.deque(maxlen=16)
        # actuator baselines: what unshed/unrepack restore to.  Captured
        # when the action first fires, so operator WORLDS/queue changes
        # made BEFORE a shed are respected.
        self.shed_from = None       # batch_queue_max before shedding
        self.repack_from = None     # world_batch_max before re-packing
        self._seen_degraded = set()  # (wid, epoch) accept_degraded once

    # -------------------------------------------------------------- gating
    def _bucket(self, action):
        b = self._buckets.get(action)
        if b is None:
            b = self._buckets[action] = TokenBucket(self.rate,
                                                    self.rate_window)
        return b

    def _admit(self, action, target, now):
        """budget -> backoff -> token bucket; arms the exponential
        backoff on success.  Suppressions are counted per gate (the
        HEALTH section shows them) but never journaled — a suppressed
        decision changed nothing."""
        if self.budget_total and self.budget_used >= self.budget_total:
            self.suppressed["budget"] += 1
            return False
        key = (action, target)
        next_ok, delay = self._backoff.get(key, (0.0, 0.0))
        if now < next_ok:
            self.suppressed["backoff"] += 1
            return False
        if not self._bucket(action).take(now):
            self.suppressed["rate"] += 1
            return False
        delay = self.backoff_base if delay <= 0.0 \
            else min(delay * 2.0, self.backoff_cap)
        self._backoff[key] = (now + delay, delay)
        self.budget_used += 1
        return True

    # ----------------------------------------------------------- recording
    def _decide(self, cause, signal, action, target, outcome,
                piece=None, worker=b""):
        """Journal + trace + count one decision and tell the clients —
        the single funnel every action (and restore) goes through."""
        srv = self.server
        self.actions[action] += 1
        srv.obs.counter("server_mitigations",
                        help="mitigation-engine actions taken").inc()
        srv.obs.counter(f"server_mitigation_{action}",
                        help=f"mitigation '{action}' actions").inc()
        if srv.journal:
            srv.journal.mitigation(cause=cause, signal=signal,
                                   action=action, target=target,
                                   outcome=outcome, piece=piece,
                                   worker=worker)
        srv.recorder.instant("mitigation", cat="server", cause=cause,
                             signal=signal, action=action,
                             target=str(target), outcome=outcome)
        d = {"cause": cause, "signal": signal, "action": action,
             "target": str(target), "outcome": outcome}
        self.recent.append(d)
        msg = (f"MITIGATE: {signal} ({cause}) -> {action} on "
               f"{target or 'server'}: {outcome}")
        print(f"server: {msg}")
        srv._report_clients(msg)

    # -------------------------------------------------------- signal hooks
    def on_perf_regression(self, wid, piece, rate, median, now=None):
        """SLO watch flagged (wid, piece): escalate a hedge for the
        flagged piece — even with ``hedge_enabled`` off, mitigation IS
        the operator typing the hedge."""
        if not self.enabled:
            return
        srv = self.server
        now = time.monotonic() if now is None else now
        if wid in srv.hedge_by or wid in srv.hedge_of:
            return                  # one hedge per piece already placed
        if not srv.avail_workers:
            self.suppressed["no_idle_worker"] += 1
            return
        if not self._admit("hedge_escalate", wid.hex(), now):
            return
        srv._dispatch_hedge(wid, piece,
                            f"SLO regression (rate {rate:.2f} << "
                            f"median {median:.2f}) [mitigation]")
        self._decide(cause=f"rate {rate:.2f} < slo x median "
                           f"{median:.2f}",
                     signal="perf_regression", action="hedge_escalate",
                     target=wid.hex(),
                     outcome=f"hedged to {srv.hedge_by[wid].hex()}",
                     piece=piece, worker=wid)

    def on_straggler(self, wid, piece, why, now=None):
        """Flat-progress straggler with hedging DISABLED: the detector
        (``_check_stragglers``) found a stall it would normally hedge;
        mitigation places the hedge through its gates instead."""
        if not self.enabled:
            return
        srv = self.server
        now = time.monotonic() if now is None else now
        if not srv.avail_workers:
            self.suppressed["no_idle_worker"] += 1
            return
        if not self._admit("hedge_escalate", wid.hex(), now):
            return
        srv._dispatch_hedge(wid, piece, f"{why} [mitigation]")
        self._decide(cause=str(why), signal="straggler",
                     action="hedge_escalate", target=wid.hex(),
                     outcome=f"hedged to {srv.hedge_by[wid].hex()}",
                     piece=piece, worker=wid)

    def on_mesh_degraded(self, wid, piece, epoch, ndev, now=None):
        """A worker re-formed a DEGRADED survivor mesh and kept its
        piece.  The actuation — accept the epoch instead of requeueing
        — is the server's standing behavior; the engine's decision
        record makes the acceptance auditable and rate-limits the
        narration to once per (worker, epoch)."""
        if not self.enabled:
            return
        key = (wid, int(epoch or 0))
        if key in self._seen_degraded:
            return
        now = time.monotonic() if now is None else now
        # backoff target is epoch-qualified: each NEW epoch is a
        # distinct decision worth journaling (same-epoch repeats are
        # already deduped above); the token bucket still caps the
        # fleet-wide acceptance rate in a cascading failure
        if not self._admit("accept_degraded", f"{wid.hex()}#{epoch}",
                           now):
            return
        self._seen_degraded.add(key)
        self._decide(cause=f"mesh epoch {epoch} degraded to "
                           f"{ndev} device(s)",
                     signal="mesh_degraded", action="accept_degraded",
                     target=wid.hex(),
                     outcome="piece continues on survivor mesh",
                     piece=piece if not _is_pack(piece) else None,
                     worker=wid)

    def on_sdc_deviant(self, wid, piece, why="", now=None):
        """The SDC 2-of-3 fingerprint vote named ``wid`` the deviant:
        its device silently corrupts state, so every piece it would
        run is suspect — quarantine it (drain from assignment).  The
        ``sdc_vote`` audit record already names it; THIS record is the
        gated actuation (the closed loop's recovery step)."""
        if not self.enabled:
            return
        srv = self.server
        if wid in srv.sdc_quarantine:
            return                  # already quarantined
        now = time.monotonic() if now is None else now
        if not self._admit("quarantine_worker", wid.hex(), now):
            return
        srv.sdc_quarantine.add(wid)
        if wid in srv.avail_workers:
            srv.avail_workers.remove(wid)
        srv.sdc_quarantined_workers += 1
        self._decide(cause=str(why) or "fingerprint vote",
                     signal="sdc_deviant", action="quarantine_worker",
                     target=wid.hex(),
                     outcome="worker drained from assignment",
                     piece=piece if not _is_pack(piece) else None,
                     worker=wid)

    # ------------------------------------------------------------ the tick
    def tick(self, now=None):
        """Level-triggered checks on the server's heartbeat cadence:
        queue pressure (shed/unshed) and the fleet memory watermark
        (repack/unrepack)."""
        if not self.enabled:
            return
        now = time.monotonic() if now is None else now
        self._tick_queue(now)
        self._tick_mem(now)
        # bound the backoff map: entries idle past their cap expired
        for key, (next_ok, _d) in list(self._backoff.items()):
            if now > next_ok + self.backoff_cap:
                del self._backoff[key]

    def _tick_queue(self, now):
        srv = self.server
        limit = self.shed_from if self.shed_from is not None \
            else srv.batch_queue_max
        if not limit or limit <= 0:
            return                  # unbounded admission: nothing to shed
        depth = len(srv.scenarios)
        if self.shed_from is None:
            if depth >= self.shed_hi * limit \
                    and self._admit("shed", "admission", now):
                tightened = max(1, int(limit * self.shed_factor))
                self.shed_from = srv.batch_queue_max
                srv.batch_queue_max = tightened
                self._decide(
                    cause=f"queue depth {depth} >= "
                          f"{self.shed_hi:g} x limit {limit}",
                    signal="queue_pressure", action="shed",
                    target="admission",
                    outcome=f"batch_queue_max {self.shed_from} -> "
                            f"{tightened}")
        elif depth <= self.shed_lo * limit:
            restored, self.shed_from = self.shed_from, None
            tightened = srv.batch_queue_max
            srv.batch_queue_max = restored
            self._decide(
                cause=f"queue depth {depth} <= "
                      f"{self.shed_lo:g} x limit {limit}",
                signal="queue_pressure", action="unshed",
                target="admission",
                outcome=f"batch_queue_max {tightened} -> {restored}")

    def _tick_mem(self, now):
        srv = self.server
        if self.mem_budget <= 0:
            return
        g = srv.fleet.get("devprof_live_bytes_total")
        live = int(g.value) if g is not None else 0
        if self.repack_from is None:
            if live >= self.mem_hi * self.mem_budget \
                    and srv.world_batch_max > 1 \
                    and self._admit("repack", "worlds", now):
                shrunk = max(1, int(srv.world_batch_max
                                    * self.repack_factor))
                self.repack_from = srv.world_batch_max
                srv.world_batch_max = shrunk
                self._decide(
                    cause=f"fleet live bytes {live} >= "
                          f"{self.mem_hi:g} x budget {self.mem_budget}",
                    signal="mem_watermark", action="repack",
                    target="worlds",
                    outcome=f"world_batch_max {self.repack_from} -> "
                            f"{shrunk}")
        elif live <= self.mem_lo * self.mem_budget:
            restored, self.repack_from = self.repack_from, None
            shrunk = srv.world_batch_max
            srv.world_batch_max = restored
            self._decide(
                cause=f"fleet live bytes {live} <= "
                      f"{self.mem_lo:g} x budget {self.mem_budget}",
                signal="mem_watermark", action="unrepack",
                target="worlds",
                outcome=f"world_batch_max {shrunk} -> {restored}")

    # ------------------------------------------------------------- control
    def set_enabled(self, on):
        """MITIGATE ON/OFF.  Disabling first restores every actuator
        the engine has touched (journaled while still enabled) — an
        operator turning mitigation off must get the configured
        service levels back, not a silently-degraded server."""
        on = bool(on)
        if self.enabled and not on:
            if self.shed_from is not None:
                restored, self.shed_from = self.shed_from, None
                tightened = self.server.batch_queue_max
                self.server.batch_queue_max = restored
                self._decide(cause="MITIGATE OFF",
                             signal="operator", action="unshed",
                             target="admission",
                             outcome=f"batch_queue_max {tightened} -> "
                                     f"{restored}")
            if self.repack_from is not None:
                restored, self.repack_from = self.repack_from, None
                shrunk = self.server.world_batch_max
                self.server.world_batch_max = restored
                self._decide(cause="MITIGATE OFF",
                             signal="operator", action="unrepack",
                             target="worlds",
                             outcome=f"world_batch_max {shrunk} -> "
                                     f"{restored}")
            srv = self.server
            while srv.sdc_quarantine:
                # quarantine is this engine's actuation, so disabling
                # it releases the workers — the operator overriding the
                # vote gets the full pool back, journaled per worker
                wid = srv.sdc_quarantine.pop()
                self._decide(cause="MITIGATE OFF", signal="operator",
                             action="release_worker", target=wid.hex(),
                             outcome="worker returned to assignment",
                             worker=wid)
                if wid in srv.workers \
                        and wid not in srv.avail_workers \
                        and wid not in srv.inflight \
                        and srv.workers.get(wid, 0) < 2:
                    srv.avail_workers.append(wid)
                    srv._send_pending_scenario()
        self.enabled = on

    # ------------------------------------------------------------ readback
    def payload(self):
        """Machine-readable engine state (the ``MITIGATE`` command and
        the HEALTH ``mitigation`` section), with a human ``text``
        rendering — the HEALTH-style readback contract."""
        remaining = None if not self.budget_total \
            else max(0, self.budget_total - self.budget_used)
        d = {"enabled": bool(self.enabled),
             "budget": {"total": self.budget_total,
                        "used": self.budget_used,
                        "remaining": remaining},
             "actions": dict(self.actions),
             "suppressed": dict(self.suppressed),
             "shed_active": self.shed_from is not None,
             "repack_active": self.repack_from is not None,
             "queue_limit": self.server.batch_queue_max,
             "world_batch_max": self.server.world_batch_max,
             "quarantined_workers": sorted(
                 w.hex() for w in self.server.sdc_quarantine),
             "recent": list(self.recent)}
        taken = sum(self.actions.values())
        supp = sum(self.suppressed.values())
        supp_txt = ", ".join(f"{k}:{v}" for k, v in
                             sorted(self.suppressed.items())) or "-"
        act_txt = ", ".join(f"{k}:{v}" for k, v in
                            sorted(self.actions.items())) or "-"
        d["text"] = (
            f"MITIGATE {'ON' if self.enabled else 'OFF'}: {taken} "
            f"action(s) [{act_txt}], {supp} suppressed [{supp_txt}], "
            "budget "
            + (f"{remaining}/{self.budget_total} left"
               if self.budget_total else "unbounded")
            + (", SHEDDING (queue limit "
               f"{self.server.batch_queue_max})"
               if d["shed_active"] else "")
            + (", REPACKED (world max "
               f"{self.server.world_batch_max})"
               if d["repack_active"] else "")
            + (f", {len(d['quarantined_workers'])} worker(s) "
               "QUARANTINED"
               if d["quarantined_workers"] else ""))
        return d


def _is_pack(piece):
    from .server import WorldPack
    return isinstance(piece, WorldPack)
