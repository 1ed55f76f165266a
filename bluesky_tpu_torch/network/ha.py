"""Broker high availability: journal-fenced leadership + warm standby
(port of ``bluesky_tpu/network/ha.py``; the lease file and the journal
records are the JAX package's, byte for byte).

The BATCH journal (network/journal.py) is the single source of truth
for a sweep; this module adds the small amount of coordination state
needed for a *warm-standby* server to take over the sweep when the
leader dies, with no operator commands and no double-counted work
(docs/FAULT_TOLERANCE.md §broker HA):

- **lease file** — ``<journal>.lease``, an atomically-replaced JSON
  blob ``{leader, epoch, ttl, stamp}`` the leader rewrites every
  ``ha_poll_dt``.  The standby polls it cheaply; a stamp older than
  ``ttl`` (wall clock — the two servers are different processes, so
  monotonic clocks don't compare) means the leader has been silent
  for a full lease and the standby may take over.
- **lease journal record** — the durable half of the same fact: every
  leadership acquisition appends ``{"rec": "lease", leader, epoch,
  ttl}`` to the shared journal, so replay knows the epoch in force at
  every point of the file.  All records a leader writes after its
  lease carry ``wepoch`` (writer epoch, distinct from the mesh
  ``epoch`` field of mesh_lost/resharded records); replay fences a
  deposed leader's late ``dispatched``/``completed`` appends off as
  audit-only (``fenced``), which is what makes a non-atomic UNIX-file
  handover safe.
- **JournalTail** — the standby's warm view: an incremental reader
  that follows the growing journal between polls so takeover replay
  is a re-fold of an already-hot file, and HA STATUS can report how
  far behind the standby is.

The leader/standby *processes* are plain Servers (network/server.py
``ha_role=``); this module stays free of ZMQ so the lease protocol is
unit-testable in isolation.
"""
import json
import os
import time


def lease_path(journal_path):
    """The lease file that guards ``journal_path``."""
    return str(journal_path) + ".lease"


def write_lease(path, leader, epoch, ttl, stamp=None):
    """Atomically (tmp + rename) publish a lease: ``leader`` (hex id)
    holds ``epoch`` and promises a heartbeat within ``ttl`` seconds of
    ``stamp``.  Best-effort: a full disk degrades to the journal
    record being authoritative (takeover then keys off file age)."""
    blob = {"leader": str(leader), "epoch": int(epoch),
            "ttl": float(ttl),
            "stamp": float(time.time() if stamp is None else stamp)}
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    return True


def read_lease(path):
    """The current lease blob, or None (absent/torn/unreadable —
    a torn read is impossible via os.replace, but a truncated disk
    copy still parses to None instead of raising)."""
    if not path:
        return None
    try:
        with open(path) as f:
            blob = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(blob, dict) or "epoch" not in blob:
        return None
    return blob


def lease_age(lease, now=None):
    """Seconds since the lease was last renewed (wall clock)."""
    now = time.time() if now is None else now
    return now - float(lease.get("stamp", 0.0))


def is_stale(lease, now=None, default_ttl=10.0):
    """Has the leader been silent past its own promised ttl?"""
    if lease is None:
        return True
    ttl = float(lease.get("ttl") or default_ttl)
    return lease_age(lease, now) > ttl


class JournalTail:
    """Incremental reader over the growing shared journal.

    ``poll()`` consumes newly-appended complete lines (a torn final
    line stays unconsumed until its newline lands, mirroring the
    replay torn-tail rule) and keeps running counters: total records
    seen, the highest lease epoch and its leader, lease-record count.
    This is the standby's warm state — cheap enough to run every
    ``ha_poll_dt`` — while the authoritative fold at takeover is a
    full ``BatchJournal.replay`` of the same file."""

    def __init__(self, path):
        self.path = str(path)
        self.pos = 0
        self.records = 0
        self.leases = 0
        self.epoch = 0
        self.leader = ""

    def poll(self):
        """Consume complete appended lines; return records consumed."""
        new = 0
        try:
            with open(self.path, "rb") as f:
                f.seek(self.pos)
                chunk = f.read()
        except OSError:
            return 0
        if not chunk:
            return 0
        # only whole lines: hold back a torn tail for the next poll
        cut = chunk.rfind(b"\n")
        if cut < 0:
            return 0
        self.pos += cut + 1
        for line in chunk[:cut + 1].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except ValueError:
                continue
            if not isinstance(r, dict):
                continue
            new += 1
            if r.get("rec") == "lease":
                self.leases += 1
                ep = r.get("epoch")
                if isinstance(ep, int) and ep >= self.epoch:
                    self.epoch = ep
                    self.leader = str(r.get("leader", ""))
        self.records += new
        return new


def reconcile(pending, reported):
    """Match journal-owed pieces against surviving workers' in-flight
    reports (pure function; the server applies the result).

    ``pending``: replayed owed pieces (the multiset of copies the old
    leader had queued-or-running), in journal order.  ``reported``:
    ``[(worker_hex, content_key), ...]`` from idempotent re-REGISTERs.
    Each report *adopts* one owed copy with a matching content key —
    the piece keeps running where it is, no requeue, no breaker
    strike.  Reports with no owed copy left are returned as ``extra``
    (a completion raced the failover, or a surviving hedge twin of an
    already-counted copy — the server cancels/dedupes those by key).
    Returns ``(adopted, requeue, extra)`` with ``adopted`` as
    ``[(worker_hex, piece)]`` and ``requeue`` the leftover pending
    copies in their original order."""
    from .journal import BatchJournal
    left = list(pending)
    keys = [BatchJournal.piece_key(p) for p in left]
    adopted, extra = [], []
    for worker, key in reported:
        try:
            i = keys.index(key)
        except ValueError:
            extra.append((worker, key))
            continue
        keys.pop(i)
        adopted.append((worker, left.pop(i)))
    return adopted, left, extra
