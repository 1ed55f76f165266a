"""State-integrity guard: chunk-edge response to in-chunk finite trips.

Port of ``bluesky_tpu/fault/guard.py``.  Detection lives inside the
device chunk (``core/step.run_steps_checked`` and the checked edge
runners: an isfinite reduction folded into the chunk's carry reports the
first bad step index).  This module is the HOST side: when a chunk trips, identify
the poisoned aircraft, log them (FAULTLOG event logger + echo), and
apply the recovery policy:

* ``quarantine`` (default) — delete the non-finite aircraft (mask flip,
  slot identity preserved for the rest of the fleet) and scrub any
  non-finite leftovers from the state arrays, so the run continues with
  the healthy fleet.
* ``rollback``   — restore the newest snapshot-ring checkpoint
  (simulation/snapshot.SnapshotRing), then ALSO quarantine the aircraft
  that were poisoned — rollback without quarantine would replay
  straight back into the same fault.  Falls back to plain quarantine
  when the ring is empty.
* ``halt``       — pause the sim and keep the corrupt state untouched
  for debugging (the only policy that does not scrub).

Every trip is recorded in ``guard.trips`` (host-visible for tests and
reports) and echoed to the issuing client.
"""
import torch

from ..core.graph import leaves
from ..utils import asnumpy


class IntegrityGuard:
    def __init__(self, sim):
        self.sim = sim
        from .. import settings
        self.enabled = bool(getattr(settings, "guard_enabled", True))
        self.policy = str(getattr(settings, "guard_policy",
                                  "quarantine")).lower()
        self.trips = []           # [{simt, bad_step, ids, action}]
        # per-sim registry: W multi-world sims keep separate FAULTLOGs
        self.logger = sim.datalog.define_event(
            "FAULTLOG", "State-integrity guard trips: acid, action")

    def reset(self):
        self.trips.clear()

    def set_policy(self, policy: str) -> bool:
        policy = policy.lower()
        if policy not in ("quarantine", "rollback", "halt"):
            return False
        self.policy = policy
        return True

    # ------------------------------------------------------------ response
    def bad_slots(self):
        """Live slots with a non-finite guarded field (host-side scan)."""
        from ..core.step import GUARD_FIELDS
        ac = self.sim.traf.state.ac
        bad = torch.zeros_like(ac.active)
        for f in GUARD_FIELDS:
            bad |= ~torch.isfinite(getattr(ac, f))
        return asnumpy(bad & ac.active).nonzero()[0].tolist()

    def scrub(self):
        """Replace every non-finite float in the state pytree with 0 so
        stale corruption in deactivated rows can never propagate through
        arithmetic masking (NaN * 0 == NaN).  In place: the state's
        tensors belong to the traffic."""
        for _, x in leaves(self.sim.traf.state):
            if x.is_floating_point():
                x.masked_fill_(~torch.isfinite(x), 0.0)

    def trip(self, bad_step: int, chunk: int):
        """Handle one tripped chunk; called by Simulation.step at the
        chunk edge with the in-scan first-bad-step index."""
        sim = self.sim
        slots = self.bad_slots()
        ids = [sim.traf.ids[s] for s in slots
               if sim.traf.ids[s] is not None]
        action = self.policy
        if self.policy == "halt":
            sim.pause()
        elif self.policy == "rollback" and len(sim.snap_ring):
            ok, msg = sim.snap_ring.rollback(sim)
            if ok:
                action = "rollback+quarantine"
                self._delete_ids(ids)
            else:                       # corrupt ring entry: degrade
                action = "quarantine"
                self._delete_slots(self.bad_slots())
            self.scrub()
        else:
            action = "quarantine"
            self._delete_slots(slots)
            self.scrub()
        rec = dict(simt=sim.simt, bad_step=int(bad_step), chunk=int(chunk),
                   ids=ids, action=action)
        self.trips.append(rec)
        names = ",".join(ids) if ids else "<none identified>"
        sim.scr.echo(f"INTEGRITY GUARD: non-finite state at step "
                     f"{bad_step}/{chunk} of the chunk — {action} "
                     f"[{names}]")
        if self.logger.active:
            self.logger.log(sim, ids or ["-"], [action])
        # Observability: count the trip, mark it on the flight-recorder
        # timeline, and dump the ring so the spans LEADING UP TO the
        # incident survive it (throttled; docs/OBSERVABILITY.md).
        sim.obs.counter("sim_guard_trips").inc()
        sim.recorder.instant("guard_trip", bad_step=int(bad_step),
                             chunk=int(chunk), action=action,
                             nbad=len(ids))
        sim.recorder.auto_dump("guard_trip")
        return rec

    def mesh_trip(self, action: str, **extra):
        """Record a structured mesh-epoch event (``mesh_lost`` /
        ``resharded``) in the trip log.  Unlike ``trip`` this does not
        touch aircraft state: the mesh recovery
        (``simulation/sim._handle_mesh_lost``) owns the response; the
        guard gives the event the same audit trail (``guard.trips`` and
        FAULTLOG) as every other fault class."""
        sim = self.sim
        rec = dict(simt=float(sim.simt_planned), bad_step=-1,
                   chunk=int(sim._step_count), ids=[],
                   action=str(action), source="mesh_guard", **extra)
        self.trips.append(rec)
        if self.logger.active:
            self.logger.log(sim, ["-"], [str(action)])
        # the mesh_lost / resharded pair brackets the recovery on the
        # flight recorder's timeline
        sim.obs.counter("sim_mesh_trips").inc()
        tags = {k: v for k, v in extra.items()
                if isinstance(v, (int, float, str, bool, list))}
        sim.recorder.instant(str(action), world=sim.world_tag, **tags)
        sim.recorder.auto_dump("mesh_trip")
        return rec

    def _delete_slots(self, slots):
        if slots:
            self.sim.traf.delete(list(slots))

    def _delete_ids(self, ids):
        """Delete by callsign — slot numbers may differ after rollback."""
        slots = [self.sim.traf.id2idx(a) for a in ids]
        self._delete_slots([s for s in slots
                            if isinstance(s, int) and s >= 0])
