"""Deferred conditional commands: ATALT / ATSPD triggers.

Parity with the reference ``bluesky/traffic/conditional.py:13-129``: each
condition watches one aircraft's altitude or speed and fires a stored stack
command when the watched value crosses its target (sign change of
``target - actual`` between two evaluations, so overshoot can't miss).

Port of ``bluesky_tpu/core/conditional.py``; its divergences from the
reference:
* Conditions are evaluated at *chunk edges* from one host sample of the
  state arrays, not every 0.05 s step.  The sign-change predicate makes the
  trigger robust to the coarser sampling; the fire time quantizes to the
  chunk (<= 1 s in normal operation — the Simulation clamps the chunk
  ladder while conditions are pending so fast-forward can't defer a
  trigger by more than ~1 s of sim time).
* Aircraft slots are stable in this framework (delete never shifts
  indices), so the reference's index-decrement bookkeeping on deletion
  (conditional.py:118-129) reduces to dropping that slot's conditions.
"""
import numpy as np

from ..utils import asnumpy

ALT_TYPE, SPD_TYPE = 0, 1


class ConditionList:
    """Host-side condition table; tiny (human-issued), plain NumPy."""

    def __init__(self, sim):
        self.sim = sim
        self.idx = np.array([], dtype=np.int64)      # aircraft slot
        self.condtype = np.array([], dtype=np.int64)
        self.target = np.array([], dtype=np.float64)
        self.lastdif = np.array([], dtype=np.float64)
        self.cmd = []

    @property
    def ncond(self):
        return len(self.cmd)

    def permute(self, newslot):
        """Spatial shard re-bucketing moved aircraft between slots —
        follow them (slots stay stable between refreshes)."""
        if self.idx.size:
            self.idx = np.asarray(newslot)[self.idx].astype(np.int64)

    # ------------------------------------------------------------ commands
    def ataltcmd(self, acidx, targalt, cmdtxt):
        """acid ATALT alt cmd (conditional.py:51-54)."""
        actalt = float(self.sim.traf.state.ac.alt[acidx])
        self._add(acidx, ALT_TYPE, targalt, actalt, cmdtxt)
        return True

    def atspdcmd(self, acidx, targspd, cmdtxt):
        """acid ATSPD spd cmd (conditional.py:56-59).

        The watched value is CAS (matching the reference's update(), which
        compares against ``bs.traf.cas``; its add-time sample of ``tas`` is
        inconsistent with its own trigger test — we use CAS on both sides)."""
        actspd = float(self.sim.traf.state.ac.cas[acidx])
        self._add(acidx, SPD_TYPE, targspd, actspd, cmdtxt)
        return True

    def _add(self, acidx, icondtype, target, actual, cmdtxt):
        self.idx = np.append(self.idx, acidx)
        self.condtype = np.append(self.condtype, icondtype)
        self.target = np.append(self.target, target)
        self.lastdif = np.append(self.lastdif, target - actual)
        self.cmd.append(cmdtxt)

    # ------------------------------------------------------------- update
    def update(self):
        """Fire conditions whose watched value crossed the target since the
        last evaluation (conditional.py:25-49).  Called at chunk edges."""
        if self.ncond == 0:
            return
        ac = self.sim.traf.state.ac
        alt = asnumpy(ac.alt)[self.idx]
        cas = asnumpy(ac.cas)[self.idx]
        actual = np.where(self.condtype == ALT_TYPE, alt, cas)
        actdif = self.target - actual
        fire = np.where(actdif * self.lastdif <= 0.0)[0]
        self.lastdif = actdif
        if len(fire) == 0:
            return
        cmds = [self.cmd[i] for i in fire]
        self._delete(fire)
        for c in cmds:
            self.sim.stack.stack(c)

    def _delete(self, sel):
        keep = np.ones(self.ncond, dtype=bool)
        keep[sel] = False
        self.idx = self.idx[keep]
        self.condtype = self.condtype[keep]
        self.target = self.target[keep]
        self.lastdif = self.lastdif[keep]
        self.cmd = [c for c, k in zip(self.cmd, keep) if k]

    def delac(self, acidx):
        """Drop conditions of deleted aircraft; slots are stable so no
        index renumbering (cf. conditional.py:118-129)."""
        for i in np.atleast_1d(acidx):
            sel = np.where(self.idx == int(i))[0]
            if len(sel):
                self._delete(sel)

    def reset(self):
        self.__init__(self.sim)
