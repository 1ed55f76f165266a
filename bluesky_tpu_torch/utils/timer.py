"""Wall-clock periodic triggers (parity: bluesky/tools/timer.py:6-42).

Timers fire callbacks from the host main loop — the reference calls
``Timer.update_timers()`` each Node.run() iteration (node.py:80); ours is
called from the network node loop the same way.  Device-side scheduling
(ASAS/FMS cadence) is *not* done with these: that lives inside the jitted
step (core/step.py) as sim-time gates.
"""
import time


class Timer:
    """Fires connected callbacks every ``interval`` wall-clock seconds."""

    timers = []

    def __init__(self, interval: float):
        self.interval = float(interval)
        self.tnext = time.perf_counter() + self.interval
        self.slots = []
        Timer.timers.append(self)

    def connect(self, slot):
        self.slots.append(slot)

    def disconnect(self, slot):
        try:
            self.slots.remove(slot)
        except ValueError:
            pass

    def remove(self):
        """Deregister this timer so it stops firing and can be collected."""
        try:
            Timer.timers.remove(self)
        except ValueError:
            pass

    @classmethod
    def update_timers(cls):
        now = time.perf_counter()
        for timer in cls.timers:
            if now >= timer.tnext:
                timer.tnext = now + timer.interval
                for slot in list(timer.slots):
                    slot()

    @classmethod
    def reset_all(cls):
        cls.timers.clear()
