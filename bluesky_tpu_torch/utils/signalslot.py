"""Minimal pub-sub signal (parity: bluesky/tools/signal.py:4).

A Signal is a named list of callbacks; emit() fans an event out to every
connected slot.  Used by the network Client to deliver events/streams and by
the plugin/GUI layers.
"""


class Signal:
    """Named callback list with connect/disconnect/emit."""

    def __init__(self, name=""):
        self.name = name
        self.slots = []

    def connect(self, slot):
        self.slots.append(slot)

    def disconnect(self, slot):
        try:
            self.slots.remove(slot)
        except ValueError:
            pass

    def emit(self, *args, **kwargs):
        for slot in list(self.slots):
            slot(*args, **kwargs)
