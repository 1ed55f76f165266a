"""Detached node: the Node interface with no networking (port of
``bluesky_tpu/network/detached.py``).

For embedding the sim in other Python programs (tests, notebooks, batch
scripts, ``python -m bluesky_tpu_torch --detached``): events are
delivered by direct calls, streams collected in a buffer the host
program may drain.  Imports neither pyzmq nor msgpack.
"""
from ..utils.timer import Timer
from .common import make_id


class Node:
    def __init__(self, *args, **kwargs):
        self.node_id = make_id()
        self.host_id = make_id()
        self.running = False
        self.streams = []         # [(name, data)] drained by the embedder

    def connect(self):
        pass

    def close(self):
        pass

    def quit(self):
        self.running = False

    def send_event(self, name: bytes, data=None, route=None):
        # loop server-bound events straight back into the handler
        self.event(name, data, [self.node_id])

    def send_stream(self, name: bytes, data):
        self.streams.append((name, data))

    def event(self, name: bytes, data, sender_route):
        pass

    def step(self):
        pass

    def process_events(self, timeout_ms: int = 0) -> int:
        return 0

    def run(self):
        self.running = True
        while self.running:
            self.step()
            Timer.update_timers()
