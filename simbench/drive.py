"""The system under test: a ``bluesky_tpu_torch`` ``Simulation`` built
from a cell, warmed up, and driven chunk by chunk through
``Simulation.step`` in fast time; and the captures the check reads.

Nothing else of the port is imported here at module level: this module
is imported by the tests, which run without a card.
"""
import time

import numpy as np
import torch

from . import fleet as fleetmod

#: the per-aircraft columns of the state that the check reads, by the
#: reference's names (``simbench/reference/step.py``)
FIELDS = {
    "active": "ac.active", "lat": "ac.lat", "lon": "ac.lon",
    "alt": "ac.alt", "hdg": "ac.hdg", "trk": "ac.trk", "tas": "ac.tas",
    "gs": "ac.gs", "gsnorth": "ac.gsnorth", "gseast": "ac.gseast",
    "cas": "ac.cas", "mach": "ac.mach", "vs": "ac.vs",
    "selspd": "ac.selspd", "selalt": "ac.selalt", "selvs": "ac.selvs",
    "apvsdef": "ac.apvsdef", "ax": "ac.ax", "bank": "ac.bank",
    "swlnav": "ac.swlnav", "swvnav": "ac.swvnav",
    "ap_trk": "ap.trk", "ap_tas": "ap.tas", "ap_alt": "ap.alt",
    "ap_vs": "ap.vs",
    "asas_trk": "asas.trk", "asas_tas": "asas.tas", "asas_vs": "asas.vs",
    "asas_alt": "asas.alt", "asas_active": "asas.active",
    "asase": "asas.asase", "asasn": "asas.asasn", "inconf": "asas.inconf",
    "tcpamax": "asas.tcpamax", "noreso": "asas.noreso",
    "resooff": "asas.resooff",
}
CLOCKS = ("simt", "fms_t0", "asas_tnext")
#: chunks of set-up: the first is the check's first chunk; with the rest
#: they capture the gate patterns' graphs and pass the first sort refresh
WARMUP_CHUNKS = 3
#: aircraft that the check compares, drawn from the seed
CHECK_SAMPLE = 4096


def field(state, path):
    obj = state
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def clocks(state) -> dict:
    return {k: getattr(state, k) for k in CLOCKS}


def build(cell, seed: int, device):
    """A ``Simulation`` holding the cell's fleet, its configuration
    applied and the traffic's stack lines processed.  Returns ``(sim,
    columns drawn)``."""
    from bluesky_tpu_torch.core.asas import AsasConfig
    from bluesky_tpu_torch.simulation.sim import Simulation
    c = cell.config
    if int(c["k_partners"]) != 8:
        raise ValueError("the Simulation's partner tables are 8 wide")
    cols = fleetmod.draw(c["fleet"], seed)
    sim = Simulation(nmax=int(c["nmax"]), wmax=int(c["wmax"]),
                     dtype=getattr(torch, c["dtype"]),
                     rng_seed=int(seed) % 2 ** 32,
                     pair_matrix=bool(c["pair_matrix"]), device=device)
    sim.cfg = sim.cfg._replace(simdt=float(c["simdt"]),
                               cd_block=int(c["cd_block"]),
                               asas=AsasConfig(**c["asas"]))
    f = c["fleet"]
    sim.traf.create(int(f["n_aircraft"]), f["actype"], cols["alt"],
                    cols["spd"], None, cols["lat"], cols["lon"], cols["hdg"])
    sim.traf.flush()
    for line in cell.traffic["stack"]:
        sim.stack.stack(line)
    sim.stack.process()
    return sim, cols


def chunk_steps(cell) -> int:
    return int(cell.traffic["chunk_steps"])


class Retirements:
    """Wall stamps of the chunk edges the Simulation retires: the count
    of its ``sim_chunk_latency_ms`` series rises by one at each."""

    def __init__(self, sim):
        self.hist = sim.obs.get("sim_chunk_latency_ms")
        self.seen = self.hist.count
        self.stamps = []

    def poll(self):
        now = time.perf_counter()
        while self.seen < self.hist.count:
            self.seen += 1
            self.stamps.append(now)


def warm_up(sim, cell, sample):
    """The cell's warm-up chunks, then the pipeline drained and the
    device idle.  Returns the sampled rows after the first chunk
    (``take``)."""
    sim.step(max_chunk=chunk_steps(cell))
    first = take(sim.traf.state, sample)
    for _ in range(WARMUP_CHUNKS - 1):
        sim.step(max_chunk=chunk_steps(cell))
    sim.drain_pipeline()
    if sim.traf.state.device.type == "cuda":
        torch.cuda.synchronize()
    return first


class PreState:
    """The state before a chunk, as the check reads it: every column of
    ``FIELDS`` of every slot and the old partner rows of the sampled
    ownships, copied on the device's stream into host memory allocated
    in set-up (pinned on a card), so that taking it inside the window
    neither waits for the device nor allocates device memory beyond the
    sampled rows."""

    def __init__(self, state, sample):
        pin = state.device.type == "cuda"
        self.sample = torch.as_tensor(sample, dtype=torch.long,
                                      device=state.device)
        host = lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        self.cols = {k: host(field(state, p)) for k, p in FIELDS.items()}
        self.sort_perm = host(state.asas.sort_perm)
        k = state.asas.partners.shape[1]
        self.partners = torch.empty((len(sample), k), dtype=torch.int32,
                                    pin_memory=pin)
        self.event = None
        self.clocks = None

    def take(self, state, backend: str):
        """Enqueue the copies of ``state`` (no host wait)."""
        nb = state.device.type == "cuda"
        for k, p in FIELDS.items():
            self.cols[k].copy_(field(state, p), non_blocking=nb)
        a = state.asas
        self.sort_perm.copy_(a.sort_perm, non_blocking=nb)
        if backend == "sparse":
            rows = a.partners_s.index_select(
                0, a.sort_perm.index_select(0, self.sample).long())
        else:
            rows = a.partners.index_select(0, self.sample)
        self.partners.copy_(rows, non_blocking=nb)
        self.clocks = clocks(state)
        if nb:
            self.event = torch.cuda.Event()
            self.event.record()

    def numpy(self, backend: str) -> dict:
        """The copies as numpy arrays, the partner rows in slot ids."""
        if self.event is not None:
            self.event.synchronize()
        out = {k: v.numpy().copy() for k, v in self.cols.items()}
        p = self.partners.numpy().astype(np.int64)
        if backend == "sparse":
            # stripe-sorted ids back to slots: sort_perm is slot -> sorted
            dest = self.sort_perm.numpy().astype(np.int64)
            inv = np.full(max(int(dest.max()) + 1, int(p.max()) + 1), -1,
                          np.int64)
            inv[dest] = np.arange(dest.size)
            p = np.where(p >= 0, inv[np.clip(p, 0, None)], -1)
        out["partners"] = p
        out["clocks"] = dict(self.clocks)
        return out


def take(state, sample) -> dict:
    """Copies, on the device's stream, of the sampled rows of every
    column of ``FIELDS`` and of the conflict totals (no host wait)."""
    idx = torch.as_tensor(sample, dtype=torch.long, device=state.device)
    out = {k: field(state, p).index_select(0, idx) for k, p in FIELDS.items()}
    out["nconf_cur"] = state.asas.nconf_cur.clone()
    out["nlos_cur"] = state.asas.nlos_cur.clone()
    return out


def host(taken) -> dict:
    """``take``'s copies as numpy columns and integer totals."""
    return {k: int(v) if v.dim() == 0 else v.cpu().numpy()
            for k, v in taken.items()}


def rows(state, sample) -> dict:
    """The sampled rows of every column of ``FIELDS`` (numpy) and the
    conflict totals."""
    return host(take(state, sample))


def sample_slots(sim, seed):
    """The slots the check compares: ``CHECK_SAMPLE`` of the active
    aircraft, drawn from the seed."""
    act = np.flatnonzero(sim.traf.state.ac.active.cpu().numpy())
    return act[fleetmod.sample(act.size, CHECK_SAMPLE, seed)]
