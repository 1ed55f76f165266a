"""Chunks of steps replayed as CUDA graphs.

The port's counterpart of ``jax.jit(run_steps)`` (``bluesky_tpu/core/
step.py``: ``run_steps`` compiles a chunk's ``lax.scan`` over ``step``
into one device program).  PyTorch runs eagerly and one step makes some
640 launches, so on a CUDA state the chunk runners of ``core/step.py``
replay captured CUDA graphs for the steps without an ASAS interval: one
graph per gate pattern (plain, FMS-due), with the chunk's folds (the
guard, ScanStats, fingerprint) inside.  The ASAS-due step (1 in 20 at
simdt 0.05 s and dtasas 1 s) and the in-scan sort refresh run eagerly
between replays, on the same buffers; the tiled interval reads its reach
matrix back to the host, so it could never be captured.

A graph reads and writes fixed addresses, so each configuration owns a
set of static buffers, one per state tensor and per fold: the captured
step computes the new state from them and copies every changed tensor
back into them, so that a replay advances them in place.  A chunk first
copies the caller's state into them (a tensor that already is the buffer
is skipped, so chained chunks copy nothing), and ``Traffic.create`` or
``delete`` between chunks, which write new tensors or slots, are picked
up by that copy.  The host clocks stay on the host
(``step.next_clocks``); the ADS-B model compares with ``simt`` on the
device, so the buffers hold a device copy of it, advanced inside the
graph with the same add in the same dtype as the host clock, hence equal
to it bit for bit.

Graphs are captured lazily, per (configuration, state layout, device,
checked, keep), into one memory pool shared by all of them.  The first
step of each gate pattern runs eagerly on a side stream (the warm-up; it
is that step, not a rehearsal), then is captured.  The pool may be
shared because everything that lives across replays is a static buffer
allocated outside capture: a graph's own memory holds only what one
replay makes and drops.  Noise draws come from one ``torch.Generator``
registered with the graphs and reseeded before every step, exactly as
the eager step seeds its own: a step's draws are those of Philox with
the step's seed from offset 0 on either path.  A capture or replay that
fails raises; nothing falls back to the eager loop on the card.

A stacked state (``step.stack_worlds``) is chunked the same way: its
buffers carry the leading [W] axis, the device clock is a [W] buffer,
and the captured steps are ``step.step_body_worlds``.  The FMS gate is
hoisted as in JAX: the host decides which worlds are due, the FMS-due
graph runs when any is, and the per-world select inside it reads a
static [W] mask buffer that is filled (a non-blocking copy from pinned
memory) before each replay, so one captured graph serves every pattern
of due worlds.  The ASAS step, eager, reads a mask buffer filled the
same way.  Each world draws its noise from a generator of its own, all
of them registered with the graphs and reseeded before every step.
"""
import dataclasses
import threading
import time

import torch

from . import step as stepmod
from ..obs import devprof

#: the chunk executors by key; per device, the shared graph memory pool,
#: the side stream of the warm-ups and captures, and every graph captured
#: into the pool (the allocator refuses a capture into a pool whose graphs
#: have all been destroyed, so they live until ``clear``)
_CHUNKS = {}
_POOLS = {}
#: this thread's count of new chunk executors (``misses``); the keys the
#: CPU's eager chunks have run under (``eager_lookup``)
_LOOKUPS = threading.local()
_EAGER = set()


def clear():
    """Drop every captured graph and static buffer."""
    _CHUNKS.clear()
    _POOLS.clear()
    _EAGER.clear()


def misses() -> int:
    """The chunk executors this thread has made anew (each captures its
    graphs on its first steps): a dispatch that raised the count was a
    compile miss, one that left it a hit (the compile telemetry,
    ``obs/devprof``)."""
    return getattr(_LOOKUPS, "misses", 0)


def _miss():
    _LOOKUPS.misses = misses() + 1


def eager_lookup(state, cfg, checked: bool, keep: bool):
    """The CPU's eager chunk captures nothing; its first chunk under a
    key counts as the miss a card would take there, so the compile
    telemetry reads the same on both."""
    key = chunk_key(state, cfg, checked, keep)
    if key not in _EAGER:
        _EAGER.add(key)
        _miss()


def leaves(obj, prefix=""):
    """``[(dotted path, tensor)]`` of every tensor of a state (or of any
    dataclass, NamedTuple or dict of tensors), in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    elif hasattr(obj, "_asdict"):
        items = list(obj._asdict().items())
    elif isinstance(obj, dict):
        items = sorted(obj.items())
    else:
        return []
    out = []
    for name, v in items:
        out += leaves(v, f"{prefix}{name}.")
    return out


def rebuild(obj, tensors):
    """``obj`` with its tensors (in ``leaves`` order) replaced by
    ``tensors`` (an iterator)."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: rebuild(getattr(obj, f.name), tensors)
            for f in dataclasses.fields(obj)})
    if hasattr(obj, "_asdict"):
        return type(obj)(*[rebuild(v, tensors) for v in obj])
    if isinstance(obj, dict):
        return {k: rebuild(obj[k], tensors) for k in sorted(obj)}
    return obj


def write_back(dst, src):
    """Copy the tensors ``src`` into the buffers ``dst`` (pairwise).  A
    source that is its buffer is skipped; a source that shares storage
    with any buffer is cloned before the first copy, so no copy reads a
    buffer another copy has already written.  A dtype, shape or device
    change raises."""
    owned = {d.untyped_storage().data_ptr() for d in dst}
    todo = []
    for d, s in zip(dst, src, strict=True):
        if (s.dtype, s.shape, s.device) != (d.dtype, d.shape, d.device):
            raise ValueError(f"graph buffer {tuple(d.shape)} {d.dtype} on "
                             f"{d.device} cannot take {tuple(s.shape)} "
                             f"{s.dtype} on {s.device}")
        if s.data_ptr() == d.data_ptr() and s.stride() == d.stride():
            continue
        if s.untyped_storage().data_ptr() in owned:
            s = s.clone()
        todo.append((d, s))
    for d, s in todo:
        d.copy_(s)


def _capture(body, device, gen):
    """Run ``body`` once on the side stream (the warm-up, which is a real
    step), then capture it there into a CUDA graph in the shared pool;
    returns the graph's replay.  Unlike ``torch.cuda.graph`` this neither
    synchronises nor empties the allocator's cache, which would make the
    next eager ASAS interval allocate its memory again."""
    if device not in _POOLS:
        _POOLS[device] = (torch.cuda.graph_pool_handle(),
                          torch.cuda.Stream(device), [])
    pool, side, graphs = _POOLS[device]
    cur = torch.cuda.current_stream(device)
    g = torch.cuda.CUDAGraph()
    for one in (gen if isinstance(gen, list) else [gen]):
        if one is not None:
            g.register_generator_state(one)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        t0 = time.perf_counter()
        body()
        t1 = time.perf_counter()
        g.capture_begin(pool=pool)
        try:
            body()
        finally:
            g.capture_end()
    cur.wait_stream(side)
    graphs.append(g)
    devprof.compile_event("capture_warmup", (t1 - t0) * 1e3)
    devprof.compile_event("capture", (time.perf_counter() - t1) * 1e3)
    return g.replay


def signature(state):
    """The layout of a state: every tensor's path, shape and dtype."""
    return tuple((k, tuple(t.shape), t.dtype) for k, t in leaves(state))


class ChunkGraphs:
    """The static buffers and captured step graphs of one configuration,
    with the chunk-executor interface of ``step._EagerChunk``."""

    def __init__(self, state, cfg, checked: bool, static=None):
        self.cfg = cfg
        self.device = state.device
        self.static = static if static is not None else rebuild(
            state, iter([torch.empty_like(t) for _, t in leaves(state)]))
        self.bufs = [t for _, t in leaves(self.static)]
        self.carry = stepmod.init_carry(self.static, cfg, checked)
        self.carry_bufs = [t for _, t in leaves(self.carry)]
        from .state import is_stacked
        dtype = state.ac.lat.dtype
        self.worlds = is_stacked(state)
        lead = tuple(state.ac.lat.shape[:-1])
        self.simt = torch.zeros(lead, dtype=dtype, device=self.device)
        self.simdt = torch.full((), float(state.simt.dtype.type(cfg.simdt)),
                                dtype=dtype, device=self.device)
        self.gen = None
        if stepmod.noise_on(cfg):
            self.gen = [torch.Generator(device=self.device)
                        for _ in range(lead[0])] if self.worlds \
                else torch.Generator(device=self.device)
        if self.worlds:
            # the per-world gate masks the FMS graph and the ASAS step read
            self.fms_mask = torch.zeros(lead, dtype=torch.bool,
                                        device=self.device)
            self.asas_mask = torch.zeros_like(self.fms_mask)
        self.checked = checked
        self.replays = {}
        self.clocks = None
        self.lent = False

    def owns(self, state) -> bool:
        """Whether ``state`` holds one of the buffers (it was made from a
        state this executor returned).  Empty tensors are left out: they
        all have the data pointer 0."""
        ptrs = {t.data_ptr() for t in self.bufs if t.numel()}
        return any(t.numel() and t.data_ptr() in ptrs
                   for _, t in leaves(state))

    def start(self, state):
        """Copy ``state`` and fresh folds into the buffers."""
        write_back(self.bufs, [t for _, t in leaves(state)])
        write_back(self.carry_bufs, [t for _, t in leaves(
            stepmod.init_carry(state, self.cfg, self.checked))])
        if self.worlds:
            self.simt.copy_(stepmod.host_to_device(state.simt, self.device))
        else:
            self.simt.fill_(float(state.simt))
        self.clocks = stepmod.Clocks(state.simt, state.fms_t0,
                                     state.asas_tnext, state.rng)

    @property
    def state(self):
        """The buffers as a state, with the host side of the chunk."""
        return self.static.replace(**self.clocks._asdict())

    def _body(self, fms: bool, asas: bool):
        """One step and its folds on the buffers, written back."""
        if self.worlds:
            out = stepmod.step_body_worlds(
                self.static, self.cfg, fms, asas, self.fms_mask,
                self.asas_mask, self.simt, self.gen)
        else:
            out = stepmod.step_body(self.static, self.cfg, fms, asas,
                                    self.simt, self.gen)
        carry = stepmod.fold_carry(self.carry, out, self.cfg)
        write_back(self.bufs + self.carry_bufs,
                   [t for _, t in leaves(out)]
                   + [t for _, t in leaves(carry)])
        self.simt.add_(self.simdt)

    def step(self):
        if self.worlds:
            fms, asas, clk = stepmod.next_clocks_worlds(self.clocks, self.cfg)
            for mask, due in ((self.fms_mask, fms), (self.asas_mask, asas)):
                mask.copy_(stepmod.host_to_device(due, self.device),
                           non_blocking=True)
            fms, asas = bool(fms.any()), bool(asas.any())
            if self.gen is not None:
                stepmod.seed_worlds(self.gen, self.clocks.rng)
        else:
            fms, asas, clk = stepmod.next_clocks(self.clocks, self.cfg)
            if self.gen is not None:
                self.gen.manual_seed(stepmod.noise_seed(self.clocks))
        if asas:
            self._body(fms, True)
        else:
            replay = self.replays.get(fms)
            if replay is None:
                self.replays[fms] = _capture(
                    lambda: self._body(fms, False), self.device, self.gen)
            else:
                replay()
        self.clocks = clk

    def apply(self, fn):
        """Run ``fn(state)`` eagerly and write its result back."""
        write_back(self.bufs, [t for _, t in leaves(fn(self.state))])

    def finish(self, keep: bool):
        """``(state, carry, simt)`` of the chunk: the buffers themselves,
        or copies of them with ``keep``; the folds and ``simt`` always as
        copies (they are reset by the next chunk)."""
        state = self.state
        if keep:
            state = rebuild(state, iter([t.clone() for t in self.bufs]))
        else:
            self.lent = True
        carry = rebuild(self.carry, iter([t.clone()
                                          for t in self.carry_bufs]))
        return state, carry, self.simt.clone()


def chunk_key(state, cfg, checked: bool, keep: bool):
    """The key of a chunk's executor (and of its captured graphs)."""
    return (cfg, checked, keep, state.device, signature(state))


def chunk(state, cfg, checked: bool, keep: bool) -> ChunkGraphs:
    """The executor of one chunk of ``state`` under ``cfg``, its buffers
    loaded.  The buffers of a returned state are reused only when that
    state (or one made from it) comes back, which donates it as in JAX;
    a chunk of any other state gets new buffers and graphs.  A returned
    state that comes back under another configuration (a stack command
    changed the CD backend or the resolver) donates its buffers to that
    configuration's new executor, which captures its own graphs on them:
    the state is not copied, and the executor it came from is dropped.
    ``keep`` chunks own buffers of their own and return copies, so they
    write neither their input nor a state returned before."""
    key = chunk_key(state, cfg, checked, keep)
    ex = _CHUNKS.get(key)
    if ex is None or (ex.lent and not ex.owns(state)):
        _miss()
        lender = None if keep else _lender(state, key)
        ex = _CHUNKS[key] = ChunkGraphs(
            state, cfg, checked,
            static=lender.static if lender is not None else None)
    ex.start(state)
    return ex


def _lender(state, key):
    """The executor of another configuration, of the same layout and
    not ``keep``, whose buffers ``state`` holds; removed from the table
    (a chunk of ``state`` donates the buffers)."""
    for k, ex in list(_CHUNKS.items()):
        if k != key and not k[2] and k[3:] == key[3:] and ex.lent \
                and ex.owns(state):
            del _CHUNKS[k]
            return ex
    return None


def release(state):
    """Declare that ``state``, a state a runner returned, will not be
    read again: the executor whose buffers it holds may reuse them for
    a chunk of any state (``chunk`` then copies that state in instead of
    allocating new buffers and capturing new graphs)."""
    for ex in _CHUNKS.values():
        if ex.lent and ex.owns(state):
            ex.lent = False
