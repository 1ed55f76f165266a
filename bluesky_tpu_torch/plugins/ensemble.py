"""Device-side Monte-Carlo ensembles: ENSEMBLE n time [spread].

The reference parallelizes Monte-Carlo studies as a PROCESS farm (the
server's BATCH split, network/server.py) — one OS process per replica.
This plugin is the on-device counterpart with no reference equivalent:
the CURRENT traffic scene is replicated on the device with per-replica
initial-condition jitter and stepped as ONE stacked program
(``parallel.sharding.ensemble_step_fn``: each chunk advances every
replica in one pass of the step, the CD kernels walking the replicas'
slabs together), so a 64-replica study of a 500-aircraft scene costs
the launches of one chunk instead of 64 processes.  On a mesh of
several cards each owns whole replicas, with no traffic between them.

Usage from the stack:

    CRE ... / IC scenario.scn        # set up the scene
    ENSEMBLE 32 60 500               # 32 replicas, 60 sim-s, 500 m jitter

Reports conflict/LoS count statistics across the ensemble — the
uncertainty band the reference MC studies compute from BATCH logs.

Port of ``bluesky_tpu/plugins/ensemble.py``, with the jitter and the
stepping split so that callers may also use them one by one: ``jitter``
(the replicas' starting states) and ``step`` (their chunks, with the
per-interval counts); ``final`` keeps the last run's end states.  The
jitter draws from an explicit ``torch.Generator`` on the state's
device, seeded from the base state's ``rng`` and the run counter, so
repeated ENSEMBLE calls draw fresh replicas; each replica's ``rng`` is
a fresh seed of the same draw (JAX's 5-way key split gives each replica
a fresh stream).  The draws cannot equal JAX's ``jax.random`` ones;
their law is the same.
"""
import numpy as np
import torch


def init_plugin(sim):
    ens = Ensemble(sim)
    config = {
        "plugin_name": "ENSEMBLE",
        "plugin_type": "sim",
    }
    stackfunctions = {
        "ENSEMBLE": [
            "ENSEMBLE nreps,time[,spread]",
            "int,float,[float]",
            ens.run,
            "Monte-Carlo the current scene on-device: nreps jittered "
            "replicas stepped as one vmapped program",
        ],
    }
    return config, stackfunctions


class Ensemble:
    MAX_SLOTS = 2_000_000        # nmax*nreps guard (device memory)

    def __init__(self, sim):
        self.sim = sim
        self.last = None         # stats dict of the last run
        self.final = None        # the replicas' end states (stacked)
        self._runs = 0           # per-call entropy for the jitter seed
        self._cache = {}         # (cfg, nreps, nmax, nsteps) -> runner
        self._ndev = 1

    def run(self, nreps, tend, spread=500.0):
        sim = self.sim
        nreps = int(nreps)
        n = sim.traf.ntraf
        if n == 0:
            return False, "ENSEMBLE: no traffic in the scene"
        if nreps < 2:
            return False, "ENSEMBLE: need at least 2 replicas"
        nmax = sim.traf.state.nmax
        if nmax * nreps > self.MAX_SLOTS:
            return False, (f"ENSEMBLE: {nreps} x nmax {nmax} exceeds "
                           f"{self.MAX_SLOTS} slots — shrink one")
        # A dense-allocated state carries the [nmax, nmax] pair matrix,
        # which every replica would copy — bound that memory too.
        if sim.traf.state.asas.resopairs.numel() * nreps > 256_000_000:
            return False, ("ENSEMBLE: the [N,N] pair matrix x nreps "
                           "would exceed device memory — run the sim "
                           "with a tiled allocation "
                           "(Traffic(pair_matrix=False)) for large "
                           "ensembles")
        sim.traf.flush()
        self._runs += 1
        states = self.jitter(sim.traf.state, nreps, spread, self._runs)
        self.final, (peak_conf, peak_los, mean_conf, mean_los) = \
            self.step(states, self.config(), tend)
        self.last = dict(nreps=nreps, tend=float(tend),
                         spread=float(spread),
                         peak_conf_mean=float(peak_conf.mean()),
                         peak_conf_std=float(peak_conf.std()),
                         mean_conf_mean=float(mean_conf.mean()),
                         peak_los_mean=float(peak_los.mean()),
                         mean_los_mean=float(mean_los.mean()))
        return True, (
            f"ENSEMBLE {nreps} x {float(tend):.0f}s (jitter "
            f"{float(spread):.0f} m) on {self._ndev} device(s), "
            f"conflict PAIRS sampled each CD interval:\n"
            f"  peak conflicts {peak_conf.mean():.1f} "
            f"+- {peak_conf.std():.1f} "
            f"(min {peak_conf.min():.0f}, max {peak_conf.max():.0f})\n"
            f"  mean conflicts {mean_conf.mean():.2f} "
            f"+- {mean_conf.std():.2f}\n"
            f"  peak LoS       {peak_los.mean():.1f} "
            f"+- {peak_los.std():.1f}")

    @staticmethod
    def jitter(base, nreps, spread, run):
        """``nreps`` stacked copies of ``base`` with gaussian position
        noise of ``spread`` metres and 0.5 m/s TAS and GS noise on the
        active slots — the classic MC-over-uncertainty setup the
        reference runs as BATCH process replicas.  A pure function of
        ``base`` (its ``rng`` seeds the draw), the arguments and the run
        number ``run``.  ``base`` is not changed."""
        from ..parallel import sharding
        words = np.random.SeedSequence(
            [int(base.rng) & (2**64 - 1), int(run)]).generate_state(
                nreps + 1, np.uint64)
        ac = base.ac
        dev, dtype = ac.lat.device, ac.lat.dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(words[0] >> np.uint64(1)))
        noise = torch.randn((4, nreps, ac.lat.shape[-1]), generator=gen,
                            dtype=dtype, device=dev)
        mlat = spread / 111_000.0
        mlon = mlat / torch.clamp_min(torch.cos(torch.deg2rad(ac.lat)), 0.2)
        states = sharding.stack_replicas([base] * nreps)
        act = ac.active
        for k, (name, scale) in enumerate((("lat", mlat), ("lon", mlon),
                                           ("tas", 0.5), ("gs", 0.5))):
            col = getattr(states.ac, name)
            col.copy_(torch.where(act, col + noise[k] * scale, col))
        # a fresh rng stream for every replica
        return states.replace(rng=np.asarray(words[1:], np.uint64))

    def config(self):
        """The sim's FULL config (simdt, noise, ASAS settings) with only
        the replica-hostile pieces changed: dense CD above 4,096 slots
        becomes tiled, and any aircraft-axis mesh is dropped (replicas
        shard on 'ens', not 'ac')."""
        sim = self.sim
        backend = sim.cfg.cd_backend
        if backend == "dense" and sim.traf.state.nmax > 4096:
            backend = "tiled"
        return sim.cfg._replace(cd_backend=backend, cd_mesh=None)

    def step(self, states, cfg, tend):
        """Step the stacked replicas to ``tend`` in CD-interval chunks,
        accumulating per-replica peak and mean conflict/LoS pair counts
        (one host read of the counts per chunk) — sampling only the
        final step would miss every conflict that resolves before
        ``tend``.  Returns ``(states, (peak_conf, peak_los, mean_conf,
        mean_los))``.  The chunk runner is cached across calls."""
        from ..parallel import sharding
        nreps = len(states.simt)
        nmax = states.ac.lat.shape[-1]
        dev = states.ac.lat.device
        # Cover tend exactly: whole CD-interval chunks plus one
        # remainder chunk.
        chunk = max(1, int(round(cfg.asas.dtasas / cfg.simdt)))
        total = max(1, int(round(float(tend) / cfg.simdt)))
        nchunks, rem = divmod(total, chunk)
        plan = [chunk] * nchunks + ([rem] if rem else [])

        def get_runner(nsteps):
            ck = (cfg, nreps, nmax, nsteps)
            runner = self._cache.get(ck)
            if runner is None:
                devs = sharding.default_devices(dev)
                mesh = sharding.make_ensemble_mesh(
                    min(nreps, len(devs)), devices=devs)
                runner = sharding.ensemble_step_fn(mesh, cfg,
                                                   nsteps=nsteps)
                if len(self._cache) > 2:    # keep the latest plan only
                    self._cache = {}
                self._cache[ck] = runner
                self._ndev = mesh.devices.size
            return runner

        peak_conf = np.zeros(nreps)
        peak_los = np.zeros(nreps)
        sum_conf = np.zeros(nreps)
        sum_los = np.zeros(nreps)
        for nsteps in plan:
            states = get_runner(nsteps)(states)
            counts = torch.stack([states.asas.nconf_cur,
                                  states.asas.nlos_cur]).cpu().numpy()
            nconf = counts[0] / 2.0     # pairs
            nlos = counts[1] / 2.0
            peak_conf = np.maximum(peak_conf, nconf)
            peak_los = np.maximum(peak_los, nlos)
            sum_conf += nconf
            sum_los += nlos
        return states, (peak_conf, peak_los, sum_conf / len(plan),
                        sum_los / len(plan))
