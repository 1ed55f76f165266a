#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bluesky_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit (no CUDA device -> exit 2);
2. build: every CUDA source of ``bluesky_tpu_torch/csrc`` compiled by
   ``nvcc`` for sm_90a, all sources at once;
3. kernel checks: each hand-written kernel against its plain PyTorch
   version on the card, in float32, at its default work items per row
   and at ``SPLIT`` (most rows cut in two), the split launch made twice
   and required bit-equal, and bit-equal to the default launch but for
   the three MVP sums; the work items that ``cd_mask_items`` builds on
   the card held against its plain version's.  The sparse path's two
   kernels on three
   geometries (continental, the 230 nm regional clump with overflow
   rows, an equator-crossing fleet), each for a fresh and a resumed
   partner table, and the overflow kernel timed on the clump; the
   pallas full grid on the same three geometries in Morton order; the
   candidate kernel on eight clusters, at a capacity most rows fit and
   at one that sends most rows to the full grid.  Each pallas check also
   holds ``detect_resolve_pallas`` with candidates against the one
   without.  Then the Eby and Swarm forms of every kernel the same way:
   K1 and K3 on the continental check, K2 on the resumed regional clump,
   K4 (Eby only: the candidate pass has no Swarm form) on the clusters
   at ``cand_cap=4096``;
4. sparse path: 100,000 aircraft of the continental geometry in
   100,352 slots, built with ``Traffic.create/flush``, under
   ``SimConfig(cd_backend="sparse", cd_block=256)``: the sort refresh
   and 20 steps of ``run_steps``, three times, with every kernel's launch
   count taken over exactly that run; then the timings of each kernel,
   its plain version and its bound at the path's shapes;
5. pallas path: the same scene under ``SimConfig(cd_backend="pallas",
   cd_block=256)``: the Morton refresh and 20 steps, three times, then
   ``detect_resolve_pallas(cand_cap=4096)`` on the stepped state, with
   the launch counts taken over exactly that run; then the same
   timings for the pallas kernels, and the candidate kernel's once more
   at a capacity most rows fit.  Every kernel timed at the main path's
   shapes is checked there as in phase 3 first.  Then phases 4 and 5
   once more under each of ``reso_method="EBY"``, ``"SWARM"`` and
   ``"SSD"`` (with pallas and EBY one candidate-mode call too): the chunk
   rate, one ASAS interval (and one more under
   ``torch.cuda.set_sync_debug_mode("error")``: no host read) and the
   peak memory of each, and the Eby and Swarm form of every kernel on
   the path timed and bounded at its shapes (SSD runs the MVP forms);
6. dense path: 10,000 aircraft of the 230 nm regional circle in 10,240
   slots, ``Traffic(pair_matrix=True)``, under ``SimConfig(cd_backend=
   "dense")`` (the default configuration of both packages): 20 steps,
   three times, then one ASAS interval and one step without CD timed
   alone; then one dense interval under each of EBY, SWARM and SSD with its
   peak memory;
7. tiled path: phase 4's scene under ``SimConfig(cd_backend="tiled",
   cd_block=512)``: the Morton refresh and 20 steps, three times, then
   one ASAS interval and one refresh timed alone, with the reachable
   tiles and the eager row iterations of an interval (at most nb);
8. dense against tiled on the card in float64 (N=2,048 regional), and
   the dense CD&R on the card against the same call on the CPU; then the
   dense and tiled intervals under EBY and SWARM against each other, and
   under SSD each against the same call on the CPU.
   Phases 6-8 run no kernel: the JAX package computes them in plain
   XLA, the port in plain PyTorch;
9. graph phase: on phase 4's sparse and phase 5's pallas scene and on
   phase 6's dense one (MVP), a chunk through ``step`` in a Python loop
   against one through the runners, which replay CUDA graphs for the
   steps without an ASAS interval, from copies of the same state: every
   state tensor bit-equal, the host clocks equal and the device ``simt``
   equal to the host's, flags off and with ``checked``, ``scanstats``,
   ``fingerprint`` (and ``inscan_refresh`` on sparse), on dense with
   noise on too; the checked runner's bad step with a NaN in a live row,
   chunk k's telemetry after chunk k+1, ``run_steps_edge_keep``'s input
   (sparse and dense); then eager against graphed chunks and steps
   without CD, alternating for three rounds, each profiled once (host
   launch calls per step, busy share), and the host synchronisations
   inside each runner's chunk;
10. Simulation phase (``sim_phase``): the embedded ``Simulation`` on the
    card, driven through its stack as a user types it.  100,000 aircraft
    (``MCRE`` in a 25 x 25 deg continental view, 100,352 slots, the
    default ``Traffic(pair_matrix=True)``) under CDMETHOD SPARSE and
    ASAS ON, then CDMETHOD PALLAS and RESO EBY: the loop's rate against
    the bare runner's, per chunk the wall, edge-pull and dispatch-gap
    ms and the host syncs, pipelined against ``chunk_pipeline`` off,
    graph captures per MCRE, a ring capture, the busy share and peak
    memory, with K1, K2 and K3 launched through ``Simulation.run``
    (their counts are the ``sim_launches`` of the kernels line).  Then
    10,000 aircraft of the regional view through the same command
    script on the card and on the CPU (plain versions), float64, under
    CDMETHOD DENSE for one ASAS interval (the CPU's float64 dense half
    took 95 s for two), then SPARSE and PALLAS for two each, held
    against each other after every interval (``compare_sims``), each
    interval's CD from the same inputs.
11. worlds phase (``worlds_phase``, at ``WORLDS_SCALE``): world-batched
    stepping.  Sparse and pallas (MVP) on 128 worlds of 500 aircraft of
    the regional geometry (world w from numpy seed w) in 512 slots each,
    sparse EBY on 8 worlds of 10,000 in 10,240 slots, dense on 8 worlds
    of 2,000 in 2,048 (each world count half the shape's, for time): three chunks (sort refresh and 20 steps) of the stack through
    ``run_steps_worlds_edge``, with the launch counts set to 0 just
    before and read just after (each kernel once per ASAS interval for
    the whole group, or the run fails), and the host syncs of a stacked
    chunk (none, or the run fails); then the same chunks world by world
    through ``run_steps_edge``, every world held to its solo run (flags,
    counts and partner sets equal, floats within the float32 bounds,
    bit-equality reported); ms per chunk, aggregate aircraft-steps/s,
    launches per interval and peak memory of both.  The world-group
    launches of K1 and K2 (sparse) and K3 (pallas) are held against their
    plain versions on the stacked operands and timed with their bounds:
    the ``/worlds`` entries of the kernels line.  Then 2 BATCH pieces of
    500 aircraft (CRE lines from numpy seeds, CDMETHOD SPARSE, ASAS ON,
    FF 60, the guard on) through ``WorldBatch.run()`` (8 until phase 19
    came, 4 until phase 21 came), each held to a solo ``Simulation``.
12. differentiable phase (``diff_phase``): gradients through the smooth
    dense step (``bluesky_tpu_torch/diff``; no kernel runs on this path,
    and the launch counts must read 0 after it).  (a) 25 head-on pairs
    (``conflict_scene(50)``) in a float64 ``Simulation`` on the card, ``OPT
    100,4,0.5`` typed into its stack (4 iterations, cut from 10 for
    time: both reach no hard LoS, where 3 leave 6 pairs in float64 on
    the CPU): the guard clean, hard
    LoS before and none after, the objective falling, the wall seconds of each
    descent iteration; (b) the same with 4 restarts on the world axis;
    (c) ``value_and_grad_once`` on ``conflict_scene(8)`` in float64 on
    the card against the CPU, ASAS out of the loop and in it (value and
    gradient within 1e-9, equal guard words); (d) the rollout of
    2,000 aircraft in 2,048 slots (float32, 50 steps of 1 s; 400, then
    100 until it was cut for time) without
    and with ASAS: forward and forward+backward ms, peak memory,
    gradient norm, with the card's name and power limit.
13. partner width phase (``kwide_phase``): partner tables K = 16 and
    K = 64 wide (``Traffic(k_partners=K)``, the path JAX's users take for
    denser studies; past K = 32 the walker and the merge run their wide
    form, the top-K lists in device memory).  (a) every kernel form (K1,
    K2, K3 in MVP, Eby and Swarm; K4 in MVP and Eby) at K = 16 and 64 and
    the MVP forms at K = 1, 3, 32, 33 and 128, each against its plain
    version on the check shapes of phase 3, the MVP and Eby forms at
    K = 64 and the MVP forms at 33 and 128 also on a clump of 700
    aircraft within 0.36 deg (block 64; rows with more than 32
    partners), and the three mesh forms
    (``rows``, ``col0``, ``gid``) at K = 64 MVP as phase 14 (a) checks
    them; (b) phases 4 and 5 at K = 16 and at K = 64: ``main_scene``
    through three 20-step chunks on sparse and pallas, the
    candidate-mode call, the chunk rate, ASAS interval, peak memory and
    rows with more than 8 (and 32) partners, each kernel timed, bounded
    and held to its plain version on sampled row blocks
    (``sampled_holds``; whole grids until phase 21 came), and at K = 64
    also K1-K4 at K = 33 and 128 on the same operands (the partner table
    cut or widened by empty slots; 0 launches: off the path); (c)
    ``regional_scene``
    (10,000 in 10,240 slots) at K = 64 on sparse and pallas under EBY,
    SWARM and SSD, with the Eby candidate call; (d) one stacked worlds
    group at K = 64 (16 x 2,000 sparse MVP), each world held to its solo
    run; (e) one ``snapshot.save`` and one ``snapshot.load`` of a 100k
    K = 64 ``Simulation``: ms, bytes, and the restored state bit for bit
    the saved one.  Each part logs its seconds.  The kernels line lists
    the K = 16, 33, 64 and 128 forms by ``kname``; the phase fails if a
    K = 64 form goes unmeasured.
14. shard phase (``shard_phase``): the shard modes on ``SHARDS`` = 4
    shards of the one card (a mesh that repeats ``cuda:0``).  (a) every
    mesh form of the walker (``MESH_FORMS``: K1's row subset, ``col0``
    halo window and gid table, K2's and K3's row subset and window) in
    MVP, Eby and Swarm at K = 8 and MVP at K = 16 against its plain
    version on the check shapes of phase 3, the row subsets also bit-equal
    to the single-device launch's rows; (b) the 100k continental scene in
    200,000 slots (2 x the fleet, as JAX's bench sizes the spatial and
    tiles runs) in a ``Simulation``, CDMETHOD SPARSE, ``set_shard`` with
    ``devices=[cuda:0] * 4`` in REPLICATE 4, SPATIAL 4 and TILE 2x2, and
    CDMETHOD PALLAS in REPLICATE 4: 3 s of ``Simulation.run`` (FF) with
    the launch counts set to 0 just before and read just after (each
    mode's forms, ``SHARD_MODES``, launched), then 60 steps on the mesh
    and on the single-device reference of the mode, every state tensor
    bit-equal, the ASAS interval ms of both, the chunk rate and the peak
    memory; (c) every mesh form timed, bounded and held to its plain
    version at the shapes the main path gave it (the first call of each,
    ``capture_mesh_calls``; K3's window, on no path, on the pallas
    operands).  The kernels line lists the mesh forms by ``mesh_name``.
15. entry phase (``entry_phase``): the worker entry points.  (a) the
    command line in-process, ``bluesky_tpu_torch.__main__.main(
    ["--detached", "--scenfile", scn])`` with no config file (so the
    default device, CUDA): a scenario of CDMETHOD SPARSE, ASAS ON, the
    continental view, SEED 1, MCRE 1000 B744, OP and FF, then at 30 s
    SNAPSHOT SAVE and QUIT; exit 0, the snapshot at 1,000 aircraft and
    simt 30 (within one 0.05 s step), the state on ``cuda``, K1 launched, the telnet bridge's
    thread gone after QUIT.  (b) ``DetachedSimNode(nmax=SIM_NMAX)`` fed
    phase 10's continental session as STACKCMD events (SEED 1, MCRE
    100000), stepped with ``node.step()`` (ScreenIO streaming SIMINFO
    and ACDATA) for 10 fast-time chunks, ``node.streams`` drained after
    each, then 3 chunks under CDMETHOD PALLAS: ms per chunk against
    phase 10's embedded rate, ms and bytes per ACDATA frame (from the
    chunk edge and from the live state), the streams' bytes buffered a
    chunk, K1, K2 and K3 launched (the ``entry_launches`` of the kernels
    line); then an embedded ``Simulation`` given the same commands, seed
    and chunk count, every state tensor bit-equal to the node's.
16. fabric phase (``fabric_phase``): the port's own server on the card,
    ``python -m bluesky_tpu_torch --headless --config-file cfg`` in its
    own process group, the config on free ports with ``telnet_port = 0``
    and no ``device`` key (so the spawned workers, ``python -m
    bluesky_tpu_torch --sim`` with the same config, run on CUDA), the
    port's ``Client`` attached.  (a) ``max_nnodes = 2``: ``BATCH`` of 4
    pieces (ASAS ON, CDMETHOD SPARSE three times and PALLAS once, a 4 x
    4 deg regional view, SEED k, MCRE 1000 B744, OP, FF; at 60 s
    SNAPSHOT SAVE and HOLD): two workers spawned and registered, each
    piece completed exactly once in the journal and none crashed, each
    snapshot bit-equal to an embedded ``Simulation`` given the same
    lines; spawn-to-REGISTER seconds, device memory per process
    (``nvidia-smi --query-compute-apps``), sim-s per wall-s of each
    piece against its embedded run.  (b) ``world_pack = True``,
    ``world_batch_max = 8``, ``max_nnodes = 1``: 8 SPARSE pieces of 500
    aircraft in one WORLDS pack (one dispatch, each piece completed
    once, each bit-equal to its solo embedded run).  (c) a 100k
    continental ``SimNode`` of this process on the (b) server's worker
    ports, ACDATA through the broker to a SUB socket for 3 fast-time
    chunks: ms from publish to receipt and wire bytes of each frame.
    Each server is stopped with SIGTERM: exit 0, its journal's last
    record the clean-exit ``shutdown``, no process of its group left.
    The workers' K1, K2 and K3 launches come from their last log line
    (``__main__._log_launches``): the ``fabric_launches`` of the kernels
    line, the (a) workers' on the MVP forms, the pack worker's on the
    ``/worlds`` forms.
17. mesh-epoch phase (``epoch_phase``; ROADMAP A9 step 2): on
    ``main_scene``'s 100,000 aircraft in 200,000 slots, (a) SHARD
    REPLICATE 4 on 4 x the card under SPARSE and then PALLAS, the
    snapshot ring every simulated second, FAULT MESHKILL 1: the trip log
    ``mesh_lost``, ``resharded``, epoch 1 on 2 shards, the state 3 s
    later bit-equal to a fresh ``Simulation`` restored from the same ring
    blob on a 2-shard mesh, the ms from the trip to the first re-sharded
    chunk; (b) the same on TILE 2x2 (the survivors re-form the first
    layout of tiles -> spatial -> replicate that holds on 2 shards); (c)
    two ``scripts/torch_multihost.py`` processes on the card
    (``init_multihost(backend="gloo")``, each rank owning 2 of the 4
    shards), REPLICATE under SPARSE and PALLAS, SPATIAL and TILE 2x2, 3
    chunks of 20 steps each, each rank bit-equal to the single-process
    4-shard mesh, the fingerprints
    compared at every chunk edge, chunk ms, bytes and collectives per
    rank per interval, the backend printed (NCCL not measured on one
    card); (d) ``ensemble_step_fn`` on an 8 x card ``("ens",)`` mesh of
    8 x 10,000 ``regional_scene`` sparse replicas (seeds 0-7), each
    bit-equal to its solo run, aggregate aircraft-steps/s against one at
    a time; (e) (c)'s replicate job with rank 1 SIGKILLed after 2
    chunks: rank 0's ``MeshGuard.guarded_ready`` raises
    ``MeshLostError`` naming rank 1 within the dispatch and heartbeat
    budgets, and rank 0's resumed run from its last snapshot on its own
    2 shards is bit-equal to a fresh run from that snapshot; its chunk
    ms with the guard on the joins are logged beside (c)'s without.  The
    launches of (a)-(b), (c) (both ranks) and (d) are the
    ``meshkill_launches``, ``multihost_launches`` and
    ``ensemble_launches`` of the kernels line.
18. no-partner phase (``noresume_phase``, after phase 5's resolver
    paths; ROADMAP A10.1 and B4): ``cd_sched.detect_resolve_sched``
    without a partner table (JAX's CD-only sparse form) on
    ``main_scene``'s 100,000 aircraft (block 256, K = 8) and on the
    regional clump (8,192 aircraft, ``s_cap=2``: overflow rows with real
    tiles), in MVP, Eby and Swarm, the launch counts set to 0 just
    before and read just after: K1's no-resume form (``cd_full_grid``
    over the segment blocks) and K3 on the overflow rows launched,
    nothing else; the clump's whole pass held to its plain versions on
    the card; a 500-aircraft call bit-equal to ``detect_resolve_pallas``
    (the hand-off of at most two blocks); each form timed and bounded
    (K1 at 100k, K3 on the clump): the ``/noresume`` and ``/overflow``
    entries of the kernels line.
19. plugins phase (``plugins_phase``; ROADMAP A10.2-A10.4): (a) the
    synthetic BADA and BS files of ``models/synthetic.py`` (the ones the
    CPU tests read) under ``performance_model`` "bada" and "bs": a
    10,000-aircraft ``regional_scene`` Simulation of their types under
    SPARSE (block 256, no pair matrix), every ``PerfArrays`` column on
    the card bit-equal to a CPU ``Traffic`` of the same types, 3 chunks,
    K1/K2 launched; ``ops/perf_legacy`` and ``ops/perf_bada`` on 100,000
    float32 rows on the card against float64 on the CPU within
    ``PERF_RTOL``, phase codes and flags equal (``perf_rows``' grids keep
    every threshold out of float32 rounding); (b) the same fleet 30
    sim-s without plugins and 30 with AREA, SECTORCOUNT, GEOVECTOR and
    TRAFGEN, every hook at 1 s: sim-s per wall-s of each, the host syncs
    per pipelined chunk without plugins ([0, 0]), the ``plugin`` sync
    reasons, graph captures and compile misses after warm-up (0), host
    ms per hook call; at every edge AREA deleted only aircraft outside
    its box, SECTORCOUNT's count equals a recount of the card's
    positions, TRAFGEN created what its Poisson draws asked for; (c)
    PLUGINS LOAD ENSEMBLE and ENSEMBLE 8 10 500 on 2,000 regional
    aircraft in 2,048 slots, each replica bit-equal to a solo
    ``run_steps`` from the same jittered start, aggregate aircraft-steps/s;
    (d) ``scenario/sample.so6`` converted, IC'd into a 1,024-slot
    Simulation and flown 200 sim-s (its last flight starts at 180 s):
    every flight created.  The launches of (b) and (c) are the
    ``plugin_launches`` and ``plugin_ensemble_launches`` of the kernels
    line.
20. UI phase (``ui_phase``; ROADMAP A10.7, A10.9): (a) the web session:
    ``plugin_sim``'s 10,000 regional aircraft in 10,240 slots (SPARSE,
    block 256, no pair matrix) served by ``ui.web.serve_sim(sim,
    run=False)`` on a free loopback port, the script's own loop pumping
    the backend and stepping ``UI_T`` sim-s of FF without a viewer and
    ``UI_T`` more with a ``urllib`` viewer thread pulling ``/frame.svg``
    at ``UI_FPS``: sim-s per wall-s of each, pipelined and synchronous
    chunks with their sync reasons, host syncs per iteration with and
    without a render (``count_syncs``), render ms and SVG bytes per
    frame; then a CRE posted to ``/cmd`` is in the next frame, a click
    at an aircraft's position on an empty line gives its callsign, and
    SSD CONFLICTS and ND give one frame each (discs drawn, the ND
    served).  (b) SCREENSHOT on phase 10's 100,000-aircraft Simulation
    (``screenshot_100k``, before its profiling): ms and bytes of the
    file, which parses as XML with one glyph per live aircraft.  (c)
    the attached mirror on phase 16 (c)'s fabric: a ``GuiClient`` on the
    server's ports takes the 100k wire node's ACDATA, and ``render_svg``
    of its ``nodeData`` gives one glyph per aircraft.  (d) the host
    geodesy core: ``ops.hostgeo.compiled`` True (built with the host
    compiler), ``UI_GEO_PAIRS`` pairs of qdrdist, qdrpos and kwikqdrdist
    through the C path and the NumPy path, equal within 1e-12 relative
    (1e-9 absolute for coinciding pairs), ms of each.  The UI launches
    no kernel of its own.

21. scale phase (``scale_phase``): the JAX package's largest fleets, as
    its ``bench.py`` makes them (``bench_columns``: numpy seed 0, B744,
    the draws in its order) and drives them (``bench.run_one``: the sort
    refresh, then a chunk of ``run_steps``; here 20-step chunks through
    ``run_steps_edge``), block 256, MVP, K = 8, ``Traffic(pair_matrix=
    False)``.  (a) ``global_scene``: 1,000,000 aircraft worldwide
    (area-uniform to +-70 deg, every longitude) in 1,000,000 slots under
    SPARSE: a warm-up chunk and three timed ones with the launch counts
    set to 0 just before and read just after (``scale_chunks``: the last
    chunk's ms and aircraft-steps/s, peak memory, the graph captures'
    ms), the ASAS interval and the sort refresh timed alone; (b) the
    same stepped state under PALLAS, the same way; (c) on the stepped
    sparse state's next interval: the sparse and pallas CD equal in
    flags, ``nconf``, ``nlos`` and every ownship's conflict and LoS
    counts; those counts of ``WITNESS_OWN`` sampled ownships (the
    ``SCALE_LAST`` highest sparse slots and caller slots among them)
    against a float64 brute force over the whole fleet on the card
    (``witness_counts``: the tile body's pair math, every difference
    covered by pairs within ``WITNESS_MARGIN`` of a threshold, counted
    and logged); each launched form (K1 and K2 sparse, K3 pallas, and K3
    on the sparse overflow rows if there are any) held against its plain
    version on sampled row blocks (``sample_rows``: the last
    ``SCALE_LAST`` occupied or overflow row blocks, which hold the
    largest offsets, and ``SCALE_RANDOM`` drawn ones), timed whole and
    bounded; (d) ``bench_scene`` of the regional draws: 100,000 aircraft
    in the 230 nm circle in 100,352 slots under SPARSE: a warm-up chunk and two
    timed ones, the interval timed alone, K1, K2 and (off the path) K3
    on the overflow rows held on sampled rows, timed and bounded; it
    fails without overflow rows.  The kernels line lists these forms
    with ``/scale_global``, ``/scale_regional`` and ``_overflow``
    (``SCALE_FORMS``), each with its path's numbers (``path_*``).

Phase 10 ends with the profiling of the 100k Simulation
(``profile_phase``, ROADMAP A10.5): under CDMETHOD SPARSE the host syncs
of two chunks with devprof off and with the memory sample at every edge
(equal; ``devprof_live_bytes_total`` above 0), ``PROFILE DEVICE 2`` (the
trace file's size and its top device ops), the syncs once more (equal),
and ``PROFILE KERNELS 20``.

Every ``run_steps`` of phases 4-8 runs graphed chunks (``core/graph.py``).

Every kernel also logs its work items, longest item and the time of its
row merge alone (K2 on the clump as well, K4 at both capacities); every
walker's registers and spills (each resolver form, ``WALKERS``) come
from the ``-Xptxas -v`` report of the build.  The run fails if a kernel
form of ``FORMS`` or of phase 18 was never measured.  The card's power draw, clocks and temperature are logged before
phase 3 and after each later phase.  It prints one JSON line describing
every kernel, then the ``nvidia-smi`` name and power limit, then the
result line ``{"ok": true, "device": {...}}``.
"""
import faulthandler
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

#: when the script started (``log_card`` reports the seconds since)
T_START = time.perf_counter()
#: seconds after which the script dumps every thread's stack to standard
#: error (the check stops it at 1,200 s)
STACKS_AFTER_S = 1100

#: H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate
#: outside the tensor cores.  The float32 rate counts a fused
#: multiply-add as two operations; the kernels are built with
#: --fmad=false, so they reach at most half of it and the bound errs low.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: float32 operations per active pair of a visited tile in the tile body
#: of csrc/cd_tiles.cu, counted by hand: every float32 add, multiply,
#: divide, compare, select, abs, min/max, rint, sqrt and rsqrt once;
#: integer and boolean operations are not counted.  The activity test 1,
#: geometry 116 (cos/sin sums 6, the two radii and their choice 27,
#: dlat/dlon 8, the four sin polynomials and their products 48, the
#: clamped root 7, the arcsine distance 13, the bearing normalization
#: 7), CPA and entry/exit times 44, the conflict and LoS compares 6 and
#: the LoS count 1.  The MVP tail of the conflict pairs (~60 more) is
#: left out: conflicts are a small share of the pairs.
PAIR_FLOPS = 168
#: The resume keep predicate (cd_sched_tiles, for K1 and K2), run
#: only on the conflict pairs and the old-partner pairs: the relative
#: velocity 2, the flat-earth displacement 11, the past-CPA test 4, the
#: distance 4 and the keep compares 5.
KEEP_FLOPS = 26
#: The Eby form (cr_eby.pair_contrib in double precision, on the conflict
#: pairs only): the TAS velocity differences and the three sums 9 float32
#: operations; in float64 the scaling 6, the squared norms and dot product
#: 15, the quadratic's a, b, c and discriminant 12, the safe a 3, sqrt 1,
#: the two roots 8, their minimum 3, the position at tstar 6 and its norm
#: 6, the 10 m test 1 and transverse speed 6, the norm again 6, intrusion
#: and safe denominator 5, the scale 2 and the outputs 3: 84 (the 10 m
#: push, 8 more, is taken by almost no pair and left out).
EBY_F32_FLOPS = 9
EBY_F64_FLOPS = 84
#: The Swarm form: the distance test of every visited pair (2 products,
#: a sum, a compare: 4); on each neighbour pair (w = 1) the altitude test
#: 2, the track wrap and its test 8 and the seven sums 7: 17.  The pairs
#: that pass the distance test but are no neighbours are left out.
SWARM_PAIR_FLOPS = 4
SWARM_NEIGHBOUR_FLOPS = 17
#: H100 SXM float64 peak outside the tensor cores (NVIDIA data sheet).
PEAK_F64_FLOPS = 34e12

NM, FT = 1852.0, 0.3048
KERNELS = {
    "cd_sched._sched_kernel": dict(
        source="bluesky_tpu_torch/csrc/cd_tiles.cu",
        replaces="bluesky_tpu/ops/cd_sched.py:511"),
    "cd_pallas._kernel_resume": dict(
        source="bluesky_tpu_torch/csrc/cd_tiles.cu",
        replaces="bluesky_tpu/ops/cd_pallas.py:449"),
    "cd_pallas._kernel": dict(
        source="bluesky_tpu_torch/csrc/cd_tiles.cu",
        replaces="bluesky_tpu/ops/cd_pallas.py:96"),
    "cd_pallas._kernel_cand": dict(
        source="bluesky_tpu_torch/csrc/cd_tiles.cu",
        replaces="bluesky_tpu/ops/cd_pallas.py:494"),
}
#: the resolver forms of the kernels: MVP, Eby, Swarm (cd_pallas.RESO_CODE)
RESOS = ("mvp", "eby", "swarm")
#: the kernels of each form (the candidate pass has no Swarm form)
FORMS = [(k, r) for r in RESOS for k in KERNELS
         if not (r == "swarm" and k == "cd_pallas._kernel_cand")]


def form_name(kernel, reso):
    """The JSON name of a kernel's resolver form: the TPU kernel's name,
    with ``/eby`` or ``/swarm`` for those forms."""
    return kernel if reso == "mvp" else f"{kernel}/{reso}"


def kname(name, kk):
    """The JSON name of a kernel form at partner width ``kk``: ``/k<kk>``
    appended, nothing at the default K = 8."""
    return name if kk == 8 else f"{name}/k{kk}"


def walker_width(kk):
    """The suffix of a walker's K form in ``WALKERS``: none for the
    constant K = 8 form, ``/kwide`` for the run-time form up to K = 32,
    ``/wide`` for the wide form past it."""
    return "" if kk == 8 else "/kwide" if kk <= 32 else "/wide"


#: each form's walker, by a piece of its mangled name in the ``nvcc
#: -Xptxas -v`` report (items_kernel<RESUME, IDS, RESO, KT, MESH>): the
#: constant K = 8 form (KT = 8), with ``/kwide`` the run-time form of
#: the other K up to 32 (KT = 0), with ``/wide`` the form of K > 32 (KT =
#: KT_WIDE = -1, mangled ``n1``); with ``/mesh`` the mesh form (MESH) of
#: the shard modes
WALKERS = {
    form_name(k, r) + walker_width(kk) + mesh:
    "items_kernelILb{}ELb{}ELi{}ELi{}ELb{}E".format(
        int(k in ("cd_sched._sched_kernel", "cd_pallas._kernel_resume")),
        int(k == "cd_pallas._kernel_cand"), RESOS.index(r), kt, int(bool(mesh)))
    for k, r in FORMS for kk, kt in ((8, 8), (16, 0), (64, "n1"))
    for mesh in ("", "/mesh") if not (mesh and k == "cd_pallas._kernel_cand")}
#: phase 13 (``kwide_phase``): every kernel form at partner widths KWIDE
#: and KWIDER (the wide form), the MVP forms at KWIDE_MVP as well (33
#: and 128 also timed on the K = 64 path's operands)
KWIDE = 16
KWIDER = 64
KWIDE_MVP = (1, 3, 32, 33, 128)
#: candidate capacity of the pallas path's candidate-mode call
CAND_CAP = 4096
#: work items per row of the split checks, so that most rows split
SPLIT = 2


def log(*a):
    print(*a, flush=True)


def nvidia_smi(fields="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def log_card(when):
    """One line of the card's power, clocks and temperature; and one line
    on standard error of the seconds since the script started, so that a
    run cut at its time limit shows how far it got."""
    fields = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
              "temperature.gpu")
    log(f"nvidia-smi {when} ({fields}): {nvidia_smi(fields)}")
    print(f"chip_smoke: {when}, {time.perf_counter() - T_START:.1f} s "
          "since the start", file=sys.stderr, flush=True)


def kernel_registers(report):
    """``{form name: (registers, spill store bytes, spill load bytes)}``
    of each walker of ``WALKERS`` from the ``-Xptxas -v`` report of
    cd_tiles.cu; logs each entry function's registers and spilled
    bytes."""
    regs, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"\d([a-z_]+_kernel)((?:I?L[bi]n?\d+E)*)", name)
            flags = [("true" if v == "1" else "false") if t == "b"
                     else v.replace("n", "-")
                     for t, v in re.findall(r"L([bi])(n?\d+)E", k.group(2))]
            short = k.group(1) + (f"<{', '.join(flags)}>" if flags else "")
            log(f"registers: {short}: {m.group(1)}, spill stores/loads "
                f"{spill[0]}/{spill[1]} bytes")
            for kernel, piece in WALKERS.items():
                if piece in name:
                    regs[kernel] = (int(m.group(1)), *spill)
    return regs


def columns(n, geom, seed):
    """Per-aircraft CD inputs of one geometry, from a numpy seed (the
    geometries of tests/test_cd_sched.py and, "clusters", the eight
    clusters ~550 km apart of tests/test_cd_pallas_candidates.py)."""
    rng = np.random.default_rng(seed)
    if geom == "clusters":
        centers = [(45 + 5 * (i // 4), -5 + 5 * (i % 4)) for i in range(8)]
        ci = rng.integers(0, 8, n)
        lat = np.array([centers[c][0] for c in ci]) + rng.normal(0, 0.3, n)
        lon = np.array([centers[c][1] for c in ci]) + rng.normal(0, 0.4, n)
    elif geom == "regional":
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 3.8 * np.sqrt(rng.random(n))
        lat = 52.6 + r * np.cos(ang)
        lon = 5.4 + r * np.sin(ang) / 0.6
    elif geom == "equator":
        lat = rng.uniform(-8.0, 8.0, n)
        lon = rng.uniform(-10.0, 30.0, n)
    else:
        lat = rng.uniform(35.0, 60.0, n)
        lon = rng.uniform(-10.0, 30.0, n)
    gs = rng.uniform(130.0, 240.0, n)
    trk = rng.uniform(0.0, 360.0, n)
    alt = rng.uniform(3000.0, 11000.0, n)
    vs = rng.uniform(-15.0, 15.0, n)
    active = rng.random(n) > 0.05
    return dict(lat=lat, lon=lon, trk=trk, gs=gs, alt=alt, vs=vs,
                active=active)


def cd_args(c, dev, t_ahead=0.0):
    """The detect_resolve_sched operands of ``c`` on ``dev``, positions
    moved ``t_ahead`` seconds along the tracks (flat earth)."""
    import torch
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    trk = np.radians(c["trk"])
    gse, gsn = c["gs"] * np.sin(trk), c["gs"] * np.cos(trk)
    lat = c["lat"] + gsn * t_ahead / 111320.0
    lon = c["lon"] + gse * t_ahead / (111320.0 * np.cos(np.radians(lat)))
    return [f(lat), f(lon), f(c["trk"]), f(c["gs"]), f(c["alt"]),
            f(c["vs"]), f(gse), f(gsn),
            torch.as_tensor(c["active"], device=dev),
            torch.zeros(len(lat), dtype=torch.bool, device=dev)]


def extra_col(c, reso, dev):
    """The resolver column of ``c`` on ``dev``, from a numpy seed: the TAS
    (Eby; 0.9-1.1 x gs) or the CAS (Swarm; 0.6-0.8 x gs); None for MVP."""
    import torch
    if reso == "mvp":
        return None
    rng = np.random.default_rng(21)
    lo, hi = (0.9, 1.1) if reso == "eby" else (0.6, 0.8)
    return torch.as_tensor(
        np.asarray(c["gs"] * rng.uniform(lo, hi, len(c["gs"])), np.float32),
        device=dev)


def reso_kw(reso, col, sched=True):
    """The resolver keywords of ``cd_sched.prepare`` (``sched``) or
    ``cd_pallas.prepare`` for the column ``col`` of ``extra_col``."""
    if reso == "mvp":
        return {}
    key = "tas" if reso == "eby" else "cas"
    if sched:
        return {key: col, "reso": reso}
    return {"extra_cols": {key: col}, "reso": reso}


def check_split(name, kern, want):
    """Hold ``kern()`` (the wrapper's default work items per row) and
    ``kern(per_row=SPLIT)`` against the plain outputs ``want``
    (``cd_pallas.compare_outputs``).  The split launch, made twice, must
    give equal bits, and equal bits to the default launch in every output
    but the three resolver sums and the Swarm sums (one tile body: only
    the sums add in another order), the top-K ids in order.  Returns
    ``(largest float difference, the default launch's outputs)``."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas
    whole, split, again = kern(), kern(per_row=SPLIT), kern(per_row=SPLIT)
    err = max(cd_pallas.compare_outputs(name, whole, want),
              cd_pallas.compare_outputs(f"{name} split {SPLIT}", split, want))
    sums = {2, 3, 4} | set(range(len(whole) - cd_pallas.N_SWARM,
                                  len(whole))) \
        if len(whole) in (17, 20) else {2, 3, 4}
    for j, (a, b, w) in enumerate(zip(split, again, whole)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} split {SPLIT}: output {j} "
                                 f"differs between two launches")
        if j not in sums and not torch.equal(a, w):
            raise AssertionError(f"{name} split {SPLIT}: output {j} "
                                 f"differs from the default launch")
    return err, whole


def check_items(name, mask, per_row):
    """Hold the work items ``cd_mask_items`` builds from the CUDA row mask
    ``mask`` against those of its plain version on the CPU
    (``compact_rows`` + ``work_items``) at ``per_row`` and at ``SPLIT``
    items per row: starts, lengths, launch order and each row's tiles
    equal."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas
    w = mask.shape[1]
    for c in (per_row, SPLIT):
        got = [t.cpu() for t in cd_pallas.mask_items(mask, c)]
        want = cd_pallas.mask_items(mask.cpu(), c)
        valid = torch.arange(w)[None, :] < mask.cpu().sum(1)[:, None]
        if not (all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
                and torch.equal(got[0][valid], want.tiles[valid])):
            raise AssertionError(f"{name}: the work items of cd_mask_items "
                                 f"differ from the plain ones at {c} a row")


def check_kernels(dev, errs, scale=1):
    """Phase 3, sparse backend: both kernels against their plain versions
    (fleet sizes divided by ``scale``), each also with at most ``SPLIT``
    work items per row.  Returns the JSON keys of the overflow kernel on
    the resumed regional clump, where it has real tiles (``measure`` and
    ``item_extra``, prefixed ``regional_``)."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp
    mvp = cr_mvp.MVPConfig(rpz_m=5 * NM * 1.05, hpz_m=1000 * FT * 1.05,
                           tlookahead=300.0)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, mvp, 5 * NM * 1.05)
    # The regional clump runs with s_cap=2: its stripe sort covers every
    # row with <= 3 segments, so the default s_cap=6 would leave the
    # overflow kernel without a real tile.
    for geom, n, s_cap in (("continental", 16384, 6), ("regional", 8192, 2),
                           ("equator", 8192, 6)):
        n //= scale
        c = columns(n, geom, seed=1)
        n_tot = cd_sched.padded_size(n, 256)
        table = torch.full((n_tot, 8), -1, dtype=torch.int32, device=dev)
        perm = None
        for t_ahead in (0.0, 20.0):
            # the resumed pass keeps the first pass's (now stale) layout,
            # in whose slot space its partner table is written
            x = cd_sched.prepare(*cd_args(c, dev, t_ahead), 5 * NM,
                                 1000 * FT, 300.0, table, block=256,
                                 s_cap=s_cap, perm=perm)
            perm = x.perm
            reach_f = x.reach & x.overflow[:, None]
            p1 = cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax,
                                            x.pold, p)
            p2 = cd_pallas.full_grid_resume_plain(x.packed, reach_f, x.pold,
                                                  p)
            tag = f"{geom} N={n} t+{t_ahead:g}s"
            e1 = check_split(f"sched_kernel {tag}",
                             lambda **kw: cd_sched.sched_tiles(
                                 x.packed, x.wst, x.wln, x.wmax, x.pold, p,
                                 **kw), p1)[0]
            k2_run = lambda **kw: cd_pallas.full_grid_resume(
                x.packed, reach_f, x.pold, p, **kw)
            e2, k2 = check_split(f"kernel_resume {tag}", k2_run, p2)
            check_items(f"kernel_resume {tag}", reach_f,
                        cd_pallas.RESUME_ITEMS_PER_ROW)
            items = cd_sched.window_items(x.wst, x.wln, x.wmax, x.nb, SPLIT)
            items2 = cd_pallas.reach_items(reach_f, SPLIT)
            errs["cd_sched._sched_kernel"] = max(
                errs["cd_sched._sched_kernel"], e1)
            errs["cd_pallas._kernel_resume"] = max(
                errs["cd_pallas._kernel_resume"], e2)
            merged = [torch.where(x.overflow[:, None, None], f, s)
                      for f, s in zip(p2, p1)]
            nconf = int(merged[6].to(torch.int32).sum())
            nlos = int(merged[7].to(torch.int32).sum())
            log(f"check {tag}: overflow rows {int(x.overflow.sum())}, "
                f"scheduled tiles {int(x.wln.sum())}, overflow tiles "
                f"{int(reach_f.sum())}, nconf {nconf}, nlos {nlos}, "
                f"max abs err sched {e1:.3g} resume {e2:.3g}: match; "
                f"split {SPLIT}: {split_rows(items)} and "
                f"{split_rows(items2)} rows split")
            if geom == "regional" and not int(x.overflow.sum()):
                raise AssertionError("regional check has no overflow rows")
            if geom == "regional" and t_ahead:
                rf = reach_f.cpu().numpy()
                tiles = lambda i: np.flatnonzero(rf[i])
                name = f"cd_pallas._kernel_resume {tag}"
                err, ms, _, t_bytes, t_ops = measure(name, dict(
                    kern=k2_run,
                    plain=lambda: cd_pallas.full_grid_resume_plain(
                        x.packed, reach_f, x.pold, p),
                    pairs=active_pairs(x, tiles),
                    keep=keep_pairs(x, tiles, k2[6]),
                    bytes=in_out_bytes(x, True) + x.nb * x.nb,
                    tiles=int(rf.sum())))
                errs["cd_pallas._kernel_resume"] = max(
                    errs["cd_pallas._kernel_resume"], err)
                k2_regional = dict(
                    regional_ms=ms, regional_bound_ms=max(t_bytes, t_ops),
                    **item_extra(name, x, cd_pallas.reach_items(reach_f), p,
                                 pold=x.pold, prefix="regional_"))
            # the resumed pass starts from this pass's merged table
            table = merged[11].transpose(1, 2).reshape(n_tot, 8).contiguous()
    return k2_regional


def pallas_operands(cols, perm, c, reso="mvp", col=None):
    """The pallas kernels' operands of the caller-order columns ``cols``
    in the Morton order ``perm`` (sorted position -> caller slot) in the
    resolver form ``reso`` (with its column ``col``, caller order), and
    the candidate table of capacity ``c["cap"]``: ``(x, cand,
    row_over)``."""
    from bluesky_tpu_torch.ops import cd_pallas
    perm = perm.long()
    x = cd_pallas.prepare(*[a[perm] for a in cols], c["rpz"],
                          c["tlook"], block=256,
                          **reso_kw(reso, None if col is None else col[perm],
                                    False))
    cand, row_over = cd_pallas.build_candidates(
        x.lat, x.lon, x.gs, x.active, x.nb, x.block, c["cap"], c["rpz"],
        c["tlook"])
    return x, cand, row_over


def check_pallas_kernels(dev, errs):
    """Phase 3, pallas backend: the full grid (``_kernel``) on the three
    geometries and the eight clusters, in Morton order, also with at most
    ``SPLIT`` work items per row; the candidate
    kernel (``_kernel_cand``) on the clusters at a capacity most rows fit
    (4096) and one most rows overflow (2048); and everywhere
    ``detect_resolve_pallas`` with candidates held against the one
    without (flags, counts and top-K ids equal)."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas, cd_tiled, cr_mvp
    mvp = cr_mvp.MVPConfig(rpz_m=5 * NM * 1.05, hpz_m=1000 * FT * 1.05,
                           tlookahead=300.0)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, mvp)
    for geom, n, caps in (("continental", 16384, (4096,)),
                          ("regional", 8192, (4096,)),
                          ("equator", 8192, (4096,)),
                          ("clusters", 16384, (4096, 2048))):
        cols = cd_args(columns(n, geom, seed=1), dev)
        perm = cd_tiled.spatial_permutation(cols[0], cols[1], cols[8])
        tag = f"{geom} N={n}"
        rd0 = cd_pallas.detect_resolve_pallas(
            *cols, 5 * NM, 1000 * FT, 300.0, mvp, block=256)
        for cap in caps:
            x, cand, row_over = pallas_operands(
                cols, perm, dict(rpz=5 * NM, tlook=300.0, cap=cap))
            if cap == caps[0]:
                check_items(f"_kernel {tag}", x.reach, cd_pallas.ITEMS_PER_ROW)
                e = check_split(
                    f"_kernel {tag}", lambda **kw: cd_pallas.full_grid(
                        x.packed, x.reach, p, **kw),
                    cd_pallas.full_grid_plain(x.packed, x.reach, p))[0]
                errs["cd_pallas._kernel"] = max(errs["cd_pallas._kernel"], e)
                log(f"check _kernel {tag}: {int(x.reach.sum())} tiles, nconf "
                    f"{int(rd0.nconf)}, nlos {int(rd0.nlos)}, max abs err "
                    f"{e:.3g}: match; split {SPLIT}: "
                    f"{split_rows(cd_pallas.reach_items(x.reach, SPLIT))} "
                    f"rows split")
            n_over = int(row_over.sum())
            if geom == "clusters":
                check_items(f"_kernel_cand {tag} cap {cap}",
                            cand[:, ::x.block] < x.nb * x.block,
                            cd_pallas.CAND_ITEMS_PER_ROW)
                e = check_split(
                    f"_kernel_cand {tag} cap {cap}",
                    lambda **kw: cd_pallas.cand_tiles(x.packed, cand, p, **kw),
                    cd_pallas.cand_tiles_plain(x.packed, cand, p))[0]
                errs["cd_pallas._kernel_cand"] = max(
                    errs["cd_pallas._kernel_cand"], e)
                items = cd_pallas.cand_items(cand, x.block, SPLIT)
                log(f"check _kernel_cand {tag} cap {cap}: overflow rows "
                    f"{n_over} of {x.nb}, max abs err {e:.3g}: match; "
                    f"split {SPLIT}: {split_rows(items)} rows split")
                if not (0 < n_over < x.nb
                        and (n_over <= x.nb // 4) == (cap == 4096)):
                    raise AssertionError(
                        f"cap {cap}: {n_over} overflow rows of {x.nb}")
            rd = cd_pallas.detect_resolve_pallas(
                *cols, 5 * NM, 1000 * FT, 300.0, mvp, block=256,
                cand_cap=cap)
            cd_pallas.compare_rows(f"cand_cap={cap} vs 0, {tag}", rd, rd0)
            log(f"check detect_resolve_pallas {tag}: cand_cap={cap} "
                f"({n_over} overflow rows) equals cand_cap=0")


def check_width_kernels(dev, errs, kk, resos=RESOS, scale=1):
    """The kernel forms of ``resos`` at partner width ``kk`` (phase 3:
    the Eby and Swarm forms at K = 8; phase 13 (a): every form at
    K = 16, the MVP forms at K = 1, 3 and 32), each against its plain
    version of the same form as ``check_split`` holds them, with the TAS
    (Eby) or CAS (Swarm) column of ``extra_col``: K1 and K3 on the
    continental check (N=16,384), K2 on the resumed regional clump
    (N=8,192, ``s_cap=2``, the partner table ``kk`` wide from the first
    interval) and K4 on the eight clusters at ``cand_cap=4096`` (no
    Swarm form), fleet sizes divided by ``scale``.  Flags, counts and
    the candidate, keep and merged partner sets equal, sums within
    ``cd_pallas.compare_outputs``'s tolerances."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cd_tiled, cr_mvp
    mvp = cr_mvp.MVPConfig(rpz_m=5 * NM * 1.05, hpz_m=1000 * FT * 1.05,
                           tlookahead=300.0)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, mvp, 5 * NM * 1.05)
    pp = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, mvp)
    n1, n2 = 16384 // scale, 8192 // scale
    for reso in resos:
        k1, k2, k3, k4 = (kname(form_name(k, reso), kk) for k in KERNELS)
        c = columns(n1, "continental", seed=1)
        cols, col = cd_args(c, dev), extra_col(c, reso, dev)
        n_tot = cd_sched.padded_size(n1, 256)
        x = cd_sched.prepare(
            *cols, 5 * NM, 1000 * FT, 300.0,
            torch.full((n_tot, kk), -1, dtype=torch.int32, device=dev),
            block=256, **reso_kw(reso, col))
        e1 = check_split(k1, lambda **kw: cd_sched.sched_tiles(
            x.packed, x.wst, x.wln, x.wmax, x.pold, p, reso=reso, **kw),
            cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax, x.pold,
                                       p, reso))[0]
        perm = cd_tiled.spatial_permutation(cols[0], cols[1], cols[8]).long()
        xp = cd_pallas.prepare(*[a[perm] for a in cols], 5 * NM, 300.0,
                               block=256, **reso_kw(
                                   reso, None if col is None else col[perm],
                                   False))
        e3 = check_split(k3, lambda **kw: cd_pallas.full_grid(
            xp.packed, xp.reach, pp, reso=reso, kk=kk, **kw),
            cd_pallas.full_grid_plain(xp.packed, xp.reach, pp, reso, kk))[0]
        c = columns(n2, "regional", seed=1)
        col = extra_col(c, reso, dev)
        n_tot = cd_sched.padded_size(n2, 256)
        table = torch.full((n_tot, kk), -1, dtype=torch.int32, device=dev)
        perm = None
        for t_ahead in (0.0, 20.0):
            x = cd_sched.prepare(*cd_args(c, dev, t_ahead), 5 * NM,
                                 1000 * FT, 300.0, table, block=256, s_cap=2,
                                 perm=perm, **reso_kw(reso, col))
            perm = x.perm
            reach_f = x.reach & x.overflow[:, None]
            if t_ahead:
                e2 = check_split(k2, lambda **kw: cd_pallas.full_grid_resume(
                    x.packed, reach_f, x.pold, p, reso=reso, **kw),
                    cd_pallas.full_grid_resume_plain(x.packed, reach_f,
                                                     x.pold, p, reso))[0]
            table = cd_sched.run_kernels(x, p)[11].transpose(1, 2) \
                .reshape(n_tot, kk).contiguous()
        wide = int(((table >= 0).sum(1) > 8).sum())
        more = ""
        if reso != "swarm":
            c = columns(n1, "clusters", seed=1)
            cols, col = cd_args(c, dev), extra_col(c, reso, dev)
            perm = cd_tiled.spatial_permutation(cols[0], cols[1],
                                                cols[8]).long()
            xp = cd_pallas.prepare(*[a[perm] for a in cols], 5 * NM, 300.0,
                                   block=256, **reso_kw(
                                       reso, None if col is None
                                       else col[perm], False))
            cand, row_over = cd_pallas.build_candidates(
                xp.lat, xp.lon, xp.gs, xp.active, xp.nb, xp.block, CAND_CAP,
                5 * NM, 300.0)
            e4 = check_split(k4, lambda **kw: cd_pallas.cand_tiles(
                xp.packed, cand, pp, reso=reso, kk=kk, **kw),
                cd_pallas.cand_tiles_plain(xp.packed, cand, pp, reso, kk))[0]
            errs[k4] = max(errs.get(k4, 0.0), e4)
            more = (f", K4 on the clusters at cap {CAND_CAP} ("
                    f"{int(row_over.sum())} overflow rows of {xp.nb}) "
                    f"{e4:.3g}")
        for k, e in ((k1, e1), (k2, e2), (k3, e3)):
            errs[k] = max(errs.get(k, 0.0), e)
        log(f"check K={kk} {reso}: max abs err K1 {e1:.3g}, K3 {e3:.3g} "
            f"(continental N={n1}), K2 {e2:.3g} (regional N={n2} t+20s, "
            f"{int(x.overflow.sum())} overflow rows, {wide} rows with more "
            f"than 8 partners){more}: match")


def dense_clump(n=700, seed=3, radius=0.36):
    """The CD inputs of ``n`` aircraft within ``radius`` deg of 52.6 N
    5.4 E at 9,500 m +- 300, from a numpy seed: at block 64 hundreds of
    rows conflict with more than 32 others (the drawn-in clump of
    ``tests/test_torch_kwide.py``, denser)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    r = radius * np.sqrt(rng.random(n))
    return dict(lat=52.6 + r * np.cos(ang), lon=5.4 + r * np.sin(ang) / 0.6,
                trk=rng.uniform(0.0, 360.0, n), gs=rng.uniform(130.0, 240.0, n),
                alt=9500.0 + rng.uniform(-300.0, 300.0, n),
                vs=rng.uniform(-2.0, 2.0, n), active=rng.random(n) > 0.05)


def check_dense_kernels(dev, errs, kk, reso="mvp", B=64):
    """Phase 13 (a): every kernel of ``reso`` at partner width ``kk`` on
    ``dense_clump`` (block ``B``), where rows hold more than 32
    partners: K1 and K2 (K2 on every row's reachable blocks, so every old
    partner is tested) on the second interval with the first interval's
    ``kk``-wide table, K3 in Morton order and K4 at a capacity of four
    blocks, each against its plain version as ``check_split`` holds
    them.  Fails unless some merged row holds more than 32 partners
    when ``kk`` > 32."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cd_tiled, cr_mvp
    mvp = cr_mvp.MVPConfig(rpz_m=5 * NM * 1.05, hpz_m=1000 * FT * 1.05,
                           tlookahead=300.0)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, mvp, 5 * NM * 1.05)
    pp = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, mvp)
    c = dense_clump()
    col = extra_col(c, reso, dev)
    n = len(c["lat"])
    n_tot = cd_sched.padded_size(n, B)
    table = torch.full((n_tot, kk), -1, dtype=torch.int32, device=dev)
    x = None
    for t_ahead in (0.0, 20.0):
        x = cd_sched.prepare(*cd_args(c, dev, t_ahead), 5 * NM, 1000 * FT,
                             300.0, table, block=B, s_cap=2,
                             perm=None if x is None else x.perm,
                             **reso_kw(reso, col))
        if not t_ahead:
            table = cd_sched.run_kernels(x, p)[11].transpose(1, 2) \
                .reshape(n_tot, kk).contiguous()
    name = lambda k: f"{kname(form_name(k, reso), kk)} dense clump"
    e1 = check_split(name("cd_sched._sched_kernel"), lambda **kw:
                     cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax,
                                          x.pold, p, reso=reso, **kw),
                     cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln,
                                                x.wmax, x.pold, p, reso))[0]
    e2, o2 = check_split(name("cd_pallas._kernel_resume"), lambda **kw:
                         cd_pallas.full_grid_resume(x.packed, x.reach,
                                                    x.pold, p, reso=reso,
                                                    **kw),
                         cd_pallas.full_grid_resume_plain(
                             x.packed, x.reach, x.pold, p, reso))
    wide = int(((o2[11] >= 0).sum(1) > 32).sum())
    cols = cd_args(c, dev)
    perm = cd_tiled.spatial_permutation(cols[0], cols[1], cols[8]).long()
    xp = cd_pallas.prepare(*[a[perm] for a in cols], 5 * NM, 300.0, block=B,
                           **reso_kw(reso, None if col is None else col[perm],
                                     False))
    e3 = check_split(name("cd_pallas._kernel"), lambda **kw:
                     cd_pallas.full_grid(xp.packed, xp.reach, pp, reso=reso,
                                         kk=kk, **kw),
                     cd_pallas.full_grid_plain(xp.packed, xp.reach, pp, reso,
                                               kk))[0]
    e4 = 0.0
    if reso != "swarm":
        cand, _ = cd_pallas.build_candidates(
            xp.lat, xp.lon, xp.gs, xp.active, xp.nb, xp.block, 4 * B,
            5 * NM, 300.0)
        e4 = check_split(name("cd_pallas._kernel_cand"), lambda **kw:
                         cd_pallas.cand_tiles(xp.packed, cand, pp, reso=reso,
                                              kk=kk, **kw),
                         cd_pallas.cand_tiles_plain(xp.packed, cand, pp, reso,
                                                    kk))[0]
    for k, e in zip(KERNELS, (e1, e2, e3, e4)):
        errs[kname(form_name(k, reso), kk)] = max(
            errs.get(kname(form_name(k, reso), kk), 0.0), e)
    log(f"check K={kk} {reso} dense clump (N={n}, B={B}): max abs err K1 "
        f"{e1:.3g}, K2 {e2:.3g}, K3 {e3:.3g}, K4 {e4:.3g}; rows with more "
        f"than 32 merged partners {wide}, old partners "
        f"{int((x.pold >= 0).sum())}, kept {int(o2[10].sum())}: match")
    if kk > 32 and not wide:
        raise AssertionError(f"dense clump K={kk}: no row past 32 partners")


def split_rows(items):
    """Rows of a ``WorkItems`` cut into more than one item."""
    return int(((items.length > 0).sum(1) > 1).sum())


def in_out_bytes(x, resume, kk=8):
    """Bytes a pass must move at least: the slabs (and the partner table)
    read once, the outputs (with the Swarm sums in that form; the top-K,
    keep and merged tables ``kk`` wide) written once (every row block of
    a stack of worlds)."""
    nb, B = x.packed.shape[0], x.block
    nacc = 8 + (7 if x.reso == "swarm" else 0)
    if resume:
        kk = x.pold.shape[1]
        return ((x.packed.numel() + x.pold.numel()) * 4
                + ((nacc + 1) * nb * B + 4 * nb * kk * B) * 4)
    return x.packed.numel() * 4 + (nacc * nb * B + 2 * nb * kk * B) * 4


def segment_tiles(x):
    """Row i's segment blocks of the sparse operands ``x`` (the tiles of
    K1), as a function of i; for a stack of worlds the blocks of row i's
    world, as global block ids."""
    st = x.wst.cpu().numpy()
    ln = np.minimum(x.wln.cpu().numpy(), x.wmax)

    def tiles(i):
        t = np.concatenate([np.arange(b, b + k) for b, k in zip(st[i], ln[i])]
                           + [np.zeros(0, np.int64)])
        return t[t < x.nb] + i // x.nb * x.nb
    return tiles


def reach_tiles(x, reach):
    """Row i's blocks of a reach mask of the operands ``x`` ([rows, nb]),
    as global block ids (a stack of worlds: those of row i's world)."""
    rh = reach.cpu().numpy()
    return lambda i: np.flatnonzero(rh[i]) + i // x.nb * x.nb


def form_work(reso, outs, nfix):
    """``measure``'s keys of a resolver form from a launch's outputs: the
    conflict pairs of the Eby form, the neighbour pairs of the Swarm form
    (its w sum, output ``nfix``)."""
    if reso == "eby":
        return dict(eby=int(outs[6].double().sum()))
    if reso == "swarm":
        return dict(swarm=True, neighbours=int(outs[nfix].double().sum()))
    return {}


def keep_pairs(x, tiles_of_row, ncnt):
    """Pairs the keep predicate runs on: the conflict pairs of the visited
    tiles (``ncnt``, the pass's conflict counts) and the active
    old-partner pairs of ``x.pold`` whose partner lies in a visited tile
    (a pair that is both counts twice, so this errs high)."""
    from bluesky_tpu_torch.ops.cd_pallas import _IDX
    B = x.block
    act = (x.packed[:, _IDX["active"], :] > 0.5).cpu().numpy()
    flat = act.reshape(-1)
    pold = x.pold.cpu().numpy()
    lane = np.arange(B)
    total = int(ncnt.double().sum())
    for i in range(x.packed.shape[0]):
        q = pold[i]
        ok = ((q >= 0) & act[i][None, :] & (q != i * B + lane)
              & np.isin(q // B, tiles_of_row(i)))
        total += int((ok & flat[np.clip(q, 0, flat.size - 1)]).sum())
    return total


def active_pairs(x, tiles_of_row):
    """Active ownship-intruder pairs over the visited tiles (self pairs
    excluded): the work the tile body does on this run's data."""
    from bluesky_tpu_torch.ops.cd_pallas import _IDX
    act = (x.packed[:, _IDX["active"], :] > 0.5).sum(1).cpu().numpy() \
        .astype(np.int64)
    total = 0
    for i in range(x.packed.shape[0]):
        js = tiles_of_row(i)
        total += int(act[i] * act[js].sum() - act[i] * (js == i).sum())
    return total


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main_scene(dev, n_ac=100_000, nmax=100_352, seed=0, cd_backend="sparse",
               cd_block=256, reso_method="MVP", k_partners=8):
    """The main path's scene and configuration: ``n_ac`` aircraft of the
    continental geometry of ``__graft_entry__._build_state`` in ``nmax``
    slots, built with the port's ``Traffic(pair_matrix=False,
    k_partners=k_partners).create/flush`` on ``dev`` (no [N, N]
    ``resopairs``: 10 GB at this size), under ``SimConfig(cd_backend=
    cd_backend, cd_block=cd_block)`` with the resolver ``reso_method``.
    Returns ``(state, cfg)``."""
    from bluesky_tpu_torch.core import asas, step as stepmod
    from bluesky_tpu_torch.core.traffic import Traffic
    rng = np.random.default_rng(seed)
    traf = Traffic(nmax=nmax, pair_matrix=False, k_partners=k_partners,
                   device=dev)
    lat = rng.uniform(35.0, 60.0, n_ac)
    lon = rng.uniform(-10.0, 30.0, n_ac)
    hdg = rng.uniform(0.0, 360.0, n_ac)
    alt = rng.uniform(3000.0, 11000.0, n_ac)
    spd = rng.uniform(130.0, 240.0, n_ac)
    traf.create(n_ac, "B744", alt, spd, None, lat, lon, hdg)
    traf.flush()
    return traf.state, stepmod.SimConfig(
        cd_backend=cd_backend, cd_block=cd_block,
        asas=asas.AsasConfig(reso_method=reso_method))


def regional_scene(dev, n_ac=10_000, nmax=10_240, seed=0, cd_backend="dense",
                   cd_block=512, reso_method="MVP", dtype=None,
                   pair_matrix=True, k_partners=8):
    """The dense path's scene: ``n_ac`` aircraft in the 230 nm regional
    circle of ``columns`` (the JAX ``cd_tiled.py`` docstring calls 10,000
    there ~3x the density of the busiest real airspace) in ``nmax``
    slots, built with ``Traffic(pair_matrix=pair_matrix, k_partners=
    k_partners)`` on ``dev`` (float32, or ``dtype``), under
    ``SimConfig(cd_backend=cd_backend, cd_block=cd_block)`` with the
    resolver ``reso_method``.  Returns ``(state, cfg)``."""
    import torch
    from bluesky_tpu_torch.core import asas, step as stepmod
    from bluesky_tpu_torch.core.traffic import Traffic
    c = columns(n_ac, "regional", seed)
    traf = Traffic(nmax=nmax, pair_matrix=pair_matrix, device=dev,
                   dtype=dtype or torch.float32, k_partners=k_partners)
    traf.create(n_ac, "B744", c["alt"], c["gs"], None, c["lat"], c["lon"],
                c["trk"])
    traf.flush()
    return traf.state, stepmod.SimConfig(
        cd_backend=cd_backend, cd_block=cd_block,
        asas=asas.AsasConfig(reso_method=reso_method))


def reset_launches():
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched
    for k in (cd_sched.LAUNCHES, cd_pallas.LAUNCHES):
        for name in k:
            k[name] = 0


#: the wrapper of each kernel, whose ``LAUNCHES`` key it counts under
WRAPPERS = {"cd_sched._sched_kernel": "cd_sched_tiles",
            "cd_pallas._kernel_resume": "cd_full_grid_resume",
            "cd_pallas._kernel": "cd_full_grid",
            "cd_pallas._kernel_cand": "cd_cand_tiles"}


def launch_keys():
    """``{LAUNCHES key: form_name}`` of every form of ``FORMS``."""
    from bluesky_tpu_torch.ops import cd_pallas
    return {cd_pallas.launch_key(WRAPPERS[k], r): form_name(k, r)
            for k, r in FORMS}


def launch_counts():
    """The launch count of each kernel form, by ``form_name``."""
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched
    counts = dict(cd_pallas.LAUNCHES, **cd_sched.LAUNCHES)
    return {name: counts[key] for key, name in launch_keys().items()}


def drive(dev, backend, n_ac, nmax, scene=main_scene, **kw):
    """Build ``scene`` (``main_scene``; ``kw`` to it) for ``backend`` and
    run the sort refresh (none for dense) plus 20 steps, three times, with
    every launch count set to 0 just before: the first two chunks capture
    the step's graphs (all steps before simt 1.01 s are FMS-due), the
    third only replays them.  Returns ``(state, cfg, chunk seconds)``."""
    import torch
    from bluesky_tpu_torch.core import asas, graph, step as stepmod
    graph.clear()
    t0 = time.perf_counter()
    state, cfg = scene(dev, n_ac, nmax, cd_backend=backend, **kw)
    torch.cuda.synchronize()
    log(f"{backend} {cfg.asas.reso_method}: {n_ac} aircraft in {nmax} slots "
        f"built in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    chunk_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        if backend != "dense":
            state = asas.refresh_spatial_sort(
                state, cfg.asas, block=cfg.cd_block,
                impl=asas.impl_for_backend(backend))
        state = stepmod.run_steps(state, cfg, 20)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    return state, cfg, chunk_s


def wide_rows(state, more=8):
    """Rows of the state's partner tables (the caller-space ``partners``
    and the sparse backend's sorted-space ``partners_s``, the fuller of
    the two) that hold more than ``more`` partners."""
    a = state.asas
    return max(int(((t >= 0).sum(-1) > more).sum())
               for t in (a.partners, a.partners_s))


def check_run(backend, state, cfg, launches, chunk_s, n_ac):
    """Fail unless the run stayed finite, found conflicts and launched
    each of its kernels; log its end-to-end numbers (and past K = 8 the
    rows with more than 8 partners).  ``backend`` names the run in the
    log and the failures."""
    import torch
    from bluesky_tpu_torch.core import step as stepmod
    peak = torch.cuda.max_memory_allocated()
    intervals = float(state.asas_tnext) / cfg.asas.dtasas
    if not bool(stepmod.state_finite(state)):
        raise AssertionError(f"{backend} path: non-finite state")
    nconf = int(state.asas.nconf_cur)
    if nconf <= 0:
        raise AssertionError(f"{backend} path: no conflicts detected")
    for name, cnt in launches.items():
        if cnt < 1:
            raise AssertionError(f"{backend} path never launched {name}")
    log(f"{backend}: chunk seconds {chunk_s}, aircraft-steps/s of the "
        f"third chunk {n_ac * 20 / chunk_s[-1]:.4g}, ASAS intervals "
        f"{intervals:g}, nconf {nconf}, nlos {int(state.asas.nlos_cur)}, "
        f"launches {launches}, peak memory {peak / 2**30:.3f} GiB")
    kk = state.asas.partners.shape[-1]
    if kk != 8:
        log(f"{backend}: partner tables {kk} wide, rows with more than 8 "
            f"partners {wide_rows(state)}"
            + (f", more than 32 {wide_rows(state, 32)}" if kk > 32 else ""))


def time_layers(backend, layers):
    """Wall ms of each layer of a chunk, three times, on its own."""
    import torch
    for what, fn in layers.items():
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"{backend}: ms per {what} {ms}")


def measure(name, r):
    """Check ``r["kern"]`` against ``r["plain"]`` once more
    (``check_split``), time both and compute the bound.  ``r`` gives
    ``kern`` (taking the wrapper's ``per_row``), ``plain``, the active
    ``pairs`` (``PAIR_FLOPS`` each), the ``keep`` pairs (``KEEP_FLOPS``
    each more; 0 when absent), the ``bytes`` it must move and its
    ``tiles``; for the Eby form the conflict pairs ``eby`` (the Eby
    body's float32 and float64 counts each), for the Swarm form
    ``swarm=True`` (``SWARM_PAIR_FLOPS`` on every pair) and the
    ``neighbours`` (``SWARM_NEIGHBOUR_FLOPS`` each); ``time``, when
    given, is what is timed instead of ``kern`` (a sampled hold's whole
    launch, ``sampled_run``).  Logs one line;
    returns the largest float difference, ms per launch, plain ms, bytes
    ms and operations ms."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = r["plain"]()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = check_split(f"{name} main path", r["kern"], want)[0]
    ms = cuda_ms(r.get("time", r["kern"]), 5)
    t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
    ops = (r["pairs"] * PAIR_FLOPS + r.get("keep", 0) * KEEP_FLOPS
           + r.get("eby", 0) * EBY_F32_FLOPS
           + (r["pairs"] * SWARM_PAIR_FLOPS
              + r.get("neighbours", 0) * SWARM_NEIGHBOUR_FLOPS
              if r.get("swarm") else 0))
    ops64 = r.get("eby", 0) * EBY_F64_FLOPS
    t_ops = (ops / PEAK_F32_FLOPS + ops64 / PEAK_F64_FLOPS) * 1e3
    log(f"{name}: {ms:.4g} ms per launch, plain {plain_ms:.4g} ms, "
        f"{r['tiles']} tiles, {r['pairs']} active pairs, "
        f"{r.get('keep', 0)} keep pairs, {r.get('eby', 0)} Eby pairs, "
        f"{r.get('neighbours', 0)} swarm neighbour pairs, bound "
        f"{max(t_bytes, t_ops):.4g} ms ({t_bytes:.3g} ms bytes, "
        f"{t_ops:.3g} ms operations)")
    return err, ms, plain_ms, t_bytes, t_ops


def report_kernels(runs, launches, errs, regs):
    """``measure`` each kernel form of ``runs`` (keyed by ``form_name``);
    returns the kernels JSON entries, with each run's ``extra`` keys, its
    resolver form and its walker's registers and spilled bytes (``regs``,
    from ``kernel_registers``)."""
    report = []
    for name, r in runs.items():
        err, ms, plain_ms, t_bytes, t_ops = measure(name, r)
        errs[name] = max(errs.get(name, 0.0), err)
        log(f"{name}: {launches[name]} launches")
        kernel, _, reso = name.partition("/")
        reso = r.get("reso", reso)
        kk = r.get("kk", 8)
        walker = r.get("walker", form_name(kernel, reso or "mvp")
                       + walker_width(kk))
        nreg, st, ld = regs.get(walker, (None, None, None))
        report.append(dict(
            name=name, route="cuda", source=KERNELS[kernel]["source"],
            replaces=KERNELS[kernel]["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, resolver=reso or "mvp", partners=kk,
            registers=nreg,
            spill_store_bytes=st, spill_load_bytes=ld,
            **r.get("extra", {})))
    return report


def item_extra(name, x, items, p, pold=None, cand=None, prefix="",
               reso="mvp", kk=8):
    """The JSON keys of a split walker on ``items`` of the operands ``x``
    (``cd_pallas.walk_items`` arguments ``pold``, ``cand``, ``reso``,
    ``kk``): its non-empty work items, its longest item in
    tiles and the ms of its row merge alone, each key prefixed with
    ``prefix``.  Logs them."""
    from bluesky_tpu_torch.ops import cd_pallas
    parts = cd_pallas.walk_items(x.packed, items, p, pold, cand, reso, kk)
    extra = dict(items=int((items.length > 0).sum()),
                 max_tiles_per_item=int(items.length.max()),
                 merge_ms=cuda_ms(lambda: cd_pallas.merge_items(
                     parts, items, x.block, pold, reso), 5))
    log(f"{name}: {extra['items']} work items, longest "
        f"{extra['max_tiles_per_item']} tiles, merge {extra['merge_ms']:.4g}"
        f" ms per launch")
    return {prefix + k: v for k, v in extra.items()}


def sparse_path(dev, errs, regs, k2_regional, n_ac=100_000, nmax=100_352,
                kk=8, more=()):
    """Phase 4: the port's sparse step at 100k aircraft.  ``k2_regional``
    (``check_kernels``) joins K2's JSON entry.  Phase 13 (b) runs it with
    partner tables ``kk`` wide (the entries named by ``kname``), the ASAS
    interval the only layer timed, and times K1 and K2 at each width of
    ``more`` as well, on the same operands with the partner table cut or
    widened by empty slots (off the path: 0 launches); there the holds
    run on sampled row blocks (``sampled_holds``)."""
    from bluesky_tpu_torch.core import asas, step as stepmod
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp

    tag = "sparse" if kk == 8 else f"sparse K={kk}"
    state, cfg, chunk_s = drive(dev, "sparse", n_ac, nmax, k_partners=kk)
    names = ("cd_sched._sched_kernel", "cd_pallas._kernel_resume")
    launches = {kname(k, kk): v for k, v in launch_counts().items()
                if k in names}
    check_run(tag, state, cfg, launches, chunk_s, n_ac)

    # The layers of a chunk on the stepped state, each timed on its own:
    # one ASAS interval, one sort refresh, one step without the CD.
    no_cd = cfg._replace(asas=cfg.asas._replace(swasas=False))
    layers = {"ASAS interval": lambda: asas.update_tiled(
        state, cfg.asas, block=256, impl="sparse")}
    if kk == 8:
        layers.update({
            "sort refresh": lambda: asas.refresh_spatial_sort(
                state, cfg.asas, block=256, impl="sparse"),
            "step without CD": lambda: stepmod.step(state, no_cd)})
    time_layers(tag, layers)

    # Each kernel, its plain version and its bound at the path's shapes:
    # the operands of the next interval of the stepped state.
    ac, a = state.ac, state.asas
    c = cfg.asas
    x = cd_sched.prepare(ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                         ac.gseast, ac.gsnorth, ac.active, a.noreso, c.rpz,
                         c.hpz, c.dtlookahead,
                         a.partners_s[:cd_sched.padded_size(nmax, 256)],
                         block=256, perm=a.sort_perm)
    mvp = cr_mvp.MVPConfig(rpz_m=c.rpz_m, hpz_m=c.hpz_m,
                           tlookahead=c.dtlookahead)
    p = cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp,
                              c.rpz * c.resofach)
    reach_f = x.reach & x.overflow[:, None]
    ln = np.minimum(x.wln.cpu().numpy(), x.wmax)
    rf = reach_f.cpu().numpy()
    sched_tiles_of = segment_tiles(x)
    nb = x.nb
    k1 = cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold, p)
    k2 = cd_pallas.full_grid_resume(x.packed, reach_f, x.pold, p)
    runs = {
        kname("cd_sched._sched_kernel", kk): dict(
            kern=lambda **kw: cd_sched.sched_tiles(
                x.packed, x.wst, x.wln, x.wmax, x.pold, p, **kw),
            plain=lambda rows=None: cd_sched.sched_tiles_plain(
                x.packed, x.wst, x.wln, x.wmax, x.pold, p, rows=rows),
            pairs=active_pairs(x, sched_tiles_of),
            keep=keep_pairs(x, sched_tiles_of, k1[6]),
            bytes=in_out_bytes(x, True) + 2 * x.wst.numel() * 4,
            tiles=int(ln.sum()), kk=kk, reso="mvp",
            extra=item_extra(kname("cd_sched._sched_kernel", kk), x,
                             cd_sched.window_items(x.wst, x.wln, x.wmax, nb),
                             p, pold=x.pold)),
        kname("cd_pallas._kernel_resume", kk): dict(
            kern=lambda **kw: cd_pallas.full_grid_resume(
                x.packed, reach_f, x.pold, p, **kw),
            plain=lambda rows=None: cd_pallas.full_grid_resume_plain(
                x.packed, reach_f, x.pold, p, rows=rows),
            pairs=active_pairs(x, lambda i: np.flatnonzero(rf[i])),
            keep=keep_pairs(x, lambda i: np.flatnonzero(rf[i]), k2[6]),
            bytes=in_out_bytes(x, True) + nb * nb, tiles=int(rf.sum()),
            kk=kk, reso="mvp",
            extra=dict(item_extra(kname("cd_pallas._kernel_resume", kk), x,
                                  cd_pallas.reach_items(reach_f), p,
                                  pold=x.pold), **k2_regional)),
    }
    for q in more:
        xq = x._replace(pold=(x.pold[:, :q] if q <= kk
                              else wider(x.pold, q)).contiguous())
        q1 = cd_sched.sched_tiles(xq.packed, xq.wst, xq.wln, xq.wmax,
                                  xq.pold, p)
        q2 = cd_pallas.full_grid_resume(xq.packed, reach_f, xq.pold, p)
        n1, n2 = (kname(k, q) for k in names)
        launches.update({n1: 0, n2: 0})
        runs[n1] = dict(
            kern=lambda xq=xq, **kw: cd_sched.sched_tiles(
                xq.packed, xq.wst, xq.wln, xq.wmax, xq.pold, p, **kw),
            plain=lambda xq=xq, rows=None: cd_sched.sched_tiles_plain(
                xq.packed, xq.wst, xq.wln, xq.wmax, xq.pold, p, rows=rows),
            pairs=runs[kname(names[0], kk)]["pairs"],
            keep=keep_pairs(xq, sched_tiles_of, q1[6]),
            bytes=in_out_bytes(xq, True) + 2 * x.wst.numel() * 4,
            tiles=int(ln.sum()), kk=q, reso="mvp",
            extra=item_extra(n1, xq, cd_sched.window_items(
                x.wst, x.wln, x.wmax, nb), p, pold=xq.pold))
        runs[n2] = dict(
            kern=lambda xq=xq, **kw: cd_pallas.full_grid_resume(
                xq.packed, reach_f, xq.pold, p, **kw),
            plain=lambda xq=xq, rows=None: cd_pallas.full_grid_resume_plain(
                xq.packed, reach_f, xq.pold, p, rows=rows),
            pairs=runs[kname(names[1], kk)]["pairs"],
            keep=keep_pairs(xq, lambda i: np.flatnonzero(rf[i]), q2[6]),
            bytes=in_out_bytes(xq, True) + nb * nb, tiles=int(rf.sum()),
            kk=q, reso="mvp",
            extra=item_extra(n2, xq, cd_pallas.reach_items(reach_f), p,
                             pold=xq.pold))
    per_row = ln.sum(1)
    log(f"{tag}: overflow rows {int(x.overflow.sum())}, scheduled tiles "
        f"per interval {int(ln.sum())} (per row block: mean "
        f"{per_row.mean():.4g}, median {np.median(per_row):g}, max "
        f"{per_row.max()}), overflow tiles per interval {int(rf.sum())}")
    return report_kernels(runs if kk == 8 else sampled_holds(x, runs),
                          launches, errs, regs)


def cand_pairs(x, cand):
    """Active ownship-candidate pairs of a candidate table (self pairs
    excluded)."""
    import torch
    from bluesky_tpu_torch.ops.cd_pallas import _IDX
    act = x.packed[:, _IDX["active"], :] > 0.5                # [nb, B]
    act_ids = torch.cat([act.reshape(-1), act.new_zeros(1)])
    own = act.sum(1)
    cand_l = cand.long()
    c_act = act_ids[cand_l]                                   # [nb, c_cap]
    rows = torch.arange(x.nb, device=cand.device)[:, None]
    self_blk = (cand_l // x.block) == rows
    pairs = own * c_act.sum(1) - (c_act & self_blk).sum(1)
    return int(pairs.sum())


def pallas_path(dev, errs, regs, n_ac=100_000, nmax=100_352, kk=8,
                more=()):
    """Phase 5: the port's pallas step at 100k aircraft, then one
    candidate-mode pass on the stepped state.  Phase 13 (b) runs it with
    partner tables ``kk`` wide (the entries named by ``kname``), without
    the capacity sweep, and times K3 and K4 at each width of ``more`` as
    well, on the same operands (off the path: 0 launches); there the
    holds run on sampled row blocks (``sampled_holds``)."""
    import torch
    from bluesky_tpu_torch.core import asas
    from bluesky_tpu_torch.ops import cd_pallas, cr_mvp

    tag = "pallas" if kk == 8 else f"pallas K={kk}"
    state, cfg, chunk_s = drive(dev, "pallas", n_ac, nmax, k_partners=kk)
    ac, a = state.ac, state.asas
    c = cfg.asas
    mvp = cr_mvp.MVPConfig(rpz_m=c.rpz_m, hpz_m=c.hpz_m,
                           tlookahead=c.dtlookahead)
    cols = [ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, a.noreso]
    args = (c.rpz, c.hpz, c.dtlookahead, mvp)
    t0 = time.perf_counter()
    rd_c = cd_pallas.detect_resolve_pallas(
        *cols, *args, block=256, k_partners=kk, perm=a.sort_perm,
        cand_cap=CAND_CAP)
    torch.cuda.synchronize()
    cand_call_ms = (time.perf_counter() - t0) * 1e3
    names = ("cd_pallas._kernel", "cd_pallas._kernel_cand")
    launches = {kname(k, kk): v for k, v in launch_counts().items()
                if k in names}
    check_run(tag, state, cfg, launches, chunk_s, n_ac)

    rd_f = cd_pallas.detect_resolve_pallas(*cols, *args, block=256,
                                           k_partners=kk, perm=a.sort_perm)
    cd_pallas.compare_rows(f"{tag} path cand_cap vs 0", rd_c, rd_f)
    x, cand, row_over = pallas_operands(
        cols, a.sort_perm, dict(rpz=c.rpz, tlook=c.dtlookahead, cap=CAND_CAP))
    log(f"{tag}: detect_resolve_pallas(cand_cap={CAND_CAP}) "
        f"{cand_call_ms:.4g} ms, overflow rows {int(row_over.sum())} of "
        f"{x.nb}, equals cand_cap=0 (nconf {int(rd_c.nconf)})")
    # the work items cut these rows; the longest once set K3's time
    per_row = x.reach.sum(1).float()
    log(f"{tag}: reachable tiles per row block: mean "
        f"{float(per_row.mean()):.4g}, median {float(per_row.median()):g}, "
        f"max {int(per_row.max())}")

    layers = {"ASAS interval": lambda: asas.update_tiled(
        state, cfg.asas, block=256, impl="pallas")}
    if kk == 8:
        layers["sort refresh"] = lambda: asas.refresh_spatial_sort(
            state, cfg.asas, block=256, impl="pallas")
    time_layers(tag, layers)
    # The candidate scheduler against the block grid on this state: the
    # detect call at capacities 0 (full grid) to 4 x CAND_CAP.
    for cap in (0, CAND_CAP, 2 * CAND_CAP, 4 * CAND_CAP) if kk == 8 else ():
        over = pallas_operands(cols, a.sort_perm, dict(
            rpz=c.rpz, tlook=c.dtlookahead, cap=cap or CAND_CAP))[2]
        time_layers("pallas", {
            f"detect with cand_cap={cap} ({int(over.sum()) if cap else 0}"
            f" overflow rows)": lambda: cd_pallas.detect_resolve_pallas(
                *cols, *args, block=256, perm=a.sort_perm, cand_cap=cap)})

    p = cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp)
    nb, B = x.nb, x.block
    rh = x.reach.cpu().numpy()

    def cand_run(cand, cap, kk=kk):
        name = kname(f"cd_pallas._kernel_cand at cand_cap={cap}", kk)
        return dict(
            kern=lambda **kw: cd_pallas.cand_tiles(x.packed, cand, p, kk=kk,
                                                   **kw),
            plain=lambda rows=None: cd_pallas.cand_tiles_plain(
                x.packed, cand, p, kk=kk, rows=rows),
            pairs=cand_pairs(x, cand),
            bytes=in_out_bytes(x, False, kk) + cand.numel() * 4,
            tiles=int(((cand < nb * B).sum(1) + B - 1).div(
                B, rounding_mode="floor").sum()), kk=kk, reso="mvp",
            extra=item_extra(name, x, cd_pallas.cand_items(cand, B), p,
                             cand=cand, kk=kk))

    runs = {
        kname("cd_pallas._kernel", kk): dict(
            kern=lambda **kw: cd_pallas.full_grid(x.packed, x.reach, p,
                                                  kk=kk, **kw),
            plain=lambda rows=None: cd_pallas.full_grid_plain(
                x.packed, x.reach, p, kk=kk, rows=rows),
            pairs=active_pairs(x, lambda i: np.flatnonzero(rh[i])),
            bytes=in_out_bytes(x, False, kk) + nb * nb, tiles=int(rh.sum()),
            kk=kk, reso="mvp",
            extra=item_extra(kname("cd_pallas._kernel", kk), x,
                             cd_pallas.reach_items(x.reach), p, kk=kk)),
        kname("cd_pallas._kernel_cand", kk): cand_run(cand, CAND_CAP),
    }
    for q in more:
        n3, n4 = (kname(k, q) for k in names)
        launches.update({n3: 0, n4: 0})
        runs[n3] = dict(
            kern=lambda q=q, **kw: cd_pallas.full_grid(x.packed, x.reach, p,
                                                       kk=q, **kw),
            plain=lambda q=q, rows=None: cd_pallas.full_grid_plain(
                x.packed, x.reach, p, kk=q, rows=rows),
            pairs=runs[kname(names[0], kk)]["pairs"],
            bytes=in_out_bytes(x, False, q) + nb * nb, tiles=int(rh.sum()),
            kk=q, reso="mvp",
            extra=item_extra(n3, x, cd_pallas.reach_items(x.reach), p, kk=q))
        runs[n4] = cand_run(cand, CAND_CAP, q)
    if kk != 8:
        return report_kernels(sampled_holds(x, runs), launches, errs, regs)
    report = report_kernels(runs, launches, errs, regs)
    # At CAND_CAP most rows overflow and leave the candidate kernel after
    # one read; at 4 x CAND_CAP most rows fit, so this line times the
    # kernel's pair work against its bound.
    cap = 4 * CAND_CAP
    _, cand_w, over_w = pallas_operands(cols, a.sort_perm, dict(
        rpz=c.rpz, tlook=c.dtlookahead, cap=cap))
    wide = cand_run(cand_w, cap)
    err, ms, plain_ms, t_bytes, t_ops = measure(
        f"cd_pallas._kernel_cand at cand_cap={cap} ({int(over_w.sum())} "
        f"overflow rows)", wide)
    errs["cd_pallas._kernel_cand"] = max(errs["cd_pallas._kernel_cand"], err)
    report[-1]["max_abs_err"] = errs["cd_pallas._kernel_cand"]
    report[-1].update({f"cap{cap}_ms": ms, f"cap{cap}_plain_ms": plain_ms,
                       f"cap{cap}_bound_ms": max(t_bytes, t_ops)},
                      **{f"cap{cap}_{k}": v for k, v in wide["extra"].items()})
    return report


def resolver_path(dev, errs, regs, backend, method, n_ac=100_000,
                  nmax=100_352, kk=8, scene=main_scene, **scene_kw):
    """Phases 4-5 under ``method`` (EBY, SWARM or SSD): ``main_scene``
    under ``SimConfig(cd_backend=backend, cd_block=256)`` with that
    resolver, the sort refresh and 20 steps, three times (for pallas and EBY
    also one ``detect_resolve_pallas(cand_cap=4096)`` in the Eby form on
    the stepped state), each kernel form's launches counted over exactly
    that run; the chunk rate, one ASAS interval and the peak memory.
    Then, for EBY and SWARM, each kernel of the path in that form timed
    against its plain version and bound at the path's shapes, as phases
    4-5 time the MVP forms; SSD runs the MVP forms, timed there.  One
    more interval runs with every host synchronisation an error.  Phase
    13 (c) runs it on ``scene`` (``scene_kw`` to it) with partner tables
    ``kk`` wide, the entries named by ``kname``."""
    import torch
    from bluesky_tpu_torch.core import asas
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp
    reso = {"EBY": "eby", "SWARM": "swarm"}.get(method, "mvp")
    state, cfg, chunk_s = drive(dev, backend, n_ac, nmax, scene=scene,
                                reso_method=method, k_partners=kk, **scene_kw)
    ac, a = state.ac, state.asas
    c = cfg.asas
    mvp = cr_mvp.MVPConfig(rpz_m=c.rpz_m, hpz_m=c.hpz_m,
                           tlookahead=c.dtlookahead)
    col = {"eby": ac.tas, "swarm": ac.cas}.get(reso)
    cols = [ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, a.noreso]
    kernels = (("cd_sched._sched_kernel", "cd_pallas._kernel_resume")
               if backend == "sparse" else ("cd_pallas._kernel",))
    if backend == "pallas" and reso == "eby":
        kernels += ("cd_pallas._kernel_cand",)
        cd_pallas.detect_resolve_pallas(
            *cols, c.rpz, c.hpz, c.dtlookahead, mvp, block=256,
            k_partners=kk, perm=a.sort_perm, cand_cap=CAND_CAP, reso="eby",
            extra_cols={"tas": ac.tas})
        torch.cuda.synchronize()
    forms = [form_name(k, reso) for k in kernels]
    names = [kname(f, kk) for f in forms]
    launches = {kname(k, kk): v for k, v in launch_counts().items()
                if k in forms}
    tag = f"{backend} {method}" + ("" if kk == 8 else f" K={kk} N={n_ac}")
    check_run(tag, state, cfg, launches, chunk_s, n_ac)
    time_layers(tag, {"ASAS interval": lambda: asas.update_tiled(
        state, c, block=256, impl=backend)})
    # the interval reads nothing back to the host on these backends: any
    # synchronising call raises in this mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        asas.update_tiled(state, c, block=256, impl=backend)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{tag}: one ASAS interval under torch.cuda.set_sync_debug_mode("
        f"'error'): no host synchronisation")
    if reso == "mvp":
        return []
    if backend == "sparse":
        x = cd_sched.prepare(*cols, c.rpz, c.hpz, c.dtlookahead,
                             a.partners_s[:cd_sched.padded_size(nmax, 256)],
                             block=256, perm=a.sort_perm,
                             **reso_kw(reso, col))
        p = cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp,
                                  c.rpz * c.resofach)
        reach_f = x.reach & x.overflow[:, None]
        rf = reach_f.cpu().numpy()
        seg = segment_tiles(x)
        k1 = cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold, p,
                                  reso=reso)
        k2 = cd_pallas.full_grid_resume(x.packed, reach_f, x.pold, p,
                                        reso=reso)
        runs = {
            names[0]: dict(
                kern=lambda **kw: cd_sched.sched_tiles(
                    x.packed, x.wst, x.wln, x.wmax, x.pold, p, reso=reso,
                    **kw),
                plain=lambda: cd_sched.sched_tiles_plain(
                    x.packed, x.wst, x.wln, x.wmax, x.pold, p, reso),
                pairs=active_pairs(x, seg), keep=keep_pairs(x, seg, k1[6]),
                bytes=in_out_bytes(x, True) + 2 * x.wst.numel() * 4,
                tiles=int(sum(len(seg(i)) for i in range(x.nb))), kk=kk,
                reso=reso,
                extra=item_extra(names[0], x, cd_sched.window_items(
                    x.wst, x.wln, x.wmax, x.nb), p, pold=x.pold, reso=reso),
                **form_work(reso, k1, 13)),
            names[1]: dict(
                kern=lambda **kw: cd_pallas.full_grid_resume(
                    x.packed, reach_f, x.pold, p, reso=reso, **kw),
                plain=lambda: cd_pallas.full_grid_resume_plain(
                    x.packed, reach_f, x.pold, p, reso),
                pairs=active_pairs(x, lambda i: np.flatnonzero(rf[i])),
                keep=keep_pairs(x, lambda i: np.flatnonzero(rf[i]), k2[6]),
                bytes=in_out_bytes(x, True) + x.nb * x.nb,
                tiles=int(rf.sum()), kk=kk, reso=reso,
                extra=item_extra(names[1], x, cd_pallas.reach_items(reach_f),
                                 p, pold=x.pold, reso=reso),
                **form_work(reso, k2, 13))}
    else:
        x, cand, _ = pallas_operands(
            cols, a.sort_perm, dict(rpz=c.rpz, tlook=c.dtlookahead,
                                    cap=CAND_CAP), reso, col)
        p = cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp)
        rh = x.reach.cpu().numpy()
        k3 = cd_pallas.full_grid(x.packed, x.reach, p, reso=reso, kk=kk)
        runs = {names[0]: dict(
            kern=lambda **kw: cd_pallas.full_grid(x.packed, x.reach, p,
                                                  reso=reso, kk=kk, **kw),
            plain=lambda: cd_pallas.full_grid_plain(x.packed, x.reach, p,
                                                    reso, kk),
            pairs=active_pairs(x, lambda i: np.flatnonzero(rh[i])),
            bytes=in_out_bytes(x, False, kk) + x.nb * x.nb,
            tiles=int(rh.sum()), kk=kk, reso=reso,
            extra=item_extra(names[0], x, cd_pallas.reach_items(x.reach), p,
                             reso=reso, kk=kk),
            **form_work(reso, k3, 10))}
        if reso == "eby":
            k4 = cd_pallas.cand_tiles(x.packed, cand, p, reso=reso, kk=kk)
            runs[names[1]] = dict(
                kern=lambda **kw: cd_pallas.cand_tiles(x.packed, cand, p,
                                                       reso=reso, kk=kk,
                                                       **kw),
                plain=lambda: cd_pallas.cand_tiles_plain(x.packed, cand, p,
                                                         reso, kk),
                pairs=cand_pairs(x, cand),
                bytes=in_out_bytes(x, False, kk) + cand.numel() * 4,
                tiles=int(((cand < x.nb * x.block).sum(1) + x.block - 1)
                          .div(x.block, rounding_mode="floor").sum()),
                kk=kk, reso=reso,
                extra=item_extra(names[1], x, cd_pallas.cand_items(
                    cand, x.block), p, cand=cand, reso=reso, kk=kk),
                **form_work(reso, k4, 10))
    per_row = x.reach.sum(1).float()
    log(f"{tag}: reachable tiles per row block: mean "
        f"{float(per_row.mean()):.4g}, max {int(per_row.max())}, total "
        f"{int(x.reach.sum())}")
    return report_kernels(runs, launches, errs, regs)


def dense_path(dev, n_ac=10_000, nmax=10_240):
    """Phase 6: the dense step (``SimConfig(cd_backend="dense")``, the
    JAX package's default) on ``regional_scene``: 20 steps, three times, then
    one ASAS interval (``asas.update``) and one step without the CD
    timed on their own.  No kernel runs on this path."""
    from bluesky_tpu_torch.core import asas, step as stepmod
    state, cfg, chunk_s = drive(dev, "dense", n_ac, nmax,
                                scene=regional_scene)
    log(f"dense: kernel launches {launch_counts()} (none expected)")
    check_run("dense", state, cfg, {}, chunk_s, n_ac)
    log(f"dense: engaged pairs in resopairs "
        f"{int(state.asas.resopairs.sum())}")
    no_cd = cfg._replace(asas=cfg.asas._replace(swasas=False))
    log(f"dense: ms per ASAS interval (cuda_ms, 3 runs) "
        f"{cuda_ms(lambda: asas.update(state, cfg.asas), 3):.4g}")
    time_layers("dense", {
        "ASAS interval": lambda: asas.update(state, cfg.asas),
        "step without CD": lambda: stepmod.step(state, no_cd)})


def dense_resolvers(dev, n_ac=10_000, nmax=10_240):
    """Phase 6, the other resolvers: one dense ASAS interval
    (``asas.update``) on ``regional_scene`` with EBY, SWARM and SSD, each
    timed with CUDA events over 3 runs after a warm-up, with the peak
    memory of the interval.  Dense SSD walks the intruder axis in chunks,
    each a few [N, C, chunk] float32 slabs (C candidates)."""
    import torch
    from bluesky_tpu_torch.core import asas
    from bluesky_tpu_torch.ops import cr_ssd
    for method in ("EBY", "SWARM", "SSD"):
        state, cfg = regional_scene(dev, n_ac, nmax, reso_method=method)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, _ = asas.update(state, cfg.asas)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if int(out.asas.nconf_cur) <= 0 or not bool(torch.isfinite(
                out.asas.trk).all() & torch.isfinite(out.asas.tas).all()):
            raise AssertionError(f"dense {method}: no conflicts or "
                                 "non-finite commands")
        ms = cuda_ms(lambda: asas.update(state, cfg.asas), 3)
        slab = ""
        if method == "SSD":
            sc = cr_ssd.SSDConfig()
            ncand = sc.ntrk * sc.nspd + 2
            slab = (f", one [N, C, chunk] slab [{nmax}, {ncand}, "
                    f"{sc.chunk}] float32 = "
                    f"{nmax * ncand * sc.chunk * 4 / 2**30:.3f} GiB")
        log(f"dense {method}: N={n_ac} in {nmax} slots, nconf "
            f"{int(out.asas.nconf_cur)}, ms per ASAS interval (cuda_ms, 3 "
            f"runs) {ms:.4g}, peak memory {peak / 2**30:.3f} GiB "
            f"({(peak - base) / 2**30:.3f} GiB above the state){slab}")
        del state, out


def tiled_path(dev, n_ac=100_000, nmax=100_352):
    """Phase 7: the tiled step (``SimConfig(cd_backend="tiled",
    cd_block=512)``) on ``main_scene``: the Morton refresh and 20 steps,
    three times; then one ASAS interval (``update_tiled(impl="lax")``) and one
    refresh timed on their own, with the reachable tiles and the eager
    row iterations of an interval (at most nb).  No kernel runs on this
    path."""
    from bluesky_tpu_torch.core import asas
    from bluesky_tpu_torch.ops import cd_tiled
    state, cfg, chunk_s = drive(dev, "tiled", n_ac, nmax, cd_block=512)
    log(f"tiled: kernel launches {launch_counts()} (none expected)")
    check_run("tiled", state, cfg, {}, chunk_s, n_ac)
    last = dict(cd_tiled.LAST_CALL)
    if not 0 < last["iterations"] <= last["nb"]:
        raise AssertionError(f"tiled path: {last['iterations']} eager "
                             f"iterations for nb={last['nb']}")
    log(f"tiled: per interval {last['tiles']} reachable tiles of "
        f"{last['nb'] ** 2} ({last['tiles'] / last['nb']:.4g} per row "
        f"block), {last['iterations']} eager row iterations, nb "
        f"{last['nb']}")
    log(f"tiled: ms per ASAS interval (cuda_ms, 3 runs) "
        f"{cuda_ms(lambda: asas.update_tiled(state, cfg.asas, block=512, impl='lax'), 3):.4g}")
    time_layers("tiled", {
        "ASAS interval": lambda: asas.update_tiled(state, cfg.asas,
                                                   block=512, impl="lax"),
        "sort refresh": lambda: asas.refresh_spatial_sort(
            state, cfg.asas, block=512, impl="lax")})


def check_dense_tiled(dev, n=2048):
    """Phase 8: the dense and tiled CD&R against each other on the card,
    in float64, at ``n`` aircraft of the regional geometry (block 256,
    eight row blocks): ``inconf``, ``nconf`` and ``nlos`` equal,
    ``tcpamax`` and the three MVP sums within rtol 1e-6 / atol 1e-4 (the
    tolerances of tests/test_cd_tiled.py).  Then the same dense call on
    the card and on the CPU: flags equal, floats within 1e-9 relative
    (each pair matrix relative to its value plus the scale of the terms
    it cancels; the MVP sums and commands with a 1e-9 absolute floor for
    values near zero)."""
    import torch
    from bluesky_tpu_torch.ops import cd, cd_tiled, cr_mvp
    c = columns(n, "regional", seed=2)
    trk = np.radians(c["trk"])
    c.update(gse=c["gs"] * np.sin(trk), gsn=c["gs"] * np.cos(trk),
             noreso=np.arange(n) % 97 == 0)
    rpz, hpz, tlook = 5 * NM, 1000 * FT, 300.0
    mvp = cr_mvp.MVPConfig(rpz_m=rpz * 1.05, hpz_m=hpz * 1.05,
                           tlookahead=tlook)

    def cols(d):
        t = lambda k: torch.as_tensor(c[k], device=d)
        return [t(k).double() for k in ("lat", "lon", "trk", "gs", "alt",
                                         "vs", "gse", "gsn")] \
            + [t("active"), t("noreso")]

    def dense(d):
        lat, lon, trk_, gs, alt, vs, gse, gsn, act, nor = cols(d)
        out = cd.detect(lat, lon, trk_, gs, alt, vs, act, rpz, hpz, tlook)
        parts = cr_mvp.pair_contributions(out, alt, gse, gsn, vs, mvp)
        m = (out.swconfl & ~nor[None, :]).double()
        sums = [(p * m).sum(1) for p in parts[:3]]
        cmds = cr_mvp.resolve(out, alt, gse, gsn, vs, trk_, gs, alt,
                              torch.zeros_like(vs), alt, 51.4, 92.6, -15.24,
                              15.24, mvp, noreso=nor)
        return out, sums, cmds

    out, sums, cmds = dense(dev)
    rd = cd_tiled.detect_resolve_tiled(*cols(dev), rpz, hpz, tlook, mvp,
                                       block=256)
    h = lambda a: a.detach().cpu().numpy()
    nconf, nlos = int(out.swconfl.sum()), int(out.swlos.sum())
    if not (np.array_equal(h(out.inconf), h(rd.inconf))
            and nconf == int(rd.nconf) > 0 and nlos == int(rd.nlos)):
        raise AssertionError(
            f"dense vs tiled on the card: nconf {nconf} / {int(rd.nconf)}, "
            f"nlos {nlos} / {int(rd.nlos)}, inconf differs in "
            f"{int((h(out.inconf) != h(rd.inconf)).sum())} rows")
    worst = 0.0
    for name, a, b in (("tcpamax", rd.tcpamax, out.tcpamax),
                       ("sum_dve", rd.sum_dve, sums[0]),
                       ("sum_dvn", rd.sum_dvn, sums[1]),
                       ("sum_dvv", rd.sum_dvv, sums[2])):
        np.testing.assert_allclose(h(a), h(b), rtol=1e-6, atol=1e-4,
                                   err_msg=f"dense vs tiled {name}")
        worst = max(worst, float(np.abs(h(a) - h(b)).max()))
    log(f"check dense vs tiled (float64, N={n}, card): nconf {nconf}, nlos "
        f"{nlos}, {int(out.inconf.sum())} ownships in conflict equal; "
        f"tcpamax and MVP sums within rtol 1e-6 / atol 1e-4 (largest "
        f"difference {worst:.3g})")

    out_c, sums_c, cmds_c = dense("cpu")
    for k in ("swconfl", "swlos", "inconf"):
        if not np.array_equal(h(getattr(out, k)), h(getattr(out_c, k))):
            raise AssertionError(f"dense card vs CPU: {k} differs")
    act = c["active"]
    pm = act[:, None] & act[None, :] & ~np.eye(n, dtype=bool)
    # each matrix relative to its value plus the scale of the terms it
    # cancels: 180 deg for the bearing, dist / vrel for the times (|tcpa|
    # <= dist / vrel), dist^2 for dcpa2
    dist = h(out_c.dist)[pm]
    u, v = c["gse"], c["gsn"]
    vrel = np.sqrt(np.maximum((u[None, :] - u[:, None]) ** 2
                              + (v[None, :] - v[:, None]) ** 2, 1e-6))[pm]
    scale = dict(qdr=180.0, dist=0.0, tcpa=dist / vrel, tinconf=dist / vrel,
                 toutconf=dist / vrel, dcpa2=dist ** 2)
    worst = 0.0
    for k, s in scale.items():
        g, w = h(getattr(out, k))[pm], h(getattr(out_c, k))[pm]
        rel = float((np.abs(g - w) / (np.abs(w) + s)).max())
        worst = max(worst, rel)
        if rel > 1e-9:
            raise AssertionError(f"dense card vs CPU: {k} differs by {rel:.3g}"
                                 " relative")
    for name, a, b in zip(("tcpamax", "sum_dve", "sum_dvn", "sum_dvv",
                           "trk", "gs", "vs", "alt", "asase", "asasn"),
                          [out.tcpamax] + sums + list(cmds),
                          [out_c.tcpamax] + sums_c + list(cmds_c)):
        np.testing.assert_allclose(h(a), h(b), rtol=1e-9, atol=1e-9,
                                   err_msg=f"dense card vs CPU {name}")
    log(f"check dense card vs CPU (float64, N={n}): flags equal, pair "
        f"matrices within {worst:.3g} relative to their scale, tcpamax, MVP "
        f"sums and commands within rtol 1e-9 / atol 1e-9")


def check_dense_tiled_resolvers(dev, n=2048):
    """Phase 8, the other resolvers, in float64 at ``n`` aircraft of the
    regional geometry (``regional_scene``, block 256): EBY and SWARM,
    ``asas.update`` (dense) against ``asas.update_tiled(impl="lax")``:
    the flags, counts and ASAS-engaged flags equal, the commands within
    rtol 1e-6 / atol 1e-6 (tracks as angles).  SSD: dense SSD draws the
    obstacle of every intruder within ADS-B range and the tiled one those
    of its partner table, so each is held against the same call on the
    CPU instead (flags equal, commands within 1e-9)."""
    import torch
    from bluesky_tpu_torch.core import asas
    from bluesky_tpu_torch.core.state import state_from_numpy, state_to_numpy
    for method in ("EBY", "SWARM", "SSD"):
        state, cfg = regional_scene(dev, n, n, cd_backend="tiled",
                                    reso_method=method, dtype=torch.float64)
        state = asas.refresh_spatial_sort(state, cfg.asas, block=256,
                                          impl="lax")
        dense = state_to_numpy(asas.update(state, cfg.asas)[0])
        tiled = state_to_numpy(asas.update_tiled(state, cfg.asas, block=256,
                                                 impl="lax")[0])
        worst = 0.0
        pairs = [("dense", dense, "tiled", tiled)]
        if method == "SSD":
            cpu = state_from_numpy(state_to_numpy(state), device="cpu")
            pairs = [
                ("dense", dense, "dense on the CPU",
                 state_to_numpy(asas.update(cpu, cfg.asas)[0])),
                ("tiled", tiled, "tiled on the CPU",
                 state_to_numpy(asas.update_tiled(cpu, cfg.asas, block=256,
                                                  impl="lax")[0]))]
        for na, a, nb_, b in pairs:
            tol = 1e-9 if method == "SSD" else 1e-6
            if int(a["asas.nconf_cur"]) <= 0:
                raise AssertionError(f"{method} {na}: no conflicts")
            for k in ("asas.inconf", "asas.active", "asas.nconf_cur",
                      "asas.nlos_cur"):
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"{method}: {k} of {na} and {nb_} "
                                         "differ")
            for k in ("asas.trk", "asas.tas", "asas.vs", "asas.alt"):
                d = np.abs(a[k] - b[k])
                if k == "asas.trk":
                    d = np.minimum(d, 360.0 - d)
                bound = tol + tol * np.abs(b[k])
                if not (d <= bound).all():
                    raise AssertionError(
                        f"{method}: {k} of {na} and {nb_} differ by "
                        f"{float(d.max()):.3g}")
                worst = max(worst, float(d.max()))
            log(f"check {method} {na} vs {nb_} (float64, N={n}): nconf "
                f"{int(a['asas.nconf_cur'])}, flags equal, commands within "
                f"{tol:g} (largest difference {worst:.3g})")


#: steps of a chunk, as every path above drives it
CHUNK = 20
#: host-side CUDA calls that launch work, counted by ``profile_chunk``
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def state_copy(state):
    """A copy of every tensor of ``state`` (the host side shared)."""
    from bluesky_tpu_torch.core import graph
    return graph.rebuild(state, iter([t.clone()
                                      for _, t in graph.leaves(state)]))


def bits_equal(a, b):
    """Bit-equality of two tensors, NaN payloads included."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        w = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(w), b.view(w))
    return torch.equal(a, b)


def assert_same(tag, a, b):
    """Every tensor of ``a`` and ``b`` (states or packs) bit-equal, and the
    host clocks and seed of two states equal."""
    from bluesky_tpu_torch.core import graph
    la, lb = graph.leaves(a), graph.leaves(b)
    bad = [k for (k, x), (_, y) in zip(la, lb) if not bits_equal(x, y)]
    if len(la) != len(lb) or bad:
        raise AssertionError(f"{tag}: graph and eager differ in {bad[:8]}")
    for k in ("simt", "fms_t0", "asas_tnext", "rng"):
        if hasattr(a, k) and getattr(a, k) != getattr(b, k):
            raise AssertionError(f"{tag}: host {k} {getattr(a, k)} != "
                                 f"{getattr(b, k)}")


def eager_chunk(state, cfg, nsteps, checked=False):
    """The eager reference of a chunk: ``step`` in a Python loop, the folds
    of ``fold_carry`` after each step and, for the in-scan refresh,
    ``inscan_sparse_refresh`` before each step where it is due.  Returns
    ``(state, carry, (sort_t, refreshes))``."""
    from bluesky_tpu_torch.core import asas, step as stepmod
    carry = stepmod.init_carry(state, cfg, checked)
    sort_t, count = state.simt.dtype.type(-1.0), 0
    for _ in range(nsteps):
        if stepmod.inscan_refresh_active(cfg) and stepmod.refresh_due(
                state.simt, sort_t, cfg):
            sort_t, count = state.simt, count + 1
            state = asas.inscan_sparse_refresh(state, cfg.asas,
                                               block=min(cfg.cd_block, 256))
        state = stepmod.step(state, cfg)
        carry = stepmod.fold_carry(carry, state, cfg)
    return state, carry, (sort_t, count)


def check_graph_chunk(tag, state, cfg):
    """One chunk of ``state`` through ``step`` in a Python loop and one
    through ``run_steps`` (graph replays), from copies: every state
    tensor bit-equal, the host clocks equal.  Then the same with
    ``checked=True, scanstats=True, fingerprint=True`` (and
    ``inscan_refresh=True`` on sparse) through ``run_steps_edge``, the
    guard word, ScanStats and fingerprint packs and the refresh record
    equal too, and the device ``simt`` of the graph buffers equal to the
    host ``simt``."""
    from bluesky_tpu_torch.core import step as stepmod
    from bluesky_tpu_torch.obs import fingerprint
    want = eager_chunk(state_copy(state), cfg, CHUNK)[0]
    got = stepmod.run_steps(state_copy(state), cfg, CHUNK)
    assert_same(f"{tag} run_steps", got, want)
    on = cfg._replace(scanstats=True, fingerprint=True,
                      inscan_refresh=cfg.cd_backend == "sparse")
    w_state, w_carry, (w_sort_t, w_count) = eager_chunk(
        state_copy(state), on, CHUNK, checked=True)
    out = stepmod.run_steps_edge(state_copy(state), on, CHUNK, checked=True)
    g_state, tel, stats = out[:3]
    assert_same(f"{tag} flags on", g_state, w_state)
    assert_same(f"{tag} ScanStats", stats, w_carry["st"])
    assert_same(f"{tag} fingerprint", out[-1], w_carry["fp"])
    if int(tel.bad) != int(w_carry["bad"]) or int(tel.bad) != -1:
        raise AssertionError(f"{tag}: bad {int(tel.bad)} / "
                             f"{int(w_carry['bad'])}")
    more = ""
    if stepmod.inscan_refresh_active(on):
        rp = out[3]
        if (rp.sort_t, int(rp.count)) != (w_sort_t, w_count) or w_count < 1:
            raise AssertionError(f"{tag}: refresh {rp.sort_t} x "
                                 f"{int(rp.count)} / {w_sort_t} x {w_count}")
        more = f", {w_count} in-scan refresh at simt {float(w_sort_t):g}"
    if tel.simt.item() != float(g_state.simt):
        raise AssertionError(f"{tag}: device simt {tel.simt.item()!r} != "
                             f"host {g_state.simt!r}")
    log(f"check graph {tag}: run_steps and run_steps_edge(checked, "
        f"scanstats, fingerprint{', inscan_refresh' * bool(more)}) equal "
        f"the eager loop bit for bit over {CHUNK} steps (simt "
        f"{float(g_state.simt):g} on host and device, fingerprint "
        f"{fingerprint.combine(out[-1]):08x}, conf_peak "
        f"{int(stats.conf_peak)}{more})")


def check_graph_guard_and_edges(tag, state, cfg):
    """The checked runner with a NaN latitude in the first live row gives
    the eager loop's first bad step (0); chunk k's ``EdgeTelemetry`` is
    unchanged after chunk k+1 ran on k's donated state; and
    ``run_steps_edge_keep`` leaves its input bit for bit."""
    from bluesky_tpu_torch.core import step as stepmod
    bad_state = state_copy(state)
    bad_state.ac.lat[0] = float("nan")
    _, bad = stepmod.run_steps_checked(state_copy(bad_state), cfg, CHUNK)
    _, carry, _ = eager_chunk(bad_state, cfg, CHUNK, checked=True)
    if not int(bad) == int(carry["bad"]) == 0:
        raise AssertionError(f"{tag}: bad {int(bad)} / {int(carry['bad'])}")
    s1, tel1 = stepmod.run_steps_edge(state_copy(state), cfg, CHUNK)
    kept = [t.clone() for t in tel1]
    s2, tel2 = stepmod.run_steps_edge(s1, cfg, CHUNK)
    if not all(bits_equal(a, b) for a, b in zip(tel1, kept)) \
            or not tel2.simt.item() > tel1.simt.item():
        raise AssertionError(f"{tag}: chunk k+1 changed chunk k's telemetry")
    before = state_copy(s2)
    stepmod.run_steps_edge_keep(s2, cfg, CHUNK)
    assert_same(f"{tag} run_steps_edge_keep input", s2, before)
    log(f"check graph {tag}: first bad step 0 on both paths (NaN in row "
        f"0); chunk k's telemetry unchanged by chunk k+1; "
        f"run_steps_edge_keep leaves its input unchanged")


def device_us(evt):
    """Self device time of a profiler row [us] across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profile_chunk(fn):
    """Wall ms of ``fn()`` under ``torch.profiler``, the device ms of its
    kernels (one stream: the busy time), its kernel executions and its
    host launch calls by name (``LAUNCH_CALLS``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    kernels = [e for e in rows if device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    calls = {e.key: e.count for e in rows if e.key in LAUNCH_CALLS}
    return wall, sum(device_us(e) for e in kernels) / 1e3, \
        sum(e.count for e in kernels), calls


def count_syncs(fn):
    """Host synchronisations ``fn()`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen)


def time_graph_chunks(tag, state, cfg, n_ac):
    """Eager against graphed chunks of ``state``, alternating for three
    rounds: a chunk is the sort refresh (none for dense) and ``CHUNK``
    steps, eager through ``step`` in a loop, graphed through
    ``run_steps`` chained on its own output.  Then the step without CD
    the same way, both paths profiled (launches per step, busy share),
    and the host synchronisations inside each runner.  Logs and returns
    the numbers."""
    import torch
    from bluesky_tpu_torch.core import asas, step as stepmod
    impl = asas.impl_for_backend(cfg.cd_backend)

    def chunk(s, graphed, c=cfg):
        if c.cd_backend != "dense" and c.asas.swasas:
            s = asas.refresh_spatial_sort(s, c.asas, block=c.cd_block,
                                          impl=impl)
        if graphed:
            return stepmod.run_steps(s, c, CHUNK)
        for _ in range(CHUNK):
            s = stepmod.step(s, c)
        return s

    no_cd = cfg._replace(asas=cfg.asas._replace(swasas=False))
    res = {}
    for what, c in (("chunk", cfg), ("step without CD", no_cd)):
        runs = {True: state_copy(state), False: state_copy(state)}
        runs[True] = chunk(runs[True], True, c)          # the captures
        ms = {True: [], False: []}
        for r in range(3):
            for graphed in ((False, True) if r % 2 == 0 else (True, False)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[graphed] = chunk(runs[graphed], graphed, c)
                torch.cuda.synchronize()
                ms[graphed].append((time.perf_counter() - t0) * 1e3)
        prof = {g: profile_chunk(lambda: runs.__setitem__(
            g, chunk(runs[g], g, c))) for g in (False, True)}
        res[what] = (ms, prof)
        for g, name in ((False, "eager"), (True, "graph")):
            wall, busy, nk, calls = prof[g]
            per = ", ".join(f"{k} {v / CHUNK:.4g}" for k, v in
                            sorted(calls.items()))
            rate = [f"{n_ac * CHUNK / (m / 1e3):.4g}" for m in ms[g]]
            log(f"graph timing {tag} {what}, {name}: ms per chunk "
                f"{[round(m, 3) for m in ms[g]]}, ms per step "
                f"{[round(m / CHUNK, 4) for m in ms[g]]}, aircraft-steps/s "
                f"{rate}; profiled chunk {wall:.3f} ms wall, {busy:.3f} ms "
                f"kernels ({100 * busy / wall:.1f} % busy), "
                f"{nk / CHUNK:.4g} kernel executions per step, host calls "
                f"per step: {per}")
    def chained(run):
        """Syncs of ``run`` on its own output, after its captures."""
        out = run(state_copy(state))
        return count_syncs(lambda: run(out))

    flags = cfg._replace(scanstats=True, fingerprint=True)
    syncs = {
        "run_steps": chained(lambda s: stepmod.run_steps(s, cfg, CHUNK)),
        "run_steps_checked": chained(
            lambda s: stepmod.run_steps_checked(s, cfg, CHUNK)[0]),
        "run_steps_edge(checked, scanstats, fingerprint)": chained(
            lambda s: stepmod.run_steps_edge(s, flags, CHUNK,
                                             checked=True)[0])}
    if cfg.cd_backend == "sparse":
        inscan = cfg._replace(inscan_refresh=True)
        syncs["run_steps_edge(inscan_refresh)"] = chained(
            lambda s: stepmod.run_steps_edge(s, inscan, CHUNK)[0])
    log(f"graph syncs {tag}: host synchronisations inside one chunk "
        f"(after its captures) {syncs}; the edge read adds one")
    return res, syncs


def graph_phase(dev):
    """Phase 9: the captured chunk against the eager one on 100k
    continental sparse and pallas and 10k regional dense (MVP): the
    checks of ``check_graph_chunk``, on dense also with noise on and the
    guard and edge checks of ``check_graph_guard_and_edges`` (on sparse
    too), then ``time_graph_chunks``."""
    import torch
    from bluesky_tpu_torch.core import asas, graph, step as stepmod
    for backend, scene, n_ac, nmax in (
            ("sparse", main_scene, 100_000, 100_352),
            ("pallas", main_scene, 100_000, 100_352),
            ("dense", regional_scene, 10_000, 10_240)):
        graph.clear()
        t0 = time.perf_counter()
        state, cfg = scene(dev, n_ac, nmax, cd_backend=backend)
        if backend != "dense":
            state = asas.refresh_spatial_sort(
                state, cfg.asas, block=cfg.cd_block,
                impl=asas.impl_for_backend(backend))
        # the chunk starts one step before an ASAS interval, so that the
        # FMS-due, plain and ASAS steps all run in it
        state = stepmod.run_steps(state, cfg, CHUNK - 1)
        check_graph_chunk(backend, state, cfg)
        if backend != "pallas":
            check_graph_guard_and_edges(backend, state, cfg)
        if backend == "dense":
            noisy = cfg._replace(noise=stepmod.NoiseConfig(
                turb_active=True, adsb_transnoise=True))
            want = eager_chunk(state_copy(state), noisy, CHUNK)[0]
            got = stepmod.run_steps(state_copy(state), noisy, CHUNK)
            assert_same("dense noise on", got, want)
            log("check graph dense noise on (turbulence and ADS-B noise): "
                "run_steps equals the eager loop bit for bit")
        time_graph_chunks(backend, state, cfg, n_ac)
        log(f"graph_phase {backend}: {time.perf_counter() - t0:.1f} s, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        del state
    graph.clear()


#: the Simulation phase's fleets: 100k continental through MCRE in the
#: 25 x 25 deg view of PAN 47.5 10 / ZOOM 0.08 (lat 35-60, lon -2.5-22.5,
#: ``DisplayState.getviewbounds``), and 10k regional in the +-3.8 deg view
#: of PAN 52.6 5.4 / ZOOM 1/3.8
SIM_N, SIM_NMAX = 100_000, 100_352
SIM_VIEW = ("PAN 47.5 10", "ZOOM 0.08")
SIM_BOX = (35.0, 60.0, -2.5, 22.5)
REG_N, REG_NMAX = 10_000, 10_240
REG_VIEW = ("PAN 52.6 5.4", f"ZOOM {1 / 3.8!r}")
REG_BOX = (52.6 - 3.8, 52.6 + 3.8, 5.4 - 3.8, 5.4 + 3.8)
#: ASAS intervals of the regional session by CD method (dense one: its
#: float64 [N, N] interval on the CPU takes ~45 s)
REG_INTERVALS = {"dense": 1, "sparse": 2, "pallas": 2}


def sim_do(sim, *lines):
    """Stack and process ``lines`` as a user types them; fail on any
    echo that reports an error.  Returns the echo lines."""
    for line in lines:
        sim.stack.stack(line)
    sim.stack.process()
    out, sim.scr.echobuf[:] = list(sim.scr.echobuf), []
    bad = [e for e in out if any(m in e for m in (
        "Unknown command", "Usage", "failed", "not found", "error"))]
    if bad:
        raise AssertionError(f"stack {lines}: {bad}")
    return out


def sim_view(sim, view, box):
    """Set the display view and check the MCRE box it gives."""
    sim_do(sim, *view)
    got = sim.scr.getviewbounds()
    if not np.allclose(got, box, atol=1e-9):
        raise AssertionError(f"view {view}: bounds {got}, want {box}")


def sim_chunks(sim, n, syncs=False):
    """Step ``sim`` ``n`` chunks of ``CHUNK`` steps; per chunk the wall
    ms of ``Simulation.step``, the ms spent waiting for edge telemetry
    (``sim_edge_pull_ms``), the host gap before its dispatch
    (``sim_dispatch_gap_ms``) and, with ``syncs``, the host
    synchronisations it made (``count_syncs``, which synchronises the
    card around the chunk)."""
    pulls = []
    sim._edge_pull_sink = pulls.append
    gap = sim.obs.get("sim_dispatch_gap_ms")
    rows = []
    for _ in range(n):
        n0, g0, s0 = len(pulls), gap.count, gap.sum
        t0 = time.perf_counter()
        if syncs:
            ns = count_syncs(lambda: sim.step(max_chunk=CHUNK))
        else:
            ns = None
            sim.step(max_chunk=CHUNK)
        rows.append(dict(
            wall_ms=(time.perf_counter() - t0) * 1e3,
            pull_ms=sum(pulls[n0:]),
            gap_ms=gap.sum - s0 if gap.count > g0 else None, syncs=ns))
    return rows


def log_chunks(tag, rows, n_ac):
    wall = sum(r["wall_ms"] for r in rows) / 1e3
    sim_s = len(rows) * CHUNK * 0.05
    log(f"sim {tag}: {len(rows)} chunks in {wall:.4f} s: "
        f"{sim_s / wall:.4g} sim-s per wall-s, "
        f"{n_ac * CHUNK * len(rows) / wall:.4g} aircraft-steps/s; per "
        f"chunk wall ms {[round(r['wall_ms'], 3) for r in rows]}, edge "
        f"pull ms {[round(r['pull_ms'], 3) for r in rows]}, dispatch gap "
        f"ms {[None if r['gap_ms'] is None else round(r['gap_ms'], 3) for r in rows]}"
        + (f", host syncs {[r['syncs'] for r in rows]}"
           if rows[0]["syncs"] is not None else ""))
    return wall


def captures():
    """CUDA graphs captured so far (``core/graph.py``)."""
    from bluesky_tpu_torch.core import graph
    return sum(len(p[2]) for p in graph._POOLS.values())


def check_sim_state(tag, sim):
    """The stepped fleet is finite, fills its slots and has conflicts."""
    from bluesky_tpu_torch.core import step as stepmod
    st = sim.traf.state
    if not bool(stepmod.state_finite(st)):
        raise AssertionError(f"sim {tag}: non-finite state")
    if int(st.ac.active.sum()) != sim.traf.ntraf:
        raise AssertionError(f"sim {tag}: live slots != ntraf")
    if int(st.asas.nconf_cur) <= 0:
        raise AssertionError(f"sim {tag}: no conflicts detected")


#: phase 10's embedded rates, which phase 15 compares with
SIM_RATES = {}


#: phase 10 (c), the profiling of the 100k Simulation: the PROFILE DEVICE
#: window's chunks and directory
PROFILE_CHUNKS = 2
PROFILE_DIR = os.path.join("output", "chip_smoke_devprof")


def top_device_ops(trace, n=5):
    """``[(name, total device ms, count)]`` of the ``n`` device ops with
    the most time in a ``torch.profiler`` Chrome trace file."""
    with open(trace) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events) \
        if isinstance(events, dict) else events
    tot = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            ms, k = tot.get(e["name"], (0.0, 0))
            tot[e["name"]] = (ms + float(e.get("dur", 0.0)) / 1e3, k + 1)
    return sorted(((k, ms, c) for k, (ms, c) in tot.items()),
                  key=lambda r: -r[1])[:n]


def profile_phase(sim):
    """Phase 10 (c): PROFILE on the 100k Simulation, under CDMETHOD SPARSE
    and RESO MVP.  The host syncs of two chunks with every devprof
    feature off; the wall ms of pipelined chunks with the compile
    telemetry off and on (logged); then the syncs with the memory sample at every chunk edge
    (``devprof_mem_dt``), which must be equal and leave
    ``devprof_live_bytes_total`` above 0; ``PROFILE DEVICE`` over
    ``PROFILE_CHUNKS`` chunks, whose Chrome trace must be written (its
    size and top device ops logged), then the syncs of two chunks once
    more, equal again; and ``PROFILE KERNELS 20``, its report logged.
    The devprof counters of the session are logged too."""
    import shutil
    from bluesky_tpu_torch import settings
    t0 = time.perf_counter()
    sim_do(sim, "CDMETHOD SPARSE", "RESO MVP")
    sim_chunks(sim, 2)                     # this configuration's captures
    syncs = lambda rows: [r["syncs"] for r in rows]
    off = syncs(sim_chunks(sim, 2, syncs=True))
    # the compile telemetry's hook (on by default) against none: the
    # host ms per pipelined chunk, off, on, off, on
    walls, tel0 = {False: [], True: []}, settings.devprof_compile_telemetry
    try:
        for tel in (False, True, False, True):
            settings.devprof_compile_telemetry = tel
            walls[tel] += [r["wall_ms"] for r in sim_chunks(sim, 3)]
    finally:
        settings.devprof_compile_telemetry = tel0
    old = settings.devprof_mem_dt
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    settings.devprof_mem_dt = 1e-6
    try:
        on = syncs(sim_chunks(sim, 2, syncs=True))
        live = sim.obs.get("devprof_live_bytes_total")
        if live is None or live.value <= 0:
            raise AssertionError("profile: devprof_live_bytes_total is not "
                                 "above 0 with the memory sample on")
        sim_do(sim, f"PROFILE DEVICE {PROFILE_CHUNKS} {PROFILE_DIR}")
        n0 = len(sim.devprof.windows)
        win_rows = sim_chunks(sim, PROFILE_CHUNKS + 2)
        sim.drain_pipeline()
        if sim.devprof.window_active or len(sim.devprof.windows) != n0 + 1:
            raise AssertionError("profile: the PROFILE DEVICE window did not "
                                 "close after its chunks")
        win = sim.devprof.windows[-1]
        if not win["trace"] or not os.path.isfile(win["trace"]):
            raise AssertionError(f"profile: no trace file in {PROFILE_DIR}")
        size = os.path.getsize(win["trace"])
        top = top_device_ops(win["trace"])
        if not top:
            raise AssertionError("profile: the trace holds no device op")
        after = syncs(sim_chunks(sim, 2, syncs=True))
    finally:
        settings.devprof_mem_dt = old
    if not off == on == after:
        raise AssertionError(f"profile: host syncs per chunk {off} with "
                             f"devprof off, {on} with the memory sample, "
                             f"{after} after the window")
    kern = sim_do(sim, "PROFILE KERNELS 20")
    log("profile: wall ms per pipelined chunk, compile telemetry off "
        f"{[round(w, 3) for w in walls[False]]} (mean "
        f"{np.mean(walls[False]):.3f}), on {[round(w, 3) for w in walls[True]]}"
        f" (mean {np.mean(walls[True]):.3f})")
    log(f"profile: host syncs per chunk {off} off, {on} with the memory "
        f"sample, {after} after the window (equal); devprof_live_bytes_total"
        f" {int(live.value)}, watermarks {sim.devprof.watermarks()}")
    log(f"profile: PROFILE DEVICE {PROFILE_CHUNKS}: trace {win['trace']} "
        f"{size} bytes, window {win['wall_s']} s, chunk wall ms "
        f"{[round(r['wall_ms'], 3) for r in win_rows]}, per chunk "
        f"{ {q: {k: v for k, v in c.items() if k != 't0'} for q, c in win['chunks'].items()} }")
    log("profile: top device ops (name, ms, count): "
        + "; ".join(f"{k[:80]} {ms:.3f} {c}" for k, ms, c in top))
    log("profile: PROFILE KERNELS 20:\n" + "\n".join(kern))
    log(f"profile: {sim.devprof.compile_summary()}; compile histograms "
        + ", ".join(f"{h} {sim.obs.get(h).count} x "
                    f"{sim.obs.get(h).mean:.1f} ms"
                    for h in ("devprof_compile_trace_ms",
                                     "devprof_compile_lower_ms")
                    if sim.obs.get(h) is not None)
        + f"; {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)


def sim_continental(dev):
    """The 100k continental session through the stack: CDMETHOD SPARSE,
    ASAS ON, the view, MCRE 100000 B744, OP, five ASAS intervals and
    more (pipelined, with host syncs counted, then with the pipeline
    off, then the bare runner on the same state), a ring capture, then
    CDMETHOD PALLAS and RESO EBY for three intervals.  Returns the
    kernel launches of the session."""
    import torch
    from bluesky_tpu_torch.core import graph, step as stepmod
    from bluesky_tpu_torch.simulation.sim import Simulation
    graph.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = Simulation(nmax=SIM_NMAX)
    if sim.traf.device.type != dev.type:
        raise AssertionError(f"Simulation() runs on {sim.traf.device}")
    sim_do(sim, "CDMETHOD SPARSE", "ASAS ON")
    sim_view(sim, SIM_VIEW, SIM_BOX)
    cap0 = captures()
    reset_launches()
    # FF: fast-time, no wall-clock pacing (Simulation._plan_chunk)
    sim_do(sim, f"MCRE {SIM_N} B744", "OP", "FF")
    torch.cuda.synchronize()
    log(f"sim continental: Simulation(nmax={SIM_NMAX}) and MCRE {SIM_N} "
        f"in {time.perf_counter() - t0:.2f} s, {sim.traf.ntraf} aircraft")
    first = sim_chunks(sim, 2)
    log(f"sim continental: graph captures of the first MCRE's chunks "
        f"{captures() - cap0}")
    log_chunks("sparse MVP, first two chunks (captures)", first, SIM_N)
    piped = sim_chunks(sim, 6)
    wall_p = log_chunks("sparse MVP pipelined", piped, SIM_N)
    log_chunks("sparse MVP pipelined, host syncs counted",
               sim_chunks(sim, 2, syncs=True), SIM_N)
    sim_do(sim, "CHUNKSTEPS PIPELINE OFF")
    sync = sim_chunks(sim, 4)
    wall_s = log_chunks("sparse MVP chunk_pipeline off", sync, SIM_N)
    log_chunks("sparse MVP chunk_pipeline off, host syncs counted",
               sim_chunks(sim, 2, syncs=True), SIM_N)
    sim_do(sim, "CHUNKSTEPS PIPELINE ON")
    log(f"sim continental: pipelined {1e3 * wall_p / len(piped):.4g} ms "
        f"per chunk against {1e3 * wall_s / len(sync):.4g} ms synchronous")
    SIM_RATES["sparse pipelined ms per 20 steps"] = 1e3 * wall_p / len(piped)
    wall, busy, nk, calls = profile_chunk(
        lambda: (sim.step(max_chunk=CHUNK), sim.drain_pipeline()))
    log(f"sim continental: profiled chunk {wall:.3f} ms wall, {busy:.3f} "
        f"ms kernels ({100 * busy / wall:.1f} % busy), {nk} kernel "
        f"executions, host calls {calls}")
    check_sim_state("sparse", sim)
    # the bare runner on the same state: no stack, no edge work
    sim.drain_pipeline()
    state = sim.traf.state
    bare = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = stepmod.run_steps_edge(state, sim.cfg, CHUNK,
                                       checked=True)[0]
        torch.cuda.synchronize()
        bare.append((time.perf_counter() - t1) * 1e3)
    sim.traf.state = state
    log(f"sim continental: bare run_steps_edge(checked) ms per chunk "
        f"{[round(m, 3) for m in bare]}, aircraft-steps/s "
        f"{[f'{SIM_N * CHUNK / (m / 1e3):.4g}' for m in bare]}")
    t1 = time.perf_counter()
    sim.snap_ring.capture(sim)
    log(f"sim continental: snapshot-ring capture "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    sim.snap_ring.clear()
    cap1 = captures()
    sim_do(sim, "CDMETHOD PALLAS", "RESO EBY")
    eby = sim_chunks(sim, 4)
    log_chunks("pallas EBY (first chunk captures)", eby, SIM_N)
    log(f"sim continental: graph captures after CDMETHOD PALLAS, RESO EBY "
        f"{captures() - cap1}")
    sim.drain_pipeline()
    check_sim_state("pallas EBY", sim)
    launches = launch_counts()
    log(f"sim continental: kernel launches {launches}")
    # K1 and K2 on the sparse path, K3 (Eby form) on the pallas one
    for form in ("cd_sched._sched_kernel", "cd_pallas._kernel_resume",
                 "cd_pallas._kernel/eby"):
        if launches[form] < 1:
            raise AssertionError(f"Simulation.run never launched {form}")
    screenshot_100k(sim)
    ps = sim.pipe_stats
    log(f"sim continental: {time.perf_counter() - t0:.1f} s, simt "
        f"{sim.simt:.2f}, ASAS intervals {float(sim.traf.state.asas_tnext):g}"
        f", chunks {ps['pipelined_chunks']} pipelined / {ps['sync_chunks']}"
        f" sync, sync reasons {dict(ps['sync_reasons'].items())}, peak "
        f"device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_phase(sim)
    del sim, state
    graph.clear()
    return launches


def caller_partners(asas):
    """Row-wise caller-space partner sets of a state's ``asas`` arrays
    (host NumPy): the sorted-space ``partners_s`` mapped back through
    the stripe destinations ``sort_perm`` (sparse), else ``partners``."""
    ps, perm = asas["asas.partners_s"], asas["asas.sort_perm"]
    inv = np.full(ps.shape[0], -1)
    inv[perm] = np.arange(perm.size)
    return [frozenset(int(inv[j]) for j in ps[perm[i]] if j >= 0)
            for i in range(perm.size)]


def borderline_pairs(pre, cfg, dev, margin=1e-4):
    """The directional pairs of the state ``pre`` (host arrays, float64)
    whose float64 conflict or LoS flag hangs on a comparison within
    ``margin`` of its threshold (relative to R^2, the lookahead, R or
    the half-height), the pair's other comparisons holding: a float32
    evaluation may flag them either way.  Conflict: dcpa^2 against R^2
    with the closest approach inside the lookahead, the window's ends
    against each other, 0 and the lookahead, and the altitude gap
    against the half-height when the pair is in horizontal conflict;
    LoS: the distance against R and the altitude gap against the
    half-height."""
    import torch
    from bluesky_tpu_torch.ops import cd
    t = lambda k: torch.as_tensor(pre[k], device=dev)
    act = t("ac.active")
    o = cd.detect(t("ac.lat"), t("ac.lon"), t("ac.trk"), t("ac.gs"),
                  t("ac.alt"), t("ac.vs"), act, cfg.rpz, cfg.hpz,
                  cfg.dtlookahead)
    tl, r2, hpz, alt = cfg.dtlookahead, cfg.rpz ** 2, cfg.hpz, t("ac.alt")
    dalt = (alt[None, :] - alt[:, None]).abs()
    near = lambda x, ref, scale: (x - ref).abs() < margin * scale
    h, nh = o.dcpa2 < r2, near(o.dcpa2, r2, r2)
    na = near(o.tinconf, o.toutconf, tl)
    nb = near(o.toutconf, 0.0, tl)
    nc = near(o.tinconf, tl, tl)
    nv = near(dalt, hpz, hpz)
    ahead = (o.tcpa > -margin * tl) & (o.tcpa < tl * (1 + margin))
    conf = (h & ((o.tinconf <= o.toutconf) | na) & ((o.toutconf > 0) | nb)
            & ((o.tinconf < tl) | nc) & (na | nb | nc)) \
        | ((nh | (nv & h)) & ahead)
    los = (near(o.dist, cfg.rpz, cfg.rpz) & (dalt < hpz * (1 + margin))) \
        | (nv & (o.dist < cfg.rpz * (1 + margin)))
    pairs = act[:, None] & act[None, :]
    pairs.fill_diagonal_(False)
    return torch.nonzero((conf | los) & pairs).cpu().numpy()


def compare_sims(tag, backend, card, cpu, pre):
    """Card against CPU after one ASAS interval from the same inputs
    ``pre`` (host arrays of the state at the ASAS step): callsigns, every
    int and bool (flags, counts) and the partner sets equal; floats
    within rtol 1e-9 / atol 1e-9 on dense (PR 5's card-vs-CPU bound,
    float64 on both sides).  Where the float32 kernels ran (sparse,
    pallas) the rows of the pairs ``borderline_pairs`` finds are set
    apart (a float32 test may go either way there: the counts may differ
    by at most their number, and no other row may differ); the floats
    are held at the float32 bounds of ``tests/test_torch_slice.py``
    (lat/lon 1e-5 deg, the aircraft's altitudes 1e-2 m, the rest rtol
    1e-4 / atol 1e-3), but for the resolver's commands (``asas.*``,
    ``pilot.*``): they come from pair sums that the card adds in another
    float32 order (the kernel check ``cd_pallas.compare_outputs`` allows
    rtol 1e-4 / atol 5e-3 on one call's sums), held at rtol 1e-3 / atol
    5e-2."""
    from bluesky_tpu_torch.core.state import state_to_numpy
    a, b = state_to_numpy(card.traf.state), state_to_numpy(cpu.traf.state)
    n = card.traf.nmax
    if card.traf.ids != cpu.traf.ids:
        raise AssertionError(f"sim {tag}: callsigns differ")
    edge = np.zeros((0, 2), int) if backend == "dense" \
        else borderline_pairs(pre, card.cfg.asas, card.traf.device)
    keep = np.ones(n, bool)
    keep[edge.ravel()] = False
    row = lambda k, x: x[keep] if x.ndim and x.shape[0] == n \
        and k != "asas.resopairs" else x
    bad, moved = [], set()
    for k in a:
        if a[k].dtype.kind in "fc" or k in (
                "asas.partners_s", "asas.sort_perm", "asas.partners"):
            continue
        if k in ("asas.nconf_cur", "asas.nlos_cur"):
            if abs(int(a[k]) - int(b[k])) > len(edge):
                bad.append(f"{k} {int(a[k])} / {int(b[k])}")
        elif not np.array_equal(a[k], b[k]):
            d = np.atleast_1d(a[k] != b[k])
            if d.shape[0] == n:
                moved |= set(np.flatnonzero(d.reshape(n, -1).any(1)))
            if not np.array_equal(row(k, a[k]), row(k, b[k])):
                bad.append(f"{k} in {int(d.sum())} entries")
    if backend == "sparse":
        pa, pb = caller_partners(a), caller_partners(b)
    elif backend == "pallas":
        pa, pb = ([frozenset(r[r >= 0]) for r in x["asas.partners"]]
                  for x in (a, b))
    else:
        pa, pb = ([frozenset(np.flatnonzero(r)) for r in x["asas.resopairs"]]
                  for x in (a, b))
    moved |= {i for i in range(n) if pa[i] != pb[i]}
    if any(pa[i] != pb[i] for i in np.flatnonzero(keep)):
        bad.append("partner sets")
    worst = {}
    for k in a:
        x, y = a[k], b[k]
        if x.dtype.kind not in "fc" or not x.size:
            continue
        if backend == "dense":
            rtol, atol = 1e-9, 1e-9
        elif k.endswith((".lat", ".lon")):
            rtol, atol = 0.0, 1e-5
        elif k in ("ac.alt", "ac.selalt", "adsb.alt"):
            rtol, atol = 0.0, 1e-2
        elif k.startswith(("asas.", "pilot.")):
            rtol, atol = 1e-3, 5e-2
        else:
            rtol, atol = 1e-4, 1e-3
        x, y = row(k, x), row(k, y)
        d = np.abs(x - y)
        if k.endswith(("trk", "hdg")):
            d = np.minimum(d, 360.0 - d)
        worst[k] = float(d.max())
        if not (d <= atol + rtol * np.abs(y)).all():
            bad.append(f"{k} by {worst[k]:.3g}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    log(f"check sim {tag} card vs CPU: nconf {int(a['asas.nconf_cur'])} / "
        f"{int(b['asas.nconf_cur'])}, nlos {int(a['asas.nlos_cur'])} / "
        f"{int(b['asas.nlos_cur'])}, {len(edge)} borderline directional "
        f"pairs (rows {sorted(set(edge.ravel().tolist()))[:12]}), rows "
        f"that differ {sorted(int(i) for i in moved)[:12]}, largest float "
        f"differences {top}")
    if bad:
        raise AssertionError(f"sim {tag}: card vs CPU differ: {bad}")
    log(f"check sim {tag} card vs CPU: ids, flags, counts and partner sets "
        "equal off the borderline pairs, floats within bounds")


def sim_regional(dev):
    """The 10k regional session through the stack on the card and on the
    CPU (the plain versions), float64: the view, MCRE 10000, ASAS ON,
    OP, FF, then CDMETHOD DENSE for ``REG_INTERVALS["dense"]`` ASAS
    intervals, SPARSE and PALLAS for two each.  Each interval starts from the same inputs: both
    step to the ASAS step, the CPU takes the card's state, both finish
    the second, and ``compare_sims`` holds them against each other."""
    import torch
    from bluesky_tpu_torch.core import graph
    from bluesky_tpu_torch.core.state import state_from_numpy, state_to_numpy
    from bluesky_tpu_torch.simulation.sim import Simulation
    graph.clear()
    t0 = time.perf_counter()
    card, cpu = (Simulation(nmax=REG_NMAX, dtype=torch.float64, device=d)
                 for d in (dev, "cpu"))
    for sim in (card, cpu):
        sim_view(sim, REG_VIEW, REG_BOX)
        sim_do(sim, f"MCRE {REG_N} B744", "ASAS ON", "OP", "FF")
    for backend, intervals in REG_INTERVALS.items():
        t1 = time.perf_counter()
        for sim in (card, cpu):
            sim_do(sim, f"CDMETHOD {backend.upper()}")
        for k in range(1, intervals + 1):
            t_end = card.simt + 1.0
            for sim in (card, cpu):
                st = sim.traf.state
                while st.simt < st.asas_tnext:      # up to the ASAS step
                    sim.run(until_simt=sim.simt + sim.simdt)
                    st = sim.traf.state
            pre = {k: np.array(v, copy=True)
                   for k, v in state_to_numpy(card.traf.state).items()}
            cpu.traf.state = state_from_numpy(pre, device="cpu")
            for sim in (card, cpu):
                sim.run(until_simt=t_end)
            compare_sims(f"regional {backend} interval {k}", backend, card,
                         cpu, pre)
        log(f"sim regional {backend}: {intervals} ASAS interval(s) on the "
            f"card and the CPU in {time.perf_counter() - t1:.1f} s")
    check_sim_state("regional", card)
    log(f"sim regional: {time.perf_counter() - t0:.1f} s")
    del card, cpu
    graph.clear()


# ------------------------------------------------------------ worlds phase
#: the worlds shapes: (worlds, aircraft a world, slots a world).  The
#: MVP shape is the 256 x N=500 fleet of BENCH_WORLDS.json's projected
#: headline (128k slots, about the main path's size), EBY an ensemble of
#: sixteen national-airspace-sized scenarios (nb = 40 row blocks a world
#: at block 256), dense the file's largest N.
WORLDS_MVP = (256, 500, 512)
WORLDS_EBY = (16, 10_000, 10_240)
WORLDS_DENSE = (16, 2_000, 2_048)
#: the world counts the script runs are the shapes' divided by this (the
#: solo loop of 256 worlds took 11 s a chunk, the 16-piece WorldBatch 35 s
#: of scenario lines)
WORLDS_SCALE = 2
#: the world-axis forms of the kernels, by the kernel of each backend
WORLD_KERNELS = {"sparse": ("cd_sched._sched_kernel",
                            "cd_pallas._kernel_resume"),
                 "pallas": ("cd_pallas._kernel",)}


def world_scene(dev, worlds, n_ac, nmax, backend, reso="MVP", kk=8):
    """``worlds`` worlds of ``regional_scene`` (world w from numpy seed
    w), float32, ``Traffic(pair_matrix=backend == "dense",
    k_partners=kk)``, built on the CPU (no launches) and stacked on
    ``dev``; the sort refresh is the chunk's.  Returns ``(stacked state,
    cfg)``."""
    from bluesky_tpu_torch.core import graph, step as stepmod
    states = []
    for w in range(worlds):
        st, cfg = regional_scene("cpu", n_ac, nmax, seed=w,
                                 cd_backend=backend, cd_block=256,
                                 reso_method=reso,
                                 pair_matrix=backend == "dense",
                                 k_partners=kk)
        states.append(st)
    ws = stepmod.stack_worlds(states)
    return graph.rebuild(ws, iter([t.to(dev) for _, t in
                                   graph.leaves(ws)])), cfg


def world_chunk(state, cfg, backend, batched=True):
    """One chunk of the worlds phase: the sort refresh (none for dense)
    and ``CHUNK`` steps through ``run_steps_worlds_edge`` (a stacked
    state) or ``run_steps_edge`` (one world)."""
    from bluesky_tpu_torch.core import asas, step as stepmod
    if backend != "dense":
        state = asas.refresh_spatial_sort(state, cfg.asas, block=256,
                                          impl=asas.impl_for_backend(backend))
    run = stepmod.run_steps_worlds_edge if batched else stepmod.run_steps_edge
    return run(state, cfg, CHUNK)[0]


def launches_per_interval(launches, intervals):
    return {k: v / intervals for k, v in launches.items() if v}


def compare_worlds(tag, got, want, backend):
    """Hold each world of the stacked ``got`` against its solo run
    ``want`` (stacked too): flags, counts and the pair state (the
    partner tables as row sets) equal, floats within the float32 bounds
    of PERF.md §2 (lat/lon 1e-5 deg, altitude 1e-2 m, the rest rtol 1e-4
    / atol 1e-3).  Returns whether every tensor is bit-equal."""
    import torch
    from bluesky_tpu_torch.core import graph
    same = True
    for (k, a), (_, b) in zip(graph.leaves(got), graph.leaves(want)):
        if bits_equal(a, b):
            continue
        same = False
        if k in ("asas.partners_s.", "asas.partners."):
            if not torch.equal(torch.sort(a, -1).values,
                               torch.sort(b, -1).values):
                raise AssertionError(f"{tag}: {k} partner sets differ")
        elif not a.is_floating_point():
            w = (a != b).reshape(a.shape[0], -1).any(1).nonzero()
            raise AssertionError(f"{tag}: {k} differs in worlds "
                                 f"{w.flatten()[:8].tolist()}")
        else:
            d = (a.double() - b.double()).abs()
            if k.endswith(("trk.", "hdg.")):
                d = torch.minimum(d, 360.0 - d)
            rtol, atol = ((0.0, 1e-5) if k.endswith(("lat.", "lon."))
                          else (0.0, 1e-2) if k.endswith("alt.")
                          else (1e-4, 1e-3))
            bad = (d > atol + rtol * b.double().abs()) \
                & ~(a.isnan() & b.isnan())
            if bool(bad.any()):
                raise AssertionError(f"{tag}: {k} off by {float(d.max())}")
    for k in ("simt", "fms_t0", "asas_tnext"):
        if not np.array_equal(getattr(got, k), getattr(want, k)):
            raise AssertionError(f"{tag}: host {k} differs")
    return same


def worlds_batched_vs_solo(dev, backend, shape, reso="MVP", kk=8):
    """Phase 11, one shape: ``CHUNKS`` chunks of the stacked worlds through
    ``run_steps_worlds_edge`` (counts set to 0 just before, read just
    after), then the same chunks on the same worlds one at a time through
    ``run_steps_edge``; every world held to its solo run
    (``compare_worlds``); ms per chunk, aggregate aircraft-steps/s,
    launches per ASAS interval, peak memory and host synchronisations of
    a batched chunk.  Partner tables ``kk`` wide (phase 13 (d)).  Returns
    ``(stepped stack, cfg, batched launches)``."""
    import torch
    from bluesky_tpu_torch.core import graph, step as stepmod
    worlds, n_ac, nmax = shape
    tag = f"worlds {backend} {reso} {worlds} x {n_ac}" \
        + ("" if kk == 8 else f" K={kk}")
    t0 = time.perf_counter()
    init, cfg = world_scene(dev, worlds, n_ac, nmax, backend, reso, kk)
    torch.cuda.synchronize()
    log(f"{tag}: built in {time.perf_counter() - t0:.2f} s")
    graph.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, ms = init, []
    for _ in range(3):
        t0 = time.perf_counter()
        state = world_chunk(state, cfg, backend)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    intervals = 3
    steps = worlds * n_ac * CHUNK
    log(f"{tag} batched: ms per chunk {[round(m, 3) for m in ms]} (the "
        f"first two capture), aircraft-steps/s of the third "
        f"{steps / ms[-1] * 1e3:.4g}, kernel launches per ASAS interval "
        f"{launches_per_interval(launches, intervals)}, peak memory "
        f"{peak / 2**30:.3f} GiB, nconf {state.asas.nconf_cur.sum().item()}")
    if not bool(stepmod.state_finite(state).all()):
        raise AssertionError(f"{tag}: non-finite state")
    if int(state.asas.nconf_cur.sum()) <= 0:
        raise AssertionError(f"{tag}: no conflicts detected")
    for k in WORLD_KERNELS.get(backend, ()):
        name = form_name(k, {"MVP": "mvp", "EBY": "eby"}.get(reso, "mvp"))
        if launches[name] != intervals:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} "
                                 f"times in {intervals} intervals, not "
                                 "once per interval for the group")
    done = state_copy(state)
    graph.release(state)        # the sync count reuses the buffers
    syncs = count_syncs(lambda: world_chunk(state_copy(done), cfg, backend))
    log(f"{tag} batched: host syncs in a chunk {syncs}")
    if syncs:
        raise AssertionError(f"{tag}: {syncs} host syncs in a worlds chunk")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    solo = []
    t0 = time.perf_counter()
    for w in range(worlds):
        s = stepmod.world_slice(init, w)
        for _ in range(3):
            s = world_chunk(s, cfg, backend, batched=False)
        solo.append(state_copy(s))
        graph.release(s)
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo_launches = launch_counts()
    solo_peak = torch.cuda.max_memory_allocated()
    log(f"{tag} solo loop: ms per chunk of all worlds "
        f"{solo_s / 3 * 1e3:.4g} (captures included), aircraft-steps/s "
        f"{steps * 3 / solo_s:.4g}, kernel launches per ASAS interval "
        f"{launches_per_interval(solo_launches, intervals)}, peak memory "
        f"{solo_peak / 2**30:.3f} GiB")
    same = compare_worlds(tag, done, stepmod.stack_worlds(solo), backend)
    log(f"{tag}: every world equals its solo run (flags, counts, partner "
        f"sets; floats within the f32 bounds); bit-equal: {same}")
    return done, cfg, launches


def world_kernel_runs(state, cfg, backend):
    """The world-group launches of phase 11's kernels on the operands of
    the next interval of the stepped stack ``state``, for ``measure``:
    K1 and K2 (sparse) or K3 (pallas, on the Morton-sorted columns)."""
    import torch
    from bluesky_tpu_torch.core import asas as asasmod
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cd_tiled
    ac, a, c = state.ac, state.asas, cfg.asas
    mvp = asasmod._mvp_config(c)
    cols = [ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, a.noreso]
    worlds, nmax = ac.lat.shape
    if backend == "pallas":
        perm = a.sort_perm.long()
        x = cd_pallas.prepare(*[cd_tiled.take(t, perm) for t in cols],
                              c.rpz, c.dtlookahead, block=256)
        p = cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp)
        tiles = reach_tiles(x, x.reach)
        return {"cd_pallas._kernel/worlds": dict(
            kern=lambda **kw: cd_pallas.full_grid(x.packed, x.reach, p, **kw),
            plain=lambda: cd_pallas.full_grid_plain(x.packed, x.reach, p),
            pairs=active_pairs(x, tiles),
            bytes=in_out_bytes(x, False) + x.reach.numel(),
            tiles=int(x.reach.sum()), reso="mvp",
            extra=dict(worlds=worlds, slots=nmax, **item_extra(
                "cd_pallas._kernel/worlds", x,
                cd_pallas.reach_items(x.reach), p)))}
    n_tot = cd_sched.padded_size(nmax, 256)
    x = cd_sched.prepare(*cols, c.rpz, c.hpz, c.dtlookahead,
                         a.partners_s[..., :n_tot, :], block=256,
                         perm=a.sort_perm)
    p = cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp,
                              c.rpz * c.resofach)
    reach_f = x.reach & x.overflow[:, None]
    seg = segment_tiles(x)
    over = reach_tiles(x, reach_f)
    k1 = cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold, p,
                              nbw=x.nb)
    k2 = cd_pallas.full_grid_resume(x.packed, reach_f, x.pold, p)
    ln = np.minimum(x.wln.cpu().numpy(), x.wmax)
    log(f"worlds sparse operands: {x.packed.shape[0]} row blocks "
        f"({worlds} worlds of {x.nb}), overflow rows "
        f"{int(x.overflow.sum())}, scheduled tiles {int(ln.sum())}")
    return {
        "cd_sched._sched_kernel/worlds": dict(
            kern=lambda **kw: cd_sched.sched_tiles(
                x.packed, x.wst, x.wln, x.wmax, x.pold, p, nbw=x.nb, **kw),
            plain=lambda: cd_sched.sched_tiles_plain(
                x.packed, x.wst, x.wln, x.wmax, x.pold, p, nbw=x.nb),
            pairs=active_pairs(x, seg), keep=keep_pairs(x, seg, k1[6]),
            bytes=in_out_bytes(x, True) + 2 * x.wst.numel() * 4,
            tiles=int(ln.sum()), reso="mvp",
            extra=dict(worlds=worlds, slots=nmax, **item_extra(
                "cd_sched._sched_kernel/worlds", x,
                cd_sched.window_items(x.wst, x.wln, x.wmax, x.nb), p,
                pold=x.pold))),
        "cd_pallas._kernel_resume/worlds": dict(
            kern=lambda **kw: cd_pallas.full_grid_resume(
                x.packed, reach_f, x.pold, p, **kw),
            plain=lambda: cd_pallas.full_grid_resume_plain(
                x.packed, reach_f, x.pold, p),
            pairs=active_pairs(x, over), keep=keep_pairs(x, over, k2[6]),
            bytes=in_out_bytes(x, True) + reach_f.numel(),
            tiles=int(reach_f.sum()), reso="mvp",
            extra=dict(worlds=worlds, slots=nmax, **item_extra(
                "cd_pallas._kernel_resume/worlds", x,
                cd_pallas.reach_items(reach_f), p, pold=x.pold))),
    }


def world_piece(seed, n_ac, tend):
    """A BATCH piece of ``n_ac`` aircraft of the regional geometry from
    numpy seed ``seed`` as CRE lines (altitudes in ft, CAS 250-450 kt),
    under CDMETHOD SPARSE and ASAS ON, fast-forwarded ``tend`` sim-s."""
    c = columns(n_ac, "regional", seed)
    cas = np.random.default_rng(1000 + seed).uniform(250.0, 450.0, n_ac)
    lines = ["CDMETHOD SPARSE", "ASAS ON"] + [
        f"CRE W{seed:02d}{i:04d} B744 {c['lat'][i]:.6f} {c['lon'][i]:.6f} "
        f"{c['trk'][i]:.2f} {c['alt'][i] / FT:.0f} {cas[i]:.1f}"
        for i in range(n_ac)] + [f"FF {tend:g}"]
    return [0.0] * len(lines), lines


def worldbatch_phase(dev, pieces=64, n_ac=500, nmax=512, tend=60.0,
                     nsolo=4):
    """Phase 11, the user's path: ``pieces`` BATCH pieces through
    ``WorldBatch.run()`` (guard on), ``nsolo`` of them held to solo
    ``Simulation``s run to the same time.  Returns the kernel launches
    of the pack's run."""
    import torch
    from bluesky_tpu_torch.core import graph
    from bluesky_tpu_torch.simulation.sim import OP, Simulation
    from bluesky_tpu_torch.simulation.worlds import WorldBatch
    scen = [world_piece(s, n_ac, tend) for s in range(pieces)]
    graph.clear()
    t0 = time.perf_counter()
    wb = WorldBatch(scen, simkw=dict(nmax=nmax, device=dev))
    setup = stack_setup(wb.sims)
    log(f"worldbatch: {pieces} pieces set up in "
        f"{time.perf_counter() - t0:.2f} s, their scenario lines "
        f"({pieces * (n_ac + 3)} stack commands) processed in {setup:.2f} s")
    reset_launches()
    t0 = time.perf_counter()
    status = wb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    if status != ["completed"] * pieces:
        raise AssertionError(f"worldbatch: statuses {set(status)}")
    if any(s.guard.trips for s in wb.sims):
        raise AssertionError("worldbatch: a guard tripped")
    sim_s = sum(s.simt for s in wb.sims)
    log(f"worldbatch: {pieces} x {n_ac} aircraft, {tend:g} sim-s each: "
        f"joint_dispatches {wb.stats['joint_dispatches']}, largest group "
        f"{wb.stats['max_group']}, solo dispatches "
        f"{wb.stats['solo_dispatches']}, run() {wall:.3f} s wall, "
        f"{sim_s / wall:.4g} sim-s per wall-s of the pack "
        f"({sim_s * n_ac / wall / wb.sims[0].cfg.simdt:.4g} "
        f"aircraft-steps/s; {sim_s / (wall + setup):.4g} sim-s per wall-s "
        f"with the scenario lines), kernel launches {launches}")
    for k in WORLD_KERNELS["sparse"]:
        if not launches.get(k):
            raise AssertionError(f"worldbatch never launched {k}")
    for i in range(min(nsolo, pieces)):
        graph.clear()
        sim = Simulation(nmax=nmax, device=dev)
        sim.pipeline_enabled = False
        sim.stack.set_scendata(*scen[i])
        sim.op()
        setup = stack_setup([sim])
        t0 = time.perf_counter()
        while sim.state_flag == OP:
            sim.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sim.simt != wb.sims[i].simt:
            raise AssertionError(f"worldbatch world {i}: simt "
                                 f"{wb.sims[i].simt} != solo {sim.simt}")
        same = compare_worlds(f"worldbatch world {i}",
                              _stack1(wb.sims[i].traf.state),
                              _stack1(sim.traf.state), "sparse")
        log(f"worldbatch world {i}: equals its solo Simulation "
            f"(bit-equal: {same}); solo {sim.simt / wall:.4g} sim-s per "
            f"wall-s (captures included; {sim.simt / (wall + setup):.4g} "
            f"with the scenario lines)")
    return launches


def stack_setup(sims):
    """Process the scenario lines due at sim time 0 of each of ``sims``
    (its CRE lines and settings, as ``_plan_chunk`` would at the first
    step); returns the wall seconds."""
    import torch
    t0 = time.perf_counter()
    for sim in sims:
        sim.stack.checkfile(sim.simt)
        sim.stack.process()
        sim.traf.flush()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _stack1(state):
    from bluesky_tpu_torch.core import step as stepmod
    return stepmod.stack_worlds([state])


def worlds_phase(dev, errs, regs, scale=1):
    """Phase 11: world-batched stepping (``worlds_batched_vs_solo`` on the
    three worlds shapes, world counts divided by ``scale``), the
    world-group launches of K1, K2 and K3 against their plain versions
    at the MVP shape, and ``worldbatch_phase``.  Returns the kernels
    JSON entries of the world-axis forms."""
    shrink = lambda s: (max(2, s[0] // scale),) + s[1:]
    report = []
    for backend in ("sparse", "pallas"):
        t0 = time.perf_counter()
        state, cfg, launches = worlds_batched_vs_solo(
            dev, backend, shrink(WORLDS_MVP))
        runs = world_kernel_runs(state, cfg, backend)
        launches = {f"{k}/worlds": launches[k]
                    for k in WORLD_KERNELS[backend]}
        report += report_kernels(runs, launches, errs, regs)
        log(f"worlds {backend}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worlds_batched_vs_solo(dev, "sparse", shrink(WORLDS_EBY), reso="EBY")
    log(f"worlds sparse EBY: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worlds_batched_vs_solo(dev, "dense", shrink(WORLDS_DENSE))
    log(f"worlds dense: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worldbatch_phase(dev, pieces=max(2, 4 // scale))
    log(f"worldbatch: {time.perf_counter() - t0:.1f} s")
    return report


#: the differentiable phase (``diff_phase``): the demo scene (25 head-on
#: pairs, ``conflict_scene``, with legs of 20 km: the pairs meet at
#: ~80 s; float64, whose descent the card follows to 1e-14 of the CPU's,
#: where float32 rounding takes another path) and the OPT arguments
#: (tend, iterations, learning rate); the
#: card-against-CPU check's scene and horizon; the full-width rollout
#: (the dense worlds shape of the worlds phase) and its chunks without
#: and with ASAS in the loop (50 does not fit in 80 GB with ASAS)
DIFF_DEMO_N, DIFF_DEMO_LEG_KM, DIFF_DEMO_OPT = 50, 20.0, (100.0, 4, 0.5)
DIFF_CHECK_N, DIFF_CHECK_TEND = 8, 100.0
DIFF_CHECK_RTOL = 1e-9
DIFF_WIDE = dict(n_ac=2000, nmax=2048, tend=50.0, simdt=1.0,
                 chunk=(50, 25))

_OPT_ECHO = re.compile(
    r"OPT: objective (\S+) -> (\S+) in (\d+) iters \((\d+) restart\(s\), "
    r"best (\d+)\); hard LoS (\d+) -> (\d+)")


def diff_opt_demo(dev, restarts=1):
    """Phase 12 (a)/(b): ``conflict_scene(DIFF_DEMO_N)`` created in a
    float64 ``Simulation`` on the card, then ``TRACE ON`` and ``OPT
    tend,iters,lr[,restarts]`` typed into its stack.  Fails unless the
    guard stays clean, the plan had hard LoS before and none after, and
    the objective fell.  Logs the wall seconds of each descent iteration
    (the ``opt_step`` spans of the flight recorder) and of the command."""
    import torch
    from bluesky_tpu_torch.diff import optimize as dopt
    from bluesky_tpu_torch.simulation.sim import Simulation
    tend, n_it, lr = DIFF_DEMO_OPT
    sim = Simulation(nmax=DIFF_DEMO_N, dtype=torch.float64, device=dev)
    dopt.conflict_scene(DIFF_DEMO_N, leg_km=DIFF_DEMO_LEG_KM, traf=sim.traf)
    cmd = f"OPT {tend:g},{n_it},{lr:g}" \
        + (f",{restarts}" if restarts > 1 else "")
    sim.stack.stack("TRACE ON")
    sim.stack.process()
    sim.recorder.clear()
    sim.scr.echobuf.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.stack.stack(cmd)
    sim.stack.process()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = " ".join(sim.scr.echobuf)
    m = _OPT_ECHO.search(text)
    if m is None or "GUARD TRIP" in text or "integrity-guard" in text:
        raise AssertionError(f"diff {cmd}: {text}")
    first, last = float(m.group(1)), float(m.group(2))
    iters_run, before, after = int(m.group(3)), int(m.group(6)), \
        int(m.group(7))
    spans = [e["dur"] / 1e6 for e in list(sim.recorder._ring)
             if e["name"] == "opt_step"]
    sim.recorder.disable()
    log(f"diff {cmd} on {DIFF_DEMO_N} aircraft: {text}")
    log(f"diff {cmd}: {wall:.2f} s wall, {len(spans)} iterations "
        f"{sum(spans):.2f} s ({min(spans):.3f}-{max(spans):.3f} s each, "
        f"median {float(np.median(spans)):.3f}; the first includes the "
        f"warm-up), the rest (hard-metric verification at 0.05 s, before "
        f"and after) {wall - sum(spans):.2f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not (iters_run == n_it and before > 0 and after == 0
            and last < first):
        raise AssertionError(
            f"diff {cmd}: {iters_run} iterations, hard LoS {before} -> "
            f"{after}, objective {first} -> {last}")


def diff_card_vs_cpu(dev):
    """Phase 12 (c): ``value_and_grad_once`` on ``conflict_scene(
    DIFF_CHECK_N)`` in float64 on the card and on the CPU, ASAS out of
    the loop and in it: equal guard words, equal non-finite gradient
    entries, and the value and the finite gradient entries within
    ``DIFF_CHECK_RTOL`` of the CPU's (relative to the largest entry)."""
    import torch
    from bluesky_tpu_torch.diff import optimize as dopt
    for with_asas in (False, True):
        res = {}
        for d in (dev, torch.device("cpu")):
            traf, acfg = dopt.conflict_scene(DIFF_CHECK_N,
                                             dtype=torch.float64, device=d)
            t0 = time.perf_counter()
            value, grads, bad = dopt.value_and_grad_once(
                traf.state, acfg, tend=DIFF_CHECK_TEND,
                with_asas=with_asas)
            g = np.concatenate([x.cpu().numpy() for x in grads])
            res[d.type] = (float(value), g, int(bad),
                           time.perf_counter() - t0)
        (vc, gc, bc, tc), (vh, gh, bh, th) = res["cuda"], res["cpu"]
        fin = np.isfinite(gh)
        scale = max(float(np.abs(gh[fin]).max(initial=0.0)), 1e-300)
        gerr = float(np.abs(gc[fin] - gh[fin]).max(initial=0.0)) / scale
        verr = abs(vc - vh) / max(abs(vh), 1e-300)
        log(f"diff card vs CPU, conflict_scene({DIFF_CHECK_N}) float64, "
            f"tend {DIFF_CHECK_TEND:g}, with_asas={with_asas}: value "
            f"{vc!r} / {vh!r} (rel err {verr:.3g}), guard word {bc} / {bh}, "
            f"gradient max err {gerr:.3g} of its max |g| {scale:.6g}, "
            f"{int((~fin).sum())} non-finite entries on the CPU; "
            f"{tc:.2f} s card, {th:.2f} s CPU")
        if bc != bh or not np.array_equal(fin, np.isfinite(gc)) \
                or verr > DIFF_CHECK_RTOL or gerr > DIFF_CHECK_RTOL:
            raise AssertionError(
                f"diff card vs CPU (with_asas={with_asas}) disagree")


def diff_full_width(dev):
    """Phase 12 (d): the rollout at the full width of the dense worlds
    shape, ``regional_scene(n_ac=2000, nmax=2048)`` in float32, tend
    50 s at simdt 1, ASAS out of the loop (chunks of 50) and in it
    (chunks of 25: about 40 saved [2048, 2048] tensors a step, so 50
    steps need about 90 GiB): the forward alone (no gradient) and
    forward+backward (``value_and_grad_once``) timed, with the peak
    memory of each, the gradient norm and the guard word."""
    import torch
    from bluesky_tpu_torch.core.step import SimConfig
    from bluesky_tpu_torch.diff import optimize as dopt
    from bluesky_tpu_torch.diff.objectives import ObjectiveWeights
    from bluesky_tpu_torch.diff.smooth import SmoothConfig
    w = DIFF_WIDE
    state, cfg0 = regional_scene(dev, n_ac=w["n_ac"], nmax=w["nmax"])
    nsteps = int(round(w["tend"] / w["simdt"]))
    for with_asas, chunk in zip((False, True), w["chunk"]):
        asas = cfg0.asas._replace(swasas=with_asas)
        cfg = SimConfig(simdt=w["simdt"], asas=asas, cd_backend="dense",
                        smooth=SmoothConfig())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            acc, _, fbad = dopt._rollout(state, cfg, nsteps, chunk,
                                         ObjectiveWeights(), 1.0, False,
                                         los_margin=1.2)
            acc = float(acc)
        fwd = time.perf_counter() - t0
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value, grads, bad = dopt.value_and_grad_once(
            state, asas, tend=w["tend"], simdt=w["simdt"], chunk=chunk,
            with_asas=with_asas)
        gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
        bad = int(bad)
        both = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"diff full width {w['n_ac']} aircraft in {w['nmax']} slots "
            f"float32, {nsteps} steps of {w['simdt']:g} s, chunk {chunk}, "
            f"with_asas={with_asas}: forward {fwd * 1e3:.1f} ms "
            f"({fwd * 1e3 / nsteps:.3f} a step, peak {fwd_peak:.3f} GiB), "
            f"forward+backward {both * 1e3:.1f} ms (ratio "
            f"{both / fwd:.3f}, peak {peak:.3f} GiB), objective {acc!r} / "
            f"{float(value)!r}, |grad| {gnorm:.6g}, guard word {bad} "
            f"(forward {int(fbad)}); card {nvidia_smi()}")
        if not (np.isfinite(acc) and np.isfinite(float(value))) \
                or int(fbad) != -1:
            raise AssertionError("diff full width: non-finite forward")


def diff_phase(dev):
    """Phase 12: the differentiable mode on the card: (a) the demo
    through OPT, (b) the same with 4 restarts on the world axis, (c) the
    gradient on the card against the CPU, (d) the rollout at full width.
    No kernel runs on this path (the dense step is plain PyTorch): the
    launch counts are set to 0 before it and must read 0 after."""
    reset_launches()
    t0 = time.perf_counter()
    diff_opt_demo(dev)
    log(f"diff (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    diff_opt_demo(dev, restarts=4)
    log(f"diff (b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    diff_card_vs_cpu(dev)
    log(f"diff (c): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    diff_full_width(dev)
    log(f"diff (d): {time.perf_counter() - t0:.1f} s")
    launched = {k: v for k, v in launch_counts().items() if v}
    if launched:
        raise AssertionError(f"diff phase launched kernels: {launched}")


#: phase 13 (e): where the snapshot of the 100k state is written (a
#: gitignored directory of the checkout; removed after the load)
KWIDE_SNAP = os.path.join("output", "chip_smoke_kwide.snap")


def snapshot_kwide(dev, n_ac=100_000, nmax=100_352, kk=KWIDER):
    """Phase 13 (e): a ``Simulation`` on the card whose ``Traffic`` has no
    [N, N] ``resopairs`` and partner tables ``kk`` wide, ``n_ac``
    aircraft of ``main_scene``'s geometry created in it, CDMETHOD SPARSE,
    ASAS ON and FF, run for 3 s; then one ``snapshot.save`` of its state
    and one ``snapshot.load`` into a second such ``Simulation``: ms of
    each and the file's bytes.  Fails unless the restored state is bit
    for bit the saved one, with the same ids and sim time, and the
    restored sim steps on."""
    import torch
    from bluesky_tpu_torch.core.state import state_to_numpy
    from bluesky_tpu_torch.simulation import snapshot
    from bluesky_tpu_torch.simulation.sim import Simulation

    def make():
        sim = Simulation(nmax=nmax, device=dev)
        sim.traf.pair_matrix = False
        sim.traf.k_partners = kk
        sim.reset()
        return sim

    sim = make()
    rng = np.random.default_rng(0)
    sim.traf.create(n_ac, "B744", rng.uniform(3000.0, 11000.0, n_ac),
                    rng.uniform(130.0, 240.0, n_ac), None,
                    rng.uniform(35.0, 60.0, n_ac),
                    rng.uniform(-10.0, 30.0, n_ac),
                    rng.uniform(0.0, 360.0, n_ac))
    sim.traf.flush()
    sim_do(sim, "CDMETHOD SPARSE", "ASAS ON", "OP", "FF")
    sim.run(until_simt=3.0)
    torch.cuda.synchronize()
    wide = wide_rows(sim.traf.state)
    os.makedirs(os.path.dirname(KWIDE_SNAP), exist_ok=True)
    t0 = time.perf_counter()
    snapshot.save(sim, KWIDE_SNAP)
    save_ms = (time.perf_counter() - t0) * 1e3
    size = os.path.getsize(KWIDE_SNAP)
    other = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok, msg = snapshot.load(other, KWIDE_SNAP)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    os.remove(KWIDE_SNAP)
    if not ok:
        raise AssertionError(f"snapshot K={kk}: {msg}")
    a, b = state_to_numpy(sim.traf.state), state_to_numpy(other.traf.state)
    same = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)
    if not (same and sim.traf.ids == other.traf.ids
            and other.simt == sim.simt
            and b["asas.partners_s"].shape[1] == kk):
        raise AssertionError(f"snapshot K={kk}: the restored state differs")
    other.op()
    other.run(until_simt=other.simt + 1.0)
    if not bool(torch.isfinite(other.traf.state.ac.lat).all()):
        raise AssertionError(f"snapshot K={kk}: the restored sim went "
                             "non-finite")
    log(f"snapshot K={kk}: {n_ac} aircraft in {nmax} slots at simt "
        f"{sim.simt:g} ({wide} rows with more than 8 partners, nconf "
        f"{int(sim.traf.state.asas.nconf_cur)}): save {save_ms:.1f} ms, "
        f"{size} bytes, load {load_ms:.1f} ms, restored state bit-equal "
        f"({len(a)} tensors), {msg}; card {nvidia_smi()}")


def kwide_phase(dev, errs, regs, scale=1):
    """Phase 13: partner tables ``KWIDE`` = 16 and ``KWIDER`` = 64 wide
    (the wide form past 32), and the MVP forms at ``KWIDE_MVP``: (a)
    every kernel form at K = 16 and 64 and the MVP forms at K = 1, 3, 32,
    33 and 128 against their plain versions on the check shapes
    (``check_width_kernels``), the MVP and Eby forms at K = 64 and the
    MVP forms at 33 and 128 on ``dense_clump``, where rows hold more than
    32 partners (``check_dense_kernels``; not Swarm: its neighbour sums
    over rows of hundreds of neighbours there miss ``compare_outputs``' rtol by
    float32 order at any K, as the g++ rehearsal of the kernels showed at
    K = 8), and the three mesh forms at K = 64 MVP
    (``check_mesh_forms``); (b) ``main_scene`` at K = 16 and 64 through
    ``sparse_path`` and ``pallas_path`` (three 20-step chunks, with the
    candidate-mode call), each kernel timed and bounded and held on
    sampled row blocks (``sampled_holds``), at K = 64 also K1-K4 at K = 33
    and 128 on the path's operands; (c)
    ``regional_scene`` 10,000 in 10,240 slots at K = 64, sparse and
    pallas under EBY, SWARM and SSD (``resolver_path``; with pallas and
    EBY the candidate call); (d) one stacked worlds group at K = 64 (16 x
    2,000 sparse MVP), each world held to its solo run; (e)
    ``snapshot_kwide`` at K = 64.  Logs each part's seconds.  Returns the
    kernels JSON entries; fails unless every K = 64 form was measured."""
    report = []
    t0 = time.perf_counter()
    for kk in (KWIDE, KWIDER):
        check_width_kernels(dev, errs, kk, scale=scale)
    for kk in KWIDE_MVP:
        check_width_kernels(dev, errs, kk, ("mvp",), scale=scale)
    for reso, kk in (("mvp", KWIDER), ("eby", KWIDER), ("mvp", 33),
                     ("mvp", 128)):
        check_dense_kernels(dev, errs, kk, reso)
    check_mesh_forms(dev, errs, "mvp", KWIDER, scale)
    log(f"kwide (a): {time.perf_counter() - t0:.1f} s")
    for kk in (KWIDE, KWIDER):
        t0 = time.perf_counter()
        more = tuple(q for q in KWIDE_MVP if q > 32) if kk == KWIDER else ()
        report += sparse_path(dev, errs, regs, {}, 100_000 // scale,
                              100_352 // scale, kk=kk, more=more)
        report += pallas_path(dev, errs, regs, 100_000 // scale,
                              100_352 // scale, kk=kk, more=more)
        log(f"kwide (b) K={kk}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for backend in ("sparse", "pallas"):
        for method in ("EBY", "SWARM", "SSD"):
            report += resolver_path(dev, errs, regs, backend, method,
                                    10_000 // scale, 10_240 // scale,
                                    kk=KWIDER, scene=regional_scene,
                                    cd_block=256, pair_matrix=False)
    log(f"kwide (c): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worlds_batched_vs_solo(dev, "sparse", (max(2, 16 // scale), 2_000, 2_048),
                           kk=KWIDER)
    log(f"kwide (d): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    snapshot_kwide(dev, 100_000 // scale, 100_352 // scale, kk=KWIDER)
    log(f"kwide (e): {time.perf_counter() - t0:.1f} s")
    missing = {kname(form_name(k, r), KWIDER) for k, r in FORMS} \
        - {e["name"] for e in report}
    if missing:
        raise AssertionError(f"K={KWIDER} forms never measured: "
                             f"{sorted(missing)}")
    return report


#: phase 14 (``shard_phase``): the mesh forms of the walker (ROADMAP B3),
#: by kernel and ``MeshForm.kind``, and the kernel forms each shard mode
#: of the 100k scene launches (K3's row subset on the pallas backend's
#: replicate split; its ``col0`` form is on no path: the JAX pallas
#: backend has no spatial mode)
MESH_FORMS = (("cd_sched._sched_kernel", "rows"),
              ("cd_sched._sched_kernel", "col0"),
              ("cd_sched._sched_kernel", "gid"),
              ("cd_pallas._kernel_resume", "rows"),
              ("cd_pallas._kernel_resume", "col0"),
              ("cd_pallas._kernel", "rows"),
              ("cd_pallas._kernel", "col0"))
SHARD_MODES = {"replicate": (("cd_sched._sched_kernel", "rows"),
                             ("cd_pallas._kernel_resume", "rows")),
               "spatial": (("cd_sched._sched_kernel", "col0"),
                           ("cd_pallas._kernel_resume", "col0")),
               "tiles": (("cd_sched._sched_kernel", "gid"),),
               "pallas replicate": (("cd_pallas._kernel", "rows"),)}
#: shards of phase 14, all on the one card
SHARDS = 4


def mesh_name(kernel, reso, kind, kk=8):
    """The JSON name of a mesh form: the kernel form's name, then
    ``/rows``, ``/col0`` or ``/gid`` (and ``/k16`` past K = 8)."""
    return kname(f"{form_name(kernel, reso)}/{kind}", kk)


def mesh_launch_counts():
    """The launch count of each MVP mesh form, by ``mesh_name``."""
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched
    wrapper = {"cd_sched._sched_kernel": (cd_sched, "cd_sched_tiles"),
               "cd_pallas._kernel_resume": (cd_pallas, "cd_full_grid_resume"),
               "cd_pallas._kernel": (cd_pallas, "cd_full_grid")}
    return {mesh_name(k, "mvp", kind): wrapper[k][0].LAUNCHES[
        cd_pallas.launch_key(wrapper[k][1], "mvp", kind)]
        for k, kind in MESH_FORMS}


def wider(pold, kk):
    """A partner table ``pold`` [nb, 8, B] as ``kk`` wide, the new slots
    empty (the same partners in a wider table)."""
    import torch
    pad = pold.new_full((pold.shape[0], kk - pold.shape[1], pold.shape[2]),
                        -1)
    return torch.cat([pold, pad], 1).contiguous()


class MeshCall:
    """One mesh-form call of a walker wrapper: ``fn`` (``sched_tiles``,
    ``full_grid_resume`` or ``full_grid``) with its positional operands
    and its keywords, the ``mesh`` among them; ``plain`` its plain
    version; ``tiles(i)`` local row i's local column blocks.  ``run``
    calls the wrapper (or with ``plain=True`` the plain version) in
    resolver form ``reso`` at partner width ``kk``."""

    def __init__(self, kernel, fn, plain, args, kw, tiles):
        self.kernel, self.fn, self.plain = kernel, fn, plain
        self.args, self.kw, self.tiles = list(args), dict(kw), tiles
        self.mesh = kw["mesh"]

    def _args(self, kk):
        if self.kernel == "cd_pallas._kernel":
            return self.args, dict(kk=kk)
        a = list(self.args)
        j = 4 if self.kernel == "cd_sched._sched_kernel" else 2
        if kk != a[j].shape[1]:
            a[j] = wider(a[j], kk)
        return a, {}

    def run(self, reso="mvp", kk=8, plain=False, **kw):
        a, extra = self._args(kk)
        if plain:
            if self.kernel == "cd_pallas._kernel":
                return self.plain(*a, reso=reso, kk=kk, mesh=self.mesh)
            return self.plain(*a, reso=reso, mesh=self.mesh)
        return self.fn(*a, reso=reso, mesh=self.mesh, **extra, **kw)

    def pold(self, kk):
        if self.kernel == "cd_pallas._kernel":
            return None
        return self._args(kk)[0][4 if self.kernel ==
                                 "cd_sched._sched_kernel" else 2]

    def intr(self):
        return self.args[0]

    def col_blocks(self):
        return self.mesh.col_blocks(self.intr().shape[0]).numpy()

    def pairs(self):
        """Active pairs over the visited tiles, self pairs excluded."""
        from bluesky_tpu_torch.ops.cd_pallas import _IDX
        m = self.mesh
        act = lambda t: (t[:, _IDX["active"], :] > 0.5).sum(1).cpu() \
            .numpy().astype(np.int64)
        ao, ai, gb = act(m.own), act(self.intr()), self.col_blocks()
        total = 0
        for i in range(m.own.shape[0]):
            js = self.tiles(i)
            g = m.row0 + i * m.rstride
            total += int(ao[i] * ai[js].sum() - ao[i] * (gb[js] == g).sum())
        return total

    def keep(self, ncnt, kk):
        """The keep predicate's pairs: the conflict pairs and the active
        old partners that lie in a visited tile (errs high, as
        ``keep_pairs``)."""
        from bluesky_tpu_torch.ops.cd_pallas import _IDX
        pold = self.pold(kk)
        if pold is None:
            return 0
        m = self.mesh
        B = m.own.shape[2]
        act_o = (m.own[:, _IDX["active"], :] > 0.5).cpu().numpy()
        q = pold.cpu().numpy()
        gb = self.col_blocks()
        lane = np.arange(B)
        total = int(ncnt.double().sum())
        for i in range(m.own.shape[0]):
            g = m.row0 + i * m.rstride
            ok = ((q[i] >= 0) & act_o[i][None, :] & (q[i] != g * B + lane)
                  & np.isin(q[i] // B, gb[self.tiles(i)]))
            total += int(ok.sum())
        return total

    def nbytes(self, reso, kk):
        """Bytes the launch must move: the slab of every block it reads
        once (the own rows and the column blocks of the visited tiles, a
        block in both counted once, by its global id), the windows or
        reach mask and the partner table read once, the outputs written
        once."""
        m = self.mesh
        nb, B = m.own.shape[0], m.own.shape[2]
        nacc = 8 + (7 if reso == "swarm" else 0)
        index = self.args[1:3] if self.kernel == "cd_sched._sched_kernel" \
            else self.args[1:2]
        gb = self.col_blocks()
        blocks = set(m.row0 + np.arange(nb) * m.rstride)
        for i in range(nb):
            blocks.update(gb[self.tiles(i)].tolist())
        slab = m.own.shape[1] * B * 4
        read = len(blocks) * slab + sum(
            t.numel() * t.element_size() for t in index)
        pold = self.pold(kk)
        if pold is None:
            return read + (nacc * nb * B + 2 * nb * kk * B) * 4
        return read + pold.numel() * 4 \
            + ((nacc + 1) * nb * B + 4 * nb * kk * B) * 4


def capture_mesh_calls(fn):
    """Run ``fn()`` with the walker wrappers' mesh-form calls recorded:
    ``{(kernel, kind): MeshCall}`` of the first call of each, and under
    ``"pallas"`` the first pallas operands of a replicate split."""
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched
    seen = {}
    orig = {"sched_tiles": (cd_sched, cd_sched.sched_tiles),
            "full_grid_resume": (cd_pallas, cd_pallas.full_grid_resume),
            "full_grid": (cd_pallas, cd_pallas.full_grid),
            "full_grid_rows": (cd_pallas, cd_pallas.full_grid_rows)}
    kernel = {"sched_tiles": "cd_sched._sched_kernel",
              "full_grid_resume": "cd_pallas._kernel_resume",
              "full_grid": "cd_pallas._kernel"}
    plain = {"sched_tiles": cd_sched.sched_tiles_plain,
             "full_grid_resume": cd_pallas.full_grid_resume_plain,
             "full_grid": cd_pallas.full_grid_plain}

    nops = {"sched_tiles": 6, "full_grid_resume": 4, "full_grid": 3}

    def wrap(name, f):
        def g(*a, **kw):
            if name == "full_grid_rows":        # the pallas operands
                seen.setdefault("pallas", a[0])
                return f(*a, **kw)
            m = kw.get("mesh")
            if m is not None and (kernel[name], m.kind) not in seen:
                ops = a[:nops[name]]
                if name == "sched_tiles":     # packed, wst, wln, wmax, ...
                    st = ops[1].cpu().numpy()
                    ln = np.minimum(ops[2].cpu().numpy(), ops[3])
                    nc = ops[0].shape[0]

                    def tiles(i, st=st, ln=ln, nc=nc):
                        t = np.concatenate(
                            [np.arange(b, b + k) for b, k in zip(st[i], ln[i])]
                            + [np.zeros(0, np.int64)])
                        return t[t < nc]
                else:                         # packed, reach, ...
                    rh = ops[1].cpu().numpy()
                    tiles = lambda i, rh=rh: np.flatnonzero(rh[i])
                seen[kernel[name], m.kind] = MeshCall(
                    kernel[name], f, plain[name], ops, dict(mesh=m), tiles)
            return f(*a, **kw)
        return g

    for name, (mod, f) in orig.items():
        setattr(mod, name, wrap(name, f))
    try:
        fn()
    finally:
        for name, (mod, f) in orig.items():
            setattr(mod, name, f)
    return seen


def check_mesh_forms(dev, errs, reso, kk, scale=1):
    """Phase 14 (a): every mesh form in resolver form ``reso`` at partner
    width ``kk`` against its plain version on the check shapes
    (``check_split``), with the TAS or CAS column of ``extra_col``: K1's
    row subset (shard 1 of ``SHARDS``: rows 1, 1 + D, ...), halo window
    (shard 1's contiguous rows against its neighbours' blocks, ``col0``)
    and gid table (the same rows against the present set of the blocks
    they reach, ranked by block id) on the continental check; K2's row
    subset and window (the shard with the most overflow rows) on the
    resumed regional clump; K3's on the continental check in Morton
    order.  The row subset is also held
    bit-equal to the same rows of the single-device launch."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cd_tiled, cr_mvp
    from bluesky_tpu_torch.ops.cd_pallas import MeshForm
    mvp = cr_mvp.MVPConfig(rpz_m=5 * NM * 1.05, hpz_m=1000 * FT * 1.05,
                           tlookahead=300.0)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, mvp, 5 * NM * 1.05)
    pp = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, mvp)
    D = SHARDS
    name = lambda k, kind: mesh_name(k, reso, kind, kk)

    def hold(k, kind, kern, plain, whole=None, rows=None):
        err, outs = check_split(name(k, kind), kern, plain)
        if whole is not None:
            for j, (a, b) in enumerate(zip(outs, whole)):
                if not torch.equal(a, b[rows]):
                    raise AssertionError(f"{name(k, kind)}: output {j} "
                                         "differs from the single-device "
                                         "launch's rows")
        errs[name(k, kind)] = max(errs.get(name(k, kind), 0.0), err)
        return err

    def window(nb, d):
        """Shard d's rows and its halo window of one shard's blocks a
        side."""
        nb_l = nb // D
        r0, c0 = d * nb_l, max(0, (d - 1) * nb_l)
        return r0, r0 + nb_l, c0, min(nb, (d + 2) * nb_l)

    # K1 on the continental check
    c = columns(16384 // scale, "continental", seed=1)
    cols, col = cd_args(c, dev), extra_col(c, reso, dev)
    n_tot = cd_sched.padded_size(len(c["lat"]), 256)
    x = cd_sched.prepare(
        *cols, 5 * NM, 1000 * FT, 300.0,
        torch.full((n_tot, kk), -1, dtype=torch.int32, device=dev),
        block=256, **reso_kw(reso, col))
    rows = torch.arange(1, x.nb, D, device=dev)
    form = MeshForm(own=x.packed[rows], row0=1, rstride=D)
    args = (x.packed, x.wst[rows], x.wln[rows], x.wmax, x.pold[rows], p)
    e = [hold("cd_sched._sched_kernel", "rows",
              lambda **kw: cd_sched.sched_tiles(*args, reso=reso, mesh=form,
                                                **kw),
              cd_sched.sched_tiles_plain(*args, reso, mesh=form),
              cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold,
                                   p, reso=reso), rows)]
    r0, r1, c0, c1 = window(x.nb, 1)
    reach_h = x.reach[r0:r1, c0:c1].contiguous()
    st, ln, _ = cd_sched.build_windows(reach_h, 6, x.wmax,
                                       pad_start=c1 - c0)
    form = MeshForm(own=x.packed[r0:r1], row0=r0, col0=c0)
    args = (x.packed[c0:c1], torch.clamp(st, 0, c1 - c0), ln, x.wmax,
            x.pold[r0:r1], p)
    e.append(hold("cd_sched._sched_kernel", "col0",
                  lambda **kw: cd_sched.sched_tiles(*args, reso=reso,
                                                    mesh=form, **kw),
                  cd_sched.sched_tiles_plain(*args, reso, mesh=form)))
    rr = x.reach[r0:r1]
    present = torch.nonzero(rr.any(0) | (torch.arange(
        x.nb, device=dev) // (r1 - r0) == 1)).reshape(-1)
    s_cap_t = max(6, -(-present.numel() // x.wmax))
    order, gid_tab, wst, wln = cd_sched._tile_windows(rr, present, x.nb,
                                                      s_cap_t, x.wmax)
    form = MeshForm(own=x.packed[r0:r1], row0=r0, gid=gid_tab)
    args = (x.packed[present[order]], wst, wln, x.wmax, x.pold[r0:r1], p)
    e.append(hold("cd_sched._sched_kernel", "gid",
                  lambda **kw: cd_sched.sched_tiles(*args, reso=reso,
                                                    mesh=form, **kw),
                  cd_sched.sched_tiles_plain(*args, reso, mesh=form)))
    # K3 on the continental check in Morton order
    perm = cd_tiled.spatial_permutation(cols[0], cols[1], cols[8]).long()
    xp = cd_pallas.prepare(*[a[perm] for a in cols], 5 * NM, 300.0,
                           block=256, **reso_kw(
                               reso, None if col is None else col[perm],
                               False))
    rows = torch.arange(1, xp.nb, D, device=dev)
    form = MeshForm(own=xp.packed[rows], row0=1, rstride=D)
    e.append(hold("cd_pallas._kernel", "rows",
                  lambda **kw: cd_pallas.full_grid(
                      xp.packed, xp.reach[rows], pp, reso=reso, kk=kk,
                      mesh=form, **kw),
                  cd_pallas.full_grid_plain(xp.packed, xp.reach[rows], pp,
                                            reso, kk, mesh=form),
                  cd_pallas.full_grid(xp.packed, xp.reach, pp, reso=reso,
                                      kk=kk), rows))
    r0, r1, c0, c1 = window(xp.nb, 1)
    form = MeshForm(own=xp.packed[r0:r1], row0=r0, col0=c0)
    reach_h = xp.reach[r0:r1, c0:c1].contiguous()
    e.append(hold("cd_pallas._kernel", "col0",
                  lambda **kw: cd_pallas.full_grid(
                      xp.packed[c0:c1], reach_h, pp, reso=reso, kk=kk,
                      mesh=form, **kw),
                  cd_pallas.full_grid_plain(xp.packed[c0:c1], reach_h, pp,
                                            reso, kk, mesh=form)))
    # K2 on the resumed regional clump
    c = columns(8192 // scale, "regional", seed=1)
    col = extra_col(c, reso, dev)
    n_tot = cd_sched.padded_size(len(c["lat"]), 256)
    table = torch.full((n_tot, kk), -1, dtype=torch.int32, device=dev)
    perm = None
    for t_ahead in (0.0, 20.0):
        x = cd_sched.prepare(*cd_args(c, dev, t_ahead), 5 * NM, 1000 * FT,
                             300.0, table, block=256, s_cap=2, perm=perm,
                             **reso_kw(reso, col))
        perm = x.perm
        if not t_ahead:
            table = cd_sched.run_kernels(x, p)[11].transpose(1, 2) \
                .reshape(n_tot, kk).contiguous()
    reach_f = x.reach & x.overflow[:, None]
    rows = torch.arange(1, x.nb, D, device=dev)
    form = MeshForm(own=x.packed[rows], row0=1, rstride=D)
    e.append(hold("cd_pallas._kernel_resume", "rows",
                  lambda **kw: cd_pallas.full_grid_resume(
                      x.packed, reach_f[rows], x.pold[rows], p, reso=reso,
                      mesh=form, **kw),
                  cd_pallas.full_grid_resume_plain(
                      x.packed, reach_f[rows], x.pold[rows], p, reso,
                      mesh=form),
                  cd_pallas.full_grid_resume(x.packed, reach_f, x.pold, p,
                                             reso=reso), rows))
    # the shard with the most overflow rows
    d = int(x.overflow[:x.nb // D * D].reshape(D, -1).sum(1).argmax())
    r0, r1, c0, c1 = window(x.nb, d)
    form = MeshForm(own=x.packed[r0:r1], row0=r0, col0=c0)
    args = (x.packed[c0:c1], reach_f[r0:r1, c0:c1].contiguous(),
            x.pold[r0:r1], p)
    e.append(hold("cd_pallas._kernel_resume", "col0",
                  lambda **kw: cd_pallas.full_grid_resume(
                      *args, reso=reso, mesh=form, **kw),
                  cd_pallas.full_grid_resume_plain(*args, reso, mesh=form)))
    log(f"check mesh forms K={kk} {reso}: max abs err K1 rows/col0/gid "
        f"{e[0]:.3g}/{e[1]:.3g}/{e[2]:.3g}, K3 rows/col0 {e[3]:.3g}/"
        f"{e[4]:.3g} (continental), K2 rows/col0 {e[5]:.3g}/{e[6]:.3g} "
        f"(regional t+20s, {int(x.overflow.sum())} overflow rows, "
        f"{int(reach_f[r0:r1, c0:c1].sum())} window tiles): match")


def shard_scene(dev, mode, n_ac=100_000, nmax=200_000):
    """The 100k continental scene in a ``Simulation`` on ``dev``
    (``main_scene``'s geometry, ``nmax`` = 2 x ``n_ac`` as JAX's bench
    sizes the spatial and tiles runs), CDMETHOD SPARSE (PALLAS for
    ``"pallas replicate"``), then ``set_shard`` of ``mode`` with
    ``devices=[dev] * SHARDS`` (TILE 2x2).  Returns the sim."""
    import torch
    from bluesky_tpu_torch.simulation.sim import Simulation
    rng = np.random.default_rng(0)
    sim = Simulation(nmax=nmax, device=dev, pair_matrix=False)
    sim_do(sim, "CDMETHOD PALLAS" if mode == "pallas replicate"
           else "CDMETHOD SPARSE", "ASAS ON")
    lat = rng.uniform(35.0, 60.0, n_ac)
    lon = rng.uniform(-10.0, 30.0, n_ac)
    hdg = rng.uniform(0.0, 360.0, n_ac)
    alt = rng.uniform(3000.0, 11000.0, n_ac)
    spd = rng.uniform(130.0, 240.0, n_ac)
    sim.traf.create(n_ac, "B744", alt, spd, None, lat, lon, hdg)
    sim.traf.flush()
    t0 = time.perf_counter()
    sim.set_shard(mode.split()[-1], SHARDS, devices=[dev] * SHARDS,
                  tiles=(2, 2) if mode == "tiles" else None)
    torch.cuda.synchronize()
    log(f"shard {mode}: set_shard in {time.perf_counter() - t0:.2f} s, "
        f"stats {sim.shard_stats}")
    return sim


def shard_mode_run(dev, mode, n_ac=100_000, nmax=200_000):
    """Phase 14 (b) for one mode: ``shard_scene``, then 3 s of sim time
    through ``Simulation.run`` (FF) with the launch counts set to 0 just
    before and read just after (every form of ``SHARD_MODES[mode]``
    launched, or the run fails); then from a copy of the run's state 60
    steps (3 ASAS intervals) of ``run_steps`` on the mesh and 60 on the
    single-device reference of the mode (the same config without the
    mesh), every state tensor bit-equal; the ASAS interval ms of both,
    the chunk rate and the peak memory.  Returns ``(launches, calls)``:
    the mesh-form launches of the run and the first mesh-form call of
    each kind (``capture_mesh_calls``), the main path's shapes."""
    import torch
    from bluesky_tpu_torch.core import asas, graph, step as stepmod
    graph.clear()
    torch.cuda.reset_peak_memory_stats()
    sim = shard_scene(dev, mode, n_ac, nmax)
    reset_launches()
    sim_do(sim, "OP", "FF")
    t0 = time.perf_counter()
    calls = capture_mesh_calls(lambda: sim.run(until_simt=3.0))
    sim.drain_pipeline()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mesh_launch_counts()
    for k, kind in SHARD_MODES[mode]:
        if launches[mesh_name(k, "mvp", kind)] < 1:
            raise AssertionError(f"shard {mode}: Simulation.run never "
                                 f"launched {mesh_name(k, 'mvp', kind)}")
    check_sim_state(f"shard {mode}", sim)
    log(f"shard {mode}: Simulation.run to simt {sim.simt:.2f} in "
        f"{wall:.2f} s ({SHARDS} shards on {dev}), nconf "
        f"{int(sim.traf.state.asas.nconf_cur)}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    cfg = sim.cfg
    ref_cfg = cfg._replace(cd_mesh=None)
    s0 = state_copy(sim.traf.state)
    mesh_out = stepmod.run_steps(state_copy(s0), cfg, 3 * CHUNK)
    mesh_out = state_copy(mesh_out)
    ref_out = stepmod.run_steps(state_copy(s0), ref_cfg, 3 * CHUNK)
    assert_same(f"shard {mode}: mesh against the single-device reference",
                mesh_out, ref_out)
    log(f"shard {mode}: 60 steps on the mesh bit-equal to the "
        f"single-device reference (nconf {int(ref_out.asas.nconf_cur)}, "
        f"engaged {int(ref_out.asas.active.sum())})")
    impl = asas.impl_for_backend(cfg.cd_backend)
    interval = lambda c: asas.update_tiled(
        mesh_out, c.asas, block=c.cd_block, impl=impl, mesh=c.cd_mesh,
        mesh_axis=c.cd_mesh_axis, shard_mode=c.cd_shard_mode,
        halo_blocks=c.cd_halo_blocks, tile_shape=c.cd_tile_shape or None,
        tile_budgets=c.cd_tile_budgets)
    time_layers(f"shard {mode}", {
        "ASAS interval on the mesh": lambda: interval(cfg),
        "ASAS interval, single-device reference":
            lambda: interval(ref_cfg)})
    state, chunk_ms = mesh_out, []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = stepmod.run_steps(state, cfg, CHUNK)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"shard {mode}: 20-step chunk ms {[round(m, 3) for m in chunk_ms]}"
        f", aircraft-steps/s "
        f"{[f'{n_ac * CHUNK / (m / 1e3):.4g}' for m in chunk_ms]}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
        f"{nvidia_smi()}")
    del sim, state, mesh_out, ref_out, s0
    graph.clear()
    return launches, calls


def mesh_runs(calls, launches):
    """``report_kernels`` runs of every mesh form at the main path's
    shapes: each captured call (``capture_mesh_calls``) in MVP, Eby and
    Swarm at K = 8 and MVP at K = 16 (the Eby and Swarm forms and K = 16
    on the MVP path's operands, the partner table widened by empty
    slots), the launches those of the MVP path."""
    runs = {}
    for (k, kind), call in calls.items():
        for reso, kk in (("mvp", 8), ("eby", 8), ("swarm", 8), ("mvp", 16)):
            nm = mesh_name(k, reso, kind, kk)
            outs = call.run(reso, kk)
            nfix = 13 if call.pold(kk) is not None else 10
            launches.setdefault(nm, 0)
            mesh = call.mesh
            runs[nm] = dict(
                kern=lambda c=call, r=reso, q=kk, **kw: c.run(r, q, **kw),
                plain=lambda c=call, r=reso, q=kk: c.run(r, q, plain=True),
                pairs=call.pairs(), keep=call.keep(outs[6], kk),
                bytes=call.nbytes(reso, kk),
                tiles=int(sum(len(call.tiles(i))
                              for i in range(mesh.own.shape[0]))),
                kk=kk, reso=reso,
                walker=form_name(k, reso) + walker_width(kk) + "/mesh",
                extra=dict(mesh_form=kind, rows=int(mesh.own.shape[0]),
                           cols=int(call.intr().shape[0]),
                           rstride=int(mesh.rstride)),
                **form_work(reso, outs, nfix))
    return runs


def shard_phase(dev, errs, regs, scale=1):
    """Phase 14: the shard modes (ROADMAP A9 step 1, B3) on ``SHARDS``
    shards of the one card.  (a) ``check_mesh_forms`` in MVP, Eby and
    Swarm at K = 8 and MVP at K = 16; (b) ``shard_mode_run`` for SHARD
    REPLICATE, SPATIAL and TILE 2x2 on the 100k continental sparse scene,
    and the pallas backend's replicate split; every mesh form then timed,
    bounded and held to its plain version at the main path's shapes.
    Returns the kernels JSON entries of the mesh forms; fails unless
    every form was measured."""
    from bluesky_tpu_torch.ops import cd_pallas
    t0 = time.perf_counter()
    for reso in RESOS:
        check_mesh_forms(dev, errs, reso, 8, scale)
    check_mesh_forms(dev, errs, "mvp", KWIDE, scale)
    log(f"shard (a): {time.perf_counter() - t0:.1f} s")
    launches, calls = {}, {}
    for mode in SHARD_MODES:
        t0 = time.perf_counter()
        n, c = shard_mode_run(dev, mode, 100_000 // scale, 200_000 // scale)
        launches.update({k: v for k, v in n.items() if v})
        calls.update({k: v for k, v in c.items() if k not in calls})
        log(f"shard (b) {mode}: {time.perf_counter() - t0:.1f} s")
        log_card(f"after shard {mode}")
    for k, kind in MESH_FORMS:
        launches.setdefault(mesh_name(k, "mvp", kind), 0)
    # K3's halo window is on no path: its call on the pallas replicate
    # path's operands (shard 1's contiguous rows against its neighbours'
    # blocks)
    x = calls.pop("pallas")
    p = calls[("cd_pallas._kernel", "rows")].args[2]
    nb_l = x.nb // SHARDS
    r0, r1, c0, c1 = nb_l, 2 * nb_l, 0, min(x.nb, 3 * nb_l)
    reach = x.reach[r0:r1, c0:c1].contiguous()
    calls[("cd_pallas._kernel", "col0")] = MeshCall(
        "cd_pallas._kernel", cd_pallas.full_grid, cd_pallas.full_grid_plain,
        (x.packed[c0:c1], reach, p),
        dict(mesh=cd_pallas.MeshForm(own=x.packed[r0:r1], row0=r0,
                                     col0=c0)),
        lambda i, rh=reach.cpu().numpy(): np.flatnonzero(rh[i]))
    t0 = time.perf_counter()
    report = report_kernels(mesh_runs(calls, launches), launches, errs, regs)
    log(f"shard (c) timings: {time.perf_counter() - t0:.1f} s")
    missing = {mesh_name(k, r, kind, kk) for k, kind in MESH_FORMS
               for r, kk in (("mvp", 8), ("eby", 8), ("swarm", 8),
                             ("mvp", KWIDE))} - {e["name"] for e in report}
    if missing:
        raise AssertionError(f"mesh forms never measured: {sorted(missing)}")
    return report


# ------------------------------------------------------------ entry phase
ENTRY_N = 1000          # under DetachedSimNode()'s default 1024 slots
ENTRY_SESSION = ("CDMETHOD SPARSE", "ASAS ON") + SIM_VIEW + ("SEED 1",)
ENTRY_CHUNKS, ENTRY_PALLAS_CHUNKS = 6, 3


def entry_cli(dev):
    """Phase 15 (a): ``python -m bluesky_tpu_torch --detached --scenfile``
    in-process, with no config file: the run reaches QUIT with exit 0 on
    ``dev``, its SNAPSHOT holds ``ENTRY_N`` aircraft at simt 30, K1 ran
    and the telnet bridge's thread is gone."""
    import threading
    from bluesky_tpu_torch import __main__ as tmain
    from bluesky_tpu_torch.core import graph
    from bluesky_tpu_torch.simulation import simnode, snapshot
    graph.clear()
    d = os.path.join("output", "chip_smoke_entry")
    os.makedirs(d, exist_ok=True)
    snap, scn = os.path.join(d, "end.snap"), os.path.join(d, "entry.scn")
    if os.path.exists(snap):
        os.remove(snap)
    with open(scn, "w") as f:
        # OP before FF: a sim in INIT starts (OP) when its first
        # aircraft appear, and OP ends fast-time
        for line in ENTRY_SESSION + (f"MCRE {ENTRY_N} B744", "OP", "FF"):
            f.write(f"00:00:00.00>{line}\n")
        f.write(f"00:00:30.00>SNAPSHOT SAVE {snap}\n00:00:30.00>QUIT\n")
    made = []

    class Recorded(simnode.DetachedSimNode):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    threads0 = set(threading.enumerate())
    reset_launches()
    orig, simnode.DetachedSimNode = simnode.DetachedSimNode, Recorded
    t0 = time.perf_counter()
    try:
        rc = tmain.main(["--detached", "--scenfile", scn])
    finally:
        simnode.DetachedSimNode = orig
    wall = time.perf_counter() - t0
    launches = launch_counts()
    (node,) = made
    blob, err = snapshot.read_blob(snap)
    if rc != 0 or err is not None:
        raise AssertionError(f"entry --detached: rc {rc}, snapshot {err}")
    ntraf = sum(1 for i in blob["ids"] if i)
    simt = snapshot.blob_simt(blob)
    dev_of = node.sim.traf.state.device.type
    left = [t.name for t in set(threading.enumerate()) - threads0]
    log(f"entry --detached: rc {rc} in {wall:.2f} s, state on {dev_of}, "
        f"snapshot ntraf {ntraf} simt {simt:g}, sim state "
        f"{node.sim.state_flag}, K1 launches "
        f"{launches['cd_sched._sched_kernel']}, threads left {left}")
    # the trigger fires at the first step edge at or past 30 s of the
    # float32 clock: within one step of it
    if ntraf != ENTRY_N or not 30.0 - 1e-4 <= simt <= 30.05 + 1e-4:
        raise AssertionError(f"entry --detached: snapshot ntraf {ntraf} "
                             f"simt {simt}")
    if dev_of != dev.type:
        raise AssertionError(f"entry --detached ran on {dev_of}")
    if launches["cd_sched._sched_kernel"] < 1:
        raise AssertionError("entry --detached never launched K1")
    if left:
        raise AssertionError(f"entry --detached left threads {left}")
    del node, made
    gc.collect()
    graph.clear()


def frame_bytes(data):
    """Payload bytes of a stream frame: its arrays' bytes and its
    strings' characters (the wire adds msgpack's few bytes a field)."""
    n = 0
    for v in data.values():
        if isinstance(v, np.ndarray):
            n += v.nbytes
        elif isinstance(v, list):
            n += sum(len(x) if isinstance(x, str) else 8 for x in v)
        else:
            n += 8
    return n


def entry_session(sim_like, step):
    """Type the continental session into ``sim_like`` (a node's
    STACKCMD events or a Simulation's stack), step ``ENTRY_CHUNKS``
    fast-time chunks, switch to CDMETHOD PALLAS, step
    ``ENTRY_PALLAS_CHUNKS`` more.  ``step`` runs one chunk and returns
    its row of numbers."""
    for line in ENTRY_SESSION + (f"MCRE {SIM_N} B744", "OP", "FF"):
        sim_like(line)
    rows = [step() for _ in range(ENTRY_CHUNKS)]
    sim_like("CDMETHOD PALLAS")
    rows += [step() for _ in range(ENTRY_PALLAS_CHUNKS)]
    return rows


def entry_node(dev):
    """Phase 15 (b): the 100k continental session in a
    ``DetachedSimNode``, ScreenIO streaming; then the same commands in
    an embedded ``Simulation``, held bit for bit.  Returns the node
    session's kernel launches."""
    import torch
    from bluesky_tpu_torch.core import graph
    from bluesky_tpu_torch.simulation.sim import Simulation
    from bluesky_tpu_torch.simulation.simnode import DetachedSimNode
    graph.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    node = DetachedSimNode(nmax=SIM_NMAX)
    if node.sim.traf.device.type != dev.type:
        raise AssertionError(f"DetachedSimNode() runs on "
                             f"{node.sim.traf.device}")
    reset_launches()

    def node_step():
        t1 = time.perf_counter()
        s0 = node.sim.simt_planned
        node.step()
        wall = (time.perf_counter() - t1) * 1e3
        frames = [(n, d) for n, d in node.streams]
        node.streams.clear()
        return dict(wall_ms=wall, sim_s=node.sim.simt_planned - s0,
                    frames=[n.decode() for n, _ in frames],
                    buffered=sum(frame_bytes(d) for _, d in frames))
    rows = entry_session(
        lambda line: node.event(b"STACKCMD", {"cmd": line}, []), node_step)
    node.sim.drain_pipeline()
    torch.cuda.synchronize()
    launches = launch_counts()
    wall = time.perf_counter() - t0
    check_sim_state("entry node pallas", node.sim)
    for tag, part in (("sparse", rows[1:ENTRY_CHUNKS]),
                      ("pallas", rows[ENTRY_CHUNKS + 1:])):
        ms = sum(r["wall_ms"] for r in part)
        steps = sum(r["sim_s"] for r in part) / 0.05
        log(f"entry node {tag} MVP: {len(part)} chunks after the first, "
            f"{ms / (steps / CHUNK):.4g} ms per {CHUNK} steps with "
            f"ScreenIO ({SIM_N * steps / (ms / 1e3):.4g} aircraft-steps/s"
            f"); phase 10 embedded pipelined "
            f"{SIM_RATES.get('sparse pipelined ms per 20 steps', float('nan')):.4g}"
            f" ms per {CHUNK} steps")
    log(f"entry node: per chunk wall ms "
        f"{[round(r['wall_ms'], 1) for r in rows]}, sim s "
        f"{[round(r['sim_s'], 2) for r in rows]}, frames "
        f"{[r['frames'] for r in rows]}, stream bytes buffered a chunk "
        f"{[r['buffered'] for r in rows]}")
    # ACDATA at full width: from the retired edge, then the live state
    scr = node.sim.scr
    for source in ("edge", "live"):
        ms = []
        for _ in range(3):
            if source == "live":
                node.sim._last_edge = None
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            scr.send_aircraft_data()
            ms.append((time.perf_counter() - t1) * 1e3)
            (name, data), = node.streams
            node.streams.clear()
        log(f"entry node: ACDATA frame from the {source} "
            f"{[round(m, 3) for m in ms]} ms, {frame_bytes(data)} payload "
            f"bytes, {len(data['id'])} aircraft, nconf {data['nconf_cur']}")
    log(f"entry node: {wall:.1f} s, launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for form in ("cd_sched._sched_kernel", "cd_pallas._kernel_resume",
                 "cd_pallas._kernel"):
        if launches[form] < 1:
            raise AssertionError(f"the entry node never launched {form}")
    # the embedded Simulation on the same commands
    node_state = state_copy(node.sim.traf.state)
    node_simt = node.sim.simt
    del node, scr
    gc.collect()                # the node and its sim refer to each other
    graph.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sim = Simulation(nmax=SIM_NMAX, device=dev)
    entry_session(sim.stack.stack, lambda: sim.step())
    sim.drain_pipeline()
    torch.cuda.synchronize()
    if sim.simt != node_simt:
        raise AssertionError(f"entry: node simt {node_simt} != embedded "
                             f"{sim.simt}")
    assert_same("entry node against the embedded Simulation", node_state,
                sim.traf.state)
    log(f"entry node: bit-equal to the embedded Simulation at simt "
        f"{sim.simt:g} ({time.perf_counter() - t0:.1f} s)")
    del sim, node_state
    gc.collect()
    graph.clear()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------- fabric phase
#: phase 16: the BATCH pieces' regional view (4 x 4 deg around 52.6 N
#: 5.4 E), their fleet (under the spawned worker's default 1,024 slots,
#: the JAX package's ``Simulation()`` default: no setting sizes a
#: spawned worker), the sim time of their snapshot, the WORLDS pack's
#: pieces and fleet, and the ACDATA frames timed on the wire
FABRIC_VIEW = ("PAN 52.6 5.4", "ZOOM 0.5")
FABRIC_N, FABRIC_T = 1000, 60.0
FABRIC_METHODS = ("SPARSE", "SPARSE", "PALLAS", "SPARSE")
FABRIC_PACK, FABRIC_PACK_N = 8, 500
FABRIC_FRAMES = 3
FABRIC_DIR = os.path.join("output", "chip_smoke_fabric")
#: a worker's last log line (``__main__._log_launches``)
_WORKER_LAUNCHES = re.compile(
    r"bluesky_tpu_torch worker ([0-9a-f]+): kernel launches (\{[^{}]*\})")


def free_ports(n):
    """``n`` free localhost TCP ports."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def fabric_piece(k, n_ac, method, snap, tsnap):
    """BATCH piece ``k``: ASAS ON, CDMETHOD ``method``, the regional
    view, SEED k, MCRE ``n_ac`` B744, OP, FF; at ``tsnap`` SNAPSHOT SAVE
    ``snap`` and HOLD (the HOLD completes the piece)."""
    lines = [f"SCEN P{k}", "ASAS ON", f"CDMETHOD {method}", *FABRIC_VIEW,
             f"SEED {k}", f"MCRE {n_ac} B744", "OP", "FF",
             f"SNAPSHOT SAVE {snap}", "HOLD"]
    return [0.0] * (len(lines) - 2) + [tsnap, tsnap], lines


def write_scenario(path, pieces):
    with open(path, "w") as f:
        for times, lines in pieces:
            for t, line in zip(times, lines):
                f.write(f"{int(t) // 3600:02d}:{int(t) // 60 % 60:02d}:"
                        f"{t % 60:05.2f}>{line}\n")


def fabric_embedded(dev, piece, snap):
    """``piece`` in an embedded ``Simulation`` as a worker runs a BATCH
    piece (reset, the scenario, OP, steps until it leaves OP), its
    snapshot to ``snap``; returns the wall seconds from OP to HOLD."""
    import torch
    from bluesky_tpu_torch.simulation.sim import OP, Simulation
    times, lines = piece
    lines = [f"SNAPSHOT SAVE {snap}" if ln.startswith("SNAPSHOT SAVE")
             else ln for ln in lines]
    sim = Simulation(nmax=1024, device=dev)
    sim.reset()
    sim.stack.set_scendata(list(times), lines)
    sim.op()
    t0 = time.perf_counter()
    for _ in range(10 ** 6):
        if sim.state_flag != OP:
            break
        sim.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def same_snapshot(tag, path_a, path_b):
    """The two snapshot files hold the same fleet: every state array bit
    for bit, the ids, types, routes and conditions equal."""
    from bluesky_tpu_torch.simulation import snapshot
    (a, ea), (b, eb) = snapshot.read_blob(path_a), snapshot.read_blob(path_b)
    if ea or eb:
        raise AssertionError(f"{tag}: snapshot {ea or eb}")
    sa, sb = a["state"], b["state"]
    bad = [k for k in sa if k not in sb or sa[k].dtype != sb[k].dtype
           or sa[k].shape != sb[k].shape
           or sa[k].tobytes() != sb[k].tobytes()]
    bad += [k for k in ("ids", "types", "routes", "autoid") if a[k] != b[k]]
    if bad or sa.keys() != sb.keys():
        raise AssertionError(f"{tag}: the worker's snapshot differs from "
                             f"the embedded run's in {bad[:8]}")
    return snapshot.blob_simt(a), sum(1 for i in a["ids"] if i)


class FabricServer:
    """``python -m bluesky_tpu_torch --headless --config-file cfg`` in its
    own process group, on free ports, its journal and log under
    ``FABRIC_DIR/tag``, with the port's ``Client`` connected."""

    def __init__(self, tag, dev, **keys):
        from bluesky_tpu_torch.network.client import Client
        self.dir = os.path.abspath(os.path.join(FABRIC_DIR, tag))
        os.makedirs(self.dir, exist_ok=True)
        ev, st, wev, wst, disc = free_ports(5)
        self.ports = dict(event=ev, stream=st, wevent=wev, wstream=wst)
        keys = dict(event_port=ev, stream_port=st, wevent_port=wev,
                    wstream_port=wst, discovery_port=disc, telnet_port=0,
                    log_path=self.dir, **keys)
        if dev.type == "cpu":
            keys["device"] = "cpu"      # a CPU rehearsal of the phase
        self.cfg = os.path.join(self.dir, "fabric.cfg")
        with open(self.cfg, "w") as f:
            f.writelines(f"{k} = {v!r}\n" for k, v in keys.items())
        self.log = os.path.join(self.dir, "server.log")
        self.t0 = time.perf_counter()
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "bluesky_tpu_torch", "--headless",
                 "--config-file", self.cfg], stdout=out,
                stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                env=dict(os.environ, PYTHONUNBUFFERED="1"),
                start_new_session=True)
        self.client = Client()
        self.client.connect(event_port=ev, stream_port=st, timeout=60.0)
        self.records = []               # (first seen, record)

    def text(self):
        with open(self.log) as f:
            return f.read()

    def journal(self):
        names = [n for n in os.listdir(self.dir) if n.endswith(".jsonl")]
        return os.path.join(self.dir, names[0]) if names else None

    def poll(self):
        """Pump the client; stamp the journal records new since the last
        poll; fail if the server died."""
        self.client.receive(10)
        if self.proc.poll() is not None:
            raise AssertionError(f"fabric server exited "
                                 f"{self.proc.returncode}:\n{self.text()}")
        path = self.journal()
        if path is None:
            return
        now = time.perf_counter()
        with open(path) as f:
            lines = f.read().splitlines()
        for line in lines[len(self.records):]:
            try:
                self.records.append((now, json.loads(line)))
            except json.JSONDecodeError:
                break                   # a line still being written

    def wait(self, cond, what, timeout):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            self.poll()
            if cond():
                return time.perf_counter()
            time.sleep(0.01)
        raise AssertionError(f"fabric: {what} not within {timeout} s:\n"
                             f"{self.text()[-4000:]}")

    def piece_times(self):
        """{piece key: (dispatched, completed) first-seen stamps}."""
        out = {}
        for t, r in self.records:
            if r.get("rec") in ("dispatched", "completed"):
                out.setdefault(r["key"], {}).setdefault(r["rec"], t)
        return {k: (v.get("dispatched"), v.get("completed"))
                for k, v in out.items()}

    def health(self):
        self.client.last_health = None
        self.client.request_health()
        self.wait(lambda: self.client.last_health is not None, "HEALTH", 30)
        return self.client.last_health

    def stop(self):
        """SIGTERM: exit 0, the clean-exit marker last in the journal, no
        process of its group alive.  Returns each worker's kernel
        launches from its last log line."""
        import signal
        self.client.close()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            raise AssertionError("fabric server ignored SIGTERM")
        left = True
        for _ in range(100):
            try:
                os.killpg(self.proc.pid, 0)
            except ProcessLookupError:
                left = False
                break
            time.sleep(0.1)
        if left:
            os.killpg(self.proc.pid, signal.SIGKILL)
        with open(self.journal()) as f:
            last = json.loads(f.read().splitlines()[-1])
        text = self.text()
        launches = {wid: json.loads(blob) for wid, blob in
                    _WORKER_LAUNCHES.findall(text)}
        log(f"fabric server {os.path.basename(self.dir)}: SIGTERM -> exit "
            f"{rc}, last journal record {last.get('rec')!r}, processes of "
            f"its group left: {left}; worker launches {launches}")
        if rc != 0 or last.get("rec") != "shutdown" or left:
            raise AssertionError(f"fabric server shutdown:\n{text[-4000:]}")
        return launches


def compute_apps():
    """``nvidia-smi --query-compute-apps=pid,used_memory`` lines."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()] \
        or [f"(none listed; rc {out.returncode} {out.stderr.strip()})"]


def fabric_launches(per_worker, suffix=""):
    """The workers' launches summed by kernels-line name (+ ``suffix``)."""
    names, out = launch_keys(), {}
    for counts in per_worker.values():
        for key, n in counts.items():
            name = names[key] + suffix
            out[name] = out.get(name, 0) + n
    return out


def fabric_batch(dev, n_ac=FABRIC_N, tsnap=FABRIC_T):
    """Phase 16 (a): the port's server (``--headless``, no ``device``
    key: CUDA) with ``max_nnodes = 2`` spawns two workers; a 4-piece
    BATCH (three SPARSE, one PALLAS) completes each piece exactly once;
    each piece's snapshot bit-equal to an embedded ``Simulation`` on the
    same lines; the workers' K1, K2 and K3 launches from their logs."""
    from bluesky_tpu_torch.network.journal import BatchJournal
    d = os.path.abspath(os.path.join(FABRIC_DIR, "batch"))
    pieces = [fabric_piece(k, n_ac, m, os.path.join(d, f"piece_{k}.snap"),
                           tsnap) for k, m in enumerate(FABRIC_METHODS)]
    srv = FabricServer("batch", dev, max_nnodes=2)
    try:
        t_reg1 = srv.wait(lambda: len(srv.client.nodes) == 1,
                          "the first worker's REGISTER", 180)
        # the second worker before the BATCH, so that both take pieces
        # (a 1,000-aircraft piece takes less than a worker's start)
        t_add = time.perf_counter()
        srv.client.send_event(b"ADDNODES", 1, target=b"")
        t_reg2 = srv.wait(lambda: len(srv.client.nodes) == 2,
                          "the second worker's REGISTER", 180)
        scn = os.path.join(d, "batch.scn")
        write_scenario(scn, pieces)
        srv.client.stack(f"BATCH {scn}")
        apps = compute_apps() if dev.type == "cuda" else []
        srv.wait(lambda: sum(1 for _, r in srv.records
                             if r.get("rec") == "completed") >= len(pieces),
                 "the BATCH", 600)
        apps_end = compute_apps() if dev.type == "cuda" else []
        times = srv.piece_times()
        recs = [r for _, r in srv.records]
    finally:
        launches = srv.stop()
    log(f"fabric batch: spawn -> REGISTER {t_reg1 - srv.t0:.2f} s for the "
        f"first worker (from the server's start), {t_reg2 - t_add:.2f} s "
        f"for the second (from ADDNODES); device memory per process "
        f"{apps} (both workers up), {apps_end} (after the batch)")
    keys = [BatchJournal.piece_key(p) for p in pieces]
    done = [r["key"] for r in recs if r.get("rec") == "completed"]
    crashed = [r for r in recs if r.get("rec") in ("crashed", "quarantined")]
    if sorted(done) != sorted(keys) or crashed or len(launches) != 2 \
            or len({r["worker"] for r in recs
                    if r.get("rec") == "completed"}) != 2:
        raise AssertionError(f"fabric batch: completed {done}, pieces "
                             f"{keys}, crashed {crashed}, workers "
                             f"{list(launches)}")
    for k, (piece, key) in enumerate(zip(pieces, keys)):
        t_disp, t_done = times[key]
        snap = os.path.join(d, f"embedded_{k}.snap")
        wall = fabric_embedded(dev, piece, snap)
        simt, ntraf = same_snapshot(f"fabric piece {k}", piece[1][-2]
                                    .split(" ", 2)[2], snap)
        log(f"fabric piece {k} ({FABRIC_METHODS[k]}): {ntraf} aircraft, "
            f"snapshot at simt {simt:g} bit-equal to the embedded run; "
            f"worker {tsnap / (t_done - t_disp):.4g} sim-s per wall-s "
            f"(dispatch to completion, {t_done - t_disp:.2f} s: the "
            f"scenario lines, graph captures and the journal included), "
            f"embedded {tsnap / wall:.4g} ({wall:.2f} s from OP)")
    got = fabric_launches(launches)
    if dev.type == "cuda":
        for form in ("cd_sched._sched_kernel", "cd_pallas._kernel_resume",
                     "cd_pallas._kernel"):
            if not got.get(form):
                raise AssertionError(f"fabric batch: the workers never "
                                     f"launched {form}: {launches}")
    return got


def fabric_worlds_wire(dev, pack=FABRIC_PACK, n_ac=FABRIC_PACK_N,
                       tsnap=FABRIC_T, wire_n=None, wire_nmax=None):
    """Phase 16 (b) and (c).  (b) a server with ``world_pack = True``,
    ``world_batch_max = 8`` and ``max_nnodes = 1``: ``pack`` SPARSE
    pieces of ``n_ac`` in one WORLDS pack on its one worker, one pack
    dispatch, each piece completed once and bit-equal to its solo
    embedded run.  (c) a 100k continental ``SimNode`` of this process on
    the same server's worker ports, ACDATA through the broker to a raw
    SUB socket for ``FABRIC_FRAMES`` fast-time chunks: ms from publish
    to receipt and bytes of each frame.  Returns the pack worker's
    launches by ``/worlds`` name."""
    import threading
    import torch
    import zmq
    from bluesky_tpu_torch.core import graph
    from bluesky_tpu_torch.network.journal import BatchJournal
    from bluesky_tpu_torch.network.npcodec import packb, unpackb
    from bluesky_tpu_torch.simulation.simnode import SimNode
    wire_n = SIM_N if wire_n is None else wire_n
    wire_nmax = SIM_NMAX if wire_nmax is None else wire_nmax
    d = os.path.abspath(os.path.join(FABRIC_DIR, "worlds"))
    pieces = [fabric_piece(100 + k, n_ac, "SPARSE",
                           os.path.join(d, f"piece_{k}.snap"), tsnap)
              for k in range(pack)]
    srv = FabricServer("worlds", dev, max_nnodes=1, world_pack=True,
                       world_batch_max=8)
    node = thread = sub = None
    try:
        t_reg = srv.wait(lambda: len(srv.client.nodes) == 1,
                         "the worker's REGISTER", 180)
        (worker,) = list(srv.client.nodes)
        scn = os.path.join(d, "worlds.scn")
        write_scenario(scn, pieces)
        srv.client.stack(f"BATCH {scn}")
        srv.wait(lambda: sum(1 for _, r in srv.records
                             if r.get("rec") == "completed") >= pack,
                 "the WORLDS pack", 600)
        apps = compute_apps() if dev.type == "cuda" else []
        h = srv.health()
        times = srv.piece_times()
        recs = [r for _, r in srv.records]
        disp = [r for r in recs if r.get("rec") == "dispatched"]
        log(f"fabric worlds: spawn -> REGISTER {t_reg - srv.t0:.2f} s; "
            f"HEALTH worlds {h['worlds']}; dispatched records "
            f"{[(r.get('world'), r.get('pack')) for r in disp]}; device "
            f"memory per process {apps}")
        keys = [BatchJournal.piece_key(p) for p in pieces]
        done = [r["key"] for r in recs if r.get("rec") == "completed"]
        if h["worlds"]["world_batches"] != 1 \
                or h["worlds"]["packed_pieces"] != pack \
                or sorted(done) != sorted(keys) \
                or sorted(r.get("world") for r in disp) != list(range(pack)) \
                or {r["worker"] for r in disp} != {worker.hex()}:
            raise AssertionError(f"fabric worlds: not one pack of {pack} "
                                 f"completed once: {recs}")
        t0 = min(t for t, _ in times.values())
        t1 = max(t for _, t in times.values())
        walls = []
        for k, piece in enumerate(pieces):
            snap = os.path.join(d, f"embedded_{k}.snap")
            walls.append(fabric_embedded(dev, piece, snap))
            same_snapshot(f"fabric world {k}", piece[1][-2].split(" ", 2)[2],
                          snap)
        log(f"fabric worlds: every piece's snapshot bit-equal to its solo "
            f"embedded run; the pack {pack * tsnap / (t1 - t0):.4g} sim-s "
            f"per wall-s ({t1 - t0:.2f} s from its dispatch to its last "
            f"completion), solo {[round(tsnap / w, 4) for w in walls]}")

        # (c) the wire: a 100k node of this process behind the server
        graph.clear()
        node = SimNode(event_port=srv.ports["wevent"],
                       stream_port=srv.ports["wstream"], nmax=wire_nmax,
                       device=dev)
        sent = {}                   # simt -> [(publish stamp, bytes)]

        def send_stream(name, data, node=node):
            payload = packb(data)
            t = time.perf_counter()
            node.stream_out.send_multipart([name + node.node_id, payload])
            if name == b"ACDATA":
                sent.setdefault(float(data["simt"]), []).append(
                    (t, len(payload)))
        node.send_stream = send_stream
        thread = threading.Thread(target=node.run, daemon=True)
        thread.start()
        srv.wait(lambda: node.node_id in srv.client.nodes,
                 "the wire node's REGISTER", 60)
        sub = zmq.Context.instance().socket(zmq.SUB)
        sub.setsockopt(zmq.LINGER, 0)
        sub.setsockopt(zmq.RCVHWM, 0)
        sub.connect(f"tcp://127.0.0.1:{srv.ports['stream']}")
        sub.setsockopt(zmq.SUBSCRIBE, b"ACDATA" + node.node_id)
        time.sleep(0.5)
        srv.client.actnode(node.node_id)
        for line in ("CDMETHOD SPARSE", "ASAS ON") + SIM_VIEW + (
                "SEED 1", f"MCRE {wire_n} B744", "OP", "FF"):
            srv.client.stack(line)
        got = []
        t0 = time.perf_counter()
        while len(got) < FABRIC_FRAMES + 1:
            srv.poll()
            if sub.poll(10):
                frames = sub.recv_multipart()
                t = time.perf_counter()
                data = unpackb(frames[1])
                # a frame's publish stamp: the first unmatched one of its
                # sim time (PUB/SUB keeps the order)
                simt = float(data["simt"])
                t_pub, n_pub = sent[simt].pop(0)
                if len(data["id"]) == wire_n:
                    got.append(((t - t_pub) * 1e3, len(frames[1]), n_pub,
                                (time.perf_counter() - t) * 1e3, simt))
            if time.perf_counter() - t0 > 300:
                raise AssertionError("fabric wire: no ACDATA frames")
        attached_mirror(srv, node.node_id, wire_n)
        srv.client.stack("HOLD")
        rows = got
        log(f"fabric wire: {wire_n} aircraft ACDATA through the server "
            f"(ms publish -> receipt, wire payload bytes, unpack ms, sim "
            f"time): {[tuple(round(x, 3) for x in r) for r in rows]}; the "
            f"server's stream drops "
            f"{srv.health().get('stream_drops')}")
        if not rows or any(n != m for _, n, m, _, _ in rows):
            raise AssertionError(f"fabric wire: frames {got}, sent {sent}")
        node.quit()
        thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("fabric wire: the node did not quit")
        if dev.type == "cuda":
            check_sim_state("fabric wire", node.sim)
    finally:
        if sub is not None:
            sub.close()
        if node is not None and thread is not None and thread.is_alive():
            node.quit()
            thread.join(timeout=60)
        launches = srv.stop()
        del node
        gc.collect()
        graph.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    got = fabric_launches(launches, "/worlds")
    if dev.type == "cuda":
        for form in WORLD_KERNELS["sparse"]:
            if not got.get(form + "/worlds"):
                raise AssertionError(f"fabric worlds: the worker never "
                                     f"launched {form}: {launches}")
    return got


def fabric_phase(dev):
    """Phase 16: the port's own server on the card (``fabric_batch``, then
    ``fabric_worlds_wire``); returns the workers' kernel launches by
    kernels-line name."""
    import shutil
    shutil.rmtree(FABRIC_DIR, ignore_errors=True)
    os.makedirs(os.path.join(FABRIC_DIR, "batch"))
    os.makedirs(os.path.join(FABRIC_DIR, "worlds"))
    t0 = time.perf_counter()
    launches = fabric_batch(dev)
    log(f"fabric (a): {time.perf_counter() - t0:.1f} s, launches "
        f"{launches}")
    t0 = time.perf_counter()
    launches.update(fabric_worlds_wire(dev))
    log(f"fabric (b), (c): {time.perf_counter() - t0:.1f} s")
    return launches


def entry_phase(dev):
    """Phase 15: the command line, then the full-width node; returns
    the node session's kernel launches."""
    entry_cli(dev)
    return entry_node(dev)


def sim_phase(dev):
    """Phase 10: the embedded ``Simulation`` driven through its stack
    (``sim_continental``, then ``sim_regional``); returns the kernel
    launches of the continental session."""
    launches = sim_continental(dev)
    log_card("after sim_continental")
    sim_regional(dev)
    return launches



# ------------------------------------------------------- mesh-epoch phase
#: phase 17's shards on the one card, ensemble replicas and their size,
#: the killed-peer budgets [s]
EPOCH_SHARDS = 4
ENS_REPLICAS, ENS_N, ENS_NMAX = 8, 10_000, 10_240
MH_TIMEOUT, MH_HB = 60.0, 10.0
#: the modes of (c), in the order the ranks run them
MH_MODES = ("replicate", "pallas", "spatial", "tiles")


def launches_by_name(counts=None):
    """Launch counts by kernels-line name: every form of ``FORMS`` and
    every MVP mesh form (``mesh_name``), from ``counts`` (a dict of
    ``LAUNCHES`` keys, e.g. a worker's) or this process's."""
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched
    counts = counts if counts is not None else dict(cd_pallas.LAUNCHES,
                                                    **cd_sched.LAUNCHES)
    out = {}
    for key, name in launch_keys().items():
        out[name] = counts.get(key, 0)
    for k, kind in MESH_FORMS:
        wrapper = {"cd_sched._sched_kernel": "cd_sched_tiles",
                   "cd_pallas._kernel_resume": "cd_full_grid_resume",
                   "cd_pallas._kernel": "cd_full_grid"}[k]
        out[mesh_name(k, "mvp", kind)] = counts.get(
            cd_pallas.launch_key(wrapper, "mvp", kind), 0)
    return out


def add_counts(total, more):
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def meshkill_case(dev, mode, n_ac=100_000, nmax=200_000):
    """Phase 17 (a)/(b) for one mode: ``shard_scene`` on ``EPOCH_SHARDS``
    shards of the card, the snapshot ring every simulated second and the
    pipeline off, 3 s of FF; FAULT MESHKILL 1; the tripping ``step``
    (mesh_lost, the ring blob restored onto the 2 survivors) and the
    first re-sharded chunk timed together; then 3 s more.  Checks the
    trip log, epoch 1 on 2 shards, and the state bit-equal to a fresh
    ``Simulation`` restored from the same ring blob onto a 2-shard mesh
    of the mode the recovery formed and run the same way.  Returns the
    launches of the run by name."""
    import torch
    from bluesky_tpu_torch.core import graph
    from bluesky_tpu_torch.simulation import snapshot as snapmod
    from bluesky_tpu_torch.simulation.sim import Simulation
    graph.clear()
    sim = shard_scene(dev, mode, n_ac, nmax)
    sim.pipeline_enabled = False
    sim.snap_ring.dt = 1.0
    reset_launches()
    sim_do(sim, "OP", "FF")
    sim.run(until_simt=3.0)
    blob = sim.snap_ring.newest()
    if blob is None:
        raise AssertionError(f"meshkill {mode}: the ring holds no snapshot")
    t_blob = snapmod.blob_simt(blob)
    echo = sim_do(sim, "FAULT MESHKILL 1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(max_chunk=CHUNK)           # trips at the dispatch, re-shards
    sim.step(max_chunk=CHUNK)           # the first chunk on the survivors
    torch.cuda.synchronize()
    trip_ms = (time.perf_counter() - t0) * 1e3
    sim.run(until_simt=t_blob + 3.0)
    sim.drain_pipeline()
    torch.cuda.synchronize()
    launches = launches_by_name()
    actions = [t["action"] for t in sim.guard.trips]
    new_mode, nd = sim.shard_mode, sim._shard_ndev()
    if actions != ["mesh_lost", "resharded"] or sim.mesh_epoch != 1 \
            or nd != EPOCH_SHARDS // 2 or not sim.mesh_health()["degraded"]:
        raise AssertionError(f"meshkill {mode}: trips {actions}, epoch "
                             f"{sim.mesh_epoch}, {nd} shards, "
                             f"{sim.mesh_health()}")
    (ev,) = sim.mesh_events
    check_sim_state(f"meshkill {mode}", sim)
    echoes = [e for e in sim.scr.echobuf if "MESH" in e]
    sim.scr.echobuf[:] = []
    tiles = tuple(sim.cfg.cd_tile_shape) if new_mode == "tiles" else None
    fresh = Simulation(nmax=nmax, device=dev, pair_matrix=False)
    fresh.pipeline_enabled = False
    ok, msg = snapmod.restore_blob(fresh, blob, full_reset=False)
    if not ok:
        raise AssertionError(f"meshkill {mode}: fresh restore: {msg}")
    fresh.set_shard(new_mode, nd, devices=[dev] * nd, tiles=tiles)
    sim_do(fresh, "OP", "FF")
    fresh.step(max_chunk=CHUNK)
    fresh.run(until_simt=t_blob + 3.0)
    fresh.drain_pipeline()
    assert_same(f"meshkill {mode}: against a fresh {new_mode} {nd} run "
                "from the same blob", sim.traf.state, fresh.traf.state)
    log(f"meshkill {mode}: {echo[-1]}; {' | '.join(echoes)}; trip to the "
        f"first re-sharded chunk {trip_ms:.1f} ms; now {new_mode.upper()} "
        f"{nd}" + (f" {tiles[0]}x{tiles[1]}" if tiles else "")
        + f", epoch {sim.mesh_epoch}; MESHLOST notice {ev}; state at simt "
        f"{sim.simt:.2f} bit-equal to a fresh {new_mode} {nd} run from the "
        f"ring blob of simt {t_blob:.2f}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    del sim, fresh
    graph.clear()
    return launches


def start_ranks(dev, workdir, state_path, *extra):
    """Two ``scripts/torch_multihost.py`` ranks on ``dev``'s kind of
    device (the card), gloo."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_ports(1)[0]
    env = dict(os.environ, PYTHONPATH=here)
    return [subprocess.Popen(
        [sys.executable, os.path.join(here, "scripts", "torch_multihost.py"),
         "--rank", str(r), "--world", "2", "--port", str(port),
         "--state", state_path, "--out", workdir, "--device", dev.type,
         "--backend", "gloo", "--shards", str(EPOCH_SHARDS), *extra],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]


def stop_ranks(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def one_process_run(dev, path, mode, chunks=3):
    """The single-process ``EPOCH_SHARDS``-shard mesh of (c): the same
    entry and chunks as the ranks.  Returns ``(state, chunk ms)``."""
    import torch
    from bluesky_tpu_torch.parallel import sharding
    from scripts.torch_multihost import enter, load, make_mesh
    mesh = make_mesh(mode, dev, EPOCH_SHARDS, 1)
    state, cfg = enter(load(path, dev), mesh, mode)
    run = sharding.sharded_step_fn(mesh, cfg, nsteps=CHUNK)
    ms = []
    for _ in range(chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run(state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, ms


def multihost_phase(dev, workdir, n_ac=100_000, nmax=200_000):
    """Phase 17 (c): two processes on the one card
    (``init_multihost(backend="gloo")``, each rank owning 2 of the 4
    shards), SHARD REPLICATE under SPARSE and PALLAS, then SPATIAL, then
    TILE 2x2, 3 chunks of 20 steps each on ``main_scene`` in 200,000
    slots: each rank's state bit-equal to the single-process 4-shard
    mesh, the ranks' fingerprints compared at every chunk edge (a
    mismatch fails the rank).  Returns the scene's npz path, the ranks'
    launches by name and rank 0's REPLICATE chunk ms."""
    from bluesky_tpu_torch.core.state import state_to_numpy
    from scripts.torch_multihost import load
    state, _ = main_scene(dev, n_ac, nmax)
    path = os.path.join(workdir, "scene.npz")
    np.savez(path, **state_to_numpy(state))
    del state
    t0 = time.perf_counter()
    procs = start_ranks(dev, workdir, path, "--mode", ",".join(MH_MODES),
                        "--steps", str(CHUNK), "--chunks", "3")
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        stop_ranks(procs)
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multihost rank {r} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    launches = {}
    infos = []
    for r in (0, 1):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            infos.append(json.load(f))
        add_counts(launches, launches_by_name(infos[-1]["launches"]))
    for mode in MH_MODES:
        want, ms1 = one_process_run(dev, path, mode)
        for r in (0, 1):
            got = load(os.path.join(workdir, f"rank{r}-{mode}.npz"), dev)
            assert_same(f"multihost {mode}: rank {r} against the "
                        "single-process 4-shard mesh", got, want)
        rows = [info["chunks"][mode] for info in infos]
        log(f"multihost {mode}: 2 processes x 2 shards on {dev}, backend "
            f"{infos[0]['backend']} (CUDA joins staged through pinned host "
            f"memory: {infos[0]['staged']}; NCCL not measured on one card); "
            f"bit-equal to one process; chunk ms rank 0 "
            f"{[round(c['ms'], 2) for c in rows[0]]}, rank 1 "
            f"{[round(c['ms'], 2) for c in rows[1]]}, one process "
            f"{[round(m, 2) for m in ms1]}; per rank per interval (one "
            f"ASAS interval a 20-step chunk): bytes from its peer "
            f"{[c['bytes'] for c in rows[0]]}, staged "
            f"{[c['staged_bytes'] for c in rows[0]]}, collectives "
            f"{[c['calls'] for c in rows[0]]}")
    log(f"multihost: {len(MH_MODES)} modes in {wall:.1f} s wall (two process "
        f"starts included), launches "
        f"{  {k: v for k, v in launches.items() if v} }")
    return path, launches, [c["ms"] for c in infos[0]["chunks"]["replicate"]]


def killed_peer_phase(dev, workdir, path, unguarded_ms):
    """Phase 17 (e): (c)'s replicate job with a MeshGuard on its joins
    (``MH_TIMEOUT`` s collective budget, ``MH_HB`` s heartbeats); rank 1
    SIGKILLed after 2 chunks.  Rank 0 must raise ``MeshLostError`` naming
    rank 1 within ``MH_TIMEOUT + MH_HB`` s of the kill and resume from
    its last snapshot on its own 2 shards for 3 chunks, bit-equal to a
    fresh 2-shard run from that snapshot here.  Logs rank 0's guarded
    chunk ms beside (c)'s unguarded ones (``unguarded_ms``)."""
    import signal
    import torch
    from bluesky_tpu_torch.parallel import sharding
    from scripts.torch_multihost import enter, load
    kdir = os.path.join(workdir, "killed")
    os.makedirs(kdir)
    procs = start_ranks(dev, kdir, path, "--steps", str(CHUNK), "--hb",
                        os.path.join(kdir, "hb"), "--timeout",
                        str(MH_TIMEOUT), "--hb-timeout", str(MH_HB),
                        "--resume-chunks", "3")
    progress = os.path.join(kdir, "progress")

    def chunks():
        try:
            with open(progress) as f:
                return int(f.read())
        except (OSError, ValueError):
            return 0
    try:
        deadline = time.monotonic() + 120
        while chunks() < 2:
            for p in procs:
                if p.poll() is not None:
                    raise AssertionError("killed peer: a rank left early:\n"
                                         + p.communicate()[0][-6000:])
            if time.monotonic() > deadline:
                raise AssertionError("killed peer: the job never progressed")
            time.sleep(0.05)
        os.kill(procs[1].pid, signal.SIGKILL)
        t_kill = time.time()
        out0 = procs[0].communicate(timeout=MH_TIMEOUT + MH_HB + 120)[0]
    finally:
        stop_ranks(procs)
    if procs[0].returncode != 0:
        raise AssertionError(f"killed peer: rank 0 exited "
                             f"{procs[0].returncode}:\n{out0[-6000:]}")
    with open(os.path.join(kdir, "meshlost.json")) as f:
        lost = json.load(f)
    detect = lost["time"] - t_kill
    if lost["lost"] != [1] or detect > MH_TIMEOUT + MH_HB:
        raise AssertionError(f"killed peer: {lost}, {detect:.2f} s after "
                             "the kill")
    snap = load(os.path.join(kdir, "snap.npz"), dev)
    t_snap = float(snap.simt)
    mesh = sharding.make_mesh(devices=[dev] * (EPOCH_SHARDS // 2))
    state, cfg = enter(snap, mesh, "replicate")
    run = sharding.sharded_step_fn(mesh, cfg, nsteps=CHUNK)
    for _ in range(3):
        state = run(state)
    torch.cuda.synchronize()
    assert_same("killed peer: rank 0's resumed run against a fresh 2-shard "
                "run from the same snapshot",
                load(os.path.join(kdir, "resumed.npz"), dev), state)
    log(f"killed peer: rank 1 SIGKILLed after {lost['chunks']} chunks; rank "
        f"0 raised MeshLostError {detect:.2f} s later (budget "
        f"{MH_TIMEOUT + MH_HB:g} s): {lost['error'][:300]}; survivors "
        f"{lost['survivors']}; resumed from simt {t_snap:.2f} on 2 shards, "
        "bit-equal to a fresh run from that snapshot; rank 0's chunk ms "
        f"with the guard on its joins {[round(m, 2) for m in lost['ms']]} "
        f"against (c)'s without {[round(m, 2) for m in unguarded_ms]}")


def ensemble_phase(dev):
    """Phase 17 (d): ``ensemble_step_fn`` on an ``ENS_REPLICAS`` x card
    ``("ens",)`` mesh of ``regional_scene`` sparse replicas (seeds 0-7,
    the sort refresh in the chunk), 3 chunks of 20 steps, each replica
    bit-equal to its solo ``run_steps``; aggregate aircraft-steps/s of the
    ensemble against the replicas one at a time.  Returns the launches of
    the ensemble run by name."""
    import torch
    from bluesky_tpu_torch.core import graph, step as stepmod
    from bluesky_tpu_torch.core.state import world_slice
    from bluesky_tpu_torch.parallel import sharding
    graph.clear()
    states, cfg = [], None
    for s in range(ENS_REPLICAS):
        st, cfg = regional_scene(dev, ENS_N, ENS_NMAX, seed=s,
                                 cd_backend="sparse", cd_block=256,
                                 pair_matrix=False)
        states.append(st)
    cfg = cfg._replace(inscan_refresh=True)
    mesh = sharding.make_ensemble_mesh(devices=[dev] * ENS_REPLICAS)
    run = sharding.ensemble_step_fn(mesh, cfg, nsteps=CHUNK)
    stacked = sharding.stack_replicas([state_copy(s) for s in states])
    reset_launches()
    ens_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stacked = run(stacked)
        torch.cuda.synchronize()
        ens_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launches_by_name()
    solo_ms = []
    for r, st in enumerate(states):
        st = state_copy(st)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = stepmod.run_steps(st, cfg, CHUNK)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        solo_ms.append(ms)
        assert_same(f"ensemble replica {r} against its solo run",
                    world_slice(stacked, r), st)
    rate = lambda ms: ENS_REPLICAS * ENS_N * CHUNK / (ms / 1e3)
    solo_chunk = [sum(m[i] for m in solo_ms) for i in range(3)]
    log(f"ensemble: {ENS_REPLICAS} x {ENS_N} sparse replicas on an "
        f"{ENS_REPLICAS} x {dev} ('ens',) mesh, each bit-equal to its solo "
        f"run; 20-step chunk ms {[round(m, 2) for m in ens_ms]} "
        f"(aggregate aircraft-steps/s {[f'{rate(m):.4g}' for m in ens_ms]}) "
        f"against one at a time {[round(m, 2) for m in solo_chunk]} "
        f"({[f'{rate(m):.4g}' for m in solo_chunk]}); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    del stacked, states
    graph.clear()
    return launches


def epoch_phase(dev):
    """Phase 17: mesh epochs, several processes and the ensemble
    (ROADMAP A9 step 2): (a) MESHKILL on REPLICATE 4 under SPARSE and
    PALLAS, (b) on TILE 2x2, (c) two processes on the card, (d) the
    ensemble, (e) the killed peer.  Returns ``{column: {name:
    launches}}`` for the kernels line."""
    import shutil
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "output"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="phase17-",
                               dir=os.path.join(here, "output"))
    cols = dict(meshkill_launches={}, multihost_launches={},
                ensemble_launches={})
    try:
        for mode in ("replicate", "pallas replicate", "tiles"):
            t0 = time.perf_counter()
            add_counts(cols["meshkill_launches"], meshkill_case(dev, mode))
            log(f"epoch (a/b) {mode}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        path, n, unguarded_ms = multihost_phase(dev, workdir)
        cols["multihost_launches"] = n
        log(f"epoch (c): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cols["ensemble_launches"] = ensemble_phase(dev)
        log(f"epoch (d): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        killed_peer_phase(dev, workdir, path, unguarded_ms)
        log(f"epoch (e): {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for form in (("cd_sched._sched_kernel", "rows"),
                 ("cd_pallas._kernel_resume", "rows"),
                 ("cd_pallas._kernel", "rows"),
                 ("cd_sched._sched_kernel", "gid")):
        if cols["meshkill_launches"].get(mesh_name(form[0], "mvp",
                                                   form[1]), 0) < 1:
            raise AssertionError(f"epoch: MESHKILL runs never launched "
                                 f"{mesh_name(form[0], 'mvp', form[1])}")
    for form in (("cd_sched._sched_kernel", "rows"),
                 ("cd_pallas._kernel", "rows"),
                 ("cd_sched._sched_kernel", "col0"),
                 ("cd_sched._sched_kernel", "gid")):
        if cols["multihost_launches"].get(mesh_name(form[0], "mvp",
                                                    form[1]), 0) < 1:
            raise AssertionError(f"epoch: the ranks never launched "
                                 f"{mesh_name(form[0], 'mvp', form[1])}")
    if cols["ensemble_launches"].get("cd_sched._sched_kernel", 0) < 1:
        raise AssertionError("epoch: the ensemble never launched K1")
    return cols


#: the no-partner sparse path (phase 18): the clump's fleet and segment
#: cap (``check_kernels``' regional check: overflow rows with real tiles)
#: and the fleet of the hand-off to the full grid (at most 2 * 256)
NORES_CLUMP = (8192, 2)
NORES_SMALL = 500


def nores_name(kernel, reso):
    """The JSON name of a no-partner form: K1's no-resume form
    (``/noresume``) and K3 on its overflow rows (``/overflow``)."""
    tail = "noresume" if kernel == "cd_sched._sched_kernel" else "overflow"
    return f"{form_name(kernel, reso)}/{tail}"


def nores_runs(x, p, reso, tag):
    """``measure``'s entries of K1's no-resume form on the segment blocks
    and of K3 on the overflow rows of the no-partner operands ``x``."""
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched
    reach_f = x.reach & x.overflow[:, None]
    rf = reach_f.cpu().numpy()
    seg = segment_tiles(x)
    k1 = cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, None, p,
                              reso=reso)
    k3 = cd_pallas.full_grid(x.packed, reach_f, p, reso=reso)
    walker = form_name("cd_pallas._kernel", reso)
    return {
        nores_name("cd_sched._sched_kernel", reso): dict(
            kern=lambda **kw: cd_sched.sched_tiles(
                x.packed, x.wst, x.wln, x.wmax, None, p, reso=reso, **kw),
            plain=lambda: cd_sched.sched_tiles_plain(
                x.packed, x.wst, x.wln, x.wmax, None, p, reso),
            pairs=active_pairs(x, seg),
            bytes=in_out_bytes(x, False) + 2 * x.wst.numel() * 4,
            tiles=int(sum(len(seg(i)) for i in range(x.nb))), reso=reso,
            walker=walker,
            extra=dict(item_extra(
                f"K1 no-resume {reso} {tag}", x, cd_sched.window_items(
                    x.wst, x.wln, x.wmax, x.nb), p, reso=reso),
                overflow_rows=int(x.overflow.sum())),
            **form_work(reso, k1, 10)),
        nores_name("cd_pallas._kernel", reso): dict(
            kern=lambda **kw: cd_pallas.full_grid(x.packed, reach_f, p,
                                                  reso=reso, **kw),
            plain=lambda: cd_pallas.full_grid_plain(x.packed, reach_f, p,
                                                    reso),
            pairs=active_pairs(x, lambda i: np.flatnonzero(rf[i])),
            bytes=in_out_bytes(x, False) + x.nb * x.nb,
            tiles=int(rf.sum()), reso=reso, walker=walker,
            extra=dict(item_extra(f"K3 overflow {reso} {tag}", x,
                                  cd_pallas.reach_items(reach_f), p,
                                  reso=reso),
                       overflow_rows=int(x.overflow.sum())),
            **form_work(reso, k3, 10))}


def noresume_phase(dev, errs, regs, n_ac=100_000, nmax=100_352):
    """Phase 18: the sparse CD without a partner table
    (``detect_resolve_sched(partners=None)``, JAX's CD-only sparse form):
    the main path's 100k continental scene (``main_scene``, block 256,
    K = 8) and the regional clump (``NORES_CLUMP``: overflow rows, so K3
    runs on real tiles), under MVP, EBY and SWARM, with the launch counts
    set to 0 just before and read just after: K1's no-resume form and K3
    on the overflow rows each launched, nothing else; the clump's whole
    pass (``cd_sched.run_kernels``) held to its plain versions on the
    same card operands (``cd_pallas.compare_outputs``), and the hand-off
    of ``NORES_SMALL`` aircraft bit-equal to ``detect_resolve_pallas``.
    Then each form timed against its plain version and bounded: K1 at
    the 100k shapes, K3 at the clump's, where it has tiles.  Returns the
    kernels JSON entries."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp
    state, cfg = main_scene(dev, n_ac, nmax)
    ac, a, c = state.ac, state.asas, cfg.asas
    mvp = cr_mvp.MVPConfig(rpz_m=c.rpz_m, hpz_m=c.hpz_m,
                           tlookahead=c.dtlookahead)
    p = cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp)
    cd_tail = (c.rpz, c.hpz, c.dtlookahead, mvp)
    main_cols = [ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
                 ac.gsnorth, ac.active, a.noreso]
    ncl, s_cap = NORES_CLUMP
    clump = columns(ncl, "regional", seed=1)
    small = columns(NORES_SMALL, "regional", seed=2)
    report = []
    for reso in RESOS:
        main_col = {"eby": ac.tas, "swarm": ac.cas}.get(reso)
        clump_col = extra_col(clump, reso, dev)
        keys = {nores_name("cd_sched._sched_kernel", reso):
                cd_pallas.launch_key(cd_sched.NORESUME, reso),
                nores_name("cd_pallas._kernel", reso):
                cd_pallas.launch_key("cd_full_grid", reso)}
        reset_launches()
        t0 = time.perf_counter()
        rd = cd_sched.detect_resolve_sched(
            *main_cols, *cd_tail, block=256, **reso_kw(reso, main_col))
        rd_c = cd_sched.detect_resolve_sched(
            *cd_args(clump, dev), *cd_tail, block=256, s_cap=s_cap,
            **reso_kw(reso, clump_col))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(cd_sched.LAUNCHES, **cd_pallas.LAUNCHES)
        launches = {name: counts[key] for name, key in keys.items()}
        for name, n in launches.items():
            if n < 1:
                raise AssertionError(f"no-partner path never launched {name}")
        others = {k: v for k, v in counts.items()
                  if v and k not in keys.values()}
        if others:
            raise AssertionError(f"no-partner path launched {others}")
        rd0 = rd[0] if reso == "swarm" else rd
        x = cd_sched.prepare(*main_cols, c.rpz, c.hpz, c.dtlookahead, None,
                             block=256, **reso_kw(reso, main_col))
        xc = cd_sched.prepare(*cd_args(clump, dev), c.rpz, c.hpz,
                              c.dtlookahead, None, block=256, s_cap=s_cap,
                              **reso_kw(reso, clump_col))
        # the whole no-partner pass on the clump's card operands (K1 and
        # K3 merged row-disjointly) against its plain versions there
        reach_f = xc.reach & xc.overflow[:, None]
        want = [torch.where(xc.overflow[:, None, None], f, s_) for f, s_ in
                zip(cd_pallas.full_grid_plain(xc.packed, reach_f, p, reso),
                    cd_sched.sched_tiles_plain(xc.packed, xc.wst, xc.wln,
                                               xc.wmax, None, p, reso))]
        err = cd_pallas.compare_outputs(
            f"no-partner pass {reso} clump", cd_sched.run_kernels(xc, p),
            want)
        # the hand-off: bit-equal to detect_resolve_pallas's own call
        sm_col = extra_col(small, reso, dev)
        hand = cd_sched.detect_resolve_sched(
            *cd_args(small, dev), *cd_tail, block=256,
            **reso_kw(reso, sm_col))
        direct = cd_pallas.detect_resolve_pallas(
            *cd_args(small, dev), *cd_tail, block=256, reso=reso,
            extra_cols=None if sm_col is None else
            {"tas" if reso == "eby" else "cas": sm_col})
        if reso == "swarm":
            hand, direct = hand[0], direct[0]
        for k in hand._fields:
            if not torch.equal(getattr(hand, k), getattr(direct, k)):
                raise AssertionError(f"no-partner hand-off {reso}: {k} "
                                     "differs from detect_resolve_pallas")
        log(f"noresume {reso}: the 100k interval and the clump in "
            f"{wall:.1f} ms; 100k nconf {int(rd0.nconf)}, nlos "
            f"{int(rd0.nlos)}; the clump's pass (N={ncl}, s_cap={s_cap}) "
            f"matches its plain versions (max abs err {err:.3g}); the "
            f"{NORES_SMALL}-aircraft hand-off is detect_resolve_pallas's; "
            f"launches {launches}")
        if not int((xc.reach & xc.overflow[:, None]).sum()):
            raise AssertionError("noresume: the clump has no overflow tile")
        runs = nores_runs(x, p, reso, "100k")
        k3 = nores_name("cd_pallas._kernel", reso)
        runs[k3] = nores_runs(xc, p, reso, f"clump N={ncl}")[k3]
        log(f"noresume {reso}: 100k overflow rows {int(x.overflow.sum())}; "
            f"clump overflow rows {int(xc.overflow.sum())} of {xc.nb}, "
            f"overflow tiles {int((xc.reach & xc.overflow[:, None]).sum())}")
        report += report_kernels(runs, launches, errs, regs)
    del state
    return report


# ------------------------------------------------------ plugins phase
#: phase 19: the regional fleets of (a) and (b), (c)'s ensemble scene,
#: (d)'s Simulation and the rows of the performance kernels
PLUG_N, PLUG_NMAX = 10_000, 10_240
PLUG_TYPES = ("A320", "B744", "AT72", "E190")
PLUG_T = 30
PLUG_BOX = (51.0, 3.0, 54.2, 7.8)            # AREA's box (lat, lon)
PLUG_SECTOR = (52.2, 4.8, 53.0, 6.0)         # SECTORCOUNT's box
PLUG_FLOW = 7200.0                           # TRAFGEN source [a/c per h]
ENS19 = (8, 10.0, 500.0, 2_000, 2_048)       # reps, tend, spread, n, nmax
SO6_NMAX, SO6_T = 1_024, 200.0
PERF_ROWS = 100_000
#: the float32 bound of the performance kernels against float64 (the
#: CPU tests hold float64 to rel 1e-12): rel 1e-5 of each value plus
#: 1e-5 of its column's largest magnitude (cancellations near zero)
PERF_RTOL = 1e-5


def plugin_sim(dev, n_ac, nmax, types=("B744",), seed=0):
    """A ``Simulation`` on ``dev`` (float32, no [N, N] pair matrix) with
    ``regional_scene``'s ``n_ac`` aircraft created through its Traffic
    facade, types cycling through ``types``; then CDMETHOD SPARSE (block
    256), ASAS ON, OP, FF.  Returns ``(sim, types of the slots)``."""
    from bluesky_tpu_torch.simulation.sim import Simulation
    sim = Simulation(nmax=nmax, device=dev, pair_matrix=False)
    c = columns(n_ac, "regional", seed)
    tlist = [types[i % len(types)] for i in range(n_ac)]
    sim.traf.create(n_ac, tlist, c["alt"], c["gs"], None, c["lat"],
                    c["lon"], c["trk"])
    sim.traf.flush()
    sim_do(sim, "CDMETHOD SPARSE", "ASAS ON", "OP", "FF")
    sim.cfg = sim.cfg._replace(cd_block=256)
    return sim, tlist


def perf_rows(n, seed):
    """Inputs of the performance kernels on grids that float32 holds
    exactly and no threshold of the kernels comes within float32 rounding
    of (1/64 steps, whole numbers above 2**17, altitudes half a foot off
    whole feet): alt, gs, delalt, cas,
    the five minimum speeds, swhdgsel, the engine masks and the BADA and
    limit columns, float64 numpy."""
    rng = np.random.default_rng(seed)
    q = lambda a, b: np.round(rng.uniform(a, b, n) * 64.0) / 64.0
    whole = lambda a, b: np.round(rng.uniform(a, b, n))
    ft = 0.3048
    alt = (np.round(rng.uniform(0.0, 40000.0, n)) + 0.5) * ft
    alt[rng.random(n) < 0.1] = 0.0
    delalt = np.round(rng.uniform(-3000.0, 3000.0, n)) * ft
    delalt[rng.random(n) < 0.2] = 0.0
    alt, delalt = (np.float64(np.float32(x)) for x in (alt, delalt))
    eng = rng.integers(0, 3, n)
    climb = rng.random(n) < 0.4
    descent = ~climb & (rng.random(n) < 0.5)
    maxthr = whole(80000.0, 250000.0)
    return dict(
        alt=alt, gs=q(0.0, 260.0), delalt=delalt, cas=q(50.0, 200.0),
        vm=[q(40.0, 90.0) for _ in range(5)], swhdgsel=rng.random(n) < 0.5,
        jet=eng == 0, turbo=eng == 1, piston=eng == 2, climb=climb,
        descent=descent, lvl=~climb & ~descent,
        phase=rng.integers(1, 7, n), mach=q(0.2, 0.95), mmo=q(0.7, 0.9),
        abco=rng.random(n) < 0.5, delspd=rng.choice([-5.0, 0.0, 5.0], n),
        desspd=q(40.0, 220.0), to_spd=q(60.0, 90.0), vmin=q(45.0, 80.0),
        vmo=q(150.0, 200.0), hmaxact=whole(9000.0, 13000.0),
        desalt=whole(0.0, 14000.0), desvs=rng.choice([-5.0, 0.0, 8.0], n),
        maxthr=maxthr, thr=np.round(maxthr * rng.uniform(0.3, 1.2, n)),
        drag=whole(20000.0, 90000.0), tas=q(5.0, 250.0),
        mass=whole(40000.0, 200000.0), esf=q(0.3, 1.7),
        ctc=(q(1e5, 3e5), q(3e4, 6e4), rng.uniform(1e-11, 1e-10, n)),
        ctdes=(q(0.02, 0.05), q(0.8, 1.0), q(0.1, 0.2), q(0.2, 0.4)),
        hpdes=whole(2000.0, 3000.0), cf=(q(0.2, 1.0), q(100.0, 2000.0),
                                         q(5.0, 20.0), whole(30000.0, 90000.0),
                                         q(0.85, 1.0)),
        cred=q(0.0, 0.25), mmin=whole(35000.0, 40000.0),
        mmax=whole(72000.0, 80000.0))


def perf_kernel_calls(r, to):
    """Every performance kernel on the rows ``r`` converted by ``to``:
    ``{name: output tuple}``."""
    from bluesky_tpu_torch.ops import perf_bada as pb, perf_legacy as pl
    t = {k: (to(v) if isinstance(v, np.ndarray) else
             [to(x) for x in v] if isinstance(v, (list, tuple)) else v)
         for k, v in r.items()}
    bphase = np.radians([15.0, 35.0, 35.0, 35.0, 15.0, 15.0])
    zero = to(np.zeros(len(r["alt"])))
    out = {}
    for bada in (False, True):
        out[f"phases bada={bada}"] = pl.phases(
            t["alt"], t["gs"], t["delalt"], t["cas"], *t["vm"], zero,
            bphase, t["swhdgsel"], bada)
    out["esf"] = (pl.esf(t["abco"], ~t["abco"], t["alt"], t["mach"],
                         t["climb"], t["descent"], t["delspd"]),)
    out["calclimits"] = pl.calclimits(
        t["desspd"], t["gs"], t["to_spd"], t["vmin"], t["vmo"], t["mmo"],
        t["mach"], t["alt"], t["hmaxact"], t["desalt"], t["desvs"],
        t["maxthr"], t["thr"], t["drag"], t["tas"], t["mass"], t["esf"],
        t["phase"])
    eng = (t["jet"], t["turbo"], t["piston"])
    out["max_climb_thrust"] = (pb.max_climb_thrust(
        t["alt"], t["tas"], *eng, *t["ctc"]),)
    out["thrust"] = pb.thrust(t["phase"], t["climb"], t["descent"],
                              t["lvl"], t["alt"], t["tas"], t["drag"], *eng,
                              *t["ctc"], *t["ctdes"], t["hpdes"])
    out["reduced_climb_power"] = (pb.reduced_climb_power(
        t["alt"], t["hmaxact"], t["climb"], t["cred"], t["mass"],
        t["mmin"], t["mmax"]),)
    out["fuelflow"] = pb.fuelflow(t["phase"], t["alt"], t["tas"], t["thr"],
                                  *eng, *t["cf"])
    return out


def perf_kernels_check(dev, n=None):
    """Phase 19 (a), second half: ``ops/perf_legacy`` and
    ``ops/perf_bada`` on ``n`` float32 rows on the card against float64
    on the CPU (``perf_rows``): floats within ``PERF_RTOL``, phase codes
    and flags equal except ``limspd_flag`` where the float64 speed limit
    lies within 1e-3 m/s of its 0.1 m/s dead band."""
    import torch
    from bluesky_tpu_torch.ops import aero
    n = n or PERF_ROWS
    r = perf_rows(n, 19)
    ref = perf_kernel_calls(r, torch.from_numpy)
    t0 = time.perf_counter()
    got = perf_kernel_calls(r, lambda a: torch.from_numpy(
        a.astype(np.float32) if a.dtype == np.float64 else a).to(dev))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    lim = aero.vmach2cas(torch.from_numpy(r["mmo"] - 0.01),
                         torch.from_numpy(r["alt"])).numpy()
    edge = (r["mach"] > r["mmo"]) \
        & (np.abs(np.abs(r["desspd"] - lim) - 0.1) < 1e-3)
    worst = 0.0
    for name, want in ref.items():
        for k, (w, g) in enumerate(zip(want, got[name])):
            w, g = w.numpy(), g.cpu().numpy()
            if w.dtype == np.float64:
                if g.dtype != np.float32:
                    raise AssertionError(f"perf {name}[{k}]: {g.dtype}")
                d = np.abs(g.astype(np.float64) - w)
                tol = PERF_RTOL * (np.abs(w) + np.abs(w).max())
                if not (d <= tol).all():
                    i = int(np.argmax(d - tol))
                    raise AssertionError(
                        f"perf {name}[{k}] row {i}: {g[i]} against {w[i]}")
                worst = max(worst, float((d / (np.abs(w).max() or 1)).max()))
            else:
                keep = ~edge if (name, k) == ("calclimits", 1) else \
                    np.ones(n, bool)
                if not np.array_equal(g[keep], w[keep]):
                    raise AssertionError(f"perf {name}[{k}]: flags differ")
    phases = set(ref["phases bada=False"][0].numpy().tolist())
    if not set(range(1, 7)) <= phases:
        raise AssertionError(f"perf rows cover phases {sorted(phases)}")
    log(f"plugins (a): perf_legacy and perf_bada on {n} float32 rows on the "
        f"card in {ms:.2f} ms (first call) match float64 on the CPU: phase "
        f"codes and flags equal ({int(edge.sum())} limspd rows in the dead "
        f"band's float32 margin left out), largest error "
        f"{worst:.3g} of the column's magnitude")


def perf_model_runs(dev, root):
    """Phase 19 (a): under ``performance_model`` "bada" and then "bs"
    (``settings.perf_path`` the synthetic tree ``root``), a
    ``plugin_sim`` of the data's types: every ``PerfArrays`` column on
    the card bit-equal to a CPU ``Traffic`` created with the same types,
    3 chunks, the chunk rate and K1/K2 launches."""
    from bluesky_tpu_torch import settings
    from bluesky_tpu_torch.core import graph
    from bluesky_tpu_torch.core.traffic import Traffic
    saved = (settings.performance_model, settings.perf_path)
    settings.perf_path = root
    try:
        for model in ("bada", "bs"):
            settings.performance_model = model
            graph.clear()
            sim, tlist = plugin_sim(dev, PLUG_N, PLUG_NMAX, PLUG_TYPES)
            cpu = Traffic(nmax=PLUG_NMAX, pair_matrix=False, device="cpu")
            c = columns(PLUG_N, "regional", 0)
            cpu.create(PLUG_N, tlist, c["alt"], c["gs"], None, c["lat"],
                       c["lon"], c["trk"])
            cpu.flush()
            bad = [k for (k, x), (_, y) in zip(
                graph.leaves(sim.traf.state.perf),
                graph.leaves(cpu.state.perf)) if not bits_equal(x.cpu(), y)]
            if bad or sim.traf.coeffdb.model != model:
                raise AssertionError(f"perf {model}: card columns differ "
                                     f"from the CPU's in {bad}")
            mass = sorted({round(float(m), 1) for m in
                           sim.traf.state.perf.mass[:4].cpu()})
            reset_launches()
            rows = sim_chunks(sim, 3)
            sim.drain_pipeline()
            check_sim_state(f"perf {model}", sim)
            launches = {k: v for k, v in launch_counts().items() if v}
            log_chunks(f"plugins (a) {model}", rows, PLUG_N)
            log(f"plugins (a) {model}: PerfArrays bit-equal to the CPU's "
                f"({len(graph.leaves(cpu.state.perf))} columns; slot masses "
                f"{mass} kg), launches {launches}")
            for form in ("cd_sched._sched_kernel",
                         "cd_pallas._kernel_resume"):
                if launches.get(form, 0) < 1:
                    raise AssertionError(f"perf {model}: never launched "
                                         f"{form}")
            del sim, cpu
    finally:
        settings.performance_model, settings.perf_path = saved
        graph.clear()


def plugin_session(dev):
    """Phase 19 (b): ``plugin_sim``'s fleet for ``PLUG_T`` sim-s without
    plugins, then ``PLUG_T`` more with AREA, SECTORCOUNT, GEOVECTOR and
    TRAFGEN loaded, every hook at 1 s.  At each of their edges: the
    aircraft AREA deleted were all outside its box there (none inside
    was), SECTORCOUNT's count is a recount of the card's positions, and
    TRAFGEN created what its Poisson draws asked for.  Returns the
    launches of the plugin run by name."""
    from bluesky_tpu_torch.core import graph
    from bluesky_tpu_torch.plugins import host_arrays
    graph.clear()
    sim, _ = plugin_sim(dev, PLUG_N, PLUG_NMAX)
    sim_chunks(sim, 2)                          # warm-up
    reset_launches()
    plain = sim_chunks(sim, PLUG_T)
    plain_launch = launch_counts()
    syncs = [r["syncs"] for r in sim_chunks(sim, 2, syncs=True)]
    if syncs != [0, 0]:
        raise AssertionError(f"plugins (b): host syncs without plugins "
                             f"{syncs}")
    (a0, o0, a1, o1), (s0, t0_, s1, t1_) = PLUG_BOX, PLUG_SECTOR
    sim_do(sim, "PLUGINS LOAD AREA", f"BOX EXP {a0} {o0} {a1} {o1}",
           "AREA EXP", "PLUGINS LOAD SECTORCOUNT",
           f"BOX S1 {s0} {t0_} {s1} {t1_}", "SECTORCOUNT ADD S1",
           "PLUGINS LOAD GEOVECTOR", "GEOVECTOR S1 250 300",
           "PLUGINS LOAD TRAFGEN", "TRAFGEN CIRCLE 52.6 5.4 200",
           f"TRAFGEN SRC SEGM90 FLOW {PLUG_FLOW:g}", "OP", "FF")
    pm = sim.plugins
    for funs in (pm.preupdate_funs, pm.update_funs):
        for fun in funs.values():               # every hook at 1 s
            fun[0], fun[1] = sim.simt + 1.0, 1.0
    area = pm.update_funs["AREA"][2].__self__
    sector = pm.update_funs["SECTORCOUNT"][2].__self__
    gen = pm.update_funs["TRAFGEN"][2].__self__
    seen = dict(area=0, deleted=0, sector=0, draws=0, created=0)
    hook_ms = {}

    def timed(name, fn):
        t = time.perf_counter()
        fn()
        hook_ms[name] = hook_ms.get(name, 0.0) \
            + (time.perf_counter() - t) * 1e3

    def area_update():
        ac = sim.traf.state.ac
        lat, lon, act = host_arrays(ac.lat, ac.lon, ac.active)
        before = {i: s for s, i in enumerate(sim.traf.ids) if i}
        timed("AREA", orig_area)
        gone = [s for i, s in before.items() if sim.traf.id2idx(i) < 0]
        inside = (lat >= a0) & (lat <= a1) & (lon >= o0) & (lon <= o1)
        if any(inside[s] or not act[s] for s in gone):
            raise AssertionError("plugins (b): AREA deleted an aircraft "
                                 "inside its box")
        seen["area"] += 1
        seen["deleted"] += len(gone)

    def sector_update():
        timed("SECTORCOUNT", orig_sector)
        ac = sim.traf.state.ac
        n = int(((ac.lat >= s0) & (ac.lat <= s1) & (ac.lon >= t0_)
                 & (ac.lon <= t1_) & ac.active).sum())
        if n != len(sector.previnside[0]):
            raise AssertionError(f"plugins (b): SECTORCOUNT {len(sector.previnside[0])}"
                                 f" against a recount of {n}")
        seen["sector"] += 1

    def spawn_count(obj, dt):
        k = orig_spawn(obj, dt)
        seen["draws"] += k
        return k

    orig_area, orig_sector, orig_spawn = area.update, sector.update, \
        gen._spawn_count
    pm.update_funs["AREA"][2] = area_update
    pm.update_funs["SECTORCOUNT"][2] = sector_update
    for funs, name in ((pm.preupdate_funs, "GEOVECTOR"),
                       (pm.update_funs, "TRAFGEN")):
        funs[name][2] = (lambda n, f: lambda: timed(n, f))(
            name, funs[name][2])
    gen._spawn_count = spawn_count
    sim.traf.create_hooks.append(
        lambda slots: seen.__setitem__("created",
                                       seen["created"] + len(slots)))
    sim_chunks(sim, 2)                          # warm-up
    cap0 = captures()
    miss = lambda: sum(int(sim.obs.get(k).value) for k in (
        "devprof_cache_misses_ladder", "devprof_cache_misses_offladder"))
    m0 = miss()
    reasons = sim.pipe_stats["sync_reasons"]
    p0 = reasons.get("plugin", 0)
    reset_launches()
    seen.update(area=0, deleted=0, sector=0, draws=0, created=0)
    hook_ms.clear()
    rows = sim_chunks(sim, PLUG_T)
    sim.drain_pipeline()
    launches = launch_counts()
    check_sim_state("plugins (b)", sim)
    caps, misses = captures() - cap0, miss() - m0
    mean = PLUG_FLOW * PLUG_T / 3600.0
    if seen["created"] != seen["draws"] or \
            abs(seen["draws"] - mean) > 5 * mean ** 0.5:
        raise AssertionError(f"plugins (b): TRAFGEN created {seen['created']}"
                             f" for draws {seen['draws']} (flow mean {mean})")
    if seen["area"] < PLUG_T - 1 or seen["sector"] < PLUG_T // 2 \
            or not seen["deleted"]:
        raise AssertionError(f"plugins (b): hooks ran {seen}")
    if caps or misses:
        raise AssertionError(f"plugins (b): {caps} graph captures and "
                             f"{misses} compile misses after warm-up")
    w_plain = log_chunks("plugins (b) without plugins", plain, PLUG_N)
    w_plug = log_chunks("plugins (b) AREA+SECTORCOUNT+GEOVECTOR+TRAFGEN "
                        "at 1 s", rows, PLUG_N)
    log(f"plugins (b): {PLUG_T / w_plain:.4g} sim-s per wall-s without "
        f"plugins against {PLUG_T / w_plug:.4g} with; host syncs per "
        f"pipelined chunk without plugins {syncs}; plugin syncs "
        f"{reasons.get('plugin', 0) - p0}; graph captures {caps} and "
        f"compile misses {misses} after warm-up; AREA deleted "
        f"{seen['deleted']} (all outside its box), SECTORCOUNT recounted "
        f"{seen['sector']} times, TRAFGEN created {seen['created']} (flow "
        f"mean {mean:g}); host ms per hook call "
        f"{ {k: round(v / PLUG_T, 3) for k, v in hook_ms.items()} }; "
        f"launches without "
        f"{ {k: v for k, v in plain_launch.items() if v} }, with "
        f"{ {k: v for k, v in launches.items() if v} }")
    for form in ("cd_sched._sched_kernel", "cd_pallas._kernel_resume"):
        if launches[form] < 1:
            raise AssertionError(f"plugins (b): never launched {form}")
    del sim
    graph.clear()
    return launches


def ensemble_command(dev):
    """Phase 19 (c): PLUGINS LOAD ENSEMBLE and ENSEMBLE 8 10 500 on a
    2,000-aircraft regional SPARSE scene in 2,048 slots; each replica's
    end state bit-equal to a solo ``run_steps`` from the same jittered
    start (``Ensemble.jitter`` again with the run's number).  Returns the
    launches of the ENSEMBLE command by name."""
    import torch
    from bluesky_tpu_torch.core import graph, step as stepmod
    from bluesky_tpu_torch.core.state import world_slice
    nrep, tend, spread, n_ac, nmax = ENS19
    graph.clear()
    sim, _ = plugin_sim(dev, n_ac, nmax)
    sim_chunks(sim, 2)
    sim.drain_pipeline()
    sim_do(sim, "PLUGINS LOAD ENSEMBLE")
    base = state_copy(sim.traf.state)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    echo = sim_do(sim, f"ENSEMBLE {nrep} {tend:g} {spread:g}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    ens = sim.stack.cmddict["ENSEMBLE"][2].__self__
    final = state_copy(ens.final)
    start = ens.jitter(base, nrep, spread, ens._runs)
    cfg = ens.config()
    nsteps = int(round(tend / cfg.simdt))
    plan = [20] * (nsteps // 20) + ([nsteps % 20] if nsteps % 20 else [])
    for r in range(nrep):
        st = state_copy(world_slice(start, r))
        for k in plan:
            st = stepmod.run_steps(st, cfg, k)
        assert_same(f"ENSEMBLE replica {r} against its solo run",
                    world_slice(final, r), st)
    log(f"plugins (c): ENSEMBLE {nrep} {tend:g} {spread:g} on {n_ac} "
        f"aircraft in {nmax} slots: {wall:.3f} s, "
        f"{nrep * n_ac * nsteps / wall:.4g} aggregate aircraft-steps/s; "
        f"each replica bit-equal to its solo run; launches "
        f"{ {k: v for k, v in launches.items() if v} }; reply "
        f"{echo[0].splitlines()[0]!r}")
    for form in ("cd_sched._sched_kernel", "cd_pallas._kernel_resume"):
        if launches[form] < 1:
            raise AssertionError(f"plugins (c): ENSEMBLE never launched "
                                 f"{form}")
    del sim, base, final, start
    graph.clear()
    return launches


def so6_run(dev, workdir):
    """Phase 19 (d): ``scenario/sample.so6`` converted, IC'd into a
    ``SO6_NMAX``-slot Simulation on the card and run ``SO6_T`` sim-s (its
    last flight starts 180 s after its first): every flight of the file
    created, the fleet finite."""
    from bluesky_tpu_torch.core import step as stepmod
    from bluesky_tpu_torch.simulation.sim import Simulation
    from bluesky_tpu_torch.utils import so6
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "scenario", "sample.so6")) as f:
        scn = so6.convert(f.readlines())
    path = os.path.join(workdir, "sample.scn")
    with open(path, "w") as f:
        f.write("\n".join(scn) + "\n")
    flights = {line.split()[1] for line in scn if ">CRE " in line}
    sim = Simulation(nmax=SO6_NMAX, device=dev)
    t0 = time.perf_counter()
    sim_do(sim, f"IC {path}", "OP", f"FF {SO6_T:g}")
    sim.run(until_simt=SO6_T)
    sim.drain_pipeline()
    got = {i for i in sim.traf.ids if i}
    if got != flights or not bool(stepmod.state_finite(sim.traf.state)):
        raise AssertionError(f"plugins (d): SO6 flights {sorted(flights)},"
                             f" created {sorted(got)}")
    log(f"plugins (d): sample.so6 -> {len(scn)} scenario lines, "
        f"{len(flights)} flights all created and flown {SO6_T:g} sim-s in "
        f"{time.perf_counter() - t0:.2f} s")


def plugins_phase(dev):
    """Phase 19: plugins and performance models (ROADMAP A10.2-A10.4).
    Returns ``{column: {name: launches}}`` for the kernels line."""
    import shutil
    import tempfile
    from bluesky_tpu_torch import settings
    from bluesky_tpu_torch.models import synthetic
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "output"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="phase19-",
                               dir=os.path.join(here, "output"))
    log_path, settings.log_path = settings.log_path, workdir   # FLSTLOG..
    cols = {}
    try:
        t0 = time.perf_counter()
        perf_model_runs(dev, synthetic.write_perf_tree(
            os.path.join(workdir, "performance")))
        perf_kernels_check(dev)
        log(f"plugins (a): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cols["plugin_launches"] = plugin_session(dev)
        log(f"plugins (b): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cols["plugin_ensemble_launches"] = ensemble_command(dev)
        log(f"plugins (c): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        so6_run(dev, workdir)
        log(f"plugins (d): {time.perf_counter() - t0:.1f} s")
    finally:
        settings.log_path = log_path
        shutil.rmtree(workdir, ignore_errors=True)
    return cols


#: phase 20 (``ui_phase``): the sim seconds of each web run, the viewer's
#: pull rate, the geodesy pairs; what (b) and (c) measured in phases 10
#: and 16 (``UI_RESULTS``)
UI_T = 30
UI_FPS = 4.0
UI_GEO_PAIRS = 1_000_000
UI_GEO_RTOL, UI_GEO_ATOL = 1e-12, 1e-9
UI_RESULTS = {}


def svg_glyphs(svg, parse=True):
    """Aircraft glyphs of a radar picture: the ``<g data-acid=...>``
    groups that are not SSD discs.  With ``parse`` the SVG must parse
    as XML; without, the chevrons' ``rotate(...)" data-acid=`` are
    counted in the text."""
    if not parse:
        return svg.count(')" data-acid=')
    import xml.etree.ElementTree as ET
    root = ET.fromstring(svg)
    return sum(1 for g in root.iter("{http://www.w3.org/2000/svg}g")
               if "data-acid" in g.attrib and "class" not in g.attrib)


def screenshot_100k(sim):
    """Phase 20 (b): SCREENSHOT on phase 10's 100k Simulation: ms and
    bytes of the file, one glyph per live aircraft."""
    path = os.path.abspath(os.path.join("output", "chip_smoke_radar.svg"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    sim_do(sim, f"SCREENSHOT {path}")
    ms = (time.perf_counter() - t0) * 1e3
    size = os.path.getsize(path)
    t1 = time.perf_counter()
    with open(path) as f:
        glyphs = svg_glyphs(f.read())
    parse_ms = (time.perf_counter() - t1) * 1e3
    os.remove(path)
    if glyphs != sim.traf.ntraf:
        raise AssertionError(f"SCREENSHOT: {glyphs} glyphs for "
                             f"{sim.traf.ntraf} aircraft")
    UI_RESULTS["screenshot"] = dict(ms=ms, bytes=size, glyphs=glyphs)
    log(f"ui (b): SCREENSHOT of {glyphs} aircraft in {ms:.1f} ms, "
        f"{size} bytes, parsed as XML in {parse_ms:.1f} ms")


def attached_mirror(srv, node_id, n_ac, timeout=120):
    """Phase 20 (c): a ``GuiClient`` on phase 16 (c)'s server takes the
    wire node's ACDATA; ``render_svg`` of its ``nodeData`` gives one
    glyph per aircraft."""
    from bluesky_tpu_torch.network.guiclient import GuiClient
    gui = GuiClient()
    try:
        t0 = time.perf_counter()
        gui.connect(event_port=srv.ports["event"],
                    stream_port=srv.ports["stream"], timeout=60.0)
        nd = gui.get_nodedata(node_id)
        while len(nd.acdata.get("id", [])) != n_ac:
            srv.poll()
            gui.receive(10)
            if time.perf_counter() - t0 > timeout:
                raise AssertionError("ui (c): no full ACDATA frame in the "
                                     "GuiClient mirror")
        wait = time.perf_counter() - t0
        t1 = time.perf_counter()
        svg = gui.render_svg(nodeid=node_id)
        ms = (time.perf_counter() - t1) * 1e3
    finally:
        gui.close()
    glyphs = svg_glyphs(svg, parse=False)
    if glyphs != n_ac:
        raise AssertionError(f"ui (c): the mirror drew {glyphs} of {n_ac}")
    UI_RESULTS["mirror"] = dict(ms=ms, bytes=len(svg), glyphs=glyphs,
                                wait_s=wait)
    log(f"ui (c): GuiClient mirror of the wire node: first full frame "
        f"{wait:.2f} s after connect, render_svg {ms:.1f} ms, "
        f"{len(svg)} bytes, {glyphs} glyphs")


class Viewer(threading.Thread):
    """A browser stand-in: pulls ``/frame.svg`` at ``fps`` until
    stopped; keeps (ms, bytes) of each pull."""

    def __init__(self, port, fps):
        super().__init__(daemon=True)
        self.url = f"http://127.0.0.1:{port}/frame.svg"
        self.period = 1.0 / fps
        self.halt = threading.Event()
        self.pulls = []

    def run(self):
        import urllib.request
        t_next = time.perf_counter()
        while not self.halt.is_set():
            t0 = time.perf_counter()
            with urllib.request.urlopen(self.url, timeout=30) as r:
                n = len(r.read())
            self.pulls.append(((time.perf_counter() - t0) * 1e3, n))
            t_next += self.period
            self.halt.wait(max(0.0, t_next - time.perf_counter()))


def web_run(sim, backend, t_sim):
    """The serve loop for ``t_sim`` sim-s: pump, then one chunk.  Returns
    (wall s, pipelined chunks, sync chunks, sync reasons)."""
    ps = sim.pipe_stats
    p0, s0 = ps["pipelined_chunks"], ps["sync_chunks"]
    r0 = dict(ps["sync_reasons"].items())
    t_end = sim.simt_planned + t_sim
    t0 = time.perf_counter()
    while sim.simt_planned < t_end - 1e-9:
        backend.pump()
        sim.step(max_chunk=CHUNK)
    sim.drain_pipeline()
    wall = time.perf_counter() - t0
    reasons = {k: v - r0.get(k, 0) for k, v in ps["sync_reasons"].items()
               if v - r0.get(k, 0)}
    return wall, ps["pipelined_chunks"] - p0, ps["sync_chunks"] - s0, \
        reasons


def web_syncs(sim, backend, n):
    """Host syncs of ``n`` loop iterations, split by whether the
    iteration rendered a frame: ([syncs without], [syncs with])."""
    out = ([], [])
    for _ in range(n):
        r0 = backend._last_render
        k = count_syncs(lambda: (backend.pump(),
                                 sim.step(max_chunk=CHUNK)))
        out[backend._last_render != r0].append(k)
    return out


def served(backend, fn):
    """``fn()`` on a client thread while this thread pumps the backend
    (no stepping), as the serve loop would between chunks."""
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("out", fn()),
                         daemon=True)
    t.start()
    t0 = time.perf_counter()
    while t.is_alive():
        backend.pump()
        t.join(0.005)
        if time.perf_counter() - t0 > 60:
            raise AssertionError("ui (a): a request never came back")
    if "out" not in box:
        raise AssertionError("ui (a): a request failed")
    return box["out"]


def web_session(dev):
    """Phase 20 (a): the 10k regional Simulation behind ``serve_sim``."""
    import contextlib
    import urllib.request
    from bluesky_tpu_torch.core import graph
    from bluesky_tpu_torch.plugins import host_arrays
    from bluesky_tpu_torch.ui.radar import SSD_MAX_DISCS
    from bluesky_tpu_torch.ui.web import serve_sim
    graph.clear()
    sim, _ = plugin_sim(dev, PLUG_N, PLUG_NMAX)
    (port,) = free_ports(1)
    with contextlib.redirect_stdout(sys.stderr):
        ui = serve_sim(sim, port=port, fps=UI_FPS, run=False)
    backend = ui.backend
    renders = []
    real = backend._render

    def timed_render():
        t = time.perf_counter()
        out = real()
        renders.append(((time.perf_counter() - t) * 1e3, len(out[0])))
        return out
    backend._render = timed_render
    base = f"http://127.0.0.1:{port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.read().decode()

    def post(path, body):
        req = urllib.request.Request(base + path, data=body.encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read().decode()
    viewer = None
    try:
        sim_chunks(sim, 2)                          # warm-up (captures)
        cap0 = captures()
        plain = web_run(sim, backend, UI_T)
        syn_plain = web_syncs(sim, backend, 8)
        n_plain = len(renders)
        viewer = Viewer(port, UI_FPS)
        viewer.start()
        view = web_run(sim, backend, UI_T)
        syn_view = web_syncs(sim, backend, 16)
        viewer.halt.set()
        viewer.join(timeout=60)
        frames = renders[n_plain:]
        log(f"ui (a): {PLUG_N} aircraft, {UI_T} sim-s: without a viewer "
            f"{UI_T / plain[0]:.4g} sim-s per wall-s ({plain[1]} pipelined"
            f" / {plain[2]} sync chunks, reasons {plain[3]}, renders "
            f"{n_plain}); with the viewer at {UI_FPS:g} Hz "
            f"{UI_T / view[0]:.4g} ({view[1]} / {view[2]}, reasons "
            f"{view[3]}, {len(viewer.pulls)} pulls); host syncs per "
            f"iteration without a render {syn_plain[0] + syn_view[0]}, "
            f"with one {syn_plain[1] + syn_view[1]}; per frame render ms "
            f"{[round(m, 2) for m, _ in frames]}, SVG bytes "
            f"{[b for _, b in frames]}; pull ms "
            f"{[round(m, 2) for m, _ in viewer.pulls]}; graph captures "
            f"after warm-up {captures() - cap0}")
        if not frames or syn_plain[0] and max(syn_plain[0]) > 0:
            raise AssertionError(f"ui (a): renders {frames}, syncs "
                                 f"{syn_plain}")
        # a posted CRE is in the next frame
        served(backend, lambda: post("/cmd", "CRE UI1 B744 52.6 5.4 90 "
                                     "FL300 250"))
        if 'data-acid="UI1"' not in served(backend,
                                           lambda: get("/frame.svg")):
            raise AssertionError("ui (a): the posted CRE is not in the "
                                 "next frame")
        # a click at an aircraft's position on an empty line
        ac = sim.traf.state.ac
        lat, lon, act = host_arrays(ac.lat, ac.lon, ac.active)
        slot = int(np.flatnonzero(act)[17])
        click = json.loads(served(backend, lambda: post(
            "/click", json.dumps({"line": "", "lat": float(lat[slot]),
                                  "lon": float(lon[slot])}))))
        if click["todisplay"] != sim.traf.ids[slot] + " ":
            raise AssertionError(f"ui (a): click gave {click}, want "
                                 f"{sim.traf.ids[slot]}")
        n0 = len(renders)
        served(backend, lambda: post("/cmd", "SSD CONFLICTS"))
        svg = served(backend, lambda: get("/frame.svg"))
        discs = svg.count('class="ssd"')
        act, inconf = host_arrays(ac.active, sim.traf.state.asas.inconf)
        nconf = int((act & inconf).sum())
        served(backend, lambda: post("/cmd", f"ND {sim.traf.ids[slot]}"))
        nd = served(backend, lambda: get("/nd.svg"))
        served(backend, lambda: post("/cmd", "SSD OFF"))
        log(f"ui (a): the posted CRE in the next frame; a click at "
            f"{sim.traf.ids[slot]}'s position gave {click['todisplay']!r};"
            f" SSD CONFLICTS frame {discs} discs ({nconf} aircraft in "
            f"conflict), ND frame {len(nd)} "
            f"bytes; render ms / bytes of those frames "
            f"{[(round(m, 2), b) for m, b in renders[n0:]]}")
        if discs != min(nconf, SSD_MAX_DISCS) or "<svg" not in nd:
            raise AssertionError(f"ui (a): SSD discs {discs}, ND {nd[:80]}")
        if sim.pipe_stats["render_errors"]:
            raise AssertionError(f"ui (a): {sim.pipe_stats['render_errors']}"
                                 f" renders failed (logged on stderr)")
        UI_RESULTS["web"] = dict(plain=UI_T / plain[0], view=UI_T / view[0],
                                 frames=frames, syncs=(syn_plain, syn_view))
    finally:
        if viewer is not None:
            viewer.halt.set()
        ui.stop()
        del sim
        graph.clear()


def geo_pairs(n, seed=20):
    """``n`` pairs of points, the first thousand coinciding, a tenth
    across the antimeridian, and bearings and distances for qdrpos."""
    rng = np.random.default_rng(seed)
    lat1, lat2 = rng.uniform(-85, 85, n), rng.uniform(-85, 85, n)
    lon1, lon2 = rng.uniform(-180, 180, n), rng.uniform(-180, 180, n)
    near = rng.random(n) < 0.5                  # regional pairs
    lat2[near] = np.clip(lat1[near] + rng.normal(0, 1, near.sum()), -89, 89)
    lon2[near] = lon1[near] + rng.normal(0, 1.5, near.sum())
    lat2[:1000], lon2[:1000] = lat1[:1000], lon1[:1000]
    return (lat1, lon1, lat2, lon2, rng.uniform(0, 360, n),
            rng.uniform(0, 500, n))


def geo_check(name, got, want, same):
    for g, w in zip(got, want):
        d = np.abs(g - w)
        ok = (d <= UI_GEO_RTOL * np.abs(w)) | (same & (d <= UI_GEO_ATOL))
        if not ok.all():
            raise AssertionError(f"ui (d): {name} C against NumPy: "
                                 f"{int((~ok).sum())} pairs off, worst "
                                 f"{float(d[~ok].max())}")


def hostgeo_phase():
    """Phase 20 (d): the host geodesy core, C against NumPy."""
    from bluesky_tpu_torch.ops import hostgeo
    t0 = time.perf_counter()
    if not hostgeo.compiled:
        raise AssertionError(f"ui (d): hostgeo not compiled: "
                             f"{hostgeo.status}")
    build_s = time.perf_counter() - t0
    lat1, lon1, lat2, lon2, qdr, dist = geo_pairs(UI_GEO_PAIRS)
    same = (lat1 == lat2) & (lon1 == lon2)
    calls = {"qdrdist": lambda: hostgeo.qdrdist(lat1, lon1, lat2, lon2),
             "qdrpos": lambda: hostgeo.qdrpos(lat1, lon1, qdr, dist),
             "kwikqdrdist": lambda: hostgeo.kwikqdrdist(lat1, lon1, lat2,
                                                       lon2)}
    ms, out = {}, {}
    try:
        for path in ("C", "NumPy", "C", "NumPy"):
            hostgeo.compiled = path == "C"
            for name, fn in calls.items():
                t1 = time.perf_counter()
                out[name, path] = fn()
                ms.setdefault((name, path), []).append(
                    (time.perf_counter() - t1) * 1e3)
    finally:
        hostgeo.compiled = True
    for name in calls:
        geo_check(name, out[name, "C"], out[name, "NumPy"],
                  same if name != "qdrpos" else np.zeros_like(same))
    UI_RESULTS["geo"] = ms
    log(f"ui (d): hostgeo {hostgeo.status} (first use {build_s:.2f} s); "
        f"{UI_GEO_PAIRS} pairs, C and NumPy equal within {UI_GEO_RTOL:g} "
        f"relative; ms (two rounds) "
        + ", ".join(f"{n} {p} {[round(m, 2) for m in v]}"
                    for (n, p), v in ms.items()))


def ui_phase(dev):
    """Phase 20: the radar and browser UI; (b) and (c) ran in phases 10
    and 16."""
    for part in ("screenshot", "mirror"):
        if part not in UI_RESULTS:
            raise AssertionError(f"ui: part {part} never ran")
    t0 = time.perf_counter()
    web_session(dev)
    log(f"ui (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hostgeo_phase()
    log(f"ui (d): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------- scale phase
#: phase 21 (``scale_phase``): the JAX package's largest fleets, as its
#: ``bench.py`` ``detail()`` makes them: ``SCALE_GLOBAL`` aircraft
#: worldwide in as many slots (sparse and pallas), ``SCALE_REGIONAL``
#: aircraft in the 230 nm circle in its slots (sparse)
SCALE_GLOBAL = 1_000_000
SCALE_REGIONAL = (100_000, 100_352)
#: the kernel forms the scale phase must measure (the kernels line): each
#: form its paths launch, and K3 on the regional overflow rows (off the
#: path); K3 on the global sparse overflow rows joins them when there
#: is an overflow row
SCALE_FORMS = ("cd_sched._sched_kernel/scale_global",
               "cd_pallas._kernel_resume/scale_global",
               "cd_pallas._kernel/scale_global",
               "cd_sched._sched_kernel/scale_regional",
               "cd_pallas._kernel_resume/scale_regional",
               "cd_pallas._kernel/scale_regional_overflow")
#: the sampled row blocks of a plain hold: the last ``SCALE_LAST``
#: occupied row blocks (the largest slot offsets) and ``SCALE_RANDOM``
#: more drawn from numpy seed 0 among the occupied ones
SCALE_LAST = 64
SCALE_RANDOM = 64
#: the float64 witness: sampled ownships (the ``SCALE_LAST`` highest
#: sparse slots and the ``SCALE_LAST`` highest caller slots among them),
#: the whole fleet as intruders ``WITNESS_CHUNK`` at a time, and the
#: relative margin within which a compared quantity leaves a pair's
#: float32 flag free to go either way (an excused pair)
WITNESS_OWN = 1024
WITNESS_CHUNK = 8192
WITNESS_MARGIN = 1e-4


def bench_columns(n_ac, geometry, seed=0):
    """The creation inputs of ``bench.py``'s ``_make_traffic``: its numpy
    seed and its draws in its order; ``geometry`` "global" (area-uniform
    up to +-70 deg, every longitude) or "regional" (the 230 nm circle
    around 52.6 N 5.4 E).  Returns ``dict(lat, lon, alt, spd, hdg)``."""
    rng = np.random.default_rng(seed)
    if geometry == "global":
        lat = np.degrees(np.arcsin(rng.uniform(-0.94, 0.94, n_ac)))
        lon = rng.uniform(-180.0, 180.0, n_ac)
    else:
        ang = rng.uniform(0, 2 * np.pi, n_ac)
        r = 3.8 * np.sqrt(rng.random(n_ac))
        lat = 52.6 + r * np.cos(ang)
        lon = 5.4 + r * np.sin(ang) / 0.6
    alt = rng.uniform(3000.0, 11000.0, n_ac)
    spd = rng.uniform(130.0, 240.0, n_ac)
    hdg = rng.uniform(0.0, 360.0, n_ac)
    return dict(lat=lat, lon=lon, alt=alt, spd=spd, hdg=hdg)


def bench_scene(dev, n_ac, nmax, geometry, cd_backend="sparse",
                cd_block=256, reso_method="MVP"):
    """``n_ac`` aircraft of ``bench_columns``' ``geometry`` (B744, seed
    0) in ``nmax`` slots, built with the port's ``Traffic(pair_matrix=
    False).create/flush`` on ``dev`` in float32, under ``SimConfig(
    cd_backend=cd_backend, cd_block=cd_block)``.  Returns ``(state,
    cfg)``."""
    from bluesky_tpu_torch.core import asas, step as stepmod
    from bluesky_tpu_torch.core.traffic import Traffic
    c = bench_columns(n_ac, geometry)
    traf = Traffic(nmax=nmax, pair_matrix=False, device=dev)
    traf.create(n_ac, "B744", c["alt"], c["spd"], None, c["lat"], c["lon"],
                c["hdg"])
    traf.flush()
    return traf.state, stepmod.SimConfig(
        cd_backend=cd_backend, cd_block=cd_block,
        asas=asas.AsasConfig(reso_method=reso_method))


def global_scene(dev, n_ac=SCALE_GLOBAL, nmax=SCALE_GLOBAL, **kw):
    """``bench.py``'s global fleet (``bench_scene``): by default its
    million aircraft in a million slots, as ``bench.run_one`` sizes it."""
    return bench_scene(dev, n_ac, nmax, "global", **kw)


class CaptureLog:
    """The graph captures made while it is entered: ``(kind, ms)`` of
    every ``devprof.compile_event`` (``core/graph._capture`` reports its
    warm-up and its capture)."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        from bluesky_tpu_torch.obs import devprof
        self._orig = devprof.compile_event

        def record(kind, ms):
            self.events.append((kind, ms))
            return self._orig(kind, ms)
        devprof.compile_event = record
        return self

    def __exit__(self, *exc):
        from bluesky_tpu_torch.obs import devprof
        devprof.compile_event = self._orig

    def ms(self, kind):
        return [round(m, 3) for k, m in self.events if k == kind]


def scale_chunks(tag, state, cfg, n_ac, timed):
    """Drive ``state`` as ``bench.run_one`` drives JAX's: the sort
    refresh, then a 20-step chunk through ``run_steps_edge``, once to warm
    up and ``timed`` times more, the launch counts set to 0 just before
    and read just after.  Fails unless the state stays finite, conflicts
    are found and the backend's kernels (MVP) are launched, and nothing
    else is.  Logs the last chunk's ms and aircraft-steps/s, the peak
    memory (and the memory held when the run started) and the capture
    ms.  Returns ``(state, launches, info)``."""
    import torch
    from bluesky_tpu_torch.core import asas, graph, step as stepmod
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched
    impl = asas.impl_for_backend(cfg.cd_backend)
    names = {"sparse": ("cd_sched._sched_kernel", "cd_pallas._kernel_resume"),
             "pallas": ("cd_pallas._kernel",)}[cfg.cd_backend]
    graph.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    chunk_ms = []
    with CaptureLog() as caps:
        for _ in range(1 + timed):
            t0 = time.perf_counter()
            state = asas.refresh_spatial_sort(state, cfg.asas,
                                              block=cfg.cd_block, impl=impl)
            state = stepmod.run_steps_edge(state, cfg, CHUNK)[0]
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
    counts = dict(cd_pallas.LAUNCHES, **cd_sched.LAUNCHES)
    launches = {k: v for k, v in launch_counts().items() if k in names}
    want = {cd_pallas.launch_key(WRAPPERS[k], "mvp") for k in names}
    others = {k: v for k, v in counts.items() if v and k not in want}
    peak = torch.cuda.max_memory_allocated()
    if not bool(stepmod.state_finite(state)):
        raise AssertionError(f"{tag}: non-finite state")
    nconf, nlos = int(state.asas.nconf_cur), int(state.asas.nlos_cur)
    if nconf <= 0:
        raise AssertionError(f"{tag}: no conflicts detected")
    missing = [k for k, v in launches.items() if v < 1]
    if missing or others:
        raise AssertionError(f"{tag}: launched {others}, never {missing}")
    info = dict(chunk_ms=chunk_ms[-1], rate=n_ac * CHUNK / chunk_ms[-1] * 1e3,
                peak_gib=peak / 2**30, held_gib=held / 2**30,
                nconf=nconf, nlos=nlos,
                capture_ms=caps.ms("capture"),
                capture_warmup_ms=caps.ms("capture_warmup"))
    log(f"{tag}: chunk ms {[round(m, 2) for m in chunk_ms]} (the first the "
        f"warm-up), the last {info['chunk_ms']:.2f} ms = {info['rate']:.4g} "
        f"aircraft-steps/s; nconf {nconf}, nlos {nlos}; launches "
        f"{launches}; peak memory {info['peak_gib']:.3f} GiB, "
        f"{info['peak_gib'] - info['held_gib']:.3f} above the "
        f"{info['held_gib']:.3f} GiB held at the start (the state and "
        f"what earlier phases keep); graph "
        f"captures {info['capture_ms']} ms (warm-ups "
        f"{info['capture_warmup_ms']} ms)")
    return state, launches, info


def occupied_rows(x):
    """Row blocks of the slabs ``x.packed`` holding an active aircraft
    (numpy, ascending)."""
    from bluesky_tpu_torch.ops.cd_pallas import _IDX
    return np.flatnonzero(
        (x.packed[:, _IDX["active"], :] > 0.5).any(1).cpu().numpy())


def sample_rows(pool):
    """The row blocks a sampled plain hold runs, of the ascending row ids
    ``pool``: its last ``SCALE_LAST`` (the largest slot offsets) and
    ``SCALE_RANDOM`` more drawn from numpy seed 0, ascending."""
    rng = np.random.default_rng(0)
    pick = rng.choice(pool, min(SCALE_RANDOM, pool.size), replace=False)
    return np.unique(np.concatenate([pool[-SCALE_LAST:], pick]))


def sampled_run(x, rows, kern, plain, **r):
    """A ``measure`` entry held on the row blocks ``rows``: ``kern`` (the
    whole launch; its outputs at ``rows`` compared) and ``plain(rows=)``
    (the plain version of those rows only).  The time is the whole
    launch's; ``plain_ms`` the sampled rows'."""
    import torch
    idx = torch.as_tensor(rows, dtype=torch.long, device=x.packed.device)
    r["extra"] = dict(r.get("extra", {}), plain_rows=int(len(rows)),
                      rows=int(x.packed.shape[0]))
    return dict(r, kern=lambda **kw: [o[idx] for o in kern(**kw)],
                time=kern, plain=lambda: plain(rows=rows))


def sampled_holds(x, runs):
    """Phase 13 (b)'s holds at the 100k shapes (``sparse_path`` and
    ``pallas_path`` past K = 8): each run of ``runs`` held on
    ``sample_rows`` of the occupied row blocks of ``x``
    (``sampled_run``; its ``plain`` takes ``rows``), timed whole.  The
    whole grid of each form is held at K = 8 (phases 4-5) and on the
    check shapes at every K (phase 13 (a))."""
    rows = sample_rows(occupied_rows(x))
    return {name: sampled_run(x, rows, r["kern"], r["plain"],
                              **{k: v for k, v in r.items()
                                 if k not in ("kern", "plain")})
            for name, r in runs.items()}


def sparse_scale_runs(tag, x, p):
    """The sampled ``measure`` entries of the sparse interval's kernels
    on its operands ``x`` (``cd_sched.prepare``): K1 (the segment pass
    with the partner table) on ``sample_rows`` of the occupied row
    blocks, K2 (the overflow rows' pass) and, off the path, K3 on the
    same overflow reach on ``sample_rows`` of the overflow rows (of the
    occupied ones when there is none: K2 then holds empty rows)."""
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched
    occ = occupied_rows(x)
    over = np.flatnonzero(x.overflow.cpu().numpy())
    rows_k1, rows_k2 = sample_rows(occ), sample_rows(over if over.size
                                                      else occ)
    reach_f = x.reach & x.overflow[:, None]
    rf = reach_f.cpu().numpy()
    ln = np.minimum(x.wln.cpu().numpy(), x.wmax)
    seg = segment_tiles(x)
    k1 = cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold, p)
    k2 = cd_pallas.full_grid_resume(x.packed, reach_f, x.pold, p)
    over_tiles = lambda i: np.flatnonzero(rf[i])
    k2_name, k3_name = (f"cd_pallas._kernel_resume/{tag}",
                        f"cd_pallas._kernel/{tag}_overflow")
    return {
        f"cd_sched._sched_kernel/{tag}": sampled_run(
            x, rows_k1,
            lambda **kw: cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax,
                                              x.pold, p, **kw),
            lambda rows: cd_sched.sched_tiles_plain(
                x.packed, x.wst, x.wln, x.wmax, x.pold, p, rows=rows),
            pairs=active_pairs(x, seg), keep=keep_pairs(x, seg, k1[6]),
            bytes=in_out_bytes(x, True) + 2 * x.wst.numel() * 4,
            tiles=int(ln.sum()), reso="mvp",
            extra=item_extra(f"K1 {tag}", x, cd_sched.window_items(
                x.wst, x.wln, x.wmax, x.nb), p, pold=x.pold)),
        k2_name: sampled_run(
            x, rows_k2,
            lambda **kw: cd_pallas.full_grid_resume(x.packed, reach_f,
                                                    x.pold, p, **kw),
            lambda rows: cd_pallas.full_grid_resume_plain(
                x.packed, reach_f, x.pold, p, rows=rows),
            pairs=active_pairs(x, over_tiles),
            keep=keep_pairs(x, over_tiles, k2[6]),
            bytes=in_out_bytes(x, True) + x.nb * x.nb, tiles=int(rf.sum()),
            reso="mvp", extra=dict(item_extra(
                f"K2 {tag}", x, cd_pallas.reach_items(reach_f), p,
                pold=x.pold), overflow_rows=int(x.overflow.sum()))),
        k3_name: sampled_run(
            x, rows_k2,
            lambda **kw: cd_pallas.full_grid(x.packed, reach_f, p, **kw),
            lambda rows: cd_pallas.full_grid_plain(x.packed, reach_f, p,
                                                   rows=rows),
            pairs=active_pairs(x, over_tiles), bytes=in_out_bytes(x, False)
            + x.nb * x.nb, tiles=int(rf.sum()), reso="mvp",
            extra=dict(item_extra(f"K3 {tag} overflow rows", x,
                                  cd_pallas.reach_items(reach_f), p),
                       overflow_rows=int(x.overflow.sum())))}


def scale_operands(state, cfg):
    """The next interval's operands of the stepped sparse state: the
    sorted slabs, windows and partner table (``cd_sched.prepare``) and
    the tile parameters."""
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp
    ac, a, c = state.ac, state.asas, cfg.asas
    n_tot = cd_sched.padded_size(ac.lat.shape[0], 256)
    x = cd_sched.prepare(ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                         ac.gseast, ac.gsnorth, ac.active, a.noreso, c.rpz,
                         c.hpz, c.dtlookahead, a.partners_s[:n_tot],
                         block=256, perm=a.sort_perm)
    mvp = cr_mvp.MVPConfig(rpz_m=c.rpz_m, hpz_m=c.hpz_m,
                           tlookahead=c.dtlookahead)
    p = cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp,
                              c.rpz * c.resofach)
    return x, p, mvp


def log_schedule(tag, x):
    """One line of the sparse schedule of ``x``: row blocks, occupied
    ones, overflow rows, segment, overflow and reachable tiles."""
    ln = np.minimum(x.wln.cpu().numpy(), x.wmax).sum(1)
    rf = int((x.reach & x.overflow[:, None]).sum())
    log(f"{tag}: {x.nb} row blocks ({occupied_rows(x).size} occupied), "
        f"overflow rows {int(x.overflow.sum())}, segment tiles "
        f"{int(ln.sum())} (per row block mean {ln.mean():.4g}, max "
        f"{ln.max()}), overflow tiles {rf}, reachable tiles "
        f"{int(x.reach.sum())}")


def witness_counts(cols, own_ids, p, dev):
    """Float64 brute force: the conflict and LoS counts of the ownships
    ``own_ids`` (caller slots) against the whole fleet of the caller
    columns ``cols`` (lat, lon, trk, gs, alt, vs, gseast, gsnorth,
    active, noreso: float32 on the card), by the tile body's own pair
    math (``cd_pallas.conflict_terms``) on float64 slabs of the same
    float32 inputs, ``WITNESS_CHUNK`` intruders at a time.  Returns
    ``(nconf, nlos, excused)`` [len(own_ids)] each.  ``excused`` counts
    the pairs whose float64 flag hangs on a comparison within
    ``WITNESS_MARGIN`` (relative) of its threshold while none of the
    flag's other comparisons fails clearly: dcpa^2 against R^2, the
    window's ends (the horizontal window taken on both sides of the
    grazing pair) against each other, 0 and the lookahead, the altitude
    gap against the half-height, the distance against R.  Float32 may
    flag those either way."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas, cd_tiled
    lat, lon, trk, gs, alt, vs, gse, gsn, act, noreso = (
        c.double() for c in cols)
    trkrad = torch.deg2rad(trk)
    f = cd_tiled.precompute_trig(lat, lon)
    f.update(u=gs * torch.sin(trkrad), v=gs * torch.cos(trkrad), alt=alt,
             vs=vs, gse=gse, gsn=gsn, trk=trk, active=act, noreso=noreso,
             tr=torch.ones_like(lat))
    slab = torch.stack([f[k] for k in cd_pallas._FIELDS])      # [NF, n]
    own_ids = torch.as_tensor(own_ids, dtype=torch.long, device=dev)
    own = slab[:, own_ids]
    n = slab.shape[1]
    m, tl, r2 = WITNESS_MARGIN, p.tlookahead, p.rpz * p.rpz
    nconf = torch.zeros(own_ids.numel(), dtype=torch.int64, device=dev)
    nlos, excused = torch.zeros_like(nconf), torch.zeros_like(nconf)
    near = lambda a, b, scale: (a - b).abs() <= m * scale
    for j0 in range(0, n, WITNESS_CHUNK):
        ids = torch.arange(j0, min(j0 + WITNESS_CHUNK, n), device=dev)
        t = cd_pallas.conflict_terms(own, slab[:, ids], own_ids, ids, p)
        nconf += t["swconfl"].sum(0)
        nlos += t["swlos"].sum(0)
        dcpa2, dist, dalt = t["dcpa2"], t["dist"], t["dalt"].abs()
        dt = torch.sqrt(torch.clamp_min(r2 - dcpa2, 0.0)) * t["rvrel"]
        hi, lo = t["tcrosshi"], t["tcrosslo"]
        tin = torch.maximum(torch.minimum(hi, lo), t["tcpa"] - dt)
        tout = torch.minimum(torch.maximum(hi, lo), t["tcpa"] + dt)
        conds = (                    # (holds, within the margin)
            (dcpa2 < r2, near(dcpa2, r2, dist * dist + r2)),
            (tin <= tout, near(tin, tout, tin.abs() + tout.abs() + tl)
             | near(dalt, p.hpz, p.hpz)),
            (tout > 0.0, near(tout, 0.0, tout.abs() + tl)),
            (tin < tl, near(tin, tl, tin.abs() + tl)))
        los = ((dist < p.rpz, near(dist, p.rpz, p.rpz)),
               (dalt < p.hpz, near(dalt, p.hpz, p.hpz)))

        def unsure(cs):
            fails = torch.zeros_like(dist, dtype=torch.bool)
            edge = torch.zeros_like(fails)
            for holds, close in cs:
                fails |= ~holds & ~close
                edge |= close
            return edge & ~fails
        excused += ((unsure(conds) | unsure(los)) & t["pairmask"]).sum(0)
    return nconf, nlos, excused


def scale_witness(tag, cols, p, nconf_k, nlos_k, slot_of, dev):
    """Hold the kernels' per-ownship conflict and LoS counts (``nconf_k``
    / ``nlos_k`` [slots], read at ``slot_of[caller]``) on
    ``WITNESS_OWN`` sampled ownships against ``witness_counts``: the
    ``SCALE_LAST`` active aircraft with the highest slots and the
    ``SCALE_LAST`` highest active caller slots, the rest drawn from numpy
    seed 0.  A difference must be covered by the ownship's excused
    pairs.  Logs the pairs excused and the ownships that needed them."""
    act = cols[8].cpu().numpy()
    slots = slot_of.cpu().numpy()
    live = np.flatnonzero(act)
    top_slot = live[np.argsort(slots[live])[-SCALE_LAST:]]
    top_id = live[-SCALE_LAST:]
    rest = np.setdiff1d(live, np.concatenate([top_slot, top_id]))
    rng = np.random.default_rng(0)
    own = np.unique(np.concatenate([
        top_slot, top_id,
        rng.choice(rest, WITNESS_OWN - 2 * SCALE_LAST, replace=False)]))
    t0 = time.perf_counter()
    wc, wl, ex = (a.cpu().numpy() for a in witness_counts(cols, own, p, dev))
    ms = (time.perf_counter() - t0) * 1e3
    kc = nconf_k.reshape(-1).cpu().numpy()[slots[own]].astype(np.int64)
    kl = nlos_k.reshape(-1).cpu().numpy()[slots[own]].astype(np.int64)
    dc, dl = np.abs(kc - wc), np.abs(kl - wl)
    bad = (dc + dl) > ex
    log(f"{tag} witness: {own.size} ownships against {act.size} slots in "
        f"float64 ({ms:.0f} ms): conflicts {int(wc.sum())} (kernels "
        f"{int(kc.sum())}), LoS {int(wl.sum())} (kernels {int(kl.sum())}); "
        f"{int(ex.sum())} pairs excused on {int((ex > 0).sum())} ownships, "
        f"{int(((dc + dl) > 0).sum())} ownships needed them "
        f"({int((dc + dl).sum())} pairs)")
    if bad.any():
        i = np.flatnonzero(bad)[:8]
        raise AssertionError(
            f"{tag} witness: ownships {own[i].tolist()} count conflicts "
            f"{kc[i].tolist()} / LoS {kl[i].tolist()} on the card against "
            f"{wc[i].tolist()} / {wl[i].tolist()} in float64, beyond "
            f"their {ex[i].tolist()} excused pairs")
    return dict(witness_ownships=int(own.size),
                witness_excused=int(ex.sum()),
                witness_needed=int(((dc + dl) > 0).sum()))


def scale_global(dev, errs, regs):
    """Phase 21 (a)-(c): ``global_scene``'s million aircraft, sparse then
    pallas (block 256, MVP, K = 8), each a warm-up chunk and three timed
    ones (``scale_chunks``), the interval and the sort refresh timed
    alone; then, on the stepped sparse state's next interval, each
    launched kernel held on sampled row blocks against its plain version
    and timed, the sparse and pallas CD equal in flags, per-ownship
    counts, ``nconf`` and ``nlos``, and both against the float64
    witness.  Returns the kernels JSON entries."""
    import torch
    from bluesky_tpu_torch.core import asas
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cd_tiled
    # what earlier phases left in reference cycles goes first, so that
    # the peak is this fleet's
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state, cfg = global_scene(dev)
    torch.cuda.synchronize()
    log(f"scale global: {SCALE_GLOBAL} aircraft in {SCALE_GLOBAL} slots "
        f"built in {time.perf_counter() - t0:.2f} s")
    state, l_sparse, i_sparse = scale_chunks("scale global sparse", state,
                                             cfg, SCALE_GLOBAL, 3)
    time_layers("scale global sparse", {
        "ASAS interval": lambda: asas.update_tiled(state, cfg.asas,
                                                   block=256, impl="sparse"),
        "sort refresh": lambda: asas.refresh_spatial_sort(
            state, cfg.asas, block=256, impl="sparse")})
    snap = state_copy(state)
    cfg_p = cfg._replace(cd_backend="pallas")
    state, l_pallas, i_pallas = scale_chunks("scale global pallas", state,
                                             cfg_p, SCALE_GLOBAL, 3)
    time_layers("scale global pallas", {
        "ASAS interval": lambda: asas.update_tiled(state, cfg_p.asas,
                                                   block=256, impl="pallas"),
        "sort refresh": lambda: asas.refresh_spatial_sort(
            state, cfg_p.asas, block=256, impl="pallas")})
    del state
    gc.collect()

    # (c) the next interval of the stepped sparse state, both backends
    x, p, mvp = scale_operands(snap, cfg)
    log_schedule("scale global sparse", x)
    ac, a, c = snap.ac, snap.asas, cfg.asas
    cols = [ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, a.noreso]
    rd_s = cd_sched.detect_resolve_sched(
        *cols, c.rpz, c.hpz, c.dtlookahead, mvp,
        partners=a.partners_s[:x.n_tot], resume_rpz_m=c.rpz * c.resofach,
        block=256, perm=a.sort_perm)[0]
    perm_m = cd_tiled.spatial_permutation(ac.lat, ac.lon, ac.active)
    rd_p = cd_pallas.detect_resolve_pallas(
        *cols, c.rpz, c.hpz, c.dtlookahead, mvp, block=256, perm=perm_m)
    for k in ("inconf", "nconf", "nlos"):
        if not torch.equal(getattr(rd_s, k), getattr(rd_p, k)):
            raise AssertionError(f"scale global: sparse and pallas {k} "
                                 "differ")
    outs_s = cd_sched.run_kernels(x, p)
    g = lambda t: cd_tiled.take(t, perm_m.long())
    xp = cd_pallas.prepare(*(g(t) for t in cols), c.rpz, c.dtlookahead,
                           block=256)
    k3 = cd_pallas.full_grid(xp.packed, xp.reach, p)
    inv_m = cd_tiled.invert(perm_m.long())
    per_own = lambda o, slot: o.reshape(-1)[slot]
    for j, what in ((6, "conflict"), (7, "LoS")):
        if not torch.equal(per_own(outs_s[j], x.perm.long()),
                           per_own(k3[j], inv_m)):
            raise AssertionError(f"scale global: sparse and pallas "
                                 f"per-ownship {what} counts differ")
    log(f"scale global: sparse and pallas agree on the next interval: "
        f"nconf {int(rd_s.nconf)}, nlos {int(rd_s.nlos)}, ownships in "
        f"conflict {int(rd_s.inconf.sum())}, every ownship's counts")
    extra = scale_witness("scale global", cols, p, outs_s[6], outs_s[7],
                          x.perm, dev)

    # the sampled plain holds and the timings of every launched form
    runs = sparse_scale_runs("scale_global", x, p)
    if not int(x.overflow.sum()):   # no overflow row: no K3 tile to hold
        runs.pop("cd_pallas._kernel/scale_global_overflow")
    rows_p = sample_rows(occupied_rows(xp))
    rh = xp.reach.cpu().numpy()
    runs["cd_pallas._kernel/scale_global"] = sampled_run(
        xp, rows_p, lambda **kw: cd_pallas.full_grid(xp.packed, xp.reach, p,
                                                     **kw),
        lambda rows: cd_pallas.full_grid_plain(xp.packed, xp.reach, p,
                                               rows=rows),
        pairs=active_pairs(xp, lambda i: np.flatnonzero(rh[i])),
        bytes=in_out_bytes(xp, False) + xp.nb * xp.nb, tiles=int(rh.sum()),
        reso="mvp", extra=item_extra("K3 scale_global", xp,
                                     cd_pallas.reach_items(xp.reach), p))
    log(f"scale global pallas: {xp.nb} row blocks, reachable tiles "
        f"{int(rh.sum())} (per row block mean {rh.sum(1).mean():.4g}, max "
        f"{rh.sum(1).max()})")
    launches = {f"{k}/scale_global": v
                for k, v in dict(l_sparse, **l_pallas).items()}
    launches.setdefault("cd_pallas._kernel/scale_global_overflow", 0)
    for r in runs.values():
        r["extra"].update(extra)
    for name, info in (("cd_sched._sched_kernel/scale_global", i_sparse),
                       ("cd_pallas._kernel_resume/scale_global", i_sparse),
                       ("cd_pallas._kernel/scale_global", i_pallas)):
        runs[name]["extra"].update({f"path_{k}": v for k, v in info.items()})
    report = report_kernels(runs, launches, errs, regs)
    del snap, x, xp, outs_s, k3
    gc.collect()
    return report


def scale_regional(dev, errs, regs):
    """Phase 21 (d): ``SCALE_REGIONAL`` aircraft of ``bench_columns``'
    230 nm circle (``bench_scene``), sparse, block 256,
    MVP, K = 8: a warm-up chunk and two timed ones, the interval timed
    alone, then K1, K2 and (off the path) K3 on the overflow rows held on
    sampled row blocks against their plain versions and timed.  Fails
    unless the schedule has overflow rows.  Returns the kernels JSON
    entries."""
    import torch
    from bluesky_tpu_torch.core import asas
    n_ac, nmax = SCALE_REGIONAL
    t0 = time.perf_counter()
    state, cfg = bench_scene(dev, n_ac, nmax, "regional")
    torch.cuda.synchronize()
    log(f"scale regional: {n_ac} aircraft in {nmax} slots built in "
        f"{time.perf_counter() - t0:.2f} s")
    state, launches, info = scale_chunks("scale regional sparse", state, cfg,
                                         n_ac, 2)
    time_layers("scale regional sparse", {
        "ASAS interval": lambda: asas.update_tiled(state, cfg.asas,
                                                   block=256, impl="sparse")})
    x, p, _ = scale_operands(state, cfg)
    log_schedule("scale regional sparse", x)
    if not int(x.overflow.sum()):
        raise AssertionError("scale regional: no overflow row, so the "
                             "overflow pass went untested")
    runs = sparse_scale_runs("scale_regional", x, p)
    launches = {f"{k}/scale_regional": v for k, v in launches.items()}
    launches["cd_pallas._kernel/scale_regional_overflow"] = 0
    for name in ("cd_sched._sched_kernel/scale_regional",
                 "cd_pallas._kernel_resume/scale_regional"):
        runs[name]["extra"].update({f"path_{k}": v for k, v in info.items()})
    report = report_kernels(runs, launches, errs, regs)
    del state, x
    gc.collect()
    return report


def scale_phase(dev, errs, regs):
    """Phase 21: ``scale_global`` and ``scale_regional``, each logging its
    seconds."""
    report = []
    for part in (scale_global, scale_regional):
        t0 = time.perf_counter()
        report += part(dev, errs, regs)
        log(f"{part.__name__}: {time.perf_counter() - t0:.1f} s")
    return report


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bluesky_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    # a run still going near the 1,200 s limit prints where each of its
    # threads is, to standard error
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    msgs = _cuda.build_all(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for src, m in msgs.items():
        log(f"build {src}:\n{m.strip()}")
    for src in _cuda.SIGNATURES:
        _cuda.load(src)
    regs = kernel_registers(msgs["cd_tiles.cu"])

    errs = {form_name(k, r): 0.0 for k, r in FORMS}
    log_card("before the checks and timings")
    t0 = time.perf_counter()
    k2_regional = check_kernels(dev, errs)
    check_pallas_kernels(dev, errs)
    check_width_kernels(dev, errs, 8, ("eby", "swarm"))
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    report = []
    for path, more in ((sparse_path, (k2_regional,)), (pallas_path, ())):
        t0 = time.perf_counter()
        report += path(dev, errs, regs, *more)
        log(f"{path.__name__}: {time.perf_counter() - t0:.1f} s")
        log_card(f"after {path.__name__}")
    for backend in ("sparse", "pallas"):
        for method in ("EBY", "SWARM", "SSD"):
            t0 = time.perf_counter()
            report += resolver_path(dev, errs, regs, backend, method)
            log(f"resolver_path {backend} {method}: "
                f"{time.perf_counter() - t0:.1f} s")
        log_card(f"after the {backend} resolver paths")
    t0 = time.perf_counter()
    nores_report = noresume_phase(dev, errs, regs)
    log(f"noresume_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after noresume_phase")
    for path in (dense_path, dense_resolvers, tiled_path, check_dense_tiled,
                 check_dense_tiled_resolvers, graph_phase):
        t0 = time.perf_counter()
        path(dev)
        log(f"{path.__name__}: {time.perf_counter() - t0:.1f} s")
        log_card(f"after {path.__name__}")
    t0 = time.perf_counter()
    sim_launches = sim_phase(dev)
    log(f"sim_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after sim_phase")
    t0 = time.perf_counter()
    world_report = worlds_phase(dev, errs, regs, scale=WORLDS_SCALE)
    log(f"worlds_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after worlds_phase")
    t0 = time.perf_counter()
    diff_phase(dev)
    log(f"diff_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after diff_phase")
    t0 = time.perf_counter()
    kwide_report = kwide_phase(dev, errs, regs)
    log(f"kwide_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after kwide_phase")
    t0 = time.perf_counter()
    shard_report = shard_phase(dev, errs, regs)
    log(f"shard_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after shard_phase")
    t0 = time.perf_counter()
    entry_launches = entry_phase(dev)
    log(f"entry_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after entry_phase")
    t0 = time.perf_counter()
    fabric = fabric_phase(dev)
    log(f"fabric_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after fabric_phase")
    t0 = time.perf_counter()
    epoch = epoch_phase(dev)
    log(f"epoch_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after epoch_phase")
    t0 = time.perf_counter()
    epoch.update(plugins_phase(dev))
    log(f"plugins_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after plugins_phase")
    t0 = time.perf_counter()
    ui_phase(dev)
    log(f"ui_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after ui_phase")
    t0 = time.perf_counter()
    scale_report = scale_phase(dev, errs, regs)
    log(f"scale_phase: {time.perf_counter() - t0:.1f} s")
    log_card("after scale_phase")
    for entry in report:
        entry["sim_launches"] = sim_launches[entry["name"]]
    report += (world_report + kwide_report + shard_report + nores_report
               + scale_report)
    for entry in report:
        entry["entry_launches"] = entry_launches.get(entry["name"], 0)
        entry["fabric_launches"] = fabric.get(entry["name"], 0)
        for col, counts in epoch.items():
            entry[col] = counts.get(entry["name"], 0)
    missing = ({form_name(k, r) for k, r in FORMS}
               | {nores_name(k, r) for r in RESOS
                  for k in ("cd_sched._sched_kernel", "cd_pallas._kernel")}
               | set(SCALE_FORMS)) - {e["name"] for e in report}
    if missing:
        raise AssertionError(f"kernel forms never measured: {sorted(missing)}")

    print(json.dumps({"kernels": report}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
