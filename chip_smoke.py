#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one informative line; any failure exits nonzero):

1. environment: torch and CUDA versions, the card's name and power limit;
   a GPU is required (there is no CPU route);
2. build: the CUDA kernels from ``event_based_optical_flow_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. kernel vs plain version at the main path's shape (the first 30 000-event
   window of configs/synthetic_mvsec_geometry.yaml, 260x346, a random smooth
   flow of a few px), forward images and the flow gradient, in float64 and
   float32; a second float32 call must give the same bits, and both must
   equal the exact models of their bits (``fused_iwe_fixed_reference``,
   ``fused_iwe_bwd_ordered_reference`` on the CPU copies of the inputs:
   max|err| 0; so do K3's tangent (``fused_iwe_jvp_fixed_reference``) and
   K4 in ``[check]`` and ``[voxel-check]``, the batched forward, backward,
   tangent and HVP backward in ``[fleet-check]``, and K8 at each of its
   launch configurations in ``[vote-check]`` (``bilinear_vote_fixed_reference``));
4. objective: the finest scale's whole objective and gradient on the card
   (float64 and float32) against the plain version on the CPU (float64),
   and the float32 value and gradient again, bit for bit;
5. timing: kernel and plain version, forward and backward, CUDA events;
   then K8, the standalone vote: ``[vote-check]`` holds it to its plain
   version at the main path's three shapes, the finest scale's init-sweep
   call on the first window (the real ``[P, K, C, 4]`` batch, recorded from
   a sweep), the DSEC path's scale-2 sweep call (112x160 patches, the
   opted-in shared memory) and a full-frame metric vote, in float64 and
   float32 (a second float32 call must give the same bits); ``[vote-time]``
   times it, the plain version and one deterministic ``index_add`` of its
   corner terms;
6. the slice: the port's eval loop (the function its CLI runs) on
   configs/synthetic_mvsec_geometry.yaml, frame 0 (``MVSEC_LAST_FRAME``),
   fresh output dir, chained (``optimizer.chain``'s default: every Newton
   evaluation replayed from a CUDA graph, ``solver/graphs.py``); asserts
   kernel launches, finite EPE clearly below the zero-flow EPE, finite
   PRED_FWL, one metric line per frame; then frame 0 once more in a fresh
   run with the loop (``chain: false``, eager evaluations), which must
   reproduce the chained run's metrics, per-scale losses, host syncs and
   launches bit for bit (the solve on the card is deterministic, so this
   run's verdict is every run's); ``[chain]`` prints both runs' seconds,
   syncs and peak device memory beside the card's name and power limit.  The
   slice sets the synthetic
   scene's ``data.pattern`` to ``dots``: the config's default lattice scene
   aliases translations by its period (CMax itself, in the original
   reference too, lands ~20 px off there), so no solver beats zero flow on
   it and the EPE check would test the scene, not the port.  ``[viz-check]``
   then votes frame 0's three visualization IWEs (the window's events as
   they are, warped by the solved motion to the window's middle, warped by
   a random smooth GT) through K8 and the plain vote: K8's float images
   equal their exact model, the uint8 images (clipped as the visualizer
   clips them) differ from the plain vote's by at most 1 level, and the
   solver's own images are K8's;
7. the analytic HVP path: the solver and optimizer blocks of
   configs/dsec_zurich_city.yaml (analytic Gauss-Newton HVP on the finest
   scale, central FD on the coarse scales over a stride-4 event subsample,
   two central-FD polish iterations, the per-component step clip) on the
   synthetic loader at DSEC geometry (480x640, 300 000-event windows;
   ``DSEC_DATA``).  ``[check]`` holds the tangent (K3) and HVP-backward
   (K4) kernels to their plain versions at the first window's shape,
   ``[hvp]`` the finest scale's whole staged HVP on the card to the plain
   version on the CPU, ``[time]`` times K3/K4, then frame 0 through the
   CLI's eval loop (EPE, PRED_FWL, K3/K4 launched on the finest scale only,
   coarse scales on the subsample) and frame 0 again with the loop, bit
   for bit (``[dsec-repeat]``, ``[chain]``);
8. the time-aware path: the solver and optimizer blocks of
   configs/mvsec_indoor_burgers.yaml (Burgers flow voxel, 10 time bins, t0
   in the middle, FD HVP) on the MVSEC slice's synthetic data block
   (``ta_config``).  ``[voxel-check]`` holds the voxel kernels (K5 forward
   and backward, K6 tangent and HVP backward) to their plain versions at
   the first window's shape, ``[voxel-objective]`` / ``[voxel-hvp]`` the
   finest scale's objective with its gradient through the Burgers chain
   and its staged Gauss-Newton HVP on the card to the CPU, ``[voxel-time]``
   times K5/K6, then, with the coarse scales cut to ``TA_COARSE_MAX_ITER``
   Newton iterations, ``[ta-frame]`` frame 0 through the CLI's eval loop
   (EPE, PRED_FWL through the voxel, K5 launched on every scale),
   ``[ta-analytic-frame]`` frame 0 with ``optimizer.hvp_mode: analytic``
   (K6 launched on the finest scale only), and ``[ta-repeat]`` the FD
   frame 0 again with the loop, bit for bit (``[chain]``);
9. the fleet path: ``solver.method: fleet_pyramidal_patch_contrast_maximization``
   with ``data.fleet_batch`` frames per lockstep Newton-CG, ``hvp_mode:
   analytic`` (``fleet_config``), chained (the fleet chain: one init sweep
   per finer scale for the whole batch, every lockstep evaluation replayed
   from a CUDA graph).  ``[fleet-check]`` holds the batched kernels (K7:
   the dense and voxel forward, backward, tangent and HVP backward with a
   frame index) to their batched plain versions on the optimization
   windows of frames 0..3, and each frame's output to the single-frame
   kernel's on that frame alone, bit for bit; ``[fleet-time]`` times them;
   ``[fleet-graph-check]`` one scale's lockstep solve (FD below the finest
   scale, analytic on it) from a batch's staged graphs against the same
   solve with eager evaluations, bit for bit; ``[fleet-frame]`` solves
   frames 0..3 as one chained batch of 4 on the MVSEC slice's blocks
   through the CLI's fleet eval loop (batched K1/K2 on every scale, K3/K4
   on the finest only, K8 in one sweep call per finer scale; EPE per
   frame; ``warm_start: batch``, whose first batch is cold),
   ``[fleet-repeat]`` the same batch from a fresh solver, bit for bit,
   ``[fleet-loop]`` the batch with the loop (``chain: false``: a sweep per
   frame, so other draws; EPE per frame; ``[chain]`` prints both runs'
   seconds per frame, syncs and peak memory), ``[fleet-warm]`` frames
   4..7 through the same loop resuming the checkpoint of ``[fleet-frame]``
   (every frame warm from frame 3's solution), and ``[fleet-ta-frame]``
   frames 0..1 as one chained batch of 2 on the time-aware blocks, coarse
   scales cut to ``TA_COARSE_MAX_ITER`` Newton iterations (batched K5 on
   every scale, K6 on the finest only).  The fleet's cold starts draw from
   ``FLEET_SOLVER_SEED``.  The fleet reads no ``ind1``/``ind2``: it is
   handed the first eval timestamps it solves;
10. serving: the HTTP server (``serve.FlowServer``) on ``127.0.0.1``, an
   ephemeral port, on the card, with the serving defaults, the cold start
   drawn from ``SERVE_SOLVER_SEED``, and ``SERVE_EVENT_COUNT``-event windows.  ``[serve-push]`` posts eval
   windows 0, 1 and 2 of the MVSEC slice's data block (one cold push, two
   warm ones): seconds, EPE through ``estimator.metrics`` against the
   loader's GT (the flow rescaled from the solved window's span to the eval
   window's) beside the zero-flow EPE, the HVP per scale (analytic on every
   scale of a warm push), host syncs, K8 and K1-K4 launches;
   ``[serve-repeat]`` a fresh server's push of window 0 with the loop,
   bit for bit (``[chain]``);
   ``[serve-resume]`` a server started with the state file written after
   push 1 reports 2 windows; ``[serve-wfo]`` a server with
   ``optimizer_config={"warm_finest_only": True, "warm_full_every": 3}``
   takes windows 0..3: the cold push (the default server's bits), two
   finest-only warm pushes (no init sweep: no K8 launch) and the re-anchor
   (every scale);
11. the reference protocol: ``[mvsec-cli]`` runs ``MVSEC_CONFIG`` as shipped
   (260x346, 30 000-event windows, 5 scales, random init, FD HVP, eval_dt
   4) through the CLI's ``main.run`` on an ``indoor_flying1`` recording in
   MVSEC's layout written from the synthetic dots scene
   (``mvsec_fixture``), frames 0 and 1 (the second warm-started): per frame
   seconds, EPE against the zero flow's, PRED_FWL, host syncs, the solve's
   K1/K2/K8 launches; the output files' lines and checkpoint.  The run
   writes the JAX CLI's PNGs (``visualize_every`` 1, as shipped):
   ``[viz-cli]`` lists them per prefix against the JAX CLI's names, gives
   the images' seconds and K8 launches per frame, and reruns the frames
   with ``visualize_every: 0``: the same metrics, losses, syncs and
   launches, its frame seconds beside the images run's;
12. live-camera ingestion: ``[evt2-fwl]`` runs ``EVT2_CONFIG`` as shipped
   (480x640, 300 000-event windows, zero init, 5 scales) with the hot-pixel
   and refractory filters and ``output.save_flow: npz`` through the CLI's
   GT-free loop on a Prophesee RAW EVT2 file (``evt2_fixture``: dots
   translating, hot pixels), ``EVT2_WINDOWS`` windows: PRED_FWL must be
   finite and below 1, and each dumped flow's EPE against the synthesized
   displacement below half the zero flow's;
13. the global motion-model solver (``solver.method:
   global_contrast_maximization``): ``[global-check]`` holds each model's
   objective (2d-translation, 4-param-similarity, 3-rotation) at 260x346 on
   the card to the CPU (value, gradient, the analytic HVP along a random
   direction) and K1-K4 on the model's field to their plain versions and
   exact models; ``[global-sim]`` runs ``GLOBAL_SIM_CONFIG`` as shipped
   (120x152, zero init, the 33-candidate sweep, FD HVP) through the CLI's
   eval loop, frames 0..2 chained (0 cold, 1 and 2 warm), then frame 0 with
   the loop, bit for bit (``[global-sim-repeat]``, ``[chain]``);
   ``[global-rot3d]`` ``GLOBAL_ROT3D_CONFIG`` as shipped, frames 0..2;
   ``[global-rot3d-346]`` its data block at 260x346 (``global_346_data``)
   with ``hvp_mode: analytic`` (K3, K4), frames 0..1.  Per frame: seconds,
   EPE against the zero flow's, PRED_FWL, host syncs, the solve's K1-K4
   launches and the recovered parameters beside the scene's rates in the
   solver's sign convention;
14. the host-driven optimizers (``optimizer_path``): the MVSEC slice's
   frame 0 through the CLI's eval loop with scipy's Newton-CG
   (``optimizer.device: false``, ``[opt-scipy-newton]``), BFGS
   (``[opt-bfgs]``), Adam (``[opt-adam]``) and the sampling optimizer
   (``[opt-sampling]``) and optax's L-BFGS (``[opt-lbfgs]``),
   ``OPT_PHASES``' settings: seconds, EPE against
   the zero flow's (``OPT_GATED`` below half of it, the others below it),
   host syncs, iterations, K1/K2/K8 launches; ``[opt-repeat]`` BFGS again
   from a fresh solver, bit for bit; then ``[trace]``: one chained frame
   (Newton budget ``TRACE_MAX_ITER``) with ``output.trace_dir``, whose
   ``torch.profiler`` trace must name K1's and K8's kernels;
15. the device L-BFGS (``lbfgs_path``, ``optimizer.device_solver: lbfgs``,
   ``LBFGS_MAX_ITER`` iterations per scale): ``[lbfgs]`` the MVSEC slice's
   frame 0 chained, then with the loop in a fresh run, bit for bit
   (``[lbfgs-repeat]``, ``[chain]``); ``[lbfgs-dsec]`` the DSEC path's
   blocks chained, beside the Newton ``[dsec-frame]``'s seconds, syncs and
   launches; ``[fleet-lbfgs]`` the fleet of ``FLEET_BATCH`` with the
   lockstep L-BFGS, chained, twice from fresh solvers, bit for bit.  K1/K2
   (K7's pair in the fleet) and K8, no K3/K4; every frame below
   ``EPE_FRACTION`` x its zero flow's;
16. the cold-start inits (``init_path``): ``[init-grid]`` for
   ``grid-best`` and ``global-best`` the sweep of the MVSEC slice's frame
   0 at the coarsest scale as the solver runs it (chunks of
   ``GRID_SWEEP_CHUNK`` candidates through K7) and with one K1 per
   candidate (seconds, launches, peak memory of each), against the plain
   version's sweep (the chosen translation, or a tie within ``TOL``),
   then frame 0 with that init through the CLI; ``[init-sampling]`` frame
   0 with ``optuna-sampling``; every frame below ``EPE_FRACTION`` x its
   zero flow's;
17. the EV-FlowNet path (``dnn_path``): ``[dnn-check]`` on the first
   training batch of ``DNN_CONFIG`` (64x80, batch 2, 20 000 events) and of
   ``dnn_346_config`` (256x336, 30 000 events: the signed voxel votes and
   the finest loss votes on K8's global sums), float64 and float32: the voxel grids (one K8 launch, polarity-signed weights) and
   the multi-scale CMax loss with its gradient w.r.t. the four flow heads
   (one K8 launch per scale; the backward a gather, no launch) against the
   plain vote on the same tensors, each K8 call against the exact model of
   its bits (max|err| 0), and the network's forward on the card against
   the CPU from the same converted weights; ``[dnn-train]`` runs
   ``DNN_CONFIG`` as shipped through ``main.run(..., eval_mode=True)`` (300
   steps, then the eval windows): median seconds per step, the first and
   last losses (the mean of the last 10 must be below the first), K8
   launches per step, per-frame AEE beside the zero flow's, peak memory;
   the checkpoint and ``dnn_flow_error.txt`` must exist; ``[dnn-repeat]``
   trains ``DNN_REPEAT_STEPS`` steps twice from the seed: the same losses
   and parameter bits; ``[dnn-346]`` trains ``DNN_346_STEPS`` steps at
   256x336 (``dnn_346_config``: the MVSEC slice's data block, 30 000
   events, the shipped dnn block); ``[dnn-346-witness]`` takes
   ``DNN_WITNESS_STEPS`` float64 steps there on the card and on the CPU:
   the same losses to ``DNN_WITNESS_TOL``; ``[dnn-vote-time]`` times K8 at
   both cells' voxel and finest loss calls;
18. the JAX package's unfused objective's options (``unfused_path``, every
   config the MVSEC slice's with ``solver.outer_padding: PAD``,
   ``unfused_config``): ``[pad-check]`` K1 (bilinear and count), K2, K3, K4,
   K7's four batched kernels on a polarity frame's two-channel table and
   K8 (bilinear and count, the full frame and the finest sweep call's
   shape) at pad ``PAD``, float64 and float32, against their plain
   versions and exact models (max|err| 0), the count vote's tangent and
   HVP term zeros with no launch, K5 and K6 at pad ``PAD``; ``[pad-time]``
   K1-K4 at pad ``PAD`` against pad 0, with bounds; frame 0 from the zero
   start through the CLI's eval loop: ``[pad-frame]`` (K1-K4: the route's
   exact HVP) and ``[polarity-frame]`` (K7), chained and again with the
   loop, bit for bit, and ``[pad-ta-frame]`` (K5, K6, chained), below
   ``EPE_FRACTION`` x the zero flow's; ``[pad-random]`` the pad
   frame from the config's random start and ``[count-frame]`` (the count
   vote and the sampling optimizer) printed ungated with the reason;
   ``[pad-fleet]`` the fleet's frames 0..3 with padding and polarity;
   ``[pad-serve]`` a serving estimator with ``outer_padding`` on window 0;
19. the multi-device layer (``mesh_path``) on meshes that repeat this card
   (``parallel.make_mesh(devices=[cuda:0] * k)``: every partition and every
   reduction runs, on one card): ``[mesh-check]`` each kernel's sharded form
   over ``MESH_SHARDS`` run-aligned shards of the MVSEC slice's first window
   (K1/K5 into per-shard int64 sums, K2/K5's backward per shard, K3/K6 in
   the frame's reduced bound, K4/K6's HVP backward; K7 as one call per data
   shard; K8 per even shard into int64 sums, full frame and sweep-patch
   images), float64 and float32, against the unsharded kernel: max|err| 0,
   with the sharded call's time; ``[mesh-dsec]`` the DSEC config with the
   ``parallel: {data: 1, event: MESH_SHARDS}`` block its own comment names,
   frame 0 through ``main.run(..., mesh=...)``: the EPE, per-scale losses
   and iterations of ``[dsec-frame]`` bit for bit, K1-K4 launched
   ``MESH_SHARDS`` times per single-device launch; ``[mesh-fleet]`` the fleet
   cell's blocks on frames 0..``MESH_FLEET_FRAMES - 1`` with ``parallel:
   {data: 2}`` (the odd batch pads with its last frame): each frame the bits
   of a single-device fleet run of its half from the padded batch's draws;
   ``[mesh-dnn]`` ``dnn_train_step_parallel`` over 2 data devices at 64x80
   against ``dnn_train_step``: ``MESH_DNN_STEPS`` steps in float64 at the
   JAX package's bounds (loss rel 1e-6, parameters atol 1e-5); one step in
   float32 (the JAX test's protocol), its loss at the same bound and its
   averaged gradient to 1e-5 of the largest, its parameters and the later
   steps' printed with the element that moved most apart and both runs'
   gradients there (a gradient below Adam's eps moves its weight by ~lr
   whatever its size, so float32's reordered sums can move one by lr).

``python3 chip_smoke.py --distinct-devices`` (``distinct_main``, a host with
``MESH_SHARDS`` cards or more) builds the kernels and runs ``[mesh-check]``,
``[mesh-dsec]``, ``[mesh-fleet]`` and ``[mesh-dnn]`` with every mesh over
distinct cards, against the same single-device results on cuda:0: the
cross-device copies, device switches and per-device streams that a
repeated card never exercises.

The paths' frames: MVSEC, DSEC and time-aware FD frame 0, each of them
again, the time-aware analytic frame 0, the fleet's frames 0..3 (three
times: chained, again, the loop) and 4..7 (warm), the time-aware fleet's
0..1, the serving path's windows 0..2 (its warm pushes are the on-card
check of the sequential warm start), window 0 again, windows 0..3 of
the warm finest-only server, the MVSEC recording's frames 0..1, the EVT2
recording's windows 0..1, the global configs' frames 0..2 (the
similarity's frame 0 again with the loop) and the 346 cell's 0..1, the
MVSEC slice's frame 0 with each host-driven optimizer (BFGS twice) and
once profiled, with the device L-BFGS (twice) and with each init, the
DSEC path's frame 0 with the device L-BFGS, the L-BFGS fleet's frames
0..3 (twice), the unfused frames 0 (pad and polarity twice, the random
start, count) and serving window 0 with padding, and the
DNN's training runs (300 steps and 7 eval windows, 20 steps twice, 20
steps at 256x336).  Every path runs chained, the sequential
repeats and ``[fleet-loop]`` with the loop.  Each path's run (each
serving push) starts with every kernel launch count at 0 and reads them
at its end (a replayed graph adds the launches its capture counted); the
checks and timings launch outside those runs.  The last two lines of standard
output are one JSON object describing the kernels (each with its
launches on the paths, error, times and bound), then ``{"ok": true,
"device": {...}}``; a ``[wall]`` line before them gives the whole run's
seconds.  The script imports nothing of JAX.
"""

import copy
import dataclasses
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import yaml

CONFIG = "configs/synthetic_mvsec_geometry.yaml"
DSEC_CONFIG = "configs/dsec_zurich_city.yaml"
TA_CONFIG = "configs/mvsec_indoor_burgers.yaml"
# The DSEC config's data block, replaced by the synthetic loader at DSEC
# geometry (the JAX package's DSEC gate, tools/gate_study.py): 300 000-event
# windows, cut from the config's 1 500 000, as the JAX package measured it.
# The scene's seed is 1: the config's `initialize: zero` cold start stalls
# at the coarsest scale, where zero motion is a kinked local minimum of the
# cost on this geometry (in the JAX package's objective too), and the init
# sweep's +-10 px/s box then reaches the quadrant flows of some scenes and
# not of others.  Seed 11 (frame 0 EPE 1.03 vs zero flow 1.79, FD arm
# alike) and seeds 0, 2, 3 missed the EPE rule in at least one frame on an
# H100; seed 1 passed all three (PERF.md, Findings).
DSEC_DATA = {
    "dataset": "synthetic", "sequence": "dsec-geometry", "height": 480, "width": 640,
    "n_events_per_batch": 300_000, "event_rate": 3.0e6, "duration": 1.2, "n_frames": 13,
    "pattern": "dots", "n_dots": 4000, "flow_max": 25.0, "seed": 1, "eval_dt": 1,
    "load_gt_flow": True, "ind1": 0, "ind2": 2,
}
OFFSETS = (0.0, 1.0, 0.5)
# |kernel - plain| <= TOL * max(1, max|plain|): float64 sums the same terms in
# another order and in 2^-36 fixed point (forward); float32 adds the
# plain version's own float32 rounding of its sums (~1e-6 relative per
# sum), bounded with margin
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# a solved frame's EPE must be below this fraction of the zero-flow EPE
EPE_FRACTION = 0.5
# the last eval frame each sequential path solves (frames 0..N), cut to keep
# the whole script well inside its 1200 s limit: a time-aware frame takes ~2
# min on an H100 (host-bound).  The MVSEC path's frame 1 was cut when the
# serving path came in: its warm pushes run the same sequential pyramid from
# the previous window's motion and are the on-card check of the warm start.
MVSEC_LAST_FRAME = 0
DSEC_LAST_FRAME = 0
TA_LAST_FRAME = 0
# K8 launches per init-sweep call (solver/sampling.py): the patches' orig
# images and the two rounds of candidates
VOTES_PER_SWEEP = 3
# frames per lockstep batch of the fleet path: dense, time-aware
FLEET_BATCH = 4
FLEET_TA_BATCH = 2
FLEET_METHOD = "fleet_pyramidal_patch_contrast_maximization"
# The fleet path's solver seed, which draws every frame's cold start.  In a
# fleet every frame starts cold from the config's random init (a uniform
# draw in its +-150 px/s box at the coarsest scale), where the sequential
# slice starts only frame 0 cold.  Such draws often land a frame in a bad
# basin of the coarsest scale: with seed 0, frame 2's draw failed the EPE
# rule on an H100, and the sequential solver given the same draw lands in
# the same basin (PERF.md, Findings).  Seed 14 passed every fleet frame.
FLEET_SOLVER_SEED = 14
# The Newton budget on the coarse scales of every time-aware run: the
# sequential FD frame and its bitwise repeat, the analytic frame and the
# fleet pair (the finest scale keeps the config's 25).  At the full budget
# the FD frame took 113-178 s on an H100, by the host's speed, and the
# analytic frame and the fleet pair ~130 s and ~180 s: with the FD repeat
# at the full budget the whole script took 1024 s of its 1200 s limit.
TA_COARSE_MAX_ITER = 8
# One NVIDIA H100 SXM (NVIDIA's data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores, for each kernel's least time on the card.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
# floating-point operations per event and reference-time offset, counted
# from the kernels' arithmetic in csrc/fused_iwe.cu (warp, corner split,
# weights or their derivatives, fixed-point scaling); the gathers and
# atomics are counted as bytes, not operations
OPS_PER_EVENT_OFFSET = {"fwd": 30, "bwd": 40, "jvp": 45, "hvp_bwd": 40}
# K8 (csrc/vote.cu): per voting event two eps adds, two floors, two
# fractions, two complements, four two-factor corner weights and four
# fixed-point scalings
OPS_PER_VOTE = 20
# the serving path's windows: every pushed window is solved at exactly this
# many events (the MVSEC protocol's window)
SERVE_EVENT_COUNT = 30000
# The serving path's solver seed, which draws the cold push's start (the
# serving default `initialize: random`).  Seed 0's draw lands the cold push
# of window 0 (its ~40 000 events uniformly subsampled to 30 000) in a bad
# coarsest basin on an H100, with either HVP mode and with the window's
# time shifted to 0, while the same draw solves the CLI's window (its last
# 30 000 events); seeds 4 and 5 failed too, seeds 1, 2, 3, 6, 7, 8 passed,
# and seeds 1 and 2 passed the warm pushes of windows 1 and 2 as well
# (tools/screen_serve_seeds.py; PERF.md, Findings).
SERVE_SOLVER_SEED = 1
# The reference protocol's config ([mvsec-cli]) and the raw-camera config
# ([evt2-fwl]), run as shipped apart from the data location, the output dir
# and the frames
MVSEC_CONFIG = "configs/mvsec_indoor_no_timeaware.yaml"
EVT2_CONFIG = "configs/evt2_raw.yaml"
# h5py is not installed on the H100 machines this script has run on
# (`import h5py` raises ModuleNotFoundError), so [mvsec-cli] hands the MVSEC
# loader the datasets of its `_data.hdf5` file through `mvsec_arrays_reader`
# in place of `data.mvsec.h5py_loader`; the CPU tests hold that reader to
# h5py's read of the written file.  Set True where h5py is installed: the
# phase then writes and reads the file itself.
MVSEC_H5PY = False
# the MVSEC fixture: GT frames (indoor_flying1 keeps frames 60.. of them),
# the gray-frame rate, the dots scene's event rate and largest flow (px/s).
# At 30 px/s (at most 3.75 px over an eval_dt 4 window) the integer event
# coordinates make zero flow sharper than the GT flow (GT_FWL 1.02 in a CPU
# rehearsal at half the geometry) and the solve lands off; at 60 px/s
# (zero-flow EPE ~4 px, as the MVSEC-geometry slice's ~3.4) it did not.
MVSEC_FIXTURE = {"n_gt": 68, "frame_hz": 32.0, "event_rate": 300_000.0, "flow_max": 60.0}
MVSEC_FIRST_VALID_GT = 60
# seconds since the epoch of the fixture's first event: MVSEC stamps are
# Unix times, so the loader's float64 timestamps are held at that magnitude
MVSEC_EPOCH = 1.5e9
# the EVT2 fixture: a Gen3 VGA recording of dots translating at (row, col)
# px/s, with hot pixels firing every HOT_PERIOD_US, and the filters'
# settings that remove them (hot_pixel_sigma) and thin bursts (refractory_us)
EVT2_FIXTURE = {"n_dots": 4000, "events": 660_000, "seconds": 0.3, "velocity": (-40.0, 60.0),
                "n_hot": 8, "hot_period_us": 50}
EVT2_FILTERS = {"hot_pixel_sigma": 5.0, "refractory_us": 50}
EVT2_WINDOWS = 2
# The global motion-model solver's shipped configs ([global-sim],
# [global-rot3d]) and their scenes' rates: the similarity scene rotates at
# `omega` rad/s about the image center (the solver's `rot` is its negation),
# the rotation scene's camera at `omega3` (the solver's rot_x..rot_z are
# its negation)
# The EV-FlowNet path: the DNN config as shipped (64x80, 300 steps), the
# repeat's steps, and the steps of the 256x336 cell (the MVSEC slice's data
# block).
DNN_CONFIG = "configs/synthetic_dnn.yaml"
DNN_REPEAT_STEPS = 20
DNN_346_STEPS = 20
# [dnn-346-witness]: float64 Adam steps at 256x336 on the card and on the
# CPU, and how far their losses may part (relative): the card's images are
# K8's fixed-point sums, the CPU's the plain vote's (they differ by ~1e-11
# in float64), and Adam's first steps divide each gradient entry by its own
# magnitude, so an entry near 0 can turn either way
DNN_WITNESS_STEPS = 3
DNN_WITNESS_TOL = 1e-6
GLOBAL_SIM_CONFIG = "configs/synthetic_rotation_global.yaml"
GLOBAL_ROT3D_CONFIG = "configs/synthetic_rotation3d_global.yaml"
GLOBAL_LAST_FRAME = 2
# [global-rot3d-346]: the rotation config at the DAVIS346's 260x346 (MVSEC's
# camera); the dots and the event rate scale by the pixel ratio, so the dot
# density and the events per pixel and second stay the shipped ones; the
# focal falls back to the loader's (H + W) / 2, which keeps the shipped field
# of view (136 px at 120x152); the analytic HVP engages K3 and K4
GLOBAL_346_LAST_FRAME = 1
# [global-check]'s parameter box in the solver's scaled (px/s-equivalent)
# units: over the cell's ~0.034 s solve windows, fields of up to ~10-25 px,
# which send the rotation field's corner events off the image
GLOBAL_CHECK_SPAN = 400.0


def global_346_data(data: dict) -> dict:
    """``data`` (the rotation config's block) at 260x346: ``height``,
    ``width``, ``n_dots`` and ``event_rate`` scaled by the pixel ratio,
    ``focal`` dropped."""
    ratio = (260 * 346) / (data["height"] * data["width"])
    out = {k: v for k, v in data.items() if k != "focal"}
    out.update(height=260, width=346, n_dots=int(round(data["n_dots"] * ratio)),
               event_rate=float(data["event_rate"] * ratio))
    return out


KERNEL_LINES = {"fwd": 986, "bwd": 1092, "jvp": 1637, "hvp_bwd": 1806,
                "voxel_fwd": 1223, "voxel_bwd": 1272, "voxel_jvp": 1941, "voxel_hvp_bwd": 1986,
                "batched_fwd": 1398, "batched_bwd": 1448, "batched_jvp": 1850, "batched_hvp_bwd": 1893,
                "batched_voxel_fwd": 1312, "batched_voxel_bwd": 1356, "batched_voxel_jvp": 2025,
                "batched_voxel_hvp_bwd": 2071}
# the batched dense pair also replaces K9, the same contract on unpacked events
ALSO_REPLACES = {"batched_fwd": "event_based_optical_flow_tpu/ops/pallas_objective_batched.py:71",
                 "batched_bwd": "event_based_optical_flow_tpu/ops/pallas_objective_batched.py:114"}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def environment():
    cuda = torch.version.cuda
    phase("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {cuda}, "
                 f"cuda available: {torch.cuda.is_available()}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (the port's main path runs only on the GPU)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def first_window(config: dict):
    """The eval loop's first optimization window (30 000 events)."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.data import collections

    data_config = config["data"]
    loader = collections[data_config["dataset"]](config=data_config)
    loader.set_sequence(data_config["sequence"])
    ts = loader.eval_frame_time_list()
    ind1, ind2 = loader.time_to_index(ts[0]), loader.time_to_index(ts[data_config["eval_dt"]])
    return loader, port_main._optimization_batch(loader, data_config, ind1, ind2)


def smooth_flow(h: int, w: int, rng) -> np.ndarray:
    """A random smooth displacement field of a few px."""
    from event_based_optical_flow_tpu_torch.ops.interp import _resize_bilinear

    coarse = torch.as_tensor(rng.uniform(-4.0, 4.0, (2, 6, 8)))
    return _resize_bilinear(coarse, (h, w)).numpy()


def cpu_copies(frame):
    """(x, y, dtf, wt) and the bins of ``frame`` on the CPU: the exact
    models run there (the card's own elementwise kernels may contract a
    multiply and an add)."""
    return tuple(getattr(frame, k).cpu() for k in ("x", "y", "dtf", "wt")), \
        None if frame.bins is None else frame.bins.cpu()


def exact_err(got, want) -> float:
    """max|kernel - exact model|: the model on the CPU, so 0 means the same bits."""
    return (got.cpu() - want).abs().max().item() if want.numel() else 0.0


def compare(fi, frame, flow, g, include_orig, offsets, pad=0, count=False):
    """(forward err, backward err or None, forward scale, backward scale,
    whether a second kernel call gave the same bits, max|err| of the
    forward and backward against their exact models); ``pad`` and
    ``count``: the images' outer padding and the count vote (no backward:
    its flow derivative is 0)."""
    ev = (frame.x, frame.y, frame.dtf, frame.wt)
    kw = {"bins": frame.bins, "pad": pad}  # a voxel's time bins, or None for a dense flow
    cev, cbins = cpu_copies(frame)
    ref = fi.fused_iwe_reference(flow, *ev, offsets, include_orig, count=count, **kw)
    got = fi.fused_iwe_fwd(flow, *ev, offsets, include_orig, count=count, **kw)
    torch.cuda.synchronize()
    fwd_err = (got - ref).abs().max().item()
    fwd_scale = max(1.0, ref.abs().max().item())
    same = torch.equal(got, fi.fused_iwe_fwd(flow, *ev, offsets, include_orig, count=count, **kw))
    exact = exact_err(got, fi.fused_iwe_fixed_reference(flow.cpu(), *cev, offsets, include_orig, bins=cbins,
                                                        pad=pad, count=count))
    if not offsets or count:
        return fwd_err, None, fwd_scale, None, same, exact
    gk = g[: ref.shape[0]].contiguous()
    flr = flow.clone().requires_grad_(True)
    (want,) = torch.autograd.grad((fi.fused_iwe_reference(flr, *ev, offsets, include_orig, **kw) * gk).sum(), flr)
    got_d = fi.fused_iwe_bwd(flow, *ev, gk, offsets, include_orig, **kw)
    same = same and torch.equal(got_d, fi.fused_iwe_bwd(flow, *ev, gk, offsets, include_orig, **kw))
    torch.cuda.synchronize()
    exact = max(exact, exact_err(got_d, fi.fused_iwe_bwd_ordered_reference(flow.cpu(), *cev, gk.cpu(), offsets,
                                                                          include_orig, bins=cbins, pad=pad)))
    return (fwd_err, (got_d - want).abs().max().item(), fwd_scale, max(1.0, want.abs().max().item()), same,
            exact)


def cuda_ms(fn, n_warm: int = 5, n_iter: int = 50) -> float:
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def objective_check(config: dict, events: np.ndarray, rng, solv=None, span: float = 15.0) -> str:
    """The finest scale's whole objective (kernel, blur, hybrid cost; for a
    time-aware config the Burgers chain too) and its autograd gradient on
    the card against the plain version on the CPU at float64, on the first
    window at random tile motions of a few px/s.
    float64 on both sides: the sums' order is all that differs (1e-9);
    float32 on the card: its rounding (1e-4 of the value), and for the
    gradient also corner decisions that flip where a warped coordinate
    rounds across a pixel edge (1e-2 of the largest component).  ``solv``:
    the config's solver on the CPU, when the caller has built it; ``span``:
    the motion's box (px/s, or a global model's scaled units)."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents, build_objective, build_orig_iwe

    if solv is None:
        _, solv = port_main.build(config, "cpu")
    spec, where = finest_spec(solv)
    motion = rng.uniform(-span, span, solv.motion_vector_size * solv.n_patch)
    out = {}
    for dev, dtype, rep in (("cpu", torch.float64, 0), ("cuda", torch.float64, 0),
                            ("cuda", torch.float32, 0), ("cuda", torch.float32, 1)):
        frame = FrameEvents.from_numpy(events, dev, dtype, solv.time_bin)
        m = torch.as_tensor(motion, dtype=dtype, device=dev).requires_grad_(True)
        loss, _ = build_objective(spec)(m, build_orig_iwe(spec)(frame), frame)
        (grad,) = torch.autograd.grad(loss, m)
        out[(dev, dtype, rep)] = (loss.item(), grad.double().cpu().numpy())
    l_ref, g_ref = out[("cpu", torch.float64, 0)]
    (l0, g0), (l1, g1) = out[("cuda", torch.float32, 0)], out[("cuda", torch.float32, 1)]
    same = l0 == l1 and np.array_equal(g0, g1)
    g_scale = np.abs(g_ref).max()
    lines = []
    for key, (tol_l, tol_g) in ((("cuda", torch.float64, 0), (1e-9, 1e-9)),
                                (("cuda", torch.float32, 0), (1e-4, 1e-2))):
        l_got, g_got = out[key]
        el, eg = abs(l_got - l_ref) / abs(l_ref), np.abs(g_got - g_ref).max() / g_scale
        ok = el <= tol_l and eg <= tol_g
        lines.append(f"cuda {str(key[1])[6:]}: loss rel err {el:.2e} (tol {tol_l:g}), grad err {eg:.2e} "
                     f"x max|grad| (tol {tol_g:g}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: the objective on the card disagrees with the CPU")
    if not same:
        raise SystemExit("chip_smoke: the float32 objective on the card changed between two calls")
    return (f"{where}, loss {l_ref:.6f} (cpu float64); "
            + "; ".join(lines) + "; float32 repeat same bits: ok")


def finest_spec(solv):
    """(the objective's spec, a label) of a tile solver's finest scale, or
    of a global solver's model."""
    if hasattr(solv, "overload_patch_configuration"):
        solv.overload_patch_configuration(solv.patch_scales - 1)
        return solv._current_spec(), f"scale {solv.current_scale}, {solv.n_patch} tiles"
    return solv._current_spec(), f"{solv.motion_model}, parameters {solv.motion_model_keys} (scaled units)"


def zero_flow_epe(loader, data_config, frame_index: int, solv) -> float:
    """EPE of a zero flow on the same eval window (the metric's masks)."""
    from event_based_optical_flow_tpu_torch.flow.metrics import calculate_flow_error
    from event_based_optical_flow_tpu_torch.ops.iwe import event_mask

    ts = loader.eval_frame_time_list()
    t1, t2 = ts[frame_index], ts[frame_index + data_config["eval_dt"]]
    events = loader.load_event(loader.time_to_index(t1), loader.time_to_index(t2))
    gt = solv.tensor(np.transpose(loader.load_optical_flow(t1, t2), (2, 0, 1)))
    mask = event_mask(solv.tensor(events), solv.image_shape)[None]
    return float(calculate_flow_error(gt[None], torch.zeros_like(gt)[None], mask)["EPE"])


def dsec_config() -> dict:
    """configs/dsec_zurich_city.yaml with its solver and optimizer blocks as
    they are and ``DSEC_DATA`` as its data block."""
    with open(DSEC_CONFIG) as f:
        config = yaml.safe_load(f)
    config["data"] = dict(DSEC_DATA)
    return config


def ta_config() -> dict:
    """The time-aware path: configs/synthetic_mvsec_geometry.yaml's data
    block (no MVSEC recording is in the repository) with the
    solver and optimizer blocks of configs/mvsec_indoor_burgers.yaml as
    they are (Burgers voxel, 10 bins, t0 in the middle)."""
    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    with open(TA_CONFIG) as f:
        burgers = yaml.safe_load(f)
    config["solver"], config["optimizer"] = burgers["solver"], burgers["optimizer"]
    return config


def slice_config(config: dict, last_frame: int, out_dir: str) -> dict:
    """The smoke's slice: frames 0..last_frame of the `dots` scene."""
    run_config = copy.deepcopy(config)
    run_config["data"]["ind2"] = last_frame
    run_config["data"]["pattern"] = "dots"
    run_config["output"]["output_dir"] = out_dir
    return run_config


def scaled_config(scale: float, method: str, out_dir: str, overrides=(), scene: str = "mvsec") -> dict:
    """Frame 0 of the MVSEC slice's scene (``scene: dsec``: the DSEC path's)
    with its height and width scaled by ``scale`` (the crop to multiples of
    16, the event rate and the window's event count by the pixel ratio: the
    same events per pixel), float64 (the JAX package's exact scatter
    backend), ``optimizer.method: method`` and the ``overrides``
    (``SECTION.KEY=VALUE``, YAML values): the configs of
    ``tools/screen_host_optimizers.py`` and ``[pad-random-witness]``."""
    if scene == "dsec":
        config = dsec_config()
    else:
        with open(CONFIG) as f:
            config = yaml.safe_load(f)
    config = slice_config(config, last_frame=0, out_dir=out_dir)
    d, patch = config["data"], config["solver"]["patch"]
    h, w = int(round(d["height"] * scale)), int(round(d["width"] * scale))
    ratio = (h * w) / (d["height"] * d["width"])
    d.update(height=h, width=w, event_rate=d["event_rate"] * ratio,
             n_events_per_batch=int(round(d["n_events_per_batch"] * ratio)), visualize_every=0)
    if scale != 1.0:
        patch.update(crop_height=h // 16 * 16, crop_width=w // 16 * 16)
    config["solver"].update(iwe_backend="scatter", precision="64")
    config["optimizer"]["method"] = method
    for item in overrides:
        path, value = item.split("=", 1)
        *parents, key = path.split(".")
        node = config
        for name in parents:
            node = node[name]
        node[key] = yaml.safe_load(value)
    return config


def frame0_solve(config: dict, dev, draw_seed=None):
    """Frame 0 of ``config`` solved once by the port on ``dev`` as the CLI's
    eval loop solves it, from its configured start, ``draw_seed`` (if given)
    reseeding the init sweep's generator only (the cold start's numpy draws
    stay the config's): (its metrics, the zero flow's EPE, the solver's
    frame stats)."""
    from event_based_optical_flow_tpu_torch import main as port_main

    loader, solv = port_main.build(config, dev)
    if draw_seed is not None:
        solv.generator.manual_seed(int(draw_seed))
    ts = loader.eval_frame_time_list()
    batch, window, gt, seconds = port_main._gather_frame(loader, config["data"], ts[0], ts[config["data"]["eval_dt"]])
    metrics = solv.optimize_with_metrics(batch, gt, seconds, window)[1]
    return metrics, zero_flow_epe(loader, config["data"], 0, solv), solv.last_frame_stats


def run_slice(port_main, config: dict, dev, last_frame: int):
    """(records, output dir, wall seconds, peak device GiB) of the CLI's
    eval loop over frames 0..last_frame, in a fresh output dir."""
    out_dir = tempfile.mkdtemp(prefix="evflow_chip_smoke_")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = port_main.run(slice_config(config, last_frame, out_dir), eval_mode=True, device=dev)
    torch.cuda.synchronize()
    return records, out_dir, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def loop_config(config: dict) -> dict:
    """``config`` with ``optimizer.chain: false``: the per-scale loop, every
    Newton evaluation run eagerly."""
    loop = copy.deepcopy(config)
    loop["optimizer"]["chain"] = False
    return loop


def loop_repeat(port_main, config: dict, dev, records, peak: float, smi: str, name: str, what: str) -> bool:
    """Frame 0 of ``config`` again in a fresh run with the loop (``chain:
    false``): the chained run's metrics, per-scale losses, host syncs and
    kernel launches per scale, bit for bit (``[name]``); then the path's
    ``[chain]`` line: chained and loop seconds of the frame (the chained
    one pays its captures: each run builds a fresh solver), syncs and the
    runs' peak device memory.  Returns whether the bits agree."""
    again, _, _, loop_peak = run_slice(port_main, loop_config(config), dev, last_frame=0)
    a, r = again[0], records[0]
    same = (r["stats"]["chain"] and not a["stats"]["chain"] and a["metrics"] == r["metrics"]
            and all(a["stats"][k] == r["stats"][k] for k in ("loss", "iters", "syncs", "launches")))
    phase(name, f"frame 0 in a fresh run with the loop (chain: false, {a['seconds']:.3f} s): metrics, per-scale "
                f"losses, iterations, host syncs and launches bit for bit the chained run's: "
                f"{'ok' if same else 'FAIL'}")
    phase("chain", f"{what} frame 0 on {smi}: chained {r['seconds']:.3f} s, loop {a['seconds']:.3f} s "
                   f"({a['seconds'] / r['seconds']:.2f}x), host syncs {r['stats']['syncs']} / "
                   f"{a['stats']['syncs']}, peak device memory {peak:.3f} / {loop_peak:.3f} GiB")
    return same


def check_second_order(fi, frame, flow, dflow, g1, g2, tol, names=("K3", "K4"), pad=0):
    """K3 (both ways of emit_value) and K4 (both ways of term_a) against
    their plain versions on the same tensors (K6's two kernels for a voxel
    and the frame's time bins; ``pad``: the images' outer padding):
    (lines, max abs err of the tangent, of the HVP backward without term
    A, all ok)."""
    ev = (frame.x, frame.y, frame.dtf, frame.wt)
    kw = {"bins": frame.bins, "pad": pad}

    def err(got, want):
        torch.cuda.synchronize()
        scale = max(1.0, want.abs().max().item())
        e = (got - want).abs().max().item()
        return e, scale, e <= tol * scale

    img, tan = fi.fused_iwe_jvp(flow, dflow, *ev, OFFSETS, True, **kw)
    ref_img, ref_tan = fi.fused_iwe_jvp_reference(flow, dflow, *ev, OFFSETS, True, **kw)
    tan_only = fi.fused_iwe_jvp(flow, dflow, *ev, OFFSETS, False, **kw)
    value_bits = torch.equal(img, fi.fused_iwe_fwd(flow, *ev, OFFSETS, False, **kw))
    repeat = torch.equal(tan_only, tan) and torch.equal(tan_only, fi.fused_iwe_jvp(flow, dflow, *ev, OFFSETS, False,
                                                                                  **kw))
    (ev_, sv, okv), (et, st, okt) = err(img, ref_img), err(tan, ref_tan)
    cev, cbins = cpu_copies(frame)
    exact = exact_err(tan_only, fi.fused_iwe_jvp_fixed_reference(flow.cpu(), dflow.cpu(), *cev, OFFSETS, False,
                                                                 bins=cbins, pad=pad))
    lines = [f"{names[0]} jvp: value max|err| {ev_:.3e} (scale {sv:.3g}), tangent max|err| {et:.3e} "
             f"(scale {st:.3g}), tol {tol:g} x scale; tangent exact model: max|err| {exact:g}; value == "
             f"fused_iwe_fwd bits: {value_bits}; emit_value=False and a repeat same bits: {repeat}"]
    ok = okv and okt and value_bits and repeat and exact == 0
    errs = {"jvp": et}
    for term_a in (False, True):
        got = fi.fused_iwe_hvp_bwd(flow, dflow, g1, g2, *ev, OFFSETS, term_a, **kw)
        e, sc, good = err(got, fi.fused_iwe_hvp_bwd_reference(flow, dflow, g1, g2, *ev, OFFSETS, term_a, **kw))
        same = torch.equal(got, fi.fused_iwe_hvp_bwd(flow, dflow, g1, g2, *ev, OFFSETS, term_a, **kw))
        exact = exact_err(got, fi.fused_iwe_bwd_ordered_reference(
            flow.cpu(), *cev, g2.cpu(), OFFSETS, False, bins=cbins, pad=pad,
            **({"g1": g1.cpu(), "dflow": dflow.cpu()} if term_a else {})))
        good = good and exact == 0
        extra = ""
        if not term_a:
            k2 = torch.equal(got, fi.fused_iwe_bwd(flow, *ev, g2, OFFSETS, False, **kw))
            extra, same, errs["hvp_bwd"] = f"; == fused_iwe_bwd(g2) bits: {k2}", same and k2, e
        lines.append(f"{names[1]} hvp_bwd term_a={term_a}: max|err| {e:.3e} (scale {sc:.3g}), tol {tol:g} x "
                     f"scale; exact model: max|err| {exact:g}; repeat same bits{extra}: {same}")
        ok = ok and good and same
    return lines, errs, ok


def hvp_check(config: dict, events: np.ndarray, rng, solv=None, span: float = 15.0) -> str:
    """The finest scale's staged analytic HVP (K1 values, K3 tangent, the
    cost's jvp-of-grad, K4, the tile map's transpose; for a time-aware
    config K5, K6 and the Burgers chain's jvp and vjp) on the card against
    the plain version on the CPU at float64: 1e-9 of max|Hp|
    (the sums' order); float32 on the card: 1e-2 of the largest component
    (the gradient's rule: corner decisions that flip under float32
    rounding); a float32 repeat gives the same bits.  ``solv``: the
    config's solver on the CPU, when the caller has built it; ``span``: the
    motion's box (px/s, or a global model's scaled units)."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.solver.objective import (FrameEvents, build_objective_hvp_staged,
                                                                     build_orig_iwe)

    if solv is None:
        _, solv = port_main.build(config, "cpu")
    spec, where = finest_spec(solv)
    size = solv.motion_vector_size * solv.n_patch
    motion, p = rng.uniform(-span, span, size), rng.normal(0.0, 1.0, size)
    prep, hvp = build_objective_hvp_staged(spec)
    out = {}
    for dev, dtype, rep in (("cpu", torch.float64, 0), ("cuda", torch.float64, 0),
                            ("cuda", torch.float32, 0), ("cuda", torch.float32, 1)):
        frame = FrameEvents.from_numpy(events, dev, dtype, solv.time_bin)
        orig = build_orig_iwe(spec)(frame)
        m, pp = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (motion, p))
        out[(dev, dtype, rep)] = hvp(prep(m, orig, frame), m, pp, orig, frame).double().cpu().numpy()
    want = out[("cpu", torch.float64, 0)]
    scale = np.abs(want).max()
    lines = []
    for key, tol in ((("cuda", torch.float64, 0), 1e-9), (("cuda", torch.float32, 0), 1e-2)):
        e = np.abs(out[key] - want).max() / scale
        lines.append(f"cuda {str(key[1])[6:]}: max|err| {e:.2e} x max|Hp| (tol {tol:g}): "
                     f"{'ok' if e <= tol else 'FAIL'}")
        if not e <= tol:
            raise SystemExit("chip_smoke: the analytic HVP on the card disagrees with the CPU")
    if not np.array_equal(out[("cuda", torch.float32, 0)], out[("cuda", torch.float32, 1)]):
        raise SystemExit("chip_smoke: the float32 analytic HVP on the card changed between two calls")
    return (f"{where}, N={len(events)}, max|Hp| {scale:.4g} "
            "(cpu float64); " + "; ".join(lines) + "; float32 repeat same bits: ok")


def sector_bytes(index: torch.Tensor, itemsize: int) -> int:
    """Bytes of the distinct 32-byte sectors that the element offsets
    ``index`` fall in: the least a gather of those elements moves."""
    return 32 * np.unique(index.numpy() * itemsize // 32).size


def bound_times(kind: str, frame, flow: torch.Tensor, pad: int = 0):
    """(bytes time, operations time) in ms, for one call of a kernel on
    ``frame``'s events, the flow
    ``flow`` [2, H, W] (a voxel [T, 2, H, W] with the frame's bins),
    ``OFFSETS`` and images of outer padding ``pad``, counted from these inputs: the event arrays read once; of
    the flow (and the tangent flow) and of the cotangent images only the
    32-byte sectors that this frame's gathers touch (each voting event's
    source pixel in its bin's slice; the four corners of each warped
    position); the images and the flow gradient written whole; over the HBM
    rate.  The operations of ``OPS_PER_EVENT_OFFSET`` for each voting event
    over the float32 rate.  The timed forms: the forward without the orig
    image, the tangent only, the HVP backward without term A (which reads
    neither g1 nor the tangent flow)."""
    frame = {k: getattr(frame, k) for k in ("x", "y", "dtf", "wt", "bins")}
    frame = {k: None if a is None else a.cpu() for k, a in frame.items()}
    flow = flow.cpu()
    h, w = flow.shape[-2:]
    hw, item = h * w, flow.element_size()
    x, y, d, bins = frame["x"], frame["y"], frame["dtf"], frame["bins"]
    voting = (frame["wt"] != 0) & (x > -1) & (x < h) & (y > -1) & (y < w)
    x, y, d = x[voting], y[voting], d[voting]
    b = torch.zeros_like(x, dtype=torch.int64) if bins is None else bins[voting].long().clamp(0, len(flow) - 1)
    at = b * 2 * hw + x.long() * w + y.long()  # .long() truncates toward zero, as the kernels do
    flow_read = sector_bytes(torch.cat([at, at + hw]), item)
    u, v = flow.reshape(-1)[at], flow.reshape(-1)[at + hw]
    corners = []
    hp, wp = h + 2 * pad, w + 2 * pad  # the images' size
    for k, off in enumerate(OFFSETS):
        r0, c0 = torch.floor(x - (d - off) * u).long() + pad, torch.floor(y - (d - off) * v).long() + pad
        for r, c in ((r0, c0), (r0 + 1, c0), (r0, c0 + 1), (r0 + 1, c0 + 1)):
            inside = (r >= 0) & (r < hp) & (c >= 0) & (c < wp)
            corners.append((k * hp * wp + r * wp + c)[inside])
    g_read = sector_bytes(torch.cat(corners), item)
    events = len(frame["x"]) * (4 * item + (0 if bins is None else 4))  # x, y, dtf, wt (, int32 bins)
    images = len(OFFSETS) * hp * wp * item
    grad = flow.numel() * item
    moved = {"fwd": events + flow_read + images, "bwd": events + flow_read + g_read + grad,
             "jvp": events + 2 * flow_read + images, "hvp_bwd": events + flow_read + g_read + grad}[kind]
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = OPS_PER_EVENT_OFFSET[kind] * len(x) * len(OFFSETS) / H100_FP32_FLOPS * 1e3
    return t_bytes, t_ops


def bound(kind: str, frame, flow: torch.Tensor, pad: int = 0):
    """(least milliseconds one H100 needs, what bounds it: "bytes" or
    "operations") for one call of a kernel on ``frame``'s events and
    ``flow`` (``bound_times``)."""
    t_bytes, t_ops = bound_times(kind, frame, flow, pad)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fleet_bound(kind: str, fleet, flows: torch.Tensor, pad: int = 0):
    """``bound`` of one batched call: each frame's bytes and operations
    (``bound_times`` on that frame's events and flow), summed over the
    frames."""
    t_bytes, t_ops = (sum(t) for t in zip(*(bound_times(kind, fleet.frame(b), flows[b], pad)
                                            for b in range(len(fleet)))))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(fi, frame, flow, dflow, g1, g2, names, frames=None, pad=0) -> dict:
    """Float32 times (ms per call: CUDA events, mean of 50 after 5
    warm-up) of the named kernels and their plain versions on one frame
    (on a batch of frames, the batched forms, with ``frames``; images of
    outer padding ``pad``)."""
    ev = (frame.x, frame.y, frame.dtf, frame.wt)
    kw = {"bins": frame.bins, "frames": frames, "pad": pad}
    flr = flow.clone().requires_grad_(True)
    with torch.enable_grad():
        graph = fi.fused_iwe_reference(flr, *ev, OFFSETS, False, **kw)
    calls = {
        "fwd": (lambda: fi.fused_iwe_fwd(flow, *ev, OFFSETS, False, **kw),
                lambda: fi.fused_iwe_reference(flow, *ev, OFFSETS, False, **kw)),
        "bwd": (lambda: fi.fused_iwe_bwd(flow, *ev, g2, OFFSETS, False, **kw),
                lambda: torch.autograd.grad(graph, flr, g2, retain_graph=True)),
        "jvp": (lambda: fi.fused_iwe_jvp(flow, dflow, *ev, OFFSETS, False, **kw),
                lambda: fi.fused_iwe_jvp_reference(flow, dflow, *ev, OFFSETS, False, **kw)),
        "hvp_bwd": (lambda: fi.fused_iwe_hvp_bwd(flow, dflow, g1, g2, *ev, OFFSETS, False, **kw),
                    lambda: fi.fused_iwe_hvp_bwd_reference(flow, dflow, g1, g2, *ev, OFFSETS, False, **kw)),
    }
    times = {}
    for name in names:
        kernel, plain = calls[name]
        times[name], times[f"{name}_plain"] = cuda_ms(kernel), cuda_ms(plain)
    return times


def time_line(smi, times, names, what) -> str:
    return (f"{smi}: float32 {what}: " + "; ".join(
        f"kernel {name} {times[name]:.4f} ms vs plain {times[f'{name}_plain']:.4f} ms" for name in names)
        + " (CUDA events, mean of 50 after 5 warm-up; jvp tangent only, hvp_bwd term_a=False)")


def dsec_path(port_main, fi, dev, smi, rng):
    """Phase 7; returns (launches of the path's run, K3/K4 max abs errors,
    K3/K4 times, their bounds)."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents

    config = dsec_config()
    _, events = first_window(config)
    h, w = config["data"]["height"], config["data"]["width"]
    flow_np, dflow_np = smooth_flow(h, w, rng), smooth_flow(h, w, rng)
    g_np = rng.normal(size=(2, len(OFFSETS), h, w))
    errs = {}
    for dtype in (torch.float64, torch.float32):
        frame = FrameEvents.from_numpy(events, dev, dtype)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
        lines, e, ok = check_second_order(fi, frame, t(flow_np), t(dflow_np), t(g_np[0]), t(g_np[1]),
                                          TOL[dtype])
        for line in lines:
            phase("check", f"{str(dtype)[6:]} N={len(events)} {h}x{w} offsets={OFFSETS}: {line}")
        if not ok:
            raise SystemExit("chip_smoke: K3/K4 disagree with their plain versions")
        if dtype == torch.float32:
            errs = e
    phase("hvp", hvp_check(config, events, rng))

    frame = FrameEvents.from_numpy(events, dev, torch.float32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    times = time_kernels(fi, frame, t(flow_np), t(dflow_np), t(g_np[0]), t(g_np[1]), ("jvp", "hvp_bwd"))
    phase("time", time_line(smi, times, ("jvp", "hvp_bwd"), f"N={len(events)} {h}x{w} offsets={OFFSETS}"))
    bounds = {k: bound(k, frame, t(flow_np)) for k in ("jvp", "hvp_bwd")}

    last = DSEC_LAST_FRAME
    ops.reset_launch_counts()
    records, out_dir, wall, peak = run_slice(port_main, config, dev, last_frame=last)
    launches = ops.launch_counts()
    run_config = slice_config(config, last_frame=last, out_dir=out_dir)
    loader, solv = port_main.build(run_config, dev)
    finest = solv.patch_scales - 1
    failed = []
    for r in records:
        m, st = r["metrics"], r["stats"]
        zero = zero_flow_epe(loader, run_config["data"], r["frame"], solv)
        second_order = {s: (c["jvp"], c["hvp_bwd"]) for s, c in st["launches"].items()}
        ok = (np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(m["PRED_FWL"])
              and all((s == finest) == (jvp > 0 and hb > 0) for s, (jvp, hb) in second_order.items())
              # the coarse scales solved on the stride-4 subsample of the finest's events
              and all(n == (st["events"][finest] + 3) // 4 for s, n in st["events"].items() if s != finest))
        phase("dsec-frame", f"{r['frame']}: {r['seconds']:.3f} s, EPE {m['EPE']:.4f} (zero flow {zero:.4f}), "
                            f"3PE {m['3PE']:.4f}, AE {m['AE']:.4f}, GT_FWL {m['GT_FWL']:.4f}, "
                            f"PRED_FWL {m['PRED_FWL']:.4f}, host syncs {st['syncs']}, "
                            f"Newton iters {st['iters']} (polish included), HVP {st['hvp']}, "
                            f"events {st['events']}, launches {st['launches']}, "
                            f"loss {({s: round(v, 6) for s, v in st['loss'].items()})}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(r["frame"])
    phase("dsec", f"{len(records)} windows in {wall:.2f} s, kernel launches {launches}, out {out_dir}")
    DSEC_NEWTON.update(loss=records[0]["stats"]["loss"], iters=records[0]["stats"]["iters"],
                       scale_launches=records[0]["stats"]["launches"])
    DSEC_NEWTON.update(seconds=records[0]["seconds"], syncs=records[0]["stats"]["syncs"],
                       epe=records[0]["metrics"]["EPE"], launches=solve_launches(records[0]["stats"]))
    same = loop_repeat(port_main, config, dev, records, peak, smi, "dsec-repeat", "DSEC")
    if failed:
        raise SystemExit(f"chip_smoke: DSEC frames {failed}: metrics, K3/K4 launches or subsample wrong")
    if len(records) != last + 1 or 0 in (launches[k] for k in fi.KERNELS):
        raise SystemExit("chip_smoke: the DSEC path did not run its windows through all four kernels")
    if not same:
        raise SystemExit("chip_smoke: the loop's run of DSEC frame 0 did not reproduce the chained result")
    return launches, errs, times, bounds


def smooth_voxel(h: int, w: int, n_bins: int, rng) -> np.ndarray:
    """A random voxel of smooth displacement fields of a few px, one per
    time bin."""
    return np.stack([smooth_flow(h, w, rng) for _ in range(n_bins)])


def ta_run_checks(records, stats_rule, loader, run_config, solv, name) -> list:
    """Print one line per eval frame of a time-aware run; the frames that
    fail the EPE rule, PRED_FWL or ``stats_rule`` (kernel launches per
    scale)."""
    failed = []
    for r in records:
        m, st = r["metrics"], r["stats"]
        zero = zero_flow_epe(loader, run_config["data"], r["frame"], solv)
        voxel = {s: {k: c[k] for k in ("voxel_fwd", "voxel_bwd", "voxel_jvp", "voxel_hvp_bwd")}
                 for s, c in st["launches"].items()}
        ok = (np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(m["PRED_FWL"])
              and stats_rule(st))
        phase(name, f"{r['frame']}: {r['seconds']:.3f} s, EPE {m['EPE']:.4f} (zero flow {zero:.4f}), "
                    f"3PE {m['3PE']:.4f}, AE {m['AE']:.4f}, GT_FWL {m['GT_FWL']:.4f}, "
                    f"PRED_FWL {m['PRED_FWL']:.4f}, host syncs {st['syncs']}, Newton iters {st['iters']}, "
                    f"HVP {st['hvp']}, voxel kernel launches per scale {voxel}, "
                    f"loss {({s: round(v, 6) for s, v in st['loss'].items()})}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(r["frame"])
    return failed


def ta_path(port_main, fi, dev, smi, rng):
    """Phase 8; returns (launches of the path's two runs, K5/K6 max abs
    errors, K5/K6 times, their bounds)."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents

    config = ta_config()
    _, events = first_window(config)
    h, w = config["data"]["height"], config["data"]["width"]
    n_bins = config["solver"]["time_bin"]
    vox_np, dvox_np = smooth_voxel(h, w, n_bins, rng), smooth_voxel(h, w, n_bins, rng)
    g_np = rng.normal(size=(3, len(OFFSETS), h, w))
    errs = {}
    for dtype in (torch.float64, torch.float32):
        frame = FrameEvents.from_numpy(events, dev, dtype, time_bin=n_bins)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
        vox, dvox, g1, g2 = t(vox_np), t(dvox_np), t(g_np[0]), t(g_np[1])
        what = f"{str(dtype)[6:]} N={len(events)} {h}x{w} T={n_bins} offsets={OFFSETS}"
        fe, be, fs, bs, same, exact = compare(fi, frame, vox, t(g_np[2]), False, OFFSETS)
        ok = fe <= TOL[dtype] * fs and be <= TOL[dtype] * bs and same and exact == 0
        phase("voxel-check", f"{what}: K5 fwd max|err| {fe:.3e} (scale {fs:.3g}), bwd max|err| {be:.3e} "
                             f"(scale {bs:.3g}), tol {TOL[dtype]:g} x scale; exact model: max|err| {exact:g}; "
                             f"repeat same bits: {same}: " + ("ok" if ok else "FAIL"))
        lines, e, ok2 = check_second_order(fi, frame, vox, dvox, g1, g2, TOL[dtype], names=("K6", "K6"))
        for line in lines:
            phase("voxel-check", f"{what}: {line}: {'ok' if ok2 else 'FAIL'}")
        if not (ok and ok2):
            raise SystemExit("chip_smoke: K5/K6 disagree with their plain versions")
        if dtype == torch.float32:
            errs = {"voxel_fwd": fe, "voxel_bwd": be, "voxel_jvp": e["jvp"], "voxel_hvp_bwd": e["hvp_bwd"]}
    phase("voxel-objective", objective_check(config, events, rng))
    phase("voxel-hvp", hvp_check(config, events, rng))

    frame = FrameEvents.from_numpy(events, dev, torch.float32, time_bin=n_bins)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    names = ("fwd", "bwd", "jvp", "hvp_bwd")
    times = time_kernels(fi, frame, t(vox_np), t(dvox_np), t(g_np[0]), t(g_np[1]), names)
    phase("voxel-time", time_line(smi, times, names, f"N={len(events)} {h}x{w} T={n_bins} offsets={OFFSETS}"))
    times = {f"voxel_{k}": v for k, v in times.items()}
    bounds = {f"voxel_{k}": bound(k, frame, t(vox_np)) for k in names}

    # the config's FD HVP, coarse scales cut to TA_COARSE_MAX_ITER: K5 on every scale, no K6
    fd = copy.deepcopy(config)
    fd["optimizer"]["coarse_max_iter"] = TA_COARSE_MAX_ITER
    last = TA_LAST_FRAME
    ops.reset_launch_counts()
    records, out_dir, wall, peak = run_slice(port_main, fd, dev, last_frame=last)
    launches = ops.launch_counts()
    run_config = slice_config(fd, last_frame=last, out_dir=out_dir)
    loader, solv = port_main.build(run_config, dev)
    failed = ta_run_checks(
        records, lambda st: all(c["voxel_fwd"] > 0 and c["voxel_bwd"] > 0 and c["voxel_jvp"] == 0
                                for c in st["launches"].values()), loader, run_config, solv, "ta-frame")
    phase("ta", f"{len(records)} windows in {wall:.2f} s, kernel launches {launches}, out {out_dir}")

    # hvp_mode: analytic: K6 (Gauss-Newton) on the finest scale only
    analytic = copy.deepcopy(fd)
    analytic["optimizer"]["hvp_mode"] = "analytic"
    finest = solv.patch_scales - 1
    ops.reset_launch_counts()
    a_records, a_dir, a_wall, _ = run_slice(port_main, analytic, dev, last_frame=0)
    a_launches = ops.launch_counts()
    a_config = slice_config(analytic, last_frame=0, out_dir=a_dir)
    a_failed = ta_run_checks(
        a_records, lambda st: all(c["voxel_fwd"] > 0 and (s == finest) == (c["voxel_jvp"] > 0 and c["voxel_hvp_bwd"] > 0)
                                  for s, c in st["launches"].items()), loader, a_config, solv, "ta-analytic-frame")
    phase("ta-analytic", f"{len(a_records)} window in {a_wall:.2f} s, kernel launches {a_launches}, out {a_dir}")
    same = loop_repeat(port_main, fd, dev, records, peak, smi, "ta-repeat", "time-aware FD")
    if failed or a_failed:
        raise SystemExit(f"chip_smoke: time-aware frames {failed} (FD), {a_failed} (analytic): metrics or "
                         "K5/K6 launches wrong")
    if len(records) != last + 1 or len(a_records) != 1:
        raise SystemExit("chip_smoke: the time-aware path did not run its windows")
    if not same:
        raise SystemExit("chip_smoke: the loop's run of time-aware frame 0 did not reproduce the chained result")
    return {k: launches[k] + a_launches[k] for k in launches}, errs, times, bounds


def fleet_config(config: dict, batch: int, warm_start=False) -> dict:
    """``config``'s blocks solved as a fleet: the fleet solver, ``batch``
    frames per lockstep solve, independent frames (or ``warm_start:
    batch``), the analytic HVP on the finest scale, the cold starts of
    ``FLEET_SOLVER_SEED``; chained unless the config says otherwise."""
    config = copy.deepcopy(config)
    config["solver"].update(method=FLEET_METHOD, seed=FLEET_SOLVER_SEED)
    config["data"].update(fleet_batch=batch, warm_start=warm_start)
    config["optimizer"]["hvp_mode"] = "analytic"
    return config


def run_fleet(port_main, config: dict, dev, n_frames: int, out_dir=None):
    """(records, run config, loader, solver, wall seconds, peak device GiB)
    of the CLI's fleet eval loop over frames 0..n_frames-1 (from the frame
    the checkpoint of ``out_dir`` names, when given; else in a fresh output
    dir): the steps of ``main.run``, with the loop handed the first
    n_frames + eval_dt eval timestamps."""
    from event_based_optical_flow_tpu_torch.utils import set_numerics, validate_config

    out_dir = out_dir or tempfile.mkdtemp(prefix="evflow_chip_smoke_fleet_")
    run_config = slice_config(config, n_frames - 1, out_dir)
    validate_config(run_config)
    set_numerics()
    loader, solv = port_main.build(run_config, dev)
    data = run_config["data"]
    ts = loader.eval_frame_time_list()[: n_frames + data["eval_dt"]]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = port_main.evaluate_dataset_fleet(ts, data, loader, solv, out_dir, data["fleet_batch"])
    torch.cuda.synchronize()
    return records, run_config, loader, solv, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def fleet_windows(config: dict, n_frames: int):
    """The optimization windows of eval frames 0..n_frames-1 (the fleet's
    first batch)."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.data import collections

    data = config["data"]
    loader = collections[data["dataset"]](config=data)
    loader.set_sequence(data["sequence"])
    ts = loader.eval_frame_time_list()
    return [port_main._gather_frame(loader, data, ts[i], ts[i + data["eval_dt"]])[0] for i in range(n_frames)]


def fleet_kernel_check(fi, fleet, flows, dflows, g, g1, g2, tol, pad=0):
    """The four batched kernels of one form (dense, or voxel with the
    fleet's bins; ``pad``: the images' outer padding) against their
    batched plain versions, each frame against the single-frame kernel on
    that frame alone, and a repeat: (lines, max abs errors, all ok)."""
    ev, kw = (fleet.x, fleet.y, fleet.dtf, fleet.wt), {"bins": fleet.bins, "frames": fleet.frames, "pad": pad}
    flr = flows.clone().requires_grad_(True)
    (ref_grad,) = torch.autograd.grad((fi.fused_iwe_reference(flr, *ev, OFFSETS, False, **kw) * g).sum(), flr)
    ref_val, ref_tan = fi.fused_iwe_jvp_reference(flows, dflows, *ev, OFFSETS, True, **kw)
    calls = {
        "fwd": (lambda: fi.fused_iwe_fwd(flows, *ev, OFFSETS, False, **kw),
                lambda one, b: fi.fused_iwe_fwd(flows[b], *one, OFFSETS, False, bins=fleet.frame(b).bins, pad=pad),
                fi.fused_iwe_reference(flows, *ev, OFFSETS, False, **kw)),
        "bwd": (lambda: fi.fused_iwe_bwd(flows, *ev, g, OFFSETS, False, **kw),
                lambda one, b: fi.fused_iwe_bwd(flows[b], *one, g[b], OFFSETS, False, bins=fleet.frame(b).bins,
                                                pad=pad),
                ref_grad),
        "jvp": (lambda: fi.fused_iwe_jvp(flows, dflows, *ev, OFFSETS, False, **kw),
                lambda one, b: fi.fused_iwe_jvp(flows[b], dflows[b], *one, OFFSETS, False, bins=fleet.frame(b).bins,
                                                pad=pad),
                ref_tan),
        "hvp_bwd": (lambda: fi.fused_iwe_hvp_bwd(flows, dflows, g1, g2, *ev, OFFSETS, True, **kw),
                    lambda one, b: fi.fused_iwe_hvp_bwd(flows[b], dflows[b], g1[b], g2[b], *one, OFFSETS, True,
                                                        bins=fleet.frame(b).bins, pad=pad),
                    fi.fused_iwe_hvp_bwd_reference(flows, dflows, g1, g2, *ev, OFFSETS, True, **kw)),
    }
    cev = tuple(a.cpu() for a in ev)
    ckw = {"bins": None if fleet.bins is None else fleet.bins.cpu(),
           "frames": fi.Frames(fleet.frames.ptr.cpu(), fleet.frames.sizes), "pad": pad}
    cpu = lambda a: a.cpu()
    models = {  # the exact models of the forward's, the backward's and the tangent's bits
        "fwd": lambda: fi.fused_iwe_fixed_reference(cpu(flows), *cev, OFFSETS, False, **ckw),
        "jvp": lambda: fi.fused_iwe_jvp_fixed_reference(cpu(flows), cpu(dflows), *cev, OFFSETS, False, **ckw),
        "bwd": lambda: fi.fused_iwe_bwd_ordered_reference(cpu(flows), *cev, cpu(g), OFFSETS, False, **ckw),
        "hvp_bwd": lambda: fi.fused_iwe_bwd_ordered_reference(cpu(flows), *cev, cpu(g2), OFFSETS, False, **ckw,
                                                              g1=cpu(g1), dflow=cpu(dflows)),
    }
    lines, errs, all_ok = [], {}, True
    for name, (batched, single, want) in calls.items():
        got = batched()
        torch.cuda.synchronize()
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        exact = exact_err(got, models[name]()) if name in models else None
        frames_same = []
        for b in range(len(fleet)):
            one = fleet.frame(b)
            frames_same.append(torch.equal(got[b], single((one.x, one.y, one.dtf, one.wt), b)))
        repeat = torch.equal(got, batched())
        ok = err <= tol * scale and all(frames_same) and repeat and exact in (None, 0)
        if name == "jvp":  # the value half is the batched forward's bits
            val, tan = fi.fused_iwe_jvp(flows, dflows, *ev, OFFSETS, True, **kw)
            v_err = (val - ref_val).abs().max().item()
            ok = (ok and torch.equal(tan, got) and torch.equal(val, calls["fwd"][0]())
                  and v_err <= tol * max(1.0, ref_val.abs().max().item()))
        errs[fi.form(fleet.bins, fleet.frames) + name] = err
        all_ok = all_ok and ok
        lines.append(f"{fi.form(fleet.bins, fleet.frames)}{name}: max|err| {err:.3e} (scale {scale:.3g}), tol "
                     f"{tol:g} x scale{'' if exact is None else f'; exact model: max|err| {exact:g}'}; each frame "
                     f"== the single-frame kernel alone: {frames_same}; repeat same bits: {repeat}: "
                     f"{'ok' if ok else 'FAIL'}")
    return lines, errs, all_ok


def fleet_run_checks(records, launch_rule, loader, run_config, solv, name, sequential=None, warm=False) -> list:
    """Print one line per frame of a fleet run; the frames that fail the
    EPE rule, PRED_FWL or ``launch_rule`` (the batch's launches per scale)."""
    failed = []
    finest = solv.patch_scales - 1
    for r in records:
        m, st = r["metrics"], r["stats"]
        zero = zero_flow_epe(loader, run_config["data"], r["frame"], solv)
        launches = {s: {k: v for k, v in c.items() if v} for s, c in st["launches"].items()}
        ok = (np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(m["PRED_FWL"])
              and launch_rule(st))
        beside = ""
        if sequential is not None and r["frame"] == 0:
            beside = (f", sequential slice's frame 0 EPE {sequential:.4f} (FD HVP, solver seed 0: another cold "
                      "draw; printed, not checked)")
        phase(name, f"{r['frame']}: {r['seconds']:.3f} s per frame (batch of {len(st['loss'][finest])}, "
                    f"{'chained' if st['chain'] else 'loop'}{', warm' if warm else ''}), EPE "
                    f"{m['EPE']:.4f} (zero flow {zero:.4f}){beside}, 3PE {m['3PE']:.4f}, AE {m['AE']:.4f}, "
                    f"GT_FWL {m['GT_FWL']:.4f}, PRED_FWL {m['PRED_FWL']:.4f}, batch host syncs {st['syncs']}, "
                    f"lockstep Newton iters {st['iters']}, HVP {st['hvp']}, launches per scale {launches}, "
                    f"loss {({s: [round(v, 6) for v in l] for s, l in st['loss'].items()})}: "
                    f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(r["frame"])
    return failed


def fleet_path(port_main, fi, dev, smi, rng, sequential_epe: float):
    """Phase 9; returns (launches of the path's two runs, the batched
    kernels' max abs errors, times, bounds)."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.solver.objective import FleetEvents

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    h, w = config["data"]["height"], config["data"]["width"]
    n_bins = ta_config()["solver"]["time_bin"]
    windows = fleet_windows(config, FLEET_BATCH)
    b = len(windows)
    flows_np = {None: np.stack([smooth_flow(h, w, rng) for _ in range(b)]),
                n_bins: np.stack([smooth_voxel(h, w, n_bins, rng) for _ in range(b)])}
    dflows_np = {None: np.stack([smooth_flow(h, w, rng) for _ in range(b)]),
                 n_bins: np.stack([smooth_voxel(h, w, n_bins, rng) for _ in range(b)])}
    g_np = rng.normal(size=(3, b, len(OFFSETS), h, w))
    errs = {}
    for dtype in (torch.float64, torch.float32):
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
        for tb in (None, n_bins):
            fleet = FleetEvents.from_numpy(windows, dev, dtype, tb)
            lines, e, ok = fleet_kernel_check(fi, fleet, t(flows_np[tb]), t(dflows_np[tb]), *(t(a) for a in g_np),
                                              TOL[dtype])
            for line in lines:
                phase("fleet-check", f"{str(dtype)[6:]} B={b} N={list(fleet.frames.sizes)} {h}x{w}"
                                     f"{'' if tb is None else f' T={tb}'} offsets={OFFSETS}: {line}")
            if not ok:
                raise SystemExit("chip_smoke: the batched kernels disagree with their plain versions or with "
                                 "the single-frame kernels")
            if dtype == torch.float32:
                errs.update(e)

    times, bounds = {}, {}
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    names = ("fwd", "bwd", "jvp", "hvp_bwd")
    for tb in (None, n_bins):
        fleet = FleetEvents.from_numpy(windows, dev, torch.float32, tb)
        flows = t(flows_np[tb])
        form = fi.form(fleet.bins, fleet.frames)
        got = time_kernels(fi, fleet, flows, t(dflows_np[tb]), t(g_np[0]), t(g_np[1]), names, fleet.frames)
        phase("fleet-time", time_line(smi, got, names, f"{form}: B={b} N={list(fleet.frames.sizes)} {h}x{w}"
                                                       f"{'' if tb is None else f' T={tb}'} offsets={OFFSETS}"))
        times.update({form + k: v for k, v in got.items()})
        bounds.update({form + k: fleet_bound(k, fleet, flows.cpu()) for k in names})

    graph_lines, graph_ok = fleet_graph_check(port_main, dev, windows)
    for line in graph_lines:
        phase("fleet-graph-check", line)
    if not graph_ok:
        raise SystemExit("chip_smoke: the fleet's lockstep solve from replayed graphs differs from the eager one")

    # frames 0..3 as one batch of 4, chained: batched K1/K2 on every scale,
    # K3/K4 on the finest, K8 once per finer scale for the whole batch;
    # warm_start: batch (the first batch is cold) leaves the warm motion in
    # the checkpoint for [fleet-warm]
    dense = fleet_config(config, FLEET_BATCH, warm_start="batch")
    finest_rule = lambda prefix: lambda st: all(  # noqa: E731
        c[prefix + "fwd"] > 0 and c[prefix + "bwd"] > 0
        and (s == max(st["launches"])) == (c[prefix + "jvp"] > 0 and c[prefix + "hvp_bwd"] > 0)
        for s, c in st["launches"].items())
    sweeps = lambda st: sum(c["vote"] for c in st["launches"].values())  # noqa: E731
    runs, launches = {}, {}
    for name, run_cfg, out in (("fleet-frame", dense, None), ("fleet-loop", loop_config(dense), None)):
        ops.reset_launch_counts()
        records, run_config, loader, solv, wall, peak = run_fleet(port_main, run_cfg, dev, FLEET_BATCH)
        got = ops.launch_counts()
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        st = records[0]["stats"] if records else {}
        # the chain sweeps each finer scale once for the batch, the loop once per frame
        per_batch = (VOTES_PER_SWEEP * (solv.patch_scales - 1 - solv.coarsest_scale)
                     * (1 if st.get("chain") else FLEET_BATCH))
        rule = lambda st, per_batch=per_batch: finest_rule("batched_")(st) and sweeps(st) == per_batch  # noqa: E731
        failed = fleet_run_checks(records, rule, loader, run_config, solv, name,
                                  sequential_epe if name == "fleet-frame" else None)
        runs[name] = (records, wall, peak, failed, run_config["output"]["output_dir"])
        phase("fleet", f"{name}: {len(records)} windows in one batch ({'chained' if st.get('chain') else 'loop'}) "
                       f"in {wall:.2f} s ({wall / max(1, len(records)):.3f} s per frame), batch host syncs "
                       f"{st.get('syncs')}, peak device memory {peak:.3f} GiB, K8 launches in the sweeps "
                       f"{sweeps(st) if st else 0}"
                       f", kernel launches { {k: v for k, v in got.items() if v} } on {smi}")
    (records, wall, peak, failed, out_dir), (loop_records, loop_wall, loop_peak, loop_failed, _) = (
        runs["fleet-frame"], runs["fleet-loop"])
    again, _, _, _, again_wall, _ = run_fleet(port_main, dense, dev, FLEET_BATCH)
    same = (len(again) == len(records) and all(a["metrics"] == r["metrics"] for a, r in zip(again, records))
            and all(again[0]["stats"][k] == records[0]["stats"][k] for k in ("loss", "syncs", "launches")))
    phase("fleet-repeat", f"the chained batch from a fresh solver ({again_wall:.2f} s): metrics, per-scale losses, "
                          f"host syncs and launches bit for bit the same: {'ok' if same else 'FAIL'}")
    if records and loop_records:
        cs, ls = records[0]["stats"], loop_records[0]["stats"]
        phase("chain", f"fleet of {FLEET_BATCH} frames 0..{FLEET_BATCH - 1} on {smi}: chained "
                       f"{wall / FLEET_BATCH:.3f} s per frame, loop {loop_wall / FLEET_BATCH:.3f} s per frame "
                       f"({loop_wall / wall:.2f}x; the two draw differently), batch host syncs {cs['syncs']} / "
                       f"{ls['syncs']}, peak device memory {peak:.3f} / {loop_peak:.3f} GiB")

    # frames 4..7, warm from batch 0..3's last solution (the checkpoint's)
    ops.reset_launch_counts()
    warm_records, warm_config, warm_loader, warm_solv, warm_wall, warm_peak = run_fleet(
        port_main, dense, dev, 2 * FLEET_BATCH, out_dir=out_dir)
    got = ops.launch_counts()
    launches = {k: launches[k] + got[k] for k in launches}
    warm_ok = [r["frame"] for r in warm_records] == list(range(FLEET_BATCH, 2 * FLEET_BATCH))
    warm_failed = fleet_run_checks(warm_records, finest_rule("batched_"), warm_loader, warm_config, warm_solv,
                                   "fleet-warm", warm=True)
    if warm_records:
        ws = warm_records[0]["stats"]
        phase("fleet", f"fleet-warm: frames {FLEET_BATCH}..{2 * FLEET_BATCH - 1} from the checkpoint's warm motion "
                       f"in {warm_wall:.2f} s ({warm_wall / FLEET_BATCH:.3f} s per frame), lockstep iters "
                       f"{ws['iters']} (cold batch {records[0]['stats']['iters'] if records else None}), batch host "
                       f"syncs {ws['syncs']}, peak device memory {warm_peak:.3f} GiB on {smi}")

    # frames 0..1 as one batch of 2, time-aware, chained: batched K5 on every scale, K6 on the finest
    ta = fleet_config(ta_config(), FLEET_TA_BATCH)
    ta["optimizer"]["coarse_max_iter"] = TA_COARSE_MAX_ITER
    ops.reset_launch_counts()
    ta_records, ta_run_config, ta_loader, ta_solv, ta_wall, ta_peak = run_fleet(port_main, ta, dev, FLEET_TA_BATCH)
    ta_launches = ops.launch_counts()
    launches = {k: launches[k] + ta_launches[k] for k in launches}
    ta_failed = fleet_run_checks(ta_records, finest_rule("batched_voxel_"), ta_loader, ta_run_config, ta_solv,
                                 "fleet-ta-frame")
    phase("fleet-ta", f"{len(ta_records)} windows in one batch (chained) in {ta_wall:.2f} s "
                      f"({ta_wall / max(1, len(ta_records)):.3f} s per frame), batch host syncs "
                      f"{ta_records[0]['stats']['syncs'] if ta_records else None}, peak device memory {ta_peak:.3f} "
                      f"GiB, kernel launches { {k: v for k, v in ta_launches.items() if v} } on {smi}")
    if failed or loop_failed or warm_failed or ta_failed:
        raise SystemExit(f"chip_smoke: fleet frames {failed} (chained), {loop_failed} (loop), {warm_failed} (warm), "
                         f"{ta_failed} (time-aware): metrics or batched kernel launches wrong")
    if (len(records) != FLEET_BATCH or len(loop_records) != FLEET_BATCH or not warm_ok
            or len(ta_records) != FLEET_TA_BATCH or not all(r["stats"]["chain"] for r in records + ta_records)):
        raise SystemExit("chip_smoke: the fleet path did not run its windows")
    if not same:
        raise SystemExit("chip_smoke: a second run of the fleet batch did not reproduce its result")
    return launches, errs, times, bounds


def fleet_graph_check(port_main, dev, windows):
    """``[fleet-graph-check]``: one scale's lockstep Newton-CG of the dense
    fleet config (3 iterations) on frames 0..3 from random tile motions,
    once with eager evaluations and once through a fresh ``ChainGraphs``
    stage (captured, then replayed): iterates, losses, iterations and host
    syncs bit for bit, on the scale below the finest (central FD HVP) and
    the finest (the analytic HVP's prep and HVP).  Returns (lines, ok)."""
    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    _, solv = port_main.build(fleet_config(config, len(windows)), dev)
    fleet, orig, _ = solv._newton_events(windows, chain=False, coarse=False)["full"]
    stage = ChainGraphs(dev).stage("fleet-full", fleet, orig)
    lines, all_ok = [], True
    for s in (solv.patch_scales - 2, solv.patch_scales - 1):
        solv.overload_patch_configuration(s)
        spec = solv._current_spec()
        x0 = solv.tensor(np.random.default_rng(s).uniform(-20.0, 20.0, (len(windows), 2 * solv.n_patch)))
        out = []
        for staged in (None, stage):
            solv.syncs = 0
            t0 = time.perf_counter()
            bx, bf, k, hvp = solv._run_fleet_newton(spec, x0, stage.frame, stage.orig, 3, None, True, False, staged)
            torch.cuda.synchronize()
            out.append((bx, bf, k, solv.syncs, time.perf_counter() - t0))
        (xe, fe, ke, se, te), (xs, fs, ks, ss, ts) = out
        ok = torch.equal(xe, xs) and torch.equal(fe, fs) and (ke, se) == (ks, ss)
        all_ok = all_ok and ok
        lines.append(f"scale {s}, B={len(windows)} N={list(fleet.frames.sizes)}, {hvp} HVP, 3 lockstep iterations: "
                     f"eager {te:.3f} s, staged (captures included) {ts:.3f} s; iterates, losses, iterations ({ks}) "
                     f"and host syncs ({ss}) bit for bit: {'ok' if ok else 'FAIL'}")
    return lines, all_ok


def sweep_call(port_main, config: dict, events: np.ndarray, dev, scale=None):
    """The init-sweep scoring call of ``scale`` (the finest by default) on
    ``events``, as K8 gets it in a solve of ``config``: (the ``[P, K, C,
    4]`` warped patch events, their ``[P, 1, C]`` weights), recorded from a
    real sweep from random tile motions of a few px/s."""
    _, solv = port_main.build(config, dev)
    s = solv.patch_scales - 1 if scale is None else scale
    solv.overload_patch_configuration(s)
    motion0 = solv.tensor(np.random.default_rng(1).uniform(-20.0, 20.0, (2, solv.n_patch)))
    n_cand = max(4, int(config["optimizer"]["n_iter"] / max(1, s - solv.coarsest_scale)))
    with recorded_votes() as calls:
        solv.initialize_guess_from_patch_search(events, motion0, n_cand)
    torch.cuda.synchronize()
    ev, weight, _ = max(calls, key=lambda c: c[0].numel())
    return (ev, weight), tuple(solv.patch_size)


def vote_bound(events: torch.Tensor, weight, image_size):
    """(least milliseconds one H100 needs, "bytes" or "operations") for one
    K8 call, counted from this call's data: of the event array only the
    32-byte sectors that the voting (nonzero-weight) rows' x and y fall in
    (a zero-weight row's position is never read; x and y share their sector
    with the unread t and p), each event set read once however many images
    vote it (the voxel grid's planes: a stride-0 expand, which K8 reads in
    place), a tensor weight read once at its own shape, the images written
    once, over the HBM rate; ``OPS_PER_VOTE`` operations per vote and one
    per output pixel (the fixed-point conversion) over the float32 rate."""
    from event_based_optical_flow_tpu_torch.ops import vote

    h, w = image_size
    rows = events.shape[:-1]
    n = rows[-1]
    n_img = rows.numel() // n
    item = events.element_size()
    _, rep = vote._event_rows(events, tuple(rows[:-1]))
    votes = (torch.broadcast_to(weight != 0, rows) if torch.is_tensor(weight)
             else torch.full(tuple(rows), weight != 0, device=events.device))
    # the images of one event row are consecutive (image i reads row i // rep)
    voting = votes.reshape(-1, rep, n).any(dim=1).reshape(-1).nonzero().squeeze(1).cpu()
    weight_bytes = weight.numel() * item if torch.is_tensor(weight) else 0
    moved = sector_bytes(voting * events.shape[-1], item) + weight_bytes + n_img * h * w * item
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = (OPS_PER_VOTE * int(votes.sum()) + n_img * h * w) / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vote_path(port_main, dev, smi, config: dict, events: np.ndarray) -> dict:
    """Phases ``[vote-check]`` and ``[vote-time]`` at each of the main
    path's launch configurations: the finest scale's sweep call (256-thread
    blocks), the DSEC path's scale-2 sweep call on its first window
    (112x160 patches: 1024-thread blocks with opted-in shared memory) and a
    full-frame metric vote of the first window (the global path).  Returns
    the finest sweep's float32 error, times and bound (the ``kernels``
    line's)."""
    from event_based_optical_flow_tpu_torch.ops import vote

    (sweep_ev, sweep_wt), patch = sweep_call(port_main, config, events, dev)
    dsec = dsec_config()
    (dsec_ev, dsec_wt), dsec_patch = sweep_call(port_main, dsec, first_window(dsec)[1], dev, scale=2)
    h, w = config["data"]["height"], config["data"]["width"]
    shapes = {"sweep": (sweep_ev, sweep_wt, patch),
              "dsec_sweep": (dsec_ev, dsec_wt, dsec_patch),
              "frame": (torch.as_tensor(events, device=dev), 1.0, (h, w))}
    out = {}
    for dtype in (torch.float64, torch.float32):
        for name, (ev, wt, size) in shapes.items():
            ev = ev.to(dtype)
            wt = wt.to(dtype) if torch.is_tensor(wt) else wt
            want = vote.bilinear_vote_plain(ev, size, wt)
            got = vote.bilinear_vote_kernel(ev, size, wt)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            same = torch.equal(got, vote.bilinear_vote_kernel(ev, size, wt))
            exact = exact_err(got, vote.bilinear_vote_fixed_reference(ev.cpu(), size, wt.cpu() if torch.is_tensor(wt)
                                                                      else wt))
            ok = err <= TOL[dtype] * scale and same and exact == 0
            path = "shared memory" if size[0] * size[1] <= vote.shared_pixels() else "global sums"
            phase("vote-check", f"{str(dtype)[6:]} {name}: events {list(ev.shape)} -> images {list(got.shape)} "
                                f"({path}), weight {list(wt.shape) if torch.is_tensor(wt) else wt}: max|err| "
                                f"{err:.3e} (scale {scale:.3g}), tol {TOL[dtype]:g} x scale; exact model: max|err| "
                                f"{exact:g}; repeat same bits: {same}: " + ("ok" if ok else "FAIL"))
            if not ok:
                raise SystemExit("chip_smoke: K8 disagrees with its plain version or its exact model, or is not "
                                 "reproducible")
            if dtype == torch.float32:
                out[name] = {"err": err}
    for name, (ev, wt, size) in shapes.items():
        ev = ev.to(torch.float32)
        wt = wt.to(torch.float32) if torch.is_tensor(wt) else wt
        inds, vals, batch = vote.corner_terms(ev, size, wt)
        image = torch.zeros(int(np.prod(batch)) * size[0] * size[1], dtype=torch.float32, device=dev)
        times = {"ms": cuda_ms(lambda: vote.bilinear_vote_kernel(ev, size, wt)),
                 "plain_ms": cuda_ms(lambda: vote.bilinear_vote_plain(ev, size, wt)),
                 # one PyTorch call that computes the vote's scatter from its corner terms
                 "library_ms": cuda_ms(lambda: image.index_add(0, inds, vals))}
        b_ms, b_by = vote_bound(ev, wt, size)
        out[name].update(times, bound_ms=b_ms, bound_by=b_by)
        phase("vote-time", f"{smi}: float32 {name} {list(ev.shape)}: kernel {times['ms']:.4f} ms vs plain "
                           f"{times['plain_ms']:.4f} ms, library (index_add of the 4n corner terms, deterministic) "
                           f"{times['library_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}) (CUDA events, mean of 50 "
                           "after 5 warm-up)")
    return out["sweep"]


def http_post(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=900) as resp:
        return resp.read()


def push_window(base: str, events: np.ndarray):
    """``POST /flow`` one window: (flow [2, H, W] float32, span seconds)."""
    buf = io.BytesIO()
    np.savez(buf, events=events)
    out = np.load(io.BytesIO(http_post(f"{base}/flow", buf.getvalue())))
    return out["flow"], float(out["span"])


def healthz(base: str) -> dict:
    with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
        return json.loads(resp.read())


def serve_windows(config: dict, n: int):
    """Eval windows 0..n-1 of ``config``'s data block (the `dots` scene):
    (events as the loader holds them, GT displacement [H, W, 2], seconds)."""
    from event_based_optical_flow_tpu_torch.data import collections

    data = dict(config["data"], pattern="dots")
    loader = collections[data["dataset"]](config=data)
    loader.set_sequence(data["sequence"])
    ts = loader.eval_frame_time_list()
    out = []
    for i in range(n):
        t1, t2 = ts[i], ts[i + data["eval_dt"]]
        out.append((loader.load_event(loader.time_to_index(t1), loader.time_to_index(t2)),
                    loader.load_optical_flow(t1, t2), t2 - t1))
    return out


def serve_path(dev, smi) -> dict:
    """Phases ``[serve-push]``, ``[serve-repeat]``, ``[serve-resume]``: the
    HTTP server on the card with the serving defaults (solver seed
    ``SERVE_SOLVER_SEED``) and ``SERVE_EVENT_COUNT``-event windows, fed
    windows 0..2 of the MVSEC slice's data block (cold, warm, warm);
    returns the launches of the pushes."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.serve import FlowServer

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    h, w = config["data"]["height"], config["data"]["width"]
    windows = serve_windows(config, 4)
    state_dir = tempfile.mkdtemp(prefix="evflow_chip_smoke_serve_")
    state = os.path.join(state_dir, "state.npz")
    kw = {"solver_config": {"seed": SERVE_SOLVER_SEED}, "fixed_event_count": SERVE_EVENT_COUNT, "device": dev}
    server = FlowServer((h, w), port=0, state_path=state, **kw).start()
    base = f"http://127.0.0.1:{server.port}"
    total, failed, flows = {}, [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, (events, gt, seconds) in enumerate(windows[:3]):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            flow, span = push_window(base, events)
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
            flows.append(flow)
            if i == 1:
                resume_state = os.path.join(state_dir, "after_push_1.npz")
                shutil.copy(state, resume_state)
            est = server.estimator
            stats = est._solver.last_frame_stats
            if i == 0:
                cold = (wall, dict(stats))
            # the flow is the displacement over the solved window's span; the
            # GT over the eval window's seconds
            pred = flow.astype(np.float64) / span * seconds
            m = est.metrics(pred, gt, events)
            zero = est.metrics(np.zeros_like(pred), gt, events)["EPE"]
            finest = max(stats["hvp"])
            hvp_ok = all(v == "analytic-gn" for s, v in stats["hvp"].items() if i > 0 or s == finest)
            used = {k: v for k, v in launches.items() if v}
            ok = (np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and hvp_ok and np.isfinite(flow).all()
                  and all(launches[k] > 0 for k in ("vote", "fwd", "bwd", "jvp", "hvp_bwd")))
            phase("serve-push", f"window {i} ({'cold' if i == 0 else 'warm'}, {len(events)} events pushed, "
                                f"{SERVE_EVENT_COUNT} solved): {wall:.3f} s, EPE {m['EPE']:.4f} (zero flow "
                                f"{zero:.4f}), 3PE {m['3PE']:.4f}, AE {m['AE']:.4f}, HVP {stats['hvp']}, host syncs "
                                f"{stats['syncs']}, Newton iters {stats['iters']}, kernel launches {used}, loss "
                                f"{({s: round(v, 6) for s, v in stats['loss'].items()})}: {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(i)
    finally:
        server.shutdown()
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    again = FlowServer((h, w), port=0, optimizer_config={"chain": False}, **kw).start()
    try:
        t0 = time.perf_counter()
        flow0, _ = push_window(f"http://127.0.0.1:{again.port}", windows[0][0])
        loop_wall = time.perf_counter() - t0
        loop = again.estimator._solver.last_frame_stats
        same = (np.array_equal(flow0, flows[0]) and cold[1]["chain"] and not loop["chain"]
                and all(loop[k] == cold[1][k] for k in ("loss", "syncs", "launches")))
        phase("serve-repeat", f"window 0 to a fresh server with the loop (chain: false, {loop_wall:.3f} s): flow, "
                              f"per-scale losses, host syncs and launches bit for bit the chained push's: "
                              f"{'ok' if same else 'FAIL'}")
        phase("chain", f"serving cold push (window 0) on {smi}: chained {cold[0]:.3f} s, loop {loop_wall:.3f} s "
                       f"({loop_wall / cold[0]:.2f}x), host syncs {cold[1]['syncs']} / {loop['syncs']}, peak device "
                       f"memory {peak:.3f} (the three chained pushes) / {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    finally:
        again.shutdown()
    resumed = FlowServer((h, w), port=0, state_path=resume_state, **kw).start()
    try:
        health = healthz(f"http://127.0.0.1:{resumed.port}")
        warm = resumed.estimator._solver.previous_frame_best_estimation
        resume_ok = health == {"status": "ok", "n_windows": 2} and warm is not None
        phase("serve-resume", f"a server started with the state file written after push 1: /healthz {health}, "
                              f"warm scales {sorted(warm) if warm else None}: {'ok' if resume_ok else 'FAIL'}")
    finally:
        resumed.shutdown()
    wfo_launches, wfo_failed = serve_wfo(dev, smi, (h, w), windows, flows[0], kw)
    total = {k: total[k] + wfo_launches[k] for k in total}
    if failed:
        raise SystemExit(f"chip_smoke: serving windows {failed}: EPE, HVP modes or kernel launches wrong")
    if not same:
        raise SystemExit("chip_smoke: the loop's push of window 0 did not reproduce the chained push")
    if not resume_ok:
        raise SystemExit("chip_smoke: a server did not resume the serving state file")
    if wfo_failed:
        raise SystemExit(f"chip_smoke: warm finest-only serving windows {wfo_failed}: EPE, path or launches wrong")
    return total


def serve_wfo(dev, smi, image_shape, windows, cold_flow, kw):
    """``[serve-wfo]``: a server with ``warm_finest_only`` and
    ``warm_full_every: 3`` takes windows 0..3: the cold push (the default
    server's cold push, bit for bit), two finest-only warm pushes (one
    finest-scale solve, no init sweep: no K8 launch), then the re-anchor
    (the full pyramid, K8 in its sweeps).  Each push: seconds, EPE against
    the zero flow, host syncs, launches.  Returns (launches, failed
    windows)."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.serve import FlowServer

    server = FlowServer(image_shape, port=0,
                        optimizer_config={"warm_finest_only": True, "warm_full_every": 3}, **kw).start()
    base = f"http://127.0.0.1:{server.port}"
    total, failed = {}, []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, (events, gt, seconds) in enumerate(windows):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            flow, span = push_window(base, events)
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
            est = server.estimator
            solv, stats = est._solver, est._solver.last_frame_stats
            pred = flow.astype(np.float64) / span * seconds
            m = est.metrics(pred, gt, events)
            zero = est.metrics(np.zeros_like(pred), gt, events)["EPE"]
            finest_only = i in (1, 2)
            path_ok = (solv._wfo_last == finest_only and bool(stats.get("warm_finest")) == finest_only
                       and (launches["vote"] == 0) == finest_only and launches["fwd"] > 0
                       and (i > 0 or np.array_equal(flow, cold_flow)))
            ok = np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(flow).all() and path_ok
            what = "cold" if i == 0 else ("warm, finest only" if finest_only else "warm, the re-anchor: every scale")
            phase("serve-wfo", f"window {i} ({what}, streak {solv._warm_streak}): {wall:.3f} s, EPE {m['EPE']:.4f} "
                               f"(zero flow {zero:.4f}), HVP {stats['hvp']}, host syncs {stats['syncs']}, Newton "
                               f"iters {stats['iters']}, kernel launches { {k: v for k, v in launches.items() if v} }"
                               f"{'; the default server cold push, bit for bit' if i == 0 else ''} on {smi}: "
                               f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(i)
    finally:
        server.shutdown()
    phase("serve-wfo", f"peak device memory of the four pushes {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return total, failed


def mvsec_fixture(root: str, height: int, width: int, seed: int = 7, **kw) -> dict:
    """An ``indoor_flying1`` recording in MVSEC's layout, from the synthetic
    ``dots`` scene (``MVSEC_FIXTURE``, overridden by ``kw``): writes the GT
    (``<root>/indoor_flying1_gt_flow_dist.npz``: ``timestamps`` and each GT
    interval's displacement ``x_flow_dist`` (width) / ``y_flow_dist``
    (height)) and identity rectify maps (``<root>/indoor_flying_left_{x,y}
    _map.txt``), and returns the datasets of ``indoor_flying1_data.hdf5``:
    ``davis/left/events`` [n, 4] float64 (x=width, y=height, t in Unix
    seconds, p in {-1, 1}), ``davis/left/image_raw_ts`` (the gray frames,
    one per GT frame) and ``davis/right/events``.  The first
    ``MVSEC_FIRST_VALID_GT`` GT frames precede the events (the loader drops
    them), two gray intervals of events lead the first kept one and follow
    the last."""
    from event_based_optical_flow_tpu_torch.data.synthetic import SyntheticDataLoader

    fx = {**MVSEC_FIXTURE, **kw}
    n_gt, dt = fx["n_gt"], 1.0 / fx["frame_hz"]
    first = 2 * dt  # the first kept GT frame, after the first event
    duration = first + (n_gt - MVSEC_FIRST_VALID_GT + 1) * dt
    scene = SyntheticDataLoader({"height": height, "width": width, "duration": duration, "seed": seed,
                                 "event_rate": fx["event_rate"], "flow_max": fx["flow_max"], "pattern": "dots"})
    scene.set_sequence("indoor_flying1")
    ev = scene.load_event(0, len(scene))
    gt_ts = MVSEC_EPOCH + first + (np.arange(n_gt) - MVSEC_FIRST_VALID_GT) * dt
    step = scene.load_optical_flow(0.0, dt)  # the quadrants' displacement over one GT interval
    np.savez(os.path.join(root, "indoor_flying1_gt_flow_dist.npz"), timestamps=gt_ts,
             x_flow_dist=np.repeat(step[None, ..., 1], n_gt, 0), y_flow_dist=np.repeat(step[None, ..., 0], n_gt, 0))
    rows, cols = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    np.savetxt(os.path.join(root, "indoor_flying_left_x_map.txt"), cols, fmt="%d")
    np.savetxt(os.path.join(root, "indoor_flying_left_y_map.txt"), rows, fmt="%d")
    left = np.stack([ev[:, 1], ev[:, 0], MVSEC_EPOCH + ev[:, 2], 2.0 * ev[:, 3] - 1.0], axis=1)
    return {"davis/left/events": left, "davis/left/image_raw_ts": gt_ts.copy(), "davis/right/events": left[:16]}


def write_mvsec_h5(path: str, datasets: dict) -> None:
    """Write ``mvsec_fixture``'s datasets as an HDF5 file (needs h5py)."""
    import h5py

    with h5py.File(path, "w") as f:
        for name, values in datasets.items():
            f.create_dataset(name, data=values)


def mvsec_arrays_reader(datasets: dict):
    """A stand-in for ``data.mvsec.h5py_loader`` on ``mvsec_fixture``'s
    datasets instead of the file: the same arrays, with HDF5's conversion
    to int16 (values saturate at the type's range; the timestamp column
    does, and the loader reads the timestamps from the float64 column)."""
    def to_int16(a):
        return np.clip(a, -32768, 32767).astype(np.int16)

    def read(path: str):
        left, right = datasets["davis/left/events"], datasets["davis/right/events"]
        return ({"left": left[:, 2].copy(), "right": right[:, 2].copy()},
                {"event": to_int16(left), "gray_ts": np.asarray(datasets["davis/left/image_raw_ts"], np.float64)},
                {"event": to_int16(right)})

    return read


def evt2_words(x_col, y_row, t_us, pol) -> np.ndarray:
    """Prophesee EVT2.0 words of time-sorted CD events: an EVT_TIME_HIGH
    word (type 0x8, t >> 6) wherever the upper bits change, then each event's
    CD word (type = polarity, t's 6 low bits, 11-bit column, 11-bit row)."""
    t_us = np.asarray(t_us, np.int64)
    high = t_us >> 6
    new_high = np.concatenate([[True], high[1:] != high[:-1]])
    cd = ((np.asarray(pol, np.int64) << 28) | ((t_us & 0x3F) << 22) | (np.asarray(x_col, np.int64) << 11)
          | np.asarray(y_row, np.int64))
    words = np.stack([(0x8 << 28) | high, cd], axis=1).reshape(-1)
    keep = np.stack([new_high, np.ones_like(new_high)], axis=1).reshape(-1)
    return words[keep].astype(np.uint32)


def evt2_fixture(path: str, height: int, width: int, seed: int = 0, **kw):
    """A Prophesee RAW EVT2 file at ``path`` (``%`` header, then the words)
    of a Gen3 camera watching random dots translate at ``velocity`` (row,
    col) px/s for ``seconds``, with ``n_hot`` hot pixels firing every
    ``hot_period_us`` (``EVT2_FIXTURE``, overridden by ``kw``).  Returns the
    velocity (the GT: a window's displacement is velocity x its seconds)."""
    fx = {**EVT2_FIXTURE, **kw}
    rng = np.random.default_rng(seed)
    v = np.asarray(fx["velocity"])
    n, seconds = fx["events"], fx["seconds"]
    t = np.sort(rng.uniform(0.0, seconds, n))
    dots = rng.uniform([-seconds * min(v[0], 0), -seconds * min(v[1], 0)],
                       [height - seconds * max(v[0], 0), width - seconds * max(v[1], 0)], (fx["n_dots"], 2))
    pos = dots[rng.integers(0, fx["n_dots"], n)] + v * t[:, None] + rng.normal(0.0, 0.2, (n, 2))
    rows, cols = np.round(pos[:, 0]), np.round(pos[:, 1])
    inside = (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
    hot_t = np.arange(0, int(seconds * 1e6), fx["hot_period_us"])
    hot = rng.integers(0, [height, width], (fx["n_hot"], 2))
    t_us = np.concatenate([np.floor(t[inside] * 1e6), np.tile(hot_t, fx["n_hot"])])
    y_row = np.concatenate([rows[inside], np.repeat(hot[:, 0], len(hot_t))])
    x_col = np.concatenate([cols[inside], np.repeat(hot[:, 1], len(hot_t))])
    pol = np.concatenate([rng.integers(0, 2, inside.sum()), np.ones(fx["n_hot"] * len(hot_t), np.int64)])
    order = np.argsort(t_us, kind="stable")
    header = f"% format EVT2;height={height};width={width}\n% end\n".encode()
    with open(path, "wb") as f:
        f.write(header + evt2_words(x_col[order], y_row[order], t_us[order], pol[order]).astype("<u4").tobytes())
    return tuple(v)


def mvsec_cli_path(dev, smi) -> dict:
    """``[mvsec-cli]``: ``MVSEC_CONFIG`` as shipped (260x346, 30 000-event
    windows, 5 scales, random init, FD HVP, hybrid cost, eval_dt 4) through
    ``main.run`` on an ``indoor_flying1`` fixture (``mvsec_fixture``), frames
    0 and 1 (``data.ind1``/``ind2``, the second warm-started).  Per frame:
    seconds, EPE against the zero flow's, PRED_FWL, host syncs, the solve's
    K1/K2/K8 launches.  Returns the run's launches."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.data import mvsec

    with open(MVSEC_CONFIG) as f:
        config = yaml.safe_load(f)
    root = tempfile.mkdtemp(prefix="evflow_chip_smoke_mvsec_")
    d = config["data"]
    datasets = mvsec_fixture(root, d["height"], d["width"])
    n_frames = 2
    d.update(root=root, gt=root, ind1=0, ind2=n_frames - 1)
    out_dir = config["output"]["output_dir"] = os.path.join(root, "out")
    reader = mvsec.h5py_loader
    if MVSEC_H5PY:
        write_mvsec_h5(os.path.join(root, "indoor_flying1_data.hdf5"), datasets)
        how = "h5py reads the written indoor_flying1_data.hdf5"
    else:
        mvsec.h5py_loader = mvsec_arrays_reader(datasets)
        how = "the file's datasets handed to the loader in place of h5py_loader (MVSEC_H5PY False: no h5py on this machine)"
    try:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        records = port_main.run(config, eval_mode=True, device=dev)
        torch.cuda.synchronize()
        wall, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
        launches = ops.launch_counts()
        loader, solv = port_main.build(config, dev)
    finally:
        mvsec.h5py_loader = reader
    failed = []
    for r in records:
        m, st = r["metrics"], r["stats"]
        zero = zero_flow_epe(loader, d, r["frame"], solv)
        solve = solve_launches(st)
        ok = np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(m["PRED_FWL"])
        phase("mvsec-cli", f"frame {r['frame']} ({'warm' if r['frame'] else 'cold'}): {r['seconds']:.3f} s, EPE "
                           f"{m['EPE']:.4f} (zero flow {zero:.4f}), 3PE {m['3PE']:.4f}, AE {m['AE']:.4f}, GT_FWL "
                           f"{m['GT_FWL']:.4f}, PRED_FWL {m['PRED_FWL']:.4f}, host syncs {st['syncs']}, Newton "
                           f"iters {st['iters']}, the solve's launches K1 {solve['fwd']} K2 {solve['bwd']} K8 "
                           f"{solve['vote']}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(r["frame"])
    lines = {name: count_lines(os.path.join(out_dir, name))
             for name in ("flow_error_per_frame_with_mask.txt", "eval_metrics.jsonl")}
    with np.load(os.path.join(out_dir, "eval_state.npz")) as state:
        next_frame = int(state["__next_frame"])
    files_ok = all(n == n_frames for n in lines.values()) and next_frame == n_frames
    phase("mvsec-cli", f"{MVSEC_CONFIG} on {smi}: {len(records)} frames ({len(loader)} events, "
                       f"{len(loader.eval_frame_time_list())} gray frames kept of {MVSEC_FIXTURE['n_gt']}) in "
                       f"{wall:.2f} s, peak device memory {peak:.3f} GiB, kernel launches "
                       f"{ {k: v for k, v in launches.items() if v} }; output lines {lines}, eval_state next frame "
                       f"{next_frame}: {'ok' if files_ok else 'FAIL'}; reader: {how}")
    if failed or len(records) != n_frames:
        raise SystemExit(f"chip_smoke: MVSEC frames {failed}: metrics not finite or not below the zero flow")
    if 0 in (launches["fwd"], launches["bwd"], launches["vote"]) or not files_ok:
        raise SystemExit("chip_smoke: the MVSEC eval did not run K1, K2 and K8 or wrote the wrong outputs")
    if not MVSEC_H5PY:
        mvsec.h5py_loader = mvsec_arrays_reader(datasets)
    try:
        again = viz_cli(port_main, config, records, out_dir, launches, dev, smi)
    finally:
        mvsec.h5py_loader = reader
    return {k: launches[k] + again[k] for k in launches}


def count_lines(path: str) -> int:
    with open(path) as f:
        return len(f.read().strip().splitlines())


def solve_launches(stats: dict) -> dict:
    """Each kernel's launches in one solve, summed over its scales (``fwd``
    K1, ``bwd`` K2, ``jvp`` K3, ``hvp_bwd`` K4, ``batched_fwd`` K7's
    forward, ``vote`` K8, ...)."""
    return {k: sum(c[k] for c in stats["launches"].values()) for k in next(iter(stats["launches"].values()))}


def evt2_fwl_path(dev, smi) -> dict:
    """``[evt2-fwl]``: ``EVT2_CONFIG`` as shipped (480x640, 300 000-event
    windows, zero init, 5 scales) with ``EVT2_FILTERS`` and ``output.save_flow:
    npz`` through ``main.run``'s GT-free loop on a RAW EVT2 fixture
    (``evt2_fixture``), ``EVT2_WINDOWS`` windows.  Per window: seconds,
    PRED_FWL, host syncs, the solve's launches, and the dumped flow's EPE
    against the synthesized displacement beside the zero flow's.  Returns the
    run's launches."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.flow.metrics import calculate_flow_error
    from event_based_optical_flow_tpu_torch.ops.iwe import event_mask

    with open(EVT2_CONFIG) as f:
        config = yaml.safe_load(f)
    root = tempfile.mkdtemp(prefix="evflow_chip_smoke_evt2_")
    d = config["data"]
    velocity = evt2_fixture(os.path.join(root, d["sequence"] + ".raw"), d["height"], d["width"])
    d.update(root=root, eval_n_frames=EVT2_WINDOWS + d["eval_dt"], **EVT2_FILTERS)
    out_dir = config["output"]["output_dir"] = os.path.join(root, "out")
    config["output"]["save_flow"] = "npz"
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = port_main.run(config, eval_mode=True, device=dev)
    torch.cuda.synchronize()
    wall, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    launches = ops.launch_counts()
    loader, solv = port_main.build(config, dev)
    ts = loader.eval_frame_time_list()
    failed = []
    for r in records:
        i, st = r["frame"], r["stats"]
        t1, t2 = ts[i], ts[i + d["eval_dt"]]
        events = solv.tensor(loader.load_event(loader.time_to_index(t1), loader.time_to_index(t2)))
        gt = solv.tensor(np.ones((2,) + solv.image_shape) * np.asarray(velocity)[:, None, None] * (t2 - t1))
        with np.load(os.path.join(out_dir, "flow_submission", f"{i:06d}.npz")) as dump:
            flow = solv.tensor(dump["flow"])
        mask = event_mask(events, solv.image_shape)[None]
        epe = float(calculate_flow_error(gt[None], flow[None], mask)["EPE"])
        zero = float(calculate_flow_error(gt[None], torch.zeros_like(gt)[None], mask)["EPE"])
        fwl = r["metrics"]["PRED_FWL"]
        solve = solve_launches(st)
        ok = np.isfinite(fwl) and fwl < 1.0 and epe < EPE_FRACTION * zero
        phase("evt2-fwl", f"window {i} ({'warm' if i else 'cold'}, {t2 - t1:.4f} s, {len(events)} events): "
                          f"{r['seconds']:.3f} s, PRED_FWL {fwl:.4f}, the npz dump's EPE {epe:.4f} against the "
                          f"synthesized displacement (zero flow {zero:.4f}), host syncs {st['syncs']}, Newton iters "
                          f"{st['iters']}, the solve's launches K1 {solve['fwd']} K2 {solve['bwd']} K8 "
                          f"{solve['vote']}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(i)
    n_dumps = len(os.listdir(os.path.join(out_dir, "flow_submission")))
    lines = count_lines(os.path.join(out_dir, "eval_metrics.jsonl"))
    files_ok = n_dumps == lines == EVT2_WINDOWS
    phase("evt2-fwl", f"{EVT2_CONFIG} on {smi}: {len(records)} windows ({len(loader)} events after the filters "
                      f"{EVT2_FILTERS}) in {wall:.2f} s, peak device memory {peak:.3f} GiB, kernel launches "
                      f"{ {k: v for k, v in launches.items() if v} }; flow dumps {n_dumps}, metric lines {lines}: "
                      f"{'ok' if files_ok else 'FAIL'}")
    if failed or len(records) != EVT2_WINDOWS or not files_ok:
        raise SystemExit(f"chip_smoke: EVT2 windows {failed}: PRED_FWL or the dumped flow wrong, or outputs missing")
    if 0 in (launches["fwd"], launches["bwd"], launches["vote"]):
        raise SystemExit("chip_smoke: the EVT2 FWL eval did not run K1, K2 and K8")
    return launches


def global_check(port_main, fi, dev, smi, rng) -> None:
    """``[global-check]``: each global model (2d-translation,
    4-param-similarity, 3-rotation) at 260x346 on the first window of the
    rotation config's 346 cell: the objective's value and gradient
    (``objective_check``) and its analytic HVP along a random direction
    (``hvp_check``) on the card against the CPU, and K1-K4 on the model's
    field (x ``t_scale``, the tangent the field of a random direction) against
    their plain versions and exact models (``compare``,
    ``check_second_order``), float64 and float32."""
    from event_based_optical_flow_tpu_torch.solver import objective

    with open(GLOBAL_ROT3D_CONFIG) as f:
        config = yaml.safe_load(f)
    config["data"] = global_346_data(config["data"])
    loader, events = first_window(config)
    h, w = config["data"]["height"], config["data"]["width"]
    for model in ("2d-translation", "4-param-similarity", "3-rotation"):
        cfg = copy.deepcopy(config)
        cfg["solver"]["motion_model"] = model
        solv = port_main.solver.collections[cfg["solver"]["method"]](
            (h, w), calibration_parameter=loader.load_calib(), solver_config=cfg["solver"],
            optimizer_config=cfg["optimizer"], output_config=cfg["output"], device="cpu")
        phase("global-check", f"{model} objective: " + objective_check(cfg, events, rng, solv, GLOBAL_CHECK_SPAN))
        phase("global-check", f"{model} analytic HVP: " + hvp_check(cfg, events, rng, solv, GLOBAL_CHECK_SPAN))
        spec = solv._current_spec()
        motion = rng.uniform(-GLOBAL_CHECK_SPAN, GLOBAL_CHECK_SPAN, solv.motion_vector_size)
        p = rng.normal(0.0, 1.0, solv.motion_vector_size)
        g_np = rng.normal(size=(3, len(OFFSETS), h, w))
        for dtype in (torch.float64, torch.float32):
            frame = objective.FrameEvents.from_numpy(events, dev, dtype)
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
            flow = objective.flow_of(spec, t(motion), frame.t_scale).contiguous()
            dflow = objective.flow_of(spec, t(p), frame.t_scale).contiguous()
            fe, be, fs, bs, same, exact = compare(fi, frame, flow, t(g_np[0]), False, OFFSETS)
            lines, _, ok2 = check_second_order(fi, frame, flow, dflow, t(g_np[1]), t(g_np[2]), TOL[dtype])
            ok = fe <= TOL[dtype] * fs and be <= TOL[dtype] * bs and same and exact == 0 and ok2
            phase("global-check", f"{model} {str(dtype)[6:]} N={len(events)} {h}x{w}, max|flow| "
                                  f"{flow.abs().max().item():.3g} px, max|dflow| {dflow.abs().max().item():.3g} px: "
                                  f"K1 fwd max|err| {fe:.3e} (scale {fs:.3g}), K2 bwd max|err| {be:.3e} (scale "
                                  f"{bs:.3g}), tol {TOL[dtype]:g} x scale; exact model: max|err| {exact:g}; repeat "
                                  f"same bits: {same}; " + "; ".join(lines) + f": {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: K1-K4 on the {model} field disagree with their plain versions")


def global_run(port_main, dev, smi, name: str, config: dict, last_frame: int, truth, cell: str):
    """Frames 0..last_frame of a global config through the CLI's eval loop
    (chained, a fresh output dir): per frame seconds, EPE against the zero
    flow's, PRED_FWL, host syncs, Newton iterations, the HVP, the solve's
    K1-K4 launches and the recovered parameters beside ``truth`` (the
    scene's, in the solver's sign convention).  Returns (records, the run's
    launches, peak device GiB)."""
    from event_based_optical_flow_tpu_torch import ops

    ops.reset_launch_counts()
    records, out_dir, wall, peak = run_slice(port_main, config, dev, last_frame)
    launches = ops.launch_counts()
    run_config = slice_config(config, last_frame, out_dir)
    loader, solv = port_main.build(run_config, dev)
    failed = []
    for r in records:
        m, st = r["metrics"], r["stats"]
        zero = zero_flow_epe(loader, run_config["data"], r["frame"], solv)
        ok = np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(m["PRED_FWL"])
        solve = st["launches"][0]
        got = ", ".join(f"{k} {v:.4f}" for k, v in st["params"].items())
        want = ", ".join(f"{k} {v:.4f}" for k, v in truth.items())
        phase(name, f"frame {r['frame']} ({'warm' if r['frame'] else 'cold'}): {r['seconds']:.3f} s, EPE "
                    f"{m['EPE']:.4f} (zero flow {zero:.4f}), AE {m['AE']:.4f}, GT_FWL {m['GT_FWL']:.4f}, PRED_FWL "
                    f"{m['PRED_FWL']:.4f}, host syncs {st['syncs']}, Newton iters {st['iters'][0]} ({st['hvp'][0]} "
                    f"HVP), loss {st['loss'][0]:.6f}, the solve's launches K1 {solve['fwd']} K2 {solve['bwd']} K3 "
                    f"{solve['jvp']} K4 {solve['hvp_bwd']}; recovered ({got}) against ({want}): "
                    f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(r["frame"])
    phase(name, f"{cell} on {smi}: {len(records)} frames in {wall:.2f} s, peak device memory {peak:.3f} GiB, "
                f"kernel launches {({k: v for k, v in launches.items() if v})}")
    if failed or len(records) != last_frame + 1:
        raise SystemExit(f"chip_smoke: {name} frames {failed}: metrics not finite or not below the zero flow")
    if 0 in (launches["fwd"], launches["bwd"], launches["vote"]):
        raise SystemExit(f"chip_smoke: {name} did not run K1, K2 and K8")
    return records, launches, peak


def global_path(dev, smi) -> dict:
    """The global motion-model solver: ``[global-check]``, then
    ``[global-sim]`` (``GLOBAL_SIM_CONFIG`` as shipped, frames 0..2 chained,
    then frame 0 with the loop, bit for bit), ``[global-rot3d]``
    (``GLOBAL_ROT3D_CONFIG`` as shipped, frames 0..2) and
    ``[global-rot3d-346]`` (its data block at 260x346, ``hvp_mode:
    analytic``, frames 0..1: K3 and K4).  Returns the three runs' launches."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.ops import fused_iwe as fi

    global_check(port_main, fi, dev, smi, np.random.default_rng(11))
    with open(GLOBAL_SIM_CONFIG) as f:
        sim = yaml.safe_load(f)
    with open(GLOBAL_ROT3D_CONFIG) as f:
        rot3d = yaml.safe_load(f)
    d = sim["data"]
    records, total, peak = global_run(
        port_main, dev, smi, "global-sim", sim, GLOBAL_LAST_FRAME,
        {"trans_x": 0.0, "trans_y": 0.0, "rot": -d["omega"], "zoom": 0.0},
        f"{GLOBAL_SIM_CONFIG} as shipped ({d['height']}x{d['width']}, {d['n_events_per_batch']}-event solves, "
        f"{sim['solver']['motion_model']}, {sim['optimizer']['n_iter']}-candidate sweep, FD HVP)")
    if not loop_repeat(port_main, sim, dev, records, peak, smi, "global-sim-repeat", "global similarity"):
        raise SystemExit("chip_smoke: the loop's run of the global frame 0 did not reproduce the chained result")
    runs = [(rot3d, "global-rot3d", GLOBAL_LAST_FRAME,
             f"{GLOBAL_ROT3D_CONFIG} as shipped ({rot3d['data']['height']}x{rot3d['data']['width']}, "
             f"focal {rot3d['data']['focal']} px, FD HVP)")]
    big = copy.deepcopy(rot3d)
    big["data"] = global_346_data(rot3d["data"])
    big["optimizer"]["hvp_mode"] = "analytic"
    runs.append((big, "global-rot3d-346", GLOBAL_346_LAST_FRAME,
                 f"{GLOBAL_ROT3D_CONFIG} at 260x346 (changed: height/width 120x152 -> 260x346, n_dots "
                 f"{rot3d['data']['n_dots']} -> {big['data']['n_dots']}, event_rate {rot3d['data']['event_rate']} "
                 f"-> {big['data']['event_rate']:.0f}, focal {rot3d['data']['focal']} dropped for the loader's "
                 f"(H + W) / 2 = 303; optimizer.hvp_mode: analytic)"))
    for config, name, last, cell in runs:
        omega3 = config["data"]["omega3"]
        records, launches, _ = global_run(port_main, dev, smi, name, config, last,
                                          {k: -v for k, v in zip(("rot_x", "rot_y", "rot_z"), omega3)}, cell)
        total = {k: total[k] + launches[k] for k in total}
    if 0 in (launches["jvp"], launches["hvp_bwd"]):
        raise SystemExit("chip_smoke: the analytic global solve did not run K3 and K4")
    return total


# ---- the visualizer, the host-driven optimizers, the trace --------------------

# the PNGs the JAX CLI writes per GT frame of a pyramid solve
# (main.py::evaluate_dataset_with_gt's visualize_*_sequential, the history plot)
VIZ_PREFIXES = ("original", "pred_warp", "pred_masked", "gt_warp", "gt_flow", "optimization_steps")
# The host-driven optimizers on the MVSEC slice's frame 0: (phase, optimizer
# block update, solver.patch update); the repeat reruns the second from a
# fresh solver.  Adam runs at lr 5 px/s: at the reference's default 0.05 its
# 40 steps per scale move a tile by at most 2 px/s from the random +-150 px/s
# coarsest start, and the JAX package's frame lands at EPE 21.56 (zero flow
# 3.42), at lr 2, 5, 10 at 0.640, 0.618, 0.639.  The sampling optimizer
# starts from zero: from the random start its 4 rounds of 10 joint
# candidates keep the coarsest basin (JAX: EPE 3.88), from zero 0.897
# (tools/screen_host_optimizers.py, the JAX package on the CPU at full size,
# float64, scatter backend).
# optax's LBFGS runs at lr 5 (the same screen, full size: lr 1, 5, 20 land
# the JAX package's frame at EPE 0.6994, 0.6893, 0.7015).
OPT_PHASES = (("opt-scipy-newton", {"method": "Newton-CG", "device": False}, {}),
              ("opt-bfgs", {"method": "BFGS"}, {}),
              ("opt-adam", {"method": "Adam", "lr": 5.0}, {}),
              ("opt-sampling", {"method": "optuna"}, {"initialize": "zero"}),
              ("opt-lbfgs", {"method": "LBFGS", "lr": 5.0}, {}))
# The phases held to EPE_FRACTION x the zero flow: scipy's Newton-CG (the
# original method's optimizer) and BFGS, the one of BFGS / Adam / optuna that
# the JAX package brings within it as shipped on this scene (EPE 0.812 against
# 3.42; at half size none of them is, nor the device Newton-CG with JAX's
# draws); the others must beat the zero flow.
OPT_GATED = ("opt-scipy-newton", "opt-bfgs", "opt-lbfgs")
# [trace]: the chained frame's Newton budget, cut from the config's 25 so the
# profiled frame's trace stays small
TRACE_MAX_ITER = 3
# [lbfgs], [lbfgs-dsec], [fleet-lbfgs]: optimizer.device_solver lbfgs with
# max_iter LBFGS_MAX_ITER on every scale, 3x the configs' Newton budget of 25
# (the JAX package's docstring: 2-4x).  The JAX package on the CPU at full
# size, float64 (tools/screen_host_optimizers.py): the MVSEC slice's frame 0
# at max_iter 50, 75, 100 lands at EPE 0.7026, 0.6647, 0.6518 against the
# zero flow's 3.4166.
LBFGS_MAX_ITER = 75
# [init-grid]: the cold starts swept through the coarsest scale's objective
GRID_INITS = (("grid-best", 30), ("global-best", 10))
# solver.outer_padding of the unfused phases' configs (unfused_config)
PAD = 8
# [pad-random-witness]: the pad frame from the config's random start at the
# screen's scale (scaled_config, float64), held to the JAX package's EPE of
# the same frame, start and size: `JAX_PLATFORMS=cpu python3
# tools/screen_host_optimizers.py --scale 0.35 --methods Newton-CG --set
# solver.outer_padding=8` (91x121, 3672 events; zero flow 3.3850).  The two
# packages draw their init sweeps from other generators (and the card's from
# another than the CPU's), and from this start the exact HVP's trajectory
# takes those draws into the EPE: the port on the CPU with the config's draws
# and sweep seeds 1-6 gives 25.2885-26.1353 (the screen's --port-seeds 1 2 3
# 4 5 6), a spread of 3.3% of JAX's EPE.  The band is twice that, rounded up.
WITNESS_SCALE = 0.35
WITNESS_JAX_EPE = 25.844328841979678
WITNESS_BAND = 0.1
# the Newton DSEC frame's line (dsec_path), printed beside [lbfgs-dsec]'s
DSEC_NEWTON = {}
# the multi-device layer's phases (mesh_path)
MESH_SHARDS = 4
MESH_FLEET_FRAMES = 3
MESH_DNN_STEPS = 5
MESH_DNN_LOSS_REL = 1e-6  # the JAX package's bounds (tests/test_models.py)
MESH_DNN_PARAM_ATOL = 1e-5
# float32's gate on the averaged gradient, relative to the largest: 2^-23
# times the reductions' ~100-term depth, with margin (the CPU: 7.2e-7)
MESH_DNN_GRAD_REL = 1e-5
# ``--distinct-devices``: the mesh phases over distinct cards (``distinct_main``)
DISTINCT_DEVICES = False


def viz_check(port_main, dev, smi, run_config: dict, out_dir: str, rng) -> None:
    """``[viz-check]``: the three visualization IWEs of the slice's frame 0
    (its window's events unwarped, warped to the window's middle by the
    solved motion as ``visualize_pred_sequential`` warps them, and warped
    by a random smooth GT as ``visualize_gt_sequential`` does) voted by K8
    and by the plain vote on the card: K8's float images against its exact
    model (max|err| 0) and the plain vote's, and the uint8 images' pixels
    that differ after the clip (at most 1 level, at truncation boundaries);
    the solver's own ``_warped_viz_iwe`` gives K8's image with one K8
    launch."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.ops import vote
    from event_based_optical_flow_tpu_torch.utils import checkpoint as ckpt
    from event_based_optical_flow_tpu_torch.visualizer import clip_iwe

    loader, solv = port_main.build(run_config, dev)
    d = run_config["data"]
    ts = loader.eval_frame_time_list()
    events = port_main._gather_frame(loader, d, ts[0], ts[d["eval_dt"]])[1]
    _, motion = ckpt.load_eval_state(out_dir)  # frame 0's solution: the slice warm-starts from it
    finest = solv.patch_scales - 1
    solv.overload_patch_configuration(finest)
    t_scale = solv._t_range(events)
    h, w = solv.image_shape
    with torch.no_grad():
        e = solv.tensor(events)
        flow = solv.motion_to_dense_flow({finest: solv.tensor(motion[finest])}, t_scale) * t_scale
        gt = solv.tensor(smooth_flow(h, w, rng))
        images = {"original": (e, None, "first"), "pred_warp": (e, flow, "middle"), "gt_warp": (e, gt, "first")}
        failed = []
        for name, (ev, fl, direction) in images.items():
            warped = ev if fl is None else solv.warper.warp_event(ev, fl, "dense-flow", direction)
            got = vote.bilinear_vote_kernel(warped, (h, w))
            plain = vote.bilinear_vote_plain(warped, (h, w))
            exact = exact_err(got, vote.bilinear_vote_fixed_reference(warped.cpu(), (h, w)))
            err = (got - plain).abs().max().item()
            k8_u8, plain_u8 = clip_iwe(got.cpu().numpy(), solv.iwe_visualize_max_scale), clip_iwe(
                plain.cpu().numpy(), solv.iwe_visualize_max_scale)
            levels = np.abs(k8_u8.astype(int) - plain_u8.astype(int))
            before = ops.launch_counts()["vote"]
            own = (solv.create_clipped_iwe_for_visualization(events, solv.iwe_visualize_max_scale) if fl is None
                   else solv._warped_viz_iwe(events, fl, "dense-flow", direction))
            own_launches = ops.launch_counts()["vote"] - before
            ok = exact == 0 and levels.max() <= 1 and np.array_equal(own, k8_u8) and own_launches == 1
            phase("viz-check", f"{name}: {len(events)} events -> {h}x{w} {str(got.dtype)[6:]} on {smi}: K8 against "
                               f"its exact model max|err| {exact:g}, against the plain vote {err:.3e}; uint8 after "
                               f"the clip (x{solv.iwe_visualize_max_scale}): {int((levels > 0).sum())} pixels differ "
                               f"from the plain vote's, by at most {int(levels.max())} level; the solver's image: "
                               f"K8's bits, {own_launches} K8 launch: {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(name)
    if failed:
        raise SystemExit(f"chip_smoke: visualization images {failed} disagree with K8's exact model or the plain vote")


def viz_cli(port_main, config: dict, records, out_dir: str, launches: dict, dev, smi) -> dict:
    """``[viz-cli]``: the PNGs the ``[mvsec-cli]`` run wrote (``visualize_every``
    1, as shipped) against the JAX CLI's names for its frames, the
    visualization's seconds per frame and K8 launches, and the same config
    with ``visualize_every: 0`` in a fresh output dir: the same metrics and
    solver stats bit for bit, its seconds beside the images run's (whose
    ``seconds`` end before the images).  Returns the second run's
    launches."""
    from event_based_optical_flow_tpu_torch import ops

    frames = [r["frame"] for r in records]
    names = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    want = sorted(f"{p}{i}.png" for p in VIZ_PREFIXES for i in range(len(frames)))
    plain = copy.deepcopy(config)
    plain["data"]["visualize_every"] = 0
    plain["output"]["output_dir"] = out_dir + "_no_viz"
    ops.reset_launch_counts()
    again = port_main.run(plain, eval_mode=True, device=dev)
    no_viz = ops.launch_counts()
    same = [a["metrics"] for a in again] == [r["metrics"] for r in records] and all(
        a["stats"][k] == r["stats"][k] for a, r in zip(again, records) for k in ("loss", "syncs", "launches"))
    per_prefix = {p: sorted(f for f in names if f.startswith(p) and f[len(p):-4].isdigit()) for p in VIZ_PREFIXES}
    viz_k8 = (launches["vote"] - no_viz["vote"]) / len(frames)
    ok = names == want and same and viz_k8 > 0
    phase("viz-cli", f"{MVSEC_CONFIG} frames {frames} with visualize_every 1 on {smi}: PNGs {per_prefix} (the JAX "
                     f"CLI's names: {names == want}); images {', '.join(f'{r['viz_seconds']:.3f}' for r in records)} "
                     f"s per frame after each record, K8 {viz_k8:g} launches per frame; frame seconds "
                     f"{', '.join(f'{r['seconds']:.3f}' for r in records)} against visualize_every 0's "
                     f"{', '.join(f'{a['seconds']:.3f}' for a in again)}; metrics, losses, syncs and launches bit "
                     f"for bit the same: {same}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the MVSEC CLI's images are not the JAX CLI's, or visualizing changed the solve")
    return no_viz


def optimizer_path(dev, smi) -> dict:
    """``[opt-*]``: the MVSEC slice's frame 0 through the CLI's eval loop with
    each host-driven optimizer of ``OPT_PHASES`` (a fresh output dir each):
    seconds, EPE against the zero flow's, host syncs, the solve's K1/K2
    launches, iterations per scale; each EPE finite and below the zero
    flow's, those of ``OPT_GATED`` below ``EPE_FRACTION`` of it.
    ``[opt-repeat]`` runs the BFGS frame again from a fresh solver: the same
    metrics, losses, syncs and launches.  Returns the runs' launches."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch import ops

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    total, failed, runs = None, [], {}
    for name, update, patch in OPT_PHASES + (("opt-repeat",) + OPT_PHASES[1][1:],):
        cfg = copy.deepcopy(config)
        cfg["optimizer"].update(update)
        cfg["solver"]["patch"].update(patch)
        ops.reset_launch_counts()
        records, out_dir, wall, peak = run_slice(port_main, cfg, dev, last_frame=0)
        launches = ops.launch_counts()
        total = launches if total is None else {k: total[k] + launches[k] for k in total}
        r = runs[name] = records[0]
        loader, solv = port_main.build(slice_config(cfg, 0, out_dir), dev)
        zero = zero_flow_epe(loader, cfg["data"], 0, solv)
        m, st = r["metrics"], r["stats"]
        solve = solve_launches(st)
        bound = EPE_FRACTION * zero if name in OPT_GATED else zero
        ok = np.isfinite(m["EPE"]) and m["EPE"] < bound and np.isfinite(m["PRED_FWL"])
        if name == "opt-repeat":
            first = runs[OPT_PHASES[1][0]]
            ok = ok and m == first["metrics"] and all(st[k] == first["stats"][k] for k in ("loss", "syncs", "launches"))
        phase(name, f"frame 0, optimizer {update}{', patch ' + str(patch) if patch else ''} on {smi}: "
                    f"{r['seconds']:.3f} s, EPE {m['EPE']:.4f} (zero flow "
                    f"{zero:.4f}, gate {'%.1f x zero flow' % EPE_FRACTION if name in OPT_GATED else 'zero flow'}), "
                    f"PRED_FWL {m['PRED_FWL']:.4f}, host syncs {st['syncs']}, iterations {st['iters']}, loss per "
                    f"scale { {s: round(v, 6) for s, v in st['loss'].items()} }, the solve's launches K1 "
                    f"{solve['fwd']} K2 {solve['bwd']} K8 {solve['vote']}, peak {peak:.3f} GiB"
                    + (", the same bits as [opt-bfgs]" if name == "opt-repeat" else "") + f": {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        if 0 in (solve["fwd"], launches["vote"]) or (update["method"] != "optuna" and solve["bwd"] == 0):
            failed.append(f"{name} (launches)")
    if failed:
        raise SystemExit(f"chip_smoke: optimizer phases {failed} failed their EPE gate, repeat or launches")
    return total


def trace_path(dev, smi) -> dict:
    """``[trace]``: one chained frame of the MVSEC slice (frame 0, the coarse
    and finest Newton budgets cut to ``TRACE_MAX_ITER``) with
    ``output.trace_dir``: ``profiled_optimize``'s ``torch.profiler`` trace
    must exist and name K1's kernel (``fused_iwe_fwd_kernel``) and K8's
    (``bilinear_vote``).  Returns the run's launches."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch import ops

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    config["optimizer"]["max_iter"] = TRACE_MAX_ITER
    trace_dir = tempfile.mkdtemp(prefix="evflow_chip_smoke_trace_")
    config["output"]["trace_dir"] = trace_dir
    ops.reset_launch_counts()
    records, _, wall, _ = run_slice(port_main, config, dev, last_frame=0)
    launches = ops.launch_counts()
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir) if f.endswith(".json")]
    text = open(files[0]).read() if len(files) == 1 else ""
    names = {k: k in text for k in ("fused_iwe_fwd_kernel", "bilinear_vote")}
    ok = len(files) == 1 and all(names.values()) and records[0]["stats"]["chain"]
    phase("trace", f"MVSEC slice frame 0 chained, max_iter {TRACE_MAX_ITER}, profiled on {smi}: "
                   f"{records[0]['seconds']:.3f} s, trace files {[os.path.basename(f) for f in files]}, "
                   f"{os.path.getsize(files[0]) / 2**20 if files else 0:.2f} MiB, names {names}, K1 "
                   f"{launches['fwd']} K8 {launches['vote']} launches: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the profiled solve wrote no trace naming K1 and K8")
    return launches


def lbfgs_config(config: dict) -> dict:
    """``config`` solved by the device L-BFGS (``optimizer.device_solver:
    lbfgs``, ``LBFGS_MAX_ITER`` iterations on every scale)."""
    config = copy.deepcopy(config)
    config["optimizer"].update(device_solver="lbfgs", max_iter=LBFGS_MAX_ITER)
    return config


def lbfgs_frame(port_main, name: str, config: dict, dev, smi, what: str):
    """Frame 0 of ``config`` chained: ``[name]``'s line (seconds, EPE against
    the zero flow's, syncs, L-BFGS iterations and launches per scale).
    Returns (records, peak GiB, launches, failed)."""
    from event_based_optical_flow_tpu_torch import ops

    ops.reset_launch_counts()
    records, out_dir, wall, peak = run_slice(port_main, config, dev, last_frame=0)
    launches = ops.launch_counts()
    loader, solv = port_main.build(slice_config(config, 0, out_dir), dev)
    r = records[0]
    m, st = r["metrics"], r["stats"]
    zero = zero_flow_epe(loader, config["data"], 0, solv)
    solve = solve_launches(st)
    ok = (np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(m["PRED_FWL"])
          and st["chain"] and set(st["hvp"].values()) == {"lbfgs"} and solve["fwd"] > 0 and solve["bwd"] > 0
          and solve["jvp"] == solve["hvp_bwd"] == 0)
    phase(name, f"{what} frame 0, device_solver lbfgs, max_iter {LBFGS_MAX_ITER}, chained on {smi}: "
                f"{r['seconds']:.3f} s, EPE {m['EPE']:.4f} (zero flow {zero:.4f}), PRED_FWL {m['PRED_FWL']:.4f}, "
                f"host syncs {st['syncs']}, L-BFGS iters {st['iters']}, events {st['events']}, the solve's launches "
                f"K1 {solve['fwd']} K2 {solve['bwd']} K3 {solve['jvp']} K4 {solve['hvp_bwd']} K8 {solve['vote']}, "
                f"loss {({s: round(v, 6) for s, v in st['loss'].items()})}, peak {peak:.3f} GiB: "
                f"{'ok' if ok else 'FAIL'}")
    return records, peak, launches, [] if ok else [name]


def lbfgs_path(dev, smi) -> dict:
    """``[lbfgs]``: the MVSEC slice's frame 0 with the device L-BFGS
    (``lbfgs_config``), chained, then in a fresh run with the loop: the same
    metrics, losses, iterations, syncs and launches (``[lbfgs-repeat]``,
    ``[chain]``).  ``[lbfgs-dsec]``: the DSEC path's blocks
    (``dsec_config``) with it, chained, beside the Newton ``[dsec-frame]``.
    ``[fleet-lbfgs]``: the fleet of ``FLEET_BATCH`` (frames 0..3,
    ``FLEET_SOLVER_SEED``) with the lockstep L-BFGS, chained, twice from
    fresh solvers: the same bits.  Every frame below ``EPE_FRACTION`` x its
    zero flow's; K1/K2 (batched in the fleet) and K8, no K3/K4.  Returns
    the runs' launches."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch import ops

    with open(CONFIG) as f:
        config = lbfgs_config(yaml.safe_load(f))
    records, peak, total, failed = lbfgs_frame(port_main, "lbfgs", config, dev, smi, "MVSEC slice")
    ops.reset_launch_counts()
    if not loop_repeat(port_main, config, dev, records, peak, smi, "lbfgs-repeat", "MVSEC L-BFGS"):
        failed.append("lbfgs-repeat")
    total = {k: total[k] + v for k, v in ops.launch_counts().items()}

    dsec, _, launches, dsec_failed = lbfgs_frame(port_main, "lbfgs-dsec", lbfgs_config(dsec_config()), dev, smi,
                                                 "DSEC path")
    total = {k: total[k] + launches[k] for k in total}
    failed += dsec_failed
    if DSEC_NEWTON:
        d = dsec[0]
        phase("lbfgs-dsec", f"beside the Newton [dsec-frame] 0: {d['seconds']:.3f} s against {DSEC_NEWTON['seconds']:.3f} "
                            f"s ({d['seconds'] / DSEC_NEWTON['seconds']:.2f}x), host syncs {d['stats']['syncs']} "
                            f"against {DSEC_NEWTON['syncs']}, EPE {d['metrics']['EPE']:.4f} against "
                            f"{DSEC_NEWTON['epe']:.4f}, K1 {solve_launches(d['stats'])['fwd']} against "
                            f"{DSEC_NEWTON['launches']['fwd']}, K2 {solve_launches(d['stats'])['bwd']} against "
                            f"{DSEC_NEWTON['launches']['bwd']}")

    fleet = lbfgs_config(fleet_config(config, FLEET_BATCH))
    rule = lambda st: all(c["batched_fwd"] > 0 and c["batched_bwd"] > 0  # noqa: E731
                          and c["batched_jvp"] == c["batched_hvp_bwd"] == 0 for c in st["launches"].values())
    runs = []
    for attempt in range(2):
        ops.reset_launch_counts()
        recs, run_config, loader, solv, wall, fpeak = run_fleet(port_main, fleet, dev, FLEET_BATCH)
        got = ops.launch_counts()
        total = {k: total[k] + got[k] for k in total}
        if attempt == 0:
            failed += [f"fleet-lbfgs {f}" for f in fleet_run_checks(recs, rule, loader, run_config, solv,
                                                                    "fleet-lbfgs")]
        runs.append((recs, wall, fpeak))
    (recs, wall, fpeak), (again, again_wall, _) = runs
    same = (len(again) == len(recs) == FLEET_BATCH and all(a["metrics"] == r["metrics"] for a, r in zip(again, recs))
            and all(again[0]["stats"][k] == recs[0]["stats"][k] for k in ("loss", "iters", "syncs", "launches")))
    phase("fleet-lbfgs", f"{len(recs)} windows in one chained batch in {wall:.2f} s ({wall / FLEET_BATCH:.3f} s per "
                         f"frame), batch host syncs {recs[0]['stats']['syncs']}, peak {fpeak:.3f} GiB; again from a "
                         f"fresh solver ({again_wall:.2f} s): metrics, losses, iterations, syncs and launches bit for "
                         f"bit the same: {'ok' if same else 'FAIL'} on {smi}")
    if not same:
        failed.append("fleet-lbfgs repeat")
    if failed:
        raise SystemExit(f"chip_smoke: L-BFGS phases {failed} failed their EPE gate, launches or repeat")
    return total


def init_path(dev, smi) -> dict:
    """``[init-grid]``: for ``grid-best`` (100 candidates) and
    ``global-best`` (900), the MVSEC slice's frame 0 window at the
    coarsest scale: the sweep as the solver runs it (chunks of
    ``GRID_SWEEP_CHUNK`` candidates through the batched objective, K7) and
    with one K1 evaluation per candidate, each timed with its launches and
    peak memory, and the plain version's sweep (the plain vote on the
    card): the chosen translation equal, or the two candidates' plain
    losses within ``TOL``; then frame 0 through the CLI's eval loop with
    that init (EPE below ``EPE_FRACTION`` x the zero flow's).
    ``[init-sampling]``: frame 0 with ``optuna-sampling``.  Returns the
    frame runs' launches."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.ops import fused_iwe as fi
    from event_based_optical_flow_tpu_torch.solver import objective, patch_base
    from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents, build_objective, build_orig_iwe

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    total, failed = None, []
    for init, step in GRID_INITS + (("optuna-sampling", None),):
        cfg = copy.deepcopy(config)
        cfg["solver"]["patch"]["initialize"] = init
        if step is not None:
            loader, solv = port_main.build(slice_config(cfg, 0, tempfile.mkdtemp(prefix="evflow_chip_smoke_")), dev)
            d = slice_config(cfg, 0, "")["data"]
            ts = loader.eval_frame_time_list()
            events = port_main._gather_frame(loader, d, ts[0], ts[d["eval_dt"]])[0]
            solv.overload_patch_configuration(solv.coarsest_scale)
            spec = solv._current_spec()
            frame = FrameEvents.from_numpy(events, dev, solv.dtype, solv.time_bin)
            orig = build_orig_iwe(spec)(frame)
            grid = patch_base.grid_translations(step)
            tiles = solv.tensor(np.repeat(grid[:, :, None], solv.n_patch, axis=2).reshape(len(grid), -1))
            per_candidate = lambda motions: torch.stack(  # noqa: E731  the other design: one K1 each
                [build_objective(spec)(m, orig, frame)[0] for m in motions])
            timed = {}
            for arm, sweep in (("kept", lambda m: solv._grid_sweep_losses(spec, frame, orig, m)),
                               ("per", per_candidate)):
                with torch.no_grad():
                    sweep(tiles[:patch_base.GRID_SWEEP_CHUNK])  # warm-up
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    ops.reset_launch_counts()
                    t0 = time.perf_counter()
                    losses = sweep(tiles)
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = {k: v for k, v in ops.launch_counts().items() if v}
                timed[arm] = (losses, seconds, counts, (torch.cuda.max_memory_allocated() - base) / 2**30)
            kernels = (objective.fused_iwe, fi.fused_iwe)
            objective.fused_iwe = fi.fused_iwe = fi.fused_iwe_reference
            try:
                t0 = time.perf_counter()
                plain = solv._grid_sweep_losses(spec, frame, orig, tiles).double().cpu().numpy()
                torch.cuda.synchronize()
                plain_seconds = time.perf_counter() - t0
            finally:
                objective.fused_iwe, fi.fused_iwe = kernels
            kept = timed["kept"][0].double().cpu().numpy()
            per = timed["per"][0].double().cpu().numpy()
            k, kp = int(np.nanargmin(kept)), int(np.nanargmin(plain))
            scale = np.abs(plain).max()
            err = float(np.abs(kept - plain).max() / scale)
            ok = (err <= TOL[solv.dtype] and float(np.abs(per - plain).max() / scale) <= TOL[solv.dtype]
                  and (k == kp or abs(plain[k] - plain[kp]) <= TOL[solv.dtype] * scale))
            (_, s_kept, c_kept, m_kept), (_, s_per, c_per, m_per) = timed["kept"], timed["per"]
            phase("init-grid", f"{init}: {len(grid)} candidates at scale {solv.coarsest_scale} ({solv.n_patch} tiles) "
                               f"on {len(events)} events, {str(solv.dtype)[6:]} on {smi}: chosen {grid[k].tolist()} "
                               f"(plain sweep: {grid[kp].tolist()}), loss {kept[k]:.6f} (plain {plain[k]:.6f}); "
                               f"sweep in chunks of {patch_base.GRID_SWEEP_CHUNK} {s_kept:.4f} s, launches {c_kept}, "
                               f"peak +{m_kept:.3f} GiB; one K1 per candidate {s_per:.4f} s, launches {c_per}, "
                               f"peak +{m_per:.3f} GiB; plain sweep {plain_seconds:.4f} s; max|loss - plain| "
                               f"{err:.2e} x max|plain| (tol {TOL[solv.dtype]:g}): {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{init} sweep")
        ops.reset_launch_counts()
        records, out_dir, wall, peak = run_slice(port_main, cfg, dev, last_frame=0)
        launches = ops.launch_counts()
        total = launches if total is None else {key: total[key] + v for key, v in launches.items()}
        loader, solv = port_main.build(slice_config(cfg, 0, out_dir), dev)
        r = records[0]
        m, st = r["metrics"], r["stats"]
        zero = zero_flow_epe(loader, cfg["data"], 0, solv)
        solve = solve_launches(st)
        ok = np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(m["PRED_FWL"]) and st["chain"]
        name = "init-grid" if step is not None else "init-sampling"
        phase(name, f"{init}: frame 0 chained on {smi}: {r['seconds']:.3f} s, EPE {m['EPE']:.4f} (zero flow "
                    f"{zero:.4f}), PRED_FWL {m['PRED_FWL']:.4f}, host syncs {st['syncs']}, Newton iters "
                    f"{st['iters']}, the solve's launches K1 {solve['fwd']} K2 {solve['bwd']} K7 "
                    f"{solve['batched_fwd']} K8 {solve['vote']}, loss "
                    f"{({s: round(v, 6) for s, v in st['loss'].items()})}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(init)
    if failed:
        raise SystemExit(f"chip_smoke: init phases {failed} failed their sweep check or EPE gate")
    return total


# ---- the EV-FlowNet path ------------------------------------------------------


def dnn_batch(config: dict, dev, dtype):
    """The first training batch of ``config`` as ``run_dnn_flow`` draws it
    (``models.train.draw_batch`` from ``np.random.default_rng(0)``):
    (events ``[B, N, 4]``, weights ``[B, N]``, image size)."""
    from event_based_optical_flow_tpu_torch.data import collections
    from event_based_optical_flow_tpu_torch.models import train

    d = config["data"]
    loader = collections[d["dataset"]](config=d)
    loader.set_sequence(d["sequence"])
    size = train.crop_size(d)
    ev, wt, _ = train.draw_batch(loader, np.random.default_rng(0), size, d["n_events_per_batch"],
                                 int(config["dnn"]["batch_size"]))
    return (torch.as_tensor(ev, dtype=dtype, device=dev), torch.as_tensor(wt, dtype=dtype, device=dev), size)


class plain_votes:
    """Inside: every standalone vote (``ops.iwe.bilinear_vote``, which the
    voxel featurizer and ``create_iwe`` call) runs K8's plain version on the
    same tensors, autograd differentiating it."""

    def __enter__(self):
        from event_based_optical_flow_tpu_torch.ops import iwe, vote

        self.saved = iwe.bilinear_vote
        iwe.bilinear_vote = vote.bilinear_vote_plain

    def __exit__(self, *exc):
        from event_based_optical_flow_tpu_torch.ops import iwe

        iwe.bilinear_vote = self.saved


class recorded_votes:
    """Inside: K8's launches are recorded as (events, weight, image size)."""

    def __enter__(self):
        from event_based_optical_flow_tpu_torch.ops import vote

        self.calls, self.kernel = [], vote.bilinear_vote_kernel

        def record(ev, image_size, weight=1.0, eps=1e-6, padding=0, count=False):
            self.calls.append((ev, weight, tuple(image_size)))
            return self.kernel(ev, image_size, weight, eps, padding, count)

        vote.bilinear_vote_kernel = record
        return self.calls

    def __exit__(self, *exc):
        from event_based_optical_flow_tpu_torch.ops import vote

        vote.bilinear_vote_kernel = self.kernel


def dnn_step_terms(config: dict, dev, dtype, model=None):
    """One training step's forward terms on the card: (model, voxel grids,
    flows as leaves that require grad, the multi-scale loss per item,
    events, weights, image size)."""
    from event_based_optical_flow_tpu_torch.models import EVFlowNet, events_to_voxel_grid
    from event_based_optical_flow_tpu_torch.models.train import default_scale_time, multi_scale_cmax_loss

    ev, wt, size = dnn_batch(config, dev, dtype)
    dnn = config["dnn"]
    if model is None:
        model = EVFlowNet(dnn["n_bin"], default_scale_time(dnn, size)).to(dev, dtype)
    voxel = events_to_voxel_grid(ev, size, dnn["n_bin"], wt)
    with torch.no_grad():
        flows = {k: v.requires_grad_(True) for k, v in model(voxel).items()}
    return model, voxel, flows, multi_scale_cmax_loss(flows, ev, size, wt), ev, wt, size


def dnn_check(dev, smi) -> dict:
    """``[dnn-check]`` on the first batch of each DNN cell (``DNN_CONFIG``:
    64x80, batch 2, 20 000 events, every K8 call in shared memory;
    ``dnn_346_config``: 256x336, 30 000 events, the voxel call and the
    finest loss call on K8's global sums), float64 and float32: the voxel
    grids (one K8 launch, polarity-signed weights) and the multi-scale loss
    with its gradient w.r.t. the four flow heads (one K8 launch per scale;
    the backward a gather) against the plain vote on the same tensors;
    every K8 call of the step against the exact model of its bits (max|err|
    0); the full network's forward on the card against the CPU from the
    same converted weights.  Returns the K8 launches of one step's forward
    and backward."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.models import EVFlowNet, convert
    from event_based_optical_flow_tpu_torch.ops import vote

    with open(DNN_CONFIG) as f:
        cells = (("64x80", yaml.safe_load(f)), ("256x336", dnn_346_config()))
    per_step = {}
    for name, config in cells:
        for dtype in (torch.float64, torch.float32):
            tol = TOL[dtype]
            ops.reset_launch_counts()
            with recorded_votes() as calls:
                model, voxel, flows, loss, ev, wt, size = dnn_step_terms(config, dev, dtype)
            forward = ops.launch_counts()["vote"]
            grads = torch.autograd.grad(loss.sum(), list(flows.values()))
            per_step = {"forward": forward, "backward": ops.launch_counts()["vote"] - forward}
            with plain_votes():
                _, p_voxel, p_flows, p_loss, *_ = dnn_step_terms(config, dev, dtype, model)
                p_grads = torch.autograd.grad(p_loss.sum(), list(p_flows.values()))
            rel = lambda a, b: (a - b).abs().max().item() / max(1.0, b.abs().max().item())
            errs = {"voxel": rel(voxel, p_voxel), "loss": rel(loss.detach(), p_loss.detach()),
                    "grad": max(rel(g, pg) for g, pg in zip(grads, p_grads))}
            signed = bool((calls[0][1] < 0).any())  # the voxel's polarity-signed votes
            paths = ["global" if s[0] * s[1] > vote.shared_pixels() else "shared" for _, _, s in calls]
            exact = max(exact_err(vote.bilinear_vote_kernel(e, s, w), vote.bilinear_vote_fixed_reference(
                e.cpu(), s, w.cpu() if torch.is_tensor(w) else w)) for e, w, s in calls)
            cpu = EVFlowNet(model.n_bin, model.scale_time).to(dtype)
            cpu.load_state_dict(convert.params_from_flax(convert.params_to_flax(model.state_dict())))
            with torch.no_grad():
                want = cpu(voxel.cpu())
                got = model(voxel)
            errs["net"] = max(rel(got[k].cpu(), want[k]) for k in want)
            # the 256x336 cell's signed voxel votes and finest loss votes take the global sums
            want_paths = ["global", "shared", "shared", "shared", "global"] if name == "256x336" else ["shared"] * 5
            ok = (max(errs.values()) <= tol and exact == 0 and signed and forward == 1 + len(flows)
                  and per_step["backward"] == 0 and paths == want_paths)
            phase("dnn-check", f"{str(dtype)[6:]} {name} batch {list(ev.shape)} -> {size[0]}x{size[1]}: voxel (K8, "
                               f"signed weights {signed}) rel err {errs['voxel']:.3e}, multi-scale loss "
                               f"{[round(v, 6) for v in loss.tolist()]} rel err {errs['loss']:.3e}, flow grads "
                               f"rel err {errs['grad']:.3e} (K8 vs the plain vote on the same tensors), network "
                               f"forward card vs CPU from converted weights rel err {errs['net']:.3e}, tol {tol:g} "
                               f"x scale; exact model of K8's {len(calls)} calls (voxel, scales 0-3: {paths}): "
                               f"max|err| {exact:g}; K8 launches forward {forward} (voxel 1 + loss {len(flows)} "
                               f"scales), backward {per_step['backward']}: " + ("ok" if ok else "FAIL"))
            if not ok:
                raise SystemExit("chip_smoke: the DNN path on the card disagrees with its plain version, the "
                                 "exact model or the CPU, or a call took another K8 path")
    return per_step


def dnn_run(port_main, config: dict, dev, eval_mode: bool):
    """``main.run`` of ``config`` in a fresh output dir, K8 counted from 0:
    (run result, seconds, peak GiB, launches, output dir)."""
    from event_based_optical_flow_tpu_torch import ops

    config = copy.deepcopy(config)
    config["output"]["output_dir"] = tempfile.mkdtemp(prefix="dnn_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = port_main.run(config, eval_mode, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (run, seconds, torch.cuda.max_memory_allocated() / 2**30, ops.launch_counts(),
            config["output"]["output_dir"])


def params_hash(model) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dnn_346_config() -> dict:
    """EV-FlowNet on ``CONFIG``'s data block (260x346 cropped to 256x336,
    30 000-event windows) with ``DNN_CONFIG``'s dnn block as shipped and
    ``DNN_346_STEPS`` steps."""
    with open(DNN_CONFIG) as f:
        config = yaml.safe_load(f)
    with open(CONFIG) as f:
        config["data"] = yaml.safe_load(f)["data"]
    config["dnn"]["n_steps"] = DNN_346_STEPS
    return config


def dnn_witness(config: dict, dev) -> dict:
    """``DNN_WITNESS_STEPS`` Adam steps of ``config`` in float64 from the
    seed on the card and on the CPU (the plain vote), on ``run_dnn_flow``'s
    first batches: ((losses, seconds) on the card, on the CPU)."""
    from event_based_optical_flow_tpu_torch.data import collections
    from event_based_optical_flow_tpu_torch.models import train

    d, dnn = config["data"], config["dnn"]
    loader = collections[d["dataset"]](config=d)
    loader.set_sequence(d["sequence"])
    size = train.crop_size(d)
    rng = np.random.default_rng(0)
    batches = [train.draw_batch(loader, rng, size, d["n_events_per_batch"], int(dnn["batch_size"]))[:2]
               for _ in range(DNN_WITNESS_STEPS)]
    out = []
    for device in (dev, torch.device("cpu")):
        model, opt = train.make_dnn_train_state(size, dnn["n_bin"], lr=float(dnn["lr"]),
                                                scale_time=train.default_scale_time(dnn, size), device=device,
                                                dtype=torch.float64)
        step, _ = train.dnn_train_step(model, opt, size, dnn["n_bin"], multi_scale=bool(dnn.get("multi_scale")))
        t0 = time.perf_counter()
        losses = [float(step(*(torch.as_tensor(a, device=device) for a in b))) for b in batches]
        out.append((losses, time.perf_counter() - t0))
    return tuple(out)


def dnn_vote_time(smi, config: dict, dev, name: str) -> list:
    """K8 at one training step's shapes of ``config`` (the voxel call and the
    finest scale's loss call, float32): kernel, plain version, one
    deterministic ``index_add`` of the corner terms, and the bound."""
    from event_based_optical_flow_tpu_torch.ops import vote

    with recorded_votes() as calls:
        dnn_step_terms(config, dev, torch.float32)
    out = []
    for what, (ev, wt, size) in (("voxel", calls[0]), ("loss-finest", calls[-1])):
        inds, vals, batch = vote.corner_terms(ev, size, wt)
        image = torch.zeros(int(np.prod(batch)) * size[0] * size[1], dtype=torch.float32, device=dev)
        t = {"ms": cuda_ms(lambda: vote.bilinear_vote_kernel(ev, size, wt)),
             "plain_ms": cuda_ms(lambda: vote.bilinear_vote_plain(ev, size, wt)),
             "library_ms": cuda_ms(lambda: image.index_add(0, inds, vals))}
        b_ms, b_by = vote_bound(ev, wt, size)
        path = "shared memory" if size[0] * size[1] <= vote.shared_pixels() else "global sums"
        out.append({"shape": f"{name} {what}", "events": list(ev.shape), "image": list(size), "path": path, **t,
                    "bound_ms": b_ms, "bound_by": b_by})
        phase("dnn-vote-time", f"{smi}: float32 {name} {what} {list(ev.shape)} -> {size[0]}x{size[1]} ({path}): "
                               f"kernel {t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms, library (index_add) "
                               f"{t['library_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return out


def dnn_path(dev, smi):
    """The EV-FlowNet path: ``[dnn-check]``, ``[dnn-train]`` (``DNN_CONFIG`` as
    shipped through ``main.run(..., eval_mode=True)``: 300 steps, the eval
    windows), ``[dnn-repeat]`` (``DNN_REPEAT_STEPS`` steps twice, the same
    bits), ``[dnn-346]`` (``dnn_346_config``) and its float64 witness (the
    card's steps against the CPU's), then K8's times at the DNN's shapes.
    Returns (the runs' launches, K8's DNN entry for the ``kernels``
    line)."""
    from event_based_optical_flow_tpu_torch import main as port_main

    per_step = dnn_check(dev, smi)
    with open(DNN_CONFIG) as f:
        config = yaml.safe_load(f)
    run, seconds, peak, launches, out_dir = dnn_run(port_main, config, dev, eval_mode=True)
    losses, steps = run["losses"], config["dnn"]["n_steps"]
    frames = len(run["eval"])
    zero = run["eval_zero_epe"]
    aee = [round(r["EPE"], 4) for r in run["eval"]]
    ckpt = os.path.join(out_dir, "checkpoints", f"step_{steps}", "state.pt")
    txt = os.path.join(out_dir, "dnn_flow_error.txt")
    want_launches = steps * per_step["forward"] + frames
    ok = (len(losses) == steps and np.isfinite(losses).all() and np.mean(losses[-10:]) < losses[0]
          and os.path.exists(ckpt) and os.path.exists(txt) and count_lines(txt) == frames + 1 and frames > 0
          and launches["vote"] == want_launches)
    phase("dnn-train", f"{smi}: {DNN_CONFIG} as shipped ({config['data']['height']}x{config['data']['width']}, "
                       f"batch {config['dnn']['batch_size']}, {config['data']['n_events_per_batch']} events, "
                       f"multi-scale), {steps} steps: median {np.median(run['step_seconds']):.4f} s/step, loss "
                       f"first {losses[0]:.6f}, last {losses[-1]:.6f}, mean of last 10 {np.mean(losses[-10:]):.6f}; "
                       f"K8 launches {launches['vote']} = {steps} steps x {per_step['forward']} (forward; backward "
                       f"{per_step['backward']}) + {frames} eval frames x 1; eval AEE per frame {aee} vs zero flow "
                       f"{[round(z, 4) for z in zero]} (mean {np.mean(aee):.4f} vs {np.mean(zero):.4f}); peak "
                       f"{peak:.3f} GiB; phase {seconds:.2f} s: " + ("ok" if ok else "FAIL"))
    if not ok:
        raise SystemExit("chip_smoke: DNN training did not descend, a loss is not finite, or the checkpoint, "
                         "dnn_flow_error.txt or K8's launches are missing")
    total = dict(launches)

    repeat = copy.deepcopy(config)
    repeat["dnn"]["n_steps"] = DNN_REPEAT_STEPS
    runs = []
    for _ in range(2):
        r, s, _, launches, _ = dnn_run(port_main, repeat, dev, eval_mode=False)
        runs.append((r["losses"], params_hash(r["model"]), s))
        total = {k: total[k] + launches[k] for k in total}
    same = runs[0][:2] == runs[1][:2]
    phase("dnn-repeat", f"{DNN_REPEAT_STEPS} steps from seed 0, twice: losses {runs[0][0][:3]}... last "
                        f"{runs[0][0][-1]:.9f} vs {runs[1][0][-1]:.9f}, params hash {runs[0][1]} vs {runs[1][1]} "
                        f"({runs[0][2]:.2f} s, {runs[1][2]:.2f} s): same bits: {same}: " + ("ok" if same else "FAIL"))
    if not same:
        raise SystemExit("chip_smoke: two DNN runs from one seed gave different bits")

    big = dnn_346_config()
    run, seconds, peak, launches, _ = dnn_run(port_main, big, dev, eval_mode=False)
    total = {k: total[k] + launches[k] for k in total}
    losses = run["losses"]
    ok = (len(losses) == DNN_346_STEPS and np.isfinite(losses).all()
          and launches["vote"] == DNN_346_STEPS * per_step["forward"])
    phase("dnn-346", f"{smi}: EV-FlowNet on {CONFIG}'s data block ({big['data']['height']}x{big['data']['width']} "
                     f"-> 256x336, {big['data']['n_events_per_batch']} events, batch {big['dnn']['batch_size']}, "
                     f"multi-scale, scale_time {big['dnn']['scale_time']}), {DNN_346_STEPS} steps: median "
                     f"{np.median(run['step_seconds']):.4f} s/step, losses {[round(v, 4) for v in losses]} (mean "
                     f"of the first 5 {np.mean(losses[:5]):.4f}, of the last 5 {np.mean(losses[-5:]):.4f}); K8 "
                     f"launches {launches['vote']}; peak {peak:.3f} GiB; phase {seconds:.2f} s: "
                     + ("ok" if ok else "FAIL"))
    if not ok:
        raise SystemExit("chip_smoke: the 256x336 DNN run failed")
    # the card's steps at 256x336 against the CPU's, in float64 (the float32
    # run above printed beside them)
    (card, card_s), (cpu, cpu_s) = dnn_witness(big, dev)
    err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(card, cpu))
    ok = np.isfinite(card).all() and err <= DNN_WITNESS_TOL
    phase("dnn-346-witness", f"{DNN_WITNESS_STEPS} float64 Adam steps at 256x336 from the seed on the first "
                             f"batches: card losses {[round(v, 9) for v in card]} ({card_s:.2f} s), CPU "
                             f"{[round(v, 9) for v in cpu]} ({cpu_s:.2f} s): max rel err {err:.3e}, tol "
                             f"{DNN_WITNESS_TOL:g}; the float32 run's first {DNN_WITNESS_STEPS} "
                             f"{[round(v, 6) for v in losses[:DNN_WITNESS_STEPS]]}: " + ("ok" if ok else "FAIL"))
    if not ok:
        raise SystemExit("chip_smoke: the card's float64 DNN steps at 256x336 disagree with the CPU's")
    shapes = dnn_vote_time(smi, config, dev, "64x80") + dnn_vote_time(smi, big, dev, "256x336")
    return total, {"launches_per_step": per_step, "shapes": shapes}


def unfused_config(config: dict, iwe: str = "bilinear_vote", init: str = "zero", **opt) -> dict:
    """``config`` on the JAX package's unfused objective: ``solver.outer_padding:
    PAD``, ``solver.iwe.method: iwe``, the cold start ``init`` and ``opt``
    in its optimizer block.  The zero start by default: from the config's
    random start (+-150 px/s) the route's exact HVP, which has no step clip
    in the JAX package either, diverges (``[pad-random]``)."""
    config = copy.deepcopy(config)
    config["solver"]["outer_padding"] = PAD
    config["solver"]["iwe"] = dict(config["solver"]["iwe"], method=iwe)
    config["solver"]["patch"] = dict(config["solver"]["patch"], initialize=init)
    config["optimizer"].update(opt)
    return config


def pad_check(fi, dev, config: dict, events: np.ndarray, rng):
    """``[pad-check]``: at ``PAD`` and the MVSEC slice's first window, float64
    and float32, K1 (orig and direction images; the count vote), K2, K3 and
    K4 against their plain versions (``TOL``) and exact models (max|err| 0),
    and their voxel forms (K5, K6: the time-aware path's 10 bins);
    the count vote's tangent and HVP term (zeros, no launch); K7's four
    batched kernels on a polarity frame's two-channel table; K8 padded and
    counting at the full frame and at the finest sweep call's shape.
    Returns the float32 errors of the padded K1-K4 (keyed by kernel)."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.ops import vote
    from event_based_optical_flow_tpu_torch.solver.objective import FleetEvents, FrameEvents

    h, w = config["data"]["height"], config["data"]["width"]
    hp, wp = h + 2 * PAD, w + 2 * PAD
    flow_np, dflow_np = smooth_flow(h, w, rng), rng.normal(0.0, 3.0, (2, h, w))
    n_bins = ta_config()["solver"]["time_bin"]
    vox_np, dvox_np = smooth_voxel(h, w, n_bins, rng), smooth_voxel(h, w, n_bins, rng)
    g_np = rng.normal(size=(1 + len(OFFSETS), hp, wp))
    g1_np, g2_np = rng.normal(size=(2, len(OFFSETS), hp, wp))
    (sweep_ev, sweep_wt), patch = sweep_call(port_main, config, events, dev)
    errs, failed = {}, []
    for dtype in (torch.float64, torch.float32):
        frame = FrameEvents.from_numpy(events, dev, dtype)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)  # noqa: E731
        flow, g, dflow, g1, g2 = t(flow_np), t(g_np), t(dflow_np), t(g1_np), t(g2_np)
        name = str(dtype)[6:]
        for include_orig, offsets, count in ((False, OFFSETS, False), (True, (), False), (True, OFFSETS, True)):
            fe, be, fs, bs, same, exact = compare(fi, frame, flow, g, include_orig, offsets, pad=PAD, count=count)
            ok = fe <= TOL[dtype] * fs and (be is None or be <= TOL[dtype] * bs) and same and exact == 0
            phase("pad-check", f"{name} K1{'' if count else '/K2'} pad {PAD} offsets={offsets} orig={include_orig} "
                               f"{'count' if count else 'bilinear'} N={len(events)} {h}x{w} -> {hp}x{wp}: fwd max|err| "
                               f"{fe:.3e} (scale {fs:.3g})" + ("" if be is None else f", bwd max|err| {be:.3e} "
                                                                                        f"(scale {bs:.3g})")
                               + f", tol {TOL[dtype]:g} x scale; exact model: max|err| {exact:g}; repeat same bits: "
                               + f"{same}: {'ok' if ok else 'FAIL'}")
            failed += [] if ok else [f"{name} K1/K2 pad count={count}"]
            if dtype == torch.float32 and offsets and not count:
                errs.update(fwd=fe, bwd=be)
        lines, second, ok = check_second_order(fi, frame, flow, dflow, g1, g2, TOL[dtype], pad=PAD)
        for line in lines:
            phase("pad-check", f"{name} pad {PAD}: {line}")
        failed += [] if ok else [f"{name} K3/K4 pad"]
        voxel = FrameEvents.from_numpy(events, dev, dtype, time_bin=n_bins)
        fe, be, fs, bs, same, exact = compare(fi, voxel, t(vox_np), g[1:].contiguous(), False, OFFSETS, pad=PAD)
        ok = fe <= TOL[dtype] * fs and be <= TOL[dtype] * bs and same and exact == 0
        lines, _, ok2 = check_second_order(fi, voxel, t(vox_np), t(dvox_np), g1, g2, TOL[dtype], names=("K6", "K6"),
                                           pad=PAD)
        for line in [f"K5 fwd max|err| {fe:.3e} (scale {fs:.3g}), bwd max|err| {be:.3e} (scale {bs:.3g}), tol "
                     f"{TOL[dtype]:g} x scale; exact model: max|err| {exact:g}; repeat same bits: {same}"] + lines:
            phase("pad-check", f"{name} T={n_bins} pad {PAD}: {line}: {'ok' if ok and ok2 else 'FAIL'}")
        failed += [] if ok and ok2 else [f"{name} K5/K6 pad"]
        if dtype == torch.float32:
            errs.update(second)
        ev = (frame.x, frame.y, frame.dtf, frame.wt)
        before = dict(ops.launch_counts())
        val, tan = fi.fused_iwe_jvp(flow, dflow, *ev, OFFSETS, True, pad=PAD, count=True)
        term = fi.fused_iwe_hvp_bwd(flow, dflow, g1, g2, *ev, OFFSETS, True, pad=PAD, count=True)
        fwd_bits = torch.equal(val, fi.fused_iwe_fwd(flow, *ev, OFFSETS, False, pad=PAD, count=True))
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        ok = fwd_bits and not tan.abs().max().item() and not term.abs().max().item() and launched == {"fwd": 2}
        phase("pad-check", f"{name} count vote pad {PAD}: tangent and HVP term all zeros, value == K1's count bits: "
                           f"{fwd_bits}, launches {launched} (K1 only): {'ok' if ok else 'FAIL'}")
        failed += [] if ok else [f"{name} count tangent"]
        pol = FrameEvents.from_numpy(events, dev, dtype, polarity=True)
        fleet = FleetEvents(pol.x, pol.y, pol.dtf, pol.wt, pol.t_scale.repeat(2), pol.channels)
        two = lambda a: a.expand((2,) + tuple(a.shape)).contiguous()  # noqa: E731
        lines, batched, ok = fleet_kernel_check(fi, fleet, two(flow), two(dflow), two(g[1:]), two(g1), two(g2),
                                                TOL[dtype], pad=PAD)
        for line in lines:
            phase("pad-check", f"{name} K7 polarity channels (B=2, {fleet.frames.sizes}) pad {PAD}: {line}")
        failed += [] if ok else [f"{name} K7 pad"]
        frame_ev = torch.as_tensor(events, dtype=dtype, device=dev)
        sweep = (sweep_ev.to(dtype), sweep_wt.to(dtype), (patch[0] + 2 * PAD, patch[1] + 2 * PAD))
        for what, (e, wt, size) in (("frame", (frame_ev, 1.0, (hp, wp))), ("sweep", sweep)):
            for count in (False, True):
                got = vote.bilinear_vote_kernel(e, size, wt, padding=PAD, count=count)
                want = vote.bilinear_vote_plain(e, size, wt, padding=PAD, count=count)
                torch.cuda.synchronize()
                err, scale = (got - want).abs().max().item(), max(1.0, want.abs().max().item())
                cw = wt.cpu() if torch.is_tensor(wt) else wt
                exact = exact_err(got, vote.bilinear_vote_fixed_reference(e.cpu(), size, cw, padding=PAD,
                                                                          count=count))
                same = torch.equal(got, vote.bilinear_vote_kernel(e, size, wt, padding=PAD, count=count))
                ok = err <= TOL[dtype] * scale and exact == 0 and same
                phase("pad-check", f"{name} K8 {what} {'count' if count else 'bilinear'} pad {PAD}: events "
                                   f"{list(e.shape)} -> images {list(got.shape)}: max|err| {err:.3e} (scale "
                                   f"{scale:.3g}), tol {TOL[dtype]:g} x scale; exact model: max|err| {exact:g}; "
                                   f"repeat same bits: {same}: {'ok' if ok else 'FAIL'}")
                failed += [] if ok else [f"{name} K8 {what} count={count}"]
    if failed:
        raise SystemExit(f"chip_smoke: padded or counting kernels {failed} disagree with their plain versions or "
                         "exact models")
    return errs


def pad_time(fi, dev, smi, config: dict, events: np.ndarray, rng) -> dict:
    """``[pad-time]``: float32 K1-K4 at ``PAD`` against ``pad`` 0 on the
    MVSEC slice's first window, kernels and plain versions, with each
    bound; K5/K6 (the time-aware path's 10 bins) and K7 (a polarity
    frame's two-channel table) at ``PAD``; K8 padded and counting at the
    finest sweep call's shape and a full frame.  Returns {kernel form:
    {ms, plain_ms, bound_ms, bound_by[, ms_pad0]}}."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.ops import vote
    from event_based_optical_flow_tpu_torch.solver.objective import FleetEvents, FrameEvents

    h, w = config["data"]["height"], config["data"]["width"]
    frame = FrameEvents.from_numpy(events, dev, torch.float32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    flow, dflow = t(smooth_flow(h, w, rng)), t(rng.normal(0.0, 3.0, (2, h, w)))
    out = {}
    names = ("fwd", "bwd", "jvp", "hvp_bwd")
    for pad in (0, PAD):
        g1, g2 = t(rng.normal(size=(2, len(OFFSETS), h + 2 * pad, w + 2 * pad)))
        out[pad] = time_kernels(fi, frame, flow, dflow, g1, g2, names, pad=pad)
    rows = {}
    for name in names:
        b_ms, b_by = bound(name, frame, flow, PAD)
        rows[name] = {"ms": out[PAD][name], "plain_ms": out[PAD][f"{name}_plain"], "bound_ms": b_ms,
                      "bound_by": b_by, "ms_pad0": out[0][name]}
        phase("pad-time", f"{smi}: float32 {name} N={len(events)} {h}x{w} pad {PAD} ({h + 2 * PAD}x{w + 2 * PAD} "
                          f"images): kernel {out[PAD][name]:.4f} ms (pad 0: {out[0][name]:.4f} ms, "
                          f"{out[PAD][name] / out[0][name]:.2f}x) vs plain {out[PAD][f'{name}_plain']:.4f} ms, bound "
                          f"{b_ms:.6f} ms ({b_by}) (CUDA events, mean of 50 after 5 warm-up; jvp tangent only, "
                          "hvp_bwd term_a=False)")
    n_bins = ta_config()["solver"]["time_bin"]
    voxel = FrameEvents.from_numpy(events, dev, torch.float32, time_bin=n_bins)
    vox, dvox = t(smooth_voxel(h, w, n_bins, rng)), t(smooth_voxel(h, w, n_bins, rng))
    pol = FrameEvents.from_numpy(events, dev, torch.float32, polarity=True)
    fleet = FleetEvents(pol.x, pol.y, pol.dtf, pol.wt, pol.t_scale.repeat(2), pol.channels)
    two = lambda a: a.expand((2,) + tuple(a.shape)).contiguous()  # noqa: E731
    g1, g2 = t(rng.normal(size=(2, len(OFFSETS), h + 2 * PAD, w + 2 * PAD)))
    voxels = FleetEvents.copies(voxel, 2)
    for form, frame_f, fl, dfl, a1, a2, batch, what in (
            ("voxel_", voxel, vox, dvox, g1, g2, None, f"T={n_bins}"),
            ("batched_", fleet, two(flow), two(dflow), two(g1), two(g2), fleet, "polarity channels B=2"),
            ("batched_voxel_", voxels, two(vox), two(dvox), two(g1), two(g2), voxels, f"T={n_bins} B=2")):
        times = time_kernels(fi, frame_f, fl, dfl, a1, a2, names, frames=None if batch is None else batch.frames,
                             pad=PAD)
        for name in names:
            b_ms, b_by = bound(name, frame_f, fl, PAD) if batch is None else fleet_bound(name, batch, fl, PAD)
            rows[form + name] = {"ms": times[name], "plain_ms": times[f"{name}_plain"], "bound_ms": b_ms,
                                 "bound_by": b_by}
        bounds = ", ".join(f"{rows[form + n]['bound_ms']:.6f}" for n in names)
        phase("pad-time", time_line(smi, times, names, f"{what} N={len(events)} {h}x{w} pad {PAD}")
              + f"; bounds {bounds} ms")
    (sweep_ev, sweep_wt), patch = sweep_call(port_main, config, events, dev)
    frame_ev = torch.as_tensor(events, dtype=torch.float32, device=dev)
    sweep = (sweep_ev.float(), sweep_wt.float(), (patch[0] + 2 * PAD, patch[1] + 2 * PAD))
    for what, (e, wt, size) in (("sweep", sweep), ("frame", (frame_ev, 1.0, (h + 2 * PAD, w + 2 * PAD)))):
        for count in (False, True):
            ms = cuda_ms(lambda: vote.bilinear_vote_kernel(e, size, wt, padding=PAD, count=count))
            plain_ms = cuda_ms(lambda: vote.bilinear_vote_plain(e, size, wt, padding=PAD, count=count))
            b_ms, b_by = vote_bound(e, wt, size)
            rows[f"vote_{what}{'_count' if count else ''}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                                              "bound_by": b_by}
            phase("pad-time", f"{smi}: float32 K8 {what} {'count' if count else 'bilinear'} pad {PAD} {list(e.shape)}"
                              f" -> {list(size)}: kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
                              f"({b_by}) (CUDA events, mean of 50 after 5 warm-up)")
    return rows


def unfused_frame(port_main, name: str, config: dict, dev, smi, what: str, rule, gated: bool = True,
                  repeat: bool = True):
    """Frame 0 of ``config`` through the CLI's eval loop (chained where its
    optimizer runs chained): ``[name]``'s line (seconds, EPE against the
    zero flow's, syncs, iterations, HVP, launches, peak memory), gated at
    ``EPE_FRACTION`` of the zero flow's with ``gated``; ``rule(launches)``
    checks the solve's kernels; with ``repeat`` the loop's rerun gives the
    same bits (``loop_repeat``).  Returns (launches, failed)."""
    from event_based_optical_flow_tpu_torch import ops

    ops.reset_launch_counts()
    records, out_dir, wall, peak = run_slice(port_main, config, dev, last_frame=0)
    total = ops.launch_counts()
    loader, solv = port_main.build(slice_config(config, 0, out_dir), dev)
    r = records[0]
    m, st = r["metrics"], r["stats"]
    zero = zero_flow_epe(loader, config["data"], 0, solv)
    solve = solve_launches(st)
    epe_ok = bool(np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero)
    ok = np.isfinite(m["EPE"]) and np.isfinite(m["PRED_FWL"]) and rule(solve) and (epe_ok or not gated)
    used = {k: v for k, v in solve.items() if v}
    phase(name, f"{what} frame 0 ({'chained' if st['chain'] else 'the loop'}) on {smi}: {r['seconds']:.3f} s, EPE "
                f"{m['EPE']:.4f} (zero flow {zero:.4f}{'' if gated else '; ungated, see below'}), PRED_FWL "
                f"{m['PRED_FWL']:.4f}, host syncs {st['syncs']}, iters {st['iters']}, HVP {st['hvp']}, the solve's "
                f"launches {used}, loss {({s: round(v, 6) for s, v in st['loss'].items()})}, peak {peak:.3f} GiB: "
                f"{'ok' if ok else 'FAIL'}")
    failed = [] if ok else [name]
    if repeat:
        ops.reset_launch_counts()
        if not loop_repeat(port_main, config, dev, records, peak, smi, f"{name}-repeat", what):
            failed.append(f"{name}-repeat")
        total = {k: total[k] + v for k, v in ops.launch_counts().items()}
    return total, failed, epe_ok


def random_witness(dev, smi, rule) -> list:
    """``[pad-random-witness]``: ``[pad-random]``'s frame at the screen's
    ``WITNESS_SCALE``, float64, on the card from the config's random start,
    its EPE within ``WITNESS_BAND`` of the JAX package's (``WITNESS_JAX_EPE``)
    and its solve through K1-K4 (``rule``).  Returns the failed names."""
    from event_based_optical_flow_tpu_torch import ops

    config = scaled_config(WITNESS_SCALE, "Newton-CG", tempfile.mkdtemp(prefix="evflow_chip_smoke_"),
                           [f"solver.outer_padding={PAD}"])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m, zero, st = frame0_solve(config, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    off = abs(m["EPE"] - WITNESS_JAX_EPE) / WITNESS_JAX_EPE
    ok = bool(np.isfinite(m["EPE"]) and off <= WITNESS_BAND and rule(launches) and set(st["hvp"].values()) == {"exact"})
    d = config["data"]
    phase("pad-random-witness", f"{d['height']}x{d['width']}, outer_padding {PAD}, float64, the config's random start "
                                f"on {smi}: {wall:.3f} s, EPE {m['EPE']!r} against the JAX package's "
                                f"{WITNESS_JAX_EPE!r} ({off:.2%} off, band {WITNESS_BAND:.0%}; zero flow {zero:.4f}), "
                                f"iters {st['iters']}, HVP {st['hvp']}, loss {st['loss']}: {'ok' if ok else 'FAIL'}")
    return [] if ok else ["pad-random-witness"]


def unfused_path(fi, dev, smi, config: dict, events: np.ndarray, rng):
    """The JAX package's unfused objective's options on the MVSEC slice,
    every config ``unfused_config`` of it (``solver.outer_padding: PAD``):
    ``[pad-check]``, ``[pad-time]``, then frame 0 through the CLI's eval
    loop from the zero start: ``[pad-frame]`` (bilinear votes into the
    padded images: K1-K4), ``[polarity-frame]`` (the two polarity channels:
    K7's four batched kernels), each chained and again with the loop, bit
    for bit, gated at ``EPE_FRACTION`` of the zero flow's; ``[pad-random]``
    the pad frame from the config's random start, printed ungated (the
    exact HVP's divergence, the JAX package's too:
    ``tools/screen_host_optimizers.py``); ``[pad-ta-frame]`` the time-aware
    path's frame 0 (K5, K6 and the voxel map's curvature: the exact HVP),
    chained, gated; ``[count-frame]`` (the count vote,
    no image gradient: the sampling optimizer, K1 only), printed ungated
    (the JAX package's EPE for this draw at this size is not taken: a
    full-size CPU run of it is not made); ``[pad-fleet]``: the fleet of
    ``FLEET_BATCH`` with padding and the polarity vote (K7 over the 2B
    channels' table, the exact HVP), chained, gated; ``[pad-serve]``: a serving
    estimator with ``outer_padding`` and the zero start takes the serving
    path's window 0 cold.  Returns (launches of the runs, the float32 errors and the
    ``[pad-time]`` rows of K1-K4)."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.streaming import StreamingFlowEstimator

    errs = pad_check(fi, dev, config, events, rng)
    rows = pad_time(fi, dev, smi, config, events, rng)
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]
    single = lambda s: all(s[k] > 0 for k in ("fwd", "bwd", "jvp", "hvp_bwd"))  # noqa: E731
    batched = lambda s: all(s[f"batched_{k}"] > 0 for k in ("fwd", "bwd", "jvp", "hvp_bwd"))  # noqa: E731
    count = lambda s: s["fwd"] > 0 and s["bwd"] == s["jvp"] == s["hvp_bwd"] == 0  # noqa: E731
    voxel = lambda s: all(s[f"voxel_{k}"] > 0 for k in ("fwd", "bwd", "jvp", "hvp_bwd"))  # noqa: E731
    total, failed = {}, []
    for name, cfg, rule, gated, repeat, what in (
            ("pad-frame", unfused_config(config), single, True, True, f"MVSEC slice, outer_padding {PAD}"),
            ("polarity-frame", unfused_config(config, "polarity"), batched, True, True,
             f"MVSEC slice, outer_padding {PAD}, iwe.method polarity"),
            ("pad-random", unfused_config(config, init="random"), single, False, False,
             f"MVSEC slice, outer_padding {PAD}, the random start"),
            ("pad-ta-frame", unfused_config(ta_config(), coarse_max_iter=TA_COARSE_MAX_ITER), voxel, True, False,
             f"time-aware path (Burgers, T=10, coarse scales cut to {TA_COARSE_MAX_ITER}), outer_padding {PAD}"),
            ("count-frame", unfused_config(config, "count", method="optuna"), count, False, False,
             f"MVSEC slice, outer_padding {PAD}, iwe.method count, optimizer.method optuna")):
        launches, bad, epe_ok = unfused_frame(port_main, name, cfg, dev, smi, what, rule, gated, repeat)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        failed += bad
        if name == "count-frame":
            phase(name, f"ungated: the JAX package's EPE for this draw at 260x346 is not measured (no full-size CPU "
                        f"run); below {EPE_FRACTION} x the zero flow's: {epe_ok}")
        elif not gated:
            phase(name, f"ungated: from the random start the exact HVP (no step clip, as in the JAX package) "
                        f"diverges, the JAX package's too ([pad-random-witness]); below {EPE_FRACTION} x the zero "
                        f"flow's: {epe_ok}")
            failed += random_witness(dev, smi, single)
    ops.reset_launch_counts()
    recs, run_config, loader, solv, wall, fpeak = run_fleet(port_main, fleet_config(unfused_config(config, "polarity"),
                                                                                     FLEET_BATCH), dev, FLEET_BATCH)
    total = {k: total[k] + v for k, v in ops.launch_counts().items()}
    rule = lambda st: (set(st["hvp"].values()) == {"exact"}  # noqa: E731
                       and all(batched({k: c.get(k, 0) for k in total}) for c in st["launches"].values()))
    failed += [f"pad-fleet {f}" for f in fleet_run_checks(recs, rule, loader, run_config, solv, "pad-fleet")]
    phase("pad-fleet", f"{len(recs)} windows, outer_padding {PAD}, iwe.method polarity, in one chained batch in "
                       f"{wall:.2f} s ({wall / FLEET_BATCH:.3f} s per frame), peak {fpeak:.3f} GiB on {smi}")
    windows = serve_windows(config, 1)
    h, w = config["data"]["height"], config["data"]["width"]
    est = StreamingFlowEstimator((h, w), solver_config={"seed": SERVE_SOLVER_SEED, "outer_padding": PAD,
                                                        "patch": {"initialize": "zero"}},
                                 fixed_event_count=SERVE_EVENT_COUNT, device=dev)
    events0, gt, seconds = windows[0]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    flow = est.push(events0)
    span = est.last_span
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    total = {k: total[k] + v for k, v in launches.items()}
    pred = np.asarray(flow, dtype=np.float64) / span * seconds
    m, zero = est.metrics(pred, gt, events0), est.metrics(np.zeros_like(pred), gt, events0)["EPE"]
    stats = est._solver.last_frame_stats
    ok = (np.isfinite(pred).all() and m["EPE"] < EPE_FRACTION * zero and single(launches)
          and set(stats["hvp"].values()) == {"exact"})
    phase("pad-serve", f"window 0 cold (zero start) to a serving estimator with outer_padding {PAD} on {smi}: "
                       f"{wall:.3f} s, EPE "
                       f"{m['EPE']:.4f} (zero flow {zero:.4f}), HVP {stats['hvp']}, host syncs {stats['syncs']}, "
                       f"launches {({k: v for k, v in launches.items() if v})}: {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("pad-serve")
    if failed:
        raise SystemExit(f"chip_smoke: unfused phases {failed} failed their EPE gate, launches or repeat")
    return total, rows


def smoke_mesh(dev, data: int, event: int):
    """A ``data`` x ``event`` mesh whose every device is this card; with
    ``--distinct-devices``, over the first ``data * event`` visible cards."""
    from event_based_optical_flow_tpu_torch.parallel import make_mesh

    if DISTINCT_DEVICES:
        return make_mesh(data * event, data=data, event=event)
    card = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    return make_mesh(data * event, data=data, event=event, devices=[card] * (data * event))


def mesh_text(mesh) -> str:
    """The mesh's devices, for the phase lines."""
    devices = list(mesh.devices.reshape(-1))
    if len(set(devices)) == 1:
        return f"{len(devices)} x this card"
    return ", ".join(str(d) for d in devices)


def mesh_check(dev, smi, config: dict, events: np.ndarray, rng):
    """``[mesh-check]``: each kernel's sharded form against the unsharded
    kernel on the same inputs (max|err| 0), float64 and float32, and the
    float32 sharded call's time against the unsharded one's.  Returns
    ({kernel: max|err|}, {kernel: (sharded ms, unsharded ms)}, the check's
    mesh launches)."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.ops import fused_iwe as fi
    from event_based_optical_flow_tpu_torch.ops import vote
    from event_based_optical_flow_tpu_torch.parallel.sharded import sharded_vote, sum_on
    from event_based_optical_flow_tpu_torch.solver import objective as obj
    from event_based_optical_flow_tpu_torch.solver.objective import FleetEvents, FrameEvents

    h, w = config["data"]["height"], config["data"]["width"]
    n_bins = ta_config()["solver"]["time_bin"]
    mesh = smoke_mesh(dev, 1, MESH_SHARDS)
    devices = mesh.event_devices()
    flows = {None: smooth_flow(h, w, rng), n_bins: smooth_voxel(h, w, n_bins, rng)}
    dflows = {None: smooth_flow(h, w, rng), n_bins: smooth_voxel(h, w, n_bins, rng)}
    g_np = rng.normal(size=(3, len(OFFSETS), h, w))
    windows = fleet_windows(config, FLEET_BATCH)
    fleet_flows = {None: np.stack([smooth_flow(h, w, rng) for _ in windows]),
                   n_bins: np.stack([smooth_voxel(h, w, n_bins, rng) for _ in windows])}
    errs, times = {}, {}
    ops.reset_launch_counts()
    for dtype in (torch.float64, torch.float32):
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)  # noqa: E731
        g, g1, g2 = (t(a) for a in g_np)
        for tb in (None, n_bins):
            frame = FrameEvents.from_numpy(events, dev, dtype, tb)
            sf = frame.shard(devices)
            ev = (frame.x, frame.y, frame.dtf, frame.wt)
            flow, dflow, pre = t(flows[tb]), t(dflows[tb]), "" if tb is None else "voxel_"
            # the orig image: a dense zero flow, no bins (the objective's orig call)
            zeros = torch.zeros((2, h, w), dtype=dtype, device=dev)
            dense_sf = obj.ShardedFrame(tuple(dataclasses.replace(sh, bins=None) for sh in sf.shards), sf.t_scale,
                                        sf.n_total)

            def parts(fn):
                return sum_on((fn(sh) for sh in sf.voting()), sf.lead, flow)

            calls = {
                "fwd": (lambda: obj._sharded_images(flow, sf, OFFSETS, False),
                        lambda: fi.fused_iwe_fwd(flow, *ev, OFFSETS, False, bins=frame.bins)),
                "fwd_orig": (lambda: obj._sharded_images(zeros, dense_sf, (), True),
                             lambda: fi.fused_iwe_fwd(zeros, *ev, (), True)),
                "bwd": (lambda: parts(lambda sh: fi.fused_iwe_bwd(flow.to(sh.x.device), sh.x, sh.y, sh.dtf, sh.wt,
                                                                    g.to(sh.x.device), OFFSETS, False, bins=sh.bins,
                                                                    mesh=True)),
                        lambda: fi.fused_iwe_bwd(flow, *ev, g, OFFSETS, False, bins=frame.bins)),
                "jvp": (lambda: obj._sharded_tangent(flow, dflow, sf, OFFSETS),
                        lambda: fi.fused_iwe_jvp(flow, dflow, *ev, OFFSETS, False, bins=frame.bins)),
                "hvp_bwd": (lambda: obj._sharded_hvp_bwd(flow, dflow, g1, g2, sf, OFFSETS, False),
                            lambda: fi.fused_iwe_hvp_bwd(flow, dflow, g1, g2, *ev, OFFSETS, False, bins=frame.bins)),
                "hvp_bwd_term_a": (lambda: obj._sharded_hvp_bwd(flow, dflow, g1, g2, sf, OFFSETS, True),
                                   lambda: fi.fused_iwe_hvp_bwd(flow, dflow, g1, g2, *ev, OFFSETS, True,
                                                                bins=frame.bins)),
            }
            line = []
            for name, (sharded, single) in calls.items():
                a, b = sharded(), single()
                err = (a - b).abs().max().item() if torch.equal(torch.isnan(a), torch.isnan(b)) else float("inf")
                key = pre + name.replace("_orig", "").replace("_term_a", "")
                errs[key] = max(errs.get(key, 0.0), err)
                line.append(f"{name} {err:g}")
                if dtype == torch.float32 and name in ("fwd", "bwd", "jvp", "hvp_bwd"):
                    times[key] = (cuda_ms(sharded, 3, 20), cuda_ms(single, 3, 20))
            ok = all(errs[k] == 0 for k in errs)
            phase("mesh-check", f"{str(dtype)[6:]} N={len(events)} {h}x{w}{'' if tb is None else f' T={tb}'} "
                                f"offsets={OFFSETS}, {MESH_SHARDS} run-aligned shards of "
                                f"{[sh.x.shape[0] for sh in sf.shards]} events on {mesh_text(mesh)} ({smi}): sharded "
                                f"vs unsharded "
                                f"max|err| {', '.join(line)}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("chip_smoke: a sharded kernel differs from the unsharded kernel")
        # K7: one batched call per data shard (2 + 2 frames) against one call over the batch
        for tb in (None, n_bins):
            whole = FleetEvents.from_numpy(windows, dev, dtype, tb)
            halves = [(i, FleetEvents.from_numpy(windows[i:i + 2], dev, dtype, tb)) for i in (0, 2)]
            fl = t(fleet_flows[tb])
            dfl = torch.flip(fl, (0,)).contiguous()
            gb, gb1, gb2 = (torch.as_tensor(rng.normal(size=(len(windows), len(OFFSETS), h, w)), dtype=dtype,
                                            device=dev) for _ in range(3))

            def per_shard(fn):
                return torch.cat([fn(fl[i:i + 2], dfl[i:i + 2], gb[i:i + 2], gb1[i:i + 2], gb2[i:i + 2], hv)
                                  for i, hv in halves])

            def ev(f):
                return (f.x, f.y, f.dtf, f.wt)

            calls = {
                "fwd": lambda f, d, g, g1, g2, fr: fi.fused_iwe_fwd(f, *ev(fr), OFFSETS, False, bins=fr.bins,
                                                                    frames=fr.frames),
                "bwd": lambda f, d, g, g1, g2, fr: fi.fused_iwe_bwd(f, *ev(fr), g, OFFSETS, False, bins=fr.bins,
                                                                    frames=fr.frames),
                "jvp": lambda f, d, g, g1, g2, fr: fi.fused_iwe_jvp(f, d, *ev(fr), OFFSETS, False, bins=fr.bins,
                                                                    frames=fr.frames),
                "hvp_bwd": lambda f, d, g, g1, g2, fr: fi.fused_iwe_hvp_bwd(f, d, g1, g2, *ev(fr), OFFSETS, True,
                                                                            bins=fr.bins, frames=fr.frames),
            }
            line = []
            for name, fn in calls.items():
                key = "batched_" + ("" if tb is None else "voxel_") + name
                err = (per_shard(fn) - fn(fl, dfl, gb, gb1, gb2, whole)).abs().max().item()
                errs[key] = max(errs.get(key, 0.0), err)
                line.append(f"{name} {err:g}")
            ok = all(errs[k] == 0 for k in errs)
            phase("mesh-check", f"{str(dtype)[6:]} K7 over {len(windows)} frames {list(whole.frames.sizes)}"
                                f"{'' if tb is None else f' T={tb}'}: one call per data shard (2 + 2 frames) vs one "
                                f"call, max|err| {', '.join(line)}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("chip_smoke: a data shard's batched call differs from the batch's")
        # K8: even shards into int64 sums, a full-frame image (global path) and sweep-patch images (shared)
        ev_t = t(events)
        wt_t = torch.ones(len(events), dtype=dtype, device=dev)
        for size in ((h, w), (h // 8, w // 8)):
            pieces = [p.to(d) for p, d in zip(torch.tensor_split(ev_t, MESH_SHARDS), devices)]
            wpieces = [p.to(d) for p, d in zip(torch.tensor_split(wt_t, MESH_SHARDS), devices)]
            sharded = lambda: sharded_vote(pieces, wpieces, size, dev)  # noqa: E731
            single = lambda: vote.bilinear_vote_kernel(ev_t, size, wt_t)  # noqa: E731
            err = (sharded() - single()).abs().max().item()
            errs["vote"] = max(errs.get("vote", 0.0), err)
            if dtype == torch.float32 and size == (h, w):
                times["vote"] = (cuda_ms(sharded, 3, 20), cuda_ms(single, 3, 20))
            route = "global sums" if size[0] * size[1] > vote.shared_pixels() else "shared memory"
            phase("mesh-check", f"{str(dtype)[6:]} K8 {size[0]}x{size[1]} ({route}), {MESH_SHARDS} even shards: "
                                f"max|err| {err:g}: {'ok' if err == 0 else 'FAIL'}")
            if err != 0:
                raise SystemExit("chip_smoke: the sharded vote differs from the unsharded vote")
    timing = ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in times.items())
    phase("mesh-time", f"float32, {MESH_SHARDS} shards on {mesh_text(mesh)} ({smi}), sharded / unsharded ms per call: "
                       f"{timing}")
    return errs, times, ops.mesh_launch_counts()


def mesh_dsec(port_main, dev, smi) -> dict:
    """``[mesh-dsec]``: the DSEC config with ``parallel: {data: 1, event:
    MESH_SHARDS}`` (its own comment's block), frame 0 through ``main.run``
    with a mesh that repeats this card, against ``[dsec-frame]``'s bits (a
    single-device run here when that phase did not run).  Returns the run's
    launches and mesh launches."""
    from event_based_optical_flow_tpu_torch import ops

    config = dsec_config()
    if not DSEC_NEWTON:
        records, _, _, _ = run_slice(port_main, config, dev, last_frame=0)
        st = records[0]["stats"]
        DSEC_NEWTON.update(epe=records[0]["metrics"]["EPE"], loss=st["loss"], iters=st["iters"],
                           scale_launches=st["launches"], seconds=records[0]["seconds"])
    config["parallel"] = {"data": 1, "event": MESH_SHARDS}
    out_dir = tempfile.mkdtemp(prefix="evflow_chip_smoke_mesh_")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    mesh = smoke_mesh(dev, 1, MESH_SHARDS)
    records = port_main.run(slice_config(config, 0, out_dir), eval_mode=True, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, mesh_launches = ops.launch_counts(), ops.mesh_launch_counts()
    r, ref = records[0], DSEC_NEWTON
    st = r["stats"]
    per_shard = all(st["launches"][s][k] == MESH_SHARDS * ref["scale_launches"][s][k]
                    for s in st["launches"] for k in ("fwd", "bwd", "jvp", "hvp_bwd"))
    same = r["metrics"]["EPE"] == ref["epe"] and st["loss"] == ref["loss"] and st["iters"] == ref["iters"]
    ok = same and per_shard and not st["chain"]
    phase("mesh-dsec", f"{smi}: {DSEC_CONFIG} with parallel {config['parallel']} on {mesh_text(mesh)}, "
                       f"frame 0 (the loop): {r['seconds']:.3f} s (single device chained {ref['seconds']:.3f} s), "
                       f"EPE {r['metrics']['EPE']!r} vs {ref['epe']!r}, loss {st['loss']} vs {ref['loss']}, "
                       f"iters {st['iters']} vs {ref['iters']}: same bits {same}; K1-K4 per scale "
                       f"{ {s: {k: c[k] for k in ('fwd', 'bwd', 'jvp', 'hvp_bwd')} for s, c in st['launches'].items()} } "
                       f"= {MESH_SHARDS} x the single device's: {per_shard}; mesh launches {mesh_launches}; phase "
                       f"{wall:.2f} s: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the event-sharded DSEC frame differs from the single-device frame")
    return launches, mesh_launches


def mesh_fleet(port_main, dev, smi) -> dict:
    """``[mesh-fleet]``: the fleet cell's blocks (``fleet_config``) on frames
    0..MESH_FLEET_FRAMES-1 with ``parallel: {data: 2}`` through the fleet
    eval loop: the odd batch pads with its last frame to [0, 1, 2, 2], and
    each frame's metrics and per-scale losses are the bits of a
    single-device fleet solver's run of its half whose generator first
    skips the starts the shards before it drew (the padded batch's starts
    in frame order; the first sweep draws of a fresh generator serve both
    halves, as the JAX package's replicated key does; the frames hold
    equal event counts, so the halves' sweeps take the padded batch's
    patch capacity).  Returns the run's launches."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.utils import validate_config

    with open(CONFIG) as f:
        base = yaml.safe_load(f)
    config = fleet_config(base, MESH_FLEET_FRAMES)
    meshed = copy.deepcopy(config)
    meshed["parallel"] = {"data": 2}
    out_dir = tempfile.mkdtemp(prefix="evflow_chip_smoke_mesh_fleet_")
    run_config = slice_config(meshed, MESH_FLEET_FRAMES - 1, out_dir)
    validate_config(run_config)
    mesh = smoke_mesh(dev, 2, 1)
    loader, solv = port_main.build(run_config, dev, mesh=mesh)
    data = run_config["data"]
    ts = loader.eval_frame_time_list()[: MESH_FLEET_FRAMES + data["eval_dt"]]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    records = port_main.evaluate_dataset_fleet(ts, data, loader, solv, out_dir, data["fleet_batch"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    shard_losses = [st["loss"] for st in solv.last_batch_stats["shards"]]
    gathered = [port_main._gather_frame(loader, data, ts[i], ts[i + data["eval_dt"]])
                for i in range(MESH_FLEET_FRAMES)]
    sizes = [len(g[0]) for g in gathered]
    halves = [[0, 1], [2, 2]]  # the padded batch's halves
    oks, lines = [len(set(sizes)) == 1], []
    for d, half in enumerate(halves):
        _, ref = port_main.build(slice_config(config, MESH_FLEET_FRAMES - 1, out_dir), dev)
        ref.overload_patch_configuration(ref.coarsest_scale)
        for _ in range(len(half) * d):  # the starts of the shards before this one
            ref._init_scale(ref.coarsest_scale, None)
        best = ref.optimize_batch([gathered[i][0] for i in half])
        same_loss = ref.last_batch_stats["loss"] == shard_losses[d]
        for b, i in enumerate(half[:2 if d == 0 else 1]):
            _, gt_slice, gt_flow, flow_time = gathered[i]
            m = ref.calculate_flow_error(best[b], gt_flow, timescale=flow_time, events=gt_slice)
            same = m == records[i]["metrics"] and same_loss
            oks.append(same)
            lines.append(f"frame {i} EPE {records[i]['metrics']['EPE']:.6f} vs {m['EPE']:.6f} (half {d}; zero flow "
                         f"{zero_flow_epe(loader, data, i, ref):.4f})")
    ok = all(oks) and len(records) == MESH_FLEET_FRAMES
    phase("mesh-fleet", f"{smi}: the fleet cell on frames 0..{MESH_FLEET_FRAMES - 1} ({sizes} events), parallel "
                        f"{meshed['parallel']} on {mesh_text(mesh)} (padded to 4: halves {halves}): "
                        f"{'; '.join(lines)}; metrics and per-scale losses the single-device halves' bits from "
                        f"the padded batch's draws: {all(oks)}; {wall:.2f} s, K7 launches "
                        f"{ {k: v for k, v in launches.items() if k.startswith('batched') and v} }: "
                        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: a data-sharded fleet frame differs from its half's single-device run")
    return launches


def mesh_dnn(dev, smi) -> dict:
    """``[mesh-dnn]``: ``MESH_DNN_STEPS`` steps of ``dnn_train_step_parallel``
    over two data devices against ``dnn_train_step``, from one seed on
    ``DNN_CONFIG``'s batches: in float64 every step's loss to
    ``MESH_DNN_LOSS_REL`` and the parameters after the last to
    ``MESH_DNN_PARAM_ATOL`` (the JAX package's bounds); in float32 the
    first step's loss to ``MESH_DNN_LOSS_REL`` and its averaged gradient
    to ``MESH_DNN_GRAD_REL`` of the largest, its parameters and the later
    steps' printed with the element that moved most apart and both runs'
    gradients there (Adam's first update ``lr g / (|g| + eps)`` follows
    the sign of a gradient below its eps, which float32's reordered sums
    can flip).  Returns the K8 launches of the parallel steps."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.data import collections
    from event_based_optical_flow_tpu_torch.models import train

    with open(DNN_CONFIG) as f:
        config = yaml.safe_load(f)
    d, dnn = config["data"], config["dnn"]
    loader = collections[d["dataset"]](config=d)
    loader.set_sequence(d["sequence"])
    size = train.crop_size(d)
    mesh = smoke_mesh(dev, 2, 1)

    def apart(model_s, model_p):
        """(max|err| of the parameters, the worst element's description)."""
        worst = (0.0, "none")
        for (name, p), q in zip(model_s.named_parameters(), model_p.parameters()):
            diff = (p - q.to(p.device)).abs().reshape(-1)
            i = int(diff.argmax())
            if diff[i].item() > worst[0]:
                gs, gp = (float("nan") if t.grad is None else t.grad.reshape(-1)[i].item() for t in (p, q))
                worst = (diff[i].item(), f"{name}[{i}] apart {diff[i].item():.3e}, gradients there {gs:.3e} / "
                                         f"{gp:.3e}")
        return worst

    launches, out = 0, {}
    for dtype in (torch.float64, torch.float32):
        kw = dict(n_bin=dnn["n_bin"], lr=float(dnn["lr"]), scale_time=train.default_scale_time(dnn, size),
                  device=dev, dtype=dtype)
        model_s, opt_s = train.make_dnn_train_state(size, **kw)
        model_p, opt_p = train.make_dnn_train_state(size, **kw)
        step_s, _ = train.dnn_train_step(model_s, opt_s, size, dnn["n_bin"], multi_scale=True)
        step_p, _ = train.dnn_train_step_parallel(model_p, opt_p, size, mesh, dnn["n_bin"], multi_scale=True)
        rng = np.random.default_rng(0)
        losses, first = [], None
        for _ in range(MESH_DNN_STEPS):
            arrays = train.draw_batch(loader, rng, size, d["n_events_per_batch"], int(dnn["batch_size"]))
            ev, wt = (torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays[:2])
            ls = float(step_s(ev, wt))
            ops.reset_launch_counts()
            lp = float(step_p(ev, wt))
            launches += ops.launch_counts()["vote"]
            losses.append((ls, lp))
            if first is None:
                pairs = list(zip(model_s.parameters(), model_p.parameters()))
                grad_err = max((p.grad - q.grad.to(p.device)).abs().max().item() for p, q in pairs)
                grad_max = max(p.grad.abs().max().item() for p, _ in pairs)
                first = (abs(ls - lp) / abs(ls), grad_err / grad_max, apart(model_s, model_p))
        rel = max(abs(a - b) / abs(a) for a, b in losses)
        out[dtype] = (losses, rel, apart(model_s, model_p), first)
    losses, rel, (perr, _), _ = out[torch.float64]
    l32, rel32, (perr32, worst32), (rel1, grad1, (perr1, worst1)) = out[torch.float32]
    ok64 = rel <= MESH_DNN_LOSS_REL and perr <= MESH_DNN_PARAM_ATOL and np.isfinite(losses).all()
    ok32 = rel1 <= MESH_DNN_LOSS_REL and grad1 <= MESH_DNN_GRAD_REL and np.isfinite(l32).all()
    ok = ok64 and ok32
    phase("mesh-dnn", f"{smi}: {DNN_CONFIG} ({size[0]}x{size[1]}, batch {dnn['batch_size']}) over 2 data devices "
                      f"({mesh_text(mesh)}) vs one device, the JAX package's bounds (loss rel "
                      f"{MESH_DNN_LOSS_REL:g}, params atol {MESH_DNN_PARAM_ATOL:g}): float64, {MESH_DNN_STEPS} "
                      f"steps: losses {[(round(a, 9), round(b, 9)) for a, b in losses]}, max rel err {rel:.3e}, "
                      f"params max|err| {perr:.3e}: {ok64}; float32, 1 step: loss rel err {rel1:.3e}, gradient "
                      f"max|err| / max|g| {grad1:.3e} (tol {MESH_DNN_GRAD_REL:g}): {ok32}; its params max|err| "
                      f"{perr1:.3e} (printed: {worst1}); float32 after {MESH_DNN_STEPS} steps (printed): max rel "
                      f"err {rel32:.3e}, params max|err| {perr32:.3e} ({worst32}); K8 launches {launches}: "
                      f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the data-parallel DNN steps left JAX's bounds")
    return {"vote": launches}


def mesh_path(port_main, dev, smi, config: dict, events: np.ndarray, rng):
    """Phase 19; returns (the mesh runs' launches, their mesh launches, each
    kernel's sharded max|err| and times)."""
    errs, times, check_launches = mesh_check(dev, smi, config, events, rng)
    launches, mesh_launches = mesh_dsec(port_main, dev, smi)
    fleet_launches = mesh_fleet(port_main, dev, smi)
    launches = {k: launches[k] + fleet_launches[k] for k in launches}
    dnn_launches = mesh_dnn(dev, smi)
    launches["vote"] += dnn_launches["vote"]
    return launches, mesh_launches, check_launches, errs, times


def build_kernels() -> None:
    """The CUDA kernels, one ``nvcc`` per source, all started together."""
    from event_based_optical_flow_tpu_torch.ops import cuda_build

    with ThreadPoolExecutor() as pool:
        built = list(pool.map(cuda_build.load_kernel_library, ("fused_iwe", "vote")))
    for kl in built:
        ptxas = " | ".join(l.strip() for l in kl.build_log.splitlines() if "registers" in l or "spill" in l)
        phase("build", f"{kl.path.name}: {kl.build_seconds:.2f} s (nvcc sm_90a); {ptxas or 'cached'}")


def distinct_main() -> int:
    """``python3 chip_smoke.py --distinct-devices`` (a host with at least
    ``MESH_SHARDS`` cards): the mesh phases of phase 19 with every mesh
    over distinct cards (cuda:0, cuda:1, ...) instead of one card repeated:
    ``[mesh-check]``, ``[mesh-dsec]``, ``[mesh-fleet]`` and ``[mesh-dnn]``,
    each against the same single-device results on cuda:0 and gated as in
    the one-card run, which runs every partition and reduction but none of
    the cross-device copies, device switches and per-device streams."""
    global DISTINCT_DEVICES
    DISTINCT_DEVICES = True
    t_start = time.perf_counter()
    smi = environment()
    if torch.cuda.device_count() < MESH_SHARDS:
        raise SystemExit(f"chip_smoke: --distinct-devices needs {MESH_SHARDS} cards, {torch.cuda.device_count()} "
                         "are visible")
    dev = torch.device("cuda", 0)

    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.utils import set_numerics

    set_numerics()
    build_kernels()
    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    _, events = first_window(config)
    errs, times, _ = mesh_check(dev, smi, config, events, np.random.default_rng(0))
    mesh_dsec(port_main, dev, smi)
    mesh_fleet(port_main, dev, smi)
    mesh_dnn(dev, smi)
    phase("wall", f"the mesh phases over {torch.cuda.device_count()} cards, builds included: "
                  f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"mesh": {"max_abs_err": errs, "sharded_unsharded_ms": times}}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    t_start = time.perf_counter()
    smi = environment()
    dev = torch.device("cuda")

    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.ops import fused_iwe as fi
    from event_based_optical_flow_tpu_torch.ops import vote
    from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents
    from event_based_optical_flow_tpu_torch.utils import set_numerics

    set_numerics()
    build_kernels()

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    loader, events = first_window(config)
    h, w = config["data"]["height"], config["data"]["width"]
    rng = np.random.default_rng(0)
    flow_np = smooth_flow(h, w, rng)
    g_np = rng.normal(size=(1 + len(OFFSETS), h, w))
    errs = {}
    for dtype in (torch.float64, torch.float32):
        frame = FrameEvents.from_numpy(events, dev, dtype)
        flow = torch.as_tensor(flow_np, dtype=dtype, device=dev)
        g = torch.as_tensor(g_np, dtype=dtype, device=dev)
        for include_orig, offsets in ((False, OFFSETS), (True, ())):
            fe, be, fs, bs, same, exact = compare(fi, frame, flow, g, include_orig, offsets)
            ok = fe <= TOL[dtype] * fs and (be is None or be <= TOL[dtype] * bs) and same and exact == 0
            phase("check", f"{str(dtype)[6:]} offsets={offsets} orig={include_orig} N={len(events)} "
                           f"{h}x{w}: fwd max|err| {fe:.3e} (scale {fs:.3g})"
                           + ("" if be is None else f", bwd max|err| {be:.3e} (scale {bs:.3g})")
                           + f", tol {TOL[dtype]:g} x scale; exact model: max|err| {exact:g}; repeat same bits: "
                           + f"{same}: " + ('ok' if ok else 'FAIL'))
            if not ok:
                raise SystemExit("chip_smoke: kernel disagrees with its plain version")
            if dtype == torch.float32 and offsets:
                errs = {"fwd": fe, "bwd": be}
    phase("objective", objective_check(config, events, rng))

    # timing at the main path's shape, float32 (the main path's dtype)
    frame = FrameEvents.from_numpy(events, dev, torch.float32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    times = time_kernels(fi, frame, t(flow_np), None, None, t(g_np[1:]), ("fwd", "bwd"))
    phase("time", time_line(smi, times, ("fwd", "bwd"), f"N={len(events)} {h}x{w} offsets={OFFSETS}"))
    bounds = {k: bound(k, frame, t(flow_np)) for k in ("fwd", "bwd")}
    k8 = vote_path(port_main, dev, smi, config, events)

    # the slice: the CLI's eval loop
    last = MVSEC_LAST_FRAME
    ops.reset_launch_counts()
    records, out_dir, wall, peak = run_slice(port_main, config, dev, last_frame=last)
    launches = ops.launch_counts()
    run_config = slice_config(config, last_frame=last, out_dir=out_dir)
    slice_loader, solv = port_main.build(run_config, dev)
    failed = []
    for r in records:
        m = r["metrics"]
        zero = zero_flow_epe(slice_loader, run_config["data"], r["frame"], solv)
        ok = np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(m["PRED_FWL"])
        loss = {s: round(v, 6) for s, v in r["stats"]["loss"].items()}
        phase("frame", f"{r['frame']}: {r['seconds']:.3f} s, EPE {m['EPE']:.4f} (zero flow {zero:.4f}), "
                       f"3PE {m['3PE']:.4f}, AE {m['AE']:.4f}, GT_FWL {m['GT_FWL']:.4f}, "
                       f"PRED_FWL {m['PRED_FWL']:.4f}, host syncs {r['stats']['syncs']}, "
                       f"Newton iters {r['stats']['iters']}, loss per scale {loss}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(r["frame"])
    with open(os.path.join(out_dir, "eval_metrics.jsonl")) as f:
        n_lines = len(f.read().strip().splitlines())
    phase("slice", f"{len(records)} windows in {wall:.2f} s, eval_metrics.jsonl lines {n_lines}, "
                   f"kernel launches {launches}, out {out_dir}")
    same = loop_repeat(port_main, config, dev, records, peak, smi, "repeat", "MVSEC")
    if failed:
        raise SystemExit(f"chip_smoke: frames {failed}: metrics not finite or not below the zero flow")
    if (len(records) != last + 1 or n_lines != last + 1
            or 0 in (launches["fwd"], launches["bwd"], launches["vote"])):
        raise SystemExit("chip_smoke: the eval loop did not run its windows through K1, K2 and K8")
    if not same:
        raise SystemExit("chip_smoke: the loop's run of frame 0 did not reproduce the chained result")
    viz_check(port_main, dev, smi, run_config, out_dir, rng)

    # each path's run counts from 0; a kernel's launches are all paths' runs'
    paths = (dsec_path, ta_path, lambda *a: fleet_path(*a, sequential_epe=records[0]["metrics"]["EPE"]))
    for path in paths:
        path_launches, path_errs, path_times, path_bounds = path(port_main, fi, dev, smi, rng)
        launches = {k: launches[k] + path_launches[k] for k in launches}
        errs.update(path_errs)
        times.update(path_times)
        bounds.update(path_bounds)
    for path in (serve_path, mvsec_cli_path, evt2_fwl_path, global_path, optimizer_path, trace_path, lbfgs_path,
                 init_path):
        path_launches = path(dev, smi)
        launches = {k: launches[k] + path_launches[k] for k in launches}
    unfused_launches, pad_rows = unfused_path(fi, dev, smi, config, events, rng)
    launches = {k: launches[k] + unfused_launches[k] for k in launches}
    dnn_launches, k8_dnn = dnn_path(dev, smi)
    launches = {k: launches[k] + dnn_launches[k] for k in launches}
    mesh_launches, mesh_counts, mesh_check_counts, mesh_errs, mesh_times = mesh_path(port_main, dev, smi, config,
                                                                                     events, rng)
    launches = {k: launches[k] + mesh_launches[k] for k in launches}

    def mesh_entry(name: str) -> dict:
        """A kernel's sharded form: its launches on a shard in the mesh
        runs (K7: its data shards' calls), in ``[mesh-check]``, its max|err|
        against the unsharded kernel and the sharded / unsharded ms."""
        runs = mesh_launches[name] if name.startswith("batched") else mesh_counts.get(name, 0)
        ms = mesh_times.get(name, (None, None))
        return {"launches": runs, "check_launches": mesh_check_counts.get(name, 0),
                "max_abs_err": mesh_errs.get(name), "ms": ms[0], "unsharded_ms": ms[1]}
    src = fi.KERNEL_SOURCE
    pb = "event_based_optical_flow_tpu/ops/pallas_objective_banded.py"
    kernels = [
        {"name": f"fused_iwe_{name}", "route": "cuda", "source": src, "replaces": f"{pb}:{line}",
         "launches": launches[name], "max_abs_err": errs[name], "ms": times[name],
         "plain_ms": times[f"{name}_plain"], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no single PyTorch call computes a fused gather + warp + vote (or its derivatives)
         "library_ms": None, **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}),
         **({f"pad{PAD}": pad_rows[name]} if name in pad_rows else {}),
         **({"mesh": mesh_entry(name)} if name in mesh_errs else {})}
        for name, line in KERNEL_LINES.items()
    ]
    kernels.append({"name": "vote", "route": "cuda", "source": vote.KERNEL_SOURCE,
                    "replaces": "event_based_optical_flow_tpu/ops/pallas_iwe.py:101", "launches": launches["vote"],
                    "max_abs_err": k8["err"], "ms": k8["ms"], "plain_ms": k8["plain_ms"],
                    "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"], "library_ms": k8["library_ms"],
                    "dnn": k8_dnn, f"pad{PAD}": {k: v for k, v in pad_rows.items() if k.startswith("vote_")},
                    "mesh": mesh_entry("vote")})
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels {missing} were not launched on their paths")
    wall = time.perf_counter() - t_start
    phase("wall", f"the whole script, builds included: {wall:.1f} s (budget 1000 s, limit 1200 s: "
                  f"{'under' if wall < 1000 else 'OVER'} the budget)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(distinct_main() if sys.argv[1:] == ["--distinct-devices"] else main())
