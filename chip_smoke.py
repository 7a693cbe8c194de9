#!/usr/bin/env python3
"""Smoke run of the PyTorch port (myfm_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It drives the port's three paths through ``fit`` then ``predict`` and
holds every CUDA kernel of each against its plain PyTorch version:

* the categorical fast path, on the ML-10M-shaped all-categorical design
  (one-hot date main table, one-hot user and item RelationBlocks,
  rank 32);
* the joint engine, on synthetic ML-100k (fold 0 of 10) with the
  timeSVD++-flipped features (one-hot date main table; user and item
  blocks of one-hot ids plus N-hot implicit columns), rank 10, 200
  sweeps, which "auto" resolves to the joint engine;
* variational inference (``VariationalFMRegressor``) on the same ML-100k
  design at rank 10, 3 sweeps, which "auto" resolves to the fast path
  with entity+attribute tables (kernel 2 and kernel 1's VI layout), and
  on the ML-10M-shaped design at rank 32, 3 sweeps (kernel 1's VI
  layout); ``VariationalFMClassifier`` (rating >= 4) on the ML-10M-shaped
  design, rank 32, 3 sweeps (kernel 1's VI layout with the latent means
  τ as its target column); and both VI estimators on the ML-100k design
  through the row-space colored sweep (``sweep_strategy="colored"``,
  plain PyTorch: the TPU package runs no Pallas kernel there);
* the Gibbs fast path with entity+attribute tables: the same ML-100k
  design through ``MyFMGibbsRegressor`` (rank 10, 20 sweeps) and
  ``MyFMOrderedProbit`` (10 sweeps), which "auto" resolves below 200
  sweeps to the fast path: kernel 1 over each table (an entity+attribute
  table's own rows are its effective rows) and kernel 4 for the side
  features' color scan;
* the probit tasks: ``MyFMOrderedProbit`` and ``MyFMGibbsClassifier``
  (rank 32, 6 sweeps) on the ML-10M-shaped design's fast path (kernel 1)
  and ``MyFMOrderedProbit`` (rank 10, 20 sweeps, the joint engine) on the
  ML-100k design (kernel 4);
* the colored Gibbs engine (plain PyTorch: the TPU package runs no
  Pallas kernel there) on the same ML-100k design at rank 10:
  ``MyFMGibbsRegressor(sweep_strategy="colored")``,
  ``MyFMOrderedProbit(fit_linear=False)`` through "auto", and the
  joint-row factor sweep (``sweep_strategy="joint"``,
  ``fit_linear=False``);
* kernel 3 (``tile_gram``) through its entry point ``entity_grams``, and
  kernels 5 and 6 (kernel 1 section by section, and its (slot, τ) load)
  through ``myfm_tpu_torch.tools.kernel_sections``, on the ML-10M plan;
* the Gram modes of kernels 1, 2 and 5: "auto" on the card resolves
  float32 to "split" (three bf16 tensor-core products per Gram entry)
  everywhere below rank 64 and to "bf16" (one) at rank >= 64, after each
  mode's self-check on the card; every fast-path fit asserts its
  resolved mode and that kernel 1 (and 2) launched in it alone, and
  every kernel-vs-plain comparison of kernels 1, 2 and 5 runs IEEE (fp32
  and fp64), "split" and "bf16" (fp32);
* rank 128 on the ML-10M design (the reference's flagship,
  ``bench.py`` ``_bench_rank128``): kernel 1 in each mode at its shapes,
  and ``MyFMGibbsRegressor(rank=128)``, which "auto" runs in "bf16".

Phases, one line each:

  device    the card (and nvidia-smi's name / power limit)
  build     nvcc builds every kernel from csrc/ (in parallel)
  data      the synthetic design and its fast-path plan: seconds of the
            design, of the fingerprint (the plan cache's key) and of the
            card build's windows (counts and tiling, ``_plan_tiles``,
            upload, the card derivation, finalize windows, the rest)
  plan      the same plan built twice, the O(rows) layouts packed on the
            host by the native planner (built here first, with g++) and
            derived on the card; every table tensor bit-equal, each
            build's seconds and windows
  kernel    fused_tile_gram_cross, kernel vs plain, at each table's
            first chunk of tiles (the main path's shapes), fp32 + fp64,
            then under "modes" in "split" and "bf16" (fp32; kernel vs
            plain in the same mode within KERNEL_TOL, and ``vs_ieee``
            within the self-check's gate)
  sweep     one categorical_sweep through the kernel vs one through
            the plain version, same state and variates, in each mode
  egram     tile_gram (kernel 3) on the z rows of each table's first
            chunk: kernel vs plain (fp32 + fp64) and vs kernel 1's Gram
            of the same tiles; then entity_grams over every tile of each
            table against the sweep's own per-entity Grams (kernel 1)
  sections  kernel 1 at levels 0-3 on the user table's first chunk (ms
            and ns/row per level, level 3 bit-equal to the production
            kernel), IEEE at every level and "split" / "bf16" at levels
            1-3, and the (slot, τ) probe bit-equal to
            transpose(1, 2).contiguous() on that chunk's aux2 and on the
            TPU probe's [4, 2, 256]
  modes     the self-check of "split" and "bf16" on the card (run first,
            right after the build; both must pass), then per mode kernel
            1's errors, ms, yardstick and bound summed over the ML-10M
            first chunks and kernel 5's levels (the ML-100k plans' mode
            rows are in the vkernel and eakernel lines)
  osweep    one ordered-probit categorical_sweep through kernel 1 vs one
            through the plain version, same state and variates, in each
            mode
  fit       the estimator, from an emptied plan cache (so it compiles
            its plan); the kernel's launch counter must rise, all in
            "split", the mode "auto" resolved (history_); whether the plan
            came from the cache and the cache's device bytes (beside every
            peak-memory reading from here on)
  predict   held-out RMSE, below std(y_test)
  ofit      MyFMOrderedProbit(rank=32) on ratings 1..5 as classes 0..4,
            6 sweeps; "auto" must resolve to the fast path, kernel 1 must
            launch, every kept sample's cutpoints finite and increasing
  opredict  predict_proba rows sum to 1; held-out log-loss below the
            class-frequency predictor's
  cfit      MyFMGibbsClassifier(rank=32) on rating >= 4, 6 sweeps;
            ofit and cfit refit fit's design and must take its plan from
            the cache (their time to first sweep is the refit's)
  cpredict  held-out log-loss below the base rate's; accuracy, AUC
  lfit      the libFM protocol (examples/ml-10m-regression.py):
            MyFMGibbsRegressor(rank=32), n_kept_samples=1, with a
            utils.callbacks.RegressionCallback (clip 1..5, CSV trace)
            that scores the held-out rows on the card every sweep, 8
            sweeps on fit's cached plan.  Kernel 1 must launch every
            sweep, in "split"; the callback's test plan must live on
            the card; at sweeps 0 and 7 its score must match the host
            forward FM.predict_score of the same weights (LIBFM_TOL);
            every trace value finite (rmse_all_but_5 from sweep 5 on);
            the final rmse below std(y_test); the last rmse_this the
            RMSE of fm.predict within 1e-4; the CSV a header and 8
            rows.  Sweeps/s beside fit's, the callback's ms per sweep,
            the loop's host syncs per sweep
  lofit     MyFMOrderedProbit(rank=32) with an OrderedProbitCallback, 6
            sweeps on ofit's plan: every row of the running class
            probabilities sums to 1 within 1e-6, log-loss finite
  lcfit     MyFMGibbsClassifier(rank=32) with a ClassificationCallback,
            6 sweeps on cfit's plan: accuracy and log-loss finite
  ckpt      CategoricalGibbsTrainer on a plan of that design (rank 32,
            regression, default torch ops): 4 sweeps in one go against 2
            checkpointed at 2 and resumed to 4 in a fresh trainer; the
            last 2 samples bit-equal, or the run fails; the checkpoint's
            bytes, write and read seconds
  drain     the estimator on the cached plan, 100 sweeps keeping every
            sample with an eager user callback, then with the pipelined
            harvest: each fit's seconds and sweeps/s, the loop's host
            syncs per sweep, the synchronising calls torch's sync-debug
            mode counts per sweep, the harvest's peak pinned bytes and
            the host allocator's pinned blocks; the two chains, under
            default torch ops, must be the same bits (every kept
            sample's w0, w and V and the hyper trace); then
            MyFMOrderedProbit, 6 sweeps each way, default ops: samples,
            cutpoints, hyper and MH accept traces bit-equal.  The plan
            cache is emptied after it, and again before the joint, VI,
            ML-10M VI and row-space phases
  shard1    world size 1 over NCCL on cuda:0
            (``myfm_tpu_torch.tools.sharded.shard1``):
            MyFMGibbsRegressor(rank=32, mesh=<group>) on fit's design, 6
            sweeps, then predict through the sharded scorer; every kept
            sample, the hyper trace and the prediction bit-equal to
            fit's (the same plan; an all-reduce over one rank returns
            its operand); kernel 1 must launch every sweep; launches by
            mode, sweeps/s, time to first sweep, peak memory, the
            collectives' calls and bytes, and their seconds in one
            sweep timed apart
  r128data  the same design compiled at rank 128 (D = 130): (B, K, T, S)
            and chunk tiles per table, plan time; the fast-path gate
            must accept it
  r128kernel kernel 1 vs plain at each table's first chunk at rank 128,
            IEEE (fp32 + fp64), "split" and "bf16", each with its device
            ms of pass 1 and of the carry walk apart, the Gram pass that
            ran ("wgmma" in both reduced modes) and two launches
            bit-equal (every kernel-1/2 comparison reports the last two)
  r128fit   the trainer on that plan with gram_fast_matmul=False for
            R128_IEEE_ITER sweeps (the IEEE sweep time), then
            MyFMGibbsRegressor(rank=128) through "auto": "fastpath",
            "bf16", kernel 1 launched in bf16 alone and every launch on
            the wgmma pass; one warm-up and three timed sweeps, time to
            first sweep, peak memory
  r128predict held-out RMSE below std(y_test)
  jdata     the ML-100k timeSVD++-flipped design and its joint plan:
            (B, C, Pf) of each block's tail, compile time
  jkernel   joint_tail_pass, kernel vs plain, on each block's real tail
            stack from the Gram of the initial state, fp32 + fp64, with
            its µs per color and each of its two kernels' device ms;
            the prep kernel's lists (tail_lists) bit-equal to their
            plain version on each tail's segb
  jsweep    one gibbs_sweep with the tail kernel vs one with the plain
            tail, same state and variates
  jfit      the estimator through "auto" (n_iter 200, stopped by its
            callback after J_FIT_SWEEPS); must resolve to "joint" and
            launch the tail kernel
  jpredict  held-out RMSE through serving (entity space, with the side
            tables), below std(y_test)
  jofit     MyFMOrderedProbit(rank=10, sweep_strategy="joint"), 20
            sweeps; the tail kernel must launch
  jopredict the ofit / opredict checks on the held-out rows
  eakernel  the same design's Gibbs plan with entity+attribute tables:
            kernel 1 vs plain at each table's first chunk (fp32 + fp64),
            then kernel 4 vs plain on each side table's color stack as
            a first sweep's EA pass hands it over (fp64 within
            JTAIL_TOL; fp32 within it, or no farther from the fp64
            result than twice the plain fp32 version), with its µs per
            color, its two kernels' device ms and the plain time
  eafit     MyFMGibbsRegressor(rank=10) through "auto", 20 sweeps; must
            resolve to "fastpath" and launch kernels 1 (in "split") and 4
  eapredict held-out RMSE below std(y_test), served by the entity-space
            plan (its scorer's calls counted) and equal to the row-space
            scorer's mean of the same samples
  eaofit    MyFMOrderedProbit(rank=10) through "auto", 10 sweeps, on the
            fast path; kernels 1 and 4 must launch; then the ofit /
            opredict checks (eaopredict)
  vdata     the same ML-100k design's VI plan, with entity+attribute
            tables: (B, K, T, S) per table, (C, Pf) per side table
  vkernel   fused_tile_gram (each EA table, all its tiles) and
            fused_tile_gram_cross in its VI layout (each one-hot table's
            first chunk), kernel vs plain on the initial state's operands,
            fp32 + fp64, and "split" / "bf16" as in the kernel phase
  vsweep    one categorical_vi_sweep through the kernels vs one through
            the plain versions, same state, in IEEE and "split" (the VI
            paths' modes); both against one float64 IEEE plain sweep
  vcsweep   the same for the classification task (rating >= 4), one
            sweep in, so both kernels carry latent means τ; in "split",
            the mode its fits run
  vsections where one VI sweep's time goes, section by section, and the
            device operations of one entity+attribute color step
  vfit      VariationalFMRegressor(rank=10) through "auto"; must resolve
            to "fastpath", launch both kernels (in "split"), and keep the
            ELBO from decreasing
  vpredict  held-out RMSE of the VI fit, below std(y_test)
  v10m      the ML-10M-shaped design through VariationalFMRegressor
            (rank 32, 3 sweeps) -> predict; kernel 1's VI layout vs plain
            at each table's first chunk first
  vcfit10m  VariationalFMClassifier(rank=32) on the same design, rating
            >= 4, 3 sweeps: "auto" must resolve to "fastpath" and launch
            kernel 1's VI layout, the ELBO keep from decreasing,
            predict_proba lie in (0, 1) and the held-out log-loss fall
            below the base rate's; kernel 1's VI layout vs plain at each
            table's first chunk one classification sweep in
  vrfit     row-space CAVI on the ML-100k design: launches per sweep
            counted by torch.profiler on one sweep's parts, then
            VariationalFMRegressor and VariationalFMClassifier (rating
            >= 4) with sweep_strategy="colored", each stopped by its
            callback once VR_FIT_S seconds have passed (s/sweep from its
            own sweeps, or its one sweep's time where one sweep outlasts
            half the budget): each must resolve to "colored" and keep the
            ELBO check; RMSE below std(y_test), log-loss below the base
            rate's
  gcsweep   one colored gibbs_sweep on the ML-100k design in fp32
            against the same sweep in fp64 on the card, from one state
            and one set of variates (w, V, e, α within GCSWEEP_TOL of
            scale); launches per sweep counted by torch.profiler on its
            parts (hyperparameters with sweep_w, one factor of sweep_V,
            the refresh) and on one sweep_V_joint
  gcfit     MyFMGibbsRegressor(rank=10, sweep_strategy="colored"),
            stopped by its callback once GC_FIT_S seconds have passed
            (at least GC_MIN_ITER sweeps): must resolve to "colored";
            s per sweep, time to first sweep, peak memory
  gcpredict its held-out RMSE below std(y_test)
  gcofit    MyFMOrderedProbit(rank=10, fit_linear=False) through "auto",
            as gcfit: must resolve to "colored"; then the ofit /
            opredict checks (gcopredict)
  gjvfit    MyFMGibbsRegressor(rank=10, sweep_strategy="joint",
            fit_linear=False), GJV_MAX_ITER sweeps or GJV_FIT_S seconds:
            sweep_V_joint; the engine must read "joint" and the held-out
            RMSE fall below std(y_test)
  drain     (second line) default-ops pairs on the ML-100k design: the
            colored engine (MyFMGibbsRegressor, sweep_strategy="colored",
            DRAIN_COLORED_ITER sweeps each way) and the joint engine
            (sweep_strategy="joint", DRAIN_JOINT_ITER): every kept
            sample and the hyper trace bit-equal, or the run fails
  shard2    world size 2: two spawned processes on cuda:0 over gloo
            (``myfm_tpu_torch.tools.sharded.shard2``), the ML-100k
            design in float64 — the entity+attribute fast path
            (MyFMGibbsRegressor; kernels 1 and 4), the joint engine
            (MyFMOrderedProbit; kernel 4) and the VI fast path
            (VariationalFMRegressor; kernel 1's VI layout and kernel 2):
            each rank's fit within rtol 1e-8 / atol 1e-10 of the
            one-process fit from the same seed, the replicated state the
            same bits on both ranks, the kernels launched on each rank;
            the collectives' calls, bytes and seconds per rank (gloo on
            the ranks' CUDA tensors)

The kernels line gives, for every kernel, its launches in its path's
fit, its largest fp32 error against the plain version, its fp32 time,
the plain version's time, the least time the card could take for the
same work (the larger of the bytes it must move over 3.35 TB/s and its
operations: fp32 over 67 TFLOP/s, the Gram's bf16 products in "split" /
"bf16" over 989 TFLOP/s, the H100 SXM's published peaks) and which of
the two bounds it, and the time of the one PyTorch call that computes
the same function where there is one (the torch.bmm of the
slot-masked operand for the Gram kernels and section levels 1-3; in
"bf16" the bf16 torch.bmm, in "split" the sum of three of them,
transpose(1, 2).contiguous() for the probe; none for the joint tail, a
chain of ~1k dependent colors, for its prep kernel's lists (a stable sort
gives the grouped rows but not the live slots and their starts), nor for
section level 0).  ``fused_tile_gram_cross[ea]`` and ``joint_tail_pass[ea]``
are kernels 1 and 4 on the entity+attribute fast path (eakernel, eafit).
The sharded phases' launches of a kernel stand under its entry's
``sharded_launches`` (phase -> launches per rank; ``shard1`` also by
Gram mode under ``sharded_launches_by_mode``); no error or time is
given for them: the entry's numbers are its one-process path's.  The
libFM phases' kernel 1 launches (lfit, lofit, lcfit) stand under
``fused_tile_gram_cross``'s ``callback_launches``, by phase.
``joint_tail_pass[lists]`` is the prep kernel, which
every joint_tail_pass call launches before the chain, timed alone on the
tail's real operands as the call launches it.  Times are
summed over the tables (or block tails) of the path, at their first
chunk; ``fused_tile_gram_cross[vi]`` is kernel 1's VI layout on the
ML-100k design and ``fused_tile_gram_cross[vi10m]`` the same at the
ML-10M shape (v10m), ``fused_tile_gram_cross[vic10m]`` the same as
the VI classifier launches it (vcfit10m).  ``mode`` names the Gram mode
whose numbers an entry gives (the mode its path ran: "split" for the
rank-32 and VI paths, "bf16" for ``[r128]``; ``[r128 highest]`` is the
IEEE run beside it), ``launches_by_mode`` the path's launches by mode,
and ``gram_section[L mode]`` kernel 5's level L in that mode.  The phase
lines of the Gram
kernels also give
``device_ms``, one call's device time by torch.profiler (the median
duration of each of its kernels; pass 1 and the carry apart), beside
the event-timed ``ms``; null where no trace held the call whole
(traces late in this long process can lose events; the fresh process
of ``python -m myfm_tpu_torch.tools.vi_gram`` is the one to read).

The last line is {"ok": true, "device": {...}}, printed only when
every phase passed; any failure exits non-zero.  Without a CUDA card,
or without the package beside this file, it exits non-zero at once.
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
RANK = 32
N_ITER = 6  # < 200, so "auto" keeps the fast path
N_KEPT = 3
DRAIN_ITER = 100  # the timed harvest pair: a chain keeping every sample
DRAIN_CHECK_ITER = 6  # the ordered pair: > _SNAP_LAG sweeps
DRAIN_COLORED_ITER = 1  # the colored engine's pair (~10-30 s a sweep;
# 2 before the libFM phases were added, cut for the run's time)
DRAIN_JOINT_ITER = 3  # the joint engine's pair
R128_RANK = 128  # the reference's flagship rank (bench.py _bench_rank128)
R128_N_ITER = 4  # one warm-up sweep, three timed
R128_IEEE_ITER = 2
TEST_SHARE = 0.1
# |kernel − plain| over max|plain| of each Gram chunk: the two sum up to
# ~10^4 rows per carried chain in different orders (3e-7 in fp32 and
# 1.4e-15 in fp64 measured on an H100 at these shapes)
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12}
# the reduced Gram modes of kernels 1, 2 and 5 (fp32 only), held against
# their plain versions in the same mode and against IEEE
REDUCED_MODES = ("split", "bf16")
ALL_MODES = ("highest",) + REDUCED_MODES
# one fp32 sweep, kernel vs plain: the Gram differences above flow
# through the draws (max |Δw|, |ΔV| measured 3e-5 on O(1) weights) and
# the exact moment algebra (Σe, Σe² measured 1e-7 to 2e-6 of their
# scale: the groupwise sums of the λ/μ draws use index_add_, whose
# atomics add in a different order on every run)
SWEEP_WEIGHT_TOL = 5e-4
SWEEP_MOMENT_TOL = 1e-4

GRAM_REPLACES = "myfm_tpu/ops/pallas_gram.py:602"
GRAM_SOURCE = "myfm_tpu_torch/csrc/fused_gram_cross.cu"
ROWS_REPLACES = "myfm_tpu/ops/pallas_gram.py:100"
SECTIONS_SOURCE = "myfm_tpu_torch/csrc/gram_sections.cu"
SECTIONS_REPLACES = "scripts/microbench_kernel_sections.py:176"
PROBE_REPLACES = "scripts/probe_transpose.py:42"
# entity_grams (kernel 3 over every tile of a table) vs the sweep's
# per-entity Grams (kernel 1 chunk by chunk), fp32, of max |G|: the same
# row sums, the z rows built by two codes
EGRAM_TOL = 1e-5
P_N_ITER = 6  # probit fits on the fast path (< 200: "auto" keeps it)
JO_N_ITER = 20
# the libFM callbacks' fits (lfit, lofit / lcfit)
L_ITER = 8
LP_ITER = 6
# the callback's fp32 test score on the card vs the fp64 host forward of
# the same fp32 weights, |Δ| <= LIBFM_TOL * (1 + |host|): scores ~1-5
# summed from 3 linear terms and 3 rank-32 pair products
LIBFM_TOL = 1e-4
# one ordered-probit sweep, kernel vs plain: as SWEEP_*; the cutpoints'
# Newton mode moves with the scores (fp32)
OSWEEP_CUT_TOL = 1e-3

J_RANK = 10
J_N_ITER = 200  # >= 200 at <= 500k rows: "auto" prefers the joint engine
J_FIT_SWEEPS = 20  # jfit's callback stops it there (the smoke's time)
J_FEATURES = "timesvdpp_flipped"
# |kernel − plain| over max|plain| of each tail's outputs (G, Atot, Ct,
# u_new) after ~1k chained colors; fp32 is loose because the Gram-
# assembled S cancels two aggregates of its own scale (ops/joint.py)
JTAIL_TOL = {"float32": 1e-3, "float64": 1e-10}
# (measured on an H100: fp32 7e-6 to 3.6e-4, fp64 2e-14 to 5e-13)
# one fp32 sweep, tail kernel vs plain tail, every other op
# deterministic: max |Δw|, |ΔV| on O(1) weights (measured 8e-6, 1.5e-5)
JSWEEP_TOL = 1e-3
TAIL_REPLACES = "myfm_tpu/ops/pallas_joint_tail.py:368"
# the ML-100k design through the Gibbs fast path with entity+attribute
# tables ("auto" below 200 sweeps)
EA_N_ITER = 20
EAO_N_ITER = 10
# entity-space vs row-space posterior mean of the same fp32 samples, max
# |Δ| on ratings 1-5: the same sums in another order (~1e-6)
SERVE_TOL = 1e-4
TAIL_SOURCE = "myfm_tpu_torch/csrc/joint_tail.cu"
META_REPLACES = "myfm_tpu/ops/pallas_gram.py:384"

# the H100 SXM's published peaks (NVIDIA's data sheet, 700 W): device
# memory rate and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

V_RANK = 10
V_N_ITER = 3  # cut from the cell's 20 for the smoke's time (5 before
# the libFM phases were added)
V10M_RANK = 32
V10M_N_ITER = 3
# |kernel − plain| over max|plain| of each VI Gram chunk (the same sums
# over up to ~10^4 rows per carried chain in another order)
VKERNEL_TOL = {"float32": 1e-5, "float64": 1e-10}
# one fp32 VI sweep, kernels vs plain, every other op deterministic: max
# |Δ| of the posterior means and variances and of the residual e, over
# the field's scale (max |plain|, at least 1), and the ELBO's relative
# difference.  The ~1e-7 Gram differences above flow through ~1k
# sequential fp32 color updates of each entity+attribute table (measured
# on an H100: |Δe| 2.4e-3 on residuals of scale ~4)
VSWEEP_TOL = 1e-3
VSWEEP_ELBO_TOL = 1e-4
# the largest ELBO decrease allowed between two fp32 sweeps, relative to
# the ELBO's magnitude (every CAVI update is an exact coordinate
# maximiser; fp32 sums over ~10^5 rows round at ~1e-7 relative)
ELBO_DROP_TOL = 1e-5
# row-space CAVI (vrfit): each fit stops after the sweep that would take
# it past VR_FIT_S seconds at its own rate, after VR_MIN_ITER sweeps at
# least and VR_MAX_ITER at most
VR_FIT_S = 12.0
VR_MIN_ITER = 1
VR_MAX_ITER = 20
# the colored Gibbs engine on the ML-100k design (gcsweep): one fp32
# colored sweep against the same sweep in fp64, both on the card, from
# one state and one set of variates: max |Δ| of w, V, e and α over the
# field's scale (max |fp64|, at least 1); one pass measured 7e-7 on the
# CPU at the tiny design's size, and ~2k chained colors per factor here
GCSWEEP_TOL = 1e-3
# the colored fits (gcfit, gcofit) stop as vrfit's do, after GC_MIN_ITER
# sweeps at least; the joint-row fit without linear terms (gjvfit) after
# GJV_MAX_ITER sweeps or GJV_FIT_S seconds, whichever comes first
GC_FIT_S = 12.0
GC_MIN_ITER = 1
GC_MAX_ITER = 20
GJV_FIT_S = 12.0
GJV_MAX_ITER = 5


def fail(message):
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase, message):
    print(f"[{phase}] {message}", flush=True)


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` runs after one
    warm-up, timed with CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` fp32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare_gram(torch, kernel, plain, rows_of, ops, S, kw, tol, label,
                 row_ops=4, modes=REDUCED_MODES, mode_device=False):
    """One Gram kernel vs its plain version on ``ops`` in IEEE fp32 and
    fp64 (max error over max |plain|, at most ``tol``), then fp32 times
    (``tools.vi_gram.time_kernel``): the kernel by CUDA events (``ms``,
    the wrapper's host work included) and by the profiler's kernel
    durations (``device_ms``: pass 1 and the carry apart; None, with the
    reason, where no trace of this long process held the call whole),
    the one-call yardstick (torch.bmm of the prebuilt slot-masked
    operand), the bound of the kernel's work on this chunk's rows
    (``row_ops`` D operations per row to build it); and the plain
    version's time.  Then, under ``modes[mode]``, the same in each
    reduced Gram mode in fp32 (kernel vs plain in that mode within
    KERNEL_TOL; ``vs_ieee``, the kernel's distance from its IEEE output,
    within the self-check's gate; the yardstick the bf16 torch.bmm, three
    summed for "split"; the profiler's pass-1 / carry split too with
    ``mode_device``).  Every mode's row names the Gram pass that ran
    (``pass``: the one whose count in the wrapper's ``pass_launches``
    rose by the two launches there, failing if another did or the rule
    ops/gram.gram_pass names another) and holds two launches to the same
    bits (``deterministic``)."""
    from myfm_tpu_torch.ops import gram
    from myfm_tpu_torch.tools.vi_gram import (cast, check, device_ms,
                                              time_kernel)

    def pass_and_bits(row, mkw):
        mode = gram.gram_mode(mkw.get("fast_matmul", False))
        before = dict(kernel.pass_launches)
        a, ca = kernel(*o, S, **mkw)
        b, cb = kernel(*o, S, **mkw)
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(ca, cb)):
            fail(f"{label}, {mode}: two launches gave different bits")
        ran = {p: n - before[p] for p, n in kernel.pass_launches.items()
               if n != before[p]}
        rule = gram.gram_pass(mode, a.shape[2], a.shape[1])
        if ran != {rule: 2}:
            fail(f"{label}, {mode}: passes launched {ran}, the rule names "
                 f"{rule}")
        row.update(deterministic=True, **{"pass": rule})

    try:
        row = check(kernel, plain, ops, S, kw, tol)
    except AssertionError as exc:
        fail(f"{label}: {exc}")
    o = cast(ops, torch.float32)
    pass_and_bits(row, kw)
    row.update(time_kernel(kernel, rows_of, o, S, kw, row_ops))
    try:
        row.update(device_ms(lambda: kernel(*o, S, **kw)))
    except RuntimeError as exc:
        row.update(device_ms=None, device_ms_error=str(exc))
    row["plain_ms"] = cuda_ms(torch, lambda: plain(*o, S, **kw), 3)
    if modes:
        ieee, _ = kernel(*o, S, **kw)
        row["modes"] = {}
    for mode in modes:
        mkw = dict(kw, fast_matmul=mode)
        try:
            m = check(kernel, plain, ops, S, mkw,
                      {"float32": tol["float32"]})
        except AssertionError as exc:
            fail(f"{label}, {mode}: {exc}")
        out, _ = kernel(*o, S, **mkw)
        torch.cuda.synchronize()
        m["vs_ieee"] = float((out - ieee).abs().max()) / max(
            float(ieee.abs().max()), 1.0)
        if not m["vs_ieee"] <= gram.SELFCHECK_TOL[mode]:
            fail(f"{label}, {mode}: {m['vs_ieee']:.3e} of scale from IEEE "
                 f"(gate {gram.SELFCHECK_TOL[mode]:.0e})")
        pass_and_bits(m, mkw)
        m.update(time_kernel(kernel, rows_of, o, S, mkw, row_ops))
        if mode_device:
            try:
                m.update(device_ms(lambda: kernel(*o, S, **mkw)))
            except RuntimeError as exc:
                m.update(device_ms=None, device_ms_error=str(exc))
        m["plain_ms"] = cuda_ms(torch, lambda: plain(*o, S, **mkw), 1)
        row["modes"][mode] = m
        del out
    return row


def build_design(seed):
    import scipy.sparse as sps

    from myfm_tpu_torch import RelationBlock
    from myfm_tpu_torch.utils.benchmark_data import (
        SyntheticMovieLensManager,
    )

    man = SyntheticMovieLensManager("10m", rank=8, random_seed=seed)
    data = man.load_rating_all()
    users = data["user_id"] - 1
    items = data["movie_id"] - 1
    days = data["day"]
    y = data["rating"]
    n = y.shape[0]
    n_users, n_items = man.n_users, man.n_items
    n_days = int(days.max()) + 1
    eye_u = sps.identity(n_users, format="csr")
    eye_i = sps.identity(n_items, format="csr")
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(n * TEST_SHARE)

    def design(rows):
        X = sps.csr_matrix(
            (np.ones(rows.size), (np.arange(rows.size), days[rows])),
            shape=(rows.size, n_days),
        )
        blocks = [RelationBlock(users[rows], eye_u),
                  RelationBlock(items[rows], eye_i)]
        return X, blocks, y[rows]

    grouping = [0] * n_days + [1] * n_users + [2] * n_items
    shape = dict(rows=n, users=n_users, items=n_items, days=n_days)
    return design(perm[n_test:]), design(perm[:n_test]), grouping, shape


def kernel_phase(torch, plan, state, y_tiles, label="kernel"):
    """Kernel vs plain at each table's first chunk of tiles."""
    from myfm_tpu_torch.ops import gram

    rows = []
    for ti, t in enumerate(plan.tables):
        ops = first_chunk_ops(torch, plan, ti, state.core.w, state.core.V,
                              y_tiles)
        S = t.tile_entities
        row = dict(table=ti, K=ops[0].shape[0], T=t.tile_rows, S=S,
                   n_cross=len(ops[1]))
        row.update(compare_gram(
            torch, gram.fused_tile_gram_cross,
            gram.fused_tile_gram_cross_reference,
            lambda o, S: gram.cross_rows(o[0], o[1], o[2], S), ops, S,
            {}, KERNEL_TOL, f"{label} vs plain, table {ti}",
        ))
        rows.append(row)
    return rows


def sweep_phase(torch, plan, trainer, state):
    """One sweep through the kernel vs one through the plain version, in
    each Gram mode, same state and variates (per mode)."""
    import dataclasses

    from myfm_tpu_torch.ops.categorical import (
        categorical_sweep,
        draw_sweep_variates,
    )

    v = draw_sweep_variates(plan, trainer.cfg, RANK, trainer.generator,
                            torch.float32, trainer.device)
    out = {}
    for mode in ALL_MODES:
        cfg = dataclasses.replace(trainer.cfg, gram_fast_matmul=mode)
        args = (plan, state, trainer.y, trainer.y_tiles, v, cfg)
        t0 = time.perf_counter()
        a = categorical_sweep(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = categorical_sweep(*args, plain=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res = dict(kernel_s=t1 - t0, plain_s=t2 - t1)
        for f in ("w", "V"):
            x, z = getattr(a.core, f), getattr(b.core, f)
            if not bool(torch.isfinite(x).all()):
                fail(f"sweep ({mode}): non-finite {f}")
            res[f"d{f}"] = float((x - z).abs().max())
            if res[f"d{f}"] > SWEEP_WEIGHT_TOL:
                fail(f"sweep ({mode}): max |Δ{f}| {res[f'd{f}']:.3e} > "
                     f"{SWEEP_WEIGHT_TOL:.0e}")
        n = plan.n_rows
        e2 = float(b.sum_e2)
        res["dsum_e"] = abs(float(a.sum_e) - float(b.sum_e))
        res["dsum_e2"] = abs(float(a.sum_e2) - e2)
        if res["dsum_e"] > SWEEP_MOMENT_TOL * (n * e2) ** 0.5:
            fail(f"sweep ({mode}): |Δ sum_e| {res['dsum_e']:.3e} over "
                 f"scale {(n * e2) ** 0.5:.3e}")
        if res["dsum_e2"] > SWEEP_MOMENT_TOL * e2:
            fail(f"sweep ({mode}): |Δ sum_e2| {res['dsum_e2']:.3e} over "
                 f"{e2:.3e}")
        out[mode] = res
        del a, b
    return out


def own_rows(torch, w, V, t):
    """Table t's own per-entity [w | V | qs] rows."""
    V_t = V[t.col_offset : t.col_offset + t.n_cols]
    return torch.cat([w[t.col_offset : t.col_offset + t.n_cols, None], V_t,
                      (V_t * V_t).sum(1, keepdim=True)], dim=1)


def table_chunks(torch, plan, ti, w, V, y_tiles):
    """Kernel 1's operands of table ti, chunk by chunk of tiles."""
    from myfm_tpu_torch.ops.categorical import (
        eff_tables,
        table_gram_operands,
    )

    eff = eff_tables(plan, w, V)
    own = (own_rows(torch, w, V, plan.tables[ti]) if eff[ti] is None
           else eff[ti])  # an entity+attribute table's effective rows
    return table_gram_operands(plan, ti, w, V, eff, own, y_tiles[ti])


def first_chunk_ops(torch, plan, ti, w, V, y_tiles):
    """Kernel 1's operands at table ti's first chunk of tiles."""
    return list(next(table_chunks(torch, plan, ti, w, V, y_tiles)))


def egram_phase(torch, plan, state, y_tiles):
    """tile_gram (kernel 3) vs plain on each table's first-chunk z rows
    (built with the plain path) and vs kernel 1's Gram of the same tiles;
    then its entry point, entity_grams, over every tile of each table
    with the launch count set to 0 before it, against the sweep's
    per-entity Grams (kernel 1, chunk by chunk).  Returns (comparison
    rows, path rows, launches on the path)."""
    from myfm_tpu_torch.ops import gram
    from myfm_tpu_torch.ops.categorical import _build_table_gram, eff_tables

    w, V = state.core.w, state.core.V
    rows, zs = [], []
    for ti, t in enumerate(plan.tables):
        S, T = t.tile_entities, t.tile_rows
        ops = first_chunk_ops(torch, plan, ti, w, V, y_tiles)
        K = ops[0].shape[0]
        z, _ = gram.cross_rows(ops[0], ops[1], ops[2], S)
        slot = t.slot[: K * T].view(K, T)
        kops = [z, slot, *ops[3:]]
        row = dict(table=ti, K=K, T=T, S=S, D=RANK + 2)
        row.update(compare_gram(
            torch, gram.tile_gram, gram.tile_gram_reference,
            lambda o, S: (o[0], (o[1].long()[:, :, None] == torch.arange(
                S, device=o[1].device)).to(o[0].dtype)),
            kops, S, {}, KERNEL_TOL, f"tile_gram vs plain, table {ti}",
            row_ops=0, modes=(),
        ))
        mine, _ = gram.tile_gram(*kops, S)
        k1, _ = gram.fused_tile_gram_cross(*ops, S)
        torch.cuda.synchronize()
        scale = max(float(k1.abs().max()), 1.0)
        row["vs_kernel1"] = float((mine - k1).abs().max()) / scale
        if not row["vs_kernel1"] <= KERNEL_TOL["float32"]:
            fail(f"egram table {ti}: tile_gram vs kernel 1 "
                 f"{row['vs_kernel1']:.3e} of scale")
        rows.append(row)
        # every tile's z rows, for the entry point below
        zs.append(torch.cat([
            gram.cross_rows(c[0], c[1], c[2], S)[0]
            for c in table_chunks(torch, plan, ti, w, V, y_tiles)]))
    gram.tile_gram.launches = 0
    grams = [gram.entity_grams(t, z, t.tile_entities, RANK + 2)
             for t, z in zip(plan.tables, zs)]
    torch.cuda.synchronize()
    launches = gram.tile_gram.launches
    path = []
    eff = eff_tables(plan, w, V)
    for ti, (t, G) in enumerate(zip(plan.tables, grams)):
        ref = _build_table_gram(plan, ti, w, V, eff,
                                own_rows(torch, w, V, t), y_tiles[ti],
                                plain=False)
        rel = float((G - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
        if not (bool(torch.isfinite(G).all()) and rel <= EGRAM_TOL):
            fail(f"egram: entity_grams of table {ti} vs the sweep's Grams "
                 f"{rel:.3e} of scale")
        path.append(dict(table=ti, B=t.n_cols, tiles=t.n_tiles, rel=rel))
    del zs, grams
    return rows, path, launches


def sections_phase(torch, plan, state, y_tiles):
    """Kernels 5 and 6 through tools/kernel_sections on the user table's
    first chunk: the checks (each level vs plain in each Gram mode, level
    3 bit-equal to the production kernel in that mode; the probe
    bit-equal to the transpose), then the timed runs with the launch
    counts set to 0 before them: every level in IEEE and levels 1-3 in
    "split" and "bf16"."""
    from myfm_tpu_torch.ops import gram
    from myfm_tpu_torch.tools import kernel_sections as ks

    ti = 1  # the user table
    t = plan.tables[ti]
    S = t.tile_entities
    ops = first_chunk_ops(torch, plan, ti, state.core.w, state.core.V,
                          y_tiles)
    try:
        errs = {mode: ks.check_sections(ops, S, mode) for mode in ALL_MODES}
    except AssertionError as exc:
        fail(f"sections: {exc}")
    probe_tpu = torch.randn(4, 2, 256, device="cuda")
    for x in (ops[0], probe_tpu):
        ks.check_probe(x.contiguous())
    gram.gram_section.launches = [0] * len(gram.SECTION_LEVELS)
    gram.gram_section.mode_launches = gram.section_counts()
    gram.interleave_probe.launches = dict.fromkeys(gram.PROBE_VARIANTS, 0)
    levels = [r for mode in ALL_MODES
              for r in ks.time_sections(ops, S, mode=mode)]
    probe = ks.time_probe(ops[0].contiguous())
    probe_small = ks.time_probe(probe_tpu)
    torch.cuda.synchronize()
    for r in levels:
        r["launches"] = gram.gram_section.mode_launches[r["mode"]][
            r["level"]]
        r["err_float32"] = errs[r["mode"]][f"level{r['level']}_err"]
    for r in probe:
        r["launches"] = gram.interleave_probe.launches[r["variant"]]
        r["err_float32"] = 0.0  # bit-equal (check_probe)
    return dict(table=ti, K=ops[0].shape[0], T=t.tile_rows, S=S,
                rows=ops[0].shape[0] * t.tile_rows, levels=levels,
                probe=probe, probe_tpu_shape=probe_small)


def selfcheck_phase(torch):
    """The Gram modes' self-checks on the card (ops/gram.
    gram_fast_selfcheck), each timed on its first, uncached call; both
    must pass, or "auto" would not take the mode."""
    from myfm_tpu_torch.ops import gram

    out = {}
    for mode in REDUCED_MODES:
        t0 = time.perf_counter()
        ok = gram.gram_fast_selfcheck(mode, "cuda")
        out[mode] = dict(ok=ok, s=time.perf_counter() - t0)
        if ok is not True:
            fail(f"modes: the {mode!r} self-check failed on the card")
    return out


def mode_summary(krows, sec):
    """The modes line: per Gram mode, kernel 1 at the fast path's first
    chunks (errors against plain and IEEE, ms, yardstick, bound, summed
    over the tables) and kernel 5's levels."""
    out = {}
    for mode in REDUCED_MODES:
        rows = [r["modes"][mode] for r in krows]
        out[mode] = dict(
            kernel1=dict(
                rel_float32=max(r["rel_float32"] for r in rows),
                vs_ieee=max(r["vs_ieee"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                ieee_ms=sum(r["ms"] for r in krows),
                library_ms=sum(r["library_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows)),
            kernel5={f"level{r['level']}": dict(
                ms=r["ms"], err_float32=r["err_float32"],
                launches=r["launches"], library_ms=r["library_ms"],
                bound_ms=r["bound_ms"])
                for r in sec["levels"] if r["mode"] == mode})
    return out


def osweep_phase(torch, plan, y_tr):
    """One ordered-probit sweep through kernel 1 vs one through the plain
    version, from the same state and variates, in each Gram mode."""
    import dataclasses

    from myfm_tpu_torch.ops.categorical import (
        categorical_sweep,
        draw_sweep_variates,
    )
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.ops.oprobit import _newton_minimize
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    tr = CategoricalGibbsTrainer(
        plan, (y_tr - 1).astype(np.int64), GibbsConfig(task="ordered",
                                                       n_class=5),
        RANK, 0.1, SEED,
    )
    state = tr._initialize()
    v = draw_sweep_variates(plan, tr.cfg, RANK, tr.generator, torch.float32,
                            tr.device)
    per_mode = {}
    for mode in ALL_MODES:
        cfg = dataclasses.replace(tr.cfg, gram_fast_matmul=mode)
        res = {}
        outs = []
        for plain in (False, True):
            syncs = _newton_minimize.syncs
            t0 = time.perf_counter()
            outs.append(categorical_sweep(plan, state, tr.y, tr.y_tiles, v,
                                          cfg, plain=plain))
            torch.cuda.synchronize()
            res["plain_s" if plain else "kernel_s"] = (
                time.perf_counter() - t0)
            res["newton_syncs"] = _newton_minimize.syncs - syncs
        a, b = (o.core for o in outs)
        for f in ("w", "V"):
            x, z = getattr(a, f), getattr(b, f)
            if not bool(torch.isfinite(x).all()):
                fail(f"osweep ({mode}): non-finite {f}")
            res[f"d{f}"] = float((x - z).abs().max())
            if res[f"d{f}"] > SWEEP_WEIGHT_TOL:
                fail(f"osweep ({mode}): max |Δ{f}| {res[f'd{f}']:.3e} > "
                     f"{SWEEP_WEIGHT_TOL:.0e}")
        res["cutpoints"] = a.cutpoints.tolist()
        res["dcut"] = float((a.cutpoints - b.cutpoints).abs().max())
        res["accepts"] = [a.n_mh_accept.tolist(), b.n_mh_accept.tolist()]
        if not (bool(torch.isfinite(a.cutpoints).all())
                and bool((torch.diff(a.cutpoints) > 0).all())
                and res["dcut"] <= OSWEEP_CUT_TOL):
            fail(f"osweep ({mode}): cutpoints {res['cutpoints']} (Δ "
                 f"{res['dcut']:.3e})")
        per_mode[mode] = res
    return per_mode


def log_loss(P, y):
    """Mean −log P[row, class] (P [N, K], or [N] = P(class 1))."""
    if P.ndim == 1:
        P = np.stack([1.0 - P, P], axis=1)
    return float(-np.mean(np.log(P[np.arange(y.size), y] + 1e-15)))


def probit_checks(phase, fm, X_te, b_te, y_te, y_tr, n_class):
    """Held-out checks of a probit fit: probabilities of the right shape
    whose rows sum to 1, log-loss below the class-frequency predictor's.
    Returns the scores."""
    from myfm_tpu_torch.base import roc_auc

    t0 = time.perf_counter()
    P = fm.predict_proba(X_te, b_te)
    t_pred = time.perf_counter() - t0
    out = dict(rows=int(y_te.size), predict_s=t_pred)
    if n_class == 2:
        if not (P.shape == y_te.shape and np.isfinite(P).all()
                and np.all((P >= 0) & (P <= 1))):
            fail(f"{phase}: P(y=1) of shape {P.shape}, finite "
                 f"{np.isfinite(P).all()}")
        out["accuracy"] = float(np.mean((P > 0.5) == (y_te > 0)))
        out["auc"] = roc_auc(y_te > 0, P)
    else:
        dev = float(np.abs(P.sum(axis=1) - 1.0).max())
        if not (P.shape == (y_te.size, n_class) and np.isfinite(P).all()
                and dev <= 1e-5):
            fail(f"{phase}: class probabilities of shape {P.shape}, rows "
                 f"off 1 by {dev}")
        out["row_sum_dev"] = dev
        out["accuracy"] = float(np.mean(P.argmax(axis=1) == y_te))
    freq = np.bincount(y_tr, minlength=n_class) / y_tr.size
    out["log_loss"] = log_loss(P, y_te)
    out["base_log_loss"] = log_loss(
        freq[1] * np.ones(y_te.size) if n_class == 2
        else np.tile(freq, (y_te.size, 1)), y_te)
    if not out["log_loss"] < out["base_log_loss"]:
        fail(f"{phase}: held-out log-loss {out['log_loss']} not below the "
             f"class-frequency predictor's {out['base_log_loss']}")
    return out


def cutpoint_checks(phase, fm):
    cuts = fm.cutpoint_samples
    if not (cuts.ndim == 2 and np.isfinite(cuts).all()
            and np.all(np.diff(cuts, axis=1) > 0)):
        fail(f"{phase}: kept cutpoints not finite and increasing: {cuts}")
    return cuts[-1].tolist()


def build_joint_design():
    from myfm_tpu_torch.utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    train, test = load_synthetic_movielens("100k", 0)
    X_tr, X_te, b_tr, b_te, grouping = build_feature_blocks(
        train, test, J_FEATURES
    )
    return (X_tr, b_tr, train["rating"]), (X_te, b_te, test["rating"]), \
        grouping


def jkernel_phase(torch, plan, trainer, state):
    """joint_tail_pass kernel vs plain on each block's real tail (its
    inputs are the same bits on every run: the port's sums add in one
    order)."""
    from myfm_tpu_torch.ops.forward import factor_q
    from myfm_tpu_torch.ops.gibbs import draw_gibbs_variates, draw_hypers
    from myfm_tpu_torch.ops.joint import (
        build_block_gram,
        dense_tail_operands,
    )
    from myfm_tpu_torch.ops import _build
    from myfm_tpu_torch.ops.joint_tail import (
        _bind,
        _prep,
        joint_tail_pass,
        joint_tail_pass_reference,
        tail_lists,
        tail_lists_reference,
    )
    from myfm_tpu_torch.tools.joint_tail import TAIL_KINDS
    from myfm_tpu_torch.tools.vi_gram import device_ms

    # the initial state's hyperparameters drawn as a sweep draws them
    v = draw_gibbs_variates(plan, trainer.cfg, J_RANK, trainer.generator,
                            torch.float32, trainer.device)
    h = draw_hypers(plan, state, v, trainer.cfg)
    U = torch.cat([h.w[:, None], h.V], dim=1)
    lam = torch.cat([h.lambda_w[:, None], h.lambda_V], dim=1)
    mu = torch.cat([h.mu_w[:, None], h.mu_V], dim=1)
    q = factor_q(plan, h.V)
    D = J_RANK + 2
    rows, lrows = [], []
    for bi, b in enumerate(plan.blocks):
        ds = b.dense_stack
        if ds is None:
            continue
        C, B = ds.xw.shape
        # the prep kernel's lists, bit-equal to their plain version
        Pf = int(ds.feat.shape[1])
        lists = tail_lists(ds.segb, Pf)
        want = tail_lists_reference(ds.segb, Pf)
        for name, g, w in zip(("rows", "lstart", "live"), lists, want):
            if not torch.equal(g, w):
                fail(f"jkernel block {bi}: prep kernel's {name} differ "
                     "from the plain version")
        lrow = dict(block=bi, err_float32=max(
            float((g - w).abs().max()) for g, w in zip(lists, want)))
        G = build_block_gram(b, h.e, q, flat=True).T.contiguous()
        ops32 = [G, G.new_zeros((J_RANK, B)), G.new_zeros((B,)), ds.xw,
                 ds.segb, *dense_tail_operands(b, U, lam, mu, v.noise,
                                               plan.group_index)]
        row = dict(block=bi, C=C, B=B, Pf=int(ds.feat.shape[1]))
        for dtype in (torch.float32, torch.float64):
            o = [t if t.dtype == torch.int32 else t.to(dtype)
                 for t in ops32]
            alpha = h.alpha.to(dtype)
            out = joint_tail_pass(*o, alpha, D)
            ref = joint_tail_pass_reference(*o, alpha, D)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            err, rel = 0.0, 0.0
            for a, r in zip(out, ref):
                if not bool(torch.isfinite(a).all()):
                    fail(f"jkernel block {bi} {name}: non-finite output")
                e_abs = float((a - r).abs().max())
                err = max(err, e_abs)
                rel = max(rel, e_abs / max(float(r.abs().max()), 1.0))
            row[f"err_{name}"] = err
            row[f"rel_{name}"] = rel
            if not rel <= JTAIL_TOL[name]:
                fail(f"jkernel block {bi} {name}: max err {rel:.3e} of "
                     f"scale > {JTAIL_TOL[name]:.0e}")
            if dtype == torch.float32:
                row["ms"] = cuda_ms(
                    torch, lambda: joint_tail_pass(*o, alpha, D), 5
                )
                row["us_per_color"] = row["ms"] * 1e3 / C
                # the device time of each of the call's two kernels
                try:
                    split = device_ms(lambda: joint_tail_pass(*o, alpha, D),
                                      reps=5, kinds=TAIL_KINDS)
                    row.update(prep_device_ms=split["prep_ms"],
                               chain_device_ms=split["chain_ms"],
                               captured=split["captured"])
                except RuntimeError as exc:
                    row.update(prep_device_ms=None, chain_device_ms=None,
                               device_ms_error=str(exc))
                # the prep kernel alone as the call launches it: the same
                # operands at this D, into a new workspace sized for the
                # chain (events: its host work included, and here, under
                # deterministic ops, a fill of that workspace)
                lib = _bind(_build.load("joint_tail"))
                a_t, u_out = alpha.reshape(1), torch.empty_like(o[5])
                ws = _prep(lib, *o[3:], a_t, u_out, D)
                lrow.update(
                    ms=cuda_ms(torch, lambda: _prep(lib, *o[3:], a_t, u_out,
                                                    D), 10),
                    device_ms=row["prep_device_ms"],
                    plain_ms=cuda_ms(
                        torch, lambda: tail_lists_reference(o[4], Pf), 5),
                    library_ms=None,
                    **dict(zip(("bound_ms", "bound_by"), bound(
                        nbytes(*o[3:], ws, u_out), 0))))
                row["plain_ms"] = cuda_ms(
                    torch, lambda: joint_tail_pass_reference(*o, alpha, D),
                    1,
                )
                # the work this tail's data needs: per touched row its
                # Gram statistics and its rank-two update (~6 D² ops), per
                # live slot an (R+1)-dim Cholesky and two solves
                segb = o[4].long()
                touched = int((segb < Pf).sum())
                live = int((torch.nn.functional.one_hot(segb, Pf + 1)
                            [..., :Pf].sum(dim=1) > 0).sum())
                r1 = J_RANK + 1
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes(*o) + nbytes(*out),
                    touched * 6 * D * D + live * (r1**3 // 3 + 4 * r1 * r1),
                )
        rows.append(row)
        lrows.append(lrow)
    if not rows:
        fail("jkernel: no block of the plan has a tail stack")
    return rows, lrows


def jsweep_phase(torch, plan, trainer, state):
    """One sweep with the tail kernel vs one with the plain tail, from
    the same state and variates; every other op runs deterministically,
    so the difference is the tail's alone."""
    import dataclasses

    from myfm_tpu_torch.ops.gibbs import draw_gibbs_variates, gibbs_sweep

    v = draw_gibbs_variates(plan, trainer.cfg, J_RANK, trainer.generator,
                            torch.float32, trainer.device)
    res = {}
    outs = []
    for tail in (True, True, False):
        cfg = dataclasses.replace(trainer.cfg, joint_tail_kernel=tail)
        t0 = time.perf_counter()
        outs.append(gibbs_sweep(plan, state, trainer.y, v, cfg))
        torch.cuda.synchronize()
        res["plain_s" if not tail else "kernel_s"] = (
            time.perf_counter() - t0
        )
    a, a2, b = outs
    for f in ("w", "V"):
        x, x2, z = getattr(a, f), getattr(a2, f), getattr(b, f)
        if not (bool(torch.isfinite(x).all())
                and bool(torch.isfinite(z).all())):
            fail(f"jsweep: non-finite {f}")
        res[f"d{f}"] = float((x - z).abs().max())
        res[f"rerun_d{f}"] = float((x - x2).abs().max())
        if res[f"d{f}"] > JSWEEP_TOL:
            fail(f"jsweep: max |Δ{f}| {res[f'd{f}']:.3e} > {JSWEEP_TOL:.0e}")
    return res


def eakernel_phase(torch, plan, trainer, state):
    """Kernel 4 vs its plain version on each side table's color stack, on
    the operands ``_ea_table_pass`` hands it in a first sweep from the
    initial state (``tools/joint_tail.ea_stacks``): float64 within
    ``JTAIL_TOL``, float32
    within it or no farther from the float64 result than twice the plain
    float32 version (``tools/joint_tail.check``); float32 times of the
    kernel (events, and each of its two kernels' device time), of the
    plain version (one call) and the bound."""
    from myfm_tpu_torch.ops.joint_tail import (
        joint_tail_pass,
        joint_tail_pass_reference,
    )
    from myfm_tpu_torch.tools.joint_tail import TAIL_KINDS, check, ea_stacks
    from myfm_tpu_torch.tools.vi_gram import device_ms

    D = J_RANK + 2
    rows = []
    for st in ea_stacks(plan, trainer, state, J_RANK):
        o, alpha = st["ops"], st["alpha"]
        C, B = o[3].shape
        Pf = int(o[5].shape[1])
        row = dict(table=st["block"], C=C, B=B, Pf=Pf)
        try:
            row.update(check(joint_tail_pass, o, alpha, D))
        except AssertionError as exc:
            fail(f"eakernel table {st['block']}: {exc}")

        def scan():
            return joint_tail_pass(*o, alpha, D)

        row["ms"] = cuda_ms(torch, scan, 5)
        row["us_per_color"] = row["ms"] * 1e3 / C
        try:
            split = device_ms(scan, reps=5, kinds=TAIL_KINDS)
            row.update(prep_device_ms=split["prep_ms"],
                       chain_device_ms=split["chain_ms"],
                       captured=split["captured"])
        except RuntimeError as exc:
            row.update(prep_device_ms=None, chain_device_ms=None,
                       device_ms_error=str(exc))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        joint_tail_pass_reference(*o, alpha, D)
        stop.record()
        torch.cuda.synchronize()
        row["plain_ms"] = start.elapsed_time(stop)
        # as jkernel: per touched row its statistics and rank-two update,
        # per live slot an (R+1)-dim Cholesky and two solves
        segb = o[4].long()
        touched = int((segb < Pf).sum())
        live = int((torch.nn.functional.one_hot(segb, Pf + 1)
                    [..., :Pf].sum(dim=1) > 0).sum())
        r1 = J_RANK + 1
        row["touched"], row["live"] = touched, live
        row["bound_ms"], row["bound_by"] = bound(
            nbytes(*o) + nbytes(*scan()),
            touched * 6 * D * D + live * (r1**3 // 3 + 4 * r1 * r1),
        )
        row["library_ms"] = None
        rows.append(row)
    if not rows:
        fail("eakernel: the plan has no entity+attribute table")
    return rows


def vi_layout_rows(torch, plan, state, y_tiles, rank, tables,
                   name="fused_tile_gram_cross[vi]"):
    """fused_tile_gram_cross in its VI layout vs plain at the first chunk
    of each one-hot table in ``tables``, on the state's operands
    (``y_tiles``: the target column, y or the latent means τ)."""
    from myfm_tpu_torch.ops import gram
    from myfm_tpu_torch.ops.categorical_vi import (
        vi_eff_tables,
        vi_gram_operands,
    )

    c = state.core
    eff = (vi_eff_tables(plan, c.w, c.w_var, c.V, c.V_var)
           if plan.has_side else None)
    out = []
    for ti in tables:
        t = plan.tables[ti]
        ops = next(vi_gram_operands(plan, ti, c.w, c.w_var, c.V, c.V_var,
                                    y_tiles[ti], eff))
        row = dict(kernel=name, table=ti,
                   K=ops[0].shape[0], T=t.tile_rows, S=t.tile_entities,
                   n_cross=len(ops[1]))
        kw = dict(q_lo=2, n_extra=2 * rank, out_rows=2 + rank)
        row.update(compare_gram(
            torch, gram.fused_tile_gram_cross,
            gram.fused_tile_gram_cross_reference,
            lambda o, S: gram.cross_rows(o[0], o[1], o[2], S, 2, 2 * rank),
            list(ops), t.tile_entities, kw, VKERNEL_TOL,
            f"VI-layout kernel vs plain, table {ti}",
        ))
        out.append(row)
    return out


def vkernel_phase(torch, plan, trainer, state):
    """fused_tile_gram vs plain on each entity+attribute table's
    operands and fused_tile_gram_cross (VI layout) vs plain on each
    one-hot table's first chunk, all from the initial state."""
    from myfm_tpu_torch.ops import gram
    from myfm_tpu_torch.ops.categorical_vi import (
        vi_eff_tables,
        vi_ea_gram_operands,
    )

    c = state.core
    eff = vi_eff_tables(plan, c.w, c.w_var, c.V, c.V_var)
    rows = []
    for ti, si in enumerate(plan.side):
        if si is None:
            continue
        t = plan.tables[ti]
        ops = next(vi_ea_gram_operands(plan, ti, c.w, c.w_var, c.V, c.V_var,
                                       c.w0, trainer.y_tiles[ti], eff))
        row = dict(kernel="fused_tile_gram", table=ti, K=ops[0].shape[0],
                   T=t.tile_rows, S=t.tile_entities, D=3 * V_RANK + 2)
        row.update(compare_gram(
            torch, gram.fused_tile_gram, gram.fused_tile_gram_reference,
            lambda o, S: gram.meta_rows(o[0], o[1], o[2], o[3], S),
            list(ops), t.tile_entities, dict(out_rows=2 + V_RANK),
            VKERNEL_TOL, f"fused_tile_gram vs plain, table {ti}",
        ))
        rows.append(row)
    onehot = [ti for ti, si in enumerate(plan.side) if si is None]
    rows += vi_layout_rows(torch, plan, state, trainer.y_tiles, V_RANK,
                           onehot)
    return rows


def vsweep_phase(torch, plan, plan64, trainer, state, phase="vsweep",
                 modes=("highest", "split")):
    """One VI sweep through both kernels vs one through their plain
    versions, from the same state, in each Gram mode of ``modes`` (the VI
    paths run IEEE or "split"; "bf16" is held at kernel level in vkernel
    and v10m); CAVI draws nothing,
    and every other op runs deterministically, so the difference is the
    kernels'.  Both fp32 sweeps are also held against a float64 plain
    IEEE sweep from the same state (on ``plan64``, the design compiled in
    float64), which tells the kernels' share from fp32's own rounding
    along the color scans and the mode's.  The trainer's task decides the
    target column (y, or the latent means τ of the classification
    task)."""
    import dataclasses

    from myfm_tpu_torch.ops.categorical import make_y_tiles
    from myfm_tpu_torch.ops.categorical_vi import categorical_vi_sweep

    y64 = trainer.y.double()
    st64 = dataclasses.replace(state, core=type(state.core)(**{
        f.name: getattr(state.core, f.name).double()
        for f in dataclasses.fields(state.core)}),
        tau=None if state.tau is None else state.tau.double())
    exact = categorical_vi_sweep(
        plan64, st64, y64, make_y_tiles(plan64, y64),
        dataclasses.replace(trainer.cfg, gram_fast_matmul=False),
        plain=True).core
    per_mode = {}
    for mode in modes:
        cfg = dataclasses.replace(trainer.cfg, gram_fast_matmul=mode)
        res = {}
        outs = []
        for plain in (False, True):
            t0 = time.perf_counter()
            outs.append(categorical_vi_sweep(
                plan, state, trainer.y, trainer.y_tiles, cfg,
                plain=plain))
            torch.cuda.synchronize()
            res["plain_s" if plain else "kernel_s"] = (
                time.perf_counter() - t0)
        a, b = (o.core for o in outs)
        for f in ("w", "w_var", "V", "V_var", "e", "elbo"):
            x, z, x64 = getattr(a, f), getattr(b, f), getattr(exact, f)
            if not (bool(torch.isfinite(x).all())
                    and bool(torch.isfinite(z).all())):
                fail(f"{phase} ({mode}): non-finite {f}")
            scale = max(float(z.abs().max()), 1.0)
            res[f"d{f}"] = float((x - z).abs().max()) / scale
            res[f"{f}_kernel_vs_f64"] = float(
                (x.double() - x64).abs().max()) / scale
            res[f"{f}_plain_vs_f64"] = float(
                (z.double() - x64).abs().max()) / scale
            tol = VSWEEP_ELBO_TOL if f == "elbo" else VSWEEP_TOL
            if not res[f"d{f}"] <= tol:
                fail(f"{phase} ({mode}): max |Δ{f}| {res[f'd{f}']:.3e} of "
                     f"scale > {tol:.0e}")
        if outs[0].tau is not None and not (
                bool(torch.isfinite(outs[0].tau).all())
                and bool(torch.isfinite(outs[1].tau).all())):
            fail(f"{phase} ({mode}): non-finite latent means τ")
        per_mode[mode] = res
        del outs, a, b
    return per_mode


VI_SECTIONS = (
    "vi_table_gram", "_vi_entity_updates", "vi_ea_table_gram",
    "_vi_dense_color_step", "vi_eff_tables", "vi_refresh_rows",
)


def vsections_phase(torch, plan, trainer, state):
    """Where one VI sweep's time goes: the module functions of
    ops/categorical_vi.py wrapped with a synchronize before and after
    (the sweep is launch-bound, so host time is its cost), and the device
    operations one color step launches, counted by torch.profiler on the
    first color (that call is left out of the timings and of the sweep's
    total)."""
    from myfm_tpu_torch.ops import categorical_vi as cvi

    spent = dict.fromkeys(VI_SECTIONS, 0.0)
    calls = dict.fromkeys(VI_SECTIONS, 0)
    probe = {}
    saved = {n: getattr(cvi, n) for n in VI_SECTIONS}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            if name == "_vi_dense_color_step" and not probe:
                act = [torch.profiler.ProfilerActivity.CPU,
                       torch.profiler.ProfilerActivity.CUDA]
                t0 = time.perf_counter()
                with torch.profiler.profile(activities=act) as prof:
                    out = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                probe["s"] = time.perf_counter() - t0
                probe["launches"] = sum(
                    1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
                return out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return timed

    try:
        for n in VI_SECTIONS:
            setattr(cvi, n, wrap(n, saved[n]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cvi.categorical_vi_sweep(plan, state, trainer.y, trainer.y_tiles,
                                 trainer.cfg)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for n in VI_SECTIONS:
            setattr(cvi, n, saved[n])
    res = {n: dict(ms=spent[n] * 1e3, calls=calls[n]) for n in VI_SECTIONS}
    total -= probe["s"]
    res["other_ms"] = (total - sum(spent.values())) * 1e3
    res["sweep_ms_with_syncs"] = total * 1e3
    res["device_ops_per_color"] = probe.get("launches")
    return res


def ea_phases(torch, train, test, jgroup, timer, stamps):
    """The eakernel, eafit, eapredict, eaofit and eaopredict phases on
    the ML-100k design; returns (kernel 1 rows, kernel 4 rows, the two
    kernels' launches in eafit, and kernel 1's launches there by Gram
    mode)."""
    from myfm_tpu_torch import MyFMGibbsRegressor, MyFMOrderedProbit
    from myfm_tpu_torch import predictor as predictor_mod
    from myfm_tpu_torch.design import compile_design
    from myfm_tpu_torch.design_categorical import try_compile_categorical
    from myfm_tpu_torch.ops import gram, joint_tail
    from myfm_tpu_torch.ops.forward_categorical import (
        compile_categorical_inference,
    )
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.ops.oprobit import _newton_minimize
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    jX_tr, jb_tr, jy_tr = train
    jX_te, jb_te, jy_te = test
    jstd = float(jy_te.std())
    jyo_tr = (np.asarray(jy_tr) - 1).astype(np.int64)
    jyo_te = (np.asarray(jy_te) - 1).astype(np.int64)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eplan = try_compile_categorical(
        jX_tr, jb_tr, np.asarray(jgroup, np.int32), None, np.float32,
        "cuda", rank=J_RANK, allow_side=True,
    )
    t_eplan = time.perf_counter() - t0
    if eplan is None or not eplan.has_side:
        fail("eakernel: no entity+attribute plan for the ML-100k design")
    etrainer = CategoricalGibbsTrainer(
        eplan, jy_tr, GibbsConfig(task="regression"), J_RANK, 0.1, SEED,
    )
    if etrainer.cfg.joint_tail_kernel is not True:
        fail("eakernel: the EA trainer did not resolve to the tail kernel")
    estate = etrainer._initialize()
    ekrows = kernel_phase(torch, eplan, estate, etrainer.y_tiles,
                          label="eakernel kernel 1")
    earows = eakernel_phase(torch, eplan, etrainer, estate)
    etiling = [(t.n_cols, t.n_tiles, t.tile_rows, t.tile_entities)
               for t in eplan.tables]
    say("eakernel", json.dumps(dict(
        plan_tables=etiling, plan_s=t_eplan,
        side=[tuple(si.stack_feat.shape) for si in eplan.side
              if si is not None])))
    for r in ekrows:
        say("eakernel", json.dumps(dict(kernel="fused_tile_gram_cross", **r)))
    for r in earows:
        say("eakernel", json.dumps(dict(kernel="joint_tail_pass", **r)))
    del eplan, etrainer, estate
    torch.cuda.empty_cache()

    stamps.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_gram_counts(gram)
    joint_tail.joint_tail_pass.launches = 0
    joint_tail.tail_lists.launches = 0
    t_fit = time.perf_counter()
    efm = MyFMGibbsRegressor(
        rank=J_RANK, random_seed=SEED, device="cuda"
    ).fit(jX_tr, jy_tr, X_rel=jb_tr, n_iter=EA_N_ITER, grouping=jgroup,
          callback=timer)
    torch.cuda.synchronize()
    t_fit_end = time.perf_counter()
    ea_gram = gram.fused_tile_gram_cross.launches
    ea_tail = joint_tail.joint_tail_pass.launches
    ea_lists = joint_tail.tail_lists.launches
    if efm.history_.engine != "fastpath":
        fail(f"eafit: resolved to {efm.history_.engine!r}, not 'fastpath'")
    if ea_gram <= 0 or ea_tail <= 0:
        fail(f"eafit: kernel 1 launched {ea_gram} times, kernel 4 "
             f"{ea_tail} times")
    ttfs, rate = fit_rates(stamps, t_fit)
    ea_modes = mode_check("eafit", efm.history_,
                          gram.fused_tile_gram_cross.mode_launches["gibbs"],
                          "split")
    say("eafit", json.dumps(dict(
        engine=efm.history_.engine,
        gram_mode=efm.history_.gram_fast_matmul,
        launches_by_mode=ea_modes, sweeps=len(stamps),
        time_to_first_sweep_s=ttfs, sweeps_per_s=rate,
        fit_s=t_fit_end - t_fit, gram_launches=ea_gram,
        tail_launches=ea_tail, lists_launches=ea_lists,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        plan_cache_gib=cache_gib(),
    )))

    # serving must take the entity-space plan: count its scorer's calls,
    # and hold its mean to the row-space scorer's on the same samples
    splan = compile_categorical_inference(jX_te, jb_te, np.float32, "cuda")
    if splan is None or all(t.xs is None for t in splan.tables):
        fail("eapredict: no entity-space plan with side tables")
    served = []
    scorer = predictor_mod.scores_samples_reduce

    def counted(*a, **k):
        served.append(1)
        return scorer(*a, **k)

    predictor_mod.scores_samples_reduce = counted
    try:
        t0 = time.perf_counter()
        epred = efm.predict(jX_te, jb_te)
        t_pred = time.perf_counter() - t0
    finally:
        predictor_mod.scores_samples_reduce = scorer
    rplan = compile_design(jX_te, jb_te, dtype=np.float32,
                           for_training=False, device="cuda")
    P = efm.predictor_
    rows_sum = sum(
        predictor_mod._rows_reduce(rplan, w0s, ws, vs, "sum", None)
        .double().cpu().numpy()
        for _, w0s, ws, vs in P._sample_chunks())
    d_rows = float(np.abs(epred - rows_sum / len(P.samples)).max())
    ermse = float(np.sqrt(np.mean((epred - jy_te) ** 2)))
    if not served:
        fail("eapredict: serving did not go through the entity-space plan")
    if not (epred.shape == jy_te.shape and np.isfinite(epred).all()
            and ermse < jstd and d_rows <= SERVE_TOL):
        fail(f"eapredict: rmse {ermse} vs std(y_test) {jstd}, entity-space "
             f"vs row-space scores {d_rows}")
    say("eapredict", json.dumps(dict(
        rows=int(jy_te.size), samples=len(P.samples), predict_s=t_pred,
        entity_space_calls=len(served), max_vs_row_space=d_rows,
        rmse=ermse, std_y_test=jstd,
        side_tables=sum(t.xs is not None for t in splan.tables),
    )))
    del efm, P, rplan, splan
    torch.cuda.empty_cache()

    stamps.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_gram_counts(gram)
    joint_tail.joint_tail_pass.launches = 0
    syncs = _newton_minimize.syncs
    t_fit = time.perf_counter()
    eofm = MyFMOrderedProbit(
        rank=J_RANK, random_seed=SEED, device="cuda"
    ).fit(jX_tr, jyo_tr, X_rel=jb_tr, n_iter=EAO_N_ITER, grouping=jgroup,
          callback=timer)
    torch.cuda.synchronize()
    t_fit_end = time.perf_counter()
    eo_gram = gram.fused_tile_gram_cross.launches
    eo_tail = joint_tail.joint_tail_pass.launches
    if eofm.history_.engine != "fastpath" or eo_gram <= 0 or eo_tail <= 0:
        fail(f"eaofit: engine {eofm.history_.engine!r}, kernel 1 launches "
             f"{eo_gram}, kernel 4 launches {eo_tail}")
    ttfs, rate = fit_rates(stamps, t_fit)
    say("eaofit", json.dumps(dict(
        engine=eofm.history_.engine,
        gram_mode=eofm.history_.gram_fast_matmul,
        launches_by_mode=mode_check(
            "eaofit", eofm.history_,
            gram.fused_tile_gram_cross.mode_launches["gibbs"], "split"),
        sweeps=len(stamps),
        time_to_first_sweep_s=ttfs, sweeps_per_s=rate,
        fit_s=t_fit_end - t_fit, gram_launches=eo_gram,
        tail_launches=eo_tail,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        plan_cache_gib=cache_gib(),
        newton_syncs=_newton_minimize.syncs - syncs,
        cutpoints_last=cutpoint_checks("eaofit", eofm),
        mh_accepts=eofm.history_.n_mh_accept,
    )))
    say("eaopredict", json.dumps(probit_checks(
        "eaopredict", eofm, jX_te, jb_te, jyo_te, jyo_tr,
        int(jyo_tr.max()) + 1)))
    del eofm
    return ekrows, earows, ea_gram, ea_tail, ea_modes


def elbo_check(phase, elbos):
    """The largest ELBO decrease between two sweeps; fails above
    ELBO_DROP_TOL of the smallest |ELBO| or on a non-finite ELBO."""
    elbos = np.asarray(elbos, dtype=np.float64)
    drop = float(max(-np.diff(elbos).min(), 0.0)) if elbos.size > 1 else 0.0
    if not (np.isfinite(elbos).all()
            and drop <= ELBO_DROP_TOL * np.abs(elbos).min()):
        fail(f"{phase}: the ELBO fell by {drop} (trace {elbos.tolist()})")
    return drop


def count_launches(torch, fn):
    """Device kernels that ``fn`` launches, counted from
    torch.profiler's CUDA activity (the raw kineto events: building the
    profiler's event tree for a million-launch sweep takes longer than
    the sweep); memsets and copies are not kernels and are not
    counted."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(
        1 for ev in prof.profiler.kineto_results.events()
        if ev.device_type() == cuda
        and not ev.name().startswith(("Memset", "Memcpy"))
    )


def budget(torch, stamps, t_fit, limit_s, min_iter):
    """A fit callback that stamps each sweep's end on the host and stops
    the fit once one more sweep at its own rate would pass ``limit_s``
    seconds from ``t_fit`` (after ``min_iter`` sweeps)."""

    def callback(i, fm, hyper, history):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        spent = stamps[-1] - t_fit
        return (i + 1 >= min_iter
                and spent + spent / (i + 1) > limit_s), None

    return callback


def vcfit10m_phase(torch, train, test, grouping, timer, stamps):
    """VariationalFMClassifier(rank=32) on the ML-10M-shaped design,
    rating >= 4, V10M_N_ITER sweeps: "auto" must take the fast path and
    launch kernel 1's VI layout, the ELBO keep from decreasing,
    predict_proba lie in (0, 1) and the held-out log-loss fall below the
    base rate's.  Returns (the phase's numbers, the kernel's launches)."""
    from myfm_tpu_torch import VariationalFMClassifier
    from myfm_tpu_torch.ops import gram

    (X_tr, b_tr, y_tr), (X_te, b_te, y_te) = train, test
    yc_tr, yc_te = (y_tr >= 4).astype(float), (y_te >= 4).astype(int)
    stamps.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_gram_counts(gram)
    t_fit = time.perf_counter()
    fm = VariationalFMClassifier(
        rank=V10M_RANK, random_seed=SEED, device="cuda"
    ).fit(X_tr, yc_tr, X_rel=b_tr, n_iter=V10M_N_ITER, grouping=grouping,
          callback=timer)
    torch.cuda.synchronize()
    launches = gram.fused_tile_gram_cross.vi_launches
    peak = torch.cuda.max_memory_allocated()
    if fm.history_.engine != "fastpath" or launches <= 0:
        fail(f"vcfit10m: engine {fm.history_.engine!r}, VI-layout "
             f"launches {launches}")
    drop = elbo_check("vcfit10m", fm.history_.elbos)
    ttfs, rate = fit_rates(stamps, t_fit)
    P = fm.predict_proba(X_te, b_te)
    if not (np.isfinite(P).all() and ((P > 0) & (P < 1)).all()):
        fail("vcfit10m: predict_proba outside (0, 1)")
    out = dict(
        sweeps=len(stamps), time_to_first_sweep_s=ttfs, sweeps_per_s=rate,
        vi_launches=launches,
        gram_mode=fm.history_.gram_fast_matmul,
        launches_by_mode=mode_check(
            "vcfit10m", fm.history_,
            gram.fused_tile_gram_cross.mode_launches["vi"], "split"),
        peak_gib=peak / 2**30, plan_cache_gib=cache_gib(),
        elbo_first=fm.history_.elbos[0], elbo_last=fm.history_.elbos[-1],
        elbo_largest_drop=drop,
        **probit_checks("vcfit10m", fm, X_te, b_te, yc_te,
                        yc_tr.astype(int), 2),
    )
    del fm
    torch.cuda.empty_cache()
    return out, launches


def vrfit_phase(torch, train, test, grouping, stamps):
    """Row-space CAVI (the colored sweep, plain PyTorch) on the ML-100k
    design.  Launches per sweep, counted by torch.profiler on one
    sweep's parts through the trainer: the hyperparameter and linear
    stage, one factor of the V sweep (every factor launches the same
    kernels: no step of it depends on the data), and the refresh.  Then
    VariationalFMRegressor and VariationalFMClassifier (rating >= 4)
    with sweep_strategy="colored", each timed sweep by sweep and
    stopped by its callback once VR_FIT_S have passed (at least
    VR_MIN_ITER sweeps, at most VR_MAX_ITER)."""
    from myfm_tpu_torch import VariationalFMClassifier, VariationalFMRegressor
    from myfm_tpu_torch.design import compile_design
    from myfm_tpu_torch.ops import variational as tv
    from myfm_tpu_torch.vi_trainer import VariationalTrainer

    (X_tr, b_tr, y_tr), (X_te, b_te, y_te) = train, test
    t0 = time.perf_counter()
    plan = compile_design(X_tr, b_tr, grouping=grouping, dtype=np.float32,
                          device="cuda")
    t_plan = time.perf_counter() - t0
    colors = [(len(b.colors), 0 if b.color_stack is None
               else int(b.color_stack.rows.shape[0])) for b in plan.blocks]
    cfg = tv.VariationalConfig()
    trainer = VariationalTrainer(plan, y_tr, cfg, V_RANK, 0.1, SEED)
    state = trainer._initialize()
    t0 = time.perf_counter()
    st_a = tv.vi_sweep_stage_a(plan, state, cfg)
    n_stage_a = count_launches(
        torch, lambda: tv.vi_sweep_stage_a(plan, state, cfg))
    n_factor = count_launches(torch, lambda: tv.vi_V_factor(
        plan, st_a.e, st_a.V[:, 0], st_a.V_var[:, 0], st_a.alpha,
        st_a.lambda_V[:, 0], st_a.mu_V[:, 0]))
    n_refresh = count_launches(
        torch, lambda: tv.vi_update_e(plan, st_a, trainer.y, cfg))
    t_count = time.perf_counter() - t0
    del plan, trainer, state, st_a
    torch.cuda.empty_cache()
    out = dict(plan_s=t_plan, block_colors_unrolled_stacked=colors,
               launches_per_sweep=n_stage_a + V_RANK * n_factor + n_refresh,
               launches_stage_a=n_stage_a, launches_per_factor=n_factor,
               launches_refresh=n_refresh, count_s=t_count)

    for task, est in (("regression", VariationalFMRegressor),
                      ("classification", VariationalFMClassifier)):
        yt = y_tr if task == "regression" else (y_tr >= 4).astype(float)
        stamps.clear()
        torch.cuda.reset_peak_memory_stats()
        t_fit = time.perf_counter()
        fm = est(rank=V_RANK, random_seed=SEED, sweep_strategy="colored",
                 device="cuda").fit(X_tr, yt, X_rel=b_tr,
                                    n_iter=VR_MAX_ITER, grouping=grouping,
                                    callback=budget(torch, stamps, t_fit,
                                                    VR_FIT_S, VR_MIN_ITER))
        torch.cuda.synchronize()
        t_fit_s = time.perf_counter() - t_fit
        if fm.history_.engine != "colored":
            fail(f"vrfit: the {task} fit resolved to "
                 f"{fm.history_.engine!r}, not 'colored'")
        ttfs, rate = fit_rates(stamps, t_fit)
        row = dict(engine=fm.history_.engine, sweeps=len(stamps),
                   fit_s=t_fit_s, time_to_first_sweep_s=ttfs,
                   s_per_sweep=s_per_sweep(ttfs, rate),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   plan_cache_gib=cache_gib(),
                   elbo_first=fm.history_.elbos[0],
                   elbo_last=fm.history_.elbos[-1],
                   elbo_largest_drop=elbo_check(f"vrfit {task}",
                                                fm.history_.elbos))
        if task == "regression":
            pred = fm.predict(X_te, b_te)
            rmse = float(np.sqrt(np.mean((pred - y_te) ** 2)))
            if not (np.isfinite(pred).all() and rmse < float(y_te.std())):
                fail(f"vrfit: rmse {rmse} vs std(y_test) {y_te.std()}")
            row.update(rmse=rmse, std_y_test=float(y_te.std()))
        else:
            P = fm.predict_proba(X_te, b_te)
            if not (np.isfinite(P).all() and ((P > 0) & (P < 1)).all()):
                fail("vrfit: predict_proba outside (0, 1)")
            row.update(probit_checks(
                "vrfit", fm, X_te, b_te, (y_te >= 4).astype(int),
                (y_tr >= 4).astype(int), 2))
        out[task] = row
        del fm
        torch.cuda.empty_cache()
    return out


def _cast(obj, dtype):
    """A dataclass of tensors (a GibbsState, GibbsVariates) with its
    floating tensors cast to ``dtype``."""
    import dataclasses

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dtype)
        for f in dataclasses.fields(obj)
        if getattr(getattr(obj, f.name), "is_floating_point", bool)()
    })


def gcsweep_phase(torch, train, grouping):
    """One colored gibbs_sweep on the ML-100k design in fp32 against the
    same sweep in fp64, both on the card, from one fp64 state and one
    set of fp64 variates (cast to fp32 for the fp32 run): the largest
    difference relative to scale of w, V, e and α, and the host seconds
    of each.  Then the launches per sweep, counted by torch.profiler on
    the sweep's parts: the hyperparameters with sweep_w, one factor of
    sweep_V (every factor launches the same kernels: no step depends on
    the data), the refresh, and one sweep_V_joint (the joint-row sweep
    without linear terms, which gjvfit runs)."""
    from myfm_tpu_torch.design import compile_design
    from myfm_tpu_torch.ops import gibbs as tg
    from myfm_tpu_torch.trainer import GibbsTrainer

    X_tr, b_tr, y_tr = train
    t0 = time.perf_counter()
    plans = {dt: compile_design(X_tr, b_tr, grouping=grouping,
                                dtype=np_dt, device="cuda")
             for dt, np_dt in ((torch.float64, np.float64),
                               (torch.float32, np.float32))}
    t_plan = time.perf_counter() - t0
    cfg = tg.GibbsConfig(task="regression")
    trainer = GibbsTrainer(plans[torch.float64], y_tr, cfg, J_RANK, 0.1,
                           SEED, dtype=np.float64)
    state = trainer._initialize()
    variates = tg.draw_gibbs_variates(plans[torch.float64], cfg, J_RANK,
                                      trainer.generator, torch.float64,
                                      "cuda")
    out, res = dict(plan_s=t_plan), {}
    for dt, name in ((torch.float64, "fp64"), (torch.float32, "fp32")):
        args = (_cast(state, dt), trainer.y.to(dt), _cast(variates, dt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[dt] = tg.gibbs_sweep(plans[dt], args[0], args[1], args[2], cfg)
        torch.cuda.synchronize()
        out[f"s_{name}"] = time.perf_counter() - t0
    for f in ("w", "V", "e", "alpha"):
        got = getattr(res[torch.float32], f).double()
        want = getattr(res[torch.float64], f)
        err = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1.0)
        if not (bool(torch.isfinite(got).all()) and err <= GCSWEEP_TOL):
            fail(f"gcsweep: fp32 vs fp64 {f} differs by {err} of scale "
                 f"(tolerance {GCSWEEP_TOL})")
        out[f"err_{f}"] = err

    plan = plans[torch.float32]
    st, v = _cast(state, torch.float32), _cast(variates, torch.float32)
    y = trainer.y.float()
    h = tg.draw_hypers(plan, st, v, cfg)

    def hypers_and_w():
        hh = tg.draw_hypers(plan, st, v, cfg)
        tg.sweep_w(plan, hh.e, hh.w, hh.alpha, hh.lambda_w, hh.mu_w,
                   v.noise[:, 0])

    t0 = time.perf_counter()
    n_hw = count_launches(torch, hypers_and_w)
    n_factor = count_launches(torch, lambda: tg.sweep_V_factor(
        plan, h.e, h.V[:, 0], h.alpha, h.lambda_V[:, 0], h.mu_V[:, 0],
        v.noise[:, 1]))
    n_refresh = count_launches(torch, lambda: tg.refresh_e(
        plan, h, h.w0, h.w, h.V, y, cfg))
    n_joint = count_launches(torch, lambda: tg.sweep_V_joint(
        plan, h.e, h.V, h.alpha, h.lambda_V, h.mu_V, v.noise[:, 1:]))
    out.update(
        block_colors_unrolled_stacked=[
            (len(b.colors), 0 if b.color_stack is None
             else int(b.color_stack.rows.shape[0])) for b in plan.blocks],
        launches_per_sweep=n_hw + J_RANK * n_factor + n_refresh,
        launches_hypers_and_w=n_hw, launches_per_factor=n_factor,
        launches_refresh=n_refresh, launches_sweep_V_joint=n_joint,
        count_s=time.perf_counter() - t0)
    del plans, trainer, state, variates, res, plan, st, v, h
    torch.cuda.empty_cache()
    return out


def gibbs_colored_fits(torch, train, test, grouping, stamps):
    """The colored engine through the estimators on the ML-100k design,
    each fit stopped by ``budget``; returns {phase: line}.

    gcfit    MyFMGibbsRegressor(sweep_strategy="colored"), GC_FIT_S;
    gcpredict its held-out RMSE below std(y_test);
    gcofit   MyFMOrderedProbit(fit_linear=False) through "auto", which
             must resolve to "colored" (the fast path's side features
             and the joint candidate need the linear terms), GC_FIT_S;
             then the cutpoint and held-out probit checks (gcopredict);
    gjvfit   MyFMGibbsRegressor(sweep_strategy="joint", fit_linear=False):
             sweep_V_joint, GJV_MAX_ITER sweeps or GJV_FIT_S; the engine
             must read "joint" and the held-out RMSE fall below
             std(y_test).  Kernel 4 has no part in it: its launches are
             reported, not required."""
    from myfm_tpu_torch import MyFMGibbsRegressor, MyFMOrderedProbit
    from myfm_tpu_torch.ops import joint_tail

    (X_tr, b_tr, y_tr), (X_te, b_te, y_te) = train, test
    std = float(np.std(y_te))
    yo_tr = (np.asarray(y_tr) - 1).astype(np.int64)
    yo_te = (np.asarray(y_te) - 1).astype(np.int64)
    lines = {}

    def fit(phase, est, y, engine, n_iter, limit_s, **kw):
        stamps.clear()
        torch.cuda.reset_peak_memory_stats()
        joint_tail.joint_tail_pass.launches = 0
        t_fit = time.perf_counter()
        fm = est(rank=J_RANK, random_seed=SEED, device="cuda", **kw).fit(
            X_tr, y, X_rel=b_tr, n_iter=n_iter, n_kept_samples=n_iter,
            grouping=grouping,
            callback=budget(torch, stamps, t_fit, limit_s, GC_MIN_ITER))
        torch.cuda.synchronize()
        if fm.history_.engine != engine:
            fail(f"{phase}: resolved to {fm.history_.engine!r}, not "
                 f"{engine!r}")
        ttfs, rate = fit_rates(stamps, t_fit)
        lines[phase] = dict(
            engine=fm.history_.engine, sweeps=len(stamps),
            fit_s=time.perf_counter() - t_fit, time_to_first_sweep_s=ttfs,
            s_per_sweep=s_per_sweep(ttfs, rate),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            plan_cache_gib=cache_gib(),
            tail_kernel_launches=joint_tail.joint_tail_pass.launches)
        return fm

    def rmse_check(phase, fm):
        t0 = time.perf_counter()
        pred = fm.predict(X_te, b_te)
        rmse = float(np.sqrt(np.mean((pred - y_te) ** 2)))
        if not (pred.shape == y_te.shape and np.isfinite(pred).all()
                and rmse < std):
            fail(f"{phase}: rmse {rmse} vs std(y_test) {std}")
        return dict(rows=int(y_te.size), samples=len(fm.predictor_.samples),
                    predict_s=time.perf_counter() - t0, rmse=rmse,
                    std_y_test=std)

    fm = fit("gcfit", MyFMGibbsRegressor, y_tr, "colored", GC_MAX_ITER,
             GC_FIT_S, sweep_strategy="colored")
    lines["gcpredict"] = rmse_check("gcpredict", fm)
    del fm
    fm = fit("gcofit", MyFMOrderedProbit, yo_tr, "colored", GC_MAX_ITER,
             GC_FIT_S, fit_linear=False)
    lines["gcofit"].update(cutpoints_last=cutpoint_checks("gcofit", fm),
                           mh_accepts=fm.history_.n_mh_accept)
    lines["gcopredict"] = probit_checks("gcopredict", fm, X_te, b_te, yo_te,
                                        yo_tr, int(yo_tr.max()) + 1)
    del fm
    fm = fit("gjvfit", MyFMGibbsRegressor, y_tr, "joint", GJV_MAX_ITER,
             GJV_FIT_S, sweep_strategy="joint", fit_linear=False)
    lines["gjvfit"].update(rmse_check("gjvfit", fm))
    del fm
    torch.cuda.empty_cache()
    return lines


def r128_phases(torch, train, test, grouping, timer, stamps):
    """The rank-128 phases on the ML-10M design: r128data (the plan at
    rank 128, which the fast-path gate must accept), r128kernel (kernel 1
    in IEEE, split and bf16 vs plain at each table's first chunk),
    r128fit (the same trainer with gram_fast_matmul=False for
    R128_IEEE_ITER sweeps on that plan, then MyFMGibbsRegressor(rank=128)
    through "auto", which must take the fast path in "bf16" and launch
    kernel 1 in bf16 alone: one warm-up sweep and R128_N_ITER - 1 timed)
    and r128predict (held-out RMSE below std(y_test)).  Returns (kernel
    rows, bf16 launches in r128fit, IEEE launches beside it)."""
    import dataclasses

    from myfm_tpu_torch import MyFMGibbsRegressor
    from myfm_tpu_torch.design_categorical import try_compile_categorical
    from myfm_tpu_torch.ops import gram
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    (X_tr, b_tr, y_tr), (X_te, b_te, y_te) = train, test
    R = R128_RANK
    t0 = time.perf_counter()
    plan = try_compile_categorical(
        X_tr, b_tr, np.asarray(grouping, np.int32), None, np.float32,
        "cuda", rank=R)
    t_plan = time.perf_counter() - t0
    if plan is None:
        fail("r128data: the ML-10M design at rank 128 did not take the "
             "fast path")
    say("r128data", json.dumps(dict(
        rank=R, plan_s=t_plan,
        plan_tables=[(t.n_cols, t.n_tiles, t.tile_rows, t.tile_entities)
                     for t in plan.tables],
        chunk_tiles=[t.chunk_tiles for t in plan.tables])))

    trainer = CategoricalGibbsTrainer(
        plan, y_tr, GibbsConfig(task="regression"), R, 0.1, SEED)
    if trainer.cfg.gram_fast_matmul != "bf16":
        fail(f"r128kernel: rank {R} resolved to Gram mode "
             f"{trainer.cfg.gram_fast_matmul!r}, not 'bf16'")
    state = trainer._initialize()
    krows = []
    for ti, t in enumerate(plan.tables):
        ops = first_chunk_ops(torch, plan, ti, state.core.w, state.core.V,
                              trainer.y_tiles)
        row = dict(table=ti, K=ops[0].shape[0], T=t.tile_rows,
                   S=t.tile_entities, D=R + 2)
        row.update(compare_gram(
            torch, gram.fused_tile_gram_cross,
            gram.fused_tile_gram_cross_reference,
            lambda o, S: gram.cross_rows(o[0], o[1], o[2], S), ops,
            t.tile_entities, {}, KERNEL_TOL,
            f"r128kernel vs plain, table {ti}", mode_device=True))
        say("r128kernel", json.dumps(row))
        krows.append(row)
        del ops
    del state
    torch.cuda.empty_cache()

    # the IEEE sweep time at rank 128, on the same plan
    stamps.clear()
    reset_gram_counts(gram)
    ieee = CategoricalGibbsTrainer(
        plan, y_tr, dataclasses.replace(trainer.cfg, gram_fast_matmul=False),
        R, 0.1, SEED)
    t_fit = time.perf_counter()
    _, ih = ieee.run(R128_IEEE_ITER, 1, lambda *a: timer(*a)[0])
    torch.cuda.synchronize()
    ieee_modes = mode_check("r128fit (IEEE)", ih,
                            gram.fused_tile_gram_cross.mode_launches[
                                "gibbs"], "highest")
    ieee_line = dict(sweeps=len(stamps), first_sweep_s=stamps[0] - t_fit,
                     s_per_sweep=(stamps[-1] - stamps[0])
                     / max(len(stamps) - 1, 1),
                     launches_by_mode=ieee_modes)
    del plan, trainer, ieee, ih
    torch.cuda.empty_cache()

    stamps.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_gram_counts(gram)
    t_fit = time.perf_counter()
    fm = MyFMGibbsRegressor(rank=R, random_seed=SEED, device="cuda").fit(
        X_tr, y_tr, X_rel=b_tr, n_iter=R128_N_ITER, n_kept_samples=N_KEPT,
        grouping=grouping, callback=timer)
    torch.cuda.synchronize()
    t_fit_end = time.perf_counter()
    counts = mode_check("r128fit", fm.history_,
                        gram.fused_tile_gram_cross.mode_launches["gibbs"],
                        "bf16")
    passes = dict(gram.fused_tile_gram_cross.pass_launches)
    if fm.history_.engine != "fastpath":
        fail(f"r128fit: resolved to {fm.history_.engine!r}")
    if passes != dict(gram.pass_counts(), wgmma=counts["bf16"]):
        fail(f"r128fit: kernel 1 ran the Gram passes {passes}, not the "
             f"wgmma pass alone ({counts['bf16']} launches)")
    ttfs, rate = fit_rates(stamps, t_fit)
    say("r128fit", json.dumps(dict(
        engine=fm.history_.engine, gram_mode=fm.history_.gram_fast_matmul,
        sweeps=len(stamps), time_to_first_sweep_s=ttfs, sweeps_per_s=rate,
        fit_s=t_fit_end - t_fit, launches_by_mode=counts,
        launches_by_pass=passes,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        plan_cache_gib=cache_gib(),
        ieee=ieee_line)))
    t0 = time.perf_counter()
    pred = fm.predict(X_te, b_te)
    t_pred = time.perf_counter() - t0
    rmse = float(np.sqrt(np.mean((pred - y_te) ** 2)))
    std = float(y_te.std())
    if not (pred.shape == y_te.shape and np.isfinite(pred).all()
            and rmse < std):
        fail(f"r128predict: rmse {rmse} vs std(y_test) {std}")
    say("r128predict", json.dumps(dict(
        rows=int(y_te.size), predict_s=t_pred, rmse=rmse, std_y_test=std)))
    del fm
    torch.cuda.empty_cache()
    return krows, counts["bf16"], ieee_modes["highest"]


def reset_gram_counts(gram):
    """Every launch count of kernels 1 and 2 to 0, by mode and pass too."""
    gram.fused_tile_gram_cross.launches = 0
    gram.fused_tile_gram_cross.vi_launches = 0
    gram.fused_tile_gram_cross.mode_launches = {
        "gibbs": gram.mode_counts(), "vi": gram.mode_counts()}
    gram.fused_tile_gram_cross.pass_launches = gram.pass_counts()
    gram.fused_tile_gram.launches = 0
    gram.fused_tile_gram.mode_launches = gram.mode_counts()
    gram.fused_tile_gram.pass_launches = gram.pass_counts()


def mode_check(phase, history, counts, want):
    """A fit's resolved Gram mode (``history.gram_fast_matmul``, the
    trainer's cfg; False is "highest") must be ``want`` and its kernel
    launches by mode (``counts``) all in that mode; returns the counts."""
    from myfm_tpu_torch.ops.gram import gram_mode

    got = history.gram_fast_matmul
    ran = sorted(m for m, n in counts.items() if n)
    if got is None or gram_mode(got) != want or ran != [want]:
        fail(f"{phase}: Gram mode {got!r}, launches by mode {counts}; "
             f"want {want!r} alone")
    return dict(counts)


def fit_rates(stamps, t_fit):
    """(time to first sweep, sweeps/s after it, or None after one sweep)
    from the callback's per-sweep host stamps."""
    ttfs = stamps[0] - t_fit
    if len(stamps) < 2:
        return ttfs, None
    return ttfs, (len(stamps) - 1) / (stamps[-1] - stamps[0])


def cache_gib():
    """Device memory the plan cache holds (GiB)."""
    from myfm_tpu_torch.design_cache import plan_cache_bytes

    return plan_cache_bytes("cuda") / 2**30


def plan_phase(torch, X, blocks, grouping):
    """The ML-10M fast-path plan built twice: the O(rows) layouts packed
    on the host by the native planner and uploaded, then derived on the
    card from the entity ids and the counts-only metadata (the default
    on CUDA).  Every tensor of every table must be bit-equal.  Returns
    the card plan and the phase line: each build's seconds and windows
    (``compile_categorical_table``'s timings, summed over the tables;
    "other" is the rest of the build: mappings, cross-table maps), and
    the fingerprint's seconds."""
    import dataclasses

    from myfm_tpu_torch._native import build as build_planner
    from myfm_tpu_torch.design_cache import design_fingerprint
    from myfm_tpu_torch.design_categorical import try_compile_categorical

    t0 = time.perf_counter()
    build_planner()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    design_fingerprint(X, blocks, grouping)
    t_fp = time.perf_counter() - t0
    line = dict(native_build_s=t_native, fingerprint_s=t_fp)
    plans = {}
    for name, on_card in (("host", False), ("card", True)):
        windows = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = try_compile_categorical(
            X, blocks, np.asarray(grouping, np.int32), None, np.float32,
            "cuda", rank=RANK, derive_src_on_device=on_card,
            timings=windows)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        if plan is None:
            fail("plan: the design did not compile to the fast path")
        windows["other"] = total - sum(windows.values())
        line[name] = dict(s=total, windows=windows)
        plans[name] = plan
    for ti, (a, b) in enumerate(zip(plans["host"].tables,
                                    plans["card"].tables)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            same = (torch.equal(x, y) and x.dtype == y.dtype
                    if isinstance(x, torch.Tensor)
                    else np.array_equal(x, y))
            if not same:
                fail(f"plan: table {ti} field {f.name} differs between "
                     "the host pack and the card derivation")
    for a, b in zip(plans["host"].cross_ent, plans["card"].cross_ent):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail("plan: the cross-table entity maps differ")
    line["bit_equal"] = True
    return plans["card"], line


def chain_check(phase, pairs):
    """Two chains' host values, pair by pair: bit-equal, or the run
    fails with their largest difference.  Returns the reading."""
    diff, scale, equal = 0.0, 0.0, True
    for x, y in pairs:
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if x.shape != y.shape:
            fail(f"{phase}: shapes {x.shape} and {y.shape} differ")
        equal = equal and np.array_equal(x, y)
        if x.size:
            diff = max(diff, float(np.abs(x - y).max()))
            scale = max(scale, float(np.abs(x).max()))
    rel = diff / max(scale, 1e-30)
    if not equal:
        fail(f"{phase}: two chains from one seed differ by {diff:.3e} "
             f"({rel:.3e} of scale)")
    return dict(bit_equal=equal, max_abs_diff=diff)


def sample_pairs(a_samples, b_samples):
    """(a, b) host arrays of two lists of kept samples: w0, w, V and
    every cutpoint vector."""
    if len(a_samples) != len(b_samples):
        fail(f"{len(a_samples)} and {len(b_samples)} kept samples")
    for a, b in zip(a_samples, b_samples):
        yield np.float64(a.w0), np.float64(b.w0)
        yield a.w, b.w
        yield a.V, b.V
        if len(a.cutpoints) != len(b.cutpoints):
            fail("the samples' cutpoint groups differ")
        yield from zip(a.cutpoints, b.cutpoints)


def ckpt_phase(torch, train, grouping):
    """Resume on the card: CategoricalGibbsTrainer on the ML-10M plan
    (compiled here), rank 32, regression, default ops: 4 sweeps in one
    go, and 2 sweeps checkpointed at 2 then resumed to 4 in a fresh
    trainer.  The last 2 kept samples go through ``chain_check``.  Also
    the checkpoint's bytes and its write and read seconds."""
    import os
    import tempfile

    from myfm_tpu_torch import checkpoint
    from myfm_tpu_torch.design_categorical import try_compile_categorical
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.ops._build import BUILD_DIR
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    X_tr, blocks_tr, y_tr = train
    plan = try_compile_categorical(
        X_tr, blocks_tr, np.asarray(grouping, np.int32), None, np.float32,
        "cuda", rank=RANK)
    if plan is None:
        fail("ckpt: the design did not compile to the fast path")
    io_s = {"write": [], "read": []}
    real = checkpoint.save_checkpoint, checkpoint.load_checkpoint

    def timed(kind, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            io_s[kind].append(time.perf_counter() - t0)
            return out
        return run

    def trainer():
        return CategoricalGibbsTrainer(
            plan, y_tr, GibbsConfig(task="regression"), RANK, 0.1, SEED)

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    checkpoint.save_checkpoint = timed("write", real[0])
    checkpoint.load_checkpoint = timed("read", real[1])
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
            path = os.path.join(d, "chain.npz")
            t0 = time.perf_counter()
            full, _ = trainer().run(4, 4)
            trainer().run(2, 1, checkpoint_path=path, checkpoint_every=2)
            size = os.path.getsize(path)
            resumed, _ = trainer().run(4, 4, checkpoint_path=path,
                                       resume=True)
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
    finally:
        checkpoint.save_checkpoint, checkpoint.load_checkpoint = real
    if len(resumed.samples) != 2:
        fail(f"ckpt: the resumed run kept {len(resumed.samples)} samples")
    line = chain_check("ckpt", sample_pairs(full.samples[-2:],
                                            resumed.samples))
    line.update(checkpoint_bytes=size, write_s=io_s["write"],
                read_s=io_s["read"],
                sweeps=dict(full=4, first=2, resumed=2), phase_s=t_all)
    return line


def drain_phase(torch, train, grouping):
    """The harvest on the cached ML-10M design (rank 32).

    Timed: MyFMGibbsRegressor for DRAIN_ITER sweeps with every sample
    kept, once with an eager user callback and once with the default
    (pipelined) harvest, default ops.  Per run: the whole fit's seconds
    (plan from the cache, initialisation included) and its sweeps per
    second, the loop's host syncs per sweep
    (``run_mcmc_loop.host_syncs``), the synchronising calls torch's
    sync-debug mode reports per sweep, the peak pinned bytes the
    harvest held (``_HostCopy.peak_pinned_bytes``), the pinned blocks
    the host allocator made (``num_host_alloc``) and the bytes it holds
    after the fit.  The two chains, default ops, through
    ``chain_check``: every kept sample's w0, w and V and the hyper trace
    (their largest V difference is reported too).

    Checked as well: MyFMOrderedProbit for DRAIN_CHECK_ITER sweeps, eager
    then pipelined, default ops: every kept sample's w0, w, V and
    cutpoints, the hyper trace and the MH accept trace through
    ``chain_check``."""
    import warnings

    from myfm_tpu_torch import MyFMGibbsRegressor, MyFMOrderedProbit
    from myfm_tpu_torch.design_cache import get_or_build
    from myfm_tpu_torch.trainer import _HostCopy, run_mcmc_loop

    X_tr, blocks_tr, y_tr = train

    def host_alloc():
        """The host allocator's pinned blocks made so far and the bytes
        it holds (None where this torch has no such counters)."""
        stats = getattr(torch.cuda, "host_memory_stats", dict)()
        return (stats.get("num_host_alloc"),
                stats.get("allocated_bytes.current"))

    def fit(est, y, n_iter, callback):
        hits = get_or_build.hits
        fm = est(rank=RANK, random_seed=SEED, device="cuda").fit(
            X_tr, y, X_rel=blocks_tr, n_iter=n_iter, n_kept_samples=n_iter,
            grouping=grouping, callback=callback)
        torch.cuda.synchronize()
        if get_or_build.hits - hits != 1:
            fail("drain: a fit did not take its plan from the cache")
        return fm

    harvests = (("eager", lambda *a: (False, None)), ("pipelined", None))
    line, fits = {}, {}
    for name, callback in harvests:
        syncs = run_mcmc_loop.host_syncs
        _HostCopy.peak_pinned_bytes = _HostCopy.pinned_bytes
        allocs, _ = host_alloc()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                fits[name] = fit(MyFMGibbsRegressor, y_tr, DRAIN_ITER,
                                 callback)
                fit_s = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch_syncs = sum("synchroniz" in str(w.message) for w in caught)
        allocs_after, held = host_alloc()
        line[name] = dict(
            fit_s=fit_s, sweeps_per_s=DRAIN_ITER / fit_s,
            loop_syncs_per_sweep=(run_mcmc_loop.host_syncs - syncs)
            / DRAIN_ITER,
            torch_syncs_per_sweep=torch_syncs / DRAIN_ITER,
            peak_pinned_bytes=_HostCopy.peak_pinned_bytes,
            pinned_left_bytes=_HostCopy.pinned_bytes,
            host_allocs=(None if allocs is None
                         else allocs_after - allocs),
            host_alloc_bytes=held)
        if _HostCopy.pinned_bytes:
            fail(f"drain: {_HostCopy.pinned_bytes} pinned bytes still "
                 "held after the fit")
    line.update(sweeps=DRAIN_ITER, kept=DRAIN_ITER,
                default_ops_max_abs_diff_V=max(
                    float(np.abs(a.V - b.V).max()) for a, b in zip(
                        fits["eager"].predictor_.samples,
                        fits["pipelined"].predictor_.samples)))
    line["regression"] = chain_check(
        "drain", fit_pairs(fits["eager"], fits["pipelined"], DRAIN_ITER))
    del fits

    yo = (y_tr - 1).astype(np.int64)
    eager, lazy = (fit(MyFMOrderedProbit, yo, DRAIN_CHECK_ITER, cb)
                   for _, cb in harvests)
    pairs = fit_pairs(eager, lazy, DRAIN_CHECK_ITER)
    pairs += list(zip(eager.history_.n_mh_accept_trace,
                      lazy.history_.n_mh_accept_trace))
    line["check"] = dict(task="ordered", sweeps=DRAIN_CHECK_ITER,
                         **chain_check("drain", pairs))
    return line


def fit_pairs(a, b, sweeps):
    """(a, b) host arrays of two fits: every kept sample (w0, w, V,
    cutpoints) and every sweep's hyperparameters."""
    if len(a.history_.hypers) != sweeps or len(b.history_.hypers) != sweeps:
        fail("drain: a checked fit's hyper trace is short")
    pairs = list(sample_pairs(a.predictor_.samples, b.predictor_.samples))
    for x, y in zip(a.history_.hypers, b.history_.hypers):
        pairs += [(getattr(x, k), getattr(y, k)) for k in
                  ("alpha", "mu_w", "lambda_w", "mu_V", "lambda_V")]
    return pairs


def rowspace_pairs(torch, train, grouping):
    """Default-ops same-seed pairs on the row-space engines (ML-100k,
    rank 10): the colored engine and the joint engine (kernel 4), each
    fit twice from one seed; every kept sample and the hyper trace
    through ``chain_check``, with each fit's seconds."""
    from myfm_tpu_torch import MyFMGibbsRegressor

    X, b, y = train
    line = {}
    for engine, n_iter in (("colored", DRAIN_COLORED_ITER),
                           ("joint", DRAIN_JOINT_ITER)):
        fits, secs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            fits.append(MyFMGibbsRegressor(
                rank=J_RANK, random_seed=SEED, device="cuda",
                sweep_strategy=engine).fit(
                X, y, X_rel=b, n_iter=n_iter, n_kept_samples=n_iter,
                grouping=grouping))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if fits[-1].history_.engine != engine:
                fail(f"drain: the {engine} pair resolved to "
                     f"{fits[-1].history_.engine!r}")
        line[engine] = dict(sweeps=n_iter, fit_s=secs, **chain_check(
            f"drain {engine}", fit_pairs(*fits, n_iter)))
    return line


def libfm_phase(torch, phase, est, cb, train, grouping, n_iter,
                n_kept):
    """One fit through a libFM callback of ``utils.callbacks`` on the
    cached ML-10M plan.

    The callback is the one a user passes; the smoke only wraps its
    ``_measure_score`` (a wait for the compute stream, then the host
    clock around the callback's own work: the device score, its copy to
    the host and the metrics) and its ``_score_on_device`` (the host
    clock around it, the score and its copy apart from the metrics; a
    device clone of the sweep's weights, and the score, at the first and
    the last sweep), and reads kernel 1's launch counter at every
    sweep.
    The wait is the one the callback's score fetch makes anyway; it
    leaves the harvest's side stream alone, so the loop's host syncs
    count as they would without the wrapper.  Returns (fm, info,
    snapshots): snapshots maps a sweep to (w0, w, V on the card, the
    callback's score)."""
    from myfm_tpu_torch.design_cache import get_or_build
    from myfm_tpu_torch.ops import gram
    from myfm_tpu_torch.trainer import run_mcmc_loop

    X_tr, b_tr, y_tr = train
    stamps, cb_s, score_s, per_sweep, snaps = [], [], [], [], {}
    measure, score_on_device = cb._measure_score, cb._score_on_device

    def timed_measure(i, fm, hyper):
        per_sweep.append(gram.fused_tile_gram_cross.launches)
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        out = measure(i, fm, hyper)
        t1 = time.perf_counter()
        cb_s.append(t1 - t0)
        stamps.append(t1)
        return out

    def spied_score(fm):
        t0 = time.perf_counter()
        score = score_on_device(fm)
        score_s.append(time.perf_counter() - t0)
        if len(cb_s) in (0, n_iter - 1):
            st = fm._state
            snaps[len(cb_s)] = (st.w0.clone(), st.w.clone(), st.V.clone(),
                                score)
        return score

    cb._measure_score, cb._score_on_device = timed_measure, spied_score
    reset_gram_counts(gram)
    hits, syncs = get_or_build.hits, run_mcmc_loop.host_syncs
    torch.cuda.reset_peak_memory_stats()
    t_fit = time.perf_counter()
    fm = est(rank=RANK, random_seed=SEED, device="cuda").fit(
        X_tr, y_tr, X_rel=b_tr, n_iter=n_iter, n_kept_samples=n_kept,
        grouping=grouping, callback=cb)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    del cb._measure_score, cb._score_on_device
    launches = gram.fused_tile_gram_cross.launches
    if get_or_build.hits - hits != 1:
        fail(f"{phase}: the fit did not take its plan from the cache")
    if fm.history_.engine != "fastpath":
        fail(f"{phase}: resolved to {fm.history_.engine!r}")
    modes = mode_check(phase, fm.history_,
                       gram.fused_tile_gram_cross.mode_launches["gibbs"],
                       "split")
    steps = np.diff([0] + per_sweep)
    if len(cb.result_trace) != n_iter or (steps <= 0).any():
        fail(f"{phase}: {len(cb.result_trace)} callback calls of {n_iter}; "
             f"kernel 1 launches per sweep {steps.tolist()}")
    plan_device = cb._device_plan.group_index.device
    if plan_device.type != "cuda":
        fail(f"{phase}: the callback's test plan lives on {plan_device}")
    ttfs, rate = fit_rates(stamps, t_fit)
    info = dict(engine=fm.history_.engine, launches_by_mode=modes,
                kernel_launches=launches,
                launches_per_sweep=steps.tolist(), sweeps=n_iter,
                plan_from_cache=True, test_plan_device=str(plan_device),
                test_rows=cb.n_test_data, time_to_first_sweep_s=ttfs,
                sweeps_per_s=rate, fit_s=fit_s,
                callback_ms=[1e3 * t for t in cb_s],
                callback_ms_after_first=float(np.median(cb_s[1:])) * 1e3,
                score_ms=[1e3 * t for t in score_s],
                host_syncs_per_sweep=(run_mcmc_loop.host_syncs - syncs)
                / n_iter,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                plan_cache_gib=cache_gib())
    return fm, info, snaps


def libfm_phases(torch, train, test, grouping, fit_rate):
    """lfit, lofit and lcfit (see the module docstring).  Returns their
    kernel 1 launches by phase."""
    import os
    import tempfile

    from myfm_tpu_torch import (
        FM,
        MyFMGibbsClassifier,
        MyFMGibbsRegressor,
        MyFMOrderedProbit,
    )
    from myfm_tpu_torch.utils.callbacks import (
        ClassificationCallback,
        OrderedProbitCallback,
        RegressionCallback,
    )

    X_te, b_te, y_te = test
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "trace.csv")
        cb = RegressionCallback(L_ITER, X_te, y_te, X_rel_test=b_te,
                                clip_min=1, clip_max=5,
                                trace_path=trace_path)
        fm, info, snaps = libfm_phase(torch, "lfit", MyFMGibbsRegressor, cb,
                                      train, grouping, L_ITER, 1)
        with open(trace_path) as f:
            lines = f.read().splitlines()
    errs = {}
    for it, (w0, w, V, score) in sorted(snaps.items()):
        host = FM(float(w0), w.cpu().numpy(), V.cpu().numpy()).predict_score(
            X_te, b_te)
        err = np.abs(score - host) / (1.0 + np.abs(host))
        errs[it] = float(err.max())
        if not err.max() <= LIBFM_TOL:
            fail(f"lfit: sweep {it}: the callback's device score is "
                 f"{err.max():.3g} (relative) from the host forward")
    trace = cb.result_trace
    bad = [(i, k, v) for i, row in enumerate(trace) for k, v in row.items()
           if not (np.isnan(v) if k == "rmse_all_but_5" and i < 5
                   else np.isfinite(v))]
    pred = fm.predict(X_te, b_te)
    rmse_pred = float(np.sqrt(np.mean((pred - y_te) ** 2)))
    std = float(y_te.std())
    header = ",".join(trace[0])
    if bad or not trace[-1]["rmse"] < std or not abs(
            trace[-1]["rmse_this"] - rmse_pred) <= 1e-4 or lines[0] != header \
            or len(lines) != L_ITER + 1:
        fail(f"lfit: trace entries out of place {bad}; final rmse "
             f"{trace[-1]['rmse']} vs std(y_test) {std}; rmse_this "
             f"{trace[-1]['rmse_this']} vs predict's {rmse_pred}; CSV "
             f"{len(lines)} lines, header {lines[:1]}")
    info.update(fit_sweeps_per_s=fit_rate, score_rel_err=errs,
                rmse=trace[-1]["rmse"], rmse_this=trace[-1]["rmse_this"],
                rmse_all_but_5=trace[-1]["rmse_all_but_5"],
                predict_rmse=rmse_pred, std_y_test=std,
                csv_lines=len(lines))
    say("lfit", json.dumps(info))
    launches["lfit"] = info["kernel_launches"]
    del fm, cb, snaps
    torch.cuda.empty_cache()

    y_tr = train[2]
    yo_tr, yo_te = (y_tr - 1).astype(np.int64), (y_te - 1).astype(np.int64)
    for phase, est, ytr_, cb in (
        ("lofit", MyFMOrderedProbit, yo_tr, OrderedProbitCallback(
            LP_ITER, X_te, yo_te, 5, X_rel_test=b_te)),
        ("lcfit", MyFMGibbsClassifier, (y_tr >= 4).astype(np.int64),
         ClassificationCallback(LP_ITER, X_te, (y_te >= 4).astype(np.int64),
                                X_rel_test=b_te)),
    ):
        fm, info, _ = libfm_phase(torch, phase, est, cb,
                                  (train[0], train[1], ytr_), grouping,
                                  LP_ITER, 1)
        last = cb.result_trace[-1]
        checks = dict(log_loss=last["log_loss"], accuracy=last["accuracy"],
                      log_loss_all_but_5=last["log_loss_all_but_5"],
                      accuracy_all_but_5=last["accuracy_all_but_5"])
        if phase == "lofit":
            mean = cb.predictions / cb.n_samples
            checks["max_row_sum_err"] = float(
                np.abs(mean.sum(axis=1) - 1.0).max())
            if not checks["max_row_sum_err"] <= 1e-6:
                fail(f"lofit: class probabilities sum to 1 only within "
                     f"{checks['max_row_sum_err']}")
            checks["rmse"] = last["rmse"]
        if not all(np.isfinite(v) for v in checks.values()):
            fail(f"{phase}: {checks}")
        info.update(checks)
        say(phase, json.dumps(info))
        launches[phase] = info["kernel_launches"]
        del fm, cb
        torch.cuda.empty_cache()
    return launches


def run_phase(phase, fn):
    """fn() of a phase of ``myfm_tpu_torch.tools.sharded``; its failure
    fails the run."""
    from myfm_tpu_torch.tools.sharded import PhaseError

    try:
        return fn()
    except PhaseError as exc:
        fail(f"{phase}: {exc}")


def s_per_sweep(ttfs, rate):
    """Seconds per sweep after the first, or the first sweep's own time
    (plan and initialisation included) where a fit ran one."""
    return ttfs if rate is None else 1.0 / rate


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        import myfm_tpu_torch  # noqa: F401 — the package beside this file
        from myfm_tpu_torch.ops import _build, gram, joint_tail
    except ImportError as exc:
        fail(f"the myfm_tpu_torch package is missing: {exc}")
    t_start = time.perf_counter()
    # the plain versions are the reference: full fp32 matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind} | {smi} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda} | count "
                  f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = [item for log in logs.values()
             for item in _build.ptxas_summary(log)]
    say("build", f"{len(logs)} kernel source(s) built in "
                 f"{time.perf_counter() - t0:.1f} s; " + ", ".join(ptxas))
    selfchecks = selfcheck_phase(torch)

    from myfm_tpu_torch import MyFMGibbsRegressor, clear_plan_cache
    from myfm_tpu_torch.design_cache import get_or_build
    from myfm_tpu_torch.ops.gibbs import GibbsConfig
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    t0 = time.perf_counter()
    (X_tr, blocks_tr, y_tr), (X_te, blocks_te, y_te), grouping, shape = (
        build_design(SEED)
    )
    t_design = time.perf_counter() - t0
    plan, pline = plan_phase(torch, X_tr, blocks_tr, grouping)
    tiling = [(t.n_cols, t.n_tiles, t.tile_rows, t.tile_entities)
              for t in plan.tables]
    say("data", f"{shape} train {y_tr.size} test {y_te.size}; design "
                f"{t_design:.1f} s; plan (B, K, T, S) per table {tiling} in "
                f"{pline['card']['s']:.2f} s on the card path: fingerprint "
                f"{pline['fingerprint_s']:.2f} s (the cache's key), then "
                + ", ".join(f"{k} {v:.3f} s" for k, v in
                            pline["card"]["windows"].items()))
    say("plan", json.dumps(pline))

    trainer = CategoricalGibbsTrainer(
        plan, y_tr, GibbsConfig(task="regression"), RANK, 0.1, SEED,
    )
    if trainer.cfg.gram_fast_matmul != "split":
        fail(f"kernel: rank {RANK} resolved to Gram mode "
             f"{trainer.cfg.gram_fast_matmul!r}, not 'split'")
    state = trainer._initialize()
    krows = kernel_phase(torch, plan, state, trainer.y_tiles)
    for r in krows:
        say("kernel", json.dumps(r))
    res = sweep_phase(torch, plan, trainer, state)
    say("sweep", json.dumps(res))
    erows, epath, e_launches = egram_phase(torch, plan, state,
                                           trainer.y_tiles)
    for r in erows:
        say("egram", json.dumps(r))
    say("egram", json.dumps(dict(entity_grams=epath,
                                 tile_gram_launches=e_launches)))
    sec = sections_phase(torch, plan, state, trainer.y_tiles)
    say("sections", json.dumps(sec))
    say("modes", json.dumps(dict(selfcheck=selfchecks,
                                 **mode_summary(krows, sec))))
    say("osweep", json.dumps(osweep_phase(torch, plan, y_tr)))
    del plan, trainer, state
    torch.cuda.empty_cache()

    stamps = []

    def timer(i, fm, hyper, history):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return False, None

    torch.cuda.reset_peak_memory_stats()
    reset_gram_counts(gram)
    clear_plan_cache()
    hits = get_or_build.hits
    t_fit = time.perf_counter()
    fm = MyFMGibbsRegressor(rank=RANK, random_seed=SEED, device="cuda").fit(
        X_tr, y_tr, X_rel=blocks_tr, n_iter=N_ITER, n_kept_samples=N_KEPT,
        grouping=grouping, callback=timer,
    )
    fit_cached = get_or_build.hits > hits
    pred = fm.predict(X_te, blocks_te)
    torch.cuda.synchronize()
    launches = gram.fused_tile_gram_cross.launches
    fit_modes = mode_check("fit", fm.history_,
                           gram.fused_tile_gram_cross.mode_launches["gibbs"],
                           "split")
    peak = torch.cuda.max_memory_allocated()
    if fm.history_.engine != "fastpath":
        fail(f"fit resolved to {fm.history_.engine!r}, not the fast path")
    if launches <= 0:
        fail("the main path never launched fused_tile_gram_cross")
    ttfs = stamps[0] - t_fit
    sweeps_per_s = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    say("fit", f"engine {fm.history_.engine}, Gram mode "
               f"{fm.history_.gram_fast_matmul}, {len(stamps)} sweeps, "
               f"plan from the cache {fit_cached}, "
               f"time to first sweep {ttfs:.2f} s, {sweeps_per_s:.3f} "
               f"sweeps/s, kernel launches {launches} (by mode "
               f"{fit_modes}), peak device memory {peak / 2**30:.2f} GiB "
               f"(plan cache {cache_gib():.3f} GiB)")

    rmse = float(np.sqrt(np.mean((pred - y_te) ** 2)))
    std = float(y_te.std())
    if not (pred.shape == y_te.shape and np.isfinite(pred).all()
            and rmse < std):
        fail(f"predict: rmse {rmse} vs std(y_test) {std}")
    say("predict", f"{y_te.size} held-out rows, RMSE {rmse:.4f} < "
                   f"std(y_test) {std:.4f}; so far "
                   f"{time.perf_counter() - t_start:.1f} s")

    # ---- world size 1 over NCCL: the same fit through mesh= ----
    from myfm_tpu_torch.tools import sharded

    fit_ref = (sharded._samples(fm), pred)
    del fm
    torch.cuda.empty_cache()
    s1 = run_phase("shard1", lambda: sharded.shard1(
        (X_tr, blocks_tr, y_tr), (X_te, blocks_te, y_te), grouping,
        fit_ref))
    say("shard1", json.dumps(s1))
    del fit_ref

    # ---- the probit tasks on the fast path: ML-10M shape, rank 32 ----
    torch.cuda.empty_cache()
    from myfm_tpu_torch import MyFMGibbsClassifier, MyFMOrderedProbit
    from myfm_tpu_torch.ops.oprobit import _newton_minimize

    yo_tr, yo_te = (y_tr - 1).astype(np.int64), (y_te - 1).astype(np.int64)
    o_launches = {}
    for phase, est, ytr_, yte_, n_class in (
        ("ofit", MyFMOrderedProbit, yo_tr, yo_te, 5),
        ("cfit", MyFMGibbsClassifier, (y_tr >= 4).astype(np.int64),
         (y_te >= 4).astype(np.int64), 2),
    ):
        stamps.clear()
        torch.cuda.reset_peak_memory_stats()
        reset_gram_counts(gram)
        syncs = _newton_minimize.syncs
        hits = get_or_build.hits
        t_fit = time.perf_counter()
        pfm = est(rank=RANK, random_seed=SEED, device="cuda").fit(
            X_tr, ytr_, X_rel=blocks_tr, n_iter=P_N_ITER,
            n_kept_samples=N_KEPT, grouping=grouping, callback=timer,
        )
        if get_or_build.hits - hits != 1:
            fail(f"{phase}: the refit of fit's design missed the plan "
                 "cache")
        torch.cuda.synchronize()
        t_fit_end = time.perf_counter()
        o_launches[phase] = gram.fused_tile_gram_cross.launches
        if pfm.history_.engine != "fastpath":
            fail(f"{phase}: resolved to {pfm.history_.engine!r}")
        if o_launches[phase] <= 0:
            fail(f"{phase}: never launched fused_tile_gram_cross")
        ttfs, rate = fit_rates(stamps, t_fit)
        info = dict(engine=pfm.history_.engine,
                    gram_mode=pfm.history_.gram_fast_matmul,
                    launches_by_mode=mode_check(
                        phase, pfm.history_,
                        gram.fused_tile_gram_cross.mode_launches["gibbs"],
                        "split"),
                    sweeps=len(stamps), plan_from_cache=True,
                    time_to_first_sweep_s=ttfs, sweeps_per_s=rate,
                    fit_s=t_fit_end - t_fit, kernel_launches=o_launches[phase],
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    plan_cache_gib=cache_gib(),
                    newton_syncs=_newton_minimize.syncs - syncs)
        if n_class > 2:
            info["cutpoints_last"] = cutpoint_checks(phase, pfm)
            info["mh_accepts"] = pfm.history_.n_mh_accept
        say(phase, json.dumps(info))
        say(phase.replace("fit", "predict"), json.dumps(probit_checks(
            phase.replace("fit", "predict"), pfm, X_te, blocks_te, yte_,
            ytr_, n_class)))
        del pfm
        torch.cuda.empty_cache()

    # ---- the libFM protocol: a callback scores the held-out rows ----
    libfm_launches = libfm_phases(torch, (X_tr, blocks_tr, y_tr),
                                  (X_te, blocks_te, y_te), grouping,
                                  sweeps_per_s)
    say("lcfit", f"so far {time.perf_counter() - t_start:.1f} s")

    # ---- the fit's surface: resume, and the harvest on the cached plan
    say("ckpt", json.dumps(ckpt_phase(torch, (X_tr, blocks_tr, y_tr),
                                      grouping)))
    torch.cuda.empty_cache()
    say("drain", json.dumps(drain_phase(
        torch, (X_tr, blocks_tr, y_tr), grouping)))
    clear_plan_cache()
    torch.cuda.empty_cache()

    # ---- rank 128 on the ML-10M design: kernel 1 in bf16 ----
    r128rows, r128_launches, r128_ieee_launches = r128_phases(
        torch, (X_tr, blocks_tr, y_tr), (X_te, blocks_te, y_te), grouping,
        timer, stamps)
    say("r128predict", f"so far {time.perf_counter() - t_start:.1f} s")

    # ---- the joint engine: ML-100k timeSVD++-flipped, rank 10 ----
    clear_plan_cache()
    torch.cuda.empty_cache()
    from myfm_tpu_torch.design import compile_design, joint_auto_eligible
    from myfm_tpu_torch.trainer import GibbsTrainer

    t0 = time.perf_counter()
    (jX_tr, jb_tr, jy_tr), (jX_te, jb_te, jy_te), jgroup = (
        build_joint_design()
    )
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    jplan = compile_design(
        jX_tr, jb_tr, grouping=np.asarray(jgroup, np.int32),
        dtype=np.float32, joint_dense=True, joint_rank=J_RANK,
        device="cuda",
    )
    t_plan = time.perf_counter() - t0
    if not joint_auto_eligible(jplan, J_RANK, np.float32):
        fail("the ML-100k plan is not eligible for the joint engine")
    tails = [
        None if b.dense_stack is None else
        (b.block_size, *b.dense_stack.xw.shape[:1],
         int(b.dense_stack.feat.shape[1]))
        for b in jplan.blocks
    ]
    heads = [len(b.dense_colors) for b in jplan.blocks]
    say("jdata", f"train {jy_tr.size} test {jy_te.size}, features "
                 f"{jplan.n_features}, groups {jplan.n_groups}; (B, C, Pf) "
                 f"of each block's tail {tails}, head colors {heads}; "
                 f"features {t_feat:.1f} s, plan {t_plan:.1f} s")

    jtrainer = GibbsTrainer(
        jplan, jy_tr, GibbsConfig(task="regression", joint_rows=True),
        J_RANK, 0.1, SEED,
    )
    if jtrainer.cfg.joint_tail_kernel is not True:
        fail("the joint trainer did not resolve to the tail kernel")
    jstate = jtrainer._initialize()
    jrows, jlrows = jkernel_phase(torch, jplan, jtrainer, jstate)
    for r in jrows:
        say("jkernel", json.dumps(r))
    for r in jlrows:
        say("jkernel", json.dumps(dict(lists=True, **r)))
    say("jsweep", json.dumps(jsweep_phase(torch, jplan, jtrainer, jstate)))
    del jplan, jtrainer, jstate
    torch.cuda.empty_cache()

    stamps.clear()
    torch.cuda.reset_peak_memory_stats()
    joint_tail.joint_tail_pass.launches = 0
    joint_tail.tail_lists.launches = 0
    t_fit = time.perf_counter()
    jfm = MyFMGibbsRegressor(
        rank=J_RANK, random_seed=SEED, device="cuda"
    ).fit(jX_tr, jy_tr, X_rel=jb_tr, n_iter=J_N_ITER, grouping=jgroup,
          callback=lambda i, *a: (timer(i, *a)[0] or i + 1 >= J_FIT_SWEEPS,
                                  None))
    torch.cuda.synchronize()
    t_fit_end = time.perf_counter()
    jlaunches = joint_tail.joint_tail_pass.launches
    jl_launches = joint_tail.tail_lists.launches
    jpeak = torch.cuda.max_memory_allocated()
    if jfm.history_.engine != "joint":
        fail(f"joint fit resolved to {jfm.history_.engine!r}, not 'joint'")
    if jlaunches <= 0 or jl_launches <= 0:
        fail("the joint path never launched joint_tail_pass's kernels "
             f"(chain {jlaunches}, lists {jl_launches})")
    ttfs = stamps[0] - t_fit
    sweeps_per_s = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    say("jfit", f"engine {jfm.history_.engine}, {len(stamps)} sweeps, "
                f"time to first sweep {ttfs:.2f} s, {sweeps_per_s:.3f} "
                f"sweeps/s, fit {t_fit_end - t_fit:.1f} s, tail kernel "
                f"launches {jlaunches}, peak device memory "
                f"{jpeak / 2**30:.3f} GiB (plan cache {cache_gib():.3f} GiB)")

    t0 = time.perf_counter()
    jpred = jfm.predict(jX_te, jb_te)
    t_pred = time.perf_counter() - t0
    jrmse = float(np.sqrt(np.mean((jpred - jy_te) ** 2)))
    jstd = float(jy_te.std())
    if not (jpred.shape == jy_te.shape and np.isfinite(jpred).all()
            and jrmse < jstd):
        fail(f"jpredict: rmse {jrmse} vs std(y_test) {jstd}")
    say("jpredict", f"{jy_te.size} held-out rows, {len(jfm.predictor_.samples)}"
                    f" samples in {t_pred:.2f} s, RMSE {jrmse:.4f} < "
                    f"std(y_test) {jstd:.4f}; so far "
                    f"{time.perf_counter() - t_start:.1f} s")

    # ---- ordered probit on the joint engine: ML-100k, rank 10 ----
    del jfm
    torch.cuda.empty_cache()
    jyo_tr = (np.asarray(jy_tr) - 1).astype(np.int64)
    jyo_te = (np.asarray(jy_te) - 1).astype(np.int64)
    stamps.clear()
    torch.cuda.reset_peak_memory_stats()
    joint_tail.joint_tail_pass.launches = 0
    syncs = _newton_minimize.syncs
    t_fit = time.perf_counter()
    jofm = MyFMOrderedProbit(
        rank=J_RANK, random_seed=SEED, sweep_strategy="joint", device="cuda"
    ).fit(jX_tr, jyo_tr, X_rel=jb_tr, n_iter=JO_N_ITER, grouping=jgroup,
          callback=timer)
    torch.cuda.synchronize()
    t_fit_end = time.perf_counter()
    jo_launches = joint_tail.joint_tail_pass.launches
    if jofm.history_.engine != "joint" or jo_launches <= 0:
        fail(f"jofit: engine {jofm.history_.engine!r}, tail kernel launches "
             f"{jo_launches}")
    ttfs, rate = fit_rates(stamps, t_fit)
    say("jofit", json.dumps(dict(
        engine=jofm.history_.engine, sweeps=len(stamps),
        time_to_first_sweep_s=ttfs, sweeps_per_s=rate,
        fit_s=t_fit_end - t_fit, tail_kernel_launches=jo_launches,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        plan_cache_gib=cache_gib(),
        newton_syncs=_newton_minimize.syncs - syncs,
        cutpoints_last=cutpoint_checks("jofit", jofm),
        mh_accepts=jofm.history_.n_mh_accept,
    )))
    say("jopredict", json.dumps(probit_checks(
        "jopredict", jofm, jX_te, jb_te, jyo_te, jyo_tr,
        int(jyo_tr.max()) + 1)))
    del jofm

    ea = ea_phases(torch, (jX_tr, jb_tr, jy_tr), (jX_te, jb_te, jy_te),
                   jgroup, timer, stamps)
    say("ea", f"so far {time.perf_counter() - t_start:.1f} s")

    # ---- VI: the same ML-100k design, entity+attribute fast path ----
    clear_plan_cache()
    torch.cuda.empty_cache()
    from myfm_tpu_torch import VariationalFMRegressor
    from myfm_tpu_torch.ops.variational import VariationalConfig
    from myfm_tpu_torch.variational import compile_vi_fast_plan
    from myfm_tpu_torch.vi_trainer import CategoricalVITrainer

    vgroup = np.asarray(jgroup, np.int32)
    t0 = time.perf_counter()
    # the estimators' own compile: the one-hot plan first, which this
    # design does not take, then the entity+attribute plan
    vplan = compile_vi_fast_plan(jX_tr, jb_tr, vgroup, np.float32, "cuda",
                                 V_RANK)
    t_vplan = time.perf_counter() - t0
    if vplan is None or not vplan.has_side:
        fail("vdata: no entity+attribute plan for the ML-100k design")
    vtiling = [(t.n_cols, t.n_tiles, t.tile_rows, t.tile_entities)
               for t in vplan.tables]
    vside = [tuple(si.stack_feat.shape) for si in vplan.side
             if si is not None]
    say("vdata", f"rows {vplan.n_rows}, features {vplan.n_features}; "
                 f"(B, K, T, S) per table {vtiling}; (C, Pf) per side "
                 f"table {vside}; plan {t_vplan:.2f} s")

    vtrainer = CategoricalVITrainer(vplan, jy_tr, VariationalConfig(),
                                    V_RANK, 0.1, SEED)
    vstate = vtrainer._initialize()
    vrows = vkernel_phase(torch, vplan, vtrainer, vstate)
    for r in vrows:
        say("vkernel", json.dumps(r))
    vplan64 = compile_vi_fast_plan(jX_tr, jb_tr, vgroup, np.float64, "cuda",
                                   V_RANK)
    say("vsweep", json.dumps(
        vsweep_phase(torch, vplan, vplan64, vtrainer, vstate)))
    # the classification task (rating >= 4 as ±1) from one sweep in, so
    # the kernels' target column carries latent means τ, not ±1
    vctrainer = CategoricalVITrainer(
        vplan, np.where(jy_tr >= 4, 1.0, -1.0),
        VariationalConfig(task="classification"), V_RANK, 0.1, SEED)
    vcstate = vctrainer._sweep(vctrainer._initialize())
    say("vcsweep", json.dumps(vsweep_phase(
        torch, vplan, vplan64, vctrainer, vcstate, phase="vcsweep",
        modes=("split",))))
    del vplan64, vctrainer, vcstate
    say("vsections", json.dumps(
        vsections_phase(torch, vplan, vtrainer, vstate)))
    del vplan, vtrainer, vstate
    torch.cuda.empty_cache()

    stamps.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_gram_counts(gram)
    t_fit = time.perf_counter()
    vfm = VariationalFMRegressor(
        rank=V_RANK, random_seed=SEED, device="cuda"
    ).fit(jX_tr, jy_tr, X_rel=jb_tr, n_iter=V_N_ITER, grouping=jgroup,
          callback=timer)
    torch.cuda.synchronize()
    t_fit_end = time.perf_counter()
    v_vi = gram.fused_tile_gram_cross.vi_launches
    v_meta = gram.fused_tile_gram.launches
    vpeak = torch.cuda.max_memory_allocated()
    if vfm.history_.engine != "fastpath":
        fail(f"VI fit resolved to {vfm.history_.engine!r}, not 'fastpath'")
    if v_vi <= 0 or v_meta <= 0:
        fail(f"the VI fit launched fused_tile_gram_cross[vi] {v_vi} and "
             f"fused_tile_gram {v_meta} times")
    v_modes = dict(
        vi=mode_check("vfit", vfm.history_,
                      gram.fused_tile_gram_cross.mode_launches["vi"],
                      "split"),
        meta=mode_check("vfit", vfm.history_,
                        gram.fused_tile_gram.mode_launches, "split"))
    elbos = np.asarray(vfm.history_.elbos, dtype=np.float64)
    drop = elbo_check("vfit", elbos)
    ttfs, rate = fit_rates(stamps, t_fit)
    say("vfit", f"engine {vfm.history_.engine}, Gram mode "
                f"{vfm.history_.gram_fast_matmul} (launches by mode "
                f"{v_modes}), {len(stamps)} sweeps, "
                f"time to first sweep {ttfs:.2f} s, {rate:.3f} sweeps/s, "
                f"fit {t_fit_end - t_fit:.1f} s, launches: "
                f"fused_tile_gram_cross[vi] {v_vi}, fused_tile_gram "
                f"{v_meta}; ELBO first {elbos[0]:.6e} last {elbos[-1]:.6e}"
                f", largest decrease {drop:.3e} (tolerance "
                f"{ELBO_DROP_TOL:.0e} of |ELBO|); peak device memory "
                f"{vpeak / 2**30:.3f} GiB (plan cache {cache_gib():.3f} GiB)")

    t0 = time.perf_counter()
    vpred = vfm.predict(jX_te, jb_te)
    t_pred = time.perf_counter() - t0
    vrmse = float(np.sqrt(np.mean((vpred - jy_te) ** 2)))
    if not (vpred.shape == jy_te.shape and np.isfinite(vpred).all()
            and vrmse < jstd):
        fail(f"vpredict: rmse {vrmse} vs std(y_test) {jstd}")
    say("vpredict", f"{jy_te.size} held-out rows in {t_pred:.2f} s, RMSE "
                    f"{vrmse:.4f} < std(y_test) {jstd:.4f}")
    del vfm
    torch.cuda.empty_cache()

    # ---- VI at the ML-10M shape (the fast-path design), rank 32 ----
    clear_plan_cache()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p10 = compile_vi_fast_plan(X_tr, blocks_tr,
                               np.asarray(grouping, np.int32), np.float32,
                               "cuda", V10M_RANK)
    if p10 is None or p10.has_side:
        fail("v10m: the ML-10M design did not compile to a one-hot VI plan")
    t_p10 = time.perf_counter() - t0
    tr10 = CategoricalVITrainer(p10, y_tr, VariationalConfig(), V10M_RANK,
                                0.1, SEED)
    st10 = tr10._initialize()
    k10 = vi_layout_rows(torch, p10, st10, tr10.y_tiles, V10M_RANK,
                         range(len(p10.tables)))
    # the classifier's launches of the same kernel, one sweep in (the
    # target column then holds the latent means τ)
    from myfm_tpu_torch.ops.categorical import make_y_tiles

    tr10c = CategoricalVITrainer(
        p10, np.where(y_tr >= 4, 1.0, -1.0),
        VariationalConfig(task="classification"), V10M_RANK, 0.1, SEED)
    st10c = tr10c._sweep(tr10c._initialize())
    kc10 = vi_layout_rows(torch, p10, st10c, make_y_tiles(p10, st10c.tau),
                          V10M_RANK, range(len(p10.tables)),
                          name="fused_tile_gram_cross[vic10m]")
    t10 = [(t.n_cols, t.n_tiles, t.tile_rows, t.tile_entities)
           for t in p10.tables]
    del p10, tr10, st10, tr10c, st10c
    torch.cuda.empty_cache()
    stamps.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_gram_counts(gram)
    t_fit = time.perf_counter()
    v10 = VariationalFMRegressor(
        rank=V10M_RANK, random_seed=SEED, device="cuda"
    ).fit(X_tr, y_tr, X_rel=blocks_tr, n_iter=V10M_N_ITER,
          grouping=grouping, callback=timer)
    torch.cuda.synchronize()
    v10_launches = gram.fused_tile_gram_cross.vi_launches
    v10_modes = mode_check("v10m", v10.history_,
                           gram.fused_tile_gram_cross.mode_launches["vi"],
                           "split")
    v10_peak = torch.cuda.max_memory_allocated()
    if v10.history_.engine != "fastpath" or v10_launches <= 0:
        fail(f"v10m: engine {v10.history_.engine!r}, VI-layout launches "
             f"{v10_launches}")
    ttfs, rate = fit_rates(stamps, t_fit)
    pred10 = v10.predict(X_te, blocks_te)
    rmse10 = float(np.sqrt(np.mean((pred10 - y_te) ** 2)))
    if not (np.isfinite(pred10).all() and rmse10 < std):
        fail(f"v10m: rmse {rmse10} vs std(y_test) {std}")
    say("v10m", json.dumps(dict(
        plan_tables=t10, plan_s=round(t_p10, 2), kernel=k10,
        sweeps=len(stamps), time_to_first_sweep_s=ttfs, sweeps_per_s=rate,
        vi_launches=v10_launches, gram_mode=v10.history_.gram_fast_matmul,
        launches_by_mode=v10_modes, peak_gib=v10_peak / 2**30,
        plan_cache_gib=cache_gib(),
        elbo_first=v10.history_.elbos[0], elbo_last=v10.history_.elbos[-1],
        rmse=rmse10, std_y_test=std,
        whole_run_s=time.perf_counter() - t_start,
    )))
    del v10
    torch.cuda.empty_cache()

    # ---- the VI classifier at the ML-10M shape, rank 32 ----
    vc10, vc10_launches = vcfit10m_phase(
        torch, (X_tr, blocks_tr, y_tr), (X_te, blocks_te, y_te), grouping,
        timer, stamps)
    vc10["kernel"] = kc10
    say("vcfit10m", json.dumps(vc10))

    # ---- row-space CAVI (the colored sweep) on the ML-100k design ----
    clear_plan_cache()
    torch.cuda.empty_cache()
    say("vrfit", json.dumps(vrfit_phase(
        torch, (jX_tr, jb_tr, jy_tr), (jX_te, jb_te, jy_te), vgroup,
        stamps)))
    say("vrfit", f"whole run so far {time.perf_counter() - t_start:.1f} s")

    # ---- the colored Gibbs engine on the ML-100k design, rank 10 ----
    say("gcsweep", json.dumps(gcsweep_phase(
        torch, (jX_tr, jb_tr, jy_tr), vgroup)))
    for phase, line in gibbs_colored_fits(
            torch, (jX_tr, jb_tr, jy_tr), (jX_te, jb_te, jy_te), vgroup,
            stamps).items():
        say(phase, json.dumps(line))
    say("gjvfit", f"whole run so far {time.perf_counter() - t_start:.1f} s")

    # ---- same-seed pairs on the row-space engines, default ops ----
    say("drain", json.dumps(dict(rowspace=rowspace_pairs(
        torch, (jX_tr, jb_tr, jy_tr), vgroup))))
    clear_plan_cache()
    torch.cuda.empty_cache()

    # ---- world size 2: two processes on the card over gloo ----
    s2 = run_phase("shard2", lambda: sharded.shard2("cuda:0"))
    say("shard2", json.dumps(s2))
    say("shard2", f"whole run so far {time.perf_counter() - t_start:.1f} s")
    def s2_launches(fit, kernel):
        return {f"shard2 {fit}": [r["launches"][kernel]
                                  for r in s2["fits"][fit]["ranks"]]}

    def entry(name, source, replaces, launches, rows, mode="highest",
              modes=None, sharded=None):
        """One kernel of the kernels line; ``rows`` are its phase rows,
        read in Gram mode ``mode`` (a row of another mode holds that
        mode's numbers under "modes"); ``modes`` its path's launches by
        mode."""
        rows = [r if r.get("mode", "highest") == mode else r["modes"][mode]
                for r in rows]
        lib = [r.get("library_ms") for r in rows]
        b = [r["bound_ms"] for r in rows]
        out = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["err_float32"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(b),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(lib),
            "mode": mode,
        }
        passes = sorted({r["pass"] for r in rows if "pass" in r})
        if passes:
            out["pass"] = "+".join(passes)
        if modes is not None:
            out["launches_by_mode"] = modes
        if sharded is not None:
            out["sharded_launches"] = sharded
        return out

    vi_rows = [r for r in vrows if r["kernel"] != "fused_tile_gram"]
    meta_rows = [r for r in vrows if r["kernel"] == "fused_tile_gram"]
    print(json.dumps({"kernels": [
        dict(entry("fused_tile_gram_cross", GRAM_SOURCE, GRAM_REPLACES,
                   launches, krows, "split", fit_modes,
                   {"shard1": [s1["kernel_launches"]["gram_gibbs"]]}),
             sharded_launches_by_mode={
                 "shard1": [s1["gram_launches_by_mode"]]},
             callback_launches=libfm_launches),
        entry("fused_tile_gram_cross[vi]", GRAM_SOURCE, GRAM_REPLACES, v_vi,
              vi_rows, "split", v_modes["vi"], s2_launches("vi", "gram_vi")),
        entry("fused_tile_gram", GRAM_SOURCE, META_REPLACES, v_meta,
              meta_rows, "split", v_modes["meta"],
              s2_launches("vi", "gram_meta")),
        entry("fused_tile_gram_cross[vi10m]", GRAM_SOURCE, GRAM_REPLACES,
              v10_launches, k10, "split", v10_modes),
        entry("fused_tile_gram_cross[vic10m]", GRAM_SOURCE, GRAM_REPLACES,
              vc10_launches, kc10, "split", vc10["launches_by_mode"]),
        entry("fused_tile_gram_cross[r128]", GRAM_SOURCE, GRAM_REPLACES,
              r128_launches, r128rows, "bf16",
              {"bf16": r128_launches}),
        entry("fused_tile_gram_cross[r128 highest]", GRAM_SOURCE,
              GRAM_REPLACES, r128_ieee_launches, r128rows, "highest",
              {"highest": r128_ieee_launches}),
        entry("joint_tail_pass", TAIL_SOURCE, TAIL_REPLACES, jlaunches,
              jrows, sharded=s2_launches("joint", "joint_tail")),
        entry("joint_tail_pass[lists]", TAIL_SOURCE, TAIL_REPLACES,
              jl_launches, jlrows),
        entry("fused_tile_gram_cross[ea]", GRAM_SOURCE, GRAM_REPLACES,
              ea[2], ea[0], "split", ea[4], s2_launches("ea", "gram_gibbs")),
        entry("joint_tail_pass[ea]", TAIL_SOURCE, TAIL_REPLACES, ea[3],
              ea[1], sharded=s2_launches("ea", "joint_tail")),
        entry("tile_gram", GRAM_SOURCE, ROWS_REPLACES, e_launches, erows),
    ] + [
        entry(f"gram_section[{r['level']}]" if r["mode"] == "highest"
              else f"gram_section[{r['level']} {r['mode']}]",
              SECTIONS_SOURCE, SECTIONS_REPLACES, r["launches"], [r],
              r["mode"])
        for r in sec["levels"]
    ] + [
        entry(f"interleave_probe[{r['variant']}]", SECTIONS_SOURCE,
              PROBE_REPLACES, r["launches"], [r])
        for r in sec["probe"]
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
