#!/usr/bin/env python3
"""
Drives the PyTorch/CUDA port (quanonet_torch) on one NVIDIA card and checks
it.  Run from the root of a checkout:

    python3 chip_smoke.py [--phases a,b,...]

Without arguments every phase below runs.  ``--phases`` runs only the
named ones (names as in PHASES), with device, build and the phases whose
results they take (PHASE_NEEDS); it prints no kernels line.

Phases, each printed as one JSON line:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
             versions; TF32 matmuls must be off (they shift the model's
             quality band).
2. build   — builds every kernel from csrc/ (torch.utils.cpp_extension
             .load, nvcc for sm_90a), the sources in parallel, and reports
             the build times.
3. kernel  — each kernel against its plain PyTorch version on the card at
             the shapes the served path gives it (random seeded weights):
             the flagship Q5 Net40-2-20-2 at N in {1, 7, 100, 1000, 8192},
             Q2 Net5-1-5-1, Q7 (D = 128), and the other widths.  Max abs
             error on the amplitudes (<= 2e-5) and the expectation
             (<= 1e-4); median times over CUDA events; the bound from the
             H100 SXM datasheet (67 TFLOP/s fp32, 3.35 TB/s); the launch
             geometry (cuda_hea.chain_geometry), and at the flagship's
             N = 100 and 8192 the time on the card alone (device_ms).
4. serve   — the served path: the shipped Advection anchor through
             infer.load_model -> serve.Predictor -> HTTP on `cuda`.  Warms
             every bucket, answers requests of 1, 37, 1000 and 9000 rows,
             one POST /predict over loopback; checks against the JAX
             package's predictions (tests/fixtures/
             torch_port_advection_anchor.npz, atol 1e-4) and the plain
             engine, and that the chain kernel and the compile kernel B4f
             (the default route on `cuda`) were launched.  Then,
             outside that counted window, where the time of the smallest
             and largest bucket goes (request, forward, chain operands,
             kernel).
5. kernel_bwd — the residual-saving forward kernel and the backward
             kernels against chain_dense_saved / chain_backward_dense on
             the card: the flagship at N in {100, 1000, 8192}, Q2
             Net5-1-5-1 and Q7 Net40-2-20-2 at N = 1000.  Max abs error of
             Mbar and phibar (<= 1e-4 x max(1, max|plain|)), bit-equality
             of two backward calls, median times, the bound, the launch
             geometry and Mbar slices, and at the flagship's N = 100 and
             8192 the time on the card alone of all the backward's launches
             and of the residual forward.
6. train_parity — 20 Adam steps of the flagship on `cuda` from one
             initial state on the default path (the compile kernels),
             engine 'pallas' (the kernels) against
             'dense' (autograd of the plain chain), on the same batches:
             per-step losses to 1e-4 relative, parameters to
             PARITY_PARAM_TOL; B4f and B4b launched once a step.
7. train   — the training path: the quick regime of the port's bench
             (python -m quanonet_torch.bench --quick) for seeds 0, 1,
             each seed's rel-L2 held to the band fixed from the JAX
             package's CPU run (QUICK_BAND_REL_L2), then one epoch of the
             training CLI at flagship width into a temporary --prefix,
             whose best_model.ckpt infer.load_model must reproduce; both
             chain kernels, B4f and B4b must have been launched (B5, the
             opt-in Adam, not).  Then, outside that counted
             window, where one training step's time goes at batch 100
             (train_breakdown: host clock, CUDA events, a torch.profiler
             window for the device's busy share).
8. kernel_fused — the fused-group chain kernels (csrc/fused_chain.cu,
             8..16 qubits, taking the angles x): the forward, primal and
             residual, against fused_gates.chain_fused_x /
             chain_fused_saved_x at Q10 Net40-2-20-2 (N = 1, 100, 8192),
             Q8, Q9 (ragged), encode-only blocks, Q11-13 Net10-2-10-2, Q14
             and, forward only, Q15-16 Net5-2-5-2: amplitude and
             expectation errors, median times and the time on the card
             alone, the bounds (fused_bound at the fp32 peak,
             fused_tc_bound with the products on the tensor cores), and at
             Q10 the whole forward beside the grouped-kron engine 'fused'.
9. kernel_fused_bwd — the backward against chain_fused_backward_x at the
             same cases up to Q14 (1e-4 x max(1, max|plain|), two calls
             bit-equal), its time on the card alone in all and by launch,
             and the U7bar launch's yardstick, one torch.bmm on complex64
             of its shapes (u7bar_library_ms).
10. train_parity_q10 — 20 Adam steps at Q10 Net40-2-20-2, batch 100,
             'pfused' against autograd of 'fused'.
11. train_q10 — one epoch of the training CLI at Q10 ('auto' -> 'pfused'),
             its checkpoint reproduced by infer.load_model, both fused
             counters up; then train_breakdown_q10.
12. serve_q10 — a Q10 checkpoint of seeded weights
             (tests/fixtures/torch_port_q10_fused.npz) through Predictor
             and HTTP on `cuda`: requests of 1, 37, 1000 rows against the
             'fused' engine, the fixture's 64 rows against the JAX
             package's predictions (atol 1e-4).

13. kernel_ucomp — the block-matrix compile kernels (csrc/ucomp.cu,
             from the weights) against ucomp_weights_dense /
             ucomp_weights_backward_dense at the flagship (nb 60, ld 2,
             D 32), Q2 ld 1, Q3 ld 3, HEAQNN Q4, Q6 and Q7 Net40-2-20-2
             (D = 128) and a single block: forward to 2e-5 (and to the
             autograd fold), w̄ to 1e-4 x max(1, max|plain|), two backward
             calls bit-equal, median times, time on the card alone, the
             bound of the gate form and the matrix form's flops
             (ucomp_counts), the launch geometry, what the smallest launch
             costs, and at the flagship the compile path against the
             autograd fold it replaces (hea.fold_block_mats): host ms and
             device rows of each (compile_path).  Then kernel_ucomp_shift:
             B4f at the stacks the shift rule compiles
             (param_shift.shifted_block_weights; every inner shifted set
             of a step in one launch with last = -1, unchunked at the
             flagship and at Q7, and one --ps_chunk 64 chunk) against
             ucomp_weights_dense to 2e-5, and single sets, inner and
             final, against the autograd fold of the shifted weights.
             Then kernel_ucomp_packed: B4f and B4b at the stacks the
             packed multi-seed step compiles at the flagship for 4 seeds
             (the 236 inner blocks with last = -1, the 4 final blocks
             with EVERY_BLOCK) against ucomp_weights_dense and
             ucomp_weights_backward_dense at the limits above, and the
             joined stack and its w̄ against each seed's own compile.
14. kernel_adam — the one-launch Adam (csrc/adam.cu) through FusedAdam,
             its rates from the card's table, against adam_step_dense on
             the flagship's six leaves over 25 steps (atol 2e-6, rtol
             1e-5), two runs bit-equal, the device count 25 after; one
             step's events, host and card ms and bound, and
             torch.optim.Adam(fused=True) as the yardstick.
15. train_parity_ucomp — 20 Adam steps of the flagship with the compile
             kernels and FusedAdam (its rate table from the schedule)
             against train_parity's default run on the same batches; the
             compile kernels and B5 launched once a step.  Then
             train_parity_fold: the same on the fold with torch.optim.Adam
             (the route before the compile kernels), no compile or Adam
             kernel launched.
16. profile_step — quanonet_torch.profile_step.main at full width on
             `cuda`, twice: the fold (USE_UCOMP off; the compile and Adam
             kernels must stay unlaunched), then USE_UCOMP on with
             --fused_adam (B1f, B1b, B4f, B4b and B5 all launched).  Then,
             outside the counted windows, step_arms: the step at batch 100
             in five arms interleaved in one process (fold, +ucomp, +fused
             Adam, both, and the default: USE_UCOMP unset with the
             solver's optimizer, at most half the fold's step; both must
             beat ucomp in every round before FusedAdam may become the
             solver's adam): step_ms, device rows a step and the card's
             busy share.
17. serve_ucomp — the Advection anchor through load_model -> Predictor ->
             HTTP with USE_UCOMP on: the JAX fixture within 1e-4, the
             compile kernel's count up; then buckets 1 and 8192 with the
             compile kernels and with the fold, in turns.

18. kernel_embed — the real-embedding chain kernels (csrc/embed_chain.cu):
             the forward, primal and residual, against chain_embed /
             chain_embed_saved on random general E and t at the shapes of
             Q1 .. Q7 models, the flagship (nb 60, d 32) at N in {1, 37,
             100, 1000, 1025, 8192}: amplitudes (<= 2e-5), expectation
             (<= 1e-4), the residual u (<= 2e-5), median times, time on the
             card alone, the bound (embed_bound), the launch geometry
             (cuda_embed.embed_geometry) and Ebar's slices.
19. kernel_embed_bwd — the backward against chain_embed_backward at the
             same cases (1e-4 x max(1, max|plain|), two calls bit-equal).
20. train_parity_embed — 20 Adam steps of the flagship with engine
             'embed': the kernels against autograd of the plain chain and
             against train_parity's 'pallas' run, on the same batches.
21. train_embed — the quick regime through --engine embed for seeds 0 and
             1 (each within QUICK_BAND_REL_L2), then one CLI epoch with
             --engine embed whose checkpoint infer.load_model reproduces;
             both embed kernels launched, the block-chain kernels not.
22. serve_embed — the Advection anchor through load_model -> Predictor ->
             HTTP with engine='embed' against the JAX fixture (atol 1e-4);
             then buckets 1 and 8192 in turns with 'pallas'.
23. embed_vs_pallas — the flagship's step at batch 100, the two engines
             in turns in one process: step ms, device rows a step, the
             card's busy share and each chain kernel's card ms inside the
             step.  (profile_step, phase 16, times 'embed' among its
             engines.)
24. classical — FNN, DeepONet and FNO each take a few epochs through the
             training CLI on the card (loss finite and falling, parameters
             on `cuda`); the DeepONet checkpoint is served through
             Predictor, whose prediction equals infer.predict's.  No
             hand-written kernel runs here: these models are plain matrix
             products.

25. train_shift, train_spsa — QPU emulation: three steps each of the
             training CLI at the flagship's width, --grad_method shift, and
             --grad_method spsa --train_shots 1000: loss finite, the run ID's
             suffix, the checkpoint predicting in infer; B1b, B4b and B2b
             launched 0 times, B1f and B4f the counted number
             (shift_launches).  Then qpu_steps: ms a step by CUDA events,
             evaluations a step and the card's busy share of autograd, the
             shift rule exact and with shots, and SPSA with shots.
26. serve_shots, serve_shots_q10 — the anchor (B4f, B1f) and the seeded
             Q10 checkpoint (B2f) through Predictor at 10,000 shots, bucket
             100, 64 replays with distinct seeds: each row's |mean − exact|
             / (shot_noise_std / 8) <= 5, one shot_seed replays bit-equal,
             the bucket's latency against the exact path in turns.
27. shift_grad — the flagship's shift-rule gradient of every parameter on
             the card, batch 100, against autograd's through B4b/B1b on the
             same batch: within 1e-3 x max(1, max|g|), and each leaf within
             1e-3 x its own max|g| (max and median |g| a leaf reported);
             the launches counted.  A negative control plants the wrong
             compile of the final block's shifted sets (the Hadamard as if
             inner) and must fail the leaf check.  The same at Q7
             Net40-2-20-2 (B1f at 84,000 rows); the peak memory of each
             backward, shift and autograd.
28. multiseed — the sequential route of --multi_seed 0 1 in the quick
             regime cut to MULTISEED_EPOCHS (multiseed.
             train_seeds_sequential): each seed's
             metric.json equals its single CLI run's (but the wall-clock
             rate), and the rerun skips both.
29. infer_from_name — the Advection anchor scored by the infer CLI with
             no --data: the test set generated from its directory's name;
             its rel-L2 within INFER_NAME_BAND.

30. compare_engines — the port's cross-engine gate
             (quanonet_torch/compare_engines.py) on `cuda`: every check
             passes, Q14 included; each check's name and the count.
31. kernel_noise — the noise trajectories' fold route at the flagship, N
             = 100 and 20,000: X, Y and Z on every qubit of the first, an
             inner and the last block and one random pattern, each
             trajectory's folded matrices through B1f against the
             physical-frame forward (noise.plain_states) and against the
             plain chain (amplitudes 2e-5, expectation 1e-4), the
             gradients through B1b/B4b against plain autograd at N = 100
             (1e-4 x max(1, max|plain|)), two calls bit-equal; a Pauli
             folded on the wrong side of U_b must fail the amplitude
             limit; the 32 trajectories of a noisy forward on both routes.
32. noise_paths — the anchor's noisy forward at bucket 100 (32
             trajectories, B4f once, B1f a trajectory), its ZNE with
             scales (1, 2), a damping case (the plain route, no kernel)
             and 20 noise-aware training steps of the flagship at batch
             100 with 8 trajectories at p = 0.001 (B1f and B1b a
             trajectory, B4f and B4b a step, the loss falling): the route
             counter and launches
             of each, the noisy forward and ZNE replayed bit-equal, then
             CUDA-event ms, device rows and the busy share.
33. infer_noise — the anchor scored from its name three ways (exact,
             --noise_p 0.01 --noise_traj 32, and --zne 1 2 on it): the
             three rel-L2s, a record; then tests/test_mitigation.py's Q2
             prediction case on the card (noise 0.1, 256 trajectories,
             scales (1, 2)): ZNE must land nearer the ideal.
34. multiseed_packed — --multi_seed 0 1 2 3 in the quick regime (cut to
             MULTISEED_EPOCHS) through the CLI on `cuda`, the packed
             route: each seed against its single run (losses 1e-4 relative, rel-L2 1e-3 relative,
             best_model.npz 5e-4), the rerun skipping every seed, B4f and
             B4b 2 launches a step for all seeds, B1f and B1b one a seed
             and step; then --multi_seed 0 1 at Q10 Net40-2-20-2 for one
             epoch of 2 batches (B2f, B2b a seed and step) and FNN,
             DeepONet, FNO packed (no kernel), with the same checks.
35. seedpack — profile_seedpack at S = 1, 2, 4, 8, 25 steps an arm, the
             packed and the sequential arms in turns: samples/s, ms a
             step, device rows and busy share; the packed losses finite
             and falling (no limit on speed); each arm's launches in one
             step (packed: B4f, B4b 2, B1f, B1b S; sequential: S each).
36. datagen_device — Advection at the flagship's size generated on the
             card through DataManager (time, peak memory, the host
             generator's time, the _dgdevice name), two CLI epochs of the
             flagship from it (finite, falling), each solver against its
             CPU run on equal inputs (1e-5; Darcy's CG 1e-4), Darcy and
             RDiffusion at their default sizes and RDiffusion at num_cal
             1000, timed.
37. datagen_native — the C++ library built from native/ (build time),
             Antideriv and Advection through --datagen native (the
             _dgnative and _rk4 / _native names), the solvers against
             SciPy's RK45 (5e-3) and the host stencils (1e-4).
38. ibm_export — python -m quanonet_torch.ibm_inference --simulator_only
             on `cuda` and on the CPU (QASM byte-equal, the manifest equal
             but its two shot-stream numbers), the gate replay against the
             engine (1e-4), ideal_predictions on the Advection anchor at
             full width against infer.predict and the replay of 3 points
             (1e-4), noisy_predictions at p = 0.01, 32 trajectories on both
             anchors (the fold route, replayed bit-equal).
39. multichip_ranks — the multi-GPU checks on ranks started by
             parallel/launch: world 1 on NCCL, worlds 2 and 4 as ranks
             sharing the one card over gloo (which checks the code path and
             measures nothing of scaling); one start a world, its seconds.
40. multichip_dp — the flagship data-parallel at batch 100 under Adam on
             the quick regime's rows: world 1, 50 make_dp_run_segment steps
             against the single-process make_train_epoch on the same orders
             (epoch losses 1e-5 relative; B4f, B4b, B1f, B1b once a step);
             one make_dp_train_step step on a fixed 100-row batch at world
             2 against world 1's (1e-6); 20 world-2 segment steps leaving
             the ranks bit-identical; ms a make_dp_run_segment step at
             each world size, and at world 1 the single-process step's in
             the same rank, in turns.
41. multichip_amp — the amplitude-sharded engine at Q12 Net40-2-20-2,
             batch 100, worlds 1, 2, 4 against the unsharded 'pfused'
             engine (B2f, B2b): outputs 1e-4, the weight gradient 1e-3 ×
             max(1, max|g|); the forward's exchanges equal
             sharded_collective_counts; one shard's forward under
             virtual_global k = 1, 2, 3 from bench_amplitude's rows.
42. multichip_pipe — the pipelined engine on the flagship's 60 blocks, 4
             microbatches at batch 100, worlds 1, 2, 4 against the
             unsharded block-chain engine, the same limits; one B4f launch
             a stage a forward, one B4b a backward, M + P - 1 hops.
43. multichip_cli — the Solver's data-parallel route through the CLI at
             the flagship on the quick regime's rows: --num_devices 2
             --share_device true (two ranks sharing the card) at batch =
             the 20,000 training rows against --num_devices 1 (the plain
             single-process path), 5 epochs: losses and rel-L2 1e-5
             relative, each rank's B4f, B4b, B1f, B1b in train, only rank
             0's artifacts, the caller's model holding the trained
             parameters; the quick regime at batch 100 on the two ranks
             (rel-L2 in the band, 2,000 steps a rank); --shard pipe
             --num_devices 1 at the flagship (3 steps: B4f, no chain
             kernel); --num_devices 2 without --share_device, which must
             fail naming the card count.
44. bench_amplitude — quanonet_torch.bench_amplitude (after
             multichip_ranks): the Q12 Net4-2-4-2 sharded forward against
             'pfused' (1e-4) and the Q16/Q18/Q20 capacity forwards at world
             1 (NCCL) and world 2 (ranks sharing the card; run in
             multichip_runs' start of each world), each row's
             exchanges the counted model's; one shard's forward under
             virtual_global at the JAX script's four cases (k = 3) and Q12
             Net40-2-20-2 batch 100 at k = 1, 2, 3, in turns with 'pfused':
             finite, local state 2^(n-k); ms, busy share, peak memory.
45. profile_q10 — quanonet_torch.profile_q10 at Q10 Net40-2-20-2, batch
             100, PROFILE_Q10_ITERS calls a component: the 'pfused' step's
             components and the 'fused' ablations (ms, device rows, busy
             share, launches); full_step the Solver's step bit for bit over
             5 steps, fwd_full bit-equal to forward_fused, every ablation
             finite, B2f/B2b a call as counted.
46. bench_serve — quanonet_torch.bench_serve on the Advection anchor (Q5)
             and the seeded Q10 checkpoint, buckets 1 … 8192: median
             latency, rows/s, peak memory a bucket, HTTP overhead at 64;
             every timed request and the HTTP answer equal
             Predictor.predict bit for bit.
47. bench_suite — quanonet_torch.bench_suite --quick: the JAX suite's four
             lines on the port, values and rel-L2 finite, the Q5 Advection
             rel-L2 below 1.0; the default route's kernels launched.
48. studies — the noise-robustness study (depolarizing) and the
             hardware-training study's --quick arms (autodiff, shift, SPSA),
             both at 3 epochs (JAX: 300 and --quick's 30;
             quanonet_torch/studies/) on the card: each CSV in the JAX
             script's columns and rows, every rel-L2 finite, the verdict
             lines printed, shift within 10 % of autodiff; each training
             arm's launches by its route (fold: B1f, B1b a trajectory, B4f,
             B4b a step; shift: B1f, B4f as param_shift fans out; SPSA: two
             forwards a step; no backward kernel on either).
49. sweeps — quanonet_torch.sweeps: every sweep's --dry_run plan counted
             against the shell scripts' (SWEEP_COUNTS); circuit's first Q5
             and Q10 regimes cut to 2 epochs, 100 functions, seeds 0 and 1
             through the driver's subprocess runner (metric.json a seed,
             collect_results), their launches through cli.main in this
             process (Q5 B1f/B1b/B4f/B4b, Q10 B2f/B2b, packed), and a rerun
             that resume-skips and launches nothing.
50. bf16_modes — the opt-in bf16 operand modes (UCOMP_BF16: the compile's
             product form, B4f-bf16 and B4b-bf16 in csrc/ucomp.cu;
             PFUSED_BF16: the fused chain's three low products, the kBf16
             variants of B2f and B2b): each kernel against its bf16 twin
             (ucomp_dense / ucomp_backward_dense and chain_fused* with
             bf16=True; B4 at the flagship and Q7, B2 at Q10 N = 100 and
             1000 on the chain's first BF16_PREFIX_BLOCKS blocks) within
             3e-2 x max(1, max|twin|) and an RMS of at most half the twin's
             own deviation from fp32; B2's 60-block chain deviating from
             fp32 as much as its twin does (BF16_DEV_BAND); the times,
             bounds at the bf16 peak and bf16 torch.bmm yardsticks; then
             the flagship under UCOMP_BF16 and Q10 under PFUSED_BF16 through
             the entry points (the training CLI, 3 epochs at Q5 and
             train_q10's epoch at Q10, and Predictor's requests), their
             launches (the bf16 kernels, not the fp32 ones), rel-L2 (within
             5 % of fp32's) and ms a step against the fp32 default in one
             process, the served rows against the twin's (Q5) or deviating
             from fp32 as the twin's do (Q10); QON_UNPIN_EXPECT's deviation
             at the flagship.  Every other phase runs with the three modes
             off (modes_off).
51. bench_regimes — the port's bench beyond the reference regime: the
             throughput regime (--regime throughput: batch 1000, cosine
             peak 1e-2) at full width and data, 100 epochs, one seed, with
             --anchor_crossing: best-epoch rel-L2 under the in-run anchor
             (the JAX package's outcome for this regime), epochs_to_anchor
             the first boundary of its own trajectory under the anchor,
             B4f, B4b, B1f and B1b once a step and B1f, B4f once an
             evaluated chunk; --quick --datagen device on 'pallas' (the
             _dgdevice cache, finite) with --precision unset and default in
             turns: rel_l2_runs bit-equal (the kernels and the pinned sums
             do not read the setting), the process's setting and TF32 off
             restored.
52. ood — the OOD study of visualization.ipynb (quanonet_torch.ood): both
             shipped anchors fed sin 2πx and sin 4πx through load_model /
             predict at batch 4096 on the card, against the JAX package's
             predictions (tests/fixtures/torch_port_ood.npz, atol 1e-4);
             the rel-L2s a record; one B4f and B1f a chunk.
53. entry — quanonet_torch.entry.entry() (the twin of
             __graft_entry__.entry): the flagship forward at batch 8 on the
             card against the CPU plain path (1e-4), one B4f and one B1f.
The kernel phase (3) also holds B1f at N = 60,000 and, at Q7, 84,000: the
rows of the shift rule's encode-shift batch at the flagship and at Q7.

Each path (serve, train, train_q10, serve_q10, profile_step, serve_ucomp,
train_embed, serve_embed, train_shift, train_spsa, serve_shots,
serve_shots_q10, shift_grad, multiseed, infer_from_name, noise_forward,
noise_zne, noise_damping, noise_train, infer_noise, multiseed_packed,
multiseed_packed_q10, seedpack, datagen_device, ibm_export,
bench_amplitude, multichip_dp, multichip_amp, multichip_pipe,
multichip_cli, profile_q10, bench_serve, bench_suite, studies_noise,
studies_hardware, sweeps_circuit_q5, sweeps_circuit_q10, bf16_q5, bf16_q10,
bench_throughput, bench_datagen, bench_precision, ood, entry)
starts with every launch
count at 0 and reads them when it ends; a multichip path adds the ranks'
own counts, read in each rank around the driven window.  A card time
("device_ms") comes from a warmed profiler
window (each kernel's mean over the rows it kept), else from the launches
queued back to back behind a sleep (kernel_device_ms); the run's count of
each source is the device_time_sources line.  Then the {"phase_seconds":
{...}} line (each phase's wall seconds), the {"kernels": [...]} line, the
nvidia-smi line, and last {"ok": true, "device": {...}}.  Any failed
check exits non-zero before the last line.  Needs one card; exits 1
without CUDA.
"""
import argparse
import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
import shlex
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.utils import cpp_extension

from quanonet_torch import (
    bench, bench_amplitude, bench_serve, bench_suite, cli, ibm_export,
    ibm_inference, multiseed, ood, profile_q10, profile_seedpack,
    profile_step, sweeps, time_chain,
)
from quanonet_torch import entry as entry_mod
from quanonet_torch import tracing
from quanonet_torch.config import (
    get_base_parser, load_config, set_random_seed,
)
from quanonet_torch.data import device_gen, generation, native
from quanonet_torch.data.manager import DataManager
from quanonet_torch.infer import load_model, predict
from quanonet_torch.infer import main as infer_main
from quanonet_torch.models import QuanONet
from quanonet_torch import checkpoint as ckpt_io
from quanonet_torch.convert import raw_from_state_dict
from quanonet_torch.ops import (
    _build, cuda_adam, cuda_embed, cuda_fused, cuda_hea, cuda_ucomp,
    fused_gates, hea, noise, param_shift,
)
from quanonet_torch.ops.hamiltonian import simple_ham_diag
from quanonet_torch.profile_step import (
    launch_counts as _counts, profile_steps,
)
from quanonet_torch.serve import Predictor, make_server
from quanonet_torch.studies import _common as studies_common
from quanonet_torch.studies import hardware_training, noise_robustness
from quanonet_torch.solver import (
    ScheduledOptimizer, _decay_tuple_schedule, epoch_permutation,
    build_optimizer, make_run_segment, make_train_epoch,
)

REPO = os.path.dirname(os.path.abspath(__file__))
ANCHOR = os.path.join(
    REPO, 'pretrained_weights', 'Advection',
    'Advection_QuanONet_Net40-2-20-2_Q5_TF_S0.1_1000x100_Seed0',
    'best_model.ckpt')
FIXTURE = os.path.join(REPO, 'tests', 'fixtures',
                       'torch_port_advection_anchor.npz')

# H100 SXM datasheet peaks at its full 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

AMP_TOL = 2e-5       # fp32 chain of up to 60 block products, other order
EXPECT_TOL = 1e-4
SERVE_TOL = 1e-4

KERNEL_CASES = [     # (label, qubits, net_size, batch rows N)
    *[('Q5 Net40-2-20-2', 5, (40, 2, 20, 2), n)
      for n in (1, 7, 100, 1000, 8192)],
    # the shift rule's encode-shift batch at the flagship: 2·n_x·N rows
    ('Q5 Net40-2-20-2', 5, (40, 2, 20, 2), 60000),
    ('Q2 Net5-1-5-1', 2, (5, 1, 5, 1), 1000),
    ('Q7 Net40-2-20-2', 7, (40, 2, 20, 2), 1000),
    ('Q7 Net40-2-20-2', 7, (40, 2, 20, 2), 84000),
    ('Q1 Net2-1-2-1', 1, (2, 1, 2, 1), 37),
    ('Q3 Net4-2-3-1', 3, (4, 2, 3, 1), 37),
    ('Q4 Net10-2-5-2', 4, (10, 2, 5, 2), 37),
    ('Q6 Net10-2-5-2', 6, (10, 2, 5, 2), 37),
]
SERVE_REQUESTS = (1, 37, 1000, 9000)
# (qubits, N) of the flagship where the chain kernels are also timed on the
# card alone (kernel_device_ms): the training batch and the largest bucket
FLAGSHIP_DEVICE_CASES = ((5, 100), (5, 8192))

BWD_CASES = [        # (label, qubits, net_size, batch rows N)
    *[('Q5 Net40-2-20-2', 5, (40, 2, 20, 2), n) for n in (100, 1000, 8192)],
    ('Q2 Net5-1-5-1', 2, (5, 1, 5, 1), 1000),
    ('Q7 Net40-2-20-2', 7, (40, 2, 20, 2), 1000),
]
# Mbar sums N rows of products and phibar runs back through 60 blocks, in
# another order than the plain version: a relative fp32 limit, scaled by
# the largest plain value (at least 1)
BWD_REL_TOL = 1e-4
PARITY_STEPS = 20
PARITY_LOSS_RTOL = 1e-4
# After 20 Adam steps at lr <= 3e-3 each parameter has moved by at most
# ~0.06; gradients that differ in the last bits (another summation order)
# move it by a small share of one step.  A sixth of one step's size:
PARITY_PARAM_TOL = 5e-4
# The quick regime's band (PERF.md, "quality band"): the JAX package's
# own `python bench.py --cpu --quick --runs 3` on the CPU gave rel-L2
# 0.3337 / 0.3436 / 0.3365; every seed of the port must stay within 1.25x
# the worst of them.
JAX_QUICK_REL_L2 = (0.3337, 0.3436, 0.3365)
QUICK_BAND_REL_L2 = 1.25 * max(JAX_QUICK_REL_L2)
QUICK_SEEDS = 2      # the seeds of train and train_embed
CLI_PRED_TOL = 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps):
    """Median device time of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def chain_bound(nb, n, d):
    """Least time (ms) the card needs for the chain, the larger of two
    times.  Operations at the fp32 peak: each block's product s . M_b^T in
    the three-product (Karatsuba) form of the TPU kernel, 3 real products
    (6 flops per complex MAC) plus its additions (4 per amplitude, and
    Mr + Mi once per block), and the phase products (6 flops per amplitude
    and block; the sincos is not counted).  Bytes at the HBM rate: each
    input read once and each output written once."""
    flops = (nb * n * (6.0 * d * d + 4.0 * d) + nb * d * d
             + 6.0 * (nb - 1) * n * d)
    nbytes = 4.0 * (2 * nb * d * d + nb * n * d + 2 * n * d)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def bwd_bound(nb, n, d):
    """Least time (ms) the card needs for the chain's backward, the larger
    of two times.  Operations at the fp32 peak: per block the two products
    Mbar = conj(s)^T . ubar and sbar = ubar . conj(M^T)^T in the
    three-product form, 6 flops per complex MAC each, plus that form's
    additions (3 per output element and the input sums) and the
    elementwise phase work (15 flops per amplitude; the sincos is not
    counted).  Bytes at the HBM rate: the inputs mt, phi, states and g
    read once, the outputs Mbar and phibar written once."""
    flops = nb * (12.0 * n * d * d + 21.0 * n * d + 4.0 * d * d)
    nbytes = 4.0 * (4 * nb * d * d + 4 * nb * n * d + 2 * n * d)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def phase_device():
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    check(torch.get_float32_matmul_precision() == 'highest',
          "float32 matmul precision must be 'highest'")
    emit({"phase": "device", "nvidia_smi": smi_line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False,
          "cuda_home": cpp_extension.CUDA_HOME,
          "ninja": shutil.which('ninja')})
    return smi_line


def phase_build():
    """Every kernel source, one nvcc each, all started together."""
    names = (cuda_hea.KERNEL, cuda_fused.KERNEL, cuda_ucomp.KERNEL,
             cuda_adam.KERNEL, cuda_embed.KERNEL)
    t0 = time.time()

    def build(name):
        t = time.time()
        return name, _build.build(name), time.time() - t
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    emit({"phase": "build", "seconds": time.time() - t0,
          "kernels": {name: {"library": os.path.relpath(lib, REPO),
                             "seconds": sec} for name, lib, sec in built}})


def phase_kernel():
    """Kernel vs plain at every case; returns the per-case records."""
    dev = torch.device('cuda')
    records = []
    for label, nq, net, n in KERNEL_CASES:
        spec = hea.quanonet_spec(nq, net)
        rng = np.random.RandomState(1000 * nq + n)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        x = torch.tensor(rng.uniform(-4, 4, (n, spec.total_encode))
                         .astype(np.float32), device=dev)
        ops = hea.prepare_chain(spec, w, x)
        kr, ki = cuda_hea.block_chain(*ops)
        pr, pi = hea.chain_dense(*ops)
        torch.cuda.synchronize()
        diag = torch.as_tensor(simple_ham_diag(nq, -5, 5), device=dev)
        err_amp = max((kr - pr).abs().max().item(),
                      (ki - pi).abs().max().item())
        err_exp = (hea.diag_expectation_pair(kr, ki, diag)
                   - hea.diag_expectation_pair(pr, pi, diag)
                   ).abs().max().item()
        finite = bool(torch.isfinite(kr).all() and torch.isfinite(ki).all())
        reps = 20 if n >= 1000 else 50
        ms = time_ms(lambda: cuda_hea.block_chain(*ops), reps)
        plain_ms = time_ms(lambda: hea.chain_dense(*ops), 5)
        bound_ms, bound_by, flops, nbytes = chain_bound(spec.n_blocks, n,
                                                        spec.dim)
        rec = {"phase": "kernel", "case": label, "nq": nq,
               "nb": spec.n_blocks, "N": n, "D": spec.dim,
               "geometry": _chain_geometry(spec.n_blocks, n, spec.dim),
               "max_abs_err_amp": err_amp, "max_abs_err_expect": err_exp,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "share_of_bound": bound_ms / ms}
        if (nq, n) in FLAGSHIP_DEVICE_CASES:
            rec["device_ms"] = kernel_device_ms(
                lambda: cuda_hea.block_chain(*ops), 'hea_chain_fwd')
        emit(rec)
        check(finite, f"{label} N={n}: kernel output not finite")
        check(err_amp <= AMP_TOL,
              f"{label} N={n}: amplitude error {err_amp} > {AMP_TOL}")
        check(err_exp <= EXPECT_TOL,
              f"{label} N={n}: expectation error {err_exp} > {EXPECT_TOL}")
        records.append(rec)
    return records


def _post(port, path, payload):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _http_predict(pred, branch, trunk):
    """One POST /predict over loopback to a server around ``pred``; ->
    (status, response, whether the server's thread has stopped)."""
    srv = make_server(pred, host='127.0.0.1', port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        code, resp = _post(srv.server_port, '/predict',
                           {"branch": branch.tolist(),
                            "trunk": trunk.tolist()})
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    return code, resp, not thread.is_alive()


def phase_serve():
    """The served path on the card; returns the kernel launches it made."""
    fixture = np.load(FIXTURE)
    fb, ft, fpred = fixture['branch'], fixture['trunk'], fixture['pred']
    ref_model, ref_cfg = load_model(ANCHOR, 100, 2, device='cuda',
                                    engine='dense')
    rng = np.random.RandomState(7)
    reqs = [(rng.randn(n, 100).astype(np.float32),
             rng.rand(n, 2).astype(np.float32)) for n in SERVE_REQUESTS]
    refs = [predict(ref_model, b, t, cfg=ref_cfg) for b, t in reqs]

    tracing.reset()                  # the served path starts here
    t0 = time.time()
    pred = Predictor(ANCHOR, branch_in=100, trunk_in=2, max_batch=8192,
                     device='cuda')
    check(pred.cfg['engine'] == 'pallas', f"engine {pred.cfg['engine']}")
    warm_s = pred.warmup()
    load_s = time.time() - t0
    bucket_ms = {}
    for b in pred.buckets:
        bb = np.zeros((b, 100), np.float32)
        tb = np.zeros((b, 2), np.float32)
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            pred.predict(bb, tb)
            times.append(1e3 * (time.perf_counter() - t1))
        bucket_ms[b] = float(np.median(times))
    req_err = []
    for (b, t), ref in zip(reqs, refs):
        out = pred.predict(b, t)
        check(out.shape == (b.shape[0], 1) and np.isfinite(out).all(),
              f"request of {b.shape[0]} rows: shape {out.shape} or not finite")
        req_err.append(float(np.abs(out - ref).max()))
    fix_err = float(np.abs(pred.predict(fb, ft) - fpred).max())

    code, resp, stopped = _http_predict(pred, fb, ft)
    http_err = float(np.abs(np.asarray(resp['pred']) - fpred).max())
    torch.cuda.synchronize()
    counts = _counts()               # ... and ends here
    launches = counts["hea_chain_fwd"]
    emit({"phase": "serve", "ckpt": os.path.relpath(ANCHOR, REPO),
          "engine": pred.cfg['engine'], "load_and_warmup_s": load_s,
          "warmup_s": warm_s, "bucket_latency_ms": bucket_ms,
          "requests": list(SERVE_REQUESTS),
          "request_max_abs_err_vs_plain": req_err,
          "fixture_max_abs_err": fix_err, "http_status": code,
          "http_buckets": resp['buckets'], "http_max_abs_err": http_err,
          "kernel_launches": launches, "launches": counts})
    check(max(req_err) <= SERVE_TOL,
          f"served requests differ from the plain engine by {req_err}")
    check(fix_err <= SERVE_TOL,
          f"served output differs from the JAX fixture by {fix_err}")
    check(code == 200 and http_err <= SERVE_TOL,
          f"HTTP /predict: status {code}, error {http_err}")
    check(launches > 0, "the served path launched no kernel")
    check(counts["ucomp_fwd"] > 0 and counts["ucomp_bwd"] == 0,
          f"serve: the default path on cuda takes B4f alone: {counts}")
    check(stopped, "server thread did not stop")
    for rows in (1, 8192):
        emit({"phase": "serve_breakdown", "rows": rows,
              **serve_breakdown(pred, rows)})
    return counts


def host_ms(fn, reps=20):
    """Median host-clock time (ms) of fn() followed by a synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def serve_breakdown(pred, rows):
    """Where one bucket's request time goes: the whole request (NumPy in,
    NumPy out), the model's forward on tensors already on the card, the
    chain operands within it (block-matrix fold and phases) and the
    kernel.  Runs after the served path's launches were read."""
    model = pred.model
    b = torch.zeros((rows, 100), device=pred.device)
    t = torch.zeros((rows, 2), device=pred.device)
    bn, tn = np.zeros((rows, 100), np.float32), np.zeros((rows, 2), np.float32)
    with torch.inference_mode():
        x = torch.cat([model.trunk_freq(t), model.branch_freq(b)], dim=1)
        ops = hea.prepare_chain(model.spec, model.ansatz, x)
        return {
            "request_ms": host_ms(lambda: pred.predict(bn, tn)),
            "forward_ms": host_ms(lambda: model(b, t)),
            "operands_ms": host_ms(
                lambda: hea.prepare_chain(model.spec, model.ansatz, x)),
            "kernel_host_ms": host_ms(lambda: cuda_hea.block_chain(*ops)),
            "kernel_ms": time_ms(lambda: cuda_hea.block_chain(*ops), 20),
        }


def _max_err(got, want):
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def _chain_geometry(nb, n, d):
    """The launch geometry of the block-chain kernels for (nb, N, D) on
    this card, and the Mbar reduction's slices."""
    sms = cuda_hea.sm_count(torch.cuda.current_device())
    return {**cuda_hea.chain_geometry(n, d, sms)._asdict(),
            "mbar_splits": cuda_hea.mbar_splits(nb, n, d, sms)}


def phase_kernel_bwd():
    """Residual forward and backward kernels vs plain at every case;
    returns the per-case records."""
    dev = torch.device('cuda')
    records = []
    for label, nq, net, n in BWD_CASES:
        spec = hea.quanonet_spec(nq, net)
        rng = np.random.RandomState(2000 * nq + n)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        x = torch.tensor(rng.uniform(-4, 4, (n, spec.total_encode))
                         .astype(np.float32), device=dev)
        g = [torch.tensor(rng.randn(n, spec.dim).astype(np.float32),
                          device=dev) for _ in range(2)]
        ops = hea.prepare_chain(spec, w, x)
        fwd = cuda_hea.chain_forward(*ops, save_residuals=True)
        primal = cuda_hea.chain_forward(*ops)
        fwd_plain = hea.chain_dense_saved(*ops)
        bwd = cuda_hea.chain_backward(*ops, fwd[2], fwd[3], *g)
        bwd2 = cuda_hea.chain_backward(*ops, fwd[2], fwd[3], *g)
        bwd_plain = hea.chain_backward_dense(*ops, fwd_plain[2:], *g)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all()) for t in (*fwd, *bwd))
        err_amp = _max_err(fwd[:2], fwd_plain[:2])
        err_states = _max_err(fwd[2:], fwd_plain[2:])
        err_mbar = _max_err(bwd[:2], bwd_plain[:2])
        err_phibar = _max_err(bwd[2:], bwd_plain[2:])
        scale_mbar = max(1.0, max(t.abs().max().item() for t in bwd_plain[:2]))
        scale_phibar = max(1.0, bwd_plain[2].abs().max().item())
        bit_equal = all(torch.equal(a, b) for a, b in zip(bwd, bwd2))
        primal_equal = all(torch.equal(a, b) for a, b in zip(primal, fwd))
        reps = 20 if n >= 1000 else 50
        ms_saved = time_ms(
            lambda: cuda_hea.chain_forward(*ops, save_residuals=True), reps)
        ms = time_ms(lambda: cuda_hea.chain_backward(*ops, fwd[2], fwd[3],
                                                     *g), reps)
        plain_ms = time_ms(lambda: hea.chain_backward_dense(
            *ops, fwd_plain[2:], *g), 5)
        plain_saved_ms = time_ms(lambda: hea.chain_dense_saved(*ops), 5)
        bound_ms, bound_by, flops, nbytes = bwd_bound(spec.n_blocks, n,
                                                      spec.dim)
        fwd_bound_ms = chain_bound(spec.n_blocks, n, spec.dim)[0]
        rec = {"phase": "kernel_bwd", "case": label, "nq": nq,
               "nb": spec.n_blocks, "N": n, "D": spec.dim,
               "splits": cuda_hea.mbar_splits(
                   spec.n_blocks, n, spec.dim,
                   torch.cuda.get_device_properties(dev)
                   .multi_processor_count),
               "max_abs_err_amp": err_amp, "max_abs_err_states": err_states,
               "max_abs_err_mbar": err_mbar, "mbar_scale": scale_mbar,
               "max_abs_err_phibar": err_phibar,
               "phibar_scale": scale_phibar,
               "bwd_bit_equal": bit_equal, "primal_bit_equal": primal_equal,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "share_of_bound": bound_ms / ms,
               "fwd_saved_ms": ms_saved, "fwd_saved_plain_ms": plain_saved_ms,
               "fwd_bound_ms": fwd_bound_ms,
               "geometry": _chain_geometry(spec.n_blocks, n, spec.dim)}
        if (nq, n) in FLAGSHIP_DEVICE_CASES:
            # every launch of the backward (sweep, Mbar, slices) and the
            # residual forward, on the card alone
            rec["device_ms"] = kernel_device_ms(
                lambda: cuda_hea.chain_backward(*ops, fwd[2], fwd[3], *g),
                None)
            rec["fwd_saved_device_ms"] = kernel_device_ms(
                lambda: cuda_hea.chain_forward(*ops, save_residuals=True),
                'hea_chain_fwd')
        emit(rec)
        where = f"{label} N={n}"
        check(finite, f"{where}: backward output not finite")
        check(err_amp <= AMP_TOL and err_states <= AMP_TOL,
              f"{where}: residual forward error {err_amp} / {err_states}")
        check(err_mbar <= BWD_REL_TOL * scale_mbar,
              f"{where}: Mbar error {err_mbar} > {BWD_REL_TOL} x {scale_mbar}")
        check(err_phibar <= BWD_REL_TOL * scale_phibar,
              f"{where}: phibar error {err_phibar} > {BWD_REL_TOL} x "
              f"{scale_phibar}")
        check(bit_equal, f"{where}: two backward calls differ")
        check(primal_equal, f"{where}: residual variant's output differs "
                            f"from the primal-only kernel's")
        records.append(rec)
    return records


def quick_data():
    """The quick regime's Advection data (bench.py --quick), generated
    from NumPy seed 0 into the repository's data cache."""
    cfg = dict(operator='Advection', model_type='QuanONet', num_train=200,
               num_test=100, num_points=100, num_points_0=100,
               train_sample_num=100, test_sample_num=100)
    np.random.seed(0)
    return DataManager(cfg, data_dir=os.path.join(REPO, 'data')).get_data()


def _parity_batches(dev):
    """The parity runs' data: (inputs, target, PARITY_STEPS batches of 100
    sample indices, the learning-rate schedule)."""
    data = quick_data()
    inputs = (torch.as_tensor(data['train_branch_input'], device=dev),
              torch.as_tensor(data['train_trunk_input'], device=dev))
    target = torch.as_tensor(data['train_output'], device=dev)
    idx = epoch_permutation(0, 0, target.shape[0])[:100 * PARITY_STEPS]
    idx = idx.to(dev).reshape(PARITY_STEPS, 100)
    return inputs, target, idx, _decay_tuple_schedule(
        3e-3, ('cosine', 2000, 0.0), None)


def _parity_steps(model, opt, inputs, target, idx):
    """One step per batch of idx; -> (losses, final parameters)."""
    losses = []
    for bi in idx:
        loss = ((model(inputs[0][bi], inputs[1][bi]) - target[bi])
                ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses, {k: v.detach().clone()
                    for k, v in model.state_dict().items()}


def phase_train_parity():
    """20 Adam steps of the default path on `cuda` (the compile kernels),
    kernels against autograd of the plain chain; returns the kernels' run
    (losses, parameters)."""
    dev = torch.device('cuda')
    inputs, target, idx, schedule = _parity_batches(dev)
    runs, counts = {}, {}
    for engine in ('pallas', 'dense'):
        model = QuanONet(5, 100, 2, (40, 2, 20, 2), scale_coeff=0.1,
                         engine=engine, device=dev,
                         generator=torch.Generator().manual_seed(0))
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                                 schedule)
        tracing.reset()
        runs[engine] = _parity_steps(model, opt, inputs, target, idx)
        counts[engine] = _counts()
    (lk, pk), (ld, pd) = runs['pallas'], runs['dense']
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, ld))
    param_err = max((pk[k] - pd[k]).abs().max().item() for k in pk)
    moved = max((pk[k] - init[k]).abs().max().item() for k in pk)
    emit({"phase": "train_parity", "steps": PARITY_STEPS,
          "losses_pallas": lk, "losses_dense": ld,
          "max_loss_rel_diff": loss_rel, "max_param_abs_diff": param_err,
          "max_param_moved": moved, "launches": counts})
    check(loss_rel <= PARITY_LOSS_RTOL,
          f"train_parity: step losses differ by {loss_rel} relative")
    check(param_err <= PARITY_PARAM_TOL,
          f"train_parity: parameters differ by {param_err}")
    on = counts['pallas']
    check(on["ucomp_fwd"] == on["ucomp_bwd"] == on["hea_chain_bwd"]
          == PARITY_STEPS and on["adam_step"] == 0,
          f"train_parity: the default path's launches {on}")
    return runs['pallas']


def phase_train():
    """The training path: the bench's quick regime for QUICK_SEEDS seeds,
    then one epoch of the CLI; returns the launches of both kernels in
    it."""
    quick_data()                      # the bench reads the cache
    tracing.reset()                   # the path starts here
    result = bench.run(bench.parser().parse_args(
        ['--quick', '--runs', str(QUICK_SEEDS)]))
    with tempfile.TemporaryDirectory() as tmp:
        stdout = sys.stdout
        try:
            solver = cli.main([
                '--operator', 'Advection', '--model_type', 'QuanONet',
                '--net_size', '40', '2', '20', '2', '--num_qubits', '5',
                '--scale_coeff', '0.1', '--num_epochs', '1',
                '--num_train', '20', '--num_test', '10',
                '--train_sample_num', '100', '--test_sample_num', '100',
                '--learning_rate', '0.003', '--prefix',
                os.path.join(tmp, 'outputs'), '--device', 'cuda'])
        finally:
            sys.stdout = stdout       # the Solver logs stdout to its file
        torch.cuda.synchronize()
        counts = _counts()                                     # ... ends here
        launches = (counts["hea_chain_fwd"], counts["hea_chain_bwd"])
        exp_dir = solver.exp_logger.exp_dir
        with open(os.path.join(exp_dir, 'metric.json')) as f:
            metrics = json.load(f)['metrics']
        ckpt = os.path.join(exp_dir, 'best_model.ckpt')
        written = [os.path.exists(ckpt),
                   os.path.exists(ckpt.replace('.ckpt', '.npz'))]
        want = solver.predict_test()
        model, _ = load_model(ckpt, 100, 2, device='cuda')
        got = predict(model, solver.test_inputs[0], solver.test_inputs[1])
        cli_err = float(np.abs(got - want).max())
    emit({"phase": "train", "bench": result,
          "band_rel_l2": QUICK_BAND_REL_L2,
          "jax_quick_rel_l2": list(JAX_QUICK_REL_L2),
          "cli_run_id": solver.run_id, "cli_metrics": metrics,
          "cli_ckpt_written": written, "cli_reload_max_abs_err": cli_err,
          "fwd_launches": launches[0], "bwd_launches": launches[1],
          "launches": counts})
    for seed, rel in enumerate(result['rel_l2_runs']):
        check(np.isfinite(rel) and rel <= QUICK_BAND_REL_L2,
              f"train: seed {seed} rel-L2 {rel} outside the band "
              f"{QUICK_BAND_REL_L2}")
    check(all(np.isfinite(v) for v in metrics.values()),
          f"train: CLI metric.json not finite: {metrics}")
    check(all(written), "train: CLI did not write best_model.ckpt/.npz")
    check(cli_err <= CLI_PRED_TOL,
          f"train: reloaded checkpoint predicts {cli_err} off the Solver's")
    check(launches[0] > 0 and launches[1] > 0,
          f"train: kernel launches {launches}")
    check(counts["ucomp_fwd"] > 0 and counts["ucomp_bwd"] > 0,
          f"train: the default path on cuda takes B4f and B4b: {counts}")
    check(counts["adam_step"] == 0,
          f"train: the solver's adam launched B5 (opt-in): {counts}")
    return counts, result


def train_breakdown(steps=20):
    """Where one training step's time goes, flagship at batch 100 on the
    card: host clock with a synchronise for the whole step, the forward
    (with the graph built), forward + backward, and the Adam step; CUDA
    events for the two chain kernels; a torch.profiler window for the
    device's busy share and the kernels that take it.  Runs outside the
    counted windows."""
    dev = torch.device('cuda')
    data = quick_data()
    idx = epoch_permutation(0, 0, data['train_output'].shape[0])[:100].numpy()
    b = torch.as_tensor(data['train_branch_input'][idx], device=dev)
    t = torch.as_tensor(data['train_trunk_input'][idx], device=dev)
    y = torch.as_tensor(data['train_output'][idx], device=dev)
    model = QuanONet(5, 100, 2, (40, 2, 20, 2), scale_coeff=0.1, device=dev,
                     generator=torch.Generator().manual_seed(0))
    opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                             lambda s: 1e-3)

    def loss():
        return ((model(b, t) - y) ** 2).mean()

    def step():
        opt.zero_grad()
        loss().backward()
        opt.step()

    x = torch.cat([model.trunk_freq(t), model.branch_freq(b)], dim=1)
    ops = [a.detach() for a in hea.prepare_chain(model.spec, model.ansatz,
                                                 x)]
    fwd = cuda_hea.chain_forward(*ops, save_residuals=True)
    g = torch.ones_like(fwd[0])
    out = {
        "step_ms": host_ms(step, steps),
        "forward_ms": host_ms(loss, steps),
        "forward_backward_ms": host_ms(lambda: loss().backward(), steps),
        "adam_ms": host_ms(opt.step, steps),
        "operands_forward_ms": host_ms(lambda: hea.prepare_chain(
            model.spec, model.ansatz, x), steps),
        "kernel_fwd_saved_ms": time_ms(lambda: cuda_hea.chain_forward(
            *ops, save_residuals=True), steps),
        "kernel_bwd_ms": time_ms(lambda: cuda_hea.chain_backward(
            *ops, fwd[2], fwd[3], g, g), steps),
    }
    out.update(profile_steps(step, steps, warm=3))
    return out


# ── the fused-group chain: Q8..Q16 (B2f, B2b) ──────────────────────────────

FUSED_CASES = [      # (label, qubits, net_size or block configs, N, backward)
    *[('Q10 Net40-2-20-2', 10, (40, 2, 20, 2), n, True)
      for n in (1, 100, 8192)],
    ('Q8 Net40-2-20-2', 8, (40, 2, 20, 2), 100, True),
    ('Q9 Net2-1-2-2', 9, (2, 1, 2, 2), 7, True),
    ('Q8 encode-only blocks', 8, ((8, 1), (8, 0), (8, 2), (8, 0)), 5, True),
    *[(f'Q{q} Net10-2-10-2', q, (10, 2, 10, 2), 100, True)
      for q in (11, 12, 13)],
    ('Q14 Net5-2-5-2', 14, (5, 2, 5, 2), 32, True),
    ('Q15 Net5-2-5-2', 15, (5, 2, 5, 2), 16, False),
    ('Q16 Net5-2-5-2', 16, (5, 2, 5, 2), 8, False),
]
Q10_NET = (40, 2, 20, 2)
Q10_FIXTURE = os.path.join(REPO, 'tests', 'fixtures',
                           'torch_port_q10_fused.npz')
Q10_SERVE_REQUESTS = (1, 37, 1000)
Q10_CLI_TRAIN = 300          # Advection functions of the Q10 CLI epoch


def _fused_spec(nq, net):
    if isinstance(net[0], tuple):
        return hea.HEASpec(nq, net)
    return hea.quanonet_spec(nq, net)


def _fused_counts(spec, n):
    """Per-call work of the fused-group chain: (flops of the forward, of
    the backward, bytes of the inputs and outputs of each) on N = n rows."""
    nq, d = spec.n_qubits, spec.dim
    nh = nq - 7
    amps = n * d
    fwd = bwd = 0.0
    for _, ld in spec.block_configs:
        # H^{(x)n}: n add/sub stages (2 flops an amplitude), two of them in
        # an encoding-only block; the phase product 6
        h = (1 + (ld == 0)) * 2.0 * nq * amps
        fwd += h + 6.0 * amps
        bwd += h + 15.0 * amps
        # per sublayer: the low product, 6 flops per complex MAC (the
        # three-product count); each high qubit's 2x2, 14 an amplitude
        fwd += ld * (6.0 * 128 * amps + 14.0 * nh * amps)
        # backward: ct . conj(U7t)^T and U7bar = conj(S)^T . ct, the 2x2's
        # adjoint (14) and its cotangent sums (16) per high qubit
        bwd += ld * (12.0 * 128 * amps + 30.0 * nh * amps)
    s = spec.total_sublayers
    ops_bytes = 4.0 * (2 * s * 128 * 128 + 2 * s * nh * 4)
    phi_bytes = 4.0 * spec.n_blocks * amps
    out_bytes = 4.0 * 2 * amps
    fwd_bytes = ops_bytes + phi_bytes + out_bytes
    # backward: operands, phi, the states (2 nb N D) and g read; the
    # cotangents of the operands and phibar written
    bwd_bytes = 2 * ops_bytes + 4.0 * 3 * spec.n_blocks * amps + out_bytes
    return fwd, bwd, fwd_bytes, bwd_bytes


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def fused_bound(spec, n):
    """Least time (ms) the card needs for the fused-group chain's forward
    on n rows: the larger of its operations at the fp32 peak and its bytes
    (each input read once, each output written once) at the HBM rate."""
    flops, _, nbytes, _ = _fused_counts(spec, n)
    return (*_bound(flops, nbytes), flops, nbytes)


def fused_bwd_bound(spec, n):
    """The same for the backward: the VJP's own products, butterfly and
    phase work (not the recompute of the forward), against its inputs and
    outputs read and written once."""
    _, flops, _, nbytes = _fused_counts(spec, n)
    return (*_bound(flops, nbytes), flops, nbytes)


def fused_tc_bound(spec, n, backward=False):
    """The least time (ms) with the low products on the tensor cores in
    the 3xTF32 split the kernels use: each real product three TF32 products
    at 495 TFLOP/s, the rest of the work (butterflies, phases) at the fp32
    peak, against the same bytes."""
    fwd, bwd, fwd_bytes, bwd_bytes = _fused_counts(spec, n)
    amps = n * spec.dim
    products = (2 if backward else 1) * 6.0 * 128 * amps * spec.total_sublayers
    flops = (bwd if backward else fwd) - products
    t = 3 * products / PEAK_TF32_FLOPS + flops / PEAK_FP32_FLOPS
    return 1e3 * max(t, (bwd_bytes if backward else fwd_bytes) / PEAK_HBM_BYTES)


def u7bar_library_ms(spec, n, dev, reps):
    """The yardstick of the U7bar launch: one torch.bmm on complex64 of its
    shapes, (S, 128, N hi) x (S, N hi, 128), on random inputs."""
    s, rows = spec.total_sublayers, n * spec.dim // 128
    a = torch.randn(s, 128, rows, dtype=torch.complex64, device=dev)
    b = torch.randn(s, rows, 128, dtype=torch.complex64, device=dev)
    ms = time_ms(lambda: torch.bmm(a, b), reps)
    del a, b
    return ms


def _fused_case(nq, net, n, seed, dev):
    spec = _fused_spec(nq, net)
    rng = np.random.RandomState(seed)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), device=dev)
    x = torch.tensor(rng.uniform(-4, 4, (n, spec.total_encode))
                     .astype(np.float32), device=dev)
    return spec, w, x, rng


def phase_kernel_fused():
    """B2f (primal and residual) against chain_fused / chain_fused_saved at
    every case; returns the per-case records."""
    dev = torch.device('cuda')
    records = []
    for label, nq, net, n, _ in FUSED_CASES:
        spec, w, x, _ = _fused_case(nq, net, n, 3000 + 10 * nq + n, dev)
        with torch.no_grad():
            ops = fused_gates.prepare_fused_chain_x(spec, w, x)
        lds = fused_gates.block_depths(spec)
        kr, ki = cuda_fused.chain_forward(*ops, lds)
        pr, pi = fused_gates.chain_fused_x(*ops, lds)
        torch.cuda.synchronize()
        diag = torch.as_tensor(simple_ham_diag(nq, -5, 5), device=dev)
        err_amp = _max_err((kr, ki), (pr, pi))
        err_exp = (hea.diag_expectation_pair(kr, ki, diag)
                   - hea.diag_expectation_pair(pr, pi, diag)
                   ).abs().max().item()
        finite = bool(torch.isfinite(kr).all() and torch.isfinite(ki).all())
        rec = {"phase": "kernel_fused", "case": label, "nq": nq,
               "nb": spec.n_blocks, "S": spec.total_sublayers, "N": n,
               "D": spec.dim,
               "rows_per_cta": cuda_fused.rows_per_cta(
                   nq, n, torch.cuda.get_device_properties(dev)
                   .multi_processor_count),
               "max_abs_err_amp": err_amp, "max_abs_err_expect": err_exp}
        if nq <= cuda_fused.TRAIN_MAX_QUBITS:
            fwd = cuda_fused.chain_forward(*ops, lds, save_residuals=True)
            saved = fused_gates.chain_fused_saved_x(*ops, lds)
            torch.cuda.synchronize()
            rec["max_abs_err_states"] = _max_err(fwd[2:], saved[2:])
            rec["primal_bit_equal"] = all(
                torch.equal(a, b) for a, b in zip(fwd[:2], (kr, ki)))
            del fwd, saved
        reps = 3 if n * spec.dim >= 2 ** 22 else 20
        rec["ms"] = time_ms(lambda: cuda_fused.chain_forward(*ops, lds), reps)
        rec["device_ms"] = kernel_device_ms(
            lambda: cuda_fused.chain_forward(*ops, lds), 'fused_chain_fwd',
            reps)
        rec["plain_ms"] = time_ms(lambda: fused_gates.chain_fused_x(*ops, lds),
                                  1 if n * spec.dim >= 2 ** 22 else 3)
        if nq <= cuda_fused.TRAIN_MAX_QUBITS:
            rec["saved_ms"] = time_ms(lambda: cuda_fused.chain_forward(
                *ops, lds, save_residuals=True), reps)
            rec["saved_device_ms"] = kernel_device_ms(
                lambda: cuda_fused.chain_forward(*ops, lds,
                                                 save_residuals=True),
                'fused_chain_fwd', reps)
        bound_ms, bound_by, flops, nbytes = fused_bound(spec, n)
        rec.update({"bound_ms": bound_ms, "bound_by": bound_by,
                    "tc_bound_ms": fused_tc_bound(spec, n),
                    "flops": flops, "bytes": nbytes,
                    "share_of_bound": bound_ms / rec["ms"]})
        if nq == 10 and n in (100, 8192):
            # yardstick: the whole forward from (weights, x), the
            # fused-group kernels against the grouped-kron engine
            with torch.no_grad():
                rec["pfused_engine_ms"] = time_ms(
                    lambda: cuda_fused.forward_pfused(spec, w, x), reps)
                rec["fused_engine_ms"] = time_ms(
                    lambda: fused_gates.forward_fused(spec, w, x), reps)
        emit(rec)
        where = f"{label} N={n}"
        check(finite, f"{where}: fused kernel output not finite")
        check(err_amp <= AMP_TOL,
              f"{where}: amplitude error {err_amp} > {AMP_TOL}")
        check(err_exp <= EXPECT_TOL,
              f"{where}: expectation error {err_exp} > {EXPECT_TOL}")
        if "primal_bit_equal" in rec:
            check(rec["max_abs_err_states"] <= AMP_TOL,
                  f"{where}: residual states error "
                  f"{rec['max_abs_err_states']}")
            check(rec["primal_bit_equal"], f"{where}: residual variant's "
                  f"output differs from the primal-only kernel's")
        records.append(rec)
        del ops, kr, ki, pr, pi
        torch.cuda.empty_cache()
    return records


def phase_kernel_fused_bwd():
    """B2b against chain_fused_backward at every case up to Q14; returns
    the per-case records."""
    dev = torch.device('cuda')
    records = []
    for label, nq, net, n, bwd in FUSED_CASES:
        if not bwd:
            continue
        spec, w, x, rng = _fused_case(nq, net, n, 4000 + 10 * nq + n, dev)
        with torch.no_grad():
            ops = fused_gates.prepare_fused_chain_x(spec, w, x)
        lds = fused_gates.block_depths(spec)
        g = [torch.tensor(rng.randn(n, spec.dim).astype(np.float32),
                          device=dev) for _ in range(2)]
        _, _, st_r, st_i = cuda_fused.chain_forward(*ops, lds,
                                                    save_residuals=True)
        got = cuda_fused.chain_backward(*ops, lds, st_r, st_i, *g)
        again = cuda_fused.chain_backward(*ops, lds, st_r, st_i, *g)
        want = fused_gates.chain_fused_backward_x(*ops, lds, (st_r, st_i),
                                                  *g)
        torch.cuda.synchronize()
        names = ('u7bar_r', 'u7bar_i', 'u2bar_r', 'u2bar_i', 'xbar')
        errs = {k: (a - b).abs().max().item()
                for k, a, b in zip(names, got, want)}
        scales = {k: max(1.0, b.abs().max().item())
                  for k, b in zip(names, want)}
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        big = n * spec.dim >= 2 ** 22

        def bwd():
            cuda_fused.chain_backward(*ops, lds, st_r, st_i, *g)
        ms = time_ms(bwd, 3 if big else 20)
        # on the card alone: all its launches, and each on its own
        device_ms = kernel_device_ms(bwd, None, 3 if big else 20)
        split = _profiled(bwd, 3 if big else 20).get("top_device_ms_per_step")
        plain_ms = time_ms(lambda: fused_gates.chain_fused_backward_x(
            *ops, lds, (st_r, st_i), *g), 1)
        bound_ms, bound_by, flops, nbytes = fused_bwd_bound(spec, n)
        rec = {"phase": "kernel_fused_bwd", "case": label, "nq": nq,
               "nb": spec.n_blocks, "S": spec.total_sublayers, "N": n,
               "D": spec.dim, "max_abs_err": errs, "scale": scales,
               "bit_equal": bit_equal, "ms": ms, "device_ms": device_ms,
               "device_ms_by_launch": split, "plain_ms": plain_ms,
               # (not at the largest batch: its complex64 operands
               # would take 16 GB beside the backward's own scratch)
               "u7bar_library_ms": (None if big else
                                    u7bar_library_ms(spec, n, dev, 20)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tc_bound_ms": fused_tc_bound(spec, n, backward=True),
               "flops": flops, "bytes": nbytes,
               "share_of_bound": bound_ms / ms,
               "u7bar_splits": cuda_fused.u7bar_splits(
                   spec.total_sublayers, n * spec.dim // 128,
                   torch.cuda.get_device_properties(dev)
                   .multi_processor_count)}
        emit(rec)
        where = f"{label} N={n}"
        check(finite, f"{where}: fused backward output not finite")
        for k in names:
            check(errs[k] <= BWD_REL_TOL * scales[k],
                  f"{where}: {k} error {errs[k]} > {BWD_REL_TOL} x "
                  f"{scales[k]}")
        check(bit_equal, f"{where}: two fused backward calls differ")
        records.append(rec)
        del ops, st_r, st_i, got, again, want
        torch.cuda.empty_cache()
    return records


def phase_train_parity_q10():
    """20 Adam steps at Q10 Net40-2-20-2, batch 100: the fused-group
    kernels ('pfused') against autograd of the grouped-kron engine
    ('fused'), from one initial state on the same batches."""
    dev = torch.device('cuda')
    data = quick_data()
    inputs = (torch.as_tensor(data['train_branch_input'], device=dev),
              torch.as_tensor(data['train_trunk_input'], device=dev))
    target = torch.as_tensor(data['train_output'], device=dev)
    idx = epoch_permutation(1, 0, target.shape[0])[:100 * PARITY_STEPS]
    idx = idx.to(dev).reshape(PARITY_STEPS, 100)
    schedule = _decay_tuple_schedule(3e-3, ('cosine', 2000, 0.0), None)
    runs = {}
    for engine in ('pfused', 'fused'):
        model = QuanONet(10, 100, 2, Q10_NET, scale_coeff=0.1,
                         engine=engine, device=dev,
                         generator=torch.Generator().manual_seed(0))
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                                 schedule)
        losses = []
        for bi in idx:
            loss = ((model(inputs[0][bi], inputs[1][bi]) - target[bi])
                    ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        runs[engine] = (losses, {k: v.detach().clone()
                                 for k, v in model.state_dict().items()})
    (lk, pk), (lf, pf) = runs['pfused'], runs['fused']
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lf))
    param_err = max((pk[k] - pf[k]).abs().max().item() for k in pk)
    moved = max((pk[k] - init[k]).abs().max().item() for k in pk)
    emit({"phase": "train_parity_q10", "steps": PARITY_STEPS,
          "losses_pfused": lk, "losses_fused": lf,
          "max_loss_rel_diff": loss_rel, "max_param_abs_diff": param_err,
          "max_param_moved": moved})
    check(all(np.isfinite(lk)), "train_parity_q10: losses not finite")
    check(loss_rel <= PARITY_LOSS_RTOL,
          f"train_parity_q10: step losses differ by {loss_rel} relative")
    check(param_err <= PARITY_PARAM_TOL,
          f"train_parity_q10: parameters differ by {param_err}")


def phase_train_q10():
    """The training path at Q10: one epoch of the CLI (engine 'auto' ->
    'pfused'); returns the launches in it."""
    with tempfile.TemporaryDirectory() as tmp:
        stdout = sys.stdout
        tracing.reset()               # the path starts here
        try:
            solver = cli.main([
                '--operator', 'Advection', '--model_type', 'QuanONet',
                '--net_size', *map(str, Q10_NET), '--num_qubits', '10',
                '--scale_coeff', '0.1', '--num_epochs', '1',
                '--num_train', str(Q10_CLI_TRAIN), '--num_test', '20',
                '--train_sample_num', '100', '--test_sample_num', '100',
                '--learning_rate', '0.003', '--prefix',
                os.path.join(tmp, 'outputs'), '--device', 'cuda'])
        finally:
            sys.stdout = stdout
        torch.cuda.synchronize()
        counts = _counts()            # ... and ends here
        launches = (counts["fused_chain_fwd"], counts["fused_chain_bwd"])
        other = (counts["hea_chain_fwd"], counts["hea_chain_bwd"])
        exp_dir = solver.exp_logger.exp_dir
        with open(os.path.join(exp_dir, 'metric.json')) as f:
            metrics = json.load(f)['metrics']
        ckpt = os.path.join(exp_dir, 'best_model.ckpt')
        written = [os.path.exists(ckpt),
                   os.path.exists(ckpt.replace('.ckpt', '.npz'))]
        want = solver.predict_test()
        model, cfg = load_model(ckpt, 100, 2, device='cuda')
        got = predict(model, solver.test_inputs[0], solver.test_inputs[1])
        cli_err = float(np.abs(got - want).max())
    emit({"phase": "train_q10", "cli_run_id": solver.run_id,
          "engine": solver.model.engine, "reload_engine": cfg['engine'],
          "cli_metrics": metrics, "cli_ckpt_written": written,
          "cli_reload_max_abs_err": cli_err, "fwd_launches": launches[0],
          "bwd_launches": launches[1], "hea_chain_launches": list(other),
          "launches": counts})
    check(all(np.isfinite(v) for v in metrics.values()),
          f"train_q10: CLI metric.json not finite: {metrics}")
    check(all(written), "train_q10: CLI did not write best_model.ckpt/.npz")
    check(cfg['engine'] == 'pfused', f"train_q10: reload engine "
                                     f"{cfg['engine']}")
    check(cli_err <= CLI_PRED_TOL,
          f"train_q10: reloaded checkpoint predicts {cli_err} off the "
          f"Solver's")
    check(launches[0] > 0 and launches[1] > 0,
          f"train_q10: fused kernel launches {launches}")
    return counts


def train_breakdown_q10(steps=10):
    """Where one Q10 training step's time goes at batch 100: host clock
    for the step, the forward and the Adam step; CUDA events for the two
    fused-group kernels; a torch.profiler window for the card's busy
    share.  Runs outside the counted windows."""
    dev = torch.device('cuda')
    data = quick_data()
    idx = epoch_permutation(0, 0, data['train_output'].shape[0])[:100].numpy()
    b = torch.as_tensor(data['train_branch_input'][idx], device=dev)
    t = torch.as_tensor(data['train_trunk_input'][idx], device=dev)
    y = torch.as_tensor(data['train_output'][idx], device=dev)
    model = QuanONet(10, 100, 2, Q10_NET, scale_coeff=0.1, device=dev,
                     generator=torch.Generator().manual_seed(0))
    opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                             lambda s: 1e-3)

    def loss():
        return ((model(b, t) - y) ** 2).mean()

    def step():
        opt.zero_grad()
        loss().backward()
        opt.step()

    x = torch.cat([model.trunk_freq(t), model.branch_freq(b)], dim=1)
    lds = fused_gates.block_depths(model.spec)
    ops = [a.detach() for a in fused_gates.prepare_fused_chain_x(
        model.spec, model.ansatz, x)]
    fwd = cuda_fused.chain_forward(*ops, lds, save_residuals=True)
    g = torch.ones_like(fwd[0])
    out = {
        "engine": hea.resolve_engine(model.engine, 10, dev),
        "step_ms": host_ms(step, steps),
        "forward_ms": host_ms(loss, steps),
        "adam_ms": host_ms(opt.step, steps),
        "operands_forward_ms": host_ms(
            lambda: fused_gates.prepare_fused_chain_x(model.spec, model.ansatz,
                                                      x), steps),
        "kernel_fwd_saved_ms": time_ms(lambda: cuda_fused.chain_forward(
            *ops, lds, save_residuals=True), steps),
        "kernel_bwd_ms": time_ms(lambda: cuda_fused.chain_backward(
            *ops, lds, fwd[2], fwd[3], g, g), steps),
    }
    out.update(profile_steps(step, steps, warm=3))
    return out


def _q10_checkpoint(tmp):
    """The fixture's seeded Q10 weights as a .ckpt under an experiment-ID
    directory, as the training CLI would write it; -> its path."""
    fx = np.load(Q10_FIXTURE)
    state = {k[len('sd.'):]: torch.as_tensor(fx[k]) for k in fx.files
             if k.startswith('sd.')}
    run = os.path.join(tmp, 'Advection_QuanONet_Net40-2-20-2_Q10_TF_S0.1_'
                            '1000x100_Seed0')
    os.makedirs(run)
    path = os.path.join(run, 'best_model.ckpt')
    ckpt_io.save_ms_ckpt(path, raw_from_state_dict(state, 'QuanONet'))
    return path, fx['branch'], fx['trunk'], fx['pred']


def phase_serve_q10():
    """The served path at Q10: a seeded checkpoint through Predictor and
    HTTP on `cuda`; returns the fused kernel's launches in it."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, fb, ft, fpred = _q10_checkpoint(tmp)
        ref_model, ref_cfg = load_model(ckpt, 100, 2, device='cuda',
                                        engine='fused')
        rng = np.random.RandomState(17)
        reqs = [(rng.randn(n, 100).astype(np.float32),
                 rng.rand(n, 2).astype(np.float32))
                for n in Q10_SERVE_REQUESTS]
        refs = [predict(ref_model, b, t, cfg=ref_cfg) for b, t in reqs]

        tracing.reset()                # the served path starts here
        t0 = time.time()
        pred = Predictor(ckpt, branch_in=100, trunk_in=2, max_batch=1024,
                         device='cuda')
        check(pred.cfg['engine'] == 'pfused', f"engine {pred.cfg['engine']}")
        warm_s = pred.warmup()
        load_s = time.time() - t0
        bucket_ms = {}
        for b in pred.buckets:
            times = []
            for _ in range(3):
                t1 = time.perf_counter()
                pred.predict(np.zeros((b, 100), np.float32),
                             np.zeros((b, 2), np.float32))
                times.append(1e3 * (time.perf_counter() - t1))
            bucket_ms[b] = float(np.median(times))
        req_err = []
        for (b, t), ref in zip(reqs, refs):
            out = pred.predict(b, t)
            check(out.shape == (b.shape[0], 1) and np.isfinite(out).all(),
                  f"Q10 request of {b.shape[0]} rows: shape {out.shape} or "
                  f"not finite")
            req_err.append(float(np.abs(out - ref).max()))
        fix_err = float(np.abs(pred.predict(fb, ft) - fpred).max())
        code, resp, stopped = _http_predict(pred, fb, ft)
        http_err = float(np.abs(np.asarray(resp['pred']) - fpred).max())
        torch.cuda.synchronize()
        counts = _counts()            # ... and ends here
        launches = counts["fused_chain_fwd"]
        other = (counts["hea_chain_fwd"], counts["fused_chain_bwd"])
    emit({"phase": "serve_q10", "engine": pred.cfg['engine'],
          "load_and_warmup_s": load_s, "warmup_s": warm_s,
          "bucket_latency_ms": bucket_ms,
          "requests": list(Q10_SERVE_REQUESTS),
          "request_max_abs_err_vs_fused": req_err,
          "fixture_max_abs_err": fix_err, "http_status": code,
          "http_buckets": resp['buckets'], "http_max_abs_err": http_err,
          "kernel_launches": launches,
          "other_launches": {"hea_chain": other[0],
                             "fused_chain_bwd": other[1]}})
    check(max(req_err) <= SERVE_TOL,
          f"Q10 served requests differ from the fused engine by {req_err}")
    check(fix_err <= SERVE_TOL,
          f"Q10 served output differs from the JAX fixture by {fix_err}")
    check(code == 200 and http_err <= SERVE_TOL,
          f"Q10 HTTP /predict: status {code}, error {http_err}")
    check(launches > 0, "the Q10 served path launched no fused kernel")
    check(stopped, "server thread did not stop")
    return launches


# ── the flagship's step with the compile and Adam kernels (B4f, B4b, B5) ────

FLAGSHIP = (5, (40, 2, 20, 2))
UCOMP_CASES = [      # (label, spec)
    ('Q5 Net40-2-20-2', hea.quanonet_spec(*FLAGSHIP)),
    ('Q2 Net5-1-5-1', hea.quanonet_spec(2, (5, 1, 5, 1))),
    ('Q3 Net2-3-2-3', hea.quanonet_spec(3, (2, 3, 2, 3))),
    ('Q4 HEAQNN 5-2', hea.heaqnn_spec(4, (5, 2))),
    ('Q6 Net40-2-20-2', hea.quanonet_spec(6, (40, 2, 20, 2))),
    ('Q7 Net40-2-20-2', hea.quanonet_spec(7, (40, 2, 20, 2))),
    ('Q5 one block', hea.HEASpec(5, ((5, 2),))),
]
ADAM_ATOL, ADAM_RTOL = 2e-6, 1e-5   # the kernel contracts multiply-adds
ADAM_STEPS = 25
PROFILE_ITERS = 40
ARM_ROUNDS, ARM_STEPS = 3, 20
# step_arms' rounds are longer: its rule compares two arms ~0.3 ms apart
# round by round, where rounds of 20 steps spread by more
STEP_ARMS_STEPS = 100


def ucomp_counts(nb, ld, d, n, h_blocks=None):
    """Least work of the block-matrix compile from the weights, in the gate
    form the kernels compute (csrc/ucomp.cu), as a dict: flops and bytes
    forward and backward.  Per row of H (D rows a block) and sublayer: two
    RY passes, n D / 2 pairs of two complex rotations each (12 flops a
    pair), the phase (a complex product an amplitude, 6 flops), the gather
    (no flops); then, in each of the ``h_blocks`` blocks that end with
    it (default nb − 1, every block but the last; nb for last = -1, 0 for
    EVERY_BLOCK), a Hadamard pass (4 flops a pair) and its 1 / sqrt(D)
    scale (2 an amplitude).  The backward counts the cotangent through the
    same passes and each angle's cotangent (8 flops a pair of an RY, 3 + n
    an amplitude of the phase), not the recompute of the forward state.
    Bytes: the weights (and g) read once, mt (or w̄) written once.  Beside
    them, as ``*_matmul_flops``, the D^3 count of the matrix form the TPU kernel and the plain version
    compute (a real D x D product 2 D^3 flops, a complex one three of them
    plus 5 D^2 additions; forward: ld products U1t . B' and ld - 1 fold
    products a block, H . acc and . R as butterflies; backward: the VJP's
    own products)."""
    rows = nb * d
    h_blocks = nb - 1 if h_blocks is None else h_blocks
    sub_fwd = (12 * n + 6) * d
    h = (2 * n + 2) * d
    fwd = rows * ld * sub_fwd + h_blocks * d * h
    bwd = rows * ld * (sub_fwd + 8 * n * d + (3 + n) * d) + h_blocks * d * h
    w_bytes = 4.0 * nb * ld * 3 * n
    mt_bytes = 4.0 * 2 * nb * d * d
    real = 2.0 * d ** 3
    cplx = 3 * real + 5.0 * d * d
    hr = (nb + h_blocks) * 2.0 * n * d * d
    return {"fwd_flops": float(fwd), "bwd_flops": float(bwd),
            "fwd_bytes": w_bytes + mt_bytes,
            "bwd_bytes": 2 * w_bytes + mt_bytes,
            "fwd_matmul_flops": nb * (2 * ld * real + (ld - 1) * cplx) + hr,
            "bwd_matmul_flops": nb * (2 * (ld - 1) * cplx + 4 * ld * real)
            + hr}


def smallest_launch():
    """What one launch costs on this card when the kernel does next to
    nothing: the Adam kernel bound to a single one-element leaf, per launch
    in a back-to-back run of 200 (CUDA events) and alone with a
    synchronise (host clock)."""
    leaf = torch.nn.Parameter(torch.zeros(1, device='cuda'))
    leaf.grad = torch.zeros(1, device='cuda')
    opt = cuda_adam.fused_adam(0.0).init([leaf])

    def burst():
        for _ in range(200):
            opt.step()
    return {"back_to_back_ms": time_ms(burst, 10) / 200,
            "alone_with_sync_ms": host_ms(opt.step, 50)}


def _profiled(step, steps=10, match=None, warm=3):
    return profile_steps(step, steps, match, warm)


# where each card time of kernel_device_ms came from, for the run's record
DEVICE_MS_SOURCES = {"profiler": 0, "queued": 0}


def kernel_device_ms(fn, match, reps=20):
    """Time on the card alone (ms a call) of the kernels whose name holds
    ``match``: the CUDA-event times around a wrapper also hold the host's
    part of a call, which for a kernel of microseconds is most of it.
    From a torch.profiler window of ``reps`` calls after a warm-up of as
    many: each kernel's mean time over the launches the window kept, times
    its launches a call (a window can lose the rows of a few launches,
    never a whole call's worth).  Without a row, from
    time_chain.queued_device_ms (the calls queued behind a sleep, back to
    back, between two CUDA events), which also holds the card's gap
    between launches.  Never None."""
    fn()
    prof = _profiled(fn, reps, match, warm=reps)
    if prof.get("device_rows"):
        DEVICE_MS_SOURCES["profiler"] += 1
        return sum(ms / count * -(-count // reps)
                   for count, ms in prof["device_rows"])
    DEVICE_MS_SOURCES["queued"] += 1
    return time_chain.queued_device_ms(fn, reps)


def profiler_rows(fn, match, reps=20, windows=5):
    """How many of the ``reps`` launches of ``match`` each of ``windows``
    profiler windows kept, fresh and after a warm-up of ``reps`` calls
    (kernel_device_ms reads warmed windows: fresh ones lose their first
    rows)."""
    fn()
    return {name: [_profiled(fn, reps, match, warm).get("device_kernels", 0)
                   for _ in range(windows)]
            for name, warm in (("fresh", 0), ("warmed", reps))}


def phase_kernel_ucomp(launch):
    """B4f and B4b against their plain versions at every case, beside what
    the smallest launch costs (``launch``); returns the per-case records."""
    dev = torch.device('cuda')
    sms = cuda_ucomp.sm_count(dev.index)
    records = []
    for label, spec in UCOMP_CASES:
        nb, d, ld = spec.n_blocks, spec.dim, spec.block_configs[0][1]
        last = nb - 1
        rng = np.random.RandomState(5000 + 10 * spec.n_qubits + nb)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        g = [torch.tensor(rng.randn(nb, d, d).astype(np.float32), device=dev)
             for _ in range(2)]
        fwd = cuda_ucomp.ucomp_forward(w, ld, last)
        bwd = cuda_ucomp.ucomp_backward(w, ld, last, *g)
        again = cuda_ucomp.ucomp_backward(w, ld, last, *g)
        fwd_plain = cuda_ucomp.ucomp_weights_dense(w, ld, last)
        bwd_plain = cuda_ucomp.ucomp_weights_backward_dense(w, ld, last, *g)
        fold = hea.fold_block_mats(spec, w)
        torch.cuda.synchronize()
        counts = ucomp_counts(nb, ld, d, spec.n_qubits)
        fwd_bound, fwd_by = _bound(counts["fwd_flops"], counts["fwd_bytes"])
        bwd_bound, bwd_by = _bound(counts["bwd_flops"], counts["bwd_bytes"])
        rec = {"phase": "kernel_ucomp", "case": label, "nq": spec.n_qubits,
               "nb": nb, "ld": ld, "D": d,
               "geometry": {
                   "fwd": cuda_ucomp.ucomp_geometry(d, nb, sms)._asdict(),
                   "bwd": cuda_ucomp.ucomp_geometry(
                       d, nb, sms, backward=True)._asdict()},
               "max_abs_err_fwd": _max_err(fwd, fwd_plain),
               "max_abs_err_vs_fold": _max_err(fwd, fold),
               "max_abs_err_bwd": (bwd - bwd_plain).abs().max().item(),
               "bwd_scale": max(1.0, bwd_plain.abs().max().item()),
               "bwd_bit_equal": torch.equal(bwd, again),
               "fwd_ms": time_ms(lambda: cuda_ucomp.ucomp_forward(
                   w, ld, last), 30),
               "fwd_plain_ms": time_ms(lambda: cuda_ucomp.ucomp_weights_dense(
                   w, ld, last), 5),
               "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
               "bwd_ms": time_ms(lambda: cuda_ucomp.ucomp_backward(
                   w, ld, last, *g), 30),
               "bwd_plain_ms": time_ms(
                   lambda: cuda_ucomp.ucomp_weights_backward_dense(
                       w, ld, last, *g), 5),
               "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
               **counts,
               "fwd_device_ms": kernel_device_ms(
                   lambda: cuda_ucomp.ucomp_forward(w, ld, last),
                   'ucomp_fwd'),
               "bwd_device_ms": kernel_device_ms(
                   lambda: cuda_ucomp.ucomp_backward(w, ld, last, *g),
                   'ucomp_bwd'),
               "smallest_launch": launch,
               "launch_bound": max(fwd_bound, bwd_bound)
               < launch["back_to_back_ms"]}
        if (spec.n_qubits, nb) == (5, 60):
            rec["replaces"] = _fold_against_compile(spec, w, g)
        emit(rec)
        finite = all(bool(torch.isfinite(t).all()) for t in (*fwd, bwd))
        check(finite, f"ucomp {label}: output not finite")
        check(rec["max_abs_err_fwd"] <= AMP_TOL,
              f"ucomp {label}: forward error {rec['max_abs_err_fwd']}")
        check(rec["max_abs_err_vs_fold"] <= AMP_TOL,
              f"ucomp {label}: differs from the fold by "
              f"{rec['max_abs_err_vs_fold']}")
        check(rec["max_abs_err_bwd"] <= BWD_REL_TOL * rec["bwd_scale"],
              f"ucomp {label}: wbar error {rec['max_abs_err_bwd']} > "
              f"{BWD_REL_TOL} x {rec['bwd_scale']}")
        check(rec["bwd_bit_equal"], f"ucomp {label}: two backward calls differ")
        records.append(rec)
    return records


def _fold_against_compile(spec, w, g):
    """At the flagship: the autograd fold that the compile kernels replace
    and the compile path, each as time_chain.compile_path measures it."""
    out = {}
    for name, mats in (('fold', hea.fold_block_mats),
                       ('compile', cuda_ucomp.compile_block_mats)):
        path = time_chain.compile_path(mats, spec, w, g, host_ms, _profiled)
        out.update({f"{name}_{k}": v for k, v in path.items()})
    return out


# B4f at the stacks the shift rule compiles: (label, spec, --ps_chunk)
SHIFT_STACK_CASES = (
    ('Q5 Net40-2-20-2', hea.quanonet_spec(*FLAGSHIP), None),
    ('Q5 Net40-2-20-2', hea.quanonet_spec(*FLAGSHIP), 64),
    ('Q7 Net40-2-20-2', hea.quanonet_spec(7, (40, 2, 20, 2)), None),
)


def _shifted_fold(spec, w, p, sign, b):
    """Block b of the autograd fold of w with weight p shifted."""
    w = w.clone()
    w.view(-1)[p] += sign * param_shift.SHIFT
    fr, fi = hea.fold_block_mats(spec, w)
    return fr[b], fi[b]


def phase_kernel_ucomp_shift():
    """B4f at the shift rule's stacks, built as its backward builds them
    (ops/param_shift.py): the first chunk's weight sets (p, ±1), each its
    block's shifted (ld, 3, n) slice, the inner blocks' slices
    concatenated and compiled with last = -1 (the Hadamard on every
    block), against ucomp_weights_dense; the first and last inner set,
    and a final-block set compiled alone with last = 0, against the
    autograd fold of the shifted weights.  Returns the records."""
    dev = torch.device('cuda')
    records = []
    for label, spec, chunk in SHIFT_STACK_CASES:
        nb, d, ld = spec.n_blocks, spec.dim, spec.block_configs[0][1]
        rng = np.random.RandomState(6000 + spec.n_qubits)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        n_w = w.numel()
        ps = range(min(chunk or n_w, n_w))
        sets = [(p, 1.0) for p in ps] + [(p, -1.0) for p in ps]
        blocks, wb = param_shift.shifted_block_weights(spec, w, sets)
        inner = [k for k, b in enumerate(blocks) if b != nb - 1]
        stack = torch.cat([wb[k] for k in inner])
        mr, mi = cuda_ucomp.ucomp_forward(stack, ld, -1)
        plain = cuda_ucomp.ucomp_weights_dense(stack, ld, -1)
        vs_fold = 0.0
        for j in (0, len(inner) - 1):
            k = inner[j]
            vs_fold = max(vs_fold, _max_err(
                (mr[j], mi[j]),
                _shifted_fold(spec, w, *sets[k], blocks[k])))
        # a final-block set, compiled on its own as the backward does
        p_last = n_w - 1
        (b_last,), (w_last,) = param_shift.shifted_block_weights(
            spec, w, [(p_last, -1.0)])
        fr, fi = cuda_ucomp.ucomp_forward(w_last, ld, 0)
        final_vs_fold = _max_err(
            (fr[0], fi[0]), _shifted_fold(spec, w, p_last, -1.0, b_last))
        torch.cuda.synchronize()
        counts = ucomp_counts(len(inner), ld, d, spec.n_qubits, len(inner))
        bound, by = _bound(counts["fwd_flops"], counts["fwd_bytes"])
        rec = {"phase": "kernel_ucomp_shift", "case": label,
               "ps_chunk": chunk, "sets": len(sets),
               "stacked_blocks": len(inner), "ld": ld, "D": d,
               "last": -1, "max_abs_err_fwd": _max_err((mr, mi), plain),
               "max_abs_err_vs_fold": vs_fold,
               "final_block_max_abs_err_vs_fold": final_vs_fold,
               "fwd_ms": time_ms(lambda: cuda_ucomp.ucomp_forward(
                   stack, ld, -1), 10),
               "fwd_plain_ms": time_ms(
                   lambda: cuda_ucomp.ucomp_weights_dense(stack, ld, -1), 3),
               "fwd_bound_ms": bound, "fwd_bound_by": by}
        emit(rec)
        check(bool(torch.isfinite(mr).all() and torch.isfinite(mi).all()),
              f"ucomp shift stack {label}: output not finite")
        for key in ("max_abs_err_fwd", "max_abs_err_vs_fold",
                    "final_block_max_abs_err_vs_fold"):
            check(rec[key] <= AMP_TOL,
                  f"ucomp shift stack {label} chunk {chunk}: {key} "
                  f"{rec[key]} > {AMP_TOL}")
        records.append(rec)
    return records


def phase_kernel_ucomp_packed():
    """B4f and B4b at the stacks the packed route compiles
    (cuda_ucomp.compile_block_mats_stacked) at the flagship for
    len(PACKED_SEEDS) seeds: the S·(nb − 1) inner blocks with last = -1
    and the S final blocks with EVERY_BLOCK, each forward and backward
    against ucomp_weights_dense / ucomp_weights_backward_dense on the same
    weights and cotangents, at kernel_ucomp's limits.  Then the joined
    stack and its w̄ under autograd against each seed's own
    compile_block_mats.  Returns the records of the two stacks."""
    dev = torch.device('cuda')
    spec = hea.quanonet_spec(*FLAGSHIP)
    s = len(PACKED_SEEDS)
    nb, d, ld, n = (spec.n_blocks, spec.dim, spec.block_configs[0][1],
                    spec.n_qubits)
    sms = cuda_ucomp.sm_count(dev.index)
    rng = np.random.RandomState(7000)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, (s, *spec.weight_shape()))
                     .astype(np.float32), device=dev)
    ws = w.reshape(s, nb, ld, 3, n)
    stacks = (('inner', ws[:, :-1].reshape(-1, 3, n).contiguous(), -1),
              ('final', ws[:, -1].reshape(-1, 3, n).contiguous(),
               cuda_ucomp.EVERY_BLOCK))
    records = []
    for label, stack, last in stacks:
        blocks = stack.shape[0] // ld
        g = [torch.tensor(rng.randn(blocks, d, d).astype(np.float32),
                          device=dev) for _ in range(2)]
        fwd = cuda_ucomp.ucomp_forward(stack, ld, last)
        bwd = cuda_ucomp.ucomp_backward(stack, ld, last, *g)
        fwd_plain = cuda_ucomp.ucomp_weights_dense(stack, ld, last)
        bwd_plain = cuda_ucomp.ucomp_weights_backward_dense(stack, ld, last,
                                                            *g)
        torch.cuda.synchronize()
        counts = ucomp_counts(blocks, ld, d, n,
                              blocks if last == -1 else 0)
        fwd_bound, fwd_by = _bound(counts["fwd_flops"], counts["fwd_bytes"])
        bwd_bound, bwd_by = _bound(counts["bwd_flops"], counts["bwd_bytes"])
        rec = {"phase": "kernel_ucomp_packed", "case": f"Q5 S={s} {label}",
               "seeds": s, "nb": blocks, "ld": ld, "D": d, "last": last,
               "geometry": {
                   "fwd": cuda_ucomp.ucomp_geometry(d, blocks, sms)._asdict(),
                   "bwd": cuda_ucomp.ucomp_geometry(
                       d, blocks, sms, backward=True)._asdict()},
               "max_abs_err_fwd": _max_err(fwd, fwd_plain),
               "max_abs_err_bwd": (bwd - bwd_plain).abs().max().item(),
               "bwd_scale": max(1.0, bwd_plain.abs().max().item()),
               "fwd_ms": time_ms(lambda: cuda_ucomp.ucomp_forward(
                   stack, ld, last), 30),
               "fwd_plain_ms": time_ms(lambda: cuda_ucomp.ucomp_weights_dense(
                   stack, ld, last), 5),
               "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
               "bwd_ms": time_ms(lambda: cuda_ucomp.ucomp_backward(
                   stack, ld, last, *g), 30),
               "bwd_plain_ms": time_ms(
                   lambda: cuda_ucomp.ucomp_weights_backward_dense(
                       stack, ld, last, *g), 5),
               "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by}
        emit(rec)
        finite = all(bool(torch.isfinite(t).all()) for t in (*fwd, bwd))
        check(finite, f"ucomp packed {label}: output not finite")
        check(rec["max_abs_err_fwd"] <= AMP_TOL,
              f"ucomp packed {label}: forward error {rec['max_abs_err_fwd']}")
        check(rec["max_abs_err_bwd"] <= BWD_REL_TOL * rec["bwd_scale"],
              f"ucomp packed {label}: wbar error {rec['max_abs_err_bwd']} > "
              f"{BWD_REL_TOL} x {rec['bwd_scale']}")
        records.append(rec)
    # the joined stack and its wbar against each seed's own compile
    gr, gi = (torch.tensor(rng.randn(s, nb, d, d).astype(np.float32),
                           device=dev) for _ in range(2))
    wp = w.clone().requires_grad_()
    jr, ji = cuda_ucomp.compile_block_mats_stacked(spec, wp)
    (wbar,) = torch.autograd.grad((jr * gr + ji * gi).sum(), wp)
    own_err = own_bwd_err = 0.0
    for i in range(s):
        wi = w[i].clone().requires_grad_()
        mr, mi = cuda_ucomp.compile_block_mats(spec, wi)
        (own,) = torch.autograd.grad((mr * gr[i] + mi * gi[i]).sum(), wi)
        own_err = max(own_err, _max_err((jr[i], ji[i]), (mr, mi)))
        own_bwd_err = max(own_bwd_err, (wbar[i] - own).abs().max().item())
    scale = max(1.0, wbar.abs().max().item())
    emit({"phase": "kernel_ucomp_packed", "case": f"Q5 S={s} joined",
          "max_abs_err_vs_own_compile": own_err,
          "max_abs_err_wbar_vs_own_compile": own_bwd_err,
          "wbar_scale": scale})
    check(own_err <= AMP_TOL,
          f"ucomp packed: the joined stack differs from each seed's compile "
          f"by {own_err}")
    check(own_bwd_err <= BWD_REL_TOL * scale,
          f"ucomp packed: wbar differs from each seed's compile by "
          f"{own_bwd_err} > {BWD_REL_TOL} x {scale}")
    return records


def _flagship_model(dev, engine='pallas'):
    return QuanONet(FLAGSHIP[0], 100, 2, FLAGSHIP[1], scale_coeff=0.1,
                    engine=engine, device=dev,
                    generator=torch.Generator().manual_seed(0))


def phase_kernel_adam(launch):
    """B5 through FusedAdam against adam_step_dense on the flagship's
    leaves: ADAM_STEPS steps at the rates 1e-2 * 0.95^t (update t) from the
    card's rate table, fresh gradients every step; two runs bit-equal, the
    device count ADAM_STEPS after.  Then one step at a constant rate by
    CUDA events, by the host clock and on the card, beside its bound, the
    plain version, torch.optim.Adam(fused=True) (the yardstick) and the
    default torch.optim.Adam, and the rows the profiler keeps of it
    (profiler_rows).  Returns the record."""
    dev = torch.device('cuda')
    shapes = [tuple(p.shape) for p in _flagship_model(dev).parameters()]
    n_params = sum(int(np.prod(s)) for s in shapes)

    def leaves(seed):
        rng = np.random.RandomState(seed)
        return [torch.tensor(np.asarray(rng.randn(*s), np.float32),
                             device=dev) for s in shapes]

    def schedule(count):
        return 1e-2 * 0.95 ** (count + 1)

    def run_fused():
        params = [torch.nn.Parameter(a) for a in leaves(0)]
        opt = cuda_adam.fused_adam(schedule, total_steps=ADAM_STEPS).init(
            params)
        for t in range(1, ADAM_STEPS + 1):
            for q, g in zip(params, leaves(100 + t)):
                q.grad = g
            opt.step()
        torch.cuda.synchronize()
        check(opt.state_dict()['count'] == ADAM_STEPS,
              "adam: the host's count")
        return ([q.detach() for q in params] + opt.mu + opt.nu,
                int(opt.device_count[0]))

    def run_plain():
        # update t at the schedule's rate before the count's increment,
        # in fp32 as the kernel reads it: from the schedule, not the table
        p = leaves(0)
        m = [torch.zeros_like(a) for a in p]
        v = [torch.zeros_like(a) for a in p]
        for t in range(1, ADAM_STEPS + 1):
            cuda_adam.adam_step_dense(p, leaves(100 + t), m, v,
                                      float(np.float32(schedule(t - 1))), t)
        torch.cuda.synchronize()
        return p + m + v

    before = _counts()["adam_step"]
    (got, count), (again, _) = run_fused(), run_fused()
    fused_launches = _counts()["adam_step"] - before
    want = run_plain()
    err = _max_err(got, want)
    close = all(torch.allclose(a, b, atol=ADAM_ATOL, rtol=ADAM_RTOL)
                for a, b in zip(got, want))
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))

    p, g = leaves(1), leaves(2)
    m, v = [torch.zeros_like(a) for a in p], [torch.zeros_like(a) for a in p]
    params = [torch.nn.Parameter(a.clone()) for a in p]
    for q, gq in zip(params, g):
        q.grad = gq
    opt = cuda_adam.fused_adam(1e-3).init(params)
    library = torch.optim.Adam([torch.nn.Parameter(a.clone()) for a in p],
                               lr=1e-3, fused=True)
    default = torch.optim.Adam([torch.nn.Parameter(a.clone()) for a in p],
                               lr=1e-3)
    for other in (library, default):
        for q, gq in zip(other.param_groups[0]['params'], g):
            q.grad = gq
    bound_ms, nbytes = time_chain.adam_bound_ms(n_params)
    rec = {"phase": "kernel_adam", "leaves": [list(s) for s in shapes],
           "parameters": n_params, "steps": ADAM_STEPS,
           "max_abs_err": err, "close": close, "bit_equal": bit_equal,
           "device_count": count, "launches": fused_launches,
           "ctas": opt._bindings[0].grid(),
           "ms": time_ms(opt.step, 100),
           "host_ms": host_ms(opt.step, 50),
           "device_ms": kernel_device_ms(opt.step, 'adam_kernel'),
           "queued_device_ms": time_chain.queued_device_ms(opt.step),
           "profiler_rows": profiler_rows(opt.step, 'adam_kernel'),
           "plain_ms": time_ms(lambda: cuda_adam.adam_step_dense(
               p, g, m, v, 1e-3, 3), 20),
           "library_ms": time_ms(library.step, 100),
           "library_host_ms": host_ms(library.step, 50),
           "torch_adam_default_ms": time_ms(default.step, 50),
           "torch_adam_default_host_ms": host_ms(default.step, 50),
           "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
           "smallest_launch": launch}
    emit(rec)
    check(all(bool(torch.isfinite(t).all()) for t in got),
          "adam: output not finite")
    check(close, f"adam: kernel differs from the plain version by {err} "
                 f"(atol {ADAM_ATOL}, rtol {ADAM_RTOL})")
    check(bit_equal, "adam: two runs of 25 steps differ")
    check(count == ADAM_STEPS and fused_launches == 2 * ADAM_STEPS,
          f"adam: device count {count}, launches {fused_launches}")
    return rec


def phase_train_parity_ucomp(default_run):
    """20 Adam steps of the flagship with the compile kernels (USE_UCOMP
    on) and FusedAdam against train_parity's default run (the compile
    kernels and torch.optim.Adam), same initial state, batches and
    schedule."""
    dev = torch.device('cuda')
    inputs, target, idx, schedule = _parity_batches(dev)
    model = _flagship_model(dev)
    opt = cuda_adam.fused_adam(schedule, total_steps=PARITY_STEPS).init(
        model.parameters())
    tracing.reset()
    with use_ucomp(True):
        lu, pu = _parity_steps(model, opt, inputs, target, idx)
    counts = _counts()
    ld, pd = default_run
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lu, ld))
    param_err = max((pu[k] - pd[k]).abs().max().item() for k in pu)
    emit({"phase": "train_parity_ucomp", "steps": PARITY_STEPS,
          "losses_ucomp_fused_adam": lu, "losses_default": ld,
          "max_loss_rel_diff": loss_rel, "max_param_abs_diff": param_err,
          "launches": counts})
    check(all(np.isfinite(lu)), "train_parity_ucomp: losses not finite")
    check(loss_rel <= PARITY_LOSS_RTOL,
          f"train_parity_ucomp: step losses differ by {loss_rel} relative")
    check(param_err <= PARITY_PARAM_TOL,
          f"train_parity_ucomp: parameters differ by {param_err}")
    check(counts["ucomp_fwd"] == counts["ucomp_bwd"] == counts["adam_step"]
          == PARITY_STEPS, f"train_parity_ucomp: launches {counts}")


def phase_train_parity_fold(default_run):
    """20 Adam steps of the flagship on the route that was the default on
    `cuda` before the compile kernels (USE_UCOMP off: the autograd fold; a
    ScheduledOptimizer over torch.optim.Adam) against train_parity's
    default run, same initial state, batches and schedule."""
    dev = torch.device('cuda')
    inputs, target, idx, schedule = _parity_batches(dev)
    model = _flagship_model(dev)
    opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()), schedule)
    tracing.reset()
    with use_ucomp(False):
        lf, pf = _parity_steps(model, opt, inputs, target, idx)
    counts = _counts()
    ld, pd = default_run
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, ld))
    param_err = max((pf[k] - pd[k]).abs().max().item() for k in pf)
    emit({"phase": "train_parity_fold", "steps": PARITY_STEPS,
          "losses_fold_torch_adam": lf, "losses_default": ld,
          "max_loss_rel_diff": loss_rel, "max_param_abs_diff": param_err,
          "launches": counts})
    check(all(np.isfinite(lf)), "train_parity_fold: losses not finite")
    check(loss_rel <= PARITY_LOSS_RTOL,
          f"train_parity_fold: step losses differ by {loss_rel} relative")
    check(param_err <= PARITY_PARAM_TOL,
          f"train_parity_fold: parameters differ by {param_err}")
    check(counts["ucomp_fwd"] == counts["ucomp_bwd"] == counts["adam_step"]
          == 0 and counts["hea_chain_bwd"] == PARITY_STEPS,
          f"train_parity_fold: the fold's launches {counts}")


@contextmanager
def use_ucomp(flag):
    """cuda_hea.USE_UCOMP set to ``flag`` inside, and back to the value it
    had after."""
    found, cuda_hea.USE_UCOMP = cuda_hea.USE_UCOMP, flag
    try:
        yield
    finally:
        cuda_hea.USE_UCOMP = found


def phase_profile_step():
    """profile_step.main at full width on the card: the fold (USE_UCOMP
    off, torch.optim.Adam), then USE_UCOMP on with --fused_adam; returns the
    second run's launches."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, ucomp, extra in (('fold', False, []),
                                   ('ucomp_fused_adam', True,
                                    ['--fused_adam'])):
            out = os.path.join(tmp, f'{name}.json')
            tracing.reset()            # the path starts here
            stdout = sys.stdout
            sys.stdout = sys.stderr    # its results line is not this script's
            try:
                with use_ucomp(ucomp):
                    res = profile_step.main(['--iters', str(PROFILE_ITERS),
                                             '--out', out] + extra)
            finally:
                sys.stdout = stdout
            torch.cuda.synchronize()
            counts = _counts()         # ... and ends here
            with open(out) as f:
                written = json.load(f)
            runs[name] = (res, counts, written == res)
    emit({"phase": "profile_step", "iters": PROFILE_ITERS,
          **{name: {"results": res, "launches": counts,
                    "json_written": same}
             for name, (res, counts, same) in runs.items()}})
    for name, (res, counts, same) in runs.items():
        check(same, f"profile_step {name}: --out differs from the results")
        check(res['platform'] == 'cuda' and res['nvidia_smi'],
              f"profile_step {name}: platform {res['platform']}, card "
              f"{res['nvidia_smi']}")
        for k in ('full_step[pallas] bs=100', 'fwd_only[pallas] bs=100',
                  'full_step[embed] bs=100', 'fwd_only[embed] bs=100',
                  'full_step[dense] bs=100', 'fwd_only[dense] bs=100',
                  'full_step[pallas] bs=400', 'full_step[pallas] bs=1600',
                  'compile_path fwd+bwd', 'adam_only'):
            check(np.isfinite(res.get(k, np.nan)) and res[k] > 0,
                  f"profile_step {name}: component {k!r} is {res.get(k)}")
        check(counts["hea_chain_fwd"] > 0 and counts["hea_chain_bwd"] > 0
              and counts["embed_chain_fwd"] > 0
              and counts["embed_chain_bwd"] > 0,
              f"profile_step {name}: chain launches {counts}")
    off, on = runs['fold'][1], runs['ucomp_fused_adam'][1]
    check(off["ucomp_fwd"] == off["ucomp_bwd"] == off["adam_step"] == 0,
          f"profile_step: the fold arm launched a compile or Adam kernel: "
          f"{off}")
    check(on["ucomp_fwd"] > 0 and on["ucomp_bwd"] > 0 and on["adam_step"] > 0,
          f"profile_step: toggles on, yet launches {on}")
    return on


def _arms_in_turns(arms, steps=ARM_STEPS):
    """{name: step} -> per arm the median step time over ARM_ROUNDS rounds
    of ``steps`` steps, the arms taking turns (host clock with a
    synchronise), then its device rows a step, the card's busy share and
    its top kernels under torch.profiler."""
    times = {name: [] for name in arms}
    for step in arms.values():
        for _ in range(3):
            step()
    for _ in range(ARM_ROUNDS):
        for name, step in arms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0) / steps)
    out = {}
    for name, step in arms.items():
        prof = _profiled(step)
        out[name] = {"step_ms": float(np.median(times[name])),
                     "step_ms_rounds": times[name],
                     "device_rows_per_step": prof.get(
                         "device_kernels_per_step"),
                     "device_busy_share": prof.get("device_busy_share"),
                     "device_busy_ms_per_step": (
                         prof["device_busy_ms"] / prof["profiled_steps"]
                         if "device_busy_ms" in prof else None),
                     "top_device_ms_per_step": prof.get(
                         "top_device_ms_per_step"),
                     "profiler_error": prof.get("profiler_error")}
    return out


def step_arms():
    """The flagship's step at batch 100 in five arms, in turns within this
    process so that all see the same host: ``fold`` (USE_UCOMP off, a
    ScheduledOptimizer over torch.optim.Adam: the route before the compile
    kernels), ``ucomp`` (USE_UCOMP on, the same optimizer), ``fused_adam``
    (the fold with FusedAdam), ``both`` (the compile kernels with
    FusedAdam) and ``default`` (USE_UCOMP unset, the solver's
    build_optimizer for adam).  Per arm the step ms of each of ARM_ROUNDS
    rounds of STEP_ARMS_STEPS steps, device rows a step and the card's
    busy share (_arms_in_turns).  The default arm must take at most half
    the fold's median; ``both`` must beat ``ucomp`` in every round before
    FusedAdam may become the solver's adam (ROADMAP §B.2).  Outside the
    counted windows."""
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    b = torch.as_tensor(rng.randn(100, 100).astype(np.float32), device=dev)
    t = torch.as_tensor(rng.rand(100, 2).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.randn(100, 1).astype(np.float32), device=dev)
    arms, optimizers = {}, {}
    for name, flag in (('fold', False), ('ucomp', True),
                       ('fused_adam', False), ('both', True),
                       ('default', None)):
        model = _flagship_model(dev)
        if name == 'default':
            opt = build_optimizer(dict(optimizer='adam', learning_rate=1e-4),
                                  ARM_ROUNDS * STEP_ARMS_STEPS,
                                  model.parameters())
        elif name in ('fused_adam', 'both'):
            opt = cuda_adam.fused_adam(1e-4).init(model.parameters())
        else:
            opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                                     lambda s: 1e-4)
        optimizers[name] = type(opt).__name__

        def step(model=model, opt=opt, flag=flag):
            with use_ucomp(flag):
                loss = ((model(b, t) - y) ** 2).mean()
                opt.zero_grad()
                loss.backward()
                opt.step()
        arms[name] = step
    out = _arms_in_turns(arms, STEP_ARMS_STEPS)
    for name, arm in out.items():
        arm["optimizer"] = optimizers[name]
    rounds = zip(out['both']['step_ms_rounds'],
                 out['ucomp']['step_ms_rounds'])
    out["fused_adam_beats_compile_every_round"] = all(
        f < c for f, c in rounds)
    out["default_over_fold"] = (out['default']['step_ms']
                                / out['fold']['step_ms'])
    emit({"phase": "step_arms", "batch": 100, "rounds": ARM_ROUNDS,
          "steps_per_round": STEP_ARMS_STEPS, **out})
    check(out["default_over_fold"] <= 0.5,
          f"step_arms: the default arm takes {out['default_over_fold']} "
          f"of the fold's step")
    return out


def phase_serve_ucomp():
    """The served path with USE_UCOMP on: the Advection anchor through
    load_model -> Predictor -> HTTP on `cuda`; returns the launches in
    it."""
    fixture = np.load(FIXTURE)
    fb, ft, fpred = fixture['branch'], fixture['trunk'], fixture['pred']
    tracing.reset()                    # the served path starts here
    with use_ucomp(True):
        model, cfg = load_model(ANCHOR, 100, 2, device='cuda')
        load_err = float(np.abs(predict(model, fb, ft, cfg=cfg)
                                - fpred).max())
        pred = Predictor(ANCHOR, branch_in=100, trunk_in=2, max_batch=8192,
                         device='cuda')
        check(pred.cfg['engine'] == 'pallas', f"engine {pred.cfg['engine']}")
        warm_s = pred.warmup()
        fix_err = float(np.abs(pred.predict(fb, ft) - fpred).max())
        code, resp, stopped = _http_predict(pred, fb, ft)
        http_err = float(np.abs(np.asarray(resp['pred']) - fpred).max())
        torch.cuda.synchronize()
        counts = _counts()             # ... and ends here
    # outside the counted window: each bucket with the toggle on and off,
    # in turns
    bucket_ms = {}
    for rows in (1, 8192):
        bn, tn = (np.zeros((rows, 100), np.float32),
                  np.zeros((rows, 2), np.float32))
        times = {True: [], False: []}
        for _ in range(3):
            for on in (True, False):
                with use_ucomp(on):
                    times[on].append(host_ms(lambda: pred.predict(bn, tn), 10))
        bucket_ms[rows] = {"ucomp_ms": float(np.median(times[True])),
                           "fold_ms": float(np.median(times[False])),
                           "ucomp_rounds": times[True],
                           "fold_rounds": times[False]}
    emit({"phase": "serve_ucomp", "ckpt": os.path.relpath(ANCHOR, REPO),
          "engine": pred.cfg['engine'], "warmup_s": warm_s,
          "load_model_fixture_max_abs_err": load_err,
          "fixture_max_abs_err": fix_err, "http_status": code,
          "http_max_abs_err": http_err, "launches": counts,
          "bucket_request_ms": bucket_ms})
    check(max(load_err, fix_err) <= SERVE_TOL,
          f"serve_ucomp: output differs from the JAX fixture by "
          f"{load_err} / {fix_err}")
    check(code == 200 and http_err <= SERVE_TOL,
          f"serve_ucomp HTTP /predict: status {code}, error {http_err}")
    check(counts["ucomp_fwd"] > 0 and counts["hea_chain_fwd"] > 0,
          f"serve_ucomp: launches {counts}")
    check(counts["ucomp_bwd"] == 0, f"serve_ucomp: a backward ran: {counts}")
    check(stopped, "server thread did not stop")
    return counts


# ── the real-embedding chain (B3f, B3b) and the classical baselines ─────────

EMBED_CASES = [      # (label, qubits, net_size, batch rows N)
    *[('Q5 Net40-2-20-2', 5, (40, 2, 20, 2), n)
      for n in (1, 37, 100, 1000, 1025, 8192)],
    ('Q1 Net2-1-2-1', 1, (2, 1, 2, 1), 37),
    ('Q2 Net5-1-5-1', 2, (5, 1, 5, 1), 1000),
    ('Q3 Net4-2-3-1', 3, (4, 2, 3, 1), 37),
    ('Q4 Net10-2-5-2', 4, (10, 2, 5, 2), 37),
    ('Q6 Net10-2-5-2', 6, (10, 2, 5, 2), 100),
    ('Q7 Net40-2-20-2', 7, (40, 2, 20, 2), 100),
    ('Q7 Net2-1-2-1', 7, (2, 1, 2, 1), 1000),
    ('Q5 one block', 5, (1, 1, 0, 0), 37),
]
CLASSICAL_RUNS = [   # (model type, extra CLI flags)
    ('FNN', ['--net_size', '3', '20']),
    ('DeepONet', ['--net_size', '3', '20', '3', '20']),
    ('FNO', ['--net_size', '15', '14', '3', '32', '--batch_size', '20']),
]
CLASSICAL_EPOCHS = 5


def embed_counts(nb, n, d):
    """Least work of the real-embedding chain as the function is given
    (general E and t): (flops forward, flops backward, bytes forward,
    bytes backward, bytes of the residual u, (nb-1) rows written by the
    forward and read by the backward).  A real (2d x 2d)
    product per row and block is 2 (2d)^2 flops; the phase step 3 flops a
    column (the sincos is not counted).  The backward does two such
    products and the outer product Ebar a block, and 7 flops a column for
    tbar and ubar.  Bytes: each input read once (the backward's: E, t, s,
    u, g), each output written once."""
    w = 2 * d
    prod = 2.0 * nb * n * w * w
    fwd = prod + 3.0 * (nb - 1) * n * w + n * w
    bwd = 3 * prod + 7.0 * (nb - 1) * n * w + 2.0 * n * w
    e_bytes, row_bytes = 4.0 * nb * w * w, 4.0 * n * w
    residual_bytes = (nb - 1) * row_bytes
    fwd_bytes = e_bytes + (nb + 1) * row_bytes
    bwd_bytes = 2 * e_bytes + (2 * nb + 1) * row_bytes + residual_bytes
    return fwd, bwd, fwd_bytes, bwd_bytes, residual_bytes


def embed_bound(nb, n, d):
    """Least time (ms) the card needs for the real-embedding chain's
    forward: the larger of its operations at the fp32 peak and its bytes at
    the HBM rate; -> (ms, bound_by, flops, bytes)."""
    flops, _, nbytes, _, _ = embed_counts(nb, n, d)
    return (*_bound(flops, nbytes), flops, nbytes)


def embed_bwd_bound(nb, n, d):
    """The same for the backward."""
    _, flops, _, nbytes, _ = embed_counts(nb, n, d)
    return (*_bound(flops, nbytes), flops, nbytes)


def _embed_case(nq, net, n, seed, dev):
    """Random general operands at a model's shapes: E with no block
    structure, scaled so the row keeps its size; t with no antisymmetry,
    |t| up to 12 rad; a cotangent."""
    spec = hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(seed)
    w = 2 * spec.dim
    e, t, g = (torch.tensor(a.astype(np.float32), device=dev) for a in (
        rng.randn(spec.n_blocks, w, w) / np.sqrt(w),
        rng.uniform(-12, 12, (spec.n_blocks, n, w)), rng.randn(n, w)))
    return spec, e, t, g


def _embed_geometry(nb, n, d):
    """The launch geometry of the real-embedding chain kernels for
    (nb, N, d) on this card, and the Ebar reduction's slices."""
    sms = cuda_hea.sm_count(torch.cuda.current_device())
    return (cuda_embed.embed_geometry(n, d, sms)._asdict(),
            cuda_embed.ebar_splits(nb, n, 2 * d, sms))


def _embed_expectation(out, d, diag):
    """<H> of the state [re | im] = out, normalised: a general E is not
    unitary and a general t's phase step keeps no norm, so the row is
    brought back to a state before it is measured."""
    sr, si = out[:, :d], out[:, d:]
    norm = (sr * sr + si * si).sum(-1, keepdim=True)
    return hea.diag_expectation_pair(sr, si, diag) / norm


def _embed_geometry_by_case(records):
    """Each kernel_embed* case's shape, launch geometry and Ebar slices."""
    return [{"case": r['case'], "nb": r['nb'], "N": r['N'], "d": r['d'],
             **{k: r['geometry'][k] for k in ('tile', 'rows', 'grid')},
             "ebar_splits": r['ebar_splits']} for r in records]


def phase_kernel_embed():
    """B3f (primal and residual) against chain_embed / chain_embed_saved at
    every case; returns the per-case records."""
    dev = torch.device('cuda')
    records = []
    for label, nq, net, n in EMBED_CASES:
        spec, e, t, _ = _embed_case(nq, net, n, 6000 + 10 * nq + n, dev)
        nb, d = spec.n_blocks, spec.dim
        out = cuda_embed.embed_chain(e, t)
        saved = cuda_embed.embed_forward(e, t, save_residuals=True)
        plain = cuda_embed.chain_embed_saved(e, t)
        torch.cuda.synchronize()
        diag = torch.as_tensor(simple_ham_diag(nq, -5, 5), device=dev)
        err_exp = (_embed_expectation(out, d, diag)
                   - _embed_expectation(plain[0], d, diag)
                   ).abs().max().item()
        reps = 20 if n >= 1000 else 50
        bound_ms, bound_by, flops, nbytes = embed_bound(nb, n, d)
        residual_bytes = embed_counts(nb, n, d)[4]
        geometry, splits = _embed_geometry(nb, n, d)
        rec = {"phase": "kernel_embed", "case": label, "nq": nq, "nb": nb,
               "N": n, "d": d, "geometry": geometry, "ebar_splits": splits,
               "max_abs_err_amp": (out - plain[0]).abs().max().item(),
               "max_abs_err_expect": err_exp,
               "max_abs_err_u": (saved[1] - plain[1]).abs().max().item(),
               "primal_bit_equal": torch.equal(out, saved[0]),
               "ms": time_ms(lambda: cuda_embed.embed_chain(e, t), reps),
               "device_ms": kernel_device_ms(
                   lambda: cuda_embed.embed_chain(e, t), 'embed_chain_fwd'),
               "plain_ms": time_ms(lambda: cuda_embed.chain_embed(e, t), 5),
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes,
               "saved_ms": time_ms(lambda: cuda_embed.embed_forward(
                   e, t, save_residuals=True), reps),
               "saved_plain_ms": time_ms(
                   lambda: cuda_embed.chain_embed_saved(e, t), 5),
               "saved_bound_ms": _bound(flops, nbytes + residual_bytes)[0]}
        rec["share_of_bound"] = bound_ms / rec["ms"]
        emit(rec)
        where = f"embed {label} N={n}"
        check(bool(torch.isfinite(out).all()), f"{where}: output not finite")
        check(rec["max_abs_err_amp"] <= AMP_TOL,
              f"{where}: amplitude error {rec['max_abs_err_amp']}")
        check(err_exp <= EXPECT_TOL, f"{where}: expectation error {err_exp}")
        check(rec["max_abs_err_u"] <= AMP_TOL,
              f"{where}: residual error {rec['max_abs_err_u']}")
        check(rec["primal_bit_equal"], f"{where}: residual variant's output "
                                       f"differs from the primal kernel's")
        records.append(rec)
    return records


def phase_kernel_embed_bwd():
    """B3b against chain_embed_backward at every case; returns the
    per-case records."""
    dev = torch.device('cuda')
    records = []
    for label, nq, net, n in EMBED_CASES:
        spec, e, t, g = _embed_case(nq, net, n, 6500 + 10 * nq + n, dev)
        nb, d = spec.n_blocks, spec.dim
        _, u = cuda_embed.embed_forward(e, t, save_residuals=True)
        got = cuda_embed.embed_backward(e, t, u, g)
        again = cuda_embed.embed_backward(e, t, u, g)
        want = cuda_embed.chain_embed_backward(e, t, u, g)
        torch.cuda.synchronize()
        names = ('ebar', 'tbar')
        errs = {k: (a - b).abs().max().item()
                for k, a, b in zip(names, got, want)}
        scales = {k: max(1.0, b.abs().max().item())
                  for k, b in zip(names, want)}
        reps = 20 if n >= 1000 else 50
        bound_ms, bound_by, flops, nbytes = embed_bwd_bound(nb, n, d)
        geometry, splits = _embed_geometry(nb, n, d)
        rec = {"phase": "kernel_embed_bwd", "case": label, "nq": nq,
               "nb": nb, "N": n, "d": d, "geometry": geometry,
               "ebar_splits": splits,
               "max_abs_err": errs, "scale": scales,
               "bit_equal": all(torch.equal(a, b)
                                for a, b in zip(got, again)),
               "ms": time_ms(lambda: cuda_embed.embed_backward(
                   e, t, u, g), reps),
               "device_ms": kernel_device_ms(
                   lambda: cuda_embed.embed_backward(e, t, u, g), None),
               "plain_ms": time_ms(lambda: cuda_embed.chain_embed_backward(
                   e, t, u, g), 5),
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes}
        rec["share_of_bound"] = bound_ms / rec["ms"]
        emit(rec)
        where = f"embed {label} N={n}"
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"{where}: backward output not finite")
        for k in names:
            check(errs[k] <= BWD_REL_TOL * scales[k],
                  f"{where}: {k} error {errs[k]} > {BWD_REL_TOL} x "
                  f"{scales[k]}")
        check(rec["bit_equal"], f"{where}: two backward calls differ")
        records.append(rec)
    return records


def phase_train_parity_embed(pallas_run):
    """20 Adam steps of the flagship with engine 'embed': the kernels
    against autograd of the plain chain (chain_embed in the kernels'
    place) and against train_parity's 'pallas' run, same initial state,
    batches and schedule."""
    dev = torch.device('cuda')
    inputs, target, idx, schedule = _parity_batches(dev)
    runs, counts = {}, {}
    kernels = cuda_embed.embed_chain
    for name, chain in (('kernels', kernels),
                        ('plain', cuda_embed.chain_embed)):
        model = _flagship_model(dev, engine='embed')
        opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                                 schedule)
        tracing.reset()
        cuda_embed.embed_chain = chain
        try:
            runs[name] = _parity_steps(model, opt, inputs, target, idx)
        finally:
            cuda_embed.embed_chain = kernels
        counts[name] = _counts()
    (lk, pk), (lp, pp) = runs['kernels'], runs['plain']
    ld, pd = pallas_run

    def diffs(la, pa, lb, pb):
        return (max(abs(a - b) / abs(b) for a, b in zip(la, lb)),
                max((pa[k] - pb[k]).abs().max().item() for k in pa))
    vs_plain, vs_pallas = diffs(lk, pk, lp, pp), diffs(lk, pk, ld, pd)
    emit({"phase": "train_parity_embed", "steps": PARITY_STEPS,
          "losses_embed": lk, "losses_plain": lp, "losses_pallas": ld,
          "max_loss_rel_diff_vs_plain": vs_plain[0],
          "max_param_abs_diff_vs_plain": vs_plain[1],
          "max_loss_rel_diff_vs_pallas": vs_pallas[0],
          "max_param_abs_diff_vs_pallas": vs_pallas[1],
          "launches": counts})
    check(all(np.isfinite(lk)), "train_parity_embed: losses not finite")
    for what, (loss_rel, param_err) in (('plain', vs_plain),
                                        ('pallas', vs_pallas)):
        check(loss_rel <= PARITY_LOSS_RTOL,
              f"train_parity_embed: step losses differ from {what} by "
              f"{loss_rel} relative")
        check(param_err <= PARITY_PARAM_TOL,
              f"train_parity_embed: parameters differ from {what} by "
              f"{param_err}")
    on, off = counts['kernels'], counts['plain']
    check(on["embed_chain_fwd"] == on["embed_chain_bwd"] == PARITY_STEPS,
          f"train_parity_embed: launches {on}")
    check(off["embed_chain_fwd"] == off["embed_chain_bwd"] == 0,
          f"train_parity_embed: the plain run launched a kernel: {off}")


def phase_train_embed():
    """The training path with --engine embed: the bench's quick regime for
    QUICK_SEEDS seeds, then one epoch of the CLI; returns the launches in
    it."""
    quick_data()
    tracing.reset()                   # the path starts here
    result = bench.run(bench.parser().parse_args(
        ['--quick', '--runs', str(QUICK_SEEDS), '--engine', 'embed']))
    with tempfile.TemporaryDirectory() as tmp:
        stdout = sys.stdout
        try:
            solver = cli.main([
                '--operator', 'Advection', '--model_type', 'QuanONet',
                '--net_size', '40', '2', '20', '2', '--num_qubits', '5',
                '--scale_coeff', '0.1', '--num_epochs', '1',
                '--num_train', '20', '--num_test', '10',
                '--train_sample_num', '100', '--test_sample_num', '100',
                '--learning_rate', '0.003', '--engine', 'embed', '--prefix',
                os.path.join(tmp, 'outputs'), '--device', 'cuda'])
        finally:
            sys.stdout = stdout
        torch.cuda.synchronize()
        counts = _counts()            # ... and ends here
        exp_dir = solver.exp_logger.exp_dir
        with open(os.path.join(exp_dir, 'metric.json')) as f:
            metrics = json.load(f)['metrics']
        ckpt = os.path.join(exp_dir, 'best_model.ckpt')
        want = solver.predict_test()
        model, cfg = load_model(ckpt, 100, 2, device='cuda', engine='embed')
        got = predict(model, solver.test_inputs[0], solver.test_inputs[1])
        cli_err = float(np.abs(got - want).max())
    emit({"phase": "train_embed", "bench": result,
          "band_rel_l2": QUICK_BAND_REL_L2, "cli_run_id": solver.run_id,
          "cli_engine": solver.model.engine, "reload_engine": cfg['engine'],
          "cli_metrics": metrics, "cli_reload_max_abs_err": cli_err,
          "launches": counts})
    check(result['resolved_engine'] == 'embed'
          and solver.model.engine == 'embed' and cfg['engine'] == 'embed',
          f"train_embed: engines {result['resolved_engine']}, "
          f"{solver.model.engine}, {cfg['engine']}")
    for seed, rel in enumerate(result['rel_l2_runs']):
        check(np.isfinite(rel) and rel <= QUICK_BAND_REL_L2,
              f"train_embed: seed {seed} rel-L2 {rel} outside the band "
              f"{QUICK_BAND_REL_L2}")
    check(all(np.isfinite(v) for v in metrics.values()),
          f"train_embed: CLI metric.json not finite: {metrics}")
    check(cli_err <= CLI_PRED_TOL,
          f"train_embed: reloaded checkpoint predicts {cli_err} off the "
          f"Solver's")
    check(counts["embed_chain_fwd"] > 0 and counts["embed_chain_bwd"] > 0,
          f"train_embed: kernel launches {counts}")
    check(counts["hea_chain_fwd"] == counts["hea_chain_bwd"] == 0,
          f"train_embed: the block-chain kernels ran: {counts}")
    return counts, result


def phase_serve_embed():
    """The served path with engine='embed': the Advection anchor through
    load_model -> Predictor -> HTTP on `cuda`; returns the launches in
    it."""
    fixture = np.load(FIXTURE)
    fb, ft, fpred = fixture['branch'], fixture['trunk'], fixture['pred']
    rng = np.random.RandomState(27)
    reqs = [(rng.randn(n, 100).astype(np.float32),
             rng.rand(n, 2).astype(np.float32)) for n in SERVE_REQUESTS]
    pallas = Predictor(ANCHOR, branch_in=100, trunk_in=2, max_batch=8192,
                       device='cuda')
    refs = [pallas.predict(b, t) for b, t in reqs]
    tracing.reset()                    # the served path starts here
    model, cfg = load_model(ANCHOR, 100, 2, device='cuda', engine='embed')
    load_err = float(np.abs(predict(model, fb, ft, cfg=cfg) - fpred).max())
    pred = Predictor(ANCHOR, branch_in=100, trunk_in=2, max_batch=8192,
                     device='cuda', engine='embed')
    check(pred.cfg['engine'] == 'embed', f"engine {pred.cfg['engine']}")
    warm_s = pred.warmup()
    req_err = []
    for (b, t), ref in zip(reqs, refs):
        out = pred.predict(b, t)
        check(out.shape == (b.shape[0], 1) and np.isfinite(out).all(),
              f"embed request of {b.shape[0]} rows: shape {out.shape} or "
              f"not finite")
        req_err.append(float(np.abs(out - ref).max()))
    fix_err = float(np.abs(pred.predict(fb, ft) - fpred).max())
    code, resp, stopped = _http_predict(pred, fb, ft)
    http_err = float(np.abs(np.asarray(resp['pred']) - fpred).max())
    torch.cuda.synchronize()
    counts = _counts()                 # ... and ends here
    # outside the counted window: each bucket through both engines, in turns
    bucket_ms = {}
    for rows in (1, 8192):
        bn, tn = (np.zeros((rows, 100), np.float32),
                  np.zeros((rows, 2), np.float32))
        times = {'embed': [], 'pallas': []}
        for _ in range(3):
            for name, p in (('embed', pred), ('pallas', pallas)):
                times[name].append(host_ms(lambda: p.predict(bn, tn), 10))
        bucket_ms[rows] = {"embed_ms": float(np.median(times['embed'])),
                           "pallas_ms": float(np.median(times['pallas'])),
                           "embed_rounds": times['embed'],
                           "pallas_rounds": times['pallas']}
    emit({"phase": "serve_embed", "ckpt": os.path.relpath(ANCHOR, REPO),
          "engine": pred.cfg['engine'], "warmup_s": warm_s,
          "requests": list(SERVE_REQUESTS),
          "request_max_abs_err_vs_pallas": req_err,
          "load_model_fixture_max_abs_err": load_err,
          "fixture_max_abs_err": fix_err, "http_status": code,
          "http_max_abs_err": http_err, "launches": counts,
          "bucket_request_ms": bucket_ms})
    check(max(req_err) <= SERVE_TOL,
          f"serve_embed: requests differ from the pallas engine by {req_err}")
    check(max(load_err, fix_err) <= SERVE_TOL,
          f"serve_embed: output differs from the JAX fixture by "
          f"{load_err} / {fix_err}")
    check(code == 200 and http_err <= SERVE_TOL,
          f"serve_embed HTTP /predict: status {code}, error {http_err}")
    check(counts["embed_chain_fwd"] > 0, f"serve_embed: launches {counts}")
    check(counts["embed_chain_bwd"] == counts["hea_chain_fwd"] == 0,
          f"serve_embed: another kernel ran: {counts}")
    check(stopped, "server thread did not stop")
    return counts


def embed_vs_pallas():
    """The flagship's step at batch 100 through 'pallas' and 'embed', in
    turns within this process so that both see the same host: median step
    time over ARM_ROUNDS rounds of ARM_STEPS steps (host clock with a
    synchronise), then each engine's device rows a step, the card's busy
    share under torch.profiler, and the card ms a step of each chain
    kernel (B3f, B3b's launches; B1f, B1b's).  Outside the counted
    windows."""
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    b = torch.as_tensor(rng.randn(100, 100).astype(np.float32), device=dev)
    t = torch.as_tensor(rng.rand(100, 2).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.randn(100, 1).astype(np.float32), device=dev)
    arms = {}
    for engine in ('pallas', 'embed'):
        model = _flagship_model(dev, engine=engine)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)

        def step(model=model, opt=opt):
            loss = ((model(b, t) - y) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        arms[engine] = step
    out = _arms_in_turns(arms)
    for arm in out.values():
        arm["chain_kernels_device_ms_per_step"] = {
            k: v for k, v in (arm["top_device_ms_per_step"] or {}).items()
            if 'chain' in k or 'sum_splits' in k}
    return out


def phase_classical():
    """FNN, DeepONet and FNO through the training CLI on the card, and the
    DeepONet checkpoint through Predictor; returns the launches.  These
    models are plain matrix products (nn.Linear, einsum): no hand-written
    kernel runs here."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tracing.reset()
        for mt, flags in CLASSICAL_RUNS:
            stdout = sys.stdout
            t0 = time.time()
            try:
                solver = cli.main([
                    '--operator', 'Antideriv', '--model_type', mt, *flags,
                    '--num_epochs', str(CLASSICAL_EPOCHS), '--num_train',
                    '100', '--num_test', '20', '--learning_rate', '0.003',
                    '--prefix', os.path.join(tmp, 'outputs'), '--device',
                    'cuda'])
            finally:
                sys.stdout = stdout
            torch.cuda.synchronize()
            with open(os.path.join(solver.exp_logger.exp_dir,
                                   'metric.json')) as f:
                saved = json.load(f)
            runs[mt] = {
                "run_id": solver.run_id, "seconds": time.time() - t0,
                "parameters": sum(p.numel()
                                  for p in solver.model.parameters()),
                "devices": sorted({p.device.type
                                   for p in solver.model.parameters()}),
                "loss_train": saved['history']['loss_train'],
                "rel_l2": saved['metrics']['rel_l2']}
            if mt == 'DeepONet':
                ckpt = os.path.join(solver.exp_logger.exp_dir,
                                    'best_model.ckpt')
                b, t = solver.test_inputs
                pred = Predictor(ckpt, branch_in=b.shape[1],
                                 trunk_in=t.shape[1], max_batch=256,
                                 device='cuda')
                served = pred.predict(b[:300], t[:300])
                model, cfg = load_model(ckpt, b.shape[1], t.shape[1],
                                        device='cuda')
                direct = predict(model, b[:300], t[:300], cfg=cfg)
                runs[mt]["served_max_abs_err_vs_predict"] = float(
                    np.abs(served - direct).max())
                runs[mt]["served_max_abs_err_vs_solver"] = float(
                    np.abs(served - solver.predict_test()[:300]).max())
        counts = _counts()
    emit({"phase": "classical", "epochs": CLASSICAL_EPOCHS,
          "hand_written_kernels": "none: plain matrix products",
          "launches": counts, **runs})
    for mt, r in runs.items():
        losses = r["loss_train"]
        check(len(losses) == CLASSICAL_EPOCHS and all(np.isfinite(losses))
              and losses[-1] < losses[0],
              f"classical {mt}: losses {losses}")
        check(np.isfinite(r["rel_l2"]), f"classical {mt}: rel-L2 not finite")
        check(r["devices"] == ['cuda'],
              f"classical {mt}: parameters on {r['devices']}")
    d = runs['DeepONet']
    check(d["served_max_abs_err_vs_predict"] <= 1e-6
          and d["served_max_abs_err_vs_solver"] <= CLI_PRED_TOL,
          f"classical DeepONet: served prediction off by "
          f"{d['served_max_abs_err_vs_predict']} / "
          f"{d['served_max_abs_err_vs_solver']}")
    check(not any(counts.values()),
          f"classical: a quantum kernel was launched: {counts}")
    return counts


# ── QPU emulation: finite shots, the shift rule, SPSA ───────────────────────

# The shift-rule gradient against autograd's through B4b/B1b on the same
# batch: both are exact, so they differ by fp32 rounding only; a
# relative limit on the largest gradient (at least 1), fixed before the
# phase first ran
SHIFT_GRAD_REL_TOL = 1e-3
# ... and each leaf's largest error within this share of its own largest
# |g| (fixed before that check first ran): the limit above is 1e-3
# absolute whenever max|g| <= 1, loose for a leaf of small gradients
SHIFT_GRAD_LEAF_TOL = 1e-3
QPU_SHOTS = 1000             # --train_shots of the SPSA run
SERVE_SHOTS = 10000          # shots a served prediction
SERVE_SHOT_BUCKET = 100
SERVE_SHOT_REPLAYS = 64
SERVE_SHOT_Z = 5.0           # |mean − exact| / (σ / √replays), each row
INFER_NAME_BAND = 0.25       # the anchor's in-run 0.161 (PERF.md §5) + margin


def shift_launches(spec, chunk=None, steps=1):
    """B4f and B1f launches of ``steps`` shift-rule steps (the forward and
    the backward's fan-out, ops/param_shift.py) at ``chunk``: the forward
    compiles and runs the chain once; the backward compiles the base
    matrices once, the shifted inner blocks once a chunk that has one,
    each of the final block's 2·ld·3·n shifted sets on its own, and runs a
    chain a weight set and one a chunk of input columns."""
    n = spec.n_qubits
    ld = spec.block_configs[0][1]
    n_w, n_x = spec.total_sublayers * 3 * n, spec.n_blocks * n
    step = n_w if not chunk else min(chunk, n_w)
    final = range((spec.n_blocks - 1) * ld * 3 * n, n_w)
    inner_chunks = sum(1 for p0 in range(0, n_w, step)
                       if p0 < final.start)
    xstep = n_x if not chunk else min(chunk, n_x)
    return {"ucomp_fwd": steps * (2 + inner_chunks + 2 * len(final)),
            "hea_chain_fwd": steps * (1 + 2 * n_w + -(-n_x // xstep))}


def _flagship_batch(dev, n=100):
    data = quick_data()
    idx = epoch_permutation(0, 0, data['train_output'].shape[0])[:n].numpy()
    return tuple(torch.as_tensor(data[k][idx], device=dev)
                 for k in ('train_branch_input', 'train_trunk_input',
                           'train_output'))


def _shift_and_autograd(nq, b, t, y):
    """The loss's gradients of a fresh Q``nq`` Net40-2-20-2 (seed 0) on
    one batch, autograd's and the shift rule's: -> {grad_method: (grads,
    launches, backward ms by events, backward peak bytes above what the
    forward left allocated)}."""
    out = {}
    for gm in ('autodiff', 'shift'):
        model = QuanONet(nq, 100, 2, (40, 2, 20, 2), scale_coeff=0.1,
                         grad_method=gm, device='cuda',
                         generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        tracing.reset()
        loss = ((model(b, t) - y) ** 2).mean()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        loss.backward()
        stop.record()
        torch.cuda.synchronize()
        out[gm] = ({k: p.grad for k, p in model.named_parameters()},
                   _counts(), start.elapsed_time(stop),
                   torch.cuda.max_memory_allocated() - base)
    return out


def _leaf_errors(grads, ref):
    """Per leaf: the largest error against ``ref``, the reference's largest
    and median |g| (unclamped)."""
    return {k: {"max_abs_err": (g - ref[k]).abs().max().item(),
                "max_abs_grad": ref[k].abs().max().item(),
                "median_abs_grad": ref[k].abs().median().item()}
            for k, g in grads.items()}


def _shift_grad_checks(label, leaves):
    """The limit on the largest error, SHIFT_GRAD_REL_TOL x max(1,
    max|g|): -> that scale, max(1, max|g|)."""
    scale = max(1.0, max(v["max_abs_grad"] for v in leaves.values()))
    worst = max(v["max_abs_err"] for v in leaves.values())
    check(worst <= SHIFT_GRAD_REL_TOL * scale,
          f"shift_grad {label}: gradients differ from autograd's by {leaves}")
    return scale


def _leaf_passes(leaves):
    """Whether each leaf's error is within SHIFT_GRAD_LEAF_TOL x its own
    max|g|."""
    return {k: v["max_abs_err"] <= SHIFT_GRAD_LEAF_TOL * v["max_abs_grad"]
            for k, v in leaves.items()}


@contextmanager
def _final_block_as_inner():
    """The negative control: the shift rule's final-block sets compiled
    with the Hadamard on, as an inner block would be (last = 0 taken as
    -1), in param_shift alone."""
    real = param_shift._ucomp

    class Planted:
        @staticmethod
        def ucomp(w, ld, last):
            return real.ucomp(w, ld, -1 if last == 0 else last)
    param_shift._ucomp = Planted
    try:
        yield
    finally:
        param_shift._ucomp = real


def phase_shift_grad():
    """The flagship's shift-rule gradient on the card against autograd's
    (B4b, B1b) on the same batch of 100, each leaf also against its own
    size; the planted wrong final-block compile must fail that; the same
    at Q7; the backward's time and peak memory.  Returns the launches of
    the flagship's shift step's forward and backward."""
    b, t, y = _flagship_batch(torch.device('cuda'))
    rec = {"phase": "shift_grad", "batch": 100,
           "limit_rel": SHIFT_GRAD_REL_TOL,
           "leaf_limit_rel": SHIFT_GRAD_LEAF_TOL}
    got = None
    for nq in (5, 7):
        label = f"Q{nq} Net40-2-20-2"
        runs = _shift_and_autograd(nq, b, t, y)
        ref = runs['autodiff'][0]
        leaves = _leaf_errors(runs['shift'][0], ref)
        scale = _shift_grad_checks(label, leaves)
        passes = _leaf_passes(leaves)
        spec = hea.quanonet_spec(nq, (40, 2, 20, 2))
        want = shift_launches(spec)
        counts = runs['shift'][1]
        case = {"evaluations": 1 + 2 * spec.total_sublayers * 3 * nq
                + 2 * spec.total_encode,
                "leaves": leaves, "max_abs_grad_clamped": scale,
                "limit": SHIFT_GRAD_REL_TOL * scale,
                "leaf_passes": passes, "launches": counts,
                "expected_launches": want,
                "autodiff_launches": runs['autodiff'][1],
                "backward_ms": {gm: r[2] for gm, r in runs.items()},
                "backward_peak_bytes": {gm: r[3] for gm, r in runs.items()}}
        check(all(passes.values()),
              f"shift_grad {label}: a leaf's error exceeds "
              f"{SHIFT_GRAD_LEAF_TOL} x its max|g|: {leaves}")
        check(counts["hea_chain_bwd"] == counts["ucomp_bwd"] == 0
              and counts["hea_chain_fwd"] == want["hea_chain_fwd"]
              and counts["ucomp_fwd"] == want["ucomp_fwd"],
              f"shift_grad {label}: launches {counts}, expected {want}")
        if nq == 5:
            got = counts
            with _final_block_as_inner():
                planted = _shift_and_autograd(5, b, t, y)['shift'][0]
            bad = _leaf_errors(planted, ref)
            case["planted_final_block"] = {
                "leaves": bad, "leaf_passes": _leaf_passes(bad),
                "fails_limit": max(v["max_abs_err"] for v in bad.values())
                > SHIFT_GRAD_REL_TOL * scale}
            check(not _leaf_passes(bad)["ansatz"],
                  f"shift_grad: the planted final-block compile passes the "
                  f"leaf check: {bad['ansatz']}")
        rec[label] = case
    emit(rec)
    return got


def _qpu_step(model, spsa_c=None):
    """One step of the solver's own epoch (make_train_epoch) on one batch
    of 100 of the flagship's data: -> step()."""
    from quanonet_torch.solver import make_train_epoch
    b, t, y = _flagship_batch(torch.device('cuda'))
    opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                             lambda s: 1e-3)
    epoch = make_train_epoch(model, opt, 100, 100, 1, seed=0, spsa_c=spsa_c)
    perm = torch.arange(100)
    count = iter(range(10 ** 6))
    return lambda: epoch(perm, (b, t), y, next(count))


def qpu_steps():
    """ms a training step by CUDA events, evaluations a step and the
    card's busy share: autograd (the default), the shift rule exact and
    with QPU_SHOTS shots, SPSA with QPU_SHOTS shots.  The shift rule with
    shots launches ~320,000 kernels a step (a generator and a binomial
    chain an evaluation): it is timed over one step and not profiled, a
    trace of that size takes minutes to read.  Outside the counted
    windows."""
    dev = torch.device('cuda')
    spec = hea.quanonet_spec(*FLAGSHIP)
    evals = 1 + 2 * spec.total_sublayers * 3 * spec.n_qubits \
        + 2 * spec.total_encode
    arms = {"autodiff": (dict(), None, 1, 10),
            "shift": (dict(grad_method='shift'), None, evals, 2),
            "shift_shots": (dict(grad_method='shift', shots=QPU_SHOTS),
                            None, evals, 1),
            "spsa_shots": (dict(shots=QPU_SHOTS), 0.05, 2, 10)}
    out = {}
    for name, (kw, spsa_c, n_evals, reps) in arms.items():
        model = QuanONet(5, 100, 2, (40, 2, 20, 2), scale_coeff=0.1,
                         device=dev, **kw,
                         generator=torch.Generator().manual_seed(0))
        step = _qpu_step(model, spsa_c)
        t0 = time.time()
        rec = {"ms": time_ms(step, reps), "evaluations": n_evals,
               "reps": reps}
        if name != "shift_shots":
            rec["host_ms"] = host_ms(step, reps)
            prof = profile_steps(step, reps, warm=1)
            rec.update({k: prof.get(k) for k in (
                "device_busy_share", "device_busy_ms",
                "device_kernels_per_step", "profiler_error")})
        rec["seconds"] = time.time() - t0
        out[name] = rec
    return out


def _cli_qpu(tmp, extra):
    """Three steps (300 samples, batch 100) of the training CLI at the
    flagship's width with the flags ``extra``; -> (solver, launches)."""
    stdout = sys.stdout
    tracing.reset()                   # the path starts here
    try:
        solver = cli.main([
            '--operator', 'Advection', '--model_type', 'QuanONet',
            '--net_size', '40', '2', '20', '2', '--num_qubits', '5',
            '--scale_coeff', '0.1', '--num_epochs', '1', '--num_train', '3',
            '--num_test', '5', '--train_sample_num', '100',
            '--test_sample_num', '100', '--batch_size', '100',
            '--learning_rate', '0.003', '--prefix',
            os.path.join(tmp, 'outputs'), '--device', 'cuda', *extra])
    finally:
        sys.stdout = stdout
    torch.cuda.synchronize()
    return solver, _counts()          # ... and ends here


def phase_train_qpu():
    """train_shift and train_spsa: three steps each through the CLI at
    full width; the checkpoint loads in infer.  Returns the launches of
    each path."""
    spec = hea.quanonet_spec(*FLAGSHIP)
    paths = {"train_shift": (['--grad_method', 'shift'], '_Shift_'),
             "train_spsa": (['--grad_method', 'spsa', '--train_shots',
                             str(QPU_SHOTS)], f'_SpsaSh{QPU_SHOTS}_')}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for path, (extra, tag) in paths.items():
            solver, counts = _cli_qpu(tmp, extra)
            exp_dir = solver.exp_logger.exp_dir
            with open(os.path.join(exp_dir, 'metric.json')) as f:
                saved = json.load(f)
            model, cfg = load_model(os.path.join(exp_dir, 'best_model.ckpt'),
                                    100, 2, device='cuda')
            b, t = solver.test_inputs
            reloaded = predict(model, b, t, cfg=cfg)
            # evaluation: one chunk of the 500 test rows, compiled and run
            if path == 'train_shift':
                want = shift_launches(spec, steps=3)
                want = {k: v + 1 for k, v in want.items()}
                exact = solver.predict_test()
            else:
                want = {"ucomp_fwd": 2 * 3 + 1, "hea_chain_fwd": 2 * 3 + 1}
                exact = None
            rec = {"run_id": solver.run_id,
                   "loss_train": saved['history']['loss_train'],
                   "metrics": saved['metrics'], "launches": counts,
                   "expected_launches": want,
                   "reload_max_abs_err": (
                       float(np.abs(reloaded - exact).max())
                       if exact is not None else None)}
            emit({"phase": path, **rec})
            check(tag in solver.run_id, f"{path}: run ID {solver.run_id}")
            check(len(rec["loss_train"]) == 1
                  and all(np.isfinite(rec["loss_train"]))
                  and np.isfinite(saved['metrics']['rel_l2']),
                  f"{path}: loss or metrics not finite: {rec}")
            check(reloaded.shape == (b.shape[0], 1)
                  and np.isfinite(reloaded).all(),
                  f"{path}: the checkpoint does not predict in infer")
            check(exact is None or rec["reload_max_abs_err"] <= CLI_PRED_TOL,
                  f"{path}: reloaded checkpoint off by "
                  f"{rec['reload_max_abs_err']}")
            check(counts["hea_chain_bwd"] == counts["ucomp_bwd"]
                  == counts["fused_chain_bwd"] == counts["adam_step"] == 0
                  and all(counts[k] == v for k, v in want.items()),
                  f"{path}: launches {counts}, expected {want}")
            out[path] = counts
    emit({"phase": "qpu_steps", "batch": 100, **qpu_steps()})
    return out


def _serve_shots(label, ckpt, engine, rows):
    """A bucket of SERVE_SHOT_BUCKET rows at SERVE_SHOTS shots, replayed
    SERVE_SHOT_REPLAYS times with distinct seeds, against the exact
    prediction and shot_noise_std; -> (record, launches)."""
    from quanonet_torch.ops import sampling
    b, t = rows
    exact_pred = Predictor(ckpt, branch_in=100, trunk_in=2,
                           max_batch=SERVE_SHOT_BUCKET, device='cuda')
    exact = exact_pred.predict(b, t)
    torch.cuda.synchronize()
    tracing.reset()                   # the served path starts here
    pred = Predictor(ckpt, branch_in=100, trunk_in=2,
                     max_batch=SERVE_SHOT_BUCKET, device='cuda',
                     shots=SERVE_SHOTS, shot_seed=7)
    outs = np.stack([pred.predict(b, t)
                     for _ in range(SERVE_SHOT_REPLAYS)])
    torch.cuda.synchronize()
    counts = _counts()                # ... and ends here
    replay = Predictor(ckpt, branch_in=100, trunk_in=2,
                       max_batch=SERVE_SHOT_BUCKET, device='cuda',
                       shots=SERVE_SHOTS, shot_seed=7).predict(b, t)
    model = pred.model
    with torch.inference_mode():
        bt, tt = (torch.as_tensor(a, device='cuda') for a in (b, t))
        x = torch.cat([model.trunk_freq(tt), model.branch_freq(bt)], dim=1)
        sr, si = hea.hea_forward_pair(model.spec, model.ansatz, x,
                                      engine=model.engine)
        std = sampling.shot_noise_std(sr, si, model.measure.diag,
                                      SERVE_SHOTS).cpu().numpy()
    diff = np.abs(outs.mean(0) - exact)
    se = std / np.sqrt(SERVE_SHOT_REPLAYS)
    z = np.where(se > 0, diff / np.where(se > 0, se, 1.0),
                 np.where(diff > 0, np.inf, 0.0))
    # bucket latency, the exact and the sampled path in turns
    lat = {"exact": [], "shots": []}
    for _ in range(5):
        for name, p in (("exact", exact_pred), ("shots", pred)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.predict(b, t)
            torch.cuda.synchronize()
            lat[name].append(1e3 * (time.perf_counter() - t0))
    rec = {"case": label, "engine": pred.cfg['engine'],
           "bucket": SERVE_SHOT_BUCKET, "shots": SERVE_SHOTS,
           "replays": SERVE_SHOT_REPLAYS, "max_z": float(z.max()),
           "mean_z": float(z.mean()), "limit_z": SERVE_SHOT_Z,
           "max_abs_mean_err": float(diff.max()),
           "max_shot_noise_std": float(std.max()),
           "replay_bit_equal": bool(np.array_equal(replay, outs[0])),
           "replays_distinct": bool(not np.array_equal(outs[0], outs[1])),
           "bucket_latency_ms": {k: float(np.median(v))
                                 for k, v in lat.items()},
           "bucket_latency_ms_rounds": lat, "launches": counts}
    check(pred.cfg['engine'] == engine, f"{label}: engine {rec['engine']}")
    check(rec["max_z"] <= SERVE_SHOT_Z,
          f"{label}: shot means off by z = {rec['max_z']}")
    check(rec["replay_bit_equal"] and rec["replays_distinct"],
          f"{label}: replay {rec['replay_bit_equal']}, distinct "
          f"{rec['replays_distinct']}")
    return rec, counts


def phase_serve_shots():
    """serve_shots (Q5, the anchor: B4f, B1f) and serve_shots_q10 (the
    seeded Q10 checkpoint: B2f); returns the launches of each path."""
    rng = np.random.RandomState(31)
    rows = (rng.randn(SERVE_SHOT_BUCKET, 100).astype(np.float32),
            rng.rand(SERVE_SHOT_BUCKET, 2).astype(np.float32))
    rec, q5 = _serve_shots('Q5 anchor', ANCHOR, 'pallas', rows)
    emit({"phase": "serve_shots", **rec})
    check(q5["hea_chain_fwd"] > 0 and q5["ucomp_fwd"] > 0
          and q5["hea_chain_bwd"] == q5["ucomp_bwd"] == 0,
          f"serve_shots: launches {q5}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = _q10_checkpoint(tmp)[0]
        rec, q10 = _serve_shots('Q10 seeded', ckpt, 'pfused', rows)
    emit({"phase": "serve_shots_q10", **rec})
    check(q10["fused_chain_fwd"] > 0 and q10["fused_chain_bwd"] == 0
          and q10["hea_chain_fwd"] == 0,
          f"serve_shots_q10: launches {q10}")
    return q5, q10


MULTISEED_ARGV = ['--operator', 'Advection', '--model_type', 'QuanONet',
                  '--net_size', '40', '2', '20', '2', '--num_qubits', '5',
                  '--scale_coeff', '0.1', '--num_epochs', '10',
                  '--num_train', '200', '--num_test', '100',
                  '--train_sample_num', '100', '--test_sample_num', '100',
                  '--learning_rate', '0.003', '--device', 'cuda']
# the multi-seed phases' runs, cut from the quick regime's 10 epochs
MULTISEED_EPOCHS = 3
MULTISEED_CUT_ARGV = MULTISEED_ARGV + ['--num_epochs', str(MULTISEED_EPOCHS)]


def _cli(argv):
    """cli.main(argv) with sys.stdout restored after it (the solver
    redirects it to its log)."""
    stdout = sys.stdout
    try:
        return cli.main(argv)
    finally:
        sys.stdout = stdout


def _sequential(argv):
    """The sequential route of --multi_seed (multiseed.
    train_seeds_sequential) for the CLI flags ``argv``, seeded as the CLI
    seeds it."""
    config = load_config(get_base_parser().parse_args(argv))
    set_random_seed(config.get('seed', 0))
    stdout = sys.stdout
    try:
        return multiseed.train_seeds_sequential(config)
    finally:
        sys.stdout = stdout


def phase_multiseed():
    """The sequential route of --multi_seed 0 1 in the quick regime against
    two single runs of the CLI: each seed's metric.json equal (but the
    wall-clock rate); the rerun skips.  Returns the launches of the
    multi-seed run."""
    argv = MULTISEED_CUT_ARGV

    def run(args):
        if '--multi_seed' in args:
            return _sequential(argv + args)
        return _cli(argv + args)

    def saved(prefix, seed):
        base = os.path.join(prefix, 'Advection')
        (d,) = [r for r in os.listdir(base) if r.endswith(f'_Seed{seed}')]
        with open(os.path.join(base, d, 'metric.json')) as f:
            m = json.load(f)
        m['metrics'].pop('train_samples_per_sec', None)
        return m
    with tempfile.TemporaryDirectory() as tmp:
        single, multi = (os.path.join(tmp, 'single'),
                         os.path.join(tmp, 'multi'))
        for seed in (0, 1):
            run(['--seed', str(seed), '--prefix', single])
        torch.cuda.synchronize()
        tracing.reset()               # the multi-seed path starts here
        t0 = time.time()
        result = run(['--multi_seed', '0', '1', '--prefix', multi])
        torch.cuda.synchronize()
        counts = _counts()            # ... and ends here
        seconds = time.time() - t0
        equal = {s: saved(single, s) == saved(multi, s) for s in (0, 1)}
        rerun = run(['--multi_seed', '0', '1', '--prefix', multi])
    emit({"phase": "multiseed", "route": "sequential", "seeds": [0, 1],
          "seconds": seconds,
          "rel_l2": {s: result[s]['rel_l2'] for s in (0, 1)},
          "equal_to_single_runs": equal, "rerun": rerun,
          "launches": counts})
    check(all(equal.values()),
          f"multiseed: a seed differs from its single run: {equal}")
    check(rerun == {0: None, 1: None}, f"multiseed: rerun trained {rerun}")
    check(counts["hea_chain_fwd"] > 0 and counts["ucomp_fwd"] > 0,
          f"multiseed: launches {counts}")
    return counts


def phase_infer_from_name():
    """The Advection anchor scored by the infer CLI without --data: the
    test set generated from its directory's name (NumPy seed 0) into the
    repository's data cache.  Returns the launches."""
    here = os.getcwd()
    os.chdir(REPO)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            np.random.seed(0)
            torch.cuda.synchronize()
            tracing.reset()           # the path starts here
            t0 = time.time()
            preds = infer_main(['--ckpt', ANCHOR, '--device', 'cuda',
                                '--output', os.path.join(tmp, 'o.npz')])
            torch.cuda.synchronize()
            counts = _counts()        # ... and ends here
            seconds = time.time() - t0
            with np.load(os.path.join(tmp, 'o.npz')) as z:
                rel = float(z['rel_l2'])
    finally:
        os.chdir(here)
    emit({"phase": "infer_from_name", "rows": int(preds.shape[0]),
          "rel_l2": rel, "band": INFER_NAME_BAND, "seconds": seconds,
          "launches": counts})
    check(np.isfinite(preds).all() and rel <= INFER_NAME_BAND,
          f"infer_from_name: rel-L2 {rel}")
    check(counts["hea_chain_fwd"] > 0 and counts["ucomp_fwd"] > 0,
          f"infer_from_name: launches {counts}")
    return counts


# ── QPU emulation part 2: noise trajectories, ZNE, T1/T2 ────────────────────
NOISE_P = 0.01               # the depolarizing prob of the noise paths
# ... and of the training path: at 0.01 the flagship's 300 error sites
# swamp the signal (a first card run read a loss going 0.957 -> 0.821 over
# 20 steps, swinging by 0.1 between steps); at 0.001 it falls clearly
NOISE_TRAIN_P = 0.001
NOISE_TRAJ = 32              # infer's default trajectories
NOISE_TRAIN_TRAJ = 8         # the solver's default in training
NOISE_TRAIN_STEPS = 20
NOISE_KERNEL_ROWS = (100, 20000)   # the training batch, infer's batch
ZNE_GATE_TRAJ = 256          # tests/test_mitigation.py's prediction case


def _noise_patterns(nb, n, dev):
    """kernel_noise's trajectories: X, Y and Z on every qubit of the first,
    an inner and the last block, then one random pattern (an error on each
    site with prob 0.3): a, b (10, nb, n)."""
    a, b = [], []
    for pauli in 'XYZ':
        for blk in (0, nb // 2, nb - 1):
            at = torch.zeros((nb, n), dtype=torch.bool)
            bt = torch.zeros((nb, n), dtype=torch.bool)
            at[blk], bt[blk] = pauli in 'XY', pauli in 'YZ'
            a.append(at)
            b.append(bt)
    ra, rb = noise.sample_pauli_masks(torch.Generator().manual_seed(13), 0.3,
                                      nb, n)
    return (torch.stack(a + [ra]).to(dev), torch.stack(b + [rb]).to(dev))


def _fold_rows(mt_r, mt_i, a, b):
    """The negative control: the Paulis folded on the wrong side of U_b,
    into the rows of the transposed block matrices (the Pauli before
    U_b)."""
    fr, fi = noise.fold_paulis(mt_r.transpose(1, 2), mt_i.transpose(1, 2),
                               a, b)
    return fr.transpose(2, 3).contiguous(), fi.transpose(2, 3).contiguous()


def _err(got, want):
    return (got - want).abs().max().item()


def _expect(sr, si, diag):
    return ((sr * sr + si * si) * diag).sum(-1)


def _noise_grads(spec, w0, x0, a, b, diag, kernels):
    """Gradients (w̄, x̄) of Σ E² over the trajectories: through B4f/B1f
    with B1b/B4b (``kernels``), else autograd of the plain fold and chain;
    -> (grads, launches)."""
    w = w0.clone().requires_grad_()
    x = x0.clone().requires_grad_()
    torch.cuda.synchronize()
    tracing.reset()
    if kernels:
        sr, si = noise.fold_states(*cuda_hea._prepare(spec, w, x), a, b)
    else:
        sr, si = noise.fold_states(*hea.prepare_chain(spec, w, x), a, b,
                                   chain=hea.chain_dense)
    (_expect(sr, si, diag) ** 2).sum().backward()
    torch.cuda.synchronize()
    return (w.grad, x.grad), _counts()


def phase_kernel_noise():
    """The fold route at the flagship (Q5 Net40-2-20-2) at N = 100 and
    20,000: each trajectory's folded matrices through B1f against the
    physical-frame forward (noise.plain_states) for the same masks and
    against the plain chain on them; the gradients through B1b/B4b against
    plain autograd at N = 100; two calls bit-equal; the wrong-side fold
    must fail the amplitude limit; the 32 trajectories of a noisy forward
    timed on both routes."""
    dev = torch.device('cuda')
    spec = hea.quanonet_spec(*FLAGSHIP)
    nq, nb, d = spec.n_qubits, spec.n_blocks, spec.dim
    diag = torch.as_tensor(simple_ham_diag(nq, -5, 5), device=dev)
    a, b = _noise_patterns(nb, nq, dev)
    a32, b32 = (torch.stack(m) for m in zip(*[
        noise.sample_pauli_masks(torch.Generator().manual_seed(100 + t),
                                 NOISE_P, nb, nq) for t in range(NOISE_TRAJ)]))
    a32, b32 = a32.to(dev), b32.to(dev)
    rec = {"phase": "kernel_noise", "case": "Q5 Net40-2-20-2",
           "trajectories": int(a.shape[0]), "amp_limit": AMP_TOL,
           "expect_limit": EXPECT_TOL, "grad_limit_rel": BWD_REL_TOL}
    for n in NOISE_KERNEL_ROWS:
        rng = np.random.RandomState(7000 + n)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        x = torch.tensor(rng.uniform(-4, 4, (n, spec.total_encode))
                         .astype(np.float32), device=dev)
        with torch.no_grad():
            ops = cuda_hea._prepare(spec, w, x)
            torch.cuda.synchronize()
            tracing.reset()
            kr, ki = noise.fold_states(*ops, a, b)
            torch.cuda.synchronize()
            launches = _counts()["hea_chain_fwd"]
            kr2, ki2 = noise.fold_states(*ops, a, b)
            ur, ui = hea.compile_block_unitaries(spec, w)
            utr, uti = ur.transpose(1, 2), ui.transpose(1, 2)
            xb = x.reshape(n, nb, nq).transpose(0, 1)
            pr, pi = noise.plain_states(spec, utr, uti, xb, a, b)
            dr, di = noise.fold_states(*ops, a, b, chain=hea.chain_dense)
            wr, wi = _fold_rows(ops[0], ops[1], a[-1:], b[-1:])
            cr, ci = cuda_hea.block_chain(wr[0], wi[0], ops[2])
            torch.cuda.synchronize()
            case = {
                "N": n, "B1f_launches": launches,
                "max_abs_err_amp": max(_err(kr, pr), _err(ki, pi)),
                "max_abs_err_amp_plain_chain": max(_err(kr, dr),
                                                   _err(ki, di)),
                "max_abs_err_expect": _err(_expect(kr, ki, diag),
                                               _expect(pr, pi, diag)),
                "bit_equal": bool(torch.equal(kr, kr2)
                                  and torch.equal(ki, ki2)),
                "wrong_side_max_abs_err": max(_err(cr, pr[-1]),
                                              _err(ci, pi[-1]))}
            ops_k = ops
            case["trajectories_32"] = {
                "ms": time_ms(lambda: noise.fold_states(*ops_k, a32, b32),
                              10),
                "plain_ms": time_ms(lambda: noise.plain_states(
                    spec, utr, uti, xb, a32, b32), 3),
                "bound_ms": NOISE_TRAJ * chain_bound(nb, n, d)[0]}
        if n == NOISE_KERNEL_ROWS[0]:
            gk, lk = _noise_grads(spec, w, x, a, b, diag, True)
            gk2, _ = _noise_grads(spec, w, x, a, b, diag, True)
            gp, _ = _noise_grads(spec, w, x, a, b, diag, False)
            scale = max(1.0, max(g.abs().max().item() for g in gp))
            case.update({
                "grad_max_abs_err": max(_err(k, p)
                                        for k, p in zip(gk, gp)),
                "grad_scale": scale, "grad_launches": lk,
                "grad_bit_equal": all(torch.equal(u, v)
                                      for u, v in zip(gk, gk2))})
            check(case["grad_max_abs_err"] <= BWD_REL_TOL * scale,
                  f"kernel_noise: gradients off by {case['grad_max_abs_err']}")
            check(case["grad_bit_equal"], "kernel_noise: gradients differ "
                  "between two calls")
            t = int(a.shape[0])
            check(lk["hea_chain_fwd"] == lk["hea_chain_bwd"] == t
                  and lk["ucomp_fwd"] == lk["ucomp_bwd"] == 1,
                  f"kernel_noise: gradient launches {lk}")
        rec[f"N={n}"] = case
        check(launches == a.shape[0], f"kernel_noise: {launches} B1f "
              f"launches for {a.shape[0]} trajectories")
        check(case["max_abs_err_amp"] <= AMP_TOL
              and case["max_abs_err_amp_plain_chain"] <= AMP_TOL,
              f"kernel_noise N={n}: amplitudes off: {case}")
        check(case["max_abs_err_expect"] <= EXPECT_TOL,
              f"kernel_noise N={n}: expectation off: {case}")
        check(case["bit_equal"], f"kernel_noise N={n}: two calls differ")
        check(case["wrong_side_max_abs_err"] > AMP_TOL,
              f"kernel_noise N={n}: the wrong-side fold passes: {case}")
    emit(rec)


def _path_timing(fn, reps):
    """CUDA-event ms, device rows and the busy share of fn()."""
    prof = profile_steps(fn, reps, warm=1)
    return {"ms": time_ms(fn, reps), "reps": reps,
            **{k: prof.get(k) for k in ("device_busy_share",
                                        "device_busy_ms",
                                        "device_kernels_per_step",
                                        "profiler_error")}}


def _routes_since(before):
    return {k: v - before[k] for k, v in noise.routes.items()}


def _served(**kw):
    return Predictor(ANCHOR, branch_in=100, trunk_in=2, max_batch=100,
                     device='cuda', shot_seed=7, **kw)


def phase_noise_paths():
    """The anchor's noisy forward at bucket 100 (32 trajectories), its ZNE
    with scales (1, 2), a damping case (the plain route), and 20
    noise-aware training steps of the flagship at batch 100 with 8
    trajectories (NOISE_TRAIN_P): each path's launches by kernel and
    route counter, then (outside the counted window) its CUDA-event ms,
    device rows and busy share.  Returns the launches of each path."""
    from quanonet_torch.infer import zne_predict
    from quanonet_torch.solver import make_train_epoch
    rng = np.random.RandomState(41)
    b = rng.randn(100, 100).astype(np.float32)
    t = rng.rand(100, 2).astype(np.float32)
    exact = _served().predict(b, t)
    out, rec = {}, {"phase": "noise_paths", "bucket": 100,
                    "noise_p": NOISE_P}

    def counted(fn):
        torch.cuda.synchronize()
        r0 = dict(noise.routes)
        tracing.reset()               # the path starts here
        val = fn()
        torch.cuda.synchronize()
        return val, _counts(), _routes_since(r0)   # ... and ends here

    pred = _served(noise_p=NOISE_P, noise_traj=NOISE_TRAJ)
    noisy, c, r = counted(lambda: pred.predict(b, t))
    replay = _served(noise_p=NOISE_P, noise_traj=NOISE_TRAJ).predict(b, t)
    rec["forward"] = {"trajectories": NOISE_TRAJ, "launches": c, "routes": r,
                      "replay_bit_equal": bool(np.array_equal(noisy, replay)),
                      "max_abs_diff_from_exact": float(
                          np.abs(noisy - exact).max()),
                      **_path_timing(lambda: pred.predict(b, t), 10)}
    out["noise_forward"] = c
    check(rec["forward"]["replay_bit_equal"], "noise_paths: the noisy "
          "forward does not replay")
    check(r == {"fold": 1, "plain": 0} and c["hea_chain_fwd"] == NOISE_TRAJ
          and c["ucomp_fwd"] == 1, f"noise_paths forward: {c}, {r}")

    def zne():
        return zne_predict(pred.model, b, t, cfg=pred.cfg,
                           scales=(1.0, 2.0), shot_seed=7)
    z, c, r = counted(zne)
    rec["zne"] = {"scales": [1.0, 2.0], "trajectories": NOISE_TRAJ,
                  "launches": c, "routes": r,
                  "replay_bit_equal": bool(np.array_equal(z, zne())),
                  "max_abs_diff_from_exact": float(np.abs(z - exact).max()),
                  **_path_timing(zne, 5)}
    out["noise_zne"] = c
    check(rec["zne"]["replay_bit_equal"], "noise_paths: ZNE does not replay")
    check(r == {"fold": 1, "plain": 0}
          and c["hea_chain_fwd"] == 2 * NOISE_TRAJ and c["ucomp_fwd"] == 1,
          f"noise_paths zne: {c}, {r}")

    damp = _served(damp_gamma=0.01, noise_traj=NOISE_TRAIN_TRAJ)
    dval, c, r = counted(lambda: damp.predict(b, t))
    rec["damping"] = {"damp_gamma": 0.01, "trajectories": NOISE_TRAIN_TRAJ,
                      "launches": c, "routes": r,
                      "finite": bool(np.isfinite(dval).all()),
                      **_path_timing(lambda: damp.predict(b, t), 1)}
    out["noise_damping"] = c
    check(r == {"fold": 0, "plain": 1} and rec["damping"]["finite"]
          and not any(c.values()), f"noise_paths damping: {c}, {r}")

    dev = torch.device('cuda')
    bt, tt, yt = _flagship_batch(dev)
    model = QuanONet(5, 100, 2, (40, 2, 20, 2), scale_coeff=0.1,
                     noise_p=NOISE_TRAIN_P, noise_traj=NOISE_TRAIN_TRAJ,
                     device=dev, generator=torch.Generator().manual_seed(0))
    opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                             lambda s: 3e-3)
    epoch = make_train_epoch(model, opt, 100, 100, 1, seed=0)
    perm = torch.arange(100)
    count = iter(range(10 ** 6))

    def step():
        return epoch(perm, (bt, tt), yt, next(count))[0]
    losses, c, r = counted(lambda: [step().item()
                                    for _ in range(NOISE_TRAIN_STEPS)])
    k = NOISE_TRAIN_STEPS * NOISE_TRAIN_TRAJ
    rec["train"] = {"steps": NOISE_TRAIN_STEPS, "noise_p": NOISE_TRAIN_P,
                    "trajectories": NOISE_TRAIN_TRAJ, "loss": losses,
                    "launches": c, "routes": r,
                    **_path_timing(step, 10)}
    out["noise_train"] = c
    check(np.isfinite(losses).all() and losses[-1] < losses[0]
          and np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"noise_paths train: loss {losses}")
    check(r == {"fold": NOISE_TRAIN_STEPS, "plain": 0}
          and c["hea_chain_fwd"] == c["hea_chain_bwd"] == k
          and c["ucomp_fwd"] == c["ucomp_bwd"] == NOISE_TRAIN_STEPS,
          f"noise_paths train: launches {c}, routes {r}")
    emit(rec)
    return out


def _zne_gate_q2():
    """tests/test_mitigation.py's prediction case on the card: Q2, noise
    0.1, 256 trajectories, scales (1, 2); ZNE must land nearer the ideal
    than the noisy value."""
    from quanonet_torch.infer import zne_predict
    kw = dict(num_qubits=2, branch_input_size=5, trunk_input_size=2,
              net_size=(2, 1, 2, 1), scale_coeff=0.1, device='cuda')
    rng = np.random.RandomState(4)
    b = rng.randn(6, 5).astype(np.float32)
    t = rng.rand(6, 2).astype(np.float32)
    cfg = {'model_type': 'QuanONet'}
    ideal_model = QuanONet(**kw, generator=torch.Generator().manual_seed(0))
    ideal = predict(ideal_model, b, t, cfg=cfg)
    noisy_model = QuanONet(**kw, noise_p=0.1, noise_traj=ZNE_GATE_TRAJ)
    noisy_model.load_state_dict(ideal_model.state_dict())
    noisy = predict(noisy_model, b, t, cfg=cfg, shot_seed=1)
    zne = zne_predict(noisy_model, b, t, cfg=cfg, scales=(1.0, 2.0),
                      shot_seed=1)
    return {"noisy_l2_from_ideal": float(np.linalg.norm(noisy - ideal)),
            "zne_l2_from_ideal": float(np.linalg.norm(zne - ideal))}


def phase_infer_noise():
    """The Advection anchor scored from its name by the infer CLI three
    ways: exact, --noise_p 0.01 --noise_traj 32, and --zne 1 2 on that
    channel (a record: 300 error sites may be past what 2-point ZNE
    recovers); then the Q2 ZNE gate.  Returns the launches."""
    here = os.getcwd()
    os.chdir(REPO)
    runs = {"exact": [],
            "noise": ['--noise_p', str(NOISE_P), '--noise_traj',
                      str(NOISE_TRAJ)]}
    runs["zne"] = runs["noise"] + ['--zne', '1', '2']
    rel, seconds = {}, {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            r0 = dict(noise.routes)
            tracing.reset()           # the path starts here
            for name, extra in runs.items():
                np.random.seed(0)
                t0 = time.time()
                preds = infer_main(['--ckpt', ANCHOR, '--device', 'cuda',
                                    '--output',
                                    os.path.join(tmp, f'{name}.npz'),
                                    *extra])
                torch.cuda.synchronize()
                seconds[name] = time.time() - t0
                check(np.isfinite(preds).all(),
                      f"infer_noise {name}: predictions not finite")
                with np.load(os.path.join(tmp, f'{name}.npz')) as z:
                    rel[name] = float(z['rel_l2'])
            counts = _counts()        # ... and ends here
            routes = _routes_since(r0)
    finally:
        os.chdir(here)
    gate = _zne_gate_q2()
    emit({"phase": "infer_noise", "rows": int(preds.shape[0]),
          "rel_l2": rel, "seconds": seconds, "launches": counts,
          "routes": routes, "zne_gate_q2": gate})
    check(routes == {"fold": 2 * -(-preds.shape[0] // 20000), "plain": 0},
          f"infer_noise: routes {routes}")
    check(gate["zne_l2_from_ideal"] < gate["noisy_l2_from_ideal"],
          f"infer_noise: Q2 ZNE is not nearer the ideal: {gate}")
    return counts


# ── packed multi-seed, data generation, the QPU export ─────────────────────
# each seed of the packed route against its single run (the stacked
# reductions round differently from one run's; the train_parity limits)
PACKED_LOSS_RTOL = 1e-4      # each epoch's loss, relative
PACKED_REL_L2_RTOL = 1e-3    # the test rel-L2, relative
PACKED_PARAM_TOL = 5e-4      # best_model.npz, absolute
PACKED_SEEDS = (0, 1, 2, 3)
PACKED_Q10_ARGV = ['--operator', 'Advection', '--model_type', 'QuanONet',
                   '--net_size', '40', '2', '20', '2', '--num_qubits', '10',
                   '--scale_coeff', '0.1', '--num_epochs', '1',
                   '--num_train', '2', '--num_test', '2',
                   '--train_sample_num', '100', '--test_sample_num', '100',
                   '--learning_rate', '0.003', '--device', 'cuda']
PACKED_CLASSICAL_EPOCHS = 2
SEEDPACK_SEEDS, SEEDPACK_ITERS, SEEDPACK_ROUNDS = '1,2,4,8', 25, 3
DATAGEN_SIZE = dict(num_train=1000, num_test=1000, num_points=100,
                    num_points_0=100, train_sample_num=100,
                    test_sample_num=100)   # the flagship's data
DATAGEN_TOL = 1e-5           # a device solver against its CPU run
DATAGEN_CG_TOL = 1e-4        # ... Darcy's CG (its reductions round apart)
NATIVE_ODE_TOL = 5e-3        # tests/test_native.py: RK4 against RK45
NATIVE_STENCIL_TOL = 1e-4    # ... fp32 stencils against the fp64 host's
EXPORT_TOL = 1e-4            # the export's self-verification contract
EXPORT_MEASURED = ('expected_shot_noise_std_mean', 'sampled_rel_l2_at_shots')


def _artifacts(prefix, operator, seed):
    """(metrics, loss history, best_model.npz arrays) of seed's run."""
    base = os.path.join(prefix, operator)
    (d,) = [r for r in os.listdir(base) if r.endswith(f'_Seed{seed}')]
    with open(os.path.join(base, d, 'metric.json')) as f:
        m = json.load(f)
    with np.load(os.path.join(base, d, 'best_model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    return m['metrics'], m['history']['loss_train'], arrays


def _packed_against_single(argv, seeds, tmp, label, operator='Advection'):
    """Single CLI runs of ``seeds``, then --multi_seed of them (the packed
    route) with every count zeroed just before, then its rerun: per seed
    the largest relative loss and rel-L2 differences and the largest
    parameter difference; the launches and seconds of the packed run."""
    single = os.path.join(tmp, label, 'single')
    packed = os.path.join(tmp, label, 'packed')
    for seed in seeds:
        _cli(argv + ['--seed', str(seed), '--prefix', single])
    ms = ['--multi_seed'] + [str(s) for s in seeds]
    torch.cuda.synchronize()
    tracing.reset()                   # the packed path starts here
    t0 = time.time()
    result = _cli(argv + ms + ['--prefix', packed])
    torch.cuda.synchronize()
    counts = _counts()                # ... and ends here
    seconds = time.time() - t0
    rerun = _cli(argv + ms + ['--prefix', packed])
    seeds_out = {}
    for seed in seeds:
        m_s, l_s, a_s = _artifacts(single, operator, seed)
        m_p, l_p, a_p = _artifacts(packed, operator, seed)
        l_s, l_p = np.asarray(l_s), np.asarray(l_p)
        seeds_out[seed] = {
            "epochs": [len(l_s), len(l_p)],
            "loss_rel_err": float(np.max(np.abs(l_p - l_s)
                                         / np.abs(l_s))),
            "rel_l2": [m_s['rel_l2'], m_p['rel_l2']],
            "rel_l2_rel_err": abs(m_p['rel_l2'] - m_s['rel_l2'])
            / m_s['rel_l2'],
            "param_max_abs_err": max(float(np.abs(a_p[k] - a_s[k]).max())
                                     for k in a_s),
            "same_keys": sorted(a_s) == sorted(a_p),
            "samples_per_sec": [m_s.get('train_samples_per_sec'),
                                m_p.get('train_samples_per_sec')]}
    return {"seeds": seeds_out, "seconds": seconds, "launches": counts,
            "rerun": rerun, "result_seeds": sorted(result)}


def _check_packed(label, run, seeds):
    for seed, r in run["seeds"].items():
        check(r["same_keys"] and r["epochs"][0] == r["epochs"][1],
              f"{label}: seed {seed}'s artifacts differ in form: {r}")
        check(r["loss_rel_err"] <= PACKED_LOSS_RTOL,
              f"{label}: seed {seed}'s losses off by {r['loss_rel_err']}")
        check(r["rel_l2_rel_err"] <= PACKED_REL_L2_RTOL,
              f"{label}: seed {seed}'s rel-L2 off by {r['rel_l2_rel_err']}")
        check(r["param_max_abs_err"] <= PACKED_PARAM_TOL,
              f"{label}: seed {seed}'s parameters off by "
              f"{r['param_max_abs_err']}")
    check(run["rerun"] == {s: None for s in seeds},
          f"{label}: the rerun trained {run['rerun']}")
    check(run["result_seeds"] == sorted(seeds),
          f"{label}: seeds {run['result_seeds']}")


def phase_multiseed_packed():
    """--multi_seed 0 1 2 3 in the quick regime through the CLI on `cuda`:
    the packed route, each seed against its single run (losses, rel-L2,
    best_model.npz), the rerun skipping every seed, and its launches: B4f
    and B4b 2 a step for all seeds, B1f and B1b one a seed and step, and
    the evaluation's B4f and B1f a chunk and seed.  Then --multi_seed 0 1
    at Q10 Net40-2-20-2 for one epoch of 2 batches (B2f, B2b a seed and
    step), and FNN, DeepONet and FNO packed for 2 epochs (no kernel).
    Returns the launches of the Q5 and Q10 runs."""
    seeds = PACKED_SEEDS
    s = len(seeds)
    with tempfile.TemporaryDirectory() as tmp:
        q5 = _packed_against_single(MULTISEED_CUT_ARGV, seeds, tmp, 'q5')
        q10 = _packed_against_single(PACKED_Q10_ARGV, seeds[:2], tmp, 'q10')
        classical = {}
        for mt, flags in CLASSICAL_RUNS:
            argv = ['--operator', 'Antideriv', '--model_type', mt, *flags,
                    '--num_epochs', str(PACKED_CLASSICAL_EPOCHS),
                    '--num_train', '100', '--num_test', '20',
                    '--learning_rate', '0.003', '--device', 'cuda']
            classical[mt] = _packed_against_single(argv, seeds[:2], tmp, mt,
                                                   'Antideriv')
    steps = MULTISEED_EPOCHS * (200 * 100 // 100)
    chunks = -(-100 * 100 // 4096)            # evaluation chunks a seed
    want = {"ucomp_fwd": 2 * steps + chunks * s, "ucomp_bwd": 2 * steps,
            "hea_chain_fwd": s * steps + chunks * s,
            "hea_chain_bwd": s * steps}
    q10_steps = 2
    q10_want = {"fused_chain_fwd": 2 * q10_steps + 2,
                "fused_chain_bwd": 2 * q10_steps}
    emit({"phase": "multiseed_packed", "seeds": list(seeds),
          "steps": steps, "expected_launches": want,
          "limits": {"loss_rel": PACKED_LOSS_RTOL,
                     "rel_l2_rel": PACKED_REL_L2_RTOL,
                     "param_abs": PACKED_PARAM_TOL},
          "q5": q5, "q10": {**q10, "expected_launches": q10_want},
          "classical": classical})
    _check_packed("multiseed_packed", q5, seeds)
    _check_packed("multiseed_packed q10", q10, seeds[:2])
    for mt, run in classical.items():
        _check_packed(f"multiseed_packed {mt}", run, seeds[:2])
        check(not any(run["launches"].values()),
              f"multiseed_packed {mt}: a kernel launched {run['launches']}")
    got = {k: q5["launches"][k] for k in want}
    check(got == want and q5["launches"]["fused_chain_fwd"] == 0
          and q5["launches"]["adam_step"] == 0,
          f"multiseed_packed: launches {q5['launches']}, want {want}")
    got = {k: q10["launches"][k] for k in q10_want}
    check(got == q10_want and q10["launches"]["hea_chain_fwd"] == 0,
          f"multiseed_packed q10: launches {q10['launches']}, "
          f"want {q10_want}")
    return q5["launches"], q10["launches"]


def phase_seedpack(out_dir):
    """profile_seedpack at S = 1, 2, 4, 8, SEEDPACK_ITERS steps an arm,
    the packed and the sequential arms in turns: samples/s, ms a step,
    device rows and busy share.  No limit on speed (no gain is claimed);
    the packed arm's losses must be finite and falling.  Every count is
    zeroed just before and read just after: both arms must have launched
    B4f, B4b, B1f and B1b.  Returns the launches."""
    t0 = time.time()
    torch.cuda.synchronize()
    tracing.reset()                   # the path starts here
    res = profile_seedpack.main([
        '--seeds', SEEDPACK_SEEDS, '--iters', str(SEEDPACK_ITERS),
        '--rounds', str(SEEDPACK_ROUNDS), '--device', 'cuda',
        '--out', os.path.join(out_dir, 'seedpack_profile_torch.json')])
    torch.cuda.synchronize()
    counts = _counts()                # ... and ends here
    emit({"phase": "seedpack", "seconds": time.time() - t0,
          "launches": counts, **res})
    for size, row in res["packs"].items():
        check(row["packed"]["losses_finite"]
              and row["packed"]["losses_falling"],
              f"seedpack: S={size} losses {row['packed']['loss_first']} -> "
              f"{row['packed']['loss_last']}")
        k = int(size)
        for arm, compiles in (("packed", 2), ("sequential", k)):
            want = {"ucomp_fwd": compiles, "ucomp_bwd": compiles,
                    "hea_chain_fwd": k, "hea_chain_bwd": k,
                    "fused_chain_fwd": 0, "fused_chain_bwd": 0}
            got = row[arm]["launches_per_step"]
            check(got == want, f"seedpack: S={size} {arm} step launched "
                               f"{got}, want {want}")
    check(all(counts[k] for k in ("ucomp_fwd", "ucomp_bwd", "hea_chain_fwd",
                                  "hea_chain_bwd")),
          f"seedpack: a kernel of the step was not launched: {counts}")
    return counts


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def _solver_errors(dev):
    """Each device solver on the card against its CPU run on equal inputs
    (GRF draws made on the card): max abs errors."""
    g = torch.Generator(device=dev).manual_seed(0)
    _, full = device_gen.sample_grf(g, 8, 1000)
    u0, _ = device_gen.sample_grf(g, 8, 100)
    d0, _ = device_gen.sample_grf(g, 4, 400)
    cases = {
        "ode_rk4": lambda u: device_gen.solve_ode_batch('Nonlinear', u, 1000),
        "advection": device_gen.solve_advection_batch,
        "rdiffusion": device_gen.solve_rdiffusion_batch,
        "darcy_cg": device_gen.solve_darcy_batch}
    inputs = {"ode_rk4": full, "advection": u0, "rdiffusion": u0,
              "darcy_cg": d0}
    return {name: float((fn(inputs[name]).cpu()
                         - fn(inputs[name].cpu())).abs().max())
            for name, fn in cases.items()}


def phase_datagen_device():
    """--datagen device: Advection at the flagship's size generated on the
    card through DataManager (time, peak memory, the host generator's
    time for the same size, the _dgdevice cache name), two CLI epochs of
    the flagship trained from it (finite, falling), its solvers against
    their CPU runs on equal inputs, and Darcy and RDiffusion at their
    default sizes (and RDiffusion at num_cal 1000, 100 functions: ~20,000
    steps).  Returns the launches of the training run."""
    dev = torch.device('cuda')
    cfg = dict(operator='Advection', model_type='QuanONet', datagen='device',
               device='cuda', **DATAGEN_SIZE)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, 'data')
        np.random.seed(0)
        torch.cuda.reset_peak_memory_stats(dev)
        dm = DataManager(cfg, data_dir=data_dir)
        data, dev_s = _timed(dm.get_data)
        peak = torch.cuda.max_memory_allocated(dev)
        name = dm._get_filename()
        root = generation.DATA_ROOT
        generation.DATA_ROOT = os.path.join(tmp, 'raw')
        try:
            np.random.seed(0)
            host = DataManager({**cfg, 'datagen': 'host'},
                               data_dir=os.path.join(tmp, 'host'))
            _, host_s = _timed(host._generate_and_process)
        finally:
            generation.DATA_ROOT = root
        argv = ['--operator', 'Advection', '--model_type', 'QuanONet',
                '--net_size', '40', '2', '20', '2', '--num_qubits', '5',
                '--scale_coeff', '0.1', '--num_epochs', '2',
                '--learning_rate', '0.003', '--datagen', 'device',
                '--device', 'cuda', '--prefix', os.path.join(tmp, 'out')]
        for k, v in DATAGEN_SIZE.items():
            argv += [f'--{k}', str(v)]
        torch.cuda.synchronize()
        tracing.reset()               # the training path starts here
        solver = _cli(argv)
        torch.cuda.synchronize()
        counts = _counts()            # ... and ends here
        with open(os.path.join(solver.exp_logger.exp_dir,
                               'metric.json')) as f:
            saved = json.load(f)
        cached = os.path.exists(os.path.join(data_dir, 'Advection', name))
    errs = _solver_errors(dev)
    defaults = {}
    for op in ('Darcy', 'RDiffusion'):
        np.random.seed(0)
        out, sec = _timed(lambda: device_gen.generate_pde_operator_data_device(
            op, 1000, 1000, 100, 100, device='cuda'))
        defaults[op] = {"seconds": sec, "functions": 2000, "num_cal": 100,
                        "finite": bool(np.isfinite(out[1]).all())}
    np.random.seed(0)
    out, sec = _timed(lambda: device_gen.generate_pde_operator_data_device(
        'RDiffusion', 50, 50, 100, 100, num_cal=1000, device='cuda'))
    defaults["RDiffusion_num_cal_1000"] = {
        "seconds": sec, "functions": 100, "num_cal": 1000,
        "finite": bool(np.isfinite(out[1]).all())}
    losses = saved['history']['loss_train']
    emit({"phase": "datagen_device", "size": DATAGEN_SIZE,
          "cache_name": name, "device_seconds": dev_s,
          "host_seconds": host_s, "peak_memory_bytes": peak,
          "train_shape": list(data['train_output'].shape),
          "loss_train": losses, "rel_l2": saved['metrics']['rel_l2'],
          "solver_max_abs_err_vs_cpu": errs,
          "limits": {"solvers": DATAGEN_TOL, "darcy_cg": DATAGEN_CG_TOL},
          "defaults": defaults, "launches": counts})
    check(name.endswith('_dgdevice.npz') and cached,
          f"datagen_device: cache {name}, written {cached}")
    check(data['train_output'].shape == (100000, 1)
          and np.isfinite(data['train_output']).all(),
          f"datagen_device: train_output {data['train_output'].shape}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"datagen_device: losses {losses}")
    for k, e in errs.items():
        check(e <= (DATAGEN_CG_TOL if k == 'darcy_cg' else DATAGEN_TOL),
              f"datagen_device: {k} off its CPU run by {e}")
    check(all(d["finite"] for d in defaults.values()),
          f"datagen_device: non-finite output {defaults}")
    check(counts["hea_chain_fwd"] > 0 and counts["ucomp_bwd"] > 0,
          f"datagen_device: launches {counts}")
    return counts


def phase_datagen_native():
    """--datagen native: the C++ library built from native/ at first use
    (its build time; without -fopenmp where the compiler cannot build
    OpenMP code), Antideriv and Advection through DataManager with
    the _dgnative names, and the solvers against SciPy's RK45 and the host
    stencils on equal inputs at tests/test_native.py's limits."""
    from scipy.integrate import solve_ivp
    t0 = time.time()
    lib = native.build()
    build_s = time.time() - t0
    native.load()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = generation.DATA_ROOT
        generation.DATA_ROOT = os.path.join(tmp, 'raw')
        try:
            for op in ('Antideriv', 'Advection'):
                cfg = dict(operator=op, model_type='QuanONet',
                           datagen='native', **DATAGEN_SIZE)
                np.random.seed(0)
                dm = DataManager(cfg, data_dir=os.path.join(tmp, 'data'))
                data, sec = _timed(dm.get_data)
                out[op] = {"seconds": sec, "cache_name": dm._get_filename(),
                           "finite": bool(np.isfinite(
                               data['train_output']).all()),
                           "raw": sorted(os.listdir(os.path.join(
                               tmp, 'raw', f'{op}_Operator_data')))}
        finally:
            generation.DATA_ROOT = root
    np.random.seed(0)
    u0s = np.stack([generation.generate_random_gaussian_field(1024)[1]
                    for _ in range(3)]).astype(np.float32)
    grid, x = np.linspace(0, 1, 1024), np.linspace(0, 1, 300)
    ode_err = 0.0
    for op, rhs in (('Antideriv', lambda fn: lambda t, y: fn(t)),
                    ('Nonlinear', lambda fn: lambda t, y: -y ** 3 + fn(t))):
        got = native.solve_ode_batch_native(op, u0s, 300)
        for i in range(3):
            fn = (lambda u: lambda t: np.interp(t, grid, u))(u0s[i])
            ref = solve_ivp(rhs(fn), [0, 1], [0], t_eval=x,
                            method='RK45').y[0]
            ode_err = max(ode_err, float(np.abs(got[i] - ref).max()))
    np.random.seed(1)
    _, u0 = generation.generate_random_gaussian_field(80)
    adv_err = float(np.abs(native.solve_advection_batch_native(
        u0.astype(np.float32)[None])[0]
        - generation.solve_advection_pde(80, u0_cal=u0)[0]).max())
    _, u0 = generation.generate_random_gaussian_field(40)
    rd_err = float(np.abs(native.solve_rdiffusion_batch_native(
        u0.astype(np.float32)[None])[0]
        - generation.solve_rdiffusion_pde(40, 0.2, u0_cal=u0)[0]).max())
    emit({"phase": "datagen_native", "library": os.path.relpath(lib, REPO),
          "build_seconds": build_s, "compiler": native.make_settings(),
          "openmp": native.openmp,
          "size": DATAGEN_SIZE, "runs": out,
          "ode_max_abs_err_vs_rk45": ode_err,
          "advection_max_abs_err_vs_host": adv_err,
          "rdiffusion_max_abs_err_vs_host": rd_err,
          "limits": {"ode": NATIVE_ODE_TOL, "stencils": NATIVE_STENCIL_TOL}})
    for op, r in out.items():
        tag = '_rk4.npz' if op == 'Antideriv' else '_native.npz'
        check(r["cache_name"].endswith('_dgnative.npz') and r["finite"]
              and any(f.endswith(tag) for f in r["raw"]),
              f"datagen_native {op}: {r}")
    check(ode_err <= NATIVE_ODE_TOL, f"datagen_native: ODE off by {ode_err}")
    check(max(adv_err, rd_err) <= NATIVE_STENCIL_TOL,
          f"datagen_native: stencils off by {adv_err}, {rd_err}")


def _export(tmp, device, extra=()):
    """ibm_inference on the default Q2 anchor into tmp/<device>: the
    QASM texts and the manifest."""
    d = os.path.join(tmp, device)
    ibm_inference.main(['--simulator_only', '--device', device,
                        '--export_dir', d, *extra])
    files = sorted(f for f in os.listdir(d) if f.endswith('.qasm'))
    qasm = {}
    for f in files:
        with open(os.path.join(d, f), 'rb') as fh:
            qasm[f] = fh.read()
    with open(os.path.join(d, 'manifest.json')) as f:
        return qasm, json.load(f)


def _self_verify(raw, net, nq, branch, trunk, ideal, points):
    """Largest |gate-level replay - engine| over ``points`` (ham_bound
    ±5)."""
    offset, coeff = ibm_export.simple_ham_params(nq, -5.0, 5.0)
    tw, bw, cf, bias = ibm_export.unpack_quanonet_weights(raw, net, nq)
    dev = 0.0
    for k in points:
        n, ops = ibm_export.build_gate_list(branch, np.atleast_1d(trunk[k]),
                                            tw, bw, cf)
        zsum = ibm_export.simulate_gate_list(n, ops)
        dev = max(dev, abs(zsum * coeff + offset + bias - ideal[k]))
    return float(dev)


def phase_ibm_export():
    """The QPU export: quanonet_torch.ibm_inference --simulator_only on
    `cuda` and on the CPU for the default Q2 anchor (QASM byte-equal, the
    manifest equal but the two numbers drawn from each device's shot
    stream), the gate lists' replay against the engine on `cuda` (<=
    1e-4); ideal_predictions on the Advection anchor at full width (one
    branch vector, 100 (x, t) trunk points) against infer.predict and
    simulate_gate_list on 3 of its points (1e-4); noisy_predictions at p
    = 0.01, 32 trajectories, on both anchors: the fold route, replayed
    bit-equal.  Returns the launches of the export."""
    from quanonet_torch.checkpoint import load_raw
    q2 = ibm_inference.DEFAULT_WEIGHTS
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        tracing.reset()               # the export path starts here
        t0 = time.time()
        qasm_gpu, man_gpu = _export(tmp, 'cuda')
        torch.cuda.synchronize()
        counts = _counts()            # ... and ends here
        seconds = time.time() - t0
        qasm_cpu, man_cpu = _export(tmp, 'cpu')
    measured = {k: [man_gpu.pop(k), man_cpu.pop(k)] for k in EXPORT_MEASURED}
    raw2 = load_raw(q2)
    branch2 = np.cos(np.pi * np.linspace(0, 1, 10))
    trunk2 = np.linspace(0, 1, 100)
    ideal2 = ibm_export.ideal_predictions(raw2, [5, 1, 5, 1], 2, branch2,
                                          trunk2, device='cuda')
    dev2 = _self_verify(raw2, [5, 1, 5, 1], 2, branch2, trunk2, ideal2,
                        np.linspace(0, 99, 3, dtype=int))
    # the Advection anchor at full width
    raw5 = load_raw(ANCHOR)
    rng = np.random.RandomState(0)
    branch5 = rng.randn(100).astype(np.float32)
    trunk5 = rng.rand(100, 2).astype(np.float32)
    ideal5 = ibm_export.ideal_predictions(raw5, [40, 2, 20, 2], 5, branch5,
                                          trunk5, device='cuda')
    model, cfg = load_model(ANCHOR, 100, 2, device='cuda')
    direct = predict(model, np.tile(branch5, (100, 1)), trunk5, cfg=cfg)
    err5 = float(np.abs(ideal5 - direct[:, 0]).max())
    dev5 = _self_verify(raw5, [40, 2, 20, 2], 5, branch5, trunk5, ideal5,
                        (0, 49, 99))
    noisy = {}
    for label, raw, net, nq, br, tr in (
            ('q2', raw2, [5, 1, 5, 1], 2, branch2, trunk2),
            ('advection', raw5, [40, 2, 20, 2], 5, branch5, trunk5)):
        before = dict(noise.routes)
        runs = [ibm_export.noisy_predictions(raw, net, nq, br, tr, 0.01,
                                             n_traj=32, seed=3,
                                             device='cuda')
                for _ in range(2)]
        noisy[label] = {"routes": {k: noise.routes[k] - before[k]
                                   for k in before},
                        "replay_bit_equal": bool(np.array_equal(*runs)),
                        "finite": bool(np.isfinite(runs[0]).all())}
    emit({"phase": "ibm_export", "seconds": seconds,
          "qasm_files": sorted(qasm_gpu),
          "qasm_equal_cpu": qasm_gpu == qasm_cpu,
          "manifest_equal_cpu": man_gpu == man_cpu,
          "measured_cuda_cpu": measured,
          "q2_replay_max_dev": dev2, "advection_ideal_vs_predict": err5,
          "advection_replay_max_dev": dev5, "noisy": noisy,
          "limit": EXPORT_TOL, "launches": counts})
    check(len(qasm_gpu) == 3 and qasm_gpu == qasm_cpu,
          "ibm_export: the QASM files differ from the CPU run's")
    check(man_gpu == man_cpu, "ibm_export: the manifests differ")
    check(max(dev2, dev5, err5) <= EXPORT_TOL,
          f"ibm_export: replay {dev2}, {dev5}; ideal vs predict {err5}")
    for label, r in noisy.items():
        check(r["routes"]["fold"] == 2 and r["routes"]["plain"] == 0
              and r["replay_bit_equal"] and r["finite"],
              f"ibm_export noisy {label}: {r}")
    check(counts["hea_chain_fwd"] > 0 and counts["ucomp_fwd"] > 0
          and counts["hea_chain_bwd"] == 0,
          f"ibm_export: launches {counts}")
    return counts


def phase_compare_engines():
    """The port's cross-engine gate (quanonet_torch/compare_engines.py) on
    the card, Q14 included: every check must pass."""
    from quanonet_torch import compare_engines
    t0 = time.time()
    art = compare_engines.Gate('cuda').run()
    emit({"phase": "compare_engines", "seconds": time.time() - t0, **art})
    check(art["all_ok"] and art["passed"] == art["total"],
          f"compare_engines: {art['passed']}/{art['total']}")
    check('Q14 fused≡pfused' in art["checks"],
          "compare_engines: the Q14 check did not run")


# ── multi-GPU: data parallelism, the sharded and pipelined engines ─────────

MULTICHIP_WORLDS = (1, 2, 4)   # 1: NCCL; 2 and 4: ranks sharing the card
MULTICHIP_TIMEOUT_S = 300
MULTICHIP_LR = 1e-3
DP_STEP_TOL = 1e-6             # one step, world 2 against world 1
DP_LOSS_RTOL = 1e-5            # world 1 against the single-process run
AMP_Q = 12
AMP_OUT_TOL = 1e-4
SHARD_GRAD_TOL = 1e-3          # × max(1, max|g|), the shift rule's limit
PIPE_MICROBATCHES = 4
AMP_BENCH_WORLDS = (1, 2)      # bench_amplitude's sharded rows
SHARD_ROUNDS = 2               # bench_amplitude's shard rows in turns


def _multichip_inputs():
    """The three paths' inputs, seeded: the flagship's state and the quick
    regime's first 2,000 rows (dp); Q12 Net40-2-20-2 and the flagship with
    batch-100 angles (amp, pipe)."""
    data = quick_data()
    arrays = (data['train_branch_input'][:2000].astype(np.float32),
              data['train_trunk_input'][:2000].astype(np.float32))
    target = data['train_output'][:2000].astype(np.float32)
    model = _flagship_model('cpu')
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    kw = dict(num_qubits=FLAGSHIP[0], branch_input_size=100,
              trunk_input_size=2, net_size=FLAGSHIP[1], scale_coeff=0.1)
    rng = np.random.RandomState(15)
    amp_spec = hea.quanonet_spec(AMP_Q, FLAGSHIP[1])
    pipe_spec = hea.quanonet_spec(*FLAGSHIP)
    circuits = {}
    for name, spec in (('amp', amp_spec), ('pipe', pipe_spec)):
        circuits[name] = (
            spec,
            rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32),
            rng.uniform(-2, 2, (100, spec.total_encode)).astype(np.float32),
            simple_ham_diag(spec.n_qubits, -5, 5))
    return kw, state, arrays, target, circuits


def _dp_perms():
    """World 1's orders: 5 epochs of the first 1,000 rows (50 steps)."""
    return [epoch_permutation(0, e, 1000) for e in range(5)]


def multichip_runs():
    """Every multi-GPU check on the ranks, and bench_amplitude's sharded
    forwards at AMP_BENCH_WORLDS, one start a world: world 1 on NCCL,
    worlds 2 and 4 sharing the card over gloo.  Returns ({world: the
    checks' results of every rank}, the inputs, the seconds a world)."""
    from quanonet_torch.parallel import _workers, launch
    kw, state, arrays, target, circuits = _multichip_inputs()
    runs, seconds = {}, {}
    for world in MULTICHIP_WORLDS:
        calls = []
        if world == 1:
            calls.append(('dp_check', (kw, state, tuple(a[:1000] for a in
                                                        arrays),
                                       target[:1000], MULTICHIP_LR, 5,
                                       _dp_perms())))
        elif world == 2:
            calls.append(('dp_check', (kw, state, arrays, target,
                                       MULTICHIP_LR, 1)))
        if world in AMP_BENCH_WORLDS:   # bench_amplitude's rows, second
            calls.append(('amp_forwards', (bench_amplitude.amp_inputs(),)))
        # one timed repetition where ranks share the card: a code path
        calls.append(('amp_check', (*circuits['amp'],
                                    3 if world == 1 else 1)))
        calls.append(('pipe_check', (*circuits['pipe'], PIPE_MICROBATCHES)))
        t0 = time.time()
        runs[world] = launch.run_ranks(
            _workers.run_checks, world, 'cuda', args=(calls,),
            share_device=world > 1, timeout_s=MULTICHIP_TIMEOUT_S)
        seconds[world] = time.time() - t0
    return runs, (kw, state, arrays, target, circuits), seconds


def _rank_launches(results):
    """Kernel launches summed over the ranks' results."""
    out = {}
    for r in results:
        for k, v in r['launches'].items():
            out[k] = out.get(k, 0) + v
    return out


def _path_counts(parent, ranks):
    """A path's launches: this process's counts plus the ranks'."""
    return {k: v + ranks.get(k, 0) for k, v in parent.items()}


def phase_multichip_dp(runs, inputs, smi_line):
    """Data parallelism of the flagship (Q5 Net40-2-20-2, batch 100, Adam)
    on the quick regime's rows: world 1 on NCCL, 50 steps of
    make_dp_run_segment against the single-process make_train_epoch on the
    same orders (epoch losses 1e-5 relative; B4f, B4b, B1f, B1b once a
    step); one make_dp_train_step step on a fixed 100-row batch at world 2
    (ranks sharing the card, 50 rows a rank) against world 1's (1e-6); 20
    segment steps at world 2 leaving the ranks' parameters bit-identical;
    the ms a segment step at each world size, and at world 1 the plain
    step's in the same rank.  Returns the path's launches."""
    kw, state, arrays, target, _ = inputs
    tracing.reset()
    model = _flagship_model('cuda')
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    opt = build_optimizer({'learning_rate': MULTICHIP_LR}, 1,
                          model.parameters())
    run = make_run_segment(make_train_epoch(model, opt, 1000, 100, 1),
                           model)
    _, _, plain = run(float('inf'), None, _dp_perms(),
                      tuple(torch.as_tensor(a[:1000], device='cuda')
                            for a in arrays),
                      torch.as_tensor(target[:1000], device='cuda'))
    plain_params = {k: v.detach().cpu().numpy()
                    for k, v in model.state_dict().items()}
    one = runs[1][0][0]
    two = [r[0] for r in runs[2]]
    loss_dev = max(abs(a[0] / b[0] - 1) for a, b in zip(one['hist'], plain))
    param_dev = max(float(np.abs(one['params'][k] - v).max())
                    for k, v in plain_params.items())
    check(loss_dev <= DP_LOSS_RTOL,
          f"multichip_dp: world 1 losses {loss_dev:.2e} from the plain run")
    check(param_dev <= PARITY_PARAM_TOL,
          f"multichip_dp: world 1 parameters {param_dev:.2e} apart")
    steps = one['steps']
    for name in ('ucomp_fwd', 'ucomp_bwd', 'hea_chain_fwd', 'hea_chain_bwd'):
        check(one['launches'][name] == steps,
              f"multichip_dp: {name} {one['launches'][name]} in {steps} "
              f"steps")
    step_dev = max(float(np.abs(r['one_step'][k] - one['one_step'][k]).max())
                   for r in two for k in one['one_step'])
    check(step_dev <= DP_STEP_TOL,
          f"multichip_dp: world 2's step {step_dev:.2e} from world 1's")
    identical = all(np.array_equal(two[1]['params'][k], two[0]['params'][k])
                    for k in two[0]['params'])
    check(identical, "multichip_dp: world 2's replicas differ")
    for r in two:
        check(r['launches']['hea_chain_fwd'] == r['steps'] == 20,
              "multichip_dp: world 2 launches a step")
    ranks = _rank_launches([one] + two)
    emit({"phase": "multichip_dp", "nvidia_smi": smi_line,
          "world1_backend": "nccl", "world2": "2 ranks sharing one card "
          "over gloo", "world1_loss_max_rel_dev": loss_dev,
          "world1_param_max_abs_dev": param_dev,
          "world1_steps": steps, "world1_launches": one['launches'],
          "world2_step_max_abs_dev": step_dev,
          "world2_replicas_bit_identical": identical,
          "world2_steps_a_rank": two[0]['steps'],
          "step_ms": {"world1_nccl": one['step_ms'],
                      "world1_plain_same_rank": one['plain_step_ms'],
                      "world2_shared_card": two[0]['step_ms']},
          "step_ms_of": "make_dp_run_segment at batch 100 (the plain: "
                        "make_train_epoch), in turns in one rank, median "
                        "of 3 rounds",
          "plain_losses": [h[0] for h in plain]})
    return _path_counts(_counts(), ranks)


def _grad_err(got, want):
    return float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))


def phase_multichip_amp(runs, inputs, smi_line, shard_rows):
    """The amplitude-sharded engine at Q12 Net40-2-20-2, batch 100, on the
    grouped-kron local path: world 1 (NCCL) and worlds 2 and 4 (ranks
    sharing the card) against the unsharded 'pfused' engine on the card
    (B2f, B2b): outputs 1e-4, the weight gradient 1e-3 × max(1, max|g|);
    the forward's exchanges equal sharded_collective_counts.  One shard's
    forward under virtual_global k = 1, 2, 3 comes from bench_amplitude's
    shard-compute rows (``shard_rows``).  Returns the path's launches."""
    from quanonet_torch.parallel.amplitude import sharded_collective_counts
    spec, w, x, diag = inputs[4]['amp']
    tracing.reset()
    wt = torch.tensor(w, device='cuda', requires_grad=True)
    ref = hea.hea_expectation(spec, wt, torch.tensor(x, device='cuda'),
                              diag=diag, engine='pfused')
    ref.sum().backward()
    ref_out, ref_grad = ref.detach().cpu().numpy(), wt.grad.cpu().numpy()
    counts = _counts()
    check(counts["fused_chain_fwd"] == 1 and counts["fused_chain_bwd"] == 1,
          "multichip_amp: the pfused reference did not launch B2f, B2b")
    records = {}
    for world in MULTICHIP_WORLDS:
        res = [r[-2] for r in runs[world]]
        want = sharded_collective_counts(spec, world)['ppermutes']
        out_err = max(float(np.abs(r['out'] - ref_out).max()) for r in res)
        g_err, scale = max(_grad_err(r['w_grad'], ref_grad) for r in res)
        check(out_err <= AMP_OUT_TOL,
              f"multichip_amp: world {world} output {out_err:.2e}")
        check(g_err <= SHARD_GRAD_TOL * scale,
              f"multichip_amp: world {world} gradient {g_err:.2e}")
        check(all(r['exchanges'] == want for r in res),
              f"multichip_amp: world {world} exchanges "
              f"{[r['exchanges'] for r in res]}, model {want}")
        records[str(world)] = {"max_abs_err": out_err,
                               "grad_max_abs_err": g_err, "grad_scale": scale,
                               "exchanges": want,
                               "fwd_bwd_ms": [r['fwd_bwd_ms'] for r in res]}
    virtual = {str(r['k']): {k: r[k] for k in (
        'shard_ms', 'pfused_ms', 'device_busy_share', 'peak_memory_bytes')
        if k in r}
        for r in shard_rows
        if (r['qubits'], tuple(r['net_size']), r['batch'])
        == (AMP_Q, FLAGSHIP[1], 100)}
    check(sorted(virtual) == ['1', '2', '3'],
          f"multichip_amp: bench_amplitude's Q{AMP_Q} shard rows {virtual}")
    emit({"phase": "multichip_amp", "nvidia_smi": smi_line, "nq": AMP_Q,
          "net": FLAGSHIP[1], "batch": 100, "reference": "pfused",
          "worlds": records, "shared_card": "worlds 2 and 4: ranks sharing "
          "one card over gloo", "virtual_global_fwd": virtual,
          "virtual_global_of": "bench_amplitude's shard-compute rows: one "
                               "shard's forward, CUDA events, in turns with "
                               "the unsharded pfused forward"})
    return _counts()


def phase_multichip_pipe(runs, inputs, smi_line):
    """The pipelined engine on the flagship (60 blocks), 4 microbatches of
    25 at batch 100, worlds 1 (NCCL), 2 and 4 (ranks sharing the card)
    against the unsharded block-chain engine on the card (B4f, B1f; B4b,
    B1b): outputs 1e-4, the weight gradient 1e-3 × max(1, max|g|); one B4f
    launch a stage a forward and one B4b a backward, no chain kernel.
    Returns the path's launches."""
    spec, w, x, diag = inputs[4]['pipe']
    tracing.reset()
    wt = torch.tensor(w, device='cuda', requires_grad=True)
    ref = hea.hea_expectation(spec, wt, torch.tensor(x, device='cuda'),
                              diag=diag, engine='pallas')
    ref.sum().backward()
    ref_out, ref_grad = ref.detach().cpu().numpy(), wt.grad.cpu().numpy()
    records, ranks = {}, []
    for world in MULTICHIP_WORLDS:
        res = [r[-1] for r in runs[world]]
        ranks += res
        out_err = max(float(np.abs(r['out'] - ref_out).max()) for r in res)
        g_err, scale = max(_grad_err(r['w_grad'], ref_grad) for r in res)
        check(out_err <= AMP_OUT_TOL,
              f"multichip_pipe: world {world} output {out_err:.2e}")
        check(g_err <= SHARD_GRAD_TOL * scale,
              f"multichip_pipe: world {world} gradient {g_err:.2e}")
        for r in res:
            check(r['fwd_launches']['ucomp_fwd'] == 1
                  and r['launches']['ucomp_fwd'] == 1
                  and r['launches']['ucomp_bwd'] == 1
                  and r['launches']['hea_chain_fwd'] == 0,
                  f"multichip_pipe: world {world} launches {r['launches']}")
            check(r['hops']['shift'] == PIPE_MICROBATCHES + world - 1,
                  f"multichip_pipe: world {world} hops {r['hops']}")
        records[str(world)] = {"max_abs_err": out_err,
                               "grad_max_abs_err": g_err, "grad_scale": scale,
                               "hops": res[0]['hops'],
                               "fwd_bwd_ms": [r['fwd_bwd_ms'] for r in res]}
    emit({"phase": "multichip_pipe", "nvidia_smi": smi_line,
          "blocks": spec.n_blocks, "microbatches": PIPE_MICROBATCHES,
          "batch": 100, "reference": "pallas", "worlds": records,
          "shared_card": "worlds 2 and 4: ranks sharing one card over "
          "gloo"})
    return _path_counts(_counts(), _rank_launches(ranks))


MULTICHIP_CLI_EXPECTED = ['train_args.json', 'train.log', 'best_model.ckpt',
                          'best_model.npz', 'final.ckpt', 'final.npz',
                          'metric.json']


def _saved_metrics(solver):
    with open(os.path.join(solver.exp_logger.exp_dir, 'metric.json')) as f:
        return json.load(f)


def _dp_cli_check(name, solver, steps):
    """A data-parallel CLI run on the ranks: only rank 0's artifacts and
    one TensorBoard writer; each rank's backward kernels once a training
    step and its forward kernels at least once, B1f in evaluate.  Returns
    the ranks' launches."""
    exp_dir = solver.exp_logger.exp_dir
    check(sorted(os.listdir(exp_dir)) == sorted(MULTICHIP_CLI_EXPECTED)
          and len(os.listdir(solver.exp_logger.tb_dir)) == 1,
          f"multichip_cli {name}: artifacts {sorted(os.listdir(exp_dir))}")
    ranks = solver.rank_launches
    check(len(ranks) == 2, f"multichip_cli {name}: {len(ranks)} ranks")
    for r in ranks:
        check(r['ucomp_bwd'] == r['hea_chain_bwd'] == steps
              and r['ucomp_fwd'] >= steps and r['hea_chain_fwd'] > steps,
              f"multichip_cli {name}: a rank's launches {r} in {steps} "
              f"steps")
    return _rank_launches([{'launches': r} for r in ranks])


def phase_multichip_cli():
    """The Solver's data-parallel route through the CLI at the flagship on
    the quick regime's 20,000 training rows: --num_devices 2
    --share_device true (two ranks sharing the card over gloo) at batch =
    the training set against --num_devices 1 --shard data (world 1: the
    plain single-process path), 5 epochs, losses and rel-L2 1e-5
    relative, the caller's model holding the trained parameters; the quick
    regime (10 epochs at batch 100) on the two ranks, rel-L2 in the band;
    --shard pipe --num_devices 1 at the flagship, 3 steps (B4f, no chain
    kernel); --num_devices 2 without --share_device, which must fail
    naming the card count.  Returns the launches of the runs (this
    process's and the ranks')."""
    from quanonet_torch.parallel.shard_engine import clear_shard_context
    share = ['--num_devices', '2', '--share_device', 'true']
    full = ['--batch_size', '20000', '--num_epochs', '5']
    tracing.reset()
    record, ranks = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(name, args):
            t0 = time.time()
            solver = _cli(MULTISEED_ARGV + args
                          + ['--prefix', os.path.join(tmp, name)])
            torch.cuda.synchronize()
            return solver, time.time() - t0

        one, _ = run('world1', full + ['--num_devices', '1', '--shard',
                                       'data'])
        two, seconds = run('world2', full + share + ['--shard', 'data'])
        m1, m2 = _saved_metrics(one), _saved_metrics(two)
        h1, h2 = m1['history']['loss_train'], m2['history']['loss_train']
        loss_dev = max(abs(a / b - 1) for a, b in zip(h2, h1))
        rel_dev = abs(m2['metrics']['rel_l2'] / m1['metrics']['rel_l2'] - 1)
        check(len(h2) == len(h1) == 5 and loss_dev <= DP_LOSS_RTOL
              and rel_dev <= DP_LOSS_RTOL,
              f"multichip_cli: world 2 losses {loss_dev:.2e}, rel-L2 "
              f"{rel_dev:.2e} from world 1")
        ranks['full_batch'] = _dp_cli_check('full batch', two, 5)
        two.model.load_state_dict(two.best_params)
        pred = two.predict_test()
        caller_rel = float(np.linalg.norm(pred - two.test_output)
                           / np.linalg.norm(two.test_output))
        caller_dev = abs(caller_rel / m2['metrics']['rel_l2'] - 1)
        check(caller_dev <= DP_LOSS_RTOL,
              f"multichip_cli: the caller's model scores {caller_rel}, the "
              f"ranks {m2['metrics']['rel_l2']}")
        record['full_batch'] = {
            "world1": "the plain single-process path",
            "world2": "2 ranks sharing one card over gloo",
            "loss_max_rel_dev": loss_dev, "rel_l2_rel_dev": rel_dev,
            "rel_l2": [m1['metrics']['rel_l2'], m2['metrics']['rel_l2']],
            "caller_rel_l2_rel_dev": caller_dev, "world2_seconds": seconds,
            "rank_launches": two.rank_launches}

        quick, seconds = run('quick', share + ['--batch_size', '100'])
        rel = _saved_metrics(quick)['metrics']['rel_l2']
        check(np.isfinite(rel) and rel <= QUICK_BAND_REL_L2,
              f"multichip_cli: the quick regime on two ranks, rel-L2 {rel} "
              f"> {QUICK_BAND_REL_L2}")
        ranks['quick'] = _dp_cli_check('quick', quick, 2000)
        record['quick_batch_100'] = {
            "world2": "2 ranks sharing one card over gloo", "rel_l2": rel,
            "band_rel_l2": QUICK_BAND_REL_L2, "seconds": seconds,
            "train_samples_per_sec": _saved_metrics(quick)['metrics'].get(
                'train_samples_per_sec'),
            "rank_launches": quick.rank_launches}

        before = _counts()
        pipe, _ = run('pipe', ['--shard', 'pipe', '--num_devices', '1',
                               '--num_train', '3', '--num_test', '5',
                               '--num_epochs', '1', '--batch_size', '100'])
        clear_shard_context()
        pipe_counts = {k: v - before[k] for k, v in _counts().items()}
        exp_dir = pipe.exp_logger.exp_dir
        for f in ('metric.json', 'best_model.ckpt', 'best_model.npz',
                  'final.ckpt', 'train_args.json'):
            check(os.path.exists(os.path.join(exp_dir, f)),
                  f"multichip_cli --shard pipe: no {f}")
        rel = _saved_metrics(pipe)['metrics']['rel_l2']
        check(np.isfinite(rel) and pipe_counts['ucomp_fwd'] > 0
              and pipe_counts["hea_chain_fwd"] == 0,
              f"multichip_cli --shard pipe: rel-L2 {rel}, launches "
              f"{pipe_counts}")
        record['pipe'] = {"rel_l2": rel, "launches": pipe_counts}

        prefix = os.path.join(tmp, 'two')
        try:
            _cli(MULTISEED_ARGV + ['--prefix', prefix, '--num_devices', '2'])
            failed = False
        except SystemExit as e:
            failed = e.code != 0
        logs = [open(p).read() for p in glob.glob(
            os.path.join(prefix, '*', '*', 'train.log'))]
        named = any(f"the {torch.cuda.device_count()} CUDA device" in t
                    for t in logs)
        check(failed and named,
              "multichip_cli: --num_devices 2 on one card did not fail "
              "naming the card count")
    emit({"phase": "multichip_cli", **record,
          "num_devices_2": "raised, naming the card count"})
    out = _counts()
    for r in ranks.values():
        out = _path_counts(out, r)
    return out


# ── the measurement tools: amplitude bench, Q10 profiler, serve bench, suite

PROFILE_Q10_ITERS = 5          # the module's default is 300
SERVE_BENCH_REPS = 20
SUITE_QUICK_REL_L2 = 1.0       # a sanity floor; `train` holds the band


def phase_bench_amplitude(runs, smi_line):
    """quanonet_torch.bench_amplitude on the card: the correctness,
    capacity and traffic rows at worlds 1 (NCCL) and 2 (ranks sharing the
    card over gloo), from multichip_runs' starts of those worlds, and the
    shard-compute rows in turns with 'pfused'.  Gates: Q12 within 1e-4 of
    'pfused', each row's exchanges the counted model's, outputs finite,
    local state 2^(n-k).  Returns (the path's launches, the result)."""
    dev = torch.device('cuda')
    tracing.reset()
    started = {w: [r[1] for r in runs[w]] for w in AMP_BENCH_WORLDS}
    result = {"rows": bench_amplitude.amp_rows(AMP_BENCH_WORLDS, dev,
                                               started=started)[0],
              "shard_compute": bench_amplitude.shard_compute_rows(
                  dev, rounds=SHARD_ROUNDS)}
    gates = bench_amplitude.gates(result)
    for name, ok in gates.items():
        check(ok, f"bench_amplitude: {name}")
    counts = _counts()
    check(counts["fused_chain_fwd"] > 0 and counts["fused_chain_bwd"] == 0,
          f"bench_amplitude: the pfused forwards launch B2f only: {counts}")
    emit({"phase": "bench_amplitude", "nvidia_smi": smi_line, **result,
          "gates": gates, "launches": counts,
          "shared_card": "world 2: two ranks sharing one card over gloo "
                         "(a code path, not scaling)",
          "link_bytes_per_s": bench_amplitude.LINK_BYTES_PER_S})
    return counts, result


def phase_profile_q10(smi_line):
    """quanonet_torch.profile_q10 at Q10 Net40-2-20-2, batch 100, on the
    card (PROFILE_Q10_ITERS calls a component): both profiles' gates (the
    Solver's step bit for bit, fwd_full bit-equal to forward_fused, finite
    ablations, B2f/B2b a call as counted).  Returns the path's launches."""
    tracing.reset()
    pfused, fused = profile_q10.run(10, (40, 2, 20, 2), 100,
                                    PROFILE_Q10_ITERS, torch.device('cuda'))
    for label, res in (("pfused", pfused), ("fused", fused)):
        for name, ok in res["gates"].items():
            check(ok, f"profile_q10 {label}: {name}")
    emit({"phase": "profile_q10", "nvidia_smi": smi_line,
          "pfused": pfused, "fused": fused})
    return _counts()


def phase_bench_serve(smi_line):
    """quanonet_torch.bench_serve on the card: the shipped Advection anchor
    (Q5) and the seeded Q10 checkpoint, buckets 1 … 8192: each timed
    request and the HTTP answer equal Predictor.predict bit for bit.
    Returns the path's launches."""
    tracing.reset()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        q10 = _q10_checkpoint(tmp)[0]
        for label, ckpt, engine in (("q5", ANCHOR, "pallas"),
                                    ("q10", q10, "pfused")):
            res = bench_serve.run(ckpt, 100, 2, 8192, SERVE_BENCH_REPS,
                                  'cuda')
            check(res["engine"] == engine,
                  f"bench_serve {label}: engine {res['engine']}")
            for name, ok in res["gates"].items():
                check(ok, f"bench_serve {label}: {name}")
            out[label] = res
    emit({"phase": "bench_serve", "nvidia_smi": smi_line, **out})
    return _counts()


def phase_bench_suite(smi_line):
    """quanonet_torch.bench_suite --quick on the card: the four lines under
    the JAX script's names, every value and rel-L2 finite, the Q5 Advection
    line's rel-L2 below SUITE_QUICK_REL_L2.  Returns the path's launches."""
    tracing.reset()
    lines = bench_suite.suite(True, torch.device('cuda'))
    for line in lines:
        check(np.isfinite(line["value"]) and line["value"] > 0,
              f"bench_suite: {line['metric']} = {line['value']}")
        if "rel_l2" in line:
            check(np.isfinite(line["rel_l2"]),
                  f"bench_suite: {line['metric']} rel-L2 {line['rel_l2']}")
    check(lines[0]["rel_l2"] < SUITE_QUICK_REL_L2,
          f"bench_suite: Q5 Advection rel-L2 {lines[0]['rel_l2']}")
    counts = _counts()
    check(all(counts[k] > 0 for k in ("hea_chain_fwd", "hea_chain_bwd",
                                      "ucomp_fwd", "ucomp_bwd")),
          f"bench_suite: the default route's kernels: {counts}")
    emit({"phase": "bench_suite", "nvidia_smi": smi_line, "quick": True,
          "lines": lines, "launches": counts})
    return counts


# the studies' budget: 3 epochs (the hardware study's --quick takes 30,
# the noise study's JAX default 300), cut to pay for bf16_modes and
# bench_regimes within the script's time
STUDY_EPOCHS = 3
# shift's rel-L2 against autodiff's, relative: the same gradient, so far
# inside the JAX verdict's 10 % (which is printed, and gated too)
STUDY_SHIFT_MATCH = 1e-3
# the regimes a sweep issues, as tests/test_torch_port_sweeps.py recorded
# them from the shell scripts
SWEEP_COUNTS = {'benchmarks1': 84, 'benchmarks2': 9, 'capacity': 76,
                'circuit': 24, 'hamiltonian': 17, 'scaling': 42,
                'missing_benchmarks1': 19, 'stream:capacity_deeponet': 36,
                'stream:capacity_deeponet_d5': 4, 'stream:capacity_q_a': 20,
                'stream:capacity_q_b': 20, 'stream:capacity_q_b2': 10,
                'stream:circuit_q10': 8}
SWEEP_CUT = dict(num_epochs=2, num_train=100, num_test=100, multi_seed=[0, 1])


def _jax_csv_layout(name):
    """(header, rows) of the JAX package's shipped docs/<name>."""
    import csv
    with open(os.path.join(REPO, 'docs', name), newline='') as f:
        rows = list(csv.DictReader(f))
    return list(rows[0]), rows


def _study_steps(epochs):
    base = studies_common.BASE
    return epochs * -(-base['num_train'] * base['train_sample_num']
                      // base['batch_size'])


def phase_studies(smi_line):
    """The two studies on the card at a cut budget (STUDY_EPOCHS): the
    noise study (depolarizing) and the hardware study's --quick arms
    (autodiff, shift, SPSA on seed 0).  Gates: each CSV has the JAX script's columns and row set,
    every rel-L2 finite, each verdict line printed; shift within
    STUDY_SHIFT_MATCH of autodiff at seed 0, and the JAX verdict (10 %)
    a MATCH; each training arm's launches by its route (autodiff
    B1f, B1b, B4f, B4b one a step; noise-aware B1f, B1b one a trajectory
    and step, B4f, B4b one a step; shift B1f, B4f as param_shift fans out,
    no backward kernel; SPSA B1f, B4f two a step, no backward kernel).  The
    noise verdict at this budget is recorded, not gated.  Returns the
    launches of each study."""
    out, paths = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        stdout = sys.stdout
        try:
            tracing.reset()           # the noise study's path starts here
            t0 = time.time()
            noise = noise_robustness.run(noise_robustness.parser().parse_args(
                ['--epochs', str(STUDY_EPOCHS),
                 '--prefix', os.path.join(tmp, 'noise'),
                 '--out', os.path.join(tmp, 'noise.csv'), '--device', 'cuda']))
            torch.cuda.synchronize()
            paths['studies_noise'] = _counts()     # ... and ends here
            out['noise_seconds'] = time.time() - t0
            tracing.reset()           # the hardware study's path
            t0 = time.time()
            hardware_training.QUICK_EPOCHS = STUDY_EPOCHS
            hw = hardware_training.run(hardware_training.parser().parse_args(
                ['--quick', '--prefix', os.path.join(tmp, 'hw'),
                 '--out', os.path.join(tmp, 'hw.csv'), '--device', 'cuda']))
            torch.cuda.synchronize()
            paths['studies_hardware'] = _counts()
            out['hardware_seconds'] = time.time() - t0
        finally:
            sys.stdout = stdout
        csvs = {}
        for label, res in (('noise', noise), ('hardware', hw)):
            with open(res['out'], newline='') as f:
                csvs[label] = f.read()
    noise_cols, noise_rows = _jax_csv_layout('noise_robustness.csv')
    hw_cols, _ = _jax_csv_layout('hardware_training.csv')
    key = ('trained', 'eval_noise_p', 'eval_readout_p', 'zne')
    got_keys = [tuple(str(r[k]) for k in key) for r in noise['rows']]
    want_keys = [tuple(r[k] for k in key) for r in noise_rows]
    rel = {r['method']: r['rel_l2'] for r in hw['rows']}
    steps = qsteps = _study_steps(STUDY_EPOCHS)
    spec = hea.quanonet_spec(studies_common.BASE['num_qubits'],
                             tuple(studies_common.BASE['net_size']))
    traj = noise_robustness.parser().get_default('traj')
    shift = shift_launches(spec, steps=qsteps)
    kernels = ("hea_chain_fwd", "hea_chain_bwd", "ucomp_fwd", "ucomp_bwd")
    want = {
        'noise ideal': dict(zip(kernels, [steps] * 4)),
        'noise noise_aware': dict(zip(kernels, [traj * steps, traj * steps,
                                                steps, steps])),
        'hardware autodiff': dict(zip(kernels, [qsteps] * 4)),
        'hardware shift': {"hea_chain_fwd": shift["hea_chain_fwd"],
                           "hea_chain_bwd": 0,
                           "ucomp_fwd": shift["ucomp_fwd"], "ucomp_bwd": 0},
        'hardware spsa': dict(zip(kernels, [2 * qsteps, 0, 2 * qsteps, 0]))}
    got = {f'noise {arm}': noise['launches'][arm]['train']
           for arm in ('ideal', 'noise_aware')}
    got.update({f"hardware {r['method']}": c['train']
                for r, c in zip(hw['rows'], hw['launches'])})
    emit({"phase": "studies", "nvidia_smi": smi_line,
          "noise": {"epochs": STUDY_EPOCHS, "rows": noise['rows'],
                    "verdict_line": noise['verdict_line'],
                    "wins": noise['verdict'][3],
                    "launches": noise['launches']},
          "hardware": {"epochs": STUDY_EPOCHS, "rows": hw['rows'],
                       "verdicts": [line for line, _ in hw['verdicts']],
                       "launches": hw['launches']},
          "steps": {"noise": steps, "hardware": qsteps},
          "expected_train_launches": want, "csv": csvs, **out})
    check(list(noise['rows'][0]) == noise_cols and got_keys == want_keys,
          f"studies: the noise CSV's layout {list(noise['rows'][0])}, rows "
          f"{got_keys}")
    check(list(hw['rows'][0]) == hw_cols
          and [r['method'] for r in hw['rows']] == ['autodiff', 'shift',
                                                    'spsa'],
          f"studies: the hardware CSV's layout {list(hw['rows'][0])}")
    check(all(np.isfinite(r['rel_l2']) for r in noise['rows'] + hw['rows']),
          "studies: a rel-L2 is not finite")
    check(noise['verdict_line'].startswith('VERDICT @ deployment noise')
          and len(hw['verdicts']) == 1,
          f"studies: verdict lines {noise['verdict_line']!r}, "
          f"{hw['verdicts']}")
    check(abs(rel['shift'] - rel['autodiff'])
          <= STUDY_SHIFT_MATCH * rel['autodiff'] and hw['verdicts'][0][1],
          f"studies: shift {rel['shift']} against autodiff "
          f"{rel['autodiff']}")
    for arm, w in want.items():
        check({k: got[arm][k] for k in w} == w
              and got[arm]["fused_chain_fwd"] == got[arm]["adam_step"] == 0,
              f"studies: {arm} launched {got[arm]}, expected {w}")
    return paths['studies_noise'], paths['studies_hardware']


def phase_sweeps(smi_line):
    """The sweep driver on the card: the --dry_run plan of every sweep
    (its counts the shell scripts' as recorded, SWEEP_COUNTS); circuit's
    first Q5 and first Q10 regimes cut to SWEEP_CUT through the driver's
    own subprocess runner (exit 0, a finite metric.json a seed,
    collect_results grouping the two seeds of each); the same two argument
    lists once through cli.main in this process to count their launches
    (Q5 packed: B4f, B4b 2 a step, B1f, B1b one a seed and step, the
    evaluation's B4f, B1f a chunk and seed; Q10: B2f, B2b the same, no
    block-chain kernel); then a rerun of the runner and of cli.main, which
    resume-skip (metric.json unchanged, no launch).  Returns the launches
    of the Q5 and Q10 regimes."""
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    try:
        import collect_results
    finally:
        sys.path.pop(0)
    plan = {name: len(sweeps.plan(name)) for name in sweeps.names()}
    circuit = sweeps.plan('circuit')

    def first(nq):
        return next(r for r in circuit
                    if r[r.index('--num_qubits') + 1] == str(nq))
    regimes = {label: sweeps.with_flags(first(nq), **SWEEP_CUT)
               for label, nq in (('q5', 5), ('q10', 10))}
    seeds = SWEEP_CUT['multi_seed']
    # circuit's regimes: 10 training and 100 test points a function, batch
    # 100; the evaluation runs in chunks of max(batch, 4096) rows
    steps = SWEEP_CUT['num_epochs'] * -(-SWEEP_CUT['num_train'] * 10 // 100)
    chunks = -(-SWEEP_CUT['num_test'] * 100 // 4096)
    s = len(seeds)
    want = {'q5': {"hea_chain_fwd": s * steps + chunks * s,
                   "hea_chain_bwd": s * steps,
                   "ucomp_fwd": 2 * steps + chunks * s,
                   "ucomp_bwd": 2 * steps, "fused_chain_fwd": 0},
            'q10': {"fused_chain_fwd": s * steps + chunks * s,
                    "fused_chain_bwd": s * steps, "hea_chain_fwd": 0}}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, 'runner.log')
        t0 = time.time()
        with open(log_path, 'w') as log:
            rc, done = sweeps.run(list(regimes.values()), 'cuda', tmp,
                                  log=log)
        res['runner_seconds'] = time.time() - t0
        prefix = os.path.join(tmp, 'circuit_reproduction')
        metric_files = sorted(glob.glob(os.path.join(prefix, '*', '*',
                                                     'metric.json')))
        before = {f: open(f, 'rb').read() for f in metric_files}
        groups = {k[1]: sorted(m['rel_l2'] for m in v)
                  for k, v in collect_results.collect(prefix).items()}
        counts = {}
        for label, argv in regimes.items():
            tracing.reset()           # the regime's path starts here
            _cli(sweeps.with_flags(argv, prefix=os.path.join(tmp, 'inproc'))
                 + ['--device', 'cuda'])
            torch.cuda.synchronize()
            counts[label] = _counts()   # ... and ends here
        t0 = time.time()
        with open(log_path + '.rerun', 'w') as log:
            rc2, _ = sweeps.run(list(regimes.values()), 'cuda', tmp, log=log)
        res['rerun_seconds'] = time.time() - t0
        with open(log_path + '.rerun') as f:
            skips = f.read().count('⏩ [Resume] All seeds already completed')
        unchanged = all(open(f, 'rb').read() == b for f, b in before.items())
        tracing.reset()
        rerun = {label: _cli(sweeps.with_flags(
            argv, prefix=os.path.join(tmp, 'inproc')) + ['--device', 'cuda'])
            for label, argv in regimes.items()}
        rerun_counts = _counts()
        with open(log_path) as f:
            log_tail = f.read()[-4000:]
    emit({"phase": "sweeps", "nvidia_smi": smi_line, "plan": plan,
          "regimes": {k: shlex.join(v) for k, v in regimes.items()},
          "runner": {"rc": rc, "done": [{k: d[k] for k in ('rc', 'seconds')}
                                        for d in done]},
          "metric_files": len(metric_files), "collected": groups,
          "launches": counts, "expected_launches": want,
          "rerun": {"rc": rc2, "skips": skips, "unchanged": unchanged,
                    "cli": rerun, "launches": rerun_counts}, **res})
    check(plan == SWEEP_COUNTS, f"sweeps: plan {plan} != {SWEEP_COUNTS}")
    check(rc == 0 and [d['rc'] for d in done] == [0, 0],
          f"sweeps: the runner exited {rc} ({done}); log: {log_tail}")
    check(len(metric_files) == 2 * s and len(groups) == 2
          and all(len(v) == s and np.isfinite(v).all()
                  for v in groups.values()),
          f"sweeps: metric.json files {metric_files}, collected {groups}")
    for label, w in want.items():
        check({k: counts[label][k] for k in w} == w,
              f"sweeps {label}: launched {counts[label]}, expected {w}")
    check(rc2 == 0 and skips == 2 and unchanged
          and rerun == {k: {sd: None for sd in seeds} for k in regimes}
          and not any(rerun_counts.values()),
          f"sweeps: the rerun trained or launched: {rc2}, {skips}, "
          f"{unchanged}, {rerun}, {rerun_counts}")
    return counts['q5'], counts['q10']


# ── the opt-in bf16 operand modes (UCOMP_BF16, PFUSED_BF16) ──────────────────

BF16_ATOL = 3e-2          # the JAX test's limit for its bf16 mode (tests/
                          # test_ucomp.py), x max(1, max|plain|)
BF16_RMS_SHARE = 0.5      # RMS of kernel - twin over the twin's own RMS
                          # deviation from the fp32 form
BF16_DEV_BAND = (0.8, 1.25)   # the 60-block chain: RMS of kernel - fp32 over
                              # that of twin - fp32 (a twin whose x moved
                              # one ulp: twin_1ulp's dev_ratio)
BF16_PREFIX_BLOCKS = 2    # the chain's blocks held against the twin
BF16_Q5 = (5, (40, 2, 20, 2))
BF16_Q7 = (7, (40, 2, 20, 2))
BF16_FUSED_ROWS = (100, 1000)    # the training batch, a serving bucket
BF16_Q5_EPOCHS = 3        # of the flagship's CLI run in each mode
BF16_REL_L2_RTOL = 0.05   # a run's rel-L2 in a mode against fp32's
MODE_SWITCHES = ('UCOMP_BF16', 'PFUSED_BF16', 'QON_UNPIN_EXPECT')


def modes_off():
    """Every opt-in numeric mode off, in this process and in the processes
    it starts: the exact gates of the other phases hold the fp32 paths."""
    for name in MODE_SWITCHES:
        os.environ[name] = '0'
    cuda_ucomp.UCOMP_BF16 = False
    hea.UNPIN_EXPECT = False


@contextmanager
def bf16_mode(ucomp=False, pfused=False):
    """The compile's (cuda_ucomp.UCOMP_BF16) and the fused chain's
    (PFUSED_BF16, read at each call) bf16 modes on for the block, off
    after."""
    cuda_ucomp.UCOMP_BF16 = ucomp
    os.environ['PFUSED_BF16'] = '1' if pfused else '0'
    try:
        yield
    finally:
        modes_off()


def _bf16_err(got, want, fp32):
    """(max |got - want|, its limit, RMS(got - want) / RMS(want - fp32), the
    mode's own max and RMS deviation from the fp32 form)."""
    got, want, fp32 = (t.double() for t in (got, want, fp32))
    rms = lambda a: a.pow(2).mean().sqrt().item()
    dev = rms(want - fp32)
    return ((got - want).abs().max().item(),
            BF16_ATOL * max(1.0, want.abs().max().item()),
            rms(got - want) / dev if dev else 0.0,
            (want - fp32).abs().max().item(), dev)


def _bf16_check(where, got, want, fp32):
    err, limit, share, dev_max, dev_rms = _bf16_err(got, want, fp32)
    check(bool(torch.isfinite(got).all()), f"{where}: not finite")
    check(err <= limit and share <= BF16_RMS_SHARE,
          f"{where}: {err} (limit {limit}), RMS share {share} (limit "
          f"{BF16_RMS_SHARE}) from its bf16 twin")
    return {"max_abs_err": err, "limit": limit, "rms_share": share,
            "mode_dev_max": dev_max, "mode_dev_rms": dev_rms}


def ucomp_bf16_counts(nb, ld, d):
    """Per-call work of the bf16 product form: (flops of B4f-bf16, of
    B4b-bf16, bytes of each), 2 D^3 flops a real product, inputs read once
    and outputs written once.  A block's products: forward 2 ld (U1t.B'),
    3 (ld - 1) (the fold), 4 (H acc R); backward 2 ld, 3 (ld - 2) (the
    prefixes), 4 (H g R), 8 (ld - 1) (Sbar and accbar), 4 ld (u1bar,
    bbar)."""
    mac = 2.0 * d ** 3
    fwd = nb * mac * (2 * ld + 3 * (ld - 1) + 4)
    bwd = nb * mac * (2 * ld + 3 * max(0, ld - 2) + 4 + 8 * (ld - 1)
                      + 4 * ld)
    mats = 4.0 * nb * d * d
    return fwd, bwd, mats * (3 * ld + 2), mats * (6 * ld + 2)


def _bf16_bound(flops, nbytes, fp32_flops=0.0):
    """The larger of the products at the bf16 tensor-core peak (plus any
    other work at the fp32 peak) and the bytes at the HBM rate."""
    t_ops = flops / PEAK_BF16_FLOPS + fp32_flops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def _bf16_ucomp_kernels(dev):
    """B4f-bf16 and B4b-bf16 against their twins at the flagship (nb 60, D
    32) and Q7 Net40-2-20-2 (D 128, planes in device memory): errors,
    the mode's deviation from the fp32 form, times, bounds."""
    out = []
    for nq, net in (BF16_Q5, BF16_Q7):
        spec = hea.quanonet_spec(nq, net)
        ld, nb, d = spec.block_configs[0][1], spec.n_blocks, spec.dim
        last = nb - 1
        rng = np.random.RandomState(18_000 + nq)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        ops = cuda_ucomp.compile_operands(w)
        g = [torch.tensor(rng.randn(nb, d, d).astype(np.float32), device=dev)
             for _ in range(2)]
        fwd = cuda_ucomp.ucomp_bf16_forward(*ops, ld, last)
        twin = cuda_ucomp.ucomp_dense(*ops, ld, last, bf16=True)
        fp32 = cuda_ucomp.ucomp_dense(*ops, ld, last)
        bwd = cuda_ucomp.ucomp_bf16_backward(*ops, ld, last, *g)
        again = cuda_ucomp.ucomp_bf16_backward(*ops, ld, last, *g)
        twin_b = cuda_ucomp.ucomp_backward_dense(*ops, ld, last, *g,
                                                 bf16=True)
        fp32_b = cuda_ucomp.ucomp_backward_dense(*ops, ld, last, *g)
        torch.cuda.synchronize()
        where = f"bf16_modes: B4 bf16 Q{nq}"
        rec = {"nq": nq, "nb": nb, "ld": ld, "D": d,
               "fwd": [_bf16_check(f"{where} fwd", *t)
                       for t in zip(fwd, twin, fp32)],
               "bwd": [_bf16_check(f"{where} bwd", *t)
                       for t in zip(bwd, twin_b, fp32_b)],
               "bwd_bit_equal": all(torch.equal(a, b)
                                    for a, b in zip(bwd, again))}
        check(rec["bwd_bit_equal"], f"{where}: two backward calls differ")
        f_kernel = lambda: cuda_ucomp.ucomp_bf16_forward(*ops, ld, last)
        b_kernel = lambda: cuda_ucomp.ucomp_bf16_backward(*ops, ld, last, *g)
        ffl, bfl, fby, bby = ucomp_bf16_counts(nb, ld, d)
        u1 = ops[0].to(torch.bfloat16)
        b2 = torch.cat(ops[1:], -1).to(torch.bfloat16)
        rec.update({
            "fwd_ms": time_ms(f_kernel, 20),
            "fwd_device_ms": kernel_device_ms(f_kernel, 'ucomp_bf16_fwd'),
            "fwd_plain_ms": time_ms(lambda: cuda_ucomp.ucomp_dense(
                *ops, ld, last, bf16=True), 5),
            "bwd_ms": time_ms(b_kernel, 20),
            "bwd_device_ms": kernel_device_ms(b_kernel, 'ucomp_bf16_bwd'),
            "bwd_plain_ms": time_ms(lambda: cuda_ucomp.ucomp_backward_dense(
                *ops, ld, last, *g, bf16=True), 5),
            "gate_form_fwd_ms": time_ms(
                lambda: cuda_ucomp.ucomp_forward(w, ld, last), 20),
            "products_library_ms": time_ms(lambda: torch.bmm(u1, b2), 20),
            "fwd_flops": ffl, "bwd_flops": bfl})
        rec["fwd_bound_ms"], rec["fwd_bound_by"] = _bf16_bound(ffl, fby)
        rec["bwd_bound_ms"], rec["bwd_bound_by"] = _bf16_bound(bfl, bby)
        out.append(rec)
        del ops, fwd, twin, fp32, bwd, again, twin_b, fp32_b
    return out


def _prefix(ops, lds, blocks):
    """The chain operands of its first ``blocks`` blocks."""
    s = sum(lds[:blocks])
    return ([o[:s].contiguous() for o in ops[:4]]
            + [ops[4][:blocks].contiguous()], tuple(lds[:blocks]))


def _bf16_fused_kernels(dev):
    """B2f-bf16 and B2b-bf16 at Q10 Net40-2-20-2, N = 100 and 1000: on the
    first BF16_PREFIX_BLOCKS blocks against the bf16 twins (a product
    state rounded each sublayer: over 60 blocks a rounding that lands on
    the other side decorrelates two bf16 runs, see BF16_DEV_BAND); on all
    60 blocks the deviation from the fp32 form against the twin's; times
    at N = 100 with the fp32 kernels in turns."""
    out = []
    for n in BF16_FUSED_ROWS:
        spec, w, x, rng = _fused_case(10, Q10_NET, n, 18_100 + n, dev)
        with torch.no_grad():
            ops_all = fused_gates.prepare_fused_chain_x(spec, w, x)
        lds_all = fused_gates.block_depths(spec)
        ops, lds = _prefix(ops_all, lds_all, BF16_PREFIX_BLOCKS)
        rec = {"nq": 10, "N": n, "prefix_blocks": BF16_PREFIX_BLOCKS,
               "nb": spec.n_blocks}
        where = f"bf16_modes: B2 bf16 Q10 N={n}"
        k = cuda_fused.chain_forward(*ops, lds, save_residuals=True,
                                     bf16=True)
        t = fused_gates.chain_fused_saved_x(*ops, lds, bf16=True)
        f = fused_gates.chain_fused_saved_x(*ops, lds)
        rec["prefix_fwd"] = [_bf16_check(f"{where} fwd", *a)
                             for a in zip(k, t, f)]
        g = [torch.tensor(rng.randn(n, spec.dim).astype(np.float32),
                          device=dev) for _ in range(2)]
        kb = cuda_fused.chain_backward(*ops, lds, t[2], t[3], *g, bf16=True)
        tb = fused_gates.chain_fused_backward_x(*ops, lds, t[2:], *g,
                                                bf16=True)
        fb = fused_gates.chain_fused_backward_x(*ops, lds, t[2:], *g)
        rec["prefix_bwd"] = [_bf16_check(f"{where} bwd", *a)
                             for a in zip(kb, tb, fb)]
        if n == BF16_FUSED_ROWS[0]:
            rec.update(_bf16_whole_chain(where, ops_all, lds_all))
            rec["twin_1ulp"] = {"prefix": _twin_1ulp(ops, lds),
                                "chain": _twin_1ulp(ops_all, lds_all)}
        rec.update(_bf16_fused_times(spec, ops_all, lds_all, g, dev,
                                     plain=n == BF16_FUSED_ROWS[0]))
        out.append(rec)
        del ops_all, ops, k, t, f, kb, tb, fb
        torch.cuda.empty_cache()
    return out


def _twin_1ulp(ops, lds):
    """How far the bf16 twin moves when x moves by one ulp: the RMS of
    the change over the twin's own RMS deviation from fp32 (the share a
    kernel that sums in another order can be held to), and the moved
    twin's deviation over the twin's (what BF16_DEV_BAND holds)."""
    moved = list(ops)
    moved[4] = torch.nextafter(ops[4], torch.tensor(float('inf'),
                                                    device=ops[4].device))
    t = fused_gates.chain_fused_x(*ops, lds, bf16=True)
    m = fused_gates.chain_fused_x(*moved, lds, bf16=True)
    f = fused_gates.chain_fused_x(*ops, lds)
    rms = lambda a: a.double().pow(2).mean().sqrt().item()
    return {"share": [rms(a - b) / rms(b - c) for a, b, c in zip(m, t, f)],
            "dev_ratio": [rms(a - c) / rms(b - c)
                          for a, b, c in zip(m, t, f)]}


def _bf16_whole_chain(where, ops, lds):
    """The whole 60-block chain: the kernel's deviation from the fp32 form
    against the twin's (BF16_DEV_BAND), and within BF16_ATOL."""
    k = cuda_fused.chain_forward(*ops, lds, bf16=True)
    t = fused_gates.chain_fused_x(*ops, lds, bf16=True)
    f = fused_gates.chain_fused_x(*ops, lds)
    rms = lambda a: a.double().pow(2).mean().sqrt().item()
    ratio = [rms(a - c) / rms(b - c) for a, b, c in zip(k, t, f)]
    dev_max = [(a - c).abs().max().item() for a, c in zip(k, f)]
    check(all(torch.isfinite(a).all() for a in k),
          f"{where}: chain output not finite")
    check(all(BF16_DEV_BAND[0] <= r <= BF16_DEV_BAND[1] for r in ratio),
          f"{where}: the chain's deviation from fp32 is {ratio} of its "
          f"twin's (band {BF16_DEV_BAND})")
    check(max(dev_max) <= BF16_ATOL, f"{where}: the chain deviates "
          f"{dev_max} from fp32 (limit {BF16_ATOL})")
    return {"chain_dev_ratio": ratio, "chain_dev_max": dev_max,
            "chain_twin_dev_max": [(b - c).abs().max().item()
                                   for b, c in zip(t, f)],
            "chain_kernel_vs_twin_max": [(a - b).abs().max().item()
                                         for a, b in zip(k, t)]}


def _bf16_fused_times(spec, ops, lds, g, dev, plain):
    """B2f/B2b bf16 and fp32 in turns (fp32, bf16, bf16, fp32; CUDA
    events), the bf16 ones' card time, the bounds at the bf16 tensor-core
    peak, the U7bar products' one bf16 torch.bmm; with ``plain`` the
    twins' times."""
    st = cuda_fused.chain_forward(*ops, lds, save_residuals=True, bf16=True)
    calls = {}
    for bf16 in (False, True):
        calls[bf16] = (
            lambda b=bf16: cuda_fused.chain_forward(*ops, lds, bf16=b),
            lambda b=bf16: cuda_fused.chain_forward(
                *ops, lds, save_residuals=True, bf16=b),
            lambda b=bf16: cuda_fused.chain_backward(*ops, lds, st[2], st[3],
                                                     *g, bf16=b))
    times = {False: [[], [], []], True: [[], [], []]}
    for bf16 in (False, True, True, False):
        for i, fn in enumerate(calls[bf16]):
            times[bf16][i].append(time_ms(fn, 10))
    n = ops[4].shape[1]
    fwd, bwd, fwd_bytes, bwd_bytes = _fused_counts(spec, n)
    products = 6.0 * 128 * n * spec.dim * spec.total_sublayers
    rows = n * spec.dim // 128
    s = spec.total_sublayers
    a = torch.randn(3 * s, 128, rows, device=dev).to(torch.bfloat16)
    b = torch.randn(3 * s, rows, 128, device=dev).to(torch.bfloat16)
    out = {"fwd_ms": float(np.median(times[True][0])),
           "fwd_saved_ms": float(np.median(times[True][1])),
           "bwd_ms": float(np.median(times[True][2])),
           "fp32_fwd_ms": float(np.median(times[False][0])),
           "fp32_fwd_saved_ms": float(np.median(times[False][1])),
           "fp32_bwd_ms": float(np.median(times[False][2])),
           "turns_ms": {"bf16": times[True], "fp32": times[False]},
           "fwd_device_ms": kernel_device_ms(calls[True][0],
                                             'fused_chain_fwd', 10),
           "bwd_device_ms": kernel_device_ms(calls[True][2], 'fused_', 10),
           "u7bar_library_ms": time_ms(lambda: torch.bmm(a, b), 10)}
    if plain:
        out["fwd_plain_ms"] = time_ms(lambda: fused_gates.chain_fused_x(
            *ops, lds, bf16=True), 1)
        out["bwd_plain_ms"] = time_ms(
            lambda: fused_gates.chain_fused_backward_x(
                *ops, lds, st[2:], *g, bf16=True), 1)
    out["fwd_bound_ms"], out["fwd_bound_by"] = _bf16_bound(
        products, fwd_bytes, fwd - products)
    out["bwd_bound_ms"], out["bwd_bound_by"] = _bf16_bound(
        2 * products, bwd_bytes, bwd - 2 * products)
    del a, b, st
    return out


def _bf16_requests():
    rng = np.random.RandomState(19)
    return [(rng.randn(n, 100).astype(np.float32),
             rng.rand(n, 2).astype(np.float32)) for n in (1, 37, 200)]


def _bf16_served(ckpt, reqs):
    pred = Predictor(ckpt, branch_in=100, trunk_in=2, max_batch=256,
                     device='cuda')
    pred.warmup()
    return np.concatenate([pred.predict(b, t) for b, t in reqs])


@contextmanager
def _twins_for_kernels():
    """The bf16 kernels' wrappers answered by their plain twins (the served
    reference of the modes; nothing is counted)."""
    saved = cuda_ucomp.ucomp_bf16_forward, cuda_fused.chain_forward

    def chain(*ops, save_residuals=False, bf16=False):
        assert not save_residuals
        return fused_gates.chain_fused_x(*ops, bf16=bf16)
    cuda_ucomp.ucomp_bf16_forward = (
        lambda u1t, br, bi, ld, last: cuda_ucomp.ucomp_dense(
            u1t, br, bi, ld, last, bf16=True))
    cuda_fused.chain_forward = chain
    try:
        yield
    finally:
        cuda_ucomp.ucomp_bf16_forward, cuda_fused.chain_forward = saved


def _bf16_path(tmp, ckpt, nq, net, ucomp, pfused):
    """One mode's path: the training CLI (Q5: BF16_Q5_EPOCHS epochs of 20
    functions; Q10: the train_q10 epoch) and the served requests, with
    every count zeroed just before and read just after; -> (counts, CLI
    metrics, served predictions)."""
    argv = ['--operator', 'Advection', '--model_type', 'QuanONet',
            '--net_size', *map(str, net), '--num_qubits', str(nq),
            '--scale_coeff', '0.1',
            '--num_epochs', str(BF16_Q5_EPOCHS if nq == 5 else 1),
            '--num_train', '20' if nq == 5 else str(Q10_CLI_TRAIN),
            '--num_test', '20', '--train_sample_num', '100',
            '--test_sample_num', '100', '--learning_rate', '0.003',
            '--prefix', os.path.join(tmp, f'out_{int(ucomp or pfused)}'),
            '--device', 'cuda']
    stdout = sys.stdout
    with bf16_mode(ucomp=ucomp, pfused=pfused):
        tracing.reset()                 # the path starts here
        try:
            solver = cli.main(argv)
        finally:
            sys.stdout = stdout
        served = _bf16_served(ckpt, _bf16_requests())
        torch.cuda.synchronize()
        counts = _counts()              # ... and ends here
    with open(os.path.join(solver.exp_logger.exp_dir, 'metric.json')) as f:
        metrics = json.load(f)['metrics']
    return counts, metrics, served


def _bf16_step_arms(nq, net, ucomp, pfused):
    """ms a training step at batch 100, fp32 and the mode in turns
    (_arms_in_turns)."""
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    b = torch.as_tensor(rng.randn(100, 100).astype(np.float32), device=dev)
    t = torch.as_tensor(rng.rand(100, 2).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.randn(100, 1).astype(np.float32), device=dev)
    arms = {}
    for name, on in (('fp32', False), ('bf16', True)):
        model = QuanONet(nq, 100, 2, net, scale_coeff=0.1, device=dev,
                         generator=torch.Generator().manual_seed(0))
        opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                                 lambda s: 1e-4)

        def step(model=model, opt=opt, on=on):
            with bf16_mode(ucomp=ucomp and on, pfused=pfused and on):
                loss = ((model(b, t) - y) ** 2).mean()
                opt.zero_grad()
                loss.backward()
                opt.step()
        arms[name] = step
    return _arms_in_turns(arms, ARM_STEPS)


def phase_bf16_modes(smi_line):
    """The opt-in bf16 operand modes on the card: each bf16 kernel against
    its bf16 twin (B4 at the flagship and Q7; B2 at Q10, N = 100 and 1000),
    each mode's deviation from the fp32 path beside the JAX test's limit;
    then the flagship under UCOMP_BF16 and Q10 under PFUSED_BF16 through the
    entry points (the training CLI, Predictor's requests), each path's
    launches, rel-L2 and ms a step against the fp32 default in one process;
    QON_UNPIN_EXPECT's deviation at the flagship.
    -> (kernel records, path counts)."""
    dev = torch.device('cuda')
    ucomp_recs = _bf16_ucomp_kernels(dev)
    fused_recs = _bf16_fused_kernels(dev)
    paths, quality = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, nq, net, ucomp, pfused in (
                ('bf16_q5', 5, FLAGSHIP[1], True, False),
                ('bf16_q10', 10, Q10_NET, False, True)):
            ckpt = ANCHOR if nq == 5 else _q10_checkpoint(tmp)[0]
            counts, metrics, served = _bf16_path(tmp, ckpt, nq, net, ucomp,
                                                 pfused)
            _, metrics32, served32 = _bf16_path(tmp, ckpt, nq, net, False,
                                                False)
            with bf16_mode(ucomp=ucomp, pfused=pfused), _twins_for_kernels():
                twin = _bf16_served(ckpt, _bf16_requests())
            paths[label] = counts
            rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
            served_vs = {
                "max_abs_dev_from_fp32": float(np.abs(served - served32)
                                               .max()),
                "twin_max_abs_dev_from_fp32": float(np.abs(twin - served32)
                                                    .max()),
                "max_abs_err_vs_twin": float(np.abs(served - twin).max()),
                "dev_ratio": rms(served - served32) / rms(twin - served32)}
            quality[label] = {
                "launches": counts, "cli_metrics": metrics,
                "fp32_cli_metrics": metrics32, "served": served_vs,
                "jax_bf16_limit": BF16_ATOL,
                "step_arms": _bf16_step_arms(nq, net, ucomp, pfused)}
            kernels = (('ucomp_bf16_fwd', 'ucomp_bf16_bwd') if ucomp
                       else ('fused_chain_bf16_fwd', 'fused_chain_bf16_bwd'))
            fp32_kernels = (('ucomp_fwd', 'ucomp_bwd') if ucomp
                            else ('fused_chain_fwd', 'fused_chain_bwd'))
            where = f"bf16_modes: {label}"
            check(all(counts[k] > 0 for k in kernels)
                  and all(counts[k] == 0 for k in fp32_kernels),
                  f"{where}: launches {counts}")
            rel, rel32 = metrics['rel_l2'], metrics32['rel_l2']
            check(all(np.isfinite(v) for v in metrics.values())
                  and abs(rel - rel32) <= BF16_REL_L2_RTOL * rel32,
                  f"{where}: CLI metrics {metrics} against fp32's "
                  f"{metrics32} (rel-L2 within {BF16_REL_L2_RTOL} relative)")
            # the served rows: the compile's blocks are independent, so the
            # flagship's predictions sit on its twin's; the 60-block fused
            # chain decorrelates bf16 runs, so Q10's deviate from fp32 as
            # much as its twin's do
            check(np.isfinite(served).all(), f"{where}: served not finite")
            if ucomp:
                check(served_vs["max_abs_err_vs_twin"] <= BF16_ATOL,
                      f"{where}: served {served_vs} (limit {BF16_ATOL} from "
                      f"the twin's)")
            else:
                check(BF16_DEV_BAND[0] <= served_vs["dev_ratio"]
                      <= BF16_DEV_BAND[1], f"{where}: served {served_vs} "
                      f"(deviation band {BF16_DEV_BAND})")
    # QON_UNPIN_EXPECT at the flagship, batch 100
    model = _flagship_model(dev)
    rng = np.random.RandomState(1)
    b = torch.as_tensor(rng.randn(100, 100).astype(np.float32), device=dev)
    t = torch.as_tensor(rng.rand(100, 2).astype(np.float32), device=dev)
    with torch.no_grad():
        pinned = model(b, t)
        hea.UNPIN_EXPECT = True
        try:
            unpinned = model(b, t)
        finally:
            modes_off()
    unpin_dev = (unpinned - pinned).abs().max().item()
    emit({"phase": "bf16_modes", "card": smi_line,
          "limits": {"jax_atol": BF16_ATOL, "rms_share": BF16_RMS_SHARE,
                     "chain_dev_band": BF16_DEV_BAND},
          "ucomp_kernels": ucomp_recs, "fused_kernels": fused_recs,
          "paths": quality, "unpin_expect_max_abs_dev": unpin_dev})
    check(bool(torch.isfinite(unpinned).all())
          and unpin_dev <= BF16_ATOL * max(1.0, pinned.abs().max().item()),
          f"bf16_modes: QON_UNPIN_EXPECT moves the flagship's output by "
          f"{unpin_dev}")
    return {"ucomp": ucomp_recs, "fused": fused_recs}, paths


# ── the rest of the root bench, the flagship entry and the OOD study ────────
OOD_FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'torch_port_ood.npz')
OOD_TOL = 1e-4               # the served-prediction limit
ENTRY_TOL = 1e-4
REGIME_EPOCHS = 5            # the quick runs of --datagen and --precision


def _bench(argv):
    """bench.run on ``argv``; -> (result, the launches of the run)."""
    torch.cuda.synchronize()
    tracing.reset()                   # the path starts here
    result = bench.run(bench.parser().parse_args(argv))
    torch.cuda.synchronize()
    return result, _counts()          # ... and ends here


def phase_bench_regimes():
    """The port's bench beyond the reference regime: the throughput regime
    at full width and data with --anchor_crossing (batch 1000, one seed;
    best-epoch rel-L2 under the in-run anchor, as the JAX package's runs
    of this regime are; each kernel of the step once a step, and one B1f
    and B4f an evaluated chunk); then the quick regime on 'pallas' with
    --datagen device (the _dgdevice cache, finite), --precision unset and
    default in turns (bit-equal: the kernels do not read the setting; the
    process's setting restored).  -> {path: launches}."""
    found = torch.get_float32_matmul_precision()
    thr, thr_counts = _bench(['--regime', 'throughput', '--anchor_crossing',
                              '--runs', '1'])
    (track,) = thr['anchor_crossing_runs']
    anchor = thr['reference_anchor_rel_l2']
    steps = thr['epochs'] * thr['train_samples'] // thr['batch_size']
    test_rows = bench.SIZES['full']['num_test'] * \
        bench.SIZES['full']['test_sample_num']
    evals = (len(track) + 1 + thr['anchor_measured_in_run']) * \
        -(-test_rows // bench.EVAL_CHUNK)
    want = {"hea_chain_fwd": steps + evals, "ucomp_fwd": steps + evals,
            "hea_chain_bwd": steps, "ucomp_bwd": steps}
    first = next((e for e, v in track if v < anchor), None)
    # the quick regime on the card's data, --precision unset and default
    prec = {}
    for flag in (None, 'default'):
        prec[flag] = _bench(['--quick', '--epochs', str(REGIME_EPOCHS),
                             '--engine', 'pallas', '--datagen', 'device']
                            + (['--precision', flag] if flag else []))
    dg, dg_counts = prec[None]
    after = torch.get_float32_matmul_precision()
    emit({"phase": "bench_regimes", "throughput": thr,
          "throughput_launches": thr_counts, "want_launches": want,
          "steps": steps, "eval_forwards": evals,
          "time_to_anchor_s": (first * thr['train_samples'] / thr['value']
                               if first else None),
          "datagen_device": dg,
          "precision": {str(k): {"rel_l2_runs": v[0]['rel_l2_runs'],
                                 "value": v[0]['value'],
                                 "matmul_precision": v[0]['matmul_precision'],
                                 "launches": v[1]}
                        for k, v in prec.items()},
          "precision_found": found, "precision_after": after})
    check(thr['batch_size'] == 1000 and thr['lr'] == 1e-2
          and thr['regime'] == 'throughput' and thr['anchor_measured_in_run'],
          f"bench_regimes: throughput regime {thr['batch_size']}, "
          f"{thr['lr']}, {thr['regime']}")
    check(thr['beats_anchor_all_runs'],
          f"bench_regimes: throughput rel-L2 {thr['rel_l2_runs']} not under "
          f"the anchor's {anchor}")
    check(thr['epochs_to_anchor'] == [first] and first is not None,
          f"bench_regimes: epochs_to_anchor {thr['epochs_to_anchor']} "
          f"against the trajectory's {first}")
    check(all(thr_counts[k] == v for k, v in want.items())
          and thr_counts["adam_step"] == 0,
          f"bench_regimes: throughput launches {thr_counts}, want {want}")
    check(dg['data_file'].endswith('_dgdevice.npz')
          and all(np.isfinite(dg['rel_l2_runs'])),
          f"bench_regimes: datagen device {dg['data_file']} "
          f"{dg['rel_l2_runs']}")
    check(dg_counts["hea_chain_bwd"] > 0 and dg_counts["ucomp_bwd"] > 0,
          f"bench_regimes: datagen device launches {dg_counts}")
    (r0, c0), (r1, c1) = prec[None], prec['default']
    check(r0['rel_l2_runs'] == r1['rel_l2_runs'],
          f"bench_regimes: --precision default moved the pallas route: "
          f"{r0['rel_l2_runs']} against {r1['rel_l2_runs']}")
    check(r0['matmul_precision'] == 'highest'
          and r1['matmul_precision'] == 'high' and after == found,
          f"bench_regimes: precision {r0['matmul_precision']}, "
          f"{r1['matmul_precision']}, found {found}, after {after}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "bench_regimes: TF32 left on")
    return {"bench_throughput": thr_counts, "bench_datagen": dg_counts,
            "bench_precision": c1}


def phase_ood():
    """The OOD study of visualization.ipynb on the card: both anchors fed
    sin 2πx and sin 4πx through infer.load_model / predict at batch 4096;
    the predictions against the JAX package's (tests/fixtures/
    torch_port_ood.npz, OOD_TOL), the rel-L2s a record.  -> launches."""
    want = np.load(OOD_FIXTURE)
    torch.cuda.synchronize()
    tracing.reset()                   # the path starts here
    t0 = time.time()
    rows, arrays = ood.study(list(ood.CONFIGS), device='cuda')
    torch.cuda.synchronize()
    counts = _counts()                # ... and ends here
    seconds = time.time() - t0
    errs = {f"{r['operator']}/{r['key']}": float(np.abs(
        arrays[f"{r['operator']}/{r['key']}/pred"]
        - want[f"{r['operator']}/{r['key']}"]).max()) for r in rows}
    chunks = sum(-(-r['grid'][0] * r['grid'][1] // ood.BATCH) for r in rows)
    emit({"phase": "ood", "rows": rows, "max_abs_err_vs_jax": errs,
          "tol": OOD_TOL, "seconds": seconds, "launches": counts})
    check(len(rows) == 4 and all(np.isfinite(r['rel_l2']) for r in rows),
          f"ood: rows {rows}")
    check(max(errs.values()) <= OOD_TOL,
          f"ood: predictions off the JAX package's by {errs}")
    check(counts["hea_chain_fwd"] == counts["ucomp_fwd"] == chunks
          and counts["hea_chain_bwd"] == counts["ucomp_bwd"] == 0,
          f"ood: launches {counts}, want {chunks} B1f and B4f")
    return counts


def phase_entry():
    """The flagship entry (quanonet_torch.entry, the twin of
    __graft_entry__.entry) on the card: one call launches B4f and B1f
    once each and gives the CPU plain path's output (ENTRY_TOL).
    -> launches."""
    fn, args = entry_mod.entry()
    cpu_fn, cpu_args = entry_mod.entry(device='cpu')
    want = cpu_fn(*cpu_args).numpy()
    torch.cuda.synchronize()
    tracing.reset()                   # the path starts here
    out = fn(*args)
    torch.cuda.synchronize()
    counts = _counts()                # ... and ends here
    got = out.cpu().numpy()
    err = float(np.abs(got - want).max())
    ms = time_ms(lambda: fn(*args), 20)
    emit({"phase": "entry", "out": got.ravel().tolist(),
          "max_abs_err_vs_cpu": err, "tol": ENTRY_TOL, "ms": ms,
          "launches": counts})
    check(got.shape == (8, 1) and err <= ENTRY_TOL,
          f"entry: {got.shape}, {err} off the CPU plain path")
    check(counts["hea_chain_fwd"] == counts["ucomp_fwd"] == 1
          and sum(counts.values()) == 2, f"entry: launches {counts}")
    return counts


# every phase by name, in the order main() runs them; --phases picks some
PHASES = (
    'device', 'build', 'kernel', 'serve', 'kernel_bwd', 'train_parity',
    'train', 'train_breakdown', 'kernel_fused', 'kernel_fused_bwd',
    'train_parity_q10', 'train_q10', 'train_breakdown_q10', 'serve_q10',
    'smallest_launch', 'kernel_ucomp', 'kernel_ucomp_shift',
    'kernel_ucomp_packed', 'kernel_adam', 'train_parity_ucomp',
    'train_parity_fold', 'profile_step', 'step_arms', 'serve_ucomp',
    'kernel_embed', 'kernel_embed_bwd', 'train_parity_embed', 'train_embed',
    'serve_embed', 'embed_vs_pallas', 'classical', 'train_qpu', 'serve_shots',
    'shift_grad', 'multiseed', 'infer_from_name', 'compare_engines',
    'kernel_noise', 'noise_paths', 'infer_noise', 'multiseed_packed',
    'seedpack', 'datagen_device', 'datagen_native', 'ibm_export',
    'multichip_ranks', 'bench_amplitude', 'multichip_dp', 'multichip_amp',
    'multichip_pipe', 'multichip_cli', 'profile_q10', 'bench_serve',
    'bench_suite', 'studies', 'sweeps', 'bf16_modes', 'bench_regimes', 'ood',
    'entry')
# the phases whose results a phase takes
PHASE_NEEDS = {
    'kernel_ucomp': ('smallest_launch',), 'kernel_adam': ('smallest_launch',),
    'train_parity_ucomp': ('train_parity',),
    'train_parity_fold': ('train_parity',),
    'train_parity_embed': ('train_parity',),
    'bench_amplitude': ('multichip_ranks',),
    'multichip_dp': ('multichip_ranks',),
    'multichip_amp': ('multichip_ranks', 'bench_amplitude'),
    'multichip_pipe': ('multichip_ranks',)}


def selected_phases(names):
    """The phases ``names`` (comma-separated), with device, build and the
    phases they need; raises on an unknown name."""
    out = {'device', 'build'}
    for name in filter(None, names.split(',')):
        if name not in PHASES:
            raise SystemExit(f"chip_smoke: unknown phase {name!r}; the "
                             f"phases: {', '.join(PHASES)}")
        out.add(name)
        out.update(PHASE_NEEDS.get(name, ()))
    return out


class Phases:
    """Runs each phase asked for (all when ``only`` is None) and keeps its
    wall seconds."""

    def __init__(self, only=None):
        self.only, self.seconds = only, {}

    def run(self, name, fn, *args):
        if self.only is not None and name not in self.only:
            return None
        t0 = time.time()
        out = fn(*args)
        self.seconds[name] = time.time() - t0
        return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port on one card and check it.")
    ap.add_argument('--phases', default=None,
                    help="comma-separated phases to run, with device, build "
                         "and the phases they need; no kernels line then "
                         "(default: every phase)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    ph = Phases(None if args.phases is None
                else selected_phases(args.phases))
    modes_off()     # the opt-in modes run in bf16_modes only
    smi_line = ph.run('device', phase_device)
    ph.run('build', phase_build)
    records = ph.run('kernel', phase_kernel)
    serve = ph.run('serve', phase_serve)
    bwd_records = ph.run('kernel_bwd', phase_kernel_bwd)
    default_run = ph.run('train_parity', phase_train_parity)
    train = ph.run('train', lambda: phase_train()[0])
    ph.run('train_breakdown', lambda: emit(
        {"phase": "train_breakdown", "batch": 100, **train_breakdown()}))
    fused_records = ph.run('kernel_fused', phase_kernel_fused)
    fused_bwd_records = ph.run('kernel_fused_bwd', phase_kernel_fused_bwd)
    ph.run('train_parity_q10', phase_train_parity_q10)
    q10_train = ph.run('train_q10', phase_train_q10)
    ph.run('train_breakdown_q10', lambda: emit(
        {"phase": "train_breakdown_q10", "batch": 100,
         **train_breakdown_q10()}))
    q10_serve = ph.run('serve_q10', phase_serve_q10)
    launch = ph.run('smallest_launch', smallest_launch)
    ucomp_records = ph.run('kernel_ucomp', phase_kernel_ucomp, launch)
    shift_stacks = ph.run('kernel_ucomp_shift', phase_kernel_ucomp_shift)
    packed_stacks = ph.run('kernel_ucomp_packed', phase_kernel_ucomp_packed)
    adam = ph.run('kernel_adam', phase_kernel_adam, launch)
    ph.run('train_parity_ucomp', phase_train_parity_ucomp, default_run)
    ph.run('train_parity_fold', phase_train_parity_fold, default_run)
    ps_counts = ph.run('profile_step', phase_profile_step)
    ph.run('step_arms', step_arms)
    serve_ucomp = ph.run('serve_ucomp', phase_serve_ucomp)
    embed_records = ph.run('kernel_embed', phase_kernel_embed)
    embed_bwd_records = ph.run('kernel_embed_bwd', phase_kernel_embed_bwd)
    ph.run('train_parity_embed', phase_train_parity_embed, default_run)
    train_embed = ph.run('train_embed', lambda: phase_train_embed()[0])
    serve_embed = ph.run('serve_embed', phase_serve_embed)
    ph.run('embed_vs_pallas', lambda: emit(
        {"phase": "embed_vs_pallas", "batch": 100, "rounds": ARM_ROUNDS,
         "steps_per_round": ARM_STEPS, **embed_vs_pallas()}))
    classical = ph.run('classical', phase_classical)
    # QPU emulation, multi-seed and the infer CLI's own data: each path read
    # with every count zeroed just before it
    new_paths = {}

    def paths(name, fn, *args, keys=None):
        """Run phase ``name``; keep its path counts under ``keys`` (one
        name, a tuple of names for a tuple result, or None for a dict of
        paths)."""
        out = ph.run(name, fn, *args)
        if out is None:
            return
        if keys is None:
            new_paths.update(out)
        elif isinstance(keys, tuple):
            new_paths.update(zip(keys, out))
        else:
            new_paths[keys] = out
    paths('train_qpu', phase_train_qpu)
    paths('serve_shots', phase_serve_shots,
          keys=('serve_shots', 'serve_shots_q10'))
    paths('shift_grad', phase_shift_grad, keys='shift_grad')
    paths('multiseed', phase_multiseed, keys='multiseed')
    paths('infer_from_name', phase_infer_from_name, keys='infer_from_name')
    # QPU emulation part 2 and the cross-engine gate
    ph.run('compare_engines', phase_compare_engines)
    ph.run('kernel_noise', phase_kernel_noise)
    paths('noise_paths', phase_noise_paths)
    paths('infer_noise', phase_infer_noise, keys='infer_noise')
    # packed multi-seed, data generation on the card and natively, and
    # the QPU export: each path read with every count zeroed just before it
    paths('multiseed_packed', phase_multiseed_packed,
          keys=('multiseed_packed', 'multiseed_packed_q10'))

    def seedpack():
        with tempfile.TemporaryDirectory() as tmp:
            return phase_seedpack(tmp)
    paths('seedpack', seedpack, keys='seedpack')
    paths('datagen_device', phase_datagen_device, keys='datagen_device')
    ph.run('datagen_native', phase_datagen_native)
    paths('ibm_export', phase_ibm_export, keys='ibm_export')
    # the measurement tools and multi-GPU: each path read with every count
    # of this process zeroed just before it (a multichip path adds its
    # ranks' counts)

    def ranks():
        runs, inputs, seconds = multichip_runs()
        emit({"phase": "multichip_ranks", "seconds_a_world": seconds})
        return runs, inputs
    mc = ph.run('multichip_ranks', ranks)
    amp = ph.run('bench_amplitude', lambda: phase_bench_amplitude(mc[0],
                                                                  smi_line))
    if amp is not None:
        new_paths['bench_amplitude'] = amp[0]
    paths('multichip_dp', lambda: phase_multichip_dp(*mc, smi_line),
          keys='multichip_dp')
    paths('multichip_amp', lambda: phase_multichip_amp(
        *mc, smi_line, amp[1]['shard_compute']), keys='multichip_amp')
    paths('multichip_pipe', lambda: phase_multichip_pipe(*mc, smi_line),
          keys='multichip_pipe')
    paths('multichip_cli', phase_multichip_cli, keys='multichip_cli')
    paths('profile_q10', phase_profile_q10, smi_line, keys='profile_q10')
    paths('bench_serve', phase_bench_serve, smi_line, keys='bench_serve')
    paths('bench_suite', phase_bench_suite, smi_line, keys='bench_suite')
    # the studies and the sweeps: each path read with every count zeroed
    # just before it
    paths('studies', phase_studies, smi_line,
          keys=('studies_noise', 'studies_hardware'))
    paths('sweeps', phase_sweeps, smi_line,
          keys=('sweeps_circuit_q5', 'sweeps_circuit_q10'))
    # the opt-in bf16 modes: each path read with every count zeroed just
    # before it
    bf16 = ph.run('bf16_modes', phase_bf16_modes, smi_line)
    if bf16 is not None:
        new_paths.update(bf16[1])
    # the rest of the root bench, the OOD study and the flagship entry: each
    # path read with every count zeroed just before it
    paths('bench_regimes', phase_bench_regimes)
    paths('ood', phase_ood, keys='ood')
    paths('entry', phase_entry, keys='entry')
    emit({"phase_seconds": ph.seconds})
    if ph.only is None:
        kernels_line(new_paths, records, bwd_records, serve, train, q10_train,
                     fused_records, fused_bwd_records, q10_serve, ps_counts,
                     serve_ucomp, ucomp_records, shift_stacks, packed_stacks,
                     adam, embed_records, embed_bwd_records, train_embed,
                     serve_embed, classical, bf16[0])
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernels_line(new_paths, records, bwd_records, serve, train, q10_train,
                 fused_records, fused_bwd_records, q10_serve, ps_counts,
                 serve_ucomp, ucomp_records, shift_stacks, packed_stacks,
                 adam, embed_records, embed_bwd_records, train_embed,
                 serve_embed, classical, bf16):
    """The {"kernels": [...]} line from every phase's results and the
    paths' launch counts."""
    launches = serve["hea_chain_fwd"]
    train_fwd, train_bwd = train["hea_chain_fwd"], train["hea_chain_bwd"]
    q10_train_fwd = q10_train["fused_chain_fwd"]
    q10_train_bwd = q10_train["fused_chain_bwd"]

    def new(kernel):
        return {path: c[kernel] for path, c in new_paths.items()}
    emit({"phase": "device_time_sources", **DEVICE_MS_SOURCES})
    ehead = next(r for r in embed_records
                 if r['nq'] == 5 and r['N'] == 8192)
    estep = next(r for r in embed_records if r['nq'] == 5 and r['N'] == 100)
    ebwd = next(r for r in embed_bwd_records
                if r['nq'] == 5 and r['N'] == 100)
    ebwd_big = next(r for r in embed_bwd_records
                    if r['nq'] == 5 and r['N'] == 8192)
    # the paths that launch the compile and Adam kernels, each read with
    # every count zeroed just before it
    paths = {"serve": serve, "train": train, "train_q10": q10_train,
             "profile_step": ps_counts, "serve_ucomp": serve_ucomp,
             "train_embed": train_embed, "serve_embed": serve_embed,
             "classical": classical, **new_paths}
    by_path = {k: {path: c[k] for path, c in paths.items()}
               for k in ("ucomp_fwd", "ucomp_bwd", "adam_step")}
    ustep = next(r for r in ucomp_records if (r['nq'], r['nb']) == (5, 60))
    ucomp_shape = {"nb": ustep['nb'], "ld": ustep['ld'], "D": ustep['D']}
    head = next(r for r in records
                if r['nq'] == 5 and r['N'] == 8192)
    step = next(r for r in bwd_records
                if r['nq'] == 5 and r['N'] == 100)
    bwd_big = next(r for r in bwd_records
                   if r['nq'] == 5 and r['N'] == 8192)
    fwd_step = next(r for r in records
                    if r['nq'] == 5 and r['N'] == 100)
    fhead = next(r for r in fused_records
                 if r['nq'] == 10 and r['N'] == 100)
    fstep = next(r for r in fused_bwd_records
                 if r['nq'] == 10 and r['N'] == 100)
    emit({"kernels": [{
        "name": "hea_chain_fwd", "route": "cuda",
        "source": "quanonet_torch/csrc/hea_chain.cu",
        "replaces": "quanonet_tpu/ops/pallas_hea.py:153",
        "twin": "quanonet_torch/ops/hea.py:chain_dense, chain_dense_saved",
        "launches": (launches + train_fwd + ps_counts["hea_chain_fwd"]
                     + serve_ucomp["hea_chain_fwd"]
                     + sum(new("hea_chain_fwd").values())),
        "launches_by_path": {"serve": launches, "train": train_fwd,
                             "profile_step": ps_counts["hea_chain_fwd"],
                             "serve_ucomp": serve_ucomp["hea_chain_fwd"],
                             **new("hea_chain_fwd")},
        "max_abs_err": max(r['max_abs_err_amp']
                           for r in records + bwd_records),
        "max_abs_err_expect": max(r['max_abs_err_expect'] for r in records),
        "ms": head['ms'], "plain_ms": head['plain_ms'],
        "bound_ms": head['bound_ms'], "bound_by": head['bound_by'],
        "library_ms": None, "device_ms": head['device_ms'],
        "geometry": head['geometry'],
        "timed_shape": {"nb": head['nb'], "N": head['N'], "D": head['D']},
        "at_N_100": {"ms": fwd_step['ms'], "device_ms": fwd_step['device_ms'],
                     "bound_ms": fwd_step['bound_ms'],
                     "geometry": fwd_step['geometry']},
        "residual_variant": {
            "ms": step['fwd_saved_ms'], "plain_ms": step['fwd_saved_plain_ms'],
            "bound_ms": step['fwd_bound_ms'],
            "device_ms": step['fwd_saved_device_ms'],
            "timed_shape": {"nb": step['nb'], "N": step['N'],
                            "D": step['D']}},
        "shapes": [[r['nb'], r['N'], r['D']] for r in records]}, {
        "name": "hea_chain_bwd", "route": "cuda",
        "source": "quanonet_torch/csrc/hea_chain.cu",
        "replaces": "quanonet_tpu/ops/pallas_hea.py:178",
        "twin": "quanonet_torch/ops/hea.py:chain_backward_dense",
        "launches": (train_bwd + ps_counts["hea_chain_bwd"]
                     + sum(new("hea_chain_bwd").values())),
        "launches_by_path": {"serve": 0, "train": train_bwd,
                             "profile_step": ps_counts["hea_chain_bwd"],
                             "serve_ucomp": 0, **new("hea_chain_bwd")},
        "max_abs_err": max(max(r['max_abs_err_mbar'], r['max_abs_err_phibar'])
                           for r in bwd_records),
        "ms": step['ms'], "plain_ms": step['plain_ms'],
        "bound_ms": step['bound_ms'], "bound_by": step['bound_by'],
        "library_ms": None, "device_ms": step['device_ms'],
        "geometry": step['geometry'],
        "timed_shape": {"nb": step['nb'], "N": step['N'], "D": step['D']},
        "at_N_8192": {"ms": bwd_big['ms'], "device_ms": bwd_big['device_ms'],
                      "bound_ms": bwd_big['bound_ms'],
                      "bound_by": bwd_big['bound_by'],
                      "geometry": bwd_big['geometry']},
        "shapes": [[r['nb'], r['N'], r['D']] for r in bwd_records]}, {
        "name": "fused_chain_fwd", "route": "cuda",
        "source": "quanonet_torch/csrc/fused_chain.cu",
        "replaces": "quanonet_tpu/ops/pallas_fused.py:492",
        "twin": "quanonet_torch/ops/fused_gates.py:chain_fused, "
                "chain_fused_saved",
        "launches": (q10_serve + q10_train_fwd
                     + sum(new("fused_chain_fwd").values())),
        "launches_by_path": {"serve_q10": q10_serve,
                             "train_q10": q10_train_fwd,
                             **new("fused_chain_fwd")},
        "max_abs_err": max(max(r['max_abs_err_amp'],
                               r.get('max_abs_err_states', 0.0))
                           for r in fused_records),
        "max_abs_err_expect": max(r['max_abs_err_expect']
                                  for r in fused_records),
        "ms": fhead['ms'], "plain_ms": fhead['plain_ms'],
        "bound_ms": fhead['bound_ms'], "bound_by": fhead['bound_by'],
        "library_ms": None, "device_ms": fhead['device_ms'],
        "tc_bound_ms": fhead['tc_bound_ms'],
        "timed_shape": {"nq": 10, "nb": fhead['nb'], "N": fhead['N'],
                        "D": fhead['D']},
        "residual_variant_ms": fhead['saved_ms'],
        "residual_variant_device_ms": fhead['saved_device_ms'],
        "fused_engine_ms": fhead['fused_engine_ms'],
        "pfused_engine_ms": fhead['pfused_engine_ms'],
        "shapes": [[r['nq'], r['nb'], r['N']] for r in fused_records]}, {
        "name": "fused_chain_bwd", "route": "cuda",
        "source": "quanonet_torch/csrc/fused_chain.cu",
        "replaces": "quanonet_tpu/ops/pallas_fused.py:570",
        "twin": "quanonet_torch/ops/fused_gates.py:chain_fused_backward",
        "launches": q10_train_bwd + sum(new("fused_chain_bwd").values()),
        "launches_by_path": {"serve_q10": 0, "train_q10": q10_train_bwd,
                             **new("fused_chain_bwd")},
        "max_abs_err": max(max(r['max_abs_err'].values())
                           for r in fused_bwd_records),
        "ms": fstep['ms'], "plain_ms": fstep['plain_ms'],
        "bound_ms": fstep['bound_ms'], "bound_by": fstep['bound_by'],
        "library_ms": None, "device_ms": fstep['device_ms'],
        "tc_bound_ms": fstep['tc_bound_ms'],
        "device_ms_by_launch": fstep['device_ms_by_launch'],
        "u7bar_library_ms": fstep['u7bar_library_ms'],
        "timed_shape": {"nq": 10, "nb": fstep['nb'], "N": fstep['N'],
                        "D": fstep['D']},
        "shapes": [[r['nq'], r['nb'], r['N']] for r in fused_bwd_records]}, {
        "name": "ucomp_fwd", "route": "cuda",
        "source": "quanonet_torch/csrc/ucomp.cu",
        "replaces": "quanonet_tpu/ops/pallas_ucomp.py:118",
        "twin": "quanonet_torch/ops/cuda_ucomp.py:ucomp_weights_dense",
        "launches": sum(by_path["ucomp_fwd"].values()),
        "launches_by_path": by_path["ucomp_fwd"],
        "max_abs_err": max(r['max_abs_err_fwd'] for r in
                           ucomp_records + shift_stacks + packed_stacks),
        "ms": ustep['fwd_ms'], "plain_ms": ustep['fwd_plain_ms'],
        "bound_ms": ustep['fwd_bound_ms'], "bound_by": ustep['fwd_bound_by'],
        "library_ms": None, "timed_shape": ucomp_shape,
        "device_ms": ustep['fwd_device_ms'],
        "matmul_flops": ustep['fwd_matmul_flops'],
        "geometry": ustep['geometry']['fwd'],
        "smallest_launch_ms": ustep['smallest_launch']['back_to_back_ms'],
        "fold_forward_ms": ustep['replaces']['fold_forward_ms'],
        "compile_forward_ms": ustep['replaces']['compile_forward_ms'],
        "shapes": [[r['nb'], r['ld'], r['D']] for r in ucomp_records]
        + [[r['stacked_blocks'], r['ld'], r['D']] for r in shift_stacks]
        + [[r['nb'], r['ld'], r['D']] for r in packed_stacks],
        "packed_stacks": [{k: r[k] for k in ("nb", "last", "fwd_ms",
                                              "fwd_plain_ms", "fwd_bound_ms")}
                          for r in packed_stacks]}, {
        "name": "ucomp_bwd", "route": "cuda",
        "source": "quanonet_torch/csrc/ucomp.cu",
        "replaces": "quanonet_tpu/ops/pallas_ucomp.py:142",
        "twin": "quanonet_torch/ops/cuda_ucomp.py:"
                "ucomp_weights_backward_dense",
        "launches": sum(by_path["ucomp_bwd"].values()),
        "launches_by_path": by_path["ucomp_bwd"],
        "max_abs_err": max(r['max_abs_err_bwd']
                           for r in ucomp_records + packed_stacks),
        "ms": ustep['bwd_ms'], "plain_ms": ustep['bwd_plain_ms'],
        "bound_ms": ustep['bwd_bound_ms'], "bound_by": ustep['bwd_bound_by'],
        "library_ms": None, "timed_shape": ucomp_shape,
        "device_ms": ustep['bwd_device_ms'],
        "matmul_flops": ustep['bwd_matmul_flops'],
        "geometry": ustep['geometry']['bwd'],
        "smallest_launch_ms": ustep['smallest_launch']['back_to_back_ms'],
        "compile_device_rows": ustep['replaces']['compile_device_rows'],
        "fold_forward_backward_ms":
            ustep['replaces']['fold_forward_backward_ms'],
        "compile_forward_backward_ms":
            ustep['replaces']['compile_forward_backward_ms'],
        "shapes": [[r['nb'], r['ld'], r['D']]
                   for r in ucomp_records + packed_stacks],
        "packed_stacks": [{k: r[k] for k in ("nb", "last", "bwd_ms",
                                              "bwd_plain_ms", "bwd_bound_ms")}
                          for r in packed_stacks]}, {
        "name": "adam_step", "route": "cuda",
        "source": "quanonet_torch/csrc/adam.cu",
        "replaces": "quanonet_tpu/ops/pallas_adam.py:51",
        "twin": "quanonet_torch/ops/cuda_adam.py:adam_step_dense",
        "launches": sum(by_path["adam_step"].values()),
        "launches_by_path": by_path["adam_step"],
        "max_abs_err": adam['max_abs_err'],
        "ms": adam['ms'], "plain_ms": adam['plain_ms'],
        "bound_ms": adam['bound_ms'], "bound_by": adam['bound_by'],
        "library_ms": adam['library_ms'],
        "timed_shape": {"leaves": len(adam['leaves']),
                        "parameters": adam['parameters']},
        "device_ms": adam['device_ms'], "host_ms": adam['host_ms'],
        "queued_device_ms": adam['queued_device_ms'], "ctas": adam['ctas'],
        "smallest_launch_ms": adam['smallest_launch']['back_to_back_ms'],
        "torch_adam_default_ms": adam['torch_adam_default_ms']}, {
        "name": "embed_chain_fwd", "route": "cuda",
        "source": "quanonet_torch/csrc/embed_chain.cu",
        "replaces": "quanonet_tpu/ops/pallas_embed.py:68",
        "twin": "quanonet_torch/ops/cuda_embed.py:chain_embed, "
                "chain_embed_saved",
        "launches": (train_embed["embed_chain_fwd"]
                     + serve_embed["embed_chain_fwd"]
                     + ps_counts["embed_chain_fwd"]
                     + sum(new("embed_chain_fwd").values())),
        "launches_by_path": {"train_embed": train_embed["embed_chain_fwd"],
                             "serve_embed": serve_embed["embed_chain_fwd"],
                             "profile_step": ps_counts["embed_chain_fwd"],
                             **new("embed_chain_fwd")},
        "max_abs_err": max(max(r['max_abs_err_amp'], r['max_abs_err_u'])
                           for r in embed_records),
        "max_abs_err_expect": max(r['max_abs_err_expect']
                                  for r in embed_records),
        "ms": ehead['ms'], "plain_ms": ehead['plain_ms'],
        "bound_ms": ehead['bound_ms'], "bound_by": ehead['bound_by'],
        "library_ms": None, "device_ms": ehead['device_ms'],
        "timed_shape": {"nb": ehead['nb'], "N": ehead['N'], "d": ehead['d']},
        "geometry": ehead['geometry'],
        "residual_variant": {
            "ms": estep['saved_ms'], "plain_ms": estep['saved_plain_ms'],
            "bound_ms": estep['saved_bound_ms'],
            "timed_shape": {"nb": estep['nb'], "N": estep['N'],
                            "d": estep['d']},
            "geometry": estep['geometry']},
        "shapes": [[r['nb'], r['N'], r['d']] for r in embed_records],
        "geometry_by_case": _embed_geometry_by_case(embed_records)}, {
        "name": "embed_chain_bwd", "route": "cuda",
        "source": "quanonet_torch/csrc/embed_chain.cu",
        "replaces": "quanonet_tpu/ops/pallas_embed.py:85",
        "twin": "quanonet_torch/ops/cuda_embed.py:chain_embed_backward",
        "launches": (train_embed["embed_chain_bwd"]
                     + ps_counts["embed_chain_bwd"]
                     + sum(new("embed_chain_bwd").values())),
        "launches_by_path": {"train_embed": train_embed["embed_chain_bwd"],
                             "serve_embed": 0,
                             "profile_step": ps_counts["embed_chain_bwd"],
                             **new("embed_chain_bwd")},
        "max_abs_err": max(max(r['max_abs_err'].values())
                           for r in embed_bwd_records),
        "ms": ebwd['ms'], "plain_ms": ebwd['plain_ms'],
        "bound_ms": ebwd['bound_ms'], "bound_by": ebwd['bound_by'],
        "library_ms": None, "device_ms": ebwd['device_ms'],
        "timed_shape": {"nb": ebwd['nb'], "N": ebwd['N'], "d": ebwd['d']},
        "geometry": ebwd['geometry'], "ebar_splits": ebwd['ebar_splits'],
        "at_N_8192": {"ms": ebwd_big['ms'], "plain_ms": ebwd_big['plain_ms'],
                      "bound_ms": ebwd_big['bound_ms'],
                      "bound_by": ebwd_big['bound_by'],
                      "device_ms": ebwd_big['device_ms'],
                      "ebar_splits": ebwd_big['ebar_splits']},
        "shapes": [[r['nb'], r['N'], r['d']] for r in embed_bwd_records],
        "geometry_by_case": _embed_geometry_by_case(embed_bwd_records)},
        *bf16_kernels(bf16, new_paths)]})


def bf16_kernels(bf16, new_paths):
    """The kernels line's entries of the bf16 variants: bf16_modes' records,
    the launches of every path that ran them."""
    u5 = next(r for r in bf16['ucomp'] if r['nq'] == 5)
    f100 = next(r for r in bf16['fused'] if r['N'] == 100)

    def errs(key, recs):
        return max(e['max_abs_err'] for r in recs for e in r[key])

    def entry(name, source, replaces, twin, rec, pre, err, library_ms,
              **extra):
        by_path = {p: c[name] for p, c in new_paths.items() if c.get(name)}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "twin": twin,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": rec[pre + 'ms'], "plain_ms": rec[pre + 'plain_ms'],
                "bound_ms": rec[pre + 'bound_ms'],
                "bound_by": rec[pre + 'bound_by'], "library_ms": library_ms,
                "device_ms": rec[pre + 'device_ms'], **extra}
    ucomp_src = "quanonet_torch/csrc/ucomp.cu"
    fused_src = "quanonet_torch/csrc/fused_chain.cu"
    return [
        entry("ucomp_bf16_fwd", ucomp_src,
              "quanonet_tpu/ops/pallas_ucomp.py:118",
              "quanonet_torch/ops/cuda_ucomp.py:ucomp_dense(bf16=True)", u5,
              'fwd_', errs('fwd', bf16['ucomp']), None,
              products_library_ms=u5['products_library_ms'],
              gate_form_fwd_ms=u5['gate_form_fwd_ms'],
              timed_shape={"nb": u5['nb'], "ld": u5['ld'], "D": u5['D']},
              shapes=[[r['nb'], r['ld'], r['D']] for r in bf16['ucomp']]),
        entry("ucomp_bf16_bwd", ucomp_src,
              "quanonet_tpu/ops/pallas_ucomp.py:142",
              "quanonet_torch/ops/cuda_ucomp.py:"
              "ucomp_backward_dense(bf16=True)", u5, 'bwd_',
              errs('bwd', bf16['ucomp']), None,
              timed_shape={"nb": u5['nb'], "ld": u5['ld'], "D": u5['D']}),
        entry("fused_chain_bf16_fwd", fused_src,
              "quanonet_tpu/ops/pallas_fused.py:492",
              "quanonet_torch/ops/fused_gates.py:chain_fused(bf16=True)",
              f100, 'fwd_', errs('prefix_fwd', bf16['fused']), None,
              fp32_ms=f100['fp32_fwd_ms'],
              residual_variant_ms=f100['fwd_saved_ms'],
              timed_shape={"nq": 10, "nb": f100['nb'], "N": 100},
              held_on_blocks=BF16_PREFIX_BLOCKS),
        entry("fused_chain_bf16_bwd", fused_src,
              "quanonet_tpu/ops/pallas_fused.py:570",
              "quanonet_torch/ops/fused_gates.py:"
              "chain_fused_backward(bf16=True)", f100, 'bwd_',
              errs('prefix_bwd', bf16['fused']), None,
              fp32_ms=f100['fp32_bwd_ms'],
              u7bar_library_ms=f100['u7bar_library_ms'],
              timed_shape={"nq": 10, "nb": f100['nb'], "N": 100},
              held_on_blocks=BF16_PREFIX_BLOCKS)]


if __name__ == '__main__':
    sys.exit(main())
