#!/usr/bin/env python3
"""
Drives the PyTorch/CUDA port (quanonet_torch) on one NVIDIA card and checks
it.  Run from the root of a checkout:

    python3 chip_smoke.py

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
             engine, and that the kernel's launch count went up.  Then,
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
             initial state, engine 'pallas' (the kernels) against 'dense'
             (autograd of the plain chain), on the same batches: per-step
             losses to 1e-4 relative, parameters to PARITY_PARAM_TOL.
7. train   — the training path: the quick regime of the port's bench
             (python -m quanonet_torch.bench --quick) for seeds 0, 1, 2,
             each seed's rel-L2 held to the band fixed from the JAX
             package's CPU run (QUICK_BAND_REL_L2), then one epoch of the
             training CLI at flagship width into a temporary --prefix,
             whose best_model.ckpt infer.load_model must reproduce; both
             kernels must have been launched.  Then, outside that counted
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

13. kernel_ucomp — the block-matrix compile kernels (csrc/ucomp.cu)
             against ucomp_dense / ucomp_backward_dense at the flagship
             (nb 60, ld 2, D 32), Q2 ld 1, Q3 ld 3, HEAQNN Q4, Q6 and Q7
             Net40-2-20-2 (D = 128) and a single block: forward to 2e-5,
             backward to 1e-4 x max(1, max|plain|), two backward calls
             bit-equal, median times, the bound (ucomp_counts), what the
             smallest launch costs, and at the flagship the autograd fold
             they replace (hea.fold_block_mats) with its device rows.
14. kernel_adam — the one-launch Adam (csrc/adam.cu) against
             adam_step_dense on the flagship's six leaves over 25 steps
             (atol 2e-6, rtol 1e-5), two runs bit-equal, its time and
             bound, and torch.optim.Adam(fused=True) as the yardstick.
15. train_parity_ucomp — 20 Adam steps of the flagship with USE_UCOMP on
             and FusedAdam against train_parity's default run (the fold
             and torch.optim.Adam) on the same batches.
16. profile_step — quanonet_torch.profile_step.main at full width on
             `cuda`, twice: the default path (the compile and Adam kernels
             must stay unlaunched), then USE_UCOMP on with --fused_adam
             (B1f, B1b, B4f, B4b and B5 all launched).  Then, outside the
             counted windows, the step at batch 100 in four arms (default,
             +ucomp, +fused Adam, both), interleaved in one process:
             step_ms, device rows a step and the card's busy share.
17. serve_ucomp — the Advection anchor through load_model -> Predictor ->
             HTTP with USE_UCOMP on: the JAX fixture within 1e-4, the
             compile kernel's count up; then buckets 1 and 8192 with the
             toggle on and off, in turns.

18. kernel_embed — the real-embedding chain kernels (csrc/embed_chain.cu):
             the forward, primal and residual, against chain_embed /
             chain_embed_saved on random general E and t at the shapes of
             Q1 .. Q7 models, the flagship (nb 60, d 32) at N in {1, 37,
             100, 8192}: amplitudes (<= 2e-5), expectation (<= 1e-4),
             median times, time on the card alone, the bound (embed_bound).
19. kernel_embed_bwd — the backward against chain_embed_backward at the
             same cases (1e-4 x max(1, max|plain|), two calls bit-equal).
20. train_parity_embed — 20 Adam steps of the flagship with engine
             'embed': the kernels against autograd of the plain chain and
             against train_parity's 'pallas' run, on the same batches.
21. train_embed — the quick regime through --engine embed for seeds 0, 1,
             2 (each within QUICK_BAND_REL_L2), then one CLI epoch with
             --engine embed whose checkpoint infer.load_model reproduces;
             both embed kernels launched, the block-chain kernels not.
22. serve_embed — the Advection anchor through load_model -> Predictor ->
             HTTP with engine='embed' against the JAX fixture (atol 1e-4);
             then buckets 1 and 8192 in turns with 'pallas'.
23. embed_vs_pallas — the flagship's step at batch 100, the two engines
             in turns in one process: step ms, device rows a step and the
             card's busy share.  (profile_step, phase 16, times 'embed'
             among its engines.)
24. classical — FNN, DeepONet and FNO each take a few epochs through the
             training CLI on the card (loss finite and falling, parameters
             on `cuda`); the DeepONet checkpoint is served through
             Predictor, whose prediction equals infer.predict's.  No
             hand-written kernel runs here: these models are plain matrix
             products.

Each path (serve, train, train_q10, serve_q10, profile_step, serve_ucomp,
train_embed, serve_embed) starts with every launch count at 0 and reads them when it ends.  Then the {"kernels": [...]} line,
the nvidia-smi line, and last {"ok": true, "device": {...}}.  Any failed
check exits non-zero before the last line.  Needs one card; exits 1
without CUDA.
"""
import json
import os
from concurrent.futures import ThreadPoolExecutor
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

from quanonet_torch import bench, cli, profile_step
from quanonet_torch.data.manager import DataManager
from quanonet_torch.infer import load_model, predict
from quanonet_torch.models import QuanONet
from quanonet_torch import checkpoint as ckpt_io
from quanonet_torch.convert import raw_from_state_dict
from quanonet_torch.ops import (
    _build, cuda_adam, cuda_embed, cuda_fused, cuda_hea, cuda_ucomp,
    fused_gates, hea,
)
from quanonet_torch.ops.hamiltonian import simple_ham_diag
from quanonet_torch.serve import Predictor, make_server
from quanonet_torch.solver import (
    ScheduledOptimizer, _decay_tuple_schedule, epoch_permutation,
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
PEAK_HBM_BYTES = 3.35e12

AMP_TOL = 2e-5       # fp32 chain of up to 60 block products, other order
EXPECT_TOL = 1e-4
SERVE_TOL = 1e-4

KERNEL_CASES = [     # (label, qubits, net_size, batch rows N)
    *[('Q5 Net40-2-20-2', 5, (40, 2, 20, 2), n)
      for n in (1, 7, 100, 1000, 8192)],
    ('Q2 Net5-1-5-1', 2, (5, 1, 5, 1), 1000),
    ('Q7 Net40-2-20-2', 7, (40, 2, 20, 2), 1000),
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

    _zero_counts()                   # the served path starts here
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
    launches = cuda_hea.launches     # ... and ends here
    emit({"phase": "serve", "ckpt": os.path.relpath(ANCHOR, REPO),
          "engine": pred.cfg['engine'], "load_and_warmup_s": load_s,
          "warmup_s": warm_s, "bucket_latency_ms": bucket_ms,
          "requests": list(SERVE_REQUESTS),
          "request_max_abs_err_vs_plain": req_err,
          "fixture_max_abs_err": fix_err, "http_status": code,
          "http_buckets": resp['buckets'], "http_max_abs_err": http_err,
          "kernel_launches": launches})
    check(max(req_err) <= SERVE_TOL,
          f"served requests differ from the plain engine by {req_err}")
    check(fix_err <= SERVE_TOL,
          f"served output differs from the JAX fixture by {fix_err}")
    check(code == 200 and http_err <= SERVE_TOL,
          f"HTTP /predict: status {code}, error {http_err}")
    check(launches > 0, "the served path launched no kernel")
    check(stopped, "server thread did not stop")
    for rows in (1, 8192):
        emit({"phase": "serve_breakdown", "rows": rows,
              **serve_breakdown(pred, rows)})
    return launches


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
    """20 Adam steps, kernels against autograd of the plain chain; returns
    the kernels' run (losses, parameters)."""
    dev = torch.device('cuda')
    inputs, target, idx, schedule = _parity_batches(dev)
    runs = {}
    for engine in ('pallas', 'dense'):
        model = QuanONet(5, 100, 2, (40, 2, 20, 2), scale_coeff=0.1,
                         engine=engine, device=dev,
                         generator=torch.Generator().manual_seed(0))
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        opt = ScheduledOptimizer(torch.optim.Adam(model.parameters()),
                                 schedule)
        runs[engine] = _parity_steps(model, opt, inputs, target, idx)
    (lk, pk), (ld, pd) = runs['pallas'], runs['dense']
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, ld))
    param_err = max((pk[k] - pd[k]).abs().max().item() for k in pk)
    moved = max((pk[k] - init[k]).abs().max().item() for k in pk)
    emit({"phase": "train_parity", "steps": PARITY_STEPS,
          "losses_pallas": lk, "losses_dense": ld,
          "max_loss_rel_diff": loss_rel, "max_param_abs_diff": param_err,
          "max_param_moved": moved})
    check(loss_rel <= PARITY_LOSS_RTOL,
          f"train_parity: step losses differ by {loss_rel} relative")
    check(param_err <= PARITY_PARAM_TOL,
          f"train_parity: parameters differ by {param_err}")
    return runs['pallas']


def phase_train():
    """The training path: the bench's quick regime for 3 seeds, then one
    epoch of the CLI; returns the launches of both kernels in it."""
    quick_data()                      # the bench reads the cache
    _zero_counts()                    # the path starts here
    result = bench.run(bench.parser().parse_args(['--quick', '--runs', '3']))
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
        launches = (cuda_hea.launches, cuda_hea.bwd_launches)  # ... ends here
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
          "fwd_launches": launches[0], "bwd_launches": launches[1]})
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
    return launches, result


def _device_us(event):
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


def train_breakdown(steps=20):
    """Where one training step's time goes, flagship at batch 100 on the
    card: host clock with a synchronise for the whole step, the forward
    (with the graph built), forward + backward, and the Adam step; CUDA
    events for the two chain kernels; a torch.profiler window for the
    device's busy share and the kernels that take it.  Runs outside the
    counted windows."""
    from torch.profiler import ProfilerActivity, profile
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
    out.update(profile_steps(step, steps, profile, ProfilerActivity))
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
            *ops, lds, (st_r, st_i), *g), 1 if big else 3)
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


def _zero_counts():
    cuda_hea.launches = cuda_hea.bwd_launches = 0
    cuda_fused.launches = cuda_fused.bwd_launches = 0
    cuda_ucomp.launches = cuda_ucomp.bwd_launches = 0
    cuda_adam.launches = 0
    cuda_embed.launches = cuda_embed.bwd_launches = 0


def _counts():
    return {"hea_chain_fwd": cuda_hea.launches,
            "hea_chain_bwd": cuda_hea.bwd_launches,
            "fused_chain_fwd": cuda_fused.launches,
            "fused_chain_bwd": cuda_fused.bwd_launches,
            "ucomp_fwd": cuda_ucomp.launches,
            "ucomp_bwd": cuda_ucomp.bwd_launches,
            "adam_step": cuda_adam.launches,
            "embed_chain_fwd": cuda_embed.launches,
            "embed_chain_bwd": cuda_embed.bwd_launches}


def phase_train_q10():
    """The training path at Q10: one epoch of the CLI (engine 'auto' ->
    'pfused'); returns the fused kernels' launches in it."""
    with tempfile.TemporaryDirectory() as tmp:
        stdout = sys.stdout
        _zero_counts()                # the path starts here
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
        launches = (cuda_fused.launches, cuda_fused.bwd_launches)
        other = (cuda_hea.launches, cuda_hea.bwd_launches)  # ... ends here
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
          "bwd_launches": launches[1], "hea_chain_launches": list(other)})
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
    return launches


def train_breakdown_q10(steps=10):
    """Where one Q10 training step's time goes at batch 100: host clock
    for the step, the forward and the Adam step; CUDA events for the two
    fused-group kernels; a torch.profiler window for the card's busy
    share.  Runs outside the counted windows."""
    from torch.profiler import ProfilerActivity, profile
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
    out.update(profile_steps(step, steps, profile, ProfilerActivity))
    return out


def profile_steps(step, steps, profile, activity, match=None):
    """The card's busy share over ``steps`` calls of step() under
    torch.profiler, and the kernels that take it; with ``match``, only the
    kernels whose name holds it."""
    try:
        torch.cuda.synchronize()
        with profile(activities=[activity.CPU, activity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        # the card's own rows (kernels, copies): a CPU op's device time is
        # that of the kernels it launched, which have rows of their own
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and (match is None or match in e.key)]
        busy_us = sum(_device_us(e) for e in kernels)
        if not busy_us:
            return {"profiler_error": "no device rows in the trace"}
        top = sorted(kernels, key=_device_us, reverse=True)[:8]
        return {
            "profiled_steps": steps, "profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_kernels_per_step": sum(e.count for e in kernels) / steps,
            "top_device_ms_per_step": {
                e.key[:60]: _device_us(e) / 1e3 / steps for e in top}}
    except RuntimeError as e:     # the profiler is a measurement, no check
        return {"profiler_error": str(e)[:200]}


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

        _zero_counts()                 # the served path starts here
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
        launches = cuda_fused.launches  # ... and ends here
        other = (cuda_hea.launches, cuda_fused.bwd_launches)
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
ARM_ROUNDS, ARM_STEPS = 5, 20


def ucomp_counts(nb, ld, d, n):
    """Least work of the block-matrix compile, counted as chain_bound and
    fused_bwd_bound count: (flops forward, flops backward, bytes forward,
    bytes backward).  A real D x D product is 2 D^3 flops.  A real-by-complex
    product is two of them; a complex-by-complex product three (the
    three-product form) plus that form's 5 D^2 additions.  H and R are n
    butterfly stages, 2 n D^2 additions on a complex matrix.  Forward, per
    block: ld products U1t . B' (real by complex), ld - 1 fold products
    (complex), H . acc and . R (butterflies; no R on the last block).
    Backward, the VJP's own products and not the recompute of the forward:
    H g R (butterflies), per fold step Sbar and the next accbar (complex
    each), per sublayer U1bar and B'bar (two real products each).  Bytes:
    every input read once, every output written once."""
    real = 2.0 * d ** 3
    cplx = 3 * real + 5.0 * d * d
    hr = (2 * nb - 1) * 2.0 * n * d * d
    fwd = nb * (2 * ld * real + (ld - 1) * cplx) + hr
    bwd = nb * (2 * (ld - 1) * cplx + 4 * ld * real) + hr
    ops_bytes = 4.0 * 3 * nb * ld * d * d
    mt_bytes = 4.0 * 2 * nb * d * d
    return fwd, bwd, ops_bytes + mt_bytes, 2 * ops_bytes + mt_bytes


def smallest_launch():
    """What one launch costs on this card when the kernel does next to
    nothing: the Adam kernel on a single one-element leaf, per launch in a
    back-to-back run of 200 (CUDA events) and alone with a synchronise
    (host clock)."""
    leaf = [torch.zeros(1, device='cuda') for _ in range(4)]

    def launch():
        cuda_adam.adam_step(leaf[:1], leaf[1:2], leaf[2:3], leaf[3:], 0.0, 1)

    def burst():
        for _ in range(200):
            launch()
    return {"back_to_back_ms": time_ms(burst, 10) / 200,
            "alone_with_sync_ms": host_ms(launch, 50)}


def _profiled(step, steps=10, match=None):
    from torch.profiler import ProfilerActivity, profile
    return profile_steps(step, steps, profile, ProfilerActivity, match)


def kernel_device_ms(fn, match, reps=20):
    """Time on the card alone (ms a call) of the kernels whose name holds
    ``match``, from a torch.profiler window over ``reps`` calls of fn():
    the CUDA-event times around a wrapper also hold the host's part of a
    call, which for a kernel of microseconds is most of it.  None when the
    trace has no such row."""
    fn()
    prof = _profiled(fn, reps, match)
    return prof["device_busy_ms"] / reps if "device_busy_ms" in prof else None


def phase_kernel_ucomp(launch):
    """B4f and B4b against their plain versions at every case, beside what
    the smallest launch costs (``launch``); returns the per-case records."""
    dev = torch.device('cuda')
    records = []
    for label, spec in UCOMP_CASES:
        nb, d, ld = spec.n_blocks, spec.dim, spec.block_configs[0][1]
        last = nb - 1
        rng = np.random.RandomState(5000 + 10 * spec.n_qubits + nb)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        ops = cuda_ucomp.compile_operands(spec, w)
        g = [torch.tensor(rng.randn(nb, d, d).astype(np.float32), device=dev)
             for _ in range(2)]
        fwd = cuda_ucomp.ucomp_forward(*ops, ld, last)
        bwd = cuda_ucomp.ucomp_backward(*ops, ld, last, *g)
        again = cuda_ucomp.ucomp_backward(*ops, ld, last, *g)
        fwd_plain = cuda_ucomp.ucomp_dense(*ops, ld, last)
        bwd_plain = cuda_ucomp.ucomp_backward_dense(*ops, ld, last, *g)
        fold = hea.fold_block_mats(spec, w)
        torch.cuda.synchronize()
        names = ('u1bar', 'bbar_r', 'bbar_i')
        errs = {k: (a - b).abs().max().item()
                for k, a, b in zip(names, bwd, bwd_plain)}
        scales = {k: max(1.0, b.abs().max().item())
                  for k, b in zip(names, bwd_plain)}
        f_flops, b_flops, f_bytes, b_bytes = ucomp_counts(nb, ld, d, spec.n_qubits)
        fwd_bound, fwd_by = _bound(f_flops, f_bytes)
        bwd_bound, bwd_by = _bound(b_flops, b_bytes)
        rec = {"phase": "kernel_ucomp", "case": label, "nq": spec.n_qubits,
               "nb": nb, "ld": ld, "D": d,
               "panel_rows": cuda_ucomp.panel_rows(d),
               "max_abs_err_fwd": _max_err(fwd, fwd_plain),
               "max_abs_err_vs_fold": _max_err(fwd, fold),
               "max_abs_err_bwd": errs, "bwd_scale": scales,
               "bwd_bit_equal": all(torch.equal(a, b)
                                    for a, b in zip(bwd, again)),
               "fwd_ms": time_ms(lambda: cuda_ucomp.ucomp_forward(
                   *ops, ld, last), 30),
               "fwd_plain_ms": time_ms(lambda: cuda_ucomp.ucomp_dense(
                   *ops, ld, last), 5),
               "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
               "fwd_flops": f_flops, "fwd_bytes": f_bytes,
               "bwd_ms": time_ms(lambda: cuda_ucomp.ucomp_backward(
                   *ops, ld, last, *g), 30),
               "bwd_plain_ms": time_ms(
                   lambda: cuda_ucomp.ucomp_backward_dense(
                       *ops, ld, last, *g), 5),
               "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
               "bwd_flops": b_flops, "bwd_bytes": b_bytes,
               "fwd_device_ms": kernel_device_ms(
                   lambda: cuda_ucomp.ucomp_forward(*ops, ld, last),
                   'ucomp_fwd'),
               "bwd_device_ms": kernel_device_ms(
                   lambda: cuda_ucomp.ucomp_backward(*ops, ld, last, *g),
                   'ucomp_bwd'),
               "smallest_launch": launch,
               "launch_bound": max(fwd_bound, bwd_bound)
               < launch["back_to_back_ms"]}
        if (spec.n_qubits, nb) == (5, 60):
            rec["replaces"] = _fold_against_compile(spec, w)
        emit(rec)
        finite = all(bool(torch.isfinite(t).all()) for t in (*fwd, *bwd))
        check(finite, f"ucomp {label}: output not finite")
        check(rec["max_abs_err_fwd"] <= AMP_TOL,
              f"ucomp {label}: forward error {rec['max_abs_err_fwd']}")
        check(rec["max_abs_err_vs_fold"] <= AMP_TOL,
              f"ucomp {label}: differs from the fold by "
              f"{rec['max_abs_err_vs_fold']}")
        for k in names:
            check(errs[k] <= BWD_REL_TOL * scales[k],
                  f"ucomp {label}: {k} error {errs[k]} > {BWD_REL_TOL} x "
                  f"{scales[k]}")
        check(rec["bwd_bit_equal"], f"ucomp {label}: two backward calls differ")
        records.append(rec)
    return records


def _fold_against_compile(spec, w):
    """At the flagship: the autograd fold that the compile kernels replace
    and the compile path as the engine takes it (elementwise build under
    autograd + the kernels), forward and forward + backward, from the
    weights: host clock with a synchronise, and the device rows of one
    forward + backward."""
    wg = w.clone().requires_grad_()

    def fwd_bwd(mats):
        def run():
            mr, mi = mats(spec, wg)
            torch.autograd.grad((mr * mr).sum() + (mi * mi).sum(), wg)
        return run

    out = {}
    for name, mats in (('fold', hea.fold_block_mats),
                       ('compile', cuda_ucomp.compile_block_mats)):
        with torch.no_grad():
            out[f"{name}_forward_ms"] = host_ms(lambda: mats(spec, w))
        out[f"{name}_forward_backward_ms"] = host_ms(fwd_bwd(mats))
        prof = _profiled(fwd_bwd(mats))
        out[f"{name}_device_rows"] = prof.get("device_kernels_per_step")
        out[f"{name}_device_busy_ms"] = (
            prof["device_busy_ms"] / prof["profiled_steps"]
            if "device_busy_ms" in prof else None)
    with torch.no_grad():
        out["compile_operands_forward_ms"] = host_ms(
            lambda: cuda_ucomp.compile_operands(spec, w))
    return out


def _flagship_model(dev, engine='pallas'):
    return QuanONet(FLAGSHIP[0], 100, 2, FLAGSHIP[1], scale_coeff=0.1,
                    engine=engine, device=dev,
                    generator=torch.Generator().manual_seed(0))


def phase_kernel_adam(launch):
    """B5 against adam_step_dense on the flagship's leaves, beside what the
    smallest launch costs (``launch``); returns the record."""
    dev = torch.device('cuda')
    shapes = [tuple(p.shape) for p in _flagship_model(dev).parameters()]
    n_params = sum(int(np.prod(s)) for s in shapes)

    def leaves(seed):
        rng = np.random.RandomState(seed)
        return [torch.tensor(np.asarray(rng.randn(*s), np.float32),
                             device=dev) for s in shapes]

    def run(step):
        p = leaves(0)
        m = [torch.zeros_like(a) for a in p]
        v = [torch.zeros_like(a) for a in p]
        for t in range(1, ADAM_STEPS + 1):
            step(p, leaves(100 + t), m, v, 1e-2 * 0.95 ** t, t)
        torch.cuda.synchronize()
        return p + m + v

    got, again = run(cuda_adam.adam_step), run(cuda_adam.adam_step)
    want = run(cuda_adam.adam_step_dense)
    err = _max_err(got, want)
    close = all(torch.allclose(a, b, atol=ADAM_ATOL, rtol=ADAM_RTOL)
                for a, b in zip(got, want))
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))

    p, g = leaves(1), leaves(2)
    m, v = [torch.zeros_like(a) for a in p], [torch.zeros_like(a) for a in p]
    params = [torch.nn.Parameter(a.clone()) for a in p]
    for q, gq in zip(params, g):
        q.grad = gq
    library = torch.optim.Adam(params, lr=1e-3, fused=True)
    default = torch.optim.Adam([torch.nn.Parameter(a.clone()) for a in p],
                               lr=1e-3)
    for q, gq in zip(default.param_groups[0]['params'], g):
        q.grad = gq
    nbytes = 7.0 * n_params * 4
    bound_ms, bound_by = _bound(12.0 * n_params, nbytes)
    rec = {"phase": "kernel_adam", "leaves": [list(s) for s in shapes],
           "parameters": n_params, "steps": ADAM_STEPS,
           "max_abs_err": err, "close": close, "bit_equal": bit_equal,
           "ms": time_ms(lambda: cuda_adam.adam_step(p, g, m, v, 1e-3, 3),
                         100),
           "host_ms": host_ms(lambda: cuda_adam.adam_step(p, g, m, v, 1e-3,
                                                          3), 50),
           "device_ms": kernel_device_ms(
               lambda: cuda_adam.adam_step(p, g, m, v, 1e-3, 3),
               'adam_kernel'),
           "plain_ms": time_ms(lambda: cuda_adam.adam_step_dense(
               p, g, m, v, 1e-3, 3), 20),
           "library_ms": time_ms(library.step, 100),
           "library_host_ms": host_ms(library.step, 50),
           "torch_adam_default_ms": time_ms(default.step, 50),
           "torch_adam_default_host_ms": host_ms(default.step, 50),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "smallest_launch": launch}
    emit(rec)
    check(all(bool(torch.isfinite(t).all()) for t in got),
          "adam: output not finite")
    check(close, f"adam: kernel differs from the plain version by {err} "
                 f"(atol {ADAM_ATOL}, rtol {ADAM_RTOL})")
    check(bit_equal, "adam: two runs of 25 steps differ")
    return rec


def phase_train_parity_ucomp(default_run):
    """20 Adam steps of the flagship with USE_UCOMP on and FusedAdam
    against the default path's run (train_parity's 'pallas': the fold and
    torch.optim.Adam), same initial state, batches and schedule."""
    dev = torch.device('cuda')
    inputs, target, idx, schedule = _parity_batches(dev)
    model = _flagship_model(dev)
    opt = cuda_adam.fused_adam(schedule).init(model.parameters())
    _zero_counts()
    cuda_hea.USE_UCOMP = True
    try:
        lu, pu = _parity_steps(model, opt, inputs, target, idx)
    finally:
        cuda_hea.USE_UCOMP = False
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


def phase_profile_step():
    """profile_step.main at full width on the card: the default path, then
    USE_UCOMP on with --fused_adam; returns the second run's launches."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, ucomp, extra in (('default', False, []),
                                   ('ucomp_fused_adam', True,
                                    ['--fused_adam'])):
            out = os.path.join(tmp, f'{name}.json')
            _zero_counts()             # the path starts here
            cuda_hea.USE_UCOMP = ucomp
            stdout = sys.stdout
            sys.stdout = sys.stderr    # its results line is not this script's
            try:
                res = profile_step.main(['--iters', str(PROFILE_ITERS),
                                         '--out', out] + extra)
            finally:
                sys.stdout = stdout
                cuda_hea.USE_UCOMP = False
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
    off, on = runs['default'][1], runs['ucomp_fused_adam'][1]
    check(off["ucomp_fwd"] == off["ucomp_bwd"] == off["adam_step"] == 0,
          f"profile_step: the default path launched an opt-in kernel: {off}")
    check(on["ucomp_fwd"] > 0 and on["ucomp_bwd"] > 0 and on["adam_step"] > 0,
          f"profile_step: toggles on, yet launches {on}")
    return on


def _arms_in_turns(arms):
    """{name: step} -> per arm the median step time over ARM_ROUNDS rounds
    of ARM_STEPS steps, the arms taking turns (host clock with a
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
            for _ in range(ARM_STEPS):
                step()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0) / ARM_STEPS)
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


def four_arm_step():
    """The flagship's step at batch 100 in four arms (default, +ucomp,
    +fused Adam, both), in turns within this process so that all see the
    same host: median step time over ARM_ROUNDS rounds of ARM_STEPS steps
    (host clock with a synchronise), then each arm's device rows a step and
    the card's busy share under torch.profiler.  Outside the counted
    windows."""
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    b = torch.as_tensor(rng.randn(100, 100).astype(np.float32), device=dev)
    t = torch.as_tensor(rng.rand(100, 2).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.randn(100, 1).astype(np.float32), device=dev)
    arms = {}
    for name, ucomp, fused in (('default', False, False),
                               ('ucomp', True, False),
                               ('fused_adam', False, True),
                               ('both', True, True)):
        model = _flagship_model(dev)
        opt = (cuda_adam.fused_adam(1e-4).init(model.parameters()) if fused
               else torch.optim.Adam(model.parameters(), lr=1e-4))

        def step(model=model, opt=opt, ucomp=ucomp):
            cuda_hea.USE_UCOMP = ucomp
            try:
                loss = ((model(b, t) - y) ** 2).mean()
                opt.zero_grad()
                loss.backward()
                opt.step()
            finally:
                cuda_hea.USE_UCOMP = False
        arms[name] = step
    return _arms_in_turns(arms)


def phase_serve_ucomp():
    """The served path with USE_UCOMP on: the Advection anchor through
    load_model -> Predictor -> HTTP on `cuda`; returns the launches in
    it."""
    fixture = np.load(FIXTURE)
    fb, ft, fpred = fixture['branch'], fixture['trunk'], fixture['pred']
    _zero_counts()                     # the served path starts here
    cuda_hea.USE_UCOMP = True
    try:
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
    finally:
        cuda_hea.USE_UCOMP = False
    # outside the counted window: each bucket with the toggle on and off,
    # in turns
    bucket_ms = {}
    for rows in (1, 8192):
        bn, tn = (np.zeros((rows, 100), np.float32),
                  np.zeros((rows, 2), np.float32))
        times = {True: [], False: []}
        for _ in range(3):
            for on in (True, False):
                cuda_hea.USE_UCOMP = on
                try:
                    times[on].append(host_ms(lambda: pred.predict(bn, tn), 10))
                finally:
                    cuda_hea.USE_UCOMP = False
        bucket_ms[rows] = {"ucomp_ms": float(np.median(times[True])),
                           "default_ms": float(np.median(times[False])),
                           "ucomp_rounds": times[True],
                           "default_rounds": times[False]}
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
    *[('Q5 Net40-2-20-2', 5, (40, 2, 20, 2), n) for n in (1, 37, 100, 8192)],
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
    bytes backward, bytes of the residuals s and u).  A real (2d x 2d)
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
    residual_bytes = (2 * nb - 1) * row_bytes
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


def _embed_expectation(out, d, diag):
    """<H> of the state [re | im] = out, normalised: a general E is not
    unitary and a general t's phase step keeps no norm, so the row is
    brought back to a state before it is measured."""
    sr, si = out[:, :d], out[:, d:]
    norm = (sr * sr + si * si).sum(-1, keepdim=True)
    return hea.diag_expectation_pair(sr, si, diag) / norm


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
        rec = {"phase": "kernel_embed", "case": label, "nq": nq, "nb": nb,
               "N": n, "d": d,
               "max_abs_err_amp": (out - plain[0]).abs().max().item(),
               "max_abs_err_expect": err_exp,
               "max_abs_err_s": (saved[1] - plain[1]).abs().max().item(),
               "max_abs_err_u": ((saved[2] - plain[2]).abs().max().item()
                                 if nb > 1 else 0.0),
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
        check(max(rec["max_abs_err_s"], rec["max_abs_err_u"]) <= AMP_TOL,
              f"{where}: residual error {rec['max_abs_err_s']} / "
              f"{rec['max_abs_err_u']}")
        check(rec["primal_bit_equal"], f"{where}: residual variant's output "
                                       f"differs from the primal kernel's")
        records.append(rec)
    return records


def phase_kernel_embed_bwd():
    """B3b against chain_embed_backward at every case; returns the
    per-case records."""
    dev = torch.device('cuda')
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records = []
    for label, nq, net, n in EMBED_CASES:
        spec, e, t, g = _embed_case(nq, net, n, 6500 + 10 * nq + n, dev)
        nb, d = spec.n_blocks, spec.dim
        _, s, u = cuda_embed.embed_forward(e, t, save_residuals=True)
        got = cuda_embed.embed_backward(e, t, s, u, g)
        again = cuda_embed.embed_backward(e, t, s, u, g)
        want = cuda_embed.chain_embed_backward(e, t, s, u, g)
        torch.cuda.synchronize()
        names = ('ebar', 'tbar')
        errs = {k: (a - b).abs().max().item()
                for k, a, b in zip(names, got, want)}
        scales = {k: max(1.0, b.abs().max().item())
                  for k, b in zip(names, want)}
        reps = 20 if n >= 1000 else 50
        bound_ms, bound_by, flops, nbytes = embed_bwd_bound(nb, n, d)
        rec = {"phase": "kernel_embed_bwd", "case": label, "nq": nq,
               "nb": nb, "N": n, "d": d,
               "splits": cuda_embed.ebar_splits(nb, n, 2 * d, sms),
               "max_abs_err": errs, "scale": scales,
               "bit_equal": all(torch.equal(a, b)
                                for a, b in zip(got, again)),
               "ms": time_ms(lambda: cuda_embed.embed_backward(
                   e, t, s, u, g), reps),
               "device_ms": kernel_device_ms(
                   lambda: cuda_embed.embed_backward(e, t, s, u, g), None),
               "plain_ms": time_ms(lambda: cuda_embed.chain_embed_backward(
                   e, t, s, u, g), 5),
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
        _zero_counts()
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
    3 seeds, then one epoch of the CLI; returns the launches in it."""
    quick_data()
    _zero_counts()                    # the path starts here
    result = bench.run(bench.parser().parse_args(
        ['--quick', '--runs', '3', '--engine', 'embed']))
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
    _zero_counts()                     # the served path starts here
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
    synchronise), then each engine's device rows a step and the card's
    busy share under torch.profiler.  Outside the counted windows."""
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
    return _arms_in_turns(arms)


def phase_classical():
    """FNN, DeepONet and FNO through the training CLI on the card, and the
    DeepONet checkpoint through Predictor.  These models are plain matrix
    products (nn.Linear, einsum): no hand-written kernel runs here."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        _zero_counts()
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi_line = phase_device()
    phase_build()
    records = phase_kernel()
    launches = phase_serve()
    bwd_records = phase_kernel_bwd()
    default_run = phase_train_parity()
    (train_fwd, train_bwd), _ = phase_train()
    emit({"phase": "train_breakdown", "batch": 100, **train_breakdown()})
    fused_records = phase_kernel_fused()
    fused_bwd_records = phase_kernel_fused_bwd()
    phase_train_parity_q10()
    q10_train_fwd, q10_train_bwd = phase_train_q10()
    emit({"phase": "train_breakdown_q10", "batch": 100,
          **train_breakdown_q10()})
    q10_serve = phase_serve_q10()
    launch = smallest_launch()
    ucomp_records = phase_kernel_ucomp(launch)
    adam = phase_kernel_adam(launch)
    phase_train_parity_ucomp(default_run)
    ps_counts = phase_profile_step()
    emit({"phase": "four_arm_step", "batch": 100, "rounds": ARM_ROUNDS,
          "steps_per_round": ARM_STEPS, **four_arm_step()})
    serve_ucomp = phase_serve_ucomp()
    embed_records = phase_kernel_embed()
    embed_bwd_records = phase_kernel_embed_bwd()
    phase_train_parity_embed(default_run)
    train_embed, _ = phase_train_embed()
    serve_embed = phase_serve_embed()
    emit({"phase": "embed_vs_pallas", "batch": 100, "rounds": ARM_ROUNDS,
          "steps_per_round": ARM_STEPS, **embed_vs_pallas()})
    phase_classical()
    ehead = next(r for r in embed_records
                 if r['nq'] == 5 and r['N'] == 8192)
    estep = next(r for r in embed_records if r['nq'] == 5 and r['N'] == 100)
    ebwd = next(r for r in embed_bwd_records
                if r['nq'] == 5 and r['N'] == 100)
    ebwd_big = next(r for r in embed_bwd_records
                    if r['nq'] == 5 and r['N'] == 8192)
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
                     + serve_ucomp["hea_chain_fwd"]),
        "launches_by_path": {"serve": launches, "train": train_fwd,
                             "profile_step": ps_counts["hea_chain_fwd"],
                             "serve_ucomp": serve_ucomp["hea_chain_fwd"]},
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
        "launches": train_bwd + ps_counts["hea_chain_bwd"],
        "launches_by_path": {"serve": 0, "train": train_bwd,
                             "profile_step": ps_counts["hea_chain_bwd"],
                             "serve_ucomp": 0},
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
        "launches": q10_serve + q10_train_fwd,
        "launches_by_path": {"serve_q10": q10_serve,
                             "train_q10": q10_train_fwd},
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
        "launches": q10_train_bwd,
        "launches_by_path": {"serve_q10": 0, "train_q10": q10_train_bwd},
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
        "twin": "quanonet_torch/ops/cuda_ucomp.py:ucomp_dense",
        "launches": ps_counts["ucomp_fwd"] + serve_ucomp["ucomp_fwd"],
        "launches_by_path": {"profile_step": ps_counts["ucomp_fwd"],
                             "serve_ucomp": serve_ucomp["ucomp_fwd"]},
        "max_abs_err": max(r['max_abs_err_fwd'] for r in ucomp_records),
        "ms": ustep['fwd_ms'], "plain_ms": ustep['fwd_plain_ms'],
        "bound_ms": ustep['fwd_bound_ms'], "bound_by": ustep['fwd_bound_by'],
        "library_ms": None, "timed_shape": ucomp_shape,
        "device_ms": ustep['fwd_device_ms'],
        "smallest_launch_ms": ustep['smallest_launch']['back_to_back_ms'],
        "fold_forward_ms": ustep['replaces']['fold_forward_ms'],
        "compile_forward_ms": ustep['replaces']['compile_forward_ms'],
        "shapes": [[r['nb'], r['ld'], r['D']] for r in ucomp_records]}, {
        "name": "ucomp_bwd", "route": "cuda",
        "source": "quanonet_torch/csrc/ucomp.cu",
        "replaces": "quanonet_tpu/ops/pallas_ucomp.py:142",
        "twin": "quanonet_torch/ops/cuda_ucomp.py:ucomp_backward_dense",
        "launches": ps_counts["ucomp_bwd"],
        "launches_by_path": {"profile_step": ps_counts["ucomp_bwd"],
                             "serve_ucomp": 0},
        "max_abs_err": max(max(r['max_abs_err_bwd'].values())
                           for r in ucomp_records),
        "ms": ustep['bwd_ms'], "plain_ms": ustep['bwd_plain_ms'],
        "bound_ms": ustep['bwd_bound_ms'], "bound_by": ustep['bwd_bound_by'],
        "library_ms": None, "timed_shape": ucomp_shape,
        "device_ms": ustep['bwd_device_ms'],
        "smallest_launch_ms": ustep['smallest_launch']['back_to_back_ms'],
        "fold_forward_backward_ms":
            ustep['replaces']['fold_forward_backward_ms'],
        "compile_forward_backward_ms":
            ustep['replaces']['compile_forward_backward_ms'],
        "shapes": [[r['nb'], r['ld'], r['D']] for r in ucomp_records]}, {
        "name": "adam_step", "route": "cuda",
        "source": "quanonet_torch/csrc/adam.cu",
        "replaces": "quanonet_tpu/ops/pallas_adam.py:51",
        "twin": "quanonet_torch/ops/cuda_adam.py:adam_step_dense",
        "launches": ps_counts["adam_step"],
        "launches_by_path": {"profile_step": ps_counts["adam_step"],
                             "serve_ucomp": 0},
        "max_abs_err": adam['max_abs_err'],
        "ms": adam['ms'], "plain_ms": adam['plain_ms'],
        "bound_ms": adam['bound_ms'], "bound_by": adam['bound_by'],
        "library_ms": adam['library_ms'],
        "timed_shape": {"leaves": len(adam['leaves']),
                        "parameters": adam['parameters']},
        "device_ms": adam['device_ms'],
        "smallest_launch_ms": adam['smallest_launch']['back_to_back_ms'],
        "torch_adam_default_ms": adam['torch_adam_default_ms']}, {
        "name": "embed_chain_fwd", "route": "cuda",
        "source": "quanonet_torch/csrc/embed_chain.cu",
        "replaces": "quanonet_tpu/ops/pallas_embed.py:68",
        "twin": "quanonet_torch/ops/cuda_embed.py:chain_embed, "
                "chain_embed_saved",
        "launches": (train_embed["embed_chain_fwd"]
                     + serve_embed["embed_chain_fwd"]
                     + ps_counts["embed_chain_fwd"]),
        "launches_by_path": {"train_embed": train_embed["embed_chain_fwd"],
                             "serve_embed": serve_embed["embed_chain_fwd"],
                             "profile_step": ps_counts["embed_chain_fwd"]},
        "max_abs_err": max(max(r['max_abs_err_amp'], r['max_abs_err_s'],
                               r['max_abs_err_u']) for r in embed_records),
        "max_abs_err_expect": max(r['max_abs_err_expect']
                                  for r in embed_records),
        "ms": ehead['ms'], "plain_ms": ehead['plain_ms'],
        "bound_ms": ehead['bound_ms'], "bound_by": ehead['bound_by'],
        "library_ms": None, "device_ms": ehead['device_ms'],
        "timed_shape": {"nb": ehead['nb'], "N": ehead['N'], "d": ehead['d']},
        "residual_variant": {
            "ms": estep['saved_ms'], "plain_ms": estep['saved_plain_ms'],
            "bound_ms": estep['saved_bound_ms'],
            "timed_shape": {"nb": estep['nb'], "N": estep['N'],
                            "d": estep['d']}},
        "shapes": [[r['nb'], r['N'], r['d']] for r in embed_records]}, {
        "name": "embed_chain_bwd", "route": "cuda",
        "source": "quanonet_torch/csrc/embed_chain.cu",
        "replaces": "quanonet_tpu/ops/pallas_embed.py:85",
        "twin": "quanonet_torch/ops/cuda_embed.py:chain_embed_backward",
        "launches": (train_embed["embed_chain_bwd"]
                     + ps_counts["embed_chain_bwd"]),
        "launches_by_path": {"train_embed": train_embed["embed_chain_bwd"],
                             "serve_embed": 0,
                             "profile_step": ps_counts["embed_chain_bwd"]},
        "max_abs_err": max(max(r['max_abs_err'].values())
                           for r in embed_bwd_records),
        "ms": ebwd['ms'], "plain_ms": ebwd['plain_ms'],
        "bound_ms": ebwd['bound_ms'], "bound_by": ebwd['bound_by'],
        "library_ms": None, "device_ms": ebwd['device_ms'],
        "timed_shape": {"nb": ebwd['nb'], "N": ebwd['N'], "d": ebwd['d']},
        "at_N_8192": {"ms": ebwd_big['ms'], "plain_ms": ebwd_big['plain_ms'],
                      "bound_ms": ebwd_big['bound_ms'],
                      "bound_by": ebwd_big['bound_by']},
        "shapes": [[r['nb'], r['N'], r['d']] for r in embed_bwd_records]}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
