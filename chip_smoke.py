#!/usr/bin/env python3
"""
Drives the PyTorch/CUDA port (quanonet_torch) on one NVIDIA card and checks
it.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
             versions; TF32 matmuls must be off (they shift the model's
             quality band).
2. build   — builds every kernel of the served path from csrc/
             (torch.utils.cpp_extension.load, nvcc for sm_90a) and reports
             the build time.
3. kernel  — each kernel against its plain PyTorch version on the card at
             the shapes the served path gives it (random seeded weights):
             the flagship Q5 Net40-2-20-2 at N in {1, 7, 100, 1000, 8192},
             Q2 Net5-1-5-1, Q7 (D = 128), and the other widths.  Max abs
             error on the amplitudes (<= 2e-5) and the expectation
             (<= 1e-4); median times over CUDA events; the bound from the
             H100 SXM datasheet (67 TFLOP/s fp32, 3.35 TB/s).
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

Then the {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check exits non-zero before
the last line.  Needs one card; exits 1 without CUDA.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.utils import cpp_extension

from quanonet_torch.infer import load_model, predict
from quanonet_torch.ops import _build, cuda_hea, hea
from quanonet_torch.ops.hamiltonian import simple_ham_diag
from quanonet_torch.serve import Predictor, make_server

REPO = os.path.dirname(os.path.abspath(__file__))
ANCHOR = os.path.join(
    REPO, 'pretrained_weights', 'Advection',
    'Advection_QuanONet_Net40-2-20-2_Q5_TF_S0.1_1000x100_Seed0',
    'best_model.ckpt')
FIXTURE = os.path.join(REPO, 'tests', 'fixtures',
                       'torch_port_advection_anchor.npz')

# H100 SXM datasheet peaks at its full 700 W limit
PEAK_FP32_FLOPS = 67e12
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
    t0 = time.time()
    lib = _build.build(cuda_hea.KERNEL)
    seconds = time.time() - t0
    emit({"phase": "build", "kernel": cuda_hea.KERNEL,
          "library": os.path.relpath(lib, REPO), "seconds": seconds})


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
               "max_abs_err_amp": err_amp, "max_abs_err_expect": err_exp,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "share_of_bound": bound_ms / ms}
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

    cuda_hea.launches = 0            # the served path starts here
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

    srv = make_server(pred, host='127.0.0.1', port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        code, resp = _post(srv.server_port, '/predict',
                           {"branch": fb.tolist(), "trunk": ft.tolist()})
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
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
    check(not thread.is_alive(), "server thread did not stop")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi_line = phase_device()
    phase_build()
    records = phase_kernel()
    launches = phase_serve()
    head = next(r for r in records
                if r['nq'] == 5 and r['N'] == 8192)
    emit({"kernels": [{
        "name": "hea_chain_fwd", "route": "cuda",
        "source": "quanonet_torch/csrc/hea_chain.cu",
        "replaces": "quanonet_tpu/ops/pallas_hea.py:153",
        "twin": "quanonet_torch/ops/hea.py:chain_dense",
        "launches": launches,
        "max_abs_err": max(r['max_abs_err_amp'] for r in records),
        "max_abs_err_expect": max(r['max_abs_err_expect'] for r in records),
        "ms": head['ms'], "plain_ms": head['plain_ms'],
        "bound_ms": head['bound_ms'], "bound_by": head['bound_by'],
        "library_ms": None,
        "timed_shape": {"nb": head['nb'], "N": head['N'], "D": head['D']},
        "shapes": [[r['nb'], r['N'], r['D']] for r in records]}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
