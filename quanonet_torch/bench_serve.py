#!/usr/bin/env python3
"""
Serving-path benchmark of the port (counterpart of scripts/bench_serve.py):
per-bucket request latency and throughput of serve.Predictor, its peak
device memory, and the HTTP layer's overhead.

    python -m quanonet_torch.bench_serve [--ckpt ...] [--branch_in 10]
        [--trunk_in 1] [--max_batch 8192] [--reps 20] [--device cuda|cpu]
        [--out docs/serving_torch.json]

The default checkpoint is the JAX script's, the Q2 Antideriv anchor, so
the two files compare like with like.  Predictor.warmup runs every bucket
once; then, per bucket of the power-of-two ladder, one untimed request and
``--reps`` timed ones on seeded rows (NumPy in, NumPy out, each call ending
on the host, so the host clock times the whole request):

  latency_ms        median Predictor.predict wall time a request
  rows_per_sec      bucket / latency, the rate of clients batching there
  peak_memory_bytes torch.cuda.max_memory_allocated over the bucket's
                    requests, from a reset (None on the CPU)
  launches          the kernel launches of one request, by kernel

and at bucket 64 (``http_overhead_ms_at_64``) a loopback round trip
through serve.make_server minus the direct call, medians of 10.  Every
timed request and the HTTP answer must equal the bucket's untimed
Predictor.predict bit for bit (``gates``; exit 1 otherwise).  Runs on the
card and raises without one unless ``--device cpu``; the results carry the
card's name and power limit.
"""
import argparse
import json
import os
import statistics
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from quanonet_torch.profile_step import (
    card_line, launch_counts, launches_since, peak_memory,
)
from quanonet_torch.serve import Predictor, make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CKPT = os.path.join(
    REPO, 'pretrained_weights/Antideriv/'
    'Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_1000x100_Seed0/'
    'best_model.npz')
HTTP_BUCKET = 64
HTTP_REPS = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _wall(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def bucket_rows(pred, reps, rng):
    """The per-bucket rows and whether every timed request equalled the
    bucket's untimed one."""
    rows, equal = [], True
    for b in pred.buckets:
        branch = rng.randn(b, pred.branch_in).astype(np.float32)
        trunk = (rng.rand(b, pred.trunk_in).astype(np.float32)
                 if pred.trunk_in else None)
        before = launch_counts()
        want = pred.predict(branch, trunk)
        launches = launches_since(before)

        def timed():
            walls = [_wall(lambda: pred.predict(branch, trunk))
                     for _ in range(reps)]
            return ([dt for dt, _ in walls],
                    all(np.array_equal(out, want) for _, out in walls))
        (times, same), peak = peak_memory(timed, pred.device)
        equal = equal and same
        lat = statistics.median(times)
        rows.append(dict(bucket=b, latency_ms=lat * 1e3,
                         rows_per_sec=b / lat, peak_memory_bytes=peak,
                         launches=launches))
        log(f"  bucket {b:>6}: {lat * 1e3:9.3f} ms/request  "
            f"{b / lat:12,.0f} rows/s  peak {peak}")
    return rows, equal


def http_overhead(pred, rng):
    """(ms of a loopback round trip minus a direct call at bucket 64,
    whether the HTTP answer equals the direct call's bit for bit)."""
    b = min(HTTP_BUCKET, pred.max_batch)
    branch = rng.randn(b, pred.branch_in).astype(np.float32)
    trunk = (rng.rand(b, pred.trunk_in).astype(np.float32)
             if pred.trunk_in else None)
    body = {"branch": branch.tolist()}
    if trunk is not None:
        body["trunk"] = trunk.tolist()
    payload = json.dumps(body).encode()
    srv = make_server(pred, host='127.0.0.1', port=0)
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    try:
        url = f'http://127.0.0.1:{srv.server_port}/predict'

        def post():
            req = urllib.request.Request(
                url, data=payload, headers={'Content-Type':
                                            'application/json'})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())
        direct = pred.predict(branch, trunk)
        answer = post()
        direct_s = statistics.median(
            _wall(lambda: pred.predict(branch, trunk))[0]
            for _ in range(HTTP_REPS))
        http_s = statistics.median(_wall(post)[0] for _ in range(HTTP_REPS))
    finally:
        srv.shutdown()
        srv.server_close()
        thr.join(timeout=10)
    got = np.asarray(answer["pred"], np.float32)
    return (http_s - direct_s) * 1e3, b, bool(np.array_equal(got, direct))


def run(ckpt, branch_in, trunk_in, max_batch=8192, reps=20, device=None,
        seed=0):
    """The serving result (the JAX file's keys, plus the card, memory,
    launches and gates) of one checkpoint."""
    pred = Predictor(ckpt, branch_in, trunk_in, max_batch=max_batch,
                     device=device)
    dev = pred.device
    log(f"device: {dev}; warming {len(pred.buckets)} buckets...")
    warmup_s = pred.warmup()
    rng = np.random.RandomState(seed)
    rows, equal = bucket_rows(pred, reps, rng)
    overhead, http_b, http_equal = http_overhead(pred, rng)
    log(f"HTTP loopback overhead at bucket {http_b}: {overhead:.3f} ms")
    return dict(
        platform=dev.type, ckpt=os.path.basename(os.path.dirname(ckpt))
        + '/' + os.path.basename(ckpt),
        engine=pred.cfg.get('engine'), max_batch=max_batch, reps=reps,
        warmup_s=warmup_s, buckets=rows, http_overhead_ms_at_64=overhead,
        http_bucket=http_b,
        device_name=(torch.cuda.get_device_name(dev)
                     if dev.type == 'cuda' else 'cpu'),
        nvidia_smi=card_line(dev), torch=torch.__version__,
        latency="median host-clock wall of Predictor.predict (NumPy in, "
                "NumPy out)",
        gates={"timed requests equal Predictor.predict": equal,
               "HTTP answer equals Predictor.predict": http_equal})


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--ckpt', default=DEFAULT_CKPT)
    ap.add_argument('--branch_in', type=int, default=10)
    ap.add_argument('--trunk_in', type=int, default=1)
    ap.add_argument('--max_batch', type=int, default=8192)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default='docs/serving_torch.json',
                    help='results file, relative to the current directory')
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    result = run(args.ckpt, args.branch_in, args.trunk_in, args.max_batch,
                 args.reps, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    log(f"wrote {args.out}")
    print(json.dumps(result), flush=True)
    if not all(result["gates"].values()):
        log("FAILED: " + ", ".join(k for k, v in result["gates"].items()
                                   if not v))
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
