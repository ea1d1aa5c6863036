"""
HTTP JSON serving of trained checkpoints on the port (counterpart of
quanonet_tpu/serve.py), on ``cuda`` unless ``--device cpu`` is asked for.

* **Shape buckets.**  Every request batch is padded up to the next
  power-of-two bucket (capped at --max_batch), the same ladder and API as
  the JAX server, so a stream of request sizes runs a small fixed set of
  batch shapes; every bucket is run once at startup (--warmup, default
  on).  Requests over max_batch run as several chunks.
* **Parameters on the device once**; requests carry data only.  The
  threaded handler serialises device work under one lock, the right
  behaviour for a one-card server.
* **Memory.**  A bucket's chain operands grow with the register.  Up to
  7 qubits the block chain takes the raw phases (blocks, bucket, 2^n)
  fp32, 62.9 MB for the Q5 flagship at bucket 8192.  From 8 qubits the
  fused-group chain takes the angles (blocks, bucket, n), 19.7 MB for a
  Q10 Net40-2-20-2 model at bucket 8192, and builds the phases inside the
  kernel; the state is 2 × 8192 × 1024 × 4 B = 67 MB.  Lower --max_batch
  for wider registers.
* **Shots and noise.**  With --shots each prediction is estimated from
  sampled shots (ops/sampling.py), with --noise_p / --readout_p (or a
  ``_Noise`` checkpoint name) from --noise_traj noise trajectories
  (ops/noise.py); each executed bucket draws from a generator seeded from
  (--shot_seed, a counter of the buckets run), the JAX server's rule, so
  one server's answers replay from its seed.

CLI:  python -m quanonet_torch.serve --ckpt <best_model.ckpt|.npz>
          --branch_in 100 [--trunk_in 2] [--port 8777] [--max_batch 8192]
          [--shots N] [--noise_p P [--noise_traj T]] [--readout_p R]
          [--shot_seed S] [--device cuda|cpu]
API:  POST /predict   {"branch": [[...], ...], "trunk": [[...], ...]}
                      -> {"pred": [[...], ...], "n": N, "buckets": [B, ...]}
                      (one bucket per executed chunk; bodies over the
                      size cap get 413)
      GET  /healthz   -> {"ok": true}
      GET  /info      -> model config + bucket sizes + request counters
"""
import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

from quanonet_torch.infer import load_model
from quanonet_torch.ops.sampling import key_generator


def _buckets(max_batch):
    """Power-of-two bucket ladder 1,2,4,...,max_batch (inclusive)."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class Predictor:
    """Bucketed predictions over a loaded checkpoint."""

    def __init__(self, ckpt_path, branch_in, trunk_in=0, max_batch=8192,
                 device=None, shot_seed=0, **overrides):
        self.model, self.cfg = load_model(ckpt_path, branch_in, trunk_in,
                                          device=device, **overrides)
        self.shot_seed = int(shot_seed)
        self._sampled = bool(getattr(self.model, 'sampled', False))
        self._req_counter = 0
        self.device = next(self.model.parameters()).device
        self.branch_in = branch_in
        self.trunk_in = trunk_in
        self.max_batch = int(max_batch)
        self.buckets = _buckets(self.max_batch)
        self.requests = 0
        self.rows = 0
        self._lock = threading.Lock()
        mt = self.cfg.get('model_type')
        self._two_input = trunk_in > 0 and mt in ('QuanONet', 'DeepONet')
        self._concat = trunk_in > 0 and mt == 'FNN'

    def _bucket(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def buckets_for(self, n):
        """The bucket each executed chunk of an n-row request pads to
        (requests larger than max_batch run several chunks)."""
        return [self._bucket(min(self.max_batch, n - s))
                for s in range(0, max(n, 1), self.max_batch)]

    def predict(self, branch, trunk=None):
        """branch (n, branch_in) float32; trunk (n, trunk_in) or None.
        Pads each chunk to its bucket, runs it, slices the padding off."""
        branch = np.asarray(branch, np.float32)
        if branch.ndim != 2 or branch.shape[1] != self.branch_in:
            raise ValueError(
                f"branch must be (n, {self.branch_in}), got {branch.shape}")
        n = branch.shape[0]
        if (self._two_input or self._concat) and trunk is None:
            # never silently zero-fill a REQUIRED input: a client that
            # forgets the trunk would get confidently wrong predictions
            raise ValueError(
                f"model expects a trunk input (trunk_in={self.trunk_in})")
        if trunk is not None:
            trunk = np.asarray(trunk, np.float32)
            if trunk.shape != (n, self.trunk_in):
                raise ValueError(
                    f"trunk must be ({n}, {self.trunk_in}), "
                    f"got {trunk.shape}")
        preds = []
        for s in range(0, n, self.max_batch):
            nb = min(self.max_batch, n - s)
            preds.append(self._run_bucket(
                branch[s:s + nb], None if trunk is None else trunk[s:s + nb]))
        with self._lock:
            self.requests += 1
            self.rows += n
        return np.concatenate(preds, axis=0)

    def _run_bucket(self, branch, trunk):
        """Pad one ≤max_batch slice to its bucket, run the model, slice the
        padding back off."""
        nb = branch.shape[0]
        b = self._bucket(nb)
        bp = np.zeros((b, self.branch_in), np.float32)
        bp[:nb] = branch
        inp = [bp]
        if self._two_input or self._concat:
            tp = np.zeros((b, self.trunk_in), np.float32)
            if trunk is not None:
                tp[:nb] = trunk
            inp = [np.concatenate([bp, tp], axis=1)] if self._concat \
                else [bp, tp]
        with self._lock, torch.inference_mode():
            kw = {}
            if self._sampled:
                self._req_counter += 1
                kw['generator'] = key_generator(
                    self.shot_seed, self._req_counter, device=self.device)
            out = self.model(*(torch.as_tensor(a, device=self.device)
                               for a in inp), **kw)
            out = out.cpu().numpy()
        return out[:nb]

    def warmup(self):
        """Run every bucket once so live traffic meets no first-call cost
        (kernel build and load, allocator growth)."""
        t0 = time.time()
        for b in self.buckets:
            bp = np.zeros((b, self.branch_in), np.float32)
            tp = (np.zeros((b, self.trunk_in), np.float32)
                  if self.trunk_in else None)
            self._run_bucket(bp, tp)
        return time.time() - t0

    def info(self):
        cfg = {k: v for k, v in self.cfg.items()
               if isinstance(v, (str, int, float, bool, list, tuple))
               or v is None}
        with self._lock:
            counters = dict(requests=self.requests, rows=self.rows)
        return dict(model_type=self.cfg.get('model_type'),
                    branch_in=self.branch_in, trunk_in=self.trunk_in,
                    buckets=self.buckets, config=cfg, **counters)


def make_server(pred: Predictor, host='127.0.0.1', port=8777,
                max_body_bytes=None):
    """Build (not start) a ThreadingHTTPServer wired to the predictor.

    max_body_bytes caps POST bodies (413 beyond it) so one oversized JSON
    payload can't exhaust memory; the default budgets ~32 bytes of JSON
    text per input float for a full max_batch request, floored at 8 MiB.
    The endpoint is UNAUTHENTICATED — bind loopback (default) unless the
    network is trusted."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if max_body_bytes is None:
        row_floats = pred.branch_in + max(pred.trunk_in, 0) + 1
        max_body_bytes = max(8 << 20, 32 * row_floats * pred.max_batch)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                self._send(200, {"ok": True})
            elif self.path == '/info':
                self._send(200, pred.info())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != '/predict':
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get('Content-Length', 0))
                if length > max_body_bytes:
                    self._send(413, {"error":
                                     f"request body {length} bytes exceeds "
                                     f"the {max_body_bytes}-byte cap "
                                     f"(split the batch across requests)"})
                    return
                req = json.loads(self.rfile.read(length))
                branch = req['branch']
                trunk = req.get('trunk')
                n = len(branch)
                out = pred.predict(branch, trunk)
                self._send(200, {"pred": out.tolist(), "n": n,
                                 "buckets": pred.buckets_for(n)})
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:   # keep the server alive on bad input
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet access log -> stderr
            print(f"[serve] {self.address_string()} {fmt % args}",
                  file=sys.stderr)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a trained QuanONet checkpoint over HTTP "
                    "(PyTorch/CUDA port)")
    ap.add_argument('--ckpt', required=True)
    ap.add_argument('--branch_in', type=int, required=True)
    ap.add_argument('--trunk_in', type=int, default=0)
    ap.add_argument('--host', default='127.0.0.1',
                    help='bind address; the endpoint is UNAUTHENTICATED — '
                         'anything beyond the loopback default exposes '
                         'predictions to the whole network')
    ap.add_argument('--port', type=int, default=8777)
    ap.add_argument('--max_batch', type=int, default=8192)
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    ap.add_argument('--shots', type=int, default=None,
                    help='Finite-shot sampled predictions (QPU emulation)')
    ap.add_argument('--noise_p', type=float, default=None,
                    help='Noisy predictions via Pauli trajectories '
                         '(ops/noise.py)')
    ap.add_argument('--readout_p', type=float, default=None)
    ap.add_argument('--noise_traj', type=int, default=None)
    ap.add_argument('--shot_seed', type=int, default=0,
                    help='Seed of the --shots and noise sampling')
    ap.add_argument('--no_warmup', action='store_true')
    args = ap.parse_args(argv)

    overrides = {k: getattr(args, k) for k in
                 ('shots', 'noise_p', 'readout_p', 'noise_traj')
                 if getattr(args, k) is not None}
    pred = Predictor(args.ckpt, args.branch_in, args.trunk_in,
                     max_batch=args.max_batch, device=args.device,
                     shot_seed=args.shot_seed, **overrides)
    if not args.no_warmup:
        print(f"[serve] warming {len(pred.buckets)} buckets "
              f"(max {args.max_batch})...", flush=True)
        dt = pred.warmup()
        print(f"[serve] warmup done in {dt:.1f}s", flush=True)
    srv = make_server(pred, args.host, args.port)
    print(f"[serve] listening on http://{args.host}:{srv.server_port} "
          f"(POST /predict, GET /healthz, GET /info) on {pred.device}",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
        srv.shutdown()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
