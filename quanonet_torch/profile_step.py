#!/usr/bin/env python3
"""
Component-level timing of the flagship train step (Q5 Advection,
Net40-2-20-2, bs=100): where does a step's time go (counterpart of the
JAX package's profile_step.py at the root of the repository)?  The
sequential block chain, the batch-independent block-matrix compile, the
optimizer, or the host issuing small kernels.

PyTorch runs eagerly, so each component is a plain loop of ``--iters``
calls, timed by the host clock between two ``torch.cuda.synchronize()``
calls after a warm-up pass (which also builds the kernels).

Components (microseconds per iteration):
  full_step[engine]   loss, backward and the Adam update (the real step)
  fwd_only[engine]    model forward + mean under no_grad (inference path)
  compile_path        forward + backward of a scalar reduction of the
                      block matrices (batch-independent work): the
                      autograd fold, or with USE_UCOMP=1 the compile
                      kernels (ops/cuda_ucomp.py), as the engine takes them
  adam_only           the optimizer's update on frozen gradients
  batch sweep         full_step[first engine] at bs in {400, 1600}: the
                      fixed-vs-variable cost split

Usage:
    python -m quanonet_torch.profile_step [--iters N]
        [--engines pallas,embed,dense] [--fused_adam] [--device cuda|cpu]
        [--out docs/step_profile_torch.json]

Runs on the card and raises without one; ``--device cpu`` times the plain
versions on the CPU.  ``--fused_adam`` takes the one-launch Adam
(ops/cuda_adam.py) in full_step and adam_only; ``USE_UCOMP=1`` in the
environment takes the compile kernels in every 'pallas' and 'embed' step and in
compile_path.  Both are off by default.  Writes the results, with the
card's name and power limit, to ``--out`` (relative to the current
directory) and prints them as the last line of stdout; a table goes to
stderr.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import cuda_hea
from quanonet_torch.ops.cuda_adam import fused_adam
from quanonet_torch.ops.hea import quanonet_spec, resolve_engine

NUM_QUBITS, NET_SIZE = 5, (40, 2, 20, 2)   # the flagship's shape
WARMUP = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iters', type=int, default=200)
    ap.add_argument('--engines', default='pallas,embed,dense')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--fused_adam', action='store_true',
                    help='use the one-launch Adam (ops/cuda_adam.py) in '
                         'full_step and adam_only')
    ap.add_argument('--out', default='docs/step_profile_torch.json',
                    help='results file, relative to the current directory')
    return ap


def card_line(device):
    """The card's name and power limit as nvidia-smi gives them; None on
    the CPU."""
    if device.type != 'cuda':
        return None
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def main(argv=None):
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    engines = args.engines.split(',')
    for engine in engines:
        resolve_engine(engine, NUM_QUBITS, dev)   # raises if unknown
    iters = args.iters
    log(f"device: {dev}  iters={iters}  USE_UCOMP={cuda_hea.USE_UCOMP}  "
        f"fused_adam={args.fused_adam}")

    rng = np.random.RandomState(0)
    results = {}

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    def timed(name, fn):
        """fn() WARMUP times, then ``iters`` times between synchronises."""
        t0 = time.time()
        for _ in range(WARMUP):
            fn()
        sync()
        log(f"  {name}: warm-up {time.time() - t0:.1f}s")
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        dt = time.perf_counter() - t0
        us = dt / iters * 1e6
        log(f"  {name}: {us:.2f} us/iter  ({dt:.3f}s total)")
        results[name] = us
        return us

    def make_optimizer(model):
        if args.fused_adam:
            return fused_adam(1e-4).init(model.parameters())
        return torch.optim.Adam(model.parameters(), lr=1e-4)

    def make_model(engine):
        return QuanONet(NUM_QUBITS, 100, 2, NET_SIZE, scale_coeff=0.1,
                        if_trainable_freq=True, engine=engine, device=dev,
                        generator=torch.Generator().manual_seed(0))

    def model_step_timer(engine, bs):
        model = make_model(engine)
        b = torch.as_tensor(rng.randn(bs, 100).astype(np.float32), device=dev)
        t = torch.as_tensor(rng.rand(bs, 2).astype(np.float32), device=dev)
        y = torch.as_tensor(rng.randn(bs, 1).astype(np.float32), device=dev)
        optimizer = make_optimizer(model)

        def full():
            loss = ((model(b, t) - y) ** 2).mean()
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()

        def fwd():
            with torch.no_grad():
                return model(b, t).mean()

        return full, fwd

    for engine in engines:
        full, fwd = model_step_timer(engine, 100)
        timed(f'full_step[{engine}] bs=100', full)
        timed(f'fwd_only[{engine}] bs=100', fwd)

    # batch sweep on the first engine
    for bs in (400, 1600):
        full, _ = model_step_timer(engines[0], bs)
        timed(f'full_step[{engines[0]}] bs={bs}', full)

    # compile path only: forward + backward of the block matrices
    spec = quanonet_spec(NUM_QUBITS, NET_SIZE)
    w = torch.as_tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                        .astype(np.float32), device=dev).requires_grad_()

    def compile_step():
        mr, mi = cuda_hea.block_mats(spec, w)
        (g,) = torch.autograd.grad((mr * mr).sum() + (mi * mi).sum(), w)
        with torch.no_grad():
            w.add_(g, alpha=1e-12)
    timed('compile_path fwd+bwd', compile_step)

    # adam only (the full model's parameters, frozen gradients)
    model = make_model('dense')
    optimizer = make_optimizer(model)
    for p in model.parameters():
        p.grad = p.detach() * 1e-3
    timed('adam_only', optimizer.step)

    results['platform'] = dev.type
    results['iters'] = iters
    results['unit'] = 'us/iter'
    results['use_ucomp'] = cuda_hea.USE_UCOMP
    results['fused_adam'] = args.fused_adam
    results['num_qubits'] = NUM_QUBITS
    results['net_size'] = list(NET_SIZE)
    results['device_name'] = (torch.cuda.get_device_name(dev)
                              if dev.type == 'cuda' else 'cpu')
    results['nvidia_smi'] = card_line(dev)
    results['torch'] = torch.__version__
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(results, f, indent=2)
    log(f"wrote {args.out}")
    print(json.dumps(results), flush=True)
    return results


if __name__ == '__main__':
    main()
