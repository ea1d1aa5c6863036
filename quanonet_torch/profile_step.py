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
                      block matrices (batch-independent work), by the
                      engine's route (cuda_hea.compile_route): the compile
                      kernels (ops/cuda_ucomp.py) on the card, the autograd
                      fold on the CPU or with USE_UCOMP=0
  adam_only           the optimizer's update on frozen gradients
  batch sweep         full_step[first engine] at bs in {400, 1600}: the
                      fixed-vs-variable cost split

Usage:
    python -m quanonet_torch.profile_step [--iters N]
        [--engines pallas,embed,dense] [--fused_adam] [--device cuda|cpu]
        [--out docs/step_profile_torch.json]

Runs on the card and raises without one; ``--device cpu`` times the plain
versions on the CPU.  ``--fused_adam`` takes the one-launch Adam
(ops/cuda_adam.py) in full_step and adam_only, where torch.optim.Adam is
the default here; ``USE_UCOMP`` picks the block matrices' route in every
'pallas' and 'embed' step and in compile_path (unset: the compile kernels
on the card; ``USE_UCOMP=0`` forces the fold, ``1`` the compile kernels
on the CPU too).  Writes the results, with the
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


def launch_counts():
    """Every kernel wrapper's launch count so far, by kernel."""
    from quanonet_torch.ops import cuda_adam, cuda_embed, cuda_fused, \
        cuda_ucomp
    return {"hea_chain_fwd": cuda_hea.launches,
            "hea_chain_bwd": cuda_hea.bwd_launches,
            "fused_chain_fwd": cuda_fused.launches,
            "fused_chain_bwd": cuda_fused.bwd_launches,
            "ucomp_fwd": cuda_ucomp.launches,
            "ucomp_bwd": cuda_ucomp.bwd_launches,
            "adam_step": cuda_adam.launches,
            "embed_chain_fwd": cuda_embed.launches,
            "embed_chain_bwd": cuda_embed.bwd_launches,
            "ucomp_bf16_fwd": cuda_ucomp.bf16_launches,
            "ucomp_bf16_bwd": cuda_ucomp.bf16_bwd_launches,
            "fused_chain_bf16_fwd": cuda_fused.bf16_launches,
            "fused_chain_bf16_bwd": cuda_fused.bf16_bwd_launches}


def launches_since(before):
    """The launches by kernel since ``before`` (a :func:`launch_counts`),
    the kernels that launched only."""
    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}


def event_ms(fn, iters, device, warmup=WARMUP):
    """Mean ms a call of fn() over ``iters`` calls after ``warmup`` calls:
    two CUDA events around the loop on the card, the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_rows(events, match=None):
    """{name: [launches, device µs]} of the card's own rows (kernels,
    copies) among a trace's raw events, read without building the
    profiler's event tree, whose cost grows with every row of the trace."""
    rows = {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        annotation = getattr(e, 'is_user_annotation', None)
        if annotation is not None and annotation():
            continue
        name = e.name()
        if match is not None and match not in name:
            continue
        row = rows.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += e.duration_ns() / 1e3
    return rows


def profile_steps(step, steps, match=None, warm=0):
    """The card's busy share over ``steps`` calls of step() under
    torch.profiler, and the kernels that take it; with ``match``, only the
    kernels whose name holds it.  With ``warm``, the window starts after
    ``warm`` calls made under the profiler (its schedule's warm-up step):
    a fresh window can miss the rows of its first kernels.  The device
    rows are the card's own (kernels, copies), not the spans that
    ``record_function`` annotations (such as ``Optimizer.step``) also get
    on the card's timeline."""
    from torch.profiler import ProfilerActivity, profile, schedule
    try:
        torch.cuda.synchronize()
        sched = ({"schedule": schedule(wait=0, warmup=1, active=1, repeat=1)}
                 if warm else {})
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **sched) as prof:
            if warm:
                for _ in range(warm):
                    step()
                torch.cuda.synchronize()
                prof.step()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
            if warm:
                prof.step()
        rows = _device_rows(prof.profiler.kineto_results.events(), match)
        busy_us = sum(us for _, us in rows.values())
        if not busy_us:
            return {"profiler_error": "no device rows in the trace"}
        launches = sum(n for n, _ in rows.values())
        top = sorted(rows.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
        return {
            "profiled_steps": steps, "profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_kernels": launches,
            "device_kernels_per_step": launches / steps,
            # each row's launches and card time, by kernel
            "device_rows": [(n, us / 1e3) for n, us in rows.values()],
            "top_device_ms_per_step": {
                name[:60]: us / 1e3 / steps for name, (_, us) in top}}
    except RuntimeError as e:     # the profiler is a measurement, no check
        return {"profiler_error": str(e)[:200]}


# the work a busy-share window holds: long enough to average over calls,
# short enough that the trace stays small
BUSY_WINDOW_MS = 250.0


def busy_share(step, device, call_ms):
    """:func:`profile_steps` of step() on the card over about
    BUSY_WINDOW_MS of calls (1 to 10, ``call_ms`` each) after one warm-up
    call: device rows a call, the busy share and the kernels that take it;
    on the CPU a note that it was not measured."""
    if device.type != 'cuda':
        return {"device_busy": "not measured: CPU run"}
    steps = max(1, min(10, int(BUSY_WINDOW_MS / max(call_ms, 1e-3))))
    out = profile_steps(step, steps, warm=1)
    out.pop("device_rows", None)
    return out


def peak_memory(fn, device):
    """fn()'s result and its peak device memory (bytes,
    ``torch.cuda.max_memory_allocated`` from a reset); None on the CPU."""
    if device.type != 'cuda':
        return fn(), None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, torch.cuda.max_memory_allocated(device)


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
