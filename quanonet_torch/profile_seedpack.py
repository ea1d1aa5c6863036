#!/usr/bin/env python3
"""
Seed-packing throughput of the port (counterpart of the repository's
profile_seedpack.py): S seeds of the flagship train step (Q5 Advection,
Net40-2-20-2, batch 100) stepped as one packed model
(models/packed.PackedModel, the route of ``--multi_seed``) against the
same S seeds stepped one after another in this process, the two arms in
turns, so that both see the same host.

    python -m quanonet_torch.profile_seedpack [--iters N] [--seeds 1,2,4,8]
        [--rounds R] [--bs B] [--device cuda|cpu]
        [--out docs/seedpack_profile_torch.json]

Per S: ms a step of each arm (the median over ``--rounds`` rounds of
``--iters`` steps, host clock between synchronises; a sequential step is
S single-seed steps), aggregate samples/s (S · bs a step), each arm's
kernel launches in one step, the packed arm's losses (finite, and
falling over the run), and for each arm its device rows, its card busy
time and share (torch.profiler over a warmed window; "not measured" where
the trace holds no device row).  The batches are random, seeded; the
optimizer is the solver's (solver.build_optimizer, Adam at 1e-4) over the
stacked leaves or each seed's own.

Runs on the card and raises without one (``--device cpu``: the plain
versions).  Writes its results with the card's name and power limit to
``--out`` (relative to the current directory; never the JAX tool's
docs/seedpack_profile.json) and prints them as the last line of stdout.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.models import QuanONet
from quanonet_torch.models.packed import PackedModel
from quanonet_torch.ops import cuda_fused, cuda_hea, cuda_ucomp
from quanonet_torch.profile_step import card_line, profile_steps
from quanonet_torch.solver import build_optimizer

NUM_QUBITS, NET_SIZE = 5, (40, 2, 20, 2)   # the flagship's shape
WARMUP = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iters', type=int, default=50,
                    help='steps of an arm in one round')
    ap.add_argument('--rounds', type=int, default=5)
    ap.add_argument('--seeds', default='1,2,4,8',
                    help='the pack sizes S, comma-separated')
    ap.add_argument('--bs', type=int, default=100)
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    ap.add_argument('--out', default='docs/seedpack_profile_torch.json',
                    help='results file, relative to the current directory')
    return ap


def _model(seed, dev):
    return QuanONet(NUM_QUBITS, 100, 2, NET_SIZE, scale_coeff=0.1,
                    if_trainable_freq=True, device=dev,
                    generator=torch.Generator().manual_seed(seed))


def _optimizer(params, steps):
    return build_optimizer(dict(optimizer='adam', learning_rate=1e-4),
                           steps, params)


def arms(s, bs, dev, steps):
    """(packed step, sequential step, the packed step's losses): S seeds
    on S random batches, one packed model or S models in turn."""
    rng = np.random.RandomState(s)
    b = torch.as_tensor(rng.randn(s, bs, 100).astype(np.float32), device=dev)
    t = torch.as_tensor(rng.rand(s, bs, 2).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.randn(s, bs, 1).astype(np.float32), device=dev)
    pack = PackedModel([_model(i, dev) for i in range(s)])
    popt = _optimizer(pack.parameters(), steps)
    losses = []

    def packed():
        loss = ((pack(b, t) - y) ** 2).mean(dim=(1, 2))
        popt.zero_grad()
        loss.sum().backward()
        popt.step()
        losses.append(loss.detach())

    singles = [_model(i, dev) for i in range(s)]
    sopts = [_optimizer(m.parameters(), steps) for m in singles]

    def sequential():
        for i, (m, opt) in enumerate(zip(singles, sopts)):
            loss = ((m(b[i], t[i]) - y[i]) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()

    return packed, sequential, losses


def launches_per_step(step):
    """The port's kernel launches in one call of step(), by kernel."""
    before = _launch_counts()
    step()
    return {k: v - before[k] for k, v in _launch_counts().items()}


def _launch_counts():
    return {"hea_chain_fwd": cuda_hea.launches,
            "hea_chain_bwd": cuda_hea.bwd_launches,
            "fused_chain_fwd": cuda_fused.launches,
            "fused_chain_bwd": cuda_fused.bwd_launches,
            "ucomp_fwd": cuda_ucomp.launches,
            "ucomp_bwd": cuda_ucomp.bwd_launches}


def device_profile(step, steps=10, warm=3):
    """Device rows a step, the card's busy ms a step and its share of the
    wall time, over ``steps`` calls of step() in a torch.profiler window
    opened after ``warm`` calls (profile_step.profile_steps);
    {'profiler_error': ...} where the trace holds no device row."""
    prof = profile_steps(step, steps, warm=warm)
    if "profiler_error" in prof:
        return prof
    return {"device_rows_per_step": prof["device_kernels_per_step"],
            "device_busy_ms_per_step": prof["device_busy_ms"] / steps,
            "device_busy_share": prof["device_busy_share"]}


def sweep(args, dev):
    """The S sweep: {S: per-arm times, rates, losses, device profile}."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == 'cuda' \
        else (lambda: None)
    packs = {}
    steps = (args.rounds * args.iters + WARMUP) * 2 + 40
    for s in [int(v) for v in args.seeds.split(',')]:
        packed, sequential, losses = arms(s, args.bs, dev, steps)
        turns = {'packed': packed, 'sequential': sequential}
        times = {k: [] for k in turns}
        for step in turns.values():
            for _ in range(WARMUP):
                step()
        launches = {name: launches_per_step(step)
                    for name, step in turns.items()}
        for _ in range(args.rounds):
            for name, step in turns.items():
                sync()
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    step()
                sync()
                times[name].append(1e3 * (time.perf_counter() - t0)
                                   / args.iters)
        row = {}
        for name in turns:
            ms = float(np.median(times[name]))
            row[name] = {"ms_per_step": ms, "ms_rounds": times[name],
                         "samples_per_sec": s * args.bs / (ms / 1e3),
                         "launches_per_step": launches[name]}
        trace = torch.stack(losses).cpu().numpy()          # (steps, S)
        row["packed"]["loss_first"] = trace[0].tolist()
        row["packed"]["loss_last"] = trace[-1].tolist()
        row["packed"]["losses_finite"] = bool(np.isfinite(trace).all())
        row["packed"]["losses_falling"] = bool(
            (trace[-1] < trace[0]).all())
        if dev.type == 'cuda':
            row["packed"].update(device_profile(packed))
            row["sequential"].update(device_profile(sequential))
        row["packed_over_sequential"] = (row["packed"]["samples_per_sec"]
                                         / row["sequential"]["samples_per_sec"])
        log(f"  S={s}: packed {row['packed']['ms_per_step']:.3f} ms "
            f"({row['packed']['samples_per_sec']:,.0f} samples/s), "
            f"sequential {row['sequential']['ms_per_step']:.3f} ms "
            f"({row['sequential']['samples_per_sec']:,.0f} samples/s)")
        packs[str(s)] = row
    base = packs.get('1')
    if base:
        for s, row in packs.items():
            row["packed_speedup_vs_S1"] = (row["packed"]["samples_per_sec"]
                                           / base["packed"]["samples_per_sec"])
    return {"bs": args.bs, "iters": args.iters,
            "rounds": args.rounds, "packs": packs}


def main(argv=None):
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device: {dev}")
    out = sweep(args, dev)
    out.update({"platform": dev.type,
                "device_name": (torch.cuda.get_device_name(dev)
                                if dev.type == 'cuda' else 'cpu'),
                "nvidia_smi": card_line(dev), "torch": torch.__version__,
                "num_qubits": NUM_QUBITS, "net_size": list(NET_SIZE)})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=2)
    log(f"wrote {args.out}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
