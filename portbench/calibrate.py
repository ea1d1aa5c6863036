"""
The readings the limits and the serving rate are set from, on the card,
many seeds in one process (the kernels build once):

    python3 portbench/calibrate.py readings --workload W --seeds 1,2,...
        [--control_seeds 3,4,5] [--fault NAME --fault_seeds 6,7,8]
        [--seconds 2]
    python3 portbench/calibrate.py sweep --workload q10_serve_open
        --rates 80,120,160 [--seconds 20] [--seed 1] [--trace 1]

``readings`` prints one JSON line a run: the cell's compared numbers for
the program (sound runs: the lower readings) on each seed, for the TF32
control put in the program's place (on ``--control_seeds``, after the
program's own run of that seed: a training control goes on from the same
states), and for the program with one fault planted underneath its timed
path (see :data:`FAULTS`).  ``sweep`` runs the serving window at each
rate, each a cell of its own built from the traffic with that rate, and
prints the latencies, how busy the server was, and whether the backlog
grew; ``--trace 1`` runs each window under the profiler, as a traced run
does.  The knee is the highest rate at which the backlog did not grow.
"""
import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """Half of each batch left out of the loss, the mean taken over the
    rest."""
    from quanonet_torch import solver
    plain = solver.padded_batches

    def broken(perm, num_samples, batch_size):
        idx, masks = plain(perm, num_samples, batch_size)
        masks = masks.clone()
        masks[:, batch_size // 2:] = 0
        return idx, masks

    solver.padded_batches = broken
    try:
        yield
    finally:
        solver.padded_batches = plain


@contextlib.contextmanager
def unchanged():
    """Each optimizer step returns the state unchanged."""
    from quanonet_torch import solver
    plain = solver.ScheduledOptimizer.step

    def broken(self):
        self.count += 1

    solver.ScheduledOptimizer.step = broken
    try:
        yield
    finally:
        solver.ScheduledOptimizer.step = plain


@contextlib.contextmanager
def altered(delta=1e-2):
    """The first answer of every batch altered where it is produced."""
    from quanonet_torch.models.quanonet import QuanONet
    plain = QuanONet.readout

    def broken(self, out, params=None):
        out = plain(self, out, params).clone()
        out[..., 0, :] += delta
        return out

    QuanONet.readout = broken
    try:
        yield
    finally:
        QuanONet.readout = plain


FAULTS = {'half_batch': half_batch, 'unchanged': unchanged,
          'altered': altered}


def one_run(cell, seed, seconds, device, control=False):
    """One run's compared numbers: the program's, and with ``control``
    also the TF32 control's in its place."""
    run = cell.kind.Cell(cell.config, cell.traffic, seed, device, seconds,
                         cell.root)
    run.run_window(seconds)
    run.free()
    torch.cuda.empty_cache()
    out = []
    for tf32 in (False, True) if control else (False,):
        checks = run.check(cell.limits, tf32=tf32)
        numbers = {name: value for name, value, _ in checks}
        numbers.update(getattr(run, 'details', {}))
        out.append(numbers)
    return out


def readings(args, cell, device):
    plans = [(s, None) for s in args.seeds + args.control_seeds]
    plans += [(s, args.fault) for s in args.fault_seeds]
    for seed, fault in plans:
        t0 = time.perf_counter()
        with (FAULTS[fault]() if fault else contextlib.nullcontext()):
            found = one_run(cell, seed, args.seconds, device,
                            control=not fault and seed in args.control_seeds)
        whats = [f'fault:{fault}'] if fault else ['program', 'control']
        for what, numbers in zip(whats, found):
            print(json.dumps({'workload': cell.name, 'run': what,
                              'seed': seed, 'numbers': numbers,
                              'seconds': time.perf_counter() - t0}),
                  flush=True)


def sweep(args, cell, device):
    for rate in args.rates:
        traffic = dict(cell.traffic, rate=rate)
        run = cell.kind.Cell(cell.config, traffic, args.seed, device,
                             args.seconds, cell.root)
        if args.trace:
            w, _ = harness.traced_window(run, args.seconds)
        else:
            run.warm_unit()
            w = run.run_window(args.seconds)
        run.free()
        lat = np.array(w['latency_ms'])
        fifth = len(lat) // 5
        print(json.dumps({
            'rate': rate, 'trace': args.trace, 'requests': len(lat),
            'p50_ms': float(np.median(lat)),
            'p95_ms': float(np.percentile(lat, 95)),
            'max_ms': float(lat.max()),
            'service_p50_ms': float(np.median(w['service_ms'])),
            'service_mean_ms': float(np.mean(w['service_ms'])),
            'busy_share': float(np.sum(w['service_ms']) / 1e3
                                / args.seconds),
            'middle_fifth_ms': float(np.mean(lat[2 * fifth:3 * fifth])),
            'last_fifth_ms': float(np.mean(lat[-fifth:])),
            'window_s': w['seconds']}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('what', choices=['readings', 'sweep'])
    ap.add_argument('--workload', required=True)
    seeds = lambda s: [int(v) for v in s.split(',') if v]   # noqa: E731
    ap.add_argument('--seeds', type=seeds, default=[])
    ap.add_argument('--control_seeds', type=seeds, default=[])
    ap.add_argument('--fault', choices=sorted(FAULTS))
    ap.add_argument('--fault_seeds', type=seeds, default=[])
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--rates', type=lambda s: [float(v) for v in
                                               s.split(',')], default=[])
    ap.add_argument('--seed', type=int, default=1)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("calibrate.py measures on a CUDA card")
    device = torch.device('cuda', 0)
    cell = harness.Workload(ROOT, args.workload)
    (readings if args.what == 'readings' else sweep)(args, cell, device)


if __name__ == '__main__':
    main()
