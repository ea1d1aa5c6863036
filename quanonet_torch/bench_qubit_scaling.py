"""
Qubit-scaling bench of the port (counterpart of the repository's
bench_qubit_scaling.py): train-step and forward throughput of the QuanONet
as the register grows, engine by engine, on one CUDA card.

    python -m quanonet_torch.bench_qubit_scaling [--quick] [--only N]
        [--engine E] [--device cuda|cpu]

The rows are the JAX bench's ``CONFIGS`` (qubits, net size, engines, batch,
train or forward, steps per epoch); synthetic data, since throughput does
not depend on it.  Each row times ``epochs`` epochs after one untimed epoch
(which builds the kernels), the clock stopped after a CUDA synchronise.
Prints one JSON line per row with the JAX bench's keys; ``mfu_pct`` is
taken against the card's fp32 peak (67 TFLOP/s, H100 SXM datasheet), not
the TPU's bf16 one, and ``device`` names the card.  This is how the port
learns where its engines cross over on the card: 'auto' keeps the JAX
package's thresholds until these numbers say otherwise.
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.models import QuanONet

BASELINE_SPS = 2083.0      # Q5 MindQuantum CPU anchor (the JAX bench's)
PEAK_FP32_FLOPS = 67e12    # H100 SXM datasheet, fp32 outside tensor cores

# (qubits, net_size, engines, batch, train?, steps_per_epoch): the JAX
# bench's rows (bench_qubit_scaling.py:183-203), with its engine names
CONFIGS = [
    (5, (40, 2, 20, 2), ('pallas', 'embed', 'fused'), 100, True, 200),
    (8, (40, 2, 20, 2), ('pallas', 'fused', 'pfused'), 100, True, 100),
    (10, (40, 2, 20, 2), ('dense', 'fused', 'pfused'), 100, True, 20),
    (11, (10, 2, 10, 2), ('pfused', 'fused'), 100, True, 20),
    (12, (10, 2, 10, 2), ('fused', 'pfused'), 100, True, 20),
    (13, (10, 2, 10, 2), ('pfused', 'fused'), 100, True, 20),
    (14, (5, 2, 5, 2), ('pfused', 'fused'), 32, True, 10),
    (16, (5, 2, 5, 2), ('fused',), 16, True, 10),
    (15, (5, 2, 5, 2), ('pfused', 'fused'), 16, False, 10),
    (16, (5, 2, 5, 2), ('pfused', 'fused'), 8, False, 10),
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def model_flops_per_sample(n_qubits, net_size, engine, train=True):
    """Analytic model-FLOP count per sample, the JAX bench's
    (bench_qubit_scaling.py:38-78): the grouped-kron algebra for the
    fused-group engines, the dense block chain's for dense/pallas/embed;
    a complex MAC is 8 flops, permutations are free, a train step is 3x
    the forward."""
    D = 2 ** n_qubits
    bd, bld, td, tld = net_size
    n_blocks = bd + td
    n_sub = bd * bld + td * tld
    if engine in ('dense', 'pallas', 'embed'):
        per_step = (24 if engine == 'embed' else 18) * D * D * n_blocks
        return per_step if train else per_step // 3
    hi = max(D // 128, 1)
    w = min(D, 128)
    per_sub = 8 * w * D + (8 * hi * D if hi > 1 else 0)
    nh = max(n_qubits - 7, 0)
    per_block = 8 * D + 2 * (2 * 2 * w * D) + 2 * 4 * nh * D
    fwd = n_sub * per_sub + n_blocks * per_block + 4 * D
    return 3 * fwd if train else fwd


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def bench_config(n_qubits, net_size, engine, batch, device, epochs_timed=20,
                 train=True, steps_per_epoch=10):
    """Samples/s of ``epochs_timed`` epochs of ``steps_per_epoch`` batches
    (train steps with Adam, or forwards under inference mode), and the
    seconds of the untimed first epoch."""
    rng = np.random.RandomState(0)
    n = batch * steps_per_epoch
    branch = torch.as_tensor(rng.randn(n, 100).astype(np.float32),
                             device=device)
    trunk = torch.as_tensor(rng.rand(n, 2).astype(np.float32), device=device)
    target = torch.as_tensor(rng.randn(n, 1).astype(np.float32),
                             device=device)
    model = QuanONet(num_qubits=n_qubits, branch_input_size=100,
                     trunk_input_size=2, net_size=tuple(net_size),
                     scale_coeff=0.1, engine=engine, device=device,
                     generator=torch.Generator().manual_seed(0))

    if not train:
        def epoch():
            acc = torch.zeros((), device=device)
            with torch.inference_mode():
                for s in range(0, n, batch):
                    acc = acc + model(branch[s:s + batch],
                                      trunk[s:s + batch]).sum()
            return acc
    else:
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        gen = torch.Generator().manual_seed(1)

        def epoch():
            perm = torch.randperm(n, generator=gen).to(device)
            losses = []
            for bi in perm.reshape(steps_per_epoch, batch):
                loss = ((model(branch[bi], trunk[bi]) - target[bi])
                        ** 2).mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            return torch.stack(losses).mean()

    t0 = time.time()
    epoch()
    _sync(device)
    first_s = time.time() - t0
    t0 = time.time()
    for _ in range(epochs_timed):
        last = epoch()
    _sync(device)
    dt = time.time() - t0
    if not bool(torch.isfinite(last)):
        raise FloatingPointError(f"Q{n_qubits} {engine}: non-finite output")
    return epochs_timed * n / dt, first_s


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--quick', action='store_true',
                    help='3 timed epochs per row instead of 20')
    ap.add_argument('--only', type=int, default=None,
                    help='bench a single qubit count')
    ap.add_argument('--engine', default=None,
                    help='bench a single engine (filters each row)')
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    return ap


def run(args):
    """The rows of ``args`` (from :func:`parser`); returns them."""
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    timed = 3 if args.quick else 20
    rows = []
    for nq, net, engines, batch, train, spe in CONFIGS:
        if args.only and nq != args.only:
            continue
        for eng in engines:
            if args.engine and eng != args.engine:
                continue
            try:
                sps, first_s = bench_config(nq, net, eng, batch, device,
                                            epochs_timed=timed, train=train,
                                            steps_per_epoch=spe)
            except (NotImplementedError, ValueError, RuntimeError,
                    FloatingPointError) as e:
                log(f"Q{nq} {eng}: FAILED {type(e).__name__}: {e}")
                continue
            fps = model_flops_per_sample(nq, net, eng, train=train)
            tflops = sps * fps / 1e12
            row = {
                "metric": f"qubit_scaling_q{nq}_{eng}"
                          f"{'_train' if train else '_fwd'}",
                "qubits": nq, "engine": eng, "net_size": list(net),
                "batch": batch, "mode": "train" if train else "forward",
                "value": sps, "unit": "samples/sec",
                "vs_baseline": sps / BASELINE_SPS,
                "compile_s": first_s,
                "model_mflops_per_sample": fps / 1e6,
                "model_tflops_per_sec": tflops,
                "mfu_pct": 100.0 * tflops * 1e12 / PEAK_FP32_FLOPS,
                "peak": "fp32 67 TFLOP/s", "device": name,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == '__main__':
    main()
