"""
Training bench of the port: the flagship QuanONet Q5 Net40-2-20-2 on
Advection (counterpart of the regime of the repository's bench.py,
lines 258-480), on one CUDA card.

    python -m quanonet_torch.bench [--quick] [--runs R] [--epochs E]
        [--lr LR] [--schedule cosine|none] [--batch_size B]
        [--engine auto|dense|gates|fused|pallas|embed|pfused]
        [--device cuda|cpu]

The regime: 1000 train functions x 100 points, batch 100, Adam with
cosine decay from 3e-3 (``--schedule none``: the reference's fixed 1e-4),
100 epochs, best-epoch parameters scored by rel-L2 on 1000 test functions
x 1000 points; ``--quick`` is 200 x 100, 10 epochs, 100 x 100 test
points.  Run r draws its parameters and epoch permutations from seed r.
The shipped Advection anchor checkpoint is scored in the same run on the
identical test set.  Samples/s is timed on run 0 over up to three
segments after the first (which builds the kernels), each ended by a
CUDA synchronise.  fp32 throughout; TF32 stays off.

Prints ONE JSON line with the JAX bench's keys (metric, value, unit,
vs_baseline, rel_l2_runs, beats_anchor_all_runs, ...) and the card it ran
on, the kernel launches of the run (the chain's and the compile's), the
model-FLOP rate against the card's fp32 peak (:func:`flops_per_sample`),
and the seconds it took.
"""
import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.data.manager import DataManager
from quanonet_torch.infer import load_model
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import cuda_embed, cuda_fused, cuda_hea, cuda_ucomp
from quanonet_torch.ops.hea import resolve_engine
from quanonet_torch.solver import (
    ScheduledOptimizer, _decay_tuple_schedule, epoch_permutation,
    make_run_segment, make_train_epoch,
)

BASELINE_SAMPLES_PER_SEC = 2083.0   # the reference's CPU path (bench.py)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR_CKPT = os.path.join(
    REPO, 'pretrained_weights', 'Advection',
    'Advection_QuanONet_Net40-2-20-2_Q5_TF_S0.1_1000x100_Seed0',
    'best_model.ckpt')
REFERENCE_ANCHOR_REL_L2 = 0.1697   # fallback if the ckpt is absent
DATA_DIR = os.path.join(REPO, 'data')   # shared with the repo's bench.py
EVAL_CHUNK = 20000
PEAK_FP32_FLOPS = 67e12    # H100 SXM datasheet, fp32 outside tensor cores
# the module whose launch counters a resolved engine moves
KERNEL_MODULES = {'pallas': cuda_hea, 'embed': cuda_embed,
                  'pfused': cuda_fused}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def flops_per_sample(engine, n_qubits, n_blocks):
    """Model-FLOP cost per sample of one train step (forward + backward),
    by engine, as the JAX bench counts it.

    dense / pallas (three-product split-real chain): per block the forward
    is one complex (1, D) x (D, D) product = 3 real products = 6 D^2 flops;
    the backward adds the mbar and sbar pairs = 12 D^2: 18 D^2 a block.

    embed (real-embedding chain): the forward is one real (1, 2D) x
    (2D, 2D) product = 2 (2D)^2 = 8 D^2 flops; the backward is
    ebar = s^T g and sbar = g E^T, 8 D^2 each: 24 D^2 a block.

    fused / pfused / gates apply kron-factored operators (no D x D product
    per block), so this model does not describe them: None."""
    D = 2 ** n_qubits
    if engine in ('dense', 'pallas'):
        return 18 * D * D * n_blocks
    if engine == 'embed':
        return 24 * D * D * n_blocks
    return None


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--quick', action='store_true',
                    help='200 train functions, 10 epochs, 100 x 100 test '
                         'points')
    ap.add_argument('--epochs', type=int, default=None)
    ap.add_argument('--runs', type=int, default=None,
                    help='training repeats, run r with seed first_seed + r '
                         '(default 3, 1 with --quick)')
    ap.add_argument('--first_seed', type=int, default=0,
                    help='seed of the first run (to spread the runs of one '
                         'regime over several processes)')
    ap.add_argument('--lr', type=float, default=None,
                    help='peak learning rate (default 3e-3 with cosine, '
                         '1e-4 with --schedule none)')
    ap.add_argument('--schedule', default='cosine', choices=['none', 'cosine'])
    ap.add_argument('--batch_size', type=int, default=100)
    ap.add_argument('--engine', default='auto',
                    choices=['auto', 'dense', 'gates', 'fused', 'pallas',
                             'embed', 'pfused'])
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    return ap


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(args):
    """The regime of ``args`` (from :func:`parser`); returns the result
    dict that :func:`main` prints."""
    t_start = time.time()
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    num_train = 200 if args.quick else 1000
    epochs = args.epochs or (10 if args.quick else 100)
    runs = args.runs or (1 if args.quick else 3)
    cfg = dict(operator='Advection', model_type='QuanONet',
               num_train=num_train, num_test=100 if args.quick else 1000,
               num_points=100, num_points_0=100, train_sample_num=100,
               test_sample_num=100 if args.quick else 1000)
    t0 = time.time()
    np.random.seed(0)
    data = DataManager(cfg, data_dir=DATA_DIR).get_data()
    log(f"data ready in {time.time() - t0:.1f}s; "
        f"train={data['train_output'].shape[0]} samples")

    inputs = (torch.as_tensor(data['train_branch_input'], device=device),
              torch.as_tensor(data['train_trunk_input'], device=device))
    target = torch.as_tensor(data['train_output'], device=device)
    n = target.shape[0]
    batch_size = args.batch_size
    if n % batch_size:
        raise SystemExit(f"--batch_size {batch_size} must divide the "
                         f"{n}-sample training set")
    steps_per_epoch = n // batch_size
    peak_lr = args.lr or (3e-3 if args.schedule == 'cosine' else 1e-4)
    if args.schedule == 'cosine':   # optax.cosine_decay_schedule(lr, T)
        schedule = _decay_tuple_schedule(
            peak_lr, ('cosine', epochs * steps_per_epoch, 0.0), None)
    else:
        schedule = lambda t: peak_lr
    seg = 5 if args.quick else 10
    if epochs % seg:
        raise SystemExit(f"--epochs must be a multiple of {seg}")
    n_segs = epochs // seg

    tb = torch.as_tensor(data['test_branch_input'], device=device)
    tt = torch.as_tensor(data['test_trunk_input'], device=device)
    ty = np.asarray(data['test_output'], np.float64)

    def eval_rel_l2(model):
        with torch.inference_mode():
            preds = torch.cat([model(tb[s:s + EVAL_CHUNK],
                                     tt[s:s + EVAL_CHUNK])
                               for s in range(0, tb.shape[0], EVAL_CHUNK)])
        p = preds.cpu().numpy().astype(np.float64)
        return float(np.linalg.norm(p - ty) / (np.linalg.norm(ty) + 1e-8))

    # the reference anchor on the IDENTICAL test set and eval code
    anchor_rel = None
    if os.path.exists(ANCHOR_CKPT):
        anchor_model, _ = load_model(ANCHOR_CKPT, 100, 2, device=str(device),
                                     engine=args.engine)
        anchor_rel = eval_rel_l2(anchor_model)
        log(f"reference shipped-ckpt anchor on this test set: "
            f"rel_l2 {anchor_rel:.4f}")
    anchor = anchor_rel if anchor_rel is not None else REFERENCE_ANCHOR_REL_L2

    resolved = resolve_engine(args.engine, 5, device)
    kernels = KERNEL_MODULES.get(resolved)
    launches0 = (kernels.launches, kernels.bwd_launches) if kernels else None
    compile0 = (cuda_ucomp.launches, cuda_ucomp.bwd_launches)
    sps = None
    rels = []
    seeds = [args.first_seed + r for r in range(runs)]
    for r, seed in enumerate(seeds):
        model = QuanONet(num_qubits=5, branch_input_size=100,
                         trunk_input_size=2, net_size=(40, 2, 20, 2),
                         scale_coeff=0.1, if_trainable_freq=True,
                         engine=args.engine, device=device,
                         generator=torch.Generator().manual_seed(seed))
        fresh = copy.deepcopy(model) if n_segs == 1 else None
        opt = ScheduledOptimizer(torch.optim.Adam(model.parameters(),
                                                  lr=peak_lr), schedule)
        run_segment = make_run_segment(
            make_train_epoch(model, opt, n, batch_size, 1), model)
        perms = [epoch_permutation(seed, e, n) for e in range(epochs)]
        best_loss, best_params = float('inf'), None

        def segment(i, state):
            return run_segment(*state, perms[i * seg:(i + 1) * seg],
                               inputs, target)[:2]

        t0 = time.time()
        best_loss, best_params = segment(0, (best_loss, best_params))
        if r == 0:
            log(f"first segment ({seg} epochs, kernel builds included): "
                f"{time.time() - t0:.1f}s (best loss {best_loss:.4f})")
        timed = min(n_segs - 1, 3)
        _sync(device)
        t0 = time.time()
        if timed:
            for i in range(1, 1 + timed):
                best_loss, best_params = segment(i, (best_loss, best_params))
            timed_epochs = timed * seg
        else:
            # one segment only: time a replay of it from a fresh copy, so
            # the trajectory stays `epochs` long
            opt2 = ScheduledOptimizer(torch.optim.Adam(
                fresh.parameters(), lr=peak_lr), schedule)
            make_run_segment(make_train_epoch(fresh, opt2, n, batch_size, 1),
                             fresh)(float('inf'), None, perms[:seg], inputs,
                                    target)
            timed_epochs = seg
        _sync(device)
        dt = time.time() - t0
        if r == 0:
            sps = timed_epochs * n / dt
            log(f"timed: {timed_epochs} epochs x {n} samples in {dt:.2f}s "
                f"=> {sps:,.0f} samples/sec")
        for i in range(1 + timed, n_segs):
            best_loss, best_params = segment(i, (best_loss, best_params))
        model.load_state_dict(best_params)
        rel = eval_rel_l2(model)
        rels.append(rel)
        log(f"run {r} (seed {seed}): best-epoch train MSE {best_loss:.6f} "
            f"-> test rel_l2 {rel:.4f}")

    rel_worst = max(rels)
    log(f"rel_l2 over {runs} run(s): mean {np.mean(rels):.4f} "
        f"min {min(rels):.4f} max {rel_worst:.4f} (measured anchor "
        f"{anchor:.4f}; worst-run beats anchor: {rel_worst < anchor})")
    fps = flops_per_sample(resolved, 5, 60)
    tflops = sps * fps / 1e12 if fps else None
    return {
        "metric": "quanonet_q5_advection_train_samples_per_sec_per_chip",
        "regime": "quick" if args.quick else "reference",
        "value": sps,
        "unit": "samples/sec",
        "vs_baseline": sps / BASELINE_SAMPLES_PER_SEC,
        "rel_l2": rel_worst,
        "rel_l2_runs": rels,
        "seeds": seeds,
        "rel_l2_mean": float(np.mean(rels)),
        "eval_protocol": "best-epoch, per-seed torch generators, worst of "
                         "runs",
        "reference_anchor_rel_l2": anchor,
        "anchor_measured_in_run": anchor_rel is not None,
        "beats_anchor_all_runs": bool(rel_worst < anchor),
        "epochs": epochs,
        "runs": runs,
        "batch_size": batch_size,
        "engine": args.engine,
        "resolved_engine": resolved,
        "model_flops_per_sample": fps,
        "model_tflops_per_sec": tflops,
        "mfu_pct": (100.0 * tflops * 1e12 / PEAK_FP32_FLOPS
                    if fps and device.type == 'cuda' else None),
        "lr": peak_lr,
        "lr_schedule": args.schedule,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == 'cuda' else 'cpu'),
        "fwd_launches": kernels.launches - launches0[0] if kernels else 0,
        "bwd_launches": (kernels.bwd_launches - launches0[1]
                         if kernels else 0),
        "compile_launches": [cuda_ucomp.launches - compile0[0],
                             cuda_ucomp.bwd_launches - compile0[1]],
        "seconds": time.time() - t_start,
    }


def main(argv=None):
    print(json.dumps(run(parser().parse_args(argv))), flush=True)


if __name__ == '__main__':
    main()
