"""
Training bench of the port: the flagship QuanONet Q5 Net40-2-20-2 on
Advection (counterpart of the repository's bench.py, lines 258-548), on
one CUDA card.

    python -m quanonet_torch.bench [--quick] [--regime reference|throughput]
        [--runs R] [--first_seed S] [--epochs E] [--lr LR]
        [--schedule cosine|none] [--batch_size B] [--anchor_crossing]
        [--datagen host|device|native] [--precision default|float32|highest]
        [--f32_tail N] [--engine auto|dense|gates|fused|pallas|embed|pfused]
        [--device cuda|cpu]

The regimes (:func:`regime_defaults`): ``reference`` is 1000 train
functions x 100 points, batch 100, Adam with cosine decay from 3e-3;
``throughput`` is batch 1000 with the peak scaled linearly to 1e-2 (the
JAX package's batch-size frontier, docs/batch_regime.json);
``--schedule none`` is the reference's fixed 1e-4 in either.  100 epochs,
best-epoch parameters scored by rel-L2 on 1000 test functions x 1000
points; ``--quick`` is 200 x 100, 10 epochs, 100 x 100 test points (the
sizes are :data:`SIZES`).  Run r draws its parameters and epoch
permutations from seed first_seed + r.  The shipped Advection anchor
checkpoint is scored in the same run on the identical test set.

Samples/s is timed on run 0 over up to three segments after the first
(which builds the kernels), each ended by a CUDA synchronise; with one
segment, a replay of it from a fresh copy of the model.
``--anchor_crossing`` (the time-to-matched-quality study) scores the
best-so-far parameters at every segment boundary with the anchor's eval
and times run 0 as the sum of its segments after the first, the evals
outside the clock; it adds ``anchor_crossing_runs`` ([[epoch, rel-L2],
...] a run) and ``epochs_to_anchor`` (each run's first boundary under the
anchor, or null).

``--precision`` maps the JAX package's matmul precision onto
``torch.set_float32_matmul_precision`` (:data:`MATMUL_PRECISION`): unset
or float32/highest is fp32 ('highest'); ``default``, the TPU's one-pass
bf16, is TF32 on the card ('high').  The hand-written kernels and the
pinned sums stay fp32 at every setting, so on the 'pallas' route it moves
no product; it acts on the library products of the other engines.
``--f32_tail N`` runs the last N segments after the timed ones under
'highest', as the JAX bench does.  The setting found is restored when the
run ends.  ``--datagen device|native`` generates the data on the card or
natively (cache names ``_dgdevice`` / ``_dgnative``): not byte-equal to
the shared host cache, so never a headline run.

Prints ONE JSON line with the JAX bench's keys (metric, value, unit,
vs_baseline, rel_l2_runs, rel_l2_min/max, beats_anchor_all_runs,
matmul_precision, f32_tail_segs, platform, ...) and the card it ran on,
the kernel launches of the run (the chain's and the compile's), the
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
from quanonet_torch.ops.hea import resolve_engine
from quanonet_torch.profile_step import launch_counts, launches_since
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
# the chain kernel whose launch counters a resolved engine moves
KERNEL_KEYS = {'pallas': 'hea_chain', 'embed': 'embed_chain',
               'pfused': 'fused_chain'}
# the data sizes, epochs and epochs a segment of the full and quick runs
SIZES = {
    'full': dict(num_train=1000, num_test=1000, train_sample_num=100,
                 test_sample_num=1000, epochs=100, seg=10),
    'quick': dict(num_train=200, num_test=100, train_sample_num=100,
                  test_sample_num=100, epochs=10, seg=5),
}
# --precision (the JAX package's matmul precision) -> torch's setting
MATMUL_PRECISION = {None: 'highest', 'default': 'high',
                    'float32': 'highest', 'highest': 'highest'}


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


def regime_defaults(regime, schedule=None, batch_size=None, lr=None):
    """(batch size, schedule, peak lr) of a regime, as the JAX bench sets
    them: batch 1000 for 'throughput', else 100; cosine unless 'none';
    peak 1e-2 (throughput) or 3e-3 (reference) with cosine, 1e-4 without.
    ``batch_size`` and ``lr`` override."""
    schedule = schedule or 'cosine'
    if schedule == 'cosine':
        peak = 1e-2 if regime == 'throughput' else 3e-3
    else:
        peak = 1e-4
    return (batch_size or (1000 if regime == 'throughput' else 100),
            schedule, lr or peak)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--quick', action='store_true',
                    help='200 train functions, 10 epochs, 100 x 100 test '
                         'points')
    ap.add_argument('--regime', default='reference',
                    choices=['reference', 'throughput'],
                    help='reference: batch 100, cosine peak 3e-3; '
                         'throughput: batch 1000, cosine peak 1e-2')
    ap.add_argument('--engine', default='auto',
                    choices=['auto', 'dense', 'gates', 'fused', 'pallas',
                             'embed', 'pfused'])
    ap.add_argument('--epochs', type=int, default=None)
    ap.add_argument('--runs', type=int, default=None,
                    help='training repeats, run r with seed first_seed + r '
                         '(default 3, 1 with --quick)')
    ap.add_argument('--first_seed', type=int, default=0,
                    help='seed of the first run (to spread the runs of one '
                         'regime over several processes)')
    ap.add_argument('--precision', default=None,
                    choices=['default', 'float32', 'highest'],
                    help="the JAX package's matmul precision: default -> "
                         "TF32 ('high'), float32/highest -> fp32; unset: "
                         "fp32")
    ap.add_argument('--lr', type=float, default=None,
                    help='peak learning rate (default by regime with '
                         'cosine: 3e-3 reference, 1e-2 throughput; 1e-4 '
                         'with --schedule none)')
    ap.add_argument('--schedule', default=None, choices=['none', 'cosine'],
                    help='learning-rate schedule (default cosine)')
    ap.add_argument('--anchor_crossing', action='store_true',
                    help="score the best-so-far parameters at every segment "
                         "boundary and report each run's first epoch under "
                         "the anchor; samples/s from the segments' own "
                         "times")
    ap.add_argument('--batch_size', type=int, default=None,
                    help='override the regime batch (100 reference, 1000 '
                         'throughput)')
    ap.add_argument('--datagen', default=None,
                    choices=['host', 'device', 'native'],
                    help='data generator (device/native: not byte-equal to '
                         'the host cache, never a headline run)')
    ap.add_argument('--f32_tail', type=int, default=0,
                    help="run the last N segments at matmul precision "
                         "'highest'")
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    return ap


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(args):
    """The regime of ``args`` (from :func:`parser`); returns the result
    dict that :func:`main` prints.  The process's float32 matmul precision
    is set for the run and restored as found, also when the run raises."""
    found = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(MATMUL_PRECISION[args.precision])
        return _run(args)
    finally:
        torch.set_float32_matmul_precision(found)


def _run(args):
    t_start = time.time()
    device = resolve_device(args.device)
    size = SIZES['quick' if args.quick else 'full']
    epochs = args.epochs or size['epochs']
    runs = args.runs or (1 if args.quick else 3)
    cfg = dict(operator='Advection', model_type='QuanONet',
               num_train=size['num_train'], num_test=size['num_test'],
               num_points=100, num_points_0=100,
               train_sample_num=size['train_sample_num'],
               test_sample_num=size['test_sample_num'])
    if args.datagen:
        cfg.update(datagen=args.datagen, device=str(device))
    t0 = time.time()
    np.random.seed(0)
    manager = DataManager(cfg, data_dir=DATA_DIR)
    data = manager.get_data()
    log(f"data ready in {time.time() - t0:.1f}s "
        f"({manager._get_filename()}); "
        f"train={data['train_output'].shape[0]} samples")

    inputs = (torch.as_tensor(data['train_branch_input'], device=device),
              torch.as_tensor(data['train_trunk_input'], device=device))
    target = torch.as_tensor(data['train_output'], device=device)
    n = target.shape[0]
    batch_size, schedule_name, peak_lr = regime_defaults(
        args.regime, args.schedule, args.batch_size, args.lr)
    if n % batch_size:
        raise SystemExit(f"--batch_size {batch_size} must divide the "
                         f"{n}-sample training set")
    steps_per_epoch = n // batch_size
    if schedule_name == 'cosine':   # optax.cosine_decay_schedule(lr, T)
        schedule = _decay_tuple_schedule(
            peak_lr, ('cosine', epochs * steps_per_epoch, 0.0), None)
    else:
        schedule = lambda t: peak_lr
    seg = size['seg']
    if epochs % seg:
        raise SystemExit(f"--epochs must be a multiple of {seg}")
    n_segs = epochs // seg
    f32_tail = args.f32_tail

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
    kernel = KERNEL_KEYS.get(resolved)
    launches0 = launch_counts()
    sps = None
    rels, crossings, seg_precision = [], [], []
    seeds = [args.first_seed + r for r in range(runs)]
    for r, seed in enumerate(seeds):
        model = QuanONet(num_qubits=5, branch_input_size=100,
                         trunk_input_size=2, net_size=(40, 2, 20, 2),
                         scale_coeff=0.1, if_trainable_freq=True,
                         engine=args.engine, device=device,
                         generator=torch.Generator().manual_seed(seed))
        init = copy.deepcopy(model)      # the replay's starting point
        evaluator = copy.deepcopy(model)   # scores best-so-far parameters
        opt = ScheduledOptimizer(torch.optim.Adam(model.parameters(),
                                                  lr=peak_lr), schedule)
        run_segment = make_run_segment(
            make_train_epoch(model, opt, n, batch_size, 1), model)
        perms = [epoch_permutation(seed, e, n) for e in range(epochs)]
        state = (float('inf'), None)

        def segment(i, state):
            if r == 0:
                seg_precision.append(torch.get_float32_matmul_precision())
            return run_segment(*state, perms[i * seg:(i + 1) * seg],
                               inputs, target, i * seg)[:2]

        def score(best_params):
            evaluator.load_state_dict(best_params)
            return eval_rel_l2(evaluator)

        def replay():
            """Seconds of a replay of the first segment from a fresh copy,
            so the trajectory stays `epochs` long."""
            m = copy.deepcopy(init)
            opt2 = ScheduledOptimizer(torch.optim.Adam(m.parameters(),
                                                       lr=peak_lr), schedule)
            _sync(device)
            t0 = time.time()
            make_run_segment(make_train_epoch(m, opt2, n, batch_size, 1),
                             m)(float('inf'), None, perms[:seg], inputs,
                                target)
            _sync(device)
            return time.time() - t0

        t0 = time.time()
        state = segment(0, state)
        if r == 0:
            log(f"first segment ({seg} epochs, kernel builds included): "
                f"{time.time() - t0:.1f}s (best loss {state[0]:.4f})")
        if args.anchor_crossing:
            track = [(seg, score(state[1]))]
            tsum = 0.0
            for i in range(1, n_segs):
                _sync(device)
                t0 = time.time()
                state = segment(i, state)
                _sync(device)
                tsum += time.time() - t0
                track.append(((i + 1) * seg, score(state[1])))
            crossings.append(track)
            if r == 0:
                timed_epochs, dt = ((epochs - seg, tsum) if n_segs > 1
                                    else (seg, replay()))
            first = next((e for e, v in track if v < anchor), None)
            log(f"run {r}: first epoch beating anchor ({anchor:.4f}): "
                f"{first}; trajectory "
                + " ".join(f"{e}:{v:.4f}" for e, v in track))
        else:
            timed = min(n_segs - 1, 3)
            if timed:
                _sync(device)
                t0 = time.time()
                for i in range(1, 1 + timed):
                    state = segment(i, state)
                _sync(device)
                timed_epochs, dt = timed * seg, time.time() - t0
            else:
                timed_epochs, dt = seg, replay()
            # the last f32_tail segments after the timed ones at 'highest'
            tail_start = max(1 + timed, n_segs - f32_tail)
            for i in range(1 + timed, n_segs):
                if f32_tail > 0 and i >= tail_start:
                    prev = torch.get_float32_matmul_precision()
                    torch.set_float32_matmul_precision('highest')
                    try:
                        state = segment(i, state)
                    finally:
                        torch.set_float32_matmul_precision(prev)
                else:
                    state = segment(i, state)
        if r == 0:
            sps = timed_epochs * n / dt
            log(f"timed: {timed_epochs} epochs x {n} samples in {dt:.2f}s "
                f"=> {sps:,.0f} samples/sec")
        best_loss, best_params = state
        rel = score(best_params)
        rels.append(rel)
        log(f"run {r} (seed {seed}): best-epoch train MSE {best_loss:.6f} "
            f"-> test rel_l2 {rel:.4f}")

    rel_worst = max(rels)
    log(f"rel_l2 over {runs} run(s): mean {np.mean(rels):.4f} "
        f"min {min(rels):.4f} max {rel_worst:.4f} (measured anchor "
        f"{anchor:.4f}; worst-run beats anchor: {rel_worst < anchor})")
    fps = flops_per_sample(resolved, 5, 60)
    tflops = sps * fps / 1e12 if fps else None
    launches = launches_since(launches0)
    result = {
        "metric": "quanonet_q5_advection_train_samples_per_sec_per_chip",
        "regime": args.regime,
        "quick": bool(args.quick),
        "value": sps,
        "unit": "samples/sec",
        "vs_baseline": sps / BASELINE_SAMPLES_PER_SEC,
        "rel_l2": rel_worst,
        "rel_l2_runs": rels,
        "seeds": seeds,
        "rel_l2_mean": float(np.mean(rels)),
        "rel_l2_min": min(rels),
        "rel_l2_max": rel_worst,
        "eval_protocol": "best-epoch, per-seed torch generators, worst of "
                         "runs",
        "reference_anchor_rel_l2": anchor,
        "anchor_measured_in_run": anchor_rel is not None,
        "beats_anchor_all_runs": bool(rel_worst < anchor),
        "epochs": epochs,
        "runs": runs,
        "batch_size": batch_size,
        "train_samples": n,
        "engine": args.engine,
        "resolved_engine": resolved,
        "model_flops_per_sample": fps,
        "model_tflops_per_sec": tflops,
        "mfu_pct": (100.0 * tflops * 1e12 / PEAK_FP32_FLOPS
                    if fps and device.type == 'cuda' else None),
        "lr": peak_lr,
        "lr_schedule": schedule_name,
        "matmul_precision": torch.get_float32_matmul_precision(),
        "precision_flag": args.precision,
        "matmul_precision_segments": seg_precision,
        "f32_tail_segs": f32_tail,
        "datagen": manager.datagen,
        "data_file": manager._get_filename(),
        "platform": device.type,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == 'cuda' else 'cpu'),
        "fwd_launches": launches.get(f'{kernel}_fwd', 0),
        "bwd_launches": launches.get(f'{kernel}_bwd', 0),
        "compile_launches": [launches.get('ucomp_fwd', 0),
                             launches.get('ucomp_bwd', 0)],
        "seconds": time.time() - t_start,
    }
    if args.anchor_crossing:
        result["anchor_crossing_runs"] = [[[e, v] for e, v in t]
                                          for t in crossings]
        result["epochs_to_anchor"] = [
            next((e for e, v in t if v < anchor), None) for t in crossings]
    return result


def main(argv=None):
    print(json.dumps(run(parser().parse_args(argv))), flush=True)


if __name__ == '__main__':
    main()
