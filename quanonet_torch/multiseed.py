"""
Multi-seed training (counterpart of quanonet_tpu/multiseed.py): the seeds
of ``--multi_seed`` train together in one process as one packed model
(:func:`train_seeds_packed`, the JAX package's vmapped program), or one
after another with the reference's per-process semantics
(:func:`train_seeds_sequential`; reference
scripts/reproduce_benchmarks2.sh:89-122 launches one process per seed).

Routes (:func:`train_multi_seed`): the packed epoch is plain autodiff, so
noise-aware training, ``--grad_method shift|spsa`` and ``--train_shots``
run the seeds sequentially, as the JAX package routes them
(quanonet_tpu/multiseed.py:117-136); so do ``--save_state`` and
``--init_checkpoint``, which the packed epoch does not carry, and a
single seed left to train (a pack of one is slower than its plain step).
Everything else is packed, on ``cuda`` unless ``--device cpu`` is given: the
non-kernel ops take the seed axis in one call, the compile runs as two
B4f launches for all seeds (B4b under autograd), and each seed's chain is
one launch of its engine's kernel on its slice (models/packed.py).  The
JAX package's guards of its vmapped engine (the VMEM footprint of a
vmapped Pallas chain, the TPU worker crash at Q8+) are TPU workarounds
and are not carried over: every engine packs.

Each seed in the pack draws what its single run draws: its parameters
from ``torch.Generator().manual_seed(seed)`` and epoch e's permutation
from ``solver.epoch_permutation(seed, e, n)``, under one learning-rate
schedule over epochs × batches and one optimizer over the stacked leaves
(Adam is elementwise, so the stacked step is each seed's step).  The
packed route is held seed by seed against single runs to float32
tolerance (the stacked reductions round differently), the sequential
route bit for bit.

Artifacts: one experiment directory per seed with the standard contract
(metric.json, best_model.ckpt/.npz), as if S separate runs had executed.
A seed whose metric.json exists is skipped (probed without side effects,
:meth:`ExperimentLogger.completed`), never by ``sys.exit``, so the others
still train.

Dataset semantics: by default every seed trains on the one cached
dataset, generated with the first seed that trains (the cache's file name
carries no seed, as the reference's).  ``--multi_seed_fresh_data true``
regenerates the dataset for each seed from its own NumPy seed, bypassing
the processed-data cache; the packed route then stacks the seeds' data.
"""
import os
import time

import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.config import parse_bool, set_random_seed
from quanonet_torch.data.manager import DataManager
from quanonet_torch.logger import ExperimentLogger
from quanonet_torch.metrics import compute_metrics, rel_l2
from quanonet_torch.models.packed import PackedModel
from quanonet_torch.ops.noise import is_noisy
from quanonet_torch.solver import (
    Solver, build_model, build_optimizer, epoch_permutation, padded_batches,
    predict_chunks, save_checkpoint,
)


def _cfg_for(config, seed):
    cfg = dict(config)
    cfg['seed'] = seed
    cfg.pop('multi_seed', None)
    return cfg


def _fresh_data(config, seed, prefix):
    """The dataset regenerated from NumPy seed ``seed``, not cached."""
    set_random_seed(seed)
    return DataManager(config, data_dir=os.path.join(prefix, "..", "data"))\
        ._generate_and_process()


def sequential_reason(config):
    """Why ``config``'s seeds must train one after another, or None when
    the packed route takes them."""
    if is_noisy(config.get('noise_p'), config.get('readout_p'),
                config.get('damp_gamma'), config.get('dephase_p')):
        return "noise-aware training draws per-step noise per seed"
    if (str(config.get('grad_method') or 'autodiff') != 'autodiff'
            or config.get('train_shots')):
        return "--grad_method/--train_shots change the step itself"
    if parse_bool(config.get('save_state', 'false')):
        return "--save_state snapshots one run's state"
    if config.get('init_checkpoint'):
        return "--init_checkpoint warm-starts one run"
    return None


def _pending(config):
    """The seeds of ``config['multi_seed']`` whose runs are not completed
    (probed without side effects), in order."""
    prefix = config.get('prefix') or "outputs"
    return [s for s in config['multi_seed']
            if not ExperimentLogger.completed(_cfg_for(config, s),
                                              base_output_dir=prefix)]


def train_multi_seed(config):
    """Train every seed of ``config['multi_seed']``; returns {seed:
    metrics}, None for a seed that was already completed.  A single seed
    left to train runs as its single run: a pack of one is slower than
    the plain step, and this keeps it bit-equal to that run."""
    reason = sequential_reason(config)
    if not reason and len(_pending(config)) == 1:
        reason = "one seed left to train"
    if reason:
        print(f"[multi-seed] {reason}: the seeds run sequentially")
        return train_seeds_sequential(config)
    return train_seeds_packed(config)


def train_seeds_sequential(config):
    """Train every seed of ``config['multi_seed']`` in turn, each as its
    single run; returns {seed: metrics}, None for a completed seed."""
    prefix = config.get('prefix') or "outputs"
    fresh = parse_bool(config.get('multi_seed_fresh_data', False))
    out = {}
    for seed in config['multi_seed']:
        cfg = _cfg_for(config, seed)
        if ExperimentLogger.completed(cfg, base_output_dir=prefix):
            print(f"⏩ [Resume] Seed {seed} already completed; skipping.")
            out[seed] = None
            continue
        set_random_seed(seed)
        data = _fresh_data(cfg, seed, prefix) if fresh else None
        solver = Solver(cfg, data=data)
        history = solver.train()
        out[seed] = solver.evaluate(history)
        print(f"Seed {seed}: rel_l2={out[seed]['rel_l2']:.4f} "
              f"MSE={out[seed]['MSE']:.6f}")
    return out


def _split(data, model_type):
    """(train inputs, test inputs, train output, test output), float32."""
    if model_type in ('HEAQNN', 'FNN', 'FNO'):
        names = ('input',)
    else:
        names = ('branch_input', 'trunk_input')
    return (tuple(data[f'train_{k}'].astype(np.float32) for k in names),
            tuple(data[f'test_{k}'].astype(np.float32) for k in names),
            data['train_output'].astype(np.float32),
            data['test_output'].astype(np.float32))


def make_packed_epoch(pack, optimizer, num_samples, batch_size, per_sample):
    """One epoch of the pack: ``epoch(perms, inputs, outputs) -> (avg_loss,
    sse)``, both (S,) float32 tensors on the outputs' device.  perms (S, n)
    orders each seed's samples; inputs and outputs hold every seed's rows,
    (n, ...) shared or (S·n, ...) seed-major (``fresh``: one dataset a
    seed).  Each seed's batches and masks are solver.padded_batches', its
    loss that of solver.make_train_epoch; the S batches of a step are one
    ``index_select``, the S losses' sum takes one ``backward``."""
    num_batches = max(1, int(np.ceil(num_samples / batch_size)))

    def epoch(perms, inputs, outputs, fresh=False):
        dev = outputs.device
        s = perms.shape[0]
        idx, masks = padded_batches(
            torch.as_tensor(perms, dtype=torch.long, device=dev), num_samples,
            batch_size)
        if fresh:
            idx = idx + num_samples * torch.arange(s, device=dev)[:, None,
                                                                  None]
        denom = torch.clamp(masks.sum(1) * per_sample, min=1.0)
        losses = []
        for b in range(num_batches):
            bi = idx[:, b].reshape(-1)
            batch_in = tuple(a.index_select(0, bi).reshape(
                s, batch_size, *a.shape[1:]) for a in inputs)
            batch_out = outputs.index_select(0, bi).reshape(
                s, batch_size, *outputs.shape[1:])
            pred = pack(*batch_in)
            m = masks[b].reshape((1, batch_size) + (1,) * (pred.dim() - 2))
            sq = (pred - batch_out) ** 2 * m
            loss = sq.reshape(s, -1).sum(1) / denom[b]
            optimizer.zero_grad()
            loss.sum().backward()
            optimizer.step()
            losses.append(loss.detach())
        losses = torch.stack(losses)                      # (batches, S)
        return losses.mean(0), (losses * (masks.sum(1) * per_sample)[:, None]
                                ).sum(0)

    return epoch


def train_seeds_packed(config):
    """Train the seeds of ``config['multi_seed']`` that are not completed
    as one packed model (module docstring); returns {seed: metrics}, None
    for a completed seed."""
    seeds = list(config['multi_seed'])
    prefix = config.get('prefix') or "outputs"
    pending = _pending(config)
    done_seeds = [s for s in seeds if s not in pending]
    if not pending:
        print("⏩ [Resume] All seeds already completed. Skipping.")
        return {s: None for s in seeds}
    if done_seeds:
        print(f"⏩ [Resume] Seeds {done_seeds} already completed; "
              f"training the rest.")
    seeds = pending
    n_seeds = len(seeds)
    device = resolve_device(config.get('device'))
    model_type = config['model_type']
    loggers = {s: ExperimentLogger(_cfg_for(config, s),
                                   base_output_dir=prefix) for s in seeds}

    fresh = parse_bool(config.get('multi_seed_fresh_data', False))
    if fresh:
        per_seed = [_fresh_data(config, s, prefix) for s in seeds]
    else:
        set_random_seed(seeds[0])
        per_seed = [DataManager(config, data_dir=os.path.join(
            prefix, "..", "data")).get_data()]
    splits = [_split(d, model_type) for d in per_seed]
    train_in = tuple(torch.as_tensor(np.concatenate(cols), device=device)
                     for cols in zip(*(sp[0] for sp in splits)))
    train_out_np = [sp[2] for sp in splits]
    train_out = torch.as_tensor(np.concatenate(train_out_np), device=device)

    models = [build_model(_cfg_for(config, s), per_seed[0], device=device,
                          generator=torch.Generator().manual_seed(int(s)))[0]
              for s in seeds]
    pack = PackedModel(models)

    num_samples = train_out_np[0].shape[0]
    batch_size = min(config.get('batch_size', 100), num_samples)
    num_batches = max(1, int(np.ceil(num_samples / batch_size)))
    epochs = config['num_epochs']
    per_sample = int(np.prod(train_out_np[0].shape[1:]))
    optimizer = build_optimizer(config, epochs * num_batches,
                                pack.parameters())
    epoch_fn = make_packed_epoch(pack, optimizer, num_samples, batch_size,
                                 per_sample)
    norms = [np.sqrt(float(np.sum(y.astype(np.float64) ** 2)))
             for y in train_out_np]
    norms = norms if fresh else norms * n_seeds

    best_loss = np.full(n_seeds, np.inf)
    best = {k: v.detach().clone() for k, v in pack.params.items()}
    histories = {s: {'loss_train': [], 'loss_test': []} for s in seeds}
    print(f"[multi-seed] packing {n_seeds} seeds {seeds} on {device}")
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t0 = time.time()
    for e in range(epochs):
        perms = torch.stack([epoch_permutation(s, e, num_samples)
                             for s in seeds])
        avg, sse = epoch_fn(perms, train_in, train_out, fresh)
        avg, sse = torch.stack([avg, sse]).cpu().numpy()  # one host read
        improved = avg < best_loss
        if improved.any():
            best_loss = np.where(improved, avg, best_loss)
            rows = torch.as_tensor(np.nonzero(improved)[0], device=device)
            for k, v in pack.params.items():
                best[k][rows] = v.detach()[rows]
        for i, s in enumerate(seeds):
            loss = float(avg[i])
            histories[s]['loss_train'].append(loss)
            loggers[s].log_metric("Loss/train", loss, e)
            loggers[s].log_metric(
                "Error/rel_l2",
                float(np.sqrt(max(float(sse[i]), 0.0)) / (norms[i] + 1e-8)),
                e)
        if e % 10 == 0:
            print(f"Epoch {e} | per-seed MSE: {avg}")
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    rate = epochs * num_samples * n_seeds / max(wall, 1e-9)
    print(f"[multi-seed] {n_seeds} seeds packed: {wall:.2f}s, {rate:,.0f} "
          f"samples/sec in all (incl. kernel builds)")

    out = {s: None for s in done_seeds}
    for i, s in enumerate(seeds):
        _, test_in, _, test_out = splits[i if fresh else 0]
        model = pack.load_seed(i, best)
        y_pred = predict_chunks(model, test_in,
                                config.get('batch_size', 100), device)
        m = compute_metrics(test_out, y_pred)
        m['rel_l2'] = rel_l2(test_out, y_pred)
        m['train_samples_per_sec'] = rate / n_seeds
        if config.get('if_save', True):
            save_checkpoint(pack.state_dict_of(i, best),
                            loggers[s].get_ckpt_path(), model_type)
        loggers[s].save_metrics(m, histories[s])
        loggers[s].close()
        out[s] = m
        print(f"Seed {s}: rel_l2={m['rel_l2']:.4f} MSE={m['MSE']:.6f}")
    return out
