"""
Multi-seed training (counterpart of quanonet_tpu/multiseed.py): the seeds
of ``--multi_seed`` train one after another, each as the run of that seed
alone would, with the reference's per-process semantics (reference
scripts/reproduce_benchmarks2.sh:89-122 launches one process per seed;
the JAX package's ``_train_seeds_sequential``).

Artifacts: one experiment directory per seed with the standard contract
(metric.json, best_model.ckpt/.npz), as if S separate runs had executed.
A seed whose metric.json exists is skipped (probed without side effects,
:meth:`ExperimentLogger.completed`), never by ``sys.exit``, so the seeds
after it still train.

Dataset semantics: by default every seed trains on the one cached
dataset, which the first seed to run generates (the cache's file name
carries no seed, as the reference's).  ``--multi_seed_fresh_data true``
regenerates the dataset for each seed from its own NumPy seed, bypassing
the processed-data cache.

Not ported yet: the packed route, S models stepped together in one
process (the JAX package's vmapped program; ROADMAP §A item 2).
"""
import os

from quanonet_torch.config import parse_bool, set_random_seed
from quanonet_torch.data.manager import DataManager
from quanonet_torch.logger import ExperimentLogger
from quanonet_torch.solver import Solver


def _cfg_for(config, seed):
    cfg = dict(config)
    cfg['seed'] = seed
    cfg.pop('multi_seed', None)
    return cfg


def train_multi_seed(config):
    """Train every seed of ``config['multi_seed']`` in turn; returns
    {seed: metrics}, None for a seed that was already completed."""
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
        data = None
        if fresh:
            data = DataManager(
                cfg, data_dir=os.path.join(prefix, "..", "data"))\
                ._generate_and_process()
        solver = Solver(cfg, data=data)
        history = solver.train()
        out[seed] = solver.evaluate(history)
        print(f"Seed {seed}: rel_l2={out[seed]['rel_l2']:.4f} "
              f"MSE={out[seed]['MSE']:.6f}")
    return out
