"""
What the two studies share (scripts/noise_robustness_study.py and
scripts/hardware_training_study.py keep a copy each): the Q2 Antideriv
configuration, a training run through the port's Solver that reuses a
completed run directory, and the harvest of its metric.json.

``BASE`` is one module-level dict so that a caller can shrink the budget
(``num_train``, ``num_test``) in place; ``base_config`` adds what each
script sets from its flags.
"""
import csv
import json
import os
import sys

# the reference demo configuration at the studies' budget: Net5-1-5-1, TF,
# S0.001, 10,000 training samples, batch 100, cosine decay from 3e-3
BASE = dict(operator='Antideriv', model_type='QuanONet',
            num_train=1000, num_test=1000, num_points=100,
            num_points_0=10, train_sample_num=10, test_sample_num=100,
            batch_size=100, learning_rate=3e-3, lr_scheduler='cosine',
            num_qubits=2, net_size=[5, 1, 5, 1], scale_coeff=0.001,
            if_trainable_freq='true', ham_bound=[-5, 5],
            ham_pauli='Z', seed=0)


def base_config(epochs, prefix, device):
    """The JAX scripts' ``base``: BASE with the run's epochs and prefix,
    plus the port's device."""
    return dict(BASE, num_epochs=epochs, prefix=prefix, device=device)


def train_one(cfg, launches=None):
    """Train and evaluate ``cfg`` with the port's Solver; -> the run
    directory.  A completed run (metric.json present) is reused: the
    Solver's ``SystemExit(0)`` on resume means "reuse the checkpoint" here,
    as in the JAX scripts.  ``launches``, a dict, receives the kernel
    launches of ``train`` and of ``evaluate`` (profile_step.launch_counts:
    all 0 on the CPU)."""
    from quanonet_torch.profile_step import launch_counts
    from quanonet_torch.solver import Solver
    stdout = sys.stdout             # the Solver redirects it to its log
    try:
        solver = Solver(dict(cfg))
        before = launch_counts()
        try:
            history = solver.train()
        except SystemExit as e:
            if e.code != 0:
                raise
            print(f"  [resume-skip] reusing completed run "
                  f"{solver.exp_logger.exp_dir}", flush=True)
            return solver.exp_logger.exp_dir
        trained = launch_counts()
        solver.evaluate(history)
        if launches is not None:
            after = launch_counts()
            launches['train'] = {k: trained[k] - before[k] for k in before}
            launches['evaluate'] = {k: after[k] - trained[k] for k in after}
        return solver.exp_logger.exp_dir
    finally:
        sys.stdout = stdout


def harvest(exp_dir):
    """metric.json -> (rel-L2, training samples/s incl. kernel builds)."""
    with open(os.path.join(exp_dir, 'metric.json')) as f:
        m = json.load(f)
    met = m.get('metrics', m)
    return (float(met['rel_l2']),
            float(met.get('train_samples_per_sec') or 0.0))


def write_csv(path, rows):
    """``rows`` (dicts of one key order) to ``path``, header first."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w', newline='') as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
