"""
The multi-GPU dry run (counterpart of ``__graft_entry__.dryrun_multichip``):

    python -m quanonet_torch.multichip --world N [--device cuda|cpu]
                                       [--share_device]

runs the whole multi-GPU surface on N ranks and prints one JSON line a
arm, then ``{"ok": true, ...}``; a failed arm raises (exit code 1):

(a) one data × seed step (parallel/mesh.make_dp_train_step, multi_seed) at
    the flagship topology, QuanONet Q5 Net40-2-20-2 (seed_parallel 2 when
    N is even), a small batch: a finite loss a seed;
(b), (c) the Solver with ``--shard amp`` and ``--shard pipe`` (Q5
    Net2-1-2-1: 4 blocks; the short chain keeps the run to seconds while
    exercising every collective) on the ranks against the unsharded Solver
    in this process: loss trajectory and rel-L2 to rtol 1e-4 (the JAX dry
    run's limit); pipe where 1 < stages dividing 4 blocks fit in N;
(d) dp × pp on a (data, pipe) grid (Q3 Net4-1-4-1, 4 microbatches):
    forward and gradient finite, and equal to the unsharded engine.

On ``cuda`` each rank takes a card of its own (NCCL); ``--share_device``
puts every rank on card 0 over gloo, which checks the code path on one
card and measures nothing of scaling.  Each start of ranks is limited to
parallel/launch.DEFAULT_TIMEOUT_S.
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.parallel import launch

FLAGSHIP_NET = (40, 2, 20, 2)
SHARD_NET = (2, 1, 2, 1)
SHARD_RTOL = 1e-4


def arm_dp_seed(group, batch):
    """(a): one dp × seed step; returns the losses of every seed."""
    from quanonet_torch.models import QuanONet
    from quanonet_torch.models.packed import PackedModel
    from quanonet_torch.parallel import mesh
    from quanonet_torch.solver import build_optimizer
    sp = 2 if group.world % 2 == 0 else 1
    m = mesh.make_mesh(group, seed_parallel=sp)
    seeds = [m.seed.rank]            # one seed a seed-axis rank
    models = [QuanONet(5, 10, 1, FLAGSHIP_NET, scale_coeff=0.1,
                       device=group.device,
                       generator=torch.Generator().manual_seed(s))
              for s in seeds]
    packed = PackedModel(models)
    step = mesh.make_dp_train_step(
        packed, build_optimizer({'learning_rate': 1e-3}, 1,
                                packed.parameters()), m, multi_seed=True)
    rng = np.random.RandomState(0)
    branch = rng.randn(batch, 10).astype(np.float32)
    trunk = rng.rand(batch, 1).astype(np.float32)
    target = rng.randn(batch, 1).astype(np.float32)
    loss = step(mesh.shard_batch(m, branch, trunk),
                *mesh.shard_batch(m, target))
    return {'losses': loss, 'mesh': m.shape}


def arm_solver(group, config, data):
    """(b), (c): a rank of the sharded Solver; rank 0's history and
    metrics."""
    from quanonet_torch.parallel.shard_engine import clear_shard_context
    from quanonet_torch.solver import Solver
    solver = Solver(config, data=data)
    history = solver.train()
    metrics = solver.evaluate(history)
    clear_shard_context()
    return {'history': history, 'metrics': metrics}


def arm_dp_pp(group, spec, w, x, diag, dp_n):
    """(d): the dp × pp pipeline's output and weight gradient."""
    from quanonet_torch.parallel import mesh
    from quanonet_torch.parallel.pipeline import make_pipeline_hea
    data, pipe = mesh.grid(group, group.world // dp_n)
    f = make_pipeline_hea(spec, pipe, n_microbatches=4,
                          data=data if dp_n > 1 else None)
    wt = torch.as_tensor(w, device=group.device).requires_grad_()
    out = f(wt, torch.as_tensor(x, device=group.device), diag)
    out.sum().backward()
    return {'out': out.detach(), 'w_grad': wt.grad,
            'stages': pipe.world, 'data': dp_n}


def _solver_cfg(prefix, device, **over):
    cfg = dict(operator='Antideriv', model_type='QuanONet', num_train=12,
               num_test=8, num_points=40, num_points_0=8,
               train_sample_num=4, test_sample_num=6, batch_size=12,
               num_epochs=3, learning_rate=0.01, num_qubits=5,
               net_size=list(SHARD_NET), scale_coeff=0.01,
               if_trainable_freq='true', seed=0, prefix=prefix,
               device=str(device))
    cfg.update(over)
    return cfg


def _emit(obj):
    print(json.dumps(obj, default=float), flush=True)


def run(world, device, workdir, share_device=False):
    """The four arms, the Solver's outputs under ``workdir``; returns their
    records."""
    from quanonet_torch.ops.hamiltonian import simple_ham_diag
    from quanonet_torch.ops.hea import hea_expectation, quanonet_spec
    from quanonet_torch.solver import Solver
    kw = dict(device=device, share_device=share_device)
    records = {}
    seed_n = 2 if world % 2 == 0 else 1
    (a,) = {tuple(r['losses']) for r in launch.run_ranks(
        arm_dp_seed, world, args=(4 * (world // seed_n),), **kw)}
    if not np.isfinite(a).all() or len(a) != seed_n:
        raise RuntimeError(f"dp x seed step: losses {a}")
    records['dp_seed'] = {'losses': list(a), 'seeds': seed_n,
                          'data': world // seed_n}
    _emit({'arm': 'dp_seed', **records['dp_seed']})

    amp_n = 1 << (world.bit_length() - 1)
    pipe_n = max(d for d in (4, 2, 1) if d <= world)
    stdout = sys.stdout
    try:
        ref = Solver(_solver_cfg(os.path.join(workdir, 'ref'), device))
        ref_hist = ref.train()
        ref_metrics = ref.evaluate(ref_hist)
        for mode, n in (('amp', amp_n), ('pipe', pipe_n)):
            if mode == 'pipe' and n == 1:
                continue
            cfg = _solver_cfg(os.path.join(workdir, mode), device,
                              shard=mode, num_devices=n,
                              batch_size=12 if mode == 'amp' else 2 * n)
            if mode == 'pipe':
                ref_p = Solver(_solver_cfg(os.path.join(workdir, 'ref_p'),
                                           device, batch_size=2 * n))
                hist0 = ref_p.train()
                base = (hist0, ref_p.evaluate(hist0))
            else:
                base = (ref_hist, ref_metrics)
            r = launch.run_ranks(arm_solver, n,
                                 args=(cfg, ref.data), **kw)[0]
            dev = max(abs(a / b - 1) for a, b in
                      zip(r['history']['loss_train'],
                          base[0]['loss_train']))
            rel = abs(r['metrics']['rel_l2'] / base[1]['rel_l2'] - 1)
            if dev > SHARD_RTOL or rel > SHARD_RTOL:
                raise RuntimeError(f"--shard {mode}: trajectory rel-dev "
                                   f"{dev:.2e}, rel-L2 {rel:.2e}")
            records[f'solver_{mode}'] = {
                'devices': n, 'max_traj_rel_dev': dev, 'rel_l2_rel_dev': rel,
                'rel_l2': r['metrics']['rel_l2']}
    finally:
        sys.stdout = stdout          # the Solver sends stdout to its log
    for mode in ('amp', 'pipe'):
        if f'solver_{mode}' in records:
            _emit({'arm': f'solver_{mode}', **records[f'solver_{mode}']})

    pp_n = min(4, amp_n)
    dp_n = 2 if amp_n >= 2 * pp_n else 1
    spec = quanonet_spec(3, (4, 1, 4, 1))
    rng = np.random.RandomState(1)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.randn(8 * dp_n, spec.total_encode).astype(np.float32)
    diag = simple_ham_diag(3, -5, 5)
    ranks = launch.run_ranks(arm_dp_pp, dp_n * pp_n,
                             args=(spec, w, x, diag, dp_n), **kw)
    wt = torch.tensor(w, requires_grad=True)
    want = hea_expectation(spec, wt, torch.tensor(x), diag=diag,
                           engine='dense')
    want.sum().backward()
    err = max(float(np.abs(r['out'] - want.detach().numpy()).max())
              for r in ranks)
    gerr = max(float(np.abs(r['w_grad'] - wt.grad.numpy()).max())
               for r in ranks)
    scale = max(1.0, float(wt.grad.abs().max()))
    if err > 1e-4 or gerr > 1e-3 * scale:
        raise RuntimeError(f"dp x pp: output {err:.2e}, gradient "
                           f"{gerr:.2e}")
    records['dp_pp'] = {'stages': pp_n, 'data': dp_n,
                        'max_abs_err': err, 'grad_max_abs_err': gerr}
    _emit({'arm': 'dp_pp', **records['dp_pp']})
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--world', type=int, required=True)
    p.add_argument('--device', default=None,
                   help='cuda (default; raises without a card) or cpu')
    p.add_argument('--share_device', action='store_true',
                   help='every rank on card 0 over gloo')
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix='multichip_') as workdir:
        run(args.world, device, workdir, args.share_device)
    _emit({'ok': True, 'world': args.world, 'device': str(device),
           'share_device': args.share_device})
    return 0


if __name__ == '__main__':
    sys.exit(main())
