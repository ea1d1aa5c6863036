"""
The port's Solver and CLI with --num_devices and --shard (quanonet_torch/
solver.py over parallel/) on gloo ranks on the CPU: data parallelism at
W = 2 against W = 1 at batch = the training set, --shard amp at W = 2 and
4 and --shard pipe at W = 2 against the unsharded port Solver (the JAX
dryrun's rtol 1e-4; the JAX package's test_solver_shard_matches_unsharded),
an interrupted W = 2 run resumed bit for bit, rank 0 alone writing the
artifacts, the caller's model holding the trained parameters, the CLI, and
every guard of the JAX package's _setup_sharding.

Every multi-rank run starts its ranks through launch.Ranks with a 60 s
limit a call (launch.DEFAULT_TIMEOUT_S, set here).
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import quanonet_torch.data.generation as t_gen
import torch_dist_workers as workers
from quanonet_torch import cli
from quanonet_torch.parallel import launch
from quanonet_torch.parallel.shard_engine import clear_shard_context
from quanonet_torch.solver import Solver

TIMEOUT_S = 60
SHARD_RTOL = 1e-4
DP_RTOL = 1e-5


def _cfg(prefix, **over):
    cfg = dict(operator='Antideriv', model_type='QuanONet',
               num_train=12, num_test=8, num_points=40, num_points_0=8,
               train_sample_num=4, test_sample_num=6,
               batch_size=16, num_epochs=6, learning_rate=0.01,
               num_qubits=4, net_size=[2, 1, 2, 1], scale_coeff=0.01,
               if_trainable_freq='true', seed=0, prefix=prefix,
               device='cpu')
    cfg.update(over)
    return cfg


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    """A module-wide working directory with its own raw-data root, and the
    per-call rank limit."""
    tmp = tmp_path_factory.mktemp('parallel_solver')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_gen, 'DATA_ROOT', str(tmp / 'raw'))
        mp.setattr(launch, 'DEFAULT_TIMEOUT_S', TIMEOUT_S)
        mp.chdir(tmp)
        yield tmp
    clear_shard_context()


def _run(cfg):
    np.random.seed(0)
    solver = Solver(cfg)
    history = solver.train()
    metrics = solver.evaluate(history)
    clear_shard_context()
    return solver, history, metrics


@pytest.fixture(scope='module')
def unsharded(workdir):
    return _run(_cfg('out_ref'))


@pytest.fixture(scope='module')
def dp_runs(workdir):
    """W = 1 and W = 2 at batch = the 48 training rows: one step an
    epoch."""
    return {w: _run(_cfg(f'out_dp{w}', batch_size=48, num_devices=w))
            for w in (1, 2)}


def test_dp_solver_matches_one_device(dp_runs):
    (_, h1, m1), (s2, h2, m2) = dp_runs[1], dp_runs[2]
    assert s2.world == 2 and len(h2['loss_train']) == 6
    # each rank's kernel launches of train and evaluate (none on the CPU)
    assert len(s2.rank_launches) == 2 and dp_runs[1][0].rank_launches == []
    assert all(set(r) >= {'hea_chain_fwd', 'ucomp_bwd'}
               for r in s2.rank_launches)
    np.testing.assert_allclose(h2['loss_train'], h1['loss_train'],
                               rtol=DP_RTOL)
    np.testing.assert_allclose(m2['rel_l2'], m1['rel_l2'], rtol=DP_RTOL)
    assert h2['loss_train'][-1] < h2['loss_train'][0]


def test_caller_holds_the_trained_model(dp_runs):
    """The caller's model holds rank 0's parameters: its own evaluation of
    the test set reproduces the ranks' sharded rel-L2, and the parameters
    are the one-device run's within the trajectory's tolerance."""
    (s1, _, _), (s2, _, m2) = dp_runs[1], dp_runs[2]
    s2.model.load_state_dict(s2.best_params)
    pred = s2.predict_test()
    rel = np.linalg.norm(pred - s2.test_output) / np.linalg.norm(
        s2.test_output)
    np.testing.assert_allclose(rel, m2['rel_l2'], rtol=1e-5)
    for k, v in s1.params.items():
        np.testing.assert_allclose(s2.params[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_only_rank_zero_writes(dp_runs):
    s2 = dp_runs[2][0]
    exp_dir = s2.exp_logger.exp_dir
    assert sorted(os.listdir(exp_dir)) == sorted([
        'train_args.json', 'train.log', 'best_model.ckpt', 'best_model.npz',
        'final.ckpt', 'final.npz', 'metric.json'])
    with open(os.path.join(exp_dir, 'metric.json')) as f:
        saved = json.load(f)
    assert len(saved['history']['loss_train']) == 6
    # one TensorBoard writer: the caller's, with rank 0's scalars in it
    assert len(os.listdir(s2.exp_logger.tb_dir)) == 1
    log = open(os.path.join(exp_dir, 'train.log')).read()
    assert 'Data-parallel training over 2 devices' in log


@pytest.mark.parametrize("mode,world", [('amp', 2), ('amp', 4),
                                        ('pipe', 2)])
def test_sharded_solver_matches_unsharded(unsharded, mode, world):
    _, ref_hist, ref_metrics = unsharded
    solver, hist, metrics = _run(_cfg(f'out_{mode}{world}', shard=mode,
                                      num_devices=world))
    assert solver.config['engine'] == mode and solver.world == world
    np.testing.assert_allclose(hist['loss_train'], ref_hist['loss_train'],
                               rtol=SHARD_RTOL, atol=1e-6)
    np.testing.assert_allclose(metrics['rel_l2'], ref_metrics['rel_l2'],
                               rtol=SHARD_RTOL, atol=1e-6)
    assert hist['loss_train'][-1] < hist['loss_train'][0]


@pytest.mark.parametrize("mode", ['amp', 'pipe'])
def test_sharded_solver_at_one_device_runs_here(unsharded, mode):
    """At N = 1 the sharded engine runs in this process on a world-1
    group: no rank is started."""
    _, ref_hist, _ = unsharded
    solver, hist, _ = _run(_cfg(f'out_{mode}1', shard=mode, num_devices=1))
    assert solver._ranks is None and solver.group.world == 1
    np.testing.assert_allclose(hist['loss_train'], ref_hist['loss_train'],
                               rtol=SHARD_RTOL, atol=1e-6)


def test_resume_at_two_ranks_is_bit_identical(workdir):
    """Rank 0 dies in epoch 4 of 6 (snapshots every 2): the restarted run
    continues from the snapshot and ends where the unbroken run ends, bit
    for bit; the snapshot is removed at the end."""
    cfg = dict(num_devices=2, save_state='true', epochs_per_sync=2,
               batch_size=8)
    whole = Solver(_cfg('out_whole', **cfg))
    hist_whole = whole.train()

    broken_cfg = _cfg('out_broken', **cfg)
    first = Solver(dict(broken_cfg))
    with pytest.raises(RuntimeError, match='simulated preemption'):
        launch.run_ranks(workers.solver_killed_at, 2,
                         args=(dict(first.config), first.data, 4),
                         timeout_s=TIMEOUT_S)
    state = os.path.join(first.exp_logger.exp_dir, 'train_state.npz')
    assert int(np.load(state)['done']) == 4
    resumed = Solver(dict(broken_cfg))
    hist = resumed.train()
    resumed.evaluate(hist)
    whole.evaluate(hist_whole)
    assert not os.path.exists(state)
    assert hist['loss_train'] == hist_whole['loss_train']
    for k in whole.params:
        assert torch.equal(whole.params[k], resumed.params[k]), k
        assert torch.equal(whole.best_params[k], resumed.best_params[k]), k


@pytest.mark.parametrize("flags", [['--num_devices', '2'],
                                   ['--shard', 'pipe', '--num_devices', '2'],
                                   ['--shard', 'amp']])
def test_cli_trains_over_ranks(workdir, flags):
    prefix = f"out_cli{'_'.join(flags)}"
    solver = cli.main([
        '--operator', 'Antideriv', '--model_type', 'QuanONet',
        '--net_size', '2', '1', '2', '1', '--num_qubits', '2',
        '--num_epochs', '2', '--num_train', '10', '--num_test', '5',
        '--num_points', '20', '--num_points_0', '5', '--num_cal', '50',
        '--train_sample_num', '4', '--test_sample_num', '5',
        '--batch_size', '8', '--device', 'cpu', '--prefix', prefix] + flags)
    clear_shard_context()
    with open(os.path.join(solver.exp_logger.exp_dir, 'metric.json')) as f:
        assert np.isfinite(json.load(f)['metrics']['rel_l2'])
    assert glob.glob(os.path.join(solver.exp_logger.exp_dir,
                                  'best_model.npz'))


@pytest.mark.parametrize("over,match", [
    (dict(model_type='FNN', net_size=[2, 8], shard='amp', num_devices=2),
     'quantum'),
    (dict(shard='amp', num_devices=3), 'power-of-two'),
    (dict(shard='amp', num_devices=32), 'exceed'),
    (dict(shard='pipe', num_devices=3), 'divide evenly'),
    (dict(shard='pipe', num_devices=2, batch_size=15), 'n_microbatches'),
    (dict(shard='amp', num_devices=2, noise_p=0.01), 'incompatible'),
    (dict(shard='pipe', num_devices=2, train_shots=10,
          grad_method='spsa'), 'incompatible'),
    (dict(shard='amp', num_devices=2, multi_seed=[0, 1]), 'incompatible'),
    (dict(shard='amp', num_devices=2, grad_method='shift'), 'autodiff'),
    (dict(num_devices=2, grad_method='shift'), 'single-device'),
    (dict(num_devices=2, grad_method='spsa', train_shots=10),
     'single-device'),
    (dict(shard='mesh'), 'one of'),
    (dict(num_devices=2, device='cuda'), 'CUDA'),
])
def test_guards_raise(workdir, over, match):
    with pytest.raises((ValueError, RuntimeError), match=match):
        Solver(_cfg('out_guard', **over))
    clear_shard_context()
