"""
The port's training stack (quanonet_torch/solver.py, config.py,
logger.py, checkpoint writers, cli.py) on the CPU, held against the JAX
package: one SGD and one Adam step equal optax's, the learning-rate
schedules equal build_optimizer's, one epoch fed JAX's permutation equals
make_train_epoch, checkpoints cross between the two packages' readers and
writers, run IDs parse in both, and an interrupted run resumes bit for
bit.

Tolerances: 1e-5 absolute on parameters after a few steps and on losses
(fp32 forward and gradient in another summation order, times a learning
rate <= 0.05); schedules to 1e-6 relative (optax evaluates them in fp32).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import quanonet_torch.data.generation as t_gen
from quanonet_tpu import checkpoint as j_ckpt
from quanonet_tpu import infer as j_infer
from quanonet_tpu import logger as j_logger
from quanonet_tpu import solver as j_solver
from quanonet_tpu.models import QuanONet as JQuanONet
from quanonet_torch import checkpoint as t_ckpt
from quanonet_torch import cli
from quanonet_torch import infer as t_infer
from quanonet_torch import logger as t_logger
from quanonet_torch import solver as t_solver
from quanonet_torch.convert import flax_from_state_dict, state_dict_from_flax
from quanonet_torch.models import QuanONet

PARAM_TOL = 1e-5
MODEL = dict(num_qubits=2, branch_input_size=4, trunk_input_size=1,
             net_size=(3, 1, 2, 1), scale_coeff=0.3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed=0, engine='dense'):
    """A JAX QuanONet's params and a port model loaded with them."""
    jm = JQuanONet(**MODEL)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4)),
                     jnp.zeros((1, 1)))
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)
    model = QuanONet(**MODEL, engine=engine, device='cpu')
    model.load_state_dict(state_dict_from_flax(_np(params)))
    return jm, params, model


def _batch(n, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 4).astype(np.float32),
            rng.rand(n, 1).astype(np.float32),
            rng.randn(n, 1).astype(np.float32))


def _assert_params_close(model, jparams, atol=PARAM_TOL):
    want = state_dict_from_flax(_np(jparams))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name,lr", [('sgd', 0.05), ('adam', 0.01)])
def test_one_step_equals_optax(name, lr):
    """The round-5 rule: SGD as well as Adam, since Adam's normalised step
    hides a wrong gradient scale."""
    jm, params, model = _pair()
    b, t, y = _batch(6)
    opt = getattr(optax, name)(lr)
    grads = jax.grad(lambda p: jnp.mean(
        (jm.apply(p, jnp.asarray(b), jnp.asarray(t)) - y) ** 2))(params)
    upd, _ = opt.update(grads, opt.init(params), params)
    want = optax.apply_updates(params, upd)

    topt = t_solver.build_optimizer(
        dict(optimizer=name, learning_rate=lr), 1, model.parameters())
    loss = ((model(torch.tensor(b), torch.tensor(t)) - torch.tensor(y))
            ** 2).mean()
    topt.zero_grad()
    loss.backward()
    topt.step()
    _assert_params_close(model, want)


@pytest.mark.parametrize("sched", [
    dict(), dict(lr_scheduler='cosine'),
    dict(lr_scheduler='cosine', lr_scheduler_kwargs=dict(eta_min=1e-4)),
    dict(lr_scheduler='step', lr_scheduler_kwargs=dict(step_size=5)),
    dict(lr_scheduler='exponential'), dict(lr_scheduler='inverse_time'),
    dict(decay=('cosine', 30, 0.1)), dict(decay=('step', 4, 0.7)),
    dict(decay=('exponential', 10, 0.5)), dict(decay=('inverse time', 8, 2)),
], ids=lambda s: str(s.get('lr_scheduler') or s.get('decay') or 'none'))
def test_schedule_equals_build_optimizer(sched):
    """lr at t = 0, 1, 17, T: the update count before the increment, as
    optax evaluates it.  Read from SGD updates of a gradient of 1."""
    total = 40
    cfg = dict(optimizer='sgd', learning_rate=0.02, **sched)
    opt = j_solver.build_optimizer(cfg, total)
    p = {'w': jnp.zeros(())}
    state = opt.init(p)
    want = []
    for _ in range(total + 1):
        upd, state = opt.update({'w': jnp.ones(())}, state, p)
        want.append(-float(upd['w']))

    w = torch.zeros((), requires_grad=True)
    topt = t_solver.build_optimizer(cfg, total, [w])
    got = []
    for _ in range(total + 1):
        with torch.no_grad():
            w.zero_()
        w.grad = torch.ones(())
        topt.step()
        got.append(-w.item())
    for t in (0, 1, 17, total):
        assert got[t] == pytest.approx(want[t], rel=1e-6, abs=1e-9), t
        assert t_solver.build_schedule(cfg, total)(t) == pytest.approx(
            want[t], rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("name,lr", [('sgd', 0.05), ('adam', 0.01)])
def test_epoch_with_jax_permutation_equals_make_train_epoch(name, lr):
    """23 samples in batches of 10: the last batch is ragged (3 real rows,
    7 masked).  The port's epoch, fed JAX's permutation, gives JAX's
    avg_loss, SSE and parameters."""
    jm, params, model = _pair(seed=3, engine='pallas')
    b, t, y = _batch(23, seed=4)
    key = jax.random.PRNGKey(7)
    opt = getattr(optax, name)(lr)
    epoch = j_solver.make_train_epoch(jm.apply, opt, 23, 10, per_sample=1)
    (want_p, _), (want_avg, want_sse) = epoch(
        (params, opt.init(params)), key,
        (jnp.asarray(b), jnp.asarray(t)), jnp.asarray(y))
    perm = np.array(jax.random.permutation(key, 23))

    topt = t_solver.build_optimizer(dict(optimizer=name, learning_rate=lr),
                                    3, model.parameters())
    avg, sse = t_solver.make_train_epoch(model, topt, 23, 10, 1)(
        perm, (torch.tensor(b), torch.tensor(t)), torch.tensor(y))
    assert avg.item() == pytest.approx(float(want_avg), abs=PARAM_TOL)
    # SSE sums losses x counts: the same fp32 agreement, relative
    assert sse.item() == pytest.approx(float(want_sse), rel=PARAM_TOL)
    _assert_params_close(model, want_p)


def test_run_segment_tracks_best_epoch():
    model = torch.nn.Linear(1, 1)
    scripted = [3.0, 1.0, 2.0, 0.5, 0.7]
    seen = []

    def epoch(perm, inputs, outputs, index):
        seen.append(index)                    # the epoch's index in the run
        with torch.no_grad():
            model.weight.fill_(float(perm))       # the epoch's parameters
        loss = torch.tensor(scripted[perm])
        return loss, 2 * loss

    run = t_solver.make_run_segment(epoch, model)
    best, params, hist = run(float('inf'), None, [0, 1, 2], None, None)
    assert best == 1.0 and params['weight'].item() == 1.0
    assert hist == [(3.0, 6.0), (1.0, 2.0), (2.0, 4.0)]
    best, params, hist = run(best, params, [3, 4], None, None, 3)
    assert best == 0.5 and params['weight'].item() == 3.0
    assert model.weight.item() == 4.0         # the live model moved on
    assert seen == [0, 1, 2, 3, 4]


def test_epoch_permutation_replays():
    a = t_solver.epoch_permutation(0, 5, 50)
    assert torch.equal(a, t_solver.epoch_permutation(0, 5, 50))
    assert sorted(a.tolist()) == list(range(50))
    assert not torch.equal(a, t_solver.epoch_permutation(0, 6, 50))
    assert not torch.equal(a, t_solver.epoch_permutation(1, 5, 50))


def test_segment_size_matches_jax():
    for epochs in (1, 10, 12, 64, 100, 997, 1000):
        assert t_solver._segment_size(epochs) == \
            j_solver._segment_size(epochs), epochs


# ── checkpoints and run IDs across the two packages ─────────────────────────

def test_ckpt_round_trip_through_both_readers(tmp_path):
    _, params, model = _pair(seed=5)
    raw = j_ckpt.quantum_params_to_raw(_np(params), 'QuanONet')
    tree = flax_from_state_dict(model.state_dict())
    t_path, j_path = str(tmp_path / 't.ckpt'), str(tmp_path / 'j.ckpt')
    t_ckpt.save_ms_ckpt(t_path, t_ckpt.quantum_params_to_raw(tree,
                                                             'QuanONet'))
    j_ckpt.save_ms_ckpt(j_path, raw)
    assert open(t_path, 'rb').read() == open(j_path, 'rb').read()
    for reader in (t_ckpt.load_ms_ckpt, j_ckpt.load_ms_ckpt):
        for path in (t_path, j_path):
            got = reader(path)
            assert set(got) == set(raw)
            for k in raw:
                assert got[k].tobytes() == raw[k].tobytes(), k
                assert got[k].shape == raw[k].shape, k
    t_ckpt.save_npz(str(tmp_path / 't.npz'), tree, 'QuanONet')
    got = j_ckpt.load_raw(str(tmp_path / 't.npz'))
    for k in raw:
        assert got[k].tobytes() == raw[k].tobytes(), k
    nested = {'params': {'a': {'b': np.arange(3.0)}, 'c': np.ones(2)}}
    flat = t_ckpt.flatten_tree(nested)
    assert flat.keys() == j_ckpt.flatten_tree(nested).keys() == {'a.b', 'c'}
    back = t_ckpt.unflatten_tree(flat)['params']
    np.testing.assert_array_equal(back['a']['b'], np.arange(3.0))


@pytest.mark.parametrize("cfg", [
    dict(operator='Advection', model_type='QuanONet', net_size=[40, 2, 20, 2],
         num_qubits=5, if_trainable_freq='true', scale_coeff=0.1,
         num_train=1000, num_points=100, seed=0),
    dict(operator='Antideriv', model_type='HEAQNN', net_size=[3, 2],
         num_qubits=3, if_trainable_freq='false', scale_coeff=0.01,
         ham_bound=[-3, 3], ham_pauli='X', quantum_backend='qiskit',
         num_train=20, num_points=50, seed=4),
])
def test_run_id_parses_in_both_packages(cfg):
    run_id = t_logger.get_experiment_id(cfg)
    assert run_id == j_logger.get_experiment_id(cfg)
    path = os.path.join('out', run_id, 'best_model.ckpt')
    got, want = t_infer._parse_path(path), j_infer._parse_path(path)
    assert got == want
    assert got['net_size'] == list(cfg['net_size'])
    assert got['num_qubits'] == cfg['num_qubits']
    assert got['model_type'] == cfg['model_type']


# ── the Solver and the CLI ───────────────────────────────────────────────────

@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.chdir(tmp_path)
    np.random.seed(0)
    return tmp_path


def _solver_cfg(prefix, **over):
    cfg = dict(operator='Antideriv', model_type='QuanONet',
               num_train=20, num_test=10, num_points=50, num_points_0=10,
               num_cal=100, train_sample_num=5, test_sample_num=10,
               batch_size=25, num_epochs=12, epochs_per_sync=4,
               learning_rate=0.01, num_qubits=2, net_size=[2, 1, 2, 1],
               scale_coeff=0.01, if_trainable_freq='true',
               ham_bound=[-5, 5], ham_pauli='Z', seed=0, engine='pallas',
               save_state='true', prefix=prefix, device='cpu')
    cfg.update(over)
    return cfg


def test_interrupted_run_resumes_bit_identically(isolated):
    a = t_solver.Solver(_solver_cfg('outA'))
    hist_a = a.train()

    b1 = t_solver.Solver(_solver_cfg('outB'))
    orig = b1.exp_logger.log_metric

    def dying_log(tag, value, step):
        if step >= 4:
            raise RuntimeError('simulated preemption')
        return orig(tag, value, step)

    b1.exp_logger.log_metric = dying_log
    with pytest.raises(RuntimeError, match='simulated preemption'):
        b1.train()
    state_path = os.path.join(b1.exp_logger.exp_dir, 'train_state.npz')
    assert int(np.load(state_path)['done']) == 4

    b2 = t_solver.Solver(_solver_cfg('outB'))
    hist_b = b2.train()
    assert not os.path.exists(state_path)
    assert len(hist_b['loss_train']) == 12
    assert hist_a['loss_train'] == hist_b['loss_train']
    for k in a.params:
        assert torch.equal(a.params[k], b2.params[k]), k
        assert torch.equal(a.best_params[k], b2.best_params[k]), k
    assert b2.best_loss == a.best_loss


def test_cli_end_to_end_and_resume_skip(isolated):
    argv = ['--operator', 'Antideriv', '--model_type', 'QuanONet',
            '--net_size', '5', '1', '5', '1', '--num_qubits', '2',
            '--num_epochs', '2', '--num_train', '20', '--num_test', '10',
            '--num_cal', '100', '--prefix', str(isolated / 'out'),
            '--device', 'cpu', '--profile', str(isolated / 'prof')]
    solver = cli.main(argv)
    assert os.path.exists(isolated / 'prof' / 'trace.json')
    exp_dir = solver.exp_logger.exp_dir
    metrics = json.load(open(os.path.join(exp_dir, 'metric.json')))
    assert all(np.isfinite(v) for v in metrics['metrics'].values())
    assert len(metrics['history']['loss_train']) == 2
    for name in ('best_model.ckpt', 'best_model.npz', 'final.ckpt',
                 'final.npz', 'train_args.json'):
        assert os.path.exists(os.path.join(exp_dir, name)), name
    # the trained checkpoint loads in both packages' inference paths
    ckpt = os.path.join(exp_dir, 'best_model.ckpt')
    model, cfg = t_infer.load_model(ckpt, 100, 1, device='cpu')
    assert cfg['net_size'] == [5, 1, 5, 1] and cfg['num_qubits'] == 2
    b, t = solver.test_inputs
    np.testing.assert_array_equal(
        t_infer.predict(model, b, t, cfg=cfg), solver.predict_test())
    j_model, j_params, _ = j_infer.load_model(ckpt, 100, 1)
    want = np.asarray(j_model.apply(j_params, jnp.asarray(b),
                                    jnp.asarray(t)))
    np.testing.assert_allclose(solver.predict_test(), want, atol=1e-4)
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 0


@pytest.mark.parametrize("flags,item", [
    (['--shard', 'amp'], '§A item 8'), (['--num_devices', '2'], '§A item 8'),
    (['--datagen', 'device'], '§A item 7'),
    (['--datagen', 'native'], '§A item 7'),
])
def test_cli_unported_flags_raise(isolated, flags, item):
    """The flags of §A item 8 (--shard, --num_devices) and the --datagen
    routes of §A item 7, which raised until they were ported, now train
    and evaluate through the CLI on the CPU (two gloo ranks for
    --num_devices 2; --shard amp alone runs on one device, in this
    process); the generated routes cache under _dg<route>."""
    base = ['--operator', 'Antideriv', '--model_type', 'QuanONet',
            '--device', 'cpu', '--prefix', str(isolated / 'o')]
    solver = cli.main(base + flags + [
        '--net_size', '2', '1', '2', '1', '--num_qubits', '2',
        '--num_epochs', '1', '--num_train', '10', '--num_test', '5',
        '--num_points', '20', '--num_points_0', '5', '--num_cal', '50',
        '--train_sample_num', '5', '--test_sample_num', '5'])
    with open(os.path.join(solver.exp_logger.exp_dir, 'metric.json')) as f:
        assert np.isfinite(json.load(f)['metrics']['rel_l2'])
    if item == '§A item 8':
        from quanonet_torch.parallel.shard_engine import clear_shard_context
        clear_shard_context()
        if flags[0] == '--num_devices':
            assert solver.world == 2
        else:
            assert solver.config['engine'] == 'amp'
        return
    route = flags[1]
    assert os.listdir(isolated / 'data' / 'Antideriv') == [
        f'Antideriv_10_5_20_5_5_5_dg{route}.npz']


@pytest.mark.parametrize("flags,run_ids", [
    (['--multi_seed', '0', '1'], ['_Seed0', '_Seed1']),
    (['--grad_method', 'shift'], ['_Shift_']),
    (['--train_shots', '10', '--grad_method', 'spsa'], ['_SpsaSh10_']),
    (['--noise_p', '0.01', '--noise_traj', '2'], ['_Noise0.01_']),
])
def test_cli_ported_flags_run(isolated, flags, run_ids):
    """--multi_seed, --grad_method shift, --train_shots and --noise_p,
    which raised until they were ported, now train and evaluate through
    the CLI."""
    cli.main(['--operator', 'Antideriv', '--model_type', 'QuanONet',
              '--net_size', '2', '1', '2', '1', '--num_qubits', '2',
              '--num_epochs', '1', '--num_train', '10', '--num_test', '5',
              '--num_points', '20', '--num_points_0', '5', '--num_cal', '50',
              '--train_sample_num', '5', '--test_sample_num', '5',
              '--device', 'cpu', '--prefix', str(isolated / 'o')] + flags)
    runs = os.listdir(isolated / 'o' / 'Antideriv')
    for tag in run_ids:
        (run,) = [r for r in runs if tag in r]
        with open(isolated / 'o' / 'Antideriv' / run / 'metric.json') as f:
            metrics = json.load(f)['metrics']
        assert np.isfinite(metrics['rel_l2'])


def test_classical_models_raise(isolated):
    """The classical model types build (DeepONet by the reference's 4-arg
    net-size policy); an unknown type raises, and so does a noise flag on a
    classical model."""
    from quanonet_torch.models import DeepONet
    solver = t_solver.Solver(_solver_cfg('outC', model_type='DeepONet'))
    assert isinstance(solver.model, DeepONet)
    assert solver.input_mode == 'tuple'
    with pytest.raises(ValueError, match='Unknown model type'):
        t_solver.build_model(dict(model_type='Nope'), {})
    with pytest.raises(ValueError, match='quantum models only'):
        t_solver.build_model(dict(model_type='FNN', noise_p=0.01), {})
