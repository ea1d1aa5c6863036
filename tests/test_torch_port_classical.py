"""
The classical baselines of the port (quanonet_torch/models/classical.py:
FNN, DeepONet, FNO), held against the flax models of the JAX package on
converted weights, with their checkpoints, encodings, solver epoch,
inference and serving.

Tolerances: 1e-5 on forward values and 2e-5 on gradients (the reference's
cross-backend limits, tests/test_classical_torch_oracle.py); an epoch of
three Adam steps holds parameters to 1e-5.
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
from quanonet_tpu import solver as j_solver
from quanonet_tpu.data import processing as j_proc
from quanonet_tpu.models import classical as j_models
from quanonet_torch import checkpoint as t_ckpt
from quanonet_torch import cli
from quanonet_torch import infer as t_infer
from quanonet_torch import solver as t_solver
from quanonet_torch.convert import (
    classical_state_dict_from_flax, flax_from_classical_state_dict,
    raw_from_state_dict, state_dict_from_raw,
)
from quanonet_torch.data import processing as t_proc
from quanonet_torch.data.manager import DataManager
from quanonet_torch.models import (
    FNN, FNO, DeepONet, deeponet_layer_sizes,
)
from quanonet_torch.models.classical import dft_basis
from quanonet_torch.serve import Predictor

FWD_TOL = 1e-5
GRAD_TOL = 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _hold(jmodel, params, model, inputs, y):
    """Forward values and every gradient of the mean-square loss agree."""
    model.load_state_dict(classical_state_dict_from_flax(_np(params)))

    def jloss(p):
        out = jmodel.apply(p, *[jnp.asarray(a) for a in inputs])
        return jnp.mean((out - y) ** 2), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    out = model(*[torch.tensor(a) for a in inputs])
    assert tuple(out.shape) == jout.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=FWD_TOL, rtol=0)
    ((out - torch.tensor(y)) ** 2).mean().backward()
    want = classical_state_dict_from_flax(_np(jgrads))
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   atol=GRAD_TOL, rtol=0, err_msg=k)


def test_fnn_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(7, 5).astype(np.float32)
    y = rng.randn(7, 1).astype(np.float32)
    jm = j_models.FNN(net_size=(2, 8))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    _hold(jm, params, FNN(5, (2, 8), device='cpu'), (x,), y)


@pytest.mark.parametrize("net_size", [[3, 8], [2, 8, 3, 8], [2, 8, 3, 6],
                                      [3, 7, 2, 9, 5]],
                         ids=['2-arg', '4-arg', '4-arg-mismatch', '5-arg'])
def test_deeponet_matches_flax(net_size):
    rng = np.random.RandomState(1)
    bx = rng.randn(6, 10).astype(np.float32)
    tx = rng.rand(6, 2).astype(np.float32)
    y = rng.randn(6, 1).astype(np.float32)
    bl, tl = deeponet_layer_sizes(net_size, 10, 2)
    assert (bl, tl) == j_models.deeponet_layer_sizes(net_size, 10, 2)
    jm = j_models.DeepONet(branch_layers=bl, trunk_layers=tl)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(bx), jnp.asarray(tx))
    params = jax.tree_util.tree_map(lambda a: a + 0.05, params)  # bias != 0
    model = DeepONet(10, 2, bl, tl, device='cpu')
    assert model.bias.shape == ()
    _hold(jm, params, model, (bx, tx), y)


def test_deeponet_layer_sizes_defaults():
    for cfg in (None, [], [4, 12], [2, 10, 3, 10], [2, 10, 3, 7],
                [2, 10, 3, 7, 4]):
        assert deeponet_layer_sizes(cfg, 10, 2) == \
            j_models.deeponet_layer_sizes(cfg, 10, 2), cfg
    with pytest.raises(ValueError, match='different widths'):
        DeepONet(3, 1, (4, 5), (4, 6), device='cpu')


@pytest.mark.parametrize('n_points,modes', [(16, 5), (15, 8), (16, 9)],
                         ids=['even', 'odd-nyquist', 'even-nyquist'])
def test_fno_matches_flax(n_points, modes):
    """Odd and even signal lengths (the irfft weight conventions differ),
    modes up to the full Nyquist band."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, n_points, 2).astype(np.float32)
    y = rng.randn(4, n_points, 1).astype(np.float32)
    jm = j_models.FNO(modes=modes, width=6, layers=2, fc_hidden=9)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    model = FNO(2, modes=modes, width=6, layers=2, fc_hidden=9, device='cpu')
    _hold(jm, params, model, (x,), y)
    for a, b in zip(dft_basis(n_points, modes),
                    j_models._dft_basis(n_points, modes)):
        np.testing.assert_array_equal(a, b)
    # the DFT matrices are buffers outside the state_dict, rebuilt when the
    # signal length changes
    assert not any('cos' in k or 'sin' in k for k in model.state_dict())
    longer = torch.tensor(rng.randn(2, n_points + 4, 2).astype(np.float32))
    assert tuple(model(longer).shape) == (2, n_points + 4, 1)
    with pytest.raises(ValueError, match='exceeds Nyquist'):
        model(torch.zeros(1, 2 * modes - 3, 2))


@pytest.mark.parametrize("fan_in,fan_out", [(40, 60)])
def test_initial_weights_follow_flax_distributions(fan_in, fan_out):
    """Held by distribution (other random streams): the MLP's kernels are
    truncated normal of variance 2/(in + out), FNO's dense kernels of 1/in,
    biases zero, spectral weights U(0, 1/(in·out))."""
    g = torch.Generator().manual_seed(0)
    fnn = FNN(fan_in, (3, fan_out), device='cpu', generator=g)
    w = fnn.fnn.dense_0.weight.detach().numpy()
    assert w.shape == (fan_out, fan_in)
    std = np.sqrt(2.0 / (fan_in + fan_out))
    assert w.std() == pytest.approx(std, rel=0.05)
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(fnn.fnn.dense_0.bias.detach().abs().max()) == 0.0
    jp = j_models.FNN(net_size=(3, fan_out)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, fan_in)))
    jw = np.asarray(jp['params']['fnn']['dense_0']['kernel'])
    assert jw.std() == pytest.approx(w.std(), rel=0.08)
    assert np.abs(jw).max() == pytest.approx(np.abs(w).max(), rel=0.1)

    fno = FNO(fan_in, modes=8, width=fan_out, layers=1, device='cpu',
              generator=g)
    w0 = fno.fc0.weight.detach().numpy()
    assert w0.std() == pytest.approx(np.sqrt(1.0 / fan_in), rel=0.05)
    wr = fno.conv_0.w_re.detach().numpy()
    scale = 1.0 / (fan_out * fan_out)
    assert wr.shape == (fan_out, fan_out, 8)
    assert wr.min() >= 0 and wr.max() <= scale
    assert wr.mean() == pytest.approx(scale / 2, rel=0.05)
    again = FNN(fan_in, (3, fan_out), device='cpu',
                generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.fnn.dense_0.weight, fnn.fnn.dense_0.weight)


def _models():
    """(model type, flax module, init inputs, port model) of small sizes."""
    bl, tl = deeponet_layer_sizes([2, 6], 4, 1)
    return [
        ('FNN', j_models.FNN(net_size=(2, 6)), (np.zeros((1, 5)),),
         FNN(5, (2, 6), device='cpu')),
        ('DeepONet', j_models.DeepONet(branch_layers=bl, trunk_layers=tl),
         (np.zeros((1, 4)), np.zeros((1, 1))),
         DeepONet(4, 1, bl, tl, device='cpu')),
        ('FNO', j_models.FNO(modes=3, width=4, layers=2, fc_hidden=5),
         (np.zeros((1, 8, 2)),),
         FNO(2, modes=3, width=4, layers=2, fc_hidden=5, device='cpu')),
    ]


@pytest.mark.parametrize("index", [0, 1, 2], ids=['FNN', 'DeepONet', 'FNO'])
def test_classical_checkpoints_round_trip_both_ways(index, tmp_path):
    """A classical .npz / .ckpt written by either package loads in the
    other with equal bytes, and the flat keys are the flax paths."""
    mt, jm, init, model = _models()[index]
    params = jm.init(jax.random.PRNGKey(4),
                     *[jnp.asarray(a, jnp.float32) for a in init])
    params = _np(jax.tree_util.tree_map(lambda a: a + 0.01, params))
    raw = j_ckpt.flatten_tree(params)
    # JAX -> port
    j_ckpt.save_npz(str(tmp_path / 'j.npz'), params, mt)
    j_ckpt.save_ms_ckpt(str(tmp_path / 'j.ckpt'), raw)
    for name in ('j.npz', 'j.ckpt'):
        sd = state_dict_from_raw(t_ckpt.load_raw(str(tmp_path / name)), mt,
                                 None, None, None)
        model.load_state_dict(sd)
        back = raw_from_state_dict(model.state_dict(), mt)
        assert set(back) == set(raw)
        for k in raw:
            assert back[k].shape == raw[k].shape, k
            assert back[k].tobytes() == raw[k].tobytes(), k
    # port -> JAX
    tree = flax_from_classical_state_dict(model.state_dict())
    t_ckpt.save_npz(str(tmp_path / 't.npz'), tree, mt)
    t_ckpt.save_ms_ckpt(str(tmp_path / 't.ckpt'),
                        raw_from_state_dict(model.state_dict(), mt))
    for name in ('t.npz', 't.ckpt'):
        got = j_ckpt.unflatten_tree(j_ckpt.load_raw(str(tmp_path / name)))
        flat = j_ckpt.flatten_tree(got)
        for k in raw:
            assert flat[k].tobytes() == raw[k].tobytes(), k
        assert set(flat) == set(raw)


def _fake_generator(pde, seed=0):
    def generate(num_train, num_test, num_points, num_points_0, num_cal=None):
        rng = np.random.RandomState(seed)
        x = np.linspace(0, 1, num_points)
        u0 = lambda n: rng.randn(n, num_points_0)
        if pde:
            u = lambda n: rng.randn(n, num_points, num_points)
            return (u0(num_train), u(num_train), u0(num_test), u(num_test),
                    x, np.linspace(0, 1, num_points))
        u = lambda n: rng.randn(n, num_points)
        return u0(num_train), u(num_train), u0(num_test), u(num_test), x
    return generate


@pytest.mark.parametrize("pde", [False, True], ids=['ode', 'pde'])
def test_fncode_byte_equal(pde):
    name = 'pde_fncode' if pde else 'ode_fncode'
    got = getattr(t_proc, name)(_fake_generator(pde), 3, 2, 6)
    want = getattr(j_proc, name)(_fake_generator(pde), 3, 2, 6)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_ode_fncode_resamples_coarser_u0():
    def coarse(num_train, num_test, num_points, num_points_0, num_cal=None):
        rng = np.random.RandomState(1)
        return (rng.randn(num_train, 4), rng.randn(num_train, num_points),
                rng.randn(num_test, 4), rng.randn(num_test, num_points),
                np.linspace(0, 1, num_points))
    got = t_proc.ode_fncode(coarse, 3, 2, 7)
    want = j_proc.ode_fncode(coarse, 3, 2, 7)
    assert got[0].shape == (3, 7, 2)
    for a, b in zip(got, want):
        assert (a is None and b is None) or a.tobytes() == b.tobytes()


def test_fno_data_manager_equals_jax(tmp_path, monkeypatch):
    """The FNO branch of the DataManager: the JAX package's arrays, byte
    for byte, under one NumPy seed, in the `_FNO` cache file."""
    import quanonet_tpu.data.generation as j_gen
    from quanonet_tpu.data.manager import DataManager as JDataManager
    cfg = dict(operator='Antideriv', model_type='FNO', num_train=3,
               num_test=2, num_points=12, num_points_0=12, num_cal=50)
    monkeypatch.setattr(j_gen, 'DATA_ROOT', str(tmp_path / 'jraw'),
                        raising=False)
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'traw'))
    np.random.seed(11)
    want = JDataManager(dict(cfg), data_dir=str(tmp_path / 'j')).get_data()
    np.random.seed(11)
    dm = DataManager(dict(cfg), data_dir=str(tmp_path / 't'))
    got = dm.get_data()
    assert dm._get_filename() == 'Antideriv_3_2_12_12_FNO.npz'
    assert os.path.exists(tmp_path / 't' / 'Antideriv' / dm._get_filename())
    assert set(got) == set(want) == {'train_input', 'train_output',
                                     'test_input', 'test_output'}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("index", [0, 1, 2], ids=['FNN', 'DeepONet', 'FNO'])
def test_epoch_with_jax_permutation_equals_make_train_epoch(index):
    """23 samples in batches of 10 (a ragged last batch): the port's epoch,
    fed JAX's permutation, gives JAX's avg_loss, SSE and parameters."""
    mt, jm, init, model = _models()[index]
    rng = np.random.RandomState(5)
    inputs = tuple(rng.randn(23, *a.shape[1:]).astype(np.float32)
                   for a in init)
    y = rng.randn(23, *((8, 1) if mt == 'FNO' else (1,))).astype(np.float32)
    per_sample = int(np.prod(y.shape[1:]))
    params = jm.init(jax.random.PRNGKey(6), *[jnp.asarray(a) for a in inputs])
    model.load_state_dict(classical_state_dict_from_flax(_np(params)))
    key = jax.random.PRNGKey(7)
    opt = optax.adam(0.01)
    epoch = j_solver.make_train_epoch(jm.apply, opt, 23, 10,
                                      per_sample=per_sample)
    (want_p, _), (want_avg, want_sse) = epoch(
        (params, opt.init(params)), key,
        tuple(jnp.asarray(a) for a in inputs), jnp.asarray(y))
    perm = np.array(jax.random.permutation(key, 23))
    topt = t_solver.build_optimizer(dict(optimizer='adam',
                                         learning_rate=0.01), 3,
                                    model.parameters())
    avg, sse = t_solver.make_train_epoch(model, topt, 23, 10, per_sample)(
        perm, tuple(torch.tensor(a) for a in inputs), torch.tensor(y))
    assert avg.item() == pytest.approx(float(want_avg), abs=1e-5)
    assert sse.item() == pytest.approx(float(want_sse), rel=1e-5)
    want = classical_state_dict_from_flax(_np(want_p))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_build_model_defaults_match_jax():
    """FNN (3, 20), FNO 15/14/3/32, DeepONet 2x10: the JAX package's
    defaults when net_size is absent, and its single-input routing."""
    data = dict(train_branch_input=np.zeros((2, 7)),
                train_trunk_input=np.zeros((2, 1)),
                train_input=np.zeros((2, 8)))
    fnn, mode = t_solver.build_model(dict(model_type='FNN'), data,
                                     device='cpu')
    assert mode == 'single' and fnn.net_size == (3, 20)
    assert fnn.fnn.layer_sizes == (20, 20, 20, 20, 1)
    don, mode = t_solver.build_model(dict(model_type='DeepONet'), data,
                                     device='cpu')
    assert mode == 'tuple'
    assert don.branch.layer_sizes == don.trunk.layer_sizes == (10, 10)
    fno, mode = t_solver.build_model(
        dict(model_type='FNO'), dict(train_input=np.zeros((2, 40, 2))),
        device='cpu')
    assert mode == 'single'
    assert (fno.modes, fno.width, fno.layers, fno.fc_hidden) == (15, 14, 3, 32)
    jfno, jmode = j_solver.build_model(dict(model_type='FNO'), {})
    assert jmode == 'single' and (jfno.modes, jfno.width, jfno.layers,
                                  jfno.fc_hidden) == (15, 14, 3, 32)


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.chdir(tmp_path)
    np.random.seed(0)
    return tmp_path


CLI_CASES = {
    'FNN': ['--net_size', '2', '10'],
    'DeepONet': ['--net_size', '2', '10', '2', '10'],
    'FNO': ['--net_size', '4', '6', '2', '8', '--num_points', '20',
            '--num_points_0', '20'],
}


@pytest.mark.parametrize("mt", ['FNN', 'DeepONet', 'FNO'])
def test_cli_trains_and_both_packages_read_the_checkpoint(isolated, mt):
    """python -m quanonet_torch.cli --model_type <classical>: trains with a
    falling loss, writes both formats, resume-skips, and both packages'
    infer reproduce the Solver's predictions from the checkpoint."""
    argv = ['--operator', 'Antideriv', '--model_type', mt, *CLI_CASES[mt],
            '--num_epochs', '3', '--num_train', '20', '--num_test', '10',
            '--num_cal', '100', '--learning_rate', '0.01', '--prefix',
            str(isolated / 'out'), '--device', 'cpu']
    solver = cli.main(argv)
    exp_dir = solver.exp_logger.exp_dir
    assert f'_{mt}_' in solver.run_id
    metrics = json.load(open(os.path.join(exp_dir, 'metric.json')))
    assert all(np.isfinite(v) for v in metrics['metrics'].values())
    losses = metrics['history']['loss_train']
    assert len(losses) == 3 and losses[-1] < losses[0]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 0
    want = solver.predict_test()
    branch = solver.test_inputs[0]
    trunk = solver.test_inputs[1] if mt == 'DeepONet' else None
    if mt == 'FNN':     # the FNN's one input is [branch | trunk]
        branch, trunk = (solver.data['test_branch_input'],
                         solver.data['test_trunk_input'])
    b_in = branch.shape[-1]
    t_in = trunk.shape[1] if trunk is not None else 0
    for ext in ('.ckpt', '.npz'):
        path = os.path.join(exp_dir, 'best_model' + ext)
        model, cfg = t_infer.load_model(path, b_in, t_in, device='cpu')
        assert cfg['model_type'] == mt
        got = t_infer.predict(model, branch, trunk, cfg=cfg)
        np.testing.assert_allclose(got, want, atol=1e-6)
        jm, jparams, jcfg = j_infer.load_model(path, b_in, t_in)
        jgot = j_infer.predict(jm, jparams, branch, trunk, cfg=jcfg)
        np.testing.assert_allclose(jgot, want, atol=FWD_TOL)


def test_train_state_resume_for_a_classical_model(isolated):
    """--save_state: a DeepONet run killed at a segment boundary resumes
    bit-identically."""
    cfg = dict(operator='Antideriv', model_type='DeepONet',
               net_size=[2, 6], num_train=20, num_test=10, num_points=50,
               num_points_0=10, num_cal=100, train_sample_num=5,
               test_sample_num=10, batch_size=25, num_epochs=8,
               epochs_per_sync=4, learning_rate=0.01, seed=0,
               save_state='true', device='cpu')
    a = t_solver.Solver(dict(cfg, prefix='outA'))
    hist_a = a.train()
    b1 = t_solver.Solver(dict(cfg, prefix='outB'))
    orig = b1.exp_logger.log_metric

    def dying_log(tag, value, step):
        if step >= 4:
            raise RuntimeError('simulated preemption')
        return orig(tag, value, step)

    b1.exp_logger.log_metric = dying_log
    with pytest.raises(RuntimeError, match='simulated preemption'):
        b1.train()
    b2 = t_solver.Solver(dict(cfg, prefix='outB'))
    hist_b = b2.train()
    assert hist_a['loss_train'] == hist_b['loss_train']
    for k in a.params:
        assert torch.equal(a.params[k], b2.params[k]), k


@pytest.mark.parametrize("mt", ['DeepONet', 'FNN'])
def test_predictor_serves_classical_models(tmp_path, mt):
    """DeepONet takes (branch, trunk), FNN their concatenation; a missing
    trunk raises; bucket padding is inert."""
    g = torch.Generator().manual_seed(3)
    if mt == 'DeepONet':
        ref = DeepONet(6, 2, (5, 5), (5, 5), device='cpu', generator=g)
        run = tmp_path / 'Antideriv_DeepONet_Net2-5_20x100_Seed0'
    else:
        ref = FNN(8, (2, 5), device='cpu', generator=g)
        run = tmp_path / 'Antideriv_FNN_Net2-5_20x100_Seed0'
    run.mkdir()
    t_ckpt.save_ms_ckpt(str(run / 'best_model.ckpt'),
                        raw_from_state_dict(ref.state_dict(), mt))
    pred = Predictor(str(run / 'best_model.ckpt'), branch_in=6, trunk_in=2,
                     max_batch=4, device='cpu')
    rng = np.random.RandomState(0)
    b = rng.randn(7, 6).astype(np.float32)
    t = rng.rand(7, 2).astype(np.float32)
    got = pred.predict(b, t)
    want = t_infer.predict(pred.model, b, t, cfg=pred.cfg)
    assert got.shape == (7, 1)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert pred.buckets_for(7) == [4, 4]
    with pytest.raises(ValueError, match='expects a trunk input'):
        pred.predict(b)
    assert pred.warmup() >= 0
