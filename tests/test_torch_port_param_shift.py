"""
Parameter-shift and SPSA gradients of the port (quanonet_torch/ops/
param_shift.py), the models' grad_method/shots and the solver's
--grad_method / --train_shots / --spsa_c / --ps_chunk, held against the
JAX package on the CPU (``engine='dense'``, as tests/test_param_shift.py
runs it).

Tolerances: the shift Jacobian 1e-5 (2·P forward evaluations in fp32,
each differenced and halved); the shift VJP through a loss and the
model's shift gradients 5e-4 (the JAX test's own, and the port's autograd
to the same limit); SPSA with one injected Δ 1e-6 (a loss that is exact
in fp32, so the limit holds the estimator's formula); a chunked and an
unchunked backward, exact
or sampled, bit-equal (every evaluation runs the same rows and draws from
its own generator).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quanonet_torch.data.generation as t_gen
from quanonet_tpu.models import QuanONet as JQuanONet
from quanonet_tpu.ops import param_shift as j_ps
from quanonet_tpu.ops.hamiltonian import resolve_ham_diag, simple_ham_params
from quanonet_tpu.ops.hea import hea_expectation as j_expectation
from quanonet_tpu.ops.hea import heaqnn_spec as j_heaqnn_spec
from quanonet_torch import infer as t_infer
from quanonet_torch import solver as t_solver
from quanonet_torch.convert import state_dict_from_flax
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import cuda_hea
from quanonet_torch.ops import hea as t_hea
from quanonet_torch.ops import param_shift as t_ps

J_SPEC = j_heaqnn_spec(2, (2, 1))          # S = 2 sublayers: P = 12, n_x = 4
T_SPEC = t_hea.heaqnn_spec(2, (2, 1))
DIAG = resolve_ham_diag(2, [-5.0, 5.0], None)
BATCH = 4


def _wx(seed=7, spec=T_SPEC):
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (BATCH, spec.total_encode)).astype(np.float32)
    return w, x


def _obs(pauli):
    if pauli == 'Z':
        return dict(diag=DIAG)
    off, co = simple_ham_params(2, -5.0, 5.0)
    return dict(pauli=pauli, offset=off, coeff=co)


def test_shift_jacobian_matches_jax():
    w, x = _wx()
    want = j_ps.shift_jacobian(J_SPEC, jnp.asarray(w), jnp.asarray(x),
                               diag=jnp.asarray(DIAG), engine='dense')
    got = t_ps.shift_jacobian(T_SPEC, torch.tensor(w), torch.tensor(x),
                              diag=DIAG, engine='dense', chunk=5)
    assert got.shape == (BATCH,) + T_SPEC.weight_shape()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _port_grads(f, w, x, target, *extra):
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    loss = ((f(wt, xt, *extra) - torch.tensor(target)) ** 2).mean()
    loss.backward()
    return wt.grad, xt.grad


@pytest.mark.parametrize("pauli", ["Z", "X"])
def test_shift_vjp_matches_jax_grad_through_a_loss(pauli):
    """Weight and encode-input cotangents of the shift VJP equal
    jax.grad's and the port's autograd through an MSE loss."""
    w, x = _wx()
    kw = _obs(pauli)
    jkw = {k: (jnp.asarray(v) if k == 'diag' else v) for k, v in kw.items()}
    target = np.linspace(-1.0, 1.0, BATCH, dtype=np.float32)[:, None]

    def loss_ad(a, b):
        return jnp.mean((j_expectation(J_SPEC, a, b, engine='dense', **jkw)
                         - target) ** 2)

    gw_j, gx_j = jax.grad(loss_ad, argnums=(0, 1))(jnp.asarray(w),
                                                   jnp.asarray(x))
    gw, gx = _port_grads(t_ps.make_ps_expectation(T_SPEC, engine='dense',
                                                  **kw), w, x, target)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), atol=5e-4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), atol=5e-4)
    gw_a, gx_a = _port_grads(
        lambda a, b: t_hea.hea_expectation(T_SPEC, a, b, engine='dense',
                                           **kw), w, x, target)
    np.testing.assert_allclose(gw.numpy(), gw_a.numpy(), atol=5e-4)
    np.testing.assert_allclose(gx.numpy(), gx_a.numpy(), atol=5e-4)


@pytest.mark.parametrize("shots", [None, 512])
def test_chunked_backward_equals_unchunked(shots):
    """A chunk of 5 shift indices (12 weights, 4 inputs: ragged) gives the
    unchunked backward's bits, exact and sampled."""
    w, x = _wx()
    target = np.zeros((BATCH, 1), np.float32)
    grads = []
    for chunk in (None, 5, 1):
        f = t_ps.make_ps_expectation(T_SPEC, diag=DIAG, engine='dense',
                                     shots=shots, chunk=chunk)
        extra = (torch.Generator().manual_seed(3),) if shots else ()
        grads.append(_port_grads(f, w, x, target, *extra))
    for gw, gx in grads[1:]:
        assert torch.equal(gw, grads[0][0]) and torch.equal(gx, grads[0][1])


def test_compile_route_fanout_matches_the_fold(monkeypatch):
    """The card's route: the block matrices from the compile kernels'
    function (their plain version here), a weight shift recompiling only
    its block, the final block (right factor I) on its own.  Its shift
    gradients equal the fold's within fp32 rounding, and chunked runs
    are bit-equal."""
    spec = t_hea.quanonet_spec(2, (2, 2, 1, 2))     # 3 blocks, ld 2
    w, x = _wx(9, spec)
    target = np.full((BATCH, 1), 0.3, np.float32)
    dense = _port_grads(t_ps.make_ps_expectation(spec, diag=DIAG,
                                                 engine='dense'),
                        w, x, target)
    monkeypatch.setattr(cuda_hea, 'USE_UCOMP', True)
    runs = [_port_grads(t_ps.make_ps_expectation(spec, diag=DIAG,
                                                 engine='pallas',
                                                 chunk=chunk), w, x, target)
            for chunk in (None, 7)]
    for got, want in zip(runs[0], dense):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))


@pytest.mark.parametrize("route", ["fold", "compile"])
def test_weight_sets_built_in_slices_give_the_same_bits(monkeypatch, route):
    """The shifted sets' block matrices are built a slice at a time under
    SET_BYTES: slices of one and of three sets (ragged) give the bits of
    one slice holding them all."""
    spec = t_hea.quanonet_spec(2, (2, 2, 1, 2))     # 3 blocks, ld 2
    w, x = _wx(11, spec)
    target = np.full((BATCH, 1), -0.2, np.float32)
    monkeypatch.setattr(cuda_hea, 'USE_UCOMP', route == 'compile')
    engine = 'pallas' if route == 'compile' else 'dense'
    per_set = 2 * spec.n_blocks * spec.dim ** 2 * 4
    runs = []
    for sets in (10 ** 6, 1, 3):
        monkeypatch.setattr(t_ps, 'SET_BYTES', sets * per_set)
        runs.append(_port_grads(t_ps.make_ps_expectation(
            spec, diag=DIAG, engine=engine), w, x, target))
    for gw, gx in runs[1:]:
        assert torch.equal(gw, runs[0][0]) and torch.equal(gx, runs[0][1])


def test_finite_shot_gradient_tracks_exact():
    """Finite-shot shift gradients are noisy but unbiased: at 8192 shots
    they point the exact gradient's way (cosine > 0.9, the JAX test's)."""
    w, x = _wx()
    target = np.zeros((BATCH, 1), np.float32)
    gs, _ = _port_grads(t_ps.make_ps_expectation(
        T_SPEC, diag=DIAG, engine='dense', shots=8192), w, x, target,
        torch.Generator().manual_seed(3))
    ge, _ = _port_grads(t_ps.make_ps_expectation(T_SPEC, diag=DIAG,
                                                 engine='dense'),
                        w, x, target)
    gs, ge = gs.flatten().double(), ge.flatten().double()
    assert float(gs @ ge / (gs.norm() * ge.norm())) > 0.9
    with pytest.raises(ValueError, match='generator'):
        t_ps.make_ps_expectation(T_SPEC, diag=DIAG, shots=8)(
            torch.tensor(w), torch.tensor(x), None)


def test_spsa_gradient_with_injected_delta_matches_jax(monkeypatch):
    """One Δ injected into both packages: the same estimate and loss.
    The loss is exact in fp32 (eighths, c a power of two), so both
    packages evaluate it to the same bits and the test holds the
    estimator's formula."""
    rng = np.random.RandomState(4)
    a = (rng.randint(-8, 9, 6) / 8).astype(np.float32)
    b = (rng.randint(-8, 9, (2, 3)) / 8).astype(np.float32)
    va = (rng.randint(-8, 9, 6) / 8).astype(np.float32)
    vb = (rng.randint(-8, 9, (2, 3)) / 8).astype(np.float32)
    deltas = [np.where(rng.rand(6) < 0.5, -1.0, 1.0).astype(np.float32),
              np.where(rng.rand(2, 3) < 0.5, -1.0, 1.0).astype(np.float32)]

    def jloss(p):
        return jnp.sum(p['a'] * va) + jnp.sum(p['b'] * vb) ** 2

    def tloss(p):
        return ((p['a'] * torch.tensor(va)).sum()
                + (p['b'] * torch.tensor(vb)).sum() ** 2)

    order = iter(deltas)
    monkeypatch.setattr(jax.random, 'rademacher',
                        lambda k, shape, dtype: jnp.asarray(next(order)))
    gj, lj = j_ps.spsa_gradient(jloss, {'a': jnp.asarray(a),
                                        'b': jnp.asarray(b)},
                                jax.random.PRNGKey(0), c=0.25)
    torder = iter(deltas)
    monkeypatch.setattr(t_ps, 'rademacher',
                        lambda g, like: torch.tensor(next(torder)))
    gt, lt = t_ps.spsa_gradient(tloss, {'a': torch.tensor(a),
                                        'b': torch.tensor(b)},
                                torch.Generator().manual_seed(0), c=0.25)
    for k in ('a', 'b'):
        assert np.abs(np.asarray(gj[k])).max() > 0.1
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   atol=1e-6)
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-6)


def test_spsa_step_trains_a_circuit_loss():
    """make_spsa_step drives a circuit loss down from two evaluations a
    step over the whole parameter set."""
    w0, x = _wx()
    w_true, _ = _wx(11)
    target = t_hea.hea_expectation(T_SPEC, torch.tensor(w_true),
                                   torch.tensor(x), diag=DIAG,
                                   engine='dense')
    w = torch.nn.Parameter(torch.tensor(w0))

    def loss(p):
        return ((t_hea.hea_expectation(T_SPEC, p['w'], torch.tensor(x),
                                       diag=DIAG, engine='dense')
                 - target) ** 2).mean()

    l0 = loss({'w': w}).item()
    opt = torch.optim.Adam([w], lr=0.1)
    step = t_ps.make_spsa_step(loss, opt, {'w': w}, c=0.1)
    g = torch.Generator().manual_seed(2)
    for _ in range(150):
        step(g)
    assert loss({'w': w}).item() < 0.5 * l0


def test_quanonet_shift_grads_match_autodiff_and_jax():
    """With grad_method='shift' the gradient of every parameter (ansatz,
    TrainableFreq layers, bias) equals the port's autograd and JAX's."""
    kw = dict(num_qubits=2, branch_input_size=3, trunk_input_size=1,
              net_size=(1, 1, 1, 1), scale_coeff=0.01)
    b = np.random.RandomState(1).randn(BATCH, 3).astype(np.float32)
    t = np.random.RandomState(2).randn(BATCH, 1).astype(np.float32)
    target = np.linspace(-1.0, 1.0, BATCH, dtype=np.float32)[:, None]
    jm = JQuanONet(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(b), jnp.asarray(t))
    g_j = jax.grad(lambda p: jnp.mean(
        (jm.apply(p, jnp.asarray(b), jnp.asarray(t)) - target) ** 2))(params)
    g_j = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g_j))
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    grads = {}
    for gm in ('autodiff', 'shift'):
        model = QuanONet(**kw, grad_method=gm, device='cpu')
        model.load_state_dict(sd)
        loss = ((model(torch.tensor(b), torch.tensor(t))
                 - torch.tensor(target)) ** 2).mean()
        loss.backward()
        grads[gm] = {k: p.grad for k, p in model.named_parameters()}
    assert len(grads['shift']) >= 4
    for k, g in grads['shift'].items():
        np.testing.assert_allclose(g.numpy(), grads['autodiff'][k].numpy(),
                                   atol=5e-4, err_msg=k)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]), atol=5e-4,
                                   err_msg=k)


# ── the solver ───────────────────────────────────────────────────────────────

@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.chdir(tmp_path)
    np.random.seed(0)
    return tmp_path


def _cfg(prefix, **over):
    cfg = dict(operator='Antideriv', model_type='QuanONet',
               num_train=20, num_test=5, num_points=30, num_points_0=5,
               num_cal=50, train_sample_num=5, test_sample_num=5,
               batch_size=25, num_epochs=6, epochs_per_sync=2,
               learning_rate=0.05, num_qubits=2, net_size=[1, 1, 1, 1],
               scale_coeff=0.01, if_trainable_freq='true',
               ham_bound=[-5, 5], ham_pauli='Z', seed=0, save_state='true',
               prefix=prefix, device='cpu')
    cfg.update(over)
    return cfg


def test_solver_shift_training_loss_falls_and_reloads(isolated):
    solver = t_solver.Solver(_cfg('out', grad_method='shift', ps_chunk=4))
    assert '_Shift_' in solver.run_id
    hist = solver.train()['loss_train']
    assert np.isfinite(hist).all() and hist[-1] < hist[0]
    metrics = solver.evaluate()
    assert np.isfinite(metrics['rel_l2'])
    # the checkpoint of a _Shift run loads and predicts the ideal circuit
    ckpt = os.path.join(solver.exp_logger.exp_dir, 'best_model.ckpt')
    model, cfg = t_infer.load_model(ckpt, 5, 1, device='cpu')
    assert cfg['grad_method'] == 'shift' and model.grad_method == 'autodiff'
    b, t = solver.test_inputs
    np.testing.assert_allclose(t_infer.predict(model, b, t, cfg=cfg),
                               solver.predict_test(), atol=1e-6)


def test_solver_spsa_with_train_shots(isolated):
    solver = t_solver.Solver(_cfg('out', grad_method='spsa', train_shots=256,
                                  spsa_c=0.1, num_epochs=2))
    assert '_SpsaC0.1Sh256_' in solver.run_id
    assert solver.model.shots == 256
    hist = solver.train()['loss_train']
    assert np.isfinite(hist).all()
    # evaluation samples with the training shots, replayably
    a, b = solver.predict_test(), solver.predict_test()
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(solver.evaluate()['rel_l2'])


@pytest.mark.parametrize("over,match", [
    (dict(train_shots=10), 'needs --grad_method shift or spsa'),
    (dict(grad_method='shift', model_type='DeepONet', net_size=[2, 10]),
     'quantum models only'),
])
def test_train_shots_and_grad_method_checks(isolated, over, match):
    with pytest.raises(ValueError, match=match):
        t_solver.Solver(_cfg('out', **over))


@pytest.mark.parametrize("over", [
    dict(grad_method='spsa', train_shots=64),
    dict(grad_method='shift', train_shots=64, ps_chunk=5),
])
def test_sampled_run_resumes_bit_identically(isolated, over):
    """A run broken after epoch 2 and resumed draws what the unbroken run
    drew: every stochastic step is keyed by (seed, global step)."""
    a = t_solver.Solver(_cfg('outA', **over))
    hist_a = a.train()['loss_train']
    b1 = t_solver.Solver(_cfg('outB', **over))
    orig = b1.exp_logger.log_metric

    def dying_log(tag, value, step):
        if step >= 2:
            raise RuntimeError('simulated preemption')
        return orig(tag, value, step)

    b1.exp_logger.log_metric = dying_log
    with pytest.raises(RuntimeError, match='simulated preemption'):
        b1.train()
    b2 = t_solver.Solver(_cfg('outB', **over))
    hist_b = b2.train()['loss_train']
    assert hist_a == hist_b and len(hist_b) == 6
    for k in a.params:
        assert torch.equal(a.params[k], b2.params[k]), k
