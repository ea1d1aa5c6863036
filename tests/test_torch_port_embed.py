"""
The real-embedding chain in the port (quanonet_torch/ops/cuda_embed.py:
chain_embed, chain_embed_saved, chain_embed_backward, EmbedChain,
pack_operands, forward_embed) on the CPU, held against the JAX package:
pallas_embed._make_chain and its VJP (the Pallas kernels in interpret
mode) on random general E and t, the backward rebuilding each block's
input row from the saved products u alone, forward_embed, the Q5 model's
values and gradients with engine='embed', one optimizer step, a CLI epoch,
and the served Advection anchor.

Tolerances: 2e-5 absolute on the chain's output (fp32, up to 5 blocks,
another summation order than XLA's) and 1e-4 x max(1, max|JAX|) on its
cotangents (Ebar sums N rows of products); 1e-5 on the model's values and
1e-4 on its gradients (a chain of products through the block fold and the
packing as well); 1e-4 on the served anchor (60 blocks).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quanonet_tpu.models import QuanONet as JQuanONet
from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops import pallas_embed
from quanonet_tpu.ops.pallas_hea import _prepare
from quanonet_torch import cli
from quanonet_torch import infer as t_infer
from quanonet_torch import solver as t_solver
from quanonet_torch.convert import state_dict_from_flax
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import cuda_embed
from quanonet_torch.ops import hea as t_hea
from quanonet_torch.profile_step import launches_of
from quanonet_torch.serve import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADVECTION = os.path.join(
    REPO, 'pretrained_weights/Advection/'
    'Advection_QuanONet_Net40-2-20-2_Q5_TF_S0.1_1000x100_Seed0/'
    'best_model.ckpt')
FIXTURE = os.path.join(REPO, 'tests', 'fixtures',
                       'torch_port_advection_anchor.npz')

CHAIN_TOL = 2e-5
BWD_REL_TOL = 1e-4
VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _general(d, nb, n, seed):
    """Random general operands: E with no block structure (scaled so the
    row keeps its size), t with no antisymmetry, and a cotangent."""
    rng = np.random.RandomState(seed)
    w = 2 * d
    e = (rng.randn(nb, w, w) / np.sqrt(w)).astype(np.float32)
    t = rng.uniform(-4, 4, (nb, n, w)).astype(np.float32)
    g = rng.randn(n, w).astype(np.float32)
    return e, t, g


@pytest.mark.parametrize("n", [3, 37])
@pytest.mark.parametrize("nb", [1, 5])
@pytest.mark.parametrize("d", [2, 8, 32])
def test_chain_matches_jax_pallas(d, nb, n):
    """chain_embed / chain_embed_saved / chain_embed_backward == the Pallas
    custom-VJP chain and its jax.vjp (_fwd_kernel and _bwd_kernel in
    interpret mode)."""
    e, t, g = _general(d, nb, n, seed=100 * d + 10 * nb + n)
    chain = pallas_embed._make_chain(nb, d, float(1.0 / np.sqrt(d)))
    out, vjp = jax.vjp(chain, jnp.asarray(e), jnp.asarray(t))
    want_e, want_t = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    te, tt = torch.tensor(e), torch.tensor(t)
    got, u = cuda_embed.chain_embed_saved(te, tt)
    assert tuple(u.shape) == (max(nb - 1, 1), n, 2 * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=CHAIN_TOL)
    np.testing.assert_allclose(cuda_embed.chain_embed(te, tt).numpy(),
                               np.asarray(out), atol=CHAIN_TOL)
    ebar, tbar = cuda_embed.chain_embed_backward(te, tt, u, torch.tensor(g))
    for name, a, b in (('ebar', ebar, want_e), ('tbar', tbar, want_t)):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(
            a.numpy(), b, atol=BWD_REL_TOL * max(1.0, np.abs(b).max()),
            err_msg=name)


@pytest.mark.parametrize("d,nb,n", [(1, 3, 4), (4, 1, 2), (16, 4, 9)])
def test_backward_matches_autograd(d, nb, n):
    """The explicit sweep, and EmbedChain around it, equal autograd through
    chain_embed; no launch is counted on CPU tensors."""
    e, t, g = _general(d, nb, n, seed=d)
    ops = [torch.tensor(a, requires_grad=True) for a in (e, t)]
    want = torch.autograd.grad((cuda_embed.chain_embed(*ops)
                                * torch.tensor(g)).sum(), ops)
    before = launches_of('embed_chain_fwd', 'embed_chain_bwd')
    out = cuda_embed.embed_chain(*ops)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * torch.tensor(g)).sum(), ops)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=CHAIN_TOL)
    with torch.no_grad():
        assert torch.equal(cuda_embed.embed_chain(*ops),
                           cuda_embed.chain_embed(*ops))
    assert launches_of('embed_chain_fwd', 'embed_chain_bwd') == before


def test_backward_float64_gradcheck():
    e, t, _ = _general(2, 3, 2, seed=9)
    ops = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in (e, t)]
    assert torch.autograd.gradcheck(cuda_embed.EmbedChain.apply, ops,
                                    atol=1e-8)


def _case(nq, net, n, seed):
    spec = j_hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (n, spec.total_encode)).astype(np.float32)
    return spec, w, x


def test_pack_operands_equals_jax_packing():
    """E = [[Mr, Mi], [-Mi, Mr]] and t = [phi | -phi], entry for entry."""
    spec, w, x = _case(3, (2, 2, 2, 1), 5, seed=2)
    mt_r, mt_i, phi = (np.asarray(a) for a in _prepare(
        spec, jnp.asarray(w), jnp.asarray(x)))
    want_e = np.concatenate([np.concatenate([mt_r, mt_i], axis=2),
                             np.concatenate([-mt_i, mt_r], axis=2)], axis=1)
    want_t = np.concatenate([phi, -phi], axis=2)
    e, t = cuda_embed.pack_operands(*(torch.tensor(a)
                                      for a in (mt_r, mt_i, phi)))
    np.testing.assert_array_equal(e.numpy(), want_e)
    np.testing.assert_array_equal(t.numpy(), want_t)
    assert e.is_contiguous() and t.is_contiguous()


@pytest.mark.parametrize("nq,net,n", [(5, (3, 2, 2, 2), 6),
                                      (2, (5, 1, 5, 1), 9),
                                      (3, (1, 1, 0, 0), 4)])
def test_forward_embed_matches_jax_and_dense(nq, net, n):
    """forward_embed == the JAX package's forward_embed (Pallas in
    interpret mode; a single block reroutes to its dense path there and
    runs in the chain here) and the port's dense engine."""
    spec, w, x = _case(nq, net, n, seed=nq)
    t_spec = t_hea.quanonet_spec(nq, net)
    jr, ji = pallas_embed.forward_embed(spec, jnp.asarray(w), jnp.asarray(x))
    sr, si = cuda_embed.forward_embed(t_spec, torch.tensor(w),
                                      torch.tensor(x))
    np.testing.assert_allclose(sr.numpy(), np.asarray(jr), atol=VALUE_TOL)
    np.testing.assert_allclose(si.numpy(), np.asarray(ji), atol=VALUE_TOL)
    dr, di = t_hea.forward_dense(t_spec, torch.tensor(w), torch.tensor(x))
    np.testing.assert_allclose(sr.numpy(), dr.numpy(), atol=VALUE_TOL)
    np.testing.assert_allclose(si.numpy(), di.numpy(), atol=VALUE_TOL)
    pr, pi = t_hea.hea_forward_pair(t_spec, torch.tensor(w), torch.tensor(x),
                                    engine='embed')
    assert torch.equal(pr, sr) and torch.equal(pi, si)


def test_embed_refuses_what_it_cannot_run():
    """n_encode != n_qubits raises, as the block-chain engine does; from 8
    qubits the engine raises on either device instead of rerouting."""
    spec = t_hea.HEASpec(2, ((1, 1), (2, 1)))
    with pytest.raises(ValueError, match='n_encode == n_qubits'):
        cuda_embed.forward_embed(spec, torch.zeros(2, 3, 2),
                                 torch.zeros(1, 3))
    spec = t_hea.HEASpec(8, ((8, 1),))
    with pytest.raises(ValueError, match="up to 7 qubits"):
        cuda_embed.forward_embed(spec, torch.zeros(1, 3, 8),
                                 torch.zeros(1, 8))


MODEL = dict(num_qubits=5, branch_input_size=6, trunk_input_size=2,
             net_size=(3, 2, 2, 1), scale_coeff=0.3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(engine, seed=0):
    jm = JQuanONet(**MODEL, engine='embed')
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 6)),
                     jnp.zeros((1, 2)))
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)
    model = QuanONet(**MODEL, engine=engine, device='cpu')
    model.load_state_dict(state_dict_from_flax(_np(params)))
    return jm, params, model


def _batch(n, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 6).astype(np.float32),
            rng.rand(n, 2).astype(np.float32),
            rng.randn(n, 1).astype(np.float32))


@pytest.mark.parametrize("engine", ['embed', 'dense'])
def test_q5_model_values_and_gradients_match_jax(engine):
    """The Q5 model with engine='embed': values and every parameter's
    gradient equal the JAX package's (its engine 'embed'), and so do the
    port's 'dense' ones."""
    jm, params, model = _pair(engine)
    b, t, y = _batch(7)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(b), jnp.asarray(t))
        return jnp.mean((out - y) ** 2), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    out = model(torch.tensor(b), torch.tensor(t))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=VALUE_TOL)
    ((out - torch.tensor(y)) ** 2).mean().backward()
    want = state_dict_from_flax(_np(jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   atol=GRAD_TOL, err_msg=k)


def test_one_adam_step_equals_optax():
    jm, params, model = _pair('embed', seed=2)
    b, t, y = _batch(6, seed=3)
    opt = optax.adam(0.01)
    grads = jax.grad(lambda p: jnp.mean(
        (jm.apply(p, jnp.asarray(b), jnp.asarray(t)) - y) ** 2))(params)
    upd, _ = opt.update(grads, opt.init(params), params)
    want = state_dict_from_flax(_np(optax.apply_updates(params, upd)))
    topt = t_solver.build_optimizer(
        dict(optimizer='adam', learning_rate=0.01), 1, model.parameters())
    loss = ((model(torch.tensor(b), torch.tensor(t)) - torch.tensor(y))
            ** 2).mean()
    topt.zero_grad()
    loss.backward()
    topt.step()
    for k, v in model.state_dict().items():
        # Adam's normalised step turns a gradient's last bits into up to
        # lr x a small share: a hundredth of one step
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4,
                                   err_msg=k)


def test_cli_epoch_with_engine_embed(tmp_path, monkeypatch):
    """python -m quanonet_torch.cli --engine embed trains, writes both
    checkpoint formats, and its checkpoint predicts the Solver's values
    through infer with engine='embed' and 'dense'."""
    import quanonet_torch.data.generation as t_gen
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.chdir(tmp_path)
    np.random.seed(0)
    solver = cli.main([
        '--operator', 'Antideriv', '--model_type', 'QuanONet',
        '--net_size', '5', '1', '5', '1', '--num_qubits', '2',
        '--num_epochs', '2', '--num_train', '20', '--num_test', '10',
        '--num_cal', '100', '--prefix', str(tmp_path / 'out'),
        '--device', 'cpu', '--engine', 'embed'])
    assert solver.model.engine == 'embed'
    exp_dir = solver.exp_logger.exp_dir
    metrics = json.load(open(os.path.join(exp_dir, 'metric.json')))
    assert all(np.isfinite(v) for v in metrics['metrics'].values())
    assert len(metrics['history']['loss_train']) == 2
    want = solver.predict_test()
    for ext, engine in (('.ckpt', 'embed'), ('.npz', 'dense')):
        model, cfg = t_infer.load_model(
            os.path.join(exp_dir, 'best_model' + ext), 10, 1, device='cpu',
            engine=engine)
        assert cfg['engine'] == engine
        got = t_infer.predict(model, *solver.test_inputs, cfg=cfg)
        np.testing.assert_allclose(got, want, atol=VALUE_TOL)


def test_served_anchor_with_engine_embed():
    """The shipped Advection anchor through Predictor with engine='embed'
    gives the JAX package's predictions (the fixture), buckets and all."""
    d = np.load(FIXTURE)
    pred = Predictor(ADVECTION, branch_in=100, trunk_in=2, max_batch=32,
                     device='cpu', engine='embed')
    assert pred.cfg['engine'] == 'embed'
    got = pred.predict(d['branch'], d['trunk'])
    assert got.shape == d['pred'].shape
    np.testing.assert_allclose(got, d['pred'], atol=1e-4)
