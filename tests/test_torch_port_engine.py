"""
The port's circuit engine (quanonet_torch/ops/hea.py, cuda_hea.py) on the
CPU, held against the JAX package's engines on the same NumPy inputs.

Tolerances: 2e-5 on amplitudes and 1e-4 on expectations (fp32 through a
chain of up to 60 block products, summed in another order than XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops.hamiltonian import simple_ham_diag
from quanonet_torch.ops import cuda_hea
from quanonet_torch.ops import hea as t_hea

AMP_TOL = 2e-5
EXP_TOL = 1e-4


def _case(nq, net, batch, seed=0):
    spec = j_hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (batch, spec.total_encode)).astype(np.float32)
    return spec, w, x, simple_ham_diag(nq, -5, 5)


def _jax_pair(spec, w, x, engine):
    return [np.asarray(a) for a in j_hea.hea_forward_pair(
        spec, jnp.asarray(w), jnp.asarray(x), engine=engine)]


def _torch_pair(nq, net, w, x, fn):
    spec = t_hea.quanonet_spec(nq, net)
    return [a.numpy() for a in fn(spec, torch.tensor(w), torch.tensor(x))]


@pytest.mark.parametrize("jax_engine,port_fn", [
    ('dense', t_hea.forward_dense),
    ('gates', t_hea.forward_gates),
    ('pallas', t_hea.forward_dense),      # Pallas kernel in interpret mode
    ('dense', cuda_hea.forward_pallas),   # the kernel's wrapper on CPU
])
def test_q3_engines_match_jax(jax_engine, port_fn):
    nq, net = 3, (4, 2, 3, 1)
    spec, w, x, diag = _case(nq, net, batch=5)
    jr, ji = _jax_pair(spec, w, x, jax_engine)
    tr, ti = _torch_pair(nq, net, w, x, port_fn)
    np.testing.assert_allclose(tr, jr, atol=AMP_TOL)
    np.testing.assert_allclose(ti, ji, atol=AMP_TOL)
    want = np.asarray(j_hea.hea_expectation(
        spec, jnp.asarray(w), jnp.asarray(x), diag=jnp.asarray(diag),
        engine=jax_engine))
    got = ((tr ** 2 + ti ** 2) * diag).sum(-1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=EXP_TOL)


def test_flagship_q5_dense_matches_jax():
    nq, net = 5, (40, 2, 20, 2)
    spec, w, x, diag = _case(nq, net, batch=8, seed=3)
    jr, ji = _jax_pair(spec, w, x, 'dense')
    tspec = t_hea.quanonet_spec(nq, net)
    assert tspec.n_blocks == 60 and tspec.weight_shape() == (120, 3, 5)
    tr, ti = t_hea.forward_dense(tspec, torch.tensor(w), torch.tensor(x))
    np.testing.assert_allclose(tr.numpy(), jr, atol=AMP_TOL)
    np.testing.assert_allclose(ti.numpy(), ji, atol=AMP_TOL)
    want = np.asarray(j_hea.hea_expectation(
        spec, jnp.asarray(w), jnp.asarray(x), diag=jnp.asarray(diag),
        engine='dense'))
    got = t_hea.hea_expectation(tspec, torch.tensor(w), torch.tensor(x),
                                diag=diag, engine='auto')
    np.testing.assert_allclose(got.numpy(), want, atol=EXP_TOL)


@pytest.mark.parametrize("pauli", ['X', 'Y'])
def test_pauli_sum_measurement_matches_jax(pauli):
    nq, net = 3, (4, 2, 3, 1)
    spec, w, x, _ = _case(nq, net, batch=4, seed=7)
    want = np.asarray(j_hea.hea_expectation(
        spec, jnp.asarray(w), jnp.asarray(x), pauli=pauli, offset=0.3,
        coeff=1.7, engine='dense'))
    got = t_hea.hea_expectation(t_hea.quanonet_spec(nq, net), torch.tensor(w),
                                torch.tensor(x), pauli=pauli, offset=0.3,
                                coeff=1.7, engine='gates')
    np.testing.assert_allclose(got.numpy(), want, atol=EXP_TOL)


def test_chain_operands_match_jax_prepare():
    """prepare_chain gives pallas_hea._prepare's block matrices and raw
    phases, the kernel's inputs."""
    from quanonet_tpu.ops.pallas_hea import _prepare
    nq, net = 4, (3, 2, 2, 1)
    spec, w, x, _ = _case(nq, net, batch=6, seed=11)
    want = [np.asarray(a) for a in _prepare(spec, jnp.asarray(w),
                                            jnp.asarray(x))]
    got = t_hea.prepare_chain(t_hea.quanonet_spec(nq, net), torch.tensor(w),
                              torch.tensor(x))
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == wnt.shape and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), wnt, atol=1e-5)


def test_single_block_chain():
    nq, net = 2, (1, 1, 0, 0)
    spec, w, x, _ = _case(nq, net, batch=3)
    jr, ji = _jax_pair(spec, w, x, 'gates')
    tr, ti = _torch_pair(nq, net, w, x, t_hea.forward_dense)
    np.testing.assert_allclose(tr, jr, atol=AMP_TOL)
    np.testing.assert_allclose(ti, ji, atol=AMP_TOL)


def test_golden_engine_outputs():
    """The round-1 golden fixture (tests/test_regression_golden.py): the
    port's plain path reproduces ``out``, its autograd gradient ``grad``."""
    import os
    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'fixtures', 'golden_engine_outputs.npz'))
    spec = t_hea.quanonet_spec(3, (4, 2, 3, 1))
    rng = np.random.RandomState(2024)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), requires_grad=True)
    x = torch.tensor(rng.uniform(-2, 2, (6, spec.total_encode))
                     .astype(np.float32))
    diag = simple_ham_diag(3, -5, 5)
    out = t_hea.hea_expectation(spec, w, x, diag=diag, engine='dense')
    np.testing.assert_allclose(out.detach().numpy(), d['out'], atol=1e-4)
    (grad,) = torch.autograd.grad((out ** 2).sum(), w)
    np.testing.assert_allclose(grad.numpy(), d['grad'], atol=1e-4)


def test_plain_grad_matches_jax_at_q5():
    nq, net = 5, (4, 2, 2, 2)
    spec, w, x, diag = _case(nq, net, batch=4, seed=5)
    gw_j, gx_j = jax.grad(lambda w_, x_: jnp.sum(j_hea.hea_expectation(
        spec, w_, x_, diag=jnp.asarray(diag), engine='dense') ** 2),
        argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = t_hea.hea_expectation(t_hea.quanonet_spec(nq, net), wt, xt,
                                diag=diag, engine='dense')
    gw, gx = torch.autograd.grad((out ** 2).sum(), (wt, xt))
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), atol=2e-4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), atol=2e-4)


def test_init_ansatz_weights_seeded_uniform():
    spec = t_hea.quanonet_spec(5, (40, 2, 20, 2))
    a = t_hea.init_ansatz_weights(spec, torch.Generator().manual_seed(0))
    b = t_hea.init_ansatz_weights(spec, torch.Generator().manual_seed(0))
    assert a.shape == (120, 3, 5) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert a.abs().max() <= np.pi and a.std() > 1.5   # U(-π, π): std 1.81
