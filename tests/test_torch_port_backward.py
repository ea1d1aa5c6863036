"""
The block chain's backward in the port (quanonet_torch/ops/hea.py
chain_dense_saved / chain_backward_dense, ops/cuda_hea.BlockChain) on the
CPU, held against the JAX package: the VJP of pallas_hea._make_block_chain
(the Pallas kernels in interpret mode), autograd of the plain chain, a
float64 gradcheck, and the whole model's gradients against jax.grad.

Tolerances: 2e-5 absolute on amplitudes and on the chain's cotangents at
these sizes (fp32, a few blocks, another summation order than XLA's);
2e-4 on the whole model's parameter gradients (as the engine tests: a
chain of products through the block fold as well).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_tpu.models import QuanONet as JQuanONet
from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops.pallas_hea import _make_block_chain, _prepare
from quanonet_torch.convert import state_dict_from_flax
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import cuda_hea
from quanonet_torch.ops import hea as t_hea

CHAIN_TOL = 2e-5
GRAD_TOL = 2e-4


def _operands(nq, net, n, seed):
    """JAX's chain operands (pallas_hea._prepare) and a cotangent, NumPy."""
    spec = j_hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (n, spec.total_encode)).astype(np.float32)
    ops = [np.asarray(a) for a in _prepare(spec, jnp.asarray(w),
                                           jnp.asarray(x))]
    g = [rng.randn(n, spec.dim).astype(np.float32) for _ in range(2)]
    return spec, ops, g


def test_backward_matches_jax_pallas_vjp():
    """chain_backward_dense == jax.vjp of the Pallas custom-VJP chain
    (its _bwd_kernel in interpret mode), Q3 Net4-2-3-1, N = 5."""
    spec, ops, g = _operands(3, (4, 2, 3, 1), 5, seed=0)
    chain = _make_block_chain(spec.n_blocks, spec.dim,
                              float(1.0 / np.sqrt(spec.dim)))
    out, vjp = jax.vjp(chain, *[jnp.asarray(a) for a in ops])
    want = [np.asarray(a) for a in vjp(tuple(jnp.asarray(a) for a in g))]

    t_ops = [torch.tensor(a) for a in ops]
    sr, si, st_r, st_i = t_hea.chain_dense_saved(*t_ops)
    np.testing.assert_allclose(sr.numpy(), np.asarray(out[0]), atol=CHAIN_TOL)
    np.testing.assert_allclose(si.numpy(), np.asarray(out[1]), atol=CHAIN_TOL)
    got = t_hea.chain_backward_dense(*t_ops, (st_r, st_i),
                                     *[torch.tensor(a) for a in g])
    for name, a, b in zip(('mbar_r', 'mbar_i', 'phibar'), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=CHAIN_TOL, err_msg=name)


@pytest.mark.parametrize("nq,net,n", [(3, (4, 2, 3, 1), 5),
                                      (1, (2, 1, 2, 1), 3),
                                      (5, (3, 2, 2, 2), 4),
                                      (2, (1, 1, 0, 0), 2)])
def test_backward_matches_autograd(nq, net, n):
    """The explicit sweep equals autograd through chain_dense."""
    spec, ops, g = _operands(nq, net, n, seed=nq)
    t_ops = [torch.tensor(a, requires_grad=True) for a in ops]
    gr, gi = (torch.tensor(a) for a in g)
    sr, si = t_hea.chain_dense(*t_ops)
    want = torch.autograd.grad((sr * gr + si * gi).sum(), t_ops)
    with torch.no_grad():
        _, _, st_r, st_i = t_hea.chain_dense_saved(*t_ops)
        got = t_hea.chain_backward_dense(*t_ops, (st_r, st_i), gr, gi)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=CHAIN_TOL)


def test_saved_states_are_block_inputs():
    """states[b] is block b's input state; the primal output is
    chain_dense's, bit for bit."""
    _, ops, _ = _operands(3, (4, 2, 3, 1), 6, seed=3)
    t_ops = [torch.tensor(a) for a in ops]
    sr, si, st_r, st_i = t_hea.chain_dense_saved(*t_ops)
    pr, pi = t_hea.chain_dense(*t_ops)
    assert torch.equal(sr, pr) and torch.equal(si, pi)
    assert st_r.shape == st_i.shape == t_ops[2].shape
    # states[0] is D(x_1)/sqrt(D); the last block applied to states[-1]
    # gives the output
    d = ops[2].shape[-1]
    torch.testing.assert_close(st_r[0], torch.cos(t_ops[2][0]) / d ** 0.5)
    out_r, out_i = t_hea._kara(st_r[-1], st_i[-1], t_ops[0][-1],
                               t_ops[1][-1])
    assert torch.equal(out_r, sr) and torch.equal(out_i, si)


def test_block_chain_on_cpu_is_plain_and_launches_nothing():
    _, ops, g = _operands(3, (4, 2, 3, 1), 5, seed=1)
    before = (cuda_hea.launches, cuda_hea.bwd_launches)
    t_ops = [torch.tensor(a, requires_grad=True) for a in ops]
    gr, gi = (torch.tensor(a) for a in g)
    sr, si = cuda_hea.block_chain(*t_ops)          # grad needed: BlockChain
    assert sr.grad_fn is not None and 'BlockChain' in type(sr.grad_fn).__name__
    got = torch.autograd.grad((sr * gr + si * gi).sum(), t_ops)
    with torch.no_grad():
        pr, pi, st_r, st_i = t_hea.chain_dense_saved(*t_ops)
        want = t_hea.chain_backward_dense(*t_ops, (st_r, st_i), gr, gi)
    assert torch.equal(sr.detach(), pr) and torch.equal(si.detach(), pi)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (cuda_hea.launches, cuda_hea.bwd_launches) == before


def test_plain_sweep_gradcheck_float64():
    """torch.autograd.gradcheck of BlockChain's plain backward (the explicit
    sweep) in float64 against finite differences."""
    rng = np.random.RandomState(5)
    nb, n, d = 3, 4, 4
    args = [torch.tensor(rng.randn(*s), dtype=torch.float64,
                         requires_grad=True)
            for s in ((nb, d, d), (nb, d, d), (nb, n, d))]
    assert torch.autograd.gradcheck(cuda_hea.BlockChain.apply, args)


@pytest.mark.parametrize("engine", ['pallas', 'dense'])
def test_model_grads_match_jax(engine):
    """The whole QuanONet's parameter gradients (ansatz, frequency maps,
    bias) equal jax.grad of the JAX model on equal parameters."""
    cfg = dict(num_qubits=3, branch_input_size=6, trunk_input_size=2,
               net_size=(3, 2, 2, 1), scale_coeff=0.3)
    rng = np.random.RandomState(8)
    b = rng.randn(7, 6).astype(np.float32)
    t = rng.rand(7, 2).astype(np.float32)
    y = rng.randn(7, 1).astype(np.float32)
    jm = JQuanONet(**cfg, engine='pallas')
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(b), jnp.asarray(t))
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)
    jgrads = jax.grad(lambda p: jnp.mean(
        (jm.apply(p, jnp.asarray(b), jnp.asarray(t)) - y) ** 2))(params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))

    model = QuanONet(**cfg, engine=engine, device='cpu')
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    loss = ((model(torch.tensor(b), torch.tensor(t)) - torch.tensor(y))
            ** 2).mean()
    loss.backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want) == {
        'ansatz', 'bias', 'branch_freq.weights', 'branch_freq.bias',
        'trunk_freq.weights', 'trunk_freq.bias'}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=GRAD_TOL, err_msg=k)
