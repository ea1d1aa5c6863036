"""
The fused-group engines of the port for 8..16 qubits
(quanonet_torch/ops/fused_gates.py, cuda_fused.py) on the CPU, held
against the JAX package on the same NumPy inputs (the slice around them:
tests/test_torch_port_fused_slice.py).

* the tables at n = 8..16, and the ring gather's own backward;
* ``forward_fused`` against the JAX engine ``fused``: values and the
  gradients in the weights and the encodings;
* the plain versions of the chain kernels (``chain_fused``,
  ``chain_fused_saved``, ``chain_fused_backward``) against the VJP of the
  JAX package's Pallas chain (``pallas_fused._make_chain``, interpret mode),
  cotangent by cotangent, at Q8 and Q9;

Tolerances: 2e-5 on amplitudes and chain cotangents (fp32 through a few
blocks, summed in another order than XLA's), 2e-4 on gradients in the
weights and encodings (as the engine tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_tpu.ops import fused_gates as j_fg
from quanonet_tpu.ops import gates as j_gates
from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops import pallas_fused as j_pf
from quanonet_tpu.ops.hamiltonian import simple_ham_diag
from quanonet_torch.ops import cuda_fused, fused_gates as t_fg
from quanonet_torch.ops import gates as t_gates
from quanonet_torch.ops import hea as t_hea
from quanonet_torch.profile_step import launches_of

AMP_TOL = 2e-5
GRAD_TOL = 2e-4
ENCODE_ONLY = ((8, 1), (8, 0), (8, 2), (8, 0))


def _case(nq, net, batch, seed=0, configs=None):
    spec = (j_hea.HEASpec(nq, configs) if configs
            else j_hea.quanonet_spec(nq, net))
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (batch, spec.total_encode)).astype(np.float32)
    tspec = t_hea.HEASpec(spec.n_qubits, spec.block_configs)
    return spec, tspec, w, x, rng


# ── tables and the ring gather ───────────────────────────────────────────────

@pytest.mark.parametrize("n", range(8, 17))
def test_tables_match_jax(n):
    np.testing.assert_array_equal(t_gates.z_signs(n), j_gates.z_signs(n))
    np.testing.assert_array_equal(t_gates.cnot_ring_permutation(n),
                                  j_gates.cnot_ring_permutation(n))
    np.testing.assert_array_equal(t_gates.cnot_ring_inverse_permutation(n),
                                  j_gates.cnot_ring_inverse_permutation(n))
    assert t_fg.qubit_groups(n) == j_fg.qubit_groups(n)


@pytest.mark.parametrize("n,axis", [(3, -1), (9, -1), (4, -2)])
def test_ring_gather_backward_equals_scatter_bit_for_bit(n, axis):
    """The gather by the inverse permutation gives the bits of autograd's
    own backward of index_select (a scatter-add into zeros)."""
    rng = np.random.RandomState(n)
    shape = (5, 2 ** n) if axis == -1 else (3, 2 ** n, 6)
    sr, si = (torch.tensor(rng.randn(*shape).astype(np.float32),
                           requires_grad=True) for _ in range(2))
    g = [torch.tensor(rng.randn(*shape).astype(np.float32))
         for _ in range(2)]
    out = t_gates.ring_apply(n, axis)(sr, si)
    got = torch.autograd.grad(out, (sr, si), g)
    idx = torch.as_tensor(t_gates.cnot_ring_inverse_permutation(n),
                          dtype=torch.long)
    ref = (sr.index_select(axis, idx), si.index_select(axis, idx))
    want = torch.autograd.grad(ref, (sr, si), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    if axis == -1:   # the ring's adjoint undoes it
        back = t_gates.ring_adjoint_apply(n)(*[o.detach() for o in out])
        assert torch.equal(back[0], sr.detach())


# ── the grouped-kron engine 'fused' ──────────────────────────────────────────

FUSED_CASES = [(8, (3, 2, 2, 1), 5, None), (9, (2, 1, 2, 2), 7, None),
               (10, (2, 2, 2, 1), 4, None), (12, (1, 1, 1, 1), 3, None),
               (8, None, 5, ENCODE_ONLY)]


@pytest.mark.parametrize("nq,net,n,configs", FUSED_CASES)
def test_forward_fused_matches_jax(nq, net, n, configs):
    """Values, and gradients in the weights and the encodings, of
    sum(<H>^2) through forward_fused against the JAX engine."""
    spec, tspec, w, x, _ = _case(nq, net, n, seed=nq, configs=configs)
    diag = simple_ham_diag(nq, -5, 5)
    (jr, ji), vjp = jax.vjp(lambda w_, x_: j_fg.forward_fused(spec, w_, x_),
                            jnp.asarray(w), jnp.asarray(x))
    jr, ji = np.asarray(jr), np.asarray(ji)
    # d sum(E^2) / d(sr, si) with E = sum_k (sr^2 + si^2) diag_k
    e = ((jr ** 2 + ji ** 2) * diag).sum(-1, keepdims=True)
    gw_j, gx_j = vjp((jnp.asarray(4 * e * diag * jr),
                      jnp.asarray(4 * e * diag * ji)))

    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    tr, ti = t_fg.forward_fused(tspec, wt, xt)
    np.testing.assert_allclose(tr.detach().numpy(), jr, atol=AMP_TOL)
    np.testing.assert_allclose(ti.detach().numpy(), ji, atol=AMP_TOL)
    out = t_hea.hea_expectation(tspec, wt, xt, diag=diag, engine='fused')
    gw, gx = torch.autograd.grad((out ** 2).sum(), (wt, xt))
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), atol=GRAD_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), atol=GRAD_TOL)


def test_forward_fused_checkpointing_keeps_grads():
    """remat=True (each block under torch.utils.checkpoint, the default
    from 12 qubits) gives the gradients of remat=False, bit for bit."""
    _, tspec, w, x, _ = _case(8, (2, 1, 1, 2), 3, seed=4)
    grads = []
    for remat in (False, True):
        wt = torch.tensor(w, requires_grad=True)
        sr, si = t_fg.forward_fused(tspec, wt, torch.tensor(x), remat=remat)
        grads.append(torch.autograd.grad((sr * sr - si).sum(), wt)[0])
    assert torch.equal(grads[0], grads[1])


# ── the plain versions of the chain kernels ──────────────────────────────────

def test_chain_operands_match_jax():
    """prepare_fused_chain gives forward_pfused's kernel operands: the
    low-group unitaries transposed, the high qubits' 2x2s
    (build_high_rot2x2) and the raw phases."""
    spec, tspec, w, x, _ = _case(10, (2, 2, 2, 1), 3, seed=2)
    gu = j_fg.build_group_unitaries(spec, jnp.asarray(w))
    u2r, u2i = j_fg.build_high_rot2x2(spec, jnp.asarray(w), 7)
    phi = 0.5 * np.einsum('bxn,dn->bxd', x.reshape(3, spec.n_blocks, 10)
                          .transpose(1, 0, 2), j_gates.z_signs(10))
    want = (np.asarray(gu[0][0]).transpose(0, 2, 1),
            np.asarray(gu[0][1]).transpose(0, 2, 1), np.asarray(u2r),
            np.asarray(u2i), phi)
    got = t_fg.prepare_fused_chain(tspec, torch.tensor(w), torch.tensor(x))
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == wnt.shape and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), wnt, atol=1e-5)


@pytest.mark.parametrize("nq,net,n,bfly", [(8, (3, 2, 2, 1), 5, False),
                                           (9, (2, 1, 2, 2), 7, True)])
def test_plain_chain_matches_jax_pallas_vjp(nq, net, n, bfly):
    """chain_fused_saved / chain_fused_backward against jax.vjp of the
    Pallas custom-VJP chain (its _fwd_kernel and _bwd_kernel in interpret
    mode).  With the butterfly layout (bfly) the high group's cotangent is
    the same (S, n-7, 4) array; with the dense hi x hi layout it is a
    different array, and the two are held through the weights' gradient."""
    spec, tspec, w, x, rng = _case(nq, net, n, seed=20 + nq)
    t_ops = t_fg.prepare_fused_chain(tspec, torch.tensor(w), torch.tensor(x))
    ops = [jnp.asarray(a.numpy()) for a in t_ops]
    if not bfly:   # the dense (S, hi, hi) high-group unitaries
        gu = j_fg.build_group_unitaries(spec, jnp.asarray(w))
        ops[2:4] = gu[1]
    g = [rng.randn(n, spec.dim).astype(np.float32) for _ in range(2)]
    chain = j_pf._make_chain(nq, tuple(spec.block_configs), n, False, bfly)
    out, vjp = jax.vjp(chain, *ops)
    want = [np.asarray(a) for a in vjp(tuple(jnp.asarray(a) for a in g))]

    lds = t_fg.block_depths(tspec)
    sr, si, st_r, st_i = t_fg.chain_fused_saved(*t_ops, lds)
    np.testing.assert_allclose(sr.numpy(), np.asarray(out[0]), atol=AMP_TOL)
    np.testing.assert_allclose(si.numpy(), np.asarray(out[1]), atol=AMP_TOL)
    got = t_fg.chain_fused_backward(*t_ops, lds, (st_r, st_i),
                                    *[torch.tensor(a) for a in g])
    names = ('u7bar_r', 'u7bar_i', 'u2bar_r', 'u2bar_i', 'phibar')
    for k in (0, 1, 4) + ((2, 3) if bfly else ()):
        assert tuple(got[k].shape) == want[k].shape, names[k]
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=AMP_TOL,
                                   err_msg=names[k])
    if not bfly:   # the weights' gradient through each package's operands
        def j_loss(w_):
            gu_ = j_fg.build_group_unitaries(spec, w_)
            u7r, u7i = gu_[0]
            r, i = chain(u7r.transpose(0, 2, 1), u7i.transpose(0, 2, 1),
                         *gu_[1], jnp.asarray(ops[4]))
            return jnp.sum(r * g[0] + i * g[1])
        gw_j = jax.grad(j_loss)(jnp.asarray(w))
        wt = torch.tensor(w, requires_grad=True)
        ops_t = t_fg.prepare_fused_chain_x(tspec, wt, torch.tensor(x))
        r, i = cuda_fused.fused_chain(*ops_t, lds)
        (gw,) = torch.autograd.grad(
            (r * torch.tensor(g[0]) + i * torch.tensor(g[1])).sum(), wt)
        np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j),
                                   atol=GRAD_TOL)


def test_plain_backward_matches_autograd_and_gradcheck():
    """chain_fused_backward equals autograd through chain_fused (encode-only
    blocks included), and FusedChain's plain backward passes a float64
    gradcheck."""
    _, tspec, w, x, rng = _case(8, None, 4, seed=9, configs=ENCODE_ONLY)
    ops = [t.detach().requires_grad_()
           for t in t_fg.prepare_fused_chain(tspec, torch.tensor(w),
                                             torch.tensor(x))]
    lds = t_fg.block_depths(tspec)
    g = [torch.tensor(rng.randn(4, 256).astype(np.float32))
         for _ in range(2)]
    sr, si = t_fg.chain_fused(*ops, lds)
    want = torch.autograd.grad((sr * g[0] + si * g[1]).sum(), ops)
    with torch.no_grad():
        saved = t_fg.chain_fused_saved(*ops, lds)
        got = t_fg.chain_fused_backward(*ops, lds, saved[2:], *g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=AMP_TOL)
    args = [torch.tensor(rng.randn(*s), dtype=torch.float64,
                         requires_grad=True)
            for s in ((3, 128, 128), (3, 128, 128), (3, 1, 4), (3, 1, 4),
                      (3, 2, 8))]
    assert torch.autograd.gradcheck(
        lambda *a: cuda_fused.FusedChain.apply(*a, (1, 0, 2)), args,
        fast_mode=True)


def test_fused_chain_on_cpu_is_plain_and_launches_nothing():
    _, tspec, w, x, _ = _case(9, (2, 1, 2, 2), 3, seed=5)
    before = launches_of('fused_chain_fwd', 'fused_chain_bwd')
    ops = t_fg.prepare_fused_chain_x(tspec, torch.tensor(w), torch.tensor(x))
    lds = t_fg.block_depths(tspec)
    got = cuda_fused.fused_chain(*ops, lds)
    want = t_fg.chain_fused_x(*ops, lds)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    req = [t.clone().requires_grad_() for t in ops]
    sr, si = cuda_fused.fused_chain(*req, lds)
    assert 'FusedChain' in type(sr.grad_fn).__name__
    assert torch.equal(sr.detach(), want[0])
    (sr.sum() + si.sum()).backward()
    assert launches_of('fused_chain_fwd', 'fused_chain_bwd') == before
