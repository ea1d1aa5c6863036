"""
The fused-group chain kernels' angle contract (quanonet_torch/ops/
cuda_fused.py, csrc/fused_chain.cu: x as (nb, N, n) in place of the phases
φ (nb, N, 2^n)) on the CPU, held against the JAX package on the same NumPy
inputs:

* ``FusedChain`` on CPU tensors (the plain versions ``chain_fused_saved_x``
  and ``chain_fused_backward_x``) against the JAX package's
  ``pallas_fused.forward_pfused`` (its Pallas chain in interpret mode) and
  its VJP with respect to x: Q8 with encoding-only blocks, Q9 Net2-1-2-2,
  Q10 Net5-2-5-2;
* the kernels' phase factorisation, exp(-iφ) as a low-qubit factor times a
  high-qubit factor, against exp(-i·encoding_phases), and x̄ = ½ φ̄·z
  against autograd of φ(x);
* the precision plan of the kernels' tensor-core products: the 3xTF32
  split (round to nearest at TF32's 10-bit mantissa, emulated by bit
  masking) in the kernels' four-product form through the Q10 chain stays
  within the kernels' amplitude limit of the fp32 chain (plain TF32 misses
  it by 20x: 3.9e-4 against 3.7e-7 for the split);
* the order in which the kernels stream the sublayers' operators.

Tolerances: 2e-5 on amplitudes (the kernels' limit, chip_smoke.AMP_TOL:
fp32 through the chain in another order than XLA's); 1e-4 × max(1,
max|x̄|) on the gradient in x (a sum over 2^n amplitudes and back through
every block); 4e-6 on the phase factors (two sincos of sums of up to 16
angles against one of their total, |x| <= 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops import pallas_fused as j_pf
from quanonet_torch.ops import cuda_fused, fused_gates as t_fg
from quanonet_torch.ops import hea as t_hea

AMP_TOL = 2e-5
GRAD_REL_TOL = 1e-4
PHASE_TOL = 4e-6
ENCODE_ONLY = ((8, 1), (8, 0), (8, 2), (8, 0))


def _case(nq, net, batch, seed, configs=None):
    spec = (j_hea.HEASpec(nq, configs) if configs
            else j_hea.quanonet_spec(nq, net))
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (batch, spec.total_encode)).astype(np.float32)
    tspec = t_hea.HEASpec(spec.n_qubits, spec.block_configs)
    return spec, tspec, w, x, rng


@pytest.mark.parametrize("nq,net,n,configs", [
    (8, None, 3, ENCODE_ONLY), (9, (2, 1, 2, 2), 4, None),
    (10, (5, 2, 5, 2), 2, None)])
def test_angle_chain_matches_jax_forward_pfused_and_its_vjp_in_x(
        nq, net, n, configs):
    spec, tspec, w, x, rng = _case(nq, net, n, 30 + nq, configs)
    g = [rng.randn(n, spec.dim).astype(np.float32) for _ in range(2)]
    (jr, ji), vjp = jax.vjp(
        lambda x_: j_pf.forward_pfused(spec, jnp.asarray(w), x_),
        jnp.asarray(x))
    (jgx,) = vjp((jnp.asarray(g[0]), jnp.asarray(g[1])))
    jgx = np.asarray(jgx)

    xt = torch.tensor(x, requires_grad=True)
    *ops, xb = t_fg.prepare_fused_chain_x(tspec, torch.tensor(w), xt)
    assert tuple(xb.shape) == (spec.n_blocks, n, nq)
    xb.retain_grad()
    sr, si = cuda_fused.FusedChain.apply(*ops, xb, t_fg.block_depths(tspec))
    np.testing.assert_allclose(sr.detach().numpy(), np.asarray(jr),
                               atol=AMP_TOL)
    np.testing.assert_allclose(si.detach().numpy(), np.asarray(ji),
                               atol=AMP_TOL)
    (sr * torch.tensor(g[0]) + si * torch.tensor(g[1])).sum().backward()
    # the chain's own cotangent comes back in the kernels' layout
    assert tuple(xb.grad.shape) == (spec.n_blocks, n, nq)
    scale = max(1.0, float(np.abs(jgx).max()))
    assert np.abs(xt.grad.numpy() - jgx).max() <= GRAD_REL_TOL * scale


@pytest.mark.parametrize("nq", [8, 10, 13])
def test_phase_factors_are_exp_of_encoding_phases(nq):
    spec = t_hea.quanonet_spec(nq, (2, 1, 1, 1))
    rng = np.random.RandomState(nq)
    x = torch.tensor(rng.uniform(-2, 2, (3, spec.total_encode))
                     .astype(np.float32))
    xb = t_fg.block_angles(spec, x)
    phi = t_hea.encoding_phases(spec, x)
    assert torch.equal(t_fg.angle_phases(xb), phi)
    (lr, li), (hr, hi) = t_fg.phase_factors(xb)
    assert lr.shape[-1] == 128 and hr.shape[-1] == 2 ** (nq - 7)
    k = torch.arange(2 ** nq)
    lo, up = k & 127, k >> 7
    dr = lr[..., lo] * hr[..., up] - li[..., lo] * hi[..., up]
    di = lr[..., lo] * hi[..., up] + li[..., lo] * hr[..., up]
    assert (dr - torch.cos(phi)).abs().max().item() <= PHASE_TOL
    assert (di + torch.sin(phi)).abs().max().item() <= PHASE_TOL


def test_angles_cotangent_is_the_transpose_of_the_phase_sum():
    rng = np.random.RandomState(4)
    xb = torch.tensor(rng.randn(2, 3, 9).astype(np.float32),
                      requires_grad=True)
    phibar = torch.tensor(rng.randn(2, 3, 512).astype(np.float32))
    (want,) = torch.autograd.grad((t_fg.angle_phases(xb) * phibar).sum(), xb)
    got = t_fg.angles_cotangent(phibar)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def _tf32(v):
    """Round float32 to TF32 (10-bit mantissa), to nearest with ties away
    from zero (cvt.rna.tf32.f32), by adding half a unit and masking."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b from TF32 parts: a_lo b_hi + a_hi b_lo + a_hi b_hi, each
    product exact in fp32 (as on the tensor cores), summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _low_with(mm):
    def low(sr, si, tr, ti):   # the kernels' four real products
        n = sr.shape[0]
        r, i = sr.reshape(-1, 128), si.reshape(-1, 128)
        return ((mm(r, tr) - mm(i, ti)).reshape(n, -1),
                (mm(r, ti) + mm(i, tr)).reshape(n, -1))
    return low


def test_3xtf32_products_keep_the_q10_chain_within_the_amplitude_limit(
        monkeypatch):
    spec = t_hea.quanonet_spec(10, (40, 2, 20, 2))
    rng = np.random.RandomState(10)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32))
    x = torch.tensor(rng.uniform(-4, 4, (4, spec.total_encode))
                     .astype(np.float32))
    lds = t_fg.block_depths(spec)
    ops = t_fg.prepare_fused_chain_x(spec, w, x)
    want = t_fg.chain_fused_x(*ops, lds)
    monkeypatch.setattr(t_fg, '_low', _low_with(_mm_3xtf32))
    got = t_fg.chain_fused_x(*ops, lds)
    assert max((a - b).abs().max().item() for a, b in zip(got, want)) <= AMP_TOL


def test_operator_stream_order():
    """The forward streams sublayers 0..S-1; the backward, per block in
    reverse, its sublayers for the recompute, then in reverse for the
    adjoint products: each sublayer once in each orientation."""
    lds = (2, 0, 1, 3)
    assert cuda_fused.schedule(lds, False) == [0, 2, 4, 6, 8, 10]
    bwd = cuda_fused.schedule(lds, True)
    assert bwd == [6, 8, 10, 11, 9, 7, 4, 5, 0, 2, 3, 1]
    assert sorted(bwd) == list(range(12))
