"""
The opt-in numeric modes of the port on the CPU, held against the JAX
package's modes of the same name on the same NumPy inputs:

* ``UCOMP_BF16`` (the compile's bf16 operand mode, ops/cuda_ucomp.py):
  compile_block_mats and its weight gradient in the mode (the plain product
  form with bf16=True, through compile_operands) against
  pallas_ucomp.compile_block_mats and jax.grad with
  ``pallas_ucomp.UCOMP_BF16`` set (Pallas in interpret mode);
* ``PFUSED_BF16`` (the fused-group chain's bf16 mode, ops/cuda_fused.py):
  the plain chain with bf16=True (outputs, U7bar, u2bar, phibar) against
  jax.vjp of ``pallas_fused._make_chain(nq, configs, n, True, True)``, and
  each of its three low products against the JAX kernels' ``_make_kara(True)``
  on equal operands;
* ``QON_UNPIN_EXPECT`` (the expectation's precision pin, ops/hea.py);
* the routing: every mode off by default, the chain's mode a no-op on the
  CPU as the JAX package's is off the TPU.

Limits.  Each mode is held within the JAX test's own limit for its bf16
mode (tests/test_ucomp.py: 3e-2; x max(1, max|JAX|) on cotangents) and, to
show that the port rounds where JAX rounds, near the JAX mode's result
measured against that mode's own deviation from its fp32 result at the
same inputs.  The compile's blocks are independent and two or three
products deep, so its max abs difference is held within a quarter of that
deviation.  The chain carries its state through a product a sublayer, and
the two packages' fp32 parts (the Hadamard as butterflies here, as a dot
with H7 there) differ in their last bits: once a rounding lands on the
other side, the row diverges by bf16 steps, and a max abs is then set by
where that happened.  The chain is held by the RMS of the difference
instead, at most half that of the deviation, which the four-product form
(other rounding points) fails in the same test, and each low product on
equal operands to 1e-5.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops import pallas_fused as j_pf
from quanonet_tpu.ops import pallas_ucomp
from quanonet_torch.ops import cuda_fused, cuda_ucomp, gates
from quanonet_torch.ops import fused_gates as t_fg
from quanonet_torch.ops import hea as t_hea

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ATOL = 3e-2        # tests/test_ucomp.py's limit for the bf16 mode
QUARTER = 0.25         # of the JAX mode's own max abs deviation
RMS_SHARE = 0.5        # of the JAX mode's own RMS deviation (the chain)
PRODUCT_TOL = 1e-5     # one product on equal operands: fp32 sums apart


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


# ── UCOMP_BF16 ───────────────────────────────────────────────────────────────

UCOMP_CASES = [((4, (3, 2, 3, 2)), 7), ((5, (2, 2, 2, 2)), 0)]
UCOMP_IDS = ['q4-3-2-3-2', 'q5-2-2-2-2']


def _ucomp_case(nq, net, seed):
    spec, jspec = t_hea.quanonet_spec(nq, net), j_hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    g = [rng.randn(spec.n_blocks, spec.dim, spec.dim).astype(np.float32)
         for _ in range(2)]
    return spec, jspec, w, g


def _jax_mode(on):
    """pallas_ucomp's bf16 switch, its kernel cache and JAX's caches
    cleared, so that no trace of the other mode is reused."""
    pallas_ucomp.UCOMP_BF16 = on
    pallas_ucomp._make_ucomp.cache_clear()
    jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _jax_ucomp(shape, seed):
    """{mode: (mt_r, mt_i, the weights' gradient under the case's random
    cotangent)} of pallas_ucomp.compile_block_mats, f32 and UCOMP_BF16,
    from one jax.vjp each (interpret mode)."""
    _, jspec, w, g = _ucomp_case(*shape, seed)
    out = {}
    try:
        for on in (False, True):
            _jax_mode(on)
            mats, vjp = jax.vjp(
                lambda w_: pallas_ucomp.compile_block_mats(jspec, w_),
                jnp.asarray(w))
            (gw,) = vjp(tuple(jnp.asarray(a) for a in g))
            out[on] = [np.asarray(a) for a in (*mats, gw)]
    finally:
        _jax_mode(False)
    return out


@pytest.mark.parametrize("shape,seed", UCOMP_CASES, ids=UCOMP_IDS)
def test_ucomp_bf16_matches_jax_mode(monkeypatch, shape, seed):
    """compile_block_mats under UCOMP_BF16 (on the CPU: the plain product
    form in the mode) against the JAX package's under its UCOMP_BF16."""
    spec, _, w, _ = _ucomp_case(*shape, seed)
    want = _jax_ucomp(shape, seed)
    monkeypatch.setattr(cuda_ucomp, 'UCOMP_BF16', True)
    got = cuda_ucomp.compile_block_mats(spec, torch.tensor(w))
    for g, b, f in zip(got, want[True][:2], want[False][:2]):
        assert g.shape == (spec.n_blocks, spec.dim, spec.dim)
        assert g.dtype == torch.float32 and g.is_contiguous()
        err, dev = np.abs(g.numpy() - b).max(), np.abs(b - f).max()
        assert err <= JAX_ATOL and err <= QUARTER * dev, (err, dev)


@pytest.mark.parametrize("shape,seed", UCOMP_CASES, ids=UCOMP_IDS)
def test_ucomp_bf16_weight_gradient_matches_jax_mode(monkeypatch, shape,
                                                     seed):
    """The weights' gradient under a random cotangent: UCompBf16's plain
    backward (ucomp_backward_dense with bf16=True) carried through
    compile_operands by autograd, against the VJP through the JAX kernels
    under UCOMP_BF16."""
    spec, _, w, (pr, pi) = _ucomp_case(*shape, seed)
    want = _jax_ucomp(shape, seed)
    monkeypatch.setattr(cuda_ucomp, 'UCOMP_BF16', True)
    wt = torch.tensor(w, requires_grad=True)
    mr, mi = cuda_ucomp.compile_block_mats(spec, wt)
    assert 'UCompBf16' in type(mr.grad_fn).__name__
    (g,) = torch.autograd.grad((mr * torch.tensor(pr)).sum()
                               + (mi * torch.tensor(pi)).sum(), wt)
    err = np.abs(g.numpy() - want[True][2]).max()
    dev = np.abs(want[True][2] - want[False][2]).max()
    scale = max(1.0, np.abs(want[True][2]).max())
    assert err <= JAX_ATOL * scale and err <= QUARTER * dev, (err, dev)


def test_ucomp_bf16_routes_every_compile(monkeypatch):
    """With UCOMP_BF16 the compile (compile_block_mats and the stacked
    form's two launches) takes the mode on the CPU through the plain
    versions and launches nothing; without it, the fp32 path bit for
    bit."""
    spec, _, w, _ = _ucomp_case(4, (3, 2, 3, 2), 11)
    w2 = torch.tensor(np.stack([w, w[::-1].copy()]))
    before = (cuda_ucomp.launches, cuda_ucomp.bwd_launches,
              cuda_ucomp.bf16_launches, cuda_ucomp.bf16_bwd_launches)
    fp32 = cuda_ucomp.compile_block_mats_stacked(spec, w2)
    monkeypatch.setattr(cuda_ucomp, 'UCOMP_BF16', True)
    got = cuda_ucomp.compile_block_mats_stacked(spec, w2)
    for s in range(2):
        want = cuda_ucomp.ucomp_weights_dense(w2[s], 2, spec.n_blocks - 1,
                                              bf16=True)
        for a, b, c in zip(got, want, fp32):
            np.testing.assert_allclose(a[s].numpy(), b.numpy(), atol=1e-6)
            assert (a[s] - c[s]).abs().max().item() > 1e-4   # it moved
    monkeypatch.setattr(cuda_ucomp, 'UCOMP_BF16', False)
    again = cuda_ucomp.compile_block_mats_stacked(spec, w2)
    assert all(torch.equal(a, b) for a, b in zip(again, fp32))
    assert (cuda_ucomp.launches, cuda_ucomp.bwd_launches,
            cuda_ucomp.bf16_launches, cuda_ucomp.bf16_bwd_launches) == before


def test_ucomp_bf16_kernels_refuse_what_they_do_not_take():
    """The bf16 wrappers launch on CUDA tensors or raise: CPU tensors name
    the plain version (no fallback); shapes and `last` are checked before
    any build."""
    ops = cuda_ucomp.compile_operands(torch.zeros(4, 3, 3))
    g = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match='ucomp_dense'):
        cuda_ucomp.ucomp_bf16_forward(*ops, 2, 1)
    with pytest.raises(ValueError, match='ucomp_dense'):
        cuda_ucomp.ucomp_bf16_backward(*ops, 2, 1, g, g)
    with pytest.raises(ValueError, match='blocks of 3'):
        cuda_ucomp.ucomp_bf16_forward(*ops, 3, 0)
    with pytest.raises(ValueError, match='last'):
        cuda_ucomp.ucomp_bf16_forward(*ops, 2, 2)
    with pytest.raises(ValueError, match='2\\^1 .. 2\\^7'):
        cuda_ucomp.ucomp_bf16_forward(torch.zeros(2, 3, 3), ops[1], ops[2],
                                      1, 0)


# ── PFUSED_BF16 ──────────────────────────────────────────────────────────────

def test_fused_bf16_products_match_jax_kara():
    """Each low product of the chain's bf16 mode on equal operands: the
    forward (the state times U7t), the backward's ct · conj(U7t)ᵀ and U7bar =
    conj(PRE)ᵀ · CT, against the JAX kernels' _make_kara(True)."""
    rng = np.random.RandomState(5)
    kara = j_pf._make_kara(True)
    s_r, s_i, c_r, c_i = (rng.randn(24, 128).astype(np.float32) * 0.2
                          for _ in range(4))
    u_r, u_i = (rng.randn(128, 128).astype(np.float32) * 0.09
                for _ in range(2))
    t = lambda a: torch.tensor(a)
    j = jnp.asarray
    got = t_fg._low_bf16(t(s_r), t(s_i), t(u_r), t(u_i))
    want = kara(j(s_r), j(s_i), j(u_r), j(u_i))
    got += t_fg._low_bf16(t(c_r), t(c_i), t(u_r).T, -t(u_i).T)
    want += kara(j(c_r), j(c_i), j(u_r).T, -j(u_i).T)
    got += gates.kara_bf16(t(s_r).T, -t(s_i).T, t(c_r), t(c_i))
    want += kara(j(s_r).T, -j(s_i).T, j(c_r), j(c_i))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=PRODUCT_TOL)
    # the mode rounds: the fp32 product is not within this limit
    exact = t_fg._low(t(s_r), t(s_i), t(u_r), t(u_i))
    assert (exact[1] - got[1]).abs().max().item() > 10 * PRODUCT_TOL


def _four_product(ar, ai, br, bi):
    """(ar + i ai)(br + i bi) in four bf16 products: other rounding points
    than the JAX mode's three (the negative control)."""
    d = gates.bf16_dot
    return d(ar, br) - d(ai, bi), d(ar, bi) + d(ai, br)


def _twin(t_ops, lds, g):
    sr, si, st_r, st_i = t_fg.chain_fused_saved(*t_ops, lds, bf16=True)
    grads = t_fg.chain_fused_backward(*t_ops, lds, (st_r, st_i),
                                      *[torch.tensor(a) for a in g],
                                      bf16=True)
    return [sr.numpy(), si.numpy()] + [a.numpy() for a in grads]


@pytest.mark.parametrize("nq,net,n", [(8, (3, 2, 2, 1), 5),
                                      (9, (2, 1, 2, 2), 7)])
def test_fused_bf16_chain_matches_jax_mode(monkeypatch, nq, net, n):
    """chain_fused_saved / chain_fused_backward with bf16=True against
    jax.vjp of the JAX chain with use_bf16 (butterfly layout, interpret
    mode): outputs, U7bar, u2bar and phibar; the four-product form, which
    rounds elsewhere, fails the same limit."""
    spec = j_hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(20 + nq)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (n, spec.total_encode)).astype(np.float32)
    tspec = t_hea.HEASpec(spec.n_qubits, spec.block_configs)
    t_ops = t_fg.prepare_fused_chain(tspec, torch.tensor(w), torch.tensor(x))
    ops = [jnp.asarray(a.numpy()) for a in t_ops]
    g = [rng.randn(n, spec.dim).astype(np.float32) for _ in range(2)]
    want = {}
    for on in (False, True):
        chain = j_pf._make_chain(nq, tuple(spec.block_configs), n, on, True)
        out, vjp = jax.vjp(chain, *ops)
        want[on] = [np.asarray(a) for a in out] + [
            np.asarray(a) for a in vjp(tuple(jnp.asarray(a) for a in g))]
    lds = t_fg.block_depths(tspec)
    got = _twin(t_ops, lds, g)
    names = ('sr', 'si', 'u7bar_r', 'u7bar_i', 'u2bar_r', 'u2bar_i', 'phibar')
    shares = []
    for name, a, b, f in zip(names, got, want[True], want[False]):
        assert a.shape == b.shape, name
        scale = max(1.0, np.abs(b).max())
        assert np.abs(a - b).max() <= JAX_ATOL * scale, name
        shares.append(_rms(a - b) / _rms(b - f))
    assert max(shares) <= RMS_SHARE, dict(zip(names, shares))
    monkeypatch.setattr(t_fg, 'kara_bf16', _four_product)
    wrong = _twin(t_ops, lds, g)
    assert max(_rms(a - b) / _rms(b - f) for a, b, f in
               zip(wrong, want[True], want[False])) > RMS_SHARE


def test_fused_bf16_mode_is_a_no_op_on_the_cpu(monkeypatch):
    """PFUSED_BF16=1 applies on `cuda` only, as the JAX mode on the TPU
    only: on the CPU fused_chain and its gradient are the fp32 plain chain
    bit for bit and launch nothing."""
    spec = t_hea.quanonet_spec(9, (2, 1, 2, 2))
    rng = np.random.RandomState(4)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32))
    x = torch.tensor(rng.uniform(-2, 2, (3, spec.total_encode))
                     .astype(np.float32))
    ops = t_fg.prepare_fused_chain_x(spec, w, x)
    lds = t_fg.block_depths(spec)
    monkeypatch.setenv('PFUSED_BF16', '1')
    assert cuda_fused.use_bf16()
    before = (cuda_fused.launches, cuda_fused.bwd_launches,
              cuda_fused.bf16_launches, cuda_fused.bf16_bwd_launches)
    got = cuda_fused.fused_chain(*ops, lds)
    want = t_fg.chain_fused_x(*ops, lds)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    req = [o.clone().requires_grad_() for o in ops]
    sr, si = cuda_fused.fused_chain(*req, lds)
    grads = torch.autograd.grad(sr.sum() + 2 * si.sum(), req)
    monkeypatch.delenv('PFUSED_BF16')
    req = [o.clone().requires_grad_() for o in ops]
    sr, si = cuda_fused.fused_chain(*req, lds)
    plain = torch.autograd.grad(sr.sum() + 2 * si.sum(), req)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))
    assert (cuda_fused.launches, cuda_fused.bwd_launches,
            cuda_fused.bf16_launches, cuda_fused.bf16_bwd_launches) == before


# ── QON_UNPIN_EXPECT ─────────────────────────────────────────────────────────

def _bf16_np(a):
    """float32 -> bf16 (to nearest even) -> float32, in NumPy bits."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


def test_unpinned_expectation_rounds_as_numpy():
    """The unpinned expectation: |ψ|² and the diagonal rounded to bf16, the
    products and their sum in fp32, against NumPy's rounding and a float64
    sum (fp32 sums apart)."""
    rng = np.random.RandomState(2)
    sr, si = (rng.randn(6, 64).astype(np.float32) * 0.125 for _ in range(2))
    diag = rng.uniform(-5, 5, 64).astype(np.float32)
    got = t_hea.diag_expectation_unpinned(torch.tensor(sr), torch.tensor(si),
                                          torch.tensor(diag))
    probs = sr * sr + si * si
    want = (_bf16_np(probs).astype(np.float64)
            * _bf16_np(diag).astype(np.float64)).sum(-1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    pinned = t_hea.diag_expectation_pair(torch.tensor(sr), torch.tensor(si),
                                         torch.tensor(diag))
    assert (got - pinned).abs().max().item() > 1e-5   # it rounds


def test_unpin_expect_keeps_the_cpu_pinned(monkeypatch):
    """QON_UNPIN_EXPECT on the CPU: the port's expectation is the pinned
    one bit for bit, as the JAX package's CPU path with _EXPECT_PRECISION
    None equals its pinned output."""
    rng = np.random.RandomState(3)
    sr, si = (rng.randn(5, 32).astype(np.float32) * 0.17 for _ in range(2))
    diag = rng.uniform(-5, 5, 32).astype(np.float32)
    args = [torch.tensor(a) for a in (sr, si, diag)]
    pinned = t_hea.diag_expectation_pair(*args)
    monkeypatch.setattr(t_hea, 'UNPIN_EXPECT', True)
    assert torch.equal(t_hea.diag_expectation_pair(*args), pinned)
    j_pinned = np.asarray(j_hea.diag_expectation_pair(*map(jnp.asarray,
                                                           (sr, si, diag))))
    monkeypatch.setattr(j_hea, '_EXPECT_PRECISION', None)
    j_unpinned = np.asarray(j_hea.diag_expectation_pair(
        *map(jnp.asarray, (sr, si, diag))))
    np.testing.assert_array_equal(j_unpinned, j_pinned)
    np.testing.assert_allclose(pinned.numpy(), j_pinned, atol=1e-6)


# ── the switches ─────────────────────────────────────────────────────────────

def _switches(env):
    """The three switches as a fresh process reads them from ``env``."""
    code = ("from quanonet_torch.ops import cuda_fused, cuda_ucomp, hea; "
            "print(cuda_ucomp.UCOMP_BF16, cuda_fused.use_bf16(), "
            "hea.UNPIN_EXPECT)")
    base = {k: v for k, v in os.environ.items()
            if k not in ('UCOMP_BF16', 'PFUSED_BF16', 'QON_UNPIN_EXPECT')}
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         env={**base, 'PYTHONPATH': REPO, **env},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_modes_are_off_by_default_and_on_with_1():
    """Unset, every mode is off; '1' turns each on (the JAX switches'
    values), anything else leaves it off."""
    assert _switches({}) == ['False', 'False', 'False']
    assert _switches({'UCOMP_BF16': '1', 'PFUSED_BF16': '1',
                      'QON_UNPIN_EXPECT': '1'}) == ['True', 'True', 'True']
