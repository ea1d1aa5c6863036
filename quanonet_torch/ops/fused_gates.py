"""
Fused-group statevector engine for 8..16 qubits (counterpart of
quanonet_tpu/ops/fused_gates.py, engine ``'fused'``), and the plain
PyTorch versions of the fused-group chain kernels (csrc/fused_chain.cu,
engine ``'pfused'``) in those kernels' operand contract.

A sublayer's rotation stack is a Kronecker product of per-qubit complex
2x2s, R_i = RY(w2)·RZ(w1)·RY(w0), so it is applied to the state in qubit
groups, never as a (2^n, 2^n) matrix.  Per block, with RX(x) = H RZ(x) H:

    ψ ← H^{⊗n} ψ;  ψ ← D(x_b) ⊙ ψ;
    for each sublayer:  ψ ← (⊗ R_i [·H_i]) ψ;  ψ ← Ring ψ

(the encode's left Hadamard folds into the block's first sublayer; a block
with linear_depth 0 applies its left Hadamard instead).  Memory is
O(batch·2^n) for the state and O(S·4^7) for the operators: nothing on this
path builds a D×D matrix (``hea.hadamard_kron`` and
``hea.compile_block_unitaries`` would take 17 GB at Q16).

``forward_fused`` (engine ``'fused'``) is the JAX engine's algebra: each
qubit group's (2^k, 2^k) unitary as a three-product complex contraction,
differentiated by autograd, each block under ``torch.utils.checkpoint``
from 12 qubits up (where the JAX package rematerialises).

The chain's operands (:func:`prepare_fused_chain`): the low group (qubits
0..6) as one 128×128 unitary per sublayer, transposed for row-vector
products (u7t), the high qubits 7..n-1 as per-qubit 2x2 entries
[u00, u01, u10, u11] (u2, ``build_high_rot2x2``; their tensor product is
the dense high-group unitary, the JAX kernel's butterfly mode), and the raw
phases φ (nb, N, 2^n).  :func:`chain_fused`, :func:`chain_fused_saved` and
:func:`chain_fused_backward` compute the chain, its block input states and
its reverse sweep on those operands, with the algebra of
pallas_fused._fwd_kernel and _bwd_kernel.

The kernels take the encoding angles instead of φ
(:func:`prepare_fused_chain_x`: x as (nb, N, n)) and build the phases
themselves from :func:`phase_factors`; :func:`chain_fused_x`,
:func:`chain_fused_saved_x` and :func:`chain_fused_backward_x` are the
plain versions in that contract (φ by :func:`angle_phases`, then the chain
above, and x̄ = ½ φ̄·z).  They are what the kernels' wrappers
(ops/cuda_fused.py) run on CPU tensors, and what the kernels are held
against on the card.
"""
from functools import lru_cache

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from quanonet_torch.ops.gates import (
    _kron2, ring_adjoint_apply, ring_apply, z_signs,
)
from quanonet_torch.ops.hea import _table, encoding_phases

MAX_GROUP_QUBITS = 7   # 2^7 = 128: the low group of the chain kernels
LANE_QUBITS = 7
REMAT_MIN_QUBITS = 12  # forward_fused checkpoints each block from here up

_INV_SQRT2 = float(1.0 / np.sqrt(2.0))
_H2 = np.array([[1.0, 1.0], [1.0, -1.0]], np.float32) / np.sqrt(2.0)


@lru_cache(maxsize=None)
def qubit_groups(n_qubits: int, k_max: int = MAX_GROUP_QUBITS):
    """Partition qubits [0, n) into contiguous groups of at most k_max,
    lowest bits first.  Returns ((offset, k), ...)."""
    groups = []
    off = 0
    while off < n_qubits:
        k = min(k_max, n_qubits - off)
        groups.append((off, k))
        off += k
    return tuple(groups)


@lru_cache(maxsize=None)
def _hadamard_group(k: int) -> np.ndarray:
    """H^{⊗k} as a (2^k, 2^k) float32 constant."""
    u = _H2
    for _ in range(k - 1):
        u = np.kron(_H2, u)
    return np.ascontiguousarray(u, np.float32)


def _rot2x2(w):
    """Per-qubit complex 2x2s of sublayers: R = RY(w2)·RZ(w1)·RY(w0).

    w: (..., 3, n) -> (rr, ri), each (..., n, 2, 2) float32, written out
    entry by entry (no matmul, so no matmul precision mode touches it).
    Conventions are the engine's (ops/gates.py)."""
    a, b, c = w[..., 0, :] / 2.0, w[..., 1, :] / 2.0, w[..., 2, :] / 2.0
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    # RZ·RY(w0): row 0 × e^{-ib}, row 1 × e^{+ib}
    m0r = ((ca * cb, -sa * cb), (sa * cb, ca * cb))
    m0i = ((-ca * sb, sa * sb), (sa * sb, ca * sb))
    ry2 = ((cc, -sc), (sc, cc))

    def times(m):   # RY(w2) @ m, real × complex part
        return torch.stack([torch.stack(
            [ry2[i][0] * m[0][k] + ry2[i][1] * m[1][k] for k in (0, 1)], -1)
            for i in (0, 1)], -2)
    return times(m0r), times(m0i)


def _times_h(m):
    """(..., 2, 2) @ H: columns (m0 + m1, m0 - m1) / √2."""
    c0 = (m[..., 0] + m[..., 1]) * _INV_SQRT2
    c1 = (m[..., 0] - m[..., 1]) * _INV_SQRT2
    return torch.stack([c0, c1], -1)


def first_in_block(spec) -> np.ndarray:
    """Bool mask over sublayers: first-in-block (gets the encode-H fold)."""
    first = np.zeros(spec.total_sublayers, bool)
    s = 0
    for _, ld in spec.block_configs:
        if ld > 0:
            first[s] = True
        s += ld
    return first


def folded_rot2x2(spec, weights):
    """(rr, ri), each (S, n, 2, 2): every sublayer's per-qubit 2x2s, with
    the encode Hadamard right-folded into first-in-block sublayers."""
    rr, ri = _rot2x2(weights)
    fold = torch.as_tensor(first_in_block(spec),
                           device=weights.device)[:, None, None, None]
    return (torch.where(fold, _times_h(rr), rr),
            torch.where(fold, _times_h(ri), ri))


def _ckron(ar, ai, br, bi):
    """Complex Kronecker product A ⊗ B in split-real form (B acts on the
    lower bits), batched over the leading axes."""
    return (_kron2(ar, br) - _kron2(ai, bi)), (_kron2(ar, bi) + _kron2(ai, br))


def _group_unitary(rr, ri, off, k):
    """Kron the per-qubit 2x2s of qubits [off, off+k) (rr, ri: (S, n, 2, 2))
    into a (S, 2^k, 2^k) complex pair, the higher qubit on the left."""
    ur, ui = rr[:, off], ri[:, off]
    for q in range(off + 1, off + k):
        ur, ui = _ckron(rr[:, q], ri[:, q], ur, ui)
    return ur, ui


def _entries(rr, ri, off):
    """(S, n, 2, 2) pairs -> qubits [off, n) as (S, n-off, 4) pairs with
    entries [u00, u01, u10, u11]."""
    s, n = rr.shape[:2]
    return (rr[:, off:].reshape(s, n - off, 4).contiguous(),
            ri[:, off:].reshape(s, n - off, 4).contiguous())


def build_high_rot2x2(spec, weights, off=LANE_QUBITS):
    """Per-qubit complex 2x2 rotations of qubits [off, n) for every
    sublayer, encode Hadamard folded: (u2r, u2i), each (S, n-off, 4) with
    entries [u00, u01, u10, u11].  Their tensor product is the dense group
    unitary of those qubits."""
    return _entries(*folded_rot2x2(spec, weights), off)


def build_group_unitaries(spec, weights):
    """All sublayer group unitaries: {group_index: (ur, ui)}, each
    (S, 2^k, 2^k), the first sublayer of each block with the encode
    Hadamard folded in.  O(S·4^k), independent of 2^n."""
    rr, ri = folded_rot2x2(spec, weights)
    return {gi: _group_unitary(rr, ri, off, k)
            for gi, (off, k) in enumerate(qubit_groups(spec.n_qubits))}


def _apply_group(sr, si, ur, ui, off, k, n_qubits):
    """Apply a (2^k, 2^k) complex unitary to qubits [off, off+k) of the
    (batch, 2^n) split-real state: three real contractions of width 2^k
    (the JAX engine's form)."""
    batch = sr.shape[0]
    shape = (batch, 2 ** (n_qubits - off - k), 2 ** k, 2 ** off)
    r, i = sr.reshape(shape), si.reshape(shape)
    t1 = torch.einsum('bhml,jm->bhjl', r, ur)
    t2 = torch.einsum('bhml,jm->bhjl', i, ui)
    t3 = torch.einsum('bhml,jm->bhjl', r + i, ur + ui)
    return (t1 - t2).reshape(batch, -1), (t3 - t1 - t2).reshape(batch, -1)


def _apply_hadamard(sr, si, groups, n_qubits):
    """ψ ← H^{⊗n} ψ as grouped constant contractions."""
    batch = sr.shape[0]
    for off, k in groups:
        h = torch.as_tensor(_hadamard_group(k), device=sr.device)
        shape = (batch, 2 ** (n_qubits - off - k), 2 ** k, 2 ** off)
        sr = torch.einsum('bhml,jm->bhjl', sr.reshape(shape), h)
        si = torch.einsum('bhml,jm->bhjl', si.reshape(shape), h)
        sr, si = sr.reshape(batch, -1), si.reshape(batch, -1)
    return sr, si


def forward_fused(spec, weights, x, remat=None):
    """Evolve |0…0⟩ through the circuit; returns (sr, si), each
    (batch, 2^n) float32.  x: (batch, n_blocks·n_qubits) block-major encode
    angles (uniform encode, like the dense path).  remat: checkpoint each
    block on the backward pass (default: from REMAT_MIN_QUBITS up)."""
    n = spec.n_qubits
    if not spec.uniform_encode:
        raise ValueError("fused engine requires n_encode == n_qubits "
                         "per block (same contract as dense)")
    if remat is None:
        remat = n >= REMAT_MIN_QUBITS
    groups = qubit_groups(n)
    gu = build_group_unitaries(spec, weights)
    phi = encoding_phases(spec, x)                        # (nb, batch, D)
    ring = ring_apply(n)

    def block(sr, si, phi_b, s0, ld):
        sr, si = _apply_hadamard(sr, si, groups, n)
        dr, di = torch.cos(phi_b), -torch.sin(phi_b)
        sr, si = dr * sr - di * si, dr * si + di * sr
        if ld == 0:   # encoding-only block: its left Hadamard
            return _apply_hadamard(sr, si, groups, n)
        for d in range(ld):
            for gi, (off, k) in enumerate(groups):
                sr, si = _apply_group(sr, si, gu[gi][0][s0 + d],
                                      gu[gi][1][s0 + d], off, k, n)
            sr, si = ring(sr, si)
        return sr, si

    batch = x.shape[0]
    sr = torch.zeros((batch, spec.dim), dtype=torch.float32, device=x.device)
    sr[:, 0] = 1.0
    si = torch.zeros_like(sr)
    s0 = 0
    for b, (_, ld) in enumerate(spec.block_configs):
        if remat and torch.is_grad_enabled():
            sr, si = checkpoint(block, sr, si, phi[b], s0, ld,
                                use_reentrant=False)
        else:
            sr, si = block(sr, si, phi[b], s0, ld)
        s0 += ld
    return sr, si


# ── the plain versions of the chain kernels ─────────────────────────────────

def block_depths(spec):
    """linear_depth of each block, in circuit order: the chain's layout."""
    return tuple(int(ld) for _, ld in spec.block_configs)


def prepare_fused_chain(spec, weights, x):
    """The chain kernels' operands (counterpart of the operand build in
    pallas_fused.forward_pfused): (u7t_r, u7t_i, u2_r, u2_i, phi) with
    u7t (S, 128, 128) the low-group unitaries transposed, u2 (S, n-7, 4) the
    high qubits' 2x2 entries, phi (nb, N, 2^n) the raw phases (exact fp32).
    Differentiable in weights and x."""
    if spec.n_qubits <= LANE_QUBITS:
        raise ValueError(f"the fused-group chain needs more than "
                         f"{LANE_QUBITS} qubits, got {spec.n_qubits}")
    rr, ri = folded_rot2x2(spec, weights)
    u7r, u7i = _group_unitary(rr, ri, 0, LANE_QUBITS)
    return (u7r.transpose(1, 2).contiguous(), u7i.transpose(1, 2).contiguous(),
            *_entries(rr, ri, LANE_QUBITS), encoding_phases(spec, x))


def block_angles(spec, x):
    """x (batch, nb·n), block-major -> (nb, batch, n) contiguous: the
    angles of each block, the kernels' phase operand."""
    n = spec.n_qubits
    return x.reshape(x.shape[0], spec.n_blocks, n).transpose(0, 1).contiguous()


def prepare_fused_chain_x(spec, weights, x):
    """The chain kernels' operands: (u7t_r, u7t_i, u2_r, u2_i, xb), those of
    :func:`prepare_fused_chain` with the angles xb (nb, N, n)
    (:func:`block_angles`) in place of φ.  Differentiable in weights and
    x."""
    if spec.n_qubits <= LANE_QUBITS:
        raise ValueError(f"the fused-group chain needs more than "
                         f"{LANE_QUBITS} qubits, got {spec.n_qubits}")
    rr, ri = folded_rot2x2(spec, weights)
    u7r, u7i = _group_unitary(rr, ri, 0, LANE_QUBITS)
    return (u7r.transpose(1, 2).contiguous(), u7i.transpose(1, 2).contiguous(),
            *_entries(rr, ri, LANE_QUBITS), block_angles(spec, x))


def angle_phases(xb):
    """xb (nb, N, n) -> φ (nb, N, 2^n), φ_k = ½ Σ_i z_i(k) x_i: the sum of
    :func:`quanonet_torch.ops.hea.encoding_phases`, term by term in qubit
    order (exact fp32 whatever the matmul precision)."""
    n = xb.shape[-1]
    zsgn = _table(z_signs(n), xb)                        # (D, n)
    phi = xb[..., 0, None] * zsgn[:, 0]
    for i in range(1, n):
        phi = phi + xb[..., i, None] * zsgn[:, i]
    return 0.5 * phi


def phase_factors(xb):
    """exp(-iφ) of :func:`angle_phases` as the kernels build it: a low
    factor over qubits 0..6 and a high factor over qubits 7..n-1, one angle
    sum and one sincos each, exp(-iφ)[k] = low[k & 127] · high[k >> 7].
    -> ((low_r, low_i) (..., 128), (high_r, high_i) (..., 2^(n-7)))."""
    n = xb.shape[-1]

    def factor(angles, k):
        zsgn = _table(z_signs(k), angles)                # (2^k, k)
        a = angles[..., 0, None] * zsgn[:, 0]
        for i in range(1, k):
            a = a + angles[..., i, None] * zsgn[:, i]
        return torch.cos(0.5 * a), -torch.sin(0.5 * a)
    return factor(xb[..., :LANE_QUBITS], LANE_QUBITS), \
        factor(xb[..., LANE_QUBITS:], n - LANE_QUBITS)


def angles_cotangent(phibar):
    """φ̄ (nb, N, 2^n) -> x̄ (nb, N, n), x̄_i = ½ Σ_k z_i(k) φ̄_k, qubit by
    qubit (exact fp32)."""
    n = phibar.shape[-1].bit_length() - 1
    zsgn = _table(z_signs(n), phibar)
    return 0.5 * torch.stack([(phibar * zsgn[:, i]).sum(-1)
                              for i in range(n)], -1)


def chain_fused_x(u7t_r, u7t_i, u2_r, u2_i, xb, lds):
    """:func:`chain_fused` on the angles xb (nb, N, n): the plain version of
    the forward kernel."""
    return chain_fused(u7t_r, u7t_i, u2_r, u2_i, angle_phases(xb), lds)


def chain_fused_saved_x(u7t_r, u7t_i, u2_r, u2_i, xb, lds):
    """:func:`chain_fused_saved` on the angles xb: the plain version of the
    forward kernel's residual variant."""
    return chain_fused_saved(u7t_r, u7t_i, u2_r, u2_i, angle_phases(xb), lds)


def chain_fused_backward_x(u7t_r, u7t_i, u2_r, u2_i, xb, lds, residuals,
                           gr, gi):
    """:func:`chain_fused_backward` on the angles xb -> (u7bar_r, u7bar_i,
    u2bar_r, u2bar_i, xbar), xbar (nb, N, n): the plain version of the
    backward kernels."""
    *grads, phibar = chain_fused_backward(u7t_r, u7t_i, u2_r, u2_i,
                                          angle_phases(xb), lds, residuals,
                                          gr, gi)
    return (*grads, angles_cotangent(phibar))


def _halves(a, q):
    """(N, 2^n) -> views of the amplitudes with bit q = 0 and = 1."""
    v = a.reshape(a.shape[0], -1, 2, 2 ** q)
    return v[:, :, 0], v[:, :, 1]


def _join(a0, a1):
    return torch.stack([a0, a1], 2).reshape(a0.shape[0], -1)


def _wht(sr, si, n):
    """H^{⊗n}: n add/sub butterflies and one 2^{-n/2} scale."""
    for q in range(n):
        r0, r1 = _halves(sr, q)
        i0, i1 = _halves(si, q)
        sr, si = _join(r0 + r1, r0 - r1), _join(i0 + i1, i0 - i1)
    scale = float(2.0 ** (-n / 2.0))
    return sr * scale, si * scale


def _low(sr, si, tr, ti):
    """Each row's state as (hi, 128) times the 128×128 complex T."""
    n = sr.shape[0]
    r, i = sr.reshape(-1, 128), si.reshape(-1, 128)
    return ((r @ tr - i @ ti).reshape(n, -1), (r @ ti + i @ tr).reshape(n, -1))


def _bfly(sr, si, q, u_r, u_i):
    """The 2x2 u (entries [u00, u01, u10, u11]) on qubit q."""
    r0, r1 = _halves(sr, q)
    i0, i1 = _halves(si, q)

    def mul(k, xr, xi):
        return u_r[k] * xr - u_i[k] * xi, u_r[k] * xi + u_i[k] * xr
    a, b = mul(0, r0, i0), mul(1, r1, i1)
    c, d = mul(2, r0, i0), mul(3, r1, i1)
    return (_join(a[0] + b[0], c[0] + d[0]), _join(a[1] + b[1], c[1] + d[1]))


def _bfly_adj(sr, si, q, u_r, u_i):
    """u^H on qubit q: out0 = conj(u00) s0 + conj(u10) s1,
    out1 = conj(u01) s0 + conj(u11) s1."""
    r0, r1 = _halves(sr, q)
    i0, i1 = _halves(si, q)

    def cmul(k, xr, xi):
        return u_r[k] * xr + u_i[k] * xi, u_r[k] * xi - u_i[k] * xr
    a, b = cmul(0, r0, i0), cmul(2, r1, i1)
    c, d = cmul(1, r0, i0), cmul(3, r1, i1)
    return (_join(a[0] + b[0], c[0] + d[0]), _join(a[1] + b[1], c[1] + d[1]))


def _sub_offsets(lds):
    off = [0]
    for ld in lds:
        off.append(off[-1] + ld)
    return off


def _run_block(sr, si, u7t_r, u7t_i, u2_r, u2_i, phi_b, s0, ld, n):
    sr, si = _wht(sr, si, n)
    pr, pi = torch.cos(phi_b), -torch.sin(phi_b)
    sr, si = pr * sr - pi * si, pr * si + pi * sr
    if ld == 0:
        return _wht(sr, si, n)
    ring = ring_apply(n)
    for s in range(s0, s0 + ld):
        sr, si = _low(sr, si, u7t_r[s], u7t_i[s])
        for j in range(n - LANE_QUBITS):
            sr, si = _bfly(sr, si, LANE_QUBITS + j, u2_r[s, j], u2_i[s, j])
        sr, si = ring(sr, si)
    return sr, si


def _check_layout(u7t_r, u2_r, phi, lds):
    nb, _, dim = phi.shape
    n = dim.bit_length() - 1
    if dim != 2 ** n or n <= LANE_QUBITS:
        raise ValueError(f"phi must be (nb, N, 2^n) with n > {LANE_QUBITS}, "
                         f"got {tuple(phi.shape)}")
    if len(lds) != nb or sum(lds) != u7t_r.shape[0] or min(lds) < 0:
        raise ValueError(f"block depths {lds} do not match {nb} blocks and "
                         f"{u7t_r.shape[0]} sublayers")
    if tuple(u2_r.shape[1:]) != (n - LANE_QUBITS, 4):
        raise ValueError(f"u2 must be (S, {n - LANE_QUBITS}, 4), got "
                         f"{tuple(u2_r.shape)}")
    return n


def chain_fused_saved(u7t_r, u7t_i, u2_r, u2_i, phi, lds):
    """The chain from |0…0⟩ -> (sr, si, states_r, states_i): the output
    (N, 2^n) and each block's input state (nb, N, 2^n).  lds: the blocks'
    linear depths (:func:`block_depths`).  The plain version of the
    forward kernel's residual variant."""
    n = _check_layout(u7t_r, u2_r, phi, lds)
    nb, batch, dim = phi.shape
    sr = torch.zeros((batch, dim), dtype=torch.float32, device=phi.device)
    sr[:, 0] = 1.0
    si = torch.zeros_like(sr)
    off = _sub_offsets(lds)
    states_r, states_i = [], []
    for b in range(nb):
        states_r.append(sr)
        states_i.append(si)
        sr, si = _run_block(sr, si, u7t_r, u7t_i, u2_r, u2_i, phi[b],
                            off[b], lds[b], n)
    return sr, si, torch.stack(states_r), torch.stack(states_i)


def chain_fused(u7t_r, u7t_i, u2_r, u2_i, phi, lds):
    """The chain from |0…0⟩ -> (sr, si), each (N, 2^n).  The plain version
    of the forward kernel."""
    n = _check_layout(u7t_r, u2_r, phi, lds)
    nb, batch, dim = phi.shape
    sr = torch.zeros((batch, dim), dtype=torch.float32, device=phi.device)
    sr[:, 0] = 1.0
    si = torch.zeros_like(sr)
    off = _sub_offsets(lds)
    for b in range(nb):
        sr, si = _run_block(sr, si, u7t_r, u7t_i, u2_r, u2_i, phi[b],
                            off[b], lds[b], n)
    return sr, si


def chain_fused_backward(u7t_r, u7t_i, u2_r, u2_i, phi, lds, residuals,
                         gr, gi):
    """Reverse sweep of the chain, written out (no autograd): the output's
    cotangent (gr, gi) -> (u7bar_r, u7bar_i, u2bar_r, u2bar_i, phibar), the
    cotangents of u7t, u2 and phi, summed over the batch.  ``residuals`` =
    (states_r, states_i) from :func:`chain_fused_saved`.  The plain version
    of the backward kernel, with the algebra of pallas_fused._bwd_kernel:
    per block, recompute its stages from the saved input state, then walk
    back through the ring (the gather by its inverse), each high qubit's
    butterfly (u2bar[j, 2a+b] = Σ ct_a · conj(t_b), ct <- u^H ct), the low
    product (u7bar = conj(S_prelow)ᵀ·ct, ct <- ct·conj(u7t)ᵀ), the phase
    (phibar) and H, which is self-adjoint."""
    n = _check_layout(u7t_r, u2_r, phi, lds)
    states_r, states_i = residuals
    nb, batch, dim = phi.shape
    nh = n - LANE_QUBITS
    ring, ring_b = ring_apply(n), ring_adjoint_apply(n)
    off = _sub_offsets(lds)
    u7bar_r = torch.zeros_like(u7t_r)
    u7bar_i = torch.zeros_like(u7t_i)
    u2bar_r = torch.zeros_like(u2_r)
    u2bar_i = torch.zeros_like(u2_i)
    phibar = torch.empty_like(phi)
    ctr, cti = gr, gi
    for b in range(nb - 1, -1, -1):
        s0, ld = off[b], lds[b]
        ar, ai = _wht(states_r[b], states_i[b], n)          # pre-diagonal
        pr, pi = torch.cos(phi[b]), -torch.sin(phi[b])
        sr, si = pr * ar - pi * ai, pr * ai + pi * ar
        stages = []
        for s in range(s0, s0 + ld):
            pre = (sr, si)
            sr, si = _low(sr, si, u7t_r[s], u7t_i[s])
            bst = []
            for j in range(nh):
                bst.append((sr, si))
                sr, si = _bfly(sr, si, LANE_QUBITS + j, u2_r[s, j],
                               u2_i[s, j])
            sr, si = ring(sr, si)
            stages.append((pre, bst))
        if ld == 0:
            ctr, cti = _wht(ctr, cti, n)
        for d in range(ld - 1, -1, -1):
            s = s0 + d
            (plr, pli), bst = stages[d]
            ctr, cti = ring_b(ctr, cti)
            for j in range(nh - 1, -1, -1):
                q = LANE_QUBITS + j
                tr, ti = bst[j]
                c = (_halves(ctr, q), _halves(cti, q))
                t = (_halves(tr, q), _halves(ti, q))
                for a in (0, 1):
                    for bb in (0, 1):
                        xr, xi = t[0][bb], t[1][bb]
                        yr, yi = c[0][a], c[1][a]
                        u2bar_r[s, j, 2 * a + bb] = (yr * xr + yi * xi).sum()
                        u2bar_i[s, j, 2 * a + bb] = (yi * xr - yr * xi).sum()
                ctr, cti = _bfly_adj(ctr, cti, q, u2_r[s, j], u2_i[s, j])
            cr, ci = ctr.reshape(-1, 128), cti.reshape(-1, 128)
            xr, xi = plr.reshape(-1, 128), pli.reshape(-1, 128)
            u7bar_r[s] = xr.T @ cr + xi.T @ ci
            u7bar_i[s] = xr.T @ ci - xi.T @ cr
            ctr, cti = _low(ctr, cti, u7t_r[s].T, -u7t_i[s].T)
        dbr = ar * ctr + ai * cti
        dbi = -ai * ctr + ar * cti
        phibar[b] = dbr * pi - dbi * pr
        ctr, cti = pr * ctr + pi * cti, -pi * ctr + pr * cti
        ctr, cti = _wht(ctr, cti, n)
    return u7bar_r, u7bar_i, u2bar_r, u2bar_i, phibar
