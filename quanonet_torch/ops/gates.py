"""
Gate primitives and static circuit structures (counterpart of
quanonet_tpu/ops/gates.py).

Conventions (checkpoint-load-critical):

* little-endian: qubit ``i`` <-> bit ``i`` of the basis index ``k``;
* rotations use e^{-i θ P / 2}:
    RY(θ) = [[cos θ/2, -sin θ/2], [sin θ/2, cos θ/2]]
    RZ(θ) = diag(e^{-iθ/2}, e^{+iθ/2})
* CNOT ring applies control=(i+1)%n -> target=i sequentially for
  i = 0..n-1.

The tables are NumPy (host constants); the engine carries split
(re, im) float32 pairs, as the JAX package does.
"""
from functools import lru_cache

import numpy as np
import torch


class _PermGather(torch.autograd.Function):
    """out = (sr, si) gathered by ``idx`` along ``axis``.  A permutation's
    transpose is its inverse, so the backward is the gather by ``inv``
    (autograd's own backward of ``index_select`` would scatter-add into
    zeros, which gives the same bits with a memset and a scatter)."""

    @staticmethod
    def forward(ctx, sr, si, idx, inv, axis):
        ctx.inv, ctx.axis = inv, axis
        return sr.index_select(axis, idx), si.index_select(axis, idx)

    @staticmethod
    def backward(ctx, gr, gi):
        return (gr.index_select(ctx.axis, ctx.inv),
                gi.index_select(ctx.axis, ctx.inv), None, None, None)


def make_perm_apply(perm: np.ndarray, axis: int = -1):
    """Permutation gather along ``axis`` on the (re, im) pair:
    out[..., k, ...] = s[..., perm[k], ...], differentiable with the gather
    by the inverse permutation as its backward.  The index tensors are
    copied to each device once, on first use there."""
    idx = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(idx.size, dtype=np.int64)
    on_device = {}

    def apply(sr, si):
        pair = on_device.get(sr.device)
        if pair is None:
            pair = (torch.as_tensor(idx, device=sr.device),
                    torch.as_tensor(inv, device=sr.device))
            on_device[sr.device] = pair
        return _PermGather.apply(sr, si, *pair, axis)

    return apply


@lru_cache(maxsize=None)
def ring_apply(n_qubits: int, axis: int = -1):
    """The CNOT ring on the register (or on the rows of an operator with
    ``axis=-2``): the gather by :func:`cnot_ring_inverse_permutation`."""
    return make_perm_apply(cnot_ring_inverse_permutation(n_qubits), axis)


@lru_cache(maxsize=None)
def ring_adjoint_apply(n_qubits: int):
    """The ring's transpose, which is its inverse: the gather by
    :func:`cnot_ring_permutation`."""
    return make_perm_apply(cnot_ring_permutation(n_qubits))


def ry_matrix(theta):
    """RY(θ) 2x2 (real). theta: any shape -> (..., 2, 2)."""
    c = torch.cos(theta / 2.0)
    s = torch.sin(theta / 2.0)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


@lru_cache(maxsize=None)
def bit_table(n_qubits: int) -> np.ndarray:
    """bits[k, i] = bit i of k.  Shape (2^n, n), int32."""
    k = np.arange(2 ** n_qubits, dtype=np.int64)
    return ((k[:, None] >> np.arange(n_qubits)[None, :]) & 1).astype(np.int32)


@lru_cache(maxsize=None)
def z_signs(n_qubits: int) -> np.ndarray:
    """signs[k, i] = (-1)^{bit_i(k)} = <k|Z_i|k>.  Shape (2^n, n), float32."""
    return (1.0 - 2.0 * bit_table(n_qubits)).astype(np.float32)


@lru_cache(maxsize=None)
def cnot_ring_permutation(n_qubits: int) -> np.ndarray:
    """Composite permutation of the CNOT ring: (R ψ)[perm[k]] = ψ[k].
    Identity for n_qubits == 1 (a single qubit has no ring)."""
    dim = 2 ** n_qubits
    k = np.arange(dim, dtype=np.int64)
    if n_qubits > 1:
        for i in range(n_qubits):
            c = (i + 1) % n_qubits
            k = k ^ (((k >> c) & 1) << i)
    return k.astype(np.int32)


@lru_cache(maxsize=None)
def cnot_ring_inverse_permutation(n_qubits: int) -> np.ndarray:
    """inv[i] = j such that perm[j] = i, i.e. (R M)[i, :] = M[inv[i], :]."""
    perm = cnot_ring_permutation(n_qubits)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv


@lru_cache(maxsize=None)
def hadamard_kron(n_qubits: int) -> np.ndarray:
    """H^{⊗n}: [i, j] = (-1)^{popcount(i & j)} / sqrt(2^n), float32.
    Rewrites the RX encoding layer as a diagonal: ⊗RX(x) = H·⊗RZ(x)·H."""
    bits = bit_table(n_qubits)
    par = (bits[:, None, :] & bits[None, :, :]).sum(-1) & 1
    return ((1.0 - 2.0 * par) / np.sqrt(2 ** n_qubits)).astype(np.float32)


def _kron2(a, b):
    """Kronecker product of the last two axes, batched over the leading
    ones: (..., p, p) x (..., q, q) -> (..., p·q, p·q)."""
    p, q = a.shape[-1], b.shape[-1]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(*out.shape[:-4], p * q, p * q)


def kron_chain(mats):
    """Full-register operator from per-qubit 2x2s.

    mats: (..., n, 2, 2) with mats[..., i, :, :] acting on qubit i.  With
    little-endian indexing the register operator is
    kron(m_{n-1}, ..., m_1, m_0).
    """
    n = mats.shape[-3]
    u = mats[..., n - 1, :, :]
    for q in range(n - 2, -1, -1):
        u = _kron2(u, mats[..., q, :, :])
    return u


# ── the bf16 operand modes ────────────────────────────────────────────────────

def round_bf16(x):
    """x rounded to bf16 (to nearest even, as ``astype(jnp.bfloat16)``) and
    back to fp32: the operand rounding of the opt-in bf16 modes."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_dot(a, b):
    """a @ b on bf16-rounded operands, summed in fp32 (each product of two
    bf16 values is exact in fp32): the JAX package's bf16 ``_dot``."""
    return round_bf16(a) @ round_bf16(b)


def kara_bf16(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi) as three :func:`bf16_dot` products: t1 =
    ar·br, t2 = ai·bi, t3 = (ar + ai)·(br + bi), the sums formed in fp32
    before their rounding; -> (t1 - t2, t3 - t1 - t2)."""
    t1 = bf16_dot(ar, br)
    t2 = bf16_dot(ai, bi)
    t3 = bf16_dot(ar + ai, br + bi)
    return t1 - t2, t3 - t1 - t2
