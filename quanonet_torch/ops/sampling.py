"""
Finite-shot measurement sampling: what a real QPU returns (counterpart of
quanonet_tpu/ops/sampling.py).

* :func:`sample_counts`: multinomial basis-state counts per input row, as
  a chain of binomials down a binary tree of the basis states (n levels,
  O(2^n) work a row, independent of ``shots``; no per-shot memory);
* :func:`sample_indices`: raw measurement outcomes (the SamplerV2
  analogue), inverse-CDF draws, little-endian qubit <-> bit convention
  (ops/gates.py);
* :func:`shot_expectation`: the shot-estimated ⟨H⟩ for every observable
  the models measure: diagonal / Z directly, Σ X_i and Σ Y_i through an
  in-place rotation to the measurement basis (X = H Z H, Y = S H Z H S†),
  as hardware measures them;
* :func:`shot_noise_std`: the analytic standard error of the estimator,
  sqrt((⟨H²⟩ − ⟨H⟩²) / shots).

The state comes from :func:`quanonet_torch.ops.hea.hea_forward_pair`, so
on ``cuda`` from the chain kernels.  Everything is float32 split-real.
Randomness flows through explicit ``torch.Generator`` objects; where the
JAX package folds an index into a key, :func:`fold_in` derives a new
generator from (the generator's seed, index), so sampled runs replay bit
for bit and a draw does not depend on how the work around it is chunked.
"""
import numpy as np
import torch

from quanonet_torch.ops.gates import bit_table, z_signs
from quanonet_torch.ops.hea import HEASpec, hea_forward_pair

_MASK64 = (1 << 64) - 1


def derive_seed(seed, *path):
    """A 63-bit seed from ``seed`` and the integers ``path`` (splitmix64
    over each step): the counterpart of ``jax.random.fold_in``."""
    z = int(seed) & _MASK64
    for i in path:
        z = (z + 0x9E3779B97F4A7C15 * (int(i) + 1)) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def key_generator(seed, *path, device='cpu'):
    """A ``torch.Generator`` on ``device`` seeded from
    ``derive_seed(seed, *path)``."""
    return torch.Generator(device=device).manual_seed(
        derive_seed(seed, *path))


def fold_in(generator, i):
    """A new generator on ``generator``'s device, seeded from its initial
    seed and ``i``; ``generator``'s own state is not read or advanced."""
    return key_generator(generator.initial_seed(), i,
                         device=generator.device)


def probs_pair(sr, si):
    """Measurement probabilities |ψ_k|², renormalized against float32
    norm drift over deep circuits.  (batch, 2^n) -> (batch, 2^n)."""
    p = sr * sr + si * si
    return p / p.sum(-1, keepdim=True)


def _apply_h_all(sr, si, n_qubits):
    """H on every qubit: a real butterfly per qubit, O(n·2^n)."""
    batch = sr.shape[0]
    inv_sqrt2 = float(np.float32(1.0 / np.sqrt(2.0)))

    def h(a, q):
        a = a.reshape(batch, 2 ** (n_qubits - 1 - q), 2, 2 ** q)
        a0, a1 = a[:, :, 0, :], a[:, :, 1, :]
        return torch.stack([(a0 + a1) * inv_sqrt2, (a0 - a1) * inv_sqrt2],
                           dim=2).reshape(batch, -1)

    for q in range(n_qubits):
        sr, si = h(sr, q), h(si, q)
    return sr, si


def _apply_sdg_all(sr, si, n_qubits):
    """S† on every qubit: ψ_k *= (−i)^{popcount(k)}, one diagonal
    multiply."""
    pc = bit_table(n_qubits).sum(axis=1) % 4
    fr = torch.as_tensor(np.cos(-0.5 * np.pi * pc).astype(np.float32),
                         device=sr.device)
    fi = torch.as_tensor(np.sin(-0.5 * np.pi * pc).astype(np.float32),
                         device=sr.device)
    return sr * fr - si * fi, sr * fi + si * fr


def rotate_to_pauli_basis(sr, si, pauli, n_qubits):
    """Rotate the state so that a computational-basis measurement realizes
    the X/Y observable: X = H Z H (H^⊗n), Y = S H Z H S† (H^⊗n·S†^⊗n).
    The state is returned unchanged for pauli='Z'."""
    if pauli == 'Z':
        return sr, si
    if pauli == 'Y':
        sr, si = _apply_sdg_all(sr, si, n_qubits)
    elif pauli != 'X':
        raise ValueError(f"pauli must be X, Y or Z, got {pauli}")
    return _apply_h_all(sr, si, n_qubits)


def sample_counts(generator, probs, shots):
    """Multinomial counts per row: (batch, 2^n) float32 summing to
    ``shots``.  A binomial chain down the binary tree of the basis states:
    at each of the n levels every node's count splits between its halves
    by one ``torch.binomial`` draw over the node's remaining mass."""
    probs = probs.detach()
    batch, dim = probs.shape
    masses = [probs]                       # masses[l]: (batch, 2^(n-l))
    while masses[-1].shape[1] > 1:
        masses.append(masses[-1].reshape(batch, -1, 2).sum(-1))
    counts = torch.full((batch, 1), float(shots), dtype=probs.dtype,
                        device=probs.device)
    for m in reversed(masses[:-1]):        # children of the nodes of counts
        left, right = m[:, 0::2], m[:, 1::2]
        total = left + right
        q = torch.where(total > 0, left / torch.where(total > 0, total, 1.0),
                        torch.zeros_like(total)).clamp_(0.0, 1.0)
        cl = torch.binomial(counts, q, generator=generator)
        counts = torch.stack([cl, counts - cl], dim=-1).reshape(batch, -1)
    return counts


def sample_indices(generator, probs, shots):
    """``shots`` raw outcomes per row, (batch, shots) int32 basis-state
    indices (qubit i <-> bit i).  Inverse-CDF draws: O(shots·log 2^n) a
    row."""
    dim = probs.shape[-1]
    cdf = torch.cumsum(probs.detach(), dim=-1).contiguous()
    u = torch.rand((probs.shape[0], shots), generator=generator,
                   dtype=probs.dtype, device=probs.device)
    idx = torch.searchsorted(cdf, u, right=True)
    return idx.clamp_(0, dim - 1).to(torch.int32)


def indices_to_bits(idx, n_qubits):
    """Basis-state indices -> bitstrings, (..., n_qubits) int32 with
    bits[..., i] the measured value of qubit i (little-endian)."""
    shifts = torch.arange(n_qubits, dtype=torch.int32, device=idx.device)
    return (idx.to(torch.int32)[..., None] >> shifts) & 1


def shot_expectation_pair(generator, sr, si, diag, shots):
    """Shot-estimated ⟨H⟩ for diagonal H from a split-real state, (batch,
    1) float32.  Unbiased: E[est] = Σ_k p_k d_k."""
    counts = sample_counts(generator, probs_pair(sr, si), shots)
    d = torch.as_tensor(diag, dtype=counts.dtype, device=counts.device)
    return ((counts * d).sum(-1) / shots)[:, None]


def shot_noise_std(sr, si, diag, shots):
    """Analytic standard error of the ``shots``-shot estimator,
    sqrt((⟨H²⟩ − ⟨H⟩²) / shots), (batch, 1) float32: what a QPU shot
    budget buys."""
    p = probs_pair(sr, si)
    d = torch.as_tensor(diag, dtype=p.dtype, device=p.device)
    e1 = (p * d).sum(-1)
    e2 = (p * (d * d)).sum(-1)
    return torch.sqrt(torch.clamp(e2 - e1 * e1, min=0.0) / shots)[:, None]


def _pauli_sum_diag(n_qubits, offset, coeff):
    """Diagonal of offset + coeff·Σ_i Z_i in the (rotated) measurement
    basis; after :func:`rotate_to_pauli_basis` it realizes Σ X_i / Σ Y_i."""
    zsum = z_signs(n_qubits).sum(axis=1).astype(np.float32)
    return (offset + coeff * zsum).astype(np.float32)


def measurement_diag(n_qubits, pauli, diag, offset, coeff):
    """The diagonal that a sampled measurement reads after the basis
    rotation: ``diag`` for Z, :func:`_pauli_sum_diag` for X and Y."""
    if pauli == 'Z':
        if diag is None:
            raise ValueError("Z-basis sampling requires a diagonal")
        return diag
    return _pauli_sum_diag(n_qubits, offset, coeff)


def shot_expectation(generator, spec: HEASpec, weights, x, shots, diag=None,
                     pauli='Z', offset=0.0, coeff=0.0, engine='auto'):
    """Full circuit + finite-shot measurement, (batch, 1) float32: the
    sampled analogue of :func:`quanonet_torch.ops.hea.hea_expectation`
    with (generator, shots) in front.  For pauli='X'/'Y' the state is
    rotated to the measurement basis, where the Σ P_i observable is
    diagonal."""
    d = measurement_diag(spec.n_qubits, pauli, diag, offset, coeff)
    sr, si = hea_forward_pair(spec, weights, x, engine=engine)
    sr, si = rotate_to_pauli_basis(sr, si, pauli, spec.n_qubits)
    return shot_expectation_pair(generator, sr, si, d, shots)
