"""
Hamiltonian constructors (counterpart of quanonet_tpu/ops/hamiltonian.py).

Every Z-basis Hamiltonian the framework supports is diagonal in the
computational basis, so it is carried as its diagonal d with
⟨H⟩ = Σ_k |ψ_k|² d_k.  X/Y-basis observables are parameterised by
(offset, coeff) and measured by the engine's Pauli-sum path.
"""
from functools import lru_cache

import numpy as np

from quanonet_torch.ops.gates import z_signs


def simple_ham_params(num_qubits, lower_bound=None, upper_bound=None):
    """(offset, coeff_per_qubit) of H = offset·I + c·Σ_i P_i:
    offset = lb + (ub-lb)/2, c = (ub-lb)/2/n; default bounds (-n, n)."""
    if lower_bound is None:
        lower_bound = -num_qubits
    if upper_bound is None:
        upper_bound = num_qubits
    coff = upper_bound - lower_bound
    offset = lower_bound + coff / 2.0
    coeff = coff / 2.0 / num_qubits
    return float(offset), float(coeff)


@lru_cache(maxsize=None)
def _zsum(num_qubits: int) -> np.ndarray:
    """Σ_i <k|Z_i|k> per basis state, shape (2^n,)."""
    return z_signs(num_qubits).sum(axis=1).astype(np.float32)


def simple_ham_diag(num_qubits, lower_bound=None, upper_bound=None) -> np.ndarray:
    """Diagonal of offset·I + c·Σ_i Z_i, shape (2^n,) float32."""
    offset, coeff = simple_ham_params(num_qubits, lower_bound, upper_bound)
    return (offset + coeff * _zsum(num_qubits)).astype(np.float32)


def ham_diag_full(diag_elements, num_qubits) -> np.ndarray:
    """Explicit diagonal Hamiltonian (the --ham_diag flag)."""
    d = np.asarray(diag_elements, dtype=np.float32)
    if d.size != 2 ** num_qubits:
        raise ValueError(
            f"ham_diag has {d.size} entries; expected 2^{num_qubits} = "
            f"{2 ** num_qubits}")
    return d


def zero_state_ham_diag(num_qubits, lower_bound=0.0,
                        upper_bound=1.0) -> np.ndarray:
    """Diagonal of lb·I + (ub-lb)·|0…0⟩⟨0…0| (the reference's
    zero_state_hamiltonian: the sum over all {I,Z}^n strings with weight
    (ub-lb)/2^n collapses to the |0…0⟩ projector)."""
    d = np.full(2 ** num_qubits, float(lower_bound), dtype=np.float32)
    d[0] += float(upper_bound - lower_bound)
    return d


def walsh_hadamard_coeffs(diag_elements, num_qubits) -> np.ndarray:
    """Pauli-Z-string coefficients of a diagonal H (Walsh–Hadamard
    transform, the reference's quantum_circuits_ms.py:41-63): coeffs[idx]
    multiplies the Z-string whose qubit set is the bit pattern of idx.
    Used by the QPU export (quanonet_torch/ibm_export.py)."""
    n = num_qubits
    d = np.asarray(diag_elements, dtype=np.float64)
    dim = 2 ** n
    i = np.arange(dim)[:, None]
    j = np.arange(dim)[None, :]
    popcount = np.vectorize(lambda x: bin(x).count('1'))(i & j)
    had = (-1.0) ** popcount
    return (had @ d) / dim


def generate_ham_diag_rank1(num_qubits, seed=None) -> np.ndarray:
    """Rank-1 spectrum: one random position set to 5, the rest -5 (the
    reference's one-hot * 10 - 5)."""
    length = 2 ** num_qubits
    rng = np.random.RandomState(seed) if seed is not None else np.random
    arr = np.zeros(length)
    idx = rng.choice(length, 1, replace=False)
    arr[idx[0]] = 1
    return arr * 10 - 5


def generate_ham_spectrum_uniform(num_qubits, rank, seed=None) -> np.ndarray:
    """Uniform eigenspectrum: ``rank`` values evenly spaced in [-5, 5] at
    random positions, zeros elsewhere (an even rank avoids a zero
    eigenvalue)."""
    length = 2 ** num_qubits
    if rank > length:
        raise ValueError(
            f"Rank ({rank}) cannot be greater than Hilbert space "
            f"dimension ({length}).")
    if rank % 2 != 0:
        print(f"Warning: Rank {rank} is odd. 0.0 might be included in the "
              f"spectrum, reducing the effective rank.")
    rng = np.random.RandomState(seed) if seed is not None else np.random
    arr = np.zeros(length)
    idx = rng.choice(length, rank, replace=False)
    arr[idx] = np.linspace(-5, 5, rank)
    return arr


def resolve_ham_diag(num_qubits, ham_bound=None, ham_diag=None) -> np.ndarray:
    """Config -> diagonal vector: ham_diag overrides ham_bound."""
    if ham_diag is not None:
        return ham_diag_full(ham_diag, num_qubits)
    if ham_bound is None:
        ham_bound = [-5.0, 5.0]
    return simple_ham_diag(num_qubits, ham_bound[0], ham_bound[1])
