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


def resolve_ham_diag(num_qubits, ham_bound=None, ham_diag=None) -> np.ndarray:
    """Config -> diagonal vector: ham_diag overrides ham_bound."""
    if ham_diag is not None:
        return ham_diag_full(ham_diag, num_qubits)
    if ham_bound is None:
        ham_bound = [-5.0, 5.0]
    return simple_ham_diag(num_qubits, ham_bound[0], ham_bound[1])
