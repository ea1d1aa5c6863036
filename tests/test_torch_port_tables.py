"""The port's static tables (quanonet_torch/ops/gates.py, hamiltonian.py)
equal the JAX package's for n = 1..7, and its torch gate helpers agree with
the JAX ones."""
import numpy as np
import pytest
import torch

from quanonet_tpu.ops import gates as j_gates
from quanonet_tpu.ops import hamiltonian as j_ham
from quanonet_torch.ops import gates as t_gates
from quanonet_torch.ops import hamiltonian as t_ham


@pytest.mark.parametrize("n", range(1, 8))
def test_tables_equal_jax(n):
    for name in ('bit_table', 'z_signs', 'cnot_ring_permutation',
                 'cnot_ring_inverse_permutation', 'hadamard_kron'):
        want = getattr(j_gates, name)(n)
        got = getattr(t_gates, name)(n)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(t_ham.simple_ham_diag(n),
                                  j_ham.simple_ham_diag(n))
    np.testing.assert_array_equal(t_ham.simple_ham_diag(n, -5, 5),
                                  j_ham.simple_ham_diag(n, -5, 5))
    assert t_ham.simple_ham_params(n, -3, 7) == j_ham.simple_ham_params(n, -3, 7)
    np.testing.assert_array_equal(t_ham.resolve_ham_diag(n, [-2.0, 4.0]),
                                  j_ham.resolve_ham_diag(n, [-2.0, 4.0]))


def test_ham_diag_full_checks_length():
    d = np.arange(8, dtype=np.float32)
    np.testing.assert_array_equal(t_ham.resolve_ham_diag(3, ham_diag=d), d)
    with pytest.raises(ValueError, match='2\\^3'):
        t_ham.ham_diag_full(np.zeros(5), 3)


def test_ry_and_kron_chain_match_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    th = rng.uniform(-np.pi, np.pi, (4, 3)).astype(np.float32)
    got = t_gates.kron_chain(t_gates.ry_matrix(torch.tensor(th)))
    for s in range(4):
        want = j_gates.kron_chain(j_gates.ry_matrix(jnp.asarray(th[s])))
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want),
                                   atol=1e-6)


def test_perm_apply_is_the_ring_gather():
    n = 4
    rng = np.random.RandomState(1)
    sr = rng.randn(3, 16).astype(np.float32)
    si = rng.randn(3, 16).astype(np.float32)
    inv = t_gates.cnot_ring_inverse_permutation(n)
    gr, gi = t_gates.make_perm_apply(inv)(torch.tensor(sr), torch.tensor(si))
    np.testing.assert_array_equal(gr.numpy(), sr[:, inv])
    np.testing.assert_array_equal(gi.numpy(), si[:, inv])
