"""
The port's flagship entry (quanonet_torch/entry.py) on the CPU against the
repository's ``__graft_entry__.entry()``: the same inputs (NumPy seed 0,
batch 8), and with the JAX parameters carried across through
``convert.state_dict_from_flax`` the same forward to 1e-5 (fp32 chains of
60 blocks, other order).  On the CPU no kernel is launched.
"""
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from quanonet_torch.convert import state_dict_from_flax
from quanonet_torch.entry import entry
from quanonet_torch.profile_step import launches_of

TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Torch on one thread here: these runs are many small ops, whose
    thread-pool barriers stall when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_entry():
    """entry()'s output, inputs and the parameters its forward closes
    over."""
    fn, (branch, trunk) = graft.entry()
    params = dict(zip(fn.__code__.co_freevars,
                      (c.cell_contents for c in fn.__closure__)))['params']
    return (np.asarray(fn(branch, trunk)), np.asarray(branch),
            np.asarray(trunk), params)


def test_inputs_are_jax_entry(jax_entry):
    _, branch, trunk, _ = jax_entry
    fn, (b, t) = entry(device='cpu')
    assert b.shape == (8, 100) and t.shape == (8, 2)
    assert b.dtype == t.dtype == torch.float32
    np.testing.assert_array_equal(b.numpy(), branch)
    np.testing.assert_array_equal(t.numpy(), trunk)


def test_forward_matches_jax_entry(jax_entry):
    want, _, _, params = jax_entry
    fn, (b, t) = entry(device='cpu')
    fn.model.load_state_dict(state_dict_from_flax(params))
    before = launches_of('hea_chain_fwd', 'ucomp_fwd')
    got = fn(b, t)
    assert got.shape == (8, 1) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert launches_of('hea_chain_fwd', 'ucomp_fwd') == before


def test_own_parameters_replay():
    """Parameters from a torch generator seeded 0: two entries agree bit
    for bit, and their outputs are finite and inside the Hamiltonian's
    bounds (±5)."""
    fn, args = entry(device='cpu')
    fn2, args2 = entry(device='cpu')
    out = fn(*args)
    assert torch.equal(out, fn2(*args2))
    assert torch.isfinite(out).all() and out.abs().max() <= 5.0
