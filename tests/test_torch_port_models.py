"""
The port's models, checkpoint reader and weight conversion
(quanonet_torch/models, checkpoint.py, convert.py), held against the JAX
package: a seeded flax init carried across gives the same outputs, the
reference checkpoint keys round-trip, and the reader gives byte-equal
arrays for every shipped checkpoint.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_tpu import checkpoint as j_ckpt
from quanonet_tpu.models import HEAQNN as JHEAQNN
from quanonet_tpu.models import QuanONet as JQuanONet
from quanonet_torch import checkpoint as t_ckpt
from quanonet_torch.convert import (
    flax_from_state_dict, raw_from_state_dict, state_dict_from_flax,
    state_dict_from_raw,
)
from quanonet_torch.models import HEAQNN, QuanONet, tile_to

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP_TOL = 1e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(if_trainable_freq=False),
    dict(ham_pauli='X', ham_bound=(-2.0, 3.0)),
    dict(ham_diag=tuple(np.linspace(-1, 1, 8).tolist())),
])
def test_quanonet_from_flax_init_matches_jax(kw):
    cfg = dict(num_qubits=3, branch_input_size=6, trunk_input_size=2,
               net_size=(3, 2, 2, 1), scale_coeff=0.3, **kw)
    rng = np.random.RandomState(4)
    b = rng.randn(5, 6).astype(np.float32)
    t = rng.rand(5, 2).astype(np.float32)
    jm = JQuanONet(**cfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(b), jnp.asarray(t))
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)  # bias != 0
    want = np.asarray(jm.apply(params, jnp.asarray(b), jnp.asarray(t)))

    model = QuanONet(**cfg, device='cpu')
    model.load_state_dict(state_dict_from_flax(_np_tree(params)))
    with torch.no_grad():
        got = model(torch.tensor(b), torch.tensor(t)).numpy()
    assert got.shape == want.shape == (5, 1)
    np.testing.assert_allclose(got, want, atol=EXP_TOL)


def test_heaqnn_from_flax_init_matches_jax():
    cfg = dict(num_qubits=3, input_size=5, net_size=(3, 2), scale_coeff=0.2)
    x = np.random.RandomState(6).randn(4, 5).astype(np.float32)
    jm = JHEAQNN(**cfg)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    model = HEAQNN(**cfg, device='cpu')
    assert set(model.state_dict()) == {'ansatz', 'freq.weights', 'freq.bias'}
    model.load_state_dict(state_dict_from_flax(_np_tree(params)))
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=EXP_TOL)


@pytest.mark.parametrize("model_type", ['QuanONet', 'HEAQNN'])
def test_raw_keys_round_trip(model_type):
    if model_type == 'QuanONet':
        jm = JQuanONet(num_qubits=2, branch_input_size=4, trunk_input_size=1,
                       net_size=(2, 1, 3, 2))
        args = (jnp.zeros((1, 4)), jnp.zeros((1, 1)))
        net = (2, 1, 3, 2)
    else:
        jm = JHEAQNN(num_qubits=2, input_size=4, net_size=(3, 2))
        args = (jnp.zeros((1, 4)),)
        net = (3, 2)
    tree = _np_tree(jm.init(jax.random.PRNGKey(3), *args))
    sd = state_dict_from_flax(tree)
    raw = raw_from_state_dict(sd, model_type)
    want_raw = j_ckpt.quantum_params_to_raw(tree, model_type)
    assert set(raw) == set(want_raw)
    for k in raw:
        np.testing.assert_array_equal(raw[k], want_raw[k], err_msg=k)
    sd2 = state_dict_from_raw(raw, model_type, net, 2, True)
    assert set(sd2) == set(sd)
    for k in sd:
        assert torch.equal(sd2[k], sd[k]), k
    back = flax_from_state_dict(sd)['params']
    for k, v in tree['params'].items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(back[k][kk], v[kk])
        else:
            np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, 'pretrained_weights', '*', '*', 'best_model.*'))))
def test_reader_byte_equal_to_jax(path):
    want = j_ckpt.load_raw(path)
    got = t_ckpt.load_raw(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_four_shipped_checkpoints_found():
    assert len(glob.glob(os.path.join(
        REPO, 'pretrained_weights', '*', '*', 'best_model.*'))) == 4


def test_advection_anchor_shapes():
    raw = t_ckpt.load_raw(os.path.join(
        REPO, 'pretrained_weights/Advection/'
        'Advection_QuanONet_Net40-2-20-2_Q5_TF_S0.1_1000x100_Seed0/'
        'best_model.ckpt'))
    sd = state_dict_from_raw(raw, 'QuanONet', (40, 2, 20, 2), 5, True)
    assert tuple(sd['ansatz'].shape) == (120, 3, 5)
    assert tuple(sd['branch_freq.weights'].shape) == (200,)
    assert tuple(sd['trunk_freq.bias'].shape) == (100,)
    assert tuple(sd['bias'].shape) == ()
    with pytest.raises(ValueError, match='1800 elements'):
        state_dict_from_raw(raw, 'QuanONet', (40, 2, 20, 1), 5, True)


def test_seeded_init_and_layers():
    kw = dict(num_qubits=2, branch_input_size=3, trunk_input_size=1,
              net_size=(2, 1, 2, 1), device='cpu')
    a = QuanONet(**kw, generator=torch.Generator().manual_seed(0))
    b = QuanONet(**kw, generator=torch.Generator().manual_seed(0))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert torch.all(a.branch_freq.weights == 0.01)
    assert a.branch_freq.bias.abs().max() <= np.pi
    assert a.bias.item() == 0.0
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert tile_to(x, 7).tolist() == [[0, 1, 2, 0, 1, 2, 0],
                                      [3, 4, 5, 3, 4, 5, 3]]


@pytest.mark.parametrize("flag", [
    dict(shots=100), dict(grad_method='shift'), dict(noise_p=0.01),
    dict(readout_p=0.02), dict(noise_p=0.01, zne_scales=(1.0, 2.0)),
    dict(damp_gamma=0.1), dict(dephase_p=0.1)])
def test_qpu_flags_build_and_run(flag):
    """shots, the shift rule and the noise, ZNE and T1/T2 channels, which
    raised until they were ported, now build a model that runs forward and
    backward."""
    model = QuanONet(2, 3, 1, (2, 1, 2, 1), device='cpu', **flag,
                     generator=torch.Generator().manual_seed(0))
    kw = ({'generator': torch.Generator().manual_seed(1)}
          if model.sampled else {})
    out = model(torch.rand(4, 3), torch.rand(4, 1), **kw)
    assert out.shape == (4, 1) and torch.isfinite(out).all()
    out.sum().backward()
    assert torch.isfinite(model.bias.grad)
