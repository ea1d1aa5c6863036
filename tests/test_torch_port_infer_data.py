"""
The infer CLI's own test data (quanonet_torch/infer.py
generate_test_data): without --data or --branch the port generates the
test set the checkpoint directory's name describes, as the JAX package's
infer CLI does (quanonet_tpu/infer.py:416-452), from its own host
DataManager.

Under one NumPy seed the arrays are byte-equal to those the JAX CLI
generates; the shipped Antideriv anchor is scored from its name alone,
its predictions within 1e-4 of the JAX package's on the same rows (fp32
chains in another order; outputs of order 1).
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from quanonet_tpu import infer as j_infer
from quanonet_tpu.data import manager as j_manager
from quanonet_torch import infer as t_infer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANTIDERIV = os.path.join(
    REPO, 'pretrained_weights/Antideriv/'
    'Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_1000x100_Seed0/'
    'best_model.npz')


@pytest.fixture(scope='module')
def port_cwd(tmp_path_factory):
    """A directory whose ./data holds the port's Antideriv test set,
    generated with its raw solutions from the anchor's name (NumPy seed
    0): generated once for the module."""
    cwd = tmp_path_factory.mktemp('port')
    here = os.getcwd()
    os.chdir(cwd)
    try:
        np.random.seed(0)
        arrays = t_infer.generate_test_data(ANTIDERIV)
    finally:
        os.chdir(here)
    return cwd, arrays


def test_generated_arrays_equal_the_jax_clis(port_cwd, tmp_path,
                                             monkeypatch):
    """Both CLIs build the test set from the anchor's name under NumPy
    seed 0, each in its own directory holding the same raw solutions (the
    raw cache, shared between the packages and held byte-equal by
    tests/test_torch_port_data.py): the arrays are byte-equal."""
    cwd, _ = port_cwd
    raw = os.path.join('data', 'Antideriv_Operator_data')
    for side in ('port', 'jax'):
        shutil.copytree(cwd / raw, tmp_path / side / raw)
    monkeypatch.chdir(tmp_path / 'port')
    np.random.seed(0)
    branch, trunk, y_true = t_infer.generate_test_data(ANTIDERIV)

    captured = {}
    orig = j_manager.DataManager.get_data

    def get_data(self):
        captured.update(orig(self))
        return captured

    monkeypatch.setattr(j_manager.DataManager, 'get_data', get_data)
    # the JAX CLI's scoring is not under test here
    monkeypatch.setattr(j_infer, 'predict',
                        lambda model, params, b, *a, **k:
                        np.zeros((b.shape[0], 1), np.float32))
    monkeypatch.chdir(tmp_path / 'jax')
    np.random.seed(0)
    j_infer.main(['--ckpt', ANTIDERIV])
    assert branch.shape == (100000, 10) and trunk.shape == (100000, 1)
    for got, key in ((branch, 'test_branch_input'),
                     (trunk, 'test_trunk_input'), (y_true, 'test_output')):
        want = captured[key]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), key


def test_anchor_scored_from_its_name_alone(port_cwd, tmp_path, monkeypatch):
    cwd, (branch, trunk, y_true) = port_cwd
    monkeypatch.chdir(cwd)                 # the generated cache is here
    out = tmp_path / 'scored.npz'
    preds = t_infer.main(['--ckpt', ANTIDERIV, '--device', 'cpu',
                          '--output', str(out)])
    with np.load(out) as z:
        rel = float(z['rel_l2'])
    assert rel == pytest.approx(t_infer.evaluate(preds, y_true)['rel_l2'])
    assert rel < 0.2                       # the anchor's quality (~0.12)
    model, params, cfg = j_infer.load_model(ANTIDERIV, 10, 1)
    rows = slice(0, 2000)
    want = np.asarray(model.apply(params, jnp.asarray(branch[rows]),
                                  jnp.asarray(trunk[rows])))
    np.testing.assert_allclose(preds[rows], want, atol=1e-4)
    # --num_points_0 shapes the generated branch input
    again = t_infer.main(['--ckpt', ANTIDERIV, '--device', 'cpu',
                          '--num_points_0', '7', '--batch_size', '50000'])
    assert again.shape == (100000, 1) and np.isfinite(again).all()


@pytest.mark.parametrize("suffix,method", [('_Shift', 'shift'),
                                           ('_SpsaC0.1Sh256', 'spsa')])
def test_qpu_trained_checkpoint_names_load(tmp_path, suffix, method):
    """A _Shift / _Spsa checkpoint loads and predicts the ideal circuit:
    the gradient estimator is provenance, not a different model."""
    name = os.path.basename(os.path.dirname(ANTIDERIV))
    run = tmp_path / name.replace('_1000x100', suffix + '_1000x100')
    run.mkdir()
    shutil.copy(ANTIDERIV, run / 'best_model.npz')
    rng = np.random.RandomState(0)
    b = rng.rand(16, 10).astype(np.float32)
    t = rng.rand(16, 1).astype(np.float32)
    model, cfg = t_infer.load_model(str(run / 'best_model.npz'), 10, 1,
                                    device='cpu')
    ref, _ = t_infer.load_model(ANTIDERIV, 10, 1, device='cpu')
    assert cfg['grad_method'] == method
    assert model.shots is None and model.grad_method == 'autodiff'
    np.testing.assert_array_equal(t_infer.predict(model, b, t),
                                  t_infer.predict(ref, b, t))
    # with --shots the same checkpoint predicts from sampled shots
    shot_model, _ = t_infer.load_model(str(run / 'best_model.npz'), 10, 1,
                                       device='cpu', shots=2000)
    a1 = t_infer.predict(shot_model, b, t, shot_seed=4)
    a2 = t_infer.predict(shot_model, b, t, shot_seed=4)
    a3 = t_infer.predict(shot_model, b, t, shot_seed=5)
    np.testing.assert_array_equal(a1, a2)
    assert not np.array_equal(a1, a3)
    assert np.abs(a1 - t_infer.predict(ref, b, t)).max() < 0.5
