"""
Zero-noise extrapolation of the port (quanonet_torch/ops/mitigation.py)
and infer's zne_predict, held against the JAX package
(quanonet_tpu/ops/mitigation.py) on the CPU.

Tolerances: the Richardson weights exact (the same NumPy formula) with
the same ValueErrors; ZNE with injected (u, choice) 1e-5 against the
combination of JAX's ``_traj_forward`` at every scale; the fold route's
ZNE 1e-5 against the plain route's on the same draws; the statistical
cases with the JAX tests' limits and setups (tests/test_mitigation.py:
exact for an affine channel within 0.12, nearer the ideal than the noisy
value on the Q2 setups).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops import mitigation as j_mit
from quanonet_tpu.ops import noise as j_noise
from quanonet_tpu.ops.sampling import probs_pair
from quanonet_torch import infer as t_infer
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import hea as t_hea
from quanonet_torch.ops import mitigation as t_mit
from quanonet_torch.ops import noise as t_noise
from quanonet_torch.ops.hamiltonian import simple_ham_diag


def _gen(seed=11):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("scales", [(1.0, 2.0), (1.0, 2.0, 3.0),
                                    (1.0, 1.5, 2.0, 3.0), (2.0,)])
def test_richardson_weights_equal_jax(scales):
    w = t_mit.richardson_weights(scales)
    np.testing.assert_array_equal(w, j_mit.richardson_weights(scales))
    c = np.asarray(scales)
    assert abs(w.sum() - 1.0) < 1e-12
    for k in range(1, len(scales)):
        assert abs(np.sum(w * c ** k)) < 1e-9


@pytest.mark.parametrize("scales,match", [
    ((1.0, 1.0), 'distinct'), ((0.0, 1.0), 'positive'),
    ((-1.0, 2.0), 'positive'), ((), '1-D'), (((1.0, 2.0),), '1-D')])
def test_richardson_weights_raise_as_jax(scales, match):
    with pytest.raises(ValueError, match=match):
        j_mit.richardson_weights(scales)
    with pytest.raises(ValueError, match=match):
        t_mit.richardson_weights(scales)


@pytest.mark.parametrize("route", ['plain', 'fold'])
@pytest.mark.parametrize("scales", [(1.0, 2.0), (1.0, 2.0, 3.0)])
def test_zne_with_injected_draws_matches_jax(route, scales):
    """ZNE's combination for injected (u, choice) against JAX's
    _traj_forward at each scale's mask u < c·p, weighted as
    zne_expectation weights them; on both routes (the fold route's plain
    version on the CPU)."""
    n, net, rows, n_traj = 3, (2, 1, 2, 1), 4, 3
    spec, spec_j = t_hea.quanonet_spec(n, net), j_hea.quanonet_spec(n, net)
    rng = np.random.RandomState(6)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.randn(rows, spec.total_encode).astype(np.float32)
    diag = simple_ham_diag(n, -3, 3)
    p = np.array([0.2, 0.1, 0.3], np.float32)
    nb = spec.n_blocks
    u = rng.rand(n_traj, nb, n).astype(np.float32)
    choice = rng.randint(0, 3, (n_traj, nb, n))
    ur, ui = j_hea.compile_block_unitaries(spec_j, jnp.asarray(w))
    xb = jnp.asarray(x).reshape(rows, nb, n).transpose(1, 0, 2)
    wts = j_mit.richardson_weights(scales)
    want = np.zeros((n_traj, rows), np.float32)
    for t in range(n_traj):
        val = jnp.zeros((rows,), jnp.float32)
        for c, wi in zip(scales, wts):
            occur = jnp.asarray(u[t]) < jnp.float32(c) * jnp.asarray(p)
            a = occur & (jnp.asarray(choice[t]) != 2)
            b = occur & (jnp.asarray(choice[t]) != 0)
            sr, si = j_noise._traj_forward(spec_j, ur.transpose(0, 2, 1),
                                           ui.transpose(0, 2, 1), xb, a, b)
            val = val + jnp.float32(wi) * (probs_pair(sr, si)
                                           @ jnp.asarray(diag))
        want[t] = np.asarray(val)
    ops = t_noise._Operands(route, spec, torch.tensor(w), torch.tensor(x))
    got = t_mit.zne_values(ops, torch.tensor(u), torch.tensor(choice),
                           torch.tensor(p), scales, torch.tensor(diag))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_fold_route_zne_equals_plain_on_the_same_draws(monkeypatch):
    spec = t_hea.quanonet_spec(2, (2, 1, 2, 1))
    rng = np.random.RandomState(0)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32))
    x = torch.tensor(rng.randn(3, spec.total_encode).astype(np.float32))
    diag = simple_ham_diag(2, -3, 3)
    out = {}
    for route in ('plain', 'fold'):
        monkeypatch.setattr(t_mit, 'noise_route', lambda *a, r=route: r)
        before = t_noise.routes[route]
        out[route] = t_mit.zne_expectation(_gen(), spec, w, x, 0.1, 8,
                                           scales=(1.0, 2.0, 3.0), diag=diag,
                                           readout_p=0.02)
        assert t_noise.routes[route] == before + 1
    np.testing.assert_allclose(out['fold'].numpy(), out['plain'].numpy(),
                               atol=1e-5)


def test_zne_exact_for_affine_channel():
    """One noise site (a one-block spec, noise on qubit 0 only) and a Z_0
    observable: E(c·p) is affine in c, so 2-point ZNE recovers the ideal
    value up to trajectory noise (tests/test_mitigation.py's setup)."""
    spec = t_hea.heaqnn_spec(2, (1, 1))
    rng = np.random.RandomState(2)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32))
    x = torch.tensor(rng.randn(2, spec.total_encode).astype(np.float32))
    zdiag = np.array([1, -1, 1, -1], np.float32)
    p = np.array([0.15, 0.0], np.float32)
    ideal = t_hea.hea_expectation(spec, w, x, diag=zdiag,
                                  engine='dense').numpy()
    noisy = t_noise.noisy_expectation(_gen(), spec, w, x, p, 4096,
                                      diag=zdiag).numpy()
    zne = t_mit.zne_expectation(_gen(), spec, w, x, p, 4096,
                                scales=(1.0, 2.0), diag=zdiag).numpy()
    np.testing.assert_allclose(noisy, (1 - 4 * 0.15 / 3) * ideal, atol=0.07)
    np.testing.assert_allclose(zne, ideal, atol=0.12)
    assert np.max(np.abs(zne - ideal)) < np.max(np.abs(noisy - ideal))


def test_zne_improves_multiblock():
    """The multi-block Q2 setup (a polynomial channel): 3-point ZNE lands
    nearer the ideal than the raw noisy value."""
    spec = t_hea.quanonet_spec(2, (2, 1, 2, 1))
    rng = np.random.RandomState(0)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32))
    x = torch.tensor(rng.randn(3, spec.total_encode).astype(np.float32))
    diag = simple_ham_diag(2, -3, 3)
    ideal = t_hea.hea_expectation(spec, w, x, diag=diag,
                                  engine='dense').numpy()
    noisy = t_noise.noisy_expectation(_gen(), spec, w, x, 0.08, 2048,
                                      diag=diag).numpy()
    zne = t_mit.zne_expectation(_gen(), spec, w, x, 0.08, 2048,
                                scales=(1.0, 2.0, 3.0), diag=diag).numpy()
    assert np.linalg.norm(zne - ideal) < np.linalg.norm(noisy - ideal)


def test_zne_predict_replayable_and_closer():
    """tests/test_mitigation.py's prediction case: noise 0.1, 256
    trajectories, scales (1, 2)."""
    kw = dict(num_qubits=2, branch_input_size=5, trunk_input_size=2,
              net_size=(2, 1, 2, 1), scale_coeff=0.1, device='cpu')
    rng = np.random.RandomState(4)
    b = rng.randn(6, 5).astype(np.float32)
    t = rng.rand(6, 2).astype(np.float32)
    cfg = {'model_type': 'QuanONet'}
    ideal_model = QuanONet(**kw, generator=_gen(0))
    ideal = t_infer.predict(ideal_model, b, t, cfg=cfg)
    noisy_model = QuanONet(**kw, noise_p=0.1, noise_traj=256)
    noisy_model.load_state_dict(ideal_model.state_dict())
    noisy = t_infer.predict(noisy_model, b, t, cfg=cfg, shot_seed=1)
    zne = t_infer.zne_predict(noisy_model, b, t, cfg=cfg, scales=(1.0, 2.0),
                              shot_seed=1)
    zne2 = t_infer.zne_predict(noisy_model, b, t, cfg=cfg,
                               scales=(1.0, 2.0), shot_seed=1)
    np.testing.assert_array_equal(zne, zne2)
    assert np.linalg.norm(zne - ideal) < np.linalg.norm(noisy - ideal)
    assert noisy_model.measure.zne_scales is None     # left as it was
    with pytest.raises(ValueError, match='noise_p'):
        t_infer.zne_predict(ideal_model, b, t, cfg=cfg)
    with pytest.raises(ValueError, match='distinct'):
        t_infer.zne_predict(noisy_model, b, t, cfg=cfg, scales=(1.0, 1.0))
