"""
Finite-shot sampling of the port (quanonet_torch/ops/sampling.py) and the
riders it came with (metrics.count_parameters,
ExperimentLogger.completed, hea.hea_forward_state), held against the JAX
package on the CPU.

The same inputs, made from a NumPy seed, go through both packages.  The
deterministic pieces agree to 1e-6 absolute (the basis rotation,
probabilities and the analytic standard error are short fp32 sums of
amplitudes of magnitude <= 1) and the complex state to 1e-5 (a chain of
blocks in another summation order).  The random streams differ (torch
generators against JAX keys), so the sampled pieces are held by their
distribution: counts sum to ``shots``, equal seeds replay bit for bit,
each row's shot mean lies within 4 standard errors of JAX's exact
expectation, and the empirical variance of the estimator matches
``shot_noise_std`` within 30 % (400 replays: the sample variance's own
relative spread is sqrt(2/399) = 7 %, so 30 % is four of it).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_tpu import logger as j_logger
from quanonet_tpu import metrics as j_metrics
from quanonet_tpu.models import QuanONet as JQuanONet
from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops import sampling as j_sampling
from quanonet_tpu.ops.hamiltonian import resolve_ham_diag, simple_ham_params
from quanonet_torch import logger as t_logger
from quanonet_torch import metrics as t_metrics
from quanonet_torch.convert import state_dict_from_flax
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import hea as t_hea
from quanonet_torch.ops import sampling as t_sampling

NQ = 3
J_SPEC = j_hea.heaqnn_spec(NQ, (2, 1))
T_SPEC = t_hea.heaqnn_spec(NQ, (2, 1))
DIAG = resolve_ham_diag(NQ, [-5.0, 5.0], None)
OFFSET, COEFF = simple_ham_params(NQ, -5.0, 5.0)
BATCH = 4


def _inputs(seed=7):
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, T_SPEC.weight_shape()).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (BATCH, T_SPEC.total_encode)).astype(
        np.float32)
    return w, x


def _jax_state(w, x):
    sr, si = j_hea.hea_forward_pair(J_SPEC, jnp.asarray(w), jnp.asarray(x),
                                    engine='dense')
    return np.asarray(sr), np.asarray(si)


def _exact(w, x, pauli):
    """JAX's exact expectation (BATCH,) of the observable."""
    kw = (dict(diag=jnp.asarray(DIAG)) if pauli == 'Z'
          else dict(pauli=pauli, offset=OFFSET, coeff=COEFF))
    return np.asarray(j_hea.hea_expectation(
        J_SPEC, jnp.asarray(w), jnp.asarray(x), engine='dense', **kw))[:, 0]


def _std(sr, si, pauli, shots):
    """JAX's shot_noise_std (BATCH,) of the observable, in its basis."""
    sr, si = j_sampling.rotate_to_pauli_basis(jnp.asarray(sr),
                                              jnp.asarray(si), pauli, NQ)
    d = (DIAG if pauli == 'Z'
         else j_sampling._pauli_sum_diag(NQ, OFFSET, COEFF))
    return np.asarray(j_sampling.shot_noise_std(sr, si, jnp.asarray(d),
                                                shots))[:, 0]


@pytest.mark.parametrize("pauli", ["Z", "X", "Y"])
def test_rotation_and_probs_match_jax(pauli):
    sr, si = _jax_state(*_inputs())
    jr, ji = j_sampling.rotate_to_pauli_basis(jnp.asarray(sr),
                                              jnp.asarray(si), pauli, NQ)
    tr, ti = t_sampling.rotate_to_pauli_basis(torch.tensor(sr),
                                              torch.tensor(si), pauli, NQ)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6)
    np.testing.assert_allclose(
        t_sampling.probs_pair(tr, ti).numpy(),
        np.asarray(j_sampling.probs_pair(jr, ji)), atol=1e-6)
    with pytest.raises(ValueError, match='X, Y or Z'):
        t_sampling.rotate_to_pauli_basis(tr, ti, 'W', NQ)


@pytest.mark.parametrize("shots", [1, 1000])
def test_shot_noise_std_matches_jax(shots):
    sr, si = _jax_state(*_inputs())
    for d in (DIAG, t_sampling._pauli_sum_diag(NQ, OFFSET, COEFF)):
        want = j_sampling.shot_noise_std(jnp.asarray(sr), jnp.asarray(si),
                                         jnp.asarray(d), shots)
        got = t_sampling.shot_noise_std(torch.tensor(sr), torch.tensor(si),
                                        d, shots)
        assert got.shape == (BATCH, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(
        t_sampling._pauli_sum_diag(NQ, OFFSET, COEFF),
        j_sampling._pauli_sum_diag(NQ, OFFSET, COEFF))


def test_indices_to_bits_matches_jax():
    idx = np.random.RandomState(3).randint(0, 2 ** NQ, (5, 9)).astype(
        np.int32)
    want = j_sampling.indices_to_bits(jnp.asarray(idx), NQ)
    got = t_sampling.indices_to_bits(torch.tensor(idx), NQ)
    assert got.dtype == torch.int32 and got.shape == (5, 9, NQ)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hea_forward_state_matches_jax():
    w, x = _inputs(11)
    want = j_hea.hea_forward_state(J_SPEC, jnp.asarray(w), jnp.asarray(x),
                                   engine='dense')
    got = t_hea.hea_forward_state(T_SPEC, torch.tensor(w), torch.tensor(x),
                                  engine='dense')
    assert got.dtype == torch.complex64 and got.shape == (BATCH, 2 ** NQ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_counts_sum_to_shots_and_replay():
    sr, si = _jax_state(*_inputs())
    p = t_sampling.probs_pair(torch.tensor(sr), torch.tensor(si))
    a = t_sampling.sample_counts(torch.Generator().manual_seed(5), p, 777)
    b = t_sampling.sample_counts(torch.Generator().manual_seed(5), p, 777)
    c = t_sampling.sample_counts(torch.Generator().manual_seed(6), p, 777)
    assert torch.equal(a.sum(-1), torch.full((BATCH,), 777.0))
    assert (a >= 0).all() and torch.equal(a, a.round())
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a basis state of probability 1 takes every shot
    onehot = torch.zeros(2, 8)
    onehot[0, 5] = onehot[1, 0] = 1.0
    got = t_sampling.sample_counts(torch.Generator().manual_seed(0), onehot,
                                   50)
    assert torch.equal(got, 50 * onehot)
    i1 = t_sampling.sample_indices(torch.Generator().manual_seed(2), p, 64)
    i2 = t_sampling.sample_indices(torch.Generator().manual_seed(2), p, 64)
    assert i1.dtype == torch.int32 and torch.equal(i1, i2)
    # fold_in derives without reading or advancing the parent's state
    g = torch.Generator().manual_seed(9)
    state = g.get_state()
    f1, f2 = t_sampling.fold_in(g, 3), t_sampling.fold_in(g, 3)
    assert torch.equal(g.get_state(), state)
    assert f1.initial_seed() == f2.initial_seed() != \
        t_sampling.fold_in(g, 4).initial_seed()


def test_sample_indices_follow_the_probabilities():
    sr, si = _jax_state(*_inputs())
    p = t_sampling.probs_pair(torch.tensor(sr), torch.tensor(si))
    shots = 20000
    idx = t_sampling.sample_indices(torch.Generator().manual_seed(1), p,
                                    shots)
    freq = torch.stack([torch.bincount(r.long(), minlength=2 ** NQ)
                        for r in idx]).double() / shots
    sigma = torch.sqrt(p.double() * (1 - p.double()) / shots)
    assert ((freq - p.double()).abs() <= 4 * sigma + 1e-12).all()


@pytest.mark.parametrize("pauli", ["Z", "X", "Y"])
def test_shot_mean_within_four_sigma_of_jax_exact(pauli):
    w, x = _inputs()
    shots = 4000
    got = t_sampling.shot_expectation(
        torch.Generator().manual_seed(13), T_SPEC, torch.tensor(w),
        torch.tensor(x), shots, diag=DIAG if pauli == 'Z' else None,
        pauli=pauli, offset=OFFSET, coeff=COEFF, engine='dense')
    assert got.shape == (BATCH, 1)
    exact = _exact(w, x, pauli)
    sigma = _std(*_jax_state(w, x), pauli, shots)
    assert (sigma > 0).all()
    assert (np.abs(got.numpy()[:, 0] - exact) <= 4 * sigma).all()


@pytest.mark.parametrize("pauli", ["Z", "X"])
def test_empirical_variance_matches_shot_noise_std(pauli):
    w, x = _inputs(5)
    sr, si = t_hea.hea_forward_pair(T_SPEC, torch.tensor(w),
                                    torch.tensor(x), engine='dense')
    sr, si = t_sampling.rotate_to_pauli_basis(sr, si, pauli, NQ)
    d = t_sampling.measurement_diag(NQ, pauli, DIAG, OFFSET, COEFF)
    shots, reps = 200, 400
    g = torch.Generator().manual_seed(21)
    est = torch.stack([t_sampling.shot_expectation_pair(
        t_sampling.fold_in(g, r), sr, si, d, shots)[:, 0]
        for r in range(reps)])
    var = est.double().var(0).numpy()
    want = _std(*_jax_state(w, x), pauli, shots) ** 2
    np.testing.assert_allclose(var, want, rtol=0.3)


def test_count_parameters_equals_jax():
    kw = dict(num_qubits=2, branch_input_size=3, trunk_input_size=1,
              net_size=(2, 1, 2, 1), scale_coeff=0.01)
    params = JQuanONet(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 3)),
                                  jnp.zeros((1, 1)))
    model = QuanONet(**kw, device='cpu')
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    want = j_metrics.count_parameters(params)
    assert t_metrics.count_parameters(model) == want
    assert t_metrics.count_parameters(model.state_dict()) == want
    assert t_metrics.count_parameters(
        [torch.zeros(3, dtype=torch.complex64)]) == 6


def test_completed_is_a_side_effect_free_probe(tmp_path):
    cfg = dict(operator='Antideriv', model_type='QuanONet',
               net_size=[2, 1, 2, 1], num_qubits=2, if_trainable_freq='true',
               scale_coeff=0.01, num_train=20, num_points=50, seed=3)
    prefix = str(tmp_path / 'out')
    assert not t_logger.ExperimentLogger.completed(cfg, prefix)
    assert not os.path.exists(prefix)            # nothing was made
    log = t_logger.ExperimentLogger(cfg, base_output_dir=prefix)
    assert not t_logger.ExperimentLogger.completed(cfg, prefix)
    log.save_metrics({'rel_l2': 0.5})
    log.close()
    assert t_logger.ExperimentLogger.completed(cfg, prefix)
    assert j_logger.ExperimentLogger.completed(cfg, prefix)
    with open(os.path.join(log.exp_dir, 'metric.json')) as f:
        assert json.load(f)['metrics'] == {'rel_l2': 0.5}
    other = dict(cfg, seed=4)
    assert not t_logger.ExperimentLogger.completed(other, prefix)
    assert not j_logger.ExperimentLogger.completed(other, prefix)
