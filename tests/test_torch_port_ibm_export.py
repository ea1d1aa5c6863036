"""
The QPU export of the port (quanonet_torch/ibm_export.py,
quanonet_torch/ibm_inference.py), held against the JAX package's
(quanonet_tpu/ibm_export.py, the root ibm_inference.py) on the CPU.

* The NumPy parts (unpack_quanonet_weights, build_gate_list, to_qasm2,
  hamiltonian_pauli_terms, submission_manifest) and walsh_hadamard_coeffs
  give JAX's bytes, on the shipped Q2 anchor and a Q3 case.
* The gate replay (final_state, simulate_gate_list,
  pauli_term_expectations) runs in float64 in the port and in float32 in
  JAX, whose cos/sin differ from torch's by an ulp on some angles: 1e-6
  against JAX, 1e-12 against a complex128 NumPy oracle of the gate list.
* ideal_predictions, the shot-noise std of shot_predictions, and
  noisy_predictions with injected draws (the same fixed error pattern in
  every trajectory of both packages, on both of the port's routes) against
  JAX at 1e-5; the sampled means by distribution.
* The CLI end to end with --device cpu: JAX's artifacts, QASM byte-equal,
  the manifest equal but for the two numbers drawn from each package's
  shot stream.
* The qiskit-gated half through tests/test_ibm_submit_stub.py's doubles.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import test_ibm_submit_stub as stub
from quanonet_tpu import ibm_export as j_ibm
from quanonet_tpu.ops import hamiltonian as j_ham
from quanonet_tpu.ops import noise as j_noise
from quanonet_torch import ibm_export as t_ibm
from quanonet_torch import ibm_inference as t_cli
from quanonet_torch.checkpoint import load_raw
from quanonet_torch.ops import hamiltonian as t_ham
from quanonet_torch.ops import noise as t_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q2 = t_cli.DEFAULT_WEIGHTS
PRED_TOL = 1e-5
REPLAY_TOL = 1e-6
MEASURED = ('expected_shot_noise_std_mean', 'sampled_rel_l2_at_shots')


def _q3_raw(seed=3):
    """A Q3 Net2-2-3-1 checkpoint dict of random weights."""
    rng = np.random.RandomState(seed)
    n, (bd, bld, td, tld) = 3, (2, 2, 3, 1)
    return {'QuanONet.weight': rng.uniform(
                -np.pi, np.pi, (bd * bld + td * tld) * 3 * n).astype(
                np.float32),
            'trunk_LinearLayer.Net2.weights': rng.randn(td * n).astype(
                np.float32),
            'trunk_LinearLayer.Net2.bias': rng.randn(td * n).astype(
                np.float32),
            'branch_LinearLayer.Net2.weights': rng.randn(bd * n).astype(
                np.float32),
            'branch_LinearLayer.Net2.bias': rng.randn(bd * n).astype(
                np.float32),
            'bias': np.asarray([0.25], np.float32)}, [2, 2, 3, 1], n


CASES = {'q2': lambda: (load_raw(Q2), [5, 1, 5, 1], 2), 'q3': _q3_raw}


def _gate_lists(case):
    raw, net, n = CASES[case]()
    branch = np.cos(np.pi * np.linspace(0, 1, 10))
    out = []
    for mod in (t_ibm, j_ibm):
        tw, bw, cf, bias = mod.unpack_quanonet_weights(raw, net, n)
        lists = [mod.build_gate_list(branch, [x], tw, bw, cf)
                 for x in (0.0, 0.37, 1.0)]
        out.append(((tw, bw, cf, bias), lists))
    return raw, net, n, branch, out


@pytest.mark.parametrize("case", ['q2', 'q3'])
def test_numpy_parts_give_jax_bytes(case):
    raw, net, n, _, ((t_unp, t_lists), (j_unp, j_lists)) = _gate_lists(case)
    for a, b in zip(t_unp[:3], j_unp[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert t_unp[3] == j_unp[3]
    assert t_lists == j_lists
    qasms = [t_ibm.to_qasm2(*gl, measure=m) for gl in t_lists
             for m in (False, True)]
    assert qasms == [j_ibm.to_qasm2(*gl, measure=m) for gl in j_lists
                     for m in (False, True)]
    diag = np.linspace(-2, 3, 2 ** n)
    for kw in (dict(), dict(ham_pauli='X', ham_bound=(-1.0, 2.0)),
               dict(ham_pauli='Y'), dict(ham_diag=diag)):
        assert t_ibm.hamiltonian_pauli_terms(n, **kw) == \
            j_ibm.hamiltonian_pauli_terms(n, **kw)
    labels = [f'p{i}' for i in range(len(qasms))]
    assert json.dumps(t_ibm.submission_manifest(
        qasms, n, shots=123, bias=0.5, labels=labels)) == json.dumps(
        j_ibm.submission_manifest(qasms, n, shots=123, bias=0.5,
                                  labels=labels))
    assert t_ham.walsh_hadamard_coeffs(diag, n).tobytes() == \
        j_ham.walsh_hadamard_coeffs(diag, n).tobytes()


def _oracle_state(n, ops):
    """complex128 statevector of the gate list by dense 2^n matrices."""
    dim = 2 ** n
    psi = np.zeros(dim, complex)
    psi[0] = 1.0
    k = np.arange(dim)
    for op in ops:
        if op[0] == 'cx':
            c, t = op[1], op[2]
            psi = psi[k ^ (((k >> c) & 1) << t)]
            continue
        q, th = op[1], op[2]
        c, s = np.cos(th / 2), np.sin(th / 2)
        g = {'rx': np.array([[c, -1j * s], [-1j * s, c]]),
             'ry': np.array([[c, -s], [s, c]]),
             'rz': np.diag([np.exp(-1j * th / 2), np.exp(1j * th / 2)])}[
            op[0]]
        bit = (k >> q) & 1
        other = k ^ (1 << q)
        psi = g[bit, bit] * psi + g[bit, 1 - bit] * psi[other]
    return psi


@pytest.mark.parametrize("case", ['q2', 'q3'])
def test_replay_matches_jax_and_the_oracle(case):
    _, _, n, _, ((_, lists), _) = _gate_lists(case)
    diag = np.linspace(-1, 2, 2 ** n)
    for n_wires, ops in lists:
        got = t_ibm.final_state(n_wires, ops)
        assert got.dtype == np.complex128
        np.testing.assert_allclose(got, _oracle_state(n_wires, ops),
                                   atol=1e-12)
        np.testing.assert_allclose(got, j_ibm.final_state(n_wires, ops),
                                   atol=REPLAY_TOL)
        for kw in (dict(ham_pauli='Z'), dict(ham_pauli='X'),
                   dict(ham_pauli='Y'), dict(ham_diag=diag)):
            assert abs(t_ibm.simulate_gate_list(n_wires, ops, **kw)
                       - j_ibm.simulate_gate_list(n_wires, ops, **kw)) \
                <= REPLAY_TOL * n_wires
        terms = t_ibm.hamiltonian_pauli_terms(n_wires, ham_diag=diag)[0]
        assert abs(t_ibm.pauli_term_expectations(n_wires, ops, terms)
                   - j_ibm.pauli_term_expectations(n_wires, ops, terms)) \
            <= REPLAY_TOL * len(terms)
    with pytest.raises(ValueError, match='unknown op'):
        t_ibm.final_state(1, [('h', 0, 0.0)])
    with pytest.raises(ValueError, match='ham_pauli'):
        t_ibm.simulate_gate_list(1, [], ham_pauli='W')


@pytest.mark.parametrize("case", ['q2', 'q3'])
def test_ideal_and_shot_std_match_jax(case):
    raw, net, n = CASES[case]()
    branch = np.cos(np.pi * np.linspace(0, 1, 10))
    trunk = np.linspace(0, 1, 7)
    for kw in (dict(), dict(ham_pauli='X'),
               dict(ham_diag=np.linspace(-3, 3, 2 ** n))):
        got = t_ibm.ideal_predictions(raw, net, n, branch, trunk,
                                      device='cpu', **kw)
        want = j_ibm.ideal_predictions(raw, net, n, branch, trunk, **kw)
        assert got.shape == want.shape == (7,)
        np.testing.assert_allclose(got, want, atol=PRED_TOL)
    _, std = t_ibm.shot_predictions(raw, net, n, branch, trunk, shots=500,
                                    device='cpu')
    _, j_std = j_ibm.shot_predictions(raw, net, n, branch, trunk, shots=500)
    assert std.dtype == np.float64
    np.testing.assert_allclose(std, j_std, atol=PRED_TOL)


def test_shot_means_by_distribution():
    """Sampled predictions scatter around the ideal ones by their
    analytic std: the mean over 40 seeds within 5 σ/√40 of the ideal at
    every point; equal seeds replay, other seeds differ."""
    raw, net, n = CASES['q2']()
    branch = np.cos(np.pi * np.linspace(0, 1, 10))
    trunk = np.linspace(0, 1, 5)
    ideal = t_ibm.ideal_predictions(raw, net, n, branch, trunk,
                                    device='cpu')
    runs = [t_ibm.shot_predictions(raw, net, n, branch, trunk, shots=200,
                                   seed=s, device='cpu') for s in range(40)]
    std = runs[0][1]
    mean = np.mean([r[0] for r in runs], axis=0)
    assert (np.abs(mean - ideal) <= 5 * std / np.sqrt(40) + 1e-6).all()
    again = t_ibm.shot_predictions(raw, net, n, branch, trunk, shots=200,
                                   seed=0, device='cpu')
    assert np.array_equal(again[0], runs[0][0])
    assert not np.array_equal(runs[0][0], runs[1][0])


def _fixed_masks(nb, n):
    """One error pattern: X on qubit 0 of block 0, Y on the last qubit of
    the middle block, Z on qubit 0 of the last block."""
    a = np.zeros((nb, n), bool)
    b = np.zeros((nb, n), bool)
    a[0, 0] = True
    a[nb // 2, n - 1] = b[nb // 2, n - 1] = True
    b[nb - 1, 0] = True
    return a, b


@pytest.mark.parametrize("route", ['plain', 'fold'])
@pytest.mark.parametrize("readout_p", [0.0, 0.05],
                         ids=['depolarizing', 'readout'])
def test_noisy_predictions_with_injected_draws(monkeypatch, route,
                                               readout_p):
    """Every trajectory of both packages draws the same fixed pattern (each
    package's sample_pauli_masks replaced): the trajectory means agree to
    1e-5, on the port's physical-frame and fold routes, with and without
    readout error (applied exactly by both)."""
    import torch
    raw, net, n = CASES['q3']()
    nb = net[0] + net[2]
    a, b = _fixed_masks(nb, n)
    monkeypatch.setattr(j_noise, 'sample_pauli_masks',
                        lambda key, p, nb_, nq: (jnp.asarray(a),
                                                 jnp.asarray(b)))
    monkeypatch.setattr(t_noise, 'sample_pauli_masks',
                        lambda g, p, nb_, nq: (torch.as_tensor(a),
                                               torch.as_tensor(b)))
    monkeypatch.setattr(t_noise, 'noise_route', lambda dev, nq, d: route)
    branch = np.cos(np.pi * np.linspace(0, 1, 10))
    trunk = np.linspace(0, 1, 6)
    got = t_ibm.noisy_predictions(raw, net, n, branch, trunk, 0.05,
                                  n_traj=3, readout_p=readout_p,
                                  device='cpu')
    want = j_ibm.noisy_predictions(raw, net, n, branch, trunk, 0.05,
                                   n_traj=3, readout_p=readout_p)
    assert got.dtype == np.float64 and got.shape == (6,)
    np.testing.assert_allclose(got, want, atol=PRED_TOL)
    ideal = t_ibm.ideal_predictions(raw, net, n, branch, trunk,
                                    device='cpu')
    assert not np.allclose(got, ideal, atol=1e-3)


def test_readout_alone_matches_jax():
    """No Pauli errors (noise_p 0) and readout error alone: exact in both
    packages, whatever their streams."""
    raw, net, n = CASES['q2']()
    branch = np.cos(np.pi * np.linspace(0, 1, 10))
    trunk = np.linspace(0, 1, 5)
    got = t_ibm.noisy_predictions(raw, net, n, branch, trunk, 0.0,
                                  readout_p=0.03, n_traj=2, device='cpu')
    want = j_ibm.noisy_predictions(raw, net, n, branch, trunk, 0.0,
                                   readout_p=0.03, n_traj=2)
    np.testing.assert_allclose(got, want, atol=PRED_TOL)


def test_noisy_predictions_replay_and_route():
    raw, net, n = CASES['q2']()
    branch = np.cos(np.pi * np.linspace(0, 1, 10))
    trunk = np.linspace(0, 1, 4)
    before = dict(t_noise.routes)
    runs = [t_ibm.noisy_predictions(raw, net, n, branch, trunk, 0.05,
                                    n_traj=8, seed=2, device='cpu')
            for _ in range(2)]
    assert np.array_equal(*runs)
    assert t_noise.routes['plain'] - before['plain'] == 2
    other = t_ibm.noisy_predictions(raw, net, n, branch, trunk, 0.05,
                                    n_traj=8, seed=3, device='cpu')
    assert not np.array_equal(runs[0], other)


def test_cli_writes_the_jax_tools_artifacts(tmp_path):
    """python -m quanonet_torch.ibm_inference --device cpu against the
    root ibm_inference.py on the default Q2 anchor: the same files, QASM
    byte-equal, the manifest equal but for its shot-stream numbers, and
    the gate replay within the 1e-4 contract (the tool exits 0)."""
    env = {**os.environ, 'PYTHONPATH': REPO, 'JAX_PLATFORMS': 'cpu'}
    env.pop('QISKIT_IBM_TOKEN', None)
    for tool, out in ((['-m', 'quanonet_torch.ibm_inference', '--device',
                        'cpu'], 'torch'),
                      ([os.path.join(REPO, 'ibm_inference.py')], 'jax')):
        res = subprocess.run([sys.executable, *tool, '--simulator_only',
                              '--export_dir', str(tmp_path / out)],
                             cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
    files = sorted(os.listdir(tmp_path / 'torch'))
    assert files == sorted(os.listdir(tmp_path / 'jax')) == [
        'circuit_point0.qasm', 'circuit_point49.qasm',
        'circuit_point99.qasm', 'manifest.json']
    for f in files[:3]:
        assert (tmp_path / 'torch' / f).read_bytes() == \
            (tmp_path / 'jax' / f).read_bytes()
    got, want = (json.loads((tmp_path / d / 'manifest.json').read_text())
                 for d in ('torch', 'jax'))
    np.testing.assert_allclose(got.pop(MEASURED[0]), want.pop(MEASURED[0]),
                               rtol=1e-5)
    assert abs(got.pop(MEASURED[1]) - want.pop(MEASURED[1])) < 0.05
    assert got == want


def test_cli_noise_floor_and_missing_weights(tmp_path, capsys):
    t_cli.main(['--simulator_only', '--device', 'cpu', '--export_dir',
                str(tmp_path / 'e'), '--gate_error_2q', '0.01',
                '--noise_traj', '8', '--export_points', '2'])
    man = json.loads((tmp_path / 'e' / 'manifest.json').read_text())
    assert man['depolarizing_p_per_block'] == pytest.approx(0.02)
    assert np.isfinite(man['predicted_noisy_rel_l2'])
    assert np.isfinite(man['predicted_zne_rel_l2'])
    assert man['points'] == [0, 99]
    t_cli.main(['--weight_path', str(tmp_path / 'none.npz'), '--device',
                'cpu'])
    assert 'not found' in capsys.readouterr().out


STUB_TESTS = [name for name in dir(stub) if name.startswith('test_')]


@pytest.mark.parametrize("name", STUB_TESTS)
def test_qiskit_gated_half_holds_the_stub_contract(monkeypatch, capsys,
                                                   name):
    """tests/test_ibm_submit_stub.py's tests, run on the port's module."""
    monkeypatch.setattr(stub, 'ibm_export', t_ibm)
    fn = getattr(stub, name)
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    fn(*[{'monkeypatch': monkeypatch, 'capsys': capsys}[a] for a in args])
