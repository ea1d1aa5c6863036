"""
The port's cross-engine gate (quanonet_torch/compare_engines.py) and its
Hamiltonian helpers, held against the JAX package on the CPU: the module
runs and passes as a CLI, a group that raises fails the run, and every
port engine at the module's inputs is within 1e-4 of the JAX engine of the
same name (forward and gradient of the group's loss; the JAX 'gates'
engine and Q12 'pfused' forward only: their gradients cost minutes of XLA
compile here, and the module holds the port's 'gates' gradient against
'dense' and its 'pfused' against 'fused').  The helpers' arrays are
byte-equal to JAX's under one seed.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quanonet_tpu.ops import hamiltonian as j_ham
from quanonet_tpu.ops import hea as j_hea
from quanonet_torch import compare_engines as ce
from quanonet_torch.ops import hamiltonian as t_ham

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def test_cli_passes_on_the_cpu_and_writes_its_own_artifact(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, '-m', 'quanonet_torch.compare_engines', '--device',
         'cpu'], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert '[SKIP] Q14 fused≡pfused' in out.stdout
    assert not (tmp_path / 'compare_engines_result.json').exists()
    with open(tmp_path / 'compare_engines_torch_result.json') as f:
        art = json.load(f)
    assert set(art) == {'platform', 'device_name', 'passed', 'total',
                        'all_ok', 'checks'}
    assert art['platform'] == 'cpu' and art['all_ok']
    assert art['passed'] == art['total'] == len(art['checks']) == 20
    assert 'Q8 multi-CTA fused≡pfused' in art['checks']


def test_a_group_that_raises_fails_the_run(tmp_path, monkeypatch):
    def broken(self):
        raise RuntimeError('planted')
    monkeypatch.setattr(ce.Gate, 'GROUPS', ('ham_variants', 'golden_ckpt'))
    monkeypatch.setattr(ce.Gate, 'golden_ckpt', broken)
    out = tmp_path / 'r.json'
    assert ce.main(['--device', 'cpu', '--out', str(out)]) == 1
    art = json.loads(out.read_text())
    assert not art['all_ok'] and art['checks']['golden_ckpt'] is False
    assert art['passed'] == art['total'] - 1 == 4


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_hamiltonian_helpers_byte_equal_jax(n, seed):
    pairs = [(t_ham.generate_ham_diag_rank1(n, seed=seed),
              j_ham.generate_ham_diag_rank1(n, seed=seed)),
             (t_ham.zero_state_ham_diag(n, -1.5, 2.0),
              j_ham.zero_state_ham_diag(n, -1.5, 2.0)),
             (t_ham.zero_state_ham_diag(n), j_ham.zero_state_ham_diag(n))]
    for rank in range(1, 2 ** n + 1):
        pairs.append((t_ham.generate_ham_spectrum_uniform(n, rank, seed),
                      j_ham.generate_ham_spectrum_uniform(n, rank, seed)))
    for got, want in pairs:
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match='cannot be greater'):
        t_ham.generate_ham_spectrum_uniform(n, 2 ** n + 1, seed)


def _j_spec(spec):
    return j_hea.HEASpec(spec.n_qubits, spec.block_configs)


def _jax_run(spec, w, x, engine, power, grad=True, **obs):
    """JAX's (forward, gradient of Σ out^power) at the same inputs; jitted
    but for 'gates', whose jitted gradient takes minutes to compile."""
    spec = _j_spec(spec)
    obs = {k: jnp.asarray(v) if k == 'diag' else v for k, v in obs.items()}
    xj = jnp.asarray(x)

    def f(w_):
        out = j_hea.hea_expectation(spec, w_, xj, engine=engine, **obs)
        return jnp.sum(out ** power), out
    if not grad:
        return np.asarray(f(jnp.asarray(w))[1]), None
    (_, out), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(w))
    return np.asarray(out), np.asarray(g)


def _held(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=TOL)
    if want[1] is not None:
        np.testing.assert_allclose(got[1], want[1], atol=TOL)


@pytest.mark.parametrize("engine", ce.ENGINES)
@pytest.mark.parametrize("group", ['quanonet', 'heaqnn'])
def test_engines_match_jax(group, engine):
    spec, w, x, diag = (ce.quanonet_inputs() if group == 'quanonet'
                        else ce.heaqnn_inputs())
    power = 2 if group == 'quanonet' else 1
    got = ce.engine_run(spec, w, x, engine, 'cpu', power, diag=diag)
    _held(got, _jax_run(spec, w, x, engine, power, engine != 'gates',
                        diag=diag))


def test_ham_variants_match_jax():
    spec, w, x, diags = ce.ham_inputs()
    obs = [dict(diag=d) for d in diags.values()] + [
        dict(pauli=p, offset=0.0, coeff=1.0) for p in ('X', 'Y')]
    for kw in obs:
        for engine in ('dense', 'gates'):
            got = ce.forward_run(spec, w, x, engine, 'cpu', **kw)
            want = _jax_run(spec, w, x, engine, 1, False, **kw)[0]
            np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("engine", ['fused', 'pfused'])
@pytest.mark.parametrize("label", ['Q8', 'Q8 multi-CTA', 'Q12'])
def test_pfused_group_matches_jax(label, engine):
    spec, w, x, diag = ce.pfused_inputs()[label]
    got = ce.engine_run(spec, w, x, engine, 'cpu', 2, diag=diag)
    grad = not (label == 'Q12' and engine == 'pfused')
    _held(got, _jax_run(spec, w, x, engine, 2, grad, diag=diag))
