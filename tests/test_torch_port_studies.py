"""
The two studies of the port (quanonet_torch/studies/) against the JAX
scripts they carry over (scripts/noise_robustness_study.py,
scripts/hardware_training_study.py), on the CPU.  The scripts are loaded
from their files (they import quanonet_tpu only inside functions).

- ``evals_per_step`` and the verdicts equal the JAX scripts': the shipped
  docs/noise_robustness*.csv and docs/hardware_training.csv reach the JAX
  verdicts (WINS, WINS, MATCH x3, PASS) and planted rows flip each;
- with a stand-in Solver in each package, every arm hands the Solver the
  JAX script's configuration field for field (the port adds ``device``),
  the evaluations are the same calls, and the CSVs come out byte-equal;
- ``eval_under_noise`` on the shipped Q2 checkpoint: exact at p = 0 to
  1e-5 relative; noisy and ZNE to 1e-5 relative on the same trajectories'
  error draws, injected into both packages (the two draw from other
  random streams);
- a tiny end-to-end run of each study trains through the port's Solver,
  writes the JAX layout and prints its verdict; without a card and without
  ``--device cpu`` each raises before it writes.
"""
import csv
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import quanonet_tpu.data.manager as j_manager
import quanonet_tpu.solver as j_solver
import quanonet_torch.data.manager as t_manager
import quanonet_torch.solver as t_solver
from quanonet_torch.studies import _common
from quanonet_torch.studies import hardware_training as hw
from quanonet_torch.studies import noise_robustness as nr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, 'docs')
Q2_CKPT = os.path.join(
    REPO, 'pretrained_weights/Antideriv/'
    'Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_1000x100_Seed0/'
    'best_model.npz')


def _read_csv(path):
    """A study's CSV as rows of floats where a field is a number (an empty
    field stays '')."""
    def value(v):
        try:
            return float(v)
        except ValueError:
            return v
    with open(path, newline='') as f:
        return [{k: value(v) for k, v in r.items()}
                for r in csv.DictReader(f)]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'scripts', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_NOISE = _load_script('noise_robustness_study')
J_HW = _load_script('hardware_training_study')


@pytest.fixture(autouse=True)
def _two_threads():
    """Q2 tensors are tiny: two intra-op threads are as fast as many, and
    the test workers sharing the host's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ── evals_per_step and the verdicts ─────────────────────────────────────────

@pytest.mark.parametrize("grad_method,nq,net", [
    ('shift', 2, (5, 1, 5, 1)), ('shift', 5, (40, 2, 20, 2)),
    ('shift', 3, (2, 3, 2, 3)), ('autodiff', 2, (5, 1, 5, 1)),
    ('spsa', 7, (40, 2, 20, 2))])
def test_evals_per_step_is_the_jax_scripts(grad_method, nq, net):
    got = hw.evals_per_step(grad_method, nq, net)
    assert got == J_HW.evals_per_step(grad_method, nq, net)
    if (grad_method, nq, net) == ('shift', 2, (5, 1, 5, 1)):
        assert got == 161


@pytest.mark.parametrize("channel,name", [
    ('depolarizing', 'noise_robustness.csv'),
    ('t1t2', 'noise_robustness_t1t2.csv')])
def test_noise_verdict_on_the_shipped_csv(channel, name):
    rows = _read_csv(os.path.join(DOCS, name))
    ideal, robust, label, wins = nr.verdict(rows, channel)
    assert wins and robust < ideal
    line = nr.verdict_line(ideal, robust, label, wins)
    assert line.endswith('noise-aware training WINS')
    if channel == 't1t2':
        assert (ideal, robust) == (0.3225, 0.19073)
        assert 'T1/T2 γ=0.01, p_φ=0.003' in line
        key, level = 'eval_damp_gamma', 0.01
    else:
        assert (ideal, robust) == (0.62359, 0.29322)
        key, level = 'eval_noise_p', 0.02
    # a planted noise-aware row at the deployment noise flips it
    for r in rows:
        if r['trained'] == 'noise_aware' and r[key] == level \
                and r.get('zne', '') == '':
            r['rel_l2'] = ideal + 0.01
    assert not nr.verdict(rows, channel)[3]
    assert nr.verdict_line(*nr.verdict(rows, channel)).endswith('no win')


def test_hardware_verdicts_on_the_shipped_csv():
    rows = _read_csv(os.path.join(DOCS, 'hardware_training.csv'))
    lines = hw.verdicts(rows, 3)
    assert [line.rsplit(' ', 1)[-1] for line, _ in lines] == \
        ['MATCH'] * 3 + ['PASS']
    assert all(ok for _, ok in lines)
    # a planted shift row of seed 1, 11 % off autodiff's, flips its match
    shift1 = next(r for r in rows if r['method'] == 'shift'
                  and r['seed'] == 1)
    shift1['rel_l2'] = 0.11033 * 1.11
    lines = hw.verdicts(rows, 3)
    assert [ok for _, ok in lines] == [True, False, True, True]
    assert 'MISMATCH' in lines[1][0]
    # a planted shift@8192 row above 1.05 x shift@256 fails the shot budget
    hi = next(r for r in rows if r['method'] == 'shift@8192')
    hi['rel_l2'] = 0.35175 * 1.06
    assert hw.verdicts(rows, 3)[-1][0].endswith('FAIL')
    assert not hw.verdicts(rows, 3)[-1][1]


# ── the arms' configurations, with stand-in Solvers ─────────────────────────

class _Recorder:
    """Stand-in Solvers for both packages: each records its configuration
    and writes a metric.json whose rel-L2 follows from the arm."""

    def __init__(self, root):
        self.root, self.configs = root, []
        rec = self

        class Solver:
            def __init__(self, cfg):
                rec.configs.append(dict(cfg))
                d = os.path.join(rec.root, f'run{len(rec.configs)}')
                os.makedirs(d)
                rel = (0.1 + 0.01 * cfg.get('seed', 0)
                       + (0.004 if cfg.get('grad_method') == 'shift' else 0)
                       + 1e-4 * (cfg.get('train_shots') or 0) / 256)
                with open(os.path.join(d, 'metric.json'), 'w') as f:
                    json.dump({'metrics': {'rel_l2': rel,
                                           'train_samples_per_sec': 123.4}},
                              f)
                self.exp_logger = type('L', (), {'exp_dir': d})()

            def train(self):
                return {}

            def evaluate(self, history):
                return {}
        self.Solver = Solver


def _fake_eval(calls):
    def ev(ckpt, data, p, readout_p, zne=None, traj=64, seed=0,
           damp_gamma=None, dephase_p=None, device=None):
        calls.append((os.path.basename(os.path.dirname(ckpt)), p,
                      readout_p, zne, traj, damp_gamma, dephase_p, seed))
        return 0.3 + p + readout_p + (damp_gamma or 0) \
            - (0.05 if zne else 0) \
            - (0.2 if os.path.basename(os.path.dirname(ckpt)) == 'run2'
               else 0)
    return ev


class _NoData:
    def __init__(self, *a, **k):
        pass

    def get_data(self):
        return {}


def _run_jax(mod, argv, monkeypatch):
    monkeypatch.setattr('sys.argv', [mod.__file__, *argv])
    return mod.main()


@pytest.mark.parametrize("extra", [
    [], ['--channel', 't1t2'],
    ['--noise_p', '0.05', '--readout_p', '0', '--traj', '4',
     '--eval_traj', '16', '--epochs', '7']])
def test_noise_study_arms_are_the_jax_scripts(extra, tmp_path, monkeypatch,
                                              capsys):
    out = {}
    for pkg in ('jax', 'torch'):
        rec = _Recorder(tmp_path / pkg)
        calls = []
        csv_path = str(tmp_path / f'{pkg}.csv')
        argv = ['--prefix', 'study_prefix', '--out', csv_path, *extra]
        if pkg == 'jax':
            monkeypatch.setattr(j_solver, 'Solver', rec.Solver)
            monkeypatch.setattr(j_manager, 'DataManager', _NoData)
            monkeypatch.setattr(J_NOISE, 'eval_under_noise', _fake_eval(calls))
            rc = _run_jax(J_NOISE, argv, monkeypatch)
        else:
            monkeypatch.setattr(t_solver, 'Solver', rec.Solver)
            monkeypatch.setattr(t_manager, 'DataManager', _NoData)
            monkeypatch.setattr(nr, 'eval_under_noise', _fake_eval(calls))
            rc = nr.main([*argv, '--device', 'cpu'])
        verdict = [line for line in capsys.readouterr().out.splitlines()
                   if line.startswith('VERDICT')]
        with open(csv_path) as f:
            out[pkg] = (rec.configs, calls, f.read(), rc, verdict)
    j_cfgs, t_cfgs = out['jax'][0], out['torch'][0]
    assert len(j_cfgs) == len(t_cfgs) == 2
    assert all(c.pop('device') == 'cpu' for c in t_cfgs)
    assert t_cfgs == j_cfgs
    assert out['torch'][1:] == out['jax'][1:]
    assert out['torch'][3] == 0 and len(out['torch'][4]) == 1


@pytest.mark.parametrize("extra,n_arms", [
    (['--quick'], 3), ([], 11), (['--match_seeds', '2', '--epochs', '5'], 9)])
def test_hardware_study_arms_are_the_jax_scripts(extra, n_arms, tmp_path,
                                                 monkeypatch, capsys):
    out = {}
    for pkg in ('jax', 'torch'):
        rec = _Recorder(tmp_path / pkg)
        csv_path = str(tmp_path / f'{pkg}.csv')
        argv = ['--prefix', 'hw_prefix', '--out', csv_path, *extra]
        if pkg == 'jax':
            monkeypatch.setattr(j_solver, 'Solver', rec.Solver)
            rc = _run_jax(J_HW, argv, monkeypatch)
        else:
            monkeypatch.setattr(t_solver, 'Solver', rec.Solver)
            rc = hw.main([*argv, '--device', 'cpu'])
        verdict = [line for line in capsys.readouterr().out.splitlines()
                   if line.startswith('VERDICT')]
        with open(csv_path) as f:
            out[pkg] = (rec.configs, f.read(), rc, verdict)
    j_cfgs, t_cfgs = out['jax'][0], out['torch'][0]
    assert all(c.pop('device') == 'cpu' for c in t_cfgs)
    assert t_cfgs == j_cfgs and len(j_cfgs) == n_arms
    assert out['torch'][1:] == out['jax'][1:]
    assert out['torch'][3]


def test_hardware_study_quick_runs_its_arms_at_quick_epochs(tmp_path,
                                                           monkeypatch):
    """--quick runs autodiff, shift and spsa on seed 0 at the module's
    QUICK_EPOCHS, whatever --epochs says (as the JAX script's --quick);
    chip_smoke.py and the card's full-budget run set that constant."""
    rec = _Recorder(tmp_path)
    monkeypatch.setattr(t_solver, 'Solver', rec.Solver)
    monkeypatch.setattr(hw, 'QUICK_EPOCHS', 300)
    out = tmp_path / 'h.csv'
    assert hw.main(['--quick', '--epochs', '5', '--out', str(out),
                    '--device', 'cpu']) == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert [(r['method'], r['seed'], r['epochs']) for r in rows] == \
        [('autodiff', '0', '300'), ('shift', '0', '300'), ('spsa', '0', '300')]
    assert [(c.get('grad_method'), c['seed'], c['num_epochs'])
            for c in rec.configs] == \
        [(None, 0, 300), ('shift', 0, 300), ('spsa', 0, 300)]


# ── eval_under_noise on the shipped checkpoint ──────────────────────────────

@pytest.fixture(scope='module')
def eval_data(tmp_path_factory):
    """2,000 test rows of Antideriv (20 functions x 100 points, 10 sensor
    points), from the host generator under NumPy seed 0."""
    root = tmp_path_factory.mktemp('eval_data')
    cwd = os.getcwd()
    os.chdir(root)                # the raw cache goes to ./data
    try:
        np.random.seed(0)
        return t_manager.DataManager(
            dict(operator='Antideriv', model_type='QuanONet', num_train=2,
                 num_test=20, num_points=100, num_points_0=10,
                 train_sample_num=10, test_sample_num=100),
            data_dir=str(root / 'processed')).get_data()
    finally:
        os.chdir(cwd)


def test_eval_under_noise_exact_is_the_jax_scripts(eval_data):
    want = J_NOISE.eval_under_noise(Q2_CKPT, eval_data, 0.0, 0.0)
    got = nr.eval_under_noise(Q2_CKPT, eval_data, 0.0, 0.0, device='cpu')
    assert abs(got - want) <= 1e-5 * want
    # the noise-trained run's name must not leak its channels into p = 0
    assert 0.05 < got < 0.2


class _InjectedDraws:
    """The same trajectories' error draws in both packages: u (T, nb, n)
    uniforms and choice (T, nb, n) in {0, 1, 2}, made with NumPy; a block
    and qubit errs where u < c·p, with the Pauli X, Y or Z of ``choice``.

    The port runs its own noisy_expectation and zne_expectation with
    sample_pauli_masks and zne_values fed these draws, trajectory by
    trajectory in the order it asks for them.  JAX runs its own
    noisy_expectation and zne_expectation with the key's draws replaced by
    these: each trajectory's ``one`` (quanonet_tpu/ops/noise.py,
    ops/mitigation.py) built from the package's _traj_forward,
    apply_readout_error and probs_pair, vmapped over the trajectories."""

    def __init__(self, monkeypatch, n_traj, nb, n, seed=5):
        import jax
        import jax.numpy as jnp
        from quanonet_tpu.ops import mitigation as j_mit
        from quanonet_tpu.ops import noise as j_noise
        from quanonet_tpu.ops.hea import compile_block_unitaries
        from quanonet_tpu.ops.sampling import probs_pair
        from quanonet_torch.ops import mitigation as t_mit
        from quanonet_torch.ops import noise as t_noise
        rng = np.random.RandomState(seed)
        self.u = rng.rand(n_traj, nb, n).astype(np.float32)
        self.choice = rng.randint(0, 3, (n_traj, nb, n))
        self.taken = 0
        draws = self

        def masks(generator, p, n_blocks, n_qubits):
            t = draws.taken
            draws.taken += 1
            dev = generator.device
            occur = torch.as_tensor(draws.u[t], device=dev) < \
                t_noise._per_qubit(p, n_qubits, dev)
            choice = torch.as_tensor(draws.choice[t], device=dev)
            return occur & (choice != 2), occur & (choice != 0)

        zne_values = t_mit.zne_values

        def values(ops, u, choice, p, *a, **k):
            t = draws.taken
            draws.taken += u.shape[0]
            return zne_values(ops, torch.as_tensor(draws.u[t:draws.taken]),
                              torch.as_tensor(draws.choice[t:draws.taken]),
                              p, *a, **k)

        def j_forward(spec, weights, x, noise_p, n_traj_, scales, diag,
                      readout_p):
            assert n_traj_ == n_traj
            w = (j_mit.richardson_weights(scales) if scales
                 else np.ones(1))
            ur, ui = compile_block_unitaries(spec, weights)
            utr, uti = ur.transpose(0, 2, 1), ui.transpose(0, 2, 1)
            xb = x.reshape(x.shape[0], nb, n).transpose(1, 0, 2)
            p = jnp.broadcast_to(jnp.asarray(noise_p, jnp.float32), (n,))
            d = jnp.asarray(diag, jnp.float32)

            def one(u, choice):
                val = jnp.zeros((xb.shape[1],), jnp.float32)
                for c, wi in zip(scales or (1.0,), w):
                    occur = u < jnp.float32(c) * p
                    a, b = occur & (choice != 2), occur & (choice != 0)
                    sr, si = j_noise._traj_forward(spec, utr, uti, xb, a, b)
                    probs = j_noise.apply_readout_error(probs_pair(sr, si),
                                                        readout_p)
                    val = val + jnp.float32(wi) * jnp.einsum(
                        'bd,d->b', probs, d,
                        precision=jax.lax.Precision.HIGHEST)
                return val
            vals = jax.vmap(one)(jnp.asarray(draws.u),
                                 jnp.asarray(draws.choice))
            return jnp.mean(vals, axis=0)[:, None]

        def j_noisy(key, spec, weights, x, noise_p, n_traj_, diag=None,
                    shots=None, readout_p=0.0, damp_gamma=None,
                    dephase_p=None, **_):
            assert not (shots or damp_gamma or dephase_p)
            return j_forward(spec, weights, x, noise_p, n_traj_, None, diag,
                             readout_p)

        def j_zne(key, spec, weights, x, noise_p, n_traj_, scales=(1.0, 2.0),
                  diag=None, readout_p=0.0, **_):
            return j_forward(spec, weights, x, noise_p, n_traj_, scales,
                             diag, readout_p)

        monkeypatch.setattr(t_noise, 'sample_pauli_masks', masks)
        monkeypatch.setattr(t_mit, 'zne_values', values)
        monkeypatch.setattr(j_noise, 'noisy_expectation', j_noisy)
        monkeypatch.setattr(j_mit, 'zne_expectation', j_zne)


@pytest.mark.parametrize("zne", [None, nr.ZNE_SCALES])
def test_eval_under_noise_noisy_and_zne_on_injected_draws(
        eval_data, zne, monkeypatch):
    """p = 0.02, readout 0.01, 64 trajectories, plain and under ZNE(1, 2,
    3): on the same injected draws, port and JAX within 1e-5 relative
    (read on the CPU: 0.44338 noisy, 2.1e-7 apart; 0.75194 under ZNE,
    3.8e-7 apart).  A port that skips the extrapolation (0.309 apart
    under ZNE) or runs the channel at half p (0.259 under ZNE; the noisy
    case fails too) fails.  Then with its own
    draws the port replays a seed bit for bit, and the channel costs
    accuracy."""
    own = {s: nr.eval_under_noise(Q2_CKPT, eval_data, 0.02, 0.01, seed=s,
                                  zne=zne, device='cpu') for s in (0, 3)}
    assert nr.eval_under_noise(Q2_CKPT, eval_data, 0.02, 0.01, seed=3,
                               zne=zne, device='cpu') == own[3]
    exact = nr.eval_under_noise(Q2_CKPT, eval_data, 0.0, 0.0, device='cpu')
    if zne is None:
        assert min(own.values()) > exact
    draws = _InjectedDraws(monkeypatch, 64, 10, 2)
    want = J_NOISE.eval_under_noise(Q2_CKPT, eval_data, 0.02, 0.01, zne=zne)
    got = nr.eval_under_noise(Q2_CKPT, eval_data, 0.02, 0.01, zne=zne,
                              device='cpu')
    assert draws.taken == 64
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * want, (got, want)
    assert got != own[0] and got != exact


# ── end to end on the CPU, and no fallback ──────────────────────────────────

@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A tiny budget through the module dict: 200 training samples, 1,000
    test rows; the raw data cache under the test's directory."""
    monkeypatch.setitem(_common.BASE, 'num_train', 20)
    monkeypatch.setitem(_common.BASE, 'num_test', 10)
    monkeypatch.setattr(hw, 'QUICK_EPOCHS', 2)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _shipped(name):
    with open(os.path.join(DOCS, name), newline='') as f:
        return list(csv.DictReader(f))


def test_noise_study_end_to_end(tiny, capsys):
    out = tiny / 'n.csv'
    rc = nr.main(['--epochs', '2', '--prefix', str(tiny / 'outputs'),
                  '--out', str(out), '--device', 'cpu'])
    with open(out, newline='') as f:
        rows = list(csv.DictReader(f))
    want = _shipped('noise_robustness.csv')
    assert list(rows[0]) == list(want[0])
    key = ('trained', 'eval_noise_p', 'eval_readout_p', 'zne')
    assert [tuple(r[k] for k in key) for r in rows] == \
        [tuple(r[k] for k in key) for r in want]
    assert all(np.isfinite(float(r['rel_l2'])) for r in rows)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith('VERDICT @ deployment noise p=0.02')]
    assert len(lines) == 1 and rc == (0 if 'WINS' in lines[0] else 1)
    runs = sorted(r for r in os.listdir(tiny / 'outputs' / 'Antideriv')
                  if r.startswith('Antideriv_'))
    assert runs == ['Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_20x100_Seed0',
                    'Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_'
                    'Noise0.02R0.01_20x100_Seed0']


def test_hardware_study_end_to_end(tiny, capsys):
    out = tiny / 'h.csv'
    rc = hw.main(['--quick', '--prefix', str(tiny / 'outputs'),
                  '--out', str(out), '--device', 'cpu'])
    with open(out, newline='') as f:
        rows = list(csv.DictReader(f))
    want = _shipped('hardware_training.csv')
    assert list(rows[0]) == list(want[0])
    assert [(r['method'], r['seed'], r['epochs'],
             r['circuit_evals_per_step']) for r in rows] == \
        [('autodiff', '0', '2', '1'), ('shift', '0', '2', '161'),
         ('spsa', '0', '2', '2')]
    rel = {r['method']: float(r['rel_l2']) for r in rows}
    assert all(np.isfinite(v) for v in rel.values())
    # the two gradients are the same: the same trained model
    assert abs(rel['shift'] - rel['autodiff']) <= 1e-3 * rel['autodiff']
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith('VERDICT')]
    assert lines == [f"VERDICT shift≡autodiff (seed 0): {rel['shift']:.4f}"
                     f" vs {rel['autodiff']:.4f} -> MATCH"] and rc == 0


@pytest.mark.parametrize("module", [nr, hw])
def test_studies_refuse_cpu_fallback(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    out = tmp_path / 'x.csv'
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        module.main(['--out', str(out), '--prefix', str(tmp_path / 'o')])
    assert not any(tmp_path.iterdir())
