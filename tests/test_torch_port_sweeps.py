"""
The sweep driver of the port (quanonet_torch/sweeps.py) against the shell
sweeps it carries over (scripts/reproduce_*.sh,
scripts/run_missing_benchmarks1.sh, scripts/streams/*.sh), on the CPU.

Each script runs under bash with a stand-in ``python`` first on PATH (a
/bin/sh script that logs its argv and exits 0): the driver's plan equals
the ``main.py`` argument lists the script issues, in order, for every
sweep and stream, and with the optional operator.  One tiny regime trains
through the driver's subprocess runner and resume-skips on a rerun; a
failing regime stops the sweep with its exit code; scripts/
collect_results.py reads the result.
"""
import json
import os
import shlex
import subprocess
import sys

import numpy as np
import pytest

from quanonet_torch import sweeps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, 'scripts')

# regimes a script issues, recorded with the stand-in python below
RECORDED = {'benchmarks1': 84, 'benchmarks2': 9, 'capacity': 76,
            'circuit': 24, 'hamiltonian': 17, 'scaling': 42,
            'missing_benchmarks1': 19, 'stream:capacity_deeponet': 36,
            'stream:capacity_deeponet_d5': 4, 'stream:capacity_q_a': 20,
            'stream:capacity_q_b': 20, 'stream:capacity_q_b2': 10,
            'stream:circuit_q10': 8}

SHIM = """#!/bin/sh
for a in "$@"; do printf '%s\\t' "$a" >> "$SHIM_LOG"; done
printf '\\n' >> "$SHIM_LOG"
exit 0
"""


def _script(sweep):
    if sweep.startswith('stream:'):
        return os.path.join(SCRIPTS, 'streams', sweep[7:] + '.sh')
    if sweep == 'missing_benchmarks1':
        return os.path.join(SCRIPTS, 'run_missing_benchmarks1.sh')
    return os.path.join(SCRIPTS, f'reproduce_{sweep}.sh')


@pytest.fixture(scope='module')
def shim(tmp_path_factory):
    d = tmp_path_factory.mktemp('shim')
    (d / 'python').write_text(SHIM)
    (d / 'python').chmod(0o755)
    return d


def _issued(shim, sweep, operator):
    log = shim / f"{sweep.replace(':', '_')}_{operator}.log"
    env = dict(os.environ, PATH=f"{shim}{os.pathsep}{os.environ['PATH']}",
               SHIM_LOG=str(log))
    out = subprocess.run(['bash', _script(sweep),
                          *([operator] if operator else [])],
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    runs = [line.split('\t')[:-1] for line in log.read_text().splitlines()]
    assert all(r[0] == 'main.py' for r in runs)
    return [r[1:] for r in runs]


@pytest.mark.parametrize("sweep,operator", [
    *[(s, None) for s in RECORDED],
    *[(s, 'Advection') for s in sweeps.TAKES_OPERATOR]])
def test_plan_is_what_the_script_issues(shim, sweep, operator):
    want = _issued(shim, sweep, operator)
    assert len(want) == RECORDED[sweep]
    assert sweeps.plan(sweep, operator) == want
    if operator:
        assert all(r[r.index('--operator') + 1] == operator for r in want)


def test_every_sweep_has_a_script():
    assert sorted(sweeps.names()) == sorted(RECORDED)
    for sweep in RECORDED:
        assert os.path.isfile(_script(sweep))


def test_dry_run_prints_one_regime_a_line(capsys):
    assert sweeps.main(['--sweep', 'hamiltonian', 'Nonlinear',
                        '--dry_run']) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [shlex.split(line) for line in lines] == \
        sweeps.plan('hamiltonian', 'Nonlinear')
    assert lines[3].split('--ham_bound ')[1].startswith('-1 1 ')
    assert '--ham_diag -5 -2.5 2.5 5 ' in lines[-1]


def test_plan_refuses_what_the_scripts_do_not_take():
    with pytest.raises(ValueError, match='takes no operator'):
        sweeps.plan('benchmarks1', 'Advection')
    with pytest.raises(ValueError, match='unknown sweep'):
        sweeps.plan('nope')
    with pytest.raises(ValueError, match='unknown stream'):
        sweeps.plan('stream:nope')


def test_with_flags():
    argv = ['--a', '1', '--multi_seed', '0', '1', '2', '--ham_bound', '-3',
            '3', '--prefix', 'p']
    assert sweeps.with_flags(argv, multi_seed=[4, 5], ham_bound=['-1', 1],
                             new='x') == \
        ['--a', '1', '--multi_seed', '4', '5', '--ham_bound', '-1', '1',
         '--prefix', 'p', '--new', 'x']
    assert argv[3:6] == ['0', '1', '2']


def _tiny(regime):
    return sweeps.with_flags(regime, num_epochs=1, num_train=4, num_test=2,
                             multi_seed=[0, 1])


def test_a_tiny_regime_trains_then_resume_skips(tmp_path, monkeypatch):
    """The circuit sweep's first regime (Q2 Net50-2-10-2, packed seeds) cut
    to one epoch of 40 samples and two seeds, through the runner on the
    CPU; a rerun skips every seed; collect_results groups the seeds."""
    # the regimes' processes inherit these: two threads for their tiny
    # tensors, not one a core beside the other test workers; and no
    # TensorFlow, as on the card's machine (tensorboard imports it when it
    # finds it, ~15 s a process here, and falls back to its own stub)
    monkeypatch.setenv('OMP_NUM_THREADS', '2')
    stub = tmp_path / 'no_tensorflow' / 'tensorflow'
    stub.mkdir(parents=True)
    (stub / '__init__.py').write_text(
        "raise ImportError('TensorFlow is hidden from this test')\n")
    monkeypatch.setenv('PYTHONPATH', os.pathsep.join(
        p for p in (str(stub.parent), os.environ.get('PYTHONPATH')) if p))
    regime = _tiny(sweeps.plan('circuit')[0])
    logs = []
    for i in range(2):
        with open(tmp_path / f'run{i}.log', 'w') as log:
            rc, done = sweeps.run([regime], 'cpu', str(tmp_path), log=log)
        logs.append((tmp_path / f'run{i}.log').read_text())
        assert rc == 0 and [d['rc'] for d in done] == [0]
        if i == 0:
            runs = tmp_path / 'circuit_reproduction' / 'Antideriv'
            metric = {d: (runs / d / 'metric.json').read_bytes()
                      for d in os.listdir(runs) if d.startswith('Antideriv')}
    assert sorted(metric) == [
        f'Antideriv_QuanONet_Net50-2-10-2_Q2_TF_S0.01_4x100_Seed{s}'
        for s in (0, 1)]
    assert 'packed' in logs[0]
    assert '⏩ [Resume] All seeds already completed' in logs[1]
    assert metric == {d: (runs / d / 'metric.json').read_bytes()
                      for d in metric}
    sys.path.insert(0, SCRIPTS)
    try:
        import collect_results
    finally:
        sys.path.remove(SCRIPTS)
    groups = collect_results.collect(str(tmp_path / 'circuit_reproduction'))
    (key, ms), = groups.items()
    assert key == ('Antideriv', 'Antideriv_QuanONet_Net50-2-10-2_Q2_TF_'
                                'S0.01_4x100')
    assert len(ms) == 2 and all(np.isfinite(m['rel_l2']) for m in ms)
    assert sorted(m['rel_l2'] for m in ms) == sorted(
        json.loads(b)['metrics']['rel_l2'] for b in metric.values())


def test_a_failing_regime_stops_the_sweep_with_its_exit_code(tmp_path):
    bad = ['--model_type', 'QuanONet', '--operator', 'Antideriv',
           '--no_such_flag']
    good = _tiny(sweeps.plan('circuit')[0])
    with open(tmp_path / 'run.log', 'w') as log:
        rc, done = sweeps.run([bad, good], 'cpu', str(tmp_path), log=log)
    assert rc == 2 and [d['rc'] for d in done] == [2]
    assert 'unrecognized arguments: --no_such_flag' in \
        (tmp_path / 'run.log').read_text()
    assert not (tmp_path / 'circuit_reproduction').exists()


def test_sweep_refuses_cpu_fallback(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        sweeps.main(['--sweep', 'circuit', '--workdir', str(tmp_path)])
    assert not any(tmp_path.iterdir())
