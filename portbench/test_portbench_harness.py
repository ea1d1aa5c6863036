"""The harness on the CPU: discovery by name, a new mix and metric added
as files alone, the import check, and the run's contract without a card.
Run with ``python -m pytest portbench -q``."""
import hashlib
import json
import os
import subprocess
import sys

import pytest

from portbench import harness, tiny

REPO = tiny.REPO


def _bench():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as fh:
        return json.load(fh)


@pytest.mark.parametrize('workload', [w['name'] for w in _bench()['workloads']])
def test_every_cell_finds_its_files(workload):
    cell = harness.Workload(REPO, workload)
    assert cell.config['name'] == cell.workload['config']
    assert cell.traffic['kind'] == cell.kind.__name__.rsplit('.', 1)[1]
    assert cell.limits and all(isinstance(v, (int, float))
                               for v in cell.limits.values())
    names = [m['name'] for m in cell.metrics(0) + cell.metrics(1)]
    assert 'setup_s' in names
    assert len(cell.metrics(0)) >= 2 and cell.metrics(1)
    for name in names:
        assert callable(cell.reader(name))


def test_config_files_hold_their_entries():
    bench = _bench()
    for c in bench['configs']:
        with open(os.path.join(REPO, c['file'])) as fh:
            cfg = json.load(fh)
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced'] == []


def _digest(root):
    out = {}
    for folder, _, files in os.walk(root):
        for name in files:
            if '__pycache__' in folder:
                continue
            path = os.path.join(folder, name)
            with open(path, 'rb') as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_mix_and_metric_are_files_alone(tmp_path):
    """A later change adds a cell with a mix and a metric of its own by
    adding files (and its entries in BENCHMARK.json): no existing file of
    portbench/ changes."""
    root = tiny.tiny_tree(tmp_path)
    before = _digest(os.path.join(root, 'portbench'))
    pb = os.path.join(root, 'portbench')
    with open(os.path.join(pb, 'traffic', 'dummy_mix.json'), 'w') as fh:
        json.dump(dict(kind='score', functions=4, points=25, chunk=40,
                       check_block_rows=100), fh)
    with open(os.path.join(pb, 'limits', 'dummy_cell.json'), 'w') as fh:
        json.dump({'pred_gap': 5e-3}, fh)
    with open(os.path.join(pb, 'metrics', 'dummy_rows.score.py'), 'w') as fh:
        fh.write("def read(record):\n"
                 "    return record['rows'] if record['kind'] == 'score' "
                 "else None\n")
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as fh:
        bench = json.load(fh)
    bench['workloads'].append(dict(
        name='dummy_cell', config='q5_advection_net40-2-20-2',
        traffic='dummy_mix', chips=1, why='a test'))
    bench['end_to_end'].append(dict(
        name='dummy_rows.score', unit='rows', better='higher', bound=0.25,
        source='host_clock', workloads=['dummy_cell']))
    with open(path, 'w') as fh:
        json.dump(bench, fh)
    result = tiny.run(root, 'dummy_cell')
    assert result['correct']
    assert result['metrics']['dummy_rows.score']['value'] % 100 == 0
    assert set(result['metrics']) == {'dummy_rows.score', 'setup_s'}
    after = _digest(pb)
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize('workload', ['q10_train_b1000', 'q5_score_grid',
                                      'q10_serve_open'])
def test_tiny_cells_run_and_check_on_the_cpu(tmp_path, workload):
    root = tiny.tiny_tree(tmp_path)
    result = tiny.run(root, workload)
    assert result['correct'], result['checks']
    assert list(result)[-1] == 'checks'
    assert result['attempted'] > 0 and result['failed'] == 0
    cell = harness.Workload(root, workload)
    assert set(result['metrics']) == {m['name'] for m in cell.metrics(0)}
    traced = tiny.run(root, workload, trace=1)
    assert traced['correct'] and 'breakdown' in traced
    assert traced['device']['window_s'] > 0


def test_the_harness_imports_nothing_of_the_jax_stack():
    assert harness.import_violations(REPO) == []


def test_the_import_check_sees_a_forbidden_import(tmp_path):
    root = tiny.tiny_tree(tmp_path)
    pb = os.path.join(root, 'portbench')
    with open(os.path.join(pb, 'kinds', 'bad.py'), 'w') as fh:
        fh.write("import jax.numpy as jnp\n")
    with open(os.path.join(pb, 'reference', 'bad.py'), 'w') as fh:
        fh.write("from quanonet_torch.ops import hea\n"
                 "from portbench.frozen import work\n"
                 "from ..kinds import train\n"
                 "from . import ckpt\n"
                 "from .quanonet import QuanONet\n"
                 "import quanonet_torch_extra\n")
    found = sorted(harness.import_violations(root))
    assert found == [('portbench/kinds/bad.py', 'jax.numpy'),
                     ('portbench/reference/bad.py', 'portbench.frozen'),
                     ('portbench/reference/bad.py', 'portbench.kinds'),
                     ('portbench/reference/bad.py', 'quanonet_torch.ops')]


def test_loaded_modules_are_compared_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'quanonet_tpu_like', sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, 'flax.linen', sys)
    assert harness.loaded_forbidden() == ['flax']


def test_without_a_card_a_run_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'q5_score_grid',
         '--seed', '3', '--seconds', '1', '--trace', '0'], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    if proc.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert proc.stdout == ''
    assert 'CUDA' in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize('workload', [w['name'] for w in _bench()['workloads']])
def test_each_cell_runs_correct_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's kernels")
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', workload,
         '--seed', '2147483711', '--seconds', '3', '--trace', '0'],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])['correct']
