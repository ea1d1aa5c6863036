"""
Multi-seed training of the port (quanonet_torch/multiseed.py) and
backend.py, on the CPU.

The sequential route (``train_seeds_sequential``, the JAX package's
``_train_seeds_sequential``): S = 2 seeds equal two single runs of those
seeds bit for bit (losses, metrics and checkpoints), and
``--multi_seed_fresh_data`` gives each seed its own dataset.  Through
``--multi_seed`` (the packed route; its own tests are
test_torch_port_multiseed_packed.py) a completed seed is skipped without
side effects and the rest still train.
"""
import json
import os

import numpy as np
import pytest

import quanonet_torch.data.generation as t_gen
from quanonet_torch import cli
from quanonet_torch import multiseed as t_multiseed
from quanonet_torch.backend import BackendManager
from quanonet_torch.config import (
    get_base_parser, load_config, set_random_seed,
)

ARGV = ['--operator', 'Antideriv', '--model_type', 'QuanONet',
        '--net_size', '2', '1', '2', '1', '--num_qubits', '2',
        '--num_epochs', '3', '--num_train', '10', '--num_test', '5',
        '--num_points', '20', '--num_points_0', '5', '--num_cal', '50',
        '--train_sample_num', '5', '--test_sample_num', '5',
        '--batch_size', '20', '--learning_rate', '0.05', '--device', 'cpu']


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.chdir(tmp_path)
    np.random.seed(0)
    return tmp_path


def _run_dir(prefix, seed):
    base = os.path.join(prefix, 'Antideriv')
    (run,) = [r for r in os.listdir(base) if r.endswith(f'_Seed{seed}')]
    return os.path.join(base, run)


def _artifacts(prefix, seed):
    """(metrics without the wall-clock rate, history, checkpoint arrays)."""
    d = _run_dir(prefix, seed)
    with open(os.path.join(d, 'metric.json')) as f:
        m = json.load(f)
    m['metrics'].pop('train_samples_per_sec', None)
    with np.load(os.path.join(d, 'best_model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    return m['metrics'], m['history'], arrays


def _sequential(argv):
    """The sequential route for the CLI flags ``argv``, seeded as the CLI
    seeds it."""
    config = load_config(get_base_parser().parse_args(argv))
    set_random_seed(config.get('seed', 0))
    return t_multiseed.train_seeds_sequential(config)


def test_sequential_seeds_equal_single_runs(isolated):
    # both layouts share one data cache (prefix/../data), as runs of the
    # reference's scripts share theirs
    for seed in (0, 1):
        cli.main(ARGV + ['--seed', str(seed), '--prefix',
                         str(isolated / 'single')])
    result = _sequential(ARGV + ['--multi_seed', '0', '1', '--prefix',
                                 str(isolated / 'multi')])
    assert sorted(result) == [0, 1]
    for seed in (0, 1):
        m_s, h_s, a_s = _artifacts(str(isolated / 'single'), seed)
        m_m, h_m, a_m = _artifacts(str(isolated / 'multi'), seed)
        assert m_s == m_m and h_s == h_m
        assert result[seed]['rel_l2'] == m_s['rel_l2']
        assert a_s.keys() == a_m.keys()
        for k in a_s:
            np.testing.assert_array_equal(a_s[k], a_m[k])
    assert _artifacts(str(isolated / 'multi'), 0)[1] != \
        _artifacts(str(isolated / 'multi'), 1)[1]


def test_completed_seeds_are_skipped_and_the_rest_train(isolated):
    prefix = str(isolated / 'out')
    cli.main(ARGV + ['--seed', '0', '--prefix', prefix])
    marker = os.path.join(_run_dir(prefix, 0), 'metric.json')
    before = os.stat(marker).st_mtime_ns
    result = cli.main(ARGV + ['--multi_seed', '0', '1', '--prefix', prefix])
    assert result[0] is None and np.isfinite(result[1]['rel_l2'])
    assert os.stat(marker).st_mtime_ns == before
    again = cli.main(ARGV + ['--multi_seed', '0', '1', '--prefix', prefix])
    assert again == {0: None, 1: None}
    assert os.stat(marker).st_mtime_ns == before
    # the probe made nothing for a seed that never ran
    assert not any(r.endswith('_Seed2')
                   for r in os.listdir(os.path.join(prefix, 'Antideriv')))


@pytest.mark.parametrize("fresh", [False, True])
def test_fresh_data_gives_each_seed_its_own_data(isolated, monkeypatch,
                                                 fresh):
    seen = {}

    class Recording(t_multiseed.Solver):
        def __init__(self, config, **kw):
            super().__init__(config, **kw)
            seen[config['seed']] = self.data['train_output'].copy()

    monkeypatch.setattr(t_multiseed, 'Solver', Recording)
    argv = ARGV + ['--multi_seed', '0', '1', '--prefix',
                   str(isolated / 'out')]
    if fresh:
        argv += ['--multi_seed_fresh_data', 'true']
    _sequential(argv)
    assert sorted(seen) == [0, 1]
    assert np.array_equal(seen[0], seen[1]) is not fresh


def test_backend_manager_routes_to_torch():
    bm = BackendManager()
    for model in ('QuanONet', 'HEAQNN', 'DeepONet', 'FNN', 'FNO'):
        assert bm.check_compatibility(model, 'qiskit', 'mindspore') == \
            'torch'
    with pytest.raises(ValueError, match='Unknown model type'):
        bm.check_compatibility('Transformer')
    summary = bm.device_summary()
    assert summary['num_devices'] == len(summary['devices']) >= 1
    assert summary['platform'] in ('cpu', 'cuda')
