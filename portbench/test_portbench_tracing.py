"""The per-layer metrics that read the program's own spans
(``quanonet_torch.tracing``), on the CPU: the tiny traced training cell
reports its four host metrics, the scoring cell's span metrics read
nothing without a card, and every new reader reads nothing without a
session or without the registry.  Run with ``python -m pytest portbench -q``."""
import json
import os
import sys

import pytest

from portbench import harness, tiny

REPO = tiny.REPO
HOST_METRICS = ('host_ms_per_step.train', 'backward_host_ms_per_step.train',
                'optimizer_host_ms_per_step.train',
                'read_wait_ms_per_epoch.train')
SPAN_METRICS = HOST_METRICS + ('chain_fwd_roofline.train',
                               'chain_bwd_roofline.train',
                               'chain_fwd_roofline.score',
                               'operands_ms_per_chunk.score')


def _entries():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as fh:
        return {m['name']: m for m in json.load(fh)['per_layer']}


def test_each_span_metric_has_its_entry_and_cell():
    entries = _entries()
    for name in SPAN_METRICS:
        cell = ('q10_train_b1000' if name.endswith('.train')
                else 'q5_score_grid')
        assert entries[name]['workloads'] == [cell]
        assert entries[name]['source'] == 'program_span'


def test_tiny_traced_training_reports_the_host_metrics(tmp_path):
    root = tiny.tiny_tree(tmp_path)
    result = tiny.run(root, 'q10_train_b1000', trace=1)
    assert result['correct'], result['checks']
    for name in HOST_METRICS:
        assert result['metrics'][name]['value'] > 0, name
        assert result['metrics'][name]['unit'] == 'ms'
    # the plain engine on the CPU has neither chain spans nor device time
    assert 'chain_fwd_roofline.train' not in result['metrics']
    assert 'chain_bwd_roofline.train' not in result['metrics']


def test_tiny_traced_scoring_reads_no_span_metric_on_the_cpu(tmp_path):
    root = tiny.tiny_tree(tmp_path)
    result = tiny.run(root, 'q5_score_grid', trace=1)
    assert result['correct'], result['checks']
    assert 'chain_fwd_roofline.score' not in result['metrics']
    assert 'operands_ms_per_chunk.score' not in result['metrics']


RECORD = dict(kind='train', seconds=1.0, rows=1000, units=10, attempted=10,
              failed=0, flops=3e9, bytes=1e6, window_s=1.0, busy_s=0.5,
              device_rows=100)


@pytest.mark.parametrize('name', SPAN_METRICS)
def test_every_reader_reads_nothing_without_a_session(name):
    from quanonet_torch import tracing
    tracing.reset()
    assert harness.Workload(REPO, 'q10_train_b1000').reader(name)(
        RECORD) is None


@pytest.mark.parametrize('name', SPAN_METRICS)
def test_every_reader_reads_nothing_from_a_program_without_tracing(
        monkeypatch, name):
    """A parent commit's program has no registry: the reader returns None
    and does not raise."""
    import quanonet_torch
    monkeypatch.setitem(sys.modules, 'quanonet_torch.tracing', None)
    monkeypatch.delattr(quanonet_torch, 'tracing', raising=False)
    assert harness.Workload(REPO, 'q10_train_b1000').reader(name)(
        RECORD) is None
