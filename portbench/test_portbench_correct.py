"""``correct`` on the CPU: each cell's run with its timed path broken
underneath (a step that leaves the state unchanged, half of each batch
left out of the loss, an answer altered where it is produced) comes out
not correct, and so does the TF32 control in the program's place, against
the cells' own limits.  The tiny copy (tiny.py) runs the program's plain
engines at 4 qubits and 40 blocks.  On the card, at the cells' sizes,
``python3 portbench/calibrate.py readings`` reads the same faults and
control (PERF.md has the readings the limits were set from)."""

import pytest
import torch

from portbench import calibrate, harness, tiny


@pytest.mark.parametrize('workload,fault', [
    ('q10_train_b1000', 'unchanged'), ('q10_train_b1000', 'half_batch'),
    ('q5_score_grid', 'altered'), ('q10_serve_open', 'altered')])
def test_a_broken_timed_path_is_not_correct(tmp_path, workload, fault):
    root = tiny.tiny_tree(tmp_path)
    assert tiny.run(root, workload)['correct']
    with calibrate.FAULTS[fault]():
        result = tiny.run(root, workload)
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('workload', ['q10_train_b1000', 'q5_score_grid',
                                      'q10_serve_open'])
def test_the_tf32_control_is_not_correct(tmp_path, workload):
    root = tiny.tiny_tree(tmp_path)
    cell = harness.Workload(root, workload)
    for seed in (3, 4, 2 ** 31 + 5):
        run = cell.kind.Cell(cell.config, cell.traffic, seed,
                             torch.device('cpu'), 0.2, root)
        run.run_window(0.2)
        run.free()
        checks = run.check(cell.limits, tf32=True)
        assert any(v > lim for _, v, lim in checks), checks
