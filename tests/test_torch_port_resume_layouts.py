"""
A train state saved under one Adam layout resumes under the other
(solver.save_train_state / load_train_state): ``torch.optim.Adam``'s
per-parameter exp_avg / exp_avg_sq and step, under a ScheduledOptimizer
(the solver's adam), and the one-launch Adam's mu / nu
(ops/cuda_adam.FusedAdam).  The moments carry over bit for bit and the
count is the file's.
Two more epochs then agree with the run that kept its optimizer to 1e-5
(the two rules differ in their bias correction's rounding: beta**t in
double against 1 - exp(t log b) in fp32), as in test_torch_port_adam.py.
"""
import os

import numpy as np
import pytest
import torch

from quanonet_torch import solver as t_solver
from quanonet_torch.ops.cuda_adam import FusedAdam
from test_torch_port_adam import _data, _model

STEPS = 12   # four epochs of 20 samples in batches of 8


def _start(kind):
    model = _model()
    schedule = lambda t: 0.01 * 0.9 ** t   # noqa: E731
    opt = (FusedAdam(schedule, total_steps=STEPS).init(model.parameters())
           if kind == 'fused' else t_solver.ScheduledOptimizer(
               torch.optim.Adam(model.parameters()), schedule))
    return model, opt, t_solver.make_train_epoch(model, opt, 20, 8, 1)


def _moments(opt):
    if isinstance(opt, FusedAdam):
        return [t.clone() for t in opt.mu + opt.nu]
    inner = opt.optimizer
    params = inner.param_groups[0]['params']
    return ([inner.state[p]['exp_avg'].clone() for p in params]
            + [inner.state[p]['exp_avg_sq'].clone() for p in params])


@pytest.mark.parametrize("first,second", [('torch', 'fused'),
                                          ('fused', 'torch')])
def test_resume_across_layouts(tmp_path, first, second):
    inputs, outputs = _data(20, seed=5)
    perms = [np.random.RandomState(e).permutation(20) for e in range(4)]
    path = os.path.join(tmp_path, 'train_state.npz')
    model_a, opt_a, epoch_a = _start(first)
    for perm in perms[:2]:
        epoch_a(perm, inputs, outputs)
    best = {k: v.clone() for k, v in model_a.state_dict().items()}
    t_solver.save_train_state(path, 2, model_a, opt_a, 0.5, best, [1.0, 0.5])
    saved = _moments(opt_a)
    for perm in perms[2:]:
        epoch_a(perm, inputs, outputs)

    model_b, opt_b, epoch_b = _start(second)
    done, best_loss, _, hist = t_solver.load_train_state(path, model_b, opt_b)
    assert (done, best_loss, hist) == (2, 0.5, [1.0, 0.5])
    assert opt_b.count == 6
    if second == 'torch':
        assert all(float(st['step']) == 6.0
                   for st in opt_b.optimizer.state.values())
    else:
        assert int(opt_b.device_count[0]) == 6
    assert all(torch.equal(a, b) for a, b in zip(saved, _moments(opt_b)))
    for perm in perms[2:]:
        epoch_b(perm, inputs, outputs)
    assert opt_b.count == STEPS
    for (k, a), b in zip(model_a.state_dict().items(),
                         model_b.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   err_msg=k)

