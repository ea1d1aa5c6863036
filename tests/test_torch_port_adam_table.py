"""
The one-launch Adam's rate table and update count (ops/cuda_adam.FusedAdam)
on the CPU, where a step takes the plain version with the same table and
count as the kernel: a cosine schedule over 30 steps against the JAX
package's pallas_adam.fused_adam (Pallas in interpret mode), the table's
clamp, the count's host mirror, a constant rate, and the refusal past the
table's end.

Tolerances: atol 2e-6, rtol 1e-5 against the JAX package (the JAX test's
limits: the same fp32 rule; the port evaluates the schedule in float64 and
rounds it to fp32 once, optax in fp32).
"""
import numpy as np
import optax
import pytest
import torch

from quanonet_tpu.ops.pallas_adam import fused_adam as j_fused_adam
from quanonet_torch import solver as t_solver
from quanonet_torch.ops import cuda_adam
from quanonet_torch.ops.cuda_adam import FusedAdam
from test_torch_port_adam import (
    _assert_close, _grad_trees, _run_jax, _run_torch, _tree,
)

PEAK, STEPS, ALPHA = 3e-3, 30, 0.1


def test_cosine_table_matches_pallas_adam():
    """30 steps of a cosine decay from 3e-3 to 3e-4, its table of 30
    rates built at init, against the JAX package's fused_adam under
    optax.cosine_decay_schedule."""
    schedule = t_solver._decay_tuple_schedule(PEAK, ('cosine', STEPS, ALPHA),
                                              STEPS)
    tree = _tree(4)
    grads = _grad_trees(tree, STEPS, seed=21)
    got, opt = _run_torch(
        lambda ps: FusedAdam(schedule, total_steps=STEPS).init(ps), tree,
        grads)
    assert opt.count == STEPS and int(opt.device_count[0]) == STEPS
    np.testing.assert_array_equal(
        opt.lr_table.numpy(),
        np.float32([schedule(t) for t in range(STEPS)]))
    want, (count, _, _) = _run_jax(
        j_fused_adam(optax.cosine_decay_schedule(PEAK, STEPS, ALPHA)), tree,
        grads, True)
    assert float(count) == STEPS
    _assert_close(got, want)


def _one_leaf(lr, **kw):
    p = torch.nn.Parameter(torch.ones(3))
    return p, FusedAdam(lr, **kw).init([p])


def test_constant_rate_is_a_table_of_one_and_clamps():
    """A constant rate is one fp32 entry that every update reads (the clamp
    min(count, len - 1)), as adam_step_dense at that rate."""
    p, opt = _one_leaf(0.05)
    assert opt.lr_table.tolist() == [np.float32(0.05)]
    ref, m, v = torch.ones(3), torch.zeros(3), torch.zeros(3)
    for t in range(1, 6):
        p.grad = torch.full((3,), float(t))
        opt.step()
        cuda_adam.adam_step_dense([ref], [p.grad], [m], [v],
                                  float(np.float32(0.05)), t)
    assert torch.equal(p.detach(), ref)
    assert opt.count == 5 and int(opt.device_count[0]) == 5


def test_schedule_past_its_table_raises_before_the_step():
    """A schedule's table holds total_steps rates; the update after them
    raises and moves nothing; a schedule without total_steps is refused."""
    p, opt = _one_leaf(lambda t: 0.1 / (1 + t), total_steps=3)
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
    before = p.detach().clone()
    with pytest.raises(RuntimeError, match='past the schedule'):
        opt.step()
    assert torch.equal(p.detach(), before) and opt.count == 3
    assert int(opt.device_count[0]) == 3
    with pytest.raises(ValueError, match='total_steps'):
        FusedAdam(lambda t: 0.1)


def test_count_mirror_and_resume():
    """state_dict reads the device count and refuses one that is not the
    host's mirror; load_state_dict sets both."""
    p, opt = _one_leaf(0.1)
    p.grad = torch.ones(3)
    opt.step()
    opt.step()
    assert opt.state_dict()['count'] == 2
    opt.device_count[0] = 7
    with pytest.raises(RuntimeError, match='mirror'):
        opt.state_dict()
    opt.load_state_dict({'count': 4, 'state': {
        0: {'mu': torch.full((3,), 0.5), 'nu': torch.full((3,), 0.25)}}})
    assert opt.count == 4 and int(opt.device_count[0]) == 4
    assert opt.state_dict()['count'] == 4
    assert torch.equal(opt.mu[0], torch.full((3,), 0.5))


def test_gradients_checked_when_they_move(monkeypatch):
    """A gradient is checked when its pointer changes, not on every step;
    a non-contiguous one raises."""
    p, opt = _one_leaf(0.1)
    checked = []
    real = cuda_adam._check
    monkeypatch.setattr(cuda_adam, '_check',
                        lambda *a: checked.append(a[0]) or real(*a))
    p.grad = torch.ones(3)
    for _ in range(3):
        opt.step()
    assert checked == ['gradient'] and opt.count == 3
    p.grad = torch.ones(3, 2)[:, 0]
    with pytest.raises(ValueError, match='contiguous'):
        opt.step()
    assert opt.count == 3 and checked == ['gradient'] * 2
