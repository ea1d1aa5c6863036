"""
The port's optimizers (quanonet_torch/solver.build_optimizer) against the
JAX package's optax ones (quanonet_tpu/solver.build_optimizer): the same
parameters and gradients, one update each, and for RMSprop's options a few
updates under a decaying learning rate.  RMSprop is the port's own class:
optax puts epsilon inside the square root, torch.optim.RMSprop outside.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_torch import solver as t_solver
from quanonet_tpu import solver as j_solver


def _steps(cfg, p0, grads, total_steps=10):
    """Parameters after len(grads) updates in each package: (port, optax)."""
    opt = j_solver.build_optimizer(cfg, total_steps)
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, pj)
        pj = pj + upd
    pt = torch.nn.Parameter(torch.tensor(p0))
    topt = t_solver.build_optimizer(cfg, total_steps, [pt])
    for g in grads:
        topt.zero_grad()
        pt.grad = torch.tensor(g)
        topt.step()
    return pt.detach().numpy(), np.asarray(pj)


@pytest.mark.parametrize("g", [1e-5, 1e-2])
def test_rmsprop_one_step_matches_optax(g):
    """eps inside the square root: from p = 1 at lr 1e-3 a gradient of 1e-5
    moves p by -9.995e-5 (optax); eps outside would give -3.152e-3."""
    p0 = np.ones((3, 4), np.float32)
    grads = [np.full((3, 4), g, np.float32)]
    got, want = _steps({'optimizer': 'rmsprop', 'learning_rate': 1e-3},
                       p0, grads)
    assert np.abs(got - want).max() <= 2e-7
    if g == 1e-5:
        assert want[0, 0] - 1.0 == pytest.approx(-9.995e-5, rel=1e-3)


@pytest.mark.parametrize("kw", [
    {}, {'decay': 0.5, 'eps': 1e-6}, {'centered': True},
    {'momentum': 0.9}, {'momentum': 0.8, 'nesterov': True},
    {'centered': True, 'momentum': 0.9}, {'eps_in_sqrt': False},
    {'initial_scale': 0.1},
])
def test_rmsprop_options_match_optax(kw):
    """decay, centered, momentum (a trace of the lr-scaled update, as
    optax's), nesterov, eps_in_sqrt, initial_scale: four updates under a
    cosine learning rate."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) * 0.1 for _ in range(4)]
    cfg = {'optimizer': 'rmsprop', 'learning_rate': 1e-2,
           'lr_scheduler': 'cosine', 'optimizer_kwargs': kw}
    got, want = _steps(cfg, p0, grads)
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("name,kw", [
    ('adamw', {}), ('adamw', {'weight_decay': 0.1}),
    ('sgd', {'momentum': 0.9}), ('sgd', {'momentum': 0.9, 'nesterov': True}),
])
def test_adamw_and_sgd_one_step_match_optax(name, kw):
    rng = np.random.RandomState(1)
    p0 = rng.randn(4, 6).astype(np.float32)
    grads = [rng.randn(4, 6).astype(np.float32)]
    got, want = _steps({'optimizer': name, 'learning_rate': 1e-3,
                        'optimizer_kwargs': kw}, p0, grads)
    assert np.abs(got - want).max() <= 2e-7


def test_rmsprop_state_round_trips():
    """The port's RMSprop keeps its moments in the optimizer state, so a
    resumed run continues where it stopped."""
    rng = np.random.RandomState(2)
    grads = [rng.randn(6).astype(np.float32) for _ in range(4)]
    cfg = {'optimizer': 'rmsprop', 'learning_rate': 1e-2,
           'optimizer_kwargs': {'momentum': 0.9, 'centered': True}}

    def run(split):
        p = torch.nn.Parameter(torch.ones(6))
        opt = t_solver.build_optimizer(cfg, 10, [p])
        for i, g in enumerate(grads):
            if i == split:
                sd = opt.state_dict()
                p = torch.nn.Parameter(p.detach().clone())
                opt = t_solver.build_optimizer(cfg, 10, [p])
                opt.load_state_dict(sd)
            opt.zero_grad()
            p.grad = torch.tensor(g)
            opt.step()
        return p.detach()
    assert torch.equal(run(None), run(2))
    with pytest.raises(ValueError, match='bias_correction'):
        t_solver.build_optimizer(
            {'optimizer': 'rmsprop', 'learning_rate': 1e-3,
             'optimizer_kwargs': {'bias_correction': True}}, 10,
            [torch.nn.Parameter(torch.ones(2))])
