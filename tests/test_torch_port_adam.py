"""
The port's one-launch Adam (quanonet_torch/ops/cuda_adam.py) on the CPU,
where it takes its plain version, held against the JAX package's
pallas_adam.fused_adam (Pallas in interpret mode), optax.adam and
torch.optim.Adam, and inside the port's training loop.

Tolerances: atol 2e-6, rtol 1e-5 over 25 steps against the JAX package
(its own test's limits: the same fp32 rule, other rounding of the
multiply-adds); against torch.optim.Adam the same, its bias correction
being beta**t in double on the host against 1 - exp(t log b) in fp32 here.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quanonet_tpu.ops.pallas_adam import fused_adam as j_fused_adam
from quanonet_torch import solver as t_solver
from quanonet_torch.convert import adam_state_from_flax, state_dict_from_flax
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import cuda_adam
from quanonet_torch.ops.cuda_adam import FusedAdam, fused_adam

ATOL, RTOL = 2e-6, 1e-5
MODEL = dict(num_qubits=2, branch_input_size=4, trunk_input_size=1,
             net_size=(3, 1, 2, 1), scale_coeff=0.3)


def _tree(seed=0):
    """The JAX test's tree: a 3-d leaf, a 0-d leaf and a nested pair."""
    rng = np.random.RandomState(seed)
    return {'ansatz': rng.randn(12, 3, 5).astype(np.float32),
            'bias': np.float32(rng.randn()),
            'freq': {'b': rng.randn(20).astype(np.float32),
                     'w': rng.randn(20).astype(np.float32)}}


def _grad_trees(tree, n_steps, seed=100):
    rng = np.random.RandomState(seed)
    return [jax.tree_util.tree_map(
        lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32), tree)
        for _ in range(n_steps)]


def _run_torch(make_opt, tree, grads):
    """Steps of a port optimizer over the tree's leaves, flax key order."""
    sd = state_dict_from_flax({'params': tree})
    params = [torch.nn.Parameter(v) for v in sd.values()]
    opt = make_opt(params)
    for g in grads:
        _set_grads(sd, params, g)
        opt.step()
    return dict(zip(sd, params)), opt


def _set_grads(sd, params, grad_tree):
    by_key = state_dict_from_flax({'params': grad_tree})
    for k, p in zip(sd, params):
        p.grad = by_key[k]


def _run_jax(opt, tree, grads, fused):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = opt.init(params)

    @jax.jit
    def step(g, state, params):
        if fused:
            return opt.fused_step(g, state, params)
        upd, state = opt.update(g, state, params)
        return optax.apply_updates(params, upd), state

    for g in grads:
        params, state = step(jax.tree_util.tree_map(jnp.asarray, g), state,
                             params)
    return state_dict_from_flax({'params': jax.tree_util.tree_map(
        np.asarray, params)}), state


def _assert_close(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("steps,lr,j_lr", [
    (25, 1e-2, 1e-2),
    (10, lambda t: 1e-2 * 0.95 ** t, optax.exponential_decay(1e-2, 1, 0.95)),
], ids=['constant', 'exponential_decay'])
def test_matches_pallas_adam_and_optax(steps, lr, j_lr):
    """A constant rate over 25 steps; a schedule over 10, evaluated at the
    count before the increment as optax evaluates it."""
    tree = _tree(0 if steps == 25 else 1)
    grads = _grad_trees(tree, steps)
    got, opt = _run_torch(
        lambda ps: fused_adam(lr, total_steps=steps).init(ps), tree, grads)
    assert opt.count == steps
    _assert_close(got, _run_jax(j_fused_adam(j_lr), tree, grads, True)[0])
    _assert_close(got, _run_jax(optax.adam(j_lr), tree, grads, False)[0])


def test_matches_torch_adam_under_scheduled_optimizer():
    schedule = t_solver._decay_tuple_schedule(3e-3, ('cosine', 30, 0.1), 30)
    tree = _tree(2)
    grads = _grad_trees(tree, 25, seed=7)
    got, _ = _run_torch(
        lambda ps: fused_adam(schedule, total_steps=30).init(ps), tree, grads)
    want, _ = _run_torch(lambda ps: t_solver.ScheduledOptimizer(
        torch.optim.Adam(ps), schedule), tree, grads)
    assert got['bias'].dim() == 0
    _assert_close(got, {k: v.detach() for k, v in want.items()})


def test_state_carried_across_from_jax():
    """Both optimizers start from one non-zero state (10 JAX steps in) and
    agree after 5 more; the moments agree too."""
    tree = _tree(3)
    grads = _grad_trees(tree, 15, seed=9)
    j_opt = j_fused_adam(1e-2)
    j_params, (count, mu, nu) = _run_jax(j_opt, tree, grads[:10], True)
    sd = state_dict_from_flax({'params': tree})
    params = [torch.nn.Parameter(j_params[k].clone()) for k in sd]
    opt = fused_adam(1e-2).init(params)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    opt.load_state_dict(adam_state_from_flax(
        np.asarray(count), np_tree(mu), np_tree(nu), list(sd)))
    assert opt.count == 10
    for g in grads[10:]:
        _set_grads(sd, params, g)
        opt.step()
    want, (_, mu15, nu15) = _run_jax(j_opt, tree, grads, True)
    _assert_close(dict(zip(sd, params)), want)
    state = opt.state_dict()
    assert state['count'] == 15
    for i, k in enumerate(sd):
        for name, tree15 in (('mu', mu15), ('nu', nu15)):
            np.testing.assert_allclose(
                state['state'][i][name].numpy(),
                state_dict_from_flax(np_tree(tree15))[k].numpy(),
                atol=ATOL, rtol=RTOL, err_msg=f'{name} {k}')


def test_step_semantics():
    """In place; a parameter without a gradient is skipped; a gradient that
    is not contiguous raises; the kernel wrapper refuses CPU leaves."""
    p = [torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.ones(()))]
    opt = FusedAdam(0.1).init(p)
    mu_ptr = opt.mu[0].data_ptr()
    p[0].grad = torch.ones(4)
    opt.step()
    assert opt.mu[0].data_ptr() == mu_ptr and opt.count == 1
    np.testing.assert_allclose(p[0].detach().numpy(), 0.9, atol=1e-6)
    assert p[1].item() == 1.0 and opt.nu[1].item() == 0.0
    opt.zero_grad()
    assert p[0].grad is None
    p[0].grad = torch.ones(4, 2)[:, 0]
    with pytest.raises(ValueError, match='contiguous'):
        opt.step()
    before = cuda_adam.launches
    with pytest.raises(ValueError, match='CUDA leaves'):
        cuda_adam.adam_step([p[1].detach()], [torch.ones(())], opt.mu[1:],
                            opt.nu[1:], 0.1, 1)
    assert cuda_adam.launches == before


def _data(n, seed=1):
    rng = np.random.RandomState(seed)
    return ((torch.tensor(rng.randn(n, 4).astype(np.float32)),
             torch.tensor(rng.rand(n, 1).astype(np.float32))),
            torch.tensor(rng.randn(n, 1).astype(np.float32)))


def _model():
    return QuanONet(**MODEL, engine='pallas', device='cpu',
                    generator=torch.Generator().manual_seed(0))


def test_train_epoch_with_fused_adam():
    """One epoch of make_train_epoch with FusedAdam (23 samples in batches
    of 10, the last ragged) equals the epoch with torch.optim.Adam."""
    inputs, outputs = _data(23)
    perm = np.random.RandomState(0).permutation(23)
    out = {}
    for name in ('fused', 'torch'):
        model = _model()
        opt = (fused_adam(0.01).init(model.parameters()) if name == 'fused'
               else t_solver.build_optimizer(
                   dict(optimizer='adam', learning_rate=0.01), 3,
                   model.parameters()))
        avg, sse = t_solver.make_train_epoch(model, opt, 23, 10, 1)(
            perm, inputs, outputs)
        assert opt.count == 3
        out[name] = (avg.item(), sse.item(), model.state_dict())
    # a loss near 2.4, parameters 1e-6 apart after the first step: relative
    assert out['fused'][0] == pytest.approx(out['torch'][0], rel=1e-5)
    assert out['fused'][1] == pytest.approx(out['torch'][1], rel=1e-5)
    for k, v in out['fused'][2].items():
        np.testing.assert_allclose(v.numpy(), out['torch'][2][k].numpy(),
                                   atol=1e-5, err_msg=k)


def test_train_state_round_trip_is_bit_identical(tmp_path):
    """Two epochs, save, two more; against save, load into a fresh model
    and optimizer, two more: equal bits in parameters and moments."""
    inputs, outputs = _data(20, seed=5)
    perms = [np.random.RandomState(e).permutation(20) for e in range(4)]
    path = os.path.join(tmp_path, 'train_state.npz')

    def start():
        model = _model()
        opt = fused_adam(lambda t: 0.01 * 0.9 ** t,
                         total_steps=12).init(model.parameters())
        return model, opt, t_solver.make_train_epoch(model, opt, 20, 8, 1)

    model_a, opt_a, epoch_a = start()
    for perm in perms[:2]:
        epoch_a(perm, inputs, outputs)
    best = {k: v.clone() for k, v in model_a.state_dict().items()}
    t_solver.save_train_state(path, 2, model_a, opt_a, 0.5, best, [1.0, 0.5])
    for perm in perms[2:]:
        epoch_a(perm, inputs, outputs)

    model_b, opt_b, epoch_b = start()
    done, best_loss, best_b, hist = t_solver.load_train_state(path, model_b,
                                                              opt_b)
    assert (done, best_loss, hist) == (2, 0.5, [1.0, 0.5])
    assert opt_b.count == opt_a.count - 6
    assert all(torch.equal(best[k], best_b[k]) for k in best)
    for perm in perms[2:]:
        epoch_b(perm, inputs, outputs)
    for (k, a), b in zip(model_a.state_dict().items(),
                         model_b.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu):
        assert torch.equal(a, b)
