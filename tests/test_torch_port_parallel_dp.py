"""
The port's data parallelism (quanonet_torch/parallel/mesh.py, dp_solver.py,
comm.py, launch.py) on gloo ranks on the CPU: one make_dp_train_step step
under Adam against the JAX package's make_dp_train_step (optax.adam) on the
same batch at W = 2 and 4, and with multi_seed on a 2 × 2 (data, seed)
grid; make_dp_run_segment's full-batch SGD step against the unsharded one
(the scale trap that Adam hides), replicas bit-identical after a segment,
padding rows masked out, noise-aware data parallelism against the manual
per-rank reference, an FNN, a bad batch size; the collectives' values,
gradients and counts; a rank's exception and a deadlock raising in the
caller.

One launch.run_ranks call per case group (60 s limit); the JAX side runs
in this process.  Tolerances: parameters after one step 1e-6 (the JAX
tests' 1e-6 for SGD; Adam's first step moves each parameter by ~lr), the
loss 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_workers as workers
from quanonet_torch.convert import (
    classical_state_dict_from_flax, state_dict_from_flax,
)
from quanonet_torch.ops.sampling import derive_seed, key_generator
from quanonet_torch.parallel import launch
from quanonet_torch.parallel.dp_solver import (
    local_permutation, make_dp_run_segment, pad_to_devices,
)
from quanonet_tpu.models import FNN as JFNN
from quanonet_tpu.models import QuanONet as JQuanONet
from quanonet_tpu.parallel import make_dp_train_step, make_mesh
from quanonet_tpu.parallel.mesh import (
    replicate, shard_batch, shard_seed_axis,
)

TOL = 1e-6
TIMEOUT_S = 60
LR = 0.01
QKW = dict(num_qubits=2, branch_input_size=6, trunk_input_size=1,
           net_size=(2, 1, 2, 1), scale_coeff=0.3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 6).astype(np.float32),
            rng.rand(n, 1).astype(np.float32),
            rng.randn(n, 1).astype(np.float32))


def _jax_dp_step(jm, params, inputs, y, world):
    mesh = make_mesh(world)
    opt = optax.adam(LR)
    step = make_dp_train_step(jm.apply, opt, mesh)
    new, _, loss = step(replicate(mesh, params),
                        replicate(mesh, opt.init(params)),
                        shard_batch(mesh, *inputs), shard_batch(mesh, y)[0])
    return _np(new), float(loss)


def _step_case(kind):
    """(JAX model, params, torch inputs, worker args, state converter)."""
    b, t, y = _batch()
    if kind == 'QuanONet':
        jm = JQuanONet(**QKW)
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(b[:1]),
                         jnp.asarray(t[:1]))
        inputs, kw, conv = (b, t), QKW, state_dict_from_flax
    else:
        jm = JFNN(net_size=(2, 8))
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(b[:1]))
        inputs = (b,)
        kw, conv = dict(in_features=6, net_size=(2, 8)), \
            classical_state_dict_from_flax
    state = {k: v.numpy() for k, v in conv(_np(params)).items()}
    return jm, params, inputs, y, (kind, kw, state, inputs, y, LR), conv


def _data(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randn(n, 1).astype(np.float32))


def _sgd_cases(world):
    return [(n, _data(n, n)) for n in {2: (13,), 4: (24, 22)}[world]]


def _fnn_case():
    from quanonet_torch.models import FNN
    kw = dict(in_features=5, net_size=(2, 8))
    model = FNN(**kw, device='cpu',
                generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(4)
    X = rng.randn(12, 5).astype(np.float32)
    Y = rng.randn(12, 1).astype(np.float32)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, X, Y, (kw, state)


NOISY = dict(world=4, n=16, seed=5)


def _calls(world):
    """Every rank function a test reads, for one start per world."""
    calls = [('dp_step', _step_case(kind)[4])
             for kind in ('QuanONet', 'FNN')]
    for n, (X, Y) in _sgd_cases(world):
        calls.append(('dp_segment', ('linear', _linear(), X, Y,
                                     n + (-n) % world, 1, 0.1, 0)))
    if world == 2:
        _, X, Y, spec = _fnn_case()
        calls.append(('dp_segment', ('fnn', spec, X, Y, 12, 1, 0.1, 0)))
        return calls
    rng = np.random.RandomState(3)
    X = rng.randn(40, 3).astype(np.float32)
    Y = (X @ rng.randn(3, 1)).astype(np.float32)
    calls.append(('dp_segment', ('linear', _linear(), X, Y, 8, 6, 0.05, 7,
                                 'adam')))
    X, Y = _data(NOISY['n'], 0)
    calls.append(('dp_segment', ('noisy', _linear(), X, Y, NOISY['n'], 1,
                                 0.1, NOISY['seed'])))
    calls.append(('collectives', ()))
    calls.append(('dp_step_multiseed', _multiseed_case()[1]))
    return calls


@pytest.fixture(scope='module')
def runs():
    """{world: {call index: per-rank results}}: one start per world."""
    out = {}
    for world in (2, 4):
        ranks = launch.run_ranks(workers.run_all, world,
                                 args=(_calls(world),), timeout_s=TIMEOUT_S)
        out[world] = [[r[i] for r in ranks] for i in range(len(ranks[0]))]
    return out


def _close_state(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=0, atol=TOL,
                                   err_msg=k)


def _identical(per_rank):
    """Every rank's parameters bit for bit rank 0's."""
    for p in per_rank[1:]:
        for k in p:
            np.testing.assert_array_equal(p[k], per_rank[0][k])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ['QuanONet', 'FNN'])
def test_dp_step_matches_jax(runs, world, kind):
    jm, params, inputs, y, _, conv = _step_case(kind)
    ranks = runs[world][('QuanONet', 'FNN').index(kind)]
    new, loss = _jax_dp_step(jm, params, tuple(jnp.asarray(a)
                                               for a in inputs),
                             jnp.asarray(y), world)
    want = conv(new)
    for r_loss, r_state in ranks:
        np.testing.assert_allclose(r_loss, loss, rtol=TOL)
        _close_state(r_state, want)
    _identical([r[1] for r in ranks])


def _multiseed_case():
    """(JAX per-seed results, worker args) of the (4, 2) multi-seed step."""
    b, t, y = _batch(seed=1)
    jm = JQuanONet(**QKW)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    params = jax.vmap(lambda k: jm.init(k, jnp.asarray(b[:1]),
                                        jnp.asarray(t[:1])))(keys)
    per_seed = [jax.tree_util.tree_map(lambda a, s=s: np.asarray(a)[s],
                                       _np(params)) for s in range(2)]
    states = [{k: v.numpy() for k, v in state_dict_from_flax(p).items()}
              for p in per_seed]
    return (jm, params, (b, t), y), (QKW, states, (b, t), y, LR)


def test_dp_multiseed_step_matches_jax(runs):
    """2 seeds over the seed axis × 2-way data parallelism: each seed's
    step equals JAX's seed-vmapped step on the (4, seed_parallel=2)
    mesh."""
    (jm, params, (b, t), y), _ = _multiseed_case()
    opt = optax.adam(LR)
    mesh = make_mesh(4, seed_parallel=2)
    step = make_dp_train_step(jm.apply, opt, mesh, multi_seed=True)
    new, _, loss = step(shard_seed_axis(mesh, params),
                        shard_seed_axis(mesh, jax.vmap(opt.init)(params)),
                        shard_batch(mesh, jnp.asarray(b), jnp.asarray(t)),
                        shard_batch(mesh, jnp.asarray(y))[0])
    new = _np(new)
    ranks = runs[4][-1]
    for rank, (r_loss, r_params) in enumerate(ranks):
        np.testing.assert_allclose(r_loss, np.asarray(loss), rtol=TOL)
        s = rank % 2                          # this rank's seed
        want = state_dict_from_flax(jax.tree_util.tree_map(
            lambda a: a[s], new))
        for k, v in want.items():
            np.testing.assert_allclose(r_params[k][0], v.numpy(), rtol=0,
                                       atol=TOL, err_msg=k)
    assert ranks[0][0][0] != ranks[0][0][1]   # two seeds, two losses


def _linear(feat=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(feat, 1).astype(np.float32),
            rng.randn(1).astype(np.float32))


def _full_batch_sgd(spec, X, Y, lr):
    """The unsharded full-batch SGD step of x @ w + b on the mean squared
    error."""
    w, b = (torch.tensor(a, requires_grad=True) for a in spec)
    loss = ((torch.tensor(X) @ w + b - torch.tensor(Y)) ** 2).mean()
    loss.backward()
    with torch.no_grad():
        return (w - lr * w.grad).numpy(), (b - lr * b.grad).numpy(), \
            loss.item()


@pytest.mark.parametrize("world,case", [(2, 0), (4, 0), (4, 1)])
def test_segment_full_batch_sgd_is_exact(runs, world, case):
    """One step an epoch over the whole (padded) set: the exact
    full-batch SGD step (SGD is not scale invariant: a W-times gradient
    would show), replicas bit-identical, and the padding rows of a set not
    divisible by W (13 over 2, 22 over 4) masked out of the loss and the
    gradient."""
    n, (X, Y) = _sgd_cases(world)[case]
    ranks = runs[world][2 + case]
    w, b, loss = _full_batch_sgd(_linear(), X, Y, 0.1)
    for hist, p in ranks:
        np.testing.assert_allclose(p['w'], w, rtol=0, atol=TOL)
        np.testing.assert_allclose(p['b'], b, rtol=0, atol=TOL)
        np.testing.assert_allclose(hist[0][0], loss, rtol=TOL)
    _identical([r[1] for r in ranks])


def test_segment_replicas_bit_identical_over_epochs(runs):
    """Minibatches, six epochs, local shuffling, Adam: the replicas stay
    bit-identical and the loss falls."""
    ranks = runs[4][4]
    hist = ranks[0][0]
    assert hist[-1][0] < hist[0][0]
    for h, _ in ranks[1:]:
        assert h == hist
    _identical([r[1] for r in ranks])


def test_noisy_segment_equals_manual_reference(runs):
    """Noise-aware data parallelism (the JAX test's
    test_noisy_dp_step_exact_vs_manual_reference): the full-batch step
    equals the gradient of the global loss replayed rank by rank, each
    rank's rows in its local order and its draws from (seed, step, rank)."""
    world, n, seed = NOISY['world'], NOISY['n'], NOISY['seed']
    X, Y = _data(n, 0)
    w, b = (torch.tensor(a, requires_grad=True) for a in _linear())
    local = n // world
    total = 0.0
    for d in range(world):
        perm = local_permutation(seed, 0, d, local)
        xs = torch.tensor(X[d * local:(d + 1) * local])[perm]
        ys = torch.tensor(Y[d * local:(d + 1) * local])[perm]
        gen = key_generator(derive_seed(seed, 0), 1, d)
        pred = xs @ w + b + 0.1 * torch.randn((local, 1), generator=gen)
        total = total + ((pred - ys) ** 2).sum()
    loss = total / n
    loss.backward()
    ranks = runs[4][5]
    for hist, p in ranks:
        np.testing.assert_allclose(
            p['w'], (w - 0.1 * w.grad).detach().numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(
            p['b'], (b - 0.1 * b.grad).detach().numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(hist[0][0], loss.item(), rtol=TOL)
    _identical([r[1] for r in ranks])


def test_fnn_segment_is_exact(runs):
    """A classical model through the segment: the full-batch SGD step of
    an FNN equals the unsharded one."""
    model, X, Y, _ = _fnn_case()
    loss = ((model(torch.tensor(X)) - torch.tensor(Y)) ** 2).mean()
    loss.backward()
    for hist, p in runs[2][3]:
        np.testing.assert_allclose(hist[0][0], loss.item(), rtol=TOL)
        for k, v in model.named_parameters():
            np.testing.assert_allclose(
                p[k], (v - 0.1 * v.grad).detach().numpy(), rtol=0,
                atol=TOL, err_msg=k)


def test_collectives(runs):
    """psum (identity backward), exchange (its own backward), shift (zeros
    into rank 0 and out of the last rank's backward), the gather (own rows
    back), the in-place gradient sum (the .grad pointer kept), and the
    world as backend.device_summary reports it in a rank."""
    for r, out in enumerate(runs[4][6]):
        t = float(r + 1)
        np.testing.assert_array_equal(out['s'], [20.0] * 3)
        np.testing.assert_array_equal(out['e'], [float((r ^ 1) + 1)] * 3)
        np.testing.assert_array_equal(out['sh'], [3.0 * r] * 3)
        np.testing.assert_array_equal(out['g'][:, 0], [1.0, 2.0, 3.0, 4.0])
        # d/dt of 2t (psum, identity) + e² at the partner + 3t shifted on
        # + g² of the own row
        grad = 2.0 + 2.0 * t + (3.0 if r < 3 else 0.0) + 2.0 * t
        np.testing.assert_array_equal(out['grad'], [grad] * 3)
        np.testing.assert_array_equal(out['pgrad'], [6.0 / 4.0] * 2)
        assert out['same_ptr'] and out['extra'][0] == 4.0
        counts = out['counts']
        assert counts['exchange'] == counts['exchange_bwd'] == 1
        assert counts['shift'] == counts['shift_bwd'] == 1
        assert counts['all_reduce'] == 2 and counts['all_gather'] == 1
        # backend.device_summary reports the rank and the world size
        assert (out['summary']['rank'], out['summary']['world_size']) == \
            (r, 4)


def test_bad_batch_size_and_padding():
    import types
    from quanonet_torch.parallel.comm import Group
    with pytest.raises(ValueError, match="divide evenly"):
        make_dp_run_segment(torch.nn.Linear(1, 1), None,
                            types.SimpleNamespace(rank=0, world=8), 100,
                            30, 1)
    arrays, outputs, real = pad_to_devices((np.arange(5.0)[:, None],),
                                           np.arange(5.0)[:, None], 4)
    assert real == 5 and outputs.shape[0] == 8
    np.testing.assert_array_equal(outputs[5:, 0], [0.0, 1.0, 2.0])
    run, _ = make_dp_run_segment(torch.nn.Linear(3, 1), None, Group(), 10,
                                 5, 1)
    assert run.local_n == 10


def test_rank_failure_and_deadlock_raise():
    """A rank's exception is raised in the caller, its traceback the
    cause; a collective some rank never joins fails at the timeout; every
    rank process is gone after either.  On a CPU-only host, two ranks on
    'cuda' raise naming the card count."""
    with pytest.raises(KeyError, match='rank one fails') as info:
        launch.run_ranks(workers.fail_on_rank1, 2, timeout_s=TIMEOUT_S)
    assert 'rank 1' in str(info.value.__cause__)
    with pytest.raises((TimeoutError, RuntimeError)):
        launch.run_ranks(workers.hang_unless_rank0, 2, timeout_s=4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="0 CUDA device"):
            launch.run_ranks(workers.seed_of, 2, device='cuda', args=(0,))
