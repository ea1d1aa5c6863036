"""
The port's amplitude-sharded engine (quanonet_torch/parallel/amplitude.py)
on gloo ranks on the CPU, held against the JAX package's
hea_expectation_sharded on a W-device virtual mesh and its single-device
engine, and against jax.grad: W = 2 and 4, the per-gate body and the
grouped-kron local path, a QuanONet and a HEAQNN spec, X and Y Pauli sums,
the exchange count against sharded_collective_counts, the world-1
virtual_global timing mode, and the configuration errors.

Every multi-rank case runs in one launch.run_ranks call per W (60 s
limit); the JAX side runs in this process (its sharded engine on the
fused path, and the per-gate body at Q3: XLA takes ~10 s to compile each
larger per-gate program; every case is also held against the JAX
single-device engine).  Tolerances: outputs 1e-5
(fp32, other summation order), gradients 1e-4 × max(1, max|g|).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import mesh_utils
from jax.sharding import Mesh

import torch_dist_workers as workers
from quanonet_torch.ops import hea as t_hea
from quanonet_torch.parallel import comm, launch
from quanonet_torch.parallel import amplitude as t_amp
from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops.hamiltonian import simple_ham_diag, simple_ham_params
from quanonet_tpu.parallel.amplitude import hea_expectation_sharded

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
TIMEOUT_S = 60
CASES = [('Q', 3, (2, 1, 2, 1)), ('Q', 5, (2, 2, 2, 2)), ('H', 4, (3, 2))]


def _spec(pkg, kind, nq, net):
    return (pkg.quanonet_spec(nq, net) if kind == 'Q'
            else pkg.heaqnn_spec(nq, net))


def _inputs(kind, nq, net, batch=3, seed=0):
    spec = _spec(j_hea, kind, nq, net)
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (batch, spec.total_encode)).astype(np.float32)
    return w, x, np.asarray(simple_ham_diag(nq, -5, 5), np.float32)


def _jax_mesh(n):
    return Mesh(mesh_utils.create_device_mesh((n,),
                                              devices=jax.devices()[:n]),
                ('amp',))


def _case_list(world):
    """(key, torch case) for every check run on ``world`` ranks."""
    out = []
    for kind, nq, net in CASES:
        w, x, diag = _inputs(kind, nq, net)
        for fused in (False, True):
            out.append(((kind, nq, net, fused, 'Z'),
                        (_spec(t_hea, kind, nq, net), w, x, diag, fused,
                         'Z', 0.0, 0.0)))
    if world == 2:
        w, x, _ = _inputs('Q', 4, (2, 1, 2, 1))
        off, coeff = simple_ham_params(4, -5.0, 5.0)
        for pauli in ('X', 'Y'):
            for fused in (False, True):
                out.append((('Q', 4, (2, 1, 2, 1), fused, pauli),
                            (t_hea.quanonet_spec(4, (2, 1, 2, 1)), w, x,
                             None, fused, pauli, off, coeff)))
    return out


@pytest.fixture(scope='module')
def runs():
    """{world: {key: (out, w̄, x̄, exchanges fwd, bwd) per rank}}."""
    res = {}
    for world in (2, 4):
        cases = _case_list(world)
        ranks = launch.run_ranks(workers.amp_cases, world,
                                 args=([c for _, c in cases],),
                                 timeout_s=TIMEOUT_S)
        res[world] = {key: [r[i] for r in ranks]
                      for i, (key, _) in enumerate(cases)}
    return res


@functools.lru_cache(maxsize=None)
def _reference(kind, nq, net, pauli):
    """JAX single-device output and jax.grad of sum(out²) in w and x."""
    spec = _spec(j_hea, kind, nq, net)
    if pauli == 'Z':
        w, x, diag = _inputs(kind, nq, net)
        obs = dict(diag=jnp.asarray(diag))
    else:
        w, x, _ = _inputs(kind, nq, net)
        off, coeff = simple_ham_params(nq, -5.0, 5.0)
        obs = dict(pauli=pauli, offset=off, coeff=coeff)

    def f(w_, x_):
        return j_hea.hea_expectation(spec, w_, x_, engine='dense', **obs)
    wj, xj = jnp.asarray(w), jnp.asarray(x)
    gw, gx = jax.jit(jax.grad(lambda w_, x_: jnp.sum(f(w_, x_) ** 2),
                              argnums=(0, 1)))(wj, xj)
    return np.asarray(jax.jit(f)(wj, xj)), np.asarray(gw), np.asarray(gx)


def _close_grad(got, want):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=GRAD_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fused", [False, True])
def test_amp_matches_jax(runs, world, case, fused):
    kind, nq, net = case
    got = runs[world][(kind, nq, net, fused, 'Z')]
    out, gw, gx = _reference(kind, nq, net, 'Z')
    if fused or nq == 3:     # (XLA compiles JAX's per-gate body slowly)
        w, x, diag = _inputs(kind, nq, net)
        sharded = np.asarray(hea_expectation_sharded(
            _spec(j_hea, kind, nq, net), jnp.asarray(w), jnp.asarray(x),
            jnp.asarray(diag), _jax_mesh(world), fused=fused))
        for r in got:
            np.testing.assert_allclose(r[0], sharded, rtol=0, atol=OUT_TOL)
    for r in got:            # every rank holds the whole result
        np.testing.assert_allclose(r[0], out, rtol=0, atol=OUT_TOL)
        _close_grad(r[1], gw)
        _close_grad(r[2], gx)
    for r in got[1:]:        # and the same bits
        for a, b in zip(r[:3], got[0][:3]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pauli", ['X', 'Y'])
@pytest.mark.parametrize("fused", [False, True])
def test_amp_pauli_xy(runs, pauli, fused):
    got = runs[2][('Q', 4, (2, 1, 2, 1), fused, pauli)]
    out, gw, gx = _reference('Q', 4, (2, 1, 2, 1), pauli)
    if fused:
        w, x, _ = _inputs('Q', 4, (2, 1, 2, 1))
        off, coeff = simple_ham_params(4, -5.0, 5.0)
        sharded = np.asarray(hea_expectation_sharded(
            j_hea.quanonet_spec(4, (2, 1, 2, 1)), jnp.asarray(w),
            jnp.asarray(x), None, _jax_mesh(2), fused=True, pauli=pauli,
            offset=off, coeff=coeff))
        for r in got:
            np.testing.assert_allclose(r[0], sharded, rtol=0, atol=OUT_TOL)
    for r in got:
        np.testing.assert_allclose(r[0], out, rtol=0, atol=OUT_TOL)
        _close_grad(r[1], gw)
        _close_grad(r[2], gx)


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_count_is_the_model(runs, world):
    """Forward exchanges equal sharded_collective_counts on every rank and
    case; the backward repeats those whose result is used."""
    for (kind, nq, net, fused, pauli), per_rank in runs[world].items():
        want = t_amp.sharded_collective_counts(
            _spec(t_hea, kind, nq, net), world, pauli)['ppermutes']
        for r in per_rank:
            assert r[3] == want, (kind, nq, net, fused, pauli)
            # a both-global CNOT's exchange is used, and so sent back, only
            # on ranks whose control bit is 1 (their partners share it)
            assert 0 < r[4] <= want


def test_collective_model_against_jax():
    """The model's names and bytes are the JAX package's; its ring term is
    k per sublayer where JAX's model counts k + 1 (its engine, like this
    one, moves k: the wrap link is one of the k)."""
    from quanonet_tpu.parallel.amplitude import sharded_collective_counts
    for nq, net, n_dev in ((5, (2, 2, 2, 2), 4), (3, (2, 1, 2, 1), 8)):
        j = sharded_collective_counts(j_hea.quanonet_spec(nq, net), n_dev)
        t = t_amp.sharded_collective_counts(t_hea.quanonet_spec(nq, net),
                                            n_dev)
        k = n_dev.bit_length() - 1
        subs = t_hea.quanonet_spec(nq, net).total_sublayers
        assert j['ppermutes'] - t['ppermutes'] == subs
        assert t['psums'] == j['psums'] == 1
        assert t['bytes_per_sample'] == t['ppermutes'] * 2 ** (nq - k) * 8
    with pytest.raises(ValueError, match="power of 2"):
        t_amp.sharded_collective_counts(t_hea.quanonet_spec(5, (2, 2, 2, 2)),
                                        3)


def test_virtual_global_k0_is_the_circuit():
    spec = t_hea.quanonet_spec(5, (2, 2, 2, 2))
    w, x, diag = _inputs('Q', 5, (2, 2, 2, 2), batch=4)
    f = t_amp.make_sharded_hea(spec, comm.Group(), fused=True,
                               virtual_global=0)
    got = f(torch.tensor(w), torch.tensor(x), diag).numpy()
    want = np.asarray(j_hea.hea_expectation(
        _spec(j_hea, 'Q', 5, (2, 2, 2, 2)), jnp.asarray(w), jnp.asarray(x),
        diag=jnp.asarray(diag), engine='fused'))
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


def test_virtual_global_runs_one_shard():
    """k = 2 runs one shard's work (2^(n-2) states) with no-op exchanges,
    counted as a 4-way run's; its output is a gauge variant, finite."""
    spec = t_hea.quanonet_spec(6, (2, 2, 2, 2))
    w, x, diag = _inputs('Q', 6, (2, 2, 2, 2), batch=4)
    group = comm.Group()
    f = t_amp.make_sharded_hea(spec, group, fused=True, virtual_global=2)
    out = f(torch.tensor(w), torch.tensor(x), diag[:16])
    assert out.shape == (4, 1) and torch.isfinite(out).all()
    assert group.counts['exchange'] == \
        t_amp.sharded_collective_counts(spec, 4)['ppermutes']
    with pytest.raises(ValueError, match="1-device"):
        t_amp.make_sharded_hea(spec, types.SimpleNamespace(rank=0, world=2),
                               virtual_global=2)
    with pytest.raises(ValueError, match="Z-basis"):
        t_amp.make_sharded_hea(spec, group, virtual_global=1, pauli='X')


def test_configuration_errors():
    """Non-power-of-two and too many devices raise (the JAX tests'
    test_rejects_non_power_of_two, test_rejects_too_many_devices); so
    does the fused path on a non-uniform encode."""
    with pytest.raises(ValueError, match="power of 2"):
        t_amp.make_sharded_hea(t_hea.quanonet_spec(3, (1, 1, 1, 1)),
                               types.SimpleNamespace(rank=0, world=3))
    with pytest.raises(ValueError, match="devices"):
        t_amp.make_sharded_hea(t_hea.quanonet_spec(2, (1, 1, 1, 1)),
                               types.SimpleNamespace(rank=0, world=8))
    spec = t_hea.HEASpec(3, ((2, 1), (3, 1)))
    with pytest.raises(ValueError, match="uniform encode"):
        t_amp.make_sharded_hea(spec, comm.Group(), fused=True)
    with pytest.raises(ValueError, match="pauli"):
        t_amp.make_sharded_hea(spec, comm.Group(), pauli='W')
