"""
The port's pipelined circuit engine (quanonet_torch/parallel/pipeline.py) on
gloo ranks on the CPU, held against the JAX package's make_pipeline_hea on
a W-device virtual mesh and its dense engine under jax.grad: W = 2 and 4
stages, M = 2, 4 and 8 microbatches, a QuanONet and a HEAQNN spec, X and Y
Pauli sums, the stage-local compile against compile-all, dp × pp on a 2 × 2
grid, the hop counts of the GPipe schedule, and the configuration errors
(the JAX tests' test_pipeline_rejects_indivisible_blocks,
test_stage_local_rejects_nonuniform, test_batch_divisibility_errors).

One launch.run_ranks call per W (60 s limit); the JAX side runs in this
process.  Tolerances: outputs 1e-5, gradients 1e-4 × max(1, max|g|).
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
from quanonet_torch.parallel.pipeline import make_pipeline_hea
from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops.hamiltonian import simple_ham_diag, simple_ham_params
from quanonet_tpu.parallel.pipeline import make_pipeline_hea as j_pipeline

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
TIMEOUT_S = 60
BATCH = 16
SPECS = {'Q': (3, (2, 1, 2, 1)), 'H': (4, (4, 2))}


def _spec(pkg, kind):
    nq, net = SPECS[kind]
    return (pkg.quanonet_spec(nq, net) if kind == 'Q'
            else pkg.heaqnn_spec(nq, net))


def _inputs(kind, batch=BATCH, seed=1):
    spec = _spec(j_hea, kind)
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (batch, spec.total_encode)).astype(np.float32)
    return w, x, np.asarray(simple_ham_diag(spec.n_qubits, -5, 5),
                            np.float32)


def _obs(kind, pauli):
    if pauli == 'Z':
        return 0.0, 0.0
    return simple_ham_params(_spec(j_hea, kind).n_qubits, -5.0, 5.0)


def _keys(world):
    keys = [(kind, M, local, 'Z') for kind in SPECS for M in (2, 4, 8)
            for local in (True, False)]
    if world == 2:
        keys += [('Q', 4, True, 'X'), ('Q', 4, True, 'Y')]
    return keys


def _torch_case(kind, M, local, pauli):
    w, x, diag = _inputs(kind)
    return (_spec(t_hea, kind), w, x, diag if pauli == 'Z' else None, M,
            local, pauli, *_obs(kind, pauli))


GRID = [('Q', 2), ('H', 4)]


@pytest.fixture(scope='module')
def runs():
    """{world: ({key: per-rank results}, [grid case per-rank results])}."""
    res = {}
    for world in (2, 4):
        keys = _keys(world)
        grid = [(_spec(t_hea, kind), *_inputs(kind), M)
                for kind, M in GRID] if world == 4 else []
        ranks = launch.run_ranks(workers.pipe_cases, world,
                                 args=([_torch_case(*k) for k in keys],
                                       grid),
                                 timeout_s=TIMEOUT_S)
        res[world] = ({k: [r[0][i] for r in ranks]
                       for i, k in enumerate(keys)},
                      [[r[1][i] for r in ranks] for i in range(len(grid))])
    return res


@functools.lru_cache(maxsize=None)
def _reference(kind, pauli):
    """The JAX dense engine's output and jax.grad of sum(out²)."""
    spec = _spec(j_hea, kind)
    w, x, diag = _inputs(kind)
    offset, coeff = _obs(kind, pauli)
    obs = (dict(diag=jnp.asarray(diag)) if pauli == 'Z' else
           dict(pauli=pauli, offset=offset, coeff=coeff))

    def f(w_, x_):
        return j_hea.hea_expectation(spec, w_, x_, engine='dense', **obs)
    wj, xj = jnp.asarray(w), jnp.asarray(x)
    gw, gx = jax.jit(jax.grad(lambda w_, x_: jnp.sum(f(w_, x_) ** 2),
                              argnums=(0, 1)))(wj, xj)
    return np.asarray(jax.jit(f)(wj, xj)), np.asarray(gw), np.asarray(gx)


@functools.lru_cache(maxsize=None)
def _jax_pipeline(kind, world, M, pauli='Z'):
    w, x, diag = _inputs(kind)
    mesh = Mesh(mesh_utils.create_device_mesh(
        (world,), devices=jax.devices()[:world]), ('pipe',))
    offset, coeff = _obs(kind, pauli)
    f = j_pipeline(_spec(j_hea, kind), mesh, n_microbatches=M, pauli=pauli,
                   offset=offset, coeff=coeff)
    return np.asarray(f(jnp.asarray(w), jnp.asarray(x),
                        jnp.asarray(diag if pauli == 'Z'
                                    else np.zeros_like(diag))))


def _check(per_rank, ref):
    out, gw, gx = ref
    for r in per_rank:
        np.testing.assert_allclose(r[0], out, rtol=0, atol=OUT_TOL)
        for got, want in ((r[1], gw), (r[2], gx)):
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=GRAD_TOL * max(1.0, np.abs(want).max()))
    for r in per_rank[1:]:       # every rank holds the same bits
        for a, b in zip(r[:3], per_rank[0][:3]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ['Q', 'H'])
@pytest.mark.parametrize("M", [2, 4, 8])
def test_pipeline_matches_jax(runs, world, kind, M):
    per_rank = runs[world][0][(kind, M, True, 'Z')]
    _check(per_rank, _reference(kind, 'Z'))
    if M == 4 and (kind == 'Q' or world == 2):   # (XLA compiles slowly)
        np.testing.assert_allclose(per_rank[0][0],
                                   _jax_pipeline(kind, world, M), rtol=0,
                                   atol=OUT_TOL)
    # the GPipe schedule: M + P - 1 hops forward, one fewer backward (the
    # first tick's input is the zero carry) on every rank
    for r in per_rank:
        assert (r[3], r[4]) == (M + world - 1, M + world - 2)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ['Q', 'H'])
def test_stage_local_equals_compile_all(runs, world, kind):
    for M in (2, 4, 8):
        local = runs[world][0][(kind, M, True, 'Z')]
        full = runs[world][0][(kind, M, False, 'Z')]
        _check(full, _reference(kind, 'Z'))
        for a, b in zip(local, full):
            for u, v in zip(a[:3], b[:3]):
                np.testing.assert_allclose(u, v, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("pauli", ['X', 'Y'])
def test_pipeline_pauli_xy(runs, pauli):
    per_rank = runs[2][0][('Q', 4, True, pauli)]
    _check(per_rank, _reference('Q', pauli))
    if pauli == 'X':
        np.testing.assert_allclose(per_rank[0][0],
                                   _jax_pipeline('Q', 2, 4, pauli), rtol=0,
                                   atol=OUT_TOL)


@pytest.mark.parametrize("case", range(len(GRID)))
def test_dp_times_pp_grid(runs, case):
    """2 data ranks × 2 stages: the batch split over 'data', each half
    pipelined over 'pipe', the result gathered back; gradients summed over
    both axes."""
    kind, _ = GRID[case]
    _check(runs[4][1][case], _reference(kind, 'Z'))


def test_configuration_errors():
    spec = t_hea.quanonet_spec(3, (2, 1, 2, 1))         # 4 blocks
    with pytest.raises(ValueError, match="not divisible by pipeline"):
        make_pipeline_hea(spec, types.SimpleNamespace(rank=0, world=3))
    nonuniform = t_hea.HEASpec(3, ((3, 1), (3, 2)))
    with pytest.raises(ValueError, match="uniform block"):
        make_pipeline_hea(nonuniform, comm.Group(), stage_local_compile=True)
    w, x, diag = _inputs('Q', batch=6)
    f = make_pipeline_hea(spec, comm.Group(), n_microbatches=4)
    with pytest.raises(ValueError, match="n_microbatches=4"):
        f(torch.tensor(w), torch.tensor(x), diag)
    fd = make_pipeline_hea(spec, comm.Group(), n_microbatches=2,
                           data=types.SimpleNamespace(rank=0, world=4))
    with pytest.raises(ValueError, match="data-axis size 4"):
        fd(torch.tensor(w), torch.tensor(x), diag)


def test_world_one_is_the_chain():
    """One stage on a world-1 group: the pipeline is the plain chain."""
    spec = t_hea.quanonet_spec(3, (2, 1, 2, 1))
    w, x, diag = _inputs('Q', batch=8)
    f = make_pipeline_hea(spec, comm.Group(), n_microbatches=2)
    got = f(torch.tensor(w), torch.tensor(x), diag)
    want = t_hea.hea_expectation(spec, torch.tensor(w), torch.tensor(x),
                                 diag=diag, engine='dense')
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=OUT_TOL)
