"""
Data generation on the device in the port (quanonet_torch/data/
device_gen.py), run here on the CPU, held against the JAX package's
quanonet_tpu/data/device_gen.py on equal NumPy inputs (RK4, advection and
reaction-diffusion 1e-5; Darcy's CG 1e-4: its whole-batch dot products
sum in another order) and against the host generators at
tests/test_device_gen.py's limits (RK4 against SciPy's RK45 5e-3, the
stencils 1e-4, Darcy against the sparse solve 2e-3).  GRF draws come from
torch's generators, so sample_grf is held by distribution: mean, variance
and the covariance of the host sampler's kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quanonet_torch.data.generation as t_gen
from quanonet_tpu.data import device_gen as j_dg
from quanonet_tpu.data.manager import DataManager as JDataManager
from quanonet_torch.data import device_gen as t_dg
from quanonet_torch.data.manager import DataManager

SOLVER_TOL = 1e-5
CG_TOL = 1e-4


@pytest.fixture(autouse=True)
def _data_root(tmp_path, monkeypatch):
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    yield


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("op", ['Antideriv', 'Homogeneous', 'Nonlinear',
                                'Identity'])
def test_rk4_matches_jax(op):
    full = np.random.RandomState(0).randn(4, 1024).astype(np.float32)
    got = t_dg.solve_ode_batch(op, torch.tensor(full), 200).numpy()
    want = np.asarray(j_dg.solve_ode_batch(op, jnp.asarray(full), 200))
    assert got.shape == want.shape == (4, 200)
    np.testing.assert_allclose(got, want, atol=SOLVER_TOL)


@pytest.mark.parametrize("nc", [60, 150], ids=['num_t>num_cal',
                                               'num_t<num_cal'])
def test_stencils_match_jax(nc):
    """Advection resamples its num_t = int(1/dt) states to num_cal columns
    by a gather where num_t > num_cal and by interpolation otherwise; the
    reaction-diffusion keeps every stride-th state."""
    u0 = np.random.RandomState(nc).randn(3, nc).astype(np.float32)
    for name in ('solve_advection_batch', 'solve_rdiffusion_batch'):
        got = getattr(t_dg, name)(torch.tensor(u0)).numpy()
        want = np.asarray(getattr(j_dg, name)(jnp.asarray(u0)))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=SOLVER_TOL, err_msg=name)


def test_darcy_cg_matches_jax_and_its_stopping_rule(monkeypatch):
    u0 = np.random.RandomState(7).randn(3, 4 * 24).astype(np.float32)
    got = t_dg.solve_darcy_batch(torch.tensor(u0)).numpy()
    want = np.asarray(j_dg.solve_darcy_batch(jnp.asarray(u0)))
    assert got.shape == want.shape == (3, 24, 24)
    np.testing.assert_allclose(got, want, atol=CG_TOL)
    # the host reads the residual every CG_CHECK_EVERY iterations; the
    # iterate past the rule is held on the device: the interval does not
    # change the result
    monkeypatch.setattr(t_dg, 'CG_CHECK_EVERY', 1)
    assert torch.equal(t_dg.solve_darcy_batch(torch.tensor(u0)),
                       torch.tensor(got))
    # maxiter bounds the iterations as JAX's does
    few = t_dg.solve_darcy_batch(torch.tensor(u0), cg_maxiter=3).numpy()
    want3 = np.asarray(j_dg.solve_darcy_batch(jnp.asarray(u0),
                                              cg_maxiter=3))
    np.testing.assert_allclose(few, want3, atol=CG_TOL)


def test_grf_by_distribution():
    """Mean ~0, variance ~1, neighbour correlation (tests/
    test_device_gen.py's checks), and the 1024-point samples' covariance
    against the host sampler's kernel L Lᵀ."""
    m, full = t_dg.sample_grf(_gen(0), 4000, 128)
    m, full = m.numpy(), full.numpy().astype(np.float64)
    assert m.shape == (4000, 128) and full.shape == (4000, 1024)
    assert abs(m.mean()) < 0.05
    assert 0.9 < m.var() < 1.1
    assert np.corrcoef(m[:, 60], m[:, 61])[0, 1] > 0.99
    chol = t_gen._grf_cholesky(0.2)
    kernel = chol @ chol.T
    idx = np.arange(0, 1024, 64)
    cov = np.cov(full[:, idx].T)
    assert np.abs(cov - kernel[np.ix_(idx, idx)]).max() < 0.1
    again, _ = t_dg.sample_grf(_gen(0), 4000, 128)
    assert np.array_equal(again.numpy(), m)


@pytest.mark.parametrize("op", ['Antideriv', 'Homogeneous', 'Nonlinear',
                                'Identity'])
def test_ode_matches_scipy(op):
    """tests/test_device_gen.py's case: RK4 against SciPy's RK45 on the
    same input function, 5e-3.  SciPy runs at rtol 1e-9: at its default
    (rtol 1e-3, the host path's) RK45 itself strays up to 7.1e-3 from the
    solution of Homogeneous (which grows as e^x) on some draws, the JAX
    package's RK4 measured with three keys."""
    from scipy.integrate import solve_ivp
    num_cal = 200
    u0_m, u = t_dg.generate_ode_batch(_gen(1), op, 4, num_cal, num_cal,
                                      num_cal=num_cal)
    u0_m, u = u0_m.numpy(), u.numpy()
    x_cal = np.linspace(0, 1, num_cal)
    for b in range(2):
        u0_fn = (lambda v: lambda x: np.interp(x, x_cal, v))(u0_m[b])
        if op == 'Identity':
            np.testing.assert_allclose(u[b], u0_m[b], atol=1e-5)
            continue
        rhs = {'Antideriv': lambda x, y: u0_fn(x),
               'Homogeneous': lambda x, y: y + u0_fn(x),
               'Nonlinear': lambda x, y: -y ** 3 + u0_fn(x)}[op]
        sol = solve_ivp(rhs, [0, 1], [0], t_eval=x_cal, method='RK45',
                        rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(u[b], sol.y[0], atol=5e-3)


def test_pde_solvers_match_the_host_ones():
    np.random.seed(0)
    _, u0 = t_gen.generate_random_gaussian_field(96)
    host_u, _ = t_gen.solve_advection_pde(96, u0_cal=u0)
    dev_u = t_dg.solve_advection_batch(
        torch.tensor(u0, dtype=torch.float32)[None])[0].numpy()
    np.testing.assert_allclose(dev_u, host_u, atol=1e-4)
    np.random.seed(1)
    _, u0 = t_gen.generate_random_gaussian_field(50)
    host_u, _ = t_gen.solve_rdiffusion_pde(50, 0.2, u0_cal=u0)
    dev_u = t_dg.solve_rdiffusion_batch(
        torch.tensor(u0, dtype=torch.float32)[None])[0].numpy()
    assert dev_u.shape == host_u.shape
    np.testing.assert_allclose(dev_u, host_u, atol=1e-4)
    np.random.seed(7)
    _, u0 = t_gen.generate_random_gaussian_field(4 * 24, length_scale=1.0)
    host_u, _ = t_gen.solve_darcy_pde(24, u0_cal=u0)
    dev_u = t_dg.solve_darcy_batch(
        torch.tensor(u0, dtype=torch.float32)[None])[0].numpy()
    np.testing.assert_allclose(dev_u, host_u, atol=2e-3)


def test_batch_shapes_and_contracts():
    u0, u = t_dg.generate_pde_batch(_gen(2), 'Advection', 3, 32, 16,
                                    num_cal=64)
    assert u0.shape == (3, 16) and u.shape == (3, 32, 32)
    u0, u = t_dg.generate_pde_batch(_gen(2), 'Darcy', 2, 20, 12, num_cal=20)
    assert u0.shape == (2, 12) and u.shape == (2, 20, 20)
    assert torch.isfinite(u).all()
    with pytest.raises(ValueError, match='Advection/RDiffusion/Darcy'):
        t_dg.generate_pde_batch(_gen(), 'Antideriv', 2, 8, 8)
    np.random.seed(5)
    out = t_dg.generate_ode_operator_data_device('Antideriv', 5, 3, 12, 6,
                                                 num_cal=50, device='cpu')
    assert [a.shape for a in out] == [(5, 6), (5, 12), (3, 6), (3, 12),
                                      (12,)]
    out = t_dg.generate_pde_operator_data_device('RDiffusion', 4, 2, 10, 8,
                                                 num_cal=20, device='cpu')
    assert [a.shape for a in out] == [(4, 8), (4, 10, 10), (2, 8),
                                      (2, 10, 10), (10,), (10,)]
    with pytest.raises(ValueError, match='input_sampler'):
        t_dg.generate_ode_operator_data_device(
            'Antideriv', 1, 1, 4, 4, input_sampler=lambda n: None,
            device='cpu')


@pytest.mark.parametrize("op,model", [('Antideriv', 'QuanONet'),
                                      ('Advection', 'QuanONet'),
                                      ('Darcy', 'FNO')])
def test_data_manager_device_route(tmp_path, op, model):
    """--datagen device through DataManager on the CPU: the _dgdevice
    cache name (JAX's), the shapes of the host route, a cached reload,
    and one NumPy seed giving one dataset (the device generator is seeded
    from the NumPy RNG)."""
    cfg = dict(operator=op, model_type=model, num_train=4, num_test=2,
               num_points=12, num_points_0=12 if model == 'FNO' else 6,
               train_sample_num=3,
               test_sample_num=3, datagen='device', device='cpu',
               num_cal=24 if op != 'Antideriv' else 60)
    dm = DataManager(cfg, data_dir=str(tmp_path / 'a'))
    name = dm._get_filename()
    assert name.endswith('_dgdevice.npz')
    assert name == JDataManager(cfg)._get_filename()
    np.random.seed(11)
    data = dm.get_data()
    host = DataManager({**cfg, 'datagen': 'host'},
                       data_dir=str(tmp_path / 'h'))
    np.random.seed(11)
    ref = host.get_data()
    assert sorted(data) == sorted(ref)
    for k in data:
        assert data[k].shape == ref[k].shape, k
        assert np.isfinite(data[k]).all(), k
    assert (tmp_path / 'a' / op / name).exists()
    np.random.seed(11)
    again = DataManager(cfg, data_dir=str(tmp_path / 'b')).get_data()
    for k in data:
        assert np.array_equal(again[k], data[k]), k
    cached = DataManager(cfg, data_dir=str(tmp_path / 'a')).get_data()
    assert all(np.array_equal(cached[k], data[k]) for k in data)


def test_device_route_default_device_is_the_card(monkeypatch):
    """Without a device the generator asks for `cuda` (and raises here,
    where there is none), never the CPU silently."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        t_dg.generate_ode_operator_data_device('Antideriv', 1, 1, 4, 4,
                                               num_cal=8)
