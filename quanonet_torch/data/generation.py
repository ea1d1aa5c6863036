"""
Ground-truth data generation: GRF input sampling + ODE/PDE solvers (the
port's own copy of quanonet_tpu/data/generation.py, host path only).

Host-side NumPy/SciPy, the same code as the JAX package's host path, so
the same global NumPy seed gives the same bytes and the raw caches are
shared (reference data_utils/data_generation.py).  Two deliberate speedups
over the reference, both kept from the JAX package: the GRF covariance
Cholesky factor is cached per length scale (identical samples for the same
randn stream), and the PDE stencils are vectorised.

Randomness uses the global NumPy RNG, matching the reference's seeding
contract (utils/common.py:154-181: np.random.seed at launch).  The raw
caches are guarded by an ``fcntl`` file lock (the ``filelock`` package is
not needed).

``use_native`` (or ``QUANONET_NATIVE=1``) routes the ODE solves and the
Advection / RDiffusion stencils through the C++ library (data/native.py):
RK4 against SciPy's RK45 at ~1e-3, float32 stencils against the float64
host ones at ~1e-4, so their raw caches carry a ``_rk4`` / ``_native``
tag and never mix with the byte-contract files.  Asked for, the native
path runs or raises (the JAX package falls back to SciPy there).  The
on-device generators are data/device_gen.py.
"""
import fcntl
import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import lru_cache
from multiprocessing import cpu_count

import numpy as np
from scipy.integrate import solve_ivp
from scipy.interpolate import RegularGridInterpolator, interp1d


@contextmanager
def _file_lock(path):
    """Exclusive advisory lock on ``path`` for the ``with`` block."""
    with open(path, 'a') as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


# ── Gaussian random field ────────────────────────────────────────────────────

_GRF_N = 1024
_GRF_JITTER = 1e-10


@lru_cache(maxsize=8)
def _grf_cholesky(length_scale: float) -> np.ndarray:
    """Cholesky factor of the RBF kernel on the fixed 1024-point grid
    (reference data_generation.py:19-56 recomputes this per sample)."""
    x = np.linspace(0, 1, _GRF_N)
    r2 = (x[:, None] - x[None, :]) ** 2
    k = np.exp(-0.5 * r2 / (length_scale ** 2))
    return np.linalg.cholesky(k + _GRF_JITTER * np.eye(_GRF_N))


def generate_random_gaussian_field(m, length_scale=0.2):
    """Sample one GRF; returns (interp function, values at m points)."""
    L = _grf_cholesky(float(length_scale))
    gp_sample = L @ np.random.randn(_GRF_N)
    grid = np.linspace(0, 1, _GRF_N)
    u_fn = lambda x: np.interp(x, grid, gp_sample)
    return u_fn, u_fn(np.linspace(0, 1, m))


# ── ODE systems (reference data_generation.py:67-84) ─────────────────────────

ODE_SYSTEMS = {
    'Antideriv': {
        'description': 'du/dx = u0(x)',
        'ode_func': lambda u0_fn: lambda x, u: u0_fn(x),
    },
    'Homogeneous': {
        'description': 'du/dx = u + u0(x)',
        'ode_func': lambda u0_fn: lambda x, u: u + u0_fn(x),
    },
    'Nonlinear': {
        'description': 'du/dx = u0(x) - u^3',
        'ode_func': lambda u0_fn: lambda x, u: -u ** 3 + u0_fn(x),
    },
    'Identity': {
        'description': 'u = u0(x)',
        'ode_func': None,
    },
}

DATA_ROOT = os.environ.get('QUANONET_DATA_ROOT', 'data')


def _resolve_native(use_native):
    """The use_native tri-state: None defers to ``QUANONET_NATIVE=1``."""
    if use_native is None:
        use_native = os.environ.get('QUANONET_NATIVE') == '1'
    return bool(use_native)


def _native_ode_solve(operator_type, samples, num_cal, u_cals, u0_cals):
    """The C++ batched RK4 of every sample (data/native.py), each sample's
    input evaluated on the high-resolution grid first."""
    from quanonet_torch.data.native import solve_ode_batch_native
    grid = np.linspace(0, 1, _GRF_N)
    u0_full = np.stack([fn(grid) for fn, _ in samples]).astype(np.float32)
    u = solve_ode_batch_native(operator_type, u0_full, num_cal)
    for i, (_, u0_cal) in enumerate(samples):
        u_cals.append(u[i].astype(np.float64))
        u0_cals.append(u0_cal)


def _native_pde_solve(operator_type, total_needed, num_cal, length_scale,
                      input_sampler, u_cals, u0_cals):
    """The C++ batched stencil of Advection / RDiffusion (data/native.py)
    on ``total_needed`` sequential GRF draws, as the host loop draws them;
    NaN samples are skipped."""
    from quanonet_torch.data.native import (
        solve_advection_batch_native, solve_rdiffusion_batch_native,
    )
    batch_solver = {'Advection': solve_advection_batch_native,
                    'RDiffusion': solve_rdiffusion_batch_native,
                    }[operator_type]
    sampler = input_sampler or (
        lambda n: generate_random_gaussian_field(n, length_scale))
    u0s = np.stack([sampler(num_cal)[1] for _ in range(total_needed)])
    us = batch_solver(u0s.astype(np.float32))
    for i in range(total_needed):
        if np.isnan(us[i]).any():
            continue
        u_cals.append(us[i].astype(np.float64))
        u0_cals.append(u0s[i])


def generate_ode_operator_data(operator_type, num_train, num_test,
                               num_points, num_points_0,
                               length_scale=0.2, num_cal=1000,
                               input_sampler=None, use_native=None):
    """GRF inputs -> RK45 solutions, dual-resolution interpolation, random
    train/test split (reference data_generation.py:87-206).  Raw solutions
    are cached on disk under a file lock unless input_sampler is given.

    use_native: True routes the solves through the C++ batched RK4
    (data/native.py), raw cache ``..._rk4.npz``; None defers to
    QUANONET_NATIVE=1."""
    if operator_type not in ODE_SYSTEMS:
        raise ValueError(f"Unknown operator type: {operator_type}")
    ode_func_generator = ODE_SYSTEMS[operator_type]['ode_func']
    use_native = _resolve_native(use_native)
    cache_tag = '_rk4' if use_native else ''

    data_path = os.path.join(
        DATA_ROOT, f'{operator_type}_Operator_data',
        f'{operator_type}_Operator_data_{num_cal}_1{cache_tag}.npz')
    os.makedirs(os.path.dirname(data_path), exist_ok=True)
    x_cal = np.linspace(0, 1, num_cal)

    with _file_lock(data_path + '.lock'):
        if input_sampler is None and os.path.exists(data_path):
            d = np.load(data_path, allow_pickle=True)
            u_cals = list(d['u_cals']) if 'u_cals' in d else []
            u0_cals = list(d['u0_cals']) if 'u0_cals' in d else []
        else:
            u_cals, u0_cals = [], []

        if len(u_cals) < num_train + num_test:
            total_needed = num_train + num_test - len(u_cals)
            sampler = input_sampler or (
                lambda n: generate_random_gaussian_field(n, length_scale))
            samples = [sampler(num_cal) for _ in range(total_needed)]

            if operator_type == 'Identity':
                for _, u0 in samples:
                    u_cals.append(u0.copy())
                    u0_cals.append(u0)
            elif use_native:
                _native_ode_solve(operator_type, samples, num_cal, u_cals,
                                  u0_cals)
            else:
                def _solve_one(args):
                    u0_fn, u0_cal = args
                    try:
                        sol = solve_ivp(ode_func_generator(u0_fn), [0, 1],
                                        [0], t_eval=x_cal, method='RK45')
                        return sol.y[0], u0_cal
                    except Exception:   # bad-sample tolerance, as upstream
                        return None, None

                n_workers = max(1, min(cpu_count(), total_needed))
                with ThreadPoolExecutor(max_workers=n_workers) as ex:
                    results = list(ex.map(_solve_one, samples))
                for u_cal, u0_cal in results:
                    if u_cal is not None:
                        u_cals.append(u_cal)
                        u0_cals.append(u0_cal)

            if input_sampler is None:
                np.savez(data_path, u_cals=u_cals, u0_cals=u0_cals)

    x_target = np.linspace(0, 1, num_points)
    x_target_0 = np.linspace(0, 1, num_points_0)
    us, u0s = [], []
    for u_cal, u0_cal in zip(u_cals, u0_cals):
        us.append(interp1d(x_cal, u_cal, kind='linear', bounds_error=False,
                           fill_value='extrapolate')(x_target))
        u0s.append(interp1d(x_cal, u0_cal, kind='linear', bounds_error=False,
                            fill_value='extrapolate')(x_target_0))

    train_index = np.random.choice(num_train + num_test, num_train,
                                   replace=False)
    test_index = np.setdiff1d(np.arange(num_train + num_test), train_index)
    u0s = np.array(u0s)
    us = np.array(us)
    return (u0s[train_index].astype(np.float32),
            us[train_index].astype(np.float32),
            u0s[test_index].astype(np.float32),
            us[test_index].astype(np.float32),
            x_target.astype(np.float32))


# ── PDE solvers (reference data_generation.py:224-352) ──────────────────────

def solve_darcy_pde(num_cal, length_scale=1.0, K=0.1, f=-1.0, u0_cal=None):
    """-∇·(K∇u)=f on the unit square with GRF Dirichlet boundary built from
    a 1-D field of length 4*num_cal (reference data_generation.py:224-263)."""
    from scipy.sparse import diags
    from scipy.sparse.linalg import spsolve
    nx = ny = num_cal
    dx = dy = 1.0 / (nx - 1)
    if u0_cal is None:
        _, u0_cal = generate_random_gaussian_field(4 * num_cal,
                                                   length_scale=length_scale)
    edge = len(u0_cal) // 4
    left = u0_cal[:edge]
    top = u0_cal[edge:2 * edge]
    right = u0_cal[2 * edge:3 * edge][::-1]
    bottom = u0_cal[3 * edge:][::-1]

    N = nx * ny
    main = np.full(N, -2 / dx ** 2 - 2 / dy ** 2)
    offx = np.full(N, 1 / dx ** 2)
    offy = np.full(N, 1 / dy ** 2)
    rhs = np.full(N, -f / K)

    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing='ij')
    idx = (ii * ny + jj).ravel()
    # precedence mirrors the reference's if/elif chain: bottom, top, left, right
    bmask = (jj == 0).ravel()
    tmask = (jj == ny - 1).ravel() & ~bmask
    lmask = ((ii == 0).ravel()) & ~bmask & ~tmask
    rmask = ((ii == nx - 1).ravel()) & ~bmask & ~tmask & ~lmask
    for mask, vals, coord in ((bmask, bottom, ii.ravel()),
                              (tmask, top, ii.ravel()),
                              (lmask, left, jj.ravel()),
                              (rmask, right, jj.ravel())):
        sel = idx[mask]
        main[sel] = 1.0
        offx[sel] = 0.0
        offy[sel] = 0.0
        rhs[sel] = vals[coord[mask]]

    # ±1 neighbours step in jj (y, 1/dy²), ±ny neighbours in ii (x, 1/dx²)
    A = diags([main, offy[:-1], offy[1:], offy[-1], offy[:1],
               offx[:N - ny], offx[ny:], offx[N - ny:], offx[:ny]],
              [0, 1, -1, -N + 1, N - 1, ny, -ny, -N + ny, N - ny],
              shape=(N, N))
    u_cal = spsolve(A.tocsr(), rhs).reshape((nx, ny))
    return u_cal, u0_cal


def solve_advection_pde(num_cal, length_scale=0.2, c=1.0, u0_cal=None):
    """∂u/∂t + c ∂u/∂x = 0, upwind FD with CFL 0.8, periodic boundary
    (reference data_generation.py:265-321); vectorised stencil."""
    dx = 1.0 / (num_cal - 1)
    dt = 0.8 * dx / abs(c) if c != 0 else 0.01
    num_t = int(1.0 / dt)
    if u0_cal is None:
        _, u0_cal = generate_random_gaussian_field(num_cal,
                                                   length_scale=length_scale)
    u_cal = np.zeros((num_cal, num_t))
    u_cal[:, 0] = u0_cal
    lam = c * dt / dx
    for j in range(1, num_t):
        u = u_cal[:, j - 1]
        if c > 0:
            u_cal[:, j] = u - lam * (u - np.roll(u, 1))
        elif c < 0:
            u_cal[:, j] = u - lam * (np.roll(u, -1) - u)
        else:
            u_cal[:, j] = u

    if num_t > num_cal:
        t_idx = np.linspace(0, num_t - 1, num_cal, dtype=int)
        u_sampled = u_cal[:, t_idx]
    else:
        t_old = np.linspace(0, 1, num_t)
        t_new = np.linspace(0, 1, num_cal)
        f = interp1d(t_old, u_cal, axis=1, kind='linear',
                     bounds_error=False, fill_value='extrapolate')
        u_sampled = f(t_new)
    return u_sampled, u0_cal


def solve_rdiffusion_pde(num_cal, length_scale, D=0.01, k=0.01, u0_cal=None):
    """∂u/∂t = D ∂²u/∂x² + k u² + u0(x), explicit Euler, Dirichlet-0
    (reference data_generation.py:323-352); vectorised stencil, including
    the reference's early-time subsampling quirk."""
    x_cal = np.linspace(0, 1, num_cal)
    t_cal = np.linspace(0, 1, num_cal)
    dx = x_cal[1] - x_cal[0]
    dt = min(dx ** 2 / (2 * D), t_cal[1] - t_cal[0])
    num_cal_t = int(1 // dt)
    if u0_cal is None:
        _, u0_cal = generate_random_gaussian_field(num_cal,
                                                   length_scale=length_scale)
    u_cal = np.zeros((num_cal, num_cal_t))
    for i in range(1, num_cal_t):
        u = u_cal[:, i - 1]
        nxt = np.zeros_like(u)
        nxt[1:-1] = u[1:-1] + dt * (
            D * (u[2:] - 2 * u[1:-1] + u[:-2]) / dx ** 2
            + k * u[1:-1] ** 2 + u0_cal[1:-1])
        u_cal[:, i] = nxt
    step = max(1, num_cal_t // num_cal)
    return u_cal[:, ::step][:, :num_cal], u0_cal


_PDE_SOLVERS = {
    'Darcy': solve_darcy_pde,
    'Advection': solve_advection_pde,
    'RDiffusion': solve_rdiffusion_pde,
}

PDE_OPERATORS = tuple(_PDE_SOLVERS)
ODE_OPERATORS = tuple(ODE_SYSTEMS)


def generate_pde_operator_data(operator_type, num_train, num_test,
                               num_points, num_points_0,
                               length_scale=0.2, num_cal=100,
                               input_sampler=None, use_native=None):
    """PDE analogue of generate_ode_operator_data
    (reference data_generation.py:355-480): NaN samples skipped, periodic
    cache save, 2-D grid interpolation onto num_points x num_points.

    use_native: True routes Advection / RDiffusion through the C++ batched
    stencils (data/native.py), raw cache ``..._native.npz``; Darcy always
    takes the host sparse solve.  None defers to QUANONET_NATIVE=1."""
    if operator_type not in _PDE_SOLVERS:
        raise ValueError(f"Unknown PDE operator: {operator_type}")
    solver = _PDE_SOLVERS[operator_type]
    use_native = operator_type != 'Darcy' and _resolve_native(use_native)
    cache_tag = '_native' if use_native else ''

    data_path = os.path.join(
        DATA_ROOT, f'{operator_type}_Operator_data',
        f'{operator_type}_Operator_data_{num_cal}_1{cache_tag}.npz')
    os.makedirs(os.path.dirname(data_path), exist_ok=True)

    with _file_lock(data_path + '.lock'):
        if input_sampler is None and os.path.exists(data_path):
            try:
                d = np.load(data_path, allow_pickle=True)
                u_cals = list(d['u_cals']) if 'u_cals' in d else []
                u0_cals = list(d['u0_cals']) if 'u0_cals' in d else []
            except (OSError, ValueError):   # unreadable cache: regenerate
                u_cals, u0_cals = [], []
        else:
            u_cals, u0_cals = [], []

        if len(u_cals) < num_train + num_test:
            total_needed = num_train + num_test - len(u_cals)
            save_interval = 100
            if use_native:
                _native_pde_solve(operator_type, total_needed, num_cal,
                                  length_scale, input_sampler, u_cals,
                                  u0_cals)
                if input_sampler is None:
                    np.savez(data_path, u_cals=u_cals, u0_cals=u0_cals)
                total_needed = 0
            for i in range(total_needed):
                try:
                    u0_override = None
                    if input_sampler is not None:
                        _, u0_override = input_sampler(num_cal)
                    u_new, u0_new = solver(num_cal, length_scale=length_scale,
                                           u0_cal=u0_override)
                    if np.isnan(u_new).any():
                        continue
                    u_cals.append(u_new)
                    u0_cals.append(u0_new)
                except Exception as e:   # bad-sample tolerance, as upstream
                    print(f"Error solving PDE: {e}")
                    continue
                if input_sampler is None and (
                        (i + 1) % save_interval == 0 or i == total_needed - 1):
                    np.savez(data_path, u_cals=u_cals, u0_cals=u0_cals)

    if len(u_cals) < num_train + num_test:
        raise RuntimeError(
            f"PDE generation produced only {len(u_cals)} valid samples "
            f"(NaN/solver failures skipped) but num_train+num_test="
            f"{num_train + num_test}. Delete the raw cache and regenerate, "
            f"or lower num_train/num_test.")

    x_target = np.linspace(0, 1, num_points)
    t_target = np.linspace(0, 1, num_points)
    x_target_0 = np.linspace(0, 1, num_points_0)
    us, u0s = [], []
    for u_cal, u0_cal in zip(u_cals, u0_cals):
        if u0_cal.ndim == 1:
            u0_new = np.interp(x_target_0,
                               np.linspace(0, 1, len(u0_cal)), u0_cal)
        else:
            u0_new = u0_cal
        if u_cal.ndim == 2:
            sx = np.linspace(0, 1, u_cal.shape[0])
            st = np.linspace(0, 1, u_cal.shape[1])
            f = RegularGridInterpolator((sx, st), u_cal, method='linear',
                                        bounds_error=False, fill_value=None)
            xg, tg = np.meshgrid(x_target, t_target, indexing='ij')
            u_new = f((xg, tg))
        else:
            u_new = np.interp(x_target,
                              np.linspace(0, 1, len(u_cal)), u_cal)
        us.append(u_new)
        u0s.append(u0_new)

    train_index = np.random.choice(num_train + num_test, num_train,
                                   replace=False)
    test_index = np.setdiff1d(np.arange(num_train + num_test), train_index)
    u0s = np.array(u0s)
    us = np.array(us)
    return (u0s[train_index].astype(np.float32),
            us[train_index].astype(np.float32),
            u0s[test_index].astype(np.float32),
            us[test_index].astype(np.float32),
            x_target.astype(np.float32),
            t_target.astype(np.float32))
