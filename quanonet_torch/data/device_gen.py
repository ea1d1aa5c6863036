"""
Data generation on the card (counterpart of quanonet_tpu/data/device_gen.py),
in PyTorch: the ground-truth pipeline of the host path
(data/generation.py) with the same distributions, generated where the
model trains.

* GRF sampling: one (batch, 1024) normal draw times the Cholesky factor of
  the host sampler's covariance, then a linear-interpolation matrix
  (:func:`sample_grf`);
* the ODEs by fixed-step RK4 (:func:`solve_ode_batch`; the host path
  takes SciPy's RK45, both O(h^4) on these smooth inputs);
* Advection (upwind, CFL 0.8, periodic) and reaction-diffusion (explicit
  Euler, the reference's early-time subsampling quirk) as stencil loops
  that keep only the time columns the output reads
  (:func:`solve_advection_batch`, :func:`solve_rdiffusion_batch`);
* Darcy by conjugate gradients on the interior system, the whole batch as
  one vector with jax.scipy.sparse.linalg.cg's stopping rule
  (:func:`solve_darcy_batch`).

The draws come from a ``torch.Generator`` on the device, seeded from the
global NumPy RNG (:func:`_device_generator`), so ``config.set_random_seed``
keeps a run deterministic; the train/test split draws from the NumPy RNG as
the host path's does.  Samples are distribution-equal to the host path's,
not bit-equal, so DataManager caches them under a ``_dgdevice`` name.
Plain tensor code: every op runs on the inputs' device (the card unless
the caller passes ``device='cpu'``), fp32 with TF32 off.
"""
from functools import lru_cache

import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.data.generation import _GRF_N, _grf_cholesky

ODE_NAMES = ('Identity', 'Antideriv', 'Homogeneous', 'Nonlinear')
CG_CHECK_EVERY = 32     # CG iterations between host reads of the residual


@lru_cache(maxsize=16)
def _interp_matrix(n_src: int, n_dst: int) -> np.ndarray:
    """Dense linear-interpolation matrix from linspace(0,1,n_src) to
    linspace(0,1,n_dst): u_dst = u_src @ W.T, W (n_dst, n_src)."""
    x_dst = np.linspace(0, 1, n_dst)
    pos = x_dst * (n_src - 1)
    lo = np.clip(np.floor(pos).astype(int), 0, n_src - 2)
    frac = pos - lo
    w = np.zeros((n_dst, n_src), np.float32)
    w[np.arange(n_dst), lo] = 1.0 - frac
    w[np.arange(n_dst), lo + 1] = frac
    return w


def _interp(n_src, n_dst, like):
    return torch.as_tensor(_interp_matrix(n_src, n_dst), device=like.device)


def sample_grf(generator, batch, m, length_scale=0.2):
    """(batch, m) GRF samples on linspace(0,1,m) and the (batch, 1024)
    samples they interpolate, drawn from ``generator`` on its device: the
    host sampler's covariance (generation.py generate_random_gaussian_field)."""
    dev = generator.device
    chol = torch.as_tensor(_grf_cholesky(float(length_scale)).astype(
        np.float32), device=dev)
    z = torch.randn((batch, _GRF_N), generator=generator, device=dev)
    full = z @ chol.T                                   # (batch, 1024)
    return full @ _interp(_GRF_N, m, full).T, full


def _ode_rhs(name):
    if name == 'Antideriv':
        return lambda u, f: f
    if name == 'Homogeneous':
        return lambda u, f: u + f
    if name == 'Nonlinear':
        return lambda u, f: f - u ** 3
    raise ValueError(name)


def solve_ode_batch(name, u0_full, num_cal):
    """RK4-integrate du/dx = rhs(u, u0(x)) on linspace(0,1,num_cal), y0 = 0:
    u0_full (batch, 1024) -> (batch, num_cal).  The integrand is read at
    the grid points and half-steps through one interpolation matrix."""
    if name == 'Identity':
        return u0_full @ _interp(_GRF_N, num_cal, u0_full).T
    rhs = _ode_rhs(name)
    f_half = u0_full @ _interp(_GRF_N, 2 * num_cal - 1, u0_full).T
    h = 1.0 / (num_cal - 1)
    f0s = f_half[:, 0:-2:2].T.contiguous()              # (num_cal-1, batch)
    fms = f_half[:, 1:-1:2].T.contiguous()
    f1s = f_half[:, 2::2].T.contiguous()
    u = torch.zeros(u0_full.shape[0], dtype=torch.float32,
                    device=u0_full.device)
    traj = [u]
    for f0, fm, f1 in zip(f0s, fms, f1s):
        k1 = rhs(u, f0)
        k2 = rhs(u + 0.5 * h * k1, fm)
        k3 = rhs(u + 0.5 * h * k2, fm)
        k4 = rhs(u + h * k3, f1)
        u = u + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        traj.append(u)
    return torch.stack(traj, 1)                          # (batch, num_cal)


def _keep(num_t, wanted):
    """{time index: [output columns]} of the kept states."""
    keep = {}
    for col, t in enumerate(wanted):
        keep.setdefault(int(t), []).append(col)
    return keep


def _run_stencil(step, u_init, num_t, wanted):
    """States 0 .. num_t-1 of ``u <- step(u)`` from ``u_init``, keeping only
    the time indices ``wanted``: (len(wanted), batch, nc)."""
    keep = _keep(num_t, wanted)
    out = torch.empty((len(wanted),) + tuple(u_init.shape),
                      dtype=u_init.dtype, device=u_init.device)
    u = u_init
    last = max(keep)
    for t in range(last + 1):
        if t:
            u = step(u)
        for col in keep.get(t, ()):
            out[col] = u
    return out


def solve_advection_batch(u0, c=1.0):
    """Vectorised upwind advection (generation.py solve_advection_pde:
    CFL 0.8, periodic, time resampled to num_cal columns): u0 (batch,
    num_cal) -> (batch, x, t).  Where num_t > num_cal only the time
    columns the resampling reads are kept."""
    _, num_cal = u0.shape
    dx = 1.0 / (num_cal - 1)
    dt = 0.8 * dx / abs(c)
    num_t = int(1.0 / dt)
    lam = c * dt / dx

    def step(u):
        return u - lam * (u - torch.roll(u, 1, dims=1))

    if num_t > num_cal:
        t_idx = np.linspace(0, num_t - 1, num_cal).astype(int)
        traj = _run_stencil(step, u0, num_t, t_idx)
    else:
        traj = _run_stencil(step, u0, num_t, np.arange(num_t))
        traj = torch.einsum('ct,tbn->cbn', _interp(num_t, num_cal, u0), traj)
    return traj.permute(1, 2, 0)                         # (batch, x, t)


def solve_rdiffusion_batch(u0, D=0.01, k=0.01):
    """Vectorised explicit-Euler reaction-diffusion (generation.py
    solve_rdiffusion_pde, with the early-time subsampling quirk): u0
    (batch, num_cal) -> (batch, x, t).  Only every stride-th state is
    kept, of num_t ≈ 1/dt steps (about 20,000 at num_cal 1,000: a loop of
    launches on the card)."""
    _, num_cal = u0.shape
    dx = 1.0 / (num_cal - 1)
    dt = min(dx ** 2 / (2 * D), 1.0 / (num_cal - 1))
    num_t = int(1 // dt)
    src = u0[:, 1:-1]

    def step(u):
        lap = (u[:, 2:] - 2 * u[:, 1:-1] + u[:, :-2]) / dx ** 2
        interior = u[:, 1:-1] + dt * (D * lap + k * u[:, 1:-1] ** 2 + src)
        return torch.nn.functional.pad(interior, (1, 1))

    stride = max(1, num_t // num_cal)
    wanted = np.arange(0, num_t, stride)[:num_cal]
    traj = _run_stencil(step, torch.zeros_like(u0), num_t, wanted)
    return traj.permute(1, 2, 0)                         # (batch, x, t)


def generate_ode_batch(generator, operator, batch, num_points, num_points_0,
                       num_cal=1000, length_scale=0.2):
    """(u0 at num_points_0, u at num_points), both (batch, ·), drawn and
    solved on ``generator``'s device."""
    u0_m, u0_full = sample_grf(generator, batch, num_points_0, length_scale)
    u_cal = solve_ode_batch(operator, u0_full, num_cal)
    return u0_m, u_cal @ _interp(num_cal, num_points, u_cal).T


def _vdot(a, b):
    return (a * b).sum()


def solve_darcy_batch(u0, K=0.1, f=-1.0, cg_tol=1e-6, cg_maxiter=2000):
    """Darcy on the unit square: -∇·(K∇u) = f with a Dirichlet boundary
    from a 1-D field of length 4·num_cal (generation.py solve_darcy_pde).
    The boundary unknowns are eliminated, so the interior system is SPD,
    and conjugate gradients solve it with a matvec of padded shifts.

    The whole batch is one vector, with jax.scipy.sparse.linalg.cg's rule:
    from x = 0, iterate while r·r > tol²·(b·b) and fewer than maxiter
    steps.  The state advances on the card under that condition as a
    device flag (an iteration past it leaves the state as it was), and the
    host reads the flag every CG_CHECK_EVERY iterations, so the result is
    the iterate at which the rule stops.

    u0: (batch, 4·num_cal).  Returns (batch, num_cal, num_cal)."""
    batch = u0.shape[0]
    num_cal = u0.shape[1] // 4
    nx = ny = num_cal
    dx = 1.0 / (nx - 1)
    inv_h2 = 1.0 / dx ** 2

    edge = num_cal
    left = u0[:, :edge]                        # u[0, j]    indexed by j
    top = u0[:, edge:2 * edge]                 # u[i, ny-1] indexed by i
    right = u0[:, 2 * edge:3 * edge].flip(1)   # u[nx-1, j] indexed by j
    bottom = u0[:, 3 * edge:].flip(1)          # u[i, 0]    indexed by i

    # full-grid boundary frame (interior zero)
    g = torch.zeros((batch, nx, ny), dtype=u0.dtype, device=u0.device)
    g[:, :, 0] = bottom
    g[:, :, -1] = top
    g[:, 0, :] = left
    g[:, -1, :] = right
    # the reference's if/elif precedence: bottom/top rows win at corners
    g[:, :, 0] = bottom
    g[:, :, -1] = top

    def neg_lap(v):  # v: (batch, nx-2, ny-2)
        vp = torch.nn.functional.pad(v, (1, 1, 1, 1))
        return (4.0 * v - vp[:, :-2, 1:-1] - vp[:, 2:, 1:-1]
                - vp[:, 1:-1, :-2] - vp[:, 1:-1, 2:]) * inv_h2

    rhs = torch.full((batch, nx - 2, ny - 2), f / K, dtype=u0.dtype,
                     device=u0.device)
    rhs = rhs + (g[:, 0:-2, 1:-1] + g[:, 2:, 1:-1]
                 + g[:, 1:-1, 0:-2] + g[:, 1:-1, 2:]) * inv_h2

    atol2 = cg_tol ** 2 * _vdot(rhs, rhs)
    x = torch.zeros_like(rhs)
    r = rhs - neg_lap(x)
    p = r
    gamma = _vdot(r, r)
    for k in range(cg_maxiter):
        if k % CG_CHECK_EVERY == 0 and not bool(gamma > atol2):
            break
        active = gamma > atol2
        ap = neg_lap(p)
        alpha = gamma / _vdot(p, ap)
        x_ = x + alpha * p
        r_ = r - alpha * ap
        gamma_ = _vdot(r_, r_)
        p_ = r_ + (gamma_ / gamma) * p
        x = torch.where(active, x_, x)
        r = torch.where(active, r_, r)
        p = torch.where(active, p_, p)
        gamma = torch.where(active, gamma_, gamma)
    out = g.clone()
    out[:, 1:-1, 1:-1] = x
    return out


def generate_pde_batch(generator, operator, batch, num_points,
                       num_points_0, num_cal=100, length_scale=0.2):
    """Advection / RDiffusion / Darcy on ``generator``'s device: (u0
    (batch, num_points_0), u (batch, num_points, num_points))."""
    if operator == 'Darcy':
        # boundary field of length 4*num_cal (host semantics)
        u0_cal, _ = sample_grf(generator, batch, 4 * num_cal, length_scale)
        u = solve_darcy_batch(u0_cal)
        n0 = 4 * num_cal
    elif operator == 'Advection':
        u0_cal, _ = sample_grf(generator, batch, num_cal, length_scale)
        u = solve_advection_batch(u0_cal)
        n0 = num_cal
    elif operator == 'RDiffusion':
        u0_cal, _ = sample_grf(generator, batch, num_cal, length_scale)
        u = solve_rdiffusion_batch(u0_cal)
        n0 = num_cal
    else:
        raise ValueError(f"device-side PDE gen supports Advection/"
                         f"RDiffusion/Darcy, not {operator}")
    wx = _interp(num_cal, num_points, u)
    wt = _interp(u.shape[2], num_points, u)
    u_out = torch.einsum('pi,bij,qj->bpq', wx, u, wt)
    return u0_cal @ _interp(n0, num_points_0, u0_cal).T, u_out


def _host_contract(u0, u, num_train, num_test):
    """Random train/test split on the process-global NumPy RNG, the host
    generators' split (generation.py)."""
    n = num_train + num_test
    train_index = np.random.choice(n, num_train, replace=False)
    test_index = np.setdiff1d(np.arange(n), train_index)
    u0 = u0.cpu().numpy().astype(np.float32)
    u = u.cpu().numpy().astype(np.float32)
    return (u0[train_index], u[train_index], u0[test_index], u[test_index])


def _device_generator(device):
    """One generator a generation call, on ``device``, seeded from the
    global NumPy RNG so that launch-time seeding stays deterministic."""
    return torch.Generator(device=device).manual_seed(
        int(np.random.randint(0, 2 ** 31 - 1)))


def _check_sampler(input_sampler):
    if input_sampler is not None:
        raise ValueError("device datagen does not support input_sampler; "
                         "use the host path for custom input functions")


def generate_ode_operator_data_device(operator_type, num_train, num_test,
                                      num_points, num_points_0,
                                      length_scale=0.2, num_cal=1000,
                                      input_sampler=None, generator=None,
                                      device=None):
    """generation.generate_ode_operator_data's contract (its 5-tuple) with
    the GRF draws and the RK4 on ``device`` (the card unless 'cpu' is
    given), or on ``generator``'s device when one is passed."""
    _check_sampler(input_sampler)
    num_cal = 1000 if num_cal is None else num_cal
    gen = generator or _device_generator(resolve_device(device))
    with torch.no_grad():
        u0, u = generate_ode_batch(gen, operator_type, num_train + num_test,
                                   num_points, num_points_0, num_cal=num_cal,
                                   length_scale=length_scale)
    x_target = np.linspace(0, 1, num_points).astype(np.float32)
    return (*_host_contract(u0, u, num_train, num_test), x_target)


def generate_pde_operator_data_device(operator_type, num_train, num_test,
                                      num_points, num_points_0,
                                      length_scale=0.2, num_cal=100,
                                      input_sampler=None, generator=None,
                                      device=None):
    """generation.generate_pde_operator_data's contract (its 6-tuple, with
    t_target) with the sampling and the solve on the device."""
    _check_sampler(input_sampler)
    num_cal = 100 if num_cal is None else num_cal
    gen = generator or _device_generator(resolve_device(device))
    with torch.no_grad():
        u0, u = generate_pde_batch(gen, operator_type, num_train + num_test,
                                   num_points, num_points_0, num_cal=num_cal,
                                   length_scale=length_scale)
    x_target = np.linspace(0, 1, num_points).astype(np.float32)
    return (*_host_contract(u0, u, num_train, num_test),
            x_target, x_target.copy())
