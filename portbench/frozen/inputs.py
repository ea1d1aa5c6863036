"""
The benchmark's inputs, made from the run's seed on the run's device: the
input functions, the Antideriv training set, the Advection-shaped scoring
grid, the serving requests, and seeded QuanONet weights.

Input functions are smooth random Fourier series on [0, 1] (a squared-
exponential spectrum, length scale 0.2, as the repo's Gaussian random
fields), so the targets are exact in closed form: the antiderivative
term by term, and periodic advection at speed 1 as a shift, u(x, t) =
u0(x - t).  Sizes never depend on the seed; only values and order do.
"""
import math

import numpy as np
import torch

N_MODES = 8
LENGTH_SCALE = 0.2
SENSORS = 100           # the branch input: u0 at linspace(0, 1, 100)

# sub-streams of one run's seed
STREAM_WEIGHTS, STREAM_DATA, STREAM_ORDER, STREAM_TRAFFIC = range(4)


def sub_seed(seed, stream):
    """A generator seed for one stream of a run's seed (any whole
    number)."""
    return (int(seed) * 1000003 + 7919 * (stream + 1)) % (2 ** 63)


def generator(seed, stream, device):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def sensors(device):
    return torch.linspace(0, 1, SENSORS, device=device)


class Functions:
    """A batch of random Fourier series u(x) = c0 + sum_k a_k cos(2 pi k x)
    + b_k sin(2 pi k x)."""

    def __init__(self, gen, count, device):
        k = torch.arange(1, N_MODES + 1, device=device, dtype=torch.float32)
        scale = torch.exp(-0.5 * (math.pi * k * LENGTH_SCALE) ** 2)
        z = torch.randn((count, 2 * N_MODES + 1), generator=gen,
                        device=device)
        self.k = k
        self.c0 = z[:, 0]
        self.a = z[:, 1:N_MODES + 1] * scale
        self.b = z[:, N_MODES + 1:] * scale

    def _angle(self, x):
        return 2 * math.pi * self.k * x[..., None]

    def value(self, x):
        """u at x (count, points), row i of x for function i."""
        ang = self._angle(x)
        return self.c0[:, None] + (self.a[:, None] * torch.cos(ang)
                                   + self.b[:, None] * torch.sin(ang)).sum(-1)

    def antiderivative(self, x):
        """The integral of u from 0 to x (count, points)."""
        ang = self._angle(x)
        w = 2 * math.pi * self.k
        return self.c0[:, None] * x + ((self.a[:, None] * torch.sin(ang)
                                        - self.b[:, None]
                                        * (torch.cos(ang) - 1)) / w).sum(-1)


def antideriv_set(seed, functions, points, device):
    """The Antideriv training set: ``functions`` input functions, each at
    ``points`` of the 100 sensor positions drawn without replacement.
    Returns (branch (n, 100), trunk (n, 1), target (n, 1)), function-major,
    n = functions * points."""
    gen = generator(seed, STREAM_DATA, device)
    fns = Functions(gen, functions, device)
    grid = sensors(device)
    u0 = fns.value(grid.expand(functions, SENSORS))
    pick = torch.rand((functions, SENSORS), generator=gen,
                      device=device).argsort(-1)[:, :points]
    x = grid[pick]                                        # (F, P)
    target = fns.antiderivative(x)
    branch = u0.repeat_interleave(points, 0)
    return branch, x.reshape(-1, 1), target.reshape(-1, 1)


def advection_grid(seed, functions, points, device):
    """The Advection-shaped scoring grid: ``functions`` initial conditions
    u0, each at ``points`` (x, t) drawn from the 100 x 100 grid.  Returns
    (branch (n, 100), trunk (n, 2), target (n,) float64 on the host)."""
    gen = generator(seed, STREAM_DATA, device)
    fns = Functions(gen, functions, device)
    grid = sensors(device)
    u0 = fns.value(grid.expand(functions, SENSORS))
    idx = torch.randint(0, SENSORS, (functions, points, 2), generator=gen,
                        device=device)
    xt = grid[idx]                                        # (F, P, 2)
    target = fns.value(torch.remainder(xt[..., 0] - xt[..., 1], 1.0))
    branch = u0.repeat_interleave(points, 0)
    return (branch, xt.reshape(-1, 2),
            target.reshape(-1).double().cpu().numpy())


def function_pool(seed, count, device):
    """(count, 100) NumPy: u0 of ``count`` input functions at the sensors,
    the pool that serving requests draw their functions from."""
    gen = generator(seed, STREAM_DATA, device)
    fns = Functions(gen, count, device)
    return fns.value(sensors(device).expand(count, SENSORS)).cpu().numpy()


def request_rows(pool, first, k, points):
    """A request of k functions of the pool from index ``first`` on
    (wrapping), each at ``points`` of its sensor positions spread evenly
    (all 100 at 100): (branch (k*points, 100), trunk (k*points, 1))."""
    idx = (first + np.arange(k)) % pool.shape[0]
    x = np.linspace(0, 1, SENSORS, dtype=np.float32)
    x = x[np.linspace(0, SENSORS - 1, points).round().astype(int)]
    branch = np.repeat(pool[idx], points, axis=0)
    trunk = np.tile(x, k)[:, None]
    return branch, trunk


def stratified(values_cdf, count):
    """``count`` draws at the quantiles (i + 0.5) / count of a discrete
    distribution given by its CDF, in increasing order: the same multiset
    for every seed."""
    u = (np.arange(count) + 0.5) / count
    return np.searchsorted(values_cdf, u)


def open_loop_schedule(seed, count, seconds, k_max):
    """(due seconds, k) of ``count`` requests over ``seconds``.

    The arrivals are a Poisson process given its count: ``count`` times
    drawn independently and uniformly over the window from the seed's
    stream, then sorted, so the gaps are exponential and bursts come as
    independent users make them.  The sizes, k on 1..k_max with
    probability in proportion to 1/k, are the same multiset for every seed
    in an order the seed draws, so every seed offers the same work."""
    rng = np.random.default_rng(sub_seed(seed, STREAM_TRAFFIC))
    due = np.sort(rng.uniform(0.0, seconds, count))
    ks = np.arange(1, k_max + 1)
    cdf = np.cumsum(1.0 / ks) / np.sum(1.0 / ks)
    return due, rng.permutation(ks[stratified(cdf, count)])


def epoch_order(seed, epoch, n):
    """Epoch ``epoch``'s order of the n training rows, on the host."""
    gen = torch.Generator().manual_seed(
        sub_seed(sub_seed(seed, STREAM_ORDER), epoch))
    return torch.randperm(n, generator=gen)


def quanonet_params(config, seed, device):
    """Seeded QuanONet weights by state_dict name, made on ``device`` in
    one draw: the ansatz and the frequency maps' biases uniform on
    [-pi, pi], the maps' weights at ``scale_coeff``, the output bias 0 (the
    model's own initial law)."""
    n = config['num_qubits']
    bd, bld, td, tld = config['net_size']
    sub = bd * bld + td * tld
    sizes = [sub * 3 * n, bd * n, td * n]
    gen = generator(seed, STREAM_WEIGHTS, device)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    ansatz, branch_b, trunk_b = torch.split((2 * u - 1) * math.pi, sizes)
    scale = float(config['scale_coeff'])
    return {
        'ansatz': ansatz.reshape(sub, 3, n).contiguous(),
        'bias': torch.zeros((), device=device),
        'branch_freq.weights': torch.full((bd * n,), scale, device=device),
        'branch_freq.bias': branch_b.contiguous(),
        'trunk_freq.weights': torch.full((td * n,), scale, device=device),
        'trunk_freq.bias': trunk_b.contiguous(),
    }
