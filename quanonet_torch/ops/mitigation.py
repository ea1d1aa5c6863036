"""
Zero-noise extrapolation (ZNE) on top of ops/noise.py (counterpart of
quanonet_tpu/ops/mitigation.py).

The observable is evaluated at amplified noise levels c·p (c = 1, 2, …)
and Richardson-extrapolated back to c = 0.  Under a per-site
depolarizing channel the expectation is a polynomial in the error prob,
so an s-point extrapolation cancels the first s − 1 orders.

Common random numbers: every trajectory draws one uniform field u
(block, qubit) and one Pauli choice, and realizes scale c as the mask
u < c·p, so a site active at scale 1 is active at every larger scale and
the weighted combination cancels most of the Monte-Carlo noise with the
channel's bias.  The trajectories run on the routes of ops/noise.py: on
``cuda`` up to 7 qubits each (trajectory, scale) is one set of folded
block matrices and one block-chain launch (B1f) on the shared phases,
len(scales) × n_traj of them; the shared matrices are compiled once.
"""
import numpy as np
import torch

from quanonet_torch.ops.noise import (
    _Operands, _per_qubit, measure_diag, noise_route, routes, state_probs,
    traj_generators,
)


def richardson_weights(scales):
    """Extrapolation-to-zero weights for the sample points ``scales``: the
    w with Σ wᵢ = 1 and Σ wᵢ·cᵢᵏ = 0 for k = 1..s−1, so Σ wᵢ·f(cᵢ) = f(0)
    for any polynomial f of degree < s; wᵢ = Πⱼ≠ᵢ cⱼ/(cⱼ−cᵢ)."""
    c = np.asarray(scales, np.float64)
    if c.ndim != 1 or c.size < 1:
        raise ValueError("scales must be a 1-D sequence of noise factors")
    if np.unique(c).size != c.size:
        raise ValueError(f"scales must be distinct, got {list(c)}")
    if np.any(c <= 0):
        raise ValueError("scales must be positive (c=0 is the point being "
                         "extrapolated to, not a sample point)")
    w = np.empty_like(c)
    for i in range(c.size):
        others = np.delete(c, i)
        w[i] = np.prod(others / (others - c[i]))
    return w


def zne_expectation(generator, spec, weights, x, noise_p, n_traj,
                    scales=(1.0, 2.0), diag=None, pauli='Z', offset=0.0,
                    coeff=0.0, readout_p=0.0):
    """Zero-noise-extrapolated ⟨H⟩, (batch, 1) float32: Richardson over the
    noise scales with common-random-number trajectories.  The observable
    arguments of noise.noisy_expectation; each trajectory evaluates every
    scale on one shared draw, so equal seeds replay bit for bit.
    ``readout_p`` is not scaled (gate folding on hardware does not amplify
    it either)."""
    n, nb = spec.n_qubits, spec.n_blocks
    richardson_weights(scales)
    d = measure_diag(n, diag, pauli, offset, coeff, x.device)
    route = noise_route(x.device, n, False)
    ops = _Operands(route, spec, weights, x)
    routes[route] += 1
    p = _per_qubit(noise_p, n, x.device)
    step = ops.slice_size(x.shape[0], len(scales))
    vals = []
    for t0 in range(0, n_traj, step):
        u, choice = [], []
        for t in range(t0, min(t0 + step, n_traj)):
            (g,) = traj_generators(generator, t, 1, x.device)
            u.append(torch.rand((nb, n), generator=g, device=x.device))
            choice.append(torch.randint(0, 3, (nb, n), generator=g,
                                        device=x.device))
        vals.append(zne_values(ops, torch.stack(u), torch.stack(choice), p,
                               scales, d, pauli, readout_p))
    return torch.cat(vals).mean(0)[:, None]


def zne_values(ops, u, choice, p, scales, d, pauli='Z', readout_p=0.0):
    """The Richardson combinations (T, N) of T trajectories with the draws
    u (T, nb, n) uniforms and choice (T, nb, n) in {0, 1, 2}: scale c's
    masks are u < c·p with the Pauli X, Y or Z of ``choice``; ``ops`` a
    route's shared operands (noise._Operands), d the measured diagonal."""
    ns = len(scales)
    occur = torch.stack([u < float(c) * p for c in scales], 1)  # (T, s, ..)
    choice = choice[:, None].expand_as(occur)
    a = (occur & (choice != 2)).flatten(0, 1)
    b = (occur & (choice != 0)).flatten(0, 1)
    sr, si = ops.states(a, b)
    e = (state_probs(sr, si, pauli, ops.spec.n_qubits, readout_p)
         * d).sum(-1)
    e = e.reshape(-1, ns, e.shape[-1])          # (trajectories, scales, N)
    val = torch.zeros_like(e[:, 0])
    for i, wi in enumerate(richardson_weights(scales)):
        val = val + float(np.float32(wi)) * e[:, i]
    return val
