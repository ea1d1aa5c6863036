"""
Pauli-twirled noise trajectories, readout error and the T1/T2 channels:
a QPU's noise floor on the simulator (counterpart of
quanonet_tpu/ops/noise.py).

* gate/decoherence noise: a depolarizing channel after every HEA block,
  simulated by Pauli-twirled trajectories.  Each trajectory draws, per
  (block, qubit), "error or not" (prob p_q) and a uniform Pauli X, Y or Z,
  and runs a pure-state forward with those Paulis inserted; the mean over
  trajectories converges to the exact channel value without a 4^n density
  matrix.  Pure dephasing (T2) XORs a Z-flip into the same mask;
  amplitude damping (T1) is a quantum jump (MCWF) after the Paulis.
* readout error: a per-qubit bit flip on the measured distribution,
  applied exactly (n butterflies on the probabilities).
* finite shots: the total budget is spent exactly, floor(shots/n_traj) or
  one more multinomial draw a trajectory, pooled-count estimator.

A sampled Pauli is X^a·Z^b (Y = i·XZ; the global phase cancels in every
expectation).  The trajectories run on one of two routes, chosen from
(device, qubits, channels) by :func:`noise_route` before anything runs and
counted in ``routes``:

* ``'fold'`` (``cuda``, 1-7 qubits, no damping): the masks are drawn per
  trajectory, not per row, so they fold into that trajectory's block
  matrices.  The block chain is ψ = M_B D(x_B) … M_1 D(x_1) H|0⟩ with
  M_b = H U_b H and M_B = U_B H (hea.prepare_chain), so a Pauli P after U_b
  gives M_b' = (H P H) M_b for b < B and M_B' = P M_B; H X H = Z and
  H Z H = X.  Each trajectory's transposed matrices are the shared ones
  with their columns signed and permuted (:func:`fold_paulis`, one batched
  gather), and the chain runs on the shared phases: one compile of the
  shared matrices (B4f where ``cuda_hea.compile_route`` takes it; B4b once
  under autograd) and one block-chain launch a trajectory (B1f; its
  residual variant and B1b under autograd);
* ``'plain'`` (damping on, whose jump depends on each row's state; 8
  qubits and up; the CPU): :func:`traj_forward`, the physical-frame
  forward in plain PyTorch, as the JAX package computes it, a slice of
  trajectories stacked as one batch of rows.

Trajectory t draws from generators seeded from (the generator's seed, t)
(``sampling.fold_in``), on the device of the inputs, so equal seeds replay
bit for bit.  Trajectories run a slice at a time under ``SLICE_BYTES``.
Like the JAX package, the noise path ignores the ``engine``.
"""
import numpy as np
import torch

from quanonet_torch.ops import cuda_hea as _cuda_hea
from quanonet_torch.ops.gates import bit_table, z_signs
from quanonet_torch.ops.hea import (
    HEASpec, _init_state, _kara, _rx_single, compile_block_unitaries,
)
from quanonet_torch.ops.sampling import (
    derive_seed, key_generator, measurement_diag, probs_pair,
    rotate_to_pauli_basis, sample_counts,
)

FOLD_MAX_QUBITS = 7          # the block-chain kernel's widths (D <= 128)
# the most bytes of a slice of trajectories' folded matrices and states
SLICE_BYTES = 1 << 28

# Calls of the noisy expectation (noise.py and mitigation.py) by route;
# chip_smoke.py zeroes and reads it around a path.
routes = {'fold': 0, 'plain': 0}


def _per_qubit(v, n, device):
    """A scalar or (n,) channel parameter -> (n,) float32 on ``device``."""
    t = torch.as_tensor(v, dtype=torch.float32).to(device)
    return torch.broadcast_to(t, (n,))


def _flip_bit(a, q, n_qubits):
    """Bit-flip (Pauli-X) permutation on qubit q: an axis reverse."""
    batch = a.shape[0]
    return a.reshape(batch, 2 ** (n_qubits - 1 - q), 2, 2 ** q).flip(2) \
        .reshape(batch, -1)


def _rows(m):
    """A scalar or (batch,) mask -> broadcastable against (batch, D)."""
    return m[:, None] if m.dim() else m


def apply_pauli_xz(sr, si, q, a, b, n_qubits):
    """X^a · Z^b on qubit q (Z first, then X: (a, b) = (1, 1) realizes Y up
    to the global phase i).  a, b: bool tensors, scalars or (batch,)."""
    a = torch.as_tensor(a, device=sr.device)
    b = torch.as_tensor(b, device=sr.device)
    zq = torch.as_tensor(z_signs(n_qubits)[:, q], device=sr.device)
    sgn = torch.where(_rows(b), zq, torch.ones_like(zq))
    sr, si = sr * sgn, si * sgn
    fr, fi = _flip_bit(sr, q, n_qubits), _flip_bit(si, q, n_qubits)
    return torch.where(_rows(a), fr, sr), torch.where(_rows(a), fi, si)


def sample_pauli_masks(generator, p, n_blocks, n_qubits):
    """One trajectory's error pattern from ``generator``: (a, b) bool
    (n_blocks, n_qubits) on its device.  Per (block, qubit) an error with
    prob p_q, then a uniform Pauli X, Y or Z (the depolarizing channel
    ρ → (1 − p)ρ + (p/3) Σ_P PρP); a is the bit-flip component (X or Y),
    b the phase-flip component (Y or Z)."""
    dev = generator.device
    p = _per_qubit(p, n_qubits, dev)
    occur = torch.rand((n_blocks, n_qubits), generator=generator,
                       device=dev) < p
    choice = torch.randint(0, 3, (n_blocks, n_qubits), generator=generator,
                           device=dev)
    return occur & (choice != 2), occur & (choice != 0)


def apply_amplitude_damping(sr, si, q, gamma, u, n_qubits):
    """One quantum-jump (MCWF) step of the T1 amplitude-damping channel on
    qubit q: Kraus K0 = diag(1, √(1−γ)), K1 = √γ·|0⟩⟨1|.  The jump fires
    with prob γ·P1 (P1 the population of q's 1-subspace, per row); it
    lowers the 1-amplitudes into the 0-subspace, the no-jump branch scales
    them by √(1−γ), and both renormalize.  u: (batch,) uniforms; gamma a
    scalar."""
    batch = sr.shape[0]
    hi, lo = 2 ** (n_qubits - 1 - q), 2 ** q
    r = sr.reshape(batch, hi, 2, lo)
    i = si.reshape(batch, hi, 2, lo)
    r0, r1, i0, i1 = r[:, :, 0], r[:, :, 1], i[:, :, 0], i[:, :, 1]
    gamma = torch.as_tensor(gamma, dtype=sr.dtype, device=sr.device)
    p1 = (r1 * r1 + i1 * i1).sum(dim=(1, 2))
    p_jump = gamma * p1
    jump = (u < p_jump)[:, None, None]
    z = torch.zeros_like(r1)
    inv_j = torch.rsqrt(torch.clamp(p1, min=1e-30))[:, None, None]
    s = torch.sqrt(torch.clamp(1.0 - gamma, min=0.0))
    inv_n = torch.rsqrt(torch.clamp(1.0 - p_jump, min=1e-30))[:, None, None]
    out_r = torch.stack([torch.where(jump, r1 * inv_j, r0 * inv_n),
                         torch.where(jump, z, r1 * (s * inv_n))], dim=2)
    out_i = torch.stack([torch.where(jump, i1 * inv_j, i0 * inv_n),
                         torch.where(jump, z, i1 * (s * inv_n))], dim=2)
    return out_r.reshape(batch, -1), out_i.reshape(batch, -1)


def traj_forward(spec: HEASpec, utr, uti, xb, a, b, gamma=None, u=None):
    """Noise trajectories in the physical frame, plain PyTorch (the port of
    the JAX package's ``_traj_forward``).  utr/uti: the block unitaries
    transposed (nb, D, D); xb: (nb, rows, n) encode angles; a/b: the
    sampled Pauli components, (nb, n) for one trajectory or (nb, n, rows)
    a row; gamma (n,) the damping γ a block and u (nb, n, rows) the jump
    uniforms when amplitude damping is on.  Returns the final split-real
    state (rows, D)."""
    n = spec.n_qubits
    sr, si = _init_state(xb.shape[1], spec.dim, xb.device)
    for blk in range(spec.n_blocks):
        for q in range(n):                         # encode: ⊗RX(x_b)
            sr, si = _rx_single(sr, si, q, xb[blk, :, q], n)
        sr, si = _kara(sr, si, utr[blk], uti[blk])  # ansatz: s ← U_b s
        for q in range(n):                         # sampled Pauli noise
            sr, si = apply_pauli_xz(sr, si, q, a[blk, q], b[blk, q], n)
        if gamma is not None:                      # T1 decay, MCWF
            for q in range(n):
                sr, si = apply_amplitude_damping(sr, si, q, gamma[q],
                                                 u[blk, q], n)
    return sr, si


def apply_readout_error(probs, ro):
    """Exact per-qubit bit-flip (readout) channel on a measured
    distribution: probs (batch, 2^n), ro scalar or (n,) flip probs.  The
    kron of 2x2 binary-symmetric channels as n butterflies."""
    batch, dim = probs.shape
    n = dim.bit_length() - 1
    ro = torch.broadcast_to(
        torch.as_tensor(ro, dtype=probs.dtype).to(probs.device), (n,))
    for q in range(n):
        p = probs.reshape(batch, 2 ** (n - 1 - q), 2, 2 ** q)
        p0, p1 = p[:, :, 0], p[:, :, 1]
        r = ro[q]
        probs = torch.stack([(1 - r) * p0 + r * p1, r * p0 + (1 - r) * p1],
                            dim=2).reshape(batch, -1)
    return probs


def is_noisy(noise_p=None, readout_p=None, damp_gamma=None, dephase_p=None):
    """True iff a channel parameter switches a channel on.  None and 0
    both mean off (the ideal circuit); scalars or per-qubit arrays.  The
    one predicate for the models, the solver and infer."""
    def on(v):
        return v is not None and bool(np.any(np.asarray(v, np.float64)))
    return (on(noise_p) or on(readout_p) or on(damp_gamma)
            or on(dephase_p))


def distribute_shots(shots, n_traj):
    """A total shot budget over trajectories: floor(shots/n_traj) each, the
    first ``shots % n_traj`` one more; sums to ``shots`` (float32
    (n_traj,), zeros when shots < n_traj)."""
    base, extra = divmod(int(shots), n_traj)
    return (np.full(n_traj, base, np.float32)
            + (np.arange(n_traj) < extra)).astype(np.float32)


def noise_route(device, n_qubits, damping):
    """'fold' (the block-chain kernels, the Paulis folded into each
    trajectory's block matrices) on ``cuda`` up to FOLD_MAX_QUBITS without
    amplitude damping; 'plain' (:func:`traj_forward`) otherwise."""
    if (torch.device(device).type == 'cuda'
            and n_qubits <= FOLD_MAX_QUBITS and not damping):
        return 'fold'
    return 'plain'


def fold_paulis(mt_r, mt_i, a, b):
    """The block matrices of S trajectories: (mt_r, mt_i) (nb, D, D), the
    transposed chain matrices of hea.prepare_chain, and the Pauli masks
    a, b (S, nb, n) -> (S, nb, D, D) each.

    An inner block's Pauli X^a Z^b after U_b becomes G = H X^a Z^b H =
    Z^a X^b on the chain's left, the last block's P = X^a Z^b itself; on
    the transposed matrix either is a signed column permutation,
    mt'[:, k] = σ(k) · mt[:, k ⊕ m_x], with m_x = mask(b) and
    σ(k) = (−1)^{|k ∧ mask(a)|} for b < B, m_x = mask(a) and
    σ(k) = (−1)^{|(k ⊕ m_x) ∧ mask(b)|} for the last block: the state of
    the physical-frame forward, global phase included."""
    s_, nb, n = a.shape
    d = mt_r.shape[-1]
    dev = mt_r.device
    bits = 2 ** torch.arange(n, device=dev)
    ma = (a.to(dev).long() * bits).sum(-1)               # (S, nb)
    mb = (b.to(dev).long() * bits).sum(-1)
    last = torch.arange(nb, device=dev) == nb - 1
    mx = torch.where(last, ma, mb)[..., None]            # (S, nb, 1)
    mz = torch.where(last, mb, ma)[..., None]
    k = torch.arange(d, device=dev)
    perm = k ^ mx                                        # (S, nb, D)
    parity = torch.as_tensor(bit_table(n).sum(1) % 2, device=dev)
    sk = torch.where(last[:, None], perm, k)
    sign = (1.0 - 2.0 * parity[sk & mz]).to(mt_r.dtype)[:, :, None, :]
    idx = perm[:, :, None, :].expand(s_, nb, d, d)
    shape = (s_, nb, d, d)
    return (torch.gather(mt_r.expand(shape), 3, idx) * sign,
            torch.gather(mt_i.expand(shape), 3, idx) * sign)


def fold_states(mt_r, mt_i, phi, a, b, chain=None):
    """Final states (S, N, D) ×2 of S trajectories on the fold route: each
    trajectory's folded matrices (:func:`fold_paulis`) through ``chain``
    (default ``cuda_hea.block_chain``: B1f on ``cuda``, hea.chain_dense on
    the CPU) on the shared phases phi (nb, N, D)."""
    chain = chain or _cuda_hea.block_chain
    fr, fi = fold_paulis(mt_r, mt_i, a, b)
    outs = [chain(fr[k], fi[k], phi) for k in range(a.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def plain_states(spec, utr, uti, xb, a, b, gamma=None, u=None):
    """Final states (S, N, D) ×2 of S trajectories on the plain route: one
    :func:`traj_forward` over S·N rows (trajectory-major).  a, b (S, nb,
    n); u (S, nb, n, N) when damping."""
    s_, nb, n = a.shape
    rows = xb.shape[1]

    def per_row(m):                                      # (nb, n, S·N)
        return m.permute(1, 2, 0).repeat_interleave(rows, dim=2)
    ur = (u.permute(1, 2, 0, 3).reshape(nb, n, s_ * rows)
          if u is not None else None)
    sr, si = traj_forward(spec, utr, uti, xb.repeat(1, s_, 1), per_row(a),
                          per_row(b), gamma, ur)
    return sr.reshape(s_, rows, -1), si.reshape(s_, rows, -1)


def measure_diag(n_qubits, diag, pauli, offset, coeff, device):
    """The diagonal read after the basis rotation (sampling.
    measurement_diag), float32 on ``device``."""
    if pauli == 'Z' and diag is None:
        raise ValueError("Z-basis noise simulation requires a diagonal")
    return torch.as_tensor(
        measurement_diag(n_qubits, pauli, diag, offset, coeff),
        dtype=torch.float32).to(device)


def state_probs(sr, si, pauli, n_qubits, readout_p):
    """States (S, N, D) ×2 -> the measured distributions (S, N, D): rotated
    to the Pauli's basis, renormalized, through the readout channel."""
    s_, rows, d = sr.shape
    sr, si = rotate_to_pauli_basis(sr.reshape(-1, d), si.reshape(-1, d),
                                   pauli, n_qubits)
    probs = probs_pair(sr, si)
    if is_noisy(readout_p=readout_p):
        probs = apply_readout_error(probs, readout_p)
    return probs.reshape(s_, rows, d)


class _Operands:
    """A route's shared operands, built once a call: the chain's (mt_r,
    mt_i, phi) on the fold route, the transposed unitaries and the angles
    on the plain route."""

    def __init__(self, route, spec, weights, x):
        if not spec.uniform_encode:
            raise ValueError("noisy_expectation requires a uniform-encode "
                             "spec (every block encodes n_qubits angles)")
        self.route, self.spec = route, spec
        n, nb = spec.n_qubits, spec.n_blocks
        if route == 'fold':
            self.ops = _cuda_hea._prepare(spec, weights, x)
        else:
            ur, ui = compile_block_unitaries(spec, weights)
            self.ops = (ur.transpose(1, 2), ui.transpose(1, 2),
                        x.reshape(x.shape[0], nb, n).transpose(0, 1))

    def states(self, a, b, gamma=None, u=None):
        if self.route == 'fold':
            return fold_states(*self.ops, a, b)
        return plain_states(self.spec, *self.ops, a, b, gamma, u)

    def slice_size(self, rows, sets=1):
        """Trajectories a slice, each running ``sets`` mask sets."""
        d, nb = self.spec.dim, self.spec.n_blocks
        per = 4 * sets * (2 * nb * d * d + 16 * rows * d)
        return max(1, SLICE_BYTES // per)


def traj_generators(generator, t, count, device):
    """The generators of trajectory t: ``count`` of them on ``device``,
    seeded from (the generator's seed, t, i), i = 0 .. count − 1 (those of
    ``fold_in(fold_in(generator, t), i)``, made on the inputs' device)."""
    seed = derive_seed(generator.initial_seed(), t)
    return [key_generator(seed, i, device=device) for i in range(count)]


def noisy_expectation(generator, spec: HEASpec, weights, x, noise_p, n_traj,
                      diag=None, pauli='Z', offset=0.0, coeff=0.0,
                      shots=None, readout_p=0.0, damp_gamma=None,
                      dephase_p=None):
    """Trajectory-averaged ⟨H⟩ under per-block noise, (batch, 1) float32:
    the noisy counterpart of hea.hea_expectation, with (generator, noise_p,
    n_traj, shots, readout_p, damp_gamma, dephase_p).

    generator  torch.Generator: trajectory t draws from (its seed, t), so
               equal seeds replay bit for bit.
    noise_p    scalar or (n,) depolarizing prob a qubit and block.
    n_traj     trajectories averaged (std ∝ 1/√n_traj).
    shots      optional total shot budget, spent exactly over the
               trajectories (:func:`distribute_shots`), pooled-count
               estimator; None = exact per-trajectory expectations.
    readout_p  scalar or (n,) measurement bit-flip prob, applied exactly.
    damp_gamma None, scalar or (n,): T1 amplitude damping γ a block
               (γ = 1 − e^(−t_block/T1)), quantum jumps.
    dephase_p  None, scalar or (n,): T2 Z-flip prob a block, XORed into
               the Pauli mask.

    Per block: encode → U_b → depolarizing and dephasing Paulis →
    damping.  Unbiased in the channel."""
    n, nb = spec.n_qubits, spec.n_blocks
    d = measure_diag(n, diag, pauli, offset, coeff, x.device)
    damping = damp_gamma is not None
    route = noise_route(x.device, n, damping)
    ops = _Operands(route, spec, weights, x)
    routes[route] += 1
    gamma = _per_qubit(damp_gamma, n, x.device) if damping else None
    dp = (_per_qubit(dephase_p, n, x.device) if dephase_p is not None
          else None)
    traj_shots = distribute_shots(shots, n_traj) if shots else None
    rows = x.shape[0]
    step = ops.slice_size(rows)
    vals = []
    for t0 in range(0, n_traj, step):
        ts = range(t0, min(t0 + step, n_traj))
        a, b, u, ks = [], [], [], []
        for t in ts:
            kn, k_s, kd, ku = traj_generators(generator, t, 4, x.device)
            at, bt = sample_pauli_masks(kn, noise_p, nb, n)
            if dp is not None:
                bt = bt ^ (torch.rand((nb, n), generator=kd,
                                      device=x.device) < dp)
            a.append(at)
            b.append(bt)
            ks.append(k_s)
            if damping:
                u.append(torch.rand((nb, n, rows), generator=ku,
                                    device=x.device))
        sr, si = ops.states(torch.stack(a), torch.stack(b), gamma,
                            torch.stack(u) if damping else None)
        probs = state_probs(sr, si, pauli, n, readout_p)
        if traj_shots is None:
            vals.append((probs * d).sum(-1))
            continue
        # pooled counts: the mean over n_traj of n_traj·⟨counts_t, d⟩/shots
        # is Σ_t ⟨counts_t, d⟩ / shots
        for j, t in enumerate(ts):
            counts = sample_counts(ks[j], probs[j], float(traj_shots[t]))
            vals.append(((counts * d).sum(-1)
                         * (n_traj / float(shots)))[None])
    return torch.cat(vals).mean(0)[:, None]


def noise_p_from_calibration(spec: HEASpec, gate_error_2q,
                             gate_error_1q=0.0):
    """Depolarizing prob a qubit and block from calibration gate errors:
    a sublayer touches every qubit with three 1q rotations and two ring
    CNOTs, and a block averages total_sublayers/n_blocks sublayers, so
    p ≈ (sublayers a block) · (2·err_2q + 3·err_1q), clipped to [0, 1)."""
    sub_per_block = spec.total_sublayers / max(1, spec.n_blocks)
    p = sub_per_block * (2.0 * float(gate_error_2q)
                         + 3.0 * float(gate_error_1q))
    return float(np.clip(p, 0.0, 0.999))


def channel_params_from_t1t2(block_time_us, t1_us, t2_us):
    """(damp_gamma, dephase_p) a block from calibration T1/T2 and the time
    a block takes on hardware:

    * amplitude damping: γ = 1 − e^(−t/T1);
    * pure dephasing: 1/Tφ = 1/T2 − 1/(2·T1), clipped at 0 (T2 > 2·T1 in
      a calibration snapshot means T1-limited coherence), then
      p_φ = (1 − e^(−t/Tφ))/2, the Z-flip prob whose channel decays the
      coherences by e^(−t/Tφ).

    Returns plain floats for noisy_expectation(damp_gamma=…, dephase_p=…).
    """
    t, t1, t2 = float(block_time_us), float(t1_us), float(t2_us)
    if t < 0 or t1 <= 0 or t2 <= 0:
        raise ValueError("block_time_us must be >= 0 and T1/T2 > 0")
    gamma = 1.0 - np.exp(-t / t1)
    inv_tphi = max(0.0, 1.0 / t2 - 0.5 / t1)
    p_phi = 0.5 * (1.0 - np.exp(-t * inv_tphi))
    return float(gamma), float(p_phi)
