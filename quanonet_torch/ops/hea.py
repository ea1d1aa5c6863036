"""
Hardware-Efficient-Ansatz (HEA) statevector engine (counterpart of
quanonet_tpu/ops/hea.py).

Circuit: a sequence of blocks; each block is

    1. encoding: RX(x_j) on qubit j (data re-uploading),
    2. ``linear_depth`` ansatz sublayers: RY(w0)/RZ(w1)/RY(w2) on every
       qubit, then a CNOT ring with control=(i+1)%n -> target=i.

Weights: (total_sublayers, 3, n_qubits), sublayers in circuit order (trunk
blocks first for QuanONet), gate order [RY, RZ, RY'].  A statevector is the
split pair (sr, si), each (batch, 2^n) float32.

Engines:

* ``dense``: each block's ansatz stack compiles to one (2^n, 2^n) unitary;
  with the Hadamards folded in, the circuit is a chain of block matrices
  and per-sample diagonal phases (:func:`prepare_chain`,
  :func:`chain_dense`), differentiated by autograd.  With
  :func:`chain_dense_saved` and :func:`chain_backward_dense`, the plain
  version of the CUDA kernels.
* ``pallas``: the same chain through the hand-written CUDA kernels
  (ops/cuda_hea.py), forward and backward.  The name is kept from the JAX
  package so that
  configs and ``--engine`` values mean the same thing.
* ``gates``: literal gate-by-gate application (oracle).
* ``fused``: the grouped-kron engine for 8 qubits and up
  (ops/fused_gates.py): per-qubit 2x2s applied in qubit groups, never a
  D×D matrix, differentiated by autograd.
* ``pfused``: the fused-group chain through the hand-written CUDA kernels
  (ops/cuda_fused.py), 8..16 qubits forward, to 14 with a gradient.

``auto`` takes ``pallas`` on a card and ``dense`` on the CPU below 8
qubits; from 8 qubits ``pfused`` on a card up to 14 and ``fused`` above and
on the CPU (the JAX package's routing, hea.py:436-454), and for no-grad
callers (:func:`resolve_inference_engine`) ``pfused`` at 15-16 on a card.

``QON_UNPIN_EXPECT=1`` (the JAX package's switch, off by default) drops the
expectation's fp32 pin on `cuda`: |ψ|² and the diagonal are rounded to bf16
before the products, summed in fp32 (:func:`diag_expectation_unpinned`),
the TPU's default precision that the JAX mode falls back to; on the CPU
the expectation stays exact fp32, as the JAX package's CPU path does.
"""
import os
from dataclasses import dataclass

import numpy as np
import torch

from quanonet_torch.ops.gates import (
    hadamard_kron,
    kron_chain,
    ring_apply,
    round_bf16,
    ry_matrix,
    z_signs,
)

# The expectation's precision pin: '1' drops it on `cuda` (read here once;
# callers and tests set the attribute).
UNPIN_EXPECT = os.environ.get('QON_UNPIN_EXPECT') == '1'


@dataclass(frozen=True)
class HEASpec:
    """Static circuit description.

    block_configs: ((n_encode, linear_depth), ...) in circuit order —
    trunk blocks then branch blocks for QuanONet.
    """
    n_qubits: int
    block_configs: tuple

    @property
    def n_blocks(self) -> int:
        return len(self.block_configs)

    @property
    def total_sublayers(self) -> int:
        return sum(ld for _, ld in self.block_configs)

    @property
    def total_encode(self) -> int:
        return sum(ne for ne, _ in self.block_configs)

    @property
    def dim(self) -> int:
        return 2 ** self.n_qubits

    def weight_shape(self):
        return (self.total_sublayers, 3, self.n_qubits)

    @property
    def uniform_encode(self) -> bool:
        return all(ne == self.n_qubits for ne, _ in self.block_configs)


def make_block_configs(num_qubits, trunk_depth, trunk_linear_depth,
                       branch_depth, branch_linear_depth):
    """QuanONet layout: trunk blocks first, then branch blocks."""
    cfg = [(num_qubits, trunk_linear_depth)] * trunk_depth
    cfg += [(num_qubits, branch_linear_depth)] * branch_depth
    return tuple(cfg)


def quanonet_spec(num_qubits, net_size) -> HEASpec:
    """net_size = (branch_depth, branch_ld, trunk_depth, trunk_ld)."""
    bd, bld, td, tld = net_size
    return HEASpec(num_qubits, make_block_configs(num_qubits, td, tld, bd, bld))


def heaqnn_spec(num_qubits, net_size) -> HEASpec:
    """net_size[:2] = (depth, linear_depth)."""
    depth, ld = int(net_size[0]), int(net_size[1])
    return HEASpec(num_qubits, tuple([(num_qubits, ld)] * depth))


def _table(arr, like):
    """Host constant -> float32 tensor on ``like``'s device."""
    return torch.as_tensor(arr, dtype=torch.float32, device=like.device)


# ── split-real primitives ─────────────────────────────────────────────────────

def _init_state(batch, dim, device):
    sr = torch.zeros((batch, dim), dtype=torch.float32, device=device)
    sr[:, 0] = 1.0
    si = torch.zeros((batch, dim), dtype=torch.float32, device=device)
    return sr, si


def _halves(a, q, n_qubits):
    """(batch, 2^n) -> the amplitudes with bit q = 0 and bit q = 1, each
    (batch, hi, lo)."""
    a = a.reshape(a.shape[0], 2 ** (n_qubits - 1 - q), 2, 2 ** q)
    return a[:, :, 0, :], a[:, :, 1, :]


def _join(a0, a1):
    return torch.stack([a0, a1], dim=2).reshape(a0.shape[0], -1)


def _apply_ry(sr, si, q, c, s, n_qubits):
    """RY = [[c, -s], [s, c]] (real) on qubit q; c/s scalars."""
    def rot(a):
        a0, a1 = _halves(a, q, n_qubits)
        return _join(c * a0 - s * a1, s * a0 + c * a1)

    return rot(sr), rot(si)


def _apply_rz(sr, si, q, half, n_qubits):
    """RZ = diag(e^{-iθ/2}, e^{+iθ/2}) on qubit q; half = θ/2."""
    c = torch.cos(half)
    s = torch.sin(half)
    r0, r1 = _halves(sr, q, n_qubits)
    i0, i1 = _halves(si, q, n_qubits)
    # e^{-iθ/2}(r0+i i0) ; e^{+iθ/2}(r1+i i1)
    return (_join(c * r0 + s * i0, c * r1 - s * i1),
            _join(c * i0 - s * r0, c * i1 + s * r1))


def _rx_single(sr, si, q, theta, n_qubits):
    """RX(θ) on one qubit with per-sample θ (batch,)."""
    half = theta / 2.0
    c = torch.cos(half)[:, None, None]
    s = torch.sin(half)[:, None, None]
    r0, r1 = _halves(sr, q, n_qubits)
    i0, i1 = _halves(si, q, n_qubits)
    return (_join(c * r0 + s * i1, s * i0 + c * r1),
            _join(c * i0 - s * r1, -s * r0 + c * i1))


def _apply_ring(sr, si, n_qubits):
    if n_qubits <= 1:
        return sr, si
    return ring_apply(n_qubits)(sr, si)


# ── dense path: compile ansatz stacks to block unitaries ────────────────────

def _sublayer_unitary(w, n_qubits):
    """Ansatz sublayers -> (ur, ui), each (..., 2^n, 2^n) float32.

    w: (..., 3, n_qubits) = [RY θ, RZ θ, RY' θ].
    U = Ring · (⊗RY') · (⊗RZ) · (⊗RY); ⊗RZ is diagonal and the ring is a
    static row permutation, so the dense work is two real kron chains and
    two real matmuls.
    """
    u_ry1 = kron_chain(ry_matrix(w[..., 0, :]))          # (..., D, D) real
    u_ry2 = kron_chain(ry_matrix(w[..., 2, :]))
    zsgn = _table(z_signs(n_qubits), w)                  # (D, n)
    # K = n <= 7: an explicit sum, exact in fp32 whatever the matmul mode
    phase = 0.5 * (w[..., 1, None, :] * zsgn).sum(-1)    # (..., D)
    zr = torch.cos(phase)                                # Re e^{-i phase}
    zi = -torch.sin(phase)                               # Im e^{-i phase}
    ur = u_ry2 @ (zr[..., :, None] * u_ry1)
    ui = u_ry2 @ (zi[..., :, None] * u_ry1)
    return ring_apply(n_qubits, -2)(ur, ui)


def compile_block_unitaries(spec: HEASpec, weights):
    """weights (S, 3, n) -> (Ur, Ui), each (n_blocks, 2^n, 2^n) float32.

    Sublayer unitaries are built batched, then folded per block.  Blocks
    are grouped by linear_depth so the fold is a short static chain.
    """
    n = spec.n_qubits
    dim = spec.dim
    sub_r, sub_i = _sublayer_unitary(weights, n)

    blocks_r, blocks_i = [], []
    s = 0
    i = 0
    while i < spec.n_blocks:
        ld = spec.block_configs[i][1]
        j = i
        while j < spec.n_blocks and spec.block_configs[j][1] == ld:
            j += 1
        g = j - i  # group of g consecutive blocks with equal linear_depth
        if ld == 0:  # encoding-only block: identity ansatz
            eye = torch.eye(dim, dtype=torch.float32, device=weights.device)
            ur = eye.expand(g, dim, dim)
            ui = torch.zeros((g, dim, dim), dtype=torch.float32,
                             device=weights.device)
        else:
            gr = sub_r[s:s + g * ld].reshape(g, ld, dim, dim)
            gi = sub_i[s:s + g * ld].reshape(g, ld, dim, dim)
            ur, ui = gr[:, 0], gi[:, 0]
            for d in range(1, ld):
                ar, ai = gr[:, d], gi[:, d]
                ur, ui = ar @ ur - ai @ ui, ar @ ui + ai @ ur
        blocks_r.append(ur)
        blocks_i.append(ui)
        s += g * ld
        i = j
    return torch.cat(blocks_r, 0), torch.cat(blocks_i, 0)


def encoding_phases(spec: HEASpec, x):
    """Raw encoding phases φ (n_blocks, batch, 2^n):
    φ_{b,k} = ½ Σ_i zsign[k, i] · x_{b,i}, x block-major (batch, nb·n).
    Leading axes carry over: x (S, batch, nb·n) -> φ (S, n_blocks, batch,
    2^n), each seed's slice elementwise equal to its own call.

    Written as an explicit sum over the K = n qubits, not a matmul, so it
    stays exact fp32 whatever the matmul precision (TF32 rounding here
    random-walks into ~2% output error over a 60-block chain).  At Q10 and
    a batch of 8192 it is 60 × 8192 × 1024 × 4 B = 2.0 GB."""
    n = spec.n_qubits
    xb = x.reshape(*x.shape[:-1], spec.n_blocks, n).transpose(-3, -2)
    zsgn = _table(z_signs(n), x)                         # (D, n)
    phi = xb[..., 0, None] * zsgn[:, 0]
    for i in range(1, n):
        phi = phi + xb[..., i, None] * zsgn[:, i]
    return (0.5 * phi).contiguous()


def fold_block_mats(spec: HEASpec, weights):
    """weights (S, 3, n) -> (mt_r, mt_i), each (n_blocks, D, D) float32
    contiguous: the block matrices of :func:`prepare_chain`, by batched
    products under autograd.  The plain path, and the oracle of the compile
    kernel (ops/cuda_ucomp.compile_block_mats)."""
    ur, ui = compile_block_unitaries(spec, weights)      # (B, D, D)
    hk = _table(hadamard_kron(spec.n_qubits), weights)
    uh_r = ur @ hk
    uh_i = ui @ hk
    m_r = torch.cat([hk @ uh_r[:-1], uh_r[-1:]], 0)
    m_i = torch.cat([hk @ uh_i[:-1], uh_i[-1:]], 0)
    return (m_r.transpose(1, 2).contiguous(),
            m_i.transpose(1, 2).contiguous())


def prepare_chain(spec: HEASpec, weights, x):
    """Chain operands (counterpart of pallas_hea._prepare).

    Since RX(θ) = H RZ(θ) H, each encoding layer is H·D(x_b)·H with the
    diagonal D(x_b)_k = e^{-i φ_{b,k}}.  Folding the Hadamards into the
    batch-independent block unitaries, the circuit is

        ψ = M_B D(x_B) M_{B-1} ... M_1 D(x_1) s0,
        M_b = H U_b H (b < B),  M_B = U_B H,  s0 = H|0…0⟩ = uniform.

    Returns (mt_r, mt_i, phi): the block matrices transposed for
    row-vector products, (nb, D, D) each, and the raw phases (nb, batch, D).
    """
    return (*fold_block_mats(spec, weights), encoding_phases(spec, x))


def _kara(sr, si, tr, ti):
    """(sr + i si) @ (tr + i ti) in 3 real matmuls (Karatsuba)."""
    t1 = sr @ tr
    t2 = si @ ti
    t3 = (sr + si) @ (tr + ti)
    return t1 - t2, t3 - t1 - t2


def chain_dense(mt_r, mt_i, phi):
    """Plain PyTorch block chain: (mt_r, mt_i, phi) -> (sr, si).

    s_1 = D(x_1)/√D;  s <- D(x_{b+1}) ⊙ (s·M_bᵀ) for b < nb;  out = s·M_nbᵀ.
    The plain version of the CUDA kernel (ops/cuda_hea.block_chain)."""
    nb, _, dim = phi.shape
    inv_sqrt = float(1.0 / np.sqrt(dim))
    sr = torch.cos(phi[0]) * inv_sqrt                    # D(x_1) · H|0>
    si = -torch.sin(phi[0]) * inv_sqrt
    for b in range(nb - 1):
        ur, ui = _kara(sr, si, mt_r[b], mt_i[b])
        pr = torch.cos(phi[b + 1])
        pi = -torch.sin(phi[b + 1])
        sr, si = pr * ur - pi * ui, pr * ui + pi * ur
    return _kara(sr, si, mt_r[nb - 1], mt_i[nb - 1])


def chain_dense_saved(mt_r, mt_i, phi):
    """:func:`chain_dense` that also returns the backward's residuals:
    (sr, si, states_r, states_i), states (nb, N, D) the input state of each
    block.  The plain version of the CUDA kernel's residual variant."""
    nb, _, dim = phi.shape
    inv_sqrt = float(1.0 / np.sqrt(dim))
    sr = torch.cos(phi[0]) * inv_sqrt
    si = -torch.sin(phi[0]) * inv_sqrt
    states_r, states_i = [sr], [si]
    for b in range(nb - 1):
        ur, ui = _kara(sr, si, mt_r[b], mt_i[b])
        pr = torch.cos(phi[b + 1])
        pi = -torch.sin(phi[b + 1])
        sr, si = pr * ur - pi * ui, pr * ui + pi * ur
        states_r.append(sr)
        states_i.append(si)
    out_r, out_i = _kara(sr, si, mt_r[nb - 1], mt_i[nb - 1])
    return out_r, out_i, torch.stack(states_r), torch.stack(states_i)


def chain_backward_dense(mt_r, mt_i, phi, residuals, gr, gi):
    """Reverse sweep of the chain, written out (no autograd): the
    cotangent (gr, gi) of the output -> (mbar_r, mbar_i, phibar), the
    cotangents of mt_r, mt_i and phi.  ``residuals`` = (states_r, states_i)
    from :func:`chain_dense_saved`.  The plain version of the CUDA backward
    kernel, with the algebra of pallas_hea._bwd_kernel:

        ubar_{nb-1} = g;  for b = nb-1 .. 0:
            mbar_b = conj(s_b)ᵀ · ubar_b         (summed over the batch)
            sbar_b = ubar_b · conj(mt_b)ᵀ
            phibar_b, ubar_{b-1} from sbar_b and D_b = cos φ_b − i sin φ_b

    The post-matmul state u_{b-1} = conj(D_b) ⊙ s_b is recovered from the
    saved input state (|D_b| = 1) instead of being saved."""
    states_r, states_i = residuals
    nb, _, dim = phi.shape
    inv_sqrt = float(1.0 / np.sqrt(dim))
    mbar_r, mbar_i, phibar = [], [], []
    ubr, ubi = gr, gi
    for b in range(nb - 1, -1, -1):
        sr, si = states_r[b], states_i[b]
        mr, mi = _kara(sr.T, -si.T, ubr, ubi)
        mbar_r.append(mr)
        mbar_i.append(mi)
        sbr, sbi = _kara(ubr, ubi, mt_r[b].T, -mt_i[b].T)
        pr = torch.cos(phi[b])
        pi = -torch.sin(phi[b])
        if b == 0:   # s_1 = inv_sqrt · (cos φ_0, −sin φ_0)
            phibar.append(inv_sqrt * (sbr * pi - sbi * pr))
            break
        ur, ui = pr * sr + pi * si, pr * si - pi * sr
        dbr = ur * sbr + ui * sbi
        dbi = -ui * sbr + ur * sbi
        phibar.append(dbr * pi - dbi * pr)
        ubr, ubi = pr * sbr + pi * sbi, pr * sbi - pi * sbr
    return (torch.stack(mbar_r[::-1]), torch.stack(mbar_i[::-1]),
            torch.stack(phibar[::-1]))


def forward_dense(spec: HEASpec, weights, x):
    """Final statevector (sr, si) via the compiled block-unitary chain."""
    if not spec.uniform_encode:
        raise ValueError("dense engine requires n_encode == n_qubits per block")
    return chain_dense(*prepare_chain(spec, weights, x))


# ── gates path: literal per-gate application (oracle) ───────────────────────

def forward_gates(spec: HEASpec, weights, x):
    """Gate-by-gate statevector evolution, the literal oracle."""
    n = spec.n_qubits
    sr, si = _init_state(x.shape[0], spec.dim, x.device)
    col = 0
    sub = 0
    for n_encode, linear_depth in spec.block_configs:
        for j in range(n_encode):
            if col < x.shape[1]:
                sr, si = _rx_single(sr, si, j % n, x[:, col], n)
            col += 1
        for _ in range(linear_depth):
            w = weights[sub]  # (3, n)
            for i in range(n):
                sr, si = _apply_ry(sr, si, i, torch.cos(w[0, i] / 2),
                                   torch.sin(w[0, i] / 2), n)
                sr, si = _apply_rz(sr, si, i, w[1, i] / 2, n)
                sr, si = _apply_ry(sr, si, i, torch.cos(w[2, i] / 2),
                                   torch.sin(w[2, i] / 2), n)
            sr, si = _apply_ring(sr, si, n)
            sub += 1
    return sr, si


# ── expectation ──────────────────────────────────────────────────────────────

def diag_expectation_pair(sr, si, diag):
    """⟨H⟩ for diagonal H: Σ_k |ψ_k|² d_k -> (batch, 1).  An elementwise
    product and a sum, exact fp32 whatever the matmul precision: this
    reduction is the model output.  With ``UNPIN_EXPECT`` on `cuda`,
    :func:`diag_expectation_unpinned`."""
    if UNPIN_EXPECT and sr.device.type == 'cuda':
        return diag_expectation_unpinned(sr, si, diag)
    return ((sr * sr + si * si) * diag).sum(-1, keepdim=True)


def diag_expectation_unpinned(sr, si, diag):
    """⟨H⟩ as a one-pass bf16 product would give it: |ψ_k|² (fp32) and d_k
    rounded to bf16, their products (exact) summed in fp32 -> (batch, 1)."""
    return (round_bf16(sr * sr + si * si) * round_bf16(diag)).sum(
        -1, keepdim=True)


def pauli_sum_total(sr, si, pauli, n_qubits):
    """Raw Σ_q ⟨P_q⟩ for P ∈ {X, Y} -> (batch,)."""
    total = torch.zeros(sr.shape[0], dtype=torch.float32, device=sr.device)
    for q in range(n_qubits):
        r0, r1 = _halves(sr, q, n_qubits)
        i0, i1 = _halves(si, q, n_qubits)
        if pauli == 'X':
            # <X_q> = 2 Re Σ conj(ψ_0) ψ_1
            val = 2.0 * (r0 * r1 + i0 * i1).sum(dim=(1, 2))
        elif pauli == 'Y':
            # <Y_q> = 2 Im Σ conj(ψ_0) ψ_1
            val = 2.0 * (r0 * i1 - i0 * r1).sum(dim=(1, 2))
        else:
            raise ValueError(f"pauli must be X or Y, got {pauli}")
        total = total + val
    return total


def pauli_sum_expectation_pair(sr, si, pauli, n_qubits, offset, coeff):
    """⟨offset + coeff·Σ_i P_i⟩ for P ∈ {X, Y} -> (batch, 1)."""
    total = pauli_sum_total(sr, si, pauli, n_qubits)
    return (offset + coeff * total)[:, None]


# ── public API ───────────────────────────────────────────────────────────────

FUSED_MIN_QUBITS = 8  # the JAX package auto-routes n >= 8 to its fused engines

ENGINES = ('dense', 'gates', 'fused', 'pallas', 'embed', 'pfused')

# The sharded engines (parallel/shard_engine.py): never chosen by 'auto';
# the Solver's --shard amp|pipe installs their group first.
SHARDED_ENGINES = ('amp', 'pipe')


def resolve_engine(engine, n_qubits: int, device) -> str:
    """Engine name -> the engine that runs.  ``'auto'``: below
    FUSED_MIN_QUBITS the block-chain kernels (``'pallas'``) on a card and
    the plain chain (``'dense'``) on the CPU; from there the fused-group
    chain kernels (``'pfused'``) on a card up to
    cuda_fused.AUTO_MAX_QUBITS, the grouped-kron engine (``'fused'``) above
    and on the CPU.  Explicit engines are honoured on either device, the
    sharded ones ('amp', 'pipe') among them; an unknown name raises."""
    if engine in ('auto', None):
        cuda = torch.device(device).type == 'cuda'
        if n_qubits >= FUSED_MIN_QUBITS:
            from quanonet_torch.ops.cuda_fused import AUTO_MAX_QUBITS
            return 'pfused' if cuda and n_qubits <= AUTO_MAX_QUBITS \
                else 'fused'
        return 'pallas' if cuda else 'dense'
    if engine not in ENGINES + SHARDED_ENGINES:
        raise ValueError(f"unknown engine '{engine}' (choose from "
                         f"{('auto',) + ENGINES + SHARDED_ENGINES})")
    return engine


def resolve_inference_engine(engine, n_qubits: int, device) -> str:
    """Engine choice for no-grad callers (infer.py, serve.py): as
    :func:`resolve_engine`, except that at 15-16 qubits on a card ``auto``
    takes the primal-only fused-group chain kernel, which serves those
    widths but cannot train them (the JAX package's
    hea.resolve_inference_engine)."""
    if engine in ('auto', None) and torch.device(device).type == 'cuda':
        from quanonet_torch.ops.cuda_fused import (
            MAX_QUBITS, TRAIN_MAX_QUBITS,
        )
        if TRAIN_MAX_QUBITS < n_qubits <= MAX_QUBITS:
            return 'pfused'
    return resolve_engine(engine, n_qubits, device)


def hea_forward_pair(spec: HEASpec, weights, x, engine='auto'):
    """Evolve |0…0⟩; returns (sr, si) each (batch, 2^n) float32."""
    engine = resolve_engine(engine, spec.n_qubits, x.device)
    if engine in SHARDED_ENGINES:
        raise ValueError(
            f"engine '{engine}' computes expectations only (the state is "
            f"sharded over the ranks and never gathered); use "
            f"hea_expectation, or a single-device engine for the state")
    if engine == 'dense':
        return forward_dense(spec, weights, x)
    if engine == 'gates':
        return forward_gates(spec, weights, x)
    if engine == 'fused':
        from quanonet_torch.ops.fused_gates import forward_fused
        return forward_fused(spec, weights, x)
    if engine == 'pfused':
        from quanonet_torch.ops.cuda_fused import forward_pfused
        return forward_pfused(spec, weights, x)
    if engine == 'embed':
        from quanonet_torch.ops.cuda_embed import forward_embed
        return forward_embed(spec, weights, x)
    from quanonet_torch.ops.cuda_hea import forward_pallas
    return forward_pallas(spec, weights, x)


def hea_forward_state(spec: HEASpec, weights, x, engine='auto'):
    """Complex statevector (batch, 2^n) complex64 from
    :func:`hea_forward_pair`: a test and analysis helper; the engines and
    kernels work on the split-real pair."""
    sr, si = hea_forward_pair(spec, weights, x, engine=engine)
    return torch.complex(sr, si)


def hea_expectation(spec: HEASpec, weights, x, diag=None, pauli='Z',
                    offset=0.0, coeff=0.0, engine='auto'):
    """Full circuit + measurement.  Returns (batch, 1) float32.

    diag: (2^n,) diagonal Hamiltonian (includes offset/coeff) when pauli='Z';
    offset/coeff parameterise Σ X_i / Σ Y_i observables otherwise.
    """
    resolved = resolve_engine(engine, spec.n_qubits, x.device)
    if pauli == 'Z' and diag is None:
        raise ValueError("Z-basis measurement requires a diagonal")
    if resolved in SHARDED_ENGINES:
        from quanonet_torch.parallel.shard_engine import sharded_expectation
        return sharded_expectation(spec, weights, x, diag, pauli=pauli,
                                   offset=offset, coeff=coeff)
    if pauli == 'Z':
        diag = torch.as_tensor(diag, dtype=torch.float32, device=x.device)
        if resolved == 'pallas':
            from quanonet_torch.ops.cuda_hea import hea_expectation_pallas
            return hea_expectation_pallas(spec, weights, x, diag)
        if resolved == 'pfused':
            from quanonet_torch.ops.cuda_fused import hea_expectation_pfused
            return hea_expectation_pfused(spec, weights, x, diag)
        if resolved == 'embed':
            from quanonet_torch.ops.cuda_embed import hea_expectation_embed
            return hea_expectation_embed(spec, weights, x, diag)
    sr, si = hea_forward_pair(spec, weights, x, engine=resolved)
    if pauli == 'Z':
        return diag_expectation_pair(sr, si, diag)
    return pauli_sum_expectation_pair(sr, si, pauli, spec.n_qubits,
                                      offset, coeff)


def init_ansatz_weights(spec: HEASpec, generator=None, device=None):
    """U(-π, π) init from ``generator`` (drawn on the CPU, so one seed
    gives the same weights on every device)."""
    w = torch.empty(spec.weight_shape(), dtype=torch.float32)
    w.uniform_(-np.pi, np.pi, generator=generator)
    return w.to(device) if device is not None else w
