"""
The block-matrix compile through the hand-written CUDA kernels
``csrc/ucomp.cu`` (counterpart of quanonet_tpu/ops/pallas_ucomp.py, whose
``_fwd_kernel`` and ``_bwd_kernel`` they replace): the batch-independent
half of a step, from the ansatz weights to the Hadamard-folded,
transposed block matrices that the block chain consumes.

Off by default, as in the JAX package: ``ops/cuda_hea`` takes this path
only with ``USE_UCOMP=1``; otherwise the matrices come from
:func:`quanonet_torch.ops.hea.fold_block_mats` (batched products under
autograd), which is also the oracle here.

Structure, per sublayer s (transposed from the start):

    S_sᵀ = U1_sᵀ · (z_s[:, None] ⊙ U2_sᵀ) · Pᵀ = U1_sᵀ · B′_s

with P the ring permutation, folded into B′ as a column gather.  Per
block: the fold of its ``ld`` sublayers acc = S_0ᵀ · … · S_{ld-1}ᵀ, then
mt_b = H · acc · R_b with R_b = H, and I for the final block.

Split of labour, as the JAX module has it: everything elementwise
(cos/sin of the half angles, the RY factor products, the RZ diagonal as an
explicit fp32 sum, the gather) is PyTorch under autograd; the kernels do
only the matrix chains, and their VJP is a kernel too (:class:`UComp`).
The operands are unpacked (S, D, D) tensors and the index of the block
whose right factor is I: the JAX module's block-diagonal packing served
its matrix unit's tile and has no counterpart here.

Applicability: one uniform linear_depth >= 1 across blocks and at most 7
qubits (:func:`ucomp_applicable`).  CPU tensors take the plain versions
:func:`ucomp_dense` and :func:`ucomp_backward_dense`; CUDA tensors launch
the kernels or raise.
"""
import ctypes
from functools import lru_cache

import numpy as np
import torch

from quanonet_torch.ops import _build
from quanonet_torch.ops.gates import (
    bit_table, hadamard_kron, ring_apply, z_signs,
)

KERNEL = 'ucomp'
MAX_QUBITS = 7
THREADS = 256     # of a CTA, as in csrc/ucomp.cu
MAX_ROWS = 4      # rows of a panel one thread owns, as there

# Launches since import: ``launches`` counts the forward kernel,
# ``bwd_launches`` the backward (its two kernels count as one).
launches = 0
bwd_launches = 0

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def ucomp_applicable(spec) -> bool:
    """One uniform linear_depth >= 1, at most 7 qubits, at least one
    block."""
    lds = {ld for _, ld in spec.block_configs}
    return (len(lds) == 1 and lds != {0} and spec.n_qubits <= MAX_QUBITS
            and spec.n_blocks >= 1)


@lru_cache(maxsize=None)
def _lib():
    lib = _build.load(KERNEL)
    lib.ucomp_forward.argtypes = [_VP] * 5 + [_I] * 5 + [_F, _VP]
    lib.ucomp_forward.restype = _I
    lib.ucomp_backward.argtypes = [_VP] * 12 + [_I] * 5 + [_F, _VP]
    lib.ucomp_backward.restype = _I
    lib.ucomp_error_string.argtypes = [_I]
    lib.ucomp_error_string.restype = ctypes.c_char_p
    return lib


# ── the plain versions ───────────────────────────────────────────────────────

def _hadamard(dim, like):
    return torch.as_tensor(hadamard_kron(int(np.log2(dim))),
                           dtype=torch.float32, device=like.device)


def _right_factors(nb, dim, last, like):
    """R (nb, D, D): H for every block, I for block ``last``."""
    r = _hadamard(dim, like).repeat(nb, 1, 1)
    if 0 <= last < nb:
        r[last] = torch.eye(dim, dtype=torch.float32, device=like.device)
    return r


def _cmul(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi), four real products."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _sublayer_products(u1t, br, bi, ld):
    """S = U1ᵀ · B′ per sublayer, (nb, ld, D, D) each."""
    dim = u1t.shape[-1]
    return ((u1t @ br).reshape(-1, ld, dim, dim),
            (u1t @ bi).reshape(-1, ld, dim, dim))


def ucomp_dense(u1t, br, bi, ld, last):
    """Plain PyTorch block-matrix compile: u1t, br, bi (nb·ld, D, D) ->
    (mt_r, mt_i), each (nb, D, D).  Per block the fold of its ``ld``
    products U1ᵀ·B′, then H · acc · R with R = H, and I for block ``last``
    (-1: none).  The plain version of the CUDA forward kernel."""
    dim = u1t.shape[-1]
    sr, si = _sublayer_products(u1t, br, bi, ld)
    ar, ai = sr[:, 0], si[:, 0]
    for d in range(1, ld):
        ar, ai = _cmul(ar, ai, sr[:, d], si[:, d])
    h = _hadamard(dim, u1t)
    r = _right_factors(ar.shape[0], dim, last, u1t)
    return h @ ar @ r, h @ ai @ r


def ucomp_backward_dense(u1t, br, bi, ld, last, gr, gi):
    """The VJP of :func:`ucomp_dense`, written out (no autograd): the
    cotangent (gr, gi) of (mt_r, mt_i) -> (u1bar, bbar_r, bbar_i), each
    (nb·ld, D, D).  The plain version of the CUDA backward kernel, with the
    algebra of pallas_ucomp._bwd_kernel: the sublayer products and fold
    prefixes are recomputed, accbar = H ḡ R (H, R symmetric and real), and
    for d = ld-1 .. 0

        S̄_d = acc_{d-1}ᴴ · accbar,   accbar <- accbar · S_dᴴ     (d > 0)
        Ū1ᵀ = S̄r · B′rᵀ + S̄i · B′iᵀ,   B̄′ = (U1ᵀ)ᵀ · S̄.
    """
    dim = u1t.shape[-1]
    sr, si = _sublayer_products(u1t, br, bi, ld)
    nb = sr.shape[0]
    pres = [(sr[:, 0], si[:, 0])]
    for d in range(1, ld - 1):    # the last fold product is never needed
        pres.append(_cmul(*pres[-1], sr[:, d], si[:, d]))
    h = _hadamard(dim, u1t)
    r = _right_factors(nb, dim, last, u1t)
    abar_r, abar_i = h @ gr @ r, h @ gi @ r
    t = lambda a: a.transpose(-1, -2)
    sbar_r = [None] * ld
    sbar_i = [None] * ld
    for d in range(ld - 1, 0, -1):
        pr, pi = pres[d - 1]
        sbar_r[d] = t(pr) @ abar_r + t(pi) @ abar_i
        sbar_i[d] = t(pr) @ abar_i - t(pi) @ abar_r
        abar_r, abar_i = (abar_r @ t(sr[:, d]) + abar_i @ t(si[:, d]),
                          abar_i @ t(sr[:, d]) - abar_r @ t(si[:, d]))
    sbar_r[0], sbar_i[0] = abar_r, abar_i
    sbar_r = torch.stack(sbar_r, 1).reshape(nb * ld, dim, dim)
    sbar_i = torch.stack(sbar_i, 1).reshape(nb * ld, dim, dim)
    return (sbar_r @ t(br) + sbar_i @ t(bi), t(u1t) @ sbar_r,
            t(u1t) @ sbar_i)


# ── the kernels ──────────────────────────────────────────────────────────────

def panel_rows(dim):
    """Rows of H one CTA carries through a block: a thread owns one column
    and up to MAX_ROWS rows; from D = 64 it owns all four, so that each
    operator element it reads is used four times."""
    row_groups = max(1, THREADS // dim)
    return min(dim, row_groups * (MAX_ROWS if dim >= 64 else 1))


def _check(named, device):
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, u1t on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_operands(u1t, br, bi, ld, last):
    if u1t.dim() != 3 or u1t.shape[1] != u1t.shape[2]:
        raise ValueError(f"u1t must be (S, D, D), got {tuple(u1t.shape)}")
    s, dim, _ = u1t.shape
    if dim < 2 or dim > 2 ** MAX_QUBITS or dim & (dim - 1):
        raise ValueError(f"the compile kernel takes D = 2..128, a power of "
                         f"two, got {dim}")
    if ld < 1 or s < ld or s % ld:
        raise ValueError(f"{s} sublayers do not make blocks of {ld}")
    nb = s // ld
    if nb > 65535:
        raise ValueError(f"{nb} blocks are too many for one launch")
    if not -1 <= last < nb:
        raise ValueError(f"last must be -1 or a block index < {nb}, got "
                         f"{last}")
    _check((('u1t', u1t, (s, dim, dim)), ('br', br, (s, dim, dim)),
            ('bi', bi, (s, dim, dim))), u1t.device)
    if u1t.device.type != 'cuda':
        raise ValueError(f"the compile kernels take CUDA tensors, got "
                         f"{u1t.device}; ucomp_dense is the plain version")
    return nb, dim


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.ucomp_error_string(err).decode()} (cudaError {err})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def ucomp_forward(u1t, br, bi, ld, last):
    """The forward kernel on CUDA tensors: (mt_r, mt_i), each (nb, D, D)."""
    global launches
    nb, dim = _check_operands(u1t, br, bi, ld, last)
    dev = u1t.device
    mt_r = torch.empty((nb, dim, dim), dtype=torch.float32, device=dev)
    mt_i = torch.empty((nb, dim, dim), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.ucomp_forward(
            u1t.data_ptr(), br.data_ptr(), bi.data_ptr(), mt_r.data_ptr(),
            mt_i.data_ptr(), nb, ld, dim, panel_rows(dim), last,
            float(1.0 / np.sqrt(dim)), _stream(dev))
    _raise_on(lib, err, 'ucomp_forward')
    launches += 1
    return mt_r, mt_i


def ucomp_backward(u1t, br, bi, ld, last, gr, gi):
    """The backward kernels on CUDA tensors: the cotangent (gr, gi) of
    (mt_r, mt_i) -> (u1bar, bbar_r, bbar_i).  Deterministic: two calls on
    equal inputs give equal bits."""
    global bwd_launches
    nb, dim = _check_operands(u1t, br, bi, ld, last)
    dev = u1t.device
    _check((('gr', gr, (nb, dim, dim)), ('gi', gi, (nb, dim, dim))), dev)
    out = [torch.empty_like(u1t) for _ in range(3)]
    # the panels before each operator and the cotangents after it
    scratch = [torch.empty((nb, 2 * ld, dim, dim), dtype=torch.float32,
                           device=dev) for _ in range(4)]
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.ucomp_backward(
            u1t.data_ptr(), br.data_ptr(), bi.data_ptr(), gr.data_ptr(),
            gi.data_ptr(), *(t.data_ptr() for t in scratch),
            *(t.data_ptr() for t in out), nb, ld, dim, panel_rows(dim), last,
            float(1.0 / np.sqrt(dim)), _stream(dev))
    _raise_on(lib, err, 'ucomp_backward')
    bwd_launches += 1
    return tuple(out)


class UComp(torch.autograd.Function):
    """(u1t, br, bi) -> (mt_r, mt_i) with the backward kernel as its
    gradient (the counterpart of pallas_ucomp._make_ucomp).  On CPU tensors
    both passes are the plain versions."""

    @staticmethod
    def forward(ctx, u1t, br, bi, ld, last):
        ctx.save_for_backward(u1t, br, bi)
        ctx.ld, ctx.last = ld, last
        if u1t.device.type == 'cpu':
            return ucomp_dense(u1t, br, bi, ld, last)
        return ucomp_forward(u1t, br, bi, ld, last)

    @staticmethod
    def backward(ctx, gr, gi):
        u1t, br, bi = ctx.saved_tensors
        if u1t.device.type == 'cpu':
            grads = ucomp_backward_dense(u1t, br, bi, ctx.ld, ctx.last,
                                         gr, gi)
        else:
            grads = ucomp_backward(u1t, br, bi, ctx.ld, ctx.last,
                                   gr.contiguous(), gi.contiguous())
        return (*grads, None, None)


def ucomp(u1t, br, bi, ld, last):
    """(u1t, br, bi) -> (mt_r, mt_i): :func:`ucomp_dense`, through the CUDA
    kernels for CUDA tensors.  Operands (nb·ld, D, D) float32, contiguous."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u1t, br, bi)):
        return UComp.apply(u1t, br, bi, ld, last)
    if u1t.device.type == 'cpu':
        return ucomp_dense(u1t, br, bi, ld, last)
    return ucomp_forward(u1t, br, bi, ld, last)


# ── from the weights to the operands ─────────────────────────────────────────

@lru_cache(maxsize=None)
def _static_tables(n_qubits, device):
    """Per (n, device): eq, diff_t (n, D, D) with eq[q, i, j] = [bit q of i
    equals bit q of j], diff_t[q, i, j] = bit_q(j) - bit_q(i); the Z signs
    (D, n)."""
    bits = bit_table(n_qubits).T                         # (n, D)
    eq = (bits[:, :, None] == bits[:, None, :]).astype(np.float32)
    diff_t = (bits[:, None, :] - bits[:, :, None]).astype(np.float32)
    return (torch.as_tensor(eq, device=device),
            torch.as_tensor(diff_t, device=device),
            torch.as_tensor(z_signs(n_qubits), device=device))


def compile_operands(spec, weights):
    """weights (S, 3, n) -> (u1t, br, bi), each (S, D, D): the transposed
    RY layer and B′ = (z ⊙row U2ᵀ)·Pᵀ of every sublayer.  Elementwise
    PyTorch, differentiated by autograd."""
    n = spec.n_qubits
    n_sub = weights.shape[0]
    eq, diff_t, zsgn = _static_tables(n, weights.device)
    half = weights * 0.5                                 # (S, 3, n)
    # both RY layers in one batch: rows 0 (RY) then rows 2 (RY'), (2S, n)
    ry = half[:, 0::2].transpose(0, 1).reshape(2 * n_sub, n)
    c = torch.cos(ry)[:, :, None, None]
    s = torch.sin(ry)[:, :, None, None]
    # ∏_q [eq_q·cos + (j_q - i_q)·sin]: sequential multiplies, so that
    # autograd gives the exact factor-rule backward
    ut = None
    for q in range(n):
        f = torch.addcmul(eq[q] * c[:, q], diff_t[q], s[:, q])
        ut = f if ut is None else ut * f                 # (2S, D, D)
    u1t, u2t = ut[:n_sub], ut[n_sub:]
    # K = n <= 7: an explicit sum, exact in fp32 whatever the matmul mode
    ph = (half[:, 1, None, :] * zsgn).sum(-1)            # (S, D)
    zr = torch.cos(ph)[:, :, None]
    zi = -torch.sin(ph)[:, :, None]
    # the ring permutation, folded in as a column gather [..., inv]
    br, bi = ring_apply(n)(zr * u2t, zi * u2t)
    return u1t, br, bi


def compile_block_mats(spec, weights):
    """weights (S, 3, n) -> (mt_r, mt_i), each (n_blocks, D, D) float32
    contiguous: the Hadamard-folded block matrices, transposed for
    row-vector products, that the chain kernels consume (the contract of
    :func:`quanonet_torch.ops.hea.fold_block_mats`)."""
    if not ucomp_applicable(spec):
        raise ValueError(
            "the compile kernel needs one uniform linear_depth >= 1 and at "
            f"most {MAX_QUBITS} qubits, got {spec}")
    ld = spec.block_configs[0][1]
    return ucomp(*compile_operands(spec, weights), ld, spec.n_blocks - 1)
