"""
The block-matrix compile through the hand-written CUDA kernels
``csrc/ucomp.cu`` (counterpart of quanonet_tpu/ops/pallas_ucomp.py, whose
``_fwd_kernel`` and ``_bwd_kernel`` they replace): the batch-independent
half of a step, from the ansatz weights to the Hadamard-folded,
transposed block matrices that the block chain consumes.

The default on ``cuda`` (the JAX package's default is off):
``ops/cuda_hea.block_mats`` takes this path for CUDA weights where it
applies, unless ``USE_UCOMP=0`` forces the fold
(:func:`quanonet_torch.ops.hea.fold_block_mats`, batched products under
autograd, also the oracle here); CPU weights take the fold unless
``USE_UCOMP=1``.

Structure, per sublayer s (transposed from the start):

    S_sᵀ = U1_sᵀ · (z_s[:, None] ⊙ U2_sᵀ) · Pᵀ = U1_sᵀ · B′_s

with P the ring permutation, folded into B′ as a column gather.  Per
block: the fold of its ``ld`` sublayers acc = S_0ᵀ · … · S_{ld-1}ᵀ, then
mt_b = H · acc · R_b with R_b = H, and I for the final block.

The kernels take the weights (S, 3, n) and nothing else: B4f applies the
compile as gate passes on the rows of H (RY, the RZ phase, RY′, the ring
gather per sublayer, then H), B4b walks each row back and writes the
weights' cotangent w̄ (S, 3, n) directly; :class:`UComp` joins them as one
autograd function over the weights.  The plain version of the same function
keeps the matrix form on purpose, an oracle independent of the kernels'
gate form: the forward is :func:`ucomp_dense` of :func:`compile_operands`
(elementwise PyTorch: cos/sin of the half angles, the RY factor products,
the RZ diagonal as an explicit fp32 sum, the gather), the backward
:func:`ucomp_backward_dense`'s operand cotangents carried through
:func:`compile_operands`' VJP.

The bf16 operand mode (``UCOMP_BF16=1``, off by default; the JAX package's
switch of the same name): every product of the TPU kernel's matrix form on
bf16-rounded operands with fp32 sums, the fold three-product.  The gate
form has no product to round, so the mode takes the matrix form's split:
:func:`compile_operands` (elementwise PyTorch, under autograd) gives u1t,
br, bi, and :class:`UCompBf16` runs B4f-bf16 and B4b-bf16 (the product
chains in ``csrc/ucomp.cu``, ``mma.sync`` bf16) on them, the plain versions
:func:`ucomp_dense` / :func:`ucomp_backward_dense` with ``bf16=True``.
:func:`ucomp` reads the module attribute ``UCOMP_BF16`` at each call, so
every caller of the compile follows it.

Applicability: one uniform linear_depth >= 1 across blocks and at most 7
qubits (:func:`ucomp_applicable`).  CPU tensors take the plain versions;
CUDA tensors launch the kernels or raise.  The launch geometry (warps a
CTA, CTAs a block) comes from D, nb and the card's SM count
(:func:`ucomp_geometry`); the library handle and the SM count are read
once.
"""
import ctypes
import os
from collections import namedtuple
from functools import lru_cache

import numpy as np
import torch

from quanonet_torch.ops import _build
from quanonet_torch.ops.gates import (
    bf16_dot, bit_table, hadamard_kron, kara_bf16, ring_apply, z_signs,
)

KERNEL = 'ucomp'
MAX_QUBITS = 7
EVERY_BLOCK = -2  # ``last``: every block's right factor is I (kEveryBlock)
FWD_WARPS = 4     # warps of a forward CTA
BWD_WARPS = 8     # warps of a backward CTA

# The bf16 operand mode: '1' turns it on (read here once; callers and tests
# set the attribute).
UCOMP_BF16 = os.environ.get('UCOMP_BF16', '0') == '1'

# Launches since import: ``launches`` counts the forward kernel,
# ``bwd_launches`` the backward (with the CTAs' sum, when it runs, as one);
# ``bf16_launches`` and ``bf16_bwd_launches`` the bf16 mode's two kernels.
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0

Geometry = namedtuple('Geometry', 'warps ctas')

_VP, _I = ctypes.c_void_p, ctypes.c_int


def ucomp_applicable(spec) -> bool:
    """One uniform linear_depth >= 1, at most 7 qubits, at least one
    block."""
    lds = {ld for _, ld in spec.block_configs}
    return (len(lds) == 1 and lds != {0} and spec.n_qubits <= MAX_QUBITS
            and spec.n_blocks >= 1)


def row_groups(dim):
    """Row groups of a block: a warp carries min(32 / D, D) rows at once
    below D = 32 and one row from there (``Row::G`` in csrc/ucomp.cu)."""
    return dim // (1 if dim >= 32 else min(32 // dim, dim))


def ucomp_geometry(dim, nb, sms, backward=False):
    """(warps a CTA, CTAs a block) of the kernels at width D for nb
    blocks on a card of ``sms`` SMs.  The forward gives every warp one row
    group.  The backward doubles its CTAs a block from one until the grid
    covers the SMs or every warp has one row group: each CTA past the
    first costs a partial to sum, in a second launch."""
    groups = row_groups(dim)
    warps = min(BWD_WARPS if backward else FWD_WARPS, groups)
    most = -(-groups // warps)
    if not backward:
        return Geometry(warps, most)
    ctas = 1
    while ctas < most and nb * ctas < sms:
        ctas *= 2
    return Geometry(warps, min(ctas, most))


@lru_cache(maxsize=None)
def _lib():
    lib = _build.load(KERNEL)
    lib.ucomp_forward.argtypes = [_VP] * 3 + [_I] * 6 + [_VP]
    lib.ucomp_forward.restype = _I
    lib.ucomp_backward.argtypes = [_VP] * 5 + [_I] * 6 + [_VP]
    lib.ucomp_backward.restype = _I
    lib.ucomp_error_string.argtypes = [_I]
    lib.ucomp_error_string.restype = ctypes.c_char_p
    lib.ucomp_row_groups.argtypes = [_I]
    lib.ucomp_row_groups.restype = _I
    lib.ucomp_bf16_forward.argtypes = [_VP] * 6 + [_I] * 5 + [_VP]
    lib.ucomp_bf16_forward.restype = _I
    lib.ucomp_bf16_backward.argtypes = [_VP] * 9 + [_I] * 5 + [_VP]
    lib.ucomp_bf16_backward.restype = _I
    lib.ucomp_bf16_bytes.argtypes = [_I] * 3
    lib.ucomp_bf16_bytes.restype = ctypes.c_longlong
    for n in range(1, MAX_QUBITS + 1):
        if lib.ucomp_row_groups(n) != row_groups(2 ** n):
            raise RuntimeError(
                f"csrc/ucomp.cu has {lib.ucomp_row_groups(n)} row groups at "
                f"{n} qubits, cuda_ucomp.row_groups {row_groups(2 ** n)}")
    return lib


@lru_cache(maxsize=None)
def sm_count(index):
    """SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# ── the plain versions ───────────────────────────────────────────────────────

def _hadamard(dim, like):
    return torch.as_tensor(hadamard_kron(int(np.log2(dim))),
                           dtype=torch.float32, device=like.device)


def _right_factors(nb, dim, last, like):
    """R (nb, D, D): H for every block, I for block ``last`` (for every
    block when ``last`` is EVERY_BLOCK)."""
    if last == EVERY_BLOCK:
        return torch.eye(dim, dtype=torch.float32,
                         device=like.device).repeat(nb, 1, 1)
    r = _hadamard(dim, like).repeat(nb, 1, 1)
    if 0 <= last < nb:
        r[last] = torch.eye(dim, dtype=torch.float32, device=like.device)
    return r


def _cmul(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi), four real products."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _products(bf16):
    """(dot, complex product) of a mode: fp32 ``@`` and the four-product
    :func:`_cmul`, or the bf16 operand mode's :func:`gates.bf16_dot` and
    three-product :func:`gates.kara_bf16`."""
    return (bf16_dot, kara_bf16) if bf16 else (torch.matmul, _cmul)


def _sublayer_products(u1t, br, bi, ld, dot=torch.matmul):
    """S = U1ᵀ · B′ per sublayer, (nb, ld, D, D) each."""
    dim = u1t.shape[-1]
    return (dot(u1t, br).reshape(-1, ld, dim, dim),
            dot(u1t, bi).reshape(-1, ld, dim, dim))


def ucomp_dense(u1t, br, bi, ld, last, bf16=False):
    """Plain PyTorch block-matrix compile from the operands: u1t, br, bi
    (nb·ld, D, D) -> (mt_r, mt_i), each (nb, D, D).  Per block the fold of
    its ``ld`` products U1ᵀ·B′, then H · acc · R with R = H, and I for block
    ``last`` (-1: none; EVERY_BLOCK: all).  With ``bf16`` every product
    takes bf16-rounded operands (the fold three-product), as
    pallas_ucomp's ``_dot``/``_kara`` under ``UCOMP_BF16``: the plain
    version of the bf16 kernels."""
    dot, cmul = _products(bf16)
    dim = u1t.shape[-1]
    sr, si = _sublayer_products(u1t, br, bi, ld, dot)
    ar, ai = sr[:, 0], si[:, 0]
    for d in range(1, ld):
        ar, ai = cmul(ar, ai, sr[:, d], si[:, d])
    h = _hadamard(dim, u1t)
    r = _right_factors(ar.shape[0], dim, last, u1t)
    return dot(dot(h, ar), r), dot(dot(h, ai), r)


def ucomp_backward_dense(u1t, br, bi, ld, last, gr, gi, bf16=False):
    """The VJP of :func:`ucomp_dense`, written out (no autograd): the
    cotangent (gr, gi) of (mt_r, mt_i) -> (u1bar, bbar_r, bbar_i), each
    (nb·ld, D, D), with the algebra of pallas_ucomp._bwd_kernel: the
    sublayer products and fold prefixes are recomputed, accbar = H ḡ R
    (H, R symmetric and real), and for d = ld-1 .. 0

        S̄_d = acc_{d-1}ᴴ · accbar,   accbar <- accbar · S_dᴴ     (d > 0)
        Ū1ᵀ = S̄r · B′rᵀ + S̄i · B′iᵀ,   B̄′ = (U1ᵀ)ᵀ · S̄,

    each of them four real products; ``bf16`` rounds every product's
    operands as :func:`ucomp_dense` does.
    """
    dot, cmul = _products(bf16)
    dim = u1t.shape[-1]
    sr, si = _sublayer_products(u1t, br, bi, ld, dot)
    nb = sr.shape[0]
    pres = [(sr[:, 0], si[:, 0])]
    for d in range(1, ld - 1):    # the last fold product is never needed
        pres.append(cmul(*pres[-1], sr[:, d], si[:, d]))
    h = _hadamard(dim, u1t)
    r = _right_factors(nb, dim, last, u1t)
    abar_r, abar_i = dot(dot(h, gr), r), dot(dot(h, gi), r)
    t = lambda a: a.transpose(-1, -2)
    sbar_r = [None] * ld
    sbar_i = [None] * ld
    for d in range(ld - 1, 0, -1):
        pr, pi = pres[d - 1]
        sbar_r[d] = dot(t(pr), abar_r) + dot(t(pi), abar_i)
        sbar_i[d] = dot(t(pr), abar_i) - dot(t(pi), abar_r)
        abar_r, abar_i = (dot(abar_r, t(sr[:, d])) + dot(abar_i, t(si[:, d])),
                          dot(abar_i, t(sr[:, d])) - dot(abar_r, t(si[:, d])))
    sbar_r[0], sbar_i[0] = abar_r, abar_i
    sbar_r = torch.stack(sbar_r, 1).reshape(nb * ld, dim, dim)
    sbar_i = torch.stack(sbar_i, 1).reshape(nb * ld, dim, dim)
    return (dot(sbar_r, t(br)) + dot(sbar_i, t(bi)), dot(t(u1t), sbar_r),
            dot(t(u1t), sbar_i))


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


def compile_operands(weights):
    """weights (S, 3, n) -> (u1t, br, bi), each (S, D, D), D = 2^n: the
    transposed RY layer and B′ = (z ⊙row U2ᵀ)·Pᵀ of every sublayer.
    Elementwise PyTorch, differentiated by autograd."""
    n = weights.shape[-1]
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


def ucomp_weights_dense(w, ld, last, bf16=False):
    """The plain version of B4f: w (nb·ld, 3, n) -> (mt_r, mt_i), each
    (nb, D, D), as :func:`ucomp_dense` of :func:`compile_operands` (in the
    bf16 operand mode with ``bf16``)."""
    return ucomp_dense(*compile_operands(w), ld, last, bf16)


def ucomp_weights_backward_dense(w, ld, last, gr, gi, bf16=False):
    """The plain version of B4b: the cotangent (gr, gi) of (mt_r, mt_i) ->
    w̄ (nb·ld, 3, n), :func:`ucomp_backward_dense`'s operand cotangents
    carried through :func:`compile_operands`' VJP."""
    with torch.enable_grad():
        wd = w.detach().requires_grad_()
        ops = compile_operands(wd)
    cot = ucomp_backward_dense(*(o.detach() for o in ops), ld, last, gr, gi,
                               bf16)
    (wbar,) = torch.autograd.grad(ops, wd, cot)
    return wbar


# ── the kernels ──────────────────────────────────────────────────────────────

def _check(named, device):
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, w on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_weights(w, ld, last):
    """(nb, n) of weights w (nb·ld, 3, n) on the card; raises on anything
    the kernels do not take."""
    if w.dim() != 3 or w.shape[1] != 3:
        raise ValueError(f"w must be (S, 3, n), got {tuple(w.shape)}")
    s, _, n = w.shape
    if not 1 <= n <= MAX_QUBITS:
        raise ValueError(f"the compile kernels take 1..{MAX_QUBITS} qubits, "
                         f"got {n}")
    if ld < 1 or s < ld or s % ld:
        raise ValueError(f"{s} sublayers do not make blocks of {ld}")
    nb = s // ld
    if nb > 65535:
        raise ValueError(f"{nb} blocks are too many for one launch")
    if not EVERY_BLOCK <= last < nb:
        raise ValueError(f"last must be -1, EVERY_BLOCK ({EVERY_BLOCK}) or "
                         f"a block index < {nb}, got {last}")
    _check((('w', w, (s, 3, n)),), w.device)
    if w.device.type != 'cuda':
        raise ValueError(f"the compile kernels take CUDA tensors, got "
                         f"{w.device}; ucomp_weights_dense is the plain "
                         f"version")
    return nb, n


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.ucomp_error_string(err).decode()} (cudaError {err})")


def ucomp_forward(w, ld, last):
    """B4f on CUDA tensors: w (nb·ld, 3, n) -> (mt_r, mt_i), each
    (nb, D, D)."""
    global launches
    nb, n = _check_weights(w, ld, last)
    dim, dev = 2 ** n, w.device
    mt_r = torch.empty((nb, dim, dim), dtype=torch.float32, device=dev)
    mt_i = torch.empty((nb, dim, dim), dtype=torch.float32, device=dev)
    geo = ucomp_geometry(dim, nb, sm_count(dev.index))
    lib = _lib()
    err = _build.on_device(dev, lambda: lib.ucomp_forward(
        w.data_ptr(), mt_r.data_ptr(), mt_i.data_ptr(), n, nb, ld, last,
        geo.warps, geo.ctas, torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(lib, err, 'ucomp_forward')
    launches += 1
    return mt_r, mt_i


def ucomp_backward(w, ld, last, gr, gi):
    """B4b on CUDA tensors: the cotangent (gr, gi) of (mt_r, mt_i) -> w̄
    (nb·ld, 3, n).  Deterministic: two calls on equal inputs give equal
    bits."""
    global bwd_launches
    nb, n = _check_weights(w, ld, last)
    dim, dev = 2 ** n, w.device
    _check((('gr', gr, (nb, dim, dim)), ('gi', gi, (nb, dim, dim))), dev)
    geo = ucomp_geometry(dim, nb, sm_count(dev.index), backward=True)
    wbar = torch.empty_like(w)
    part = (torch.empty((nb, geo.ctas, ld * 3 * n), dtype=torch.float32,
                        device=dev) if geo.ctas > 1 else None)
    lib = _lib()
    err = _build.on_device(dev, lambda: lib.ucomp_backward(
        w.data_ptr(), gr.data_ptr(), gi.data_ptr(),
        None if part is None else part.data_ptr(), wbar.data_ptr(), n, nb,
        ld, last, geo.warps, geo.ctas,
        torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(lib, err, 'ucomp_backward')
    bwd_launches += 1
    return wbar


MAX_SMEM = 232448   # bytes of shared memory a CTA can use on the H100


def _check_operands(named, dev):
    if dev.type != 'cuda':
        raise ValueError(f"the bf16 compile kernels take CUDA tensors, got "
                         f"{dev}; ucomp_dense(..., bf16=True) is the plain "
                         f"version")
    _check(named, dev)


def _bf16_shape(u1t, ld, last):
    """(n, nb) of bf16 operands (nb·ld, D, D); raises on what the kernels
    do not take."""
    if u1t.dim() != 3 or u1t.shape[1] != u1t.shape[2]:
        raise ValueError(f"u1t must be (S, D, D), got {tuple(u1t.shape)}")
    s, dim = u1t.shape[0], u1t.shape[-1]
    n = dim.bit_length() - 1
    if dim != 2 ** n or not 1 <= n <= MAX_QUBITS:
        raise ValueError(f"D must be 2^1 .. 2^{MAX_QUBITS}, got {dim}")
    if ld < 1 or s < ld or s % ld:
        raise ValueError(f"{s} sublayers do not make blocks of {ld}")
    nb = s // ld
    if not EVERY_BLOCK <= last < nb:
        raise ValueError(f"last must be -1, EVERY_BLOCK ({EVERY_BLOCK}) or "
                         f"a block index < {nb}, got {last}")
    return n, nb


def _bf16_launch(n, nb, ld, dev, backward):
    """(ctas, scratch) of a bf16 launch: a CTA an SM at most, its planes in
    shared memory where they fit, else in a device-memory scratch."""
    ctas = min(nb, sm_count(dev.index))
    per_cta = _lib().ucomp_bf16_bytes(n, ld, int(backward))
    scratch = (None if per_cta <= MAX_SMEM else
               torch.empty((ctas, per_cta // 4), dtype=torch.float32,
                           device=dev))
    return ctas, scratch


def ucomp_bf16_forward(u1t, br, bi, ld, last):
    """B4f-bf16 on CUDA tensors: the operands u1t, br, bi (nb·ld, D, D) of
    :func:`compile_operands` -> (mt_r, mt_i), each (nb, D, D)."""
    global bf16_launches
    n, nb = _bf16_shape(u1t, ld, last)
    shape, dim, dev = tuple(u1t.shape), 2 ** n, u1t.device
    _check_operands((('u1t', u1t, shape), ('br', br, shape),
                     ('bi', bi, shape)), dev)
    ctas, scratch = _bf16_launch(n, nb, ld, dev, False)
    mt_r = torch.empty((nb, dim, dim), dtype=torch.float32, device=dev)
    mt_i = torch.empty((nb, dim, dim), dtype=torch.float32, device=dev)
    lib = _lib()
    err = _build.on_device(dev, lambda: lib.ucomp_bf16_forward(
        u1t.data_ptr(), br.data_ptr(), bi.data_ptr(), mt_r.data_ptr(),
        mt_i.data_ptr(), None if scratch is None else scratch.data_ptr(), n,
        nb, ld, last, ctas, torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(lib, err, 'ucomp_bf16_forward')
    bf16_launches += 1
    return mt_r, mt_i


def ucomp_bf16_backward(u1t, br, bi, ld, last, gr, gi):
    """B4b-bf16 on CUDA tensors: the cotangent (gr, gi) of (mt_r, mt_i) ->
    (u1bar, bbar_r, bbar_i), each (nb·ld, D, D).  Deterministic: no
    atomics."""
    global bf16_bwd_launches
    n, nb = _bf16_shape(u1t, ld, last)
    shape, dim, dev = tuple(u1t.shape), 2 ** n, u1t.device
    _check_operands((('u1t', u1t, shape), ('br', br, shape),
                     ('bi', bi, shape), ('gr', gr, (nb, dim, dim)),
                     ('gi', gi, (nb, dim, dim))), dev)
    ctas, scratch = _bf16_launch(n, nb, ld, dev, True)
    out = [torch.empty(shape, dtype=torch.float32, device=dev)
           for _ in range(3)]
    lib = _lib()
    err = _build.on_device(dev, lambda: lib.ucomp_bf16_backward(
        u1t.data_ptr(), br.data_ptr(), bi.data_ptr(), gr.data_ptr(),
        gi.data_ptr(), *[t.data_ptr() for t in out],
        None if scratch is None else scratch.data_ptr(), n, nb, ld, last,
        ctas, torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(lib, err, 'ucomp_bf16_backward')
    bf16_bwd_launches += 1
    return tuple(out)


class UCompBf16(torch.autograd.Function):
    """(u1t, br, bi) -> (mt_r, mt_i) in the bf16 operand mode, with B4b-bf16
    as its gradient: the counterpart of pallas_ucomp._make_ucomp under
    UCOMP_BF16, its operands' cotangents carried through
    :func:`compile_operands` by autograd.  On CPU tensors both passes are
    the plain versions."""

    @staticmethod
    def forward(ctx, u1t, br, bi, ld, last):
        ctx.save_for_backward(u1t, br, bi)
        ctx.ld, ctx.last = ld, last
        if u1t.device.type == 'cpu':
            return ucomp_dense(u1t, br, bi, ld, last, bf16=True)
        return ucomp_bf16_forward(u1t, br, bi, ld, last)

    @staticmethod
    def backward(ctx, gr, gi):
        u1t, br, bi = ctx.saved_tensors
        if u1t.device.type == 'cpu':
            grads = ucomp_backward_dense(u1t, br, bi, ctx.ld, ctx.last, gr,
                                         gi, bf16=True)
        else:
            grads = ucomp_bf16_backward(u1t, br, bi, ctx.ld, ctx.last,
                                        gr.contiguous(), gi.contiguous())
        return (*grads, None, None)


def ucomp_bf16(w, ld, last):
    """w (nb·ld, 3, n) -> (mt_r, mt_i) in the bf16 operand mode: the
    operands of :func:`compile_operands`, then :class:`UCompBf16` (or, with
    no gradient, its forward alone)."""
    ops = compile_operands(w)
    if torch.is_grad_enabled() and w.requires_grad:
        return UCompBf16.apply(*ops, ld, last)
    if w.device.type == 'cpu':
        return ucomp_dense(*ops, ld, last, bf16=True)
    return ucomp_bf16_forward(*ops, ld, last)


class UComp(torch.autograd.Function):
    """w -> (mt_r, mt_i) with B4b as its gradient (the counterpart of
    pallas_ucomp._make_ucomp with the elementwise build inside).  On CPU
    tensors both passes are the plain versions."""

    @staticmethod
    def forward(ctx, w, ld, last):
        ctx.save_for_backward(w)
        ctx.ld, ctx.last = ld, last
        if w.device.type == 'cpu':
            return ucomp_weights_dense(w, ld, last)
        return ucomp_forward(w, ld, last)

    @staticmethod
    def backward(ctx, gr, gi):
        (w,) = ctx.saved_tensors
        if w.device.type == 'cpu':
            wbar = ucomp_weights_backward_dense(w, ctx.ld, ctx.last, gr, gi)
        else:
            wbar = ucomp_backward(w, ctx.ld, ctx.last, gr.contiguous(),
                                  gi.contiguous())
        return wbar, None, None


def ucomp(w, ld, last):
    """w (nb·ld, 3, n) -> (mt_r, mt_i): :func:`ucomp_weights_dense`,
    through the CUDA kernels for CUDA tensors; with ``UCOMP_BF16`` the bf16
    operand mode (:func:`ucomp_bf16`).  w float32, contiguous."""
    if UCOMP_BF16:
        return ucomp_bf16(w, ld, last)
    if torch.is_grad_enabled() and w.requires_grad:
        return UComp.apply(w, ld, last)
    if w.device.type == 'cpu':
        return ucomp_weights_dense(w, ld, last)
    return ucomp_forward(w, ld, last)


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
    return ucomp(weights.contiguous(), ld, spec.n_blocks - 1)


def compile_block_mats_stacked(spec, weights):
    """weights (S, n_sub, 3, n) of S circuits of one spec -> (mt_r, mt_i),
    each (S, n_blocks, D, D) contiguous, circuit s's block matrices those
    of :func:`compile_block_mats` of weights[s]: two launches for all S,
    the inner blocks with ``last`` = -1 and the S final blocks with
    EVERY_BLOCK, joined in chain order by one ``cat`` each."""
    if not ucomp_applicable(spec):
        raise ValueError(
            "the compile kernel needs one uniform linear_depth >= 1 and at "
            f"most {MAX_QUBITS} qubits, got {spec}")
    ld, nb, n = spec.block_configs[0][1], spec.n_blocks, spec.n_qubits
    s, dim = weights.shape[0], spec.dim
    w = weights.reshape(s, nb, ld, 3, n)
    fr, fi = ucomp(w[:, -1].reshape(s * ld, 3, n).contiguous(), ld,
                   EVERY_BLOCK)
    if nb == 1:
        return fr.reshape(s, 1, dim, dim), fi.reshape(s, 1, dim, dim)
    ir, ii = ucomp(w[:, :-1].reshape(s * (nb - 1) * ld, 3, n).contiguous(),
                   ld, -1)
    return (torch.cat([ir.reshape(s, nb - 1, dim, dim),
                       fr.reshape(s, 1, dim, dim)], 1),
            torch.cat([ii.reshape(s, nb - 1, dim, dim),
                       fi.reshape(s, 1, dim, dim)], 1))
