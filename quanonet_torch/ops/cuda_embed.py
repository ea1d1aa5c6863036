"""
The real-embedding chain through the hand-written CUDA kernels
``csrc/embed_chain.cu`` (counterpart of quanonet_tpu/ops/pallas_embed.py,
whose ``_fwd_kernel`` and ``_bwd_kernel`` they replace; engine name
``'embed'``).

The state is one real row ``[re | im]`` of width 2d and each block matrix
its real representation ``E = [[Mr, Mi], [-Mi, Mr]]``, so a block is one
real (N, 2d) x (2d, 2d) product; the per-sample phase becomes, with packed
angles ``t = [phi | -phi]``, ``s' = cos t * u + sin t * swap(u)``.  The
packing (:func:`pack_operands`) is plain PyTorch under autograd, which
resolves the complex structure of Ebar (Mbar_r = Ebar_11 + Ebar_22,
Mbar_i = Ebar_12 - Ebar_21) and tbar -> phibar outside the kernels.  The
kernels take any E and t: they assume neither E's block structure nor t's
antisymmetry.

The operands come from :func:`cuda_hea._prepare`, so ``USE_UCOMP=1`` feeds
this engine too.  The kernels run the whole chain of one batch tile per
CTA, whatever the batch and the width (d = 1 .. 128): no padding, no
chunking, no fallback, and a single block (nb = 1) runs in the kernel.

Residuals: the forward saves each block's input row s (nb, N, 2d) and each
product u (max(nb-1, 1), N, 2d), as the TPU kernel does.  u is not
recomputed as s . E in the backward (a third product), and cannot be
recovered from the next s for a general t.

:func:`embed_chain` dispatches:

* a gradient is needed -> :class:`EmbedChain` (the counterpart of
  ``_make_chain``): its forward runs the residual-saving forward kernel,
  its backward the backward kernels;
* no gradient (eval, serving) -> the primal-only forward kernel, which
  writes no residuals;
* CPU tensors -> the plain versions (:func:`chain_embed`,
  :func:`chain_embed_saved`, :func:`chain_embed_backward`); CUDA tensors
  launch the kernels or raise.
"""
import ctypes
from functools import lru_cache

import numpy as np
import torch

from quanonet_torch.ops import _build
from quanonet_torch.ops import cuda_hea as _cuda_hea
from quanonet_torch.ops import hea as _hea

KERNEL = 'embed_chain'
DIMS = (1, 2, 4, 8, 16, 32, 64, 128)   # d = 2^n, n = 0..7 qubits
MIN_SPLIT_ROWS = 64   # fewest batch rows per slice of the Ebar reduction
MAX_SPLITS = 1024

# Launches since import: ``launches`` counts the forward kernel (primal and
# residual variants), ``bwd_launches`` the backward.
launches = 0
bwd_launches = 0

_VP, _I = ctypes.c_void_p, ctypes.c_int


# ── plain versions ──────────────────────────────────────────────────────────

def _swap(a, d):
    return torch.cat([a[:, d:], a[:, :d]], dim=1)


def _s0(t0, d):
    inv_sqrt = float(1.0 / np.sqrt(d))
    return inv_sqrt * torch.cat([torch.cos(t0[:, :d]), torch.sin(t0[:, d:])],
                                dim=1)


def chain_embed_saved(e, t):
    """Plain PyTorch real-embedding chain with the backward's residuals:
    (e (nb, 2d, 2d), t (nb, N, 2d)) -> (out (N, 2d), s (nb, N, 2d),
    u (max(nb-1, 1), N, 2d)).  The plain version of the forward kernel's
    residual variant."""
    nb, _, w = t.shape
    d = w // 2
    s = _s0(t[0], d)
    states, us = [s], []
    for b in range(nb - 1):
        u = s @ e[b]
        tb = t[b + 1]
        s = torch.cos(tb) * u + torch.sin(tb) * _swap(u, d)
        us.append(u)
        states.append(s)
    out = s @ e[nb - 1]
    return (out, torch.stack(states),
            torch.stack(us) if us else torch.zeros_like(t[:1]))


def chain_embed(e, t):
    """Plain PyTorch real-embedding chain: (e, t) -> out (N, 2d).  The
    plain version of the forward kernel (:func:`embed_chain`)."""
    nb, _, w = t.shape
    d = w // 2
    s = _s0(t[0], d)
    for b in range(nb - 1):
        u = s @ e[b]
        s = torch.cos(t[b + 1]) * u + torch.sin(t[b + 1]) * _swap(u, d)
    return s @ e[nb - 1]


def chain_embed_backward(e, t, s, u, g):
    """Reverse sweep of the chain, written out (no autograd) with the
    algebra of pallas_embed._bwd_kernel: the output's cotangent g (N, 2d)
    -> (ebar (nb, 2d, 2d), tbar (nb, N, 2d)).  ``s``, ``u`` from
    :func:`chain_embed_saved`.  The plain version of the backward kernel.

        ubar_{nb-1} = g;  for b = nb-1 .. 0:
            ebar_b = s_b^T . ubar_b              (summed over the batch)
            sbar_b = ubar_b . E_b^T
            tbar_b = sbar_b * (cos t_b * swap(u_{b-1}) - sin t_b * u_{b-1})
            ubar_{b-1} = cos t_b * sbar_b + swap(sin t_b * sbar_b)
        tbar_0 = sbar_0 * d^(-1/2) * [-sin t_0 | cos t_0]"""
    nb, _, w = t.shape
    d = w // 2
    inv_sqrt = float(1.0 / np.sqrt(d))
    ebar, tbar = [], []
    ubar = g
    for b in range(nb - 1, -1, -1):
        ebar.append(s[b].T @ ubar)
        sbar = ubar @ e[b].T
        c, sn = torch.cos(t[b]), torch.sin(t[b])
        if b == 0:
            tbar.append(sbar * inv_sqrt
                        * torch.cat([-sn[:, :d], c[:, d:]], dim=1))
            break
        ub = u[b - 1]
        tbar.append(sbar * (c * _swap(ub, d) - sn * ub))
        ubar = c * sbar + _swap(sn * sbar, d)
    return torch.stack(ebar[::-1]), torch.stack(tbar[::-1])


# ── the kernels' wrappers ───────────────────────────────────────────────────

@lru_cache(maxsize=None)
def _lib():
    lib = _build.load(KERNEL)
    lib.embed_chain_forward.argtypes = [_VP] * 5 + [_I] * 3 + [_VP]
    lib.embed_chain_forward.restype = _I
    lib.embed_chain_backward.argtypes = [_VP] * 9 + [_I] * 4 + [_VP]
    lib.embed_chain_backward.restype = _I
    lib.embed_chain_error_string.argtypes = [_I]
    lib.embed_chain_error_string.restype = ctypes.c_char_p
    return lib


def _check(named, device):
    """Each (name, tensor, shape) is float32, contiguous, on ``device``;
    the block matrices also 16-byte aligned."""
    for name, a, shape in named:
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, t on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name == 'e' and a.data_ptr() % 16:
            raise ValueError("e must be 16-byte aligned (the kernels read "
                             "it as float4)")


def _check_operands(e, t):
    if t.dim() != 3 or t.shape[2] % 2:
        raise ValueError(f"t must be (nb, N, 2d), got {tuple(t.shape)}")
    if t.device.type != 'cuda':
        raise ValueError("the embed-chain kernels take CUDA tensors; "
                         "embed_chain() computes the plain version on the "
                         "CPU")
    nb, n, w = t.shape
    if w // 2 not in DIMS:
        raise ValueError(f"the embed-chain kernel takes d in {DIMS}, "
                         f"got {w // 2}")
    if nb < 1:
        raise ValueError("the chain needs at least one block")
    if n >= 2 ** 31:
        raise ValueError(f"batch of {n} rows is too large for one launch")
    _check((('e', e, (nb, w, w)), ('t', t, (nb, n, w))), t.device)


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.embed_chain_error_string(err).decode()} (cudaError {err})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def embed_forward(e, t, save_residuals=False):
    """The forward kernel on CUDA tensors: out (N, 2d), and with
    ``save_residuals`` the tuple (out, s, u): each block's input row
    s (nb, N, 2d) and each product u (max(nb-1, 1), N, 2d)."""
    global launches
    _check_operands(e, t)
    nb, n, w = t.shape
    dev = t.device
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    res = ()
    if save_residuals:
        res = (torch.empty((nb, n, w), dtype=torch.float32, device=dev),
               (torch.empty if nb > 1 else torch.zeros)(
                   (max(nb - 1, 1), n, w), dtype=torch.float32, device=dev))
    if n:
        lib = _lib()
        res_ptrs = [a.data_ptr() for a in res] or [None, None]
        with torch.cuda.device(dev):
            err = lib.embed_chain_forward(
                e.data_ptr(), t.data_ptr(), out.data_ptr(), *res_ptrs,
                nb, n, w // 2, _stream(dev))
        _raise_on(lib, err, 'embed_chain_forward')
        launches += 1
    return (out, *res) if save_residuals else out


def ebar_splits(nb, n, w, sms):
    """Slices of the batch rows for the Ebar reduction: enough CTAs to
    fill ``sms`` SMs twice over, at least MIN_SPLIT_ROWS rows each."""
    tiles = (w // min(w, 32)) ** 2
    want = -(-2 * sms // (nb * tiles))
    splits = max(1, min(want, -(-n // MIN_SPLIT_ROWS), MAX_SPLITS))
    rows = -(-n // splits)
    return -(-n // rows)


def embed_backward(e, t, s, u, g):
    """The backward kernels on CUDA tensors: the output's cotangent
    g (N, 2d) -> (ebar, tbar).  Deterministic: two calls on equal inputs
    give equal bits."""
    global bwd_launches
    _check_operands(e, t)
    nb, n, w = t.shape
    dev = t.device
    _check((('s', s, (nb, n, w)), ('u', u, (max(nb - 1, 1), n, w)),
            ('g', g, (n, w))), dev)
    tbar = torch.empty((nb, n, w), dtype=torch.float32, device=dev)
    if not n:
        return torch.zeros((nb, w, w), dtype=torch.float32, device=dev), tbar
    ebar = torch.empty((nb, w, w), dtype=torch.float32, device=dev)
    splits = ebar_splits(
        nb, n, w, torch.cuda.get_device_properties(dev).multi_processor_count)
    ub = torch.empty((nb, n, w), dtype=torch.float32, device=dev)
    part = (torch.empty((splits, nb, w, w), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.embed_chain_backward(
            e.data_ptr(), t.data_ptr(), s.data_ptr(), u.data_ptr(),
            g.data_ptr(), ub.data_ptr(),
            part.data_ptr() if part is not None else None,
            ebar.data_ptr(), tbar.data_ptr(), nb, n, w // 2, splits,
            _stream(dev))
    _raise_on(lib, err, 'embed_chain_backward')
    bwd_launches += 1
    return ebar, tbar


class EmbedChain(torch.autograd.Function):
    """(e, t) -> out with the backward kernel as its gradient (the
    counterpart of pallas_embed._make_chain).  On CPU tensors both passes
    are the plain versions."""

    @staticmethod
    def forward(ctx, e, t):
        if t.device.type == 'cpu':
            out, s, u = chain_embed_saved(e, t)
        else:
            out, s, u = embed_forward(e, t, save_residuals=True)
        ctx.save_for_backward(e, t, s, u)
        return out

    @staticmethod
    def backward(ctx, g):
        e, t, s, u = ctx.saved_tensors
        if t.device.type == 'cpu':
            return chain_embed_backward(e, t, s, u, g)
        return embed_backward(e, t, s, u, g.contiguous())


def embed_chain(e, t):
    """(e, t) -> out (N, 2d): the chain of :func:`chain_embed`, through the
    CUDA kernels for CUDA tensors.  e (nb, 2d, 2d), t (nb, N, 2d), float32,
    contiguous."""
    if torch.is_grad_enabled() and (e.requires_grad or t.requires_grad):
        return EmbedChain.apply(e, t)
    if t.device.type == 'cpu':
        return chain_embed(e, t)
    return embed_forward(e, t)


def pack_operands(mt_r, mt_i, phi):
    """The block chain's operands (mt_r, mt_i (nb, d, d), phi (nb, N, d))
    -> (e (nb, 2d, 2d), t (nb, N, 2d)): E = [[Mr, Mi], [-Mi, Mr]] and
    t = [phi | -phi], plain PyTorch under autograd (the counterpart of
    pallas_embed.forward_embed's packing)."""
    e = torch.cat([torch.cat([mt_r, mt_i], dim=2),
                   torch.cat([-mt_i, mt_r], dim=2)], dim=1)
    return e, torch.cat([phi, -phi], dim=2)


def forward_embed(spec, weights, x):
    """(sr, si) of the circuit through the real-embedding chain kernels."""
    if not spec.uniform_encode:
        raise ValueError(
            "the embed engine requires n_encode == n_qubits per block")
    d = spec.dim
    if d not in DIMS:
        raise ValueError(
            f"engine 'embed' takes up to 7 qubits (d in {DIMS}), got "
            f"{spec.n_qubits}; use 'pfused' or 'fused' from 8")
    out = embed_chain(*pack_operands(*_cuda_hea._prepare(spec, weights, x)))
    return out[:, :d], out[:, d:]


def hea_expectation_embed(spec, weights, x, diag):
    """Z-diagonal expectation (batch, 1) of the kernel's final state."""
    sr, si = forward_embed(spec, weights, x)
    return _hea.diag_expectation_pair(sr, si, diag)
