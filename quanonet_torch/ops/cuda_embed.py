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

The operands come from :func:`cuda_hea._operands`, so this engine takes
the block matrices by the same route (``cuda_hea.compile_route``: the
compile kernels for CUDA weights unless ``USE_UCOMP=0``).  The kernels run the whole chain of one batch tile per
CTA, whatever the batch and the width (d = 1 .. 128): no padding, no
chunking, no fallback, and a single block (nb = 1) runs in the kernel.
The tile's size is chosen per call from N, d and the card's SM count
(:func:`embed_geometry`): small at the training batch, so that it spreads
over many SMs, large at large N, so that each thread's register tile keeps
the FMA units busy.  The library handle and the SM count are read once.

Residuals: the forward saves each block's product u (max(nb-1, 1), N, 2d)
and nothing else.  The TPU kernel also saves each block's input row s;
here the backward rebuilds s_b where it needs it, one phase step from
u_{b-1} (s_0 from t_0 alone), which halves the residual bytes.  u is not
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
from collections import namedtuple
from functools import lru_cache

import numpy as np
import torch

from quanonet_torch import tracing
from quanonet_torch.ops import _build
from quanonet_torch.ops import cuda_hea as _cuda_hea
from quanonet_torch.ops import hea as _hea

KERNEL = 'embed_chain'
DIMS = (1, 2, 4, 8, 16, 32, 64, 128)   # d = 2^n, n = 0..7 qubits
MIN_SPLIT_ROWS = 1024   # batch rows of the Ebar reduction before a split
MAX_SPLITS = 1024

# The kernels' launch geometries, (threads, CJ, P, KS) per half-width d in
# order of growing row tile R = threads / (d / CJ * KS) * P: a thread owns P
# rows and CJ column pairs (j, j + d) and, with KS > 1, one of KS slices of
# each product's depth, whose partial sums the KS lanes add by shuffles.
# The same table as EMBED_TILES in csrc/embed_chain.cu (the tests compare
# them; the library is checked against it when loaded).
TILES = {
    1: ((32, 1, 1, 1), (128, 1, 2, 1), (256, 1, 2, 1)),
    2: ((32, 1, 1, 1), (128, 1, 2, 1), (256, 2, 2, 1)),
    4: ((32, 1, 1, 1), (128, 2, 2, 1), (256, 4, 2, 1)),
    8: ((64, 1, 1, 1), (128, 2, 2, 1), (256, 4, 2, 1)),
    16: ((32, 4, 1, 4), (128, 4, 1, 4), (256, 4, 4, 1)),
    32: ((32, 4, 1, 4), (256, 4, 1, 4), (256, 2, 2, 1)),
    64: ((64, 4, 1, 2), (256, 4, 1, 2), (256, 4, 4, 2)),
    128: ((256, 1, 2, 1), (256, 2, 4, 1), (256, 4, 4, 1)),
}
RING = 4              # panels of E in flight (``Tile::NS``)

Geometry = namedtuple('Geometry', 'tile threads cj p ks rows grid '
                                  'fwd_smem bwd_smem')

_VP, _I = ctypes.c_void_p, ctypes.c_int


# ── plain versions ──────────────────────────────────────────────────────────

def _swap(a, d):
    return torch.cat([a[:, d:], a[:, :d]], dim=1)


def _s0(t0, d):
    inv_sqrt = float(1.0 / np.sqrt(d))
    return inv_sqrt * torch.cat([torch.cos(t0[:, :d]), torch.sin(t0[:, d:])],
                                dim=1)


def _phase_step(tb, u, d):
    """s = cos t (.) u + sin t (.) swap(u): the next block's input row."""
    return torch.cos(tb) * u + torch.sin(tb) * _swap(u, d)


def chain_embed_saved(e, t):
    """Plain PyTorch real-embedding chain with the backward's residual:
    (e (nb, 2d, 2d), t (nb, N, 2d)) -> (out (N, 2d), u (max(nb-1, 1), N,
    2d)), each block's product before its phase step (zeros when nb = 1).
    The plain version of the forward kernel's residual variant."""
    nb, _, w = t.shape
    d = w // 2
    s = _s0(t[0], d)
    us = []
    for b in range(nb - 1):
        u = s @ e[b]
        s = _phase_step(t[b + 1], u, d)
        us.append(u)
    out = s @ e[nb - 1]
    return out, torch.stack(us) if us else torch.zeros_like(t[:1])


def chain_embed(e, t):
    """Plain PyTorch real-embedding chain: (e, t) -> out (N, 2d).  The
    plain version of the forward kernel (:func:`embed_chain`)."""
    nb, _, w = t.shape
    d = w // 2
    s = _s0(t[0], d)
    for b in range(nb - 1):
        s = _phase_step(t[b + 1], s @ e[b], d)
    return s @ e[nb - 1]


def chain_embed_backward(e, t, u, g):
    """Reverse sweep of the chain, written out (no autograd) with the
    algebra of pallas_embed._bwd_kernel: the output's cotangent g (N, 2d)
    -> (ebar (nb, 2d, 2d), tbar (nb, N, 2d)).  ``u`` from
    :func:`chain_embed_saved`; each block's input row is rebuilt from it,
    s_0 = d^(-1/2) [cos t_0 | sin t_0] and s_b = cos t_b * u_{b-1} +
    sin t_b * swap(u_{b-1}), as the kernels rebuild it.  The plain version
    of the backward kernel.

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
        s = _s0(t[0], d) if b == 0 else _phase_step(t[b], u[b - 1], d)
        ebar.append(s.T @ ubar)
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

def panel_depth(w):
    """Rows (forward) or columns (sweep) of E_b in one panel of the ring:
    the whole matrix up to W = 64, at most 32 KB above (``Tile::KP``)."""
    return w if w * w <= 8192 else 8192 // w


def tile_geometry(d, tile, n):
    """The launch geometry of tile ``tile`` at half-width d for n batch
    rows, with the shared memory of its forward and sweep kernels (the
    formulas of ``Tile`` in csrc/embed_chain.cu)."""
    threads, cj, p, ks = TILES[d][tile]
    w = 2 * d
    rows = threads // (d // cj * ks) * p
    ld = w if w < 4 else w + 4           # padded row of the row tile
    kp = panel_depth(w)
    ldp = kp if kp < 4 else kp + 4       # padded row of a sweep panel
    return Geometry(tile, threads, cj, p, ks, rows, -(-n // rows),
                    4 * (2 * rows * ld + RING * kp * w),
                    4 * (2 * rows * ld + RING * w * ldp))


def embed_geometry(n, d, sms):
    """The geometry both chain kernels launch with for n batch rows at
    half-width d on a card of ``sms`` SMs: the largest row tile that still
    gives at least half as many CTAs as SMs, else the smallest (the
    training batch: N = 100 at d = 32 runs 100 CTAs of one row).  The primal
    and residual forward of one (n, d) share it, and so their bits."""
    geos = [tile_geometry(d, t, n) for t in range(len(TILES[d]))]
    fill = [g for g in geos if 2 * g.grid >= sms]
    return fill[-1] if fill else geos[0]


@lru_cache(maxsize=None)
def _lib():
    lib = _build.load(KERNEL)
    lib.embed_chain_forward.argtypes = [_VP] * 4 + [_I] * 4 + [_VP]
    lib.embed_chain_forward.restype = _I
    lib.embed_chain_backward.argtypes = [_VP] * 8 + [_I] * 5 + [_VP]
    lib.embed_chain_backward.restype = _I
    lib.embed_chain_error_string.argtypes = [_I]
    lib.embed_chain_error_string.restype = ctypes.c_char_p
    lib.embed_chain_tile_rows.argtypes = [_I, _I]
    lib.embed_chain_tile_rows.restype = _I
    for d in DIMS:
        for t in range(len(TILES[d])):
            built = lib.embed_chain_tile_rows(d, t)
            if built != tile_geometry(d, t, 1).rows:
                raise RuntimeError(
                    f"csrc/embed_chain.cu tile {t} at d = {d} has {built} "
                    f"rows, cuda_embed.TILES {tile_geometry(d, t, 1).rows}")
    return lib


def _check(named, device):
    """Each (name, tensor, shape) is float32, contiguous, 16-byte aligned
    and on ``device``."""
    for name, a, shape in named:
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, t on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             f"read it as float4)")


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
    ``save_residuals`` the pair (out, u): each block's product before its
    phase step, u (max(nb-1, 1), N, 2d) (zeros when nb = 1)."""
    _check_operands(e, t)
    nb, n, w = t.shape
    dev = t.device
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    u = ((torch.empty if nb > 1 else torch.zeros)(
        (max(nb - 1, 1), n, w), dtype=torch.float32, device=dev)
        if save_residuals else None)
    if n:
        lib = _lib()
        geo = embed_geometry(n, w // 2, _cuda_hea.sm_count(dev.index))
        err = _build.on_device(dev, lambda: lib.embed_chain_forward(
            e.data_ptr(), t.data_ptr(), out.data_ptr(),
            u.data_ptr() if u is not None else None, nb, n, w // 2,
            geo.tile, _stream(dev)))
        _raise_on(lib, err, 'embed_chain_forward')
        tracing.count('embed_chain_fwd')
    return (out, u) if save_residuals else out


def ebar_tile_side(w):
    """Side of one output tile of the Ebar kernel (``EbarTile::TS``)."""
    return min(w, 64)


def ebar_smem(w):
    """Bytes of shared memory of one CTA of the Ebar kernel at width w
    (``EbarTile::smem_bytes``): a ring of four chunks of rows (t_b,
    ubar_b, u_{b-1}, and u_{b-1}'s swap partners when a tile is narrower
    than the row) and two buffers of the rebuilt s_b."""
    ts = ebar_tile_side(w)
    rc = min(64, 1024 // ts)
    arrays = 3 if ts == w else 4
    return 4 * (4 * arrays * rc * ts + 2 * rc * ts)


def ebar_splits(nb, n, w, sms):
    """Slices of the batch rows for the Ebar reduction, summed in slice
    order by a third launch when there is more than one: enough CTAs to
    fill ``sms`` SMs twice over, but one slice up to MIN_SPLIT_ROWS rows
    and at most one more for each further MIN_SPLIT_ROWS, so the training
    batch (N = 100) runs one slice and no third launch."""
    tiles = (w // ebar_tile_side(w)) ** 2
    want = -(-2 * sms // (nb * tiles))
    splits = max(1, min(want, -(-n // MIN_SPLIT_ROWS), MAX_SPLITS))
    rows = -(-n // splits)
    return -(-n // rows)


def embed_backward(e, t, u, g):
    """The backward kernels on CUDA tensors: the output's cotangent
    g (N, 2d) and the forward's residual u -> (ebar, tbar).
    Deterministic: two calls on equal inputs give equal bits."""
    _check_operands(e, t)
    nb, n, w = t.shape
    dev = t.device
    _check((('u', u, (max(nb - 1, 1), n, w)), ('g', g, (n, w))), dev)
    tbar = torch.empty((nb, n, w), dtype=torch.float32, device=dev)
    if not n:
        return torch.zeros((nb, w, w), dtype=torch.float32, device=dev), tbar
    ebar = torch.empty((nb, w, w), dtype=torch.float32, device=dev)
    sms = _cuda_hea.sm_count(dev.index)
    splits = ebar_splits(nb, n, w, sms)
    ub = torch.empty((nb, n, w), dtype=torch.float32, device=dev)
    part = (torch.empty((splits, nb, w, w), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    lib = _lib()
    err = _build.on_device(dev, lambda: lib.embed_chain_backward(
        e.data_ptr(), t.data_ptr(), u.data_ptr(), g.data_ptr(),
        ub.data_ptr(),
        part.data_ptr() if part is not None else None,
        ebar.data_ptr(), tbar.data_ptr(), nb, n, w // 2,
        embed_geometry(n, w // 2, sms).tile, splits, _stream(dev)))
    _raise_on(lib, err, 'embed_chain_backward')
    tracing.count('embed_chain_bwd')
    return ebar, tbar


class EmbedChain(torch.autograd.Function):
    """(e, t) -> out with the backward kernel as its gradient (the
    counterpart of pallas_embed._make_chain).  On CPU tensors both passes
    are the plain versions."""

    @staticmethod
    def forward(ctx, e, t):
        with tracing.span('circuit.chain_fwd', rows=t.shape[1],
                          device=t.is_cuda):
            if t.device.type == 'cpu':
                out, u = chain_embed_saved(e, t)
            else:
                out, u = embed_forward(e, t, save_residuals=True)
        ctx.save_for_backward(e, t, u)
        return out

    @staticmethod
    def backward(ctx, g):
        e, t, u = ctx.saved_tensors
        with tracing.span('circuit.chain_bwd', rows=t.shape[1],
                          device=t.is_cuda):
            if t.device.type == 'cpu':
                return chain_embed_backward(e, t, u, g)
            return embed_backward(e, t, u, g.contiguous())


def embed_chain(e, t):
    """(e, t) -> out (N, 2d): the chain of :func:`chain_embed`, through the
    CUDA kernels for CUDA tensors.  e (nb, 2d, 2d), t (nb, N, 2d), float32,
    contiguous."""
    if torch.is_grad_enabled() and (e.requires_grad or t.requires_grad):
        return EmbedChain.apply(e, t)
    with tracing.span('circuit.chain_fwd', rows=t.shape[1], device=t.is_cuda):
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
    with tracing.span('circuit.operands', device=x.is_cuda):
        ops = pack_operands(*_cuda_hea._operands(spec, weights, x))
    out = embed_chain(*ops)
    return out[:, :d], out[:, d:]


def hea_expectation_embed(spec, weights, x, diag):
    """Z-diagonal expectation (batch, 1) of the kernel's final state."""
    sr, si = forward_embed(spec, weights, x)
    return _hea.diag_expectation_pair(sr, si, diag)
