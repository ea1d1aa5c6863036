"""
The HEA block chain through the hand-written CUDA kernels
``csrc/hea_chain.cu`` (counterpart of quanonet_tpu/ops/pallas_hea.py,
whose ``_fwd_kernel`` and ``_bwd_kernel`` they replace; engine name
``'pallas'``).

The operands come from :func:`_prepare`: the raw phases, and the block
matrices with the Hadamards folded in, from the compile kernels
(ops/cuda_ucomp.py) for CUDA weights where they apply, else from
:func:`quanonet_torch.ops.hea.fold_block_mats` (batched products under
autograd); ``USE_UCOMP`` forces either (:func:`compile_route`).  The
kernels run the whole chain of one batch tile per CTA, whatever the
batch: no padding, no chunking, no fallback.  The tile's size is chosen per call from N, D and the card's SM
count (:func:`chain_geometry`): small at the training batch, so that it
spreads over many SMs, large at large N, so that each thread's register
tile keeps the FMA units busy.  The library handle and the SM count are
read once.

:func:`block_chain` dispatches:

* a gradient is needed -> :class:`BlockChain` (the counterpart of
  ``_make_block_chain``): its forward runs the residual-saving forward
  kernel, its backward the backward kernel;
* no gradient (eval, serving) -> the primal-only forward kernel, which
  writes no residuals;
* CPU tensors -> the plain versions (:func:`hea.chain_dense`,
  :func:`hea.chain_dense_saved`, :func:`hea.chain_backward_dense`);
  CUDA tensors launch the kernels or raise.
"""
import ctypes
import os
from collections import namedtuple
from functools import lru_cache

import torch

from quanonet_torch import tracing
from quanonet_torch.ops import _build
from quanonet_torch.ops import cuda_ucomp as _ucomp
from quanonet_torch.ops import hea as _hea

KERNEL = 'hea_chain'
DIMS = (2, 4, 8, 16, 32, 64, 128)   # n = 1..7 qubits
MIN_SPLIT_ROWS = 1024   # fewest batch rows per slice of the Mbar reduction
MAX_SPLITS = 1024

# The kernels' launch geometries, (threads, CJ, P) per width in order of
# growing row tile R = threads / (D / CJ) * P: a thread owns P rows and CJ
# amplitudes.  The same table as HEA_TILES in csrc/hea_chain.cu (the tests
# compare them; the library is checked against it when loaded).
TILES = {
    2: ((32, 1, 1), (128, 1, 2), (256, 2, 2)),
    4: ((32, 1, 1), (128, 2, 2), (256, 4, 2)),
    8: ((64, 1, 1), (128, 2, 2), (256, 4, 2)),
    16: ((128, 1, 1), (256, 2, 2), (256, 4, 2)),
    32: ((256, 1, 1), (256, 4, 1), (256, 4, 2)),
    64: ((256, 1, 1), (256, 2, 2), (256, 4, 2)),
    128: ((256, 1, 1), (256, 2, 2), (256, 4, 2)),
}
SMEM_LIMIT = 232448   # bytes of shared memory a CTA may use (sm_90)
MAX_THREADS = 1024

Geometry = namedtuple('Geometry', 'tile threads cj p rows grid fwd_smem '
                                  'bwd_smem')

# Where the block matrices come from (the JAX package's toggle of the same
# name, whose default there is off): True ('1') the compile kernels, False
# ('0') the autograd fold, None (unset, or any other value) the compile
# kernels for CUDA weights and the fold for CPU weights
# (:func:`compile_route`).
USE_UCOMP = {'1': True, '0': False}.get(os.environ.get('USE_UCOMP'))

_VP, _I = ctypes.c_void_p, ctypes.c_int


def tile_geometry(d, tile, n):
    """The launch geometry of tile ``tile`` at width d for n batch rows,
    with the shared memory of its forward and sweep kernels (the formulas
    of ``Tile`` in csrc/hea_chain.cu)."""
    threads, cj, p = TILES[d][tile]
    rows = threads // (d // cj) * p
    ld = d if d < 4 else d + 4           # padded row of the tile and sweep's M
    nbuf = 2 if d <= 64 else 1           # block-matrix buffers
    return Geometry(tile, threads, cj, p, rows, -(-n // rows),
                    4 * (2 * rows * ld + 2 * nbuf * d * d),
                    4 * (2 * rows * ld + 2 * nbuf * d * ld))


def chain_geometry(n, d, sms):
    """The geometry both block-chain kernels launch with for n batch rows
    at width d on a card of ``sms`` SMs: the largest row tile that still
    gives at least half as many CTAs as SMs, else the smallest (the
    training batch: N = 100 at D = 32 runs 13 CTAs of 8 rows).  The primal
    and residual forward of one (n, d) share it, and so their bits."""
    geos = [tile_geometry(d, t, n) for t in range(len(TILES[d]))]
    fill = [g for g in geos if 2 * g.grid >= sms]
    return fill[-1] if fill else geos[0]


@lru_cache(maxsize=None)
def _lib():
    lib = _build.load(KERNEL)
    lib.hea_chain_forward.argtypes = [_VP] * 7 + [_I] * 4 + [_VP]
    lib.hea_chain_forward.restype = _I
    lib.hea_chain_backward.argtypes = [_VP] * 14 + [_I] * 5 + [_VP]
    lib.hea_chain_backward.restype = _I
    lib.hea_chain_error_string.argtypes = [_I]
    lib.hea_chain_error_string.restype = ctypes.c_char_p
    lib.hea_chain_tile_rows.argtypes = [_I, _I]
    lib.hea_chain_tile_rows.restype = _I
    for d in DIMS:
        for t in range(len(TILES[d])):
            built = lib.hea_chain_tile_rows(d, t)
            if built != tile_geometry(d, t, 1).rows:
                raise RuntimeError(
                    f"csrc/hea_chain.cu tile {t} at D = {d} has {built} rows, "
                    f"cuda_hea.TILES {tile_geometry(d, t, 1).rows}")
    return lib


@lru_cache(maxsize=None)
def sm_count(index):
    """SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(named, device):
    """Each (name, tensor, shape) is float32, contiguous, on ``device``;
    the block matrices and the phases also 16-byte aligned."""
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, phi on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name.startswith('mt_') or name == 'phi':
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned "
                                 f"(the kernels read it as float4)")


def _check_operands(mt_r, mt_i, phi):
    if phi.dim() != 3:
        raise ValueError(f"phi must be (nb, N, D), got {tuple(phi.shape)}")
    nb, n, d = phi.shape
    if d not in DIMS:
        raise ValueError(f"the block-chain kernel takes D in {DIMS}, got {d}")
    if nb < 1:
        raise ValueError("the chain needs at least one block")
    if n >= 2 ** 31:
        raise ValueError(f"batch of {n} rows is too large for one launch")
    _check((('mt_r', mt_r, (nb, d, d)), ('mt_i', mt_i, (nb, d, d)),
            ('phi', phi, (nb, n, d))), phi.device)


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.hea_chain_error_string(err).decode()} (cudaError {err})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def chain_forward(mt_r, mt_i, phi, save_residuals=False):
    """The forward kernel on CUDA tensors: (sr, si), and with
    ``save_residuals`` also (states_r, states_i), each block's input state
    (nb, N, D)."""
    _check_operands(mt_r, mt_i, phi)
    nb, n, d = phi.shape
    dev = phi.device
    out_r = torch.empty((n, d), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, d), dtype=torch.float32, device=dev)
    st = ((torch.empty((nb, n, d), dtype=torch.float32, device=dev),
           torch.empty((nb, n, d), dtype=torch.float32, device=dev))
          if save_residuals else ())
    if n:
        lib = _lib()
        st_ptrs = [t.data_ptr() for t in st] or [None, None]
        geo = chain_geometry(n, d, sm_count(dev.index))
        err = _build.on_device(dev, lambda: lib.hea_chain_forward(
            mt_r.data_ptr(), mt_i.data_ptr(), phi.data_ptr(),
            out_r.data_ptr(), out_i.data_ptr(), *st_ptrs, nb, n, d,
            geo.tile, _stream(dev)))
        _raise_on(lib, err, 'hea_chain_forward')
        tracing.count('hea_chain_fwd')
    return (out_r, out_i, *st)


def mbar_tile_side(d):
    """Side of one output tile of the Mbar kernel (``MbarTile::TS``)."""
    return d if d < 32 else (32 if d < 64 else 64)


def mbar_splits(nb, n, d, sms):
    """Slices of the batch rows for the Mbar reduction, summed in slice
    order by a third launch when there is more than one: enough CTAs to
    fill ``sms`` SMs twice over, at least MIN_SPLIT_ROWS rows each, so the
    training batch (N = 100) runs one slice and no third launch."""
    tiles = (d // mbar_tile_side(d)) ** 2
    want = -(-2 * sms // (nb * tiles))
    splits = max(1, min(want, -(-n // MIN_SPLIT_ROWS), MAX_SPLITS))
    rows = -(-n // splits)
    return -(-n // rows)


def chain_backward(mt_r, mt_i, phi, states_r, states_i, gr, gi):
    """The backward kernels on CUDA tensors: the output's cotangent
    (gr, gi) -> (mbar_r, mbar_i, phibar).  Deterministic: two calls on
    equal inputs give equal bits."""
    _check_operands(mt_r, mt_i, phi)
    nb, n, d = phi.shape
    dev = phi.device
    _check((('states_r', states_r, (nb, n, d)),
            ('states_i', states_i, (nb, n, d)),
            ('gr', gr, (n, d)), ('gi', gi, (n, d))), dev)
    phibar = torch.empty((nb, n, d), dtype=torch.float32, device=dev)
    if not n:
        return (torch.zeros((nb, d, d), dtype=torch.float32, device=dev),
                torch.zeros((nb, d, d), dtype=torch.float32, device=dev),
                phibar)
    mbar_r = torch.empty((nb, d, d), dtype=torch.float32, device=dev)
    mbar_i = torch.empty((nb, d, d), dtype=torch.float32, device=dev)
    sms = sm_count(dev.index)
    splits = mbar_splits(nb, n, d, sms)
    ub_r = torch.empty((nb, n, d), dtype=torch.float32, device=dev)
    ub_i = torch.empty((nb, n, d), dtype=torch.float32, device=dev)
    part = ((torch.empty((splits, nb, d, d), dtype=torch.float32, device=dev),
             torch.empty((splits, nb, d, d), dtype=torch.float32, device=dev))
            if splits > 1 else ())
    part_ptrs = [t.data_ptr() for t in part] or [None, None]
    lib = _lib()
    err = _build.on_device(dev, lambda: lib.hea_chain_backward(
        mt_r.data_ptr(), mt_i.data_ptr(), phi.data_ptr(),
        states_r.data_ptr(), states_i.data_ptr(), gr.data_ptr(),
        gi.data_ptr(), ub_r.data_ptr(), ub_i.data_ptr(), *part_ptrs,
        mbar_r.data_ptr(), mbar_i.data_ptr(), phibar.data_ptr(),
        nb, n, d, chain_geometry(n, d, sms).tile, splits, _stream(dev)))
    _raise_on(lib, err, 'hea_chain_backward')
    tracing.count('hea_chain_bwd')
    return mbar_r, mbar_i, phibar


class BlockChain(torch.autograd.Function):
    """(mt_r, mt_i, phi) -> (sr, si) with the backward kernel as its
    gradient (the counterpart of pallas_hea._make_block_chain).  On CPU
    tensors both passes are the plain versions."""

    @staticmethod
    def forward(ctx, mt_r, mt_i, phi):
        with tracing.span('circuit.chain_fwd', rows=phi.shape[1],
                          device=phi.is_cuda):
            if phi.device.type == 'cpu':
                sr, si, st_r, st_i = _hea.chain_dense_saved(mt_r, mt_i, phi)
            else:
                sr, si, st_r, st_i = chain_forward(mt_r, mt_i, phi,
                                                   save_residuals=True)
        ctx.save_for_backward(mt_r, mt_i, phi, st_r, st_i)
        return sr, si

    @staticmethod
    def backward(ctx, gr, gi):
        mt_r, mt_i, phi, st_r, st_i = ctx.saved_tensors
        with tracing.span('circuit.chain_bwd', rows=phi.shape[1],
                          device=phi.is_cuda):
            if phi.device.type == 'cpu':
                return _hea.chain_backward_dense(mt_r, mt_i, phi,
                                                 (st_r, st_i), gr, gi)
            return chain_backward(mt_r, mt_i, phi, st_r, st_i,
                                  gr.contiguous(), gi.contiguous())


def block_chain(mt_r, mt_i, phi):
    """(mt_r, mt_i, phi) -> (sr, si): the chain of
    :func:`quanonet_torch.ops.hea.chain_dense`, through the CUDA kernels
    for CUDA tensors.  mt_* (nb, D, D), phi (nb, N, D), float32,
    contiguous."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (mt_r, mt_i, phi)):
        return BlockChain.apply(mt_r, mt_i, phi)
    with tracing.span('circuit.chain_fwd', rows=phi.shape[1],
                      device=phi.is_cuda):
        if phi.device.type == 'cpu':
            return _hea.chain_dense(mt_r, mt_i, phi)
        return chain_forward(mt_r, mt_i, phi)


def compile_route(flag, spec, device_type):
    """Whether the block matrices come from the compile kernels: where
    they apply to ``spec`` (``cuda_ucomp.ucomp_applicable``), when ``flag``
    (``USE_UCOMP``) is True, or is None and the weights lie on ``cuda``."""
    if flag is None:
        flag = device_type == 'cuda'
    return flag and _ucomp.ucomp_applicable(spec)


def block_mats(spec, weights):
    """(mt_r, mt_i) of the chain: the compile kernels where
    :func:`compile_route` takes them, else the autograd fold."""
    if compile_route(USE_UCOMP, spec, weights.device.type):
        return _ucomp.compile_block_mats(spec, weights)
    return _hea.fold_block_mats(spec, weights)


def block_mats_stacked(spec, weights):
    """weights (S, n_sub, 3, n) -> (mt_r, mt_i), each (S, nb, D, D): the
    block matrices of S circuits, by the compile kernels in two launches
    for all S where :func:`compile_route` takes them
    (cuda_ucomp.compile_block_mats_stacked), else by the fold of each."""
    if compile_route(USE_UCOMP, spec, weights.device.type):
        return _ucomp.compile_block_mats_stacked(spec, weights)
    mats = [_hea.fold_block_mats(spec, w) for w in weights]
    return (torch.stack([m[0] for m in mats]),
            torch.stack([m[1] for m in mats]))


def _aligned(t):
    """``t``, or a copy of it where its start is not 16-byte aligned (a
    slice of a stacked tensor at D = 2)."""
    return t.clone() if t.data_ptr() % 16 else t


def hea_expectation_stacked(spec, weights, x, diag):
    """Z-diagonal expectation (S, batch, 1) of S circuits of one spec:
    weights (S, n_sub, 3, n), x (S, batch, nb·n).  The block matrices of
    all S come from :func:`block_mats_stacked`, the phases from one
    elementwise pass, and each circuit's chain is one call of
    :func:`block_chain` on its slice (one B1f launch a circuit, B1b under
    autograd)."""
    if not spec.uniform_encode:
        raise ValueError(
            "the block-chain engine requires n_encode == n_qubits per block")
    with tracing.span('circuit.operands', device=x.is_cuda):
        mt_r, mt_i = block_mats_stacked(spec, weights)
        phi = _hea.encoding_phases(spec, x)
    states = [block_chain(_aligned(mt_r[s]), _aligned(mt_i[s]),
                          _aligned(phi[s])) for s in range(phi.shape[0])]
    return _hea.diag_expectation_pair(torch.stack([r for r, _ in states]),
                                      torch.stack([i for _, i in states]),
                                      diag)


def _operands(spec, weights, x):
    return (*block_mats(spec, weights), _hea.encoding_phases(spec, x))


def _prepare(spec, weights, x):
    """Chain operands (mt_r, mt_i, phi), the counterpart of
    pallas_hea._prepare, under the ``circuit.operands`` span."""
    with tracing.span('circuit.operands', device=x.is_cuda):
        return _operands(spec, weights, x)


def forward_pallas(spec, weights, x):
    """(sr, si) of the circuit through the block-chain kernels."""
    if not spec.uniform_encode:
        raise ValueError(
            "the block-chain engine requires n_encode == n_qubits per block")
    return block_chain(*_prepare(spec, weights, x))


def hea_expectation_pallas(spec, weights, x, diag):
    """Z-diagonal expectation (batch, 1) of the kernel's final state."""
    sr, si = forward_pallas(spec, weights, x)
    return _hea.diag_expectation_pair(sr, si, diag)
