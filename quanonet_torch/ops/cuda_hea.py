"""
The HEA block chain through the hand-written CUDA kernels
``csrc/hea_chain.cu`` (counterpart of quanonet_tpu/ops/pallas_hea.py,
whose ``_fwd_kernel`` and ``_bwd_kernel`` they replace; engine name
``'pallas'``).

The operands come from :func:`_prepare`: the raw phases, and the block
matrices with the Hadamards folded in, by default from
:func:`quanonet_torch.ops.hea.fold_block_mats` (batched products under
autograd) and with ``USE_UCOMP=1`` from the compile kernels
(ops/cuda_ucomp.py), where they apply.  The kernels run the whole chain of
one batch tile per CTA, whatever the batch: no padding, no chunking, no
fallback.

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

import torch

from quanonet_torch.ops import _build
from quanonet_torch.ops import cuda_ucomp as _ucomp
from quanonet_torch.ops import hea as _hea

KERNEL = 'hea_chain'
DIMS = (2, 4, 8, 16, 32, 64, 128)   # n = 1..7 qubits
MIN_SPLIT_ROWS = 64   # fewest batch rows per slice of the Mbar reduction
MAX_SPLITS = 1024

# Launches since import: ``launches`` counts the forward kernel (primal and
# residual variants), ``bwd_launches`` the backward.  chip_smoke.py zeroes
# them before driving a path and reads them after, to show that the path
# ran the kernels.
launches = 0
bwd_launches = 0

# Block matrices from the compile kernels instead of the autograd fold
# (the JAX package's toggle of the same name; off by default, as there).
USE_UCOMP = os.environ.get('USE_UCOMP', '0') == '1'

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load(KERNEL)
    lib.hea_chain_forward.argtypes = [_VP] * 7 + [_I] * 3 + [_VP]
    lib.hea_chain_forward.restype = _I
    lib.hea_chain_backward.argtypes = [_VP] * 14 + [_I] * 4 + [_VP]
    lib.hea_chain_backward.restype = _I
    lib.hea_chain_error_string.argtypes = [_I]
    lib.hea_chain_error_string.restype = ctypes.c_char_p
    return lib


def _check(named, device):
    """Each (name, tensor, shape) is float32, contiguous, on ``device``;
    the block matrices also 16-byte aligned."""
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, phi on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name.startswith('mt_') and t.data_ptr() % 16:
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
    global launches
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
        with torch.cuda.device(dev):
            err = lib.hea_chain_forward(
                mt_r.data_ptr(), mt_i.data_ptr(), phi.data_ptr(),
                out_r.data_ptr(), out_i.data_ptr(), *st_ptrs, nb, n, d,
                _stream(dev))
        _raise_on(lib, err, 'hea_chain_forward')
        launches += 1
    return (out_r, out_i, *st)


def mbar_splits(nb, n, d, sms):
    """Slices of the batch rows for the Mbar reduction: enough CTAs to
    fill ``sms`` SMs twice over, at least MIN_SPLIT_ROWS rows each."""
    tiles = (d // min(d, 32)) ** 2
    want = -(-2 * sms // (nb * tiles))
    splits = max(1, min(want, -(-n // MIN_SPLIT_ROWS), MAX_SPLITS))
    rows = -(-n // splits)
    return -(-n // rows)


def chain_backward(mt_r, mt_i, phi, states_r, states_i, gr, gi):
    """The backward kernels on CUDA tensors: the output's cotangent
    (gr, gi) -> (mbar_r, mbar_i, phibar).  Deterministic: two calls on
    equal inputs give equal bits."""
    global bwd_launches
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
    splits = mbar_splits(
        nb, n, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    ub_r = torch.empty((nb, n, d), dtype=torch.float32, device=dev)
    ub_i = torch.empty((nb, n, d), dtype=torch.float32, device=dev)
    part = ((torch.empty((splits, nb, d, d), dtype=torch.float32, device=dev),
             torch.empty((splits, nb, d, d), dtype=torch.float32, device=dev))
            if splits > 1 else ())
    part_ptrs = [t.data_ptr() for t in part] or [None, None]
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.hea_chain_backward(
            mt_r.data_ptr(), mt_i.data_ptr(), phi.data_ptr(),
            states_r.data_ptr(), states_i.data_ptr(), gr.data_ptr(),
            gi.data_ptr(), ub_r.data_ptr(), ub_i.data_ptr(), *part_ptrs,
            mbar_r.data_ptr(), mbar_i.data_ptr(), phibar.data_ptr(),
            nb, n, d, splits, _stream(dev))
    _raise_on(lib, err, 'hea_chain_backward')
    bwd_launches += 1
    return mbar_r, mbar_i, phibar


class BlockChain(torch.autograd.Function):
    """(mt_r, mt_i, phi) -> (sr, si) with the backward kernel as its
    gradient (the counterpart of pallas_hea._make_block_chain).  On CPU
    tensors both passes are the plain versions."""

    @staticmethod
    def forward(ctx, mt_r, mt_i, phi):
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
        if phi.device.type == 'cpu':
            return _hea.chain_backward_dense(mt_r, mt_i, phi, (st_r, st_i),
                                             gr, gi)
        return chain_backward(mt_r, mt_i, phi, st_r, st_i, gr.contiguous(),
                              gi.contiguous())


def block_chain(mt_r, mt_i, phi):
    """(mt_r, mt_i, phi) -> (sr, si): the chain of
    :func:`quanonet_torch.ops.hea.chain_dense`, through the CUDA kernels
    for CUDA tensors.  mt_* (nb, D, D), phi (nb, N, D), float32,
    contiguous."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (mt_r, mt_i, phi)):
        return BlockChain.apply(mt_r, mt_i, phi)
    if phi.device.type == 'cpu':
        return _hea.chain_dense(mt_r, mt_i, phi)
    return chain_forward(mt_r, mt_i, phi)


def block_mats(spec, weights):
    """(mt_r, mt_i) of the chain: the compile kernels when ``USE_UCOMP``
    is on and they apply, else the autograd fold."""
    if USE_UCOMP and _ucomp.ucomp_applicable(spec):
        return _ucomp.compile_block_mats(spec, weights)
    return _hea.fold_block_mats(spec, weights)


def _prepare(spec, weights, x):
    """Chain operands (mt_r, mt_i, phi), the counterpart of
    pallas_hea._prepare."""
    return (*block_mats(spec, weights), _hea.encoding_phases(spec, x))


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
