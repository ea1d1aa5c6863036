"""
The HEA block chain through the hand-written CUDA kernel
``csrc/hea_chain.cu`` (counterpart of quanonet_tpu/ops/pallas_hea.py,
whose ``_fwd_kernel`` it replaces; engine name ``'pallas'``).

The operands come from :func:`quanonet_torch.ops.hea.prepare_chain` (the
block-matrix fold with the Hadamards, and the raw phases).  The kernel runs
the whole chain of one batch tile per CTA, whatever the batch: no padding,
no chunking, no fallback.  On CPU tensors :func:`block_chain` computes its
plain version, :func:`quanonet_torch.ops.hea.chain_dense`; on CUDA tensors
it launches the kernel or raises.

Serving only: the backward kernel (pallas_hea._bwd_kernel) comes with the
training slice, so a call that would need a gradient raises.
"""
import ctypes

import torch

from quanonet_torch.ops import _build
from quanonet_torch.ops import hea as _hea

KERNEL = 'hea_chain'
DIMS = (2, 4, 8, 16, 32, 64, 128)   # n = 1..7 qubits

# Kernel launches since import; chip_smoke.py zeroes it before driving the
# served path and reads it after, to show that path ran the kernel.
launches = 0


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.hea_chain_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hea_chain_error_string.argtypes = [ctypes.c_int]
    lib.hea_chain_error_string.restype = ctypes.c_char_p
    return lib


def _check(mt_r, mt_i, phi):
    if phi.dim() != 3:
        raise ValueError(f"phi must be (nb, N, D), got {tuple(phi.shape)}")
    nb, n, d = phi.shape
    if d not in DIMS:
        raise ValueError(f"the block-chain kernel takes D in {DIMS}, got {d}")
    if nb < 1:
        raise ValueError("the chain needs at least one block")
    if n >= 2 ** 31:
        raise ValueError(f"batch of {n} rows is too large for one launch")
    for name, t, shape in (('mt_r', mt_r, (nb, d, d)),
                           ('mt_i', mt_i, (nb, d, d)), ('phi', phi, None)):
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != phi.device:
            raise ValueError(f"{name} is on {t.device}, phi on {phi.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (('mt_r', mt_r), ('mt_i', mt_i)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned "
                             f"(the kernel reads it as float4)")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (mt_r, mt_i, phi)):
        raise NotImplementedError(
            "the block-chain kernel has no backward yet (pallas_hea."
            "_bwd_kernel, ROADMAP §B1b); run under torch.no_grad() or "
            "torch.inference_mode(), or use engine='dense' to differentiate")


def block_chain(mt_r, mt_i, phi):
    """(mt_r, mt_i, phi) -> (sr, si): the chain of
    :func:`quanonet_torch.ops.hea.chain_dense`, through the CUDA kernel for
    CUDA tensors.  mt_* (nb, D, D), phi (nb, N, D), float32, contiguous."""
    global launches
    if phi.device.type == 'cpu':
        return _hea.chain_dense(mt_r, mt_i, phi)
    _check(mt_r, mt_i, phi)
    nb, n, d = phi.shape
    out_r = torch.empty((n, d), dtype=torch.float32, device=phi.device)
    out_i = torch.empty((n, d), dtype=torch.float32, device=phi.device)
    if n == 0:
        return out_r, out_i
    lib = _lib()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = lib.hea_chain_forward(
            mt_r.data_ptr(), mt_i.data_ptr(), phi.data_ptr(),
            out_r.data_ptr(), out_i.data_ptr(), nb, n, d, stream)
    if err:
        raise RuntimeError(
            f"hea_chain_forward launch failed: "
            f"{lib.hea_chain_error_string(err).decode()} (cudaError {err})")
    launches += 1
    return out_r, out_i


def forward_pallas(spec, weights, x):
    """(sr, si) of the circuit through the block-chain kernel."""
    if not spec.uniform_encode:
        raise ValueError(
            "the block-chain engine requires n_encode == n_qubits per block")
    return block_chain(*_hea.prepare_chain(spec, weights, x))


def hea_expectation_pallas(spec, weights, x, diag):
    """Z-diagonal expectation (batch, 1) of the kernel's final state."""
    sr, si = forward_pallas(spec, weights, x)
    return _hea.diag_expectation_pair(sr, si, diag)
