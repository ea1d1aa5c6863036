"""
The fused-group chain through the hand-written CUDA kernels
``csrc/fused_chain.cu`` (counterpart of quanonet_tpu/ops/pallas_fused.py,
whose ``_fwd_kernel`` and ``_bwd_kernel`` they replace; engine name
``'pfused'``), for 8 to 16 qubits.

The operands come from :func:`quanonet_torch.ops.fused_gates.
prepare_fused_chain_x` (the low-group unitaries, the high qubits' 2x2s, the
encoding angles x as (nb, N, n)); the kernels build each block's phases
from x and the backward returns x̄ of that shape, so the (nb, N, 2^n) phase
tensor is never allocated.  The kernels run the whole chain of R rows per
CTA, whatever the batch: no padding, no tiles to pick, no fallback.

:func:`fused_chain` dispatches:

* a gradient is needed -> :class:`FusedChain` (the counterpart of
  ``_make_chain``'s custom VJP): its forward runs the residual-saving
  forward kernel, its backward the backward kernels;
* no gradient (eval, serving) -> the primal-only forward kernel;
* CPU tensors -> the plain versions (:func:`fused_gates.chain_fused_x`,
  :func:`fused_gates.chain_fused_saved_x`,
  :func:`fused_gates.chain_fused_backward_x`); CUDA tensors launch the
  kernels or raise.

Widths: MIN_QUBITS..MAX_QUBITS (8..16) forward, training to
TRAIN_MAX_QUBITS (14), the JAX package's limits; above that a gradient
raises with a pointer to ``engine='fused'``.  Outside the range the engine
raises (the JAX package reroutes to 'fused' there).
"""
import ctypes
from functools import lru_cache

import torch

from quanonet_torch.ops import _build
from quanonet_torch.ops import fused_gates as _fg

KERNEL = 'fused_chain'
LANE_QUBITS = 7
MIN_QUBITS = 8
MAX_QUBITS = 16
TRAIN_MAX_QUBITS = 14
AUTO_MAX_QUBITS = 14       # 'auto' takes 'pfused' with a gradient up to here
# Up to these the kernels keep a CTA's rows in shared memory, above in a
# per-CTA scratch in device memory: the forward's 2 buffer pairs (and two
# 36 KB slots of U7t staging) fit at 13 qubits (209 KB), the backward's 4
# at 12.
FWD_SMEM_MAX_QUBITS = 13
BWD_SMEM_MAX_QUBITS = 12
PITCH = 132                # floats of a tile row of 128 lanes in a buffer
                           # (csrc/fused_chain.cu kPitch)
MIN_SPLIT_ROWS = 256       # fewest tile rows per slice of the U7bar reduction
MAX_SPLITS = 64

# Launches since import: ``launches`` counts the forward kernel (primal and
# residual variants), ``bwd_launches`` the backward.  chip_smoke.py zeroes
# them before driving a path and reads them after, to show that the path
# ran the kernels.
launches = 0
bwd_launches = 0

_VP, _I = ctypes.c_void_p, ctypes.c_int
_sub_offsets = {}
_schedules = {}


@lru_cache(maxsize=None)
def _lib():
    """The library, loaded (and built) once, its argument types set."""
    lib = _build.load(KERNEL)
    lib.fused_chain_forward.argtypes = [_VP] * 12 + [_I] * 4 + [_VP]
    lib.fused_chain_forward.restype = _I
    lib.fused_chain_backward.argtypes = [_VP] * 24 + [_I] * 6 + [_VP]
    lib.fused_chain_backward.restype = _I
    lib.fused_chain_error_string.argtypes = [_I]
    lib.fused_chain_error_string.restype = ctypes.c_char_p
    return lib


def rows_per_cta(n_qubits, batch, sms):
    """Batch rows each CTA owns: enough for 8 tile rows of 128 lanes
    (2^(n-7) a row) while those CTAs fit on the card at once; for a batch
    that would need more, 32 tile rows (16 at 8 qubits: the backward's 4
    buffer pairs, two staging slots and the phase factors of 16 rows would
    not fit in shared memory), so that each sublayer's 128 KB U7t and each
    A fragment serve 4 n8 tiles instead of one.  A CTA takes one SM (its
    registers), so past one wave the larger tile wins: the Q10 forward at
    N = 1000 took 7.3 ms on an H100 with 8 tile rows (8 waves), 4.3 ms
    with 32."""
    hi = 2 ** (n_qubits - LANE_QUBITS)
    rows = max(1, 8 // hi)
    if hi <= 16 and -(-batch // rows) > sms:
        rows = (32 if hi >= 4 else 16) // hi
    return rows


def u7bar_splits(n_sub, tile_rows, sms):
    """Slices of the N·hi tile rows for the U7bar GEMM: enough CTAs (4 per
    sublayer and slice) to fill ``sms`` SMs twice, at least MIN_SPLIT_ROWS
    rows each."""
    want = -(-2 * sms // max(1, 4 * n_sub))
    splits = max(1, min(want, -(-tile_rows // MIN_SPLIT_ROWS), MAX_SPLITS))
    per = -(-tile_rows // splits)
    return -(-tile_rows // per)


def _sub_off(lds, device):
    """(nb + 1) int32 sublayer offsets of the blocks on ``device``, copied
    there once per layout."""
    key = (tuple(lds), device)
    t = _sub_offsets.get(key)
    if t is None:
        off = [0]
        for ld in lds:
            off.append(off[-1] + ld)
        t = torch.tensor(off, dtype=torch.int32, device=device)
        _sub_offsets[key] = t
    return t


def schedule(lds, backward):
    """The order in which the kernels stream the sublayers' U7t, entry
    2 t + adj: the forward takes sublayers 0..S-1; the backward, per block
    in reverse, its sublayers in order (the recompute), then in reverse
    (the adjoint products)."""
    off = [0]
    for ld in lds:
        off.append(off[-1] + ld)
    if not backward:
        return [2 * t for t in range(off[-1])]
    out = []
    for b in range(len(lds) - 1, -1, -1):
        out += [2 * t for t in range(off[b], off[b + 1])]
        out += [2 * t + 1 for t in range(off[b + 1] - 1, off[b] - 1, -1)]
    return out


def _sched(lds, backward, device):
    """:func:`schedule` as int32 on ``device``, copied there once per
    layout (one entry at least: a valid pointer for a chain of encoding
    blocks only)."""
    key = (tuple(lds), backward, device)
    t = _schedules.get(key)
    if t is None:
        t = torch.tensor(schedule(lds, backward) or [0], dtype=torch.int32,
                         device=device)
        _schedules[key] = t
    return t


def _check(named, device):
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name.startswith('u7t') and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             f"read it as float4)")


def _check_operands(u7t_r, u7t_i, u2_r, u2_i, x, lds):
    """-> n_qubits, after checking the operands the kernels take."""
    if x.dim() != 3:
        raise ValueError(f"x must be (nb, N, n), got {tuple(x.shape)}")
    nb, n, nq = x.shape
    if not MIN_QUBITS <= nq <= MAX_QUBITS:
        raise ValueError(f"the fused-chain kernel takes {MIN_QUBITS} <= n <= "
                         f"{MAX_QUBITS} qubits, got x of {nq} angles a block")
    if nb < 1 or len(lds) != nb or min(lds) < 0:
        raise ValueError(f"block depths {tuple(lds)} do not match {nb} "
                         f"blocks")
    if n >= 2 ** 31 // 8:
        raise ValueError(f"batch of {n} rows is too large for one launch")
    s, nh = sum(lds), nq - LANE_QUBITS
    _check((('u7t_r', u7t_r, (s, 128, 128)), ('u7t_i', u7t_i, (s, 128, 128)),
            ('u2_r', u2_r, (s, nh, 4)), ('u2_i', u2_i, (s, nh, 4)),
            ('x', x, (nb, n, nq))), x.device)
    return nq


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.fused_chain_error_string(err).decode()} (cudaError {err})")


def _ptrs(ts):
    return [t.data_ptr() for t in ts] or [None] * 2


def _geometry(nq, n, dev):
    """(rows per CTA, grid) of a launch over n rows at nq qubits."""
    rows = rows_per_cta(nq, n,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    return rows, -(-n // rows)


def _scratch(nq, rows, grid, backward, dev):
    """Device-memory tiles (padded tile rows) of the forward's 2 buffer
    pairs above FWD_SMEM_MAX_QUBITS and of the backward's 4 above
    BWD_SMEM_MAX_QUBITS."""
    if nq <= (BWD_SMEM_MAX_QUBITS if backward else FWD_SMEM_MAX_QUBITS):
        return None
    pairs = 4 if backward else 2
    tile_rows = rows << (nq - LANE_QUBITS)
    return torch.empty((grid, 2 * pairs, tile_rows * PITCH),
                       dtype=torch.float32, device=dev)


def chain_forward(u7t_r, u7t_i, u2_r, u2_i, x, lds, save_residuals=False):
    """The forward kernel on CUDA tensors, x (nb, N, n): (sr, si), and with
    ``save_residuals`` also (states_r, states_i), each block's input state
    (nb, N, 2^n)."""
    global launches
    nq = _check_operands(u7t_r, u7t_i, u2_r, u2_i, x, lds)
    nb, n, _ = x.shape
    d = 2 ** nq
    dev = x.device
    out_r = torch.empty((n, d), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, d), dtype=torch.float32, device=dev)
    st = ((torch.empty((nb, n, d), dtype=torch.float32, device=dev),
           torch.empty((nb, n, d), dtype=torch.float32, device=dev))
          if save_residuals else ())
    if n:
        rows, grid = _geometry(nq, n, dev)
        scratch = _scratch(nq, rows, grid, False, dev)
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.fused_chain_forward(
                u7t_r.data_ptr(), u7t_i.data_ptr(), u2_r.data_ptr(),
                u2_i.data_ptr(), x.data_ptr(),
                _sub_off(lds, dev).data_ptr(),
                _sched(lds, False, dev).data_ptr(), out_r.data_ptr(),
                out_i.data_ptr(), *_ptrs(st),
                None if scratch is None else scratch.data_ptr(), nb, n, nq,
                rows, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, err, 'fused_chain_forward')
        launches += 1
    return (out_r, out_i, *st)


def chain_backward(u7t_r, u7t_i, u2_r, u2_i, x, lds, states_r, states_i,
                   gr, gi):
    """The backward kernels on CUDA tensors: the output's cotangent
    (gr, gi) -> (u7bar_r, u7bar_i, u2bar_r, u2bar_i, xbar), xbar
    (nb, N, n).  Deterministic: two calls on equal inputs give equal
    bits."""
    global bwd_launches
    nq = _check_operands(u7t_r, u7t_i, u2_r, u2_i, x, lds)
    if nq > TRAIN_MAX_QUBITS:
        raise _train_limit(nq)
    nb, n, _ = x.shape
    d = 2 ** nq
    s, nh = sum(lds), nq - LANE_QUBITS
    dev = x.device
    _check((('states_r', states_r, (nb, n, d)),
            ('states_i', states_i, (nb, n, d)),
            ('gr', gr, (n, d)), ('gi', gi, (n, d))), dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    u7bar = (zeros(s, 128, 128), zeros(s, 128, 128))
    u2bar = (zeros(s, nh, 4), zeros(s, nh, 4))
    xbar = torch.empty((nb, n, nq), dtype=torch.float32, device=dev)
    if not n:
        return (*u7bar, *u2bar, xbar.zero_())
    rows, grid = _geometry(nq, n, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = u7bar_splits(s, n << (nq - LANE_QUBITS), sms)
    pre = [torch.empty((s, n, d), dtype=torch.float32, device=dev)
           for _ in range(4)]          # pre-low states and cotangents
    u2part = torch.empty((s, grid, nh, 8), dtype=torch.float32, device=dev)
    part = ([torch.empty((splits, s, 128, 128), dtype=torch.float32,
                         device=dev) for _ in range(2)]
            if splits > 1 else [])
    scratch = _scratch(nq, rows, grid, True, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.fused_chain_backward(
            u7t_r.data_ptr(), u7t_i.data_ptr(), u2_r.data_ptr(),
            u2_i.data_ptr(), x.data_ptr(), _sub_off(lds, dev).data_ptr(),
            _sched(lds, True, dev).data_ptr(), states_r.data_ptr(),
            states_i.data_ptr(), gr.data_ptr(), gi.data_ptr(),
            *[t.data_ptr() for t in pre], u2part.data_ptr(),
            *_ptrs(part), None if scratch is None else scratch.data_ptr(),
            *[t.data_ptr() for t in u7bar + u2bar], xbar.data_ptr(), nb, s,
            n, nq, rows, splits, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, 'fused_chain_backward')
    bwd_launches += 1
    return (*u7bar, *u2bar, xbar)


def _train_limit(nq):
    return ValueError(
        f"pfused training tops out at Q{TRAIN_MAX_QUBITS} (the JAX "
        f"package's limit, pallas_fused.TRAIN_MAX_QUBITS); Q{nq} has a "
        f"gradient through it: train with engine='fused' (per-block "
        f"checkpointing) instead")


class FusedChain(torch.autograd.Function):
    """(u7t_r, u7t_i, u2_r, u2_i, x) -> (sr, si), x (nb, N, n), with the
    backward kernels as its gradient (the counterpart of
    pallas_fused._make_chain; x̄ comes back as (nb, N, n)).  On CPU tensors
    both passes are the plain versions."""

    @staticmethod
    def forward(ctx, u7t_r, u7t_i, u2_r, u2_i, x, lds):
        if x.device.type == 'cpu':
            sr, si, st_r, st_i = _fg.chain_fused_saved_x(u7t_r, u7t_i, u2_r,
                                                         u2_i, x, lds)
        else:
            sr, si, st_r, st_i = chain_forward(u7t_r, u7t_i, u2_r, u2_i, x,
                                               lds, save_residuals=True)
        ctx.lds = lds
        ctx.save_for_backward(u7t_r, u7t_i, u2_r, u2_i, x, st_r, st_i)
        return sr, si

    @staticmethod
    def backward(ctx, gr, gi):
        u7t_r, u7t_i, u2_r, u2_i, x, st_r, st_i = ctx.saved_tensors
        if x.device.type == 'cpu':
            grads = _fg.chain_fused_backward_x(u7t_r, u7t_i, u2_r, u2_i, x,
                                               ctx.lds, (st_r, st_i), gr, gi)
        else:
            grads = chain_backward(u7t_r, u7t_i, u2_r, u2_i, x, ctx.lds,
                                   st_r, st_i, gr.contiguous(),
                                   gi.contiguous())
        return (*grads, None)


def fused_chain(u7t_r, u7t_i, u2_r, u2_i, x, lds):
    """(u7t_r, u7t_i, u2_r, u2_i, x) -> (sr, si), x (nb, N, n): the chain of
    :func:`quanonet_torch.ops.fused_gates.chain_fused_x`, through the CUDA
    kernels for CUDA tensors.  lds: the blocks' linear depths."""
    lds = tuple(lds)
    ops = (u7t_r, u7t_i, u2_r, u2_i, x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        nq = x.shape[-1]
        if nq > TRAIN_MAX_QUBITS:
            raise _train_limit(nq)
        return FusedChain.apply(*ops, lds)
    if x.device.type == 'cpu':
        return _fg.chain_fused_x(*ops, lds)
    return chain_forward(*ops, lds)


def pfused_applicable(spec):
    return (MIN_QUBITS <= spec.n_qubits <= MAX_QUBITS and spec.uniform_encode
            and spec.n_blocks >= 1)


def forward_pfused(spec, weights, x):
    """(sr, si), each (batch, 2^n), through the fused-group chain kernels;
    the circuit contract of :func:`fused_gates.forward_fused`.  Raises
    outside 8..16 qubits and for a non-uniform encode."""
    if not pfused_applicable(spec):
        raise ValueError(
            f"engine 'pfused' takes {MIN_QUBITS}..{MAX_QUBITS} qubits with "
            f"n_encode == n_qubits per block, got {spec.n_qubits} qubits, "
            f"blocks {spec.block_configs}; use engine='fused'")
    return fused_chain(*_fg.prepare_fused_chain_x(spec, weights, x),
                       _fg.block_depths(spec))


def hea_expectation_pfused(spec, weights, x, diag):
    """Z-diagonal expectation (batch, 1) of the kernels' final state."""
    from quanonet_torch.ops.hea import diag_expectation_pair
    sr, si = forward_pfused(spec, weights, x)
    return diag_expectation_pair(sr, si, diag)
