"""
The fused-group chain kernels' CUDA source (quanonet_torch/csrc/
fused_chain.cu) run on the CPU, against their plain versions
(fused_gates.chain_fused_saved_x / chain_fused_backward_x).

The source is compiled with the host's C++ compiler against
tests/cuda_emulation/cuda_runtime.h, a stand-in for the CUDA runtime that
runs each CUDA thread as a user-level context on one OS thread, switched
at the barriers (so that a loaded host cannot starve it); the source's
inline-PTX helpers (cp.async copies, TF32 rounding, mma.sync) are replaced
here by synchronous emulations.  This holds the kernels'
indexing, layouts and algebra at every width the card takes, in shared
memory and in device-memory scratch, and with the large-batch geometry,
without a card.  What it cannot hold (timing, memory ordering, the tensor
cores' own rounding) is left to the cuda-marked tests on the card.

Tolerances as on the card (chip_smoke.py): 2e-5 on amplitudes and states,
1e-4 x max(1, max|plain|) on the backward's cotangents; the residual
variant's output equals the primal kernel's bit for bit.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from quanonet_torch.ops import cuda_fused, fused_gates, hea

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, 'quanonet_torch', 'csrc', 'fused_chain.cu')
HEADERS = os.path.join(REPO, 'tests', 'cuda_emulation')
AMP_TOL = 2e-5
BWD_REL_TOL = 1e-4

# the inline-PTX helpers and their emulations
_BODIES = (
    ('void cp_async16(float* smem', 'emu_cp16(smem, gmem);'),
    ('void cp_async16_zfill(', 'emu_cp16z(smem, gmem, valid);'),
    ('void cp_async_commit()', ''),
    ('void cp_async_wait(int pending)', '(void)pending;'),
    ('void split_tf32(float v',
     'hi = emu_tf32(v); lo = emu_tf32(v - __uint_as_float(hi));'),
    ('void mma_tf32(float (&d)[4]', 'emu_mma(d, a, b0, b1);'),
    ('void mma_tf32_zero(float (&d)[4]',
     'd[0] = d[1] = d[2] = d[3] = 0.f; emu_mma(d, a, b0, b1);'),
)


def _replace_body(src, head, body):
    i = src.index(head)
    j = src.index('{', i)
    depth = 0
    for k in range(j, len(src)):
        depth += {'{': 1, '}': -1}.get(src[k], 0)
        if depth == 0:
            return src[:j] + '{ ' + body + ' }' + src[k + 1:]
    raise ValueError(head)


def emulation_source(src):
    """fused_chain.cu -> a C++ translation unit for the emulation."""
    for head, body in _BODIES:
        src = _replace_body(src, head, body)
    src = re.sub(r'(\w+(?:<[^<>]*>)?)<<<(.*?),(.*?),(.*?),(.*?)>>>\(',
                 lambda m: f'Launch{{dim3({m.group(2)}), dim3({m.group(3)})}}'
                           f'({m.group(1)})(', src, flags=re.S)
    for name in ('smem', 'gsm'):
        src = src.replace(f'extern __shared__ __align__(16) float {name}[];',
                          f'float* {name} = ::{name};')
    return src


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    cxx = shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        pytest.skip("needs a C++20 compiler for the emulation")
    out = tmp_path_factory.mktemp('fused_emulation')
    cpp = out / 'fused_chain_emulated.cpp'
    with open(SOURCE) as f:
        cpp.write_text(emulation_source(f.read()))
    so = out / 'libfused_chain_emulated.so'
    subprocess.run([cxx, '-std=c++20', '-O2', '-shared', '-fPIC', '-pthread',
                    '-I', HEADERS, '-o', str(so), str(cpp)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_chain_forward.argtypes = [vp] * 12 + [i] * 4 + [vp]
    lib.fused_chain_backward.argtypes = [vp] * 24 + [i] * 6 + [vp]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tables(lds, backward):
    off = np.cumsum((0,) + tuple(lds)).astype(np.int32)
    sched = cuda_fused.schedule(lds, backward) or [0]
    return torch.tensor(off), torch.tensor(sched, dtype=torch.int32)


def _forward(lib, ops, lds, sms, save):
    """The wrapper's launch of the forward kernel, on CPU tensors."""
    xb = ops[4]
    nb, n, nq = xb.shape
    d = 2 ** nq
    out = [torch.empty(n, d) for _ in range(2)]
    st = [torch.empty(nb, n, d) for _ in range(2)] if save else [None] * 2
    rows = cuda_fused.rows_per_cta(nq, n, sms)
    grid = -(-n // rows)
    scratch = cuda_fused._scratch(nq, rows, grid, False, 'cpu')
    off, sched = _tables(lds, False)
    err = lib.fused_chain_forward(*map(_ptr, ops), _ptr(off), _ptr(sched),
                                  *map(_ptr, out + st), _ptr(scratch), nb, n,
                                  nq, rows, None)
    assert err == 0
    return (*out, *st) if save else tuple(out)


def _backward(lib, ops, lds, sms, st_r, st_i, gr, gi):
    """The wrapper's launch of the backward kernels, on CPU tensors."""
    xb = ops[4]
    nb, n, nq = xb.shape
    d, s, nh = 2 ** nq, sum(lds), nq - 7
    rows = cuda_fused.rows_per_cta(nq, n, sms)
    grid = -(-n // rows)
    splits = cuda_fused.u7bar_splits(s, n << nh, sms)
    u7bar = [torch.zeros(s, 128, 128) for _ in range(2)]
    u2bar = [torch.zeros(s, nh, 4) for _ in range(2)]
    xbar = torch.empty(nb, n, nq)
    pre = [torch.empty(s, n, d) for _ in range(4)]
    u2part = torch.empty(s, grid, nh, 8)
    part = ([torch.empty(splits, s, 128, 128) for _ in range(2)]
            if splits > 1 else [None] * 2)
    scratch = cuda_fused._scratch(nq, rows, grid, True, 'cpu')
    off, sched = _tables(lds, True)
    err = lib.fused_chain_backward(
        *map(_ptr, ops), _ptr(off), _ptr(sched), *map(_ptr, (st_r, st_i, gr, gi)),
        *map(_ptr, pre), _ptr(u2part), *map(_ptr, part), _ptr(scratch),
        *map(_ptr, u7bar + u2bar), _ptr(xbar), nb, s, n, nq, rows, splits,
        None)
    assert err == 0
    return (*u7bar, *u2bar, xbar)


# (qubits, net_size or block configs, N, SMs the geometry is chosen for; 0
# takes the large-batch geometry at any N)
CASES = [
    (8, (1, 1, 1, 1), 5, 132),                          # 4 rows a CTA, ragged
    (8, ((8, 1), (8, 0), (8, 2), (8, 0)), 3, 132),      # encode-only blocks
    (9, (1, 1, 1, 1), 3, 132),                          # 2 rows a CTA, ragged
    (10, (1, 1, 1, 1), 8, 0),                           # 32 tile rows a CTA
    (12, (1, 1, 1, 1), 2, 132),                         # 32 tile rows a row
    (13, (1, 1, 1, 1), 1, 132),                         # backward in device memory
]


@pytest.mark.parametrize("nq,net,n,sms", CASES)
def test_emulated_kernels_match_plain(lib, nq, net, n, sms):
    spec = (hea.HEASpec(nq, net) if isinstance(net[0], tuple)
            else hea.quanonet_spec(nq, net))
    rng = np.random.RandomState(nq + n)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32))
    x = torch.tensor(rng.uniform(-4, 4, (n, spec.total_encode))
                     .astype(np.float32))
    ops = fused_gates.prepare_fused_chain_x(spec, w, x)
    lds = fused_gates.block_depths(spec)
    got = _forward(lib, ops, lds, sms, True)
    want = fused_gates.chain_fused_saved_x(*ops, lds)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= AMP_TOL
    primal = _forward(lib, ops, lds, sms, False)
    assert all(torch.equal(a, b) for a, b in zip(primal, got[:2]))

    g = [torch.tensor(rng.randn(n, spec.dim).astype(np.float32))
         for _ in range(2)]
    grads = _backward(lib, ops, lds, sms, want[2], want[3], *g)
    plain = fused_gates.chain_fused_backward_x(*ops, lds, (want[2], want[3]),
                                               *g)
    for a, b in zip(grads, plain):
        assert a.shape == b.shape
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= BWD_REL_TOL * scale


def test_emulated_q14_forward_in_scratch(lib):
    """The forward in device-memory scratch (7 high qubits: passes of 3, 3
    and 1 bits a Hadamard or a sublayer's 2x2s; 128 tile rows, in 2
    batches of tile rows a product)."""
    spec = hea.quanonet_spec(14, (1, 1, 1, 1))
    rng = np.random.RandomState(14)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32))
    x = torch.tensor(rng.uniform(-4, 4, (1, spec.total_encode))
                     .astype(np.float32))
    ops = fused_gates.prepare_fused_chain_x(spec, w, x)
    lds = fused_gates.block_depths(spec)
    got = _forward(lib, ops, lds, 132, False)
    want = fused_gates.chain_fused_x(*ops, lds)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= AMP_TOL
