"""
The block-matrix compile kernels' CUDA source (quanonet_torch/csrc/
ucomp.cu) run on the CPU, against their plain versions
(cuda_ucomp.ucomp_weights_dense and autograd through it).

The source is compiled with the host's C++ compiler against
tests/cuda_emulation/cuda_runtime.h, a stand-in for the CUDA runtime that
runs each CUDA thread as a user-level context on one OS thread, switched
at the barriers and the warp shuffles.  This holds the kernels' gate passes
(the lane and register pairs of every qubit, the ring gather through
shuffles and through shared memory), the walk back with each angle's
cotangent, the warp, CTA and block reductions, at Q1-Q7, depths 1-3, the
last block at the end, in the middle, absent and every block
(EVERY_BLOCK, the final blocks of a packed multi-seed step), a single
block and the flagship, with the launch geometry an H100 takes.  What it cannot hold
(timing, memory ordering) is left to the cuda-marked tests on the card.

Tolerances as on the card (chip_smoke.py): 2e-5 on the block matrices,
1e-4 x max(1, max|plain|) on w̄; two backward calls give equal bits.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

import emulated_cuda
from quanonet_torch.ops import cuda_ucomp

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(REPO), 'quanonet_torch', 'csrc',
                      'ucomp.cu')
AMP_TOL = 2e-5
BWD_REL_TOL = 1e-4
H100_SMS = 132

CASES = [    # (qubits, blocks, linear depth, last)
    (1, 3, 1, 2), (2, 4, 2, -1), (3, 3, 3, 1), (4, 5, 2, 4),
    (5, 1, 2, 0), (5, 3, 3, -1), (6, 2, 1, 0), (6, 3, 2, 1),
    (7, 2, 2, 1), (7, 1, 3, -1), (5, 60, 2, 59),
    # every block's right factor I: the final blocks of several chains
    (3, 4, 2, cuda_ucomp.EVERY_BLOCK), (5, 4, 2, cuda_ucomp.EVERY_BLOCK),
]
IDS = [f"q{n}-nb{nb}-ld{ld}-last{last}" for n, nb, ld, last in CASES]


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    lib = emulated_cuda.build(SOURCE, (),
                              tmp_path_factory.mktemp('ucomp_emulation'),
                              opt='-O1')
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ucomp_forward.argtypes = [vp] * 3 + [i] * 6 + [vp]
    lib.ucomp_backward.argtypes = [vp] * 5 + [i] * 6 + [vp]
    lib.ucomp_row_groups.argtypes = [i]
    return lib


def _forward(lib, w, ld, last):
    """The wrapper's launch of B4f, on CPU tensors, at an H100's geometry."""
    s, _, n = w.shape
    nb, dim = s // ld, 2 ** n
    geo = cuda_ucomp.ucomp_geometry(dim, nb, H100_SMS)
    mt_r, mt_i = torch.empty(nb, dim, dim), torch.empty(nb, dim, dim)
    assert lib.ucomp_forward(w.data_ptr(), mt_r.data_ptr(), mt_i.data_ptr(),
                             n, nb, ld, last, geo.warps, geo.ctas,
                             None) == 0
    return mt_r, mt_i


def _backward(lib, w, ld, last, gr, gi):
    """The wrapper's launch of B4b, on CPU tensors, at an H100's
    geometry."""
    s, _, n = w.shape
    nb = s // ld
    geo = cuda_ucomp.ucomp_geometry(2 ** n, nb, H100_SMS, backward=True)
    wbar = torch.empty_like(w)
    part = torch.empty(nb, geo.ctas, ld * 3 * n) if geo.ctas > 1 else None
    assert lib.ucomp_backward(
        w.data_ptr(), gr.data_ptr(), gi.data_ptr(),
        None if part is None else part.data_ptr(), wbar.data_ptr(), n, nb,
        ld, last, geo.warps, geo.ctas, None) == 0
    return wbar


def test_row_groups_are_the_built_ones(lib):
    """The emulated library reports cuda_ucomp.row_groups at every width,
    and 0 outside 1..7 qubits."""
    for n in range(1, 8):
        assert lib.ucomp_row_groups(n) == cuda_ucomp.row_groups(2 ** n)
    assert lib.ucomp_row_groups(8) == 0


@pytest.mark.parametrize("n,nb,ld,last", CASES, ids=IDS)
def test_kernels_match_plain(lib, n, nb, ld, last):
    rng = np.random.RandomState(100 * n + 10 * ld + nb)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, (nb * ld, 3, n))
                     .astype(np.float32))
    dim = 2 ** n
    gr, gi = (torch.tensor(rng.randn(nb, dim, dim).astype(np.float32))
              for _ in range(2))
    got = _forward(lib, w, ld, last)
    wg = w.clone().requires_grad_()
    want = cuda_ucomp.ucomp_weights_dense(wg, ld, last)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= AMP_TOL
    (plain,) = torch.autograd.grad(
        (want[0] * gr).sum() + (want[1] * gi).sum(), wg)
    wbar = _backward(lib, w, ld, last, gr, gi)
    scale = max(1.0, plain.abs().max().item())
    assert (wbar - plain).abs().max().item() <= BWD_REL_TOL * scale
    assert torch.equal(wbar, _backward(lib, w, ld, last, gr, gi))


def test_refuses_what_it_does_not_take(lib):
    """Qubits outside 1..7, a last block out of range, too many warps and
    a backward of several CTAs without its partial buffer return
    cudaErrorInvalidValue and launch nothing."""
    w = torch.zeros(4, 3, 3)
    out = torch.full((2, 8, 8), 7.0)
    ptrs = (w.data_ptr(), out.data_ptr(), out.data_ptr())
    assert lib.ucomp_forward(*ptrs, 8, 2, 2, 1, 1, 1, None) == 1
    assert lib.ucomp_forward(*ptrs, 3, 2, 2, 2, 1, 1, None) == 1
    assert lib.ucomp_forward(*ptrs, 3, 2, 2, -3, 1, 1, None) == 1
    assert lib.ucomp_forward(*ptrs, 3, 2, 2, 1, 17, 1, None) == 1
    assert lib.ucomp_backward(w.data_ptr(), out.data_ptr(), out.data_ptr(),
                              None, w.data_ptr(), 3, 2, 2, 1, 1, 2,
                              None) == 1
    assert bool((out == 7.0).all())
