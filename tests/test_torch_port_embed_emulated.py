"""
The real-embedding chain kernels' CUDA source (quanonet_torch/csrc/
embed_chain.cu) run on the CPU, against their plain versions
(cuda_embed.chain_embed_saved / chain_embed_backward).

The source is compiled with the host's C++ compiler against
tests/cuda_emulation/cuda_runtime.h, a stand-in for the CUDA runtime that
runs each CUDA thread as a user-level context on one OS thread, switched
at the barriers; the source's inline-PTX helpers (the cp.async copies)
are replaced here by synchronous copies, so a copy made into a ring slot
that another thread still reads shows as a wrong result.  This holds the
kernels' indexing, the ring of E panels, the double-buffered row tiles,
the forward's residual u and the Ebar reduction, which rebuilds each
block's input row from u and t, at every width and every tile of
EMBED_TILES, at the geometry the training batch takes, and with Ebar in
two slices, without a card.  What it cannot hold (timing, memory ordering) is left to the
cuda-marked tests on the card.

Tolerances as on the card (chip_smoke.py): 2e-5 on the output and the
residual u, 1e-4 x max(1, max|plain|) on the backward's cotangents; the
residual variant's output equals the primal kernel's bit for bit, and two
backward calls give equal bits.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

import emulated_cuda
from quanonet_torch.ops import cuda_embed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, 'quanonet_torch', 'csrc', 'embed_chain.cu')
AMP_TOL = 2e-5
BWD_REL_TOL = 1e-4
H100_SMS = 132

# the inline-PTX helpers and their emulations
_BODIES = (
    ('void cp_async16(float* smem', 'emu_cp16(smem, gmem);'),
    ('void cp_async_zfill(float* smem', 'emu_cpz(smem, gmem, BYTES, valid);'),
    ('void cp_async_commit()', ''),
    ('void cp_async_wait(int pending)', '(void)pending;'),
)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    lib = emulated_cuda.build(SOURCE, _BODIES,
                              tmp_path_factory.mktemp('embed_emulation'),
                              opt='-O1')
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.embed_chain_forward.argtypes = [vp] * 4 + [i] * 4 + [vp]
    lib.embed_chain_backward.argtypes = [vp] * 8 + [i] * 5 + [vp]
    lib.embed_chain_tile_rows.argtypes = [i, i]
    return lib


def _forward(lib, e, t, tile, save):
    """The wrapper's launch of the forward kernel, on CPU tensors."""
    nb, n, w = t.shape
    out = torch.empty(n, w)
    u = torch.zeros(max(nb - 1, 1), n, w) if save else None
    assert lib.embed_chain_forward(e.data_ptr(), t.data_ptr(),
                                   out.data_ptr(),
                                   u.data_ptr() if save else None, nb, n,
                                   w // 2, tile, None) == 0
    return (out, u) if save else out


def _backward(lib, e, t, u, g, tile):
    """The wrapper's launch of the backward kernels, on CPU tensors, with
    the slices of ebar_splits on an H100."""
    nb, n, w = t.shape
    splits = cuda_embed.ebar_splits(nb, n, w, H100_SMS)
    ub = torch.empty(nb, n, w)
    part = torch.empty(splits, nb, w, w) if splits > 1 else None
    ebar, tbar = torch.empty(nb, w, w), torch.empty(nb, n, w)
    assert lib.embed_chain_backward(
        e.data_ptr(), t.data_ptr(), u.data_ptr(), g.data_ptr(), ub.data_ptr(), None if part is None else part.data_ptr(),
        ebar.data_ptr(), tbar.data_ptr(), nb, n, w // 2, tile, splits,
        None) == 0
    return ebar, tbar


def _operands(d, nb, n, seed):
    """Random general E (no block structure), t (no antisymmetry), g, as
    chip_smoke's kernel phases draw them."""
    rng = np.random.RandomState(seed)
    w = 2 * d
    return [torch.tensor(a.astype(np.float32)) for a in (
        rng.randn(nb, w, w) / np.sqrt(w), rng.uniform(-12, 12, (nb, n, w)),
        rng.randn(n, w))]


def _check_case(lib, d, tile, nb, n):
    e, t, g = _operands(d, nb, n, 100 * d + 10 * tile + nb + n)
    out, u = _forward(lib, e, t, tile, True)
    want, wu = cuda_embed.chain_embed_saved(e, t)
    assert (out - want).abs().max().item() <= AMP_TOL
    assert (u - wu).abs().max().item() <= AMP_TOL
    assert torch.equal(_forward(lib, e, t, tile, False), out)

    got = _backward(lib, e, t, u, g, tile)
    for a, b in zip(got, cuda_embed.chain_embed_backward(e, t, u, g)):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= BWD_REL_TOL * scale
    again = _backward(lib, e, t, u, g, tile)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_tile_table_is_the_built_one(lib):
    """The emulated library reports cuda_embed.TILES' row tiles."""
    for d in cuda_embed.DIMS:
        for tile in range(len(cuda_embed.TILES[d])):
            assert lib.embed_chain_tile_rows(d, tile) == \
                cuda_embed.tile_geometry(d, tile, 1).rows
    assert lib.embed_chain_tile_rows(32, 3) == 0


@pytest.mark.parametrize("d", cuda_embed.DIMS)
@pytest.mark.parametrize("tile", [0, 1, 2])
def test_every_tile_ragged(lib, d, tile):
    """Every tile of every width, three blocks, a ragged batch of 37."""
    _check_case(lib, d, tile, 3, 37)


@pytest.mark.parametrize("d,tile,n", [(1, 0, 5), (32, 0, 37), (128, 2, 3)])
def test_one_block(lib, d, tile, n):
    """A single block (nb = 1): the forward's one product, the sweep's
    first step, the residual u unwritten and unread."""
    _check_case(lib, d, tile, 1, n)


def test_training_geometry(lib):
    """The geometry the flagship's training batch takes on an H100 (N = 100,
    d = 32), five blocks."""
    tile = cuda_embed.embed_geometry(100, 32, H100_SMS).tile
    _check_case(lib, 32, tile, 5, 100)


@pytest.mark.parametrize("d", [2, 32])
def test_ebar_in_slices(lib, d):
    """One row past a slice of 1,024: Ebar in two slices, summed in slice
    order by the third launch, at the geometry the wrapper takes."""
    nb, n = 3, 1025
    assert cuda_embed.ebar_splits(nb, n, 2 * d, H100_SMS) == 2
    tile = cuda_embed.embed_geometry(n, d, H100_SMS).tile
    _check_case(lib, d, tile, nb, n)
