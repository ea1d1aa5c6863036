"""
The block-chain forward kernel's CUDA source (quanonet_torch/csrc/
hea_chain.cu, B1f) run on the CPU: its angle route (the phases formed in
registers from the angles x) against its phase route (the phases that
hea.encoding_phases forms), and both against the plain chain
(hea.chain_dense).

The source is compiled with the host's C++ compiler against
tests/cuda_emulation/cuda_runtime.h, a stand-in for the CUDA runtime that
runs each CUDA thread as a user-level context on one OS thread, switched
at the barriers; the source's inline-PTX helpers (the cp.async copies) are
replaced here by synchronous copies.  This holds the angle route's
indexing (each row's angles read in place from x (N, nb * n), every
amplitude's signs) at three widths, every tile of TILES, one and three
blocks and ragged batches, without a card.  What it cannot hold (timing,
memory ordering, the card's sincosf) is left to the cuda-marked tests.

The angle route sums each phase in encoding_phases' order with exact
products, so its output equals the phase route's bit for bit; both lie
within 1e-5 of the plain chain (another summation order).
"""
import ctypes
import os

import numpy as np
import pytest
import torch

import emulated_cuda
from quanonet_torch.ops import cuda_hea, hea

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, 'quanonet_torch', 'csrc', 'hea_chain.cu')
AMP_TOL = 1e-5

# the inline-PTX helpers and their emulations
_BODIES = (
    ('void cp_async(void* dst',
     'std::memcpy(dst, src, src_bytes); '
     'std::memset(static_cast<char*>(dst) + src_bytes, 0, '
     'BYTES - src_bytes);'),
    ('void cp_async_commit()', ''),
    ('void cp_async_wait()', ''),
)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    lib = emulated_cuda.build(SOURCE, _BODIES,
                              tmp_path_factory.mktemp('hea_emulation'),
                              opt='-O1')
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hea_chain_forward.argtypes = [vp] * 7 + [i] * 4 + [vp]
    lib.hea_chain_forward_angles.argtypes = [vp] * 5 + [i] * 4 + [vp]
    return lib


def _operands(nq, nb, n, seed):
    """Random block matrices (as M^T, norm ~1) and angles x (N, nb * n)."""
    d = 2 ** nq
    rng = np.random.RandomState(seed)
    mt = [torch.tensor((rng.randn(nb, d, d) / np.sqrt(2 * d))
                       .astype(np.float32)) for _ in range(2)]
    x = torch.tensor(rng.uniform(-8, 8, (n, nb * nq)).astype(np.float32))
    return mt, x


@pytest.mark.parametrize("nq", [1, 3, 5])
@pytest.mark.parametrize("tile", [0, 1, 2])
@pytest.mark.parametrize("nb", [1, 3])
def test_angle_route_equals_phase_route(lib, nq, tile, nb):
    """Every tile at D = 2, 8, 32, a ragged batch over two CTAs and a
    bit: the angle route's output equals the phase route's bit for bit,
    and both lie within AMP_TOL of the plain chain."""
    d = 2 ** nq
    rows = cuda_hea.tile_geometry(d, tile, 1).rows
    n = rows + rows // 2 + 1
    (mt_r, mt_i), x = _operands(nq, nb, n, 100 * nq + 10 * tile + nb)
    phi = hea.encoding_phases(hea.HEASpec(nq, ((nq, 1),) * nb), x)
    out = [torch.empty(n, d) for _ in range(4)]
    assert lib.hea_chain_forward(
        mt_r.data_ptr(), mt_i.data_ptr(), phi.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), None, None, nb, n, d, tile, None) == 0
    assert lib.hea_chain_forward_angles(
        mt_r.data_ptr(), mt_i.data_ptr(), x.data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), nb, n, d, tile, None) == 0
    assert torch.equal(out[2], out[0]) and torch.equal(out[3], out[1])
    want = hea.chain_dense(mt_r, mt_i, phi)
    for got, plain in zip(out, want + want):
        assert (got - plain).abs().max().item() <= AMP_TOL


def test_angle_route_rejects_what_it_cannot_launch(lib):
    """No blocks, no rows, a width or a tile outside HEA_TILES: an error
    code, and nothing launched."""
    (mt_r, mt_i), x = _operands(2, 1, 4, 0)
    out = torch.empty(2, 4, 4)
    ptrs = (mt_r.data_ptr(), mt_i.data_ptr(), x.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr())
    for nb, n, d, tile in ((0, 4, 4, 0), (1, 0, 4, 0), (1, 4, 3, 0),
                           (1, 4, 4, 3)):
        assert lib.hea_chain_forward_angles(*ptrs, nb, n, d, tile,
                                            None) != 0
