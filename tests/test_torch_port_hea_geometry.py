"""
The launch geometry of the block-chain kernels (quanonet_torch/ops/
cuda_hea.py: chain_geometry, tile_geometry, mbar_splits), which the CPU
can check though the kernels run only on the card: every batch row and
amplitude is owned by exactly one thread, the tiles fit the card's limits,
the table is the one csrc/hea_chain.cu instantiates, and the Mbar slices
cover the batch in a fixed order.  Also the wrapper's host side: the
library is loaded and configured once, the SM count read once.
"""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quanonet_torch.ops import _build, cuda_hea
from quanonet_torch.profile_step import launches_of

H100_SMS = 132
NS = (1, 7, 8, 9, 100, 101, 1000, 8192)
SOURCE = Path(cuda_hea.__file__).resolve().parent.parent / 'csrc' / \
    'hea_chain.cu'


def _owners(d, threads, cj, p, interleaved):
    """(row in the tile, amplitude) -> count of threads that own it, for
    the forward's contiguous amplitudes (tj * CJ + c) or the sweep's
    interleaved outputs (tk + c * JT)."""
    jt = d // cj
    rg_count = threads // jt
    owned = np.zeros((rg_count * p, d), int)
    for t in range(threads):
        tj, rg = t % jt, t // jt
        for q in range(p):
            for c in range(cj):
                j = tj + c * jt if interleaved else tj * cj + c
                owned[q * rg_count + rg, j] += 1
    return owned


def test_table_matches_the_kernel_source():
    """cuda_hea.TILES is HEA_TILES of csrc/hea_chain.cu, in order."""
    text = SOURCE.read_text()
    body = text[text.index('#define HEA_TILES(X)'):]
    body = body[:body.index('namespace {')]
    rows = re.findall(r'X\((\d+), (\d+), (\d+), (\d+), (\d+)\)', body)
    table = {}
    for d, t, threads, cj, p in (tuple(map(int, r)) for r in rows):
        assert t == len(table.setdefault(d, []))
        table[d].append((threads, cj, p))
    assert {d: tuple(v) for d, v in table.items()} == cuda_hea.TILES
    assert tuple(sorted(table)) == cuda_hea.DIMS


@pytest.mark.parametrize("d", cuda_hea.DIMS)
def test_tiles_cover_rows_and_fit_the_card(d):
    """Each tile: every (row, amplitude) of the row tile has one owner in
    both kernels; threads, shared memory within sm_90's limits; row tiles
    grow along the table."""
    rows = []
    for t, (threads, cj, p) in enumerate(cuda_hea.TILES[d]):
        g = cuda_hea.tile_geometry(d, t, 1)
        for interleaved in (False, True):
            owned = _owners(d, threads, cj, p, interleaved)
            assert owned.shape == (g.rows, d)
            assert (owned == 1).all()
        assert threads % 32 == 0 and threads <= cuda_hea.MAX_THREADS
        assert d % cj == 0 and cj in (1, 2, 4)
        assert max(g.fwd_smem, g.bwd_smem) <= cuda_hea.SMEM_LIMIT
        rows.append(g.rows)
    assert rows == sorted(rows) and len(set(rows)) == len(rows)


@pytest.mark.parametrize("d", cuda_hea.DIMS)
@pytest.mark.parametrize("n", NS)
def test_geometry_covers_every_row_once(d, n):
    """The grid's row tiles partition [0, N): the last CTA holds the ragged
    end, none is empty; the choice is one of the table's tiles."""
    g = cuda_hea.chain_geometry(n, d, H100_SMS)
    assert g == cuda_hea.tile_geometry(d, g.tile, n)
    starts = np.arange(g.grid) * g.rows
    covered = np.concatenate([np.arange(s, min(s + g.rows, n)) for s in starts])
    assert np.array_equal(covered, np.arange(n))
    assert (g.grid - 1) * g.rows < n <= g.grid * g.rows
    assert g.grid < 2 ** 31
    # the largest tile that still fills half the card, else the smallest
    others = [cuda_hea.tile_geometry(d, t, n)
              for t in range(len(cuda_hea.TILES[d]))]
    if 2 * g.grid >= H100_SMS:
        assert all(2 * o.grid < H100_SMS for o in others if o.rows > g.rows)
    else:
        assert g.tile == 0


def test_flagship_geometry():
    """The training batch spreads over tens of SMs; serving's largest
    bucket takes the 2 x 4 register tile; one slice of Mbar at N = 100."""
    small = cuda_hea.chain_geometry(100, 32, H100_SMS)
    assert (small.rows, small.grid, small.p, small.cj) == (8, 13, 1, 1)
    big = cuda_hea.chain_geometry(8192, 32, H100_SMS)
    assert (big.rows, big.grid, big.p, big.cj) == (64, 128, 2, 4)
    assert cuda_hea.mbar_splits(60, 100, 32, H100_SMS) == 1
    assert cuda_hea.mbar_splits(60, 8192, 32, H100_SMS) > 1


@pytest.mark.parametrize("d", cuda_hea.DIMS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("nb", [1, 60])
def test_mbar_slices_in_fixed_order(d, n, nb):
    """The slices of the Mbar reduction are non-empty, in order, disjoint
    and cover the batch; a slice holds at least MIN_SPLIT_ROWS rows unless
    there is one; the output tile divides D."""
    splits = cuda_hea.mbar_splits(nb, n, d, H100_SMS)
    assert 1 <= splits <= min(n, cuda_hea.MAX_SPLITS)
    per = -(-n // splits)
    bounds = [(s * per, min((s + 1) * per, n)) for s in range(splits)]
    assert all(lo < hi for lo, hi in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if splits > 1:
        assert per >= cuda_hea.MIN_SPLIT_ROWS
    assert d % cuda_hea.mbar_tile_side(d) == 0
    assert cuda_hea.mbar_splits(nb, n, d, H100_SMS) == splits


class _FakeFn:
    """A C function of the library: counts calls and argtypes settings."""

    def __init__(self, result=0):
        object.__setattr__(self, 'calls', [])
        object.__setattr__(self, 'configured', 0)
        object.__setattr__(self, 'result', result)

    def __setattr__(self, name, value):
        if name == 'argtypes':
            object.__setattr__(self, 'configured', self.configured + 1)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        self.calls.append(args)
        return self.result(*args) if callable(self.result) else self.result


class _FakeLib:
    def __init__(self):
        self.hea_chain_forward = _FakeFn()
        self.hea_chain_backward = _FakeFn()
        self.hea_chain_error_string = _FakeFn(b'')
        self.hea_chain_tile_rows = _FakeFn(
            lambda d, t: cuda_hea.tile_geometry(d, t, 1).rows)


def test_library_loaded_and_configured_once(monkeypatch):
    """Several forward and backward calls load the library once, set its
    argtypes once and read the SM count once; each call passes the tile
    of chain_geometry.  The library is a stand-in: no card is needed (the
    calls get CPU pointers, which the stand-in never reads)."""
    loads, props = [], []
    lib = _FakeLib()

    def fake_load(name):
        loads.append(name)
        return lib

    class Props:
        multi_processor_count = H100_SMS

    def fake_props(index):
        props.append(index)
        return Props()

    monkeypatch.setattr(_build, 'load', fake_load)
    monkeypatch.setattr(torch.cuda, 'get_device_properties', fake_props)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(cuda_hea, '_stream', lambda dev: 0)
    cuda_hea._lib.cache_clear()
    cuda_hea.sm_count.cache_clear()
    try:
        rng = np.random.RandomState(0)
        nb, d = 3, 32
        mt = [torch.tensor(rng.randn(nb, d, d).astype(np.float32))
              for _ in range(2)]
        before = launches_of('hea_chain_fwd', 'hea_chain_bwd')
        for n in (100, 8192, 100):
            phi = torch.tensor(rng.randn(nb, n, d).astype(np.float32))
            g = [torch.zeros(n, d) for _ in range(2)]
            cuda_hea.chain_forward(*mt, phi)
            _, _, st_r, st_i = cuda_hea.chain_forward(*mt, phi,
                                                      save_residuals=True)
            cuda_hea.chain_backward(*mt, phi, st_r, st_i, *g)
        assert loads == ['hea_chain']
        assert props == [None]
        for fn in (lib.hea_chain_forward, lib.hea_chain_backward,
                   lib.hea_chain_error_string, lib.hea_chain_tile_rows):
            assert fn.configured == 1
        after = launches_of('hea_chain_fwd', 'hea_chain_bwd')
        assert (after[0] - before[0], after[1] - before[1]) == (6, 3)
        tiles = [args[-2] for args in lib.hea_chain_forward.calls]
        want = [cuda_hea.chain_geometry(n, d, H100_SMS).tile
                for n in (100, 100, 8192, 8192, 100, 100)]
        assert tiles == want
        assert [args[-3] for args in lib.hea_chain_backward.calls] == \
            want[::2]
    finally:
        cuda_hea._lib.cache_clear()
        cuda_hea.sm_count.cache_clear()
