"""
The launch geometry of the real-embedding chain kernels (quanonet_torch/
ops/cuda_embed.py: embed_geometry, tile_geometry, ebar_splits), which the
CPU can check though the kernels run only on the card: every batch row and
column is owned by exactly one thread, the tiles fit the card's limits,
the table is the one csrc/embed_chain.cu instantiates, and the Ebar slices
cover the batch in a fixed order.  Also the wrapper's host side: the
library is loaded and configured once, the SM count read once.
"""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quanonet_torch.ops import _build, cuda_embed, cuda_hea
from quanonet_torch.profile_step import launches_of

H100_SMS = 132
NS = (1, 7, 8, 9, 100, 101, 1000, 1024, 1025, 8192)
SOURCE = Path(cuda_embed.__file__).resolve().parent.parent / 'csrc' / \
    'embed_chain.cu'


def _owners(d, threads, cj, p, ks, interleaved):
    """(row in the tile, column) -> count of threads that finish it: thread
    (rg, kg, tj) finishes, of its CJ pairs, those o * KS + kg, at the
    forward's contiguous columns (tj * CJ + c and d + ...) or the sweep's
    interleaved ones (tj + c * JT and d + ...)."""
    jt = d // cj
    lanes = jt * ks
    rg_count = threads // lanes
    owned = np.zeros((rg_count * p, 2 * d), int)
    for t in range(threads):
        tj, kg, rg = t % jt, t // jt % ks, t // lanes
        for q in range(p):
            for o in range(cj // ks):
                c = o * ks + kg
                j = tj + c * jt if interleaved else tj * cj + c
                owned[q * rg_count + rg, j] += 1
                owned[q * rg_count + rg, d + j] += 1
    return owned


def test_table_matches_the_kernel_source():
    """cuda_embed.TILES is EMBED_TILES of csrc/embed_chain.cu, in order."""
    text = SOURCE.read_text()
    body = text[text.index('#define EMBED_TILES(X)'):]
    body = body[:body.index('namespace {')]
    rows = re.findall(r'X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)',
                      body)
    table = {}
    for d, t, threads, cj, p, ks in (tuple(map(int, r)) for r in rows):
        assert t == len(table.setdefault(d, []))
        table[d].append((threads, cj, p, ks))
    assert {d: tuple(v) for d, v in table.items()} == cuda_embed.TILES
    assert tuple(sorted(table)) == cuda_embed.DIMS


@pytest.mark.parametrize("d", cuda_embed.DIMS)
def test_tiles_cover_rows_and_fit_the_card(d):
    """Each tile: every (row, column) of the row tile has one thread that
    finishes it in both kernels; a depth split lies within a warp (its lanes
    add by shuffles) and holds whole k steps of every panel; threads,
    shared memory within sm_90's limits; row tiles grow along the table; a
    panel of the ring holds whole k steps of E and at most 32 KB."""
    w = 2 * d
    kp = cuda_embed.panel_depth(w)
    assert w % kp == 0 and kp % min(w, 4) == 0 and 4 * kp * w <= 32768
    rows = []
    for t, (threads, cj, p, ks) in enumerate(cuda_embed.TILES[d]):
        g = cuda_embed.tile_geometry(d, t, 1)
        for interleaved in (False, True):
            owned = _owners(d, threads, cj, p, ks, interleaved)
            assert owned.shape == (g.rows, 2 * d)
            assert (owned == 1).all()
        assert threads % 32 == 0 and threads <= cuda_hea.MAX_THREADS
        assert d % cj == 0 and cj in (1, 2, 4)
        if ks > 1:
            assert 32 % (d // cj * ks) == 0 and cj % ks == 0
            assert (kp // ks) % min(w, 4) == 0
        assert max(g.fwd_smem, g.bwd_smem) <= cuda_hea.SMEM_LIMIT
        rows.append(g.rows)
    assert rows == sorted(rows) and len(set(rows)) == len(rows)
    assert cuda_embed.ebar_smem(w) <= cuda_hea.SMEM_LIMIT


@pytest.mark.parametrize("d", cuda_embed.DIMS)
@pytest.mark.parametrize("n", NS)
def test_geometry_covers_every_row_once(d, n):
    """The grid's row tiles partition [0, N): the last CTA holds the ragged
    end, none is empty; the choice is one of the table's tiles, the
    largest that still fills half the card, else the smallest."""
    g = cuda_embed.embed_geometry(n, d, H100_SMS)
    assert g == cuda_embed.tile_geometry(d, g.tile, n)
    starts = np.arange(g.grid) * g.rows
    covered = np.concatenate([np.arange(s, min(s + g.rows, n)) for s in starts])
    assert np.array_equal(covered, np.arange(n))
    assert (g.grid - 1) * g.rows < n <= g.grid * g.rows
    assert g.grid < 2 ** 31
    others = [cuda_embed.tile_geometry(d, t, n)
              for t in range(len(cuda_embed.TILES[d]))]
    if 2 * g.grid >= H100_SMS:
        assert all(2 * o.grid < H100_SMS for o in others if o.rows > g.rows)
    else:
        assert g.tile == 0


def test_flagship_geometry():
    """The training batch spreads over at least 12 SMs (a row a CTA, its
    depth split four ways); serving's largest bucket takes a 2 x 4
    register tile; one slice of Ebar up to 1,024 rows, so the training
    batch's backward is two launches."""
    small = cuda_embed.embed_geometry(100, 32, H100_SMS)
    assert small.grid >= 12
    assert (small.rows, small.grid, small.ks) == (1, 100, 4)
    big = cuda_embed.embed_geometry(8192, 32, H100_SMS)
    assert (big.rows, big.grid, big.p, big.cj) == (32, 256, 2, 2)
    assert cuda_embed.ebar_splits(60, 100, 64, H100_SMS) == 1
    assert cuda_embed.ebar_splits(60, 1024, 64, H100_SMS) == 1
    assert cuda_embed.ebar_splits(60, 1025, 64, H100_SMS) == 2
    assert cuda_embed.ebar_splits(60, 8192, 64, H100_SMS) > 1


@pytest.mark.parametrize("d", cuda_embed.DIMS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("nb", [1, 60])
def test_ebar_slices_in_fixed_order(d, n, nb):
    """The slices of the Ebar reduction: one up to MIN_SPLIT_ROWS (1,024)
    rows and at most one more for every further MIN_SPLIT_ROWS; they are
    non-empty, in order, disjoint and cover the batch; the output tile
    divides W."""
    w = 2 * d
    splits = cuda_embed.ebar_splits(nb, n, w, H100_SMS)
    assert 1 <= splits <= min(n, cuda_embed.MAX_SPLITS)
    if n <= 1024:
        assert splits == 1
    per = -(-n // splits)
    bounds = [(s * per, min((s + 1) * per, n)) for s in range(splits)]
    assert all(lo < hi for lo, hi in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert splits <= -(-n // cuda_embed.MIN_SPLIT_ROWS)
    if splits > 1:
        assert per > cuda_embed.MIN_SPLIT_ROWS // 2
    assert w % cuda_embed.ebar_tile_side(w) == 0
    assert cuda_embed.ebar_splits(nb, n, w, H100_SMS) == splits


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
        self.embed_chain_forward = _FakeFn()
        self.embed_chain_backward = _FakeFn()
        self.embed_chain_error_string = _FakeFn(b'')
        self.embed_chain_tile_rows = _FakeFn(
            lambda d, t: cuda_embed.tile_geometry(d, t, 1).rows)


def test_library_loaded_and_configured_once(monkeypatch):
    """Several forward and backward calls load the library once, set its
    argtypes once and read the SM count once; each call passes the tile
    of embed_geometry and the slices of ebar_splits.  The library is a
    stand-in and the tensors pass for CUDA ones: no card is needed (the
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
    monkeypatch.setattr(cuda_embed, '_stream', lambda dev: 0)
    monkeypatch.setattr(cuda_embed, '_check_operands', lambda e, t: None)
    monkeypatch.setattr(cuda_embed, '_check', lambda named, device: None)
    cuda_embed._lib.cache_clear()
    cuda_hea.sm_count.cache_clear()
    try:
        rng = np.random.RandomState(0)
        nb, d = 3, 32
        e = torch.tensor(rng.randn(nb, 2 * d, 2 * d).astype(np.float32))
        before = launches_of('embed_chain_fwd', 'embed_chain_bwd')
        for n in (100, 8192, 100):
            t = torch.tensor(rng.randn(nb, n, 2 * d).astype(np.float32))
            g = torch.zeros(n, 2 * d)
            cuda_embed.embed_forward(e, t)
            _, u = cuda_embed.embed_forward(e, t, save_residuals=True)
            cuda_embed.embed_backward(e, t, u, g)
        assert loads == ['embed_chain']
        assert props == [None]
        for fn in (lib.embed_chain_forward, lib.embed_chain_backward,
                   lib.embed_chain_error_string, lib.embed_chain_tile_rows):
            assert fn.configured == 1
        after = launches_of('embed_chain_fwd', 'embed_chain_bwd')
        assert (after[0] - before[0], after[1] - before[1]) == (6, 3)
        tiles = [args[-2] for args in lib.embed_chain_forward.calls]
        want = [cuda_embed.embed_geometry(n, d, H100_SMS).tile
                for n in (100, 100, 8192, 8192, 100, 100)]
        assert tiles == want
        assert [args[-3] for args in lib.embed_chain_backward.calls] == \
            want[::2]
        assert [args[-2] for args in lib.embed_chain_backward.calls] == [
            cuda_embed.ebar_splits(nb, n, 2 * d, H100_SMS)
            for n in (100, 8192, 100)]
    finally:
        cuda_embed._lib.cache_clear()
        cuda_hea.sm_count.cache_clear()
