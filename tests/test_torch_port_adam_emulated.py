"""
The one-launch Adam's CUDA source (quanonet_torch/csrc/adam.cu) run on the
CPU, through the port's own bindings (cuda_adam._bind / _launch: the
leaves' table, the gradients' column, the rate table and the count),
against its plain version (cuda_adam.adam_step_dense).

The source is compiled with the host's C++ compiler against
tests/cuda_emulation/cuda_runtime.h (each CUDA thread a user-level context,
the CTAs of a grid one after another, device memory host memory).  This
holds the table (the kernel's by-value argument), one CTA a chunk (15, 4
and a single CTA, which takes the ticket alone), a leaf without a gradient
skipped, the rate read from the
card's table with its clamp, the count advanced by exactly one a step
through the last CTA's ticket, and more leaves than a binding takes.  What
it cannot hold (timing, memory ordering) is left to the cuda-marked tests
on the card.

Tolerances as on the card (chip_smoke.py): atol 2e-6, rtol 1e-5 (the
kernel and the plain version round their multiply-adds in other orders).
"""
import os

import numpy as np
import pytest
import torch

import emulated_cuda
from quanonet_torch.ops import _build, cuda_adam

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(REPO), 'quanonet_torch', 'csrc',
                      'adam.cu')
ATOL, RTOL = 2e-6, 1e-5
# the flagship's leaves (2,401 parameters, 13 chunks of 256), a ragged leaf
SHAPES = [(120, 3, 5), (), (200,), (200,), (100,), (100,), (257,)]


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    return cuda_adam.declare(emulated_cuda.build(
        SOURCE, (), tmp_path_factory.mktemp('adam_emulation')))


@pytest.fixture
def cpu_binding(lib, monkeypatch):
    """cuda_adam's binding on CPU tensors, through the emulated library."""
    monkeypatch.setattr(cuda_adam, '_lib', lambda: lib)
    monkeypatch.setattr(cuda_adam, '_stream', lambda dev: None)
    monkeypatch.setattr(_build, 'on_device', lambda dev, fn: fn())


def _leaves(seed, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    return [torch.tensor(np.asarray(rng.randn(*s), np.float32))
            for s in shapes]


@pytest.mark.parametrize("shapes,grid", [(SHAPES, 15),
                                         ([(300,), (), (200,)], 4),
                                         ([(3, 5)], 1)],
                         ids=['cta-a-chunk', 'four-ctas', 'one-cta'])
def test_kernel_matches_plain(cpu_binding, shapes, grid):
    """Six steps at the rates of a two-entry table (the clamp holds the
    last from update 2 on), fresh gradients every step, the second leaf
    (where there is one) without a gradient at steps 3 and 4: the kernel's
    p, m, v against adam_step_dense; the count reads the number of launches
    after each, the ticket 0."""
    p, m, v = _leaves(0, shapes), [torch.zeros(s) for s in shapes], \
        [torch.zeros(s) for s in shapes]
    pw = [a.clone() for a in p]
    mw, vw = [a.clone() for a in m], [a.clone() for a in v]
    binding = cuda_adam._Binding(p, m, v, 0.9, 0.999, 1e-8)
    assert binding.grid() == grid
    rates = torch.tensor([1e-2, 3e-3], dtype=torch.float32)
    count = torch.zeros(2, dtype=torch.int32)
    before = cuda_adam.launches
    for t in range(1, 7):
        g = _leaves(100 + t, shapes)
        skip = t in (3, 4)
        binding.set_grads([0 if skip and i == 1 else a.data_ptr()
                           for i, a in enumerate(g)])
        cuda_adam._launch([binding], rates, count)
        assert count.tolist() == [t, 0]
        live = [i for i in range(len(shapes)) if not (skip and i == 1)]
        cuda_adam.adam_step_dense(
            [pw[i] for i in live], [g[i] for i in live], [mw[i] for i in live],
            [vw[i] for i in live], float(rates[min(t - 1, 1)]), t)
    assert cuda_adam.launches == before + 6
    for got, want in zip(p + m + v, pw + mw + vw):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_count_is_read_from_the_card(cpu_binding):
    """A count set on the card (as a resumed state sets it) is the update
    number the kernel takes: two launches from count 9 equal updates 10 and
    11 of the plain version at the table's clamped rate."""
    p, g = _leaves(1), _leaves(2)
    m, v = [torch.full(s, 0.1) for s in SHAPES], [torch.full(s, 0.2)
                                                  for s in SHAPES]
    pw, mw, vw = ([a.clone() for a in xs] for xs in (p, m, v))
    binding = cuda_adam._Binding(p, m, v, 0.9, 0.999, 1e-8)
    binding.set_grads([a.data_ptr() for a in g])
    rates = torch.tensor([5e-3], dtype=torch.float32)
    count = torch.tensor([9, 0], dtype=torch.int32)
    for t in (10, 11):
        cuda_adam._launch([binding], rates, count)
        cuda_adam.adam_step_dense(pw, g, mw, vw, float(rates[0]), t)
    assert int(count[0]) == 11
    for got, want in zip(p + m + v, pw + mw + vw):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_more_leaves_than_a_binding(cpu_binding):
    """70 leaves take two bindings (64 + 6), launched in turn: every leaf
    moves as the plain version moves it, and the count advances once."""
    rng = np.random.RandomState(3)
    p = [torch.tensor(rng.randn(5).astype(np.float32)) for _ in range(70)]
    g = [torch.tensor(rng.randn(5).astype(np.float32)) for _ in range(70)]
    m, v = [torch.zeros(5) for _ in p], [torch.zeros(5) for _ in p]
    pw, mw, vw = ([a.clone() for a in xs] for xs in (p, m, v))
    bindings = cuda_adam._bind(p, m, v, 0.9, 0.999, 1e-8)
    assert [b.grid() for b in bindings] == [64, 6]
    for s, b in zip((0, 64), bindings):
        b.set_grads([a.data_ptr() for a in g[s:s + 64]])
    count = torch.tensor([4, 0], dtype=torch.int32)
    before = cuda_adam.launches
    cuda_adam._launch(bindings, torch.tensor([1e-2]), count)
    assert cuda_adam.launches == before + 2 and count.tolist() == [5, 0]
    cuda_adam.adam_step_dense(pw, g, mw, vw, float(np.float32(1e-2)), 5)
    for got, want in zip(p + m + v, pw + mw + vw):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_bind_refuses_what_it_cannot_take(lib):
    """adam_bind refuses a leaf of no element (FusedAdam leaves those out),
    a binding of no leaf and more leaves than a binding takes."""
    import ctypes
    a = torch.zeros(4)
    ptrs = (ctypes.c_void_p * 65)(*[a.data_ptr()] * 65)
    handle = ctypes.c_void_p()
    for size, leaves in ((0, 1), (4, 0), (4, 65)):
        sizes = (ctypes.c_longlong * 65)(*[size] * 65)
        assert lib.adam_bind(ptrs, ptrs, ptrs, sizes, leaves, 0.9, 0.999,
                             1e-8, ctypes.byref(handle)) != 0
        assert handle.value is None
