"""
Adam with a one-launch update, through the hand-written CUDA kernel
``csrc/adam.cu`` (counterpart of quanonet_tpu/ops/pallas_adam.py, whose
``_adam_kernel`` it replaces).

The update rule is optax.adam's (b1 = 0.9, b2 = 0.999, eps = 1e-8,
eps_root = 0): the two moment averages, the bias correction taken as
1 − exp(t·log b) in fp32, the denominator √v̂ + eps.  One launch updates
the parameters and both moments of **every leaf, in place** (the JAX
module returns new trees; here nothing is reallocated), the 0-d ``bias``
leaf included.

The learning rate and the update count live on the card, as the JAX
kernel takes them from a (1, 2) operand.  :class:`FusedAdam` evaluates its
rate once, at ``init``, into a table of ``total_steps`` fp32 entries (the
schedule in Python float64 at the count before the increment, as optax
evaluates it; a constant rate is a table of one), and keeps the count in a
device int: the kernel takes t = count + 1 and lr = table[min(count,
len − 1)] and advances the count by one.  ``count`` is the host's mirror
of it, never read back per step; :meth:`FusedAdam.state_dict` reads the
device count once and raises if the two differ.  A schedule stepped past
its table raises before the launch.

The parameters and moments are bound once, at ``init``, into a table
that the kernel's C side keeps (a handle, MAX_LEAVES leaves each, handed
to every launch by value); a step writes the gradients' column again only
when some ``.grad`` has moved (the caching allocator usually hands the
same blocks back), and checks the gradients only then.

Opt-in: nothing in ``solver``, ``cli`` or ``bench`` constructs it
(``python -m quanonet_torch.profile_step --fused_adam`` asks for it; the
rule for making it the solver's ``adam`` on ``cuda`` is in ROADMAP §B.2).
It has the interface the training loop uses (``zero_grad``, ``step``,
``count``, ``state_dict``/``load_state_dict``), so
``solver.make_train_epoch`` and ``save_train_state`` take it as they take
a ``ScheduledOptimizer``; ``load_state_dict`` also takes
``torch.optim.Adam``'s layout, and ``ScheduledOptimizer`` takes this
one's.

CPU leaves take the plain version :func:`adam_step_dense`, with the same
table and count; CUDA leaves launch the kernel or raise.
"""
import ctypes
import weakref
from functools import lru_cache

import numpy as np
import torch

from quanonet_torch import tracing
from quanonet_torch.ops import _build

KERNEL = 'adam'
MAX_LEAVES = 64   # leaves of one binding, as kMaxLeaves in csrc/adam.cu

_VP, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


@lru_cache(maxsize=None)
def _lib():
    return declare(_build.load(KERNEL))


def declare(lib):
    """The C interface of csrc/adam.cu on a loaded library ``lib``."""
    lib.adam_max_leaves.argtypes = []
    lib.adam_max_leaves.restype = _I
    if lib.adam_max_leaves() != MAX_LEAVES:
        raise RuntimeError(f"csrc/adam.cu binds {lib.adam_max_leaves()} "
                           f"leaves, cuda_adam.MAX_LEAVES {MAX_LEAVES}")
    lib.adam_bind.argtypes = ([_VP] * 4 + [_I] + [_D] * 3
                              + [ctypes.POINTER(_VP)])
    lib.adam_bind.restype = _I
    lib.adam_set_grads.argtypes = [_VP] * 2
    lib.adam_set_grads.restype = None
    lib.adam_step.argtypes = [_VP, _VP, _I, _VP, _I, _VP]
    lib.adam_step.restype = _I
    lib.adam_grid.argtypes = [_VP]
    lib.adam_grid.restype = _I
    lib.adam_free.argtypes = [_VP]
    lib.adam_free.restype = None
    lib.adam_error_string.argtypes = [_I]
    lib.adam_error_string.restype = ctypes.c_char_p
    return lib


def adam_step_dense(params, grads, mus, nus, lr, t, b1=0.9, b2=0.999,
                    eps=1e-8):
    """Plain PyTorch Adam update number ``t`` (>= 1) at rate ``lr``, in
    place on each leaf of ``params``, ``mus`` and ``nus``.  The plain
    version of the CUDA kernel."""
    # 1 − exp(t·log b) in fp32, as the kernel takes it
    c1, c2 = (float(np.float32(1) - np.exp(np.float32(t) * np.float32(np.log(b))))
              for b in (b1, b2))
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mus, nus):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(lr * ((m / c1) / ((v / c2).sqrt() + eps)))


def _check(name, i, a, like, dev):
    if a.dtype != torch.float32:
        raise TypeError(f"{name} {i} must be float32, got {a.dtype}")
    if a.device != dev:
        raise ValueError(f"{name} {i} is on {a.device}, the first parameter "
                         f"on {dev}")
    if not a.is_contiguous():
        raise ValueError(f"{name} {i} must be contiguous")
    if a.shape != like.shape:
        raise ValueError(f"{name} {i} has shape {tuple(a.shape)}, its "
                         f"parameter {tuple(like.shape)}")


def _check_leaves(params, grads, mus, nus):
    dev = params[0].device
    for i, leaves in enumerate(zip(params, grads, mus, nus)):
        for name, a in zip(('parameter', 'gradient', 'mu', 'nu'), leaves):
            _check(name, i, a, leaves[0], dev)
    return dev


def _stream(dev):
    """The current stream's handle, read without building a Stream object
    (a step's largest host cost after the launch)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.adam_error_string(err).decode()} "
                           f"(cudaError {err})")


def _pointers(tensors):
    return (_VP * len(tensors))(*(t.data_ptr() for t in tensors))


class _Binding:
    """The kernel's table over up to MAX_LEAVES CUDA leaves (p, m, v, each
    contiguous fp32 with at least one element), kept by the library and
    handed to each launch by value; freed with this object."""

    def __init__(self, params, mus, nus, b1, b2, eps):
        lib = self.lib = _lib()
        n = len(params)
        self.dev = params[0].device
        sizes = (ctypes.c_longlong * n)(*(p.numel() for p in params))
        handle = _VP()
        err = lib.adam_bind(_pointers(params), _pointers(mus),
                            _pointers(nus), sizes, n, b1, b2, eps,
                            ctypes.byref(handle))
        _raise_on(lib, err, 'adam_bind')
        self.handle = handle.value
        weakref.finalize(self, lib.adam_free, self.handle)

    def set_grads(self, ptrs):
        """The gradients' column: one device pointer a leaf, 0 for none."""
        self.lib.adam_set_grads(self.handle,
                                (_VP * len(ptrs))(*(p or None for p in ptrs)))

    def step(self, lr_table, count, advance=True):
        """One launch: rate lr_table[min(c, len − 1)], update number c + 1,
        c = count[0]; with ``advance``, adds one to c.  lr_table and count
        (two device ints: c and the kernel's ticket) as (pointer, length)
        and pointer, which do not move."""
        err = _build.on_device(self.dev, lambda: self.lib.adam_step(
            self.handle, *lr_table, count, advance, _stream(self.dev)))
        _raise_on(self.lib, err, 'adam_step launch')
        tracing.count('adam_step')

    def grid(self):
        return self.lib.adam_grid(self.handle)


def _bind(params, mus, nus, b1, b2, eps):
    """Bindings over the leaves, MAX_LEAVES a binding."""
    return [_Binding(params[s:s + MAX_LEAVES], mus[s:s + MAX_LEAVES],
                     nus[s:s + MAX_LEAVES], b1, b2, eps)
            for s in range(0, len(params), MAX_LEAVES)]


def _launch(bindings, lr_table, count):
    """One update through every binding (lr_table and count tensors); the
    last launch advances the count (the earlier ones run before it on the
    stream)."""
    rates = (lr_table.data_ptr(), lr_table.numel())
    for i, b in enumerate(bindings):
        b.step(rates, count.data_ptr(), advance=i == len(bindings) - 1)


def adam_step(params, grads, mus, nus, lr, t, b1=0.9, b2=0.999, eps=1e-8):
    """The kernel on CUDA leaves: update number ``t`` at rate ``lr``, in
    place on ``params``, ``mus`` and ``nus``, through a binding made for
    this call (a table of one rate, a count of t − 1); one launch a
    MAX_LEAVES leaves.  Training binds once instead (:class:`FusedAdam`)."""
    leaves = [ls for ls in zip(params, grads, mus, nus) if ls[0].numel()]
    if not leaves:
        return
    dev = _check_leaves(*zip(*leaves))
    if dev.type != 'cuda':
        raise ValueError(f"adam_step launches the kernel and takes CUDA "
                         f"leaves, got {dev}; adam_step_dense is the plain "
                         f"version")
    p, g, m, v = zip(*leaves)
    bindings = _bind(p, m, v, b1, b2, eps)
    for s, b in zip(range(0, len(g), MAX_LEAVES), bindings):
        b.set_grads([a.data_ptr() for a in g[s:s + MAX_LEAVES]])
    _launch(bindings, torch.tensor([lr], dtype=torch.float32, device=dev),
            torch.tensor([t - 1, 0], dtype=torch.int32, device=dev))


class FusedAdam:
    """Adam whose step is one kernel launch over every leaf.

    ``FusedAdam(learning_rate, total_steps=T).init(params)`` binds the
    parameters, makes zero moments, the rate table (T entries of a
    schedule; one of a constant rate, where T may be omitted) and the
    device count; then ``zero_grad()`` / ``step()`` as a ``torch.optim``
    optimizer, ``count`` the number of updates made.  ``step`` updates the
    parameters and the moments **in place**; a parameter whose ``.grad``
    is None is skipped, as ``torch.optim`` skips it; a gradient that is not
    contiguous fp32 of its parameter's shape raises."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 total_steps=None):
        if callable(learning_rate) and (total_steps is None
                                        or total_steps < 1):
            raise ValueError(f"a schedule needs total_steps >= 1 (the "
                             f"rate table's length), got {total_steps}")
        self.learning_rate = learning_rate
        self.total_steps = total_steps
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)
        self.count = 0
        self.params, self.mu, self.nu = [], [], []

    def init(self, params):
        self.params = list(params)
        dev = self.params[0].device
        for i, p in enumerate(self.params):
            _check('parameter', i, p, p, dev)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        rates = ([self.learning_rate(t) for t in range(self.total_steps)]
                 if callable(self.learning_rate) else [self.learning_rate])
        self.lr_table = torch.tensor(
            np.asarray(rates, np.float64).astype(np.float32), device=dev)
        # [the updates made, the kernel's ticket]
        self.device_count = torch.zeros(2, dtype=torch.int32, device=dev)
        self.count = 0
        self._live = [i for i, p in enumerate(self.params) if p.numel()]
        self._live_params = [self.params[i] for i in self._live]
        self._bindings = (_bind(*([getattr(self, k)[i] for i in self._live]
                                  for k in ('params', 'mu', 'nu')),
                                self.b1, self.b2, self.eps)
                          if dev.type == 'cuda' and self._live else [])
        self._schedule_len = (self.lr_table.numel()
                              if callable(self.learning_rate) else None)
        self._grad_ptrs = None
        return self

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _bind_grads(self, grads, ptrs):
        """Checks the gradients that moved and binds their column."""
        for i, g in zip(self._live, grads):
            if g is not None:
                _check('gradient', i, g, self.params[i],
                       self.params[i].device)
        for s, b in zip(range(0, len(ptrs), MAX_LEAVES), self._bindings):
            b.set_grads(ptrs[s:s + MAX_LEAVES])
        self._grad_ptrs = ptrs

    def step(self):
        if self._schedule_len is not None and self.count >= self._schedule_len:
            raise RuntimeError(
                f"update {self.count + 1} is past the schedule's table of "
                f"{self._schedule_len} (total_steps)")
        grads = [p.grad for p in self._live_params]
        ptrs = tuple([0 if g is None else g.data_ptr() for g in grads])
        if ptrs != self._grad_ptrs:
            self._bind_grads(grads, ptrs)
        if self._bindings:
            _launch(self._bindings, self.lr_table, self.device_count)
        else:   # CPU leaves (or none with an element): the plain version
            c = int(self.device_count[0])
            lr = float(self.lr_table[min(c, self.lr_table.numel() - 1)])
            live = [(self.params[i].detach(), g, self.mu[i], self.nu[i])
                    for i, g in zip(self._live, grads) if g is not None]
            if live:
                adam_step_dense(*zip(*live), lr, c + 1, self.b1, self.b2,
                                self.eps)
            self.device_count[0] += 1
        self.count += 1

    def state_dict(self):
        """{'count', 'state': {i: {'mu', 'nu'}}}, i in parameter order;
        reads the device count once and raises if it is not the host's."""
        on_device = int(self.device_count[0])
        if on_device != self.count:
            raise RuntimeError(f"the device count reads {on_device}, the "
                               f"host's mirror {self.count}")
        return {'count': self.count,
                'state': {i: {'mu': m, 'nu': v}
                          for i, (m, v) in enumerate(zip(self.mu, self.nu))}}

    def load_state_dict(self, sd):
        """Copies the moments in place from :meth:`state_dict`'s layout
        ('mu', 'nu') or ``torch.optim.Adam``'s ('exp_avg', 'exp_avg_sq';
        a parameter without an entry, never updated there, gets zero
        moments); the count is ``sd['count']``."""
        with torch.no_grad():
            for i, (m, v) in enumerate(zip(self.mu, self.nu)):
                st = sd['state'].get(i, {})
                if 'exp_avg' in st:
                    st = {'mu': st['exp_avg'], 'nu': st['exp_avg_sq']}
                for dst, key in ((m, 'mu'), (v, 'nu')):
                    if key in st:
                        dst.copy_(torch.as_tensor(st[key]))
                    else:
                        dst.zero_()
        self.count = int(sd['count'])
        self.device_count.copy_(torch.tensor([self.count, 0],
                                             dtype=torch.int32))


def fused_adam(learning_rate, **kw):
    return FusedAdam(learning_rate, **kw)
