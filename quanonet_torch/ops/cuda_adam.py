"""
Adam with a one-launch update, through the hand-written CUDA kernel
``csrc/adam.cu`` (counterpart of quanonet_tpu/ops/pallas_adam.py, whose
``_adam_kernel`` it replaces).

The update rule is optax.adam's (b1 = 0.9, b2 = 0.999, eps = 1e-8,
eps_root = 0): the two moment averages, the bias correction taken as
1 − exp(t·log b) in fp32, the denominator √v̂ + eps.  One launch updates
the parameters and both moments of **every leaf, in place** (the JAX
module returns new trees; here nothing is reallocated), the 0-d ``bias``
leaf included.  The learning rate is a float or a schedule, evaluated at
the count before the increment, as optax evaluates it.

Off by default, as in the JAX package: nothing constructs
:class:`FusedAdam` unless asked (``solver.build_optimizer`` builds
``torch.optim`` optimizers; ``python -m quanonet_torch.profile_step
--fused_adam`` asks).  It has the interface the training loop uses
(``zero_grad``, ``step``, ``count``, ``state_dict``/``load_state_dict``),
so ``solver.make_train_epoch`` and ``save_train_state`` take it as they
take a ``ScheduledOptimizer``.

CPU leaves take the plain version :func:`adam_step_dense`; CUDA leaves
launch the kernel or raise.
"""
import ctypes
from functools import lru_cache

import numpy as np
import torch

from quanonet_torch.ops import _build

KERNEL = 'adam'
MAX_LEAVES = 64   # leaves of one launch, as in csrc/adam.cu

# Launches of the kernel since import.
launches = 0

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@lru_cache(maxsize=None)
def _lib():
    lib = _build.load(KERNEL)
    lib.adam_step.argtypes = [_VP] * 5 + [_I] + [_F] * 9 + [_VP]
    lib.adam_step.restype = _I
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


def _check_leaves(params, grads, mus, nus):
    dev = params[0].device
    for i, leaves in enumerate(zip(params, grads, mus, nus)):
        for name, a in zip(('parameter', 'gradient', 'mu', 'nu'), leaves):
            if a.dtype != torch.float32:
                raise TypeError(f"{name} {i} must be float32, got {a.dtype}")
            if a.device != dev:
                raise ValueError(f"{name} {i} is on {a.device}, the first "
                                 f"parameter on {dev}")
            if not a.is_contiguous():
                raise ValueError(f"{name} {i} must be contiguous")
            if a.shape != leaves[0].shape:
                raise ValueError(f"{name} {i} has shape {tuple(a.shape)}, "
                                 f"its parameter {tuple(leaves[0].shape)}")
    return dev


def adam_step(params, grads, mus, nus, lr, t, b1=0.9, b2=0.999, eps=1e-8):
    """The kernel on CUDA leaves: update number ``t`` at rate ``lr``, in
    place on ``params``, ``mus`` and ``nus``; one launch per MAX_LEAVES
    leaves."""
    global launches
    leaves = [ls for ls in zip(params, grads, mus, nus) if ls[0].numel()]
    if not leaves:
        return
    dev = _check_leaves(*zip(*leaves))
    if dev.type != 'cuda':
        raise ValueError(f"adam_step launches the kernel and takes CUDA "
                         f"leaves, got {dev}; adam_step_dense is the plain "
                         f"version")
    lib = _lib()
    scalars = (float(lr), float(t), b1, b2, 1.0 - b1, 1.0 - b2,
               float(np.log(b1)), float(np.log(b2)), eps)
    with torch.cuda.device(dev):
        for s in range(0, len(leaves), MAX_LEAVES):
            chunk = leaves[s:s + MAX_LEAVES]
            n = len(chunk)
            ptrs = [(ctypes.c_void_p * n)(*(ls[k].data_ptr() for ls in chunk))
                    for k in range(4)]
            sizes = (ctypes.c_longlong * n)(*(ls[0].numel() for ls in chunk))
            err = lib.adam_step(*ptrs, sizes, n, *scalars,
                                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(
                    f"adam_step launch failed: "
                    f"{lib.adam_error_string(err).decode()} (cudaError {err})")
            launches += 1


class FusedAdam:
    """Adam whose step is one kernel launch over every leaf.

    ``FusedAdam(learning_rate).init(params)`` binds the parameters and
    makes zero moments; then ``zero_grad()`` / ``step()`` as a
    ``torch.optim`` optimizer, ``count`` the number of updates made.
    ``step`` updates the parameters and the moments **in place**; a
    parameter whose ``.grad`` is None is skipped, as ``torch.optim`` skips
    it; a gradient that is not contiguous raises."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)
        self.count = 0
        self.params, self.mu, self.nu = [], [], []

    def init(self, params):
        self.params = list(params)
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in self.params]
        self.nu = [torch.zeros_like(m) for m in self.mu]
        self.count = 0
        return self

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        lr = (self.learning_rate(self.count) if callable(self.learning_rate)
              else self.learning_rate)
        live = [(p.detach(), p.grad, m, v)
                for p, m, v in zip(self.params, self.mu, self.nu)
                if p.grad is not None]
        self.count += 1
        if not live:
            return
        dev = _check_leaves(*zip(*live))
        update = adam_step_dense if dev.type == 'cpu' else adam_step
        update(*zip(*live), lr, self.count, self.b1, self.b2, self.eps)

    def state_dict(self):
        """{'count', 'state': {i: {'mu', 'nu'}}}, i in parameter order."""
        return {'count': self.count,
                'state': {i: {'mu': m, 'nu': v}
                          for i, (m, v) in enumerate(zip(self.mu, self.nu))}}

    def load_state_dict(self, sd):
        """Copies the moments of :meth:`state_dict`'s layout in place."""
        with torch.no_grad():
            for i, (m, v) in enumerate(zip(self.mu, self.nu)):
                m.copy_(torch.as_tensor(sd['state'][i]['mu']))
                v.copy_(torch.as_tensor(sd['state'][i]['nu']))
        self.count = int(sd['count'])


def fused_adam(learning_rate, **kw):
    return FusedAdam(learning_rate, **kw)
