"""
The training loop of the port (counterpart of quanonet_tpu/solver.py), for
the quantum models and the classical baselines (FNN, DeepONet, FNO).

PyTorch runs eagerly, so the JAX package's jitted scans become plain
loops: an epoch is a loop over shuffled, masked minibatches
(:func:`make_train_epoch`), a segment a loop over epochs with best-epoch
parameter tracking (:func:`make_run_segment`).  The loss of each step stays
on the card; the host reads one value per epoch.  Under autograd the
``pallas`` engine (up to 7 qubits) runs the CUDA block-chain kernels
forward and backward (ops/cuda_hea.BlockChain), the opt-in ``embed``
engine the real-embedding chain kernels (ops/cuda_embed.EmbedChain), the
``pfused`` engine (8..14 qubits) the fused-group chain kernels
(ops/cuda_fused.FusedChain);
evaluation runs under ``torch.inference_mode`` and takes the primal-only
forward kernels.  On ``cuda`` the block matrices come from the compile
kernels (ops/cuda_ucomp.py).

Contract kept from the JAX package: resume-skip on metric.json, best and
final checkpoints in both reference formats (.npz + MindSpore .ckpt),
warm start via init_checkpoint, if_train / if_save / ckpt_path config
keys, per-epoch Loss/train and Error/rel_l2 TensorBoard scalars, and the
elastic mid-run resume (--save_state) that continues bit-identically.

QPU-trainable gradients (ops/param_shift.py): ``--grad_method shift``
makes the circuit's gradient the parameter-shift rule, ``spsa`` replaces
``loss.backward()`` with the two-evaluation SPSA estimate (``--spsa_c``),
and ``--train_shots`` measures the loss, and the evaluation, with finite
shots; ``--ps_chunk`` bounds the shift rule's fan-out.  Noise-aware
training (ops/noise.py): ``--noise_p``, ``--readout_p``, ``--damp_gamma``
and ``--dephase_p`` make the forward the mean over ``--noise_traj``
trajectories of the channel (8 by default), drawn from the step's
generator; on ``cuda`` up to 7 qubits without damping each trajectory is
one chain launch on the shared compile (B1f and B1b a trajectory, B4f and
B4b a step).

Multi-GPU (parallel/, :class:`Solver`): ``--num_devices N`` trains
data-parallel over N ranks (parallel/dp_solver.py), ``--shard amp|pipe``
runs the model's expectation on the amplitude-sharded or the pipelined
engine; one process a rank over ``torch.distributed``.

The random streams are torch's, not JAX's: parameters are drawn from a
``torch.Generator`` seeded with the run seed, epoch e's permutation from
one seeded with (seed, e), and a sampled, noisy or SPSA step t from
generators seeded from (seed, t), so a resumed run replays them.
Training is held to the JAX package by outcome and, step by step, in the
tests (which hand both the same parameters and permutations).
"""
import logging
import math
import os
import sys
import time

import numpy as np
import torch

from quanonet_torch import checkpoint as ckpt_io
from quanonet_torch import resolve_device, tracing
from quanonet_torch.config import parse_bool
from quanonet_torch.convert import raw_from_state_dict, state_dict_from_raw
from quanonet_torch.data.manager import DataManager
from quanonet_torch.logger import ExperimentLogger, StreamToLogger, setup_logger
from quanonet_torch.metrics import compute_metrics, count_parameters, rel_l2
from quanonet_torch.ops.noise import is_noisy
from quanonet_torch.ops.param_shift import make_spsa_step
from quanonet_torch.ops.sampling import derive_seed, key_generator
from quanonet_torch.parallel import comm, launch

QUANTUM_MODELS = ('QuanONet', 'HEAQNN')
CLASSICAL_MODELS = ('DeepONet', 'FNN', 'FNO')


def _segment_size(epochs, cap=64):
    """Epochs per segment (between host checkpoints and state snapshots):
    the largest divisor of ``epochs`` <= cap when it is at least half of
    cap's bound, else ``cap`` with a ragged tail (the JAX package's rule,
    which kept its compiled program shapes few)."""
    hi = min(cap, epochs)
    for s in range(hi, 0, -1):
        if epochs % s == 0:
            if s >= (hi + 1) // 2:
                return s
            break
    return hi


def _check_model_type(model_type):
    if model_type not in QUANTUM_MODELS + CLASSICAL_MODELS:
        raise ValueError(f"Unknown model type: {model_type}")


def _build_classical(config, data, device, generator):
    """FNN / DeepONet / FNO with the JAX package's net-size defaults."""
    from quanonet_torch.models import (
        FNN, FNO, DeepONet, deeponet_layer_sizes, fno_sizes,
    )
    model_type = config['model_type']
    net_size = config.get('net_size')
    noise = [k for k in ('noise_p', 'readout_p', 'damp_gamma', 'dephase_p',
                         'train_shots') if config.get(k)]
    if noise or str(config.get('grad_method') or 'autodiff') != 'autodiff':
        raise ValueError(
            f"--noise_p/--readout_p/--damp_gamma/--dephase_p/--grad_method/"
            f"--train_shots apply to quantum models only, not {model_type}")
    kw = dict(device=device, generator=generator)
    if model_type == 'DeepONet':
        branch_in = data['train_branch_input'].shape[1]
        trunk_in = data['train_trunk_input'].shape[1]
        bl, tl = deeponet_layer_sizes(net_size, branch_in, trunk_in)
        return DeepONet(branch_in, trunk_in, bl, tl, **kw), 'tuple'
    if model_type == 'FNN':
        return FNN(data['train_input'].shape[1],
                   tuple(net_size or (3, 20)), **kw), 'single'
    return FNO(data['train_input'].shape[-1], **fno_sizes(net_size),
               **kw), 'single'


def build_model(config, data, device=None, generator=None):
    """Model factory (reference solver_ms.py:91-147).  Returns (module,
    input mode): 'tuple' (branch, trunk) or 'single' (one array)."""
    from quanonet_torch.models import HEAQNN, QuanONet
    model_type = config['model_type']
    _check_model_type(model_type)
    gm = str(config.get('grad_method') or 'autodiff')
    if gm not in ('autodiff', 'shift', 'spsa'):
        raise ValueError(f"unknown grad_method {gm!r}")
    train_shots = config.get('train_shots')
    if train_shots and gm == 'autodiff':
        raise ValueError("--train_shots needs --grad_method shift or spsa "
                         "(autodiff cannot differentiate sampling)")
    if model_type in CLASSICAL_MODELS:
        return _build_classical(config, data, device, generator)
    net_size = config.get('net_size')
    ham_diag = config.get('ham_diag')
    # noise-aware training (ops/noise.py): the forward is the trajectory
    # mean under the channel; 8 trajectories by default in training (the
    # gradient averages over them and the batch), 32 at inference
    noise = {}
    if is_noisy(config.get('noise_p'), config.get('readout_p'),
                config.get('damp_gamma'), config.get('dephase_p')):
        noise = dict(
            noise_p=(float(config['noise_p'])
                     if config.get('noise_p') is not None else None),
            noise_traj=int(config.get('noise_traj') or 8),
            readout_p=float(config.get('readout_p') or 0.0),
            damp_gamma=(float(config['damp_gamma'])
                        if config.get('damp_gamma') else None),
            dephase_p=(float(config['dephase_p'])
                       if config.get('dephase_p') else None))
    # QPU-trainable gradients (ops/param_shift.py): the shift rule as the
    # circuit's gradient, and finite shots in the training loss
    qpu = dict(shots=int(train_shots) if train_shots else None,
               grad_method='shift' if gm == 'shift' else 'autodiff',
               ps_chunk=(int(config['ps_chunk'])
                         if gm == 'shift' and config.get('ps_chunk')
                         else None))
    kw = dict(num_qubits=config['num_qubits'],
              scale_coeff=config.get('scale_coeff', 0.01),
              if_trainable_freq=parse_bool(
                  config.get('if_trainable_freq', 'true')),
              ham_bound=tuple(config.get('ham_bound') or (-5.0, 5.0)),
              ham_diag=tuple(ham_diag) if ham_diag is not None else None,
              ham_pauli=config.get('ham_pauli', 'Z'),
              engine=config.get('engine', 'auto'), device=device,
              generator=generator, **qpu, **noise)
    if model_type == 'QuanONet':
        return QuanONet(branch_input_size=data['train_branch_input'].shape[1],
                        trunk_input_size=data['train_trunk_input'].shape[1],
                        net_size=tuple(net_size or (20, 2, 10, 2)),
                        **kw), 'tuple'
    return HEAQNN(input_size=data['train_input'].shape[1],
                  net_size=tuple(net_size or (20, 2)), **kw), 'single'


def _decay_tuple_schedule(lr, decay, total_steps):
    """DeepXDE-style ``decay`` tuple vocabulary (reference
    solvers/solver_dde.py:214-271):

    ('step', decay_steps, gamma)          lr · γ^⌊t/steps⌋
    ('exponential', decay_steps, gamma)   lr · γ^(t/steps)   (smooth)
    ('inverse time', decay_steps, gamma)  lr / (1 + γ·t/steps)
    ('cosine', T_max, alpha)              cosine from lr to α·lr over T_max
    """
    name = str(decay[0]).lower().replace('_', ' ')
    if name == 'step':
        steps, gamma = int(decay[1]), float(decay[2])
        return lambda t: lr * gamma ** (t // steps)
    if name == 'exponential':
        steps, gamma = float(decay[1]), float(decay[2])
        return lambda t: lr * gamma ** (t / steps)
    if name == 'inverse time':
        steps, gamma = float(decay[1]), float(decay[2])
        return lambda t: lr / (1.0 + gamma * t / steps)
    if name == 'cosine':
        t_max = float(decay[1]) if len(decay) > 1 else float(total_steps)
        alpha = float(decay[2]) if len(decay) > 2 else 0.0
        floor = alpha * lr
        return lambda t: (floor + 0.5 * (lr - floor)
                          * (1 + math.cos(math.pi * min(t, t_max) / t_max)))
    raise ValueError(
        f"unknown decay form '{decay[0]}' (expected one of step/"
        f"exponential/'inverse time'/cosine, solver_dde.py:239-245)")


def build_schedule(config, total_steps):
    """Learning rate as a function of the update count t (reference
    solver_ms.py:150-180), the schedules of the JAX package's
    ``build_optimizer``."""
    lr = config['learning_rate']
    sched = str(config.get('lr_scheduler', 'none')).lower()
    sched_kw = config.get('lr_scheduler_kwargs', {}) or {}
    decay = config.get('decay')
    if decay:
        return _decay_tuple_schedule(lr, decay, total_steps)
    if sched in ('inverse time', 'inverse_time'):
        steps = sched_kw.get('decay_steps', sched_kw.get('step_size', 1000))
        gamma = sched_kw.get('gamma', 0.9)
        return _decay_tuple_schedule(lr, ('inverse time', steps, gamma),
                                     total_steps)
    if sched == 'cosine':
        eta_min = sched_kw.get('eta_min', 0.0)
        return lambda t: (eta_min + 0.5 * (lr - eta_min)
                          * (1 + math.cos(math.pi * t / total_steps)))
    if sched == 'exponential':
        gamma = sched_kw.get('gamma', 0.99)
        return lambda t: lr * gamma ** t
    if sched == 'step':
        step_size = sched_kw.get('step_size', 100)
        gamma = sched_kw.get('gamma', 0.5)
        return lambda t: lr * gamma ** (t // step_size)
    return lambda t: lr


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer whose learning rate is ``schedule(t)``
    at each update, t the number of updates before it: optax evaluates its
    schedule at the count before the increment, and so does this (a
    ``LambdaLR`` stepped after every update, with absolute rates)."""

    def __init__(self, optimizer, schedule):
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = 0

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self):
        """{'count', 'state': {i: {name: tensor}}}: the update count and
        the torch optimizer's per-parameter state."""
        return {'count': self.count,
                'state': self.optimizer.state_dict()['state']}

    def load_state_dict(self, sd):
        """The torch optimizer's per-parameter state; into
        ``torch.optim.Adam``, also the one-launch Adam's ('mu', 'nu' a
        parameter), carried over to its layout with every parameter at
        step ``sd['count']``."""
        state = sd['state']
        if isinstance(self.optimizer, torch.optim.Adam) and any(
                'mu' in st and 'exp_avg' not in st for st in state.values()):
            step = torch.tensor(float(sd['count']), dtype=torch.float32)
            state = {i: {'step': step.clone(), 'exp_avg': st['mu'],
                         'exp_avg_sq': st['nu']} for i, st in state.items()}
        inner = self.optimizer.state_dict()
        inner['state'] = state
        self.optimizer.load_state_dict(inner)
        self.count = int(sd['count'])


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop's update rule (optax 0.2.6), which torch.optim.RMSprop
    does not give: epsilon inside the square root by default
    (``eps_in_sqrt``), g / sqrt(v + eps) where torch takes
    g / (sqrt(v) + eps), and the momentum trace taken over the
    learning-rate-scaled update, as optax's ``trace`` follows
    ``scale_by_learning_rate``.  Per step, with v and m starting at
    ``initial_scale`` and 0:

        v = decay v + (1 - decay) g^2;  centered: m = decay m + (1 - decay) g,
            v - m^2 in place of v below
        u = -lr g / sqrt(v + eps)      (eps_in_sqrt=False: sqrt(v) + eps)
        momentum: t = u + momentum t;  u = t (nesterov: u + momentum t)
        p = p + u
    """

    def __init__(self, params, lr=0.0, decay=0.9, eps=1e-8,
                 initial_scale=0.0, eps_in_sqrt=True, centered=False,
                 momentum=None, nesterov=False):
        super().__init__(params, dict(
            lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
            eps_in_sqrt=eps_in_sqrt, centered=centered,
            momentum=momentum, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, eps = group['decay'], group['eps']
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state['nu'] = torch.full_like(p, group['initial_scale'])
                    if group['centered']:
                        state['mu'] = torch.zeros_like(p)
                    if group['momentum'] is not None:
                        state['trace'] = torch.zeros_like(p)
                nu = state['nu']
                nu.copy_((1 - decay) * g * g + decay * nu)
                var = nu
                if group['centered']:
                    mu = state['mu']
                    mu.copy_((1 - decay) * g + decay * mu)
                    var = nu - mu * mu
                if group['eps_in_sqrt']:
                    u = torch.rsqrt(var + eps) * g
                else:
                    u = g / (torch.sqrt(var) + eps)
                u = -group['lr'] * u
                if group['momentum'] is not None:
                    trace = state['trace']
                    trace.copy_(u + group['momentum'] * trace)
                    u = (u + group['momentum'] * trace
                         if group['nesterov'] else trace)
                p.add_(u)
        return None


def _torch_optimizer(name, params, opt_kw):
    """optax optimizer name and keyword arguments -> the torch optimizer
    with the same update rule (optax's defaults where torch's differ:
    adamw's weight decay 1e-4; rmsprop is the port's own :class:`RMSprop`,
    since torch.optim.RMSprop puts epsilon outside the square root)."""
    kw = dict(opt_kw)
    if name in ('adam', 'adamw'):
        args = dict(lr=0.0, betas=(kw.pop('b1', 0.9), kw.pop('b2', 0.999)),
                    eps=kw.pop('eps', 1e-8))
        if kw.pop('eps_root', 0.0):
            raise ValueError("eps_root has no torch.optim counterpart")
        if name == 'adamw':
            args['weight_decay'] = kw.pop('weight_decay', 1e-4)
        cls = torch.optim.AdamW if name == 'adamw' else torch.optim.Adam
    elif name == 'sgd':
        args = dict(lr=0.0, momentum=kw.pop('momentum', None) or 0.0,
                    nesterov=kw.pop('nesterov', False))
        cls = torch.optim.SGD
    else:
        args = {k: kw.pop(k) for k in ('decay', 'eps', 'initial_scale',
                                        'eps_in_sqrt', 'centered',
                                        'momentum', 'nesterov') if k in kw}
        cls = RMSprop
    if kw:
        raise ValueError(f"optimizer_kwargs {sorted(kw)} have no "
                         f"torch.optim counterpart for {name}")
    return cls(params, **args)


def build_optimizer(config, total_steps, params):
    """torch.optim optimizer + LR schedule, the counterpart of the JAX
    package's ``build_optimizer`` (optax adam/adamw/sgd/rmsprop; an
    unknown name is adam, as there)."""
    name = str(config.get('optimizer', 'adam')).lower()
    if name not in ('adam', 'adamw', 'sgd', 'rmsprop'):
        name = 'adam'
    opt = _torch_optimizer(name, params, config.get('optimizer_kwargs') or {})
    return ScheduledOptimizer(opt, build_schedule(config, total_steps))


def padded_batches(perm, num_samples, batch_size):
    """The batches of the orders ``perm`` (..., num_samples) long: (idx
    (..., batches, batch_size), masks (batches, batch_size) float32).  The
    last batch wraps around to the order's start and its extra rows are
    masked out (solver_ms.py:219-245)."""
    num_batches = max(1, int(np.ceil(num_samples / batch_size)))
    padded = num_batches * batch_size
    idx = torch.cat([perm, perm[..., :padded - num_samples]], -1)
    masks = (torch.arange(padded, device=perm.device) < num_samples).to(
        torch.float32).reshape(num_batches, batch_size)
    return idx.reshape(*perm.shape[:-1], num_batches, batch_size), masks


def predict_chunks(model, inputs, batch_size, device, seed=None):
    """``model``'s predictions on the NumPy ``inputs``, (n, 1) NumPy, in
    chunks of max(batch_size, 4096) rows under inference mode (so the
    chain takes the primal-only kernel).  With ``seed`` (a model measured
    with shots or under a noise channel) chunk s draws from a generator
    seeded from (seed, s), as the JAX package keys it."""
    chunk = max(batch_size, 4096)
    n = inputs[0].shape[0]
    preds = []
    with torch.inference_mode():
        for s in range(0, n, chunk):
            batch = tuple(torch.as_tensor(a[s:s + chunk], device=device)
                          for a in inputs)
            kw = ({'generator': key_generator(seed, s, device=device)}
                  if seed is not None else {})
            preds.append(model(*batch, **kw).cpu().numpy())
    return np.concatenate(preds, axis=0)


def predict_chunks_sharded(model, inputs, batch_size, group, seed=None):
    """:func:`predict_chunks` with each chunk's rows shared over ``group``:
    the chunk padded to a multiple of the group's size by repeating its
    first rows, each rank predicting its contiguous share, the shares
    gathered back (the JAX package's sharded evaluation).  A sampled model
    draws chunk s of rank r from a generator seeded from (seed, s, r)."""
    chunk = max(batch_size, 4096)
    n, world = inputs[0].shape[0], group.world
    preds = []
    with torch.inference_mode():
        for s in range(0, n, chunk):
            real = min(chunk, n - s)
            rows = np.arange(real + (-real) % world) % real + s
            share = rows.size // world
            mine = rows[group.rank * share:(group.rank + 1) * share]
            batch = tuple(torch.as_tensor(a[mine], device=group.device)
                          for a in inputs)
            kw = ({'generator': key_generator(seed, s, group.rank,
                                              device=group.device)}
                  if seed is not None else {})
            out = comm.all_gather_rows(model(*batch, **kw), group)
            preds.append(out[:real].cpu().numpy())
    return np.concatenate(preds, axis=0)


def make_train_epoch(model, optimizer, num_samples, batch_size, per_sample,
                     seed=0, spsa_c=None):
    """One training epoch: ``train_epoch(perm, inputs, outputs, epoch=0) ->
    (avg_loss, sse)``, both 0-d float32 tensors on the outputs' device.
    ``optimizer`` is a :class:`ScheduledOptimizer` or anything else with
    its ``zero_grad``/``step`` pair over the model's parameters, such as
    the one-launch Adam ``ops/cuda_adam.FusedAdam`` (the counterpart of
    the JAX package's ``fused_step`` route).

    ``perm`` (num_samples,) orders the samples; the last batch wraps
    around and its extra rows are masked out, reproducing the reference's
    per-epoch averaging (solver_ms.py:219-245): each step's loss is
    sum(sq · mask) / max(sum(mask) · per_sample, 1).

    A model measured with shots or under a noise channel
    (``model.sampled``), or ``spsa_c`` (the SPSA estimator at that
    perturbation size in place of ``loss.backward()``), makes the step
    stochastic: step t = epoch · batches + b draws from generators seeded
    from (``seed``, t), the counterpart of the JAX package's per-step rngs,
    so a resumed run draws what the unbroken run drew: (seed, t, 0) the
    SPSA direction, (seed, t, 1) the model's shots and noise trajectories,
    the same for both SPSA evaluations (common random numbers).

    Tracing (quanonet_torch/tracing.py): each step is a ``solver.step``
    span, and on the autograd route its ``solver.forward`` (predictions and
    loss), ``solver.backward`` (the host's enqueue of the backward) and
    ``solver.optimizer`` (entered twice: ``zero_grad``, then ``step``)."""
    num_batches = max(1, int(np.ceil(num_samples / batch_size)))
    sampled = bool(getattr(model, 'sampled', False))
    params = dict(model.named_parameters())

    def batch_loss(pred, batch_out, mask):
        m = mask.reshape(mask.shape + (1,) * (pred.dim() - 1))
        sq = (pred - batch_out) ** 2 * m
        return sq.sum() / torch.clamp(mask.sum() * per_sample, min=1.0)

    def train_epoch(perm, inputs, outputs, epoch=0):
        dev = outputs.device
        idx, masks = padded_batches(
            torch.as_tensor(perm, dtype=torch.long, device=dev), num_samples,
            batch_size)
        losses = []
        for b in range(num_batches):
            with tracing.span('solver.step', rows=batch_size):
                bi = idx[b]
                batch_in, batch_out = tuple(a[bi] for a in inputs), outputs[bi]
                step = derive_seed(seed, epoch * num_batches + b)

                def predict(ps=None):
                    """The batch's predictions, with the tensors ``ps`` in
                    place of the model's parameters; a sampled model draws
                    the step's shots and noise."""
                    kw = ({'generator': key_generator(step, 1, device=dev)}
                          if sampled else {})
                    if ps is None:
                        return model(*batch_in, **kw)
                    return torch.func.functional_call(model, ps, batch_in,
                                                      kw)

                if spsa_c is not None:
                    loss = make_spsa_step(
                        lambda ps: batch_loss(predict(ps), batch_out,
                                              masks[b]),
                        optimizer, params, spsa_c)(
                            key_generator(step, 0, device=dev))
                else:
                    with tracing.span('solver.forward'):
                        loss = batch_loss(predict(), batch_out, masks[b])
                    with tracing.span('solver.optimizer'):
                        optimizer.zero_grad()
                    with tracing.span('solver.backward'):
                        loss.backward()
                    with tracing.span('solver.optimizer'):
                        optimizer.step()
                losses.append(loss.detach())
        losses = torch.stack(losses)
        # running rel-L2 from the accumulated SSE (solver_ms.py:240-245)
        return losses.mean(), (losses * masks.sum(1) * per_sample).sum()

    return train_epoch


def _clone(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def make_run_segment(train_epoch, model):
    """A multi-epoch segment with best-epoch parameter tracking:
    ``run_segment(best_loss, best_params, perms, inputs, outputs,
    first_epoch=0) -> (best_loss, best_params, [(avg_loss, sse) per
    epoch])``, one epoch per permutation; the epochs' indices in the run
    (first_epoch, first_epoch + 1, ...) are passed on to ``train_epoch``.
    best_params is a state_dict copy, replaced when an epoch's average
    loss is below best_loss.  Each epoch ends in a ``solver.epoch_end``
    span (the host read and the copy) around a ``solver.host_read`` span
    (the host's wait for the card), see quanonet_torch/tracing.py."""
    def run_segment(best_loss, best_params, perms, inputs, outputs,
                    first_epoch=0):
        hist = []
        for e, perm in enumerate(perms):
            avg, sse = train_epoch(perm, inputs, outputs, first_epoch + e)
            with tracing.span('solver.epoch_end'):
                with tracing.span('solver.host_read'):
                    # one host read per epoch: the wait for the card
                    avg, sse = avg.item(), sse.item()
                if avg < best_loss:
                    best_loss, best_params = avg, _clone(model)
            hist.append((avg, sse))
        return best_loss, best_params, hist
    return run_segment


def epoch_permutation(seed, epoch, n):
    """Epoch ``epoch``'s sample order for run ``seed``, on the CPU."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(epoch)])
    gen = torch.Generator().manual_seed(int(state.generate_state(1)[0]))
    return torch.randperm(n, generator=gen)


def save_checkpoint(params, ckpt_path, model_type):
    """Dual-format save of a state_dict (.ckpt MindSpore-compatible + .npz
    reference schema), mirroring solver_ms.py:256-263."""
    raw = raw_from_state_dict(params, model_type)
    ckpt_io.save_ms_ckpt(ckpt_path, raw)
    npz_path = ckpt_path.replace('.ckpt', '.npz')
    tmp = npz_path + '.tmp.npz'
    np.savez(tmp, **raw)
    os.replace(tmp, npz_path)


def save_train_state(path, done, model, optimizer, best_loss, best_params,
                     loss_hist):
    """Atomic elastic-resume snapshot at a segment boundary, in plain .npz
    (no pickling): parameters and best parameters in state_dict order,
    the optimizer's per-parameter state, and its update count (from its
    ``state_dict()``: a :class:`ScheduledOptimizer` or a ``FusedAdam``;
    either loads the other's Adam moments)."""
    opt_state = optimizer.state_dict()
    arrs = {'done': np.asarray(done, np.int64),
            'count': np.asarray(opt_state['count'], np.int64),
            'best_loss': np.asarray(best_loss, np.float32),
            'loss_hist': np.asarray(loss_hist, np.float32)}
    for i, v in enumerate(model.state_dict().values()):
        arrs[f'p{i}'] = v.detach().cpu().numpy()
    for i, v in enumerate(best_params.values()):
        arrs[f'b{i}'] = v.detach().cpu().numpy()
    for idx, st in opt_state['state'].items():
        for key, val in st.items():
            arrs[f'o{idx}.{key}'] = (val.detach().cpu().numpy()
                                     if torch.is_tensor(val)
                                     else np.asarray(val))
    tmp = path + '.tmp.npz'
    np.savez(tmp, **arrs)
    os.replace(tmp, path)


def load_train_state(path, model, optimizer):
    """Inverse of :func:`save_train_state`: loads the parameters and the
    optimizer state in place; returns (done, best_loss, best_params,
    loss_hist)."""
    with np.load(path) as z:
        keys = list(model.state_dict())
        model.load_state_dict({k: torch.as_tensor(z[f'p{i}'])
                               for i, k in enumerate(keys)})
        dev = next(model.parameters()).device
        best_params = {k: torch.as_tensor(z[f'b{i}']).to(dev)
                       for i, k in enumerate(keys)}
        state = {}
        for name in z.files:
            if name.startswith('o'):
                idx, key = name[1:].split('.', 1)
                state.setdefault(int(idx), {})[key] = torch.as_tensor(z[name])
        optimizer.load_state_dict({'count': int(z['count']),
                                   'state': state})
        return (int(z['done']), float(z['best_loss']), best_params,
                [float(x) for x in z['loss_hist']])


def _available_devices(device):
    """The devices a run may spread over when --num_devices is not given:
    every card on ``cuda``, one on the CPU."""
    return torch.cuda.device_count() if device.type == 'cuda' else 1


class Solver:
    """__init__(config) / train() -> history / evaluate(history) -> metrics
    (uniform interface, reference main.py:114-115).

    Multi-GPU (``--num_devices N``, ``--shard data|amp|pipe``): one process a
    rank over ``torch.distributed`` (parallel/).  A Solver made outside a
    world is the run's caller: at N > 1 its ``train`` starts the ranks
    (``launch.Ranks``, kept until ``evaluate`` ends; each rank makes its own
    Solver on the caller's data), and ``train`` and ``evaluate`` return
    what a single run returns, rank 0's, with the trained parameters
    loaded into the caller's model.  A Solver made inside a world (under
    ``torchrun``, or in a rank of ``launch.Ranks``) is that rank.  Only
    rank 0 writes logs, checkpoints, snapshots and metric.json; the caller
    records rank 0's TensorBoard scalars in its own writer, and keeps each
    rank's kernel launches of train and evaluate in ``rank_launches``.
    ``share_device`` puts every rank on card 0 over gloo (a check of the
    code path on one card, not a speed-up).  ``--shard amp|pipe`` at N = 1
    runs in this process on a world-1 group."""

    def __init__(self, config, input_sampler=None, data=None):
        """``data``: the processed dataset to train on, in place of the
        DataManager's (multi-seed training with fresh data per seed, and
        the ranks of a multi-GPU run)."""
        _check_model_type(config['model_type'])
        self.config = config
        self.operator_type = config['operator']
        self.model_type = config['model_type']
        self.device = resolve_device(config.get('device'))
        self.share_device = parse_bool(config.get('share_device', False))
        self.group = launch.current_group(self.device, self.share_device)
        self.rank = self.group.rank if self.group is not None else 0

        prefix = config.get('prefix') or "outputs"
        self.exp_logger = ExperimentLogger(config, base_output_dir=prefix,
                                           write=self.rank == 0)
        self.run_id = self.exp_logger.exp_name
        self.config['run_id'] = self.run_id

        if self.rank == 0:
            self.logger = setup_logger(self.exp_logger.text_log_path)
        else:
            self.logger = logging.getLogger(f'training.rank{self.rank}')
            self.logger.propagate = False
            self.logger.addHandler(logging.NullHandler())
        sys.stdout = StreamToLogger(self.logger)
        self.logger.info(f"Initialized Solver (PyTorch) for "
                         f"{self.model_type} on {self.device}")

        self.dm = DataManager(config,
                              data_dir=os.path.join(prefix, "..", "data"),
                              logger=self.logger,
                              input_sampler=input_sampler)
        self.data = self.dm.get_data() if data is None else data
        self._route_data()

        self.seed = int(config.get('seed') or 0)
        engine = config.get('engine', 'auto')
        self.shard_mode, self.world = self._setup_sharding()
        build_cfg = config
        if self.shard_mode in ('amp', 'pipe') and self.group is None:
            # the caller of a sharded run: its own model (which receives
            # the trained parameters) runs a single-device engine
            build_cfg = dict(config, engine=engine)
        self.model, self.input_mode = build_model(
            build_cfg, self.data, device=self.device,
            generator=torch.Generator().manual_seed(self.seed))
        self.params = _clone(self.model)
        self.logger.info(f"Model Parameters: {count_parameters(self.model)}")
        self.best_loss = float('inf')
        self.best_params = None
        self.best_model_path = None
        self._ranks = None       # the caller's rank processes (N > 1)
        self.rank_launches = []  # their kernel launches, one dict a rank

    # ── multi-GPU (--num_devices, --shard data|amp|pipe) ────────────────────
    def _setup_sharding(self):
        """(shard mode, device count), with the JAX package's guards
        (quanonet_tpu/solver.py _setup_sharding).

        'data' (or no --shard) with N > 1 trains data-parallel
        (parallel/dp_solver.py); 'amp' shards the 2^n state over the ranks
        (parallel/amplitude.py), 'pipe' pipelines the block chain
        (parallel/pipeline.py).  amp/pipe install this process's shard
        context and set the model engine, so every expectation (train
        loss, evaluation) runs the sharded program."""
        config = self.config
        mode = str(config.get('shard') or 'none').lower()
        if mode not in ('none', 'data', 'amp', 'pipe'):
            raise ValueError(f"--shard must be one of none/data/amp/pipe, "
                             f"got '{mode}'")
        n_dev = int(config.get('num_devices') or 0)
        if self.group is not None:
            if n_dev and n_dev != self.group.world:
                raise ValueError(f"--num_devices {n_dev} in a world of "
                                 f"{self.group.world} ranks")
            n_dev = self.group.world
        elif n_dev <= 0:
            n_dev = _available_devices(self.device) if mode != 'none' else 1
        else:
            launch.check_devices(n_dev, self.device, self.share_device)
        config['num_devices'] = n_dev
        gm = str(config.get('grad_method') or 'autodiff')
        if mode in ('none', 'data'):
            if n_dev > 1 and (gm != 'autodiff' or config.get('train_shots')):
                raise ValueError(
                    "--grad_method shift/spsa and --train_shots are "
                    "single-device for now; drop --num_devices")
            return mode, n_dev
        if self.model_type not in QUANTUM_MODELS:
            raise ValueError(f"--shard {mode} shards the quantum state/"
                             f"circuit; {self.model_type} has neither "
                             f"(use --shard data)")
        for k in ('noise_p', 'readout_p', 'damp_gamma', 'dephase_p',
                  'train_shots', 'multi_seed', 'ps_chunk', 'spsa_c'):
            if config.get(k):
                raise ValueError(f"--shard {mode} is incompatible with "
                                 f"--{k} for now")
        if gm != 'autodiff':
            raise ValueError(f"--shard {mode} trains by autodiff through "
                             f"the collectives; drop --grad_method")
        from quanonet_torch.ops.hea import heaqnn_spec, quanonet_spec
        from quanonet_torch.parallel.shard_engine import (
            set_shard_context, validate_shard_config,
        )
        if self.model_type == 'QuanONet':
            spec = quanonet_spec(config['num_qubits'],
                                 tuple(config.get('net_size')
                                       or (20, 2, 10, 2)))
        else:
            spec = heaqnn_spec(config['num_qubits'],
                               tuple(config.get('net_size') or (20, 2)))
        validate_shard_config(mode, n_dev, spec,
                              batch_size=int(config.get('batch_size', 100)),
                              n_microbatches=config.get('n_microbatches'))
        if self.group is None and n_dev == 1:
            self.group = comm.Group(device=self.device)
        if self.group is not None:
            set_shard_context(self.group, mode,
                              n_microbatches=config.get('n_microbatches'))
        config['engine'] = mode
        self.logger.info(
            f"Sharded training: --shard {mode} over {n_dev} devices "
            f"(Q{spec.n_qubits}, {spec.n_blocks} blocks)")
        return mode, n_dev

    def _on_ranks(self, fn, *args):
        """``fn(group, *args)`` on the run's ranks, started at the first
        call and kept until evaluate() ends; rank 0's result.  Each rank's
        result carries its kernel launches, added to ``rank_launches``."""
        if self._ranks is None:
            self.logger.info(f"Starting {self.world} ranks...")
            self._ranks = launch.Ranks(self.world, self.device,
                                       self.share_device)
        results = self._ranks.call(fn, *args)
        if not self.rank_launches:
            self.rank_launches = [{} for _ in results]
        for mine, r in zip(self.rank_launches, results):
            for k, v in r['launches'].items():
                mine[k] = mine.get(k, 0) + v
        return results[0]

    def _train_ranks(self):
        """The caller's train(): the ranks train and rank 0 writes the
        checkpoints; the caller records rank 0's scalars and its model
        takes the trained parameters."""
        from quanonet_torch.parallel import _workers
        r = self._on_ranks(_workers.solver_train, dict(self.config),
                           self.data)
        for tag, value, step in r['scalars']:
            self.exp_logger.log_metric(tag, value, step)

        def tensors(sd):
            return {k: torch.as_tensor(v) for k, v in sd.items()}
        self.params = tensors(r['params'])
        self.model.load_state_dict(self.params)
        self.best_params = (tensors(r['best_params'])
                            if r['best_params'] is not None else None)
        self.best_loss = r['best_loss']
        self.best_model_path = r['best_model_path']
        if r['train_samples_per_sec'] is not None:
            self.train_samples_per_sec = r['train_samples_per_sec']
        return r['history']

    @property
    def _data_parallel(self):
        return self.world > 1 and self.shard_mode in ('none', 'data')

    # ── data routing (reference solver_ms.py:72-89) ─────────────────────────
    def _route_data(self):
        d = self.data
        if self.model_type in ('HEAQNN', 'FNN', 'FNO'):
            self.train_inputs = (d['train_input'].astype(np.float32),)
            self.test_inputs = (d['test_input'].astype(np.float32),)
        else:
            self.train_inputs = (d['train_branch_input'].astype(np.float32),
                                 d['train_trunk_input'].astype(np.float32))
            self.test_inputs = (d['test_branch_input'].astype(np.float32),
                                d['test_trunk_input'].astype(np.float32))
        self.train_output = d['train_output'].astype(np.float32)
        self.test_output = d['test_output'].astype(np.float32)

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ── training ─────────────────────────────────────────────────────────────
    def train(self):
        if self.exp_logger.is_completed():
            print("⏩ [Resume] Experiment already completed "
                  "(metric.json found). Skipping training.")
            sys.exit(0)
        if self.group is None and self.world > 1:
            return self._train_ranks()

        self.logger.info("Starting Training...")
        config = self.config
        epochs = config['num_epochs']
        num_samples = self.train_output.shape[0]

        batch_size = config.get('batch_size', 100)
        if num_samples < batch_size:
            self.logger.warning(
                f"⚠️ Batch size {batch_size} > total samples {num_samples}. "
                f"Reducing to {num_samples}.")
            config['batch_size'] = batch_size = num_samples
        num_batches = max(1, int(np.ceil(num_samples / batch_size)))

        optimizer = build_optimizer(config, epochs * num_batches,
                                    self.model.parameters())
        history = {'loss_train': [], 'loss_test': []}

        if config.get('init_checkpoint'):
            self._load_into_params(config['init_checkpoint'])
            self.logger.info(
                f"Loaded init checkpoint: {config['init_checkpoint']}")

        if not parse_bool(config.get('if_train', 'true')):
            self.logger.info("Skipping training (if_train=false)")
            return history

        dev = self.device
        out_norm_sq = float(np.sum(self.train_output.astype(np.float64) ** 2))
        per_sample = int(np.prod(self.train_output.shape[1:]))
        if self._data_parallel:
            from quanonet_torch.parallel.dp_solver import (
                local_permutation, make_dp_run_segment,
            )
            run_segment, shard_data = make_dp_run_segment(
                self.model, optimizer, self.group, num_samples, batch_size,
                per_sample, seed=self.seed)
            inputs, outputs = shard_data(self.train_inputs,
                                         self.train_output)
            rank = self.group.rank

            def perm_of(e):
                return local_permutation(self.seed, e, rank,
                                         run_segment.local_n)
            self.logger.info(f"Data-parallel training over {self.world} "
                             f"devices")
        else:
            inputs = tuple(torch.as_tensor(a, device=dev)
                           for a in self.train_inputs)
            outputs = torch.as_tensor(self.train_output, device=dev)
            gm = str(config.get('grad_method') or 'autodiff')
            spsa_c = (float(config.get('spsa_c') or 0.05) if gm == 'spsa'
                      else None)
            run_segment = make_run_segment(
                make_train_epoch(self.model, optimizer, num_samples,
                                 batch_size, per_sample, seed=self.seed,
                                 spsa_c=spsa_c),
                self.model)

            def perm_of(e):
                return epoch_permutation(self.seed, e, num_samples)

        seg = int(config.get('epochs_per_sync') or _segment_size(epochs))
        best_loss = float('inf')
        best_params = _clone(self.model)
        writes = self.rank == 0
        if_save = config.get('if_save', True) and writes
        profile_dir = config.get('profile') if writes else None
        done = 0

        # Elastic mid-run resume (--save_state): snapshot (epoch, params,
        # optimizer state, best) at every segment boundary; a killed run
        # restarted with the identical config continues from the last
        # boundary bit-identically (epoch e's permutation depends on
        # (seed, e) only, and on the rank in a data-parallel run).
        save_state = parse_bool(config.get('save_state', 'false'))
        state_path = os.path.join(self.exp_logger.exp_dir, 'train_state.npz')
        if save_state and os.path.exists(state_path):
            done, best_loss, best_params, history['loss_train'] = \
                load_train_state(state_path, self.model, optimizer)
            self.logger.info(
                f"[Elastic resume] restored train state at epoch {done} "
                f"from {state_path}")
        start_done = done

        t0 = time.time()
        while done < epochs:
            n = min(seg, epochs - done)
            perms = [perm_of(e) for e in range(done, done + n)]
            if profile_dir and ((done == seg) or (seg >= epochs
                                                  and done == 0)):
                # the second segment (the first builds the kernels), or
                # the only one
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == 'cuda' else [])
                with profile(activities=acts) as prof:
                    best_loss, best_params, hist = run_segment(
                        best_loss, best_params, perms, inputs, outputs, done)
                    self._sync()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir,
                                                      'trace.json'))
                self.logger.info(f"Profiler trace written to {profile_dir}")
            else:
                best_loss, best_params, hist = run_segment(
                    best_loss, best_params, perms, inputs, outputs, done)
            for e, (avg_loss, sse) in enumerate(hist):
                epoch = done + e
                rel_err = float(np.sqrt(max(sse, 0.0))
                                / (np.sqrt(out_norm_sq) + 1e-8))
                history['loss_train'].append(avg_loss)
                self.exp_logger.log_metric("Loss/train", avg_loss, epoch)
                self.exp_logger.log_metric("Error/rel_l2", rel_err, epoch)
                if epoch % 10 == 0:
                    print(f"Epoch {epoch} | MSE: {avg_loss:.6e} | "
                          f"Rel_L2: {rel_err:.4%}")
            done += n
            if best_loss < self.best_loss:
                self.best_loss = best_loss
                self.best_params = {k: v.cpu() for k, v in best_params.items()}
                if if_save:
                    self.best_model_path = self.exp_logger.get_ckpt_path()
                    self._save_checkpoint(self.best_params,
                                          self.best_model_path)
            if save_state and writes and done < epochs:
                save_train_state(state_path, done, self.model, optimizer,
                                 best_loss, best_params,
                                 history['loss_train'])

        if save_state and writes and os.path.exists(state_path):
            os.remove(state_path)           # run completed; snapshot obsolete
        self._sync()
        wall = time.time() - t0
        sps = (epochs - start_done) * num_samples / max(wall, 1e-9)
        self.logger.info(
            f"Training wall-time: {wall:.2f}s "
            f"({sps:,.0f} samples/sec incl. kernel builds)")
        self.train_samples_per_sec = sps

        self.params = {k: v.cpu() for k, v in _clone(self.model).items()}
        if self.best_params is None:
            self.best_params = self.params
        if if_save:
            final_path = self.exp_logger.get_ckpt_path(is_final=True)
            self._save_checkpoint(self.params, final_path)
            self.logger.info(f"Saved FINAL model to {final_path}")
        return history

    # ── checkpointing ─────────────────────────────────────────────────────────
    def _save_checkpoint(self, params, ckpt_path):
        save_checkpoint(params, ckpt_path, self.model_type)

    def _load_into_params(self, path):
        default = (20, 2, 10, 2) if self.model_type == 'QuanONet' else (20, 2)
        self.model.load_state_dict(state_dict_from_raw(
            ckpt_io.load_raw(path), self.model_type,
            tuple(self.config.get('net_size') or default),
            self.config.get('num_qubits'),
            parse_bool(self.config.get('if_trainable_freq', 'true'))))
        self.params = _clone(self.model)

    # ── evaluation (reference solver_ms.py:279-330) ──────────────────────────
    def predict_test(self):
        """The model's predictions on the test inputs, (n, 1) NumPy, in
        chunks of max(batch_size, 4096) rows under inference mode (so the
        chain takes the primal-only kernel); data-parallel, each chunk's
        rows shared over the ranks (:func:`predict_chunks_sharded`).  A
        model trained with shots or under a noise channel is evaluated with
        them, chunk s drawing from a generator seeded from (run seed, s),
        as the JAX package keys it."""
        sampled = bool(getattr(self.model, 'sampled', False))
        seed = self.seed if sampled else None
        batch_size = self.config.get('batch_size', 100)
        if self._data_parallel and self.group is not None:
            return predict_chunks_sharded(self.model, self.test_inputs,
                                          batch_size, self.group, seed)
        return predict_chunks(self.model, self.test_inputs, batch_size,
                              self.device, seed)

    def evaluate(self, history=None):
        self.logger.info("Evaluating...")
        if self.group is None and self.world > 1:
            from quanonet_torch.parallel import _workers
            params = (self.best_params if self.best_params is not None
                      else self.params)
            try:
                metrics = self._on_ranks(
                    _workers.solver_evaluate, dict(self.config), self.data,
                    {k: v.cpu().numpy() for k, v in params.items()},
                    history)['metrics']
            finally:
                self._ranks.close()
                self._ranks = None
            self.exp_logger.close()
            return metrics
        if self.best_params is not None:
            self.model.load_state_dict(self.best_params)
            self.logger.info("Using best-epoch parameters")
        elif self.config.get('ckpt_path') and \
                os.path.exists(self.config['ckpt_path']):
            self._load_into_params(self.config['ckpt_path'])
            self.logger.info(
                f"Loaded evaluation model from {self.config['ckpt_path']}")

        y_pred = self.predict_test()
        y_true = self.test_output
        rel_error = rel_l2(y_true, y_pred)
        self.logger.info(
            f"⚡ Test Relative L2 Error: {rel_error:.6f} ({rel_error:.2%})")
        metrics = compute_metrics(y_true, y_pred)
        metrics['rel_l2'] = rel_error
        if hasattr(self, 'train_samples_per_sec'):
            metrics['train_samples_per_sec'] = self.train_samples_per_sec
        self.logger.info(f"Metrics: {metrics}")
        self.exp_logger.save_metrics(metrics, history)
        self.exp_logger.close()
        return metrics
