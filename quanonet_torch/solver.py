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

The random streams are torch's, not JAX's: parameters are drawn from a
``torch.Generator`` seeded with the run seed, and epoch e's permutation
from one seeded with (seed, e), so a resumed run replays them.  Training
is held to the JAX package by outcome and, step by step, in the tests
(which hand both the same parameters and permutations).
"""
import math
import os
import sys
import time

import numpy as np
import torch

from quanonet_torch import checkpoint as ckpt_io
from quanonet_torch import resolve_device
from quanonet_torch.config import parse_bool, reject_unported
from quanonet_torch.convert import raw_from_state_dict, state_dict_from_raw
from quanonet_torch.data.manager import DataManager
from quanonet_torch.logger import ExperimentLogger, StreamToLogger, setup_logger
from quanonet_torch.metrics import compute_metrics, rel_l2

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
    if model_type in CLASSICAL_MODELS:
        return _build_classical(config, data, device, generator)
    net_size = config.get('net_size')
    ham_diag = config.get('ham_diag')
    kw = dict(num_qubits=config['num_qubits'],
              scale_coeff=config.get('scale_coeff', 0.01),
              if_trainable_freq=parse_bool(
                  config.get('if_trainable_freq', 'true')),
              ham_bound=tuple(config.get('ham_bound') or (-5.0, 5.0)),
              ham_diag=tuple(ham_diag) if ham_diag is not None else None,
              ham_pauli=config.get('ham_pauli', 'Z'),
              engine=config.get('engine', 'auto'), device=device,
              generator=generator)
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


def make_train_epoch(model, optimizer, num_samples, batch_size, per_sample):
    """One training epoch: ``train_epoch(perm, inputs, outputs) ->
    (avg_loss, sse)``, both 0-d float32 tensors on the outputs' device.
    ``optimizer`` is a :class:`ScheduledOptimizer` or anything else with
    its ``zero_grad``/``step`` pair over the model's parameters, such as
    the one-launch Adam ``ops/cuda_adam.FusedAdam`` (the counterpart of
    the JAX package's ``fused_step`` route).

    ``perm`` (num_samples,) orders the samples; the last batch wraps
    around and its extra rows are masked out, reproducing the reference's
    per-epoch averaging (solver_ms.py:219-245): each step's loss is
    sum(sq · mask) / max(sum(mask) · per_sample, 1)."""
    num_batches = max(1, int(np.ceil(num_samples / batch_size)))
    padded = num_batches * batch_size

    def batch_loss(batch_in, batch_out, mask):
        pred = model(*batch_in)
        m = mask.reshape(mask.shape + (1,) * (pred.dim() - 1))
        sq = (pred - batch_out) ** 2 * m
        return sq.sum() / torch.clamp(mask.sum() * per_sample, min=1.0)

    def train_epoch(perm, inputs, outputs):
        dev = outputs.device
        perm = torch.as_tensor(perm, dtype=torch.long, device=dev)
        pad_idx = torch.cat([perm, perm[:padded - num_samples]])
        masks = (torch.arange(padded, device=dev) < num_samples).to(
            torch.float32).reshape(num_batches, batch_size)
        idx = pad_idx.reshape(num_batches, batch_size)
        losses = []
        for b in range(num_batches):
            bi = idx[b]
            loss = batch_loss(tuple(a[bi] for a in inputs), outputs[bi],
                              masks[b])
            optimizer.zero_grad()
            loss.backward()
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
    ``run_segment(best_loss, best_params, perms, inputs, outputs) ->
    (best_loss, best_params, [(avg_loss, sse) per epoch])``, one epoch per
    permutation.  best_params is a state_dict copy, replaced when an
    epoch's average loss is below best_loss."""
    def run_segment(best_loss, best_params, perms, inputs, outputs):
        hist = []
        for perm in perms:
            avg, sse = train_epoch(perm, inputs, outputs)
            avg, sse = avg.item(), sse.item()   # one host read per epoch
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


class Solver:
    """__init__(config) / train() -> history / evaluate(history) -> metrics
    (uniform interface, reference main.py:114-115)."""

    def __init__(self, config, input_sampler=None):
        reject_unported(config)
        _check_model_type(config['model_type'])
        self.config = config
        self.operator_type = config['operator']
        self.model_type = config['model_type']
        self.device = resolve_device(config.get('device'))

        prefix = config.get('prefix') or "outputs"
        self.exp_logger = ExperimentLogger(config, base_output_dir=prefix)
        self.run_id = self.exp_logger.exp_name
        self.config['run_id'] = self.run_id

        self.logger = setup_logger(self.exp_logger.text_log_path)
        sys.stdout = StreamToLogger(self.logger)
        self.logger.info(f"Initialized Solver (PyTorch) for "
                         f"{self.model_type} on {self.device}")

        self.dm = DataManager(config,
                              data_dir=os.path.join(prefix, "..", "data"),
                              logger=self.logger,
                              input_sampler=input_sampler)
        self.data = self.dm.get_data()
        self._route_data()

        self.seed = int(config.get('seed') or 0)
        self.model, self.input_mode = build_model(
            config, self.data, device=self.device,
            generator=torch.Generator().manual_seed(self.seed))
        self.params = _clone(self.model)
        self.logger.info(f"Model Parameters: "
                         f"{sum(p.numel() for p in self.model.parameters())}")
        self.best_loss = float('inf')
        self.best_params = None
        self.best_model_path = None

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
        inputs = tuple(torch.as_tensor(a, device=dev)
                       for a in self.train_inputs)
        outputs = torch.as_tensor(self.train_output, device=dev)
        out_norm_sq = float(np.sum(self.train_output.astype(np.float64) ** 2))
        per_sample = int(np.prod(self.train_output.shape[1:]))
        run_segment = make_run_segment(
            make_train_epoch(self.model, optimizer, num_samples, batch_size,
                             per_sample), self.model)

        seg = int(config.get('epochs_per_sync') or _segment_size(epochs))
        best_loss = float('inf')
        best_params = _clone(self.model)
        if_save = config.get('if_save', True)
        profile_dir = config.get('profile')
        done = 0

        # Elastic mid-run resume (--save_state): snapshot (epoch, params,
        # optimizer state, best) at every segment boundary; a killed run
        # restarted with the identical config continues from the last
        # boundary bit-identically (epoch e's permutation depends on
        # (seed, e) only).
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
            perms = [epoch_permutation(self.seed, e, num_samples)
                     for e in range(done, done + n)]
            if profile_dir and ((done == seg) or (seg >= epochs
                                                  and done == 0)):
                # the second segment (the first builds the kernels), or
                # the only one
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == 'cuda' else [])
                with profile(activities=acts) as prof:
                    best_loss, best_params, hist = run_segment(
                        best_loss, best_params, perms, inputs, outputs)
                    self._sync()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir,
                                                      'trace.json'))
                self.logger.info(f"Profiler trace written to {profile_dir}")
            else:
                best_loss, best_params, hist = run_segment(
                    best_loss, best_params, perms, inputs, outputs)
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
            if save_state and done < epochs:
                save_train_state(state_path, done, self.model, optimizer,
                                 best_loss, best_params,
                                 history['loss_train'])

        if save_state and os.path.exists(state_path):
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
        """Dual-format save (.ckpt MindSpore-compatible + .npz reference
        schema), mirroring solver_ms.py:256-263."""
        raw = raw_from_state_dict(params, self.model_type)
        ckpt_io.save_ms_ckpt(ckpt_path, raw)
        npz_path = ckpt_path.replace('.ckpt', '.npz')
        tmp = npz_path + '.tmp.npz'
        np.savez(tmp, **raw)
        os.replace(tmp, npz_path)

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
        chain takes the primal-only kernel)."""
        batch_size = max(self.config.get('batch_size', 100), 4096)
        n = self.test_output.shape[0]
        preds = []
        with torch.inference_mode():
            for s in range(0, n, batch_size):
                batch = tuple(torch.as_tensor(a[s:s + batch_size],
                                              device=self.device)
                              for a in self.test_inputs)
                preds.append(self.model(*batch).cpu().numpy())
        return np.concatenate(preds, axis=0)

    def evaluate(self, history=None):
        self.logger.info("Evaluating...")
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
