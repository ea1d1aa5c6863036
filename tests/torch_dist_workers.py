"""
Rank functions of the multi-rank port tests (tests/test_torch_port_parallel_
*.py), started by quanonet_torch.parallel.launch in spawned processes.  This
module imports torch and quanonet_torch only: a rank never imports JAX or
the tests' conftest.  Inputs arrive as NumPy arrays; results go back as
NumPy arrays (launch converts tensors).
"""
import numpy as np
import torch

from quanonet_torch.models import FNN, QuanONet
from quanonet_torch.models.packed import PackedModel
from quanonet_torch.parallel import comm, mesh
from quanonet_torch.parallel.amplitude import make_sharded_hea
from quanonet_torch.parallel.dp_solver import (
    local_permutation, make_dp_run_segment,
)
from quanonet_torch.parallel.pipeline import make_pipeline_hea


def _grads(f, w, x, device='cpu'):
    """f(w, x) (batch, 1), and the gradients of sum(f²) in w and x."""
    w = torch.tensor(w, device=device, requires_grad=True)
    x = torch.tensor(x, device=device, requires_grad=True)
    out = f(w, x)
    (out ** 2).sum().backward()
    return out.detach(), w.grad, x.grad


def amp_cases(group, cases):
    """cases: [(spec, w, x, diag, fused, pauli, offset, coeff)] -> per case
    (out, w̄, x̄, forward exchanges, backward exchanges)."""
    res = []
    for spec, w, x, diag, fused, pauli, offset, coeff in cases:
        f = make_sharded_hea(spec, group, fused=fused, pauli=pauli,
                             offset=offset, coeff=coeff)
        group.counts.clear()
        with torch.no_grad():
            f(torch.tensor(w, device=group.device),
              torch.tensor(x, device=group.device), diag)
        fwd = group.counts['exchange']
        group.counts.clear()
        out, gw, gx = _grads(lambda w_, x_: f(w_, x_, diag), w, x,
                             group.device)
        res.append((out, gw, gx, fwd, group.counts['exchange_bwd']))
    return res


def pipe_cases(group, cases, grid_cases=()):
    """cases: [(spec, w, x, diag, M, stage_local, pauli, offset, coeff)] ->
    per case (out, w̄, x̄, shifts forward, shifts backward); grid_cases run
    dp × pp on a (world/2, 2) grid: [(spec, w, x, diag, M)] -> (out, w̄,
    x̄)."""
    res = []
    for spec, w, x, diag, M, local, pauli, offset, coeff in cases:
        f = make_pipeline_hea(spec, group, n_microbatches=M,
                              stage_local_compile=local, pauli=pauli,
                              offset=offset, coeff=coeff)
        group.counts.clear()
        out, gw, gx = _grads(lambda w_, x_: f(w_, x_, diag), w, x,
                             group.device)
        res.append((out, gw, gx, group.counts['shift'],
                    group.counts['shift_bwd']))
    grid = []
    if grid_cases:
        data, pipe = mesh.grid(group, 2)
        for spec, w, x, diag, M in grid_cases:
            f = make_pipeline_hea(spec, pipe, n_microbatches=M, data=data)
            grid.append(_grads(lambda w_, x_: f(w_, x_, diag), w, x,
                               group.device))
    return res, grid


def _load(model, state):
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


def _adam(params, lr):
    from quanonet_torch.solver import build_optimizer
    return build_optimizer({'learning_rate': lr, 'optimizer': 'adam'}, 1,
                           params)


def dp_step(group, kind, model_kw, state, inputs, target, lr):
    """One make_dp_train_step step of a QuanONet or an FNN (``kind``) under
    Adam on this rank's share of the batch; returns (loss, state)."""
    cls = QuanONet if kind == 'QuanONet' else FNN
    model = _load(cls(**model_kw, device='cpu'), state)
    m = mesh.make_mesh(group)
    step = mesh.make_dp_train_step(model, _adam(model.parameters(), lr), m)
    loss = step(mesh.shard_batch(m, *inputs), *mesh.shard_batch(m, target))
    return loss, model.state_dict()


def dp_step_multiseed(group, model_kw, states, inputs, target, lr):
    """One multi-seed step on a (world/2, 2) grid: the seeds' stacked
    parameters split over the seed axis; returns (losses of every seed,
    this rank's seeds' stacked parameters)."""
    m = mesh.make_mesh(group, seed_parallel=2)
    mine = [states[s] for s in range(len(states))
            if s * m.seed.world // len(states) == m.seed.rank]
    packed = PackedModel([_load(QuanONet(**model_kw, device='cpu'), st)
                          for st in mine])
    step = mesh.make_dp_train_step(packed, _adam(packed.parameters(), lr),
                                   m, multi_seed=True)
    loss = step(mesh.shard_batch(m, *inputs), *mesh.shard_batch(m, target))
    return loss, {k: v.detach() for k, v in packed.params.items()}


class _Linear(torch.nn.Module):
    """x @ w + b; with ``noise``, plus 0.1 · a normal draw from the
    generator (a stand-in for trajectory sampling)."""

    def __init__(self, w, b, noise=False):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))
        self.b = torch.nn.Parameter(torch.tensor(b))
        self.sampled = noise

    def forward(self, x, generator=None):
        out = x @ self.w + self.b
        if self.sampled:
            out = out + 0.1 * torch.randn(out.shape, generator=generator,
                                          device=out.device)
        return out


def _sgd(params, lr):
    from quanonet_torch.solver import build_optimizer
    return build_optimizer({'learning_rate': lr, 'optimizer': 'sgd'}, 1,
                           params)


def dp_segment(group, kind, spec, X, Y, batch_size, epochs, lr, seed,
               optimizer='sgd'):
    """make_dp_run_segment for ``epochs`` epochs of a linear model
    (``kind`` 'linear' or 'noisy') or an FNN ('fnn', spec its kwargs and
    state); returns (history, parameters)."""
    if kind == 'fnn':
        kw, state = spec
        model = _load(FNN(**kw, device='cpu'), state)
    else:
        model = _Linear(*spec, noise=kind == 'noisy')
    model = model.to(group.device)
    opt = (_sgd if optimizer == 'sgd' else _adam)(model.parameters(), lr)
    run, shard = make_dp_run_segment(model, opt, group, len(Y), batch_size,
                                     1, seed=seed)
    inputs, outputs = shard((X,), Y)
    perms = [local_permutation(seed, e, group.rank, run.local_n)
             for e in range(epochs)]
    _, _, hist = run(float('inf'), None, perms, inputs, outputs)
    return hist, dict(model.named_parameters())


def solver_killed_at(group, config, data, kill_at):
    """A rank of a Solver run whose rank 0 dies at the first scalar of
    epoch ``kill_at``."""
    from quanonet_torch.solver import Solver
    solver = Solver(config, data=data)
    if group.rank == 0:
        def dying(tag, value, step):
            if step >= kill_at:
                raise RuntimeError('simulated preemption')
        solver.exp_logger.log_metric = dying
    return solver.train()


def collectives(group):
    """Each collective once on small tensors: results and gradients."""
    group.counts.clear()
    t = torch.full((3,), float(group.rank + 1), requires_grad=True)
    s = comm.psum_replicated(t * 2.0, group)
    e = comm.exchange(t * 1.0, 0, group)
    sh = comm.shift_next(t * 3.0, group)
    g = comm.all_gather_rows(t[None] * 1.0, group)
    (s.sum() + (e * e).sum() + sh.sum() + (g * g).sum()).backward()
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.full((2,), float(group.rank))
    ptr = p.grad.data_ptr()
    extra = comm.all_reduce_grads([p], group, extras=torch.ones(1),
                                  denominator=lambda e_: e_[0])
    from quanonet_torch.backend import backend
    return dict(s=s, e=e, sh=sh, g=g, grad=t.grad, pgrad=p.grad,
                same_ptr=p.grad.data_ptr() == ptr, extra=extra,
                counts=dict(group.counts), summary=backend.device_summary())


def hang_unless_rank0(group):
    """Rank 0 returns; the others wait in a collective rank 0 never
    joins."""
    if group.rank != 0:
        comm.psum_replicated(torch.ones(1), group)
    return group.rank


def fail_on_rank1(group):
    if group.rank == 1:
        raise KeyError('rank one fails')
    comm.psum_replicated(torch.ones(1), group)
    return group.rank


def seed_of(group, seed):
    return np.asarray([seed, group.rank, group.world])


def run_all(group, calls):
    """Several of this module's rank functions in one start: calls is a
    list of (name, args); returns their results in order."""
    return [globals()[name](group, *args) for name, args in calls]
