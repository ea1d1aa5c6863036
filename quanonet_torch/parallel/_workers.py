"""
Rank functions that ``parallel/launch`` starts: importable by a spawned
process, importing only torch and quanonet_torch.  Each takes the rank's
Group first and returns plain values (tensors come back as NumPy);
``group.state`` keeps the rank's Solver from train to evaluate.
"""
import numpy as np
import torch

from quanonet_torch import tracing
from quanonet_torch.profile_step import launch_counts


def solver_train(group, config, data):
    """A rank of Solver.train(): returns the history, the TensorBoard
    scalars (for the caller to record), the trained and best parameters,
    the best loss, the checkpoint path, the rate and the rank's kernel
    launches in train()."""
    from quanonet_torch.solver import Solver
    solver = group.state['solver'] = Solver(config, data=data)
    scalars = []
    solver.exp_logger.log_metric = \
        lambda tag, value, step: scalars.append((tag, value, step))
    tracing.reset()
    history = solver.train()
    return {'history': history, 'scalars': scalars, 'params': solver.params,
            'best_params': solver.best_params,
            'best_loss': solver.best_loss,
            'best_model_path': solver.best_model_path,
            'train_samples_per_sec': getattr(solver,
                                             'train_samples_per_sec', None),
            'launches': launch_counts()}


def solver_evaluate(group, config, data, params, history):
    """A rank of Solver.evaluate(): on the rank's Solver from
    :func:`solver_train`, or on a new one holding ``params``; returns the
    metrics and the rank's kernel launches in evaluate()."""
    solver = group.state.get('solver')
    if solver is None:
        from quanonet_torch.solver import Solver
        solver = Solver(config, data=data)
        solver.best_params = {k: torch.as_tensor(v)
                              for k, v in params.items()}
    tracing.reset()
    metrics = solver.evaluate(history)
    return {'metrics': metrics, 'launches': launch_counts()}


# ── checks of the multi-GPU paths on the card (chip_smoke.py, multichip.py)

def run_checks(group, calls):
    """Several of this module's check functions in one start: calls is a
    list of (name, args); returns their results in order."""
    return [globals()[name](group, *args) for name, args in calls]


class _Timer:
    """Milliseconds between two marks: CUDA events on a card, the host
    clock after a synchronisation otherwise."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'

    def __enter__(self):
        import time
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = 1e3 * (time.perf_counter() - self.t0)


def dp_check(group, model_kw, state, arrays, target, lr, epochs, perms=None,
             timed_rounds=3):
    """Data parallelism of a QuanONet from ``state`` under Adam at ``lr``:
    one make_dp_train_step step on the first 100 rows (this rank's share),
    and ``epochs`` epochs of make_dp_run_segment at batch 100 over
    ``arrays``/``target`` (with ``perms``, else each rank's local orders)
    with the kernel launches in them; then the ms a step of the segment,
    and at world 1 of the single-process segment (make_train_epoch) on the
    same orders, in turns in this process (the median of
    ``timed_rounds``).  Returns the step's loss and parameters, the
    segment's history, parameters, launches and steps, step_ms and
    plain_step_ms."""
    from quanonet_torch.models import QuanONet
    from quanonet_torch.parallel import mesh
    from quanonet_torch.parallel.dp_solver import (
        local_permutation, make_dp_run_segment,
    )
    from quanonet_torch.solver import (
        build_optimizer, make_run_segment, make_train_epoch,
    )

    def fresh():
        model = QuanONet(**model_kw, device=group.device)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in state.items()})
        return model, build_optimizer({'learning_rate': lr}, 1,
                                      model.parameters())

    model, opt = fresh()
    m = mesh.make_mesh(group)
    step = mesh.make_dp_train_step(model, opt, m)
    batch = mesh.shard_batch(m, *(a[:100] for a in arrays))
    y = mesh.shard_batch(m, target[:100])[0]
    loss = step(batch, y).item()
    one_step = {k: v.clone() for k, v in model.state_dict().items()}

    def dp_segment():
        model, opt = fresh()
        run, shard = make_dp_run_segment(model, opt, group, target.shape[0],
                                         100, 1, seed=0)
        return model, run, shard(arrays, target)

    model, run, (inputs, outputs) = dp_segment()
    if perms is None:
        perms = [local_permutation(0, e, group.rank, run.local_n)
                 for e in range(epochs)]
    tracing.reset()
    _, _, hist = run(float('inf'), None, perms, inputs, outputs)
    if group.device.type == 'cuda':
        torch.cuda.synchronize(group.device)
    launches = launch_counts()
    out = {'loss': loss, 'one_step': one_step, 'hist': hist,
           'params': {k: v.clone() for k, v in model.state_dict().items()},
           'launches': launches,
           'steps': len(perms) * (-(-run.local_n // (100 // group.world)))}

    arms = {'step_ms': (run, inputs, outputs)}
    if group.world == 1:
        plain_model, plain_opt = fresh()
        arms['plain_step_ms'] = (
            make_run_segment(make_train_epoch(plain_model, plain_opt,
                                              run.local_n, 100, 1),
                             plain_model),
            tuple(torch.as_tensor(a, device=group.device) for a in arrays),
            torch.as_tensor(target, device=group.device))
    times = {k: [] for k in arms}
    for _ in range(timed_rounds):
        for k, (seg, x, t) in arms.items():
            with _Timer(group.device) as tm:
                seg(float('inf'), None, perms, x, t)
            times[k].append(tm.ms / out['steps'])
    out.update({k: float(np.median(v)) for k, v in times.items()})
    return out


def amp_check(group, spec, w, x, diag, reps=3):
    """The amplitude-sharded expectation (grouped-kron local path) of
    ``spec`` and its weight gradient (of the sum of the outputs) on this
    rank's device: the output, w̄, the forward's exchanges and the ms of one
    forward and backward (median of ``reps``)."""
    from quanonet_torch.parallel.amplitude import make_sharded_hea
    f = make_sharded_hea(spec, group, fused=True)
    w = torch.as_tensor(w, device=group.device)
    x = torch.as_tensor(x, device=group.device)
    group.counts.clear()
    with torch.no_grad():
        out = f(w, x, diag)
    exchanges = group.counts['exchange']
    times = []
    for _ in range(reps):
        wg = w.clone().requires_grad_()
        with _Timer(group.device) as t:
            f(wg, x, diag).sum().backward()
        times.append(t.ms)
    return {'out': out, 'w_grad': wg.grad, 'exchanges': exchanges,
            'fwd_bwd_ms': float(np.median(times))}


def amp_forwards(group, cases):
    """The amplitude-sharded forward (grouped-kron local path) of each
    case (spec, w, x, diag) under no_grad: its output, the exchanges the
    engine counted, the amplitudes this rank held and the ms of the call
    (quanonet_torch/bench_amplitude.py's correctness and capacity rows)."""
    from quanonet_torch.parallel.amplitude import make_sharded_hea
    out = []
    for spec, w, x, diag in cases:
        f = make_sharded_hea(spec, group, fused=True)
        w = torch.as_tensor(w, device=group.device)
        x = torch.as_tensor(x, device=group.device)
        group.counts.clear()
        with torch.no_grad(), _Timer(group.device) as t:
            y = f(w, x, diag)
        out.append({'out': y, 'exchanges': group.counts['exchange'],
                    'local_amplitudes': f.local_dim, 'ms': t.ms})
    return out


def pipe_check(group, spec, w, x, diag, n_microbatches):
    """The pipelined expectation of ``spec`` and its weight gradient (of the
    sum of the outputs): the output, w̄, the compile launches of the forward
    and of the backward, the hops and the ms of the forward and
    backward."""
    from quanonet_torch.parallel.pipeline import make_pipeline_hea
    f = make_pipeline_hea(spec, group, n_microbatches=n_microbatches)
    w = torch.as_tensor(w, device=group.device).requires_grad_()
    x = torch.as_tensor(x, device=group.device)
    group.counts.clear()
    tracing.reset()
    with _Timer(group.device) as t:
        out = f(w, x, diag)
        fwd = launch_counts()
        out.sum().backward()
    return {'out': out.detach(), 'w_grad': w.grad, 'fwd_launches': fwd,
            'launches': launch_counts(), 'hops': dict(group.counts),
            'fwd_bwd_ms': t.ms}
