"""
Training cells: the Solver's epochs (``solver.build_model``,
``build_optimizer``, ``make_train_epoch`` under ``make_run_segment``, as
``python -m quanonet_torch.cli`` trains), one host read an epoch.

Set-up builds the one model and optimizer, and drives them from the
seed's weights through ``setup_epochs`` epochs of the window's own call
and feed.  Two epochs of that call are read for the check, each under a
forward hook that reads its first three steps: the first epoch of
set-up, and one more epoch after the window has closed, which starts from
the state the window left (a step that only a warmed or long-running
program takes shows there).  Of each it reads the state before it (the
parameters, Adam's moments and its count of updates), each step's
predictions (so its loss), Adam's first moment after step 1 (so the
step's gradient as Adam got it) and the parameters as step 4 finds them.
The reference follows the same three steps from the same state: from the
seed's weights and a fresh Adam at the start, from the program's own
state after the window.

Traffic keys: functions, points (rows = functions x points), batch,
peak_lr, epochs (the cosine schedule's length, longer than any window, so
that the rate is still on its first descent after it), setup_epochs.
"""
import math
import time

import numpy as np
import torch

from portbench.frozen import inputs, work
from portbench.kinds import Stages
from portbench.reference import quanonet as reference

CHECKED_STEPS = 3


def _solver_config(config, traffic):
    return dict(model_type='QuanONet', num_qubits=config['num_qubits'],
                net_size=list(config['net_size']),
                scale_coeff=config['scale_coeff'], if_trainable_freq='true',
                ham_bound=list(config['ham_bound']), engine=config['engine'],
                learning_rate=traffic['peak_lr'], lr_scheduler='cosine')


def _moments(opt_state, names):
    """Adam's (first, second) moments by leaf, cloned, from the
    optimizer's state (``exp_avg``/``exp_avg_sq`` in torch.optim.Adam,
    ``mu``/``nu`` in the port's one-launch Adam); zeros before its first
    update."""
    state = opt_state['state']
    out = ({}, {})
    for i, name in enumerate(names):
        st = state.get(i, {})
        for j, keys in enumerate((('exp_avg', 'mu'), ('exp_avg_sq', 'nu'))):
            got = [st[k] for k in keys if k in st]
            out[j][name] = got[0].detach().clone() if got else None
    return out


class Cell:
    def __init__(self, config, traffic, seed, device, seconds, root):
        stage = Stages('train')
        from quanonet_torch import solver
        stage('import the program')
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.n = traffic['functions'] * traffic['points']
        self.batch = traffic['batch']
        self.data = inputs.antideriv_set(seed, traffic['functions'],
                                         traffic['points'], device)
        branch, trunk, self.target = self.data
        stage('data')
        scfg = _solver_config(config, traffic)
        self.model, _ = solver.build_model(
            scfg, {'train_branch_input': branch, 'train_trunk_input': trunk},
            device=device, generator=torch.Generator().manual_seed(0))
        self.params0 = inputs.quanonet_params(config, seed, device)
        self.model.load_state_dict(self.params0)
        steps = self.n // self.batch
        self.opt = solver.build_optimizer(scfg, traffic['epochs'] * steps,
                                          self.model.parameters())
        self.segment = solver.make_run_segment(
            solver.make_train_epoch(self.model, self.opt, self.n, self.batch,
                                    1), self.model)
        self.best = (float('inf'), None)
        self.epoch = 0
        stage('model and optimizer')
        self.reads = [self._read_epoch()]
        stage('first epoch')
        for _ in range(traffic['setup_epochs'] - 1):
            self.run_epoch()
        stage('further epochs')

    def _read_epoch(self):
        """The next epoch, run by the window's own call under a forward
        hook that reads its first three steps (see the module's
        docstring)."""
        names = [k for k, _ in self.model.named_parameters()]
        betas = self.opt.optimizer.param_groups[0].get('betas',
                                                        (0.9, 0.999))
        before = self.opt.state_dict()
        m0, v0 = _moments(before, names)
        params = {k: v.detach().clone()
                  for k, v in self.model.named_parameters()}
        m0 = {k: torch.zeros_like(params[k]) if m is None else m
              for k, m in m0.items()}
        v0 = {k: torch.zeros_like(params[k]) if v is None else v
              for k, v in v0.items()}
        read = dict(epoch=self.epoch, params=params,
                    start=(m0, v0, before['count']), preds=[], grad1=None,
                    params3=None)

        def hook(module, args, output):
            calls = len(read['preds'])
            if calls == 1:
                m1, _ = _moments(self.opt.state_dict(), names)
                read['grad1'] = {
                    k: ((m1[k] - betas[0] * m0[k]) / (1 - betas[0]))
                    .double().cpu() for k in names if m1[k] is not None}
            if calls == CHECKED_STEPS:
                read['params3'] = {k: v.detach().double().cpu()
                                   for k, v in self.model.named_parameters()}
            read['preds'].append(output.detach().reshape(-1).double().cpu()
                                 if calls < CHECKED_STEPS else None)

        handle = self.model.register_forward_hook(hook)
        try:
            self.run_epoch()
        finally:
            handle.remove()
        return read

    def run_epoch(self):
        perm = inputs.epoch_order(self.seed, self.epoch, self.n)
        best_loss, best_params, hist = self.segment(
            *self.best, [perm], self.data[:2], self.target, self.epoch)
        self.best = (best_loss, best_params)
        self.epoch += 1
        return hist[0][0]

    def warm_unit(self):
        self.run_epoch()

    def run_window(self, seconds):
        """Whole epochs until ``seconds`` have passed; the window ends with
        a synchronise."""
        sync = (torch.cuda.synchronize if self.device.type == 'cuda'
                else (lambda: None))
        sync()
        epochs, bad, t0 = 0, 0, time.perf_counter()
        while True:
            loss = self.run_epoch()
            epochs += 1
            bad += 0 if math.isfinite(loss) else 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        elapsed = time.perf_counter() - t0
        steps = epochs * (self.n // self.batch)
        flops, nbytes = work.circuit_work(self.config, epochs * self.n, True)
        return dict(kind='train', seconds=elapsed, rows=epochs * self.n,
                    units=steps, attempted=steps,
                    failed=bad * (self.n // self.batch), flops=flops,
                    bytes=nbytes)

    def free(self):
        """Reads one more epoch from the state the window left, then frees
        the program's state."""
        self.reads.append(self._read_epoch())
        del self.model, self.opt, self.segment, self.best

    def check(self, limits, tf32=False):
        """The three steps of the first epoch (names as in
        :func:`compare`) and of the epoch after the window (the same names
        with ``window_`` in front) against the reference: [(name, value,
        limit)].  ``tf32`` puts the TF32 control in the program's place."""
        start, after = self.reads
        # the start is the benchmark's own seeded weights and a fresh Adam
        start = dict(start, params=self.params0, start=None)
        out, self.details = [], {}
        for prefix, read in (('', start), ('window_', after)):
            numbers, details = self._check_epoch(read, tf32)
            self.details.update({prefix + k: v for k, v in details.items()})
            out += [(prefix + name, value, limits[prefix + name])
                    for name, value in numbers]
        return out

    def _check_epoch(self, read, tf32):
        branch, trunk, target = self.data
        order = inputs.epoch_order(self.seed, read['epoch'], self.n)
        rows = [order[i * self.batch:(i + 1) * self.batch].to(self.device)
                for i in range(CHECKED_STEPS)]
        batches = [(branch[r], trunk[r], target[r, 0]) for r in rows]
        total = self.traffic['epochs'] * (self.n // self.batch)
        rate = reference.cosine_rate(self.traffic['peak_lr'], total)
        ref = reference.QuanONet(self.config, self.device)
        losses_r, grad_r, params_r = reference.train_steps(
            ref, read['params'], batches, rate, read['start'])
        if tf32:
            ctl = reference.QuanONet(self.config, self.device, tf32=True)
            losses_p, grad_p, params_p = reference.train_steps(
                ctl, read['params'], batches, rate, read['start'])
        else:
            losses_p = [float(((p - target[r, 0].double().cpu()) ** 2)
                               .mean()) for p, r in zip(read['preds'], rows)]
            grad_p, params_p = read['grad1'], read['params3']
        p0 = {k: v.double().cpu() for k, v in read['params'].items()}
        change_p, change_r = _change(params_p, p0), _change(params_r, p0)
        return (compare(losses_p, losses_r, grad_p, grad_r, change_p,
                        change_r),
                look(losses_p, losses_r, grad_p, grad_r, change_p,
                     change_r))


def _change(params, start):
    if params is None:
        return {k: torch.zeros_like(v) for k, v in start.items()}
    return {k: params[k] - start[k] for k in start}


def _leaf_gaps(prog, ref, leaves):
    """| |prog| - |ref| | / max(|ref leaf|, median leaf |ref|) of each
    leaf; a leaf the program lacks reads as zero."""
    norms = {k: float(ref[k].norm()) for k in leaves}
    floor = float(np.median(list(norms.values())))
    return [abs((float(prog[k].norm()) if prog and k in prog else 0.0)
                - norms[k]) / max(norms[k], floor) for k in leaves]


def _moved(grad_r):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone."""
    norms = {k: float(g.norm()) for k, g in grad_r.items()}
    median = float(np.median(list(norms.values())))
    return [k for k in sorted(norms) if norms[k] >= 1e-3 * median]


def compare(losses_p, losses_r, grad_p, grad_r, change_p, change_r):
    """The training numbers: the first step's loss gap (relative), the
    worst leaf's first-gradient norm gap, and the median leaf's change-norm
    gap after the three steps.

    Adam's first update is lr * g / (|g| + eps) a component, about lr
    times g's sign, so a component whose gradient is at the level of fp32
    round-off can take either sign and move by 2 lr; the later steps' loss
    and the worst leaf's change then swing from seed to seed (see
    :func:`look`).  The first step's loss and the median leaf's change do
    not."""
    return [('first_loss_gap', abs(losses_p[0] - losses_r[0]) / losses_r[0]),
            ('first_grad_gap', max(_leaf_gaps(grad_p, grad_r, sorted(grad_r)))),
            ('median_change_gap',
             float(np.median(_leaf_gaps(change_p, change_r, _moved(grad_r)))))]


def look(losses_p, losses_r, grad_p, grad_r, change_p, change_r):
    """What the numbers compared leave out: each step's loss gap, the worst
    leaf's change gap, and the components of the first gradient whose sign
    the program and the reference disagree on, with the largest of their
    reference magnitudes over its leaf's largest."""
    flips, worst = 0, 0.0
    for k, g in grad_r.items():
        if not grad_p or k not in grad_p:
            continue
        differ = torch.sign(grad_p[k]) != torch.sign(g)
        flips += int(differ.sum())
        if differ.any():
            worst = max(worst, float(g[differ].abs().max()
                                     / g.abs().max()))
    return {'loss_gaps': [abs(p - r) / r for p, r in zip(losses_p, losses_r)],
            'worst_change_gap': max(_leaf_gaps(change_p, change_r,
                                               _moved(grad_r))),
            'first_grad_sign_flips': flips,
            'largest_flipped_share': worst}
