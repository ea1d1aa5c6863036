#!/usr/bin/env python3
"""
Component timing of the Q10 training step on the port (counterpart of the
root profile_pfused.py and profile_fused.py): where do the step's time and
device rows go?

    python -m quanonet_torch.profile_q10 [--qubits 10] [--net 40,2,20,2]
        [--batch 100] [--iters 300] [--device cuda|cpu]
        [--out_pfused docs/pfused_profile_torch.json]
        [--out_fused docs/fused_profile_torch.json]

PyTorch runs eagerly, so each component is a plain loop (profile_step.py's
protocol): a warm-up, then calls between two CUDA events (the host clock
on the CPU), in 3 rounds of ``--iters`` / 3 calls with a profile's
components in turns (ms a call: the median round); then the device rows a
call and the card's busy share from a torch.profiler window
(profile_step.busy_share), and the kernel launches a call.

'pfused' components (the engine 'auto' takes at 8..14 qubits on a card;
on the CPU the same engine runs the kernels' plain versions,
fused_gates.chain_fused_x):

  full_step        loss, backward and the Solver's Adam (build_optimizer:
                   torch.optim.Adam) through the model solver.build_model
                   builds, the loss as the Solver's step computes it
  fwd_bwd          the same without the optimizer
  fwd_infer        B2f's primal path, cuda_fused.forward_pfused under
                   no_grad, and the expectation
  build_unitaries  fused_gates.build_group_unitaries forward and backward
  phases_tiling    the kernels' angle operand (fused_gates.block_angles):
                   B2f builds the phases from the angles on the card, so
                   the port has no phase tensor and no TPU relayout

'fused' components (the grouped-kron engine, fused_gates.forward_fused):
fwd_full and the forward with one stage removed (fwd_no_ring,
fwd_no_hadamard, fwd_no_diag, fwd_group0_only: only the 7-qubit group's
products), each by :func:`ablated_forward` under no_grad; build_unitaries;
full_step with the engine 'fused'.

Gates (``gates`` in the output; exit 1 if one fails): full_step is the
Solver's step (losses bit-equal to make_train_epoch's over 5 steps from
the same state and batches, each engine); fwd_full is bit-equal to
forward_fused; every ablation is finite; on the card one B2f and one B2b
a full_step and fwd_bwd, one B2f and no B2b a fwd_infer, none elsewhere.
Runs on the card and raises without one unless ``--device cpu``; the
results carry the card's name and power limit.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.ops import cuda_fused
from quanonet_torch.ops import fused_gates as fg
from quanonet_torch.ops.gates import ring_apply
from quanonet_torch.ops.hamiltonian import simple_ham_diag
from quanonet_torch.ops.hea import encoding_phases, quanonet_spec
from quanonet_torch.profile_step import (
    WARMUP, busy_share, card_line, event_ms, launch_counts, launches_since,
)
from quanonet_torch.solver import build_model, build_optimizer, \
    make_train_epoch

LR = 1e-4
PARITY_STEPS = 5
ROUNDS = 3
BRANCH_IN, TRUNK_IN = 100, 2     # the Advection flagship's inputs


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def ablated_forward(spec, weights, x, skip=()):
    """fused_gates.forward_fused with the named stages removable: 'ring',
    'hadamard', 'diag' and 'group1' (the groups narrower than 7 qubits).
    With nothing skipped it is forward_fused op for op (no remat: call it
    under no_grad)."""
    n = spec.n_qubits
    groups = fg.qubit_groups(n)
    gu = fg.build_group_unitaries(spec, weights)
    phi = encoding_phases(spec, x)                        # (nb, batch, D)
    ring = ring_apply(n)

    def block(sr, si, phi_b, s0, ld):
        if 'hadamard' not in skip:
            sr, si = fg._apply_hadamard(sr, si, groups, n)
        if 'diag' not in skip:
            dr, di = torch.cos(phi_b), -torch.sin(phi_b)
            sr, si = dr * sr - di * si, dr * si + di * sr
        if ld == 0:
            return (sr, si) if 'hadamard' in skip else \
                fg._apply_hadamard(sr, si, groups, n)
        for d in range(ld):
            for gi, (off, k) in enumerate(groups):
                if 'group1' in skip and k < fg.MAX_GROUP_QUBITS:
                    continue
                sr, si = fg._apply_group(sr, si, gu[gi][0][s0 + d],
                                         gu[gi][1][s0 + d], off, k, n)
            if 'ring' not in skip:
                sr, si = ring(sr, si)
        return sr, si

    batch = x.shape[0]
    sr = torch.zeros((batch, spec.dim), dtype=torch.float32, device=x.device)
    sr[:, 0] = 1.0
    si = torch.zeros_like(sr)
    s0 = 0
    for b, (_, ld) in enumerate(spec.block_configs):
        sr, si = block(sr, si, phi[b], s0, ld)
        s0 += ld
    return sr, si


ABLATIONS = {'fwd_full': (), 'fwd_no_ring': ('ring',),
             'fwd_no_hadamard': ('hadamard',), 'fwd_no_diag': ('diag',),
             'fwd_group0_only': ('group1',)}


class Problem:
    """The seeded inputs of one profile: the circuit's weights, angles and
    diagonal (JAX script's draws), and a model batch (branch, trunk,
    target) of ``PARITY_STEPS`` batches for the step."""

    def __init__(self, nq, net, batch, device):
        self.nq, self.net, self.batch, self.device = nq, net, batch, device
        self.spec = quanonet_spec(nq, net)
        rng = np.random.RandomState(0)
        t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
        self.w = t(rng.uniform(-np.pi, np.pi, self.spec.weight_shape())
                   .astype(np.float32))
        self.x = t(rng.uniform(-2, 2, (batch, self.spec.n_blocks * nq))
                   .astype(np.float32))
        self.diag = t(np.asarray(simple_ham_diag(nq, -5, 5), np.float32))
        self.batches = [tuple(t(a) for a in (
            rng.randn(batch, BRANCH_IN).astype(np.float32),
            rng.rand(batch, TRUNK_IN).astype(np.float32),
            rng.randn(batch, 1).astype(np.float32)))
            for _ in range(PARITY_STEPS)]

    def model(self, engine):
        """(model, optimizer) as the Solver builds them, from seed 0."""
        config = {'model_type': 'QuanONet', 'num_qubits': self.nq,
                  'net_size': list(self.net), 'scale_coeff': 0.1,
                  'engine': engine, 'learning_rate': LR}
        data = {'train_branch_input': self.batches[0][0],
                'train_trunk_input': self.batches[0][1]}
        model, _ = build_model(config, data, self.device,
                               torch.Generator().manual_seed(0))
        return model, build_optimizer(config, 1, model.parameters())


def step_fn(model, opt, batch):
    """One training step with the Solver's loss (make_train_epoch's
    batch_loss on a full batch: sum(sq · mask) / max(sum(mask), 1)); ->
    a function returning the loss."""
    b, t, y = batch
    mask = torch.ones(y.shape[0], device=y.device)

    def step():
        sq = (model(b, t) - y) ** 2 * mask[:, None]
        loss = sq.sum() / torch.clamp(mask.sum() * 1, min=1.0)
        if opt is not None:
            opt.zero_grad()
        else:
            model.zero_grad(set_to_none=True)
        loss.backward()
        if opt is not None:
            opt.step()
        return loss
    return step


def solver_parity(prob, engine):
    """Losses of PARITY_STEPS full_steps against make_train_epoch's on the
    same state and batches (one batch an epoch): bit-equal?"""
    model, opt = prob.model(engine)
    mine = [step_fn(model, opt, batch)().item() for batch in prob.batches]
    model, opt = prob.model(engine)
    epoch = make_train_epoch(model, opt, prob.batch, prob.batch, 1)
    perm = torch.arange(prob.batch)
    solver = [epoch(perm, (b, t), y)[0].item() for b, t, y in prob.batches]
    return {"steps": PARITY_STEPS, "full_step_losses": mine,
            "solver_losses": solver, "bit_equal": mine == solver}


def components(fns, iters, device, rounds=ROUNDS):
    """Each component's ms a call by events (the median of ``rounds``
    rounds of iters // rounds calls, the components in turns), its
    launches a call and its busy share."""
    per = max(1, iters // rounds)
    times = {name: [] for name in fns}
    launches = {name: {} for name in fns}
    calls = dict.fromkeys(fns, 0)
    for r in range(rounds):
        warm = WARMUP if r == 0 else 1
        for name, fn in fns.items():
            before = launch_counts()
            times[name].append(event_ms(fn, per, device, warmup=warm))
            for k, v in launches_since(before).items():
                launches[name][k] = launches[name].get(k, 0) + v
            calls[name] += per + warm
    rows = {}
    for name, fn in fns.items():
        ms = float(np.median(times[name]))
        rows[name] = {"ms": ms, "ms_rounds": times[name],
                      "launches_per_call": {k: v / calls[name] for k, v in
                                            launches[name].items()},
                      **busy_share(fn, device, ms)}
        log(f"  {name}: {ms:.3f} ms  {rows[name]['launches_per_call']}  "
            f"busy {rows[name].get('device_busy_share')}")
    return rows


def profile_pfused(prob, iters):
    dev, spec, w, x, diag = prob.device, prob.spec, prob.w, prob.x, prob.diag
    model, opt = prob.model('pfused')

    def fwd_infer():
        with torch.no_grad():
            sr, si = cuda_fused.forward_pfused(spec, w, x)
            return (sr * sr + si * si) @ diag

    def phases_tiling():
        with torch.no_grad():
            return fg.block_angles(spec, x)
    return components({
        'full_step': step_fn(model, opt, prob.batches[0]),
        'fwd_bwd': step_fn(model, None, prob.batches[0]),
        'fwd_infer': fwd_infer, 'build_unitaries': build_step(prob),
        'phases_tiling': phases_tiling}, iters, dev)


def build_step(prob):
    """build_group_unitaries forward and backward (a sum of squares)."""
    w = prob.w.clone().requires_grad_()

    def step():
        gu = fg.build_group_unitaries(prob.spec, w)
        loss = sum((u[0] ** 2).sum() + (u[1] ** 2).sum() for u in gu.values())
        (g,) = torch.autograd.grad(loss, w)
        return g
    return step


def profile_fused(prob, iters):
    dev, spec, w, x = prob.device, prob.spec, prob.w, prob.x
    fns, finite = {}, {}
    for name, skip in ABLATIONS.items():
        def fwd(skip=skip):
            with torch.no_grad():
                sr, si = ablated_forward(spec, w, x, skip)
                return (sr * sr + si * si) @ prob.diag
        finite[name] = bool(torch.isfinite(fwd()).all())
        fns[name] = fwd
    fns['build_unitaries'] = build_step(prob)
    model, opt = prob.model('fused')
    fns['full_step'] = step_fn(model, opt, prob.batches[0])
    out = components(fns, iters, dev)
    with torch.no_grad():
        got = ablated_forward(spec, w, x)
        want = fg.forward_fused(spec, w, x)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    return out, {"ablations_finite": finite, "fwd_full_bit_equal": equal}


def launch_gates(rows, device):
    """On the card: B2f and B2b a call as the component runs them."""
    if device.type != 'cuda':
        return {}
    want = {'full_step': (1, 1), 'fwd_bwd': (1, 1), 'fwd_infer': (1, 0),
            'build_unitaries': (0, 0), 'phases_tiling': (0, 0)}
    return {f"launches {name}": (
        rows[name]['launches_per_call'].get('fused_chain_fwd', 0),
        rows[name]['launches_per_call'].get('fused_chain_bwd', 0)) == n
        for name, n in want.items()}


def meta(prob, iters, engine):
    dev = prob.device
    return {"qubits": prob.nq, "net": list(prob.net), "batch": prob.batch,
            "iters": iters, "engine": engine, "platform": dev.type,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == 'cuda' else 'cpu'),
            "nvidia_smi": card_line(dev), "torch": torch.__version__,
            "timing": f"CUDA events around each loop (host clock on the "
                      f"CPU), the median of {ROUNDS} rounds, the components "
                      f"in turns"}


def run(nq, net, batch, iters, device):
    """Both profiles: (pfused result, fused result), each with its gates."""
    prob = Problem(nq, net, batch, device)
    log(f"device: {device}  Q{nq} net={net} bs={batch} iters={iters}")
    pf = profile_pfused(prob, iters)
    pf_parity = solver_parity(prob, 'pfused')
    pfused = {"meta": meta(prob, iters, 'pfused'), "ms_per_call": pf,
              "solver_parity": pf_parity,
              "phases_tiling_note":
                  "the port's angle operand (nb, N, n): B2f builds the "
                  "phases from the angles on the card; no phase tensor and "
                  "no TPU relayout exist on this path",
              "gates": {"full_step is the Solver's step":
                        pf_parity["bit_equal"],
                        **launch_gates(pf, device)}}
    fu, checks = profile_fused(prob, iters)
    fu_parity = solver_parity(prob, 'fused')
    fused = {"meta": meta(prob, iters, 'fused'), "ms_per_call": fu,
             "solver_parity": fu_parity, **checks,
             "gates": {"full_step is the Solver's step":
                       fu_parity["bit_equal"],
                       "fwd_full is forward_fused": checks[
                           "fwd_full_bit_equal"],
                       **{f"finite {k}": v for k, v in
                          checks["ablations_finite"].items()}}}
    return pfused, fused


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--qubits', type=int, default=10)
    ap.add_argument('--net', default='40,2,20,2')
    ap.add_argument('--batch', type=int, default=100)
    ap.add_argument('--iters', type=int, default=300)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out_pfused', default='docs/pfused_profile_torch.json')
    ap.add_argument('--out_fused', default='docs/fused_profile_torch.json')
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    net = tuple(int(v) for v in args.net.split(','))
    pfused, fused = run(args.qubits, net, args.batch, args.iters, dev)
    for path, res in ((args.out_pfused, pfused), (args.out_fused, fused)):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            json.dump(res, f, indent=1)
        log(f"wrote {path}")
        print(json.dumps(res), flush=True)
    failed = [k for res in (pfused, fused)
              for k, v in res["gates"].items() if not v]
    if failed:
        log("FAILED: " + ", ".join(failed))
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
