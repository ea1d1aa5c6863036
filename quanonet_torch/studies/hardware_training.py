#!/usr/bin/env python3
"""
Hardware-trainability study on the port (counterpart of
scripts/hardware_training_study.py): what does training with the
gradients a real QPU can provide (ops/param_shift.py) cost in quality and
throughput against exact autodiff?  Every arm runs through the same
Solver on the same budget.

    python -m quanonet_torch.studies.hardware_training [--quick]
        [--epochs E] [--match_seeds K] [--prefix DIR] [--out CSV]
        [--device cuda|cpu]

Arms (Antideriv Q2, the noise study's configuration, _common.BASE):

  autodiff            exact gradients through the statevector (baseline;
                      B1f/B1b and B4f/B4b on the card)
  shift               the exact two-point parameter-shift rule: the same
                      gradient, so its quality must MATCH autodiff's; its
                      throughput shows the 2·P-evaluation fan-out a QPU
                      pays (B1f and B4f only, as param_shift counts them)
  spsa                Spall's two-evaluation simultaneous perturbation
  shift @ N shots     finite-shot sampled expectations in every shifted
                      evaluation, N in {256, 8192}
  spsa @ 1024 shots   SPSA under sampled readout

autodiff and shift run on ``--match_seeds`` seeds, the others on seed 0;
without ``--quick`` also spsa_10x, shift@256, shift@8192 and spsa@1024,
each 10x arm under its own ``_10x`` prefix (run IDs do not encode the
epochs).  ``--quick``: autodiff, shift and spsa at QUICK_EPOCHS epochs on
one seed (a module constant, as in the JAX script, where ``--quick``
ignores ``--epochs``).

Writes the JAX script's CSV layout to ``--out`` (default
docs/hardware_training_torch.csv, relative to the current directory) and
prints the verdicts: shift matches autodiff's rel-L2 within 10 % on each
seed, and shift@8192 <= 1.05 x shift@256; exit 1 when one fails.  Runs on
the card and raises without one unless ``--device cpu``.
"""
import argparse
import sys

from quanonet_torch import resolve_device
from quanonet_torch.studies._common import (
    BASE, base_config, harvest, train_one, write_csv,
)

QUICK_EPOCHS = 30
MATCH_REL = 0.10       # shift's rel-L2 against autodiff's, relative
SHOTS_SLACK = 1.05     # more shots may not hurt (5 % slack)


def evals_per_step(grad_method, num_qubits, net_size):
    """Circuit evaluations per optimizer step, the cost that matters on
    hardware (each is one batch of QPU jobs).  autodiff: 1 (forward and
    backward through the simulator's state, impossible on a QPU); shift:
    1 primal + 2 per shifted parameter (3·nq ansatz angles a sublayer and
    one encode angle a (block, qubit)); spsa: 2."""
    if grad_method == 'autodiff':
        return 1
    if grad_method == 'spsa':
        return 2
    bd, bld, td, tld = net_size
    subs = bd * bld + td * tld
    n_ansatz = subs * 3 * num_qubits
    n_encode = (bd + td) * num_qubits
    return 1 + 2 * (n_ansatz + n_encode)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--epochs', type=int, default=300)
    ap.add_argument('--match_seeds', type=int, default=3,
                    help='seeds for the autodiff/shift arms (the '
                         'shift≡autodiff verdict holds per-seed); the '
                         'other arms run seed 0 only')
    ap.add_argument('--prefix', default='outputs_hw_study')
    ap.add_argument('--quick', action='store_true')
    ap.add_argument('--out', default='docs/hardware_training_torch.csv',
                    help='CSV, relative to the current directory')
    ap.add_argument('--device', default='cuda', help='cuda or cpu')
    return ap


def arms(args):
    """(name, config changes) of every arm the flags ask for, in order;
    -> (arms, the budget's epochs, the seeds of the match arms)."""
    epochs = QUICK_EPOCHS if args.quick else args.epochs
    n_match = 1 if args.quick else max(1, args.match_seeds)
    out = [('autodiff', dict(seed=k)) for k in range(n_match)]
    out += [('shift', dict(grad_method='shift', seed=k))
            for k in range(n_match)]
    out += [('spsa', dict(grad_method='spsa'))]
    if not args.quick:
        # run IDs do not encode num_epochs (reference contract), so arms
        # that differ ONLY by epochs need their own prefix or the second
        # one resume-skips into the first's experiment dir
        out += [
            ('spsa_10x', dict(grad_method='spsa', num_epochs=epochs * 10,
                              prefix=args.prefix + '_10x')),
            ('shift@256', dict(grad_method='shift', train_shots=256)),
            ('shift@8192', dict(grad_method='shift', train_shots=8192)),
            ('spsa@1024', dict(grad_method='spsa', train_shots=1024,
                               num_epochs=epochs * 10,
                               prefix=args.prefix + '_10x')),
        ]
    return out, epochs, n_match


def verdicts(rows, n_match):
    """The JAX script's verdict lines on ``rows``: -> [(line, ok)]."""
    def get(name, seed=0):
        return next((r['rel_l2'] for r in rows
                     if r['method'] == name and r.get('seed', 0) == seed),
                    None)
    out = []
    for k in range(n_match):
        auto, shift = get('autodiff', k), get('shift', k)
        if auto is None or shift is None:
            continue
        match = abs(shift - auto) <= MATCH_REL * max(auto, 1e-9)
        out.append((f"VERDICT shift≡autodiff (seed {k}): {shift:.4f} vs "
                    f"{auto:.4f} -> {'MATCH' if match else 'MISMATCH'}",
                    match))
    lo, hi = get('shift@256'), get('shift@8192')
    if lo is not None and hi is not None:
        mono = hi <= lo * SHOTS_SLACK
        out.append((f"VERDICT shot budget: shift@8192 {hi:.4f} <= "
                    f"shift@256 {lo:.4f} (+5%) -> "
                    f"{'PASS' if mono else 'FAIL'}", mono))
    return out


def run(args):
    """The study for parsed ``args``, printing its verdict lines; ->
    {"rows", "verdicts", "launches", "out"}: the CSV's rows, the verdict
    lines with their outcome, and each arm's kernel launches (train and
    evaluate) by its row's position."""
    device = str(resolve_device(args.device))
    todo, epochs, n_match = arms(args)
    base = base_config(epochs, args.prefix, device)
    rows, launches = [], []
    for name, extra in todo:
        print(f"=== arm {name} ===", flush=True)
        counts = {}
        d = train_one(dict(base, **extra), counts)
        rel, sps = harvest(d)
        gm = extra.get('grad_method', 'autodiff')
        rows.append(dict(method=name, grad_method=gm,
                         seed=extra.get('seed', 0),
                         train_shots=extra.get('train_shots', ''),
                         epochs=extra.get('num_epochs', base['num_epochs']),
                         rel_l2=round(rel, 5),
                         circuit_evals_per_step=evals_per_step(
                             gm, BASE['num_qubits'], BASE['net_size']),
                         samples_per_sec_incl_compile=round(sps, 1)))
        launches.append(counts)
        print(f"  {name:12s} rel_l2={rel:.4f}  {sps:,.0f} samples/s",
              flush=True)
    write_csv(args.out, rows)
    print(f"wrote {args.out}")
    lines = verdicts(rows, n_match)
    for line, _ in lines:
        print(line)
    return {"rows": rows, "out": args.out, "launches": launches,
            "verdicts": lines}


def main(argv=None):
    return 0 if all(ok for _, ok in run(parser().parse_args(argv))[
        "verdicts"]) else 1


if __name__ == '__main__':
    sys.exit(main())
