#!/usr/bin/env python3
"""
Noise-robustness study on the port (counterpart of
scripts/noise_robustness_study.py): does training THROUGH the hardware
noise channel beat deploying an ideally-trained model on the same noisy
hardware?

    python -m quanonet_torch.studies.noise_robustness [--device cuda|cpu]
        [--noise_p P] [--readout_p R] [--epochs E] [--traj T]
        [--eval_traj T] [--prefix DIR] [--channel depolarizing|t1t2]
        [--damp_gamma G] [--dephase_p F] [--out CSV]

Protocol (Antideriv Q2, the reference demo configuration, _common.BASE):
  1. train IDEAL: standard training, exact expectations;
  2. train NOISE-AWARE: the same seed and budget, the forward the mean
     over ``--traj`` Pauli trajectories of the channel at noise_p = P
     (+ readout), resampled every step;
  3. evaluate both best checkpoints under noisy inference at
     p in {0, P/2, P, 2P} (``--eval_traj`` trajectories), plus ZNE(1, 2, 3)
     at P.  ``--channel t1t2`` trains and evaluates through amplitude
     damping and pure dephasing at (γ, p_φ) x {0, 1/2, 1, 2} instead, with
     no ZNE (Richardson scaling applies to noise_p only).

On ``cuda`` the depolarizing arm takes the fold route
(ops/noise.noise_route: B1f a trajectory, B4f a call, B1b/B4b under
autograd); damping takes the plain physical-frame route.  Runs on the
card and raises without one unless ``--device cpu``.  Writes the JAX
script's CSV layout to ``--out`` (default docs/noise_robustness_torch.csv,
or docs/noise_robustness_t1t2_torch.csv; relative to the current
directory) and prints the verdict line; exit 0 when the noise-trained
model wins at its training noise level, 1 otherwise.
"""
import argparse
import os
import sys

from quanonet_torch import resolve_device
from quanonet_torch.studies._common import base_config, train_one, write_csv

ZNE_SCALES = (1.0, 2.0, 3.0)


def eval_under_noise(ckpt, data, p, readout_p, zne=None, traj=64, seed=0,
                     damp_gamma=None, dephase_p=None, device=None):
    """Rel-L2 of the checkpoint ``ckpt`` on ``data``'s test set under the
    channel (p, readout_p[, damp_gamma, dephase_p]) with ``traj``
    trajectories, ZNE-extrapolated over the scales ``zne`` when given."""
    from quanonet_torch.infer import evaluate, load_model, predict, \
        zne_predict
    # 0.0 values are passed explicitly: _resolve_config treats None as
    # "no override", so a _Noise…G…F… run dir's parsed channels would
    # otherwise leak into the ideal evaluation
    if p > 0 or readout_p or damp_gamma or dephase_p:
        overrides = dict(noise_p=p, noise_traj=traj, readout_p=readout_p,
                         damp_gamma=damp_gamma or 0.0,
                         dephase_p=dephase_p or 0.0)
    else:
        overrides = dict(noise_p=0.0, readout_p=0.0,
                         damp_gamma=0.0, dephase_p=0.0)
    model, cfg = load_model(
        ckpt, branch_in=data['test_branch_input'].shape[1],
        trunk_in=data['test_trunk_input'].shape[1], device=device,
        **overrides)
    if zne:
        preds = zne_predict(model, data['test_branch_input'],
                            data['test_trunk_input'], cfg=cfg,
                            scales=tuple(zne), shot_seed=seed)
    else:
        preds = predict(model, data['test_branch_input'],
                        data['test_trunk_input'], cfg=cfg, shot_seed=seed)
    return evaluate(preds, data['test_output'])['rel_l2']


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--noise_p', type=float, default=0.02,
                    help='training/deployment channel strength P')
    ap.add_argument('--readout_p', type=float, default=0.01)
    ap.add_argument('--epochs', type=int, default=300)
    ap.add_argument('--traj', type=int, default=8,
                    help='training trajectories per step')
    ap.add_argument('--eval_traj', type=int, default=64)
    ap.add_argument('--prefix', default='outputs_noise_study')
    ap.add_argument('--channel', choices=('depolarizing', 't1t2'),
                    default='depolarizing',
                    help="t1t2: train/eval through amplitude damping + "
                         "pure dephasing (ops/noise.py) instead of the "
                         "depolarizing channel; no ZNE (Richardson scaling "
                         "applies to noise_p only)")
    ap.add_argument('--damp_gamma', type=float, default=0.01,
                    help='t1t2 mode: per-block T1 damping γ')
    ap.add_argument('--dephase_p', type=float, default=0.003,
                    help='t1t2 mode: per-block T2 Z-flip prob')
    ap.add_argument('--out', default=None,
                    help='CSV, relative to the current directory (default '
                         'docs/noise_robustness_torch.csv, t1t2: '
                         'docs/noise_robustness_t1t2_torch.csv)')
    ap.add_argument('--device', default='cuda', help='cuda or cpu')
    return ap


def verdict(rows, channel='depolarizing', noise_p=0.02, damp_gamma=0.01,
            dephase_p=0.003):
    """The JAX script's verdict on ``rows``: -> (ideal-trained rel-L2 at
    the deployment noise, noise-trained rel-L2 there, label, wins)."""
    if channel == 't1t2':
        def get(trained):
            return next(r['rel_l2'] for r in rows
                        if r['trained'] == trained
                        and r['eval_damp_gamma'] == damp_gamma)
        ideal_at_p, robust_at_p = get('ideal'), get('noise_aware')
        label = f"T1/T2 γ={damp_gamma}, p_φ={dephase_p}"
    else:
        def get(trained):
            return next(r['rel_l2'] for r in rows
                        if r['trained'] == trained
                        and r['eval_noise_p'] == noise_p and r['zne'] == '')
        ideal_at_p, robust_at_p = get('ideal'), get('noise_aware')
        label = f"p={noise_p}"
    return ideal_at_p, robust_at_p, label, robust_at_p < ideal_at_p


def verdict_line(ideal_at_p, robust_at_p, label, wins):
    return (f"VERDICT @ deployment noise {label}: ideal-trained "
            f"{ideal_at_p:.4f} vs noise-trained {robust_at_p:.4f} -> "
            f"{'noise-aware training WINS' if wins else 'no win'}")


def run(args):
    """The study for parsed ``args``, printing its verdict line; -> {"rows",
    "verdict", "verdict_line", "launches", "out"}: the CSV's rows, the
    verdict tuple and line, and each training arm's kernel launches (train
    and evaluate) beside the evaluations' total."""
    from quanonet_torch.data.manager import DataManager
    from quanonet_torch.profile_step import launch_counts
    device = str(resolve_device(args.device))
    P = args.noise_p
    if args.out is None:
        args.out = os.path.join(
            'docs', 'noise_robustness_torch.csv'
            if args.channel == 'depolarizing'
            else 'noise_robustness_t1t2_torch.csv')
    base = base_config(args.epochs, args.prefix, device)
    launches = {'ideal': {}, 'noise_aware': {}}

    print(f"=== training IDEAL (epochs={args.epochs}) ===", flush=True)
    ideal_dir = train_one(base, launches['ideal'])
    if args.channel == 't1t2':
        G, F = args.damp_gamma, args.dephase_p
        print(f"=== training NOISE-AWARE (T1/T2: γ={G}, p_φ={F}, "
              f"traj={args.traj}) ===", flush=True)
        noisy_dir = train_one(dict(base, damp_gamma=G, dephase_p=F,
                                   noise_traj=args.traj),
                              launches['noise_aware'])
    else:
        print(f"=== training NOISE-AWARE (P={P}, R={args.readout_p}, "
              f"traj={args.traj}) ===", flush=True)
        noisy_dir = train_one(dict(base, noise_p=P, noise_traj=args.traj,
                                   readout_p=args.readout_p),
                              launches['noise_aware'])

    # the test set the Solver trained against (its data_dir)
    data = DataManager(dict(base), data_dir=os.path.join(
        args.prefix, '..', 'data')).get_data()

    def score(ckpt, p, ro, **kw):
        return eval_under_noise(ckpt, data, p, ro, traj=args.eval_traj,
                                device=device, **kw)
    before = launch_counts()
    rows = []
    if args.channel == 't1t2':
        G, F = args.damp_gamma, args.dephase_p
        levels = [(0.0, 0.0), (G / 2, F / 2), (G, F), (2 * G, 2 * F)]
        for name, d in (('ideal', ideal_dir), ('noise_aware', noisy_dir)):
            ckpt = os.path.join(d, 'best_model.npz')
            for g, f_ in levels:
                r = score(ckpt, 0.0, 0.0, damp_gamma=g, dephase_p=f_)
                rows.append(dict(trained=name, eval_damp_gamma=g,
                                 eval_dephase_p=f_,
                                 rel_l2=round(float(r), 5)))
                print(f"  {name:12s} @ γ={g:<7g} p_φ={f_:<7g} "
                      f"rel_l2={r:.4f}", flush=True)
    else:
        levels = [(0.0, 0.0), (P / 2, args.readout_p), (P, args.readout_p),
                  (2 * P, args.readout_p)]
        for name, d in (('ideal', ideal_dir), ('noise_aware', noisy_dir)):
            ckpt = os.path.join(d, 'best_model.npz')
            for p, ro in levels:
                r = score(ckpt, p, ro)
                rows.append(dict(trained=name, eval_noise_p=p,
                                 eval_readout_p=ro,
                                 zne='', rel_l2=round(float(r), 5)))
                print(f"  {name:12s} @ p={p:<6g} ro={ro:<5g} rel_l2={r:.4f}",
                      flush=True)
            r = score(ckpt, P, args.readout_p, zne=ZNE_SCALES)
            rows.append(dict(trained=name, eval_noise_p=P,
                             eval_readout_p=args.readout_p, zne='1-2-3',
                             rel_l2=round(float(r), 5)))
            print(f"  {name:12s} @ p={P:<6g} + ZNE(1,2,3)   rel_l2={r:.4f}",
                  flush=True)
    after = launch_counts()
    launches['evaluations'] = {k: after[k] - before[k] for k in after}

    write_csv(args.out, rows)
    print(f"wrote {args.out}")
    v = verdict(rows, args.channel, P, args.damp_gamma, args.dephase_p)
    print("\n" + verdict_line(*v))
    return {"rows": rows, "out": args.out, "launches": launches,
            "verdict": v, "verdict_line": verdict_line(*v)}


def main(argv=None):
    return 0 if run(parser().parse_args(argv))["verdict"][3] else 1


if __name__ == '__main__':
    sys.exit(main())
