"""
The out-of-distribution study of the repository's visualization.ipynb on
the port: the shipped Advection and RDiffusion anchors (Q5 Net40-2-20-2,
trained on Gaussian-random-field inputs of length scale 0.2) fed sin 2πx
and sin 4πx, against the PDE solvers' truth.

    python -m quanonet_torch.ood [--operator Advection|RDiffusion|all]
        [--device cuda|cpu] [--out docs/ood_torch.json] [--plot PNG]

For each case (:data:`CONFIGS` x :data:`OOD_INPUTS`, num_cal 100): the
truth from data/generation.solve_advection_pde(100, u0_cal=u0) or
solve_rdiffusion_pde(100, 0.2, u0_cal=u0) on its (x, t) grid, the
prediction of infer.load_model / infer.predict at batch 4096 on the same
grid (branch u0 tiled, trunk the grid's (x, t)), and rel-L2
||pred - truth|| / (||truth|| + 1e-8).  ``--out`` (relative to the
current directory) gets the rel-L2s and grid shapes; the truth,
prediction and absolute error of every case go to the ``.npz`` of the
same name.  ``--plot`` draws the notebook's figure (truth, prediction,
abs error; a row a case) with matplotlib, and raises where it is not
installed.  Runs on the card unless ``--device cpu``; raises without one.
"""
import argparse
import json
import os
import sys

import numpy as np

from quanonet_torch.data import generation as gen
from quanonet_torch.infer import load_model, predict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, 'pretrained_weights')
NUM_CAL = 100
BATCH = 4096
CONFIGS = {
    'Advection': dict(
        ckpt=os.path.join(REF, 'Advection', 'Advection_QuanONet_Net40-2-20-'
                          '2_Q5_TF_S0.1_1000x100_Seed0', 'best_model.ckpt'),
        solver=lambda u0: gen.solve_advection_pde(NUM_CAL, u0_cal=u0)[0]),
    'RDiffusion': dict(
        ckpt=os.path.join(REF, 'RDiffusion', 'RDiffusion_QuanONet_Net40-2-'
                          '20-2_Q5_TF_S0.1_1000x100_Seed0', 'best_model.ckpt'),
        solver=lambda u0: gen.solve_rdiffusion_pde(NUM_CAL, 0.2,
                                                   u0_cal=u0)[0]),
}
_X = np.linspace(0, 1, NUM_CAL)
# (name, key in the .npz, u0 on the num_cal grid)
OOD_INPUTS = (('sin(2πx)', 'sin2pix', np.sin(2 * np.pi * _X)),
              ('sin(4πx)', 'sin4pix', np.sin(4 * np.pi * _X)))


def grid_inputs(u0, nx, nt):
    """(branch, trunk) on the notebook's grid: u0 tiled, (x, t) in [0, 1]^2
    with x the slow axis."""
    X, T = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, nt),
                       indexing='ij')
    trunk = np.stack([X.ravel(), T.ravel()], axis=1).astype(np.float32)
    branch = np.tile(u0.astype(np.float32), (trunk.shape[0], 1))
    return branch, trunk


def run_case(model, cfg, solver, u0):
    """(truth (x, t), prediction on its grid)."""
    truth = solver(u0.copy())
    nx, nt = truth.shape
    branch, trunk = grid_inputs(u0, nx, nt)
    pred = predict(model, branch, trunk, cfg=cfg, batch_size=BATCH)
    return truth, pred.reshape(nx, nt)


def rel_l2(pred, truth):
    return float(np.linalg.norm(pred - truth)
                 / (np.linalg.norm(truth) + 1e-8))


def study(operators, device=None):
    """-> (rows, arrays): a row a case (operator, input, rel-L2, grid
    shape) and {'<operator>/<key>/truth|pred|err': array}."""
    rows, arrays = [], {}
    for op in operators:
        model, cfg = load_model(CONFIGS[op]['ckpt'], branch_in=100,
                                trunk_in=2, device=device)
        for name, key, u0 in OOD_INPUTS:
            truth, pred = run_case(model, cfg, CONFIGS[op]['solver'], u0)
            rows.append({"operator": op, "input": name, "key": key,
                         "rel_l2": rel_l2(pred, truth),
                         "grid": list(truth.shape),
                         "engine": cfg['engine']})
            arrays.update({f"{op}/{key}/truth": truth,
                           f"{op}/{key}/pred": pred,
                           f"{op}/{key}/err": np.abs(pred - truth)})
    return rows, arrays


def plot(rows, arrays, path):
    """The notebook's figure, a row a case; needs matplotlib."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(len(rows), 3, figsize=(13, 3.6 * len(rows)),
                             squeeze=False)
    for i, r in enumerate(rows):
        pre = f"{r['operator']}/{r['key']}/"
        for col, (part, title) in enumerate([
                ('truth', f"{r['operator']} truth  u0={r['input']}"),
                ('pred', f"prediction (rel-L2 {r['rel_l2']:.1%})"),
                ('err', 'abs error')]):
            ax = axes[i, col]
            im = ax.imshow(arrays[pre + part].T, origin='lower',
                           aspect='auto', extent=[0, 1, 0, 1],
                           cmap='RdBu_r' if col < 2 else 'magma')
            ax.set_title(title)
            ax.set_xlabel('x')
            ax.set_ylabel('t')
            fig.colorbar(im, ax=ax, shrink=0.85)
    fig.suptitle('QuanONet Q5 on OOD inputs (quanonet_torch)')
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--operator', default='Advection',
                    choices=[*CONFIGS, 'all'])
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    ap.add_argument('--out', default='docs/ood_torch.json',
                    help='results file, relative to the current directory; '
                         'the arrays go to the .npz of the same name')
    ap.add_argument('--plot', default=None, metavar='PNG',
                    help="draw the notebook's figure (needs matplotlib)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    ops = list(CONFIGS) if args.operator == 'all' else [args.operator]
    rows, arrays = study(ops, args.device)
    result = {"rows": rows, "num_cal": NUM_CAL, "batch_size": BATCH,
              "device": args.device or 'cuda'}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    np.savez_compressed(os.path.splitext(args.out)[0] + '.npz', **arrays)
    if args.plot:
        plot(rows, arrays, args.plot)
    for r in rows:
        print(f"{r['operator']} {r['input']}: rel-L2 {r['rel_l2']:.4f}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
