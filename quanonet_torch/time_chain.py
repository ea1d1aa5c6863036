"""
Times the block-chain kernels (B1f, its residual variant, and B1b with all
its launches) of one checkout on the card, at the flagship's shapes (Q5
Net40-2-20-2: nb 60, D 32; seeded random weights and inputs) and several
batch sizes: CUDA events around the wrapper (``chip_smoke.time_ms``) and
the kernels' own time in a profiler trace
(``chip_smoke.kernel_device_ms``), beside the bounds of
``chip_smoke.chain_bound`` / ``bwd_bound``.  It imports ``chip_smoke`` and
``quanonet_torch`` from ``--root``, so two checkouts (a parent commit
unpacked with ``git archive`` and the working tree) are timed by the same
code.  Run it as a file, from any directory:

    python quanonet_torch/time_chain.py --root . --label change \
        --out outputs/b1/change_1.json
    python quanonet_torch/time_chain.py --summarize outputs/b1/*.json

Compare two checkouts only within one call, in turns (parent, change,
change, parent); ``--summarize`` prints each label's median over its runs.
"""
import argparse
import json
import os
import subprocess
import sys

NS = (1, 100, 1000, 8192)
FLAGSHIP = (5, (40, 2, 20, 2))


def time_checkout(root, ns, reps, tile=None):
    """{N: times} for the checkout at ``root`` on the current card; with
    ``tile``, that row of the checkout's launch-geometry table in place of
    ``chain_geometry``'s choice."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [q for q in sys.path
                            if os.path.abspath(q or '.') != here]
    import numpy as np
    import torch
    import chip_smoke
    from quanonet_torch.ops import cuda_hea, hea
    if not torch.cuda.is_available():
        raise SystemExit("time_chain: no CUDA device")
    if tile is not None:
        cuda_hea.chain_geometry = (
            lambda n, d, sms: cuda_hea.tile_geometry(d, tile, n))
    dev = torch.device('cuda')
    nq, net = FLAGSHIP
    spec = hea.quanonet_spec(nq, net)
    rows = []
    for n in ns:
        rng = np.random.RandomState(3000 + n)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        x = torch.tensor(rng.uniform(-4, 4, (n, spec.total_encode))
                         .astype(np.float32), device=dev)
        g = [torch.tensor(rng.randn(n, spec.dim).astype(np.float32),
                          device=dev) for _ in range(2)]
        ops = hea.prepare_chain(spec, w, x)
        _, _, st_r, st_i = cuda_hea.chain_forward(*ops, save_residuals=True)

        def fwd():
            cuda_hea.chain_forward(*ops)

        def fwd_saved():
            cuda_hea.chain_forward(*ops, save_residuals=True)

        def bwd():
            cuda_hea.chain_backward(*ops, st_r, st_i, *g)
        nb, d = spec.n_blocks, spec.dim
        row = {"N": n, "nb": nb, "D": d,
               "fwd_ms": chip_smoke.time_ms(fwd, reps),
               "fwd_device_ms": chip_smoke.kernel_device_ms(
                   fwd, 'hea_chain_fwd'),
               "fwd_saved_ms": chip_smoke.time_ms(fwd_saved, reps),
               "fwd_saved_device_ms": chip_smoke.kernel_device_ms(
                   fwd_saved, 'hea_chain_fwd'),
               "bwd_ms": chip_smoke.time_ms(bwd, reps),
               # every launch of the backward: the sweep, Mbar, the slices
               "bwd_device_ms": chip_smoke.kernel_device_ms(bwd, None),
               "bwd_device_ms_by_kernel": chip_smoke._profiled(
                   bwd, 20).get("top_device_ms_per_step"),
               "fwd_bound_ms": chip_smoke.chain_bound(nb, n, d)[0],
               "bwd_bound_ms": chip_smoke.bwd_bound(nb, n, d)[0]}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if hasattr(cuda_hea, 'chain_geometry'):
            row["geometry"] = cuda_hea.chain_geometry(n, d, sms)._asdict()
        row["mbar_splits"] = cuda_hea.mbar_splits(nb, n, d, sms)
        rows.append(row)
    return rows


def summarize(paths):
    """Median over the runs of each label, one line per (label, N)."""
    import numpy as np
    runs = [json.load(open(p)) for p in paths]
    keys = ("fwd_ms", "fwd_device_ms", "fwd_saved_ms", "fwd_saved_device_ms",
            "bwd_ms", "bwd_device_ms")
    out = {}
    for label in sorted({r["label"] for r in runs}):
        mine = [r for r in runs if r["label"] == label]
        for i, row in enumerate(mine[0]["rows"]):
            med = {k: float(np.median([m["rows"][i][k] for m in mine
                                       if m["rows"][i][k] is not None]))
                   for k in keys}
            out[f"{label} N={row['N']}"] = {
                "runs": len(mine), **med,
                "fwd_bound_ms": row["fwd_bound_ms"],
                "bwd_bound_ms": row["bwd_bound_ms"]}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--root', default='.', help='checkout whose kernels to time')
    p.add_argument('--label', default='tree')
    p.add_argument('--out', default=None, help='JSON file to write')
    p.add_argument('--ns', type=int, nargs='+', default=list(NS))
    p.add_argument('--reps', type=int, default=30)
    p.add_argument('--tile', type=int, default=None,
                   help="time this row of cuda_hea.TILES instead of "
                        "chain_geometry's choice")
    p.add_argument('--summarize', nargs='+', default=None, metavar='JSON',
                   help='print the medians of earlier runs and exit')
    args = p.parse_args(argv)
    if args.summarize:
        for k, v in summarize(args.summarize).items():
            print(json.dumps({k: v}))
        return 0
    root = os.path.abspath(args.root)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    result = {"label": args.label, "root": args.root, "nvidia_smi": smi,
              "tile": args.tile,
              "rows": time_checkout(root, args.ns, args.reps, args.tile)}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
