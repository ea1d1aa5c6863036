"""
Times the chain kernels of one checkout on the card: CUDA events around the
wrapper (``chip_smoke.time_ms``) and the kernels' own time in a profiler
trace (``chip_smoke.kernel_device_ms``), beside the bounds of
``chip_smoke``.  ``--kernel block`` (the default): the block-chain kernels
(B1f, its residual variant, and B1b with all its launches) at the
flagship's shapes (Q5 Net40-2-20-2: nb 60, D 32) and several batch sizes.
``--kernel fused``: the fused-group chain kernels (B2f primal and residual,
B2b with each of its launches) at Q8, Q10 and Q12 for N = 1, 100 and 1000,
Q10 at N = 8192, Q14 at N = 32 and the Q16 forward at N = 8.  Weights and
inputs are seeded and random.  It imports ``chip_smoke`` and
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
# (qubits, net_size, N, backward) of the fused-group chain
FUSED_CASES = (
    *[(nq, net, n, True) for nq, net in ((8, (40, 2, 20, 2)),
                                          (10, (40, 2, 20, 2)),
                                          (12, (10, 2, 10, 2)))
      for n in (1, 100, 1000)],
    (10, (40, 2, 20, 2), 8192, True),
    (14, (5, 2, 5, 2), 32, True),
    (16, (5, 2, 5, 2), 8, False),
)


def _use_root(root):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [q for q in sys.path
                            if os.path.abspath(q or '.') != here]


def time_checkout(root, ns, reps, tile=None):
    """{N: times} for the checkout at ``root`` on the current card; with
    ``tile``, that row of the checkout's launch-geometry table in place of
    ``chain_geometry``'s choice."""
    _use_root(root)
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


def _fused_operands(fg, spec, w, x):
    """The checkout's kernel operands: the angle contract (u7t, u2, x as
    (nb, N, n)) where the checkout has it, else the phase contract (phi)."""
    if hasattr(fg, 'prepare_fused_chain_x'):
        return fg.prepare_fused_chain_x(spec, w, x)
    return fg.prepare_fused_chain(spec, w, x)


def time_fused(root, reps, cases=FUSED_CASES):
    """Rows of times of the fused-group chain kernels of the checkout at
    ``root``, one per case of ``cases``."""
    _use_root(root)
    import numpy as np
    import torch
    import chip_smoke
    from quanonet_torch.ops import cuda_fused, fused_gates, hea
    if not torch.cuda.is_available():
        raise SystemExit("time_chain: no CUDA device")
    dev = torch.device('cuda')
    rows = []
    for nq, net, n, with_bwd in cases:
        spec = hea.quanonet_spec(nq, net)
        rng = np.random.RandomState(5000 + 10 * nq + n)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        x = torch.tensor(rng.uniform(-4, 4, (n, spec.total_encode))
                         .astype(np.float32), device=dev)
        with torch.no_grad():
            ops = _fused_operands(fused_gates, spec, w, x)
        lds = fused_gates.block_depths(spec)
        big = n * spec.dim >= 2 ** 22
        r = 3 if big else reps

        def fwd():
            cuda_fused.chain_forward(*ops, lds)
        row = {"nq": nq, "net": list(net), "N": n, "nb": spec.n_blocks,
               "S": spec.total_sublayers, "D": spec.dim,
               "fwd_ms": chip_smoke.time_ms(fwd, r),
               "fwd_device_ms": chip_smoke.kernel_device_ms(
                   fwd, 'fused_chain_fwd', r),
               "fwd_bound_ms": chip_smoke.fused_bound(spec, n)[0]}
        if with_bwd:
            _, _, st_r, st_i = cuda_fused.chain_forward(
                *ops, lds, save_residuals=True)
            g = [torch.tensor(rng.randn(n, spec.dim).astype(np.float32),
                              device=dev) for _ in range(2)]

            def fwd_saved():
                cuda_fused.chain_forward(*ops, lds, save_residuals=True)

            def bwd():
                cuda_fused.chain_backward(*ops, lds, st_r, st_i, *g)
            row.update({
                "fwd_saved_ms": chip_smoke.time_ms(fwd_saved, r),
                "fwd_saved_device_ms": chip_smoke.kernel_device_ms(
                    fwd_saved, 'fused_chain_fwd', r),
                "bwd_ms": chip_smoke.time_ms(bwd, r),
                # every launch of the backward, each also on its own
                "bwd_device_ms": chip_smoke.kernel_device_ms(bwd, None, r),
                "bwd_device_ms_by_kernel": chip_smoke._profiled(
                    bwd, r).get("top_device_ms_per_step"),
                "bwd_bound_ms": chip_smoke.fused_bwd_bound(spec, n)[0]})
            del st_r, st_i
        rows.append(row)
        print(json.dumps({"case": f"Q{nq} N={n}", **row}), flush=True)
        del ops
        torch.cuda.empty_cache()
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
            med = {}
            for k in keys:
                vals = [m["rows"][i].get(k) for m in mine]
                vals = [v for v in vals if v is not None]
                if vals:
                    med[k] = float(np.median(vals))
                    med[k + "_spread"] = float(max(vals) - min(vals))
            split = [m["rows"][i].get("bwd_device_ms_by_kernel") for m in mine]
            split = [d for d in split if d]
            if split:
                med["bwd_device_ms_by_kernel"] = {
                    name: float(np.median([d.get(name, 0.0) for d in split]))
                    for name in split[0]}
            where = (f"Q{row['nq']} " if "nq" in row else "") + f"N={row['N']}"
            out[f"{label} {where}"] = {
                "runs": len(mine), **med,
                "fwd_bound_ms": row["fwd_bound_ms"],
                "bwd_bound_ms": row.get("bwd_bound_ms")}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--root', default='.', help='checkout whose kernels to time')
    p.add_argument('--kernel', choices=('block', 'fused'), default='block',
                   help='the block-chain kernels (B1) or the fused-group '
                        'chain kernels (B2)')
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
    rows = (time_fused(root, args.reps) if args.kernel == 'fused'
            else time_checkout(root, args.ns, args.reps, args.tile))
    result = {"label": args.label, "root": args.root, "nvidia_smi": smi,
              "kernel": args.kernel, "tile": args.tile, "rows": rows}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
