"""
Times the chain kernels of one checkout on the card: CUDA events around the
wrapper (``chip_smoke.time_ms``) and the kernels' own time in a profiler
trace (``chip_smoke.kernel_device_ms``), beside the bounds of
``chip_smoke``.  ``--kernel block`` (the default): the block-chain kernels
(B1f on the phases, on the angles where the checkout has that route, its
residual variant, and B1b with all its launches) and the whole no-grad
forward (``forward_pallas`` under ``inference_mode``: operands and chain)
at the flagship's shapes (Q5 Net40-2-20-2: nb 60, D 32) and several batch
sizes.
``--kernel fused``: the fused-group chain kernels (B2f primal and residual,
B2b with each of its launches) at Q8, Q10 and Q12 for N = 1, 100 and 1000,
Q10 at N = 8192, Q14 at N = 32 and the Q16 forward at N = 8.
``--kernel embed``: the real-embedding chain kernels (B3f primal and
residual, B3b with each of its launches) at Q5 Net40-2-20-2 (nb 60, d 32)
for N = 1, 100, 1000 and 8192, Q7 Net40-2-20-2 (d 128) at N = 100 and Q7
Net2-1-2-1 (nb 4) at N = 1000, on chip_smoke's seeded general operands,
and their card time inside the flagship's training step through engine
'embed'.  ``--kernel ucomp``: the block-matrix compile kernels (B4f, B4b
with each of its launches) at Q5, Q6 and Q7 Net40-2-20-2 and Q3
Net2-3-2-3, the whole compile path from the weights (host ms forward and
forward + backward, device rows, card time; a checkout whose kernels take
the operands runs ``compile_operands`` first), and the flagship's training
step at batch 100 with ``USE_UCOMP`` off and on, in turns.  ``--kernel
adam``: the one-launch Adam (B5) on the flagship's six leaves (2,401
parameters): one ``FusedAdam.step`` by CUDA events, by the host clock and
on the card (:func:`queued_device_ms`, and the profiler's rows), beside
its bound; then the flagship's step with the compile kernels and
``FusedAdam`` (the 'both' arm of ``chip_smoke.step_arms``).  Weights and
inputs are seeded and random.  It imports
``chip_smoke`` and ``quanonet_torch`` from ``--root``, so two checkouts (a
parent commit unpacked with ``git archive`` and the working tree) are
timed by the same code.  Run it as a file, from any directory:

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
import time

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
# (qubits, net_size, N) of the real-embedding chain
EMBED_CASES = (*[(5, FLAGSHIP[1], n) for n in (1, 100, 1000, 8192)],
               (7, FLAGSHIP[1], 100), (7, (2, 1, 2, 1), 1000))
# (qubits, net_size) of the block-matrix compile
UCOMP_CASES = ((5, FLAGSHIP[1]), (6, FLAGSHIP[1]), (7, FLAGSHIP[1]),
               (3, (2, 3, 2, 3)))
# launch geometries of the compile kernels that --tile picks: (forward warps
# a CTA, backward warps a CTA, backward CTAs a block); the forward gives
# every warp one row group, the CTAs a block are capped at what the rows fill
UCOMP_GEOMETRIES = ((1, 8, 4), (2, 8, 4), (4, 8, 4), (8, 16, 2),
                    (16, 16, 1), (4, 8, 1), (4, 4, 8), (4, 8, 2))


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

        def forward():
            with torch.inference_mode():
                cuda_hea.forward_pallas(spec, w, x)
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
               "bwd_bound_ms": chip_smoke.bwd_bound(nb, n, d)[0],
               # the whole no-grad forward: operands and chain
               "forward_ms": chip_smoke.time_ms(forward, reps),
               "forward_device_ms": chip_smoke.kernel_device_ms(forward,
                                                                None)}
        if hasattr(cuda_hea, 'chain_forward_angles'):
            def fwd_angles():
                cuda_hea.chain_forward_angles(ops[0], ops[1], x, nb)
            row["fwd_angles_ms"] = chip_smoke.time_ms(fwd_angles, reps)
            row["fwd_angles_device_ms"] = chip_smoke.kernel_device_ms(
                fwd_angles, 'hea_chain_fwd')
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


def time_embed(root, reps, tile=None, cases=EMBED_CASES):
    """Rows of times of the real-embedding chain kernels of the checkout
    at ``root``, one per case of ``cases``; with ``tile``, that row of the
    checkout's tile table in place of ``embed_geometry``'s choice.  The
    backward takes the residuals the checkout's forward returns, whatever
    its contract ((s, u) before the u-only residuals, u since)."""
    _use_root(root)
    import torch
    import chip_smoke
    from quanonet_torch.ops import cuda_embed
    if not torch.cuda.is_available():
        raise SystemExit("time_chain: no CUDA device")
    if tile is not None:
        cuda_embed.embed_geometry = (
            lambda n, d, sms: cuda_embed.tile_geometry(d, tile, n))
    dev = torch.device('cuda')
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for nq, net, n in cases:
        spec, e, t, g = chip_smoke._embed_case(nq, net, n,
                                               6000 + 10 * nq + n, dev)
        nb, d = spec.n_blocks, spec.dim
        res = cuda_embed.embed_forward(e, t, save_residuals=True)[1:]
        r = 5 if n * d >= 2 ** 17 else reps

        def fwd():
            cuda_embed.embed_forward(e, t)

        def fwd_saved():
            cuda_embed.embed_forward(e, t, save_residuals=True)

        def bwd():
            cuda_embed.embed_backward(e, t, *res, g)
        row = {"nq": nq, "net": list(net), "N": n, "nb": nb, "d": d,
               "residuals": len(res),
               "fwd_ms": chip_smoke.time_ms(fwd, r),
               "fwd_device_ms": chip_smoke.kernel_device_ms(
                   fwd, 'embed_chain_fwd', r),
               "fwd_saved_ms": chip_smoke.time_ms(fwd_saved, r),
               "fwd_saved_device_ms": chip_smoke.kernel_device_ms(
                   fwd_saved, 'embed_chain_fwd', r),
               "bwd_ms": chip_smoke.time_ms(bwd, r),
               # every launch of the backward, each also on its own
               "bwd_device_ms": chip_smoke.kernel_device_ms(bwd, None, r),
               "bwd_device_ms_by_kernel": chip_smoke._profiled(
                   bwd, r).get("top_device_ms_per_step"),
               "fwd_bound_ms": chip_smoke.embed_bound(nb, n, d)[0],
               "bwd_bound_ms": chip_smoke.embed_bwd_bound(nb, n, d)[0],
               "ebar_splits": cuda_embed.ebar_splits(nb, n, 2 * d, sms)}
        if hasattr(cuda_embed, 'embed_geometry'):
            row["geometry"] = cuda_embed.embed_geometry(n, d, sms)._asdict()
        rows.append(row)
        print(json.dumps({"case": f"Q{nq} N={n}", **row}), flush=True)
        del res
        torch.cuda.empty_cache()
    return rows


def embed_step_kernels(root, steps=20):
    """Card ms a step of each real-embedding chain kernel inside the
    flagship's training step at batch 100 through engine 'embed' (the step
    of chip_smoke.embed_vs_pallas), from a profiler window of ``steps``
    steps."""
    _use_root(root)
    import numpy as np
    import torch
    import chip_smoke
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    b, t, y = (torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        rng.randn(100, 100), rng.rand(100, 2), rng.randn(100, 1)))
    model = chip_smoke._flagship_model(dev, engine='embed')
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def step():
        loss = ((model(b, t) - y) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    for _ in range(3):
        step()
    prof = chip_smoke._profiled(step, steps)
    top = prof.get("top_device_ms_per_step") or {}
    return {"device_busy_ms_per_step": (
                prof["device_busy_ms"] / steps if "device_busy_ms" in prof
                else None),
            "device_rows_per_step": prof.get("device_kernels_per_step"),
            "embed_chain_ms_per_step": {k: v for k, v in top.items()
                                        if 'embed_chain' in k
                                        or 'sum_splits' in k}}


def compile_path(mats, spec, w, g, host_ms, profiled):
    """The compile path ``mats(spec, w) -> (mt_r, mt_i)`` from the weights
    as the engine takes it, forward and forward + backward under the
    cotangent g (no loss of its own): host clock with a synchronise
    (``host_ms``), and under the profiler (``profiled``) the device rows of
    one forward + backward, the card's busy time and its top rows."""
    import torch
    wg = w.clone().requires_grad_()

    def fwd_bwd():
        torch.autograd.grad(mats(spec, wg), wg, g)

    with torch.no_grad():
        out = {"forward_ms": host_ms(lambda: mats(spec, w))}
    out["forward_backward_ms"] = host_ms(fwd_bwd)
    prof = profiled(fwd_bwd)
    out["device_rows"] = prof.get("device_kernels_per_step")
    out["device_busy_ms"] = (prof["device_busy_ms"] / prof["profiled_steps"]
                             if "device_busy_ms" in prof else None)
    out["top_device_ms"] = prof.get("top_device_ms_per_step")
    return out


def _ucomp_kernels(cu, spec, w, ld, last, g):
    """fwd(), bwd() of the checkout's compile kernels: from the weights
    where it has that contract, else from the operands of its
    ``compile_operands(spec, w)``, built once outside the timed calls."""
    if hasattr(cu, 'ucomp_weights_dense'):
        return (lambda: cu.ucomp_forward(w, ld, last),
                lambda: cu.ucomp_backward(w, ld, last, *g))
    ops = cu.compile_operands(spec, w)
    return (lambda: cu.ucomp_forward(*ops, ld, last),
            lambda: cu.ucomp_backward(*ops, ld, last, *g))


def time_ucomp(root, reps, tile=None, cases=UCOMP_CASES):
    """Rows of times of the block-matrix compile kernels of the checkout
    at ``root`` and of its whole compile path, one per case of ``cases``;
    bounds where the checkout's ``chip_smoke.ucomp_counts`` counts the gate
    form.  With ``tile``, row ``tile`` of UCOMP_GEOMETRIES in place of
    ``ucomp_geometry``'s choice, and the kernels alone."""
    _use_root(root)
    import numpy as np
    import torch
    import chip_smoke
    from quanonet_torch.ops import cuda_ucomp, hea
    if not torch.cuda.is_available():
        raise SystemExit("time_chain: no CUDA device")
    if tile is not None:
        fw, bw, bc = UCOMP_GEOMETRIES[tile]

        def forced(dim, nb, sms, backward=False):
            groups = cuda_ucomp.row_groups(dim)
            warps = min(bw if backward else fw, groups)
            most = -(-groups // warps)
            return cuda_ucomp.Geometry(warps, min(bc, most) if backward
                                       else most)
        cuda_ucomp.ucomp_geometry = forced
    dev = torch.device('cuda')
    rows = []
    for nq, net in cases:
        spec = hea.quanonet_spec(nq, net)
        nb, d, ld = spec.n_blocks, spec.dim, spec.block_configs[0][1]
        rng = np.random.RandomState(7000 + 10 * nq + nb)
        w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                         .astype(np.float32), device=dev)
        g = [torch.tensor(rng.randn(nb, d, d).astype(np.float32), device=dev)
             for _ in range(2)]
        fwd, bwd = _ucomp_kernels(cuda_ucomp, spec, w, ld, nb - 1, g)
        row = {"nq": nq, "net": list(net), "nb": nb, "ld": ld, "D": d,
               "fwd_ms": chip_smoke.time_ms(fwd, reps),
               "fwd_device_ms": chip_smoke.kernel_device_ms(fwd, 'ucomp_fwd'),
               "bwd_ms": chip_smoke.time_ms(bwd, reps),
               # every launch of the backward, each also on its own
               "bwd_device_ms": chip_smoke.kernel_device_ms(bwd, 'ucomp_bwd'),
               "bwd_device_ms_by_kernel": chip_smoke._profiled(
                   bwd, 20, 'ucomp_bwd').get("top_device_ms_per_step"),
               "fwd_bound_ms": None, "bwd_bound_ms": None}
        if tile is None:
            row["path"] = compile_path(cuda_ucomp.compile_block_mats, spec, w,
                                       g, chip_smoke.host_ms,
                                       chip_smoke._profiled)
        counts = chip_smoke.ucomp_counts(nb, ld, d, nq)
        if isinstance(counts, dict):
            row["fwd_bound_ms"] = chip_smoke._bound(
                counts["fwd_flops"], counts["fwd_bytes"])[0]
            row["bwd_bound_ms"] = chip_smoke._bound(
                counts["bwd_flops"], counts["bwd_bytes"])[0]
        if hasattr(cuda_ucomp, 'ucomp_geometry'):
            sms = cuda_ucomp.sm_count(dev.index)
            row["geometry"] = {
                "fwd": cuda_ucomp.ucomp_geometry(d, nb, sms)._asdict(),
                "bwd": cuda_ucomp.ucomp_geometry(
                    d, nb, sms, backward=True)._asdict()}
        rows.append(row)
        print(json.dumps({"case": f"Q{nq} nb={nb}", **row}), flush=True)
    return rows


_SLEEP_CYCLES_PER_MS = []


def queued_device_ms(fn, reps=100, attempts=4):
    """Time on the card of one fn() (ms) without the profiler: the card
    first sleeps (``torch.cuda._sleep``) three times as long as the host
    took to issue ``reps`` calls, so that the calls wait in the stream and
    run back to back, and a CUDA-event pair around them is divided by
    ``reps``.  It holds the card's own gap between two launches, not the
    host's.  When the host took longer to issue them than the card slept,
    the calls did not all wait: it tries again with twice the sleep, up to
    ``attempts`` times, and then gives the last reading (an upper bound)."""
    import torch
    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sleep_ms = 3e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    for _ in range(attempts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * _SLEEP_CYCLES_PER_MS[0]))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issued_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        end.synchronize()
        if issued_ms < sleep_ms:
            break
        sleep_ms *= 2
    return start.elapsed_time(end) / reps


ADAM_BYTES_PER_PARAM = 7 * 4   # p, g, m, v read; p, m, v written (fp32)


def adam_bound_ms(n_params):
    """B5's bound (ms) on n_params parameters: the bytes (seven fp32 words
    a parameter, the rate table's entry and the count read and written
    once) at the HBM rate, against its 12 flops a parameter at the fp32
    peak."""
    nbytes = ADAM_BYTES_PER_PARAM * n_params + 4 + 8
    return 1e3 * max(nbytes / 3.35e12, 12.0 * n_params / 67e12), nbytes


def time_adam(root, reps):
    """Rows of times of one ``FusedAdam.step`` of the checkout at ``root``
    on the flagship's leaves, at a constant rate."""
    _use_root(root)
    import numpy as np
    import torch
    import chip_smoke
    from quanonet_torch.ops import cuda_adam
    dev = torch.device('cuda')
    shapes = [tuple(p.shape) for p in chip_smoke._flagship_model(
        dev).parameters()]
    n_params = int(sum(np.prod(s) for s in shapes))
    rng = np.random.RandomState(11)
    params = [torch.nn.Parameter(torch.tensor(
        np.asarray(rng.randn(*s), np.float32), device=dev)) for s in shapes]
    opt = cuda_adam.fused_adam(1e-3).init(params)
    for p in params:
        p.grad = torch.tensor(np.asarray(rng.randn(*p.shape), np.float32),
                              device=dev)
    bindings = getattr(opt, '_bindings', None)
    row = {"case": "Q5 Net40-2-20-2 leaves",
           "parameters": n_params, "leaves": len(shapes),
           "ctas": bindings[0].grid() if bindings else None,
           "adam_ms": chip_smoke.time_ms(opt.step, reps),
           "adam_host_ms": chip_smoke.host_ms(opt.step, reps),
           "adam_queued_device_ms": queued_device_ms(opt.step),
           "adam_device_ms": chip_smoke.kernel_device_ms(
               opt.step, 'adam_kernel'),
           "adam_bound_ms": adam_bound_ms(n_params)[0]}
    print(json.dumps(row), flush=True)
    return [row]


def adam_train_step(root):
    """The flagship's training step at batch 100 with the compile kernels
    and ``FusedAdam`` (``chip_smoke._arms_in_turns`` of the checkout at
    ``root``, one arm): step ms, device rows a step, the card's busy
    time."""
    _use_root(root)
    import numpy as np
    import torch
    import chip_smoke
    from quanonet_torch.ops import cuda_adam, cuda_hea
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    b, t, y = (torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        rng.randn(100, 100), rng.rand(100, 2), rng.randn(100, 1)))
    model = chip_smoke._flagship_model(dev)
    opt = cuda_adam.fused_adam(1e-4).init(model.parameters())

    def step():
        found, cuda_hea.USE_UCOMP = cuda_hea.USE_UCOMP, True
        try:
            loss = ((model(b, t) - y) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        finally:
            cuda_hea.USE_UCOMP = found
    out = chip_smoke._arms_in_turns({'both': step})
    for arm in out.values():
        arm.pop("top_device_ms_per_step", None)
    return out


def ucomp_step(root):
    """The flagship's training step at batch 100 with ``USE_UCOMP`` off
    and on, in turns (``chip_smoke._arms_in_turns`` of the checkout at
    ``root``): step ms, device rows a step, the card's busy time."""
    _use_root(root)
    import numpy as np
    import torch
    import chip_smoke
    from quanonet_torch.ops import cuda_hea
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    b, t, y = (torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        rng.randn(100, 100), rng.rand(100, 2), rng.randn(100, 1)))
    arms = {}
    for name, on in (('default', False), ('ucomp', True)):
        model = chip_smoke._flagship_model(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)

        def step(model=model, opt=opt, on=on):
            found, cuda_hea.USE_UCOMP = cuda_hea.USE_UCOMP, on
            try:
                loss = ((model(b, t) - y) ** 2).mean()
                opt.zero_grad()
                loss.backward()
                opt.step()
            finally:
                cuda_hea.USE_UCOMP = found
        arms[name] = step
    out = chip_smoke._arms_in_turns(arms)
    for arm in out.values():
        arm.pop("top_device_ms_per_step", None)
    return out


def _median(vals):
    import numpy as np
    vals = [v for v in vals if v is not None]
    return float(np.median(vals)) if vals else None


def summarize(paths):
    """Median over the runs of each label, one line per (label, N)."""
    import numpy as np
    runs = [json.load(open(p)) for p in paths]
    keys = ("fwd_ms", "fwd_device_ms", "fwd_saved_ms", "fwd_saved_device_ms",
            "bwd_ms", "bwd_device_ms", "fwd_angles_ms",
            "fwd_angles_device_ms", "forward_ms", "forward_device_ms",
            "adam_ms", "adam_host_ms",
            "adam_queued_device_ms", "adam_device_ms")
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
            if "path" in row:
                med["path"] = {k: _median([m["rows"][i]["path"].get(k)
                                           for m in mine])
                               for k in ("forward_ms", "forward_backward_ms",
                                         "device_rows", "device_busy_ms")}
            where = " ".join(
                ([row['case']] if "case" in row else [])
                + ([f"Q{row['nq']}"] if "nq" in row else [])
                + ([f"Net{'-'.join(map(str, row['net']))}"] if "net" in row
                   else [])
                + ([f"N={row['N']}"] if "N" in row else []))
            out[f"{label} {where}"] = {
                "runs": len(mine), **med,
                **{k: row[k] for k in ("fwd_bound_ms", "bwd_bound_ms",
                                       "adam_bound_ms") if k in row}}
        steps = [m["step"] for m in mine if m.get("step")]
        if steps and "embed_chain_ms_per_step" in steps[0]:
            steps = [st["embed_chain_ms_per_step"] for st in steps]
            out[f"{label} step"] = {
                name: float(np.median([d.get(name, 0.0) for d in steps]))
                for name in steps[0]}
        elif steps:
            out[f"{label} step"] = {
                arm: {k: _median([st[arm][k] for st in steps])
                      for k in ("step_ms", "device_rows_per_step",
                                "device_busy_ms_per_step")}
                for arm in steps[0]}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--root', default='.', help='checkout whose kernels to time')
    p.add_argument('--kernel',
                   choices=('block', 'fused', 'embed', 'ucomp', 'adam'),
                   default='block',
                   help='the block-chain kernels (B1), the fused-group '
                        'chain kernels (B2), the real-embedding chain '
                        'kernels (B3), the block-matrix compile kernels '
                        '(B4) or the one-launch Adam (B5)')
    p.add_argument('--label', default='tree')
    p.add_argument('--out', default=None, help='JSON file to write')
    p.add_argument('--ns', type=int, nargs='+', default=list(NS))
    p.add_argument('--reps', type=int, default=30)
    p.add_argument('--tile', type=int, default=None,
                   help="time this row of cuda_hea.TILES (cuda_embed.TILES "
                        "with --kernel embed, UCOMP_GEOMETRIES with --kernel "
                        "ucomp) instead of the geometry function's choice")
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
    if args.kernel == 'fused':
        rows = time_fused(root, args.reps)
    elif args.kernel == 'embed':
        rows = time_embed(root, args.reps, args.tile)
    elif args.kernel == 'ucomp':
        rows = time_ucomp(root, args.reps, args.tile)
    elif args.kernel == 'adam':
        rows = time_adam(root, max(args.reps, 100))
    else:
        rows = time_checkout(root, args.ns, args.reps, args.tile)
    result = {"label": args.label, "root": args.root, "nvidia_smi": smi,
              "kernel": args.kernel, "tile": args.tile, "rows": rows}
    if args.kernel == 'embed':
        result["step"] = embed_step_kernels(root)
    elif args.kernel == 'ucomp' and args.tile is None:
        result["step"] = ucomp_step(root)
    elif args.kernel == 'adam':
        result["step"] = adam_train_step(root)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
