"""
The sharded circuit engines as model engines (counterpart of
quanonet_tpu/parallel/shard_engine.py): ``--shard amp|pipe``.

The amplitude-sharded engine (parallel/amplitude.py) and the pipelined
engine (parallel/pipeline.py) keep the expectation contract of the
single-device engines, f(weights, x, diag) -> (batch, 1), but run over a
group of ranks.  The Solver installs a shard context (the rank's
:class:`~quanonet_torch.parallel.comm.Group` and the schedule) before it
builds the model; every expectation the model takes then routes through
the sharded program (engine names 'amp' / 'pipe' in ops/hea.py).  Each
rank process holds its own context.
"""
from dataclasses import dataclass
from typing import Optional

import torch

from quanonet_torch.parallel.comm import Group

SHARD_MODES = ('amp', 'pipe')


@dataclass(frozen=True)
class ShardContext:
    group: Group                            # the rank's group
    mode: str                               # 'amp' | 'pipe'
    n_microbatches: Optional[int] = None    # pipe only (default: world)


_context: Optional[ShardContext] = None
_fn_cache = {}


def set_shard_context(group, mode, n_microbatches=None):
    """Install this process's shard context."""
    global _context
    if mode not in SHARD_MODES:
        raise ValueError(f"shard mode must be one of {SHARD_MODES}, "
                         f"got '{mode}'")
    _fn_cache.clear()
    _context = ShardContext(group, mode,
                            int(n_microbatches) if n_microbatches else None)
    return _context


def clear_shard_context():
    global _context
    _context = None
    _fn_cache.clear()


def get_shard_context() -> Optional[ShardContext]:
    return _context


def _build(spec, ctx, pauli, offset, coeff):
    if ctx.mode == 'amp':
        from quanonet_torch.parallel.amplitude import make_sharded_hea
        # the grouped-kron local path where the spec allows it (uniform
        # encode: every QuanONet/HEAQNN net), the per-gate body otherwise
        return make_sharded_hea(spec, ctx.group, fused=spec.uniform_encode,
                                pauli=pauli, offset=offset, coeff=coeff)
    from quanonet_torch.parallel.pipeline import make_pipeline_hea
    raw = make_pipeline_hea(spec, ctx.group,
                            n_microbatches=ctx.n_microbatches, pauli=pauli,
                            offset=offset, coeff=coeff)
    M = int(ctx.n_microbatches or ctx.group.world)

    def fn(weights, x, diag):
        # the schedule needs batch % M == 0: zero rows in, their results
        # sliced away (the slice gives the pad rows zero cotangents)
        batch = x.shape[0]
        pad = (-batch) % M
        if pad:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))], 0)
        return raw(weights, x, diag)[:batch]

    return fn


def sharded_expectation(spec, weights, x, diag, pauli='Z', offset=0.0,
                        coeff=0.0):
    """Engine entry of ops/hea.hea_expectation for 'amp' and 'pipe': the
    sharded program for (spec, context, observable), built on first use."""
    ctx = _context
    if ctx is None:
        raise RuntimeError(
            "engine 'amp'/'pipe' needs an active shard context: run via "
            "Solver --shard amp|pipe, or call "
            "parallel.shard_engine.set_shard_context(group, mode) first")
    if torch.is_tensor(offset) or torch.is_tensor(coeff):
        raise ValueError(
            "engine 'amp'/'pipe' takes the observable as Python floats: "
            "pauli offset/coeff must not be tensors (use a single-device "
            "engine to differentiate with respect to the Hamiltonian's "
            "bounds)")
    offset, coeff = float(offset), float(coeff)
    key = (spec, pauli, offset, coeff)
    fn = _fn_cache.get(key)
    if fn is None:
        fn = _fn_cache[key] = _build(spec, ctx, pauli, offset, coeff)
    if diag is None:
        diag = torch.zeros(spec.dim, dtype=torch.float32, device=x.device)
    return fn(weights, x, diag)


def validate_shard_config(mode, n_devices, spec, batch_size=None,
                          n_microbatches=None):
    """The Solver's checks before it starts (the engines raise the same
    conditions later, deep inside a run)."""
    if mode == 'amp':
        if n_devices & (n_devices - 1):
            raise ValueError(
                f"--shard amp needs a power-of-two --num_devices, "
                f"got {n_devices}")
        k = n_devices.bit_length() - 1
        if k > spec.n_qubits:
            raise ValueError(
                f"--shard amp: 2^{k} shards ({n_devices} devices) exceed "
                f"the 2^{spec.n_qubits} amplitudes of a Q{spec.n_qubits} "
                f"state")
    elif mode == 'pipe':
        if spec.n_blocks % n_devices:
            raise ValueError(
                f"--shard pipe: n_blocks={spec.n_blocks} (branch_depth + "
                f"trunk_depth) must divide evenly over {n_devices} "
                f"pipeline stages")
        M = int(n_microbatches or n_devices)
        if batch_size is not None and batch_size % M:
            raise ValueError(
                f"--shard pipe: batch_size={batch_size} not divisible by "
                f"n_microbatches={M} (batches are zero-padded at "
                f"inference, but training batches should divide evenly "
                f"to avoid wasted pipeline ticks)")
