"""
Pipeline parallelism over the block chain (counterpart of
quanonet_tpu/parallel/pipeline.py).

In the Hadamard-diagonal form the circuit is the chain

    ψ = M_B D(x_B) M_{B-1} ... M_1 D(x_1) s0

(ops/hea.prepare_chain).  P ranks hold P contiguous stages of nb/P blocks
each, and microbatches of states flow from stage to stage on a GPipe
schedule: microbatch m is on stage p at tick t = m + p, so M microbatches
drain in M + P - 1 ticks.  Every tick each rank first takes its left
neighbour's last output (``comm.shift_next``, re and im in one message;
stage 0 gets zeros and adds the fresh microbatch's D(x_1)·H|0>), applies
its blocks and trailing diagonals, and measures; the last stage's
measurements of ticks P-1 .. T-1 are the result, summed over the group so
that every rank holds it.

Every rank joins every hop, padding microbatches included, and the hops
of the backward run in reverse tick order on each rank's autograd engine:
each tick's input is the previous tick's output, so the order is forced
by the data, and stage 0's received zeros stay in its graph (the injected
state is added to them) so that its hop's backward runs too.

Stage-local compile (uniform blocks, the default): each rank compiles only
its own blocks from its slice of the weights.  On ``cuda`` that is one B4f
launch (``ops/cuda_ucomp.ucomp``, B4b under autograd) on the contiguous
(per·ld, 3, n) slice, with ``last`` the stage's final block on the last
stage and -1 elsewhere (the JAX package's ``_fold`` where-mask); on the CPU
the plain fold.  ``stage_local_compile=False`` compiles every block and
takes the stage's slice.  The stage's block products are Karatsuba complex
products (``torch.matmul``), as in the JAX package, which computes them
outside any Pallas kernel.

``data``: a second group to shard the batch over (dp × pp): each data
rank runs the pipeline on its contiguous share of the batch, and the
result is gathered back over ``data``.  Weight and angle cotangents are
summed over ``pipe`` then ``data`` (``comm.sum_cotangents``), so after a
backward every rank holds the full gradient.
"""
import numpy as np
import torch

from quanonet_torch.ops import cuda_hea, cuda_ucomp
from quanonet_torch.ops import hea as _hea
from quanonet_torch.ops.gates import hadamard_kron
from quanonet_torch.parallel import comm


def _stage_fold(sub_spec, w_loc, is_last_stage):
    """Plain fold of the stage's blocks, (per, D, D) pre-transposed each:
    M_b = H U_b H, the global last block U_b H."""
    ur, ui = _hea.compile_block_unitaries(sub_spec, w_loc)
    hk = _hea._table(hadamard_kron(sub_spec.n_qubits), w_loc)
    uh_r, uh_i = ur @ hk, ui @ hk
    m_r, m_i = hk @ uh_r, hk @ uh_i
    if is_last_stage:
        m_r = torch.cat([m_r[:-1], uh_r[-1:]], 0)
        m_i = torch.cat([m_i[:-1], uh_i[-1:]], 0)
    return (m_r.transpose(1, 2).contiguous(),
            m_i.transpose(1, 2).contiguous())


def make_pipeline_hea(spec, pipe, n_microbatches=None, data=None,
                      stage_local_compile=None, pauli='Z', offset=0.0,
                      coeff=0.0):
    """f(weights, x, diag) -> (batch, 1) with the chain pipelined over the
    group ``pipe`` (module docstring); pauli 'X'/'Y' measures
    <offset + coeff·Σ P_i> on the draining stage (diag ignored).

    Requirements: spec.n_blocks divisible by the pipe size, the (per data
    rank) batch divisible by n_microbatches (default: the pipe size)."""
    P, p = pipe.world, pipe.rank
    nb = spec.n_blocks
    if nb % P:
        raise ValueError(f"n_blocks={nb} not divisible by pipeline size {P}")
    per = nb // P
    M = int(n_microbatches or P)
    n, D = spec.n_qubits, spec.dim
    inv_sqrt = float(1.0 / np.sqrt(D))
    uniform = len(set(spec.block_configs)) == 1
    if stage_local_compile is None:
        stage_local_compile = uniform
    if stage_local_compile and not uniform:
        raise ValueError("stage-local compile requires uniform block "
                         "structure (all blocks same (n_enc, ld))")
    if not spec.uniform_encode:
        raise ValueError("the pipeline requires n_encode == n_qubits per "
                         "block")
    sub_spec = _hea.HEASpec(n, spec.block_configs[:per])
    ld = spec.block_configs[0][1]
    last_stage = p == P - 1
    groups = (pipe,) + ((data,) if data is not None else ())

    def stage_mats(weights):
        """This stage's pre-transposed block matrices (per, D, D)."""
        if not stage_local_compile:
            mt_r, mt_i = cuda_hea.block_mats(spec, weights)
            return mt_r[p * per:(p + 1) * per], mt_i[p * per:(p + 1) * per]
        w_loc = weights[p * per * ld:(p + 1) * per * ld].contiguous()
        if cuda_hea.compile_route(cuda_hea.USE_UCOMP, sub_spec,
                                  weights.device.type):
            return cuda_ucomp.ucomp(w_loc, ld, per - 1 if last_stage else -1)
        return _stage_fold(sub_spec, w_loc, last_stage)

    def stage_phases(x):
        """(per+1, batch, D): the phases of blocks p·per .. p·per+per; row 0
        feeds the injection on stage 0, rows 1..per the trailing
        diagonals (the last stage's final row is unused)."""
        hi = min((p + 1) * per + 1, nb)
        xs = x[:, p * per * n:hi * n]
        phi = _hea.encoding_phases(_hea.HEASpec(n, ((n, 0),) * (hi - p * per)),
                                   xs)
        if hi - p * per < per + 1:
            phi = torch.cat([phi, torch.zeros_like(phi[:1])], 0)
        return phi

    def measure(sr, si, diag):
        if pauli == 'Z':
            return _hea.diag_expectation_pair(sr, si, diag)
        return _hea.pauli_sum_expectation_pair(sr, si, pauli, n, offset,
                                               coeff)

    def run(weights, x, diag):
        batch = x.shape[0]
        mb = batch // M
        mt_r, mt_i = stage_mats(weights)
        phi = stage_phases(x)
        carry = torch.zeros((2, mb, D), dtype=torch.float32, device=x.device)
        outs = []
        for t in range(M + P - 1):
            recv = comm.shift_next(carry, pipe)
            m = min(max(t - p, 0), M - 1)       # the resident microbatch
            ph = phi[:, m * mb:(m + 1) * mb]
            sr, si = recv[0], recv[1]
            if p == 0:                           # D(x_1) · H|0..0>
                sr = sr + torch.cos(ph[0]) * inv_sqrt
                si = si - torch.sin(ph[0]) * inv_sqrt
            for k in range(per):
                sr, si = _hea._kara(sr, si, mt_r[k], mt_i[k])
                if not (last_stage and k == per - 1):
                    dr, di = torch.cos(ph[k + 1]), -torch.sin(ph[k + 1])
                    sr, si = dr * sr - di * si, dr * si + di * sr
            carry = torch.stack([sr, si])
            outs.append(measure(sr, si, diag))
        res = torch.cat(outs[P - 1:])            # the last stage's drain
        return comm.psum_replicated(res if last_stage else res * 0.0, pipe)

    def fn(weights, x, diag=None):
        batch = x.shape[0]
        shard = batch
        if data is not None:
            if batch % data.world:
                raise ValueError(f"batch={batch} not divisible by data-axis "
                                 f"size {data.world}")
            shard = batch // data.world
        if shard % M:
            raise ValueError(f"per-shard batch {shard} not divisible by "
                             f"n_microbatches={M}")
        weights, x = comm.sum_cotangents(groups, weights, x)
        if data is not None:
            x = x[data.rank * shard:(data.rank + 1) * shard]
        if pauli == 'Z':
            diag = torch.as_tensor(diag, dtype=torch.float32,
                                   device=x.device)
        out = run(weights, x, diag)
        return comm.all_gather_rows(out, data) if data is not None else out

    return fn
