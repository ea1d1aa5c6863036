"""
The amplitude-sharded statevector engine (counterpart of
quanonet_tpu/parallel/amplitude.py): the 2^n amplitude axis split over the
ranks of a group, for qubit counts whose state outgrows one card.

With W = 2^k ranks in block layout the top k qubits' bit values are the
rank, so

* gates on the n-k local qubits run on the rank's own shard;
* RX and RY on a global qubit exchange the shard with one partner rank
  (``comm.exchange``, rank r <-> r ^ (1 << bit), re and im in one message);
* RZ on a global qubit needs no message (the rank's bit is constant over
  its shard);
* the CNOT ring needs one exchange per link that targets a global qubit;
  its local run is one gather;
* the measurement is a local partial expectation and one
  ``comm.psum_replicated``; X and Y Pauli sums add one exchange per global
  qubit.

The weights and angles enter through ``comm.sum_cotangents`` and the
result leaves through ``comm.psum_replicated``, so after a backward every
rank holds the full gradient of every parameter, the JAX package's
``shard_map`` transpose of a replicated input.

:func:`make_sharded_hea` builds f(weights, x, diag) -> (batch, 1) from the
per-gate body (:func:`_body`, any spec) or, with ``fused=True``, the
grouped-kron local path (:func:`_body_fused`, uniform encode): per
sublayer the local rotations as one 2^k-wide contraction per qubit group
(ops/fused_gates.py), the global ones per gate.

``virtual_global=k`` (world 1 only) is a timing instrument: one shard's
local work of a 2^k-way run, state 2^(n-k), every exchange a no-op; the
output is a fixed-gauge variant, not the circuit.  ``diag`` is then the
rank's slice (or the full diagonal, whose first 2^(n-k) entries are
taken).
"""
import math

import numpy as np
import torch

from quanonet_torch.ops.fused_gates import (
    _apply_group, _apply_hadamard, _group_unitary, folded_rot2x2,
    qubit_groups,
)
from quanonet_torch.ops.gates import make_perm_apply, z_signs
from quanonet_torch.ops.hea import (
    _apply_rz, _apply_ry, _rx_single, pauli_sum_total,
)
from quanonet_torch.parallel import comm


def _pair(sr, si):
    return torch.stack([sr, si])


def _partner(sr, si, bit, group):
    """(pr, pi): the partner rank's shard across global bit ``bit``."""
    p = comm.exchange(_pair(sr, si), bit, group)
    return p[0], p[1]


def _inverse(perm):
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def _local_ring(local_n):
    """Gather of the ring's local CNOT run (links i = 0..local_n-2)."""
    k = np.arange(2 ** local_n)
    p = k.copy()
    for i in range(max(local_n - 1, 0)):
        p = p ^ (((p >> (i + 1)) & 1) << i)
    return make_perm_apply(_inverse(p))


class _Shard:
    """The gate algebra of one rank: ``local_n`` local qubits, the global
    ones exchanged over ``group``, the rank's bits from ``rank``."""

    def __init__(self, n, local_n, rank, group):
        self.n, self.local_n, self.rank, self.group = n, local_n, rank, group
        self.local_dim = 2 ** local_n
        self._tables = {}

    def table(self, key, make, device):
        """The host array ``make()`` on ``device``, copied there once per
        ``key``: a copy a gate would wait for the card every time."""
        t = self._tables.get((key, device))
        if t is None:
            t = self._tables[(key, device)] = torch.as_tensor(make(),
                                                              device=device)
        return t

    def bit(self, q):
        return (self.rank >> (q - self.local_n)) & 1

    def init_state(self, batch, device):
        sr = torch.zeros((batch, self.local_dim), dtype=torch.float32,
                         device=device)
        if self.rank == 0:       # |0...0> lives on rank 0's index 0
            sr[:, 0] = 1.0
        return sr, torch.zeros_like(sr)

    def rx(self, sr, si, q, theta):
        if q < self.local_n:
            return _rx_single(sr, si, q, theta, self.local_n)
        pr, pi = _partner(sr, si, q - self.local_n, self.group)
        c = torch.cos(theta / 2.0)[:, None]
        s = torch.sin(theta / 2.0)[:, None]
        return c * sr + s * pi, c * si - s * pr

    def ry(self, sr, si, q, c, s):
        if q < self.local_n:
            return _apply_ry(sr, si, q, c, s, self.local_n)
        pr, pi = _partner(sr, si, q - self.local_n, self.group)
        sign = 2.0 * self.bit(q) - 1.0   # -s on the |0> half, +s on |1>
        return c * sr + sign * s * pr, c * si + sign * s * pi

    def rz(self, sr, si, q, half):
        if q < self.local_n:
            return _apply_rz(sr, si, q, half, self.local_n)
        sgn = 2.0 * self.bit(q) - 1.0    # e^{+iθ/2} on |1>, e^{-iθ/2} on |0>
        c, s = torch.cos(half), torch.sin(half)
        return c * sr - sgn * s * si, c * si + sgn * s * sr

    def rotations(self, sr, si, q, w):
        """RY(w0)·RZ(w1)·RY(w2) order of the ansatz on qubit q."""
        sr, si = self.ry(sr, si, q, torch.cos(w[0, q] / 2),
                         torch.sin(w[0, q] / 2))
        sr, si = self.rz(sr, si, q, w[1, q] / 2)
        return self.ry(sr, si, q, torch.cos(w[2, q] / 2),
                       torch.sin(w[2, q] / 2))

    def cnot(self, sr, si, control, target):
        ln = self.local_n
        k = np.arange(self.local_dim)
        if control < ln and target < ln:
            idx = self.table(('cnot', control, target), lambda: _inverse(
                k ^ (((k >> control) & 1) << target)), sr.device)
            return sr[:, idx], si[:, idx]
        if control >= ln and target < ln:
            if not self.bit(control):    # flip the target iff the bit is 1
                return sr, si
            idx = self.table(('flip', target),
                             lambda: _inverse(k ^ (1 << target)), sr.device)
            return sr[:, idx], si[:, idx]
        if control < ln:                 # local control, global target
            pr, pi = _partner(sr, si, target - ln, self.group)
            cm = self.table(('mask', control), lambda: (
                (k >> control) & 1).astype(np.float32)[None, :], sr.device)
            return sr * (1 - cm) + pr * cm, si * (1 - cm) + pi * cm
        pr, pi = _partner(sr, si, target - ln, self.group)
        return (pr, pi) if self.bit(control) else (sr, si)

    def measure(self, sr, si, diag_local, pauli, offset, coeff):
        """The local partial expectation, summed over the group."""
        if pauli == 'Z':
            local = ((sr * sr + si * si) * diag_local).sum(-1)
            return comm.psum_replicated(local, self.group)[:, None]
        ln = self.local_n
        total = (pauli_sum_total(sr, si, pauli, ln) if ln > 0
                 else torch.zeros(sr.shape[0], dtype=torch.float32,
                                  device=sr.device))
        bits = [q - ln for q in range(ln, self.n)]
        if bits:
            partners = comm.exchange_bits(_pair(sr, si), bits, self.group)
            for j, q in enumerate(range(ln, self.n)):
                pr, pi = partners[j, 0], partners[j, 1]
                if pauli == 'X':
                    # both partners contribute Re<conj(me), partner>: the
                    # pair sums to 2 Re Σ conj(ψ0) ψ1
                    total = total + (sr * pr + si * pi).sum(1)
                else:
                    # Im<conj(me), partner> flips sign on the |1> half
                    sign = 1.0 - 2.0 * self.bit(q)
                    total = total + sign * (sr * pi - si * pr).sum(1)
        total = comm.psum_replicated(total, self.group)
        return (offset + coeff * total)[:, None]


def _body(spec, sh, weights, x):
    """Gate by gate, any encode (the JAX package's ``body``)."""
    n = spec.n_qubits
    sr, si = sh.init_state(x.shape[0], x.device)
    col = sub = 0
    for n_encode, linear_depth in spec.block_configs:
        for j in range(n_encode):
            if col < x.shape[1]:
                sr, si = sh.rx(sr, si, j % n, x[:, col])
            col += 1
        for _ in range(linear_depth):
            w = weights[sub]
            for i in range(n):
                sr, si = sh.rotations(sr, si, i, w)
            if n > 1:
                for i in range(n):
                    sr, si = sh.cnot(sr, si, (i + 1) % n, i)
            sub += 1
    return sr, si


def _body_fused(spec, sh, weights, x):
    """The grouped-kron local path (the JAX package's ``body_fused``): the
    encode's local RX gates as H·D(x)·H with the left H folded into the
    block's first sublayer, the local rotations one contraction per qubit
    group, the ring's local run one gather; global qubits per gate."""
    n, ln = spec.n_qubits, sh.local_n
    groups = qubit_groups(ln) if ln > 0 else ()
    zs = sh.table('zs', lambda: z_signs(ln), x.device) if ln > 0 else None
    ring = _local_ring(ln) if ln > 1 else None
    rr, ri = folded_rot2x2(spec, weights)        # (S, n, 2, 2), H folded
    units = {g: _group_unitary(rr, ri, off, k)
             for g, (off, k) in enumerate(groups)}
    sr, si = sh.init_state(x.shape[0], x.device)
    col = sub = 0
    for n_encode, linear_depth in spec.block_configs:
        # RX gates on distinct wires commute: the global ones per gate,
        # the local ones as H·D·H with the left H deferred
        for i in range(ln, n):
            sr, si = sh.rx(sr, si, i, x[:, col + i])
        if ln > 0:
            sr, si = _apply_hadamard(sr, si, groups, ln)
            xb = x[:, col:col + ln]
            # K = local_n: an explicit sum, exact in fp32 whatever the
            # matmul precision
            phi = 0.5 * (xb[:, None, :] * zs[None]).sum(-1)
            dr, di = torch.cos(phi), -torch.sin(phi)
            sr, si = dr * sr - di * si, dr * si + di * sr
        pending_h = ln > 0
        col += n_encode
        for _ in range(linear_depth):
            for g, (off, k) in enumerate(groups):
                ur, ui = units[g]
                sr, si = _apply_group(sr, si, ur[sub], ui[sub], off, k, ln)
            pending_h = False
            w = weights[sub]
            for i in range(ln, n):
                sr, si = sh.rotations(sr, si, i, w)
            if n > 1:
                if ring is not None:     # the whole local run in one gather
                    sr, si = ring(sr, si)
                for i in range(max(ln - 1, 0), n):
                    sr, si = sh.cnot(sr, si, (i + 1) % n, i)
            sub += 1
        if pending_h:                    # encoding-only block
            sr, si = _apply_hadamard(sr, si, groups, ln)
    return sr, si


def make_sharded_hea(spec, group, fused=False, virtual_global=None,
                     pauli='Z', offset=0.0, coeff=0.0):
    """f(weights, x, diag) -> (batch, 1), the expectation of ``spec`` with
    the state sharded over ``group`` (module docstring).  weights and x are
    the same on every rank; diag is the full (2^n,) diagonal, each rank
    reading its slice (ignored for pauli 'X'/'Y')."""
    n = spec.n_qubits
    world = group.world
    if virtual_global is not None:
        if world != 1:
            raise ValueError("virtual_global requires a 1-device group")
        k = int(virtual_global)
    else:
        k = int(math.log2(world))
        if 2 ** k != world:
            raise ValueError(f"device count {world} must be a power of 2")
    if k > n:
        raise ValueError(
            f"2^{k} shards ({world} devices) > 2^{n} amplitudes")
    if pauli not in ('Z', 'X', 'Y'):
        raise ValueError(f"pauli must be Z, X or Y, got {pauli}")
    if pauli != 'Z' and virtual_global is not None:
        raise ValueError("virtual_global is a Z-basis timing instrument")
    if fused and not spec.uniform_encode:
        raise ValueError("fused sharded engine requires uniform encode")
    local_n = n - k
    sh = _Shard(n, local_n, group.rank, group)
    body = _body_fused if fused else _body
    offset, coeff = float(offset), float(coeff)

    def f(weights, x, diag=None):
        weights, x = comm.sum_cotangents((group,), weights, x)
        sr, si = body(spec, sh, weights, x)
        dl = None
        if pauli == 'Z':
            d = torch.as_tensor(diag, dtype=torch.float32, device=x.device)
            dl = d if d.numel() == sh.local_dim else \
                d[group.rank * sh.local_dim:(group.rank + 1) * sh.local_dim]
        return sh.measure(sr, si, dl, pauli, offset, coeff)

    f.local_dim = sh.local_dim      # the amplitudes a rank holds, 2^(n-k)
    return f


def hea_expectation_sharded(spec, weights, x, diag, group, fused=False,
                            pauli='Z', offset=0.0, coeff=0.0):
    """One-shot :func:`make_sharded_hea`."""
    return make_sharded_hea(spec, group, fused=fused, pauli=pauli,
                            offset=offset, coeff=coeff)(weights, x, diag)


def sharded_collective_counts(spec, n_dev, pauli='Z'):
    """The messages of one sharded forward, counted from the engine's
    gates: with k = log2(n_dev) global qubits (the top k), one exchange
    per encode RX on a global wire, 2k per sublayer for the global RY rows
    (RZ is free) and k for the ring (the links whose target is global; a
    link with a global control and a local target flips locally), k more
    for an X or Y measurement, and one psum.  Each exchange moves the
    local shard, re and im: batch · 2^(n-k) · 2 · 4 bytes.

    Returns {'ppermutes', 'psums', 'bytes_per_sample'} (the JAX package's
    names).  The JAX package's model counts k + 1 ring exchanges per
    sublayer, the wrap link twice; its engine moves k, as this one does."""
    k = int(math.log2(n_dev))
    if 2 ** k != n_dev:
        raise ValueError("n_dev must be a power of 2")
    n = spec.n_qubits
    if k > n:
        raise ValueError("more devices than amplitudes")
    local_n = n - k
    pp = k if pauli in ('X', 'Y') else 0
    for n_encode, ld in spec.block_configs:
        pp += sum(1 for j in range(n_encode) if j % n >= local_n)
        pp += ld * (2 * k + (k if n > 1 else 0))
    shard_bytes = 2 ** local_n * 2 * 4
    return {'ppermutes': pp, 'psums': 1,
            'bytes_per_sample': pp * shard_bytes}
