"""
The plain reference of QuanONet: a gate-by-gate statevector in plain
PyTorch, fp32 (complex64) with TF32 off, written from the circuit's
description alone.  It imports nothing of the program; it takes the
benchmark's inputs and weights and works everything else out itself.

The model (QuanONet, the repo's README and the paper):

    angles = concat(trunk_w * tile(trunk) + trunk_b,
                    branch_w * tile(branch) + branch_b)    # trunk first
    |psi> = prod over blocks b of [ ld sublayers of
              (RY(w0), RZ(w1), RY(w2) on every qubit, CNOT ring) ]
              . RX(angles[b*n + j]) on qubit j                       |0...0>
    out = sum_k |psi_k|^2 d_k + bias,  d = offset + coeff * sum_i Z_i

little-endian (qubit i is bit i of the basis index), RY(t) = [[c, -s],
[s, c]], RZ(t) = diag(e^{-it/2}, e^{it/2}), RX(t) = [[c, -is], [-is, c]]
with c, s = cos(t/2), sin(t/2); the ring applies CNOT(control (i+1) mod
n, target i) for i = 0 .. n-1.

``tf32=True`` is the control: the same arithmetic with every operand of
every gate rounded to TF32 (10-bit mantissa) first, forward and backward,
as a TF32 product would read its inputs.
"""
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

LEAVES = ('ansatz', 'bias', 'branch_freq.bias', 'branch_freq.weights',
          'trunk_freq.bias', 'trunk_freq.weights')


def round_tf32(x):
    """fp32 -> the nearest TF32 value (ties to even), kept in fp32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """Round to TF32 on the way in and the cotangent on the way back."""

    @staticmethod
    def forward(ctx, x):
        return _round_any(x)

    @staticmethod
    def backward(ctx, g):
        return _round_any(g)


def _round_any(x):
    if x.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(x)))
    return round_tf32(x)


def tile(x, width):
    """(rows, m) -> (rows, width): x repeated cyclically."""
    reps = width // x.shape[-1] + 1
    return x.repeat(1, reps)[:, :width]


class Circuit:
    """The QuanONet circuit of ``config`` at its stated precision, or the
    TF32 control."""

    def __init__(self, config, device, tf32=False):
        self.n = int(config['num_qubits'])
        bd, bld, td, tld = config['net_size']
        self.lds = [tld] * td + [bld] * bd
        self.tf32 = tf32
        lo, hi = config['ham_bound']
        n = self.n
        k = np.arange(2 ** n)
        z = 1 - 2 * ((k[:, None] >> np.arange(n)) & 1)
        d = (lo + (hi - lo) / 2) + (hi - lo) / 2 / n * z.sum(1)
        self.diag = torch.tensor(d, dtype=torch.float32, device=device)
        self.cnots = []
        if n > 1:
            for i in range(n):
                c = (i + 1) % n
                self.cnots.append(torch.tensor(
                    k ^ (((k >> c) & 1) << i), device=device))

    def _r(self, x):
        return _RoundTF32.apply(x) if self.tf32 else x

    def _view(self, psi, q):
        """psi (rows, 2^n) as (rows, hi, 2, lo): axis 2 is qubit q's bit."""
        return self._r(psi).view(psi.shape[0], -1, 2, 2 ** q)

    def _rotate(self, psi, q, c, s):
        """[[c, s0], [s1, c]] on qubit q, s = (s0, s1) along axis 2: the
        halves (a0, a1) -> (c a0 + s0 a1, c a1 + s1 a0)."""
        v = self._view(psi, q)
        return torch.addcmul(c * v, v.flip(2), s).reshape(psi.shape)

    def _diagonal(self, psi, q, p):
        """diag(p0, p1) on qubit q, p along axis 2."""
        return (self._view(psi, q) * p).reshape(psi.shape)

    def gate_tables(self, ansatz):
        """The sublayers' gates from their angles (sublayers, 3, n): RY's
        c and (-s, s), RZ's (e^{-it/2}, e^{it/2}), each (sublayers, 3, n,
        2, 1) complex (axis 1: which of RY, RZ, RY')."""
        c, s = torch.cos(ansatz / 2), torch.sin(ansatz / 2)
        sign = torch.tensor([-1.0, 1.0], device=ansatz.device)[:, None]
        ry_c = self._r(torch.complex(c, torch.zeros_like(c)))
        ry_s = self._r((s[..., None, None] * sign).to(torch.complex64))
        rz = self._r(torch.complex(c[..., None, None].expand(
            *c.shape, 2, 1), s[..., None, None] * sign))
        return ry_c, ry_s, rz

    def block(self, psi, rx_c, rx_s, ry_c, ry_s, rz):
        """One block: RX on qubit j with the rows' (c, -i s) of column j of
        rx_c, rx_s (rows, n), then the sublayers of the tables."""
        rows = psi.shape[0]
        for j in range(self.n):
            psi = self._rotate(psi, j, rx_c[:, j].view(rows, 1, 1, 1),
                               rx_s[:, j].view(rows, 1, 1, 1))
        for t in range(ry_c.shape[0]):
            for q in range(self.n):
                psi = self._rotate(psi, q, ry_c[t, 0, q], ry_s[t, 0, q])
                psi = self._diagonal(psi, q, rz[t, 1, q])
                psi = self._rotate(psi, q, ry_c[t, 2, q], ry_s[t, 2, q])
            for idx in self.cnots:
                psi = psi.index_select(1, idx)
        return psi

    def expectation(self, angles, ansatz, save_memory=False):
        """<H> of each row of angles (rows, blocks * n) -> (rows,).  With
        ``save_memory`` each block's autograd graph is rebuilt in the
        backward pass (checkpointing), not kept."""
        rows, n = angles.shape[0], self.n
        half = angles / 2
        rx_c = self._r(torch.complex(torch.cos(half), torch.zeros_like(half)))
        rx_s = self._r(torch.complex(torch.zeros_like(half),
                                     -torch.sin(half)))
        tables = self.gate_tables(ansatz)
        psi = torch.zeros((rows, 2 ** n), dtype=torch.complex64,
                          device=angles.device)
        psi[:, 0] = 1
        s = 0
        for b, ld in enumerate(self.lds):
            args = (rx_c[:, b * n:(b + 1) * n], rx_s[:, b * n:(b + 1) * n],
                    *(t[s:s + ld] for t in tables))
            s += ld
            if save_memory:
                psi = checkpoint(self.block, psi, *args, use_reentrant=False)
            else:
                psi = self.block(psi, *args)
        prob = psi.real ** 2 + psi.imag ** 2
        return (self._r(prob) * self._r(self.diag)).sum(-1)


class QuanONet:
    """The reference model: ``params`` by state_dict name (see LEAVES)."""

    def __init__(self, config, device, tf32=False):
        self.circuit = Circuit(config, device, tf32)
        bd, _, td, _ = config['net_size']
        self.width_b = bd * self.circuit.n
        self.width_t = td * self.circuit.n

    def angles(self, params, branch, trunk):
        enc_t = (tile(trunk, self.width_t) * params['trunk_freq.weights']
                 + params['trunk_freq.bias'])
        enc_b = (tile(branch, self.width_b) * params['branch_freq.weights']
                 + params['branch_freq.bias'])
        return torch.cat([enc_t, enc_b], 1)

    def forward(self, params, branch, trunk, save_memory=False):
        """Predictions (rows,) of one block of rows."""
        x = self.angles(params, branch, trunk)
        out = self.circuit.expectation(x, params['ansatz'], save_memory)
        return out + params['bias']

    @torch.no_grad()
    def predict(self, params, branch, trunk, block_rows):
        """Predictions (rows,) float64 on the host, ``block_rows`` rows at
        a time."""
        out = [self.forward(params, branch[s:s + block_rows],
                            trunk[s:s + block_rows]).double().cpu()
               for s in range(0, branch.shape[0], block_rows)]
        return torch.cat(out).numpy()


def cosine_rate(peak, total_steps):
    """The learning rate of update t: cosine decay from ``peak`` to 0."""
    return lambda t: 0.5 * peak * (1 + math.cos(math.pi * min(t, total_steps)
                                                / total_steps))


def train_steps(model, params, batches, rate, start=None, betas=(0.9, 0.999),
                eps=1e-8):
    """Adam over ``batches`` [(branch, trunk, target (rows,))] from
    ``params``, the loss the mean squared error.  ``start`` (first moments,
    second moments by leaf, updates made) is Adam's state to go on from;
    None starts afresh.  Returns (the loss of each step, the gradient of
    the first step by leaf, the parameters after the last step by leaf),
    all float64 on the host."""
    p = {k: params[k].detach().clone().float() for k in LEAVES}
    if start is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v = {k: torch.zeros_like(x) for k, x in p.items()}
        done = 0
    else:
        m = {k: start[0][k].to(p[k]).clone() for k in LEAVES}
        v = {k: start[1][k].to(p[k]).clone() for k in LEAVES}
        done = int(start[2])
    losses, first_grad = [], None
    for t, (branch, trunk, target) in enumerate(batches, done):
        leaves = {k: x.clone().requires_grad_(True) for k, x in p.items()}
        pred = model.forward(leaves, branch, trunk, save_memory=True)
        loss = ((pred - target) ** 2).mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES])
        losses.append(loss.item())
        if first_grad is None:
            first_grad = {k: g.double().cpu() for k, g in zip(LEAVES, grads)}
        lr = rate(t)
        b1, b2 = betas
        with torch.no_grad():
            for k, g in zip(LEAVES, grads):
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                m_hat = m[k] / (1 - b1 ** (t + 1))
                v_hat = v[k] / (1 - b2 ** (t + 1))
                p[k] = p[k] - lr * m_hat / (v_hat.sqrt() + eps)
    return losses, first_grad, {k: x.double().cpu() for k, x in p.items()}
