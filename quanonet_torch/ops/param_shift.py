"""
Parameter-shift and SPSA gradients: the QPU-trainable path (counterpart
of quanonet_tpu/ops/param_shift.py).

Every gate of the HEA ansatz is exp(-i θ P / 2) for a Pauli word P with
eigenvalues ±1 (the RY/RZ rotations), and the encode diagonal is
Π_j exp(-i x_j Z_j / 2).  For such gates the two-point shift rule is
exact, not a finite difference:

    dE/dθ = [ E(θ + π/2) − E(θ − π/2) ] / 2

* :func:`make_ps_expectation`: the expectation as a
  ``torch.autograd.Function`` whose backward is the shift rule for the
  ansatz weights and for the encode inputs, so autograd carries the input
  cotangent on into the TrainableFreq layers and the whole QuanONet trains
  from circuit evaluations alone.  With ``shots`` every shifted evaluation
  is finite-shot sampled from its own generator, the unbiased stochastic
  gradient a device would deliver;
* :func:`shift_jacobian`: the exact per-sample Jacobian dE/dw, an
  independent gradient oracle;
* :func:`spsa_gradient` / :func:`make_spsa_step`: the two-evaluation
  simultaneous-perturbation estimator (Spall 1992) over a dict of
  tensors, and a step over a ``torch.optim`` optimizer.

The fan-out.  One backward runs 2·(S·3·n) + 2·(nb·n) evaluations beside
the forward; ``chunk`` (``--ps_chunk``) bounds how many shift indices go
at once.  On the block chain (engines ``pallas`` and ``dense``):

* the 2·n_x encode shifts share the block matrices, so a chunk of C
  columns is one batch of 2·C·N rows through one chain launch (B1f on
  ``cuda``; at the flagship, unchunked, 60,000 rows);
* a weight shift changes one block's matrices, so only that block is
  compiled again: the shifted blocks of a chunk in one compile launch
  (B4f, the Hadamard right factor on every block), those of the final
  block, whose right factor is I, one launch each; each shifted set's
  matrices are the base set with its block replaced, built a slice of
  sets at a time under ``SET_BYTES``, and each set runs its own chain
  launch on the shared phases.

Other engines (``pfused``, ``fused``, ``gates``, ``embed``) evaluate each
weight set through their forward, and the encode shifts as one batch.
Every evaluation runs without autograd, so on ``cuda`` only the forward
kernels launch.  Evaluation i of a sampled backward draws from
``fold_in(generator, i)`` (the JAX package's indexing: 0 the forward,
1 + p and 1 + P + p the weight shifts, 1 + 2P + j and 1 + 2P + n_x + j
the input shifts), so a chunked and an unchunked backward draw the same
bits.
"""
import numpy as np
import torch

from quanonet_torch.ops import cuda_hea as _cuda_hea
from quanonet_torch.ops import cuda_ucomp as _ucomp
from quanonet_torch.ops import hea as _hea
from quanonet_torch.ops.sampling import (
    fold_in, measurement_diag, rotate_to_pauli_basis, shot_expectation,
    shot_expectation_pair,
)

SHIFT = 0.5 * np.pi
# the most bytes of shifted weight sets' block matrices (nb, D, D) x2 held
# at once: 68 sets at Q7 Net40-2-20-2, 1,092 at the flagship (Q5)
SET_BYTES = 1 << 29


def _chunks(n, chunk):
    """[start, stop) ranges covering range(n), ``chunk`` at a time (all at
    once when chunk is None or at least n)."""
    step = n if not chunk or chunk >= n else int(chunk)
    return [(s, min(s + step, n)) for s in range(0, n, max(step, 1))]


def shifted_block_weights(spec, weights, sets):
    """The compile route's inputs for the shifted weight sets (p, sign) of
    a spec with one uniform linear depth ld: (blocks, slices), each set's
    block index and its block's (ld, 3, n) slice of the weights with
    weight p shifted by sign·π/2."""
    ld = spec.block_configs[0][1]
    per_block = ld * 3 * spec.n_qubits
    blocks, slices = [], []
    for p, sign in sets:
        b = p // per_block
        w = weights[b * ld:(b + 1) * ld].clone()
        w.view(-1)[p - b * per_block] += sign * SHIFT
        blocks.append(b)
        slices.append(w)
    return blocks, slices


class _Circuit:
    """One circuit and observable, evaluated exactly or with ``shots``."""

    def __init__(self, spec, diag, pauli, offset, coeff, engine, shots,
                 chunk):
        self.spec = spec
        self.pauli = pauli
        self.diag = diag
        self.offset, self.coeff = offset, coeff
        self.engine = engine
        self.shots = int(shots) if shots else None
        self.chunk = chunk
        if self.shots:
            self.mdiag = measurement_diag(spec.n_qubits, pauli, diag, offset,
                                          coeff)
        elif pauli == 'Z' and diag is None:
            raise ValueError("Z-basis measurement requires a diagonal")

    # ── evaluation ───────────────────────────────────────────────────────
    def expectation(self, weights, x, generator, index):
        """Evaluation ``index``: (N, 1), as hea_expectation /
        shot_expectation compute it."""
        if self.shots:
            return shot_expectation(
                fold_in(generator, index), self.spec, weights, x, self.shots,
                diag=self.diag, pauli=self.pauli, offset=self.offset,
                coeff=self.coeff, engine=self.engine)
        return _hea.hea_expectation(self.spec, weights, x, diag=self.diag,
                                    pauli=self.pauli, offset=self.offset,
                                    coeff=self.coeff, engine=self.engine)

    def _measure(self, sr, si, generator, indices):
        """States (G, N, D) -> expectations (G, N); group g is evaluation
        indices[g]."""
        g_, n, d = sr.shape
        if self.shots:
            sr, si = rotate_to_pauli_basis(sr.reshape(-1, d),
                                           si.reshape(-1, d), self.pauli,
                                           self.spec.n_qubits)
            sr, si = sr.reshape(g_, n, d), si.reshape(g_, n, d)
            return torch.stack([
                shot_expectation_pair(fold_in(generator, i), sr[k], si[k],
                                      self.mdiag, self.shots)[:, 0]
                for k, i in enumerate(indices)])
        sr, si = sr.reshape(-1, d), si.reshape(-1, d)
        if self.pauli == 'Z':
            diag = torch.as_tensor(self.diag, dtype=torch.float32,
                                   device=sr.device)
            e = _hea.diag_expectation_pair(sr, si, diag)
        else:
            e = _hea.pauli_sum_expectation_pair(
                sr, si, self.pauli, self.spec.n_qubits, self.offset,
                self.coeff)
        return e.reshape(g_, n)

    # ── the fan-out ──────────────────────────────────────────────────────
    def _route(self, device):
        """(engine, chain) : chain is the block-chain function when the
        engine runs the block chain, else None."""
        engine = _hea.resolve_engine(self.engine, self.spec.n_qubits, device)
        if engine in ('pallas', 'dense') and self.spec.uniform_encode:
            return engine, (_cuda_hea.block_chain if engine == 'pallas'
                            else _hea.chain_dense)
        return engine, None

    def _operands(self, engine, weights, x):
        if engine == 'pallas':
            return _cuda_hea._prepare(self.spec, weights, x)
        return _hea.prepare_chain(self.spec, weights, x)

    def _shifted_blocks(self, engine, weights, sets):
        """The block index and block matrices (mt_r, mt_i) of each shifted
        weight set (p, sign): (blocks, [(D, D)] mt_r, [(D, D)] mt_i)."""
        spec = self.spec
        if engine == 'pallas' and _cuda_hea.compile_route(
                _cuda_hea.USE_UCOMP, spec, weights.device.type):
            ld = spec.block_configs[0][1]
            last = spec.n_blocks - 1
            blocks, wb = shifted_block_weights(spec, weights, sets)
            inner = [k for k, b in enumerate(blocks) if b != last]
            mats_r = [None] * len(sets)
            mats_i = [None] * len(sets)
            if inner:
                mr, mi = _ucomp.ucomp(torch.cat([wb[k] for k in inner]),
                                      ld, -1)
                for j, k in enumerate(inner):
                    mats_r[k], mats_i[k] = mr[j], mi[j]
            for k, b in enumerate(blocks):
                if b == last:                 # right factor I: its own launch
                    mr, mi = _ucomp.ucomp(wb[k], ld, 0)
                    mats_r[k], mats_i[k] = mr[0], mi[0]
            return blocks, mats_r, mats_i
        per_sub = 3 * spec.n_qubits
        subs = np.cumsum([0] + [ld for _, ld in spec.block_configs])
        blocks, mats_r, mats_i = [], [], []
        for p, sign in sets:
            b = int(np.searchsorted(subs, p // per_sub, side='right')) - 1
            w = weights.clone()
            w.view(-1)[p] += sign * SHIFT
            mr, mi = _hea.fold_block_mats(spec, w)
            blocks.append(b)
            mats_r.append(mr[b].clone())      # not a view of all nb blocks
            mats_i.append(mi[b].clone())
        return blocks, mats_r, mats_i

    def _weight_states(self, weights, x, route, ops, sets):
        """Final states (G, N, D) ×2 of the weight sets (p, sign)."""
        engine, chain = route
        if chain is None:
            outs = []
            for p, sign in sets:
                w = weights.clone()
                w.view(-1)[p] += sign * SHIFT
                outs.append(_hea.hea_forward_pair(self.spec, w, x,
                                                  engine=engine))
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]))
        mt_r, mt_i, phi = ops
        blocks, br, bi = self._shifted_blocks(engine, weights, sets)
        g_, n, d = len(sets), phi.shape[1], mt_r.shape[-1]
        out_r = mt_r.new_empty((g_, n, d))
        out_i = mt_r.new_empty((g_, n, d))
        # the sets' matrices, base with its block replaced, a slice of sets
        # at a time under SET_BYTES
        per_set = 2 * mt_r.numel() * mt_r.element_size()
        step = max(1, SET_BYTES // per_set)
        for s0 in range(0, g_, step):
            s1 = min(s0 + step, g_)
            at = torch.arange(s1 - s0, device=mt_r.device)
            bidx = torch.as_tensor(blocks[s0:s1], device=mt_r.device)
            sets_r = mt_r.expand(s1 - s0, *mt_r.shape).clone()
            sets_i = mt_i.expand(s1 - s0, *mt_i.shape).clone()
            sets_r[at, bidx] = torch.stack(br[s0:s1])
            sets_i[at, bidx] = torch.stack(bi[s0:s1])
            outs = [chain(sets_r[k], sets_i[k], phi)
                    for k in range(s1 - s0)]
            out_r[s0:s1] = torch.stack([o[0] for o in outs])
            out_i[s0:s1] = torch.stack([o[1] for o in outs])
        return out_r, out_i

    def _input_states(self, weights, xs, route, ops):
        """Final states of the rows xs (R, n_x) at the unshifted weights."""
        engine, chain = route
        if chain is None:
            return _hea.hea_forward_pair(self.spec, weights, xs,
                                         engine=engine)
        mt_r, mt_i, _ = ops
        return chain(mt_r, mt_i, _hea.encoding_phases(self.spec, xs))

    def weight_terms(self, weights, x, generator, route, ops, p0, p1):
        """(E(w + π/2 e_p), E(w − π/2 e_p)) for p in [p0, p1), each
        (p1 − p0, N)."""
        n_w = weights.numel()
        ps = range(p0, p1)
        sets = [(p, 1.0) for p in ps] + [(p, -1.0) for p in ps]
        sr, si = self._weight_states(weights, x, route, ops, sets)
        e = self._measure(sr, si, generator,
                          [1 + p for p in ps] + [1 + n_w + p for p in ps])
        return e[:p1 - p0], e[p1 - p0:]

    def input_terms(self, weights, x, generator, route, ops, j0, j1):
        """(E(x + π/2 e_j), E(x − π/2 e_j)) for j in [j0, j1), each
        (j1 − j0, N)."""
        n_w = weights.numel()
        n, n_x = x.shape
        c = j1 - j0
        xs = x.unsqueeze(0).repeat(2 * c, 1, 1)
        for k, j in enumerate(range(j0, j1)):
            xs[k, :, j] += SHIFT
            xs[c + k, :, j] -= SHIFT
        sr, si = self._input_states(weights, xs.reshape(2 * c * n, n_x),
                                    route, ops)
        d = sr.shape[-1]
        base = 1 + 2 * n_w
        e = self._measure(sr.reshape(2 * c, n, d), si.reshape(2 * c, n, d),
                          generator,
                          [base + j for j in range(j0, j1)]
                          + [base + n_x + j for j in range(j0, j1)])
        return e[:c], e[c:]

    def vjp(self, weights, x, generator, g, need_w=True, need_x=True):
        """The shift-rule cotangents (w̄, x̄) of the expectation for its
        cotangent g (N, 1)."""
        route = self._route(x.device)
        ops = (self._operands(route[0], weights, x)
               if route[1] is not None else None)
        g = g[:, 0]
        gw = gx = None
        if need_w:
            gw = torch.empty(weights.numel(), dtype=weights.dtype,
                             device=weights.device)
            for p0, p1 in _chunks(weights.numel(), self.chunk):
                ep, em = self.weight_terms(weights, x, generator, route, ops,
                                           p0, p1)
                gw[p0:p1] = 0.5 * ((ep - em) * g).sum(-1)
            gw = gw.reshape(weights.shape)
        if need_x:
            gx = torch.empty_like(x)
            for j0, j1 in _chunks(x.shape[1], self.chunk):
                ep, em = self.input_terms(weights, x, generator, route, ops,
                                          j0, j1)
                gx[:, j0:j1] = (0.5 * (ep - em) * g).T
        return gw, gx


class _ShiftRule(torch.autograd.Function):
    """(weights, x) -> ⟨H⟩ (N, 1) with the shift rule as its backward."""

    @staticmethod
    def forward(ctx, weights, x, circuit, generator):
        ctx.save_for_backward(weights, x)
        ctx.circuit, ctx.generator = circuit, generator
        return circuit.expectation(weights, x, generator, 0)

    @staticmethod
    def backward(ctx, g):
        weights, x = ctx.saved_tensors
        with torch.no_grad():
            gw, gx = ctx.circuit.vjp(weights, x, ctx.generator, g,
                                     need_w=ctx.needs_input_grad[0],
                                     need_x=ctx.needs_input_grad[1])
        return gw, gx, None, None


def make_ps_expectation(spec, diag=None, pauli='Z', offset=0.0, coeff=0.0,
                        engine='auto', shots=None, chunk=None):
    """The shift-rule expectation of a fixed circuit and observable.

    Returns ``f(weights, x)`` (exact) or, with ``shots``,
    ``f(weights, x, generator)`` (finite-shot sampled, independent shot
    noise in each shifted evaluation).  Output (N, 1) float32, the values
    of hea_expectation / shot_expectation; the backward is the exact
    two-point shift rule instead of autograd through the circuit."""
    circuit = _Circuit(spec, diag, pauli, offset, coeff, engine, shots,
                       chunk)
    if not shots:
        def f(weights, x):
            return _ShiftRule.apply(weights, x, circuit, None)
        return f

    def fs(weights, x, generator):
        if generator is None:
            raise ValueError("a sampled expectation needs a generator")
        return _ShiftRule.apply(weights, x, circuit, generator)
    return fs


def shift_jacobian(spec, weights, x, diag=None, pauli='Z', offset=0.0,
                   coeff=0.0, engine='auto', chunk=None):
    """The exact per-sample Jacobian dE/dw, shape (N,) + weight_shape,
    from 2·P forward evaluations: what autograd computes, through nothing
    but shifted circuits."""
    circuit = _Circuit(spec, diag, pauli, offset, coeff, engine, None, chunk)
    with torch.no_grad():
        route = circuit._route(x.device)
        ops = (circuit._operands(route[0], weights, x)
               if route[1] is not None else None)
        cols = []
        for p0, p1 in _chunks(weights.numel(), chunk):
            ep, em = circuit.weight_terms(weights, x, None, route, ops,
                                          p0, p1)
            cols.append(0.5 * (ep - em))
        jac = torch.cat(cols)                            # (P, N)
    return jac.T.reshape((x.shape[0],) + tuple(weights.shape))


# ── SPSA ─────────────────────────────────────────────────────────────────────

def rademacher(generator, like):
    """±1 with equal odds in ``like``'s shape, dtype and device; zeros for
    a tensor that is not floating point."""
    if not like.is_floating_point():
        return torch.zeros_like(like)
    r = torch.randint(0, 2, like.shape, generator=generator,
                      device=like.device)
    return (2 * r - 1).to(like.dtype)


def spsa_gradient(loss_fn, params, generator, c=0.05):
    """The simultaneous-perturbation gradient from two loss evaluations:
    ĝ = Δ · [L(θ + cΔ) − L(θ − cΔ)] / (2c), Rademacher Δ (1/Δ_i = Δ_i).
    ``params`` is a dict name -> tensor, and ``loss_fn`` takes one.
    Returns (ĝ as such a dict, (L⁺ + L⁻)/2)."""
    with torch.no_grad():
        deltas = {k: rademacher(generator, t) for k, t in params.items()}
        lp = loss_fn({k: t + c * deltas[k] for k, t in params.items()})
        lm = loss_fn({k: t - c * deltas[k] for k, t in params.items()})
        scale = (lp - lm) / (2.0 * c)
        return {k: scale * d for k, d in deltas.items()}, 0.5 * (lp + lm)


def make_spsa_step(loss_fn, optimizer, params, c=0.05):
    """An SPSA step for a ``torch.optim``-style optimizer over the dict
    ``params`` (name -> parameter): ``step(generator) -> loss_mid`` sets
    each parameter's ``.grad`` to the estimate and steps the optimizer."""
    def step(generator):
        grads, loss = spsa_gradient(
            loss_fn, {k: p.detach() for k, p in params.items()}, generator,
            c=c)
        optimizer.zero_grad()
        for k, p in params.items():
            p.grad = grads[k]
        optimizer.step()
        return loss
    return step
