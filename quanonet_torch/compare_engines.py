"""
Cross-engine consistency gate of the port (counterpart of the repository's
compare_engines.py): the port's engines against each other at the same
inputs, seeds and tolerances.

  1. QuanONet Q4 (5, 2, 4, 1): dense ≡ gates ≡ fused ≡ pallas ≡ embed,
     forward and gradient
  2. HEAQNN Q3 (6, 2): the same
  3. ham_diag rank-1 and uniform rank-4, and the X/Y Pauli sums: dense ≡
     gates
  4. the golden Antideriv .npz: every engine agrees
  5. the golden Advection .ckpt loads and runs
  6. FNN / DeepONet / FNO: 20 Adam steps (the solver's optimizer) lower
     the loss
  7. fused ≡ pfused at Q8 (one batch and one of 16 rows, at least two
     CTAs of the fused-group kernel's geometry, so that the cross-CTA
     sums of x̄ and ū run), at Q12, and at Q14 on ``cuda`` only

On ``cuda``, ``pallas``, ``embed`` and ``pfused`` are the hand-written
kernels (B1, B3, B2; the block matrices from the compile kernels B4 where
``cuda_hea.compile_route`` takes them); on the CPU their plain versions.
Tolerances: forward 1e-4 (quantum), gradients 1e-4, classical 1e-5.

CLI:  python -m quanonet_torch.compare_engines [--device cuda|cpu]
          [--out compare_engines_torch_result.json]
Writes {"platform", "device_name", "passed", "total", "all_ok", "checks"}
to --out and exits 1 when a check fails; a group that raises is a failed
check.
"""
import argparse
import json
import os
import platform as _platform

import numpy as np
import torch

from quanonet_torch import checkpoint as ckpt_io
from quanonet_torch import resolve_device
from quanonet_torch.convert import state_dict_from_raw
from quanonet_torch.ops import cuda_fused
from quanonet_torch.ops.hamiltonian import (
    generate_ham_diag_rank1, generate_ham_spectrum_uniform, simple_ham_diag,
)
from quanonet_torch.ops.hea import hea_expectation, heaqnn_spec, quanonet_spec

FWD_TOL_QUANTUM = 1e-4
GRAD_TOL = 1e-4
FWD_TOL_CLASSICAL = 1e-5

ENGINES = ('dense', 'gates', 'fused', 'pallas', 'embed')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANTIDERIV = os.path.join(
    REPO, 'pretrained_weights', 'Antideriv',
    'Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_1000x100_Seed0',
    'best_model.npz')
ADVECTION = os.path.join(
    REPO, 'pretrained_weights', 'Advection',
    'Advection_QuanONet_Net40-2-20-2_Q5_TF_S0.1_1000x100_Seed0',
    'best_model.ckpt')
PFUSED_ROWS = 16          # the multi-CTA case's batch


def _uniform(rng, shape, lo, hi):
    return rng.uniform(lo, hi, shape).astype(np.float32)


# ── the groups' inputs (NumPy, from the seeds of compare_engines.py) ────────

def quanonet_inputs():
    """Group 1: (spec, w, x, diag) of QuanONet Q4 (5, 2, 4, 1)."""
    spec = quanonet_spec(4, (5, 2, 4, 1))
    rng = np.random.RandomState(0)
    w = _uniform(rng, spec.weight_shape(), -np.pi, np.pi)
    x = _uniform(rng, (6, spec.total_encode), -2, 2)
    return spec, w, x, simple_ham_diag(4, -5, 5)


def heaqnn_inputs():
    """Group 2: (spec, w, x, diag) of HEAQNN Q3 (6, 2)."""
    spec = heaqnn_spec(3, (6, 2))
    rng = np.random.RandomState(1)
    w = _uniform(rng, spec.weight_shape(), -np.pi, np.pi)
    x = _uniform(rng, (5, spec.total_encode), -2, 2)
    return spec, w, x, simple_ham_diag(3, -5, 5)


def ham_inputs():
    """Group 3: (spec, w, x, {name: diag})."""
    spec = heaqnn_spec(3, (3, 1))
    rng = np.random.RandomState(2)
    w = _uniform(rng, spec.weight_shape(), -np.pi, np.pi)
    x = _uniform(rng, (4, spec.total_encode), -1, 1)
    diags = {'rank1': generate_ham_diag_rank1(3, seed=0),
             'uniform_rank4': generate_ham_spectrum_uniform(3, 4, seed=0)}
    return spec, w, x, {k: v.astype(np.float32) for k, v in diags.items()}


def pfused_inputs():
    """Group 7: {label: (spec, w, x, diag)} in the draw order of
    compare_engines.py (Q8, Q8 on PFUSED_ROWS rows, Q12, Q14)."""
    rng = np.random.RandomState(5)
    spec8 = quanonet_spec(8, (4, 2, 3, 1))
    w8 = _uniform(rng, spec8.weight_shape(), -np.pi, np.pi)
    x8 = _uniform(rng, (6, spec8.total_encode), -2, 2)
    d8 = simple_ham_diag(8, -5, 5)
    x8b = _uniform(rng, (PFUSED_ROWS, spec8.total_encode), -2, 2)
    out = {'Q8': (spec8, w8, x8, d8), 'Q8 multi-CTA': (spec8, w8, x8b, d8)}
    for nq in (12, 14):
        spec = quanonet_spec(nq, (2, 1, 1, 1))
        w = _uniform(rng, spec.weight_shape(), -np.pi, np.pi)
        x = _uniform(rng, (4, spec.total_encode), -2, 2)
        out[f'Q{nq}'] = (spec, w, x, simple_ham_diag(nq, -5, 5))
    return out


def engine_run(spec, w, x, engine, device, power=1, **obs):
    """(forward (N, 1), gradient of Σ out^power in w) as NumPy arrays."""
    wt = torch.tensor(w, device=device, requires_grad=True)
    out = hea_expectation(spec, wt, torch.tensor(x, device=device),
                          engine=engine, **obs)
    (out ** power).sum().backward()
    return out.detach().cpu().numpy(), wt.grad.cpu().numpy()


def forward_run(spec, w, x, engine, device, **obs):
    """The forward alone, (N, 1) NumPy."""
    with torch.no_grad():
        return hea_expectation(spec, torch.tensor(w, device=device),
                               torch.tensor(x, device=device),
                               engine=engine, **obs).cpu().numpy()


class Gate:
    """The checks of one run on one device."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self.results = []

    def report(self, name, passed, detail=""):
        passed = bool(passed)
        print(f"[{'PASS' if passed else 'FAIL'}] {name} {detail}",
              flush=True)
        self.results.append((name, passed))
        return passed

    def _agree(self, label, outs, grads=None, extra=None):
        """Every engine against the first, forward and gradient; ``extra``
        (condition, detail) joins each check."""
        ok = True
        base = next(iter(outs))
        for eng in list(outs)[1:]:
            df = float(np.abs(outs[eng] - outs[base]).max())
            detail = f"(fwd {df:.2e}"
            good = df <= FWD_TOL_QUANTUM
            if grads is not None:
                dg = float(np.abs(grads[eng] - grads[base]).max())
                detail += f", grad {dg:.2e}"
                good = good and dg <= GRAD_TOL
            if extra is not None:
                good = good and extra[0]
                detail += f", {extra[1]}"
            ok &= self.report(f"{label} {base}≡{eng}", good, detail + ")")
        return ok

    def quanonet_engines(self):
        spec, w, x, diag = quanonet_inputs()
        runs = {e: engine_run(spec, w, x, e, self.device, 2, diag=diag)
                for e in ENGINES}
        return self._agree("QuanONet", {e: r[0] for e, r in runs.items()},
                           {e: r[1] for e, r in runs.items()})

    def heaqnn_engines(self):
        spec, w, x, diag = heaqnn_inputs()
        runs = {e: engine_run(spec, w, x, e, self.device, 1, diag=diag)
                for e in ENGINES}
        return self._agree("HEAQNN", {e: r[0] for e, r in runs.items()},
                           {e: r[1] for e, r in runs.items()})

    def ham_variants(self):
        spec, w, x, diags = ham_inputs()
        ok = True
        for name, diag in diags.items():
            ok &= self._agree(f"ham_diag[{name}]", {
                e: forward_run(spec, w, x, e, self.device, diag=diag)
                for e in ('dense', 'gates')})
        for pauli in ('X', 'Y'):
            ok &= self._agree(f"ham_pauli[{pauli}]", {
                e: forward_run(spec, w, x, e, self.device, pauli=pauli,
                               offset=0.0, coeff=1.0)
                for e in ('dense', 'gates')})
        return ok

    def golden_npz(self):
        from quanonet_torch.models import QuanONet
        if not os.path.exists(ANTIDERIV):
            return self.report("golden Antideriv npz", True,
                               "(skipped: not mounted)")
        sd = state_dict_from_raw(ckpt_io.load_raw(ANTIDERIV), 'QuanONet',
                                 (5, 1, 5, 1), 2, True)
        rng = np.random.RandomState(3)
        b = torch.tensor(rng.randn(8, 10).astype(np.float32),
                         device=self.device)
        t = torch.tensor(rng.rand(8, 1).astype(np.float32),
                         device=self.device)
        outs = []
        for eng in ENGINES:
            model = QuanONet(2, 10, 1, (5, 1, 5, 1), scale_coeff=0.001,
                             engine=eng, device=self.device)
            model.load_state_dict(sd)
            with torch.no_grad():
                outs.append(model(b, t).cpu().numpy())
        df = max(float(np.abs(o - outs[0]).max()) for o in outs[1:])
        return self.report("golden Antideriv npz engines agree",
                           df <= FWD_TOL_QUANTUM, f"(max diff {df:.2e})")

    def golden_ckpt(self):
        from quanonet_torch.models import QuanONet
        if not os.path.exists(ADVECTION):
            return self.report("golden Advection ckpt", True,
                               "(skipped: not mounted)")
        model = QuanONet(5, 100, 2, (40, 2, 20, 2), scale_coeff=0.1,
                         engine='dense', device=self.device)
        model.load_state_dict(state_dict_from_raw(
            ckpt_io.load_raw(ADVECTION), 'QuanONet', (40, 2, 20, 2), 5,
            True))
        rng = np.random.RandomState(4)
        with torch.no_grad():
            out = model(torch.tensor(rng.randn(4, 100).astype(np.float32),
                                     device=self.device),
                        torch.tensor(rng.rand(4, 2).astype(np.float32),
                                     device=self.device)).cpu().numpy()
        ok = bool(np.isfinite(out).all() and np.abs(out).max() < 10)
        return self.report("golden Advection ckpt loads+runs", ok,
                           f"(outputs {out.ravel()[:2]})")

    def classical_models(self):
        from quanonet_torch.models import (
            FNN, FNO, DeepONet, deeponet_layer_sizes,
        )
        from quanonet_torch.solver import build_optimizer
        dev = self.device
        rng = np.random.RandomState(5)

        def t(a):
            return torch.tensor(a.astype(np.float32), device=dev)
        x, y = t(rng.randn(32, 8)), t(rng.randn(32, 1))
        gen = torch.Generator().manual_seed(0)
        bl, tl = deeponet_layer_sizes([2, 16], 8, 1)
        cases = [('FNN', FNN(8, (2, 16), device=dev, generator=gen), (x,),
                  y),
                 ('DeepONet', DeepONet(8, 1, bl, tl, device=dev,
                                       generator=gen),
                  (x, t(rng.rand(32, 1))), y)]
        xg, yg = t(rng.randn(8, 32, 2)), t(rng.randn(8, 32, 1))
        cases.append(('FNO', FNO(2, modes=6, width=8, layers=1,
                                 fc_hidden=8, device=dev, generator=gen),
                      (xg,), yg))
        ok = True
        for name, model, inputs, target in cases:
            opt = build_optimizer({'learning_rate': 1e-2}, 20,
                                  model.parameters())

            def loss_fn():
                return ((model(*inputs) - target) ** 2).mean()
            with torch.no_grad():
                l0 = float(loss_fn())
            for _ in range(20):
                opt.zero_grad()
                loss_fn().backward()
                opt.step()
            with torch.no_grad():
                l1 = float(loss_fn())
            ok &= self.report(f"{name} trains", np.isfinite(l1) and l1 < l0,
                              f"(loss {l0:.4f} -> {l1:.4f})")
        return ok

    def pfused_engine(self):
        cases = pfused_inputs()
        ok = True
        for label, (spec, w, x, diag) in cases.items():
            if label == 'Q14' and self.device.type != 'cuda':
                print(f"[SKIP] {label} fused≡pfused — card-only gate (the "
                      f"plain fused chain at Q14 is minutes on the CPU)",
                      flush=True)
                continue
            runs = {e: engine_run(spec, w, x, e, self.device, 2, diag=diag)
                    for e in ('fused', 'pfused')}
            extra = None
            if label == 'Q8 multi-CTA':      # the kernel's CTAs at this batch
                sms = (torch.cuda.get_device_properties(
                    self.device).multi_processor_count
                    if self.device.type == 'cuda' else 132)
                ctas = -(-x.shape[0]
                         // cuda_fused.rows_per_cta(8, x.shape[0], sms))
                extra = (ctas >= 2, f"{ctas} CTAs")
            ok &= self._agree(label, {e: r[0] for e, r in runs.items()},
                              {e: r[1] for e, r in runs.items()}, extra)
        return ok

    GROUPS = ('quanonet_engines', 'heaqnn_engines', 'ham_variants',
              'golden_npz', 'golden_ckpt', 'classical_models',
              'pfused_engine')

    def run(self):
        """Every group; -> the artifact."""
        all_ok = True
        for g in self.GROUPS:
            try:
                all_ok &= bool(getattr(self, g)())
            except Exception as e:          # a group that raises fails
                self.report(g, False, f"(exception: {e!r})")
                all_ok = False
        n_pass = sum(1 for _, p in self.results if p)
        print(f"\n{'=' * 60}\n{n_pass}/{len(self.results)} checks passed")
        return {"platform": self.device.type,
                "device_name": (torch.cuda.get_device_name(self.device)
                                if self.device.type == 'cuda'
                                else _platform.processor() or 'cpu'),
                "passed": n_pass, "total": len(self.results),
                "all_ok": bool(all_ok),
                "checks": {name: p for name, p in self.results}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    ap.add_argument('--out', default='compare_engines_torch_result.json',
                    help='where the JSON artifact goes')
    args = ap.parse_args(argv)
    artifact = Gate(args.device).run()
    with open(args.out, 'w') as f:
        json.dump(artifact, f, indent=1)
    print(f"artifact: {args.out}")
    return 0 if artifact["all_ok"] else 1


if __name__ == '__main__':
    raise SystemExit(main())
