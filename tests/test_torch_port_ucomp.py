"""
The port's block-matrix compile (quanonet_torch/ops/cuda_ucomp.py) on the
CPU, where its wrappers take the plain versions, held against the JAX
package's pallas_ucomp (Pallas in interpret mode) and against the port's
own autograd fold (hea.fold_block_mats): the matrices, the gradients with
respect to the weights, the USE_UCOMP route of the 'pallas' engine, and
profile_step, the entry point that drives it.

Tolerances are the JAX test's own (tests/test_ucomp.py): 2e-6 on the
matrices (entries of unitaries, fp32 products in another order), atol 5e-5
and rtol 1e-4 on the weight gradients under a random cotangent, 5e-6 on the
expectation end to end.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_tpu.ops import pallas_ucomp
from quanonet_tpu.ops import hea as j_hea
from quanonet_torch import profile_step
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import cuda_hea, cuda_ucomp, hea
from quanonet_torch.ops.hamiltonian import simple_ham_diag
from quanonet_torch.profile_step import launches_of

CASES = [    # (spec function, qubits, net_size): the JAX test's specs
    ('quanonet_spec', 2, (3, 1, 2, 1)),       # ld = 1
    ('quanonet_spec', 3, (2, 3, 2, 3)),       # ld = 3
    ('heaqnn_spec', 4, (5, 2)),               # single stream
    ('quanonet_spec', 7, (2, 2, 2, 2)),       # D = 128
    ('quanonet_spec', 5, (40, 2, 20, 2)),     # flagship
]
IDS = [f"q{nq}-{'-'.join(map(str, net))}" for _, nq, net in CASES]


def _specs(make_spec, nq, net):
    return getattr(hea, make_spec)(nq, net), getattr(j_hea, make_spec)(nq, net)


def _weights(spec, seed):
    rng = np.random.RandomState(seed)
    return rng, rng.uniform(-np.pi, np.pi,
                            spec.weight_shape()).astype(np.float32)


@pytest.mark.parametrize("make_spec,nq,net", CASES, ids=IDS)
def test_compile_block_mats_matches_jax_and_fold(make_spec, nq, net):
    spec, jspec = _specs(make_spec, nq, net)
    assert cuda_ucomp.ucomp_applicable(spec)
    _, w = _weights(spec, 0)
    got = cuda_ucomp.compile_block_mats(spec, torch.tensor(w))
    want_j = pallas_ucomp.compile_block_mats(jspec, jnp.asarray(w))
    want_t = hea.fold_block_mats(spec, torch.tensor(w))
    for g, wj, wt in zip(got, want_j, want_t):
        assert g.shape == (spec.n_blocks, spec.dim, spec.dim)
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), atol=2e-6)
        np.testing.assert_allclose(g.numpy(), wt.numpy(), atol=2e-6)


@pytest.mark.parametrize("make_spec,nq,net", CASES[:4], ids=IDS[:4])
def test_weight_gradients_match_jax_and_fold(make_spec, nq, net):
    """UComp with the written-out plain backward against jax.grad through
    pallas_ucomp and against autograd through the fold, D = 128 included."""
    spec, jspec = _specs(make_spec, nq, net)
    rng, w = _weights(spec, 1)
    pr, pi = (rng.randn(spec.n_blocks, spec.dim, spec.dim).astype(np.float32)
              for _ in range(2))

    def j_loss(w):
        mr, mi = pallas_ucomp.compile_block_mats(jspec, w)
        return jnp.sum(mr * pr) + jnp.sum(mi * pi)

    def t_grad(fn):
        wt = torch.tensor(w, requires_grad=True)
        mr, mi = fn(spec, wt)
        (g,) = torch.autograd.grad(
            (mr * torch.tensor(pr)).sum() + (mi * torch.tensor(pi)).sum(), wt)
        return g.numpy()

    got = t_grad(cuda_ucomp.compile_block_mats)
    np.testing.assert_allclose(got, np.asarray(jax.grad(j_loss)(
        jnp.asarray(w))), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got, t_grad(hea.fold_block_mats),
                               atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("nq,ld,nb,last", [(2, 1, 3, 2), (3, 3, 2, 1),
                                           (4, 2, 4, -1), (3, 2, 1, 0)])
def test_backward_dense_matches_autograd(nq, ld, nb, last):
    """ucomp_backward_dense against autograd of ucomp_dense on random
    operands (1e-5 x max(1, max|.|): not unitary, values in the tens)."""
    dim = 2 ** nq
    g = torch.Generator().manual_seed(nq)
    ops = [torch.randn(nb * ld, dim, dim, generator=g, requires_grad=True)
           for _ in range(3)]
    ct = [torch.randn(nb, dim, dim, generator=g) for _ in range(2)]
    mr, mi = cuda_ucomp.ucomp_dense(*ops, ld, last)
    want = torch.autograd.grad((mr * ct[0]).sum() + (mi * ct[1]).sum(), ops)
    with torch.no_grad():
        got = cuda_ucomp.ucomp_backward_dense(*ops, ld, last, *ct)
    for a, b in zip(got, want):
        tol = 1e-5 * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= tol
    # the wrapper on CPU weights: the plain versions, and no launch
    w = torch.tensor(np.random.RandomState(nq).uniform(
        -np.pi, np.pi, (nb * ld, 3, nq)).astype(np.float32),
        requires_grad=True)
    before = launches_of('ucomp_fwd', 'ucomp_bwd')
    out = cuda_ucomp.ucomp(w, ld, last)
    (via,) = torch.autograd.grad(
        (out[0] * ct[0]).sum() + (out[1] * ct[1]).sum(), w)
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(
            out, cuda_ucomp.ucomp_weights_dense(w, ld, last)))
        assert torch.equal(via, cuda_ucomp.ucomp_weights_backward_dense(
            w, ld, last, *ct))
    assert launches_of('ucomp_fwd', 'ucomp_bwd') == before


@pytest.mark.parametrize("nq,ld,nb,last", [(2, 1, 3, 2), (3, 3, 2, 1),
                                           (4, 2, 4, -1), (3, 2, 1, 0),
                                           (7, 2, 2, 1)])
def test_weight_backward_dense_matches_autograd(nq, ld, nb, last):
    """The plain weight backward (ucomp_backward_dense's operand
    cotangents carried through compile_operands' VJP) against autograd of
    the plain forward (ucomp_dense of compile_operands), D = 128 included
    (1e-5 x max(1, max|.|): two fp32 orders of the same products)."""
    rng = np.random.RandomState(10 + nq)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, (nb * ld, 3, nq))
                     .astype(np.float32), requires_grad=True)
    dim = 2 ** nq
    ct = [torch.tensor(rng.randn(nb, dim, dim).astype(np.float32))
          for _ in range(2)]
    mr, mi = cuda_ucomp.ucomp_dense(*cuda_ucomp.compile_operands(w), ld, last)
    (want,) = torch.autograd.grad((mr * ct[0]).sum() + (mi * ct[1]).sum(), w)
    got = cuda_ucomp.ucomp_weights_backward_dense(w.detach(), ld, last, *ct)
    assert got.shape == w.shape and got.dtype == torch.float32
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


def test_applicability():
    mixed = hea.HEASpec(3, ((3, 1), (3, 1), (3, 2), (3, 2)))
    assert not cuda_ucomp.ucomp_applicable(mixed)
    assert not cuda_ucomp.ucomp_applicable(hea.quanonet_spec(8, (2, 2, 2, 2)))
    assert not cuda_ucomp.ucomp_applicable(hea.HEASpec(3, ((3, 0), (3, 0))))
    assert cuda_ucomp.ucomp_applicable(hea.quanonet_spec(7, (2, 2, 2, 2)))
    with pytest.raises(ValueError, match='uniform linear_depth'):
        cuda_ucomp.compile_block_mats(mixed, torch.zeros(6, 3, 3))


def test_engine_route_with_toggle(monkeypatch):
    """With USE_UCOMP on, the 'pallas' engine takes the compile path and
    still equals 'dense' end to end; a spec it does not apply to falls
    through to the fold; the default is None (auto), which takes the fold
    for these CPU weights."""
    assert cuda_hea.USE_UCOMP is None
    spec = hea.quanonet_spec(3, (4, 2, 3, 2))
    rng, w = _weights(spec, 2)
    x = torch.tensor(rng.uniform(-2, 2, (6, spec.total_encode))
                     .astype(np.float32))
    diag = torch.tensor(simple_ham_diag(3, -5, 5))
    calls = []
    real = cuda_ucomp.compile_block_mats
    monkeypatch.setattr(cuda_ucomp, 'compile_block_mats',
                        lambda *a: calls.append(1) or real(*a))
    want = hea.hea_expectation(spec, torch.tensor(w), x, diag=diag,
                               engine='dense')
    hea.hea_expectation(spec, torch.tensor(w), x, diag=diag, engine='pallas')
    assert not calls
    monkeypatch.setattr(cuda_hea, 'USE_UCOMP', True)
    got = hea.hea_expectation(spec, torch.tensor(w), x, diag=diag,
                              engine='pallas')
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-6)
    mixed = hea.HEASpec(3, ((3, 1), (3, 2)))
    wm = torch.tensor(_weights(mixed, 3)[1])
    xm = x[:, :mixed.total_encode]
    got = hea.hea_expectation(mixed, wm, xm, diag=diag, engine='pallas')
    want = hea.hea_expectation(mixed, wm, xm, diag=diag, engine='dense')
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-6)


def test_model_gradients_with_toggle(monkeypatch):
    """A QuanONet's loss gradients through the compile path equal the
    default path's (5e-5 / 1e-4, the gradient limits above)."""
    rng = np.random.RandomState(4)
    b = torch.tensor(rng.randn(8, 6).astype(np.float32))
    t = torch.tensor(rng.rand(8, 2).astype(np.float32))
    y = torch.tensor(rng.randn(8, 1).astype(np.float32))
    grads = {}
    for on in (False, True):
        monkeypatch.setattr(cuda_hea, 'USE_UCOMP', on)
        model = QuanONet(3, 6, 2, (3, 2, 2, 2), scale_coeff=0.3,
                         engine='pallas', device='cpu',
                         generator=torch.Generator().manual_seed(0))
        ((model(b, t) - y) ** 2).mean().backward()
        grads[on] = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads[True].items():
        np.testing.assert_allclose(g.numpy(), grads[False][k].numpy(),
                                   atol=5e-5, rtol=1e-4, err_msg=k)


COMPONENTS = ['full_step[pallas] bs=100', 'fwd_only[pallas] bs=100',
              'full_step[dense] bs=100', 'fwd_only[dense] bs=100',
              'full_step[pallas] bs=400', 'full_step[pallas] bs=1600',
              'compile_path fwd+bwd', 'adam_only']


@pytest.mark.parametrize("ucomp,extra", [(False, []),
                                         (True, ['--fused_adam'])])
def test_profile_step_on_cpu(tmp_path, monkeypatch, capsys, ucomp, extra):
    """profile_step at the Q2 Net5-1-5-1 size on the CPU: every component
    is timed, the JSON is written to --out and printed as the last line."""
    monkeypatch.setattr(profile_step, 'NUM_QUBITS', 2)
    monkeypatch.setattr(profile_step, 'NET_SIZE', (5, 1, 5, 1))
    monkeypatch.setattr(cuda_hea, 'USE_UCOMP', ucomp)
    out = tmp_path / 'step_profile.json'
    res = profile_step.main(['--device', 'cpu', '--iters', '2', '--out',
                             str(out)] + extra)
    assert json.load(open(out)) == res
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    for key in COMPONENTS:
        assert np.isfinite(res[key]) and res[key] > 0, key
    assert res['platform'] == 'cpu' and res['nvidia_smi'] is None
    assert res['use_ucomp'] is ucomp and res['fused_adam'] is bool(extra)


def test_profile_step_defaults():
    """It runs on the card unless asked, never writes the JAX package's
    TPU profile, times the root script's engines ('embed' among them) and
    refuses an unknown one."""
    args = profile_step.parser().parse_args([])
    assert args.device == 'cuda' and args.engines == 'pallas,embed,dense'
    assert args.out == 'docs/step_profile_torch.json'
    with pytest.raises(ValueError, match='unknown engine'):
        profile_step.main(['--device', 'cpu', '--engines', 'nope'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            profile_step.main(['--iters', '1'])
