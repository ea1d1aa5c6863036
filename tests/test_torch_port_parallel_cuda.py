"""
The multi-GPU paths on the card (quanonet_torch/parallel/): world 1 on
NCCL and world 2 as two ranks sharing card 0 over gloo, for data
parallelism (the full-batch SGD step of make_dp_run_segment against the
unsharded one, replicas bit-identical), the amplitude-sharded engine and
the pipelined engine (outputs and gradients against the plain engine on
the CPU), and the Solver's data-parallel route (two ranks sharing the card
against one device at batch = the training set).  Marked ``cuda``: without a card each test skips.  On the card
(no JAX there):

    python -m pytest --noconftest tests/test_torch_port_parallel_cuda.py -m cuda

Tolerances: outputs 1e-5, gradients 1e-4 × max(1, max|g|), the SGD step
1e-6, the Solver's losses and rel-L2 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import quanonet_torch.data.generation as t_gen
import torch_dist_workers as workers
from quanonet_torch.ops import hea
from quanonet_torch.ops.hamiltonian import simple_ham_diag
from quanonet_torch.parallel import launch
from quanonet_torch.solver import Solver

pytestmark = pytest.mark.cuda
TIMEOUT_S = 120
WORLDS = [(1, False), (2, True)]   # (ranks, sharing card 0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks run on the card")
    return torch.device('cuda')


def _circuit(nq, net, batch, seed=0):
    spec = hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(seed)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (batch, spec.total_encode)).astype(np.float32)
    return spec, w, x, simple_ham_diag(nq, -5, 5)


def _plain(spec, w, x, diag):
    """The plain engine on the CPU: output and gradients of sum(out²)."""
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = hea.hea_expectation(spec, wt, xt, diag=diag, engine='dense')
    (out ** 2).sum().backward()
    return out.detach().numpy(), wt.grad.numpy(), xt.grad.numpy()


def _check(per_rank, ref):
    for r in per_rank:
        np.testing.assert_allclose(r[0], ref[0], rtol=0, atol=1e-5)
        for got, want in zip(r[1:3], ref[1:]):
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("world,share", WORLDS)
def test_dp_segment_on_the_card(card, world, share):
    rng = np.random.RandomState(0)
    X = rng.randn(24, 3).astype(np.float32)
    Y = rng.randn(24, 1).astype(np.float32)
    w0, b0 = rng.randn(3, 1).astype(np.float32), np.zeros(1, np.float32)
    ranks = launch.run_ranks(workers.dp_segment, world, 'cuda',
                             args=('linear', (w0, b0), X, Y, 24, 1, 0.1, 0),
                             share_device=share, timeout_s=TIMEOUT_S)
    w, b = torch.tensor(w0, requires_grad=True), torch.tensor(b0,
                                                              requires_grad=True)
    ((torch.tensor(X) @ w + b - torch.tensor(Y)) ** 2).mean().backward()
    for _, p in ranks:
        np.testing.assert_allclose(p['w'], (w - 0.1 * w.grad).detach(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(p['w'], ranks[0][1]['w'])


@pytest.mark.parametrize("world,share", WORLDS)
def test_amp_on_the_card(card, world, share):
    spec, w, x, diag = _circuit(5, (2, 2, 2, 2), 6)
    cases = [(spec, w, x, diag, fused, 'Z', 0.0, 0.0)
             for fused in (False, True)]
    ranks = launch.run_ranks(workers.amp_cases, world, 'cuda', args=(cases,),
                             share_device=share, timeout_s=TIMEOUT_S)
    ref = _plain(spec, w, x, diag)
    for i in range(len(cases)):
        _check([r[i] for r in ranks], ref)


@pytest.mark.parametrize("world,share", WORLDS)
def test_pipe_on_the_card(card, world, share):
    spec, w, x, diag = _circuit(5, (2, 2, 2, 2), 8)
    cases = [(spec, w, x, diag, M, True, 'Z', 0.0, 0.0) for M in (2, 4)]
    ranks = launch.run_ranks(workers.pipe_cases, world, 'cuda',
                             args=(cases,), share_device=share,
                             timeout_s=TIMEOUT_S)
    ref = _plain(spec, w, x, diag)
    for i in range(len(cases)):
        _check([r[0][i] for r in ranks], ref)


def test_solver_dp_on_the_card(card, tmp_path, monkeypatch):
    """Solver(--num_devices 2, share_device) on the card: the same losses
    and rel-L2 as one device at batch = the training set, each rank's
    kernels launched once a step, the caller's model holding the trained
    parameters."""
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.setattr(launch, 'DEFAULT_TIMEOUT_S', TIMEOUT_S)
    monkeypatch.chdir(tmp_path)
    cfg = dict(operator='Antideriv', model_type='QuanONet', num_train=12,
               num_test=8, num_points=40, num_points_0=8,
               train_sample_num=4, test_sample_num=6, batch_size=48,
               num_epochs=4, learning_rate=0.01, num_qubits=4,
               net_size=[2, 1, 2, 1], scale_coeff=0.01,
               if_trainable_freq='true', seed=0, device='cuda')
    runs = {}
    for world in (1, 2):
        np.random.seed(0)
        solver = Solver(dict(cfg, prefix=str(tmp_path / f'w{world}'),
                             num_devices=world, share_device='true'))
        history = solver.train()
        runs[world] = (solver, history, solver.evaluate(history))
    (_, h1, m1), (s2, h2, m2) = runs[1], runs[2]
    np.testing.assert_allclose(h2['loss_train'], h1['loss_train'],
                               rtol=1e-5)
    np.testing.assert_allclose(m2['rel_l2'], m1['rel_l2'], rtol=1e-5)
    assert len(s2.rank_launches) == 2
    for r in s2.rank_launches:
        assert r['hea_chain_bwd'] == r['ucomp_bwd'] == 4, r
    s2.model.load_state_dict(s2.best_params)
    pred = s2.predict_test()
    rel = np.linalg.norm(pred - s2.test_output) / np.linalg.norm(
        s2.test_output)
    np.testing.assert_allclose(rel, m2['rel_l2'], rtol=1e-5)
