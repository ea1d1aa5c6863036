"""
The CUDA kernels against their plain versions on the card: the block chain
(quanonet_torch/csrc/hea_chain.cu: the forward, its residual-saving
variant and the backward), the fused-group chain (csrc/fused_chain.cu,
8..16 qubits, the same three), the block-matrix compile (csrc/ucomp.cu), the
one-launch Adam (csrc/adam.cu) and the real-embedding chain
(csrc/embed_chain.cu).  Marked ``cuda``: without a card each test skips; on
the card run them with

    python -m pytest tests/test_torch_port_cuda.py -m cuda
"""
import os

import numpy as np
import pytest
import torch

from quanonet_torch import tracing
from quanonet_torch.ops import cuda_hea, hea
from quanonet_torch.ops.hamiltonian import simple_ham_diag
from quanonet_torch.profile_step import launch_counts, launches_of

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device('cuda')


def _operands(nq, net, n, seed, device):
    spec = hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(seed)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), device=device)
    x = torch.tensor(rng.uniform(-4, 4, (n, spec.total_encode))
                     .astype(np.float32), device=device)
    return spec, hea.prepare_chain(spec, w, x)


@pytest.mark.parametrize("nq,net,n", [
    (1, (2, 1, 2, 1), 37), (2, (5, 1, 5, 1), 100), (3, (4, 2, 3, 1), 7),
    (4, (10, 2, 5, 2), 129), (5, (40, 2, 20, 2), 1000),
    (6, (10, 2, 5, 2), 33), (7, (40, 2, 20, 2), 100), (5, (1, 1, 0, 0), 3),
])
def test_kernel_matches_plain(card, nq, net, n):
    spec, ops = _operands(nq, net, n, seed=nq, device=card)
    before = launch_counts()['hea_chain_fwd']
    kr, ki = cuda_hea.block_chain(*ops)
    torch.cuda.synchronize()
    assert launch_counts()['hea_chain_fwd'] == before + 1
    pr, pi = hea.chain_dense(*ops)
    assert (kr - pr).abs().max().item() <= 2e-5
    assert (ki - pi).abs().max().item() <= 2e-5
    diag = torch.as_tensor(simple_ham_diag(nq, -5, 5), device=card)
    ek = hea.diag_expectation_pair(kr, ki, diag)
    ep = hea.diag_expectation_pair(pr, pi, diag)
    assert (ek - ep).abs().max().item() <= 1e-4


def test_kernel_rejects_bad_inputs(card):
    _, (mt_r, mt_i, phi) = _operands(3, (2, 1, 2, 1), 4, 0, card)
    with pytest.raises(TypeError, match='float32'):
        cuda_hea.block_chain(mt_r.double(), mt_i, phi)
    with pytest.raises(ValueError, match='contiguous'):
        cuda_hea.block_chain(mt_r, mt_i, phi.transpose(0, 1).contiguous()
                             .transpose(0, 1))
    with pytest.raises(ValueError, match='must be'):
        cuda_hea.block_chain(mt_r[:1], mt_i, phi)
    # with a gradient needed the chain goes through BlockChain: the
    # residual-saving forward, then the backward kernel
    before = launches_of('hea_chain_fwd', 'hea_chain_bwd')
    sr, si = cuda_hea.block_chain(mt_r.requires_grad_(), mt_i, phi)
    (sr.sum() + si.sum()).backward()
    torch.cuda.synchronize()
    assert launches_of('hea_chain_fwd', 'hea_chain_bwd') == (
        before[0] + 1, before[1] + 1)
    assert mt_r.grad is not None and torch.isfinite(mt_r.grad).all()
    with pytest.raises(TypeError, match='float32'):
        cuda_hea.chain_backward(mt_r.detach(), mt_i, phi, phi, phi,
                                sr.detach().double(), si.detach())


def _bwd_tol(plain):
    """1e-4 x max(1, max|plain|): Mbar sums N rows, phibar runs back
    through every block, in another order than the plain version."""
    return 1e-4 * max(1.0, plain.abs().max().item())


@pytest.mark.parametrize("nq,net,n", [
    (1, (2, 1, 2, 1), 37), (2, (5, 1, 5, 1), 1000), (3, (4, 2, 3, 1), 37),
    (4, (10, 2, 5, 2), 129), (5, (40, 2, 20, 2), 100),
    (5, (40, 2, 20, 2), 37), (6, (10, 2, 5, 2), 33),
    (7, (40, 2, 20, 2), 100), (5, (1, 1, 0, 0), 3),
])
def test_backward_kernels_match_plain(card, nq, net, n):
    spec, ops = _operands(nq, net, n, seed=10 + nq, device=card)
    rng = np.random.RandomState(n)
    gr, gi = (torch.tensor(rng.randn(n, spec.dim).astype(np.float32),
                           device=card) for _ in range(2))
    before = launches_of('hea_chain_fwd', 'hea_chain_bwd')
    sr, si, st_r, st_i = cuda_hea.chain_forward(*ops, save_residuals=True)
    got = cuda_hea.chain_backward(*ops, st_r, st_i, gr, gi)
    torch.cuda.synchronize()
    assert launches_of('hea_chain_fwd', 'hea_chain_bwd') == (
        before[0] + 1, before[1] + 1)
    pr, pi, pst_r, pst_i = hea.chain_dense_saved(*ops)
    for a, b in ((sr, pr), (si, pi), (st_r, pst_r), (st_i, pst_i)):
        assert (a - b).abs().max().item() <= 2e-5
    want = hea.chain_backward_dense(*ops, (pst_r, pst_i), gr, gi)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= _bwd_tol(b)
    # the primal-only kernel gives the residual variant's output, bit for bit
    qr, qi = cuda_hea.chain_forward(*ops)
    assert torch.equal(qr, sr) and torch.equal(qi, si)


@pytest.mark.parametrize("n", [100, 8192])
def test_backward_is_deterministic(card, n):
    """Mbar is a cross-CTA sum in a fixed order: equal inputs, equal bits."""
    spec, ops = _operands(5, (40, 2, 20, 2), n, seed=3, device=card)
    g = torch.randn(2, n, spec.dim, device=card)
    _, _, st_r, st_i = cuda_hea.chain_forward(*ops, save_residuals=True)
    a = cuda_hea.chain_backward(*ops, st_r, st_i, g[0], g[1])
    b = cuda_hea.chain_backward(*ops, st_r, st_i, g[0], g[1])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _unitary_operands(d, nb, n, seed, device):
    """Random unitary block matrices (as M^T) and phases in [-8, 8]."""
    rng = np.random.RandomState(seed)
    mats = []
    for _ in range(nb):
        q, _ = np.linalg.qr(rng.randn(d, d) + 1j * rng.randn(d, d))
        mats.append(q.T)
    mt = np.stack(mats)
    phi = rng.uniform(-8, 8, (nb, n, d))
    return [torch.tensor(np.ascontiguousarray(a, np.float32), device=device)
            for a in (mt.real, mt.imag, phi)], rng


@pytest.mark.parametrize("tile", [0, 1, 2])
@pytest.mark.parametrize("d", cuda_hea.DIMS)
def test_every_tile_ragged_and_at_its_boundaries(card, monkeypatch, d, tile):
    """Each launch geometry of both kernels (forced in turn) at N = 1, one
    row either side of its row tile and a ragged multiple, with one block
    and with several: forward and residuals within 2e-5 of the plain
    version, the primal equal to the residual variant bit for bit, the
    backward within 1e-4 x max(1, max|plain|), two backward calls equal."""
    rows = cuda_hea.tile_geometry(d, tile, 1).rows
    monkeypatch.setattr(cuda_hea, 'chain_geometry',
                        lambda n, dd, sms: cuda_hea.tile_geometry(dd, tile, n))
    for nb in (1, 4):
        for n in sorted({1, max(1, rows - 1), rows + 1, 2 * rows + 3}):
            (mt_r, mt_i, phi), rng = _unitary_operands(
                d, nb, n, 100 * d + 10 * tile + nb, card)
            gr, gi = (torch.tensor(rng.randn(n, d).astype(np.float32),
                                   device=card) for _ in range(2))
            where = f"D={d} tile={tile} nb={nb} N={n}"
            sr, si, st_r, st_i = cuda_hea.chain_forward(
                mt_r, mt_i, phi, save_residuals=True)
            qr, qi = cuda_hea.chain_forward(mt_r, mt_i, phi)
            got = cuda_hea.chain_backward(mt_r, mt_i, phi, st_r, st_i, gr, gi)
            again = cuda_hea.chain_backward(mt_r, mt_i, phi, st_r, st_i, gr,
                                            gi)
            torch.cuda.synchronize()
            pr, pi, pst_r, pst_i = hea.chain_dense_saved(mt_r, mt_i, phi)
            for a, b in ((sr, pr), (si, pi), (st_r, pst_r), (st_i, pst_i)):
                assert (a - b).abs().max().item() <= 2e-5, where
            assert torch.equal(qr, sr) and torch.equal(qi, si), where
            want = hea.chain_backward_dense(mt_r, mt_i, phi, (pst_r, pst_i),
                                            gr, gi)
            for a, b in zip(got, want):
                assert (a - b).abs().max().item() <= _bwd_tol(b), where
            assert all(torch.equal(a, b) for a, b in zip(got, again)), where


ANGLE_NS = (1, 7, 100, 8192, 20000, 20003)


@pytest.mark.parametrize("nb", [1, 60])
@pytest.mark.parametrize("nq", range(1, 8))
def test_angle_route_equals_phase_route(card, monkeypatch, nq, nb):
    """B1f on the angles against B1f on encoding_phases of the same x, bit
    for bit: at every N of ANGLE_NS with the tile chain_geometry picks,
    and at the ragged N = 20,003 with each tile of TILES forced in turn."""
    d = 2 ** nq
    spec = hea.HEASpec(nq, ((nq, 0),) * nb)
    geometry = cuda_hea.chain_geometry
    forced = [(n, None) for n in ANGLE_NS] + [(20003, t) for t in range(3)]
    for n, tile in forced:
        monkeypatch.setattr(
            cuda_hea, 'chain_geometry', geometry if tile is None else
            (lambda nn, dd, sms, t=tile: cuda_hea.tile_geometry(dd, t, nn)))
        (mt_r, mt_i, _), rng = _unitary_operands(d, nb, 1, 7 * n + nq, card)
        x = torch.tensor(rng.uniform(-8, 8, (n, nb * nq)).astype(np.float32),
                         device=card)
        got = cuda_hea.chain_forward_angles(mt_r, mt_i, x, nb)
        want = cuda_hea.chain_forward(mt_r, mt_i,
                                      hea.encoding_phases(spec, x))
        torch.cuda.synchronize()
        where = f"D={d} nb={nb} N={n} tile={tile}"
        assert torch.equal(got[0], want[0]), where
        assert torch.equal(got[1], want[1]), where


def test_flagship_inference_takes_the_angles_bit_for_bit(card):
    """The released flagship under inference_mode: hea_expectation_pallas
    (the angle route) equals the phase route bit for bit, and counts one
    angle launch a forward; a forward under a gradient counts none."""
    from quanonet_torch.infer import load_model
    model, _ = load_model(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'pretrained_weights', 'Advection', 'Advection_QuanONet_Net40-2-20-2_'
        'Q5_TF_S0.1_1000x100_Seed0', 'best_model.ckpt'), 100, 2,
        device='cuda')
    rng = np.random.RandomState(11)
    branch = torch.tensor(rng.randn(20000, 100).astype(np.float32),
                          device=card)
    trunk = torch.tensor(rng.rand(20000, 2).astype(np.float32), device=card)
    spec, diag = model.spec, model.measure.diag
    keys = ('hea_chain_fwd', 'hea_chain_fwd_angles')

    def counts():
        c = tracing.counts()
        return tuple(c[k] for k in keys)
    with torch.inference_mode():
        x = model.encode(branch, trunk)
        before = counts()
        got = cuda_hea.hea_expectation_pallas(spec, model.ansatz, x, diag)
        mid = counts()
        want = hea.diag_expectation_pair(
            *cuda_hea.block_chain(*cuda_hea._prepare(spec, model.ansatz, x)),
            diag)
        after = counts()
    assert torch.equal(got, want)
    assert (mid[0] - before[0], mid[1] - before[1]) == (1, 1)
    assert (after[0] - mid[0], after[1] - mid[1]) == (1, 0)
    out = model(branch[:100], trunk[:100])
    out.sum().backward()
    torch.cuda.synchronize()
    assert counts()[1] == after[1]
    assert model.ansatz.grad is not None


def test_model_training_step_matches_dense(card):
    """One Adam step of a Q4 QuanONet through the kernels equals the plain
    engine's (autograd of chain_dense) on the card."""
    from quanonet_torch.models import QuanONet
    rng = np.random.RandomState(0)
    b = torch.tensor(rng.randn(64, 8).astype(np.float32), device=card)
    t = torch.tensor(rng.rand(64, 2).astype(np.float32), device=card)
    y = torch.tensor(rng.randn(64, 1).astype(np.float32), device=card)
    out = {}
    for engine in ('pallas', 'dense'):
        model = QuanONet(4, 8, 2, (6, 2, 4, 2), engine=engine, device=card,
                         generator=torch.Generator().manual_seed(1))
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        loss = ((model(b, t) - y) ** 2).mean()
        loss.backward()
        opt.step()
        out[engine] = (loss.item(), model.state_dict())
    assert out['pallas'][0] == pytest.approx(out['dense'][0], rel=1e-5)
    for k, v in out['pallas'][1].items():
        assert (v - out['dense'][1][k]).abs().max().item() <= 1e-5, k


# ── the fused-group chain kernels (csrc/fused_chain.cu) ─────────────────────

def _fused_operands(nq, net, n, seed, device, configs=None):
    from quanonet_torch.ops import fused_gates
    spec = hea.HEASpec(nq, configs) if configs else hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(seed)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), device=device)
    x = torch.tensor(rng.uniform(-4, 4, (n, spec.total_encode))
                     .astype(np.float32), device=device)
    with torch.no_grad():
        ops = fused_gates.prepare_fused_chain_x(spec, w, x)
    return spec, ops, fused_gates.block_depths(spec), rng


@pytest.mark.parametrize("nq,net,n,configs", [
    (8, (3, 2, 2, 1), 5, None), (9, (2, 1, 2, 2), 7, None),
    (8, None, 5, ((8, 1), (8, 0), (8, 2), (8, 0))),
    (10, (40, 2, 20, 2), 100, None), (12, (1, 1, 1, 1), 9, None),
    (13, (1, 1, 1, 1), 3, None), (14, (1, 1, 1, 1), 2, None),
    (16, (1, 1, 1, 1), 2, None),
])
def test_fused_kernel_matches_plain(card, nq, net, n, configs):
    """B2f against chain_fused_x, in shared memory (to 13 qubits) and in
    device memory (from 14)."""
    from quanonet_torch.ops import cuda_fused, fused_gates
    spec, ops, lds, _ = _fused_operands(nq, net, n, nq, card, configs)
    before = launch_counts()['fused_chain_fwd']
    kr, ki = cuda_fused.fused_chain(*ops, lds)
    torch.cuda.synchronize()
    assert launch_counts()['fused_chain_fwd'] == before + 1
    pr, pi = fused_gates.chain_fused_x(*ops, lds)
    assert (kr - pr).abs().max().item() <= 2e-5
    assert (ki - pi).abs().max().item() <= 2e-5
    diag = torch.as_tensor(simple_ham_diag(nq, -5, 5), device=card)
    ek = hea.diag_expectation_pair(kr, ki, diag)
    ep = hea.diag_expectation_pair(pr, pi, diag)
    assert (ek - ep).abs().max().item() <= 1e-4


@pytest.mark.parametrize("nq,net,n,configs", [
    (8, (3, 2, 2, 1), 5, None), (9, (2, 1, 2, 2), 7, None),
    (8, None, 5, ((8, 1), (8, 0), (8, 2), (8, 0))),
    (10, (40, 2, 20, 2), 100, None), (12, (1, 1, 1, 1), 9, None),
    (13, (1, 1, 1, 1), 3, None), (14, (1, 1, 1, 1), 2, None),
])
def test_fused_backward_kernels_match_plain(card, nq, net, n, configs):
    """B2b against chain_fused_backward_x (xbar (nb, N, n)), the residual
    variant against chain_fused_saved_x; two backward calls give equal
    bits."""
    from quanonet_torch.ops import cuda_fused, fused_gates
    spec, ops, lds, rng = _fused_operands(nq, net, n, 10 + nq, card, configs)
    g = [torch.tensor(rng.randn(n, spec.dim).astype(np.float32),
                      device=card) for _ in range(2)]
    sr, si, st_r, st_i = cuda_fused.chain_forward(*ops, lds,
                                                  save_residuals=True)
    got = cuda_fused.chain_backward(*ops, lds, st_r, st_i, *g)
    again = cuda_fused.chain_backward(*ops, lds, st_r, st_i, *g)
    torch.cuda.synchronize()
    pr, pi, pst_r, pst_i = fused_gates.chain_fused_saved_x(*ops, lds)
    for a, b in ((sr, pr), (si, pi), (st_r, pst_r), (st_i, pst_i)):
        assert (a - b).abs().max().item() <= 2e-5
    want = fused_gates.chain_fused_backward_x(*ops, lds, (pst_r, pst_i),
                                              *g)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= _bwd_tol(b)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    qr, qi = cuda_fused.chain_forward(*ops, lds)
    assert torch.equal(qr, sr) and torch.equal(qi, si)


def test_fused_kernel_rejects_bad_inputs(card):
    from quanonet_torch.ops import cuda_fused
    _, (u7r, u7i, u2r, u2i, xb), lds, _ = _fused_operands(
        9, (2, 1, 2, 1), 4, 0, card)
    with pytest.raises(TypeError, match='float32'):
        cuda_fused.fused_chain(u7r.double(), u7i, u2r, u2i, xb, lds)
    with pytest.raises(ValueError, match='contiguous'):
        cuda_fused.fused_chain(u7r.transpose(1, 2), u7i, u2r, u2i, xb, lds)
    with pytest.raises(ValueError, match='must be'):
        cuda_fused.fused_chain(u7r[:1], u7i, u2r, u2i, xb, lds)
    with pytest.raises(ValueError, match='block depths'):
        cuda_fused.fused_chain(u7r, u7i, u2r, u2i, xb, lds[:-1])
    with pytest.raises(ValueError, match='x must be'):
        cuda_fused.fused_chain(u7r, u7i, u2r, u2i, xb[0], lds)
    # with a gradient the chain goes through FusedChain: the residual
    # forward, then the backward kernels, x's gradient (nb, N, n)
    before = launches_of('fused_chain_fwd', 'fused_chain_bwd')
    xg = xb.clone().requires_grad_()
    sr, si = cuda_fused.fused_chain(u7r.requires_grad_(), u7i, u2r, u2i,
                                    xg, lds)
    (sr.sum() + si.sum()).backward()
    torch.cuda.synchronize()
    assert launches_of('fused_chain_fwd', 'fused_chain_bwd') == (
        before[0] + 1, before[1] + 1)
    assert u7r.grad is not None and torch.isfinite(u7r.grad).all()
    assert xg.grad.shape == xb.shape and torch.isfinite(xg.grad).all()


@pytest.mark.parametrize("nq,n", [(8, 4000), (10, 4000), (11, 2200)])
def test_fused_kernels_at_large_batch_tiles(card, nq, n):
    """The geometry of a batch that fills the card 16 times over (32 tile
    rows a CTA, 16 at 8 qubits): both kernels launch (their shared memory
    fits) and match the plain versions."""
    from quanonet_torch.ops import cuda_fused, fused_gates
    spec, ops, lds, rng = _fused_operands(nq, (2, 1, 1, 1), n, nq, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    rows = cuda_fused.rows_per_cta(nq, n, sms)
    assert rows << (nq - 7) == (16 if nq == 8 else 32)
    g = [torch.tensor(rng.randn(n, spec.dim).astype(np.float32),
                      device=card) for _ in range(2)]
    sr, si, st_r, st_i = cuda_fused.chain_forward(*ops, lds,
                                                  save_residuals=True)
    got = cuda_fused.chain_backward(*ops, lds, st_r, st_i, *g)
    torch.cuda.synchronize()
    pr, pi, pst_r, pst_i = fused_gates.chain_fused_saved_x(*ops, lds)
    for a, b in ((sr, pr), (si, pi), (st_r, pst_r), (st_i, pst_i)):
        assert (a - b).abs().max().item() <= 2e-5
    want = fused_gates.chain_fused_backward_x(*ops, lds, (pst_r, pst_i), *g)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= _bwd_tol(b)


def test_q8_training_step_pfused_matches_fused(card):
    """One Adam step of a Q8 QuanONet through the fused-group kernels
    equals autograd of the grouped-kron engine on the card."""
    from quanonet_torch.models import QuanONet
    rng = np.random.RandomState(0)
    b = torch.tensor(rng.randn(64, 8).astype(np.float32), device=card)
    t = torch.tensor(rng.rand(64, 2).astype(np.float32), device=card)
    y = torch.tensor(rng.randn(64, 1).astype(np.float32), device=card)
    out = {}
    for engine in ('pfused', 'fused'):
        model = QuanONet(8, 8, 2, (6, 2, 4, 2), engine=engine, device=card,
                         generator=torch.Generator().manual_seed(1))
        opt = torch.optim.Adam(model.parameters(), lr=0.01)
        loss = ((model(b, t) - y) ** 2).mean()
        loss.backward()
        opt.step()
        out[engine] = (loss.item(), model.state_dict())
    assert out['pfused'][0] == pytest.approx(out['fused'][0], rel=1e-5)
    for k, v in out['pfused'][1].items():
        assert (v - out['fused'][1][k]).abs().max().item() <= 1e-5, k


# ── the block-matrix compile kernels (csrc/ucomp.cu) ────────────────────────

UCOMP_CASES = [      # (qubits, block configs or net_size)
    (5, (40, 2, 20, 2)), (2, (3, 1, 2, 1)), (3, (2, 3, 2, 3)),
    (4, ((4, 2),) * 5), (6, (3, 2, 2, 2)), (7, (2, 2, 2, 2)),
    (1, (2, 1, 1, 1)), (5, ((5, 2),)),
]


def _ucomp_weights(nq, net, seed, device):
    spec = (hea.HEASpec(nq, net) if isinstance(net[0], tuple)
            else hea.quanonet_spec(nq, net))
    rng = np.random.RandomState(seed)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), device=device)
    return spec, w, spec.block_configs[0][1], rng


@pytest.mark.parametrize("nq,net", UCOMP_CASES)
def test_ucomp_kernels_match_plain(card, nq, net):
    """B4f against the plain forward from the weights (2e-5) and B4b's w̄
    against the plain weight backward (1e-4 x max(1, max|plain|): gate
    passes against products, another order); two backward calls give equal
    bits; the forward equals the autograd fold."""
    from quanonet_torch.ops import cuda_ucomp
    spec, w, ld, rng = _ucomp_weights(nq, net, 20 + nq, card)
    last = spec.n_blocks - 1
    before = launches_of('ucomp_fwd', 'ucomp_bwd')
    got = cuda_ucomp.ucomp_forward(w, ld, last)
    g = [torch.tensor(rng.randn(spec.n_blocks, spec.dim, spec.dim)
                      .astype(np.float32), device=card) for _ in range(2)]
    bwd = cuda_ucomp.ucomp_backward(w, ld, last, *g)
    again = cuda_ucomp.ucomp_backward(w, ld, last, *g)
    torch.cuda.synchronize()
    assert launches_of('ucomp_fwd', 'ucomp_bwd') == (
        before[0] + 1, before[1] + 2)
    for a, b in zip(got, cuda_ucomp.ucomp_weights_dense(w, ld, last)):
        assert a.shape == b.shape and a.is_contiguous()
        assert (a - b).abs().max().item() <= 2e-5
    for a, b in zip(got, hea.fold_block_mats(spec, w)):
        assert (a - b).abs().max().item() <= 2e-5
    want = cuda_ucomp.ucomp_weights_backward_dense(w, ld, last, *g)
    assert bwd.shape == want.shape == w.shape
    assert (bwd - want).abs().max().item() <= _bwd_tol(want)
    assert torch.equal(bwd, again)
    # a block that is not the last takes H on the right
    mid = cuda_ucomp.ucomp_forward(w, ld, -1)
    for a, b in zip(mid, cuda_ucomp.ucomp_weights_dense(w, ld, -1)):
        assert (a - b).abs().max().item() <= 2e-5


def test_ucomp_rejects_bad_inputs_and_trains(card, monkeypatch):
    from quanonet_torch.ops import cuda_ucomp
    spec, w, ld, _ = _ucomp_weights(3, (2, 2, 2, 2), 0, card)
    with pytest.raises(TypeError, match='float32'):
        cuda_ucomp.ucomp(w.double(), ld, 3)
    with pytest.raises(ValueError, match='contiguous'):
        cuda_ucomp.ucomp(w.permute(2, 1, 0).contiguous().permute(2, 1, 0),
                         ld, 3)
    with pytest.raises(ValueError, match='blocks of'):
        cuda_ucomp.ucomp(w[:3], ld, 0)
    with pytest.raises(ValueError, match='last'):
        cuda_ucomp.ucomp(w, ld, 4)
    # with USE_UCOMP on, the 'pallas' engine's gradient goes through both
    # compile kernels and equals the default path's
    monkeypatch.setattr(cuda_hea, 'USE_UCOMP', True)
    x = torch.randn(6, spec.total_encode, device=card)
    diag = torch.as_tensor(simple_ham_diag(3, -5, 5), device=card)
    grads = {}
    for on in (True, False):
        monkeypatch.setattr(cuda_hea, 'USE_UCOMP', on)
        before = launches_of('ucomp_fwd', 'ucomp_bwd')
        wg = w.clone().requires_grad_()
        out = hea.hea_expectation(spec, wg, x, diag=diag, engine='pallas')
        (grads[on],) = torch.autograd.grad(out.sum(), wg)
        after = launches_of('ucomp_fwd', 'ucomp_bwd')
        used = (after[0] - before[0], after[1] - before[1])
        assert used == ((1, 1) if on else (0, 0))
    assert (grads[True] - grads[False]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("nq,net", [(5, (40, 2, 20, 2)), (2, (3, 1, 2, 1)),
                                    (1, (2, 1, 1, 1))])
def test_stacked_compile_and_packed_step_on_the_card(card, nq, net):
    """The packed multi-seed compile: B4f with last = EVERY_BLOCK against
    the plain version; three seeds' block matrices in two launches each
    way equal to each seed's own compile (forward bit-equal: the forward's
    geometry depends on D alone), w̄ within 1e-4 x max(1, max|g|); one
    packed step's chains a launch a seed (Q1: a seed's slice realigned)."""
    from quanonet_torch.models import QuanONet
    from quanonet_torch.models.packed import PackedModel
    from quanonet_torch.ops import cuda_ucomp
    spec, w, ld, rng = _ucomp_weights(nq, net, 40 + nq, card)
    every = cuda_ucomp.ucomp_forward(w, ld, cuda_ucomp.EVERY_BLOCK)
    for a, b in zip(every, cuda_ucomp.ucomp_weights_dense(
            w, ld, cuda_ucomp.EVERY_BLOCK)):
        assert (a - b).abs().max().item() <= 2e-5
    ws = torch.stack([w, w.flip(0), -w]).requires_grad_()
    g = [torch.tensor(rng.randn(3, spec.n_blocks, spec.dim, spec.dim)
                      .astype(np.float32), device=card) for _ in range(2)]
    before = launches_of('ucomp_fwd', 'ucomp_bwd')
    mr, mi = cuda_ucomp.compile_block_mats_stacked(spec, ws)
    (got,) = torch.autograd.grad((mr * g[0]).sum() + (mi * g[1]).sum(), ws)
    torch.cuda.synchronize()
    two = 1 if spec.n_blocks == 1 else 2
    after = launches_of('ucomp_fwd', 'ucomp_bwd')
    assert (after[0] - before[0], after[1] - before[1]) == (two, two)
    for i in range(3):
        wi = ws.detach()[i].clone().requires_grad_()
        r, im = cuda_ucomp.compile_block_mats(spec, wi)
        assert torch.equal(mr[i], r) and torch.equal(mi[i], im)
        (want,) = torch.autograd.grad((r * g[0][i]).sum()
                                      + (im * g[1][i]).sum(), wi)
        assert (got[i] - want).abs().max().item() <= _bwd_tol(want)
    models = [QuanONet(nq, 6, 2, net, scale_coeff=0.3, device=card,
                       generator=torch.Generator().manual_seed(i))
              for i in range(3)]
    pack = PackedModel(models)
    b = torch.randn(3, 7, 6, device=card)
    t = torch.rand(3, 7, 2, device=card)
    before = launches_of('hea_chain_fwd', 'hea_chain_bwd')
    out = pack(b, t)
    out.sum().backward()
    torch.cuda.synchronize()
    after = launches_of('hea_chain_fwd', 'hea_chain_bwd')
    assert (after[0] - before[0], after[1] - before[1]) == (3, 3)
    for i, m in enumerate(models):
        assert (out[i] - m(b[i], t[i])).abs().max().item() <= 1e-5


# ── the one-launch Adam (csrc/adam.cu) ──────────────────────────────────────

def _adam_leaves(device, seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(120, 3, 5), (), (200,), (200,), (100,), (100,), (1,), (257,)]
    return [torch.tensor(np.asarray(rng.randn(*s), np.float32), device=device)
            for s in shapes]


def test_adam_kernel_matches_plain(card):
    """B5 against adam_step_dense over 25 steps (atol 2e-6, rtol 1e-5: the
    kernel contracts multiply-adds), a 0-d leaf and a ragged one included;
    the same run twice gives equal bits."""
    from quanonet_torch.ops import cuda_adam
    runs = []
    for kernel in (True, True, False):
        p, m, v = (_adam_leaves(card, 0), [torch.zeros_like(a) for a in
                                           _adam_leaves(card, 0)],
                   [torch.zeros_like(a) for a in _adam_leaves(card, 0)])
        before = launch_counts()['adam_step']
        for t in range(1, 26):
            g = _adam_leaves(card, 100 + t)
            step = cuda_adam.adam_step if kernel else cuda_adam.adam_step_dense
            step(p, g, m, v, 1e-2 * 0.95 ** t, t)
        torch.cuda.synchronize()
        assert launch_counts()['adam_step'] - before == (25 if kernel else 0)
        runs.append(p + m + v)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    for a, b in zip(runs[0], runs[2]):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=1e-5)


def test_fused_adam_on_card(card):
    """FusedAdam's step on CUDA parameters: one launch, parameters moved as
    torch.optim.Adam moves them (1e-6: beta**t in double on the host
    against expf in fp32 on the card); more than 64 leaves take two
    launches, and the device count one step; a non-contiguous gradient
    raises."""
    from quanonet_torch.ops import cuda_adam
    leaves = _adam_leaves(card, 1)
    a = [torch.nn.Parameter(x.clone()) for x in leaves]
    b = [torch.nn.Parameter(x.clone()) for x in leaves]
    fused = cuda_adam.fused_adam(1e-2).init(a)
    ref = torch.optim.Adam(b, lr=1e-2)
    before = launch_counts()['adam_step']
    for t in range(5):
        for pa, pb, g in zip(a, b, _adam_leaves(card, 50 + t)):
            pa.grad, pb.grad = g, g.clone()
        fused.step()
        ref.step()
    torch.cuda.synchronize()
    assert launch_counts()['adam_step'] == before + 5 and fused.count == 5
    for pa, pb in zip(a, b):
        assert (pa - pb).abs().max().item() <= 1e-6
    many = [torch.nn.Parameter(torch.ones(3, device=card)) for _ in range(70)]
    opt = cuda_adam.fused_adam(0.1).init(many)
    for q in many:
        q.grad = torch.ones_like(q)
    before = launch_counts()['adam_step']
    opt.step()
    torch.cuda.synchronize()
    assert launch_counts()['adam_step'] == before + 2
    assert all(torch.allclose(q, torch.full_like(q, 0.9)) for q in many)
    assert opt.state_dict()['count'] == 1 and fused.state_dict()['count'] == 5
    many[0].grad = torch.ones(3, 2, device=card)[:, 0]
    with pytest.raises(ValueError, match='contiguous'):
        opt.step()


# ── the real-embedding chain kernels (csrc/embed_chain.cu) ──────────────────

def _embed_operands(d, nb, n, seed, device):
    """Random general E (no block structure), t (no antisymmetry), g."""
    rng = np.random.RandomState(seed)
    w = 2 * d
    return [torch.tensor(a.astype(np.float32), device=device) for a in (
        rng.randn(nb, w, w) / np.sqrt(w), rng.uniform(-12, 12, (nb, n, w)),
        rng.randn(n, w))]


EMBED_CASES = [(1, 3, 37), (2, 5, 1000), (8, 5, 37), (16, 7, 100),
               (32, 60, 1), (32, 60, 100), (32, 60, 8192), (64, 15, 37),
               (128, 6, 1000), (32, 1, 37), (128, 1, 5)]


@pytest.mark.parametrize("d,nb,n", EMBED_CASES)
def test_embed_kernels_match_plain(card, d, nb, n):
    """B3f (primal and residual) within 2e-5 of chain_embed_saved (the
    output and the residual u), B3b within 1e-4 x max(1, max|plain|) of
    chain_embed_backward, two backward calls bit-equal, each wrapper
    counting its launch."""
    from quanonet_torch.ops import cuda_embed
    e, t, g = _embed_operands(d, nb, n, 7000 + d + nb + n, card)
    before = launches_of('embed_chain_fwd', 'embed_chain_bwd')
    out = cuda_embed.embed_chain(e, t)
    saved, u = cuda_embed.embed_forward(e, t, save_residuals=True)
    got = cuda_embed.embed_backward(e, t, u, g)
    again = cuda_embed.embed_backward(e, t, u, g)
    torch.cuda.synchronize()
    assert launches_of('embed_chain_fwd', 'embed_chain_bwd') == (
        before[0] + 2, before[1] + 2)
    want, wu = cuda_embed.chain_embed_saved(e, t)
    assert torch.equal(out, saved)
    assert (out - want).abs().max().item() <= 2e-5
    assert (u - wu).abs().max().item() <= 2e-5
    for a, b, c in zip(got, again,
                       cuda_embed.chain_embed_backward(e, t, wu, g)):
        assert torch.equal(a, b)
        scale = max(1.0, c.abs().max().item())
        assert (a - c).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("tile", [0, 1, 2])
@pytest.mark.parametrize("d", (1, 2, 4, 8, 16, 32, 64, 128))
def test_embed_every_tile_ragged_and_at_its_boundaries(card, monkeypatch, d,
                                                       tile):
    """Each launch geometry of the embed-chain kernels (forced in turn) at
    N = 1, one row either side of its row tile and a ragged multiple, with
    one block and with several: the output and the residual u within 2e-5
    of the plain version, the primal equal to the residual variant bit for
    bit, the backward within 1e-4 x max(1, max|plain|), two backward calls
    equal; and Ebar in two slices at 1,025 rows."""
    from quanonet_torch.ops import cuda_embed
    rows = cuda_embed.tile_geometry(d, tile, 1).rows
    monkeypatch.setattr(
        cuda_embed, 'embed_geometry',
        lambda n, dd, sms: cuda_embed.tile_geometry(dd, tile, n))
    ns = sorted({1, max(1, rows - 1), rows + 1, 2 * rows + 3})
    for nb, n in [(nb, n) for nb in (1, 4) for n in ns] + [(3, 1025)]:
        e, t, g = _embed_operands(d, nb, n, 100 * d + 10 * tile + nb, card)
        where = f"d={d} tile={tile} nb={nb} N={n}"
        out, u = cuda_embed.embed_forward(e, t, save_residuals=True)
        primal = cuda_embed.embed_forward(e, t)
        got = cuda_embed.embed_backward(e, t, u, g)
        again = cuda_embed.embed_backward(e, t, u, g)
        torch.cuda.synchronize()
        want, wu = cuda_embed.chain_embed_saved(e, t)
        assert (out - want).abs().max().item() <= 2e-5, where
        assert (u - wu).abs().max().item() <= 2e-5, where
        assert torch.equal(primal, out), where
        for a, b in zip(got, cuda_embed.chain_embed_backward(e, t, wu, g)):
            assert (a - b).abs().max().item() <= _bwd_tol(b), where
        assert all(torch.equal(a, b) for a, b in zip(got, again)), where


def test_embed_kernel_rejects_bad_inputs_and_trains(card):
    from quanonet_torch.ops import cuda_embed
    e, t, g = _embed_operands(4, 3, 5, 1, card)
    with pytest.raises(TypeError, match='float32'):
        cuda_embed.embed_chain(e.double(), t)
    with pytest.raises(ValueError, match='contiguous'):
        cuda_embed.embed_chain(e.transpose(1, 2), t)
    with pytest.raises(ValueError, match='must be'):
        cuda_embed.embed_chain(e[:1], t)
    with pytest.raises(ValueError, match='takes d in'):
        cuda_embed.embed_chain(torch.zeros(1, 6, 6, device=card),
                               torch.zeros(1, 2, 6, device=card))
    assert tuple(cuda_embed.embed_chain(e, t[:, :0]).shape) == (0, 8)
    before = launches_of('embed_chain_fwd', 'embed_chain_bwd')
    ops = [e.clone().requires_grad_(), t.clone().requires_grad_()]
    got = torch.autograd.grad((cuda_embed.embed_chain(*ops) * g).sum(), ops)
    torch.cuda.synchronize()
    assert launches_of('embed_chain_fwd', 'embed_chain_bwd') == (
        before[0] + 1, before[1] + 1)
    ref = [e.clone().requires_grad_(), t.clone().requires_grad_()]
    want = torch.autograd.grad((cuda_embed.chain_embed(*ref) * g).sum(), ref)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            1.0, b.abs().max().item())


def test_model_training_step_embed_matches_dense(card):
    """One SGD step of a Q4 QuanONet through the embed kernels equals the
    plain engine's on the card."""
    from quanonet_torch.models import QuanONet
    rng = np.random.RandomState(0)
    b = torch.tensor(rng.randn(64, 8).astype(np.float32), device=card)
    t = torch.tensor(rng.rand(64, 2).astype(np.float32), device=card)
    y = torch.tensor(rng.randn(64, 1).astype(np.float32), device=card)
    out = {}
    for engine in ('embed', 'dense'):
        model = QuanONet(4, 8, 2, (6, 2, 4, 2), engine=engine, device=card,
                         generator=torch.Generator().manual_seed(1))
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        loss = ((model(b, t) - y) ** 2).mean()
        loss.backward()
        opt.step()
        out[engine] = (loss.item(), model.state_dict())
    assert out['embed'][0] == pytest.approx(out['dense'][0], rel=1e-5)
    for k, v in out['embed'][1].items():
        assert (v - out['dense'][1][k]).abs().max().item() <= 1e-5, k


# ── noise trajectories on the fold route (B1f/B1b a trajectory) ─────────────

def _noise_case(nq, net, n, n_traj, seed, device):
    spec, (mt_r, mt_i, phi) = _operands(nq, net, n, seed, device)
    rng = np.random.RandomState(seed)
    a = torch.tensor(rng.rand(n_traj, spec.n_blocks, nq) < 0.3, device=device)
    b = torch.tensor(rng.rand(n_traj, spec.n_blocks, nq) < 0.3, device=device)
    return spec, (mt_r, mt_i, phi), a, b


@pytest.mark.parametrize("nq,net,n", [(5, (40, 2, 20, 2), 100),
                                      (2, (5, 1, 5, 1), 37),
                                      (7, (10, 2, 5, 2), 64)])
def test_noise_fold_route_kernel_matches_plain(card, nq, net, n):
    """Each trajectory's folded matrices through B1f equal the plain chain
    on them, one launch a trajectory."""
    from quanonet_torch.ops import noise
    spec, ops, a, b = _noise_case(nq, net, n, 4, nq, card)
    before = launch_counts()['hea_chain_fwd']
    kr, ki = noise.fold_states(*ops, a, b)
    torch.cuda.synchronize()
    assert launch_counts()['hea_chain_fwd'] == before + 4
    pr, pi = noise.fold_states(*ops, a, b, chain=hea.chain_dense)
    assert (kr - pr).abs().max().item() <= 2e-5
    assert (ki - pi).abs().max().item() <= 2e-5


def test_noise_fold_gradient_through_the_kernels(card):
    """Autograd through B4f/B1f with B1b and B4b against the plain chain
    and the autograd fold, 1e-4 x max(1, max|plain|)."""
    from quanonet_torch.ops import noise
    spec = hea.quanonet_spec(5, (40, 2, 20, 2))
    rng = np.random.RandomState(3)
    w0 = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x0 = rng.uniform(-4, 4, (100, spec.total_encode)).astype(np.float32)
    a = torch.tensor(rng.rand(3, spec.n_blocks, 5) < 0.2, device=card)
    b = torch.tensor(rng.rand(3, spec.n_blocks, 5) < 0.2, device=card)
    diag = torch.as_tensor(simple_ham_diag(5, -5, 5), device=card)
    grads = {}
    for route in ('kernel', 'plain'):
        w = torch.tensor(w0, device=card, requires_grad=True)
        x = torch.tensor(x0, device=card, requires_grad=True)
        if route == 'kernel':
            sr, si = noise.fold_states(*cuda_hea._prepare(spec, w, x), a, b)
        else:
            sr, si = noise.fold_states(*hea.prepare_chain(spec, w, x), a, b,
                                       chain=hea.chain_dense)
        (((sr * sr + si * si) * diag).sum(-1) ** 2).sum().backward()
        grads[route] = (w.grad, x.grad)
    for got, want in zip(grads['kernel'], grads['plain']):
        assert (got - want).abs().max().item() <= 1e-4 * max(
            1.0, want.abs().max().item())


def test_noisy_expectation_routes_on_the_card(card):
    from quanonet_torch.ops import mitigation, noise
    spec = hea.quanonet_spec(5, (40, 2, 20, 2))
    rng = np.random.RandomState(4)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), device=card)
    x = torch.tensor(rng.uniform(-4, 4, (50, spec.total_encode))
                     .astype(np.float32), device=card)
    diag = simple_ham_diag(5, -5, 5)
    g = torch.Generator(device=card).manual_seed(1)
    routes = dict(noise.routes)
    before = launch_counts()['hea_chain_fwd']
    e1 = noise.noisy_expectation(g, spec, w, x, 0.01, 8, diag=diag)
    e2 = noise.noisy_expectation(g, spec, w, x, 0.01, 8, diag=diag)
    torch.cuda.synchronize()
    assert torch.equal(e1, e2)
    assert launch_counts()['hea_chain_fwd'] == before + 16
    z = mitigation.zne_expectation(g, spec, w, x, 0.01, 4, diag=diag)
    d = noise.noisy_expectation(g, spec, w, x, 0.0, 2, diag=diag,
                                damp_gamma=0.01)
    assert noise.routes['fold'] == routes['fold'] + 3
    assert noise.routes['plain'] == routes['plain'] + 1
    assert all(torch.isfinite(t).all() for t in (e1, z, d))


# ── the opt-in bf16 operand modes (UCOMP_BF16, PFUSED_BF16) ───────────────────
# Kernel against its bf16 twin: 3e-2 x max(1, max|twin|) on every entry and
# an RMS of the difference at most half that of the twin's own deviation
# from the fp32 form (chip_smoke.py's bf16_modes).  The fused chain is held
# on a few blocks: over many, a rounding that lands on the other side
# decorrelates two bf16 runs.

def _bf16_close(got, want, fp32):
    got, want, fp32 = (t.double() for t in (got, want, fp32))
    rms = lambda a: a.pow(2).mean().sqrt().item()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 3e-2 * max(
        1.0, want.abs().max().item())
    assert rms(got - want) <= 0.5 * rms(want - fp32)


@pytest.mark.parametrize("nq,net", [(2, (3, 1, 2, 1)), (3, (2, 3, 2, 3)),
                                    (5, (40, 2, 20, 2)), (6, (4, 3, 4, 3)),
                                    (7, (40, 2, 20, 2))])
def test_ucomp_bf16_kernels_match_bf16_plain(card, nq, net):
    from quanonet_torch.ops import cuda_ucomp
    spec = hea.quanonet_spec(nq, net)
    ld, nb, d = spec.block_configs[0][1], spec.n_blocks, spec.dim
    rng = np.random.RandomState(nq + 18)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), device=card)
    ops = cuda_ucomp.compile_operands(w)
    g = [torch.tensor(rng.randn(nb, d, d).astype(np.float32), device=card)
         for _ in range(2)]
    got = cuda_ucomp.ucomp_bf16_forward(*ops, ld, nb - 1)
    for a, b, c in zip(got, cuda_ucomp.ucomp_dense(*ops, ld, nb - 1,
                                                   bf16=True),
                       cuda_ucomp.ucomp_dense(*ops, ld, nb - 1)):
        _bf16_close(a, b, c)
    got = cuda_ucomp.ucomp_bf16_backward(*ops, ld, nb - 1, *g)
    for a, b, c in zip(got,
                       cuda_ucomp.ucomp_backward_dense(*ops, ld, nb - 1, *g,
                                                       bf16=True),
                       cuda_ucomp.ucomp_backward_dense(*ops, ld, nb - 1, *g)):
        _bf16_close(a, b, c)
    again = cuda_ucomp.ucomp_bf16_backward(*ops, ld, nb - 1, *g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ucomp_bf16_mode_routes_the_compile(card, monkeypatch):
    """UCOMP_BF16 on `cuda`: the model's compile launches the bf16 kernels
    (forward, and backward under autograd), not the gate form's."""
    from quanonet_torch.ops import cuda_ucomp
    monkeypatch.setattr(cuda_ucomp, 'UCOMP_BF16', True)
    spec = hea.quanonet_spec(5, (40, 2, 20, 2))
    w = torch.tensor(np.random.RandomState(2).uniform(
        -np.pi, np.pi, spec.weight_shape()).astype(np.float32), device=card,
        requires_grad=True)
    kernels = ('ucomp_fwd', 'ucomp_bwd', 'ucomp_bf16_fwd', 'ucomp_bf16_bwd')
    before = launches_of(*kernels)
    mr, mi = cuda_hea.block_mats(spec, w)
    (mr.sum() + mi.sum()).backward()
    torch.cuda.synchronize()
    assert launches_of(*kernels) == (
        before[0], before[1], before[2] + 1, before[3] + 1)
    assert bool(torch.isfinite(w.grad).all())


@pytest.mark.parametrize("nq,net,n,blocks", [(8, (3, 2, 2, 1), 1000, 5),
                                             (10, (40, 2, 20, 2), 100, 2),
                                             (13, (2, 1, 2, 1), 3, 3)])
def test_fused_bf16_kernels_match_bf16_plain(card, nq, net, n, blocks):
    from quanonet_torch.ops import cuda_fused, fused_gates
    spec = hea.quanonet_spec(nq, net)
    rng = np.random.RandomState(nq + n)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), device=card)
    x = torch.tensor(rng.uniform(-2, 2, (n, spec.total_encode))
                     .astype(np.float32), device=card)
    ops = fused_gates.prepare_fused_chain_x(spec, w, x)
    lds = fused_gates.block_depths(spec)
    s = sum(lds[:blocks])
    ops = [o[:s].contiguous() for o in ops[:4]] + [ops[4][:blocks]
                                                   .contiguous()]
    lds = lds[:blocks]
    got = cuda_fused.chain_forward(*ops, lds, save_residuals=True, bf16=True)
    want = fused_gates.chain_fused_saved_x(*ops, lds, bf16=True)
    for a, b, c in zip(got, want, fused_gates.chain_fused_saved_x(*ops, lds)):
        _bf16_close(a, b, c)
    g = [torch.tensor(rng.randn(n, spec.dim).astype(np.float32), device=card)
         for _ in range(2)]
    got = cuda_fused.chain_backward(*ops, lds, want[2], want[3], *g,
                                    bf16=True)
    twin = fused_gates.chain_fused_backward_x(*ops, lds, want[2:], *g,
                                              bf16=True)
    fp32 = fused_gates.chain_fused_backward_x(*ops, lds, want[2:], *g)
    for a, b, c in zip(got, twin, fp32):
        _bf16_close(a, b, c)


def test_fused_bf16_mode_routes_the_chain(card, monkeypatch):
    """PFUSED_BF16=1 on `cuda`: the pfused engine's forward and gradient
    launch the bf16 variants, not the fp32 kernels; unset, the fp32 ones."""
    from quanonet_torch.ops import cuda_fused
    spec = hea.quanonet_spec(10, (4, 2, 4, 2))
    rng = np.random.RandomState(6)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), device=card, requires_grad=True)
    x = torch.tensor(rng.uniform(-2, 2, (64, spec.total_encode))
                     .astype(np.float32), device=card)

    def counts():
        return launches_of('fused_chain_fwd', 'fused_chain_bwd',
                           'fused_chain_bf16_fwd', 'fused_chain_bf16_bwd')
    for on in (True, False):
        if on:
            monkeypatch.setenv('PFUSED_BF16', '1')
        else:
            monkeypatch.delenv('PFUSED_BF16')
        before = counts()
        sr, si = cuda_fused.forward_pfused(spec, w, x)
        (sr.sum() + si.sum()).backward()
        torch.cuda.synchronize()
        step = (0, 0, 1, 1) if on else (1, 1, 0, 0)
        assert counts() == tuple(b + d for b, d in zip(before, step))
