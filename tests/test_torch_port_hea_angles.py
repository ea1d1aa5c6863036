"""
The block chain's angle route on the host side (quanonet_torch/ops/
cuda_hea.py): the route forward_pallas takes (the angles where no gradient
is needed on CUDA tensors, the phases under a gradient and on the CPU),
the argument checks of chain_forward_angles, and its counter beside the
13 launch keys.  The kernel itself runs in tests/
test_torch_port_hea_emulated.py on the CPU and in the cuda-marked tests
on the card.
"""
import numpy as np
import pytest
import torch

from quanonet_torch import tracing
from quanonet_torch.ops import cuda_hea, hea
from quanonet_torch.profile_step import LAUNCH_KEYS, launch_counts

NQ, NET, BATCH = 3, (2, 1, 2, 1), 6


@pytest.fixture(autouse=True)
def _fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


class _OnCard:
    """Angles that claim to lie on a card.  On the angle route
    forward_pallas reads only these of x; the stand-in launch below reads
    the tensor inside."""

    is_cuda = True

    def __init__(self, x):
        self.x, self.shape, self.requires_grad = x, x.shape, x.requires_grad

    def contiguous(self):
        return self


def _phases(x, nb):
    n = x.shape[1] // nb
    return hea.encoding_phases(hea.HEASpec(n, ((n, 0),) * nb), x)


@pytest.fixture
def routes(monkeypatch):
    """Each route forward_pallas takes, in order; both compute on the CPU
    (the angle launch as chain_dense on encoding_phases)."""
    taken = []
    prepare = cuda_hea._prepare

    def angles(mt_r, mt_i, x, nb):
        taken.append('angles')
        return hea.chain_dense(mt_r, mt_i, _phases(x.x, nb))

    def phases(spec, weights, x):
        taken.append('phases')
        return prepare(spec, weights, x.x if isinstance(x, _OnCard) else x)

    monkeypatch.setattr(cuda_hea, 'chain_forward_angles', angles)
    monkeypatch.setattr(cuda_hea, '_prepare', phases)
    return taken


def _case(x_grad=False):
    spec = hea.quanonet_spec(NQ, NET)
    rng = np.random.RandomState(5)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, spec.weight_shape())
                     .astype(np.float32), requires_grad=True)
    x = torch.tensor(rng.uniform(-3, 3, (BATCH, spec.total_encode))
                     .astype(np.float32), requires_grad=x_grad)
    return spec, w, x


@pytest.mark.parametrize("mode", ['no_grad', 'inference_mode'])
def test_no_grad_on_the_card_takes_the_angles(routes, mode):
    spec, w, x = _case()
    with getattr(torch, mode)():
        got = cuda_hea.forward_pallas(spec, w, _OnCard(x))
        want = cuda_hea.forward_pallas(spec, w, x)
    assert routes == ['angles', 'phases']
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_no_input_requiring_grad_takes_the_angles(routes):
    """Grad enabled, but neither the weights nor x require it."""
    spec, w, x = _case()
    diag = torch.linspace(-5, 5, spec.dim)
    out = cuda_hea.hea_expectation_pallas(spec, w.detach(), _OnCard(x), diag)
    assert routes == ['angles'] and not out.requires_grad


@pytest.mark.parametrize("x_grad", [False, True])
def test_a_gradient_takes_the_phases(routes, x_grad):
    """Grad enabled and the weights or x requiring it: the phases and
    BlockChain, on the card as on the CPU."""
    spec, w, x = _case(x_grad)
    if x_grad:
        w = w.detach()
    sr, si = cuda_hea.forward_pallas(spec, w, _OnCard(x))
    (sr.sum() + si.sum()).backward()
    assert routes == ['phases']
    assert (x if x_grad else w).grad is not None


def test_the_cpu_takes_the_phases(routes):
    spec, w, x = _case()
    with torch.no_grad():
        cuda_hea.forward_pallas(spec, w, x)
    cuda_hea.forward_pallas(spec, w, x)
    assert routes == ['phases', 'phases']


def _angle_operands(d=8, nb=3, n=5):
    return (torch.zeros(nb, d, d), torch.zeros(nb, d, d),
            torch.zeros(n, nb * (d.bit_length() - 1)))


def test_angle_route_checks_its_arguments():
    mt_r, mt_i, x = _angle_operands()
    call = cuda_hea.chain_forward_angles
    with pytest.raises(ValueError, match='CUDA device'):
        call(mt_r, mt_i, x, 3)
    with pytest.raises(ValueError, match=r'x must be \(N, 9\)'):
        call(mt_r, mt_i, torch.zeros(5, 10), 3)
    with pytest.raises(ValueError, match=r'x must be \(N, 9\)'):
        call(mt_r, mt_i, torch.zeros(45), 3)
    with pytest.raises(ValueError, match=r'x must be \(N, 9\)'):
        call(mt_r, mt_i, torch.zeros(3, 5, 3), 3)
    with pytest.raises(TypeError, match='float32'):
        call(mt_r, mt_i, x.double(), 3)
    with pytest.raises(ValueError, match='contiguous'):
        call(mt_r, mt_i, torch.zeros(9, 5).t(), 3)
    with pytest.raises(ValueError, match='must be'):
        call(mt_r, mt_i[:2], x, 3)
    with pytest.raises(ValueError, match='at least one block'):
        call(mt_r[:0], mt_i[:0], x[:, :0], 0)
    with pytest.raises(ValueError, match=r'mt_r must be \(nb, D, D\)'):
        call(mt_r[0], mt_i, x, 3)
    for d in (3, 256):
        mt = torch.zeros(3, d, d)
        with pytest.raises(ValueError, match='D in'):
            call(mt, mt, x, 3)


def test_angle_counter_is_outside_the_launch_keys():
    assert 'hea_chain_fwd_angles' not in LAUNCH_KEYS
    assert len(LAUNCH_KEYS) == 13
    tracing.count('hea_chain_fwd_angles')
    assert launch_counts() == {k: 0 for k in LAUNCH_KEYS}
    assert tracing.counts()['hea_chain_fwd_angles'] == 1
