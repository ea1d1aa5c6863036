"""
The CUDA block-chain kernel (quanonet_torch/csrc/hea_chain.cu) against its
plain version on the card.  Marked ``cuda``: without a card each test
skips; on the card run them with

    python -m pytest tests/test_torch_port_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from quanonet_torch.ops import cuda_hea, hea
from quanonet_torch.ops.hamiltonian import simple_ham_diag

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
    before = cuda_hea.launches
    kr, ki = cuda_hea.block_chain(*ops)
    torch.cuda.synchronize()
    assert cuda_hea.launches == before + 1
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
    with pytest.raises(NotImplementedError, match='B1b'):
        cuda_hea.block_chain(mt_r.requires_grad_(), mt_i, phi)
