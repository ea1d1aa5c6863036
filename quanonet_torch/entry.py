"""
The flagship forward as one callable (counterpart of
``__graft_entry__.entry``; its twin ``dryrun_multichip`` is
:mod:`quanonet_torch.multichip`):

    from quanonet_torch.entry import entry
    fn, (branch, trunk) = entry()          # on the card
    out = fn(branch, trunk)                # (8, 1)

QuanONet Q5 Net40-2-20-2 with TrainableFreq at scale 0.1 (the reference's
headline architecture), inputs from ``np.random.RandomState(0)`` at batch
8 (branch N(0, 1) of width 100, trunk U[0, 1) of width 2, as the JAX
entry draws them), parameters from a torch generator seeded 0.  ``fn``
runs the forward under ``torch.inference_mode``: on the card one call
launches the compile kernel B4f and the chain kernel B1f once each.
Runs on the card unless ``device='cpu'``; raises without one.
"""
import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.models import QuanONet

FLAGSHIP_NET = (40, 2, 20, 2)
BATCH = 8


def flagship(device=None, batch=BATCH):
    """(model, branch, trunk) of the entry on ``device``."""
    device = resolve_device(device)
    model = QuanONet(num_qubits=5, branch_input_size=100, trunk_input_size=2,
                     net_size=FLAGSHIP_NET, scale_coeff=0.1,
                     if_trainable_freq=True, device=device,
                     generator=torch.Generator().manual_seed(0))
    model.eval()
    rng = np.random.RandomState(0)
    branch = torch.as_tensor(rng.randn(batch, 100).astype(np.float32),
                             device=device)
    trunk = torch.as_tensor(rng.rand(batch, 2).astype(np.float32),
                            device=device)
    return model, branch, trunk


def entry(device=None):
    """-> (fn, (branch, trunk)): the flagship's forward and its inputs."""
    model, branch, trunk = flagship(device)

    def fn(branch_input, trunk_input):
        with torch.inference_mode():
            return model(branch_input, trunk_input)

    fn.model = model
    return fn, (branch, trunk)
