"""Quantum models of the port; the classical baselines come in a later
slice (ROADMAP §A7)."""
from quanonet_torch.models.layers import FixedScale, TrainableFreq, tile_to
from quanonet_torch.models.quanonet import HEAQNN, QuanONet
