"""Models of the port: the quantum models and the classical baselines."""
from quanonet_torch.models.classical import (
    FNN, FNO, MLP, DeepONet, SpectralConv1d, deeponet_layer_sizes,
    fno_sizes,
)
from quanonet_torch.models.layers import FixedScale, TrainableFreq, tile_to
from quanonet_torch.models.quanonet import HEAQNN, QuanONet
