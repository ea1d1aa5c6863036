"""
Frequency-mapping layers shared by the quantum models (counterpart of
quanonet_tpu/models/layers.py).

* trainable-freq (TF) mode: tile the input cyclically to
  depth*num_qubits, then elementwise ``x*w + b``.  Init: w = scale_coeff
  constant, b ~ U(-π, π) (the MindSpore original's convention, which the
  JAX package follows).
* fixed mode: elementwise * scale_coeff then tile; no parameters.
"""
import numpy as np
import torch
from torch import nn


def tile_to(x, out_features):
    """Cyclically tile (batch, m) -> (batch, out_features)."""
    m = x.shape[-1]
    reps = out_features // m + 1
    return x.repeat(*((1,) * (x.dim() - 1)), reps)[..., :out_features]


class TrainableFreq(nn.Module):
    """Tile + trainable elementwise affine (TF mode)."""

    def __init__(self, out_features, init_scale=0.01,
                 bias_init_range=float(np.pi), *, device=None,
                 generator=None):
        super().__init__()
        self.out_features = int(out_features)
        self.weights = nn.Parameter(
            torch.full((self.out_features,), float(init_scale),
                       dtype=torch.float32, device=device))
        r = float(bias_init_range)
        bias = torch.empty(self.out_features, dtype=torch.float32)
        bias.uniform_(-r, r, generator=generator)   # drawn on the CPU
        self.bias = nn.Parameter(bias.to(device))

    def forward(self, x, params=None, prefix=None):
        """x (..., batch, m); with ``params`` the tensors
        ``params[prefix + '.weights']``/``'.bias'`` (..., out) in place of
        the layer's own, their leading axes matching x's (a seed axis:
        models/packed.py)."""
        w, b = ((self.weights, self.bias) if params is None else
                (params[f'{prefix}.weights'], params[f'{prefix}.bias']))
        return (tile_to(x, self.out_features) * w.unsqueeze(-2)
                + b.unsqueeze(-2))


class FixedScale(nn.Module):
    """Scale by a constant then tile (fixed-freq mode); parameter-free."""

    def __init__(self, out_features, scale=0.01):
        super().__init__()
        self.out_features = int(out_features)
        self.scale = float(scale)

    def forward(self, x, params=None, prefix=None):
        return tile_to(x * self.scale, self.out_features)
