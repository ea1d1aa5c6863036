"""
Classical baseline models: FNN, DeepONet, FNO as torch modules (counterpart
of quanonet_tpu/models/classical.py).

* FNN — fc0 + depth hidden + fc_out, tanh, Xavier-normal init;
* DeepONet — branch MLP · tanh(trunk MLP), summed, + scalar bias (the extra
  activation on the trunk output is the paper's convention);
* FNO — 1-D spectral convolution + 1x1 convolution residual stack.  The
  complex spectral weights are two float32 leaves (re, im), and the
  truncated real DFT is two real matrix products (:func:`dft_basis`), as in
  the JAX package: rfft -> keep the first ``modes`` -> zero-pad -> irfft,
  in pure real arithmetic.

These are plain matrix products that the JAX package computes outside any
Pallas kernel, so ``nn.Linear`` and ``torch.einsum`` carry them here.

Module names are the flax names (``dense_i``, ``branch``, ``trunk``,
``bias``, ``fc0``, ``conv_i.w_re/w_im``, ``w_i``, ``fc1``, ``fc2``), so a
state_dict key is the flax path with ``.``; a flax ``Dense`` kernel
(in, out) is ``nn.Linear.weight`` (out, in) transposed
(quanonet_torch/convert.py).  PyTorch infers no shapes: every module takes
its input width, and, like the quantum models, its ``device`` (``cuda``
unless ``'cpu'`` is asked for).  Initial weights are drawn on the CPU from
``generator`` with flax's distributions: truncated normal (±2σ) of variance
2/(in + out) for the MLPs (``glorot_normal``) and 1/in for FNO's dense
layers (flax's ``Dense`` default, ``lecun_normal``), zero biases,
U(0, 1/(in·out)) for the spectral weights.
"""
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from quanonet_torch import resolve_device

# std of a unit normal truncated to ±2: jax's variance_scaling divides by it
_TRUNC_STD = 0.87962566103423978


def _dense(in_features, out_features, fan, device, generator):
    """``nn.Linear`` with flax's initial weights: truncated normal of
    variance 1/fan, zero bias."""
    lin = nn.Linear(in_features, out_features, device=device)
    w = torch.empty(out_features, in_features)
    nn.init.trunc_normal_(w, generator=generator)        # ±2, unit normal
    w *= float(np.sqrt(1.0 / fan)) / _TRUNC_STD
    with torch.no_grad():
        lin.weight.copy_(w)
        lin.bias.zero_()
    return lin


class MLP(nn.Module):
    """Dense stack ``dense_0 .. dense_{n-1}``; tanh after every layer except
    the last.  ``layer_sizes``: hidden and output widths."""

    def __init__(self, in_features, layer_sizes, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.layer_sizes = tuple(int(w) for w in layer_sizes)
        width = int(in_features)
        for i, out in enumerate(self.layer_sizes):
            self.add_module(f'dense_{i}', _dense(
                width, out, (width + out) / 2.0, device, generator))
            width = out

    def forward(self, x):
        n = len(self.layer_sizes)
        for i in range(n):
            x = getattr(self, f'dense_{i}')(x)
            if i < n - 1:
                x = torch.tanh(x)
        return x


class FNN(nn.Module):
    """net_size = (hidden_depth, hidden_width); output scalar: fc0 + depth
    hidden + fc_out, so depth + 1 hidden widths."""

    def __init__(self, in_features, net_size, output_size=1, *, device=None,
                 generator=None):
        super().__init__()
        depth, width = int(net_size[0]), int(net_size[1])
        self.net_size = (depth, width)
        self.fnn = MLP(in_features, [width] * (depth + 1) + [output_size],
                       device=device, generator=generator)

    def forward(self, x):
        return self.fnn(x)


class DeepONet(nn.Module):
    """branch_layers / trunk_layers: widths after the input layer; the last
    entries must match (latent dimension p).
    out = Σ_p b_p · tanh(t_p) + bias."""

    def __init__(self, branch_in, trunk_in, branch_layers, trunk_layers, *,
                 device=None, generator=None):
        super().__init__()
        if branch_layers[-1] != trunk_layers[-1]:
            raise ValueError(
                f"DeepONet: branch and trunk end in different widths "
                f"({branch_layers[-1]} and {trunk_layers[-1]})")
        self.branch = MLP(branch_in, branch_layers, device=device,
                          generator=generator)
        self.trunk = MLP(trunk_in, trunk_layers, device=device,
                         generator=generator)
        self.bias = nn.Parameter(torch.zeros((), device=resolve_device(
            device)))

    def forward(self, branch_input, trunk_input):
        b = self.branch(branch_input)
        t = torch.tanh(self.trunk(trunk_input))
        return (b * t).sum(dim=1, keepdim=True) + self.bias


def deeponet_layer_sizes(net_config, branch_in, trunk_in):
    """The reference's net-size policy: 2-arg [depth, width]; 4-arg
    [bd, bw, td, tw] (width-mismatch fallback p = min); 5-arg
    [bd, bw, td, tw, p]."""
    b_depth, b_width = 2, 10
    t_depth, t_width = 2, 10
    p = None
    net_config = list(net_config or [])
    if len(net_config) == 2:
        b_depth = t_depth = net_config[0]
        b_width = t_width = net_config[1]
        p = b_width
    elif len(net_config) == 4:
        b_depth, b_width, t_depth, t_width = net_config
        p = b_width if b_width == t_width else min(b_width, t_width)
    elif len(net_config) == 5:
        b_depth, b_width, t_depth, t_width, p = net_config

    if p is not None and (len(net_config) == 5 or b_width != t_width):
        branch = [b_width] * (b_depth - 1) + [p]
        trunk = [t_width] * (t_depth - 1) + [p]
    else:
        branch = [b_width] * b_depth
        trunk = [t_width] * t_depth
    return tuple(branch), tuple(trunk)


@lru_cache(maxsize=32)
def dft_basis(n_points: int, modes: int):
    """Truncated real-DFT analysis/synthesis matrices (float32 NumPy):
    (cos_f, sin_f, cos_b, sin_b) with

      X_re = x @ cos_f, X_im = x @ sin_f          (analysis, (N, modes))
      out  = X_re @ cos_b - X_im @ sin_b          (synthesis, (modes, N))
    """
    p = np.arange(n_points)[:, None]
    f = np.arange(modes)[None, :]
    ang = 2.0 * np.pi * p * f / n_points
    cos_f = np.cos(ang).astype(np.float32)
    sin_f = (-np.sin(ang)).astype(np.float32)
    # irfft synthesis weights: 1/N for f=0, 2/N for 0<f<N/2, 1/N at Nyquist
    weight = np.full(modes, 2.0 / n_points)
    weight[0] = 1.0 / n_points
    if n_points % 2 == 0 and modes == n_points // 2 + 1:
        weight[-1] = 1.0 / n_points
    cos_b = (weight[:, None] * np.cos(ang).T).astype(np.float32)
    sin_b = (weight[:, None] * np.sin(ang).T).astype(np.float32)
    return cos_f, sin_f, cos_b, sin_b


class SpectralConv1d(nn.Module):
    """Fourier spectral convolution on (batch, n_points, channels):
    truncated real DFT along the points axis.  The DFT matrices are
    buffers, built for the signal length of the first call and again when
    it changes (not part of the state_dict)."""

    _BASIS = ('cos_f', 'sin_f', 'cos_b', 'sin_b')

    def __init__(self, in_channels, out_channels, modes, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.modes = int(modes)
        scale = 1.0 / (self.in_channels * self.out_channels)
        shape = (self.in_channels, self.out_channels, self.modes)
        for name in ('w_re', 'w_im'):
            w = torch.empty(shape).uniform_(0.0, scale, generator=generator)
            setattr(self, name, nn.Parameter(w.to(device)))
        self.n_points = None
        for name in self._BASIS:
            self.register_buffer(name, None, persistent=False)

    def _basis(self, n_points, device):
        if n_points != self.n_points or self.cos_f.device != device:
            freq_size = n_points // 2 + 1
            if self.modes > freq_size:
                raise ValueError(
                    f"SpectralConv1d: modes={self.modes} exceeds Nyquist "
                    f"freq_size={freq_size} for signal length {n_points}.")
            for name, m in zip(self._BASIS, dft_basis(n_points, self.modes)):
                setattr(self, name, torch.as_tensor(m, device=device))
            self.n_points = n_points
        return self.cos_f, self.sin_f, self.cos_b, self.sin_b

    def forward(self, x):
        cos_f, sin_f, cos_b, sin_b = self._basis(x.shape[1], x.device)
        # analysis: (b, p, i) -> (b, modes, i)
        x_re = torch.einsum('bpi,pf->bfi', x, cos_f)
        x_im = torch.einsum('bpi,pf->bfi', x, sin_f)
        # complex channel mix per mode
        o_re = (torch.einsum('bfi,iof->bfo', x_re, self.w_re)
                - torch.einsum('bfi,iof->bfo', x_im, self.w_im))
        o_im = (torch.einsum('bfi,iof->bfo', x_re, self.w_im)
                + torch.einsum('bfi,iof->bfo', x_im, self.w_re))
        # synthesis back to (b, p, o)
        return (torch.einsum('bfo,fp->bpo', o_re, cos_b)
                - torch.einsum('bfo,fp->bpo', o_im, sin_b))


def fno_sizes(net_size):
    """net_size [modes, width, layers, fc_hidden], each optional -> FNO's
    keyword arguments with the reference's defaults 15 / 14 / 3 / 32."""
    cfg = [int(v) for v in net_size or ()]
    names, defaults = ('modes', 'width', 'layers', 'fc_hidden'), (15, 14, 3, 32)
    return {k: cfg[i] if len(cfg) > i else d
            for i, (k, d) in enumerate(zip(names, defaults))}


class FNO(nn.Module):
    """1-D Fourier Neural Operator.  Input (batch, n_points, in_channels)
    -> (batch, n_points, 1)."""

    def __init__(self, in_channels, modes, width, layers=1, fc_hidden=32, *,
                 device=None, generator=None):
        super().__init__()
        self.modes, self.width = int(modes), int(width)
        self.layers, self.fc_hidden = int(layers), int(fc_hidden)
        kw = dict(device=resolve_device(device), generator=generator)
        self.fc0 = _dense(in_channels, self.width, in_channels, **kw)
        for i in range(self.layers):
            self.add_module(f'conv_{i}', SpectralConv1d(
                self.width, self.width, self.modes, **kw))
            self.add_module(f'w_{i}', _dense(self.width, self.width,
                                             self.width, **kw))   # 1x1 conv
        self.fc1 = _dense(self.width, self.fc_hidden, self.width, **kw)
        self.fc2 = _dense(self.fc_hidden, 1, self.fc_hidden, **kw)

    def forward(self, x):
        x = self.fc0(x)
        for i in range(self.layers):
            x = torch.relu(getattr(self, f'conv_{i}')(x)
                           + getattr(self, f'w_{i}')(x))
        return self.fc2(torch.relu(self.fc1(x)))
