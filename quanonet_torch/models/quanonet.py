"""
QuanONet and HEAQNN as torch modules (counterpart of
quanonet_tpu/models/quanonet.py).

QuanONet:
    branch u0 -> freq map -> branch_enc (branch_depth * nq angles)
    trunk  y  -> freq map -> trunk_enc  (trunk_depth * nq angles)
    x = concat([trunk_enc, branch_enc])          # trunk first!
    out = <H>_HEA(x) + bias                      # scalar trainable bias

HEAQNN (ablation twin): single input stream, same blocks, no bias.

state_dict keys follow the JAX package's parameter tree
(quanonet_torch/convert.py maps between them):
    ansatz (S,3,nq), bias (), branch_freq.{weights,bias},
    trunk_freq.{weights,bias} (QuanONet); ansatz, freq.{weights,bias}
    (HEAQNN).

Measurement: exact, or with ``shots`` finite-shot sampled
(ops/sampling.py) from a ``torch.Generator`` passed to ``forward``; with
``grad_method='shift'`` the circuit's gradient is the parameter-shift rule
(ops/param_shift.py) for the ansatz and the encode inputs, exact or
sampled.  With ``noise_p``, ``readout_p``, ``damp_gamma`` or ``dephase_p``
the output is the mean over ``noise_traj`` noise trajectories
(ops/noise.py), drawn from the same generator, and with ``zne_scales`` it
is zero-noise extrapolated (ops/mitigation.py); autograd differentiates
through the trajectories (noise-aware training).
"""
import torch
from torch import nn

from quanonet_torch import resolve_device
from quanonet_torch.models.layers import FixedScale, TrainableFreq
from quanonet_torch.ops.hamiltonian import resolve_ham_diag, simple_ham_params
from quanonet_torch.ops.hea import (
    hea_expectation, heaqnn_spec, init_ansatz_weights, quanonet_spec,
)
from quanonet_torch.ops.mitigation import zne_expectation
from quanonet_torch.ops.noise import is_noisy, noisy_expectation
from quanonet_torch.ops.param_shift import make_ps_expectation
from quanonet_torch.ops.sampling import shot_expectation


class _Measure(nn.Module):
    """Measurement of the HEA circuit: the Z-diagonal or an X/Y Pauli sum,
    exact, from ``shots``, or under a noise channel (the mean over
    ``noise_traj`` trajectories, zero-noise extrapolated with
    ``zne_scales``); with grad_method 'shift' its gradient is the shift
    rule (ps_chunk bounds the fan-out).  ``sampled``: forward needs a
    generator."""

    def __init__(self, spec, ham_bound, ham_diag, ham_pauli, engine, device,
                 shots=None, grad_method='autodiff', ps_chunk=None,
                 noise_p=None, noise_traj=32, readout_p=0.0,
                 zne_scales=None, damp_gamma=None, dephase_p=None):
        super().__init__()
        if grad_method not in ('autodiff', 'shift'):
            raise ValueError(f"unknown grad_method {grad_method!r}")
        self.spec = spec
        self.engine = engine
        self.pauli = ham_pauli
        self.shots = int(shots) if shots else None
        self.configure(noise_p, noise_traj, readout_p, zne_scales,
                       damp_gamma, dephase_p, grad_method)
        if ham_pauli == 'Z' or ham_diag is not None:
            self.pauli = 'Z'
            diag = resolve_ham_diag(
                spec.n_qubits, list(ham_bound),
                list(ham_diag) if ham_diag is not None else None)
            self.register_buffer(
                'diag', torch.as_tensor(diag, device=device),
                persistent=False)
            self.offset = self.coeff = 0.0
        else:
            self.diag = None
            self.offset, self.coeff = simple_ham_params(
                spec.n_qubits, ham_bound[0], ham_bound[1])
        self.shift = None
        if grad_method == 'shift':
            self.shift = make_ps_expectation(
                spec, diag=self.diag, pauli=self.pauli, offset=self.offset,
                coeff=self.coeff, engine=engine, shots=self.shots,
                chunk=ps_chunk)

    def configure(self, noise_p=None, noise_traj=32, readout_p=0.0,
                  zne_scales=None, damp_gamma=None, dephase_p=None,
                  grad_method='autodiff'):
        """Set the noise channel, with the JAX package's guards."""
        noisy = is_noisy(noise_p, readout_p, damp_gamma, dephase_p)
        if grad_method == 'shift' and (noisy or zne_scales):
            raise ValueError(
                "grad_method='shift' assumes a unitary circuit; drop the "
                "noise/zne flags (noise-aware training uses autodiff)")
        if zne_scales:
            if not noise_p:
                raise ValueError("zne_scales requires noise_p > 0")
            if self.shots:
                raise ValueError(
                    "zne_scales and shots are mutually exclusive "
                    "(extrapolate exact trajectory expectations)")
            if is_noisy(damp_gamma=damp_gamma, dephase_p=dephase_p):
                raise ValueError(
                    "zne_scales extrapolates the depolarizing channel "
                    "only; drop damp_gamma/dephase_p")
        self.noisy = noisy
        self.noise_p = noise_p
        self.noise_traj = int(noise_traj)
        self.readout_p = readout_p or 0.0
        self.zne_scales = (tuple(float(c) for c in zne_scales)
                           if zne_scales else None)
        self.damp_gamma = damp_gamma
        self.dephase_p = dephase_p
        self.sampled = bool(self.shots or noisy or self.zne_scales)

    def forward(self, ansatz, x, generator=None):
        if self.sampled and generator is None:
            what = (f"{self.shots} shots" if not self.noisy
                    else "a noise channel")
            raise ValueError(f"a model measured with {what} needs a "
                             f"generator")
        obs = dict(diag=self.diag, pauli=self.pauli, offset=self.offset,
                   coeff=self.coeff)
        if self.zne_scales:
            return zne_expectation(generator, self.spec, ansatz, x,
                                   self.noise_p, self.noise_traj,
                                   scales=self.zne_scales,
                                   readout_p=self.readout_p, **obs)
        if self.noisy:
            return noisy_expectation(
                generator, self.spec, ansatz, x,
                self.noise_p if self.noise_p is not None else 0.0,
                self.noise_traj, shots=self.shots, readout_p=self.readout_p,
                damp_gamma=self.damp_gamma, dephase_p=self.dephase_p, **obs)
        if self.shift is not None:
            return (self.shift(ansatz, x, generator) if self.shots
                    else self.shift(ansatz, x))
        if self.shots:
            return shot_expectation(generator, self.spec, ansatz, x,
                                    self.shots, diag=self.diag,
                                    pauli=self.pauli, offset=self.offset,
                                    coeff=self.coeff, engine=self.engine)
        return hea_expectation(self.spec, ansatz, x, diag=self.diag,
                               pauli=self.pauli, offset=self.offset,
                               coeff=self.coeff, engine=self.engine)


class QuanONet(nn.Module):
    """Quantum operator network."""

    def __init__(self, num_qubits, branch_input_size, trunk_input_size,
                 net_size, scale_coeff=0.01, if_trainable_freq=True,
                 ham_bound=(-5.0, 5.0), ham_diag=None, ham_pauli='Z',
                 engine='auto', shots=None, noise_p=None, readout_p=0.0,
                 zne_scales=None, damp_gamma=None, dephase_p=None,
                 grad_method='autodiff', ps_chunk=None, noise_traj=32, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_qubits = int(num_qubits)
        self.branch_input_size = int(branch_input_size)
        self.trunk_input_size = int(trunk_input_size)
        self.net_size = tuple(int(v) for v in net_size)
        self.engine = engine
        self.spec = quanonet_spec(self.num_qubits, self.net_size)
        bd, _, td, _ = self.net_size
        nq = self.num_qubits
        if if_trainable_freq:
            self.branch_freq = TrainableFreq(bd * nq, scale_coeff,
                                             device=device,
                                             generator=generator)
            self.trunk_freq = TrainableFreq(td * nq, scale_coeff,
                                            device=device,
                                            generator=generator)
        else:
            self.branch_freq = FixedScale(bd * nq, scale_coeff)
            self.trunk_freq = FixedScale(td * nq, scale_coeff)
        self.ansatz = nn.Parameter(
            init_ansatz_weights(self.spec, generator, device))
        self.bias = nn.Parameter(torch.zeros((), device=device))
        self.measure = _Measure(self.spec, ham_bound, ham_diag, ham_pauli,
                                engine, device, shots, grad_method, ps_chunk,
                                noise_p, noise_traj, readout_p, zne_scales,
                                damp_gamma, dephase_p)
        self.shots = self.measure.shots
        self.grad_method = grad_method

    @property
    def sampled(self):
        """Whether forward draws from a generator (shots or noise)."""
        return self.measure.sampled

    def encode(self, branch_input, trunk_input, params=None):
        """The circuit's angles (..., batch, width); ``params`` (tensors by
        state_dict name, with leading axes) in place of the module's
        own."""
        # trunk encoding first: the circuit is trunk blocks then branch blocks
        return torch.cat([self.trunk_freq(trunk_input, params, 'trunk_freq'),
                          self.branch_freq(branch_input, params,
                                           'branch_freq')], dim=-1)

    def readout(self, out, params=None):
        """The measured ``out`` (..., batch, 1) plus the output bias."""
        bias = self.bias if params is None else params['bias']
        return out + bias.reshape(bias.shape
                                  + (1,) * (out.dim() - bias.dim()))

    def forward(self, branch_input, trunk_input, generator=None):
        """``generator`` draws the shots and noise of a sampled model."""
        x = self.encode(branch_input, trunk_input)
        return self.readout(self.measure(self.ansatz, x, generator))


class HEAQNN(nn.Module):
    """Hardware-efficient-ansatz QNN.  net_size[:2] = (depth,
    linear_depth); no output bias."""

    def __init__(self, num_qubits, input_size, net_size, scale_coeff=0.01,
                 if_trainable_freq=True, ham_bound=(-5.0, 5.0),
                 ham_diag=None, ham_pauli='Z', engine='auto', shots=None,
                 noise_p=None, readout_p=0.0, zne_scales=None,
                 damp_gamma=None, dephase_p=None, grad_method='autodiff',
                 ps_chunk=None, noise_traj=32, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_qubits = int(num_qubits)
        self.input_size = int(input_size)
        self.net_size = tuple(int(v) for v in net_size)
        self.engine = engine
        self.spec = heaqnn_spec(self.num_qubits, self.net_size)
        width = self.net_size[0] * self.num_qubits
        if if_trainable_freq:
            self.freq = TrainableFreq(width, scale_coeff, device=device,
                                      generator=generator)
        else:
            self.freq = FixedScale(width, scale_coeff)
        self.ansatz = nn.Parameter(
            init_ansatz_weights(self.spec, generator, device))
        self.measure = _Measure(self.spec, ham_bound, ham_diag, ham_pauli,
                                engine, device, shots, grad_method, ps_chunk,
                                noise_p, noise_traj, readout_p, zne_scales,
                                damp_gamma, dephase_p)
        self.shots = self.measure.shots
        self.grad_method = grad_method

    @property
    def sampled(self):
        """Whether forward draws from a generator (shots or noise)."""
        return self.measure.sampled

    def encode(self, x, params=None):
        """The circuit's angles (QuanONet.encode)."""
        return self.freq(x, params, 'freq')

    def readout(self, out, params=None):
        """``out`` itself: HEAQNN has no output bias."""
        return out

    def forward(self, x, generator=None):
        """``generator`` draws the shots and noise of a sampled model."""
        return self.measure(self.ansatz, self.encode(x), generator)
