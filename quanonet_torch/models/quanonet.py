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

This slice measures exactly: the Z-diagonal and the X/Y Pauli-sum
observables.  The QPU-emulation flags (shots, noise, ZNE, T1/T2 channels,
shift-rule gradients) raise until their slice lands (ROADMAP §A9).
"""
import torch
from torch import nn

from quanonet_torch import resolve_device
from quanonet_torch.models.layers import FixedScale, TrainableFreq
from quanonet_torch.ops.hamiltonian import resolve_ham_diag, simple_ham_params
from quanonet_torch.ops.hea import (
    hea_expectation, heaqnn_spec, init_ansatz_weights, quanonet_spec,
)


def _reject_unported(shots=None, noise_p=None, readout_p=0.0,
                     zne_scales=None, damp_gamma=None, dephase_p=None,
                     grad_method='autodiff'):
    """Flags of later slices raise instead of being ignored."""
    flags = dict(shots=shots, noise_p=noise_p, readout_p=readout_p,
                 zne_scales=zne_scales, damp_gamma=damp_gamma,
                 dephase_p=dephase_p)
    used = [k for k, v in flags.items() if v]
    if grad_method == 'shift':
        used.append("grad_method='shift'")
    elif grad_method != 'autodiff':
        raise ValueError(f"unknown grad_method {grad_method!r}")
    if used:
        raise NotImplementedError(
            f"{', '.join(used)}: QPU emulation is not ported yet "
            f"(ROADMAP §A9); the port measures exactly")


class _Measure(nn.Module):
    """Exact measurement of the HEA circuit: Z-diagonal or X/Y Pauli sum."""

    def __init__(self, spec, ham_bound, ham_diag, ham_pauli, engine, device):
        super().__init__()
        self.spec = spec
        self.engine = engine
        self.pauli = ham_pauli
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

    def forward(self, ansatz, x):
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
                 grad_method='autodiff', *, device=None, generator=None):
        super().__init__()
        _reject_unported(shots, noise_p, readout_p, zne_scales, damp_gamma,
                         dephase_p, grad_method)
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
                                engine, device)

    def forward(self, branch_input, trunk_input):
        # trunk encoding first: the circuit is trunk blocks then branch blocks
        x = torch.cat([self.trunk_freq(trunk_input),
                       self.branch_freq(branch_input)], dim=1)
        return self.measure(self.ansatz, x) + self.bias


class HEAQNN(nn.Module):
    """Hardware-efficient-ansatz QNN.  net_size[:2] = (depth,
    linear_depth); no output bias."""

    def __init__(self, num_qubits, input_size, net_size, scale_coeff=0.01,
                 if_trainable_freq=True, ham_bound=(-5.0, 5.0),
                 ham_diag=None, ham_pauli='Z', engine='auto', shots=None,
                 noise_p=None, readout_p=0.0, zne_scales=None,
                 damp_gamma=None, dephase_p=None, grad_method='autodiff', *,
                 device=None, generator=None):
        super().__init__()
        _reject_unported(shots, noise_p, readout_p, zne_scales, damp_gamma,
                         dephase_p, grad_method)
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
                                engine, device)

    def forward(self, x):
        return self.measure(self.ansatz, self.freq(x))
