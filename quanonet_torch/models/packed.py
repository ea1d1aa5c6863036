"""
S models of one configuration stepped as one (the counterpart of the JAX
package's seed-vmapped parameter tree, quanonet_tpu/multiseed.py:205-208):
every parameter gets a leading seed axis, and one forward takes a batch
per seed, (S, batch, ...) -> (S, batch, ...).

The quantum models run their non-kernel ops once for all seeds: the
frequency maps and the output bias (the model's own encode and readout,
given the stacked leaves) broadcast over the seed axis, the
encoding phases are one elementwise pass (hea.encoding_phases), and on the
block-chain engine (``pallas``) the block matrices of every seed come from
two compile launches (B4f, B4b under autograd; cuda_hea.block_mats_stacked)
while each seed's chain is one B1f (B1b) launch on its slice
(cuda_hea.hea_expectation_stacked).  Every other engine (``pfused`` from 8
qubits, ``embed``, ``dense``, ``fused``) and the X/Y observables run the
seed's own call of hea.hea_expectation on its slice, one chain launch a
seed on the card.  The classical models run under ``torch.vmap`` of
``torch.func.functional_call``; no kernel of the port runs there.

Seed s's parameters are its own model's, built from its own generator, so
the pack starts where S single runs start; :meth:`PackedModel.state_dict_of`
gives seed s's state_dict back in its model's order.  Sampled models (shots,
noise) are not packed: their forward draws per-step generators per seed.
"""
import torch

from quanonet_torch.models.quanonet import HEAQNN, QuanONet
from quanonet_torch.ops import cuda_hea
from quanonet_torch.ops.hea import hea_expectation, resolve_engine


class PackedModel:
    """``models``: S models of one configuration, on one device.  The
    stacked leaves are :attr:`params` (name -> (S, ...) tensor requiring
    grad); ``models[0]`` carries the configuration (spec, engine,
    observable) and the modules the classical forward is called on."""

    def __init__(self, models):
        self.models = list(models)
        base = self.models[0]
        if getattr(base, 'sampled', False):
            raise ValueError("a model measured with shots or under a noise "
                             "channel is not packed")
        self.base = base
        self.quantum = isinstance(base, (QuanONet, HEAQNN))
        self.params = {
            k: torch.stack([dict(m.named_parameters())[k].detach()
                            for m in self.models]).requires_grad_()
            for k, _ in base.named_parameters()}
        self.names = list(base.state_dict())

    def parameters(self):
        return list(self.params.values())

    def _quantum(self, params, inputs):
        base = self.base
        x = base.encode(*inputs, params=params)
        m = base.measure
        ansatz = params['ansatz']
        engine = resolve_engine(m.engine, m.spec.n_qubits, x.device)
        if engine == 'pallas' and m.pauli == 'Z':
            out = cuda_hea.hea_expectation_stacked(m.spec, ansatz, x, m.diag)
        else:
            out = torch.stack([
                hea_expectation(m.spec, ansatz[s], x[s], diag=m.diag,
                                pauli=m.pauli, offset=m.offset,
                                coeff=m.coeff, engine=m.engine)
                for s in range(x.shape[0])])
        return base.readout(out, params)

    def _classical(self, params, inputs):
        base = self.base

        def one(p, *xs):
            return torch.func.functional_call(base, p, xs)
        return torch.vmap(one)(params, *inputs)

    def __call__(self, *inputs, params=None):
        """inputs (S, batch, ...) each -> predictions (S, batch, ...), with
        the stacked tensors ``params`` in place of :attr:`params`."""
        params = self.params if params is None else params
        if self.quantum:
            return self._quantum(params, inputs)
        return self._classical(params, inputs)

    def state_dict_of(self, s, params=None):
        """Seed s's state_dict (CPU tensors, its model's key order) from
        ``params`` (default :attr:`params`)."""
        params = self.params if params is None else params
        own = self.models[s].state_dict()
        return {k: (params[k][s] if k in params else own[k]).detach()
                .cpu().clone() for k in self.names}

    def load_seed(self, s, params=None):
        """Seed s's model with its slice of ``params`` loaded; returns it."""
        model = self.models[s]
        model.load_state_dict(self.state_dict_of(s, params))
        return model

