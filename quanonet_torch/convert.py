"""
Weights carried across between the JAX package and the port.

* ``state_dict_from_flax(tree)``: the JAX package's ``{'params': {...}}``
  (as NumPy arrays) -> the port's ``state_dict``; ``flax_from_state_dict``
  is its inverse.
* ``state_dict_from_raw(raw, ...)``: the same from reference checkpoint
  keys (quanonet_torch/checkpoint.py); ``raw_from_state_dict`` is its
  inverse.

* ``adam_state_from_flax(count, mu, nu, names)``: an optax-Adam or JAX
  ``FusedAdam`` state -> the ``state_dict`` of the port's
  ``ops/cuda_adam.FusedAdam``.

A nested key ``branch_freq/weights`` of the tree is ``branch_freq.weights``
in the state_dict; top-level leaves (``ansatz``, ``bias``) keep their names.
"""
import numpy as np
import torch

from quanonet_torch.checkpoint import (
    quantum_params_from_raw, quantum_params_to_raw,
)


def state_dict_from_flax(tree) -> dict:
    """{'params': {name: array | {name: array}}} -> {'a.b': float32 tensor}."""
    p = tree['params'] if 'params' in tree else tree
    sd = {}
    for name, node in p.items():
        leaves = node.items() if isinstance(node, dict) else [(None, node)]
        for leaf, value in leaves:
            key = name if leaf is None else f'{name}.{leaf}'
            sd[key] = torch.tensor(np.array(value, dtype=np.float32))
    return sd


def flax_from_state_dict(state_dict) -> dict:
    """Inverse of :func:`state_dict_from_flax` (NumPy leaves)."""
    params = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy().astype(np.float32)
        name, _, leaf = key.partition('.')
        if leaf:
            params.setdefault(name, {})[leaf] = arr
        else:
            params[name] = arr
    return {'params': params}


def adam_state_from_flax(count, mu, nu, names) -> dict:
    """An Adam state of the JAX package as NumPy arrays (the update count
    and the two moment trees, shaped like the parameter tree) -> the
    ``state_dict`` that ``ops/cuda_adam.FusedAdam.load_state_dict`` takes.
    ``names``: the state_dict keys of the optimizer's parameters, in its
    order (``[k for k, _ in model.named_parameters()]``)."""
    mu, nu = state_dict_from_flax(mu), state_dict_from_flax(nu)
    return {'count': int(count),
            'state': {i: {'mu': mu[k], 'nu': nu[k]}
                      for i, k in enumerate(names)}}


def state_dict_from_raw(raw, model_type, net_size, num_qubits,
                        if_trainable_freq) -> dict:
    """Reference checkpoint keys -> the port's state_dict."""
    return state_dict_from_flax(quantum_params_from_raw(
        raw, model_type, tuple(net_size), int(num_qubits),
        bool(if_trainable_freq)))


def raw_from_state_dict(state_dict, model_type) -> dict:
    """The port's state_dict -> reference checkpoint keys."""
    return quantum_params_to_raw(flax_from_state_dict(state_dict), model_type)
