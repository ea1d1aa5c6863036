"""
Weights carried across between the JAX package and the port.

* ``state_dict_from_flax(tree)``: the JAX package's ``{'params': {...}}``
  (as NumPy arrays) -> the port's ``state_dict``; ``flax_from_state_dict``
  is its inverse.
* ``state_dict_from_raw(raw, ...)``: the same from reference checkpoint
  keys (quanonet_torch/checkpoint.py); ``raw_from_state_dict`` is its
  inverse.

* ``classical_state_dict_from_flax(tree)`` / ``flax_from_classical_state_dict``:
  the same for FNN, DeepONet and FNO, whose trees nest deeper
  (``branch/dense_0/kernel``) and whose dense kernels are transposed: a
  flax ``Dense`` kernel is (in, out), ``nn.Linear.weight`` (out, in).

* ``adam_state_from_flax(count, mu, nu, names)``: an optax-Adam or JAX
  ``FusedAdam`` state -> the ``state_dict`` of the port's
  ``ops/cuda_adam.FusedAdam``.

A nested key ``branch_freq/weights`` of the tree is ``branch_freq.weights``
in the state_dict; top-level leaves (``ansatz``, ``bias``) keep their names.
"""
import numpy as np
import torch

from quanonet_torch.checkpoint import (
    flatten_tree, quantum_params_from_raw, quantum_params_to_raw,
    unflatten_tree,
)

QUANTUM_MODELS = ('QuanONet', 'HEAQNN')


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


def classical_state_dict_from_flax(tree) -> dict:
    """A classical model's {'params': ...} tree (or its flat
    {'a.b.kernel': array} form, the classical checkpoint's keys) -> the
    port's state_dict: ``x.kernel`` (in, out) becomes ``x.weight``
    (out, in); every other leaf (dense biases, DeepONet's 0-d ``bias``,
    ``conv_i.w_re/w_im``) keeps its name and shape."""
    sd = {}
    for key, value in flatten_tree(tree).items():
        arr = np.array(value, dtype=np.float32)
        head, _, leaf = key.rpartition('.')
        if leaf == 'kernel':
            key, arr = f'{head}.weight', arr.T.copy()
        sd[key] = torch.tensor(arr)
    return sd


def flax_from_classical_state_dict(state_dict) -> dict:
    """Inverse of :func:`classical_state_dict_from_flax` (NumPy leaves)."""
    raw = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy().astype(np.float32)
        head, _, leaf = key.rpartition('.')
        if leaf == 'weight':
            key, arr = f'{head}.kernel', arr.T.copy()
        raw[key] = arr
    return unflatten_tree(raw)


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
    """Checkpoint keys -> the port's state_dict: the reference's keys for
    the quantum models, the flattened flax tree for the classical ones."""
    if model_type not in QUANTUM_MODELS:
        return classical_state_dict_from_flax(raw)
    return state_dict_from_flax(quantum_params_from_raw(
        raw, model_type, tuple(net_size), int(num_qubits),
        bool(if_trainable_freq)))


def raw_from_state_dict(state_dict, model_type) -> dict:
    """The port's state_dict -> checkpoint keys (see
    :func:`state_dict_from_raw`)."""
    if model_type not in QUANTUM_MODELS:
        return flatten_tree(flax_from_classical_state_dict(state_dict))
    return quantum_params_to_raw(flax_from_state_dict(state_dict), model_type)
