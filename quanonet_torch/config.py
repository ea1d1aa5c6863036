"""
Config / flag system of the port's training CLI (the port's own copy of
quanonet_tpu/config.py).

Flag names, precedence (CLI > JSON > defaults) and default values are the
JAX package's, which keeps them contract-compatible with the reference
(utils/common.py:25-152).  argparse defaults are None so values present in
a JSON config are not clobbered by argparse-injected defaults.

The port adds ``--device``: ``cuda`` by default (raising without a card),
the CPU only when it is named.
"""
import argparse
import json
import os
import random

import numpy as np
import torch

# Built-in defaults (reference utils/common.py:123-141).
DEFAULTS = {
    'seed': 0,
    'device_target': 'CPU',          # accepted for CLI compat
    'num_train': 1000,
    'num_test': 1000,
    'batch_size': 100,
    'num_epochs': 1000,
    'learning_rate': 0.0001,
    'num_points': 100,
    'num_points_0': 100,
    'train_sample_num': 10,
    'test_sample_num': 100,
    'num_qubits': 5,
    'if_trainable_freq': 'true',
    'ham_bound': [-5, 5],
    'ham_pauli': 'Z',
    # Backend flags are accepted for script compat; every value routes to
    # the one engine.  'engine' selects the gate-application strategy.
    'quantum_backend': 'mindquantum',
    'classical_backend': 'pytorch',
    # 'auto' | 'dense' | 'gates' | 'pallas' | 'embed' | 'fused' | 'pfused'
    'engine': 'auto',
}


def get_base_parser():
    """argparse tree mirroring reference utils/common.py:25-95."""
    parser = argparse.ArgumentParser(
        description='QuanONet on the PyTorch/CUDA port / Operator Learning')

    # Core identity
    parser.add_argument('--operator', '-o', type=str, required=True,
                        help='Operator type (e.g., Antideriv, Darcy)')
    parser.add_argument('--model_type', '-m', type=str, required=True,
                        help='Model architecture: QuanONet, HEAQNN, '
                             'DeepONet, FNN or FNO')
    parser.add_argument('--config', '-c', type=str, default=None,
                        help='Path to JSON config file')

    # Environment & hardware
    parser.add_argument('--seed', '-s', type=int, default=None)
    parser.add_argument('--gpu', '-g', type=str, default=None,
                        help='Accepted for script compat; use --device')
    parser.add_argument('--prefix', '-p', type=str, default=None,
                        help='Output root directory prefix')
    parser.add_argument('--device_target', type=str, default=None,
                        choices=['CPU', 'GPU', 'Ascend', 'TPU'])
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default; raises without a card) or cpu')

    # Data configuration
    parser.add_argument('--num_train', type=int)
    parser.add_argument('--num_test', type=int)
    parser.add_argument('--num_points', type=int)
    parser.add_argument('--num_points_0', type=int)
    parser.add_argument('--train_sample_num', type=int, default=None)
    parser.add_argument('--test_sample_num', type=int, default=None)
    parser.add_argument('--num_cal', type=int, default=None)

    # Training hyperparameters
    parser.add_argument('--batch_size', type=int)
    parser.add_argument('--num_epochs', type=int)
    parser.add_argument('--learning_rate', type=float)

    # Model specific
    parser.add_argument('--net_size', type=int, nargs='+')
    parser.add_argument('--num_qubits', type=int, default=None)
    parser.add_argument('--scale_coeff', type=float)
    parser.add_argument('--if_trainable_freq', type=str, default=None)
    parser.add_argument('--ham_bound', type=float, nargs='+', default=None)
    parser.add_argument('--ham_pauli', type=str, default=None,
                        choices=['X', 'Y', 'Z'])
    parser.add_argument('--ham_diag', type=float, nargs='+', default=None)

    # Backend selection (accepted for compat; all resolve to one engine)
    parser.add_argument('--quantum_backend', type=str, default=None,
                        choices=['mindquantum', 'torchquantum', 'qiskit',
                                 'pennylane', 'jax'])
    parser.add_argument('--classical_backend', type=str, default=None,
                        choices=['pytorch', 'mindspore', 'jax'])

    parser.add_argument('--engine', type=str, default=None,
                        choices=['auto', 'dense', 'gates', 'fused', 'pallas',
                                 'embed', 'pfused'],
                        help='Gate-application strategy for the statevector '
                             'engine: pallas = the block-chain CUDA kernels '
                             '(up to 7 qubits), embed = the real-embedding '
                             'chain CUDA kernels (up to 7 qubits, opt-in), '
                             'pfused = the fused-group chain CUDA kernels '
                             '(8..16 qubits), fused = the grouped-kron '
                             'PyTorch engine; auto picks as the JAX package '
                             'does')
    parser.add_argument('--num_devices', type=int, default=None,
                        help='Devices for the data-parallel mesh (default: all)')
    parser.add_argument('--shard', type=str, default=None,
                        choices=['none', 'data', 'amp', 'pipe'],
                        help='Mesh-sharded training: data = batch data '
                             'parallelism (same as --num_devices alone); '
                             'amp = amplitude sharding, the 2^n state axis '
                             'splits across devices (Q12+ capacity); '
                             'pipe = pipeline parallelism over the block '
                             'chain (GPipe schedule)')
    parser.add_argument('--share_device', type=str, default=None,
                        help="'true' => every rank of --num_devices on "
                             "card 0, over gloo: checks the multi-GPU code "
                             "path on one card (no speed-up)")
    parser.add_argument('--n_microbatches', type=int, default=None,
                        help='--shard pipe: microbatches per batch '
                             '(default: the pipeline size); batch_size '
                             'must divide evenly by it')
    parser.add_argument('--multi_seed', type=int, nargs='+', default=None,
                        help='Train these seeds together as one packed '
                             'model (or one after another where the step '
                             'needs it: noise, shift/SPSA, shots), each in '
                             'its own experiment directory; completed seeds '
                             'are skipped')
    parser.add_argument('--multi_seed_fresh_data', type=str, default=None,
                        help="'true' => --multi_seed regenerates the "
                             'dataset for each seed (from its NumPy seed) '
                             'instead of sharing the cached one')
    parser.add_argument('--profile', type=str, default=None,
                        help='Write a torch.profiler trace of one training '
                             'segment to this directory')
    parser.add_argument('--noise_p', type=float, default=None,
                        help='Noise-aware training: per-qubit per-block '
                             'depolarizing error prob simulated by '
                             'Pauli-twirled trajectories (ops/noise.py); '
                             'the run ID gains a _Noise suffix')
    parser.add_argument('--noise_traj', type=int, default=None,
                        help='Noise trajectories per forward (default 8 '
                             'in training, 32 in inference)')
    parser.add_argument('--readout_p', type=float, default=None,
                        help='Per-qubit measurement bit-flip prob, applied '
                             'exactly inside the noisy forward')
    parser.add_argument('--damp_gamma', type=float, default=None,
                        help='Per-block T1 amplitude-damping γ for '
                             'noise-aware training (quantum-jump '
                             'trajectories, ops/noise.py); run ID gains a G '
                             'suffix')
    parser.add_argument('--dephase_p', type=float, default=None,
                        help='Per-block T2 pure-dephasing Z-flip prob; '
                             'run ID gains an F suffix')
    parser.add_argument('--grad_method', type=str, default=None,
                        choices=['autodiff', 'shift', 'spsa'],
                        help='Gradient source: autodiff (default), shift '
                             '(the parameter-shift rule from circuit '
                             'evaluations alone) or spsa (two perturbed '
                             'loss evaluations a step)')
    parser.add_argument('--train_shots', type=int, default=None,
                        help='Finite-shot measurement in the training loss '
                             'and the evaluation; needs --grad_method shift '
                             'or spsa')
    parser.add_argument('--ps_chunk', type=int, default=None,
                        help='Shift indices evaluated at once by '
                             '--grad_method shift (bounds its memory)')
    parser.add_argument('--spsa_c', type=float, default=None,
                        help='SPSA perturbation size (default 0.05)')
    parser.add_argument('--save_state', type=str, default=None,
                        help="'true' => snapshot (epoch, params, optimizer "
                             'state, best) to train_state.npz at every '
                             'segment boundary; a killed run restarted with '
                             'the same config resumes bit-identically from '
                             'the last boundary')
    parser.add_argument('--datagen', type=str, default=None,
                        choices=['host', 'device', 'native'],
                        help='Raw data generator: host = reference '
                             'NumPy/SciPy (default), device = on the card '
                             '(GRF + RK4 + stencils + CG in PyTorch), '
                             'native = the C++ solvers of native/ built at '
                             'first use; the last two cache under their own '
                             'names')
    return parser


def load_config(args):
    """Merge CLI > JSON > defaults (reference utils/common.py:97-152)."""
    config = {}
    if getattr(args, 'config', None) and os.path.exists(args.config):
        with open(args.config, 'r') as f:
            config = json.load(f)
        print(f"Loaded configuration from {args.config}")

    for key, value in vars(args).items():
        if value is not None:
            config[key] = value

    for key, default_val in DEFAULTS.items():
        if key not in config:
            config[key] = default_val

    if 'operator' not in config:
        config['operator'] = args.operator
    if 'model_type' not in config:
        config['model_type'] = args.model_type
    return config


def parse_bool(v) -> bool:
    """Reference convention: booleans arrive as strings 'true'/'false'."""
    return str(v).lower() == 'true'


def set_random_seed(seed):
    """Seed the host RNGs (NumPy drives data generation, as in the
    reference utils/common.py:154-181) and torch's."""
    if seed is None:
        return
    print(f"Setting random seed: {seed}")
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
