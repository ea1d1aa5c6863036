"""
Standalone inference for QuanONet / HEAQNN / DeepONet / FNN / FNO on the
port (counterpart of quanonet_tpu/infer.py).

Hyper-parameters are parsed from the experiment-ID directory name of the
checkpoint, with keyword/CLI overrides; both checkpoint formats (.npz and
MindSpore .ckpt) load.  Runs on ``cuda`` unless ``device='cpu'`` is asked
for.  Without --data or --branch the CLI generates the test set that the
checkpoint's name describes (:func:`generate_test_data`).  With --shots
each prediction is estimated from that many sampled shots
(ops/sampling.py), replayable from --shot_seed.  With --noise_p,
--readout_p, --damp_gamma, --dephase_p (or --t1_us/--t2_us with
--block_time_us) each prediction is the mean over --noise_traj noise
trajectories (ops/noise.py), and with --zne it is zero-noise
extrapolated (ops/mitigation.py); a ``_Noise`` checkpoint name loads
under its channel.

CLI:  python -m quanonet_torch.infer --ckpt <best_model.ckpt|.npz>
          [--data <file.npz> | --branch <b.npy> [--trunk <t.npy>]]
          [--num_points_0 P] [--shots N] [--shot_seed S]
          [--noise_p P [--noise_traj T] [--zne C1 C2 ...]] [--readout_p R]
          [--t1_us T1 --t2_us T2 --block_time_us B]
          [--damp_gamma G] [--dephase_p F]
          [--output preds.npy] [--device cuda|cpu]
"""
import argparse
import copy
import os
import re

import numpy as np
import torch

from quanonet_torch import checkpoint as ckpt_io
from quanonet_torch import resolve_device
from quanonet_torch.convert import state_dict_from_raw
from quanonet_torch.metrics import compute_metrics, rel_l2
from quanonet_torch.ops.mitigation import richardson_weights
from quanonet_torch.ops.noise import channel_params_from_t1t2
from quanonet_torch.ops.sampling import key_generator

_NET_RE = re.compile(r'Net(\d+)-(\d+)-(\d+)-(\d+)')
_NET2_RE = re.compile(r'Net(\d+)-(\d+)(?:[^-]|$)')
_Q_RE = re.compile(r'_Q(\d+)')
_S_RE = re.compile(r'_S([\d.]+)')
_TF_RE = re.compile(r'_(TF|FF|NTF)_')
_MODEL_RE = re.compile(r'_(QuanONet|HEAQNN|DeepONet|FNN|FNO)_')
_QB_RE = re.compile(r'_(TQ|Qiskit|PL|torchquantum|qiskit|pennylane)_')
_QB_MAP = {'TQ': 'torchquantum', 'Qiskit': 'qiskit', 'PL': 'pennylane'}
_DATA_RE = re.compile(r'_(\d+)x(\d+)_Seed')
# Hamiltonian-ablation suffixes of the experiment ID
_PAULI_RE = re.compile(r'_Pauli([XYZ])')
_DIAG_RE = re.compile(r'_Diag([^_]+)')
_HAM_RE = re.compile(r'_Ham([^_]+)')
# noise-aware-training suffix _Noise{p}[R{readout_p}][G{damp_gamma}][F{dephase_p}]
_NOISE_RE = re.compile(r'_Noise([0-9.eE+-]+?)(?:R([0-9.eE+-]+?))?'
                       r'(?:G([0-9.eE+-]+?))?(?:F([0-9.eE+-]+))?(?=_|$)')
_NUM_RE = re.compile(r'-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?')
# _Shift[Sh{N}] / _Spsa[C{c}][Sh{N}]: recorded for provenance only; the
# inference forward is the same ideal circuit
_GRAD_RE = re.compile(r'_(Shift|Spsa)(?:C([0-9.eE+-]+?))?(?:Sh(\d+))?'
                      r'(?=_|$)')

QUANTUM_MODELS = ('QuanONet', 'HEAQNN')


def _parse_joined_floats(s):
    """Parse ``"-".join(map(str, values))`` where a value may itself be
    negative: ``[1, -1]`` encodes as ``"1--1"`` and ``[-3, 3]`` as
    ``"-3-3"``.  Returns None if the string does not parse."""
    vals, i = [], 0
    while i < len(s):
        m = _NUM_RE.match(s, i)
        if not m:
            return None
        vals.append(float(m.group(0)))
        i = m.end()
        if i < len(s):
            if s[i] != '-':
                return None
            i += 1
    return vals or None


_DEFAULTS = {
    'model_type': 'QuanONet',
    'num_qubits': 5,
    'net_size': [40, 2, 20, 2],
    # the reference's infer defaults scale_coeff to 0.1 (its solvers to
    # 0.01); the infer-side value is kept for CLI parity
    'scale_coeff': 0.1,
    'if_trainable_freq': True,
    'ham_bound': [-5.0, 5.0],
    'ham_diag': None,
    'ham_pauli': 'Z',
    'quantum_backend': 'jax',
    'batch_size': 128,
}


def _parse_path(ckpt_path: str) -> dict:
    """Hyper-parameters encoded in the checkpoint's directory name."""
    name = os.path.basename(os.path.dirname(os.path.abspath(ckpt_path)))
    cfg = {}
    m = _MODEL_RE.search(name)
    if m:
        cfg['model_type'] = m.group(1)
    m = _NET_RE.search(name)
    if m:
        cfg['net_size'] = [int(m.group(i)) for i in range(1, 5)]
    else:
        m = _NET2_RE.search(name)
        if m:
            cfg['net_size'] = [int(m.group(1)), int(m.group(2))]
    m = _Q_RE.search(name)
    if m:
        cfg['num_qubits'] = int(m.group(1))
    m = _S_RE.search(name)
    if m:
        cfg['scale_coeff'] = float(m.group(1))
    m = _TF_RE.search(name)
    if m:
        cfg['if_trainable_freq'] = (m.group(1) == 'TF')
    m = _QB_RE.search(name)
    if m:
        cfg['quantum_backend'] = _QB_MAP.get(m.group(1), m.group(1))
    m = _PAULI_RE.search(name)
    if m:
        cfg['ham_pauli'] = m.group(1)
    m = _DIAG_RE.search(name)
    if m:
        diag = _parse_joined_floats(m.group(1))
        if diag:
            cfg['ham_diag'] = diag
    else:
        m = _HAM_RE.search(name)
        if m:
            bound = _parse_joined_floats(m.group(1))
            if bound and len(bound) == 2:
                cfg['ham_bound'] = bound
    m = _NOISE_RE.search(name)
    if m:
        try:
            p = float(m.group(1))
            cfg['noise_p'] = p if p > 0 else None
            if m.group(2):
                cfg['readout_p'] = float(m.group(2))
            if m.group(3):
                cfg['damp_gamma'] = float(m.group(3))
            if m.group(4):
                cfg['dephase_p'] = float(m.group(4))
        except ValueError:
            pass
    m = _GRAD_RE.search(name)
    if m:
        cfg['grad_method'] = m.group(1).lower()
        if m.group(2):
            cfg['spsa_c'] = float(m.group(2))
        if m.group(3):
            cfg['train_shots'] = int(m.group(3))
    return cfg


def _resolve_config(ckpt_path: str, overrides: dict) -> dict:
    cfg = {**_DEFAULTS, **_parse_path(ckpt_path)}
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    return cfg


def _build_model(cfg: dict, branch_in: int, trunk_in: int, device):
    from quanonet_torch.models import (
        FNN, FNO, DeepONet, HEAQNN, QuanONet, deeponet_layer_sizes,
        fno_sizes,
    )
    from quanonet_torch.ops.hea import resolve_inference_engine

    mt = cfg['model_type']
    net_size = list(cfg['net_size'])
    if mt == 'DeepONet':
        bl, tl = deeponet_layer_sizes(net_size, branch_in, trunk_in)
        return DeepONet(branch_in, trunk_in, bl, tl, device=device)
    if mt == 'FNN':
        # the FNN's one input is the concatenation [branch | trunk]
        return FNN(branch_in + trunk_in, net_size, device=device)
    if mt == 'FNO':
        return FNO(branch_in, **fno_sizes(net_size), device=device)
    if mt not in QUANTUM_MODELS:
        raise ValueError(f"Unknown model_type: {mt}")
    # --noise_p 0 with no readout error is the ideal model: the exact path,
    # not a 0-probability trajectory ensemble
    if cfg.get('noise_p') is not None and float(cfg['noise_p']) == 0.0 \
            and not cfg.get('readout_p'):
        cfg = {**cfg, 'noise_p': None}
    nq = int(cfg['num_qubits'])
    kw = dict(num_qubits=nq,
              engine=resolve_inference_engine(cfg.get('engine') or 'auto',
                                              nq, device),
              net_size=tuple(cfg['net_size']),
              scale_coeff=float(cfg['scale_coeff']),
              if_trainable_freq=bool(cfg['if_trainable_freq']),
              ham_bound=tuple(cfg['ham_bound']),
              ham_diag=(tuple(cfg['ham_diag'])
                        if cfg.get('ham_diag') is not None else None),
              ham_pauli=cfg.get('ham_pauli', 'Z'),
              shots=int(cfg['shots']) if cfg.get('shots') else None,
              noise_p=(float(cfg['noise_p'])
                       if cfg.get('noise_p') is not None else None),
              noise_traj=int(cfg.get('noise_traj') or 32),
              readout_p=float(cfg.get('readout_p') or 0.0),
              zne_scales=cfg.get('zne_scales'),
              damp_gamma=(float(cfg['damp_gamma'])
                          if cfg.get('damp_gamma') else None),
              dephase_p=(float(cfg['dephase_p'])
                         if cfg.get('dephase_p') else None),
              device=device)
    if mt == 'QuanONet':
        return QuanONet(branch_input_size=branch_in,
                        trunk_input_size=trunk_in, **kw)
    return HEAQNN(input_size=branch_in, **kw)


def load_model(ckpt_path: str, branch_in: int, trunk_in: int = 0,
               device=None, **overrides):
    """Load a checkpoint (.ckpt / .npz) of any model type onto ``device``
    (default ``cuda``; raises without a card unless ``device='cpu'``).

    Returns (model, cfg); run inference with
    ``predict(model, branch, trunk, cfg=cfg)``.
    """
    device = resolve_device(device)
    cfg = _resolve_config(ckpt_path, overrides)
    model = _build_model(cfg, branch_in, trunk_in, device)
    raw = ckpt_io.load_raw(ckpt_path)
    model.load_state_dict(state_dict_from_raw(
        raw, cfg['model_type'], cfg['net_size'], cfg['num_qubits'],
        cfg['if_trainable_freq']))
    model.eval()
    cfg['_backend'] = 'torch'
    cfg['engine'] = getattr(model, 'engine', None)
    cfg['device'] = str(device)
    return model, cfg


def predict(model, branch_input, trunk_input=None, cfg=None,
            batch_size=None, shot_seed=0):
    """Batched inference: QuanONet and DeepONet take (branch, trunk), FNN
    their concatenation, HEAQNN branch only, FNO the grid tensor.  Returns
    a NumPy array, (n, 1) for all but FNO's (n, points, 1).

    A model loaded with ``shots`` or a noise channel predicts from sampled
    shots and trajectories: the batch at row offset s draws from a
    generator seeded from (shot_seed, s), so the predictions replay for
    equal arguments."""
    if batch_size is None:
        batch_size = 20000
    model_type = (cfg or {}).get('model_type', 'QuanONet')
    two_input = trunk_input is not None and \
        model_type in ('QuanONet', 'DeepONet')
    concat = trunk_input is not None and model_type == 'FNN'
    device = next(model.parameters()).device
    sampled = bool(getattr(model, 'sampled', False))
    n = branch_input.shape[0]
    preds = []
    with torch.inference_mode():
        for s in range(0, n, batch_size):
            kw = ({'generator': key_generator(shot_seed, s, device=device)}
                  if sampled else {})
            b = torch.as_tensor(
                np.asarray(branch_input[s:s + batch_size], np.float32),
                device=device)
            if two_input or concat:
                t = torch.as_tensor(
                    np.asarray(trunk_input[s:s + batch_size], np.float32),
                    device=device)
                out = model(torch.cat([b, t], dim=1)) if concat \
                    else model(b, t, **kw)
            else:
                out = model(b, **kw)
            preds.append(out.cpu().numpy())
    return np.concatenate(preds, axis=0)


def zne_predict(model, branch_input, trunk_input=None, cfg=None,
                scales=(1.0, 2.0), batch_size=None, shot_seed=0):
    """Zero-noise-extrapolated predictions (ops/mitigation.py): every
    trajectory evaluates all amplified noise levels ``c·noise_p`` on one
    shared error draw (common random numbers), Richardson-extrapolated to
    c = 0.  The model must have ``noise_p`` set; equal arguments replay bit
    for bit.  ``model`` itself is left as it was."""
    p = getattr(model, 'measure', None) and model.measure.noise_p
    if not p:
        raise ValueError("zne_predict needs a model with noise_p > 0 "
                         "(nothing to extrapolate)")
    richardson_weights(scales)           # validate the scales up front
    m = copy.deepcopy(model)
    m.measure.shots = None
    ms = m.measure
    ms.configure(ms.noise_p, ms.noise_traj, ms.readout_p,
                 tuple(float(c) for c in scales), ms.damp_gamma,
                 ms.dephase_p)
    return predict(m, branch_input, trunk_input, cfg=cfg,
                   batch_size=batch_size, shot_seed=shot_seed)


def evaluate(y_pred, y_true):
    """Rel-L2 / MSE / MAE."""
    m = compute_metrics(y_true, y_pred)
    return {'rel_l2': rel_l2(y_true, y_pred),
            'mse': m['MSE'], 'mae': m['MAE']}


# ── CLI ───────────────────────────────────────────────────────────────────────

def generate_test_data(ckpt_path, num_points_0=None):
    """The test set that the checkpoint directory's name describes
    (operator, model type, ``{num_train}x{num_points}``), from the host
    DataManager under the global NumPy seed, as the JAX package's infer
    CLI builds it: 1000 test functions, and for the quantum models
    num_points_0 = min(points, qubits × branch depth) unless given.
    Returns (branch, trunk or None, test_output)."""
    from quanonet_torch.data.manager import DataManager

    dir_name = os.path.basename(os.path.dirname(os.path.abspath(ckpt_path)))
    m_op = _MODEL_RE.search(dir_name)
    m_data = _DATA_RE.search(dir_name)
    operator = dir_name.split('_')[0] if dir_name else None
    if not operator or not m_op:
        raise SystemExit("Provide --data <file.npz> or --branch <file.npy>.")
    num_train = int(m_data.group(1)) if m_data else 1000
    num_points = int(m_data.group(2)) if m_data else 100
    model_type = m_op.group(1)
    if model_type in QUANTUM_MODELS:
        cfg = _resolve_config(ckpt_path, {})
        inferred = min(num_points,
                       int(cfg['num_qubits']) * int(cfg['net_size'][0]))
    else:
        inferred = num_points
    data_cfg = {
        'operator': operator, 'model_type': model_type,
        'num_train': num_train, 'num_test': 1000, 'num_points': num_points,
        'num_points_0': (num_points_0 if num_points_0 is not None
                         else inferred),
        'train_sample_num': 10, 'test_sample_num': 100,
    }
    print(f"[Auto] Generating test data for {operator} "
          f"(num_points={num_points}, "
          f"num_points_0={data_cfg['num_points_0']}) ...")
    data = DataManager(data_cfg).get_data()
    branch = (data['test_branch_input'] if 'test_branch_input' in data
              else data['test_input'])
    return branch, data.get('test_trunk_input'), data.get('test_output')


def _parser():
    p = argparse.ArgumentParser(
        description='QuanONet inference on the PyTorch/CUDA port',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument('--ckpt', required=True,
                   help='Checkpoint path (.ckpt / .npz)')
    p.add_argument('--data', default=None,
                   help='.npz with test_branch_input / test_trunk_input '
                        '/ test_output')
    p.add_argument('--branch', default=None,
                   help='Branch input .npy (alternative to --data)')
    p.add_argument('--trunk', default=None, help='Trunk input .npy')
    p.add_argument('--num_points_0', type=int, default=None,
                   help='Branch points of the data generated from the '
                        'checkpoint name (default min(points, qubits x '
                        'branch depth) for the quantum models)')
    p.add_argument('--output', default=None,
                   help='Save predictions to .npy or .npz')
    p.add_argument('--batch_size', type=int, default=None,
                   help='Inference batch (default 20000)')
    p.add_argument('--device', default=None,
                   help='cuda (default) or cpu')
    p.add_argument('--model_type', default=None)
    p.add_argument('--num_qubits', type=int, default=None)
    p.add_argument('--net_size', type=int, nargs='+', default=None)
    p.add_argument('--scale_coeff', type=float, default=None)
    p.add_argument('--quantum_backend', default=None,
                   choices=['mindquantum', 'torchquantum', 'qiskit',
                            'pennylane', 'jax'],
                   help='CLI-compat override; every backend maps onto the '
                        'one engine here, so this only annotates the config')
    p.add_argument('--ham_bound', type=float, nargs=2, default=None)
    p.add_argument('--shots', type=int, default=None,
                   help='Finite-shot measurement sampling (QPU emulation): '
                        'estimate each prediction from N sampled shots '
                        'instead of the exact expectation')
    p.add_argument('--shot_seed', type=int, default=0,
                   help='Seed of the --shots sampling (replayable)')
    p.add_argument('--noise_p', type=float, default=None,
                   help='Per-qubit per-block depolarizing error prob '
                        '(Pauli-twirled trajectory simulation, '
                        'ops/noise.py); combine with --shots for the full '
                        'QPU error budget')
    p.add_argument('--noise_traj', type=int, default=None,
                   help='Noise trajectories to average (default 32)')
    p.add_argument('--readout_p', type=float, default=None,
                   help='Per-qubit measurement bit-flip prob, applied '
                        'exactly (no sampling)')
    p.add_argument('--zne', type=float, nargs='+', default=None,
                   metavar='SCALE',
                   help='Zero-noise extrapolation (ops/mitigation.py): '
                        'evaluate at these noise scale factors and '
                        'Richardson-extrapolate the predictions to zero '
                        'noise; requires --noise_p or a _Noise checkpoint')
    p.add_argument('--t1_us', type=float, default=None,
                   help='Calibration T1 (µs): adds the amplitude-damping '
                        '(quantum-jump) channel per block; needs '
                        '--block_time_us')
    p.add_argument('--t2_us', type=float, default=None,
                   help='Calibration T2 (µs): adds the pure-dephasing '
                        '(Z-twirl) channel per block; needs --block_time_us')
    p.add_argument('--block_time_us', type=float, default=None,
                   help='Hardware wall-time one HEA block occupies (µs); '
                        'converts --t1_us/--t2_us to per-block (γ, p_φ) '
                        'via ops.noise.channel_params_from_t1t2')
    p.add_argument('--damp_gamma', type=float, default=None,
                   help='Directly set the per-block amplitude-damping γ '
                        '(overrides --t1_us)')
    p.add_argument('--dephase_p', type=float, default=None,
                   help='Directly set the per-block pure-dephasing Z-flip '
                        'prob (overrides --t2_us)')
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    y_true = None
    if args.data:
        d = np.load(args.data)
        branch = d['test_branch_input'] if 'test_branch_input' in d.files \
            else d['test_input']
        trunk = d['test_trunk_input'] if 'test_trunk_input' in d.files \
            else None
        if 'test_output' in d.files:
            y_true = d['test_output']
    elif args.branch:
        branch = np.load(args.branch)
        trunk = np.load(args.trunk) if args.trunk else None
    else:
        branch, trunk, y_true = generate_test_data(args.ckpt,
                                                   args.num_points_0)

    branch_in = branch.shape[-1] if branch.ndim == 3 else branch.shape[1]
    trunk_in = trunk.shape[1] if trunk is not None else 0

    # T1/T2 decoherence: --t1_us/--t2_us with --block_time_us map
    # calibration times to per-block channel strengths; --damp_gamma and
    # --dephase_p set them directly
    damp_gamma, dephase_p = args.damp_gamma, args.dephase_p
    if args.t1_us is not None or args.t2_us is not None:
        if args.block_time_us is None:
            raise SystemExit("--t1_us/--t2_us need --block_time_us")
        g, pphi = channel_params_from_t1t2(
            args.block_time_us, args.t1_us or 1e12, args.t2_us or 1e12)
        if damp_gamma is None and args.t1_us is not None:
            damp_gamma = g
        if dephase_p is None and args.t2_us is not None:
            dephase_p = pphi
        print(f"T1/T2 : block={args.block_time_us}us "
              f"T1={args.t1_us}us T2={args.t2_us}us -> "
              f"damp_gamma={damp_gamma} dephase_p={dephase_p}")

    overrides = dict(model_type=args.model_type, num_qubits=args.num_qubits,
                     net_size=args.net_size, scale_coeff=args.scale_coeff,
                     ham_bound=args.ham_bound,
                     quantum_backend=args.quantum_backend,
                     shots=args.shots, noise_p=args.noise_p,
                     noise_traj=args.noise_traj, readout_p=args.readout_p,
                     damp_gamma=damp_gamma, dephase_p=dephase_p)
    model, cfg = load_model(args.ckpt, branch_in=branch_in,
                            trunk_in=trunk_in, device=args.device,
                            **overrides)
    print(f"Model : {cfg['model_type']}  backend={cfg['_backend']}  "
          f"engine={cfg['engine']}  device={cfg['device']}")
    print(f"Config: net_size={cfg['net_size']}  "
          f"num_qubits={cfg.get('num_qubits', '-')}")
    if cfg.get('shots'):
        print(f"Shots : {cfg['shots']} per prediction "
              f"(sampled measurement, seed={args.shot_seed})")
    if cfg.get('noise_p') is not None or cfg.get('readout_p'):
        print(f"Noise : depolarizing p={cfg.get('noise_p') or 0} over "
              f"{cfg.get('noise_traj') or 32} trajectories, "
              f"readout_p={cfg.get('readout_p') or 0} "
              f"(seed={args.shot_seed})")

    if args.zne:
        print(f"ZNE   : Richardson extrapolation over noise scales "
              f"{args.zne}")
        preds = zne_predict(model, branch, trunk, cfg=cfg,
                            scales=tuple(args.zne),
                            batch_size=args.batch_size,
                            shot_seed=args.shot_seed)
    else:
        preds = predict(model, branch, trunk, cfg=cfg,
                        batch_size=args.batch_size,
                        shot_seed=args.shot_seed)
    print(f"Output: {preds.shape}")

    if y_true is not None:
        m = evaluate(preds, y_true)
        print(f"Rel-L2 : {m['rel_l2']:.4f}  ({m['rel_l2']:.2%})")
        print(f"MSE    : {m['mse']:.6f}")
        print(f"MAE    : {m['mae']:.6f}")

    if args.output:
        if args.output.endswith('.npz'):
            np.savez(args.output, predictions=preds,
                     **(evaluate(preds, y_true) if y_true is not None else {}))
        else:
            np.save(args.output, preds)
        print(f"Saved  : {args.output}")
    return preds


if __name__ == '__main__':
    main()
