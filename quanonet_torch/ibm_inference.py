"""
QPU deployment CLI of the port (counterpart of the repository's
ibm_inference.py; reference ibm_inference.py:121-312):

    python -m quanonet_torch.ibm_inference [--weight_path CKPT]
        [--simulator_only] [--export_dir DIR] [--export_points K]
        [--shots N] [--gate_error_2q E [--gate_error_1q E1]
        [--readout_error R] [--noise_traj T]]
        [--t1_us T1 --t2_us T2 --block_time_us B] [--job_id ID]
        [--device cuda|cpu]

Loads a trained QuanONet checkpoint (by default the shipped Antideriv Q2
anchor), folds the trainable-frequency affine map into concrete gate
angles, runs an ideal simulation on the port's engine (the reference uses
qiskit's StatevectorEstimator for this step), predicts the shot-noise and,
from calibration numbers, the decoherence floor of the planned job, then
self-verifies the exported gate sequences by replaying them gate by gate
(ibm_export.simulate_gate_list; exit 1 beyond 1e-4) and writes
circuit_point<k>.qasm and manifest.json to --export_dir.  With qiskit and
QISKIT_IBM_TOKEN present the real-QPU path (least-busy backend,
calibration-scored layout, EstimatorV2) runs; neither is needed otherwise.
Runs on ``cuda`` unless ``--device cpu`` is given.  fp32 throughout: the
port keeps TF32 matmuls off.
"""
import argparse
import json
import os
import sys

import numpy as np

from quanonet_torch import resolve_device
from quanonet_torch.checkpoint import load_raw
from quanonet_torch.ibm_export import (
    build_gate_list, fetch_ibm_job, ideal_predictions, noisy_predictions,
    qiskit_available, shot_predictions, simulate_gate_list,
    submission_manifest, submit_to_ibm, to_qasm2, unpack_quanonet_weights,
)
from quanonet_torch.infer import _parse_path, evaluate
from quanonet_torch.ops.hamiltonian import simple_ham_params

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "pretrained_weights/Antideriv/"
    "Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_1000x100_Seed0/"
    "best_model.npz")


def main(argv=None):
    p = argparse.ArgumentParser(description="QuanONet hardware deployment")
    p.add_argument('--weight_path', type=str, default=DEFAULT_WEIGHTS)
    p.add_argument('--simulator_only', action='store_true',
                   help="Skip real hardware even if a token is set.")
    p.add_argument('--input_func', type=str, choices=['cos', 'linear'],
                   default='cos')
    p.add_argument('--ham_bound', type=float, nargs=2, default=[-5.0, 5.0])
    p.add_argument('--job_id', type=str, default=None,
                   help="Fetch results from an existing IBM Quantum job "
                        "(reference ibm_inference.py:223-243; qiskit-gated)")
    # Manual architecture overrides (auto-parsed from path by default;
    # reference ibm_inference.py:134-152)
    p.add_argument('--num_qubits', type=int, default=None)
    p.add_argument('--n_branch', type=int, default=None)
    p.add_argument('--n_trunk', type=int, default=None)
    p.add_argument('--n_hidden', type=int, default=None)
    p.add_argument('--export_dir', type=str, default='ibm_export',
                   help="Where to write .qasm deployment artifacts")
    p.add_argument('--export_points', type=int, default=3,
                   help="Number of sample points to export as QASM")
    p.add_argument('--shots', type=int, default=10_000)
    p.add_argument('--gate_error_2q', type=float, default=None,
                   help="Calibration 2q gate error (e.g. from --profile / "
                        "backend properties): predicts the job's "
                        "decoherence floor via a Pauli-twirled "
                        "depolarizing channel (ops/noise.py) and its "
                        "ZNE-mitigated floor (ops/mitigation.py)")
    p.add_argument('--gate_error_1q', type=float, default=0.0)
    p.add_argument('--readout_error', type=float, default=0.0,
                   help="Per-qubit readout bit-flip prob for the noise "
                        "floor prediction")
    p.add_argument('--noise_traj', type=int, default=128)
    p.add_argument('--t1_us', type=float, default=None,
                   help="Calibration T1 (µs, from --profile): adds the "
                        "amplitude-damping channel to the noise-floor "
                        "prediction; needs --block_time_us")
    p.add_argument('--t2_us', type=float, default=None,
                   help="Calibration T2 (µs): adds pure dephasing; needs "
                        "--block_time_us")
    p.add_argument('--block_time_us', type=float, default=None,
                   help="Hardware wall-time per HEA block (µs) for the "
                        "T1/T2 -> per-block (γ, p_φ) conversion")
    p.add_argument('--device', type=str, default=None,
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if not os.path.exists(args.weight_path):
        print(f"Warning: weights {args.weight_path} not found.")
        return

    path_cfg = _parse_path(args.weight_path)
    net_size = list(path_cfg.get('net_size', [5, 1, 5, 1]))
    # CLI overrides, reference ibm_inference.py:149-152 (n_hidden sets
    # both branch and trunk hidden counts)
    if args.n_branch is not None:
        net_size[0] = args.n_branch
    if args.n_trunk is not None:
        net_size[2] = args.n_trunk
    if args.n_hidden is not None:
        net_size[1] = net_size[3] = args.n_hidden
    num_qubits = args.num_qubits or path_cfg.get('num_qubits', 2)
    print(f"-> Architecture: branch=({net_size[0]}x{net_size[1]}), "
          f"trunk=({net_size[2]}x{net_size[3]}), qubits={num_qubits}")

    ham_offset, ham_coeff = simple_ham_params(num_qubits, *args.ham_bound)
    raw = load_raw(args.weight_path)
    trunk_w, branch_w, coeffs, bias = unpack_quanonet_weights(
        raw, net_size, num_qubits)

    # input function (reference ibm_inference.py:176-189)
    num_points_0, num_points = 10, 100
    trunk_vec = np.linspace(0, 1, num_points)
    if args.input_func == 'cos':
        branch_vec = np.cos(np.pi * np.linspace(0, 1, num_points_0))
        true_solution = np.sin(np.pi * trunk_vec) / np.pi
    else:
        branch_vec = np.linspace(0, 1, num_points_0)
        true_solution = 0.5 * trunk_vec ** 2

    # ideal simulation on the TPU engine
    print(f"\n--- Running Ideal Simulation (port engine on {device}) ---")
    ideal_pred = ideal_predictions(raw, net_size, num_qubits, branch_vec,
                                   trunk_vec, ham_bound=args.ham_bound,
                                   device=device)
    m = evaluate(ideal_pred, true_solution)
    print(f"[Ideal] MSE: {m['mse']:.2e} | Relative L2: {m['rel_l2']:.2%}")

    # finite-shot emulation of the planned QPU job (ops/sampling.py):
    # predicts the shot-noise floor BEFORE spending hardware time
    sampled_pred, shot_std = shot_predictions(
        raw, net_size, num_qubits, branch_vec, trunk_vec,
        ham_bound=args.ham_bound, shots=args.shots, device=device)
    ms = evaluate(sampled_pred, true_solution)
    print(f"[Sampled @{args.shots} shots] MSE: {ms['mse']:.2e} | "
          f"Relative L2: {ms['rel_l2']:.2%} | "
          f"shot-noise std (mean over points): "
          f"{float(np.mean(shot_std)):.2e}")

    # decoherence-floor prediction from calibration numbers
    # (ops/noise.py + ops/mitigation.py): what the QPU job will score,
    # raw and ZNE-mitigated, before burning hardware time
    noise_floor = {}
    damp_gamma = dephase_p = None
    if args.t1_us is not None or args.t2_us is not None:
        if args.block_time_us is None:
            p.error("--t1_us/--t2_us need --block_time_us")
        from quanonet_torch.ops.noise import channel_params_from_t1t2
        g, pphi = channel_params_from_t1t2(
            args.block_time_us, args.t1_us or 1e12, args.t2_us or 1e12)
        damp_gamma = g if args.t1_us is not None else None
        dephase_p = pphi if args.t2_us is not None else None
        print(f"[T1/T2] block={args.block_time_us}us T1={args.t1_us}us "
              f"T2={args.t2_us}us -> damp_gamma={damp_gamma} "
              f"dephase_p={dephase_p}")
    if args.gate_error_2q is not None or damp_gamma is not None \
            or dephase_p is not None:
        from quanonet_torch.ops.hea import quanonet_spec
        from quanonet_torch.ops.noise import noise_p_from_calibration
        spec = quanonet_spec(num_qubits, tuple(net_size))
        noise_p = (noise_p_from_calibration(spec, args.gate_error_2q,
                                            args.gate_error_1q)
                   if args.gate_error_2q is not None else 0.0)
        noisy_pred = noisy_predictions(
            raw, net_size, num_qubits, branch_vec, trunk_vec, noise_p,
            ham_bound=args.ham_bound, readout_p=args.readout_error,
            n_traj=args.noise_traj, damp_gamma=damp_gamma,
            dephase_p=dephase_p, device=device)
        mn = evaluate(noisy_pred, true_solution)
        print(f"[Noise floor @2q_err={args.gate_error_2q or 0:g} -> "
              f"p={noise_p:.4g}/block] Relative L2: {mn['rel_l2']:.2%}")
        noise_floor = {
            'calibration_gate_error_2q': args.gate_error_2q,
            'calibration_gate_error_1q': args.gate_error_1q,
            'readout_error': args.readout_error,
            'depolarizing_p_per_block': noise_p,
            'noise_traj': args.noise_traj,
            'predicted_noisy_rel_l2': float(mn['rel_l2']),
        }
        if damp_gamma is not None or dephase_p is not None:
            noise_floor.update({
                'calibration_t1_us': args.t1_us,
                'calibration_t2_us': args.t2_us,
                'block_time_us': args.block_time_us,
                'damp_gamma_per_block': damp_gamma,
                'dephase_p_per_block': dephase_p,
            })
        # ZNE-mitigated floor: Richardson extrapolation applies to the
        # depolarizing channel only (scales noise_p), so it is predicted
        # for the gate-error component alone
        if noise_p and damp_gamma is None and dephase_p is None:
            zne_pred = noisy_predictions(
                raw, net_size, num_qubits, branch_vec, trunk_vec, noise_p,
                ham_bound=args.ham_bound, readout_p=args.readout_error,
                n_traj=args.noise_traj, zne_scales=(1.0, 2.0),
                device=device)
            mz = evaluate(zne_pred, true_solution)
            print(f"[Noise floor] ZNE(1,2)-mitigated: {mz['rel_l2']:.2%}")
            noise_floor['predicted_zne_rel_l2'] = float(mz['rel_l2'])

    # gate-level export + self-verification
    os.makedirs(args.export_dir, exist_ok=True)
    export_idx = np.linspace(0, num_points - 1, args.export_points,
                             dtype=int)
    max_dev = 0.0
    qasms, labels = [], []
    for k in export_idx:
        n_wires, ops = build_gate_list(branch_vec, [trunk_vec[k]],
                                       trunk_w, branch_w, coeffs)
        zsum = simulate_gate_list(n_wires, ops)
        gate_pred = zsum * ham_coeff + ham_offset + bias
        max_dev = max(max_dev, abs(gate_pred - ideal_pred[k]))
        qasm = to_qasm2(n_wires, ops)
        qasms.append(qasm)
        labels.append(f'circuit_point{k}.qasm (trunk={trunk_vec[k]:.6g})')
        qasm_path = os.path.join(args.export_dir, f'circuit_point{k}.qasm')
        with open(qasm_path, 'w') as f:
            f.write(qasm)
    print(f"-> Exported {len(export_idx)} QASM circuits to "
          f"{args.export_dir}/ (gate-level replay deviates "
          f"{max_dev:.2e} from the engine)")
    if max_dev > 1e-4:
        print("❌ Export self-verification FAILED")
        sys.exit(1)

    manifest = {
        'weight_path': args.weight_path,
        'net_size': net_size, 'num_qubits': num_qubits,
        'ham_offset': ham_offset, 'ham_coeff': ham_coeff, 'bias': bias,
        'post_processing': 'pred = evs * ham_coeff + ham_offset + bias',
        'observable': f'sum_i Z_i over {num_qubits} qubits',
        'shots': args.shots,
        'points': export_idx.tolist(),
        # predicted shot-noise floor of the planned job (ops/sampling.py)
        'expected_shot_noise_std_mean': float(np.mean(shot_std)),
        'sampled_rel_l2_at_shots': float(ms['rel_l2']),
        # predicted decoherence floor (--gate_error_2q; ops/noise.py)
        **noise_floor,
        # formal multi-pub hand-off: per-circuit QASM hashes + big-endian
        # observable terms + postprocess, exactly what submit_to_ibm
        # assembles live (ibm_export.submission_manifest)
        'submission': submission_manifest(
            qasms, num_qubits, tuple(args.ham_bound), shots=args.shots,
            bias=bias, labels=labels),
    }
    with open(os.path.join(args.export_dir, 'manifest.json'), 'w') as f:
        json.dump(manifest, f, indent=2)

    # real-QPU path (qiskit-gated)
    token = os.getenv("QISKIT_IBM_TOKEN")
    if args.job_id:
        # MODE: fetch existing job (reference ibm_inference.py:223-243)
        print(f"\n--- Fetching Existing Job: {args.job_id} ---")
        try:
            evs, name = fetch_ibm_job(args.job_id)
        except Exception as e:
            print(f"❌ Failed to fetch job: {e}")
            return
        if evs is None:
            print(f"⚠️ Job is currently {name}. Cannot fetch results yet.")
            return
        noisy = np.asarray(evs) * ham_coeff + ham_offset + bias
        m = evaluate(noisy, true_solution[export_idx])
        print(f"[IBM QPU ({name})] MSE: {m['mse']:.2e} | "
              f"Relative L2: {m['rel_l2']:.2%}")
        return
    if token and not args.simulator_only:
        if not qiskit_available():
            print("\nQISKIT_IBM_TOKEN set but qiskit is not installed; "
                  "submit the exported .qasm files from a qiskit-enabled "
                  "machine (see manifest.json for post-processing).")
            return
        qasms = [open(os.path.join(args.export_dir,
                                   f'circuit_point{k}.qasm')).read()
                 for k in export_idx]
        try:
            job, off, c = submit_to_ibm(qasms, num_qubits, args.ham_bound,
                                        shots=args.shots)
        except Exception as e:
            print(f"QPU submission failed ({e}); ideal results above stand.")
    else:
        print("\n(no QISKIT_IBM_TOKEN / --simulator_only: ideal-only run; "
              "QASM artifacts are the hardware hand-off)")


if __name__ == '__main__':
    main()
