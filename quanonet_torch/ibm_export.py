"""
The QPU deployment path of the port (counterpart of
quanonet_tpu/ibm_export.py; reference ibm_inference.py:1-312): a trained
QuanONet checkpoint becomes concrete gate lists, OpenQASM 2.0 text and a
submission manifest, with the predictions a QPU job should reproduce.
Built without qiskit:

* ``build_gate_list``, ``to_qasm2``, ``hamiltonian_pauli_terms``,
  ``submission_manifest`` (and ``unpack_quanonet_weights``): NumPy, the
  JAX package's code, so both packages write the same bytes;
* ``final_state`` / ``simulate_gate_list`` / ``pauli_term_expectations``
  replay a gate list gate by gate through the port's gate-level code
  (ops/hea.py) in float64 on the host: the export self-verifies against
  the engine's prediction;
* ``ideal_predictions``, ``shot_predictions`` and ``noisy_predictions``
  build the port's QuanONet from the raw checkpoint and run it on the
  port's engine (on ``cuda`` the compile kernel B4f and the chain kernel
  B1f; the noisy path takes ops/noise.noise_route's route);
* the qiskit-gated extras (calibration-scored qubit routing, EstimatorV2
  submission, job fetch) run only where qiskit is installed and raise
  ImportError otherwise.

``trunk_points`` may be (n,) (one trunk coordinate a point, as the
reference's Antideriv export) or (n, k) (k coordinates a point, e.g. the
(x, t) of Advection).
"""
import hashlib

import numpy as np
import torch

from quanonet_torch import resolve_device
from quanonet_torch.ops.hamiltonian import (
    simple_ham_params, walsh_hadamard_coeffs,
)


def unpack_quanonet_weights(raw, net_size, num_qubits):
    """Flat checkpoint -> per-layer structures (reference
    ibm_inference.py:159-173: trunk-first flat order)."""
    n_branch_layers, n_branch_hidden, n_trunk_layers, n_trunk_hidden = net_size
    w = np.asarray(raw['QuanONet.weight'], np.float64)
    trunk_count = n_trunk_layers * n_trunk_hidden * 3 * num_qubits
    branch_count = n_branch_layers * n_branch_hidden * 3 * num_qubits
    trunk_weights = w[:trunk_count].reshape(
        n_trunk_layers, n_trunk_hidden, 3, num_qubits)
    branch_weights = w[trunk_count:trunk_count + branch_count].reshape(
        n_branch_layers, n_branch_hidden, 3, num_qubits)
    t_w = np.asarray(raw['trunk_LinearLayer.Net2.weights']).reshape(
        n_trunk_layers, num_qubits)
    t_b = np.asarray(raw['trunk_LinearLayer.Net2.bias']).reshape(
        n_trunk_layers, num_qubits)
    b_w = np.asarray(raw['branch_LinearLayer.Net2.weights']).reshape(
        n_branch_layers, num_qubits)
    b_b = np.asarray(raw['branch_LinearLayer.Net2.bias']).reshape(
        n_branch_layers, num_qubits)
    coefficients = np.stack([np.concatenate([t_w, b_w], axis=0),
                             np.concatenate([t_b, b_b], axis=0)], axis=1)
    bias = float(np.asarray(raw['bias']).reshape(()))
    return trunk_weights, branch_weights, coefficients, bias


def build_gate_list(branch_inputs, trunk_inputs, trunk_weights,
                    branch_weights, coefficients):
    """Fully-resolved gate ops for one sample.

    Returns (n_wires, ops) with ops = [('rx'|'ry'|'rz', qubit, angle) or
    ('cx', control, target)].  Mirrors reference create_circuit:21-59:
    cyclic feature tiling per layer, affine fold angle = x*w + b, ansatz
    RY/RZ/RY + CNOT ring control=(i+1)%n -> target=i.
    """
    branch_inputs = np.asarray(branch_inputs, np.float64)
    trunk_inputs = np.asarray(trunk_inputs, np.float64)
    n_trunk_layers, n_trunk_hidden = trunk_weights.shape[:2]
    n_branch_layers, n_branch_hidden = branch_weights.shape[:2]
    n = trunk_weights.shape[-1]
    branch_size, trunk_size = len(branch_inputs), len(trunk_inputs)
    ops = []

    def entangle():
        for i in range(n):
            ops.append(('cx', (i + 1) % n, i))

    def ansatz(wl):
        for j in range(n):
            ops.append(('ry', j, float(wl[0][j])))
            ops.append(('rz', j, float(wl[1][j])))
            ops.append(('ry', j, float(wl[2][j])))

    def encode(coeffs, feats):
        for j in range(n):
            angle = feats[j] * float(coeffs[0][j]) + float(coeffs[1][j])
            ops.append(('rx', j, float(angle)))

    for i in range(n_trunk_layers):
        feats = [trunk_inputs[(i * n % trunk_size + j) % trunk_size]
                 for j in range(n)]
        encode(coefficients[i], feats)
        for h in range(n_trunk_hidden):
            ansatz(trunk_weights[i][h])
            entangle()
    for i in range(n_branch_layers):
        feats = [branch_inputs[(i * n % branch_size + j) % branch_size]
                 for j in range(n)]
        encode(coefficients[n_trunk_layers + i], feats)
        for h in range(n_branch_hidden):
            ansatz(branch_weights[i][h])
            entangle()
    return n, ops


def to_qasm2(n_wires, ops, measure=False):
    """OpenQASM 2.0 emission."""
    lines = ['OPENQASM 2.0;', 'include "qelib1.inc";',
             f'qreg q[{n_wires}];']
    if measure:
        lines.append(f'creg c[{n_wires}];')
    for op in ops:
        if op[0] == 'cx':
            lines.append(f'cx q[{op[1]}],q[{op[2]}];')
        else:
            lines.append(f'{op[0]}({op[2]!r}) q[{op[1]}];')
    if measure:
        lines += [f'measure q[{i}] -> c[{i}];' for i in range(n_wires)]
    return '\n'.join(lines) + '\n'


def final_state(n_wires, ops):
    """Run the exported gate sequence gate by gate and return the final
    statevector as a host-side complex128 array (index k <-> little-endian
    bit i = qubit i, the engine convention).  The port's gate-level
    functions (ops/hea.py ``_rx_single``, ``_apply_ry``, ``_apply_rz``;
    half angles) in float64 on the CPU; CX as an index permutation."""
    from quanonet_torch.ops.hea import _apply_ry, _apply_rz, _rx_single

    f64 = torch.float64
    dim = 2 ** n_wires
    sr = torch.zeros((1, dim), dtype=f64)
    sr[0, 0] = 1.0
    si = torch.zeros((1, dim), dtype=f64)
    k = np.arange(dim)
    for op in ops:
        if op[0] == 'rx':
            sr, si = _rx_single(sr, si, op[1],
                                torch.tensor([op[2]], dtype=f64), n_wires)
        elif op[0] == 'ry':
            half = torch.tensor(op[2], dtype=f64) / 2
            sr, si = _apply_ry(sr, si, op[1], torch.cos(half),
                               torch.sin(half), n_wires)
        elif op[0] == 'rz':
            sr, si = _apply_rz(sr, si, op[1],
                               torch.tensor(op[2], dtype=f64) / 2, n_wires)
        elif op[0] == 'cx':
            c, t = op[1], op[2]
            perm = k ^ (((k >> c) & 1) << t)
            inv = np.empty_like(perm)
            inv[perm] = k
            inv = torch.as_tensor(inv)
            sr = sr[:, inv]
            si = si[:, inv]
        else:
            raise ValueError(f"unknown op {op[0]}")
    return (sr.numpy() + 1j * si.numpy())[0]


def simulate_gate_list(n_wires, ops, ham_pauli='Z', ham_diag=None):
    """Self-verify the export: run the exported gate sequence and return
    the RAW observable value the estimator would report —
    <Σ P_i> for ham_pauli in {X, Y, Z} (reference ham_pauli ablation,
    quantum_circuits_ms.py:28-39), or <H> for an explicit diagonal
    ham_diag (quantum_circuits_qiskit.py:117-134).  Apply the classical
    affine (offset, coeff) from hamiltonian_pauli_terms afterwards."""
    from quanonet_torch.ops.gates import z_signs

    psi = final_state(n_wires, ops)
    if ham_diag is not None:
        d = np.asarray(ham_diag, np.float64)
        if d.size != 2 ** n_wires:
            raise ValueError(f"ham_diag has {d.size} entries; expected "
                             f"2^{n_wires} = {2 ** n_wires}")
        return float((np.abs(psi) ** 2) @ d)
    if ham_pauli == 'Z':
        zs = z_signs(n_wires).sum(axis=1)
        return float((np.abs(psi) ** 2) @ zs)
    if ham_pauli not in ('X', 'Y'):
        raise ValueError(f"ham_pauli must be X|Y|Z, got {ham_pauli!r}")
    k = np.arange(2 ** n_wires)
    total = 0.0
    for i in range(n_wires):
        flipped = psi[k ^ (1 << i)]
        if ham_pauli == 'X':
            # <X_i> = Σ_k conj(ψ_k) ψ_{k^bit}
            total += float(np.real(np.conj(psi) @ flipped))
        else:
            # Y|0>=i|1>, Y|1>=-i|0>: (Yψ)_k = i·sign(bit_i(k))·ψ_{k^bit}
            sign = np.where((k >> i) & 1, 1.0, -1.0)
            total += float(np.real(np.conj(psi) @ (1j * sign * flipped)))
    return total


def hamiltonian_pauli_terms(num_qubits, ham_bound=(-5.0, 5.0),
                            ham_pauli='Z', ham_diag=None):
    """The observable half of a QPU submission: big-endian Pauli-string
    terms for qiskit's ``SparsePauliOp.from_list`` plus the classical
    affine postprocess, ``pred = evs·coeff + offset (+ bias)``.

    Matches the reference's _build_hamiltonian_op
    (quantum_circuits_qiskit.py:93-134): qubit i sits at string position
    n-1-i (qiskit big-endian).  Simple Hamiltonians (H = offset·I +
    c·Σ_i P_i, P = ham_pauli ∈ {X,Y,Z}, generate_simple_hamiltonian
    semantics) export unit-coefficient single-P terms with the affine
    applied classically — exactly how the reference submits
    (ibm_inference.py:195-213).  An explicit ham_diag exports its
    Walsh–Hadamard Z-string decomposition (terms carry the real
    coefficients; offset=0, coeff=1), dropping |c| < 1e-12 terms.

    Returns (terms, offset, coeff) with terms = [(pauli_str, coeff), ...].
    """
    n = num_qubits
    if ham_diag is not None:
        coeffs = walsh_hadamard_coeffs(ham_diag, n)
        terms = []
        for idx, c in enumerate(coeffs):
            if abs(c) < 1e-12:
                continue
            chars = ['I'] * n
            for q in range(n):
                if (idx >> q) & 1:
                    chars[n - 1 - q] = 'Z'
            terms.append((''.join(chars), float(c)))
        if not terms:
            terms = [('I' * n, 0.0)]
        return terms, 0.0, 1.0
    if ham_pauli not in ('X', 'Y', 'Z'):
        raise ValueError(f"ham_pauli must be X|Y|Z, got {ham_pauli!r}")
    offset, coeff = simple_ham_params(n, *ham_bound)
    terms = [('I' * (n - 1 - i) + ham_pauli + 'I' * i, 1.0)
             for i in range(n)]
    return terms, offset, coeff


def pauli_term_expectations(n_wires, ops, terms):
    """Independent estimator double: evaluate each big-endian Pauli-string
    term on the exported circuit's final state exactly as qiskit's
    EstimatorV2 would, and return Σ c·<term>.  Verifies the TERMS emitted
    by hamiltonian_pauli_terms (string convention included) without
    qiskit."""
    psi = final_state(n_wires, ops)
    k = np.arange(2 ** n_wires)
    total = 0.0
    for string, c in terms:
        if len(string) != n_wires:
            raise ValueError(f"term {string!r} has wrong length")
        phi = psi.copy()
        for pos, ch in enumerate(string):
            q = n_wires - 1 - pos    # big-endian: leftmost char = qubit n-1
            if ch == 'I':
                continue
            bit = (k >> q) & 1
            if ch == 'Z':
                phi = np.where(bit, -phi, phi)
            elif ch == 'X':
                phi = phi[k ^ (1 << q)]
            elif ch == 'Y':
                phi = 1j * np.where(bit, 1.0, -1.0) * phi[k ^ (1 << q)]
            else:
                raise ValueError(f"unknown Pauli {ch!r} in {string!r}")
        total += float(c) * float(np.real(np.conj(psi) @ phi))
    return total


def submission_manifest(qasm_strs, num_qubits, ham_bound=(-5.0, 5.0),
                        ham_pauli='Z', ham_diag=None, shots=10_000,
                        bias=0.0, labels=None):
    """Assemble the JSON-serializable hand-off artifact for a multi-pub
    EstimatorV2 submission from a qiskit-enabled machine: one pub per
    exported circuit, a shared observable (hamiltonian_pauli_terms), the
    shot budget, and the classical postprocess.  The structure mirrors
    what submit_to_ibm assembles live (one (circuit, [observable]) pub
    per QASM, reference ibm_inference.py:269-276)."""
    terms, offset, coeff = hamiltonian_pauli_terms(
        num_qubits, ham_bound, ham_pauli, ham_diag)
    pubs = []
    for idx, qasm in enumerate(qasm_strs):
        counts = {}
        for line in qasm.splitlines():
            head = line.split('(')[0].split()[0] if line.strip() else ''
            if head in ('rx', 'ry', 'rz', 'cx'):
                counts[head] = counts.get(head, 0) + 1
        pub = {'index': idx,
               'qasm_sha256': hashlib.sha256(qasm.encode()).hexdigest(),
               'gate_counts': counts}
        if labels is not None:
            pub['label'] = labels[idx]
        pubs.append(pub)
    return {
        'format': 'quanonet-ibm-submission/1',
        'num_qubits': int(num_qubits),
        'shots': int(shots),
        'observable': {'terms': [[s, float(c)] for s, c in terms],
                       'convention': 'qiskit big-endian'},
        'postprocess': {'formula': 'pred = evs*coeff + offset + bias',
                        'coeff': float(coeff), 'offset': float(offset),
                        'bias': float(bias)},
        'pubs': pubs,
    }


def _quanonet(raw, net_size, num_qubits, branch_size, trunk_size, device,
              **kw):
    """The port's QuanONet of ``raw``'s parameters on ``device``, on the
    engine the port's infer path takes (hea.resolve_inference_engine)."""
    from quanonet_torch.convert import state_dict_from_raw
    from quanonet_torch.models import QuanONet
    from quanonet_torch.ops.hea import resolve_inference_engine

    model = QuanONet(num_qubits=num_qubits, branch_input_size=branch_size,
                     trunk_input_size=trunk_size, net_size=tuple(net_size),
                     if_trainable_freq=True,
                     engine=resolve_inference_engine('auto', num_qubits,
                                                     device),
                     device=device, **kw)
    model.load_state_dict(state_dict_from_raw(raw, 'QuanONet',
                                              tuple(net_size), num_qubits,
                                              True))
    return model.eval()


def _points(branch_vec, trunk_points):
    """(branch (n, m) tiled, trunk (n, k)) float32 for n trunk points."""
    t = np.asarray(trunk_points, np.float32)
    t = t.reshape(t.shape[0], -1)
    b = np.tile(np.asarray(branch_vec, np.float32), (t.shape[0], 1))
    return b, t


def _predict(model, b, t, seed=0):
    from quanonet_torch.infer import predict
    return predict(model, b, t, cfg={'model_type': 'QuanONet'},
                   shot_seed=seed)[:, 0]


def ideal_predictions(raw, net_size, num_qubits, branch_vec, trunk_points,
                      ham_bound=(-5.0, 5.0), ham_pauli='Z', ham_diag=None,
                      device=None):
    """Ideal (noise-free) predictions for all trunk points on the port's
    engine: the analog of the reference's StatevectorEstimator step
    (ibm_inference.py:205-213), with the whole observable surface
    (ham_pauli X/Y, an explicit ham_diag).  (n_points,) float32."""
    device = resolve_device(device)
    b, t = _points(branch_vec, trunk_points)
    model = _quanonet(raw, net_size, num_qubits, b.shape[1], t.shape[1],
                      device, ham_bound=tuple(ham_bound),
                      ham_pauli=ham_pauli,
                      ham_diag=(tuple(float(d) for d in ham_diag)
                                if ham_diag is not None else None))
    return _predict(model, b, t)


def shot_predictions(raw, net_size, num_qubits, branch_vec, trunk_points,
                     ham_bound=(-5.0, 5.0), shots=10_000, seed=0,
                     device=None):
    """Finite-shot predictions and the analytic shot-noise std per point:
    the decoherence-free emulation of the reference's 10,000-shot
    EstimatorV2 job (ibm_inference.py:269-276), so the shot-noise floor of
    a planned QPU submission is known before it is spent.  The shots draw
    from the port's generators, seeded from ``seed`` (infer.predict's
    ``shot_seed``).

    Returns (sampled_preds, shot_std), both (n_points,) float64."""
    from quanonet_torch.ops.hamiltonian import simple_ham_diag
    from quanonet_torch.ops.hea import hea_forward_pair
    from quanonet_torch.ops.sampling import shot_noise_std

    device = resolve_device(device)
    b, t = _points(branch_vec, trunk_points)
    model = _quanonet(raw, net_size, num_qubits, b.shape[1], t.shape[1],
                      device, ham_bound=tuple(ham_bound), shots=int(shots))
    sampled = _predict(model, b, t, seed)
    # the analytic std needs the pre-measurement state: the model's own
    # frequency maps, then the engine
    diag = torch.as_tensor(simple_ham_diag(num_qubits, *ham_bound),
                           device=device)
    with torch.inference_mode():
        bt = torch.as_tensor(b, device=device)
        tt = torch.as_tensor(t, device=device)
        sr, si = hea_forward_pair(model.spec, model.ansatz,
                                  model.encode(bt, tt),
                                  engine=model.engine)
        std = shot_noise_std(sr, si, diag, int(shots))[:, 0].cpu().numpy()
    return sampled.astype(np.float64), std.astype(np.float64)


def noisy_predictions(raw, net_size, num_qubits, branch_vec, trunk_points,
                      noise_p, ham_bound=(-5.0, 5.0), readout_p=0.0,
                      n_traj=64, zne_scales=None, seed=0,
                      damp_gamma=None, dephase_p=None, device=None):
    """Predictions under the calibrated depolarizing + readout channel
    (ops/noise.py): the decoherence floor of a planned QPU job, optionally
    zero-noise-extrapolated (ops/mitigation.py, ``zne_scales=(1, 2, 3)``).
    Derive ``noise_p`` from calibration with
    ops.noise.noise_p_from_calibration(spec, gate_error_2q), and
    ``damp_gamma`` / ``dephase_p`` (T1/T2 a block) with
    ops.noise.channel_params_from_t1t2(block_time_us, t1_us, t2_us).  The
    trajectories draw from the port's generators, seeded from ``seed``; on
    ``cuda`` up to 7 qubits without damping they take the fold route (one
    B1f launch a trajectory on one compile), otherwise the physical frame.

    Returns (n_points,) float64: with shot_predictions, the hardware error
    budget before submission."""
    device = resolve_device(device)
    b, t = _points(branch_vec, trunk_points)
    model = _quanonet(
        raw, net_size, num_qubits, b.shape[1], t.shape[1], device,
        ham_bound=tuple(ham_bound), noise_p=float(noise_p),
        noise_traj=int(n_traj), readout_p=float(readout_p),
        zne_scales=tuple(zne_scales) if zne_scales else None,
        damp_gamma=float(damp_gamma) if damp_gamma is not None else None,
        dephase_p=float(dephase_p) if dephase_p is not None else None)
    return _predict(model, b, t, seed).astype(np.float64)


# ── qiskit-gated extras ──────────────────────────────────────────────────────

def qiskit_available() -> bool:
    try:
        import qiskit  # noqa: F401
        return True
    except ImportError:
        return False


def profile_hardware(backend):
    """Calibration-aware qubit-pair scoring (reference
    ibm_inference.py:68-118): score = 2q-gate error + readout errors;
    reports T1/T2.  Requires a qiskit backend object."""
    props = backend.properties()
    conf = backend.configuration()
    basis_gates = conf.basis_gates
    gate_name = 'ecr' if 'ecr' in basis_gates else (
        'cz' if 'cz' in basis_gates else 'cx')

    scored = []
    seen = set()
    for q1, q2 in conf.coupling_map:
        key = tuple(sorted((q1, q2)))
        if key in seen:
            continue
        seen.add(key)
        try:
            gp = (props.gate_property(gate_name, [q1, q2])
                  or props.gate_property(gate_name, [q2, q1]))
            if not gp or 'gate_error' not in gp:
                continue
            gate_err = gp['gate_error'][0]
            ro1 = props.qubit_property(q1, 'readout_error')[0]
            ro2 = props.qubit_property(q2, 'readout_error')[0]
            t1 = (props.qubit_property(q1, 'T1')[0]
                  + props.qubit_property(q2, 'T1')[0]) / 2 * 1e6
            t2 = (props.qubit_property(q1, 'T2')[0]
                  + props.qubit_property(q2, 'T2')[0]) / 2 * 1e6
            scored.append({'pair': [q1, q2],
                           'score': gate_err + ro1 + ro2,
                           'gate_err': gate_err,
                           'ro_avg': (ro1 + ro2) / 2,
                           't1_avg': t1, 't2_avg': t2})
        except Exception:
            continue
    scored.sort(key=lambda s: s['score'])
    best = scored[0]
    print(f"Recommended Best Pair : {best['pair']}")
    print(f"  -> Avg T1 Time      : {best['t1_avg']:.1f} µs")
    print(f"  -> Avg T2 Time      : {best['t2_avg']:.1f} µs")
    print(f"  -> Gate Error       : {best['gate_err']:.4%}")
    print(f"  -> Avg Readout Error: {best['ro_avg']:.4%}")
    return best['pair']


def submit_to_ibm(qasm_strs, num_qubits, ham_bound, shots=10_000,
                  min_num_qubits=None, ham_pauli='Z', ham_diag=None):
    """Submit exported circuits to the least-busy IBM backend with
    calibration-aware initial layout (reference ibm_inference.py:244-276).
    The observable supports the full Hamiltonian surface (Z/X/Y simple
    bounds, explicit ham_diag) via hamiltonian_pauli_terms.
    Requires qiskit + qiskit-ibm-runtime + QISKIT_IBM_TOKEN."""
    if not qiskit_available():
        raise ImportError(
            "qiskit is not installed in this environment; the exported "
            ".qasm files are the hand-off artifact — submit them from a "
            "qiskit-enabled machine.")
    import os
    from qiskit import QuantumCircuit, transpile
    from qiskit.quantum_info import SparsePauliOp
    from qiskit_ibm_runtime import EstimatorV2, QiskitRuntimeService

    token = os.getenv("QISKIT_IBM_TOKEN")
    service = QiskitRuntimeService(channel="ibm_quantum_platform",
                                   token=token)
    backend = service.least_busy(
        min_num_qubits=min_num_qubits or num_qubits + 1)
    layout = profile_hardware(backend)[:num_qubits]
    terms, offset, coeff = hamiltonian_pauli_terms(
        num_qubits, ham_bound, ham_pauli, ham_diag)
    ham = SparsePauliOp.from_list(terms)
    pubs = []
    for qasm in qasm_strs:
        qc = QuantumCircuit.from_qasm_str(qasm)
        isa = transpile(qc, backend=backend, optimization_level=3,
                        initial_layout=layout)
        pubs.append((isa, [ham.apply_layout(isa.layout)]))
    estimator = EstimatorV2(mode=backend)
    estimator.options.default_shots = shots
    job = estimator.run(pubs)
    print(f"Submitted job: {job.job_id()}")
    return job, offset, coeff


def fetch_ibm_job(job_id):
    """Fetch an existing IBM Quantum job's expectation values
    (reference ibm_inference.py:223-243).  Returns (evs, backend_name)
    when the job is DONE, else (None, status).  Requires qiskit-ibm-
    runtime + QISKIT_IBM_TOKEN."""
    if not qiskit_available():
        raise ImportError(
            "qiskit is not installed in this environment; fetch the job "
            "from a qiskit-enabled machine "
            "(concatenate r.data.evs over QiskitRuntimeService()"
            ".job(id).result()).")
    import os
    import numpy as _np
    from qiskit_ibm_runtime import QiskitRuntimeService

    token = os.getenv("QISKIT_IBM_TOKEN")
    service = QiskitRuntimeService(channel="ibm_quantum_platform",
                                   token=token)
    job = service.job(job_id)
    status = str(job.status())
    if status != "DONE":
        return None, status
    backend_name = job.backend().name if job.backend() else "Unknown"
    # submit_to_ibm runs ONE pub per exported circuit (the reference's
    # ibm_inference.py:223-243 uses a single parameterized pub instead) —
    # gather every pub's expectation values, not just pub 0's.
    evs = _np.concatenate(
        [_np.atleast_1d(_np.asarray(r.data.evs)) for r in job.result()])
    return evs, backend_name
