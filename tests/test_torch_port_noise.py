"""
Noise trajectories of the port (quanonet_torch/ops/noise.py), the noisy
models, noise-aware training and the infer CLI's noise flags, held against
the JAX package (quanonet_tpu/ops/noise.py) on the CPU.

Tolerances: the helpers 1e-6 (exact for the integer and NumPy ones, the
same ValueErrors); one trajectory with injected masks and jump uniforms
1e-5 against JAX's ``_traj_forward`` (fp32 chains of a few blocks, other
order); the fold route (Paulis folded into the chain's block matrices)
1e-5 against the physical-frame forward for the same masks, its gradient
1e-4 against ``jax.grad``; the trajectory mean against a complex128
density-matrix oracle with the JAX test's atol 0.1 (8,192 trajectories:
Monte-Carlo error ~0.02).  The random streams are torch's, so whole noisy
outputs are held by distribution, by replay and by the oracle, not by
bits against JAX.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quanonet_torch.data.generation as t_gen
from quanonet_tpu.models import QuanONet as JQuanONet
from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.ops import noise as j_noise
from quanonet_torch import infer as t_infer
from quanonet_torch import solver as t_solver
from quanonet_torch.models import QuanONet
from quanonet_torch.ops import cuda_hea
from quanonet_torch.ops import hea as t_hea
from quanonet_torch.ops import noise as t_noise
from quanonet_torch.ops.hamiltonian import simple_ham_diag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANTIDERIV = os.path.join(
    REPO, 'pretrained_weights/Antideriv/'
    'Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_1000x100_Seed0/'
    'best_model.npz')


def _gen(seed=7):
    return torch.Generator().manual_seed(seed)


def _setup(n=2, net=(2, 1, 2, 1), batch=3, seed=0):
    """(torch spec, JAX spec, w, x, diag) as in tests/test_noise.py."""
    rng = np.random.RandomState(seed)
    spec = t_hea.quanonet_spec(n, net)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.randn(batch, spec.total_encode).astype(np.float32)
    return spec, j_hea.quanonet_spec(n, net), w, x, simple_ham_diag(n, -3, 3)


def _masks(rng, nb, n, p=0.5):
    return rng.rand(nb, n) < p, rng.rand(nb, n) < p


# ── the helpers against JAX ─────────────────────────────────────────────────

@pytest.mark.parametrize("a,b", [(1, 0), (0, 1), (1, 1), (0, 0)])
def test_pauli_xz_matches_jax(a, b):
    rng = np.random.RandomState(3)
    sr = rng.randn(4, 8).astype(np.float32)
    si = rng.randn(4, 8).astype(np.float32)
    for q in range(3):
        jr, ji = j_noise.apply_pauli_xz(jnp.asarray(sr), jnp.asarray(si), q,
                                        jnp.bool_(a), jnp.bool_(b), 3)
        tr, ti = t_noise.apply_pauli_xz(torch.tensor(sr), torch.tensor(si),
                                        q, torch.tensor(bool(a)),
                                        torch.tensor(bool(b)), 3)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_amplitude_damping_matches_jax():
    rng = np.random.RandomState(11)
    psi = rng.randn(5, 8) + 1j * rng.randn(5, 8)
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    sr, si = psi.real.astype(np.float32), psi.imag.astype(np.float32)
    u = rng.rand(5).astype(np.float32)
    for q in range(3):
        for gamma in (0.0, 0.3, 0.9, 1.0):
            jr, ji = j_noise.apply_amplitude_damping(
                jnp.asarray(sr), jnp.asarray(si), q, jnp.float32(gamma),
                jnp.asarray(u), 3)
            tr, ti = t_noise.apply_amplitude_damping(
                torch.tensor(sr), torch.tensor(si), q, gamma,
                torch.tensor(u), 3)
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
            np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6)
            norms = (tr ** 2 + ti ** 2).sum(1).numpy()
            np.testing.assert_allclose(norms, 1.0, atol=1e-5)


@pytest.mark.parametrize("ro", [0.07, (0.03, 0.1, 0.0)])
def test_readout_error_matches_jax(ro):
    rng = np.random.RandomState(5)
    probs = rng.rand(4, 8).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    want = np.asarray(j_noise.apply_readout_error(
        jnp.asarray(probs), jnp.asarray(np.asarray(ro, np.float32))))
    got = t_noise.apply_readout_error(torch.tensor(probs),
                                      np.asarray(ro, np.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_numpy_helpers_equal_jax():
    for shots, traj in [(1000, 32), (7, 32), (33, 8), (0, 4)]:
        np.testing.assert_array_equal(t_noise.distribute_shots(shots, traj),
                                      j_noise.distribute_shots(shots, traj))
    for args in [(None, None, None, None), (0.0, 0.0, 0.0, 0.0),
                 (0.01, None, None, None), (None, 0.02, None, None),
                 (None, None, 0.1, None), (None, None, None, 0.05),
                 ((0.0, 0.1), None, None, None), ((0.0, 0.0), 0, None, 0.0)]:
        assert t_noise.is_noisy(*args) == j_noise.is_noisy(*args), args
    for nq, net in [(5, (40, 2, 20, 2)), (2, (5, 1, 5, 1)), (3, (4, 2, 3, 1))]:
        for e2, e1 in [(0.005, 0.0), (0.01, 0.001), (0.5, 0.1), (0.0, 0.0)]:
            assert t_noise.noise_p_from_calibration(
                t_hea.quanonet_spec(nq, net), e2, e1) == \
                j_noise.noise_p_from_calibration(
                    j_hea.quanonet_spec(nq, net), e2, e1)
    for args in [(0.0, 100.0, 80.0), (1.0, 100.0, 80.0), (1.0, 100.0, 200.0),
                 (1.0, 100.0, 500.0), (2.5, 37.0, 21.0)]:
        assert t_noise.channel_params_from_t1t2(*args) == \
            j_noise.channel_params_from_t1t2(*args)
    for bad in [(1.0, -1.0, 80.0), (-1.0, 100.0, 80.0), (1.0, 100.0, 0.0)]:
        with pytest.raises(ValueError, match='block_time_us'):
            j_noise.channel_params_from_t1t2(*bad)
        with pytest.raises(ValueError, match='block_time_us'):
            t_noise.channel_params_from_t1t2(*bad)


def test_masks_follow_the_channel():
    """The masks' rates: errors with prob p, each Pauli a third of them."""
    a, b = t_noise.sample_pauli_masks(_gen(1), 0.3, 2000, 5)
    assert a.shape == b.shape == (2000, 5) and a.dtype == torch.bool
    occur = (a | b).float().mean().item()
    y = (a & b).float().mean().item()
    assert abs(occur - 0.3) < 0.01 and abs(y - 0.1) < 0.01
    a2, b2 = t_noise.sample_pauli_masks(_gen(1), 0.3, 2000, 5)
    assert torch.equal(a, a2) and torch.equal(b, b2)


# ── one trajectory: physical frame and fold route ───────────────────────────

def _unitaries(spec_j, spec_t, w):
    ur, ui = j_hea.compile_block_unitaries(spec_j, jnp.asarray(w))
    tur, tui = t_hea.compile_block_unitaries(spec_t, torch.tensor(w))
    return ((ur.transpose(0, 2, 1), ui.transpose(0, 2, 1)),
            (tur.transpose(1, 2), tui.transpose(1, 2)))


@pytest.mark.parametrize("n", [2, 3, 4, 5])
@pytest.mark.parametrize("damping", [False, True])
def test_traj_forward_matches_jax(n, damping):
    spec, spec_j, w, x, _ = _setup(n, (2, 1, 2, 1), batch=4, seed=n)
    nb = spec.n_blocks
    rng = np.random.RandomState(10 + n)
    a, b = _masks(rng, nb, n)
    gamma = np.full(n, 0.3, np.float32) if damping else None
    u = rng.rand(nb, n, 4).astype(np.float32) if damping else None
    (jr_, ji_), (tr_, ti_) = _unitaries(spec_j, spec, w)
    xb = x.reshape(4, nb, n).transpose(1, 0, 2)
    jr, ji = j_noise._traj_forward(
        spec_j, jr_, ji_, jnp.asarray(xb), jnp.asarray(a), jnp.asarray(b),
        None if gamma is None else jnp.asarray(gamma),
        None if u is None else jnp.asarray(u))
    tr, ti = t_noise.traj_forward(
        spec, tr_, ti_, torch.tensor(xb), torch.tensor(a), torch.tensor(b),
        None if gamma is None else torch.tensor(gamma),
        None if u is None else torch.tensor(u))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)


def _one_pauli(nb, n, block, pauli, qubit):
    a = np.zeros((nb, n), bool)
    b = np.zeros((nb, n), bool)
    a[block, qubit] = pauli in 'XY'
    b[block, qubit] = pauli in 'YZ'
    return a, b


def _fold_against_physical(spec, w, x, a, b):
    mt_r, mt_i, phi = t_hea.prepare_chain(spec, torch.tensor(w),
                                          torch.tensor(x))
    fr, fi = t_noise.fold_states(mt_r, mt_i, phi, torch.tensor(a)[None],
                                 torch.tensor(b)[None])
    ur, ui = t_hea.compile_block_unitaries(spec, torch.tensor(w))
    xb = torch.tensor(x).reshape(x.shape[0], spec.n_blocks,
                                 spec.n_qubits).transpose(0, 1)
    pr, pi = t_noise.traj_forward(spec, ur.transpose(1, 2),
                                  ui.transpose(1, 2), xb, torch.tensor(a),
                                  torch.tensor(b))
    return (fr[0], fi[0]), (pr, pi)


@pytest.mark.parametrize("pauli", ['X', 'Y', 'Z'])
@pytest.mark.parametrize("where", ['first', 'inner', 'last'])
def test_fold_route_matches_physical_frame(pauli, where):
    """A Pauli folded into the chain's block matrices gives the state of
    the physical-frame forward with that Pauli after U_b, global phase
    included, on every qubit of the first, an inner and the last block."""
    spec, _, w, x, _ = _setup(3, (2, 1, 2, 1), batch=5, seed=4)
    nb = spec.n_blocks
    block = {'first': 0, 'inner': nb // 2, 'last': nb - 1}[where]
    for q in range(3):
        a, b = _one_pauli(nb, 3, block, pauli, q)
        (fr, fi), (pr, pi) = _fold_against_physical(spec, w, x, a, b)
        np.testing.assert_allclose(fr.numpy(), pr.numpy(), atol=1e-5)
        np.testing.assert_allclose(fi.numpy(), pi.numpy(), atol=1e-5)


@pytest.mark.parametrize("n,net", [(1, (2, 1, 2, 1)), (4, (3, 2, 2, 1)),
                                   (5, (4, 2, 3, 2))])
def test_fold_route_random_patterns(n, net):
    spec, _, w, x, _ = _setup(n, net, batch=6, seed=n)
    rng = np.random.RandomState(n)
    for _ in range(3):
        a, b = _masks(rng, spec.n_blocks, n)
        (fr, fi), (pr, pi) = _fold_against_physical(spec, w, x, a, b)
        np.testing.assert_allclose(fr.numpy(), pr.numpy(), atol=1e-5)
        np.testing.assert_allclose(fi.numpy(), pi.numpy(), atol=1e-5)


def test_fold_route_gradient_matches_jax():
    """The fold route's gradient (the chain's backward, B1b's plain
    version, and the autograd fold of the block matrices) against
    jax.grad of JAX's physical-frame trajectory at the same masks."""
    spec, spec_j, w, x, diag = _setup(3, (2, 2, 2, 1), batch=4, seed=9)
    rng = np.random.RandomState(9)
    masks = [_masks(rng, spec.n_blocks, 3, 0.4) for _ in range(3)]
    xb = x.reshape(4, spec.n_blocks, 3).transpose(1, 0, 2)

    def j_loss(w_, xb_):
        ur, ui = j_hea.compile_block_unitaries(spec_j, w_)
        total = 0.0
        for a, b in masks:
            sr, si = j_noise._traj_forward(
                spec_j, ur.transpose(0, 2, 1), ui.transpose(0, 2, 1), xb_,
                jnp.asarray(a), jnp.asarray(b))
            e = jnp.sum((sr * sr + si * si) * jnp.asarray(diag), axis=1)
            total = total + jnp.sum(e ** 2)
        return total
    gw_j, gx_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(w),
                                                   jnp.asarray(xb))
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    mt_r, mt_i, phi = cuda_hea._prepare(spec, wt, xt)
    a = torch.tensor(np.stack([m[0] for m in masks]))
    b = torch.tensor(np.stack([m[1] for m in masks]))
    sr, si = t_noise.fold_states(mt_r, mt_i, phi, a, b)
    e = ((sr * sr + si * si) * torch.tensor(diag)).sum(-1)
    (e ** 2).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=1e-4)
    gx = xt.grad.reshape(4, spec.n_blocks, 3).transpose(0, 1).numpy()
    np.testing.assert_allclose(gx, np.asarray(gx_j), atol=1e-4)


# ── the trajectory mean ─────────────────────────────────────────────────────

def _kron_op(P, q, n):
    mats = [np.eye(2, dtype=complex)] * n
    mats[n - 1 - q] = P
    out = mats[0]
    for m in mats[1:]:
        out = np.kron(out, m)
    return out


def _dm_oracle(spec_j, w, x, diag, p_dep, p_phi, gamma):
    """Exact density-matrix evolution of the composed channel (the oracle
    of tests/test_noise.py): encode ⊗RX → U_b → depolarizing → dephasing
    → amplitude damping (Kraus), per block; complex128 NumPy, the block
    unitaries from the JAX package."""
    n, nb, D = spec_j.n_qubits, spec_j.n_blocks, spec_j.dim
    ur, ui = j_hea.compile_block_unitaries(spec_j, jnp.asarray(w))
    U = np.asarray(ur, np.float64) + 1j * np.asarray(ui, np.float64)
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    Y = np.array([[0, -1j], [1j, 0]], dtype=complex)
    Z = np.array([[1, 0], [0, -1]], dtype=complex)
    K0 = np.array([[1, 0], [0, np.sqrt(1 - gamma)]], dtype=complex)
    K1 = np.array([[0, np.sqrt(gamma)], [0, 0]], dtype=complex)

    def rx(theta):
        c, s = np.cos(theta / 2), np.sin(theta / 2)
        return np.array([[c, -1j * s], [-1j * s, c]])

    xb = np.asarray(x, np.float64).reshape(-1, nb, n)
    outs = []
    for s in range(xb.shape[0]):
        rho = np.zeros((D, D), dtype=complex)
        rho[0, 0] = 1.0
        for b in range(nb):
            E = np.eye(D, dtype=complex)
            for q in range(n):
                E = _kron_op(rx(xb[s, b, q]), q, n) @ E
            V = U[b] @ E
            rho = V @ rho @ V.conj().T
            for q in range(n):
                rho = (1 - p_dep) * rho + (p_dep / 3) * sum(
                    _kron_op(P, q, n) @ rho @ _kron_op(P, q, n).conj().T
                    for P in (X, Y, Z))
            for q in range(n):
                Zq = _kron_op(Z, q, n)
                rho = (1 - p_phi) * rho + p_phi * (Zq @ rho @ Zq.conj().T)
            for q in range(n):
                A0, A1 = _kron_op(K0, q, n), _kron_op(K1, q, n)
                rho = A0 @ rho @ A0.conj().T + A1 @ rho @ A1.conj().T
        outs.append(float(np.real(np.sum(np.diag(rho) * diag))))
    return np.array(outs)


@pytest.mark.parametrize("p_dep,p_phi,gamma", [(0.15, 0.10, 0.20),
                                               (0.0, 0.0, 0.35)])
def test_trajectory_mean_vs_density_matrix_oracle(p_dep, p_phi, gamma):
    """The composed channels, and damping alone."""
    spec, spec_j, w, x, diag = _setup(batch=2)
    want = _dm_oracle(spec_j, w, x, diag, p_dep, p_phi, gamma)
    got = t_noise.noisy_expectation(
        _gen(), spec, torch.tensor(w), torch.tensor(x), p_dep, 8192,
        diag=diag, damp_gamma=gamma, dephase_p=p_phi or None)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=0.1)


def test_full_damping_resets_to_ground():
    """γ = 1: every qubit is reset to |0⟩ after the last block on both
    branches, so ⟨Z_0⟩ = +1 exactly for every trajectory."""
    spec, _, w, x, _ = _setup(batch=3)
    zdiag = np.array([1, -1, 1, -1], np.float32)
    got = t_noise.noisy_expectation(_gen(), spec, torch.tensor(w),
                                    torch.tensor(x), 0.0, 8, diag=zdiag,
                                    damp_gamma=1.0)
    np.testing.assert_allclose(got.numpy(), 1.0, atol=1e-5)


def test_zero_noise_and_readout_alone_are_exact():
    spec, spec_j, w, x, diag = _setup()
    wt, xt = torch.tensor(w), torch.tensor(x)
    exact = t_hea.hea_expectation(spec, wt, xt, diag=diag, engine='dense')
    zero = t_noise.noisy_expectation(_gen(), spec, wt, xt, 0.0, 4, diag=diag)
    np.testing.assert_allclose(zero.numpy(), exact.numpy(), atol=1e-5)
    sr, si = j_hea.hea_forward_pair(spec_j, jnp.asarray(w), jnp.asarray(x),
                                    engine='dense')
    probs = sr * sr + si * si
    probs = probs / probs.sum(axis=1, keepdims=True)
    want = np.asarray(j_noise.apply_readout_error(probs, 0.07) @ diag)
    got = t_noise.noisy_expectation(_gen(), spec, wt, xt, 0.0, 2, diag=diag,
                                    readout_p=0.07)
    np.testing.assert_allclose(got[:, 0].numpy(), want, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(shots=640),
                                dict(pauli='X', offset=1.0, coeff=0.5),
                                dict(damp_gamma=0.2, dephase_p=0.05)])
def test_replay_bit_equal_and_seed_sensitive(kw):
    spec, _, w, x, diag = _setup()
    obs = {} if 'pauli' in kw else dict(diag=diag)
    args = (spec, torch.tensor(w), torch.tensor(x), 0.2, 16)
    a = t_noise.noisy_expectation(_gen(7), *args, **obs, **kw)
    b = t_noise.noisy_expectation(_gen(7), *args, **obs, **kw)
    c = t_noise.noisy_expectation(_gen(8), *args, **obs, **kw)
    assert a.shape == (3, 1) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_shots_compose_with_noise():
    """The finite-shot noisy estimate converges to the exact noisy value
    (the JAX test's budget and limit)."""
    spec, _, w, x, diag = _setup(batch=2)
    args = (spec, torch.tensor(w), torch.tensor(x), 0.1, 256)
    exact = t_noise.noisy_expectation(_gen(), *args, diag=diag)
    sampled = t_noise.noisy_expectation(_gen(), *args, diag=diag,
                                        shots=256 * 512)
    np.testing.assert_allclose(sampled.numpy(), exact.numpy(), atol=0.15)


def test_routes_and_the_fold_route_on_the_same_draws(monkeypatch):
    """The route comes from (device, qubits, damping); forced onto the
    CPU, the fold route draws what the plain route draws and gives its
    values, with a gradient."""
    assert t_noise.noise_route('cuda', 5, False) == 'fold'
    assert t_noise.noise_route('cuda', 7, False) == 'fold'
    assert t_noise.noise_route('cuda', 8, False) == 'plain'
    assert t_noise.noise_route('cuda', 5, True) == 'plain'
    assert t_noise.noise_route('cpu', 5, False) == 'plain'
    spec, _, w, x, diag = _setup(3, (2, 1, 2, 1), batch=4, seed=2)
    out, grads = {}, {}
    for route in ('plain', 'fold'):
        monkeypatch.setattr(t_noise, 'noise_route', lambda *a, r=route: r)
        before = dict(t_noise.routes)
        wt = torch.tensor(w, requires_grad=True)
        out[route] = t_noise.noisy_expectation(
            _gen(3), spec, wt, torch.tensor(x), 0.3, 6, diag=diag,
            readout_p=0.02, dephase_p=0.1)
        out[route].sum().backward()
        grads[route] = wt.grad
        assert t_noise.routes[route] == before[route] + 1
    np.testing.assert_allclose(out['fold'].detach().numpy(),
                               out['plain'].detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(grads['fold'].numpy(),
                               grads['plain'].numpy(), atol=1e-4)


def test_trajectories_in_slices_give_the_same_bits(monkeypatch):
    spec, _, w, x, diag = _setup()
    args = (spec, torch.tensor(w), torch.tensor(x), 0.2, 9)
    whole = t_noise.noisy_expectation(_gen(), *args, diag=diag, shots=900)
    monkeypatch.setattr(t_noise, 'SLICE_BYTES', 1)     # one a slice
    sliced = t_noise.noisy_expectation(_gen(), *args, diag=diag, shots=900)
    assert torch.equal(sliced, whole)


def test_nonuniform_spec_rejected():
    spec = t_hea.HEASpec(2, ((2, 1), (1, 1)))
    with pytest.raises(ValueError, match='uniform-encode'):
        t_noise.noisy_expectation(_gen(), spec,
                                  torch.zeros(spec.weight_shape()),
                                  torch.zeros(1, spec.total_encode), 0.1, 2,
                                  diag=np.zeros(4, np.float32))


# ── the models ──────────────────────────────────────────────────────────────

KW = dict(num_qubits=2, branch_input_size=5, trunk_input_size=2,
          net_size=(2, 1, 2, 1), scale_coeff=0.1)


@pytest.mark.parametrize("flags,match", [
    (dict(noise_p=0.1, grad_method='shift'), 'unitary circuit'),
    (dict(zne_scales=(1.0, 2.0), grad_method='shift'), 'unitary circuit'),
    (dict(zne_scales=(1.0, 2.0)), 'requires noise_p'),
    (dict(noise_p=0.1, zne_scales=(1.0, 2.0), shots=100),
     'mutually exclusive'),
    (dict(noise_p=0.1, zne_scales=(1.0, 2.0), damp_gamma=0.3),
     'depolarizing'),
    (dict(noise_p=0.1, zne_scales=(1.0, 2.0), dephase_p=0.3),
     'depolarizing'),
])
def test_model_guards_raise_as_jax(flags, match):
    rng = np.random.RandomState(0)
    b = jnp.asarray(rng.randn(2, 5).astype(np.float32))
    t = jnp.asarray(rng.rand(2, 2).astype(np.float32))
    params = JQuanONet(**KW).init(jax.random.PRNGKey(0), b, t)
    with pytest.raises(ValueError, match=match):
        JQuanONet(**KW, **flags).apply(
            params, b, t, rngs={'noise': jax.random.PRNGKey(1),
                                'shots': jax.random.PRNGKey(2)})
    with pytest.raises(ValueError, match=match):
        QuanONet(**KW, **flags, device='cpu')


def test_noisy_model_needs_a_generator_and_replays():
    model = QuanONet(**KW, noise_p=0.3, noise_traj=8, readout_p=0.05,
                     device='cpu', generator=_gen(0))
    assert model.sampled and model.measure.noise_traj == 8
    b, t = torch.randn(4, 5), torch.rand(4, 2)
    with pytest.raises(ValueError, match='generator'):
        model(b, t)
    a = model(b, t, generator=_gen(3))
    assert torch.equal(a, model(b, t, generator=_gen(3)))
    a.sum().backward()
    assert torch.isfinite(model.ansatz.grad).all()
    # zero-strength channels are the ideal model
    ideal = QuanONet(**KW, device='cpu', generator=_gen(0))
    zero = QuanONet(**KW, noise_p=0.0, damp_gamma=0.0, dephase_p=0.0,
                    noise_traj=2, device='cpu', generator=_gen(0))
    assert not zero.sampled
    torch.testing.assert_close(zero(b, t), ideal(b, t))


# ── noise-aware training and inference ──────────────────────────────────────

@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.chdir(tmp_path)
    np.random.seed(0)
    return tmp_path


def _cfg(prefix, **over):
    cfg = dict(operator='Antideriv', model_type='QuanONet',
               num_train=20, num_test=10, num_points=50, num_points_0=10,
               train_sample_num=5, test_sample_num=10,
               batch_size=25, num_epochs=8, epochs_per_sync=4,
               learning_rate=0.01, num_qubits=2, net_size=[2, 1, 2, 1],
               scale_coeff=0.01, if_trainable_freq='true',
               ham_bound=[-5, 5], ham_pauli='Z', seed=0, prefix=prefix,
               noise_p=0.05, noise_traj=2, readout_p=0.02, device='cpu')
    cfg.update(over)
    return cfg


def test_noise_training_end_to_end(isolated):
    """The JAX test's run: the _Noise run ID, the loss falling, finite
    metrics, and the checkpoint loading under its channel."""
    solver = t_solver.Solver(_cfg('outputs'))
    assert '_Noise0.05R0.02' in solver.run_id
    assert solver.model.sampled and solver.model.measure.noise_traj == 2
    history = solver.train()
    metrics = solver.evaluate(history)
    assert np.isfinite(metrics['rel_l2'])
    losses = history['loss_train']
    assert len(losses) == 8 and losses[-1] < losses[0]
    exp_dir = solver.exp_logger.exp_dir
    with open(os.path.join(exp_dir, 'train_args.json')) as f:
        assert json.load(f)['noise_p'] == 0.05
    model, cfg = t_infer.load_model(os.path.join(exp_dir, 'best_model.ckpt'),
                                    10, 1, device='cpu')
    assert cfg['noise_p'] == 0.05 and cfg['readout_p'] == 0.02
    assert model.sampled and model.measure.noise_traj == 32
    # the evaluation is under the channel, keyed off the run seed
    np.testing.assert_array_equal(solver.predict_test(),
                                  solver.predict_test())


@pytest.mark.parametrize("over,tag", [
    (dict(), '_Noise0.05R0.02'),
    (dict(noise_p=None, readout_p=None, damp_gamma=0.02, dephase_p=0.005),
     '_Noise0G0.02F0.005')])
def test_noisy_run_resumes_bit_identically(isolated, over, tag):
    """Broken after epoch 4 and resumed, a noisy run (depolarizing and
    readout; T1/T2) draws what the unbroken run drew: the trajectories are
    keyed by (seed, global step)."""
    over = dict(over, save_state='true')
    a = t_solver.Solver(_cfg('outA', **over))
    assert tag in a.run_id
    hist_a = a.train()['loss_train']
    b1 = t_solver.Solver(_cfg('outB', **over))
    orig = b1.exp_logger.log_metric

    def dying_log(tag, value, step):
        if step >= 4:
            raise RuntimeError('simulated preemption')
        return orig(tag, value, step)

    b1.exp_logger.log_metric = dying_log
    with pytest.raises(RuntimeError, match='simulated preemption'):
        b1.train()
    b2 = t_solver.Solver(_cfg('outB', **over))
    hist_b = b2.train()['loss_train']
    assert hist_a == hist_b and len(hist_b) == 8
    assert hist_a[-1] < hist_a[0]
    for k in a.params:
        assert torch.equal(a.params[k], b2.params[k]), k


def test_served_noisy_predictions_replay():
    """serve.Predictor with a noise channel draws each bucket from
    (shot_seed, bucket counter): one seed replays, another differs."""
    from quanonet_torch.serve import Predictor
    rng = np.random.RandomState(2)
    b = rng.randn(5, 10).astype(np.float32)
    t = rng.rand(5, 1).astype(np.float32)

    def served(seed):
        return Predictor(ANTIDERIV, branch_in=10, trunk_in=1, max_batch=8,
                         device='cpu', shot_seed=seed, noise_p=0.05,
                         noise_traj=4, readout_p=0.01)
    p = served(3)
    assert p.model.sampled and p.model.measure.readout_p == 0.01
    out = p.predict(b, t)
    assert out.shape == (5, 1) and np.isfinite(out).all()
    np.testing.assert_array_equal(served(3).predict(b, t), out)
    assert not np.array_equal(served(4).predict(b, t), out)


def test_classical_models_refuse_noise(isolated):
    with pytest.raises(ValueError, match='quantum models'):
        t_solver.Solver(_cfg('outputs', model_type='FNN', net_size=[2, 8]))


def _antideriv_data(tmp_path, n=6):
    rng = np.random.RandomState(4)
    data = tmp_path / 'd.npz'
    np.savez(data, test_branch_input=rng.randn(n, 10).astype(np.float32),
             test_trunk_input=rng.rand(n, 1).astype(np.float32),
             test_output=rng.randn(n, 1).astype(np.float32))
    return str(data)


@pytest.mark.parametrize("flags", [
    ['--noise_p', '0.05', '--noise_traj', '4', '--readout_p', '0.01'],
    ['--noise_p', '0.05', '--noise_traj', '4', '--zne', '1', '2'],
    ['--t1_us', '50', '--t2_us', '70', '--block_time_us', '1.5',
     '--noise_traj', '4'],
    ['--damp_gamma', '0.1', '--dephase_p', '0.02', '--noise_traj', '4',
     '--shots', '400'],
])
def test_infer_cli_noise_flags_predict(tmp_path, capsys, flags):
    data = _antideriv_data(tmp_path)
    argv = ['--ckpt', ANTIDERIV, '--data', data, '--device', 'cpu', *flags]
    preds = t_infer.main(argv)
    assert preds.shape == (6, 1) and np.isfinite(preds).all()
    np.testing.assert_array_equal(t_infer.main(argv), preds)   # replays
    ideal = t_infer.main(['--ckpt', ANTIDERIV, '--data', data,
                          '--device', 'cpu'])
    assert not np.array_equal(preds, ideal)
    out = capsys.readouterr().out
    if '--t1_us' in flags:
        g, p = t_noise.channel_params_from_t1t2(1.5, 50.0, 70.0)
        assert (f"T1/T2 : block=1.5us T1=50.0us T2=70.0us -> "
                f"damp_gamma={g} dephase_p={p}") in out
    if '--zne' in flags:
        assert 'ZNE   : Richardson extrapolation' in out
    with pytest.raises(SystemExit, match='block_time_us'):
        t_infer.main(['--ckpt', ANTIDERIV, '--data', data, '--device',
                      'cpu', '--t1_us', '50'])


def test_noise_checkpoint_name_loads_under_its_channel(tmp_path):
    """A _Noise… directory name loads as the noisy model; --noise_p 0
    forces the ideal one, as in the JAX package."""
    name = ('Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_Noise0.05R0.01G0.02'
            '_1000x100_Seed0')
    d = tmp_path / name
    d.mkdir()
    ckpt = d / 'best_model.npz'
    ckpt.write_bytes(open(ANTIDERIV, 'rb').read())
    model, cfg = t_infer.load_model(str(ckpt), 10, 1, device='cpu')
    m = model.measure
    assert (m.noise_p, m.readout_p, m.damp_gamma, m.noise_traj) == \
        (0.05, 0.01, 0.02, 32)
    data = _antideriv_data(tmp_path)
    noisy = t_infer.main(['--ckpt', str(ckpt), '--data', data, '--device',
                          'cpu', '--noise_traj', '4'])
    ideal = t_infer.main(['--ckpt', ANTIDERIV, '--data', data, '--device',
                          'cpu'])
    assert not np.array_equal(noisy, ideal)
    forced = t_infer.main(['--ckpt', str(ckpt), '--data', data, '--device',
                           'cpu', '--noise_p', '0', '--readout_p', '0',
                           '--damp_gamma', '0'])
    np.testing.assert_allclose(forced, ideal, atol=1e-6)
