"""
The port's Q10 step profiler (quanonet_torch/profile_q10.py) on the CPU at
Q8 Net4-2-4-2, batch 16, through the kernels' plain versions ('pfused' ->
fused_gates.chain_fused_x): its full_step is the Solver's step (losses
bit-equal to make_train_epoch's over 5 steps, both engines), its fwd_full
is fused_gates.forward_fused bit for bit and every ablation is finite and
removes something; the port's forward_fused against the JAX package's on
the same NumPy arrays (1e-5); the output files.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanonet_torch import profile_q10 as pq
from quanonet_torch.ops import fused_gates as t_fg
from quanonet_torch.ops.hea import quanonet_spec as t_spec
from quanonet_tpu.ops import fused_gates as j_fg
from quanonet_tpu.ops.hea import quanonet_spec as j_spec

NQ, NET, BATCH, ITERS = 8, (4, 2, 4, 2), 16, 2
CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def profiles():
    return pq.run(NQ, NET, BATCH, ITERS, CPU)


def test_full_step_is_the_solvers_step(profiles):
    for res in profiles:
        par = res['solver_parity']
        assert par['steps'] == 5 and par['bit_equal']
        assert par['full_step_losses'] == par['solver_losses']
        assert np.isfinite(par['full_step_losses']).all()
        assert res['gates']["full_step is the Solver's step"]


def test_components_and_gates(profiles):
    pfused, fused = profiles
    assert set(pfused['ms_per_call']) == {
        'full_step', 'fwd_bwd', 'fwd_infer', 'build_unitaries',
        'phases_tiling'}
    assert set(fused['ms_per_call']) == {
        'fwd_full', 'fwd_no_ring', 'fwd_no_hadamard', 'fwd_no_diag',
        'fwd_group0_only', 'build_unitaries', 'full_step'}
    for res in profiles:
        assert all(res['gates'].values()), res['gates']
        assert res['meta']['platform'] == 'cpu'
        assert res['meta']['nvidia_smi'] is None
        for row in res['ms_per_call'].values():
            assert row['ms'] > 0
            assert row['launches_per_call'] == {}       # plain versions
            assert row['device_busy'] == "not measured: CPU run"
    assert fused['fwd_full_bit_equal']
    assert all(fused['ablations_finite'].values())


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    spec = t_spec(NQ, NET)
    w = rng.uniform(-np.pi, np.pi, spec.weight_shape()).astype(np.float32)
    x = rng.uniform(-2, 2, (BATCH, spec.n_blocks * NQ)).astype(np.float32)
    return spec, w, x


def test_forward_fused_against_jax():
    spec, w, x = _inputs()
    with torch.no_grad():
        got = t_fg.forward_fused(spec, torch.as_tensor(w), torch.as_tensor(x))
        ablated = pq.ablated_forward(spec, torch.as_tensor(w),
                                     torch.as_tensor(x))
    want = j_fg.forward_fused(j_spec(NQ, NET), jnp.asarray(w), jnp.asarray(x))
    for a, b, c in zip(got, ablated, want):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ['fwd_no_ring', 'fwd_no_hadamard',
                                  'fwd_no_diag', 'fwd_group0_only'])
def test_each_ablation_removes_its_stage(name):
    spec, w, x = _inputs()
    w, x = torch.as_tensor(w), torch.as_tensor(x)
    with torch.no_grad():
        full = pq.ablated_forward(spec, w, x)
        cut = pq.ablated_forward(spec, w, x, pq.ABLATIONS[name])
    assert all(torch.isfinite(t).all() for t in cut)
    assert not torch.equal(full[0], cut[0])


def test_cli_writes_both_files(tmp_path):
    pf, fu = tmp_path / 'pf.json', tmp_path / 'fu.json'
    assert pq.main(['--qubits', '8', '--net', '2,1,2,1', '--batch', '4',
                    '--iters', '1', '--device', 'cpu', '--out_pfused',
                    str(pf), '--out_fused', str(fu)]) == 0
    for path, engine in ((pf, 'pfused'), (fu, 'fused')):
        res = json.loads(path.read_text())
        assert res['meta']['engine'] == engine
        assert res['meta']['qubits'] == 8 and res['meta']['batch'] == 4
