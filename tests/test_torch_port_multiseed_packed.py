"""
The packed route of multi-seed training (quanonet_torch/multiseed.py
train_seeds_packed, models/packed.py), on the CPU.

* One packed step of S = 3 seeds against ``jax.vmap(jax.value_and_grad)``
  of the JAX model on the same stacked parameters (carried across by
  convert.py) and the same batches: losses 1e-5 relative, gradients
  1e-4 x max(1, max|g|) (fp32, other summation orders).
* The packed route against single runs of each seed end to end, with the
  card's limits (losses 1e-4 relative, rel-L2 1e-3 relative, best_model.npz
  5e-4 absolute); on the CPU the quantum models land bit-equal.
* The stacked compile (two launches' worth: the inner blocks with
  last = -1, the final ones with EVERY_BLOCK) against each seed's own
  compile, forward and w̄.
* Completed seeds skipped, a partial resume, one seed left to train
  (sequential, bit-equal to its single run), fresh data per seed, the
  routes that stay sequential, and FNN, DeepONet, FNO packed.
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
from quanonet_torch import cli
from quanonet_torch import multiseed as t_multiseed
from quanonet_torch.config import get_base_parser, load_config
from quanonet_torch.convert import state_dict_from_flax
from quanonet_torch.models import QuanONet
from quanonet_torch.models.packed import PackedModel
from quanonet_torch.ops import cuda_hea, cuda_ucomp
from quanonet_torch.ops import hea as t_hea

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PACKED_LOSS_RTOL = 1e-4
PACKED_REL_L2_RTOL = 1e-3
PACKED_PARAM_TOL = 5e-4

ARGV = ['--operator', 'Antideriv', '--model_type', 'QuanONet',
        '--net_size', '2', '1', '2', '1', '--num_qubits', '2',
        '--num_epochs', '3', '--num_train', '10', '--num_test', '5',
        '--num_points', '20', '--num_points_0', '5', '--num_cal', '50',
        '--train_sample_num', '5', '--test_sample_num', '5',
        '--batch_size', '20', '--learning_rate', '0.05', '--device', 'cpu']


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.chdir(tmp_path)
    np.random.seed(0)
    return tmp_path


def _artifacts(prefix, seed, operator='Antideriv'):
    base = os.path.join(prefix, operator)
    (run,) = [r for r in os.listdir(base) if r.endswith(f'_Seed{seed}')]
    with open(os.path.join(base, run, 'metric.json')) as f:
        m = json.load(f)
    with np.load(os.path.join(base, run, 'best_model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    return m['metrics'], m['history']['loss_train'], arrays


def _assert_seed_matches(single, packed, seed, operator='Antideriv'):
    m_s, l_s, a_s = _artifacts(single, seed, operator)
    m_p, l_p, a_p = _artifacts(packed, seed, operator)
    assert len(l_s) == len(l_p)
    np.testing.assert_allclose(l_p, l_s, rtol=PACKED_LOSS_RTOL, atol=0)
    assert abs(m_p['rel_l2'] - m_s['rel_l2']) <= \
        PACKED_REL_L2_RTOL * m_s['rel_l2']
    assert sorted(a_s) == sorted(a_p)
    for k in a_s:
        np.testing.assert_allclose(a_p[k], a_s[k], rtol=0,
                                   atol=PACKED_PARAM_TOL, err_msg=k)


def _config(argv):
    return load_config(get_base_parser().parse_args(argv))


# ── one packed step against jax.vmap ─────────────────────────────────────────

@pytest.mark.parametrize("engine,ucomp", [('dense', None), ('pallas', True)],
                         ids=['dense', 'pallas-stacked-compile'])
@pytest.mark.parametrize("nq,net", [(2, (5, 1, 5, 1)), (5, (4, 1, 4, 1))],
                         ids=['q2', 'q5'])
def test_packed_step_matches_jax_vmap(monkeypatch, nq, net, engine, ucomp):
    monkeypatch.setattr(cuda_hea, 'USE_UCOMP', ucomp)
    s, bs, bin_, tin = 3, 6, 7, 2
    rng = np.random.RandomState(nq)
    b = rng.randn(s, bs, bin_).astype(np.float32)
    t = rng.rand(s, bs, tin).astype(np.float32)
    y = rng.randn(s, bs, 1).astype(np.float32)
    jm = JQuanONet(num_qubits=nq, branch_input_size=bin_,
                   trunk_input_size=tin, net_size=net, scale_coeff=0.3,
                   engine='dense')
    keys = jnp.stack([jax.random.PRNGKey(10 + i) for i in range(s)])
    params = jax.vmap(lambda k: jm.init(k, jnp.asarray(b[0, :1]),
                                        jnp.asarray(t[0, :1])))(keys)

    def loss_fn(p, bb, tt, yy):
        return jnp.mean((jm.apply(p, bb, tt) - yy) ** 2)
    want_l, want_g = jax.vmap(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(b), jnp.asarray(t), jnp.asarray(y))

    models = []
    for i in range(s):
        m = QuanONet(nq, bin_, tin, net, scale_coeff=0.3, engine=engine,
                     device='cpu')
        m.load_state_dict(state_dict_from_flax(
            jax.tree_util.tree_map(lambda a: np.asarray(a[i]), params)))
        models.append(m)
    pack = PackedModel(models)
    loss = ((pack(torch.tensor(b), torch.tensor(t)) - torch.tensor(y)) ** 2
            ).mean(dim=(1, 2))
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_l),
                               rtol=LOSS_RTOL)
    grads = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want_g))
    for k, p in pack.params.items():
        g, w = p.grad.numpy(), grads[k].numpy()
        assert g.shape == w.shape, k
        tol = GRAD_RTOL * max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol, k


def test_stacked_compile_equals_each_seeds_compile():
    """compile_block_mats_stacked (the inner blocks with last = -1, the
    final ones with EVERY_BLOCK, joined by one cat) equals each seed's
    compile_block_mats, forward bit for bit, and carries w̄ back."""
    spec = t_hea.quanonet_spec(3, (2, 2, 3, 2))
    rng = np.random.RandomState(4)
    w = torch.tensor(rng.uniform(-np.pi, np.pi, (3,) + spec.weight_shape())
                     .astype(np.float32), requires_grad=True)
    g = [torch.tensor(rng.randn(3, spec.n_blocks, 8, 8).astype(np.float32))
         for _ in range(2)]
    mr, mi = cuda_ucomp.compile_block_mats_stacked(spec, w)
    (got,) = torch.autograd.grad((mr * g[0]).sum() + (mi * g[1]).sum(), w)
    for i in range(3):
        wi = w.detach()[i].clone().requires_grad_()
        r, im = cuda_ucomp.compile_block_mats(spec, wi)
        assert torch.equal(mr[i], r) and torch.equal(mi[i], im)
        (want,) = torch.autograd.grad((r * g[0][i]).sum()
                                      + (im * g[1][i]).sum(), wi)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), atol=1e-5)
    # one block: only the EVERY_BLOCK launch
    one = t_hea.quanonet_spec(2, (1, 1, 0, 0))
    w1 = torch.tensor(rng.uniform(-3, 3, (2, 1, 3, 2)).astype(np.float32))
    r1, _ = cuda_ucomp.compile_block_mats_stacked(one, w1)
    assert torch.equal(r1[1], cuda_ucomp.compile_block_mats(one, w1[1])[0])


def test_every_block_plain_version():
    """EVERY_BLOCK leaves every block's right factor I: each block equals
    that block compiled alone as the last one."""
    rng = np.random.RandomState(5)
    w = torch.tensor(rng.uniform(-3, 3, (6, 3, 3)).astype(np.float32))
    mr, mi = cuda_ucomp.ucomp_weights_dense(w, 2, cuda_ucomp.EVERY_BLOCK)
    for b in range(3):
        r, i = cuda_ucomp.ucomp_weights_dense(w[2 * b:2 * b + 2], 2, 0)
        assert torch.equal(mr[b], r[0]) and torch.equal(mi[b], i[0])
    with pytest.raises(ValueError, match='last must be'):
        cuda_ucomp._check_weights(w, 2, -3)


# ── end to end ───────────────────────────────────────────────────────────────

@pytest.mark.parametrize("flags,ucomp", [
    ([], None), (['--engine', 'pallas'], True),
    (['--num_qubits', '8'], None),
    (['--ham_pauli', 'X', '--num_qubits', '3'], None),
    (['--model_type', 'HEAQNN', '--net_size', '2', '1'], None),
], ids=['dense', 'pallas-stacked-compile', 'fused-q8', 'pauli-x', 'heaqnn'])
def test_packed_route_matches_single_runs(isolated, monkeypatch, flags,
                                          ucomp):
    monkeypatch.setattr(cuda_hea, 'USE_UCOMP', ucomp)
    argv = ARGV + flags
    for seed in (0, 1, 2):
        cli.main(argv + ['--seed', str(seed), '--prefix',
                         str(isolated / 'single')])
    calls = []
    monkeypatch.setattr(t_multiseed, 'train_seeds_sequential',
                        lambda c: calls.append(c))
    result = cli.main(argv + ['--multi_seed', '0', '1', '2', '--prefix',
                              str(isolated / 'packed')])
    assert not calls and sorted(result) == [0, 1, 2]
    for seed in (0, 1, 2):
        _assert_seed_matches(str(isolated / 'single'),
                             str(isolated / 'packed'), seed)
        assert result[seed]['train_samples_per_sec'] > 0
    assert _artifacts(str(isolated / 'packed'), 0)[1] != \
        _artifacts(str(isolated / 'packed'), 1)[1]


@pytest.mark.parametrize("model,flags", [
    ('FNN', ['--net_size', '2', '10']),
    ('DeepONet', ['--net_size', '2', '10']),
    ('FNO', ['--net_size', '4', '6', '2', '8', '--num_points', '20',
             '--num_points_0', '20']),
])
def test_classical_models_packed(isolated, model, flags):
    argv = ['--operator', 'Antideriv', '--model_type', model, *flags,
            '--num_epochs', '2', '--num_train', '10', '--num_test', '5',
            '--num_cal', '50', '--batch_size', '20',
            '--learning_rate', '0.01', '--device', 'cpu']
    for seed in (0, 1):
        cli.main(argv + ['--seed', str(seed), '--prefix',
                         str(isolated / 'single')])
    cli.main(argv + ['--multi_seed', '0', '1', '--prefix',
                     str(isolated / 'packed')])
    for seed in (0, 1):
        _assert_seed_matches(str(isolated / 'single'),
                             str(isolated / 'packed'), seed)


def test_completed_seeds_skipped_without_training(isolated):
    cfg = _config(ARGV + ['--multi_seed', '0', '1', '--prefix', 'outputs'])
    first = t_multiseed.train_multi_seed(dict(cfg))
    assert sorted(first) == [0, 1] and all(first.values())
    assert t_multiseed.train_multi_seed(dict(cfg)) == {0: None, 1: None}


def test_partial_resume_retrains_only_the_missing_seed(isolated):
    """tests/test_multiseed.py's partial resume: seed 1's marker removed,
    seed 0's artifacts untouched, seed 1 retrained to the same values."""
    cfg = _config(ARGV + ['--multi_seed', '0', '1', '--prefix', 'outputs'])
    t_multiseed.train_multi_seed(dict(cfg))
    base = os.path.join('outputs', 'Antideriv')
    runs = {s: os.path.join(base, r) for s in (0, 1) for r in os.listdir(base)
            if r.endswith(f'_Seed{s}')}
    os.remove(os.path.join(runs[1], 'metric.json'))
    w1_before = np.load(os.path.join(runs[1], 'best_model.npz'))[
        'QuanONet.weight']
    mtime0 = os.path.getmtime(os.path.join(runs[0], 'best_model.npz'))
    out = t_multiseed.train_multi_seed(dict(cfg))
    assert out[0] is None and out[1] is not None
    assert os.path.getmtime(os.path.join(runs[0], 'best_model.npz')) == \
        mtime0
    # seed 1 alone (its single run) draws what it drew in the pack of two
    np.testing.assert_allclose(
        np.load(os.path.join(runs[1], 'best_model.npz'))['QuanONet.weight'],
        w1_before, atol=PACKED_PARAM_TOL)


def test_one_seed_left_runs_as_its_single_run(isolated, monkeypatch):
    """One seed to train, given alone or left by a partial resume, takes
    the sequential route and lands bit-equal to its single run."""
    single, one, resume = (str(isolated / d)
                           for d in ('single', 'one', 'resume'))
    cli.main(ARGV + ['--seed', '1', '--prefix', single])
    cli.main(ARGV + ['--seed', '0', '--prefix', resume])
    monkeypatch.setattr(t_multiseed, 'train_seeds_packed',
                        lambda c: pytest.fail("packed route taken"))
    assert sorted(cli.main(ARGV + ['--multi_seed', '1', '--prefix', one])) \
        == [1]
    out = cli.main(ARGV + ['--multi_seed', '0', '1', '--prefix', resume])
    assert out[0] is None and out[1] is not None
    m_s, l_s, a_s = _artifacts(single, 1)
    for prefix in (one, resume):
        m, losses, arrays = _artifacts(prefix, 1)
        assert losses == l_s and m['rel_l2'] == m_s['rel_l2']
        assert sorted(arrays) == sorted(a_s)
        for k in a_s:
            np.testing.assert_array_equal(arrays[k], a_s[k], err_msg=k)


def test_fresh_data_packed_matches_sequential(isolated):
    """--multi_seed_fresh_data: each seed trains on its own dataset, the
    packed route as the sequential one does.  The shared run goes first,
    so that every later generation reads the same raw cache and draws
    only its split from its NumPy seed."""
    shared = _config(ARGV + ['--multi_seed', '0', '1', '--prefix',
                             str(isolated / 'shared')])
    t_multiseed.train_multi_seed(shared)
    argv = ARGV + ['--multi_seed', '0', '1', '--multi_seed_fresh_data',
                   'true']
    seq = _config(argv + ['--prefix', str(isolated / 'single')])
    t_multiseed.train_seeds_sequential(seq)
    cli.main(argv + ['--prefix', str(isolated / 'packed')])
    for seed in (0, 1):
        _assert_seed_matches(str(isolated / 'single'),
                             str(isolated / 'packed'), seed)
    # seed 1 trained on its own data, not on the shared dataset (drawn
    # with seed 0)
    assert _artifacts(str(isolated / 'packed'), 1)[1] != \
        _artifacts(str(isolated / 'shared'), 1)[1]


@pytest.mark.parametrize("flags", [
    ['--noise_p', '0.01', '--noise_traj', '2'],
    ['--grad_method', 'shift'],
    ['--grad_method', 'spsa'],
    ['--grad_method', 'spsa', '--train_shots', '16'],
    ['--save_state', 'true'],
], ids=['noise', 'shift', 'spsa', 'train-shots', 'save-state'])
def test_routes_that_stay_sequential(isolated, monkeypatch, flags):
    calls = []
    monkeypatch.setattr(t_multiseed, 'train_seeds_packed',
                        lambda c: pytest.fail("packed route taken"))
    monkeypatch.setattr(t_multiseed, 'train_seeds_sequential',
                        lambda c: calls.append(c) or {})
    cfg = _config(ARGV + flags + ['--multi_seed', '0', '1'])
    assert t_multiseed.sequential_reason(cfg)
    t_multiseed.train_multi_seed(cfg)
    assert len(calls) == 1
    assert t_multiseed.sequential_reason(_config(ARGV)) is None


def test_packed_model_refuses_sampled_models():
    m = QuanONet(2, 3, 1, (1, 1, 1, 1), shots=10, device='cpu')
    with pytest.raises(ValueError, match='not packed'):
        PackedModel([m])


def test_profile_seedpack_on_the_cpu(tmp_path, monkeypatch):
    """profile_seedpack's sweep on the plain versions, at a narrow model:
    both arms timed for each S, the packed losses finite, its own JSON
    written, and no kernel counted (the CPU takes the plain versions)."""
    from quanonet_torch import profile_seedpack
    monkeypatch.setattr(profile_seedpack, 'NUM_QUBITS', 2)
    monkeypatch.setattr(profile_seedpack, 'NET_SIZE', (2, 1, 2, 1))
    out = tmp_path / 'sp.json'
    res = profile_seedpack.main(['--device', 'cpu', '--iters', '2',
                                 '--rounds', '1', '--seeds', '1,2',
                                 '--bs', '10', '--out', str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert sorted(res['packs']) == ['1', '2'] and res['platform'] == 'cpu'
    for row in res['packs'].values():
        for arm in ('packed', 'sequential'):
            assert row[arm]['ms_per_step'] > 0
            assert not any(row[arm]['launches_per_step'].values())
        assert row['packed']['losses_finite']
