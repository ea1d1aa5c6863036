"""
The slice that runs the fused-group engines (8..16 qubits) in the port —
models, one optimiser step, the training CLI, infer and the served path's
fixture — on the CPU, held against the JAX package on the same NumPy
inputs (the engines themselves: tests/test_torch_port_fused.py).

* a Q8 QuanONet through ``convert`` against the JAX model (outputs and
  every parameter's gradient), one Adam step against optax's, one epoch of
  the CLI, ``infer.load_model`` against JAX's ``infer.predict``;
* ``tests/fixtures/torch_port_q10_fused.npz`` (64 seeded rows, seeded Q10
  Net40-2-20-2 weights and the JAX package's predictions for them; the
  on-card smoke test holds the served Q10 output against it) still equals
  what JAX computes now.

Tolerances: 1e-4 on outputs and predictions (fp32 through up to 120
sublayers, summed in another order than XLA's), 2e-4 on parameter
gradients (as the engine tests), 1e-5 on parameters after one Adam step.

Regenerate the fixture only after re-validating the JAX reference:
    JAX_PLATFORMS=cpu python tests/test_torch_port_fused_slice.py --regen
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import quanonet_torch.data.generation as t_gen
from quanonet_tpu import infer as j_infer
from quanonet_tpu.models import QuanONet as JQuanONet
from quanonet_torch import checkpoint as t_ckpt
from quanonet_torch import cli
from quanonet_torch import infer as t_infer
from quanonet_torch.convert import raw_from_state_dict, state_dict_from_flax
from quanonet_torch.models import QuanONet
from quanonet_torch.solver import build_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'torch_port_q10_fused.npz')
Q10_RUN = 'Advection_QuanONet_Net40-2-20-2_Q10_TF_S0.1_1000x100_Seed0'
EXP_TOL = 1e-4
GRAD_TOL = 2e-4
PARAM_TOL = 1e-5


# ── the slice: models, one optimiser step, the CLI, infer ────────────────────

Q8 = dict(num_qubits=8, branch_input_size=6, trunk_input_size=2,
          net_size=(3, 2, 2, 1), scale_coeff=0.3)


def _q8_pair():
    rng = np.random.RandomState(8)
    b = rng.randn(5, 6).astype(np.float32)
    t = rng.rand(5, 2).astype(np.float32)
    y = rng.randn(5, 1).astype(np.float32)
    jm = JQuanONet(**Q8)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(b), jnp.asarray(t))
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)
    return jm, params, b, t, y


@pytest.mark.parametrize("engine", ['auto', 'pfused'])
def test_q8_quanonet_matches_jax(engine):
    """A Q8 QuanONet loaded through convert: outputs and every parameter's
    gradient equal the JAX model's (engine 'auto' is the JAX package's
    'fused' on the CPU); the weights carry across unchanged in shape."""
    jm, params, b, t, y = _q8_pair()
    want_out = np.asarray(jm.apply(params, jnp.asarray(b), jnp.asarray(t)))
    jgrads = jax.grad(lambda p: jnp.mean(
        (jm.apply(p, jnp.asarray(b), jnp.asarray(t)) - y) ** 2))(params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))

    model = QuanONet(**Q8, engine=engine, device='cpu')
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert tuple(sd['ansatz'].shape) == (8, 3, 8)
    model.load_state_dict(sd)
    out = model(torch.tensor(b), torch.tensor(t))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=EXP_TOL)
    ((out - torch.tensor(y)) ** 2).mean().backward()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   atol=GRAD_TOL, err_msg=k)


def test_q8_adam_step_equals_optax():
    jm, params, b, t, y = _q8_pair()
    opt = optax.adam(0.01)
    grads = jax.grad(lambda p: jnp.mean(
        (jm.apply(p, jnp.asarray(b), jnp.asarray(t)) - y) ** 2))(params)
    upd, _ = opt.update(grads, opt.init(params), params)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, upd)))
    model = QuanONet(**Q8, engine='pfused', device='cpu')
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    topt = build_optimizer(dict(optimizer='adam', learning_rate=0.01), 1,
                           model.parameters())
    loss = ((model(torch.tensor(b), torch.tensor(t)) - torch.tensor(y))
            ** 2).mean()
    topt.zero_grad()
    loss.backward()
    topt.step()
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=PARAM_TOL,
                                   err_msg=k)


def test_q8_cli_epoch_and_infer_match_jax(tmp_path, monkeypatch):
    """One epoch of the training CLI at Q8 on the CPU writes both checkpoint
    formats; infer.load_model of best_model.ckpt reproduces the Solver's
    predictions and the JAX package's infer.predict of the same file."""
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.chdir(tmp_path)
    np.random.seed(0)
    solver = cli.main([
        '--operator', 'Antideriv', '--model_type', 'QuanONet',
        '--net_size', '2', '1', '2', '1', '--num_qubits', '8',
        '--num_epochs', '1', '--num_train', '6', '--num_test', '3',
        '--num_points', '20', '--num_cal', '50', '--train_sample_num', '5',
        '--test_sample_num', '5', '--batch_size', '10',
        '--prefix', str(tmp_path / 'out'), '--device', 'cpu'])
    assert solver.model.engine == 'auto'
    exp_dir = solver.exp_logger.exp_dir
    ckpt = os.path.join(exp_dir, 'best_model.ckpt')
    assert os.path.exists(ckpt) and os.path.exists(
        ckpt.replace('.ckpt', '.npz'))
    b, t = solver.test_inputs
    model, cfg = t_infer.load_model(ckpt, b.shape[1], t.shape[1],
                                    device='cpu')
    assert cfg['engine'] == 'fused' and cfg['num_qubits'] == 8
    got = t_infer.predict(model, b, t, cfg=cfg)
    np.testing.assert_array_equal(got, solver.predict_test())
    jm, jp, jcfg = j_infer.load_model(ckpt, b.shape[1], t.shape[1])
    np.testing.assert_allclose(got, j_infer.predict(jm, jp, b, t, cfg=jcfg),
                               atol=EXP_TOL)


def test_qubit_scaling_bench_rows(monkeypatch, capsys):
    """python -m quanonet_torch.bench_qubit_scaling: the JAX bench's rows
    and FLOP model, one JSON line per row with its keys; an engine that
    does not take the width ('embed' at 8 qubits) is reported and skipped,
    not rerouted."""
    import bench_qubit_scaling as j_bench
    from quanonet_torch import bench_qubit_scaling as t_bench
    assert [(q, n, e, b, t, s) for q, n, e, b, t, s in t_bench.CONFIGS] == \
        [(q, tuple(n), e, b, t, s) for q, n, e, b, t, s in
         [(5, (40, 2, 20, 2), ('pallas', 'embed', 'fused'), 100, True, 200),
          (8, (40, 2, 20, 2), ('pallas', 'fused', 'pfused'), 100, True, 100),
          (10, (40, 2, 20, 2), ('dense', 'fused', 'pfused'), 100, True, 20),
          (11, (10, 2, 10, 2), ('pfused', 'fused'), 100, True, 20),
          (12, (10, 2, 10, 2), ('fused', 'pfused'), 100, True, 20),
          (13, (10, 2, 10, 2), ('pfused', 'fused'), 100, True, 20),
          (14, (5, 2, 5, 2), ('pfused', 'fused'), 32, True, 10),
          (16, (5, 2, 5, 2), ('fused',), 16, True, 10),
          (15, (5, 2, 5, 2), ('pfused', 'fused'), 16, False, 10),
          (16, (5, 2, 5, 2), ('pfused', 'fused'), 8, False, 10)]]
    for q, net, engines, _, train, _ in t_bench.CONFIGS:
        for e in engines:
            assert t_bench.model_flops_per_sample(q, net, e, train) == \
                j_bench.model_flops_per_sample(q, net, e, train)
    monkeypatch.setattr(t_bench, 'CONFIGS', [
        (8, (1, 1, 1, 1), ('fused', 'pfused', 'embed'), 4, True, 2),
        (9, (1, 1, 1, 1), ('pfused',), 3, False, 2)])
    rows = t_bench.run(t_bench.parser().parse_args(
        ['--quick', '--device', 'cpu']))
    assert [(r['qubits'], r['engine'], r['mode']) for r in rows] == [
        (8, 'fused', 'train'), (8, 'pfused', 'train'), (9, 'pfused', 'forward')]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == rows
    for r in rows:
        assert r['value'] > 0 and r['unit'] == 'samples/sec'
        assert r['metric'] == (f"qubit_scaling_q{r['qubits']}_{r['engine']}"
                               f"_{'train' if r['mode'] == 'train' else 'fwd'}")


# ── the Q10 fixture of the served path ───────────────────────────────────────

def q10_inputs(n=64, seed=10):
    """Advection-shaped rows, smooth periodic u0 on 100 grid points
    (branch) and (x, t) in [0, 1]^2 (trunk), and seeded Q10 Net40-2-20-2
    weights in the port's state_dict keys."""
    rng = np.random.RandomState(seed)
    xs = np.linspace(0.0, 1.0, 100)
    k = np.arange(1, 6)
    amp = rng.randn(n, 5) / k
    shift = rng.uniform(0, 2 * np.pi, (n, 5))
    branch = (amp[:, :, None] * np.sin(2 * np.pi * k[None, :, None]
                                       * xs[None, None, :]
                                       + shift[:, :, None])).sum(1)
    branch = branch.astype(np.float32)
    trunk = rng.rand(n, 2).astype(np.float32)
    sd = {'ansatz': rng.uniform(-np.pi, np.pi, (120, 3, 10)),
          'bias': np.asarray(0.05),
          'branch_freq.weights': 0.1 * (1 + 0.2 * rng.randn(400)),
          'branch_freq.bias': rng.uniform(-np.pi, np.pi, 400),
          'trunk_freq.weights': 0.1 * (1 + 0.2 * rng.randn(200)),
          'trunk_freq.bias': rng.uniform(-np.pi, np.pi, 200)}
    return branch, trunk, {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _q10_ckpt(tmp, sd):
    run = os.path.join(tmp, Q10_RUN)
    os.makedirs(run, exist_ok=True)
    path = os.path.join(run, 'best_model.ckpt')
    t_ckpt.save_ms_ckpt(path, raw_from_state_dict(
        {k: torch.tensor(v) for k, v in sd.items()}, 'QuanONet'))
    return path


def jax_q10_predictions(tmp, branch, trunk, sd):
    """The JAX package's predictions ('auto', its 'fused' on the CPU) from
    the checkpoint file the port writes for these weights."""
    model, params, cfg = j_infer.load_model(_q10_ckpt(tmp, sd), 100, 2)
    return np.asarray(j_infer.predict(model, params, branch, trunk, cfg=cfg))


def test_q10_fixture_equals_jax_today(tmp_path):
    branch, trunk, sd = q10_inputs()
    d = np.load(FIXTURE)
    np.testing.assert_array_equal(d['branch'], branch)
    np.testing.assert_array_equal(d['trunk'], trunk)
    for k, v in sd.items():
        np.testing.assert_array_equal(d['sd.' + k], v)
    want = jax_q10_predictions(str(tmp_path), branch, trunk, sd)
    np.testing.assert_allclose(d['pred'], want, atol=1e-5)
    # the port's plain path serves the same checkpoint to the fixture's
    # tolerance on the card (1e-4)
    model, cfg = t_infer.load_model(_q10_ckpt(str(tmp_path), sd), 100, 2,
                                    device='cpu')
    assert cfg['engine'] == 'fused' and tuple(model.ansatz.shape) == (120, 3,
                                                                       10)
    np.testing.assert_allclose(
        t_infer.predict(model, branch[:16], trunk[:16], cfg=cfg),
        d['pred'][:16], atol=EXP_TOL)


if __name__ == '__main__':
    import sys
    import tempfile
    if '--regen' in sys.argv:
        jax.config.update('jax_platforms', 'cpu')
        branch, trunk, sd = q10_inputs()
        with tempfile.TemporaryDirectory() as tmp:
            pred = jax_q10_predictions(tmp, branch, trunk, sd)
        np.savez(FIXTURE, branch=branch, trunk=trunk, pred=pred,
                 **{'sd.' + k: v for k, v in sd.items()})
        print(f"wrote {FIXTURE}: pred {pred.ravel()[:3]}")
