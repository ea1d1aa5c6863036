"""
The port's out-of-distribution study (quanonet_torch/ood.py, the
repository's visualization.ipynb) on the CPU against the JAX package:
for both shipped anchors (Advection, RDiffusion) and both inputs (sin 2πx,
sin 4πx), the port's truth against the JAX solvers
(quanonet_tpu.data.generation.solve_advection_pde /
solve_rdiffusion_pde) to 1e-5, and its predictions on the notebook's grid
against ``quanonet_tpu.infer.predict`` to 1e-4 (the served-prediction
limit); ``tests/fixtures/torch_port_ood.npz`` (the JAX predictions the
on-card smoke test holds the port against) still equals what JAX computes
now; the CLI writes its JSON and arrays; ``--plot`` draws the figure.

Regenerate the fixture only after re-validating the JAX reference:
    JAX_PLATFORMS=cpu python tests/test_torch_port_ood.py --regen
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from quanonet_torch import ood

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'torch_port_ood.npz')
TRUTH_TOL = 1e-5
PRED_TOL = 1e-4
CASES = [(op, key) for op in ood.CONFIGS for _, key, _ in ood.OOD_INPUTS]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Torch on one thread here: these runs are many small ops, whose
    thread-pool barriers stall when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u0(key):
    return next(u0 for _, k, u0 in ood.OOD_INPUTS if k == key)


def jax_truth(op, u0):
    from quanonet_tpu.data import generation as gen
    if op == 'Advection':
        return gen.solve_advection_pde(100, u0_cal=u0.copy())[0]
    return gen.solve_rdiffusion_pde(100, 0.2, u0_cal=u0.copy())[0]


def jax_cases_of(op):
    """{(op, key): (truth, prediction)} of the notebook's run_case on the
    JAX package, one load of the anchor for both inputs."""
    from quanonet_tpu.infer import load_model, predict
    model, params, cfg = load_model(ood.CONFIGS[op]['ckpt'], branch_in=100,
                                    trunk_in=2)
    out = {}
    for _, key, u0 in ood.OOD_INPUTS:
        truth = jax_truth(op, u0)
        branch, trunk = ood.grid_inputs(u0, *truth.shape)
        pred = predict(model, params, branch, trunk, cfg=cfg,
                       batch_size=4096)
        out[(op, key)] = truth, np.asarray(pred).reshape(truth.shape)
    return out


@pytest.fixture(scope='module')
def port():
    return ood.study(list(ood.CONFIGS), device='cpu')


@pytest.fixture(scope='module')
def jax_cases():
    return {case: v for op in ood.CONFIGS
            for case, v in jax_cases_of(op).items()}


@pytest.mark.parametrize("op,key", CASES)
def test_truth_matches_jax_solvers(port, op, key):
    _, arrays = port
    want = jax_truth(op, _u0(key))
    assert arrays[f"{op}/{key}/truth"].shape == want.shape == (100, 100)
    np.testing.assert_allclose(arrays[f"{op}/{key}/truth"], want, rtol=0,
                               atol=TRUTH_TOL)


@pytest.mark.parametrize("op,key", CASES)
def test_predictions_match_jax_predict(port, jax_cases, op, key):
    rows, arrays = port
    truth, want = jax_cases[(op, key)]
    got = arrays[f"{op}/{key}/pred"]
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_TOL)
    row = next(r for r in rows if (r['operator'], r['key']) == (op, key))
    assert row['grid'] == [100, 100] and row['engine'] == 'dense'
    assert row['rel_l2'] == pytest.approx(ood.rel_l2(want, truth), abs=1e-5)
    np.testing.assert_array_equal(arrays[f"{op}/{key}/err"],
                                  np.abs(got - arrays[f"{op}/{key}/truth"]))


def test_fixture_equals_jax_today(jax_cases):
    d = np.load(FIXTURE)
    assert sorted(d.files) == sorted(f"{op}/{key}" for op, key in CASES)
    for (op, key), (_, want) in jax_cases.items():
        np.testing.assert_allclose(d[f"{op}/{key}"], want, rtol=0, atol=1e-6)


def test_cli_writes_json_arrays_and_plot(tmp_path):
    """One operator through the CLI on the CPU: the JSON's rows, the .npz
    of the same name, and the figure where matplotlib is installed (the
    option raises without it)."""
    out = tmp_path / 'ood_torch.json'
    png = tmp_path / 'ood.png'
    argv = ['--operator', 'RDiffusion', '--device', 'cpu', '--out', str(out),
            '--plot', str(png)]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            ood.main(argv)
        return
    assert ood.main(argv) == 0
    res = json.loads(out.read_text())
    assert [r['input'] for r in res['rows']] == ['sin(2πx)', 'sin(4πx)']
    assert all(np.isfinite(r['rel_l2']) for r in res['rows'])
    arrays = np.load(tmp_path / 'ood_torch.npz')
    assert len(arrays.files) == 6 and png.stat().st_size > 0


if __name__ == '__main__':
    if '--regen' in sys.argv:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        preds = {f"{op}/{key}": pred.astype(np.float32)
                 for op in ood.CONFIGS
                 for (op, key), (_, pred) in jax_cases_of(op).items()}
        np.savez_compressed(FIXTURE, **preds)
        print(f"wrote {FIXTURE}: {sorted(preds)}")
