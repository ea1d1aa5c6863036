"""
The port's inference and serving (quanonet_torch/infer.py, serve.py) on
the CPU, held against the JAX package's.

* The shipped Advection anchor (Q5 Net40-2-20-2) loaded by the port gives
  the JAX package's ``infer.predict`` to 1e-4.
* ``tests/fixtures/torch_port_advection_anchor.npz`` (64 seeded rows and
  the JAX package's predictions for them; the on-card smoke test holds the
  served output against it) still equals what JAX computes now.
* One port counterpart for each test of tests/test_serve.py, on the
  Antideriv checkpoint with ``device='cpu'``.

Regenerate the fixture only after re-validating the JAX reference:
    JAX_PLATFORMS=cpu python tests/test_torch_port_serve.py --regen
"""
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from quanonet_torch import infer as t_infer
from quanonet_torch.serve import Predictor, _buckets, make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANTIDERIV = os.path.join(
    REPO, 'pretrained_weights/Antideriv/'
    'Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_1000x100_Seed0/'
    'best_model.npz')
ADVECTION = os.path.join(
    REPO, 'pretrained_weights/Advection/'
    'Advection_QuanONet_Net40-2-20-2_Q5_TF_S0.1_1000x100_Seed0/'
    'best_model.ckpt')
FIXTURE = os.path.join(REPO, 'tests', 'fixtures',
                       'torch_port_advection_anchor.npz')


def anchor_inputs(n=64, seed=0):
    """Advection-shaped rows: smooth periodic u0 on 100 grid points
    (branch) and (x, t) in [0, 1]^2 (trunk)."""
    rng = np.random.RandomState(seed)
    xs = np.linspace(0.0, 1.0, 100)
    k = np.arange(1, 6)
    amp = rng.randn(n, 5) / k
    shift = rng.uniform(0, 2 * np.pi, (n, 5))
    branch = (amp[:, :, None] * np.sin(2 * np.pi * k[None, :, None]
                                       * xs[None, None, :]
                                       + shift[:, :, None])).sum(1)
    trunk = rng.rand(n, 2)
    return branch.astype(np.float32), trunk.astype(np.float32)


def jax_anchor_predictions(branch, trunk):
    from quanonet_tpu.infer import load_model, predict
    model, params, cfg = load_model(ADVECTION, branch_in=100, trunk_in=2)
    return predict(model, params, branch, trunk, cfg=cfg)


@pytest.fixture(scope='module')
def anchor():
    branch, trunk = anchor_inputs()
    return branch, trunk, jax_anchor_predictions(branch, trunk)


def test_fixture_equals_jax_today(anchor):
    branch, trunk, want = anchor
    d = np.load(FIXTURE)
    np.testing.assert_array_equal(d['branch'], branch)
    np.testing.assert_array_equal(d['trunk'], trunk)
    np.testing.assert_allclose(d['pred'], want, atol=1e-5)


def test_advection_anchor_matches_jax_predict(anchor):
    branch, trunk, want = anchor
    model, cfg = t_infer.load_model(ADVECTION, branch_in=100, trunk_in=2,
                                    device='cpu')
    assert cfg['engine'] == 'dense' and cfg['device'] == 'cpu'
    assert tuple(model.ansatz.shape) == (120, 3, 5)
    got = t_infer.predict(model, branch, trunk, cfg=cfg)
    assert got.shape == want.shape == (64, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_infer_cli_on_data_file(tmp_path):
    branch, trunk = anchor_inputs(8, seed=5)
    data = tmp_path / 'd.npz'
    np.savez(data, test_branch_input=branch, test_trunk_input=trunk,
             test_output=np.zeros((8, 1), np.float32))
    out = tmp_path / 'p.npy'
    preds = t_infer.main(['--ckpt', ADVECTION, '--data', str(data),
                          '--device', 'cpu', '--output', str(out)])
    model, cfg = t_infer.load_model(ADVECTION, 100, 2, device='cpu')
    np.testing.assert_allclose(np.load(out), preds, atol=0)
    np.testing.assert_allclose(
        preds, t_infer.predict(model, branch, trunk, cfg=cfg), atol=1e-6)
    # without --data or --branch the test set comes from the checkpoint
    # directory's name; a name that names no operator and model stops
    # the CLI, as in the JAX package
    unnamed = tmp_path / 'unnamed'
    unnamed.mkdir()
    shutil.copy(ADVECTION, unnamed / 'best_model.ckpt')
    with pytest.raises(SystemExit, match='--data'):
        t_infer.main(['--ckpt', str(unnamed / 'best_model.ckpt'),
                      '--device', 'cpu'])
    # --num_points_0 is parsed (it shapes the data generated from the
    # checkpoint name; with --data it is not read, as in the JAX package)
    again = t_infer.main(['--ckpt', ADVECTION, '--data', str(data),
                          '--device', 'cpu', '--num_points_0', '7'])
    np.testing.assert_array_equal(again, preds)


@pytest.mark.parametrize("flags", [
    ['--shots', '100'], ['--shot_seed', '3'], ['--noise_traj', '8'],
    ['--t1_us', '50', '--block_time_us', '1.5', '--noise_traj', '2'],
    ['--t2_us', '70', '--block_time_us', '1.5', '--noise_traj', '2'],
    ['--block_time_us', '1.5'],
    ['--noise_p', '0.01', '--noise_traj', '2'],
    ['--zne', '1', '2', '--noise_p', '0.01', '--noise_traj', '2'],
    ['--damp_gamma', '0.1', '--shots', '8', '--noise_traj', '2'],
])
def test_infer_cli_parses_every_reference_flag(tmp_path, flags):
    """Every flag of the JAX package's infer CLI parses and predicts:
    --shots / --shot_seed, and the noise-emulation flags, which raised
    NotImplementedError until they were ported."""
    from quanonet_tpu.infer import _parser as j_parser
    ref = {a.dest for a in j_parser()._actions}
    port = {a.dest for a in t_infer._parser()._actions}
    assert ref <= port
    branch, trunk = anchor_inputs(2, seed=1)
    data = tmp_path / 'd.npz'
    np.savez(data, test_branch_input=branch, test_trunk_input=trunk)
    argv = ['--ckpt', ADVECTION, '--data', str(data), '--device', 'cpu',
            *flags]
    preds = t_infer.main(argv)
    assert preds.shape == (2, 1) and np.isfinite(preds).all()
    # --noise_p 0 is the ideal model
    if flags[:2] == ['--noise_p', '0.01']:
        ideal = t_infer.main(['--ckpt', ADVECTION, '--data', str(data),
                              '--device', 'cpu'])
        np.testing.assert_array_equal(
            t_infer.main(['--ckpt', ADVECTION, '--data', str(data),
                          '--device', 'cpu', '--noise_p', '0']), ideal)


# ── counterparts of tests/test_serve.py ─────────────────────────────────────

def test_bucket_ladder():
    assert _buckets(8) == [1, 2, 4, 8]
    assert _buckets(100) == [1, 2, 4, 8, 16, 32, 64, 100]
    assert _buckets(1) == [1]


@pytest.fixture(scope='module')
def served():
    return Predictor(ANTIDERIV, branch_in=10, trunk_in=1, max_batch=16,
                     device='cpu')


def test_predictor_matches_infer_predict(served):
    rng = np.random.RandomState(0)
    b = rng.randn(7, 10).astype(np.float32)     # 7 -> bucket 8 (padded)
    t = rng.rand(7, 1).astype(np.float32)
    got = served.predict(b, t)
    model, cfg = t_infer.load_model(ANTIDERIV, branch_in=10, trunk_in=1,
                                    device='cpu')
    want = t_infer.predict(model, b, t, cfg=cfg)
    assert got.shape == want.shape == (7, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    from quanonet_tpu.infer import load_model, predict
    jm, jp, jcfg = load_model(ANTIDERIV, branch_in=10, trunk_in=1)
    np.testing.assert_allclose(got, predict(jm, jp, b, t, cfg=jcfg),
                               atol=1e-5)


def test_predictor_bucket_padding_is_inert(served):
    """Padded rows must not change the real rows' outputs."""
    rng = np.random.RandomState(1)
    b = rng.randn(3, 10).astype(np.float32)     # bucket 4
    t = rng.rand(3, 1).astype(np.float32)
    small = served.predict(b, t)
    big = served.predict(np.tile(b, (5, 1)),    # 15 rows -> bucket 16
                         np.tile(t, (5, 1)))
    np.testing.assert_allclose(big[:3], small, atol=1e-5)


def test_predictor_spans_multiple_chunks(served):
    rng = np.random.RandomState(2)
    n = 35                                       # > max_batch=16: 3 chunks
    b = rng.randn(n, 10).astype(np.float32)
    t = rng.rand(n, 1).astype(np.float32)
    out = served.predict(b, t)
    assert out.shape == (n, 1)
    one = served.predict(b[20:21], t[20:21])
    np.testing.assert_allclose(out[20:21], one, atol=1e-5)


def test_predictor_input_validation(served):
    with pytest.raises(ValueError, match="branch must be"):
        served.predict(np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="trunk must be"):
        served.predict(np.zeros((4, 10), np.float32),
                       np.zeros((3, 1), np.float32))
    with pytest.raises(ValueError, match="expects a trunk"):
        served.predict(np.zeros((4, 10), np.float32))


def _call(port, path, payload=None):
    url = f'http://127.0.0.1:{port}{path}'
    if payload is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip(served):
    srv = make_server(served, host='127.0.0.1', port=0)
    port = srv.server_port
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        code, health = _call(port, '/healthz')
        assert code == 200 and health == {"ok": True}

        rng = np.random.RandomState(3)
        b = rng.randn(5, 10).astype(np.float32)
        t = rng.rand(5, 1).astype(np.float32)
        code, resp = _call(port, '/predict', {"branch": b.tolist(),
                                              "trunk": t.tolist()})
        assert code == 200 and resp['n'] == 5
        assert resp['buckets'] == [8]      # 5 rows pad to the 8-bucket
        np.testing.assert_allclose(np.asarray(resp['pred']),
                                   served.predict(b, t), atol=1e-5)

        b2 = rng.randn(21, 10).astype(np.float32)
        t2 = rng.rand(21, 1).astype(np.float32)
        code, resp = _call(port, '/predict', {"branch": b2.tolist(),
                                              "trunk": t2.tolist()})
        assert code == 200 and resp['buckets'] == [16, 8]

        code, info = _call(port, '/info')
        assert code == 200 and info['branch_in'] == 10
        assert info['requests'] >= 1 and info['config']['device'] == 'cpu'

        code, err = _call(port, '/predict', {"branch": [[1.0, 2.0]]})
        assert code == 400 and 'branch must be' in err['error']

        code, _ = _call(port, '/nope')
        assert code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_buckets_for(served):
    assert served.buckets_for(5) == [8]
    assert served.buckets_for(16) == [16]
    assert served.buckets_for(17) == [16, 1]
    assert served.buckets_for(40) == [16, 16, 8]
    assert served.buckets_for(0) == [1]


def test_http_body_size_cap(served):
    """POST bodies over the cap are rejected with 413 before being read."""
    srv = make_server(served, host='127.0.0.1', port=0, max_body_bytes=1024)
    port = srv.server_port
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        big = {"branch": [[1.0] * 10] * 100, "trunk": [[0.5]] * 100}
        code, err = _call(port, '/predict', big)
        assert code == 413 and 'cap' in err['error']
        code, _ = _call(port, '/predict', {"branch": [[1.0] * 10],
                                           "trunk": [[0.5]]})
        assert code == 200
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


if __name__ == '__main__':
    import sys
    if '--regen' in sys.argv:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        branch, trunk = anchor_inputs()
        pred = jax_anchor_predictions(branch, trunk)
        np.savez(FIXTURE, branch=branch, trunk=trunk, pred=pred)
        print(f"wrote {FIXTURE}: pred {pred.ravel()[:3]}")
