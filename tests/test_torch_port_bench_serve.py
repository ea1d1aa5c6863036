"""
The port's serving bench (quanonet_torch/bench_serve.py) on the CPU, on
the JAX script's default checkpoint (the Q2 Antideriv anchor) with
``--max_batch 64 --reps 2 --device cpu``: its file has the JAX file's keys
(docs/serving.json), one row a bucket of the ladder and the HTTP row; every
timed request and the HTTP answer equal Predictor.predict's bit for bit,
and the Predictor answers the JAX package's predictions within 1e-5; no
device memory on the CPU.
"""
import json
import os

import numpy as np
import pytest

from quanonet_torch import bench_serve
from quanonet_torch.serve import Predictor
from quanonet_tpu import infer as j_infer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp('serve') / 'serving_torch.json'
    assert bench_serve.main(['--max_batch', '64', '--reps', '2', '--device',
                             'cpu', '--out', str(out)]) == 0
    return json.loads(out.read_text())


def test_keys_are_the_jax_files(result):
    with open(os.path.join(REPO, 'docs', 'serving.json')) as f:
        jax_file = json.load(f)
    assert set(jax_file) <= set(result)
    assert set(jax_file['buckets'][0]) <= set(result['buckets'][0])
    assert [r['bucket'] for r in result['buckets']] == [1, 2, 4, 8, 16, 32,
                                                        64]
    assert np.isfinite(result['http_overhead_ms_at_64'])
    assert result['http_bucket'] == 64
    assert result['platform'] == 'cpu' and result['nvidia_smi'] is None
    assert result['ckpt'].startswith('Antideriv_QuanONet_Net5-1-5-1_Q2')
    for row in result['buckets']:
        assert row['latency_ms'] > 0 and row['peak_memory_bytes'] is None
        assert row['rows_per_sec'] == pytest.approx(
            row['bucket'] / row['latency_ms'] * 1e3)


def test_outputs_equal_predictor_predict(result):
    """The bench's gates held; its Predictor answers the JAX package's
    predictions on the same rows within 1e-5."""
    assert result['gates'] == {"timed requests equal Predictor.predict": True,
                               "HTTP answer equals Predictor.predict": True}
    pred = Predictor(bench_serve.DEFAULT_CKPT, 10, 1, max_batch=64,
                     device='cpu')
    rng = np.random.RandomState(0)
    branch = rng.randn(37, 10).astype(np.float32)
    trunk = rng.rand(37, 1).astype(np.float32)
    model, params, cfg = j_infer.load_model(bench_serve.DEFAULT_CKPT, 10, 1)
    want = np.asarray(j_infer.predict(model, params, branch, trunk, cfg=cfg))
    np.testing.assert_allclose(pred.predict(branch, trunk), want, rtol=0,
                               atol=1e-5)
