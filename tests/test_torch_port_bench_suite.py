"""
The port's bench suite (quanonet_torch/bench_suite.py) on the CPU: its
four metric names are the JAX script's (read from the root
bench_suite.py's text, not imported); the training line through the
port's DataManager, QuanONet and make_train_epoch at a test size (a few
hundred rows, 2 epochs), the inference line on the Q2 anchor and the
generation line at 64 functions give finite values; the baselines are the
JAX script's reference-CPU ones.
"""
import os
import re

import numpy as np
import torch

from quanonet_torch import bench_suite as bs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
NAME = re.compile(r'"((?:quanonet|datagen)_[a-z0-9_]+)"')


def test_metric_names_are_the_jax_scripts():
    with open(os.path.join(REPO, 'bench_suite.py')) as f:
        jax_names = set(NAME.findall(f.read()))
    with open(bs.__file__) as f:
        port_names = set(NAME.findall(f.read()))
    assert len(jax_names) == 4
    assert port_names == jax_names
    with open(os.path.join(REPO, 'bench_suite.py')) as f:
        text = f.read()
    for base in (bs.BASELINE_TRAIN_SPS, bs.BASELINE_INFER_PPS,
                 bs.BASELINE_DATAGEN_FPS):
        assert f"{base:.1f}" in text


def test_train_line(tmp_path):
    line = bs.train_bench(
        "quanonet_q5_antideriv_train_samples_per_sec_per_chip", 'Antideriv',
        (2, 1, 2, 1), dict(num_train=30, num_test=10, num_points=100,
                           num_points_0=100, train_sample_num=10,
                           test_sample_num=10),
        epochs=2, timed_epochs=1, device=CPU, data_dir=str(tmp_path))
    assert line['train_samples'] == 300 and line['epochs'] == 2
    assert line['unit'] == 'samples/sec' and line['value'] > 0
    assert np.isfinite(line['rel_l2']) and np.isfinite(line['final_loss'])
    assert line['engine'] == 'dense' and line['nvidia_smi'] is None
    assert line['vs_baseline'] == line['value'] / bs.BASELINE_TRAIN_SPS


def test_inference_and_datagen_lines():
    inf = bs.inference_bench(2000, CPU)
    assert inf['metric'] == "quanonet_q2_inference_points_per_sec"
    assert inf['points'] == 2000 and np.isfinite(inf['value'])
    gen = bs.datagen_bench(CPU, sizes=(32, 64))
    assert gen['metric'] == "datagen_antideriv_functions_per_sec"
    assert set(gen['functions_per_sec_by_size']) == {'32', '64'}
    assert gen['value'] == gen['functions_per_sec_by_size']['64'] > 0
