"""A tiny copy of the benchmark for the CPU tests: the repo's
BENCHMARK.json and portbench/ in a temporary directory, each
configuration cut to 4 qubits and 40 blocks and each mix to a few hundred
rows, run by the harness on the CPU with the program's plain engines.
The copy also lists the parked serving cell (PARKED), whose files
portbench/ keeps for a later benchmark to list again (PERF.md)."""
import json
import os
import shutil

import torch

from portbench import harness
from portbench.frozen import inputs
from portbench.kinds import serve_open

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CONFIG = dict(num_qubits=4, net_size=[10, 2, 10, 2])
TINY_TRAFFIC = {
    'train_b1000': dict(functions=40, points=5, batch=50),
    'score_grid': dict(functions=10, points=20, chunk=50,
                       check_block_rows=100),
    'serve_open': dict(rate=40, k_max=4, max_batch=64, pool=32,
                       points=10, check_requests=4),
}

# the serving cell under Poisson arrivals, out of BENCHMARK.json while its
# tail spreads wider than a bound can hold (PERF.md, Open questions)
PARKED = {
    'workloads': [dict(name='q10_serve_open', config='q10_circuit_net20-2-40-2',
                       traffic='serve_open', chips=1,
                       why='Predictor under open-loop Poisson arrivals')],
    'end_to_end': [dict(name='serve_p95_ms', unit='ms', better='lower',
                        bound=0.25, source='host_clock',
                        workloads=['q10_serve_open'])],
    'per_layer': [
        dict(name='service_ms_p50.serve', unit='ms', better='lower',
             source='host_clock', layer='serving', moves='serve_p95_ms',
             workloads=['q10_serve_open']),
        dict(name='idle_share.serve', unit='%', better='lower',
             source='device_trace', layer='device', moves='serve_p95_ms',
             workloads=['q10_serve_open'])],
}


def _edit(path, **changes):
    with open(path) as fh:
        data = json.load(fh)
    data.update(changes)
    with open(path, 'w') as fh:
        json.dump(data, fh)
    return data


def tiny_tree(tmp_path):
    """The tiny copy's root."""
    root = str(tmp_path / 'tree')
    shutil.copytree(os.path.join(REPO, 'portbench'),
                    os.path.join(root, 'portbench'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), root)
    with open(os.path.join(root, 'BENCHMARK.json')) as fh:
        bench = json.load(fh)
    for key, entries in PARKED.items():
        bench[key] += entries
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as fh:
        json.dump(bench, fh)
    for c in bench['configs']:
        cfg = _edit(os.path.join(root, c['file']), engine='auto',
                    **TINY_CONFIG)
        if cfg['weights'] != 'seeded':
            write_ckpt(cfg, os.path.join(root, 'portbench', 'configs',
                                         cfg['weights']))
    for mix, changes in TINY_TRAFFIC.items():
        _edit(os.path.join(root, 'portbench', 'traffic', f'{mix}.json'),
              **changes)
    return root


def write_ckpt(config, path):
    """Seeded weights for ``config`` as a MindSpore .ckpt at ``path``."""
    from quanonet_torch.checkpoint import save_ms_ckpt
    params = inputs.quanonet_params(config, 5, 'cpu')
    save_ms_ckpt(path, {serve_open.RAW_NAMES[k]:
                        (v.reshape(-1) if k == 'ansatz' else v).numpy()
                        for k, v in params.items()})


def run(root, workload, seed=2 ** 31 + 17, seconds=0.3, trace=0):
    """One run of a workload of the tiny copy on the CPU: its result."""
    import time
    cell = harness.Workload(root, workload)
    return harness.run_cell(cell, seed, seconds, trace, torch.device('cpu'),
                            time.perf_counter())
