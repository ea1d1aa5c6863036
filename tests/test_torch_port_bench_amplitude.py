"""
The port's amplitude bench (quanonet_torch/bench_amplitude.py) on the CPU,
held against the JAX package: the sharded forward at Q8 Net2-2-2-2 on two
gloo ranks against the port's unsharded 'fused' engine and the JAX
package's hea_expectation(engine='fused'); the traffic rows against the
exchanges the engine counted (and the JAX model's k + 1 ring exchanges a
sublayer against the k the engines move); one shard's forward under
virtual_global k = 1, 2, 3 against the JAX package's
make_sharded_hea(..., virtual_global=k) on a one-device CPU mesh; the
shard-compute rows' fields and gates, the CLI's file, and --table's
markdown in the JAX scripts' columns.  Outputs 1e-5
(fp32, other summation order).
"""
import ast
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from quanonet_torch import bench_amplitude as ba
from quanonet_torch.ops import hea as t_hea
from quanonet_torch.parallel import comm
from quanonet_torch.parallel.amplitude import make_sharded_hea
from quanonet_tpu.ops import hea as j_hea
from quanonet_tpu.parallel import amplitude as j_amp

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = (8, (2, 2, 2, 2), 3)
CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def amp():
    """Q8 Net2-2-2-2 batch 3 on two gloo ranks: (rows, outputs)."""
    return ba.amp_rows([2], CPU, [(*CASE, True)], timeout_s=60)


def _jax_fused(nq, net, batch):
    spec, w, x, diag = ba.circuit(nq, net, batch)
    return np.asarray(j_hea.hea_expectation(
        j_hea.quanonet_spec(nq, net), jnp.asarray(w), jnp.asarray(x),
        diag=jnp.asarray(diag), engine='fused'))


def test_amp_against_fused_and_jax(amp):
    rows, outputs = amp
    (row,) = rows
    assert row['kind'] == 'correctness' and row['reference'] == 'fused'
    assert row['devices'] == 2 and row['backend'] == 'gloo'
    assert row['local_amplitudes'] == 2 ** 7
    assert row['max_err_vs_single_device'] <= TOL
    assert row['out_finite'] and row['ranks_agree'] and row['within_tol']
    ref = ba.unsharded(*ba.circuit(*CASE), CPU)[0]
    want = _jax_fused(*CASE)
    np.testing.assert_allclose(ref, want, rtol=0, atol=TOL)
    for out in outputs[(2, 0)]:
        np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
        np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
    assert all(ba.gates({'rows': rows}).values())


def test_traffic_rows_are_the_counted_exchanges(amp):
    """Each rank's counted exchanges equal the row's ppermutes; the bytes
    and link time follow from them; the JAX model counts one more ring
    exchange a sublayer than the engines move (k + 1 against k)."""
    (row,) = amp[0]
    assert row['exchanges_counted'] == [row['ppermutes_per_fwd']] * 2
    assert row['traffic_is_counted']
    spec = t_hea.quanonet_spec(CASE[0], CASE[1])
    assert row['bytes_per_sample'] == row['ppermutes_per_fwd'] * 2 ** 7 * 8
    assert row['link_us_per_sample_serialized'] == pytest.approx(
        row['bytes_per_sample'] / ba.LINK_BYTES_PER_S * 1e6)
    jax_model = j_amp.sharded_collective_counts(
        j_hea.quanonet_spec(CASE[0], CASE[1]), 2)
    assert jax_model['ppermutes'] - row['ppermutes_per_fwd'] == \
        spec.total_sublayers
    assert jax_model['bytes_per_sample'] // jax_model['ppermutes'] == \
        row['bytes_per_sample'] // row['ppermutes_per_fwd']


@pytest.mark.parametrize("k", [1, 2, 3])
def test_virtual_global_against_jax(k):
    """One shard's forward (virtual_global=k), the bench's shard-compute
    call, against the JAX package's on a one-device CPU mesh."""
    nq, net, batch = 8, (2, 2, 2, 2), 4
    spec, w, x, diag = ba.circuit(nq, net, batch)
    local = diag[:2 ** (nq - k)]
    f = make_sharded_hea(spec, comm.Group(), fused=True, virtual_global=k)
    with torch.no_grad():
        got = f(torch.as_tensor(w), torch.as_tensor(x), torch.as_tensor(local))
    mesh = Mesh(np.asarray(jax.devices()[:1]), ('amp',))
    g = j_amp.make_sharded_hea(j_hea.quanonet_spec(nq, net), mesh,
                               fused=True, virtual_global=k)
    want = np.asarray(g(jnp.asarray(w), jnp.asarray(x), jnp.asarray(local)))
    assert f.local_dim == 2 ** (nq - k)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_shard_compute_row(k):
    """The shard-compute row keeps the JAX row's fields; its gates hold
    (finite (batch, 1), local state 2^(n-k), the exchanges counted as a
    2^k-way run's); no 'pfused' arm and no device numbers on the CPU."""
    row = ba.shard_compute_row(8, (2, 2, 2, 2), 4, k, 2, CPU, rounds=2)
    for key in ('per_shard_compute_ms_per_sample', 'ppermutes_per_fwd',
                'compute_us_per_ppermute_interval', 'one_shard_exchange_us',
                'compute_hides_comm', 'link_us_per_sample_serialized'):
        assert key in row
    assert row['local_amplitudes'] == row['engine_local_amplitudes'] == \
        2 ** (8 - k)
    assert row['shards'] == 2 ** k and len(row['shard_ms_rounds']) == 2
    assert row['pfused_ms'] is None and row['peak_memory_bytes'] is None
    assert row['device_busy'] == "not measured: CPU run"
    assert row['one_shard_exchange_us'] == pytest.approx(
        2 ** (8 - k) * 8 / ba.LINK_BYTES_PER_S * 1e6)
    assert all(ba.gates({'shard_compute': [row]}).values())


def test_cli_writes_its_file(tmp_path, monkeypatch):
    monkeypatch.setattr(ba, 'SHARD_CASES', [(8, (2, 2, 2, 2), 4, 2, 2)])
    out = tmp_path / 'shard_compute_torch.json'
    assert ba.main(['--shard-compute', '--device', 'cpu', '--out',
                    str(out)]) == 0
    res = json.loads(out.read_text())
    assert res['platform'] == 'cpu' and res['nvidia_smi'] is None
    assert res['link_bytes_per_s'] == ba.LINK_BYTES_PER_S
    assert len(res['shard_compute']) == 1 and all(res['gates'].values())


def _jax_headers(script):
    """The markdown header rows a JAX script prints under --table."""
    with open(os.path.join(REPO, script)) as f:
        text = f.read()
    return [ast.literal_eval(f"({h})").strip() for h in re.findall(
        r'print\(("\\n\| Qubits.*?")\)', text, re.DOTALL)]


def _cells(line):
    return [c.strip() for c in line.strip().strip('|').split('|')]


@pytest.mark.parametrize("kind", ['traffic', 'shard_compute'])
def test_table(amp, kind, capsys, tmp_path, monkeypatch):
    """--table: the JAX scripts' markdown tables (bench_amplitude.py's
    traffic rows, bench_shard_compute.py's shard rows) in their columns,
    a line a row with the row's numbers, printed before the last line."""
    if kind == 'traffic':
        result = {'rows': amp[0]}
        (jax_header,) = [h for h in _jax_headers('bench_amplitude.py')
                         if 'ppermutes/fwd' in h]
    else:
        result = {'shard_compute': [ba.shard_compute_row(
            8, (2, 2, 2, 2), 4, 2, 2, CPU, rounds=1)]}
        (jax_header,) = _jax_headers('bench_shard_compute.py')
    header, rule, *rows = ba.table(result)
    assert len(_cells(header)) == len(_cells(jax_header)) == 6
    assert _cells(header)[0] == 'Qubits' and 'H100' in header
    assert rule == '|---' * 6 + '|'
    (row,) = result.get('rows') or result['shard_compute']
    (line,) = rows
    cells = _cells(line)
    assert cells[0] == '8' and len(cells) == 6
    if kind == 'traffic':
        assert cells[1] == f"2^8/2 = {2 ** 7:,}"
        assert cells[2] == str(row['ppermutes_per_fwd'])
        assert cells[5].startswith('≤')
    else:
        assert cells[1] == f"{2 ** 6:,}"
        assert cells[5] in ('yes', 'no')
        monkeypatch.setattr(ba, 'SHARD_CASES', [(8, (2, 2, 2, 2), 4, 2, 1)])
        assert ba.main(['--shard-compute', '--table', '--device', 'cpu',
                        '--out', str(tmp_path / 's.json')]) == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert json.loads(out[-1])['shard_compute']
        assert _cells(out[-4]) == _cells(header) and out[-3] == rule
        assert _cells(out[-2])[0] == '8'
