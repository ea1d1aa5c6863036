"""The frozen yardstick on the CPU: the circuit's work count against a
brute-force count of its gates, the busy time as a union of intervals, the
open loop's latency from the due time, the schedule's Poisson arrivals
and fixed work, and the reference against a dense statevector."""
import functools
import math
import time

import numpy as np
import pytest
import torch

from portbench.frozen import busy, inputs, readings, work
from portbench.kinds import serve_open
from portbench.reference import quanonet as reference

COST = {'H': 4, 'RX_PHASE': 6, 'RY': 6, 'RZ': 6, 'CNOT': 0}


def _gates(n, lds):
    """The circuit's gates one by one, as the work count describes them."""
    for ld in lds:
        yield from ['H'] * n + ['RX_PHASE']
        for _ in range(ld):
            yield from ['RY', 'RZ', 'RY'] * n
            yield from ['CNOT'] * n


@pytest.mark.parametrize('n,net', [(2, [1, 1, 1, 1]), (2, [3, 2, 2, 1]),
                                   (3, [2, 2, 3, 2]), (3, [1, 3, 0, 1])])
def test_work_count_is_the_brute_force_gate_count(n, net):
    config = {'num_qubits': n, 'net_size': net}
    lds = [net[3]] * net[2] + [net[1]] * net[0]
    brute = sum(COST[g] for g in _gates(n, lds)) * 2 ** n
    assert work.forward_flops_per_row(n, work.block_lds(config)) == brute
    flops, nbytes = work.circuit_work(config, 7, train=False)
    assert flops == 7 * brute
    angles, weights = 7 * n * len(lds), 3 * n * sum(lds)
    assert nbytes == 4 * (angles + weights + 7)
    flops_t, bytes_t = work.circuit_work(config, 7, train=True)
    assert flops_t == 3 * flops
    assert bytes_t == nbytes + 4 * (7 + 2 * angles + 2 * weights)


def test_the_flagship_counts():
    q5 = {'num_qubits': 5, 'net_size': [40, 2, 20, 2]}
    q10 = {'num_qubits': 10, 'net_size': [20, 2, 40, 2]}
    assert work.forward_flops_per_row(5, work.block_lds(q5)) == 395_520
    assert work.forward_flops_per_row(10, work.block_lds(q10)) == 24_944_640
    assert work.PEAK_FLOPS == 165e12
    assert work.least_seconds(165e12, 1.0) == 1.0
    assert work.least_seconds(1.0, 3.35e12) == 1.0


class _Event:
    def __init__(self, name, start, dur, cuda, annotation=False):
        self._v = (name, start, dur, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (busy.DeviceType.CUDA if self._v[3]
                else busy.DeviceType.CPU)

    def is_user_annotation(self):
        return self._v[4]


def test_busy_time_is_the_union_of_the_rows():
    events = [
        _Event(busy.WINDOW_SPAN, 100, 1000, False, True),
        _Event('step', 100, 1000, False, True),
        _Event('aten::copy_', 460, 30, False),
        _Event('k1', 50, 150, True),            # cut to [100, 200)
        _Event('k2', 150, 100, True),           # overlaps k1 (two streams)
        _Event('k1', 700, 100, True),
        _Event('span on the card', 0, 2000, True, True),   # not a row
        _Event('k3', 1200, 50, True),           # after the window
    ]
    s = busy.summarize(events)
    assert s['window_s'] == 1000 / 1e9
    assert s['busy_s'] == (250 - 100 + 100) / 1e9
    assert s['device_rows'] == 3
    assert s['device_ops'] == [['k1', 200 / 1e9], ['k2', 100 / 1e9]]
    assert s['idle_gaps'][0] == ['aten::copy_', 450 / 1e9]
    assert s['idle_gaps'][1] == ['step', 300 / 1e9]
    record = dict(s, flops=0, bytes=0, units=2, kind='train')
    assert readings.idle_share(record) == pytest.approx(75.0)
    assert readings.rows_per_unit(record) == 1.5


def test_readers_read_nothing_without_a_trace():
    record = {'kind': 'train', 'units': 3, 'flops': 1.0, 'bytes': 1.0}
    for read in (readings.idle_share, readings.rows_per_unit, readings.mfu,
                 readings.circuit_roofline):
        assert read(record) is None


def test_the_schedule_is_the_same_work_for_every_seed():
    due_a, k_a = inputs.open_loop_schedule(1, 4000, 40.0, 32)
    due_b, k_b = inputs.open_loop_schedule(2 ** 31 + 99, 4000, 40.0, 32)
    assert sorted(k_a) == sorted(k_b) and not np.array_equal(k_a, k_b)
    assert k_a.min() == 1 and k_a.max() == 32
    assert not np.allclose(due_a, due_b)
    for due in (due_a, due_b):
        assert (np.diff(due) >= 0).all() and 0 < due[0] and due[-1] < 40.0
        # Poisson arrivals: exponential gaps (coefficient of variation 1),
        # and counts a second that spread as a Poisson count (variance
        # about the mean), not evened out
        gaps = np.diff(due)
        assert np.std(gaps) / np.mean(gaps) == pytest.approx(1.0, abs=0.1)
        counts = np.bincount(due.astype(int), minlength=40)
        assert np.var(counts) / np.mean(counts) == pytest.approx(1.0,
                                                                abs=0.6)


class _SlowPredictor:
    """Answers after ``service`` seconds of the caller's time."""

    def __init__(self, service):
        self.service = service

    def predict(self, branch, trunk):
        end = time.perf_counter() + self.service
        while time.perf_counter() < end:
            pass
        return np.zeros((branch.shape[0], 1), np.float32)


def test_open_loop_latency_counts_from_the_due_time(capsys):
    run = serve_open.Cell.__new__(serve_open.Cell)
    run.pred = _SlowPredictor(0.05)
    run.config = {'num_qubits': 2, 'net_size': [1, 1, 1, 1]}
    run.traffic = {'points': 2}
    run.pool = np.zeros((4, inputs.SENSORS), np.float32)
    # the second request is due while the first is served: it waits
    run.due = np.array([0.01, 0.02, 0.2])
    run.ks = np.array([1, 1, 2])
    run.first = np.zeros(3, int)
    run.checked, run.answers = {2}, {}
    w = run.run_window(0.2)
    lat, svc = w['latency_ms'], w['service_ms']
    assert svc[0] == pytest.approx(50, abs=10)
    assert lat[1] == pytest.approx(lat[0] + svc[1] - 10, abs=5)
    assert lat[1] > svc[1] + 30
    assert len(w['lag_ms']) == 2          # requests 0 and 2 found it idle
    assert max(w['lag_ms']) < 20
    assert 2 in run.answers and w['attempted'] == 3
    assert 'generator lag: 2 of 3' in capsys.readouterr().err


def _dense_expectation(config, params, branch, trunk):
    """The circuit by dense 2^n x 2^n gates (NumPy, complex128)."""
    n = config['num_qubits']
    model = reference.QuanONet(config, 'cpu')
    x = model.angles(params, branch, trunk).double().numpy()
    w = params['ansatz'].double().numpy()
    eye = np.eye(2)

    def on(q, g):
        return functools.reduce(np.kron, [g if i == q else eye
                                          for i in reversed(range(n))])

    def rx(t):
        c, s = math.cos(t / 2), math.sin(t / 2)
        return np.array([[c, -1j * s], [-1j * s, c]])

    def ry(t):
        c, s = math.cos(t / 2), math.sin(t / 2)
        return np.array([[c, -s], [s, c]])

    def rz(t):
        return np.diag([np.exp(-0.5j * t), np.exp(0.5j * t)])

    dim = 2 ** n
    ring = np.eye(dim)
    for i in range(n):
        c = (i + 1) % n
        perm = np.zeros((dim, dim))
        for k in range(dim):
            perm[k ^ (((k >> c) & 1) << i), k] = 1
        ring = perm @ ring
    lo, hi = config['ham_bound']
    zsum = np.array([sum(1 - 2 * ((k >> i) & 1) for i in range(n))
                     for k in range(dim)])
    diag = (lo + hi) / 2 + (hi - lo) / 2 / n * zsum
    bd, bld, td, tld = config['net_size']
    out = []
    for row in x:
        psi = np.zeros(dim, complex)
        psi[0] = 1
        s = 0
        for b, ld in enumerate([tld] * td + [bld] * bd):
            for j in range(n):
                psi = on(j, rx(row[b * n + j])) @ psi
            for t in range(s, s + ld):
                for q in range(n):
                    psi = on(q, ry(w[t, 2, q]) @ rz(w[t, 1, q])
                             @ ry(w[t, 0, q])) @ psi
                psi = ring @ psi
            s += ld
        out.append(np.sum(np.abs(psi) ** 2 * diag))
    return np.array(out) + float(params['bias'])


@pytest.mark.parametrize('n,net', [(2, [2, 2, 3, 1]), (3, [1, 2, 2, 1])])
def test_the_reference_is_the_dense_statevector(n, net):
    config = dict(num_qubits=n, net_size=net, scale_coeff=0.7,
                  ham_bound=[-5, 5])
    params = inputs.quanonet_params(config, 11, 'cpu')
    params['bias'] = torch.tensor(0.25)
    branch, trunk, _ = inputs.antideriv_set(3, 3, 2, 'cpu')
    want = _dense_expectation(config, params, branch, trunk)
    got = reference.QuanONet(config, 'cpu').predict(params, branch, trunk, 4)
    assert np.abs(got - want).max() < 2e-6
    ctl = reference.QuanONet(config, 'cpu', tf32=True).predict(
        params, branch, trunk, 4)
    assert np.abs(ctl - want).max() > 1e-4


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -3.1415927])
    got = reference.round_tf32(x)
    assert got[:4].tolist() == [1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9]
    assert abs(got[4] + 3.1415927) < 2 ** -9 * 2
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
