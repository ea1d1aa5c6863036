"""
Open-loop serving cells: ``serve.Predictor.predict`` in process, NumPy in
and NumPy out, under requests that arrive on a schedule whatever the
server is doing (independent users).

The Predictor serialises device work under one lock, so a server with a
queue is one worker taking requests first come, first served.  This
driver is that worker: it takes request i at its due time, or at once if
it is late, and a request's latency is its return time minus its due
time, so a stall counts against every request it delays.  How late the
driver itself woke for a request that found the server idle (its lag) is
reported beside the numbers.

Each request carries k input functions x ``points`` points, k on
1..k_max with probability in proportion to 1/k; ``rate`` requests a
second, a number fixed in the traffic file (0.8 of the highest rate at
which the backlog did not grow, found once by a sweep on the card).  Set-up
writes the seeded weights as a checkpoint under $TMPDIR and warms only the
buckets the schedule uses.  A sample of ``check_requests`` answered
requests, drawn from the seed and with the largest among them, is held
against the reference.

The arrivals are a Poisson process (``frozen/inputs.open_loop_schedule``).

Traffic keys: rate, points, k_max, max_batch, pool (input functions to
draw from), check_requests.
"""
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench.frozen import inputs, work
from portbench.kinds import Stages
from portbench.reference import quanonet as reference

SPIN_S = 0.002

# the released file's names (the repo's checkpoint schema) of the leaves
RAW_NAMES = {
    'ansatz': 'QuanONet.weight', 'bias': 'bias',
    'branch_freq.weights': 'branch_LinearLayer.Net2.weights',
    'branch_freq.bias': 'branch_LinearLayer.Net2.bias',
    'trunk_freq.weights': 'trunk_LinearLayer.Net2.weights',
    'trunk_freq.bias': 'trunk_LinearLayer.Net2.bias',
}


def write_checkpoint(params, directory):
    """The weights as a reference-schema .npz; returns its path."""
    raw = {RAW_NAMES[k]: v.detach().cpu().numpy()
           for k, v in params.items()}
    raw['QuanONet.weight'] = raw['QuanONet.weight'].reshape(-1)
    path = os.path.join(directory, 'best_model.npz')
    np.savez(path, **raw)
    return path


def _wait_until(t):
    """Sleep to within SPIN_S of perf_counter time t, then spin to it: the
    server is idle here, and a sleep alone wakes up to milliseconds late."""
    ahead = t - time.perf_counter() - SPIN_S
    if ahead > 0:
        time.sleep(ahead)
    while time.perf_counter() < t:
        pass


def serve_schedule(traffic, seed, seconds):
    """(due seconds, k, first pool index) of each request of a window."""
    count = max(1, int(round(traffic['rate'] * seconds)))
    due, ks = inputs.open_loop_schedule(seed, count, seconds,
                                        traffic['k_max'])
    rng = np.random.default_rng(inputs.sub_seed(seed, inputs.STREAM_ORDER))
    first = rng.integers(0, traffic['pool'], count)
    return due, ks, first


class Cell:
    def __init__(self, config, traffic, seed, device, seconds, root):
        stage = Stages('serve')
        from quanonet_torch.serve import Predictor
        stage('import the program')
        self.config, self.traffic, self.device = config, traffic, device
        self.params = inputs.quanonet_params(config, seed, device)
        self.tmp = tempfile.mkdtemp(prefix='portbench-serve-')
        path = write_checkpoint(self.params, self.tmp)
        self.pred = Predictor(
            path, inputs.SENSORS, 1, max_batch=traffic['max_batch'],
            device=str(device), model_type='QuanONet',
            num_qubits=config['num_qubits'],
            net_size=list(config['net_size']),
            scale_coeff=config['scale_coeff'], if_trainable_freq=True,
            ham_bound=list(config['ham_bound']), engine=config['engine'])
        stage('predictor')
        self.pool = inputs.function_pool(seed, traffic['pool'], device)
        self.due, self.ks, self.first = serve_schedule(traffic, seed,
                                                       seconds)
        rows = self.ks * traffic['points']
        rng = np.random.default_rng(inputs.sub_seed(seed,
                                                    inputs.STREAM_TRAFFIC))
        largest = int(np.argmax(rows))
        others = rng.permutation(np.delete(np.arange(rows.size), largest))
        self.checked = set([largest] + list(
            others[:traffic['check_requests'] - 1]))
        self.answers = {}
        self.buckets = sorted({b for r in rows
                               for b in self.pred.buckets_for(int(r))})
        stage('requests')
        for _ in range(2):
            self.warm_unit()
        stage('buckets warmed twice')

    def request(self, i):
        return inputs.request_rows(self.pool, int(self.first[i]),
                                   int(self.ks[i]), self.traffic['points'])

    def warm_unit(self):
        """Every bucket the schedule uses, once."""
        for b in self.buckets:
            self.pred.predict(np.zeros((b, inputs.SENSORS), np.float32),
                              np.zeros((b, 1), np.float32))

    def run_window(self, seconds):
        """Every request due in the window, each from its due time on."""
        latency, service, lag, failed = [], [], [], 0
        t0 = time.perf_counter()
        for i, due in enumerate(self.due):
            branch, trunk = self.request(i)
            now = time.perf_counter() - t0
            if now < due:
                _wait_until(t0 + due)
            start = time.perf_counter() - t0
            if now < due:
                lag.append(start - due)
            try:
                out = self.pred.predict(branch, trunk)
            except Exception as err:     # a failed request misses every limit
                print(f"request {i} failed: {err!r}", file=sys.stderr)
                failed += 1
                latency.append(float('inf'))
                continue
            end = time.perf_counter() - t0
            latency.append(end - due)
            service.append(end - start)
            if i in self.checked:
                self.answers[i] = out[:, 0]
        elapsed = time.perf_counter() - t0
        rows = int((self.ks * self.traffic['points']).sum())
        flops, nbytes = work.circuit_work(self.config, rows, False)
        lag_ms = 1e3 * np.array(lag or [0.0])
        service_ms = 1e3 * np.array(service or [0.0])
        print(f"generator lag: {len(lag)} of {len(self.due)} requests found "
              f"the server idle; their lag p50 {np.median(lag_ms):.4f} ms, "
              f"max {lag_ms.max():.4f} ms; service p50 "
              f"{np.median(service_ms):.4f} ms, mean {service_ms.mean():.4f} "
              f"ms; served by {elapsed:.3f} s", file=sys.stderr)
        return dict(kind='serve', seconds=elapsed, rows=rows,
                    units=len(self.due), attempted=len(self.due),
                    failed=failed, flops=flops, bytes=nbytes,
                    latency_ms=[1e3 * v for v in latency],
                    service_ms=[1e3 * v for v in service],
                    lag_ms=lag_ms.tolist())

    def free(self):
        del self.pred
        shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self, limits, tf32=False):
        """[(name, value, limit)]: the widest gap of a sampled answer from
        the reference's, and the sampled requests that never returned.
        ``tf32`` puts the TF32 control in the program's place."""
        ref = reference.QuanONet(self.config, self.device)
        ctl = reference.QuanONet(self.config, self.device, tf32=True)
        block = self.traffic['max_batch']
        gap, missing = 0.0, 0
        for i in sorted(self.checked):
            branch, trunk = (torch.as_tensor(a, device=self.device)
                             for a in self.request(i))
            want = ref.predict(self.params, branch, trunk, block)
            if tf32:
                got = ctl.predict(self.params, branch, trunk, block)
            elif i in self.answers:
                got = self.answers[i]
            else:
                missing += 1
                continue
            gap = max(gap, float(np.abs(got - want).max()))
        return [('pred_gap', gap, limits['pred_gap']),
                ('missing_answers', missing, 0)]
