"""
The registry of spans and counters (quanonet_torch/tracing.py): off by
default with a shared no-op span and counters that count all the same;
on under torch.profiler and inside ``tracing.enabled()``; the Solver's
step phases and the circuit's spans of a tiny epoch on the plain engines,
with their counts, parents, self times and rows; sessions that do not
mix; the launch counters' 13 keys.  The last test runs on a card only.
"""
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quanonet_torch import solver, tracing
from quanonet_torch.profile_step import LAUNCH_KEYS, launch_counts

N, BATCH, EPOCHS = 12, 5, 2            # 3 steps an epoch, the last padded
STEPS = EPOCHS * -(-N // BATCH)


@pytest.fixture(autouse=True)
def fresh_registry():
    tracing.reset()
    yield
    tracing.reset()


def _solver_epochs(engine, qubits=2, net=(2, 1, 2, 1)):
    """EPOCHS epochs of a tiny QuanONet through the Solver's own calls."""
    g = torch.Generator().manual_seed(3)
    branch, trunk = torch.rand(N, 6, generator=g), torch.rand(N, 1, generator=g)
    target = torch.rand(N, 1, generator=g)
    cfg = dict(model_type='QuanONet', num_qubits=qubits,
               net_size=list(net), scale_coeff=0.1,
               if_trainable_freq='true', ham_bound=[-5, 5], engine=engine,
               learning_rate=1e-2, lr_scheduler='cosine')
    model, _ = solver.build_model(
        cfg, {'train_branch_input': branch, 'train_trunk_input': trunk},
        device='cpu', generator=torch.Generator().manual_seed(0))
    opt = solver.build_optimizer(cfg, STEPS, model.parameters())
    segment = solver.make_run_segment(
        solver.make_train_epoch(model, opt, N, BATCH, 1), model)
    perms = [torch.randperm(N, generator=g) for _ in range(EPOCHS)]
    return segment(float('inf'), None, perms, (branch, trunk), target)


def test_off_span_is_the_shared_noop_and_counters_count():
    assert not tracing._registry.on()
    a, b = tracing.span('x'), tracing.span('y', rows=3, device=True)
    assert a is b
    with a:
        tracing.count('hea_chain_fwd', 2)
    tracing.count('hea_chain_fwd')
    snap = tracing.snapshot()
    assert snap['spans'] == {}
    assert snap['counters'] == {'hea_chain_fwd': 3}
    assert tracing.counts()['hea_chain_fwd'] == 3
    assert tracing.counts()['never_counted'] == 0
    _solver_epochs('pallas')
    assert tracing.snapshot()['spans'] == {}


def test_solver_epoch_under_the_profiler():
    """Each span is a CPU event of the trace that encloses the program's
    ops, and the snapshot holds each span's count, parents, self time and
    rows; on the CPU no span has device time."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solver_epochs('pallas')
    spans = tracing.snapshot()['spans']
    want = {  # name: (count, parents)
        'solver.step': (STEPS, {None: STEPS}),
        'solver.forward': (STEPS, {'solver.step': STEPS}),
        'solver.backward': (STEPS, {'solver.step': STEPS}),
        'solver.optimizer': (2 * STEPS, {'solver.step': 2 * STEPS}),
        'solver.epoch_end': (EPOCHS, {None: EPOCHS}),
        'solver.host_read': (EPOCHS, {'solver.epoch_end': EPOCHS}),
        'circuit.operands': (STEPS, {'solver.forward': STEPS}),
        'circuit.chain_fwd': (STEPS, {'solver.forward': STEPS}),
        'circuit.chain_bwd': (STEPS, {'solver.backward': STEPS}),
    }
    assert set(spans) == set(want)
    for name, (n, parents) in want.items():
        got = spans[name]
        assert (got['count'], got['parents']) == (n, parents), name
        assert 0 <= got['self_s'] <= got['host_s'], name
        assert got['device_s'] is None, name
    assert spans['solver.step']['rows'] == STEPS * BATCH
    assert spans['circuit.chain_fwd']['rows'] == STEPS * BATCH
    assert spans['circuit.chain_bwd']['rows'] == STEPS * BATCH
    assert spans['solver.forward']['rows'] is None
    # a step's self time is its host time less its children's
    children = sum(spans[k]['host_s'] for k in
                   ('solver.forward', 'solver.backward', 'solver.optimizer'))
    assert spans['solver.step']['self_s'] == pytest.approx(
        spans['solver.step']['host_s'] - children, rel=1e-9, abs=1e-9)
    assert spans['solver.host_read']['self_s'] == pytest.approx(
        spans['solver.host_read']['host_s'])
    events = [e for e in prof.events() if e.name in want]
    for name, (n, _) in want.items():
        mine = [e for e in events if e.name == name]
        assert len(mine) == n, name
        # each encloses the program's ops (torch ops or an inner span)
        assert all(e.cpu_children for e in mine), name


@pytest.mark.parametrize('engine,qubits,net', [
    ('pfused', 8, (1, 1, 1, 1)), ('embed', 2, (2, 1, 2, 1))])
def test_circuit_spans_carry_the_same_names_on_every_engine(engine, qubits,
                                                             net):
    with tracing.enabled():
        _solver_epochs(engine, qubits, net)
    spans = tracing.snapshot()['spans']
    for name in ('circuit.operands', 'circuit.chain_fwd',
                 'circuit.chain_bwd'):
        assert spans[name]['count'] == STEPS, (engine, name)
    assert spans['circuit.chain_fwd']['rows'] == STEPS * BATCH


def test_two_sessions_do_not_mix():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tracing.span('first'):
                pass
    assert tracing.snapshot()['spans']['first']['count'] == 3
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span('second', rows=4):
            pass
    spans = tracing.snapshot()['spans']
    assert set(spans) == {'second'} and spans['second']['rows'] == 4
    # the record stays readable after the session, until the next starts
    with tracing.span('after'):
        pass
    assert set(tracing.snapshot()['spans']) == {'second'}


def test_enabled_turns_tracing_on_without_a_profiler():
    with tracing.span('before'):
        pass
    with tracing.enabled():
        with tracing.span('outer', rows=2):
            with tracing.enabled():       # nested: the same record
                with tracing.span('inner'):
                    pass
    assert tracing.span('later') is tracing.span('other')
    spans = tracing.snapshot()['spans']
    assert set(spans) == {'outer', 'inner'}
    assert spans['inner']['parents'] == {'outer': 1}
    assert spans['outer']['rows'] == 2
    with tracing.enabled():               # a new outermost: starts anew
        pass
    assert tracing.snapshot()['spans'] == {}


def test_reset_zeroes_the_counters():
    tracing.count('adam_step', 5)
    with tracing.enabled():
        with tracing.span('s'):
            pass
    tracing.reset()
    assert tracing.snapshot() == {'spans': {}, 'counters': {}}


def test_launch_counts_has_the_13_keys_and_reads_the_registry():
    assert len(LAUNCH_KEYS) == 13
    assert launch_counts() == {k: 0 for k in LAUNCH_KEYS}
    tracing.count('fused_chain_bwd', 4)
    tracing.count('ucomp_bf16_fwd')
    assert {k: v for k, v in launch_counts().items() if v} == {
        'fused_chain_bwd': 4, 'ucomp_bf16_fwd': 1}


def test_threads_lose_no_count_and_keep_their_own_parents():
    """Counters and spans from more threads than cores, with a short
    switch interval: no lost update, and each thread's spans parented on
    its own stack."""
    threads, rounds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.enabled():
            def work(i):
                for _ in range(rounds):
                    tracing.count('c')
                    with tracing.span(f'outer{i}'):
                        with tracing.span('inner'):
                            pass
            pool = [threading.Thread(target=work, args=(i,))
                    for i in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    snap = tracing.snapshot()
    assert snap['counters']['c'] == threads * rounds
    assert snap['spans']['inner']['count'] == threads * rounds
    assert snap['spans']['inner']['parents'] == {
        f'outer{i}': rounds for i in range(threads)}


@pytest.mark.cuda
def test_device_seconds_on_the_card():
    """On a card, a circuit span's CUDA events give its device seconds,
    resolved by the snapshot; the chain's launches are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device time comes "
                    "from CUDA events")
    from quanonet_torch.ops import cuda_hea
    g = np.random.default_rng(0)
    mt = [torch.tensor(g.standard_normal((6, 32, 32)), dtype=torch.float32,
                       device='cuda') for _ in range(2)]
    phi = torch.tensor(g.standard_normal((6, 4096, 32)), dtype=torch.float32,
                       device='cuda')
    before = launch_counts()['hea_chain_fwd']
    with tracing.enabled():
        for _ in range(5):
            cuda_hea.block_chain(*mt, phi)
    spans = tracing.snapshot()['spans']
    assert launch_counts()['hea_chain_fwd'] == before + 5
    fwd = spans['circuit.chain_fwd']
    assert fwd['count'] == 5 and fwd['rows'] == 5 * 4096
    assert fwd['device_s'] is not None and fwd['device_s'] > 0
