"""
Boundaries of the port: it imports nothing of JAX or of the JAX package,
its entry points refuse to fall back to the CPU, engines route as the JAX
package's do, and every engine and model type of the JAX package is
honoured.
"""
import os
import subprocess
import sys

import pytest
import torch

from quanonet_torch import resolve_device
from quanonet_torch.ops.hea import resolve_engine, resolve_inference_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANTIDERIV = os.path.join(
    REPO, 'pretrained_weights/Antideriv/'
    'Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_1000x100_Seed0/'
    'best_model.npz')

_IMPORT_ALL = r"""
import pkgutil, sys
import quanonet_torch
names = [m.name for m in pkgutil.walk_packages(quanonet_torch.__path__,
                                                'quanonet_torch.')]
for name in names:
    __import__(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'quanonet_tpu'))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 39


_IMPORT_KERNEL_MODULES = r"""
import sys
from quanonet_torch import profile_step
from quanonet_torch.models import classical
from quanonet_torch.ops import (
    _build, cuda_adam, cuda_embed, cuda_hea, cuda_ucomp,
)
assert _build._loaded == {}, _build._loaded
assert cuda_hea.USE_UCOMP is None
assert 'triton' not in sys.modules
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'quanonet_tpu'))
assert not bad, bad
for mod in (cuda_ucomp, cuda_adam, cuda_embed):
    print(_build.build_dir(mod.KERNEL))
"""


def test_new_kernel_modules_import_clean():
    """Importing the compile, Adam and embed-chain wrappers, the classical
    models and profile_step imports
    no JAX, loads no library and builds nothing; USE_UCOMP is None (auto:
    the compile kernels for CUDA weights) unless the environment sets it."""
    env = {k: v for k, v in os.environ.items()
           if k not in ('PYTHONPATH', 'USE_UCOMP')}
    out = subprocess.run([sys.executable, '-c', _IMPORT_KERNEL_MODULES],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    dirs = out.stdout.split()
    assert len(dirs) == 3
    if not torch.cuda.is_available():
        assert not any(os.path.exists(d) for d in dirs)


_IMPORT_QPU_MODULES = r"""
import sys
from quanonet_torch import backend, compare_engines, multiseed
from quanonet_torch.ops import _build, mitigation, noise, param_shift, sampling
assert _build._loaded == {}, _build._loaded
assert noise.routes == {'fold': 0, 'plain': 0}, noise.routes
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'quanonet_tpu', 'qiskit', 'pennylane',
                                    'mindspore', 'deepxde', 'triton'))
assert not bad, bad
print(backend.backend.check_compatibility('QuanONet'))
"""


def test_qpu_modules_import_clean():
    """The QPU-emulation modules (sampling, param_shift, noise,
    mitigation), compare_engines, multiseed and backend import no JAX and
    build no kernel; backend finds the reference's frameworks without
    importing them."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', _IMPORT_QPU_MODULES],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == 'torch'


def test_new_kernel_wrappers_raise_on_cpu_tensors():
    """The launching wrappers take CUDA tensors only: on CPU tensors they
    raise instead of computing the plain version, and count no launch; the
    dispatching ones (ucomp, FusedAdam.step) take the plain versions."""
    from quanonet_torch.ops import cuda_adam, cuda_embed, cuda_ucomp
    e, t = torch.eye(4).repeat(2, 1, 1), torch.zeros(2, 3, 4)
    counts = (cuda_embed.launches, cuda_embed.bwd_launches)
    with pytest.raises(ValueError, match='CUDA tensors'):
        cuda_embed.embed_forward(e, t)
    with pytest.raises(ValueError, match='CUDA tensors'):
        cuda_embed.embed_backward(e, t, t[:1], t[0])
    assert torch.equal(cuda_embed.embed_chain(e, t),
                       cuda_embed.chain_embed(e, t))
    assert (cuda_embed.launches, cuda_embed.bwd_launches) == counts
    w, g = torch.ones(2, 3, 2), torch.zeros(2, 4, 4)
    before = (cuda_ucomp.launches, cuda_ucomp.bwd_launches, cuda_adam.launches)
    with pytest.raises(ValueError, match='CUDA tensors'):
        cuda_ucomp.ucomp_forward(w, 1, 1)
    with pytest.raises(ValueError, match='CUDA tensors'):
        cuda_ucomp.ucomp_backward(w, 1, 1, g, g)
    leaf = [torch.ones(3)]
    with pytest.raises(ValueError, match='CUDA leaves'):
        cuda_adam.adam_step(leaf, leaf, [torch.zeros(3)], [torch.zeros(3)],
                            0.1, 1)
    got = cuda_ucomp.ucomp(w, 1, 1)
    want = cuda_ucomp.ucomp_weights_dense(w, 1, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (cuda_ucomp.launches, cuda_ucomp.bwd_launches,
            cuda_adam.launches) == before


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from quanonet_torch.infer import load_model
    from quanonet_torch.serve import Predictor
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(ANTIDERIV, branch_in=10, trunk_in=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(ANTIDERIV, branch_in=10, trunk_in=1, max_batch=4)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')


def test_engine_resolution():
    cpu, cuda = torch.device('cpu'), torch.device('cuda')
    assert resolve_engine('auto', 5, cpu) == 'dense'
    assert resolve_engine(None, 5, cpu) == 'dense'
    assert resolve_engine('auto', 5, cuda) == 'pallas'
    assert resolve_engine('auto', 7, cuda) == 'pallas'
    for eng in ('dense', 'gates', 'pallas'):
        assert resolve_engine(eng, 5, cpu) == eng
        assert resolve_engine(eng, 5, cuda) == eng
    with pytest.raises(ValueError, match='unknown engine'):
        resolve_engine('nope', 5, cpu)


@pytest.mark.parametrize("engine,item", [('fused', 'A8'), ('pfused', 'B2'),
                                         ('embed', 'B3')])
def test_unported_engines_raise(engine, item):
    """'fused' (ROADMAP §A8), 'pfused' (§B2) and 'embed' (§B3) are ported
    and honoured on either device; 'embed' stays opt-in: 'auto' never
    picks it."""
    for dev in ('cpu', 'cuda'):
        for nq in (5, 10, 16):
            assert resolve_engine(engine, nq, torch.device(dev)) == engine
            assert resolve_engine('auto', nq, torch.device(dev)) != 'embed'


def test_auto_at_eight_qubits_raises():
    """From 8 qubits 'auto' routes as the JAX package's (hea.py:436-472):
    'pfused' on a card up to 14 qubits, 'fused' above and on the CPU; a
    no-grad caller takes 'pfused' at 15-16 on a card.  'pfused' itself
    raises outside 8..16 qubits and with a gradient above 14."""
    from quanonet_torch.ops import cuda_fused
    from quanonet_torch.ops.hea import HEASpec
    cpu, cuda = torch.device('cpu'), torch.device('cuda')
    for nq in range(8, 15):
        assert resolve_engine('auto', nq, cuda) == 'pfused'
        assert resolve_inference_engine('auto', nq, cuda) == 'pfused'
    for nq in range(8, 18):
        assert resolve_engine('auto', nq, cpu) == 'fused'
        assert resolve_inference_engine('auto', nq, cpu) == 'fused'
    for nq in (15, 16):
        assert resolve_engine('auto', nq, cuda) == 'fused'
        assert resolve_inference_engine('auto', nq, cuda) == 'pfused'
    assert resolve_engine('auto', 17, cuda) == 'fused'
    assert resolve_inference_engine('auto', 17, cuda) == 'fused'
    assert resolve_inference_engine('auto', 7, cuda) == 'pallas'
    assert resolve_inference_engine('dense', 15, cuda) == 'dense'
    for nq in (7, 17):
        spec = HEASpec(nq, ((nq, 1),))
        with pytest.raises(ValueError, match="engine 'pfused' takes 8..16"):
            cuda_fused.forward_pfused(spec, torch.zeros(1, 3, nq),
                                      torch.zeros(1, nq))
    ops = [torch.zeros(1, 128, 128), torch.zeros(1, 128, 128),
           torch.zeros(1, 8, 4), torch.zeros(1, 8, 4),
           torch.zeros(1, 1, 15, requires_grad=True)]
    with pytest.raises(ValueError, match="engine='fused'"):
        cuda_fused.fused_chain(*ops, (1,))


def test_classical_model_types_raise(tmp_path):
    """The classical model types load (a DeepONet checkpoint written from
    a seeded model gives its predictions back); an unknown type raises."""
    import numpy as np
    from quanonet_torch import checkpoint as ckpt_io
    from quanonet_torch.convert import raw_from_state_dict
    from quanonet_torch.infer import load_model, predict
    from quanonet_torch.models import DeepONet
    ref = DeepONet(10, 1, (6, 6), (6, 6), device='cpu',
                   generator=torch.Generator().manual_seed(0))
    run = tmp_path / 'Antideriv_DeepONet_Net2-6_20x100_Seed0'
    run.mkdir()
    ckpt_io.save_ms_ckpt(str(run / 'best_model.ckpt'),
                         raw_from_state_dict(ref.state_dict(), 'DeepONet'))
    model, cfg = load_model(str(run / 'best_model.ckpt'), branch_in=10,
                            trunk_in=1, device='cpu')
    assert cfg['model_type'] == 'DeepONet' and cfg['engine'] is None
    rng = np.random.RandomState(0)
    b, t = (rng.randn(5, 10).astype(np.float32),
            rng.rand(5, 1).astype(np.float32))
    with torch.no_grad():
        want = ref(torch.as_tensor(b), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(predict(model, b, t, cfg=cfg), want)
    with pytest.raises(ValueError, match='Unknown model_type'):
        load_model(ANTIDERIV, branch_in=10, trunk_in=1, device='cpu',
                   model_type='Nope')


def test_kernel_wrapper_plain_on_cpu_and_no_grad():
    """On CPU tensors the wrapper computes the plain chain, with and
    without a gradient; it never launches, so the launch counts stay put."""
    from quanonet_torch.ops import cuda_hea, hea
    g = torch.Generator().manual_seed(0)
    mt_r = torch.randn(3, 4, 4, generator=g)
    mt_i = torch.randn(3, 4, 4, generator=g)
    phi = torch.randn(3, 5, 4, generator=g)
    before = (cuda_hea.launches, cuda_hea.bwd_launches)
    got = cuda_hea.block_chain(mt_r, mt_i, phi)
    want = hea.chain_dense(mt_r, mt_i, phi)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the grad path: BlockChain's plain forward and explicit backward sweep
    ops = [t.clone().requires_grad_() for t in (mt_r, mt_i, phi)]
    sr, si = cuda_hea.block_chain(*ops)
    assert torch.equal(sr.detach(), want[0])
    grads = torch.autograd.grad((sr * sr + 2 * si).sum(), ops)
    ref = [t.clone().requires_grad_() for t in (mt_r, mt_i, phi)]
    pr, pi = hea.chain_dense(*ref)
    ref_grads = torch.autograd.grad((pr * pr + 2 * pi).sum(), ref)
    for a, b in zip(grads, ref_grads):
        # random, unnormalised matrices: values in the tens, so relative
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert (cuda_hea.launches, cuda_hea.bwd_launches) == before


def test_training_cli_refuses_cpu_fallback():
    """``python -m quanonet_torch.cli`` without ``--device cpu`` raises on
    a machine without a card, before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run(
        [sys.executable, '-m', 'quanonet_torch.cli', '--operator',
         'Antideriv', '--model_type', 'QuanONet', '--prefix',
         os.path.join(REPO, 'outputs', 'never_written')],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert not os.path.exists(os.path.join(REPO, 'outputs', 'never_written'))


_IMPORT_TOOLS = r"""
import sys
from quanonet_torch import bench_amplitude, bench_serve, bench_suite, \
    profile_q10
from quanonet_torch.ops import _build
assert _build._loaded == {}, _build._loaded
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'quanonet_tpu', 'triton'))
assert not bad, bad
print('ok')
"""


def test_measurement_tools_import_clean():
    """The measurement tools (bench_amplitude, profile_q10, bench_serve,
    bench_suite) import no JAX and build no kernel."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', _IMPORT_TOOLS], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ['ok']


@pytest.mark.parametrize("module,argv", [
    ('bench_amplitude', ['--shard-compute']), ('profile_q10', []),
    ('bench_serve', []), ('bench_suite', ['--quick'])])
def test_measurement_tools_refuse_cpu_fallback(module, argv, tmp_path):
    """Each tool's CLI raises without a card unless --device cpu is given,
    before it writes its file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    outs = (['--out_pfused', str(tmp_path / 'a.json'), '--out_fused',
             str(tmp_path / 'b.json')] if module == 'profile_q10'
            else ['--out', str(tmp_path / 'a.json')])
    out = subprocess.run(
        [sys.executable, '-m', f'quanonet_torch.{module}', *argv, *outs],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert 'CUDA is not available' in out.stderr
    assert not any(tmp_path.iterdir())
