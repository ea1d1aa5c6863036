"""
The default route of the port's block matrices, as a pure function of the
device type (cuda_hea.compile_route: the compile kernels for CUDA weights,
the fold for CPU weights, ``USE_UCOMP`` forcing either), and how the
environment sets the flag.
"""
import os
import subprocess
import sys

import pytest

from quanonet_torch.ops import cuda_hea, hea

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = hea.quanonet_spec(5, (40, 2, 20, 2))
MIXED = hea.HEASpec(3, ((3, 1), (3, 2)))      # the compile does not apply


@pytest.mark.parametrize("flag,spec,device,want", [
    (None, FLAGSHIP, 'cuda', True), (None, FLAGSHIP, 'cpu', False),
    (True, FLAGSHIP, 'cpu', True), (True, FLAGSHIP, 'cuda', True),
    (False, FLAGSHIP, 'cuda', False), (False, FLAGSHIP, 'cpu', False),
    (None, MIXED, 'cuda', False), (True, MIXED, 'cuda', False),
    (None, hea.quanonet_spec(8, (2, 2, 2, 2)), 'cuda', False),
])
def test_compile_route(flag, spec, device, want):
    assert cuda_hea.compile_route(flag, spec, device) is want


@pytest.mark.parametrize("value,want", [(None, None), ('1', True),
                                        ('0', False), ('', None)])
def test_use_ucomp_from_the_environment(value, want):
    """Unset (or any value but '1' and '0') is None, auto."""
    env = {k: v for k, v in os.environ.items()
           if k not in ('PYTHONPATH', 'USE_UCOMP')}
    if value is not None:
        env['USE_UCOMP'] = value
    out = subprocess.run(
        [sys.executable, '-c', 'from quanonet_torch.ops import cuda_hea; '
                               'print(cuda_hea.USE_UCOMP)'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(want)
