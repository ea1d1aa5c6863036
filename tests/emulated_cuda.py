"""
Builds a CUDA source of quanonet_torch/csrc/ into a host library for the
CPU emulation (tests/test_torch_port_fused_emulated.py,
tests/test_torch_port_embed_emulated.py): the source's inline-PTX helpers
get the synchronous bodies a test names, each launch
``kernel<<<grid, block, bytes, stream>>>(args)`` becomes
``Launch{grid, block}(kernel)(args)``, and each dynamic shared-memory
array the launch's array of tests/cuda_emulation/cuda_runtime.h; the
result is compiled with the host's C++ compiler against that header.
"""
import ctypes
import os
import re
import shutil
import subprocess

import pytest

HEADERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'cuda_emulation')


def replace_body(src, head, body):
    """The body of the function whose declaration starts with ``head``,
    replaced by ``body``."""
    i = src.index(head)
    j = src.index('{', i)
    depth = 0
    for k in range(j, len(src)):
        depth += {'{': 1, '}': -1}.get(src[k], 0)
        if depth == 0:
            return src[:j] + '{ ' + body + ' }' + src[k + 1:]
    raise ValueError(head)


def emulation_source(src, bodies):
    """A CUDA source -> a C++ translation unit for the emulation, each
    (head, body) of ``bodies`` replacing a helper's body."""
    for head, body in bodies:
        src = replace_body(src, head, body)
    src = re.sub(r'(\w+(?:<[^<>]*>)?)<<<(.*?),(.*?),(.*?),(.*?)>>>\(',
                 lambda m: f'Launch{{dim3({m.group(2)}), dim3({m.group(3)})}}'
                           f'({m.group(1)})(', src, flags=re.S)
    return re.sub(r'extern __shared__ __align__\(16\) float (\w+)\[\];',
                  r'float* \1 = ::\1;', src)


def build(source, bodies, out_dir, opt='-O2'):
    """The emulated library of ``source`` (a path), built in ``out_dir``;
    skips the test without a C++20 compiler."""
    cxx = shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        pytest.skip("needs a C++20 compiler for the emulation")
    stem = os.path.splitext(os.path.basename(source))[0]
    cpp = out_dir / f'{stem}_emulated.cpp'
    with open(source) as f:
        cpp.write_text(emulation_source(f.read(), bodies))
    so = out_dir / f'lib{stem}_emulated.so'
    subprocess.run([cxx, '-std=c++20', opt, '-shared', '-fPIC', '-pthread',
                    '-I', HEADERS, '-o', str(so), str(cpp)], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(str(so))
