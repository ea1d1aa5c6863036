"""
Builds the port's CUDA kernels from ``quanonet_torch/csrc/`` at first use
and loads them.

``torch.utils.cpp_extension.load`` (which needs ``ninja``) compiles
``csrc/<name>.cu`` with ``nvcc`` for ``sm_90a`` and links it into a shared
library.  The sources include no PyTorch header: each exports a plain C
interface (device pointers and a stream) that its wrapper calls through
``ctypes``.  Each build goes to its own directory, keyed by a hash of the
source and the flags, so a changed source is rebuilt and nothing prebuilt
is ever committed.  A failed build raises; no caller falls back to a plain
version.

:func:`on_device` runs a wrapper's launch with its tensors' device current,
entering that device's context only when another one is current.

The build directories live in ``.kernels_build/`` at the root of a source
checkout (listed in ``.gitignore``), or, for an installed package, in
``$XDG_CACHE_HOME/quanonet_torch/kernels`` (``~/.cache`` by default).
"""
import ctypes
import hashlib
import os
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
CUDA_FLAGS = ['-O3', '-gencode=arch=compute_90a,code=sm_90a']

_lock = threading.Lock()
_loaded = {}


def build_root() -> Path:
    """``.kernels_build/`` in a source checkout, else a per-user cache."""
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / 'pyproject.toml').is_file():
        return checkout / '.kernels_build'
    cache = os.environ.get('XDG_CACHE_HOME') or Path.home() / '.cache'
    return Path(cache) / 'quanonet_torch' / 'kernels'


def build_dir(name: str) -> Path:
    """Where ``csrc/<name>.cu`` at its current source is built."""
    key = (CSRC / f'{name}.cu').read_bytes() + ' '.join(CUDA_FLAGS).encode()
    return build_root() / f'{name}-{hashlib.sha256(key).hexdigest()[:16]}'


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is built; returns the
    library's path.  Raises with the compiler's output on failure."""
    from torch.utils import cpp_extension
    out = build_dir(name)
    out.mkdir(parents=True, exist_ok=True)   # load() does not make it
    return Path(cpp_extension.load(
        name=name, sources=[str(CSRC / f'{name}.cu')],
        extra_cuda_cflags=CUDA_FLAGS, build_directory=str(out),
        is_python_module=False, verbose=False))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def on_device(device, fn):
    """fn() with CUDA ``device`` current, entering its context only when it
    is not (the context manager costs host time on every launch)."""
    import torch
    if torch.cuda.current_device() == device.index:
        return fn()
    with torch.cuda.device(device):
        return fn()
