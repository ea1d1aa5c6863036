"""
ctypes bindings of the native host-side data-generation library
(``native/quanonet_native.cpp``; counterpart of quanonet_tpu/data/native.py).

The library is compiled from that source at first use with the compiler
and flags of ``native/Makefile`` (``CXX``, ``CXXFLAGS``; the environment
overrides them as ``make`` lets it), into the port's build directory
(``ops/_build.build_root()``, ``.kernels_build/`` in a checkout), one
directory per hash of the source, the flags and the host CPU: the flags
hold ``-march=native``, so a library is only ever loaded on the kind of
CPU that built it.  Where the compiler cannot build OpenMP code (a g++
without libgomp) the library is built once more without ``-fopenmp``:
the same solvers on one thread, the same results (the parallel loop runs
over independent samples); :data:`openmp` says which was built.  Where
the library cannot be built or loaded at all the solvers raise and name
the compiler's error; the JAX package falls back to SciPy there, the port
does not (``--datagen native`` is a request).

Solvers, float32, OpenMP-parallel over the batch, with the semantics of
data/device_gen.py: fixed-step RK4 on the linearly interpolated GRF input
(:func:`solve_ode_batch_native`), upwind advection with CFL 0.8 and a
periodic boundary (:func:`solve_advection_batch_native`), explicit-Euler
reaction-diffusion with the early-time subsampling quirk
(:func:`solve_rdiffusion_batch_native`).
"""
import ctypes
import hashlib
import os
import platform
import re
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from quanonet_torch.ops._build import build_root

NATIVE_DIR = Path(os.environ.get('QUANONET_NATIVE_DIR') or Path(
    __file__).resolve().parents[2] / 'native')
SOURCE = 'quanonet_native.cpp'
LIBRARY = 'libquanonet_native.so'

ODE_KIND = {'Identity': 0, 'Antideriv': 1, 'Homogeneous': 2, 'Nonlinear': 3}

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of this process's compile, if it ran
openmp = None             # whether the built library runs its loops on
#                           OpenMP threads (None: not built yet)


def make_settings(makefile=None):
    """(compiler, flags) of ``native/Makefile``'s ``CXX ?=`` and
    ``CXXFLAGS ?=`` lines, each overridden by the environment variable of
    that name, as ``make`` does."""
    text = Path(makefile or NATIVE_DIR / 'Makefile').read_text()
    found = dict(re.findall(r'^(CXX|CXXFLAGS)\s*\?=\s*(.*)$', text, re.M))
    cxx = os.environ.get('CXX') or found.get('CXX', 'g++').strip()
    flags = os.environ.get('CXXFLAGS') or found.get('CXXFLAGS', '')
    return cxx, flags.split()


def _host_cpu():
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        text = Path('/proc/cpuinfo').read_text()
    except OSError:
        return platform.machine()
    keys = ('model name', 'flags', 'Features', 'CPU part')
    lines = [ln for ln in text.splitlines() if ln.split(':')[0].strip()
             in keys]
    return platform.machine() + '\n' + '\n'.join(sorted(set(lines)))


def build_dir(flags=None):
    """Where the library of the current source, the compiler and ``flags``
    (default the Makefile's) and the host CPU lives."""
    cxx, make_flags = make_settings()
    flags = make_flags if flags is None else flags
    key = b'\0'.join([(NATIVE_DIR / SOURCE).read_bytes(),
                      ' '.join([cxx] + flags).encode(), _host_cpu().encode()])
    return build_root() / f'native-{hashlib.sha256(key).hexdigest()[:16]}'


def _compile(cxx, flags, out):
    """Compile the library into ``out``; returns None, or the failure's
    text."""
    lib = out / LIBRARY
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f'{LIBRARY}.{os.getpid()}.tmp'
    cmd = [cxx] + flags + [str(NATIVE_DIR / SOURCE), '-o', str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"`{' '.join(cmd)}` could not run: {e}"
    if res.returncode:
        return f"`{' '.join(cmd)}` failed ({res.returncode}):\n{res.stderr}"
    os.replace(tmp, lib)
    return None


def build():
    """Compile the library unless it is built; returns its path.  With the
    Makefile's flags, or, where those fail on OpenMP alone, without
    ``-fopenmp``.  Raises RuntimeError with the compiler's output when no
    build succeeds."""
    global build_seconds, openmp
    cxx, flags = make_settings()
    tries = [flags]
    if '-fopenmp' in flags:
        tries.append([f for f in flags if f != '-fopenmp'])
    errors = []
    for attempt in tries:
        out = build_dir(attempt)
        if (out / LIBRARY).is_file():
            openmp = '-fopenmp' in attempt
            return out / LIBRARY
    t0 = time.time()
    for attempt in tries:
        err = _compile(cxx, attempt, build_dir(attempt))
        if err is None:
            build_seconds = time.time() - t0
            openmp = '-fopenmp' in attempt
            if errors:
                print(f"native datagen library: built without -fopenmp "
                      f"(one thread) after: {errors[0]}")
            return build_dir(attempt) / LIBRARY
        errors.append(err)
        if 'omp' not in err:
            break        # not an OpenMP failure: the serial build would fail
    raise RuntimeError("native datagen library: " + "\n".join(errors))


def load():
    """The loaded library, built first if needed; raises RuntimeError when
    it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"native datagen library {path} does not "
                               f"load: {e}") from e
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        i32 = ctypes.c_int32
        lib.solve_ode_batch.argtypes = [i32, f32p, i32, i32, i32, f32p]
        lib.solve_advection_batch.argtypes = [f32p, i32, i32, f32p]
        lib.solve_rdiffusion_batch.argtypes = [f32p, i32, i32, f32p]
        lib.rdiffusion_cols.argtypes = [i32]
        lib.rdiffusion_cols.restype = i32
        lib.native_version.restype = i32
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library builds and loads here (a probe: never raises)."""
    try:
        load()
        return True
    except RuntimeError:
        return False


def solve_ode_batch_native(operator, u0_full, num_cal):
    """u0_full (batch, n_src) float32 -> (batch, num_cal) RK4 solutions."""
    lib = load()
    u0 = np.ascontiguousarray(u0_full, np.float32)
    batch, n_src = u0.shape
    out = np.empty((batch, num_cal), np.float32)
    lib.solve_ode_batch(ODE_KIND[operator], u0, batch, n_src, num_cal, out)
    return out


def solve_advection_batch_native(u0_cal):
    """u0_cal (batch, num_cal) -> (batch, num_cal x, num_cal t)."""
    lib = load()
    u0 = np.ascontiguousarray(u0_cal, np.float32)
    batch, num_cal = u0.shape
    out = np.empty((batch, num_cal, num_cal), np.float32)
    lib.solve_advection_batch(u0, batch, num_cal, out)
    return out


def solve_rdiffusion_batch_native(u0_cal):
    """u0_cal (batch, num_cal) -> (batch, num_cal x, the library's
    time columns)."""
    lib = load()
    u0 = np.ascontiguousarray(u0_cal, np.float32)
    batch, num_cal = u0.shape
    out = np.empty((batch, num_cal, lib.rdiffusion_cols(num_cal)),
                   np.float32)
    lib.solve_rdiffusion_batch(u0, batch, num_cal, out)
    return out
