"""
The native C++ data-generation path of the port (quanonet_torch/data/
native.py over native/quanonet_native.cpp, and its routes in
data/generation.py and data/manager.py), on the CPU, at
tests/test_native.py's limits: RK4 against SciPy's RK45 5e-3, the float32
stencils against the float64 host ones 1e-4.

The library is compiled from the source with native/Makefile's compiler
and flags into a per-test build root.  The tests that compile skip only
where g++ is absent (they say so); the tests of the loader's settings,
hashing and errors need no compiler.  Where a test holds the port against
the JAX package's native arrays, the JAX loader too gets a library of the
test's own (``jax_native``): built with ``make`` from a copy of native/ in
the test's directory, never the shared native/libquanonet_native.so, which
other test processes may be building at the same time.
"""
import os
import shutil
import subprocess

import numpy as np
import pytest

import quanonet_tpu.data.generation as j_gen
import quanonet_tpu.data.native as j_native
import quanonet_torch.data.generation as t_gen
from quanonet_tpu.data.manager import DataManager as JDataManager
from quanonet_torch.data import native
from quanonet_torch.data.manager import DataManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_gxx = pytest.mark.skipif(shutil.which('g++') is None,
                               reason="g++ is not installed: the native "
                                      "library cannot be compiled here")


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A build root of this test's own and an unloaded library."""
    monkeypatch.setattr(native, 'build_root', lambda: tmp_path / 'build')
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'openmp', None)
    monkeypatch.delenv('CXX', raising=False)
    monkeypatch.delenv('CXXFLAGS', raising=False)
    return tmp_path


@pytest.fixture
def jax_native(fresh_build, monkeypatch):
    """The JAX package's loader pointed at a library of this test's own:
    native/Makefile and native/quanonet_native.cpp copied into the test's
    directory and built there with ``make -C``, the loader's cached state
    reset.  Skips where make or g++ is absent; a failed build fails."""
    for tool in ('make', 'g++'):
        if shutil.which(tool) is None:
            pytest.skip(f"{tool} is not installed: the JAX package's "
                        f"native library cannot be built here")
    src = fresh_build / 'jax_native'
    src.mkdir()
    for name in ('Makefile', 'quanonet_native.cpp'):
        shutil.copy(os.path.join(REPO, 'native', name), src / name)
    out = subprocess.run(['make', '-C', str(src)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, f"make -C {src} failed:\n{out.stderr}"
    so = src / 'libquanonet_native.so'
    assert so.is_file()
    monkeypatch.setattr(j_native, '_NATIVE_DIR', str(src))
    monkeypatch.setattr(j_native, '_SO_PATH', str(so))
    monkeypatch.setattr(j_native, '_lib', None)
    monkeypatch.setattr(j_native, '_tried', False)
    return so


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    monkeypatch.setattr(j_gen, 'DATA_ROOT', str(tmp_path / 'jraw'))
    return tmp_path


def test_make_settings_are_the_makefiles(monkeypatch):
    monkeypatch.delenv('CXX', raising=False)
    monkeypatch.delenv('CXXFLAGS', raising=False)
    cxx, flags = native.make_settings()
    assert cxx == 'g++'
    assert flags == ['-O3', '-march=native', '-fPIC', '-shared', '-fopenmp',
                     '-std=c++17', '-Wall']
    monkeypatch.setenv('CXX', 'clang++')
    monkeypatch.setenv('CXXFLAGS', '-O2 -shared -fPIC')
    assert native.make_settings() == ('clang++', ['-O2', '-shared', '-fPIC'])


def test_build_dir_keys_source_flags_and_host(fresh_build, monkeypatch):
    a = native.build_dir()
    assert a.parent == fresh_build / 'build' and a.name.startswith('native-')
    assert native.build_dir() == a
    assert native.build_dir(['-O2']) != a
    monkeypatch.setattr(native, '_host_cpu', lambda: 'another cpu')
    assert native.build_dir() != a


def test_asked_for_and_not_buildable_raises_with_the_compiler_error(
        fresh_build, monkeypatch, data_root):
    """No fallback to SciPy: --datagen native raises, naming the error."""
    monkeypatch.setenv('CXX', str(fresh_build / 'no-such-compiler'))
    assert native.native_available() is False
    with pytest.raises(RuntimeError, match='no-such-compiler'):
        native.solve_ode_batch_native('Antideriv', np.zeros((1, 8)), 4)
    with pytest.raises(RuntimeError, match='no-such-compiler'):
        t_gen.generate_ode_operator_data('Antideriv', 2, 1, 10, 5,
                                         num_cal=20, use_native=True)


@needs_gxx
def test_without_openmp_builds_once_more_serially(fresh_build, monkeypatch):
    """A compiler that cannot build OpenMP code (g++ without libgomp)
    gives a library built without -fopenmp, with the same results."""
    fake = fresh_build / 'gxx-no-omp'
    fake.write_text('#!/bin/sh\ncase "$*" in *-fopenmp*) echo "g++: fatal '
                    "error: cannot read spec file 'libgomp.spec'\" >&2; "
                    'exit 1;; esac\nexec g++ "$@"\n')
    fake.chmod(0o755)
    monkeypatch.setenv('CXX', str(fake))
    path = native.build()
    assert native.openmp is False and path.is_file()
    assert path.parent == native.build_dir(
        [f for f in native.make_settings()[1] if f != '-fopenmp'])
    u0 = np.random.RandomState(0).randn(3, 40).astype(np.float32)
    serial = native.solve_advection_batch_native(u0)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.delenv('CXX')
    assert native.build() != path and native.openmp is True
    np.testing.assert_array_equal(native.solve_advection_batch_native(u0),
                                  serial)


@needs_gxx
def test_ode_matches_scipy(fresh_build):
    from scipy.integrate import solve_ivp
    np.random.seed(0)
    u0s = np.stack([t_gen.generate_random_gaussian_field(1024)[1]
                    for _ in range(3)]).astype(np.float32)
    num_cal = 300
    grid = np.linspace(0, 1, 1024)
    x = np.linspace(0, 1, num_cal)
    for op, rhs in [('Antideriv', lambda fn: lambda t, y: fn(t)),
                    ('Homogeneous', lambda fn: lambda t, y: y + fn(t)),
                    ('Nonlinear', lambda fn: lambda t, y: -y ** 3 + fn(t))]:
        out = native.solve_ode_batch_native(op, u0s, num_cal)
        assert out.shape == (3, num_cal) and out.dtype == np.float32
        for i in range(3):
            fn = (lambda u: lambda t: np.interp(t, grid, u))(u0s[i])
            ref = solve_ivp(rhs(fn), [0, 1], [0], t_eval=x,
                            method='RK45').y[0]
            np.testing.assert_allclose(out[i], ref, atol=5e-3)


@needs_gxx
def test_stencils_match_host(fresh_build):
    np.random.seed(1)
    _, u0 = t_gen.generate_random_gaussian_field(80)
    host_u, _ = t_gen.solve_advection_pde(80, u0_cal=u0)
    nat = native.solve_advection_batch_native(u0.astype(np.float32)[None])[0]
    np.testing.assert_allclose(nat, host_u, atol=1e-4)
    _, u0 = t_gen.generate_random_gaussian_field(40)
    host_u, _ = t_gen.solve_rdiffusion_pde(40, 0.2, u0_cal=u0)
    nat = native.solve_rdiffusion_batch_native(
        u0.astype(np.float32)[None])[0]
    assert nat.shape == host_u.shape
    np.testing.assert_allclose(nat, host_u, atol=1e-4)


@needs_gxx
@pytest.mark.parametrize("op,tag", [('Antideriv', '_rk4'),
                                    ('Advection', '_native'),
                                    ('Darcy', '')])
def test_raw_caches_and_jax_agreement(fresh_build, jax_native, data_root,
                                      op, tag):
    """use_native writes its own raw cache (_rk4 for the ODEs, _native for
    the stencils, none for Darcy, which stays on the host solve) and, on
    equal NumPy seeds, gives the JAX package's native arrays.  The JAX side
    runs on its own build of the library (jax_native), and its native
    route is asserted before the arrays are compared: a fallback to SciPy
    fails here, by name."""
    ode = op == 'Antideriv'
    fn = 'generate_ode_operator_data' if ode else \
        'generate_pde_operator_data'
    kw = dict(num_cal=40 if ode else 12, use_native=True)
    np.random.seed(3)
    got = getattr(t_gen, fn)(op, 3, 2, 10, 6, **kw)
    np.random.seed(3)
    want = getattr(j_gen, fn)(op, 3, 2, 10, 6, **kw)
    name = f"{op}_Operator_data_{kw['num_cal']}_1{tag}.npz"
    assert j_native.native_available() and j_native._SO_PATH == \
        str(jax_native), "the JAX package's native library did not load"
    jraw = os.listdir(data_root / 'jraw' / f'{op}_Operator_data')
    assert name in jraw, (f"the JAX side fell back to the host solve: its "
                          f"raw cache holds {jraw}, not {name}")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6)
    raw = os.listdir(data_root / 'raw' / f'{op}_Operator_data')
    assert name in raw


@needs_gxx
def test_environment_flag_routes_through_the_library(fresh_build,
                                                     data_root, monkeypatch):
    """QUANONET_NATIVE=1 (tests/test_native.py's case): the raw solves run
    in C++ and give a consistent dataset (Antideriv: du/dx = u0); the
    DataManager names the processed cache _dgnative, as JAX's does."""
    monkeypatch.setenv('QUANONET_NATIVE', '1')
    np.random.seed(2)
    u0_tr, u_tr, _, _, x = t_gen.generate_ode_operator_data(
        'Antideriv', 3, 1, 60, 60, num_cal=200)
    du = np.gradient(u_tr[0], x)
    np.testing.assert_allclose(du[2:-2], u0_tr[0][2:-2], atol=0.05)
    assert sorted(os.listdir(data_root / 'raw' /
                             'Antideriv_Operator_data')) == [
        'Antideriv_Operator_data_200_1_rk4.npz',
        'Antideriv_Operator_data_200_1_rk4.npz.lock']
    cfg = dict(operator='Antideriv', model_type='QuanONet', num_train=3,
               num_test=2, num_points=10, num_points_0=5, num_cal=40,
               train_sample_num=5, test_sample_num=5)
    dm = DataManager(cfg, data_dir=str(data_root / 'data'))
    assert dm.datagen == 'native'
    assert dm._get_filename() == JDataManager(cfg)._get_filename() == \
        'Antideriv_3_2_10_5_5_5_dgnative.npz'
    data = dm.get_data()
    assert data['train_output'].shape == (15, 1)
    assert os.path.exists(data_root / 'data' / 'Antideriv' /
                          'Antideriv_3_2_10_5_5_5_dgnative.npz')
