"""
The port's host data generators (quanonet_torch/data) against the JAX
package's: under the same global NumPy seed they are the same NumPy code,
so every array of the processed dataset is byte-equal, and so is the
cache file name.  Each package writes into its own temporary directory.
"""
import numpy as np
import pytest

import quanonet_tpu.data.generation as j_gen
import quanonet_torch.data.generation as t_gen
from quanonet_tpu.data.manager import DataManager as JDataManager
from quanonet_torch.data.manager import DataManager


def _both(tmp_path, monkeypatch, cfg):
    out = {}
    for name, gen, cls in (('jax', j_gen, JDataManager),
                           ('torch', t_gen, DataManager)):
        monkeypatch.setattr(gen, 'DATA_ROOT', str(tmp_path / name / 'raw'))
        np.random.seed(0)
        dm = cls(cfg, data_dir=str(tmp_path / name / 'data'))
        out[name] = (dm._get_filename(), dm.get_data())
    return out['jax'], out['torch']


@pytest.mark.parametrize("cfg", [
    dict(operator='Advection', model_type='QuanONet', num_train=20,
         num_test=10, num_points=20, num_points_0=16, train_sample_num=7,
         test_sample_num=9),
    dict(operator='Antideriv', model_type='QuanONet', num_train=20,
         num_test=10, num_points=30, num_points_0=10, train_sample_num=5,
         test_sample_num=10, num_cal=200),
], ids=['Advection', 'Antideriv'])
def test_data_manager_byte_equal_to_jax(tmp_path, monkeypatch, cfg):
    (j_name, want), (t_name, got) = _both(tmp_path, monkeypatch, cfg)
    assert t_name == j_name
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    # the processed cache round-trips: a second call reads the same bytes
    np.random.seed(123)
    again = DataManager(cfg, data_dir=str(tmp_path / 'torch' / 'data'))
    cached = again.get_data()
    for k in want:
        assert cached[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("over,name", [
    (dict(datagen='device'), 'Advection_2_1_100_100_10_100_dgdevice.npz'),
    (dict(datagen='native'), 'Advection_2_1_100_100_10_100_dgnative.npz'),
    (dict(model_type='FNO'), 'Advection_2_1_100_100_FNO.npz')],
    ids=['over0-A10', 'over1-A10', 'over2-None'])
def test_unported_generators_raise(over, name):
    """The device and native generators (ROADMAP §A item 7, raising until
    they were ported) build and cache under their own names, as the JAX
    package's DataManager names them; the FNO grid encoding names its own
    cache file."""
    cfg = dict(operator='Advection', model_type='QuanONet', num_train=2,
               num_test=1)
    cfg.update(over)
    dm = DataManager(cfg)
    assert dm.datagen == over.get('datagen', 'host')
    assert dm._get_filename() == name
    assert JDataManager(cfg)._get_filename() == name


def test_unknown_operator_raises():
    with pytest.raises(ValueError, match='Unknown operator'):
        DataManager(dict(operator='Nope', num_train=1, num_test=1))


def _ode_cfg(**over):
    cfg = dict(operator='Antideriv', model_type='QuanONet', num_train=6,
               num_test=4, num_points=12, num_points_0=6, train_sample_num=3,
               test_sample_num=4, num_cal=50)
    cfg.update(over)
    return cfg


def test_damaged_cache_regenerates(tmp_path, monkeypatch, caplog):
    """A truncated .npz (a run killed while writing it) raises BadZipFile in
    np.load: the cache is regenerated, as the JAX package does."""
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    np.random.seed(0)
    dm = DataManager(_ode_cfg(), data_dir=str(tmp_path / 'data'))
    want = dm.get_data()
    path = tmp_path / 'data' / 'Antideriv' / dm._get_filename()
    path.write_bytes(path.read_bytes()[:100])
    np.random.seed(0)
    with caplog.at_level('WARNING'):
        got = DataManager(_ode_cfg(), data_dir=str(tmp_path / 'data')
                          ).get_data()
    assert any('Failed to load cache' in r.getMessage()
               and 'Regenerating' in r.getMessage() for r in caplog.records)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k


def _zero_input(n):
    """An input sampler: u0 = 0 (the function and its samples)."""
    return (lambda x: 0.0 * np.asarray(x)), np.zeros(n)


def test_input_sampler_forces_host(tmp_path, monkeypatch, caplog):
    """A custom input_sampler with datagen 'device' or 'native' runs on the
    host generators (the JAX package's rule), logging why."""
    monkeypatch.setattr(t_gen, 'DATA_ROOT', str(tmp_path / 'raw'))
    for datagen in ('device', 'native'):
        with caplog.at_level('INFO'):
            dm = DataManager(_ode_cfg(datagen=datagen),
                             data_dir=str(tmp_path / 'data'),
                             input_sampler=_zero_input)
        assert dm.datagen == 'host'
        assert any('forcing datagen=host' in r.getMessage()
                   for r in caplog.records)
        data = dm.get_data()
        assert not np.abs(data['train_branch_input']).any()
        assert not np.abs(data['train_output']).any()
    jdm = JDataManager(_ode_cfg(datagen='device'),
                       input_sampler=lambda n: (None, np.zeros(n)))
    assert jdm.datagen == dm.datagen


def test_datagen_env_and_unknown(monkeypatch):
    """QUANONET_NATIVE=1 asks for the native generators (ported from
    ROADMAP §A item 7: the route is 'native' and caches under _dgnative, as
    the JAX package's); an unknown datagen is a ValueError."""
    monkeypatch.setenv('QUANONET_NATIVE', '1')
    dm = DataManager(_ode_cfg())
    assert dm.datagen == JDataManager(_ode_cfg()).datagen == 'native'
    assert dm._get_filename().endswith('_dgnative.npz')
    monkeypatch.delenv('QUANONET_NATIVE')
    with pytest.raises(ValueError, match='host|device|native'):
        DataManager(_ode_cfg(datagen='gpu'))
    assert DataManager(_ode_cfg()).datagen == 'host'
