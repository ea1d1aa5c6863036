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


@pytest.mark.parametrize("over,item", [
    (dict(datagen='device'), 'A10'), (dict(datagen='native'), 'A10'),
    (dict(model_type='FNO'), None)])
def test_unported_generators_raise(over, item):
    """The device and native generators raise naming their ROADMAP item;
    the FNO grid encoding is ported and names its own cache file."""
    cfg = dict(operator='Advection', model_type='QuanONet', num_train=2,
               num_test=1)
    cfg.update(over)
    if item is None:
        assert DataManager(cfg)._get_filename() == \
            'Advection_2_1_100_100_FNO.npz'
        return
    with pytest.raises(NotImplementedError, match=item):
        DataManager(cfg)


def test_unknown_operator_raises():
    with pytest.raises(ValueError, match='Unknown operator'):
        DataManager(dict(operator='Nope', num_train=1, num_test=1))
