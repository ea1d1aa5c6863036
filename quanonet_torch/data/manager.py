"""
DataManager: generation -> encoding -> processed-data disk cache (the
port's own copy of quanonet_tpu/data/manager.py; reference
data_utils/data_manager.py:36-193).  The cache file names are the JAX
package's, so the two packages share datasets:
``{op}_{num_train}_{num_test}_{pts}_{pts0}[_FNO|_{tsn}_{tesn}][_dg{gen}].npz``.

``datagen`` (``--datagen``): 'host' (the NumPy/SciPy generators, the
cache's byte contract), 'device' (data/device_gen.py on the config's
device: the card unless ``device`` is 'cpu') or 'native' (the C++ solvers
of data/native.py, also set by ``QUANONET_NATIVE=1``); the last two are
not byte-equal to the host path and cache under ``_dgdevice`` /
``_dgnative``.  A custom ``input_sampler`` forces 'host'.
"""
import logging
import os

import numpy as np

from quanonet_torch.data import generation as gen
from quanonet_torch.data.processing import (
    ode_encode, ode_fncode, pde_encode, pde_fncode,
)

GENERATOR_MAP = {
    'Identity': 'ode', 'Antideriv': 'ode', 'Homogeneous': 'ode',
    'Nonlinear': 'ode',
    'RDiffusion': 'pde', 'Advection': 'pde', 'Darcy': 'pde',
}

PDE_OPERATORS = ('RDiffusion', 'Advection', 'Darcy')


class DataManager:
    def __init__(self, config, data_dir="data", logger=None,
                 input_sampler=None):
        self.config = config
        self.data_dir = data_dir
        self.logger = logger or logging.getLogger(__name__)
        self.input_sampler = input_sampler

        self.operator_type = config['operator']
        self.model_type = config.get('model_type', 'DeepONet')
        # 'host' (the NumPy/SciPy generators, the cache's byte contract),
        # 'device' (data/device_gen.py) or 'native' (data/native.py)
        datagen = config.get('datagen') or 'host'
        if datagen == 'host' and os.environ.get('QUANONET_NATIVE') == '1':
            datagen = 'native'    # legacy env opt-in == --datagen native
        if datagen not in ('host', 'device', 'native'):
            raise ValueError(f"datagen must be host|device|native, "
                             f"got {datagen!r}")
        if datagen != 'host' and self.input_sampler is not None:
            self.logger.info("custom input_sampler supplied: forcing "
                             "datagen=host (the sampler is a host-side "
                             "function seam)")
            datagen = 'host'
        self.datagen = datagen
        self.num_points = config.get('num_points', 100)
        self.num_points_0 = config.get('num_points_0', 100)
        if config.get('num_cal') is not None:
            self.num_cal = config['num_cal']
        elif self.operator_type in PDE_OPERATORS:
            self.num_cal = 100
        else:
            self.num_cal = 1000

        if self.operator_type not in GENERATOR_MAP:
            raise ValueError(f"Unknown operator type: {self.operator_type}")

    def get_data(self) -> dict:
        """Load-or-generate-and-save; caching bypassed with a custom
        input_sampler (reference data_manager.py:74-106)."""
        filepath = os.path.join(self.data_dir, self.operator_type,
                                self._get_filename())
        if self.input_sampler is None and os.path.exists(filepath):
            self.logger.info(f"Loading cached data from {filepath}")
            try:
                with np.load(filepath) as data:
                    return {k: data[k] for k in data.files}
            except Exception as e:   # a damaged file, e.g. BadZipFile
                self.logger.warning(f"Failed to load cache: {e}. "
                                    f"Regenerating.")

        self.logger.info(f"Generating new data for {self.operator_type}...")
        data_dict = self._generate_and_process()

        if self.input_sampler is None:
            os.makedirs(os.path.dirname(filepath), exist_ok=True)
            np.savez_compressed(filepath, **data_dict)
            self.logger.info(f"Saved data to {filepath}")
        return data_dict

    def _get_filename(self):
        """Cache filename contract (reference data_manager.py:108-121)."""
        c = self.config
        base = (f"{self.operator_type}_{c['num_train']}_{c['num_test']}"
                f"_{self.num_points}_{self.num_points_0}")
        if self.model_type == 'FNO':
            base += "_FNO"
        else:
            base += (f"_{c.get('train_sample_num', 10)}"
                     f"_{c.get('test_sample_num', 100)}")
        if self.datagen != 'host':
            # never mix generators that are not byte-equal to the host
            # path into the reference-contract cache files
            base += f"_dg{self.datagen}"
        return f"{base}.npz"

    def _generate_and_process(self):
        c = self.config
        is_pde = self.operator_type in PDE_OPERATORS
        extra = {}
        if self.datagen == 'device':
            from quanonet_torch.data import device_gen
            raw_gen = (device_gen.generate_pde_operator_data_device if is_pde
                       else device_gen.generate_ode_operator_data_device)
            extra['device'] = c.get('device')
        else:
            raw_gen = (gen.generate_pde_operator_data if is_pde
                       else gen.generate_ode_operator_data)
            extra['use_native'] = (self.datagen == 'native') or None

        def gen_func(nt, nte, *args, **kwargs):
            return raw_gen(self.operator_type, nt, nte,
                           self.num_points, self.num_points_0,
                           num_cal=self.num_cal,
                           input_sampler=self.input_sampler, **extra)

        if self.model_type == 'FNO':
            encoder = pde_fncode if is_pde else ode_fncode
            train_in, _, train_out, test_in, _, test_out = encoder(
                gen_func, c['num_train'], c['num_test'], self.num_points)
            return {
                'train_input': train_in, 'train_output': train_out,
                'test_input': test_in, 'test_output': test_out,
            }

        encoder = pde_encode if is_pde else ode_encode
        (train_branch, train_trunk, train_out,
         test_branch, test_trunk, test_out) = encoder(
            gen_func, c['num_train'], c['num_test'],
            self.num_points, self.num_points_0,
            c.get('train_sample_num', 10), c.get('test_sample_num', 100),
            self.num_cal)
        return {
            'train_branch_input': train_branch,
            'train_trunk_input': train_trunk,
            'train_output': train_out,
            'test_branch_input': test_branch,
            'test_trunk_input': test_trunk,
            'test_output': test_out,
            # combined input for FNN / HEAQNN (data_manager.py:191-192)
            'train_input': np.concatenate([train_branch, train_trunk], axis=1),
            'test_input': np.concatenate([test_branch, test_trunk], axis=1),
        }
