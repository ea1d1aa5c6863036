"""
Scoring cells: passes over a test grid already on the card, as
``quanonet_torch/bench.py``'s ``eval_rel_l2`` scores it: the model's
forward under ``inference_mode`` in ``chunk``-row slices, concatenated,
one copy to the host a pass, and the rel-L2 on the host.

The model is the configuration's released checkpoint, loaded through
``quanonet_torch.infer.load_model``; the reference reads the same file
itself.  Every answer of the first and of the last pass is held against
the reference.

Traffic keys: functions, points (rows = functions x points), chunk,
check_block_rows (the reference's rows a block).
"""
import os
import time

import numpy as np
import torch

from portbench.frozen import inputs, work
from portbench.kinds import Stages
from portbench.reference import ckpt, quanonet as reference



def weights_path(config, root):
    return os.path.join(root, 'portbench', 'configs', config['weights'])


class Cell:
    def __init__(self, config, traffic, seed, device, seconds, root):
        stage = Stages('score')
        from quanonet_torch.infer import load_model
        stage('import the program')
        self.config, self.traffic, self.device = config, traffic, device
        self.path = weights_path(config, root)
        self.model, _ = load_model(
            self.path, inputs.SENSORS, 2, device=str(device),
            model_type='QuanONet', num_qubits=config['num_qubits'],
            net_size=list(config['net_size']),
            scale_coeff=config['scale_coeff'], if_trainable_freq=True,
            ham_bound=list(config['ham_bound']), engine=config['engine'])
        stage('model')
        self.branch, self.trunk, self.target = inputs.advection_grid(
            seed, traffic['functions'], traffic['points'], device)
        stage('data')
        self.chunk = traffic['chunk']
        self.first = self.last = None
        self.warm_unit()
        stage('first pass')

    def score_pass(self):
        """One pass: the predictions (host fp32) and their rel-L2."""
        n, c = self.branch.shape[0], self.chunk
        with torch.inference_mode():
            preds = torch.cat([self.model(self.branch[s:s + c],
                                          self.trunk[s:s + c])
                               for s in range(0, n, c)])
        p = preds.cpu().numpy()
        err = p[:, 0].astype(np.float64) - self.target
        rel = float(np.linalg.norm(err) / (np.linalg.norm(self.target)
                                           + 1e-8))
        return p[:, 0], rel

    def warm_unit(self):
        self.score_pass()

    def run_window(self, seconds):
        """Whole passes until ``seconds`` have passed; each pass ends in its
        copy to the host."""
        n = self.branch.shape[0]
        passes, bad, t0 = 0, 0, time.perf_counter()
        while True:
            p, rel = self.score_pass()
            if self.first is None:
                self.first = p
            passes += 1
            bad += 0 if np.isfinite(rel) else 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.last = p
        elapsed = time.perf_counter() - t0
        chunks = passes * -(-n // self.chunk)
        flops, nbytes = work.circuit_work(self.config, passes * n, False)
        return dict(kind='score', seconds=elapsed, rows=passes * n,
                    units=chunks, attempted=passes, failed=bad, flops=flops,
                    bytes=nbytes)

    def free(self):
        del self.model

    def reference_rows(self, tf32=False):
        params = {k: torch.as_tensor(v, device=self.device)
                  for k, v in ckpt.read(self.path,
                                        self.config['num_qubits']).items()}
        model = reference.QuanONet(self.config, self.device, tf32)
        return model.predict(params, self.branch, self.trunk,
                             self.traffic['check_block_rows'])

    def check(self, limits, tf32=False):
        """[(name, value, limit)]: the widest gap of an answer of the first
        or the last pass from the reference's.  ``tf32`` puts the TF32
        control in the program's place."""
        ref = self.reference_rows()
        if tf32:
            gap = float(np.abs(self.reference_rows(tf32=True) - ref).max())
        else:
            gap = max(float(np.abs(p - ref).max())
                      for p in (self.first, self.last))
        return [('pred_gap', gap, limits['pred_gap'])]
