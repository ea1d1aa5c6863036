"""
Experiment identity, output-directory layout, and logging (the port's own
copy of quanonet_tpu/logger.py).

The run ID and the directory contract are the JAX package's, byte for
byte (reference utils/logger.py:55-118, 121-190): a run ID made here
parses with both packages' ``infer._parse_path``, and a run whose
``metric.json`` exists is resume-skipped.

TensorBoard is optional: ``torch.utils.tensorboard`` is imported at an
:class:`ExperimentLogger`'s first scalar, and left out when it does not
import.
"""
import json
import logging
import os
import sys


def _summary_writer():
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:   # tensorboard optional (any import failure)
        return None
    return SummaryWriter


class StreamToLogger:
    """Redirects stdout/stderr into the logging system
    (reference utils/logger.py:16-28)."""

    def __init__(self, logger, log_level=logging.INFO):
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ''

    def write(self, buf):
        for line in buf.rstrip().splitlines():
            self.logger.log(self.log_level, line.rstrip())

    def flush(self):
        pass


def setup_logger(log_file):
    """File + console logger (reference utils/logger.py:30-53)."""
    os.makedirs(os.path.dirname(log_file), exist_ok=True)
    logger = logging.getLogger('training')
    logger.setLevel(logging.INFO)
    if logger.hasHandlers():
        for h in list(logger.handlers):
            h.close()
        logger.handlers.clear()
    fh = logging.FileHandler(log_file)
    fh.setLevel(logging.INFO)
    ch = logging.StreamHandler(sys.__stdout__)
    ch.setLevel(logging.INFO)
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger


def get_experiment_id(config):
    """Round-trippable run ID (reference utils/logger.py:55-118).

    e.g. ``Antideriv_QuanONet_Net5-1-5-1_Q2_TF_S0.001_1000x100_Seed0``.
    """
    op = config.get('operator', 'Unknown')
    model = config.get('model_type', 'Unknown')
    nt = config.get('num_train', '?')
    np_ = config.get('num_points', '?')
    seed = config.get('seed', 0)

    exp_id = f"{op}_{model}"

    net = config.get('net_size')
    if isinstance(net, (list, tuple)) and len(net) > 0:
        exp_id += "_Net" + "-".join(map(str, net))
    elif net is not None:
        exp_id += f"_Net{net}"

    if model in ['QuanONet', 'HEAQNN']:
        nq = config.get('num_qubits', 5)
        exp_id += f"_Q{nq}"
        if_tf = str(config.get('if_trainable_freq', 'false')).lower() == 'true'
        exp_id += "_TF" if if_tf else "_FF"
        scale = config.get('scale_coeff', 0.01)
        exp_id += f"_S{scale}"
        pauli = config.get('ham_pauli', 'Z')
        if pauli != 'Z':
            exp_id += f"_Pauli{pauli}"
        diag = config.get('ham_diag')
        if diag:
            exp_id += "_Diag" + "-".join(map(str, diag))
        else:
            ham = config.get('ham_bound')
            if ham and isinstance(ham, list) and ham != [-5, 5]:
                exp_id += "_Ham" + "-".join(map(str, ham))
        # noise-aware training: the channel is part of the objective
        noise = config.get('noise_p')
        ro = config.get('readout_p')
        dg = config.get('damp_gamma')
        dp = config.get('dephase_p')
        if noise or ro or dg or dp:
            exp_id += f"_Noise{noise or 0}"
            if ro:
                exp_id += f"R{ro}"
            if dg:
                exp_id += f"G{dg}"
            if dp:
                exp_id += f"F{dp}"
        # QPU-trainable gradients: the estimator is part of the identity
        gm = str(config.get('grad_method') or 'autodiff')
        tsh = config.get('train_shots')
        if gm != 'autodiff' or tsh:
            exp_id += '_' + ('Shift' if gm == 'shift'
                             else 'Spsa' if gm == 'spsa' else 'Shot')
            if gm == 'spsa' and config.get('spsa_c'):
                exp_id += f"C{config['spsa_c']}"
            if tsh:
                exp_id += f"Sh{int(tsh)}"

    # Backend suffix, kept for dirname compat: only the legacy names get
    # one (the reference's default 'mindquantum' got none).
    qb = config.get('quantum_backend', 'mindquantum') or 'mindquantum'
    if model in ['QuanONet', 'HEAQNN'] and qb not in ('mindquantum', 'jax'):
        abbr = {'torchquantum': 'TQ', 'qiskit': 'Qiskit',
                'pennylane': 'PL'}.get(qb, qb)
        exp_id += f"_{abbr}"
    cb = config.get('classical_backend', 'pytorch') or 'pytorch'
    if model not in ['QuanONet', 'HEAQNN'] and cb not in ('pytorch', 'jax'):
        abbr = {'mindspore': 'MS'}.get(cb, cb)
        exp_id += f"_{abbr}"

    exp_id += f"_{nt}x{np_}_Seed{seed}"
    return exp_id


class ExperimentLogger:
    """Directory + TensorBoard + JSON manager
    (reference utils/logger.py:121-190).

    Layout: ``{prefix}/{Operator}/{exp_id}/`` containing train.log,
    train_args.json, metric.json, best_model.* / final.*; TensorBoard
    scalars under ``{prefix}/{Operator}/tensorboard/{exp_id}``.

    ``write=False`` (a rank other than 0 of a multi-GPU run) keeps the
    identity and the paths and writes nothing: no directory, no scalars,
    no metric.json.
    """

    def __init__(self, config, base_output_dir="outputs", write=True):
        self.config = config
        self.operator_name = config.get('operator', 'Unknown')
        self.exp_name = get_experiment_id(config)

        self.base_dir = os.path.join(base_output_dir, self.operator_name)
        self.exp_dir = os.path.join(self.base_dir, self.exp_name)
        self.tb_dir = os.path.join(self.base_dir, "tensorboard", self.exp_name)
        self.text_log_path = os.path.join(self.exp_dir, "train.log")
        self.write = write
        self.writer = None
        if not write:
            return
        os.makedirs(self.exp_dir, exist_ok=True)
        os.makedirs(self.tb_dir, exist_ok=True)

        self.save_args()

    def save_args(self):
        with open(os.path.join(self.exp_dir, "train_args.json"), 'w') as f:
            json.dump(self.config, f, indent=4, default=str)

    def log_metric(self, tag, value, step):
        if not self.write:
            return
        if self.writer is None:     # opened at the first scalar
            writer = _summary_writer()
            self.writer = writer(log_dir=self.tb_dir) if writer else False
        if self.writer:
            self.writer.add_scalar(tag, value, step)

    def save_metrics(self, metrics, history=None):
        if not self.write:
            return
        metric_path = os.path.join(self.exp_dir, "metric.json")
        data = {'metrics': metrics}
        if history is not None:
            data['history'] = history
        tmp = metric_path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(data, f, indent=4, default=str)
        os.replace(tmp, metric_path)  # atomic completion marker
        print(f"Results saved to {metric_path}")

    def get_ckpt_path(self, iteration=None, is_final=False):
        if is_final:
            return os.path.join(self.exp_dir, "final.ckpt")
        if iteration is not None:
            return os.path.join(self.exp_dir, f"iter_{iteration:05d}.ckpt")
        return os.path.join(self.exp_dir, "best_model.ckpt")

    def is_completed(self):
        """Resume-skip marker (reference utils/logger.py:182-185)."""
        return os.path.exists(os.path.join(self.exp_dir, "metric.json"))

    @staticmethod
    def completed(config, base_output_dir="outputs"):
        """Side-effect-free resume-skip probe: True iff the run's
        metric.json exists.  Unlike making an ExperimentLogger, this
        creates no directory and no TensorBoard event file."""
        exp_dir = os.path.join(base_output_dir,
                               config.get('operator', 'Unknown'),
                               get_experiment_id(config))
        return os.path.exists(os.path.join(exp_dir, "metric.json"))

    def close(self):
        if self.writer:
            self.writer.close()
