"""
Metrics (the port's own copy of quanonet_tpu/metrics.py).
"""
import numpy as np


def _to_numpy(x):
    """Coerce torch tensors / lists to numpy."""
    if hasattr(x, 'detach'):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def compute_metrics(y_true, y_pred):
    """MSE / MAE / Max_Error over flattened arrays."""
    t = np.ravel(_to_numpy(y_true)).astype(np.float64)
    p = np.ravel(_to_numpy(y_pred)).astype(np.float64)
    return {
        'MSE': float(np.mean((t - p) ** 2)),
        'MAE': float(np.mean(np.abs(t - p))),
        'Max_Error': float(np.max(np.abs(t - p))),
    }


def rel_l2(y_true, y_pred, eps=1e-8):
    """Relative L2 = ||pred - true||_2 / (||true||_2 + eps)."""
    t = np.ravel(_to_numpy(y_true)).astype(np.float64)
    p = np.ravel(_to_numpy(y_pred)).astype(np.float64)
    return float(np.linalg.norm(p - t) / (np.linalg.norm(t) + eps))


def count_parameters(params) -> int:
    """Trainable real parameters of a module, a state_dict or an iterable
    of tensors; complex tensors count twice (the counterpart of
    quanonet_tpu/metrics.py count_parameters; reference utils/utils.py:11-45)."""
    if hasattr(params, 'parameters'):
        params = params.parameters()
    elif hasattr(params, 'values'):
        params = params.values()
    total = 0
    for t in params:
        complex_ = (t.is_complex() if hasattr(t, 'is_complex')
                    else np.iscomplexobj(t))
        total += int(np.prod(np.shape(t))) * (2 if complex_ else 1)
    return total
