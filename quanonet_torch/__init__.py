"""
quanonet_torch — the PyTorch/CUDA port of quanonet_tpu for one NVIDIA
Hopper card (H100).

The JAX package ``quanonet_tpu`` stays the reference; this package keeps
its own copies of everything it needs and imports nothing of it.  Plain
tensor code is PyTorch; every TPU (Pallas) kernel on a ported path is a
CUDA C++ kernel written by hand for ``sm_90a`` (``csrc/``), built from
source at first use (``ops/_build.py``), with a plain PyTorch version
beside it that the CPU path and the tests use.

Entry points (``infer.load_model``, ``serve.Predictor``, the
``python -m quanonet_torch.infer`` / ``.serve`` CLIs) run on ``cuda``
unless the caller passes ``device='cpu'``; without a card they raise
instead of carrying on on the CPU.  Multi-GPU runs are one process a
rank (``parallel/``); ``backend.device_summary()`` reports the rank and
the world size inside a world.
"""
import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is present); ``'cpu'``
    or a ``cuda`` device name -> that device.  The CPU runs only when it
    is asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "quanonet_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        return torch.device('cuda')
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} was asked for but CUDA is "
                           f"not available")
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
