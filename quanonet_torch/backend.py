"""
Backend manager: the API of the reference's five-way dispatch (reference
utils/backend.py:5-132), kept so that reference-style code calling
``backend.check_compatibility`` works (counterpart of
quanonet_tpu/backend.py).  The port has one engine, so every combination
of model and backend names resolves to the PyTorch solver.
"""
import torch
import torch.distributed as dist

QUANTUM_MODELS = ('QuanONet', 'HEAQNN')
CLASSICAL_MODELS = ('DeepONet', 'FNN', 'FNO')


class BackendManager:
    """The reference's BackendManager with a single target, 'torch'."""

    def check_compatibility(self, model_type, quantum_backend='torch',
                            classical_backend='pytorch'):
        """(model, quantum backend, classical backend) -> solver target:
        always 'torch'; the legacy backend names are accepted, not
        dispatched."""
        if model_type not in QUANTUM_MODELS + CLASSICAL_MODELS:
            raise ValueError(
                f"Unknown model type '{model_type}'. Supported: "
                f"{QUANTUM_MODELS + CLASSICAL_MODELS}")
        return 'torch'

    def device_summary(self):
        """The platform and its devices: the CUDA cards by name when one
        is present, else the CPU; inside a world of ranks
        (``torch.distributed`` initialised: parallel/launch.py or
        ``torchrun``) also this process's rank and the world size."""
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            out = {'platform': 'cuda', 'num_devices': n,
                   'devices': [torch.cuda.get_device_name(i)
                               for i in range(n)]}
        else:
            out = {'platform': 'cpu', 'num_devices': 1, 'devices': ['cpu']}
        if dist.is_available() and dist.is_initialized():
            out.update(rank=dist.get_rank(),
                       world_size=dist.get_world_size())
        return out


backend = BackendManager()
