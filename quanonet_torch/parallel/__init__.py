"""
The port's multi-GPU layer (counterpart of quanonet_tpu/parallel/): one
process a rank over ``torch.distributed`` (comm.py, launch.py), data
parallelism (mesh.py, dp_solver.py), the amplitude-sharded and pipelined
circuit engines (amplitude.py, pipeline.py) and their model-engine routing
(shard_engine.py).
"""
from quanonet_torch.parallel.mesh import (
    make_dp_train_step, make_mesh, replicate, shard_batch,
)
from quanonet_torch.parallel.pipeline import make_pipeline_hea
from quanonet_torch.parallel.shard_engine import (
    clear_shard_context, get_shard_context, set_shard_context,
)
