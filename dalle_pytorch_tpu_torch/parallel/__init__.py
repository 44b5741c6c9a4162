"""Parallelism over devices and processes: meshes and the process helpers
(`mesh.py`), the parameter and decode-state placement rules
(`partition.py`, `serving_partition.py`), tensor parallelism by hand
(`tensor_parallel.py`), and for training over several processes the
collectives (`collectives.py`), data-parallel and fully sharded training
(`fsdp.py`) and ring attention (`ring.py`); counterparts of the JAX
package's `parallel/` modules of those names. Serving is sharded over tp
(`serving/sharded.py`), training over dp, fsdp and sp
(`train_dalle.py`)."""

from dalle_pytorch_tpu_torch.parallel.collectives import Collectives
from dalle_pytorch_tpu_torch.parallel.fsdp import FSDP, gathered
from dalle_pytorch_tpu_torch.parallel.mesh import (
    MESH_AXES,
    DeviceMesh,
    TrainMesh,
    host_barrier,
    initialize_distributed,
    is_local_root,
    is_root,
    make_mesh,
    make_train_mesh,
)
from dalle_pytorch_tpu_torch.parallel.partition import (
    fsdp_dims,
    fsdp_shard,
    param_partition_spec,
    partition_params,
)
from dalle_pytorch_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded
from dalle_pytorch_tpu_torch.parallel.serving_partition import decode_state_spec, place_decode_state
from dalle_pytorch_tpu_torch.parallel.tensor_parallel import TensorParallelDALLE, shard_sum

__all__ = [
    "Collectives", "DeviceMesh", "FSDP", "MESH_AXES", "TensorParallelDALLE", "TrainMesh",
    "decode_state_spec", "fsdp_dims", "fsdp_shard", "gathered", "host_barrier",
    "initialize_distributed", "is_local_root", "is_root", "make_mesh",
    "make_train_mesh", "param_partition_spec", "partition_params", "place_decode_state",
    "ring_attention", "ring_attention_sharded", "shard_sum",
]
