"""Parallelism over devices: meshes (`mesh.py`), the parameter and
decode-state placement rules (`partition.py`, `serving_partition.py`) and
tensor parallelism by hand (`tensor_parallel.py`); counterparts of the
JAX package's `parallel/` modules of those names. Only serving is sharded
so far (`serving/sharded.py`)."""

from dalle_pytorch_tpu_torch.parallel.mesh import MESH_AXES, DeviceMesh, make_mesh
from dalle_pytorch_tpu_torch.parallel.partition import param_partition_spec, partition_params
from dalle_pytorch_tpu_torch.parallel.serving_partition import decode_state_spec, place_decode_state
from dalle_pytorch_tpu_torch.parallel.tensor_parallel import TensorParallelDALLE, shard_sum

__all__ = [
    "DeviceMesh", "MESH_AXES", "TensorParallelDALLE", "decode_state_spec", "make_mesh",
    "param_partition_spec", "partition_params", "place_decode_state", "shard_sum",
]
