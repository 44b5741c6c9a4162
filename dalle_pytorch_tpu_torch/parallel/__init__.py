"""Parallelism over devices and processes: meshes and the process helpers
(`mesh.py`), the parameter and decode-state placement rules
(`partition.py`, `serving_partition.py`), tensor parallelism by hand
(`tensor_parallel.py`: serving's shards in one process, training's one
a rank), and for training over several processes the collectives
(`collectives.py`), data-parallel and fully sharded training
(`fsdp.py`), ring attention (`ring.py`) and the GPipe pipeline
(`gpipe.py`); counterparts of the JAX package's `parallel/` modules of
those names. Serving is sharded over tp (`serving/sharded.py`), the
DALLE's training over dp, fsdp, tp, sp and pp (`train_dalle.py`), the
dVAE's over dp and fsdp (`train_vae.py`)."""

from dalle_pytorch_tpu_torch.parallel.collectives import Collectives
from dalle_pytorch_tpu_torch.parallel.fsdp import FSDP, gathered
from dalle_pytorch_tpu_torch.parallel.gpipe import gpipe_apply, make_pp_mesh, pipeline_layers, stage_layers
from dalle_pytorch_tpu_torch.parallel.mesh import (
    MESH_AXES,
    TRAIN_AXES,
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
    tp_dims,
    vae_fsdp_dims,
)
from dalle_pytorch_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded
from dalle_pytorch_tpu_torch.parallel.serving_partition import decode_state_spec, place_decode_state
from dalle_pytorch_tpu_torch.parallel.tensor_parallel import TensorParallelDALLE, TrainingShards, shard_sum

__all__ = [
    "Collectives", "DeviceMesh", "FSDP", "MESH_AXES", "TRAIN_AXES", "TensorParallelDALLE", "TrainMesh",
    "TrainingShards", "decode_state_spec", "fsdp_dims", "fsdp_shard", "gathered", "gpipe_apply",
    "host_barrier", "initialize_distributed", "is_local_root", "is_root", "make_mesh", "make_pp_mesh",
    "make_train_mesh", "param_partition_spec", "partition_params", "pipeline_layers",
    "place_decode_state", "ring_attention", "ring_attention_sharded", "shard_sum", "stage_layers",
    "tp_dims", "vae_fsdp_dims",
]
