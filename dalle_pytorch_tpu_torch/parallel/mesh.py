"""Device meshes over torch devices: the port's counterpart of the JAX
package's `parallel/mesh.py` (`MESH_AXES`, `make_mesh`, the process
helpers).

A mesh is a 4-D array of `torch.device`s with the axes

  dp    pure data parallelism (params replicated)
  fsdp  data parallelism with sharded params and optimizer state
  tp    tensor (megatron-style) parallelism: heads, FF hidden, vocabulary
  sp    sequence parallelism (ring attention)

in that order, unused axes of size 1. Two kinds of mesh serve the two
halves of the port.

* `DeviceMesh` (serving): one process drives every device of the mesh
  (the sharded serving engines, `serving/sharded.py`); a device may
  appear more than once, so two shards can share one card. On the CPU the
  mesh's devices are all `torch.device("cpu")`, `CPU_MESH_DEVICES` of
  them visible: the analogue of the JAX tests' virtual host devices.
* `TrainMesh` (training): one process a GPU, the PyTorch idiom where the
  JAX trainer runs one controller a host and GSPMD inserts the
  collectives. The mesh is a grid of `torch.distributed` ranks over
  `TRAIN_AXES`, the four axes and `pp` (pipeline stages: the JAX
  trainer's `MESH_AXES + ("pp",)`), rank = the row-major index of its
  (dp, fsdp, tp, sp, pp) coordinates; each rank knows its coordinates and
  holds a process group for each axis of size above 1, and one for the
  data axes (dp and fsdp together, the batch's axes: `batch_spec`).
  `make_train_mesh` resolves dp = -1 as `make_mesh` does; a pure-pp mesh
  (every other axis 1) is `parallel/gpipe.py:make_pp_mesh`.

The process helpers of the JAX module: `initialize_distributed` (the
launcher's `DALLE_TPU_*` variables, or torch's `RANK` / `WORLD_SIZE` /
`MASTER_ADDR` / `MASTER_PORT`; nothing at one process), `is_root`,
`is_local_root` and `host_barrier`. The JAX `put_host_batch` has no
twin: each rank puts its own rows on its device (`data/prefetch.py:
to_device`), and the global batch is the data ranks' rows in rank order.
The JAX `gather_to_host` is `parallel/fsdp.py:gathered`, the full
parameters on every rank (a collective every rank runs). The backend is a
rule, not a knob (`process_backend`): NCCL when each rank of a host has a
GPU of its own, Gloo on the CPU or when ranks share a card; a rank's
device is `cuda:{LOCAL_RANK % device_count}` (`rank_device`).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dalle_pytorch_tpu_torch.parallel.collectives import Collectives

MESH_AXES = ("dp", "fsdp", "tp", "sp")
#: the axes of a training mesh: the four and the pipeline's stages
TRAIN_AXES = MESH_AXES + ("pp",)

#: devices a CPU mesh may use (the JAX tests force 8 virtual host devices)
CPU_MESH_DEVICES = 8


class DeviceMesh:
    """A 4-axis mesh of torch devices (`MESH_AXES` order)."""

    def __init__(self, devices: np.ndarray):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(MESH_AXES):
            raise ValueError(f"a mesh is {len(MESH_AXES)}-D ({MESH_AXES}), got shape {devices.shape}")
        self.devices = devices
        self.axis_names = MESH_AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(MESH_AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, every other axis at index 0."""
        k = MESH_AXES.index(axis)
        index = [0] * len(MESH_AXES)
        index[k] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def visible_devices(device="cuda") -> List[torch.device]:
    """The devices a mesh may take for `device`'s type: every visible card
    for CUDA, `CPU_MESH_DEVICES` entries of the CPU for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.type == "cpu":
        return [torch.device("cpu")] * CPU_MESH_DEVICES
    raise ValueError(f"no mesh over {dev.type} devices")


def make_mesh(
    dp: int = -1,
    fsdp: int = 1,
    tp: int = 1,
    sp: int = 1,
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Build the 4-axis mesh over `devices` (default: the visible cards).
    dp=-1 absorbs the remaining devices."""
    devices = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    n = len(devices)
    fixed = fsdp * tp * sp
    if dp == -1:
        if fixed < 1 or n % fixed:
            raise ValueError(f"{n} devices not divisible by fsdp*tp*sp={fixed}")
        dp = n // fixed
    if dp * fixed != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp}x{sp} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return DeviceMesh(arr.reshape(dp, fsdp, tp, sp))


# ------------------------------------------------------------- processes

#: seconds a collective may wait before the group raises (a rank that
#: skips one would otherwise hang the others)
DIST_TIMEOUT_S = 600.0


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def process_backend(device) -> str:
    """The backend of a run on `device`: NCCL when each rank of this host
    has a GPU of its own (`LOCAL_WORLD_SIZE` ranks, at most one a card),
    Gloo on the CPU or when ranks share a card (NCCL refuses two ranks on
    one GPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE") or 1
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device for a run on `device`: `cuda:{LOCAL_RANK %
    device_count}` for CUDA, the CPU as given."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", (_env_int("LOCAL_RANK") or 0) % max(1, torch.cuda.device_count()))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cpu",
    init_method: Optional[str] = None,
    timeout_s: float = DIST_TIMEOUT_S,
) -> Optional[str]:
    """Join the run's process group (once a process, before any
    collective) and return its backend; None at one process.

    Rendezvous info comes from (in precedence order) the arguments, the
    launcher's DALLE_TPU_COORDINATOR (host:port) / DALLE_TPU_NUM_PROCS /
    DALLE_TPU_PROC_ID, or torch's MASTER_ADDR:MASTER_PORT / WORLD_SIZE /
    RANK. With one process or none named it does nothing, so the trainers
    call it unconditionally. `init_method` (e.g. "file://...") replaces
    the TCP rendezvous; the backend follows `process_backend(device)`."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("DALLE_TPU_COORDINATOR") or None
        if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("DALLE_TPU_NUM_PROCS", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("DALLE_TPU_PROC_ID", "RANK")
    if num_processes is None or num_processes <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    if init_method is None:
        if coordinator_address is None:
            raise ValueError(f"{num_processes} processes need a coordinator address (host:port)")
        init_method = f"tcp://{coordinator_address}"
    if process_id is None:
        raise ValueError(f"{num_processes} processes need this process's rank")
    backend = process_backend(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return backend


def is_root() -> bool:
    """Global rank 0 (the reference's `is_root_worker`); True without a
    process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def is_local_root() -> bool:
    """The first process of this host (the reference's
    `is_local_root_worker`)."""
    return (_env_int("LOCAL_RANK") or 0) == 0


def host_barrier() -> None:
    """Every process waits for the others (the reference's
    `local_barrier`); nothing at one process."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class TrainMesh:
    """The ranks of a training run as a (dp, fsdp, tp, sp, pp) grid, and this
    rank's place in it: its coordinates, its device, the process group of
    each axis (None where the axis has one rank) and the collectives over
    them (`comm`, `parallel/collectives.py`). Built without groups (a
    one-rank run, or `groups=None` in tests of the shape alone) every
    group is None."""

    def __init__(self, dp: int = 1, fsdp: int = 1, tp: int = 1, sp: int = 1, rank: int = 0,
                 device="cpu", backend: Optional[str] = None,
                 groups: Optional[Dict[Tuple[str, ...], Tuple[object, List[int]]]] = None,
                 pp: int = 1):
        sizes = (dp, fsdp, tp, sp, pp)
        self.shape = dict(zip(TRAIN_AXES, sizes))
        self.world = int(np.prod(sizes))
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a mesh of {self.world}")
        self.rank = rank
        self.coords = dict(zip(TRAIN_AXES, (int(c) for c in np.unravel_index(rank, sizes))))
        self.device = torch.device(device)
        self.backend = backend
        self.comm = Collectives(backend, self.device)
        self._groups = groups or {}

    def group(self, *axes: str):
        """The process group over `axes` holding this rank, or None when
        they hold only this rank."""
        return self._groups.get(tuple(axes), (None, [self.rank]))[0]

    def group_ranks(self, *axes: str) -> List[int]:
        """The global ranks of this rank's group over `axes`, in group
        order."""
        return self._groups.get(tuple(axes), (None, [self.rank]))[1]

    @property
    def data_rank(self) -> int:
        """This rank's index among the data ranks (dp-major over dp x
        fsdp): its rows are the global batch's rows [data_rank * b, (data_rank
        + 1) * b)."""
        return self.coords["dp"] * self.shape["fsdp"] + self.coords["fsdp"]

    @property
    def data_world(self) -> int:
        return self.shape["dp"] * self.shape["fsdp"]

    def __repr__(self) -> str:
        return (f"TrainMesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


#: the groups a training mesh holds: each axis, and the data axes together
TRAIN_GROUPS = (("dp",), ("fsdp",), ("tp",), ("sp",), ("pp",), ("dp", "fsdp"))


def make_train_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, sp: int = 1, device="cpu",
                    pp: int = 1) -> TrainMesh:
    """The training mesh over this run's processes (one without a process
    group); dp = -1 absorbs the remaining ranks. Every rank makes the same
    `dist.new_group` calls in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    fixed = fsdp * tp * sp * pp
    if dp == -1:
        if fixed < 1 or world % fixed:
            raise ValueError(f"{world} processes not divisible by fsdp*tp*sp*pp={fixed}")
        dp = world // fixed
    if dp * fixed != world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp}x{sp}x{pp} != {world} processes")
    shape = (dp, fsdp, tp, sp, pp)
    grid = np.arange(world).reshape(shape)
    groups = {}
    for axes in TRAIN_GROUPS:
        if world == 1 or all(shape[TRAIN_AXES.index(a)] == 1 for a in axes):
            continue
        keep = [TRAIN_AXES.index(a) for a in axes]
        rest = [k for k in range(len(TRAIN_AXES)) if k not in keep]
        # one row of ranks for each coordinate of the other axes
        rows = grid.transpose(rest + keep).reshape(-1, int(np.prod([shape[k] for k in keep])))
        for row in rows:
            ranks = [int(r) for r in row]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axes] = (group, ranks)
    backend = dist.get_backend() if dist.is_initialized() else None
    return TrainMesh(dp, fsdp, tp, sp, rank=rank, device=device, backend=backend, groups=groups, pp=pp)

