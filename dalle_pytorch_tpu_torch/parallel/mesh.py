"""Device meshes over torch devices: the port's counterpart of the JAX
package's `parallel/mesh.py` (`MESH_AXES`, `make_mesh`).

A mesh is a 4-D array of `torch.device`s with the axes

  dp    pure data parallelism (params replicated)
  fsdp  data parallelism with sharded params and optimizer state
  tp    tensor (megatron-style) parallelism: heads, FF hidden, vocabulary
  sp    sequence parallelism (ring attention)

in that order, unused axes of size 1. One process drives every device of
the mesh (the sharded serving engines, `serving/sharded.py`); a device may
appear more than once, so two shards can share one card. On the CPU the
mesh's devices are all `torch.device("cpu")`, `CPU_MESH_DEVICES` of them
visible: the analogue of the JAX tests' virtual host devices.

The process helpers of the JAX module (`initialize_distributed`,
`is_root`, `host_barrier`, `put_host_batch`, `gather_to_host`) belong to
multi-process training, which is not ported yet (ROADMAP.md Queue 1 item
8).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

MESH_AXES = ("dp", "fsdp", "tp", "sp")

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
