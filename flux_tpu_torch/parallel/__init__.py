"""flux_tpu_torch.parallel — rendering one frame over several devices
(``flux_tpu.parallel``): a ('rows', 'spp') mesh of devices, the
``MeshRenderer`` that cuts each work unit over it, and the process group
that spans hosts."""

from .distributed import init_multihost
from .mesh import DeviceMesh, local_devices, make_mesh, pick_mesh_shape
from .shard import MeshRenderer, slot_launch

__all__ = [
    "init_multihost",
    "make_mesh",
    "pick_mesh_shape",
    "DeviceMesh",
    "local_devices",
    "MeshRenderer",
    "slot_launch",
]
