"""Device meshes (``flux_tpu/parallel/mesh.py``).

A frame's work unit is cut over a 2-D grid of devices:

* ``rows`` — row shards: shard ``ri`` renders the rows ``row0 + ri + k·R``
  of a band (interleaved, so that sky rows and geometry rows spread over
  the shards);
* ``spp`` — sample shards: every shard of a row renders the same pixels
  over its own range of sample indices, and the partial sums are added.

In ``flux_tpu`` the grid is a ``jax.sharding.Mesh``; here it is a
:class:`DeviceMesh`, a grid of ``torch.device`` (each the CUDA card or the
CPU) with, under a ``torch.distributed`` process group, the rank that owns
each slot. A device may appear more than once: several shards then take
turns on it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["DeviceMesh", "make_mesh", "pick_mesh_shape", "local_devices", "ROWS_LANE_BUDGET"]


# Per-device wavefront budget (lanes = rows × cols of one sample pass) above
# which an spp-only split is judged memory-bound and the 'rows' axis
# engages; flux_tpu's value, kept so that both packages pick the same mesh
# for the same frame.
ROWS_LANE_BUDGET = 2 << 20


def pick_mesh_shape(
    n_devices: int, n_rows_hint: int = 0, n_cols_hint: int = 0
) -> Tuple[int, int]:
    """Choose (rows_shards, spp_shards) for ``n_devices``.

    Sample sharding is preferred: every device renders the same pixels, so
    the load is balanced by construction. The 'rows' axis doubles while a
    device's per-sample wavefront (local rows × cols lanes of the frame
    hinted by ``n_rows_hint``/``n_cols_hint``) exceeds ROWS_LANE_BUDGET and
    the devices allow it."""
    rows_shards = 1
    lanes = n_rows_hint * max(n_cols_hint, 1)
    while (
        lanes // rows_shards > ROWS_LANE_BUDGET
        and rows_shards * 2 <= n_devices
        and n_devices % (rows_shards * 2) == 0
    ):
        rows_shards *= 2
    return (rows_shards, n_devices // rows_shards)


class DeviceMesh:
    """A ('rows', 'spp') grid of devices. ``devices[ri][si]`` is the device
    of slot (ri, si) and ``ranks[ri][si]`` the process that owns it;
    ``rank`` is this process's (all 0 without a process group)."""

    def __init__(self, devices: List[List[torch.device]], ranks: List[List[int]], rank: int = 0):
        self.devices = devices
        self.ranks = ranks
        self.rank = rank
        self.shape = {"rows": len(devices), "spp": len(devices[0])}

    @property
    def size(self) -> int:
        return self.shape["rows"] * self.shape["spp"]

    def slots(self):
        """Every slot (ri, si), rows major."""
        return [(ri, si) for ri in range(self.shape["rows"]) for si in range(self.shape["spp"])]

    def owned(self):
        """The slots this process renders."""
        return [(ri, si) for ri, si in self.slots() if self.ranks[ri][si] == self.rank]

    def __repr__(self) -> str:
        return f"DeviceMesh(rows={self.shape['rows']}, spp={self.shape['spp']}, devices={self.devices})"


def local_devices(device=None, count: Optional[int] = None) -> List[torch.device]:
    """The devices of the CLI's and the node's ``-t``: on CUDA (the
    default) the first ``count`` visible cards, at most all of them (every
    one without ``count``; a card named by index alone); on the CPU,
    ``count`` shards of it (one without), the counterpart of ``flux_tpu``'s
    virtual CPU devices. Raises where CUDA is asked for and absent."""
    from ..render import resolve_device

    dev = resolve_device(device)
    count = None if count is None else max(1, int(count))
    if dev.type == "cpu":
        return [dev] * (count or 1)
    if dev.index is not None and count is None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())][:count]


def _global_devices(devs: Sequence[torch.device]):
    """(rank, device) of every slot of the process group, ranks in order,
    each rank's own devices in the order it gave them (``flux_tpu``'s
    ``jax.devices()`` across processes), and this process's rank."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return [(0, d) for d in devs], 0
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, [str(d) for d in devs])
    return [(r, torch.device(d)) for r, names in enumerate(everyone) for d in names], dist.get_rank()


def make_mesh(
    devices: Optional[Sequence] = None,
    rows_shards: Optional[int] = 1,
    spp_shards: Optional[int] = None,
    n_rows_hint: int = 0,
    n_cols_hint: int = 0,
) -> DeviceMesh:
    """Build a ('rows', 'spp') mesh over ``devices`` (default: every visible
    CUDA card; it raises without one). Under a ``torch.distributed`` process
    group, ``devices`` are this process's and the mesh spans every
    process's, rank by rank (each process must call this).

    ``rows_shards=None`` picks the shape from the frame hints through
    :func:`pick_mesh_shape`; ``spp_shards=None`` takes the devices left."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices (e.g. [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    slots, rank = _global_devices(devs)
    if rows_shards is None:
        rows_shards, auto_spp = pick_mesh_shape(len(slots), n_rows_hint, n_cols_hint)
        if spp_shards is None:
            spp_shards = auto_spp
    if spp_shards is None:
        spp_shards = len(slots) // rows_shards
    if rows_shards < 1 or spp_shards < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got rows={rows_shards} spp={spp_shards} "
            f"over {len(slots)} devices"
        )
    n = rows_shards * spp_shards
    if n > len(slots):
        raise ValueError(
            f"mesh {rows_shards}x{spp_shards} needs {n} devices, have {len(slots)}"
        )
    grid = [slots[ri * spp_shards:(ri + 1) * spp_shards] for ri in range(rows_shards)]
    return DeviceMesh([[d for _, d in row] for row in grid], [[r for r, _ in row] for row in grid], rank)
