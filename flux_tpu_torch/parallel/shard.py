"""Cooperative rendering of one work unit over a device mesh
(``flux_tpu/parallel/shard.py``).

``flux_tpu`` jits one ``shard_map`` program over a ('rows', 'spp') mesh;
here every slot of the mesh is one plain launch of the existing kernels on
its own device (the sweep or the scene megakernel on a card, their plain
version on the CPU):

* row shard ``ri`` renders the rows ``row0 + ri + k·R`` of the band
  (``row_stride = R``), ``⌈n_rows / R⌉`` of them; rows past the band are
  rendered and dropped;
* sample shard ``si`` renders the sample indices ``[s0 + si·per_dev,
  s0 + (si+1)·per_dev)``, ``per_dev = ⌈n / S⌉``, the last one masked at
  ``s0 + n`` (``s_limit``); a shard whose range lies past it adds zeros;
* the spp partials of a row are added in shard order, a fixed association,
  and the (R, n_local) blocks are de-interleaved into image order.

A row shard is cut as its band's launch would be (the split on the card,
the sample chunks on the CPU), so a rows-only mesh gives the single-device
``Renderer``'s bits, and so do progressive, adaptive and checkpointed
renders on it. Sample shards change a pixel's association: they agree with
it to float32 rounding.

Under a ``torch.distributed`` process group every process renders its own
slots of the global mesh; the partials are exchanged by ``all_gather`` and
added in the same shard order, so the result equals the one-process mesh
of that shape bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..metrics import span
from ..render import Renderer, finalize
from ..scene import SceneData
from .mesh import DeviceMesh, make_mesh

__all__ = ["MeshRenderer", "slot_launch"]


def slot_launch(row0: int, n_rows: int, s0: int, n_samples: int, rows_shards: int, spp_shards: int,
                ri: int, si: int) -> dict:
    """The launch of slot (ri, si) of a (rows_shards, spp_shards) mesh for
    a band of ``n_rows`` rows over samples [s0, s0 + n_samples): the
    arguments of ``Renderer.render_rows_sum_range`` (and of the kernel
    wrappers, without ``band_rows``)."""
    per_dev = -(-n_samples // spp_shards)  # the last shard masks the overhang
    base = s0 + si * per_dev
    return dict(row0=row0 + ri, n_rows=-(-n_rows // rows_shards), s0=base, n_samples=per_dev,
                row_stride=rows_shards, s_limit=min(base + per_dev, s0 + n_samples), band_rows=n_rows)


class MeshRenderer:
    """Drop-in renderer that shards each work unit over a device mesh: the
    ``render_rows_sum``, ``render_rows_sum_range``, ``render_rows``,
    ``render_rows_local`` and ``render_image`` of ``flux_tpu``'s, so that a
    ``LocalWorker`` and ``ProgressiveRenderer.from_renderer`` take it as
    they take :class:`~flux_tpu_torch.render.Renderer`.

    The scene, camera, lights, ``Intersector`` and block tables are built
    once per distinct device of the mesh that this process owns (a
    ``Renderer`` each). Without ``mesh``, the mesh is every visible CUDA
    card, its shape picked from the frame (``rows_shards=None``) or given.
    ``target_lanes`` sizes the sample chunks on the CPU as in ``Renderer``.
    """

    def __init__(
        self,
        scene_data: SceneData,
        sample_root: int,
        max_depth: int,
        seed: int = 0,
        mesh: Optional[DeviceMesh] = None,
        rows_shards: Optional[int] = None,
        target_lanes: int = 1 << 20,
        accel: Optional[str] = None,
        nee: bool = False,
        physical: bool = False,
    ):
        out = scene_data.output_settings
        self.scene_data = scene_data
        self.width = out.image_width
        self.height = out.image_height
        self.mesh = (
            mesh
            if mesh is not None
            else make_mesh(rows_shards=rows_shards, n_rows_hint=self.height, n_cols_hint=self.width)
        )
        self._renderers: Dict[torch.device, Renderer] = {}
        for ri, si in self.mesh.owned():
            dev = self.mesh.devices[ri][si]
            if dev not in self._renderers:
                self._renderers[dev] = Renderer(
                    scene_data, sample_root, max_depth, seed=seed, device=dev,
                    target_lanes=target_lanes, accel=accel, nee=nee, physical=physical,
                )
        first = next(iter(self._renderers.values()), None)
        if first is None:
            raise ValueError(f"process {self.mesh.rank} owns no slot of {self.mesh}")
        # Where this process's results land: its first slot's device.
        self.device = first.device
        self.root = first.root
        self.max_depth = first.max_depth
        self.seed = first.seed
        self.accel = first.accel
        self.lights = first.lights
        self.nee = first.nee
        self.physical = first.physical
        self.target_lanes = first.target_lanes

    def render_rows_sum(self, row0: int, n_rows: int) -> torch.Tensor:
        """Radiance sum over all root² samples for a row band."""
        return self.render_rows_sum_range(row0, n_rows, 0, self.root * self.root)

    def render_rows_sum_range(
        self, row0: int, n_rows: int, s0: int, n_samples: int, with_stats: bool = False
    ) -> torch.Tensor:
        """Radiance sum over sample indices [s0, s0 + n_samples) for a row
        band, cooperatively over the whole mesh: ``(n_rows, width, 3)``, or
        4 channels with ``with_stats``, on ``self.device``."""
        rows = self._row_sums(row0, n_rows, s0, int(n_samples), with_stats, gather_all=True)
        R = self.mesh.shape["rows"]
        # De-interleave: block ri, row k is global row row0 + ri + k·R; a
        # (R, n_local) transpose restores image order, then the padding
        # rows of uneven shards are cropped.
        out = torch.stack([rows[ri].to(self.device) for ri in range(R)], dim=1)
        return out.reshape(-1, *out.shape[2:])[:n_rows]

    def render_rows(self, row0: int, n_rows: int) -> np.ndarray:
        """Final (averaged, tone-mapped) pixels for rows [row0, row0+n_rows)."""
        acc = self.render_rows_sum(row0, n_rows)
        with span("unit.readback"):
            return finalize(acc, root=self.root).cpu().numpy()

    def render_rows_local(self, row0: int, n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
        """The rows of a band that this process's row shards rendered:
        ``(global_rows, pixels)``, the rows' indices (stride rows_shards)
        and their finalized pixels, for a master to assemble. Its spp
        partials are gathered only where another process holds some."""
        R = self.mesh.shape["rows"]
        mine = sorted({ri for ri, _ in self.mesh.owned()})
        rows = self._row_sums(row0, n_rows, 0, self.root * self.root, False, gather_all=False)
        n_local = -(-n_rows // R)
        inv = np.float32(1.0 / (self.root * self.root))
        rows_idx, pixels = [], []
        for ri in mine:
            acc = rows[ri].cpu().numpy()
            # finalize() in numpy, the same elementwise float32 operations:
            # the average, then max_to_one's reciprocal-multiply (x * (1/m),
            # not x / m, which can differ by an ulp).
            img = acc * inv
            m = img.max(axis=-1, keepdims=True)
            scale = np.where(m > 1.0, np.float32(1.0) / m, np.float32(1.0))
            img = (img * scale).astype(np.float32)
            grows = row0 + ri + np.arange(n_local, dtype=np.int64) * R
            keep = grows < row0 + n_rows
            rows_idx.append(grows[keep])
            pixels.append(img[keep])
        if not rows_idx:
            return np.zeros((0,), np.int64), np.zeros((0, self.width, 3), np.float32)
        return np.concatenate(rows_idx), np.concatenate(pixels)

    def render_image(self, rows_per_band: Optional[int] = None) -> np.ndarray:
        """Render the full frame, band by band."""
        rows_per_band = rows_per_band or min(self.height, 64)
        out = np.zeros((self.height, self.width, 3), np.float32)
        r = 0
        while r < self.height:
            n = min(rows_per_band, self.height - r)
            out[r : r + n] = self.render_rows(r, n)
            r += n
        return out

    def _row_sums(self, row0, n_rows, s0, n_samples, with_stats, gather_all):
        """Each row shard's sum over every spp shard, ``{ri: (n_local,
        width, C)}``: every row with ``gather_all``, else the rows whose
        spp shards this process renders."""
        R, S = self.mesh.shape["rows"], self.mesh.shape["spp"]
        if s0 < 0 or s0 + n_samples >= 1 << 32:
            raise ValueError(f"sample range [{s0}, {s0 + n_samples}) outside uint32")
        n_local = -(-n_rows // R)
        parts = {}
        for ri, si in self.mesh.owned():
            parts[ri, si] = self._renderers[self.mesh.devices[ri][si]].render_rows_sum_range(
                with_stats=with_stats, **slot_launch(row0, n_rows, s0, n_samples, R, S, ri, si))
        rows_needed = range(R) if gather_all else sorted({ri for ri, _ in self.mesh.owned()})
        others = any(r != self.mesh.rank for row in self.mesh.ranks for r in row)
        if others and (gather_all or self._spp_spans_processes()):
            parts = self._all_gather(parts, (n_local, self.width, 4 if with_stats else 3))
        # Launches on several cards may still run: finish them before the
        # sums read their results.
        for dev in {p.device for p in parts.values()}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        rows = {}
        for ri in rows_needed:
            # The first device of the row adds its spp partials in shard order.
            dev = parts[ri, 0].device
            acc = parts[ri, 0]
            for si in range(1, S):
                acc = acc + parts[ri, si].to(dev)
            rows[ri] = acc
        return rows

    def _spp_spans_processes(self) -> bool:
        """True where some row's spp shards belong to more than one process."""
        return any(len(set(row)) > 1 for row in self.mesh.ranks)

    def _all_gather(self, parts, shape):
        """Every slot's partial on this process: each process contributes a
        buffer of every slot (its own filled), and slot (ri, si) is read
        from its owner's. On the CPU for gloo, on this process's card for
        NCCL."""
        import torch.distributed as dist

        dev = self.device if dist.get_backend() == "nccl" else torch.device("cpu")
        slots = self.mesh.slots()
        buf = torch.zeros((len(slots), *shape), dtype=torch.float32, device=dev)
        for k, (ri, si) in enumerate(slots):
            if (ri, si) in parts:
                buf[k] = parts[ri, si].to(dev)
        bufs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
        dist.all_gather(bufs, buf)
        return {(ri, si): bufs[self.mesh.ranks[ri][si]][k] for k, (ri, si) in enumerate(slots)}
