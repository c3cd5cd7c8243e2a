"""Thin-lens camera: the orthonormal basis and primary-ray generation
(``flux_tpu/camera.py``).

The math mirrors the reference: basis construction in float64
(fluxcore/src/scene.rs:22-35), the thin-lens direction (trace.rs:44-51) and
the per-pixel view-plane coordinates with the reference's ``img_h - row``
vertical flip (trace.rs:75).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .scene import CameraData, CameraSettings
from .vec import Vec3, normalize

__all__ = ["CameraBasis", "CameraTensors", "camera_tensors", "camera_from_numpy", "primary_rays"]

CAMERA_FIELDS = (
    "eye", "u", "v", "w", "focal_distance", "lens_radius", "vp_factor", "adjusted_pixel_size",
)


@dataclass(frozen=True)
class CameraBasis:
    """Orthonormal (u, v, w) view basis (scene.rs:22-35): w points from
    look_at toward the eye; u is right; v is up in view space."""

    u: np.ndarray
    v: np.ndarray
    w: np.ndarray

    @staticmethod
    def new(s: CameraSettings) -> "CameraBasis":
        eye = np.asarray(s.eye, np.float64)
        look_at = np.asarray(s.look_at, np.float64)
        up = np.asarray(s.up, np.float64)
        w = eye - look_at
        w = w / np.linalg.norm(w)
        u = np.cross(up, w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        return CameraBasis(u=u, v=v, w=w)


@dataclass(frozen=True, eq=False)
class CameraTensors:
    """Camera constants on one device (the twin of ``CameraArrays``);
    ``host`` keeps the float32 numpy values they were made from."""

    eye: torch.Tensor  # (3,)
    u: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    w: torch.Tensor  # (3,)
    focal_distance: torch.Tensor  # ()
    lens_radius: torch.Tensor  # ()
    vp_factor: torch.Tensor  # () focal_distance / view_plane_distance (trace.rs:45)
    adjusted_pixel_size: torch.Tensor  # () pixel_size / zoom_factor (trace.rs:60)
    host: dict = field(default=None, repr=False)


def camera_from_numpy(arrays: dict, device) -> CameraTensors:
    """CameraTensors from the JAX package's ``CameraArrays`` fields as numpy
    arrays, so both packages compute on the same float32 constants."""
    host = {k: np.asarray(arrays[k], np.float32).copy() for k in CAMERA_FIELDS}
    tensors = {k: torch.from_numpy(v.copy()).to(device) for k, v in host.items()}
    return CameraTensors(host=host, **tensors)


def camera_tensors(
    settings: CameraSettings, data: CameraData, pixel_size: float, device
) -> CameraTensors:
    basis = CameraBasis.new(settings)
    return camera_from_numpy(
        {
            "eye": settings.eye,
            "u": basis.u,
            "v": basis.v,
            "w": basis.w,
            "focal_distance": data.focal_distance,
            "lens_radius": data.lens_radius,
            "vp_factor": data.focal_distance / data.view_plane_distance,
            "adjusted_pixel_size": pixel_size / data.zoom_factor,
        },
        device,
    )


def primary_rays(cam: CameraTensors, row, col, img_w: int, img_h: int, sx, sy, lx, ly):
    """Thin-lens primary rays for a wavefront (SoA lanes).

    ``row``/``col`` are integer tensors (any broadcastable shape), ``sx``/
    ``sy`` the unit-square anti-aliasing jitter, ``lx``/``ly`` the unit-disc
    lens sample. Returns ``(origin, direction)`` as :class:`Vec3`.
    """
    half_w = float(np.float32(img_w * 0.5))
    half_h = float(np.float32(img_h * 0.5))
    px = cam.adjusted_pixel_size * (col.to(torch.float32) - half_w + sx)
    py = cam.adjusted_pixel_size * ((float(img_h) - row.to(torch.float32)) - half_h + sy)

    lpx = lx * cam.lens_radius
    lpy = ly * cam.lens_radius

    dx = px * cam.vp_factor - lpx
    dy = py * cam.vp_factor - lpy

    u, v, w = Vec3.splat(cam.u), Vec3.splat(cam.v), Vec3.splat(cam.w)
    d = Vec3(
        dx * u.x + dy * v.x - cam.focal_distance * w.x,
        dx * u.y + dy * v.y - cam.focal_distance * w.y,
        dx * u.z + dy * v.z - cam.focal_distance * w.z,
    )
    d = normalize(d)
    o = Vec3(
        cam.eye[0] + lpx * u.x + lpy * v.x,
        cam.eye[1] + lpx * u.y + lpy * v.y,
        cam.eye[2] + lpx * u.z + lpy * v.z,
    )
    return o, d
