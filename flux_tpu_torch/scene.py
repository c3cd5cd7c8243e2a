"""Scene schema, YAML loading, and compilation to device tensors.

The serializable side is this package's own copy of ``flux_tpu/scene.py``'s
schema: plain dataclasses that accept the reference YAML unchanged
(scenes/demo1.yml and demo2.yml load as they are, anchors included;
fluxcore/src/scene.rs:42-74, shapes.rs:15-81). ``SceneData.to_dict`` and
``from_dict`` interchange with the JAX package's ``SceneData``.

The runtime side, :class:`SceneTensors`, is the twin of the JAX package's
``SceneArrays``: sphere centers, radii and invert signs, plane points and
normals, triangles in Möller–Trumbore form, and a flat material table
indexed by shape (spheres first, then planes, then triangles), as tensors on
one device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch
import yaml

__all__ = [
    "MaterialKind",
    "MaterialData",
    "SphereData",
    "PlaneData",
    "TriangleData",
    "CameraSettings",
    "CameraData",
    "OutputSettings",
    "SceneData",
    "SceneTensors",
    "load_scene",
    "loads_scene",
    "compile_scene",
    "scene_from_numpy",
    "SCENE_FIELDS",
    "TRI_FIELDS",
]


class MaterialKind:
    """Material kind codes used in the device material table."""

    MATTE = 0
    EMISSIVE = 1
    REFLECTIVE = 2
    GLOSSY = 3


_KIND_NAMES = {
    "Matte": MaterialKind.MATTE,
    "Emissive": MaterialKind.EMISSIVE,
    "Reflective": MaterialKind.REFLECTIVE,
    "GlossyReflective": MaterialKind.GLOSSY,
}
_NAME_BY_KIND = {v: k for k, v in _KIND_NAMES.items()}


def _vec3(v) -> Tuple[float, float, float]:
    x, y, z = (float(c) for c in v)
    return (x, y, z)


@dataclass(frozen=True)
class MaterialData:
    """Tagged material union (reference: shapes.rs:39-81).

    ``color`` is the kind's primary color (diffuse / emissive / reflect) and
    ``param`` its scalar weight (diffuse_coefficient / power / reflect_amount).
    ``ambient_color`` exists only for Matte; the reference parses it into an
    ambient BRDF that its path tracer never evaluates (materials.rs:19-33),
    so it is schema-preserved but unused here as well.
    """

    kind: int
    color: Tuple[float, float, float]
    param: float = 1.0
    exponent: float = 0.0
    ambient_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @staticmethod
    def from_dict(d: dict) -> "MaterialData":
        if len(d) != 1:
            raise ValueError(f"material must have exactly one variant, got {list(d)}")
        (name, body), = d.items()
        if name not in _KIND_NAMES:
            raise ValueError(f"unknown material kind {name!r}")
        kind = _KIND_NAMES[name]
        if kind == MaterialKind.MATTE:
            return MaterialData(
                kind=kind,
                color=_vec3(body["diffuse_color"]),
                param=float(body["diffuse_coefficient"]),
                ambient_color=_vec3(body.get("ambient_color", (1.0, 1.0, 1.0))),
            )
        if kind == MaterialKind.EMISSIVE:
            return MaterialData(
                kind=kind, color=_vec3(body["color"]), param=float(body["power"])
            )
        if kind == MaterialKind.REFLECTIVE:
            return MaterialData(
                kind=kind,
                color=_vec3(body["reflect_color"]),
                param=float(body["reflect_amount"]),
            )
        return MaterialData(
            kind=kind,
            color=_vec3(body["reflect_color"]),
            param=float(body["reflect_amount"]),
            exponent=float(body["reflect_exponent"]),
        )

    def to_dict(self) -> dict:
        name = _NAME_BY_KIND[self.kind]
        if self.kind == MaterialKind.MATTE:
            return {
                name: {
                    "diffuse_color": list(self.color),
                    "ambient_color": list(self.ambient_color),
                    "diffuse_coefficient": self.param,
                }
            }
        if self.kind == MaterialKind.EMISSIVE:
            return {name: {"color": list(self.color), "power": self.param}}
        body = {"reflect_color": list(self.color), "reflect_amount": self.param}
        if self.kind == MaterialKind.GLOSSY:
            body["reflect_exponent"] = self.exponent
        return {name: body}


@dataclass(frozen=True)
class SphereData:
    """Sphere shape record (reference: shapes.rs:15-23)."""

    center: Tuple[float, float, float]
    radius: float
    material: MaterialData
    invert: bool = False

    @staticmethod
    def from_dict(d: dict) -> "SphereData":
        return SphereData(
            center=_vec3(d["center"]),
            radius=float(d["radius"]),
            material=MaterialData.from_dict(d["material"]),
            invert=bool(d.get("invert", False)),
        )

    def to_dict(self) -> dict:
        return {
            "Sphere": {
                "center": list(self.center),
                "radius": self.radius,
                "material": self.material.to_dict(),
                "invert": self.invert,
            }
        }


@dataclass(frozen=True)
class PlaneData:
    """Infinite plane shape record (reference: shapes.rs:30-37)."""

    point: Tuple[float, float, float]
    normal: Tuple[float, float, float]
    material: MaterialData

    @staticmethod
    def from_dict(d: dict) -> "PlaneData":
        return PlaneData(
            point=_vec3(d["point"]),
            normal=_vec3(d["normal"]),
            material=MaterialData.from_dict(d["material"]),
        )

    def to_dict(self) -> dict:
        return {
            "Plane": {
                "point": list(self.point),
                "normal": list(self.normal),
                "material": self.material.to_dict(),
            }
        }


@dataclass(frozen=True)
class TriangleData:
    """Triangle shape record — a flux_tpu extension beyond the reference's
    sphere/plane schema (shapes.rs:68-74 has no mesh geometry). YAML form::

        - Triangle:
            v0: [x, y, z]
            v1: [x, y, z]
            v2: [x, y, z]
            material: {...}

    The geometric normal is ``normalize((v1-v0)×(v2-v0))`` (counter-
    clockwise winding) and is used exactly like an authored plane normal:
    double-sided intersection, no flip toward the ray — the same semantics
    the reference gives planes (shapes.rs:136-151). A ``Mesh`` variant
    (``vertices`` + ``faces`` index lists + one material) expands to
    triangles at load time; ``to_dict`` always writes ``Triangle`` entries,
    so the canonical wire form is flat triangles."""

    v0: Tuple[float, float, float]
    v1: Tuple[float, float, float]
    v2: Tuple[float, float, float]
    material: MaterialData

    @staticmethod
    def from_dict(d: dict) -> "TriangleData":
        return TriangleData(
            v0=_vec3(d["v0"]),
            v1=_vec3(d["v1"]),
            v2=_vec3(d["v2"]),
            material=MaterialData.from_dict(d["material"]),
        )

    def to_dict(self) -> dict:
        return {
            "Triangle": {
                "v0": list(self.v0),
                "v1": list(self.v1),
                "v2": list(self.v2),
                "material": self.material.to_dict(),
            }
        }


def _mesh_to_triangles(body: dict) -> List["TriangleData"]:
    """Expand a ``Mesh`` shape entry (shared vertex list + integer face
    triples + one material) into flat :class:`TriangleData` records."""
    mat = MaterialData.from_dict(body["material"])
    verts = [_vec3(v) for v in body["vertices"]]
    tris: List[TriangleData] = []
    for face in body["faces"]:
        i, j, k = (int(x) for x in face)
        n = len(verts)
        if not (0 <= i < n and 0 <= j < n and 0 <= k < n):
            raise ValueError(f"mesh face {face} indexes outside {n} vertices")
        tris.append(TriangleData(v0=verts[i], v1=verts[j], v2=verts[k], material=mat))
    return tris


@dataclass(frozen=True)
class CameraSettings:
    """Eye / look-at / up (reference: scene.rs:14-18)."""

    eye: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    up: Tuple[float, float, float]


@dataclass(frozen=True)
class CameraData:
    """Thin-lens parameters (reference: scene.rs:51-58)."""

    zoom_factor: float = 1.0
    view_plane_distance: float = 500.0
    focal_distance: float = 10.0
    lens_radius: float = 0.0


@dataclass(frozen=True)
class OutputSettings:
    """Image geometry (reference: scene.rs:60-66)."""

    image_width: int
    image_height: int
    pixel_size: float = 1.0


@dataclass(frozen=True)
class SceneData:
    """Pure-data scene description (reference: scene.rs:37-49).

    Fully serializable: cloned into every Job and shipped to network render
    nodes, exactly as the reference ships it over CBOR (manager.rs:157,
    workers.rs:159) — here via ``to_dict``/``from_dict`` + msgpack.
    """

    scene_name: str
    output_settings: OutputSettings
    background: Tuple[float, float, float]
    shapes: Tuple[object, ...]  # SphereData | PlaneData | TriangleData
    camera_settings: CameraSettings
    camera_data: CameraData

    @staticmethod
    def from_dict(doc: dict) -> "SceneData":
        shapes: List[object] = []
        for entry in doc["shapes"]:
            if len(entry) != 1:
                raise ValueError(f"shape must have exactly one variant: {entry}")
            (name, body), = entry.items()
            if name == "Sphere":
                shapes.append(SphereData.from_dict(body))
            elif name == "Plane":
                shapes.append(PlaneData.from_dict(body))
            elif name == "Triangle":
                shapes.append(TriangleData.from_dict(body))
            elif name == "Mesh":
                shapes.extend(_mesh_to_triangles(body))
            else:
                raise ValueError(f"unknown shape kind {name!r}")
        cs = doc["camera_settings"]
        cd = doc["camera_data"]
        os_ = doc["output_settings"]
        return SceneData(
            scene_name=str(doc["scene_name"]),
            output_settings=OutputSettings(
                image_width=int(os_["image_width"]),
                image_height=int(os_["image_height"]),
                pixel_size=float(os_["pixel_size"]),
            ),
            background=_vec3(doc["background"]),
            shapes=tuple(shapes),
            camera_settings=CameraSettings(
                eye=_vec3(cs["eye"]), look_at=_vec3(cs["look_at"]), up=_vec3(cs["up"])
            ),
            camera_data=CameraData(
                zoom_factor=float(cd["zoom_factor"]),
                view_plane_distance=float(cd["view_plane_distance"]),
                focal_distance=float(cd["focal_distance"]),
                lens_radius=float(cd["lens_radius"]),
            ),
        )

    def to_dict(self) -> dict:
        return {
            "scene_name": self.scene_name,
            "output_settings": {
                "image_width": self.output_settings.image_width,
                "image_height": self.output_settings.image_height,
                "pixel_size": self.output_settings.pixel_size,
            },
            "background": list(self.background),
            "shapes": [s.to_dict() for s in self.shapes],
            "camera_settings": {
                "eye": list(self.camera_settings.eye),
                "look_at": list(self.camera_settings.look_at),
                "up": list(self.camera_settings.up),
            },
            "camera_data": {
                "zoom_factor": self.camera_data.zoom_factor,
                "view_plane_distance": self.camera_data.view_plane_distance,
                "focal_distance": self.camera_data.focal_distance,
                "lens_radius": self.camera_data.lens_radius,
            },
        }


def loads_scene(text: str) -> SceneData:
    """Parse a scene from YAML text (reference loader: flux/src/main.rs:28-29).

    Unknown top-level keys are ignored, which is what makes the reference's
    anchor trick in demo2.yml (top-level ``mat1``/``mat2``/``mat3`` anchor
    definitions, scenes/demo2.yml:1-15) work unmodified.
    """
    return SceneData.from_dict(yaml.safe_load(text))


def load_scene(path: str) -> SceneData:
    with open(path, "r") as f:
        return loads_scene(f.read())


# The fields of the JAX package's SceneArrays, in the order scene_from_numpy
# takes them; the triangle fields may be absent (a triangle-free scene).
SCENE_FIELDS = (
    "sphere_center",
    "sphere_radius",
    "sphere_invert",
    "plane_point",
    "plane_normal",
    "mat_kind",
    "mat_color",
    "mat_param",
    "mat_exp",
    "background",
)
TRI_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "tri_n")


@dataclass(frozen=True, eq=False)
class SceneTensors:
    """Device-resident scene: the twin of ``flux_tpu.scene.SceneArrays``.

    Materials live in a flat table indexed by shape id (spheres, then
    planes, then triangles). ``sphere_invert`` holds the reference's
    normal-flip flag as ±1 (shapes.rs:183). Triangles are kept in
    Möller–Trumbore form: ``v0``, the two edge vectors and the unit
    geometric normal (counter-clockwise winding). ``unit_d`` says that every
    ray direction in this scene is a unit vector, so the sphere quadratic
    may take ``a == 1`` exactly; it holds when every authored plane normal is
    unit (see :func:`compile_scene`). ``host`` keeps the float32 numpy arrays
    the tensors were made from, so the CUDA kernels' uploads read no device
    memory back.
    """

    sphere_center: torch.Tensor  # (Ns, 3) f32
    sphere_radius: torch.Tensor  # (Ns,)   f32
    sphere_invert: torch.Tensor  # (Ns,)   f32 (+1 / -1)
    plane_point: torch.Tensor  # (Np, 3) f32
    plane_normal: torch.Tensor  # (Np, 3) f32
    mat_kind: torch.Tensor  # (Ns+Np+Nt,) i32
    mat_color: torch.Tensor  # (Ns+Np+Nt, 3) f32
    mat_param: torch.Tensor  # (Ns+Np+Nt,) f32
    mat_exp: torch.Tensor  # (Ns+Np+Nt,) f32
    background: torch.Tensor  # (3,) f32
    tri_v0: torch.Tensor = None  # (Nt, 3) f32
    tri_e1: torch.Tensor = None  # (Nt, 3) f32  v1 - v0
    tri_e2: torch.Tensor = None  # (Nt, 3) f32  v2 - v0
    tri_n: torch.Tensor = None  # (Nt, 3) f32  unit normal
    unit_d: bool = True
    host: dict = field(default=None, repr=False)

    @property
    def num_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def num_planes(self) -> int:
        return self.plane_point.shape[0]

    @property
    def num_triangles(self) -> int:
        return 0 if self.tri_v0 is None else self.tri_v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sphere_center.device


def scene_from_numpy(arrays: dict, unit_d: bool, device) -> SceneTensors:
    """SceneTensors from the JAX package's ``SceneArrays`` fields as numpy
    arrays (``SCENE_FIELDS`` and, for a scene with triangles,
    ``TRI_FIELDS``), so both packages compute on the same float32
    constants."""
    dtypes = {"mat_kind": np.int32}
    host = {
        k: np.ascontiguousarray(np.asarray(arrays[k], dtypes.get(k, np.float32)))
        for k in SCENE_FIELDS
    }
    for k in TRI_FIELDS:
        v = arrays.get(k)
        host[k] = np.ascontiguousarray(np.asarray(() if v is None else v, np.float32))
    ns, npl = host["sphere_center"].reshape(-1, 3).shape[0], host["plane_point"].reshape(-1, 3).shape[0]
    nt = host["tri_v0"].reshape(-1, 3).shape[0]
    n = ns + npl + nt
    shapes = {
        "sphere_center": (ns, 3),
        "sphere_radius": (ns,),
        "sphere_invert": (ns,),
        "plane_point": (npl, 3),
        "plane_normal": (npl, 3),
        "mat_kind": (n,),
        "mat_color": (n, 3),
        "mat_param": (n,),
        "mat_exp": (n,),
        "background": (3,),
        **{k: (nt, 3) for k in TRI_FIELDS},
    }
    host = {k: v.reshape(shapes[k]) for k, v in host.items()}
    tensors = {k: torch.from_numpy(v.copy()).to(device) for k, v in host.items()}
    return SceneTensors(unit_d=bool(unit_d), host=host, **tensors)


def compile_scene(sd: SceneData, device) -> SceneTensors:
    """Compile SceneData to device tensors (``flux_tpu.scene.compile_scene``;
    the ``Scene::from_data`` analog, scene.rs:128-154)."""
    spheres = [s for s in sd.shapes if isinstance(s, SphereData)]
    planes = [p for p in sd.shapes if isinstance(p, PlaneData)]
    tris = [t for t in sd.shapes if isinstance(t, TriangleData)]
    # Material table order: spheres, planes, triangles.
    mats = [s.material for s in spheres] + [p.material for p in planes] + [t.material for t in tris]
    # Möller–Trumbore precompute in float64 on the host, rounded once.
    nt = len(tris)
    v0 = np.asarray([t.v0 for t in tris], np.float64).reshape(nt, 3)
    e1 = np.asarray([t.v1 for t in tris], np.float64).reshape(nt, 3) - v0
    e2 = np.asarray([t.v2 for t in tris], np.float64).reshape(nt, 3) - v0
    tn = np.cross(e1, e2)
    tn_len = np.linalg.norm(tn, axis=1, keepdims=True)
    if nt and (tn_len == 0.0).any():
        bad = int(np.argmax(tn_len[:, 0] == 0.0))
        raise ValueError(f"degenerate triangle (zero-area) at index {bad}")
    tn = tn / np.maximum(tn_len, 1e-300)
    # A scene whose plane normals are all unit keeps every ray direction
    # unit (camera rays are normalized, BRDF lobes come from orthonormal
    # frames, and mirror reflection about a unit normal keeps length).
    unit_d = all(
        abs(float(np.linalg.norm(np.asarray(p.normal, np.float64))) - 1.0) < 1e-6
        for p in planes
    )
    arrays = {
        "sphere_center": [s.center for s in spheres],
        "sphere_radius": [s.radius for s in spheres],
        "sphere_invert": [-1.0 if s.invert else 1.0 for s in spheres],
        "plane_point": [p.point for p in planes],
        "plane_normal": [p.normal for p in planes],
        "tri_v0": v0,
        "tri_e1": e1,
        "tri_e2": e2,
        "tri_n": tn,
        "mat_kind": [m.kind for m in mats],
        "mat_color": [m.color for m in mats],
        "mat_param": [m.param for m in mats],
        "mat_exp": [m.exponent for m in mats],
        "background": sd.background,
    }
    return scene_from_numpy(arrays, unit_d, device)
