"""Triangle-mesh utilities — geometry beyond the reference's schema.

The reference renders spheres and planes only (shapes.rs:68-74). The scene
schema adds a ``Triangle`` shape and a ``Mesh`` YAML variant (scene.py); this
module, the port's own copy of ``flux_tpu/meshgen.py`` (numpy only, the same
output for the same arguments), provides the mesh sources:

* :func:`icosphere` — geodesic sphere by subdividing an icosahedron. The
  workhorse of the triangle test suite: at high subdivision it must render
  like the analytic sphere it approximates, which pins the whole triangle
  path (intersection, normals, shading) against the sphere path that the
  golden/parity tests already pin against the reference.
* :func:`box` — axis-aligned box as 12 triangles.
* :func:`load_obj` — minimal Wavefront OBJ loader (v/f records, polygonal
  faces fan-triangulated), enough to pull standard test meshes into the
  reference YAML schema.
* :func:`mesh_scene` — a demo2-style showcase scene (env light + ground
  plane) around an arbitrary mesh.

All functions return/consume plain ``SceneData``/``TriangleData`` records,
so generated scenes serialize to the same YAML the CLI and network nodes
already ship.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .scene import (
    CameraData,
    CameraSettings,
    MaterialData,
    MaterialKind,
    OutputSettings,
    PlaneData,
    SceneData,
    SphereData,
    TriangleData,
)

__all__ = ["icosphere", "box", "load_obj", "mesh_triangles", "mesh_scene", "mesh_scene_yaml"]

Vec = Tuple[float, float, float]


def _icosahedron() -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron (12 vertices, 20 CCW-outward faces)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
            (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
            (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )
    return v, f


def icosphere(subdiv: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Geodesic unit sphere: (vertices, faces) after ``subdiv`` rounds of
    4-way face subdivision with midpoint reprojection. 20·4^subdiv faces
    (0→20, 1→80, 2→320, 3→1280), outward CCW winding."""
    v, f = _icosahedron()
    verts: List[np.ndarray] = list(v)
    cache: Dict[Tuple[int, int], int] = {}

    def midpoint(i: int, j: int) -> int:
        key = (i, j) if i < j else (j, i)
        k = cache.get(key)
        if k is None:
            m = verts[i] + verts[j]
            m /= np.linalg.norm(m)
            k = len(verts)
            verts.append(m)
            cache[key] = k
        return k

    faces = f.tolist()
    for _ in range(subdiv):
        nxt = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def box(lo: Vec = (-1, -1, -1), hi: Vec = (1, 1, 1)) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box as (8 vertices, 12 CCW-outward triangles)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array(
        [
            (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
            (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
        ],
        np.float64,
    )
    f = np.array(
        [
            (0, 2, 1), (0, 3, 2),  # z = z0 (normal -z)
            (4, 5, 6), (4, 6, 7),  # z = z1 (normal +z)
            (0, 1, 5), (0, 5, 4),  # y = y0 (normal -y)
            (3, 6, 2), (3, 7, 6),  # y = y1 (normal +y)
            (0, 7, 3), (0, 4, 7),  # x = x0 (normal -x)
            (1, 2, 6), (1, 6, 5),  # x = x1 (normal +x)
        ],
        np.int64,
    )
    return v, f


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ reader: ``v`` and ``f`` records only; faces
    with >3 vertices are fan-triangulated; 1-based and negative indices
    per the OBJ spec; texture/normal slots (``f a/b/c``) ignored."""
    verts: List[Tuple[float, float, float]] = []
    faces: List[Tuple[int, int, int]] = []
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                verts.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    if not verts or not faces:
        raise ValueError(f"no mesh data in {path}")
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def _transform(v: np.ndarray, scale: float, offset: Vec) -> np.ndarray:
    return v * float(scale) + np.asarray(offset, np.float64)


def mesh_triangles(
    verts: np.ndarray,
    faces: np.ndarray,
    material: MaterialData,
    *,
    scale: float = 1.0,
    offset: Vec = (0.0, 0.0, 0.0),
) -> List[TriangleData]:
    """Instantiate (vertices, faces) as flat TriangleData records."""
    v = _transform(verts, scale, offset)

    def py(p):  # plain floats: np.float64 is not YAML-serializable
        return (float(p[0]), float(p[1]), float(p[2]))

    out = []
    for i, j, k in faces:
        out.append(
            TriangleData(v0=py(v[i]), v1=py(v[j]), v2=py(v[k]), material=material)
        )
    return out


def mesh_scene(
    verts: np.ndarray,
    faces: np.ndarray,
    *,
    name: str = "mesh",
    width: int = 800,
    height: int = 600,
    scale: float = 1.0,
    offset: Vec = (0.0, 1.0, 0.0),
    material: MaterialData | None = None,
) -> SceneData:
    """A demo2-style stage for a mesh: inverted emissive environment sphere
    (scenes/demo2.yml:30-38), a small area light, and a matte ground plane,
    with the mesh resting at ``offset``."""
    mat = material or MaterialData(
        kind=MaterialKind.MATTE, color=(0.85, 0.35, 0.25), param=1.0
    )
    shapes: List[object] = [
        SphereData(
            center=(0.0, 0.0, 0.0),
            radius=1000.0,
            material=MaterialData(kind=MaterialKind.EMISSIVE, color=(0.8, 0.9, 1.0), param=1.0),
            invert=True,
        ),
        SphereData(
            center=(6.0, 9.0, -4.0),
            radius=1.5,
            material=MaterialData(kind=MaterialKind.EMISSIVE, color=(1.0, 0.95, 0.8), param=6.0),
        ),
        PlaneData(
            point=(0.0, 0.0, 0.0),
            normal=(0.0, 1.0, 0.0),
            material=MaterialData(
                kind=MaterialKind.MATTE, color=(0.6, 0.6, 0.62), param=1.0
            ),
        ),
    ]
    shapes += mesh_triangles(verts, faces, mat, scale=scale, offset=offset)
    return SceneData(
        scene_name=name,
        output_settings=OutputSettings(image_width=width, image_height=height, pixel_size=1.0),
        background=(0.0, 0.0, 0.0),
        shapes=tuple(shapes),
        camera_settings=CameraSettings(eye=(0.0, 2.2, -7.0), look_at=(0.0, 1.0, 0.0), up=(0.0, 1.0, 0.0)),
        camera_data=CameraData(
            zoom_factor=1.0, view_plane_distance=500.0, focal_distance=7.0, lens_radius=0.0
        ),
    )


def mesh_scene_yaml(
    verts: np.ndarray, faces: np.ndarray, *, scale: float = 1.0,
    offset: Vec = (0.0, 1.0, 0.0), **kw,
) -> str:
    """The :func:`mesh_scene` stage as YAML with the COMPACT ``Mesh``
    variant (shared vertex list + faces) instead of the flat ``Triangle``
    records ``SceneData.to_dict`` writes — an icosphere(3) scene is ~40 KB
    this way vs ~300 KB flat. Loads back through the normal scene loader
    (``Mesh`` expands to triangles at parse time)."""
    import yaml

    sd = mesh_scene(verts, faces, scale=scale, offset=offset, **kw)
    doc = SceneData(
        scene_name=sd.scene_name,
        output_settings=sd.output_settings,
        background=sd.background,
        shapes=tuple(s for s in sd.shapes if not isinstance(s, TriangleData)),
        camera_settings=sd.camera_settings,
        camera_data=sd.camera_data,
    ).to_dict()
    v = _transform(verts, scale, offset)
    doc["shapes"].append(
        {
            "Mesh": {
                "vertices": [[float(c) for c in p] for p in v],
                "faces": [[int(i) for i in f] for f in faces],
                "material": (
                    sd.shapes[-1].material.to_dict()
                    if isinstance(sd.shapes[-1], TriangleData)
                    else MaterialData(kind=MaterialKind.MATTE, color=(0.85, 0.35, 0.25)).to_dict()
                ),
            }
        }
    )
    return yaml.safe_dump(doc, sort_keys=False)


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m flux_tpu_torch.meshgen",
        description="Generate a triangle-mesh showcase scene (YAML, Mesh variant).",
    )
    ap.add_argument("-k", "--kind", choices=("icosphere", "box", "obj"), default="icosphere")
    ap.add_argument("-s", "--subdiv", type=int, default=2, help="icosphere subdivisions")
    ap.add_argument("--obj", help="OBJ file path (for --kind obj)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("-o", "--output", default="-", help="output path ('-' = stdout)")
    args = ap.parse_args(argv)
    if args.kind == "icosphere":
        v, f = icosphere(args.subdiv)
    elif args.kind == "box":
        v, f = box()
    else:
        if not args.obj:
            ap.error("--kind obj requires --obj PATH")
        v, f = load_obj(args.obj)
    text = mesh_scene_yaml(v, f, scale=args.scale, width=args.width, height=args.height)
    if args.output == "-":
        print(text)
    else:
        with open(args.output, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
