"""Forward mesh subpass — the JAX equivalent of the reference's optional
scene pass (a vkb ForwardSubpass drawing the Sponza glTF with
``base.vert``/``base.frag``; wired in ``src/volume_render.cpp:329-356``).
Its two products are exactly what the volume pass consumes:

* a reverse-Z **depth attachment** the volume rays clip against
  (``volume_render.frag:122-165`` — our ``render/ray_setup.make_rays``
  ``use_depth`` path, conventions identical: depth 0 = far plane,
  GREATER-or-EQUAL = nearer), and
* the opaque **scene color** the volume front-to-back blend composites
  over (``src/volume_render_subpass.cpp:177-186``:
  ``final = vol + (1 - vol.a) * scene``).

The glTF Sponza asset itself is out of scope (SURVEY §2.2) — any triangle
mesh renders through this pass; :func:`sponza_lite` builds a stand-in hall
(floor, walls, columns) around the 100-unit volume cube.

Rasterisation strategy: NDC depth is affine in screen
coordinates over a planar triangle, so per-pixel coverage + depth need
three edge functions and one screen-affine interpolation. All per-triangle
quantities (screen vertices, NDC depths, flat Lambert shade) are
vectorised over the mesh up front; a ``lax.fori_loop`` then folds each
triangle over the full-image (H, W) targets — a z-buffer as a
masked reduction, compiled once. Scene-sized meshes (tens to hundreds of
triangles) rasterise in ~ms, and this keeps the whole frame (scene pass → ray clip → volume
sweep → composite) inside jit-compiled XLA.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Opaque triangle soup in world coordinates (flat-shaded)."""

    verts: np.ndarray    # (N, 3) f32 world positions
    faces: np.ndarray    # (T, 3) i32 vertex indices, CCW front-facing
    albedo: np.ndarray   # (T, 3) f32 per-face base color in [0, 1]


@functools.partial(jax.jit, static_argnames=("height", "width", "cull"))
def _rasterize_jit(verts, faces, albedo, view_proj, light_dir,
                   *, height: int, width: int, cull: bool = True):
    f = jnp.float32
    T = faces.shape[0]

    # ---- per-triangle setup, vectorised over the mesh ----
    tri = verts[faces]                                    # (T, 3, 3)
    ones = jnp.ones(tri.shape[:-1] + (1,), f)
    clip = jnp.concatenate([tri, ones], -1) @ view_proj.T  # (T, 3, 4)
    w = clip[..., 3]
    # Near-plane guard: drop triangles with any vertex at/behind the eye
    # plane rather than clipping them (scene geometry stays in front of
    # the camera for the demo hall; a clipped-polygon path is not needed
    # for depth-attachment parity).
    w_ok = jnp.all(w > 1e-6, axis=-1)                     # (T,)
    ndc = clip[..., :3] / jnp.where(w[..., None] == 0, 1.0, w[..., None])
    # Same pixel-center mapping as make_rays: ndc = (px + 0.5)/W*2 - 1.
    sx = (ndc[..., 0] + 1.0) * (0.5 * width) - 0.5        # (T, 3)
    sy = (ndc[..., 1] + 1.0) * (0.5 * height) - 0.5
    z = ndc[..., 2]                                       # reverse-Z in [0,1]

    # Flat Lambert shade per face (base.frag's textured Blinn stand-in —
    # untextured albedo, headlight-independent key light + ambient).
    n = jnp.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    lam = jnp.maximum(0.0, -(n @ light_dir))
    shade = albedo * (0.3 + 0.7 * lam)[:, None]           # (T, 3)

    # Signed doubled area. World-CCW (outward-normal-toward-camera) front
    # faces land with NEGATIVE screen area: image rows grow downward, so
    # the projection flips orientation (back-face culling,
    # src/volume_render_subpass.cpp:200-203).
    area = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
            - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0]))
    if cull:
        face_ok = w_ok & (area < -1e-12)
    else:
        face_ok = w_ok & (jnp.abs(area) > 1e-12)
    inv_area = jnp.where(area == 0, 1.0, 1.0 / area)

    py, px = jnp.mgrid[0:height, 0:width]
    px = px.astype(f)
    py = py.astype(f)

    def edge(ax, ay, bx, by):
        """Edge function of (a→b) at every pixel center; (H, W)."""
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    def body(i, targets):
        depth, color = targets
        e0 = edge(sx[i, 1], sy[i, 1], sx[i, 2], sy[i, 2])   # opposite v0
        e1 = edge(sx[i, 2], sy[i, 2], sx[i, 0], sy[i, 0])
        e2 = edge(sx[i, 0], sy[i, 0], sx[i, 1], sy[i, 1])
        s = jnp.sign(area[i])
        # Edge-function rounding at large screen coordinates leaves a
        # seam of pixels outside BOTH triangles of a shared edge; a
        # barycentric tolerance (scaled by the triangle area, with an
        # absolute floor for small triangles) closes it — sub-pixel
        # overdraw between coplanar neighbours is harmless for an opaque
        # z-buffered pass.
        eps = 1e-6 * jnp.abs(area[i]) + 1e-2
        inside = ((e0 * s >= -eps) & (e1 * s >= -eps) & (e2 * s >= -eps)
                  & face_ok[i])
        zpix = (e0 * z[i, 0] + e1 * z[i, 1] + e2 * z[i, 2]) * inv_area[i]
        # Reverse-Z: nearer = larger; 0 = far clear (make_rays depth_init).
        better = inside & (zpix > depth) & (zpix <= 1.0) & (zpix > 0.0)
        depth = jnp.where(better, zpix, depth)
        color = jnp.where(better[..., None], shade[i], color)
        return depth, color

    depth0 = jnp.zeros((height, width), f)
    color0 = jnp.zeros((height, width, 3), f)
    depth, color = jax.lax.fori_loop(0, T, body, (depth0, color0))
    return color, depth


def rasterize(mesh: Mesh, camera, height: int, width: int,
              light_dir=(-0.4, -0.8, -0.45), cull: bool = True):
    """Render ``mesh`` from ``camera``: returns ``(color (H, W, 3) f32,
    depth (H, W) f32)`` with the volume pass's depth conventions (reverse-Z,
    0 = far/uncovered) — feed ``depth`` to ``Engine.render(depth_image=…)``
    with ``RenderOptions.depth_attachment`` and composite the volume output
    over ``color`` (or use ``Engine.render_with_scene``)."""
    vp = jnp.asarray(
        (np.asarray(camera.proj, np.float64)
         @ np.asarray(camera.view, np.float64)).astype(np.float32))
    ld = np.asarray(light_dir, np.float64)
    ld = jnp.asarray(ld / np.linalg.norm(ld), jnp.float32)
    return _rasterize_jit(
        jnp.asarray(mesh.verts, jnp.float32),
        jnp.asarray(mesh.faces, jnp.int32),
        jnp.asarray(mesh.albedo, jnp.float32),
        vp, ld, height=height, width=width, cull=cull)


# ---------------------------------------------------------------------------
# Demo scene: a stand-in for the Sponza hall, scaled to the reference's
# world (the volume is a 100-unit cube centred at the origin,
# src/volume_render.cpp:233).
# ---------------------------------------------------------------------------


def _box(cx, cy, cz, hx, hy, hz):
    """12 CCW (outward-facing) triangles of an axis-aligned box."""
    v = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                  for sz in (-1, 1)], np.float32)
    v = v * np.array([hx, hy, hz], np.float32) + np.array(
        [cx, cy, cz], np.float32)
    # Faces as quads (a, b, c, d) with outward CCW winding (seen from
    # outside); vertex index = 4*sx + 2*sy + sz over (0, 1) signs.
    quads = [
        (0, 1, 3, 2),   # -x
        (6, 7, 5, 4),   # +x
        (0, 4, 5, 1),   # -y
        (2, 3, 7, 6),   # +y
        (0, 2, 6, 4),   # -z
        (1, 5, 7, 3),   # +z
    ]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return v, np.asarray(faces, np.int32)


def _quad(a, b, c, d, nsub: int = 8):
    """Bilinearly subdivided quad (nsub×nsub tiles, 2 triangles each).
    Subdivision matters because the rasteriser drops whole triangles with
    a vertex behind the eye plane instead of clipping them: a camera
    INSIDE the hall must lose only the tiles actually behind it."""
    a, b, c, d = (np.asarray(p, np.float64) for p in (a, b, c, d))
    us = np.linspace(0.0, 1.0, nsub + 1)
    grid = np.asarray([
        [(a * (1 - u) + b * u) * (1 - t) + (d * (1 - u) + c * u) * t
         for u in us] for t in us], np.float32)          # (n+1, n+1, 3)
    v = grid.reshape(-1, 3)
    idx = np.arange((nsub + 1) * (nsub + 1)).reshape(nsub + 1, nsub + 1)
    faces = []
    for i in range(nsub):
        for j in range(nsub):
            p00, p01 = idx[i, j], idx[i, j + 1]
            p10, p11 = idx[i + 1, j], idx[i + 1, j + 1]
            faces += [(p00, p01, p11), (p00, p11, p10)]
    return v, np.asarray(faces, np.int32)


def sponza_lite(*, floor_y=-50.0, extent=320.0) -> Mesh:
    """A small hall around the volume cube: floor, back/side walls and four
    columns — enough opaque geometry to exercise every depth interaction
    (scene in front of, behind, and intersecting the volume across an
    orbit), standing in for the out-of-scope glTF Sponza."""
    parts = []            # (verts, faces, albedo_rgb)
    e = extent

    def add(vf, rgb):
        parts.append((vf[0], vf[1], np.asarray(rgb, np.float32)))

    # Floor at the volume cube's bottom face (+y up).
    add(_quad([-e, floor_y, -e], [-e, floor_y, e],
              [e, floor_y, e], [e, floor_y, -e]), (0.55, 0.50, 0.42))
    # Back wall (behind the volume for the benchmark orbit's start).
    add(_quad([-e, floor_y, -e], [e, floor_y, -e],
              [e, floor_y + 2 * e, -e], [-e, floor_y + 2 * e, -e]),
        (0.62, 0.58, 0.52))
    # Side walls.
    add(_quad([-e, floor_y, e], [-e, floor_y, -e],
              [-e, floor_y + 2 * e, -e], [-e, floor_y + 2 * e, e]),
        (0.50, 0.44, 0.38))
    add(_quad([e, floor_y, -e], [e, floor_y, e],
              [e, floor_y + 2 * e, e], [e, floor_y + 2 * e, -e]),
        (0.50, 0.44, 0.38))
    # Four columns flanking the volume.
    for cx, cz, rgb in ((-95.0, -95.0, (0.75, 0.68, 0.55)),
                        (95.0, -95.0, (0.75, 0.68, 0.55)),
                        (-95.0, 95.0, (0.70, 0.62, 0.50)),
                        (95.0, 95.0, (0.70, 0.62, 0.50))):
        add(_box(cx, floor_y + 85.0, cz, 14.0, 85.0, 14.0), rgb)

    verts, faces, albedo = [], [], []
    off = 0
    for v, fcs, rgb in parts:
        verts.append(v)
        faces.append(fcs + off)
        albedo.append(np.tile(rgb, (len(fcs), 1)))
        off += len(v)
    return Mesh(verts=np.concatenate(verts),
                faces=np.concatenate(faces),
                albedo=np.concatenate(albedo))
