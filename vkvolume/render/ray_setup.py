"""Per-pixel ray setup — the arithmetic equivalent of the reference's two
rasterized draws.

The reference renders (a) a back-face-culled unit cube whose vertices carry
``gl_ClipDistance[0] = dot(plane, world_pos)`` (shaders/volume_render_clipped.vert:50-65)
and (b) a box-plane-intersection "cap" polygon (Salama & Kolb 2005,
shaders/volume_render_plane_intersection.vert:63-130) that fills the hole the
clip plane cuts, e.g. when the camera is inside the volume. Per fragment, the
shader then derives the ray exit from an AABB intersection
(shaders/volume_render.frag:71-83) and optionally clamps entry/exit against a
depth buffer (:122-165).

All of that collapses into per-pixel interval arithmetic:

    t_entry = max(t_near(AABB), t_plane)        # clip plane: kept half-space
    t_exit  = t_far(AABB)                        # then optional depth clamp
    valid   = t_entry < t_exit  and  t_exit > 0

which yields the *same* ``ray_entry`` / ``ray_exit`` / coverage as the two
draws: the cap polygon is exactly the locus where ``t_plane > t_near``, and
back-face culling plus clip distance is exactly the ``max``.

Host-side uniform assembly mirrors ``VolumeRenderSubpass::draw``
(src/volume_render_subpass.cpp:221-249).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import math3d


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameUniforms:
    """Pytree twin of CameraUniform + RayCastUniform
    (src/volume_render_subpass.h:32-53)."""

    view: jax.Array            # (4,4)
    proj: jax.Array            # (4,4)
    view_proj_inv: jax.Array   # (4,4)
    model: jax.Array           # (4,4) node_transform @ image_transform
    model_inv: jax.Array       # (4,4)
    global_to_tex: jax.Array   # (4,4) translate(0.5) @ model_inv
    plane: jax.Array           # (4,) world-space clip plane
    plane_tex: jax.Array       # (4,) texture-space clip plane
    cam_pos_tex: jax.Array     # (3,)
    block_size: jax.Array      # (3,) float, effective per-axis block size
    front_index: jax.Array     # () int32 — octant of plane_tex (kept for parity)


def make_uniforms(
    camera,
    node_transform: np.ndarray,
    image_transform: np.ndarray,
    clip_distance: float,
    block_size_xyz,
) -> FrameUniforms:
    """Host-side uniform assembly (src/volume_render_subpass.cpp:221-249)."""
    view = camera.view.astype(np.float64)
    proj = camera.proj.astype(np.float64)
    model = node_transform.astype(np.float64) @ image_transform.astype(np.float64)
    model_inv = np.linalg.inv(model)
    view_proj_inv = np.linalg.inv(proj @ view)
    model_to_tex = math3d.translate((0.5, 0.5, 0.5)).astype(np.float64)
    global_to_tex = model_to_tex @ model_inv

    view_inv = np.linalg.inv(view)
    cam_pos_global = view_inv[:3, 3]
    cam_pos_model = (model_inv @ np.append(cam_pos_global, 1.0))[:3]
    cam_pos_tex = cam_pos_model + 0.5
    cam_dir_global = -view_inv[:3, 2]
    plane = np.append(
        cam_dir_global, -clip_distance - float(np.dot(cam_pos_global, cam_dir_global))
    )
    plane_tex = np.linalg.inv(global_to_tex).T @ plane
    front_index = (
        (1 if plane_tex[0] < 0 else 0)
        + (2 if plane_tex[1] < 0 else 0)
        + (4 if plane_tex[2] < 0 else 0)
    )
    # HOST numpy leaves, not device arrays: the host-analytic view
    # analysis (render/plan.py) reads these every fresh pose, and a
    # device-array leaf turns each read into a synced device→host round
    # trip that also drains the queued frame pipeline. As jit arguments
    # numpy leaves are device_put asynchronously at dispatch.
    f32 = lambda a: np.asarray(a, np.float32)
    return FrameUniforms(
        view=f32(view),
        proj=f32(proj),
        view_proj_inv=f32(view_proj_inv),
        model=f32(model),
        model_inv=f32(model_inv),
        global_to_tex=f32(global_to_tex),
        plane=f32(plane),
        plane_tex=f32(plane_tex),
        cam_pos_tex=f32(cam_pos_tex),
        block_size=f32(block_size_xyz),
        front_index=np.int32(front_index),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RaySetup:
    entry: jax.Array          # (H, W, 3) texture coords
    exit: jax.Array           # (H, W, 3)
    ray_dir: jax.Array        # (H, W, 3) normalized, texture space
    ray_distance: jax.Array   # (H, W)
    valid: jax.Array          # (H, W) bool — pixel covered by the draws
    depth_init: jax.Array     # (H, W) initial gl_FragDepth (reverse-Z)
    entry_clip_zw: jax.Array  # (H, W, 2) clip-space z, w at entry (depth output)


def ray_caster_get_back(front: jax.Array, direction: jax.Array) -> jax.Array:
    """Exact port of ``ray_caster_get_back`` (volume_render.frag:71-83)."""
    dir_inv = 1.0 / direction
    t_min = -front * dir_inv
    t_max = (1.0 - front) * dir_inv
    t2 = jnp.maximum(t_min, t_max)
    t_far = jnp.min(t2, axis=-1, keepdims=True)
    return t_far * direction + front


@functools.partial(jax.jit, static_argnames=("height", "width", "use_depth"))
def make_rays(
    u: FrameUniforms,
    height: int,
    width: int,
    depth_image: jax.Array | None = None,
    use_depth: bool = False,
) -> RaySetup:
    """Build the per-pixel ray interval for an H×W image.

    ``depth_image`` (reverse-Z, same conventions as the D32 attachment) clips
    rays against scene geometry when ``use_depth`` (DEPTH_ATTACHMENT variant,
    volume_render.frag:122-165).
    """
    f = jnp.float32
    py, px = jnp.mgrid[0:height, 0:width]
    ndc_x = (px.astype(f) + 0.5) / width * 2.0 - 1.0
    ndc_y = (py.astype(f) + 0.5) / height * 2.0 - 1.0

    # Unproject the pixel at the FAR plane (reverse-Z: z_ndc = 0) to get the
    # ray direction; a near-camera depth would cancel catastrophically in f32.
    clip = jnp.stack(
        [ndc_x, ndc_y, jnp.zeros_like(ndc_x), jnp.ones_like(ndc_x)], -1
    )
    world = clip @ u.view_proj_inv.T
    world = world[..., :3] / world[..., 3:4]
    pt_tex = (
        jnp.concatenate([world, jnp.ones_like(world[..., :1])], -1)
        @ u.global_to_tex.T
    )[..., :3]

    o = u.cam_pos_tex
    d = pt_tex - o
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    # AABB [0,1]^3 interval from the camera.
    dir_inv = 1.0 / d
    t0 = (0.0 - o) * dir_inv
    t1 = (1.0 - o) * dir_inv
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)

    # Clip plane: kept half-space is dot(plane_tex, p) >= 0; the camera always
    # sits on the clipped side at signed distance -clip_distance.
    s_o = jnp.dot(u.plane_tex[:3], o) + u.plane_tex[3]
    s_d = d @ u.plane_tex[:3]
    t_plane = jnp.where(s_d != 0.0, -s_o / s_d, jnp.float32(jnp.inf))
    # Rays in the FOV always cross into the kept half-space (s_d > 0).
    t_entry = jnp.where(s_d > 0.0, jnp.maximum(t_near, t_plane), t_near)

    valid = (t_entry < t_far) & (t_far > 0.0)

    entry = o + t_entry[..., None] * d
    # Exit recomputed from the entry exactly like the fragment shader.
    exit_ = ray_caster_get_back(entry, d)

    # Clip-space position of the entry point (depth write, manual z-test).
    world_entry = (
        jnp.concatenate([entry - 0.5, jnp.ones_like(entry[..., :1])], -1)
        @ (u.model).T
    )
    clip_entry = world_entry @ (u.view.T @ u.proj.T)
    entry_clip_zw = clip_entry[..., 2:4]
    depth_front = entry_clip_zw[..., 0] / entry_clip_zw[..., 1]

    if use_depth and depth_image is not None:
        frag_depth = depth_image
        # Manual reverse-Z test of the front face (volume_render.frag:127-135).
        covered = frag_depth <= depth_front
        valid = valid & covered
        depth_init = frag_depth
        # Ray ∩ depth buffer in texture coords (volume_render.frag:152-164).
        safe_front = jnp.where(depth_front == 0.0, 1.0, depth_front)
        scale = frag_depth / safe_front
        # position = clip coords of the entry fragment; the reference scales
        # position.xyz by frag_depth/frag_depth_front (volume_render.frag:153).
        position = clip_entry
        clip_at_depth = jnp.concatenate(
            [
                position[..., :3] * scale[..., None],
                position[..., 3:4],
            ],
            -1,
        )
        pos_at_depth = clip_at_depth @ u.view_proj_inv.T
        pos_at_depth = pos_at_depth[..., :3] / pos_at_depth[..., 3:4]
        hit_tex = (
            jnp.concatenate([pos_at_depth, jnp.ones_like(scale[..., None])], -1)
            @ u.model_inv.T
        )[..., :3] + 0.5
        dist_depth = jnp.linalg.norm(hit_tex - entry, axis=-1)
        dist_aabb = jnp.linalg.norm(exit_ - entry, axis=-1)
        nearer = dist_depth < dist_aabb
        exit_ = jnp.where(nearer[..., None], hit_tex, exit_)
    else:
        # No depth attachment: gl_FragDepth initialised to 0 (reverse-Z far),
        # volume_render.frag:139-141.
        depth_init = jnp.zeros((height, width), f)

    ray_distance = jnp.linalg.norm(exit_ - entry, axis=-1)

    return RaySetup(
        entry=entry,
        exit=exit_,
        ray_dir=d,
        ray_distance=ray_distance,
        valid=valid,
        depth_init=depth_init,
        entry_clip_zw=entry_clip_zw,
    )
