"""Multi-device rendering over a ``jax.sharding.Mesh``.

The reference is single-GPU (SURVEY.md §2.3); its only intra-frame
parallelism is per-pixel SIMT. The natural scale-out axis is the same one:
**rays**. The volume and its acceleration structures are replicated
(uint8 volumes are ≤ ~0.8 GB — small next to device memory) and the image
is sharded by rows across the mesh; the march needs *zero* collectives
until the final gather of image tiles, which XLA inserts automatically from
the output sharding. The lock-step while-loop's global ``any(not done)``
becomes one small all-reduce per iteration.

``march_volume_sharded`` splits the volume along Z with halo planes for
the trilinear + gradient taps (the tensor-parallel analogue) for volumes
that outgrow one device's memory.

Device placement of the acceleration *build* (occupancy + distance
transforms) is replicated as well: the per-TF-edit rebuild is cheap and
latency-bound, and replication keeps every device able to march
immediately.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..render.marcher_xla import RenderOutput, march
from ..render.ray_setup import RaySetup

RAY_AXIS = "rays"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def shard_rays(rays: RaySetup, mesh: Mesh) -> RaySetup:
    """Shard every per-pixel field by image rows (axis 0)."""
    row = NamedSharding(mesh, P(RAY_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, row), rays)


def replicate(tree, mesh: Mesh):
    repl = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, repl), tree)


VOL_AXIS = "slabs"
_HALO = 2   # trilinear needs 1 plane, on-the-fly gradient taps 1 more


def march_volume_sharded(
    mesh: Mesh,
    volume_u8,
    gradient_u8,
    dist_maps_u8,
    tf,
    rays: RaySetup,
    block_size_xyz,
    proj_view_model,
    **static_options,
) -> RenderOutput:
    """Volume-sharded (tensor-parallel analogue, SURVEY §2.3): the volume is
    split along z into per-device slabs with ``_HALO`` halo planes for the
    trilinear / on-the-fly-gradient taps; rays are replicated and each device
    marches only the ray segment inside its slab's z-interval. The segment
    results compose exactly with the front-to-back over operator in per-pixel
    ray order (ERT saturates alpha to exactly 1, so later segments multiply
    by zero); the small distance maps stay replicated — TP here scales the
    *volume* memory, the only multi-GB array.

    Segment sample phases differ from the single-device march (each segment
    re-derives n_steps from its own interval), so parity with ``march`` is
    at resample tolerance, like the plane-sweep renderers.
    """
    import jax.numpy as jnp

    n = int(mesh.devices.size)
    D = volume_u8.shape[0]
    Pz = -(-D // n)
    # Slab stack with clamped halo (CLAMP_TO_EDGE semantics at volume ends).
    idx = np.clip(
        np.arange(n)[:, None] * Pz + np.arange(-_HALO, Pz + _HALO)[None, :],
        0, D - 1,
    )
    slabs = jnp.asarray(volume_u8)[idx]              # (n, P+2H, H, W)
    grad_slabs = (jnp.asarray(gradient_u8)[idx]
                  if gradient_u8 is not None else None)
    f = jnp.float32

    def body(slab, grad_slab, maps, tf_, rays_, bs, pvm):
        d_idx = jax.lax.axis_index(VOL_AXIS)
        z0 = d_idx * Pz
        z1 = jnp.minimum(z0 + Pz, D)
        z_lo = z0.astype(f) / f(D)                   # texture-space interval
        z_hi = z1.astype(f) / f(D)

        # Clamp each ray to [z_lo, z_hi] along z (the same interval
        # arithmetic as the clip plane / depth clamps, ray_setup.py).
        o = rays_.entry
        dirs = rays_.ray_dir
        dz = dirs[..., 2]
        par = jnp.abs(dz) < 1e-9
        safe = jnp.where(par, 1.0, dz)
        t0 = (z_lo - o[..., 2]) / safe
        t1 = (z_hi - o[..., 2]) / safe
        tl = jnp.minimum(t0, t1)
        th = jnp.maximum(t0, t1)
        inside = (o[..., 2] >= z_lo) & (o[..., 2] <= z_hi)
        tl = jnp.where(par, jnp.where(inside, 0.0, 1e30), tl)
        th = jnp.where(par, jnp.where(inside, rays_.ray_distance, -1e30), th)
        ta = jnp.maximum(0.0, tl)
        tb = jnp.minimum(rays_.ray_distance, th)
        seg_valid = rays_.valid & (ta < tb)
        import dataclasses as _dc

        seg = _dc.replace(
            rays_,
            entry=o + dirs * ta[..., None],
            exit=o + dirs * tb[..., None],
            ray_distance=jnp.maximum(tb - ta, 0.0),
            valid=seg_valid,
        )
        out = march(
            slab[0], None if grad_slab is None else grad_slab[0],
            maps, tf_, seg, bs, pvm,
            vol_origin_z=z0 - _HALO,
            global_depth=D,
            **static_options,
        )
        return jax.tree.map(lambda x: x[None], out)

    if grad_slabs is None:
        body_fn = lambda s, m, t, r, b, p: body(s, None, m, t, r, b, p)
        args = (slabs, dist_maps_u8, tf, rays, block_size_xyz,
                proj_view_model)
        in_specs = (P(VOL_AXIS), P(), P(), P(), P(), P())
    else:
        body_fn = body
        args = (slabs, grad_slabs, dist_maps_u8, tf, rays, block_size_xyz,
                proj_view_model)
        in_specs = (P(VOL_AXIS), P(VOL_AXIS), P(), P(), P(), P(), P())
    vol_mesh = Mesh(mesh.devices, (VOL_AXIS,))
    parts = jax.shard_map(
        body_fn, mesh=vol_mesh, in_specs=in_specs,
        out_specs=jax.tree.map(lambda _: P(VOL_AXIS),
                               _render_output_spec_tree()),
        check_vma=False,
    )(*args)

    # Compose segments with the over operator in per-pixel ray order
    # (dz > 0 → slab 0 is nearest). GSPMD gathers the slab axis on demand.
    dz = rays.ray_dir[..., 2]
    Hh, Ww = rays.valid.shape
    zero = jnp.zeros((Hh, Ww, 4), f)

    def fold(order):
        c = zero
        for k in order:
            c = c + (1.0 - c[..., 3:4]) * parts.color[k]
        return c

    fwd = fold(range(n))
    bwd = fold(range(n - 1, -1, -1))
    color = jnp.where((dz > 0)[..., None], fwd, bwd)
    depth = parts.depth.max(axis=0)        # reverse-Z: greater = nearer
    return RenderOutput(
        color=color,
        depth=depth,
        num_volume_samples=parts.num_volume_samples.sum(axis=0),
        num_distance_samples=parts.num_distance_samples.sum(axis=0),
        num_empty_samples=parts.num_empty_samples.sum(axis=0),
        iterations=parts.iterations.max(axis=0),
    )


def _render_output_spec_tree():
    return RenderOutput(color=0, depth=0, num_volume_samples=0,
                        num_distance_samples=0, num_empty_samples=0,
                        iterations=0)


def march_sharded(
    mesh: Mesh,
    volume_u8,
    gradient_u8,
    dist_maps_u8,
    tf,
    rays: RaySetup,
    block_size_xyz,
    proj_view_model,
    **static_options,
) -> RenderOutput:
    """Data-parallel march: rays sharded over the mesh, volume replicated.

    The image height must be divisible by the mesh size. Uses jit + sharding
    annotations (GSPMD); XLA partitions the while-loop and inserts the
    ``psum``-style reduction for the global done-test and the final gather.
    """
    n = mesh.devices.size
    H = rays.valid.shape[0]
    if H % n:
        raise ValueError(f"image height {H} not divisible by mesh size {n}")
    rays_s = shard_rays(rays, mesh)
    vol, grad, maps, tf_r, bs, pvm = replicate(
        (volume_u8, gradient_u8, dist_maps_u8, tf, block_size_xyz,
         proj_view_model),
        mesh,
    )
    return march(vol, grad, maps, tf_r, rays_s, bs, pvm, **static_options)
