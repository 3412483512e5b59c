"""Renderer tests: ray setup geometry, marcher vs the scalar frag-shader
oracle (sample-count parity), ESS-mode image invariance, ERT, diagnostics."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vkvolume.accel import (
    anisotropic_distance,
    gradient_map,
    isotropic_distance,
    occupancy_map,
)
from vkvolume.camera import orbit_camera, perspective_camera
from vkvolume.options import SkippingType
from vkvolume.options import Test as RT
from vkvolume.render import make_rays, make_uniforms, march
from vkvolume.tf import tf_params
from vkvolume.utils import math3d

from scalar_reference import march_ray
from util import random_blob_volume, sphere_shell_volume


def _setup(vol, *, block_size=4, clip=50.0, cam_kw=None, size=24,
           tf_kw=None, use_gradient=False):
    n = vol.shape[0]
    d, h, w = vol.shape
    node = math3d.scale((100.0 / max(d, h, w),) * 3)
    img = math3d.scale((float(w), float(h), float(d)))
    cam = orbit_camera(aspect=1.0, **(cam_kw or dict(radius=220.0,
                                                     azimuth_deg=30,
                                                     elevation_deg=20)))
    tf_kw = tf_kw or {}
    tf = tf_params(intensity_min=tf_kw.get("imin", 0.1),
                   intensity_max=tf_kw.get("imax", 1.0),
                   gradient_min=tf_kw.get("gmin", 0.0),
                   gradient_max=tf_kw.get("gmax", 0.2 if use_gradient else 0.0),
                   sampling_factor=tf_kw.get("sf", 1.0),
                   voxel_alpha_factor=tf_kw.get("vaf", 1.0))
    mz, my, mx = (-(-d // block_size), -(-h // block_size), -(-w // block_size))
    bs = np.asarray([-(-w // mx), -(-h // my), -(-d // mz)], np.float32)
    u = make_uniforms(cam, node, img, clip, bs)
    rays = make_rays(u, size, size)
    grad = gradient_map(jnp.asarray(vol), 1.0, use_gradient=True)
    occ = occupancy_map(jnp.asarray(vol), grad if use_gradient else None, tf,
                        (mz, my, mx))
    pvm = jnp.asarray((cam.proj.astype(np.float64) @ cam.view.astype(np.float64)
                       @ (node.astype(np.float64) @ img.astype(np.float64))
                       ).astype(np.float32))
    return dict(cam=cam, tf=tf, uniforms=u, rays=rays, grad=grad, occ=occ,
                pvm=pvm, bs=bs, map_shape=(mz, my, mx))


# ------------------------------------------------------------- ray setup


def test_axis_aligned_entry_exit():
    vol = sphere_shell_volume(32)
    s = _setup(vol, cam_kw=dict(radius=220.0, azimuth_deg=0, elevation_deg=0))
    rays = s["rays"]
    c = 12  # center pixel of 24x24
    entry = np.asarray(rays.entry)[c, c]
    ext = np.asarray(rays.exit)[c, c]
    assert abs(entry[2] - 1.0) < 1e-3 and abs(ext[2] - 0.0) < 1e-2
    assert abs(np.asarray(rays.ray_distance)[c, c] - 1.0) < 1e-2
    assert np.asarray(rays.valid)[c, c]


def test_clip_plane_moves_entry():
    vol = sphere_shell_volume(32)
    # camera 220 from center, cube spans [-50, 50]; clip at 180 cuts into the
    # cube: entry should sit on the plane, 180 world units from the camera.
    s = _setup(vol, clip=180.0,
               cam_kw=dict(radius=220.0, azimuth_deg=0, elevation_deg=0))
    rays = s["rays"]
    c = 12
    entry = np.asarray(rays.entry)[c, c]
    # 180 from camera = z_world 40 = z_tex 0.9
    assert abs(entry[2] - 0.9) < 1e-3
    assert np.asarray(rays.valid)[c, c]


def test_camera_inside_volume():
    vol = sphere_shell_volume(32)
    n = 32
    node = math3d.scale((100.0 / n,) * 3)
    img = math3d.scale((float(n),) * 3)
    # camera at the cube center looking -z; clip 10 world units ahead →
    # entry on the clip plane (the reference's box-plane-intersection cap).
    cam = perspective_camera(eye=(0.0, 0.0, 0.0), center=(0.0, 0.0, -1.0),
                             aspect=1.0)
    u = make_uniforms(cam, node, img, 10.0, (4.0, 4.0, 4.0))
    rays = make_rays(u, 24, 24)
    c = 12
    assert np.asarray(rays.valid)[c, c]
    entry = np.asarray(rays.entry)[c, c]
    # camera at center (0.5); looking -z: entry z = 0.5 - 10/100 = 0.4
    assert abs(entry[2] - 0.4) < 1e-3


def test_clip_beyond_cube_invalidates():
    vol = sphere_shell_volume(32)
    s = _setup(vol, clip=400.0,
               cam_kw=dict(radius=220.0, azimuth_deg=0, elevation_deg=0))
    assert not np.asarray(s["rays"].valid).any()


def test_exit_formula_matches_frag():
    from vkvolume.render.ray_setup import ray_caster_get_back

    front = jnp.asarray([0.2, 0.3, 1.0])
    d = jnp.asarray([0.1, 0.2, -0.97])
    d = d / jnp.linalg.norm(d)
    back = np.asarray(ray_caster_get_back(front, d))
    assert (back >= -1e-5).all() and (back <= 1 + 1e-5).all()
    assert abs(min(back.min(), 1 - back.max())) < 1e-5  # on a face


def test_depth_attachment_clips_and_discards():
    vol = sphere_shell_volume(32)
    n = 32
    node = math3d.scale((100.0 / n,) * 3)
    img = math3d.scale((float(n),) * 3)
    cam = orbit_camera(radius=220.0, azimuth_deg=0, elevation_deg=0, aspect=1.0)
    u = make_uniforms(cam, node, img, 50.0, (4.0, 4.0, 4.0))
    size = 8
    # Scene depth: reverse-Z. A depth of 1.0 (at the near plane) occludes
    # everything → all rays discarded.
    near_depth = jnp.ones((size, size), jnp.float32)
    rays = make_rays(u, size, size, depth_image=near_depth, use_depth=True)
    assert not np.asarray(rays.valid).any()
    # A depth of 0.0 (far) occludes nothing and leaves the exit unchanged.
    far_depth = jnp.zeros((size, size), jnp.float32)
    rays2 = make_rays(u, size, size, depth_image=far_depth, use_depth=True)
    rays_plain = make_rays(u, size, size)
    np.testing.assert_allclose(np.asarray(rays2.exit),
                               np.asarray(rays_plain.exit), atol=1e-4)
    assert np.asarray(rays2.valid).any()


# ------------------------------------------------------------- marcher


def _march(vol, s, skipping, *, ert=True, test=RT.NONE, precomp=True,
           count=True, dist_maps=None):
    if dist_maps is None:
        if skipping == SkippingType.DISTANCE:
            dist_maps = isotropic_distance(s["occ"])[None]
        elif skipping == SkippingType.ANISOTROPIC_DISTANCE:
            dist_maps = anisotropic_distance(s["occ"])
        elif skipping == SkippingType.BLOCK:
            dist_maps = s["occ"][None]
    return march(
        jnp.asarray(vol), s["grad"], dist_maps, s["tf"], s["rays"],
        jnp.asarray(s["bs"]), s["pvm"],
        skipping_type=skipping, early_ray_termination=ert,
        precomputed_gradient=precomp, test=test, count_samples=count,
    )


SKIP_NAMES = {SkippingType.NONE: "none", SkippingType.BLOCK: "block",
              SkippingType.DISTANCE: "distance",
              SkippingType.ANISOTROPIC_DISTANCE: "aniso"}


@pytest.mark.parametrize("skipping", list(SkippingType))
@pytest.mark.parametrize("ert", [True, False])
def test_marcher_matches_scalar_oracle(rng, skipping, ert):
    vol = random_blob_volume(rng, (24, 22, 26), n_blobs=4)
    s = _setup(vol, size=12, tf_kw=dict(imin=0.15))
    out = _march(vol, s, skipping, ert=ert)

    if skipping == SkippingType.DISTANCE:
        dmaps = np.asarray(isotropic_distance(s["occ"]))[None]
    elif skipping == SkippingType.ANISOTROPIC_DISTANCE:
        dmaps = np.asarray(anisotropic_distance(s["occ"]))
    else:
        dmaps = np.asarray(s["occ"])[None]

    tf_dict = dict(imin=0.15, irange_inv=1.0 / 0.85, gmin=0.0, grange_inv=1.0,
                   use_gradient=False, sampling_factor=1.0,
                   voxel_alpha_factor=1.0, grad_mod=1.0)
    rays = s["rays"]
    grad_np = np.asarray(s["grad"])
    n_checked = 0
    exact_matches = []
    for py in range(0, 12, 2):
        for px in range(0, 12, 2):
            if not bool(np.asarray(rays.valid)[py, px]):
                continue
            color, counters, ifh = march_ray(
                volume=vol, gradient_map=grad_np, dist_maps=dmaps,
                entry=np.asarray(rays.entry)[py, px],
                ray_dir=np.asarray(rays.ray_dir)[py, px],
                ray_distance=float(np.asarray(rays.ray_distance)[py, px]),
                block_size=s["bs"], skipping=SKIP_NAMES[skipping], ert=ert,
                tf=tf_dict, precomputed_gradient=True,
            )
            got_color = np.asarray(out.color)[py, px]
            np.testing.assert_allclose(got_color, color, atol=2e-4,
                                       err_msg=f"pixel {py},{px}")
            # XLA fuses multiply-adds into FMAs, so a ray can cross a map-cell
            # boundary one float ULP differently than strict-f32 numpy; allow
            # a ±2 event slack per pixel and require near-universal exactness.
            dv = abs(int(out.num_volume_samples[py, px]) - counters["n_vol"])
            dd = abs(int(out.num_distance_samples[py, px]) - counters["n_dist"])
            de = abs(int(out.num_empty_samples[py, px]) - counters["n_empty"])
            assert dv <= 2 and dd <= 2 and de <= 2, \
                f"pixel {py},{px}: Δvol={dv} Δdist={dd} Δempty={de}"
            exact_matches.append(dv == 0 and dd == 0 and de == 0)
            n_checked += 1
    assert n_checked >= 3
    assert np.mean(exact_matches) >= 0.8


def test_ess_modes_pixel_parity(rng):
    """All ESS modes produce the same image (the reference's by-eye invariant,
    README.md:74-82) — here asserted numerically."""
    vol = sphere_shell_volume(40)
    s = _setup(vol, size=24)
    base = np.asarray(_march(vol, s, SkippingType.NONE).color)
    for skipping in [SkippingType.BLOCK, SkippingType.DISTANCE,
                     SkippingType.ANISOTROPIC_DISTANCE]:
        img = np.asarray(_march(vol, s, skipping).color)
        np.testing.assert_allclose(img, base, atol=5e-3,
                                   err_msg=SKIP_NAMES[skipping])


def test_ess_reduces_samples(rng):
    vol = sphere_shell_volume(40)
    s = _setup(vol, size=24)
    outs = {sk: _march(vol, s, sk) for sk in SkippingType}
    tot = {
        sk: int(np.sum(np.asarray(o.num_volume_samples))
                + np.sum(np.asarray(o.num_distance_samples)))
        for sk, o in outs.items()
    }
    assert tot[SkippingType.DISTANCE] < tot[SkippingType.BLOCK] < tot[SkippingType.NONE]
    assert tot[SkippingType.ANISOTROPIC_DISTANCE] <= tot[SkippingType.DISTANCE]


def test_ert_reduces_iterations():
    vol = np.full((32, 32, 32), 255, np.uint8)  # solid: ERT kicks in fast
    s = _setup(vol, size=16)
    with_ert = _march(vol, s, SkippingType.NONE, ert=True)
    without = _march(vol, s, SkippingType.NONE, ert=False)
    assert int(with_ert.iterations) < int(without.iterations)
    a = np.asarray(with_ert.color)[..., 3]
    valid = np.asarray(s["rays"].valid)
    # Grazing edge rays may early-out with zero alpha (frag:182-187); the
    # bulk of covered pixels must saturate to exactly 1.0 via ERT.
    assert (a[valid] == 1.0).mean() > 0.9


def test_entry_exit_diagnostics():
    vol = sphere_shell_volume(32)
    s = _setup(vol, size=16)
    ent = _march(vol, s, SkippingType.NONE, test=RT.RAY_ENTRY)
    ext = _march(vol, s, SkippingType.NONE, test=RT.RAY_EXIT)
    valid = np.asarray(s["rays"].valid)
    np.testing.assert_allclose(
        np.asarray(ent.color)[valid][:, :3], np.asarray(s["rays"].entry)[valid],
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(ext.color)[valid][:, :3], np.asarray(s["rays"].exit)[valid],
        atol=1e-6,
    )


def test_num_samples_diagnostic_normalisation():
    vol = sphere_shell_volume(32)
    s = _setup(vol, size=16)
    out = _march(vol, s, SkippingType.DISTANCE, test=RT.NUM_TEXTURE_SAMPLES,
                 ert=False)
    img = np.asarray(out.color)
    n_steps_max = np.floor(np.ceil(32 * np.sqrt(3.0)) * 1.0)
    counts = np.asarray(out.num_volume_samples) + np.asarray(out.num_distance_samples)
    valid = np.asarray(s["rays"].valid)
    np.testing.assert_allclose(img[valid][:, 0],
                               (counts / n_steps_max)[valid], atol=1e-6)


def test_gradient_test_equivalence(rng):
    """--gradient_test: on-the-fly gradients ≈ precomputed-map gradients
    (reference: src/volume_render.h:52, volume_render.frag:90-98)."""
    vol = sphere_shell_volume(32)
    s = _setup(vol, size=12, use_gradient=True, tf_kw=dict(gmin=0.05, gmax=0.3))
    pre = np.asarray(_march(vol, s, SkippingType.NONE, precomp=True).color)
    fly = np.asarray(_march(vol, s, SkippingType.NONE, precomp=False).color)
    # precomputed map quantises to u8 and uses integer taps → small tolerance
    assert np.abs(pre - fly).max() < 0.06


def test_first_hit_depth_written():
    vol = np.full((32, 32, 32), 255, np.uint8)
    s = _setup(vol, size=16)
    out = _march(vol, s, SkippingType.NONE)
    valid = np.asarray(s["rays"].valid)
    depth = np.asarray(out.depth)
    hit = np.asarray(out.color)[..., 3] > 0.0
    # reverse-Z: hits write depth in front of the cleared 0.0; grazing valid
    # rays that early-out (frag:182-187) keep the cleared value.
    assert hit.any()
    assert (depth[hit] > 0.0).all()
    assert (depth[~valid] == 0.0).all()
