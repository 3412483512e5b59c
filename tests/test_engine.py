"""Engine-level tests: renderer selection, TF-edit rebuild dirty-tracking,
multi-volume blending, benchmark-mode stats (the reference's interactive
update path, src/volume_render.cpp:392-445)."""

import numpy as np
import pytest

from vkvolume.camera import orbit_camera
from vkvolume.engine import (
    Engine,
    RenderOptions,
    SkippingType,
    VolumeOptions,
    from_array,
)
from vkvolume.options import Test as RT
from vkvolume.utils import math3d

from util import sphere_shell_volume


def _engine(renderer="marcher", skipping=SkippingType.DISTANCE, n=40,
            benchmark=False, **vol_kw):
    vol = sphere_shell_volume(n)
    vol_kw.setdefault("gradient_min", 0.0)
    vol_kw.setdefault("gradient_max", 0.0)
    opts = VolumeOptions(intensity_min=vol_kw.pop("imin", 0.1), **vol_kw)
    eng = Engine(RenderOptions(skipping_type=skipping), renderer=renderer,
                 benchmark_mode=benchmark)
    v = from_array(vol, opts, block_size=4)
    v.set_scale((100.0 / n,) * 3)
    stats = eng.add_volume(v)
    return eng, v, stats


CAM = orbit_camera(radius=220.0, azimuth_deg=30, elevation_deg=20, aspect=1.0)


def test_marcher_and_sweep_agree():
    out_m = _engine("marcher")[0].render(CAM, 32, 32)
    out_s = _engine("sweep")[0].render(CAM, 32, 32)
    a = np.asarray(out_m.color)
    b = np.asarray(out_s.color)
    assert np.abs(a - b).max() < 0.06
    assert abs(a[..., 3].mean() - b[..., 3].mean()) < 2e-3


def test_tf_edit_rebuilds_maps():
    eng, vol, _ = _engine("marcher")
    maps_before = np.asarray(vol.dist_maps).copy()
    vol.options.intensity_min = 0.6          # much sparser TF
    eng.update_transfer_function(vol)
    maps_after = np.asarray(vol.dist_maps)
    assert (maps_after != maps_before).any()
    # sparser TF ⇒ fewer occupied cells ⇒ distances grow
    assert maps_after.astype(int).mean() > maps_before.astype(int).mean()


def test_skipping_type_change_rebuilds():
    eng, vol, _ = _engine("marcher", skipping=SkippingType.DISTANCE)
    assert vol.dist_maps.shape[0] == 1
    eng.set_skipping_type(SkippingType.ANISOTROPIC_DISTANCE)
    assert vol.dist_maps.shape[0] == 8


def test_benchmark_mode_stats():
    eng, vol, stats = _engine("marcher", benchmark=True)
    assert stats.occupied_voxel_percent is not None
    assert 0.0 < stats.occupied_voxel_percent < 100.0
    assert stats.map_update_ms is not None and stats.map_update_ms > 0
    assert eng.options.test == RT.NUM_TEXTURE_SAMPLES
    assert not eng.options.early_ray_termination
    assert eng.options.clip_distance == 1.0


def test_multi_volume_blend():
    n = 32
    vol = sphere_shell_volume(n)
    opts = VolumeOptions(intensity_min=0.1, gradient_min=0.0, gradient_max=0.0)
    eng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                 renderer="marcher")
    v1 = from_array(vol, opts, block_size=4, name="a")
    v1.set_scale((100.0 / n,) * 3)
    v1.node_transform = math3d.translate((-30, 0, 0)) @ v1.node_transform
    v2 = from_array(vol, opts, block_size=4, name="b")
    v2.set_scale((100.0 / n,) * 3)
    v2.node_transform = math3d.translate((30, 0, 0)) @ v2.node_transform
    eng.add_volume(v1)
    eng.add_volume(v2)
    out = eng.render(CAM, 48, 48)
    single = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                    renderer="marcher")
    v3 = from_array(vol, opts, block_size=4)
    v3.set_scale((100.0 / n,) * 3)
    v3.node_transform = math3d.translate((-30, 0, 0)) @ v3.node_transform
    single.add_volume(v3)
    out_single = single.render(CAM, 48, 48)
    # two volumes cover at least as many pixels as one
    assert (np.asarray(out.color)[..., 3] > 0).sum() >= (
        np.asarray(out_single.color)[..., 3] > 0
    ).sum()


def test_multi_volume_blend_order_overlapping():
    """Overlapping volumes where draw order matters: the engine must apply
    the reference blend state (src/volume_render_subpass.cpp:177-186 — src
    factor ONE, dst ONE_MINUS_SRC_ALPHA), i.e. each later draw composites
    OVER the accumulated target: new = src + (1 - src.a) * dst."""
    n = 32
    vol = sphere_shell_volume(n)
    opts_a = VolumeOptions(intensity_min=0.1, gradient_min=0.0, gradient_max=0.0)
    opts_b = VolumeOptions(intensity_min=0.4, gradient_min=0.0, gradient_max=0.0)

    def mk(opts, dx, name):
        v = from_array(vol, opts, block_size=4, name=name)
        v.set_scale((100.0 / n,) * 3)
        v.node_transform = math3d.translate((dx, 0, 0)) @ v.node_transform
        return v

    eng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                 renderer="marcher")
    eng.add_volume(mk(opts_a, -10, "a"))
    eng.add_volume(mk(opts_b, 10, "b"))
    out = eng.render(CAM, 48, 48)

    def solo(opts, dx):
        e = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                   renderer="marcher")
        e.add_volume(mk(opts, dx, "s"))
        return e.render(CAM, 48, 48)

    r1 = solo(opts_a, -10)
    r2 = solo(opts_b, 10)
    c1, c2 = np.asarray(r1.color), np.asarray(r2.color)
    expected = c2 + (1.0 - c2[..., 3:4]) * c1          # later draw in front
    wrong = c1 + (1.0 - c1[..., 3:4]) * c2             # transposed order
    got = np.asarray(out.color)
    np.testing.assert_allclose(got, expected, atol=1e-5)
    # order must actually matter on this scene, else the test is vacuous
    assert np.abs(expected - wrong).max() > 0.01
    # reverse-Z depth: nearer (greater) hit wins per pixel
    np.testing.assert_allclose(
        np.asarray(out.depth),
        np.maximum(np.asarray(r1.depth), np.asarray(r2.depth)),
        atol=1e-6,
    )


def test_mixed_sign_frame_falls_back_to_marcher():
    """Camera inside the volume with a wide FOV: rays straddle the principal
    axis, so the sweep's single global slab order cannot composite all rays
    front-to-back — the engine must use the per-ray marcher for the frame."""
    from vkvolume.camera import orbit_camera as _orbit

    cam = _orbit(radius=10.0, azimuth_deg=45, elevation_deg=35,
                 fovy_deg=120.0, aspect=1.0)
    eng_s, _, _ = _engine("sweep")
    out_s = eng_s.render(cam, 32, 32)
    assert eng_s.last_renderer == "marcher"
    eng_m, _, _ = _engine("marcher")
    out_m = eng_m.render(cam, 32, 32)
    np.testing.assert_allclose(np.asarray(out_s.color),
                               np.asarray(out_m.color), atol=1e-6)


def test_gradient_tf_slab_skip_within_tolerance():
    """Gradient-modulated 2D TF: slab skipping is no longer exact (corners
    may fail different gates while the interpolated sample passes both) —
    the skip-vs-noskip error must stay within sampling tolerance."""
    kw = dict(imin=0.1, gradient_min=0.05, gradient_max=0.6)
    out_skip = _engine("sweep", skipping=SkippingType.DISTANCE, **kw)[0].render(
        CAM, 32, 32)
    out_none = _engine("sweep", skipping=SkippingType.NONE, **kw)[0].render(
        CAM, 32, 32)
    a = np.asarray(out_skip.color)
    b = np.asarray(out_none.color)
    assert (a[..., 3] > 0).any()          # scene not empty
    assert np.abs(a - b).max() < 0.04     # bounded skip error


def test_render_image_composites_over_background():
    eng, _, _ = _engine("marcher")
    img = eng.render_image(CAM, 32, 32, background=(1.0, 0.0, 0.0))
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    # uncovered pixels show the red background
    assert (img[0, 0] == [255, 0, 0]).all()


def test_accel_cache_roundtrip(tmp_path):
    """Checkpoint/resume of acceleration structures (SURVEY.md §5)."""
    from vkvolume.engine import Engine, RenderOptions, from_array

    n = 24
    vol = sphere_shell_volume(n)
    opts = VolumeOptions(intensity_min=0.1, gradient_min=0.0, gradient_max=0.0)

    eng1 = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                  renderer="marcher", accel_cache_dir=str(tmp_path))
    v1 = from_array(vol, opts, block_size=4)
    eng1.add_volume(v1)
    maps1 = np.asarray(v1.dist_maps)
    grad1 = np.asarray(v1.gradient)

    eng2 = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                  renderer="marcher", accel_cache_dir=str(tmp_path))
    v2 = from_array(vol, opts, block_size=4)
    stats = eng2.add_volume(v2)
    # restored, not recomputed
    assert stats.map_update_ms is None
    np.testing.assert_array_equal(np.asarray(v2.dist_maps), maps1)
    np.testing.assert_array_equal(np.asarray(v2.gradient), grad1)

    # different TF → different key → rebuild happens
    opts3 = VolumeOptions(intensity_min=0.5, gradient_min=0.0, gradient_max=0.0)
    eng3 = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                  renderer="marcher", accel_cache_dir=str(tmp_path))
    v3 = from_array(vol, opts3, block_size=4)
    stats3 = eng3.add_volume(v3)
    assert stats3.map_update_ms is not None


@pytest.mark.parametrize("renderer", ["marcher", "sweep"])
def test_texture_tf_matches_closed_form(renderer):
    """TRANSFER_FUNCTION_TEXTURE variant (transfer_function.glsl:36-38):
    the baked 256x256 texture agrees with the closed form up to the bake's
    u8 truncation + 256-bin nearest lookup (volume_component.cpp:246-261)."""
    eng, _, _ = _engine(renderer)
    out_c = eng.render(CAM, 32, 32)
    eng.options.texture_tf = True
    out_t = eng.render(CAM, 32, 32)
    a = np.asarray(out_c.color)
    b = np.asarray(out_t.color)
    assert np.abs(a - b).max() < 0.06
    assert np.abs(a - b).mean() < 5e-3
    assert not np.array_equal(a, b)  # the quantised path really ran


def test_octant_composite_matches_per_cell_selection():
    """engine._octant_composite stitches the 8 octant maps along the
    camera's three axis planes — the per-cell twin of the reference's
    per-RAY map selection (volume_render.frag:209): for a pinhole camera
    the ray through cell c has direction c - cam, so its octant is
    (z<kz) + 2*(y<ky) + 4*(x<kx). Cells straddling a plane take the min
    of both sides (rays of either sign pass through them)."""
    import jax.numpy as jnp

    from vkvolume.engine.engine import _octant_composite

    rng = np.random.default_rng(7)
    maps = rng.integers(0, 255, size=(8, 6, 7, 9), dtype=np.uint8)
    for kz, ky, kx in [(2.4, 3.0, 4.7), (-1.0, 2.5, 100.0), (0.0, 0.0, 0.0)]:
        got = np.asarray(_octant_composite(
            jnp.asarray(maps), jnp.float32(kz), jnp.float32(ky),
            jnp.float32(kx)))
        exp = np.empty(maps.shape[1:], np.uint8)
        for z in range(maps.shape[1]):
            for y in range(maps.shape[2]):
                for x in range(maps.shape[3]):
                    zs = [z < kz] if np.floor(kz) != z else [True, False]
                    ys = [y < ky] if np.floor(ky) != y else [True, False]
                    xs = [x < kx] if np.floor(kx) != x else [True, False]
                    exp[z, y, x] = min(
                        maps[int(bz) + 2 * int(by) + 4 * int(bx), z, y, x]
                        for bz in zs for by in ys for bx in xs)
        np.testing.assert_array_equal(got, exp, err_msg=f"k={kz},{ky},{kx}")


def test_aniso_image_matches_iso():
    """Anisotropic skipmode in the sweep path renders the same image as
    the isotropic one (octant maps only lengthen leaps; the occupied set
    is identical — the reference's cross-mode pixel-parity invariant)."""
    eng_a, vol_a, _ = _engine("sweep",
                              skipping=SkippingType.ANISOTROPIC_DISTANCE)
    eng_i, _, _ = _engine("sweep", skipping=SkippingType.DISTANCE)
    out_a = eng_a.render(CAM, 32, 32)
    out_i = eng_i.render(CAM, 32, 32)
    np.testing.assert_allclose(np.asarray(out_a.color),
                               np.asarray(out_i.color), atol=1e-5)
    # The stitched map really was built (and cached per camera cell).
    occ_keys = [k for k in vol_a._sweep_cache
                if isinstance(k, tuple) and k[0] == "occ"]
    assert occ_keys and all(len(k[3]) == 3 for k in occ_keys)


@pytest.mark.parametrize("test_mode", [RT.RAY_ENTRY, RT.RAY_EXIT])
def test_entry_exit_test_images_direct_path(test_mode):
    # RAY_ENTRY/RAY_EXIT never march (volume_render.frag:168-173): the
    # sweep engine serves them straight from the ray setup — one
    # elementwise program, no maps — and must match the marcher oracle.
    eng, _, _ = _engine("sweep", n=48)
    eng.options.test = test_mode
    out = eng.render(CAM, 32, 128)
    assert eng.last_renderer == "sweep"
    ref_eng, _, _ = _engine("marcher", n=48)
    ref_eng.options.test = test_mode
    ref = ref_eng.render(CAM, 32, 128)
    np.testing.assert_allclose(np.asarray(out.color),
                               np.asarray(ref.color), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.depth),
                               np.asarray(ref.depth), atol=1e-6)


def test_edge_repair_closes_resample_gap():
    # The sweep samples each ray on slab planes; silhouette pixels can
    # land on the wrong side of the edge. edge_repair re-marches the
    # suspect pixels with the oracle marcher — the repaired frame must be
    # strictly closer to the oracle, and the worst repaired-region error
    # must collapse to the oracle's own tolerance.
    H, W = 64, 64
    ref = _engine("marcher", n=48)[0].render(CAM, W, H)
    plain_eng, _, _ = _engine("sweep", n=48)
    plain = plain_eng.render(CAM, W, H)
    rep_eng, _, _ = _engine("sweep", n=48)
    rep_eng.options.edge_repair = True
    rep = rep_eng.render(CAM, W, H)

    a_ref = np.asarray(ref.color)
    d_plain = np.abs(np.asarray(plain.color) - a_ref).max(-1)
    d_rep = np.abs(np.asarray(rep.color) - a_ref).max(-1)
    n_found, budget = rep_eng.last_repair_px
    assert 0 < int(n_found) <= budget
    # No pixel may get worse, and the >2/255 population must strictly
    # shrink (the repaired pixels coincide with the oracle; the remaining
    # diffs are smooth-region resampling below the suspect threshold).
    assert d_rep.max() <= d_plain.max() + 1e-6
    assert (d_rep > 2 / 255).sum() < (d_plain > 2 / 255).sum()


def test_edge_repair_banded_equals_single_program(monkeypatch):
    """The repair march is banded into chunks so each lock-step loop stops
    at its own slowest lane instead of the frame's. Banding must be
    output-invariant: every lane is independent."""
    from vkvolume.engine import engine as eng_mod

    H, W = 64, 64
    single_eng, _, _ = _engine("sweep", n=48)
    single_eng.options.edge_repair = True
    single = np.asarray(single_eng.render(CAM, W, H).color)
    banded_eng, _, _ = _engine("sweep", n=48)
    banded_eng.options.edge_repair = True
    monkeypatch.setitem(eng_mod._REPAIR_CHUNK, False, 1024)
    monkeypatch.setitem(eng_mod._REPAIR_CHUNK, True, 1024)
    banded = np.asarray(banded_eng.render(CAM, W, H).color)
    assert int(banded_eng.last_repair_px[1]) > 1024  # actually banded
    np.testing.assert_allclose(banded, single, atol=1e-6)


def test_spin_volume_rotates_render():
    """Volume.set_spin (the reference's spin_volumes animation,
    src/volume_render.cpp:89): a 90-degree node rotation changes the frame
    while preserving the scale; spin is absolute, not cumulative."""
    eng, v, _ = _engine("marcher")
    base = np.asarray(eng.render(CAM, 32, 32).color)
    v.set_spin(np.deg2rad(90.0))
    spun = np.asarray(eng.render(CAM, 32, 32).color)
    assert spun[..., 3].max() > 0.3
    assert np.abs(spun - base).max() > 0.02
    # Scale preserved: rotation by 360 degrees restores the base frame.
    v.set_spin(np.deg2rad(360.0))
    back = np.asarray(eng.render(CAM, 32, 32).color)
    np.testing.assert_allclose(back, base, atol=2e-2)


def test_stale_octant_combines_evicted_on_rebuild():
    """Each cached occupancy/octant combine is a full transposed u8 volume
    on device; a TF edit (map rebuild) must evict combines of superseded
    builds or an interactive session leaks device memory per edit."""
    eng, v, _ = _engine("sweep")
    eng.render(CAM, 32, 32)
    occ_keys = [k for k in v._sweep_cache
                if isinstance(k, tuple) and k[0] == "occ"]
    assert len(occ_keys) == 1
    v0 = occ_keys[0][2]
    for imin in (0.15, 0.2, 0.25):
        v.options.intensity_min = imin
        eng.update_transfer_function(v, timed_runs=1)
        eng.render(CAM, 32, 32)
    occ_keys = [k for k in v._sweep_cache
                if isinstance(k, tuple) and k[0] == "occ"]
    assert len(occ_keys) == 1
    assert occ_keys[0][2] > v0
