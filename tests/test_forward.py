"""Forward mesh subpass (render/forward.py): rasteriser semantics and the
scene+volume composite — the reference's optional Sponza pass
(src/volume_render.cpp:329-356, volume_render.frag:122-165,
src/volume_render_subpass.cpp:177-186)."""

import numpy as np

from vkvolume.camera import orbit_camera
from vkvolume.engine import Engine, RenderOptions, VolumeOptions, \
    from_array
from vkvolume.options import SkippingType
from vkvolume.render import forward

from util import sphere_shell_volume

CAM = orbit_camera(radius=200.0, azimuth_deg=0, elevation_deg=10,
                   aspect=2.0)


def _tri(z, rgb, reverse=False):
    v = np.array([[-30, -20, z], [30, -20, z], [0, 30, z]], np.float32)
    f = np.array([[0, 2, 1]] if reverse else [[0, 1, 2]], np.int32)
    return forward.Mesh(verts=v, faces=f,
                        albedo=np.array([rgb], np.float32))


def _cat(*ms):
    verts, faces, alb, off = [], [], [], 0
    for m in ms:
        verts.append(m.verts)
        faces.append(m.faces + off)
        alb.append(m.albedo)
        off += len(m.verts)
    return forward.Mesh(np.concatenate(verts), np.concatenate(faces),
                        np.concatenate(alb))


def test_rasterize_coverage_cull_and_zorder():
    # Camera at azimuth 0 sits on +z looking at the origin: a world-CCW
    # (normal +z) triangle faces it.
    front = _tri(0.0, (1.0, 0.0, 0.0))
    col, dep = forward.rasterize(front, CAM, 64, 128)
    col, dep = np.asarray(col), np.asarray(dep)
    assert (dep > 0).mean() > 0.005                 # covered
    assert col[dep > 0][:, 0].min() > 0.0           # red channel shaded
    assert (col[dep == 0] == 0).all()               # clear elsewhere

    back = _tri(0.0, (1.0, 0.0, 0.0), reverse=True)
    _, dep_b = forward.rasterize(back, CAM, 64, 128)
    assert not (np.asarray(dep_b) > 0).any()        # back-face culled

    # Nearer (larger reverse-Z) green triangle wins the z-test where it
    # overlaps the red one.
    both = _cat(front, _tri(50.0, (0.0, 1.0, 0.0)))
    col2, dep2 = forward.rasterize(both, CAM, 64, 128)
    col2, dep2 = np.asarray(col2), np.asarray(dep2)
    c = col2[32, 64]
    assert c[1] > 0.0 and c[0] == 0.0, c
    _, dep_near = forward.rasterize(_tri(50.0, (0, 1, 0)), CAM, 64, 128)
    dep_near = np.asarray(dep_near)
    m = dep_near > 0
    assert (dep2[m] >= dep_near[m] - 1e-6).all()


def test_scene_composite_occludes_and_underlays():
    n = 40
    vol = sphere_shell_volume(n)
    eng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                 renderer="marcher")
    v = from_array(vol, VolumeOptions(intensity_min=0.1, gradient_min=0.0,
                                      gradient_max=0.0), block_size=4)
    v.set_scale((100.0 / n,) * 3)
    eng.add_volume(v)
    H, W = 32, 64
    cam = orbit_camera(radius=220.0, azimuth_deg=0, elevation_deg=0,
                       aspect=W / H)

    base = np.asarray(eng.render(cam, W, H).color)      # volume alone
    assert base[..., 3].max() > 0.3

    # Wall BETWEEN camera (at +z ~220) and the volume cube: every volume
    # ray is clipped before entry — the frame shows only the wall.
    wall_f = forward.Mesh(
        verts=np.array([[-500, -500, 140], [500, -500, 140],
                        [500, 500, 140], [-500, 500, 140]], np.float32),
        faces=np.array([(0, 1, 2), (0, 2, 3)], np.int32),
        albedo=np.tile(np.array([0.2, 0.4, 0.8], np.float32), (2, 1)))
    out_f = np.asarray(eng.render_with_scene(cam, W, H, wall_f).color)
    # Volume contribution gone: color matches the shaded wall everywhere.
    assert np.allclose(out_f[..., 3], 1.0)
    assert (out_f[..., 2] > out_f[..., 0]).all()        # blue-ish wall
    ctr = out_f[H // 2, W // 2]
    assert abs(ctr[0] - base[H // 2, W // 2, 0]) > 0.05 \
        or base[H // 2, W // 2, 0] < 0.05

    # Wall BEHIND the volume: the volume composites OVER it — center pixel
    # matches the volume-alone render up to the (1-α)·scene underlay.
    # Mirroring z keeps the (x, y) winding, so the same face order still
    # faces +z (toward the camera).
    wall_b = forward.Mesh(
        verts=wall_f.verts * np.array([1, 1, -1], np.float32),
        faces=wall_f.faces, albedo=wall_f.albedo)
    out_b = np.asarray(eng.render_with_scene(cam, W, H, wall_b).color)
    ctr_b = out_b[H // 2, W // 2]
    ctr_v = base[H // 2, W // 2]
    # Volume term preserved exactly; underlay only adds where α < 1.
    assert ctr_b[0] >= ctr_v[0] - 1e-5
    assert np.allclose(out_b[..., 3], 1.0)              # wall fills bg
    # Away from the volume silhouette the wall color shows through.
    edge = out_b[0, 0]
    assert edge[2] > edge[0]


def test_sponza_lite_scene_renders():
    mesh = forward.sponza_lite()
    col, dep = forward.rasterize(mesh, CAM, 64, 128)
    dep = np.asarray(dep)
    assert (dep > 0).mean() > 0.5          # hall covers most of the frame
    assert np.isfinite(np.asarray(col)).all()
    assert dep.max() <= 1.0 + 1e-6
