"""Host-analytic view analysis (render/plan.py) against the same
quantities reduced from the device ray field (render/ray_setup.make_rays):
the principal axis, its direction sign, and mixed-sign detection."""

import numpy as np
import pytest

from vkvolume.camera import orbit_camera, perspective_camera
from vkvolume.render import make_rays, make_uniforms
from vkvolume.render import plan as plan_mod
from vkvolume.render import sweep as sweep_mod
from vkvolume.utils import math3d

CAMS = [
    orbit_camera(radius=220.0, azimuth_deg=30, elevation_deg=20, aspect=1.0),
    orbit_camera(radius=150.0, azimuth_deg=-50, elevation_deg=45, aspect=2.0),
    orbit_camera(radius=400.0, azimuth_deg=110, elevation_deg=-30,
                 aspect=16 / 9),
    orbit_camera(radius=95.0, azimuth_deg=75, elevation_deg=5, aspect=1.5),
    perspective_camera(eye=(180, 40, -60), center=(10, -5, 0), fovy_deg=40.0,
                       aspect=1.0),
]


def _uniforms(cam, n=64):
    node = math3d.scale((100.0 / n,) * 3)
    img_t = math3d.scale((float(n),) * 3)
    return make_uniforms(cam, node, img_t, 50.0, (4.0, 4.0, 4.0))


@pytest.mark.parametrize("ci", range(len(CAMS)))
def test_analytic_view_contains_device_stats(ci):
    H, W = 64, 128
    u = _uniforms(CAMS[ci])
    view = plan_mod.analyze_view(u, H, W)
    assert view is not None and not view["mixed"]

    rays = make_rays(u, H, W)
    p_dev = sweep_mod.principal_axis(rays)
    assert view["p_axis"] == p_dev
    assert not sweep_mod.mixed_principal_signs(rays, p_dev)

    # Direction sign along the sweep axis, reduced over the valid rays.
    d_p = np.asarray(rays.ray_dir)[..., p_dev]
    valid = np.asarray(rays.valid)
    assert valid.any()
    assert view["sgn"] == (1.0 if d_p[valid].sum() >= 0 else -1.0)
    assert (np.sign(d_p[valid & (np.abs(d_p) > 1e-6)]) == view["sgn"]).all()


def test_analytic_view_detects_mixed_signs():
    cam = orbit_camera(radius=10.0, azimuth_deg=45, elevation_deg=35,
                       fovy_deg=120.0, aspect=1.0)
    u = _uniforms(cam)
    view = plan_mod.analyze_view(u, 64, 64)
    assert view is not None and view["mixed"]
    # The device ray field agrees: no axis gives one slab order.
    rays = make_rays(u, 64, 64)
    assert all(sweep_mod.mixed_principal_signs(rays, p) for p in range(3))


def test_analytic_view_no_coverage():
    # Camera looking away from the volume.
    cam = perspective_camera(eye=(300, 0, 0), center=(600, 0, 0),
                             fovy_deg=40.0, aspect=1.0)
    u = _uniforms(cam)
    assert plan_mod.analyze_view(u, 64, 64) is None
