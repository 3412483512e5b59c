"""Host-only view analysis for the plane sweep.

The sweep needs, per camera pose, the principal slab axis and whether the
rays that hit the volume agree on the sign of their direction along it
(mixed signs → no single slab order composites every ray front-to-back, and
the engine renders that frame with the per-ray marcher). Both are smooth
projective functions of the camera, so this module evaluates them on a
coarse host lattice of pixel rays instead of reducing the device ray field:
a moving camera then pays no device→host transfer per pose.

No jax arrays are touched: numpy only.
"""

from __future__ import annotations

import numpy as np


def _pixel_dirs(u, height: int, width: int, py: np.ndarray, px: np.ndarray):
    """Unnormalized texture-space ray directions for pixel centers (py, px)
    — the numpy twin of make_rays' unprojection (ray_setup.py:141-159).
    Normalization cancels in every ratio used here."""
    vpi = np.asarray(u.view_proj_inv, np.float64)
    g2t = np.asarray(u.global_to_tex, np.float64)
    o = np.asarray(u.cam_pos_tex, np.float64)
    ndc_x = (px + 0.5) / width * 2.0 - 1.0
    ndc_y = (py + 0.5) / height * 2.0 - 1.0
    clip = np.stack(
        [ndc_x, ndc_y, np.zeros_like(ndc_x), np.ones_like(ndc_x)], -1)
    world = clip @ vpi.T
    world = world[..., :3] / world[..., 3:4]
    pt_tex = (
        np.concatenate([world, np.ones_like(world[..., :1])], -1) @ g2t.T
    )[..., :3]
    return pt_tex - o, o


def _valid_mask(u, d: np.ndarray, o: np.ndarray) -> np.ndarray:
    """Cube-interval + clip-plane validity (scale-invariant port of
    make_rays' test, ray_setup.py:161-176)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        dir_inv = 1.0 / d
        t0 = (0.0 - o) * dir_inv
        t1 = (1.0 - o) * dir_inv
        t_near = np.max(np.minimum(t0, t1), axis=-1)
        t_far = np.min(np.maximum(t0, t1), axis=-1)
        plane = np.asarray(u.plane_tex, np.float64)
        s_o = float(plane[:3] @ o + plane[3])
        s_d = d @ plane[:3]
        t_plane = np.where(s_d != 0.0, -s_o / np.where(s_d == 0, 1, s_d),
                           np.inf)
        t_entry = np.where(s_d > 0.0, np.maximum(t_near, t_plane), t_near)
    return (t_entry < t_far) & (t_far > 0.0)


def analyze_view(u, height: int, width: int) -> dict | None:
    """Principal sweep axis of one camera pose.

    Returns ``dict(p_axis, sgn, mixed)``: the slab axis (0=x, 1=y, 2=z),
    the sign of the valid rays' direction along it, and whether the valid
    rays disagree on that sign (→ the caller must use the per-ray marcher).
    None when no ray hits the volume.
    """
    # Pixel lattice: every 16th pixel at HD sizes. Consecutive lattice rays
    # differ by a small angle, so a sign change between them is caught by
    # the lattice rays on either side of it.
    step_y = 16 if height >= 1024 else (8 if height >= 512 else 2)
    step_x = 16 if width >= 1024 else (8 if width >= 512 else 2)
    ys = np.arange(0.0, height + step_y - 1.0, float(step_y)) - 0.5
    xs = np.arange(0.0, width + step_x - 1.0, float(step_x)) - 0.5
    py, px = np.meshgrid(ys, xs, indexing="ij")
    d, o = _pixel_dirs(u, height, width, py, px)
    valid = _valid_mask(u, d, o)
    if not valid.any():
        return None

    # Principal axis from the mean valid direction (normalize first so the
    # mean is direction-weighted like sweep.principal_axis). If the
    # preferred axis is sign-mixed over the valid rays (wide-FOV frames
    # near 45°+fov/2 off-axis), try the remaining axes by |mean| — an
    # oblique but single-signed sweep axis beats the marcher fallback;
    # only an all-axes-mixed frame (camera inside the volume) truly needs
    # the marcher.
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mean = dn[valid].mean(axis=0)
    dnorm = np.linalg.norm(d, axis=-1)
    best = None
    for cand in np.argsort(-np.abs(mean)):
        d_p = d[..., cand]
        sel = valid & (np.abs(d_p) > 1e-9 * dnorm)
        if not sel.any():
            continue
        dpv = d_p[sel]
        mixed = bool((dpv > 0).any() and (dpv < 0).any())
        view = dict(p_axis=int(cand), mixed=mixed,
                    sgn=1.0 if np.median(dpv) >= 0 else -1.0)
        if best is None:
            best = view
        if not mixed:
            return view
    return best
