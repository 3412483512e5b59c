"""Acceleration-structure tests: gradient map, occupancy, voxel count, and
the Chebyshev distance transforms against brute force (SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from vkvolume.accel import (
    anisotropic_distance,
    axis_scan,
    brute_force_chebyshev,
    effective_block_size,
    gradient_map,
    isotropic_distance,
    map_extent,
    occupancy_map,
    occupied_voxel_count,
)
from vkvolume.tf import tf_params

from util import random_blob_volume

# ---------------------------------------------------------------- gradient


def _gradient_numpy(vol):
    """Direct translation of get_gradient_compute.glsl:12-20."""
    d, h, w = vol.shape
    out = np.zeros(vol.shape, np.uint8)
    taps = [(1, -1, -1), (-1, -1, 1), (-1, 1, -1), (1, 1, 1)]
    vol_f = vol.astype(np.float32) / 255.0
    pad = np.pad(vol_f, 1, mode="edge")
    acc = np.zeros(vol.shape + (3,), np.float32)
    for ox, oy, oz in taps:
        v = pad[1 + oz : 1 + oz + d, 1 + oy : 1 + oy + h, 1 + ox : 1 + ox + w]
        acc += np.array([ox, oy, oz], np.float32) * v[..., None]
    g = np.clip(np.linalg.norm(acc * 0.25, axis=-1), 0, 1)
    return np.round(g * 255).astype(np.uint8)


def test_gradient_map_matches_numpy(rng):
    vol = random_blob_volume(rng, (20, 18, 22))
    got = np.asarray(gradient_map(jnp.asarray(vol), 1.0, use_gradient=True))
    want = _gradient_numpy(vol)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_gradient_map_disabled_is_ones():
    vol = np.zeros((4, 4, 4), np.uint8)
    got = np.asarray(gradient_map(jnp.asarray(vol), 1.0, use_gradient=False))
    assert (got == 255).all()


# ---------------------------------------------------------------- occupancy


def test_map_extent_and_effective_block_size():
    # extent 9, nominal bs 4 → map 3, effective bs 3 (rndUp semantics,
    # compute_distance_map.cpp:107-113)
    assert map_extent((9, 9, 9), 4) == (3, 3, 3)
    assert effective_block_size((9, 9, 9), (3, 3, 3)) == (3, 3, 3)
    assert map_extent((832, 832, 494), 4) == (208, 208, 124)
    assert effective_block_size((832, 832, 494), (208, 208, 124)) == (4, 4, 4)


def test_occupancy_map_blocks(rng):
    vol = random_blob_volume(rng, (17, 13, 21))
    tf = tf_params(intensity_min=0.3, gradient_min=0.0, gradient_max=0.0)
    mz, my, mx = 5, 4, 6  # ceil(17/4), ceil(13/4), ceil(21/4)
    occ = np.asarray(
        occupancy_map(jnp.asarray(vol), None, tf, (mz, my, mx))
    )
    assert occ.shape == (mz, my, mx)
    # brute force
    alpha_pos = (vol.astype(np.float32) / 255.0) > 0.3
    bz, by, bx = 4, 4, 4
    for z in range(mz):
        for y in range(my):
            for x in range(mx):
                blk = alpha_pos[z * bz:(z + 1) * bz, y * by:(y + 1) * by,
                                x * bx:(x + 1) * bx]
                assert occ[z, y, x] == (0 if blk.any() else 255)


def test_occupancy_alpha_boundary_exact():
    # intensity exactly at imin → alpha == 0 → empty (strict > in frag/comp)
    vol = np.full((4, 4, 4), 128, np.uint8)
    tf = tf_params(intensity_min=128 / 255.0, gradient_min=0.0, gradient_max=0.0)
    occ = np.asarray(occupancy_map(jnp.asarray(vol), None, tf, (1, 1, 1)))
    assert occ[0, 0, 0] == 255
    tf2 = tf_params(intensity_min=127 / 255.0, gradient_min=0.0, gradient_max=0.0)
    occ2 = np.asarray(occupancy_map(jnp.asarray(vol), None, tf2, (1, 1, 1)))
    assert occ2[0, 0, 0] == 0


def test_occupancy_with_gradient_modulation(rng):
    vol = random_blob_volume(rng, (16, 16, 16))
    grad = gradient_map(jnp.asarray(vol), 1.0, use_gradient=True)
    tf = tf_params(intensity_min=0.1, gradient_min=0.1, gradient_max=0.3)
    occ = np.asarray(occupancy_map(jnp.asarray(vol), grad, tf, (4, 4, 4)))
    # gradient-modulated occupancy must be a subset of intensity-only occupancy
    tf_i = tf_params(intensity_min=0.1, gradient_min=0.0, gradient_max=0.0)
    occ_i = np.asarray(occupancy_map(jnp.asarray(vol), None, tf_i, (4, 4, 4)))
    assert ((occ == 0) <= (occ_i == 0)).all()


def test_occupied_voxel_count(rng):
    vol = random_blob_volume(rng, (15, 14, 13))
    tf = tf_params(intensity_min=0.25, gradient_min=0.0, gradient_max=0.0)
    n = int(occupied_voxel_count(jnp.asarray(vol), None, tf))
    want = int(((vol.astype(np.float32) / 255.0) > 0.25).sum())
    assert n == want


# ---------------------------------------------------------------- distance


def _random_occ(rng, shape, p):
    return np.where(rng.random(shape) < p, 0, 255).astype(np.uint8)


def _sequential_axis_scan(occ_line):
    """Literal translation of distance_map.comp stage 0 (:57-71)."""
    g = occ_line.astype(np.int32).copy()
    prev = g[0]
    for x in range(1, len(g)):
        g[x] = min(prev + 1, g[x])
        prev = g[x]
    for x in range(len(g) - 2, -1, -1):
        g[x] = min(prev + 1, g[x])
        prev = g[x]
    return g


def test_axis_scan_matches_sequential(rng):
    occ = _random_occ(rng, (3, 4, 31), 0.15)
    got = np.asarray(axis_scan(jnp.asarray(occ), axis=2, direction=0))
    for z in range(3):
        for y in range(4):
            np.testing.assert_array_equal(
                got[z, y], _sequential_axis_scan(occ[z, y])
            )


@pytest.mark.parametrize("shape,p", [((6, 7, 8), 0.1), ((12, 5, 9), 0.03),
                                     ((4, 4, 4), 0.5)])
def test_isotropic_matches_brute_force(rng, shape, p):
    occ = _random_occ(rng, shape, p)
    got = np.asarray(isotropic_distance(jnp.asarray(occ)))
    np.testing.assert_array_equal(got, brute_force_chebyshev(occ))


def test_isotropic_edge_cases():
    empty = np.full((5, 6, 7), 255, np.uint8)
    assert (np.asarray(isotropic_distance(jnp.asarray(empty))) == 255).all()
    full = np.zeros((5, 6, 7), np.uint8)
    assert (np.asarray(isotropic_distance(jnp.asarray(full))) == 0).all()


def test_anisotropic_matches_brute_force(rng):
    # cap=255 = reference-exact octant values (the default ANISO_CAP only
    # shortens >cap leaps; its exact-min semantics are pinned in
    # test_anisotropic_cap_semantics).
    occ = _random_occ(rng, (6, 7, 8), 0.12)
    got = np.asarray(anisotropic_distance(jnp.asarray(occ), cap=255))
    assert got.shape == (8, 6, 7, 8)
    for idx in range(8):
        sx = -1 if (idx & 4) else +1
        sy = -1 if (idx & 2) else +1
        sz = -1 if (idx & 1) else +1
        np.testing.assert_array_equal(
            got[idx], brute_force_chebyshev(occ, (sx, sy, sz)),
            err_msg=f"octant {idx}",
        )


def _pairwise_chebyshev(occ, direction_xyz):
    """The definition itself, one occupied cell at a time (tiny inputs)."""
    out = np.full(occ.shape, 255, np.int32)
    grid = np.indices(occ.shape)                      # z, y, x
    sides = (direction_xyz[2], direction_xyz[1], direction_xyz[0])
    for cell in np.argwhere(occ == 0):
        delta = cell[:, None, None, None] - grid      # occupied - p
        ok = np.ones(occ.shape, bool)
        for d, s in zip(delta, sides):
            if s:
                ok &= (d == 0) | (np.sign(d) == s)
        dist = np.abs(delta).max(axis=0)
        out = np.where(ok, np.minimum(out, dist), out)
    return out.astype(np.uint8)


@pytest.mark.parametrize("direction", [(0, 0, 0), (1, -1, 1), (-1, 1, -1)])
def test_brute_force_reference_matches_definition(rng, direction):
    """The summed-area brute force (the reference every DT test trusts)
    against the pairwise definition."""
    occ = _random_occ(rng, (5, 6, 7), 0.08)
    np.testing.assert_array_equal(brute_force_chebyshev(occ, direction),
                                  _pairwise_chebyshev(occ, direction))


# Shapes with long, short and uneven axes (a 140-cell x line, a 124-cell
# z line), at the occupancy densities of real block maps.
_DT_SHAPES = [((10, 20, 30), 0.07), ((13, 7, 140), 0.03),
              ((124, 20, 16), 0.07)]


@pytest.mark.parametrize("shape,p", _DT_SHAPES)
def test_isotropic_matches_brute_force_uneven_shapes(rng, shape, p):
    occ = _random_occ(rng, shape, p)
    got = np.asarray(isotropic_distance(jnp.asarray(occ)))
    np.testing.assert_array_equal(got, brute_force_chebyshev(occ))


@pytest.mark.parametrize("shape,p", _DT_SHAPES)
def test_anisotropic_matches_brute_force_uneven_shapes(rng, shape, p):
    occ = _random_occ(rng, shape, p)
    got = np.asarray(anisotropic_distance(jnp.asarray(occ), cap=255))
    for idx in range(8):
        sx = -1 if (idx & 4) else +1
        sy = -1 if (idx & 2) else +1
        sz = -1 if (idx & 1) else +1
        np.testing.assert_array_equal(
            got[idx], brute_force_chebyshev(occ, (sx, sy, sz)),
            err_msg=f"octant {idx}")


def test_anisotropic_cap_semantics(rng):
    """distance.ANISO_CAP: one-sided octant maps hit 255 at axis-facing
    boundaries, defeating max-bounded early exits. The cap must be EXACTLY
    elementwise min(uncapped, cap): leaps stay conservative and the
    occupied set is untouched."""
    occ = _random_occ(rng, (24, 32, 40), 0.004)
    full = np.asarray(anisotropic_distance(jnp.asarray(occ), cap=255))
    capped = np.asarray(anisotropic_distance(jnp.asarray(occ), cap=15))
    assert (full > 15).any()            # the cap actually binds here
    np.testing.assert_array_equal(capped, np.minimum(full, 15))


def test_anisotropic_no_less_than_isotropic(rng):
    # each octant-restricted distance >= full isotropic distance
    occ = _random_occ(rng, (8, 8, 8), 0.1)
    iso = np.asarray(isotropic_distance(jnp.asarray(occ))).astype(int)
    aniso = np.asarray(anisotropic_distance(jnp.asarray(occ))).astype(int)
    assert (aniso >= iso[None]).all()
    # min over octants == isotropic
    np.testing.assert_array_equal(aniso.min(axis=0), iso)


def test_leap_safety_property(rng):
    """D[p] > 0 ⇒ no occupied cell strictly inside the Chebyshev ball of
    radius D[p] — the invariant that makes ESS leaps safe
    (distance_map.comp:28-34)."""
    occ = _random_occ(rng, (9, 9, 9), 0.08)
    D = np.asarray(isotropic_distance(jnp.asarray(occ))).astype(int)
    occ_cells = np.argwhere(occ == 0)
    for z in range(9):
        for y in range(9):
            for x in range(9):
                d = D[z, y, x]
                if d > 0 and len(occ_cells):
                    cheb = np.max(np.abs(occ_cells - [z, y, x]), axis=1)
                    assert cheb.min() >= d
