"""Chebyshev distance transform — isotropic and anisotropic (8-octant).

Exact JAX re-derivation of the reference's GPU 3-pass Saito–Toriwaki
transform modified for the Chebyshev metric
(``shaders/distance_map.comp:44-109``, ``shaders/distance_map_anisotropic.comp``,
host schedule ``src/compute_distance_map.cpp:142-290``):

* **Stage 0** (per x-line, forward + backward ``g = min(g_prev + 1, occ)``)
  has the closed form ``g[x] = min_{x'} (occ[x'] + |x - x'|)`` — two
  ``lax.cummin`` scans (``(occ - x')`` prefix-min plus ``(occ + x')``
  suffix-min). Proof: unrolling the recurrences gives exactly those minima,
  and since every min includes the ``x' = x`` term with ``occ <= 255`` the
  uint8 saturation of the sequential version never binds.
* **Stages 1/2** (per y/z-line, zig-zag ``D' = min_n max(n, D[y ± n])`` with
  early exit) are computed as a vectorised relaxation over the shift
  distance ``n``: every cell of the whole 3-D map is updated in lock-step
  for n = 1, 2, ... with a global early exit once ``n >= max(D')`` (no cell
  can improve further — the same bound the per-line ``n < D`` exit uses, so
  results are identical). Cost is O(max_distance × cells) on the VPU, which
  mirrors the reference's effective work.

The anisotropic variant reproduces the 14-pass shared schedule
(src/compute_distance_map.cpp:229-252): 2 directional x-scans, 4 directional
y-relaxations, 8 directional z-relaxations; here the sharing is expressed as
a functional DAG (dict-cached intermediates) and XLA CSE keeps it a DAG.

Occupancy convention: OCCUPIED = 0, EMPTY = 255 (occupancy_map.comp:42-43).
Distance semantics: D[p] = Chebyshev distance from cell p to the nearest
occupied cell (0 at occupied cells), capped at 255; the anisotropic maps
restrict the search to the ray-direction octant.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_I = jnp.int16

# Value cap for the ANISOTROPIC octant maps. One-sided octant distances hit
# 255 at every axis-facing boundary (no occupied cell beyond), so a
# relaxation loop bounded by the brick/array max never early-exits — the
# reference's per-CELL running-min exit (distance_map_anisotropic.comp:66-80)
# makes its work ∝ mean distance, while a max-bounded vectorised loop pays
# the full axis length on every launch (snake b=4 aniso update measured
# 3.3× iso vs the reference's 1.7×). Capping the stage outputs bounds every
# relaxation at the cap. Safe: a capped value is ≤ the true octant distance
# (min/max stages are monotone), so ESS leaps stay conservative and images
# are bit-identical; only leap LENGTH through >cap-deep empty space shrinks
# (63 map cells = 252 voxels at the default block size — beyond any
# practical skip window). 255 restores reference-exact map values.
ANISO_CAP = 63


def _iota_along(shape, axis, dtype=_I):
    return jax.lax.broadcasted_iota(dtype, shape, axis)


def axis_scan(occ: jax.Array, axis: int, direction: int = 0) -> jax.Array:
    """1-D distance scan along ``axis``.

    direction=0: two-sided (distance_map.comp:57-71):
        g[x] = min_{x'} (occ[x'] + |x - x'|)
    direction=+1: one-sided forward (distance_map_anisotropic.comp:44-53, dir=+1):
        g[x] = min_{x' >= x} (occ[x'] + (x' - x))
    direction=-1: one-sided backward:
        g[x] = min_{x' <= x} (occ[x'] + (x - x'))
    Input/output int16 (values in [0, 255]).
    """
    occ = occ.astype(_I)
    idx = _iota_along(occ.shape, axis)
    if direction >= 0:
        suff = jnp.flip(
            jax.lax.cummin(jnp.flip(occ + idx, axis=axis), axis=axis), axis=axis
        )
        fwd_looking = suff - idx
        if direction > 0:
            return fwd_looking
    if direction <= 0:
        pref = jax.lax.cummin(occ - idx, axis=axis)
        bwd_looking = pref + idx
        if direction < 0:
            return bwd_looking
    return jnp.minimum(fwd_looking, bwd_looking)


def relax(D: jax.Array, axis: int, direction: int = 0) -> jax.Array:
    """Zig-zag relaxation along ``axis``:

        A[y] = min_n max(n, D[y + n]) / D[y - n] / both   (n >= 0, in-bounds)

    two-sided for direction=0 (distance_map.comp:72-107), one-sided otherwise
    (distance_map_anisotropic.comp:55-91). Exact: the per-line ``n < D`` /
    ``n < m_min`` early exits in the reference only skip candidates that
    cannot win (max(n, ·) >= n >= current minimum), as does our global
    ``n < max(A)`` exit; out-of-bounds candidates padded with 255 can at most
    tie the n=0 candidate ``D[y] <= 255``.
    """
    D = D.astype(_I)
    L = D.shape[axis]
    pad_widths = [(0, 0)] * D.ndim
    if direction == 0:
        pad_widths[axis] = (L, L)
    elif direction > 0:
        pad_widths[axis] = (0, L)
    else:
        pad_widths[axis] = (L, 0)
    padded = jnp.pad(D, pad_widths, constant_values=_I(255))

    # Process CHUNK shift distances per while-loop iteration: the loop is
    # loop-overhead-bound per iteration, and the early-exit bound (no cell can
    # improve once n >= max(A)) only needs to be re-evaluated per chunk.
    CHUNK = 32

    def cond(state):
        n, A = state
        return jnp.logical_and(n < L, n < jnp.max(A).astype(jnp.int32))

    def body(state):
        n, A = state
        for j in range(CHUNK):
            nj = n + j
            # Guard: shifts past L would read clamped (wrong) slices; mask
            # them to the neutral 255 candidate.
            nj_safe = jnp.minimum(nj, L - 1)
            nn = nj.astype(_I)
            cands = []
            if direction >= 0:
                cands.append(
                    _shift_dir(padded, axis, +1, nj_safe, L,
                               two_sided=(direction == 0)))
            if direction <= 0:
                cands.append(
                    _shift_dir(padded, axis, -1, nj_safe, L,
                               two_sided=(direction == 0)))
            for c in cands:
                c = jnp.where(nj < L, c, _I(255))
                A = jnp.minimum(A, jnp.maximum(nn, c))
        return n + CHUNK, A

    # n = 0 candidate is D itself. Shift distances beyond the valid range
    # only produce 255-padding candidates, which never win (<= ties).
    A0 = D
    if L <= CHUNK:
        n = jnp.int32(1)
        A = A0
        for j in range(1, L):
            nn = jnp.int32(j).astype(_I)
            if direction >= 0:
                A = jnp.minimum(A, jnp.maximum(nn, _shift_dir(
                    padded, axis, +1, jnp.int32(j), L,
                    two_sided=(direction == 0))))
            if direction <= 0:
                A = jnp.minimum(A, jnp.maximum(nn, _shift_dir(
                    padded, axis, -1, jnp.int32(j), L,
                    two_sided=(direction == 0))))
        return A
    _, A = jax.lax.while_loop(cond, body, (jnp.int32(1), A0))
    return A


def _shift_dir(padded, axis, sgn, n, L, two_sided):
    if two_sided:
        # padded has (L, L) pads; element y + sgn*n at padded index y + L + sgn*n.
        start = L + sgn * n
    else:
        start = n if sgn > 0 else L - n
    return jax.lax.dynamic_slice_in_dim(padded, start, L, axis=axis)


@jax.jit
def isotropic_distance(occ_u8: jax.Array) -> jax.Array:
    """Isotropic Chebyshev distance map from a (mz, my, mx) uint8 occupancy.

    Pipeline twin of ``ComputeDistanceMap::computeDistance``
    (src/compute_distance_map.cpp:142-175): x-scan, y-relax, z-relax.
    """
    g = axis_scan(occ_u8, axis=2, direction=0)
    g = relax(g, axis=1, direction=0)
    g = relax(g, axis=0, direction=0)
    return g.astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("cap",))
def anisotropic_distance(occ_u8: jax.Array, cap: int = ANISO_CAP) -> jax.Array:
    """All 8 octant distance maps, stacked as (8, mz, my, mx) uint8.

    Octant index matches the fragment shader's map selection
    (volume_render.frag:209):
        idx = (dz < 0) + 2*(dy < 0) + 4*(dx < 0)
    Map idx gives, at each cell, the Chebyshev distance to the nearest
    occupied cell *within the octant the ray travels* — computed by chaining
    one-sided scans in the ray's axis directions, sharing the x and (x, y)
    intermediates exactly like the reference's 14-dispatch schedule
    (src/compute_distance_map.cpp:229-252 and the octant table comment).

    Values are clipped at ``cap`` after the x-scan, which bounds every
    later relaxation loop at ``cap`` iterations (see ANISO_CAP); pass
    cap=255 for reference-exact values.
    """
    x_scans = {}
    xy = {}
    maps = []
    c = _I(cap)
    for idx in range(8):
        sx = -1 if (idx & 4) else +1
        sy = -1 if (idx & 2) else +1
        sz = -1 if (idx & 1) else +1
        if sx not in x_scans:
            x_scans[sx] = jnp.minimum(
                axis_scan(occ_u8, axis=2, direction=sx), c)
        if (sx, sy) not in xy:
            xy[(sx, sy)] = relax(x_scans[sx], axis=1, direction=sy)
        maps.append(relax(xy[(sx, sy)], axis=0, direction=sz).astype(jnp.uint8))
    return jnp.stack(maps)


def brute_force_chebyshev(occ_u8, direction_xyz=(0, 0, 0)):
    """Reference for tests: per cell, min over occupied cells of the
    Chebyshev distance, restricted to an octant when direction components are
    ±1 (0 = both ways on that axis); 255 when no occupied cell qualifies.

    Computed as the least radius r whose search box (``[p-r, p+r]`` on a
    two-sided axis, ``[p, p+r]`` / ``[p-r, p]`` on a one-sided one) holds an
    occupied cell, with box counts from a 3-D summed-area table: numpy,
    O(cells × largest extent)."""
    import numpy as np

    occ = np.asarray(occ_u8) == 0
    shape = occ.shape
    sat = np.zeros(tuple(n + 1 for n in shape), np.int64)
    sat[1:, 1:, 1:] = occ.cumsum(0).cumsum(1).cumsum(2)
    grid = np.indices(shape)
    sides = (direction_xyz[2], direction_xyz[1], direction_xyz[0])  # z, y, x
    out = np.full(shape, 255, np.uint8)
    todo = np.ones(shape, bool)
    for r in range(min(max(shape), 255)):
        lo, hi = [], []
        for g, n, s in zip(grid, shape, sides):
            lo.append(np.clip(g - (0 if s > 0 else r), 0, n))
            hi.append(np.clip(g + (0 if s < 0 else r) + 1, 0, n))
        (z0, y0, x0), (z1, y1, x1) = lo, hi
        count = (sat[z1, y1, x1] - sat[z0, y1, x1] - sat[z1, y0, x1]
                 - sat[z1, y1, x0] + sat[z0, y0, x1] + sat[z0, y1, x0]
                 + sat[z1, y0, x0] - sat[z0, y0, x0])
        hit = todo & (count > 0)
        out[hit] = r
        todo &= ~hit
        if not todo.any():
            break
    return out
