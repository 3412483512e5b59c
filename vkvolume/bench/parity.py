"""Correctness of the frame and map paths on the GPU, with stated bars.

Three comparisons, shared by ``chip_smoke.py`` and the ``gpu``-marked test:

* **marcher, GPU vs CPU.** The reference-exact marcher (the parity oracle,
  tested against the scalar fragment-shader model on the CPU) renders the
  same frame on both devices. The algorithm is the same in float32, but a
  leap or an ERT decision at an exact boundary can flip with the order of
  float operations, so the bar is ``DEVICE_BAR``: at most 0.1 % of covered
  pixels differ by more than 2/255.
* **sweep vs marcher, both on the GPU.** The plane sweep samples on slab
  planes rather than uniformly along each ray, so the bar is the repo's
  resampling bar ``RENDERER_BAR``: at most 1 % of covered pixels differ by
  more than 8/255.
* **distance transforms, GPU vs CPU.** Integer min-plus scans: bit-equal.
"""

from __future__ import annotations

import jax
import numpy as np

from ..accel import anisotropic_distance, isotropic_distance, occupancy_map
from ..options import SkippingType, Test
from .datasets import DATASETS, synthesize
from .harness import benchmark_camera, make_engine

# (channel threshold, largest admitted share of covered pixels)
DEVICE_BAR = (2.0 / 255.0, 0.001)
RENDERER_BAR = (8.0 / 255.0, 0.01)


def share_over(got: np.ndarray, ref: np.ndarray, threshold: float) -> float:
    """Share of covered pixels (alpha > 1/255 in either RGBA image) whose
    largest channel difference exceeds ``threshold``."""
    covered = (ref[..., 3] > 1 / 255) | (got[..., 3] > 1 / 255)
    bad = (np.abs(got - ref).max(-1) > threshold) & covered
    return float(bad.sum()) / max(int(covered.sum()), 1)


def _frame(engine, camera, width, height) -> np.ndarray:
    return np.asarray(engine.render(camera, width, height).color)


def marcher_device_parity(gpu, cpu, *, seed: int, scale: float, width: int,
                          height: int, skipmodes=(2, 3)) -> dict:
    """Share of covered pixels over ``DEVICE_BAR`` between the marcher on
    ``gpu`` and on ``cpu``, per skip mode, on the beetle stand-in."""
    vol = synthesize(DATASETS["beetle"], seed=seed, scale=scale)
    cam = benchmark_camera(aspect=width / height)
    shares = {}
    for sm in skipmodes:
        images = []
        for dev in (gpu, cpu):
            with jax.default_device(dev):
                eng, _, _, _ = make_engine(
                    "beetle", sm, 4, scale=scale, seed=seed, volume_u8=vol,
                    renderer="marcher", benchmark_mode=False,
                    test=Test.NONE, ert=True)
                images.append(_frame(eng, cam, width, height))
        shares[sm] = share_over(images[0], images[1], DEVICE_BAR[0])
    return shares


def renderer_parity(engine, camera, width: int, height: int) -> float:
    """Share of covered pixels over ``RENDERER_BAR`` between the sweep and
    the marcher, both through ``engine`` on its device."""
    prev = engine.renderer
    try:
        engine.renderer = "sweep"
        got = _frame(engine, camera, width, height)
        engine.renderer = "marcher"
        ref = _frame(engine, camera, width, height)
    finally:
        engine.renderer = prev
    return share_over(got, ref, RENDERER_BAR[0])


def dt_device_parity(volume, gpu, cpu) -> bool:
    """Whether the isotropic and anisotropic distance transforms of the
    volume's occupancy map are bit-equal on ``gpu`` and ``cpu``."""
    from ..tf import tf_params

    o = volume.options
    tf = tf_params(intensity_min=o.intensity_min,
                   intensity_max=o.intensity_max,
                   gradient_min=o.gradient_min, gradient_max=o.gradient_max)
    occ = occupancy_map(volume.density, volume.gradient, tf,
                        volume.map_shape_zyx)
    maps = []
    for dev in (gpu, cpu):
        x = jax.device_put(occ, dev)
        maps.append((np.asarray(isotropic_distance(x)),
                     np.asarray(anisotropic_distance(x))))
    return all(np.array_equal(a, b) for a, b in zip(*maps))


def device_parity(engine, camera, width: int, height: int, *, gpu, cpu,
                  seed: int = 0, ref_scale: float = 0.25,
                  ref_width: int = 480, ref_height: int = 272) -> dict:
    """All three comparisons. ``engine`` holds the volume to check (its
    first) on ``gpu``, rendered at ``camera``/``width``×``height`` in skip
    mode 3; the device comparison of the marcher runs on a fresh beetle
    stand-in at ``ref_scale``. ``ok`` says whether every bar held."""
    if engine.options.skipping_type != SkippingType.ANISOTROPIC_DISTANCE:
        raise ValueError("renderer parity is defined for skip mode 3")
    dev_shares = marcher_device_parity(
        gpu, cpu, seed=seed, scale=ref_scale, width=ref_width,
        height=ref_height)
    ren_share = renderer_parity(engine, camera, width, height)
    dt_equal = dt_device_parity(engine.volumes[0], gpu, cpu)
    ok = (all(s <= DEVICE_BAR[1] for s in dev_shares.values())
          and ren_share <= RENDERER_BAR[1] and dt_equal)
    return {
        "marcher_gpu_vs_cpu_share_gt_2_255": {
            f"skipmode{k}": v for k, v in dev_shares.items()},
        "marcher_bar": DEVICE_BAR[1],
        "sweep_vs_marcher_share_gt_8_255": ren_share,
        "renderer_bar": RENDERER_BAR[1],
        "dt_gpu_cpu_bit_equal": dt_equal,
        "ok": ok,
    }
