"""The device a measurement runs on (vkvolume/bench/device.py), and the
GPU-only correctness checks (vkvolume/bench/parity.py).

Tests marked ``gpu`` need an NVIDIA GPU as JAX's default device. Whether
one is present is decided inside the ``gpu`` fixture, never at import
time, so every test process collects the same tests. On the card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import jax
import numpy as np
import pytest

from vkvolume.bench.device import describe, require_gpu
from vkvolume.bench.parity import DEVICE_BAR, RENDERER_BAR, share_over


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default device is "
                    f"{dev.platform}")
    return dev


@pytest.fixture
def cpu_default(monkeypatch):
    """JAX's device list as a machine without a card reports it."""
    cpu = jax.devices("cpu")
    monkeypatch.setattr(jax, "devices", lambda *backend: cpu)
    return cpu[0]


def test_require_gpu_refuses_cpu(cpu_default):
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        require_gpu()


def test_require_gpu_rehearsal_admits_cpu(cpu_default):
    dev = require_gpu(allow_cpu=True)
    assert dev is cpu_default
    assert describe(dev) == {"platform": "cpu", "kind": dev.device_kind,
                             "count": len(jax.devices())}


def test_share_over_counts_covered_pixels_only():
    ref = np.zeros((2, 2, 4), np.float32)
    got = ref.copy()
    ref[0, 0] = (0.5, 0.5, 0.5, 0.5)       # covered, equal
    got[0, 0] = ref[0, 0]
    got[0, 1] = (0.2, 0.0, 0.0, 0.2)       # covered in got only, differs
    got[1, 1, :3] = 0.3                    # uncovered colour: ignored
    assert share_over(got, ref, RENDERER_BAR[0]) == 0.5
    assert share_over(ref, ref, DEVICE_BAR[0]) == 0.0


@pytest.mark.gpu
def test_device_parity_on_gpu(gpu):
    """The chip smoke's parity phase at a reduced size: the marcher on the
    GPU against the CPU, the sweep against the marcher, the distance
    transforms GPU against CPU."""
    from vkvolume.bench.harness import benchmark_camera, make_engine
    from vkvolume.bench.parity import device_parity
    from vkvolume.options import Test

    width, height = 480, 272
    eng, _, _, _ = make_engine("beetle", 3, 4, scale=0.25, seed=0,
                               renderer="marcher", benchmark_mode=False,
                               test=Test.NONE, ert=True)
    cam = benchmark_camera(aspect=width / height)
    result = device_parity(eng, cam, width, height, gpu=gpu,
                           cpu=jax.devices("cpu")[0], seed=0,
                           ref_scale=0.25, ref_width=width,
                           ref_height=height)
    assert result["ok"], result
