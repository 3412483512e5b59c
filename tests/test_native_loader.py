"""Native C++ loader parity vs the numpy path (skipped when not built)."""

import numpy as np
import pytest

from vkvolume.io import Header, save_volume
from vkvolume.io import native
from vkvolume.io.loader import normalise_to_u8

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native loader not built (make -C native)"
)


@pytest.mark.parametrize("dtype", ["uint8_t", "int8_t", "uint16_t", "int16_t"])
@pytest.mark.parametrize("endianness", ["little", "big"])
def test_native_matches_numpy(tmp_path, rng, dtype, endianness):
    h = Header(
        extent=(33, 17, 9),
        voxel_size=(1, 1, 1),
        normalisation_range=(-50.0, 900.0),
        dtype=dtype,
        endianness=endianness,
        rotation_axis=(0, 0, 1),
        rotation_angle_deg=0.0,
    )
    info = np.iinfo(np.dtype(dtype.rstrip("_t").replace("_", "")))
    raw = rng.integers(info.min, info.max, size=h.shape_zyx)
    path = tmp_path / "v.raw"
    save_volume(path, raw, h)

    out = native.load_normalised(path, h)
    assert out is not None
    expected = normalise_to_u8(raw.astype(np.float32), *h.normalisation_range)
    np.testing.assert_array_equal(out.reshape(h.shape_zyx), expected)
