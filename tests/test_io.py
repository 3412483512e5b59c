"""Loader round-trip tests for all dtypes × endiannesses
(SURVEY.md §4; reference behaviour: src/load_volume.cpp:88-172)."""

import numpy as np
import pytest

from vkvolume.io import Header, load_data, load_header, parse_header, save_volume
from vkvolume.io.loader import normalise_to_u8

HEADER_TEXT = """832 832 494 # extents
0.001 0.001 0.001 # voxel size
400.0 2538.0 # normalisation range
uint16_t little # data type and endianness (big or little)
1 0 0 90 # rotation axis and angle (degrees)
"""


def test_parse_reference_example():
    h = parse_header(HEADER_TEXT)
    assert h.extent == (832, 832, 494)
    assert h.voxel_size == (0.001, 0.001, 0.001)
    assert h.normalisation_range == (400.0, 2538.0)
    assert h.dtype == "uint16_t" and h.endianness == "little"
    assert h.rotation_axis == (1.0, 0.0, 0.0)
    assert h.rotation_angle_deg == 90.0
    assert h.shape_zyx == (494, 832, 832)


def test_image_transform_matches_glm():
    h = parse_header(HEADER_TEXT)
    m = h.image_transform
    # rotate(90deg, x) @ scale(0.832, 0.832, 0.494)
    np.testing.assert_allclose(m[0, 0], 0.832, atol=1e-6)
    # y axis maps to z after 90° about x.
    np.testing.assert_allclose(m[2, 1], 0.832, atol=1e-6)
    np.testing.assert_allclose(m[1, 2], -0.494, atol=1e-6)


@pytest.mark.parametrize("dtype", ["uint8_t", "int8_t", "uint16_t", "int16_t"])
@pytest.mark.parametrize("endianness", ["little", "big"])
def test_roundtrip_all_dtypes(tmp_path, rng, dtype, endianness):
    extent = (7, 5, 3)
    h = Header(
        extent=extent,
        voxel_size=(1.0, 1.0, 1.0),
        normalisation_range=(0.0, 100.0),
        dtype=dtype,
        endianness=endianness,
        rotation_axis=(0.0, 0.0, 1.0),
        rotation_angle_deg=0.0,
    )
    lo, hi = {"uint8_t": (0, 127), "int8_t": (-100, 100),
              "uint16_t": (0, 30000), "int16_t": (-3000, 3000)}[dtype]
    raw = rng.integers(lo, hi, size=h.shape_zyx)
    path = tmp_path / "vol.raw"
    save_volume(path, raw, h)

    hdr = load_header(str(path) + ".header")
    assert hdr == h
    data = load_data(path, hdr)
    assert data.shape == h.shape_zyx and data.dtype == np.uint8
    expected = normalise_to_u8(raw.astype(np.float32), 0.0, 100.0)
    np.testing.assert_array_equal(data, expected)


def test_normalise_truncates_like_cpp():
    # static_cast<uint8_t>(255 * t) truncates: t=0.5 → 127 (not 128).
    v = np.array([50.0], np.float32)
    assert normalise_to_u8(v, 0.0, 100.0)[0] == 127
    assert normalise_to_u8(np.array([100.0]), 0.0, 100.0)[0] == 255
    assert normalise_to_u8(np.array([-10.0]), 0.0, 100.0)[0] == 0
    assert normalise_to_u8(np.array([1e9]), 0.0, 100.0)[0] == 255


def test_file_size_mismatch_raises(tmp_path):
    h = Header(
        extent=(4, 4, 4),
        voxel_size=(1, 1, 1),
        normalisation_range=(0, 255),
        dtype="uint8_t",
        endianness="little",
        rotation_axis=(0, 0, 1),
        rotation_angle_deg=0.0,
    )
    path = tmp_path / "bad.raw"
    path.write_bytes(b"\x00" * 63)
    with pytest.raises(ValueError, match="File size does not match"):
        load_data(path, h)


def test_unsupported_dtype_rejected():
    bad = HEADER_TEXT.replace("uint16_t", "float32_t")
    with pytest.raises(ValueError, match="unsupported image data type"):
        parse_header(bad)
