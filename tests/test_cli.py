"""CLI surface (vkvolume/cli.py): the reference's volume_render
command line (src/volume_render.cpp:95 usage string) driven end-to-end —
including MULTIPLE positional volume files, which composite in draw order
(`<binary_volume_image>...`, loaded one node each at :186-242)."""

import numpy as np
import pytest

from vkvolume.cli import build_parser, main, setup_engine
from vkvolume.io import Header, save_volume

from util import sphere_shell_volume


def _write_volume(tmp_path, name, data):
    d, h, w = data.shape
    hdr = Header(extent=(w, h, d), voxel_size=(0.001,) * 3,
                 normalisation_range=(0.0, 255.0),
                 dtype="uint8_t", endianness="little",
                 rotation_axis=(1.0, 0.0, 0.0), rotation_angle_deg=0.0)
    path = tmp_path / name
    save_volume(path, data, hdr)
    return str(path)


def test_single_volume_render_to_png(tmp_path, capsys):
    vol = sphere_shell_volume(24)
    p = _write_volume(tmp_path, "a.raw", vol)
    out = tmp_path / "out.png"
    assert main([p, "--width", "64", "--height", "48", "--renderer",
                 "sweep", "--output", str(out)]) == 0
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape[:2] == (48, 64) and img.max() > 0
    logs = capsys.readouterr().out
    assert "Updated occupancy/distance map in" in logs


def test_multiple_volumes_composite(tmp_path, capsys):
    """Two overlapping volumes load per-volume (two map-update log lines,
    reference :186-242) and the composite covers at least the single
    volume's footprint."""
    a = sphere_shell_volume(24)
    b = np.zeros_like(a)
    b[4:12, 4:12, 4:12] = 200                        # small bright cube
    pa = _write_volume(tmp_path, "a.raw", a)
    pb = _write_volume(tmp_path, "b.raw", b)
    out2 = tmp_path / "two.png"
    assert main([pa, pb, "--width", "64", "--height", "48",
                 "--renderer", "sweep", "--output", str(out2)]) == 0
    logs = capsys.readouterr().out
    assert logs.count("Updated occupancy/distance map in") == 2
    out1 = tmp_path / "one.png"
    main([pa, "--width", "64", "--height", "48",
          "--renderer", "sweep", "--output", str(out1)])
    from PIL import Image

    two = np.asarray(Image.open(out2)).astype(np.int32)
    one = np.asarray(Image.open(out1)).astype(np.int32)
    assert (two.max(-1) > 0).sum() >= (one.max(-1) > 0).sum()
    assert (two != one).any()                        # volume b contributes


def test_setup_engine_per_volume_options(tmp_path):
    """Each volume gets its own options instance — a GUI TF edit on one
    volume must not alias the others (reference: per-volume options,
    src/volume_render.cpp:190-195)."""
    vol = sphere_shell_volume(16)
    pa = _write_volume(tmp_path, "a.raw", vol)
    pb = _write_volume(tmp_path, "b.raw", vol)
    args = build_parser().parse_args([pa, pb])
    _, volumes = setup_engine(args)
    assert len(volumes) == 2
    volumes[0].options.intensity_min = 0.5
    assert volumes[1].options.intensity_min != 0.5


@pytest.mark.parametrize("renderer", ["pallas", "xla"])
def test_unknown_renderer_refused(renderer, capsys):
    """Only the renderers the engine has are accepted; argparse exits with
    its usage error before anything is loaded."""
    with pytest.raises(SystemExit) as exc:
        build_parser().parse_args(["--renderer", renderer])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_default_renderer_is_the_engines():
    from vkvolume.engine.engine import DEFAULT_RENDERER, RENDERERS

    assert build_parser().parse_args([]).renderer == DEFAULT_RENDERER
    assert DEFAULT_RENDERER in RENDERERS
