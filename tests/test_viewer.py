"""Interactive viewer (vkvolume/viewer.py): the reference's GUI loop
(slider edit → map rebuild → re-render) served over HTTP. Drives the real
server end-to-end: page, frame fetches with TF edits, stats endpoint."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from vkvolume.engine import Engine, RenderOptions, SkippingType, \
    VolumeOptions, from_array
from vkvolume.viewer import ViewerServer

from util import sphere_shell_volume


@pytest.fixture(scope="module")
def viewer():
    vol_u8 = sphere_shell_volume(40)
    eng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                 renderer="sweep")
    vol = from_array(vol_u8, VolumeOptions(intensity_min=0.1,
                                           gradient_max=0.0),
                     block_size=4)
    vol.set_scale((100.0 / 40,) * 3)
    eng.add_volume(vol)
    srv = ViewerServer(eng, vol, 64, 64, port=0)
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()


def _get(srv, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}{path}", timeout=120) as r:
        return r.read(), dict(r.headers)


def test_page_serves_sliders(viewer):
    body, hdrs = _get(viewer, "/")
    assert b"imin" in body and b"/frame.png" in body
    assert "text/html" in hdrs["Content-Type"]


def test_frame_renders_and_tf_edit_rebuilds(viewer):
    png1, h1 = _get(viewer, "/frame.png?imin=0.1")
    assert png1[:8] == b"\x89PNG\r\n\x1a\n"
    # Same TF again: dirty-tracking must SKIP the rebuild.
    png1b, h1b = _get(viewer, "/frame.png?imin=0.1")
    assert float(h1b["X-Update-Ms"]) == 0.0
    # TF edit: rebuild runs and the image actually changes.
    png2, h2 = _get(viewer, "/frame.png?imin=0.35")
    assert float(h2["X-Update-Ms"]) > 0.0
    assert png2 != png1
    assert h2["X-Renderer"] == "sweep"


def test_camera_slider_changes_frame(viewer):
    png1, _ = _get(viewer, "/frame.png?azimuth=30")
    png2, _ = _get(viewer, "/frame.png?azimuth=75")
    assert png2 != png1


def test_stats_endpoint(viewer):
    _get(viewer, "/frame.png?imin=0.12")
    body, _ = _get(viewer, "/stats")
    st = json.loads(body)
    assert st["frames"] >= 1 and st["renderer"] == "sweep"
    assert st["render_ms"] > 0


def test_scene_toggle_changes_frame(viewer):
    """scene=1 routes through the forward mesh pass (the reference GUI's
    render-sponza checkbox): the frame gains the hall background."""
    import io

    from PIL import Image

    plain, _ = _get(viewer, "/frame.png?azimuth=30&elevation=20")
    scene, _ = _get(viewer, "/frame.png?azimuth=30&elevation=20&scene=1")
    a = np.asarray(Image.open(io.BytesIO(plain)))
    b = np.asarray(Image.open(io.BytesIO(scene)))
    # The hall fills the previously-black background.
    assert (a.reshape(-1, 3).max(1) == 0).mean() > 0.2
    assert (b.reshape(-1, 3).max(1) == 0).mean() < 0.02


def test_translation_slider_moves_volume(viewer):
    """tx drag = the reference GUI's per-volume XYZ translation
    (src/volume_render.cpp:464-468): the rendered blob must move along
    screen-x, and resetting must restore the original frame (pose cache
    keys on model_matrix, so stale ray setups would fail this)."""
    import io

    from PIL import Image

    def centroid_x(png):
        a = np.asarray(Image.open(io.BytesIO(png))).reshape(-1, 3)
        w = np.asarray(Image.open(io.BytesIO(png))).shape[1]
        lum = a.max(1).astype(np.float64).reshape(-1, w)
        xs = np.arange(w, dtype=np.float64)
        tot = lum.sum()
        assert tot > 0
        return float((lum * xs[None, :]).sum() / tot)

    base, _ = _get(viewer, "/frame.png?azimuth=0&elevation=0&tx=0")
    moved, _ = _get(viewer, "/frame.png?azimuth=0&elevation=0&tx=30")
    # az=0 looks down a horizontal axis; +x world maps to screen x.
    assert abs(centroid_x(moved) - centroid_x(base)) > 2.0
    back, _ = _get(viewer, "/frame.png?azimuth=0&elevation=0&tx=0")
    assert back == base


def test_set_translation_preserves_scale_and_spin_base():
    vol = from_array(sphere_shell_volume(16),
                     VolumeOptions(intensity_min=0.1), block_size=4)
    vol.set_scale((2.0, 2.0, 2.0))
    vol.set_translation((5.0, -2.0, 1.0))
    # Rotation/scale block untouched; translation replaced.
    assert np.allclose(vol.get_translation(), (5.0, -2.0, 1.0))
    assert np.allclose(np.asarray(vol.node_transform)[:3, :3],
                       np.diag([2.0, 2.0, 2.0]))
    # A spinning volume keeps its (new) position: the captured spin base
    # is retargeted by set_translation.
    vol.set_spin(0.3)
    vol.set_translation((1.0, 2.0, 3.0))
    assert np.allclose(np.asarray(vol._spin_base)[:3, 3], (1.0, 2.0, 3.0))


def test_option_controls_route_through_engine(viewer):
    """The remaining reference GUI controls (volume_render.cpp:447-547):
    sampling slider triggers the TF-update path, the ESS radio rebuilds
    maps WITHOUT changing the image (skipping is exact), the Test radio
    swaps in the diagnostic image, spin advances the node rotation."""
    eng = viewer.engine

    base, _ = _get(viewer, "/frame.png?azimuth=20&elevation=10")
    # Sampling edit → update_transfer_function (rebuild timed > 0).
    samp, h = _get(viewer, "/frame.png?azimuth=20&elevation=10&sampling=2")
    assert float(h["X-Update-Ms"]) > 0.0
    assert samp != base
    assert eng.volumes[0].options.sampling_factor == 2.0
    # Restore (module-scoped fixture).
    _get(viewer, "/frame.png?azimuth=20&elevation=10&sampling=1")

    # ESS radio: maps rebuild, image stays (ESS is exact).
    off, h_off = _get(viewer, "/frame.png?azimuth=20&elevation=10&skipmode=0")
    assert float(h_off["X-Update-Ms"]) > 0.0
    assert int(eng.options.skipping_type) == 0
    import io

    from PIL import Image

    a = np.asarray(Image.open(io.BytesIO(base))).astype(np.int16)
    b = np.asarray(Image.open(io.BytesIO(off))).astype(np.int16)
    assert np.abs(a - b).max() <= 1
    _get(viewer, "/frame.png?azimuth=20&elevation=10&skipmode=2")
    assert int(eng.options.skipping_type) == 2

    # Test radio: diagnostic image differs; back to none restores.
    ent, _ = _get(viewer, "/frame.png?azimuth=20&elevation=10&test=1")
    assert ent != base
    back, _ = _get(viewer, "/frame.png?azimuth=20&elevation=10&test=0")
    assert back == base

    # Spin: angle advances the node rotation through the same path.
    spun, _ = _get(viewer,
                   "/frame.png?azimuth=20&elevation=10&spinangle=45")
    assert spun != base
    _get(viewer, "/frame.png?azimuth=20&elevation=10&spinangle=0")


def test_multi_volume_sections():
    """Two volumes: the page gains a volume selector, /voldefaults serves
    per-volume state, and a TF/translation edit with vol=1 touches ONLY
    volume 1 (reference GUI: one section per volume)."""
    import json as _json

    eng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                 renderer="sweep")
    vols = []
    for i in range(2):
        v = from_array(sphere_shell_volume(24),
                       VolumeOptions(intensity_min=0.1, gradient_max=0.0),
                       block_size=4, name=f"v{i}")
        v.set_scale((100.0 / 24,) * 3)
        eng.add_volume(v)
        vols.append(v)
    srv = ViewerServer(eng, vols[0], 48, 48, port=0)
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    try:
        page, _ = _get(srv, "/")
        assert b"NVOL = 2" in page and b"/voldefaults" in page
        d1, _ = _get(srv, "/voldefaults?vol=1")
        assert _json.loads(d1)["imin"] == 0.1
        v0_maps = vols[0]._maps_version if hasattr(
            vols[0], "_maps_version") else 0
        _get(srv, "/frame.png?vol=1&imin=0.3&tx=12")
        assert vols[1].options.intensity_min == 0.3
        assert vols[0].options.intensity_min == 0.1
        assert np.allclose(vols[1].get_translation()[0], 12.0)
        assert np.allclose(vols[0].get_translation()[0], 0.0)
        assert getattr(vols[0], "_maps_version", 0) == v0_maps
        d1b, _ = _get(srv, "/voldefaults?vol=1")
        assert _json.loads(d1b)["imin"] == 0.3
    finally:
        srv.shutdown()


def test_spin_tracked_per_volume():
    """Spin angle is tracked per volume: a selector switch neither leaks
    vol0's angle onto vol1 nor resets vol0's rotation, and /voldefaults
    reports it so the page restores slider state."""
    import json as _json

    eng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                 renderer="sweep")
    vols = []
    for i in range(2):
        v = from_array(sphere_shell_volume(16),
                       VolumeOptions(intensity_min=0.1, gradient_max=0.0),
                       block_size=4, name=f"v{i}")
        v.set_scale((100.0 / 16,) * 3)
        eng.add_volume(v)
        vols.append(v)
    srv = ViewerServer(eng, vols[0], 48, 48, port=0)
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    try:
        _get(srv, "/frame.png?vol=0&spinangle=45")
        nt1_before = np.asarray(vols[1].node_transform).copy()
        # vol1 frame with ITS OWN defaults (spinangle=0) must not rotate it,
        # and must not reset vol0.
        d1 = _json.loads(_get(srv, "/voldefaults?vol=1")[0])
        assert d1["spinangle"] == 0.0
        _get(srv, "/frame.png?vol=1&spinangle=0")
        assert np.allclose(np.asarray(vols[1].node_transform), nt1_before)
        d0 = _json.loads(_get(srv, "/voldefaults?vol=0")[0])
        assert d0["spinangle"] == 45.0
    finally:
        srv.shutdown()
