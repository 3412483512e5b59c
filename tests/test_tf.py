"""Transfer-function tests: closed-form vs baked-texture equivalence
(SURVEY.md §4; reference: transfer_function.glsl:35-46 vs
volume_component.cpp:246-261)."""

import jax.numpy as jnp
import numpy as np
import pytest

from vkvolume.tf import bake_texture, get_alpha, sample_texture, tf_params


def test_closed_form_basic():
    tf = tf_params(intensity_min=0.2, intensity_max=0.8, gradient_min=0.0,
                   gradient_max=0.0)
    assert not tf.use_gradient
    a = get_alpha(tf, jnp.asarray([0.0, 0.2, 0.5, 0.8, 1.0]), jnp.asarray(1.0))
    np.testing.assert_allclose(a, [0.0, 0.0, 0.5, 1.0, 1.0], atol=1e-6)


def test_gradient_modulation():
    tf = tf_params(intensity_min=0.0, intensity_max=1.0, gradient_min=0.1,
                   gradient_max=0.3)
    assert tf.use_gradient
    a = get_alpha(tf, jnp.asarray(0.5), jnp.asarray(0.2))
    np.testing.assert_allclose(a, 0.5 * 0.5, atol=1e-6)
    # gradient below gmin → zero alpha
    a = get_alpha(tf, jnp.asarray(0.5), jnp.asarray(0.05))
    np.testing.assert_allclose(a, 0.0, atol=1e-6)


@pytest.mark.parametrize(
    "imin,imax,gmin,gmax",
    [(0.1, 1.0, 0.0, 0.0), (0.086, 1.0, 0.1, 0.3), (0.4, 0.8, 0.0, 0.0),
     (0.2, 0.8, 0.06, 0.12)],
)
def test_bake_matches_closed_form_at_grid(imin, imax, gmin, gmax):
    """At texel centres i/255, g/255 the baked u8 alpha equals the truncated
    closed-form alpha (reference bake loop volume_component.cpp:254-261)."""
    tex = bake_texture(intensity_min=imin, intensity_max=imax,
                       gradient_min=gmin, gradient_max=gmax)
    assert tex.shape == (256, 256, 4) and tex.dtype == np.uint8
    assert (tex[..., 0] == tex[..., 3]).all()  # u8vec4(alpha)

    tf = tf_params(intensity_min=imin, intensity_max=imax, gradient_min=gmin,
                   gradient_max=gmax)
    ii = np.arange(256) / 255.0
    gg = np.arange(256) / 255.0
    a = np.asarray(get_alpha(tf, jnp.asarray(ii)[None, :], jnp.asarray(gg)[:, None]))
    if not tf.use_gradient:
        a = np.broadcast_to(a, (256, 256))
    expected = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    # truncation boundary effects: allow 1 LSB
    assert np.abs(tex[..., 3].astype(int) - expected.astype(int)).max() <= 1


def test_sample_texture_nearest():
    tex = bake_texture(intensity_min=0.0, intensity_max=1.0, gradient_min=0.0,
                       gradient_max=0.0)
    # intensity 0.5 → texel floor(0.5*256)=128 → alpha 128/255
    rgba = sample_texture(jnp.asarray(tex), jnp.asarray(0.5), jnp.asarray(0.0))
    np.testing.assert_allclose(rgba[3], 128 / 255.0, atol=1e-6)
    # clamp to edge at 1.0
    rgba = sample_texture(jnp.asarray(tex), jnp.asarray(1.0), jnp.asarray(0.0))
    np.testing.assert_allclose(rgba[3], 1.0, atol=1e-6)


def test_use_gradient_flag_matches_reference_rule():
    # use_gradient = gradient_max != gradient_min (volume_component.cpp:232)
    assert tf_params(gradient_min=0.0, gradient_max=0.2).use_gradient
    assert not tf_params(gradient_min=0.2, gradient_max=0.2).use_gradient
