"""Spectral film and pixel sensor.

TPU-native analog of /root/reference/src/film.rs.  The sensor converts
hero-wavelength radiance samples to sensor RGB on device
(``PixelSensor.to_sensor_rgb``, reference film.rs:907-914); the film is a
functional pytree of per-pixel accumulators updated by scatter-add (the
reference's unsafe disjoint-tile writes, integrator.rs:277-295, become XLA
scatters — disjointness is no longer a safety condition).

Accumulators are float32 by default (the reference uses f64 sums,
film.rs:470-479; the wave structure keeps per-add magnitudes bounded, so
f32 + final normalization holds to ~1e-6 for 1k spp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shimmer_tpu.color.color import white_balance
from shimmer_tpu.ops.math import safe_div
from shimmer_tpu.spectra.sampled import SampledWavelengths
from shimmer_tpu.spectra.spectrum import (
    CIE_Y_INTEGRAL,
    Spectrum,
    cie_x_spectrum,
    cie_y_spectrum,
    cie_z_spectrum,
    d_illuminant,
    dense_sample,
    inner_product,
    swatch_reflectances,
    spectrum_xyz,
)
from shimmer_tpu.utils.pytree import pytree_dataclass
from shimmer_tpu.color.color import xyz_to_xy


class PixelSensor:
    """Spectral sensor response + sensor-RGB→XYZ matrix
    (src/film.rs:753-941)."""

    def __init__(
        self,
        colorspace,
        sensor_illum: Spectrum | None = None,
        imaging_ratio: float = 1.0,
        rgb_bar: tuple[Spectrum, Spectrum, Spectrum] | None = None,
    ):
        self.imaging_ratio = float(imaging_ratio)
        if rgb_bar is None:
            # CIE XYZ matching functions as the response curves (film.rs:822-845)
            self.rgb_bar_dense = np.stack(
                [
                    cie_x_spectrum().to_dense(),
                    cie_y_spectrum().to_dense(),
                    cie_z_spectrum().to_dense(),
                ]
            )
            if sensor_illum is not None:
                src_white = xyz_to_xy(spectrum_xyz(sensor_illum))
                self.xyz_from_sensor_rgb = white_balance(
                    src_white, colorspace.w
                )
            else:
                self.xyz_from_sensor_rgb = np.eye(3)
        else:
            # Arbitrary RGB response: least-squares fit against the 24
            # ColorChecker swatches (film.rs:847-908).
            r, g, b = rgb_bar
            assert sensor_illum is not None
            self.rgb_bar_dense = np.stack(
                [r.to_dense(), g.to_dense(), b.to_dense()]
            )
            swatches = swatch_reflectances()
            rgb_camera = np.stack(
                [
                    _project_reflectance(s, sensor_illum, r, g, b)
                    for s in swatches
                ]
            )
            sensor_white_g = inner_product(sensor_illum, g)
            sensor_white_y = inner_product(sensor_illum, cie_y_spectrum())
            xyz_output = np.stack(
                [
                    _project_reflectance(
                        s,
                        colorspace.illuminant,
                        cie_x_spectrum(),
                        cie_y_spectrum(),
                        cie_z_spectrum(),
                    )
                    * (sensor_white_y / sensor_white_g)
                    for s in swatches
                ]
            )
            m, *_ = np.linalg.lstsq(rgb_camera, xyz_output, rcond=None)
            self.xyz_from_sensor_rgb = m.T

    @staticmethod
    def create(
        colorspace,
        exposure_time: float = 1.0,
        iso: float = 100.0,
        white_balance_temp: float = 0.0,
        sensor_name: str = "cie1931",
    ) -> "PixelSensor":
        """Parameter semantics of PixelSensor::create (film.rs:767-819)."""
        if sensor_name != "cie1931" and white_balance_temp == 0.0:
            white_balance_temp = 6500.0
        imaging_ratio = exposure_time * iso / 100.0
        sensor_illum = (
            d_illuminant(white_balance_temp) if white_balance_temp != 0.0 else None
        )
        if sensor_name == "cie1931":
            return PixelSensor(colorspace, sensor_illum, imaging_ratio)
        raise ValueError(f"unknown sensor: {sensor_name}")

    def to_sensor_rgb(self, L, swl: SampledWavelengths):
        """Device: (..., 4) radiance + wavelengths → (..., 3) sensor RGB
        (film.rs:907-914)."""
        bars = jnp.asarray(self.rgb_bar_dense, jnp.float32)
        l = safe_div(L, swl.pdf)
        r = jnp.mean(dense_sample(bars[0], swl.lam) * l, axis=-1)
        g = jnp.mean(dense_sample(bars[1], swl.lam) * l, axis=-1)
        b = jnp.mean(dense_sample(bars[2], swl.lam) * l, axis=-1)
        return jnp.stack([r, g, b], axis=-1) * self.imaging_ratio


def _project_reflectance(refl, illum, b1, b2, b3):
    """⟨b_i · refl · illum⟩ / ⟨b2 · illum⟩ (film.rs project_reflectance)."""
    lam = np.arange(360.0, 831.0)
    il = illum.get(lam)
    g_int = np.sum(b2.get(lam) * il)
    return (
        np.array(
            [
                np.sum(b1.get(lam) * refl.get(lam) * il),
                np.sum(b2.get(lam) * refl.get(lam) * il),
                np.sum(b3.get(lam) * refl.get(lam) * il),
            ]
        )
        / g_int
    )


@pytree_dataclass
class FilmState:
    """Per-pixel accumulators, (H, W, ...) arrays."""

    rgb_sum: jnp.ndarray     # (H, W, 3)
    weight_sum: jnp.ndarray  # (H, W)
    rgb_splat: jnp.ndarray   # (H, W, 3)


class RgbFilm:
    """RGB film (src/film.rs RgbFilm).  Host descriptor + functional state."""

    def __init__(
        self,
        resolution: tuple[int, int],
        filter_,
        sensor: PixelSensor,
        colorspace,
        max_component_value: float = float("inf"),
        filename: str = "shimmer.pfm",
        accum_dtype=jnp.float32,
    ):
        self.resolution = tuple(resolution)  # (width, height)
        self.filter = filter_
        self.sensor = sensor
        self.colorspace = colorspace
        self.max_component_value = float(max_component_value)
        self.filename = filename
        self.filter_integral = float(filter_.integral())
        self.output_rgb_from_sensor_rgb = (
            colorspace.rgb_from_xyz @ sensor.xyz_from_sensor_rgb
        )
        self.accum_dtype = accum_dtype

    def init_state(self) -> FilmState:
        w, h = self.resolution
        return FilmState(
            rgb_sum=jnp.zeros((h, w, 3), self.accum_dtype),
            weight_sum=jnp.zeros((h, w), self.accum_dtype),
            rgb_splat=jnp.zeros((h, w, 3), self.accum_dtype),
        )

    def sample_wavelengths(self, u) -> SampledWavelengths:
        """Visible-importance wavelength sampling (film.rs:438-444)."""
        return SampledWavelengths.sample_visible(u)

    def _clamped_rgb(self, L, swl):
        rgb = self.sensor.to_sensor_rgb(L, swl)
        # Firefly clamp (film.rs:561-566).  Static skip when unbounded —
        # inf/m in the untaken where-branch would NaN the backward pass.
        import math

        if math.isinf(self.max_component_value):
            return rgb
        m = jnp.max(rgb, axis=-1)
        scale = jnp.where(
            m > self.max_component_value,
            self.max_component_value / jnp.where(m > 0.0, m, 1.0),
            1.0,
        )
        return rgb * scale[..., None]

    def add_samples(
        self, state: FilmState, pixel_xy, L, swl, weight, unique: bool = False
    ) -> FilmState:
        """Accumulate filter-weighted samples (film.rs:548-574).

        pixel_xy: (..., 2) int pixel coords; L: (..., 4); weight: (...,)
        filter weight from camera-sample importance sampling.  With filter
        importance sampling each sample lands on exactly one pixel, so this
        is a pure scatter-add — the replacement for the reference's
        per-tile unsafe film writes.

        unique: caller guarantees every lane targets a DISTINCT pixel
        (one sample per block pixel; padded lanes must be routed out of
        bounds), so the scatter needs no handling of duplicate indices
        and its result does not depend on the order of the adds.
        """
        rgb = self._clamped_rgb(L, swl) * weight[..., None]
        px = pixel_xy[..., 0].reshape(-1)
        py = pixel_xy[..., 1].reshape(-1)
        rgb_flat = rgb.reshape(-1, 3).astype(self.accum_dtype)
        w_flat = weight.reshape(-1).astype(self.accum_dtype)
        kw = {"unique_indices": True, "mode": "drop"} if unique else {}
        return FilmState(
            rgb_sum=state.rgb_sum.at[py, px].add(rgb_flat, **kw),
            weight_sum=state.weight_sum.at[py, px].add(w_flat, **kw),
            rgb_splat=state.rgb_splat,
        )

    def add_splats(self, state: FilmState, p_film, L, swl) -> FilmState:
        """Splat radiance over the filter footprint (film.rs:576-621).

        p_film: (..., 2) continuous film coords.  Footprint is a static
        (2r+1)^2 pixel window — each (dx, dy) is one scatter-add.
        """
        rgb = self._clamped_rgb(L, swl)
        w, h = self.resolution
        rx, ry = self.filter.radius
        p_discrete = p_film - 0.5
        x0 = jnp.ceil(p_discrete[..., 0] - rx).astype(jnp.int32)
        y0 = jnp.ceil(p_discrete[..., 1] - ry).astype(jnp.int32)
        nx = int(np.floor(2 * rx)) + 1
        ny = int(np.floor(2 * ry)) + 1
        rgb_splat = state.rgb_splat
        for dy in range(ny):
            for dx in range(nx):
                px = x0 + dx
                py = y0 + dy
                offset = jnp.stack(
                    [
                        px.astype(jnp.float32) + 0.5 - p_film[..., 0],
                        py.astype(jnp.float32) + 0.5 - p_film[..., 1],
                    ],
                    axis=-1,
                )
                fw = self.filter.evaluate(offset)
                valid = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (fw > 0)
                contrib = jnp.where(
                    valid[..., None], rgb * fw[..., None], 0.0
                ).reshape(-1, 3)
                rgb_splat = rgb_splat.at[
                    jnp.clip(py, 0, h - 1).reshape(-1),
                    jnp.clip(px, 0, w - 1).reshape(-1),
                ].add(contrib.astype(self.accum_dtype))
        return FilmState(
            rgb_sum=state.rgb_sum, weight_sum=state.weight_sum, rgb_splat=rgb_splat
        )

    def get_image(self, state: FilmState, splat_scale: float = 1.0):
        """Resolve accumulators to output-colorspace RGB (film.rs:720-738)."""
        rgb = safe_div(state.rgb_sum, state.weight_sum[..., None])
        rgb = rgb + splat_scale * state.rgb_splat / self.filter_integral
        m = jnp.asarray(self.output_rgb_from_sensor_rgb, jnp.float32)
        return jnp.einsum(
            "ij,hwj->hwi", m, rgb.astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
        )

    def merge(self, a: FilmState, b: FilmState) -> FilmState:
        """Combine accumulators from two waves/shards (checkpoint/psum path)."""
        return FilmState(
            rgb_sum=a.rgb_sum + b.rgb_sum,
            weight_sum=a.weight_sum + b.weight_sum,
            rgb_splat=a.rgb_splat + b.rgb_splat,
        )
