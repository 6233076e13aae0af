"""Cameras: perspective, orthographic, spherical.

TPU-native analog of /root/reference/src/camera.rs.  A camera is a host
object holding jnp transforms; ``generate_ray`` / ``generate_ray_differential``
are device functions batched over film samples.  Rays are produced directly
in *render space* (the reference's CameraTransform scheme: render space
defaults to camera-world, camera.rs:490-560, keeping coordinates small near
the camera for f32 precision — the device computes in float32).

Spherical cameras close a gap listed in SURVEY.md §2.1 (absent from the
reference); semantics follow pbrt-v4.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from shimmer_tpu.ops.math import lerp, safe_sqrt
from shimmer_tpu.ops.ray import Ray, RayDifferential
from shimmer_tpu.ops.sampling import sample_uniform_disk_concentric
from shimmer_tpu.ops.transform import Transform
from shimmer_tpu.ops.vecmath import (
    equal_area_square_to_sphere,
    normalize,
    vec,
)


class CameraTransform:
    """world↔render↔camera transform pair (camera.rs:490-560)."""

    def __init__(self, world_from_camera: Transform, rendering_space: str = "cameraworld"):
        rendering_space = rendering_space.lower()
        if rendering_space == "camera":
            world_from_render = world_from_camera
        elif rendering_space == "cameraworld":
            # Render space = world axes, origin at the camera (default).
            p_camera = world_from_camera.apply_point(jnp.zeros(3))
            world_from_render = Transform.translate(p_camera)
        elif rendering_space == "world":
            world_from_render = Transform.identity()
        else:
            raise ValueError(f"unknown rendering coordinate system: {rendering_space}")
        self.world_from_render = world_from_render
        self.render_from_camera = world_from_render.inverse() @ world_from_camera

    def render_from_world(self) -> Transform:
        return self.world_from_render.inverse()


class CameraBase:
    def __init__(
        self,
        camera_transform: CameraTransform,
        resolution,
        shutter_open: float = 0.0,
        shutter_close: float = 1.0,
    ):
        self.camera_transform = camera_transform
        self.resolution = tuple(resolution)  # (w, h)
        self.shutter_open = float(shutter_open)
        self.shutter_close = float(shutter_close)

    def sample_time(self, u):
        return lerp(u, self.shutter_open, self.shutter_close)


def _default_screen_window(resolution):
    w, h = resolution
    aspect = w / h
    if aspect > 1.0:
        return (-aspect, -1.0), (aspect, 1.0)
    return (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect)


class _ProjectiveCamera(CameraBase):
    """Shared raster↔screen↔camera transforms (camera.rs:584-640)."""

    def __init__(
        self,
        camera_transform,
        resolution,
        screen_from_camera: Transform,
        screen_window=None,
        lens_radius: float = 0.0,
        focal_distance: float = 1e6,
        **kw,
    ):
        super().__init__(camera_transform, resolution, **kw)
        if screen_window is None:
            screen_window = _default_screen_window(resolution)
        (sx0, sy0), (sx1, sy1) = screen_window
        ndc_from_screen = Transform.scale(
            1.0 / (sx1 - sx0), 1.0 / (sy1 - sy0), 1.0
        ) @ Transform.translate(jnp.array([-sx0, -sy1, 0.0]))
        raster_from_ndc = Transform.scale(resolution[0], -resolution[1], 1.0)
        self.raster_from_screen = raster_from_ndc @ ndc_from_screen
        self.screen_from_raster = self.raster_from_screen.inverse()
        self.camera_from_raster = (
            screen_from_camera.inverse() @ self.screen_from_raster
        )
        self.screen_from_camera = screen_from_camera
        self.lens_radius = float(lens_radius)
        self.focal_distance = float(focal_distance)


class PerspectiveCamera(_ProjectiveCamera):
    """Pinhole/thin-lens perspective camera (camera.rs:843-1100)."""

    def __init__(
        self,
        camera_transform,
        resolution,
        fov: float = 90.0,
        screen_window=None,
        lens_radius: float = 0.0,
        focal_distance: float = 1e6,
        **kw,
    ):
        super().__init__(
            camera_transform,
            resolution,
            Transform.perspective(fov, 1e-2, 1000.0),
            screen_window,
            lens_radius,
            focal_distance,
            **kw,
        )
        self.fov = float(fov)
        # Angular size of one pixel (for approximate texture footprints).
        self.pixel_spread = float(
            2.0 * np.tan(np.deg2rad(fov) / 2.0) / resolution[1]
        )
        zero = self.camera_from_raster.apply_point(jnp.zeros(3))
        self.dx_camera = (
            self.camera_from_raster.apply_point(vec(1.0, 0.0, 0.0)) - zero
        )
        self.dy_camera = (
            self.camera_from_raster.apply_point(vec(0.0, 1.0, 0.0)) - zero
        )

    def _camera_ray(self, p_film, u_lens):
        p_raster = jnp.concatenate(
            [p_film, jnp.zeros_like(p_film[..., :1])], axis=-1
        )
        p_camera = self.camera_from_raster.apply_point(p_raster)
        o = jnp.zeros_like(p_camera)
        d = normalize(p_camera)
        if self.lens_radius > 0.0:
            p_lens = self.lens_radius * sample_uniform_disk_concentric(u_lens)
            ft = self.focal_distance / d[..., 2]
            p_focus = o + ft[..., None] * d
            o = jnp.concatenate(
                [p_lens, jnp.zeros_like(p_lens[..., :1])], axis=-1
            )
            d = normalize(p_focus - o)
        return o, d, p_camera

    def generate_ray(self, p_film, u_lens):
        """p_film: (..., 2) raster coords → Ray in render space
        (camera.rs:966-1001)."""
        o, d, _ = self._camera_ray(p_film, u_lens)
        r2c = self.camera_transform.render_from_camera
        return Ray(o=r2c.apply_point(o), d=r2c.apply_vector(d))

    def generate_ray_differential(self, p_film, u_lens):
        """Main + x/y-offset rays (camera.rs:1003-1100)."""
        o, d, p_camera = self._camera_ray(p_film, u_lens)
        if self.lens_radius > 0.0:
            # Focus-plane construction for defocused differentials.
            def focus_dir(dp):
                p = p_camera + dp
                dd = normalize(p)
                ft = self.focal_distance / dd[..., 2]
                p_focus = ft[..., None] * dd
                return normalize(p_focus - o)

            rx_o = ry_o = o
            rx_d = focus_dir(self.dx_camera)
            ry_d = focus_dir(self.dy_camera)
        else:
            rx_o = ry_o = o
            rx_d = normalize(p_camera + self.dx_camera)
            ry_d = normalize(p_camera + self.dy_camera)
        r2c = self.camera_transform.render_from_camera
        ray = Ray(o=r2c.apply_point(o), d=r2c.apply_vector(d))
        return RayDifferential(
            ray=ray,
            rx_o=r2c.apply_point(rx_o),
            rx_d=r2c.apply_vector(rx_d),
            ry_o=r2c.apply_point(ry_o),
            ry_d=r2c.apply_vector(ry_d),
            has_differentials=jnp.ones(ray.o.shape[:-1], bool),
        )


class OrthographicCamera(_ProjectiveCamera):
    """Orthographic projection (camera.rs:643-840)."""

    def __init__(
        self,
        camera_transform,
        resolution,
        screen_window=None,
        lens_radius: float = 0.0,
        focal_distance: float = 1e6,
        **kw,
    ):
        super().__init__(
            camera_transform,
            resolution,
            Transform.orthographic(0.0, 1.0),
            screen_window,
            lens_radius,
            focal_distance,
            **kw,
        )

    def generate_ray(self, p_film, u_lens):
        p_raster = jnp.concatenate(
            [p_film, jnp.zeros_like(p_film[..., :1])], axis=-1
        )
        o = self.camera_from_raster.apply_point(p_raster)
        d = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0], jnp.float32), o.shape
        )
        if self.lens_radius > 0.0:
            p_lens = self.lens_radius * sample_uniform_disk_concentric(u_lens)
            ft = self.focal_distance / d[..., 2]
            p_focus = o + ft[..., None] * d
            o = o.at[..., 0:2].set(p_lens) if hasattr(o, "at") else o
            d = normalize(p_focus - o)
        r2c = self.camera_transform.render_from_camera
        return Ray(o=r2c.apply_point(o), d=r2c.apply_vector(d))

    def generate_ray_differential(self, p_film, u_lens):
        ray = self.generate_ray(p_film, u_lens)
        dx = self.camera_transform.render_from_camera.apply_vector(
            self.camera_from_raster.apply_vector(vec(1.0, 0.0, 0.0))
        )
        dy = self.camera_transform.render_from_camera.apply_vector(
            self.camera_from_raster.apply_vector(vec(0.0, 1.0, 0.0))
        )
        return RayDifferential(
            ray=ray,
            rx_o=ray.o + dx,
            rx_d=ray.d,
            ry_o=ray.o + dy,
            ry_d=ray.d,
            has_differentials=jnp.ones(ray.o.shape[:-1], bool),
        )


class SphericalCamera(CameraBase):
    """360° camera, equal-area or equirectangular mapping (pbrt-v4;
    gap-closing vs the reference, SURVEY.md §2.1)."""

    def __init__(self, camera_transform, resolution, mapping: str = "equalarea", **kw):
        super().__init__(camera_transform, resolution, **kw)
        self.mapping = mapping

    def generate_ray(self, p_film, u_lens):
        w, h = self.resolution
        uv = jnp.stack(
            [p_film[..., 0] / w, p_film[..., 1] / h], axis=-1
        )
        if self.mapping == "equalarea":
            uv = jnp.stack([uv[..., 0], 1.0 - uv[..., 1]], axis=-1)
            d = equal_area_square_to_sphere(uv)
        else:  # equirectangular
            theta = jnp.pi * uv[..., 1]
            phi = 2.0 * jnp.pi * uv[..., 0]
            st = jnp.sin(theta)
            d = vec(st * jnp.sin(phi), jnp.cos(theta), -st * jnp.cos(phi))
        # y-up camera convention → swap to z-up camera space
        d = jnp.stack([-d[..., 2], -d[..., 0], d[..., 1]], axis=-1)
        o = jnp.zeros_like(d)
        r2c = self.camera_transform.render_from_camera
        return Ray(o=r2c.apply_point(o), d=r2c.apply_vector(d))

    def generate_ray_differential(self, p_film, u_lens):
        ray = self.generate_ray(p_film, u_lens)
        rx = self.generate_ray(p_film + jnp.array([1.0, 0.0]), u_lens)
        ry = self.generate_ray(p_film + jnp.array([0.0, 1.0]), u_lens)
        return RayDifferential(
            ray=ray,
            rx_o=rx.o,
            rx_d=rx.d,
            ry_o=ry.o,
            ry_d=ry.d,
            has_differentials=jnp.ones(ray.o.shape[:-1], bool),
        )
