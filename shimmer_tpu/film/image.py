"""Host-side image container and I/O.

TPU-native analog of /root/reference/src/image.rs.  The container is a
numpy (H, W, C) float32 array + channel names + encoding; device texture
fetch lives in shimmer_tpu.textures.  I/O: read PNG/JPEG (via PIL, wider
than the reference's PNG-only reader, image.rs:1140-1311) and PFM; write
PFM (the reference's only writer, image.rs:1313-1378) plus PNG and EXR
(EXR closes a gap listed in SURVEY.md §2.1, via imageio when available).
"""

from __future__ import annotations

import enum
from pathlib import Path

import numpy as np

from shimmer_tpu.color.color import ColorEncoding, LINEAR, SRGB


def _optional_import(module: str, fmt: str):
    """Import an optional I/O dependency; PFM needs none of them."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{fmt} images need the '{module.split('.')[0]}' package, which "
            "is not installed; use .pfm instead"
        ) from e


# Golden-image tolerance: renders are deterministic up to floating-point
# reordering (another device, another fusion), which moves a few pixels.
GOLDEN_MEAN_REL = 0.01
GOLDEN_P99_REL = 0.05


def relative_drift(img, ref) -> tuple[float, float]:
    """(mean, 99th percentile) of |img - ref| relative to mean |ref|: the
    measure the golden-image checks hold renders to."""
    img = np.asarray(img, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).mean()), 1e-6)
    diff = np.abs(img - ref)
    return float(diff.mean() / scale), float(np.quantile(diff, 0.99) / scale)


class WrapMode(enum.Enum):
    """src/image.rs:73-97."""

    REPEAT = "repeat"
    CLAMP = "clamp"
    BLACK = "black"
    OCTAHEDRAL_SPHERE = "octahedralsphere"


class Image:
    """(H, W, C) float32 linear-space image."""

    def __init__(self, data: np.ndarray, channel_names=None):
        data = np.asarray(data, np.float32)
        if data.ndim == 2:
            data = data[..., None]
        self.data = data
        c = data.shape[-1]
        if channel_names is None:
            channel_names = (
                ["Y"] if c == 1 else ["R", "G", "B", "A"][:c]
            )
        self.channel_names = list(channel_names)

    @property
    def resolution(self):
        """(width, height)"""
        return (self.data.shape[1], self.data.shape[0])

    @property
    def n_channels(self):
        return self.data.shape[-1]

    # -- reading (src/image.rs:1140-1311, extended) --

    @staticmethod
    def read(path: str | Path, encoding: ColorEncoding | None = None) -> "Image":
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix == ".pfm":
            return Image(_read_pfm(path))
        if suffix in (".png", ".jpg", ".jpeg", ".tga", ".bmp", ".webp"):
            img = _optional_import("PIL.Image", suffix).open(path)
            arr = np.asarray(img)
            if arr.dtype == np.uint8:
                arr = arr.astype(np.float32) / 255.0
            elif arr.dtype == np.uint16:
                arr = arr.astype(np.float32) / 65535.0
            else:
                arr = arr.astype(np.float32)
            if encoding is None:
                encoding = SRGB if suffix != ".pfm" else LINEAR
            # alpha stays linear; color channels get decoded
            if arr.ndim == 3 and arr.shape[-1] == 4:
                rgb = encoding.to_linear(arr[..., :3])
                arr = np.concatenate([rgb, arr[..., 3:]], axis=-1)
            else:
                arr = encoding.to_linear(arr)
            return Image(arr)
        if suffix == ".exr":
            iio = _optional_import("imageio.v3", suffix)
            return Image(np.asarray(iio.imread(path), np.float32))
        raise ValueError(f"unsupported image format: {suffix}")

    # -- writing (src/image.rs:1313-1378, extended) --

    def write(self, path: str | Path):
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix == ".pfm":
            _write_pfm(path, self.data)
        elif suffix == ".png":
            pil_image = _optional_import("PIL.Image", suffix)
            arr = self.data[..., :3] if self.n_channels >= 3 else self.data[..., 0]
            enc = np.clip(SRGB.from_linear(np.asarray(arr, np.float64)), 0, 1)
            pil_image.fromarray(
                (enc * 255.0 + 0.5).astype(np.uint8)
            ).save(path)
        elif suffix == ".exr":
            iio = _optional_import("imageio.v3", suffix)
            iio.imwrite(path, self.data.astype(np.float32))
        else:
            raise ValueError(f"unsupported image format: {suffix}")

    # -- access helpers --

    def get_channel(self, name: str) -> np.ndarray:
        return self.data[..., self.channel_names.index(name)]

    def select_channels(self, names) -> "Image":
        idx = [self.channel_names.index(n) for n in names]
        return Image(self.data[..., idx], names)

    def bilerp(self, uv: np.ndarray, wrap: WrapMode = WrapMode.REPEAT):
        """Host bilinear sample at uv ∈ [0,1]^2 (src/image.rs bilerp)."""
        w, h = self.resolution
        x = np.asarray(uv)[..., 0] * w - 0.5
        y = np.asarray(uv)[..., 1] * h - 0.5
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        dx = (x - x0)[..., None]
        dy = (y - y0)[..., None]

        def texel(xi, yi):
            xi, yi, ok = _wrap_coords(xi, yi, w, h, wrap)
            v = self.data[yi, xi]
            return np.where(ok[..., None], v, 0.0)

        return (
            (1 - dx) * (1 - dy) * texel(x0, y0)
            + dx * (1 - dy) * texel(x0 + 1, y0)
            + (1 - dx) * dy * texel(x0, y0 + 1)
            + dx * dy * texel(x0 + 1, y0 + 1)
        )

    def average(self) -> np.ndarray:
        return self.data.mean(axis=(0, 1))

    # -- pyramid (src/image.rs:699-1007) --

    def generate_pyramid(self) -> list["Image"]:
        """Full mip pyramid: resample to power-of-2, then repeated 2× box
        downsample (the reference's scheme, image.rs:699-1007)."""
        img = self._to_pow2()
        levels = [img]
        while max(img.resolution) > 1:
            img = img._downsample_2x()
            levels.append(img)
        return levels

    def _to_pow2(self) -> "Image":
        w, h = self.resolution
        nw = 1 << (w - 1).bit_length() if w > 1 else 1
        nh = 1 << (h - 1).bit_length() if h > 1 else 1
        if (nw, nh) == (w, h):
            return self
        return self.resize(nw, nh)

    def resize(self, nw: int, nh: int) -> "Image":
        """Separable bilinear resample."""
        ys = (np.arange(nh) + 0.5) / nh
        xs = (np.arange(nw) + 0.5) / nw
        uv = np.stack(np.meshgrid(xs, ys), axis=-1)
        return Image(self.bilerp(uv, WrapMode.CLAMP), self.channel_names)

    def _downsample_2x(self) -> "Image":
        d = self.data
        h, w = d.shape[:2]
        nh, nw = max(1, h // 2), max(1, w // 2)
        if h > 1 and w > 1:
            out = (
                d[0 : 2 * nh : 2, 0 : 2 * nw : 2]
                + d[1 : 2 * nh : 2, 0 : 2 * nw : 2]
                + d[0 : 2 * nh : 2, 1 : 2 * nw : 2]
                + d[1 : 2 * nh : 2, 1 : 2 * nw : 2]
            ) * 0.25
        elif h > 1:
            out = (d[0 : 2 * nh : 2] + d[1 : 2 * nh : 2]) * 0.5
        else:
            out = (d[:, 0 : 2 * nw : 2] + d[:, 1 : 2 * nw : 2]) * 0.5
        return Image(out, self.channel_names)


def _wrap_coords(x, y, w, h, wrap: WrapMode):
    ok = np.ones(np.shape(x), bool)
    if wrap == WrapMode.REPEAT:
        x = np.mod(x, w)
        y = np.mod(y, h)
    elif wrap == WrapMode.CLAMP:
        x = np.clip(x, 0, w - 1)
        y = np.clip(y, 0, h - 1)
    elif wrap == WrapMode.BLACK:
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        x = np.clip(x, 0, w - 1)
        y = np.clip(y, 0, h - 1)
    elif wrap == WrapMode.OCTAHEDRAL_SPHERE:
        # equal-area octahedral wrap (src/image.rs:80-97): reflect across
        # edges with the appropriate flip
        assert w == h
        under_x = x < 0
        over_x = x >= w
        x = np.where(under_x, -1 - x, np.where(over_x, 2 * w - 1 - x, x))
        y = np.where(under_x | over_x, h - 1 - y, y)
        under_y = y < 0
        over_y = y >= h
        y = np.where(under_y, -1 - y, np.where(over_y, 2 * h - 1 - y, y))
        x = np.where(under_y | over_y, w - 1 - x, x)
    return x, y, ok


def _read_pfm(path: Path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError("not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        data = np.frombuffer(
            f.read(w * h * channels * 4),
            dtype="<f4" if scale < 0 else ">f4",
        )
        img = data.reshape(h, w, channels)
        # PFM scanlines are bottom-up
        return np.ascontiguousarray(img[::-1]) * abs(scale)


def _write_pfm(path: Path, data: np.ndarray):
    """Bottom-up little-endian PFM (src/image.rs:1313-1377)."""
    h, w = data.shape[:2]
    c = data.shape[2] if data.ndim == 3 else 1
    if c not in (1, 3):
        data = data[..., :3]
        c = 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.000000\n")
        f.write(np.ascontiguousarray(data[::-1], "<f4").tobytes())
