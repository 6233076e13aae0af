"""Texture system: constant/scale/mix/image textures over a texel atlas.

TPU-native analog of /root/reference/src/texture.rs + mipmap.rs.  The
reference dispatches FloatTexture/SpectrumTexture enums per evaluation;
here every texture in the scene is a row in a TextureTable and all image
texels live in one flat atlas in HBM:

* scalar textures → float channels; spectrum textures → *sigmoid
  coefficient* texels (+ scale), so the RGB→spectrum uplift
  (RgbAlbedo/Unbounded semantics, scene.rs:392-434) is precomputed at load
  and shading is a gather + closed-form sigmoid;
* MIP pyramid levels are concatenated in the same atlas with per-level
  offsets; trilinear and EWA filtering select levels from the
  ray-differential footprint (mipmap.rs:121-233);
* texture *kinds* present are static census, like materials.

Mappings: UV / spherical / cylindrical / planar (texture.rs:838-1046).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from shimmer_tpu.ops.math import lerp, safe_acos, sqr
from shimmer_tpu.ops.vecmath import dot, normalize, spherical_phi, vec2
from shimmer_tpu.utils.pytree import pytree_dataclass, static_field

# Texture kinds.
CONSTANT = 0
SCALED = 1
MIX = 2
IMAGE = 3
DIRECTION_MIX = 4

# Mappings (texture.rs:838-1046).
MAP_UV = 0
MAP_SPHERICAL = 1
MAP_CYLINDRICAL = 2
MAP_PLANAR = 3

# Wrap modes.
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_BLACK = 2

# Filters (mipmap.rs FilterFunction).
FILTER_POINT = 0
FILTER_BILINEAR = 1
FILTER_TRILINEAR = 2
FILTER_EWA = 3


@pytree_dataclass
class TextureTable:
    """Flat per-texture parameter rows + shared texel atlas.

    The atlas holds float32 texels with 4 channels per texel:
    scalar textures use channel 0; spectrum textures store sigmoid
    coefficients (c0, c1, c2) + per-texel scale.
    """

    kind: jnp.ndarray          # (K,) int32
    const_value: jnp.ndarray   # (K, 4) constant value / coeffs+scale
    tex_a: jnp.ndarray         # (K,) int32 — operand texture (scale/mix)
    tex_b: jnp.ndarray         # (K,) int32
    tex_c: jnp.ndarray         # (K,) int32 — mix amount texture (-1 = const)
    mix_amount: jnp.ndarray    # (K,)
    mix_dir: jnp.ndarray       # (K, 3)
    # image textures:
    level0_offset: jnp.ndarray  # (K,) int32 — texel offset of level 0
    level0_w: jnp.ndarray      # (K,) int32
    level0_h: jnp.ndarray      # (K,) int32
    n_levels: jnp.ndarray      # (K,) int32
    wrap: jnp.ndarray          # (K,) int32
    filter_kind: jnp.ndarray   # (K,) int32
    scale: jnp.ndarray         # (K,) uniform scale (texture.rs Scaled fast path)
    invert: jnp.ndarray        # (K,) bool — 1-x (pbrt invert param)
    # mapping:
    mapping: jnp.ndarray       # (K,) int32
    uv_scale: jnp.ndarray      # (K, 2) su, sv
    uv_delta: jnp.ndarray      # (K, 2) du, dv
    world_to_tex: jnp.ndarray  # (K, 4, 4) for spherical/cylindrical/planar
    planar_vs: jnp.ndarray     # (K, 2, 3)
    atlas: jnp.ndarray         # (A, 4) texel pool
    level_offsets: jnp.ndarray  # (K, MAX_LEVELS) int32 offsets per level
    level_sizes: jnp.ndarray    # (K, MAX_LEVELS, 2) int32 (w, h)
    kinds_present: tuple = static_field(default=())
    max_levels: int = static_field(default=1)
    # static census: any Mix row with a textured amount?
    has_amount_tex: bool = static_field(default=False)


MAX_LEVELS = 16


class TextureBuilder:
    """Host-side accumulation of scene textures into a TextureTable."""

    def __init__(self):
        self.rows = []
        self.atlas_chunks = []
        self.atlas_size = 0

    def _new_row(self, kind):
        row = {
            "kind": kind,
            "const_value": np.zeros(4, np.float32),
            "tex_a": -1,
            "tex_b": -1,
            "tex_c": -1,
            "mix_amount": 0.5,
            "mix_dir": np.array([0, 0, 1], np.float32),
            "level0_offset": 0,
            "level0_w": 0,
            "level0_h": 0,
            "n_levels": 0,
            "wrap": WRAP_REPEAT,
            "filter_kind": FILTER_TRILINEAR,
            "scale": 1.0,
            "invert": False,
            "mapping": MAP_UV,
            "uv_scale": np.array([1.0, 1.0], np.float32),
            "uv_delta": np.zeros(2, np.float32),
            "world_to_tex": np.eye(4, dtype=np.float32),
            "planar_vs": np.array([[1, 0, 0], [0, 1, 0]], np.float32),
            "level_offsets": np.zeros(MAX_LEVELS, np.int32),
            "level_sizes": np.zeros((MAX_LEVELS, 2), np.int32),
        }
        self.rows.append(row)
        return len(self.rows) - 1, row

    def add_constant_float(self, value: float) -> int:
        i, row = self._new_row(CONSTANT)
        row["const_value"][0] = value
        return i

    def add_constant_spectrum_coeffs(self, coeffs, scale: float = 1.0) -> int:
        i, row = self._new_row(CONSTANT)
        row["const_value"][:3] = np.asarray(coeffs, np.float32)
        row["const_value"][3] = scale
        return i

    def add_scaled(self, tex: int, scale_tex: int) -> int:
        i, row = self._new_row(SCALED)
        row["tex_a"] = tex
        row["tex_b"] = scale_tex
        return i

    def add_mix(
        self, tex1: int, tex2: int, amount: float = 0.5,
        amount_tex: int = -1,
    ) -> int:
        """lerp(amount, tex1, tex2) — amount may itself be a (leaf)
        float texture (texture.rs:226-260: pbrt's amount is a
        FloatTexture; a constant stays in the scalar column)."""
        i, row = self._new_row(MIX)
        row["tex_a"] = tex1
        row["tex_b"] = tex2
        row["mix_amount"] = amount
        row["tex_c"] = amount_tex
        return i

    def add_direction_mix(self, tex1: int, tex2: int, dir) -> int:
        """DirectionMix (texture.rs:263-300 / FloatDirectionMixTexture):
        amt = dot(n, dir); result = tex1*(1-amt) + tex2*amt."""
        i, row = self._new_row(DIRECTION_MIX)
        row["tex_a"] = tex1
        row["tex_b"] = tex2
        row["mix_dir"] = np.asarray(dir, np.float32)
        return i

    def add_image(
        self,
        texels: np.ndarray,
        is_spectrum: bool,
        colorspace=None,
        wrap=WRAP_REPEAT,
        filter_kind=FILTER_TRILINEAR,
        scale: float = 1.0,
        invert: bool = False,
        mapping=MAP_UV,
        uv_scale=(1.0, 1.0),
        uv_delta=(0.0, 0.0),
        max_levels: int = MAX_LEVELS,
        spectrum_type: str = "albedo",
        world_to_tex=None,
        planar_vs=None,
    ) -> int:
        """Add an image texture.  texels: (H, W) float or (H, W, 3) linear
        rgb.  Spectrum textures are uplifted to per-texel sigmoid coeffs
        (unique-color fit) with the RgbAlbedo/Unbounded scale convention.
        """
        from shimmer_tpu.film.image import Image
        from shimmer_tpu.spectra.rgb2spec import fit_rgb_coeffs

        i, row = self._new_row(IMAGE)
        row["wrap"] = wrap
        row["filter_kind"] = filter_kind
        row["scale"] = scale
        row["invert"] = invert
        row["mapping"] = mapping
        row["uv_scale"] = np.asarray(uv_scale, np.float32)
        row["uv_delta"] = np.asarray(uv_delta, np.float32)
        if world_to_tex is not None:
            row["world_to_tex"] = np.asarray(world_to_tex, np.float32)
        if planar_vs is not None:
            row["planar_vs"] = np.asarray(planar_vs, np.float32)

        img = Image(np.asarray(texels, np.float32))
        pyramid = img.generate_pyramid()[:max_levels]
        row["n_levels"] = len(pyramid)
        for li, lvl in enumerate(pyramid):
            data = lvl.data
            h, w = data.shape[:2]
            if is_spectrum:
                rgb = data[..., :3].astype(np.float64)
                m = rgb.max(axis=-1)
                tscale = np.where(
                    (spectrum_type == "albedo") & (m <= 1.0), 1.0, 2.0 * np.maximum(m, 1e-9)
                )
                if spectrum_type == "albedo":
                    tscale = np.ones_like(m)
                    base = np.clip(rgb, 0.0, 1.0)
                else:
                    tscale = 2.0 * np.maximum(m, 1e-12)
                    base = rgb / tscale[..., None]
                flat = base.reshape(-1, 3).astype(np.float32)
                uniq, inv = np.unique(flat, axis=0, return_inverse=True)
                from shimmer_tpu.color.colorspace import get_named_color_space

                cs = colorspace or get_named_color_space("srgb")
                coeffs = fit_rgb_coeffs(uniq.astype(np.float64), cs)[inv]
                texel4 = np.concatenate(
                    [coeffs.reshape(h, w, 3), tscale.reshape(h, w, 1).astype(np.float32)],
                    axis=-1,
                )
            else:
                c0 = data[..., 0]
                texel4 = np.zeros((h, w, 4), np.float32)
                texel4[..., 0] = c0
            off = self.atlas_size
            self.atlas_chunks.append(texel4.reshape(-1, 4))
            self.atlas_size += h * w
            row["level_offsets"][li] = off
            row["level_sizes"][li] = (w, h)
            if li == 0:
                row["level0_offset"] = off
                row["level0_w"] = w
                row["level0_h"] = h
        return i

    def build(self) -> TextureTable:
        k = len(self.rows)
        if k == 0:
            self.add_constant_float(0.0)
            k = 1
        g = lambda key, dt=np.float32: np.asarray(
            [r[key] for r in self.rows], dt
        )
        atlas = (
            np.concatenate(self.atlas_chunks)
            if self.atlas_chunks
            else np.zeros((1, 4), np.float32)
        )
        kinds = tuple(sorted({int(r["kind"]) for r in self.rows}))
        return TextureTable(
            kind=jnp.asarray(g("kind", np.int32)),
            const_value=jnp.asarray(g("const_value")),
            tex_a=jnp.asarray(g("tex_a", np.int32)),
            tex_b=jnp.asarray(g("tex_b", np.int32)),
            tex_c=jnp.asarray(g("tex_c", np.int32)),
            mix_amount=jnp.asarray(
                np.asarray([float(r["mix_amount"]) for r in self.rows], np.float32)
            ),
            mix_dir=jnp.asarray(g("mix_dir")),
            level0_offset=jnp.asarray(g("level0_offset", np.int32)),
            level0_w=jnp.asarray(g("level0_w", np.int32)),
            level0_h=jnp.asarray(g("level0_h", np.int32)),
            n_levels=jnp.asarray(g("n_levels", np.int32)),
            wrap=jnp.asarray(g("wrap", np.int32)),
            filter_kind=jnp.asarray(g("filter_kind", np.int32)),
            scale=jnp.asarray(g("scale")),
            invert=jnp.asarray(g("invert", bool)),
            mapping=jnp.asarray(g("mapping", np.int32)),
            uv_scale=jnp.asarray(g("uv_scale")),
            uv_delta=jnp.asarray(g("uv_delta")),
            world_to_tex=jnp.asarray(g("world_to_tex")),
            planar_vs=jnp.asarray(g("planar_vs")),
            atlas=jnp.asarray(atlas),
            level_offsets=jnp.asarray(g("level_offsets", np.int32)),
            level_sizes=jnp.asarray(g("level_sizes", np.int32)),
            kinds_present=kinds,
            max_levels=MAX_LEVELS,
            has_amount_tex=any(int(r["tex_c"]) >= 0 for r in self.rows),
        )


# --- device evaluation ---


def _apply_mapping(table: TextureTable, tex_id, si):
    """TextureMapping2D (texture.rs:838-1046): uv + screen-space derivs."""
    mapping = table.mapping[tex_id]
    su = table.uv_scale[tex_id, 0]
    sv = table.uv_scale[tex_id, 1]
    du = table.uv_delta[tex_id, 0]
    dv = table.uv_delta[tex_id, 1]
    # UV mapping (the dominant case).
    u = si.uv[..., 0] * su + du
    v = si.uv[..., 1] * sv + dv
    dudx = si.dudx * su
    dvdx = si.dvdx * sv
    dudy = si.dudy * su
    dvdy = si.dvdy * sv
    # Spherical / planar mappings (only traced if a texture uses them —
    # cheap to include unconditionally since it's pure vector math).
    m = table.world_to_tex[tex_id]
    p_t = (
        jnp.einsum("...ij,...j->...i", m[..., :3, :3], si.p, precision=jax.lax.Precision.HIGHEST)
        + m[..., :3, 3]
    )
    sph_theta = safe_acos(jnp.clip(p_t[..., 2] / jnp.maximum(
        jnp.linalg.norm(p_t, axis=-1), 1e-9), -1.0, 1.0))
    sph_phi = spherical_phi(p_t)
    u_sph = sph_theta / jnp.pi * su + du
    v_sph = sph_phi / (2.0 * jnp.pi) * sv + dv
    vs = table.planar_vs[tex_id]
    u_pl = dot(p_t, vs[..., 0, :]) * su + du
    v_pl = dot(p_t, vs[..., 1, :]) * sv + dv
    # Cylindrical (texture.rs:978-1010 / pbrt-v4 CylindricalMapping):
    # u = (pi + atan2(y, x)) / 2pi wraps around the axis, v = z.
    u_cyl = (
        (jnp.pi + jnp.arctan2(p_t[..., 1], p_t[..., 0]))
        / (2.0 * jnp.pi) * su + du
    )
    v_cyl = p_t[..., 2] * sv + dv
    u = jnp.where(
        mapping == MAP_SPHERICAL, u_sph,
        jnp.where(
            mapping == MAP_PLANAR, u_pl,
            jnp.where(mapping == MAP_CYLINDRICAL, u_cyl, u),
        ),
    )
    v = jnp.where(
        mapping == MAP_SPHERICAL, v_sph,
        jnp.where(
            mapping == MAP_PLANAR, v_pl,
            jnp.where(mapping == MAP_CYLINDRICAL, v_cyl, v),
        ),
    )
    return u, v, dudx, dvdx, dudy, dvdy


def _wrap_coord(x, n, wrap):
    ok = jnp.ones(x.shape, bool)
    n = jnp.maximum(n, 1)
    rep = jnp.mod(x, n)
    clam = jnp.clip(x, 0, n - 1)
    inb = (x >= 0) & (x < n)
    out = jnp.where(
        wrap == WRAP_REPEAT, rep, jnp.where(wrap == WRAP_CLAMP, clam, clam)
    )
    ok = jnp.where(wrap == WRAP_BLACK, inb, ok)
    return out, ok


def _texel_fetch(table: TextureTable, tex_id, level, x, y):
    """Atlas gather with wrap handling → (..., 4)."""
    level = jnp.clip(level, 0, table.n_levels[tex_id] - 1)
    off = jnp.take_along_axis(
        table.level_offsets[tex_id], level[..., None], axis=-1
    )[..., 0]
    wh = jnp.take_along_axis(
        table.level_sizes[tex_id],
        level[..., None, None],
        axis=-2,
    )[..., 0, :]
    w = wh[..., 0]
    h = wh[..., 1]
    wrap = table.wrap[tex_id]
    xi, okx = _wrap_coord(x, w, wrap)
    yi, oky = _wrap_coord(y, h, wrap)
    t = table.atlas[off + yi * w + xi]
    return jnp.where((okx & oky)[..., None], t, 0.0)


def _bilerp_level(table, tex_id, level, u, v):
    wh = jnp.take_along_axis(
        table.level_sizes[tex_id], level[..., None, None], axis=-2
    )[..., 0, :]
    w = wh[..., 0].astype(jnp.float32)
    h = wh[..., 1].astype(jnp.float32)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    t00 = _texel_fetch(table, tex_id, level, x0, y0)
    t10 = _texel_fetch(table, tex_id, level, x0 + 1, y0)
    t01 = _texel_fetch(table, tex_id, level, x0, y0 + 1)
    t11 = _texel_fetch(table, tex_id, level, x0 + 1, y0 + 1)
    return (
        (1 - dx) * (1 - dy) * t00
        + dx * (1 - dy) * t10
        + (1 - dx) * dy * t01
        + dx * dy * t11
    )


def _ewa_level(table, tex_id, level, u, v, dudx, dvdx, dudy, dvdy, n_taps=8):
    """Elliptically weighted average at one level (mipmap.rs:233-320).

    Fixed-tap version: samples along the major axis with Gaussian weights
    (the reference loops the ellipse's bounding box — data-dependent; a
    fixed tap count along the major axis is the standard GPU variant).
    """
    major = jnp.stack([dudx, dvdx], axis=-1)
    minor = jnp.stack([dudy, dvdy], axis=-1)
    swap = jnp.sum(major * major, -1) < jnp.sum(minor * minor, -1)
    major = jnp.where(swap[..., None], jnp.stack([dudy, dvdy], -1), major)
    total = jnp.zeros(u.shape + (4,), jnp.float32)
    wsum = jnp.zeros(u.shape, jnp.float32)
    for i in range(n_taps):
        t = (i + 0.5) / n_taps * 2.0 - 1.0  # [-1, 1]
        wgt = float(np.exp(-2.0 * t * t))
        uu = u + t * major[..., 0]
        vv = v + t * major[..., 1]
        total = total + wgt * _bilerp_level(table, tex_id, level, uu, vv)
        wsum = wsum + wgt
    return total / wsum[..., None]


def _eval_image(table: TextureTable, tex_id, si):
    u, v, dudx, dvdx, dudy, dvdy = _apply_mapping(table, tex_id, si)
    w0 = table.level0_w[tex_id].astype(jnp.float32)
    h0 = table.level0_h[tex_id].astype(jnp.float32)
    fk = table.filter_kind[tex_id]
    # LOD from the longer screen-space axis (mipmap.rs:121-201).
    width2 = jnp.maximum(
        (sqr(dudx) + sqr(dvdx)) * sqr(w0) * 0.0 + (sqr(dudx * w0) + sqr(dvdx * h0)),
        sqr(dudy * w0) + sqr(dvdy * h0),
    )
    lod = 0.5 * jnp.log2(jnp.maximum(width2, 1e-12))
    lod = jnp.clip(lod, 0.0, table.n_levels[tex_id].astype(jnp.float32) - 1.0)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = l0 + 1
    frac = (lod - l0.astype(jnp.float32))[..., None]
    # point/bilinear use level 0 only; trilinear lerps levels; EWA filters
    # within the chosen level.
    t_bil0 = _bilerp_level(table, tex_id, l0, u, v)
    t_bil1 = _bilerp_level(table, tex_id, jnp.minimum(l1, table.n_levels[tex_id] - 1), u, v)
    t_tri = (1.0 - frac) * t_bil0 + frac * t_bil1
    out = t_tri
    if True:  # EWA only where requested (mask; taps shared per call)
        t_ewa = _ewa_level(table, tex_id, l0, u, v, dudx, dvdx, dudy, dvdy)
        out = jnp.where((fk == FILTER_EWA)[..., None], t_ewa, out)
    out = jnp.where((fk == FILTER_BILINEAR)[..., None], t_bil0, out)
    nearest = _texel_fetch(
        table,
        tex_id,
        l0,
        (u * w0).astype(jnp.int32),
        (v * h0).astype(jnp.int32),
    )
    out = jnp.where((fk == FILTER_POINT)[..., None], nearest, out)
    return out


def eval_texture_raw(table: TextureTable, tex_id, si):
    """Evaluate texture rows → raw (..., 4) payload (value or coeffs+scale).

    Scale/mix combinators reference operand textures; one level of
    indirection is evaluated inline (nested combinators are flattened at
    build time by the scene builder)."""
    out = jnp.broadcast_to(
        table.const_value[tex_id], si.p.shape[:-1] + (4,)
    )
    kind = table.kind[tex_id]
    if IMAGE in table.kinds_present:
        img = _eval_image(table, tex_id, si)
        out = jnp.where((kind == IMAGE)[..., None], img, out)
    combinators = {SCALED, MIX, DIRECTION_MIX} & set(table.kinds_present)
    if combinators:
        a_id = jnp.maximum(table.tex_a[tex_id], 0)
        b_id = jnp.maximum(table.tex_b[tex_id], 0)
        a_const = jnp.broadcast_to(table.const_value[a_id], out.shape)
        b_const = jnp.broadcast_to(table.const_value[b_id], out.shape)
        a_kind = table.kind[a_id]
        b_kind = table.kind[b_id]
        if IMAGE in table.kinds_present:
            a_val = jnp.where(
                (a_kind == IMAGE)[..., None], _eval_image(table, a_id, si), a_const
            )
            b_val = jnp.where(
                (b_kind == IMAGE)[..., None], _eval_image(table, b_id, si), b_const
            )
        else:
            a_val, b_val = a_const, b_const
        scaled = a_val * b_val[..., 0:1]
        out = jnp.where((kind == SCALED)[..., None], scaled, out)
        if MIX in table.kinds_present:
            amt = jnp.broadcast_to(
                table.mix_amount[tex_id], out.shape[:-1]
            )
            c_tid = table.tex_c[tex_id]
            if table.has_amount_tex:
                # Textured mix amount (texture.rs:226-260: amount is a
                # FloatTexture); the amount operand must be a leaf.
                c_id = jnp.maximum(c_tid, 0)
                c_val = jnp.broadcast_to(
                    table.const_value[c_id][..., 0], out.shape[:-1]
                )
                if IMAGE in table.kinds_present:
                    c_val = jnp.where(
                        table.kind[c_id] == IMAGE,
                        _eval_image(table, c_id, si)[..., 0],
                        c_val,
                    )
                amt = jnp.where(c_tid >= 0, c_val, amt)
            mixed = lerp(amt[..., None], a_val, b_val)
            out = jnp.where((kind == MIX)[..., None], mixed, out)
        if DIRECTION_MIX in table.kinds_present:
            # amt = dot(n, dir); t1*(1-amt) + t2*amt
            # (texture.rs:263-300,SpectrumDirectionMixTexture likewise).
            d_amt = dot(
                si.n, jnp.broadcast_to(table.mix_dir[tex_id], si.n.shape)
            )
            dmixed = lerp(d_amt[..., None], a_val, b_val)
            out = jnp.where((kind == DIRECTION_MIX)[..., None], dmixed, out)
    scale = table.scale[tex_id][..., None]
    out = out * scale
    inv = table.invert[tex_id]
    out = jnp.where(inv[..., None], 1.0 - out, out)
    return out


def eval_float_texture(table: TextureTable, tex_id, si):
    """FloatTexture evaluation → (...,) scalar."""
    return eval_texture_raw(table, tex_id, si)[..., 0]


def eval_spectrum_texture(table: TextureTable, tex_id, si, swl):
    """SpectrumTexture evaluation → (..., 4) SampledSpectrum via the
    baked sigmoid coefficients."""
    from shimmer_tpu.spectra.rgb2spec import sigmoid_poly_sample

    raw = eval_texture_raw(table, tex_id, si)
    coeffs = raw[..., :3]
    tscale = raw[..., 3]
    return sigmoid_poly_sample(coeffs, swl.lam) * tscale[..., None]


def evaluate_material_textures(table: TextureTable, materials, si, swl):
    """Resolve per-lane texture-driven material parameters (the
    UniversalTextureEvaluator stage, material.rs:1376-1399).

    Uses the material table's texture-id columns when present."""
    tex = {}
    cols = getattr(materials, "tex_reflectance", None)
    if cols is not None:
        tid = cols[si.material_id]
        has = tid >= 0
        val = eval_spectrum_texture(table, jnp.maximum(tid, 0), si, swl)
        from shimmer_tpu.spectra.rgb2spec import sigmoid_poly_sample

        const = sigmoid_poly_sample(
            materials.reflectance[si.material_id], swl.lam
        )
        tex["reflectance"] = jnp.where(has[..., None], val, const)
    ur = getattr(materials, "tex_uroughness", None)
    if ur is not None:
        tid = ur[si.material_id]
        has = tid >= 0
        val = eval_float_texture(table, jnp.maximum(tid, 0), si)
        tex["uroughness"] = jnp.where(
            has, val, materials.uroughness[si.material_id]
        )
    vr = getattr(materials, "tex_vroughness", None)
    if vr is not None:
        tid = vr[si.material_id]
        has = tid >= 0
        val = eval_float_texture(table, jnp.maximum(tid, 0), si)
        tex["vroughness"] = jnp.where(
            has, val, materials.vroughness[si.material_id]
        )
    return tex
