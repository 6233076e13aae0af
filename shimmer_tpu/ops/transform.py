"""4x4 transforms with cached inverses, batched.

TPU-native analog of /root/reference/src/transform.rs (Transform with cached
inverse) and src/square_matrix.rs.  A Transform is a pytree of (..., 4, 4)
matrix + inverse; application functions preserve point/vector/normal
semantics that the reference encodes in its type system.

Constructors and composition run in NUMPY on the host: transforms are
built at scene-load time, where eager device ops would only add dispatch
overhead.  The numpy matrices are lifted to constants when application
methods are traced.

Device contractions ask for full float32 precision: on a GPU a default-
precision float32 contraction may run in TF32 (about 3 decimal digits),
which would move ray origins and directions enough to cause
self-intersection and pdf mismatches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shimmer_tpu.utils.pytree import pytree_dataclass


def _np3(x):
    return np.asarray(x, np.float64).reshape(3)


@pytree_dataclass
class Transform:
    m: jnp.ndarray      # (..., 4, 4)
    m_inv: jnp.ndarray  # (..., 4, 4)

    # -- constructors (host time, pure numpy) --

    @staticmethod
    def identity():
        eye = np.eye(4, dtype=np.float32)
        return Transform(m=eye, m_inv=eye)

    @staticmethod
    def from_matrix(m):
        m = np.asarray(m, np.float64)
        return Transform(
            m=m.astype(np.float32),
            m_inv=np.linalg.inv(m).astype(np.float32),
        )

    @staticmethod
    def translate(delta):
        delta = _np3(delta)
        m = np.eye(4, dtype=np.float32)
        m[0:3, 3] = delta
        mi = np.eye(4, dtype=np.float32)
        mi[0:3, 3] = -delta
        return Transform(m=m, m_inv=mi)

    @staticmethod
    def scale(sx, sy, sz):
        s = np.array([float(sx), float(sy), float(sz), 1.0], np.float32)
        return Transform(m=np.diag(s), m_inv=np.diag((1.0 / s).astype(np.float32)))

    @staticmethod
    def rotate_axis(theta_deg, axis):
        """Rotation about an arbitrary axis (src/transform.rs rotate)."""
        a = _np3(axis)
        a = a / np.linalg.norm(a)
        rad = np.deg2rad(float(np.asarray(theta_deg)))
        s, c = np.sin(rad), np.cos(rad)
        x, y, z = a
        m = np.array(
            [
                [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0.0],
                [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s, 0.0],
                [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c, 0.0],
                [0.0, 0.0, 0.0, 1.0],
            ],
            np.float32,
        )
        return Transform(m=m, m_inv=m.T.copy())

    @staticmethod
    def rotate_x(theta_deg):
        return Transform.rotate_axis(theta_deg, (1.0, 0.0, 0.0))

    @staticmethod
    def rotate_y(theta_deg):
        return Transform.rotate_axis(theta_deg, (0.0, 1.0, 0.0))

    @staticmethod
    def rotate_z(theta_deg):
        return Transform.rotate_axis(theta_deg, (0.0, 0.0, 1.0))

    @staticmethod
    def rotate_from_to(frm, to):
        """Rotation taking unit vector frm to unit vector to
        (src/transform.rs rotate_from_to, Möller-Hughes)."""
        frm = _np3(frm)
        to = _np3(to)
        if abs(frm[0]) < 0.72 and abs(to[0]) < 0.72:
            cand = np.array([1.0, 0.0, 0.0])
        elif abs(frm[1]) < 0.72 and abs(to[1]) < 0.72:
            cand = np.array([0.0, 1.0, 0.0])
        else:
            cand = np.array([0.0, 0.0, 1.0])
        u = cand - frm
        v = cand - to
        uu = float(u @ u)
        vv = float(v @ v)
        uv = float(u @ v)
        i = np.eye(3)
        r = (
            i
            - 2.0 / uu * np.outer(u, u)
            - 2.0 / vv * np.outer(v, v)
            + 4.0 * uv / (uu * vv) * np.outer(v, u)
        )
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = r
        return Transform(m=m, m_inv=m.T.copy())

    @staticmethod
    def look_at(pos, look, up):
        """Camera-to-world transform (src/transform.rs look_at)."""
        pos = _np3(pos)
        look = _np3(look)
        up = _np3(up)
        dir_ = look - pos
        dir_ = dir_ / np.linalg.norm(dir_)
        upn = up / np.linalg.norm(up)
        right = np.cross(upn, dir_)
        right = right / np.linalg.norm(right)
        new_up = np.cross(dir_, right)
        c2w = np.stack(
            [
                np.append(right, 0.0),
                np.append(new_up, 0.0),
                np.append(dir_, 0.0),
                np.append(pos, 1.0),
            ],
            axis=-1,
        )
        return Transform(
            m=c2w.astype(np.float32),
            m_inv=np.linalg.inv(c2w).astype(np.float32),
        )

    @staticmethod
    def orthographic(z_near, z_far):
        z_near, z_far = float(z_near), float(z_far)
        m = np.eye(4, dtype=np.float64)
        m[2, 2] = 1.0 / (z_far - z_near)
        m[2, 3] = -z_near / (z_far - z_near)
        return Transform(
            m=m.astype(np.float32), m_inv=np.linalg.inv(m).astype(np.float32)
        )

    @staticmethod
    def perspective(fov_deg, n, f):
        """Perspective projection (src/transform.rs perspective)."""
        n, f = float(n), float(f)
        persp = np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, f / (f - n), -f * n / (f - n)],
                [0.0, 0.0, 1.0, 0.0],
            ],
            np.float64,
        )
        inv_tan = 1.0 / np.tan(np.deg2rad(float(np.asarray(fov_deg))) / 2.0)
        scale = np.diag([inv_tan, inv_tan, 1.0, 1.0])
        m = scale @ persp
        return Transform(
            m=m.astype(np.float32), m_inv=np.linalg.inv(m).astype(np.float32)
        )

    # -- composition (numpy when host-side, traced-compatible) --

    def compose(self, other: "Transform") -> "Transform":
        """self ∘ other — apply ``other`` first."""
        return Transform(
            m=_matmul(self.m, other.m), m_inv=_matmul(other.m_inv, self.m_inv)
        )

    def __matmul__(self, other: "Transform") -> "Transform":
        return self.compose(other)

    def inverse(self) -> "Transform":
        return Transform(m=self.m_inv, m_inv=self.m)

    def transpose(self) -> "Transform":
        xp = np if isinstance(self.m, np.ndarray) else jnp
        return Transform(
            m=xp.swapaxes(self.m, -1, -2), m_inv=xp.swapaxes(self.m_inv, -1, -2)
        )

    # -- application (batched: p is (..., 3)) --

    def apply_point(self, p):
        ph = _apply44(self.m, p, 1.0)
        w = ph[..., 3]
        xyz = ph[..., :3]
        return jnp.where(
            (w == 1.0)[..., None], xyz, xyz / jnp.where(w == 0.0, 1.0, w)[..., None]
        )

    def apply_vector(self, v):
        return _apply44(self.m, v, 0.0)[..., :3]

    def apply_normal(self, n):
        """Normals transform by the inverse transpose (src/transform.rs)."""
        mi = jnp.swapaxes(self.m_inv, -1, -2)
        return _apply44(mi, n, 0.0)[..., :3]

    def apply_point_inv(self, p):
        ph = _apply44(self.m_inv, p, 1.0)
        w = ph[..., 3]
        xyz = ph[..., :3]
        return jnp.where(
            (w == 1.0)[..., None], xyz, xyz / jnp.where(w == 0.0, 1.0, w)[..., None]
        )

    def apply_vector_inv(self, v):
        return _apply44(self.m_inv, v, 0.0)[..., :3]

    def apply_normal_inv(self, n):
        mt = jnp.swapaxes(self.m, -1, -2)
        return _apply44(mt, n, 0.0)[..., :3]

    def swaps_handedness(self):
        """det of the upper-left 3x3 < 0 (src/transform.rs swaps_handedness)."""
        return np.linalg.det(np.asarray(self.m)[..., :3, :3]) < 0.0

    def is_identity(self):
        return bool(np.allclose(np.asarray(self.m), np.eye(4)))


def _matmul(a, b):
    """Host matrices compose in numpy; traced ones at full precision."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a @ b
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _apply44(m, v, w):
    """Apply (...,4,4) @ [v, w] over batched (...,3) v."""
    vh = jnp.concatenate([v, jnp.full_like(v[..., :1], w)], axis=-1)
    return jnp.einsum(
        "...ij,...j->...i", m, vh, precision=jax.lax.Precision.HIGHEST
    )
