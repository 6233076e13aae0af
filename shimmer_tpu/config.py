"""Global numeric configuration.

The reference selects f32/f64 at compile time (``Float`` alias,
/root/reference/src/float.rs:2-4).  On the device the compute dtype is
float32; film accumulation can optionally be float64 on CPU for
bit-fidelity tests.
"""

from __future__ import annotations

import numpy as np

# Compute dtype for all geometry / shading math (numpy dtypes are
# jnp-compatible; importing this module must not touch a device).
float_dtype = np.float32

# Index dtype for BVH links, primitive ids, material ids.
int_dtype = np.int32

# Machine constants mirroring /root/reference/src/float.rs:10-23.
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
MACHINE_EPSILON = 1.1920929e-7 * 0.5  # f32 eps / 2

# Shadow-ray epsilon (reference: src/integrator.rs:109-117 uses 1e-4 via
# ``unoccluded`` with t_max = 0.6.. * dist; origin offset handles the rest).
SHADOW_EPSILON = 1e-4


def gamma(n) -> float:
    """Conservative floating-point error bound (n * eps / (1 - n * eps)).

    Reference: /root/reference/src/float.rs:131-136.
    """
    return (n * MACHINE_EPSILON) / (1.0 - n * MACHINE_EPSILON)
