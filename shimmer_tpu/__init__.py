"""shimmer-tpu: a differentiable spectral path tracer on JAX.

Ground-up JAX/XLA/Pallas reimplementation of the capabilities of
jalberse/shimmer (a Rust, CPU-only pbrt-v4-style renderer).  See SURVEY.md
at the repository root for the structural map of the reference and how each
layer corresponds to the modules here.
"""

__version__ = "0.1.0"
