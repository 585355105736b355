"""Numeric and capacity constants for the collision pipeline.

A copy of `robocheck_tpu.core.constants` (the port imports nothing of the JAX
package). The tolerance semantics replicate the reference CUDA implementation
(`narrow-phase/narrow-phase.hu:14` TOL=1e-6 and the relative `isclose` of
`narrow-phase.cu:24-35`) so that verdicts agree bit-for-bit with the tagged
golden datasets.

Capacity constants mirror the reference's constant-memory sizing
(`Utils_rai.h:98-99`: 792 vertices / 1008 triangles for the alpha-puzzle pair),
but here they are *defaults*, not hard limits: the mesh tables pad triangle
counts up to a multiple of 128 (the obstacle group size of the kernel's tile
gate) and mask the padding.
"""

# Relative tolerance used by isclose / the ±TOL no-overlap band
# (reference: narrow-phase.hu:14).
TOL = 1e-6

# Alpha-puzzle mesh sizes (reference: Utils_rai.h:98-99).
ALPHA_NUM_VERTICES = 792
ALPHA_NUM_TRIANGLES = 1008

# Padding multiple of the mesh tables (one obstacle group of the tile gate).
LANE = 128


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
