"""The soft blocking sigma pair's work and the card's bound on it, for ``kernels.blocking_roofline``.

The work of one launch on the compacted route (``M`` heliostats, ``N`` rays and ``P``
points a heliostat, ``K`` candidate slots a heliostat), from the counts that
:func:`benchmark.reference.aim_point.chunk_pair_counts` takes on the reference's rays:
the kept slots, the heliostats with one (``needed``), the kept (ray, slot) pairs, and
the pairs whose sigma is exactly 0 (``zero``; in the backward also those whose ray
carries no power, ``zero_or_dark``, since its cotangent is 0). A pair needs
:data:`FORWARD_OPS_PER_PAIR` or :data:`BACKWARD_OPS_PER_PAIR` fp32 operations, one whose
sigma is exactly 0 only its geometry and the test, :data:`ZERO_PAIR_OPS`. Each input
byte counts once and each output byte once; a heliostat without a kept slot reads no
ray:

- forward: sigma written (4 B a ray), each slot's keep read (4 B), and where needed the
  ray's direction and target distance (20 B a ray), the points (16 B) and the kept
  slots' 16 columns (64 B);
- backward: the direction and origin cotangents written (16 B a ray and a point), each
  slot's column cotangents written and keep read (68 B), and where needed direction,
  target distance and sigma's cotangent (24 B a ray), the points and the kept columns.

The bound is the larger of the bytes over the card's bandwidth and the operations over
its fp32 rate (:func:`benchmark.roofline.bound_ms`).
"""

from __future__ import annotations

from benchmark.roofline import bound_ms

# Forward: six 3-vector dots 30, reciprocal 1, t 2, the two projections 6, the two local
# coordinates 8, the five exponents' arguments 8, five exponentials 5, three gate
# denominators 7, sigma 3, the keep-weighted sum 2; backward: the forward's 70 before the
# sum, then base 2, the three gate slopes 11, the projection and t cotangents 12, o.n, d.n,
# d.u, d.v 6, the six ray cotangents 36, the 16 candidate cotangents 41, their sum 16.
FORWARD_OPS_PER_PAIR = 72
BACKWARD_OPS_PER_PAIR = 194
# A pair whose sigma is exactly 0: the forward's 47 up to the local coordinates, the five
# exponents' arguments 8, two maxima and three comparisons 5.
ZERO_PAIR_OPS = 60


def sigma_bytes(kind: str, work: dict) -> float:
    heliostats, rays, points, slots = work["heliostats"], work["rays"], work["points"], work["slots"]
    needed, kept = work["needed"], work["kept_slots"]
    if kind == "forward":
        return 4 * heliostats * rays + 4 * heliostats * slots + needed * (20 * rays + 16 * points) + 64 * kept
    return (16 * heliostats * rays + 16 * heliostats * points + 68 * heliostats * slots
            + needed * (24 * rays + 16 * points) + 64 * kept)


def sigma_ops(kind: str, work: dict) -> float:
    zero = work["zero"] if kind == "forward" else work["zero_or_dark"]
    per_pair = FORWARD_OPS_PER_PAIR if kind == "forward" else BACKWARD_OPS_PER_PAIR
    return per_pair * (work["kept_pairs"] - zero) + ZERO_PAIR_OPS * zero


def sigma_bound_ms(kind: str, work: dict) -> float:
    """The least time of one ``kind`` ("forward" or "backward") launch on ``work``, in ms."""
    return bound_ms(sigma_bytes(kind, work), sigma_ops(kind, work))[0]
