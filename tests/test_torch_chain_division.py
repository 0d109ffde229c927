"""The float quotient of the line-search rollouts K2/K3 below 2^-99, emulated
in numpy, operation for operation, with subnormals kept.

Mirrors ``trajopt_torch/csrc/envs.cuh:69-90`` (``ChainOps::div``: Markstein's
quotient from y = RN(1/b), q = RN(a·y), r = RN(q·b − a), RN(q − r·y), and the
range vote that ``far()`` reads) and ``trajopt_torch/csrc/pivot.cuh:83-99``
(``PivotOps::div_moderate``, the division of ``ExactChainOps`` with which K2/K3
take a step again where the vote fell).  Each FMA is its exact result, the
product and sum taken in float64 with the sum's rounding error kept
(Knuth's two-sum), rounded once to float32; ``rcp`` is RN(1/b), which it is
for these divisors.  The divisors are the cart-pole ODE's: M_t = 0.497 and
denominators 0.3623 and 0.4488, the ends of their range.

Markstein's remainder falls under the subnormal grid below 2^-100 and is
rounded, so the quotient is then one ulp off a / b for a few percent of the
numerators: the fault the vote exists for.  Every such numerator is flagged,
none in [2^-99, 2^99) is off, and the retake's division is a / b everywhere."""

import numpy as np
import pytest

F32, F64 = np.float32, np.float64
DIVISORS = (0.497, 0.3623, 0.4488)


def fma32(x, y, z):
    """RN32(x·y + z) for float32 operands: x·y is exact in float64, the sum's
    rounding error is kept by two-sum, and where the float64 sum is a float32
    midpoint the error decides the side."""
    x, y, z = (np.asarray(v, F32) for v in (x, y, z))
    p = x.astype(F64) * y.astype(F64)
    c = np.broadcast_to(z.astype(F64), p.shape)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(F32)
    toward = np.where(s > r.astype(F64), F32(np.inf), F32(-np.inf)).astype(F32)
    other = np.nextafter(r, toward)
    mid = (r.astype(F64) != s) & ((r.astype(F64) + other.astype(F64)) * 0.5 == s) & (err != 0)
    nudged = np.nextafter(s, np.where(err > 0, np.inf, -np.inf)).astype(F32)
    return np.where(mid, nudged, r)


def markstein(a, b):
    """ChainOps::div."""
    b = F32(b)
    y = F32(1) / b
    q = a * y
    r = fma32(q, b, -a)
    return fma32(-r, y, q)


def vote(a):
    """ChainOps' range vote, numerator by numerator: with m = bits·2 as a
    uint32, m − 1 below 28·2^24 − 1 or m at least 226·2^24 (a nonzero
    numerator outside [2^-99, 2^99))."""
    m = np.asarray(a, F32).view(np.uint32) << np.uint32(1)
    return ((m - np.uint32(1)) < np.uint32((28 << 24) - 1)) | (m >= np.uint32(226 << 24))


def div_moderate(a, b):
    """PivotOps::div_moderate."""
    b = F32(b)
    y = F32(1) / b
    fa = np.abs(a)
    tiny, huge = fa < F32(2.0**-99), fa >= F32(2.0**100)
    up = np.where(tiny, F32(2.0**64), np.where(huge, F32(2.0**-64), F32(1)))
    down = np.where(tiny, F32(2.0**-64), np.where(huge, F32(2.0**64), F32(1)))
    a2 = a * up
    q = a2 * y
    z = fma32(-fma32(q, b, -a2), y, q)
    t = z * down
    d = fma32(t, -up, z)
    r2 = fma32(z, b, -a2)
    above = (r2 < 0) != (b < 0)
    fix = (np.abs(d) == F32(2.0**-86)) & (r2 != 0) & (above == (d > 0))
    tf = np.where(fix, t + np.where(d > 0, F32(2.0**-149), F32(-2.0**-149)), t)
    return np.where((a == 0) | (fa == np.inf), q * down, tf)


def numerators(lo, hi, n, seed):
    """n signed float32 numerators with exponents uniform in [lo, hi), and
    the zeros."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(1.0, 2.0, n) * 2.0 ** np.floor(rng.uniform(lo, hi, n))
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    return np.concatenate([(sign * mag).astype(F32), np.array([0.0, -0.0], F32)])


TINY = numerators(-149, -99, 6000, 0)
MODERATE = numerators(-99, 99, 6000, 1)


@pytest.mark.parametrize("b", DIVISORS)
def test_markstein_misses_a_over_b_below_the_range(b):
    with np.errstate(all="ignore"):
        off = markstein(TINY, b) != TINY / F32(b)
    assert off.any()
    assert not off[np.abs(TINY) >= F32(2.0**-100)].any()


@pytest.mark.parametrize("b", DIVISORS)
def test_vote_flags_every_miss(b):
    with np.errstate(all="ignore"):
        off = markstein(TINY, b) != TINY / F32(b)
    assert vote(TINY)[off].all()


@pytest.mark.parametrize("b", DIVISORS)
def test_markstein_is_a_over_b_where_the_vote_holds(b):
    with np.errstate(all="ignore"):
        got, want = markstein(MODERATE, b), MODERATE / F32(b)
    assert not vote(MODERATE).any()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("b", DIVISORS)
def test_retake_division_is_a_over_b(b):
    a = np.concatenate([TINY, MODERATE])
    with np.errstate(all="ignore"):
        got, want = div_moderate(a, b), a / F32(b)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
