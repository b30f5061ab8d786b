"""The gelu of csrc/gelu.cuh (kernels M and O), emulated on the CPU.

gelu.cuh computes gelu(tanh) of a bf16 value in fp32 as

    cube = (x * x) * x;  u = beta * fma(kappa, cube, x)
    e = 2^(|u| * 2 / ln 2);  t = fma(-2, 1 / (e + 1), 1)        # tanh|u|
    g = (0.5 * x) * (1 + copysign(t, u))                        -> bf16

with ex2.approx and rcp.approx for the power and the reciprocal. Here each
fp32 operation is emulated in numpy in that order, the two approximations by
the correctly rounded fp32 values (the card's differ from them by an ulp or
two), the fma exactly, and the result is held, for every finite bf16 input
(65,280 bit patterns), within one bf16 ulp of PyTorch's CPU
F.gelu(approximate="tanh") on bf16.

One exception, stated and counted: F.gelu forms 1 + tanh(u) from an fp32
tanh, so for u << 0 its result is a small multiple of 2^-24 times x / 2 and
follows its tanh's last bit. PyTorch's CPU tanh returns -1 for |u| above
about 8.66 (a cutoff of its vectorised tanh), where the correctly rounded
tanh is still -1 + 2^-24 (x in [-5.16, -5.06]): there F.gelu gives -0 and
any formula with a correctly rounded tanh about -1.5e-7. At those inputs
(found by computing F.gelu's own formula with a correctly rounded tanh) the
emulation is held within one ulp of that formula instead, and the test
requires them to be few. The card's check (chip_smoke.py
`check_gelu_exhaustive`, tests/test_torch_gpu.py) holds the kernels' gelu
against F.gelu on the card at every input, with no exception.
"""

import numpy as np
import torch
import torch.nn.functional as F

F32 = np.float32
BETA = F32(1.4142135623730951 * 1.1283791670955126 * 0.5)
KAPPA = F32(0.044715)
TWO_LOG2E = F32(2.8853900817779268)


def _finite_bf16() -> tuple[torch.Tensor, np.ndarray]:
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = bits[torch.isfinite(bits)]
    return x, x.float().numpy()


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c rounded once to fp32 (a, b, c fp32): the product is exact in
    fp64, the sum's rounding error is recovered exactly (TwoSum), and a sum
    that lands on an fp32 midpoint is rounded toward the exact value."""
    with np.errstate(all="ignore"):
        p = a.astype(np.float64) * b.astype(np.float64)
        c64 = c.astype(np.float64)
        s = p + c64
        bb = s - p
        err = (p - (s - bb)) + (c64 - bb)  # s + err == p + c exactly
        r = s.astype(F32)
        lo = np.nextafter(r, F32(-np.inf))
        hi = np.nextafter(r, F32(np.inf))
        r64 = r.astype(np.float64)
        mid_lo = (r64 + lo.astype(np.float64)) / 2
        mid_hi = (r64 + hi.astype(np.float64)) / 2
        fix = np.isfinite(s) & (err != 0)
        r = np.where(fix & (s == mid_lo) & (err < 0), lo, r)
        r = np.where(fix & (s == mid_hi) & (err > 0), hi, r)
    return r


def gelu_cuh(x: np.ndarray) -> np.ndarray:
    """gelu.cuh's gelu_tanh in its operation order, fp32."""
    with np.errstate(all="ignore"):
        cube = (x * x) * x
        u = BETA * _fma32(np.full_like(x, KAPPA), cube, x)
        e = np.exp2((np.abs(u) * TWO_LOG2E).astype(np.float64)).astype(F32)
        r = (1.0 / (e + F32(1)).astype(np.float64)).astype(F32)
        t = F32(1) - F32(2) * r  # fma(-2, r, 1): 2 r is exact, so one rounding either way
        return (F32(0.5) * x) * (F32(1) + np.copysign(t, u))


def f_gelu_formula_rounded_tanh(x: np.ndarray) -> np.ndarray:
    """F.gelu's own formula, 0.5 x (1 + tanh(u)) in fp32, with the fp32 tanh
    correctly rounded."""
    with np.errstate(all="ignore"):
        u = BETA * (x + KAPPA * ((x * x) * x))
        t = np.tanh(u.astype(np.float64)).astype(F32)
        return (F32(0.5) * x) * (F32(1) + t)


def _to_bf16(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, dtype=F32)).to(torch.bfloat16).float().numpy()


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps at want's magnitude (the smallest normal's below it)."""
    mag = np.maximum(np.abs(want), F32(2.0 ** -126)).astype(np.float64)
    return np.abs(got.astype(np.float64) - want.astype(np.float64)) / np.exp2(np.floor(np.log2(mag)) - 7)


def test_fma32_rounds_once():
    """The fma emulation against exact rational arithmetic, ties included."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.standard_normal(2000).astype(F32)
    b = (rng.standard_normal(2000) * 8).astype(F32)
    c = (rng.standard_normal(2000) * np.exp2(rng.integers(-30, 30, 2000))).astype(F32)
    # exact ties: 1 + 2^-24 (a midpoint of fp32) plus a tiny term of either sign
    a[:2] = F32(1.0)
    b[:2] = F32(2.0 ** -24)
    c[:2] = F32(1.0)
    c[2:4] = F32(1.0 + 2.0 ** -23)
    a[2:4] = F32(2.0 ** -24)
    b[2:4] = np.array([1.0, -1.0], dtype=F32)
    got = _fma32(a, b, c)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, F32(-np.inf)), lo, np.nextafter(lo, F32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        ok = [v for v, e in zip(cands, errs) if e == best]
        want = ok[0] if len(ok) == 1 else [v for v in ok if (v.view(np.uint32) & 1) == 0][0]
        assert got[i] == want, (i, a[i], b[i], c[i], got[i], want)


def test_gelu_cuh_formula_is_within_one_bf16_ulp_of_f_gelu_on_every_bf16():
    x_bf16, x = _finite_bf16()
    assert x.size == 65280
    ref = F.gelu(x_bf16, approximate="tanh").float().numpy()
    got = _to_bf16(gelu_cuh(x))
    rounded = _to_bf16(f_gelu_formula_rounded_tanh(x))
    # where F.gelu departs from its own formula with a correctly rounded tanh
    own = _ulps(rounded, ref) > 1
    ulps_f = _ulps(got, ref)
    ulps_own = _ulps(got, rounded)
    differ = int((got != ref).sum())
    print(f"gelu.cuh emulated: {differ} of {x.size} bf16 results differ from F.gelu's; largest {ulps_f[~own].max()} "
          f"ulps; {int(own.sum())} inputs where F.gelu is off its formula with a correctly rounded tanh "
          f"(x = {sorted(set(x[own].tolist()))})")
    assert bool((ulps_f[~own] <= 1).all()), x[~own][ulps_f[~own] > 1][:10]
    assert bool((ulps_own[own] <= 1).all())
    assert int(own.sum()) <= 8 and bool((x[own] < -4).all())
    assert differ <= 200



def test_the_exact_identity_would_leave_f_gelu():
    """Why gelu.cuh keeps 1 + tanh(u) in fp32: the exact identity
    x / (1 + e^(-2u)), emulated in fp32, lands more than one bf16 ulp from
    F.gelu at many inputs below x = -4, where F.gelu's 1 + tanh(u) is a small
    multiple of 2^-24."""
    x_bf16, x = _finite_bf16()
    ref = F.gelu(x_bf16, approximate="tanh").float().numpy()
    with np.errstate(all="ignore"):
        u = BETA * _fma32(np.full_like(x, KAPPA), (x * x) * x, x)
        e = np.exp((F32(-2) * u).astype(np.float64)).astype(F32)
        exact = (x.astype(np.float64) / (F32(1) + e).astype(np.float64)).astype(F32)
    far = _ulps(_to_bf16(exact), ref) > 1
    print(f"x / (1 + e^(-2u)): {int(far.sum())} bf16 inputs more than one ulp from F.gelu")
    assert int(far.sum()) > 100 and bool((x[far] < -4).all())
