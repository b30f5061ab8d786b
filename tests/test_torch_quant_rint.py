"""csrc/act_quant.cuh `quant8_rcp` (kernels J and M writing codes), emulated
exactly on the CPU.

quant8_rcp takes a row's codes with its reciprocal r = RN(1 / s) != 0 and
rounds without a conversion instruction: q = RN(q0 + RN(x - s q0) r) with
q0 = RN(x r) (act_quant.cuh `quotient`'s fast path, whose result is the
IEEE quotient: tests/test_torch_w8a8_fusions.py), then
t = RN(max(q, -256) + 1.5 * 2^23) and the code is t's low mantissa byte. It
must give the bits of `quant8`, clamp(rint(q), -127, 127) by cvt.rni (NaN
to 0), for every q a row can produce, and so the plain quantize's codes.
"""

import numpy as np
import torch
from test_torch_gelu_formula import _fma32

from visualcloze_tpu_torch.ops.act_quant import act_quant_plain

F32 = np.float32
MAGIC = F32(12582912.0)  # 1.5 * 2^23


def _code_by_add(q: np.ndarray) -> np.ndarray:
    """quant8_rcp's rounding of fp32 quotients q to int8 codes."""
    with np.errstate(invalid="ignore"):
        t = np.fmax(q.astype(F32), F32(-256.0)) + MAGIC  # fmaxf: NaN -> -256
    return (t.astype(F32).view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def _code_by_cvt(q: np.ndarray) -> np.ndarray:
    """quant8's: clamp(cvt.rni(q), -127, 127), NaN -> 0."""
    r = np.where(np.isnan(q), 0.0, np.rint(q.astype(np.float64)))
    return np.clip(r, -127, 127).astype(np.int8)


def test_rint_by_add_is_cvt_rni_for_every_quotient_a_row_gives():
    """Every half-integer tie and its fp32 neighbours, the largest |q| a row's
    scale allows (127 (1 + 2^-23)), zeros of both signs, tiny values, NaN,
    and a million uniform draws: each q a row can give."""
    ties = (np.arange(-255, 256) / 2.0).astype(F32)
    near = np.concatenate([ties, np.nextafter(ties, F32(np.inf)), np.nextafter(ties, F32(-np.inf))])
    edge = np.array([127.0, -127.0, 127.0 * (1 + 2.0 ** -23), -127.0 * (1 + 2.0 ** -23), 0.0, -0.0, 1e-30, -1e-30,
                     2.0 ** -149, np.nan, -np.nan], dtype=F32)
    rng = np.random.default_rng(0)
    draws = rng.uniform(-127.5, 127.5, 1 << 20).astype(F32)
    q = np.concatenate([near, edge, draws])
    # |q| <= amax / s <= 127 / (1 - 2^-24) < 127 (1 + 2^-23): s = RN(amax / 127), |x| <= amax
    q = q[np.isnan(q) | (np.abs(q) <= F32(127.0 * (1 + 2.0 ** -23)))]
    assert q.size > 1_000_000
    assert np.array_equal(_code_by_add(q), _code_by_cvt(q))


def _quant8_rcp_row(x: np.ndarray) -> tuple[np.ndarray, np.float32]:
    """A row's codes and scale as J and M compute them on the rcp path."""
    amax = np.float32(max(np.abs(x).max(), F32(1e-8)))
    s = F32(amax / F32(127.0))
    r = F32(F32(1.0) / s)
    q0 = (x * r).astype(F32)
    q = _fma32(_fma32(-q0, np.full_like(x, s), x), np.full_like(x, r), q0)
    return _code_by_add(q), s


def test_quant8_rcp_rows_are_the_plain_quantize():
    """Rows of N(0, sigma) values over 24 decades of scale, rows with one
    outlier (most codes near 0) and rows built on the codes' rounding ties:
    the emulated kernel's codes and scale equal act_quant_plain's."""
    rng = np.random.default_rng(1)
    rows = [(rng.standard_normal(3072) * 10.0 ** rng.uniform(-12, 12)).astype(F32) for _ in range(24)]
    spike = rng.standard_normal(3072).astype(F32)
    spike[17] = F32(4.0e4)
    rows.append(spike)
    s = F32(3.0) / F32(127.0)
    ties = ((rng.integers(-127, 127, 3072) + F32(0.5)) * s).astype(F32)
    ties[0] = F32(3.0)
    rows.append(ties)
    rows.append(np.zeros(3072, dtype=F32))
    for x in rows:
        codes, scale = _quant8_rcp_row(x)
        want_codes, want_scale = act_quant_plain(torch.from_numpy(x[None]))
        assert scale == want_scale.numpy()[0]
        assert np.array_equal(codes, want_codes.numpy()[0])
