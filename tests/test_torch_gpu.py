"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips without a CUDA device. This file imports no JAX,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q -m gpu
"""

import math

import pytest
import torch

from visualcloze_tpu_torch.ops import conv2d as tconv
from visualcloze_tpu_torch.ops import flash_attention as tfa
from visualcloze_tpu_torch.ops.attention import mask_to_bias


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


def _ulps_tol(want, ulps=4):
    """`ulps` bf16 ulps at the largest |want| (8 significant bits)."""
    top = want.abs().max().item()
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


def _attn_case(dev, seed, b, h, L, padded, lk=None):
    """N(0,1) bf16 q, k, v, dO; padded: batch 0 loses its last 100 keys (and
    their query rows' dO, as attention() zeroes them), batch 1 every key.
    lk: a key length other than L (no padding then)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if lk is not None:
        q, do = (torch.randn((b, h, L, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, h, lk, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        return q, k, v, do, None
    q, k, v, do = (torch.randn((b, h, L, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
    bias = None
    if padded:
        mask = torch.ones((b, L), dtype=torch.int32, device=dev)
        mask[0, L - 100:] = 0
        mask[1] = 0
        bias = mask_to_bias(mask)
        do = do * mask[:, None, :, None].to(do.dtype)
    return q, k, v, do, bias


@pytest.mark.gpu
@pytest.mark.parametrize("L, padded, lk", [(1000, False, None), (1000, True, None), (300, False, 1000),
                                           (300, False, 40), (4097, False, None), (4097, True, None)])
def test_gpu_flash_attn_fwd_and_lse_match_plain(L, padded, lk):
    """Kernels D and E against their plain version; E's LSE within 2^-13 of
    the largest |LSE| (fp32 sums of 128 products in another order: ~1e-5);
    also with 300 queries against 1000 keys, against 40 keys (less than one
    key tile), and at lengths that are multiples of no tile (1000, 4097); a
    batch whose keys are all masked gives exactly 0 and lse -1e30."""
    dev = _cuda_or_skip()
    b, h = 2, 4
    q, k, v, _, bias = _attn_case(dev, 3, b, h, L, padded, lk)
    got = tfa.flash_attn_fwd(q, k, v, bias)
    o, lse = tfa.flash_attn_fwd_lse(q, k, v, bias)
    torch.cuda.synchronize()
    want, want_lse = tfa.flash_fwd_lse_plain(q, k, v, bias)
    tol = _ulps_tol(want)
    _close(got, want, tol)
    assert torch.equal(o, got)  # one kernel body: E's output is D's
    live = want_lse > -1e29
    _close(lse[live], want_lse[live], 2.0 ** -13 * want_lse[live].abs().max().item())
    if padded:
        assert (got[1] == 0).all() and (lse[1] == -1e30).all()
        s = torch.matmul(q[:1].float(), k[:1, :, : L - 100].float().transpose(-1, -2)) * 128 ** -0.5
        _close(got[:1], torch.matmul(torch.softmax(s, dim=-1), v[:1, :, : L - 100].float()), tol)


def _bwd_case(dev, seed, L, padded, lk):
    """F's inputs: a case of _attn_case with the plain forward's lse and
    delta = rowsum(dO * O)."""
    q, k, v, do, bias = _attn_case(dev, seed, 2, 4, L, padded, lk)
    o, lse = tfa.flash_fwd_lse_plain(q, k, v, bias)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, bias, do, lse, delta


@pytest.mark.gpu
@pytest.mark.parametrize("L, padded, lk", [(1000, False, None), (1000, True, None), (300, False, 1000),
                                           (300, False, 40), (4097, False, None), (4097, True, None)])
def test_gpu_flash_attn_bwd_matches_plain(L, padded, lk):
    """Kernels F-dq and F-dkv against their plain versions, fed the same lse
    and delta: 4 bf16 ulps at each output's largest element. Also with 300
    queries against 1000 keys, as a ring chunk would pass them, against 40
    keys (less than one key tile), and at lengths that are multiples of no
    tile (1000, 4097); masked keys get exactly zero."""
    dev = _cuda_or_skip()
    args = _bwd_case(dev, 4, L, padded, lk)
    dq = tfa.flash_attn_bwd_dq(*args)
    dk, dv = tfa.flash_attn_bwd_dkv(*args)
    torch.cuda.synchronize()
    want_dq = tfa.flash_bwd_dq_plain(*args)
    want_dk, want_dv = tfa.flash_bwd_dkv_plain(*args)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        _close(got, want, _ulps_tol(want))
    if padded:  # masked keys get no gradient
        assert (dk[0, :, L - 100:] == 0).all() and (dv[0, :, L - 100:] == 0).all()
        assert (dk[1] == 0).all() and (dv[1] == 0).all()


@pytest.mark.gpu
def test_gpu_flash_attn_bwd_is_deterministic():
    """Two launches of F-dq and F-dkv on the same inputs give the same bits
    (no atomics: every sum is taken in a fixed order)."""
    dev = _cuda_or_skip()
    args = _bwd_case(dev, 6, 1000, True, None)
    first = (tfa.flash_attn_bwd_dq(*args),) + tfa.flash_attn_bwd_dkv(*args)
    second = (tfa.flash_attn_bwd_dq(*args),) + tfa.flash_attn_bwd_dkv(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_flash_mha_grads_match_autograd_oracle():
    """FlashMHA (E forward, F backward) against torch.autograd through the
    fp32 oracle mha_xla: relative RMS error of each gradient within 2%."""
    from visualcloze_tpu_torch.ops.attention import mha_xla

    dev = _cuda_or_skip()
    q, k, v, do, bias = _attn_case(dev, 5, 2, 4, 700, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(tfa.flash_mha(*leaves, bias), leaves, do)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(mha_xla(*ref, bias), ref, do.float())
    for gk, gw in zip(grads, want):
        rel = (gk.float() - gw).pow(2).mean().sqrt() / gw.pow(2).mean().sqrt()
        assert rel.item() <= 2e-2, rel.item()


def _rope_case(dev, seed, L):
    """Kernel A's inputs: N(0,1) bf16 q, k, v of (2, 4, L, 128), RoPE tables,
    and a bias by which batch 0 loses its last 100 keys, batch 1 every key."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, d = 2, 4, 128
    q, k, v = (torch.randn((b, h, L, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    ang = torch.rand((b, L, d // 2), generator=g, device=dev) * 6.0
    mask = torch.ones((b, L), dtype=torch.int32, device=dev)
    mask[0, L - 100:] = 0
    mask[1] = 0
    return q, k, v, mask_to_bias(mask), torch.cos(ang), torch.sin(ang)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1000, 4097])
def test_gpu_flash_attn_rope_matches_plain(L):
    dev = _cuda_or_skip()
    q, k, v, bias, cos, sin = _rope_case(dev, 0, L)
    got = tfa.flash_attn_rope(q, k, v, bias, cos, sin)
    torch.cuda.synchronize()
    want = tfa.flash_attention_plain(q, k, v, bias, cos, sin)
    tol = _ulps_tol(want)  # roundings of q, k, P and o to bf16: measured 1-2 ulps
    _close(got, want, tol)
    assert (got[1] == 0).all()
    # batch 0 against fp32 attention that never sees its 100 padded keys
    n = L - 100
    q32, k32 = (tfa._rot_half(t[:1].float(), cos[:1], sin[:1]) for t in (q, k))
    s = torch.matmul(q32, k32[..., :n, :].transpose(-1, -2)) * 128 ** -0.5
    _close(got[:1], torch.matmul(torch.softmax(s, dim=-1), v[:1, :, :n].float()), tol)


def _kept_keys_attention(q, k, v, keep):
    """fp32 softmax(q k[keep]^T / sqrt(D)) v[keep] for one batch row (H, L, D)."""
    s = torch.matmul(q.float(), k[:, keep].float().transpose(-1, -2)) * 128 ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v[:, keep].float())


@pytest.mark.gpu
def test_gpu_flash_attn_fwd_masks_keys_inside_the_sequence():
    """Keys masked inside a sequence 33 key tiles long, not only at its end:
    batch 0 loses its middle third (a padded image between real tokens),
    batch 1 every third key, so the bias of each key tile differs from the
    next tiles'. A, D and E against their plain versions, and each batch
    against fp32 attention that never sees its masked keys."""
    dev = _cuda_or_skip()
    b, h, L = 2, 4, 4097
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn((b, h, L, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    ang = torch.rand((b, L, 64), generator=g, device=dev) * 6.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    mask = torch.ones((b, L), dtype=torch.int32, device=dev)
    mask[0, L // 3: 2 * L // 3] = 0
    mask[1, ::3] = 0
    bias = mask_to_bias(mask)
    got = tfa.flash_attn_fwd(q, k, v, bias)
    o, lse = tfa.flash_attn_fwd_lse(q, k, v, bias)
    got_a = tfa.flash_attn_rope(q, k, v, bias, cos, sin)
    torch.cuda.synchronize()
    want, want_lse = tfa.flash_fwd_lse_plain(q, k, v, bias)
    tol = _ulps_tol(want)
    _close(got, want, tol)
    assert torch.equal(o, got)
    _close(lse, want_lse, 2.0 ** -13 * want_lse.abs().max().item())
    want_a = tfa.flash_attention_plain(q, k, v, bias, cos, sin)
    tol_a = _ulps_tol(want_a)
    _close(got_a, want_a, tol_a)
    qr, kr = (tfa._rot_half(t.float(), cos, sin) for t in (q, k))
    for i in range(b):
        keep = mask[i] > 0
        _close(got[i], _kept_keys_attention(q[i], k[i], v[i], keep), tol)
        _close(got_a[i], _kept_keys_attention(qr[i], kr[i], v[i], keep), tol_a)


@pytest.mark.gpu
def test_gpu_flash_attn_fwd_is_deterministic():
    """Two launches of A, D and E on the same inputs give the same bits
    (every sum is taken in a fixed order)."""
    dev = _cuda_or_skip()
    q, k, v, bias, cos, sin = _rope_case(dev, 7, 1000)
    for run in (lambda: (tfa.flash_attn_rope(q, k, v, bias, cos, sin),),
                lambda: (tfa.flash_attn_fwd(q, k, v, bias),),
                lambda: tfa.flash_attn_fwd_lse(q, k, v, bias)):
        first, second = run(), run()
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_flash_attn_d512_matches_plain():
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((1, 1, 1100, 512), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    got = tfa.flash_attn_d512(q, k, v)
    torch.cuda.synchronize()
    want = tfa.flash_attention_plain(q, k, v)
    _close(got, want, _ulps_tol(want))


@pytest.mark.gpu
@pytest.mark.parametrize("shape, pre", [((1, 20, 36, 128, 128), True), ((1, 12, 24, 256, 512), True),
                                        ((1, 16, 16, 512, 512), False)])
def test_gpu_conv3x3_matches_plain(shape, pre):
    dev = _cuda_or_skip()
    B, H, W, C, Co = shape
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((B, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, C, Co), generator=g, device=dev) * C ** -0.5 / 3).to(torch.bfloat16)
    b = torch.randn((Co,), generator=g, device=dev) * 0.1
    aff = None
    if pre:
        aff = (torch.rand((B, C), generator=g, device=dev) + 0.5, torch.randn((B, C), generator=g, device=dev))
    act = "swish" if pre else "none"
    torch.backends.cudnn.allow_tf32 = False
    got = tconv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act=act)
    torch.cuda.synchronize()
    want = tconv.conv3x3_plain(x, w, b, aff, act)
    _close(got, want, 1e-2 * want.abs().max().item())  # bf16 in, fp32 sums in another order


@pytest.mark.gpu
@pytest.mark.parametrize("b, h, L", [(2, 1, 1100), (1, 1, 17), (1, 2, 300), (2, 3, 65)])
def test_gpu_flash_attn_d512_edge_cases(b, h, L):
    """Kernel C against its plain version (4 bf16 ulps) where the tiles are
    ragged: several batches and heads, a length that is a multiple of no
    tile (1100, 300, 65: the last 32-key tile masked, the last 64-row query
    tile cut) and one shorter than a single tile (17)."""
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(L + b)
    q, k, v = (torch.randn((b, h, L, 512), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    got = tfa.flash_attn_d512(q, k, v)
    torch.cuda.synchronize()
    want = tfa.flash_attention_plain(q, k, v)
    _close(got, want, _ulps_tol(want))


@pytest.mark.gpu
def test_gpu_flash_attn_d512_is_deterministic():
    """Two launches of kernel C on the same inputs give the same bits."""
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((2, 1, 1100, 512), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    first, second = tfa.flash_attn_d512(q, k, v), tfa.flash_attn_d512(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _conv_inputs(dev, shape, pre, b0_scale=1.0, seed=2):
    B, H, W, C, Co = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, C, Co), generator=g, device=dev) * (9 * C) ** -0.5).to(torch.bfloat16)
    b = torch.randn((Co,), generator=g, device=dev) * 0.1
    aff = None
    if pre:
        aff = (torch.rand((B, C), generator=g, device=dev) + 0.5,
               torch.randn((B, C), generator=g, device=dev) * b0_scale)
    return x, w, b, aff


@pytest.mark.gpu
@pytest.mark.parametrize("shape, act", [
    ((1, 3, 5, 128, 128), "swish"),      # smaller than one 4 x 64 tile
    ((2, 37, 91, 128, 128), "swish"),    # rows and columns off the tile, two images
    ((1, 24, 72, 512, 256), "swish"),    # the decoder's 512 -> 256 transition
    ((1, 48, 144, 256, 128), "swish"),   # the decoder's 256 -> 128 transition
    ((1, 20, 130, 128, 256), "swish"),   # the encoder's 128 -> 256 transition
    ((1, 21, 66, 512, 512), "none"),     # the upsample conv: no affine, no activation
    ((1, 9, 70, 24, 40), "swish"),       # channel counts that are multiples of 8 only
    ((1, 9, 70, 24, 40), "affine"),      # the affine without the activation
])
def test_gpu_conv3x3_edge_cases(shape, act):
    """Kernel B against its plain version (1% of the largest output) on
    ragged tiles, the VAE's channel transitions, act "none", the affine
    alone, and channel counts that fill no 64-channel chunk."""
    dev = _cuda_or_skip()
    x, w, b, aff = _conv_inputs(dev, shape, act != "none")
    kw = dict(pre_affine=aff, act="none" if act == "affine" else act)
    torch.backends.cudnn.allow_tf32 = False
    got = tconv.conv3x3_gn_swish(x, w, b, **kw)
    torch.cuda.synchronize()
    want = tconv.conv3x3_plain(x, w, b, aff, kw["act"])
    assert got.shape == want.shape
    _close(got, want, 1e-2 * want.abs().max().item())


@pytest.mark.gpu
def test_gpu_conv3x3_zeroes_the_border_after_swish():
    """With a large b0, swish(b0) is far from 0 on the image border: kernel B
    must zero-pad AFTER the activation, as the plain version does. The
    other order (padding x, then the activation) lands outside the
    tolerance, so the check can tell them apart."""
    dev = _cuda_or_skip()
    x, w, b, aff = _conv_inputs(dev, (1, 37, 91, 128, 128), True, b0_scale=4.0, seed=5)
    torch.backends.cudnn.allow_tf32 = False
    got = tconv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act="swish")
    torch.cuda.synchronize()
    want = tconv.conv3x3_plain(x, w, b, aff, "swish")
    tol = 1e-2 * want.abs().max().item()
    _close(got, want, tol)
    a, b0 = aff
    act = x.float() * a[:, None, None, :] + b0[:, None, None, :]
    act = torch.nn.functional.pad((act * torch.sigmoid(act)).permute(0, 3, 1, 2), (1, 1, 1, 1), value=0.0)
    swish_b0 = (b0 * torch.sigmoid(b0))[:, :, None, None]
    act[:, :, 0, :] = swish_b0[:, :, 0]
    act[:, :, -1, :] = swish_b0[:, :, 0]
    act[:, :, :, 0] = swish_b0[:, :, :, 0]
    act[:, :, :, -1] = swish_b0[:, :, :, 0]  # the wrong order: the padding's zeros went through the affine + swish
    wrong = torch.nn.functional.conv2d(act.to(torch.bfloat16).float(), w.permute(3, 2, 0, 1).float()) + b[:, None, None]
    assert (wrong.permute(0, 2, 3, 1) - want.float()).abs().max().item() > tol


@pytest.mark.gpu
def test_gpu_conv3x3_is_deterministic():
    """Two launches of kernel B on the same inputs give the same bits."""
    dev = _cuda_or_skip()
    x, w, b, aff = _conv_inputs(dev, (1, 37, 91, 256, 128), True)
    first = tconv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act="swish")
    second = tconv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act="swish")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _int8_case(dev, m, k, n):
    """N(0,1) bf16 x, uniform int8 w, scale d_in^-0.5 / 127 times a factor
    per column in [0.5, 1.5) (so a column mixed up with another shows)."""
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    scale = (torch.rand((n,), generator=g, device=dev) + 0.5) * k ** -0.5 / 127
    return x, w, scale


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", [(1, 3072, 18432), (333, 3072, 9216), (3456, 3072, 64), (3968, 3072, 21504),
                                     (16, 3072, 3072), (17, 3072, 3072), (64, 3072, 272), (129, 256, 16),
                                     (300, 64, 512), (200, 15360, 3072), (5, 15360, 64), (2, 64, 16),
                                     (17, 3072, 64), (129, 3072, 3072), (257, 3072, 3072), (257, 3072, 64)])
def test_gpu_int8_matmul_matches_plain(m, k, n):
    """Kernel G against its plain version: the modulation GEMV (M = 1), a
    ragged M, final_layer.linear (N = 64), linear1; M on both sides of the
    GEMV body's threshold (16, 17) and at 64 and 129; N = 16 and 272 (not a
    multiple of the 256-column tile); K = 64 (one stage) and 15360; the edges
    of the wide body's 2-CTA clusters along M (17 and 129: a pair whose
    second CTA has no rows or one; 257: an odd count of 128-row tiles), also
    at N = 64. 4 bf16
    ulps of the largest output (fp32 sums of K exact products in another
    order); the fp32 output within 1e-5 of it, times K / 3072 above K = 3072
    (the rounding of a sum grows with its terms)."""
    from visualcloze_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

    dev = _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    x, w, scale = _int8_case(dev, m, k, n)
    got = int8_matmul(x, w, scale)
    got32 = int8_matmul(x, w, scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = int8_matmul_plain(x, w, scale, torch.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _close(got, want, _ulps_tol(want))
    _close(got32, want, 1e-5 * max(1.0, k / 3072) * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", [(1, 3072, 18432), (7, 3072, 3072), (333, 3072, 9216), (129, 3072, 64),
                                     (257, 3072, 3072)])
def test_gpu_int8_matmul_is_deterministic(m, k, n):
    """Two launches of kernel G give the same bits, in its GEMV body (M = 1,
    M = 7) and its wide body."""
    from visualcloze_tpu_torch.ops.int8_matmul import int8_matmul

    dev = _cuda_or_skip()
    x, w, scale = _int8_case(dev, m, k, n)
    for out_dtype in (torch.bfloat16, torch.float32):
        first = int8_matmul(x, w, scale, out_dtype=out_dtype)
        second = int8_matmul(x, w, scale, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def _int4_case(dev, m, k, n, group):
    """N(0,1) bf16 x, uniform packed bytes (every nibble), one scale per
    (group, column) uniform over [0.75, 1.25] x d_in^-0.5 / 7."""
    g = torch.Generator(device=dev).manual_seed(5 * m + n + k)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    scale = (torch.rand((k // group, n), generator=g, device=dev) * 0.5 + 0.75) * (k ** -0.5 / 7)
    return x, w, scale


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n, group", [(1, 3072, 18432, 128), (3, 256, 3072, 128), (16, 3072, 3072, 128),
                                            (17, 768, 3072, 128), (333, 3072, 9216, 128), (3456, 3072, 64, 128),
                                            (129, 256, 16, 128), (300, 64, 272, 64), (200, 15360, 3072, 128),
                                            (5, 15360, 64, 128), (300, 512, 1024, 256), (17, 3072, 3072, 128),
                                            (17, 3072, 64, 128), (129, 3072, 3072, 128), (257, 3072, 3072, 128),
                                            (257, 3072, 64, 128), (512, 12288, 3072, 128)])
def test_gpu_int4_matmul_matches_plain(m, k, n, group):
    """Kernel G4 against its plain version: the modulation GEMV, M on both
    sides of the GEMV body's threshold, final_layer.linear (N = 64), N = 16
    and 272 (not a multiple of the 256-column tile), K = 64 in one group of
    64, K = 15360, a group of 256; the edges of the 2-CTA clusters along M
    (17 and 129: a pair whose second CTA has no rows or one; 257: an odd
    count of 128-row tiles), also at N = 64, and the text stream's linear2.
    4 bf16 ulps of the largest output (fp32
    sums of the same bf16 products in another order); the fp32 output within
    1e-5 of it, times K / 3072 above K = 3072."""
    from visualcloze_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain

    dev = _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    x, w, scale = _int4_case(dev, m, k, n, group)
    got = int4_matmul(x, w, scale)
    got32 = int4_matmul(x, w, scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = int4_matmul_plain(x, w, scale, torch.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _close(got, want, _ulps_tol(want))
    _close(got32, want, 1e-5 * max(1.0, k / 3072) * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", [(1, 3072, 18432), (7, 3072, 3072), (333, 3072, 9216), (129, 3072, 64),
                                     (257, 3072, 3072)])
def test_gpu_int4_matmul_is_deterministic(m, k, n):
    """Two launches of kernel G4 give the same bits, in both bodies."""
    from visualcloze_tpu_torch.ops.int4_matmul import int4_matmul

    dev = _cuda_or_skip()
    x, w, scale = _int4_case(dev, m, k, n, 128)
    for out_dtype in (torch.bfloat16, torch.float32):
        first = int4_matmul(x, w, scale, out_dtype=out_dtype)
        second = int4_matmul(x, w, scale, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.gpu
def test_gpu_int4_quantizer_matches_the_cpu_bit_for_bit():
    """quantize_weight_int4 on the card gives the CPU's codes and scales (the
    JAX package's, tests/test_torch_int4.py)."""
    from visualcloze_tpu_torch.models.quant import quantize_weight_int4

    dev = _cuda_or_skip()
    w = torch.randn((3072, 1024), generator=torch.Generator().manual_seed(0)) * 0.02
    cpu, card = quantize_weight_int4(w), quantize_weight_int4(w.to(dev))
    for key in ("w_int4", "w_scale"):
        assert torch.equal(cpu[key], card[key].cpu()), key


def _w8a8_case(dev, m, k, n):
    """Codes uniform over [-127, 127] (act_quant_int8's and the weight
    quantizer's range), x_scale uniform, w_scale d_in^-0.5 / 127 times a
    factor per column in [0.5, 1.5)."""
    g = torch.Generator(device=dev).manual_seed(3 * m + n + k)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    x_scale = torch.rand((m,), generator=g, device=dev) * 0.05 + 1e-3
    w_scale = (torch.rand((n,), generator=g, device=dev) + 0.5) * k ** -0.5 / 127
    return a, w, x_scale, w_scale


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", [(3968, 3072, 21504), (3456, 12288, 3072), (512, 3072, 9216), (4097, 128, 16),
                                     (1, 3072, 3072), (129, 15360, 272), (200, 256, 144)])
def test_gpu_w8a8_matmul_matches_plain_bit_for_bit(m, k, n):
    """Kernel H equals its plain version bit for bit (exact int32 sums, the
    same fp32 rescale, one rounding, the bias as a bf16 add), with and
    without a bias, and twice launched gives the same bits: linear1, mlp.2,
    the text stream's qkv; ragged M (4097, 1, 129, 200), N not a multiple of
    the 256-column tile (16, 272, 144), K of one stage (128) and 15360."""
    from visualcloze_tpu_torch.ops.w8a8_matmul import w8a8_matmul, w8a8_matmul_plain

    dev = _cuda_or_skip()
    a, w, xs, ws = _w8a8_case(dev, m, k, n)
    bias = torch.randn((n,), device=dev).to(torch.bfloat16)
    for b in (None, bias):
        got = w8a8_matmul(a, w, xs, ws, b)
        again = w8a8_matmul(a, w, xs, ws, b)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        assert torch.equal(got, w8a8_matmul_plain(a, w, xs, ws, b))
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3072, 12288])
@pytest.mark.parametrize("n", [64, 3072, 9216])
@pytest.mark.parametrize("m", [7, 129, 333, 512, 4097])
def test_gpu_w8a8_matmul_grid_is_bit_exact_and_deterministic(m, n, k):
    """Kernel H over a grid of shapes, with and without a bias: M 7 (a
    cluster whose second CTA has no rows), 129 (one row in it), 333, 512
    (the text stream, 128-column tiles) and 4097 (an odd count of 128-row
    tiles); N 64 (less than half a tile), 3072 and 9216; K 3072 and 12288.
    Equal to the plain version bit for bit, and a second launch gives the
    same bits."""
    from visualcloze_tpu_torch.ops.w8a8_matmul import w8a8_matmul, w8a8_matmul_plain

    dev = _cuda_or_skip()
    a, w, xs, ws = _w8a8_case(dev, m, k, n)
    bias = (torch.randn((n,), device=dev) * 0.1).to(torch.bfloat16)
    for b in (None, bias):
        got = w8a8_matmul(a, w, xs, ws, b)
        again = w8a8_matmul(a, w, xs, ws, b)
        torch.cuda.synchronize()
        assert torch.equal(got, w8a8_matmul_plain(a, w, xs, ws, b))
        assert torch.equal(got, again)


@pytest.mark.gpu
def test_gpu_w8a8_matmul_refuses_what_it_cannot_take():
    from visualcloze_tpu_torch.ops.w8a8_matmul import w8a8_matmul

    dev = _cuda_or_skip()
    a, w, xs, ws = _w8a8_case(dev, 64, 192, 64)  # K not a multiple of 128
    with pytest.raises(ValueError, match="K a multiple of 128"):
        w8a8_matmul(a, w, xs, ws)
    a, w, xs, ws = _w8a8_case(dev, 64, 256, 24)  # N not a multiple of 16
    with pytest.raises(ValueError, match="N of 16"):
        w8a8_matmul(a, w, xs, ws)


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, dtype, smooth", [(3456, 3072, torch.float32, False), (3968, 15360, torch.bfloat16, True),
                                                 (512, 12288, torch.bfloat16, False), (3, 8, torch.float32, True),
                                                 (1, 3072, torch.bfloat16, True)])
def test_gpu_act_quant_int8_matches_plain_bit_for_bit(m, k, dtype, smooth):
    """Kernel I equals its plain version bit for bit (an IEEE division, round
    half to even) and twice launched gives the same bits; an all-zero row
    gives codes 0 and scale 1e-8 / 127."""
    from visualcloze_tpu_torch.ops.act_quant import act_quant_int8, act_quant_plain

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(m + k)
    x = torch.randn((m, k), generator=g, device=dev) * 3.0
    x[:, k // 2] *= 50.0
    x[m - 1] = 0.0
    x = x.to(dtype)
    a_sinv = torch.rand((k,), generator=g, device=dev) * 4.8 + 0.2 if smooth else None
    codes, scale = act_quant_int8(x, a_sinv)
    again = act_quant_int8(x, a_sinv)
    torch.cuda.synchronize()
    want_codes, want_scale = act_quant_plain(x, a_sinv)
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)
    assert torch.equal(codes, again[0]) and torch.equal(scale, again[1])
    assert not codes[m - 1].any()


@pytest.mark.gpu
def test_gpu_weight_quantizer_matches_the_cpu_bit_for_bit():
    """quantize_linear_int8 on the card gives the CPU's (and so JAX's) codes
    and scales: its division by 127 is a tensor division, not the
    reciprocal multiply PyTorch uses for a Python scalar on CUDA."""
    from visualcloze_tpu_torch.models.quant import quantize_linear_int8

    dev = _cuda_or_skip()
    w = torch.randn((3072, 1024), generator=torch.Generator().manual_seed(9)) * 0.02
    got, want = quantize_linear_int8({"w": w.to(dev)}), quantize_linear_int8({"w": w})
    for key in ("w_int8", "w_scale"):
        assert torch.equal(got[key].cpu(), want[key]), key


@pytest.mark.gpu
def test_gpu_w8a8_linear_launches_i_then_h():
    """A W8A8Linear on the card: I then H once each per call, the same bits
    as the layer through the plain versions."""
    import visualcloze_tpu_torch.models.layers as layers_mod
    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.ops.act_quant import act_quant_plain
    from visualcloze_tpu_torch.ops.w8a8_matmul import w8a8_matmul_plain

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(5)
    lin = layers_mod.W8A8Linear(3072, 1024, smooth=True).to(dev)
    lin.w_int8.random_(-127, 128, generator=g)
    lin.w_scale.fill_(3072 ** -0.5 / 127)
    lin.a_sinv.uniform_(0.5, 2.0, generator=g)
    lin.bias.data.normal_(0.0, 0.1, generator=g)
    x = torch.randn((2, 300, 3072), generator=g, device=dev)
    ops.reset_kernel_launches()
    with torch.no_grad():
        got = lin(x)
        launches = ops.kernel_launches()
        saved = layers_mod.act_quant_int8, layers_mod.w8a8_matmul
        layers_mod.act_quant_int8, layers_mod.w8a8_matmul = act_quant_plain, w8a8_matmul_plain
        try:
            want = lin(x)
        finally:
            layers_mod.act_quant_int8, layers_mod.w8a8_matmul = saved
    assert launches["act_quant_int8"] == 1 and launches["w8a8_matmul"] == 1
    assert got.shape == (2, 300, 1024) and torch.equal(got, want)


@pytest.mark.gpu
def test_gpu_checkpoint_files_load_fold_and_permute_on_the_card(tmp_path, monkeypatch):
    """build_visualcloze with device cuda on tiny checkpoint files (written as
    tests/test_torch_guards.py writes them): every DiT tensor placed on the
    card in bf16, the LoRA folded there, the caller's TF32 setting restored,
    and chip_smoke's check (unfolded tensors bit-identical to the file,
    folded ones within 1 bf16 ulp of the float64 fold) passes."""
    _cuda_or_skip()
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from test_torch_guards import patch_loader_tiny
    from visualcloze_tpu_torch.models import weights as W
    from visualcloze_tpu_torch.pipeline import build_visualcloze, random_components

    model = random_components(tiny=True, device="cpu")
    cfg = model.cfg
    lora = chip_smoke.random_lora(model.flux, 4, seed=5)
    paths = chip_smoke.write_checkpoints(model, lora, tmp_path)["paths"]
    for var, key in (("FLUX_DEV_FILL", "dit"), ("AE", "vae"), ("T5_PATH", "t5"), ("CLIP_PATH", "clip")):
        monkeypatch.setenv(var, paths[key])
    patch_loader_tiny(monkeypatch)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    loaded = build_visualcloze(model_path=paths["lora"], dtype=torch.bfloat16, device="cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert all(p.device.type == "cuda" and p.dtype == torch.bfloat16 for p in loaded.flux.parameters())
    check = chip_smoke.check_loaded_dit(loaded.flux, cfg, W.convert_flux(W.load_safetensors(paths["dit"]), cfg),
                                        W.permute_rope_layout_lora(lora, cfg))
    assert check["ok"] and check["folded_tensors"] > 0, check


@pytest.mark.gpu
def test_gpu_fold_of_a_full_width_linear_is_a_true_fp32_product(monkeypatch):
    """linear1 of a single block (3072 -> 21504) with a rank-256 LoRA folded on
    the card with TF32 on outside the fold: the fp32 result is within 1e-5 of
    the largest weight of the float64 fold (a TF32 product would be off by
    ~5e-4 of it)."""
    dev = _cuda_or_skip()
    from visualcloze_tpu_torch.models.lora import fold_linear_

    g = torch.Generator(device=dev).manual_seed(0)
    lin = torch.nn.Linear(3072, 21504, device=dev)
    with torch.no_grad():
        lin.weight.normal_(0.0, 3072 ** -0.5, generator=g)
        lin.bias.normal_(0.0, 0.02, generator=g)
    entry = {"a": (torch.rand((3072, 256), generator=g, device=dev) * 2 - 1) * 3072 ** -0.5,
             "b": torch.randn((256, 21504), generator=g, device=dev) * 0.1,
             "b_bias": torch.randn((21504,), generator=g, device=dev) * 0.02}
    want_w = lin.weight.double() + 0.5 * (entry["a"].double() @ entry["b"].double()).T
    want_b = lin.bias.double() + 0.5 * entry["b_bias"].double()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    fold_linear_(lin, entry, scale=0.5)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    top = want_w.abs().max().item()
    assert (lin.weight.double() - want_w).abs().max().item() <= 1e-5 * top
    assert (lin.bias.double() - want_b).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("b, L, c, out_dtype", [(1, 300, 3072, torch.bfloat16), (2, 37, 3072, torch.float32),
                                                 (1, 5, 64, torch.bfloat16)])
def test_gpu_layernorm_modulate_matches_plain(b, L, c, out_dtype):
    """Kernel J: 2 bf16 ulps of the largest output (fp32 out: 2^-16 of it);
    x strided (rows after 3 others), the vectors chunks of one tensor."""
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(b * L + c)
    x = (torch.randn((b, L + 3, c), generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)[:, 3:]
    shift, scale = (torch.randn((b, 1, 6 * c), generator=g, device=dev) * 0.5).chunk(6, dim=-1)[:2]
    got = bfu.layernorm_modulate(x, shift, scale, out_dtype)
    want = bfu.layernorm_modulate_plain(x, shift, scale, out_dtype).float()
    top = want.abs().max().item()
    _close(got, want, _ulps_tol(want, 2) if out_dtype == torch.bfloat16 else top * 2.0 ** -16)
    assert torch.equal(got, bfu.layernorm_modulate(x, shift, scale, out_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("b, L, c", [(1, 300, 3072), (2, 7, 64), (1, 3, 9216)])
def test_gpu_gated_residual_is_bit_exact(b, L, c):
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(L + c)
    x, y = (torch.randn((b, L, c), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    gate = torch.randn((b, 1, 3 * c), generator=g, device=dev)[..., c:2 * c]
    assert torch.equal(bfu.gated_residual(x, gate, y), bfu.gated_residual_plain(x, gate, y))


@pytest.mark.gpu
@pytest.mark.parametrize("L, heads, cols, total, offset", [(300, 24, 21504, 300, 0), (100, 24, 9216, 164, 64),
                                                           (7, 3, 2000, 9, 2)])
def test_gpu_qk_norm_split_matches_plain(L, heads, cols, total, offset):
    """Kernel L: q, k within 2 bf16 ulps, v bit for bit, the rest of the
    joint buffer untouched; an odd head count rounds the CTA up to a warp."""
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(L + cols)
    qkv = (torch.randn((1, L, cols), generator=g, device=dev) * 2).to(torch.bfloat16)[..., : 3 * heads * 128]
    qs, ks = ((torch.rand((128,), generator=g, device=dev) + 0.5).to(torch.bfloat16) for _ in range(2))
    got, want = bfu.qkv_buffers(qkv, heads, total), bfu.qkv_buffers(qkv, heads, total)
    for t in (*got, *want):
        t.fill_(3.0)
    bfu.qk_norm_split(qkv, qs, ks, heads, got, offset)
    bfu.qk_norm_split_plain(qkv, qs, ks, heads, want, offset)
    for a, w in zip(got[:2], want[:2]):
        _close(a, w, _ulps_tol(w.float(), 2))
    assert torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("L, gelu_cols, padded", [(300, 12288, 10), (300, 0, 0), (5, 64, 5)])
def test_gpu_merge_heads_matches_plain(L, gelu_cols, padded):
    """Kernel M: the merge bit for bit with padded rows zero, the gelu within
    one bf16 ulp of each element."""
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(L + gelu_cols)
    x = torch.randn((1, 24, L, 128), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.ones((1, L), dtype=torch.int32, device=dev)
    mask[:, L - padded:] = 0
    gelu = None
    if gelu_cols:
        gelu = (torch.randn((1, L, gelu_cols + 40), generator=g, device=dev) * 3).to(torch.bfloat16)[..., 40:]
    got, want = bfu.merge_heads(x, mask, gelu), bfu.merge_heads_plain(x, mask, gelu)
    hd = 24 * 128
    assert torch.equal(got[..., :hd], want[..., :hd])
    if gelu_cols:
        d = (got[..., hd:].float() - want[..., hd:].float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(want[..., hd:].float().abs().clamp_min(2.0 ** -126))) - 7)
        assert bool((d <= ulp).all())


def _colsum_tol(terms, dims):
    """2^-16 of the largest sum of |terms| over `dims`: an fp32 column sum
    over thousands of tokens taken in another order."""
    return terms.float().abs().sum(dim=dims).max().item() * 2.0 ** -16


@pytest.mark.gpu
@pytest.mark.parametrize("b, L, c, dy_dtype", [(1, 300, 3072, torch.bfloat16), (2, 37, 3072, torch.float32),
                                                (1, 5, 64, torch.bfloat16)])
def test_gpu_layernorm_modulate_bwd_matches_plain(b, L, c, dy_dtype):
    """Kernel J': dx within 2 bf16 ulps of the largest, dshift and dscale
    (per batch element) within _colsum_tol; x strided; the same bits twice;
    without the vectors' gradients nothing but dx."""
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(7 * b * L + c)
    x = (torch.randn((b, L + 3, c), generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)[:, 3:]
    scale = (torch.randn((b, 1, 6 * c), generator=g, device=dev) * 0.5).chunk(6, dim=-1)[1]
    dy = torch.randn((b, L, c), generator=g, device=dev).to(dy_dtype)
    got = bfu.layernorm_modulate_bwd(x, scale, dy)
    want = bfu.layernorm_modulate_bwd_plain(x, scale, dy)
    _close(got[0], want[0], _ulps_tol(want[0].float(), 2))
    n = bfu.layer_norm(x)
    _close(got[1], want[1], _colsum_tol(dy, 1))
    _close(got[2], want[2], _colsum_tol(dy.float() * n, 1))
    again = bfu.layernorm_modulate_bwd(x, scale, dy)
    assert all(torch.equal(a, w) for a, w in zip(got, again))
    dx, dshift, dscale = bfu.layernorm_modulate_bwd(x, scale, dy, need_vectors=False)
    assert torch.equal(dx, got[0]) and dshift is None and dscale is None


@pytest.mark.gpu
@pytest.mark.parametrize("b, L, c", [(1, 300, 3072), (2, 7, 64), (2, 1000, 3072)])
def test_gpu_gated_residual_bwd_matches_plain(b, L, c):
    """Kernel K': dy bit for bit, dgate within _colsum_tol, the same bits twice."""
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(11 * L + c)
    y, dout = (torch.randn((b, L, c), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    gate = torch.randn((b, 1, 3 * c), generator=g, device=dev)[..., c:2 * c]
    got = bfu.gated_residual_bwd(gate, y, dout)
    want = bfu.gated_residual_bwd_plain(gate, y, dout)
    assert torch.equal(got[0], want[0])
    _close(got[1], want[1], _colsum_tol(dout.float() * y.float(), 1))
    assert all(torch.equal(a, w) for a, w in zip(got, bfu.gated_residual_bwd(gate, y, dout)))


@pytest.mark.gpu
@pytest.mark.parametrize("L, heads, cols, total, offset", [(300, 24, 21504, 300, 0), (100, 24, 9216, 164, 64),
                                                           (7, 3, 2000, 9, 2)])
def test_gpu_qk_norm_split_bwd_matches_plain(L, heads, cols, total, offset):
    """Kernel L': dq and dk's columns within 2 bf16 ulps, dv's bit for bit,
    written into the first 3 H D columns of a (1, L, cols) buffer whose
    other columns stay as they were; the scales' gradients within
    _colsum_tol; the same bits twice."""
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(13 * L + cols)
    f = 3 * heads * 128
    qkv = (torch.randn((1, L, cols), generator=g, device=dev) * 2).to(torch.bfloat16)[..., :f]
    qs, ks = ((torch.rand((128,), generator=g, device=dev) + 0.5).to(torch.bfloat16) for _ in range(2))
    dq, dk, dv = (torch.randn((1, heads, total, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    outs = [torch.full((1, L, cols), 3.0, device=dev, dtype=torch.bfloat16) for _ in range(3)]
    got = bfu.qk_norm_split_bwd(qkv, qs, ks, heads, dq, dk, dv, offset, outs[0], True)
    again = bfu.qk_norm_split_bwd(qkv, qs, ks, heads, dq, dk, dv, offset, outs[1], True)
    want = bfu.qk_norm_split_bwd_plain(qkv, qs, ks, heads, dq, dk, dv, offset, outs[2], True)
    assert got[0] is outs[0] and all(torch.equal(a, w) for a, w in zip(got, again))
    hd = heads * 128
    _close(got[0][..., :2 * hd], want[0][..., :2 * hd], _ulps_tol(want[0][..., :2 * hd].float(), 2))
    assert torch.equal(got[0][..., 2 * hd:], want[0][..., 2 * hd:])
    for i, d in ((1, dq), (2, dk)):
        _close(got[i], want[i], _colsum_tol(d[:, :, offset:offset + L], (0, 1, 2)) * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("b, L, gelu_cols, padded", [(1, 300, 12288, 10), (1, 300, 0, 0), (2, 5, 64, 5)])
def test_gpu_merge_heads_bwd_matches_plain(b, L, gelu_cols, padded):
    """Kernel M': dx bit for bit with padded rows zero; dg within one bf16
    ulp of each element, in linear1's gradient buffer laid out as the gelu
    input's rows (_grad_rows); the same bits twice."""
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(17 * L + gelu_cols)
    mask = torch.ones((b, L), dtype=torch.int32, device=dev)
    mask[:, L - padded:] = 0
    gelu = None
    if gelu_cols:
        gelu = (torch.randn((b, L, gelu_cols + 40), generator=g, device=dev) * 3).to(torch.bfloat16)[..., 40:]
    dout = torch.randn((b, L, 24 * 128 + gelu_cols), generator=g, device=dev).to(torch.bfloat16)
    got = bfu.merge_heads_bwd(dout, 24, mask, gelu)
    want = bfu.merge_heads_bwd_plain(dout, 24, mask, gelu)
    assert torch.equal(got[0], want[0]) and not bool(got[0][:, :, L - padded:].any())
    assert all(torch.equal(a, w) for a, w in zip(got, bfu.merge_heads_bwd(dout, 24, mask, gelu)) if a is not None)
    if gelu_cols:
        assert got[1].stride() == gelu.stride() and got[1].storage_offset() == 40
        d = (got[1].float() - want[1].float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(want[1].float().abs().clamp_min(2.0 ** -126))) - 7)
        assert bool((d <= ulp).all())


@pytest.mark.gpu
def test_gpu_backward_kernels_refuse_what_they_cannot_take():
    """A CUDA tensor a backward kernel does not take raises; no plain fallback."""
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    dev = _cuda_or_skip()
    x = torch.randn((1, 4, 64), device=dev)
    scale = torch.zeros((1, 1, 64), device=dev)
    with pytest.raises(ValueError, match="layernorm_modulate_bwd"):
        bfu.layernorm_modulate_bwd(x, scale, x)  # fp32 x
    wide = torch.randn((1, 4, 8192), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="at most 4096"):
        bfu.gated_residual_bwd(torch.zeros((1, 1, 8192), device=dev), wide, wide)
    with pytest.raises(ValueError, match="merge_heads_bwd"):
        bfu.merge_heads_bwd(torch.randn((1, 4, 3 * 128), device=dev), 3)  # fp32 dout


@pytest.mark.gpu
def test_gpu_single_block_gradients_run_through_the_backward_kernels():
    """A full-width single block (24 heads of 128, linear1 21504 columns) on
    32 tokens under autograd with a LoRA: J, K, L, M once each forward and
    J', K', L', M' once each backward; the LoRA gradients within 5% RMS of
    the all-plain route (the blocks' plain versions under autograd)."""
    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.config import FluxConfig
    from visualcloze_tpu_torch.models import layers
    from visualcloze_tpu_torch.models.init import init_linears_, materialize
    from visualcloze_tpu_torch.models.lora import init_lora, tree_items

    dev = _cuda_or_skip()
    cfg = FluxConfig()
    g = torch.Generator(device=dev).manual_seed(5)
    block = materialize(lambda: layers.SingleBlock(cfg), dev, torch.bfloat16)
    init_linears_(block, g)
    block.norm.q_scale.data.fill_(1.0)
    block.norm.k_scale.data.fill_(1.0)
    lora = init_lora(block, 16, generator=g)
    leaves = []
    for path, t in tree_items(lora):
        if path.endswith(".b"):
            t.normal_(0.0, 0.02, generator=g)
        leaves.append(t.requires_grad_())
    x = torch.randn((1, 32, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    vec = torch.randn((1, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.ones((1, 32), dtype=torch.int32, device=dev)
    mask[0, -4:] = 0
    cot = torch.randn((1, 32, cfg.hidden_size), generator=g, device=dev)

    def grads():
        return [t.float() for t in torch.autograd.grad((block(x, vec, None, mask, lora).float() * cot).sum(), leaves)]

    from chip_smoke import plain_block_route

    ops.reset_kernel_launches()
    got = grads()
    launches = ops.kernel_launches()
    with plain_block_route():
        want = grads()
    names = ("layernorm_modulate", "gated_residual", "qk_norm_split", "merge_heads")
    assert {n: launches[n] for n in names} == dict.fromkeys(names, 1), launches
    assert {n: launches[f"{n}_bwd"] for n in names} == dict.fromkeys(names, 1), launches
    num = sum((a - b).pow(2).sum() for a, b in zip(got, want))
    den = sum(b.pow(2).sum() for b in want)
    assert (num / den).sqrt().item() <= 5e-2
