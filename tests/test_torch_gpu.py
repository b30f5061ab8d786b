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
                                     (300, 64, 512), (200, 15360, 3072), (5, 15360, 64), (2, 64, 16)])
def test_gpu_int8_matmul_matches_plain(m, k, n):
    """Kernel G against its plain version: the modulation GEMV (M = 1), a
    ragged M, final_layer.linear (N = 64), linear1; M on both sides of the
    GEMV body's threshold (16, 17) and at 64 and 129; N = 16 and 272 (not a
    multiple of the 256-column tile); K = 64 (one stage) and 15360. 4 bf16
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
@pytest.mark.parametrize("m, k, n", [(1, 3072, 18432), (7, 3072, 3072), (333, 3072, 9216)])
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
