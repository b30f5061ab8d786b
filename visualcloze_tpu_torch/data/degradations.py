"""Synthetic image degradations for restoration-task training.

A copy of visualcloze_tpu/data/degradations.py, kept here so that the port imports
nothing of the JAX package.

Counterpart of the reference's degradation toolkit
(data/degradation_toolkit/: add_degradation_various.py, image_operators.py,
x_distortion/ — ~1859 LoC), re-implemented in numpy + cv2 (no skimage/numba
dependency). Every type named in prefix_instruction.degradation_list is
covered. Host-side CPU work, applied in the input pipeline (the correct
placement on TPU too — SURVEY.md §2.9 item 9).

All functions take/return uint8 RGB (H, W, 3) arrays. Randomness comes from
an explicit np.random.Generator for deterministic, resumable data pipelines.
"""

from __future__ import annotations

import io

import cv2
import numpy as np

Array = np.ndarray


def _rng(rng):
    return rng if rng is not None else np.random.default_rng()


def _clip(x) -> Array:
    return np.clip(x, 0, 255).astype(np.uint8)


def _to_float(img: Array) -> Array:
    return img.astype(np.float32) / 255.0


def _from_float(x: Array) -> Array:
    return _clip(np.round(x * 255.0))


# ----------------------------- noise -----------------------------

def gaussian_noise(img, rng=None, sigma=None):
    rng = _rng(rng)
    sigma = sigma if sigma is not None else rng.uniform(10, 50)
    return _clip(img.astype(np.float32) + rng.normal(0, sigma, img.shape))


def poisson_noise(img, rng=None, scale=None):
    rng = _rng(rng)
    scale = scale if scale is not None else rng.uniform(0.5, 2.0)
    lam = np.maximum(img.astype(np.float32) * scale, 1e-3)
    return _clip(rng.poisson(lam).astype(np.float32) / scale)


def sp_noise(img, rng=None, amount=None):
    rng = _rng(rng)
    amount = amount if amount is not None else rng.uniform(0.01, 0.08)
    out = img.copy()
    mask = rng.random(img.shape[:2])
    out[mask < amount / 2] = 0
    out[mask > 1 - amount / 2] = 255
    return out


# ----------------------------- blur -----------------------------

def gaussian_blur(img, rng=None, sigma=None):
    rng = _rng(rng)
    sigma = sigma if sigma is not None else rng.uniform(1.0, 4.0)
    k = int(2 * round(3 * sigma) + 1)
    return cv2.GaussianBlur(img, (k, k), sigma)


def defocus_blur(img, rng=None, radius=None):
    rng = _rng(rng)
    radius = radius if radius is not None else int(rng.integers(2, 7))
    k = 2 * radius + 1
    kernel = np.zeros((k, k), np.float32)
    cv2.circle(kernel, (radius, radius), radius, 1.0, -1)
    kernel /= kernel.sum()
    return cv2.filter2D(img, -1, kernel)


def glass_blur(img, rng=None, sigma=2.0, max_delta=3, iterations=1):
    rng = _rng(rng)
    out = gaussian_blur(img, rng, sigma)
    h, w = out.shape[:2]
    for _ in range(iterations):
        dx = rng.integers(-max_delta, max_delta + 1, (h, w))
        dy = rng.integers(-max_delta, max_delta + 1, (h, w))
        ys = np.clip(np.arange(h)[:, None] + dy, 0, h - 1)
        xs = np.clip(np.arange(w)[None, :] + dx, 0, w - 1)
        out = out[ys, xs]
    return gaussian_blur(out, rng, sigma / 2)


def motion_blur(img, rng=None, size=None, angle=None):
    rng = _rng(rng)
    size = size if size is not None else int(rng.integers(7, 21))
    angle = angle if angle is not None else float(rng.uniform(0, 180))
    kernel = np.zeros((size, size), np.float32)
    kernel[size // 2, :] = 1.0
    m = cv2.getRotationMatrix2D((size / 2 - 0.5, size / 2 - 0.5), angle, 1.0)
    kernel = cv2.warpAffine(kernel, m, (size, size))
    kernel /= max(kernel.sum(), 1e-6)
    return cv2.filter2D(img, -1, kernel)


def zoom_blur(img, rng=None, max_factor=1.12):
    h, w = img.shape[:2]
    acc = img.astype(np.float32)
    n = 6
    for i in range(1, n):
        f = 1.0 + (max_factor - 1.0) * i / n
        zh, zw = int(h * f), int(w * f)
        z = cv2.resize(img, (zw, zh))
        y0, x0 = (zh - h) // 2, (zw - w) // 2
        acc += z[y0 : y0 + h, x0 : x0 + w].astype(np.float32)
    return _clip(acc / n)


# ----------------------------- weather / photometric -----------------------------

def frost(img, rng=None, strength=0.4):
    rng = _rng(rng)
    h, w = img.shape[:2]
    noise = rng.normal(0.6, 0.3, (h // 4, w // 4, 1)).astype(np.float32)
    noise = cv2.resize(noise, (w, h))[..., None]
    noise = cv2.GaussianBlur(noise, (0, 0), 3)[..., None]
    frost_layer = np.clip(noise, 0, 1) * 255.0
    return _clip(img.astype(np.float32) * (1 - strength) + frost_layer * strength)


def rain(img, rng=None, density=0.002, length=15):
    rng = _rng(rng)
    h, w = img.shape[:2]
    layer = np.zeros((h, w), np.float32)
    n = int(h * w * density)
    xs = rng.integers(0, w, n)
    ys = rng.integers(0, h, n)
    angle = rng.uniform(-20, 20)
    dx = int(np.sin(np.radians(angle)) * length)
    for x, y in zip(xs, ys):
        cv2.line(layer, (x, y), (x + dx, y + length), 1.0, 1)
    layer = cv2.GaussianBlur(layer, (3, 3), 0.7)
    return _clip(img.astype(np.float32) + layer[..., None] * 180.0)


def spatter(img, rng=None, density=0.12):
    rng = _rng(rng)
    h, w = img.shape[:2]
    blobs = rng.random((h // 8, w // 8)).astype(np.float32)
    blobs = cv2.resize(blobs, (w, h))
    blobs = cv2.GaussianBlur(blobs, (0, 0), 2)
    mask = (blobs > 1 - density).astype(np.float32)[..., None]
    color = np.array([90.0, 70.0, 60.0], np.float32)
    return _clip(img.astype(np.float32) * (1 - mask) + color * mask)


def contrast(img, rng=None, factor=None):
    rng = _rng(rng)
    factor = factor if factor is not None else rng.uniform(0.3, 0.7)
    mean = img.astype(np.float32).mean(axis=(0, 1), keepdims=True)
    return _clip((img.astype(np.float32) - mean) * factor + mean)


def contrast_strengthen(img, rng=None, factor=None):
    """Scale contrast up about the mean (ref x_distortion/contrast.py
    strengthen_scale/stretch family)."""
    rng = _rng(rng)
    factor = factor if factor is not None else rng.uniform(1.4, 2.5)
    return contrast(img, rng, factor=factor)


def contrast_weaken(img, rng=None, factor=None):
    rng = _rng(rng)
    factor = factor if factor is not None else rng.uniform(0.3, 0.7)
    return contrast(img, rng, factor=factor)


def brighten(img, rng=None, gamma=None):
    """Brighten via gamma + shift mix (ref x_distortion/brightness.py
    brighten_shift/gamma HSV/RGB family)."""
    rng = _rng(rng)
    gamma = gamma if gamma is not None else rng.uniform(0.45, 0.8)
    x = _to_float(img) ** gamma
    return _from_float(x)


def darken(img, rng=None, gamma=None):
    rng = _rng(rng)
    gamma = gamma if gamma is not None else rng.uniform(1.3, 2.2)
    x = _to_float(img) ** gamma
    return _from_float(x)


def _scale_saturation(img, factor):
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * factor, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def saturate_strengthen(img, rng=None, factor=None):
    rng = _rng(rng)
    factor = factor if factor is not None else rng.uniform(1.5, 3.0)
    return _scale_saturation(img, factor)


def saturate_weaken(img, rng=None, factor=None):
    rng = _rng(rng)
    factor = factor if factor is not None else rng.uniform(0.1, 0.5)
    return _scale_saturation(img, factor)


def gray(img, rng=None):
    g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    return np.stack([g] * 3, axis=-1)


def color_distortion(img, rng=None):
    """Channel shuffle, or zero/saturate one channel (ref
    degradation_utils.py:147-158)."""
    rng = _rng(rng)
    if rng.random() < 0.5:
        channels = rng.permutation(3)
        return img[..., channels].copy()
    out = img.copy()
    channel = int(rng.integers(0, 3))
    out[..., channel] = 0 if rng.random() < 0.5 else 255
    return out


def brightness(img, rng=None, delta=None):
    rng = _rng(rng)
    delta = delta if delta is not None else rng.uniform(40, 100)
    return _clip(img.astype(np.float32) + delta)


def darkness(img, rng=None, delta=None):
    rng = _rng(rng)
    delta = delta if delta is not None else rng.uniform(40, 100)
    return _clip(img.astype(np.float32) - delta)


def low_light(img, rng=None, factor=None):
    rng = _rng(rng)
    factor = factor if factor is not None else rng.uniform(0.15, 0.4)
    dark = img.astype(np.float32) * factor
    return _clip(dark + rng.normal(0, 6, img.shape))


# ----------------------------- compression / sampling -----------------------------

def jpeg_compress(img, rng=None, quality=None):
    rng = _rng(rng)
    quality = quality if quality is not None else int(rng.integers(5, 30))
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]


def pixelate(img, rng=None, factor=None):
    rng = _rng(rng)
    factor = factor if factor is not None else int(rng.integers(4, 12))
    h, w = img.shape[:2]
    small = cv2.resize(img, (max(w // factor, 1), max(h // factor, 1)), interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


def super_resolution_degrade(img, factor, rng=None):
    """SRx2/SRx4 training degradation: down-up with blur + noise."""
    rng = _rng(rng)
    h, w = img.shape[:2]
    x = gaussian_blur(img, rng, sigma=0.8 * factor)
    x = cv2.resize(x, (w // factor, h // factor), interpolation=cv2.INTER_AREA)
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    return _clip(x.astype(np.float32) + rng.normal(0, 3, img.shape))


def quantization(img, rng=None, levels=None):
    rng = _rng(rng)
    levels = levels if levels is not None else int(rng.integers(3, 8))
    q = 255.0 / (levels - 1)
    return _clip(np.round(img.astype(np.float32) / q) * q)


def oversharpen(img, rng=None, amount=None):
    rng = _rng(rng)
    amount = amount if amount is not None else rng.uniform(2.0, 4.0)
    blurred = cv2.GaussianBlur(img, (0, 0), 2.0).astype(np.float32)
    return _clip(img.astype(np.float32) + amount * (img.astype(np.float32) - blurred))


def denoise_artifact(img, rng=None):
    """'Denoise' distortion: over-smoothed denoiser output look."""
    rng = _rng(rng)
    noisy = gaussian_noise(img, rng, sigma=20)
    return cv2.bilateralFilter(noisy, 9, 100, 100)


def ringing(img, rng=None, cutoff=None):
    rng = _rng(rng)
    cutoff = cutoff if cutoff is not None else rng.uniform(0.15, 0.35)
    out = np.zeros_like(img, np.float32)
    h, w = img.shape[:2]
    cy, cx = h // 2, w // 2
    yy, xx = np.ogrid[:h, :w]
    r = np.sqrt(((yy - cy) / h) ** 2 + ((xx - cx) / w) ** 2)
    lp = (r < cutoff).astype(np.float32)
    for c in range(3):
        f = np.fft.fftshift(np.fft.fft2(img[..., c].astype(np.float32)))
        out[..., c] = np.real(np.fft.ifft2(np.fft.ifftshift(f * lp)))
    return _clip(out)


def rl_artifact(img, rng=None):
    """'r_l' degradation: blur followed by aggressive deconv-style sharpening."""
    rng = _rng(rng)
    blurred = gaussian_blur(img, rng, sigma=2.0)
    return oversharpen(blurred, rng, amount=3.0)


def inpainting_mask(img, rng=None, num_strokes=None):
    rng = _rng(rng)
    num_strokes = num_strokes if num_strokes is not None else int(rng.integers(3, 8))
    out = img.copy()
    h, w = img.shape[:2]
    for _ in range(num_strokes):
        pts = rng.integers(0, [w, h], size=(int(rng.integers(3, 7)), 2))
        thickness = int(rng.integers(5, max(6, min(h, w) // 12)))
        cv2.polylines(out, [pts.astype(np.int32)], False, (0, 0, 0), thickness)
    return out


def elastic(img, rng=None, alpha=None, sigma=8.0):
    rng = _rng(rng)
    h, w = img.shape[:2]
    alpha = alpha if alpha is not None else min(h, w) * 0.08
    dx = cv2.GaussianBlur((rng.random((h, w)).astype(np.float32) * 2 - 1), (0, 0), sigma) * alpha
    dy = cv2.GaussianBlur((rng.random((h, w)).astype(np.float32) * 2 - 1), (0, 0), sigma) * alpha
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return cv2.remap(img, xx + dx, yy + dy, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)


# ----------------------------- operators -----------------------------

def laplacian_op(img, rng=None):
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    lap = cv2.Laplacian(gray, cv2.CV_32F, ksize=3)
    lap = np.abs(lap)
    lap = _clip(lap / max(lap.max(), 1e-6) * 255.0)
    return np.stack([lap] * 3, axis=-1)


def canny_op(img, rng=None):
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    edges = cv2.Canny(gray, 100, 200)
    return np.stack([edges] * 3, axis=-1)


def sobel_op(img, rng=None):
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32)
    gx = cv2.Sobel(gray, cv2.CV_32F, 1, 0)
    gy = cv2.Sobel(gray, cv2.CV_32F, 0, 1)
    mag = np.sqrt(gx ** 2 + gy ** 2)
    mag = _clip(mag / max(mag.max(), 1e-6) * 255.0)
    return np.stack([mag] * 3, axis=-1)


def bayer_mosaic(img, rng=None):
    out = np.zeros_like(img)
    out[0::2, 0::2, 0] = img[0::2, 0::2, 0]  # R
    out[0::2, 1::2, 1] = img[0::2, 1::2, 1]  # G
    out[1::2, 0::2, 1] = img[1::2, 0::2, 1]  # G
    out[1::2, 1::2, 2] = img[1::2, 1::2, 2]  # B
    return out


def _radial(img, k):
    h, w = img.shape[:2]
    cy, cx = h / 2, w / 2
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    x = (xx - cx) / cx
    y = (yy - cy) / cy
    r2 = x ** 2 + y ** 2
    f = 1 + k * r2
    map_x = (x * f * cx + cx).astype(np.float32)
    map_y = (y * f * cy + cy).astype(np.float32)
    return cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)


def barrel(img, rng=None):
    return _radial(img, -0.25)


def pincushion(img, rng=None):
    return _radial(img, 0.25)


def flip(img, rng=None):
    return img[:, ::-1].copy()


def _rot_keep_shape(img, k):
    h, w = img.shape[:2]
    out = np.rot90(img, k).copy()
    if out.shape[:2] != (h, w):
        out = cv2.resize(out, (w, h))
    return out


def rotate90(img, rng=None):
    return _rot_keep_shape(img, 1)


def rotate180(img, rng=None):
    return _rot_keep_shape(img, 2)


def rotate270(img, rng=None):
    return _rot_keep_shape(img, 3)


# ----------------------------- dispatch -----------------------------

def _x_family(family: str):
    """Severity-graded x_distortion family: draws (subtype, severity 1..5)
    from the reference parameter tables (ref degradation_utils.py:83-97,
    x_distortion/__init__.py:50-113; tables in data/x_distortion.py)."""
    from .x_distortion import add_x_distortion

    def apply(img, rng=None):
        return add_x_distortion(img, family, _rng(rng))

    apply.__name__ = f"x_{family}"
    return apply


_DISPATCH = {
    "GaussianNoise": gaussian_noise,
    "PoissonNoise": poisson_noise,
    "SPNoise": sp_noise,
    "GaussianBlur": gaussian_blur,
    "DefocusBlur": defocus_blur,
    "GlassBlur": glass_blur,
    "MotionBlur": motion_blur,
    "ZoomBlur": zoom_blur,
    "Frost": frost,
    "Rain": rain,
    "Contrast": contrast,
    "Brightness": brightness,
    "Darkness": darkness,
    "LowLight": low_light,
    "JPEG": jpeg_compress,
    "jpeg": jpeg_compress,
    "Inpainting": inpainting_mask,
    "Ringing": ringing,
    "r_l": rl_artifact,
    "Elastic": elastic,
    "Laplacian": laplacian_op,
    "Canny": canny_op,
    "Sobel": sobel_op,
    "mosaic": bayer_mosaic,
    "barrel": barrel,
    "pincushion": pincushion,
    "flip": flip,
    "rotate90": rotate90,
    "rotate180": rotate180,
    "rotate270": rotate270,
    "blur": _x_family("blur"),
    "noise": _x_family("noise"),
    "compression": _x_family("compression"),
    "SRx2": lambda img, rng=None: super_resolution_degrade(img, 2, rng),
    "SRx4": lambda img, rng=None: super_resolution_degrade(img, 4, rng),
    "pixelate": _x_family("pixelate"),
    "Denoise": denoise_artifact,
    "oversharpen": _x_family("oversharpen"),
    "quantization": _x_family("quantization"),
    "spatter": _x_family("spatter"),
    "Spatter": spatter,
    "Resize": lambda img, rng=None: super_resolution_degrade(img, 2, rng),
    # reference registry keys (ref prefix_instruction.py:6-51 /
    # degradation_utils.py:11-72) not covered above
    "Defocus": defocus_blur,
    "Mosaic": bayer_mosaic,
    "contrast_strengthen": _x_family("contrast_strengthen"),
    "contrast_weaken": _x_family("contrast_weaken"),
    "brighten": _x_family("brighten"),
    "darken": _x_family("darken"),
    "saturate_strengthen": _x_family("saturate_strengthen"),
    "saturate_weaken": _x_family("saturate_weaken"),
    "gray": gray,
    "ColorDistortion": color_distortion,
    "Barrel": barrel,
    "Pincushion": pincushion,
    "identity": lambda img, rng=None: img.copy(),
}


def add_degradation(image: Array, deg_type: str, rng: np.random.Generator | None = None) -> Array:
    """Apply one named degradation (ref data/degradation_utils.py:11-72).

    image: uint8 RGB (H, W, 3). Returns the degraded uint8 RGB image.
    """
    if deg_type not in _DISPATCH:
        raise KeyError(f"unknown degradation {deg_type!r}")
    out = _DISPATCH[deg_type](image, rng)
    assert out.shape == image.shape, (deg_type, out.shape, image.shape)
    return out


def available_degradations() -> list[str]:
    return sorted(_DISPATCH)
