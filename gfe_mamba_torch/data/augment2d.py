"""2D image augmentations for the self-supervised ViT zoo (counterpart of
``gfe_mamba_tpu/data/augment2d.py``).

The torchvision pipeline of the reference's DINO / EsViT wrappers:
``RandomApply(ColorJitter(.8, .8, .8, .2), p=.3)``,
``RandomGrayscale(.2)``, ``RandomHorizontalFlip()``,
``RandomApply(GaussianBlur(3, (1, 2)), p=.2)``, ``Normalize(imagenet)``,
and the local / global ``RandomResizedCrop`` pair, with torchvision's
functional semantics for the colour ops (blends clamped to [0, 1], hue
through HSV).

Images are channels-last floats in [0, 1]: one ``(H, W, C)`` image or a
``(B, H, W, C)`` batch.  As JAX's ``vmap`` over keys does, every random
op draws its parameters per sample, and every op runs on the image's
device with static shapes and no host sync (constants are filled on the
device, never copied from the host): a random resized crop is a
fractional box resampled by two dense (out, in) weight matrices, a random
choice a ``torch.where`` over the candidates.  Draws come from an explicit
``torch.Generator`` on the image's device through :func:`_uniform` and
:func:`_permutation` alone, in a fixed order per op, so tests can feed
JAX's draws in their place.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) draws: the only source of the ops' random numbers."""
    return torch.rand(shape, generator=generator, device=device)


def _permutation(rows: int, n: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """A uniform random permutation of ``n`` for each of ``rows``."""
    return torch.rand(rows, n, generator=generator,
                      device=device).argsort(dim=1)


def _per_sample(value, img: torch.Tensor):
    """A scalar, or a tensor over the image's leading (batch) dims,
    broadcast against ``img`` ``(..., H, W, C)``."""
    if torch.is_tensor(value) and value.dim():
        return value.reshape(*value.shape, 1, 1, 1)
    return value


def _f32(value: float, device) -> torch.Tensor:
    """An f32 scalar made on ``device`` (a fill, not a host copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _scaled(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """U[lo, hi) from U[0, 1) draws, in f32 as ``jax.random.uniform``
    scales them."""
    lo, hi = _f32(lo, u.device), _f32(hi, u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def _batched(fn):
    """Run a batch-wise op on a single ``(H, W, C)`` image too."""
    @functools.wraps(fn)
    def run(img: torch.Tensor, *args, **kwargs):
        if img.dim() == 3:
            return fn(img[None], *args, **kwargs)[0]
        return fn(img, *args, **kwargs)
    return run


# ---------------------------------------------------------------------------
# colour space
# ---------------------------------------------------------------------------


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` RGB in [0, 1] -> HSV in [0, 1] (torchvision _rgb2hsv)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(maxc == 0, ones, maxc)
    cr_div = torch.where(cr == 0, ones, cr)
    rc, gc, bc = (maxc - r) / cr_div, (maxc - g) / cr_div, (maxc - b) / cr_div
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(cr == 0, 0.0, (h / 6.0) % 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` HSV in [0, 1] -> RGB (torchvision _hsv2rgb)."""
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int64) % 6
    sel = torch.stack([
        torch.stack([v, t, p], -1), torch.stack([q, v, p], -1),
        torch.stack([p, v, t], -1), torch.stack([p, q, v], -1),
        torch.stack([t, p, v], -1), torch.stack([v, p, q], -1)], 0)
    return torch.gather(sel, 0, i[None, ..., None].expand(
        1, *img.shape))[0]


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma broadcast back to 3 channels (torchvision's
    rgb_to_grayscale weights)."""
    luma = 0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return luma[..., None].expand(img.shape)


# ---------------------------------------------------------------------------
# point colour ops, clamped to [0, 1]; a factor is a scalar or one value per
# sample of a batch
# ---------------------------------------------------------------------------


def adjust_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(img * _per_sample(factor, img), 0.0, 1.0)


def adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    mean = grayscale(img)[..., 0].mean(dim=(-2, -1), keepdim=True)
    factor = _per_sample(factor, img)
    return torch.clamp(factor * img + (1.0 - factor) * mean[..., None],
                       0.0, 1.0)


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    factor = _per_sample(factor, img)
    return torch.clamp(factor * img + (1.0 - factor) * grayscale(img),
                       0.0, 1.0)


def adjust_hue(img: torch.Tensor, shift) -> torch.Tensor:
    """``shift`` in [-0.5, 0.5] rotates the HSV hue channel."""
    hsv = rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    shift = _per_sample(shift, img)
    if torch.is_tensor(shift):
        shift = shift[..., 0]
    h = (hsv[..., 0] + shift) % 1.0
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


@_batched
def color_jitter(img: torch.Tensor, generator: torch.Generator,
                 brightness: float = 0.8, contrast: float = 0.8,
                 saturation: float = 0.8, hue: float = 0.2) -> torch.Tensor:
    """torchvision ColorJitter per sample: factors ~ U(max(0, 1 - v),
    1 + v), hue ~ U(-hue, hue), the four ops in a random order."""
    b = img.shape[0]
    u = _uniform((b, 4), generator, img.device)
    perm = _permutation(b, 4, generator, img.device)
    lo = [max(0.0, 1.0 - v) for v in (brightness, contrast, saturation)]
    fb, fc, fs = (lo[i] + u[:, i] * ((1.0 + v) - lo[i])
                  for i, v in enumerate((brightness, contrast, saturation)))
    fh = (2.0 * u[:, 3] - 1.0) * hue
    ops = (lambda x: adjust_brightness(x, fb),
           lambda x: adjust_contrast(x, fc),
           lambda x: adjust_saturation(x, fs),
           lambda x: adjust_hue(x, fh))
    rows = torch.arange(b, device=img.device)
    for step in range(4):
        img = torch.stack([op(img) for op in ops])[perm[:, step], rows]
    return img


@_batched
def random_grayscale(img: torch.Tensor, generator: torch.Generator,
                     p: float = 0.2) -> torch.Tensor:
    u = _uniform((img.shape[0],), generator, img.device)
    return torch.where(_per_sample(u < p, img), grayscale(img), img)


@_batched
def random_hflip(img: torch.Tensor, generator: torch.Generator,
                 p: float = 0.5) -> torch.Tensor:
    """Flip the width axis with probability ``p``."""
    u = _uniform((img.shape[0],), generator, img.device)
    return torch.where(_per_sample(u < p, img), img.flip(-2), img)


# ---------------------------------------------------------------------------
# gaussian blur
# ---------------------------------------------------------------------------


def _gauss_kernel1d(sigma: torch.Tensor, ksize: int) -> torch.Tensor:
    """``(..., ksize)`` normalized Gaussian taps for sigmas ``(...)``."""
    x = torch.arange(ksize, dtype=torch.float32, device=sigma.device) \
        - (ksize - 1) / 2.0
    sigma = sigma[..., None]
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum(dim=-1, keepdim=True)


def _reflect(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, pad).flip(dim), x,
                      x.narrow(dim, n - 1 - pad, pad).flip(dim)], dim)


def gaussian_blur(img: torch.Tensor, sigma, ksize: int = 3) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding (torchvision
    GaussianBlur); ``sigma`` a scalar or one per sample of a batch."""
    if not torch.is_tensor(sigma):
        sigma = _f32(sigma, img.device)
    k = _gauss_kernel1d(sigma, ksize)
    k = k.reshape(*k.shape[:-1], *(1,) * 3, ksize) if k.dim() > 1 else k
    pad = ksize // 2
    x = img.float()
    hh, ww = x.shape[-3], x.shape[-2]
    xh = _reflect(x, pad, x.dim() - 3)
    x = sum(xh[..., i:i + hh, :, :] * k[..., i] for i in range(ksize))
    xw = _reflect(x, pad, x.dim() - 2)
    x = sum(xw[..., :, i:i + ww, :] * k[..., i] for i in range(ksize))
    return x.to(img.dtype)


@_batched
def random_gaussian_blur(img: torch.Tensor, generator: torch.Generator,
                         p: float = 0.2,
                         sigma_range: Tuple[float, float] = (1.0, 2.0),
                         ksize: int = 3) -> torch.Tensor:
    b = img.shape[0]
    sigma = _scaled(_uniform((b,), generator, img.device), *sigma_range)
    u = _uniform((b,), generator, img.device)
    return torch.where(_per_sample(u < p, img),
                       gaussian_blur(img, sigma, ksize), img)


def normalize(img: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    m, s = (torch.stack([torch.full((), v, dtype=img.dtype,
                                    device=img.device) for v in values])
            for values in (mean, std))
    return (img - m) / s


# ---------------------------------------------------------------------------
# random resized crop: a fractional box resampled by two weight matrices
# ---------------------------------------------------------------------------


def _linear_resample_matrix(o_n: int, i0: torch.Tensor, ext: torch.Tensor,
                            total: int) -> torch.Tensor:
    """``(..., o_n, total)`` bilinear weights mapping the span [i0, i0 +
    ext) of a ``total``-sample axis onto ``o_n`` samples: output o's
    centre sits at (o + 0.5) * ext / o_n - 0.5 + i0 (half-pixel), clamped
    to the span's samples [i0, i0 + ext - 1] as a crop-then-resize clamps
    at the crop's edge; the row is the triangle kernel relu(1 - |u - c|).
    ``i0`` and ``ext`` are f32 tensors ``(...)``."""
    dev = ext.device
    o = torch.arange(o_n, dtype=torch.float32, device=dev)
    # divided by a tensor on the device: CUDA divides by a host scalar
    # through its reciprocal, and the CPU's result is to be matched
    step = ext / torch.full_like(ext, o_n)
    c = (o + 0.5) * step[..., None] - 0.5 + i0[..., None]
    c = torch.clamp(c, i0[..., None], (i0 + ext - 1.0)[..., None])
    u = torch.arange(total, dtype=torch.float32, device=dev)
    return torch.relu(1.0 - (u - c[..., None]).abs())


@_batched
def crop_and_resize(img: torch.Tensor, box: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear-resample each image's fractional box ``(i, j, h, w)``
    (pixel units, f32; ``(4,)`` for one image, ``(B, 4)`` for a batch) to
    ``out_hw``: for integer boxes a crop and a bilinear resize without
    antialiasing, for any box two matmuls of static shapes."""
    box = box.reshape(img.shape[0], 4)
    oh, ow = out_hw
    wy = _linear_resample_matrix(oh, box[:, 0], box[:, 2], img.shape[1])
    wx = _linear_resample_matrix(ow, box[:, 1], box[:, 3], img.shape[2])
    t = torch.einsum("bpx,byxc->bypc", wx, img.float())
    return torch.einsum("boy,bypc->bopc", wy, t).to(img.dtype)


def sample_crop_box(generator: torch.Generator, in_hw: Tuple[int, int],
                    scale: Tuple[float, float],
                    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                    attempts: int = 10, *, batch: int = 1,
                    device=None) -> torch.Tensor:
    """torchvision RandomResizedCrop.get_params with static shapes, per
    sample: ``attempts`` (area, log-aspect) draws side by side, the first
    in bounds taken, else the clamp-to-ratio centre crop.  Returns ``(batch,
    4)`` f32 boxes (i, j, h, w) in pixels."""
    H, W = in_hw
    area = float(H * W)
    shape = (batch, attempts)
    target = area * _scaled(_uniform(shape, generator, device), *scale)
    log_lo = torch.log(_f32(ratio[0], device))
    log_hi = torch.log(_f32(ratio[1], device))
    u = _uniform(shape, generator, device)
    log_r = torch.maximum(log_lo, u * (log_hi - log_lo) + log_lo)
    ar = torch.exp(log_r)
    w = torch.round(torch.sqrt(target * ar))
    h = torch.round(torch.sqrt(target / ar))
    ok = (w > 0) & (w <= W) & (h > 0) & (h <= H)
    any_ok = ok.any(dim=1)
    first = ok.to(torch.uint8).argmax(dim=1, keepdim=True)
    h_ok, w_ok = h.gather(1, first)[:, 0], w.gather(1, first)[:, 0]
    # the fallback (torchvision): the aspect clamped to the ratio bounds
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w_fb, h_fb = float(W), torch.round(_f32(W / ratio[0], device))
    elif in_ratio > ratio[1]:
        w_fb, h_fb = torch.round(_f32(H * ratio[1], device)), float(H)
    else:
        w_fb, h_fb = float(W), float(H)
    hh = torch.where(any_ok, h_ok, h_fb)
    ww = torch.where(any_ok, w_ok, w_fb)
    u = _uniform((batch, 2), generator, device)
    i_rand = torch.floor(u[:, 0] * (H - hh + 1.0))
    j_rand = torch.floor(u[:, 1] * (W - ww + 1.0))
    ii = torch.where(any_ok, i_rand, torch.floor((H - hh) / 2.0))
    jj = torch.where(any_ok, j_rand, torch.floor((W - ww) / 2.0))
    return torch.stack([ii, jj, hh, ww], dim=1)


@_batched
def random_resized_crop(img: torch.Tensor, generator: torch.Generator,
                        out_size: int, scale: Tuple[float, float],
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                        ) -> torch.Tensor:
    """torchvision ``RandomResizedCrop((out, out), scale=scale)``, a box
    per sample."""
    box = sample_crop_box(generator, tuple(img.shape[1:3]), scale, ratio,
                          batch=img.shape[0], device=img.device)
    return crop_and_resize(img, box, (out_size, out_size))


# ---------------------------------------------------------------------------
# composed pipelines
# ---------------------------------------------------------------------------


@_batched
def byol_augment(img: torch.Tensor, generator: torch.Generator,
                 jitter_p: float = 0.3, gray_p: float = 0.2,
                 blur_p: float = 0.2, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """The reference's DEFAULT_AUG: RandomApply(ColorJitter(.8, .8, .8,
    .2), p=.3) -> RandomGrayscale(.2) -> RandomHorizontalFlip ->
    RandomApply(GaussianBlur(3, (1, 2)), p=.2) -> Normalize(imagenet)."""
    jittered = color_jitter(img, generator)
    u = _uniform((img.shape[0],), generator, img.device)
    img = torch.where(_per_sample(u < jitter_p, img), jittered, img)
    img = random_grayscale(img, generator, gray_p)
    img = random_hflip(img, generator)
    img = random_gaussian_blur(img, generator, blur_p)
    return normalize(img, mean, std)


class SSLViews(NamedTuple):
    """The four crops the reference feeds student and teacher."""
    local_one: torch.Tensor
    local_two: torch.Tensor
    global_one: torch.Tensor
    global_two: torch.Tensor


Augment = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def ssl_views_batch(imgs: torch.Tensor, generator: torch.Generator,
                    image_size: int, local_upper_crop_scale: float = 0.4,
                    global_lower_crop_scale: float = 0.5,
                    augment_fn: Optional[Augment] = None,
                    augment_fn2: Optional[Augment] = None) -> SSLViews:
    """DINO / EsViT views of a ``(B, H, W, C)`` batch, per sample: two
    augmented copies (``augment_fn(imgs, generator)``, default
    :func:`byol_augment`), each cropped locally (scale 0.05 to
    ``local_upper_crop_scale``) and globally (``global_lower_crop_scale``
    to 1) to ``image_size``."""
    aug1 = augment_fn or byol_augment
    aug2 = augment_fn2 or byol_augment
    one, two = aug1(imgs, generator), aug2(imgs, generator)
    local = functools.partial(random_resized_crop, generator=generator,
                              out_size=image_size,
                              scale=(0.05, local_upper_crop_scale))
    glob = functools.partial(random_resized_crop, generator=generator,
                             out_size=image_size,
                             scale=(global_lower_crop_scale, 1.0))
    return SSLViews(local(one), local(two), glob(one), glob(two))


def ssl_views(img: torch.Tensor, generator: torch.Generator,
              image_size: int, **kw) -> SSLViews:
    """:func:`ssl_views_batch` of one ``(H, W, C)`` image."""
    return SSLViews(*(v[0] for v in ssl_views_batch(img[None], generator,
                                                    image_size, **kw)))
