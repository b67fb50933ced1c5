"""Operations and bytes of the models' work, counted from shapes.

The operations are those of convolutions and matrix products (2 per
multiply-add), counted as ``torch.utils.flop_counter`` counts them on
the reference: a conv over every output voxel and the whole window, a
transposed conv over every input voxel, a product of every pair.  The
scan, norms, activations, softmax and pooling are not counted.  The
model's own work is counted once: no credit for recomputation.

An :class:`Op` knows its forward operations and whether a training step
takes the gradient of its first operand (the input; ``grad_a``) and of
its second (a weight, or a second activation; ``grad_b``); each of
those costs the forward's operations again."""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Op:
    part: str
    name: str
    flops: int
    grad_a: bool = False
    grad_b: bool = False

    def step_flops(self) -> int:
        return self.flops * (1 + self.grad_a + self.grad_b)


def conv3d_work(x_shape, w_shape, itemsize: int,
                residual: bool = False) -> tuple[int, int]:
    """A 3x3x3 conv of channels-last ``x (B, X, Y, Z, C)`` with a
    ``(F, C, 3, 3, 3)`` weight: ``(operations, bytes)``, each input and
    output byte once (x, the weight, a residual, the output) at
    ``itemsize`` bytes per element."""
    b, vox, c = x_shape[0], math.prod(x_shape[1:-1]), x_shape[-1]
    f = w_shape[0]
    flops = 2 * b * vox * 27 * c * f
    elems = b * vox * (c + f + (f if residual else 0)) + 27 * c * f
    return flops, elems * itemsize


def conv3d_least_s(flops: int, nbytes: int, peak_flops: float,
                   peak_bytes_per_s: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes_per_s)


def _conv(part, name, b, spatial, cin, cout, k=27, grad_a=False,
          grad_b=False):
    return Op(part, name, 2 * b * math.prod(spatial) * k * cin * cout,
              grad_a, grad_b)


def _mm(part, name, m, k, n, grad_a=False, grad_b=False):
    return Op(part, name, 2 * m * k * n, grad_a, grad_b)


def _half(spatial, times):
    return tuple(s // 2 ** times for s in spatial)


def vit_generator_ops(cfg: dict, b: int, trained: bool) -> list:
    """The GAN-ViT generator's ops at batch ``b``.  ``trained``: a Stage-1
    step, every weight trained and every input gradient taken but the
    MRI's."""
    g = cfg["generator"]
    f, img = g["f_maps"], tuple(cfg["img_size"])
    levels = len(f)
    ops = []

    def conv(name, spatial, cin, cout, k=27, first=False):
        ops.append(_conv("generator", name, b, spatial, cin, cout, k,
                         trained and not first, trained))

    for i in range(levels):
        s = _half(img, i)
        cin = 1 if i == 0 else f[i - 1]
        shortcut = cin != f[i]
        if shortcut:
            conv(f"enc{i}.conv1", s, cin, f[i], 1, first=i == 0)
        conv(f"enc{i}.conv2", s, f[i], f[i], first=i == 0 and not shortcut)
        conv(f"enc{i}.conv3", s, f[i], f[i])
    bx, by, bz = _half(img, levels - 1)
    fold, p = g["fold_factor"], g["vit_patch_size"]
    h, w = by * fold, (bx // fold) * bz
    n = (h // p) * (w // p)
    pd, d = f[-1] * p * p, g["vit_dim"]
    inner = g["vit_heads"] * g["vit_dim_head"]
    t = n + 1

    def mm(name, m, k, nn, grad_b=True):
        ops.append(_mm("generator", name, m, k, nn, trained, trained and
                       grad_b))

    mm("vit.embed", b * n, pd, d)
    for i in range(g["vit_depth"]):
        mm(f"vit.{i}.qkv", b * t, d, 3 * inner)
        mm(f"vit.{i}.qk", b * g["vit_heads"] * t, g["vit_dim_head"], t)
        mm(f"vit.{i}.av", b * g["vit_heads"] * t, t, g["vit_dim_head"])
        mm(f"vit.{i}.out", b * t, inner, d)
        mm(f"vit.{i}.ff1", b * t, d, g["vit_mlp_dim"])
        mm(f"vit.{i}.ff2", b * t, g["vit_mlp_dim"], d)
    mm("vit.tokens", b * d, t, n)
    mm("vit.unembed", b * n, d, pd)
    for j in range(levels - 1):
        lo, hi = levels - 1 - j, levels - 2 - j
        ops.append(_conv("generator", f"dec{j}.deconv", b, _half(img, lo),
                         f[lo], f[hi], 27, trained, trained))
        conv(f"dec{j}.conv2", _half(img, hi), f[hi], f[hi])
        conv(f"dec{j}.conv3", _half(img, hi), f[hi], f[hi])
    conv("final", img, f[0], 1, 1)
    return ops


def gfe_mamba_ops(cfg: dict, b: int, train: str | None = None) -> list:
    """The whole pipeline's ops at batch ``b``.  ``train``: None (serving),
    'stage2' (generator frozen, no gradient through it; combiner and
    classifier trained; no gradient into the volumes) or 'stage1' (the
    generator alone, see :func:`vit_generator_ops`)."""
    if train == "stage1":
        return vit_generator_ops(cfg, b, True)
    tr = train == "stage2"
    ops = vit_generator_ops(cfg, b, False)
    g, hd = cfg["generator"], cfg["head"]
    img = tuple(cfg["img_size"])
    bx, by, bz = _half(img, len(g["f_maps"]) - 1)
    hw = by * g["fold_factor"] * (bx // g["fold_factor"]) * bz
    c2 = 2 * g["f_maps"][-1]
    ops.append(_mm("combiner", "combine", b * c2, hw, hd["seq_length"],
                   False, tr))
    d, heads = hd["dim"], hd["heads"]
    ed, ns, k = hd["expand"] * d, hd["d_state"], hd["d_conv"]
    r = hd["dt_rank"]
    T = 1 + len(hd["categories"]) + hd["num_continuous"] + hd["seq_length"]

    def mm(name, m, kk, n, grad_a=True):
        ops.append(_mm("classifier", name, m, kk, n, tr and grad_a, tr))

    for i in range(hd["depth"]):
        mm(f"mamba{i}.in_proj", b * T, d, 2 * ed)
        ops.append(Op("classifier", f"mamba{i}.conv1d",
                      2 * b * (T + k - 1) * k * ed, tr, tr))
        mm(f"mamba{i}.x_proj", b * T, ed, r + 2 * ns)
        mm(f"mamba{i}.dt_proj", b * T, r, ed)
        mm(f"mamba{i}.out_proj", b * T, ed, d)
    x, y, z = img
    m_tok, d_cross = 2 * z, x * y
    mm("cross.q", b, d, d)
    mm("cross.k", b * m_tok, d_cross, d, grad_a=False)
    mm("cross.v", b * m_tok, d_cross, d, grad_a=False)
    mm("cross.qk", b * heads, d // heads, m_tok)
    mm("cross.av", b * heads, m_tok, d // heads)
    mm("cross.out", b, d, d)
    mm("feed.1", b, d, 4 * d)
    mm("feed.4", b, 2 * d, d)
    mm("logits", b, d, hd["dim_out"])
    return ops


def unet3d_ops(cfg: dict, b: int, train: bool) -> list:
    """pytorch-3dunet's UNet3D (DoubleConv, nearest upsampling joined by
    concatenation) at batch ``b`` on ``cfg['patch']``; in a step every
    weight is trained and every input gradient taken but the data's (a
    GroupNorm ahead of the first conv takes it through that conv)."""
    f = [cfg["f_maps"] * 2 ** i for i in range(cfg["num_levels"])]
    patch = tuple(cfg["patch"])
    order = cfg["layer_order"]
    norm_first = "g" in order and order.index("g") < order.index("c")
    ops = []

    def conv(name, spatial, cin, cout, k=27, first=False):
        ops.append(_conv("unet", name, b, spatial, cin, cout, k,
                         train and not first, train))

    for i, fi in enumerate(f):
        cin = cfg["in_channels"] if i == 0 else f[i - 1]
        c1 = max(fi // 2, cin)
        conv(f"enc{i}.conv1", _half(patch, i), cin, c1,
             first=i == 0 and not norm_first)
        conv(f"enc{i}.conv2", _half(patch, i), c1, fi)
    for j in range(len(f) - 1):
        lo, hi = len(f) - 1 - j, len(f) - 2 - j
        conv(f"dec{j}.conv1", _half(patch, hi), f[hi] + f[lo], f[hi])
        conv(f"dec{j}.conv2", _half(patch, hi), f[hi], f[hi])
    conv("final", patch, f[0], cfg["out_channels"], 1)
    return ops


def _down(n: int, k: int, stride: int, pad_lo: int, pad_hi: int) -> int:
    return (n + pad_lo + pad_hi - k) // stride + 1


def patchgan_ops(layers: int, ch: int, img, b: int, role: str) -> list:
    """The PatchGAN discriminator's ops on one ``(b, *img, 1)`` volume.
    ``role``: 'g_loss' (weights frozen, the input gradient taken back to
    the volume) or 'd_step' (weights trained, no gradient into the
    volume)."""
    spatial, ops, k = tuple(img), [], 4
    widths = [(1, ch, 2)] + [(ch * 2 ** (i - 1), ch * 2 ** i, 2)
                             for i in range(1, layers)]
    widths += [(ch * 2 ** (layers - 1), ch * 2 ** layers, 1),
               (ch * 2 ** layers, 1, 1)]
    for i, (cin, cout, stride) in enumerate(widths):
        spatial = tuple(_down(n, k, stride, 1, max(1, k - n - 1))
                        for n in spatial)
        ops.append(_conv("discriminator", f"{role}.conv{i}", b, spatial,
                         cin, cout, k ** 3,
                         grad_a=role == "g_loss" or i > 0,
                         grad_b=role == "d_step"))
    return ops


FIRES = ((64, 16, 64), (128, 16, 64), (128, 32, 128), (256, 32, 128),
         (256, 48, 192), (384, 48, 192), (384, 64, 256), (512, 64, 256))


def squeezenet_ops(n: int, h: int, w: int, grad: bool, tag: str) -> list:
    """The frozen SqueezeNet-1.1 trunk on ``n`` 3-channel ``h x w``
    images; ``grad``: the input gradient is taken."""
    ops = []

    def conv(name, hh, ww, cin, cout, k):
        ops.append(Op("perceptual", f"{tag}.{name}",
                      2 * n * hh * ww * k * k * cin * cout, grad, False))

    h, w = _down(h, 3, 2, 0, 0), _down(w, 3, 2, 0, 0)
    conv("conv1", h, w, 3, 64, 3)
    for i, (cin, sq, ex) in enumerate(FIRES, start=1):
        if i in (1, 3, 5):
            h, w = _down(h, 3, 2, 0, 0), _down(w, 3, 2, 0, 0)
        conv(f"fire{i}.squeeze", h, w, cin, sq, 1)
        conv(f"fire{i}.expand1x1", h, w, sq, ex, 1)
        conv(f"fire{i}.expand3x3", h, w, sq, ex, 3)
    return ops


def perceptual_ops(img, b: int, ratio: float) -> list:
    """The 2.5D perceptual loss: per axis a quarter of the slices of the
    prediction (input gradient taken) and of the target."""
    ops = []
    for axis in range(3):
        take = max(1, int(img[axis] * ratio))
        h, w = [n for i, n in enumerate(img) if i != axis]
        if min(h, w) < 32:
            scale = 32 / min(h, w)
            h, w = max(32, int(h * scale)), max(32, int(w * scale))
        ops += squeezenet_ops(b * take, h, w, True, f"pred{axis}")
        ops += squeezenet_ops(b * take, h, w, False, f"target{axis}")
    return ops


def stage1_ops(cfg: dict, b: int) -> list:
    """A Stage-1 step: the generator trained, the perceptual trunk frozen
    on both volumes, the discriminator frozen on the reconstruction for
    the generator's loss and trained on the reconstruction and the PET."""
    s1, img = cfg["stage1"], tuple(cfg["img_size"])
    layers, ch = s1["discriminator_layers"], s1["discriminator_channels"]
    return (vit_generator_ops(cfg, b, True)
            + perceptual_ops(img, b, s1["fake_3d_ratio"])
            + patchgan_ops(layers, ch, img, b, "g_loss")
            + 2 * patchgan_ops(layers, ch, img, b, "d_step"))


def total(ops, step: bool) -> int:
    return sum(op.step_flops() if step else op.flops for op in ops)
