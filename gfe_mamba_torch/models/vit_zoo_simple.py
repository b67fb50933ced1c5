"""ViT zoo, round 3: the simple, 1D and token-surgery variants
(counterpart of ``gfe_mamba_tpu/models/vit_zoo_simple.py``).

Inputs are channels-last as in JAX: series ``(B, L, C)``, images ``(B, H,
W, C)``.  The JAX classes' fields and defaults; the input's channel count
is a keyword-only ``channels`` after them.  Submodules keep the flax
names (``patch_norm1``, ``attn_0.to_qkv``, ``ff_0.fc1``, ...), so a
model's state_dict is its flax tree in torch layouts
(``utils/convert_zoo.py``).

Reference quirks that JAX keeps are kept: ViTPatchDropout's position
table has no CLS row and its mean pooling includes CLS; LocalViT
normalizes its depthwise feed-forward over channels; ViTWithPatchMerger's
head is a bare Linear over the token mean and its position table keeps an
unused row.  Patch dropout draws its scores from a ``torch.Generator``
(:class:`PatchDropout`, a ``Dropout`` that ``seed_dropout`` seeds).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.vit_zoo import (_pair, _pool, _posemb_sincos_2d,
                                            _prepend, patchify)
from gfe_mamba_torch.models.vit_zoo_extra import ConvCL, _add, _gelu, _ln


def _posemb_sincos_1d(n: int, dim: int, temperature: float = 10000.0,
                      device=None) -> torch.Tensor:
    """Fixed 1D sincos table ``(n, dim)`` (omega's denominator dim//2 - 1)."""
    pos = torch.arange(n, device=device)
    omega = torch.arange(dim // 2, device=device) / (dim // 2 - 1)
    omega = 1.0 / (temperature ** omega)
    ang = pos[:, None] * omega[None, :]
    return torch.cat([ang.sin(), ang.cos()], dim=1)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``b n (h d) -> b h n d``."""
    return t.reshape(*t.shape[:2], heads, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """``b h n d -> b n (h d)``."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)


class _Attention(nn.Module):
    """Pre-LN multi-head attention; ``out_bias=False`` is the simple-vit
    flavour, and heads == 1 with dim_head == dim has no output
    projection."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, out_bias: bool = True):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False)
        self.attn_drop = Dropout(dropout)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.to_out = nn.Linear(heads * dim_head, dim, bias=out_bias)
            self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        q = q * self.dim_head ** -0.5
        attn = self.attn_drop(torch.softmax(
            torch.einsum("bhid,bhjd->bhij", q, k), dim=-1))
        out = _merge(torch.einsum("bhij,bhjd->bhid", attn, v))
        return self.out_drop(self.to_out(out)) if self.project_out else out


class _FeedForward(nn.Module):
    """Pre-LN MLP: norm -> fc1 -> GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.norm = _ln(dim)
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(_gelu(self.fc1(self.norm(x))))))


class PatchDropout(Dropout):
    """Patch dropout (simple_vit_with_patch_dropout.py): in train mode
    keep ``max(1, int(n * (1 - p)))`` tokens of each sample, those of the
    top scores of a standard normal draw, in that order; the identity in
    eval mode.  Scores come from :meth:`scores` (the generator that
    ``seed_dropout`` attaches)."""

    def scores(self, rows: int, n: int, device) -> torch.Tensor:
        draw = torch.randn(rows * self.data_size, n,
                           generator=self.generator, device=device)
        return draw[self.data_index * rows:(self.data_index + 1) * rows]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("PatchDropout in train mode needs a "
                               "generator: call seed_dropout(model, "
                               "generator)")
        b, n = x.shape[:2]
        keep = max(1, int(n * (1.0 - self.p)))
        idx = self.scores(b, n, x.device).topk(keep, dim=1).indices
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class _Stack(nn.Module):
    """The shared body of the members below: ``attn_<i>`` and ``ff_<i>``
    residual layers."""

    def _layers(self, depth: int, make_attn, make_ff) -> None:
        self.depth = depth
        _add(self, "attn", depth, make_attn)
        _add(self, "ff", depth, make_ff)

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(x)
            x = x + getattr(self, f"ff_{i}")(x)
        return x


class _SimpleBody(_Stack):
    """Patch norm / projection / norm, a fixed sincos table, simple-vit
    layers (bias-free attention output), final norm and linear head over
    the mean of the tokens ``pooled``."""

    def _simple(self, patch_dim: int, dim: int, depth: int, heads: int,
                mlp_dim: int, dim_head: int, num_classes: int,
                pos: torch.Tensor, attn=None) -> None:
        self.patch_norm1 = _ln(patch_dim)
        self.patch_proj = nn.Linear(patch_dim, dim)
        self.patch_norm2 = _ln(dim)
        self.register_buffer("pos", pos, persistent=False)
        attn = attn or (lambda i: _Attention(dim, heads, dim_head,
                                             out_bias=False))
        self._layers(depth, attn, lambda i: _FeedForward(dim, mlp_dim))
        self.final_norm = _ln(dim)
        self.linear_head = nn.Linear(dim, num_classes)

    def _embed(self, patches: torch.Tensor) -> torch.Tensor:
        x = self.patch_norm2(self.patch_proj(self.patch_norm1(patches)))
        return x + self.pos.to(x.dtype)


class SimpleViT1D(_SimpleBody):
    """simple_vit_1d.py over ``(B, L, C)`` series."""

    def __init__(self, seq_len: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64, *, channels: int = 3):
        super().__init__()
        if seq_len % patch_size:
            raise ValueError("seq_len must be divisible by patch_size")
        self.patch = patch_size
        self._simple(patch_size * channels, dim, depth, heads, mlp_dim,
                     dim_head, num_classes,
                     _posemb_sincos_1d(seq_len // patch_size, dim))

    def features(self, series: torch.Tensor) -> torch.Tensor:
        x = self._run(self._embed(patchify(series, (self.patch,))))
        return self.final_norm(x).mean(dim=1)

    def forward(self, series: torch.Tensor) -> torch.Tensor:
        return self.linear_head(self.features(series))


class _ClsBody(_Stack):
    """CLS token, learned positions, ``head_norm`` and ``head`` over the
    pooled token (the vit-style members)."""

    def _cls(self, dim: int, num_patches: int, num_classes: int,
             emb_dropout: float, cls_shape=(1, 1), pos_shape=None) -> None:
        self.cls_token = nn.Parameter(torch.empty(*cls_shape, dim))
        self.pos_embedding = nn.Parameter(torch.empty(
            *(pos_shape or (1, num_patches + 1)), dim))
        self.emb_drop = Dropout(emb_dropout)
        self.head_norm = _ln(dim)
        self.head = nn.Linear(dim, num_classes)

    def _with_cls(self, x: torch.Tensor) -> torch.Tensor:
        x = _prepend(self.cls_token.reshape(1, 1, -1), x)
        return self.emb_drop(x + self.pos_embedding[:, :x.shape[1]]
                             .to(x.dtype))


class ViT1D(_ClsBody):
    """vit_1d.py over ``(B, L, C)`` series, a CLS head."""

    def __init__(self, seq_len: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        if seq_len % patch_size:
            raise ValueError("seq_len must be divisible by patch_size")
        self.patch = patch_size
        self.patch_norm1 = _ln(patch_size * channels)
        self.patch_proj = nn.Linear(patch_size * channels, dim)
        self.patch_norm2 = _ln(dim)
        self._cls(dim, seq_len // patch_size, num_classes, emb_dropout,
                  cls_shape=())
        self._layers(depth,
                     lambda i: _Attention(dim, heads, dim_head, dropout),
                     lambda i: _FeedForward(dim, mlp_dim, dropout))

    def features(self, series: torch.Tensor) -> torch.Tensor:
        x = self.patch_norm2(self.patch_proj(self.patch_norm1(
            patchify(series, (self.patch,)))))
        return self.head_norm(self._run(self._with_cls(x))[:, 0])

    def forward(self, series: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(series))


class SimpleViTPatchDropout(_SimpleBody):
    """simple_vit_with_patch_dropout.py: SimpleViT whose tokens go
    through :class:`PatchDropout` after the position add."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, dim_head: int = 64,
                 patch_dropout: float = 0.5, *, channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        p1, p2 = self.patch
        self._simple(p1 * p2 * channels, dim, depth, heads, mlp_dim,
                     dim_head, num_classes,
                     _posemb_sincos_2d(h // p1, w // p2, dim))
        self.patch_dropout = PatchDropout(patch_dropout)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_dropout(self._embed(patchify(img, self.patch)))
        return self.final_norm(self._run(x)).mean(dim=1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.linear_head(self.features(img))


class ViTPatchDropout(_ClsBody):
    """vit_with_patch_dropout.py: the position table has no CLS row (the
    CLS token carries no position) and 'mean' pooling averages CLS and
    the patch tokens, as the reference has them."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls",
                 dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, patch_dropout: float = 0.25, *,
                 channels: int = 3):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        p1, p2 = self.patch
        num_patches = (h // p1) * (w // p2)
        self.pool = pool
        self.patch_proj = nn.Linear(p1 * p2 * channels, dim)
        self._cls(dim, num_patches, num_classes, emb_dropout,
                  pos_shape=(num_patches,))
        self.patch_dropout = PatchDropout(patch_dropout)
        self._layers(depth,
                     lambda i: _Attention(dim, heads, dim_head, dropout),
                     lambda i: _FeedForward(dim, mlp_dim, dropout))

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_proj(patchify(img, self.patch))
        x = self.patch_dropout(x + self.pos_embedding.to(x.dtype))
        x = self._run(self.emb_drop(_prepend(self.cls_token, x)))
        return self.head_norm(_pool(x, self.pool))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


class _QKNormAttention(nn.Module):
    """simple_vit_with_qk_norm.py: q and k L2-normalized per head and
    scaled by sqrt(dim_head) times a learned gamma (initialized to
    1/sqrt(dim_head)); no further logit scale."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.scale = heads, dim_head ** 0.5
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False)
        self.q_gamma = nn.Parameter(torch.empty(heads, 1, dim_head))
        self.k_gamma = nn.Parameter(torch.empty(heads, 1, dim_head))
        self.to_out = nn.Linear(heads * dim_head, dim, bias=False)

    def reset_extra(self, generator: torch.Generator) -> None:
        self.q_gamma.fill_(1.0 / self.scale)
        self.k_gamma.fill_(1.0 / self.scale)

    def _rms(self, t: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        return t / norm.clamp(min=1e-12) * self.scale * gamma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        attn = torch.softmax(torch.einsum(
            "bhid,bhjd->bhij", self._rms(q, self.q_gamma),
            self._rms(k, self.k_gamma)), dim=-1)
        return self.to_out(_merge(torch.einsum("bhij,bhjd->bhid", attn, v)))


class SimpleViTQKNorm(_SimpleBody):
    """simple_vit_with_qk_norm.py."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, dim_head: int = 64, *,
                 channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        p1, p2 = self.patch
        self._simple(p1 * p2 * channels, dim, depth, heads, mlp_dim,
                     dim_head, num_classes,
                     _posemb_sincos_2d(h // p1, w // p2, dim),
                     attn=lambda i: _QKNormAttention(dim, heads, dim_head))

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self._run(self._embed(patchify(img, self.patch)))
        return self.final_norm(x).mean(dim=1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.linear_head(self.features(img))


class SimpleViTRegisterTokens(_SimpleBody):
    """simple_vit_with_register_tokens.py: learned register tokens
    appended after the position add; only the patch tokens are pooled."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int,
                 num_register_tokens: int = 4, dim_head: int = 64, *,
                 channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        p1, p2 = self.patch
        self._simple(p1 * p2 * channels, dim, depth, heads, mlp_dim,
                     dim_head, num_classes,
                     _posemb_sincos_2d(h // p1, w // p2, dim))
        self.register_tokens = nn.Parameter(torch.empty(num_register_tokens,
                                                        dim))

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self._embed(patchify(img, self.patch))
        n = x.shape[1]
        reg = self.register_tokens.to(x.dtype).expand(x.shape[0], -1, -1)
        x = self.final_norm(self._run(torch.cat([x, reg], dim=1)))
        return x[:, :n].mean(dim=1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.linear_head(self.features(img))


class SimpleViTFFT(_SimpleBody):
    """simple_vit_with_fft.py: a second token stream from the image's 2D
    FFT (real and imaginary parts stacked), put before the patch tokens;
    only the patch tokens are pooled."""

    def __init__(self, image_size, patch_size, freq_patch_size,
                 num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, dim_head: int = 64, *, channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        p1, p2 = self.patch
        self.freq_patch = f1, f2 = _pair(freq_patch_size)
        self._simple(p1 * p2 * channels, dim, depth, heads, mlp_dim,
                     dim_head, num_classes,
                     _posemb_sincos_2d(h // p1, w // p2, dim))
        self.freq_norm1 = _ln(f1 * f2 * 2 * channels)
        self.freq_proj = nn.Linear(f1 * f2 * 2 * channels, dim)
        self.freq_norm2 = _ln(dim)
        self.register_buffer("freq_pos",
                             _posemb_sincos_2d(h // f1, w // f2, dim),
                             persistent=False)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self._embed(patchify(img, self.patch))
        freqs = torch.fft.fft2(img, dim=(1, 2))
        # b (h p1) (w p2) c ri -> b (h w) (p1 p2 ri c)
        freqs = torch.stack([freqs.real, freqs.imag], dim=-2)
        b, hh, ww = freqs.shape[:3]
        f = patchify(freqs.reshape(b, hh, ww, -1), self.freq_patch)
        f = self.freq_norm2(self.freq_proj(self.freq_norm1(f)))
        f = f + self.freq_pos.to(f.dtype)
        tokens = self.final_norm(self._run(torch.cat([f, x], dim=1)))
        return tokens[:, f.shape[1]:].mean(dim=1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.linear_head(self.features(img))


class PatchMerger(nn.Module):
    """vit_with_patch_merger.py: learned-query attention pooling to
    ``num_tokens_out`` tokens."""

    def __init__(self, dim: int, num_tokens_out: int):
        super().__init__()
        self.scale = dim ** -0.5
        self.norm = _ln(dim)
        self.queries = nn.Parameter(torch.empty(num_tokens_out, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(x)
        sim = torch.einsum("qd,bnd->bqn", self.queries, y) * self.scale
        return torch.einsum("bqn,bnd->bqd", torch.softmax(sim, dim=-1), y)


class ViTWithPatchMerger(_Stack):
    """vit_with_patch_merger.py: no CLS; the merger after layer
    ``patch_merge_layer or depth // 2`` (1-based); the head a bare Linear
    over the token mean; the learned position table keeps the reference's
    unused extra row."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int,
                 patch_merge_layer: Optional[int] = None,
                 patch_merge_num_tokens: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        p1, p2 = self.patch
        num_patches = (h // p1) * (w // p2)
        self.patch_norm1 = _ln(p1 * p2 * channels)
        self.patch_proj = nn.Linear(p1 * p2 * channels, dim)
        self.patch_norm2 = _ln(dim)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1,
                                                      dim))
        self.emb_drop = Dropout(emb_dropout)
        self.merge_at = (patch_merge_layer or depth // 2) - 1
        self._layers(depth,
                     lambda i: _Attention(dim, heads, dim_head, dropout),
                     lambda i: _FeedForward(dim, mlp_dim, dropout))
        self.patch_merger = PatchMerger(dim, patch_merge_num_tokens)
        self.final_norm = _ln(dim)
        self.head = nn.Linear(dim, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_norm2(self.patch_proj(self.patch_norm1(
            patchify(img, self.patch))))
        x = self.emb_drop(x + self.pos_embedding[:, :x.shape[1]].to(x.dtype))
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(x)
            x = x + getattr(self, f"ff_{i}")(x)
            if i == self.merge_at:
                x = self.patch_merger(x)
        return self.final_norm(x).mean(dim=1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


class _SPT(nn.Module):
    """vit_for_small_dataset.py's shifted patch tokenization: the image
    and four one-pixel zero-filled shifts (W right, W left, H down, H up)
    concatenated on channels, patched, normed and projected."""

    def __init__(self, dim: int, patch_size: int, channels: int):
        super().__init__()
        self.patch = patch_size
        patch_dim = patch_size * patch_size * 5 * channels
        self.norm = _ln(patch_dim)
        self.proj = nn.Linear(patch_dim, dim)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        zc, zr = torch.zeros_like(img[:, :, :1]), torch.zeros_like(img[:, :1])
        shifted = [img,
                   torch.cat([zc, img[:, :, :-1]], dim=2),
                   torch.cat([img[:, :, 1:], zc], dim=2),
                   torch.cat([zr, img[:, :-1]], dim=1),
                   torch.cat([img[:, 1:], zr], dim=1)]
        x = patchify(torch.cat(shifted, dim=-1), (self.patch,) * 2)
        return self.proj(self.norm(x))


class _LSA(nn.Module):
    """Locality self-attention: a learned log temperature scales the
    logits and each token's own logit is masked out."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False)
        self.temperature = nn.Parameter(torch.empty(()))
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(heads * dim_head, dim)
        self.out_drop = Dropout(dropout)

    def reset_extra(self, generator: torch.Generator) -> None:
        self.temperature.fill_(float(torch.tensor(self.dim_head ** -0.5)
                                     .log()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        dots = torch.einsum("bhid,bhjd->bhij", q, k) * self.temperature.exp()
        eye = torch.eye(dots.shape[-1], dtype=torch.bool, device=x.device)
        dots = dots.masked_fill(eye, torch.finfo(dots.dtype).min)
        attn = self.attn_drop(torch.softmax(dots, dim=-1))
        out = _merge(torch.einsum("bhij,bhjd->bhid", attn, v))
        return self.out_drop(self.to_out(out))


class ViTForSmallDataset(_ClsBody):
    """vit_for_small_dataset.py (SPT + LSA)."""

    def __init__(self, image_size, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 pool: str = "cls", dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        h, w = _pair(image_size)
        self.pool = pool
        self.to_patch = _SPT(dim, patch_size, channels)
        self._cls(dim, (h // patch_size) * (w // patch_size), num_classes,
                  emb_dropout)
        self._layers(depth, lambda i: _LSA(dim, heads, dim_head, dropout),
                     lambda i: _FeedForward(dim, mlp_dim, dropout))

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self._run(self._with_cls(self.to_patch(img)))
        return self.head_norm(_pool(x, self.pool))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


class ParallelViT(_ClsBody):
    """parallel_vit.py: per layer, the sum of ``num_parallel_branches``
    attention branches, then of as many feed-forward branches; the patch
    embedding has no LayerNorms."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls",
                 num_parallel_branches: int = 2, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        p1, p2 = self.patch
        self.pool, self.depth = pool, depth
        self.branches = num_parallel_branches
        self.patch_proj = nn.Linear(p1 * p2 * channels, dim)
        self._cls(dim, (h // p1) * (w // p2), num_classes, emb_dropout)
        for i in range(depth):
            _add(self, f"attn_{i}", num_parallel_branches,
                 lambda j: _Attention(dim, heads, dim_head, dropout))
            _add(self, f"ff_{i}", num_parallel_branches,
                 lambda j: _FeedForward(dim, mlp_dim, dropout))

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self._with_cls(self.patch_proj(patchify(img, self.patch)))
        for i in range(self.depth):
            for kind in ("attn", "ff"):
                x = x + sum(getattr(self, f"{kind}_{i}_{j}")(x)
                            for j in range(self.branches))
        return self.head_norm(_pool(x, self.pool))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


class _LocalFeedForward(nn.Module):
    """local_vit.py's feed-forward on the 2D patch grid: 1x1 -> hardswish
    -> depthwise 3x3 -> hardswish -> 1x1, normed over channels first."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.norm = _ln(dim)
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.dw = ConvCL(hidden_dim, hidden_dim, 3, 1, 1, groups=hidden_dim)
        self.drop = Dropout(dropout)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        side = int(round(n ** 0.5))
        y = self.norm(x.reshape(b, side, -1, c))
        y = F.hardswish(self.dw(F.hardswish(self.fc1(y))))
        y = self.drop(self.fc2(self.drop(y)))
        return y.reshape(b, n, c)


class LocalViT(_ClsBody):
    """local_vit.py: the feed-forward is a depthwise-conv block on the 2D
    grid, the CLS token left out of it."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("image_size must be divisible by patch_size")
        self.patch = (patch_size, patch_size)
        self.patch_norm1 = _ln(patch_size * patch_size * channels)
        self.patch_proj = nn.Linear(patch_size * patch_size * channels, dim)
        self.patch_norm2 = _ln(dim)
        self._cls(dim, (image_size // patch_size) ** 2, num_classes,
                  emb_dropout)
        self._layers(depth,
                     lambda i: _Attention(dim, heads, dim_head, dropout),
                     lambda i: _LocalFeedForward(dim, mlp_dim, dropout))

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_norm2(self.patch_proj(self.patch_norm1(
            patchify(img, self.patch))))
        x = self._with_cls(x)
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(x)
            patches = x[:, 1:] + getattr(self, f"ff_{i}")(x[:, 1:])
            x = torch.cat([x[:, :1], patches], dim=1)
        return self.head_norm(x[:, 0])

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


class EfficientViT(_ClsBody):
    """efficient.py: the ViT shell around a pluggable ``transformer``
    module (any ``(B, N, D) -> (B, N, D)`` module, such as the port's
    ``models/vit.py::Transformer``)."""

    def __init__(self, image_size, patch_size: int, num_classes: int,
                 dim: int, transformer: nn.Module, pool: str = "cls", *,
                 channels: int = 3):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        h, w = _pair(image_size)
        self.patch, self.pool = (patch_size, patch_size), pool
        self.patch_norm1 = _ln(patch_size * patch_size * channels)
        self.patch_proj = nn.Linear(patch_size * patch_size * channels, dim)
        self.patch_norm2 = _ln(dim)
        self._cls(dim, (h // patch_size) * (w // patch_size), num_classes,
                  0.0)
        self.transformer = transformer

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_norm2(self.patch_proj(self.patch_norm1(
            patchify(img, self.patch))))
        x = self.transformer(self._with_cls(x))
        return self.head_norm(_pool(x, self.pool))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


class _FusedAttention(nn.Module):
    """simple_flash_attn_vit.py's attention through
    ``F.scaled_dot_product_attention`` (JAX's ``dot_product_attention``)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False)
        self.to_out = nn.Linear(heads * dim_head, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        return self.to_out(_merge(F.scaled_dot_product_attention(q, k, v)))


class SimpleFlashAttnViT(_SimpleBody):
    """simple_flash_attn_vit.py: SimpleViT with fused attention."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, dim_head: int = 64, *,
                 channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        p1, p2 = self.patch
        self._simple(p1 * p2 * channels, dim, depth, heads, mlp_dim,
                     dim_head, num_classes,
                     _posemb_sincos_2d(h // p1, w // p2, dim),
                     attn=lambda i: _FusedAttention(dim, heads, dim_head))

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self._run(self._embed(patchify(img, self.patch)))
        return self.final_norm(x).mean(dim=1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.linear_head(self.features(img))
