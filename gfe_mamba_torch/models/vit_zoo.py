"""ViT zoo: classifier ViTs (2D/3D), SimpleViT, MAE and DINO (counterpart
of ``gfe_mamba_tpu/models/vit_zoo.py``).

Inputs keep the JAX package's channels-last layouts: images ``(B, H, W,
C)``, volumes ``(B, H, W, D, C)``.  Constructors take the JAX classes'
fields and defaults; the widths flax infers from the input (``channels``,
DINO's ``dim``) are keyword-only arguments after them.  flax defaults
hold: LayerNorm eps 1e-6, tanh GELU.

Submodule names: ``ViT3D`` carries the vendored vit_3d.py's state_dict
keys (``utils/torch_import.py::import_vit3d``); ``ClassifierViT`` and
``SimpleViT`` the vit.py / simple_vit.py names of their patch embedding
(``to_patch_embedding.1/2/3``); every ``transformer`` is the port's
``models/vit.py::Transformer``.  ``utils/convert_zoo.py`` carries JAX
variables over.

Fixed tables (sincos position embeddings) are non-persistent buffers,
built at construction and moved with the module.  Random draws come from
an explicit ``torch.Generator``, each in one small method that tests can
replace (``MAE.permutation``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.vit import LN_EPS, Transformer
from gfe_mamba_torch.utils.initializers import init_weights


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def patchify(x: torch.Tensor, patch: Sequence[int],
             order: Sequence[int] | None = None) -> torch.Tensor:
    """``b (g1 p1) (g2 p2) .. c -> b (g1 g2 ..) (p_order.. c)``: cut the
    spatial axes of a channels-last tensor into ``patch`` blocks, tokens
    in grid order, each token's features in the patch axes' ``order``
    (default 0, 1, ..) then channels."""
    b, *sizes, c = x.shape
    n = len(sizes)
    order = range(n) if order is None else order
    split = [b]
    for size, p in zip(sizes, patch):
        split += [size // p, p]
    x = x.reshape(*split, c)
    x = x.permute(0, *(1 + 2 * i for i in range(n)),
                  *(2 + 2 * i for i in order), 2 * n + 1)
    return x.reshape(b, math.prod(s // p for s, p in zip(sizes, patch)), -1)


class Patches(nn.Module):
    """:func:`patchify` as a module (the reference's ``Rearrange``)."""

    def __init__(self, patch: Sequence[int],
                 order: Sequence[int] | None = None):
        super().__init__()
        self.patch, self.order = tuple(patch), order

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patchify(x, self.patch, self.order)


def _patch_embedding(patch_dim: int, dim: int, patches: Patches
                     ) -> nn.Sequential:
    """``to_patch_embedding``: patches -> LayerNorm -> Linear -> LayerNorm."""
    return nn.Sequential(patches, nn.LayerNorm(patch_dim, eps=LN_EPS),
                         nn.Linear(patch_dim, dim),
                         nn.LayerNorm(dim, eps=LN_EPS))


def _prepend(token: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``token`` (1, 1, D) broadcast over the batch and put before ``x``."""
    return torch.cat([token.to(x.dtype).expand(x.shape[0], -1, -1), x], 1)


def _pool(x: torch.Tensor, pool: str) -> torch.Tensor:
    return x[:, 0] if pool == "cls" else x.mean(dim=1)


def _posemb_sincos_2d(h: int, w: int, dim: int,
                      temperature: float = 10000.0,
                      device=None) -> torch.Tensor:
    """Fixed 2D sincos table ``(h * w, dim)``: dim // 4 frequencies, the
    columns ``[sin x, cos x, sin y, cos y]``, f32 as JAX computes it."""
    y, x = torch.meshgrid(torch.arange(h, device=device),
                          torch.arange(w, device=device), indexing="ij")
    omega = torch.arange(dim // 4, device=device) / (dim // 4 - 1)
    omega = 1.0 / (temperature ** omega)
    y = y.reshape(-1)[:, None] * omega
    x = x.reshape(-1)[:, None] * omega
    return torch.cat([x.sin(), x.cos(), y.sin(), y.cos()], dim=1)


class ClassifierViT(nn.Module):
    """Standard ViT classifier: patchify -> LN/Linear/LN -> CLS + pos ->
    transformer -> cls/mean pool -> Linear."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls",
                 dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        (h, w), (p1, p2) = _pair(image_size), _pair(patch_size)
        num_patches = (h // p1) * (w // p2)
        self.pool = pool
        self.to_patch_embedding = _patch_embedding(
            p1 * p2 * channels, dim, Patches((p1, p2)))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1,
                                                      dim))
        self.dropout = Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dropout)
        self.mlp_head = nn.Linear(dim, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """The pooled features the head reads."""
        x = _prepend(self.cls_token, self.to_patch_embedding(img))
        x = self.dropout(x + self.pos_embedding.to(x.dtype))
        return _pool(self.transformer(x), self.pool)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.features(img))


class ViT3D(nn.Module):
    """3D volumetric ViT classifier (vit_3d.py) over ``(B, H, W, D, C)``
    volumes, under the reference's state_dict keys: the transformer has no
    final norm of its own; ``mlp_head.0`` (a LayerNorm) normalizes every
    token before the pooling and ``mlp_head.1`` reads the pooled token, as
    JAX's ``ViT3D`` has it (for cls pooling the same function as the
    reference's).  ``pos_embedding`` keeps the reference's ``(f h w)``
    row order; the tokens run in JAX's ``(h w f)`` order, and the table is
    permuted to it in the forward."""

    def __init__(self, image_size: Sequence[int], image_depth: int,
                 patch_size: int, depth_patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 pool: str = "cls", dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        h, w = _pair(image_size)
        p, pd = patch_size, depth_patch_size
        self.grid = (image_depth // pd, h // p, w // p)       # (f, h, w)
        self.pool = pool
        self.to_patch_embedding = _patch_embedding(
            p * p * pd * channels, dim, Patches((p, p, pd)))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(
            torch.empty(1, math.prod(self.grid) + 1, dim))
        self.dropout = Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dropout)
        self.transformer.norm = nn.Identity()
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim, eps=LN_EPS),
                                      nn.Linear(dim, num_classes))

    def _pos(self) -> torch.Tensor:
        f, h, w = self.grid
        pos = self.pos_embedding
        rest = pos[:, 1:].reshape(1, f, h, w, -1).permute(0, 2, 3, 1, 4)
        return torch.cat([pos[:, :1], rest.reshape(1, f * h * w, -1)], 1)

    def features(self, vol: torch.Tensor) -> torch.Tensor:
        x = _prepend(self.cls_token, self.to_patch_embedding(vol))
        x = self.dropout(x + self._pos().to(x.dtype))
        return _pool(self.mlp_head[0](self.transformer(x)), self.pool)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        return self.mlp_head[1](self.features(vol))


class SimpleViT(nn.Module):
    """SimpleViT: sincos position table, mean pool, no CLS, no dropout."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, dim_head: int = 64, *,
                 channels: int = 3):
        super().__init__()
        (h, w), (p1, p2) = _pair(image_size), _pair(patch_size)
        self.to_patch_embedding = _patch_embedding(
            p1 * p2 * channels, dim, Patches((p1, p2)))
        self.register_buffer("pos", _posemb_sincos_2d(h // p1, w // p2, dim),
                             persistent=False)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim)
        self.linear_head = nn.Linear(dim, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.to_patch_embedding(img) + self.pos.to(img.dtype)
        return self.transformer(x).mean(dim=1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.linear_head(self.features(img))


class MAE(nn.Module):
    """Masked autoencoder over a patch grid: mask ``masking_ratio`` of
    the patches at random, encode the visible ones, decode the full grid
    with mask tokens, and return the mean squared error of the predicted
    masked patches.  ``forward(img, generator)`` draws the masking from
    ``generator`` (:meth:`permutation`)."""

    def __init__(self, image_size, patch_size, dim: int, depth: int,
                 heads: int, mlp_dim: int, masking_ratio: float = 0.75,
                 decoder_dim: int = 128, decoder_depth: int = 1,
                 decoder_heads: int = 4, dim_head: int = 64, *,
                 channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        n = (h // self.patch[0]) * (w // self.patch[1])
        patch_dim = self.patch[0] * self.patch[1] * channels
        self.num_masked = int(masking_ratio * n)
        self.patch_norm = nn.LayerNorm(patch_dim, eps=LN_EPS)
        self.patch_embed = nn.Linear(patch_dim, dim)
        self.pos_embedding = nn.Parameter(torch.empty(1, n, dim))
        self.encoder = Transformer(dim, depth, heads, dim_head, mlp_dim)
        self.enc_to_dec = nn.Linear(dim, decoder_dim)
        self.mask_token = nn.Parameter(torch.empty(decoder_dim))
        self.decoder_pos = nn.Parameter(torch.empty(1, n, decoder_dim))
        self.decoder = Transformer(decoder_dim, decoder_depth, decoder_heads,
                                   dim_head, decoder_dim * 4)
        self.to_pixels = nn.Linear(decoder_dim, patch_dim)

    def reset_extra(self, generator: torch.Generator) -> None:
        for p in (self.pos_embedding, self.mask_token, self.decoder_pos):
            p.copy_(0.02 * torch.randn(p.shape, generator=generator))

    @staticmethod
    def permutation(b: int, n: int, generator: torch.Generator,
                    device) -> torch.Tensor:
        """One uniform random permutation of ``n`` per sample, ``(b, n)``."""
        draw = torch.rand(b, n, generator=generator, device=device)
        return draw.argsort(dim=1)

    def forward(self, img: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        patches = patchify(img, self.patch)
        b, n, _ = patches.shape
        tokens = self.patch_embed(self.patch_norm(patches)) \
            + self.pos_embedding.to(img.dtype)
        perm = self.permutation(b, n, generator, img.device)
        masked_idx, visible_idx = perm[:, :self.num_masked], \
            perm[:, self.num_masked:]
        rows = torch.arange(b, device=img.device)[:, None]
        encoded = self.encoder(tokens[rows, visible_idx])
        dec = self.enc_to_dec(encoded)
        # the grid in permutation order (mask tokens, then the visible
        # tokens), put back in patch order by the inverse permutation
        mask = self.mask_token.to(dec.dtype).expand(b, self.num_masked, -1)
        in_perm = torch.cat([mask, dec], dim=1)
        full = torch.gather(in_perm, 1, perm.argsort(dim=1)[..., None]
                            .expand(-1, -1, dec.shape[-1]))
        decoded = self.decoder(full + self.decoder_pos.to(dec.dtype))
        pred = self.to_pixels(decoded[rows, masked_idx])
        return ((pred - patches[rows, masked_idx]) ** 2).mean()


class DinoHead(nn.Module):
    """Dense -> GELU -> Dense projection head (DINO)."""

    def __init__(self, projection_hidden: int = 256,
                 projection_out: int = 256, *, dim: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, projection_hidden),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(projection_hidden,
                                           projection_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


def dino_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
              student_temp: float = 0.1, teacher_temp: float = 0.04,
              center: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-entropy between the centred, sharpened teacher distribution
    and the student's (dino.py semantics)."""
    if center is None:
        center = torch.zeros(teacher_logits.shape[-1],
                             dtype=teacher_logits.dtype,
                             device=teacher_logits.device)
    t = torch.softmax((teacher_logits - center) / teacher_temp, dim=-1)
    s = F.log_softmax(student_logits / student_temp, dim=-1)
    return -(t * s).sum(dim=-1).mean()


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module,
               momentum: float = 0.996) -> nn.Module:
    """teacher <- momentum * teacher + (1 - momentum) * student, over the
    two modules' parameters in order, in place; returns ``teacher``."""
    t_params, s_params = list(teacher.parameters()), \
        list(student.parameters())
    if len(t_params) != len(s_params):
        raise ValueError("teacher and student differ in their parameters")
    for t, s in zip(t_params, s_params):
        t.copy_(momentum * t + (1.0 - momentum) * s)
    return teacher


@torch.no_grad()
def init_zoo(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill a zoo model from ``generator`` under the trainers' torch law
    (``utils/initializers.py``: uniform kernels and biases, unit norms,
    N(0, 1) tokens and other free parameters), then each module's own
    parameters outside that law (``reset_extra``: MAE's 0.02 tables,
    CaiT's LayerScale, QK-norm's gammas, ...); returns ``model``."""
    init_weights(model, generator, "torch")
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name not in ("weight", "bias"):
                p.copy_(torch.randn(p.shape, generator=generator))
        if hasattr(mod, "reset_extra"):
            mod.reset_extra(generator)
    return model
