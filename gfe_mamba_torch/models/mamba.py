"""Mamba selective state-space model (counterpart of
``gfe_mamba_tpu/models/mamba.py``).  The sequence forward's scan runs
through ``ops.scan.selective_scan`` (K2 on the card); ``Mamba.step`` is
the one-token recurrence with a ``(h, conv window)`` cache per layer, in
JAX's layout: h ``(B, ED, N)``, the window ``(B, d_conv - 1, ED)``.
The projections, the conv and the norms compute in the promoted dtype
of their input and their parameters (``models/promote.py``), as flax's
do."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.promote import Conv1d, Linear, promote
from gfe_mamba_torch.ops.scan import selective_scan, selective_scan_step


@dataclass(frozen=True)
class MambaConfig:
    d_model: int                     # D
    n_layers: int
    dt_rank: int | str = "auto"
    d_state: int = 16                # N
    expand_factor: int = 2           # E
    d_conv: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1
    dt_init: str = "random"          # "random" | "constant"
    dt_scale: float = 1.0
    dt_init_floor: float = 1e-4
    rms_norm_eps: float = 1e-5
    bias: bool = False
    conv_bias: bool = True
    inner_layernorms: bool = False   # RMSNorm on dt, B and C (Jamba)

    @property
    def d_inner(self) -> int:        # ED
        return self.expand_factor * self.d_model

    @property
    def dt_rank_(self) -> int:
        if self.dt_rank == "auto":
            return math.ceil(self.d_model / 16)
        return int(self.dt_rank)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rms = torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return x * rms * self.weight


class MambaBlock(nn.Module):
    """in_proj -> causal depthwise conv -> silu -> selective scan (dt bias
    and softplus inside the scan) -> silu(z) gate -> out_proj."""

    def __init__(self, config: MambaConfig):
        super().__init__()
        self.config = cfg = config
        ed = cfg.d_inner
        self.in_proj = Linear(cfg.d_model, 2 * ed, bias=cfg.bias)
        # left-pad d_conv-1: both-sided padding, then the first L outputs
        self.conv1d = Conv1d(ed, ed, cfg.d_conv, groups=ed,
                             padding=cfg.d_conv - 1, bias=cfg.conv_bias)
        self.x_proj = Linear(ed, cfg.dt_rank_ + 2 * cfg.d_state,
                             bias=False)
        # the bias is the scan's delta_bias, not applied by the Linear
        self.dt_proj = Linear(cfg.dt_rank_, ed, bias=True)
        self.A_log = nn.Parameter(torch.empty(ed, cfg.d_state))
        self.D = nn.Parameter(torch.empty(ed))
        self.out_proj = Linear(ed, cfg.d_model, bias=cfg.bias)
        if cfg.inner_layernorms:
            self.dt_layernorm = RMSNorm(cfg.dt_rank_, cfg.rms_norm_eps)
            self.B_layernorm = RMSNorm(cfg.d_state, cfg.rms_norm_eps)
            self.C_layernorm = RMSNorm(cfg.d_state, cfg.rms_norm_eps)

    @torch.no_grad()
    def reset_ssm_parameters(self, generator: torch.Generator) -> None:
        """The Mamba init laws: dt_proj weight U(-s, s) with
        s = dt_rank^-0.5 * dt_scale (or constant s); dt bias = softplus^-1
        of dt ~ LogUniform[dt_min, dt_max] floored at dt_init_floor;
        S4D-real A_log = log(1..N); D = 1."""
        cfg = self.config
        std = cfg.dt_rank_ ** -0.5 * cfg.dt_scale
        w = self.dt_proj.weight
        if cfg.dt_init == "constant":
            w.fill_(std)
        elif cfg.dt_init == "random":
            w.copy_(torch.rand(w.shape, generator=generator) * 2 * std - std)
        else:
            raise NotImplementedError(cfg.dt_init)
        u = torch.rand(cfg.d_inner, generator=generator)
        dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                       + math.log(cfg.dt_min)).clamp(min=cfg.dt_init_floor)
        self.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        a = torch.arange(1, cfg.d_state + 1, dtype=torch.float32)
        self.A_log.copy_(torch.log(a).repeat(cfg.d_inner, 1))
        self.D.fill_(1.0)

    def _delta_bc(self, x: torch.Tensor):
        """x_proj's output split into (dt before its projection, B, C),
        each through its RMSNorm when ``inner_layernorms``."""
        cfg = self.config
        delta, B, C = torch.split(
            self.x_proj(x), [cfg.dt_rank_, cfg.d_state, cfg.d_state], dim=-1)
        if cfg.inner_layernorms:
            delta = self.dt_layernorm(delta)
            B, C = self.B_layernorm(B), self.C_layernorm(C)
        return delta, B, C

    def scan_operands(self, x: torch.Tensor) -> list:
        """The scan's operands ``[x, delta, A, B, C, D, z, delta_bias]``
        for the layer input ``x`` (B, L, d_model), as the forward hands
        them over: x channel-major from the depthwise conv, z a ``chunk``
        view of in_proj's output, B and C ``split`` views of x_proj's (or
        their RMSNorms' outputs), A in f32, x, delta, B, C and z in the
        promoted dtype of the input and the weights (f32 for an f32 input
        under the bf16 cast), D and delta_bias in their own."""
        return self._operands(x)[0]

    def _operands(self, x: torch.Tensor):
        """:meth:`scan_operands` and the conv's input (in_proj's first
        half, ``(B, L, ED)``)."""
        L = x.shape[1]
        xi, z = self.in_proj(x).chunk(2, dim=-1)
        x = self.conv1d(xi.transpose(1, 2))[..., :L].transpose(1, 2)
        x = F.silu(x)
        A = -torch.exp(self.A_log.float())
        delta, B, C = self._delta_bc(x)
        return [x, self._dt_matmul(delta), A, B, C, self.D, z,
                self.dt_proj.bias], xi

    def _dt_matmul(self, delta: torch.Tensor) -> torch.Tensor:
        """dt_proj without its bias, which the scan adds in f32; a
        tensor-parallel dt_proj (``parallel/sharding.py``) is asked to
        leave it out too."""
        if isinstance(self.dt_proj, nn.Linear):
            return F.linear(*promote(delta, self.dt_proj.weight))
        return self.dt_proj(delta, add_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = selective_scan(*self.scan_operands(x), delta_softplus=True)
        return self.out_proj(y)

    def prefill(self, x: torch.Tensor):
        """The sequence forward of ``x (B, L, d_model)`` that also returns
        the cache :meth:`step` continues from: ``(out, (h, window))``, h
        the scan's last state ``(B, ED, N)`` in f32 and the window the
        last ``d_conv - 1`` inputs of the conv ``(B, d_conv - 1, ED)`` in
        the layer's dtype (zeros before the first token)."""
        operands, xi = self._operands(x)
        y, h = selective_scan(*operands, delta_softplus=True,
                              return_state=True)
        k = self.config.d_conv - 1
        window = F.pad(xi[:, -k:], (0, 0, max(0, k - xi.shape[1]), 0))
        return self.out_proj(y), (h, window.contiguous())

    def step(self, x: torch.Tensor, cache):
        """One token ``x (B, d_model)`` with ``cache = (h, conv window)``
        -> ``(out (B, d_model), new cache)``.  The conv is the valid conv
        of the window and this token.  Dtypes promote as in JAX's step:
        an f32 cache (``init_cache``'s) makes the state, the window and the
        output f32 whatever the layer's dtype.  A window in the layer's
        dtype (:meth:`prefill`'s) keeps the output in it: the gated y is
        rounded once to that dtype, as K2 writes the sequence forward's,
        while the state stays f32."""
        h, conv_in = cache
        x, z = self.in_proj(x).chunk(2, dim=-1)
        out_dtype = torch.promote_types(x.dtype, conv_in.dtype)
        window = torch.cat([conv_in, x[:, None]], dim=1)
        x = torch.einsum("bke,ek->be",
                         *promote(window, self.conv1d.weight[:, 0]))
        if self.conv1d.bias is not None:
            x = x + self.conv1d.bias
        x = F.silu(x)
        A = -torch.exp(self.A_log.float())
        delta, B, C = self._delta_bc(x)
        delta = F.softplus(self.dt_proj(delta))
        y, h = selective_scan_step(h, x, delta, A, B, C, self.D)
        y = (y * F.silu(z)).to(out_dtype)
        return self.out_proj(y), (h, window[:, 1:])


class ResidualBlock(nn.Module):
    """mixer(norm(x)) + x."""

    def __init__(self, config: MambaConfig):
        super().__init__()
        self.mixer = MambaBlock(config)
        self.norm = RMSNorm(config.d_model, config.rms_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mixer(self.norm(x)) + x

    def step(self, x: torch.Tensor, cache):
        out, cache = self.mixer.step(self.norm(x), cache)
        return out + x, cache


class Mamba(nn.Module):
    """Stack of residual Mamba blocks."""

    def __init__(self, config: MambaConfig):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(ResidualBlock(config)
                                    for _ in range(config.n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

    def step(self, x: torch.Tensor, caches: list):
        """One token ``x (B, d_model)`` through every layer; ``caches`` is
        :meth:`init_cache`'s list, one ``(h, conv window)`` per layer."""
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.step(x, cache)
            new_caches.append(cache)
        return x, new_caches

    def init_cache(self, batch: int, dtype=torch.float32,
                   device=None) -> list:
        """Zero caches on ``device`` (the model's when omitted)."""
        cfg = self.config
        device = device or self.layers[0].mixer.D.device
        return [(torch.zeros(batch, cfg.d_inner, cfg.d_state, dtype=dtype,
                             device=device),
                 torch.zeros(batch, cfg.d_conv - 1, cfg.d_inner,
                             dtype=dtype, device=device))
                for _ in range(cfg.n_layers)]
