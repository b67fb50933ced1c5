"""Weights and inputs drawn from the run's seed, on the device, in a few
large calls.

Every stream has a seed of its own, derived from ``--seed`` and a tag
('weights', 'inputs', 'dropout', 'sample'), so that the program and the
reference can each draw the same tensors again.

The weight law (the benchmark's own, applied to the published
state_dict's names and shapes): matrices and kernels N(0, 1/fan_in)
with fan_in the product of all axes but the first (a transposed conv's
``(I, O, *k)``: I times the window); norm scales 1 + N(0, 0.01), biases
N(0, 0.01); tokens and embeddings N(0, 1); Mamba's A_log = log(1..N),
D = 1 + N(0, 0.01) and dt_proj's bias the softplus inverse of a
log-uniform step in [0.001, 0.1] (Mamba's own laws)."""

from __future__ import annotations

import hashlib
import math

import torch

TOKENS = ("cls_token", "pos_embedding", "categorical_embeds.weight",
          "numerical_embedder.weights", "numerical_embedder.biases")


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def _leaf(name: str, t: torch.Tensor) -> torch.Tensor:
    """One leaf from its slice ``t`` of a standard normal draw."""
    shape = t.shape
    if name.endswith("A_log"):
        n = torch.arange(1, shape[1] + 1, device=t.device,
                         dtype=torch.float32)
        return torch.log(n).expand(shape).to(t.dtype)
    if name.endswith("dt_proj.bias"):
        u = 0.5 * (1.0 + torch.erf(t.float() / math.sqrt(2.0)))
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001)).clamp(min=1e-4)
        return (dt + torch.log(-torch.expm1(-dt))).to(t.dtype)
    if name.endswith(TOKENS):
        return t.clone()
    if len(shape) == 1:
        shift = 1.0 if name.endswith((".weight", ".D")) else 0.0
        return t * 0.1 + shift
    if "conv_transposed" in name:
        fan_in = shape[0] * math.prod(shape[2:])
    else:
        fan_in = math.prod(shape[1:])
    return t * (1.0 / math.sqrt(fan_in))


def leaves(shapes, seed: int, device, dtype, tag: str = "weights"):
    """``(name, tensor)`` for each of ``shapes`` (``[(name, shape), ...]``
    in the module's order), cut from one standard normal draw of
    ``dtype`` from the stream ``tag``."""
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=generator(seed, tag, device),
                       device=device, dtype=dtype)
    at = 0
    for name, shape in shapes:
        n = math.prod(shape)
        yield name, _leaf(name, flat[at:at + n].view(shape))
        at += n


def draw(shapes, seed: int, device, dtype, tag: str = "weights") -> dict:
    return dict(leaves(shapes, seed, device, dtype, tag))


def parameter_shapes(module) -> list:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@torch.no_grad()
def draw_into(module, seed: int, dtype, tag: str = "weights") -> list:
    """Fill every parameter of ``module`` (on its device) from the seed's
    stream ``tag``, one leaf at a time; returns the shapes the reference
    draws again."""
    params = dict(module.named_parameters())
    shapes = parameter_shapes(module)
    device = next(iter(params.values())).device
    for name, value in leaves(shapes, seed, device, dtype, tag):
        params[name].copy_(value)
    return shapes
