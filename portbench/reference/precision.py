"""The precision of the reference's convolutions and matrix products.

``f32`` is the reference proper: float32 with TF32 off.  The control
computes the same model one precision below the configuration's, in
the forward and the backward pass alike, with float32 accumulation as
a tensor core has it:

* ``tf32`` (below float32): TF32 on for cuBLAS and cuDNN, and every
  operand rounded to TF32's 10 stored mantissa bits (to nearest, ties
  to even), so that the CPU computes it too;
* ``fp8`` (below bfloat16): every forward operand scaled per tensor so
  that its largest magnitude maps to e4m3's largest finite value (448),
  rounded to ``float8_e4m3fn`` and scaled back; every gradient entering
  a product's backward likewise in e5m2 (57344), the usual split of fp8
  training.

``q(t)`` rounds an operand (its gradient passes through); ``q.out(y)``
leaves a product's output as it is and rounds the gradient that comes
back into it, so that the backward products see rounded operands."""

from __future__ import annotations

import torch

FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2,
                                                       57344.0)}


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(t: torch.Tensor, kind: str = "e4m3") -> torch.Tensor:
    dtype, top = FP8[kind]
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


def _round(name: str, t: torch.Tensor, backward: bool) -> torch.Tensor:
    if name == "tf32":
        return round_tf32(t)
    return round_fp8(t, "e5m2" if backward else "e4m3")


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, name):
        return _round(name, t, False)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Output(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, name):
        ctx.name = name
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(ctx.name, g, True), None


class Rounding:
    """``name`` is 'f32', 'tf32' or 'fp8' (module docstring)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return t if self.name == "f32" else _Operand.apply(t, self.name)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        if self.name == "f32" or not y.requires_grad:
            return y
        return _Output.apply(y, self.name)


def reference_mode(precision: str = "f32") -> None:
    """TF32 on for cuBLAS and cuDNN only in the TF32 control."""
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
