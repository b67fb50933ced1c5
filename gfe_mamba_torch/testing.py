"""Comparison helpers shared by the port's tests and ``chip_smoke.py``."""

from __future__ import annotations

import torch


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - bf16(want)| in bf16 ulps of bf16(want), ``want`` being
    an f32 result and ``got`` its bf16 counterpart.  An element below
    2^-8 of max |want| takes the ulp of that floor: there the rounding of
    f32 sums taken in different orders (~1e-7 of their terms) is what
    differs, not the one rounding to bf16."""
    want = want.detach().float().to(got.device)
    ref = want.bfloat16().float()
    floor = max(want.abs().max().item() * 2.0 ** -8, 1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=floor))) - 7)
    return ((got.detach().float() - ref).abs() / ulp).max().item()


def mamba_scan_operands(bsz: int, L: int, d_model: int, dtype, device,
                        d_state: int = 16, seed: int = 0) -> list:
    """The scan's operands ``[x, delta, A, B, C, D, z, delta_bias]`` as one
    ``MambaBlock`` in ``dtype`` on ``device`` hands them over
    (``MambaBlock.scan_operands``): x channel-major, z, B and C views, A
    f32.  The block takes Mamba's init and the layer input is normal, all
    from ``seed``; the global RNG is left as it was."""
    from gfe_mamba_torch.models.mamba import MambaBlock, MambaConfig

    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        block = MambaBlock(MambaConfig(d_model=d_model, n_layers=1,
                                       d_state=d_state))
    block.reset_ssm_parameters(gen)
    block = block.to(device, dtype)
    h = torch.randn(bsz, L, d_model, generator=gen).to(device, dtype)
    with torch.no_grad():
        return [t.detach() for t in block.scan_operands(h)]
