"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test needs an NVIDIA GPU (``cuda`` marker) and skips without
one.  The file imports torch and the port only, so it also runs where JAX
is not installed::

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances, relative to max(1, max |plain|): K1 f32 1e-4 (summation
order; TF32 is off for the reference), K1 bf16 3e-2 at every brick its
plan can choose (the plain version rounds the conv output to bf16
before its epilogue: up to 1 bf16 ulp, 0.8%, at the output's scale), K2
1e-5 (f32 state on both sides) and one bf16 ulp for its bf16 output
against the plain f32 result rounded, K5a 1e-5 (f32 sums in two
orders), K5b 1e-6 in f32 and one bf16 ulp (2^-7)
in bf16 (the same f32 arithmetic, op by op, rounded once), the group-norm
Function's gradients 1e-4 (autograd of the same reference on both
sides).
"""

import numpy as np
import pytest
import torch

from gfe_mamba_torch.ops.cuda import conv3d as k1
from gfe_mamba_torch.ops.cuda import group_norm as k5
from gfe_mamba_torch.ops.cuda import selective_scan as k2
from gfe_mamba_torch.testing import bf16_ulps, mamba_scan_operands

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, rel):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= rel * max(1.0, want.abs().max().item()), err


def _randn(gen, *shape, scale=1.0):
    return torch.from_numpy((gen.randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("act,with_res,post_act", [
    ("relu", False, "none"), ("none", True, "relu"), ("elu", False, "none")])
@pytest.mark.parametrize("shape,C,F", [((2, 5, 7, 19), 24, 40),
                                       ((1, 9, 13, 24), 24, 40),
                                       ((3, 11, 6, 24), 128, 64),
                                       ((1, 8, 12, 16), 32, 64),
                                       ((1, 6, 8, 8), 192, 64),
                                       ((1, 4, 8, 8), 384, 128),
                                       ((1, 4, 4, 8), 768, 256),
                                       ((1, 9, 12, 13), 64, 32),
                                       ((2, 6, 9, 11), 32, 64)])
def test_conv_kernel_matches_plain(cuda, dtype, rel, act, with_res,
                                   post_act, shape, C, F):
    """Ragged shapes: X and Y not multiples of the brick, Z = 24 (the
    256-channel level's depth) and 19, C and F multiples of 8 but not of
    16, and more input channels than one 64-wide output tile; the
    segmentation UNet3D's widths: its first K1 conv (32 -> 64) and its
    decoders' concat-joined inputs (192, 384, 768 channels); and that
    conv's input gradient (64 -> 32, the f32 variant's narrow tile), with
    Z = 13 and 11, not multiples of the f32 bricks' 8."""
    gen = np.random.RandomState(0)
    x = _randn(gen, *shape, C).to(cuda, dtype)
    w = _randn(gen, 3, 3, 3, C, F, scale=(27 * C) ** -0.5).to(cuda, dtype)
    bias = _randn(gen, F).to(cuda, dtype)
    a = (_randn(gen, shape[0], C).abs() + 0.5).to(cuda)
    s = _randn(gen, shape[0], C).to(cuda)
    res = _randn(gen, *shape, F).to(cuda, dtype) if with_res else None
    args = (x, w, bias, a, s, res, act, post_act)
    got = k1.conv3x3x3_cuda(*args)
    want = k1.conv3x3x3_plain(*args)
    torch.cuda.synchronize()
    _assert_close(got, want, rel)


# the generator's three levels at batch 1 (Stage 1's dz) and 4 (scoring),
# and ragged shapes: X, Y, Z not multiples of any brick, C and F
# multiples of 8 but not of 16, F below one 64-channel tile
BF16_SHAPES = [((b, *sp), C, C) for b in (1, 4)
               for sp, C in (((160, 160, 96), 64), ((80, 80, 48), 128),
                             ((40, 40, 24), 256))] \
    + [((2, 5, 7, 19), 24, 40), ((1, 9, 13, 24), 24, 40),
       ((3, 11, 6, 24), 128, 64), ((1, 9, 12, 13), 64, 32)]


@pytest.mark.parametrize("mode", ["affine_relu", "residual_post",
                                  "bias_elu", "dz"])
@pytest.mark.parametrize("shape,C,F", BF16_SHAPES)
@pytest.mark.parametrize("brick", k1.CONV_BRICKS)
def test_conv_kernel_bf16_matches_plain_at_each_brick(
        cuda, monkeypatch, brick, shape, C, F, mode):
    """K1's wgmma variant over every brick the kernel compiles (whichever
    ``conv_plan`` takes for the shape): the folded GroupNorm with relu;
    with a residual and post_act relu; a bias and elu without the
    affine; and as the input gradient (flipped, transposed weights, no
    affine, no epilogue)."""
    monkeypatch.setattr(k1, "conv_plan",
                        lambda *a: k1.mma_plan(brick, *a))
    gen = np.random.RandomState(4)
    x = _randn(gen, *shape, C).to(cuda, torch.bfloat16)
    w = _randn(gen, 3, 3, 3, C, F, scale=(27 * C) ** -0.5) \
        .to(cuda, torch.bfloat16)
    bias = a = s = res = None
    act = post_act = "none"
    if mode == "dz":
        w = w.flip(0, 1, 2).transpose(3, 4).contiguous()
        x = _randn(gen, *shape, F).to(cuda, torch.bfloat16)
    if mode in ("affine_relu", "residual_post"):
        a = (_randn(gen, shape[0], C).abs() + 0.5).to(cuda)
        s = _randn(gen, shape[0], C).to(cuda)
    if mode == "affine_relu":
        act = "relu"
    if mode == "residual_post":
        res = _randn(gen, *shape, F).to(cuda, torch.bfloat16)
        post_act = "relu"
    if mode == "bias_elu":
        bias = _randn(gen, F).to(cuda, torch.bfloat16)
        act = "elu"
    args = (x, w, bias, a, s, res, act, post_act)
    got = k1.conv3x3x3_cuda(*args)
    want = k1.conv3x3x3_plain(*args)
    torch.cuda.synchronize()
    _assert_close(got, want, 3e-2)


def test_k1_counts_launches_by_variant(cuda):
    """A scoring forward (the pipeline in bf16, as the benchmark serves
    it) runs its 10 K1 convs on the wgmma variant; a UNet3D forward in
    f32 its 13 on the CUDA-core one."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.models.unet3d import get_model

    model = build_gfe_mamba(
        categories=(3, 5, 2), num_continuous=4, img_size=(16, 16, 8),
        dim=64, depth=2, heads=2, seq_length=2, f_maps=(8, 16, 32),
        fold_factor=2, vit_patch_size=4, vit_dim=16, vit_depth=1,
        vit_heads=2, vit_mlp_dim=32, device=cuda).to(torch.bfloat16)
    k1.launches = k1.mma_launches = k1.fma_launches = 0
    with torch.inference_mode():
        model(torch.randn(2, 16, 16, 8, 1, device=cuda,
                          dtype=torch.bfloat16),
              torch.zeros(2, 3, dtype=torch.long, device=cuda),
              torch.randn(2, 4, device=cuda, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert (k1.launches, k1.mma_launches, k1.fma_launches) == (10, 10, 0)

    unet = get_model(dict(name="UNet3D", in_channels=1, out_channels=1,
                          f_maps=64, layer_order="gcr", num_groups=8,
                          is_segmentation=False)).to(cuda)
    k1.launches = k1.mma_launches = k1.fma_launches = 0
    with torch.no_grad():
        unet(torch.randn(1, 16, 32, 32, 1, device=cuda))
    torch.cuda.synchronize()
    assert (k1.launches, k1.mma_launches, k1.fma_launches) == (13, 0, 13)


def test_full_width_unet3d_forward_launches_k1_13_times(cuda):
    """``get_model``'s UNet3D at JAX's defaults (f_maps 64, 4 levels):
    14 3x3x3 convs, the C_in = 1 stem on cuDNN, 13 on K1; f32, card
    against the CPU within 1e-4 relative."""
    from gfe_mamba_torch.models.unet3d import get_model

    model = get_model(dict(name="UNet3D", in_channels=1, out_channels=1,
                           f_maps=64, layer_order="gcr", num_groups=8,
                           is_segmentation=False))
    x = _randn(np.random.RandomState(3), 1, 16, 32, 32, 1)
    with torch.no_grad():
        want = model(x)
        card = model.to(cuda)
        before = k1.launches
        got = card(x.to(cuda))
        torch.cuda.synchronize()
    assert k1.launches - before == 13
    _assert_close(got, want, 1e-4)


def test_conv_kernel_rejects_channels_not_multiple_of_8(cuda):
    x = torch.zeros(1, 4, 4, 4, 4, device=cuda)
    w = torch.zeros(3, 3, 3, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        k1.conv3x3x3_cuda(x, w)


@pytest.mark.parametrize("bsz", [1, 4])
@pytest.mark.parametrize("gate,bias,softplus,ED", [
    (True, True, True, 1024), (False, False, True, 1000),
    (True, False, False, 1001)])
def test_scan_kernel_matches_plain(cuda, gate, bias, softplus, ED, bsz):
    """Batch 4 (serving) and 1 (the Stage-2 step); ED = 1001 leaves one
    channel in the last block of 4."""
    gen = np.random.RandomState(1)
    L, N = 53, 16
    x = _randn(gen, bsz, L, ED)
    delta = _randn(gen, bsz, L, ED, scale=0.5)
    if not softplus:          # a real step is positive without softplus
        delta = delta.abs()
    A = -_randn(gen, ED, N).abs()
    B, C = _randn(gen, bsz, L, N), _randn(gen, bsz, L, N)
    D = _randn(gen, ED)
    z = _randn(gen, bsz, L, ED) if gate else None
    b = _randn(gen, ED, scale=0.1) if bias else None
    args = [None if t is None else t.to(cuda)
            for t in (x, delta, A, B, C, D, z, b)]
    got = k2.selective_scan_cuda(*args, delta_softplus=softplus)
    want = k2.selective_scan_plain(*args, delta_softplus=softplus)
    torch.cuda.synchronize()
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("bsz", [1, 4])
def test_scan_kernel_takes_bf16_views(cuda, bsz):
    """A Mamba layer's own bf16 operands, as its forward makes them on the
    card (x channel-major from the depthwise conv, z a ``chunk`` view, B
    and C ``split`` views, D and delta_bias bf16), go in as they are: y
    comes back in bf16 within one bf16 ulp of the plain f32 result rounded
    once (an element below 2^-8 of max |y| takes the ulp of that floor);
    the same call in f32 agrees to 1e-5."""
    for dtype in (torch.bfloat16, torch.float32):
        args = mamba_scan_operands(bsz, 53, 128, dtype, cuda, seed=bsz)
        assert not (args[0].is_contiguous() or args[6].is_contiguous()
                    or args[3].is_contiguous())
        got = k2.selective_scan_cuda(*args, delta_softplus=True)
        want = k2.selective_scan_plain(*[t.float() for t in args],
                                       delta_softplus=True)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        if dtype == torch.float32:
            _assert_close(got, want, 1e-5)
        else:
            assert bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("bwd", [True])
def test_scan_kernels_refuse_a_sequence_beyond_shared_memory(cuda, bwd):
    """K4 at L = 2000 needs ~0.9 MB of shared memory per block (227 KB at
    most): the launch's error comes back as an exception, and leaves
    nothing behind for the next launch, which succeeds.  (K2 walks any L
    in chunks: ``test_chunked_scan_kernel_matches_plain``.)"""
    def call(L):
        args = [torch.zeros(1, L, 8, device=cuda),
                torch.zeros(1, L, 8, device=cuda),
                -torch.ones(8, 16, device=cuda),
                torch.zeros(1, L, 16, device=cuda),
                torch.zeros(1, L, 16, device=cuda),
                torch.zeros(8, device=cuda), None, None]
        if bwd:
            return k2.selective_scan_bwd_cuda(*args,
                                              torch.zeros_like(args[0]))
        return k2.selective_scan_cuda(*args)

    with pytest.raises(RuntimeError, match="CUDA error"):
        call(2000)
    call(53)
    torch.cuda.synchronize()


@pytest.mark.parametrize("L", [53, 518, 519, 4096, 15024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_scan_kernel_matches_plain(cuda, L, dtype):
    """K2 over L steps in chunks (one chunk of the short kernel up to
    ``SCAN_WHOLE``, past it v4's chunks of ``long_chunk(N)``; 518 was v2's
    last length at N = 16): a Mamba layer's own operands in f32
    or bf16 (views, channel-major x), y within 1e-5 (f32) or one bf16 ulp
    of the plain loop, and the last state, from the same call, within
    1e-5 of the plain loop's (f32 on both sides)."""
    args = mamba_scan_operands(1, L, 32, dtype, cuda, seed=L)
    before = k2.chunks
    got, h = k2.selective_scan_cuda(*args, delta_softplus=True,
                                    return_state=True)
    want, want_h = k2.selective_scan_plain(*[t.float() for t in args],
                                           delta_softplus=True,
                                           return_state=True)
    torch.cuda.synchronize()
    chunk = L if L <= k2.SCAN_WHOLE else k2.long_chunk(16)
    assert k2.chunks - before == -(-L // chunk)
    assert got.dtype == dtype and h.dtype == torch.float32
    assert h.shape == (1, 64, 16)
    if dtype == torch.float32:
        _assert_close(got, want, 1e-5)
    else:
        assert bf16_ulps(got, want) <= 1.0
    _assert_close(h, want_h, 1e-5)


def _scan_case(gen, bsz, L, ED, N, gate, bias, softplus, cuda):
    x = _randn(gen, bsz, L, ED)
    delta = _randn(gen, bsz, L, ED, scale=0.5)
    if not softplus:          # a real step is positive without softplus
        delta = delta.abs()
    A = -_randn(gen, ED, N).abs()
    B, C = _randn(gen, bsz, L, N), _randn(gen, bsz, L, N)
    D = _randn(gen, ED)
    z = _randn(gen, bsz, L, ED) if gate else None
    b = _randn(gen, ED, scale=0.1) if bias else None
    return [None if t is None else t.to(cuda)
            for t in (x, delta, A, B, C, D, z, b)]


@pytest.mark.parametrize("N", [4, 8, 16, 32])
@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("gate,bias,softplus", [
    (True, True, True), (False, False, True), (True, False, False)])
@pytest.mark.parametrize("ED", [1000, 5000])
def test_long_scan_kernel_matches_plain(cuda, N, bsz, gate, bias,
                                        softplus, ED):
    """v4 (L = 519 > SCAN_WHOLE) on contiguous f32 operands at every state
    size, batch 1 and 2, with z and the bias present and absent, softplus
    on and off, ED not a multiple of the slab (1000 and 5000 in slabs of
    64, or of 32 at N = 32): y and the last state within 1e-5 of the
    plain loop."""
    gen = np.random.RandomState(N + bsz)
    args = _scan_case(gen, bsz, 519, ED, N, gate, bias, softplus, cuda)
    before = k2.long_launches
    got, h = k2.selective_scan_cuda(*args, delta_softplus=softplus,
                                    return_state=True)
    want, want_h = k2.selective_scan_plain(*args, delta_softplus=softplus,
                                           return_state=True)
    torch.cuda.synchronize()
    assert k2.long_launches - before == 1
    _assert_close(got, want, 1e-5)
    _assert_close(h, want_h, 1e-5)


@pytest.mark.parametrize("L,d_model", [
    (65, 500), (519, 500), (4467, 500), (15024, 500), (519, 2500),
    (15024, 2500)])
@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_scan_kernel_takes_mamba_views(cuda, L, d_model, bsz, dtype):
    """v4 on a Mamba layer's own operands (channel-major x, z a ``chunk``
    view, B and C ``split`` views; ED 1000 and 5000, neither a multiple
    of the slab of 64), batch 1 and 2: y within
    1e-5 (f32) or one bf16 ulp (bf16) of the plain f32 loop, the last
    state within 1e-5."""
    args = mamba_scan_operands(bsz, L, d_model, dtype, cuda, seed=L + bsz)
    assert not (args[0].is_contiguous() or args[6].is_contiguous())
    got, h = k2.selective_scan_cuda(*args, delta_softplus=True,
                                    return_state=True)
    want, want_h = k2.selective_scan_plain(*[t.float() for t in args],
                                           delta_softplus=True,
                                           return_state=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and h.shape == (bsz, 2 * d_model, 16)
    if dtype == torch.float32:
        _assert_close(got, want, 1e-5)
    else:
        assert bf16_ulps(got, want) <= 1.0
    _assert_close(h, want_h, 1e-5)


def test_long_scan_kernel_takes_stage2_views(cuda):
    """The bf16 Stage-2 step's mix of operands (f32 x, delta, z, B, C
    views beside bf16 D and delta_bias) past SCAN_WHOLE steps: within
    1e-5 of the plain loop."""
    args = mamba_scan_operands(1, 300, 128, torch.bfloat16, cuda, seed=3,
                               input_dtype=torch.float32)
    assert args[0].dtype == torch.float32 and args[5].dtype == torch.bfloat16
    got = k2.selective_scan_cuda(*args, delta_softplus=True)
    want = k2.selective_scan_plain(*[t.float() for t in args],
                                   delta_softplus=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    _assert_close(got, want, 1e-5)


def test_long_scan_kernel_copies_operands_past_32_bit_offsets(cuda,
                                                              monkeypatch):
    """An operand whose strides would overflow v4's 32-bit offsets inside
    a chunk goes in as a contiguous copy: here every view is taken for
    one (x channel-major, z and B, C views), and the result still holds
    to the plain loop within one bf16 ulp."""
    args = mamba_scan_operands(1, 300, 64, torch.bfloat16, cuda, seed=5)
    copied = []

    def fits(t, steps, width):
        if t is not None and not t.is_contiguous():
            copied.append(t)
            return False
        return True

    monkeypatch.setattr(k2, "offsets_fit", fits)
    got = k2.selective_scan_cuda(*args, delta_softplus=True)
    want = k2.selective_scan_plain(*[t.float() for t in args],
                                   delta_softplus=True)
    torch.cuda.synchronize()
    assert len(copied) == 4          # x, z, B, C
    assert bf16_ulps(got, want) <= 1.0


def test_occupancy_queries_leave_later_launches_alone(cuda):
    """Asking the occupancy of the short kernel at 53 steps (as
    ``chip_smoke.py`` does) must not lower its shared-memory limit below
    what a launch at 64 steps needs."""
    assert k2.occupancy(53, 16) > 0
    assert k2.occupancy(15024, 16) == 1
    args = mamba_scan_operands(2, 64, 512, torch.float32, cuda, seed=64)
    got = k2.selective_scan_cuda(*args, delta_softplus=True)
    want = k2.selective_scan_plain(*args, delta_softplus=True)
    torch.cuda.synchronize()
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("L,long", [(53, 0), (64, 0), (65, 1)])
def test_long_launches_count_the_long_kernel(cuda, L, long):
    """``long_launches`` counts the launches past SCAN_WHOLE steps only;
    ``launches`` counts every one."""
    args = mamba_scan_operands(1, L, 32, torch.bfloat16, cuda, seed=L)
    before = (k2.launches, k2.long_launches)
    k2.selective_scan_cuda(*args, delta_softplus=True)
    torch.cuda.synchronize()
    assert (k2.launches - before[0], k2.long_launches - before[1]) == \
        (1, long)


def _dense_experts(moe, x, top_i=None):
    """Every token through every expert, summed with the hard top-k gates
    (of the experts ``top_i`` where given)."""
    import torch.nn.functional as F

    w = torch.softmax(moe.router(x).float(), dim=-1)
    if top_i is None:
        top_i = w.topk(moe.k, dim=-1).indices
    top_w = w.gather(-1, top_i)
    gates = torch.zeros_like(w).scatter(-1, top_i, top_w).to(x.dtype)
    g = torch.einsum("bld,edf->belf", x, moe.experts_gate)
    u = torch.einsum("bld,edf->belf", x, moe.experts_up)
    y = torch.einsum("belf,efd->beld", F.silu(g) * u, moe.experts_down)
    return torch.einsum("beld,ble->bld", y, gates)


@pytest.mark.parametrize("tokens", [1, 96])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_routed_experts_match_dense_dispatch_at_published_widths(cuda,
                                                                 dtype, rel,
                                                                 tokens):
    """One Jamba2-Mini MoE layer (16 experts of 4096 -> 14336, top 2) on
    a decode step's token and on 96: the routed dispatch (bf16: the
    grouped products, 14 empty groups at one token; f32: one product per
    expert) against every token through every expert summed with the
    hard gates.  f32 with TF32 off: the same products in other shapes,
    1e-4; bf16: each product rounded once on either side, in other
    groupings, 1e-2 of the output's scale."""
    from gfe_mamba_torch.models.jamba import SparseMoEBlock, grouped_experts

    gen = torch.Generator(device=cuda).manual_seed(0)
    moe = SparseMoEBlock(4096, 16, 2, 14336).to(cuda, dtype).eval()
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=cuda)
                    / p.shape[-2] ** 0.5)
        x = torch.randn(1, tokens, 4096, generator=gen, device=cuda).to(dtype)
        out, _ = moe(x)
        want = _dense_experts(moe, x)
    torch.cuda.synchronize()
    assert grouped_experts(x, moe.experts_gate) == (dtype == torch.bfloat16)
    assert out.dtype == dtype
    err = (out.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


def test_grouped_experts_backward_matches_dense(cuda):
    """The grouped products under autograd (a bf16 training step): the
    gradients of the input and of each stacked weight against the dense
    dispatch's on the same bf16 values in f32, through the experts the
    bf16 router chose (a near tie may round the other way in f32), 3e-2
    of each gradient's scale (bf16 products and cotangents on one
    side)."""
    from gfe_mamba_torch.models.jamba import SparseMoEBlock

    gen = torch.Generator(device=cuda).manual_seed(3)
    moe = SparseMoEBlock(64, 4, 2, 96).to(cuda, torch.bfloat16)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=cuda)
                    / p.shape[-2] ** 0.5)
    ref = SparseMoEBlock(64, 4, 2, 96).to(cuda)
    ref.load_state_dict({k: v.float() for k, v in moe.state_dict().items()})
    x = torch.randn(2, 33, 64, generator=gen, device=cuda)
    cot = torch.randn(2, 33, 64, generator=gen, device=cuda)
    xb, xf = (x.bfloat16().requires_grad_(),
              x.bfloat16().float().requires_grad_())
    with torch.no_grad():
        chosen = moe.router(xb).float().topk(2, dim=-1).indices
    (moe(xb)[0].float() * cot).sum().backward()
    (_dense_experts(ref, xf, chosen) * cot).sum().backward()
    _assert_close(xb.grad, xf.grad, 3e-2)
    for name in ("experts_gate", "experts_up", "experts_down"):
        _assert_close(getattr(moe, name).grad, getattr(ref, name).grad, 3e-2)


def _small_jamba_lm(cuda, dtype):
    from gfe_mamba_torch.models.jamba import JambaConfig, JambaLM

    model = JambaLM(JambaConfig(
        d_model=64, n_layers=8, mlp_size=96, vocab_size=128,
        num_attention_heads=8, num_key_value_heads=2, num_experts=4,
        num_experts_per_tok=2, dt_rank=8, inner_layernorms=True,
        tie_lm_weights=False)).to(cuda).eval()
    gen = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = torch.randn(p.shape, generator=gen, device=cuda)
            if name.endswith("A_log"):
                p.copy_(torch.log(torch.arange(1, 17.0, device=cuda))
                        .expand(p.shape))
            elif name.endswith("dt_proj.bias"):
                p.copy_(-4.6 + 0.1 * t)
            elif p.dim() == 1:
                p.copy_(1.0 + 0.1 * t)
            else:
                p.copy_(t / p.shape[-2 if "experts" in name else -1] ** 0.5)
    return model.to(dtype), gen


@pytest.mark.parametrize("batch", [1, 3])
def test_greedy_graph_decode_matches_the_forward(cuda, batch):
    """``generate(top_k=1)`` on the card.  f32 steps eagerly (one product
    per expert, its ends on the host): its logits equal the full forward's
    on the same tokens with TF32 off (1e-4 of max(1, max |forward|)).
    bf16 replays the model's one CUDA graph (the grouped products; batch 3
    routes 6 pairs to 4 experts): its logits equal those of eager steps
    through the same prefill fed the graph's tokens, 2e-2 of max(1, max
    |eager|) (the frozen cache's masked attention against the filled
    keys'); a prompt that outgrows the graph's caches records it again at
    the next power of two, and a shorter one replays it.  Each token is
    the argmax of its own logits."""
    from gfe_mamba_torch.models.jamba import generate

    for dtype in (torch.float32, torch.bfloat16):
        model, gen = _small_jamba_lm(cuda, dtype)
        graphs = []
        for length in (37, 70, 37):
            prompt = torch.randint(0, 128, (batch, length), generator=gen,
                                   device=cuda)
            out, logits = generate(model, prompt, 9, top_k=1,
                                   return_logits=True)
            graphs.append(model.__dict__.get("_greedy_graph"))
            with torch.no_grad():
                if dtype == torch.float32:
                    want = model(out[:, :-1])[0][:, length - 1:]
                    rel = 1e-4
                else:
                    first, caches = model.prefill(prompt, 9)
                    want = [first]
                    for t in range(length, length + 8):
                        step, caches = model.step(out[:, t], caches)
                        want.append(step)
                    want, rel = torch.stack(want, 1), 2e-2
            torch.cuda.synchronize()
            assert torch.equal(out[:, :length], prompt)
            assert torch.equal(out[:, length:], logits.argmax(-1))
            _assert_close(logits, want, rel)
        if dtype == torch.float32:
            assert graphs == [None] * 3
        else:
            assert graphs[0].capacity == 64 and graphs[1].capacity == 128
            assert graphs[2] is graphs[1]


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("shape,groups", [((2, 9, 13, 21, 64), 8),
                                          ((2, 7, 5, 3, 12), 3),
                                          ((2, 5, 3, 2, 2056), 8)])
def test_group_norm_kernels_match_plain(cuda, dtype, rel, shape, groups):
    """K5a and K5b against their plain versions, every act: 16-byte
    vectors; C = 12, three vectors a row in f32 and the scalar path in
    bf16; C = 2056, more vectors than a block's 256 threads (a ragged
    second channel block).  Then the launches of one ``group_norm_act``
    call and its gradients against autograd through ``_reference``."""
    from gfe_mamba_torch.ops.group_norm import _reference, group_norm_act

    gen = np.random.RandomState(2)
    B, C = shape[0], shape[-1]
    x = _randn(gen, *shape).to(cuda, dtype)
    xv = x.reshape(B, -1, C)
    want = k5.group_norm_sums_plain(xv)
    _assert_close(k5.group_norm_sums_cuda(xv), want, 1e-5)
    mean = _randn(gen, B, C).to(cuda)
    inv = (_randn(gen, B, C).abs() + 0.5).to(cuda)
    scale, bias = _randn(gen, C).to(cuda), _randn(gen, C).to(cuda)
    for act in ("none", "elu", "relu", "leaky_relu"):
        got = k5.group_norm_apply_cuda(xv, mean, inv, scale, bias, act)
        assert got.dtype == dtype
        _assert_close(got, k5.group_norm_apply_plain(xv, mean, inv, scale,
                                                     bias, act), rel)
    ins = [t.float().requires_grad_() for t in (x, scale, bias)]
    k5.stats_launches = k5.apply_launches = 0
    y = group_norm_act(*ins, num_groups=groups, act="elu")
    assert (k5.stats_launches, k5.apply_launches) == (1, 1)
    g = _randn(gen, *shape).to(cuda)
    got = torch.autograd.grad(y, ins, g)
    want = torch.autograd.grad(_reference(*ins, groups, 1e-5, "elu"), ins, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _assert_close(a, b, 1e-4)


def test_main_path_launches_the_kernels(cuda):
    """A small full-order pipeline on the card goes through K1 for every
    3x3x3 conv and K2 for every Mamba layer."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba

    model = build_gfe_mamba(
        categories=(3, 5, 2), num_continuous=4, img_size=(16, 16, 8),
        dim=64, depth=2, heads=2, seq_length=2, f_maps=(8, 16, 32),
        fold_factor=2, vit_patch_size=4, vit_dim=16, vit_depth=1,
        vit_heads=2, vit_mlp_dim=32, device=cuda)
    k1.launches = k2.launches = 0
    with torch.inference_mode():
        logits = model(torch.randn(2, 16, 16, 8, 1, device=cuda),
                       torch.zeros(2, 3, dtype=torch.long, device=cuda),
                       torch.randn(2, 4, device=cuda))
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == (10, 2)
    assert logits.shape == (2, 1) and torch.isfinite(logits).all()
