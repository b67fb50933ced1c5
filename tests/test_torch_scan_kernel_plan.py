"""The pure-Python side of the scan kernels (K2, K4), on the CPU:

- the operand plan: which tensors reach the kernels as they are (views,
  strided, bf16) and which the caller casts first, and the dtype and
  stride arguments the kernels get;
- K2's plan: the short kernel up to ``SCAN_WHOLE`` steps, past it v4
  with its slab (by width and batch) and chunk, both as the kernel's
  source defines them; v4's index maps; and a plain emulation of its
  chunks, slabs and sums held against the JAX scan;
- a plain emulation of K4's decomposition (``csrc/selective_scan_bwd.cu``):
  blocks of ``SCAN_CH`` channels (read from ``csrc/scan.cuh``), states
  kept per step, the
  reductions over N and over the block's channels taken after the walks,
  per-block dB/dC partials summed over blocks in a fixed order, held
  against ``jax.vjp`` of the JAX scan;
- ``SelectiveScanFn`` with bf16 operands, against the JAX scan with the
  same bf16 inputs.

Tolerances: the emulation 1e-4 of max(1, max |JAX|) per gradient (f32
state on both sides, sums in other orders); bf16 results within one bf16
ulp of the JAX result, an element below 2^-8 of the tensor's max taking
the ulp of that floor (both round once from f32 sums taken in different
orders).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.ops.scan import selective_scan as jax_selective_scan
from gfe_mamba_torch.ops.cuda import selective_scan as k2
from gfe_mamba_torch.ops.scan import selective_scan
from gfe_mamba_torch.testing import bf16_ulps, mamba_scan_operands

torch.set_num_threads(2)

NAMES = ("dx", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")
# channels per block of both kernels, as the kernels' source defines it
SCAN_CH = int(re.search(
    r"constexpr int SCAN_CH = (\d+);",
    (pathlib.Path(k2.__file__).parents[2] / "csrc" / "scan.cuh").read_text()
).group(1))


def _inputs(seed, bsz=2, L=7, ED=6, N=4, gate=True, bias=True,
            softplus=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, L, ED).astype(np.float32)
    delta = (rng.randn(bsz, L, ED) * 0.5).astype(np.float32)
    if not softplus:             # a real step is positive without softplus
        delta = np.abs(delta)
    A = -np.abs(rng.randn(ED, N)).astype(np.float32)
    B = rng.randn(bsz, L, N).astype(np.float32)
    C = rng.randn(bsz, L, N).astype(np.float32)
    D = rng.randn(ED).astype(np.float32)
    z = rng.randn(bsz, L, ED).astype(np.float32) if gate else None
    b = (rng.randn(ED) * 0.1).astype(np.float32) if bias else None
    g = rng.randn(bsz, L, ED).astype(np.float32)
    return [x, delta, A, B, C, D, z, b], g


def _jax_grads(args, g, softplus):
    """y and the VJP of the associative JAX scan w.r.t. every present
    input (None where absent), in the inputs' dtypes."""
    present = [i for i, a in enumerate(args) if a is not None]

    def f(*xs):
        full = list(args)
        for i, v in zip(present, xs):
            full[i] = v
        x, delta, A, B, C, D, z, b = full
        return jax_selective_scan(x, delta, A, B, C, D, z=z, delta_bias=b,
                                  delta_softplus=softplus,
                                  mode="associative")

    y, vjp = jax.vjp(f, *(args[i] for i in present))
    grads = [None] * 8
    for i, d in zip(present, vjp(g)):
        grads[i] = d
    return y, grads


def _assert_close(got, want, name, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), (name, err)


def _assert_bf16_ulp(got, want, name):
    ulps = bf16_ulps(got, torch.as_tensor(np.asarray(want, np.float32)))
    assert ulps <= 1.0, (name, ulps)


@pytest.mark.parametrize("want,got,ulps", [
    # 1.0's bf16 ulp is 2^-7; one ulp above rounds to itself
    ([1.0, -3.0], [1.0 + 2.0 ** -7, -3.0], 1.0),
    # 2^-13 lies below 2^-8 of the max (4.0): it takes the ulp of that
    # floor, 2^-6 -> 2^-13, not its own 2^-20, so a 2^-14 miss is half one
    ([4.0, 2.0 ** -13], [4.0, 1.5 * 2.0 ** -13], 0.5)])
def test_bf16_ulps(want, got, ulps):
    got = torch.tensor(got).bfloat16()
    assert bf16_ulps(got, torch.tensor(want)) == ulps


# ---- the operand plan ----------------------------------------------------


def _mamba_operands(dtype, bsz=2, L=5):
    """A small ``MambaBlock``'s scan operands (d_model 8, ED 16, dt_rank
    1, N 4): x, delta, z, B, C."""
    x, delta, _, B, C, _, z, _ = mamba_scan_operands(bsz, L, 8, dtype, "cpu",
                                                     d_state=4)
    return x, delta, z, B, C


def test_stage2_bf16_operands_pass_as_they_are():
    """Under the bf16 Stage-2 step a Mamba layer takes f32 tokens with
    bf16 weights and computes in f32 (``models/promote.py``): x, delta,
    z, B and C are f32 views in the same layout as above, D and
    delta_bias stay bf16, and every one goes to the kernels as it is."""
    x, delta, A, B, C, D, z, bias = mamba_scan_operands(
        2, 5, 8, torch.bfloat16, "cpu", d_state=4,
        input_dtype=torch.float32)
    ED, R = 16, 1
    for t in (x, delta, z, B, C):
        assert t.dtype == torch.float32
    assert D.dtype == bias.dtype == torch.bfloat16
    assert A.dtype == torch.float32
    for t in (x, delta, A, B, C, D, z, bias):
        assert k2.kernel_operand(t) is t
    assert k2.operand_meta(x) == (0, 5 * ED, 1, 5)
    assert k2.operand_meta(z) == (0, 5 * 2 * ED, 2 * ED, 1)
    assert k2.operand_meta(C) == (0, 5 * (R + 8), R + 8, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_operands_pass_as_they_are(dtype):
    """No operand of a Mamba layer is copied: x channel-major (last
    stride L), z, B, C views with their row strides, delta contiguous;
    the kernels get each one's strides and dtype."""
    x, delta, z, B, C = _mamba_operands(dtype)
    ED, R, bf16 = 16, 1, int(dtype == torch.bfloat16)
    for t in (x, delta, z, B, C):
        assert k2.kernel_operand(t) is t
    assert k2.operand_meta(x) == (bf16, 5 * ED, 1, 5)
    assert k2.operand_meta(delta) == (bf16, 5 * ED, ED, 1)
    assert k2.operand_meta(z) == (bf16, 5 * 2 * ED, 2 * ED, 1)
    assert k2.operand_meta(C) == (bf16, 5 * (R + 8), R + 8, 1)
    assert k2.OPERAND.unpack(k2._operand(C)) == (
        C.data_ptr(), 5 * (R + 8), R + 8, 1, bf16, 0)
    assert C.data_ptr() == B.data_ptr() + 4 * B.element_size()


def test_packed_args_have_the_kernels_layout():
    """``ScanArgs`` of csrc/scan.cuh: 11 operands of 40 bytes, then A,
    part, grads, batch, L, ED, N, softplus and slab: 488 bytes, as its
    static_assert pins them."""
    x, A = torch.randn(2, 5, 8), torch.randn(8, 4)
    args = k2._args((x, None, x, None, None, None, None, None, x, None,
                     None), A, 7, 9, 2, 5, 8, 4, True)
    assert len(args) == k2.ARGS_SIZE == 488
    assert args[40:80] == bytes(40)
    assert k2.OPERAND.unpack(args[:40]) == (x.data_ptr(), 40, 8, 1, 0, 0)
    assert np.frombuffer(args[440:464], np.int64).tolist() == [
        A.data_ptr(), 7, 9]
    assert np.frombuffer(args[464:], np.int32).tolist() == [
        2, 5, 8, 4, 1, 0]
    long = k2._args((x,) * 11, A, 0, 0, 1, 15024, 8192, 16, False, 64)
    assert np.frombuffer(long[464:], np.int32).tolist() == [
        1, 15024, 8192, 16, 0, 64]
    source = (pathlib.Path(k2.__file__).parents[2] / "csrc"
              / "scan.cuh").read_text()
    assert f"sizeof(ScanArgs) == {k2.ARGS_SIZE}" in source


# ---- K2's plan: which kernel, which slab, which chunk ----------------------

# v4's constants as the kernel's source defines them
_K2_SOURCE = (pathlib.Path(k2.__file__).parents[2] / "csrc"
              / "selective_scan.cu").read_text()
LONG_S, LONG_K, LONG_P = (
    int(re.search(rf"constexpr int {name} = (\d+);", _K2_SOURCE).group(1))
    for name in ("LONG_S", "LONG_K", "LONG_P"))


def test_long_kernel_constants_are_the_sources():
    """The wrapper's chunk is the kernel's: LONG_K steps for each of the
    N / LONG_S walkers of a channel; its slab is the one the kernel takes,
    refusing any other: 64 channels for N <= 16, 32 at N = 32."""
    assert (k2.LONG_STATES, k2.LONG_ITEMS) == (LONG_S, LONG_K)
    assert [k2.long_chunk(N) for N in (4, 8, 16, 32)] == [16, 32, 64, 128]
    assert "constexpr int CH = N <= 16 ? 64 : 32;" in _K2_SOURCE
    assert "if (a.slab != CH) return {};" in _K2_SOURCE
    assert [k2.long_slab(N) for N in (4, 8, 16, 32)] == [64, 64, 64, 32]


@pytest.mark.parametrize("L,slab,chunk", [
    (1, 0, 1), (53, 0, 53), (64, 0, 64), (65, 64, 64), (4467, 64, 64),
    (15024, 64, 64)])
def test_the_wrapper_picks_the_kernel_by_length(L, slab, chunk):
    """Up to SCAN_WHOLE steps the short kernel, one chunk of L (scoring
    and Stage 2 at 53 keep it); past it v4 with its slab and chunk (the
    docqa prefill at ED 8192, batch 1, N 16)."""
    assert k2.scan_plan(L, 16) == (slab, chunk)


@pytest.mark.parametrize("N,L,plan", [
    (4, 64, (0, 64)), (32, 64, (0, 64)), (4, 65, (64, 16)),
    (8, 65, (64, 32)), (16, 65, (64, 64)), (32, 65, (32, 128)),
    (4, 15024, (64, 16)), (8, 15024, (64, 32)), (16, 15024, (64, 64)),
    (32, 15024, (32, 128))])
def test_the_slab_follows_the_state_size(N, L, plan):
    """Past SCAN_WHOLE steps v4's slab and chunk follow N alone: slabs of
    64 channels, 32 at N = 32 (whose slab of 64 would not fit a block);
    up to it the short kernel at any N."""
    assert k2.scan_plan(L, N) == plan


def test_offsets_inside_a_chunk_stay_32_bit():
    """A Mamba layer's views and dense tensors fit v4's 32-bit offsets; a
    time or channel stride past them does not (the wrapper then copies
    the operand)."""
    x, delta, z, B, C = _mamba_operands(torch.bfloat16)
    for t in (x, delta, z):
        assert k2.offsets_fit(t, 64, 64)
    assert k2.offsets_fit(B, 64, 16) and k2.offsets_fit(None, 64, 64)
    far = torch.empty_strided((1, 40, 8), (2 ** 40, 2 ** 26, 1),
                              device="meta")
    assert not k2.offsets_fit(far, 64, 64)
    assert k2.offsets_fit(far, 16, 1)
    wide = torch.empty_strided((1, 40, 8), (2 ** 40, 1, 2 ** 26),
                               device="meta")
    assert not k2.offsets_fit(wide, 64, 64) and k2.offsets_fit(wide, 64, 32)


def _long_maps(N, CH):
    """v4's index maps (csrc/selective_scan.cu::scan_long_kernel): each
    walker's (channel, state group); each stager's row-major (t, c) items,
    channel-major x (t, c) items and B/C (t, n) items."""
    G, T = N // LONG_S, LONG_K * N // LONG_S
    NW, Q = CH * G, T * CH // LONG_P
    walk = [((w // 32) * (32 // G) + (w % 32) // G, (w % 32) % G)
            for w in range(NW)]
    rows, cols, bc = [], [], []
    for p in range(LONG_P):
        rows += [(p // CH + q * (LONG_P // CH), p % CH) for q in range(Q)]
        cols += [(p % T, p // T + q * (LONG_P // T)) for q in range(Q)]
        bc += [i for i in (p + q * LONG_P
                           for q in range(-(-T * N // LONG_P)))
               if i < T * N]
    return walk, rows, cols, bc, G, T


@pytest.mark.parametrize("N,CH", [(4, 64), (8, 64), (16, 64), (32, 32)])
def test_long_kernel_maps_cover_a_chunk_once(N, CH):
    """Every (channel, state group) has one walker, a channel's G walkers
    in one warp; the stagers' row-major and channel-major maps each take
    every (t, c) of a chunk once, their B/C items every (t, n) once, and
    a warp of stagers reads a run of 32 channels (row-major) or of 32
    steps (x); a walker warp touches one step's y and gate on 32 distinct
    banks (rows of CH + 32 / G floats), and a stager warp's x stores fall
    at most 2 to a bank (rows of CH + 1 pairs)."""
    walk, rows, cols, bc, G, T = _long_maps(N, CH)
    Q = T * CH // LONG_P
    cells = {(t, c) for t in range(T) for c in range(CH)}
    assert sorted(walk) == [(c, g) for c in range(CH) for g in range(G)]
    assert len(rows) == len(cells) and set(rows) == cells
    assert len(cols) == len(cells) and set(cols) == cells
    assert sorted(bc) == list(range(T * N))
    YR, XR = CH + 32 // G, CH + 1
    for w in range(len(walk) // 32):
        lanes = walk[32 * w:32 * w + 32]
        assert len({c // (32 // G) for c, _ in lanes}) == 1
        assert len({(g * YR + c) % 32 for c, g in lanes}) == 32
    for w in range(LONG_P // 32):
        for q in range(Q):
            warp_rows = rows[32 * w * Q + q:32 * (w + 1) * Q:Q]
            warp_cols = cols[32 * w * Q + q:32 * (w + 1) * Q:Q]
            assert [c for _, c in warp_rows] == \
                list(range(warp_rows[0][1], warp_rows[0][1] + 32))
            assert len({t for t, _ in warp_rows}) == 1
            if T >= 32:
                assert [t for t, _ in warp_cols] == \
                    list(range(warp_cols[0][0], warp_cols[0][0] + 32))
            banks = [(2 * (t * XR + c) + 1) % 32 for t, c in warp_cols]
            assert max(banks.count(k) for k in set(banks)) <= \
                max(2, 32 // T)


def _k2_long_emulation(x, delta, A, B, C, D, z, bias, softplus):
    """v4's decomposition in plain f32: slabs of ``long_slab`` channels
    padded with zeros past ED, chunks of ``long_chunk(N)`` steps, the last
    padded with d = 0, x = 0, B = C = 0 (so h walks through it unchanged);
    per step each group of LONG_S states sums its C_t . h_t, the groups'
    sums are added pairwise as the lanes' butterfly adds them, then D x
    and the gate.  Returns y and the last state."""
    bsz, L, ED = x.shape
    N = A.shape[1]
    G, T = N // LONG_S, k2.long_chunk(N)
    slab = k2.long_slab(N)
    Lp, EDp = -(-L // T) * T, -(-ED // slab) * slab

    def pad(t, last):
        return torch.nn.functional.pad(t, (0, last, 0, Lp - L))

    raw = delta + (0.0 if bias is None else bias)
    d = _softplus(raw) if softplus else raw
    d = pad(d, EDp - ED)
    d[:, L:] = 0.0
    xs, Bs, Cs = pad(x, EDp - ED), pad(B, 0), pad(C, 0)
    if z is None:
        gate = torch.ones(bsz, Lp, EDp)
    else:
        gate = pad(z / (1.0 + torch.exp(-z)), EDp - ED)
    a = torch.nn.functional.pad(A, (0, 0, 0, EDp - ED))
    Dv = torch.nn.functional.pad(D, (0, EDp - ED))
    h = torch.zeros(bsz, EDp, N)
    ys = []
    for t in range(Lp):
        du = (d[:, t] * xs[:, t])[..., None]
        h = torch.exp(d[:, t, :, None] * a) * h + du * Bs[:, t, None, :]
        parts = list((h * Cs[:, t, None, :]).view(bsz, EDp, G, LONG_S)
                     .sum(-1).unbind(-1))
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [parts[i] + parts[i + half] for i in range(half)]
        ys.append((parts[0] + Dv * xs[:, t]) * gate[:, t])
    return torch.stack(ys, 1)[:, :L, :ED], h[:, :ED]


@pytest.mark.parametrize("N,L,ED,bsz,gate,bias,softplus", [
    (16, 70, 40, 1, True, True, True), (16, 33, 70, 2, False, False, True),
    (4, 21, 9, 2, True, False, False), (8, 37, 33, 1, False, True, True),
    (32, 65, 6, 1, True, True, True)])
def test_long_kernel_decomposition_matches_jax(N, L, ED, bsz, gate, bias,
                                               softplus):
    """v4's slabs (ED not a multiple of the slab), chunks (L not a multiple
    of the chunk: the zero-padded steps leave the last state as it is),
    state groups and butterfly sum hold y to JAX's scan within 1e-5, and
    the last state to the sequential loop's."""
    args, _ = _inputs(L, bsz=bsz, L=L, ED=ED, N=N, gate=gate, bias=bias,
                      softplus=softplus)
    want = jax_selective_scan(*[None if a is None else jnp.asarray(a)
                                for a in args[:6]],
                              z=None if args[6] is None
                              else jnp.asarray(args[6]),
                              delta_bias=None if args[7] is None
                              else jnp.asarray(args[7]),
                              delta_softplus=softplus, mode="sequential")
    t = [None if a is None else torch.from_numpy(a) for a in args]
    got, h = _k2_long_emulation(*t, softplus)
    _assert_close(got, want, "y", rel=1e-5)
    _, want_h = k2.selective_scan_plain(*t[:6], z=t[6], delta_bias=t[7],
                                        delta_softplus=softplus,
                                        return_state=True)
    _assert_close(h, want_h, "h", rel=1e-5)


def test_what_the_caller_casts():
    """Only a dtype the kernels do not read (f16, f64) is cast, to f32;
    strides never force a copy."""
    half = torch.randn(2, 5, 8).half()
    out = k2.kernel_operand(half)
    assert out.dtype == torch.float32 and torch.equal(out, half.float())
    strided = torch.randn(2, 8, 5, dtype=torch.float64).transpose(1, 2)
    assert k2.kernel_operand(strided).dtype == torch.float32
    t = torch.randn(4, 5, 8).transpose(0, 1)[:, ::2]
    assert k2.kernel_operand(t) is t
    assert k2.operand_meta(t) == (0, 8, 2 * 40, 1)
    assert k2.kernel_operand(None) is None
    vec = torch.randn(16, dtype=torch.bfloat16)[::2]
    assert k2.kernel_operand(vec) is vec
    assert k2.operand_meta(vec) == (1, 0, 0, 2)
    assert k2.operand_meta(None) == (0, 0, 0, 0)


def test_a_batch_row_fills_the_card():
    """At the Stage-2 shape (batch 1, ED 1024) the kernels' grid of
    ceil(ED / SCAN_CH) blocks has one block at least per SM of an H100
    (132)."""
    assert -(-1024 // SCAN_CH) >= 132


# ---- K4's decomposition, emulated ----------------------------------------


def _softplus(v):
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def _k4_emulation(x, delta, A, B, C, D, z, bias, g, softplus):
    """K4's phases over blocks of SCAN_CH channels (padded with
    zeros past ED), vectorised over (batch, block); dB/dC come out per
    block and are summed over blocks in order, dA/dD/dbias summed over
    batch in order, as the kernel's second launch does."""
    bsz, L, ED = x.shape
    N, CH = A.shape[1], SCAN_CH
    nblk = -(-ED // CH)
    pad = nblk * CH - ED

    def tiles(t):              # (bsz, L, ED) -> (bsz, nblk, L, CH)
        t = torch.nn.functional.pad(t, (0, pad))
        return t.view(bsz, L, nblk, CH).permute(0, 2, 1, 3)

    def vec(t):                # (ED,) -> (nblk, CH)
        return torch.nn.functional.pad(t, (0, pad)).view(nblk, CH)

    xs, gs = tiles(x), tiles(g)
    raw = tiles(delta) + (0.0 if bias is None else vec(bias)[:, None])
    ds = _softplus(raw) if softplus else raw
    sg = torch.sigmoid(raw) if softplus else torch.ones_like(raw)
    a = torch.nn.functional.pad(A, (0, 0, 0, pad)).view(nblk, CH, N)
    a = a.transpose(1, 2)                                # (nblk, N, CH)
    Dv = vec(D)[:, None]                                 # (nblk, 1, CH)
    Bb, Cb = B[:, None], C[:, None]                      # (bsz, 1, L, N)
    # pass 1: h_t for every t, [t][n][c]
    hs = torch.zeros(bsz, nblk, L, N, CH)
    h = torch.zeros(bsz, nblk, N, CH)
    for t in range(L):
        d = ds[:, :, t, None, :]
        h = torch.exp(d * a) * h + (d * xs[:, :, t, None, :]) \
            * Bb[:, :, t, :, None]
        hs[:, :, t] = h
    # s_t, ds, dz over (t, c); dC partials over (t, n)
    if z is None:
        dsv, dz = gs, None
    else:
        zs = tiles(z)
        s = torch.einsum("kbtnc,kbtn->kbtc", hs, Cb.expand(-1, nblk, -1, -1)) \
            + Dv * xs
        sig = torch.sigmoid(zs)
        dsv = gs * zs * sig
        dz = gs * s * (sig * (1.0 + zs * (1.0 - sig)))
    dC_part = torch.einsum("kbtnc,kbtc->kbtn", hs, dsv)
    # pass 2: only dh carries; dh_t and w_t kept per step
    dhs = torch.zeros_like(hs)
    w = torch.zeros_like(hs)
    dh = torch.zeros(bsz, nblk, N, CH)
    da = torch.zeros(bsz, nblk, N, CH)
    for t in reversed(range(L)):
        d = ds[:, :, t, None, :]
        dh = dh + Cb[:, :, t, :, None] * dsv[:, :, t, None, :]
        dhs[:, :, t] = dh
        ea = torch.exp(d * a)
        hp = hs[:, :, t - 1] if t > 0 else torch.zeros_like(dh)
        wt = dh * hp * ea
        da = da + wt * d
        w[:, :, t] = wt * a
        dh = dh * ea
    dhb = torch.einsum("kbtnc,kbtn->kbtc", dhs, Bb.expand(-1, nblk, -1, -1))
    dd = (dhb * xs + w.sum(3)) * sg
    dx = dhb * ds + Dv * dsv
    dB_part = torch.einsum("kbtnc,kbtc->kbtn", dhs, ds * xs)

    def untile(t):             # (bsz, nblk, L, CH) -> (bsz, L, ED)
        return t.permute(0, 2, 1, 3).reshape(bsz, L, nblk * CH)[..., :ED]

    dB, dC = torch.zeros(bsz, L, N), torch.zeros(bsz, L, N)
    for blk in range(nblk):
        dB += dB_part[:, blk]
        dC += dC_part[:, blk]
    dA_b = da.permute(0, 1, 3, 2).reshape(bsz, nblk * CH, N)[:, :ED]
    dD_b = (dsv * xs).sum(2).reshape(bsz, -1)[:, :ED]
    dbias_b = dd.sum(2).reshape(bsz, -1)[:, :ED]
    dA, dD, dbias = torch.zeros(ED, N), torch.zeros(ED), torch.zeros(ED)
    for b in range(bsz):
        dA += dA_b[b]
        dD += dD_b[b]
        dbias += dbias_b[b]
    return (untile(dx), untile(dd), dA, dB, dC, dD,
            None if dz is None else untile(dz),
            None if bias is None else dbias)


@pytest.mark.parametrize("gate,bias,softplus,ED,bsz", [
    (True, True, True, 6, 1), (False, False, True, 8, 2),
    (True, False, False, 9, 2), (False, True, False, 4, 1)])
def test_k4_block_decomposition_matches_jax_vjp(gate, bias, softplus, ED,
                                                bsz):
    """Ragged ED (6, 9: a last block of 2 or 1 channels), whole blocks (4,
    8), batch 1 and 2, each flag on and off."""
    args, g = _inputs(7, bsz=bsz, ED=ED, gate=gate, bias=bias,
                      softplus=softplus)
    _, want = _jax_grads([None if a is None else jnp.asarray(a)
                          for a in args], jnp.asarray(g), softplus)
    got = _k4_emulation(*[None if a is None else torch.from_numpy(a)
                          for a in args], torch.from_numpy(g), softplus)
    for name, a, b in zip(NAMES, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            _assert_close(a, b, name)


# ---- SelectiveScanFn with bf16 operands -----------------------------------


def test_scan_fn_with_bf16_operands_matches_jax():
    """bf16 x, delta, z, B, C, D, delta_bias (A f32) on the CPU: y and
    every gradient in its input's dtype, each within one bf16 ulp of the
    JAX scan run on the same bf16 inputs (both cast to f32 inside and
    round once at the end)."""
    args, g = _inputs(8, ED=10)
    bf = [None if a is None else
          (torch.from_numpy(a) if i == 2 else
           torch.from_numpy(a).bfloat16()) for i, a in enumerate(args)]
    g_bf = torch.from_numpy(g).bfloat16()
    y_jax, grads_jax = _jax_grads(
        [None if t is None else jnp.asarray(t.float().numpy()).astype(
            jnp.float32 if i == 2 else jnp.bfloat16)
         for i, t in enumerate(bf)],
        jnp.asarray(g_bf.float().numpy()).astype(jnp.bfloat16), True)
    leaves = [None if t is None else t.clone().requires_grad_() for t in bf]
    x, delta, A, B, C, D, z, b = leaves
    y = selective_scan(x, delta, A, B, C, D, z=z, delta_bias=b,
                       delta_softplus=True)
    assert y.dtype == torch.bfloat16
    y.backward(g_bf)
    _assert_bf16_ulp(y.detach(), np.asarray(y_jax, np.float32), "y")
    for name, t, want in zip(("x", "delta", "A", "B", "C", "D", "z", "b"),
                             leaves, grads_jax):
        assert t.grad.dtype == t.dtype, name
        want = np.asarray(want, np.float32)
        if t.dtype == torch.bfloat16:
            _assert_bf16_ulp(t.grad, want, name)
        else:
            _assert_close(t.grad, want, name)
