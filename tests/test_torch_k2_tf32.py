"""K2's f32 mode as a three-pass TF32 split, on the CPU (no JAX, seconds).

``csrc/mrf_f32.cu`` computes each f32 conv on the tensor cores as ``a_hi
w_hi + a_hi w_lo + a_lo w_hi`` with ``hi = tf32_rna(x)`` and ``lo = x -
hi`` (``mrf.tf32_split``), the tensor core reading each operand truncated
to tf32. Here: the split is exact and rounds to nearest; a plain emulation
of the three products holds one conv of each kind at UNIVERSAL_V1's widths
within ``K2F_TOL`` of the plain f32 conv, and the one- and two-pass defects
read at least ``K2F_DEFECT_MARGIN`` times that; the weights' hi / lo copies
read back at the kernel's offsets; and the kernel's shared-memory plan,
mirrored from its source, fits every UNIVERSAL_V1 conv.
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.ops import mrf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "tacotron2_tpu_torch" / "csrc" / "mrf_f32.cu").read_text()


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()
TOL, MARGIN = SMOKE.K2F_TOL, SMOKE.K2F_DEFECT_MARGIN


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """f32 -> TF32 (10 mantissa bits) to nearest, ties away from zero, in
    f64 arithmetic: |x| / ulp + 1/2, floored, times the ulp of x's binade."""
    x64 = x.astype(np.float64)
    out = np.zeros_like(x64)
    nz = x64 != 0
    e = np.floor(np.log2(np.abs(x64[nz])))
    ulp = np.exp2(e - 10)
    out[nz] = np.sign(x64[nz]) * np.floor(np.abs(x64[nz]) / ulp + 0.5) * ulp
    return out.astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "wide", "ties"])
def test_tf32_split_is_exact(kind):
    """hi + lo == x bit for bit, hi's low 13 mantissa bits zero, hi the
    round-to-nearest of x (ties away from zero, ``cvt.rna``), lo within
    half a TF32 ulp of hi's binade."""
    rng = np.random.default_rng(11)
    if kind == "normal":
        x = rng.standard_normal(20000).astype(np.float32)
    elif kind == "wide":
        x = (rng.standard_normal(20000) * np.exp2(rng.integers(-60, 60, 20000))).astype(
            np.float32)
    else:  # exactly halfway between two TF32 values, both signs, and the carry into the exponent
        m = rng.integers(0, 1 << 10, 4000, dtype=np.int64)
        e = rng.integers(100, 150, 4000, dtype=np.int64)
        bits = (e << 23) | (m << 13) | 0x1000
        bits = np.concatenate([bits, bits | (1 << 31), [(120 << 23) | 0x7FF000]])
        x = bits.astype(np.uint32).view(np.float32)
    xt = torch.from_numpy(x.copy())
    hi, lo = mrf.tf32_split(xt)
    assert torch.equal(hi + lo, xt)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy(), _rna_reference(x))
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11 + 1e-38).all())
    if kind == "ties":
        assert bool((hi.abs() > xt.abs()).all())  # away from zero


def _trunc(t):
    """An f32 tensor as the tensor core reads tf32: the low 13 bits dropped."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _conv64(a, w, dil):
    """SAME conv of (B, T, Ci) by tap-major (K, Co, Ci) weights in f64."""
    K = w.shape[0]
    return F.conv1d(a.double().transpose(1, 2), w.double().permute(1, 2, 0),
                    padding=dil * (K - 1) // 2, dilation=dil).transpose(1, 2)


def _emulate(a, w, dil, passes=7):
    """The kernel's sum of products in f64 (the tensor core's f32 sums
    apart): 1 a_lo w_hi, 2 a_hi w_lo, 4 a_hi w_hi, each operand as the
    tensor core reads it."""
    ah, al = mrf.tf32_split(a)
    wh, wl = mrf.tf32_split(w)
    out = 0
    for bit, x, y in ((1, _trunc(al), wh), (2, ah, _trunc(wl)), (4, ah, wh)):
        if passes & bit:
            out = out + _conv64(x, y, dil)
    return out


def _weights(rng, K, Co, Ci, scale):
    return torch.from_numpy((rng.standard_normal((K, Co, Ci)) * scale).astype(np.float32))


def _case(kind):
    """One conv of each kind at UNIVERSAL_V1's widths -> (emulated sum by
    passes, the plain f32 output)."""
    rng = np.random.default_rng({"mrf_conv": 1, "mrf_pair": 2, "ups8": 3, "ups2": 4,
                                 "conv_pre": 5}[kind])
    bias = lambda C: torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32))
    x = lambda B, T, C: torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32))
    if kind == "mrf_conv":  # stage 1: C = 256, k = 11, d = 5
        cw = mrf.ConvWeights(_weights(rng, 11, 256, 256, 0.02), bias(256), 5)
        a = mrf.operand(x(1, 96, 256), torch.float32)
        ref = mrf.mrf_conv_plain(a, cw)[0]
        return (lambda p: _emulate(a, cw.w, 5, p) + cw.b.double()), ref
    if kind == "mrf_pair":  # stage 2: C = 128, k = 11, d = 5 then 1
        c1 = mrf.ConvWeights(_weights(rng, 11, 128, 128, 0.03), bias(128), 5)
        c2 = mrf.ConvWeights(_weights(rng, 11, 128, 128, 0.03), bias(128), 1)
        a = mrf.operand(x(1, 128, 128), torch.float32)
        ref = mrf.mrf_pair_plain(a, c1, c2)[0]

        def emulate(p):
            # the kernel keeps the first conv's lrelu in f32 and splits it again
            at = F.leaky_relu((_emulate(a, c1.w, 5, p) + c1.b.double()).float(), 0.1)
            return _emulate(at, c2.w, 1, p) + c2.b.double()
        return emulate, ref
    if kind in ("ups8", "ups2"):  # the folded upsample: 512 -> 8 x 256, 128 -> 2 x 64
        u, Ci, Co, T = (8, 512, 256, 24) if kind == "ups8" else (2, 128, 64, 96)
        w = torch.from_numpy((rng.standard_normal((2 * u, Ci, Co)) * 0.02).astype(np.float32))
        uw = mrf.make_upsample(w, bias(Co), u, u // 2)
        a = mrf.operand(x(1, T, Ci), torch.float32)
        ref = mrf.conv_transpose_plain(a, uw)[0]
        fw = uw.folded
        return (lambda p: (_emulate(a, fw.w, 1, p) + fw.b.double()).reshape(ref.shape)), ref
    cw = mrf.ConvWeights(_weights(rng, 7, 512, 80, 0.05), bias(512), 1)  # conv_pre
    mel = x(1, 48, 80)
    ref = mrf.mrf_conv_plain(mel, cw)[0]
    return (lambda p: _emulate(mel, cw.w, 1, p) + cw.b.double()), ref


@pytest.mark.parametrize("kind", ["mrf_conv", "mrf_pair", "ups8", "ups2", "conv_pre"])
def test_three_pass_emulation_holds_each_conv(kind):
    """The three products hold the plain f32 conv within K2F_TOL of its
    max; one pass (``a_hi w_hi``: the lo passes left out) and two (the
    ``a_lo`` pass left out) read at least K2F_DEFECT_MARGIN x K2F_TOL."""
    emulate, ref = _case(kind)
    scale = float(ref.abs().max())
    read = {p: float((emulate(p) - ref.double()).abs().max()) / scale for p in (7, 6, 4)}
    assert read[7] <= TOL, read
    assert read[6] >= MARGIN * TOL and read[4] >= MARGIN * TOL, read


# every conv of UNIVERSAL_V1 at the say's 384-frame bucket, (K, Co, Ci, T,
# dilations): conv_pre, the four folded upsamples (3 taps to u Co), the
# resblocks' three kernel sizes per stage
UV1_CONVS = ([(7, 512, 80, 384, (1,)), (3, 2048, 512, 384, (1,)), (3, 1024, 256, 3072, (1,)),
              (3, 128, 128, 24576, (1,)), (3, 64, 64, 49152, (1,))]
             + [(k, c, c, t, (1, 3, 5)) for c, t in ((256, 3072), (128, 24576), (64, 49152),
                                                    (32, 98304)) for k in (3, 7, 11)])


@pytest.mark.parametrize("K,Co,Ci", [c[:3] for c in UV1_CONVS])
def test_hi_lo_copies_read_back(K, Co, Ci):
    """The f32 copy holds the hi and lo planes of each (N tile, slice, tap)
    side by side; each plane read back through ``read_tiled`` at the
    kernel's offsets is ``tf32_split``'s, and the two add to the weights
    bit for bit."""
    rng = np.random.default_rng(K * 7 + Co + Ci)
    w = torch.from_numpy((rng.standard_normal((K, Co, Ci)) * 0.05).astype(np.float32))
    wt = mrf.tile_conv(w)
    NI, KC = mrf.conv_tiles(Co, Ci, torch.float32)
    assert wt.shape == (Co // NI, -(-Ci // KC), K, 2, KC // 4, NI, 4)
    hi, lo = mrf.tf32_split(w)
    assert torch.equal(mrf.read_tiled(wt, K, Co, Ci, 0), hi)
    assert torch.equal(mrf.read_tiled(wt, K, Co, Ci, 1), lo)
    assert torch.equal(mrf.read_tiled(wt, K, Co, Ci), w)
    assert not (wt[:, :, :, 0].contiguous().view(torch.int32) & 0x1FFF).any()


def _const(name: str) -> int:
    """A constant of csrc/mrf_f32.cu (digits and products)."""
    expr = re.search(rf"constexpr \w+ {name} = ([0-9 *]+);", SRC).group(1)
    return math.prod(int(v) for v in expr.split("*"))


def _plan(B, T, Ci, Co, K, dil, pair, sms=132):
    """``conv_plan`` of csrc/mrf_f32.cu in Python, from the source's
    constants -> (MT, NI, G, nslot, A buffers, shared-memory bytes) or
    None."""
    kc, stages, stage_bytes = _const("kKC"), _const("kStages"), _const("kStageBytes")
    max_smem, min_n, wg, accum = (_const("kMaxSmem"), _const("kMinSplitN"), _const("kWG"),
                                  _const("kAccum"))
    wn = 128 if Co % 128 == 0 else 64 if Co % 64 == 0 else 32
    ns, convs = -(-Ci // kc), 2 if pair else 1
    for mt in (4, 2, 1) if pair else (2, 1):
        if not pair and mt == 2 and -(-T // 256) * B * (Co // min(wn, accum // 2)) < sms:
            continue
        ni = wn if pair else min(wn, accum // mt)
        if pair and mt * ni > accum:
            continue
        b = -(-T // 128) * B * (Co // ni)
        while (not pair and mt == 1 and ni > min_n
               and -(-2 * b // sms) * (ni // 2) < -(-b // sms) * ni):
            ni, b = ni // 2, 2 * b
        bm = wg * mt * 64
        rows = bm + (K - 1) * dil
        nbox = -(-rows // 256)
        box_rows = (-(-rows // nbox) + 7) & ~7
        if box_rows > 256:
            continue
        na = 2 if ns > 1 else 1
        region = na * 2 * nbox * box_rows * kc * 4
        rows_t = (bm + K - 1 + 7) & ~7
        if pair:  # the intermediate as hi / lo planes, or raw and split a slice at a time
            region = max(region, rows_t * (Co * 4 + 4 * kc * 4) if Co > 64 and K >= 7
                         else 2 * rows_t * Co * 4)
        fixed = 1024 + region + (2 * stages + 4) * 8
        if fixed >= max_smem:
            continue
        tile = 2 * ni * kc * 4
        G = max(1, min(K, stage_bytes // tile))
        while True:
            n_it = convs * ns * -(-K // G)
            nslot = min(stages, n_it, (max_smem - fixed) // (G * tile))
            if nslot >= min(2, n_it) or G == 1:
                break
            G = (G + 1) // 2
        if nslot < min(2, n_it):
            continue
        return mt, ni, G, nslot, na, fixed + nslot * G * tile
    return None


def test_plan_constants_read_from_the_source():
    assert (_const("kKC"), _const("kMaxSmem")) == (mrf.F32_KC, 227 * 1024)
    assert "constexpr int kPasses = 7;" in SRC  # the defects' copies replace this line


@pytest.mark.parametrize("rows", [1, 16, 64])
def test_shared_memory_plan_fits_every_conv(rows):
    """At the say's bucket (384 frames) and the serve windows' rows, every
    UNIVERSAL_V1 conv and every fused pair (C <= 128, each kernel size and
    dilation) has a plan within 227 KB with two ring stages or more and two
    A buffers; a pair's M tile follows its shape only, never the rows."""
    for K, Co, Ci, T, dils in UV1_CONVS:
        for dil in dils:
            plan = _plan(rows, T, Ci, Co, K, dil, False)
            assert plan is not None and plan[5] <= 227 * 1024, (K, Co, Ci, dil)
            assert plan[3] >= min(2, -(-Ci // 16) * -(-K // plan[2])) and plan[4] == 2, plan
    stage_T = {128: 24576, 64: 49152, 32: 98304}
    for C in (128, 64, 32):
        for K in (3, 7, 11):
            for dil in (1, 3, 5):
                plan = _plan(rows, stage_T[C], C, C, K, dil, True)
                assert plan[3] >= 2 and plan[4] == 2, plan
                assert plan == _plan(1, 100, C, C, K, dil, True)
    assert _plan(rows, 24576, 128, 128, 11, 5, True)[:4] == (1, 128, 2, 3)  # 128 rows at C = 128
    for K, Co, Ci, T, dils in UV1_CONVS:  # a thread's sums fit its registers
        mt, ni = _plan(rows, T, Ci, Co, K, dils[-1], False)[:2]
        assert mt * ni <= _const("kAccum")
    assert _plan(rows, 98304, 32, 32, 11, 5, True)[0] == 4  # 512 rows at C = 32


def test_one_row_fills_the_card():
    """At one row the plan takes 128-row tiles and narrows N (down to 32
    channels) while that takes fewer waves of blocks x channels: stage 1's
    convs at 64 of 256 channels (96 blocks, one wave; 32 would be two),
    ``conv_pre`` at 32 of 512."""
    mt, ni = _plan(1, 3072, 256, 256, 11, 5, False)[:2]
    assert mt == 1 and ni == 64 and math.ceil(3072 / 128) * 256 // ni == 96  # one wave
    assert _plan(64, 3072, 256, 256, 11, 5, False)[:2] == (2, 64)
    assert _plan(1, 384, 80, 512, 7, 1, False)[:2] == (1, 32)


def _ring_runs(K, ns, G, nslot, na, pair) -> bool:
    """The kernel's producer and consumers (conv_tf32_kernel, conv_mainloop)
    as a protocol over the weight ring and the ``na`` A buffers, stepped
    until done (True) or until neither can move (a deadlock, False). The
    producer loads slice s's A once slice s - na's last stage is released,
    then stage it once stage it - nslot is; the consumers keep one stage's
    products in flight behind the one they issue and release every stage
    at the end of a slice."""
    kg = -(-K // G)
    n1 = ns * kg
    n_it = 2 * n1 if pair else n1
    released, a_loaded, a_released, filled = set(), set(), set(), set()
    p_it, p_a, c_it, pend = 0, False, 0, -1

    def release(m):
        released.add(m)
        if m < n1 and m % kg == kg - 1:
            a_released.add(m // kg)

    while c_it < n_it:
        moved = False
        while p_it < n_it:
            i1 = p_it if p_it < n1 else p_it - n1
            s, j0 = i1 // kg, (i1 % kg) * G
            if p_it < n1 and j0 == 0 and not p_a:
                if s >= na and s - na not in a_released:
                    break
                a_loaded.add(s)
                p_a = moved = True
            if p_it >= nslot and p_it - nslot not in released:
                break
            filled.add(p_it)
            p_it, p_a, moved = p_it + 1, False, True
        first = c_it < n1
        i1 = c_it if first else c_it - n1
        s, j0 = i1 // kg, (i1 % kg) * G
        if (not first or j0 > 0 or s in a_loaded) and c_it in filled:
            if pend >= 0:
                release(pend)
            if j0 + min(G, K - j0) < K:
                pend = c_it
            else:
                release(c_it)
                pend = -1
            c_it, moved = c_it + 1, True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("K", [1, 3, 5, 7, 11])
def test_ring_protocol_never_deadlocks(K):
    """Every plan the kernel can take (slices, taps a stage, ring slots, a
    pair or not; two A buffers, one for one slice) runs to its end; one ring slot would not where
    a slice spans two stages or more (the consumers release a stage one
    behind, at the end of a slice at once)."""
    stuck = 0
    for ns in (1, 2, 3, 5, 16):
        for G in range(1, K + 1):
            for pair in (False, True):
                n_it = (2 if pair else 1) * ns * -(-K // G)
                for nslot in range(min(2, n_it), min(_const("kStages"), n_it) + 1):
                    na = min(2, ns)
                    assert _ring_runs(K, ns, G, nslot, na, pair), (ns, G, nslot, na, pair)
                stuck += not _ring_runs(K, ns, G, 1, min(2, ns), pair)
    assert (stuck > 0) == (K > 1)
