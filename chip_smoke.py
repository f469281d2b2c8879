#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tacotron2_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. print the card (``nvidia-smi``), torch and CUDA versions; TF32 off for
   the plain versions;
2. build every CUDA kernel from ``tacotron2_tpu_torch/csrc`` (one nvcc per
   source, in parallel);
3. hold each kernel against its plain PyTorch version on the card at the
   slice's full-width shapes (K1: one decode step at the flagship dims;
   K2: the four UNIVERSAL_V1 MRF stages and stage 2 without its upsample,
   at 64 mel frames and at the say's vocode bucket), and time kernel, plain
   version and library call;
4. run ``say`` through the port's CLI entry on random full-width weights
   saved as a reference Lightning ``.ckpt`` and a UNIVERSAL_V1 ``g_*`` file:
   a forced 256-frame decode with the launch counters read around it, a
   forced early stop (1 frame), and the kernel decode against the plain
   decode over 32 frames;
5. print the kernels line and, last, the ``{"ok": true, ...}`` line.

It exits non-zero before the last line on any failure, when no CUDA device
is visible, or when the port's package is not beside this file. Details go
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
WORK = ROOT / "build" / "smoke"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
TEXT = ("The quick brown fox jumps over the lazy dog, while the port speaks "
        "its first words on the card.")
SEED = 7
K1_TOL = 1e-4  # max |kernel - plain| / max(1, max |plain|), one step, bf16 operands
K2_TOL = 5e-3  # the same for one MRF stage (18 convs)
# 32 autoregressive frames, kernel decode vs plain decode, per output; the
# alignments' limit is absolute (max |ref| <= 1), 1% of a weight at L ~ 100
DECODE_TOL = {"mels_post": 1e-3, "gates": 1e-4, "alignments": 1e-4}
PAD = 29  # chars of padding in the padded row of the B=2 attention check
UNIVERSAL_V1 = {
    "resblock": "1", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "num_mels": 80,
    "sampling_rate": 22050, "hop_size": 256,
}


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call of ``fn``: ``inner`` calls captured in one
    CUDA graph, replayed ``reps`` times between two CUDA events, so the
    host's launch cost stays out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * inner)


def eager_ms(fn, reps: int = 50) -> float:
    """Time of one eager call, launches from the host included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def err(got, ref) -> tuple:
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise SmokeFailure("kernel output is not finite")
    a = float((got - ref).abs().max())
    return a, a / max(1.0, float(ref.abs().max()))


def check(name: str, pairs, tol, log: dict, kernel: str = "") -> float:
    """Compare (label, kernel output, plain output) pairs; ``tol`` is one
    limit or a limit per label; ``kernel`` names the wrapper whose JSON row
    the error belongs to."""
    worst = 0.0
    for label, got, ref in pairs:
        a, r = err(got, ref)
        lim = tol[label] if isinstance(tol, dict) else tol
        worst = max(worst, a)
        print(f"  {name:<20} {label:<14} max_abs_err {a:.3e}  rel {r:.3e}  (tol {lim:g})")
        log.setdefault("checks", []).append({"kernel": kernel or name, "check": name,
                                             "output": label, "max_abs_err": a,
                                             "rel_err": r, "tol": lim})
        if not r <= lim:
            raise SmokeFailure(f"{name} {label}: rel err {r:.3e} > {lim:g}")
    return worst


# ---------------------------------------------------------------------------


def random_tacotron(cfg, gate_bias: float):
    import torch

    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.run.say import model_config_from
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2

    torch.manual_seed(SEED)
    m = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision))
    with torch.no_grad():
        m.encoder.embedding.weight.normal_(0.0, 0.5)
        m.decoder.gate.bias.fill_(gate_bias)
    return m.eval()


def random_hifigan_state():
    """UNIVERSAL_V1 generator state with weight norm (g, v) on every conv,
    as the upstream ``g_*`` files store it."""
    import torch

    from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig

    torch.manual_seed(SEED + 1)
    sd = HiFiGAN(HiFiGANConfig.from_dict(UNIVERSAL_V1)).state_dict()
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight"):
            base = k[: -len(".weight")]
            out[base + ".weight_v"] = v.clone()
            dims = tuple(range(1, v.dim()))
            out[base + ".weight_g"] = v.pow(2).sum(dim=dims, keepdim=True).sqrt()
        else:
            out[k] = v
    return out


def k1_phase(model, L: int, log: dict) -> list:
    """One decode step at the flagship dims, kernels against plain versions."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    dev = torch.device("cuda")
    c = model.cfg
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    pk = dl.pack_decoder(model.prenet, model.decoder, torch.bfloat16)
    B, M, P, H, D, A = 1, c.num_mels, c.prenet_dim, c.att_rnn_dim, c.encoded_dim, c.att_dim
    rn = lambda *s, scale=0.5: torch.randn(*s, device=dev, generator=g) * scale
    encoded = rn(B, L, D).to(torch.bfloat16)
    att_enc = (encoded.float() @ model.att_encoder.weight.t()).contiguous()
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    w_prev = torch.softmax(rn(B, L, scale=3.0), dim=1)
    s = dl.StepState(rn(B, M, scale=1.0), rn(B, H), rn(B, H), rn(B, D), w_prev,
                     w_prev + torch.softmax(rn(B, L, scale=3.0), dim=1), rn(B, H), rn(B, H))
    m1, m2 = dl.prenet_masks(1, B, P, c.dropout, g, dev)
    m1, m2 = m1[0], m2[0]

    x_k = dl.prenet(s.mel, pk.wp1_t, pk.wp2_t, m1, m2)
    x_p = dl.prenet_plain(s.mel, pk.wp1_t, pk.wp2_t, m1, m2)
    check("prenet", [("out", x_k, x_p)], K1_TOL, log)
    ah_k, ac_k = dl.lstm_cell(pk.w_att, pk.b_att, x_p, s.ctx, s.att_h, s.att_c)
    ah_p, ac_p = dl.lstm_cell_plain(pk.w_att, pk.b_att, x_p, s.ctx, s.att_h, s.att_c)
    check("lstm_cell[att]", [("h", ah_k, ah_p), ("c", ac_k, ac_p)], K1_TOL, log, "lstm_cell")
    att_args = (ah_p, pk.wq, pk.w_loc, pk.wv, att_enc, encoded, lengths, s.att_w, s.att_cum)
    ctx_k, w_k, cum_k = dl.location_attention(*att_args)
    ctx_p, w_p, cum_p = dl.location_attention_plain(*att_args)
    check("location_attention", [("context", ctx_k, ctx_p), ("weights", w_k, w_p),
                                 ("cum_weights", cum_k, cum_p)], K1_TOL, log)
    rh_k, rc_k = dl.lstm_cell(pk.w_dec, pk.b_dec, ah_p, ctx_p, s.rnn_h, s.rnn_c)
    rh_p, rc_p = dl.lstm_cell_plain(pk.w_dec, pk.b_dec, ah_p, ctx_p, s.rnn_h, s.rnn_c)
    check("lstm_cell[dec]", [("h", rh_k, rh_p), ("c", rc_k, rc_p)], K1_TOL, log, "lstm_cell")
    mg_k = dl.heads(pk.w_out, pk.b_out, rh_p, ctx_p)
    mg_p = dl.heads_plain(pk.w_out, pk.b_out, rh_p, ctx_p)
    check("heads", [("mel_gate", mg_k, mg_p)], K1_TOL, log)

    # whole steps through the chunk entry (the decode's main path) against
    # the plain chunk: one step, then four (the state ping-pongs)
    for n in (1, 4):
        mk1, mk2 = dl.prenet_masks(n, B, P, c.dropout, g, dev)
        mg, al, sk = dl.decode_chunk(pk, encoded, att_enc, lengths, s, mk1, mk2)
        mgp, alp, sp = dl.decode_chunk_plain(pk, encoded, att_enc, lengths, s, mk1, mk2)
        check(f"decode_chunk[{n}]", [("mel_gate", mg, mgp), ("weights", al, alp),
                                     ("att_h", sk.att_h, sp.att_h), ("att_c", sk.att_c, sp.att_c),
                                     ("context", sk.ctx, sp.ctx), ("cum", sk.att_cum, sp.att_cum),
                                     ("rnn_h", sk.rnn_h, sp.rnn_h), ("rnn_c", sk.rnn_c, sp.rnn_c)],
              K1_TOL, log, "decode_chunk")

    # B=2 with row 1 padded (lengths < L): the attention's -inf mask on the
    # card, alone and inside a 4-step chunk; padded chars get weight 0
    lengths2 = torch.tensor([L, L - PAD], dtype=torch.int32, device=dev)
    pad2 = torch.arange(L, device=dev)[None, :] >= lengths2[:, None]
    enc2 = rn(2, L, D).to(torch.bfloat16)
    att_enc2 = (enc2.float() @ model.att_encoder.weight.t()).contiguous()
    w2 = torch.softmax(rn(2, L, scale=3.0).masked_fill(pad2, float("-inf")), dim=1)
    s2 = dl.StepState(rn(2, M, scale=1.0), rn(2, H), rn(2, H), rn(2, D), w2, 2.0 * w2,
                      rn(2, H), rn(2, H))
    att2 = (s2.att_h, pk.wq, pk.w_loc, pk.wv, att_enc2, enc2, lengths2, s2.att_w, s2.att_cum)
    got, ref = dl.location_attention(*att2), dl.location_attention_plain(*att2)
    check("location_attention[pad]", list(zip(("context", "weights", "cum_weights"), got, ref)),
          K1_TOL, log, "location_attention")
    mk1, mk2 = dl.prenet_masks(4, 2, P, c.dropout, g, dev)
    mg, al, sk = dl.decode_chunk(pk, enc2, att_enc2, lengths2, s2, mk1, mk2)
    mgp, alp, sp = dl.decode_chunk_plain(pk, enc2, att_enc2, lengths2, s2, mk1, mk2)
    check("decode_chunk[4,pad]", [("mel_gate", mg, mgp), ("weights", al, alp),
                                  ("context", sk.ctx, sp.ctx), ("rnn_h", sk.rnn_h, sp.rnn_h)],
          K1_TOL, log, "decode_chunk")
    if bool((got[1][1, L - PAD:] != 0).any()) or bool((al[:, 1, L - PAD:] != 0).any()):
        raise SmokeFailure("the kernel gave padded chars attention weight")

    # a whole 64-frame chunk through the main-path entry: device time
    # (graph replay) and eager time (the host launches included), per step
    mk1, mk2 = dl.prenet_masks(64, B, P, c.dropout, g, dev)
    chunk = lambda: dl.decode_chunk(pk, encoded, att_enc, lengths, s, mk1, mk2)
    log["decode_chunk_us_per_step"] = {"device": time_ms(chunk, 5, 1) / 64 * 1e3,
                                       "eager": eager_ms(chunk, 5) / 64 * 1e3}
    print(f"  decode_chunk (64 steps) per step: {log['decode_chunk_us_per_step']}")

    # timings at B=1 and the say's char count
    def lstm_lib(cell_mod, x, h, cc):
        cell = torch.nn.LSTMCell(cell_mod.input_size, cell_mod.hidden_size, device=dev,
                                 dtype=torch.bfloat16)
        cell.load_state_dict(cell_mod.state_dict())
        args = (x.to(torch.bfloat16), (h.to(torch.bfloat16), cc.to(torch.bfloat16)))
        return lambda: cell(*args)

    att_cell = lstm_lib(model.decoder.att_rnn, torch.cat([x_p, s.ctx], 1), s.att_h, s.att_c)
    dec_cell = lstm_lib(model.decoder.lstm, torch.cat([ah_p, ctx_p], 1), s.rnn_h, s.rnn_c)
    head_x = torch.cat([rh_p, ctx_p], 1).to(torch.bfloat16)
    head_w = pk.w_out
    head_b = pk.b_out.to(torch.bfloat16)
    lstm_k = lambda: (dl.lstm_cell(pk.w_att, pk.b_att, x_p, s.ctx, s.att_h, s.att_c),
                      dl.lstm_cell(pk.w_dec, pk.b_dec, ah_p, ctx_p, s.rnn_h, s.rnn_c))
    lstm_p = lambda: (dl.lstm_cell_plain(pk.w_att, pk.b_att, x_p, s.ctx, s.att_h, s.att_c),
                      dl.lstm_cell_plain(pk.w_dec, pk.b_dec, ah_p, ctx_p, s.rnn_h, s.rnn_c))
    f32 = lambda *shape: torch.empty(*shape, device=dev)
    lstm_bytes = (nbytes(pk.w_att, pk.b_att, x_p, s.ctx, s.att_h, s.att_c, f32(B, H), f32(B, H))
                  + nbytes(pk.w_dec, pk.b_dec, ah_p, ctx_p, s.rnn_h, s.rnn_c, f32(B, H), f32(B, H)))
    lstm_flops = 2 * B * (pk.w_att.numel() + pk.w_dec.numel())
    K = pk.w_loc.shape[2]
    att_bytes = nbytes(*att_args, f32(B, D), f32(B, L), f32(B, L))
    att_flops = B * (2 * A * H + L * A * (4 * K + 4) + 2 * L * D + 4 * L)
    rows = []
    for name, kern, plain, lib, nb, fl, replaces in (
        ("prenet", lambda: dl.prenet(s.mel, pk.wp1_t, pk.wp2_t, m1, m2),
         lambda: dl.prenet_plain(s.mel, pk.wp1_t, pk.wp2_t, m1, m2), None,
         nbytes(s.mel, pk.wp1_t, pk.wp2_t, m1, m2, f32(B, P)), 2 * B * (M * P + P * P), 347),
        ("lstm_cell", lstm_k, lstm_p, lambda: (att_cell(), dec_cell()), lstm_bytes,
         lstm_flops, 347),
        ("location_attention", lambda: dl.location_attention(*att_args),
         lambda: dl.location_attention_plain(*att_args), None, att_bytes, att_flops, 196),
        ("heads", lambda: dl.heads(pk.w_out, pk.b_out, rh_p, ctx_p),
         lambda: dl.heads_plain(pk.w_out, pk.b_out, rh_p, ctx_p),
         lambda: torch.nn.functional.linear(head_x, head_w, head_b),
         nbytes(pk.w_out, pk.b_out, rh_p, ctx_p, f32(B, M + 1)), 2 * B * pk.w_out.numel(), 347),
    ):
        b_ms, b_by = bound_ms(nb, fl)
        rows.append({
            "name": name, "route": "cuda", "source": "tacotron2_tpu_torch/csrc/decode_step.cu",
            "replaces": f"tacotron2_tpu/ops/decoder_loop_pallas.py:{replaces}",
            "ms": time_ms(kern), "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
            "eager_ms": eager_ms(kern),
            "library_ms": None if lib is None else time_ms(lib),
            "per": "one decode step, B=1, L=%d" % L,
        })
    return rows


def k2_phase(hifigan, log: dict, frames: int) -> None:
    """Each UNIVERSAL_V1 stage over ``frames`` mel frames, kernels against
    plain."""
    import torch

    from tacotron2_tpu_torch.models import layers
    from tacotron2_tpu_torch.ops import mrf

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    mel = torch.randn(1, frames, hifigan.cfg.num_mels, device="cuda", generator=g)
    x = layers.conv1d(mel, hifigan.conv_pre.weight, hifigan.conv_pre.bias, hifigan.policy,
                      padding=3)
    plain = mrf.plain_stage
    for i, (rbs, ups) in enumerate(hifigan.kernel_weights()):
        x = x.contiguous()
        xu = mrf.conv_transpose_plain(x, ups).contiguous()
        check(f"conv_transpose[{i}]@{frames}", [("out", mrf.conv_transpose(x, ups), xu)],
              K2_TOL, log, "conv_transpose")
        got, ref = mrf.mrf_stage(x, rbs, ups), plain(x, rbs, ups)
        check(f"mrf_stage[{i}]@{frames}", [("out", got, ref)], K2_TOL, log, "mrf_conv")
        if i == 2:  # row 3 of the TPU table: the MRF without its upsample
            check(f"mrf_stage[2,no_ups]@{frames}",
                  [("out", mrf.mrf_stage(xu, rbs), plain(xu, rbs, None))], K2_TOL, log,
                  "mrf_conv")
        x = ref


def k2_timing(hifigan, Tb: int) -> list:
    """Time every K2 call of one vocode of ``Tb`` frames: kernel, plain
    version and the library conv (f32, TF32 off), summed per kernel.

    The bound is that of the function the TPU kernels compute, one whole
    stage: its input read once, its weights, its output written once, and
    its flops. ``conv_transpose`` is given the input, its weights and its
    flops; ``mrf_conv`` the output, the 18 convs' weights and their flops.
    The f32 activations that this one-launch-per-conv design writes and
    reads between convs are the design's cost, reported beside the bound
    as ``traffic_ms`` (those bytes over the HBM rate)."""
    import torch
    import torch.nn.functional as F

    from tacotron2_tpu_torch.models import layers
    from tacotron2_tpu_torch.ops import mrf

    calls = []

    def conv_hook(x, cw, res=None, acc=None, acc_scale=0.0):
        calls.append(("mrf_conv", x, cw, res, acc, acc_scale))
        return mrf.mrf_conv(x, cw, res, acc, acc_scale)

    def convt_hook(x, uw):
        calls.append(("conv_transpose", x, uw))
        return mrf.conv_transpose(x, uw)

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    mel = torch.randn(1, Tb, hifigan.cfg.num_mels, device="cuda", generator=g)
    x = layers.conv1d(mel, hifigan.conv_pre.weight, hifigan.conv_pre.bias, hifigan.policy,
                      padding=3)
    stages = []
    for rbs, ups in hifigan.kernel_weights():
        xin = x.contiguous()
        x = mrf.run_stage(xin, rbs, ups, conv_hook, convt_hook)
        stages.append((xin, x, rbs, ups))
    torch.cuda.synchronize()

    tot = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "eager_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "traffic_ms": 0.0, "calls": 0}
           for n in ("mrf_conv", "conv_transpose")}
    for xin, out, rbs, ups in stages:
        Bn, T, Co = out.shape
        convs = [cw for rb in rbs for pair in rb for cw in pair if cw is not None]
        parts = {
            "conv_transpose": (nbytes(xin, ups.w_phase, ups.b),
                               2 * Bn * T * Co * xin.shape[2] * (ups.w.shape[0] // ups.stride)),
            "mrf_conv": (nbytes(out, *(cw.w for cw in convs), *(cw.b for cw in convs)),
                         sum(2 * Bn * T * cw.w.numel() for cw in convs)),
        }
        for name, (nb, fl) in parts.items():
            t = tot[name]
            t["bound_ms"] += bound_ms(nb, fl)[0]
            t["bytes_ms"] += nb / HBM_BYTES_PER_S * 1e3
            t["ops_ms"] += fl / BF16_FLOPS * 1e3
    for call in calls:
        name, x = call[0], call[1]
        t = tot[name]
        if name == "mrf_conv":
            _, _, cw, res, acc, s = call
            Kt, Co, _ = cw.w.shape
            kern = lambda: mrf.mrf_conv(x, cw, res, acc, s)
            plain = lambda: mrf.mrf_conv_plain(x, cw, res, acc, s)
            xt = x.transpose(1, 2).contiguous()
            wf = cw.w.float().permute(1, 2, 0).contiguous()
            pad = cw.dilation * (Kt - 1) // 2
            lib = lambda: F.conv1d(xt, wf, cw.b, padding=pad, dilation=cw.dilation)
            out_b = x.shape[0] * x.shape[1] * Co * 4 * (1 + (s != 0.0))
            nb = nbytes(x, cw.w, cw.b, res, acc) + out_b
        else:
            _, _, uw = call
            Kt, _, Co = uw.w.shape
            kern = lambda: mrf.conv_transpose(x, uw)
            plain = lambda: mrf.conv_transpose_plain(x, uw)
            xt = x.transpose(1, 2).contiguous()
            wf = uw.w.float().permute(1, 2, 0).contiguous()
            lib = lambda: F.conv_transpose1d(xt, wf, uw.b, stride=uw.stride, padding=uw.padding)
            Tout = (x.shape[1] - 1) * uw.stride - 2 * uw.padding + Kt
            nb = nbytes(x, uw.w, uw.b) + x.shape[0] * Tout * Co * 4
        ms = time_ms(kern, 5, 4)
        traffic_ms = nb / HBM_BYTES_PER_S * 1e3
        t.setdefault("per_call", []).append({"x": list(x.shape), "w": list(call[2].w.shape),
                                             "ms": ms, "traffic_ms": traffic_ms})
        t["ms"] += ms
        t["plain_ms"] += time_ms(plain, 5, 4)
        t["library_ms"] += time_ms(lib, 5, 4)
        t["eager_ms"] += eager_ms(kern, 5)
        t["traffic_ms"] += traffic_ms
        t["calls"] += 1
    rows = []
    # both wrappers replace the on-path stage kernels (u=8 :312, u=2 :378);
    # the MRF without its upsample (:285) runs on mrf_conv alone
    replaces = "tacotron2_tpu/ops/mrf_pallas.py:312,378 (also :285)"
    for name in ("mrf_conv", "conv_transpose"):
        t = tot[name]
        rows.append({
            "name": name, "route": "cuda", "source": "tacotron2_tpu_torch/csrc/mrf.cu",
            "replaces": replaces,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "traffic_ms": t["traffic_ms"],
            "per": f"one vocode of {Tb} frames ({t['calls']} calls)",
            "per_call": t["per_call"],
        })
    return rows


def say_phase(cfg_path: str, log: dict, card: str):
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning
    from tacotron2_tpu_torch.models.layers import F32
    from tacotron2_tpu_torch.ops import decoder_loop, mrf
    from tacotron2_tpu_torch.run.say import (cut_vocode, load_hifigan, load_tacotron,
                                             vocoder_policy)
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    cfg = load_config(cfg_path)
    WORK.mkdir(parents=True, exist_ok=True)
    ckpt = {}
    for tag, bias in (("run", 10.0), ("stop", -10.0)):
        m = random_tacotron(cfg, bias)
        ckpt[tag] = str(WORK / f"tacotron2-{tag}.ckpt")
        torch.save(to_lightning(m.state_dict()), ckpt[tag])
        n_params = sum(p.numel() for p in m.parameters())
    hdir = WORK / "hifigan"
    hdir.mkdir(exist_ok=True)
    (hdir / "config.json").write_text(json.dumps(UNIVERSAL_V1))
    g_path = str(hdir / "g_00000000")
    torch.save({"generator": random_hifigan_state()}, g_path)
    print(f"  tacotron2 params {n_params}, checkpoints in {WORK}")

    def say(tag, max_len, out):
        return cli(["say", "--config", cfg_path, "--checkpoint", ckpt[tag],
                    "--hifi-gan-checkpoint", g_path, "--text", TEXT, "--out", out,
                    "--random-seed", str(SEED), "--max-len-override", str(max_len)])

    wav_path = str(WORK / "say.wav")
    say("run", 256, wav_path)  # warm-up: first cuDNN / allocator use
    decoder_loop.reset_launches()
    mrf.reset_launches()
    res = say("run", 256, wav_path)
    launches = {**decoder_loop.LAUNCHES, **mrf.LAUNCHES}
    print(f"  say 256: {res}")
    print(f"  launches in that run: {launches}")
    if res["n_frames"] != 256:
        raise SmokeFailure(f"forced full decode gave {res['n_frames']} frames, want 256")
    for k, n in launches.items():
        if n == 0:
            raise SmokeFailure(f"kernel {k} was not launched on the say path")
    wav, sr = read_wav(wav_path)
    if len(wav) != res["cut"] * 256 or not np.isfinite(wav).all() or not np.abs(wav).max() > 0:
        raise SmokeFailure(f"bad wav: {len(wav)} samples for cut {res['cut']}")

    stop = say("stop", 5000, str(WORK / "stop.wav"))
    print(f"  say early stop: {stop}")
    if stop["n_frames"] != 1 or stop["samples"] != 256:
        raise SmokeFailure(f"early stop gave {stop['n_frames']} frames, {stop['samples']} samples")

    # kernel decode against the plain decode over 32 frames, dropout off
    dev = torch.device("cuda")
    model = load_tacotron(cfg, ckpt["run"], dev)
    prep = cfg.dataset.preprocessing
    ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
        [normalize_text(TEXT, prep.allowed_chars, prep.end_token, False)])
    ci, cl = torch.as_tensor(ci, device=dev), torch.as_tensor(cl, device=dev)
    fast = model.forward_infer_fast(ci, cl, 32, prenet_dropout=False)
    ref = model.forward_infer(ci, cl, 32, prenet_dropout=False)
    if fast.n_frames != ref.n_frames or not torch.equal(fast.lengths, ref.lengths):
        raise SmokeFailure("kernel decode and plain decode disagree on frames/lengths")
    check("decode_32_frames", [("mels_post", fast.mels_post, ref.mels_post),
                               ("gates", fast.gates, ref.gates),
                               ("alignments", fast.alignments, ref.alignments)], DECODE_TOL, log)

    # the vocoder's policy: the say's bf16 vocode through K2 against the
    # plain f32 vocode (the JAX say's precision) of the same 256-frame decode
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    full = model.forward_infer_fast(ci, cl, 256, generator=gen)
    cut = max(int(full.n_frames) - 1, 1)
    h_bf = load_hifigan(g_path, vocoder_policy(dev), dev)
    h_32 = load_hifigan(g_path, F32, dev)
    pcm_bf = cut_vocode(h_bf, full.mels_post, cut).long()
    pcm_32 = cut_vocode(h_32, full.mels_post, cut, mrf.plain_stage).long()
    if pcm_bf.shape != pcm_32.shape or pcm_bf.numel() != cut * 256:
        raise SmokeFailure(f"vocoder precision check: shapes {pcm_bf.shape}, {pcm_32.shape}")
    lsb = (pcm_bf - pcm_32).abs().float()
    vocoder_precision = {
        "max_lsb": float(lsb.max()), "mean_lsb": float(lsb.mean()),
        "share_over_2_lsb": float((lsb > 2).float().mean()),
        "f32_max_abs": float(pcm_32.abs().max()),
        "f32_rms": float(pcm_32.float().pow(2).mean().sqrt()), "samples": pcm_32.numel(),
    }
    print(f"  vocoder bf16 (K2) vs f32 (plain), PCM16 LSB, random weights: {vocoder_precision}")

    # the parts of forward_infer_fast around the decode loop, eager
    parts_ms = {
        "encode": eager_ms(lambda: model._encode(ci, cl), 5),
        "pack_decoder": eager_ms(lambda: decoder_loop.pack_decoder(
            model.prenet, model.decoder, torch.bfloat16), 5),
        "postnet_256": eager_ms(
            lambda: model.postnet(fast.mels.new_zeros(1, 256, model.cfg.num_mels), model.policy),
            5),
    }
    print(f"  eager ms of the parts around the decode loop: {parts_ms}")
    perf = {
        "parts_ms": parts_ms,
        "decode_us_per_step": res["decode_s"] / res["n_frames"] * 1e6,
        "vocoder_us_per_frame": res["vocode_s"] / res["cut"] * 1e6,
        "say_s": res["say_s"], "audio_s": res["audio_s"], "rtf": res["say_s"] / res["audio_s"],
        "chars": res["chars"], "card": card,
    }
    print(f"  decode {perf['decode_us_per_step']:.1f} us/step, vocoder "
          f"{perf['vocoder_us_per_frame']:.1f} us/frame, say {perf['say_s']:.3f} s for "
          f"{perf['audio_s']:.2f} s of audio (RTF {perf['rtf']:.4f}) on {card}")
    log["say"] = {"run": res, "stop": stop, "perf": perf, "vocoder_precision": vocoder_precision}
    return launches


def main() -> int:
    if not (ROOT / "tacotron2_tpu_torch" / "csrc").is_dir():
        print("FAIL: the tacotron2_tpu_torch package is not beside chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.set_grad_enabled(False)
    log: dict = {}
    t_start = time.perf_counter()
    try:
        card = card_line()
        print(f"[1] card: {card}")
        print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("    TF32 off for matmul and cuDNN: plain versions and library calls run in f32")

        from tacotron2_tpu_torch.config import load_config
        from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
        from tacotron2_tpu_torch.ops import build
        from tacotron2_tpu_torch.run.say import vocoder_policy
        from tacotron2_tpu_torch.text import normalize_text

        t0 = time.perf_counter()
        logs = build.build_all()
        log["build_s"] = time.perf_counter() - t0
        log["ptxas"] = logs
        print(f"[2] built {list(logs)} in {log['build_s']:.1f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    {name}: {line.strip()}")

        cfg_path = str(ROOT / "config" / "vanilla-ljspeech-stop.json")
        cfg = load_config(cfg_path)
        prep = cfg.dataset.preprocessing
        chars = len(normalize_text(TEXT, prep.allowed_chars, prep.end_token, False))
        model = random_tacotron(cfg, 10.0).cuda()
        torch.manual_seed(SEED + 1)
        hifigan = HiFiGAN(HiFiGANConfig.from_dict(UNIVERSAL_V1),
                          vocoder_policy(torch.device("cuda"))).cuda().eval()
        Tb = -(-(255 + hifigan.mel_receptive_field()) // 128) * 128  # the say's bucket
        print(f"[3] kernels against their plain versions (flagship dims, B=1, L={chars})")
        rows = k1_phase(model, chars, log)
        for frames in (64, Tb):  # 64 frames, then the say's own bucket
            k2_phase(hifigan, log, frames)
        rows += k2_timing(hifigan, Tb)
        del model, hifigan

        print("[4] say through the CLI entry (random full-width weights)")
        launches = say_phase(cfg_path, log, card)

        print("[5] kernels")
        for r in rows:
            r["launches"] = launches[r["name"]]
            r["max_abs_err"] = max(c["max_abs_err"] for c in log["checks"]
                                   if c["kernel"] == r["name"])
            lib = "-" if r["library_ms"] is None else "%.1f" % (r["library_ms"] * 1e3)
            traffic = ("" if "traffic_ms" not in r
                       else f"  design traffic {r['traffic_ms'] * 1e3:7.1f} us")
            print(f"  {r['name']:<20} {r['ms'] * 1e3:9.1f} us  "
                  f"plain {r['plain_ms'] * 1e3:9.1f} us  "
                  f"library {lib:>9} us  bound {r['bound_ms'] * 1e3:7.2f} us ({r['bound_by']})"
                  f"{traffic}  eager {r['eager_ms'] * 1e3:9.1f} us  launches {r['launches']}  "
                  f"[{r['per']}] on {card}")
        log["kernels"] = rows
        log["seconds"] = time.perf_counter() - t_start
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(log, indent=1, default=str))
        if not all(math.isfinite(r["ms"]) for r in rows):
            raise SmokeFailure("a timing is not finite")
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
        print(card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
