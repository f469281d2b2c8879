"""The encoder's bf16 BiLSTM recurrence (``tacotron2_tpu_torch/ops/encoder_lstm.py``)
on the CPU, where its wrappers run their plain versions:

- ``BiLSTMRecurrence``'s hand-written backward against autograd through the
  plain forward loop, in f64 (so no bf16 rounding of an operand flips between
  the two sum orders): the cotangents of xp, W_hh and b_hh agree to 1e-10;
- ``layers.bilstm``'s gradients under ``bf16-mixed`` against ``jax.grad`` of
  the JAX encoder's two ``lstm_sequence`` calls (ragged lengths): the
  reference the card's backward kernel is held to;
- the kernels' plans (``forward_plan``, ``backward_plan``), their constants
  mirrored from the source, and the backward product's hi / lo split of the
  f32 cotangents;
- the recurrence against the JAX package's ``lstm_sequence`` scan under the
  bf16 policy lives in tests/test_torch_layers.py (``test_bilstm_packed``,
  ``test_encoder_matches_jax``);
- under bf16 a row's encoding is the same alone and batched when both run
  at the same ``rows`` (``Tacotron2._encode``), as the server's windows do;
- the wrappers refuse tensors that are not on the CPU instead of running
  their plain versions (no launch counted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models import layers as jl
from tacotron2_tpu_torch.models import layers as tl
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.ops import encoder_lstm as el

torch.set_num_threads(1)


def _inputs(B=3, T=7, H=8, seed=0):
    r = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.tensor(r.standard_normal(s) * scale, dtype=torch.float64,
                                           requires_grad=True)
    return t(2, B, T, 4 * H), t(2, 4 * H, H, scale=0.4), t(2, 4 * H, scale=0.3)


def test_recurrence_backward_equals_autograd_of_plain_loop():
    xp, w, b = _inputs()
    hs = el.BiLSTMRecurrence.apply(xp, w, b)
    ref, _, _ = el.bilstm_forward_plain(xp, el._rnd(w), b)
    torch.testing.assert_close(hs, ref, atol=1e-12, rtol=0)
    cot = torch.tensor(np.random.default_rng(1).standard_normal(hs.shape))
    got = torch.autograd.grad(hs, (xp, w, b), cot)
    want = torch.autograd.grad(ref, (xp, w, b), cot)
    for name, a, c in zip(("xp", "w_hh", "b_hh"), got, want):
        torch.testing.assert_close(a, c, atol=1e-10, rtol=0, msg=name)


def test_launch_counts():
    assert el.forward_launches(128) == 1  # one persistent launch walks every step
    assert el.backward_launches(128) == 1  # and one walks them back


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def test_bilstm_gradients_match_jax_bf16():
    """``layers.bilstm`` under ``bf16-mixed`` (its backward: the pull of
    ``bilstm_backward_plain``, the kernel's reference) against ``jax.grad``
    of the JAX encoder's two ``lstm_sequence`` calls under the bf16 policy,
    H=16, C=10, lengths 9, 6, 4, the same cotangent. Readings, relative to
    each gradient's max: x and W_ih 0, b_ih and b_hh <= 1.7e-7, W_hh 2.2e-3 and
    4.1e-3, within one bf16 ulp of the max (4.3e-3 and 7.7e-3): the cast's
    pull rounds the f32 sum over steps once, and the two sum orders put a few
    sums on either side of a rounding boundary.
    Limits: W_hh one bf16 ulp of its max, the rest 1e-6 of their max."""
    r = np.random.default_rng(5)
    B, T, C, H = 3, 9, 10, 16
    lens = np.asarray([9, 6, 4])
    p = {"f": _jax_lstm_params(r, C, H), "b": _jax_lstm_params(r, C, H)}
    x = r.standard_normal((B, T, C)).astype(np.float32)
    cot = r.standard_normal((B, T, 2 * H)).astype(np.float32)
    pol = jl.Policy.from_string("bf16-mixed")

    def loss(p, x):
        out = jnp.concatenate([jl.lstm_sequence(p[k], x, jnp.asarray(lens), reverse=k == "b",
                                                policy=pol) for k in ("f", "b")], axis=-1)
        return jnp.sum(out * cot)

    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    lstm = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True)
    with torch.no_grad():
        for suffix, k in (("", "f"), ("_reverse", "b")):
            for name, jname in (("weight_ih", "w_ih"), ("weight_hh", "w_hh")):
                getattr(lstm, f"{name}_l0{suffix}").copy_(torch.as_tensor(p[k][jname].T.copy()))
            for name, jname in (("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                getattr(lstm, f"{name}_l0{suffix}").copy_(torch.as_tensor(p[k][jname]))
    xt = torch.tensor(x, requires_grad=True)
    out = tl.bilstm(lstm, xt, torch.as_tensor(lens), Policy.from_string("bf16-mixed"))
    (out * torch.as_tensor(cot)).sum().backward()
    pairs = [("x", xt.grad.numpy(), np.asarray(gx))]
    for suffix, k in (("", "f"), ("_reverse", "b")):
        for name, jname, transpose in (("weight_ih", "w_ih", True), ("weight_hh", "w_hh", True),
                                       ("bias_ih", "b_ih", False), ("bias_hh", "b_hh", False)):
            got = getattr(lstm, f"{name}_l0{suffix}").grad.numpy()
            ref = np.asarray(gp[k][jname])
            pairs.append((f"{name}{suffix}", got, ref.T if transpose else ref))
    for name, got, ref in pairs:
        scale = float(np.abs(ref).max())
        tol = _bf16_ulp(scale) if name.startswith("weight_hh") else 1e-6 * scale
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)


def _jax_lstm_params(r, n_in, hidden):
    return {k: (r.standard_normal(s) * 0.3).astype(np.float32) for k, s in (
        ("w_ih", (n_in, 4 * hidden)), ("w_hh", (hidden, 4 * hidden)),
        ("b_ih", (4 * hidden,)), ("b_hh", (4 * hidden,)))}


@pytest.mark.parametrize("H", [128, 256])
def test_backward_product_hi_lo_split(H):
    """The backward kernel's recurrent pull takes the f32 cotangents dg into
    a bf16 tensor-core product as hi = bf16(dg) plus lo = bf16(dg - hi), two
    products into f32 sums, where the plain version multiplies f32 dg by bf16
    W_hh and rounds only the sum to bf16. Computed here in f64 at H = 128 /
    256: hi + lo stays within 2.3e-6 / 2.5e-6 of the f64 product's max (an
    f32 sum: 4.6e-7 / 3.2e-7), and its bf16 rounding differs from the f64
    sum's in 0.37% / 0.16% of the elements (an f32 sum: 0 / 0.02%);
    bf16(dg) alone, a single bf16 product, reads 1.6e-3 / 1.4e-3 and 43%:
    another function. Limits: 1e-5 and 1%; bf16(dg) alone above 10%."""
    g = torch.Generator().manual_seed(H)
    W = (torch.randn(4 * H, H, generator=g) * 0.06).to(torch.bfloat16).double()
    dg = torch.randn(32, 4 * H, generator=g)
    hi = dg.to(torch.bfloat16)
    lo = (dg - hi.float()).to(torch.bfloat16)
    ref = dg.double() @ W
    split = hi.double() @ W + lo.double() @ W
    alone = hi.double() @ W
    rnd = lambda t: t.to(torch.bfloat16)
    scale = ref.abs().max()
    assert (split - ref).abs().max() / scale < 1e-5
    assert (rnd(split) != rnd(ref)).double().mean() < 0.01
    assert (rnd(alone) != rnd(ref)).double().mean() > 0.10


@pytest.mark.parametrize("B,H,ok", [(1, 256, True), (37, 256, True), (64, 256, True),
                                    (64, 128, True), (64, 64, False), (64, 384, False),
                                    (64, 512, False), (64, 320, False), (0, 256, False)])
def test_backward_plan_refuses_what_the_kernel_cannot_take(B, H, ok):
    """``backward_plan`` takes its template instances' widths, H = 128 and
    256 (whole m16 tiles of units a rank; a warp's W fragments, H / 4
    registers a thread); a further 8-row tile is a cluster of its own, and a
    block's memory follows H alone (86,816 bytes at H = 256: two blocks fit
    an SM)."""
    if ok:
        plan = el.backward_plan(B, H)
        assert 2 * plan["smem"] <= el.ENC_SMEM and plan["a_regs"] == H // 4
        assert plan["clusters"] == 2 * -(-B // el.ENC_TILE)
        assert plan["warps"] == (H // el.ENC_CLUSTER // 16) * el.ENC_BWD_KSPLIT
        assert plan["smem"] == el.backward_plan(1, H)["smem"] == {128: 43808, 256: 86816}[H]
    else:
        with pytest.raises(ValueError):
            el.backward_plan(B, H)


@pytest.mark.parametrize("H", [64, 128, 256, 320])
def test_forward_units_cover_w_hh_once(H):
    """The forward's cluster ranks hold every row of a direction's W_hh
    once: rank r the four gates of its units [r EU, (r + 1) EU), ordered so
    that m16 tile rows i and i + 8 are two gates of one unit and the lane 16
    away holds the other two."""
    EU = H // el.ENC_CLUSTER
    rows = [el.unit_rows(H, r) for r in range(el.ENC_CLUSTER)]
    assert sorted(x for rr in rows for x in rr) == list(range(4 * H))
    for r, rr in enumerate(rows):
        assert {x % H for x in rr} == set(range(r * EU, (r + 1) * EU))
        for base in range(0, 4 * EU, 16):
            tile = rr[base:base + 16]
            for i in range(8):  # rows g, g + 8: gates g // 4 and 2 + g // 4 of one unit
                assert tile[i] % H == tile[i + 8] % H == tile[i ^ 4] % H
                assert {tile[i] // H, tile[i + 8] // H, tile[i ^ 4] // H,
                        tile[(i ^ 4) + 8] // H} == {0, 1, 2, 3}


@pytest.mark.parametrize("B,H,ok", [(1, 256, True), (64, 256, True), (200, 256, True),
                                    (64, 384, True), (64, 448, False), (64, 512, False),
                                    (64, 100, False), (64, 96, False), (0, 256, False)])
def test_forward_plan_refuses_what_the_kernel_cannot_take(B, H, ok):
    """``forward_plan`` takes H in whole 16-byte pieces of h a rank (H a
    multiple of 64), at most ENC_MAX_WARPS warps a block and a block within
    227 KB of shared memory (H = 448 needs 234 KB: W's 224 rows alone take
    204 KB); past a tile's rows a further tile is a cluster of its own, so
    the block's memory stops growing."""
    if ok:
        plan = el.forward_plan(B, H)
        assert plan["smem"] <= el.ENC_SMEM and plan["rows"] <= el.ENC_TILE
        assert plan["clusters"] == 2 * -(-B // el.ENC_TILE)
        assert plan["warps"] * 16 == 4 * H // el.ENC_CLUSTER
    else:
        with pytest.raises(ValueError):
            el.forward_plan(B, H)


def test_forward_constants_mirror_the_kernel():
    import re
    from pathlib import Path

    src = (Path(el.__file__).parents[1] / "csrc" / "encoder_lstm.cu").read_text()
    for name, value in (("ES", el.ENC_CLUSTER), ("ETILE", el.ENC_TILE),
                        ("EMAXWARPS", el.ENC_MAX_WARPS), ("BKS", el.ENC_BWD_KSPLIT)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value
    widths = re.search(r"\(H != (\d+) && H != (\d+)\)", src).groups()
    assert tuple(sorted(int(w) for w in widths)) == el.ENC_BWD_H


def test_eval_encoder_row_alone_equals_batched():
    """Under bf16 (the served configs' policy) a row's encoding and its
    attention projection are bitwise the same alone and batched when both
    run at the same ``rows``, as the server's windows do. (Under f32 the
    packed LSTM groups rows by length, so there the products' shapes follow
    the batch's lengths.)"""
    torch.manual_seed(0)
    model = Tacotron2(Tacotron2Config(num_chars=20, encoded_dim=32, encoder_kernel_size=5,
                                      num_mels=8, prenet_dim=16, att_rnn_dim=32, att_dim=16,
                                      rnn_hidden_dim=32, postnet_dim=8),
                      Policy.from_string("bf16-mixed")).eval()
    r = np.random.default_rng(2)
    lens = torch.tensor([9, 5, 7, 3, 9])
    chars = torch.tensor(r.integers(1, 21, size=(5, 9)))
    chars[torch.arange(9)[None, :] >= lens[:, None]] = 0
    with torch.no_grad():
        enc, att, mask = model._encode(chars, lens, rows=8)
        assert enc.shape == (5, 9, 32) and att.shape == (5, 9, 16) and mask.shape == (5, 9)
        for i in range(5):
            e1, a1, _ = model._encode(chars[i:i + 1], lens[i:i + 1], rows=8)
            assert torch.equal(e1[0], enc[i]) and torch.equal(a1[0], att[i]), i


def _meta(*s, dtype=torch.float32):
    return torch.empty(*s, device="meta", dtype=dtype)


@pytest.mark.parametrize("name,call", [
    ("bilstm_forward", lambda: el.bilstm_forward(_meta(2, 1, 3, 32),
                                                 _meta(2, 32, 8, dtype=torch.bfloat16),
                                                 _meta(2, 32))),
    ("bilstm_backward", lambda: el.bilstm_backward(_meta(2, 1, 3, 8), _meta(2, 1, 3, 32),
                                                   _meta(2, 1, 3, 8),
                                                   _meta(2, 32, 8, dtype=torch.bfloat16))),
])
def test_wrapper_never_falls_back_to_plain(name, call, monkeypatch):
    def plain_called(*a, **k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    monkeypatch.setattr(el, f"{name}_plain", plain_called)
    before = dict(el.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert el.LAUNCHES == before
