#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tacotron2_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-ab   # only K2's design A/B (``k2_ab``), then exit
    python3 chip_smoke.py --k2-f32  # the kernels' build, the plain f32 version and K2's
                                    # f32 mode against f64 sums over K2F_DRAWS weight
                                    # draws (``k2_f32_reference``, what K2F_TOL rests
                                    # on), then phase 3f alone
    python3 chip_smoke.py --k1-rows [--root DIR] [--out NAME]  # K1/K5 at 1/16/64 rows
    python3 chip_smoke.py --k1-rows --enc-ab  # only the encoder: the forward's copies and
                                              # the backward against build/parent's (``enc_ab``)
    python3 chip_smoke.py --k1-ab   # the same for build/parent and this tree, in turns,
                                    # and the decode step's variants on source copies
                                    # (``cell_ab``)
    python3 chip_smoke.py --k34-ab  # the vanilla K3/K4 of build/parent and this tree in
                                    # turns, bit for bit, and the controls mode's times
    python3 chip_smoke.py --k2-f32-ab  # K2's f32 mode of build/parent and this tree in
                                       # turns at 1 / 16 / 64 rows, beside cuDNN f32
    python3 chip_smoke.py --k1-f32-rows [--cell-ab] [--root DIR] [--out NAME]  # K1's f32
                                       # cells, heads and chunk at 1/16/64 rows (and the
                                       # design copies of ``k1f_cell_ab``)
    python3 chip_smoke.py --k1-f32-ab  # K1's f32 cells and heads and the 64-step f32
                                       # chunk of build/parent and this tree in turns at
                                       # 1 / 16 / 64 rows, beside nn.LSTMCell x2 and
                                       # F.linear in f32 (``k1_f32_ab``), and the f32
                                       # cell's design copies (``k1f_cell_ab``)
    python3 chip_smoke.py --eval    # the kernels' build and phase 4f alone
    python3 chip_smoke.py --train-extras  # the kernels' build and phase 4g alone
    python3 chip_smoke.py --descriptions  # the kernels' build and phase 4h alone
    python3 chip_smoke.py --gst     # the kernels' build and phase 4i alone
    python3 chip_smoke.py --dp      # the kernels' build and phase 4j alone
    python3 chip_smoke.py --mesh    # the kernels' build and phase 4k alone
    python3 chip_smoke.py --v2v3    # the kernels' build and phase 4l alone
    python3 chip_smoke.py --f32-decode  # the kernels' build and phase 4m alone
    python3 chip_smoke.py --vocoder-shapes  # the kernels' build and phase 4n alone
    python3 chip_smoke.py --k2-shapes-ab  # K2's wide kernels (V2's wide entries too),
                                          # c2_wide's tensor-core convs and c2_deep's convs
                                          # below 8 channels of build/parent and this tree
                                          # in turns, bit for bit, and the C2 generators'
                                          # and V2's narrow rows timed in those turns
    python3 chip_smoke.py --narrow-design  # the narrow kernel's small route against
                                           # copies with a part taken out or a constant
                                           # changed, and against narrow_mma_kernel
                                           # (SMALL_DESIGN), in turns
    python3 chip_smoke.py --f32-step    # 4m's train part alone, its step against the
                                        # CPU's over K1F_STEP_DRAWS draws, with the packed
                                        # encoder, with TF32 on, the CPU on its own ReLU
                                        # branches and with one flipped (``f32_step_mode``)

Phases, each of which must pass:

1. print the card (``nvidia-smi``), torch and CUDA versions; TF32 off
   (``layers.use_f32_math``, as the say and train entries set it);
2. build every CUDA kernel from ``tacotron2_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print each kernel's registers, static shared
   memory and spills (``-Xptxas -v``);
3. hold each kernel against its plain PyTorch version on the card at the
   slice's full-width shapes (K1: one decode step at the flagship dims, its
   cluster attention also at the serve windows' 16 and 64 rows of 128
   chars with the cluster size S printed per shape, then whole 4-step
   chunks on K1_DRAWS weight draws, with the readings of defective kernels
   held above the limit; K2: the four UNIVERSAL_V1 MRF stages and stage 2
   without its upsample, at 64 mel frames and at the say's vocode bucket,
   ``conv_pre`` on ``mrf_conv``'s kernel (each element within one bf16 ulp
   of its plain version, a row alone bit for bit against the same row in a
   batch of ``K2_INVARIANCE_ROWS``), ``conv_transpose`` (the folded 3-tap conv)
   and its bf16 operand, each stage's first ``mrf_conv`` or fused
   ``mrf_pair`` alone, the upsample and the first conv bit for bit against
   the same row in a batch of ``K2_INVARIANCE_ROWS``, a fused pair against
   its two ``mrf_conv`` launches, and the stage mean's operand exactly
   ``operand`` of the f32 mean), and time kernel, plain version and
   library call (K2: ``F.conv1d`` / ``F.conv_transpose1d`` in f32 and in
   bf16); ``conv_transpose`` per stage, the vocode, the prenet (against its
   plain version) and the heads at 1, 16 and 64 rows (``up_rows``);
   K5, the int8 LSTM cell: one int8 step through the chunk entry at B=1 and
   at B=2 with a padded row, with defective kernels (activations rounded to
   bf16 before quantising, scales taken from bf16 weights) held above the
   limit, then the 4-step int8 chunk on K1_DRAWS weight draws; K2's
   ``mrf_conv`` also timed at the serve windows' 16 and 64 rows; both
   LSTM cells (K1's ``lstm_cell``, K5's ``quantize_xh`` + ``lstm_cell_int8``)
   at 1, 16 and 64 rows against their plain versions, timed beside their
   bound and library call (``cell_rows``),
   rows of a 64-row cell launch held bit for bit against the rows alone
   and of a 64-row prenet launch, the heads' rows of a 64-row launch and
   the last of an 80-row one (``cell_invariance``), and a
   64-frame chunk split by kernel at 16 and 64 rows, L=128, with the serve
   window's decode (``serve_rows_split``);
3f. K2's f32 mode (``csrc/mrf_f32.cu``, the commands' vocoder: F32, as the
   JAX package's ``load_hifigan``; a three-pass TF32 split on ``wgmma``):
   ``k2_f32_phase`` on an F32 UNIVERSAL_V1
   generator at 1, 16 and 64 rows of the say's 384-frame bucket: every f32
   entry (``conv_pre``, both upsample kinds, ``mrf_conv``, ``mrf_pair``)
   and each stage against its plain f32 version from the plain stage's
   input (K2F_TOL of the output's max), each fused pair against its two
   launches and rows 0, 1, 37, 63 of a 64-row vocode against each row
   alone bit for bit (K2's outputs and ``HiFiGAN.apply``'s), the planted
   defects (TF32- and bf16-rounded operands; copies of the kernel with the
   lo passes and with the a_lo pass left out, ``K2F_PASS_DEFECTS``) at
   least K2F_DEFECT_MARGIN x the limit, and every entry timed beside
   cuDNN's f32 convs and its bound (three TF32 passes; the CUDA cores' FP32
   rate beside it);
3c. K1's and K5's controls mode on random full-width weights of
   ``config/controllable-lj-hifi-stop-speaker.json`` (``controls_phase``):
   1- and 4-step chunks at 1, 16 and 64 rows with distinct controls per row
   against the plain chunk, the defects' readings (the controls left out,
   K5's row scale without them) held above the limits; the controls reach
   the mels (two vectors through a chunk and through the heads) and not
   the gate (bit for bit); the decoder cell and the heads with controls at
   1, 16 and 64 rows against their plain versions, timed beside bound and
   library call, their rows 0, 1, 37, 63 of a 64-row launch with distinct
   controls against the rows alone, bit for bit; the one-row 64-step chunk
   of the vanilla and the controllable model in turns;
3b. the same for K3 and K4, training's teacher-forced decode forward and
   backward (B=32, L=160 with padded rows, T=128), with every gradient
   ``TeacherDecode`` returns (K4 on the plain forward's residuals and on
   K3's own), then at the ragged shapes of the attention's cluster split
   (``K34_RAGGED``), with and without programmatic dependent launch, and
   each kernel's device time (torch.profiler); then the encoder's bf16
   BiLSTM kernels at the train batch's shapes, and the forward at the say's
   and the serve windows' shapes on inputs from real ``_encode`` calls and
   at ``enc_shapes`` (timed beside ``nn.LSTM``, rows of a 64-row launch
   against the rows alone, bit for bit, ``enc_rows``), the backward at
   ``enc_shapes`` too (timed beside ``nn.LSTM``'s backward, rows of a
   64-row launch bit for bit, ``enc_bwd_rows``);
3e. deliberate defects on source copies (``defect_phase``): the heads with
   one rank's partial sum left out, the encoder's forward and backward with
   a stale exchange, each at least DEFECT_MARGIN times its limit;
3d. K3's and K4's controls mode on random full-width weights of the
   controllable config (``k34_controls_phase``): at B=64 (its train batch,
   cluster size 2), B=32 and B=5 with L=37 against their plain versions,
   the controls' gradient included (K3_TOL_TRAIN, K4_TOL, GRAD_TOL); the
   defects (the controls left out of K3's xh2; K4 reading d_rnn_h at H + D,
   a copy of the source built under build/k34_defect) at least
   DEFECT_MARGIN times their limits; the controls mode and the vanilla
   timed in turns;
4. run ``say`` through the port's CLI entry on random full-width weights
   saved as a reference Lightning ``.ckpt`` and a UNIVERSAL_V1 ``g_*`` file:
   a forced 256-frame decode with the launch counters read around it (one
   ``bilstm_forward`` launch; K2 in its f32 mode, the commands' vocoder:
   exactly 18 ``mrf_conv_f32``, 27 ``mrf_pair_f32``, 4 ``conv_transpose_f32``
   and 1 ``conv_pre_f32`` launches a vocode, none of the bf16 mode, and the
   HiFi-GAN's weights packed once; every later path's vocodes are held to
   the same f32 plan), the say's vocode against the plain f32 vocode
   (VOCODE_F32_LSB), a bf16 generator's vocode of the same mel (K2's bf16
   mode, its launches the kernels line's bf16 rows' count) reported in
   PCM16 LSB against it, a
   forced early stop (1 frame), and the kernel decode against the plain
   decode over 32 frames; then ``say --quantize-int8`` the same way (K5's
   launches held to 2 x 256 of each of its two kernels), and the int8 decode
   against the bf16 one;
4b. run ``train`` through the CLI entry at the vanilla full width on 64
   synthetic WAVs: batch 32, 6 steps, then a resume to step 8, with K3 and
   K4's launch counters read around it and held to launches per step x T
   (``bilstm_backward``: one a step; so in 4e);
   the losses must be finite and fall; the trained checkpoint goes through
   ``say``; K3 and K4 are held against their plain versions at the train
   batch's shapes (B=32, L=128, T=384), split by kernel; one train step is
   split into its parts, the encoder also as it ran before the bf16 repair
   (cuDNN's f32 BiLSTM), as in the say phase;
4c. run the warm server in this process through ``do_server`` with a bf16
   and an int8 entry of the random weights: waves of 16 and of 64 concurrent
   requests per model, which must coalesce, with the launch
   counters held to two LSTM launches a frame per decode launch (and two
   ``quantize_xh`` in the int8 entry's); two
   batched requests again alone (PCM16 difference); K2's f32 launches 18,
   27, 4 and 1 a window and no weight packing in the waves; one request
   through Griffin-Lim; the kernels against their plain versions at the
   windows' shapes (K1 at 16 and 64 rows and K5 at 16, L=128; K2 through
   the batched vocode at 16 and 64 rows, ``serve_k2_check``: its f32 mode
   on the served generator to K2F_TOL, its bf16 mode on a bf16 copy of it
   to K2_TOL); then
   ``python -m tacotron2_tpu_torch server`` as a process of its own
   (/config, one /generate, exit 0 on SIGTERM);
4d. the controllable, multi-speaker path: ``say --speaker-id 2 --controls
   ...`` (bf16 and ``--quantize-int8``) through the CLI entry on random
   full-width weights of the controllable config, 256 frames, the launch
   counters held to 5 (7) launches a step with the decoder cell and the
   heads reading the controls at every step; the kernel decode against the
   plain decode over 32 frames with those controls; then the warm server
   with a bf16 and an int8 entry of it, a wave of 16 requests each with
   mixed voices and controls (coalescing, the controls' launches counted),
   three of each alone equal to their batched audio (0 LSB);
4e. ``train`` of the controllable config through the CLI entry at full
   width and batch 64 (``train_controls_phase``): 128 synthetic WAVs of
   speakers 0-3 with five feature columns, 6 steps and a resume to 8, every
   K3 / K4 launch one of the controls mode, the losses falling, the speaker
   embedding's rows moved; ``say --speaker-id 2 --controls ...`` of its
   checkpoint; K3 / K4 at its first batch's shapes and the step's split;
4f. from raw corpora to test-set audio (``eval_phase``): synthetic LJSpeech
   (96 WAVs of 1.0-10.1 s) and Hi-Fi TTS (3 speakers, FLAC at 44.1 kHz)
   layouts through ``preprocess`` (8 workers) and the ljspeech / hifi /
   lj-hifi splits, the row counts and columns held; ``test`` of the vanilla
   config on the LJ test split (8 rows) and of the controllable config on
   the lj-hifi one (32 rows), the gate's bias chosen from a probe run so
   rows stop at predicted frames and some fail, K1 held to 5 launches a
   step (the controls read at each in the controllable run), K2 to one
   vocode a batch, each WAV bit for bit its row vocoded alone,
   ``failures.csv`` exactly the rows stopping at frame 0 or never;
   ``train_mel_export`` of both (the vanilla first batch at B=64, L=192,
   T=896): K3 alone, ``2 + 3T`` launches a batch, no K4, the first batch's
   K3 against its plain version and timed, the .npy files equal to the
   in-process forward's and to a second export's; ``say --export-mel``;
4g. the rest of ``train`` and the prosody-model configs (``train_extras_phase``),
   each through the CLI entry: ``train --finetune`` from 4b's checkpoint at
   B=64 (4 steps) with ``TACOTRON2_TRACE_DIR`` set and the driver's save and
   histogram intervals at 2: the encoder bit for bit, every other parameter
   moved, lr / 10 logged, K3 / K4 launches per step x T, ``bilstm_backward``
   once a step, ``last.ckpt`` (``AsyncSaver``) equal to ``finetuned.ckpt``,
   the event file read back with its CRCs (the scalars, 4 images a
   validation, the histograms at their steps) and the trace naming every
   counted wrapper's kernels; K3 / K4 at that batch's shapes; the same
   finetune untraced for 8 steps (the steps after a validation and after a
   background save against the steady ones); 4e's checkpoint finetuned at
   B=128 (the speaker embedding frozen too, every launch of the controls
   mode), K3 / K4 at its shapes, the encoder's recurrence at 128 rows
   against its plain version with rows 0, 1, 37, 127 bit for bit alone;
   ``train_prosody`` on 4f's lj-hifi manifests (finite losses, the CCC
   scalars); ``train`` of ``STYLE_CONFIG`` at batch 32 with that predictor
   (``style_loss`` from step 3 on, the predictor unchanged, controls-mode
   launches) and a ``say`` of its checkpoint; the step times of each;
4h. description-conditioned speech (``descriptions_phase``, ``DESC_CONFIG``:
   562 voices, a 768-wide description, the memory D = 640), each through the
   CLI: a random BERT of bert-base's shapes from the seed, saved as a
   ``bert.``-prefixed state dict and as an HF directory with the smoke's own
   ``model.safetensors``, over a synthetic 30,522-line vocabulary;
   ``embed_descriptions`` (2 augmentations) of a synthetic 24 kHz
   LibriTTS-like corpus (8 voices, 144 rows of 150-250 chars, some blank)
   on the card, every file within DESC_TOL of the same on the CPU, the two
   layouts the same bits; ``train`` (pretraining: the batches' descriptions
   blank) at B=64 and ``train --finetune`` at B=128 (the augmented ids'
   rows, every description row a file on disk, some augmentations; the
   encoder and the speaker embedding bit for bit, the rest moved), K3 / K4
   at D = 640 against their plain versions at both batches' shapes (K4's
   attention cluster doubled where L > 216 at B = 128 needs it,
   ``train_decode.attention_cluster``, its shared memory mirror held against
   the library's), launches per step x T; ``say --speaker-id --description
   --bert-checkpoint`` bf16 and int8 (256 frames, 5 / 7 launches a step, one
   vocode), K1 / K5 at D = 640 against their plain versions, the kernel
   decode against the plain one, a description's mels apart from a blank
   one's, the chunk per step beside the vanilla D = 512's; ``test_correlation``
   of 4e's checkpoint (2 rows of each of its 4 voices, the gate's row as
   trained or negated and its bias from ``kept_gate_bias`` on probes of
   every override, each row stopping where they predict): a directory per
   override, K1 5 launches a step
   reading the controls, K2 one vocode a batch, ``correlations.csv`` by
   JAX's rules;
4i. Global Style Tokens (``gst_phase``);
4j. data-parallel train (``dp_phase``): (a) ``DP_RANKS`` gloo ranks sharing
   the card, each on its rows of the vanilla config's B=32 and the
   controllable config's B=64, then one process at the full batch, each
   step from rank 0's state before it, in a one-rank group and without a
   group, held to ``DP_TOL`` (the gradients as one vector and each tensor's
   gradient and update), the ranks' weights the same bits, each rank's K3 /
   K4 launches ``2 + 3T`` / ``4 + 4T`` a step, and a planted defect (the
   BatchNorm sums' gradients left local) read above ``DP_TOL``; (b)
   ``train`` as one NCCL rank under torchrun's environment against no
   process group; (c) the prefetcher's staged batches against
   ``DirectStream``'s bit for bit, and ``train`` with it off (the default)
   and on, the
   same losses bit for bit, their step and batch-wait times; K3
   / K4 at the ranks' 16 and 32 rows against their plain versions;
4k. the last modules (``mesh_phase``): (a) the warm server with ``mesh:
   {"data": 2}`` on two shards of the one card (``MESH_SHARDS``) beside a
   meshless one, a bf16 and an int8 wave of ``MESH_WAVE``, each shard's K1
   / K5 and K2 launches (two cell launches a step, one vocode a decode),
   every request against the meshless server's same request alone
   (``MESH_LSB``), each window's ms, and the mesh without the explicit list
   refused on one card; (b) tensor-parallel train, a ``TP_GRID`` grid of
   gloo ranks sharing the card at 4b's B=32 (no K3 / K4: the decode
   column-parallel on stock ops), each step against one process's K3 / K4
   step from the same state (``DP_TOL`` in a one-rank group), the
   replicated weights bit for bit in each model group; (c) the device mel
   backend against the numpy one on a 10 s clip (``MEL_TOL``), timed;
4l. HiFi-GAN V2 and V3 (``v2v3_phase``: jik876/hifi-gan's config_v2 and
   config_v3 at their published widths, random weights as ``g_*`` files):
   V2's stages 3 and 4 and its last upsample run the narrow kernel
   (``csrc/mrf_narrow.cu``, C = 16 and 8), V3 ResBlock2 on the wide ones
   (dilations to 12, the u = 4 fold). Every entry and stage against its
   plain version at 1, 16 and 64 rows of the say's bucket, f32 within
   K2F_TOL and bf16 within K2_TOL, fused pairs against their two launches;
   the narrow kernel's planted defects (a copy of its source leaving each
   channel's last tap out, TF32-rounded operands) at least
   K2F_DEFECT_MARGIN x the limits; rows 0, 1, 37, 63 of a 64-row vocode
   against the rows alone, bit for bit; ``say --hifi-gan-checkpoint`` with
   each file through the CLI, K2 held to ``vocode_launches`` of its config
   (f32, no bf16 entry), the WAV within VOCODE_F32_LSB of the plain f32
   vocode of the exported mel, its RTF; the warm server with the V2
   vocoder, a wave of 16 requests, each alone at 0 LSB; every entry timed
   at 1, 16 and 64 rows beside cuDNN f32 and bf16 and the bound; the
   kernels line gains the narrow rows and, on the wide rows, "v2" / "v3";
4m. K1's f32 mode and the F32 teacher-forced route (``f32_decode_phase``,
   a ``"32-true"`` copy of the flagship config, random weights): every f32
   entry (``lstm_cell_f32``, ``prenet_f32``, ``location_attention_f32``,
   ``heads_f32``, the ``_act_bf16`` prenet and heads of the int8 mode of an
   F32 model) against its plain f32 version at 1, 16 and 64 rows within
   K1F_TOL of each output's max, the controllable config's decoder cell and
   heads with controls; the planted defects (copies of
   ``csrc/decode_step.cu``: bf16-rounded cell operands, the cell's and the
   heads' products as one TF32 pass, a location tap left out) at least
   K1F_DEFECT_MARGIN x the limit; the
   int8 mode's prenet rows on a bf16 rounding boundary held to one of their
   roundings, its weights rounded to bf16 (a defect) failing that; rows 0,
   1, 37, 63 of 64 bit for bit alone; the 64-step f32 chunk (K1F_CHUNK_TOL)
   and the 4-step int8 chunk of the F32 model (K5_CHUNK_TOL) at 5 / 7
   launches a step; ``say`` and ``say --quantize-int8`` through the CLI (5 /
   7 launches a frame, the WAV within VOCODE_F32_LSB of the plain vocode,
   the f32 mels within K1F_CHUNK_TOL of the plain decode from the same
   seed); rows of a window against alone, stage by stage, then a served
   wave of 16, each request 0 LSB from alone; ``train`` 3 steps and ``train
   --finetune`` with no K3 / K4 launch, one step's loss and gradients
   against the CPU's, the CPU on the card's ReLU branches (K1F_STEP_TOL, a
   bf16-operand defect above both limits; an element on another branch
   within K1F_FLIP_REL of zero, bf16 prenet weights above it); each
   entry timed beside its bound, plain version and library call;
4n. K2 at every shape JAX's stage kernel takes (``vocoder_shapes_phase``,
   the C2 generators at random weights: ``c2_wide`` (widths 200 to 25,
   conv_pre from 100 mels), ``c2_deep`` (C = 4, 2, 1), ``c2_u5`` (an
   upsample that does not fold) and ``c2_even`` (even resblock kernels), in
   f32 and bf16): every entry and stage against its plain version at 1 and
   16 rows of a 128-frame bucket, rows 0, 1, 15 of a 16-row vocode bit for
   bit alone, the even-k generator's stock route against the CPU, the
   narrow kernel's planted defects (a partial last n8 tile's last channel
   left out, the k tile's pad channels staged from past Ci, f32's products
   as one TF32 pass) at least K2F_DEFECT_MARGIN x the limits, each
   generator's vocode through ``cut_vocode`` with exact launch
   counts per route (``vocode_launches``, ``vocode_routes``); the C3 model
   (the flagship's widths with rnn_hidden_dim 768): ``say`` with no K1
   launch, a ``train_mel_export`` batch against the CPU's, ``train`` and
   ``--quantize-int8`` refused; the narrow entries timed beside cuDNN and the
   bound; rows ``narrow_*[c2_wide]`` / ``narrow_*[c2_deep]``;
5. print the kernels line and, last, the ``{"ok": true, ...}`` line.

It exits non-zero before the last line on any failure, when no CUDA device
is visible, or when the port's package is not beside this file. Details go
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
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

TEXT = ("The quick brown fox jumps over the lazy dog, while the port speaks "
        "its first words on the card.")
SEED = 7
K1_TOL = 1e-4  # max |kernel - plain| / max(1, max |plain|), one step, bf16 operands
# the same for a 4-step chunk: the state feeds back through bf16 operands,
# so a one-ulp rounding flip of one entry propagates; set between the
# largest reading over K1_DRAWS weight draws and the readings of defective
# kernels (a wrong step's masks, a row length off by one) (PERF.md)
K1_CHUNK_TOL = 1e-3
K1_DRAWS = 4  # weight draws of the 4-step chunk check
K2_TOL = 5e-3  # the same for one MRF stage (18 convs)
K2_INVARIANCE_ROWS = 64  # a K2 row alone against the same row in a batch of this many
# 32 autoregressive frames, kernel decode vs plain decode, per output; the
# alignments' limit is absolute (max |ref| <= 1), 1% of a weight at L ~ 100
DECODE_TOL = {"mels_post": 1e-3, "gates": 1e-4, "alignments": 1e-4}
PAD = 29  # chars of padding in the padded row of the B=2 attention check
# K3 over 128 teacher-forced steps against its plain version, relative to
# max(1, max |ref|): the state feeds back through bf16 operands, so one-ulp
# rounding flips (2^-8 relative) of xh1/xh2 entries propagate; about 10x
# the largest error measured (PERF.md), the bf16 stacks to two ulps
K3_TOL = {"mel_gate": 2e-3, "c_att": 2e-3, "c_rnn": 2e-3, "al": 2e-4, "cum": 5e-4,
          "xh1": 1e-2, "xh2": 1e-2}
# K4's stacks and TeacherDecode's gradients against the plain versions on
# the same residuals (the backward's sums in f64, ``teacher_backward_ref``),
# relative to each tensor's own max: the bf16 dg and head_h stacks to two
# ulps (2^-6), the f32 ones about 10x the error measured (PERF.md); d_ctrl,
# the controls' cotangent summed over the steps (the controls mode), reads
# <= 1.4e-4 at B=64 / 32 / 5 (PERF.md). dq, the query's cotangent, is a sum
# over the chars of the softmax's pull, whose terms cancel: at T=384 on
# trained weights one-ulp flips of the bf16 operands, carried back over the
# steps, move it by up to 5.9e-3 of its max in the kernel and 4.1e-3 in the
# plain version's own f32 sums (``--k4-ref``, PERF.md), so its limit is
# dxh1's; its first pulled steps read ~1e-4 in both, and the gradient made
# from it (the query layer's weight) ~3e-4 of GRAD_TOL's 1e-2
K4_TOL = {"dg1": 1.6e-2, "dg2": 1.6e-2, "head_h": 1.6e-2, "dxh1": 1e-2, "dctx": 2e-3,
          "dq": 1e-2, "d_attenc": 5e-3, "d_wv": 5e-3, "d_wloc": 5e-3, "d_ctrl": 2e-3}
GRAD_TOL = 1e-2
# K5, the int8 cell: integer sums are exact, so one step of the kernel equals
# the plain version's up to the float epilogue and the sigmoid / tanh
# (readings <= 9e-8); the defective kernels read >= 2.6e-3 at one step. Over
# 4 steps the state feeds back through the bf16 kernels too, where K1 has
# read a rounding flip of 1.1-1.2e-4; the defects read 1.1e-3 there (PERF.md)
K5_TOL = 1e-5
K5_CHUNK_TOL = 5e-4
# K5's operand (quantize_xh) against quantize_rows: the same true division
# and rounding, so the int8 values and the row scales are equal
QUANT_TOL = 0.0
# int8 against bf16 decode of one seed over 256 frames: the JAX package's
# budget for int8 against f32 (readings 0.21% and 1.2e-4, PERF.md)
INT8_DIVERGENCE = {"mels_post_mean_rel": 0.01, "gate_drift": 0.05}
# a served request batched against alone, PCM16 LSB: reads 0 (the kernels'
# rows are independent); one LSB allows a rounding of the f32 -> int16 cast
SERVE_INVARIANCE_LSB = 1
# the say's vocode through K2's f32 mode against the plain f32 vocode, PCM16
# LSB: the two sum in other orders (~1e-6 of a stage's output), so a sample
# near a rounding boundary of the int16 cast may land one LSB apart
VOCODE_F32_LSB = 1
# K3 at the main path's shapes (the train batch: B=32, L=128, T=384) on the
# trained weights: its errors grow over the steps; 12-17x the errors
# measured at T=384, the bf16 stacks to two ulps (PERF.md). There K4's f32
# stacks and the gradients read 14-60x below K4_TOL and GRAD_TOL and its
# bf16 stacks one ulp, so those limits hold at both shapes.
K3_TOL_TRAIN = {"mel_gate": 5e-3, "c_att": 2e-3, "c_rnn": 2e-3, "al": 5e-4, "cum": 5e-4,
                "xh1": 1.6e-2, "xh2": 1.6e-2}
TRAIN_B, TRAIN_L, TRAIN_T = 32, 160, 128  # phase 3b shapes
TRAIN_TEXTS = (  # 60-150 characters each
    "Printing, in the only sense with which we are at present concerned, differs from most "
    "if not from all the arts.",
    "The earliest book printed with movable types, the Gutenberg Bible, was printed in Latin.",
    "And it is worth mention in passing that, as an example of fine typography, it has never "
    "been surpassed.",
    "The characters of this printing were taken from the best of the manuscripts.",
    "Now, as all books not primarily intended as picture-books consist principally of types, "
    "it follows that the type matters.",
    "The committee reported that the weather in the valley had changed little since spring.",
    "She walked slowly along the quiet harbour, counting the boats as the tide came in.",
    "On the second day the travellers reached a small town at the foot of the mountains.",
)
UNIVERSAL_V1 = {
    "resblock": "1", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "num_mels": 80,
    "sampling_rate": 22050, "hop_size": 256,
}
# the published generator configs of jik876/hifi-gan, config_v2.json and
# config_v3.json (the HiFi-GAN paper's V2 and V3, 0.92 M and 1.46 M
# parameters): V2 runs its stages 3 and 4 at 16 and 8 channels (the narrow
# kernel), V3 ResBlock2 at 128, 64 and 32 with dilations up to 12
HIFIGAN_V2 = {
    "resblock": "1", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 128, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "num_mels": 80,
    "sampling_rate": 22050, "hop_size": 256,
}
HIFIGAN_V3 = {
    "resblock": "2", "upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
    "upsample_initial_channel": 256, "resblock_kernel_sizes": [3, 5, 7],
    "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]], "num_mels": 80,
    "sampling_rate": 22050, "hop_size": 256,
}
# generators at the shapes JAX's stage kernel takes and the port's wide
# kernels do not (phase 4n; no published config, V1's rates and ResBlock1
# unless stated). c2_wide: stage widths 200 / 100 / 50 / 25 (Co off 32, Ci
# off 8, an odd C) on the narrow kernel, conv_pre from 100 mels (BigVGAN's
# 100-band input) to 400, the folded upsamples of stages 1-2 (to 8 x 200 and
# 8 x 100) on the wide kernels and of stages 3-4 (from 100 and 50) on the
# narrow one
C2_WIDE = {**UNIVERSAL_V1, "upsample_initial_channel": 400, "num_mels": 100}
# c2_deep: seven stages, 64 / 32 (wide pairs) to 16 / 8 (the narrow pairs)
# to C = 4, 2 and 1 (JAX folds those at s = 32 to 128), the u = 4 upsample in
# front (JAX: XLA's transposed conv) and the u = 2 folds to 2 x 2 and 2 x 1
C2_DEEP = {**UNIVERSAL_V1, "upsample_initial_channel": 128,
           "upsample_rates": [4, 2, 2, 2, 2, 2, 2], "upsample_kernel_sizes": [8, 4, 4, 4, 4, 4, 4]}
# c2_routes: JAX's XLA routes. c2_u5: a u = 5, k = 11 upsample that does
# not fold (stage 2, 256 -> 128: stock ops, then the wide kernels); c2_even:
# ResBlock2 with even kernels (4, 6) and even dilations, the whole
# generator on stock ops with get_padding's symmetric padding
C2_U5 = {**UNIVERSAL_V1, "upsample_rates": [8, 5, 2, 2], "upsample_kernel_sizes": [16, 11, 4, 4]}
C2_EVEN = {**UNIVERSAL_V1, "resblock": "2", "upsample_initial_channel": 256,
           "resblock_kernel_sizes": [4, 6], "resblock_dilation_sizes": [[2, 4], [2, 4]]}
C2_GENERATORS = {"c2_wide": C2_WIDE, "c2_deep": C2_DEEP, "c2_u5": C2_U5, "c2_even": C2_EVEN}


class SmokeFailure(RuntimeError):
    pass


def vocode_launches(h: dict, dtype=None) -> dict:
    """K2's launches in one vocode of a HiFi-GAN of config ``h`` built under
    a policy of ``dtype`` (f32 by default, the commands' vocoder policy; its
    entries counted as ``<entry>_f32``, ``mrf.F32_LAUNCHES``), every
    counter of the mode (``mrf.launch_key``): one ``conv_pre`` (stage 1's
    operand), one ``conv_transpose`` per stage, one ``mrf_pair`` per
    ResBlock1 pair that it takes (channels one N tile) and one ``mrf_conv``
    per other conv, each at 8 or 16 output channels the narrow kernel's
    entry (``narrow_transpose``, ``narrow_pair``, ``narrow_conv``) where
    the wide kernels do not take the shape; none for an upsample or a
    generator on JAX's XLA route (``vocode_routes``). 1, 4, 27 and 18 for
    UNIVERSAL_V1 (72 convs, in either mode); HIFIGAN_V2 1, 4, 9 + 9 and 18 +
    18 narrow ones; HIFIGAN_V3 1, 3 and 18."""
    import torch

    from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.ops import mrf

    dtype = torch.float32 if dtype is None else dtype
    gen = HiFiGAN(HiFiGANConfig.from_dict(h), Policy(dtype))
    n = dict.fromkeys(mrf.F32_LAUNCHES if dtype == torch.float32 else mrf.LAUNCHES, 0)
    if not gen.odd:
        return n
    n[mrf.launch_key("conv_pre", gen.conv_pre_weights())] += 1
    for rbs, ups in gen.kernel_weights():
        if ups.folded is not None:
            n[mrf.launch_key("conv_transpose", ups.folded)] += 1
        for rb in rbs:
            for c1, c2 in rb:
                if mrf.pair_fusable(c1, c2):
                    n[mrf.launch_key("mrf_pair", c1)] += 1
                else:
                    for cw in (c1, c2):
                        if cw is not None:
                            n[mrf.launch_key("mrf_conv", cw)] += 1
    return n


def vocode_routes(h: dict) -> dict:
    """JAX's XLA routes that one vocode of config ``h`` takes on stock ops
    (``mrf.STOCK_ROUTES``): each upsample that does not fold, or the whole
    generator where a resblock kernel size is even."""
    from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
    from tacotron2_tpu_torch.ops import mrf

    gen = HiFiGAN(HiFiGANConfig.from_dict(h))
    n = dict.fromkeys(mrf.STOCK_ROUTES, 0)
    if not gen.odd:
        n["generator_stock"] = 1
    else:
        n["conv_transpose_stock"] = sum(ups.folded is None for _, ups in gen.kernel_weights())
    return n


def check_vocode_launches(launches: dict, vocodes: int, where: str, dtype=None,
                          h: dict = UNIVERSAL_V1) -> None:
    """K2's launches in ``launches`` are ``vocodes`` vocodes of the HiFi-GAN
    config ``h`` (UNIVERSAL_V1 by default) under ``dtype``'s policy (f32 by
    default), entry by entry, and the other mode's entries, where counted,
    none."""
    import torch

    from tacotron2_tpu_torch.ops import mrf

    f32 = dtype is None or dtype == torch.float32
    want = {k: v * vocodes for k, v in vocode_launches(h, dtype).items()}
    want.update({k: 0 for k in (mrf.LAUNCHES if f32 else mrf.F32_LAUNCHES) if k in launches})
    if any(launches[k] != v for k, v in want.items()):
        raise SmokeFailure(f"{where}: K2 launched {[launches[k] for k in want]} times, "
                           f"want {want} ({vocodes} vocodes)")


def k2_launch_keys() -> tuple:
    """Every K2 counter, bf16 and f32 (``mrf.LAUNCHES``, ``mrf.F32_LAUNCHES``)."""
    from tacotron2_tpu_torch.ops import mrf

    return (*mrf.LAUNCHES, *mrf.F32_LAUNCHES)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_kernels(text: str) -> dict:
    """nvcc's ``-Xptxas -v`` log -> {kernel: registers, static shared
    memory and spill bytes}."""
    import re

    def kernel_name(mangled: str):  # the length-prefixed identifier ending in _kernel
        for m in re.finditer(r"\d+", mangled):  # a hash's digits may precede the length
            for k in range(len(m.group())):
                end = m.end() + int(m.group()[k:])
                ident = mangled[m.end():end]
                if ident.endswith("_kernel"):
                    return ident + template_args(mangled[end:])
        return None

    def template_args(rest: str) -> str:  # "ILi128ELi2ELb1EE..." -> "<128,2,true>"
        if not rest.startswith("I"):
            return ""
        names, i = [], 1
        while i < len(rest) and rest[i] != "E":
            m = (re.match(r"L([a-z])(-?\d+)E", rest[i:]) or re.match(r"(\d+)", rest[i:])
                 or re.match(r"S\w*?_", rest[i:]) or re.match(r".", rest[i:]))
            tok = m.group(0)
            if tok.startswith("L") and m.lastindex == 2:
                names.append({"1": "true", "0": "false"}[m.group(2)] if m.group(1) == "b"
                             else m.group(2))
            elif tok[0].isdigit():
                n = int(tok)
                name = rest[i + len(tok):i + len(tok) + n]
                names.append("bf16" if name == "__nv_bfloat16" else name)
                tok += name
            elif tok.startswith("S"):
                names.append(names[-1] if names else "?")
            else:
                names.append({"f": "float", "i": "int"}.get(tok, tok))
            i += len(tok)
        return "<" + ",".join(names) + ">"

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            if name:
                out[name] = {"registers": 0, "smem": 0, "spill_stores": 0, "spill_loads": 0,
                             "stack": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[name]["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(sm.group(1)) if sm else 0
    return out


def card_peak(kind: str) -> float:
    """A peak of the H100 SXM's data sheet, from the port's FLOP model
    (``tacotron2_tpu_torch/utils/flops.py``, the one place that holds
    them): "bytes" (HBM bytes/s), "bf16" / "tf32" (dense FLOP/s), "int8"
    (dense OP/s) or "f32" (the CUDA cores' FLOP/s)."""
    from tacotron2_tpu_torch.utils import flops

    return 1e12 * {"bytes": flops.H100_HBM_TBPS, "bf16": flops.H100_BF16_TFLOPS,
                   "int8": flops.H100_INT8_TOPS, "tf32": flops.H100_TF32_TFLOPS,
                   "f32": flops.H100_F32_TFLOPS}[kind]


def bound_ms(nbytes: float, flops: float, peak: float = None) -> tuple:
    """max(bytes / the HBM rate, ops / ``peak``, bf16's by default) in ms,
    and which of the two bounds it."""
    t_bytes = nbytes / card_peak("bytes") * 1e3
    t_ops = flops / (card_peak("bf16") if peak is None else peak) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def time_ms(fn, reps: int = 20, inner: int = 10, warm: int = 3) -> float:
    """Device time of one call of ``fn``: ``inner`` calls captured in one
    CUDA graph, replayed ``reps`` times between two CUDA events, so the
    host's launch cost stays out of the number; ``warm`` calls before."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
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


def eager_ms(fn, reps: int = 50, warm: int = 3) -> float:
    """Time of one eager call, launches from the host included."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ms_text(ms) -> str:
    """A time for a log line; None is a time this run did not measure."""
    return "not measured" if ms is None else f"{ms:.4f}"


def err(got, ref, own: bool = False) -> tuple:
    """-> (max abs error, that over max(1, max |ref|), or over max |ref|
    itself when ``own``)."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise SmokeFailure("kernel output is not finite")
    a = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    return a, a / (max(scale, 1e-30) if own else max(1.0, scale))


def check(name: str, pairs, tol, log: dict, kernel: str = "", own: bool = False) -> float:
    """Compare (label, kernel output, plain output) pairs; ``tol`` is one
    limit or a limit per label, on the error relative to max(1, max |ref|)
    or, with ``own``, to max |ref|; ``kernel`` names the wrapper whose JSON
    row the error belongs to. -> the largest relative error."""
    worst = 0.0
    for label, got, ref in pairs:
        a, r = err(got, ref, own)
        lim = tol[label] if isinstance(tol, dict) else tol
        worst = max(worst, r)
        print(f"  {name:<20} {label:<14} max_abs_err {a:.3e}  rel {r:.3e}  (tol {lim:g})")
        log.setdefault("checks", []).append({"kernel": kernel or name, "check": name,
                                             "output": label, "max_abs_err": a,
                                             "rel_err": r, "tol": lim})
        if not r <= lim:
            raise SmokeFailure(f"{name} {label}: rel err {r:.3e} > {lim:g}")
    return worst


# conv_pre on mrf_conv's kernel against its plain version: the two sum in
# other orders, so a sum near a bf16 rounding boundary rounds the other way
# before the bias. Each element within one bf16 ulp of the rounded sum
# (carried through the bias) plus one of the output, on at most this share
# of the elements
CONV_PRE_SHARE = 1e-2


def bf16_ulp(v):
    """The bf16 ulp of each element of ``v`` (0 where v is 0)."""
    import torch

    a = v.float().abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-38))) - 7), 0.0)


def conv_pre_check(hifigan, mel, log: dict, tag: str, kernel: str = "conv_pre"):
    """``conv_pre`` (``mrf_conv``'s kernel at Ci = num_mels, the sum rounded
    to bf16 before the bias) from the bf16 mel against ``operand(conv1d(...,
    round_out=True))`` (cuDNN, f32 sums of the bf16 operands): fails unless
    every element is within one bf16 ulp of the rounded sum plus one of the
    output, and at most CONV_PRE_SHARE of them differ; the share goes to
    the log under ``kernel``. -> the kernel's operand"""
    import torch

    from tacotron2_tpu_torch.models import layers
    from tacotron2_tpu_torch.ops import mrf

    bf = torch.bfloat16
    pol, w, b = hifigan.policy, hifigan.conv_pre.weight, hifigan.conv_pre.bias
    got = mrf.conv_pre(mel.to(bf).contiguous(), hifigan.conv_pre_weights())
    ref = mrf.operand(layers.conv1d(mel, w, b, pol, padding=3, round_out=True), bf)
    sums = pol.cast(layers.conv1d(mel, w, None, pol, padding=3))
    diff = (got.float() - ref.float()).abs()
    over = float((diff - bf16_ulp(sums) - bf16_ulp(ref)).max())
    share = float((diff > 0).float().mean())
    a = float(diff.max())
    print(f"  conv_pre@{tag:<14} max_abs_err {a:.3e}  {100 * share:.4f}% of the elements "
          f"differ, each within one bf16 ulp: {over <= 0}")
    log.setdefault("checks", []).append({"kernel": kernel, "check": f"conv_pre@{tag}",
                                         "output": "a", "max_abs_err": a, "rel_err": share,
                                         "tol": CONV_PRE_SHARE, "within_one_ulp": over <= 0})
    if not (over <= 0 and share <= CONV_PRE_SHARE):
        raise SmokeFailure(f"conv_pre@{tag}: {100 * share:.4f}% of the elements differ from "
                           f"the plain version, the worst {over:.3e} past one bf16 ulp")
    return got


# ---------------------------------------------------------------------------


def random_tacotron(cfg, gate_bias: float, seed: int = SEED):
    import torch

    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.run.say import model_config_from
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2

    torch.manual_seed(seed)
    m = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision))
    with torch.no_grad():
        m.decoder.gate.bias.fill_(gate_bias)
    return m.eval()


def random_hifigan_state(h: dict = UNIVERSAL_V1, seed: int = SEED + 1):
    """The generator state of config ``h`` (UNIVERSAL_V1 by default), drawn
    from ``seed``, with weight norm (g, v) on every conv, as the upstream
    ``g_*`` files store it."""
    import torch

    from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig

    torch.manual_seed(seed)
    sd = HiFiGAN(HiFiGANConfig.from_dict(h)).state_dict()
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


def write_hifigan(h: dict = UNIVERSAL_V1, name: str = "hifigan", seed: int = SEED + 1) -> str:
    """``random_hifigan_state(h, seed)`` as an upstream ``g_*`` file with
    its ``config.json`` in WORK / ``name`` -> the file's path."""
    import torch

    hdir = WORK / name
    hdir.mkdir(parents=True, exist_ok=True)
    (hdir / "config.json").write_text(json.dumps(h))
    g_path = str(hdir / "g_00000000")
    torch.save({"generator": random_hifigan_state(h, seed)}, g_path)
    return g_path


def chunk_inputs(model, lengths, g, L: int = 0) -> tuple:
    """Random bf16 encoder outputs (B, L, D), their attention projection and
    a decode state for the rows of ``lengths``, L being ``L`` or else the
    longest row; chars at or past a row's length have weight 0."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    c = model.cfg
    B, L, dev = lengths.shape[0], L or int(lengths.max()), lengths.device
    H, D = c.att_rnn_dim, getattr(c, "encoded_full_dim", c.encoded_dim)  # the memory's width
    rn = lambda *s, scale=0.5: torch.randn(*s, device=dev, generator=g) * scale
    enc = rn(B, L, D).to(torch.bfloat16)
    att_enc = (enc.float() @ model.att_encoder.weight.t()).contiguous()
    pad = torch.arange(L, device=dev)[None, :] >= lengths[:, None]
    soft = lambda: torch.softmax(rn(B, L, scale=3.0).masked_fill(pad, float("-inf")), dim=1)
    w = soft()
    s = dl.StepState(rn(B, c.num_mels, scale=1.0), rn(B, H), rn(B, H), rn(B, D), w, w + soft(),
                     rn(B, H), rn(B, H))
    return enc, att_enc, s


def chunk_check(name: str, pk, model, lengths, n: int, g, log: dict,
                defect: bool = False, L: int = 0, controls=None,
                kernel: str = "decode_chunk", tol: float = 0.0) -> float:
    """``n`` decode steps through the chunk entry (the decode's main path)
    against the plain chunk, on ``chunk_inputs`` -> the largest error. With
    ``defect``, also the errors the check reads for defective kernels (the
    plain chunk with the defect): those of a wrong step's masks or a row
    length off by one must exceed the limit, and with ``controls`` (B,
    controls_dim) those of controls left out (zero); that of activations
    left unrounded (no bf16) is only reported, being of the size of a
    rounding flip. ``kernel``: the kernels line's row of the reading;
    ``tol``: a limit of its own."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    c = model.cfg
    enc, att_enc, s = chunk_inputs(model, lengths, g, L)
    m1, m2 = dl.prenet_masks(n, lengths.shape[0], c.prenet_dim, c.dropout, g, lengths.device)
    ctl = () if controls is None else dl.stage_controls(pk, controls, lengths.shape[0],
                                                          lengths.device)
    mg, al, sk = dl.decode_chunk(pk, enc, att_enc, lengths, s, m1, m2, *ctl)

    def pairs(ref):
        mgp, alp, sp = ref
        return [("mel_gate", mg, mgp), ("weights", al, alp)] + [
            (f, getattr(sk, f), getattr(sp, f)) for f in dl.StepState._fields[1:]]

    tol = tol or (K1_TOL if n == 1 else K1_CHUNK_TOL)
    worst = check(name, pairs(dl.decode_chunk_plain(pk, enc, att_enc, lengths, s, m1, m2, *ctl)),
                  tol, log, kernel)
    pad = torch.arange(enc.shape[1], device=enc.device)[None, :] >= lengths[:, None]
    if bool((al * pad[None]).any()):
        raise SmokeFailure(f"{name}: the kernel gave padded chars attention weight")
    if not defect:
        return worst
    pk32 = pk._replace(**{f: getattr(pk, f).float() for f in (
        "w_att", "w_dec", "wp1_t", "wp2_t", "wq", "w_loc", "wv", "w_out")})
    zero_ctl = tuple(torch.zeros_like(t) if t is not None else None for t in ctl)
    for what, args, must in (
        ("masks one step late", (pk, enc, att_enc, lengths, s, m1.roll(1, 0), m2.roll(1, 0), *ctl),
         True),
        ("one char too few", (pk, enc, att_enc, lengths - 1, s, m1, m2, *ctl), True),
        ("no bf16 activations", (pk32, enc.float(), att_enc, lengths, s, m1, m2, *ctl), False),
    ) + ((("controls left out", (pk, enc, att_enc, lengths, s, m1, m2, *zero_ctl), True),)
         if ctl else ()):
        wrong = max(err(got, ref)[1] for _, got, ref in pairs(dl.decode_chunk_plain(*args)))
        log.setdefault("k1_chunk_defects", []).append({"check": name, "defect": what,
                                                       "rel_err": wrong, "tol": tol})
        print(f"  {name:<20} defect '{what}' reads rel {wrong:.3e} (tol {tol:g})")
        if must and not wrong > tol:
            raise SmokeFailure(f"{name}: the limit {tol:g} does not tell a kernel with "
                               f"'{what}' ({wrong:.3e}) from a right one")
    return worst


def k1_phase(model, cfg, L: int, log: dict, cells: dict) -> list:
    """One decode step at the flagship dims, kernels against plain versions;
    then whole chunks, the 4-step ones on K1_DRAWS weight draws. ``cells``:
    ``cell_rows``' readings, the source of the ``lstm_cell`` row."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    dev = torch.device("cuda")
    c = model.cfg
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    pk = dl.pack_decoder(model.prenet, model.decoder, torch.bfloat16)
    B, M, P, H, D, A = 1, c.num_mels, c.prenet_dim, c.att_rnn_dim, c.encoded_dim, c.att_dim
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    encoded, att_enc, s = chunk_inputs(model, lengths, g)
    m1, m2 = dl.prenet_masks(1, B, P, c.dropout, g, dev)
    m1, m2 = m1[0], m2[0]

    x_k = dl.prenet(s.mel, pk.wp1_t, pk.wp2_t, m1, m2, pk.wt_prenet)
    x_p = dl.prenet_plain(s.mel, pk.wp1_t, pk.wp2_t, m1, m2)
    check("prenet", [("out", x_k, x_p)], K1_TOL, log)
    bf = lambda t: t.to(torch.bfloat16)  # the bf16 cell's operands, as the chunk's producers
    ah_k, ac_k = dl.lstm_cell(pk.w_att, pk.b_att, bf(x_p), bf(s.ctx), bf(s.att_h), s.att_c,
                              pk.wt_att)
    ah_p, ac_p = dl.lstm_cell_plain(pk.w_att, pk.b_att, x_p, s.ctx, s.att_h, s.att_c)
    check("lstm_cell[att]", [("h", ah_k, ah_p), ("c", ac_k, ac_p)], K1_TOL, log, "lstm_cell")
    att_args = (ah_p, pk.wq, pk.w_loc, pk.wv, att_enc, encoded, lengths, s.att_w, s.att_cum)
    ctx_k, w_k, cum_k = dl.location_attention(*att_args)
    ctx_p, w_p, cum_p = dl.location_attention_plain(*att_args)
    check("location_attention", [("context", ctx_k, ctx_p), ("weights", w_k, w_p),
                                 ("cum_weights", cum_k, cum_p)], K1_TOL, log)
    rh_k, rc_k = dl.lstm_cell(pk.w_dec, pk.b_dec, bf(ah_p), bf(ctx_p), bf(s.rnn_h), s.rnn_c,
                              pk.wt_dec)
    rh_p, rc_p = dl.lstm_cell_plain(pk.w_dec, pk.b_dec, ah_p, ctx_p, s.rnn_h, s.rnn_c)
    check("lstm_cell[dec]", [("h", rh_k, rh_p), ("c", rc_k, rc_p)], K1_TOL, log, "lstm_cell")
    mg_k = dl.heads(pk.w_out, pk.b_out, rh_p, ctx_p, wt=pk.wt_out)
    mg_p = dl.heads_plain(pk.w_out, pk.b_out, rh_p, ctx_p)
    check("heads", [("mel_gate", mg_k, mg_p)], K1_TOL, log)

    # B=2 with row 1 padded (lengths < L): the attention's -inf mask on the
    # card; padded chars get weight 0
    padded = torch.tensor([L, L - PAD], dtype=torch.int32, device=dev)
    enc2, att_enc2, s2 = chunk_inputs(model, padded, g)
    att2 = (s2.att_h, pk.wq, pk.w_loc, pk.wv, att_enc2, enc2, padded, s2.att_w, s2.att_cum)
    got, ref = dl.location_attention(*att2), dl.location_attention_plain(*att2)
    check("location_attention[pad]", list(zip(("context", "weights", "cum_weights"), got, ref)),
          K1_TOL, log, "location_attention")
    if bool((got[1][1, L - PAD:] != 0).any()):
        raise SmokeFailure("the kernel gave padded chars attention weight")

    # whole steps through the chunk entry: one step, then four (the state
    # ping-pongs) at B=1 and at B=2 with row 1 padded, on this model's
    # weights and on K1_DRAWS - 1 further draws
    chunk_check("decode_chunk[1]", pk, model, lengths, 1, g, log)
    draws = [max(chunk_check("decode_chunk[4]", pk, model, lengths, 4, g, log, True),
                 chunk_check("decode_chunk[4,pad]", pk, model, padded, 4, g, log, True))]
    for d in range(1, K1_DRAWS):
        m = random_tacotron(cfg, 10.0, SEED + 10 * d).to(dev)
        pkd = dl.pack_decoder(m.prenet, m.decoder, torch.bfloat16)
        draws.append(max(chunk_check(f"decode_chunk[4]#{d}", pkd, m, lengths, 4, g, log),
                         chunk_check(f"decode_chunk[4,pad]#{d}", pkd, m, padded, 4, g, log)))
    log["k1_chunk_draws"] = draws
    print(f"  decode_chunk[4] largest error per weight draw: "
          + ", ".join(f"{x:.3e}" for x in draws) + f" (tol {K1_CHUNK_TOL:g})")

    # a whole 64-frame chunk through the main-path entry: device time
    # (graph replay) and eager time (the host launches included), per step
    mk1, mk2 = dl.prenet_masks(64, B, P, c.dropout, g, dev)
    chunk = lambda: dl.decode_chunk(pk, encoded, att_enc, lengths, s, mk1, mk2)
    log["decode_chunk_us_per_step"] = {"device": time_ms(chunk, 5, 1) / 64 * 1e3,
                                       "eager": eager_ms(chunk, 5) / 64 * 1e3}
    print(f"  decode_chunk (64 steps) per step: {log['decode_chunk_us_per_step']}")

    # timings at B=1 and the say's char count (the cells' come from cell_rows)
    head_x = torch.cat([rh_p, ctx_p], 1).to(torch.bfloat16)
    head_w = pk.w_out
    head_b = pk.b_out.to(torch.bfloat16)
    f32 = lambda *shape: torch.empty(*shape, device=dev)
    K = pk.w_loc.shape[2]
    att_bytes = nbytes(*att_args, f32(B, D), f32(B, L), f32(B, L))
    att_flops = B * (2 * A * H + L * A * (4 * K + 4) + 2 * L * D + 4 * L)
    S = dl.location_cluster_size(L, H, A, D, K)

    # the attention at the serve windows' shapes (16 and 64 rows of 128
    # chars, the server's bucket): kernel, plain version and bound, and the
    # cluster size, which must not change with the rows
    att_rows = {}
    for Bw in (16, 64):
        Lw = 128
        lw = torch.full((Bw,), Lw, dtype=torch.int32, device=dev)
        enc_w, att_enc_w, s_w = chunk_inputs(model, lw, g, Lw)
        args_w = (s_w.att_h, pk.wq, pk.w_loc, pk.wv, att_enc_w, enc_w, lw, s_w.att_w,
                  s_w.att_cum)
        check(f"location_attention@B{Bw}", list(zip(
            ("context", "weights", "cum_weights"), dl.location_attention(*args_w),
            dl.location_attention_plain(*args_w))), K1_TOL, log, "location_attention")
        nb = nbytes(*args_w, f32(Bw, D), f32(Bw, Lw), f32(Bw, Lw))
        fl = Bw * (2 * A * H + Lw * A * (4 * K + 4) + 2 * Lw * D + 4 * Lw)
        b_ms, b_by = bound_ms(nb, fl)
        Sw = dl.location_cluster_size(Lw, H, A, D, K)
        att_rows[f"B{Bw}"] = {"L": Lw, "S": Sw, "blocks": Sw * Bw,
                              "ms": time_ms(lambda: dl.location_attention(*args_w)),
                              "plain_ms": time_ms(lambda: dl.location_attention_plain(*args_w)),
                              "bound_ms": b_ms, "bound_by": b_by}
        print(f"  location_attention at B={Bw}, L={Lw}: S={Sw} ({Sw * Bw} blocks), "
              f"{att_rows[f'B{Bw}']['ms'] * 1e3:.1f} us, plain "
              f"{att_rows[f'B{Bw}']['plain_ms'] * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us")
    log["location_attention_rows"] = att_rows
    rows = []
    for name, kern, plain, lib, nb, fl, replaces in (
        ("prenet", lambda: dl.prenet(s.mel, pk.wp1_t, pk.wp2_t, m1, m2, pk.wt_prenet),
         lambda: dl.prenet_plain(s.mel, pk.wp1_t, pk.wp2_t, m1, m2), None,
         nbytes(s.mel, pk.wp1_t, pk.wp2_t, m1, m2, f32(B, P)), 2 * B * (M * P + P * P), 347),
        ("location_attention", lambda: dl.location_attention(*att_args),
         lambda: dl.location_attention_plain(*att_args), None, att_bytes, att_flops, 196),
        ("heads", lambda: dl.heads(pk.w_out, pk.b_out, rh_p, ctx_p, wt=pk.wt_out),
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
    rows[1]["per"] += f", a cluster of S={S} blocks per row"
    rows[1]["rows"] = att_rows
    return rows[:1] + [cell_row("lstm_cell", cells)] + rows[1:]


def _int8_defects(pk, model):
    """The plain int8 chunk with a defect -> {defect: a function running
    ``decode_chunk_plain`` with it}: activations rounded to bf16 before they
    are quantised; weight scales taken from bf16 weights; roundf (half away
    from zero) in place of rounding half to even; for a pack with controls,
    the decoder cell's row scale taken without them."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    quantize_rows = dl.quantize_rows
    bf = lambda t: t.to(torch.bfloat16).float()

    def roundf_rows(x):
        sx = dl._div127(x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12))
        v = x / sx
        return (torch.sign(v) * torch.floor(v.abs() + 0.5)).clamp(-127, 127), sx

    def patched(rows_fn, pack):
        def run(*args):
            dl.quantize_rows = rows_fn
            try:
                return dl.decode_chunk_plain(pack, *args)
            finally:
                dl.quantize_rows = quantize_rows
        return run

    E = pk.controls_cols
    H, D = pk.wq.shape[1], pk.w_out.shape[1] - pk.wq.shape[1] - E

    def scale_without_controls(x):
        if x.shape[1] != pk.w_dec.shape[1]:  # the attention cell's input
            return quantize_rows(x)
        keep = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
        keep[H + D:H + D + E] = False
        sx = dl._div127(x[:, keep].abs().amax(dim=1, keepdim=True).clamp_min(1e-12))
        return torch.round(x / sx).clamp(-127, 127), sx

    f32 = dl.pack_decoder(model.prenet, model.decoder, torch.float32)  # the pack's columns
    (wa, sa), (wd, sd) = (dl.quantize_weights(bf(w)) for w in (f32.w_att, f32.w_dec))
    return {
        **({"row scale without the controls": (patched(scale_without_controls, pk), True)}
           if E else {}),
        "bf16 activations": (patched(lambda x: quantize_rows(bf(x)), pk), True),
        "scales of bf16 weights": (patched(quantize_rows, pk._replace(
            w_att=wa, s_att=sa, w_dec=wd, s_dec=sd)), True),
        "roundf": (patched(roundf_rows, pk), False),
    }


def k5_check(name: str, pk, model, lengths, n: int, g, log: dict, defect: bool = False,
             L: int = 0, controls=None, kernel: str = "lstm_cell_int8",
             tol: float = 0.0) -> float:
    """``n`` int8 decode steps through the chunk entry (K5 for both LSTM
    cells) against the plain int8 chunk, on ``chunk_inputs`` -> the largest
    error; ``controls`` (B, controls_dim) for a pack with controls. With
    ``defect``, also the readings of ``_int8_defects``; all but roundf must
    exceed the limit (roundf differs only on exact ties, so it is
    reported). ``tol``: a limit of its own (inf: a reading only)."""
    from tacotron2_tpu_torch.ops import decoder_loop as dl

    c = model.cfg
    enc, att_enc, s = chunk_inputs(model, lengths, g, L)
    m1, m2 = dl.prenet_masks(n, lengths.shape[0], c.prenet_dim, c.dropout, g, lengths.device)
    ctl = () if controls is None else dl.stage_controls(pk, controls, lengths.shape[0],
                                                          lengths.device)
    mg, al, sk = dl.decode_chunk(pk, enc, att_enc, lengths, s, m1, m2, *ctl)

    def pairs(ref):
        mgp, alp, sp = ref
        return [("mel_gate", mg, mgp), ("weights", al, alp)] + [
            (f, getattr(sk, f), getattr(sp, f)) for f in dl.StepState._fields[1:]]

    tol = tol or (K5_TOL if n == 1 else K5_CHUNK_TOL)
    worst = check(name, pairs(dl.decode_chunk_plain(pk, enc, att_enc, lengths, s, m1, m2, *ctl)),
                  tol, log, kernel)
    if not defect:
        return worst
    for what, (run, must) in _int8_defects(pk, model).items():
        wrong = max(err(got, ref)[1] for _, got, ref in
                    pairs(run(enc, att_enc, lengths, s, m1, m2, *ctl)))
        log.setdefault("k5_defects", []).append({"check": name, "defect": what,
                                                 "rel_err": wrong, "tol": tol})
        print(f"  {name:<20} defect '{what}' reads rel {wrong:.3e} (tol {tol:g})")
        if must and not wrong > tol:
            raise SmokeFailure(f"{name}: the limit {tol:g} does not tell a kernel with "
                               f"'{what}' ({wrong:.3e}) from a right one")
    return worst


def k5_phase(model, cfg, L: int, log: dict, cells: dict) -> list:
    """K5, the int8 LSTM cell, against its plain version at the flagship
    dims: one step through the chunk entry at B=1 and at B=2 with a padded
    row (the defective kernels held above the one-step limit), the 4-step
    int8 chunk on K1_DRAWS weight draws; its timing row from ``cells``
    (``cell_rows``)."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    dev = torch.device("cuda")
    c = model.cfg
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    pk = model.make_packed_decoder(quantize=True)
    lengths = torch.tensor([L], dtype=torch.int32, device=dev)
    padded = torch.tensor([L, L - PAD], dtype=torch.int32, device=dev)
    k5_check("int8_step", pk, model, lengths, 1, g, log, True)
    k5_check("int8_step[pad]", pk, model, padded, 1, g, log, True)
    draws = []
    for d in range(K1_DRAWS):
        m = model if d == 0 else random_tacotron(cfg, 10.0, SEED + 10 * d).to(dev)
        pkd = pk if d == 0 else m.make_packed_decoder(quantize=True)
        draws.append(max(k5_check(f"int8_chunk[4]#{d}", pkd, m, lengths, 4, g, log, d == 0),
                         k5_check(f"int8_chunk[4,pad]#{d}", pkd, m, padded, 4, g, log)))
    log["k5_chunk_draws"] = draws
    print("  int8_chunk[4] largest error per weight draw: "
          + ", ".join(f"{x:.3e}" for x in draws) + f" (tol {K5_CHUNK_TOL:g})")

    # a whole 64-frame int8 chunk per step, device and eager, beside bf16's
    enc, att_enc, s = chunk_inputs(model, lengths, g)
    mk1, mk2 = dl.prenet_masks(64, 1, c.prenet_dim, c.dropout, g, dev)
    chunk = lambda: dl.decode_chunk(pk, enc, att_enc, lengths, s, mk1, mk2)
    log["decode_chunk_int8_us_per_step"] = {"device": time_ms(chunk, 5, 1) / 64 * 1e3,
                                            "eager": eager_ms(chunk, 5) / 64 * 1e3}
    print(f"  int8 decode_chunk (64 steps) per step: {log['decode_chunk_int8_us_per_step']}")

    return [cell_row(k, cells) for k in ("lstm_cell_int8", "quantize_xh")]


K5_KERNELS = ("quantize_xh", "lstm_cell_int8")  # K5: two launches a cell, int8 path only
K1_ROWS = (1, 16, 64)  # the say's one row and the serve windows' rows
SERVE_L = 128  # the server's char bucket (run/server.py CHAR_BUCKET)
CELL_INVARIANCE_ROWS = (0, 1, 37, 63)  # rows of a 64-row cell launch held against alone
CELL_TWO_PASSES = 80  # rows past one pass of 64: the cells' second pass, held too


def serve_batch(cfg, B: int, dev) -> tuple:
    """B of the waves' texts (77-121 chars) as the server batches them:
    char ids padded to the 128 bucket, lengths."""
    import torch

    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    prep = cfg.dataset.preprocessing
    ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
        [normalize_text(TRAIN_TEXTS[i % len(TRAIN_TEXTS)], prep.allowed_chars,
                        prep.end_token, False) for i in range(B)])
    ci = torch.nn.functional.pad(torch.as_tensor(ci), (0, SERVE_L - ci.shape[1]))
    return ci.to(dev), torch.as_tensor(cl, dtype=torch.int32, device=dev)


def cell_args(dl, pk, B: int, g) -> tuple:
    """Random inputs of both LSTM cells of one decode step at B rows ->
    ((kernel, plain) wrappers of the pack's mode, per cell (the kernel's
    args, the plain version's args, the kernel's kwargs)). The kwargs carry
    the pack's tiled weight copies where its wrappers take them; there the
    bf16 cell gets its inputs as the bf16 operands the chunk's producers
    write, the plain version their f32 values (which round to the same
    operands)."""
    import torch

    H, Pd = pk.wq.shape[1], pk.wp2_t.shape[0]
    D = pk.w_dec.shape[1] - 2 * H
    rn = lambda *s: torch.randn(*s, device=pk.wq.device, generator=g) * 0.5
    x, ctx, att_h, att_c, rnn_h, rnn_c = (torch.relu(rn(B, Pd)) * 2, rn(B, D), rn(B, H),
                                          rn(B, H), rn(B, H), rn(B, H))
    tiled = hasattr(pk, "wt_att")
    if pk.quantized:
        fns = (dl.lstm_cell_int8, dl.lstm_cell_int8_plain)
        a = (pk.w_att, pk.s_att, pk.b_att, x, ctx, att_h, att_c)
        d = (pk.w_dec, pk.s_dec, pk.b_dec, att_h, ctx, rnn_h, rnn_c)
        ka, kd = a, d
    else:
        fns = (dl.lstm_cell, dl.lstm_cell_plain)
        bf = (lambda t: t.to(torch.bfloat16)) if tiled else (lambda t: t)
        x, ctx, att_h, rnn_h = (bf(t) for t in (x, ctx, att_h, rnn_h))
        ka = (pk.w_att, pk.b_att, x, ctx, att_h, att_c)
        kd = (pk.w_dec, pk.b_dec, att_h, ctx, rnn_h, rnn_c)
        a, d = ((t.float() for t in args) for args in (ka, kd))
        a = (pk.w_att, pk.b_att, *list(a)[2:])
        d = (pk.w_dec, pk.b_dec, *list(d)[2:])
    kw = lambda f: {"wt": getattr(pk, f)} if tiled else {}
    return fns, ((ka, a, kw("wt_att")), (kd, d, kw("wt_dec")))


def cell_rows(model, log: dict, rows=K1_ROWS) -> dict:
    """Both LSTM cells of one decode step at each of ``rows``, for the
    bf16 pack (K1's ``lstm_cell``) and the int8 pack (K5), each held
    against its plain version (K1_TOL, K5_TOL): device ms by graph replay,
    the plain version's, the bound and the library call's: ``nn.LSTMCell``
    x2 in bf16 for K1; for K5 ``torch._int_mm`` of the quantised rows
    (padded to 32 rows and to a multiple of 8) against the int8 weights,
    without the scales and the epilogue, a yardstick.
    -> {kernel: {"B<rows>": {ms, plain_ms, bound_ms, bound_by, library_ms}}}"""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 30)
    out, quant_rows = {}, {}
    for quant in (False, True):
        pk = model.make_packed_decoder(quantize=quant)
        name = "lstm_cell_int8" if quant else "lstm_cell"
        H = pk.wq.shape[1]
        res = {}
        for B in rows:
            (kern_fn, plain_fn), cells = cell_args(dl, pk, B, g)
            for tag, (ka, a, kw) in zip(("att", "dec"), cells):
                got, ref = kern_fn(*ka, **kw), plain_fn(*a)
                check(f"{name}[{tag}]@B{B}", [("h", got[0], ref[0]), ("c", got[1], ref[1])],
                      K5_TOL if quant else K1_TOL, log, name)
            kern = lambda: [kern_fn(*ka, **kw) for ka, _, kw in cells]
            plain = lambda: [plain_fn(*a) for _, a, _ in cells]
            if quant:
                mm = []
                for _, (w, _, _, x1, x2, x3, _), _ in cells:
                    q, _ = dl.quantize_rows(torch.cat([x1, x2, x3], 1))
                    qp = torch.zeros(max(32, -(-B // 8) * 8), q.shape[1], dtype=torch.int8,
                                     device=dev)
                    qp[:B] = q.to(torch.int8)
                    mm.append((qp, w.t()))
                lib = lambda: [torch._int_mm(a, b) for a, b in mm]
            else:
                lib_cells = []
                for mod, (_, (_, _, x1, x2, x3, cc), _) in zip(
                        (model.decoder.att_rnn, model.decoder.lstm), cells):
                    cell = torch.nn.LSTMCell(mod.input_size, mod.hidden_size, device=dev,
                                             dtype=torch.bfloat16)
                    cell.load_state_dict(mod.state_dict())
                    bf = lambda t: t.to(torch.bfloat16)
                    lib_cells.append((cell, bf(torch.cat([x1, x2], 1)), (bf(x3), bf(cc))))
                lib = lambda: [cell(x, hc) for cell, x, hc in lib_cells]
            try:
                library_ms = time_ms(lib)
            except Exception as e:  # not every torch build takes these shapes
                library_ms = None
                log.setdefault("cell_library_errors", []).append(f"{name}@B{B}: {e!r}")
            f32 = lambda *shape: torch.empty(*shape, device=dev)
            nb = sum(nbytes(*ka, f32(B, H), f32(B, H)) for ka, _, _ in cells)
            ops = 2 * B * (pk.w_att.numel() + pk.w_dec.numel())
            b_ms, b_by = bound_ms(nb, ops, card_peak("int8") if quant else card_peak("bf16"))
            res[f"B{B}"] = {"ms": time_ms(kern), "plain_ms": time_ms(plain), "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": library_ms,
                            "eager_ms": eager_ms(kern)}
            if quant and hasattr(dl, "quantize_xh"):
                xs = [a[3:6] for _, a, _ in cells]
                for tag, x in zip(("att", "dec"), xs):
                    (qk, sk), (qp, sp) = dl.quantize_xh(*x), dl.quantize_xh_plain(*x)
                    check(f"quantize_xh[{tag}]@B{B}", [("q", qk.float(), qp.float()),
                                                      ("sx", sk, sp)], QUANT_TOL, log,
                          "quantize_xh")
                qb = sum(nbytes(*x) + B * (sum(t.shape[1] for t in x) + 4) for x in xs)
                qb_ms, qb_by = bound_ms(qb, 0)
                quant_rows[f"B{B}"] = {
                    "ms": time_ms(lambda: [dl.quantize_xh(*x) for x in xs]),
                    "plain_ms": time_ms(lambda: [dl.quantize_xh_plain(*x) for x in xs]),
                    "bound_ms": qb_ms, "bound_by": qb_by, "library_ms": None,
                    "eager_ms": eager_ms(lambda: [dl.quantize_xh(*x) for x in xs])}
            r = res[f"B{B}"]
            lib_us = "-" if library_ms is None else f"{library_ms * 1e3:.1f}"
            print(f"  {name} (both cells) at {B} rows: {r['ms'] * 1e3:.1f} us, plain "
                  f"{r['plain_ms'] * 1e3:.1f} us, library {lib_us} us, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by})")
        out[name] = res
    if quant_rows:
        out["quantize_xh"] = quant_rows
    return out


UP_ROWS = (1, 16, 64)  # rows of up_rows: the say, the serve windows


def conv_pre_rows(hifigan, mel, reps, log: dict, tag: str) -> dict:
    """``conv_pre`` on ``mel`` (B, T, num_mels): held to its plain version
    (``conv_pre_check``), its device ms (graph replay), the plain version's,
    its bound (the bf16 mel, the weights and the bf16 operand out; its
    flops), and cuDNN's ``F.conv1d`` over the same operands in f32 (TF32
    off: what the vocoder ran before, without the operand's launch) and in
    bf16 (a yardstick, bf16 output)."""
    import torch
    import torch.nn.functional as F

    from tacotron2_tpu_torch.ops import mrf

    bf = torch.bfloat16
    cw = hifigan.conv_pre_weights()
    a = mel.to(bf).contiguous()
    got = conv_pre_check(hifigan, mel, log, tag)
    K, Co, Ci = cw.w.shape
    B, T, _ = mel.shape
    b_ms, b_by = bound_ms(nbytes(a, cw.w, cw.b, got), 2 * B * T * Co * Ci * K)
    xt = a.transpose(1, 2).contiguous()
    w16 = cw.w.permute(1, 2, 0).contiguous()
    xt32, w32, b16 = xt.float(), w16.float(), cw.b.to(bf)
    return {"ms": time_ms(lambda: mrf.conv_pre(a, cw), *reps),
            "plain_ms": time_ms(lambda: mrf.conv_pre_plain(a, cw), *reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.conv1d(xt32, w32, cw.b, padding=K // 2), *reps),
            "library_bf16_ms": time_ms(lambda: F.conv1d(xt, w16, b16, padding=K // 2), *reps)}


def heads_copy(pk) -> dict:
    """The heads wrapper's tiled weight copy of a pack (``wt_out``), as a
    keyword; none for a parent's package, whose heads read ``w_out``."""
    return {"wt": pk.wt_out} if hasattr(pk, "wt_out") else {}


def up_rows(model, hifigan, Tb: int, log: dict) -> dict:
    """At each of UP_ROWS rows: K2's ``conv_transpose`` of every stage of a
    ``Tb``-frame vocode on random inputs (device ms by graph replay; bound;
    ``F.conv_transpose1d`` in f32 with TF32 off and in bf16 on the operand
    the upsample reads), the vocode's device time (``HiFiGAN.apply``, graph
    replay) and each upsample's share of it; ``conv_pre`` (``F.conv1d`` f32
    and bf16 beside it), or stage 1's ``conv_operand`` where a parent's
    package has that; K1's ``prenet`` alone (held against
    ``prenet_plain``, K1_TOL) and ``heads`` alone, each with its bound.
    Runs this tree's package or a parent's (``--root``): an upsample
    without a folded copy takes the f32 input, a pack without
    ``wt_prenet`` a prenet without its tiled copy. The upsample is held
    against ``conv_transpose_plain`` (K2_TOL) where it is folded; the
    prenet's output digest goes to the log, so that ``--k1-ab`` can tell
    whether the parent's kernel gave the same bits on the same inputs.
    -> {name: {"B<rows>": ...}}"""
    import hashlib

    import torch
    import torch.nn.functional as F

    from tacotron2_tpu_torch.ops import decoder_loop as dl
    from tacotron2_tpu_torch.ops import mrf

    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 40)
    kw = hifigan.kernel_weights()
    folded = hasattr(kw[0][1], "folded")
    out: dict = {"conv_transpose": {}, "vocode": {}, "prenet": {}, "heads": {}}
    pre = "conv_pre" if hasattr(mrf, "conv_pre") else "conv_operand" if folded else None
    if pre:
        out[pre] = {}
    for B in UP_ROWS:
        reps = (2, 2) if B > 1 else (10, 4)
        mel = torch.randn(B, Tb, hifigan.cfg.num_mels, device=dev, generator=g)
        voc_ms = time_ms(lambda: hifigan.apply(mel), 2 if B > 1 else 10, 1)
        out["vocode"][f"B{B}"] = {"ms": voc_ms}
        if pre == "conv_pre":
            r = out[pre][f"B{B}"] = conv_pre_rows(hifigan, mel, reps, log, f"B{B}x{Tb}")
            print(f"  conv_pre at {B} rows, Tb={Tb}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
                  f"plain {r['plain_ms']:.4f}, F.conv1d f32 {r['library_ms']:.4f}, bf16 "
                  f"{r['library_bf16_ms']:.4f})")
        stages, T = [], Tb
        for i, (_, uw) in enumerate(kw):
            K, Ci, Co = uw.w.shape
            x = torch.randn(B, T, Ci, device=dev, generator=g) * 0.5
            a = mrf.operand(x, bf)
            if folded:
                kern = lambda a=a, uw=uw: mrf.conv_transpose(a, uw, want_act=True)
                (yk, ak), (yp, ap) = kern(), mrf.conv_transpose_plain(a, uw, want_act=True)
                check(f"conv_transpose[{i}]@B{B}x{T}", [("out", yk, yp), ("act", ak, ap)],
                      K2_TOL, log, "conv_transpose")
                del yk, ak, yp, ap
                if i == 0 and pre == "conv_operand":
                    nb = nbytes(x, a)
                    b_ms, b_by = bound_ms(nb, 0)
                    out["conv_operand"][f"B{B}"] = {
                        "ms": time_ms(lambda x=x: mrf.conv_operand(x, bf), *reps),
                        "bound_ms": b_ms, "bound_by": b_by}
            else:
                kern = lambda x=x, uw=uw: mrf.conv_transpose(x, uw, want_act=True)
            xt = a.transpose(1, 2).contiguous()
            wt = uw.w.permute(1, 2, 0).to(bf).contiguous()
            xt32, wt32, b16 = xt.float(), wt.float(), uw.b.to(bf)
            lib = lambda xt32=xt32, wt32=wt32, uw=uw: F.conv_transpose1d(
                xt32, wt32, uw.b, stride=uw.stride, padding=uw.padding)
            lib16 = lambda xt=xt, wt=wt, b16=b16, uw=uw: F.conv_transpose1d(
                xt, wt, b16, stride=uw.stride, padding=uw.padding)
            Tout = T * uw.stride
            nb = nbytes(a if folded else x, uw.w, uw.b) + B * Tout * Co * 6
            fl = 2 * B * Tout * Co * Ci * (K // uw.stride)
            b_ms, b_by = bound_ms(nb, fl)
            ms = time_ms(kern, *reps)
            stages.append({"stage": i + 1, "Ci": Ci, "Co": Co, "u": uw.stride, "Tin": T,
                           "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": time_ms(lib, *reps),
                           "library_bf16_ms": time_ms(lib16, *reps),
                           "share_of_vocode": ms / voc_ms})
            del x, a, xt, wt, xt32, wt32
            T = Tout
        out["conv_transpose"][f"B{B}"] = {
            "ms": sum(s["ms"] for s in stages), "bound_ms": sum(s["bound_ms"] for s in stages),
            "library_ms": sum(s["library_ms"] for s in stages),
            "library_bf16_ms": sum(s["library_bf16_ms"] for s in stages), "stages": stages}
        print(f"  conv_transpose at {B} rows, Tb={Tb}: " + "; ".join(
            f"stage {s['stage']} {s['ms']:.4f} ms (bound {s['bound_ms']:.4f}, f32 "
            f"{s['library_ms']:.4f}, bf16 {s['library_bf16_ms']:.4f}, "
            f"{100 * s['share_of_vocode']:.1f}% of the vocode)" for s in stages)
            + f"; vocode {voc_ms:.3f} ms")
        torch.cuda.empty_cache()

    pk = dl.pack_decoder(model.prenet, model.decoder, torch.bfloat16)
    tiled = {"wt": pk.wt_prenet} if hasattr(pk, "wt_prenet") else {}
    M, P = pk.wp1_t.shape
    H = pk.wq.shape[1]
    D = pk.w_out.shape[1] - H
    for B in UP_ROWS:
        mel = torch.randn(B, M, device=dev, generator=g)
        m1, m2 = (m[0] for m in dl.prenet_masks(1, B, P, model.cfg.dropout, g, dev))
        args = (mel, pk.wp1_t, pk.wp2_t, m1, m2)
        got = dl.prenet(*args, **tiled)
        check(f"prenet@B{B}", [("out", got, dl.prenet_plain(*args))], K1_TOL, log, "prenet")
        b_ms, b_by = bound_ms(nbytes(*args, torch.empty(B, P, device=dev)),
                              2 * B * (M * P + P * P))
        out["prenet"][f"B{B}"] = {"ms": time_ms(lambda: dl.prenet(*args, **tiled)),
                                  "plain_ms": time_ms(lambda: dl.prenet_plain(*args)),
                                  "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                                  # the same inputs in every turn of --k1-ab: equal bits?
                                  "out_sha1": hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()}
        rnn_h = torch.randn(B, H, device=dev, generator=g)
        ctx = torch.randn(B, D, device=dev, generator=g)
        hargs = (pk.w_out, pk.b_out, rnn_h, ctx)
        heads = lambda: dl.heads(*hargs, **heads_copy(pk))
        check(f"heads@B{B}", [("mel_gate", heads(), dl.heads_plain(*hargs))], K1_TOL, log,
              "heads")
        hb_ms, hb_by = bound_ms(nbytes(pk.w_out, pk.b_out, rnn_h, ctx,
                                       torch.empty(B, M + 1, device=dev)),
                                2 * B * pk.w_out.numel())
        x_lin, b_lin = torch.cat([rnn_h, ctx], 1).to(bf), pk.b_out.to(bf)
        out["heads"][f"B{B}"] = {
            "ms": time_ms(heads), "plain_ms": time_ms(lambda: dl.heads_plain(*hargs)),
            "bound_ms": hb_ms, "bound_by": hb_by,
            "library_ms": time_ms(lambda: F.linear(x_lin, pk.w_out, b_lin)),
            "out_sha1": hashlib.sha1(heads().cpu().numpy().tobytes()).hexdigest()}
        hr = out["heads"][f"B{B}"]
        print(f"  prenet at {B} rows: {out['prenet'][f'B{B}']['ms'] * 1e3:.2f} us (bound "
              f"{b_ms * 1e3:.3f} us); heads {hr['ms'] * 1e3:.2f} us (bound "
              f"{hb_ms * 1e3:.3f} us, plain {hr['plain_ms'] * 1e3:.2f} us, F.linear bf16 "
              f"{hr['library_ms'] * 1e3:.2f} us)")
    log["up_rows"] = out
    return out


CELL_SOURCE = {
    "lstm_cell": "tacotron2_tpu/ops/decoder_loop_pallas.py:347 (the gate products :469)",
    "lstm_cell_int8": "tacotron2_tpu/ops/decoder_loop_pallas.py:347 (int8 mode, :388-402, "
                      ":465-470)",
    "quantize_xh": "tacotron2_tpu/ops/decoder_loop_pallas.py:388 (_quantize_xh, int8 mode)",
}


def cell_row(name: str, cells: dict) -> dict:
    """The kernels line's row of a cell kernel from ``cell_rows``: its
    one-row numbers at the top, every row count under "rows"."""
    one = cells[name]["B1"]
    return {"name": name, "route": "cuda", "source": "tacotron2_tpu_torch/csrc/decode_step.cu",
            "replaces": CELL_SOURCE[name], **{k: one[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "eager_ms")},
            "per": {"lstm_cell": "both LSTM cells of one decode step, B=1, library: "
                                 "nn.LSTMCell x2, bf16",
                    "lstm_cell_int8": "both LSTM cells of one int8 decode step (their "
                                      "quantize_xh launches included), B=1, library: "
                                      "torch._int_mm (a yardstick)",
                    "quantize_xh": "both cells' inputs of one int8 decode step, B=1"}[name],
            "rows": cells[name]}


def cell_invariance(model, log: dict) -> None:
    """Fails the run unless each of CELL_INVARIANCE_ROWS of a 64-row launch
    of ``lstm_cell`` and of ``lstm_cell_int8`` (both cells) equals the same
    row computed alone, bit for bit: a row's gate sums must not depend on
    the rows that share its launch (the served batched-against-alone
    contract); the same for the last row of a CELL_TWO_PASSES-row launch,
    which also holds the kernel's second pass against the plain version.
    The same rows of a 64-row ``prenet`` launch against the rows alone, too
    (its cluster takes 8 rows a group)."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 31)
    result = {}
    pk = dl.pack_decoder(model.prenet, model.decoder, torch.bfloat16)
    tiled = {"wt": pk.wt_prenet} if hasattr(pk, "wt_prenet") else {}
    M, P = pk.wp1_t.shape
    mel = torch.randn(64, M, device="cuda", generator=g)
    m1, m2 = (m[0] for m in dl.prenet_masks(1, 64, P, model.cfg.dropout, g, mel.device))
    full = dl.prenet(mel, pk.wp1_t, pk.wp2_t, m1, m2, **tiled)
    for r in CELL_INVARIANCE_ROWS:
        one = lambda t: t[r:r + 1].contiguous()
        same = torch.equal(full[r:r + 1],
                           dl.prenet(one(mel), pk.wp1_t, pk.wp2_t, one(m1), one(m2), **tiled))
        result[f"prenet row {r}"] = same
        if not same:
            raise SmokeFailure(f"prenet: row {r} alone differs from the same row in a 64-row "
                               "launch")
    for quant in (False, True):
        pk = model.make_packed_decoder(quantize=quant)
        (kern_fn, _), cells = cell_args(dl, pk, 64, g)
        name = "lstm_cell_int8" if quant else "lstm_cell"
        nw = 3 if quant else 2  # the weights, then the row inputs
        for tag, (ka, _, kw) in zip(("att", "dec"), cells):
            full = kern_fn(*ka, **kw)
            for r in CELL_INVARIANCE_ROWS:
                row = (*ka[:nw], *(t[r:r + 1].contiguous() for t in ka[nw:]))
                alone = kern_fn(*row, **kw)
                same = all(torch.equal(x[r:r + 1], y) for x, y in zip(full, alone))
                result[f"{name}[{tag}] row {r}"] = same
                if not same:
                    raise SmokeFailure(f"{name}[{tag}]: row {r} alone differs from the same "
                                       "row in a 64-row launch")
        # past 64 rows the block runs a second pass over the weights: against the
        # plain version, and its last row against the same row alone
        (_, plain_fn), cells = cell_args(dl, pk, CELL_TWO_PASSES, g)
        r = CELL_TWO_PASSES - 1
        for tag, (ka, a, kw) in zip(("att", "dec"), cells):
            got = kern_fn(*ka, **kw)
            ref = plain_fn(*a)
            check(f"{name}[{tag}]@B{CELL_TWO_PASSES}", [("h", got[0], ref[0]),
                                                        ("c", got[1], ref[1])],
                  K5_TOL if quant else K1_TOL, log, name)
            row = (*ka[:nw], *(t[r:r + 1].contiguous() for t in ka[nw:]))
            same = all(torch.equal(x[r:r + 1], y) for x, y in zip(got, kern_fn(*row, **kw)))
            result[f"{name}[{tag}] row {r} of {CELL_TWO_PASSES}"] = same
            if not same:
                raise SmokeFailure(f"{name}[{tag}]: row {r} alone differs from the same row in "
                                   f"a {CELL_TWO_PASSES}-row launch")
    # the heads (vanilla): rows of a 64-row launch and the last row of an
    # 80-row one (two clusters) against the rows alone; the 80-row launch
    # against the plain version
    pk = dl.pack_decoder(model.prenet, model.decoder, torch.bfloat16)
    H, D = pk.wq.shape[1], pk.w_out.shape[1] - pk.wq.shape[1]
    hw = heads_copy(pk)
    for B, rows in ((64, CELL_INVARIANCE_ROWS), (CELL_TWO_PASSES, (CELL_TWO_PASSES - 1,))):
        rnn_h = torch.randn(B, H, device="cuda", generator=g)
        ctx = torch.randn(B, D, device="cuda", generator=g)
        full = dl.heads(pk.w_out, pk.b_out, rnn_h, ctx, **hw)
        if B == CELL_TWO_PASSES:
            check(f"heads@B{B}", [("mel_gate", full, dl.heads_plain(pk.w_out, pk.b_out, rnn_h,
                                                                     ctx))], K1_TOL, log, "heads")
        for r in rows:
            same = torch.equal(full[r:r + 1], dl.heads(pk.w_out, pk.b_out, rnn_h[r:r + 1],
                                                       ctx[r:r + 1], **hw))
            result[f"heads row {r} of {B}"] = same
            if not same:
                raise SmokeFailure(f"heads: row {r} alone differs from the same row in a {B}-row "
                                   "launch")
    log["cell_invariance"] = result
    print(f"  heads: rows {CELL_INVARIANCE_ROWS} of a 64-row launch and row "
          f"{CELL_TWO_PASSES - 1} of an {CELL_TWO_PASSES}-row one equal the rows alone, bit for "
          "bit")
    print(f"  prenet, lstm_cell / lstm_cell_int8: rows {CELL_INVARIANCE_ROWS} of a 64-row "
          f"launch (the cells' row {CELL_TWO_PASSES - 1} of an {CELL_TWO_PASSES}-row one) equal "
          "the rows alone, bit for bit; the two-pass launch within the one-step limits")


# ---------------------------------------------------------------------------
# the controls mode of K1 and K5: the controllable, multi-speaker configs
# ---------------------------------------------------------------------------

CTL_CONFIG = "controllable-lj-hifi-stop-speaker.json"  # 4 speakers, 5 controls, vanilla widths
CTL_SPEAKER = 2  # the say's voice
CTL_VALUES = "0.3,-0.5,0.1,0.8,-0.2"  # the say's controls
# controls of K5's one-step checks: larger than the state, so that they set
# the decoder cell's row scale (a kernel that left them out of it reads far
# above K5_TOL). Over 4 steps a rounding flip of one int8 quantum (the row's
# scale / 127) propagates, as in K5_CHUNK_TOL's readings, and a quantum is 3x
# larger at this scale: those readings are reported, and the 4-step limit
# holds at controls within +-1, the state's scale (PERF.md)
CTL_SCALE = 3.0
# the kernels line's rows of the controls mode -> their CONTROLS_LAUNCHES key
CTL_KERNELS = {"lstm_cell[controls]": "lstm_cell", "lstm_cell_int8[controls]": "lstm_cell_int8",
               "heads[controls]": "heads"}
CTL_SOURCE = {
    "lstm_cell[controls]": "tacotron2_tpu/ops/decoder_loop_pallas.py:534 (the decoder cell's "
                           "controls rows, bf16 mode)",
    "lstm_cell_int8[controls]": "tacotron2_tpu/ops/decoder_loop_pallas.py:534 (int8 mode, "
                                "_quantize_xh :388 over the controls too)",
    "heads[controls]": "tacotron2_tpu/ops/decoder_loop_pallas.py:569 (controls @ w_out[H + D:])",
}
CTL_PER = {
    "lstm_cell[controls]": "the decoder cell of one step with its controls, B=1, library: "
                           "nn.LSTMCell x1, bf16",
    "lstm_cell_int8[controls]": "the int8 decoder cell of one step with its controls (its "
                                "quantize_xh included), B=1, library: torch._int_mm (a yardstick)",
    "heads[controls]": "the heads of one step over [rnn_h | ctx | controls], B=1, library: "
                       "F.linear, bf16",
}


def row_controls(B: int, g, scale: float = 1.0, dim: int = 5):
    """Distinct controls for B rows, uniform in [-scale, scale], on the card."""
    import torch

    return (torch.rand(B, dim, device="cuda", generator=g) * 2 - 1) * scale


def ctl_model(seed: int = SEED):
    """The controllable config and its model on random weights from
    ``seed`` (gate forced positive), on the card."""
    from tacotron2_tpu_torch.config import load_config

    cfg = load_config(str(ROOT / "config" / CTL_CONFIG))
    return cfg, random_tacotron(cfg, 10.0, seed).cuda()


def library_ms(fn, log: dict, tag: str):
    """``time_ms`` of a library call, None where this torch build does not
    take its shapes."""
    try:
        return time_ms(fn)
    except Exception as e:
        log.setdefault("library_errors", []).append(f"{tag}: {e!r}")
        return None


def controls_cells(model, log: dict) -> dict:
    """The controls mode's launches alone at 1, 16 and 64 rows: the decoder
    cell with distinct controls per row (bf16: ``lstm_cell``; int8:
    ``quantize_xh`` + ``lstm_cell_int8``, the controls +-CTL_SCALE) and the
    heads with them, each held against its plain version (K1_TOL, K5_TOL;
    ``quantize_xh`` exactly) and timed by graph replay beside its plain
    version, its bound and a library call (``nn.LSTMCell`` x1 in bf16;
    ``torch._int_mm`` of the quantised rows against the int8 weights, a
    yardstick; ``F.linear`` in bf16). Then, failing the run otherwise: rows
    0, 1, 37 and 63 of a 64-row launch of each (distinct controls) equal the
    rows alone, bit for bit; the heads' gate logits under two control
    vectors equal bit for bit, their mels apart by far more than K1_TOL.
    -> {row name: {"B<rows>": {ms, plain_ms, bound_ms, bound_by,
    library_ms, eager_ms}}}"""
    import torch
    import torch.nn.functional as F

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 50)
    c = model.cfg
    H, D, M, E0 = c.rnn_hidden_dim, c.encoded_dim, c.num_mels, c.controls_dim
    bf = lambda t: t.to(torch.bfloat16)
    f32 = lambda *shape: torch.empty(*shape, device=dev)
    rn = lambda *shape: torch.randn(*shape, device=dev, generator=g) * 0.5
    out = {k: {} for k in CTL_KERNELS}

    def launches(pk, B, scale):
        """(kernel, plain, library, input tensors) of the pack's decoder
        cell at B rows, and the heads' (kernel, plain, library, inputs)."""
        att_h, ctx, rnn_h, rnn_c = rn(B, H), rn(B, D), rn(B, H), rn(B, H)
        c32, cbf = dl.stage_controls(pk, row_controls(B, g, scale, E0), B, dev)
        if pk.quantized:
            ins = (att_h, ctx, rnn_h, rnn_c)
            kern = lambda: dl.lstm_cell_int8(pk.w_dec, pk.s_dec, pk.b_dec, *ins, pk.wt_dec,
                                             ctl=c32)
            plain = lambda: dl.lstm_cell_int8_plain(pk.w_dec, pk.s_dec, pk.b_dec, *ins, c32)
            q, _ = dl.quantize_rows(torch.cat([att_h, ctx, c32, rnn_h], 1))
            qp = torch.zeros(max(32, -(-B // 8) * 8), q.shape[1], dtype=torch.int8, device=dev)
            qp[:B] = q.to(torch.int8)
            w_t = pk.w_dec.t()
            lib = lambda: torch._int_mm(qp, w_t)
            cell = (kern, plain, lib, (*ins, c32, pk.s_dec))
        else:
            ins = (bf(att_h), bf(ctx), bf(rnn_h), rnn_c)
            kern = lambda: dl.lstm_cell(pk.w_dec, pk.b_dec, *ins, pk.wt_dec, ctl=cbf)
            plain = lambda: dl.lstm_cell_plain(pk.w_dec, pk.b_dec, *(t.float() for t in ins[:3]),
                                               rnn_c, c32)
            mod = torch.nn.LSTMCell(H + D + E0, H, device=dev, dtype=torch.bfloat16)
            mod.load_state_dict(model.decoder.lstm.state_dict())
            x_lib, hc = bf(torch.cat([att_h, ctx, c32[:, :E0]], 1)), (ins[2], bf(rnn_c))
            cell = (kern, plain, lambda: mod(x_lib, hc), (*ins, cbf))
        hargs = (pk.w_out, pk.b_out, rnn_h, ctx)
        x_lin, b_lin = bf(torch.cat([rnn_h, ctx, c32], 1)), bf(pk.b_out)
        heads = (lambda: dl.heads(*hargs, c32, **heads_copy(pk)),
                 lambda: dl.heads_plain(*hargs, None, c32),
                 lambda: F.linear(x_lin, pk.w_out, b_lin), (rnn_h, ctx, c32))
        return cell, heads, (att_h, ctx, rnn_h, rnn_c, c32, cbf)

    packs = {q: model.make_packed_decoder(quantize=q) for q in (False, True)}
    for quant, pk in packs.items():
        name = "lstm_cell_int8[controls]" if quant else "lstm_cell[controls]"
        for B in K1_ROWS:
            (kern, plain, lib, ins), heads, (att_h, ctx, rnn_h, _, c32, _) = launches(
                pk, B, CTL_SCALE if quant else 1.0)
            got, ref = kern(), plain()
            check(f"{name}@B{B}", [("h", got[0], ref[0]), ("c", got[1], ref[1])],
                  K5_TOL if quant else K1_TOL, log, name)
            if quant:
                (qk, sk), (qq, sq) = (f(att_h, ctx, rnn_h, ctl=c32) for f in (
                    dl.quantize_xh, dl.quantize_xh_plain))
                check(f"quantize_xh[controls]@B{B}", [("q", qk.float(), qq.float()),
                                                      ("sx", sk, sq)], QUANT_TOL, log, name)
            b_ms, b_by = bound_ms(nbytes(pk.w_dec, pk.b_dec, *ins, f32(B, H), f32(B, H)),
                                  2 * B * pk.w_dec.numel(), card_peak("int8") if quant else card_peak("bf16"))
            out[name][f"B{B}"] = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "library_ms": library_ms(lib, log, f"{name}@B{B}"),
                                  "eager_ms": eager_ms(kern)}
            if not quant:  # the heads: one kernel for both packs (bf16 weights)
                hk, hp, hl, hins = heads
                check(f"heads[controls]@B{B}", [("mel_gate", hk(), hp())], K1_TOL, log,
                      "heads[controls]")
                hb_ms, hb_by = bound_ms(nbytes(pk.w_out, pk.b_out, *hins, f32(B, M + 1)),
                                        2 * B * pk.w_out.numel())
                out["heads[controls]"][f"B{B}"] = {
                    "ms": time_ms(hk), "plain_ms": time_ms(hp), "bound_ms": hb_ms,
                    "bound_by": hb_by, "library_ms": library_ms(hl, log, f"heads@B{B}"),
                    "eager_ms": eager_ms(hk)}
            r = out[name][f"B{B}"]
            lib_us = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f}"
            print(f"  {name} at {B} rows: {r['ms'] * 1e3:.1f} us, plain "
                  f"{r['plain_ms'] * 1e3:.1f} us, library {lib_us} us, bound "
                  f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
        # rows of a 64-row launch with distinct controls against the rows alone
        (kern, _, _, _), heads, (att_h, ctx, rnn_h, rnn_c, c32, cbf) = launches(
            pk, 64, CTL_SCALE if quant else 1.0)
        full, hfull = kern(), heads[0]()
        one = lambda t, r: t[r:r + 1].contiguous()
        for r in CELL_INVARIANCE_ROWS:
            if quant:
                alone = dl.lstm_cell_int8(pk.w_dec, pk.s_dec, pk.b_dec, one(att_h, r),
                                          one(ctx, r), one(rnn_h, r), one(rnn_c, r), pk.wt_dec,
                                          ctl=one(c32, r))
            else:
                alone = dl.lstm_cell(pk.w_dec, pk.b_dec, one(bf(att_h), r), one(bf(ctx), r),
                                     one(bf(rnn_h), r), one(rnn_c, r), pk.wt_dec,
                                     ctl=one(cbf, r))
            same = all(torch.equal(x[r:r + 1], y) for x, y in zip(full, alone))
            hsame = torch.equal(hfull[r:r + 1], dl.heads(pk.w_out, pk.b_out, one(rnn_h, r),
                                                         one(ctx, r), one(c32, r),
                                                         **heads_copy(pk)))
            log.setdefault("controls_invariance", {})[f"{name} row {r}"] = same
            log["controls_invariance"][f"heads[controls] ({'int8' if quant else 'bf16'} pack) "
                                       f"row {r}"] = hsame
            if not (same and hsame):
                raise SmokeFailure(f"{name} / heads[controls]: row {r} alone differs from the "
                                   "same row of a 64-row launch with distinct controls")
    # the heads with controls at CELL_TWO_PASSES rows (two clusters): against
    # the plain version, and the last row against the row alone
    pk = packs[False]
    B, r = CELL_TWO_PASSES, CELL_TWO_PASSES - 1
    rnn_h, ctx = rn(B, H), rn(B, D)
    c32 = dl.stage_controls(pk, row_controls(B, g, 1.0, E0), B, dev)[0]
    full = dl.heads(pk.w_out, pk.b_out, rnn_h, ctx, c32, **heads_copy(pk))
    check(f"heads[controls]@B{B}", [("mel_gate", full, dl.heads_plain(
        pk.w_out, pk.b_out, rnn_h, ctx, None, c32))], K1_TOL, log, "heads[controls]")
    same = torch.equal(full[r:r + 1], dl.heads(pk.w_out, pk.b_out, rnn_h[r:r + 1], ctx[r:r + 1],
                                               c32[r:r + 1], **heads_copy(pk)))
    log["controls_invariance"][f"heads[controls] row {r} of {B}"] = same
    if not same:
        raise SmokeFailure(f"heads[controls]: row {r} alone differs from the same row of a "
                           f"{B}-row launch")
    # the controls reach the mels, not the gate: the heads under two vectors
    rnn_h, ctx = rn(16, H), rn(16, D)
    a = row_controls(16, g, 2.0, E0)
    ha, hb = (dl.heads(pk.w_out, pk.b_out, rnn_h, ctx, dl.stage_controls(pk, v, 16, dev)[0],
                       **heads_copy(pk))
              for v in (a, -a))
    apart = err(ha[:, :M], hb[:, :M])[1]
    log["controls_heads"] = {"gate_bits_equal": torch.equal(ha[:, M], hb[:, M]),
                             "mel_rel_apart": apart}
    print(f"  heads[controls] under two control vectors: gate bit-equal "
          f"{log['controls_heads']['gate_bits_equal']}, mels apart by {apart:.3e} (rel)")
    if not log["controls_heads"]["gate_bits_equal"] or not apart > 100 * K1_TOL:
        raise SmokeFailure(f"heads[controls]: the gate must not read the controls and the mels "
                           f"must: {log['controls_heads']}")
    print(f"  controls mode: rows {CELL_INVARIANCE_ROWS} of 64-row launches with distinct "
          "controls equal the rows alone, bit for bit")
    log["controls_cells"] = out
    return out


def controls_phase(vanilla, L: int, log: dict) -> list:
    """K1's and K5's controls mode on random full-width weights of the
    controllable config: 1- and 4-step chunks through the chunk entry at 1,
    16 and 64 rows (row 1 padded where B > 1; distinct controls per row,
    +-CTL_SCALE for K5's one step) against the plain chunk (K1_TOL / K5_TOL
    for one step of one row, K1_CHUNK_TOL / K5_CHUNK_TOL for the rest:
    one step of many rows can carry a rounding flip of the query's bf16
    operand, 1.06e-4 on the context at 64 rows), with the defects' readings at one
    row (the controls left out; K5's row scale without them) held above the
    limits; K5's 4 steps at +-CTL_SCALE reported;
    two control vectors through a 4-step chunk (the mels apart by far more
    than K1_CHUNK_TOL); ``controls_cells``; and the 64-step one-row chunk,
    bf16 and int8, of ``vanilla`` and of the controllable model in turns
    (vanilla, controls, controls, vanilla). -> the kernels line's rows."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    dev = torch.device("cuda")
    _, model = ctl_model()
    E0 = model.cfg.controls_dim
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 51)
    packs = {q: model.make_packed_decoder(quantize=q) for q in (False, True)}
    for B in K1_ROWS:
        Lb = L if B == 1 else SERVE_L
        lengths = torch.full((B,), Lb, dtype=torch.int32, device=dev)
        if B > 1:
            lengths[1] = Lb - PAD
        for n in (1, 4):
            # one step of many rows may carry a rounding flip too (the query's
            # bf16 operand of the cell's h, which kernel and plain version sum
            # in other orders): there the 4-step limits hold
            flips = n > 1 or B > 1
            chunk_check(f"ctl_chunk[{n}]@B{B}", packs[False], model, lengths, n, g, log,
                        defect=B == 1 and n == 4, L=Lb, controls=row_controls(B, g, 1.0, E0),
                        kernel="lstm_cell[controls]", tol=K1_CHUNK_TOL if flips else K1_TOL)
            k5_check(f"ctl_int8_chunk[{n}]@B{B}", packs[True], model, lengths, n, g, log,
                     defect=B == 1 and n == 1, L=Lb,
                     controls=row_controls(B, g, CTL_SCALE if n == 1 else 1.0, E0),
                     kernel="lstm_cell_int8[controls]", tol=K5_CHUNK_TOL if flips else K5_TOL)
        # 4 int8 steps with controls of +-CTL_SCALE: a reading only
        log.setdefault("ctl_int8_chunk4_scale3", {})[f"B{B}"] = k5_check(
            f"ctl_int8_chunk[4,+-{CTL_SCALE:g}]@B{B}", packs[True], model, lengths, 4, g, log,
            L=Lb, controls=row_controls(B, g, CTL_SCALE, E0), kernel="reported", tol=math.inf)
    # two control vectors through the same 4 steps: the mels apart
    lengths = torch.full((16,), SERVE_L, dtype=torch.int32, device=dev)
    enc, att_enc, s = chunk_inputs(model, lengths, g, SERVE_L)
    m1, m2 = dl.prenet_masks(4, 16, model.cfg.prenet_dim, model.cfg.dropout, g, dev)
    a = row_controls(16, g, 2.0, E0)
    mga, mgb = (dl.decode_chunk(packs[False], enc, att_enc, lengths, s, m1, m2,
                                *dl.stage_controls(packs[False], v, 16, dev))[0] for v in (a, -a))
    apart = err(mga[..., :-1], mgb[..., :-1])[1]
    log["controls_chunk_apart"] = apart
    print(f"  ctl_chunk[4]@B16 under two control vectors: mels apart by {apart:.3e} (rel; tol "
          f"{K1_CHUNK_TOL:g})")
    if not apart > 10 * K1_CHUNK_TOL:
        raise SmokeFailure(f"the controls do not reach the mels: {apart:.3e}")
    cells = controls_cells(model, log)

    # the prediction: the controllable one-row chunk within ~1 us a step of the vanilla one
    lengths = torch.full((1,), L, dtype=torch.int32, device=dev)
    cases = {}
    for tag, m in (("vanilla", vanilla), ("controls", model)):
        for q in (False, True):
            pk = m.make_packed_decoder(quantize=q)
            enc, att_enc, s = chunk_inputs(m, lengths, g, L)
            m1, m2 = dl.prenet_masks(64, 1, m.cfg.prenet_dim, m.cfg.dropout, g, dev)
            ctl = (dl.stage_controls(pk, row_controls(1, g, 1.0, E0), 1, dev)
                   if tag == "controls" else ())
            cases[f"{tag}_{'int8' if q else 'bf16'}"] = (
                lambda pk=pk, a=(enc, att_enc, lengths, s, m1, m2, *ctl): dl.decode_chunk(pk, *a))
    turns: dict = {k: [] for k in cases}
    for order in (("vanilla", "controls"), ("controls", "vanilla")):
        for tag in order:
            for mode in ("bf16", "int8"):
                turns[f"{tag}_{mode}"].append(time_ms(cases[f"{tag}_{mode}"], 5, 1) / 64 * 1e3)
    log["controls_chunk_us_per_step"] = turns
    print("  64-step one-row chunk, us a step, in turns (vanilla, controls, controls, vanilla): "
          + "; ".join(f"{k} " + " / ".join(f"{x:.2f}" for x in v) for k, v in turns.items()))
    rows = []
    for name in CTL_KERNELS:
        one = cells[name]["B1"]
        rows.append({"name": name, "route": "cuda",
                     "source": "tacotron2_tpu_torch/csrc/decode_step.cu",
                     "replaces": CTL_SOURCE[name], **{k: one[k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "eager_ms")},
                     "per": CTL_PER[name], "rows": cells[name]})
    del model, packs
    torch.cuda.empty_cache()
    return rows


def serve_rows_split(model, cfg, log: dict) -> dict:
    """Where a serve window's decode goes, per pack (bf16: K1; int8: K5):
    the device ms of each kernel in one 64-frame ``decode_chunk`` at 16 and
    64 rows, L=128 (torch.profiler), the chunk's device time per step (graph
    replay, and eagerly: the host's launches included; also at one row and
    the say's chars), and the window's decode (encoder at 64
    rows, 256 steps, postnet) through ``forward_infer_fast`` on the waves'
    texts, eager, ending in a sync (``serve_split``'s measure). Each chunk's
    output digest goes to the log, so that ``--k1-ab`` can tell whether the
    parent's kernels gave the same bits on the same inputs."""
    import hashlib

    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl
    from tacotron2_tpu_torch.text import normalize_text

    dev = torch.device("cuda")
    c = model.cfg
    prep = cfg.dataset.preprocessing
    say_chars = len(normalize_text(TEXT, prep.allowed_chars, prep.end_token, False))
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 32)
    out = {}
    for quant in (False, True):
        pk = model.make_packed_decoder(quantize=quant)
        mode = "int8" if quant else "bf16"
        for B in K1_ROWS:
            L = SERVE_L if B > 1 else say_chars
            ci, lengths = serve_batch(cfg, B, dev)
            if B == 1:
                lengths = torch.full((1,), L, dtype=torch.int32, device=dev)
            enc, att_enc, s = chunk_inputs(model, lengths, g, L)
            m1, m2 = dl.prenet_masks(64, B, c.prenet_dim, c.dropout, g, dev)
            chunk = lambda: dl.decode_chunk(pk, enc, att_enc, lengths, s, m1, m2)
            mg, al, _ = chunk()
            r = {"L": L, "chunk_us_per_step": time_ms(chunk, 5, 1) / 64 * 1e3,
                 "chunk_eager_us_per_step": eager_ms(chunk, 5) / 64 * 1e3,
                 # the same inputs in every turn of --k1-ab: equal bits?
                 "chunk_sha1": hashlib.sha1(mg.cpu().numpy().tobytes()
                                            + al.cpu().numpy().tobytes()).hexdigest()}
            r["split_us_per_step"] = {k: v / 64 * 1e3 for k, v in kernel_split(chunk).items()}
            if B > 1:
                gens = [torch.Generator(device=dev).manual_seed(i) for i in range(B)]
                r["window_decode_ms"] = eager_ms(lambda: model.forward_infer_fast(
                    ci, lengths, 256, packed=pk, row_generators=gens, encode_rows=64), 3)
            out[f"{mode}_B{B}"] = r
            print(f"  {mode} decode at {B} rows, L={L}: chunk {r['chunk_us_per_step']:.1f} us a "
                  "step" + ("" if B == 1 else
                            f", window decode {r['window_decode_ms']:.1f} ms")
                  + "; per step: " + ", ".join(f"{k} {v:.1f}"
                                               for k, v in r["split_us_per_step"].items()))
    log["serve_rows_split"] = out
    return out


# cell_ab's copies of csrc/decode_step.cu, each (name, pattern, replacement):
# the source; then the prenet's cluster taking 16 rows a group (half the
# clusters at 64 rows); the heads launched without programmatic dependent
# launch (the source issues their weight copy while the decoder cell ends);
# the heads' contraction split over a cluster of 4 or 16, not 8. The chunk's prenet launched with programmatic
# dependent launch, the heads' early start of it, 32 rows a group and
# GC_PREFETCH (the cells' weight chunks streamed before their wait) were
# measured the same way (PERF.md).
CELL_AB = (
    ("source", None, None),
    ("prenet_rows16", r"constexpr int PN_THREADS = 256;", "constexpr int PN_THREADS = 512;"),
    ("heads_no_pdl", r"constexpr bool HD_PDL = true;", "constexpr bool HD_PDL = false;"),
    ("heads_s4", r"constexpr int HD_S = 8;", "constexpr int HD_S = 4;"),
    ("heads_s16", r"constexpr int HD_S = 8;", "constexpr int HD_S = 16;"),
)
CELL_AB_OTHER_SUMS = {"heads_s4", "heads_s16"}  # sums in another order: bits not held


def cell_ab(model, log: dict) -> dict:
    """The decode step's design A/B on source copies: ``csrc/decode_step.cu``
    built under build/cell_ab/ once per CELL_AB entry, each bound in turn as
    ``decoder_loop._LIB``. Per copy, by graph replay: a 64-frame
    ``decode_chunk`` per step (the main path), both cells alone
    (``cell_args``) and the prenet's one-kernel entry, bf16 and int8 packs,
    at 1, 16 and 64 rows (L=128); the copies in turns, two rounds, the
    second in reverse order; the heads alone too. The chunks' outputs must
    equal the source's bit for bit (no variant changes a result; the run
    fails otherwise)."""
    import ctypes
    import re

    import torch

    from tacotron2_tpu_torch.ops import build
    from tacotron2_tpu_torch.ops import decoder_loop as dl

    csrc = Path(dl.__file__).parents[1] / "csrc"
    src = (csrc / "decode_step.cu").read_text()
    out_dir = ROOT / "build" / "cell_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, pattern, repl in CELL_AB:
        text = src
        if pattern is not None:
            text, n = re.subn(pattern, repl, src)
            if n != 1:
                raise SmokeFailure(f"cell_ab: {pattern!r} matches {n} times in "
                                   "csrc/decode_step.cu, want once")
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SmokeFailure(f"cell_ab: nvcc of the {name} copy failed: {text[-2000:]}")
        libs[name] = dl.bind(ctypes.CDLL(str(out_dir / f"lib{name}.so")))
    dev = torch.device("cuda")
    c = model.cfg
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 33)
    packs = {q: model.make_packed_decoder(quantize=q) for q in (False, True)}
    cases = []  # (key, chunk, cells, prenet)
    for q, pk in packs.items():
        for B in K1_ROWS:
            lengths = torch.full((B,), SERVE_L, dtype=torch.int32, device=dev)
            enc, att_enc, s = chunk_inputs(model, lengths, g, SERVE_L)
            m1, m2 = dl.prenet_masks(64, B, c.prenet_dim, c.dropout, g, dev)
            (kern_fn, _), cells = cell_args(dl, pk, B, g)
            pre = (s.mel, pk.wp1_t, pk.wp2_t, m1[0], m2[0], pk.wt_prenet)
            hd = (pk.w_out, pk.b_out, s.rnn_h, s.ctx)
            cases.append((f"{'int8' if q else 'bf16'}_B{B}",
                          lambda pk=pk, a=(enc, att_enc, lengths, s, m1, m2):
                          dl.decode_chunk(pk, *a),
                          lambda f=kern_fn, cs=cells: [f(*ka, **kw) for ka, _, kw in cs],
                          lambda a=pre: dl.prenet(*a),
                          lambda a=hd, pk=pk: dl.heads(*a, **heads_copy(pk))))
    saved = dl._LIB
    out: dict = {}
    first: dict = {}
    names = [n for n, _, _ in CELL_AB]
    try:
        for order in (names, names[::-1]):
            for name in order:
                dl._LIB = libs[name]
                for key, chunk, cells, pre, hd in cases:
                    mg, al, _ = chunk()
                    if name in CELL_AB_OTHER_SUMS:
                        pass
                    elif key in first and not (torch.equal(mg, first[key][0])
                                               and torch.equal(al, first[key][1])):
                        raise SmokeFailure(f"cell_ab: the {key} chunk differs in the {name} copy")
                    else:
                        first.setdefault(key, (mg, al))
                    r = out.setdefault(f"{name}_{key}", {"chunk_us": [], "cells_us": [],
                                                         "prenet_us": [], "heads_us": []})
                    r["chunk_us"].append(time_ms(chunk, 5, 1) / 64 * 1e3)
                    r["cells_us"].append(time_ms(cells) * 1e3)
                    r["prenet_us"].append(time_ms(pre) * 1e3)
                    r["heads_us"].append(time_ms(hd) * 1e3)
    finally:
        dl._LIB = saved
    for k, v in out.items():
        print(f"  {k}: chunk " + " / ".join(f"{x:.1f}" for x in v["chunk_us"])
              + " us a step, both cells alone " + " / ".join(f"{x:.1f}" for x in v["cells_us"])
              + " us, prenet alone " + " / ".join(f"{x:.2f}" for x in v["prenet_us"])
              + " us, heads alone " + " / ".join(f"{x:.2f}" for x in v["heads_us"]) + " us")
    log["cell_ab"] = out
    return out


def k1_rows_mode(out_name: str) -> int:
    """``--k1-rows``: build K1/K5 and K2 only, then ``up_rows``, ``cell_rows``,
    ``cell_invariance`` and ``serve_rows_split`` on random full-width
    weights, and where the package has the controls mode ``controls_phase``;
    the results go to
    chiprun_out/<out_name>. Runs the package found first on sys.path (the
    repo's, or a parent's with ``--root``)."""
    import torch

    from tacotron2_tpu_torch import ops
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
    from tacotron2_tpu_torch.models.layers import Policy, use_f32_math
    from tacotron2_tpu_torch.ops import build
    from tacotron2_tpu_torch.text import normalize_text

    use_f32_math()
    t0 = time.perf_counter()
    logs = build.build_all(["encoder_lstm"] if "--enc-ab" in sys.argv[1:]
                           else ["decode_step", "mrf", "encoder_lstm"])
    log: dict = {"card": card_line(), "package": str(Path(ops.__file__).parents[1]),
                 "build_s": time.perf_counter() - t0,
                 "ptxas": {k: ptxas_kernels(v) for k, v in logs.items()}}
    print(f"[k1-rows] {log['package']} on {log['card']}")
    cfg = load_config(str(ROOT / "config" / "vanilla-ljspeech-stop.json"))
    model = random_tacotron(cfg, 10.0).cuda()
    torch.manual_seed(SEED + 1)
    hifigan = HiFiGAN(HiFiGANConfig.from_dict(UNIVERSAL_V1),
                      Policy(torch.bfloat16)).cuda().eval()  # K2's bf16 mode
    Tb = -(-(255 + hifigan.mel_receptive_field()) // 128) * 128  # the say's bucket
    try:
        if "--enc-ab" in sys.argv[1:]:  # the encoder's recurrence alone
            enc_rows(model, cfg, log)
            enc_bwd_rows(model, cfg, log)
            enc_ab(model, cfg, log)
        else:
            up_rows(model, hifigan, Tb, log)
            log["cells"] = cell_rows(model, log)
            cell_invariance(model, log)
            serve_rows_split(model, cfg, log)
            enc_rows(model, cfg, log)
            enc_bwd_rows(model, cfg, log)
            from tacotron2_tpu_torch.ops import decoder_loop as dl

            if hasattr(dl, "stage_controls"):  # a package with the controls mode
                prep = cfg.dataset.preprocessing
                controls_phase(model, len(normalize_text(TEXT, prep.allowed_chars,
                                                         prep.end_token, False)), log)
            if "--cell-ab" in sys.argv[1:]:
                cell_ab(model, log)
    except SmokeFailure as e:
        log["failure"] = str(e)
        print(f"FAIL: {e}", file=sys.stderr)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out_name).write_text(json.dumps(log, indent=1, default=str))
    return 1 if "failure" in log else 0


def stage_kernel(rbs) -> str:
    """The K2 kernel that runs a stage's resblocks: ``mrf_pair`` where it
    takes the stage's ResBlock1 pairs, else ``mrf_conv``; ``_f32`` added for
    f32 weights (K2's f32 mode)."""
    import torch

    from tacotron2_tpu_torch.ops import mrf

    fused = any(mrf.pair_fusable(c1, c2) for rb in rbs for c1, c2 in rb)
    sfx = "_f32" if rbs[0][0][0].w.dtype == torch.float32 else ""
    return ("mrf_pair" if fused else "mrf_conv") + sfx


def k2_phase(hifigan, log: dict, frames: int) -> None:
    """Each UNIVERSAL_V1 stage over ``frames`` mel frames, kernels against
    plain: ``conv_pre`` (``conv_pre_check``; a row alone against the same
    row in a batch of ``K2_INVARIANCE_ROWS``, bit for bit), the upsample and
    its operand on the operand of the stage input, the stage's first conv (or fused
    pair) alone on that operand, then the whole stage, and the stage mean's
    operand as the next upsample reads it (exactly ``operand`` of the
    kernels' f32 mean). Bitwise checks fail the run: the upsample and the
    first conv or pair of a row alone against the same row in a batch of
    ``K2_INVARIANCE_ROWS`` (other tiles, and at one row narrower N tiles),
    a fused pair against its two ``mrf_conv`` launches, and the mean's
    operand."""
    import torch

    from tacotron2_tpu_torch.models import layers
    from tacotron2_tpu_torch.ops import mrf

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    bf = torch.bfloat16
    mel = torch.randn(1, frames, hifigan.cfg.num_mels, device="cuda", generator=g)
    n = K2_INVARIANCE_ROWS - 1
    a0 = conv_pre_check(hifigan, mel, log, str(frames))
    mel_b = torch.cat([mel, torch.randn(n, *mel.shape[1:], device="cuda", generator=g)])
    if not torch.equal(mrf.conv_pre(mel_b.to(bf), hifigan.conv_pre_weights())[:1], a0):
        raise SmokeFailure(f"conv_pre@{frames}: a row alone differs from the same row in a "
                           f"batch of {n + 1}")
    del mel_b
    x = layers.conv1d(mel, hifigan.conv_pre.weight, hifigan.conv_pre.bias, hifigan.policy,
                      padding=3, round_out=True)
    plain = mrf.plain_stage
    for i, (rbs, ups) in enumerate(hifigan.kernel_weights()):
        x = x.contiguous()
        a = mrf.operand(x, bf)
        xu, au = mrf.conv_transpose_plain(a, ups, want_act=True)
        yk, ak = mrf.conv_transpose(a, ups, want_act=True)
        check(f"conv_transpose[{i}]@{frames}", [("out", yk, xu), ("act", ak, au)],
              K2_TOL, log, "conv_transpose")
        a_b = torch.cat([a, mrf.operand(torch.randn(n, *a.shape[1:], device="cuda",
                                                    generator=g), bf)])
        if not all(torch.equal(k, bo[:1]) for k, bo in zip(
                (yk, ak), mrf.conv_transpose(a_b, ups, want_act=True))):
            raise SmokeFailure(f"conv_transpose[{i}]@{frames}: a row alone differs from the "
                               f"same row in a batch of {n + 1}")
        del a_b
        name = stage_kernel(rbs)
        c1, c2 = rbs[0][0]
        xu, au = xu.contiguous(), au.contiguous()
        one = ((lambda f, a, r: f(a, c1, c2, res=r, want_act=True)) if name == "mrf_pair" else
               (lambda f, a, r: f(a, c1, want_act=True)))
        k_out = one(mrf.mrf_pair if name == "mrf_pair" else mrf.mrf_conv, au, xu)
        p_out = one(mrf.mrf_pair_plain if name == "mrf_pair" else mrf.mrf_conv_plain, au, xu)
        check(f"{name}[{i}]@{frames}", [("y", k_out[0], p_out[0]), ("act", k_out[1], p_out[1])],
              K2_TOL, log, name)
        a_b = torch.cat([au, mrf.operand(torch.randn(n, *au.shape[1:], device="cuda",
                                                     generator=g), bf)])
        r_b = torch.cat([xu, torch.randn(n, *xu.shape[1:], device="cuda", generator=g)])
        b_out = one(mrf.mrf_pair if name == "mrf_pair" else mrf.mrf_conv, a_b, r_b)
        if not all(torch.equal(k[0], bo[0]) for k, bo in zip(k_out[:2], b_out[:2])):
            raise SmokeFailure(f"{name}[{i}]@{frames}: a row alone differs from the same row "
                               f"in a batch of {n + 1}")
        del a_b, r_b, b_out
        if name == "mrf_pair":
            acc = torch.randn(xu.shape, device="cuda", generator=g)
            fused = mrf.mrf_pair(au, c1, c2, xu, acc, 0.25, True, True)
            _, at, _ = mrf.mrf_conv(au, c1, want_y=False, want_act=True)
            unfused = mrf.mrf_conv(at, c2, xu, acc, 0.25, True, True)
            if not all(torch.equal(f, u) for f, u in zip(fused, unfused)):
                raise SmokeFailure(f"mrf_pair[{i}]@{frames}: the fused pair differs from its "
                                   f"two mrf_conv launches")
        got, ref = mrf.mrf_stage(x, rbs, ups), plain(x, rbs, ups)
        check(f"mrf_stage[{i}]@{frames}", [("out", got, ref)], K2_TOL, log, name)
        a_next = mrf.mrf_stage(x, rbs, ups, want_operand=True)
        if not torch.equal(a_next, mrf.operand(got, bf)):
            raise SmokeFailure(f"mrf_stage[{i}]@{frames}: the mean's operand differs from the "
                               "operand of the f32 mean")
        if i == 2:  # row 3 of the TPU table: the MRF without its upsample
            check(f"mrf_stage[2,no_ups]@{frames}",
                  [("out", mrf.mrf_stage(xu, rbs), plain(xu, rbs, None))], K2_TOL, log, name)
        x = ref


def narrow_ops(co_ci: tuple, flops: float, f32: bool) -> tuple:
    """(operations, peak) of a narrow-kernel launch from Ci to Co channels
    (``co_ci`` = (Co, Ci)): on the tensor-core route (``mrf.narrow_mma``;
    a package without it, a parent's, runs every narrow shape on the CUDA
    cores) three TF32 passes at the TF32 peak in f32 mode, the flops at the
    bf16 peak in bf16 mode; on the CUDA cores (FFMA) the flops at the FP32
    peak in f32 mode, at the bf16 peak in bf16 mode (the function's type)."""
    from tacotron2_tpu_torch.ops import mrf

    tc = getattr(mrf, "narrow_mma", lambda Co, Ci: False)(*co_ci)
    if not f32:
        return flops, card_peak("bf16")
    return (3 * flops, card_peak("tf32")) if tc else (flops, card_peak("f32"))


def k2_timing(hifigan, Tb: int, rows_b: int = 1, plain: bool = True,
              plain_reps: tuple = (5, 4), fuse_pairs: bool = True) -> list:
    """Time every K2 call of one vocode of ``Tb`` frames at ``rows_b`` rows,
    summed per kernel: the kernel; the library convs (``F.conv1d`` /
    ``F.conv_transpose1d`` in f32 with TF32 off on the operands the kernel
    reads, the same function without the epilogue, two of them for a fused
    pair, and in bf16, whose output is bf16); and with ``plain`` the plain
    version and the eager call (without it, ``plain_ms`` and ``eager_ms`` are
    None: not measured).

    The bound is that of the function the TPU kernels compute, one whole
    stage: its input read once, its weights, its output written once, and
    its flops; a stage's share goes to each kernel by its share of the
    stage's flops. ``conv_transpose`` is given its input operand, its
    weights, its outputs (f32 and operand) and the transposed conv's flops
    (not the folded conv's zero taps); ``conv_pre`` its own: the bf16 mel,
    its weights, its bf16 operand out and its flops (library: cuDNN's
    ``F.conv1d`` over the same operands). The vocode runs as ``HiFiGAN.apply``
    does: stage 1's operand by ``conv_pre``, each later stage's from the
    mean of the one before.
    The activations this one-launch-per-conv design writes and
    reads between launches (the bf16 operands, the f32 residual stream and
    stage mean) are the design's cost, reported beside the bound as
    ``traffic_ms`` (those bytes over the HBM rate).

    A generator built under F32 times K2's f32 mode (rows ``<entry>_f32``,
    ``csrc/mrf_f32.cu``): f32 operands, no bf16 library call, and the bound's
    operations taken as three TF32 passes (3 x flops at the dense TF32 peak,
    the tensor cores' route to f32-exact products), with flops at the CUDA
    cores' FP32 peak beside it (``cuda_core_ms``); ``plain_reps`` the plain
    version's repeats. At 64 rows every timing takes one warm-up call.

    Calls at the shapes the wide kernels do not take are the narrow
    kernel's (``csrc/mrf_narrow.cu``; rows ``narrow_conv``, ``narrow_pair``,
    ``narrow_transpose``, ``mrf.launch_key``): each launch's bound is its
    own, max(every byte it must read and write -- operand, weight copy,
    bias, ``res``, ``acc_in``, ``y``, ``act``, ``acc_out``, each once --
    over the HBM rate, its flops (a transposed conv's, not the fold's zero
    taps) over its route's peak, ``narrow_ops``), summed over the launches.
    ``fuse_pairs`` False: every ResBlock1
    pair as two ``mrf_conv`` launches (``run_stage`` without its pair
    call), as the narrow kernel's ``narrow_conv`` is timed."""
    import torch
    import torch.nn.functional as F

    from tacotron2_tpu_torch.models import layers
    from tacotron2_tpu_torch.ops import mrf

    calls = []

    def key(name, cw):  # the kernels-line row of a call (no _f32: added below)
        return mrf.launch_key(name, cw).removesuffix("_f32")

    def conv_hook(a, cw, res=None, acc=None, acc_scale=0.0, want_y=True, want_act=False,
                  acc_act=False):
        calls.append(("mrf_conv", a, (cw,), res, acc, acc_scale, want_y, want_act, acc_act))
        return mrf.mrf_conv(a, cw, res, acc, acc_scale, want_y, want_act, acc_act)

    def pair_hook(a, c1, c2, res=None, acc=None, acc_scale=0.0, want_y=True, want_act=False,
                  acc_act=False):
        calls.append(("mrf_pair", a, (c1, c2), res, acc, acc_scale, want_y, want_act, acc_act))
        return mrf.mrf_pair(a, c1, c2, res, acc, acc_scale, want_y, want_act, acc_act)

    def convt_hook(a, uw, want_act=False):
        if uw.folded is not None:  # else JAX's XLA route on stock ops: no kernel
            calls.append(("conv_transpose", a, uw, want_act))
        return mrf.conv_transpose(a, uw, want_act)

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    mel = torch.randn(rows_b, Tb, hifigan.cfg.num_mels, device="cuda", generator=g)
    names = tuple(mrf.LAUNCHES)
    tot = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "library_bf16_ms": 0.0,
               "bound_ms": 0.0, "eager_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
               "traffic_ms": 0.0, "cuda_core_ms": 0.0, "calls": 0} for n in names}
    kw = hifigan.kernel_weights()
    cwp = hifigan.conv_pre_weights()
    dt = hifigan.policy.compute_dtype
    f32 = dt == torch.float32
    es = torch.empty(0, dtype=dt).element_size()  # an operand's bytes
    a_mel = mel.to(dt)
    calls.append(("conv_pre", a_mel))
    a = mrf.conv_pre(a_mel, cwp)
    K, Co, Ci = cwp.w.shape
    parts0 = {key("conv_pre", cwp): (nbytes(a_mel, cwp.w, cwp.b, a),
                                     2 * rows_b * Tb * Co * Ci * K)}

    def time_calls():  # the calls made so far, then dropped (a stage's operands at a time)
        torch.cuda.synchronize()
        big = rows_b > 1  # fewer repeats at the serve windows' sizes
        warm = 1 if rows_b >= 64 else 3  # and one warm-up call at 64 rows
        bf = torch.bfloat16
        for call in calls:
            name, x = call[0], call[1]
            if name in ("mrf_conv", "mrf_pair"):
                _, a, cws, res, acc, s, want_y, want_act, acc_act = call
                fn = mrf.mrf_conv if name == "mrf_conv" else mrf.mrf_pair
                pfn = mrf.mrf_conv_plain if name == "mrf_conv" else mrf.mrf_pair_plain
                kern = lambda: fn(a, *cws, res, acc, s, want_y, want_act, acc_act)
                plain_fn = lambda: pfn(a, *cws, res, acc, s, want_y, want_act, acc_act)
                # the library's inputs: the operand of each conv (for a pair, the
                # plain first conv's output operand), channels first
                ops_in = [a] if len(cws) == 1 else [a, mrf.mrf_conv_plain(a, cws[0], want_y=False,
                                                                           want_act=True)[1]]
                lib_args = []
                for cw, op in zip(cws, ops_in):
                    Kt = cw.w.shape[0]
                    xt = op.transpose(1, 2).contiguous()
                    wt = cw.w.permute(1, 2, 0).contiguous()
                    lib_args.append((xt, wt, cw.b, cw.b.to(bf), cw.dilation * (Kt - 1) // 2,
                                     cw.dilation))
                lib32 = [(xt.float(), wt.float(), b, p, d) for xt, wt, b, _, p, d in lib_args]
                lib = lambda: [F.conv1d(xt, wt, b, padding=p, dilation=d)
                               for xt, wt, b, p, d in lib32]
                lib_bf16 = lambda: [F.conv1d(xt, wt, b16, padding=p, dilation=d)
                                    for xt, wt, _, b16, p, d in lib_args]
                Co = cws[-1].w.shape[1]
                n_out = a.shape[0] * a.shape[1] * Co
                nb = (nbytes(a, *(cw.wt for cw in cws), *(cw.b for cw in cws), res, acc)
                      + n_out * (4 * want_y + es * want_act + (s != 0.0) * (es if acc_act else 4)))
                w_shape = list(cws[0].w.shape)
                fl_call = 2 * a.shape[0] * a.shape[1] * sum(cw.w.numel() for cw in cws)
                co_ci = tuple(w_shape[1:])
                t = tot[key(name, cws[0])]
            elif name == "conv_transpose":
                _, x, uw, want_act = call  # x: the input operand
                Kt, _, Co = uw.w.shape
                kern = lambda: mrf.conv_transpose(x, uw, want_act)
                plain_fn = lambda: mrf.conv_transpose_plain(x, uw, want_act)
                xt = x.transpose(1, 2).contiguous()
                xt32, wt = xt.float(), uw.w.permute(1, 2, 0).contiguous()
                wt32 = wt.float()
                lib = lambda: F.conv_transpose1d(xt32, wt32, uw.b, stride=uw.stride,
                                                 padding=uw.padding)
                b16 = uw.b.to(bf)
                lib_bf16 = lambda: F.conv_transpose1d(xt, wt, b16, stride=uw.stride,
                                                      padding=uw.padding)
                Tout = x.shape[1] * uw.stride
                nb = (nbytes(x, uw.folded.wt, uw.folded.b)
                      + x.shape[0] * Tout * Co * (4 + es * want_act))
                w_shape = list(uw.w.shape)
                fl_call = 2 * x.shape[0] * Tout * Co * x.shape[2] * (Kt // uw.stride)
                co_ci = tuple(uw.folded.w.shape[1:])
                t = tot[key(name, uw.folded)]
            else:  # conv_pre, from the bf16 mel x
                kern = lambda: mrf.conv_pre(x, cwp)
                plain_fn = lambda: mrf.conv_pre_plain(x, cwp)
                xt = x.transpose(1, 2).contiguous()
                wt = cwp.w.permute(1, 2, 0).contiguous()
                xt32, wt32, b16 = xt.float(), wt.float(), cwp.b.to(bf)
                Kp = cwp.w.shape[0]
                lib = lambda: F.conv1d(xt32, wt32, cwp.b, padding=Kp // 2)
                lib_bf16 = lambda: F.conv1d(xt, wt, b16, padding=Kp // 2)
                nb = nbytes(x, cwp.wt, cwp.b) + x.shape[0] * x.shape[1] * cwp.w.shape[1] * es
                w_shape = list(cwp.w.shape)
                fl_call = 2 * x.shape[0] * x.shape[1] * cwp.w.numel()
                co_ci = tuple(w_shape[1:])
                t = tot[key(name, cwp)]
            reps = ((1, 2) if rows_b >= 64 else (2, 2)) if big else (5, 4)
            ms = time_ms(kern, *reps, warm)
            traffic_ms = nb / card_peak("bytes") * 1e3
            t.setdefault("per_call", []).append({"x": list(x.shape), "w": w_shape, "ms": ms,
                                                 "traffic_ms": traffic_ms})
            t["ms"] += ms
            if lib is not None:
                t["library_ms"] += time_ms(lib, *reps, warm)
                if not f32:
                    t["library_bf16_ms"] += time_ms(lib_bf16, *reps, warm)
            if plain:
                t["plain_ms"] += time_ms(plain_fn, *plain_reps, warm)
                t["eager_ms"] += eager_ms(kern, 2 if rows_b >= 64 else 5, warm)
            t["traffic_ms"] += traffic_ms
            if not mrf.wide(*co_ci):  # the narrow kernel: this launch's own bound
                ops, peak = narrow_ops(co_ci, fl_call, f32)
                t["bound_ms"] += bound_ms(nb, ops, peak)[0]
                t["bytes_ms"] += traffic_ms
                t["ops_ms"] += ops / peak * 1e3
                t["cuda_core_ms"] += fl_call / card_peak("f32") * 1e3
            t["calls"] += 1
        calls.clear()

    for i, (rbs, ups) in enumerate(kw):
        ain = a
        first = len(calls)
        last = i == len(kw) - 1
        out = mrf.run_stage(None, rbs, ups, conv_hook, convt_hook,
                            pair_hook if fuse_pairs else None, a, not last)
        y = out
        a = None if last else out
        Bn, T, Co = y.shape
        convs = [cw for rb in rbs for pair in rb for cw in pair if cw is not None]
        fl_stage = sum(2 * Bn * T * cw.w.numel() for cw in convs)
        nb_stage = nbytes(y, *(cw.w for cw in convs), *(cw.b for cw in convs))
        fl_by = {}
        for c in calls[first:]:
            if c[0] in ("mrf_conv", "mrf_pair"):
                k = key(c[0], c[2][0])
                fl_by[k] = fl_by.get(k, 0) + sum(2 * Bn * T * cw.w.numel() for cw in c[2])
        parts = {} if ups.folded is None else {key("conv_transpose", ups.folded): (
            nbytes(ain, ups.w, ups.b) + Bn * T * Co * (4 + es),
            2 * Bn * T * Co * ain.shape[2] * (ups.w.shape[0] // ups.stride))}
        if i == 0:
            parts.update(parts0)
        for n, fl in fl_by.items():
            if fl:
                parts[n] = (nb_stage * fl / fl_stage, fl)
        for name, (nb, fl) in parts.items():
            t = tot[name]
            if name.startswith("narrow"):  # bound per launch in time_calls
                continue
            ops, peak = (3 * fl, card_peak("tf32")) if f32 else (fl, card_peak("bf16"))
            t["bound_ms"] += bound_ms(nb, ops, peak)[0]
            t["bytes_ms"] += nb / card_peak("bytes") * 1e3
            t["ops_ms"] += ops / peak * 1e3
            t["cuda_core_ms"] += fl / card_peak("f32") * 1e3
        time_calls()
    rows = []
    # the wrappers replace the on-path stage kernels (u=8 :312, u=2 :378);
    # the MRF without its upsample (:285) runs on mrf_conv / mrf_pair alone
    narrow_where = ("tacotron2_tpu/ops/mrf_pallas.py:285,378 (the stage kernels at C = 16 "
                    "and 8: the phase fold s = 128 / C, :440 and :516-517)")
    replaces = {"conv_transpose": "tacotron2_tpu/ops/mrf_pallas.py:312,378 (the upsample of "
                                  "the u=8 and u=2 stage kernels)",
                "narrow_conv": narrow_where, "narrow_pair": narrow_where,
                "narrow_transpose": "tacotron2_tpu/ops/mrf_pallas.py:378 (the u=2 stage "
                                    "kernel's upsample to C = 8: its aligned fold, :516-517)",
                "conv_pre": "tacotron2_tpu/models/hifigan.py:366 (conv_pre, XLA's conv under "
                            "the bf16 policy) and tacotron2_tpu/ops/mrf_pallas.py:312 (the u=8 "
                            "stage kernel's lrelu of its input)"}
    for name in names:
        t = tot[name]
        if not t["calls"]:
            continue
        lib_none = False
        where = replaces.get(name, "tacotron2_tpu/ops/mrf_pallas.py:312,378 (also :285)")
        rows.append({
            "name": name + ("_f32" if f32 else ""), "route": "cuda",
            "source": "tacotron2_tpu_torch/csrc/" + (
                "mrf_narrow.cu" if name.startswith("narrow") else "mrf_f32.cu" if f32
                else "mrf.cu"),
            "replaces": (where.replace("the bf16 policy", "F32") + "; bf16=False, _dt = "
                         "jnp.float32 at mrf_pallas.py:463,540,636" if f32 else where),
            "ms": t["ms"], "plain_ms": t["plain_ms"] if plain else None,
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": None if lib_none else t["library_ms"],
            "library_bf16_ms": None if lib_none or f32 else t["library_bf16_ms"],
            "library": None if lib_none else
                       "F.conv1d / F.conv_transpose1d (two for a fused pair): f32 (TF32 off) "
                       + ("on the kernel's f32 operands" if f32 else
                          "on the kernel's bf16 operands; library_bf16_ms the same in bf16, "
                          "bf16 output"),
            **({"cuda_core_ms": t["cuda_core_ms"]} if f32 else {}),
            "eager_ms": t["eager_ms"] if plain else None, "traffic_ms": t["traffic_ms"],
            "per": f"one vocode of {Tb} frames at {rows_b} rows ({t['calls']} calls)",
            "per_call": t["per_call"],
        })
    return rows


def k2_ab(hifigan, Tb: int) -> dict:
    """``--k2-ab`` only (the smoke run does not repeat it): two of K2's
    design choices, each measured in turns in one process on the card.

    1. The N split: stage 1's 18 ``mrf_conv`` launches of a ``Tb``-frame
       vocode at one row with the launcher's narrowest N tile
       (``kMinSplitN`` in ``csrc/mrf.cu``) at 128 (no split), 64 (the
       committed rule) and 32, each from a copy of the source built under
       ``build/k2_ab/``: device time (graph replay) beside bf16 cuDNN on the
       same operands, and whether the outputs equal 128's bit for bit.
    2. The ResBlock1 pair fusion: a vocode's K2 stages at 1 and 64 rows with
       each pair as one ``mrf_pair`` launch or as two ``mrf_conv`` launches
       (``run_stage`` without its pair call): device times and bits."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from tacotron2_tpu_torch.models import layers
    from tacotron2_tpu_torch.ops import build, mrf

    line = "constexpr int kMinSplitN = 64;"
    src = (build.CSRC / "mrf.cu").read_text()
    if line not in src:
        raise SmokeFailure(f"csrc/mrf.cu has no line {line!r} to vary")
    jobs = {}
    for n in (128, 64, 32):
        d = ROOT / "build" / "k2_ab" / f"n{n}"
        d.mkdir(parents=True, exist_ok=True)
        for hdr in build.CSRC.glob("*.cuh"):
            shutil.copy(hdr, d)
        (d / "mrf.cu").write_text(src.replace(line, f"constexpr int kMinSplitN = {n};"))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "libmrf.so"), str(d / "mrf.cu")]
        jobs[n] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True))
    libs = {}
    for n, (d, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SmokeFailure(f"nvcc failed for the kMinSplitN = {n} copy:\n{out}")
        libs[n] = mrf.bind(ctypes.CDLL(str(d / "libmrf.so")))

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    kw = hifigan.kernel_weights()
    result = {}
    try:
        # 1. the N split, stage 1 at one row
        rbs, ups = kw[0]
        mel = torch.randn(1, Tb, hifigan.cfg.num_mels, device="cuda", generator=g)
        x0 = layers.conv1d(mel, hifigan.conv_pre.weight, hifigan.conv_pre.bias, hifigan.policy,
                           padding=3).contiguous()
        xu, au = mrf.conv_transpose_plain(mrf.operand(x0, torch.bfloat16), ups, want_act=True)
        xu, au = xu.contiguous(), au.contiguous()
        convs = [cw for rb in rbs for pair in rb for cw in pair if cw is not None]
        run = lambda: [mrf.mrf_conv(au, cw, xu, want_act=True) for cw in convs]
        outs, ms = {}, {n: [] for n in libs}
        for n in (128, 64, 32, 32, 64, 128):
            mrf._LIB = libs[n]
            outs[n] = run()
            ms[n].append(time_ms(run, 10, 4))
        xt = au.transpose(1, 2).contiguous()
        lib_args = [(cw.w.permute(1, 2, 0).contiguous(), cw.b.to(torch.bfloat16),
                     cw.dilation * (cw.w.shape[0] - 1) // 2, cw.dilation) for cw in convs]
        lib_ms = time_ms(lambda: [F.conv1d(xt, w, b, padding=p, dilation=dl)
                                  for w, b, p, dl in lib_args], 10, 4)
        same = {n: all(torch.equal(a, b) for o, o128 in zip(outs[n], outs[128])
                       for a, b in zip(o[:2], o128[:2])) for n in (64, 32)}
        result["n_split"] = {"T": xu.shape[1], "ms": {f"N>={n}": v for n, v in ms.items()},
                             "library_bf16_ms": lib_ms,
                             "equal_bits_to_128": {f"N>={n}": v for n, v in same.items()}}
        print(f"  stage 1's 18 mrf_conv at one row, T={xu.shape[1]}: "
              + "; ".join(f"N >= {n}: " + " / ".join(f"{t:.4f}" for t in v) + " ms"
                          for n, v in ms.items())
              + f"; bf16 cuDNN {lib_ms:.4f} ms; bits equal to N = 128's: {same}")
    finally:
        mrf._LIB = None

    # 2. the pair fusion, whole vocodes' K2 stages
    for rows_b in (1, 64):
        mel = torch.randn(rows_b, Tb, hifigan.cfg.num_mels, device="cuda", generator=g)
        x0 = layers.conv1d(mel, hifigan.conv_pre.weight, hifigan.conv_pre.bias,
                           hifigan.policy, padding=3).contiguous()

        def vocode(pair):
            a = mrf.operand(x0, torch.bfloat16)
            for i, (rbs, ups) in enumerate(kw):
                out = mrf.run_stage(None, rbs, ups, mrf.mrf_conv, mrf.conv_transpose, pair, a,
                                    i < len(kw) - 1)
                a = out if i < len(kw) - 1 else None
            return out

        ms, outs = {"fused": [], "unfused": []}, {}
        for key in ("fused", "unfused", "unfused", "fused"):
            pair = mrf.mrf_pair if key == "fused" else None
            ms[key].append(time_ms(lambda: vocode(pair), 3, 1 if rows_b > 1 else 4))
            outs[key] = vocode(pair)
        same = bool(torch.equal(outs["fused"], outs["unfused"]))
        result[f"pairs_B{rows_b}"] = {**{f"{k}_ms": v for k, v in ms.items()},
                                      "equal_bits": same}
        print(f"  K2 stages of one vocode at {rows_b} rows, Tb={Tb}: pairs fused "
              + " / ".join(f"{v:.3f}" for v in ms["fused"]) + " ms, as two launches "
              + " / ".join(f"{v:.3f}" for v in ms["unfused"]) + f" ms; equal bits: {same}")
    return result


K2F_TOL = 1e-5  # K2's f32 mode against its plain f32 version, of the output's max (PERF.md)
K2F_ROWS = (1, 16, 64)  # the say's one row and the serve windows' rows
K2F_INVARIANCE_ROWS = (0, 1, 37, 63)  # rows of a 64-row vocode held against the rows alone
K2F_DEFECT_MARGIN = 10.0  # a planted defect reads at least this many times K2F_TOL
K2F_DRAWS = 3  # weight draws of the f64-sum measurement
# the three-pass design's own planted defects: copies of csrc/mrf_f32.cu with
# passes left out (kPasses: 1 a_lo w_hi, 2 a_hi w_lo, 4 a_hi w_hi), the lo
# passes (one TF32 pass of the rna-rounded operands) and the a_lo pass alone
K2F_PASS_DEFECTS = (("lo_passes", 4), ("a_lo_pass", 6))


def k2f_pass_copies():
    """Start nvcc of the K2F_PASS_DEFECTS copies of csrc/mrf_f32.cu (under
    build/defects) -> a function that waits for them: {name: library}."""
    return build_copies("mrf_f32", [(f"mrf_f32_{n}", [(r"constexpr int kPasses = 7;",
                                                       f"constexpr int kPasses = {m};")])
                                    for n, m in K2F_PASS_DEFECTS],
                        ROOT / "build" / "defects", wait=False)


@contextlib.contextmanager
def f32_library(path):
    """K2's f32 wrappers launch another build of csrc/mrf_f32.cu (a defect's
    copy) inside the block."""
    import ctypes

    from tacotron2_tpu_torch.ops import mrf

    saved = mrf._lib_f32()
    mrf._LIB_F32 = mrf.bind(ctypes.CDLL(str(path)), "_f32")
    try:
        yield
    finally:
        mrf._LIB_F32 = saved


def tf32_round(t):
    """``t`` rounded to TF32 (10 mantissa bits, to nearest even), kept f32:
    what a single TF32 pass makes of an operand."""
    import torch

    i = t.contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


def rounded_conv(cw, rnd):
    """``cw`` with its weights rounded by ``rnd``, kept f32, re-tiled."""
    from tacotron2_tpu_torch.ops import mrf

    w = rnd(cw.w).contiguous()
    return mrf.ConvWeights(w, cw.b, cw.dilation, mrf.tile_conv(w))


def f64_stage(x, rbs, ups):
    """``plain_stage`` with f64 operands, weights and sums: the reference
    the f32 readings are measured against."""
    import torch.nn.functional as F

    def conv(z, cw, res=None):
        K = cw.w.shape[0]
        y = F.conv1d(F.leaky_relu(z, 0.1).transpose(1, 2), cw.w.double().permute(1, 2, 0),
                     cw.b.double(), padding=cw.dilation * (K - 1) // 2,
                     dilation=cw.dilation).transpose(1, 2)
        return y if res is None else y + res

    x = x.double()
    if ups is not None:
        x = F.conv_transpose1d(F.leaky_relu(x, 0.1).transpose(1, 2),
                               ups.w.double().permute(1, 2, 0), ups.b.double(),
                               stride=ups.stride, padding=ups.padding).transpose(1, 2)
    acc = None
    for rb in rbs:
        z = x
        for c1, c2 in rb:
            z = conv(z, c1, z) if c2 is None else conv(conv(z, c1), c2, z)
        acc = z / len(rbs) if acc is None else acc + z / len(rbs)
    return acc


def k2_f32_reference(Tb: int, log: dict) -> dict:
    """The plain f32 version (cuDNN, TF32 off) and K2's f32 mode, each
    against f64 sums (``f64_stage``, ``F.conv1d`` in f64), on K2F_DRAWS
    UNIVERSAL_V1 weight draws at one row of ``Tb`` frames: ``conv_pre`` and
    each stage from the plain f32 stage input, the error over the f64
    output's max. The spread the plain version's own f32 sums leave is what
    K2F_TOL must stand above."""
    import torch
    import torch.nn.functional as F

    from tacotron2_tpu_torch.models import layers
    from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
    from tacotron2_tpu_torch.models.layers import F32
    from tacotron2_tpu_torch.ops import mrf

    rel = lambda got, ref: float((got.double() - ref).abs().max() / ref.abs().max())
    out = []
    for d in range(K2F_DRAWS):
        torch.manual_seed(SEED + 60 + d)
        h = HiFiGAN(HiFiGANConfig.from_dict(UNIVERSAL_V1), F32).cuda().eval()
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 70 + d)
        mel = torch.randn(1, Tb, h.cfg.num_mels, device="cuda", generator=g)
        cwp = h.conv_pre_weights()
        ref = F.conv1d(mel.double().transpose(1, 2), h.conv_pre.weight.double(),
                       h.conv_pre.bias.double(), padding=3).transpose(1, 2)
        ref = F.leaky_relu(ref, 0.1)
        draw = {"conv_pre": {"plain": rel(mrf.conv_pre_plain(mel, cwp), ref),
                             "kernel": rel(mrf.conv_pre(mel, cwp), ref)}}
        x = layers.conv1d(mel, h.conv_pre.weight, h.conv_pre.bias, F32, padding=3,
                          round_out=True)
        for i, (rbs, ups) in enumerate(h.kernel_weights()):
            ref = f64_stage(x, rbs, ups)
            p = mrf.plain_stage(x, rbs, ups)
            draw[f"stage{i + 1}"] = {"plain": rel(p, ref), "kernel": rel(mrf.mrf_stage(x, rbs, ups),
                                                                         ref)}
            x = p
            del ref
        out.append(draw)
        print(f"  f64-sum reference, draw {d}: " + "; ".join(
            f"{k} plain {v['plain']:.2e} kernel {v['kernel']:.2e}" for k, v in draw.items()))
        del h
        torch.cuda.empty_cache()
    worst = {w: max(v[w] for dr in out for v in dr.values()) for w in ("plain", "kernel")}
    log["k2_f32_f64_reference"] = {"draws": out, "worst": worst, "Tb": Tb, "tol": K2F_TOL}
    print(f"  f64-sum reference over {K2F_DRAWS} draws, worst of the output's max: plain "
          f"{worst['plain']:.2e}, kernel {worst['kernel']:.2e} (K2F_TOL {K2F_TOL:g})")
    return worst


def k2_f32_phase(hifigan, Tb: int, log: dict, copies=None) -> list:
    """K2's f32 mode (``csrc/mrf_f32.cu``) on an F32 UNIVERSAL_V1 generator
    at K2F_ROWS rows of ``Tb`` frames, each stage from the plain stage's
    input: ``conv_pre`` from the mel, each upsample and its operand, each
    stage's first ``mrf_conv_f32`` or fused ``mrf_pair_f32`` alone (without
    the residual, so that the conv's own sum is held), and the whole stage,
    against their plain f32 versions within K2F_TOL of the output's max.
    Bitwise, failing the run: each fused pair against its two ``mrf_conv``
    launches, and rows K2F_INVARIANCE_ROWS of a 64-row vocode on the served
    route (``conv_pre``, each stage passing its mean's operand to the next)
    and of ``HiFiGAN.apply`` against each row alone. Planted defects (the first conv or pair of each
    stage with its operand and weights rounded to TF32, then to bf16, and
    the same calls on copies of the kernel with passes left out,
    K2F_PASS_DEFECTS) read at least K2F_DEFECT_MARGIN x K2F_TOL. Then every
    entry timed at each row count
    (``k2_timing``: kernel, plain version, cuDNN f32, bound). -> the
    kernels-line rows, ``rows`` holding each row count's."""
    import torch

    from tacotron2_tpu_torch.models import layers
    from tacotron2_tpu_torch.models.layers import F32
    from tacotron2_tpu_torch.ops import mrf

    if hifigan.policy.compute_dtype != torch.float32:
        raise SmokeFailure("k2_f32_phase wants an F32 generator")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 50)
    kw = hifigan.kernel_weights()
    cwp = hifigan.conv_pre_weights()
    tol = K2F_TOL
    defects: dict = {}
    copies = copies or k2f_pass_copies()  # the pass defects' builds, if not started before
    for B in K2F_ROWS:
        mel = torch.randn(B, Tb, hifigan.cfg.num_mels, device="cuda", generator=g)
        check(f"conv_pre_f32@B{B}x{Tb}", [("a", mrf.conv_pre(mel, cwp),
                                           mrf.conv_pre_plain(mel, cwp))],
              tol, log, "conv_pre_f32", own=True)
        x = layers.conv1d(mel, hifigan.conv_pre.weight, hifigan.conv_pre.bias, F32, padding=3,
                          round_out=True)
        for i, (rbs, ups) in enumerate(kw):
            tag = f"[{i}]@B{B}x{Tb}"
            x = x.contiguous()
            a = mrf.operand(x, torch.float32)
            xu, au = mrf.conv_transpose_plain(a, ups, want_act=True)
            yk, ak = mrf.conv_transpose(a, ups, want_act=True)
            check(f"conv_transpose_f32{tag}", [("out", yk, xu), ("act", ak, au)], tol, log,
                  "conv_transpose_f32", own=True)
            del yk, ak, a
            name = stage_kernel(rbs)
            pair = name == "mrf_pair_f32"
            c1, c2 = rbs[0][0]
            xu, au = xu.contiguous(), au.contiguous()
            one = ((lambda f, a, c1, c2, r: f(a, c1, c2, res=r, want_act=True)) if pair else
                   (lambda f, a, c1, c2, r: f(a, c1, want_act=True)))
            kern = mrf.mrf_pair if pair else mrf.mrf_conv
            # no residual: the conv's own sum is what a rounding defect moves
            p_out = one(mrf.mrf_pair_plain if pair else mrf.mrf_conv_plain, au, c1, c2, None)
            k_out = one(kern, au, c1, c2, None)
            check(f"{name}{tag}", [("y", k_out[0], p_out[0]), ("act", k_out[1], p_out[1])],
                  tol, log, name, own=True)
            if B == 16:  # the planted defects, each stage's first conv or pair
                for dname, rnd in (("tf32_operands", tf32_round),
                                   ("bf16_operands", lambda t: t.to(torch.bfloat16).float())):
                    d_out = one(kern, rnd(au), rounded_conv(c1, rnd),
                                rounded_conv(c2, rnd) if pair else None, None)
                    r = err(d_out[0], p_out[0], own=True)[1]
                    defects.setdefault(dname, []).append({"call": f"{name}{tag}", "rel_err": r})
                    del d_out
                if callable(copies):
                    copies = copies()
                for dname, _ in K2F_PASS_DEFECTS:
                    with f32_library(copies[f"mrf_f32_{dname}"]):
                        d_out = one(kern, au, c1, c2, None)
                    r = err(d_out[0], p_out[0], own=True)[1]
                    defects.setdefault(dname, []).append({"call": f"{name}{tag}", "rel_err": r})
                    del d_out
            del k_out, p_out
            if pair:
                acc = torch.randn(xu.shape, device="cuda", generator=g)
                fused = mrf.mrf_pair(au, c1, c2, xu, acc, 0.25, True, True)
                _, at, _ = mrf.mrf_conv(au, c1, want_y=False, want_act=True)
                unfused = mrf.mrf_conv(at, c2, xu, acc, 0.25, True, True)
                if not all(torch.equal(f, u) for f, u in zip(fused, unfused)):
                    raise SmokeFailure(f"{name}{tag}: the fused pair differs from its two "
                                       "mrf_conv launches")
                del acc, fused, at, unfused
            del xu, au
            ref = mrf.plain_stage(x, rbs, ups)
            check(f"mrf_stage_f32{tag}", [("out", mrf.mrf_stage(x, rbs, ups), ref)], tol, log,
                  name, own=True)
            x = ref
        del x, mel
        torch.cuda.empty_cache()
    for dname, rs in defects.items():
        worst = min(r["rel_err"] for r in rs)
        log.setdefault("k2_f32_defects", {})[dname] = {"readings": rs, "least": worst}
        print(f"  K2 f32 planted defect {dname}: least reading {worst:.3e} "
              f"({worst / tol:.0f}x K2F_TOL {tol:g})")
        if not worst >= K2F_DEFECT_MARGIN * tol:
            raise SmokeFailure(f"the planted defect {dname} reads {worst:.3e}, under "
                               f"{K2F_DEFECT_MARGIN:g} x K2F_TOL")

    def route(m):  # the served vocode's K2 route: every entry, each output kept
        outs = [mrf.conv_pre(m, cwp)]
        for i, (rbs, ups) in enumerate(kw):
            outs.append(mrf.mrf_stage(None, rbs, ups, outs[-1], want_operand=i < len(kw) - 1))
        return outs

    n = max(K2F_INVARIANCE_ROWS) + 1
    mel = torch.randn(n, Tb, hifigan.cfg.num_mels, device="cuda", generator=g)
    batch = route(mel)
    wav = hifigan.apply(mel)  # the whole vocode, conv_post and tanh included
    for r in K2F_INVARIANCE_ROWS:
        alone = route(mel[r:r + 1])
        if not all(torch.equal(b[r:r + 1], o) for b, o in zip(batch, alone)):
            raise SmokeFailure(f"K2 f32: row {r} of a {n}-row vocode differs from the row alone")
        if not torch.equal(wav[r:r + 1], hifigan.apply(mel[r:r + 1])):
            raise SmokeFailure(f"the F32 vocode (HiFiGAN.apply): row {r} of {n} differs from the "
                               "row alone")
    print(f"  K2 f32: rows {list(K2F_INVARIANCE_ROWS)} of a {n}-row vocode equal each row alone "
          "bit for bit (K2's output and HiFiGAN.apply's); every fused pair equals its two "
          "launches")
    del batch, mel, wav
    torch.cuda.empty_cache()

    rows = {}
    for B in K2F_ROWS:
        big = B > 1
        for r in k2_timing(hifigan, Tb, B, True,
                           ((1, 2) if B >= 64 else (2, 2)) if big else (5, 4)):
            row = rows.setdefault(r["name"], {**r, "rows": {}})
            row["rows"][f"B{B}"] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms", "cuda_core_ms", "eager_ms",
                                                      "traffic_ms", "per")}
            print(f"  {r['name']} at {B} rows, Tb={Tb}: {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f}, cuDNN f32 {r['library_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}, 3 TF32 passes), FP32 cores "
                  f"{r['cuda_core_ms']:.4f} ms")
        torch.cuda.empty_cache()
    out = []
    for r in rows.values():  # the kernels line: the say's one row, the others in "rows"
        r.update({k: r["rows"]["B1"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "eager_ms", "traffic_ms", "per")})
        out.append(r)
    log["k2_f32"] = {r["name"]: r["rows"] for r in out}
    return out


def kernel_split(fn) -> dict:
    """Device ms of each kernel in one call of ``fn`` (torch.profiler),
    largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            name = evt.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.split("<")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def packed_bilstm(lstm, xs, lengths):
    """The encoder's BiLSTM as torch's packed f32 LSTM (cuDNN on the card):
    ``layers.bilstm_rows``' function, each step over the rows still
    running. -> (B, T, 2H)"""
    import torch

    packed = torch.nn.utils.rnn.pack_padded_sequence(
        xs.float(), lengths.cpu(), batch_first=True, enforce_sorted=False)
    out, _ = lstm(packed)
    out, _ = torch.nn.utils.rnn.pad_packed_sequence(out, batch_first=True,
                                                    total_length=xs.shape[1])
    return out


class cudnn_bilstm:
    """Within this context the encoder runs its BiLSTM as before the bf16
    repair: torch's packed f32 LSTM (cuDNN, ``packed_bilstm``) under every
    policy. For timing the encoder before and after the repair, and for the
    F32 train step's reading with the packed encoder."""

    def __enter__(self):
        from tacotron2_tpu_torch.models import layers

        self.layers, self.saved = layers, layers.bilstm
        layers.bilstm = lambda lstm, xs, lengths, policy=None: packed_bilstm(lstm, xs, lengths)

    def __exit__(self, *exc):
        self.layers.bilstm = self.saved


def teacher_bounds(T: int, B: int, L: int, D: int, C: int, w, res, mel_gate) -> dict:
    """Bound of K3 (the T-step teacher forward) and of K4 (its reverse
    pass), each input read once and each output written once, and the
    operations these shapes need -> {name: (bound_ms, bound_by, the weight
    stream of this design (the LSTM weights re-read every step), the bound
    of the E - C pad columns' work)}. D: the encoder's width; C: the
    controls (0 without), which the bound counts; the weights and xh2 hold
    them padded to E, and that pad's bytes and operations go to the last
    entry alone."""
    from tacotron2_tpu_torch.ops import train_decode as td

    H, _, E = td.packed_dims(w, D)
    H4, R1 = w.w1.shape
    A, K, N = w.wq.shape[0], w.w_loc.shape[2], w.w_out.shape[0]
    P = R1 - D - H
    R2 = 2 * H + D + C
    f32, bf = 4, 2
    pad = E - C
    lstm_w = nbytes(w.w1, w.w2)
    w_bytes = nbytes(*w) - pad * bf * (H4 + N)
    xh2_pad = T * B * pad * bf
    gates = 2 * B * H4 * (R1 + R2)
    att = B * (2 * A * H + L * A * (4 * K + 4) + 2 * L * D + 4 * L)
    heads = 2 * B * N * (H + D + C)
    # encoded (bf16), att_enc, lengths, the two LSTM masks, the controls
    shared_in = B * L * (D * bf + A * f32) + B * 4 + 2 * T * B * H * f32 + B * C * f32
    k3 = bound_ms(w_bytes + T * B * P * f32 + shared_in + nbytes(mel_gate, *res) - xh2_pad,
                  T * (gates + att + heads))
    # K4 reads the residuals and the cotangents and writes dg1, dg2 (bf16),
    # dxh1, dctx, dq, head_h (bf16), d_attenc and d_ctrl; it recomputes the
    # gates, runs the two dx products (2 x gates) and the attention backward
    # (~3x)
    bwd_out = (T * B * (2 * H4 * bf + R1 * f32 + D * f32 + A * f32 + H * bf)
               + B * L * A * f32 + B * C * f32)
    k4 = bound_ms(w_bytes + shared_in + nbytes(*res) - xh2_pad + T * B * (N + L) * f32 + bwd_out,
                  T * (2 * gates + 3 * att + 2 * heads))
    pad_ops = 2 * B * pad * (H4 + N)  # one step's gate and heads products over the pad
    pad3 = bound_ms(pad * bf * (H4 + N) + xh2_pad, T * pad_ops)[0]
    pad4 = bound_ms(pad * bf * (H4 + N) + xh2_pad + B * pad * f32, 2 * T * pad_ops)[0]
    stream = lstm_w / card_peak("bytes") * 1e3
    return {"teacher_forward": (*k3, T * stream, pad3),
            "teacher_backward": (*k4, 2 * T * stream, pad4)}


def without_pdl(fn):
    """``fn()`` with K3's and K4's step loops launched without programmatic
    dependent launch."""
    from tacotron2_tpu_torch.ops import train_decode as td

    td._PDL = False
    try:
        return fn()
    finally:
        td._PDL = True


@contextlib.contextmanager
def f64_sums():
    """The plain versions' sums in f64 with their bf16 rounding points kept:
    ``_acc``, the sum type of a bf16 weight, promotes to f64 inside."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl
    from tacotron2_tpu_torch.ops import train_decode as td

    acc = dl._acc
    dl._acc = td._acc = lambda t: t.to(torch.promote_types(t.dtype, torch.float64))
    try:
        yield
    finally:
        dl._acc = td._acc = acc


def teacher_backward_ref(w, res, enc, att, lens, dm1, dm2, d_mg, d_al):
    """``teacher_backward_plain`` on the same inputs under ``f64_sums``,
    each output back in the kernel's type: the reference K4 is held
    against, so that a reading is the kernel's own error and not that of
    the plain version's f32 sums too (PERF.md)."""
    import torch

    from tacotron2_tpu_torch.ops import train_decode as td

    up = lambda t: t.double() if t.dtype == torch.float32 else t
    with f64_sums():
        out = td.teacher_backward_plain(type(w)(*map(up, w)), type(res)(*map(up, res)), enc,
                                        up(att), lens, up(dm1), up(dm2), up(d_mg), up(d_al))
    return type(out)(*(t.float() if t.dtype == torch.float64 else t for t in out))


def k34_check(tag: str, params, w, din, enc, att, lens, dm1, dm2, d_mg, d_al, log: dict,
              k3_tol: dict, ctl=None, mode: str = "") -> tuple:
    """K3 against its plain version; K4 against its plain version on the
    plain forward's residuals, then on K3's own (the train path's chain
    K3 -> K4), and every gradient ``TeacherDecode`` returns from K4's stacks
    (the controls' too, where ``ctl``, the padded controls, is given)
    against those from the plain ones on the same residuals; padded chars
    must get no attention weight. ``mode`` ("[controls]") names the kernels
    line's rows the errors belong to. -> (fwd_args, bwd_args on the plain
    residuals, K3's mel_gate and residuals, the plain residuals, the plain
    mel_gate)."""
    import torch

    from tacotron2_tpu_torch.ops import train_decode as td

    fwd_args = (w, din, enc, att, lens, dm1, dm2, ctl)
    mg_k, res_k = td.teacher_forward(*fwd_args)
    mg_p, res_p = td.teacher_forward_plain(*fwd_args)
    check(f"teacher_forward{tag}", [("mel_gate", mg_k, mg_p)]
          + [(f, getattr(res_k, f), getattr(res_p, f)) for f in td.Residuals._fields],
          k3_tol, log, f"teacher_forward{mode}")
    pad = torch.arange(enc.shape[1], device=enc.device)[None, :] >= lens[:, None]
    if bool((res_k.al[1:] * pad[None]).any()):
        raise SmokeFailure(f"K3{tag} gave padded chars attention weight")
    names = ("decoder_in", "encoded", "att_encoded", "controls") + td.DECODER_PARAMS
    for res, on in ((res_p, ""), (res_k, "[on K3]")):
        bwd = (w, res, enc, att, lens, dm1, dm2, d_mg, d_al)
        bk, bp = td.teacher_backward(*bwd), teacher_backward_ref(*bwd)
        # a model without controls has a zero-width d_ctrl and controls' gradient
        check(f"teacher_backward{tag}{on}", [(f, getattr(bk, f), getattr(bp, f))
                                             for f in td.BackwardOut._fields
                                             if getattr(bp, f).numel()],
              K4_TOL, log, f"teacher_backward{mode}", own=True)
        check(f"teacher_decode_grads{tag}{on}",
              [(n, a, b) for n, a, b in zip(names, td.grads_from(params, w, res, enc, bk, d_mg),
                                            td.grads_from(params, w, res, enc, bp, d_mg))
               if b.numel()],
              GRAD_TOL, log, f"teacher_backward{mode}", own=True)
    bwd_args = (w, res_p, enc, att, lens, dm1, dm2, d_mg, d_al)
    return fwd_args, bwd_args, mg_k, res_k, res_p, mg_p


# ragged shapes of the attention's cluster split (S = 4 at B = 32: slices of
# ceil(L / 4) chars): L not a multiple of S, rows ending one char either side
# of each slice boundary and on it, rows shorter than one slice; and a batch
# of 5 rows (S = 8, slices of 5 chars, the last rank owning fewer)
K34_RAGGED = (
    ("[L157]", 32, 157, 16, (157, 120, 121, 119, 80, 81, 79, 40, 41, 39, 30, 5, 1)),
    ("[B5,L37]", 5, 37, 16, (37, 10, 1, 5, 6)),
)


def k34_phase(model, log: dict) -> list:
    """K3 (teacher forward) and K4 (its reverse pass) against their plain
    versions at the vanilla full width: B=32, L=160 with row lengths running
    down to 100, T=128 steps, LSTM masks drawn once for both; then at the
    ragged shapes of ``K34_RAGGED``; then the gate product with its LSTM
    epilogue alone, with the L2 warm and flushed."""
    import torch

    from tacotron2_tpu_torch.ops import train_decode as td

    dev = torch.device("cuda")
    c = model.cfg
    B, L, T = TRAIN_B, TRAIN_L, TRAIN_T
    M, P, H, D = c.num_mels, c.prenet_dim, c.att_rnn_dim, c.encoded_dim
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    rn = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=g) * scale
    named = dict(model.decoder.named_parameters())
    params = [named[k].detach() for k in td.DECODER_PARAMS]
    w = td.pack_weights(params, torch.bfloat16)

    def inputs(B, L, T, lens):
        din = torch.relu(rn(T, B, P)) * 2.0  # prenet-like: ReLU, dropout's x2
        enc = rn(B, L, D, scale=0.5).to(torch.bfloat16)
        att = (enc.float() @ model.att_encoder.weight.t()).contiguous()
        dm1, dm2 = td.lstm_masks(T, B, H, g, dev)
        # random cotangents for K4
        return (din, enc, att, lens, dm1, dm2, rn(T, B, M + 1, scale=1e-3),
                rn(T, B, L, scale=1e-3))

    lens = torch.linspace(L, 100, B, device=dev).round().to(torch.int32)
    fwd_args, bwd_args, mg_k, res_k, res_p, _ = k34_check("", params, w,
                                                          *inputs(B, L, T, lens), log, K3_TOL)
    S = td.cluster_size(B, torch.cuda.get_device_properties(dev).multi_processor_count)
    log["k34_cluster"] = {"S": S, "dynamic_smem_bytes": td.smem_bytes(L, S, H, w.wq.shape[0], D,
                                                                      w.w_loc.shape[2])}
    print(f"  cluster attention: S={S} blocks per row at B={B}; dynamic shared memory "
          f"{log['k34_cluster']['dynamic_smem_bytes']} bytes")
    for tag, b, l, t, short in K34_RAGGED:
        rows = torch.tensor(list(short) + [l] * (b - len(short)), dtype=torch.int32, device=dev)
        k34_check(tag, params, w, *inputs(b, l, t, rows), log, K3_TOL)

    log["k34_kernel_ms"] = {
        "teacher_forward": kernel_split(lambda: td.teacher_forward(*fwd_args)),
        "teacher_backward": kernel_split(lambda: td.teacher_backward(*bwd_args))}
    for name, split in log["k34_kernel_ms"].items():
        print(f"  {name}, device ms per kernel (torch.profiler, T={T}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    # a breakdown of K3: its gate GEMM with the LSTM epilogue, both cells of
    # a step (2 of its 4 launches a step), from the profiler's split above,
    # beside two bf16 nn.LSTMCell calls of step 3's inputs as a yardstick
    t = 3

    def lstm_lib(cell_mod, xh, c_prev):
        cell = torch.nn.LSTMCell(cell_mod.input_size, cell_mod.hidden_size, device=dev,
                                 dtype=torch.bfloat16)
        cell.load_state_dict(cell_mod.state_dict())
        x, h = xh[:, :-H].contiguous(), xh[:, -H:].contiguous()
        return lambda: cell(x, (h, c_prev.to(torch.bfloat16)))

    libs = (lstm_lib(model.decoder.att_rnn, res_p.xh1[t], res_p.c_att[t]),
            lstm_lib(model.decoder.lstm, res_p.xh2[t], res_p.c_rnn[t]))
    # a step reads the weights, the biases and both xh, and per cell c_prev
    # and the mask (f32), and writes c (f32) and h (bf16)
    gl_bound, gl_by = bound_ms(nbytes(w.w1, w.b1, w.w2, w.b2, res_p.xh1[t], res_p.xh2[t])
                               + 2 * B * H * (4 + 4 + 4 + 2),
                               2 * B * (w.w1.numel() + w.w2.numel()))
    log["gate_lstm"] = {"ms": log["k34_kernel_ms"]["teacher_forward"]["gate_tma_kernel"] / T,
                        "library_ms": time_ms(lambda: [f() for f in libs]),
                        "bound_ms": gl_bound, "bound_by": gl_by,
                        "weights_mb": nbytes(w.w1, w.w2) / 1e6,
                        "per": f"both LSTM cells of one step in K3, B={B} (profiler)"}
    print(f"  gate_lstm (both cells, B={B}), us: " + ", ".join(
        f"{k} {v * 1e3:.1f}" for k, v in log["gate_lstm"].items() if k.endswith("ms")))

    # programmatic dependent launch: the same calls without it give the same
    # bits (each launch still follows every earlier one) and are timed beside
    bk = td.teacher_backward(*bwd_args)
    mg_n, res_n = without_pdl(lambda: td.teacher_forward(*fwd_args))
    bk_n = without_pdl(lambda: td.teacher_backward(*bwd_args))
    if not all(torch.equal(a, b) for a, b in zip((mg_k, *res_k, *bk), (mg_n, *res_n, *bk_n))):
        raise SmokeFailure("K3/K4 with programmatic dependent launch differ from without")

    bounds = teacher_bounds(T, B, L, D, 0, w, res_k, mg_k)
    rows = []
    log["k34_pdl"] = {}
    for name, kern, plain, (b_ms, b_by, stream, _), per, replaces in (
        ("teacher_forward", lambda: td.teacher_forward(*fwd_args),
         lambda: td.teacher_forward_plain(*fwd_args), bounds["teacher_forward"],
         f"one teacher forward, B={B}, L={L}, T={T}", 51),
        ("teacher_backward", lambda: td.teacher_backward(*bwd_args),
         lambda: td.teacher_backward_plain(*bwd_args), bounds["teacher_backward"],
         f"one reverse pass, B={B}, L={L}, T={T}", 478),
    ):
        rows.append({
            "name": name, "route": "cuda",
            "source": "tacotron2_tpu_torch/csrc/train_decode.cu",
            "replaces": f"tacotron2_tpu/ops/train_decode_pallas.py:{replaces}",
            "ms": time_ms(kern, 3, 1), "plain_ms": time_ms(plain, 2, 1),
            "bound_ms": b_ms, "bound_by": b_by, "eager_ms": eager_ms(kern, 3),
            "library_ms": None, "weight_stream_ms": stream, "per": per,
        })
        log["k34_pdl"][name] = {"ms": rows[-1]["ms"],
                                "no_pdl_ms": without_pdl(lambda: time_ms(kern, 3, 1)),
                                "eager_ms": rows[-1]["eager_ms"],
                                "no_pdl_eager_ms": without_pdl(lambda: eager_ms(kern, 3))}
    print("  K3/K4 with and without programmatic dependent launch, device ms: "
          + json.dumps(log["k34_pdl"]))
    return rows


# K3/K4 in the controls mode (the controllable configs, C=5 -> E=16): the
# controllable train batch's shape (B=64: cluster size 2 on 132 SMs), the
# -32 configs' (B=32) and a ragged one (B=5, L=37: cluster size 8, slices
# of 5 chars), with distinct controls per row
K34_CTL_SHAPES = (
    ("[controls,B64]", 64, 128, 384, None),
    ("[controls,B32]", 32, 128, 384, None),
    ("[controls,B5,L37]", 5, 37, 16, (37, 10, 1, 5, 6)),
)
# a defect must read at least this many times its limit
DEFECT_MARGIN = 3.0
# the vanilla and the controls mode timed in turns at these (B, L, T): the
# vanilla check shape of phase 3b, the controllable train batch's
K34_TURN_SHAPES = ((32, 160, 128), (64, 128, 384))


def start_k4_defect():
    """Start building a copy of ``csrc/train_decode.cu`` whose K4 reads
    d_rnn_h at H + D (the controls' cotangent) where it sits at H + D + E,
    under build/k34_defect. -> (nvcc process, library path)"""
    from tacotron2_tpu_torch.ops import build

    src = (build.CSRC / "train_decode.cu").read_text()
    good = "(const float*)(dxh2 + H + D + E), R2"
    if src.count(good) != 1:
        raise SmokeFailure("K4's d_rnn_h read is not where the defect expects it")
    out = ROOT / "build" / "k34_defect"
    out.mkdir(parents=True, exist_ok=True)
    (out / "train_decode.cu").write_text(src.replace(good, "(const float*)(dxh2 + H + D), R2"))
    lib = out / "libtrain_decode_defect.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                             str(lib), str(out / "train_decode.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def k34_controls_phase(vanilla, log: dict) -> list:
    """K3 and K4 in the controls mode on random full-width weights of the
    controllable config: at ``K34_CTL_SHAPES`` against their plain versions
    (K3_TOL_TRAIN, K4_TOL, GRAD_TOL, the controls' gradient included); the
    defects' readings, K3 with the controls left out of xh2 and K4 reading
    d_rnn_h at H + D, each at least DEFECT_MARGIN times its limit; the
    controls mode and the vanilla (``vanilla``'s weights) timed in turns at
    ``K34_TURN_SHAPES``; the kernels line's rows at B=64 (B=32 riding
    along)."""
    import ctypes

    import torch

    from tacotron2_tpu_torch.ops import train_decode as td

    proc, lib_path = start_k4_defect()
    dev = torch.device("cuda")
    _, model = ctl_model(SEED + 5)
    c = model.cfg
    M, P, H, D, C = c.num_mels, c.prenet_dim, c.att_rnn_dim, c.encoded_dim, c.controls_dim
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 6)
    rn = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=g) * scale
    pack = lambda m, C: td.pack_weights([dict(m.decoder.named_parameters())[k].detach()
                                         for k in td.DECODER_PARAMS], torch.bfloat16, C)
    params = [dict(model.decoder.named_parameters())[k].detach() for k in td.DECODER_PARAMS]
    w, w_van = pack(model, C), pack(vanilla, 0)

    def inputs(B, L, T, short=None):
        lens = (torch.tensor(list(short) + [L] * (B - len(short)), dtype=torch.int32, device=dev)
                if short else torch.linspace(L, 60, B, device=dev).round().to(torch.int32))
        din = torch.relu(rn(T, B, P)) * 2.0
        enc = rn(B, L, D, scale=0.5).to(torch.bfloat16)
        att = (enc.float() @ model.att_encoder.weight.t()).contiguous()
        dm1, dm2 = td.lstm_masks(T, B, H, g, dev)
        ctl = td.pad_controls(row_controls(B, g, dim=C), C, din[0])
        return (din, enc, att, lens, dm1, dm2, rn(T, B, M + 1, scale=1e-3),
                rn(T, B, L, scale=1e-3)), ctl

    checked = {}
    for tag, B, L, T, short in K34_CTL_SHAPES:
        args, ctl = inputs(B, L, T, short)
        S = td.cluster_size(B, td._sms(dev))
        print(f"  {tag}: B={B}, L={L}, T={T}, cluster size S={S}")
        checked[tag] = (B, L, T, ctl, k34_check(tag, params, w, *args, log, K3_TOL_TRAIN, ctl,
                                                "[controls]"))

    # the defects at B=64
    B, L, T, ctl, (fwd_args, bwd_args, mg_k, res_k, res_p, mg_p) = checked["[controls,B64]"]
    mg0, res0 = td.teacher_forward(*fwd_args[:7], torch.zeros_like(ctl))
    k3_defect = {f: err(a, b)[1] / K3_TOL_TRAIN[f]
                 for f, a, b in (("mel_gate", mg0, mg_p), ("c_rnn", res0.c_rnn, res_p.c_rnn))}
    log_nvcc, _ = proc.communicate()
    if proc.returncode != 0:
        raise SmokeFailure(f"nvcc failed for the K4 defect copy:\n{log_nvcc}")
    saved = td._LIB
    td._LIB = td.bind(ctypes.CDLL(str(lib_path)))
    try:
        bk_bad = td.teacher_backward(*bwd_args)
    finally:
        td._LIB = saved
    bp = teacher_backward_ref(*bwd_args)
    k4_defect = {f: err(getattr(bk_bad, f), getattr(bp, f), own=True)[1] / K4_TOL[f]
                 for f in ("dg2", "dxh1", "dq", "d_ctrl")}
    log["k34_controls_defects"] = {"controls_left_out_of_K3": k3_defect,
                                   "K4_d_rnn_h_at_H_plus_D": k4_defect,
                                   "as": "reading / limit"}
    print(f"  defects at B={B}, reading / limit: the controls left out of K3 {k3_defect}; K4 "
          f"reading d_rnn_h at H + D {k4_defect}")
    if max(k3_defect.values()) < DEFECT_MARGIN or max(k4_defect.values()) < DEFECT_MARGIN:
        raise SmokeFailure("a K3/K4 defect of the controls mode reads within "
                           f"{DEFECT_MARGIN}x its limit: {k3_defect}, {k4_defect}")

    # the controls mode against the vanilla in turns, same inputs but the
    # controls (device ms, CUDA-graph replay)
    turns = {}
    for B, L, T in K34_TURN_SHAPES:
        args, ctl = inputs(B, L, T)
        bwd_in = args[6:]
        calls = {}
        for mode, ww, cc in (("vanilla", w_van, None), ("controls", w, ctl)):
            f_args = (ww, *args[:6], cc)
            _, res = td.teacher_forward(*f_args)
            b_args = (ww, res, *args[1:6], *bwd_in)
            calls[mode] = (lambda f_args=f_args: td.teacher_forward(*f_args),
                           lambda b_args=b_args: td.teacher_backward(*b_args))
        got = {f"{m}_{k}": [] for m in ("vanilla", "controls") for k in ("k3", "k4")}
        for mode in ("vanilla", "controls", "controls", "vanilla"):
            got[f"{mode}_k3"].append(time_ms(calls[mode][0], 3, 1))
            got[f"{mode}_k4"].append(time_ms(calls[mode][1], 3, 1))
        turns[f"B{B},L{L},T{T}"] = got
        print(f"  K3 / K4 at B={B}, L={L}, T={T}, device ms in turns (vanilla, controls, "
              "controls, vanilla): " + "; ".join(
                  f"{k} " + " / ".join(f"{v:.3f}" for v in vs) for k, vs in got.items()))
    log["k34_controls_vs_vanilla"] = turns

    rows = []
    for name, replaces, src_note in (
            ("teacher_forward", 124, "the controls rows of xh2 :124-127 and of the heads :148"),
            ("teacher_backward", 596, "d_ctrl from the heads :579 and the decoder LSTM's dx "
                                      ":596, o_d_ctrl :818")):
        per_b = {}
        for tag in ("[controls,B64]", "[controls,B32]"):
            B, L, T, ctl, (f_args, b_args, mg, res, _, _) = checked[tag]
            b_ms, b_by, stream, pad_ms = teacher_bounds(T, B, L, D, C, w, res, mg)[name]
            kern = (lambda a=f_args: td.teacher_forward(*a)) if name == "teacher_forward" \
                else (lambda a=b_args: td.teacher_backward(*a))
            plain = (lambda a=f_args: td.teacher_forward_plain(*a)) if name == "teacher_forward" \
                else (lambda a=b_args: td.teacher_backward_plain(*a))
            per_b[B] = {"ms": time_ms(kern, 3, 1), "plain_ms": time_ms(plain, 2, 1),
                        "bound_ms": b_ms, "bound_by": b_by, "weight_stream_ms": stream,
                        "controls_pad_bound_ms": pad_ms, "eager_ms": eager_ms(kern, 3),
                        "per": f"B={B}, L={L}, T={T}, C={C}"}
        top = per_b[checked["[controls,B64]"][0]]
        rows.append({
            "name": f"{name}[controls]", "route": "cuda",
            "source": "tacotron2_tpu_torch/csrc/train_decode.cu",
            "replaces": f"tacotron2_tpu/ops/train_decode_pallas.py:{replaces} ({src_note})",
            "library_ms": None, **top,
            "per": f"{'one teacher forward' if name == 'teacher_forward' else 'one reverse pass'}"
                   f" with controls, {top['per']}",
            "rows": {str(b): {k: v[k] for k in ("ms", "plain_ms", "bound_ms")}
                     for b, v in per_b.items()}})
    return rows


# the encoder's bf16 BiLSTM recurrence against its plain version over 128
# steps: h feeds back through bf16 operands, so one-ulp rounding flips
# propagate as in K3 (relative to max(1, max |ref|); dg to its own max)
ENC_TOL = {"hs": 2e-3, "cs": 2e-3, "act": 2e-3, "dg": 1e-2}


def encoder_lstm_phase(model, cfg, log: dict) -> list:
    """The encoder's bf16 BiLSTM recurrence (``ops/encoder_lstm.py``) at the
    train batch's shapes (B=32, T=128 chars, H=256 per direction): forward
    and backward against their plain versions; the forward again at the
    eval paths' shapes on the inputs of real ``_encode`` calls (the say's
    one row; the serve windows of 16 and 64 requests, which the server
    encodes at 64 rows, two of the kernel's 32-row batch groups); then
    timed. The library yardstick is torch's f32 cuDNN LSTM over the same
    input, a different rounding (no bf16 operands)."""
    import torch

    from tacotron2_tpu_torch.ops import encoder_lstm as el
    from tacotron2_tpu_torch.run import server as srv
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 6)
    lstm = model.encoder.lstm
    B, T, H, C = TRAIN_B, 128, lstm.hidden_size, lstm.input_size
    w = torch.stack([lstm.weight_hh_l0, lstm.weight_hh_l0_reverse]).detach()
    wb = w.to(torch.bfloat16).contiguous()
    b = torch.stack([lstm.bias_hh_l0, lstm.bias_hh_l0_reverse]).detach().contiguous()
    xp = torch.randn(2, B, T, 4 * H, device=dev, generator=g)
    fk, fp = el.bilstm_forward(xp, wb, b), el.bilstm_forward_plain(xp, wb, b)
    check("bilstm_forward", list(zip(("hs", "cs", "act"), fk, fp)), ENC_TOL, log)
    dhs = torch.randn(2, B, T, H, device=dev, generator=g) * 1e-2
    bk = el.bilstm_backward(dhs, fp[2], fp[1], wb)
    bp = el.bilstm_backward_plain(dhs, fp[2], fp[1], wb)
    check("bilstm_backward", [("dg", bk, bp)], ENC_TOL, log, own=True)

    prep = cfg.dataset.preprocessing
    encode = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch
    texts = lambda n: [normalize_text(TRAIN_TEXTS[i % len(TRAIN_TEXTS)], prep.allowed_chars,
                                      prep.end_token, False) for i in range(n)]
    say_text = [normalize_text(TEXT, prep.allowed_chars, prep.end_token, False)]
    kernel, seen = el.bilstm_forward, []
    el.bilstm_forward = lambda *args: (seen.append(args), kernel(*args))[1]
    try:
        for tag, batch, bucket, encode_rows in (("say", say_text, 1, None),
                                                ("serve16", texts(16), srv.CHAR_BUCKET, 64),
                                                ("serve64", texts(64), srv.CHAR_BUCKET, 64)):
            ci, cl = encode(batch)
            L = max(bucket, -(-ci.shape[1] // bucket) * bucket)  # as the path pads chars
            ci = torch.nn.functional.pad(torch.as_tensor(ci), (0, L - ci.shape[1])).to(dev)
            model._encode(ci, torch.as_tensor(cl, device=dev), rows=encode_rows)
            args = seen.pop()
            check(f"bilstm_forward[{tag}@B{args[0].shape[1]},T{L}]",
                  list(zip(("hs", "cs", "act"), kernel(*args), el.bilstm_forward_plain(*args))),
                  ENC_TOL, log, "bilstm_forward")
    finally:
        el.bilstm_forward = kernel

    x = torch.randn(B, T, C, device=dev, generator=g)
    f32 = lambda *shape: torch.empty(*shape, device=dev)
    flops = 2 * 2 * B * T * 4 * H * H
    fwd_bytes = nbytes(xp, wb, b, *fp)
    bwd_bytes = nbytes(dhs, fp[1], fp[2], wb, f32(2, B, T, 4 * H))
    rows = []
    for name, kern, plain, lib, nb, fl in (
        ("bilstm_forward", lambda: el.bilstm_forward(xp, wb, b),
         lambda: el.bilstm_forward_plain(xp, wb, b), lambda: lstm(x), fwd_bytes, flops),
        ("bilstm_backward", lambda: el.bilstm_backward(dhs, fp[2], fp[1], wb),
         lambda: el.bilstm_backward_plain(dhs, fp[2], fp[1], wb),
         lstm_backward(lstm, x, torch.float32), bwd_bytes, flops),
    ):
        b_ms, b_by = bound_ms(nb, fl)
        rows.append({
            "name": name, "route": "cuda", "source": "tacotron2_tpu_torch/csrc/encoder_lstm.cu",
            "replaces": "tacotron2_tpu/models/layers.py:284 (lstm_sequence's scan under a bf16 "
                        "policy; XLA, not a Pallas kernel)",
            "ms": time_ms(kern, 3, 1), "plain_ms": time_ms(plain, 2, 1), "bound_ms": b_ms,
            "bound_by": b_by, "eager_ms": eager_ms(kern, 3),
            # the backward's yardstick eagerly (autograd of nn.LSTM)
            "library_ms": eager_ms(lib, 5) if name == "bilstm_backward" else time_ms(lib, 3, 1),
            "per": f"both directions, B={B}, T={T}, H={H}",
        })
    log["bilstm_library"] = ("nn.LSTM f32 (cuDNN): the forward, and the backward of its output "
                             "with the forward outside the timed region (dx and dW too); f32 "
                             "operands, not bf16; yardsticks")
    rows[0]["rows"] = enc_rows(model, cfg, log)
    rows[1]["rows"] = enc_bwd_rows(model, cfg, log)
    return rows


def lstm_backward(lstm, x, dtype):
    """A call that runs the backward of bidirectional ``nn.LSTM`` (cuDNN)
    over x in ``dtype`` from a forward made once, outside it: the gradients
    of the input and every weight for a fixed output cotangent (the library
    yardstick of ``bilstm_backward``, which leaves dx and dW to products
    after its loop)."""
    import copy

    import torch

    m = copy.deepcopy(lstm).to(dtype).train()  # cuDNN's RNN backward wants train mode
    xi = x.to(dtype).detach().requires_grad_(True)
    with torch.enable_grad():
        out = m(xi)[0]
    cot = torch.randn_like(out)
    inputs = [xi, *m.parameters()]
    return lambda: torch.autograd.grad(out, inputs, cot, retain_graph=True)


ENC_INVARIANCE_ROWS = (0, 1, 37, 63)  # rows of a 64-row forward held against the rows alone


def host_ms(fn, reps: int = 20) -> float:
    """Median host-clock time of one call of ``fn``, each call between two
    syncs (what a caller waits for)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def enc_shapes(cfg) -> tuple:
    """The recurrence's shapes on the main paths: (tag, B, T) of the say's
    one row at its own chars, the serve window's 64 rows at CHAR_BUCKET
    (also the controllable config's train batch at T=128), the vanilla train
    batch, and a ragged batch of 37 rows (a partial 8-row tile past the
    first: a last train or validation batch)."""
    from tacotron2_tpu_torch.run import server as srv
    from tacotron2_tpu_torch.text import normalize_text

    prep = cfg.dataset.preprocessing
    say_T = len(normalize_text(TEXT, prep.allowed_chars, prep.end_token, False))
    return (("say", 1, say_T), ("serve64_train64", 64, srv.CHAR_BUCKET),
            ("train32", TRAIN_B, 128), ("ragged37", 37, 128))


def enc_rows(model, cfg, log: dict) -> dict:
    """The encoder's forward recurrence (``bilstm_forward``) at
    ``enc_shapes``: against its plain version (ENC_TOL), device ms by graph
    replay beside its plain version, its bound and ``nn.LSTM`` in f32 and
    in bf16 over the same input (yardsticks: f32 operands, or bf16
    throughout, and the input projection inside; the port never calls
    them); rows ENC_INVARIANCE_ROWS of a 64-row launch against the rows
    alone, bit for bit (fails the run otherwise); the say's whole encoder
    on the host clock, synced, and the recurrence's share of it. Runs this
    tree's package or a parent's (``--root``). -> {tag: readings}"""
    import copy
    import hashlib

    import torch

    from tacotron2_tpu_torch.ops import encoder_lstm as el
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 60)
    lstm = model.encoder.lstm
    H, C = lstm.hidden_size, lstm.input_size
    wb = torch.stack([lstm.weight_hh_l0, lstm.weight_hh_l0_reverse]).detach().to(
        torch.bfloat16).contiguous()
    b = torch.stack([lstm.bias_hh_l0, lstm.bias_hh_l0_reverse]).detach().contiguous()
    lstm16 = copy.deepcopy(lstm).to(torch.bfloat16)
    out: dict = {}
    for tag, B, T in enc_shapes(cfg):
        xp = torch.randn(2, B, T, 4 * H, device=dev, generator=g)
        kern = lambda xp=xp: el.bilstm_forward(xp, wb, b)
        plain = lambda xp=xp: el.bilstm_forward_plain(xp, wb, b)
        got, ref = kern(), plain()
        check(f"bilstm_forward@B{B},T{T}", list(zip(("hs", "cs", "act"), got, ref)), ENC_TOL,
              log, "bilstm_forward")
        b_ms, b_by = bound_ms(nbytes(xp, wb, b, *ref), 2 * 2 * B * T * 4 * H * H)
        x = torch.randn(B, T, C, device=dev, generator=g)
        x16 = x.to(torch.bfloat16)
        reps = (3, 1) if T * B > 64 else (10, 1)
        out[tag] = {"B": B, "T": T, "ms": time_ms(kern, *reps), "plain_ms": time_ms(plain, 2, 1),
                    "bound_ms": b_ms, "bound_by": b_by, "eager_ms": eager_ms(kern, 5),
                    "library_ms": time_ms(lambda: lstm(x), *reps),
                    "library_bf16_ms": time_ms(lambda: lstm16(x16), *reps),
                    "launches_per_call": el.forward_launches(T),
                    "out_sha1": hashlib.sha1(b"".join(t.cpu().numpy().tobytes()
                                                      for t in got)).hexdigest()}
        r = out[tag]
        print(f"  bilstm_forward at B={B}, T={T}: {r['ms']:.4f} ms (bound {b_ms:.4f} ms, "
              f"plain {r['plain_ms']:.3f}, nn.LSTM f32 {r['library_ms']:.4f}, bf16 "
              f"{r['library_bf16_ms']:.4f}, eager {r['eager_ms']:.4f})")
        if B == 64:  # rows of this launch against the same rows alone
            for row in ENC_INVARIANCE_ROWS:
                alone = el.bilstm_forward(xp[:, row:row + 1].contiguous(), wb, b)
                same = all(torch.equal(f[:, row:row + 1], a) for f, a in zip(got, alone))
                log.setdefault("enc_invariance", {})[f"row {row} of {B}, T={T}"] = same
                if not same:
                    raise SmokeFailure(f"bilstm_forward: row {row} alone differs from the same "
                                       f"row of a {B}-row launch")
            print(f"  bilstm_forward: rows {ENC_INVARIANCE_ROWS} of the {B}-row launch equal "
                  "the rows alone, bit for bit")
        del xp, got, ref, x, x16
    prep = cfg.dataset.preprocessing
    ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
        [normalize_text(TEXT, prep.allowed_chars, prep.end_token, False)])
    ci, cl = torch.as_tensor(ci, device=dev), torch.as_tensor(cl, device=dev)
    enc_ms = host_ms(lambda: model._encode(ci, cl))
    say = out["say"]
    out["say_encoder"] = {"host_ms": enc_ms, "chars": int(cl[0]),
                          "recurrence_share": say["eager_ms"] / enc_ms}
    print(f"  the say's whole encoder ({int(cl[0])} chars, host clock, synced): {enc_ms:.4f} ms; "
          f"the forward recurrence (eager {say['eager_ms']:.4f} ms) "
          f"{100 * say['eager_ms'] / enc_ms:.1f}% of it")
    log["enc_rows"] = out
    return out


def enc_bwd_rows(model, cfg, log: dict) -> dict:
    """The encoder's backward recurrence (``bilstm_backward``) at
    ``enc_shapes`` on the forward kernel's activations and a random dh
    (x 1e-2, as the train step's): against its plain version (ENC_TOL's
    dg, to its own max), device ms by graph replay beside its plain
    version and bound, and the backward of bidirectional ``nn.LSTM``
    (cuDNN) in f32 and bf16 over the same rows, its forward outside the
    timed region (``lstm_backward``; yardsticks: the input projection's
    gradients inside); rows ENC_INVARIANCE_ROWS of a 64-row launch against
    the rows alone, bit for bit (fails the run otherwise). Runs this tree's
    package or a parent's (``--root``). -> {tag: readings}"""
    import hashlib

    import torch

    from tacotron2_tpu_torch.ops import encoder_lstm as el

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 62)
    lstm = model.encoder.lstm
    H, C = lstm.hidden_size, lstm.input_size
    wb = torch.stack([lstm.weight_hh_l0, lstm.weight_hh_l0_reverse]).detach().to(
        torch.bfloat16).contiguous()
    b = torch.stack([lstm.bias_hh_l0, lstm.bias_hh_l0_reverse]).detach().contiguous()
    out: dict = {}
    if hasattr(el, "backward_plan"):  # this tree's build (not a parent's)
        out["max_clusters"] = bwd_max_clusters(el._lib(), H)
        print(f"  bilstm_backward: the card runs {out['max_clusters']} of its clusters at once, "
              f"{2 * -(-64 // el.ENC_TILE)} at 64 rows")
    for tag, B, T in enc_shapes(cfg):
        xp = torch.randn(2, B, T, 4 * H, device=dev, generator=g)
        _, cs, act = el.bilstm_forward(xp, wb, b)
        dhs = torch.randn(2, B, T, H, device=dev, generator=g) * 1e-2
        kern = lambda dhs=dhs, act=act, cs=cs: el.bilstm_backward(dhs, act, cs, wb)
        plain = lambda dhs=dhs, act=act, cs=cs: el.bilstm_backward_plain(dhs, act, cs, wb)
        got = kern()
        check(f"bilstm_backward@B{B},T{T}", [("dg", got, plain())], ENC_TOL, log,
              "bilstm_backward", own=True)
        b_ms, b_by = bound_ms(nbytes(dhs, cs, act, wb, got), 2 * 2 * B * T * 4 * H * H)
        x = torch.randn(B, T, C, device=dev, generator=g)
        reps = (3, 1) if T * B > 64 else (10, 1)
        lib32, lib16 = lstm_backward(lstm, x, torch.float32), lstm_backward(lstm, x, torch.bfloat16)
        out[tag] = {"B": B, "T": T, "ms": time_ms(kern, *reps), "plain_ms": time_ms(plain, 2, 1),
                    "bound_ms": b_ms, "bound_by": b_by, "eager_ms": eager_ms(kern, 5),
                    "library_ms": eager_ms(lib32, 5), "library_bf16_ms": eager_ms(lib16, 5),
                    "library_timing": "eager (autograd of nn.LSTM, CUDA events)",
                    "launches_per_call": el.backward_launches(T),
                    "out_sha1": hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()}
        r = out[tag]
        print(f"  bilstm_backward at B={B}, T={T}: {r['ms']:.4f} ms (bound {b_ms:.4f} ms, "
              f"plain {r['plain_ms']:.3f}, eager {r['eager_ms']:.4f}; nn.LSTM backward "
              f"(cuDNN, eager) f32 {r['library_ms']:.4f}, bf16 {r['library_bf16_ms']:.4f})")
        if B == 64:  # rows of this launch against the same rows alone
            for row in ENC_INVARIANCE_ROWS:
                sl = lambda t: t[:, row:row + 1].contiguous()
                same = torch.equal(got[:, row:row + 1],
                                   el.bilstm_backward(sl(dhs), sl(act), sl(cs), wb))
                log.setdefault("enc_invariance", {})[f"backward row {row} of {B}, T={T}"] = same
                if not same:
                    raise SmokeFailure(f"bilstm_backward: row {row} alone differs from the "
                                       f"same row of a {B}-row launch")
            print(f"  bilstm_backward: rows {ENC_INVARIANCE_ROWS} of the {B}-row launch equal "
                  "the rows alone, bit for bit")
        del xp, cs, act, dhs, got, x, lib32, lib16
    log["enc_bwd_rows"] = out
    return out


# copies of csrc/encoder_lstm.cu for the forward's design readings, each
# (name, [(pattern, replacement), ...]): the source; a copy that records
# %globaltimer at the phases of each step (block 0 of direction 0, thread
# 0, the first 64 steps; ``t2_enc_stamps`` reads them back), also at
# 64-row tiles; copies that leave out a phase's memory traffic (readings of
# what it costs, wrong results); tiles of 16 and 64 rows; the defect whose
# reading the smoke holds above ENC_TOL.
ENC_STAMP = "if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && rank == 0 && s < 64) " \
            "enc_stamps[s * 8 + {i}] = gtime();"
ENC_AB = (
    ("source", []),
    ("stamps", ENC_STAMPS := [
        (r"(namespace \{\n)", r"\1__device__ unsigned long long enc_stamps[64 * 8];\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
        (r"(    const uint8_t\* hc = hbuf)", ENC_STAMP.format(i=0) + r"\n\1"),
        (r"(    if \(s \+ 1 < T\) fetch_x\(s \+ 1\);)", ENC_STAMP.format(i=1) + r"\n\1"),
        (r"(    asm volatile\(\"cp\.async\.wait_group 1;)", ENC_STAMP.format(i=2) + r"\n\1"),
        (r"(    // the four gates of unit u)", ENC_STAMP.format(i=3) + r"\n\1"),
        (r"(    if \(s \+ 1 == T\) break;)", ENC_STAMP.format(i=4) + r"\n\1"),
        (r"(\n  \}\n  cluster\.sync\(\);  // no rank leaves)", "\n" + ENC_STAMP.format(i=5) + r"\1"),
        (r"(extern \"C\" \{\n)", r"\1int t2_enc_stamps(void* out) {\n  return (int)"
         "cudaMemcpyFromSymbol(out, enc_stamps, sizeof(enc_stamps));\n}\n"),
    ]),
    ("no_global_stores", [(r"      hs\[st \* H \+ u\] = hv;\n      cs\[st \* H \+ u\] = c\[n\];\n",
                           "      if (hv == 12345.0f) hs[st * H + u] = c[n];\n"),
                          (r"      a\[0\] = ig;\n      a\[H\] = fg;\n      a\[2 \* H\] = gg;\n"
                           r"      a\[3 \* H\] = og;\n", "      if (og == 2.0f) a[0] = ig + fg + gg;\n")]),
    ("no_xp_copies", [(r"cp_async16\(slot \+ b \* o\.xrow \+ q \* EU \+ 4 \* k,\n[^;]*;",
                       "(void)slot;")]),
    ("stamps_tile64", ENC_STAMPS + [(r"constexpr int ETILE = 8;", "constexpr int ETILE = 64;")]),
    ("tile16", [(r"constexpr int ETILE = 8;", "constexpr int ETILE = 16;")]),
    ("tile64", [(r"constexpr int ETILE = 8;", "constexpr int ETILE = 64;")]),
    ("defect_stale_exchange", [(r"const uint8_t\* dst = hn \+ ",
                                "const uint8_t* dst = (p == 0 && rank != 0 ? hc : hn) + ")]),
    # the backward: rank 0 gets the other ranks' dg in the buffer it read
    # this step, so its next product reads theirs from two steps before
    ("defect_bwd_stale_exchange", [(r"const uint8_t\* dst = bn \+ ",
                                    "const uint8_t* dst = (p == 0 && rank != 0 ? bufs + "
                                    "((n + 1) & 1) * bufbytes : bn) + ")]),
)


def build_copies(src_name: str, copies, out_dir: Path, csrc: Path = None, wait: bool = True):
    """nvcc of each copy of ``csrc/<src_name>.cu`` (each a list of regex
    substitutions that must each match once; ``csrc``: another tree's
    sources), all started together -> {name: library path}; with ``wait``
    False, a function that waits for them and returns that."""
    import re

    from tacotron2_tpu_torch.ops import build

    csrc = csrc or Path(build.__file__).parents[1] / "csrc"
    src = (csrc / f"{src_name}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, subs in copies:  # every copy's text before any nvcc starts
        text = src
        for pattern, repl in subs:
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                raise SmokeFailure(f"{src_name} copy {name}: {pattern!r} matches {n} times")
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    libs: dict = {}

    def finish() -> dict:  # waits once; later calls return the same
        for name, proc in procs.items():
            if name in libs:
                continue
            text, _ = proc.communicate()
            if proc.returncode:
                raise SmokeFailure(f"nvcc of the {src_name} copy {name} failed: {text[-2000:]}")
            libs[name] = out_dir / f"lib{name}.so"
        return libs

    return finish() if wait else finish


def enc_ab(model, cfg, log: dict) -> dict:
    """``--enc-ab``: the forward's copies (ENC_AB) at ``enc_shapes`` in
    turns, two rounds, the second in reverse order (device ms by graph
    replay), and the stamps copy's phases a step (ns, median over steps 1-62
    of block 0): the wait for the step's h, the product, the wait for the
    step's xp, the epilogue, the push. Then the backward at ``enc_shapes``
    in turns, parent, change, change, parent: the parent's route built from
    build/parent's ``csrc/encoder_lstm.cu`` (a ``git archive`` of the parent
    unpacked there), called through its own entry (2 T launches, its
    scratch zeroed in each call), against this tree's; both against the
    plain version."""
    import ctypes

    import numpy as np
    import torch

    from tacotron2_tpu_torch.ops import encoder_lstm as el

    paths = build_copies("encoder_lstm", ENC_AB, ROOT / "build" / "enc_ab")
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for fn in (lib.t2_bilstm_forward, lib.t2_bilstm_backward):
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 61)
    lstm = model.encoder.lstm
    H = lstm.hidden_size
    wb = torch.stack([lstm.weight_hh_l0, lstm.weight_hh_l0_reverse]).detach().to(
        torch.bfloat16).contiguous()
    b = torch.stack([lstm.bias_hh_l0, lstm.bias_hh_l0_reverse]).detach().contiguous()
    shapes = [(tag, B, T, torch.randn(2, B, T, 4 * H, device=dev, generator=g))
              for tag, B, T in enc_shapes(cfg)]
    saved, out = el._LIB, {}
    try:
        names = [n for n, _ in ENC_AB if not n.startswith("defect")]
        for order in (names, names[::-1]):
            for name in order:
                el._LIB = libs[name]
                for tag, B, T, xp in shapes:
                    out.setdefault(f"{name}_{tag}", []).append(
                        time_ms(lambda xp=xp: el.bilstm_forward(xp, wb, b), 3, 1))
        phases = ("wait_h", "product", "wait_xp", "epilogue", "push")
        for (tag, B, T, xp), sname in ((sh, n) for n in libs if n.startswith("stamps")
                                       for sh in shapes):
            el._LIB = libs[sname]
            tag = f"{sname}_{tag}"
            el.bilstm_forward(xp, wb, b)
            torch.cuda.synchronize()
            buf = (ctypes.c_uint64 * (64 * 8))()
            build_err = libs[sname].t2_enc_stamps(ctypes.cast(buf, ctypes.c_void_p))
            if build_err:
                raise SmokeFailure(f"t2_enc_stamps: CUDA error {build_err}")
            st = np.frombuffer(buf, dtype=np.uint64).reshape(64, 8).astype(np.int64)
            n = min(T, 64) - 1
            d = np.stack([st[1:n, 1] - st[1:n, 0], st[1:n, 2] - st[1:n, 1],
                          st[1:n, 3] - st[1:n, 2], st[1:n, 4] - st[1:n, 3],
                          st[1:n, 5] - st[1:n, 4], st[2:n + 1, 0] - st[1:n, 0]])
            med = {k: float(np.median(v)) for k, v in zip(phases + ("step",), d)}
            out[f"phases_ns_{tag}"] = med
            print(f"  {sname} forward phases at B={B}, T={T} (ns a step, median): "
                  + ", ".join(f"{k} {v:.0f}" for k, v in med.items()))
    finally:
        el._LIB = saved
    out.update(enc_bwd_ab(model, cfg, libs["source"], wb, H, log))
    for k, v in out.items():
        if isinstance(v, list):
            print(f"  {k}: " + " / ".join(f"{x:.4f}" for x in v) + " ms")
    log["enc_ab"] = out
    return out


# copies of csrc/encoder_lstm.cu for the backward's design readings: one
# block an SM (the first build: a 16th cluster of 8 waits for another to
# end); a copy that records %globaltimer at the phases of each step (block
# 0 of direction 0, thread 0, the first 64 steps; ``t2_bwd_stamps`` reads
# them back)
BWD_STAMP = "if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && rank == 0 && n < 64) " \
            "bwd_stamps[n * 8 + {i}] = gtime();"
ENC_BWD_AB = (
    ("bwd_one_block_per_sm", [(r"__launch_bounds__\(32 \* \(H / ES / 4\), 2\)",
                               "__launch_bounds__(32 * (H / ES / 4), 1)")]),
    ("bwd_stamps", [
        (r"(namespace \{\n)", r"\1__device__ unsigned long long bwd_stamps[64 * 8];\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
        (r"(    if \(n > 0\) \{  // every rank's dg of step s \+ 1 has landed)",
         BWD_STAMP.format(i=0) + r"\n\1"),
        (r"(    if \(s > 0\) fetch\(s - 1, \(n \+ 1\) & 1\);)", BWD_STAMP.format(i=1) + r"\n\1"),
        (r"(    if \(n > 0\) \{\n      const uint8_t\* hr)", BWD_STAMP.format(i=2) + r"\n\1"),
        (r"(    cp_async_wait1\(\);  // this step's act)", BWD_STAMP.format(i=3) + r"\n\1"),
        (r"(    if \(live\) \{\n      float dh_rec)", BWD_STAMP.format(i=4) + r"\n\1"),
        (r"(    if \(n \+ 1 == T\) break;)", BWD_STAMP.format(i=5) + r"\n\1"),
        (r"(\n  \}\n  cluster\.sync\(\);  // every push to this rank)",
         "\n" + BWD_STAMP.format(i=6) + r"\1"),
        (r"(extern \"C\" \{\n)", r"\1int t2_bwd_stamps(void* out) {\n  return (int)"
         "cudaMemcpyFromSymbol(out, bwd_stamps, sizeof(bwd_stamps));\n}\n"),
    ]),
)


def bwd_max_clusters(lib, H: int) -> int:
    """The most clusters of the backward at width H a build runs on the
    card at once (``t2_bilstm_backward_clusters``)."""
    import ctypes

    n = ctypes.c_int(0)
    lib.t2_bilstm_backward_clusters.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    err = lib.t2_bilstm_backward_clusters(H, ctypes.byref(n))
    if err:
        raise SmokeFailure(f"t2_bilstm_backward_clusters: CUDA error {err}")
    return n.value


def enc_bwd_ab(model, cfg, lib, wb, H: int, log: dict) -> dict:
    """The backward in turns (``enc_ab``): the parent's build against this
    tree's (``lib``) and the ENC_BWD_AB copies, at ``enc_shapes`` and at 56
    and 57 rows (the most whose clusters of 8 fit the card with one block an
    SM, and one more tile) -> {"bwd_<build>_<tag>": [ms, ...], ...}."""
    import ctypes

    import numpy as np
    import torch

    from tacotron2_tpu_torch.ops import encoder_lstm as el

    out: dict = {}
    csrc = ROOT / "build" / "parent" / "tacotron2_tpu_torch" / "csrc"
    if not (csrc / "encoder_lstm.cu").exists():
        raise SmokeFailure(f"--enc-ab times the backward against the parent's: unpack git "
                           f"archive <parent> tacotron2_tpu_torch into {csrc.parents[1]}")
    parent = ctypes.CDLL(str(build_copies("encoder_lstm", [("parent", [])],
                                          ROOT / "build" / "enc_ab_parent", csrc)["parent"]))
    parent.t2_bilstm_backward.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                          ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    parent.t2_bilstm_backward.restype = ctypes.c_int
    copies = {}
    for name, path in build_copies("encoder_lstm", ENC_BWD_AB,
                                   ROOT / "build" / "enc_bwd_ab").items():
        copies[name] = ctypes.CDLL(str(path))
        for fn in (copies[name].t2_bilstm_forward, copies[name].t2_bilstm_backward):
            fn.argtypes = parent.t2_bilstm_backward.argtypes
            fn.restype = ctypes.c_int
    for name, l in (("change", lib), *copies.items()):
        out[f"bwd_max_clusters_{name}"] = bwd_max_clusters(l, H)
    print("  clusters of the backward the card runs at once (cudaOccupancyMaxActiveClusters): "
          + ", ".join(f"{k[17:]} {v}" for k, v in out.items() if k.startswith("bwd_max")))

    def parent_bwd(dhs, act, cs):
        _, B, T, _ = dhs.shape
        dg = torch.empty(2, B, T, 4 * H, device=dhs.device)
        scratch = [torch.zeros(2, B, H, device=dhs.device) for _ in range(2)]
        ts = (dhs, act, cs, wb, dg, *scratch)
        err = parent.t2_bilstm_backward((ctypes.c_void_p * 7)(*(t.data_ptr() for t in ts)),
                                        (ctypes.c_int * 3)(B, T, H),
                                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise SmokeFailure(f"the parent's t2_bilstm_backward: CUDA error {err}")
        return dg

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 63)
    b = torch.stack([model.encoder.lstm.bias_hh_l0,
                     model.encoder.lstm.bias_hh_l0_reverse]).detach().contiguous()
    saved = el._LIB
    try:
        shapes = (*enc_shapes(cfg), ("rows56", 56, 128), ("rows57", 57, 128))
        for tag, B, T in shapes:
            el._LIB = lib
            xp = torch.randn(2, B, T, 4 * H, device="cuda", generator=g)
            _, cs, act = el.bilstm_forward(xp, wb, b)
            dhs = torch.randn(2, B, T, H, device="cuda", generator=g) * 1e-2
            ref = el.bilstm_backward_plain(dhs, act, cs, wb)
            bwd = lambda: el.bilstm_backward(dhs, act, cs, wb)
            fns = {"parent": (None, lambda: parent_bwd(dhs, act, cs)), "change": (lib, bwd),
                   **{name: (copy, bwd) for name, copy in copies.items()}}
            order = ["parent", "change", *copies, *copies, "change", "parent"]
            for name in order:
                el._LIB, fn = fns[name][0] or lib, fns[name][1]
                out.setdefault(f"bwd_err_{name}_{tag}", err(fn(), ref, own=True)[1])
                out.setdefault(f"bwd_{name}_{tag}", []).append(time_ms(fn, 3, 1))
            del xp, cs, act, dhs, ref
        # the stamps copy's phases a step (ns, median over steps 1-62 of
        # block 0): the wait for the step's dg, issuing the next step's
        # cp.async, the product, the wait for this step's act / cs / dhs
        # and the block, the pull, the push (with its barrier)
        phases = ("wait_dg", "fetch", "product", "wait_stage", "pull", "push")
        for tag, B, T in enc_shapes(cfg):
            el._LIB = copies["bwd_stamps"]
            xp = torch.randn(2, B, T, 4 * H, device="cuda", generator=g)
            _, cs, act = el.bilstm_forward(xp, wb, b)
            el.bilstm_backward(torch.randn(2, B, T, H, device="cuda", generator=g) * 1e-2,
                               act, cs, wb)
            torch.cuda.synchronize()
            buf = (ctypes.c_uint64 * (64 * 8))()
            if copies["bwd_stamps"].t2_bwd_stamps(ctypes.cast(buf, ctypes.c_void_p)):
                raise SmokeFailure("t2_bwd_stamps failed")
            st = np.frombuffer(buf, dtype=np.uint64).reshape(64, 8).astype(np.int64)
            n = min(T, 64) - 1
            d = [st[1:n, i + 1] - st[1:n, i] for i in range(6)] + [st[2:n + 1, 0] - st[1:n, 0]]
            med = {k: float(np.median(v)) for k, v in zip(phases + ("step",), d)}
            out[f"bwd_phases_ns_{tag}"] = med
            print(f"  backward phases at B={B}, T={T} (ns a step, median): "
                  + ", ".join(f"{k} {v:.0f}" for k, v in med.items()))
    finally:
        el._LIB = saved
    print("  bilstm_backward's error to its own max, parent / change: " + "; ".join(
        f"{tag} {out[f'bwd_err_parent_{tag}']:.2e} / {out[f'bwd_err_change_{tag}']:.2e}"
        for tag, _, _ in shapes))
    return out


# the heads' defect: a copy of csrc/decode_step.cu whose owner adds the
# partial sums of all ranks but the last
HEADS_DEFECT = ("heads_rank_left_out", [(r"for \(int p = 1; p < HD_S; \+\+p\) v \+=",
                                         "for (int p = 1; p < HD_S - 1; ++p) v +=")])


def defect_phase(model, cfg, log: dict) -> None:
    """Fails the run unless each deliberate defect, a copy of the source
    built under build/defects, reads at least DEFECT_MARGIN times its limit
    against the plain version: the heads with one rank's partial sum left
    out (K1_TOL, vanilla at 1 and 64 rows, controls at 16), the encoder's
    forward with rank 0 reading the other ranks' h stale, only its own
    slice fresh (ENC_TOL, at the say's one row and at 64 rows), and the
    backward with rank 0 reading the other ranks' dg stale (ENC_TOL's dg,
    at 1 and 37 rows)."""
    import ctypes

    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl
    from tacotron2_tpu_torch.ops import encoder_lstm as el

    out_dir = ROOT / "build" / "defects"
    heads_lib = dl.bind(ctypes.CDLL(str(build_copies("decode_step", [HEADS_DEFECT],
                                                     out_dir)[HEADS_DEFECT[0]])))
    enc_names = ("defect_stale_exchange", "defect_bwd_stale_exchange")
    enc_paths = build_copies("encoder_lstm", [(n, dict(ENC_AB)[n]) for n in enc_names], out_dir)
    enc_libs = {n: ctypes.CDLL(str(enc_paths[n])) for n in enc_names}
    for lib in enc_libs.values():
        for fn in (lib.t2_bilstm_forward, lib.t2_bilstm_backward):
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 70)
    readings = {}
    pk = dl.pack_decoder(model.prenet, model.decoder, torch.bfloat16)
    H, D = pk.wq.shape[1], pk.w_out.shape[1] - pk.wq.shape[1]
    ctl_pk = ctl_model()[1].make_packed_decoder(quantize=False)
    saved = dl._LIB
    try:
        dl._LIB = heads_lib
        for tag, pack, B in (("heads@B1", pk, 1), ("heads@B64", pk, 64),
                             ("heads[controls]@B16", ctl_pk, 16)):
            rnn_h = torch.randn(B, H, device=dev, generator=g)
            ctx = torch.randn(B, D, device=dev, generator=g)
            E = pack.controls_cols
            ctl = torch.randn(B, E, device=dev, generator=g) if E else None
            got = dl.heads(pack.w_out, pack.b_out, rnn_h, ctx, ctl, wt=pack.wt_out)
            readings[tag] = err(got, dl.heads_plain(pack.w_out, pack.b_out, rnn_h, ctx, None,
                                                    ctl))[1] / K1_TOL
    finally:
        dl._LIB = saved
    lstm = model.encoder.lstm
    Hh = lstm.hidden_size
    wb = torch.stack([lstm.weight_hh_l0, lstm.weight_hh_l0_reverse]).detach().to(
        torch.bfloat16).contiguous()
    b = torch.stack([lstm.bias_hh_l0, lstm.bias_hh_l0_reverse]).detach().contiguous()
    real = el._lib()  # this tree's build, for the backward's inputs
    saved = el._LIB
    try:
        el._LIB = enc_libs["defect_stale_exchange"]
        for tag, B, T in (enc_shapes(cfg)[0], ("serve64_train64", 64, 128)):
            xp = torch.randn(2, B, T, 4 * Hh, device=dev, generator=g)
            got = el.bilstm_forward(xp, wb, b)
            ref = el.bilstm_forward_plain(xp, wb, b)
            readings[f"bilstm_forward@B{B},T{T}"] = max(
                err(x, y)[1] / ENC_TOL[k] for k, x, y in zip(("hs", "cs", "act"), got, ref))
        for B, T in ((1, 96), (37, 128)):
            el._LIB = real
            xp = torch.randn(2, B, T, 4 * Hh, device=dev, generator=g)
            _, cs, act = el.bilstm_forward(xp, wb, b)
            dhs = torch.randn(2, B, T, Hh, device=dev, generator=g) * 1e-2
            el._LIB = enc_libs["defect_bwd_stale_exchange"]
            got = el.bilstm_backward(dhs, act, cs, wb)
            readings[f"bilstm_backward@B{B},T{T}"] = err(
                got, el.bilstm_backward_plain(dhs, act, cs, wb), own=True)[1] / ENC_TOL["dg"]
    finally:
        el._LIB = saved
    log["defects"] = readings
    print("  defects, as multiples of their limits: "
          + ", ".join(f"{k} {v:.1f}x" for k, v in readings.items()))
    low = {k: v for k, v in readings.items() if not v >= DEFECT_MARGIN}
    if low:
        raise SmokeFailure(f"a defective copy reads under {DEFECT_MARGIN}x its limit: {low}")


def _synth_corpus(root: Path, n: int, sr: int = 22050, secs: tuple = (2.0, 4.0)) -> Path:
    """``n`` WAVs at ``sr`` Hz from SEED: harmonic tones with a slow
    envelope and noise, ``secs`` (2-4 s) each, PCM16."""
    import numpy as np

    from tacotron2_tpu_torch.audio.io import write_wav

    rng = np.random.default_rng(SEED)
    speech = root / "speech"
    speech.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        samples = int(rng.uniform(*secs) * sr)
        t = np.arange(samples) / sr
        f0 = rng.uniform(90.0, 250.0) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.2, 1) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        x = sum(np.sin(k * phase) / k for k in range(1, 7))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t) ** 2
        wav = 0.15 * env * x + 0.005 * rng.standard_normal(samples)
        write_wav(str(speech / f"s{i:03d}.wav"), wav.astype(np.float32), sr)
    return speech


def train_setup(root: Path, raw: dict, rows: list, n_val: int) -> Path:
    """The manifest ``rows`` (``header`` first) as ``train.csv``, its first
    ``n_val`` rows as ``val.csv``, and ``raw`` pointed at them as
    ``cfg.json`` under ``root``. -> the config's path"""
    (root / "train.csv").write_text("\n".join(rows) + "\n")
    (root / "val.csv").write_text("\n".join(rows[:n_val + 1]) + "\n")
    raw["dataset"]["train"], raw["dataset"]["val"] = str(root / "train.csv"), str(root / "val.csv")
    cfg_train = root / "cfg.json"
    cfg_train.write_text(json.dumps(raw))
    return cfg_train


def train_run(root: Path, raw: dict, rows: list, n_val: int, speech: Path) -> tuple:
    """``train`` through the CLI entry: 6 steps, then ``--resume-ckpt`` to
    step 8, on the manifest ``rows`` (``header`` first) with the first
    ``n_val`` rows as validation, with K3 and K4's launch counters set to 0
    before and read after; the losses must be finite and fall and the
    launches equal launches per step x T over every decode. -> (config
    path, first run, second run, launches, controls launches, encoder
    launches, losses, the launches wanted)"""
    import numpy as np

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.ops import encoder_lstm as el
    from tacotron2_tpu_torch.ops import train_decode as td

    cfg_train = train_setup(root, raw, rows, n_val)
    base = ["train", "--config", str(cfg_train), "--speech-dir", str(speech),
            "--seed", str(SEED)]
    td.reset_launches()
    el.reset_launches()
    first = cli(base + ["--results-dir", str(root / "r1"), "--max-steps", "6"])
    second = cli(base + ["--results-dir", str(root / "r2"), "--resume-ckpt",
                         first["checkpoint"], "--max-steps", "8"])
    launches, ctl_launches = dict(td.LAUNCHES), dict(td.CONTROLS_LAUNCHES)
    enc_launches = dict(el.LAUNCHES)
    steps = first["steps"] + second["steps"]
    losses = [s["loss"] for s in steps]
    print(f"  losses {[round(x, 4) for x in losses]}; launches {launches}, of them with "
          f"controls {ctl_launches}")
    if [s["step"] for s in steps] != list(range(1, 9)):
        raise SmokeFailure(f"steps {[s['step'] for s in steps]}, want 1..8 across the resume")
    if not all(math.isfinite(x) for x in losses) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise SmokeFailure(f"train losses do not fall: {losses}")
    want = {k: n + _want_k34(second)[k] for k, n in _want_k34(first).items()}
    if launches != want:
        raise SmokeFailure(f"K3/K4 launches {launches}, want {want}")
    if 0 in enc_launches.values():
        raise SmokeFailure(f"the encoder's BiLSTM kernels were not launched in train: "
                           f"{enc_launches}")
    if enc_launches["bilstm_backward"] != len(steps):  # one launch a step
        raise SmokeFailure(f"bilstm_backward launched {enc_launches['bilstm_backward']} times "
                           f"in {len(steps)} train steps, want one a step")
    return str(cfg_train), first, second, launches, ctl_launches, enc_launches, losses, want


def train_perf(first: dict, second: dict, card: str) -> dict:
    """Host clock per step (each step ends in a sync), first step of each
    run left out (cuDNN and allocator warm-up)."""
    import numpy as np

    steady = first["steps"][1:] + second["steps"][1:]
    ms = [s["s"] * 1e3 for s in steady]
    return {"ms_per_step_median": float(np.median(ms)), "ms_per_step": ms,
            "mel_frames_per_s": sum(s["mel_frames"] for s in steady) / sum(s["s"] for s in steady),
            "decode_frames": sorted({s["decode_frames"] for s in first["steps"] + second["steps"]}),
            "card": card}


def train_inputs(cfg_train: str, ckpt: str, speech: Path, root: Path, B: int,
                 seed: int = SEED) -> dict:
    """K3's and K4's inputs at the first ``B`` rows of the manifest under
    ``root``, on the weights of ``ckpt``, as a train step makes them: the
    encoder in train mode (a GST model's style of the batch's mel, a
    description model's embeddings from the manifest's files), the
    prenet's and LSTMs' dropout and random cotangents from a generator
    seeded with ``seed``. -> {model, opt, sched, batch, gen, params, w,
    encoder (the encoder's forward and backward), fwd (K3's arguments but
    the weights), d_mg, d_al}"""
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.data.loader import collate
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron2_tpu_torch.ops import train_decode as td
    from tacotron2_tpu_torch.run.say import model_config_from
    from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest
    from tacotron2_tpu_torch.training import optimizer, step
    from tacotron2_tpu_torch.training.checkpoint import load_model_state

    cfg = load_config(cfg_train)
    dev = torch.device("cuda")
    model = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision))
    load_model_state(ckpt, model)
    model.to(dev)
    opt, sched = optimizer.make_optimizer(model.parameters(), 1e-3, 1e-6)
    rows = read_manifest(str(root / "train.csv"))
    descs = ([r["description_embedding"] or None for r in rows]
             if cfg.model.description_embeddings else None)
    ds = manifest_dataset(cfg, rows, str(speech), cache_dir=str(root / "cache"),
                          **({"descriptions": descs} if descs else {}))
    batch = step.to_device(collate([ds[i] for i in range(B)], 32, 128), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    B, T = batch["mel"].shape[:2]
    L = batch["chars_idx"].shape[1]
    H, C = model.cfg.att_rnn_dim, model.cfg.controls_dim
    named = dict(model.decoder.named_parameters())
    params = [named[k].detach() for k in td.DECODER_PARAMS]
    w = td.pack_weights(params, torch.bfloat16, C)
    spk = batch.get("speaker_id")
    desc = ({"description_embeddings": batch["description_embeddings"]}
            if "description_embeddings" in batch else {})

    def encoder():  # a GST model's style of the batch's mel in train mode, as the step's
        with torch.enable_grad():
            gst = model.gst_embedding(B, batch["mel"], True)
            enc, att_enc, _ = model._encode(batch["chars_idx"], batch["chars_len"], True, gen,
                                            speaker_id=spk, **desc, gst_embedding=gst)
            (enc.sum() + att_enc.sum()).backward()
        return enc.detach(), att_enc.detach()

    enc, att_enc = encoder()
    enc_b, lens = enc.to(torch.bfloat16).contiguous(), batch["chars_len"].to(torch.int32)
    din = model.teacher_decoder_in(batch["mel"], gen)
    dm1, dm2 = td.lstm_masks(T, B, H, gen, dev)
    ctl = td.pad_controls(batch["controls"], C, din[0]) if "controls" in batch else None
    N = w.w_out.shape[0]
    d_mg = torch.randn(T, B, N, device=dev, generator=gen) * 1e-3
    d_al = torch.randn(T, B, L, device=dev, generator=gen) * 1e-3

    return {"model": model, "opt": opt, "sched": sched, "batch": batch, "gen": gen,
            "params": params, "w": w, "encoder": encoder,
            "fwd": (din, enc_b, att_enc.contiguous(), lens, dm1, dm2), "ctl": ctl,
            "d_mg": d_mg, "d_al": d_al}


def train_split(cfg_train: str, ckpt: str, speech: Path, root: Path, B: int, log: dict,
                mode: str = "", tag: str = "", readings: bool = False,
                split: bool = True) -> dict:
    """At the first batch's shapes, on the trained weights of ``ckpt``: K3
    and K4 against their plain versions (K3_TOL_TRAIN; a controllable
    model's with its batch's speakers and controls), their split by kernel,
    and one train step split into its parts, each timed alone, eager,
    ending in a sync (so the parts need not sum to the whole step). ``mode``
    "[controls]" names the kernels line's rows; ``tag`` the log's keys.
    With ``readings`` also K3's and K4's device ms (graph replay) beside
    their plain versions' and their bounds; without ``split`` neither the
    split by kernel nor the step's parts. A description model's batch reads
    the manifest's ``description_embedding`` files. -> the parts (ms)."""
    import torch

    from tacotron2_tpu_torch.ops import train_decode as td
    from tacotron2_tpu_torch.training import optimizer, step

    x = train_inputs(cfg_train, ckpt, speech, root, B)
    model, opt, sched, batch, gen = x["model"], x["opt"], x["sched"], x["batch"], x["gen"]
    params, w, encoder, d_mg, d_al, ctl = (x[k] for k in ("params", "w", "encoder", "d_mg",
                                                          "d_al", "ctl"))
    din, enc_b, att, lens, dm1, dm2 = x["fwd"]
    B, T = batch["mel"].shape[:2]
    L, C = batch["chars_idx"].shape[1], model.cfg.controls_dim

    fwd_args, bwd_args, mg, res_k, _, _ = k34_check(
        f"{mode}{tag}@B{B},T{T}", params, w, din, enc_b, att, lens, dm1, dm2,
        d_mg, d_al, log, K3_TOL_TRAIN, ctl, mode)
    out = td.teacher_backward(*bwd_args)
    kernels = {}
    if readings:
        bounds = teacher_bounds(T, B, L, enc_b.shape[2], C, w, res_k, mg)
        for name, kern, plain, args in (
                ("teacher_forward", td.teacher_forward, td.teacher_forward_plain, fwd_args),
                ("teacher_backward", td.teacher_backward, td.teacher_backward_plain, bwd_args)):
            b_ms, b_by, stream, _ = bounds[name]
            kernels[f"{name}{mode}"] = {
                "B": B, "L": L, "T": T, "D": enc_b.shape[2],
                "ms": time_ms(lambda: kern(*args), 3, 1),
                "plain_ms": time_ms(lambda: plain(*args), 2, 1, 1), "bound_ms": b_ms,
                "bound_by": b_by, "weight_stream_ms": stream, "library_ms": None}
            r = kernels[f"{name}{mode}"]
            print(f"  {name}{mode} at B={B}, L={L}, T={T}, D={enc_b.shape[2]}: {r['ms']:.3f} ms, "
                  f"plain {r['plain_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by}), weight stream "
                  f"{stream:.3f} ms")
    if not split:
        return {"kernels": kernels}
    key = f"k34_kernel_ms_train{mode}{tag}"
    log[key] = {"teacher_forward": kernel_split(lambda: td.teacher_forward(*fwd_args)),
                "teacher_backward": kernel_split(lambda: td.teacher_backward(*bwd_args))}
    for name, split in log[key].items():
        print(f"  {name}{mode}, device ms per kernel (torch.profiler, B={B}, L={L}, T={T}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    def postnet():
        with torch.enable_grad():
            x = mg[..., :-1].transpose(0, 1).contiguous().requires_grad_()
            model.postnet(x, model.policy, True, model.cfg.dropout, gen).sum().backward()

    whole = lambda: step.train_step(model, opt, sched, batch, gen)
    whole()
    parts = {
        "train_step": eager_ms(whole, 3, 1),
        "encoder_fwd_bwd": eager_ms(encoder, 3, 1),
        "k3_teacher_forward": eager_ms(lambda: td.teacher_forward(*fwd_args), 3, 1),
        "k4_teacher_backward": eager_ms(lambda: td.teacher_backward(*bwd_args), 3, 1),
        "dw_gemms_and_sums": eager_ms(
            lambda: td.grads_from(params, w, bwd_args[1], enc_b, out, d_mg), 3, 1),
        "postnet_fwd_bwd": eager_ms(postnet, 3, 1),
        "optimizer": eager_ms(lambda: optimizer.apply_gradients(list(model.parameters()), opt,
                                                                sched), 3, 1),
    }
    parts["sum_of_parts"] = sum(v for k, v in parts.items() if k != "train_step")
    if not mode:
        with cudnn_bilstm():  # the encoder before the repair, apart from the sum
            parts["encoder_fwd_bwd_cudnn_f32_bilstm"] = eager_ms(encoder, 3, 1)
    print(f"  split of one step{mode}{tag} (B={B}, L={L}, T={T}), eager ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return {"split_ms": parts, "split_shape": {"B": B, "L": L, "T": T}, "kernels": kernels}


TRAIN_WAVS = 64


def train_phase(cfg_path: str, g_path: str, log: dict, card: str) -> tuple:
    """``train`` through the CLI entry at the vanilla full width: 64
    synthetic WAVs, batch 32, 6 steps, then ``--resume-ckpt`` to step 8,
    with K3 and K4's launch counters read around both runs; then the trained
    checkpoint through ``say``, and the split of one train step. -> (launches,
    the run: its config, checkpoint, corpus and manifest rows, for 4g)"""
    from tacotron2_tpu_torch.__main__ import main as cli

    root = WORK / "train"
    speech = _synth_corpus(root, TRAIN_WAVS)
    rows = ["text|wav"] + [f"{TRAIN_TEXTS[i % len(TRAIN_TEXTS)]}|s{i:03d}.wav"
                           for i in range(TRAIN_WAVS)]
    cfg_train, first, second, launches, _, enc_launches, losses, want = train_run(
        root, json.loads(Path(cfg_path).read_text()), rows, 32, speech)

    # the trained checkpoint through the port's say
    said = cli(["say", "--config", cfg_train, "--checkpoint", second["checkpoint"],
                "--hifi-gan-checkpoint", g_path, "--text", TRAIN_TEXTS[0],
                "--out", str(root / "trained.wav"), "--random-seed", str(SEED),
                "--max-len-override", "64"])
    if not 1 <= said["n_frames"] <= 64:
        raise SmokeFailure(f"say of the trained checkpoint: {said}")
    perf = train_perf(first, second, card)
    perf.update(train_split(cfg_train, second["checkpoint"], speech, root, TRAIN_B, log))
    print(f"  train: {perf['ms_per_step_median']:.1f} ms/step (median), "
          f"{perf['mel_frames_per_s']:.0f} mel frames/s at B={TRAIN_B}, decode frames "
          f"{perf['decode_frames']}, on {card}")
    log["train"] = {"losses": losses, "launches": {**launches, **enc_launches}, "want": want,
                    "perf": perf, "say": said}
    run = {"cfg": cfg_train, "ckpt": second["checkpoint"], "speech": speech, "root": root,
           "rows": rows}
    return {**launches, **enc_launches}, run


CTL_TRAIN_B = 64  # the controllable config's batch
CTL_TRAIN_WAVS = 128


def train_controls_phase(g_path: str, log: dict, card: str) -> tuple:
    """``train`` through the CLI entry on ``config/controllable-lj-hifi-stop-speaker.json``
    at its full width and batch 64: 128 synthetic WAVs of speakers 0-3 with
    the five feature columns uniform in [-1, 1], a 32-row val manifest; 6
    steps, then a resume to 8, the launches held as in ``train_phase`` and
    every K3 / K4 launch one of the controls mode; the speaker embedding's
    rows of the speakers seen must have moved from the seed's init. Then
    ``say --speaker-id 2 --controls CTL_VALUES`` of the trained checkpoint
    (K1's controls rows), the split of one step at B=64, and K3 / K4 at the
    first batch's shapes. -> ({kernels-line row: launches}, the run, as
    ``train_phase``'s)"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron2_tpu_torch.ops import decoder_loop
    from tacotron2_tpu_torch.run.say import model_config_from
    from tacotron2_tpu_torch.training.checkpoint import load_model_state

    root = WORK / "train_controls"
    speech = _synth_corpus(root, CTL_TRAIN_WAVS)
    cfg_path = ROOT / "config" / CTL_CONFIG
    raw = json.loads(cfg_path.read_text())
    feats = raw["extensions"]["controls"]["features"]
    rng = np.random.default_rng(SEED + 9)
    rows = ["|".join(["text", "wav", "speaker_id", *feats])] + [
        "|".join([TRAIN_TEXTS[i % len(TRAIN_TEXTS)], f"s{i:03d}.wav", str(i % 4),
                  *(repr(float(x)) for x in rng.uniform(-1, 1, len(feats)))])
        for i in range(CTL_TRAIN_WAVS)]
    cfg_train, first, second, launches, ctl_launches, enc_launches, losses, want = train_run(
        root, raw, rows, 32, speech)
    if ctl_launches != want:
        raise SmokeFailure(f"K3/K4 launches of the controls mode {ctl_launches}, want {want}")

    cfg = load_config(cfg_train)
    torch.manual_seed(SEED)  # do_train's init from --seed
    table0 = Tacotron2(model_config_from(cfg),
                       Policy.from_string(cfg.training.precision)).speaker_embedding.weight
    trained = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision))
    load_model_state(second["checkpoint"], trained)
    moved = (trained.speaker_embedding.weight - table0).abs().amax(1).tolist()
    print(f"  speaker embedding rows moved by (max abs): {moved}")
    if not all(m > 0 for m in moved):
        raise SmokeFailure(f"the speaker embedding's rows of the speakers seen did not move: "
                           f"{moved}")

    decoder_loop.reset_launches()
    said = cli(["say", "--config", cfg_train, "--checkpoint", second["checkpoint"],
                "--hifi-gan-checkpoint", g_path, "--text", TRAIN_TEXTS[0],
                "--out", str(root / "trained.wav"), "--random-seed", str(SEED),
                "--max-len-override", "64", "--speaker-id", str(CTL_SPEAKER),
                "--controls", CTL_VALUES])
    said_ctl = dict(decoder_loop.CONTROLS_LAUNCHES)
    print(f"  say --speaker-id {CTL_SPEAKER} --controls {CTL_VALUES} of the trained "
          f"checkpoint: {said}; launches reading the controls {said_ctl}")
    if not 1 <= said["n_frames"] <= 64 or min(said_ctl["heads"],
                                              said_ctl["lstm_cell"]) < said["n_frames"]:
        raise SmokeFailure(f"say of the trained controllable checkpoint: {said}, {said_ctl}")
    perf = train_perf(first, second, card)
    perf.update(train_split(cfg_train, second["checkpoint"], speech, root, CTL_TRAIN_B, log,
                            "[controls]"))
    print(f"  train [controls]: {perf['ms_per_step_median']:.1f} ms/step (median), "
          f"{perf['mel_frames_per_s']:.0f} mel frames/s at B={CTL_TRAIN_B}, decode frames "
          f"{perf['decode_frames']}, on {card}")
    log["train_controls"] = {"losses": losses, "launches": {**launches, **enc_launches},
                             "controls_launches": ctl_launches, "want": want,
                             "speaker_rows_moved": moved, "perf": perf, "say": said,
                             "say_controls_launches": said_ctl}
    run = {"cfg": cfg_train, "ckpt": second["checkpoint"], "speech": speech, "root": root,
           "rows": rows}
    return {f"{k}[controls]": n for k, n in ctl_launches.items()}, run


def say_phase(cfg_path: str, log: dict, card: str):
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning
    from tacotron2_tpu_torch.models import hifigan as hifigan_mod
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.ops import decoder_loop, encoder_lstm, mrf
    from tacotron2_tpu_torch.run.say import (cut_vocode, load_hifigan, load_tacotron,
                                             vocode_bucket)
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    cfg = load_config(cfg_path)
    WORK.mkdir(parents=True, exist_ok=True)
    ckpt = {}
    for tag, bias in (("run", 10.0), ("stop", -10.0)):
        m = random_tacotron(cfg, bias)
        ckpt[tag] = str(WORK / f"tacotron2-{tag}.ckpt")
        torch.save(to_lightning(m.state_dict()), ckpt[tag])
        n_params = sum(p.numel() for p in m.parameters())
    g_path = write_hifigan()
    print(f"  tacotron2 params {n_params}, checkpoints in {WORK}")

    def say(tag, max_len, out):
        return cli(["say", "--config", cfg_path, "--checkpoint", ckpt[tag],
                    "--hifi-gan-checkpoint", g_path, "--text", TEXT, "--out", out,
                    "--random-seed", str(SEED), "--max-len-override", str(max_len)])

    wav_path = str(WORK / "say.wav")
    say("run", 256, wav_path)  # warm-up: first cuDNN / allocator use
    decoder_loop.reset_launches()
    mrf.reset_launches()
    encoder_lstm.reset_launches()
    packs0 = hifigan_mod.PACK_CALLS[0]
    res = say("run", 256, wav_path)
    launches = {**decoder_loop.LAUNCHES, **mrf.LAUNCHES, **mrf.F32_LAUNCHES,
                "bilstm_forward": encoder_lstm.LAUNCHES["bilstm_forward"]}
    packs = hifigan_mod.PACK_CALLS[0] - packs0
    print(f"  say 256: {res}")
    print(f"  launches in that run: {launches}; HiFi-GAN weight packings: {packs}")
    check_vocode_launches(launches, 1, "say")
    if launches["bilstm_forward"] != 1:  # one encoder call, one persistent launch
        raise SmokeFailure(f"say launched bilstm_forward {launches['bilstm_forward']} times, "
                           "want 1")
    if packs != 1:
        raise SmokeFailure(f"say packed the HiFi-GAN's weights {packs} times, want 1")
    if res["n_frames"] != 256:
        raise SmokeFailure(f"forced full decode gave {res['n_frames']} frames, want 256")
    for k, n in launches.items():
        if k in k2_launch_keys():  # K2: the f32 plan exactly, none of the bf16 mode (above)
            continue
        if (n == 0) != (k in K5_KERNELS):  # K5 is the int8 path's, below
            raise SmokeFailure(f"kernel {k} was launched {n} times on the say path")
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

    # the say's vocode (f32, K2's f32 mode) against the plain f32 vocode of
    # the same 256-frame decode (held to VOCODE_F32_LSB); then K2's bf16 mode
    # (a generator built under a bf16 policy, as the TPU kernels' bf16=True)
    # against it, reported, its launches counted as the bf16 mode's path
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    full = model.forward_infer_fast(ci, cl, 256, generator=gen)
    cut = max(int(full.n_frames) - 1, 1)
    h_32 = load_hifigan(g_path, dev)
    if h_32.policy.compute_dtype != torch.float32:
        raise SmokeFailure(f"load_hifigan gave {h_32.policy}, want F32 (JAX's load_hifigan)")
    Tb = vocode_bucket(h_32, cut)
    pcm_32 = cut_vocode(h_32, full.mels_post, [0], [cut], Tb)[0, :cut * 256].long()
    pcm_plain = cut_vocode(h_32, full.mels_post, [0], [cut], Tb, plain=True)[0, :cut * 256].long()
    lsb32 = (pcm_32 - pcm_plain).abs().float()
    f32_vocode = {"max_lsb": float(lsb32.max()), "mean_lsb": float(lsb32.mean()),
                  "samples": pcm_32.numel(), "tol_lsb": VOCODE_F32_LSB}
    print(f"  the say's vocode (K2 f32) against the plain f32 vocode, PCM16 LSB: {f32_vocode}")
    if pcm_32.numel() != cut * 256 or not f32_vocode["max_lsb"] <= VOCODE_F32_LSB:
        raise SmokeFailure(f"the say's f32 vocode: {f32_vocode}")
    h_bf = load_hifigan(g_path, dev, Policy(torch.bfloat16))
    cut_vocode(h_bf, full.mels_post, [0], [cut], Tb)  # packs the bf16 copies
    mrf.reset_launches()
    pcm_bf = cut_vocode(h_bf, full.mels_post, [0], [cut], Tb)[0, :cut * 256].long()
    bf16_launches = dict(mrf.LAUNCHES)
    check_vocode_launches({**bf16_launches, **mrf.F32_LAUNCHES}, 1, "the bf16 generator's vocode",
                          torch.bfloat16)
    launches.update(bf16_launches)
    lsb = (pcm_bf - pcm_32).abs().float()
    vocoder_precision = {
        "max_lsb": float(lsb.max()), "mean_lsb": float(lsb.mean()),
        "share_over_2_lsb": float((lsb > 2).float().mean()),
        "f32_max_abs": float(pcm_32.abs().max()),
        "f32_rms": float(pcm_32.float().pow(2).mean().sqrt()), "samples": pcm_32.numel(),
    }
    print(f"  vocoder bf16 (K2's bf16 mode, reported) vs f32 (K2's f32 mode), PCM16 LSB, random "
          f"weights: {vocoder_precision}")
    del h_bf

    # the parts of forward_infer_fast around the decode loop, eager; the
    # encoder also as it ran before the bf16 repair
    with cudnn_bilstm():
        encode_before = eager_ms(lambda: model._encode(ci, cl), 5)
    parts_ms = {
        "encode": eager_ms(lambda: model._encode(ci, cl), 5),
        "encode_cudnn_f32_bilstm": encode_before,
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
    log["say"] = {"run": res, "stop": stop, "perf": perf, "vocoder_precision": vocoder_precision,
                  "f32_vocode_vs_plain": f32_vocode}
    return launches, g_path, ckpt["run"]


def say_int8_phase(cfg_path: str, ckpt: str, g_path: str, log: dict, card: str) -> dict:
    """``say --quantize-int8`` through the CLI entry, forced to 256 frames,
    with the launch counters read around it (K5: two launches a frame of
    each of its kernels, K1's bf16 cell none); then the int8 decode against
    the bf16 decode of the same seed, as mean relative mels_post error and
    gate drift. -> K5's launches by kernel."""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.ops import decoder_loop, mrf
    from tacotron2_tpu_torch.run.say import load_tacotron
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    out = str(WORK / "say_int8.wav")
    say = lambda: cli(["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint",
                       g_path, "--text", TEXT, "--out", out, "--random-seed", str(SEED),
                       "--max-len-override", "256", "--quantize-int8"])
    say()  # warm-up
    decoder_loop.reset_launches()
    mrf.reset_launches()
    res = say()
    launches = {**decoder_loop.LAUNCHES, **mrf.LAUNCHES, **mrf.F32_LAUNCHES}
    print(f"  say --quantize-int8 256: {res}")
    print(f"  launches in that run: {launches}")
    if res["n_frames"] != 256:
        raise SmokeFailure(f"forced int8 decode gave {res['n_frames']} frames, want 256")
    check_vocode_launches(launches, 1, "int8 say")
    want = {"lstm_cell_int8": 2 * 256, "quantize_xh": 2 * 256, "lstm_cell": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise SmokeFailure(f"int8 say: launches {[launches[k] for k in want]}, want {want}")
    for k, n in launches.items():
        if n == 0 and k != "lstm_cell" and k not in k2_launch_keys():
            raise SmokeFailure(f"kernel {k} was not launched on the int8 say path")
    wav, _ = read_wav(out)
    if len(wav) != res["cut"] * 256 or not np.isfinite(wav).all():
        raise SmokeFailure(f"bad int8 wav: {len(wav)} samples for cut {res['cut']}")

    dev = torch.device("cuda")
    cfg = load_config(cfg_path)
    prep = cfg.dataset.preprocessing
    model = load_tacotron(cfg, ckpt, dev)
    ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
        [normalize_text(TEXT, prep.allowed_chars, prep.end_token, False)])
    ci, cl = torch.as_tensor(ci, device=dev), torch.as_tensor(cl, device=dev)
    outs = []
    for quantize in (False, True):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        outs.append(model.forward_infer_fast(ci, cl, 256, generator=gen, quantize=quantize))
    n = min(o.n_frames for o in outs)
    a, b = (o.mels_post[:, :n] for o in outs)
    divergence = {"mels_post_mean_rel": float((a - b).abs().mean() / a.abs().mean()),
                  "gate_drift": float((outs[0].gates[:, :n] - outs[1].gates[:, :n]).abs().max()),
                  "frames": n}
    perf = {"decode_us_per_step": res["decode_s"] / res["n_frames"] * 1e6,
            "vocoder_us_per_frame": res["vocode_s"] / res["cut"] * 1e6,
            "rtf": res["say_s"] / res["audio_s"], "card": card}
    print(f"  int8 decode {perf['decode_us_per_step']:.1f} us/step, RTF {perf['rtf']:.4f}; "
          f"int8 vs bf16 (same seed, {n} frames): {divergence} on {card}")
    for key, lim in INT8_DIVERGENCE.items():
        if not divergence[key] <= lim:
            log.setdefault("deferred", []).append(
                f"int8 vs bf16 {key} {divergence[key]:.3e} > {lim}")
    log["say_int8"] = {"run": res, "launches": launches, "perf": perf, "divergence": divergence}
    return {k: launches[k] for k in K5_KERNELS}


def _post(port: int, payload: dict) -> tuple:
    """POST /generate -> (status, body, seconds on the host clock)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, time.perf_counter() - t0


def _get(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return json.loads(r.read())


def serve_phase(cfg_path: str, ckpt: str, g_path: str, log: dict, card: str) -> dict:
    """The warm server in this process, through ``do_server`` (the function
    the CLI's ``server`` calls), with a bf16 and an int8 entry of the random
    full-width checkpoint (gate forced positive, max_len 256) and the
    default batching (8 ms window, max 64, depth 2): one warm-up request per
    model, a wave of 16 concurrent requests per model, then a wave of 64 to
    each, with the launch counters read around the waves; two
    batched requests again alone; one request through Griffin-Lim; the
    kernels held against their plain versions at the windows' shapes
    (``serve_checks``); then ``python -m tacotron2_tpu_torch server`` as a
    process of its own.
    -> K5's and the encoder recurrence's launches in the waves."""
    import concurrent.futures
    import os
    import threading

    import numpy as np

    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.models import hifigan as hifigan_mod
    from tacotron2_tpu_torch.ops import decoder_loop, encoder_lstm, mrf
    from tacotron2_tpu_torch.run import server as srv

    root = WORK / "serve"
    root.mkdir(parents=True, exist_ok=True)
    entry = {"config": cfg_path, "checkpoint": ckpt, "hifi_gan_checkpoint": g_path,
             "max_len": 256, "multi_speaker": False, "controllable": False, "num_voices": 1}
    config = {"models": [dict(entry, name="vanilla-bf16"),
                         dict(entry, name="vanilla-int8", quantize_int8=True)],
              "batching": {"enabled": True, "window_ms": 8, "max_batch": 64, "depth": 2},
              "warmup": False}
    cfg_file = root / "server.json"
    cfg_file.write_text(json.dumps(config))
    cwd = os.getcwd()
    os.chdir(root)
    started, holder = threading.Event(), {}
    thread = threading.Thread(target=lambda: holder.setdefault("result", srv.do_server(
        0, config, "warm", host="127.0.0.1",
        on_start=lambda h: (holder.setdefault("httpd", h), started.set()))), daemon=True)
    wav_len = lambda body: len(read_wav(str(root / body["path"]))[0])
    try:
        thread.start()
        while not started.wait(0.5):
            if not thread.is_alive():
                raise SmokeFailure("the server did not start")
        port = holder["httpd"].server_address[1]
        for m in (0, 1):  # loads the model, first cuDNN use
            status, body, _ = _post(port, {"text": TEXT, "model": m, "seed": 1})
            if status != 200:
                raise SmokeFailure(f"warm-up request to model {m}: {status} {body}")

        def wave(model: int, n: int) -> tuple:
            payloads = [{"text": TRAIN_TEXTS[i % len(TRAIN_TEXTS)], "model": model, "seed": 100 + i}
                        for i in range(n)]
            barrier = threading.Barrier(n)

            def one(p):
                barrier.wait()
                return _post(port, p)

            calls0, rows0 = srv.BATCH_CALLS
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(n) as ex:
                replies = list(ex.map(one, payloads))
            wall = time.perf_counter() - t0
            bad = [(s, b) for s, b, _ in replies if s != 200]
            if bad:
                raise SmokeFailure(f"wave of {n} to model {model}: {bad[:2]}")
            lat = np.array([sec for _, _, sec in replies])
            frames = sum(wav_len(b) for _, b, _ in replies) / 256
            calls, rows = srv.BATCH_CALLS[0] - calls0, srv.BATCH_CALLS[1] - rows0
            stats = {"requests": n, "decode_launches": calls, "rows_per_launch": rows / calls,
                     "p50_s": float(np.percentile(lat, 50)), "p95_s": float(np.percentile(lat, 95)),
                     "wall_s": wall, "mel_frames": frames, "mel_frames_per_s": frames / wall}
            print(f"  wave of {n} to {config['models'][model]['name']}: {stats} on {card}")
            if not stats["rows_per_launch"] > 1:
                raise SmokeFailure(f"the wave of {n} did not coalesce: {stats}")
            return stats, payloads, replies

        decoder_loop.reset_launches()
        mrf.reset_launches()
        encoder_lstm.reset_launches()
        packs0 = hifigan_mod.PACK_CALLS[0]
        waves, calls = {}, {}
        for key, model, n in (("bf16_16", 0, 16), ("int8_16", 1, 16), ("bf16_64", 0, 64),
                              ("int8_64", 1, 64)):
            waves[key], *rest = wave(model, n)
            calls[model] = calls.get(model, 0) + waves[key]["decode_launches"]
            if key == "bf16_16":
                payloads, replies = rest
        launches = {**decoder_loop.LAUNCHES, **mrf.LAUNCHES, **mrf.F32_LAUNCHES,
                    "bilstm_forward": encoder_lstm.LAUNCHES["bilstm_forward"]}
        packs = hifigan_mod.PACK_CALLS[0] - packs0
        print(f"  launches in the waves: {launches}; HiFi-GAN weight packings: {packs}")
        want = {"lstm_cell": 2 * 256 * calls[0], "lstm_cell_int8": 2 * 256 * calls[1],
                "quantize_xh": 2 * 256 * calls[1]}
        if any(launches[k] != v for k, v in want.items()) or any(
                n == 0 for k, n in launches.items() if k not in k2_launch_keys()):
            raise SmokeFailure(f"serve launches {launches}, want {want} and every kernel "
                               "(K2 in its f32 mode)")
        check_vocode_launches(launches, sum(calls.values()), "serve waves")
        if packs != 0:
            raise SmokeFailure(f"the warm server packed the HiFi-GAN's weights {packs} times "
                               "in the waves, want 0 (once per model, at its first request)")

        # batch invariance: two batched requests again, each alone
        invariance = []
        for i in (0, 5):
            status, solo, _ = _post(port, payloads[i])
            a = read_wav(str(root / replies[i][1]["path"]))[0]
            b = read_wav(str(root / solo["path"]))[0]
            if status != 200 or len(a) != len(b):  # the cut is at the first gate fire
                raise SmokeFailure(f"request {i} alone: {status}, {len(b)} samples, "
                                   f"batched {len(a)}")
            lsb = np.abs(np.round(a * 32768) - np.round(b * 32768))
            invariance.append({"request": i, "samples": len(a), "max_lsb": float(lsb.max()),
                               "mean_lsb": float(lsb.mean())})
        print(f"  batched vs alone, PCM16 LSB: {invariance}")
        worst = max(x["max_lsb"] for x in invariance)
        if not worst <= SERVE_INVARIANCE_LSB:
            log.setdefault("deferred", []).append(
                f"batched vs alone differ by {worst} LSB > {SERVE_INVARIANCE_LSB}")

        status, body, sec = _post(port, {"text": TEXT, "model": 0, "seed": 3,
                                         "use_vocoder": False})
        gl_samples = wav_len(body) if status == 200 else None
        print(f"  Griffin-Lim request: {status}, {gl_samples} samples in {sec:.3f} s")
        if gl_samples != (255 - 1) * 256:  # cut 255; Griffin-Lim is one hop shorter
            raise SmokeFailure(f"Griffin-Lim request: {status} {body}, {gl_samples} samples")
        stats = _get(port, "/stats")
        split = serve_split(holder["httpd"].app.registry)
        vocode_pcm = serve_checks(holder["httpd"].app.registry, log)
    finally:
        if "httpd" in holder:
            holder["httpd"].shutdown()
        thread.join(60)
        os.chdir(cwd)

    sub = _serve_subprocess(cfg_file, root)
    log["serve"] = {"waves": waves, "launches": launches, "invariance": invariance,
                    "griffin_lim_s": sec, "stats": stats, "split_ms": split,
                    "vocode_kernel_vs_plain_pcm": vocode_pcm, "subprocess": sub, "card": card}
    return {k: launches[k] for k in (*K5_KERNELS, "bilstm_forward")}


def say_controls_phase(g_path: str, log: dict, card: str) -> tuple:
    """``say --speaker-id 2 --controls CTL_VALUES`` through the CLI entry on
    random full-width weights of the controllable config (seed 7, saved as
    a reference Lightning ``.ckpt``; gate forced so that the decode runs 256
    frames), bf16 and then ``--quantize-int8``, with the launch counters set
    to 0 before each run and read after: 5 decode launches a step (7 in
    int8), the decoder cell (its quantize_xh) and the heads reading the
    controls at every step, K2 one vocode; then the kernel decode against
    the plain decode over 32 frames with the say's voice and controls
    (DECODE_TOL), and int8 against bf16 (INT8_DIVERGENCE, as the vanilla
    say). -> (the checkpoint, {kernels-line row: launches})"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning
    from tacotron2_tpu_torch.ops import decoder_loop, mrf
    from tacotron2_tpu_torch.run.say import load_tacotron
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    cfg_path = str(ROOT / "config" / CTL_CONFIG)
    cfg = load_config(cfg_path)
    ckpt = str(WORK / "tacotron2-controls.ckpt")
    torch.save(to_lightning(random_tacotron(cfg, 10.0).state_dict()), ckpt)
    out = str(WORK / "say_controls.wav")
    say = lambda quant: cli(
        ["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint", g_path,
         "--text", TEXT, "--out", out, "--random-seed", str(SEED), "--max-len-override", "256",
         "--speaker-id", str(CTL_SPEAKER), "--controls", CTL_VALUES]
        + (["--quantize-int8"] if quant else []))
    ctl_launches = {k: 0 for k in CTL_KERNELS}
    runs = {}
    for quant in (False, True):
        mode = "int8" if quant else "bf16"
        say(quant)  # warm-up
        decoder_loop.reset_launches()
        mrf.reset_launches()
        res = say(quant)
        launches = {**decoder_loop.LAUNCHES, **mrf.LAUNCHES, **mrf.F32_LAUNCHES}
        ctl = dict(decoder_loop.CONTROLS_LAUNCHES)
        print(f"  say --speaker-id {CTL_SPEAKER} --controls {CTL_VALUES}"
              f"{' --quantize-int8' if quant else ''}: {res}")
        print(f"  launches in that run: {launches}; of them reading the controls: {ctl}")
        if res["n_frames"] != 256:
            raise SmokeFailure(f"controllable {mode} say gave {res['n_frames']} frames, want 256")
        check_vocode_launches(launches, 1, f"controllable {mode} say")
        cell, other = ("lstm_cell_int8", "lstm_cell") if quant else ("lstm_cell", "lstm_cell_int8")
        want = {"prenet": 256, cell: 512, other: 0, "location_attention": 256, "heads": 256,
                "quantize_xh": 512 if quant else 0}
        want_ctl = {cell: 256, other: 0, "heads": 256, "quantize_xh": 256 if quant else 0}
        if ({k: launches[k] for k in want} != want
                or ctl != want_ctl or sum(want.values()) != (7 if quant else 5) * 256):
            raise SmokeFailure(f"controllable {mode} say: launches {launches}, of them reading "
                               f"the controls {ctl}; want {want} and {want_ctl}")
        ctl_launches[f"{cell}[controls]"] += ctl[cell]
        ctl_launches["heads[controls]"] += ctl["heads"]
        wav, _ = read_wav(out)
        if len(wav) != res["cut"] * 256 or not np.isfinite(wav).all() or not np.abs(wav).max() > 0:
            raise SmokeFailure(f"bad controllable wav: {len(wav)} samples for cut {res['cut']}")
        perf = {"decode_us_per_step": res["decode_s"] / res["n_frames"] * 1e6,
                "vocoder_us_per_frame": res["vocode_s"] / res["cut"] * 1e6,
                "say_s": res["say_s"], "audio_s": res["audio_s"],
                "rtf": res["say_s"] / res["audio_s"], "card": card}
        print(f"  controllable {mode} say: decode {perf['decode_us_per_step']:.1f} us/step, "
              f"vocoder {perf['vocoder_us_per_frame']:.1f} us/frame, RTF {perf['rtf']:.4f} on "
              f"{card}")
        runs[mode] = {"run": res, "launches": launches, "controls_launches": ctl, "perf": perf}

    dev = torch.device("cuda")
    model = load_tacotron(cfg, ckpt, dev)
    prep = cfg.dataset.preprocessing
    ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
        [normalize_text(TEXT, prep.allowed_chars, prep.end_token, False)])
    ci, cl = torch.as_tensor(ci, device=dev), torch.as_tensor(cl, device=dev)
    kw = dict(speaker_id=torch.tensor([CTL_SPEAKER]),
              controls=torch.tensor([[float(x) for x in CTL_VALUES.split(",")]], device=dev))
    fast = model.forward_infer_fast(ci, cl, 32, prenet_dropout=False, **kw)
    ref = model.forward_infer(ci, cl, 32, prenet_dropout=False, **kw)
    if fast.n_frames != ref.n_frames or not torch.equal(fast.lengths, ref.lengths):
        raise SmokeFailure("controllable kernel decode and plain decode disagree on frames")
    check("decode_32_frames[controls]", [("mels_post", fast.mels_post, ref.mels_post),
                                         ("gates", fast.gates, ref.gates),
                                         ("alignments", fast.alignments, ref.alignments)],
          DECODE_TOL, log)
    outs = []
    for quantize in (False, True):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        outs.append(model.forward_infer_fast(ci, cl, 256, generator=gen, quantize=quantize, **kw))
    n = min(o.n_frames for o in outs)
    a, b = (o.mels_post[:, :n] for o in outs)
    divergence = {"mels_post_mean_rel": float((a - b).abs().mean() / a.abs().mean()),
                  "gate_drift": float((outs[0].gates[:, :n] - outs[1].gates[:, :n]).abs().max()),
                  "frames": n}
    print(f"  controllable int8 vs bf16 (same seed, voice, controls): {divergence}")
    for key, lim in INT8_DIVERGENCE.items():
        if not divergence[key] <= lim:
            log.setdefault("deferred", []).append(
                f"controllable int8 vs bf16 {key} {divergence[key]:.3e} > {lim}")
    log["say_controls"] = {**runs, "divergence": divergence}
    del model
    return ckpt, ctl_launches


def serve_controls_phase(ckpt: str, g_path: str, log: dict, card: str) -> dict:
    """The warm server in this process (``do_server`` on a thread) with a
    bf16 and an int8 entry of the controllable checkpoint (``multi_speaker``
    and ``controllable``, max_len 256, the default batching): a warm-up
    request to each; the launch counters set to 0; a wave of 16 concurrent
    requests to each with mixed voices and controls (every fourth by the
    reference page's named sliders), which must coalesce (rows per launch >
    1) and read the controls in the decoder cell and the heads at every
    step of every decode launch; the counters read; then three requests of
    each wave alone, whose audio must equal the batched audio (0 PCM16
    LSB). -> {kernels-line row: launches}"""
    import concurrent.futures
    import os
    import threading

    import numpy as np

    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.ops import decoder_loop
    from tacotron2_tpu_torch.run import server as srv

    root = WORK / "serve_controls"
    root.mkdir(parents=True, exist_ok=True)
    entry = {"config": str(ROOT / "config" / CTL_CONFIG), "checkpoint": ckpt,
             "hifi_gan_checkpoint": g_path, "max_len": 256, "multi_speaker": True,
             "controllable": True, "num_voices": 4}
    config = {"models": [dict(entry, name="controllable-bf16"),
                         dict(entry, name="controllable-int8", quantize_int8=True)],
              "batching": {"enabled": True, "window_ms": 8, "max_batch": 64, "depth": 2},
              "warmup": False}
    cwd = os.getcwd()
    os.chdir(root)
    started, holder = threading.Event(), {}
    thread = threading.Thread(target=lambda: holder.setdefault("result", srv.do_server(
        0, config, "warm", host="127.0.0.1",
        on_start=lambda h: (holder.setdefault("httpd", h), started.set()))), daemon=True)

    def payload(model: int, i: int) -> dict:
        values = [round(((3 * i + 5 * j) % 9 - 4) / 4, 2) for j in range(5)]
        p = {"text": TRAIN_TEXTS[i % len(TRAIN_TEXTS)], "model": model, "seed": 300 + i,
             "voice": i % 4}
        if i % 4 == 3:  # the reference page's sliders
            p.update(zip(srv.CONTROL_SLIDERS, values))
        else:
            p["controls"] = values
        return p

    waves, invariance = {}, []
    try:
        thread.start()
        while not started.wait(0.5):
            if not thread.is_alive():
                raise SmokeFailure("the controllable server did not start")
        port = holder["httpd"].server_address[1]
        for m in (0, 1):
            status, body, _ = _post(port, {"text": TEXT, "model": m, "seed": 1, "voice": 1,
                                           "controls": [0.0] * 5})
            if status != 200:
                raise SmokeFailure(f"warm-up request to controllable model {m}: {status} {body}")
        decoder_loop.reset_launches()
        calls, replies = {}, {}
        for m in (0, 1):
            payloads = [payload(m, i) for i in range(16)]
            barrier = threading.Barrier(16)

            def one(p):
                barrier.wait()
                return _post(port, p)

            calls0, rows0 = srv.BATCH_CALLS
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(16) as ex:
                got = list(ex.map(one, payloads))
            wall = time.perf_counter() - t0
            bad = [(s, b) for s, b, _ in got if s != 200]
            if bad:
                raise SmokeFailure(f"controllable wave to model {m}: {bad[:2]}")
            calls[m], rows = srv.BATCH_CALLS[0] - calls0, srv.BATCH_CALLS[1] - rows0
            lat = np.array([sec for _, _, sec in got])
            waves[config["models"][m]["name"]] = {
                "requests": 16, "decode_launches": calls[m], "rows_per_launch": rows / calls[m],
                "p50_s": float(np.percentile(lat, 50)), "p95_s": float(np.percentile(lat, 95)),
                "wall_s": wall}
            print(f"  wave of 16 to {config['models'][m]['name']}: "
                  f"{waves[config['models'][m]['name']]} on {card}")
            if not rows / calls[m] > 1:
                raise SmokeFailure(f"the controllable wave to model {m} did not coalesce")
            replies[m] = (payloads, got)
        ctl = dict(decoder_loop.CONTROLS_LAUNCHES)
        want = {"lstm_cell": 256 * calls[0], "lstm_cell_int8": 256 * calls[1],
                "quantize_xh": 256 * calls[1], "heads": 256 * (calls[0] + calls[1])}
        print(f"  launches reading the controls in the waves: {ctl}")
        if ctl != want:
            raise SmokeFailure(f"controllable serve: launches reading the controls {ctl}, "
                               f"want {want}")
        for m in (0, 1):
            payloads, got = replies[m]
            for i in (0, 5, 11):  # voices 0, 1 and 3 (the sliders)
                status, solo, _ = _post(port, payloads[i])
                a = read_wav(str(root / got[i][1]["path"]))[0]
                b = read_wav(str(root / solo["path"]))[0]
                if status != 200 or len(a) != len(b):
                    raise SmokeFailure(f"controllable request {i} alone: {status}, {len(b)} "
                                       f"samples, batched {len(a)}")
                lsb = np.abs(np.round(a * 32768) - np.round(b * 32768))
                invariance.append({"model": m, "request": i, "samples": len(a),
                                   "max_lsb": float(lsb.max())})
        print(f"  controllable, batched vs alone, PCM16 LSB: {invariance}")
        if max(x["max_lsb"] for x in invariance) > 0:
            raise SmokeFailure(f"a controllable request's audio changed with its window: "
                               f"{invariance}")
    finally:
        if "httpd" in holder:
            holder["httpd"].shutdown()
        thread.join(60)
        os.chdir(cwd)
    log["serve_controls"] = {"waves": waves, "controls_launches": ctl,
                             "invariance": invariance, "card": card}
    return {"lstm_cell[controls]": ctl["lstm_cell"],
            "lstm_cell_int8[controls]": ctl["lstm_cell_int8"], "heads[controls]": ctl["heads"]}


def serve_split(registry) -> dict:
    """Where a window's time goes: the batched decode (encoder, 256 steps,
    postnet) of each entry and the batched vocode, at 16 and 64 rows of the
    waves' texts, each timed alone, eager, ending in a sync."""
    import torch

    from tacotron2_tpu_torch.run import server as srv
    from tacotron2_tpu_torch.run.say import cut_vocode, vocode_bucket
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    split = {}
    for idx in (0, 1):
        cfg, model, hifigan, packed, *_ = registry.load(idx)
        prep = cfg.dataset.preprocessing
        dev = next(model.parameters()).device
        for B in (16, 64):
            ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
                [normalize_text(TRAIN_TEXTS[i % len(TRAIN_TEXTS)], prep.allowed_chars,
                                prep.end_token, False) for i in range(B)])
            ci = torch.nn.functional.pad(torch.as_tensor(ci), (0, srv.CHAR_BUCKET - ci.shape[1]))
            ci, cl = ci.to(dev), torch.as_tensor(cl, device=dev)
            gens = [torch.Generator(device=dev).manual_seed(i) for i in range(B)]
            decode = lambda: model.forward_infer_fast(ci, cl, 256, packed=packed,
                                                      row_generators=gens, encode_rows=64)
            key = ("int8" if packed.quantized else "bf16") + f"_B{B}"
            split[f"decode_{key}"] = eager_ms(decode, 3)
            if idx == 0:
                mels = decode().mels_post
                Tb = vocode_bucket(hifigan, 255)
                split[f"vocode_B{B}"] = eager_ms(
                    lambda: cut_vocode(hifigan, mels, list(range(B)), [255] * B, Tb).cpu(), 3)
    print("  one window's parts, eager ms: " + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    return split


def serve_k2_check(hifigan, m, log: dict, tag: str) -> None:
    """K2 on ``hifigan``'s route (``HiFiGAN.apply``) from the window's mel
    ``m``, each call against its plain version on the same operand:
    ``conv_pre``, every upsample and every whole stage, and each mean's
    operand against ``operand`` of the f32 mean bit for bit. An F32
    generator (the served vocoder) runs K2's f32 mode, held to K2F_TOL of
    each output's max; a bf16 one K2's bf16 mode, to K2_TOL and
    ``conv_pre_check``."""
    import torch

    from tacotron2_tpu_torch.ops import mrf

    kw = hifigan.kernel_weights()
    dt = kw[0][1].w.dtype
    f32 = dt == torch.float32
    tol, own, sfx = (K2F_TOL, True, "_f32") if f32 else (K2_TOL, False, "")
    if f32:
        cwp = hifigan.conv_pre_weights()
        a = mrf.conv_pre(m.detach().contiguous(), cwp)
        check(f"conv_pre_f32@{tag}", [("a", a, mrf.conv_pre_plain(m.detach(), cwp))],
              tol, log, "conv_pre_f32", own=True)
    else:
        a = conv_pre_check(hifigan, m.detach(), log, tag)
    for i, (rbs, ups) in enumerate(kw):
        at = f"[{i}]@{tag}"
        check(f"conv_transpose{sfx}{at}", [("out", mrf.conv_transpose(a, ups)[0],
                                            mrf.conv_transpose_plain(a, ups)[0])],
              tol, log, "conv_transpose" + sfx, own)
        got = mrf.mrf_stage(None, rbs, ups, a)
        check(f"mrf_stage{sfx}{at}", [("out", got, mrf.side_output_stage(None, rbs, ups, a))],
              tol, log, stage_kernel(rbs), own)
        if i < len(kw) - 1:  # the next stage's input, as the served vocode passes it
            a = mrf.mrf_stage(None, rbs, ups, a, want_operand=True)
            if not torch.equal(a, mrf.operand(got, dt)):
                raise SmokeFailure(f"mrf_stage{sfx}{at}: the mean's operand differs from the "
                                   "operand of the f32 mean")
        del got


def serve_checks(registry, log: dict) -> dict:
    """The kernels at the windows' own shapes against their plain versions,
    on the served models' packs: a 4-step chunk (K1 for the bf16 entry at 16
    and 64 rows, K5 for the int8 entry at 16) over the waves' char lengths
    padded to the 128 bucket, so the kernels' later row groups are held too;
    then K2 at 16 and 64 rows of a decode of the waves' texts
    (``serve_k2_check``), on the served F32 vocoder (K2's f32 mode) and on a
    bf16 generator of the same weights (K2's bf16 mode). -> the PCM16
    difference of the served vocoder's batched ``cut_vocode`` from its plain
    reference route (reported)."""
    import torch

    from tacotron2_tpu_torch.models.hifigan import HiFiGAN
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.run import server as srv
    from tacotron2_tpu_torch.run.say import cut_vocode, vocode_bucket
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    pcm, h_bf = {}, None
    for idx, B in ((0, 16), (1, 16), (0, 64)):
        cfg, model, hifigan, packed, *_ = registry.load(idx)
        prep = cfg.dataset.preprocessing
        dev = next(model.parameters()).device
        ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
            [normalize_text(TRAIN_TEXTS[i % len(TRAIN_TEXTS)], prep.allowed_chars,
                            prep.end_token, False) for i in range(B)])
        L = max(srv.CHAR_BUCKET, -(-ci.shape[1] // srv.CHAR_BUCKET) * srv.CHAR_BUCKET)
        lengths = torch.as_tensor(cl, dtype=torch.int32, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 20 + B)
        key = ("int8" if packed.quantized else "bf16") + f"@B{B},L{L}"
        run = k5_check if packed.quantized else chunk_check
        run(f"serve_chunk[4,{key}]", packed, model, lengths, 4, g, log, L=L)
        if packed.quantized:
            continue

        ci = torch.nn.functional.pad(torch.as_tensor(ci), (0, L - ci.shape[1])).to(dev)
        gens = [torch.Generator(device=dev).manual_seed(100 + i) for i in range(B)]
        mels = model.forward_infer_fast(ci, torch.as_tensor(cl, device=dev), 256, packed=packed,
                                        row_generators=gens).mels_post
        rows, cuts = list(range(B)), [255] * B
        Tb = vocode_bucket(hifigan, 255)
        # cut_vocode's input: the rows cut at 255 frames in a bucket of Tb
        m = torch.nn.functional.pad(mels[:, :Tb], (0, 0, 0, max(0, Tb - mels.shape[1])))
        m = m * (torch.arange(Tb, device=dev) < 255)[None, :, None]
        if h_bf is None:  # K2's bf16 mode on the served generator's weights
            h_bf = HiFiGAN(hifigan.cfg, Policy(torch.bfloat16)).to(dev).eval()
            h_bf.load_state_dict(hifigan.state_dict())
        for gen in (hifigan, h_bf):  # the served F32 vocoder, then K2's bf16 mode
            serve_k2_check(gen, m, log, f"B{B}x{Tb}")
        del m
        lsb = (cut_vocode(hifigan, mels, rows, cuts, Tb).long()
               - cut_vocode(hifigan, mels, rows, cuts, Tb, plain=True).long()).abs().float()
        pcm[f"B{B}"] = {"Tb": Tb, "max_lsb": float(lsb.max()), "mean_lsb": float(lsb.mean()),
                        "share_over_2_lsb": float((lsb > 2).float().mean())}
    print(f"  batched vocode, kernels vs plain stages, PCM16 LSB: {pcm}")
    return pcm


def _serve_subprocess(cfg_file: Path, root: Path) -> dict:
    """``python -m tacotron2_tpu_torch server`` as a process: it must print
    its port, answer /config and one /generate, and exit 0 on SIGTERM."""
    import os
    import queue
    import re
    import signal
    import threading

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    (root / "sub").mkdir(exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tacotron2_tpu_torch", "server", "--config", str(cfg_file),
         "--port", "0", "--host", "127.0.0.1"], cwd=root / "sub", env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    out, t0 = [], time.perf_counter()
    try:
        port = None
        while port is None:
            line = lines.get(timeout=max(1.0, 180 - (time.perf_counter() - t0)))
            out.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        start_s = time.perf_counter() - t0
        registry = _get(port, "/config")
        status, body, sec = _post(port, {"text": TEXT, "model": 1, "seed": 2})
        if status != 200 or not (root / "sub" / body["path"]).exists():
            raise SmokeFailure(f"subprocess server /generate: {status} {body}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    except queue.Empty:
        raise SmokeFailure(f"the server process printed no port: {''.join(out)[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    time.sleep(0.1)
    while not lines.empty():
        out.append(lines.get())
    print(f"  server process: up in {start_s:.1f} s, /config {[r['name'] for r in registry]}, "
          f"/generate {sec:.2f} s, exit {rc}")
    if rc != 0 or [r["name"] for r in registry] != ["vanilla-bf16", "vanilla-int8"]:
        raise SmokeFailure(f"server process: exit {rc}, /config {registry}: {''.join(out)[-2000:]}")
    return {"start_s": start_s, "generate_s": sec, "exit": rc}


# ---------------------------------------------------------------------------
# phase 4f: from a raw corpus to test-set audio (``eval_phase``)

EVAL_LJ_CLIPS = 96
EVAL_LONG_EVERY = 8  # LJ clips i % 8 == 3 last 10.1 s, texts i % 8 == 5 are 170-187 chars
EVAL_HIFI_SPEAKERS = {"92": 210.0, "6097": 115.0, "9017": 130.0}  # speaker: f0 (Hz)
EVAL_HIFI_SETS = (("train", 16), ("dev", 2), ("test", 4))
EVAL_MAX_LEN = 512
# the gate bias of the test runs lies at least this far from every probed
# logit, so no rounding difference can move a row's stop: the probe's logits
# carry a bias of 10, whose f32 ulp is 9.5e-7
EVAL_GATE_MARGIN = 1e-5


def _speechlike(sr: int, f0: float, dur: float, seed: int):
    """Harmonics + noise + a ~3 Hz amplitude envelope (as
    tests/test_full_pipeline.py's speech-like clips)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * dur)) / sr
    sig = sum((1.0 / k) * np.sin(2 * np.pi * f0 * k * t) for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return (0.2 * env * sig + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def _eval_text(rng, n: int) -> str:
    """About ``n`` characters of English from TRAIN_TEXTS, ending in a period."""
    src = " ".join(TRAIN_TEXTS)
    start = int(rng.integers(0, len(src) - 200))
    while start > 0 and src[start - 1] != " ":
        start -= 1
    return src[start:start + n - 1].rstrip(" ,;") + "."


def _hifi_clip(job) -> None:
    """One Hi-Fi TTS clip as FLAC at 44.1 kHz (a worker of ``eval_corpora``)."""
    import numpy as np

    from tests.flac_encoder import encode_flac

    path, f0, dur, seed = job
    pcm = (_speechlike(44100, f0, dur, seed) * 32000).astype(np.int64)
    Path(path).write_bytes(encode_flac(pcm, sample_rate=44100, subframe_mode="fixed2"))


def eval_corpora(speech: Path) -> dict:
    """An LJSpeech layout (``metadata.csv``, ``wavs/``: EVAL_LJ_CLIPS clips of
    1.0-10.1 s, texts of 20-187 characters) and a Hi-Fi TTS one (speakers
    92, 6097 and 9017, 16 / 2 / 4 clips of 1.0-2.5 s each as FLAC at 44.1
    kHz, JSON-lines manifests) under ``speech``, from SEED. -> clips and
    seconds of audio."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from tacotron2_tpu_torch.audio.io import write_wav

    rng = np.random.default_rng(SEED + 12)
    lj = speech / "LJSpeech-1.1"
    (lj / "wavs").mkdir(parents=True)
    meta, audio_s = [], 0.0
    for i in range(EVAL_LJ_CLIPS):
        dur = 10.1 if i % EVAL_LONG_EVERY == 3 else float(rng.uniform(1.0, 6.0))
        n = int(rng.integers(170, 188)) if i % EVAL_LONG_EVERY == 5 else int(rng.integers(20, 150))
        text = _eval_text(rng, n)
        write_wav(str(lj / "wavs" / f"LJ{i:03d}.wav"),
                  _speechlike(22050, float(rng.uniform(90.0, 250.0)), dur, i), 22050)
        meta.append(f"LJ{i:03d}|{text}|{text}")
        audio_s += dur
    (lj / "metadata.csv").write_text("\n".join(meta) + "\n")

    hifi = speech / "hi_fi_tts_v0"
    jobs = []
    for spk, f0 in EVAL_HIFI_SPEAKERS.items():
        (hifi / "audio" / spk).mkdir(parents=True)
        for set_name, n in EVAL_HIFI_SETS:
            lines = []
            for j in range(n):
                rel = f"audio/{spk}/{spk}_{set_name}_{j}.flac"
                dur = float(rng.uniform(1.0, 2.5))
                jobs.append((str(hifi / rel), f0 * float(rng.uniform(0.9, 1.1)), dur,
                             int(spk) + 100 * j))
                lines.append(json.dumps({"audio_filepath": rel, "duration": dur,
                                         "text_normalized": _eval_text(rng,
                                                                       int(rng.integers(20, 120)))}))
                audio_s += dur
            (hifi / f"{spk}_manifest_clean_{set_name}.json").write_text("\n".join(lines) + "\n")
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(_hifi_clip, jobs))
    return {"clips": EVAL_LJ_CLIPS + len(jobs), "audio_s": audio_s}


def choose_gate_bias(g0, margin: float = EVAL_GATE_MARGIN) -> tuple:
    """Gate logits without their bias (rows, T) -> (a bias, the frame counts
    it gives: the first frame whose logit is negative, T where none is): of
    the midpoints between two logits at least ``margin`` apart (so a
    rounding difference cannot move a row's stop), one that leaves a row
    failing (firing at frame 0 or never) with the most rows stopping at
    distinct frames in between, and of those the one whose frames fire with
    a chance nearest 1 in 100. The eval tests choose their biases with it
    too."""
    import numpy as np

    from tacotron2_tpu_torch.run.test import gate_to_lengths

    v = np.unique(g0)
    best = None
    for bias in [-(a + b) / 2 for a, b in zip(v[:-1], v[1:]) if b - a >= margin]:
        n = gate_to_lengths((g0 + bias)[..., None])
        fails = int(np.isin(n, (0, g0.shape[1])).sum())
        score = (fails > 0, len(set(n.tolist()) - {0, g0.shape[1]}),
                 -abs(float((g0 + bias < 0).mean()) - 0.01))
        if best is None or score > best[0]:
            best = (score, float(bias), n)
    return best[1], best[2]


def eval_test(tag: str, cfg_file: Path, speech: Path, probe_ckpt: str, g_path: str,
              root: Path, log: dict) -> dict:
    """``test`` through the CLI on ``cfg_file``'s test split. A probe run on
    ``probe_ckpt`` (random full-width weights, gate bias 10: no row stops,
    every row a failure) gives every frame's gate logit; the gate does not
    feed back, so a checkpoint of the same weights with the bias of
    ``choose_gate_bias`` stops the rows at predicted frames. That run's
    counters are read: K1 5 launches a step (``tag`` "[controls]": the
    decoder cell and the heads reading the controls at each), K2 one vocode
    a batch with kept rows, one ``bilstm_forward`` a batch. Each WAV must
    have n x 256 samples equal, bit for bit, to its row alone through
    ``cut_vocode``; ``failures.csv`` must list exactly the rows stopping at
    frame 0 or never; the first batch's kernel decode is held against the
    plain decode over 32 frames (DECODE_TOL). -> {kernels-line row: launches}"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning
    from tacotron2_tpu_torch.data.loader import collate
    from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest
    from tacotron2_tpu_torch.ops import decoder_loop, encoder_lstm, mrf
    from tacotron2_tpu_torch.run import test as rt
    from tacotron2_tpu_torch.run.say import (cut_vocode, load_hifigan, load_tacotron,
                                             vocode_bucket)
    from tacotron2_tpu_torch.training.step import to_device

    cfg = load_config(str(cfg_file))
    dev = torch.device("cuda")
    base = ["test", "--config", str(cfg_file), "--speech-dir", str(speech),
            "--hifi-gan-checkpoint", g_path, "--max-len-override", str(EVAL_MAX_LEN)]
    gates, gate_to_lengths = [], rt.gate_to_lengths
    rt.gate_to_lengths = lambda g: (gates.append(g[..., 0]), gate_to_lengths(g))[1]
    try:
        probe = cli(base + ["--checkpoint", probe_ckpt, "--results-dir", str(root / "probe")])
    finally:
        rt.gate_to_lengths = gate_to_lengths
    rows = probe["rows"]
    if (probe["lengths"] != [EVAL_MAX_LEN] * rows or len(probe["failures"]) != rows
            or list((root / "probe").glob("*.wav"))):
        raise SmokeFailure(f"test{tag} probe (gate bias 10): {probe['lengths']}, "
                           f"{len(probe['failures'])} failures of {rows} rows")
    g0 = np.concatenate(gates) - 10.0
    bias, want = choose_gate_bias(g0)
    fire_share = float((g0 + bias < 0).mean())
    ckpt = str(WORK / f"tacotron2-test{tag}.ckpt")
    torch.save(to_lightning(random_tacotron(cfg, bias).state_dict()), ckpt)
    print(f"  test{tag}: {rows} rows; gate bias {bias:.6f}, {100 * fire_share:.2f}% of the "
          f"probed frames fire; each row's n: {want.tolist()}")

    calls, vocode = [], rt.cut_vocode
    rt.cut_vocode = lambda h, m, idx, cuts, Tb: (calls.append((m, list(idx), list(cuts))),
                                                 vocode(h, m, idx, cuts, Tb))[1]
    decoder_loop.reset_launches()
    mrf.reset_launches()
    encoder_lstm.reset_launches()
    out_dir = root / "test"
    try:
        res = cli(base + ["--checkpoint", ckpt, "--results-dir", str(out_dir)])
    finally:
        rt.cut_vocode = vocode
    k1, ctl, k2 = dict(decoder_loop.LAUNCHES), dict(decoder_loop.CONTROLS_LAUNCHES), \
        {**mrf.LAUNCHES, **mrf.F32_LAUNCHES}
    enc = encoder_lstm.LAUNCHES["bilstm_forward"]
    lengths, batches = res["lengths"], res["batches"]
    fails = [i for i, n in enumerate(lengths) if n in (0, EVAL_MAX_LEN)]
    stops = sorted({n for n in lengths if 0 < n < EVAL_MAX_LEN})
    print(f"  test{tag}: n {lengths}; stops {stops}; failures {fails}; batches "
          + ", ".join(f"{b['rows']}x{b['chars']} {b['decode_frames']} frames decode "
                      f"{b['decode_s'] * 1e3:.1f} ms vocode {b['vocode_s'] * 1e3:.1f} ms"
                      for b in batches))
    if lengths != want.tolist():
        raise SmokeFailure(f"test{tag}: rows stopped at {lengths}, the probe predicts "
                           f"{want.tolist()}")
    if len(stops) < 2 or not fails:
        raise SmokeFailure(f"test{tag}: stops {stops}, failures {fails}: want two or more "
                           "distinct stops in (0, max_len) and a failure")
    listed = [int(x.split("|")[0]) for x in (out_dir / "failures.csv").read_text().splitlines()]
    if listed != fails or [i for i, _ in res["failures"]] != fails:
        raise SmokeFailure(f"test{tag}: failures.csv lists {listed}, want {fails}")
    steps = sum(min(-(-b["decode_frames"] // 64) * 64, EVAL_MAX_LEN) for b in batches)
    want_k1 = {"prenet": steps, "lstm_cell": 2 * steps, "location_attention": steps,
               "heads": steps, "quantize_xh": 0, "lstm_cell_int8": 0}
    want_ctl = ({"lstm_cell": steps, "heads": steps, "quantize_xh": 0, "lstm_cell_int8": 0}
                if cfg.controls_dim else {k: 0 for k in ctl})
    print(f"  test{tag} launches: K1 {k1} (of them reading the controls {ctl}), K2 {k2}, "
          f"bilstm_forward {enc}; {steps} decode steps, {len(calls)} vocodes")
    if k1 != want_k1 or ctl != want_ctl:
        raise SmokeFailure(f"test{tag}: K1 launches {k1}, controls {ctl}; want {want_k1}, "
                           f"{want_ctl}")
    check_vocode_launches(k2, len(calls), f"test{tag}")
    if len(calls) != sum(1 for b in batches if b["vocoded"]) or enc != len(batches):
        raise SmokeFailure(f"test{tag}: {len(calls)} vocodes, {enc} bilstm_forward launches "
                           f"for {len(batches)} batches")

    hifigan = load_hifigan(g_path, dev)
    starts = np.cumsum([0] + [b["rows"] for b in batches])
    vocoded = [s for s, b in zip(starts, batches) if b["vocoded"]]
    for start, (mels, idx, cuts) in zip(vocoded, calls):
        for b, n in zip(idx, cuts):
            wav, _ = read_wav(str(out_dir / f"{start + b}.wav"))
            pcm = np.round(wav * 32768.0).astype(np.int16)
            alone = cut_vocode(hifigan, mels, [b], [n], vocode_bucket(hifigan, n))
            if len(pcm) != n * 256 or not np.array_equal(pcm, alone[0, :n * 256].cpu().numpy()):
                raise SmokeFailure(f"test{tag}: row {start + b}'s WAV ({len(pcm)} samples, n "
                                   f"{n}) is not its row vocoded alone")

    model = load_tacotron(cfg, probe_ckpt, dev)
    ds = manifest_dataset(cfg, read_manifest(cfg.dataset.test)[:batches[0]["rows"]], str(speech),
                          cache=False)
    b = to_device(collate([ds[i] for i in range(len(ds))], bucket_chars=32), dev)
    kw = {k: b[k] for k in ("speaker_id", "controls") if k in b}
    fast = model.forward_infer_fast(b["chars_idx"], b["chars_len"], 32, prenet_dropout=False, **kw)
    ref = model.forward_infer(b["chars_idx"], b["chars_len"], 32, prenet_dropout=False, **kw)
    if fast.n_frames != ref.n_frames or not torch.equal(fast.lengths, ref.lengths):
        raise SmokeFailure(f"test{tag}: kernel and plain decode disagree on frames")
    check(f"decode_32_frames[test{tag}]", [("mels_post", fast.mels_post, ref.mels_post),
                                          ("gates", fast.gates, ref.gates),
                                          ("alignments", fast.alignments, ref.alignments)],
          DECODE_TOL, log)
    log[f"eval_test{tag}"] = {"bias": bias, "fire_share": fire_share, "lengths": lengths,
                              "failures": fails, "batches": batches, "k1": k1, "controls": ctl,
                              "k2": k2, "bilstm_forward": enc}
    out = {**k1, **k2, "bilstm_forward": enc}
    if cfg.controls_dim:
        out = {"lstm_cell[controls]": ctl["lstm_cell"], "heads[controls]": ctl["heads"], **out}
    return out


def eval_export(tag: str, cfg_file: Path, speech: Path, ckpt: str, root: Path, log: dict,
                card: str) -> dict:
    """``train_mel_export`` through the CLI on ``cfg_file``'s train and val
    splits, with K3 / K4's and the encoder's counters read around it: K3
    ``forward_launches(T)`` a batch (with ``tag`` "[controls]" every one of
    the controls mode), no K4, one ``bilstm_forward`` and no
    ``bilstm_backward`` a batch. Each row must have one .npy of (its mel
    frames, 80); the first batch, rebuilt here, gives the same mels bit for
    bit through ``forward_teacher``, whose K3 call is held against the plain
    version on the same inputs (K3_TOL_TRAIN) and timed beside its bound; a
    second export writes the same bytes. -> (launches, the K3 reading)"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import load_audio
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.data.loader import collate
    from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest
    from tacotron2_tpu_torch.ops import encoder_lstm
    from tacotron2_tpu_torch.ops import train_decode as td
    from tacotron2_tpu_torch.run.say import load_tacotron
    from tacotron2_tpu_torch.training.step import to_device

    cfg = load_config(str(cfg_file))
    dev = torch.device("cuda")
    base = ["train_mel_export", "--config", str(cfg_file), "--speech-dir", str(speech),
            "--checkpoint", ckpt]
    td.reset_launches()
    encoder_lstm.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases: not the export's
    t0 = time.perf_counter()
    res = cli(base + ["--results-dir", str(root / "mels")])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    k34, ctl, enc = dict(td.LAUNCHES), dict(td.CONTROLS_LAUNCHES), dict(encoder_lstm.LAUNCHES)
    batches = res["train"]["batches"] + res["val"]["batches"]
    want = {"teacher_forward": sum(td.forward_launches(b["frames"]) for b in batches),
            "teacher_backward": 0}
    frames = sum(b["mel_frames"] for b in batches)
    secs = sum(b["s"] for b in batches)
    print(f"  train_mel_export{tag}: batches (rows x chars x frames, ms) "
          + ", ".join(f"{b['rows']}x{b['chars']}x{b['frames']} {b['s'] * 1e3:.1f}"
                      for b in batches)
          + f"; {frames / secs:.0f} exported mel frames/s, {wall:.2f} s in all, peak "
          f"{peak / 2**30:.2f} GiB over the {held / 2**30:.2f} GiB held before, on {card}; "
          f"launches {k34} (controls {ctl}), encoder {enc}")
    if k34 != want or enc != {"bilstm_forward": len(batches), "bilstm_backward": 0}:
        raise SmokeFailure(f"train_mel_export{tag}: launches {k34}, encoder {enc}; want {want}, "
                           f"one bilstm_forward a batch ({len(batches)})")
    mode = "[controls]" if cfg.controls_dim else ""
    if mode and ctl != want:
        raise SmokeFailure(f"train_mel_export{tag}: K3 launches of the controls mode {ctl}, "
                           f"want {want}")
    first = batches[0]
    if not tag and (first["rows"], first["chars"], first["frames"]) != (64, 192, 896):
        raise SmokeFailure(f"train_mel_export: the first batch is {first}, want 64 rows of "
                           "192 chars and 896 frames (the longest clip and text)")

    rows = {s: read_manifest(getattr(cfg.dataset, s)) for s in ("train", "val")}
    silence = cfg.dataset.preprocessing.silence
    for r in rows["train"] + rows["val"]:
        name = root / "mels" / Path(r["wav"]).name.replace(".wav", ".npy")
        n = 1 + (len(load_audio(str(speech / r["wav"]))[0]) + silence) // 256
        if np.load(name).shape != (n, 80):
            raise SmokeFailure(f"train_mel_export{tag}: {name.name} is "
                               f"{np.load(name).shape}, want ({n}, 80)")

    ds = manifest_dataset(cfg, rows["train"][:first["rows"]], str(speech), cache=False)
    b = to_device(collate([ds[i] for i in range(len(ds))], 32, 128), dev)
    model = load_tacotron(cfg, ckpt, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    calls, forward = [], td.teacher_forward
    td.teacher_forward = lambda *a: (calls.append(a), forward(*a))[1]
    try:
        with torch.no_grad():
            out = model.forward_teacher(b["chars_idx"], b["chars_len"], b["mel"], b["mel_len"],
                                        train=False, generator=gen,
                                        speaker_id=b.get("speaker_id"),
                                        controls=b.get("controls"))
    finally:
        td.teacher_forward = forward
    for i, r in enumerate(rows["train"][:first["rows"]]):
        got = out.mels_post[i, :int(b["mel_len"][i])].cpu().numpy()
        if not np.array_equal(got, np.load(root / "mels" / Path(r["wav"]).name.replace(".wav",
                                                                                     ".npy"))):
            raise SmokeFailure(f"train_mel_export{tag}: row {i}'s .npy is not the first "
                               "batch's forward_teacher mels")
    fwd_args = calls[0]
    w, din, enc_b = fwd_args[0], fwd_args[1], fwd_args[2]
    T, B, L = din.shape[0], din.shape[1], enc_b.shape[1]
    mg_k, res_k = td.teacher_forward(*fwd_args)
    mg_p, res_p = td.teacher_forward_plain(*fwd_args)
    check(f"teacher_forward@export{tag},B{B},L{L},T{T}",
          [("mel_gate", mg_k, mg_p)]
          + [(f, getattr(res_k, f), getattr(res_p, f)) for f in td.Residuals._fields],
          K3_TOL_TRAIN, log, f"teacher_forward{mode}")
    b_ms, b_by, stream, _ = teacher_bounds(T, B, L, enc_b.shape[2], model.cfg.controls_dim, w,
                                           res_k, mg_k)["teacher_forward"]
    k3 = {"B": B, "L": L, "T": T, "ms": time_ms(lambda: td.teacher_forward(*fwd_args), 3, 1),
          "plain_ms": time_ms(lambda: td.teacher_forward_plain(*fwd_args), 2, 1),
          "bound_ms": b_ms, "bound_by": b_by, "weight_stream_ms": stream,
          "launches": want["teacher_forward"], "card": card}
    print(f"  K3{mode} at the export's first batch (B={B}, L={L}, T={T}): {k3['ms']:.3f} ms, "
          f"plain {k3['plain_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by}), weight stream "
          f"{stream:.3f} ms on {card}")
    del out, mg_k, res_k, mg_p, res_p, calls, fwd_args

    again = cli(base + ["--results-dir", str(root / "mels_again")])
    files = res["train"]["files"] + res["val"]["files"]
    if again["train"]["files"] + again["val"]["files"] != [
            f.replace(str(root / "mels"), str(root / "mels_again")) for f in files] or any(
            Path(f).read_bytes() != Path(g).read_bytes()
            for f, g in zip(files, again["train"]["files"] + again["val"]["files"])):
        raise SmokeFailure(f"train_mel_export{tag}: a second export with the same seeds wrote "
                           "other files")
    log[f"eval_export{tag}"] = {"batches": batches, "mel_frames_per_s": frames / secs,
                                "wall_s": wall, "peak_bytes": peak, "held_bytes": held,
                                "k3": k3,
                                "launches": k34, "controls_launches": ctl, "encoder": enc,
                                "files": len(files)}
    out = {f"teacher_forward{mode}": k34["teacher_forward"], "bilstm_forward": enc["bilstm_forward"]}
    return out, k3


def eval_phase(cfg_path: str, ctl_cfg_path: str, ckpt: str, ctl_ckpt: str, g_path: str,
               log: dict, card: str) -> tuple:
    """Phase 4f: synthetic LJSpeech and Hi-Fi TTS corpora (``eval_corpora``)
    -> ``preprocess`` of each (8 worker processes) -> the three splits
    commands, down to the manifests the controllable config reads -> ``test``
    (``eval_test``) of the vanilla config on the LJ test split and of the
    controllable config on the lj-hifi one -> ``train_mel_export``
    (``eval_export``) of both -> ``say --export-mel``: the .npy is the mel
    that was vocoded. -> ({kernels-line row: launches}, K3's reading at the
    vanilla export's first batch)"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.prosody import FEATURE_NAMES
    from tacotron2_tpu_torch.preprocessing import splits
    from tacotron2_tpu_torch.preprocessing.table import column, read_table
    from tacotron2_tpu_torch.run import say as rs

    t_phase = time.perf_counter()
    root = WORK / "eval"
    speech, data = root / "speech", root / "data"
    data.mkdir(parents=True)
    t0 = time.perf_counter()
    corpus = eval_corpora(speech)
    t_corpus = time.perf_counter() - t0

    t0 = time.perf_counter()
    for dataset, sub in (("ljspeech", "LJSpeech-1.1"), ("hifi-tts", "hi_fi_tts_v0")):
        cli(["preprocess", "--dataset", dataset, "--speech-dir", str(speech / sub),
             "--out-dir", str(data), "--out-postfix", "smoke", "--n-jobs", "8"])
    t_pre = time.perf_counter() - t0
    d = {name: str(data / f"{name}.csv") for name in (
        "lj-train", "lj-val", "lj-test", "hifi-train", "hifi-val", "hifi-test",
        "lj-hifi-train", "lj-hifi-val", "lj-hifi-test")}
    t0 = time.perf_counter()
    splits.main(["ljspeech", "--csv-in", str(data / "ljspeech-smoke.csv"), "--train-out",
                 d["lj-train"], "--val-out", d["lj-val"], "--test-out", d["lj-test"],
                 "--val-size", "4", "--test-size", "8"])
    splits.main(["hifi", *(x for s in ("train", "val", "test")
                           for x in (f"--{s}-in", str(data / f"hifi-tts-{s}-smoke.csv"))),
                 "--train-out", d["hifi-train"], "--val-out", d["hifi-val"], "--test-out",
                 d["hifi-test"], "--speaker-val-size", "4", "--speaker-test-size", "8"])
    splits.main(["lj-hifi", *(x for s in ("train", "val", "test") for x in (
                     f"--hifi-{s}-in", d[f"hifi-{s}"], f"--lj-{s}-in", d[f"lj-{s}"],
                     f"--{s}-out", d[f"lj-hifi-{s}"]))])
    t_splits = time.perf_counter() - t0
    ctl_raw = json.loads(Path(ctl_cfg_path).read_text())
    feats = ctl_raw["extensions"]["controls"]["features"]
    counts = {}
    for name, want in (("ljspeech-smoke", 96), ("hifi-tts-train-smoke", 48),
                       ("hifi-tts-val-smoke", 6), ("hifi-tts-test-smoke", 12), ("lj-train", 84),
                       ("lj-val", 4), ("lj-test", 8), ("hifi-train", 30), ("hifi-val", 12),
                       ("hifi-test", 24), ("lj-hifi-train", 114), ("lj-hifi-val", 16),
                       ("lj-hifi-test", 32)):
        header, rows = read_table(str(data / f"{name}.csv"))
        counts[name] = len(rows)
        need = [*FEATURE_NAMES, "text", "wav"] + (feats + ["speaker_id"] if "hifi" in name
                                                  and "tts" not in name else [])
        if len(rows) != want or not set(need) <= set(header):
            raise SmokeFailure(f"{name}.csv: {len(rows)} rows, want {want}; columns "
                               f"{sorted(set(need) - set(header))} missing")
        if name.startswith("lj-hifi"):
            if {int(r["speaker_id"]) for r in rows} != set(range(4)) or not all(
                    np.isfinite(column(rows, f)).all() for f in feats):
                raise SmokeFailure(f"{name}.csv: speakers or control columns not as the "
                                   f"controllable config reads them")
    print(f"  corpora: {corpus['clips']} clips, {corpus['audio_s']:.1f} s of audio, made in "
          f"{t_corpus:.2f} s; preprocess {t_pre:.2f} s ({1e3 * t_pre / corpus['clips']:.2f} ms "
          f"a clip on the host, 8 workers); splits {t_splits:.2f} s; rows {counts}")

    configs = {}
    for tag, src, split in (("", cfg_path, "lj"), ("[controls]", ctl_cfg_path, "lj-hifi")):
        raw = json.loads(Path(src).read_text())
        raw["dataset"].update({s: d[f"{split}-{s}"] for s in ("train", "val", "test")})
        configs[tag] = data / f"config{'-controls' if tag else ''}.json"
        configs[tag].write_text(json.dumps(raw))
    sp = {"": speech / "LJSpeech-1.1", "[controls]": speech}
    launches: dict = {}

    def add(got: dict) -> None:
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    t0 = time.perf_counter()
    for tag, probe_ckpt in (("", ckpt), ("[controls]", ctl_ckpt)):
        add(eval_test(tag, configs[tag], sp[tag], probe_ckpt, g_path,
                      root / f"test{'-controls' if tag else ''}", log))
    t_test = time.perf_counter() - t0
    t0 = time.perf_counter()
    k3 = {}
    for tag, c in (("", ckpt), ("[controls]", ctl_ckpt)):
        got, k3[tag] = eval_export(tag, configs[tag], sp[tag], c,
                                   root / f"export{'-controls' if tag else ''}", log, card)
        add(got)
    t_export = time.perf_counter() - t0

    calls, vocode = [], rs.cut_vocode
    rs.cut_vocode = lambda h, m, idx, cuts, Tb: (calls.append((m, list(cuts))),
                                                 vocode(h, m, idx, cuts, Tb))[1]
    out = str(root / "say.wav")
    try:
        said = cli(["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint",
                    g_path, "--text", TEXT, "--out", out, "--random-seed", str(SEED),
                    "--max-len-override", "64", "--export-mel"])
    finally:
        rs.cut_vocode = vocode
    mel, cut = np.load(out + ".npy"), said["cut"]
    if mel.shape != (80, cut) or len(calls) != 1 or calls[0][1] != [cut] or not np.array_equal(
            mel, calls[0][0][0, :cut].T.cpu().numpy()):
        raise SmokeFailure(f"say --export-mel: {mel.shape} for cut {cut}, not the vocoded mel")
    print(f"  say --export-mel: {Path(out).name}.npy {mel.shape}, the mel that was vocoded")
    seconds = time.perf_counter() - t_phase
    print(f"  phase 4f: {seconds:.1f} s (corpora {t_corpus:.1f}, preprocess {t_pre:.1f}, "
          f"splits {t_splits:.1f}, test {t_test:.1f}, train_mel_export {t_export:.1f}) on {card}")
    log["eval"] = {"corpus": corpus, "rows": counts, "seconds": seconds, "corpus_s": t_corpus,
                   "preprocess_s": t_pre, "preprocess_ms_per_clip": 1e3 * t_pre / corpus["clips"],
                   "splits_s": t_splits, "test_s": t_test, "export_s": t_export,
                   "say_export_mel": {"shape": list(mel.shape), "cut": cut}, "card": card}
    torch.cuda.empty_cache()
    return launches, k3[""], {"cfg": str(configs["[controls]"]), "speech": speech}


def eval_mode() -> int:
    """``--eval``: the kernels' build and phase 4f alone, on the checkpoints
    phases 4 and 4d write (random full-width weights, gate bias 10);
    details to ``chiprun_out/eval.json``."""
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning
    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build

    card = card_line()
    print(f"[4f] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    build.build_all()
    log: dict = {"card": card}
    try:
        WORK.mkdir(parents=True, exist_ok=True)
        paths = [str(ROOT / "config" / "vanilla-ljspeech-stop.json"),
                 str(ROOT / "config" / CTL_CONFIG)]
        ckpts = []
        for p in paths:
            ckpts.append(str(WORK / f"tacotron2-{Path(p).stem}.ckpt"))
            torch.save(to_lightning(random_tacotron(load_config(p), 10.0).state_dict()),
                       ckpts[-1])
        launches, k3, _ = eval_phase(*paths, *ckpts, write_hifigan(), log, card)
        log.update({"launches": launches, "k3_export": k3})
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "eval.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"launches": launches, "k3_export": k3}))
    return 0


# ---------------------------------------------------------------------------
# phase 4g: finetuning, the background save, TensorBoard, the trace, and the
# prosody-model configs (train_prosody and the style-loss phase)

EVENT_SCALARS = ("training_gate_loss", "training_mel_loss", "training_mel_post_loss",
                 "training_tacotron_loss", "training_loss", "training_grad_norm", "lr",
                 "mel_frames_per_sec", "val_loss", "val_mel_loss")
EVENT_IMAGES = ("val_mel_spectrogram", "val_mel_spectrogram_predicted", "val_alignment",
                "val_gate")
# the kernel functions each counted wrapper launches (csrc/train_decode.cu,
# csrc/encoder_lstm.cu); the finetune's trace must name every one
TRACE_KERNELS = {
    "teacher_forward": ("stage_kernel", "gate_tma_kernel", "att_fwd_cluster_kernel",
                        "gemm_tn_kernel"),
    "teacher_backward": ("gemm_tn_kernel", "heads_pull_kernel", "lstm_mid_kernel",
                         "dx_cluster_kernel", "att_bwd_cluster_kernel"),
    "bilstm_forward": ("bilstm_fwd_kernel",),
    "bilstm_backward": ("bilstm_bwd_kernel",),
}
FT_STEPS = 2  # --finetune-steps and --max-steps of the checked finetunes: 4 steps
FT_SAVE_EVERY = 2  # the driver's SAVE_EVERY and HISTOGRAM_EVERY in the checked runs
FT_HIST_EVERY = 2
FT_TIMING_REPEAT = 4  # the timing run's manifest: 4b's rows 4 times, 4 steps an epoch
FT_TIMING_MAX_STEPS = 6  # + FT_STEPS: 8 steps, validations after 4 and 8, a save after 6
FT_TIMING_SAVE_EVERY = 6
ENC128_ROWS = (0, 1, 37, 127)  # rows of the 128-row encoder launches held alone
PROSODY_STEPS = 4
PROSODY_B = 32
STYLE_CONFIG = "controllable-lj-hifi-stop-speaker-prosody-model.json"
STYLE_STEPS = 4


def _crc32c(data: bytes) -> int:
    """CRC-32C, bit by bit per byte: the smoke's own, apart from the port's."""
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 & -(c & 1))
    return c ^ 0xFFFFFFFF


def _pb_fields(buf: bytes) -> dict:
    """A protobuf message -> {field: [values]} (varints as ints, the rest as bytes)."""
    import struct

    out: dict = {}
    pos = 0

    def varint():
        nonlocal pos
        n = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n

    while pos < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = varint()
        elif wire == 1:
            v, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n = varint()
            v, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            v, pos = buf[pos:pos + 4], pos + 4
        else:
            raise SmokeFailure(f"event file: wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def read_events(path: Path) -> list:
    """An event file, every TFRecord's masked CRC-32C checked -> [(step,
    kind, tag, value)]: scalars' values, images' (height, width, PNG
    signature present), histograms' bucket count."""
    import struct

    mask = lambda c: (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    data, pos, out = path.read_bytes(), 0, []
    while pos < len(data):
        head = data[pos:pos + 8]
        n = struct.unpack("<Q", head)[0]
        rec = data[pos + 12:pos + 12 + n]
        if (struct.unpack("<I", data[pos + 8:pos + 12])[0] != mask(_crc32c(head))
                or struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] != mask(_crc32c(rec))):
            raise SmokeFailure(f"{path.name}: a record's CRC does not match at byte {pos}")
        pos += 16 + n
        ev = _pb_fields(rec)
        step = ev.get(2, [0])[0]
        for summary in ev.get(5, []):
            for value in _pb_fields(summary).get(1, []):
                v = _pb_fields(value)
                tag = v[1][0].decode()
                if 2 in v:
                    out.append((step, "scalar", tag, struct.unpack("<f", v[2][0])[0]))
                elif 4 in v:
                    img = _pb_fields(v[4][0])
                    out.append((step, "image", tag, (img[1][0], img[2][0],
                                                     img[4][0][:8] == b"\x89PNG\r\n\x1a\n")))
                elif 5 in v:
                    out.append((step, "histogram", tag, len(_pb_fields(v[5][0]).get(7, [b""])[0])
                                // 8))
    return out


def trace_kernel_names(path: Path) -> list:
    """The names of the CUDA kernels in a Chrome trace, one per launch."""
    trace = json.loads(path.read_text())["traceEvents"]
    return [e.get("name", "") for e in trace if e.get("cat") == "kernel"]


def _params(path: str) -> dict:
    """A checkpoint's parameters (not BatchNorm's statistics), on the host."""
    from tacotron2_tpu_torch.convert import load_tacotron2_checkpoint

    return {k: v for k, v in load_tacotron2_checkpoint(path)[0].items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def _want_k34(out: dict) -> dict:
    """The K3 / K4 launches a ``train`` run's record needs: ``2 + 3T`` for
    each train and validation batch, ``4 + 4T`` for each train step."""
    from tacotron2_tpu_torch.ops import train_decode as td

    fwd_T = [s["decode_frames"] for s in out["steps"]] + out["val_decode_frames"]
    return {"teacher_forward": sum(td.forward_launches(T) for T in fwd_T),
            "teacher_backward": sum(td.backward_launches(s["decode_frames"])
                                    for s in out["steps"])}


def _metrics_rows(results: Path) -> list:
    (path,) = (results / "lightning_logs").glob("*/metrics.jsonl")
    return [json.loads(x) for x in path.read_text().splitlines()]


def _ckpt_equal(a: str, b: str) -> bool:
    """Two Lightning checkpoints with equal tensors (weights, BatchNorm
    statistics, Adam's state), step, schedule and hyperparameters."""
    import torch

    x, y = (torch.load(p, map_location="cpu", weights_only=False) for p in (a, b))

    def same(u, v):
        if isinstance(u, torch.Tensor):
            return isinstance(v, torch.Tensor) and u.dtype == v.dtype and torch.equal(u, v)
        if isinstance(u, dict):
            return isinstance(v, dict) and set(u) == set(v) and all(same(u[k], v[k]) for k in u)
        if isinstance(u, (list, tuple)):
            return len(u) == len(v) and all(same(p, q) for p, q in zip(u, v))
        return u == v

    return same(x, y)


def finetune_run(tag: str, src: dict, results: Path, frozen: tuple, controls: bool,
                 extra: tuple = (), cfg: str = None) -> tuple:
    """``train --finetune --finetune-steps FT_STEPS --max-steps FT_STEPS``
    (or ``extra``) through the CLI entry from ``src``'s checkpoint, the
    launch counters set to 0 before and read after. Holds: every step at
    twice the config's batch, finite losses, ``finetuned.ckpt``, lr / 10 logged at step
    1, the ``frozen`` parameters equal to the resumed ones bit for bit and
    every other one moved, K3 / K4 at launches per step x T over every
    decode (all of the controls mode with ``controls``), ``bilstm_backward``
    once a step. -> (the run's record, K3/K4 launches, encoder launches)"""
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.ops import encoder_lstm as el
    from tacotron2_tpu_torch.ops import train_decode as td

    td.reset_launches()
    el.reset_launches()
    out = cli(["train", "--config", str(cfg or src["cfg"]), "--speech-dir", str(src["speech"]),
               "--seed", str(SEED), "--results-dir", str(results), "--resume-ckpt", src["ckpt"],
               "--finetune", "--finetune-steps", str(FT_STEPS)]
              + list(extra or ("--max-steps", str(FT_STEPS))))
    k34 = dict(td.CONTROLS_LAUNCHES if controls else td.LAUNCHES)
    enc = dict(el.LAUNCHES)
    steps = out["steps"]
    raw = json.loads(Path(cfg or src["cfg"]).read_text())
    rows = 2 * raw["training"]["batch_size"]
    if Path(out["checkpoint"]).name != "finetuned.ckpt":
        raise SmokeFailure(f"finetune{tag} saved {out['checkpoint']}, not finetuned.ckpt")
    if {s["rows"] for s in steps} != {rows} or not all(math.isfinite(s["loss"]) for s in steps):
        raise SmokeFailure(f"finetune{tag}: rows {[s['rows'] for s in steps]} (want {rows}), "
                           f"losses {[s['loss'] for s in steps]}")
    want = _want_k34(out)
    if k34 != want or (controls and dict(td.LAUNCHES) != want):
        raise SmokeFailure(f"finetune{tag}: K3/K4 launches {k34}, want {want}")
    if enc["bilstm_backward"] != len(steps) or enc["bilstm_forward"] == 0:
        raise SmokeFailure(f"finetune{tag}: encoder launches {enc} in {len(steps)} steps")
    lr1 = [r["lr"] for r in _metrics_rows(results) if r["step"] == 1 and "lr" in r]
    if lr1 != [raw["training"]["lr"] / 10]:
        raise SmokeFailure(f"finetune{tag}: lr {lr1} logged at step 1, want "
                           f"{raw['training']['lr'] / 10}")
    before, after = _params(src["ckpt"]), _params(out["checkpoint"])
    held = sorted(k for k in before if k.startswith(frozen))
    moved = [k for k in before if not k.startswith(frozen)]
    stayed = sorted(k for k in before if torch.equal(before[k], after[k]))
    if not held or stayed != held:
        raise SmokeFailure(f"finetune{tag}: frozen {held}, unchanged {stayed}")
    print(f"  finetune{tag}: {len(steps)} steps at B={rows}, lr {lr1[0]:g}, {len(held)} frozen "
          f"tensors ({', '.join(frozen)}) bit for bit, {len(moved)} others moved; K3/K4 "
          f"{k34}, encoder {enc}")
    return out, k34, enc


def step_sets(out: dict, val_every: int, save_every: int) -> dict:
    """The run's steps by what came before them: ``after_validation`` (the
    two after each validation pass), ``after_save`` (the one after a
    background save), ``steady`` (the rest but the first) -> {set: {ms
    median, ms, wait_ms, steps}}"""
    import numpy as np

    steps = out["steps"]
    n = len(steps)
    after_val = {v + k for v in range(val_every, n, val_every) for k in (1, 2)}
    after_save = {s + 1 for s in range(save_every, n, save_every)} - after_val
    sets = {"after_validation": after_val, "after_save": after_save,
            "steady": set(range(2, n + 1)) - after_val - after_save}
    res = {}
    for name, chosen in sets.items():
        sel = [s for s in steps if s["step"] in chosen]
        ms = [1e3 * s["s"] for s in sel]
        res[name] = {"steps": sorted(chosen), "ms": ms, "wait_ms": [1e3 * s["wait_s"] for s in sel],
                     "ms_median": float(np.median(ms)) if ms else None,
                     "mel_frames_per_s": (sum(s["mel_frames"] for s in sel)
                                          / sum(s["s"] for s in sel)) if sel else None}
    return res


def enc_rows_alone(model, B: int, log: dict) -> dict:
    """The encoder's forward and backward recurrence at B rows (the
    controllable finetune's 128: 16 eight-row tiles, 32 clusters in all),
    T=128: against their plain versions (ENC_TOL), rows ENC128_ROWS (those
    under B) of each launch bit for bit against the rows alone, timed
    beside bound, plain version and ``nn.LSTM``; how many of the backward's
    clusters the card runs at once. -> {kernel: readings}"""
    import torch

    from tacotron2_tpu_torch.ops import encoder_lstm as el

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 64)
    lstm = model.encoder.lstm
    H, C = lstm.hidden_size, lstm.input_size
    T = 128
    wb = torch.stack([lstm.weight_hh_l0, lstm.weight_hh_l0_reverse]).detach().to(
        torch.bfloat16).contiguous()
    b = torch.stack([lstm.bias_hh_l0, lstm.bias_hh_l0_reverse]).detach().contiguous()
    xp = torch.randn(2, B, T, 4 * H, device=dev, generator=g)
    hs, cs, act = el.bilstm_forward(xp, wb, b)
    check(f"bilstm_forward@B{B},T{T}", list(zip(("hs", "cs", "act"), (hs, cs, act),
                                                el.bilstm_forward_plain(xp, wb, b))),
          ENC_TOL, log, "bilstm_forward")
    dhs = torch.randn(2, B, T, H, device=dev, generator=g) * 1e-2
    dg = el.bilstm_backward(dhs, act, cs, wb)
    check(f"bilstm_backward@B{B},T{T}", [("dg", dg, el.bilstm_backward_plain(dhs, act, cs, wb))],
          ENC_TOL, log, "bilstm_backward", own=True)
    sl = lambda t, row: t[:, row:row + 1].contiguous()
    rows = [r for r in ENC128_ROWS if r < B]
    for row in rows:
        alone = el.bilstm_forward(sl(xp, row), wb, b)
        same = all(torch.equal(sl(f, row), a) for f, a in zip((hs, cs, act), alone)) and \
            torch.equal(sl(dg, row), el.bilstm_backward(sl(dhs, row), sl(act, row),
                                                        sl(cs, row), wb))
        log.setdefault("enc_invariance", {})[f"row {row} of {B}, T={T}"] = same
        if not same:
            raise SmokeFailure(f"the encoder's recurrence: row {row} alone differs from the "
                               f"same row of a {B}-row launch")
    clusters = bwd_max_clusters(el._lib(), H)
    needed = 2 * -(-B // el.ENC_TILE)
    x = torch.randn(B, T, C, device=dev, generator=g)
    out = {"max_clusters": clusters, "clusters": needed}
    for name, kern, plain, lib, flops, args in (
            ("bilstm_forward", el.bilstm_forward, el.bilstm_forward_plain, lambda: lstm(x),
             2 * 2 * B * T * 4 * H * H, (xp, wb, b)),
            ("bilstm_backward", el.bilstm_backward, el.bilstm_backward_plain,
             lstm_backward(lstm, x, torch.float32), 2 * 2 * B * T * 4 * H * H,
             (dhs, act, cs, wb))):
        res = kern(*args)
        b_ms, b_by = bound_ms(nbytes(*args, *(res if isinstance(res, tuple) else (res,))), flops)
        out[name] = {"B": B, "T": T, "ms": time_ms(lambda: kern(*args), 3, 1),
                     "plain_ms": time_ms(lambda: plain(*args), 2, 1, 1), "bound_ms": b_ms,
                     "bound_by": b_by,
                     "library_ms": (time_ms(lib, 3, 1) if name == "bilstm_forward"
                                    else eager_ms(lib, 5))}
        r = out[name]
        print(f"  {name} at B={B}, T={T}: {r['ms']:.4f} ms (bound {b_ms:.4f} ms, plain "
              f"{r['plain_ms']:.3f}, nn.LSTM f32 {r['library_ms']:.4f})")
    print(f"  the encoder at {B} rows: {needed} clusters of the backward, {clusters} resident at "
          f"once; rows {rows} of both launches equal the rows alone, bit for bit")
    log["enc_finetune_rows"] = out
    return out


def step_timer(res: dict, tag: str, card: str):
    """-> lap(name): the seconds since the last lap (or this call) into
    ``res["seconds_by_step"][name]``, printed: where a phase's time goes."""
    steps = res.setdefault("seconds_by_step", {})
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        steps[name] = now - last[0]
        last[0] = now
        print(f"  [{tag}] {name}: {steps[name]:.1f} s on {card}")
    return lap


def train_extras_phase(van: dict, ctl: dict, lj_hifi: dict, g_path: str, log: dict,
                       card: str) -> tuple:
    """Phase 4g on the runs of 4b (``van``), 4e (``ctl``) and 4f's lj-hifi
    manifests (``lj_hifi``): the vanilla finetune under the trace with the
    driver's save and histogram intervals small (``finetune_run``, then
    ``last.ckpt`` against ``finetuned.ckpt``, the event file, the trace);
    an untraced vanilla finetune of 8 steps for the step times after a
    validation and after a save; the controllable finetune at B=128 (K3 / K4
    and the encoder at its shapes); ``train_prosody``; the style-loss phase
    of ``STYLE_CONFIG`` and a ``say`` of its checkpoint. -> ({kernels-line
    row: launches}, {kernels-line row: its reading at 4g's shapes})"""
    import os

    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron2_tpu_torch.ops import train_decode as td
    from tacotron2_tpu_torch.run import train as rt
    from tacotron2_tpu_torch.run.say import model_config_from
    from tacotron2_tpu_torch.training import checkpoint as ckpt_lib
    from tacotron2_tpu_torch.training.checkpoint import load_model_state
    from tacotron2_tpu_torch.training.losses import prosody_style_loss
    from tacotron2_tpu_torch.utils.profiling import trace_path

    t_phase = time.perf_counter()
    root = WORK / "train_extras"
    root.mkdir(parents=True, exist_ok=True)
    launches: dict = {}
    readings: dict = {}
    res: dict = {"card": card}
    lap = step_timer(res, "4g", card)

    def add(got: dict, suffix: str = "") -> None:
        for k, n in got.items():
            launches[k + suffix] = launches.get(k + suffix, 0) + n

    # the vanilla finetune, traced, saving and writing histograms every 2 steps
    trace_dir = root / "trace"
    saved = rt.SAVE_EVERY, rt.HISTOGRAM_EVERY
    rt.SAVE_EVERY, rt.HISTOGRAM_EVERY = FT_SAVE_EVERY, FT_HIST_EVERY
    os.environ["TACOTRON2_TRACE_DIR"] = str(trace_dir)
    try:
        ft, k34, enc = finetune_run("", van, root / "ft", ("encoder.",), False)
    finally:
        rt.SAVE_EVERY, rt.HISTOGRAM_EVERY = saved
        del os.environ["TACOTRON2_TRACE_DIR"]
    add(k34)
    add(enc)
    n = len(ft["steps"])
    if not _ckpt_equal(str(root / "ft" / "last.ckpt"), ft["checkpoint"]):
        raise SmokeFailure("finetune: last.ckpt (AsyncSaver, after the last step) differs from "
                           "finetuned.ckpt")
    (events_path,) = (root / "ft" / "lightning_logs").glob("*/events.out.tfevents.*")
    events = read_events(events_path)
    scalars = {t for _, kind, t, _ in events if kind == "scalar"}
    images = {t: [s for s, kind, u, _ in events if kind == "image" and u == t]
              for t in EVENT_IMAGES}
    hists = [(s, t) for s, kind, t, _ in events if kind == "histogram"]
    n_val = ft["phases"]["validation"]["n"] + 1  # in the loop, and at the end
    n_params = len(_params(ft["checkpoint"]))
    if not set(EVENT_SCALARS) <= scalars:
        raise SmokeFailure(f"event file: scalars {sorted(set(EVENT_SCALARS) - scalars)} missing")
    mel_images = [v for _, kind, t, v in events if kind == "image" and t.startswith("val_mel")]
    if any(len(v) != n_val for v in images.values()) or not all(
            h == 80 and png for h, _, png in mel_images):
        raise SmokeFailure(f"event file: images {images}, want 4 at each of {n_val} validations")
    want_hist = sorted(s for s in range(1, n + 1) if s % FT_HIST_EVERY == 0)
    if sorted({s for s, _ in hists}) != want_hist or len(hists) != len(want_hist) * n_params:
        raise SmokeFailure(f"event file: histograms at {sorted({s for s, _ in hists})} "
                           f"({len(hists)}), want {n_params} at each of {want_hist}")
    kernel_names = trace_kernel_names(Path(trace_path(str(trace_dir))))
    missing = {w: [k for k in TRACE_KERNELS[w] if not any(k in x for x in kernel_names)]
               for w, c in {**k34, **enc}.items() if c}
    bwd_traced = sum("bilstm_bwd_kernel" in x for x in kernel_names)
    if any(missing.values()) or bwd_traced != enc["bilstm_backward"]:
        raise SmokeFailure(f"the trace lacks kernels the counters counted: {missing}; "
                           f"bilstm_bwd_kernel {bwd_traced} times, counted "
                           f"{enc['bilstm_backward']}")
    res["finetune"] = {"steps": ft["steps"], "phases": ft["phases"], "launches": {**k34, **enc},
                       "events": {"scalars": sorted(scalars), "images": images,
                                  "histogram_steps": want_hist, "tensors": n_params,
                                  "bytes": events_path.stat().st_size},
                       "trace": {"kernel_events": len(kernel_names),
                                 "bytes": Path(trace_path(str(trace_dir))).stat().st_size}}
    print(f"  event file: {len(events)} summaries, CRCs held; scalars {sorted(scalars)}; 4 images "
          f"at each of {n_val} validations; {n_params} histograms at steps {want_hist}. Trace: "
          f"{len(kernel_names)} kernel events, every counted wrapper's kernels named, "
          f"bilstm_bwd_kernel {bwd_traced} times")
    lap("traced finetune")
    B = ft["steps"][0]["rows"]
    readings.update(train_split(van["cfg"], ft["checkpoint"], van["speech"], van["root"], B,
                                log, tag="[finetune]", readings=True)["kernels"])
    lap("K3 / K4 at the finetune's shapes")

    # the same finetune untraced, 8 steps of 4 an epoch: the step times;
    # then with the mel cache on, so that from the second epoch on the
    # loader reads each mel back instead of computing it
    raw = json.loads(Path(van["cfg"]).read_text())
    manifest = root / "train_x4.csv"
    manifest.write_text("\n".join(van["rows"][:1] + van["rows"][1:] * FT_TIMING_REPEAT) + "\n")
    raw["dataset"]["train"] = str(manifest)
    per_epoch = (len(van["rows"]) - 1) * FT_TIMING_REPEAT // B
    runs = {}
    rt.SAVE_EVERY = FT_TIMING_SAVE_EVERY
    try:
        for cache in (False, True):
            raw["dataset"]["preprocessing"]["cache"] = cache
            cfg_t = root / f"timing_cache{int(cache)}.json"
            cfg_t.write_text(json.dumps(raw))
            out, k34, enc = finetune_run(
                "[timing, mel cache]" if cache else "[timing]", van, root / f"ft_cache{int(cache)}",
                ("encoder.",), False, ("--max-steps", str(FT_TIMING_MAX_STEPS)), cfg_t)
            add(k34)
            add(enc)
            runs[cache] = (out, step_sets(out, per_epoch, FT_TIMING_SAVE_EVERY))
    finally:
        rt.SAVE_EVERY = saved[0]
    (timed, sets), (cached, sets_cached) = runs[False], runs[True]
    lap("timing finetunes")
    traced_ms = float(np.median([1e3 * s["s"] for s in ft["steps"][1:]]))
    res["finetune_timing"] = {"steps": timed["steps"], "phases": timed["phases"], "sets": sets,
                              "traced_ms_median": traced_ms, "cached_steps": cached["steps"],
                              "cached_sets": sets_cached}
    st = sets["steady"]["ms_median"]
    print(f"  finetune B={B}, host clock: steady {st:.1f} ms/step (steps "
          f"{sets['steady']['steps']}), {sets['steady']['mel_frames_per_s']:.0f} mel frames/s; "
          f"the two steps after a validation "
          f"{[round(x, 1) for x in sets['after_validation']['ms']]}"
          f" ms (waits for the batch {[round(x, 1) for x in sets['after_validation']['wait_ms']]}"
          f" ms, steady waits {[round(x, 1) for x in sets['steady']['wait_ms']]}); after a "
          f"background save {[round(x, 1) for x in sets['after_save']['ms']]} ms; under the "
          f"trace {traced_ms:.1f} ms; phases {timed['phases']} on {card}")
    print(f"  the same with the mel cache on: steady {sets_cached['steady']['ms_median']:.1f} "
          f"ms/step, after a validation "
          f"{[round(x, 1) for x in sets_cached['after_validation']['ms']]} ms (waits "
          f"{[round(x, 1) for x in sets_cached['after_validation']['wait_ms']]} ms), after a "
          f"save {[round(x, 1) for x in sets_cached['after_save']['ms']]} ms on {card}")

    # the controllable finetune at B=128
    ft_c, k34, enc = finetune_run("[controls]", ctl, root / "ft_controls",
                                  ("encoder.", "speaker_embedding."), True)
    B = ft_c["steps"][0]["rows"]
    add(k34, "[controls]")
    add(enc)
    c_ms = [1e3 * s["s"] for s in ft_c["steps"][1:]]
    res["finetune_controls"] = {
        "steps": ft_c["steps"], "phases": ft_c["phases"], "ms_median": float(np.median(c_ms)),
        "mel_frames_per_s": sum(s["mel_frames"] for s in ft_c["steps"][1:])
        / sum(s["s"] for s in ft_c["steps"][1:])}
    print(f"  finetune [controls] B={B}: {res['finetune_controls']['ms_median']:.1f} "
          f"ms/step (median of steps 2-{len(ft_c['steps'])}, each after a validation), "
          f"{res['finetune_controls']['mel_frames_per_s']:.0f} mel frames/s on {card}")
    lap("controllable finetune")
    readings.update(train_split(ctl["cfg"], ft_c["checkpoint"], ctl["speech"], ctl["root"], B,
                                log, "[controls]", "[finetune]", True)["kernels"])
    cfg = load_config(ctl["cfg"])
    model = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision))
    load_model_state(ft_c["checkpoint"], model)
    readings.update({k: v for k, v in enc_rows_alone(model.cuda(), B, log).items()
                     if k.startswith("bilstm")})
    del model
    lap("K3 / K4 and the encoder at the controllable finetune's shapes")

    # train_prosody on the lj-hifi manifests, its targets the controls' columns
    raw = json.loads(Path(lj_hifi["cfg"]).read_text())
    feats = raw["extensions"]["controls"]["features"]
    raw["extensions"]["prosody_model"] = {"active": False, "features": feats}
    p_cfg = root / "prosody.json"
    p_cfg.write_text(json.dumps(raw))
    pro = cli(["train_prosody", "--config", str(p_cfg), "--speech-dir", str(lj_hifi["speech"]),
               "--results-dir", str(root / "prosody"), "--steps", str(PROSODY_STEPS),
               "--batch-size", str(PROSODY_B), "--seed", str(SEED)])
    (p_events,) = (root / "prosody" / "lightning_logs" / "prosody").glob("events.out.tfevents.*")
    p_scalars = {t for _, kind, t, _ in read_events(p_events) if kind == "scalar"}
    want = {"train_loss", "val_loss"} | {f"{s}_{f}" for s in ("train", "val") for f in feats}
    if (len(pro["steps"]) != PROSODY_STEPS or not all(math.isfinite(s["loss"])
                                                      for s in pro["steps"])
            or not want <= p_scalars or Path(pro["checkpoint"]).name != "prosody_final.ckpt"):
        raise SmokeFailure(f"train_prosody: {pro['steps']}, scalars missing "
                           f"{sorted(want - p_scalars)}, {pro['checkpoint']}")
    p_ms = [1e3 * s["s"] for s in pro["steps"][1:]]
    res["train_prosody"] = {"steps": pro["steps"], "val": pro["val"],
                            "ms_median": float(np.median(p_ms))}
    print(f"  train_prosody: {PROSODY_STEPS} steps at batch {PROSODY_B}, losses "
          f"{[round(s['loss'], 4) for s in pro['steps']]}, frames "
          f"{[s['frames'] for s in pro['steps']]}, {res['train_prosody']['ms_median']:.1f} "
          f"ms/step (median of steps 2-{PROSODY_STEPS}); CCC scalars in the event file on {card}")
    lap("train_prosody")

    # the style-loss phase at full width
    raw = json.loads((ROOT / "config" / STYLE_CONFIG).read_text())
    tr = raw["training"]
    if (tr["batch_size"], tr["precision"], raw["extensions"]["prosody_model"]["active_after"]) \
            != (32, "16-mixed", 0.5):
        raise SmokeFailure(f"{STYLE_CONFIG}: not batch 32, 16-mixed, active_after 0.5")
    src = json.loads(Path(lj_hifi["cfg"]).read_text())["dataset"]
    raw["dataset"].update({k: src[k] for k in ("train", "val", "test")})
    s_cfg = root / "style.json"
    s_cfg.write_text(json.dumps(raw))
    loaded, load = [], ckpt_lib.load_prosody_checkpoint
    ckpt_lib.load_prosody_checkpoint = lambda path: loaded.append(load(path)) or loaded[-1]
    td.reset_launches()
    try:
        sty = cli(["train", "--config", str(s_cfg), "--speech-dir", str(lj_hifi["speech"]),
                   "--seed", str(SEED), "--results-dir", str(root / "style"), "--max-steps",
                   str(STYLE_STEPS), "--prosody-model-checkpoint", pro["checkpoint"]])
    finally:
        ckpt_lib.load_prosody_checkpoint = load
    k34, want = dict(td.CONTROLS_LAUNCHES), _want_k34(sty)
    add(k34, "[controls]")
    after = int(STYLE_STEPS * 0.5)
    has = ["style_loss" in s for s in sty["steps"]]
    if has != [s["step"] > after for s in sty["steps"]] or not all(
            math.isfinite(s["style_loss"]) for s in sty["steps"] if "style_loss" in s):
        raise SmokeFailure(f"style phase: style_loss in steps {has}, want from step {after + 1}")
    file_sd = torch.load(pro["checkpoint"], map_location="cpu", weights_only=False)["state_dict"]
    if len(loaded) != 1 or not all(torch.equal(v.cpu(), file_sd[k])
                                   for k, v in loaded[0].state_dict().items()):
        raise SmokeFailure("style phase: the prosody predictor's weights changed")
    if k34 != want or dict(td.LAUNCHES) != want:
        raise SmokeFailure(f"style phase: K3/K4 launches {k34} (controls mode), want {want}")
    said = cli(["say", "--config", str(s_cfg), "--checkpoint", sty["checkpoint"],
                "--hifi-gan-checkpoint", g_path, "--text", TRAIN_TEXTS[0], "--out",
                str(root / "style.wav"), "--random-seed", str(SEED), "--max-len-override", "64",
                "--speaker-id", str(CTL_SPEAKER), "--controls", CTL_VALUES])
    if not 1 <= said["n_frames"] <= 64:
        raise SmokeFailure(f"say of the style phase's checkpoint: {said}")
    plain = [1e3 * s["s"] for s in sty["steps"][1:] if "style_loss" not in s]
    style = [1e3 * s["s"] for s in sty["steps"] if "style_loss" in s]
    # where the style loss's time goes: its forward and backward alone at
    # the style steps' shape, eager, and split by kernel (torch.profiler)
    predictor = loaded[0]
    Bs, Ts = sty["steps"][-1]["rows"], sty["steps"][-1]["decode_frames"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 13)
    target = torch.randn(Bs, Ts, 80, device=dev, generator=g)
    post = (target + 0.1 * torch.randn(Bs, Ts, 80, device=dev, generator=g)).requires_grad_()
    lens = torch.full((Bs,), Ts, device=dev)

    def style_fb():
        with torch.enable_grad():
            prosody_style_loss(predictor, post, target, lens).backward()

    style_split = kernel_split(style_fb)
    style_eager = eager_ms(style_fb, 3)
    res["style"] = {"steps": sty["steps"], "phases": sty["phases"], "plain_ms": plain,
                    "style_ms": style, "launches": k34, "say": said,
                    "style_loss_eager_ms": style_eager, "style_loss_split_ms": style_split}
    print(f"  the style loss alone (B={Bs}, T={Ts}, forward and backward, eager): "
          f"{style_eager:.1f} ms; device ms by kernel: "
          + ", ".join(f"{k[:60]} {v:.2f}" for k, v in list(style_split.items())[:8]))
    print(f"  style phase ({STYLE_CONFIG}, B=32): style_loss "
          f"{[round(s.get('style_loss', float('nan')), 5) for s in sty['steps']]}, plain steps "
          f"{[round(x, 1) for x in plain]} ms, style steps {[round(x, 1) for x in style]} ms "
          f"(decode frames {[s['decode_frames'] for s in sty['steps']]}); predictor unchanged; "
          f"K3/K4 {k34}; say {said['n_frames']} frames on {card}")

    # the CLI's margin over the eager step (4b at B=32, 4e at B=64)
    margins = {}
    for key, B in (("train", TRAIN_B), ("train_controls", CTL_TRAIN_B)):
        perf = log.get(key, {}).get("perf")
        if perf:
            margins[f"B{B}"] = {"cli_ms": perf["ms_per_step_median"],
                                "eager_ms": perf["split_ms"]["train_step"]}
    res["cli_margin"] = margins
    print("  the CLI's step against the eager step: " + ", ".join(
        f"{k} {v['cli_ms']:.1f} / {v['eager_ms']:.1f} ms" for k, v in margins.items())
        + f" on {card}")
    res["seconds"] = time.perf_counter() - t_phase
    res["readings"] = readings
    print(f"  phase 4g: {res['seconds']:.1f} s on {card}")
    log["train_extras"] = res
    torch.cuda.empty_cache()
    return launches, readings


def _extras_source(name: str, cfg_path: Path, n: int, conditioned: bool) -> dict:
    """For ``--train-extras``: a synthetic corpus of ``n`` WAVs, its manifest
    (with speakers 0-3 and the controls' columns when ``conditioned``), and
    random full-width weights of ``cfg_path`` as the run's checkpoint."""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning

    root = WORK / name
    speech = _synth_corpus(root, n)
    raw = json.loads(cfg_path.read_text())
    if conditioned:
        feats = raw["extensions"]["controls"]["features"]
        rng = np.random.default_rng(SEED + 9)
        rows = ["|".join(["text", "wav", "speaker_id", *feats])] + [
            "|".join([TRAIN_TEXTS[i % len(TRAIN_TEXTS)], f"s{i:03d}.wav", str(i % 4),
                      *(repr(float(x)) for x in rng.uniform(-1, 1, len(feats)))])
            for i in range(n)]
    else:
        rows = ["text|wav"] + [f"{TRAIN_TEXTS[i % len(TRAIN_TEXTS)]}|s{i:03d}.wav"
                               for i in range(n)]
    cfg = train_setup(root, raw, rows, 32)
    ckpt = str(root / "random.ckpt")
    torch.save(to_lightning(random_tacotron(load_config(str(cfg)), 10.0).state_dict()), ckpt)
    return {"cfg": cfg, "ckpt": ckpt, "speech": speech, "root": root, "rows": rows}


def train_extras_mode() -> int:
    """``--train-extras``: the kernels' build and phase 4g alone, on random
    full-width checkpoints and synthetic corpora in 4b's and 4e's shapes
    (4e's conditioned manifest in place of 4f's lj-hifi ones); details to
    ``chiprun_out/train_extras.json``."""
    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build

    card = card_line()
    print(f"[4g] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    build.build_all()
    log: dict = {"card": card}
    try:
        WORK.mkdir(parents=True, exist_ok=True)
        van = _extras_source("train", ROOT / "config" / "vanilla-ljspeech-stop.json",
                             TRAIN_WAVS, False)
        ctl = _extras_source("train_controls", ROOT / "config" / CTL_CONFIG, CTL_TRAIN_WAVS,
                             True)
        launches, readings = train_extras_phase(
            van, ctl, {"cfg": str(ctl["cfg"]), "speech": ctl["speech"]}, write_hifigan(), log,
            card)
        log.update({"launches": launches})
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "train_extras.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"launches": launches, "readings": readings}))
    return 0


# ---------------------------------------------------------------------------
# phase 4h: description-conditioned speech (descriptions-libritts.json)

DESC_CONFIG = "descriptions-libritts.json"  # 562 voices, description dim 768, D = 640
DESC_VOICES = (0, 80, 160, 240, 320, 400, 480, 561)  # 8 of the 562
DESC_ROWS = 144  # the corpus' rows; the first DESC_AUGMENTED are augmented_ids.csv's
DESC_AUGMENTED = 128  # the finetune's rows: one batch of 2 x 64
DESC_BLANK_FROM = 136  # rows from here on have a blank description
DESC_SECS = (1.5, 3.0)  # the synthetic 24 kHz WAVs' lengths
DESC_TRAIN_STEPS = 3
DESC_TOL = 2e-4  # a BERT pooler row on the card against the CPU's (tests/test_bert.py's bert-base)
DESC_SPEAKER = 240  # the say's voice
DESC_PHRASES = (
    "A calm, deep male voice with a slow and steady pace.",
    "A bright young female voice, fast and cheerful, slightly breathy.",
    "An old man speaking softly in a low, gravelly tone.",
    "A clear, neutral narrator reading at a moderate speed.",
    "An excited woman with a high pitch and lively intonation.",
    "A tired, monotone voice, quiet and slow, with long pauses.",
    "A warm storyteller with expressive pitch and a gentle rhythm.",
    "A loud, energetic announcer speaking quickly and crisply.",
)
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2)
TC_PER_SPEAKER = 2  # test_correlation's rows of each of 4e's four voices
TC_MAX_LEN = 256


def desc_text(i: int) -> str:
    """A LibriTTS-like text of 150-250 characters: two of TRAIN_TEXTS (a
    third where they fall short), cut at a word."""
    t = f"{TRAIN_TEXTS[i % 8]} {TRAIN_TEXTS[(3 * i + 1) % 8]}"
    if len(t) < 150:
        t = f"{t} {TRAIN_TEXTS[(i + 5) % 8]}"
    return t if len(t) <= 250 else t[:t.rindex(" ", 0, 249)] + "."


def bert_vocab() -> list:
    """A synthetic 30,522-line WordPiece vocabulary in bert-base-uncased's
    layout: [PAD], [unused0-98], [UNK], [CLS], [SEP], [MASK], single
    characters and their ## pieces, the descriptions' words, then filler
    words and pieces."""
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    words = " ".join(DESC_PHRASES).lower().replace(",", " ").replace(".", " ").split()
    toks = (["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
            + chars + ["##" + c for c in chars if c.isalnum()] + words + ["##ly", "##ing", "##s"])
    toks = list(dict.fromkeys(toks))
    i = 0
    while len(toks) < BERT_BASE["vocab_size"]:
        toks.append(f"word{i}" if i % 2 == 0 else f"##piece{i}")
        i += 1
    return toks


def write_safetensors(path: Path, tensors: dict) -> None:
    """``tensors`` (CPU, f32) as a ``.safetensors`` file: an 8-byte
    little-endian header length, the JSON header padded to 8 bytes, the
    buffers end to end."""
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        b = t.detach().contiguous().cpu().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset,
                                                                                 offset + len(b)]}
        offset += len(b)
        blobs.append(b)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for b in blobs:
            f.write(b)


def bert_inputs(root: Path) -> tuple:
    """A random BERT of bert-base's shapes from SEED, saved twice: a state
    dict with the ``bert.`` prefix and gamma / beta LayerNorm names (a
    ``BertForPreTraining`` file's) with ``vocab.txt`` beside it, and an
    HF-layout directory (``config.json``, ``tokenizer_config.json``,
    ``vocab.txt``, ``model.safetensors`` written here). -> (the file, the
    directory, the model on the CPU)"""
    import torch

    from tacotron2_tpu_torch.models.bert import Bert, BertConfig

    g = torch.Generator()
    g.manual_seed(SEED)
    bert = Bert(BertConfig(**BERT_BASE)).init_weights(g).eval()
    sd = bert.state_dict()
    vocab = "\n".join(bert_vocab()) + "\n"
    pt_dir, hf_dir = root / "bert_pt", root / "bert_hf"
    for d in (pt_dir, hf_dir):
        d.mkdir(parents=True, exist_ok=True)
        (d / "vocab.txt").write_text(vocab)
    legacy = {}
    for k, v in sd.items():
        if ".LayerNorm." in k:
            k = k.replace(".weight", ".gamma").replace(".bias", ".beta")
        legacy["bert." + k] = v
    legacy["bert.embeddings.position_ids"] = torch.arange(BERT_BASE["max_position_embeddings"])[None]
    legacy["cls.predictions.bias"] = torch.zeros(BERT_BASE["vocab_size"])
    torch.save(legacy, pt_dir / "bert.pt")
    (hf_dir / "config.json").write_text(json.dumps({"model_type": "bert", **BERT_BASE,
                                                    "layer_norm_eps": 1e-12}))
    (hf_dir / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": True}))
    write_safetensors(hf_dir / "model.safetensors", sd)
    return str(pt_dir / "bert.pt"), str(hf_dir), bert


def desc_corpus(root: Path) -> tuple:
    """A LibriTTS-like corpus: DESC_ROWS WAVs at 24 kHz of the 8 voices of
    DESC_VOICES, texts of 150-250 chars, an ``id`` column, a ``description``
    column (one of DESC_PHRASES and the row's number; blank from row
    DESC_BLANK_FROM on), ``augmented_ids.csv`` of the first DESC_AUGMENTED
    ids. -> (the speech dir, the manifest)"""
    speech = _synth_corpus(root, DESC_ROWS, 24000, DESC_SECS)
    rows = ["id|text|wav|speaker_id|description"]
    for i in range(DESC_ROWS):
        spk = DESC_VOICES[i % len(DESC_VOICES)]
        # one description a row, so that a row's original embedding is its own
        desc = ("" if i >= DESC_BLANK_FROM
                else f"{DESC_PHRASES[(i * 5) % len(DESC_PHRASES)][:-1]}, take {i}.")
        rows.append(f"{spk}_{1000 + i // 8}_{i:06d}|{desc_text(i)}|s{i:03d}.wav|{spk}|{desc}")
    manifest = root / "libritts-descriptions.csv"
    manifest.write_text("\n".join(rows) + "\n")
    (speech / "augmented_ids.csv").write_text(
        "".join(r.split("|")[0] + "\n" for r in rows[1:DESC_AUGMENTED + 1]))
    return speech, manifest


def decode_step_bound(pk, B: int, L: int) -> tuple:
    """The least time of one decode step (K1, or K5 in an int8 pack): each
    weight read once, the memory (bf16) and its projection (f32) read once;
    the products of the cells, prenet, query, heads and the attention."""
    H4 = pk.w_att.shape[0]
    H, A, K = H4 // 4, pk.wq.shape[0], pk.w_loc.shape[2]
    D = pk.w_att.shape[1] - pk.wp2_t.shape[0] - H
    w = nbytes(pk.w_att, pk.b_att, pk.w_dec, pk.b_dec, pk.wp1_t, pk.wp2_t, pk.wq, pk.w_loc, pk.wv,
               pk.w_out, pk.b_out, pk.s_att, pk.s_dec)
    mats = (pk.w_att, pk.w_dec, pk.wp1_t, pk.wp2_t, pk.wq, pk.w_out)
    flops = 2 * B * sum(m.numel() for m in mats) + B * (L * A * (4 * K + 4) + 2 * L * D + 4 * L)
    return bound_ms(w + B * L * (2 * D + 4 * A), flops, card_peak("int8") if pk.quantized else card_peak("bf16"))


def _embedding_files(speech: Path) -> dict:
    """Every description-embedding file under ``speech`` -> {its bytes:
    [its stem, whether an augmentation]} (rows of one description share a
    base embedding)."""
    import numpy as np

    files: dict = {}
    for p in sorted((speech / "description_embeddings").rglob("*.npy")):
        aug = p.parent.name.endswith("_augmentations")
        stem = p.parent.name[:-len("_augmentations")] if aug else p.stem
        files.setdefault(np.load(p).astype(np.float32).tobytes(), []).append((stem, aug))
    return files


def bert_part(root: Path, log: dict, card: str) -> tuple:
    """The BERT files, the corpus, ``embed_descriptions`` through the CLI on
    the card (2 augmentations), the same on the CPU (every file within
    DESC_TOL), the two weight layouts (the same bits), BERT's device time at
    one description. -> (the state-dict file, the HF dir, the speech dir,
    the embedded manifest, the readings)"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.run.embed_descriptions import (BertEmbedder, do_embed_descriptions,
                                                            pad_ids)

    t0 = time.perf_counter()
    bert_pt, bert_hf, bert = bert_inputs(root)
    speech, manifest = desc_corpus(root)
    res = {"inputs_s": time.perf_counter() - t0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_csv = cli(["embed_descriptions", "--csv", str(manifest), "--speech-dir", str(speech),
                   "--bert", bert_pt, "--augmentations", "2"])["out_csv"]
    torch.cuda.synchronize()
    res["embed_card_s"] = time.perf_counter() - t0
    cpu_speech = root / "cpu"
    cpu_speech.mkdir()
    t0 = time.perf_counter()
    do_embed_descriptions(str(manifest), str(cpu_speech), out_csv=str(root / "cpu.csv"),
                          bert=bert_pt, augmentations=2, device="cpu")
    res["embed_cpu_s"] = time.perf_counter() - t0
    card_files = sorted((speech / "description_embeddings").rglob("*.npy"))
    rel = [p.relative_to(speech) for p in card_files]
    if rel != sorted(p.relative_to(cpu_speech)
                     for p in (cpu_speech / "description_embeddings").rglob("*.npy")):
        raise SmokeFailure("embed_descriptions wrote other files on the card than on the CPU")
    want_files = 3 * DESC_BLANK_FROM  # a base row and 2 augmentations a description
    worst = max(float(np.abs(np.load(speech / r) - np.load(cpu_speech / r)).max()) for r in rel)
    if len(rel) != want_files or not worst <= DESC_TOL:
        raise SmokeFailure(f"embed_descriptions: {len(rel)} files (want {want_files}), card "
                           f"against CPU {worst:.3e} (limit {DESC_TOL:g})")
    manifest_col = [r.split("|")[-1] for r in Path(out_csv).read_text().splitlines()[1:]]
    if sum(bool(x) for x in manifest_col) != DESC_BLANK_FROM:
        raise SmokeFailure(f"embed_descriptions' manifest: {sum(map(bool, manifest_col))} paths")
    texts = list(DESC_PHRASES)
    emb = BertEmbedder.from_local(bert_pt)
    a = emb.embed(texts)
    b = BertEmbedder.from_local(bert_hf).embed(texts)
    if not np.array_equal(a, b):
        raise SmokeFailure("the bert.-prefixed state dict and the safetensors directory give "
                           f"other embeddings ({float(np.abs(a - b).max()):.3e})")
    # BERT's device time at one description, beside its bound (weights read once)
    ids, mask = pad_ids([emb.tokenizer.encode(DESC_PHRASES[0], 512)])
    ids_d, mask_d = torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda")
    with torch.no_grad():
        dev_ms = time_ms(lambda: emb.model(ids_d, mask_d), 10, 5)
    layer_bytes = sum(p.numel() * 4 for n, p in bert.named_parameters()
                      if not n.startswith("embeddings."))
    T, Hd, I = ids.shape[1], BERT_BASE["hidden_size"], BERT_BASE["intermediate_size"]
    flops = BERT_BASE["num_hidden_layers"] * (2 * T * (4 * Hd * Hd + 2 * Hd * I) + 4 * T * T * Hd)
    b_ms, b_by = bound_ms(layer_bytes + 3 * T * Hd * 4, flops, 67e12)  # f32 (no TF32): 67 TFLOPS
    res.update({"files": len(rel), "card_vs_cpu_max_abs_err": worst, "layouts_equal": True,
                "bert_device_ms": dev_ms, "bert_tokens": T, "bert_bound_ms": b_ms,
                "bert_bound_by": b_by, "layer_weight_bytes": layer_bytes, "card": card})
    print(f"  BERT (bert-base shapes, random from the seed): files {res['inputs_s']:.1f} s; "
          f"embed_descriptions of {DESC_BLANK_FROM} of {DESC_ROWS} rows with 2 augmentations "
          f"{res['embed_card_s']:.2f} s on the card, {res['embed_cpu_s']:.2f} s on the CPU; "
          f"{len(rel)} files within {worst:.3e} of the CPU's (limit {DESC_TOL:g}); the two weight "
          f"layouts the same bits; one description ({T} ids) {dev_ms:.3f} ms on the card (bound "
          f"{b_ms:.3f} ms, {b_by}) on {card}")
    del emb, bert
    return bert_pt, bert_hf, speech, out_csv, res


def desc_train_part(root: Path, speech: Path, out_csv: str, log: dict, card: str) -> tuple:
    """``train`` of the description config (pretraining: blank embeddings)
    at B=64, then ``train --finetune`` at B=128 (the augmented rows, the
    original or an augmentation each read), both through the CLI, their
    batches' description rows caught; K3 / K4 at D = 640 against their
    plain versions at the first batch's shapes of each. -> (launches,
    readings, the record)"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.ops import encoder_lstm as el
    from tacotron2_tpu_torch.ops import train_decode as td
    from tacotron2_tpu_torch.run import train as rt

    raw = json.loads((ROOT / "config" / DESC_CONFIG).read_text())
    B, dim = raw["training"]["batch_size"], raw["model"]["args"]["description_embeddings_dim"]
    lines = Path(out_csv).read_text().splitlines()
    cfg = train_setup(root, raw, lines, 32)
    seen: list = []
    step = rt.train_step

    def catching(model, opt, sched, batch, *a, **k):
        seen.append(batch["description_embeddings"].float().cpu().numpy())
        return step(model, opt, sched, batch, *a, **k)

    launches: dict = {}
    readings: dict = {}
    rt.train_step = catching
    try:
        td.reset_launches()
        el.reset_launches()
        pre = cli(["train", "--config", str(cfg), "--speech-dir", str(speech), "--seed",
                   str(SEED), "--results-dir", str(root / "pre"), "--max-steps",
                   str(DESC_TRAIN_STEPS)])
        k34, enc = dict(td.LAUNCHES), dict(el.LAUNCHES)
        pre_seen, seen[:] = list(seen), []
        want = _want_k34(pre)
        losses = [s["loss"] for s in pre["steps"]]
        print(f"  train (pretraining, blank embeddings): {len(pre['steps'])} steps at B="
              f"{pre['steps'][0]['rows']}, losses {[round(x, 4) for x in losses]}, decode frames "
              f"{[s['decode_frames'] for s in pre['steps']]}; K3/K4 {k34}, encoder {enc}")
        if (k34 != want or enc["bilstm_backward"] != len(pre["steps"])
                or not all(math.isfinite(x) for x in losses)):
            raise SmokeFailure(f"description train: K3/K4 {k34} (want {want}), encoder {enc}, "
                               f"losses {losses}")
        if any(b.any() for b in pre_seen) or {b.shape for b in pre_seen} != {(B, dim)}:
            raise SmokeFailure("pretraining read description rows that are not blank (zeros)")
        for k, n in {**k34, **enc}.items():
            launches[k] = launches.get(k, 0) + n
        src = {"cfg": str(cfg), "ckpt": pre["checkpoint"], "speech": speech}
        ft, k34f, encf = finetune_run("[descriptions]", src, root / "ft",
                                      ("encoder.", "speaker_embedding."), False)
    finally:
        rt.train_step = step
    for k, n in {**k34f, **encf}.items():
        launches[k] = launches.get(k, 0) + n
    files = _embedding_files(speech)
    ids = {r.split("|")[2][:-4] for r in lines[1:DESC_AUGMENTED + 1]}  # the augmented rows' stems
    picked = [[f for f in files.get(row.tobytes(), []) if f[0] in ids]
              for b in seen for row in b]
    # a pick equal to an augmentation only, to an original only (an
    # augmentation that masked no token has its original's bits: neither)
    n_aug = sum(bool(p) and all(aug for _, aug in p) for p in picked)
    n_base = sum(bool(p) and not any(aug for _, aug in p) for p in picked)
    if (len(picked) != DESC_AUGMENTED * len(ft["steps"]) or not all(picked) or not n_aug
            or not n_base):
        raise SmokeFailure(f"finetune: {sum(not p for p in picked)} of {len(picked)} description "
                           f"rows are no file of an augmented row on disk; {n_aug} augmentations "
                           f"and {n_base} originals told apart")
    print(f"  finetune: every batch row a file on disk of an augmented id's row ({n_aug} of "
          f"{len(picked)} picks an augmentation, {n_base} an original, the rest either)")
    ms = lambda run: float(np.median([1e3 * s["s"] for s in run["steps"][1:]]))
    rec = {"train": {"steps": pre["steps"], "ms_median": ms(pre), "launches": {**k34, **enc}},
           "finetune": {"steps": ft["steps"], "ms_median": ms(ft),
                        "launches": {**k34f, **encf}, "augmented_picks": n_aug,
                        "original_picks": n_base, "picks": len(picked)}}
    for tag, run, rows in (("[descriptions]", pre, B), ("[descriptions,finetune]", ft, 2 * B)):
        got = train_split(str(cfg), run["checkpoint"], speech, root, rows, log, tag=tag,
                          readings=True, split=False)["kernels"]
        for name, r in got.items():
            readings.setdefault(name, {})[f"B{rows}"] = r
    rec["kernels"] = readings
    print(f"  train {rec['train']['ms_median']:.1f} ms/step at B={B}, finetune "
          f"{rec['finetune']['ms_median']:.1f} ms/step at B={2 * B} (host clock, medians of "
          f"steps 2-) on {card}")
    torch.cuda.empty_cache()
    return launches, readings, rec


def desc_say_part(root: Path, bert_pt: str, g_path: str, log: dict, card: str) -> tuple:
    """``say --speaker-id --description --bert-checkpoint`` of random
    full-width weights of the description config (gate forced: 256 frames),
    bf16 then int8, the launch counters read around each; K1 and K5 at D =
    640 against their plain versions (a step, 4-step chunks), the kernel
    decode against the plain one over 32 frames, a description against a
    blank one; the chunk's time per step at D = 640 beside the vanilla
    D = 512's. -> (launches, readings, the record)"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning
    from tacotron2_tpu_torch.ops import decoder_loop as dl
    from tacotron2_tpu_torch.ops import mrf
    from tacotron2_tpu_torch.run.embed_descriptions import BertEmbedder
    from tacotron2_tpu_torch.run.say import load_tacotron
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    cfg_path = str(ROOT / "config" / DESC_CONFIG)
    cfg = load_config(cfg_path)
    ckpt = str(root / "descriptions-random.ckpt")
    torch.save(to_lightning(random_tacotron(cfg, 10.0).state_dict()), ckpt)
    text, desc = desc_text(3), DESC_PHRASES[0]
    out = str(root / "say.wav")
    say = lambda quant, d=desc: cli(
        ["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint", g_path,
         "--text", text, "--out", out, "--random-seed", str(SEED), "--max-len-override", "256",
         "--speaker-id", str(DESC_SPEAKER), "--bert-checkpoint", bert_pt]
        + (["--description", d] if d else []) + (["--quantize-int8"] if quant else []))
    launches: dict = {}
    runs = {}
    for quant in (False, True):
        mode = "int8" if quant else "bf16"
        if not quant:
            say(quant)  # warm-up
        dl.reset_launches()
        mrf.reset_launches()
        res = say(quant)
        got = {**dl.LAUNCHES, **mrf.LAUNCHES, **mrf.F32_LAUNCHES}
        cell, other = ("lstm_cell_int8", "lstm_cell") if quant else ("lstm_cell", "lstm_cell_int8")
        want = {"prenet": 256, cell: 512, other: 0, "location_attention": 256, "heads": 256,
                "quantize_xh": 512 if quant else 0}
        print(f"  say --speaker-id {DESC_SPEAKER} --description '{desc}'"
              f"{' --quantize-int8' if quant else ''}: {res['n_frames']} frames, BERT encode "
              f"{res['bert_s'] * 1e3:.1f} ms; launches {got}")
        if res["n_frames"] != 256 or {k: got[k] for k in want} != want or not res["bert_s"] > 0:
            raise SmokeFailure(f"description {mode} say: {res}, launches {got}, want {want}")
        check_vocode_launches(got, 1, f"description {mode} say")
        wav, _ = read_wav(out)
        if len(wav) != res["cut"] * 256 or not np.isfinite(wav).all() or not np.abs(wav).max() > 0:
            raise SmokeFailure(f"bad description wav: {len(wav)} samples for cut {res['cut']}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        runs[mode] = {"run": res, "launches": got, "rtf": res["say_s"] / res["audio_s"],
                      "decode_us_per_step": res["decode_s"] / res["n_frames"] * 1e6,
                      "bert_ms": res["bert_s"] * 1e3, "card": card}
        print(f"  description {mode} say: decode {runs[mode]['decode_us_per_step']:.1f} us/step, "
              f"RTF {runs[mode]['rtf']:.4f}, BERT {runs[mode]['bert_ms']:.1f} ms on {card}")

    dev = torch.device("cuda")
    model = load_tacotron(cfg, ckpt, dev)
    prep = cfg.dataset.preprocessing
    ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
        [normalize_text(text, prep.allowed_chars, prep.end_token, False)])
    ci, cl = torch.as_tensor(ci, device=dev), torch.as_tensor(cl, device=dev)
    L = int(cl[0])
    d_emb = torch.as_tensor(BertEmbedder.from_local(bert_pt).embed([desc]), device=dev)
    kw = dict(speaker_id=torch.tensor([DESC_SPEAKER]))
    fast = model.forward_infer_fast(ci, cl, 32, prenet_dropout=False, description_embeddings=d_emb,
                                    **kw)
    ref = model.forward_infer(ci, cl, 32, prenet_dropout=False, description_embeddings=d_emb, **kw)
    if fast.n_frames != ref.n_frames or not torch.equal(fast.lengths, ref.lengths):
        raise SmokeFailure("description kernel decode and plain decode disagree on frames")
    check("decode_32_frames[descriptions]", [("mels_post", fast.mels_post, ref.mels_post),
                                             ("gates", fast.gates, ref.gates),
                                             ("alignments", fast.alignments, ref.alignments)],
          DECODE_TOL, log)
    blank = model.forward_infer_fast(ci, cl, 32, prenet_dropout=False,
                                     description_embeddings=torch.zeros_like(d_emb), **kw)
    apart = float((blank.mels - fast.mels).abs().max())
    print(f"  the mels with the description against a blank one: {apart:.3e} apart (more than "
          f"{10 * K1_CHUNK_TOL:g} wanted)")
    if not apart > 10 * K1_CHUNK_TOL:
        raise SmokeFailure(f"a description moves the mels by {apart:.3e} only")

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 21)
    lengths = torch.tensor([L], dtype=torch.int32, device=dev)
    padded = torch.tensor([L, L - PAD], dtype=torch.int32, device=dev)
    pk, pk8 = model.make_packed_decoder(), model.make_packed_decoder(True)
    D = model.cfg.encoded_full_dim
    chunk_check(f"decode_chunk[1]@D{D}", pk, model, lengths, 1, g, log)
    chunk_check(f"decode_chunk[4]@D{D}", pk, model, lengths, 4, g, log, True)
    chunk_check(f"decode_chunk[4,pad]@D{D}", pk, model, padded, 4, g, log)
    k5_check(f"int8_step@D{D}", pk8, model, lengths, 1, g, log, True)
    k5_check(f"int8_chunk[4]@D{D}", pk8, model, lengths, 4, g, log)
    k5_check(f"int8_chunk[4,pad]@D{D}", pk8, model, padded, 4, g, log)

    # a 64-step chunk per step: D = 640 (bf16 and int8) beside the vanilla D = 512
    vanilla = random_tacotron(load_config(str(ROOT / "config" / "vanilla-ljspeech-stop.json")),
                              10.0).to(dev)
    readings: dict = {}
    for name, m, p in (("lstm_cell", model, pk), ("lstm_cell_int8", model, pk8),
                       ("lstm_cell", vanilla, vanilla.make_packed_decoder()),
                       ("lstm_cell_int8", vanilla, vanilla.make_packed_decoder(True))):
        enc, att_enc, s = chunk_inputs(m, lengths, g)
        m1, m2 = dl.prenet_masks(64, 1, m.cfg.prenet_dim, m.cfg.dropout, g, dev)
        b_ms, b_by = decode_step_bound(p, 1, L)
        r = readings.setdefault(name, {})[f"D{enc.shape[2]}"] = {
            "D": enc.shape[2], "L": L, "B": 1,
            "chunk_us_per_step": time_ms(lambda: dl.decode_chunk(p, enc, att_enc, lengths, s, m1,
                                                                 m2), 5, 1) / 64 * 1e3,
            "plain_us_per_step": time_ms(lambda: dl.decode_chunk_plain(p, enc, att_enc, lengths, s,
                                                                       m1, m2), 2, 1) / 64 * 1e3,
            "bound_us_per_step": b_ms * 1e3, "bound_by": b_by, "card": card}
        print(f"  decode chunk ({'int8' if p.quantized else 'bf16'}, D={r['D']}, L={L}, B=1) per "
              f"step: {r['chunk_us_per_step']:.1f} us, plain {r['plain_us_per_step']:.1f} us, "
              f"bound {r['bound_us_per_step']:.2f} us ({b_by}) on {card}")
    del model, vanilla
    torch.cuda.empty_cache()
    return launches, readings, {"say": runs, "description_vs_blank_mels": apart}


def kept_gate_bias(g0, margin: float = EVAL_GATE_MARGIN, long: int = 32) -> tuple:
    """``choose_gate_bias`` for a sweep: of the midpoints between two logits
    at least ``margin`` apart, the bias that stops the most rows at a frame
    in [``long``, T) (WAVs long enough for the prosody extractor), then in
    (0, T), then at the most distinct frames. -> (the bias, the frame
    counts it gives)"""
    import numpy as np

    from tacotron2_tpu_torch.run.test import gate_to_lengths

    v = np.unique(g0)
    best = None
    for bias in [-(a + b) / 2 for a, b in zip(v[:-1], v[1:]) if b - a >= margin]:
        n = gate_to_lengths((g0 + bias)[..., None])
        inside = (n > 0) & (n < g0.shape[1])
        score = (int((inside & (n >= long)).sum()), int(inside.sum()),
                 len(set(n[inside].tolist())))
        if best is None or score > best[0]:
            best = (score, float(bias), n)
    return best[1], best[2]


def correlation_part(ctl: dict, g_path: str, root: Path, log: dict, card: str,
                     log_name: str = "test_correlation.log") -> tuple:
    """``test_correlation`` through the CLI on ``ctl``'s controllable
    checkpoint (4e's): a test manifest of TC_PER_SPEAKER rows of each of
    its four voices, max_len TC_MAX_LEN, the gate's row as trained or
    negated (the gate does not feed back) and its bias from
    ``kept_gate_bias`` on a probe decode of every override (the gate's bias
    at 10), whichever stops more rows, so that rows stop at the frames the
    probes predict; K1 5 launches a step with the decoder cell and
    the heads reading the controls at each, K2 one vocode a batch with kept
    rows, one directory per override holding its kept rows' WAVs, and
    ``correlations.csv`` by JAX's rules; its output to ``chiprun_out/<log_name>``.
    -> (launches, the record)"""
    import csv as csv_mod

    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.prosody import FEATURE_NAMES
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import load_tacotron2_checkpoint, to_lightning
    from tacotron2_tpu_torch.data.loader import collate
    from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest
    from tacotron2_tpu_torch.ops import decoder_loop as dl
    from tacotron2_tpu_torch.ops import encoder_lstm, mrf
    from tacotron2_tpu_torch.run.say import load_tacotron
    from tacotron2_tpu_torch.run.test_correlation import analyze_correlations, control_overrides
    from tacotron2_tpu_torch.training.step import to_device

    root.mkdir(parents=True, exist_ok=True)
    rows = ctl["rows"]
    head = rows[0].split("|")
    spk_col = head.index("speaker_id")
    chosen = [r for s in range(4) for r in [x for x in rows[1:]
                                            if x.split("|")[spk_col] == str(s)][:TC_PER_SPEAKER]]
    (root / "tc_test.csv").write_text("\n".join([rows[0]] + chosen) + "\n")
    raw = json.loads(Path(ctl["cfg"]).read_text())
    raw["dataset"]["test"] = str(root / "tc_test.csv")
    tc_cfg = root / "tc.json"
    tc_cfg.write_text(json.dumps(raw))
    cfg = load_config(str(tc_cfg))
    feats = list(cfg.extensions.controls.features)

    # the probe: every override's decode with the gate's bias at 10 (no row
    # stops) and the sweep's generator; the gate does not feed back, so these
    # logits less 10 plus a bias are the sweep's own
    dev = torch.device("cuda")
    model = load_tacotron(cfg, ctl["ckpt"], dev)
    with torch.no_grad():
        model.decoder.gate.bias.fill_(10.0)
    ds = manifest_dataset(cfg, read_manifest(str(root / "tc_test.csv")), str(ctl["speech"]),
                          cache=False)
    b = to_device(collate([ds[i] for i in range(len(ds))], bucket_chars=32), dev)
    overrides = [str(o) for o in control_overrides(len(feats))]
    best = None
    # the gate's row as trained and negated (a trained row's logits may only
    # rise from frame 0, so no bias stops it in range): the better of the two
    for sign in (1.0, -1.0):
        gates = []
        for o in control_overrides(len(feats)):
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            with torch.no_grad():
                model.decoder.gate.weight.mul_(sign)
            probe = model.forward_infer_fast(
                b["chars_idx"], b["chars_len"], TC_MAX_LEN, generator=gen,
                speaker_id=b["speaker_id"], controls=torch.tensor([list(o)] * len(ds), device=dev))
            with torch.no_grad():
                model.decoder.gate.weight.mul_(sign)
            gates.append(probe.gates[..., 0].float().cpu().numpy() - 10.0)
        bias, n = kept_gate_bias(np.concatenate(gates))
        kept = (int(((n >= 32) & (n < TC_MAX_LEN)).sum()), int(((n > 0) & (n < TC_MAX_LEN)).sum()))
        if best is None or kept > best[0]:
            best = (kept, sign, bias, n.reshape(len(overrides), len(ds)))
    _, sign, bias, want = best
    sd, hp = load_tacotron2_checkpoint(ctl["ckpt"])
    sd["decoder.gate.weight"] = sd["decoder.gate.weight"] * sign
    sd["decoder.gate.bias"] = torch.full_like(sd["decoder.gate.bias"], bias)
    ckpt = str(root / "tc.ckpt")
    torch.save(to_lightning(sd, hp), ckpt)
    del model
    print(f"  test_correlation: {len(chosen)} rows of voices 0-3; the gate's row x {sign:g}, bias "
          f"{bias:.6f} from probes of the {len(overrides)} overrides: "
          f"{int(((want > 0) & (want < TC_MAX_LEN)).sum())} of {want.size} rows stop in range")

    dl.reset_launches()
    mrf.reset_launches()
    encoder_lstm.reset_launches()
    t0 = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / log_name, "w") as f, contextlib.redirect_stdout(f):
        res = cli(["test_correlation", "--config", str(tc_cfg), "--speech-dir",
                   str(ctl["speech"]), "--checkpoint", ckpt, "--hifi-gan-checkpoint", g_path,
                   "--results-dir", str(root / "tc"), "--max-len-override", str(TC_MAX_LEN)])
    seconds = time.perf_counter() - t0
    k1, ctl_l, k2 = dict(dl.LAUNCHES), dict(dl.CONTROLS_LAUNCHES), \
        {**mrf.LAUNCHES, **mrf.F32_LAUNCHES}
    enc = encoder_lstm.LAUNCHES["bilstm_forward"]
    got_n = np.array([res["overrides"][o]["lengths"] for o in overrides])
    if not np.array_equal(got_n, want):
        raise SmokeFailure(f"test_correlation: rows stopped at {got_n.tolist()}, the probes "
                           f"predict {want.tolist()}")
    batches = [bt for o in overrides for bt in res["overrides"][o]["batches"]]
    steps = sum(min(-(-bt["decode_frames"] // 64) * 64, TC_MAX_LEN) for bt in batches)
    vocodes = sum(1 for bt in batches if bt["vocoded"])
    want_k1 = {"prenet": steps, "lstm_cell": 2 * steps, "location_attention": steps,
               "heads": steps, "quantize_xh": 0, "lstm_cell_int8": 0}
    want_ctl = {"lstm_cell": steps, "heads": steps, "quantize_xh": 0, "lstm_cell_int8": 0}
    kept = sum(len(res["overrides"][o]["wavs"]) for o in overrides)
    print(f"  test_correlation (its output in chiprun_out/{log_name}): "
          f"{len(overrides)} overrides x {res['rows']} rows in {seconds:.1f} s "
          f"(decode {res['decode_s']:.1f} s, vocode {res['vocode_s']:.1f} s), {kept} WAVs kept; "
          f"K1 {k1} (reading the controls {ctl_l}), K2 {k2}, bilstm_forward {enc} on {card}")
    if k1 != want_k1 or ctl_l != want_ctl or enc != len(batches):
        raise SmokeFailure(f"test_correlation: K1 {k1}, controls {ctl_l}, encoder {enc}; want "
                           f"{want_k1}, {want_ctl}, {len(batches)}")
    check_vocode_launches(k2, vocodes, "test_correlation")
    dirs = sorted(p.name for p in (root / "tc").iterdir() if p.is_dir())
    if dirs != sorted(overrides) or not 0 < kept < len(overrides) * res["rows"]:
        raise SmokeFailure(f"test_correlation: directories {dirs}, {kept} WAVs kept")
    for o in overrides:
        names = sorted(p.name for p in (root / "tc" / o).glob("*.wav"))
        if names != sorted(f"{i}.wav" for i in res["overrides"][o]["wavs"]):
            raise SmokeFailure(f"test_correlation {o}: WAVs {names}")
    with open(res["correlations"], newline="") as f:
        table = list(csv_mod.reader(f, delimiter="|"))
    samples = {d: sum(len(res["overrides"][o]["wavs"]) for o, t in zip(
        overrides, control_overrides(len(feats))) if sum(abs(v) > 1e-9 for v in t) == 0
        or abs(t[d]) > 1e-9) for d in range(len(feats))}
    body = table[1:]
    named = [r[0] for r in body[::len(FEATURE_NAMES)]]
    rules = (table[0] == ["control", "acoustic_feature", "pearson_r", "n"]
             and len(body) % len(FEATURE_NAMES) == 0 and named == [f for f in feats if f in named]
             and all([r[1] for r in body[i:i + len(FEATURE_NAMES)]] == FEATURE_NAMES
                     for i in range(0, len(body), len(FEATURE_NAMES)))
             and all((r[2] == "nan" or (-1.0 <= float(r[2]) <= 1.0 and int(r[3]) >= 3))
                     and int(r[3]) <= samples[feats.index(r[0])] for r in body)
             and all(samples[feats.index(f)] >= 3 for f in named))
    again = (root / "tc" / "correlations.csv").read_bytes()
    analyze_correlations(str(root / "tc"), feats)
    if not rules or again != (root / "tc" / "correlations.csv").read_bytes():
        raise SmokeFailure(f"correlations.csv breaks JAX's rules: {table[:3]}, samples {samples}")
    print(f"  correlations.csv: {len(body)} rows for {named}, e.g. "
          + "; ".join(f"{r[0]}/{r[1]} r={r[2]} n={r[3]}" for r in body[:3]))
    out = {**k1, **k2, "bilstm_forward": enc, "lstm_cell[controls]": ctl_l["lstm_cell"],
           "heads[controls]": ctl_l["heads"]}
    return out, {"seconds": seconds, "rows": res["rows"], "kept": kept, "bias": bias,
                 "decode_s": res["decode_s"], "vocode_s": res["vocode_s"], "steps": steps,
                 "vocodes": vocodes, "correlation_rows": len(body), "card": card}


def descriptions_phase(ctl: dict, g_path: str, log: dict, card: str) -> tuple:
    """Phase 4h on ``ctl`` (4e's controllable run, for ``test_correlation``):
    ``bert_part``, ``desc_train_part``, ``desc_say_part``,
    ``correlation_part``; K3 / K4's shared-memory plan mirrored in
    ``train_decode.att_smem_bytes`` against the library's. -> ({kernels-line
    row: launches}, {kernels-line row: its readings at D = 640})"""
    import torch

    from tacotron2_tpu_torch.ops import train_decode as td

    t_phase = time.perf_counter()
    root = WORK / "descriptions"
    root.mkdir(parents=True, exist_ok=True)
    launches: dict = {}
    res = log["descriptions"] = {"card": card}  # filled as the parts pass

    def add(got: dict) -> None:
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    for L, S, D in ((160, 1, 640), (224, 1, 640), (256, 2, 640), (256, 1, 512), (96, 8, 640)):
        lib = td.smem_bytes(L, S, 1024, 128, D, 31)
        mine = {"att_fwd_cluster": td.att_smem_bytes(False, L, S, 1024, 128, D, 31),
                "att_bwd_cluster": td.att_smem_bytes(True, L, S, 1024, 128, D, 31)}
        if any(lib[k] != v for k, v in mine.items()):
            raise SmokeFailure(f"att_smem_bytes {mine} != the library's {lib} at L={L}, S={S}")
    print(f"  K3 / K4's attention shared memory: the mirror equals the library's; S at B=128: "
          f"L=192 -> {td.attention_cluster(128, td._sms('cuda'), 192, 1024, 128, 640, 31)}, "
          f"L=256 -> {td.attention_cluster(128, td._sms('cuda'), 256, 1024, 128, 640, 31)}")
    lap = step_timer(res, "4h", card)
    bert_pt, _, speech, out_csv, res["bert"] = bert_part(root, log, card)
    lap("BERT and embed_descriptions")
    got, readings, res["train"] = desc_train_part(root, speech, out_csv, log, card)
    add(got)
    lap("train and finetune")
    got, say_readings, res["say"] = desc_say_part(root, bert_pt, g_path, log, card)
    add(got)
    readings.update(say_readings)
    lap("say")
    got, res["test_correlation"] = correlation_part(ctl, g_path, root / "correlation", log, card)
    add(got)
    lap("test_correlation")
    res["seconds"] = time.perf_counter() - t_phase
    res["readings"] = readings
    print(f"  phase 4h: {res['seconds']:.1f} s on {card}")
    torch.cuda.empty_cache()
    return launches, readings


def descriptions_mode() -> int:
    """``--descriptions``: the kernels' build and phase 4h alone, on a random
    controllable checkpoint and a synthetic corpus in 4e's shapes in place
    of 4e's run; details to ``chiprun_out/descriptions.json``."""
    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build

    card = card_line()
    print(f"[4h] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    t0 = time.perf_counter()
    build.build_all()
    log: dict = {"card": card, "build_s": time.perf_counter() - t0}
    launches, readings = {}, {}
    try:
        WORK.mkdir(parents=True, exist_ok=True)
        ctl = _extras_source("train_controls", ROOT / "config" / CTL_CONFIG, 32, True)
        launches, readings = descriptions_phase(ctl, write_hifigan(), log, card)
        log["launches"] = launches
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "descriptions.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"launches": launches, "readings": readings}, default=str))
    return 0


# ---------------------------------------------------------------------------
# phase 4i: Global Style Tokens (GST_BASE with extensions.gst)

GST_BASE = "vanilla-lj-hifi-stop.json"  # 4 voices, 16-mixed, batch 64: D = 512 + 256 = 768
GST_EXT = {"active": True, "token_embedding_size": 256}
GST_TRAIN_STEPS = 3
# attention mass on padded chars of a teacher-forced batch (alignment_metrics):
# K3 masks them, so any mass there is a fault
GST_PAD_MASS = 1e-6
# the GST's style (one reference) on the card against the same weights on
# the CPU, relative to its max: f32 sums in another order (cuDNN's convs,
# cuBLAS); under bf16 a sum a last bit apart flips the next operand's
# rounding (2^-8): tests/test_torch_gst.py bounds bf16 against JAX at 1.3e-2
GST_TOL = {"32-true": 1e-4, "16-mixed": 2e-2}
GST_SPEAKER = 2
GST_SERVE_LSB = 0  # a served request batched against alone (serve_controls_phase's reading)
GST_TEST_ROWS = 16  # test's rows of 4e's corpus
GST_EXPORT_ROWS = (16, 8)  # train_mel_export's train and val rows


def gst_raw(base: str = GST_BASE) -> dict:
    """``base``'s config with ``extensions.gst`` active (no config in config/
    has it)."""
    raw = json.loads((ROOT / "config" / base).read_text())
    raw.setdefault("extensions", {})["gst"] = dict(GST_EXT)
    return raw


def catch_first(module, name: str) -> tuple:
    """Wrap ``module.name`` so that its first call's arguments are kept ->
    (the dict that will hold them under "args", a call that restores it)."""
    fn, held = getattr(module, name), {}

    def wrapped(*a):
        held.setdefault("args", a)
        return fn(*a)

    setattr(module, name, wrapped)
    return held, lambda: setattr(module, name, fn)


def gst_train_part(root: Path, ctl: dict, log: dict, card: str) -> tuple:
    """``train`` of the GST config (GST_TRAIN_STEPS steps at its batch of 64)
    on 4e's corpus (128 WAVs of voices 0-3; 4f's lj-hifi manifests hold 114
    train rows, fewer than the finetune's 128), then ``train --finetune`` at
    B=128, through the CLI. Holds: finite losses; K3 / K4 at launches per
    step x T; ``bilstm_backward`` once a step and on its first inputs
    against its plain version; the style tokens and every GST BatchNorm's
    statistics moved from the seed's init; the teacher-forced alignments'
    pad mass (``utils/diagnostics.py``) under GST_PAD_MASS; the finetune's
    ``encoder.*`` / ``speaker_embedding.*`` bit for bit and every other
    parameter moved (``finetune_run``), the GST's statistics too; K3 / K4 at
    D = 768 against their plain versions at both batches. -> (launches,
    readings, the record, the finetuned checkpoint, the train config)"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import load_tacotron2_checkpoint
    from tacotron2_tpu_torch.data.loader import collate
    from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron2_tpu_torch.ops import encoder_lstm as el
    from tacotron2_tpu_torch.ops import train_decode as td
    from tacotron2_tpu_torch.run.say import load_tacotron, model_config_from
    from tacotron2_tpu_torch.training.step import to_device
    from tacotron2_tpu_torch.utils.diagnostics import alignment_metrics

    raw = gst_raw()
    B = raw["training"]["batch_size"]
    root.mkdir(parents=True, exist_ok=True)
    cfg_train = train_setup(root, raw, ctl["rows"], 32)
    cfg = load_config(str(cfg_train))
    held, restore = catch_first(el, "bilstm_backward")
    try:
        td.reset_launches()
        el.reset_launches()
        t0 = time.perf_counter()
        run = cli(["train", "--config", str(cfg_train), "--speech-dir", str(ctl["speech"]),
                   "--seed", str(SEED), "--results-dir", str(root / "train"), "--max-steps",
                   str(GST_TRAIN_STEPS)])
        train_s = time.perf_counter() - t0
    finally:
        restore()
    k34, enc = dict(td.LAUNCHES), dict(el.LAUNCHES)
    want, losses = _want_k34(run), [s["loss"] for s in run["steps"]]
    print(f"  train: {len(run['steps'])} steps at B={run['steps'][0]['rows']}, losses "
          f"{[round(x, 4) for x in losses]}, decode frames "
          f"{[s['decode_frames'] for s in run['steps']]}, {train_s:.1f} s; K3/K4 {k34}, "
          f"encoder {enc} on {card}")
    if (k34 != want or enc["bilstm_backward"] != len(run["steps"])
            or not all(math.isfinite(x) for x in losses) or len(losses) != GST_TRAIN_STEPS):
        raise SmokeFailure(f"GST train: K3/K4 {k34} (want {want}), encoder {enc}, losses "
                           f"{losses}")
    a = held["args"]
    check(f"bilstm_backward[gst@B{a[0].shape[1]},T{a[0].shape[2]}]",
          [("dg", el.bilstm_backward(*a), el.bilstm_backward_plain(*a))], ENC_TOL, log,
          "bilstm_backward", own=True)
    del held, a

    torch.manual_seed(SEED)  # do_train's init from --seed
    init = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision)
                     ).state_dict()
    trained = load_tacotron2_checkpoint(run["checkpoint"])[0]
    gst_keys = [k for k in trained if k.startswith("gst.")]
    stats = [k for k in gst_keys if k.endswith(("running_mean", "running_var"))]
    unmoved = [k for k in ["gst.stl.embed"] + stats if torch.equal(init[k], trained[k])]
    print(f"  train: {len(gst_keys)} GST tensors; the style tokens moved by "
          f"{float((trained['gst.stl.embed'] - init['gst.stl.embed']).abs().max()):.3e}, the "
          f"{len(stats)} BatchNorm statistics by up to "
          f"{max(float((trained[k] - init[k]).abs().max()) for k in stats):.3e}")
    if unmoved or len(stats) != 12:
        raise SmokeFailure(f"GST train: {unmoved} did not move ({len(stats)} statistics)")

    dev = torch.device("cuda")
    model = load_tacotron(cfg, run["checkpoint"], dev)
    ds = manifest_dataset(cfg, read_manifest(cfg.dataset.train)[:B], str(ctl["speech"]),
                          cache=False)
    b = to_device(collate([ds[i] for i in range(B)], 32, 128), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with torch.no_grad():
        out = model.forward_teacher(b["chars_idx"], b["chars_len"], b["mel"], b["mel_len"],
                                    train=False, generator=gen, speaker_id=b["speaker_id"])
    health = alignment_metrics(out.alignments.float().cpu().numpy(), b["chars_len"].cpu().numpy(),
                               b["mel_len"].cpu().numpy())
    print(f"  a teacher-forced batch of the trained GST model (B={B}, L="
          f"{b['chars_idx'].shape[1]}, T={b['mel'].shape[1]}): {health} (pad mass under "
          f"{GST_PAD_MASS:g} wanted)")
    if not health["pad_mass"] < GST_PAD_MASS:
        raise SmokeFailure(f"GST: attention mass {health['pad_mass']:.3e} on padded chars")
    del model, out, b

    readings: dict = {}
    for name, r in train_split(str(cfg_train), run["checkpoint"], ctl["speech"], root, B, log,
                               tag="[gst]", readings=True, split=False)["kernels"].items():
        readings.setdefault(name, {})[f"B{B}"] = {**r, "card": card}
    src = {"cfg": str(cfg_train), "ckpt": run["checkpoint"], "speech": ctl["speech"]}
    t0 = time.perf_counter()
    ft, k34f, encf = finetune_run("[gst]", src, root / "ft", ("encoder.", "speaker_embedding."),
                                  False)
    ft_s = time.perf_counter() - t0
    tuned = load_tacotron2_checkpoint(ft["checkpoint"])[0]
    still = [k for k in stats if torch.equal(trained[k], tuned[k])]
    if still:
        raise SmokeFailure(f"GST finetune: the BatchNorm statistics {still} did not move")
    print(f"  finetune: the GST's {len(stats)} BatchNorm statistics moved too ({ft_s:.1f} s)")
    for name, r in train_split(str(cfg_train), ft["checkpoint"], ctl["speech"], root, 2 * B,
                               log, tag="[gst,finetune]", readings=True,
                               split=False)["kernels"].items():
        readings.setdefault(name, {})[f"B{2 * B}"] = {**r, "card": card}
    ms = lambda r: float(np.median([1e3 * s["s"] for s in r["steps"][1:]]))
    rec = {"train": {"steps": run["steps"], "ms_median": ms(run), "seconds": train_s,
                     "launches": {**k34, **enc}, "alignment": health},
           "finetune": {"steps": ft["steps"], "ms_median": ms(ft), "seconds": ft_s,
                        "launches": {**k34f, **encf}}, "card": card}
    print(f"  train {rec['train']['ms_median']:.1f} ms/step at B={B}, finetune "
          f"{rec['finetune']['ms_median']:.1f} ms/step at B={2 * B} (host clock, medians of "
          f"steps 2-) on {card}")
    launches: dict = {}
    for got in (k34, enc, k34f, encf):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()
    return launches, readings, rec, ft["checkpoint"], cfg_train


def gst_say_part(root: Path, g_path: str, log: dict, card: str) -> tuple:
    """``say --speaker-id`` of random full-width GST weights (gate forced:
    256 frames; the style's attention sharpened, W_query x 32, and its value
    widened, W_value x 4, so that a reference reaches the audio), with and
    without ``--gst-reference`` (a synthetic 22,050 Hz WAV), bf16 then int8,
    the counters read around each: 5 / 7 launches a step and one vocode. The
    encoder's forward on the say's own inputs against its plain version;
    the style on the card against the same weights on the CPU (GST_TOL, f32
    and bf16); the kernel decode against the plain one over 32 frames; a
    reference's mels against the neutral ones; K1 and K5 at D = 768 against
    their plain versions; the chunk's time a step beside the vanilla
    D = 512's. -> (launches, readings, the record, the config, the
    checkpoint)"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import read_wav, write_wav
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning
    from tacotron2_tpu_torch.models.layers import F32
    from tacotron2_tpu_torch.ops import decoder_loop as dl
    from tacotron2_tpu_torch.ops import encoder_lstm as el
    from tacotron2_tpu_torch.ops import mrf
    from tacotron2_tpu_torch.run.say import gst_reference_mel, load_tacotron
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    cfg_path = root / "gst.json"
    cfg_path.write_text(json.dumps(gst_raw()))
    cfg = load_config(str(cfg_path))
    m = random_tacotron(cfg, 10.0)
    with torch.no_grad():
        m.gst.stl.attention.W_query.weight.mul_(32.0)
        m.gst.stl.attention.W_value.weight.mul_(4.0)
    ckpt = str(root / "gst-random.ckpt")
    torch.save(to_lightning(m.state_dict()), ckpt)
    del m
    ref = str(root / "reference.wav")
    write_wav(ref, _speechlike(22050, 190.0, 2.5, SEED), 22050)
    text, out = TRAIN_TEXTS[2], str(root / "say.wav")
    say = lambda quant, with_ref: cli(
        ["say", "--config", str(cfg_path), "--checkpoint", ckpt, "--hifi-gan-checkpoint", g_path,
         "--text", text, "--out", out, "--random-seed", str(SEED), "--max-len-override", "256",
         "--speaker-id", str(GST_SPEAKER)] + (["--gst-reference", ref] if with_ref else [])
        + (["--quantize-int8"] if quant else []))
    say(False, True)  # warm-up
    launches: dict = {}
    runs, wavs = {}, {}
    for quant in (False, True):
        for with_ref in (False, True):
            mode = ("int8" if quant else "bf16") + (", reference" if with_ref else ", neutral")
            dl.reset_launches()
            mrf.reset_launches()
            el.reset_launches()
            held, restore = catch_first(el, "bilstm_forward")
            try:
                res = say(quant, with_ref)
            finally:
                restore()
            got = {**dl.LAUNCHES, **mrf.LAUNCHES, **mrf.F32_LAUNCHES, **el.LAUNCHES}
            cell, other = (("lstm_cell_int8", "lstm_cell") if quant
                           else ("lstm_cell", "lstm_cell_int8"))
            want = {"prenet": 256, cell: 512, other: 0, "location_attention": 256, "heads": 256,
                    "quantize_xh": 512 if quant else 0, "bilstm_forward": 1}
            print(f"  say --speaker-id {GST_SPEAKER} ({mode}): {res['n_frames']} frames, "
                  f"decode {res['decode_s'] * 1e3:.1f} ms, RTF {res['say_s'] / res['audio_s']:.4f}"
                  f"; launches {got} on {card}")
            if res["n_frames"] != 256 or {k: got[k] for k in want} != want or (
                    res["gst_reference"] is None) == with_ref:
                raise SmokeFailure(f"GST {mode} say: {res}, launches {got}, want {want}")
            check_vocode_launches(got, 1, f"GST {mode} say")
            wav, _ = read_wav(out)
            if (len(wav) != res["cut"] * 256 or not np.isfinite(wav).all()
                    or not np.abs(wav).max() > 0):
                raise SmokeFailure(f"bad GST wav: {len(wav)} samples for cut {res['cut']}")
            if not quant and with_ref:
                a = held["args"]
                check(f"bilstm_forward[gst say@B{a[0].shape[1]},T{a[0].shape[2]}]",
                      list(zip(("hs", "cs", "act"), el.bilstm_forward(*a),
                               el.bilstm_forward_plain(*a))), ENC_TOL, log, "bilstm_forward")
            del held
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            wavs[mode] = wav
            runs[mode] = {"run": res, "launches": got, "rtf": res["say_s"] / res["audio_s"],
                          "decode_us_per_step": res["decode_s"] / res["n_frames"] * 1e6,
                          "card": card}
    apart = {q: float(np.abs(wavs[f"{q}, reference"] - wavs[f"{q}, neutral"]).max())
             for q in ("bf16", "int8")}
    print(f"  the reference's audio against the neutral one's (max abs): {apart}")
    if not min(apart.values()) > 0:
        raise SmokeFailure(f"--gst-reference did not reach the audio: {apart}")

    dev = torch.device("cuda")
    model, cpu = load_tacotron(cfg, ckpt, dev), load_tacotron(cfg, ckpt, torch.device("cpu"))
    ref_mel = gst_reference_mel(cfg, ref)
    style = {}
    for policy, tol in GST_TOL.items():
        pol = model.policy if policy == "16-mixed" else F32
        for what, mel in (("reference", ref_mel), ("neutral", None)):
            if mel is None:
                card_s, cpu_s = model.gst.neutral(pol), cpu.gst.neutral(pol)
            else:
                card_s, cpu_s = model.gst(mel.to(dev), policy=pol), cpu.gst(mel, policy=pol)
            e = float((card_s.cpu() - cpu_s).abs().max() / cpu_s.abs().max())
            style[f"{what}, {policy}"] = {"rel_err": e, "tol": tol,
                                          "max": float(cpu_s.abs().max())}
            print(f"  the GST's {what} style under {policy}, card against CPU: rel {e:.3e} (tol "
                  f"{tol:g}, max |style| {float(cpu_s.abs().max()):.4f})")
            if not e <= tol:
                raise SmokeFailure(f"the GST's {what} style under {policy}: card and CPU "
                                   f"{e:.3e} apart (tol {tol:g})")
    prep = cfg.dataset.preprocessing
    ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
        [normalize_text(text, prep.allowed_chars, prep.end_token, False)])
    ci, cl = torch.as_tensor(ci, device=dev), torch.as_tensor(cl, device=dev)
    L = int(cl[0])
    kw = dict(speaker_id=torch.tensor([GST_SPEAKER]), prenet_dropout=False)
    fast = model.forward_infer_fast(ci, cl, 32, gst_reference_mel=ref_mel, **kw)
    slow = model.forward_infer(ci, cl, 32, gst_reference_mel=ref_mel, **kw)
    if fast.n_frames != slow.n_frames or not torch.equal(fast.lengths, slow.lengths):
        raise SmokeFailure("GST kernel decode and plain decode disagree on frames")
    check("decode_32_frames[gst]", [("mels_post", fast.mels_post, slow.mels_post),
                                    ("gates", fast.gates, slow.gates),
                                    ("alignments", fast.alignments, slow.alignments)],
          DECODE_TOL, log)
    neutral = model.forward_infer_fast(ci, cl, 32, **kw)
    mel_apart = float((neutral.mels - fast.mels).abs().max())
    style_apart = float((model.gst_embedding(1, ref_mel) - model.gst_embedding(1)).abs().max())
    print(f"  the mels with the reference against the neutral style: {mel_apart:.3e} apart "
          f"(more than {10 * K1_CHUNK_TOL:g} wanted; the styles {style_apart:.3e} apart)")
    if not mel_apart > 10 * K1_CHUNK_TOL:
        raise SmokeFailure(f"a GST reference moves the mels by {mel_apart:.3e} only")

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 31)
    lengths = torch.tensor([L], dtype=torch.int32, device=dev)
    padded = torch.tensor([L, L - PAD], dtype=torch.int32, device=dev)
    pk, pk8 = model.make_packed_decoder(), model.make_packed_decoder(True)
    D = model.cfg.encoded_full_dim
    if D != cfg.model.encoded_dim + GST_EXT["token_embedding_size"]:
        raise SmokeFailure(f"the GST config's memory is {D} wide")
    chunk_check(f"decode_chunk[1]@D{D}", pk, model, lengths, 1, g, log)
    chunk_check(f"decode_chunk[4]@D{D}", pk, model, lengths, 4, g, log, True)
    chunk_check(f"decode_chunk[4,pad]@D{D}", pk, model, padded, 4, g, log)
    chunk_check(f"decode_chunk[1,16 rows]@D{D}", pk, model,
                torch.full((16,), 128, dtype=torch.int32, device=dev), 1, g, log)
    k5_check(f"int8_step@D{D}", pk8, model, lengths, 1, g, log, True)
    k5_check(f"int8_chunk[4]@D{D}", pk8, model, lengths, 4, g, log)
    k5_check(f"int8_chunk[4,pad]@D{D}", pk8, model, padded, 4, g, log)

    vanilla = random_tacotron(load_config(str(ROOT / "config" / "vanilla-ljspeech-stop.json")),
                              10.0).to(dev)
    readings: dict = {}
    for name, mdl, p in (("lstm_cell", model, pk), ("lstm_cell_int8", model, pk8),
                         ("lstm_cell", vanilla, vanilla.make_packed_decoder()),
                         ("lstm_cell_int8", vanilla, vanilla.make_packed_decoder(True))):
        enc, att_enc, s = chunk_inputs(mdl, lengths, g)
        m1, m2 = dl.prenet_masks(64, 1, mdl.cfg.prenet_dim, mdl.cfg.dropout, g, dev)
        b_ms, b_by = decode_step_bound(p, 1, L)
        r = readings.setdefault(name, {})[f"D{enc.shape[2]}"] = {
            "D": enc.shape[2], "L": L, "B": 1,
            "chunk_us_per_step": time_ms(lambda: dl.decode_chunk(p, enc, att_enc, lengths, s, m1,
                                                                 m2), 5, 1) / 64 * 1e3,
            "plain_us_per_step": time_ms(lambda: dl.decode_chunk_plain(p, enc, att_enc, lengths, s,
                                                                       m1, m2), 2, 1) / 64 * 1e3,
            "bound_us_per_step": b_ms * 1e3, "bound_by": b_by, "card": card}
        print(f"  decode chunk ({'int8' if p.quantized else 'bf16'}, D={r['D']}, L={L}, B=1) per "
              f"step: {r['chunk_us_per_step']:.1f} us, plain {r['plain_us_per_step']:.1f} us, "
              f"bound {r['bound_us_per_step']:.2f} us ({b_by}) on {card}")
    del model, cpu, vanilla
    torch.cuda.empty_cache()
    return launches, readings, {"say": runs, "style": style, "reference_vs_neutral_mels":
                                mel_apart, "reference_vs_neutral_style": style_apart,
                                "reference_vs_neutral_audio": apart}, cfg_path, ckpt


def gst_serve_part(root: Path, cfg_path: Path, ckpt: str, g_path: str, log: dict,
                   card: str) -> dict:
    """The warm server in this process with the GST entry (``multi_speaker``,
    max_len 256, the default batching): a warm-up request, the counters set
    to 0, a wave of 16 concurrent requests of voices 0-3, which must
    coalesce, K1 5 launches a step of every decode launch; then each of the
    16 alone, whose audio must equal the batched audio (GST_SERVE_LSB): a
    row's style is the entry's neutral one, computed once at load.
    -> {kernels-line row: launches}"""
    import concurrent.futures
    import os
    import threading

    import numpy as np

    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.ops import decoder_loop
    from tacotron2_tpu_torch.run import server as srv

    sroot = root / "serve"
    sroot.mkdir(parents=True, exist_ok=True)
    config = {"models": [{"name": "gst", "config": str(cfg_path), "checkpoint": ckpt,
                          "hifi_gan_checkpoint": g_path, "max_len": 256, "multi_speaker": True,
                          "num_voices": 4}],
              "batching": {"enabled": True, "window_ms": 8, "max_batch": 64, "depth": 2},
              "warmup": False}
    cwd = os.getcwd()
    os.chdir(sroot)
    started, holder = threading.Event(), {}
    thread = threading.Thread(target=lambda: holder.setdefault("result", srv.do_server(
        0, config, "warm", host="127.0.0.1",
        on_start=lambda h: (holder.setdefault("httpd", h), started.set()))), daemon=True)
    payloads = [{"text": TRAIN_TEXTS[i % len(TRAIN_TEXTS)], "model": 0, "seed": 400 + i,
                 "voice": i % 4} for i in range(16)]
    try:
        thread.start()
        while not started.wait(0.5):
            if not thread.is_alive():
                raise SmokeFailure("the GST server did not start")
        port = holder["httpd"].server_address[1]
        status, body, _ = _post(port, {"text": TEXT, "model": 0, "seed": 1, "voice": 1})
        if status != 200:
            raise SmokeFailure(f"warm-up request to the GST entry: {status} {body}")
        decoder_loop.reset_launches()
        barrier = threading.Barrier(16)

        def one(p):
            barrier.wait()
            return _post(port, p)

        calls0, rows0 = srv.BATCH_CALLS
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            got = list(ex.map(one, payloads))
        wall = time.perf_counter() - t0
        calls, rows = srv.BATCH_CALLS[0] - calls0, srv.BATCH_CALLS[1] - rows0
        k1 = dict(decoder_loop.LAUNCHES)
        bad = [(s, b) for s, b, _ in got if s != 200]
        lat = np.array([sec for _, _, sec in got])
        wave = {"requests": 16, "decode_launches": calls, "rows_per_launch": rows / max(calls, 1),
                "p50_s": float(np.percentile(lat, 50)), "p95_s": float(np.percentile(lat, 95)),
                "wall_s": wall, "launches": k1, "card": card}
        print(f"  wave of 16 to the GST entry: {wave}")
        if bad or not rows / calls > 1:
            raise SmokeFailure(f"the GST wave: {bad[:2]}, {rows} rows in {calls} launches")
        want = {"prenet": 256 * calls, "lstm_cell": 512 * calls, "location_attention": 256 * calls,
                "heads": 256 * calls, "quantize_xh": 0, "lstm_cell_int8": 0}
        if k1 != want:
            raise SmokeFailure(f"GST serve: K1 launches {k1}, want {want}")
        invariance = []
        for i, p in enumerate(payloads):
            status, solo, _ = _post(port, p)
            a = read_wav(str(sroot / got[i][1]["path"]))[0]
            b = read_wav(str(sroot / solo["path"]))[0]
            if status != 200 or len(a) != len(b):
                raise SmokeFailure(f"GST request {i} alone: {status}, {len(b)} samples, batched "
                                   f"{len(a)}")
            invariance.append(float(np.abs(np.round(a * 32768) - np.round(b * 32768)).max()))
        print(f"  GST, batched vs alone, PCM16 LSB of the 16 requests: {invariance}")
        if max(invariance) > GST_SERVE_LSB:
            raise SmokeFailure(f"a GST request's audio changed with its window: {invariance}")
    finally:
        if "httpd" in holder:
            holder["httpd"].shutdown()
        thread.join(60)
        os.chdir(cwd)
    log.setdefault("gst", {})["serve"] = {"wave": wave, "invariance_lsb": invariance}
    return k1


def gst_phase(ctl: dict, g_path: str, log: dict, card: str) -> tuple:
    """Phase 4i on ``ctl`` (4e's corpus and run): K3 / K4's shared-memory
    plan at D = 768 mirrored against the library's; ``gst_train_part``,
    ``gst_say_part``, ``gst_serve_part``; then ``test`` and
    ``train_mel_export`` of the GST config (``eval_test`` /
    ``eval_export``, GST_TEST_ROWS / GST_EXPORT_ROWS rows of 4e's corpus) and
    ``test_correlation`` of the controllable config with GST
    (``correlation_part``) on the finetuned weights, the controls' columns
    random, each step timed beside the card.
    -> ({kernels-line row: launches}, {kernels-line row: readings at D = 768})"""
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import load_tacotron2_checkpoint, to_lightning
    from tacotron2_tpu_torch.ops import train_decode as td

    t_phase = time.perf_counter()
    root = WORK / "gst"
    root.mkdir(parents=True, exist_ok=True)
    launches: dict = {}
    res = log.setdefault("gst", {})
    res["card"] = card
    steps = res["seconds_by_step"] = {}

    def add(got: dict) -> None:
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    def timed(name: str, t0: float) -> None:
        steps[name] = time.perf_counter() - t0
        print(f"  [4i] {name}: {steps[name]:.1f} s on {card}")

    sms = td._sms("cuda")
    for L, S in ((192, 1), (224, 2), (256, 2), (256, 1), (96, 8)):
        lib = td.smem_bytes(L, S, 1024, 128, 768, 31)
        mine = {"att_fwd_cluster": td.att_smem_bytes(False, L, S, 1024, 128, 768, 31),
                "att_bwd_cluster": td.att_smem_bytes(True, L, S, 1024, 128, 768, 31)}
        if any(lib[k] != v for k, v in mine.items()):
            raise SmokeFailure(f"att_smem_bytes {mine} != the library's {lib} at L={L}, S={S}, "
                               "D=768")
    res["att_smem"] = {f"B{B},L{L}": {"S": td.attention_cluster(B, sms, L, 1024, 128, 768, 31),
                                      "bwd_bytes": td.att_smem_bytes(
                                          True, L, td.attention_cluster(B, sms, L, 1024, 128, 768,
                                                                        31), 1024, 128, 768, 31)}
                       for B, L in ((64, 256), (128, 192), (128, 256))}
    print(f"  K3 / K4's attention shared memory at D = 768: the mirror equals the library's; "
          f"{res['att_smem']}")
    t0 = time.perf_counter()
    got, readings, res["train"], ft_ckpt, cfg_train = gst_train_part(root / "train", ctl, log,
                                                                     card)
    add(got)
    timed("train and finetune", t0)
    t0 = time.perf_counter()
    got, say_readings, res["say"], cfg_path, rand_ckpt = gst_say_part(root, g_path, log, card)
    add(got)
    readings.update(say_readings)
    timed("say", t0)
    t0 = time.perf_counter()
    add(gst_serve_part(root, cfg_path, rand_ckpt, g_path, log, card))
    timed("server", t0)

    t0 = time.perf_counter()
    head, rows = ctl["rows"][0], ctl["rows"][1:]
    raw = gst_raw()
    n_tr, n_val = GST_EXPORT_ROWS
    for split, lines in (("test", rows[:GST_TEST_ROWS]), ("train", rows[:n_tr]),
                         ("val", rows[n_tr:n_tr + n_val])):
        (root / f"eval_{split}.csv").write_text("\n".join([head] + lines) + "\n")
        raw["dataset"][split] = str(root / f"eval_{split}.csv")
    eval_cfg = root / "eval.json"
    eval_cfg.write_text(json.dumps(raw))
    probe = str(root / "probe.ckpt")
    torch.save(to_lightning(random_tacotron(load_config(str(eval_cfg)), 10.0).state_dict()), probe)
    add(eval_test("[gst]", eval_cfg, ctl["speech"], probe, g_path, root / "test", log))
    timed("test", t0)
    t0 = time.perf_counter()
    got, k3_export = eval_export("[gst]", eval_cfg, ctl["speech"], ft_ckpt, root / "export", log,
                                 card)
    add(got)
    readings.setdefault("teacher_forward", {})["export"] = k3_export
    timed("train_mel_export", t0)

    t0 = time.perf_counter()
    tc_raw = json.loads(Path(ctl["cfg"]).read_text())
    tc_raw.setdefault("extensions", {})["gst"] = dict(GST_EXT)
    tc_cfg = root / "gst_controls.json"
    tc_cfg.write_text(json.dumps(tc_raw))
    # the finetuned GST weights, the controls' columns (the last ones of the
    # decoder cell's input and the mel head's) random: random weights' gates
    # stop too few rows for the sweep's correlations
    sd = random_tacotron(load_config(str(tc_cfg)), 10.0).state_dict()
    for k, v in load_tacotron2_checkpoint(ft_ckpt)[0].items():
        if sd[k].shape == v.shape:
            sd[k] = v
        else:  # (rows, cols) widened by the controls
            sd[k] = torch.cat([v, sd[k][:, v.shape[1]:]], dim=1)
    tc_ckpt = str(root / "gst_controls.ckpt")
    torch.save(to_lightning(sd), tc_ckpt)
    got, res["test_correlation"] = correlation_part(
        {"rows": ctl["rows"], "cfg": str(tc_cfg), "ckpt": tc_ckpt, "speech": ctl["speech"]},
        g_path, root / "correlation", log, card, "test_correlation_gst.log")
    add(got)
    timed("test_correlation", t0)
    res["seconds"] = time.perf_counter() - t_phase
    res["readings"] = readings
    res["launches"] = launches
    print(f"  phase 4i: {res['seconds']:.1f} s on {card}")
    torch.cuda.empty_cache()
    return launches, readings


def gst_mode() -> int:
    """``--gst``: the kernels' build and phase 4i alone, on a synthetic
    corpus in 4e's shapes; details to ``chiprun_out/gst.json``."""
    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build

    card = card_line()
    print(f"[4i] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    t0 = time.perf_counter()
    build.build_all()
    log: dict = {"card": card, "build_s": time.perf_counter() - t0}
    launches, readings = {}, {}
    try:
        WORK.mkdir(parents=True, exist_ok=True)
        ctl = _extras_source("train_controls", ROOT / "config" / CTL_CONFIG, CTL_TRAIN_WAVS, True)
        launches, readings = gst_phase(ctl, write_hifigan(), log, card)
        if log.get("deferred"):
            raise SmokeFailure("; ".join(log["deferred"]))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "gst.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"launches": launches, "readings": readings}, default=str))
    print(card)
    return 0


# ---------------------------------------------------------------------------
# phase 4j: data-parallel train (torch.distributed) and the device prefetcher

DP_STEPS = 2  # train steps of each data-parallel comparison
DP_RANKS = 2  # ranks sharing the one card in (a): no data-parallel throughput
DP_RUN_STEPS = 3  # steps of the CLI runs of (b) and (c)
# (a)'s limits, the train limits of section 2, not new ones: a rank's step
# differs from one process's running the same code in a one-rank group in
# the order of its sums only (the BatchNorm statistics, the gradients'
# all-reduce, the dW GEMMs over half the rows), which flips bf16 roundings
# downstream as K3 / K4's own sums do. Against one process without a group
# the BatchNorm is cuDNN's. Both are held to every limit.
BN_FED_BIAS = tuple(f"encoder.convolutions.{4 * i}.bias" for i in range(3))
# The gradients are held as one vector, the relative L2 distance of every
# gradient to the reference's, and tensor by tensor (below); each tensor's
# worst element against its own max is reported beside the same reading
# between the two one-process steps, not held:
# a bf16 step's gradients sum bf16 operands behind train-mode BatchNorms
# (the encoder's and the postnet's), and two one-process steps that differ
# only in the BatchNorm's implementation read 1.3-1.6e-2 of a tensor's max
# against each other outside the encoder's conv stack and up to 1.8e-1 in
# it, where a conv's gradient cancels to a small part of its terms
# (PERF.md, PR 16).
# Each tensor is held too: its gradient's relative L2 distance
# (``tensor_grads_l2``; a BatchNorm-fed bias against its conv weight's
# gradient) to K4's gate-gradient limit, since a fresh model's first step
# reads up to 1.45e-2 on 14 of 55 tensors between the two one-process steps
# alone (PERF.md, PR 16); and the step's own update: the weights after it
# against Adam applied anew to the state before it with the step's own
# gradients, per tensor against that update's max (``adam``; two steps
# from one state part by Adam's lr x sign of near-zero gradients, which
# ``weights`` reads).
DP_TOL = {"loss": K3_TOL_TRAIN["mel_gate"], "bn": K3_TOL_TRAIN["mel_gate"],
          "grad_norm": GRAD_TOL, "grads": GRAD_TOL, "weights": GRAD_TOL,
          "tensor_grads_l2": K4_TOL["dg1"], "adam": GRAD_TOL}
# A defect planted in one vanilla step (``_plant_local_bn_grad``): the
# BatchNorm statistics' sums all-reduced forward but their gradients left
# local. The ranks' weights and statistics stay equal, so only DP_TOL's
# readings can see it: they must.


def dp_loader(run: dict, B: int):
    """``train``'s seeded loader over ``run``'s manifest, as ``do_train``
    builds it."""
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.data.loader import TTSDataLoader
    from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest, select_rows

    cfg = load_config(str(run["cfg"]))
    ds = manifest_dataset(cfg, select_rows(cfg, read_manifest(cfg.dataset.train)),
                          str(run["speech"]), cache_dir=str(run["root"] / "dp_cache"), seed=SEED)
    return TTSDataLoader(ds, batch_size=B, shuffle=True, drop_last=True, seed=SEED,
                         bucket_chars=32, bucket_frames=128)


def dp_batches(run: dict, B: int, path: Path) -> None:
    """The first ``DP_STEPS`` global batches of ``dp_loader``, saved to ``path``."""
    import torch

    loader = dp_loader(run, B)
    out = []
    while len(out) < DP_STEPS:
        out += list(loader)
    torch.save(out[:DP_STEPS], path)


def dp_steps(rank: int, n: int, spec: dict, starts=None) -> dict:
    """``spec["steps"]`` (``DP_STEPS``) train steps of a seeded model of
    ``spec["cfg"]`` on the card, each on this rank's rows of the next batch
    of ``spec["batches"]``
    (all of them with ``n`` 1: one process, no group), the dropout
    generator seeded alike; K3 / K4 and the encoder's launches counted from
    0. ``starts[i]``, where given, is the state step i starts from (another
    run's after step i - 1: weights, statistics, Adam's state, the
    generator's), so each step is compared from one state. -> per step the
    loss, ``grad_norm``, T, host ms and a digest of the weights and
    statistics, with ``spec["keep"]`` also every gradient and that state
    after the step (host copies)."""
    import copy
    import hashlib

    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.models.layers import Policy, use_f32_math
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron2_tpu_torch.ops import encoder_lstm as el
    from tacotron2_tpu_torch.ops import train_decode as td
    from tacotron2_tpu_torch.parallel import mesh
    from tacotron2_tpu_torch.run.say import model_config_from
    from tacotron2_tpu_torch.training import optimizer, step

    use_f32_math()
    dev = torch.device("cuda")
    cfg = load_config(spec["cfg"])
    torch.manual_seed(SEED)
    model = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision)).to(dev)
    batches = torch.load(spec["batches"], weights_only=False)[:spec.get("steps", DP_STEPS)]
    m_tp = spec.get("model_parallel", 1)
    dp = None
    if torch.distributed.is_initialized():
        mesh.broadcast_state(model, mesh.DataParallel(rank, n))  # over every rank
        dp = (mesh.make_data_parallel(int(batches[0]["mel"].shape[0]), m_tp) if m_tp > 1
              else mesh.DataParallel(rank, n))
    if m_tp > 1:  # tensor parallel: this rank's slices, and their Adam moments only
        mesh.shard_parameters(model, dp)
    split = getattr(model, "tp_split", {})
    opt, sched = optimizer.make_optimizer(model.parameters(), cfg.training.lr,
                                          cfg.training.weight_decay)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    init = mesh.gather_state_dict(model, dp) if spec.get("keep") or split else None
    init = _host(init) if spec.get("keep") else None  # a gather: every model rank calls it
    td.reset_launches()
    el.reset_launches()
    out = []
    digest = lambda sd: hashlib.sha1(b"".join(
        v.reshape(-1).view(torch.uint8).numpy().tobytes() for v in sd.values())).hexdigest()
    with torch.enable_grad():
        for i, b in enumerate(batches):
            if starts and starts[i] is not None:
                model.load_state_dict(starts[i]["model"])
                # a copy: Adam keeps a loaded host tensor (its step count)
                # and counts on in it
                opt.load_state_dict(copy.deepcopy(starts[i]["opt"]))
                gen.set_state(starts[i]["gen"])
            rows = mesh.shard_rows(b, dp.rank, dp.n) if dp is not None else b
            t0 = time.perf_counter()
            m = step.train_step(model, opt, sched, step.to_device(rows, dev), gen, dp=dp)
            torch.cuda.synchronize()
            rec = {"ms": (time.perf_counter() - t0) * 1e3, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]), "T": int(b["mel"].shape[1]),
                   "rows": int(rows["mel"].shape[0])}
            state = _host(mesh.gather_state_dict(model, dp))
            rec["digest"] = digest(state)
            if split:  # the replicated weights and statistics as this rank holds them
                rec["replicated_digest"] = digest(_host({k: v for k, v in model.state_dict().items()
                                                         if k not in split}))
            if spec.get("keep") or split:  # a gather: every rank of a model group calls it
                opt_sd = mesh.gather_optimizer_state(opt, model, dp)
                grads = {k: mesh.gather_units(p.grad, split[k], dp.model) if k in split
                         else p.grad for k, p in model.named_parameters()}
            if spec.get("keep"):
                rec["state"] = {"model": state, "gen": gen.get_state(), "opt": _host(opt_sd)}
                rec["grads"] = {k: g.detach().float().cpu() for k, g in grads.items()}
            out.append(rec)
    return {"steps": out, "init": init, "launches": dict(td.LAUNCHES),
            "ctl": dict(td.CONTROLS_LAUNCHES), "enc": dict(el.LAUNCHES),
            "place": None if dp is None else [dp.rank, dp.n, dp.model and dp.model.rank]}


def _host(x):
    """A copy of a state tree with every tensor on the host."""
    import copy

    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return copy.deepcopy(x)


def _dp_rank(rank: int, n: int, store: str, spec: dict, out: str) -> None:
    """A spawned rank of (a): gloo over ``file://store``, ``dp_steps``,
    its result saved to ``out``; with ``spec["defect_after"]`` then one step
    from the seed's state with the planted defect, saved to ``out`` +
    ".defect" (the same processes: no second spawn)."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    from tacotron2_tpu_torch.parallel import mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))  # the ranks share the host

    mesh.init_data_parallel("gloo", f"file://{store}", rank, n)
    torch.backends.cudnn.deterministic = True  # a reading the next run repeats
    timed = _time_tp_decode() if spec.get("model_parallel", 1) > 1 else None
    res = dp_steps(rank, n, {**spec, "keep": rank == 0})
    if timed is not None:
        res["tp_decode_ms"] = timed
    if spec.get("defect_after"):
        _plant_local_bn_grad(mesh)
        torch.save(dp_steps(rank, n, {**spec, "steps": 1, "keep": rank == 0}), out + ".defect")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    torch.save(res, out)


def _time_tp_decode() -> dict:
    """Host ms of each call of the column-parallel decode's forward and
    backward (``ops/train_scan.py``), each between two syncs of the card:
    -> {"forward": [...], "backward": [...]}, filled as the steps run."""
    import torch

    from tacotron2_tpu_torch.ops import train_scan

    times: dict = {"forward": [], "backward": []}
    for key, name in (("forward", "teacher_forward_tp"), ("backward", "teacher_backward_tp")):
        def timed(*a, _fn=getattr(train_scan, name), _key=key, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _fn(*a, **k)
            torch.cuda.synchronize()
            times[_key].append((time.perf_counter() - t0) * 1e3)
            return res
        setattr(train_scan, name, timed)
    return times


def _plant_local_bn_grad(mesh) -> None:
    """The planted defect of (a): ``mesh.mean_over_ranks`` (the global
    BatchNorm's and the CCC loss's sums) all-reducing forward only."""
    import torch

    class ForwardOnlySum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            y = x.clone()
            torch.distributed.all_reduce(y, group=group)
            return y

        @staticmethod
        def backward(ctx, g):
            return g, None

    mesh.mean_over_ranks = lambda x: ForwardOnlySum.apply(x, mesh.current().group) / \
        mesh.current().n


def _step_errors(a: dict, ref: dict, start: dict, replay: dict) -> dict:
    """A step ``a`` against a reference's from the same state ``start`` (a
    model state): the relative loss and ``grad_norm``, the worst gradient
    (against its own max), weight and BatchNorm statistic (against max(1,
    max |ref|)), each tensor's gradient's relative L2 distance (``DP_TOL``),
    and ``a``'s weights against ``replay`` (Adam applied to ``start`` with
    ``a``'s gradients), each worst with its tensor's name."""
    w: dict = {"loss": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
               "grad_norm": abs(a["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
               "per_tensor": {}}

    def worst(key, e, k):
        if e > w.get(key, -1.0):
            w[key], w[key + "_at"] = e, k

    diff2 = norm2 = 0.0
    for k, g in ref["grads"].items():
        g = g.double()
        d = a["grads"][k].double() - g
        diff2, norm2 = diff2 + float((d * d).sum()), norm2 + float((g * g).sum())
        # a conv bias that feeds a train-mode BatchNorm has a zero gradient in
        # exact arithmetic (the BN removes it): each side's is rounding noise,
        # read against its conv's weight gradient
        own = ref["grads"][k[:-4] + "weight"].double() if k in BN_FED_BIAS else g
        scale, l2 = float(own.abs().max()), float(own.norm())
        worst("tensor_grads", float(d.abs().max()) / scale if scale > 0 else 0.0, k)
        e = float(d.norm()) / l2 if l2 > 0 else float(d.norm())
        worst("tensor_grads_l2", e, k)
        upd = float((replay[k].double() - start[k].double()).abs().max())
        u = float((a["state"]["model"][k].double() - replay[k].double()).abs().max())
        worst("adam", u / upd if upd > 0 else u, k)
        w["per_tensor"][k] = {"grad_l2": e, "adam": u / upd if upd > 0 else u}
    w["grads"] = (diff2 / norm2) ** 0.5
    for k, v in ref["state"]["model"].items():
        if v.is_floating_point():
            worst("bn" if "running" in k else "weights", err(a["state"]["model"][k], v)[1], k)
    return w


def _adam_replay(model, cfg, start: dict, opt_state, grads: dict) -> dict:
    """Adam of ``train_step`` applied once to the model state ``start``
    (``opt_state`` None: a fresh optimizer) with the (clipped) ``grads``,
    on ``model``'s device: -> the parameters after it (host copies)."""
    import copy

    from tacotron2_tpu_torch.training import optimizer

    model.load_state_dict(start)
    opt, _ = optimizer.make_optimizer(model.parameters(), cfg.training.lr,
                                      cfg.training.weight_decay)
    if opt_state is not None:
        opt.load_state_dict(copy.deepcopy(opt_state))  # as in dp_steps
    for k, p in model.named_parameters():
        p.grad = grads[k].to(p.device)
    opt.step()
    return {k: p.detach().cpu().clone() for k, p in model.named_parameters()}


def _spawn_ranks(d: Path, spec: dict, prefix: str, n: int = DP_RANKS) -> list:
    """``n`` spawned ``_dp_rank`` processes over ``spec`` in a store of
    their own under ``d``: -> their results."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, n, str(d / f"{prefix}store"), spec,
                                                str(d / f"{prefix}rank{r}.pt")))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise SmokeFailure(f"{d.name} {prefix}: the ranks exited {[p.exitcode for p in procs]}")
    return [torch.load(d / f"{prefix}rank{r}.pt", weights_only=False) for r in range(n)]


def dp_compare(run: dict, B: int, tag: str, log: dict, card: str) -> dict:
    """(a) at batch ``B``: ``DP_RANKS`` spawned ranks of ``B / DP_RANKS``
    rows, then one process at ``B`` on the same batches, each step from
    rank 0's state before it, in a one-rank group (the same global-batch
    code: only the sums' split differs) and without a group (cuDNN's
    BatchNorm), each held to ``DP_TOL`` (each tensor's worst gradient
    element reported: see there). The ranks' weights and statistics the same
    bits; each rank's K3 / K4 launches ``2 + 3T`` / ``4 + 4T`` a step
    (controls mode where the config has controls), one ``bilstm_backward``.
    At the vanilla batch, one step of ranks with the planted defect
    (``_plant_local_bn_grad``) must read above ``DP_TOL``."""
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron2_tpu_torch.ops import train_decode as td
    from tacotron2_tpu_torch.parallel import mesh
    from tacotron2_tpu_torch.run.say import model_config_from

    d = run["root"] / f"dp_{tag}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    spec = {"cfg": str(run["cfg"]), "batches": str(d / "batches.pt")}
    dp_batches(run, B, d / "batches.pt")
    ranks = _spawn_ranks(d, {**spec, "defect_after": tag == "vanilla"}, "")
    starts = [None] + [s["state"] for s in ranks[0]["steps"][:-1]]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the ranks'
    mesh.init_data_parallel("gloo", f"file://{d / 'store1'}", 0, 1)
    try:
        one_rank = dp_steps(0, 1, {**spec, "keep": True}, starts)
    finally:
        torch.distributed.destroy_process_group()
    try:
        plain = dp_steps(0, 1, {**spec, "keep": True}, starts)
    finally:
        torch.backends.cudnn.deterministic = det
    cfg = load_config(spec["cfg"])
    model = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision)).cuda()

    def errors(got, ref, i, start_opt):
        start = starts[i]["model"] if i else ref["init"]
        return _step_errors(got, ref["steps"][i], start,
                            _adam_replay(model, cfg, start, start_opt, got["grads"]))

    # "both_one_process": the two one-process steps against each other (no
    # data parallel, only the BatchNorm's implementation differs): reported
    refs = {"one_rank": [], "no_group": [], "both_one_process": []}
    shown = (*DP_TOL, "tensor_grads")
    for i, a in enumerate(ranks[0]["steps"]):
        if any(r["steps"][i]["digest"] != a["digest"] for r in ranks[1:]):
            raise SmokeFailure(f"4j {tag}: the ranks' weights differ after step {i + 1}")
        for name, got, ref in (("one_rank", a, one_rank), ("no_group", a, plain),
                               ("both_one_process", one_rank["steps"][i], plain)):
            w = errors(got, ref, i, starts[i]["opt"] if i else None)
            refs[name].append(w)
            label = ("one process, one rank against no group" if name == "both_one_process"
                     else f"against one process, {name.replace('_', ' ')}")
            print(f"    step {i + 1} {label}: " + ", ".join(
                f"{k} {w[k]:.2e}" + (f" ({w[k + '_at']})" if k + "_at" in w else "")
                for k in shown))
    worst = {name: {k: max(w[k] for w in ws) for k in shown} for name, ws in refs.items()}
    bad = {f"{name} {k}": v for name, ws in worst.items() for k, v in ws.items()
           if name != "both_one_process" and k in DP_TOL and not v <= DP_TOL[k]}
    if tag == "vanilla":  # the planted defect, one step against one process
        defect = [torch.load(d / f"rank{r}.pt.defect", weights_only=False)
                  for r in range(DP_RANKS)]
        w = errors(defect[0]["steps"][0], plain, 0, None)
        seen = {k: w[k] for k in DP_TOL if not w[k] <= DP_TOL[k]}
        log.setdefault("dp", {})["defect"] = {
            "readings": w, "flagged": seen,
            "ranks_equal": defect[0]["steps"][0]["digest"] == defect[1]["steps"][0]["digest"]}
        print(f"    planted defect (the BatchNorm sums' gradients left local), step 1 against "
              f"one process: " + ", ".join(
                  f"{k} {w[k]:.2e}" + (f" ({w[k + '_at']})" if k + "_at" in w else "")
                  for k in shown)
              + f"; above DP_TOL: {sorted(seen)}; the ranks' weights equal "
              f"{log['dp']['defect']['ranks_equal']}")
        if not seen:
            bad["planted defect passes"] = w["tensor_grads_l2"]
    counted = "ctl" if "[controls]" in tag else "launches"
    want = {"teacher_forward": sum(td.forward_launches(s["T"]) for s in plain["steps"]),
            "teacher_backward": sum(td.backward_launches(s["T"]) for s in plain["steps"])}
    for r, res in enumerate(ranks):
        if res[counted] != want or res["enc"]["bilstm_backward"] != DP_STEPS \
                or res["enc"]["bilstm_forward"] < DP_STEPS:
            raise SmokeFailure(f"4j {tag}: rank {r} launched K3/K4 {res[counted]} (want {want}), "
                               f"the encoder {res['enc']}")
    rows = {s["rows"] for res in ranks for s in res["steps"]}
    out = {"B": B, "ranks": DP_RANKS, "rows_per_rank": sorted(rows), "worst": worst,
           "per_step": refs,
           "tol": DP_TOL, "launches_per_rank": ranks[0][counted],
           "losses": [s["loss"] for s in ranks[0]["steps"]],
           "one_process_losses": [s["loss"] for s in plain["steps"]],
           "rank_ms": [s["ms"] for s in ranks[0]["steps"]],
           "one_process_ms": [s["ms"] for s in plain["steps"]], "card": card}
    print(f"  {tag}: {DP_RANKS} ranks x {sorted(rows)} rows (gloo, one card) against one process "
          f"at B={B}, worst over {DP_STEPS} steps: "
          + "; ".join(f"{name.replace('_', ' ')}: " + ", ".join(
              f"{k} {v:.2e} (tol {DP_TOL.get(k, 'reported')})" for k, v in ws.items())
              for name, ws in worst.items())
          + f"; each rank's K3/K4 launches {ranks[0][counted]}; the ranks' weights equal bit "
          f"for bit; step ms on the host clock, 2 ranks sharing one card (not data-parallel "
          f"throughput) {[round(x, 1) for x in out['rank_ms']]}, one process "
          f"{[round(x, 1) for x in out['one_process_ms']]}, on {card}")
    log.setdefault("dp", {})[tag] = out
    if bad:  # the rest of the phase runs; the run fails at its end
        log.setdefault("deferred", []).append(
            f"4j {tag}: a data-parallel step differs from one process's: {bad}")
    return out


def dp_cli(run: dict, tag: str, env: dict) -> dict:
    """``train`` through the CLI entry in this process for ``DP_RUN_STEPS``
    steps on ``run``'s corpus with ``env`` set around it (torchrun's
    variables, ``TACOTRON2_DEVICE_PREFETCH``)."""
    import os

    from tacotron2_tpu_torch.__main__ import main as cli

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return cli(["train", "--config", str(run["cfg"]), "--speech-dir", str(run["speech"]),
                    "--results-dir", str(run["root"] / f"dp_{tag}"), "--seed", str(SEED),
                    "--max-steps", str(DP_RUN_STEPS)])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_phase(van: dict, ctl: dict, log: dict, card: str) -> tuple:
    """Phase 4j. (a) ``dp_compare`` of the vanilla config at B=32 and the
    controllable one at B=64; (b) ``train`` as one NCCL rank under
    torchrun's environment against the same run without a process group;
    (c) the batches the prefetcher stages (rank 1's rows of 2) against
    ``DirectStream``'s, bit for bit, then ``train`` with
    ``TACOTRON2_DEVICE_PREFETCH`` 0 and 1: the same losses bit for bit,
    their step and batch-wait ms. Every run here takes cuDNN's
    deterministic algorithms, so that two runs can be equal and (a)'s
    readings repeat from run to run. K3 / K4 at
    the ranks' shapes (16 and 32 rows) against their plain versions, timed.
    -> (the launches of (b)'s run, which drives the main path: {kernels-line
    row: launches}, K3 / K4's readings at the ranks' shapes)"""
    import os
    import socket

    import numpy as np
    import torch

    from tacotron2_tpu_torch.ops import encoder_lstm as el
    from tacotron2_tpu_torch.ops import train_decode as td

    print(f"  (a) {DP_RANKS} gloo ranks on the one card: each rank's rows through K3 / K4 and "
          "the encoder's kernels; no number here is from two cards")
    lap = step_timer(log.setdefault("dp", {}), "4j", card)
    dp_compare(van, TRAIN_B, "vanilla", log, card)
    lap("(a) vanilla")
    dp_compare(ctl, CTL_TRAIN_B, "[controls]", log, card)
    lap("(a) controls")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torchrun = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(port), "TACOTRON2_DEVICE_PREFETCH": ""}
    staged_equal = dp_staging(van)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        td.reset_launches()
        el.reset_launches()
        nccl = dp_cli(van, "nccl", torchrun)
        launches = {**td.LAUNCHES, **el.LAUNCHES}
        lap("(b) staging, one NCCL rank")
        runs = {k: dp_cli(van, f"prefetch_{k}", {"TACOTRON2_DEVICE_PREFETCH": v})
                for k, v in (("off", "0"), ("on", "1"))}
        lap("(c) prefetch off and on")
    finally:
        torch.backends.cudnn.deterministic = det
    losses = {k: [s["loss"] for s in r["steps"]] for k, r in (("nccl", nccl), *runs.items())}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["nccl"], losses["off"]))
    steady = {k: {"step_ms": float(np.median([s["s"] * 1e3 for s in r["steps"][1:]])),
                  "wait_ms": float(np.median([s["wait_s"] * 1e3 for s in r["steps"][1:]])),
                  "step_and_wait_mean_ms": float(np.mean([(s["s"] + s["wait_s"]) * 1e3
                                                          for s in r["steps"][1:]])),
                  "steps_ms": [s["s"] * 1e3 for s in r["steps"]],
                  "waits_ms": [s["wait_s"] * 1e3 for s in r["steps"]],
                  "prefetch": r["prefetch"]} for k, r in runs.items()}
    res = {"nccl_ranks": nccl["ranks"], "nccl_vs_no_group_loss_rel": rel,
           "nccl_bit_equal": losses["nccl"] == losses["off"], "losses": losses,
           "staged_bit_equal": staged_equal, "prefetch": steady, "cores": os.cpu_count(),
           "card": card}
    log.setdefault("dp", {}).update(res)
    print(f"  (b) train as one NCCL rank under torchrun's environment against no process group, "
          f"{DP_RUN_STEPS} steps at B={TRAIN_B}: losses within {rel:.2e} relative (tol "
          f"{DP_TOL['loss']:g}), bit-equal {res['nccl_bit_equal']}; launches {launches}")
    print(f"  (c) staged batches bit-equal to DirectStream's {staged_equal}; "
          f"TACOTRON2_DEVICE_PREFETCH=0 / 1: losses bit-equal "
          f"{losses['on'] == losses['off']}; " + "; ".join(
              f"{k}: steady step {v['step_ms']:.1f} ms, batch wait {v['wait_ms']:.2f} ms, step + "
              f"wait {v['step_and_wait_mean_ms']:.1f} ms a step on average (steps "
              f"{[round(x, 1) for x in v['steps_ms']]}, waits {[round(x, 2) for x in v['waits_ms']]})"
              for k, v in steady.items()) + f", on a host of {os.cpu_count()} cores, {card}")
    if nccl["ranks"] != 1 or not rel <= DP_TOL["loss"] or 0 in launches.values():
        raise SmokeFailure(f"4j (b): {res}")
    if not staged_equal or losses["on"] != losses["off"] \
            or [r["prefetch"] for r in runs.values()] != [False, True]:
        raise SmokeFailure(f"4j (c): the prefetched run differs: {res}")
    readings = {}
    for run, B, mode in ((van, TRAIN_B // DP_RANKS, ""),
                         (ctl, CTL_TRAIN_B // DP_RANKS, "[controls]")):
        kern = train_split(str(run["cfg"]), run["ckpt"], run["speech"], run["root"], B, log,
                           mode, f"@dp{B}", readings=True, split=False)["kernels"]
        readings.update({k: {f"B{B}": v} for k, v in kern.items()})
    lap("K3 / K4 at the ranks' shapes")
    return launches, readings


def dp_staging(run: dict, n: int = 4) -> bool:
    """The first ``n`` batches of ``DevicePrefetcher`` and of ``DirectStream``
    over ``dp_loader(run, TRAIN_B)``, rank 1's rows of 2 each, on the card:
    -> whether they are equal bit for bit."""
    import torch

    from tacotron2_tpu_torch.parallel import mesh
    from tacotron2_tpu_torch.parallel.prefetch import DevicePrefetcher, DirectStream

    select = lambda b: mesh.shard_rows(b, 1, 2)
    got = []
    dev = torch.device("cuda")
    for stream in (DevicePrefetcher(dp_loader(run, TRAIN_B), dev, 2, select),
                   DirectStream(dp_loader(run, TRAIN_B), dev, select)):
        batches = []
        for device_batch, _ in stream:
            batches.append({k: v.cpu() for k, v in device_batch.items()})
            if len(batches) == n:
                break
        stream.close()
        got.append(batches)
    return all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(*got))


def dp_mode() -> int:
    """``--dp``: the kernels' build and phase 4j alone, on random full-width
    checkpoints and 4b's and 4e's synthetic corpora; details to
    ``chiprun_out/dp.json``."""
    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build

    card = card_line()
    print(f"[4j] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    t0 = time.perf_counter()
    build.build_all()
    log: dict = {"card": card, "build_s": time.perf_counter() - t0}
    readings = {}
    try:
        WORK.mkdir(parents=True, exist_ok=True)
        van = _extras_source("train", ROOT / "config" / "vanilla-ljspeech-stop.json",
                             TRAIN_WAVS, False)
        ctl = _extras_source("train_controls", ROOT / "config" / CTL_CONFIG, CTL_TRAIN_WAVS, True)
        _, readings = dp_phase(van, ctl, log, card)
        if log.get("deferred"):
            raise SmokeFailure("; ".join(log["deferred"]))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        log["seconds"] = time.perf_counter() - t0
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "dp.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"readings": readings}, default=str))
    print(card)
    return 0


K4_REF_SEEDS = 12  # --k4-ref: seeds of the masks and cotangents a weight state and batch


def k4_ref_mode() -> int:
    """``--k4-ref``: the kernels' build, then 4b's ``train`` (6 steps,
    resumed to 8) on 4b's synthetic corpus. On the weights at steps 6 and 8,
    the first 16 and 32 rows, K4_REF_SEEDS seeds each, on the plain
    forward's residuals and on K3's: K4 and the plain backward in f32 sums
    each against ``teacher_backward_ref`` (the same in f64 sums), and K4
    against the plain f32 one (the former reference): each output's largest
    reading, how many of dq's exceed its former 5e-3 and its limit,
    and dq over the first 16 steps pulled, before the flips carry back.
    Fails if a K4 reading exceeds K4_TOL; details to
    ``chiprun_out/k4_ref.json``."""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build
    from tacotron2_tpu_torch.ops import train_decode as td

    card = card_line()
    print(f"[k4-ref] on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    build.build_all()
    WORK.mkdir(parents=True, exist_ok=True)
    root = WORK / "train"
    speech = _synth_corpus(root, TRAIN_WAVS)
    rows = ["text|wav"] + [f"{TRAIN_TEXTS[i % len(TRAIN_TEXTS)]}|s{i:03d}.wav"
                           for i in range(TRAIN_WAVS)]
    raw = json.loads((ROOT / "config" / "vanilla-ljspeech-stop.json").read_text())
    cfg_train, first, second, *_ = train_run(root, raw, rows, 32, speech)
    rel = lambda a, b: float((a.double() - b.double()).abs().max() / b.double().abs().max())
    draws = []
    try:
        for step, ckpt in ((6, first["checkpoint"]), (8, second["checkpoint"])):
            for B in (16, 32):
                for seed in range(SEED, SEED + K4_REF_SEEDS):
                    x = train_inputs(cfg_train, ckpt, speech, root, B, seed)
                    fwd = (x["w"], *x["fwd"], None)
                    res = {"plain": td.teacher_forward_plain(*fwd)[1],
                           "K3": td.teacher_forward(*fwd)[1]}
                    for on, r in res.items():
                        args = (x["w"], r, *x["fwd"][1:], x["d_mg"], x["d_al"])
                        k, p, ref = (td.teacher_backward(*args), td.teacher_backward_plain(*args),
                                     teacher_backward_ref(*args))
                        m = float(ref.dq.abs().max())
                        head = lambda o: float((o.dq[-16:] - ref.dq[-16:]).abs().max()) / m
                        draws.append({"step": step, "B": B, "seed": seed, "on": on,
                                      "k_ref": {f: rel(getattr(k, f), getattr(ref, f))
                                                for f in td.BackwardOut._fields
                                                if getattr(ref, f).numel()},
                                      "plain_ref": {f: rel(getattr(p, f), getattr(ref, f))
                                                    for f in td.BackwardOut._fields
                                                    if getattr(ref, f).numel()},
                                      "k_plain_dq": rel(k.dq, p.dq),
                                      "dq_first16": {"k_ref": head(k), "plain_ref": head(p)}})
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    fields = list(draws[0]["k_ref"])
    worst = {f: {w: max(d[w][f] for d in draws) for w in ("k_ref", "plain_ref")}
             for f in fields}
    dq = {w: np.array([d[w]["dq"] for d in draws]) for w in ("k_ref", "plain_ref")}
    dq["k_plain"] = np.array([d["k_plain_dq"] for d in draws])
    summary = {"draws": len(draws), "worst": worst,
               "dq": {w: {"median": float(np.median(v)), "p99": float(np.percentile(v, 99)),
                          "max": float(v.max()), "above_5e-3": int((v > 5e-3).sum()),
                          "above_limit": int((v > K4_TOL["dq"]).sum())} for w, v in dq.items()},
               "dq_first16_max": {w: max(d["dq_first16"][w] for d in draws)
                                  for w in ("k_ref", "plain_ref")},
               "card": card}
    for f in fields:
        print(f"  {f:<9} K4 vs the f64-sum reference {worst[f]['k_ref']:.3e}, the plain f32 "
              f"version vs it {worst[f]['plain_ref']:.3e} (limit {K4_TOL[f]:g})")
    for w, v in summary["dq"].items():
        print(f"  dq {w}: median {v['median']:.3e}, p99 {v['p99']:.3e}, max {v['max']:.3e}, "
              f"above 5e-3 {v['above_5e-3']}, above {K4_TOL['dq']:g} {v['above_limit']} of "
              f"{len(draws)}")
    print(f"  dq over the first 16 steps pulled: {summary['dq_first16_max']}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "k4_ref.json").write_text(json.dumps({"summary": summary, "draws": draws},
                                                    indent=1))
    print(json.dumps(summary))
    print(card)
    if any(worst[f]["k_ref"] > K4_TOL[f] for f in fields):
        print(f"FAIL: a K4 reading above K4_TOL: {worst}", file=sys.stderr)
        return 1
    return 0


MESH_SHARDS = ("cuda:0", "cuda:0")  # 4k (a): two shards on the one card (no two-card number)
MESH_WAVE = 16  # 4k (a): concurrent requests a wave, one wave bf16 and one int8
MESH_LSB = 0  # 4k (a): a sharded request against the meshless server's alone, PCM16 LSB
TP_GRID = (2, 2)  # 4k (b): data x model gloo ranks sharing the one card
TP_STEPS = 2
# 4k (b)'s limits: DP_TOL, 4j's. A grid step is held against the
# one-process K3 / K4 step in a one-rank group, whose train-mode BatchNorm
# is the same two-pass global code as the grid's data group: the reading then
# sees the column-parallel decode (stock ops against K3 / K4) and the split,
# not cuDNN's BatchNorm against the two-pass sums, which alone reads up to
# 1.45e-2 of a tensor's max between two one-process steps (4j, PERF.md). Against
# the one-process step without a group the readings are reported.
MEL_CLIP_S = 10.0  # 4k (c): the clip's seconds
MEL_TOL = 5e-3  # 4k (c): log-mel, card against the numpy backend (tests/test_audio.py's)


def mesh_serve_part(cfg_path: str, ckpt: str, g_path: str, log: dict, card: str) -> dict:
    """4k (a): the warm server with ``mesh: {"data": 2}`` on ``MESH_SHARDS``
    (a bf16 and an int8 entry of the random full-width checkpoint ``ckpt``,
    gate forced positive, ``max_len`` 256, warm-up on each shard) beside a
    meshless server of the same entries: one wave of ``MESH_WAVE``
    concurrent requests to each entry, the launch counters set to 0 before
    each wave and read after, attributed to the shards by the thread that
    launched; each shard's K1 (K5) two cell launches a decode step and K2
    one vocode a decode; every request's WAV against the meshless server's
    same request alone (``MESH_LSB``); each window's host ms; then a ``{"data":
    2}`` config without the explicit list, which must raise on a one-card
    machine. -> the waves' launches."""
    import concurrent.futures
    import os
    import threading

    import numpy as np
    import torch

    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.ops import build, decoder_loop, encoder_lstm, mrf
    from tacotron2_tpu_torch.run import server as srv

    root = WORK / "mesh_serve"
    root.mkdir(parents=True, exist_ok=True)
    entry = {"config": cfg_path, "checkpoint": ckpt, "hifi_gan_checkpoint": g_path,
             "max_len": 256, "multi_speaker": False, "controllable": False, "num_voices": 1}
    models = [dict(entry, name="vanilla-bf16"), dict(entry, name="vanilla-int8",
                                                     quantize_int8=True)]
    batching = {"enabled": True, "window_ms": 8, "max_batch": 64, "depth": 2}
    cwd = os.getcwd()
    os.chdir(root)
    servers = []
    lock, tls = threading.Lock(), threading.local()
    per_shard = [{} for _ in MESH_SHARDS]
    windows = []
    orig = (build.count, srv._shard_rows, srv.synthesize_batch)

    def count(table, name, n=1):
        orig[0](table, name, n)
        s = getattr(tls, "shard", None)
        if s is not None:
            with lock:
                per_shard[s][name] = per_shard[s].get(name, 0) + n

    def shard_rows(shard, *a, **k):
        tls.shard = index.get(id(shard))  # None: the meshless server's bundle
        try:
            return orig[1](shard, *a, **k)
        finally:
            tls.shard = None

    def synthesize(bundle, reqs, *a, **k):
        t0 = time.perf_counter()
        out = orig[2](bundle, reqs, *a, **k)
        if bundle.shards:
            windows.append({"int8": bool(bundle.packed.quantized), "rows": len(reqs),
                            "ms": (time.perf_counter() - t0) * 1e3})
        return out

    try:
        def start(config, shards=None):
            httpd = srv.make_server(config, "warm", host="127.0.0.1", port=0,
                                    shard_devices=shards)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            servers.append(httpd)
            return httpd

        mesh_h = start({"models": models, "batching": batching, "mesh": {"data": 2},
                        "warmup": True}, list(MESH_SHARDS))
        solo_h = start({"models": models, "batching": batching, "warmup": True})
        reg = mesh_h.app.registry
        index = {id(sh): i for m in (0, 1) for i, sh in enumerate(reg.load(m).shards)}
        build.count, srv._shard_rows, srv.synthesize_batch = count, shard_rows, synthesize
        port = mesh_h.server_address[1]
        waves, launches, per = {}, {}, {}
        for model, key in ((0, "bf16"), (1, "int8")):
            payloads = [{"text": TRAIN_TEXTS[i % len(TRAIN_TEXTS)], "model": model,
                         "seed": 300 + i} for i in range(MESH_WAVE)]
            barrier = threading.Barrier(MESH_WAVE)

            def one(p):
                barrier.wait()
                return _post(port, p)

            decoder_loop.reset_launches()
            mrf.reset_launches()
            encoder_lstm.reset_launches()
            for d in per_shard:
                d.clear()
            counts0 = [list(c) for c in reg.shard_counts]
            calls0 = srv.BATCH_CALLS[0]
            n_windows = len(windows)
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(MESH_WAVE) as ex:
                replies = list(ex.map(one, payloads))
            wall = time.perf_counter() - t0
            n_calls = srv.BATCH_CALLS[0] - calls0
            if any(st != 200 for st, _, _ in replies):
                raise SmokeFailure(f"4k (a) {key} wave: {[(st, b) for st, b, _ in replies][:2]}")
            wave_launches = {**decoder_loop.LAUNCHES, **mrf.LAUNCHES, **mrf.F32_LAUNCHES,
                             "bilstm_forward": encoder_lstm.LAUNCHES["bilstm_forward"]}
            for k, v in wave_launches.items():
                launches[k] = launches.get(k, 0) + v
            counts = [[a - b for a, b in zip(c, c0)] for c, c0 in zip(reg.shard_counts, counts0)]
            cell = "lstm_cell_int8" if model else "lstm_cell"
            per[key] = [{"decodes": c[0], "rows": c[1], "steps": c[2], "launches": dict(l)}
                        for c, l in zip(counts, per_shard)]
            for s, x in enumerate(per[key]):
                want = {cell: 2 * x["steps"], **({"quantize_xh": 2 * x["steps"]} if model else {})}
                got = {k: x["launches"].get(k, 0) for k in want}
                if got != want or x["decodes"] < 1:
                    raise SmokeFailure(f"4k (a) {key}: shard {s} launched {got}, want {want} "
                                       f"({x})")
                check_vocode_launches({k: x["launches"].get(k, 0) for k in k2_launch_keys()},
                                      x["decodes"], f"4k (a) {key} shard {s}")
            if wave_launches[cell] != sum(2 * x["steps"] for x in per[key]):
                raise SmokeFailure(f"4k (a) {key}: launches {wave_launches} outside the shards")
            # each request against the meshless server's same request alone
            lsb = []
            for p, (_, body, _) in zip(payloads, replies):
                st, solo, _ = _post(solo_h.server_address[1], p)
                a = read_wav(str(root / body["path"]))[0]
                b = read_wav(str(root / solo["path"]))[0]
                if st != 200 or len(a) != len(b):
                    raise SmokeFailure(f"4k (a) {key}: alone {st}, {len(b)} samples against "
                                       f"{len(a)}")
                lsb.append(float(np.abs(np.round(a * 32768) - np.round(b * 32768)).max()))
            lat = np.array([sec for _, _, sec in replies])
            waves[key] = {"requests": MESH_WAVE, "windows": n_calls,
                          "window_ms": [w["ms"] for w in windows[n_windows:]],
                          "window_rows": [w["rows"] for w in windows[n_windows:]],
                          "wall_s": wall, "p50_s": float(np.percentile(lat, 50)),
                          "max_lsb_against_alone": max(lsb), "per_shard": per[key]}
            print(f"  {key} wave of {MESH_WAVE}: {waves[key]['windows']} window(s) of "
                  f"{waves[key]['window_rows']} rows in "
                  f"{[round(x, 1) for x in waves[key]['window_ms']]} ms (host clock, two shards "
                  f"on one card); per shard "
                  + "; ".join(f"{s}: {x['decodes']} decodes, {x['rows']} rows, {x['steps']} steps, "
                              f"{cell} {x['launches'].get(cell, 0)}"
                              + (f", quantize_xh {x['launches'].get('quantize_xh', 0)}"
                                 if model else "")
                              + f", K2 mrf_conv_f32 {x['launches'].get('mrf_conv_f32', 0)} / "
                              f"mrf_pair_f32 {x['launches'].get('mrf_pair_f32', 0)}"
                              for s, x in enumerate(per[key]))
                  + f"; every request against the meshless server alone: max {max(lsb):g} PCM16 "
                  f"LSB (limit {MESH_LSB}); on {card}")
            if not max(lsb) <= MESH_LSB:
                log.setdefault("deferred", []).append(
                    f"4k (a) {key}: a sharded request differs from alone by {max(lsb)} LSB")
        stats = mesh_h.app.stats()
        if stats["mesh_devices"] != len(MESH_SHARDS):
            raise SmokeFailure(f"4k (a): /stats reports mesh_devices {stats['mesh_devices']}")
    finally:
        build.count, srv._shard_rows, srv.synthesize_batch = orig
        for h in servers:
            h.shutdown()
            h.app.close(wait=True)
            h.server_close()
        os.chdir(cwd)
    have = torch.cuda.device_count()
    try:
        srv.App({"models": models, "mesh": {"data": 2}})
        refusal = None
    except ValueError as e:
        refusal = str(e)
    print(f"  a {{'data': 2}} config without the list on {have} card(s): "
          f"{refusal or 'accepted'}")
    if (have < 2) != (refusal is not None) or \
            (refusal and f"server mesh wants data=2 devices, only {have} available" != refusal):
        raise SmokeFailure(f"4k (a): the mesh without the list on {have} card(s): {refusal}")
    log.setdefault("mesh", {})["serve"] = {"waves": waves, "stats": stats, "refusal": refusal,
                                          "shards": list(MESH_SHARDS), "card": card}
    return launches


def tp_compare(run: dict, log: dict, card: str) -> dict:
    """4k (b): ``TP_STEPS`` steps of ``run``'s config at B=``TRAIN_B`` on a
    ``TP_GRID`` grid of spawned gloo ranks sharing the card (``dp_steps``
    with ``model_parallel``: each rank its slices, the decode
    column-parallel on stock ops, no K3 / K4), each step against one
    process's K3 / K4 step from the grid's state before it (rank 0's,
    gathered): in a one-rank group, held to ``DP_TOL``, and without a
    group, reported. The replicated weights the same bits across each model
    group, the gathered state across every rank; each rank's encoder kernels
    once a step; the column-parallel decode's host ms a step."""
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron2_tpu_torch.parallel import mesh
    from tacotron2_tpu_torch.run.say import model_config_from

    d = run["root"] / "tp"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    dp_batches(run, TRAIN_B, d / "batches.pt")
    spec = {"cfg": str(run["cfg"]), "batches": str(d / "batches.pt"), "steps": TP_STEPS}
    n = TP_GRID[0] * TP_GRID[1]
    ranks = _spawn_ranks(d, {**spec, "model_parallel": TP_GRID[1]}, "", n)
    starts = [None] + [st["state"] for st in ranks[0]["steps"][:-1]]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the ranks'
    try:
        mesh.init_data_parallel("gloo", f"file://{d / 'store1'}", 0, 1)
        try:
            one_rank = dp_steps(0, 1, {**spec, "keep": True}, starts)
        finally:
            torch.distributed.destroy_process_group()
        plain = dp_steps(0, 1, {**spec, "keep": True}, starts)
    finally:
        torch.backends.cudnn.deterministic = det
    cfg = load_config(spec["cfg"])
    model = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision)).cuda()
    shown = (*DP_TOL, "tensor_grads")
    refs, bad = {"one_rank": [], "no_group": []}, {}
    groups = [list(range(i * TP_GRID[1], (i + 1) * TP_GRID[1])) for i in range(TP_GRID[0])]
    equal = []
    for i, a in enumerate(ranks[0]["steps"]):
        eq = {"replicated_in_model_groups": all(
                  len({ranks[r]["steps"][i]["replicated_digest"] for r in g}) == 1 for g in groups),
              "gathered_on_every_rank": len({r["steps"][i]["digest"] for r in ranks}) == 1}
        equal.append(eq)
        if not all(eq.values()):
            raise SmokeFailure(f"4k (b) step {i + 1}: the ranks' weights part: {eq}")
        start = starts[i]["model"] if i else ranks[0]["init"]
        replay = _adam_replay(model, cfg, start, starts[i]["opt"] if i else None, a["grads"])
        for name, ref in (("one_rank", one_rank), ("no_group", plain)):
            w = _step_errors(a, ref["steps"][i], start, replay)
            refs[name].append(w)
            print(f"    step {i + 1} against one process's K3 / K4 step, "
                  f"{name.replace('_', ' ')}: " + ", ".join(
                      f"{k} {w[k]:.2e}" + (f" ({w[k + '_at']})" if k + "_at" in w else "")
                      for k in shown))
    worst = {name: {k: max(w[k] for w in ws) for k in shown} for name, ws in refs.items()}
    bad = {f"one_rank {k}": v for k, v in worst["one_rank"].items()
           if k in DP_TOL and not v <= DP_TOL[k]}
    for r, res in enumerate(ranks):
        if any(res["launches"].values()) or res["enc"]["bilstm_backward"] != TP_STEPS \
                or res["enc"]["bilstm_forward"] < TP_STEPS:
            raise SmokeFailure(f"4k (b): rank {r} launched K3/K4 {res['launches']} (want none), "
                               f"the encoder {res['enc']}")
    decode = ranks[0].get("tp_decode_ms", {})
    out = {"grid": TP_GRID, "B": TRAIN_B, "rows_per_rank": ranks[0]["steps"][0]["rows"],
           "places": [r["place"] for r in ranks], "worst": worst, "per_step": refs, "tol": DP_TOL,
           "equal": equal, "losses": [st["loss"] for st in ranks[0]["steps"]],
           "grad_norms": [st["grad_norm"] for st in ranks[0]["steps"]],
           "one_process_losses": [st["loss"] for st in plain["steps"]],
           "rank_ms": [[st["ms"] for st in r["steps"]] for r in ranks],
           "one_process_ms": [st["ms"] for st in plain["steps"]],
           "decode_forward_ms": decode.get("forward"), "decode_backward_ms": decode.get("backward"),
           "one_process_launches": plain["launches"], "card": card}
    print(f"  (b) a {TP_GRID[0]} x {TP_GRID[1]} grid (data x model) of gloo ranks, four ranks on "
          f"one card, {out['rows_per_rank']} rows a rank of B={TRAIN_B}: losses "
          f"{[round(x, 5) for x in out['losses']]} (one process "
          f"{[round(x, 5) for x in out['one_process_losses']]}), grad_norm "
          f"{[round(x, 4) for x in out['grad_norms']]}; worst over {TP_STEPS} steps: " + "; ".join(
              f"{name.replace('_', ' ')}: " + ", ".join(
                  f"{k} {v:.2e} (tol {DP_TOL.get(k, 'reported') if name == 'one_rank' else 'reported'})"
                  for k, v in ws.items()) for name, ws in worst.items())
          + f"; the replicated weights bit-equal in each model group {equal}; step ms on the "
          f"host clock, four ranks on one card {[round(x, 1) for x in out['rank_ms'][0]]}, the "
          f"column-parallel decode (stock ops, no kernel) forward "
          f"{[round(x, 1) for x in decode.get('forward', [])]} / backward "
          f"{[round(x, 1) for x in decode.get('backward', [])]} ms, one process's K3 / K4 step "
          f"{[round(x, 1) for x in out['one_process_ms']]} ms; on {card}")
    log.setdefault("mesh", {})["tp"] = out
    if bad:
        log.setdefault("deferred", []).append(
            f"4k (b): a tensor-parallel step differs from one process's: {bad}")
    return out


def mel_device_part(log: dict, card: str) -> dict:
    """4k (c): ``TacotronMelSpectrogram(backend="torch")`` on the card
    against the numpy backend on a ``MEL_CLIP_S`` clip: the largest log-mel
    difference (``MEL_TOL``), ms a clip, the first call and warm (host
    clock, each ending in the copy to the host)."""
    import numpy as np

    from tacotron2_tpu_torch.audio.mel import TacotronMelSpectrogram

    wav = _speechlike(22050, 140.0, MEL_CLIP_S, SEED)
    mel = TacotronMelSpectrogram()
    t0 = time.perf_counter()
    got = mel(wav, backend="torch")
    first = (time.perf_counter() - t0) * 1e3
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        mel(wav, backend="torch")
        warm.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    ref = mel(wav)
    host = (time.perf_counter() - t0) * 1e3
    diff = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
    out = {"frames": int(ref.shape[0]), "max_abs_diff": diff, "first_ms": first,
           "warm_ms": float(np.median(warm)), "numpy_ms": host, "card": card}
    print(f"  (c) log-mel of a {MEL_CLIP_S:g} s clip ({out['frames']} frames): backend='torch' "
          f"on the card against numpy, max |diff| {diff:.2e} (tol {MEL_TOL:g}); first call "
          f"{first:.1f} ms, warm {out['warm_ms']:.2f} ms, numpy {host:.1f} ms (host clock) on "
          f"{card}")
    log.setdefault("mesh", {})["mel"] = out
    if got.dtype != np.float32 or not np.isfinite(got).all() or not diff <= MEL_TOL:
        raise SmokeFailure(f"4k (c): the device log-mel {got.shape} {got.dtype}: {out}")
    return out


def mesh_phase(cfg_path: str, ckpt: str, van: dict, g_path: str, log: dict, card: str) -> dict:
    """Phase 4k: (a) ``mesh_serve_part`` of ``cfg_path`` / ``ckpt`` (gate
    forced positive), (b) ``tp_compare`` on 4b's run ``van``, (c)
    ``mel_device_part``. -> (a)'s launches (the main path's served shards)."""
    print(f"  (a) the server's data mesh on {list(MESH_SHARDS)}: two shards on one card, no "
          "number here is from two cards")
    t0 = time.perf_counter()
    launches = mesh_serve_part(cfg_path, ckpt, g_path, log, card)
    log.setdefault("mesh", {})["serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp_compare(van, log, card)
    log["mesh"]["tp_s"] = time.perf_counter() - t0
    mel_device_part(log, card)
    return launches


def mesh_mode() -> int:
    """``--mesh``: the kernels' build and phase 4k alone, on 4b's config and
    a synthetic corpus with random full-width weights; details to
    ``OUT_DIR / "mesh.json"``."""
    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build

    card = card_line()
    print(f"[4k] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    t0 = time.perf_counter()
    build.build_all()
    log: dict = {"card": card, "build_s": time.perf_counter() - t0}
    try:
        WORK.mkdir(parents=True, exist_ok=True)
        van = _extras_source("train", ROOT / "config" / "vanilla-ljspeech-stop.json",
                             TRAIN_WAVS, False)
        launches = mesh_phase(str(van["cfg"]), van["ckpt"], van, write_hifigan(), log, card)
        print(f"  4k launches: {launches}")
        if log.get("deferred"):
            raise SmokeFailure("; ".join(log["deferred"]))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        log["seconds"] = time.perf_counter() - t0
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "mesh.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"  4k took {log['seconds']:.1f} s")
    print(card)
    return 0


# ---------------------------------------------------------------------------
# phase 4l: HiFi-GAN V2 and V3 on the card (the narrow kernel, ResBlock2)

V2V3 = {"v2": HIFIGAN_V2, "v3": HIFIGAN_V3}
V2V3_SEED = {"v2": SEED + 91, "v3": SEED + 92}  # each generator's random weights
V2V3_ROWS = (1, 16, 64)  # the say's one row and the serve windows' rows
V2V3_INVARIANCE_ROWS = (0, 1, 37, 63)  # rows of a 64-row vocode held against the rows alone
V2V3_WAVE = 16  # the V2 server's wave of concurrent requests
V2V3_FRAMES = 256  # the forced decode of the say and the served requests
V2V3_SERVE_LSB = 0  # a request of the wave against the same request alone, PCM16 LSB
# planted defects of the narrow kernel's small route (Ci and Co in PAIR_C:
# V2's and c2_deep's convs, the fused pair): copies of csrc/mrf_narrow.cu
# whose sums leave the last tap out, whose pair keeps its intermediate's rows
# outside [0, T) (the first conv's values, not the second conv's zero
# padding), and (f32 only) whose products take one TF32 pass (a_hi w_hi) of
# the three, on both tensor-core routes; each held at least
# K2F_DEFECT_MARGIN x the limits at every small-route call it reaches (with
# the operands and weights rounded to TF32 in f32 mode, no copy)
NARROW_DEFECTS = (
    ("narrow_last_tap", [(r"for \(int tap = 0; tap < K; \+\+tap\) \{",
                          "for (int tap = 0; tap < K - 1; ++tap) {")]),
    ("narrow_pair_halo", [(r"const bool kept = tr >= 0 && tr < T;", "const bool kept = true;")]),
    ("narrow_one_pass", [(r"constexpr int kTf32Passes = 7;", "constexpr int kTf32Passes = 4;")]),
)
# the defects a run of V2 (4l) or c2_deep (4n) must read, each with its modes
NARROW_DEFECTS_HELD = ("narrow_last_tap[f32]", "narrow_last_tap[bf16]", "narrow_pair_halo[f32]",
                       "narrow_pair_halo[bf16]", "narrow_one_pass[f32]")


def narrow_copies():
    """Start nvcc of the NARROW_DEFECTS copies of csrc/mrf_narrow.cu (under
    build/defects) -> a function that waits for them: {name: library}."""
    return build_copies("mrf_narrow", NARROW_DEFECTS, ROOT / "build" / "defects", wait=False)


def narrow_defects(copies, call: str, run, ref, pair: bool, f32: bool, defects: dict) -> None:
    """The NARROW_DEFECTS copies (``copies``: {name: library}) at one call of
    the small route: ``run()`` launched on each copy that reaches it (the
    pair's halo only on a pair, one TF32 pass only in f32), its output's
    error against ``ref`` of ``ref``'s own max into ``defects[name]``."""
    for name, _ in NARROW_DEFECTS:
        if (name == "narrow_pair_halo" and not pair) or (name == "narrow_one_pass" and not f32):
            continue
        with narrow_library(copies[name]):
            got = run()
        defects.setdefault(name, []).append({"call": call, "rel_err": err(got, ref, True)[1]})


def hold_narrow_defects(defects: dict, log: dict, where: str) -> None:
    """Each defect's least reading (``defects``: {"<name>[<mode>]":
    readings}) at least K2F_DEFECT_MARGIN x its limit, and every one of
    NARROW_DEFECTS_HELD read (and tf32_operands[f32]), else SmokeFailure."""
    for dname, rs in defects.items():
        lim = K2F_TOL if dname.endswith("[f32]") else K2_TOL
        least = min(r["rel_err"] for r in rs)
        log.setdefault("narrow_defects", {})[f"{dname} {where}"] = {
            "readings": rs, "least": least, "tol": lim}
        print(f"  narrow kernel planted defect {dname} ({where}): least reading {least:.3e} "
              f"({least / lim:.0f}x the limit {lim:g}, {len(rs)} calls)")
        if not least >= K2F_DEFECT_MARGIN * lim:
            raise SmokeFailure(f"the planted defect {dname} ({where}) reads {least:.3e}, under "
                               f"{K2F_DEFECT_MARGIN:g} x {lim:g}")
    if {*NARROW_DEFECTS_HELD, "tf32_operands[f32]"} - set(defects):
        raise SmokeFailure(f"the narrow kernel's planted defects did not all run ({where}): "
                           f"{list(defects)}")


@contextlib.contextmanager
def narrow_library(path):
    """K2's narrow entries launch another build of csrc/mrf_narrow.cu (a
    defect's copy) inside the block."""
    import ctypes

    from tacotron2_tpu_torch.ops import mrf

    saved = mrf._lib_narrow()
    lib = ctypes.CDLL(str(path))
    mrf._LIB_NARROW = mrf.bind(mrf.bind(lib, "", "narrow"), "_f32", "narrow")
    try:
        yield
    finally:
        mrf._LIB_NARROW = saved


def v2v3_stages(gen, tag: str, Tb: int, B: int, g, log: dict, copies=None, label=None) -> dict:
    """One generator's K2 entries against their plain versions at ``B`` rows
    of ``Tb`` frames, each stage from the plain stage's input (as 3f):
    ``conv_pre``, each upsample and its operand, each stage's first conv or
    fused pair alone on the upsample's operand (no residual: the conv's own
    sum) and the whole stage (ResBlock2's single convs carrying the
    residual). f32 within K2F_TOL of the output's max, bf16 within K2_TOL
    (``conv_pre`` by ``conv_pre_check``). Bit for bit, failing the run: each
    fused pair against its two launches, and at the narrow widths the
    pair's first conv alone with the residual (``narrow_conv``). With
    ``copies`` (the defects' builds), at the small route's calls
    (``mrf.narrow_small``): the planted defects' readings, each of the
    output's own max (``narrow_defects``; with the operands and weights
    rounded to TF32 in f32 mode, ``tf32_operands``) -> {defect: [readings]}.
    A check's kernel is the entry's counter name,
    ``[tag]`` added for the wide entries (their kernels-line rows are
    UNIVERSAL_V1's), or ``label(counter)``. An upsample on JAX's XLA route
    (no fold: stock ops, the plain version's own function) is not checked."""
    import torch

    from tacotron2_tpu_torch.models import layers
    from tacotron2_tpu_torch.ops import mrf

    dt = gen.policy.compute_dtype
    f32 = dt == torch.float32
    tol, own = (K2F_TOL, True) if f32 else (K2_TOL, False)
    label = label or (lambda key: key if key.startswith("narrow") else f"{key}[{tag}]")
    kw, cwp = gen.kernel_weights(), gen.conv_pre_weights()
    mel = torch.randn(B, Tb, gen.cfg.num_mels, device="cuda", generator=g)
    at = f"[{tag}]@B{B}x{Tb}"
    key = mrf.launch_key("conv_pre", cwp)
    if f32:
        check(f"{key}{at}", [("a", mrf.conv_pre(mel, cwp), mrf.conv_pre_plain(mel, cwp))], tol,
              log, label(key), own)
    else:
        conv_pre_check(gen, mel, log, f"{tag} B{B}", label(key))
    x = layers.conv1d(mel, gen.conv_pre.weight, gen.conv_pre.bias, gen.policy, padding=3,
                      round_out=True)
    defects: dict = {}
    for i, (rbs, ups) in enumerate(kw):
        x = x.contiguous()
        a = mrf.operand(x, dt)
        xu, au = mrf.conv_transpose_plain(a, ups, want_act=True)
        if ups.folded is not None:
            key = mrf.launch_key("conv_transpose", ups.folded)
            yk, ak = mrf.conv_transpose(a, ups, want_act=True)
            check(f"{key}[{tag} {i}]@B{B}", [("out", yk, xu), ("act", ak, au)], tol, log,
                  label(key), own)
            del yk, ak
            if copies is not None and mrf.narrow_small(*ups.folded.w.shape[1:]):
                narrow_defects(copies, f"{key}[{tag} {i}]@B{B}",
                               lambda a=a, ups=ups: mrf.conv_transpose(a, ups)[0], xu, False,
                               f32, defects)
        del a
        c1, c2 = rbs[0][0]
        pair = mrf.pair_fusable(c1, c2)
        key = mrf.launch_key("mrf_pair" if pair else "mrf_conv", c1)
        xu, au = xu.contiguous(), au.contiguous()
        kern, plain = (mrf.mrf_pair, mrf.mrf_pair_plain) if pair else (mrf.mrf_conv,
                                                                        mrf.mrf_conv_plain)
        one = ((lambda f, a, c1, c2: f(a, c1, c2, want_act=True)) if pair else
               (lambda f, a, c1, c2: f(a, c1, want_act=True)))
        p_out = one(plain, au, c1, c2)
        k_out = one(kern, au, c1, c2)
        check(f"{key}[{tag} {i}]@B{B}", [("y", k_out[0], p_out[0]), ("act", k_out[1], p_out[1])],
              tol, log, label(key), own)
        if pair and key.startswith("narrow"):  # the pair's first conv alone: narrow_conv
            ck = mrf.launch_key("mrf_conv", c1)
            check(f"{ck}[{tag} {i}]@B{B}", list(zip(
                ("y", "act"), mrf.mrf_conv(au, c1, xu, want_act=True)[:2],
                mrf.mrf_conv_plain(au, c1, xu, want_act=True)[:2])), tol, log, ck, own)
        if copies is not None and mrf.narrow_small(*c1.w.shape[1:]):
            narrow_defects(copies, f"{key}[{tag} {i}]@B{B}", lambda: one(kern, au, c1, c2)[0],
                           p_out[0], pair, f32, defects)
            if f32:
                d_out = one(kern, tf32_round(au), rounded_conv(c1, tf32_round),
                            rounded_conv(c2, tf32_round) if pair else None)[0]
                defects.setdefault("tf32_operands", []).append(
                    {"call": f"{key}[{tag} {i}]@B{B}", "rel_err": err(d_out, p_out[0], True)[1]})
        del k_out, p_out
        if pair:
            acc = torch.randn(xu.shape, device="cuda", generator=g)
            fused = mrf.mrf_pair(au, c1, c2, xu, acc, 0.25, True, True)
            _, a1, _ = mrf.mrf_conv(au, c1, want_y=False, want_act=True)
            unfused = mrf.mrf_conv(a1, c2, xu, acc, 0.25, True, True)
            if not all(torch.equal(f, u) for f, u in zip(fused, unfused)):
                raise SmokeFailure(f"{key}[{tag} {i}]@B{B}: the fused pair differs from its two "
                                   "mrf_conv launches")
            del acc, fused, a1, unfused
        del xu, au
        ref = mrf.plain_stage(x, rbs, ups)
        check(f"mrf_stage{'_f32' if f32 else ''}[{tag} {i}]@B{B}",
              [("out", mrf.mrf_stage(x, rbs, ups), ref)], tol, log, label(key), own)
        x = ref
    return defects


def v2v3_invariance(gen, tag: str, Tb: int, g, rows=None) -> None:
    """Rows V2V3_INVARIANCE_ROWS (or ``rows``) of a 64-row (max(rows) + 1
    rows) vocode against each row alone,
    bit for bit, failing the run: every K2 output of the served route
    (``conv_pre``, each stage passing its mean's operand on) and, for an
    F32 generator, ``HiFiGAN.apply``'s audio."""
    import torch

    from tacotron2_tpu_torch.ops import mrf

    kw, cwp = gen.kernel_weights(), gen.conv_pre_weights()
    dt = gen.policy.compute_dtype

    def route(m):
        outs = [mrf.conv_pre(m.to(dt), cwp)]
        for i, (rbs, ups) in enumerate(kw):
            outs.append(mrf.mrf_stage(None, rbs, ups, outs[-1], want_operand=i < len(kw) - 1))
        return outs

    rows = rows or V2V3_INVARIANCE_ROWS
    n = max(rows) + 1
    mel = torch.randn(n, Tb, gen.cfg.num_mels, device="cuda", generator=g)
    batch = route(mel)
    wav = gen.apply(mel) if dt == torch.float32 else None
    for r in rows:
        if not all(torch.equal(b[r:r + 1], o) for b, o in zip(batch, route(mel[r:r + 1]))):
            raise SmokeFailure(f"K2 {tag} {dt}: row {r} of a {n}-row vocode differs from the row "
                               "alone")
        if wav is not None and not torch.equal(wav[r:r + 1], gen.apply(mel[r:r + 1])):
            raise SmokeFailure(f"the {tag} F32 vocode (HiFiGAN.apply): row {r} of {n} differs "
                               "from the row alone")


def v2v3_say(tag: str, h: dict, cfg_path: str, ckpt: str, g_path: str, log: dict,
             card: str) -> dict:
    """``say --hifi-gan-checkpoint`` of a V2 / V3 ``g_*`` file through the CLI
    entry (the forced 256-frame decode of phase 4's checkpoint,
    ``--export-mel``), with the launch counters set to 0 before it and read
    after: K2's exactly ``vocode_launches(h)`` of the f32 mode, none of the
    bf16 mode, one weight packing. The WAV against the plain f32 vocode of
    the exported mel (VOCODE_F32_LSB); then a bf16 generator's vocode of the
    same mel (K2's bf16 mode, its launches the bf16 rows' count) reported
    against it. -> {"f32": launches, "bf16": launches, "perf": ...}"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.models import hifigan as hifigan_mod
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.ops import mrf
    from tacotron2_tpu_torch.run.say import cut_vocode, load_hifigan, vocode_bucket

    out = str(WORK / f"say_{tag}.wav")
    say = lambda: cli(["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint",
                       g_path, "--text", TEXT, "--out", out, "--random-seed", str(SEED),
                       "--max-len-override", str(V2V3_FRAMES), "--export-mel"])
    say()  # warm-up
    mrf.reset_launches()
    packs0 = hifigan_mod.PACK_CALLS[0]
    res = say()
    got = {**mrf.LAUNCHES, **mrf.F32_LAUNCHES}
    packs = hifigan_mod.PACK_CALLS[0] - packs0
    print(f"  say {tag}: {res['n_frames']} frames, cut {res['cut']}; K2 launches "
          f"{ {k: v for k, v in got.items() if v} }, weight packings {packs}")
    check_vocode_launches(got, 1, f"say {tag}", h=h)
    if packs != 1 or res["n_frames"] != V2V3_FRAMES:
        raise SmokeFailure(f"say {tag}: {res}, {packs} weight packings (want {V2V3_FRAMES} "
                           "frames, 1)")
    wav, _ = read_wav(out)
    mel = torch.as_tensor(np.load(out + ".npy").T[None].copy(), device="cuda")
    dev = torch.device("cuda")
    h32 = load_hifigan(g_path, dev)
    cut = res["cut"]
    Tb = vocode_bucket(h32, cut)
    hop = h32.cfg.total_upsample
    plain = cut_vocode(h32, mel, [0], [cut], Tb, plain=True)[0, :cut * hop].long().cpu()
    pcm = torch.as_tensor(np.round(wav * 32768.0)).long()
    if len(wav) != cut * hop or not np.isfinite(wav).all() or not np.abs(wav).max() > 0:
        raise SmokeFailure(f"say {tag}: bad wav, {len(wav)} samples for cut {cut}")
    lsb = (pcm - plain).abs().float()
    vs_plain = {"max_lsb": float(lsb.max()), "mean_lsb": float(lsb.mean()),
                "samples": len(wav), "peak_lsb": float(plain.abs().max()),
                "tol_lsb": VOCODE_F32_LSB}
    print(f"  say {tag}'s WAV against the plain f32 vocode of its mel, PCM16 LSB: {vs_plain}")
    if not vs_plain["max_lsb"] <= VOCODE_F32_LSB:
        raise SmokeFailure(f"say {tag}'s WAV against the plain f32 vocode: {vs_plain}")
    hbf = load_hifigan(g_path, dev, Policy(torch.bfloat16))
    cut_vocode(hbf, mel, [0], [cut], Tb)  # packs the bf16 copies
    mrf.reset_launches()
    pcm_bf = cut_vocode(hbf, mel, [0], [cut], Tb)[0, :cut * hop].long().cpu()
    bf16 = dict(mrf.LAUNCHES)
    check_vocode_launches({**bf16, **mrf.F32_LAUNCHES}, 1, f"the bf16 {tag} vocode",
                          torch.bfloat16, h)
    lsb_bf = (pcm_bf - pcm).abs().float()
    perf = {"rtf": res["say_s"] / res["audio_s"],
            "vocoder_us_per_frame": res["vocode_s"] / cut * 1e6,
            "decode_us_per_step": res["decode_s"] / res["n_frames"] * 1e6,
            "say_s": res["say_s"], "audio_s": res["audio_s"], "card": card}
    print(f"  say {tag}: RTF {perf['rtf']:.4f}, vocoder {perf['vocoder_us_per_frame']:.1f} "
          f"us/frame (host clock), decode {perf['decode_us_per_step']:.1f} us/step on {card}; "
          f"bf16 vocode against the f32 WAV, max {float(lsb_bf.max()):.0f} / mean "
          f"{float(lsb_bf.mean()):.2f} LSB (reported)")
    log.setdefault("v2v3", {}).setdefault(tag, {})["say"] = {
        "run": res, "launches": got, "vs_plain": vs_plain, "perf": perf,
        "bf16_vs_f32": {"max_lsb": float(lsb_bf.max()), "mean_lsb": float(lsb_bf.mean())}}
    del h32, hbf
    return {"f32": {k: v for k, v in got.items() if k in mrf.F32_LAUNCHES}, "bf16": bf16,
            "perf": perf}


def v2_serve(cfg_path: str, ckpt: str, g_path: str, log: dict, card: str) -> dict:
    """The warm server in this process (``do_server``) with one entry of
    phase 4's checkpoint and the V2 ``g_*`` file: a warm-up request, then a
    wave of V2V3_WAVE concurrent requests, which must coalesce, with K2's
    launches held to ``vocode_launches(HIFIGAN_V2)`` a decode launch (f32,
    no bf16 entry), then every request of the wave alone, each within
    V2V3_SERVE_LSB of its batched audio. -> K2's f32 launches in the wave."""
    import concurrent.futures
    import os
    import threading

    import numpy as np

    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.ops import mrf
    from tacotron2_tpu_torch.run import server as srv

    root = WORK / "serve_v2"
    root.mkdir(parents=True, exist_ok=True)
    config = {"models": [{"name": "vanilla-v2", "config": cfg_path, "checkpoint": ckpt,
                          "hifi_gan_checkpoint": g_path, "max_len": V2V3_FRAMES,
                          "multi_speaker": False,
                          "controllable": False, "num_voices": 1}],
              "batching": {"enabled": True, "window_ms": 8, "max_batch": 64, "depth": 2},
              "warmup": False}
    cwd = os.getcwd()
    os.chdir(root)
    started, holder = threading.Event(), {}
    thread = threading.Thread(target=lambda: holder.setdefault("result", srv.do_server(
        0, config, "warm", host="127.0.0.1",
        on_start=lambda h: (holder.setdefault("httpd", h), started.set()))), daemon=True)
    pcm = lambda body: np.round(read_wav(str(root / body["path"]))[0] * 32768.0)
    try:
        thread.start()
        while not started.wait(0.5):
            if not thread.is_alive():
                raise SmokeFailure("the V2 server did not start")
        port = holder["httpd"].server_address[1]
        status, body, _ = _post(port, {"text": TEXT, "model": 0, "seed": 1})
        if status != 200:
            raise SmokeFailure(f"V2 server warm-up: {status} {body}")
        payloads = [{"text": TRAIN_TEXTS[i % len(TRAIN_TEXTS)], "model": 0, "seed": 200 + i}
                    for i in range(V2V3_WAVE)]
        barrier = threading.Barrier(V2V3_WAVE)

        def one(p):
            barrier.wait()
            return _post(port, p)

        mrf.reset_launches()
        calls0 = srv.BATCH_CALLS[0]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(V2V3_WAVE) as ex:
            replies = list(ex.map(one, payloads))
        wall = time.perf_counter() - t0
        calls = srv.BATCH_CALLS[0] - calls0
        got = {**mrf.LAUNCHES, **mrf.F32_LAUNCHES}
        if any(s != 200 for s, _, _ in replies) or not 1 <= calls < V2V3_WAVE:
            raise SmokeFailure(f"V2 wave of {V2V3_WAVE}: {[(s, b) for s, b, _ in replies][:2]}, "
                               f"{calls} decode launches")
        check_vocode_launches(got, calls, "the V2 serve wave", h=HIFIGAN_V2)
        lsb = []
        for p, (_, body, _) in zip(payloads, replies):
            st, solo, _ = _post(port, p)
            a, b = pcm(body), pcm(solo)
            if st != 200 or len(a) != len(b):
                raise SmokeFailure(f"V2 request {p['seed']} alone: {st}, {len(b)} samples, "
                                   f"batched {len(a)}")
            lsb.append(float(np.abs(a - b).max()))
    finally:
        if "httpd" in holder:
            holder["httpd"].shutdown()
        thread.join(60)
        os.chdir(cwd)
    wave = {"requests": V2V3_WAVE, "decode_launches": calls, "wall_s": wall,
            "max_lsb_alone": max(lsb), "lsb_alone": lsb, "card": card}
    print(f"  V2 server: a wave of {V2V3_WAVE} in {calls} decode launches, {wall:.2f} s; each "
          f"request alone, max {max(lsb):.0f} PCM16 LSB from its batched audio on {card}")
    log.setdefault("v2v3", {}).setdefault("v2", {})["serve"] = wave
    if not max(lsb) <= V2V3_SERVE_LSB:
        raise SmokeFailure(f"V2 served requests differ from alone by {max(lsb)} LSB > "
                           f"{V2V3_SERVE_LSB}")
    return {k: v for k, v in got.items() if k in mrf.F32_LAUNCHES}


def v2v3_phase(cfg_path: str, ckpt: str, log: dict, card: str, copies=None) -> tuple:
    """Phase 4l: HiFi-GAN V2 and V3 (HIFIGAN_V2 / HIFIGAN_V3, random weights
    from the seed at the published widths, weight norm as upstream stores
    it, each a ``g_*`` file with its ``config.json``). For each: every K2
    entry and stage against its plain version at V2V3_ROWS rows of the
    say's bucket, f32 (the commands' vocoder) and bf16 (``v2v3_stages``),
    the narrow kernel's planted defects at 16 rows at least
    K2F_DEFECT_MARGIN x the limits, rows of a 64-row vocode bit for bit
    against the rows alone (``v2v3_invariance``), ``say`` through the CLI
    (``v2v3_say``), then for V2 the warm server's wave (``v2_serve``), and
    every entry timed at V2V3_ROWS rows (``k2_timing``: kernel, cuDNN f32
    and bf16, bound; the plain version at one row; ``narrow_conv`` with the
    pairs unfused, into the log only: no published vocode launches it). -> (the kernels-line rows
    of the narrow entries, {row name: {"v2" / "v3": readings}} for the wide
    entries' rows, the narrow entries' launches on the path: the V2 say and
    wave in f32, the V2 bf16 vocode in bf16)."""
    import torch

    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.ops import mrf
    from tacotron2_tpu_torch.run.say import load_hifigan, vocode_bucket

    dev = torch.device("cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 93)
    narrow_rows, readings, launches = {}, {}, {}
    defects: dict = {}
    for tag, h in V2V3.items():
        g_path = write_hifigan(h, f"hifigan_{tag}", V2V3_SEED[tag])
        gens = {"f32": load_hifigan(g_path, dev), "bf16": load_hifigan(g_path, dev,
                                                                        Policy(torch.bfloat16))}
        Tb = vocode_bucket(gens["f32"], V2V3_FRAMES - 1)  # the say's bucket
        n_params = sum(p.numel() for p in gens["f32"].parameters())
        print(f"  {tag}: {n_params} parameters, Tb {Tb}; K2 a vocode, f32 "
              f"{ {k: v for k, v in vocode_launches(h).items() if v} }")
        t0 = time.perf_counter()
        for B in V2V3_ROWS:
            for mode, gen in gens.items():
                libs = copies() if B == 16 and tag == "v2" else None
                for k, v in v2v3_stages(gen, tag, Tb, B, g, log, libs).items():
                    defects.setdefault(f"{k}[{mode}]", []).extend(v)
            torch.cuda.empty_cache()
        for gen in gens.values():
            v2v3_invariance(gen, tag, Tb, g)
        torch.cuda.empty_cache()
        checks_s = time.perf_counter() - t0
        print(f"  {tag}: every entry and stage against its plain version at {list(V2V3_ROWS)} "
              f"rows (f32 and bf16), fused pairs against their two launches, rows "
              f"{list(V2V3_INVARIANCE_ROWS)} of {max(V2V3_INVARIANCE_ROWS) + 1} alone bit for "
              f"bit, in {checks_s:.1f} s")
        said = v2v3_say(tag, h, cfg_path, ckpt, g_path, log, card)
        path = {"f32": said["f32"], "bf16": said["bf16"]}
        if tag == "v2":
            for k, n in v2_serve(cfg_path, ckpt, g_path, log, card).items():
                path["f32"][k] += n
        t0 = time.perf_counter()
        for mode, gen in gens.items():
            for B in V2V3_ROWS:
                big = B > 1
                for r in k2_timing(gen, Tb, B, not big,
                                   ((1, 2) if B >= 64 else (2, 2)) if big else (5, 4)):
                    entry = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "library_bf16_ms", "eager_ms",
                                               "traffic_ms", "per") if k in r}
                    if r["name"].startswith("narrow"):
                        row = narrow_rows.setdefault(r["name"], {**r, "rows": {}})
                        row["rows"][f"B{B}"] = entry
                    else:
                        row = readings.setdefault(r["name"], {}).setdefault(
                            tag, {"rows": {}, "launches_per_vocode": vocode_launches(
                                h, gen.policy.compute_dtype)[r["name"]]})
                        row["rows"][f"B{B}"] = entry
                    print(f"  {tag} {r['name']} at {B} rows, Tb={Tb}: {r['ms']:.4f} ms, plain "
                          f"{ms_text(r['plain_ms'])}, cuDNN f32 {r['library_ms']:.4f}"
                          + (f", bf16 {r['library_bf16_ms']:.4f}" if r.get('library_bf16_ms')
                             else "")
                          + f", bound {r['bound_ms']:.4f} ({r['bound_by']}) on {card}")
            torch.cuda.empty_cache()
            if tag == "v2":  # narrow_conv: no published vocode launches it (its pairs fuse)
                for B in V2V3_ROWS:
                    for r in k2_timing(gen, Tb, B, B == 1, (5, 4) if B == 1 else (1, 2),
                                       fuse_pairs=False):
                        if r["name"].startswith("narrow_conv"):
                            log.setdefault("narrow_conv", {}).setdefault(r["name"], {})[
                                f"B{B}"] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by", "library_ms",
                                                              "library_bf16_ms", "per")}
                            print(f"  v2 {r['name']} (the pairs as two launches) at {B} rows: "
                                  f"{r['ms']:.4f} ms, plain {ms_text(r['plain_ms'])}, cuDNN f32 "
                                  f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} on {card}")
                torch.cuda.empty_cache()
        log.setdefault("v2v3", {}).setdefault(tag, {}).update(
            {"Tb": Tb, "params": n_params, "checks_s": checks_s,
             "timing_s": time.perf_counter() - t0, "path_launches": path})
        if tag == "v2":
            for mode, counts in path.items():
                launches.update({k: n for k, n in counts.items() if k.startswith("narrow")})
        del gens
        torch.cuda.empty_cache()
    hold_narrow_defects(defects, log, "4l v2")
    rows = []
    for r in narrow_rows.values():  # the kernels line: the say's one row, the others in "rows"
        r.update({k: r["rows"]["B1"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "eager_ms", "traffic_ms", "per")})
        if not launches.get(r["name"]):
            raise SmokeFailure(f"{r['name']} was not launched on the V2 path: {launches}")
        rows.append(r)
    return rows, readings, launches


def v2v3_mode() -> int:
    """``--v2v3``: the kernels' build and phase 4l alone, on phase 4's
    vanilla checkpoint (random full-width weights, gate bias 10); details to
    ``chiprun_out/v2v3.json``."""
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning
    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build

    card = card_line()
    print(f"[4l] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    t0 = time.perf_counter()
    copies = narrow_copies()
    logs = build.build_all()
    log: dict = {"card": card, "build_s": time.perf_counter() - t0,
                 "ptxas_kernels": {"mrf_narrow": ptxas_kernels(logs["mrf_narrow"])}}
    print(f"  built in {log['build_s']:.1f} s; mrf_narrow: {log['ptxas_kernels']['mrf_narrow']}")
    try:
        WORK.mkdir(parents=True, exist_ok=True)
        cfg_path = str(ROOT / "config" / "vanilla-ljspeech-stop.json")
        ckpt = str(WORK / "tacotron2-run.ckpt")
        torch.save(to_lightning(random_tacotron(load_config(cfg_path), 10.0).state_dict()), ckpt)
        rows, readings, launches = v2v3_phase(cfg_path, ckpt, log, card, copies)
        log.update({"rows": rows, "readings": readings, "launches": launches})
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        log["seconds"] = time.perf_counter() - t0
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "v2v3.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
        with contextlib.suppress(SmokeFailure):
            copies()
    print(f"  4l took {log['seconds']:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                                     "library_ms", "rows")} for r in rows],
                      "launches": launches}))
    print(card)
    return 0


# ---------------------------------------------------------------------------
# phase 4m: K1's f32 mode and the F32 teacher-forced route ("32-true" models)
# ---------------------------------------------------------------------------

F32_CONFIG = "vanilla-ljspeech-stop.json"  # written again with "precision": "32-true"
K1F_TOL = 1e-5  # an f32 entry against its plain f32 version, one step, of each output's max
K1F_CHUNK_TOL = 1e-4  # the same over a 64-step f32 chunk
K1F_ROWS = (1, 16, 64)  # the say's one row (L = 96) and the serve windows' rows (L = 128)
K1F_INVARIANCE_ROWS = (0, 1, 37, 63)  # rows of a 64-row launch held against the rows alone
K1F_TWO_PASSES = 80  # rows past one pass of 64 (the cell's and the heads' second tile)
# prenet_f32_act_bf16 rounds its first layer's sums to bf16: where the
# kernel's f32 sum and the plain version's (summed in another order) fall on
# either side of a bf16 rounding boundary, that element differs by one bf16
# ulp and moves its row's outputs (6.5e-4 of the max at 80 rows read on an
# H100). A row past K1F_TOL is held to K1F_TOL of one of the outputs that
# the roundings of its boundary elements allow (``prenet_act_bf16_rows``);
# at most this many such elements a row
K1F_BOUNDARY_MAX = 14
K1F_DEFECT_MARGIN = 10.0  # a planted defect reads at least this many times its limit
K1F_FRAMES = 256  # the forced decode of the say and the served requests
K1F_WAVE = 16  # the served wave of concurrent requests
K1F_SERVE_LSB = 0  # a request of the wave against the same request alone, PCM16 LSB
K1F_TRAIN_STEPS = 3  # train steps of the 32-true config, then one --finetune step
K1F_STEP_B = 8  # rows of the one-step comparison, card against the CPU
K1F_STEP_DRAWS = 6  # draws of rows and masks that --f32-step compares
# one F32 train step on the card against the same step on the CPU (same
# state, batch and masks, dropout off): the loss relative, and every
# gradient as one vector, its relative L2 distance (each tensor's worst
# element against its own max is reported: a BatchNorm-fed bias's gradient
# is zero but for its sums' rounding). The CPU's step takes the card's ReLU
# branches (``relu_branches``): a pre-activation within rounding of zero
# may take the other branch on the other side, and one such element of an
# encoder conv moves the gradients by a whole term of a BatchNorm channel's
# few (``--f32-step``'s probe on an H100: 8.2e-5 to 1.4e-4 an element; two
# such elements, at 6.2e-8 of their max, read 1.5e-4 on the CPU's own
# branches). Readings on an H100 over six draws on the card's branches
# (PERF.md §6): loss <= 1.4e-7, gradients <= 7.0e-7; bf16 operands of the
# cells and heads (the defect) loss >= 1.26e-5, gradients >= 9.6e-4.
# Gradients: 10x the sound reading, rounded up; loss: 7x, as 10x would
# leave the defect under 10x its limit
K1F_STEP_TOL = {"loss": 1e-6, "grads": 1e-5}
# an element whose branch the CPU takes from the card: its |pre-activation|
# on the CPU over its call's max, at most (a sign within rounding of zero:
# read <= 6.2e-8; the prenet's weights rounded to bf16, a defect, 8.1e-4
# to 1.3e-3)
K1F_FLIP_REL = 1e-5
# planted defects of the f32 entries: copies of csrc/decode_step.cu (under
# build/defects) with the f32 cell's operands rounded to bf16 where it takes
# them (cf_op), the cell's and the heads' products as one TF32 pass (w_hi
# a_hi: the two lo passes left out), and with the location conv's last tap
# left out (a copy of decode_common.cuh included instead); each read at 16
# rows
_CF_OP = r"__device__ __forceinline__ float cf_op\(float x\) \{ return x; \}"
K1F_DEFECTS = (
    ("k1f_bf16_operands", [(_CF_OP, "__device__ __forceinline__ float cf_op(float x) "
                                    "{ return rnd_bf16(x); }")]),
    ("k1f_tf32_pass", [(r"constexpr int CF_PASSES = 7;", "constexpr int CF_PASSES = 4;")]),
    ("k1f_heads_tf32_pass", [(r"constexpr int HF_PASSES = 7;", "constexpr int HF_PASSES = 4;")]),
    ("k1f_loc_tap", [(r'#include "decode_common\.cuh"', '#include "decode_common_tap.cuh"')]),
)
K1F_DEFECT_ENTRY = {"k1f_bf16_operands": "lstm_cell_f32", "k1f_tf32_pass": "lstm_cell_f32",
                    "k1f_heads_tf32_pass": "heads_f32", "k1f_loc_tap": "location_attention_f32"}
K1F_SOURCE = "tacotron2_tpu_torch/csrc/decode_step.cu"
K1F_REPLACES = {
    "lstm_cell_f32": "tacotron2_tpu/ops/decoder_loop_pallas.py:347 (f32 mode, dt :386; the "
                     "gate products :469)",
    "prenet_f32": "tacotron2_tpu/ops/decoder_loop_pallas.py:347 (f32 mode, the prenet :436-445)",
    "prenet_f32_act_bf16": "tacotron2_tpu/ops/decoder_loop_pallas.py:347 (int8 mode of f32 "
                           "weights, dt = bf16 :386, the prenet :441-444)",
    "location_attention_f32": "tacotron2_tpu/ops/decoder_loop_pallas.py:196 "
                              "(batched_location_attention, dt = f32)",
    "heads_f32": "tacotron2_tpu/ops/decoder_loop_pallas.py:347 (f32 mode, the heads :565-572)",
    "heads_f32_act_bf16": "tacotron2_tpu/ops/decoder_loop_pallas.py:347 (int8 mode of f32 "
                          "weights, the heads :567-572)",
}


def k1f_copies():
    """Start nvcc of the K1F_DEFECTS copies of csrc/decode_step.cu (under
    build/defects; the location-tap copy includes a copy of
    decode_common.cuh written beside it) -> a function that waits for them:
    {name: library}."""
    from tacotron2_tpu_torch.ops import build

    out = ROOT / "build" / "defects"
    out.mkdir(parents=True, exist_ok=True)
    head = (Path(build.__file__).parents[1] / "csrc" / "decode_common.cuh").read_text()
    tap = "for (int k = 0; k < K; ++k) {"
    if head.count(tap) != 1:
        raise SmokeFailure(f"decode_common.cuh: {tap!r} matches {head.count(tap)} times")
    (out / "decode_common_tap.cuh").write_text(head.replace(tap,
                                                            "for (int k = 0; k < K - 1; ++k) {"))
    return build_copies("decode_step", K1F_DEFECTS, out, wait=False)


@contextlib.contextmanager
def decode_library(path):
    """K1's wrappers launch another build of csrc/decode_step.cu (a defect's
    copy) inside the block."""
    import ctypes

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    saved = dl._lib()
    dl._LIB = dl.bind(ctypes.CDLL(str(path)))
    try:
        yield
    finally:
        dl._LIB = saved


@contextlib.contextmanager
def plain_decode():
    """The decode's chunks on ``decode_chunk_plain`` inside the block (the
    plain f32 decode on the card, from the same seed)."""
    from tacotron2_tpu_torch.ops import decoder_loop as dl

    saved = dl.decode_chunk
    dl.decode_chunk = dl.decode_chunk_plain
    try:
        yield
    finally:
        dl.decode_chunk = saved


def write_f32_config() -> str:
    """config/F32_CONFIG with ``"precision": "32-true"`` under WORK -> its path."""
    raw = json.loads((ROOT / "config" / F32_CONFIG).read_text())
    raw["training"]["precision"] = "32-true"
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / F32_CONFIG.replace(".json", "-32-true.json")
    path.write_text(json.dumps(raw))
    return str(path)


def k1f_inputs(pk, B: int, L: int, g) -> dict:
    """Random inputs of every f32 entry at B rows of L chars (rows shorter
    than L from the second on): the state, an f32 memory and its
    projection, the prenet's masks."""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    dev = pk.wq.device
    H, A = pk.wq.shape[1], pk.wq.shape[0]
    Pd, M = pk.wp2_t.shape[0], pk.wp1_t.shape[0]
    D = pk.w_att.shape[1] - Pd - H
    rn = lambda *s, scale=0.5: torch.randn(*s, device=dev, generator=g) * scale
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    lengths[1:] = torch.randint(L // 2, L + 1, (B - 1,), device=dev, generator=g).int()
    pad = torch.arange(L, device=dev)[None, :] >= lengths[:, None]
    soft = lambda: torch.softmax(rn(B, L, scale=3.0).masked_fill(pad, float("-inf")), dim=1)
    w = soft()
    m1, m2 = dl.prenet_masks(1, B, Pd, 0.5, g, dev)
    return {"mel": rn(B, M, scale=1.0), "x": torch.relu(rn(B, Pd)) * 2, "ctx": rn(B, D),
            "att_h": rn(B, H), "att_c": rn(B, H), "rnn_h": rn(B, H), "rnn_c": rn(B, H),
            "enc": rn(B, L, D), "att_enc": rn(B, L, A), "lengths": lengths, "w": w,
            "cum": w + soft(), "m1": m1[0], "m2": m2[0]}


def k1f_calls(dl, pk, i: dict, ctl=None) -> dict:
    """Each f32 entry's (kernel call, plain call, library call or None,
    bytes, flops) on ``k1f_inputs``: both cells as one entry (the decoder
    cell with the controls ``ctl`` (B, E) where given), the prenet and the
    heads with and without bf16 activations, the attention."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    B = i["mel"].shape[0]
    H = pk.wq.shape[1]
    f32 = lambda *s: torch.empty(*s, device=pk.wq.device)
    att = (i["x"], i["ctx"], i["att_h"], i["att_c"])
    dec = (i["att_h"], i["ctx"], i["rnn_h"], i["rnn_c"])
    cells = lambda fn, **kw: (*fn(pk.w_att, pk.b_att, *att, **kw.get("a", {})),
                              *fn(pk.w_dec, pk.b_dec, *dec, ctl=ctl, **kw.get("d", {})))
    pre = (i["mel"], pk.wp1_t, pk.wp2_t, i["m1"], i["m2"])
    hd = (pk.w_out, pk.b_out, i["rnn_h"], i["ctx"])
    ha = (i["att_h"], pk.wq, pk.w_loc, pk.wv, i["att_enc"], i["enc"], i["lengths"], i["w"],
          i["cum"])
    x_heads = torch.cat([i["rnn_h"], i["ctx"]] + ([] if ctl is None else [ctl]), 1)
    out = {
        "lstm_cell_f32": (
            lambda: cells(dl.lstm_cell, a={"wt": pk.wt_att}, d={"wt": pk.wt_dec}),
            lambda: cells(dl.lstm_cell_plain),
            None,  # nn.LSTMCell x2, built by the caller
            nbytes(pk.wt_att, pk.wt_dec, pk.b_att, pk.b_dec, *att, *dec, f32(4, B, H)),
            2 * B * (pk.w_att.numel() + pk.w_dec.numel())),
        "location_attention_f32": (
            lambda: dl.location_attention(*ha), lambda: dl.location_attention_plain(*ha), None,
            nbytes(*ha, f32(B, i["enc"].shape[2]), f32(2, *i["w"].shape)),
            2 * B * (pk.wq.numel() + pk.w_loc.numel() * i["w"].shape[1]
                     + i["enc"].shape[1] * (pk.wv.numel() + i["enc"].shape[2]))),
    }
    for act, sfx in ((None, ""), (bf, "_act_bf16")):
        out["prenet_f32" + sfx] = (
            lambda act=act: dl.prenet(*pre, wt=pk.wt_prenet, act=act),
            lambda act=act: dl.prenet_plain(*pre, act),
            lambda: F.linear(torch.relu(F.linear(i["mel"], pk.wp1_t.t())) * i["m1"],
                             pk.wp2_t.t()),
            nbytes(pk.wt_prenet, *pre[:1], *pre[3:], f32(B, pk.wp2_t.shape[0])),
            2 * B * (pk.wp1_t.numel() + pk.wp2_t.numel()))
        out["heads_f32" + sfx] = (
            lambda act=act: mel_gate(dl.heads(*hd, ctl=ctl, wt=pk.wt_out, act=act)),
            lambda act=act: mel_gate(dl.heads_plain(*hd, act, ctl)),
            lambda: F.linear(x_heads, pk.w_out, pk.b_out),
            nbytes(pk.wt_out, pk.b_out, x_heads, f32(B, pk.w_out.shape[0])),
            2 * B * pk.w_out.numel())
    return out


def mel_gate(out):
    """The heads' two outputs, the mel frame and the gate logit, held apart
    (each against its own max: the smoke's gate bias of 10 would otherwise
    set the scale of the mel's errors too)."""
    return out[:, :-1], out[:, -1:]


def _outputs(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _labels(name: str, n: int) -> list:
    return {"lstm_cell_f32": ["h_att", "c_att", "h_dec", "c_dec"],
            "location_attention_f32": ["ctx", "weights", "cum"],
            "heads_f32": ["mel", "gate"],
            "heads_f32_act_bf16": ["mel", "gate"]}.get(name, ["out"][:n])


def prenet_act_bf16_rows(pre, rows) -> dict:
    """What ``prenet_f32_act_bf16`` may give at ``rows`` of its inputs
    ``pre`` (mel, wp1_t, wp2_t, m1, m2): each first-layer output
    relu(bf16(mel) . W1) * m1 rounds to bf16; where its f32 value may lie
    on either side of a bf16 rounding boundary (the f32 sum's error bound
    (M + 2) u sum |terms|, u = 2^-24, and the mask's product), either
    neighbour is right. Each row: every choice over those elements, the
    second layer in f64. -> {row: (choices, P) outputs}"""
    import torch

    mel, w1, w2, m1, m2 = pre
    u = 2.0 ** -24
    xb, w1, w2 = mel.to(torch.bfloat16).double(), w1.double(), w2.double()
    s = xb @ w1
    e = (xb.abs() @ w1.abs()) * (w1.shape[0] + 2) * u
    bf = lambda v: v.to(torch.bfloat16).double()
    lo = bf(torch.relu(s - e) * m1.double() * (1 - u))
    hi = bf(torch.relu(s + e) * m1.double() * (1 + u))
    out = {}
    for r in rows:
        J = torch.nonzero(lo[r] != hi[r]).flatten()
        if len(J) > K1F_BOUNDARY_MAX:
            raise SmokeFailure(f"prenet_f32_act_bf16 row {r}: {len(J)} sums on a bf16 rounding "
                               f"boundary, more than {K1F_BOUNDARY_MAX}")
        pick = (torch.arange(2 ** len(J), device=s.device)[:, None]
                >> torch.arange(len(J), device=s.device)) & 1
        h = lo[r].repeat(2 ** len(J), 1)
        h[:, J] = torch.where(pick.bool(), hi[r, J], lo[r, J])
        out[r] = torch.relu(h @ w2) * m2[r].double()
    return out


def k1f_check(tag: str, name: str, got: list, ref: list, log: dict, pre=None) -> None:
    """``check`` of an f32 entry's outputs within K1F_TOL of each one's max.
    ``prenet_f32_act_bf16`` (its inputs ``pre``): a row past K1F_TOL of the
    plain version is held to K1F_TOL of one of the outputs that its
    roundings on a bf16 boundary allow (``prenet_act_bf16_rows``), each
    such row logged."""
    import torch

    if name != "prenet_f32_act_bf16":
        check(tag, list(zip(_labels(name, len(got)), got, ref)), K1F_TOL, log, name, own=True)
        return
    (g,), (r,) = got, ref
    scale = float(r.abs().max())
    row_err = (g - r).abs().amax(dim=1) / scale
    flipped = [int(b) for b in torch.nonzero(row_err > K1F_TOL).flatten()]
    alts = prenet_act_bf16_rows(pre, flipped)
    held = {b: float((g[b].double() - alts[b]).abs().amax(dim=1).min()) / scale
            for b in flipped}
    worst = float(row_err.max())
    log.setdefault("checks", []).append({"kernel": name, "check": tag, "output": "out",
                                         "max_abs_err": worst * scale, "rel_err": worst,
                                         "tol": K1F_TOL, "boundary_rows": {
                                             b: {"rel_err": float(row_err[b]),
                                                 "choices": len(alts[b]), "held": held[b]}
                                             for b in flipped}})
    print(f"  {tag:<20} out            max_abs_err {worst * scale:.3e}  rel {worst:.3e}  (tol "
          f"{K1F_TOL:g}; rows past it on a bf16 boundary, each against its nearest rounding: "
          f"{ {b: f'{v:.1e}' for b, v in held.items()} })")
    if not all(v <= K1F_TOL for v in held.values()):
        raise SmokeFailure(f"{tag}: rows {flipped} differ by up to {worst:.3e} of the max, "
                           f"{held} from their nearest bf16 rounding")


def k1f_prenet_defect(dl, pre, log: dict) -> None:
    """A planted defect of ``prenet_f32_act_bf16``'s check: the prenet with
    its f32 weights rounded to bf16 (not only its activations) must fail
    ``k1f_check`` at the rows of ``pre``."""
    import torch

    mel, w1, w2, m1, m2 = pre
    bf = lambda w: w.to(torch.bfloat16).float()
    bad = dl.prenet_plain(mel, bf(w1), bf(w2), m1, m2, torch.bfloat16)
    ref = dl.prenet_plain(*pre, torch.bfloat16)
    reading = err(bad, ref, True)[1]
    try:
        k1f_check(f"defect@B{mel.shape[0]}", "prenet_f32_act_bf16", [bad], [ref], {}, pre)
    except SmokeFailure:
        print(f"  planted defect prenet_bf16_weights (prenet_f32_act_bf16) reads {reading:.3e} "
              f"({reading / K1F_TOL:.0f}x K1F_TOL) and fails the check")
        log.setdefault("k1f_defects", {})["prenet_bf16_weights"] = {
            "entry": "prenet_f32_act_bf16", "rel_err": reading, "tol": K1F_TOL,
            "rows": mel.shape[0]}
        return
    raise SmokeFailure(f"prenet_f32_act_bf16's check passes its f32 weights rounded to bf16 "
                       f"({reading:.3e} of the max)")


# the f32 entries whose products run as three TF32 passes on the tensor
# cores: their bound counts 3 x the flops at the TF32 peak (K2's f32 mode's
# rule), the CUDA cores' FP32 time beside it (``cuda_core_ms``)
K1F_TF32 = ("lstm_cell_f32", "heads_f32", "heads_f32_act_bf16")


def k1f_bound(name: str, nb: float, fl: float) -> tuple:
    """``bound_ms`` of an f32 entry's bytes and flops on its route."""
    if name in K1F_TF32:
        return bound_ms(nb, 3 * fl, card_peak("tf32"))
    return bound_ms(nb, fl, card_peak("f32"))


def k1f_cells_library(model, pk, i: dict):
    """``nn.LSTMCell`` x2 in f32 on the cells' inputs (TF32 off): the library
    call of ``lstm_cell_f32``."""
    import torch

    dev = pk.wq.device
    mods = (model.decoder.att_rnn, model.decoder.lstm)
    ins = (torch.cat([i["x"], i["ctx"]], 1), (i["att_h"], i["att_c"]),
           torch.cat([i["att_h"], i["ctx"]], 1), (i["rnn_h"], i["rnn_c"]))
    cells = []
    for mod in mods:
        cell = torch.nn.LSTMCell(mod.input_size, mod.hidden_size, device=dev)
        cell.load_state_dict(mod.state_dict())
        cells.append(cell)
    if ins[2].shape[1] != mods[1].input_size:  # a controllable model: no library call
        return None
    return lambda: (cells[0](ins[0], ins[1]), cells[1](ins[2], ins[3]))


def k1f_entries(model, ctl_model, log: dict, copies=None) -> dict:
    """Every f32 entry of the f32 pack against its plain f32 version at
    K1F_ROWS rows (L = 96 at one row, 128 at the serve windows' rows), within
    K1F_TOL of each output's max; the controllable model's decoder cell and
    heads with distinct controls per row too; at 16 rows the planted
    defects (``copies``) at least K1F_DEFECT_MARGIN x the limit; rows
    K1F_INVARIANCE_ROWS of a 64-row launch of every entry bit for bit
    against the rows alone, and at K1F_TWO_PASSES rows (a second tile)
    every entry against its plain version and its last row alone; each entry timed (graph replay) beside its plain
    version, its bound and its library call (``nn.LSTMCell`` x2 f32,
    ``F.linear`` f32, TF32 off). -> {entry: {"B<rows>": timing}}"""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 70)
    pk, cpk = model.make_packed_decoder(), ctl_model.make_packed_decoder()
    if pk.w_att.dtype != torch.float32 or pk.wt_att.dtype != torch.float32:
        raise SmokeFailure(f"the 32-true model packed {pk.w_att.dtype} weights, want f32")
    peak = {"location_attention_f32": card_peak("f32")}
    out: dict = {}
    for B in K1F_ROWS:
        L = 96 if B == 1 else SERVE_L
        i = k1f_inputs(pk, B, L, g)
        pre = (i["mel"], pk.wp1_t, pk.wp2_t, i["m1"], i["m2"])
        for name, (kern, plain, lib, nb, fl) in k1f_calls(dl, pk, i).items():
            k1f_check(f"{name}@B{B}", name, _outputs(kern()), _outputs(plain()), log, pre)
            if name == "lstm_cell_f32":
                lib = k1f_cells_library(model, pk, i)
            b_ms, b_by = k1f_bound(name, nb, fl)
            r = out.setdefault(name, {})[f"B{B}"] = {
                "ms": time_ms(kern), "plain_ms": time_ms(plain), "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": time_ms(lib) if lib else None,
                "eager_ms": eager_ms(kern)}
            if name in K1F_TF32:
                r["cuda_core_ms"] = fl / card_peak("f32") * 1e3
            log.setdefault("k1f_timing", {}).setdefault(name, {})[f"B{B}"] = r
            lib_us = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f}"
            print(f"  {name} at {B} rows: {r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} "
                  f"us, library {lib_us} us, bound {b_ms * 1e3:.2f} us ({b_by})")
        # the controls rows: the decoder cell and the heads of a controllable model
        ci = k1f_inputs(cpk, B, L, g)
        E = cpk.controls_cols
        ctl = torch.nn.functional.pad(torch.randn(B, ctl_model.cfg.controls_dim, device="cuda",
                                                  generator=g), (0, E - ctl_model.cfg.controls_dim))
        calls = k1f_calls(dl, cpk, ci, ctl)
        for name in ("lstm_cell_f32", "heads_f32", "heads_f32_act_bf16"):
            kern, plain = calls[name][:2]
            got, ref = _outputs(kern()), _outputs(plain())
            check(f"{name}[controls]@B{B}", list(zip(_labels(name, len(got)), got, ref)),
                  K1F_TOL, log, name, own=True)
        if B == 1:
            k1f_prenet_defect(dl, pre, log)
        if B == 16 and copies is not None:
            calls = k1f_calls(dl, pk, i)
            for dname, path in copies().items():
                entry = K1F_DEFECT_ENTRY[dname]
                kern, plain = calls[entry][:2]
                ref = _outputs(plain())
                with decode_library(path):
                    got = _outputs(kern())
                reading = max(err(a, b, True)[1] for a, b in zip(got, ref))
                log.setdefault("k1f_defects", {})[dname] = {"entry": entry, "rel_err": reading,
                                                           "tol": K1F_TOL}
                print(f"  planted defect {dname} ({entry}) reads {reading:.3e} "
                      f"({reading / K1F_TOL:.0f}x K1F_TOL)")
                if not reading >= K1F_DEFECT_MARGIN * K1F_TOL:
                    raise SmokeFailure(f"the planted defect {dname} reads {reading:.3e}, under "
                                       f"{K1F_DEFECT_MARGIN:g} x {K1F_TOL:g}")
        torch.cuda.empty_cache()
    if copies is not None and (set(log.get("k1f_defects", {}))
                               != {d for d, _ in K1F_DEFECTS} | {"prenet_bf16_weights"}):
        raise SmokeFailure(f"the f32 entries' planted defects did not all run: "
                           f"{list(log.get('k1f_defects', {}))}")
    # rows of a 64-row launch against the rows alone, bit for bit
    B = max(K1F_INVARIANCE_ROWS) + 1
    for tag, (p, m) in (("", (pk, model)), ("[controls]", (cpk, ctl_model))):
        i = k1f_inputs(p, B, SERVE_L, g)
        ctl = None
        if tag:
            E = p.controls_cols
            ctl = torch.nn.functional.pad(torch.randn(B, m.cfg.controls_dim, device="cuda",
                                                      generator=g), (0, E - m.cfg.controls_dim))
        full = {k: _outputs(v[0]()) for k, v in k1f_calls(dl, p, i, ctl).items()}
        for r in K1F_INVARIANCE_ROWS:
            one = {k: (v[r:r + 1].contiguous() if torch.is_tensor(v) and v.dim() and v.shape[0] == B
                       else v) for k, v in i.items()}
            alone = k1f_calls(dl, p, one, None if ctl is None else ctl[r:r + 1].contiguous())
            for name, (kern, *_) in alone.items():
                if all(torch.equal(a[r:r + 1], b) for a, b in zip(full[name], _outputs(kern()))):
                    continue
                raise SmokeFailure(f"{name}{tag}: row {r} alone differs from the same row in a "
                                   f"{B}-row launch")
    # past 64 rows the cell and the heads run a second tile: every entry
    # against its plain version, its last row against the same row alone
    B, r = K1F_TWO_PASSES, K1F_TWO_PASSES - 1
    i = k1f_inputs(pk, B, SERVE_L, g)
    one = {k: (v[r:r + 1].contiguous() if torch.is_tensor(v) and v.dim() and v.shape[0] == B
               else v) for k, v in i.items()}
    alone = k1f_calls(dl, pk, one)
    pre = (i["mel"], pk.wp1_t, pk.wp2_t, i["m1"], i["m2"])
    for name, (kern, plain, *_) in k1f_calls(dl, pk, i).items():
        got = _outputs(kern())
        k1f_check(f"{name}@B{B}", name, got, _outputs(plain()), log, pre)
        if not all(torch.equal(a[r:r + 1], b) for a, b in zip(got, _outputs(alone[name][0]()))):
            raise SmokeFailure(f"{name}: row {r} alone differs from the same row in a {B}-row "
                               "launch")
    log["k1f_invariance"] = {"rows": list(K1F_INVARIANCE_ROWS), "of": 64, "entries": sorted(full),
                             "two_passes": B}
    print(f"  every f32 entry: rows {list(K1F_INVARIANCE_ROWS)} of a 64-row launch (and row {r} "
          f"of a {B}-row one) equal the rows alone, bit for bit (vanilla and with controls)")
    return out


def k1f_chunks(model, log: dict) -> dict:
    """64 decode steps through the chunk entry of the f32 pack against the
    plain f32 chunk at K1F_ROWS rows (K1F_CHUNK_TOL of each output's max),
    counting 5 launches a step of the f32 entries and none of the bf16
    ones; the int8 pack of the F32 model (K5's cells, the bf16 attention,
    the f32 prenet and heads with bf16 activations) over 4 steps within
    K5_CHUNK_TOL (of max(1, max |ref|), as K5's chunks are held: a flipped
    int8 quantum reads against the state's scale), 7 launches a step, and
    over 64 steps reported; each chunk timed (graph replay) and its
    launches per step held. -> the readings"""
    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 71)
    res: dict = {}
    for quant in (False, True):
        pk = model.make_packed_decoder(quantize=quant)
        if dl.decode_mode(pk) != (3 if quant else 2):
            raise SmokeFailure(f"the 32-true model's pack has mode {dl.decode_mode(pk)}")
        for B in K1F_ROWS:
            L = 96 if B == 1 else SERVE_L
            i = k1f_inputs(pk, B, L, g)
            enc = i["enc"].to(pk.wq.dtype).contiguous()
            s = dl.StepState(i["mel"], i["att_h"], i["att_c"], i["ctx"], i["w"], i["cum"],
                             i["rnn_h"], i["rnn_c"])
            for n in ((4, 64) if quant else (64,)):
                m1, m2 = dl.prenet_masks(n, B, pk.wp2_t.shape[0], 0.5, g, enc.device)
                args = (pk, enc, i["att_enc"], i["lengths"], s, m1, m2)
                dl.reset_launches()
                mg, al, sk = dl.decode_chunk(*args)
                counts = {k: v for k, v in {**dl.LAUNCHES, **dl.F32_LAUNCHES}.items() if v}
                want = ({"prenet_f32_act_bf16": n, "quantize_xh": 2 * n, "lstm_cell_int8": 2 * n,
                         "location_attention": n, "heads_f32_act_bf16": n} if quant else
                        {"prenet_f32": n, "lstm_cell_f32": 2 * n, "location_attention_f32": n,
                         "heads_f32": n})
                if counts != want:
                    raise SmokeFailure(f"{'int8 ' if quant else ''}f32 chunk of {n} steps at "
                                       f"{B} rows launched {counts}, want {want}")
                mgp, alp, sp = dl.decode_chunk_plain(*args)
                pairs = [("mel_gate", mg, mgp), ("weights", al, alp)] + [
                    (f, getattr(sk, f), getattr(sp, f)) for f in dl.StepState._fields[1:]]
                tag = f"{'int8_' if quant else ''}f32_chunk{n}@B{B}"
                kernel = "heads_f32_act_bf16" if quant else "lstm_cell_f32"
                if quant and n > 4:  # a flipped int8 quantum over 64 steps: reported
                    worst = max(err(a, b, True)[1] for _, a, b in pairs)
                    log.setdefault("k1f_chunks", {})[tag] = {"rel_err": worst}
                    print(f"  {tag:<24} rel {worst:.3e} (reported)")
                    continue
                worst = check(tag, pairs, K5_CHUNK_TOL if quant else K1F_CHUNK_TOL, log, kernel,
                              own=not quant)
                ms = time_ms(lambda: dl.decode_chunk(*args), 3, 1, 1)
                res[tag] = {"rel_err": worst, "ms": ms, "us_per_step": ms / n * 1e3,
                            "launches_per_step": sum(want.values()) / n}
                log.setdefault("k1f_chunks", {})[tag] = res[tag]
                print(f"  {tag:<24} {ms / n * 1e3:.1f} us a step on the card (graph replay)")
            torch.cuda.empty_cache()
    return res


def _f32_say_model(cfg_path: str, ckpt: str, quant: bool, plain: bool):
    """The say's forward_infer_fast of ``ckpt`` (the same seed, chars and
    frames as ``say``) on the kernels or on the plain chunk -> its output."""
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.run.say import load_tacotron
    from tacotron2_tpu_torch.text import CharEncoder, normalize_text

    dev = torch.device("cuda")
    cfg = load_config(cfg_path)
    prep = cfg.dataset.preprocessing
    model = load_tacotron(cfg, ckpt, dev)
    ci, cl = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch(
        [normalize_text(TEXT, prep.allowed_chars, prep.end_token, False)])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    run = lambda: model.forward_infer_fast(torch.as_tensor(ci, device=dev),
                                           torch.as_tensor(cl, device=dev), K1F_FRAMES,
                                           generator=gen, quantize=quant)
    if plain:
        with plain_decode():
            return run()
    return run()


def f32_say(cfg_path: str, ckpt: str, g_path: str, log: dict, card: str) -> dict:
    """``say`` of the 32-true config through the CLI entry (96 chars, the
    gate forced positive, K1F_FRAMES frames, ``--export-mel``), then with
    ``--quantize-int8``, the launch counters set to 0 before each and read
    after: exactly 5 f32 launches a frame (int8: 7, K5's cells), none of
    K1's bf16 entries, the vocoder's f32 plan; the WAV within VOCODE_F32_LSB
    of the plain f32 vocode of its exported mel; the mels of the same
    decode on the plain chunk (from the same seed) within K1F_CHUNK_TOL of
    their max (int8: reported), the same frames and lengths. -> {mode:
    {launches, perf}}"""
    import numpy as np
    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.ops import decoder_loop as dl
    from tacotron2_tpu_torch.ops import mrf
    from tacotron2_tpu_torch.run.say import cut_vocode, load_hifigan, vocode_bucket

    dev = torch.device("cuda")
    h32 = load_hifigan(g_path, dev)
    out: dict = {}
    for quant in (False, True):
        tag = "int8" if quant else "f32"
        wav_path = str(WORK / f"say_32true_{tag}.wav")
        say = lambda: cli(["say", "--config", cfg_path, "--checkpoint", ckpt,
                           "--hifi-gan-checkpoint", g_path, "--text", TEXT, "--out", wav_path,
                           "--random-seed", str(SEED), "--max-len-override", str(K1F_FRAMES),
                           "--export-mel"] + (["--quantize-int8"] if quant else []))
        say()  # warm-up
        dl.reset_launches()
        mrf.reset_launches()
        res = say()
        k1 = {k: v for k, v in {**dl.LAUNCHES, **dl.F32_LAUNCHES}.items() if v}
        n = res["n_frames"]
        want = ({"prenet_f32_act_bf16": n, "quantize_xh": 2 * n, "lstm_cell_int8": 2 * n,
                 "location_attention": n, "heads_f32_act_bf16": n} if quant else
                {"prenet_f32": n, "lstm_cell_f32": 2 * n, "location_attention_f32": n,
                 "heads_f32": n})
        print(f"  32-true say {tag}: {n} frames, cut {res['cut']}; K1 launches {k1}")
        if n != K1F_FRAMES or k1 != want:
            raise SmokeFailure(f"32-true say {tag}: {n} frames, launches {k1}, want "
                               f"{K1F_FRAMES} frames, {want}")
        check_vocode_launches({**mrf.LAUNCHES, **mrf.F32_LAUNCHES}, 1, f"32-true say {tag}")
        wav, _ = read_wav(wav_path)
        mel = torch.as_tensor(np.load(wav_path + ".npy").T[None].copy(), device=dev)
        cut = res["cut"]
        plain_pcm = cut_vocode(h32, mel, [0], [cut], vocode_bucket(h32, cut),
                               plain=True)[0, :cut * 256].long().cpu()
        pcm = torch.as_tensor(np.round(wav * 32768.0)).long()
        if len(wav) != cut * 256 or not np.isfinite(wav).all() or not np.abs(wav).max() > 0:
            raise SmokeFailure(f"32-true say {tag}: bad wav, {len(wav)} samples for cut {cut}")
        lsb = float((pcm - plain_pcm).abs().max())
        kern = _f32_say_model(cfg_path, ckpt, quant, False)
        ref = _f32_say_model(cfg_path, ckpt, quant, True)
        if kern.n_frames != ref.n_frames or not torch.equal(kern.lengths, ref.lengths):
            raise SmokeFailure(f"32-true say {tag}: the kernels' decode stops at "
                               f"{kern.n_frames} / {kern.lengths.tolist()}, the plain one at "
                               f"{ref.n_frames} / {ref.lengths.tolist()}")
        pairs = [("mels_post", kern.mels_post, ref.mels_post), ("gates", kern.gates, ref.gates)]
        if quant:  # int8 quanta that flip over 256 frames: reported, as K5's 64-step chunks
            mel_err = {k: err(a, b, True)[1] for k, a, b in pairs}
            print(f"  32-true say int8: mels against the plain int8 decode {mel_err} (reported)")
        else:
            mel_err = {"worst": check("say_32true_f32_mels", pairs, K1F_CHUNK_TOL, log,
                                      "heads_f32", own=True)}
        # the whole plain path (plain decode, plain vocode) against the say's WAV: reported
        full_plain = cut_vocode(h32, ref.mels_post, [0], [cut], vocode_bucket(h32, cut),
                                plain=True)[0, :cut * 256].long().cpu()
        lsb_path = float((pcm - full_plain).abs().max())
        perf = {"rtf": res["say_s"] / res["audio_s"],
                "decode_us_per_frame": res["decode_s"] / n * 1e6,
                "vocoder_us_per_frame": res["vocode_s"] / cut * 1e6, "say_s": res["say_s"],
                "audio_s": res["audio_s"], "card": card}
        print(f"  32-true say {tag}: WAV against the plain f32 vocode of its mel max {lsb:.0f} "
              f"LSB (limit {VOCODE_F32_LSB}); against the plain decode's plain vocode max "
              f"{lsb_path:.0f} LSB (reported); RTF {perf['rtf']:.4f}, decode "
              f"{perf['decode_us_per_frame']:.1f} us/frame (host clock) on {card}")
        if not lsb <= VOCODE_F32_LSB:
            raise SmokeFailure(f"32-true say {tag}: WAV {lsb} LSB from the plain vocode")
        out[tag] = {"launches": k1, "perf": perf, "vs_plain_vocode_lsb": lsb,
                    "vs_plain_path_lsb": lsb_path, "mels_vs_plain": mel_err, "run": res}
    log.setdefault("f32_decode", {})["say"] = out
    return out


def f32_rows_alone(cfg_path: str, ckpt: str, log: dict) -> dict:
    """Stage by stage, rows of a served window of K1F_WAVE rows against the
    same rows alone, both at the server's ``encode_rows`` (64), the 32-true
    model of ``ckpt`` in this process: the encoder's output, the decode's
    mels and the postnet's, each bit for bit or its largest difference
    (reported; ``f32_serve`` holds the WAVs). -> the readings"""
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.run.say import load_tacotron

    dev = torch.device("cuda")
    cfg = load_config(cfg_path)
    model = load_tacotron(cfg, ckpt, dev)
    ci, cl = serve_batch(cfg, K1F_WAVE, dev)
    gens = lambda rows: [torch.Generator(device=dev).manual_seed(300 + r) for r in rows]
    run = lambda rows: model.forward_infer_fast(ci[rows], cl[rows], K1F_FRAMES,
                                                row_generators=gens(rows), encode_rows=64)
    full = run(list(range(K1F_WAVE)))
    enc_full = model._encode(ci, cl, rows=64)[0]
    out: dict = {}
    for r in (0, 5, K1F_WAVE - 1):
        one = run([r])
        enc_one = model._encode(ci[r:r + 1], cl[r:r + 1], rows=64)[0]
        diff = lambda a, b: 0.0 if torch.equal(a, b) else float((a - b).abs().max())
        out[f"row {r}"] = {"encoded": diff(enc_full[r:r + 1], enc_one),
                           "mels": diff(full.mels[r:r + 1], one.mels),
                           "mels_post": diff(full.mels_post[r:r + 1], one.mels_post)}
    print(f"  32-true rows of a {K1F_WAVE}-row window against alone (0.0: bit for bit): {out}")
    log.setdefault("f32_decode", {})["rows_alone"] = out
    del model
    return out


def f32_serve(cfg_path: str, ckpt: str, g_path: str, log: dict, card: str) -> dict:
    """The warm server in this process with one entry of the 32-true
    checkpoint: a warm-up request, a wave of K1F_WAVE concurrent requests
    (which must coalesce, on the f32 entries only), then each request alone,
    within K1F_SERVE_LSB of its batched audio. -> K1's f32 launches in the
    wave."""
    import concurrent.futures
    import os
    import threading

    import numpy as np

    from tacotron2_tpu_torch.audio.io import read_wav
    from tacotron2_tpu_torch.ops import decoder_loop as dl
    from tacotron2_tpu_torch.run import server as srv

    f32_rows_alone(cfg_path, ckpt, log)
    root = WORK / "serve_32true"
    root.mkdir(parents=True, exist_ok=True)
    config = {"models": [{"name": "vanilla-32-true", "config": cfg_path, "checkpoint": ckpt,
                          "hifi_gan_checkpoint": g_path, "max_len": K1F_FRAMES,
                          "multi_speaker": False, "controllable": False, "num_voices": 1}],
              "batching": {"enabled": True, "window_ms": 8, "max_batch": 64, "depth": 2},
              "warmup": False}
    cwd = os.getcwd()
    os.chdir(root)
    started, holder = threading.Event(), {}
    thread = threading.Thread(target=lambda: holder.setdefault("result", srv.do_server(
        0, config, "warm", host="127.0.0.1",
        on_start=lambda h: (holder.setdefault("httpd", h), started.set()))), daemon=True)
    pcm = lambda body: np.round(read_wav(str(root / body["path"]))[0] * 32768.0)
    try:
        thread.start()
        while not started.wait(0.5):
            if not thread.is_alive():
                raise SmokeFailure("the 32-true server did not start")
        port = holder["httpd"].server_address[1]
        status, body, _ = _post(port, {"text": TEXT, "model": 0, "seed": 1})
        if status != 200:
            raise SmokeFailure(f"32-true server warm-up: {status} {body}")
        payloads = [{"text": TRAIN_TEXTS[i % len(TRAIN_TEXTS)], "model": 0, "seed": 300 + i}
                    for i in range(K1F_WAVE)]
        barrier = threading.Barrier(K1F_WAVE)

        def one(p):
            barrier.wait()
            return _post(port, p)

        dl.reset_launches()
        calls0 = srv.BATCH_CALLS[0]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(K1F_WAVE) as ex:
            replies = list(ex.map(one, payloads))
        wall = time.perf_counter() - t0
        calls = srv.BATCH_CALLS[0] - calls0
        f32 = dict(dl.F32_LAUNCHES)
        bf16 = {k: v for k, v in dl.LAUNCHES.items() if v}
        if any(s != 200 for s, _, _ in replies) or not 1 <= calls < K1F_WAVE:
            raise SmokeFailure(f"32-true wave of {K1F_WAVE}: "
                               f"{[(s, b) for s, b, _ in replies][:2]}, {calls} decode launches")
        if bf16 or not all(f32[k] for k in ("prenet_f32", "lstm_cell_f32",
                                            "location_attention_f32", "heads_f32")):
            raise SmokeFailure(f"the 32-true wave launched f32 {f32}, bf16 {bf16}")
        lsb = []
        for p, (_, body, _) in zip(payloads, replies):
            st, solo, _ = _post(port, p)
            a, b = pcm(body), pcm(solo)
            if st != 200 or len(a) != len(b):
                raise SmokeFailure(f"32-true request {p['seed']} alone: {st}, {len(b)} samples, "
                                   f"batched {len(a)}")
            lsb.append(float(np.abs(a - b).max()))
    finally:
        if "httpd" in holder:
            holder["httpd"].shutdown()
        thread.join(60)
        os.chdir(cwd)
    wave = {"requests": K1F_WAVE, "decode_launches": calls, "wall_s": wall,
            "max_lsb_alone": max(lsb), "lsb_alone": lsb, "launches": f32, "card": card}
    print(f"  32-true server: a wave of {K1F_WAVE} in {calls} decode launches, {wall:.2f} s; "
          f"each request alone, max {max(lsb):.0f} PCM16 LSB from its batched audio on {card}")
    log.setdefault("f32_decode", {})["serve"] = wave
    if not max(lsb) <= K1F_SERVE_LSB:
        raise SmokeFailure(f"32-true served requests differ from alone by {max(lsb)} LSB > "
                           f"{K1F_SERVE_LSB}")
    return f32


@contextlib.contextmanager
def relu_branches(follow=None):
    """``torch.relu`` inside the block (the F32 train step's: the prenet's
    two layers, the encoder's three convs) records each call's input,
    detached, in the list it yields; with ``follow`` (one mask a call, as
    ``[x > 0 for x in ...]`` of another run's list) it takes those branches,
    ``torch.where(mask, x, 0)``, whose gradient is the mask, as relu's."""
    import torch

    saved, xs = torch.relu, []

    def relu(x):
        xs.append(x.detach().clone())
        if follow is None:
            return saved(x)
        if len(xs) > len(follow) or follow[len(xs) - 1].shape != x.shape:
            raise SmokeFailure(f"ReLU call {len(xs)} of {tuple(x.shape)} has no branches "
                               f"to follow ({len(follow)} recorded)")
        return torch.where(follow[len(xs) - 1].to(x.device), x, 0.0)

    torch.relu = relu
    try:
        yield xs
    finally:
        torch.relu = saved


def flip_reading(masks, xs) -> dict:
    """The elements of each ReLU call whose branch in ``masks`` (another
    run's x > 0) is not their own in ``xs``: their count, and their largest
    |x| over the call's max |x| (0 where none flipped)."""
    worst, n = 0.0, 0
    if len(masks) != len(xs):
        raise SmokeFailure(f"ReLU calls: {len(masks)} branches against {len(xs)} inputs")
    for m, x in zip(masks, xs):
        d = m.cpu() != (x > 0)
        n += int(d.sum())
        if d.any():
            worst = max(worst, float(x[d].abs().max() / x.abs().max()))
    return {"flips": n, "flip_rel": worst}


def f32_step_compare(cfg_path: str, ckpt: str, speech: Path, root: Path, log: dict,
                     draw: int = 0, variants=None, own_branches: bool = False,
                     flip_probe: bool = False) -> dict:
    """One F32 train step's loss and gradients on the card against the same
    step on the CPU: the 32-true model of ``ckpt``, K1F_STEP_B rows of the
    manifest under ``root`` (from row ``draw`` x K1F_STEP_B, masks from seed
    SEED + 72 + ``draw``), dropout off, the same LSTM masks, BatchNorm in
    train mode; within K1F_STEP_TOL. The CPU's step takes the card's ReLU
    branches (``relu_branches``), and each element whose own sign differs
    must lie within K1F_FLIP_REL of zero. Then the card's step with its
    teacher decode's LSTM and heads operands rounded to bf16 (a planted
    defect), whose reading on the loss and on the gradients must each be at
    least K1F_DEFECT_MARGIN x its limit, and the card's step with its
    prenet's weights rounded to bf16 (a defect before the ReLUs), whose
    branches against the CPU's inputs must read at least K1F_DEFECT_MARGIN x
    K1F_FLIP_REL. ``variants`` {name: (context, on the CPU too)}: the same
    step, both sides or the card's, inside each context, its readings
    reported. ``own_branches``: also the CPU's step on its own branches
    against the card's, reported. ``flip_probe``: for each ReLU call, the
    CPU's step on the card's branches but for the element nearest zero,
    flipped, against the card's (what one element on the other branch
    reads), reported. -> the readings"""
    import dataclasses

    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.data.loader import collate
    from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron2_tpu_torch.ops import train_decode as td
    from tacotron2_tpu_torch.run.say import model_config_from
    from tacotron2_tpu_torch.training import step
    from tacotron2_tpu_torch.training.checkpoint import load_model_state

    cfg = load_config(cfg_path)
    rows = read_manifest(str(root / "train.csv"))
    ds = manifest_dataset(cfg, rows, str(speech), cache_dir=str(root / "cache"))
    first = draw * K1F_STEP_B
    batch = collate([ds[i] for i in range(first, first + K1F_STEP_B)], 32, 128)
    mcfg = dataclasses.replace(model_config_from(cfg), dropout=0.0)
    gen = torch.Generator().manual_seed(SEED + 72 + draw)
    B, T = batch["mel"].shape[:2]
    masks = td.lstm_masks(T, B, mcfg.att_rnn_dim, gen, torch.device("cpu"))

    def run(dev, follow=None, prenet_bf16=False):
        model = Tacotron2(mcfg, Policy.from_string(cfg.training.precision))
        load_model_state(ckpt, model)
        model.to(dev).train()
        if prenet_bf16:  # the planted defect before the ReLUs
            with torch.no_grad():
                for i in (0, 3):
                    model.prenet[i].weight.copy_(model.prenet[i].weight.bfloat16().float())
        b = step.to_device(batch, dev)
        with torch.enable_grad(), relu_branches(follow) as xs:
            loss, _, _ = step._forward_loss(model, b, True, None,
                                            tuple(m.to(dev) for m in masks))
            loss.backward()
        return (float(loss.detach()), {k: p.grad.detach().cpu().double()
                                       for k, p in model.named_parameters()
                                       if p.grad is not None}, [x.cpu() for x in xs])

    def readings(a, b):
        (la, ga, _), (lb, gb, _) = a, b
        ks = sorted(gb)
        va, vb = (torch.cat([g[k].reshape(-1) for k in ks]) for g in (ga, gb))
        worst = max((float((ga[k] - gb[k]).abs().max() / gb[k].abs().max().clamp_min(1e-30)), k)
                    for k in ks)
        return {"loss": abs(la - lb) / abs(lb),
                "grads": float((va - vb).norm() / vb.norm()),
                "worst_tensor": worst[0], "worst_grad": worst[1]}

    branches = lambda res: [x > 0 for x in res[2]]

    def against_cpu(card):  # the CPU's step on the card's branches -> (CPU, readings)
        cpu = run(torch.device("cpu"), branches(card))
        return cpu, {**readings(card, cpu), **flip_reading(branches(card), cpu[2])}

    card = run(torch.device("cuda"))
    cpu, r = against_cpu(card)
    saved = td.lstm_cell_plain

    def bf16_operands(w, b, x1, x2, x3, c, ctl=None):  # the planted defect: bf16 operands
        bf = lambda t: None if t is None else t.to(torch.bfloat16).float()
        return saved(bf(w), b, bf(x1), bf(x2), bf(x3), c, bf(ctl))

    saved_heads = td.heads_plain

    def bf16_heads(w, b, h, c, act=None, ctl=None):
        return saved_heads(w, b, h, c, torch.bfloat16, ctl)

    td.lstm_cell_plain, td.heads_plain = bf16_operands, bf16_heads
    try:
        d = readings(run(torch.device("cuda")), cpu)
    finally:
        td.lstm_cell_plain, td.heads_plain = saved, saved_heads
    pre = run(torch.device("cuda"), prenet_bf16=True)
    dp = {**readings(pre, cpu), **flip_reading(branches(pre), cpu[2])}
    out = {"reading": r, "defect": d, "prenet_defect": dp, "draw": draw}
    if own_branches:
        out["own_branches"] = readings(card, run(torch.device("cpu")))
    for i in range(len(card[2]) if flip_probe else 0):
        follow = branches(card)
        x = card[2][i].reshape(-1)
        j = int(x.abs().argmin())
        flat = follow[i].reshape(-1).clone()
        flat[j] = ~flat[j]
        follow[i] = flat.reshape(follow[i].shape)
        out[f"flip_relu{i}"] = {**readings(card, run(torch.device("cpu"), follow)),
                                "x_rel": float(x[j].abs() / x.abs().max())}
    for name, (ctx, on_cpu) in (variants or {}).items():
        with ctx():
            v = run(torch.device("cuda"))
            out[name] = against_cpu(v)[1] if on_cpu else readings(v, cpu)
    extra = "".join(f"; {k}: loss {out[k]['loss']:.3e}, gradients {out[k]['grads']:.3e}"
                    for k in [*(["own_branches"] if own_branches else []), *(variants or {}),
                              *(k for k in out if k.startswith("flip_relu"))])
    print(f"  one F32 train step, card against CPU (B={B}, T={T}, draw {draw}): loss rel "
          f"{r['loss']:.3e}, gradients {r['grads']:.3e} (relative L2; worst tensor "
          f"{r['worst_tensor']:.3e} of its max, {r['worst_grad']}), {r['flips']} ReLU "
          f"elements on the card's branch at |x| <= {r['flip_rel']:.3e} of the max; limits "
          f"{K1F_STEP_TOL}, {K1F_FLIP_REL}; bf16 operands (defect): loss {d['loss']:.3e}, "
          f"gradients {d['grads']:.3e}; bf16 prenet weights (defect): {dp['flips']} flips at "
          f"|x| <= {dp['flip_rel']:.3e}, gradients {dp['grads']:.3e}{extra}")
    log.setdefault("f32_decode", {}).setdefault("step_vs_cpu", []).append(
        {**out, "tol": K1F_STEP_TOL, "flip_tol": K1F_FLIP_REL, "B": B, "T": T})
    for k, lim in K1F_STEP_TOL.items():
        if not r[k] <= lim:
            raise SmokeFailure(f"the F32 step on the card against the CPU: {k} {r[k]:.3e} > {lim}")
    if not r["flip_rel"] <= K1F_FLIP_REL:
        raise SmokeFailure(f"the F32 step: a ReLU element {r['flip_rel']:.3e} of its max from "
                           f"zero takes another branch on the card than on the CPU")
    if not min(d[k] / lim for k, lim in K1F_STEP_TOL.items()) >= K1F_DEFECT_MARGIN:
        raise SmokeFailure(f"the F32 step's limits do not tell bf16 operands from f32 ones: {d}")
    if not dp["flip_rel"] >= K1F_DEFECT_MARGIN * K1F_FLIP_REL:
        raise SmokeFailure(f"the F32 step's branch check does not tell bf16 prenet weights: {dp}")
    return out


@contextlib.contextmanager
def tf32_on():
    """TF32 on for matmuls and cuDNN inside the block (``use_f32_math``
    undone)."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def f32_train(cfg_path: str, log: dict, card: str) -> dict:
    """``train`` of the 32-true config through the CLI entry (batch 32, 64
    synthetic WAVs, K1F_TRAIN_STEPS steps), then ``train --finetune
    --finetune-steps 1 --max-steps 1`` of its checkpoint (two steps at twice
    the batch): finite losses, no K3 / K4 launch (JAX's XLA
    route, ``Tacotron2.teacher_route``), the step's ms on the host clock;
    then ``f32_step_compare``. -> the readings"""
    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.ops import train_decode as td

    root = WORK / "train_32true"
    speech = _synth_corpus(root, TRAIN_WAVS)
    rows = ["text|wav"] + [f"{TRAIN_TEXTS[i % len(TRAIN_TEXTS)]}|s{i:03d}.wav"
                           for i in range(TRAIN_WAVS)]
    cfg_train = train_setup(root, json.loads(Path(cfg_path).read_text()), rows, 32)
    base = ["train", "--config", str(cfg_train), "--speech-dir", str(speech), "--seed", str(SEED)]
    td.reset_launches()
    first = cli(base + ["--results-dir", str(root / "r1"), "--max-steps", str(K1F_TRAIN_STEPS)])
    ft = cli(base + ["--results-dir", str(root / "ft"), "--resume-ckpt", first["checkpoint"],
                     "--finetune", "--finetune-steps", "1", "--max-steps", "1"])
    k34 = dict(td.LAUNCHES)
    steps = first["steps"] + ft["steps"]
    losses = [s["loss"] for s in steps]
    if (any(k34.values()) or not all(math.isfinite(x) for x in losses)
            or len(first["steps"]) != K1F_TRAIN_STEPS or not ft["steps"]):
        raise SmokeFailure(f"32-true train: K3/K4 launches {k34}, losses {losses}")
    step_ms = [s["s"] * 1e3 for s in first["steps"][1:]]
    perf = {"ms_per_step": step_ms, "ms_per_step_median": sorted(step_ms)[len(step_ms) // 2],
            "finetune_ms": ft["steps"][0]["s"] * 1e3, "rows": [s["rows"] for s in steps],
            "decode_frames": [s["decode_frames"] for s in steps], "card": card}
    print(f"  32-true train: losses {[round(x, 4) for x in losses]}, no K3/K4 launch; "
          f"{perf['ms_per_step_median']:.1f} ms a step (host clock, B=32), finetune "
          f"{perf['finetune_ms']:.1f} ms on {card}")
    setup = (str(cfg_train), first["checkpoint"], speech, root)
    cmp_ = f32_step_compare(*setup, log)
    out = {"losses": losses, "k34_launches": k34, "perf": perf, "step_vs_cpu": cmp_}
    log.setdefault("f32_decode", {})["train"] = out
    return {**out, "setup": setup}


def f32_decode_phase(log: dict, card: str, copies=None) -> tuple:
    """Phase 4m: a 32-true copy of the flagship config (random weights, gate
    bias 10, seed SEED) on the card: every f32 entry against its plain f32
    version (``k1f_entries``), the f32 and int8 chunks (``k1f_chunks``), the
    32-true say bf16 and int8 (``f32_say``), a served wave
    (``f32_serve``), train and finetune (``f32_train``). -> (the kernels-line
    rows of the f32 entries, their launches on the main path: the says'
    and the wave's)"""
    import torch

    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning

    t0 = time.perf_counter()
    cfg_path = write_f32_config()
    cfg = load_config(cfg_path)
    model = random_tacotron(cfg, 10.0).cuda()
    raw = json.loads((ROOT / "config" / CTL_CONFIG).read_text())
    raw["training"]["precision"] = "32-true"
    ctl_path = WORK / "controllable-32-true.json"
    ctl_path.write_text(json.dumps(raw))
    ctl_model = random_tacotron(load_config(str(ctl_path)), 10.0, SEED + 1).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {F32_CONFIG} at 32-true: {n_params} parameters, policy "
          f"{model.policy.compute_dtype}")
    timing = k1f_entries(model, ctl_model, log, copies)
    chunks = k1f_chunks(model, log)
    del ctl_model
    ckpt = str(WORK / "tacotron2-32true.ckpt")
    torch.save(to_lightning(model.state_dict()), ckpt)
    del model
    torch.cuda.empty_cache()
    g_path = write_hifigan()
    said = f32_say(cfg_path, ckpt, g_path, log, card)
    served = f32_serve(cfg_path, ckpt, g_path, log, card)
    trained = f32_train(cfg_path, log, card)
    launches = {k: said["f32"]["launches"].get(k, 0) + said["int8"]["launches"].get(k, 0)
                + served.get(k, 0) for k in K1F_REPLACES}
    rows = []
    for name, per in timing.items():
        one = per["B1"]
        rows.append({"name": name, "route": "cuda", "source": K1F_SOURCE,
                     "replaces": K1F_REPLACES[name],
                     **{k: one[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "eager_ms")},
                     "per": f"{name} at B=1, L=96 (f32 weights; library: "
                            + ("nn.LSTMCell x2 f32" if name == "lstm_cell_f32" else
                               "none" if name == "location_attention_f32" else "F.linear f32")
                            + ", TF32 off)", "rows": per})
        if not launches.get(name):
            raise SmokeFailure(f"{name} was not launched on the 32-true path: {launches}")
    log.setdefault("f32_decode", {}).update({"chunks": chunks, "launches": launches,
                                             "seconds": time.perf_counter() - t0})
    print(f"  4m took {time.perf_counter() - t0:.1f} s; f32 launches on the path {launches}")
    return rows, launches, {"say": {k: v["perf"] for k, v in said.items()},
                            "train": trained["perf"], "chunks": chunks}


def f32_decode_mode() -> int:
    """``--f32-decode``: the kernels' build and phase 4m alone; details to
    ``chiprun_out/f32_decode.json``."""
    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build

    card = card_line()
    print(f"[4m] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    t0 = time.perf_counter()
    copies = k1f_copies()
    logs = build.build_all()
    log: dict = {"card": card, "build_s": time.perf_counter() - t0,
                 "ptxas_kernels": {"decode_step": ptxas_kernels(logs["decode_step"])}}
    print(f"  built in {log['build_s']:.1f} s")
    for k, v in log["ptxas_kernels"]["decode_step"].items():
        print(f"    decode_step: {k}: {v['registers']} registers, {v['smem']} bytes static smem, "
              f"stack frame {v['stack']} bytes, spills {v['spill_stores']} / "
              f"{v['spill_loads']} bytes")
    rows = []
    try:
        rows, launches, readings = f32_decode_phase(log, card, copies)
        log.update({"rows": rows, "launches": launches, "readings": readings})
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        log["seconds"] = time.perf_counter() - t0
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "f32_decode.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
        with contextlib.suppress(SmokeFailure):
            copies()
    print(f"  4m took {log['seconds']:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                                     "library_ms", "rows")} for r in rows],
                      "launches": launches}))
    print(card)
    return 0


def f32_step_mode() -> int:
    """``--f32-step``: phase 4m's train part alone (``f32_train``: its
    step against the CPU's at draw 0), the same comparison at draws 1 to
    K1F_STEP_DRAWS - 1 (other rows and masks) with the CPU also on its own
    ReLU branches, and at draw 0 with the encoder's BiLSTM as torch's packed
    LSTM on both sides (``cudnn_bilstm``), with TF32 on on the card
    (``tf32_on``), and with one element of each ReLU call on the other
    branch (``flip_probe``): the readings that set K1F_STEP_TOL and
    K1F_FLIP_REL, and what moves them. -> chiprun_out/f32_step.json"""
    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math

    card = card_line()
    print(f"[4m train] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    t0 = time.perf_counter()
    log: dict = {"card": card}
    try:
        setup = f32_train(write_f32_config(), log, card)["setup"]
        for draw in range(1, K1F_STEP_DRAWS):
            f32_step_compare(*setup, log, draw, own_branches=True)
        f32_step_compare(*setup, log, 0, {"packed_encoder": (cudnn_bilstm, True),
                                          "tf32_on": (tf32_on, False)}, own_branches=True,
                         flip_probe=True)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        log["seconds"] = time.perf_counter() - t0
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "f32_step.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"  took {log['seconds']:.1f} s")
    print(card)
    return 0


# ---------------------------------------------------------------------------
# phase 4n: K2 at every shape JAX's stage kernel takes, JAX's XLA routes
# around it, and a model whose two decoder LSTMs differ in width
# ---------------------------------------------------------------------------

C2_ROWS = (1, 16)  # the say's one row and a serve window's rows
C2_FRAMES = 128  # the vocode bucket of the checks and the timings
C2_INVARIANCE_ROWS = (0, 1, 15)  # rows of a 16-row vocode held bit for bit against alone
C2_SEED = {name: SEED + 101 + i for i, name in enumerate(C2_GENERATORS)}
C2_KERNEL_GENS = ("c2_wide", "c2_deep")  # the generators whose narrow entries get rows
# planted defects of the narrow kernel's narrow_mma_kernel route: copies of
# csrc/mrf_narrow.cu whose epilogue leaves the last channel of a partial last
# n8 tile out, and whose operand staging fills the k tile's pad channels with
# the channels past Ci (the next row's) instead of zeros; with NARROW_DEFECTS'
# narrow_one_pass (f32 only: one TF32 pass, a_hi w_hi, of the three), each
# with the dtypes it is held in
NARROW_SHAPE_DEFECTS = (
    ("narrow_partial_group", [(r"const int ncols = Co - n0 < p\.ct \* 8 \? Co - n0 : p\.ct \* 8;",
                               "const int ncols = Co - n0 < p.ct * 8 ? Co - n0 - 1 : p.ct * 8;")]),
    ("narrow_past_ci", [(r"slab\[r \* pe \+ ch\] = op_zero<Op>\(\);",
                         "slab[r * pe + ch] = a[((size_t)b * T + x0 + r) * Ci + c0 + ch];")]),
)
SHAPE_DEFECT_MODES = {"narrow_partial_group": ("f32", "bf16"), "narrow_past_ci": ("f32", "bf16"),
                      "narrow_one_pass": ("f32",)}
C2_DEFECT_SHAPE = (7, 25, 25, 16, 512)  # K, Co, Ci, rows, frames: a last n8 tile of 1, Ci_pad 32
C3_RNN = 768  # rnn_hidden_dim of the C3 model (att_rnn_dim stays 1024)
C3_FRAMES = 256  # its say's forced decode
C3_EXPORT = (8, 96, 128)  # rows, chars, frames of its train_mel_export batch
# the batch on the card against the CPU's, of mels_post's max: device drift
# only (both run the same stock-op scan; tests/test_torch_lstm_widths.py holds
# that scan against the JAX package's forward_teacher)
C3_EXPORT_TOL = 5e-3
C2_REPLACES = ("tacotron2_tpu/ops/mrf_pallas.py:285,378 (the stage kernels at any C: the phase "
               "fold s = 128 / C where 128 % C == 0, else unfolded, :440; the aligned "
               "upsample's fold :516-517)")


def shape_copies():
    """Start nvcc of the NARROW_SHAPE_DEFECTS copies of csrc/mrf_narrow.cu
    (under build/shape_defects) -> a function that waits: {name: library}."""
    return build_copies("mrf_narrow", NARROW_SHAPE_DEFECTS, ROOT / "build" / "shape_defects",
                        wait=False)


@contextlib.contextmanager
def nan_outputs():
    """Every float tensor ``torch.empty`` makes inside the block starts as
    NaN, so an output a kernel leaves unwritten reads as NaN, not as stale
    memory that may hold the right values."""
    import torch

    empty = torch.empty

    def poisoned(*args, **kwargs):
        t = empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    torch.empty = poisoned
    try:
        yield
    finally:
        torch.empty = empty


def defect_reading(got, ref) -> float:
    """max |got - ref| over max |ref|, a non-finite element reading inf."""
    import torch

    d = (got.float() - ref.float()).abs()
    d = torch.where(d.isfinite(), d, torch.full_like(d, float("inf")))
    return float(d.max()) / max(float(ref.float().abs().max()), 1e-30)


def shape_defects(copies, narrow, log: dict) -> None:
    """The planted defects (``copies``: NARROW_SHAPE_DEFECTS', ``narrow``:
    NARROW_DEFECTS' narrow_one_pass) on one conv of C2_DEFECT_SHAPE (Co =
    25: a last n8 tile of one channel; Ci = 25: 7 pad channels in the k
    tile), in the modes SHAPE_DEFECT_MODES names, each at least
    K2F_DEFECT_MARGIN x the
    limit (K2F_TOL / K2_TOL). The weight copy's pads (past Co and Ci) hold
    random numbers, not zeros: the right kernel's operand is zero in the pad
    channels, so they add nothing, and a kernel that stages other numbers
    there reads them. The operand is a view into a buffer with random data
    past its end, so a read past Ci stays in bounds and reads other numbers."""
    import torch

    from tacotron2_tpu_torch.ops import mrf

    K, Co, Ci, B, T = C2_DEFECT_SHAPE
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 110)
    libs = {**copies(), "narrow_one_pass": narrow()["narrow_one_pass"]}
    for dt, lim in ((torch.float32, K2F_TOL), (torch.bfloat16, K2_TOL)):
        tag = "f32" if dt == torch.float32 else "bf16"
        slack = lambda n: torch.randn(n + 4096, device="cuda", generator=g).to(dt)
        a = slack(B * T * Ci)[:B * T * Ci].view(B, T, Ci)
        w = (torch.randn(K, Co, Ci, device="cuda", generator=g) * 0.2).to(dt)
        wt = mrf.tile_conv(w)
        pads = torch.ones(wt.shape, dtype=torch.bool, device="cuda")
        pads[:, :, :Co, :Ci] = False
        wt = torch.where(pads, torch.randn(wt.shape, device="cuda", generator=g).to(dt), wt)
        cw = mrf.ConvWeights(w, torch.randn(Co, device="cuda", generator=g) * 0.1, 1, wt)
        res = torch.randn(B, T, Co, device="cuda", generator=g)
        ref = mrf.mrf_conv_plain(a, cw, res, want_act=True)
        got = mrf.mrf_conv(a, cw, res, want_act=True)
        check(f"narrow_conv[defect shape {tag}]@B{B}", [("y", got[0], ref[0])], lim, log,
              f"narrow_conv{'_f32' if tag == 'f32' else ''}[c2_wide]", dt == torch.float32)
        for name, path in libs.items():
            if tag not in SHAPE_DEFECT_MODES[name]:
                continue
            with narrow_library(path), nan_outputs():
                d = mrf.mrf_conv(a, cw, res, want_act=True)
            r = min(defect_reading(d[0], ref[0]), defect_reading(d[1], ref[1]))
            log.setdefault("c2_defects", {})[f"{name}[{tag}]"] = {"rel_err": r, "tol": lim}
            print(f"  planted defect {name} [{tag}] at K={K}, Co={Co}, Ci={Ci}: {r:.3e} "
                  f"({r / lim:.3g}x the limit {lim:g})")
            if not r >= K2F_DEFECT_MARGIN * lim:
                raise SmokeFailure(f"the planted defect {name} [{tag}] reads {r:.3e}, under "
                                   f"{K2F_DEFECT_MARGIN:g} x {lim:g}")


def c2_path(tag: str, h: dict, gens: dict, log: dict) -> dict:
    """The main path of a C2 generator: one vocode of a 255-frame cut
    through ``cut_vocode`` (the say's and the server's vocode) in each mode,
    every counter set to 0 just before and read just after: K2 held to
    ``vocode_launches(h)`` of the mode (none of the other) and the stock
    routes to ``vocode_routes(h)``; the PCM finite and not silent. ->
    {mode: the launches}."""
    import torch

    from tacotron2_tpu_torch.ops import mrf
    from tacotron2_tpu_torch.run.say import cut_vocode, vocode_bucket

    g = torch.Generator(device="cuda")
    g.manual_seed(C2_SEED[tag] + 50)
    mel = torch.randn(1, 256, h["num_mels"], device="cuda", generator=g)
    out = {}
    for mode, gen in gens.items():
        Tb = vocode_bucket(gen, 255)
        mrf.reset_launches()
        pcm = cut_vocode(gen, mel, [0], [255], Tb)
        got = {**mrf.LAUNCHES, **mrf.F32_LAUNCHES}
        routes = dict(mrf.STOCK_ROUTES)
        check_vocode_launches(got, 1, f"the {tag} {mode} vocode", gen.policy.compute_dtype, h)
        if routes != vocode_routes(h):
            raise SmokeFailure(f"the {tag} {mode} vocode took the stock routes {routes}, want "
                               f"{vocode_routes(h)}")
        peak = int(pcm.abs().max())
        if not 0 < peak < 32767:
            raise SmokeFailure(f"the {tag} {mode} vocode: PCM peak {peak}")
        out[mode] = {k: v for k, v in got.items() if v}
        log.setdefault("c2", {}).setdefault(tag, {})[f"path_{mode}"] = {
            "launches": out[mode], "routes": routes, "Tb": Tb, "pcm_peak": peak}
    print(f"  {tag}: a vocode through cut_vocode, K2 f32 {out['f32']}, bf16 {out['bf16']}, "
          f"stock routes {vocode_routes(h)}")
    return out


def c2_even_check(tag: str, gens: dict, g, log: dict) -> None:
    """The even-k generator, JAX's XLA generator on stock ops: its card run
    (cuDNN, TF32 off) against the same function on the CPU, one row, f32
    within K2F_TOL of the output's max, bf16 within K2_TOL."""
    import copy

    import torch

    mel = torch.randn(1, C2_FRAMES, gens["f32"].cfg.num_mels, device="cuda", generator=g)
    for mode, gen in gens.items():
        cpu = copy.deepcopy(gen).cpu()
        tol = K2F_TOL if mode == "f32" else K2_TOL
        ref = cpu.apply(mel.cpu()).to(mel.device)
        check(f"generator_stock[{tag} {mode}]@B1", [("wav", gen.apply(mel), ref)], tol, log,
              f"generator_stock[{tag}]", mode == "f32")


def c3_part(g_deep: str, log: dict, card: str) -> dict:
    """A model whose two decoder LSTMs differ in width: the flagship config
    with rnn_hidden_dim C3_RNN, random weights, gate bias 10. ``say`` with
    the c2_deep vocoder through the CLI (the forced C3_FRAMES decode, a
    warm-up then counted): no K1 launch, one ``decode_stock``, K2 held to
    ``vocode_launches(C2_DEEP)``; ``say --quantize-int8`` refused; one
    ``train_mel_export`` batch (``forward_teacher(train=False)``, C3_EXPORT)
    on the card against the CPU's, the prenet's AlwaysDropout bits drawn on
    the CPU for both (C3_EXPORT_TOL of mels_post's max), on the stock-op
    scan with no K3 launch; ``train`` refused at start. -> the vocoder's
    launches in the say."""
    import copy

    import torch

    from tacotron2_tpu_torch.__main__ import main as cli
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.convert import to_lightning
    from tacotron2_tpu_torch.models import tacotron2 as t2
    from tacotron2_tpu_torch.ops import decoder_loop, mrf, train_decode, train_scan
    from tacotron2_tpu_torch.parallel import mesh
    from tacotron2_tpu_torch.run.train import do_train

    raw = json.loads((ROOT / "config" / "vanilla-ljspeech-stop.json").read_text())
    raw["model"]["args"]["rnn_hidden_dim"] = C3_RNN
    cfg_path = WORK / "c3.json"
    cfg_path.write_text(json.dumps(raw))
    cfg = load_config(str(cfg_path))
    model = random_tacotron(cfg, 10.0)
    ckpt = str(WORK / "c3.ckpt")
    torch.save(to_lightning(model.state_dict()), ckpt)
    out = str(WORK / "say_c3.wav")
    args = ["say", "--config", str(cfg_path), "--checkpoint", ckpt, "--hifi-gan-checkpoint", g_deep,
            "--text", TEXT, "--out", out, "--random-seed", str(SEED), "--max-len-override",
            str(C3_FRAMES)]
    cli(args)  # warm-up
    mrf.reset_launches()
    decoder_loop.reset_launches()
    stock0 = t2.STOCK_ROUTES["decode_stock"]
    res = cli(args)
    k1 = {**decoder_loop.LAUNCHES, **decoder_loop.F32_LAUNCHES}
    k2 = {**mrf.LAUNCHES, **mrf.F32_LAUNCHES}
    stock = t2.STOCK_ROUTES["decode_stock"] - stock0
    print(f"  say of the C3 model (att_rnn_dim 1024, rnn_hidden_dim {C3_RNN}) with c2_deep: "
          f"{res['n_frames']} frames, RTF {res['say_s'] / res['audio_s']:.4f} on {card}; K1 "
          f"launches {sum(k1.values())}, stock decodes {stock}, K2 "
          f"{ {k: v for k, v in k2.items() if v} }")
    if any(k1.values()) or stock != 1 or res["n_frames"] != C3_FRAMES:
        raise SmokeFailure(f"say of the C3 model: K1 {k1}, {stock} stock decodes, "
                           f"{res['n_frames']} frames")
    check_vocode_launches(k2, 1, "say of the C3 model", h=C2_DEEP)
    try:
        cli(args + ["--quantize-int8"])
        raise SmokeFailure("say --quantize-int8 of the C3 model did not raise")
    except ValueError as e:
        refused_int8 = str(e)
    # one train_mel_export batch, card against CPU, the dropout bits from the CPU
    B, L, T = C3_EXPORT
    cg = torch.Generator().manual_seed(SEED + 120)
    chars = torch.randint(1, cfg.num_chars, (B, L), generator=cg)
    lens = torch.randint(L // 2, L + 1, (B,), generator=cg)
    lens[0] = L
    mel = torch.randn(B, T, 80, generator=cg) * 0.5
    mel_len = torch.randint(T // 2, T + 1, (B,), generator=cg)
    mel_len[0] = T
    rand_rows = mesh.rand_rows

    def run(m, dev):
        bits = torch.Generator().manual_seed(SEED + 121)
        mesh.rand_rows = lambda shape, generator, device, axis=0: torch.rand(
            tuple(shape), generator=bits).to(device)
        try:
            with torch.no_grad():
                o = m.forward_teacher(chars.to(dev), lens.to(dev), mel.to(dev), mel_len.to(dev),
                                      train=False)
        finally:
            mesh.rand_rows = rand_rows
        return o.mels_post.cpu()

    k3 = dict(train_decode.LAUNCHES)
    scan0 = train_scan.STOCK_ROUTES["teacher_scan"]
    gpu_model = copy.deepcopy(model).to("cuda")
    t0 = time.perf_counter()
    got = run(gpu_model, torch.device("cuda"))
    card_s = time.perf_counter() - t0
    k3_after = {k: train_decode.LAUNCHES[k] - k3[k] for k in k3}
    scans = train_scan.STOCK_ROUTES["teacher_scan"] - scan0
    ref = run(model, torch.device("cpu"))
    a = float((got - ref).abs().max())
    rel = a / float(ref.abs().max())
    print(f"  the C3 model's train_mel_export batch (B={B}, L={L}, T={T}, forward_teacher("
          f"train=False)) on the card against the CPU: mels_post {rel:.3e} of its max (tol "
          f"{C3_EXPORT_TOL:g}), {scans} stock-op scans, K3 {k3_after}, {card_s:.2f} s on {card}")
    log.setdefault("checks", []).append({"kernel": "teacher_scan[c3]", "check": "c3 export",
                                         "output": "mels_post", "max_abs_err": a, "rel_err": rel,
                                         "tol": C3_EXPORT_TOL})
    if not (rel <= C3_EXPORT_TOL and scans == 1 and not any(k3_after.values())):
        raise SmokeFailure(f"the C3 export batch: {rel:.3e} > {C3_EXPORT_TOL:g}, or {scans} "
                           f"scans and K3 {k3_after}")
    try:
        do_train(cfg, raw, str(WORK), results_dir=str(WORK / "c3_train"), device="cuda")
        raise SmokeFailure("train of the C3 model did not raise")
    except ValueError as e:
        refused_train = str(e)
    if "train step" not in refused_train or "differ" not in refused_int8:
        raise SmokeFailure(f"the C3 refusals: {refused_train!r}, {refused_int8!r}")
    log["c3"] = {"say": res, "k1": k1, "k2": k2, "export_rel": rel, "export_card_s": card_s,
                 "refused_int8": refused_int8, "refused_train": refused_train}
    del gpu_model
    return {k: v for k, v in k2.items() if v}


def vocoder_shapes_phase(log: dict, card: str, copies, narrow) -> tuple:
    """Phase 4n: the C2 generators (C2_GENERATORS, random weights from the
    seed as ``g_*`` files, each in f32 and bf16): every K2 entry and stage
    against its plain version at C2_ROWS rows of a C2_FRAMES bucket (f32
    within K2F_TOL, bf16 within K2_TOL; ``v2v3_stages``), rows
    C2_INVARIANCE_ROWS of a 16-row vocode bit for bit alone (the kernel
    generators), the even-k generator's stock route on the card against the
    CPU, the planted defects (``shape_defects``; NARROW_DEFECTS at
    ``c2_deep``'s small-route calls at one row, ``narrow``), each generator's vocode
    with exact launch counts per route (``c2_path``), the C3 model
    (``c3_part``), and the narrow entries of C2_KERNEL_GENS timed at C2_ROWS
    rows beside cuDNN f32 and bf16 and the bound (``k2_timing``). -> (the
    kernels-line rows ``narrow_*[tag]``, their launches on the path)."""
    import torch

    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.run.say import load_hifigan

    dev = torch.device("cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 100)
    WORK.mkdir(parents=True, exist_ok=True)
    rows, launches, paths = [], {}, {}
    t0 = time.perf_counter()
    shape_defects(copies, narrow, log)
    defects: dict = {}
    for tag, h in C2_GENERATORS.items():
        t_gen = time.perf_counter()
        g_path = write_hifigan(h, f"hifigan_{tag}", C2_SEED[tag])
        gens = {"f32": load_hifigan(g_path, dev), "bf16": load_hifigan(g_path, dev,
                                                                        Policy(torch.bfloat16))}
        if tag == "c2_deep":
            log.setdefault("c2", {})["g_deep"] = g_path
        if not gens["f32"].odd:
            c2_even_check(tag, gens, g, log)
        else:
            label = lambda key, tag=tag: f"{key}[{tag}]"
            for B in C2_ROWS:
                for mode, gen in gens.items():
                    libs = narrow() if tag == "c2_deep" and B == 1 else None
                    for k, v in v2v3_stages(gen, tag, C2_FRAMES, B, g, log, libs,
                                            label).items():
                        defects.setdefault(f"{k}[{mode}]", []).extend(v)
            if tag == "c2_deep":
                hold_narrow_defects(defects, log, "4n c2_deep")
            if tag in C2_KERNEL_GENS:
                for gen in gens.values():
                    v2v3_invariance(gen, tag, C2_FRAMES, g, C2_INVARIANCE_ROWS)
        paths[tag] = c2_path(tag, h, gens, log)
        torch.cuda.empty_cache()
        if tag in C2_KERNEL_GENS:
            for mode, gen in gens.items():
                named = {}
                for B in C2_ROWS:
                    for r in k2_timing(gen, C2_FRAMES, B, B == 1, (2, 2), True):
                        if not r["name"].startswith("narrow"):
                            continue
                        name = f"{r['name']}[{tag}]"
                        entry = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "library_bf16_ms", "eager_ms",
                                                   "traffic_ms", "per") if k in r}
                        row = named.setdefault(name, {**r, "name": name, "rows": {},
                                                      "replaces": C2_REPLACES})
                        row["rows"][f"B{B}"] = entry
                        print(f"  {name} at {B} rows, Tb={C2_FRAMES}: {r['ms']:.4f} ms, plain "
                              f"{ms_text(r['plain_ms'])}, cuDNN f32 {r['library_ms']:.4f}"
                              + (f", bf16 {r['library_bf16_ms']:.4f}"
                                 if r.get("library_bf16_ms") else "")
                              + f", bound {r['bound_ms']:.4f} ({r['bound_by']}) on {card}")
                for row in named.values():  # the kernels line: one row, the rest in "rows"
                    row.update({k: row["rows"]["B1"][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "eager_ms",
                        "traffic_ms", "per")})
                    rows.append(row)
            torch.cuda.empty_cache()
        del gens
        log.setdefault("c2", {}).setdefault(tag, {})["seconds"] = time.perf_counter() - t_gen
        print(f"  {tag}: {log['c2'][tag]['seconds']:.1f} s")
    print(f"[4n] the C3 model (rnn_hidden_dim {C3_RNN}): say, a train_mel_export batch, train")
    t_c3 = time.perf_counter()
    say_k2 = c3_part(log["c2"]["g_deep"], log, card)
    log["c3"]["seconds"] = time.perf_counter() - t_c3
    for k, n in say_k2.items():
        paths["c2_deep"]["f32"][k] = paths["c2_deep"]["f32"].get(k, 0) + n
    for tag in C2_KERNEL_GENS:
        for mode, counts in paths[tag].items():
            launches.update({f"{k}[{tag}]": n for k, n in counts.items() if k.startswith("narrow")})
    for r in rows:
        if not launches.get(r["name"]):
            raise SmokeFailure(f"{r['name']} was not launched on the C2 path: {launches}")
    log["c2_seconds"] = time.perf_counter() - t0
    print(f"  4n took {log['c2_seconds']:.1f} s")
    return rows, launches


def vocoder_shapes_mode() -> int:
    """``--vocoder-shapes``: the kernels' build and phase 4n alone; details
    to ``chiprun_out/vocoder_shapes.json``."""
    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build

    card = card_line()
    print(f"[4n] alone on {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    use_f32_math()
    t0 = time.perf_counter()
    copies, narrow = shape_copies(), narrow_copies()
    logs = build.build_all()
    log: dict = {"card": card, "build_s": time.perf_counter() - t0,
                 "ptxas_kernels": {"mrf_narrow": ptxas_kernels(logs["mrf_narrow"])}}
    print(f"  built in {log['build_s']:.1f} s; mrf_narrow: {log['ptxas_kernels']['mrf_narrow']}")
    try:
        WORK.mkdir(parents=True, exist_ok=True)
        rows, launches = vocoder_shapes_phase(log, card, copies, narrow)
        for r in rows:
            r["launches"] = launches[r["name"]]
            r["max_abs_err"] = max(c["max_abs_err"] for c in log["checks"]
                                   if c["kernel"] == r["name"])
        log.update({"rows": rows, "launches": launches})
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        log["seconds"] = time.perf_counter() - t0
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "vocoder_shapes.json").write_text(json.dumps(log, indent=1, default=str))
        shutil.rmtree(WORK, ignore_errors=True)
        with contextlib.suppress(SmokeFailure):
            copies(), narrow()
    print(json.dumps({"kernels": [{k: r[k] for k in ("name", "launches", "max_abs_err", "ms",
                                                     "plain_ms", "bound_ms", "library_ms",
                                                     "rows")} for r in rows]}))
    print(card)
    return 0


def arg_value(flag: str, default: str) -> str:
    argv = sys.argv[1:]
    return argv[argv.index(flag) + 1] if flag in argv else default


def ab_turns(rows_flag: str, prefix: str, extra=lambda i: []):
    """The parent's package (a ``git archive`` of it unpacked into
    build/parent) against this tree's, in turns parent, change, change,
    parent, each a ``rows_flag`` process of its own (the two packages share
    a name) with ``extra(i)`` added to turn i's arguments -> each turn's
    JSON (chiprun_out/<prefix>_<i>_<tag>.json) with its turn, tag and exit
    code; None where build/parent holds no package."""
    parent = ROOT / "build" / "parent"
    if not (parent / "tacotron2_tpu_torch").is_dir():
        print(f"FAIL: no parent package under {parent}", file=sys.stderr)
        return None
    turns = []
    for i, (tag, root) in enumerate((("parent", parent), ("change", ROOT), ("change", ROOT),
                                     ("parent", parent))):
        out = f"{prefix}_{i}_{tag}.json"
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), rows_flag,
                               "--root", str(root), "--out", out, *extra(i)], timeout=900)
        path = OUT_DIR / out
        turns.append({"turn": i, "tag": tag, "rc": proc.returncode,
                      **(json.loads(path.read_text()) if path.exists() else {})})
    OUT_DIR.mkdir(exist_ok=True)
    return turns


def k1_ab() -> int:
    """``--k1-ab``: the parent's K1/K5 and encoder forward against this
    tree's in turns (``ab_turns`` of ``--k1-rows``; the second change turn
    adds ``cell_ab``); the results go to chiprun_out/k1_ab.json. Fails
    unless the prenet's outputs have the same bits in every turn and each
    tree's vanilla chunks repeat theirs (the heads' split-K sums change the
    chunks' bits from the parent's; whether they equal is reported)."""
    # this tree's CELL_AB copies, once
    turns = ab_turns("--k1-rows", "k1_rows", lambda i: ["--cell-ab"] if i == 2 else [])
    if turns is None:
        return 2
    print("[k1-ab] in turns (us; window decode ms):")
    for t in turns:
        cells = t.get("cells", {})
        split = t.get("serve_rows_split", {})
        print(f"  {t['turn']} {t['tag']:<6} rc {t['rc']} "
              + " ".join(f"{k}:" + "/".join(f"{r['ms'] * 1e3:.1f}" for r in v.values() if "ms" in r)
                         for k, v in cells.items())
              + " chunk " + " ".join(f"{k} {v['chunk_us_per_step']:.1f}" for k, v in split.items())
              + " eager " + " ".join(f"{k} {v['chunk_eager_us_per_step']:.1f}"
                                     for k, v in split.items())
              + " window " + " ".join(f"{k} {v['window_decode_ms']:.1f}" for k, v in split.items()
                                      if "window_decode_ms" in v))
        up = t.get("up_rows", {})
        print("      " + " ".join(f"{k}:" + "/".join(
            f"{r['ms'] * (1 if k in ('conv_transpose', 'vocode') else 1e3):.4g}"
            for r in v.values()) for k, v in up.items())
            + "  (conv_transpose, vocode: ms; the rest us; at rows " + "/".join(
                str(b) for b in UP_ROWS) + ")")
    shas = [{B: r.get("out_sha1") for B, r in t.get("up_rows", {}).get("prenet", {}).items()}
             for t in turns]
    same = all(s == shas[0] for s in shas[1:]) and bool(shas[0])
    print(f"  the prenet's outputs at {'/'.join(str(b) for b in UP_ROWS)} rows equal in every "
          f"turn, parent and change, bit for bit: {same}")
    chunks = [{k: v.get("chunk_sha1") for k, v in t.get("serve_rows_split", {}).items()}
              for t in turns]
    # each tree's chunks repeat their bits; the heads' new sum order (split-K
    # over a cluster) gives the change other bits than the parent's
    chunk_same = chunks[0] == chunks[3] and chunks[1] == chunks[2] and bool(chunks[0])
    print(f"  the vanilla 64-step chunks (bf16 and int8, at {'/'.join(str(b) for b in K1_ROWS)} "
          f"rows) equal in both turns of each tree, bit for bit: {chunk_same}; the change's equal "
          f"the parent's: {chunks[0] == chunks[1]}")
    for name in ("heads", "bilstm_forward", "bilstm_backward"):
        key = {"bilstm_forward": "enc_rows", "bilstm_backward": "enc_bwd_rows"}.get(name)
        src = (lambda t: t.get("up_rows", {}).get("heads", {})) if name == "heads" else (
            lambda t, key=key: {k: v for k, v in t.get(key, {}).items()
                                if isinstance(v, dict) and "ms" in v})
        print(f"  {name} in turns (parent, change, change, parent; "
              + ("us" if name == "heads" else "ms") + "): " + "; ".join(
                  f"{k} " + " / ".join(
                      f"{src(t).get(k, {}).get('ms', float('nan')) * (1e3 if name == 'heads' else 1):.4g}"
                      for t in turns) for k in src(turns[1])))
    (OUT_DIR / "k1_ab.json").write_text(json.dumps(
        {"turns": turns, "prenet_bits_equal": same, "chunk_bits_equal_within_tree": chunk_same,
         "chunk_bits_equal_to_parent": chunks[0] == chunks[1]}, indent=1))
    if not (same and chunk_same):
        print("FAIL: the prenet's bits differ from the parent's, or a tree's chunks did not "
              "repeat their bits", file=sys.stderr)
        return 1
    return max(t["rc"] for t in turns)


def _sha1(tensors) -> str:
    """A digest of the tensors' bytes."""
    import hashlib

    import torch

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


K34_AB_DIMS = (80, 512, 256, 1024, 128)  # M, D, P, H, A of the configs in config/


def k34_rows_mode(out_name: str) -> int:
    """``--k34-rows``: build K3/K4 only, then the vanilla K3 and K4 (no
    controls) at ``K34_TURN_SHAPES`` on random full-width weights of a
    seeded ``Decoder`` and seeded inputs: a digest of every output (K4's
    stacks as the parent has them) and their device times; where the
    package has the controls mode, the same with 5 controls (times only).
    Results to chiprun_out/<out_name>. Runs the package found first on
    sys.path (the repo's, or a parent's with ``--root``)."""
    import torch

    from tacotron2_tpu_torch import ops
    from tacotron2_tpu_torch.models.decoder import Decoder
    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build
    from tacotron2_tpu_torch.ops import train_decode as td

    use_f32_math()
    t0 = time.perf_counter()
    build.build_all(["train_decode"])
    log: dict = {"card": card_line(), "package": str(Path(ops.__file__).parents[1]),
                 "build_s": time.perf_counter() - t0, "shapes": {}}
    print(f"[k34-rows] {log['package']} on {log['card']}")
    dev = torch.device("cuda")
    M, D, P, H, A = K34_AB_DIMS
    fields = ("dg1", "dg2", "dxh1", "dctx", "dq", "head_h", "d_attenc", "d_wv", "d_wloc")
    modes = [("vanilla", 0)] + ([("controls", 5)] if hasattr(td, "controls_cols") else [])
    try:
        for C_mode, C in modes:
            torch.manual_seed(SEED)
            dec = Decoder(M, D, P, H, A, H, C).to(dev)
            named = dict(dec.named_parameters())
            params = [named[k].detach() for k in td.DECODER_PARAMS]
            w = td.pack_weights(params, torch.bfloat16, C) if C else \
                td.pack_weights(params, torch.bfloat16)
            for B, L, T in K34_TURN_SHAPES:
                g = torch.Generator(device=dev)
                g.manual_seed(SEED + B)
                rn = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=g) * scale
                lens = torch.linspace(L, 60, B, device=dev).round().to(torch.int32)
                din = torch.relu(rn(T, B, P)) * 2.0
                enc = rn(B, L, D, scale=0.5).to(torch.bfloat16)
                att = rn(B, L, A, scale=0.5)
                dm1, dm2 = td.lstm_masks(T, B, H, g, dev)
                d_mg, d_al = rn(T, B, M + 1, scale=1e-3), rn(T, B, L, scale=1e-3)
                f_args = (w, din, enc, att, lens, dm1, dm2)
                if C:
                    f_args += (td.pad_controls(rn(B, C).clamp(-1, 1), C, din[0]),)
                mg, res = td.teacher_forward(*f_args)
                b_args = (w, res, enc, att, lens, dm1, dm2, d_mg, d_al)
                out = td.teacher_backward(*b_args)
                torch.cuda.synchronize()
                key = f"{C_mode}:B{B},L{L},T{T}"
                log["shapes"][key] = {
                    "k3_sha1": _sha1([mg, *res]),
                    "k4_sha1": _sha1([getattr(out, f) for f in fields]),
                    "k3_ms": time_ms(lambda: td.teacher_forward(*f_args), 3, 1),
                    "k4_ms": time_ms(lambda: td.teacher_backward(*b_args), 3, 1)}
                print(f"  {key}: {log['shapes'][key]}")
    except SmokeFailure as e:
        log["failure"] = str(e)
        print(f"FAIL: {e}", file=sys.stderr)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out_name).write_text(json.dumps(log, indent=1, default=str))
    return 1 if "failure" in log else 0


def k34_ab() -> int:
    """``--k34-ab``: the parent's vanilla K3/K4 against this tree's in
    turns (``ab_turns`` of ``--k34-rows``); the results go to
    chiprun_out/k34_ab.json. Fails unless the vanilla outputs have the same
    bits in every turn."""
    turns = ab_turns("--k34-rows", "k34_rows")
    if turns is None:
        return 2
    print("[k34-ab] K3 / K4 device ms in turns:")
    for t in turns:
        print(f"  {t['turn']} {t['tag']:<6} rc {t['rc']} " + "; ".join(
            f"{k} {v['k3_ms']:.3f} / {v['k4_ms']:.3f}" for k, v in t.get("shapes", {}).items()))
    digests = [{k: (v["k3_sha1"], v["k4_sha1"]) for k, v in t.get("shapes", {}).items()
                if k.startswith("vanilla")} for t in turns]
    same = bool(digests[0]) and all(d == digests[0] for d in digests[1:])
    print(f"  the vanilla K3 and K4 outputs equal in every turn, parent and change, bit for "
          f"bit: {same}")
    (OUT_DIR / "k34_ab.json").write_text(json.dumps({"turns": turns, "vanilla_bits_equal": same},
                                                    indent=1))
    if not same:
        print("FAIL: the change's vanilla K3/K4 gave other bits than the parent's",
              file=sys.stderr)
        return 1
    return max(t["rc"] for t in turns)


def k2_f32_rows_mode(out_name: str) -> int:
    """``--k2-f32-rows``: build K2's f32 mode only, then on an F32
    UNIVERSAL_V1 generator (seed SEED + 1, the smoke's) at K2F_ROWS rows of
    the say's bucket: every entry's device time beside cuDNN's f32 convs and
    the bound (``k2_timing`` without the plain version), the whole vocode's
    eager time, and a digest of the vocode's K2 outputs. Results to
    chiprun_out/<out_name>. Runs the package found first on sys.path (the
    repo's, or a parent's with ``--root``)."""
    import torch

    from tacotron2_tpu_torch import ops
    from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
    from tacotron2_tpu_torch.models.layers import F32, use_f32_math
    from tacotron2_tpu_torch.ops import build, mrf

    use_f32_math()
    t0 = time.perf_counter()
    build.build_all(["mrf_f32"])
    log: dict = {"card": card_line(), "package": str(Path(ops.__file__).parents[1]),
                 "build_s": time.perf_counter() - t0, "rows": {}}
    print(f"[k2-f32-rows] {log['package']} on {log['card']}")
    torch.manual_seed(SEED + 1)
    h32 = HiFiGAN(HiFiGANConfig.from_dict(UNIVERSAL_V1), F32).cuda().eval()
    Tb = -(-(255 + h32.mel_receptive_field()) // 128) * 128  # the say's bucket
    kw, cwp = h32.kernel_weights(), h32.conv_pre_weights()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 80)
    for B in K2F_ROWS:
        mel = torch.randn(B, Tb, h32.cfg.num_mels, device="cuda", generator=g)
        outs = [mrf.conv_pre(mel, cwp)]
        for i, (rbs, ups) in enumerate(kw):
            outs.append(mrf.mrf_stage(None, rbs, ups, outs[-1], want_operand=i < len(kw) - 1))
        entry = {"sha1": _sha1(outs),
                 "vocode_eager_ms": eager_ms(lambda: h32.apply(mel), 2 if B >= 64 else 5, 1)}
        del outs
        for r in k2_timing(h32, Tb, B, False):
            entry[r["name"]] = {k: r[k] for k in ("ms", "library_ms", "bound_ms", "cuda_core_ms")}
        log["rows"][f"B{B}"] = entry
        print(f"  B{B}: " + "; ".join(f"{k} {v['ms']:.4f} (cuDNN f32 {v['library_ms']:.4f})"
                                      for k, v in entry.items() if isinstance(v, dict))
              + f"; vocode eager {entry['vocode_eager_ms']:.3f} ms")
        del mel
        torch.cuda.empty_cache()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out_name).write_text(json.dumps(log, indent=1, default=str))
    return 0


def k2_f32_ab() -> int:
    """``--k2-f32-ab``: the parent's K2 f32 mode against this tree's in
    turns (``ab_turns`` of ``--k2-f32-rows``); the results go to
    chiprun_out/k2_f32_ab.json. Fails unless each tree's vocode outputs
    repeat their bits in both its turns (the two designs sum in other
    orders, so whether the change's equal the parent's is reported)."""
    turns = ab_turns("--k2-f32-rows", "k2_f32_rows")
    if turns is None:
        return 2
    print("[k2-f32-ab] K2's f32 entries in turns, device ms (cuDNN f32):")
    for t in turns:
        for b, e in t.get("rows", {}).items():
            print(f"  {t['turn']} {t['tag']:<6} rc {t['rc']} {b}: " + "; ".join(
                f"{k} {v['ms']:.4f} ({v['library_ms']:.4f})" for k, v in e.items()
                if isinstance(v, dict)) + f"; vocode eager {e['vocode_eager_ms']:.3f}")
    shas = [{b: e["sha1"] for b, e in t.get("rows", {}).items()} for t in turns]
    same = bool(shas[0]) and shas[0] == shas[3] and shas[1] == shas[2] and bool(shas[1])
    print(f"  each tree's vocode outputs equal in both its turns, bit for bit: {same}; the "
          f"change's equal the parent's: {shas[0] == shas[1]}")
    (OUT_DIR / "k2_f32_ab.json").write_text(json.dumps(
        {"turns": turns, "bits_equal_within_tree": same, "bits_equal_to_parent":
         shas[0] == shas[1]}, indent=1))
    if not same:
        print("FAIL: a tree's K2 f32 outputs did not repeat their bits", file=sys.stderr)
        return 1
    return max(t["rc"] for t in turns)


# design A/B of the f32 cell and heads: copies of csrc/decode_step.cu (each a
# list of regex substitutions), timed in turns by ``k1f_cell_ab``; those in
# K1F_CELL_AB_OTHER change results (timing probes), the rest must keep the
# source's bits
K1F_CELL_AB = (
    ("source", []),
    # mma.sync at every row count (the same bits as wgmma's above 16 rows), or
    # wgmma's instance at every row count
    ("mma_only", [(r"if constexpr \(NT == CF_NT\) \{", "if constexpr (false) {")]),
    ("wgmma_only", [(r"inline int cf_nt\(int nrows\) \{ return nrows <= 8 \? 1 : "
                     r"nrows <= 16 \? 2 : CF_NT; \}",
                     "inline int cf_nt(int nrows) { return CF_NT; }")]),
    # the input by TMA boxes at every row count, or by row copies at every one
    ("input_boxes", [(r"constexpr int CF_ROW_COPIES = 16;", "constexpr int CF_ROW_COPIES = 0;")]),
    ("input_rows", [(r"constexpr int CF_ROW_COPIES = 16;", "constexpr int CF_ROW_COPIES = 64;")]),
    # the split by the cvt.rna.tf32.f32 instruction (the same bits)
    ("split_cvt", [(r"return \(__float_as_uint\(x\) \+ 0x1000u\) & 0xFFFFE000u;",
                    r'uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x)); '
                    r"return r;")]),
    ("one_pass", [(r"constexpr int CF_PASSES = 7;", "constexpr int CF_PASSES = 4;")]),
    ("no_product", [(r"constexpr int CF_PASSES = 7;", "constexpr int CF_PASSES = 0;")]),
    ("heads_ntile_16", [(r"constexpr int HF_NTILE = 8;", "constexpr int HF_NTILE = 16;")]),
    ("heads_one_pass", [(r"constexpr int HF_PASSES = 7;", "constexpr int HF_PASSES = 4;")]),
)
K1F_CELL_AB_OTHER = {"one_pass", "no_product", "heads_one_pass"}


def k1f_cell_ab(model, pk, log: dict) -> dict:
    """The f32 cell's design A/B (``--k1-f32-rows --cell-ab``): the
    K1F_CELL_AB copies of csrc/decode_step.cu built under build/k1f_ab/, each
    bound in turn as ``decoder_loop._LIB``, both cells (``k1f_calls``) and
    the heads timed by graph replay at K1F_ROWS rows, in turns, two rounds,
    the second in reverse order; the copies outside K1F_CELL_AB_OTHER must
    give the source's bits. -> {copy_rows: times}"""
    import ctypes

    import torch

    from tacotron2_tpu_torch.ops import decoder_loop as dl

    libs = {k: dl.bind(ctypes.CDLL(str(v))) for k, v in build_copies(
        "decode_step", K1F_CELL_AB, ROOT / "build" / "k1f_ab").items()}
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 73)
    cases = []
    for B in K1F_ROWS:
        calls = k1f_calls(dl, pk, k1f_inputs(pk, B, 96 if B == 1 else SERVE_L, g))
        cases.append((B, calls["lstm_cell_f32"][0], calls["heads_f32"][0]))
    saved, out, first = dl._LIB, {}, {}
    names = [n for n, _ in K1F_CELL_AB]
    try:
        for order in (names, names[::-1]):
            for name in order:
                dl._LIB = libs[name]
                for B, cells, heads in cases:
                    got = _outputs(cells()) + _outputs(heads())
                    if name not in K1F_CELL_AB_OTHER:
                        ref = first.setdefault(B, got)
                        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                            raise SmokeFailure(f"k1f_cell_ab: the {name} copy changes the bits "
                                               f"at {B} rows")
                    r = out.setdefault(f"{name}_B{B}", {"cells_us": [], "heads_us": []})
                    r["cells_us"].append(time_ms(cells) * 1e3)
                    r["heads_us"].append(time_ms(heads) * 1e3)
    finally:
        dl._LIB = saved
    print("  f32 cell A/B (us, two rounds):")
    for k, v in out.items():
        print(f"    {k:<28} cells {' / '.join(f'{x:.1f}' for x in v['cells_us'])}  heads "
              f"{' / '.join(f'{x:.2f}' for x in v['heads_us'])}")
    log["k1f_cell_ab"] = out
    return out


def k1_f32_rows_mode(out_name: str) -> int:
    """``--k1-f32-rows``: build K1 only, then on a 32-true copy of F32_CONFIG
    (random weights, gate bias 10, seed SEED, as phase 4m) at K1F_ROWS rows
    (L = 96 at one row, SERVE_L at more): the device times (graph replay) of
    the K1F_TF32 entries on ``k1f_inputs`` (``lstm_cell_f32`` both cells) and
    of the 64-step f32 chunk a step, beside their library calls
    (``nn.LSTMCell`` x2, ``F.linear``, f32, TF32 off) and bounds, and a
    digest of each one's outputs. Results to chiprun_out/<out_name>. Runs the
    package found first on sys.path (the repo's, or a parent's with
    ``--root``)."""
    import torch

    from tacotron2_tpu_torch import ops
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build
    from tacotron2_tpu_torch.ops import decoder_loop as dl

    use_f32_math()
    t0 = time.perf_counter()
    build.build_all(["decode_step"])
    log: dict = {"card": card_line(), "package": str(Path(ops.__file__).parents[1]),
                 "build_s": time.perf_counter() - t0, "rows": {}}
    print(f"[k1-f32-rows] {log['package']} on {log['card']}")
    model = random_tacotron(load_config(write_f32_config()), 10.0).cuda()
    pk = model.make_packed_decoder()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 72)
    try:
        for B in K1F_ROWS:
            i = k1f_inputs(pk, B, 96 if B == 1 else SERVE_L, g)
            calls = k1f_calls(dl, pk, i)
            entry = {}
            for name in K1F_TF32:
                kern, _, lib, nb, fl = calls[name]
                if name == "lstm_cell_f32":
                    lib = k1f_cells_library(model, pk, i)
                b_ms, b_by = k1f_bound(name, nb, fl)
                entry[name] = {"ms": time_ms(kern), "library_ms": time_ms(lib), "bound_ms": b_ms,
                               "bound_by": b_by, "sha1": _sha1(_outputs(kern()))}
            s = dl.StepState(i["mel"], i["att_h"], i["att_c"], i["ctx"], i["w"], i["cum"],
                             i["rnn_h"], i["rnn_c"])
            m1, m2 = dl.prenet_masks(dl.T_CHUNK, B, pk.wp2_t.shape[0], 0.5, g, pk.wq.device)
            args = (pk, i["enc"], i["att_enc"], i["lengths"], s, m1, m2)
            mg, al, sk = dl.decode_chunk(*args)
            ms = time_ms(lambda: dl.decode_chunk(*args), 3, 1, 1)
            entry["chunk_f32"] = {"ms": ms / dl.T_CHUNK, "sha1": _sha1([mg, al, *sk])}
            log["rows"][f"B{B}"] = entry
            print(f"  B{B}: " + "; ".join(
                f"{k} {v['ms'] * 1e3:.2f} us" + (f" (library {v['library_ms'] * 1e3:.2f})"
                                                 if "library_ms" in v else " a step")
                for k, v in entry.items()))
            torch.cuda.empty_cache()
        if "--cell-ab" in sys.argv[1:]:
            k1f_cell_ab(model, pk, log)
    except SmokeFailure as e:
        log["failure"] = str(e)
        print(f"FAIL: {e}", file=sys.stderr)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out_name).write_text(json.dumps(log, indent=1, default=str))
    return 1 if "failure" in log else 0


def k1_f32_ab() -> int:
    """``--k1-f32-ab``: the parent's K1 f32 entries against this tree's in
    turns (``ab_turns`` of ``--k1-f32-rows``, each tree bound through its
    own ``decoder_loop.bind``; the second change turn adds ``k1f_cell_ab``);
    the results go to chiprun_out/k1_f32_ab.json.
    Fails unless each tree's outputs repeat their bits in both its turns
    (the two designs sum in other orders, so whether the change's equal the
    parent's is reported)."""
    turns = ab_turns("--k1-f32-rows", "k1_f32_rows", lambda i: ["--cell-ab"] if i == 2 else [])
    if turns is None:
        return 2
    print("[k1-f32-ab] K1's f32 entries in turns (parent, change, change, parent), device us "
          "(library; bound):")
    first = next((t for t in turns if t.get("rows")), {"rows": {}})
    for b, e in first["rows"].items():
        for name, v in e.items():
            got = [t.get("rows", {}).get(b, {}).get(name, {}).get("ms") for t in turns]
            print(f"  {name} {b}: " + " / ".join("-" if x is None else f"{x * 1e3:.2f}"
                                                 for x in got)
                  + (f" ({v['library_ms'] * 1e3:.2f}; {v['bound_ms'] * 1e3:.2f})"
                     if "library_ms" in v else " a step"))
    shas = [{f"{b}:{k}": v["sha1"] for b, e in t.get("rows", {}).items() for k, v in e.items()}
            for t in turns]
    same = bool(shas[0]) and shas[0] == shas[3] and shas[1] == shas[2] and bool(shas[1])
    print(f"  each tree's outputs equal in both its turns, bit for bit: {same}; the change's "
          f"equal the parent's: {shas[0] == shas[1]}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "k1_f32_ab.json").write_text(json.dumps(
        {"turns": turns, "bits_equal_within_tree": same, "bits_equal_to_parent":
         shas[0] == shas[1]}, indent=1))
    if not same:
        print("FAIL: a tree's K1 f32 outputs did not repeat their bits", file=sys.stderr)
        return 1
    return max(t["rc"] for t in turns)


def k2_shapes_rows_mode(out_name: str) -> int:
    """``--k2-shapes-rows``: build K2's three libraries, then on
    UNIVERSAL_V1, HIFIGAN_V2 and HIFIGAN_V3 generators (seed SEED + 130) in
    f32 and bf16 at 1 and 16 rows of 64 frames, every K2 call on inputs from
    the seed: ``conv_pre``, each folded upsample as one ``mrf_conv`` call
    (mode 0, the upsamples JAX fuses), each resblock conv alone with the
    residual and stage-mean epilogue, each fusable pair; the whole vocode's
    K2 outputs (each stage's) where no upsample rounds its sum (V1 in both
    modes, V2 and V3 in f32); ``c2_deep``'s convs below 8 output channels
    (the CUDA cores' route) and ``c2_wide``'s narrow convs (every one on
    ``narrow_mma_kernel``) alike. A digest of each generator's outputs on
    the wide kernels, one of V2's narrow outputs apart (``<name> narrow``:
    reported, not held to the parent's bits; so are V2's stages 3-4), V2's
    narrow entries' device times at 16 rows, the narrow rows of
    C2_KERNEL_GENS (``k2_timing`` at C2_ROWS rows of C2_FRAMES frames, beside
    cuDNN and the bound) and of V2 at V2V3_ROWS rows of the say's bucket to
    chiprun_out/<out_name>. Runs the package found first on sys.path (the
    repo's, or a parent's with ``--root``)."""
    import torch

    from tacotron2_tpu_torch import ops
    from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
    from tacotron2_tpu_torch.models.layers import Policy, use_f32_math
    from tacotron2_tpu_torch.ops import build, mrf

    use_f32_math()
    t0 = time.perf_counter()
    build.build_all(["mrf", "mrf_f32", "mrf_narrow"])
    log: dict = {"card": card_line(), "package": str(Path(ops.__file__).parents[1]),
                 "build_s": time.perf_counter() - t0, "sha1": {}, "sha1_narrow": {},
                 "narrow_ms": {}}
    print(f"[k2-shapes-rows] {log['package']} on {log['card']}")
    for name, h in (("v1", UNIVERSAL_V1), ("v2", HIFIGAN_V2), ("v3", HIFIGAN_V3)):
        for dt in (torch.float32, torch.bfloat16):
            torch.manual_seed(SEED + 130)
            gen = HiFiGAN(HiFiGANConfig.from_dict(h), Policy(dt)).cuda().eval()
            kw, cwp = gen.kernel_weights(), gen.conv_pre_weights()
            g = torch.Generator(device="cuda")
            g.manual_seed(SEED + 131)
            mode = "f32" if dt == torch.float32 else "bf16"
            for B in (1, 16):
                rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
                T = 64
                mel = rnd(B, T, h["num_mels"])
                calls = [lambda: [mrf.conv_pre(mel.to(dt), cwp)]]
                keys = [mrf.launch_key("conv_pre", cwp)]
                for rbs, ups in kw:
                    a = mrf.operand(rnd(B, T, ups.w.shape[1]), dt)
                    calls.append(lambda a=a, f=ups.folded: mrf.mrf_conv(a, f, want_act=True)[:2])
                    keys.append(mrf.launch_key("conv_transpose", ups.folded))
                    T *= ups.stride
                    C = ups.w.shape[2]
                    x, acc = rnd(B, T, C), rnd(B, T, C)
                    a = mrf.operand(x, dt)
                    for rb in rbs:
                        for c1, c2 in rb:
                            for cw in (c1, c2):
                                if cw is not None:
                                    calls.append(lambda a=a, cw=cw, x=x, acc=acc: mrf.mrf_conv(
                                        a, cw, x, acc, 0.5, True, True))
                                    keys.append(mrf.launch_key("mrf_conv", cw))
                            if mrf.pair_fusable(c1, c2):
                                calls.append(lambda a=a, c1=c1, c2=c2, x=x, acc=acc: mrf.mrf_pair(
                                    a, c1, c2, x, acc, 0.5, True, True))
                                keys.append(mrf.launch_key("mrf_pair", c1))
                outs, narrow = [], []  # the wide kernels' outputs; V2's narrow ones
                for k, c in zip(keys, calls):
                    (narrow if k.startswith("narrow") else outs).extend(c())
                if name == "v1" or dt == torch.float32:
                    a = mrf.conv_pre(mel.to(dt), cwp)
                    for i, (rbs, ups) in enumerate(kw):
                        a = mrf.mrf_stage(None, rbs, ups, a, want_operand=i < len(kw) - 1)
                        wide = all(mrf.wide(*c.w.shape[1:]) for rb in rbs for pair in rb
                                   for c in (*pair, ups.folded) if c is not None)
                        (outs if wide else narrow).append(a)
                log["sha1"][f"{name} {mode} B{B}"] = _sha1(outs)
                if narrow:
                    log["sha1_narrow"][f"{name} {mode} B{B} narrow"] = _sha1(narrow)
                del outs, narrow
                if name == "v2" and B == 16:
                    for k, c in zip(keys, calls):
                        if k.startswith("narrow"):
                            log["narrow_ms"][k] = log["narrow_ms"].get(k, 0.0) + time_ms(c, 5, 4)
                torch.cuda.empty_cache()
            del gen
    log["narrow_rows"] = {}
    for tag in C2_KERNEL_GENS:  # the C2 generators' narrow entries
        h = C2_GENERATORS[tag]
        for dt in (torch.float32, torch.bfloat16):
            torch.manual_seed(C2_SEED[tag])
            gen = HiFiGAN(HiFiGANConfig.from_dict(h), Policy(dt)).cuda().eval()
            mode = "f32" if dt == torch.float32 else "bf16"
            # c2_deep's convs below 8 channels keep the parent's FFMA order,
            # c2_wide's narrow convs the parent's narrow_mma_kernel bits
            held = {"c2_deep": ("c2_deep_co_under_8", lambda Co, Ci: Co < 8),
                    "c2_wide": ("c2_wide_tensor_cores", lambda Co, Ci: not mrf.wide(Co, Ci))}
            digest, keep = held[tag]
            g = torch.Generator(device="cuda")
            g.manual_seed(SEED + 132)
            for B in C2_ROWS:
                rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
                T, outs = 64, []
                cwp = gen.conv_pre_weights()
                if keep(*cwp.w.shape[1:]):
                    outs.append(mrf.conv_pre(rnd(B, T, h["num_mels"]).to(dt), cwp))
                for rbs, ups in gen.kernel_weights():
                    if ups.folded is not None and keep(*ups.folded.w.shape[1:]):
                        a = mrf.operand(rnd(B, T, ups.w.shape[1]), dt)
                        outs += mrf.mrf_conv(a, ups.folded, want_act=True)[:2]
                    T *= ups.stride
                    C = ups.w.shape[2]
                    if not keep(C, C):
                        continue
                    x, acc = rnd(B, T, C), rnd(B, T, C)
                    a = mrf.operand(x, dt)
                    convs = [cw for rb in rbs for pair in rb for cw in pair if cw is not None]
                    for cw in convs:
                        outs += mrf.mrf_conv(a, cw, x, acc, 0.5, True, True)
                log["sha1"][f"{digest} {mode} B{B}"] = _sha1(outs)
                del outs
            for B in C2_ROWS:
                for r in k2_timing(gen, C2_FRAMES, B, False, (2, 2), True):
                    if r["name"].startswith("narrow"):
                        log["narrow_rows"][f"{r['name']}[{tag}] B{B}"] = {
                            k: r.get(k) for k in ("ms", "library_ms", "library_bf16_ms",
                                                  "bound_ms", "bound_by", "traffic_ms", "per")}
                torch.cuda.empty_cache()
            del gen
    from tacotron2_tpu_torch.run.say import vocode_bucket

    for dt in (torch.float32, torch.bfloat16):  # V2's narrow rows at the say's bucket
        torch.manual_seed(V2V3_SEED["v2"])
        gen = HiFiGAN(HiFiGANConfig.from_dict(HIFIGAN_V2), Policy(dt)).cuda().eval()
        Tb = vocode_bucket(gen, V2V3_FRAMES - 1)
        for B in V2V3_ROWS:
            for r in k2_timing(gen, Tb, B, False, (1, 2) if B >= 64 else (2, 2), True):
                if r["name"].startswith("narrow"):
                    log["narrow_rows"][f"{r['name']}[v2] B{B}"] = {
                        k: r.get(k) for k in ("ms", "library_ms", "library_bf16_ms", "bound_ms",
                                              "bound_by", "traffic_ms", "per")}
            torch.cuda.empty_cache()
        del gen
    print("  " + "; ".join(f"{k} {v[:10]}" for k, v in log["sha1"].items()))
    print("  not held: " + "; ".join(f"{k} {v[:10]}" for k, v in log["sha1_narrow"].items()))
    print("  V2's narrow entries at 16 rows, device ms summed over a vocode's calls: "
          + "; ".join(f"{k} {v:.4f}" for k, v in log["narrow_ms"].items()))
    print(f"  the C2 generators' narrow rows ({C2_FRAMES} frames), device ms (cuDNN f32 / bf16; "
          "bound): " + "; ".join(
              f"{k} {v['ms']:.4f} ({v['library_ms']:.4f} / {ms_text(v['library_bf16_ms'])}; "
              f"{v['bound_ms']:.4f})" for k, v in log["narrow_rows"].items()))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out_name).write_text(json.dumps(log, indent=1, default=str))
    return 0


def k2_shapes_ab() -> int:
    """``--k2-shapes-ab``: the parent's K2 against this tree's in turns
    (``ab_turns`` of ``--k2-shapes-rows``); the results go to
    chiprun_out/k2_shapes_ab.json. Fails unless every held digest (the wide
    kernels' outputs, V2's among them, c2_deep's convs below 8 channels' and
    c2_wide's tensor-core convs') is the same in all four turns: the
    redesigned narrow kernel keeps the parent's bits on the routes it did
    not redesign. V2's narrow outputs (the small route, which a parent
    without it computes in another order) are reported, each tree's
    against itself. Prints the C2 generators' and
    V2's narrow rows in turns beside cuDNN and the bound."""
    turns = ab_turns("--k2-shapes-rows", "k2_shapes_rows")
    if turns is None:
        return 2
    print("[k2-shapes-ab] K2's digests and V2's narrow entries' device ms in turns:")
    for t in turns:
        print(f"  {t['turn']} {t['tag']:<6} rc {t['rc']}: " + "; ".join(
            f"{k} {v:.4f}" for k, v in t.get("narrow_ms", {}).items()))
    print("  the C2 generators' narrow rows in turns (parent / change / change / parent), device "
          "ms; this tree's cuDNN f32 / bf16 and bound:")
    change = next((t for t in turns if t["tag"] == "change" and t.get("narrow_rows")), None)
    for k in (change or {}).get("narrow_rows", {}):
        got = [t.get("narrow_rows", {}).get(k, {}).get("ms") for t in turns]
        v = change["narrow_rows"][k]
        print(f"    {k}: " + " / ".join(ms_text(x) for x in got)
              + f" ({v['library_ms']:.4f} / {ms_text(v['library_bf16_ms'])}; "
                f"{v['bound_ms']:.4f} {v['bound_by']})")
    shas = [t.get("sha1", {}) for t in turns]
    same = bool(shas[0]) and all(s == shas[0] for s in shas[1:])
    print(f"  every held digest equal in all four turns, parent and change: {same}")
    narrow = [t.get("sha1_narrow", {}) for t in turns]
    print("  V2's narrow outputs, each tree's turns equal: parent "
          f"{narrow[0] == narrow[3]}, change {narrow[1] == narrow[2]}; parent and change equal: "
          f"{narrow[0] == narrow[1]}")
    (OUT_DIR / "k2_shapes_ab.json").write_text(json.dumps({"turns": turns, "bits_equal": same},
                                                          indent=1))
    if not same:
        print("FAIL: the change's K2 outputs differ from the parent's at the parent's shapes",
              file=sys.stderr)
        return 1
    return max(t["rc"] for t in turns)


# the small route's (narrow_small_kernel) design copies: its products (and
# the weight fragments' reads), its epilogue's stores, the weights' copy and
# the epilogue tiles' prefetch taken out, f32's three TF32 passes cut to one
# (a_hi w_hi), registers for three blocks an SM, and ``on_mma``: the same
# shapes on narrow_mma_kernel (a pair as its two launches, the intermediate
# through global memory), what a pair mode of that kernel could at best save
SMALL_DESIGN = (
    ("on_mma", [(r"const bool small = \(Co == 8 \|\| Co == 16\) && \(Ci == 8 \|\| Ci == 16\);",
                 "const bool small = false;")]),
    ("no_mma", [(r"if constexpr \(\(kTf32Passes & %d\) != 0\) mma_tf32\(part\[n\], %s, "
                 r"bw\[n\]\[s\]\[%d\], bw\[n\]\[s\]\[%d\]\);" % pas, "")
                for pas in ((1, "al", 0, 1), (2, "ah", 2, 3), (4, "ah", 0, 1))]
     + [(r"mma_k8\(acc\[m\]\[n\], a2, bw\[n\]\[0\]\[0\]\);", "(void)0;"),
        (r"mma_k16\(acc\[m\]\[n\], a4, bw\[n\]\[0\]\[0\], bw\[n\]\[0\]\[1\]\);",
         "(void)0;")]),
    ("no_epilogue", [(r"for \(int i = tid; i < nrows \* NT; i \+= kSmallThreads\)",
                      "for (int i = tid; i < 0 * NT; i += kSmallThreads)")]),
    ("no_weights", [(r"for \(int i = tid; i < p\.w_units; i \+= kSmallThreads\)",
                     "for (int i = tid; i < 0; i += kSmallThreads)")]),
    ("no_prefetch", [(r"for \(int i = tid; i < nrows \* CO / 4; i \+= kSmallThreads\)",
                      "for (int i = tid; i < 0; i += kSmallThreads)")]),
    ("one_pass", [(r"constexpr int kTf32Passes = 7;", "constexpr int kTf32Passes = 4;")]),
    ("blocks3", [(r"__launch_bounds__\(kSmallThreads, 2\)",
                  "__launch_bounds__(kSmallThreads, 3)")]),
)
# (rows, T, C, K, dilation, pair): V2's small-route calls at 1 / 16 / 64 rows
# of the say's 384-frame bucket (stage 3 at T = 49,152, stage 4 at 98,304;
# the last upsample's fold 16 -> 2 x 8 a single 3-tap conv at 49,152), and
# c2_deep's at 1 / 16 rows of 128 frames (T = 2,048 at 16, 4,096 at 8)
SMALL_DESIGN_CALLS = ((1, 49152, 16, 11, 5, True), (1, 49152, 16, 3, 1, True),
                      (1, 98304, 8, 11, 5, True), (1, 49152, 16, 3, 1, False),
                      (16, 49152, 16, 11, 5, True), (16, 98304, 8, 7, 3, True),
                      (64, 49152, 16, 7, 3, True), (64, 98304, 8, 11, 5, True),
                      (1, 2048, 16, 11, 5, True), (1, 4096, 8, 11, 5, True),
                      (16, 2048, 16, 7, 3, True), (16, 4096, 8, 3, 1, True))


def narrow_design() -> int:
    """``--narrow-design``: the narrow kernel's small route and its
    SMALL_DESIGN copies (built under build/narrow_design) timed in turns on
    SMALL_DESIGN_CALLS, f32 and bf16, device us a launch (``on_mma``: a
    pair's two), the residual, act and stage-mean epilogue as a resblock's;
    chiprun_out/narrow_design.json."""
    import ctypes

    import torch

    from tacotron2_tpu_torch.models.layers import use_f32_math
    from tacotron2_tpu_torch.ops import build, mrf

    use_f32_math()
    card = card_line()
    t0 = time.perf_counter()
    wait = build_copies("mrf_narrow", SMALL_DESIGN, ROOT / "build" / "narrow_design", wait=False)
    build.build_all(["mrf_narrow"])
    libs = {"source": None, **wait()}
    log: dict = {"card": card, "build_s": time.perf_counter() - t0, "us": {}}
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 140)
    saved, small = mrf._lib_narrow(), mrf.narrow_small
    for dt in (torch.float32, torch.bfloat16):
        for B, T, C, K, d, pair in SMALL_DESIGN_CALLS:
            w = [(torch.randn(K, C, C, device="cuda", generator=g) * 0.1).to(dt)
                 for _ in range(2 if pair else 1)]
            z = torch.zeros(C, device="cuda")
            a = torch.randn(B, T, C, device="cuda", generator=g).to(dt)
            x, acc = (torch.randn(B, T, C, device="cuda", generator=g) for _ in range(2))
            # the weight copies of both layouts: the small route's, and
            # narrow_mma_kernel's (what tile_conv makes where narrow_small is false)
            cws = {}
            for mma in (False, True):
                mrf.narrow_small = (lambda Co, Ci: False) if mma else small
                cws[mma] = [mrf.ConvWeights(wi, z, dil, mrf.tile_conv(wi))
                            for wi, dil in zip(w, (d, 1))]
            mrf.narrow_small = small

            def run(mma):
                cw = cws[mma]
                if not pair:
                    return mrf.mrf_conv(a, cw[0], x, acc, 0.5, True, True)
                if not mma:
                    return mrf.mrf_pair(a, cw[0], cw[1], x, acc, 0.5, True, True)
                _, at, _ = mrf.mrf_conv(a, cw[0], want_y=False, want_act=True)
                return mrf.mrf_conv(at, cw[1], x, acc, 0.5, True, True)

            row = {}
            for rnd in range(2):
                for name in (list(libs) if rnd == 0 else list(libs)[::-1]):
                    mrf._LIB_NARROW = saved if libs[name] is None else mrf.bind(
                        mrf.bind(ctypes.CDLL(str(libs[name])), "", "narrow"), "_f32", "narrow")
                    mma = name == "on_mma"
                    mrf.narrow_small = (lambda Co, Ci: False) if mma else small
                    try:
                        us = time_ms(lambda: run(mma), 5 if B == 1 else 2, 10 if B == 1 else 3)
                    finally:
                        mrf.narrow_small = small
                    row.setdefault(name, []).append(us * 1e3)
            mrf._LIB_NARROW = saved
            key = (f"{'f32' if dt == torch.float32 else 'bf16'} B{B} T{T} C{C} k{K} d{d}"
                   + (" pair" if pair else ""))
            log["us"][key] = row
            print(f"  {key}: " + "; ".join(f"{n} {min(v):.1f}" for n, v in row.items()))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "narrow_design.json").write_text(json.dumps(log, indent=1))
    print(card)
    return 0


def main() -> int:
    pkg_root = Path(arg_value("--root", str(ROOT))).resolve()
    if not (pkg_root / "tacotron2_tpu_torch" / "csrc").is_dir():
        print("FAIL: the tacotron2_tpu_torch package is not beside chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if "--k1-ab" in sys.argv[1:]:
        return k1_ab()
    if "--k34-ab" in sys.argv[1:]:
        return k34_ab()
    if "--k2-f32-ab" in sys.argv[1:]:
        return k2_f32_ab()
    if "--k1-f32-ab" in sys.argv[1:]:
        return k1_f32_ab()
    if "--k2-shapes-ab" in sys.argv[1:]:
        return k2_shapes_ab()
    if "--narrow-design" in sys.argv[1:]:
        return narrow_design()
    sys.path.insert(0, str(pkg_root))
    torch.set_grad_enabled(False)
    if "--k1-rows" in sys.argv[1:]:
        return k1_rows_mode(arg_value("--out", "k1_rows.json"))
    if "--k34-rows" in sys.argv[1:]:
        return k34_rows_mode(arg_value("--out", "k34_rows.json"))
    if "--k2-f32-rows" in sys.argv[1:]:
        return k2_f32_rows_mode(arg_value("--out", "k2_f32_rows.json"))
    if "--k1-f32-rows" in sys.argv[1:]:
        return k1_f32_rows_mode(arg_value("--out", "k1_f32_rows.json"))
    if "--k2-shapes-rows" in sys.argv[1:]:
        return k2_shapes_rows_mode(arg_value("--out", "k2_shapes_rows.json"))
    if "--eval" in sys.argv[1:]:
        return eval_mode()
    if "--train-extras" in sys.argv[1:]:
        return train_extras_mode()
    if "--descriptions" in sys.argv[1:]:
        return descriptions_mode()
    if "--gst" in sys.argv[1:]:
        return gst_mode()
    if "--k4-ref" in sys.argv[1:]:
        return k4_ref_mode()
    if "--dp" in sys.argv[1:]:
        return dp_mode()
    if "--mesh" in sys.argv[1:]:
        return mesh_mode()
    if "--v2v3" in sys.argv[1:]:
        return v2v3_mode()
    if "--f32-step" in sys.argv[1:]:
        return f32_step_mode()
    if "--f32-decode" in sys.argv[1:]:
        return f32_decode_mode()
    if "--vocoder-shapes" in sys.argv[1:]:
        return vocoder_shapes_mode()
    log: dict = {}
    t_start = time.perf_counter()
    t_lap = [t_start]
    pass_copies = defect_narrow = defect_k1f = defect_shapes = None

    def lap(name: str) -> None:  # seconds since the last lap, into log["phase_s"]
        now = time.perf_counter()
        log.setdefault("phase_s", {})[name] = now - t_lap[0]
        t_lap[0] = now

    try:
        card = card_line()
        print(f"[1] card: {card}")
        print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")
        from tacotron2_tpu_torch.models.layers import use_f32_math

        use_f32_math()  # as the say and train entries set it
        print("    TF32 off for matmul and cuDNN (the port's setting): plain versions and "
              "library calls run in f32")

        from tacotron2_tpu_torch.config import load_config
        from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
        from tacotron2_tpu_torch.models.layers import F32, Policy
        from tacotron2_tpu_torch.ops import build
        from tacotron2_tpu_torch.text import normalize_text

        t0 = time.perf_counter()
        pass_copies = k2f_pass_copies()  # built beside the kernels, held in phase 3f
        defect_narrow = narrow_copies()  # and the narrow kernel's, held in phases 4l and 4n
        defect_k1f = k1f_copies()  # and K1's f32 entries', held in phase 4m
        defect_shapes = shape_copies()  # and the narrow kernel's at the new shapes, in 4n
        logs = build.build_all()
        log["build_s"] = time.perf_counter() - t0
        log["ptxas"] = logs
        print(f"[2] built {list(logs)} in {log['build_s']:.1f} s")
        lap("1-2 build")
        log["ptxas_kernels"] = {name: ptxas_kernels(text) for name, text in logs.items()}
        for name, kernels in log["ptxas_kernels"].items():
            for k, v in kernels.items():
                print(f"    {name}: {k}: {v['registers']} registers, {v['smem']} bytes static "
                      f"smem, stack frame {v['stack']} bytes, spills {v['spill_stores']} / "
                      f"{v['spill_loads']} bytes")
        if "--k2-f32" in sys.argv[1:]:
            torch.manual_seed(SEED + 1)
            h32 = HiFiGAN(HiFiGANConfig.from_dict(UNIVERSAL_V1), F32).cuda().eval()
            Tb = -(-(255 + h32.mel_receptive_field()) // 128) * 128  # the say's bucket
            print(f"[k2-f32] K2's f32 mode on {card}")
            try:
                k2_f32_reference(Tb, log)
                rows = k2_f32_phase(h32, Tb, log, pass_copies)
            finally:
                OUT_DIR.mkdir(exist_ok=True)
                (OUT_DIR / "k2_f32.json").write_text(json.dumps({"card": card, **log}, indent=1,
                                                                default=str))
            print(json.dumps({"kernels": [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                                             "library_ms", "rows")}
                                          for r in rows]}))
            return 0
        if "--k2-ab" in sys.argv[1:]:
            torch.manual_seed(SEED + 1)
            hifigan = HiFiGAN(HiFiGANConfig.from_dict(UNIVERSAL_V1),
                              Policy(torch.bfloat16)).cuda().eval()  # K2's bf16 mode
            Tb = -(-(255 + hifigan.mel_receptive_field()) // 128) * 128  # the say's bucket
            print(f"[k2-ab] K2's design A/B on {card}")
            OUT_DIR.mkdir(exist_ok=True)
            (OUT_DIR / "k2_ab.json").write_text(json.dumps(
                {"card": card, **k2_ab(hifigan, Tb)}, indent=1))
            return 0

        cfg_path = str(ROOT / "config" / "vanilla-ljspeech-stop.json")
        cfg = load_config(cfg_path)
        prep = cfg.dataset.preprocessing
        chars = len(normalize_text(TEXT, prep.allowed_chars, prep.end_token, False))
        model = random_tacotron(cfg, 10.0).cuda()
        torch.manual_seed(SEED + 1)
        hifigan = HiFiGAN(HiFiGANConfig.from_dict(UNIVERSAL_V1),
                          Policy(torch.bfloat16)).cuda().eval()  # K2's bf16 mode
        Tb = -(-(255 + hifigan.mel_receptive_field()) // 128) * 128  # the say's bucket
        print(f"[3] kernels against their plain versions (flagship dims, B=1, L={chars})")
        cells = cell_rows(model, log)
        cell_invariance(model, log)
        rows = k1_phase(model, cfg, chars, log, cells)
        rows += k5_phase(model, cfg, chars, log, cells)
        print(f"[3c] K1's and K5's controls mode ({CTL_CONFIG}, full width) against their "
              "plain versions at 1, 16 and 64 rows")
        rows += controls_phase(model, chars, log)
        lap("3 K1 K5 3c")
        print(f"[3] where a serve window's decode goes (16 and 64 rows, L={SERVE_L})")
        serve_rows_split(model, cfg, log)
        lap("3 serve split")
        for frames in (64, Tb):  # 64 frames, then the say's own bucket
            k2_phase(hifigan, log, frames)
        rows += k2_timing(hifigan, Tb)
        # the upsample, stage 1's operand, the prenet and the heads at 1, 16
        # and 64 rows ride along in their kernels' rows
        ups = up_rows(model, hifigan, Tb, log)
        for r in rows:
            if r["name"] in ("conv_transpose", "conv_pre", "prenet", "heads"):
                r["rows"] = ups[r["name"]]
        # the dilated convs (mrf_conv and mrf_pair) at the serve windows'
        # shapes (16 and 64 rows, the say's bucket): kernels, library calls
        # and bound, summed over both kernels
        log["k2_convs_serving"] = {}
        for rows_b in (16, 64):
            rs = [x for x in k2_timing(hifigan, Tb, rows_b, False)
                  if x["name"] in ("mrf_conv", "mrf_pair")]
            r = {k: sum(x[k] for x in rs) for k in ("ms", "bound_ms", "library_ms",
                                                     "library_bf16_ms", "traffic_ms")}
            r["per_kernel"] = {x["name"]: {k: x[k] for k in ("ms", "bound_ms", "library_ms",
                                                             "library_bf16_ms", "per")}
                               for x in rs}
            log["k2_convs_serving"][f"B{rows_b}"] = r
            print(f"  mrf_conv + mrf_pair at {rows_b} rows, Tb={Tb}: {r['ms']:.3f} ms ("
                  + ", ".join(f"{n} {v['ms']:.3f}" for n, v in r["per_kernel"].items())
                  + f"), bound {r['bound_ms']:.3f} ms, library f32 {r['library_ms']:.3f} ms, "
                  f"bf16 {r['library_bf16_ms']:.3f} ms on {card}")
        lap("3 K2 bf16")
        print(f"[3f] K2's f32 mode (csrc/mrf_f32.cu, the commands' vocoder): the kernel against "
              f"its plain version at {list(K2F_ROWS)} rows, Tb={Tb}")
        torch.manual_seed(SEED + 1)  # the bf16 generator's weights
        h32 = HiFiGAN(HiFiGANConfig.from_dict(UNIVERSAL_V1), F32).cuda().eval()
        rows += k2_f32_phase(h32, Tb, log, pass_copies)
        del h32
        torch.cuda.empty_cache()
        lap("3f K2 f32")
        print(f"[3b] K3 and K4 against their plain versions (B={TRAIN_B}, L={TRAIN_L}, "
              f"T={TRAIN_T})")
        rows += k34_phase(model, log)
        print(f"[3d] K3 and K4 in the controls mode ({CTL_CONFIG}, full width) against their "
              "plain versions at B=64 / 32 / 5, the defects, and against the vanilla in turns")
        rows += k34_controls_phase(model, log)
        lap("3b 3d K3 K4")
        rows += encoder_lstm_phase(model, cfg, log)
        print("[3e] deliberate defects of the heads and the encoder's forward and backward "
              "(source copies)")
        defect_phase(model, cfg, log)
        del model, hifigan
        lap("3 encoder 3e")

        print("[4] say through the CLI entry (random full-width weights)")
        launches, g_path, ckpt = say_phase(cfg_path, log, card)
        k5_launches = say_int8_phase(cfg_path, ckpt, g_path, log, card)
        lap("4 say")
        print("[4b] train through the CLI entry (vanilla full width, batch 32, 6 steps, "
              "resumed to 8)")
        train_launches, van_run = train_phase(cfg_path, g_path, log, card)
        for k, n in train_launches.items():
            launches[k] = launches.get(k, 0) + n
        lap("4b train")
        print("[4c] the warm server in this process (a bf16 and an int8 entry), then as a "
              "process of its own")
        launches.update(k5_launches)
        for k, n in serve_phase(cfg_path, ckpt, g_path, log, card).items():
            launches[k] = launches.get(k, 0) + n
        lap("4c serve")
        print(f"[4d] the controllable, multi-speaker path ({CTL_CONFIG}): say --speaker-id "
              "--controls (bf16 and int8), then the warm server with a bf16 and an int8 entry")
        ctl_ckpt, ctl_launches = say_controls_phase(g_path, log, card)
        for k, n in serve_controls_phase(ctl_ckpt, g_path, log, card).items():
            ctl_launches[k] += n
        launches.update(ctl_launches)
        lap("4d controls")
        print(f"[4e] train the controllable, multi-speaker config ({CTL_CONFIG}) through the "
              f"CLI entry: batch {CTL_TRAIN_B}, 6 steps, resumed to 8, then its say")
        ctl_train_launches, ctl_run = train_controls_phase(g_path, log, card)
        launches.update(ctl_train_launches)
        lap("4e train controls")
        print("[4f] from raw corpora to test-set audio through the CLI: preprocess (WAV and "
              "FLAC), the splits, test, train_mel_export and say --export-mel")
        eval_launches, k3_export, lj_hifi = eval_phase(
            cfg_path, str(ROOT / "config" / CTL_CONFIG), ckpt, ctl_ckpt, g_path, log, card)
        for k, n in eval_launches.items():
            launches[k] = launches.get(k, 0) + n
        lap("4f eval")
        print(f"[4g] finetuning (vanilla B={2 * TRAIN_B} under the trace, controllable "
              f"B={2 * CTL_TRAIN_B}), the background save, TensorBoard, train_prosody and the "
              f"style-loss phase ({STYLE_CONFIG}) through the CLI")
        extra_launches, extra_readings = train_extras_phase(van_run, ctl_run, lj_hifi, g_path,
                                                            log, card)
        for k, n in extra_launches.items():
            launches[k] = launches.get(k, 0) + n
        lap("4g train extras")
        print(f"[4h] description-conditioned speech ({DESC_CONFIG}, D = 640): BERT and "
              "embed_descriptions, train and train --finetune, say --description "
              "--bert-checkpoint, then test_correlation of 4e's checkpoint, through the CLI")
        desc_launches, desc_readings = descriptions_phase(ctl_run, g_path, log, card)
        for k, n in desc_launches.items():
            launches[k] = launches.get(k, 0) + n
        lap("4h descriptions")
        print(f"[4i] Global Style Tokens ({GST_BASE} with extensions.gst, D = 768): train and "
              "train --finetune, say --gst-reference (bf16 and int8), the server, test, "
              "train_mel_export and test_correlation, through the CLI")
        gst_launches, gst_readings = gst_phase(ctl_run, g_path, log, card)
        for k, n in gst_launches.items():
            launches[k] = launches.get(k, 0) + n
        lap("4i gst")
        print(f"[4j] data-parallel train ({DP_RANKS} gloo ranks sharing the card against one "
              f"process at B={TRAIN_B} and, {CTL_CONFIG}, B={CTL_TRAIN_B}), train as one NCCL "
              "rank under torchrun's environment, and the device prefetcher on and off")
        dp_launches, dp_readings = dp_phase(van_run, ctl_run, log, card)
        for k, n in dp_launches.items():
            launches[k] = launches.get(k, 0) + n
        lap("4j dp")
        print(f"[4k] the server's data mesh ({{'data': 2}} on {list(MESH_SHARDS)}: a bf16 and an "
              f"int8 wave of {MESH_WAVE}), tensor-parallel train ({TP_GRID[0]} x {TP_GRID[1]} "
              f"gloo ranks sharing the card against one process's K3 / K4 step at B={TRAIN_B}) "
              "and the device mel backend")
        for k, n in mesh_phase(cfg_path, ckpt, van_run, g_path, log, card).items():
            launches[k] = launches.get(k, 0) + n
        lap("4k mesh")
        print("[4l] HiFi-GAN V2 and V3 (jik876/hifi-gan's config_v2 / config_v3, random weights "
              "at the published widths): the narrow kernel and ResBlock2 against their plain "
              f"versions at {list(V2V3_ROWS)} rows, say with each g_* file, the V2 server's wave")
        narrow_rows, v2v3_readings, narrow_launches = v2v3_phase(cfg_path, ckpt, log, card,
                                                                 defect_narrow)
        launches.update(narrow_launches)
        rows += narrow_rows
        lap("4l v2v3")
        print(f"[4m] K1's f32 mode and the F32 teacher-forced route ({F32_CONFIG} at "
              f"\"32-true\"): every f32 entry against its plain f32 version at {list(K1F_ROWS)} "
              "rows, the f32 and int8 chunks, say (f32 and int8), a served wave, train and "
              "train --finetune")
        f32_rows, f32_launches, f32_readings = f32_decode_phase(log, card, defect_k1f)
        launches.update(f32_launches)
        rows += f32_rows
        lap("4m f32 decode")
        print(f"[4n] K2 at every shape JAX's stage kernel takes ({list(C2_GENERATORS)}: the "
              f"narrow kernel at any Co and Ci, JAX's XLA routes on stock ops) against the plain "
              f"versions at {list(C2_ROWS)} rows, and a model whose two LSTM widths differ "
              f"(rnn_hidden_dim {C3_RNN})")
        c2_rows, c2_launches = vocoder_shapes_phase(log, card, defect_shapes, defect_narrow)
        launches.update(c2_launches)
        rows += c2_rows
        lap("4n vocoder shapes")
        print("    seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                  log["phase_s"].items()))
        for r in rows:
            if r["name"] == "teacher_forward":
                r["export"] = k3_export
            if r["name"] in extra_readings:
                r["finetune"] = extra_readings[r["name"]]
            if r["name"] in desc_readings:
                r["descriptions"] = desc_readings[r["name"]]
            if r["name"] in gst_readings:
                r["gst"] = gst_readings[r["name"]]
            if r["name"] in dp_readings:
                r["dp"] = dp_readings[r["name"]]
            r.update(v2v3_readings.get(r["name"], {}))  # "v2" / "v3": the wide entries
        if log.get("deferred"):
            raise SmokeFailure("; ".join(log["deferred"]))

        print("[5] kernels")
        for r in rows:
            r["launches"] = launches[r["name"]]
            r["max_abs_err"] = max(c["max_abs_err"] for c in log["checks"]
                                   if c["kernel"] == r["name"])
            lib = "-" if r["library_ms"] is None else "%.1f" % (r["library_ms"] * 1e3)
            traffic = ("" if "traffic_ms" not in r
                       else f"  design traffic {r['traffic_ms'] * 1e3:7.1f} us")
            if r.get("weight_stream_ms"):
                traffic = f"  weight stream {r['weight_stream_ms'] * 1e3:9.1f} us"
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
        # the cells' and the attention's readings at other row counts ride along
        print(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                       **{k: r[k] for k in ("rows", "export", "finetune",
                                                            "descriptions", "gst", "dp", "v2",
                                                            "v3")
                                          if k in r}}
                                      for r in rows]}))
        print(card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(log, indent=1, default=str))
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
        for copies in (pass_copies, defect_narrow, defect_k1f, defect_shapes):  # no nvcc outlives
            if copies is not None:
                with contextlib.suppress(SmokeFailure):
                    copies()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
