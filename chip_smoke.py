#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (paddle_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels build for sm_90a) and nvcc; run
from the root of a checkout. It exits nonzero, and prints no result,
without a CUDA device or outside the repository. Phases:

1. the card's name and power limit; build every kernel from csrc/ (one
   nvcc per source, all at once); the tensor-core kernels (vocab_xent's
   forward, dx and dW, the GRU's and the LSTM's dW) must build without
   spills and hold HMMA instructions in their SASS (cuobjdump);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it and a few more, with times: the
   fused_lstm forward (csrc/lstm_fwd.cu, U units and R rows a block from
   lstm_fwd_plan: the classifier's (64, 512) takes U = 16, R = 16; also
   held at the serving batches B = 1 and 17, where a block takes several
   row tiles, at U = 8 and 4, and where the plan keeps the 4-unit kernel
   that stages every row; two launches bit-equal, each case with its plan
   and us a time step; with and without the stash at (64, 100, 512) and
   (64, 128, 512)); its backward's recurrence (csrc/lstm_bwd.cu
   lstm_bwd, U units and R rows a block from lstm_bwd_plan: the
   classifier's (64, 512) takes U = 16, R = 16; also held where a block
   takes several row tiles, at U = 8 and 4 and at H = 528, two launches
   bit-equal, each case with its plan and us a time step), alone (the
   split form's kernel) and as the default form with the dW kernel
   (lstm_bwd_dw, 3xTF32 mma.sync, its pairs split S ways) and its sum
   (lstm_bwd_dw_reduce), each held alone too, bit-equal across launches,
   with split_dw_db's matmul and reductions as the dW kernel's library
   call;
   the fused_gru forward's two kernels (the grid one, gru_fwd_plan's at
   the NMT shapes, held at every recurrent case; the thread-block-cluster
   one, the plan's at the RNN CRF tagger's (32, 512, 128) with bench_crf's
   rows and with resets and four more cases, hs and the stash, two
   launches bit-equal; each case prints the plan's path, (C, R) and us a
   time step), the backward's recurrence in its two kernels (the grid
   one, gru_bwd_plan's at the NMT shapes, held at every recurrent case and
   forced at the tagger's; the cluster one, the plan's at the forward
   cluster kernel's six cases, two launches bit-equal, each case with its
   plan, (C, R) and us a time step), then dW, the CRF kernels (phase 7),
   the CTC kernels (phase 8); the
   forwards' training stashes against the plain forwards', and the whole
   GRU backward against its plain version. The GRU's dW kernel (3xTF32
   mma.sync, its pairs split S ways) is held at the NMT shapes and at the
   RNN CRF tagger's (32, 512, 128), with bench_crf's rows and with resets,
   two launches bit-equal in each case; at both widths it is timed alone,
   with its sum (gru_bwd_dw_reduce, bit-equal to its plain version) and
   against gru_dw_db_plain (two float32 matmuls and a sum), beside its
   tensor-core and float32 bounds. Times are device times: cuda_ms holds
   the stream with a spin while the host enqueues the calls;
3. the LSTM slice: the LSTM text classifier at the repo's RNN benchmark
   widths (bench.py:175 bench_lstm: dict 30000, emb 512, hidden 512, 2
   layers; weights random from a seed) serves four request batches
   through ``paddle_tpu_torch.infer`` on the card; the logits are held
   against the port's CPU run, and the launch counts show the path went
   through ``fused_lstm``; one request runs again under torch.profiler;
3b. bundle-backed serving: the same classifier and weights written as a
   merged-model bundle (io/merged_model.write_bundle, verify_bundle; its
   meta holds the 32 MiB cap's torch_export_skip_reason) and served
   through inference.InferenceMachine on the card, B = 64 and 1 rows of
   128 ids, every id valid: bit-equal to Inference.infer on the same
   parameters and rows, within 1e-5 of the CPU's machine on the same
   bundle, 2 fused_lstm launches a request, the medians of both entry
   points' request ms, the bundle's bytes and write and load seconds;
   share() serves the same answer from the same device tensors with
   torch.cuda.memory_allocated() unchanged; bf16 and int8 bundles of the
   model (quant.quantize_params) held against the CPU's machine on each,
   their param_bytes against f32's, their gap to f32 and argmax
   agreement printed; then the forward's torch.export artifact of the
   classifier at 2000 words (export_forward_ex, static batch 8, T = 16;
   f32 and int8), loaded by load_forward_export onto the card, against
   the card's machine within 1e-6 and the CPU's within 1e-5, with 2
   fused_lstm launches a run (the custom op paddle_tpu_torch::lstm_fwd
   inside the program), also at B = 3 where the batch stayed symbolic;
   its export seconds; the kernel phase holds fused_lstm against its
   plain version at these bundles' shapes too;
4. the training slice: the same classifier trains through
   ``paddle_tpu_torch.SGD(...).train`` on the card, 8 batches of 64 rows
   with Adam (lr 1e-3), the default backward (the recurrence, the dW
   kernel and its sum); then 4 batches with Momentum and the split
   backward forced. The first 4 costs of each, and Momentum's parameters,
   are held against the port's CPU run of the same batches; every step
   must launch ``fused_lstm`` twice and the recurrence twice, and with
   Adam the dW kernel and its sum twice each, with Momentum neither; ms per
   step, and one step under the profiler;
4b. the nested slice: a hierarchical classifier at the same widths (an
   integer_value_sub_sequence feed of paragraphs, 1 to 8 sentences of 1
   to 16 words, T=128 -> embedding -> simple_lstm over the words -> max
   pooling to_sequence, one step a sentence -> simple_lstm over the
   sentences -> max -> fc 2; weights random from the seed) serves four
   request batches through ``infer`` (logits against the CPU run, 2
   ``fused_lstm`` launches a request); on the card the pooled sentences'
   mask must sum to each row's sentence count, and the word-level
   lstmemory must equal, bit for bit, the same layer over the same rows
   fed as a plain sequence; 4 Adam steps at B=64 against the CPU run (2
   forwards, 2 recurrences, 2 dW kernels and their sums a step); a
   SubsequenceInput group (gru_step 512 after fc 1536, B=16, T=128)
   against its CPU run and against gated_recurrent (the grid fused_gru)
   run over every sub-sequence as a row of its own; the B=64 and B=1
   request latency, nested and the flat classifier in turns, and one
   nested request under the profiler;
5. the NMT slice: dense beam-search decode (models.text.
   nmt_decode_topology at 30000/30000/512/512/512, beam 4, max_length 16;
   weights random from a seed) serves three request batches of source
   sentences; ids, scores and ticks are held against the port's CPU run,
   each request must launch ``fused_gru`` exactly twice (the two encoder
   directions); then the teacher-forced scoring form on one batch, its
   probabilities against the CPU; one decode runs under the profiler;
5b. the selective and compact-K decodes: the same topology in
   mode="selective" and mode="compact" with cand_k = 1024 candidates a
   sentence (unique, eos among them, as bench.py:466-472 builds them)
   serves the same requests; ids, scores and ticks against the port's CPU
   run, every emitted id inside its row's candidates, selective equal to
   compact, 2 ``fused_gru`` launches a request; a full-coverage compact
   decode (the whole vocab as candidates, B=1) gives the dense decode's
   ids on the card; the scoring form with 1024 candidates a row, its
   probabilities against the CPU and none off the candidates; the
   projection's row gather of W.T timed through the strided view and
   after one contiguous copy; the B=16 and B=1 request latency of the
   three modes, and one compact request under the profiler;
5c. the per-slot step decode: the same topology in compact and dense
   mode through io/merged_model.export_decode_step_ex and
   step_decode.StepDecodeDriver, 16 slots: 16 co-admitted requests in
   drain mode give the whole-loop decode's ids (scores within 1e-5) on the
   card; 48 requests of 10 source ids (max_new 4, 8 and none in turn) in
   continuous mode (at least one mid-batch admission) and drain mode give
   each request the same ids and tokens, a capped request's tokens the
   first k of its uncapped decode; every admission launches fused_gru
   twice and no tick launches it; requests/s, p50 and p95 latency, time
   to first token and ticks of both, one tick under the profiler;
5d. generation bundles: the decode at 30000 words, whose parameters pass
   JAX's 32 MiB cap, gets the cap's skip reason for both artifacts
   (``torch_export_skip_reason``, ``torch_step_skip_reason``), and
   ``driver_from_bundle_meta`` raises naming it; under the cap, at width
   512, an 800-word float32 bundle in dense and in compact mode (256
   candidates) and a 1000-word int8 compact bundle, each written by a
   worker process with the whole loop's artifact and the step's init and
   step artifacts (8 slots, T 16), decode on the card through
   ``driver_from_bundle_meta``: 8 co-admitted requests in drain mode give
   the in-process step's ids (scores within 1e-5) and the CPU artifacts'
   (1e-4); 24 requests (5c's caps) in continuous and drain mode give each
   request the same ids, and the in-process step's, fused_gru 2 launches
   an admission and none a tick; admission and tick ms, requests/s and
   p50/p95 latency beside the in-process step's, one tick under the
   profiler; the whole loop's artifact at B = 8 and 3 gives Inference's
   ids and ticks (scores within 1e-5), 2 fused_gru launches a run; the
   RNN CRF tagger's features from a bundle within 1e-5 of Inference, 2
   fused_gru_cluster launches a run (the cluster kernel through the op
   ``paddle_tpu_torch::gru_fwd``);
6. the NMT training slice: models.text.nmt_attention_cost at the same
   widths (bench.py:245 bench_nmt: dicts 30000, 512/512/512, Adam 5e-4)
   trains through ``paddle_tpu_torch.SGD(...).train`` on the card: 6 Adam
   steps at B=64 (source and target lengths 5..30, one row of 30 a batch)
   and 4 Momentum steps, their costs (and Momentum's parameters) held
   against the port's CPU run; then bench_nmt's own shape, B=256 with
   every source and target 30 long, for ms per step and target tokens a
   second, and one step under the profiler. Every step must launch
   ``fused_gru`` twice and each GRU backward kernel twice (the encoder's
   two directions);
6b. sparse-row training at tools/selfc_crossover.py's 2-D point
   (selective_fc over C = 2^20 outputs, D = 512, K = 20, B = 64,
   selection_pass_generation, gather_min_c = 1, square_error_cost; table
   and data random from a seed on the card): 3 checked and 5 timed steps
   of the sparse step (SGD lr 0.1; Adam under sparse_catchup_for), the
   plain-autodiff gather step (SGD; Adam) and the dense-mask step; the
   sparse step hands the optimizer a SparseRowGrad, leaves the table's
   .grad None and rises less than a [C, D] gradient (2 GiB) above its
   inputs in peak memory, the plain step more; SGD's parameters after 3
   steps equal the plain gather step's within 1e-6; sparse Adam's table,
   m and v, every row caught up, equal dense Adam's over the gradients it
   was handed within rtol 3e-5; the same SGD steps through SGD.train; the
   steps' medians; then sparse Adam from the state 1000 steps of uniform
   traffic leave (the rows' gaps up to 1000), its median, gaps and one
   step under the profiler;
6c. the packing-ready NMT model on padded feeds: models.text.
   nmt_packed_cost at bench.py:298 bench_nmt_packed's widths (V 30000,
   width 512, 8 heads; weights random from a seed) on its stream (256
   samples from RandomState(0), sources of 4..30 ids, targets within 2 of
   them) serves requests of 64, 1 and 17 samples through ``infer`` on its
   softmax output (probabilities against the port's CPU run, 3 fused_gru
   launches a request: two encoder directions and the decoder; one request
   under the profiler), trains 4 Adam steps of 64 samples against the
   port's CPU run, then 6 on the whole stream for ms per step and real
   target tokens a second; every step must launch fused_gru, the
   recurrence's grid kernel, the dW kernel and its sum 3 times each; one
   step under the profiler;
6d. the sparse-input models: models.text.ctr_wide_deep at bench.py:700
   bench_ctr's device-resident column (B 256, deep vocab 1,000,000, wide
   100,000, emb 16, max_ids 32, hidden 64) and ngram_lm at its defaults
   (2000/32/128, context 4, B 256) train 10 SGD steps (lr 0.05) each, the
   first 4 costs against the port's CPU run, then ms per step; no kernel
   is on these paths, and none may launch;
7. the CRF tagging slice: the kernel phase above also holds the CRF
   log-partition's four kernels (crf_fwd, a row over the W warps of
   crf_fwd_plan, each case printing its W and us a step; the backward's
   beta recursion crf_bwd, one warp a row, and its marginals
   crf_bwd_marginals, each on the plain version's inputs, then both
   together against crf_bwd_plain; crf_bwd_reduce; two launches
   bit-equal) against their plain versions at B=32, T=512, L=67 and five
   more shapes (each of the forward plan's W), and the whole crf_logz gradient
   against the CPU's; the CRF's
   forward + backward through the kernels is timed against the scan at
   T = 64..512; models.text.rnn_crf_tagger (5000/67/64/128) trains
   through ``paddle_tpu_torch.SGD(...).train`` on the card, 6 Adam and 4
   Momentum steps at B=32 (rows 256..512 long, T=512), and
   linear_crf_tagger (5000/67/32/5) 4 of each, against the port's CPU
   run (costs, Momentum's parameters); every step must launch each CRF
   kernel once (and the rnn tagger's each GRU kernel twice, its forward
   and its backward's recurrence through the cluster kernels and never
   the grid ones); one rnn
   step runs under the profiler; then the linear tagger serves three
   request batches through ``infer`` on its crf_decoding output, tags
   equal to the CPU run's and Viterbi scores within LOGIT_TOL;
8. the CTC slice: the kernel phase also holds the CTC forward-backward's
   three kernels (ctc_fwd; the backward's beta recursion ctc_bwd and its
   marginals ctc_bwd_marginals, each on the plain version's inputs, then
   both together against ctc_bwd_plain) against their plain versions at
   (T, B, S) = (512, 32, 65), the training path's, and eight more cases
   (S=41, T 2048 and 128, B=1, an empty and a repeated label, blank != 0,
   S=201, S=512), each recursion's two launches bit-equal and each case
   with its states a lane and us a step, with F.ctc_loss timed as the
   forward's and the recursion's library call and its NLLs held against
   the kernels'; the whole
   ctc_nll_kernel gradient against the CPU's; the CTC forward + backward
   through the kernels timed against the scan and F.ctc_loss at T = 128,
   512, 2048; a 161 -> fc 128 -> warp_ctc model (tools/ctc_bench.py
   bench_ctc's widths, DeepSpeech2's 161 spectrogram features) trains
   through ``paddle_tpu_torch.SGD(...).train`` on the card with CTC_IMPL =
   "kernel", 6 Adam and 4 Momentum steps at B=32, T=512, against the
   port's CPU run (costs, the first step's ctc_error equal, Momentum's
   parameters); every step must launch each CTC kernel once; one step
   runs under the profiler;
9. the library kernels: vocab_xent's five kernels (csrc/vocab_xent.cu:
   the forward's partials and their combine, dx's partials and their sum,
   dW and db; the forward, dx and dW on the tensor cores, in three TF32
   passes; the forward's two launches bit-equal at both main paths'
   shapes) against their plain versions at bench_nmt's output
   projection, (N, D, V) = (7680, 512, 30000), and eight more cases (the
   second main path's (512, 512, 30000), where dx takes several slices
   and their sum runs on them, each kernel timed there too; the JAX
   test's shape, V and D off the kernels' tiles, D past the dW kernel's
   512-row register tile, N = 1, out-of-range labels, a bias of 100),
   with matmul + F.cross_entropy and products of its logits' gradient
   timed as their library calls (the dx sum's reported row at the
   second main path's 16 slices on [16, 512, 512], bit-equal to its plain
   version in every case, part.sum(0) its library call; also timed at 2
   slices of the first shape, where the path takes none); at
   that shape two launches each of dx and dW must be bit for bit equal,
   and the PyTorch composites of dx's and dW/db's whole functions are
   timed beside their one-call yardsticks; vocab_xent's forward +
   backward through autograd at that shape (one dx slice) must launch
   each kernel once but the dx sum, which it must not launch, and stay
   under 10% of the [N, V] logits in extra peak memory, and at (512, 512,
   30000) (several slices) each kernel once; then
   maxpool_bwd (csrc/pool.cu) bit for bit against its plain version at
   bench_resnet50's stem pool, [256, 112, 112, 64], and eleven more cases
   (the JAX test's shapes, C = 3 and 48, ties, a NaN; HO and WO off the
   strip kernel's TW, the smallest image, C = 100, a misaligned x), each
   with the plan the wrapper launched (the strip kernel, or the
   thread kernel for C % 4 != 0 and the misaligned x; the report shape
   must take the strip kernel), timed beside the thread kernel forced
   there, the copy floor (csrc/pool_copy_floor.cu, built beside the
   kernels) and max_pool2d's backward, its yardstick; and
   maxpool_3x3s2p1's forward + backward through autograd launching it
   once.

The line before the last is one JSON object with every kernel's numbers;
the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# float32 products on the card run in full float32: the plain versions
# and the CPU reference then do the same arithmetic as the kernels
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# an H100 SXM's published peaks (dense): memory rate, float32 rate
# outside the tensor cores and TF32 rate on them, the units of each
# kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

# kernel vs plain version on the card: both float32, the sums over H run
# in another order; over T=100 steps the gap stays near 1e-6
KERNEL_ATOL = 1e-4
# backward kernels vs their plain version, per output, relative to its
# largest |value| (at least 1): dW and db sum B*T (row, step) terms in
# another order, and db's entries reach 100
KERNEL_BWD_RTOL = 1e-4
# port on the card vs the port on the CPU: recurrences, attention, fcs,
# every sum in another order
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

SEED = 1234

# cuda_ms's spin: at most 50 ms, in cycles of an H100's SM clock (some
# 1.98 GHz at most; a slower clock only lengthens the spin)
SPIN_MAX_S, SPIN_CYCLES_PER_S = 0.05, 2e9

# the LSTM slice: the repo's RNN benchmark widths (bench.py:175
# bench_lstm builds emb_dim = hidden = 512; 128 is only the model's
# default)
DICT, EMB, HIDDEN, LAYERS = 30000, 512, 512, 2
REQUEST_BATCHES = (64, 1, 17, 64)

# bundle-backed serving: the classifier's rows of BUNDLE_T ids, every id
# valid, at the batches of BUNDLE_BATCHES; its outputs against the CPU's
# machine on the same bundle within BUNDLE_TOL (the kernel and the plain
# version sum in another order; the f32 classifier's logits agree to 1e-7
# in phase 3); the forward's artifact at EXPORT_DICT words (under the
# 32 MiB cap), static batch EXPORT_BATCH and EXPORT_T steps, against the
# card's machine within EXPORT_TOL (the same kernel on the same shapes)
# and the CPU's within BUNDLE_TOL
BUNDLE_BATCHES, BUNDLE_T = (64, 1), 128
BUNDLE_TOL = dict(rtol=1e-5, atol=1e-6)
EXPORT_DICT, EXPORT_BATCH, EXPORT_T = 2000, 8, 16
EXPORT_TOL = dict(rtol=1e-6, atol=1e-6)

# the training slice: bench_lstm's batch and optimizer (B=64, Adam 1e-3)
TRAIN_B, TRAIN_STEPS, TRAIN_CHECKED = 64, 8, 4
# card vs CPU training: per-batch costs rtol 1e-4 with Momentum (linear in
# the gradient) and 1e-3 with Adam (g / sqrt(v) turns the sign noise of a
# tiny gradient into a full-size step); Momentum's parameters after 4
# steps atol 1e-4
TRAIN_COST_RTOL = {"momentum": 1e-4, "adam": 1e-3}
TRAIN_PARAM_ATOL = 1e-4

# the nested slice: paragraphs of 1..NESTED_SENTENCES sentences of
# 1..NESTED_WORDS word ids through the classifier's widths; a batch's
# first row is NESTED_SENTENCES x NESTED_WORDS, so T buckets to 128 as in
# the classifier's requests; NESTED_TRAIN_STEPS Adam steps of TRAIN_B
# rows; the SubsequenceInput group check at B = NESTED_GROUP_B
NESTED_SENTENCES, NESTED_WORDS = 8, 16
NESTED_TRAIN_STEPS, NESTED_GROUP_B = 4, 16
NESTED_FEEDING = {"para": 0, "label": 1}

# the NMT slice: the repo's decode benchmark widths (bench.py:421)
NMT = dict(src_dict_dim=30000, trg_dict_dim=30000, word_vector_dim=512,
           encoder_size=512, decoder_size=512)
BEAM, MAX_LEN, EOS = 4, 16, 1
NMT_BATCHES = (16, 1, 5)
# the random output projection is drawn OUT_SCALE times wider than
# 1/sqrt(fan_in), so its logits spread and the beam's top-k gaps stay far
# above the card/CPU score differences; eos's output bias is raised by
# EOS_BIAS so some requests end early (the B=1 request of this seed),
# which runs the early exit and its closed-form completion, while the
# others run all MAX_LEN ticks
OUT_SCALE, EOS_BIAS = 4.0, 1.0
# the selective and compact decodes: bench.py:420's candidate lists
# (cand_k = 1024 unique ids a sentence, eos among them), the same
# requests and weights; the scoring form with as many candidates
MODES = ("dense", "selective", "compact")
SELECT_MODES = MODES[1:]
CAND_K = SCORING_K = 1024
SELECT_FEEDING = {"src": 0, "cand": 1}
LATENCY_ROUNDS = 5
# the per-slot step decode: STEP_SLOTS slots over STEP_REQUESTS requests of
# STEP_SRC_LEN source ids (padded to the feeder's bucket, STEP_SEQ_LEN, the
# whole loop's T), the i-th capped at STEP_CAPS[i % 3] ticks (None: none)
STEP_SLOTS, STEP_REQUESTS, STEP_SRC_LEN, STEP_SEQ_LEN = 16, 48, 10, 16
STEP_CAPS = (4, 8, None)
# eos's bias in the step phase's weights: at EOS_BIAS these 10-id sources
# end every decode within a few ticks, where caps of 4 and 8 bind on
# nothing; at 0.5 the uncapped compact decodes end from the second tick
# to the last, and the dense ones run every tick
STEP_EOS_BIAS = 0.5
# generation bundles (phase 5d): at 30000 words the decode's parameters
# (202.92 MiB in float32, 152.35 in int8: only the two embedding tables
# quantize) pass JAX's 32 MiB cap on an artifact's constants, so under it
# at width 512 only the vocabulary is cut: GEN_BUNDLES are (label, words,
# decode mode, parameter dtype), compact mode with GEN_CAND_K candidates
# a sentence. Each bundle carries the whole loop's artifact at static
# batch GEN_BATCHES[0] and the step's at GEN_SLOTS slots (merged_model's
# DECODE_EXPORT_SLOTS), both at STEP_SEQ_LEN; GEN_REQUESTS requests of
# STEP_SRC_LEN ids stream through the slots with 5c's caps. The RNN CRF
# tagger's features ride a bundle too, run at GEN_BATCHES, T = EXPORT_T
GEN_BUNDLES = (("f32-dense", 800, "dense", "f32"),
               ("f32-compact", 800, "compact", "f32"),
               ("int8-compact", 1000, "compact", "int8"))
GEN_TAGGER = "tagger"
GEN_CAND_K, GEN_SLOTS, GEN_REQUESTS = 256, 8, 24
GEN_BATCHES = (8, 3)
# the artifacts on the card against the in-process step decode and
# Inference on the card (the same kernels on the same shapes), and
# against the artifacts on the CPU (every sum in another order)
GEN_TOL, GEN_CPU_TOL = 1e-5, 1e-4

# the NMT training slice: bench_nmt's optimizer (Adam 5e-4) and batch
# (256 sentence pairs of 30 tokens each side); the checked runs take B=64,
# lengths 5..30 (T buckets to 32)
NMT_TRAIN_B, NMT_TRAIN_STEPS, NMT_BENCH_B, NMT_BENCH_T = 64, 6, 256, 30
NMT_FEEDING = {"src": 0, "trg": 1, "trg_next": 2}
# bench_nmt feeds [256, 30] as it is: T rounds to a multiple of 30, not to
# the feeder's default power of two
NMT_BENCH_FEED = dict(feeding=NMT_FEEDING, bucket_rounding=NMT_BENCH_T)

# the packing-ready NMT model on padded feeds: bench.py:298
# bench_nmt_packed's widths (V 30000, width 512, 8 heads), optimizer (Adam
# 5e-4) and stream (PACKED_B samples from RandomState(0), sources of
# PACKED_LENGTHS ids, targets within 2 of them and at least 3); requests of
# PACKED_REQUESTS samples from the stream's head, PACKED_CHECKED Adam steps
# of PACKED_TRAIN_B samples (the stream in four batches) against the CPU,
# then PACKED_TIMED steps on the whole stream, as the bench times one batch
PACKED = dict(src_dict_dim=30000, trg_dict_dim=30000, word_vector_dim=512,
              encoder_size=512, decoder_size=512, num_heads=8)
PACKED_B, PACKED_LENGTHS, PACKED_TRAIN_B = 256, (4, 30), 64
PACKED_REQUESTS, PACKED_CHECKED, PACKED_TIMED = (64, 1, 17), 4, 6
PACKED_SERVE_FEEDING = {"src": 0, "trg": 1}
# its softmax output against the CPU: probabilities near 1 / V, so an
# absolute floor far under them
PACKED_PROB_TOL = dict(rtol=1e-4, atol=1e-7)

# the sparse-input models: bench.py:700 bench_ctr's device-resident column
# (B 256, deep_vocab 1,000,000, wide_dim 100,000, emb 16, max_ids 32, hidden
# 64, SGD lr 0.05; rows of 1..max_ids unique ids) and ngram_lm at its
# defaults (2000/32/128, context 4) at B 256 with the same SGD;
# SPARSE_INPUT_CHECKED steps against the CPU at rtol 1e-4, then
# SPARSE_INPUT_TIMED on the card
CTR = dict(wide_dim=100_000, deep_vocab=1_000_000, emb_dim=16, max_ids=32,
           hidden=64)
CTR_FEEDING = {"wide_ids": 0, "deep_ids": 1, "click": 2}
NGRAM_FEEDING = {"w0": 0, "w1": 1, "w2": 2, "w3": 3, "next_word": 4}
SPARSE_INPUT_B, SPARSE_INPUT_CHECKED, SPARSE_INPUT_TIMED = 256, 4, 10
SPARSE_INPUT_LR, SPARSE_INPUT_RTOL = 0.05, 1e-4

# sparse-row training: tools/selfc_crossover.py's 2-D point (selective_fc
# over C = 2^20 outputs, D = 512, K = 20 ids a row, B = 64, fill 0, into
# square_error_cost), SPARSE_CHECKED steps checked, SPARSE_TIMED timed
SPARSE_C, SPARSE_D, SPARSE_K, SPARSE_B = 1 << 20, 512, 20, 64
SPARSE_CHECKED, SPARSE_TIMED = 3, 5
# the step whose state the late sparse Adam steps start from
SPARSE_LATE_STEP = 1000
SPARSE_TABLE = "_sf.w0"

# the CRF tagging slice: the v1_api_demo/sequence_tagging taggers at their
# published widths (models/text.py: words 5000, labels 67; linear: emb 32,
# context 5; rnn: emb 64, hidden 128) on document-length batches, as
# tools/ctc_bench.py bench_crf runs B=32 at T 128..2048: B=32 rows 256 to
# 512 long, one of 512 a batch (T=512), where the layer takes the kernels
CRF_WORDS, CRF_LABELS, CRF_B, CRF_T = 5000, 67, 32, 512
LINEAR_CRF = dict(word_dim=CRF_WORDS, label_dim=CRF_LABELS, emb_dim=32,
                  context_len=5)
RNN_CRF = dict(word_dim=CRF_WORDS, label_dim=CRF_LABELS, emb_dim=64,
               hidden=128)
RNN_CRF_ADAM_STEPS, CRF_CHECKED = 6, 4
# Momentum (0.9) at lr 1e-4: a row's cost sums some 400 per-token terms
# (about 1650 at these weights), so its gradients are some 400x a
# per-token cost's; card and CPU gradients agree to the float32 accuracy
# of posteriors formed from log-domain sums of some 2000
CRF_MOMENTUM_LR = 1e-4
CRF_REQUESTS = (32, 1, 5)
CRF_FEEDING = {"words": 0, "labels": 1}
# the linear tagger's weights lie on a grid of 1/32: its emissions (sums of
# products of grid values) and every Viterbi sum are then exact in float32
# in any order, so card and CPU take the same path through every tie
CRF_GRID = 32.0
# the CRF kernels against their plain versions, relative to each output's
# largest |value| (at least 1): alphas, betas and logz grow to some
# T log L (about 2100 at T=512, L=67), where a float32 ulp is 2.4e-4, and
# the kernels round each step's sums in another order
CRF_FWD_RTOL, CRF_BWD_RTOL = 1e-5, 1e-3
# the H100's crossover of the CRF's forward + backward: kernels against
# the scan (autograd through the time loop), B=32, L=67
CROSSOVER_T = (64, 128, 256, 512)
# the CRF kernels' cases (B, T, L, kind): the main paths' shape, a shorter
# T, one full row, another L that is not a multiple of 32, an L of 4 tags
# a lane, the largest L the kernels take (the forward's plan takes W = 4
# warps a row at L = 67 and 45, 8 at L = 100, 16 at L = 169)
CRF_REPORT = (CRF_B, CRF_T, CRF_LABELS)
CRF_KERNELS = ("crf_fwd", "crf_bwd", "crf_bwd_marginals", "crf_bwd_reduce")
CRF_CASES = [CRF_REPORT + ("documents",), (CRF_B, 256, CRF_LABELS, "documents"),
             (1, CRF_T, CRF_LABELS, "full"), (7, 300, 45, "ragged"),
             (3, 200, 100, "ragged"), (4, 64, 169, "ragged")]

# the CTC slice: tools/ctc_bench.py:35 bench_ctc's widths and traffic (B=32,
# C=128 classes with blank 0, U=20 labels a row, input lengths 2U+1..T) on
# a model built in the DSL: 161 DeepSpeech2 spectrogram features (20 ms
# windows, 10 ms stride at 16 kHz) -> fc 128 (linear) -> warp_ctc, with a
# ctc_error evaluator on the fc output; B=32, T=512, rows 41..512 frames
# (one of 512 a batch), labels 1..20 long (one of 20 a batch)
CTC_FEATURES, CTC_CLASSES, CTC_U, CTC_B, CTC_T = 161, 128, 20, 32, 512
CTC_S = 2 * CTC_U + 1
CTC_ADAM_STEPS, CTC_CHECKED = 6, 4
CTC_FEEDING = {"frames": 0, "labels": 1}
# Momentum (0.9) at lr 1e-4, as the CRF taggers': a row's cost sums some
# 500 frames' terms (about 2300 at these weights)
CTC_MOMENTUM_LR = 1e-4
# the CTC kernels against their plain versions, relative to each output's
# largest |value| over the live states (at least 1; NEG, -1e30, marks the
# dead ones): alphas and betas grow to some T ln C (about 2500 at T=512,
# C=128), where a float32 ulp is 2.4e-4, and the backward's posteriors
# exp(alpha + beta - ll) inherit that absolute error from the exponent
CTC_FWD_RTOL, CTC_BWD_RTOL = 1e-5, 1e-3
# the feeder pads the labels of a batch to the next power of two, 20 to
# 32, so the training path's kernels run S = 65 states (N = 3 a lane)
CTC_PATH_S = 65
# the CTC kernels' cases (B, T, S, kind): the training path's problem (its
# labels 1..20 padded to 32), bench_ctc's U=20 at T = 512, a longer and a
# shorter T, one full row, a batch with an empty and a repeated label,
# blank != 0, S = 201 (N = 8 a lane), the largest S the kernels take
# (N = 16)
CTC_REPORT = (CTC_B, CTC_T, CTC_PATH_S)
CTC_CASES = [CTC_REPORT + ("path",), (CTC_B, CTC_T, CTC_S, "ragged"),
             (CTC_B, 2048, CTC_S, "ragged"), (CTC_B, 128, CTC_S, "ragged"),
             (1, CTC_T, CTC_S, "full"), (8, 256, CTC_S, "labels"),
             (8, 256, CTC_S, "blank"), (16, 600, 201, "ragged"),
             (4, 1100, 512, "ragged")]
# the H100's crossover of the CTC forward + backward: the kernels against
# the scan (autograd through the time loop) and F.ctc_loss
CTC_CROSSOVER_T = (128, 512, 2048)

# phase 9, the library kernels, at the shapes they were written for: the
# NMT output projection of bench.py:245 bench_nmt (256 x 30 target tokens,
# decoder 512, dict 30000) and the ResNet-50 stem pool of bench.py:100
# bench_resnet50 ([256, 112, 112, 64] -> 56 x 56). Neither package calls
# either function from a layer: their main paths are the public functions'
# forward + backward through autograd
XENT_REPORT = (7680, 512, 30000)
# a second main path, where the dx kernel takes several vocabulary slices
# and their sum runs: bench_nmt's projection at 512 rows
XENT_SLICED = (512, 512, 30000)
XENT_CASES = [XENT_REPORT + ("report",), XENT_SLICED + ("sliced",),
              (37, 16, 300, "jax test"),
              (512, 64, 30001, "V off the tile"),
              (300, 200, 4100, "D off the tile"),
              (300, 1000, 4100, "D past a chunk"), (1, 512, 30000, "one row"),
              (500, 64, 3000, "labels out of range"),
              (500, 64, 3000, "bias 100")]
XENT_KERNELS = ("vocab_xent_fwd", "vocab_xent_fwd_reduce", "vocab_xent_bwd_dx",
                "vocab_xent_bwd_dx_reduce", "vocab_xent_bwd_dw")
# extra peak device memory of vocab_xent's forward + backward at
# XENT_REPORT, as a share of the [N, V] float32 logits that the library
# path writes
XENT_MEMORY_SHARE = 0.10
POOL_REPORT = (256, 112, 112, 64)
# the pool's cases: the JAX test's shapes, C = 3 (the thread kernel) and
# 48, ties, a NaN; for the strip kernel, HO and WO off its TW window
# columns, the smallest image, a C of 100 (a multiple of 4, not of 64: a
# second, partial channel slice), and an x that starts 4 bytes past a
# 16-byte boundary (the thread kernel)
POOL_CASES = [POOL_REPORT + ("randn",), (2, 8, 8, 64, "randn"),
              (1, 12, 16, 128, "randn"), (3, 6, 10, 64, "randn"),
              (2, 8, 10, 3, "randn"), (2, 16, 12, 48, "randn"),
              (4, 16, 16, 64, "ties"), (2, 8, 8, 64, "nan"),
              (2, 18, 26, 64, "randn"), (1, 2, 2, 4, "randn"),
              (2, 12, 20, 100, "ties"), (2, 18, 26, 64, "misaligned")]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters calls, after one warm-up. A spin
    on the stream (torch.cuda._sleep) holds the device while the host
    enqueues the calls, so that the events time the device's work back to
    back, not the host's launch overhead (some 10 to 30 us a wrapper call,
    more than a small kernel takes). The spin lasts as long as one call
    took, host and device, times iters, at most SPIN_MAX_S."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(once * iters, SPIN_MAX_S) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_weights(topo, adjust=None):
    """Weights from numpy seed SEED: std 1/sqrt(fan_in), biases 0.1;
    ``adjust`` maps a parameter's name to a function of its array."""
    r = np.random.RandomState(SEED)
    out = {}
    for name, spec in sorted(topo.param_specs().items()):
        std = 0.1 if spec.is_bias else 1.0 / np.sqrt(spec.fan_in)
        out[name] = (r.randn(*spec.shape) * std).astype(np.float32)
    for name, f in (adjust or {}).items():
        out[name] = f(out[name])
    return out


# --- kernels ---------------------------------------------------------------

def recurrent_inputs(B, T, H, gates, n_bias, lengths, with_reset, seed):
    """x [B, T, gates*H], W [H, gates*H] (the GRU's split into Wg and Wc
    by the caller), bias [n_bias], mask [B, T], reset [B, T] or None."""
    r = np.random.RandomState(seed)
    mask = (np.arange(T)[None] < np.asarray(lengths)[:, None])
    arrays = [(r.randn(B, T, gates * H) * 0.5).astype(np.float32),
              (r.randn(H, gates * H) / np.sqrt(H)).astype(np.float32),
              (r.randn(n_bias) * 0.1).astype(np.float32),
              mask.astype(np.float32)]
    if with_reset:
        arrays.append((r.rand(B, T) < 0.1).astype(np.float32) * arrays[3])
    out = [torch.from_numpy(a).cuda() for a in arrays]
    return out + [None] * (5 - len(out))


def lstm_args(B, T, H, lengths, with_reset, seed):
    return recurrent_inputs(B, T, H, 4, 7 * H, lengths, with_reset, seed)


def gru_args(B, T, H, lengths, with_reset, seed):
    x3, w, bias, mask, reset = recurrent_inputs(B, T, H, 3, 3 * H, lengths,
                                                with_reset, seed)
    return [x3, w[:, :2 * H].contiguous(), w[:, 2 * H:].contiguous(), bias,
            mask, reset]


def recurrence_bound(x, weights, mask, other_inputs, out_elems):
    """Least time an H100 needs for a masked recurrence on these inputs:
    2 flops per weight element for every valid (row, step), in float32 on
    the CUDA cores (the gate math adds about 1% at H=512), against
    reading each input once and writing each output once."""
    n_w = sum(w.numel() for w in weights)
    flops = 2.0 * n_w * float(mask.sum().item())
    nbytes = 4.0 * (x.numel() + n_w + mask.numel() + out_elems
                    + sum(a.numel() for a in other_inputs if a is not None))
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def lstm_bound(x4, w, bias, mask, reset):
    B, T, H4 = x4.shape
    return recurrence_bound(x4, [w], mask, [bias, reset], 2 * B * T * H4 // 4)


def gru_bound(x3, wg, wc, bias, mask, reset):
    B, T, H3 = x3.shape
    return recurrence_bound(x3, [wg, wc], mask, [bias, reset], B * T * H3 // 3)


def largest(w):
    """An output's largest |value| over its live entries (NEG, -1e30,
    marks a dead CTC state), at least 1: the scale its error is taken
    relative to."""
    live = w[w > -1e29]
    return max(1.0, live.abs().max().item() if live.numel() else 0.0)


# the tensor-core kernels, (source, kernel), checked as built: every
# instance of a kernel template
TENSOR_CORE_KERNELS = (("vocab_xent", "vocab_xent_fwd_kernel"),
                       ("vocab_xent", "vocab_xent_bwd_dx_kernel"),
                       ("vocab_xent", "vocab_xent_bwd_dw_kernel"),
                       ("gru_bwd", "gru_bwd_dw_kernel"),
                       ("lstm_bwd", "lstm_bwd_dw_kernel"))


def tensor_core_build_check():
    """Each of TENSOR_CORE_KERNELS as built: its ptxas report (registers,
    shared memory, spills) from the build log and its HMMA instructions in
    the SASS (cuobjdump beside nvcc). Fails on a spill or on no HMMA."""
    from paddle_tpu_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    for source, kernel in TENSOR_CORE_KERNELS:
        lib = _build.library_path(source)
        log = lib.with_suffix(".log").read_text()
        parts = re.split(r"Compiling entry function '([^']+)'", log)
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        funcs = re.split(r"Function : (\S+)", sass)
        names = [parts[i] for i in range(1, len(parts), 2)
                 if kernel in parts[i]]
        if not names:
            raise SystemExit(f"{kernel} is not in {source}'s build log")
        for name in names:
            report = parts[parts.index(name) + 1]
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                                 report)]
            used = re.search(r"Used (\d+) registers", report)
            body = next(funcs[i + 1] for i in range(1, len(funcs), 2)
                        if funcs[i] == name)
            hmma = len(re.findall(r"\bHMMA\.", body))
            print(f"  {name}: {used.group(1) if used else '?'} registers, "
                  f"spill bytes {spills}, {hmma} HMMA instructions in its "
                  f"SASS", flush=True)
            if not spills or any(spills) or hmma == 0:
                raise SystemExit(f"{name} spills ({spills}) or runs no HMMA "
                                 f"({hmma})")


def kernel_phase(name, fn, plain, make_args, bound, outputs, main_shapes,
                 rtol=None, cases=None, report_shape=(64, 100, 512),
                 h_name="H", with_kind=False, bit_equal=False,
                 library=None, describe=None):
    """fn against plain on the card; with ``rtol``, each output's error is
    taken relative to its ``largest`` value. ``cases`` are (B, T, H, kind)
    (default: the recurrent kernels' three cases and the ``main_shapes``
    at H=512; ``h_name`` names the third size in the output); rows are
    T//4..T long, T//2..T for the kind "documents", all T for "full".
    ``make_args`` gets whether the kind is "reset", or with ``with_kind``
    the kind itself. With ``bit_equal`` a second launch must give the
    first one's bits. ``library`` (a function of the same arguments), one
    PyTorch call for the same function, is timed at ``report_shape``.
    ``describe(B, T, H, ms)`` adds words to each case's line. Returns the
    row of the first case at ``report_shape``, the shape PERF.md
    reports."""
    if cases is None:
        cases = [(64, 100, 512, "ragged"), (5, 37, 128, "reset"),
                 (1, 100, 512, "full")]
        # (B, T) of a main path with ragged rows, or (B, T, kind)
        cases += [(s[0], s[1], 512, s[2] if len(s) > 2 else "main path")
                  for s in main_shapes]
    report = None
    print(f"kernel {name} vs {name}_plain (pass: max_abs_err <= "
          + (f"{rtol} x max(1, max|plain| over live entries) per output)"
             if rtol else
             f"{KERNEL_ATOL})"))
    for i, (B, T, H, kind) in enumerate(cases):
        r = np.random.RandomState(i)
        low = T // 2 if kind == "documents" else T // 4
        lengths = np.full(B, T) if kind == "full" else \
            np.maximum(1, r.randint(low, T + 1, size=B))
        lengths[0] = T
        args = make_args(B, T, H, lengths,
                         kind if with_kind else kind == "reset", SEED + i)
        got = outputs(fn(*args))
        torch.cuda.synchronize()
        if bit_equal and not all(torch.equal(g, a) for g, a in
                                 zip(got, outputs(fn(*args)))):
            raise SystemExit(f"two launches of {name} differ at B={B} T={T} "
                             f"{h_name}={H}")
        want = outputs(plain(*args))
        diffs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        err = max(diffs)
        if rtol:
            limit = max(d / largest(w) / rtol for d, w in zip(diffs, want))
        else:
            limit = err / KERNEL_ATOL
        ok = bool(np.isfinite(err)) and limit <= 1.0
        ms = cuda_ms(lambda: fn(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 3)
        bound_ms, bound_by = bound(*args)
        print(f"  B={B} T={T} {h_name}={H} {kind}: max_abs_err={err:.3e} "
              f"({limit:.2f} of the limit) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}){'; two launches bit-equal' if bit_equal else ''}"
              f"{'; ' + describe(B, T, H, ms) if describe else ''}"
              f" {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version "
                             f"at B={B} T={T} {h_name}={H}: {err}")
        if (B, T, H) == report_shape and report is None:
            report = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            if library is not None:
                report["library_ms"] = cuda_ms(lambda: library(*args), 20)
                print(f"  library call at B={B} T={T} {h_name}={H}: "
                      f"{report['library_ms']:.4f} ms", flush=True)
    return report


def lstm_bwd_args(B, T, H, lengths, with_reset, seed):
    """The backward kernels' inputs: the forward kernel's outputs and gate
    stash (held against the plain forward's first) and upstream gradients,
    g_hs zero past each row's end as the layer's mask makes it; g_cs is
    None (as in training, where the cell state is unused) except in the
    reset case."""
    from paddle_tpu_torch.kernels.lstm import fused_lstm_fwd, fused_lstm_plain

    x4, w, bias, mask, reset = lstm_args(B, T, H, lengths, with_reset, seed)
    hs, cs, gates = fused_lstm_fwd(x4, w, bias, mask, reset, stash=True)
    want = fused_lstm_plain(x4, w, bias, mask, reset, with_gates=True)
    err = max((a - b).abs().max().item()
              for a, b in zip((hs, cs, gates), want))
    if not err <= KERNEL_ATOL:
        raise SystemExit(f"fused_lstm's gate stash disagrees with the plain "
                         f"forward at B={B} T={T} H={H}: {err}")
    r = np.random.RandomState(seed + 1)
    g_hs = torch.from_numpy((r.randn(B, T, H) * mask.cpu().numpy()[..., None])
                            .astype(np.float32)).cuda()
    g_cs = torch.from_numpy((r.randn(B, T, H) * 0.5).astype(np.float32)) \
        .cuda() if with_reset else None
    return [w, bias, mask, reset, gates, hs, cs, g_hs, g_cs]


def lstm_bwd_bound(w, bias, mask, reset, gates, hs, cs, g_hs, g_cs):
    """Least time for the recurrence on these inputs: the dh product
    dpre @ W^T (2 flops per W element for every valid (row, step)) in
    float32 on the CUDA cores; against reading the stash, cs, the upstream
    gradients, the mask, reset, W and bias once and writing dx4 once."""
    flops = 2.0 * w.numel() * float(mask.sum().item())
    reads = [a for a in (gates, cs, g_hs, g_cs, mask, reset, w, bias)
             if a is not None]
    return crf_bound(flops, reads, [gates])


def lstm_dw_bound(dx4, hs, cs, reset, mask):
    """Least time for dW and db on these inputs: h_prev^T dpre over the
    valid (row, step) pairs (dx4 is zero at the others), 8H^2 flops a pair,
    in three TF32 passes at the TF32 rate as the kernel runs it, and some
    11H operations a pair on the CUDA cores (db's 4H adds, the peepholes'
    3H products and adds, the reset's gate on h_prev); against reading
    dx4, hs, cs and reset once and writing dW and db."""
    H = hs.shape[2]
    pairs = float(mask.sum().item())
    reads = [dx4, hs, cs] + ([reset] if reset is not None else [])
    writes = [hs.new_empty(4 * H * H + 7 * H)]
    return tensor_core_bound(3 * 8.0 * H * H * pairs, 11.0 * H * pairs,
                             reads, writes)[:2]


def lstm_whole_bound(w, bias, mask, reset, gates, hs, cs, g_hs, g_cs):
    """Least time for the default backward (the recurrence, then dW and
    db): the recurrence's bound plus the dW kernel's."""
    rec = lstm_bwd_bound(w, bias, mask, reset, gates, hs, cs, g_hs, g_cs)
    dw = lstm_dw_bound(gates, hs, cs, reset, mask)
    return rec[0] + dw[0], "operations"


def lstm_dw_args(B, T, H, lengths, with_reset, seed):
    """The dW kernel's inputs (dx4 from the recurrence, hs, cs, reset, the
    split count) and the mask."""
    from paddle_tpu_torch.kernels.lstm import fused_lstm_bwd_nodw, \
        lstm_dw_splits

    args = lstm_bwd_args(B, T, H, lengths, with_reset, seed)
    mask, reset, hs, cs = args[2], args[3], args[5], args[6]
    return [fused_lstm_bwd_nodw(*args), hs, cs, reset,
            lstm_dw_splits(B * T, H), mask]


def lstm_reduce_args(B, T, H, lengths, with_reset, seed):
    """The dW sum's input: the dW kernel's partials at the shape's split
    count (more than one)."""
    from paddle_tpu_torch.kernels.lstm import lstm_dw_partials

    dx4, hs, cs, reset, S, _ = lstm_dw_args(B, T, H, lengths, with_reset,
                                            seed)
    if S == 1:
        raise SystemExit(f"the dW kernel takes one split at B={B} T={T} "
                         f"H={H}: its sum is not on a path")
    return [lstm_dw_partials(dx4, hs, cs, reset, S)]


def lstm_plan(B, T, H, ms):
    """The recurrence's blocks at (B, H), and its time a step."""
    from paddle_tpu_torch.kernels.lstm import lstm_bwd_plan

    plan = lstm_bwd_plan(B, H)
    return (f"plan U={plan.U} R={plan.R}, {plan.blocks} blocks of "
            f"{plan.smem} bytes; {ms * 1e3 / T:.3f} us a step")


def lstm_fwd_plan_line(B, T, H, ms):
    """The forward's blocks at (B, H), and its time a step."""
    from paddle_tpu_torch.kernels.lstm import lstm_fwd_plan

    plan = lstm_fwd_plan(B, H)
    return (f"plan U={plan.U} R={plan.R}"
            f"{' (4 units, every row)' if plan.R == 0 else ''}, "
            f"{plan.blocks} blocks of {plan.smem} bytes; "
            f"{ms * 1e3 / T:.3f} us a step")


def gru_bwd_args(B, T, H, lengths, with_reset, seed):
    """The GRU backward kernels' inputs: the forward kernel's hs and z|r|c
    stash (held against the plain forward's first) and g_hs, zero past
    each row's end as the layer's mask makes it."""
    from paddle_tpu_torch.kernels.gru import fused_gru_fwd, fused_gru_plain

    x3, wg, wc, bias, mask, reset = gru_args(B, T, H, lengths, with_reset,
                                             seed)
    hs, gates = fused_gru_fwd(x3, wg, wc, bias, mask, reset, stash=True)
    want = fused_gru_plain(x3, wg, wc, bias, mask, reset, with_gates=True)
    err = max((a - b).abs().max().item() for a, b in zip((hs, gates), want))
    if not err <= KERNEL_ATOL:
        raise SystemExit(f"fused_gru's stash disagrees with the plain "
                         f"forward at B={B} T={T} H={H}: {err}")
    r = np.random.RandomState(seed + 1)
    g_hs = torch.from_numpy((r.randn(B, T, H) * mask.cpu().numpy()[..., None])
                            .astype(np.float32)).cuda()
    return [wg, wc, mask, reset, gates, hs, g_hs]


def gru_dw_args(B, T, H, lengths, with_reset, seed):
    """The dW kernel's inputs (dx3 from the recurrence kernel, the stash,
    hs, reset), after the whole backward (both kernels) is held against
    fused_gru_bwd_plain on the same inputs."""
    from paddle_tpu_torch.kernels.gru import fused_gru_bwd, fused_gru_bwd_plain

    args = gru_bwd_args(B, T, H, lengths, with_reset, seed)
    got = fused_gru_bwd(*args)
    want = fused_gru_bwd_plain(*args)
    limit = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
                for g, w in zip(got, want)) / KERNEL_BWD_RTOL
    if not limit <= 1.0:
        raise SystemExit(f"the GRU backward (both kernels) disagrees with "
                         f"fused_gru_bwd_plain at B={B} T={T} H={H}: "
                         f"{limit:.2f} of the limit")
    mask, reset, gates, hs = args[2:6]
    return [got[0], gates, hs, reset, mask]


def gru_bwd_bound(wg, wc, mask, reset, gates, hs, g_hs):
    """Least time for the recurrence on these inputs: the two dh products
    dc_pre @ Wc^T and dg @ Wg^T (2 flops per weight element, 6H^2 a valid
    (row, step)) in float32 on the CUDA cores; against reading the stash,
    hs, g_hs, the mask, reset and the weights once and writing dx3."""
    flops = 2.0 * (wg.numel() + wc.numel()) * float(mask.sum().item())
    reads = [gates, hs, g_hs, mask, reset, wg, wc]
    nbytes = 4.0 * (sum(a.numel() for a in reads if a is not None)
                    + gates.numel())
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def gru_dw_bound(dx3, gates, hs, reset, mask, tensor_cores=True):
    """Least time for dWg, dWc and db on these inputs: h_prev^T dg and
    (r h_prev)^T dc_pre over the valid (row, step) pairs (dx3 is zero at
    the others), 6H^2 flops a pair, and some 5H operations a pair on the
    CUDA cores (r h_prev, the reset's gate, db's 3H adds); against reading
    dx3, r, hs and reset once and writing the three outputs. With
    ``tensor_cores`` (the kernel's arithmetic since it runs 3xTF32
    mma.sync) the products count three TF32 passes at the TF32 rate, as
    vocab_xent's dx and dW bounds do; else all of it is float32 on the
    CUDA cores. Returns (ms, what bounds it)."""
    H = hs.shape[2]
    pairs = float(mask.sum().item())
    flops = 2.0 * 3 * H * H * pairs
    reads = [dx3, gates[..., H:2 * H], hs] + (
        [reset] if reset is not None else [])
    writes = [hs.new_empty(3 * H * H + 3 * H)]
    if tensor_cores:
        return tensor_core_bound(3 * flops, 5.0 * H * pairs, reads,
                                 writes)[:2]
    return crf_bound(flops + 5.0 * H * pairs, reads, writes)


# the dW kernel at its two main paths' widths: the NMT encoder's report
# shape (ragged rows) and the RNN CRF tagger's (B=32, T=512, H=128, with
# bench_crf's rows 256..512 long, the kind "documents")
GRU_DW_REPORT = (64, 100, 512)
GRU_DW_TAGGER = (CRF_B, CRF_T, RNN_CRF["hidden"])


# the GRU kernels a training step launches
GRU_TRAIN_KERNELS = ("fused_gru", "fused_gru_cluster", "fused_gru_bwd",
                     "fused_gru_bwd_cluster", "fused_gru_bwd_dw",
                     "fused_gru_bwd_dw_reduce")


def gru_train_launches(B, T, H, n=2):
    """Each GRU kernel's launches in a training step with n GRUs of
    (B, T, H) (two: the NMT encoder's directions, the tagger's): the
    forward n times through the kernel gru_fwd_plan picks (the grid one,
    or the cluster one) and never through the other, the recurrence n
    times through the kernel gru_bwd_plan picks and never through the
    other, dW n times, and dW's sum n times where its pairs are split."""
    from paddle_tpu_torch.kernels.gru import (gru_bwd_plan, gru_dw_splits,
                                              gru_fwd_plan)

    fwd = gru_fwd_plan(B, H).path == "cluster"
    bwd = gru_bwd_plan(B, H).path == "cluster"
    return dict(zip(GRU_TRAIN_KERNELS,
                    (n * (not fwd), n * fwd, n * (not bwd), n * bwd, n,
                     n * int(gru_dw_splits(B * T, H) > 1))))


# the cluster kernels' cases (the forward's and the backward's): the RNN
# CRF tagger's shape (bench_crf's rows, and with resets), the recurrent
# kernels' reset case and one row at its width, a batch that takes 16 rows
# a cluster, and hidden 256
GRU_CLUSTER_CASES = [GRU_DW_TAGGER + ("documents",),
                     GRU_DW_TAGGER + ("reset",), (5, 37, 128, "reset"),
                     (1, 100, 128, "full"), (200, 20, 128, "ragged"),
                     (64, 100, 256, "ragged")]


def gru_cluster_fwd(x3, *args):
    """[hs, stash] of fused_gru's forward through the kernel gru_fwd_plan
    picks, which must be the cluster one."""
    from paddle_tpu_torch.kernels.gru import fused_gru_fwd, gru_fwd_plan

    B, _, H3 = x3.shape
    if gru_fwd_plan(B, H3 // 3).path != "cluster":
        raise SystemExit(f"the GRU forward's plan at (B, H) = ({B}, "
                         f"{H3 // 3}) is not the cluster kernel")
    return list(fused_gru_fwd(x3, *args, stash=True))


def gru_cluster_bwd(wg, wc, mask, reset, gates, hs, g_hs):
    """dx3 of the backward's recurrence through the kernel gru_bwd_plan
    picks, which must be the cluster one."""
    from paddle_tpu_torch.kernels.gru import fused_gru_bwd_dx3, gru_bwd_plan

    B, _, H = hs.shape
    if gru_bwd_plan(B, H).path != "cluster":
        raise SystemExit(f"the GRU backward's plan at (B, H) = ({B}, {H}) "
                         f"is not the cluster kernel")
    return fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs)


def gru_grid_bwd(wg, wc, mask, reset, gates, hs, g_hs):
    """dx3 of the backward's recurrence through the grid kernel, whatever
    the plan picks."""
    from paddle_tpu_torch.kernels.gru import bwd_grid_plan, fused_gru_bwd_dx3

    B, _, H = hs.shape
    return fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs,
                             plan=bwd_grid_plan(B, H))


def gru_path(ran, backward=False):
    """A kernel phase's ``describe`` for a GRU forward (or with
    ``backward`` the backward's recurrence) through the ``ran`` kernel
    ("grid" or "cluster"): that kernel's time a step, and the kernel
    gru_fwd_plan (gru_bwd_plan) picks at (B, H)."""
    def describe(B, T, H, ms):
        from paddle_tpu_torch.kernels.gru import gru_bwd_plan, gru_fwd_plan

        plan = (gru_bwd_plan if backward else gru_fwd_plan)(B, H)
        return (f"the {ran} kernel {ms * 1e3 / T:.3f} us a step; the plan "
                f"at (B, H) = ({B}, {H}): {plan.path}"
                + (f" C={plan.C} R={plan.R}" if plan.path == "cluster"
                   else ""))
    return describe


def gru_dw_widths(rows):
    """fused_gru_bwd_dw at GRU_DW_REPORT and GRU_DW_TAGGER (the kernel
    phase holds it there, two launches bit-equal): the dW kernel alone
    (its S partials), the whole function (with the sum where S > 1), its
    sum, ``part.sum(0)`` and
    gru_dw_db_plain (the library composite: two float32 torch.matmul and a
    sum) timed; the tensor-core and float32 bounds; the sum bit for bit
    against its plain version. Sets the dW row's ms (the kernel alone) and
    library_ms in ``rows``; returns the sum's row at GRU_DW_TAGGER, where
    the most splits run."""
    from paddle_tpu_torch.kernels import gru as tg

    reduce_row = None
    for i, (shape, kind) in enumerate(((GRU_DW_REPORT, "ragged"),
                                       (GRU_DW_TAGGER, "documents"))):
        B, T, H = shape
        r = np.random.RandomState(i)
        low = T // 2 if kind == "documents" else T // 4
        lengths = np.maximum(1, r.randint(low, T + 1, size=B))
        lengths[0] = T
        dx3, gates, hs, reset, mask = gru_dw_args(B, T, H, lengths, False,
                                                  SEED + 11 + i)
        S = tg.gru_dw_splits(B * T, H)
        part = tg.gru_dw_partials(dx3, gates, hs, reset, S)
        kernel_ms = cuda_ms(lambda: tg.gru_dw_partials(dx3, gates, hs, reset,
                                                       S), 20)
        whole_ms = cuda_ms(lambda: tg.fused_gru_bwd_dw(dx3, gates, hs, reset),
                           20)
        lib_ms = cuda_ms(lambda: tg.gru_dw_db_plain(dx3, gates, hs, reset),
                         20)
        tc_ms, tc_by = gru_dw_bound(dx3, gates, hs, reset, mask)
        f32_ms, f32_by = gru_dw_bound(dx3, gates, hs, reset, mask,
                                      tensor_cores=False)
        print(f"  fused_gru_bwd_dw at (B, T, H) = {shape} {kind}, "
              f"{int(mask.sum().item())} valid pairs of {B * T}, S={S} "
              f"splits: the dW kernel "
              f"{kernel_ms:.4f} ms, with its sum {whole_ms:.4f} ms; "
              f"gru_dw_db_plain (two float32 matmuls + sum) {lib_ms:.4f} ms; "
              f"bound {tc_ms:.4f} ms ({tc_by}, TF32 "
              f"{TF32_FLOPS_PER_S / 1e12:.0f} + float32 "
              f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s), {f32_ms:.4f} ms "
              f"({f32_by}) all in float32", flush=True)
        if shape == GRU_DW_REPORT:
            rows["fused_gru_bwd_dw"].update(ms=kernel_ms, library_ms=lib_ms)
        if S == 1:
            continue
        got = tg.gru_dw_reduce(part)
        torch.cuda.synchronize()
        if not torch.equal(got, tg.gru_dw_reduce_plain(part)):
            raise SystemExit(f"gru_dw_reduce differs from its plain version "
                             f"at {shape}, S={S}")
        red = dict(max_abs_err=0.0,
                   ms=cuda_ms(lambda: tg.gru_dw_reduce(part), 20),
                   plain_ms=cuda_ms(lambda: tg.gru_dw_reduce_plain(part), 5),
                   library_ms=cuda_ms(lambda: part.sum(0), 20))
        red["bound_ms"], red["bound_by"] = crf_bound(
            float(part.numel()), [part], [got])
        print(f"  fused_gru_bwd_dw_reduce on [{S}, {part.shape[1]}]: bit-equal "
              f"to its plain version; ms={red['ms']:.4f} plain_ms="
              f"{red['plain_ms']:.4f} bound_ms={red['bound_ms']:.4f} "
              f"({red['bound_by']}) part.sum(0) {red['library_ms']:.4f} ms",
              flush=True)
        if shape == GRU_DW_TAGGER:
            reduce_row = red
    return reduce_row


def where_time_goes(run, label, top=10, host_top=0):
    """One request under torch.profiler: device time by kernel (the
    ``top`` largest items), and the device's busy share of the request's
    wall time (the profiler's own overhead lengthens that wall time); with
    ``host_top``, as many host ops by their own host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    # each device-to-host copy is a host sync: the result's, and in a
    # decode one a tick for the early exit's alive.any()
    syncs = sum(n for _, n, key in rows if "DtoH" in key)
    print(f"where the time goes, {label} under the profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%), {sum(r[1] for r in rows)} device "
          f"items, {syncs} device-to-host copies")
    for ms, n, key in rows[:top]:
        print(f"  {ms:9.3f} ms  x{n:<4d} {key[:80]}")
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    if host_top:
        print(f"  host: {sum(r[0] for r in host):.3f} ms in ops")
    for ms, n, key in host[:host_top]:
        print(f"  {ms:9.3f} ms  x{n:<4d} {key[:80]} (host)")


# --- the LSTM slice --------------------------------------------------------

def lstm_requests(bucket):
    r = np.random.RandomState(SEED)
    batches = []
    for B in REQUEST_BATCHES:
        lens = r.randint(5, 101, size=B)
        lens[0] = 100
        batches.append([(r.randint(0, DICT, size=n).tolist(),)
                        for n in lens])
    shapes = [(len(b), bucket(max(len(s[0]) for s in b), True)) for b in
              batches]
    return batches, shapes


def lstm_slice_phase(pt, kernels, requests):
    """The full-width classifier serving the request batches on the card;
    returns the launch counts of that run."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import lstm_text_classification

    with layer_name_scope():
        out = lstm_text_classification(dict_dim=DICT, emb_dim=EMB,
                                       hidden=HIDDEN, num_layers=LAYERS)[2]
    params = pt.Parameters.from_numpy(random_weights(pt.Topology(out)))
    on_card = pt.Inference(out, params, device="cuda")
    on_cpu = pt.Inference(out, params, device="cpu")
    on_card.infer(requests[1])                 # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = []
    for batch in requests:
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        logits = on_card.infer(batch)          # returns host numpy: synced
        ms = (time.perf_counter() - t0) * 1e3
        rose = kernels.launches["fused_lstm"] - before["fused_lstm"]
        results.append((batch, logits, ms, rose))
    counts = dict(kernels.launches)

    for batch, logits, ms, rose in results:
        ref = on_cpu.infer(batch)
        err = float(np.abs(logits - ref).max())
        print(f"  batch B={len(batch)}: {ms:.3f} ms on the card, "
              f"fused_lstm launches +{rose}, max |logit - cpu| = {err:.3e}")
        if logits.shape != (len(batch), 2) or not np.isfinite(logits).all():
            raise SystemExit(f"bad logits: shape {logits.shape}")
        if not np.allclose(logits, ref, **LOGIT_TOL):
            raise SystemExit(f"card and CPU logits differ by {err}")
        if rose != LAYERS:
            raise SystemExit(f"fused_lstm launched {rose} times for one "
                             f"batch, expected {LAYERS}")
    where_time_goes(lambda: on_card.infer(requests[0]),
                    f"one B={len(requests[0])} classifier request")
    return counts


# --- bundle-backed serving ------------------------------------------------

def classifier(pt, dict_dim):
    """The classifier at the slice's widths over ``dict_dim`` words, its
    weights random from SEED."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import lstm_text_classification

    with layer_name_scope():
        out = lstm_text_classification(dict_dim=dict_dim, emb_dim=EMB,
                                       hidden=HIDDEN, num_layers=LAYERS)[2]
    topo = pt.Topology(out)
    return out, topo, pt.Parameters.from_numpy(random_weights(topo))


def write_bundle_file(path, topo, params, qmeta=None, **export):
    """Write and verify a bundle with the port's meta; its meta, bytes,
    write seconds and the forward export's seconds."""
    from paddle_tpu_torch.io import merged_model as mm

    t0 = time.perf_counter()
    meta = mm.bundle_meta(topo, params, qmeta=qmeta, **export)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        mm.write_bundle(f, topo, params, meta=meta)
    write_s = time.perf_counter() - t0
    mm.verify_bundle(str(path))
    return mm.read_bundle_meta(str(path)), path.stat().st_size, write_s, \
        export_s


def load_machine(path, device="cuda"):
    from paddle_tpu_torch.inference import InferenceMachine

    t0 = time.perf_counter()
    machine = InferenceMachine(str(path), device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return machine, time.perf_counter() - t0


def timed(fn, reps=5):
    """fn's result and its median host ms over reps calls (each returns
    host numpy: synced)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def served(kernels, machine, ids):
    """The machine's output for ``ids`` and the forward launches it
    made."""
    before = kernels.launches["fused_lstm"]
    out = machine.forward({"words": ids})
    return out, kernels.launches["fused_lstm"] - before


def bundle_phase(pt, kernels, workdir):
    """The classifier served from bundles on the card through
    InferenceMachine and through the forward's torch.export artifact;
    returns the fused_lstm launches of those runs."""
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.io import merged_model as mm

    out, topo, params = classifier(pt, DICT)
    r = np.random.RandomState(SEED)
    rows = {B: r.randint(0, DICT, size=(B, BUNDLE_T)).astype(np.int32)
            for B in BUNDLE_BATCHES}
    path = workdir / "classifier.ptpu"
    meta, nbytes, write_s, export_s = write_bundle_file(path, topo, params)
    machine, load_s = load_machine(path)
    print(f"  f32 bundle: {nbytes} bytes, written in {write_s:.3f} s "
          f"(its export tried in {export_s:.3f} s), loaded onto the card "
          f"in {load_s:.3f} s; torch_export_skip_reason: "
          f"{meta.get('torch_export_skip_reason')}", flush=True)
    if "too large" not in meta.get("torch_export_skip_reason", ""):
        raise SystemExit("the full-width bundle's meta lacks the 32 MiB "
                         "cap's skip reason")
    on_cpu, _ = load_machine(path, "cpu")
    live = pt.Inference(out, params, device="cuda")
    launches = 0
    f32_out = {}
    for B, ids in rows.items():
        feed = [(row.tolist(),) for row in ids]
        machine.forward({"words": ids})        # warm-up: this shape
        live.infer(feed)
        before = kernels.launches["fused_lstm"]
        (got, rose), ms = timed(lambda: served(kernels, machine, ids))
        launches += kernels.launches["fused_lstm"] - before
        want, live_ms = timed(lambda: live.infer(feed))
        ref = on_cpu.forward({"words": ids})
        err = float(np.abs(got - ref).max())
        print(f"  B={B}, T={BUNDLE_T}: InferenceMachine {ms:.3f} ms, "
              f"Inference.infer {live_ms:.3f} ms (medians of 5); fused_lstm "
              f"+{rose} a request; max |machine - cpu machine| = {err:.3e}",
              flush=True)
        if got.shape != (B, 2) or not np.isfinite(got).all():
            raise SystemExit(f"bad machine output: shape {got.shape}")
        if not np.array_equal(got, want):
            raise SystemExit("InferenceMachine differs from Inference.infer "
                             f"by {float(np.abs(got - want).max())}")
        if not np.allclose(got, ref, **BUNDLE_TOL):
            raise SystemExit(f"card and CPU machines differ by {err}")
        if rose != LAYERS:
            raise SystemExit(f"fused_lstm launched {rose} times a request, "
                             f"expected {LAYERS}")
        f32_out[B] = got

    # share(): the same device tensors, nothing allocated
    mem0 = torch.cuda.memory_allocated()
    clone = machine.share()
    mem1 = torch.cuda.memory_allocated()
    got, rose = served(kernels, clone, rows[64])
    launches += rose
    torch.cuda.synchronize()
    mem2 = torch.cuda.memory_allocated()
    same = all(clone._params[k].data_ptr() == v.data_ptr()
               for k, v in machine._params.items())
    print(f"  share(): allocated +{mem1 - mem0} bytes, +{mem2 - mem0} after "
          f"the clone's request; same tensors: {same}", flush=True)
    if not (same and mem1 == mem0 and mem2 == mem0
            and np.array_equal(got, f32_out[64])):
        raise SystemExit("share() copied or served another answer")

    # quantized bundles of the same model
    f32_bytes = meta["param_bytes"]["total"]
    for mode in quant.QUANT_MODES:
        qd, qmeta = quant.quantize_params(topo, params.as_dict(), mode)
        qpath = workdir / f"classifier_{mode}.ptpu"
        qm, nbytes, write_s, export_s = write_bundle_file(
            qpath, topo, pt.Parameters.from_dict(qd), qmeta)
        qmachine, load_s = load_machine(qpath)
        qcpu, _ = load_machine(qpath, "cpu")
        pb = qm["param_bytes"]
        print(f"  {mode} bundle: {nbytes} bytes, param_bytes {pb['total']} "
              f"({pb['total'] / f32_bytes:.3f} of f32's {f32_bytes}; "
              f"{pb['by_dtype']}), written in {write_s:.3f} s (export "
              f"{export_s:.3f} s: {'artifact' if 'torch_export' in qm else qm.get('torch_export_skip_reason')}), "
              f"loaded in {load_s:.3f} s", flush=True)
        for B, ids in rows.items():
            got, rose = served(kernels, qmachine, ids)
            launches += rose
            ref = qcpu.forward({"words": ids})
            err = float(np.abs(got - ref).max())
            gap = float(np.abs(got - f32_out[B]).max())
            agree = float((got.argmax(1) == f32_out[B].argmax(1)).mean())
            print(f"    B={B}: max |card - cpu| = {err:.3e}; max |{mode} - "
                  f"f32| = {gap:.3e}, argmax agreement {agree:.3f}",
                  flush=True)
            if not np.allclose(got, ref, **BUNDLE_TOL) or rose != LAYERS:
                raise SystemExit(f"{mode} bundle: card and CPU differ by "
                                 f"{err}, or fused_lstm launched {rose}")

    # the forward's artifact, under the cap at EXPORT_DICT words
    _out, topo2, params2 = classifier(pt, EXPORT_DICT)
    ids = np.random.RandomState(SEED + 1).randint(
        0, EXPORT_DICT, size=(EXPORT_BATCH, EXPORT_T)).astype(np.int32)
    mask = np.ones(ids.shape, np.float32)
    for mode in ("f32", "int8"):
        qmeta, P = None, params2
        if mode == "int8":
            qd, qmeta = quant.quantize_params(topo2, params2.as_dict(), mode)
            P = pt.Parameters.from_dict(qd)
        epath = workdir / f"classifier_{EXPORT_DICT}_{mode}.ptpu"
        em, nbytes, _w, export_s = write_bundle_file(
            epath, topo2, P, qmeta, seq_len=EXPORT_T,
            static_batch=EXPORT_BATCH)
        if "torch_export" not in em:
            raise SystemExit(f"no artifact at {EXPORT_DICT} words: "
                             f"{em.get('torch_export_skip_reason')}")
        sig = em["torch_export"]["signature"]
        emachine, _ = load_machine(epath)
        ecpu, _ = load_machine(epath, "cpu")
        t0 = time.perf_counter()
        fx = mm.load_forward_export(em)
        load_s = time.perf_counter() - t0
        cases = [EXPORT_BATCH] + ([3] if sig["symbolic_batch"] else [])
        for B in cases:
            before = kernels.launches["fused_lstm"]
            y = fx(ids[:B], mask[:B]).cpu().numpy()
            rose = kernels.launches["fused_lstm"] - before
            _y, fx_ms = timed(lambda: fx(ids[:B], mask[:B]).cpu().numpy())
            launches += kernels.launches["fused_lstm"] - before
            want, m_ms = timed(lambda: emachine.forward({"words": ids[:B]}))
            ref = ecpu.forward({"words": ids[:B]})
            err = float(np.abs(y - want).max())
            cpu_err = float(np.abs(y - ref).max())
            print(f"  {mode} artifact at {EXPORT_DICT}/{EMB}/{HIDDEN} x"
                  f"{LAYERS}, B={B}, T={EXPORT_T}: exported in {export_s:.3f} "
                  f"s (symbolic batch: {sig['symbolic_batch']}), bundle "
                  f"{nbytes} bytes, loaded in {load_s:.3f} s; {fx_ms:.3f} ms "
                  f"a run against the machine's {m_ms:.3f}; fused_lstm "
                  f"+{rose}; max |artifact - machine| = {err:.3e}, max "
                  f"|artifact - cpu machine| = {cpu_err:.3e}", flush=True)
            if not np.allclose(y, want, **EXPORT_TOL) or rose != LAYERS:
                raise SystemExit(f"the {mode} artifact differs from the "
                                 f"machine by {err}, or launched {rose}")
            if not np.allclose(y, ref, **BUNDLE_TOL):
                raise SystemExit(f"the {mode} artifact differs from the "
                                 f"CPU machine by {cpu_err}")
    return launches


# --- the training slice ----------------------------------------------------

def train_batches():
    """TRAIN_STEPS batches of TRAIN_B (ids, label) rows: lengths 5..100,
    one of 100 per batch (T buckets to 128), random labels."""
    r = np.random.RandomState(SEED + 3)
    out = []
    for _ in range(TRAIN_STEPS):
        lens = r.randint(5, 101, size=TRAIN_B)
        lens[0] = 100
        out.append([(r.randint(0, DICT, size=n).tolist(),
                     int(r.randint(0, 2))) for n in lens])
    return out


def train_run(pt, kernels, cost, weights, optimizer, batches, device,
              evaluators=None, metrics=None, **train_kw):
    """``SGD(...).train`` over ``batches`` (one pass) from ``weights``,
    with ``evaluators`` and ``train_kw`` (feeding, bucket_rounding);
    returns the trainer and per step (cost, host ms, launches it made).
    Each step's evaluator metrics are appended to the list ``metrics``,
    where one is given."""
    trainer = pt.SGD(cost, pt.Parameters.from_numpy(weights), optimizer,
                     evaluators=evaluators, device=device)
    steps = []

    def handler(ev):
        if isinstance(ev, pt.event.BeginIteration):
            steps.append((time.perf_counter(), dict(kernels.launches)))
        elif isinstance(ev, pt.event.EndIteration):
            t0, before = steps[-1]
            steps[-1] = (ev.cost, (time.perf_counter() - t0) * 1e3,
                         {k: kernels.launches[k] - before[k] for k in before})
            if metrics is not None:
                metrics.append(dict(ev.metrics))

    trainer.train(lambda: iter(batches), num_passes=1, event_handler=handler,
                  **train_kw)
    return trainer, steps


# the LSTM kernels a training step launches
LSTM_TRAIN_KERNELS = ("fused_lstm", "fused_lstm_bwd", "fused_lstm_bwd_nodw",
                      "fused_lstm_bwd_dw", "fused_lstm_bwd_dw_reduce")


def lstm_train_launches(split):
    """Each LSTM kernel's launches in a classifier training step (LAYERS
    LSTMs of (TRAIN_B, 128, HIDDEN)): the forward and the recurrence once
    a layer; with the default backward the recurrence under fused_lstm_bwd,
    the dW kernel and (where its pairs are split) its sum once a layer;
    with the split form forced the recurrence under fused_lstm_bwd_nodw
    and neither."""
    from paddle_tpu_torch.kernels.lstm import lstm_dw_splits

    summed = int(lstm_dw_splits(TRAIN_B * 128, HIDDEN) > 1)
    return dict(zip(LSTM_TRAIN_KERNELS,
                    (LAYERS, LAYERS * (not split), LAYERS * split,
                     LAYERS * (not split), LAYERS * (not split) * summed)))


def training_phase(pt, kernels, batches):
    """The full-width classifier trained on the card: Adam over every
    batch with the backward the shape chooses, then Momentum over the
    first TRAIN_CHECKED with the split backward forced; each against the
    port's CPU run of the same batches. Returns each run's launch counts
    and the backward kernel it must have used."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.kernels import lstm as lstm_kernels
    from paddle_tpu_torch.models.text import lstm_text_classification

    with layer_name_scope():
        cost = lstm_text_classification(dict_dim=DICT, emb_dim=EMB,
                                         hidden=HIDDEN, num_layers=LAYERS)[3]
    topo = pt.Topology(cost)
    weights = random_weights(topo)
    runs = [("adam", lambda: pt.optimizer.Adam(learning_rate=1e-3),
             batches, False),
            ("momentum", lambda: pt.optimizer.Momentum(
                momentum=0.9, learning_rate=0.01), batches[:TRAIN_CHECKED],
             True)]
    counts = []
    for name, make_opt, run_batches, split in runs:
        t0 = time.perf_counter()
        cpu, cpu_steps = train_run(pt, kernels, cost, weights, make_opt(),
                                   run_batches[:TRAIN_CHECKED], "cpu")
        cpu_s = time.perf_counter() - t0
        lstm_kernels._FORCE_SPLIT_BWD = split
        try:
            kernels.reset_launch_counts()
            card, steps = train_run(pt, kernels, cost, weights, make_opt(),
                                    run_batches, "cuda")
            counts.append(dict(kernels.launches))
        finally:
            lstm_kernels._FORCE_SPLIT_BWD = False
        want = lstm_train_launches(split)
        print(f"  {name}, {len(run_batches)} batches of {TRAIN_B} (T=128), "
              f"{'the split backward' if split else 'the default backward'}"
              f"; the CPU run of the first {TRAIN_CHECKED} took "
              f"{cpu_s:.1f} s", flush=True)
        rtol = TRAIN_COST_RTOL[name]
        for i, (c, ms, rose) in enumerate(steps):
            ref = cpu_steps[i][0] if i < TRAIN_CHECKED else None
            rel = abs(c - ref) / abs(ref) if ref is not None else None
            print(f"    step {i}: cost {c:.7f}"
                  + (f" (cpu {ref:.7f}, rel diff {rel:.3e})"
                     if ref is not None else "")
                  + f", {ms:.3f} ms, launches {rose}", flush=True)
            if not np.isfinite(c):
                raise SystemExit(f"{name}: non-finite cost at step {i}")
            if ref is not None and not rel <= rtol:
                raise SystemExit(f"{name}: step {i} cost {c} vs CPU {ref} "
                                 f"(rel {rel:.3e} > {rtol})")
            if {k: rose[k] for k in want} != want:
                raise SystemExit(f"{name}: step {i} launched {rose}, "
                                 f"expected {want}")
        if name == "momentum":
            err = max(float((card.parameters.get(k)
                             - cpu.parameters.get(k)).abs().max())
                      for k in cpu.parameters.names())
            print(f"    parameters after {TRAIN_CHECKED} steps: max |card - "
                  f"cpu| = {err:.3e}", flush=True)
            if not err <= TRAIN_PARAM_ATOL:
                raise SystemExit(f"momentum parameters differ by {err}")
        else:
            last = [ms for _, ms, _ in steps[-4:]]
            print(f"  ms per training step (median of the last 4): "
                  f"{float(np.median(last)):.3f}; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
                  flush=True)
    # one step under the profiler: the train loop's step function (its
    # pass-end copy of the parameters to the host is not a step's work)
    from paddle_tpu_torch.trainer import make_train_step
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    optimizer = pt.optimizer.Adam(learning_rate=1e-3)
    step = make_train_step(topo.loss_fn(cost), optimizer, topo.static_map(),
                           topo.lr_mults())
    params = {k: torch.from_numpy(v).cuda() for k, v in weights.items()}
    state = optimizer.init(params)
    feeds = {k: a.to("cuda") for k, a in
             DataFeeder(topo.data_type())(batches[-1]).items()}

    def one_step():
        float(step(params, state, feeds)[2])

    one_step()
    where_time_goes(one_step, f"one B={TRAIN_B} Adam training step")
    return counts


# --- the nested slice ------------------------------------------------------

def nested_paragraphs(r, B):
    """B paragraphs of sentences of word ids from ``r``; the first is
    NESTED_SENTENCES sentences of NESTED_WORDS words."""
    rows = []
    for b in range(B):
        n = NESTED_SENTENCES if b == 0 else r.randint(1, NESTED_SENTENCES + 1)
        rows.append([r.randint(0, DICT, size=NESTED_WORDS if b == 0 else
                               r.randint(1, NESTED_WORDS + 1)).tolist()
                     for _ in range(n)])
    return rows


def nested_requests():
    """A request batch of each size of REQUEST_BATCHES, batch k drawn from
    RandomState(SEED + k)."""
    return [[(p,) for p in nested_paragraphs(np.random.RandomState(SEED + k),
                                             B)]
            for k, B in enumerate(REQUEST_BATCHES)]


def nested_train_batches():
    r = np.random.RandomState(SEED + len(REQUEST_BATCHES))
    return [[(p, int(r.randint(0, 2))) for p in nested_paragraphs(r, TRAIN_B)]
            for _ in range(NESTED_TRAIN_STEPS)]


def nested_classifier(pt, nested=True):
    """The hierarchical classifier, built with the DSL in a fresh name
    scope: an integer_value_sub_sequence(DICT) feed -> embedding(EMB) ->
    simple_lstm(HIDDEN) over the words -> max pooling to_sequence (one
    step a sentence) -> simple_lstm(HIDDEN) over the sentences -> max ->
    fc(2, softmax); returns (the word-level lstm, the pooled sentences,
    the output, the cost). ``nested=False`` builds only the word-level
    lstm over a plain integer_value_sequence, with the same names."""
    from paddle_tpu_torch.core.layer import layer_name_scope

    with layer_name_scope():
        kind = (pt.data_type.integer_value_sub_sequence if nested
                else pt.data_type.integer_value_sequence)
        para = pt.layer.data(name="para", type=kind(DICT))
        emb = pt.layer.embedding(input=para, size=EMB)
        words = pt.networks.simple_lstm(input=emb, size=HIDDEN)
        if not nested:
            return words
        label = pt.layer.data(name="label",
                              type=pt.data_type.integer_value(2))
        sents = pt.layer.pooling(
            input=words, pooling_type=pt.pooling.Max(),
            agg_level=pt.layer.AggregateLevel.TO_SEQUENCE)
        text = pt.networks.simple_lstm(input=sents, size=HIDDEN)
        top = pt.layer.pooling(input=text, pooling_type=pt.pooling.Max())
        out = pt.layer.fc(input=top, size=2, act=pt.activation.Softmax())
        cost = pt.layer.classification_cost(input=out, label=label)
    return words, sents, out, cost


def on_card(weights, names):
    return {k: torch.from_numpy(weights[k]).cuda() for k in names}


def nested_structure_check(pt, words, sents, weights, batch):
    """Topology.forward on the card: the pooled sentences' mask sums to
    each row's sentence count, exactly, and the word-level lstm equals,
    bit for bit, the same layer fed the same rows as a plain sequence."""
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    topo = pt.Topology([words, sents])
    feeds = {k: a.to("cuda") for k, a in
             DataFeeder(topo.data_type())(batch).items()}
    if feeds["para"].seg_ids.dtype != torch.int32:
        raise SystemExit(f"seg_ids reach the card as "
                         f"{feeds['para'].seg_ids.dtype}")
    flat_words = nested_classifier(pt, nested=False)
    flat = pt.Topology(flat_words)
    flat_feeds = {k: a.to("cuda") for k, a in DataFeeder(flat.data_type())(
        [([w for s in p for w in s],) for p, in batch]).items()}
    params = on_card(weights, topo.param_specs())
    with torch.inference_mode():
        outs = topo.forward(params, feeds)
        flat_out = flat.forward(params, flat_feeds)[flat_words.name]
    got = outs[sents.name].mask.sum(1).cpu().numpy()
    want = np.array([len(p) for p, in batch], np.float32)
    print(f"  B={len(batch)}: pooled sentences "
          f"{tuple(outs[sents.name].value.shape)}, mask sums equal to the "
          f"sentence counts: {bool((got == want).all())}", flush=True)
    if not (got == want).all():
        raise SystemExit(f"sentence mask sums {got} against counts {want}")
    nested_out = outs[words.name]
    same = torch.equal(nested_out.value, flat_out.value) \
        and torch.equal(nested_out.mask, flat_out.mask)
    print(f"  word-level lstmemory nested and flat bit-equal on the card: "
          f"{same}", flush=True)
    if not same:
        err = float((nested_out.value - flat_out.value).abs().max())
        raise SystemExit(f"the word-level lstm differs nested and flat by "
                         f"{err}")


def nested_group_check(pt, kernels):
    """A SubsequenceInput group at the slice's width: the nested embedding
    -> fc(3 x HIDDEN) -> a group whose step is gru_step(HIDDEN) with one
    memory, at B = NESTED_GROUP_B, T = 128; the card against the CPU, and
    against gated_recurrent (the grid fused_gru, once) run over every
    sub-sequence laid out as a row of its own."""
    from paddle_tpu_torch.core.arg import Arg
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    with layer_name_scope():
        para = pt.layer.data(
            name="para", type=pt.data_type.integer_value_sub_sequence(DICT))
        emb = pt.layer.embedding(input=para, size=EMB)
        proj = pt.layer.fc(input=emb, size=3 * HIDDEN,
                           act=pt.activation.Linear())

        def step(x_t):
            m = pt.layer.memory(name="nested_gru", size=HIDDEN)
            return pt.layer.gru_step(input=x_t, output_mem=m, size=HIDDEN,
                                     name="nested_gru")
        group = pt.layer.recurrent_group(
            step=step, input=pt.layer.SubsequenceInput(proj),
            name="nested_group")
        subs = pt.layer.data(
            name="subs", type=pt.data_type.dense_vector_sequence(3 * HIDDEN))
        mono = pt.layer.grumemory(input=subs, name="nested_mono")
    topo = pt.Topology(group)
    weights = random_weights(topo)
    batch = [(p,) for p in nested_paragraphs(
        np.random.RandomState(SEED + len(REQUEST_BATCHES) + 1),
        NESTED_GROUP_B)]
    feeds = DataFeeder(topo.data_type())(batch)
    with torch.inference_mode():
        t0 = time.perf_counter()
        card = topo.forward(on_card(weights, weights),
                            {k: a.to("cuda") for k, a in feeds.items()})
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        cpu = topo.forward({k: torch.from_numpy(v)
                            for k, v in weights.items()},
                           {k: a.to("cpu") for k, a in feeds.items()})
    got, ref = card[group.name], cpu[group.name]
    err = float((got.value.cpu() - ref.value).abs().max())
    T = got.value.shape[1]
    print(f"  SubsequenceInput group (gru_step {HIDDEN}), B={len(batch)}, "
          f"T={T}: {card_ms:.3f} ms on the card, max |card - cpu| = "
          f"{err:.3e}", flush=True)
    if not torch.allclose(got.value.cpu(), ref.value, **LOGIT_TOL):
        raise SystemExit(f"the nested group differs card and CPU by {err}")
    if not torch.equal(got.seg_ids.cpu(), torch.from_numpy(feeds["para"]
                                                           .seg_ids)):
        raise SystemExit("the nested group lost its input's seg_ids")
    # every sub-sequence a row of its own, through gated_recurrent
    seg = feeds["para"].seg_ids
    spans = [np.flatnonzero(seg[b] == s) for b in range(seg.shape[0])
             for s in range(seg[b].max() + 1)]
    L = max(len(t) for t in spans)
    rows = torch.tensor([[b] * L for b in range(seg.shape[0])
                         for s in range(seg[b].max() + 1)]).cuda()
    steps = torch.tensor(np.array([np.pad(t, (0, L - len(t)))
                                   for t in spans])).cuda()
    m = torch.tensor([[1.0] * len(t) + [0.0] * (L - len(t))
                      for t in spans]).cuda()
    mono_params = {f"_nested_mono.{k}": torch.from_numpy(
        weights[f"_nested_gru.{k}"]).cuda() for k in ("w0", "w1", "wbias")}
    before = kernels.launches["fused_gru"]
    with torch.inference_mode():
        x = card[proj.name].value[rows, steps] * m[..., None]
        runs = pt.Topology(mono).forward(mono_params,
                                         {"subs": Arg(x.contiguous(), m)})
        want = got.value[rows, steps] * m[..., None]
        err = float((runs["nested_mono"].value - want).abs().max())
    rose = kernels.launches["fused_gru"] - before
    print(f"  gated_recurrent over the {len(spans)} sub-sequences as rows "
          f"(up to {L} steps): fused_gru launches +{rose}, max |group - "
          f"rows| = {err:.3e}", flush=True)
    if rose != 1:
        raise SystemExit(f"gated_recurrent launched fused_gru {rose} times")
    if not err <= KERNEL_ATOL:
        raise SystemExit(f"the nested group and the per-sub-sequence runs "
                         f"differ by {err}")


def nested_phase(pt, kernels, requests, flat_requests):
    """The hierarchical classifier served and trained on the card, each
    against the port's CPU run; the structure check, the SubsequenceInput
    group, and the latency against the flat classifier. Returns the
    launch counts of the serving run and of the training run."""
    from paddle_tpu_torch.models.text import lstm_text_classification
    from paddle_tpu_torch.core.layer import layer_name_scope

    words, sents, out, cost = nested_classifier(pt)
    weights = random_weights(pt.Topology(cost))
    params = pt.Parameters.from_numpy(weights)
    card = pt.Inference(out, params, device="cuda")
    cpu = pt.Inference(out, params, device="cpu")
    card.infer(requests[1])                    # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = []
    for batch in requests:
        before = kernels.launches["fused_lstm"]
        t0 = time.perf_counter()
        logits = card.infer(batch)             # returns host numpy: synced
        ms = (time.perf_counter() - t0) * 1e3
        results.append((batch, logits, ms,
                        kernels.launches["fused_lstm"] - before))
    serving = dict(kernels.launches)
    for batch, logits, ms, rose in results:
        ref = cpu.infer(batch)
        err = float(np.abs(logits - ref).max())
        print(f"  batch B={len(batch)} ({sum(len(p) for p, in batch)} "
              f"sentences): {ms:.3f} ms on the card, fused_lstm launches "
              f"+{rose}, max |logit - cpu| = {err:.3e}", flush=True)
        if logits.shape != (len(batch), 2) or not np.isfinite(logits).all():
            raise SystemExit(f"bad nested logits: shape {logits.shape}")
        if not np.allclose(logits, ref, **LOGIT_TOL):
            raise SystemExit(f"nested card and CPU logits differ by {err}")
        if rose != 2:
            raise SystemExit(f"fused_lstm launched {rose} times for one "
                             "nested request, expected 2")
    nested_structure_check(pt, words, sents, weights, requests[0])

    # training: Adam on the card against the CPU
    batches = nested_train_batches()
    opt = lambda: pt.optimizer.Adam(learning_rate=1e-3)   # noqa: E731
    t0 = time.perf_counter()
    _, cpu_steps = train_run(pt, kernels, cost, weights, opt(), batches,
                             "cpu", feeding=NESTED_FEEDING)
    cpu_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    _, steps = train_run(pt, kernels, cost, weights, opt(), batches, "cuda",
                         feeding=NESTED_FEEDING)
    training = dict(kernels.launches)
    want = lstm_train_launches(False)
    print(f"  adam, {len(batches)} nested batches of {TRAIN_B} (T=128); the "
          f"CPU run took {cpu_s:.1f} s", flush=True)
    rtol = TRAIN_COST_RTOL["adam"]
    for i, ((c, ms, rose), (ref, _, _)) in enumerate(zip(steps, cpu_steps)):
        rel = abs(c - ref) / abs(ref)
        print(f"    step {i}: cost {c:.7f} (cpu {ref:.7f}, rel diff "
              f"{rel:.3e}), {ms:.3f} ms, launches "
              f"{ {k: rose[k] for k in LSTM_TRAIN_KERNELS} }", flush=True)
        if not np.isfinite(c) or not rel <= rtol:
            raise SystemExit(f"nested adam: step {i} cost {c} vs CPU {ref}")
        if {k: rose[k] for k in want} != want:
            raise SystemExit(f"nested adam: step {i} launched {rose}, "
                             f"expected {want}")

    nested_group_check(pt, kernels)

    # latency: nested and flat requests in turns
    with layer_name_scope():
        flat_out = lstm_text_classification(dict_dim=DICT, emb_dim=EMB,
                                            hidden=HIDDEN,
                                            num_layers=LAYERS)[2]
    flat = pt.Inference(flat_out, pt.Parameters.from_numpy(
        random_weights(pt.Topology(flat_out))), device="cuda")
    for i in (0, 1):
        card.infer(requests[i])
        flat.infer(flat_requests[i])
    print(f"  request latency on the card ({card_line()}), nested and flat "
          f"in turns, {LATENCY_ROUNDS} rounds: median [min, max] ms",
          flush=True)
    for i in (0, 1):
        times = {"nested": [], "flat": []}
        for _ in range(LATENCY_ROUNDS):
            for name, inf, batch in (("nested", card, requests[i]),
                                     ("flat", flat, flat_requests[i])):
                t0 = time.perf_counter()
                inf.infer(batch)
                times[name].append((time.perf_counter() - t0) * 1e3)
        print(f"    B={len(requests[i])}: " + "; ".join(
            f"{name} {np.median(t):.3f} [{min(t):.3f}, {max(t):.3f}]"
            for name, t in times.items()), flush=True)
    where_time_goes(lambda: card.infer(requests[0]),
                    f"one B={len(requests[0])} nested request")
    return serving, training


# --- the NMT slice ---------------------------------------------------------

def nmt_requests(bucket):
    r = np.random.RandomState(SEED + 1)
    batches = []
    for B in NMT_BATCHES:
        lens = r.randint(5, 31, size=B)
        batches.append([(r.randint(2, NMT["src_dict_dim"], size=n).tolist(),)
                        for n in lens])
    shapes = [(len(b), bucket(max(len(s[0]) for s in b), True)) for b in
              batches]
    return batches, shapes


class TopKGaps:
    """Records, while installed, the smallest gap between the k-th and
    the (k+1)-th candidate score of every beam tick: a card/CPU id
    mismatch can only come from a gap smaller than their score error."""

    def __init__(self, rg):
        self.rg, self.real, self.ticks = rg, rg._top_k, []

    def __enter__(self):
        def top_k(x, k):
            if x.shape[-1] > k:        # a tick's top-k, not the completion
                v = torch.sort(x, dim=-1, descending=True, stable=True)[0]
                live = v[:, k] > -1e29
                gap = (v[:, k - 1] - v[:, k])[live]
                self.ticks.append(float(gap.min()) if gap.numel() else
                                  float("inf"))
            return self.real(x, k)
        self.rg._top_k = top_k
        return self

    def __exit__(self, *a):
        self.rg._top_k = self.real

    def smallest(self):
        t = int(np.argmin(self.ticks))
        return self.ticks[t], t


def nmt_decode_params(pt, topo, eos_bias=EOS_BIAS):
    """The decode's random weights (every NMT mode and the scoring form
    share their names): the output projection OUT_SCALE times wider, eos's
    bias up by ``eos_bias``."""
    def nudge_eos(b):
        b[EOS] += eos_bias
        return b

    return pt.Parameters.from_numpy(random_weights(
        topo, {"_m_out.w0": lambda w: w * OUT_SCALE,
               "_m_out.wbias": nudge_eos}))


def decode_extras(inf, batch, feeding=None):
    """One decode of ``batch`` through ``inf``'s topology and parameters
    on its device: the best beam's ids (what ``infer`` returns), then
    ctx.extras' ids [B, beam, L], scores [B, beam] and ticks."""
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    topo = inf.topology
    feeds = {k: a.to(inf.device) for k, a in
             DataFeeder(topo.data_type(), feeding)(batch).items()}
    with torch.inference_mode():
        outs, ctx = topo.forward(inf._params, feeds, return_ctx=True)
    best = outs[inf.out_names[0]].value
    return (best.reshape(best.shape[0], -1).cpu().numpy(),
            ctx.extras["m_gen:ids"].cpu().numpy(),
            ctx.extras["m_gen:scores"].cpu().numpy(),
            ctx.extras["m_gen:ticks"])


def nmt_phase(pt, kernels, requests):
    """Dense beam-search decode at full width serving the request batches
    on the card, then the scoring form on one batch; returns the launch
    counts of the decode run."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.layers import recurrent_group as rg
    from paddle_tpu_torch.models.text import (nmt_attention_cost,
                                              nmt_decode_topology)

    gen = nmt_decode_topology(beam_size=BEAM, max_length=MAX_LEN,
                              mode="dense", **NMT)
    topo = pt.Topology(gen)
    params = nmt_decode_params(pt, topo)
    on_card = pt.Inference(gen, params, device="cuda")
    on_cpu = pt.Inference(gen, params, device="cpu")
    for batch in requests:      # warm-up of every request shape (cuBLAS
        on_card.infer(batch)    # plans, sort workspace, allocator)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = []
    for batch in requests:
        before = kernels.launches["fused_gru"]
        t0 = time.perf_counter()
        ids = on_card.infer(batch)             # returns host numpy: synced
        ms = (time.perf_counter() - t0) * 1e3
        results.append((batch, ids, ms, kernels.launches["fused_gru"]
                        - before))
    counts = dict(kernels.launches)

    for batch, ids, ms, rose in results:
        with TopKGaps(rg) as gaps:
            ref = on_cpu.infer(batch)
        gap, gap_tick = gaps.smallest()
        c_ids, c_scores, c_ticks = decode_extras(on_card, batch)[1:]
        r_ids, r_scores, r_ticks = decode_extras(on_cpu, batch)[1:]
        s_err = float(np.abs(c_scores - r_scores).max())
        print(f"  batch B={len(batch)}: {ms:.3f} ms on the card, "
              f"{c_ticks} ticks, fused_gru launches +{rose}, max |score - "
              f"cpu| = {s_err:.3e}, smallest top-k gap {gap:.3e} at tick "
              f"{gap_tick}", flush=True)
        if ids.shape != (len(batch), MAX_LEN) or ids.min() < 0 or \
                ids.max() >= NMT["trg_dict_dim"]:
            raise SystemExit(f"bad decode ids: shape {ids.shape}")
        if not (np.array_equal(ids, ref) and np.array_equal(c_ids, r_ids)
                and c_ticks == r_ticks):
            bad = np.argwhere(c_ids != r_ids)
            raise SystemExit(
                f"card and CPU decode differ (first at [row, beam, tick] "
                f"{bad[0].tolist() if len(bad) else None}, ticks {c_ticks} "
                f"vs {r_ticks}); smallest top-k gap {gap:.3e} at tick "
                f"{gap_tick}")
        if not np.isfinite(c_scores).all() or \
                not np.allclose(c_scores, r_scores, **LOGIT_TOL):
            raise SystemExit(f"card and CPU scores differ by {s_err}")
        if rose != 2:
            raise SystemExit(f"fused_gru launched {rose} times for one "
                             "request, expected 2 (the encoder's two "
                             "directions)")
    where_time_goes(lambda: on_card.infer(requests[0]),
                    f"one B={len(requests[0])} decode request")

    # the teacher-forced scoring form, same weights (same names), one batch
    with layer_name_scope():
        probs = nmt_attention_cost(**NMT).inputs[0]
    r = np.random.RandomState(SEED + 2)
    batch = [(src, r.randint(2, NMT["trg_dict_dim"],
                             size=len(src) // 2 + 1).tolist())
             for (src,) in requests[0]]
    feeding = {"src": 0, "trg": 1}
    score_card = pt.Inference(probs, params, device="cuda")
    before = kernels.launches["fused_gru"]
    t0 = time.perf_counter()
    got = score_card.infer(batch, feeding)
    ms = (time.perf_counter() - t0) * 1e3
    rose = kernels.launches["fused_gru"] - before
    want = pt.Inference(probs, params, device="cpu").infer(batch, feeding)
    err = float(np.abs(got - want).max())
    print(f"  scoring form B={len(batch)}: {ms:.3f} ms on the card, "
          f"fused_gru launches +{rose}, max |prob - cpu| = {err:.3e}")
    if not np.isfinite(got).all() or not np.allclose(got, want, **LOGIT_TOL):
        raise SystemExit(f"card and CPU probabilities differ by {err}")
    if rose != 2:
        raise SystemExit(f"scoring form launched fused_gru {rose} times")
    return counts


# --- the selective and compact NMT decode ---------------------------------

def nmt_candidates(r, B, K=CAND_K, V=None):
    """[B, K] candidate ids as bench.py:466-472 builds them: unique in a
    row, eos present."""
    V = V or NMT["trg_dict_dim"]
    cand = np.stack([r.choice(V, K, replace=False) for _ in range(B)])
    no_eos = ~(cand == EOS).any(axis=1)
    cand[no_eos, 0] = EOS
    return cand


def transposed_gather(requests):
    """The compact projection's row gather at B = 16 (N = B * BEAM rows,
    CAND_K candidates, H = 512, V = 30000): rows of the fc-layout table's
    transpose W.T read through the strided view every tick, against
    W.T.contiguous() once a decode and contiguous row gathers (what
    misc.transposed_tables makes the beam search do)."""
    H, V = NMT["decoder_size"], NMT["trg_dict_dim"]
    B = len(requests[0])
    g = torch.Generator(device="cuda").manual_seed(SEED)
    w = torch.randn(H, V, device="cuda", generator=g)
    x = torch.randn(B * BEAM, H, device="cuda", generator=g)
    cand = nmt_candidates(np.random.RandomState(SEED), B)
    idx = torch.from_numpy(np.repeat(cand, BEAM, axis=0)).long().cuda()
    tick = lambda wt: torch.bmm(wt[idx], x[:, :, None])
    wt = w.t().contiguous()
    if not torch.equal(tick(w.t()), tick(wt)):
        raise SystemExit("the strided and contiguous gathers differ")
    strided, contiguous = cuda_ms(lambda: tick(w.t()), 20), \
        cuda_ms(lambda: tick(wt), 20)
    copy = cuda_ms(lambda: w.t().contiguous(), 20)
    print(f"  the compact projection's gather at N={B * BEAM}, K={CAND_K}, "
          f"H={H}, V={V}: strided {strided:.4f} ms a tick, contiguous "
          f"{contiguous:.4f} ms a tick, the W.T copy {copy:.4f} ms; over "
          f"{MAX_LEN} ticks {MAX_LEN * strided:.4f} against "
          f"{copy + MAX_LEN * contiguous:.4f} ms ({card_line()})",
          flush=True)


def nmt_select_phase(pt, kernels, requests):
    """The selective and compact decodes (cand_k = CAND_K) at full width
    serving the request batches on the card, held against the CPU; then a
    full-coverage compact decode against the dense one on the card, the
    scoring form with a selection, and the three modes' latencies.
    Returns the launch counts of the selective and compact serving."""
    from paddle_tpu_torch import layer, networks
    from paddle_tpu_torch.attr import ParamAttr
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.layers import recurrent_group as rg
    from paddle_tpu_torch.models.text import nmt_decode_topology

    def topology(mode, cand_k=CAND_K, early_exit=True):
        return nmt_decode_topology(beam_size=BEAM, max_length=MAX_LEN,
                                   cand_k=cand_k, mode=mode,
                                   early_exit=early_exit, **NMT)

    gens = {mode: topology(mode) for mode in MODES}
    params = nmt_decode_params(pt, pt.Topology(gens["dense"]))
    on_card = {m: pt.Inference(g, params, device="cuda")
               for m, g in gens.items()}
    r = np.random.RandomState(SEED + 3)
    cands = [nmt_candidates(r, len(batch)) for batch in requests]
    rows = {"dense": requests}
    rows["selective"] = rows["compact"] = [
        [(src, c.tolist()) for (src,), c in zip(batch, cand)]
        for batch, cand in zip(requests, cands)]
    feeding = {"dense": None, "selective": SELECT_FEEDING,
               "compact": SELECT_FEEDING}
    for mode in MODES:          # warm-up of every mode and request shape
        for batch in rows[mode]:
            on_card[mode].infer(batch, feeding[mode])
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    served = {}
    for mode in SELECT_MODES:
        for i, batch in enumerate(rows[mode]):
            before = kernels.launches["fused_gru"]
            t0 = time.perf_counter()
            ids = on_card[mode].infer(batch, SELECT_FEEDING)
            ms = (time.perf_counter() - t0) * 1e3
            served[mode, i] = (ids, ms,
                               kernels.launches["fused_gru"] - before)
    counts = dict(kernels.launches)

    for mode in SELECT_MODES:
        on_cpu = pt.Inference(gens[mode], params, device="cpu")
        for i, batch in enumerate(rows[mode]):
            ids, ms, rose = served[mode, i]
            c_best, c_ids, c_scores, c_ticks = decode_extras(
                on_card[mode], batch, SELECT_FEEDING)
            with TopKGaps(rg) as gaps:
                r_best, r_ids, r_scores, r_ticks = decode_extras(
                    on_cpu, batch, SELECT_FEEDING)
            gap, gap_tick = gaps.smallest()
            s_err = float(np.abs(c_scores - r_scores).max())
            print(f"  {mode} B={len(batch)}: {ms:.3f} ms on the card, "
                  f"{c_ticks} ticks, fused_gru launches +{rose}, max |score "
                  f"- cpu| = {s_err:.3e}, smallest top-k gap {gap:.3e} at "
                  f"tick {gap_tick}", flush=True)
            if ids.shape != (len(batch), MAX_LEN):
                raise SystemExit(f"bad {mode} ids: shape {ids.shape}")
            if not (np.array_equal(ids, r_best) and
                    np.array_equal(c_best, r_best) and
                    np.array_equal(c_ids, r_ids) and c_ticks == r_ticks):
                bad = np.argwhere(c_ids != r_ids)
                raise SystemExit(
                    f"{mode}: card and CPU decode differ (first at [row, "
                    f"beam, tick] {bad[0].tolist() if len(bad) else None}, "
                    f"ticks {c_ticks} vs {r_ticks}); smallest top-k gap "
                    f"{gap:.3e} at tick {gap_tick}")
            if not np.isfinite(c_scores).all() or \
                    not np.allclose(c_scores, r_scores, **LOGIT_TOL):
                raise SystemExit(f"{mode}: card and CPU scores differ by "
                                 f"{s_err}")
            for row, cand in zip(c_ids, cands[i]):
                if not np.isin(row, cand).all():
                    raise SystemExit(f"{mode}: an emitted id lies outside "
                                     "its row's candidates")
            if rose != 2:
                raise SystemExit(f"{mode}: fused_gru launched {rose} times "
                                 "for one request, expected 2")
    for i in range(len(requests)):
        if not np.array_equal(served["selective", i][0],
                              served["compact", i][0]):
            raise SystemExit(f"selective and compact ids differ on the "
                             f"card (request {i})")
    print("  card ids equal the CPU's in both modes, inside each row's "
          "candidates; selective equals compact", flush=True)

    # full coverage: the whole vocab as one B=1 request's candidates
    V = NMT["trg_dict_dim"]
    full = pt.Inference(topology("compact", cand_k=V), params, device="cuda")
    batch = requests[1]
    got = full.infer([(src, list(range(V))) for (src,) in batch],
                     SELECT_FEEDING)
    with TopKGaps(rg) as gaps:
        want = on_card["dense"].infer(batch)
    gap, gap_tick = gaps.smallest()
    print(f"  full-coverage compact B={len(batch)} (K={V}) against dense on "
          f"the card: ids equal {np.array_equal(got, want)}, smallest "
          f"top-k gap {gap:.3e} at tick {gap_tick}", flush=True)
    if not np.array_equal(got, want):
        raise SystemExit("full-coverage compact and dense ids differ")

    # the scoring form with a selection of SCORING_K candidates a row
    with layer_name_scope():
        src = layer.data(name="src", type=pt.data_type.integer_value_sequence(
            NMT["src_dict_dim"]))
        trg = layer.data(name="trg", type=pt.data_type.integer_value_sequence(
            V))
        sel = layer.data(name="cand",
                         type=pt.data_type.dense_vector(SCORING_K))
        emb = layer.embedding(input=trg, size=NMT["word_vector_dim"],
                              param_attr=ParamAttr(name="_trg_emb"),
                              name="m_trg_emb")
        probs = networks.gru_encoder_decoder(
            src_word_id=src, trg_embedding=emb, name="m",
            trg_vocab_select=sel, **NMT)
    r = np.random.RandomState(SEED + 4)
    cand = nmt_candidates(r, len(requests[0]), K=SCORING_K)
    batch = [(src, r.randint(2, V, size=len(src) // 2 + 1).tolist(),
              c.tolist()) for (src,), c in zip(requests[0], cand)]
    score_feeding = {"src": 0, "trg": 1, "cand": 2}
    before = kernels.launches["fused_gru"]
    got = pt.Inference(probs, params, device="cuda").infer(batch,
                                                           score_feeding)
    rose = kernels.launches["fused_gru"] - before
    want = pt.Inference(probs, params, device="cpu").infer(batch,
                                                           score_feeding)
    err = float(np.abs(got - want).max())
    steps = got.reshape(len(batch), -1, V)
    off = np.ones(steps.shape[::2], bool)
    off[np.arange(len(batch))[:, None], cand] = False
    stray = float(np.abs(steps.transpose(0, 2, 1)[off]).max())
    print(f"  scoring form with {SCORING_K} candidates, B={len(batch)}: "
          f"fused_gru launches +{rose}, max |prob - cpu| = {err:.3e}, "
          f"largest probability off the candidates {stray:.3e}", flush=True)
    if not np.isfinite(got).all() or not np.allclose(got, want, **LOGIT_TOL):
        raise SystemExit(f"card and CPU probabilities differ by {err}")
    if stray != 0.0:
        raise SystemExit("probability mass off the candidate columns")
    if rose != 2:
        raise SystemExit(f"scoring form launched fused_gru {rose} times")

    transposed_gather(requests)
    # the latencies with early exit (the selective and compact decodes of
    # these weights end within a few ticks: eos is among 1024 candidates)
    # and over all MAX_LEN ticks (early_exit=False: the same ids), where
    # the three modes do the same number of ticks
    full_loop = {m: pt.Inference(topology(m, early_exit=False), params,
                                 device="cuda") for m in MODES}
    for mode in MODES:
        for batch in rows[mode][:2]:
            full_loop[mode].infer(batch, feeding[mode])
    print(f"  request latency on the card ({card_line()}), the modes in "
          f"turns, {LATENCY_ROUNDS} rounds: median [min, max] ms",
          flush=True)
    for kind, infs in (("early exit", on_card),
                       (f"all {MAX_LEN} ticks", full_loop)):
        for i in (0, 1):
            times = {mode: [] for mode in MODES}
            for _ in range(LATENCY_ROUNDS):
                for mode in MODES:
                    t0 = time.perf_counter()
                    infs[mode].infer(rows[mode][i], feeding[mode])
                    times[mode].append((time.perf_counter() - t0) * 1e3)
            print(f"    {kind}, B={len(requests[i])}: " + "; ".join(
                f"{mode} {np.median(t):.3f} [{min(t):.3f}, {max(t):.3f}]"
                for mode, t in times.items()), flush=True)
    B = len(requests[0])
    where_time_goes(lambda: on_card["compact"].infer(rows["compact"][0],
                                                     SELECT_FEEDING),
                    f"one B={B} compact decode request")
    for mode in MODES:
        where_time_goes(
            lambda: full_loop[mode].infer(rows[mode][0], feeding[mode]),
            f"one B={B} {mode} decode request over all {MAX_LEN} ticks",
            host_top=8)
    return counts


# --- the per-slot step decode ----------------------------------------------

class CountedModule:
    """A step export's init or step module that records the fused_gru
    launches of each call."""

    def __init__(self, kernels, module):
        self.kernels, self.module, self.rises = kernels, module, []

    def call(self, *flat):
        before = self.kernels.launches["fused_gru"]
        out = self.module.call(*flat)
        self.rises.append(self.kernels.launches["fused_gru"] - before)
        return out


def step_requests(mode):
    """STEP_REQUESTS rows of STEP_SRC_LEN source ids (and CAND_K
    candidates in compact mode) from a seeded stream, padded to the
    export's STEP_SEQ_LEN; the i-th request's max_new is STEP_CAPS[i % 3]."""
    r = np.random.RandomState(SEED + 5)
    mask = np.zeros(STEP_SEQ_LEN, np.float32)
    mask[:STEP_SRC_LEN] = 1.0
    reqs = []
    for i in range(STEP_REQUESTS):
        src = np.zeros(STEP_SEQ_LEN, np.int32)
        src[:STEP_SRC_LEN] = r.randint(2, NMT["src_dict_dim"],
                                       size=STEP_SRC_LEN)
        feeds = {"src": src, "src:mask": mask}
        if mode == "compact":
            feeds["cand"] = nmt_candidates(r, 1, K=CAND_K)[0].astype(
                np.float32)
        reqs.append((feeds, STEP_CAPS[i % len(STEP_CAPS)]))
    return reqs


def step_run(driver_cls, export, kernels, reqs, drain, caps=True):
    """Every request submitted at once, then ticked to the end; returns
    the handles (in submission order), the wall seconds, and the fused_gru
    launches of each init and step call."""
    export = dict(export, init=CountedModule(kernels, export["init"]),
                  step=CountedModule(kernels, export["step"]))
    drv = driver_cls(export, drain=drain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [drv.submit(f, max_new=cap if caps else None)
               for f, cap in reqs]
    drv.run()
    wall = time.perf_counter() - t0
    return drv, handles, wall, export["init"].rises, export["step"].rises


def step_metrics(label, drv, handles, wall):
    lat = np.array([h.done_time - h.submit_time for h in handles]) * 1e3
    ttft = np.array([h.first_token_time - h.submit_time
                     for h in handles]) * 1e3
    print(f"    {label}: {len(handles) / wall:.2f} requests/s, latency p50 "
          f"{np.percentile(lat, 50):.3f} p95 {np.percentile(lat, 95):.3f} "
          f"ms, time to first token p50 {np.percentile(ttft, 50):.3f} p95 "
          f"{np.percentile(ttft, 95):.3f} ms, {drv.tick_count} ticks, "
          f"admissions {drv.admissions}", flush=True)


def step_decode_phase(pt, kernels):
    """The NMT decode through the per-slot step export (io/merged_model.
    export_decode_step_ex, step_decode.StepDecodeDriver) at full width,
    STEP_SLOTS slots, in compact and dense mode: drain mode with
    STEP_SLOTS co-admitted requests against the whole-loop decode of the
    same batch on the card; STEP_REQUESTS requests (caps STEP_CAPS) in
    continuous and drain mode, each request's ids and tokens equal in
    both, a capped request's tokens the first k of its uncapped decode;
    fused_gru 2 launches an admission and none a tick; requests/s,
    latency, time to first token and ticks of both; one tick under the
    profiler. Returns the continuous runs' fused_gru launches."""
    from paddle_tpu_torch.io.merged_model import export_decode_step_ex
    from paddle_tpu_torch.models.text import nmt_decode_topology
    from paddle_tpu_torch.step_decode import StepDecodeDriver

    launches = 0
    params = None
    for mode in ("compact", "dense"):
        gen = nmt_decode_topology(beam_size=BEAM, max_length=MAX_LEN,
                                  cand_k=CAND_K, mode=mode, **NMT)
        if params is None:
            params = nmt_decode_params(pt, pt.Topology(gen), STEP_EOS_BIAS)
        export, reason = export_decode_step_ex(
            pt.Topology(gen), params, slots=STEP_SLOTS,
            seq_len=STEP_SEQ_LEN, device="cuda")
        if export is None:
            raise SystemExit(f"{mode}: no step export: {reason}")
        reqs = step_requests(mode)
        feeding = SELECT_FEEDING if mode == "compact" else None
        # warm-up of both modes' shapes
        step_run(StepDecodeDriver, export, kernels, reqs[:STEP_SLOTS], True)

        # (1) drain: STEP_SLOTS co-admitted requests, uncapped, against the
        # whole loop's decode of the same batch on the card
        first = reqs[:STEP_SLOTS]
        drv, solo, _w, _i, _s = step_run(StepDecodeDriver, export, kernels,
                                         first, True, caps=False)
        rows = [(f["src"][:STEP_SRC_LEN].tolist(),)
                + ((f["cand"].astype(np.int64).tolist(),)
                   if mode == "compact" else ()) for f, _c in first]
        inf = pt.Inference(gen, params, device="cuda")
        _b, w_ids, w_scores, w_ticks = decode_extras(inf, rows, feeding)
        ids = np.stack([h.ids for h in solo])
        scores = np.stack([h.scores for h in solo])
        s_err = float(np.abs(scores - w_scores).max())
        print(f"  {mode}: {STEP_SLOTS} co-admitted requests in drain mode "
              f"against the whole-loop decode on the card: ids equal "
              f"{np.array_equal(ids, w_ids)}, max |score - whole loop| = "
              f"{s_err:.3e}, ticks {max(h.ticks for h in solo)} vs "
              f"{w_ticks}, the slots' ticks {sorted({h.ticks for h in solo})}",
              flush=True)
        if not np.array_equal(ids, w_ids) or not s_err <= 1e-5 or \
                max(h.ticks for h in solo) != w_ticks:
            raise SystemExit(f"{mode}: the step decode and the whole loop "
                             "differ")

        # (2) the request stream, continuous and drain, capped
        kernels.reset_launch_counts()
        cont = step_run(StepDecodeDriver, export, kernels, reqs, False)
        launches += kernels.launches["fused_gru"]
        drain = step_run(StepDecodeDriver, export, kernels, reqs, True)
        print(f"  {mode}: {STEP_REQUESTS} requests (max_new "
              f"{list(STEP_CAPS)} in turn), {STEP_SLOTS} slots "
              f"({card_line()})", flush=True)
        step_metrics("continuous", *cont[:3])
        step_metrics("drain", *drain[:3])
        if cont[0].admissions["mid_batch"] < 1:
            raise SystemExit(f"{mode}: no mid-batch admission")
        for i, (c, d) in enumerate(zip(cont[1], drain[1])):
            if not (np.array_equal(c.ids, d.ids) and c.tokens == d.tokens
                    and c.ticks == d.ticks):
                raise SystemExit(
                    f"{mode}: request {i} differs between continuous (slot "
                    f"{c.slot}, tick {c.admit_tick}) and drain (slot "
                    f"{d.slot}, tick {d.admit_tick})")
            cap = reqs[i][1]
            if cap is not None and i < STEP_SLOTS and \
                    c.tokens != solo[i].tokens[:cap]:
                raise SystemExit(f"{mode}: capped request {i}'s tokens are "
                                 "not the first of its uncapped decode")
            if cap is not None and c.ticks > cap:
                raise SystemExit(f"{mode}: request {i} ran past its cap")
        for label, (drv, _h, _w, inits, steps) in (("continuous", cont),
                                                   ("drain", drain)):
            if set(inits) != {2} or set(steps) != {0} or \
                    len(inits) != sum(drv.admissions.values()):
                raise SystemExit(
                    f"{mode} {label}: fused_gru launched {set(inits)} an "
                    f"admission and {set(steps)} a tick, expected 2 and 0")
        print(f"  {mode}: each request's ids and tokens equal in continuous "
              f"and drain mode, capped tokens the first k of the uncapped "
              f"decode; fused_gru 2 launches an admission "
              f"({len(cont[3])} continuous), none a tick", flush=True)
        # one tick of a full slot array under the profiler
        drv = StepDecodeDriver(export)
        for f, _c in reqs[:STEP_SLOTS]:
            drv.submit(f)
        drv.tick()
        torch.cuda.synchronize()
        where_time_goes(drv.tick, f"one {mode} tick of {STEP_SLOTS} live "
                        "slots")
    return launches


# --- generation bundles -----------------------------------------------------

def gen_model(pt, label):
    """The topology and weights (random from SEED) of the GEN_BUNDLES
    entry ``label``, or of the RNN CRF tagger's features (GEN_TAGGER)."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import (nmt_decode_topology,
                                              rnn_crf_tagger)

    if label == GEN_TAGGER:
        with layer_name_scope():
            topo = pt.Topology(rnn_crf_tagger(**RNN_CRF)[2])
        return topo, pt.Parameters.from_numpy(random_weights(topo))
    _l, words, mode, _q = next(b for b in GEN_BUNDLES if b[0] == label)
    topo = pt.Topology(nmt_decode_topology(
        beam_size=BEAM, max_length=MAX_LEN, cand_k=GEN_CAND_K, mode=mode,
        **dict(NMT, src_dict_dim=words, trg_dict_dim=words)))
    return topo, nmt_decode_params(pt, topo, STEP_EOS_BIAS)


def gen_requests(mode, words):
    """GEN_REQUESTS rows of STEP_SRC_LEN source ids below ``words`` (and
    GEN_CAND_K candidates in compact mode), padded to STEP_SEQ_LEN; the
    i-th request's max_new is STEP_CAPS[i % 3]."""
    r = np.random.RandomState(SEED + 6)
    mask = np.zeros(STEP_SEQ_LEN, np.float32)
    mask[:STEP_SRC_LEN] = 1.0
    reqs = []
    for i in range(GEN_REQUESTS):
        src = np.zeros(STEP_SEQ_LEN, np.int32)
        src[:STEP_SRC_LEN] = r.randint(2, words, size=STEP_SRC_LEN)
        feeds = {"src": src, "src:mask": mask}
        if mode == "compact":
            feeds["cand"] = nmt_candidates(r, 1, K=GEN_CAND_K, V=words)[
                0].astype(np.float32)
        reqs.append((feeds, STEP_CAPS[i % len(STEP_CAPS)]))
    return reqs


def gen_bundle(label, path):
    """A worker process's task, on the CPU: write the bundle ``label``
    (GEN_BUNDLES, or GEN_TAGGER) with the port's meta to ``path``, then,
    for a decode, run GEN_SLOTS co-admitted requests in drain mode through
    its step artifacts on the CPU (driver_from_bundle_meta). Returns the
    export and write seconds, the bundle's bytes and the CPU's ids and
    scores."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.io import merged_model as mm
    from paddle_tpu_torch.step_decode import driver_from_bundle_meta

    # the workers share the host's cores
    torch.set_num_threads(2)
    topo, params = gen_model(pt, label)
    spec = next((b for b in GEN_BUNDLES if b[0] == label), None)
    qmeta = None
    if spec is not None and spec[3] != "f32":
        qd, qmeta = quant.quantize_params(topo, params.as_dict(), spec[3])
        params = pt.Parameters.from_dict(qd)
    t0 = time.perf_counter()
    meta = mm.bundle_meta(topo, params, qmeta=qmeta, seq_len=(
        EXPORT_T if spec is None else STEP_SEQ_LEN),
        static_batch=GEN_BATCHES[0], slots=GEN_SLOTS)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        mm.write_bundle(f, topo, params, meta=meta)
    out = {"export_s": export_s, "write_s": time.perf_counter() - t0,
           "bytes": Path(path).stat().st_size}
    if spec is not None:
        drv = driver_from_bundle_meta(meta, drain=True, device="cpu")
        handles = [drv.submit(f) for f, _c in
                   gen_requests(spec[2], spec[1])[:GEN_SLOTS]]
        drv.run()
        out["ids"] = np.stack([h.ids for h in handles])
        out["scores"] = np.stack([h.scores for h in handles])
    return out


def write_gen_bundles(workdir):
    """Every bundle of phase 5d, written at once by worker processes
    (spawned: each builds its model from SEED on the CPU), as
    gen_bundle returns them, by label."""
    import concurrent.futures
    import multiprocessing

    labels = [b[0] for b in GEN_BUNDLES] + [GEN_TAGGER]
    with concurrent.futures.ProcessPoolExecutor(
            len(labels),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(gen_bundle, label, str(workdir / label))
                   for label in labels]
        return {label: f.result() for label, f in zip(labels, futures)}


def bundle_params(path):
    """A bundle's parameters widened to float32, read past its JSON header
    (a generation topology does not rebuild from a bundle's config: its
    step is a Python function)."""
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.io import merged_model as mm

    with open(path, "rb") as f:
        meta = mm._read_header(f, path)
        return mm.dequantize_bundle_params(Parameters.from_tar(f), meta)


def synced(fn):
    """fn's result once the device has finished it."""
    def run():
        out = fn()
        torch.cuda.synchronize()
        return out
    return run


def slot_inputs(export, reqs):
    """The init's inputs for GEN_SLOTS admitted requests, one a row."""
    from paddle_tpu_torch.io.merged_model import DTYPES

    return [torch.as_tensor(np.stack([f[s["name"]] for f, _c in reqs]),
                            dtype=DTYPES[s["dtype"]],
                            device=export["device"])
            for s in export["signature"]["inputs"]]


def gen_decode_checks(pt, kernels, label, words, mode, workdir, written):
    """Phase 5d's checks of one decode bundle on the card; returns the
    fused_gru launches of its artifacts' main-path runs (the stream in
    continuous and drain mode, the whole loop at GEN_BATCHES)."""
    from paddle_tpu_torch.io import merged_model as mm
    from paddle_tpu_torch.step_decode import (StepDecodeDriver,
                                              driver_from_bundle_meta)

    path = str(workdir / label)
    t0 = time.perf_counter()
    meta = mm.read_bundle_meta(path)
    params = bundle_params(path)
    read_s = time.perf_counter() - t0
    topo, _p = gen_model(pt, label)
    t0 = time.perf_counter()
    art = mm.load_step_export(meta, "cuda")
    load_s = time.perf_counter() - t0
    live, reason = mm.export_decode_step_ex(topo, params, slots=GEN_SLOTS,
                                            seq_len=STEP_SEQ_LEN,
                                            device="cuda")
    if live is None:
        raise SystemExit(f"{label}: no in-process step export: {reason}")
    sig = art["signature"]
    print(f"  {label} ({words} words): bundle {written['bytes']} bytes, "
          f"exported in {written['export_s']:.3f} s and written in "
          f"{written['write_s']:.3f} s by its worker; read in {read_s:.3f} "
          f"s, its step artifacts loaded onto the card in {load_s:.3f} s; "
          f"symbolic slot batch: {sig['symbolic_batch']}", flush=True)
    reqs = gen_requests(mode, words)
    first = reqs[:GEN_SLOTS]
    for export in (art, live):        # warm-up of the shapes
        step_run(StepDecodeDriver, export, kernels, first, True)

    # (1) GEN_SLOTS co-admitted requests in drain mode, uncapped
    drv = driver_from_bundle_meta(meta, drain=True, device="cuda")
    handles = [drv.submit(f) for f, _c in first]
    drv.run()
    _d, ref, _w, _i, _s = step_run(StepDecodeDriver, live, kernels, first,
                                   True, caps=False)
    ids, scores = (np.stack([getattr(h, k) for h in handles])
                   for k in ("ids", "scores"))
    err = float(np.abs(scores - np.stack([h.scores for h in ref])).max())
    cpu_err = float(np.abs(scores - written["scores"]).max())
    print(f"    drain, {GEN_SLOTS} co-admitted requests: ids equal the "
          f"in-process step's {np.array_equal(ids, np.stack([h.ids for h in ref]))}"
          f" (max |score diff| {err:.3e}) and the CPU artifacts' "
          f"{np.array_equal(ids, written['ids'])} ({cpu_err:.3e}); the "
          f"slots' ticks {sorted({h.ticks for h in handles})}", flush=True)
    if not (np.array_equal(ids, np.stack([h.ids for h in ref]))
            and err <= GEN_TOL and np.array_equal(ids, written["ids"])
            and cpu_err <= GEN_CPU_TOL):
        raise SystemExit(f"{label}: the step artifacts' decode differs from "
                         "the in-process step's or the CPU's")

    # (2) the request stream through the artifacts, continuous and drain,
    # capped as in 5c; the in-process step on the same requests
    before = kernels.launches["fused_gru"]
    cont = step_run(StepDecodeDriver, art, kernels, reqs, False)
    drain = step_run(StepDecodeDriver, art, kernels, reqs, True)
    launches = kernels.launches["fused_gru"] - before
    inproc = step_run(StepDecodeDriver, live, kernels, reqs, False)
    print(f"    {GEN_REQUESTS} requests (max_new {list(STEP_CAPS)} in turn), "
          f"{GEN_SLOTS} slots ({card_line()})", flush=True)
    step_metrics("artifacts, continuous", *cont[:3])
    step_metrics("artifacts, drain", *drain[:3])
    step_metrics("in-process step, continuous", *inproc[:3])
    if cont[0].admissions["mid_batch"] < 1:
        raise SystemExit(f"{label}: no mid-batch admission")
    for i, (c, d, p) in enumerate(zip(cont[1], drain[1], inproc[1])):
        if not (np.array_equal(c.ids, d.ids) and c.tokens == d.tokens
                and np.array_equal(c.ids, p.ids)):
            raise SystemExit(f"{label}: request {i} differs between "
                             "continuous, drain and the in-process step")
    for run_label, (drv, _h, _w, inits, steps) in (("continuous", cont),
                                                   ("drain", drain)):
        if set(inits) != {2} or set(steps) != {0} or \
                len(inits) != sum(drv.admissions.values()):
            raise SystemExit(
                f"{label} {run_label}: fused_gru launched {set(inits)} an "
                f"admission and {set(steps)} a tick, expected 2 and 0")

    # an admission (one init over the slot batch) and a tick of full slots
    flat = slot_inputs(art, first)
    _o, adm_ms = timed(synced(lambda: art["init"].call(*flat)))
    _o, live_adm_ms = timed(synced(lambda: live["init"].call(*flat)))
    ticks = {}
    for name, export in (("artifacts", art), ("in-process", live)):
        drv = StepDecodeDriver(export)
        for f, _c in first:
            drv.submit(f)
        drv.tick()
        _o, ticks[name] = timed(drv.tick)
    print(f"    an admission {adm_ms:.3f} ms (in-process {live_adm_ms:.3f});"
          f" a tick of {GEN_SLOTS} live slots {ticks['artifacts']:.3f} ms "
          f"(in-process {ticks['in-process']:.3f}), medians of 5; "
          f"fused_gru 2 launches an admission, none a tick", flush=True)
    drv = StepDecodeDriver(art)
    for f, _c in first:
        drv.submit(f)
    drv.tick()
    torch.cuda.synchronize()
    where_time_goes(drv.tick, f"one {label} artifact tick of {GEN_SLOTS} "
                    "live slots")

    # (3) the whole loop's artifact against Inference on the card
    t0 = time.perf_counter()
    fx = mm.load_forward_export(meta)
    load_s = time.perf_counter() - t0
    fsig = fx.signature
    names = [o["name"] for o in fsig["outputs"]]
    inf = pt.Inference(topo.outputs, params, device="cuda")
    feeding = SELECT_FEEDING if mode == "compact" else None
    cases = GEN_BATCHES if fsig["symbolic_batch"] else GEN_BATCHES[:1]
    for B in cases:
        args = [np.stack([f[s["name"]] for f, _c in reqs[:B]])
                for s in fsig["inputs"]]
        rows = [(f["src"][:STEP_SRC_LEN].tolist(),)
                + ((f["cand"].astype(np.int64).tolist(),)
                   if mode == "compact" else ()) for f, _c in reqs[:B]]
        decode_extras(inf, rows, feeding)           # warm-up: this shape
        before = kernels.launches["fused_gru"]
        out = dict(zip(names, fx(*args)))
        rose = kernels.launches["fused_gru"] - before
        _y, fx_ms = timed(lambda: [t.cpu() for t in fx(*args)])
        launches += kernels.launches["fused_gru"] - before
        (_b, w_ids, w_scores, w_ticks), inf_ms = timed(
            lambda: decode_extras(inf, rows, feeding))
        got_ids = out["m_gen:ids"].cpu().numpy()
        err = float(np.abs(out["m_gen:scores"].cpu().numpy()
                           - w_scores).max())
        ticks = int(out["m_gen:ticks"])
        print(f"    whole-loop artifact, B={B}: loaded in {load_s:.3f} s, "
              f"{fx_ms:.3f} ms a run against Inference's {inf_ms:.3f} "
              f"(medians of 5); ids equal {np.array_equal(got_ids, w_ids)},"
              f" max |score diff| {err:.3e}, ticks {ticks} vs {w_ticks}; "
              f"fused_gru +{rose}", flush=True)
        if not (np.array_equal(got_ids, w_ids) and err <= GEN_TOL
                and ticks == w_ticks and rose == 2):
            raise SystemExit(f"{label}: the whole-loop artifact differs from "
                             f"Inference at B={B}, or launched {rose}")
    return launches


def gen_bundle_phase(pt, kernels, workdir):
    """Phase 5d, generation bundles on the card: the full-width bundle's
    meta records the cap; each GEN_BUNDLES bundle's step artifacts decode
    through driver_from_bundle_meta as the in-process step does, and its
    whole loop's artifact as Inference does; the tagger's features
    artifact as Inference does, through the cluster kernel. Returns the
    artifacts' fused_gru and fused_gru_cluster launches."""
    from paddle_tpu_torch.io import merged_model as mm
    from paddle_tpu_torch.models.text import nmt_decode_topology
    from paddle_tpu_torch.step_decode import driver_from_bundle_meta
    from paddle_tpu_torch.utils.error import Error

    start = time.perf_counter()
    topo = pt.Topology(nmt_decode_topology(
        beam_size=BEAM, max_length=MAX_LEN, cand_k=CAND_K, mode="compact",
        **NMT))
    meta = mm.bundle_meta(topo, nmt_decode_params(pt, topo, STEP_EOS_BIAS),
                          seq_len=STEP_SEQ_LEN, slots=GEN_SLOTS)
    reasons = [meta.get(k, "") for k in ("torch_export_skip_reason",
                                         "torch_step_skip_reason")]
    try:
        driver_from_bundle_meta(meta)
        raised = ""
    except Error as e:
        raised = str(e)
    print(f"  full width: torch_export_skip_reason {reasons[0]!r}, "
          f"torch_step_skip_reason {reasons[1]!r}; driver_from_bundle_meta "
          f"raises {raised!r}", flush=True)
    if not all("too large" in x for x in reasons + [raised]):
        raise SystemExit("the full-width generation bundle lacks the 32 MiB "
                         "cap's skip reasons")

    t0 = time.perf_counter()
    written = write_gen_bundles(workdir)
    print(f"  {len(written)} bundles written (and the decodes' drain runs on "
          f"the CPU) by worker processes in {time.perf_counter() - t0:.1f} s "
          f"on a host of {len(os.sched_getaffinity(0))} usable cores",
          flush=True)
    gru = sum(gen_decode_checks(pt, kernels, label, words, mode, workdir,
                                written[label])
              for label, words, mode, _q in GEN_BUNDLES)

    # the RNN CRF tagger's features: the cluster kernel through the op
    path = str(workdir / GEN_TAGGER)
    meta = mm.read_bundle_meta(path)
    topo, params, _m = mm.load_merged_model(path)
    fx = mm.load_forward_export(meta)
    inf = pt.Inference(topo.outputs, params, device="cuda")
    ids = np.random.RandomState(SEED + 7).randint(
        0, CRF_WORDS, size=(GEN_BATCHES[0], EXPORT_T)).astype(np.int32)
    mask = np.ones(ids.shape, np.float32)
    cluster = 0
    cases = GEN_BATCHES if fx.signature["symbolic_batch"] else \
        GEN_BATCHES[:1]
    for B in cases:
        feed = [(row.tolist(),) for row in ids[:B]]
        inf.infer(feed)                              # warm-up: this shape
        before = kernels.launches["fused_gru_cluster"]
        y = fx(ids[:B], mask[:B])[0].reshape(B, -1).cpu().numpy()
        rose = kernels.launches["fused_gru_cluster"] - before
        _y, fx_ms = timed(lambda: fx(ids[:B], mask[:B])[0].cpu())
        cluster += kernels.launches["fused_gru_cluster"] - before
        want, inf_ms = timed(lambda: inf.infer(feed))
        err = float(np.abs(y - want).max())
        print(f"  rnn_crf_tagger's features {RNN_CRF}, B={B}, T={EXPORT_T}: "
              f"bundle {written[GEN_TAGGER]['bytes']} bytes, exported in "
              f"{written[GEN_TAGGER]['export_s']:.3f} s; {fx_ms:.3f} ms a "
              f"run against Inference's {inf_ms:.3f} (medians of 5); max "
              f"|artifact - Inference| {err:.3e}; fused_gru_cluster +{rose}",
              flush=True)
        if not (np.allclose(y, want, rtol=GEN_TOL, atol=GEN_TOL)
                and rose == 2):
            raise SystemExit(f"the tagger's features artifact differs from "
                             f"Inference by {err} at B={B}, or launched "
                             f"{rose}")
    print(f"  phase 5d ran in {time.perf_counter() - start:.1f} s",
          flush=True)
    return gru, cluster


# --- the NMT training slice ------------------------------------------------

def nmt_train_batches(B, n, lengths, seed):
    """n batches of B (src, trg, trg_next) rows: ``lengths(r, B)`` draws
    the source and target lengths; trg starts with <s> = 0 and trg_next
    is trg shifted by one, ended by <e> = 1 (dataset.synthetic.seq_pairs'
    layout, at bench_nmt's lengths)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src_lens, trg_lens = lengths(r, B)
        rows = []
        for ls, lt in zip(src_lens, trg_lens):
            trg = [0] + r.randint(2, NMT["trg_dict_dim"], size=lt - 1).tolist()
            rows.append((r.randint(2, NMT["src_dict_dim"], size=ls).tolist(),
                         trg, trg[1:] + [1]))
        out.append(rows)
    return out


def ragged_lengths(r, B):
    lens = r.randint(5, NMT_BENCH_T + 1, size=(2, B))
    lens[:, 0] = NMT_BENCH_T
    return lens


def nmt_training_phase(pt, kernels):
    """nmt_attention_cost at full width trained on the card: Adam and
    Momentum at B=64 against the port's CPU run of the same batches, then
    bench_nmt's shape for the step time. Returns the launch counts of each
    run."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import nmt_attention_cost
    from paddle_tpu_torch.trainer import make_train_step
    from paddle_tpu_torch.trainer.feeder import DataFeeder, _bucket

    with layer_name_scope():
        cost = nmt_attention_cost(**NMT)
    topo = pt.Topology(cost)
    weights = random_weights(topo)
    n_params = sum(int(np.prod(s.shape)) for s in topo.param_specs().values())
    checked = nmt_train_batches(NMT_TRAIN_B, NMT_TRAIN_STEPS, ragged_lengths,
                                SEED + 5)
    full = nmt_train_batches(
        NMT_BENCH_B, 6, lambda r, B: np.full((2, B), NMT_BENCH_T), SEED + 6)
    ragged_feed = dict(feeding=NMT_FEEDING)
    runs = [("adam", lambda: pt.optimizer.Adam(learning_rate=5e-4),
             checked, ragged_feed, True),
            ("momentum", lambda: pt.optimizer.Momentum(
                momentum=0.9, learning_rate=0.01), checked[:TRAIN_CHECKED],
             ragged_feed, True),
            ("adam", lambda: pt.optimizer.Adam(learning_rate=5e-4), full,
             NMT_BENCH_FEED, False)]
    counts = []
    for name, make_opt, batches, feed, check in runs:
        B = len(batches[0])
        # the checked runs' sources bucket to T=32, bench_nmt's stay 30
        T = _bucket(NMT_BENCH_T, True) if check else NMT_BENCH_T
        per_step = gru_train_launches(B, T, NMT["encoder_size"])
        cpu = cpu_steps = None
        if check:
            t0 = time.perf_counter()
            cpu, cpu_steps = train_run(pt, kernels, cost, weights, make_opt(),
                                       batches[:TRAIN_CHECKED], "cpu",
                                       **feed)
            cpu_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        card, steps = train_run(pt, kernels, cost, weights, make_opt(),
                                batches, "cuda", **feed)
        counts.append(dict(kernels.launches))
        tokens = sum(len(row[1]) for row in batches[-1])
        print(f"  {name}, {len(batches)} batches of {B} sentence pairs"
              + (f"; the CPU run of the first {TRAIN_CHECKED} took "
                 f"{cpu_s:.1f} s" if check else
                 f", every source and target {NMT_BENCH_T} long"),
              flush=True)
        rtol = TRAIN_COST_RTOL[name]
        for i, (c, ms, rose) in enumerate(steps):
            ref = cpu_steps[i][0] if check and i < TRAIN_CHECKED else None
            rel = abs(c - ref) / abs(ref) if ref is not None else None
            print(f"    step {i}: cost {c:.7f}"
                  + (f" (cpu {ref:.7f}, rel diff {rel:.3e})"
                     if ref is not None else "")
                  + f", {ms:.3f} ms, launches "
                  + str({k: rose[k] for k in per_step}), flush=True)
            if not np.isfinite(c):
                raise SystemExit(f"nmt {name}: non-finite cost at step {i}")
            if ref is not None and not rel <= rtol:
                raise SystemExit(f"nmt {name}: step {i} cost {c} vs CPU "
                                 f"{ref} (rel {rel:.3e} > {rtol})")
            if any(rose[k] != n for k, n in per_step.items()):
                raise SystemExit(f"nmt {name}: step {i} launched {rose}, "
                                 f"expected {per_step} (the encoder's two "
                                 "directions)")
        if name == "momentum":
            err = max(float((card.parameters.get(k)
                             - cpu.parameters.get(k)).abs().max())
                      for k in cpu.parameters.names())
            print(f"    parameters after {TRAIN_CHECKED} steps: max |card - "
                  f"cpu| = {err:.3e}", flush=True)
            if not err <= TRAIN_PARAM_ATOL:
                raise SystemExit(f"nmt momentum parameters differ by {err}")
        else:
            step_ms = float(np.median([ms for _, ms, _ in steps[-4:]]))
            print(f"  ms per training step at B={B} (median of the last "
                  f"4): {step_ms:.3f}; {tokens / step_ms * 1e3:.1f} target "
                  f"tokens/s; {n_params} parameters; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
                  flush=True)

    # one bench_nmt step under the profiler: the train loop's step function
    optimizer = pt.optimizer.Adam(learning_rate=5e-4)
    step = make_train_step(topo.loss_fn(cost), optimizer, topo.static_map(),
                           topo.lr_mults())
    params = {k: torch.from_numpy(v).cuda() for k, v in weights.items()}
    state = optimizer.init(params)
    feeds = {k: a.to("cuda") for k, a in
             DataFeeder(topo.data_type(), NMT_FEEDING,
                        bucket_rounding=NMT_BENCH_T)(full[-1]).items()}

    def one_step():
        float(step(params, state, feeds)[2])

    one_step()
    where_time_goes(one_step, f"one B={NMT_BENCH_B} T={NMT_BENCH_T} NMT "
                    "Adam training step", top=25)
    return counts


# --- the packing-ready NMT model on padded feeds ---------------------------

def packed_stream():
    """bench_nmt_packed's stream: (src, trg, trg_next) id lists."""
    r = np.random.RandomState(0)
    lo, hi = PACKED_LENGTHS
    V = PACKED["trg_dict_dim"]
    out = []
    for _ in range(PACKED_B):
        ts = int(r.randint(lo, hi + 1))
        tt = max(3, ts + int(r.randint(-2, 3)))
        out.append((r.randint(0, V, ts).tolist(), r.randint(0, V, tt).tolist(),
                    r.randint(0, V, tt).tolist()))
    return out


def packed_requests(stream):
    out, at = [], 0
    for B in PACKED_REQUESTS:
        out.append([s[:2] for s in stream[at:at + B]])
        at += B
    return out


def packed_shapes(batches, bucket):
    """(B, T) of the encoder's and the decoder's GRUs on each batch."""
    return [(len(b), bucket(max(len(s[i]) for s in b), True))
            for b in batches for i in (0, 1)]


def packed_launches(batch, bucket, H):
    """A training step's GRU launches on ``batch``: the encoder's two
    directions at its source T, the decoder at its target T."""
    B = len(batch)
    enc = gru_train_launches(B, bucket(max(len(s[0]) for s in batch), True),
                             H, n=2)
    dec = gru_train_launches(B, bucket(max(len(s[1]) for s in batch), True),
                             H, n=1)
    return {k: enc[k] + dec[k] for k in GRU_TRAIN_KERNELS}


def nmt_packed_phase(pt, kernels):
    """models.text.nmt_packed_cost at full width on padded feeds: served
    through ``infer`` on its softmax output (probabilities against the
    port's CPU run, 3 fused_gru forwards a request), trained through
    SGD.train (Adam costs against the CPU run, then bench_nmt_packed's
    batch for the step time; a step launches each GRU kernel 3 times).
    Returns the launch counts of each run."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.kernels.gru import gru_fwd_plan
    from paddle_tpu_torch.models.text import nmt_packed_cost
    from paddle_tpu_torch.trainer import make_train_step
    from paddle_tpu_torch.trainer.feeder import DataFeeder, _bucket

    H = PACKED["decoder_size"]
    with layer_name_scope():
        cost = nmt_packed_cost(**PACKED)
    out = cost.inputs[0]
    topo = pt.Topology(cost)
    weights = random_weights(topo)
    params = pt.Parameters.from_numpy(weights)
    stream = packed_stream()
    requests = packed_requests(stream)
    on_card = pt.Inference(out, params, device="cuda")
    on_cpu = pt.Inference(out, params, device="cpu")
    fwd_kernel = {"grid": "fused_gru", "cluster": "fused_gru_cluster"}
    on_card.infer(requests[1], feeding=PACKED_SERVE_FEEDING)   # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    served = []
    for batch in requests:
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        probs = on_card.infer(batch, feeding=PACKED_SERVE_FEEDING)
        ms = (time.perf_counter() - t0) * 1e3
        served.append((batch, probs, ms, {k: kernels.launches[k] - before[k]
                                          for k in before}))
    counts = [dict(kernels.launches)]
    for batch, probs, ms, rose in served:
        B = len(batch)
        name = fwd_kernel[gru_fwd_plan(B, H).path]
        ref = on_cpu.infer(batch, feeding=PACKED_SERVE_FEEDING)
        err = float(np.abs(probs - ref).max())
        T = _bucket(max(len(s[1]) for s in batch), True)
        print(f"  request B={B} (T={T}): {ms:.3f} ms on the card, {name} "
              f"launches +{rose[name]}, max |prob - cpu| = {err:.3e} "
              f"({card_line()})", flush=True)
        if probs.size != B * T * PACKED["trg_dict_dim"] or \
                not np.isfinite(probs).all():
            raise SystemExit(f"nmt_packed: bad output of {probs.shape}")
        if not np.allclose(probs, ref, **PACKED_PROB_TOL):
            raise SystemExit(f"nmt_packed: card and CPU probabilities "
                             f"differ by {err}")
        if rose[name] != 3 or sum(rose.values()) != 3:
            raise SystemExit(f"nmt_packed: a request launched {rose}, "
                             f"expected 3 {name} (three GRUs)")
    where_time_goes(lambda: on_card.infer(requests[0],
                                          feeding=PACKED_SERVE_FEEDING),
                    f"one B={PACKED_REQUESTS[0]} nmt_packed request")

    checked = [stream[i:i + PACKED_TRAIN_B]
               for i in range(0, PACKED_B, PACKED_TRAIN_B)][:PACKED_CHECKED]
    make_opt = lambda: pt.optimizer.Adam(learning_rate=5e-4)  # noqa: E731
    t0 = time.perf_counter()
    _cpu, cpu_steps = train_run(pt, kernels, cost, weights, make_opt(),
                                checked, "cpu", feeding=NMT_FEEDING)
    cpu_s = time.perf_counter() - t0
    runs = [("checked", checked, cpu_steps),
            ("bench", [stream] * PACKED_TIMED, None)]
    for label, batches, ref_steps in runs:
        kernels.reset_launch_counts()
        _card, steps = train_run(pt, kernels, cost, weights, make_opt(),
                                 batches, "cuda", feeding=NMT_FEEDING)
        counts.append(dict(kernels.launches))
        print(f"  Adam, {len(batches)} batches of {len(batches[0])} samples"
              + (f"; the CPU run took {cpu_s:.1f} s" if ref_steps else
                 ", bench_nmt_packed's whole batch each step"), flush=True)
        for i, (c, ms, rose) in enumerate(steps):
            per_step = packed_launches(batches[i], _bucket, H)
            ref = ref_steps[i][0] if ref_steps else None
            rel = abs(c - ref) / abs(ref) if ref is not None else None
            print(f"    step {i}: cost {c:.7f}"
                  + (f" (cpu {ref:.7f}, rel diff {rel:.3e})"
                     if ref is not None else "")
                  + f", {ms:.3f} ms, launches "
                  + str({k: rose[k] for k in per_step}), flush=True)
            if not np.isfinite(c):
                raise SystemExit(f"nmt_packed: non-finite cost at step {i}")
            if ref is not None and not rel <= TRAIN_COST_RTOL["adam"]:
                raise SystemExit(f"nmt_packed: step {i} cost {c} vs CPU {ref}"
                                 f" (rel {rel:.3e})")
            if any(rose[k] != n for k, n in per_step.items()):
                raise SystemExit(f"nmt_packed: step {i} launched {rose}, "
                                 f"expected {per_step} (three GRUs)")
        if ref_steps is None:
            step_ms = float(np.median([ms for _, ms, _ in steps[-4:]]))
            tokens = sum(len(s[1]) for s in stream)
            print(f"  ms per training step at B={PACKED_B} (median of the "
                  f"last 4): {step_ms:.3f}; {tokens / step_ms * 1e3:.1f} real "
                  f"target tokens/s ({tokens} a batch); peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
                  f"({card_line()})", flush=True)

    # one bench_nmt_packed step under the profiler
    optimizer = make_opt()
    step = make_train_step(topo.loss_fn(cost), optimizer, topo.static_map(),
                           topo.lr_mults())
    dev = {k: torch.from_numpy(v).cuda() for k, v in weights.items()}
    state = optimizer.init(dev)
    feeds = {k: a.to("cuda") for k, a in
             DataFeeder(topo.data_type(), NMT_FEEDING)(stream).items()}

    def one_step():
        float(step(dev, state, feeds)[2])

    one_step()
    where_time_goes(one_step, f"one B={PACKED_B} nmt_packed Adam training "
                    "step", top=15)
    return counts


# --- the sparse-input models -----------------------------------------------

def ctr_batches(n, seed):
    """bench_ctr's rows: 1..max_ids unique wide and deep ids, a click."""
    r = np.random.RandomState(seed)
    K = CTR["max_ids"]
    out = []
    for _ in range(n):
        rows = []
        for _i in range(SPARSE_INPUT_B):
            wk, dk = r.randint(1, K + 1), r.randint(1, K + 1)
            rows.append((np.unique(r.randint(0, CTR["wide_dim"], wk)).tolist(),
                         np.unique(r.randint(0, CTR["deep_vocab"],
                                             dk)).tolist(),
                         int(r.randint(0, 2))))
        out.append(rows)
    return out


def ngram_batches(n, seed):
    r = np.random.RandomState(seed)
    return [[tuple(int(i) for i in row) for row in
             r.randint(0, 2000, size=(SPARSE_INPUT_B, 5))] for _ in range(n)]


def sparse_inputs_phase(pt, kernels):
    """ctr_wide_deep at bench_ctr's device-resident shape and ngram_lm at
    its defaults, trained through SGD.train with SGD: the first costs
    against the port's CPU run, then the step time. No kernel is on these
    paths (JAX computes them outside Pallas), and none may launch."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import ctr_wide_deep, ngram_lm

    models = [("ctr_wide_deep", lambda: ctr_wide_deep(**CTR), CTR_FEEDING,
               ctr_batches),
              ("ngram_lm", ngram_lm, NGRAM_FEEDING, ngram_batches)]
    for label, build, feeding, make_batches in models:
        with layer_name_scope():
            cost = build()[3]
        weights = random_weights(pt.Topology(cost))
        batches = make_batches(SPARSE_INPUT_TIMED, SEED + 9)
        sgd = lambda: pt.optimizer.SGD(learning_rate=SPARSE_INPUT_LR)  # noqa
        _cpu, cpu_steps = train_run(pt, kernels, cost, weights, sgd(),
                                    batches[:SPARSE_INPUT_CHECKED], "cpu",
                                    feeding=feeding)
        kernels.reset_launch_counts()
        _card, steps = train_run(pt, kernels, cost, weights, sgd(), batches,
                                 "cuda", feeding=feeding)
        print(f"  {label}: {len(batches)} SGD steps of B={SPARSE_INPUT_B}",
              flush=True)
        for i, (c, ms, rose) in enumerate(steps):
            ref = cpu_steps[i][0] if i < SPARSE_INPUT_CHECKED else None
            rel = abs(c - ref) / abs(ref) if ref is not None else None
            print(f"    step {i}: cost {c:.7f}"
                  + (f" (cpu {ref:.7f}, rel diff {rel:.3e})"
                     if ref is not None else "") + f", {ms:.3f} ms",
                  flush=True)
            if not np.isfinite(c):
                raise SystemExit(f"{label}: non-finite cost at step {i}")
            if ref is not None and not rel <= SPARSE_INPUT_RTOL:
                raise SystemExit(f"{label}: step {i} cost {c} vs CPU {ref} "
                                 f"(rel {rel:.3e})")
        if any(kernels.launches.values()):
            raise SystemExit(f"{label} launched {kernels.launches}; no "
                             "kernel is on its path")
        step_ms = float(np.median([ms for _, ms, _ in steps[-4:]]))
        rate = SPARSE_INPUT_B / step_ms * 1e3
        print(f"  {label} ms per SGD step at B={SPARSE_INPUT_B} (median of "
              f"the last 4): {step_ms:.3f}; {rate:.1f} examples/s; no kernel "
              f"launched ({card_line()})", flush=True)


# --- sparse-row training ---------------------------------------------------

def sparse_model(pt, sparse, gather):
    """tools/selfc_crossover.py's model at its 2-D point: selective_fc over
    SPARSE_C outputs (input SPARSE_D, SPARSE_K ids a row, fill 0) into
    square_error_cost; ``gather`` takes the gather path at any C, else the
    dense matmul and mask."""
    from paddle_tpu_torch import layer
    from paddle_tpu_torch.attr import ParamAttr
    from paddle_tpu_torch.core.layer import layer_name_scope

    dt = pt.data_type
    with layer_name_scope():
        x = layer.data(name="x", type=dt.dense_vector(SPARSE_D))
        s = layer.data(name="sel", type=dt.dense_vector(SPARSE_K))
        lab = layer.data(name="lab", type=dt.dense_vector(SPARSE_C))
        out = layer.selective_fc(
            input=x, select=s, size=SPARSE_C, name="sf",
            param_attr=ParamAttr(sparse_update=sparse), pass_generation=True,
            gather_min_c=1 if gather else 10 ** 12)
        cost = layer.square_error_cost(input=out, label=lab, name="cost")
    return pt.Topology(cost), cost


def sparse_batches(n):
    """n batches of SPARSE_B rows from a seeded stream, on the card: x, the
    selection (one in-row duplicate and one -1 pad a batch: the dedup and
    the dead slots run) and the label."""
    from paddle_tpu_torch.core.arg import Arg

    r = np.random.RandomState(SEED + 6)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    out = []
    for _ in range(n):
        sel = r.randint(0, SPARSE_C, (SPARSE_B, SPARSE_K)).astype(np.int32)
        sel[0, 1], sel[1, 2] = sel[0, 0], -1
        out.append({
            "x": Arg(torch.randn(SPARSE_B, SPARSE_D, device="cuda",
                                 generator=g)),
            "sel": Arg(torch.from_numpy(sel).cuda()),
            "lab": Arg(torch.randn(SPARSE_B, SPARSE_C, device="cuda",
                                   generator=g))})
    return out


def sparse_steps(pt, weights, sparse, gather, opt, batches, catchup=False):
    """SPARSE_CHECKED steps, then SPARSE_TIMED more, of make_train_step on
    the card from a copy of ``weights``. Returns the parameters, the
    optimizer state after the checked steps (on the card) and the sparse
    gradients the optimizer was handed in them, the timed steps' ms, each
    step's peak
    memory above what was allocated before it, the table's gradient
    kinds handed to the optimizer, and whether the table's leaf kept a
    .grad."""
    from paddle_tpu_torch.trainer.trainer import make_train_step

    topo, cost = sparse_model(pt, sparse, gather)
    params = {k: v.clone() for k, v in weights.items()}
    state = opt.init(params, sparse_catchup_for=[SPARSE_TABLE] if catchup
                     else ())
    loss = topo.loss_fn(cost)
    leaves, kinds, handed = {}, [], []

    def spy(p, feeds, **kw):          # the step's leaves, for their .grad
        leaves.update(p)
        return loss(p, feeds, **kw)

    spy._sparse_capable = loss._sparse_capable
    update = opt.update

    def record(grads, *a, **kw):
        kinds.append(type(grads[SPARSE_TABLE]).__name__)
        if len(kinds) <= SPARSE_CHECKED and kinds[-1] == "SparseRowGrad":
            handed.append(dict(grads))
        return update(grads, *a, **kw)

    opt.update = record
    step = make_train_step(spy, opt, topo.static_map())
    ms, rises, leaf_grads, checked = [], [], [], None
    for i in range(SPARSE_CHECKED + SPARSE_TIMED):
        if i == SPARSE_CHECKED:
            checked = ({k: v.clone() for k, v in params.items()},
                       {k: ({n: t.clone() for n, t in v.items()}
                            if isinstance(v, dict) else v.clone())
                        for k, v in state.items()}, handed)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, c, _m = step(params, state,
                                    batches[i % len(batches)])
        c = float(c)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rises.append(torch.cuda.max_memory_allocated() - base)
        leaf_grads.append(leaves[SPARSE_TABLE].grad is not None)
        if not np.isfinite(c):
            raise SystemExit(f"sparse phase: cost {c}")
        leaves.clear()
    return checked, ms[SPARSE_CHECKED:], rises, kinds, any(leaf_grads)


def sparse_adam_agrees(optimizer, run, weights):
    """Sparse Adam with t0 after the checked steps, every row caught up to
    the last step (catch_up_rows over gap = step - t0), against dense Adam
    from the same weights over the same gradients densified: the table, m,
    v and the bias within the CPU tests' tolerance (rtol 3e-5, atol 1e-6).
    The gradients are the ones the sparse run was handed: a model's own
    dense Adam run differs by more, as its forward sees every row's
    zero-gradient moves where the lazy one sees them only on a touch."""
    sp, ss, handed = run
    opt = optimizer.Adam(learning_rate=1e-3)
    dp = {k: v.clone() for k, v in weights.items()}
    ds = opt.init(dp)
    for grads in handed:
        dp, ds = opt.update({k: (g.dense() if k == SPARSE_TABLE else g)
                             for k, g in grads.items()}, ds, dp)
    slots = dict(ss[SPARSE_TABLE])
    gap = SPARSE_CHECKED - slots.pop("t0")
    table, slots = opt.catch_up_rows(sp[SPARSE_TABLE], slots, gap,
                                     opt.lr_fn(SPARSE_CHECKED))
    pairs = {"table": (table, dp[SPARSE_TABLE]),
             "m": (slots["m"], ds[SPARSE_TABLE]["m"]),
             "v": (slots["v"], ds[SPARSE_TABLE]["v"]),
             "bias": (sp["_sf.wbias"], dp["_sf.wbias"])}
    worst = {k: float(((a - b).abs() - 3e-5 * b.abs()).max())
             for k, (a, b) in pairs.items()}
    errs = {k: float((a - b).abs().max()) for k, (a, b) in pairs.items()}
    print(f"  Adam after {SPARSE_CHECKED} steps, every row caught up: max "
          f"|sparse - dense| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())}"
          f"; {int((gap > 0).sum())} rows caught up, by up to "
          f"{int(gap.max())} steps ({card_line()})", flush=True)
    if len(handed) != SPARSE_CHECKED or not max(worst.values()) <= 1e-6:
        raise SystemExit(f"sparse Adam with t0 disagrees with dense Adam: "
                         f"{worst}")


def sparse_adam_late(pt, weights):
    """Sparse Adam with t0 from the state SPARSE_LATE_STEP steps of
    uniform traffic leave: t0 the last step that drew each row (SPARSE_B x
    SPARSE_K draws a step over SPARSE_C rows), m and v those of one unit-
    normal gradient on every row drawn, the rest zero, t and the step
    counter SPARSE_LATE_STEP. One step to warm up, SPARSE_TIMED timed,
    one under the profiler, each on a fresh batch whose rows replay their
    gaps."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.trainer.trainer import make_train_step

    topo, cost = sparse_model(pt, True, True)
    opt = optimizer.Adam(learning_rate=1e-3)
    params = {k: v.clone() for k, v in weights.items()}
    state = opt.init(params, sparse_catchup_for=[SPARSE_TABLE])
    n = SPARSE_LATE_STEP
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    draws = torch.randint(0, SPARSE_C, (n * SPARSE_B * SPARSE_K,),
                          device="cuda", generator=g)
    steps = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")
    s = state[SPARSE_TABLE]
    s["t0"].scatter_reduce_(0, draws, steps.repeat_interleave(
        SPARSE_B * SPARSE_K), "amax")
    drawn = (s["t0"] > 0)[:, None]
    grad = torch.randn(SPARSE_C, SPARSE_D, device="cuda", generator=g)
    s["m"] = torch.where(drawn, (1 - opt.b1) * grad, 0.0)
    s["v"] = torch.where(drawn, (1 - opt.b2) * grad * grad, 0.0)
    del grad, draws
    for k in params:
        state[k]["t"] = torch.tensor(float(n), device="cuda")
    state["__step__"] = torch.tensor(n, dtype=torch.int32)
    step = make_train_step(topo.loss_fn(cost), opt, topo.static_map())
    batches = sparse_batches(SPARSE_TIMED + 2)
    ms, rises, gaps = [], [], []
    for i, b in enumerate(batches[:-1]):
        sel = b["sel"].value
        ids = sel[sel >= 0].long().unique()
        gap = (int(state["__step__"]) - s["t0"][ids]).clamp(min=0)
        moved = s["m"][ids].ne(0).any(1)      # the rows the replay moves
        gaps.append((int(gap.max()), float(gap.float().mean()),
                     int(moved.sum()), int(gap[moved].sum())))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, c, _m = step(params, state, b)
        c = float(c)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rises.append(torch.cuda.max_memory_allocated() - base)
        s = state[SPARSE_TABLE]
        if not np.isfinite(c):
            raise SystemExit(f"late sparse Adam step: cost {c}")
    ms, rises, gaps = ms[1:], rises[1:], gaps[1:]
    print(f"  sparse Adam + t0 from step {n}: {np.median(ms):.3f} ms a step "
          f"(median of {len(ms)}: {', '.join(f'{t:.3f}' for t in ms)}), "
          f"the touched rows' gaps max {max(x[0] for x in gaps)}, mean "
          f"{np.mean([x[1] for x in gaps]):.1f}; replayed a step (the rows "
          f"with a nonzero m) {np.mean([x[2] for x in gaps]):.1f} rows, "
          f"{np.mean([x[3] for x in gaps]):.1f} steps; peak memory above "
          f"the step's inputs {max(rises) / 2 ** 20:.1f} MiB "
          f"({card_line()})", flush=True)
    if not max(rises) < SPARSE_C * SPARSE_D * 4:
        raise SystemExit(f"late sparse Adam step: peak rise {max(rises)} "
                         "bytes, a [C, D] gradient's worth")
    where_time_goes(lambda: float(step(params, state, batches[-1])[2]),
                    f"one sparse Adam + t0 step from step {n + len(ms) + 1}",
                    top=12)


def sparse_train_phase(pt):
    """Sparse-row training at tools/selfc_crossover.py's 2-D point on the
    card: the sparse step (SGD, then Adam with the t0 catch-up), the plain
    gather step (SGD, then Adam) and the dense-mask step; the sparse step
    hands the optimizer a SparseRowGrad and leaves the table's .grad None,
    its SGD parameters equal the plain gather step's, its Adam parameters
    and moments, caught up, dense Adam's over the same gradients, and its
    peak memory stays under
    a [C, D] gradient where the plain step's does not; then the same
    sparse SGD steps through SGD.train, and sparse Adam from a late
    state."""
    from paddle_tpu_torch import optimizer

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    weights = {SPARSE_TABLE: torch.randn(SPARSE_C, SPARSE_D, device="cuda",
                                         generator=g) / SPARSE_D ** 0.5,
               "_sf.wbias": torch.full((SPARSE_C,), 0.1, device="cuda")}
    batches = sparse_batches(SPARSE_CHECKED)
    table_bytes = SPARSE_C * SPARSE_D * 4
    sgd = lambda: optimizer.SGD(learning_rate=0.1)
    adam = lambda: optimizer.Adam(learning_rate=1e-3)
    runs = {}
    for label, sparse, gather, opt, catchup in (
            ("sparse", True, True, sgd(), False),
            ("plain gather", False, True, sgd(), False),
            ("dense mask", False, False, sgd(), False),
            ("sparse Adam + t0", True, True, adam(), True),
            ("plain gather Adam", False, True, adam(), False)):
        runs[label] = sparse_steps(pt, weights, sparse, gather, opt, batches,
                                   catchup)
        checked, ms, rises, kinds, leaf_grad = runs[label]
        print(f"  {label}: {np.median(ms):.3f} ms a step (median of "
              f"{len(ms)} after {SPARSE_CHECKED}: "
              f"{', '.join(f'{t:.3f}' for t in ms)}), peak "
              f"memory above the step's inputs {max(rises) / 2 ** 20:.1f} "
              f"MiB (a [C, D] gradient: {table_bytes / 2 ** 20:.0f} MiB), "
              f"the table's gradient {sorted(set(kinds))}", flush=True)
        want_sparse = label.startswith("sparse")
        if (kinds[0] == "SparseRowGrad") != want_sparse or \
                len(set(kinds)) != 1:
            raise SystemExit(f"{label}: the table's gradient was {kinds}")
        if want_sparse and (leaf_grad or max(rises) >= table_bytes):
            raise SystemExit(f"{label}: a dense table gradient (leaf .grad "
                             f"{leaf_grad}, peak rise {max(rises)} bytes)")
        if label == "plain gather" and min(rises) <= table_bytes:
            raise SystemExit("the plain gather step stayed under a [C, D] "
                             "gradient: the memory check sees nothing")
        runs[label] = checked
    sgd_runs = {k: runs[k][0] for k in ("sparse", "plain gather",
                                        "dense mask")}
    err = max(float((sgd_runs["sparse"][k]
                     - sgd_runs["plain gather"][k]).abs().max())
              for k in weights)
    dense_err = max(float((sgd_runs["sparse"][k]
                           - sgd_runs["dense mask"][k]).abs().max())
                    for k in weights)
    print(f"  SGD after {SPARSE_CHECKED} steps: max |sparse - plain gather| "
          f"= {err:.3e}, |sparse - dense mask| = {dense_err:.3e} "
          f"({card_line()})", flush=True)
    if not err <= 1e-6:
        raise SystemExit(f"the sparse and plain gather steps differ by {err}")
    sparse_adam_agrees(optimizer, runs["sparse Adam + t0"], weights)
    del runs["sparse Adam + t0"], runs["plain gather Adam"]
    # the entry point: SGD.train takes the sparse path on its own
    topo, cost = sparse_model(pt, True, True)
    params = pt.Parameters()
    for k, v in weights.items():
        params.set(k, v)
    kinds = []
    opt = sgd()
    update = opt.update
    opt.update = lambda grads, *a, **kw: (
        kinds.append(type(grads[SPARSE_TABLE]).__name__),
        update(grads, *a, **kw))[1]
    rows = [[(b["x"].value[i].cpu().numpy(),
              b["sel"].value[i].cpu().numpy().astype(np.float32),
              b["lab"].value[i].cpu().numpy()) for i in range(SPARSE_B)]
            for b in batches]
    pt.SGD(cost=cost, parameters=params, update_equation=opt,
           device="cuda").train(lambda: iter(rows), num_passes=1,
                                feeding={"x": 0, "sel": 1, "lab": 2},
                                event_handler=lambda e: None)
    err = max(float((params.get(k) - sgd_runs["sparse"][k].cpu()).abs().max())
              for k in weights)
    print(f"  SGD.train, {SPARSE_CHECKED} sparse steps: the table's "
          f"gradient {sorted(set(kinds))}, max |parameters - make_train_step"
          f"'s| = {err:.3e}", flush=True)
    if kinds != ["SparseRowGrad"] * SPARSE_CHECKED or not err <= 1e-6:
        raise SystemExit("SGD.train did not take the sparse path")
    del runs, sgd_runs, params
    sparse_adam_late(pt, weights)


# --- the CRF tagging slice -------------------------------------------------

def crf_inputs(B, T, L, lengths, seed):
    """em [T, B, L] (unit normal), mask [T, B] from ``lengths``, start, end
    and trans from a (L+2) x L CRF weight of std 0.5, on the card."""
    r = np.random.RandomState(seed)
    em = r.randn(T, B, L).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.asarray(lengths)[None, :]).astype(
        np.float32)
    w = (r.randn(L + 2, L) * 0.5).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (em, mask, w[0], w[1], w[2:])]


def crf_fwd_args(B, T, L, lengths, with_reset, seed):
    em, mask, start, _end, trans = crf_inputs(B, T, L, lengths, seed)
    return [em, mask, start, trans]


def crf_bwd_args(B, T, L, lengths, with_reset, seed):
    """The backward kernel's inputs: the forward kernel's alphas (held
    against the plain forward's first), logz and a cotangent of both
    signs."""
    from paddle_tpu_torch.kernels.crf import (_logz, crf_alphas,
                                              crf_alphas_plain)

    em, mask, start, end, trans = crf_inputs(B, T, L, lengths, seed)
    alphas = crf_alphas(em, mask, start, trans)
    want = crf_alphas_plain(em, mask, start, trans)
    err = (alphas - want).abs().max().item() / max(
        1.0, want.abs().max().item())
    if not err <= CRF_FWD_RTOL:
        raise SystemExit(f"crf_fwd's alphas disagree with the plain forward "
                         f"at B={B} T={T} L={L}: {err:.3e} relative")
    ct = torch.from_numpy(np.random.RandomState(seed + 1).randn(B).astype(
        np.float32)).cuda()
    return [em, mask, end, trans, alphas, _logz(alphas, end), ct]


def crf_betas_args(B, T, L, lengths, with_reset, seed):
    em, mask, start, end, trans = crf_inputs(B, T, L, lengths, seed)
    return [em, mask, end, trans]


def crf_marginals_args(B, T, L, lengths, with_reset, seed):
    """The marginals kernel's inputs: crf_bwd's, with the plain version's
    betas in place of end and trans."""
    from paddle_tpu_torch.kernels.crf import crf_betas_plain

    em, mask, end, trans, alphas, logz, ct = crf_bwd_args(
        B, T, L, lengths, with_reset, seed)
    return [em, mask, alphas, crf_betas_plain(em, mask, end, trans), logz,
            ct]


def crf_reduce_args(B, T, L, lengths, with_reset, seed):
    """The reduction kernel's inputs (the backward kernel's pairwise
    marginals, trans, the mask for the bound), after the whole gradient of
    crf_logz through the three kernels (d_em, d_start, d_end, d_trans) is
    held against the same Function's on the CPU, where it runs the plain
    versions."""
    from paddle_tpu_torch.kernels.crf import crf_bwd, crf_logz

    em, mask, start, end, trans = crf_inputs(B, T, L, lengths, seed)
    ct = torch.from_numpy(np.random.RandomState(seed + 1).randn(B).astype(
        np.float32))
    grads = []
    for dev in (em.device, "cpu"):
        leaves = [a.detach().to(dev, copy=True).requires_grad_(True)
                  for a in (em, start, end, trans)]
        crf_logz(leaves[0], mask.to(dev), leaves[1], leaves[2],
                 leaves[3]).backward(ct.to(dev))
        grads.append([a.grad.cpu() for a in leaves])
    limit = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
                for g, w in zip(*grads)) / CRF_BWD_RTOL
    if not limit <= 1.0:
        raise SystemExit(f"crf_logz's gradient (all three kernels) disagrees "
                         f"with the plain versions' at B={B} T={T} L={L}: "
                         f"{limit:.2f} of the limit")
    args = crf_bwd_args(B, T, L, lengths, with_reset, seed)
    return [crf_bwd(*args)[1], trans, mask]


def crf_bound(flops, reads, writes):
    """Least time for ``flops`` in float32 on the CUDA cores against
    reading each input once and writing each output once."""
    nbytes = 4.0 * sum(a.numel() for a in reads + writes)
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def tensor_core_bound(tf32_flops, f32_flops, reads, writes):
    """Least time for ``tf32_flops`` on the tensor cores in TF32 plus
    ``f32_flops`` of float32 on the CUDA cores, against reading each input
    once and writing each output once; with the peaks it used."""
    nbytes = 4.0 * sum(a.numel() for a in reads + writes)
    t_ops = (tf32_flops / TF32_FLOPS_PER_S
             + f32_flops / F32_FLOPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            f"TF32 {TF32_FLOPS_PER_S / 1e12:.0f} + float32 "
            f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s")


def valid_transitions(mask):
    """Valid (row, step) transitions t-1 -> t: the first step has none."""
    return float(mask[1:].sum().item())


def crf_fwd_bound(em, mask, start, trans):
    """The alpha step's product, 2 L^2 flops a valid transition; em, the
    mask, start and trans in, alphas out."""
    L = em.shape[2]
    return crf_bound(2.0 * L * L * valid_transitions(mask),
                     [em, mask, start, trans], [em])


def crf_bwd_bound(em, mask, end, trans, alphas, logz, ct):
    """The whole backward, both kernels: the pairwise outer product and the
    beta step's product, 4 L^2 flops a valid transition; em, alphas, the
    mask, end, trans, logz and ct in, d_em and the [B, L, L] marginals
    out."""
    B, L = em.shape[1], em.shape[2]
    return crf_bound(4.0 * L * L * valid_transitions(mask),
                     [em, alphas, mask, end, trans, logz, ct],
                     [em, em.new_empty(B, L, L)])


def crf_betas_bound(em, mask, end, trans):
    """The beta step's product, 2 L^2 flops a valid transition; em, the
    mask, end and trans in, betas out."""
    L = em.shape[2]
    return crf_bound(2.0 * L * L * valid_transitions(mask),
                     [em, mask, end, trans], [em])


def crf_marginals_bound(em, mask, alphas, betas, logz, ct):
    """The pairwise outer product, 2 L^2 flops a valid transition; em,
    alphas, betas, the mask, logz and ct in, d_em and the [B, L, L]
    marginals out."""
    B, L = em.shape[1], em.shape[2]
    return crf_bound(2.0 * L * L * valid_transitions(mask),
                     [em, alphas, betas, mask, logz, ct],
                     [em, em.new_empty(B, L, L)])


def crf_fwd_line(B, T, L, ms):
    """The forward plan's W warps a row and the kernel's us a step."""
    from paddle_tpu_torch.kernels.crf import crf_fwd_plan

    return f"W={crf_fwd_plan(B, L).W}, {ms / max(1, T - 1) * 1e3:.3f} us a step"


def crf_reduce_bound(partial, trans, mask):
    """One add a marginal; the marginals and trans in, d_trans out."""
    return crf_bound(float(partial.numel()), [partial, trans], [trans])


def crf_precision():
    """At the main paths' shape: the kernels' and the float32 plain
    versions' alphas and d_em against the plain versions in float64 (the
    float32 accuracy both share at log-domain sums of some 2000), and the
    backward's bits in two runs (no atomics: they must be equal)."""
    from paddle_tpu_torch.kernels import crf as tk

    B, T, L = CRF_REPORT
    r = np.random.RandomState(0)
    lengths = r.randint(T // 2, T + 1, size=B)
    lengths[0] = T
    em, mask, start, end, trans = crf_inputs(B, T, L, lengths, SEED)
    ct = torch.from_numpy(r.randn(B).astype(np.float32)).cuda()
    a64 = tk.crf_alphas_plain(*(x.double() for x in (em, mask, start, trans)))
    d64 = tk.crf_bwd_plain(*(x.double() for x in (em, mask, end, trans)), a64,
                           tk._logz(a64, end.double()), ct.double())[0]
    for name, alphas_fn, bwd_fn in (
            ("kernels", tk.crf_alphas, tk.crf_bwd),
            ("float32 plain", tk.crf_alphas_plain, tk.crf_bwd_plain)):
        alphas = alphas_fn(em, mask, start, trans)
        d_em = bwd_fn(em, mask, end, trans, alphas, tk._logz(alphas, end),
                      ct)[0]
        print(f"  {name} against float64 at {CRF_REPORT}: max |alphas "
              f"error| {(alphas.double() - a64).abs().max().item():.3e} "
              f"(max |alpha| {a64.abs().max().item():.1f}), max |d_em "
              f"error| {(d_em.double() - d64).abs().max().item():.3e}",
              flush=True)
    alphas = tk.crf_alphas(em, mask, start, trans)
    logz = tk._logz(alphas, end)
    runs = []
    for _ in range(2):
        d_em, partial = tk.crf_bwd(em, mask, end, trans, alphas, logz, ct)
        runs.append((d_em, partial, tk.crf_bwd_reduce(partial, trans)))
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise SystemExit("the CRF backward kernels gave other bits in a "
                         "second run")
    print("  the CRF backward kernels give the same bits in two runs",
          flush=True)


def crf_crossover():
    """The CRF's forward + backward at B=32, L=67: the crf_logz Function
    (the kernels) against the scan (autograd through the time loop), as
    the layer computes each, for each T of CROSSOVER_T."""
    from paddle_tpu_torch.layers.crf_ctc import crf_logz_kernel, crf_logz_scan

    L = CRF_LABELS
    print(f"crossover of the CRF forward + backward at B={CRF_B}, L={L} "
          f"(rows T/2..T long): ms kernels, ms scan")
    for T in CROSSOVER_T:
        r = np.random.RandomState(T)
        lengths = r.randint(T // 2, T + 1, size=CRF_B)
        lengths[0] = T
        emit = torch.from_numpy(r.randn(CRF_B, T, L).astype(
            np.float32)).cuda().requires_grad_(True)
        mask = torch.from_numpy((np.arange(T)[None] < lengths[:, None])
                                .astype(np.float32)).cuda()
        w = torch.from_numpy((r.randn(L + 2, L) * 0.5).astype(
            np.float32)).cuda().requires_grad_(True)
        ct = emit.new_ones(CRF_B)
        kernel_ms = cuda_ms(
            lambda: crf_logz_kernel(emit, mask, w).backward(ct), 20)
        scan_ms = cuda_ms(
            lambda: crf_logz_scan(emit, mask, w).backward(ct), 3)
        print(f"  T={T}: kernels {kernel_ms:.4f} ms, scan {scan_ms:.4f} ms "
              f"({scan_ms / kernel_ms:.1f}x)", flush=True)


def crf_batches(n, seed):
    """n batches of CRF_B (words, labels) rows, lengths 256..512 with one
    of 512 a batch (T=512)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = r.randint(CRF_T // 2, CRF_T + 1, size=CRF_B)
        lens[0] = CRF_T
        out.append([(r.randint(0, CRF_WORDS, size=k).tolist(),
                     r.randint(0, CRF_LABELS, size=k).tolist())
                    for k in lens])
    return out


def on_grid(weights):
    return {k: np.round(v * CRF_GRID) / CRF_GRID for k, v in weights.items()}


def training_runs(pt, kernels, cost, weights, runs, label, per_step,
                  checked, batch_shape, feeding, evaluators=None):
    """Train ``cost`` on the card through SGD.train for each (optimizer
    name, maker, batches) of ``runs``, each against the port's CPU run of
    its first ``checked`` batches: costs within TRAIN_COST_RTOL of the
    CPU's, Momentum's parameters within TRAIN_PARAM_ATOL; every step must
    launch each kernel of ``per_step`` that many times. ``evaluators``
    (a maker, or None) gives each trainer its evaluators, whose metrics are
    printed a step. ``batch_shape`` (B, T) is for the output. Returns
    each run's launch counts, the card's steps, and each run's (card, CPU)
    metrics a step."""
    B, T = batch_shape
    counts, card_steps, metrics = [], [], []
    for name, make_opt, batches in runs:
        cpu_metrics, card_metrics = [], []
        t0 = time.perf_counter()
        cpu, cpu_steps = train_run(
            pt, kernels, cost, weights, make_opt(), batches[:checked], "cpu",
            evaluators and evaluators(), cpu_metrics, feeding=feeding)
        cpu_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        card, steps = train_run(
            pt, kernels, cost, weights, make_opt(), batches, "cuda",
            evaluators and evaluators(), card_metrics, feeding=feeding)
        counts.append(dict(kernels.launches))
        card_steps.append(steps)
        metrics.append((card_metrics, cpu_metrics))
        print(f"  {label} {name}, {len(batches)} batches of {B} (T={T}); the "
              f"CPU run of the first {checked} took {cpu_s:.1f} s", flush=True)
        rtol = TRAIN_COST_RTOL[name]
        for i, (c, ms, rose) in enumerate(steps):
            ref = cpu_steps[i][0] if i < checked else None
            rel = abs(c - ref) / abs(ref) if ref is not None else None
            print(f"    step {i}: cost {c:.7f}"
                  + (f" (cpu {ref:.7f}, rel diff {rel:.3e})"
                     if ref is not None else "")
                  + "".join(f", {k} {v:.6f}"
                            + (f" (cpu {cpu_metrics[i][k]:.6f})"
                               if ref is not None else "")
                            for k, v in card_metrics[i].items())
                  + f", {ms:.3f} ms, launches "
                  + str({k: rose[k] for k in per_step}), flush=True)
            if not np.isfinite(c):
                raise SystemExit(f"{label} {name}: non-finite cost at step "
                                 f"{i}")
            if ref is not None and not rel <= rtol:
                raise SystemExit(f"{label} {name}: step {i} cost {c} vs CPU "
                                 f"{ref} (rel {rel:.3e} > {rtol})")
            if any(rose[k] != n for k, n in per_step.items()):
                raise SystemExit(f"{label} {name}: step {i} launched {rose}, "
                                 f"expected {per_step}")
        if name == "momentum":
            err, worst = max((float((card.parameters.get(k)
                                     - cpu.parameters.get(k)).abs().max()), k)
                             for k in cpu.parameters.names())
            moved = max(float(np.abs(cpu.parameters.get(k).numpy()
                                     - weights[k]).max())
                        for k in cpu.parameters.names())
            print(f"    parameters after {checked} steps: max |card - cpu| = "
                  f"{err:.3e} ({worst}); the CPU run moved them by up to "
                  f"{moved:.3e}", flush=True)
            if not err <= TRAIN_PARAM_ATOL:
                raise SystemExit(f"{label} momentum parameters differ by "
                                 f"{err} ({worst})")
    return counts, card_steps, metrics


def crf_training_runs(pt, kernels, cost, weights, runs, label):
    """``training_runs`` for a CRF tagger: every step must launch each CRF
    kernel once (and, for the rnn tagger, each GRU kernel twice)."""
    per_step = {"crf_fwd": 1, "crf_bwd": 1, "crf_bwd_marginals": 1,
                "crf_bwd_reduce": 1}
    if "gru" in label:
        per_step.update(gru_train_launches(*GRU_DW_TAGGER))
    counts, card_steps, _ = training_runs(
        pt, kernels, cost, weights, runs, label, per_step, CRF_CHECKED,
        (CRF_B, CRF_T), CRF_FEEDING)
    return counts, card_steps


def rnn_crf_phase(pt, kernels):
    """rnn_crf_tagger at full width trained on the card: Adam, then
    Momentum, each against the port's CPU run; ms per step and tokens a
    second; one step under the profiler. Returns each run's launch
    counts."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import rnn_crf_tagger
    from paddle_tpu_torch.trainer import make_train_step
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    torch.cuda.reset_peak_memory_stats()
    with layer_name_scope():
        cost = rnn_crf_tagger(**RNN_CRF)[3]
    topo = pt.Topology(cost)
    weights = random_weights(topo)
    batches = crf_batches(RNN_CRF_ADAM_STEPS, SEED + 7)
    runs = [("adam", lambda: pt.optimizer.Adam(learning_rate=1e-3), batches),
            ("momentum", lambda: pt.optimizer.Momentum(
                momentum=0.9, learning_rate=CRF_MOMENTUM_LR),
             batches[:CRF_CHECKED])]
    counts, card_steps = crf_training_runs(pt, kernels, cost, weights, runs,
                                           "rnn_crf_tagger (fused_gru)")
    step_ms = float(np.median([ms for _, ms, _ in card_steps[0][-4:]]))
    tokens = sum(len(row[0]) for row in batches[-1])
    print(f"  ms per rnn_crf_tagger Adam step (median of the last 4): "
          f"{step_ms:.3f}; {tokens / step_ms * 1e3:.1f} tokens/s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)

    optimizer = pt.optimizer.Adam(learning_rate=1e-3)
    step = make_train_step(topo.loss_fn(cost), optimizer, topo.static_map(),
                           topo.lr_mults())
    params = {k: torch.from_numpy(v).cuda() for k, v in weights.items()}
    state = optimizer.init(params)
    feeds = {k: a.to("cuda") for k, a in
             DataFeeder(topo.data_type(), CRF_FEEDING)(batches[-1]).items()}

    def one_step():
        float(step(params, state, feeds)[2])

    one_step()
    where_time_goes(one_step, f"one B={CRF_B} T={CRF_T} rnn_crf_tagger Adam "
                    "training step", top=15)
    return counts


def linear_crf_phase(pt, kernels):
    """linear_crf_tagger at full width: 4 Adam and 4 Momentum steps on the
    card against the port's CPU run; then it serves the CRF_REQUESTS
    batches through ``infer`` on its crf_decoding output, tags equal to the
    CPU run's and Viterbi scores within LOGIT_TOL. Returns the training
    runs' launch counts."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import linear_crf_tagger
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    with layer_name_scope():
        _, _, _, cost, decode = linear_crf_tagger(**LINEAR_CRF)
    topo = pt.Topology([cost, decode])
    weights = on_grid(random_weights(topo))
    batches = crf_batches(CRF_CHECKED, SEED + 8)
    runs = [("adam", lambda: pt.optimizer.Adam(learning_rate=1e-3), batches),
            ("momentum", lambda: pt.optimizer.Momentum(
                momentum=0.9, learning_rate=CRF_MOMENTUM_LR), batches)]
    counts, _ = crf_training_runs(pt, kernels, cost, weights, runs,
                                  "linear_crf_tagger")

    params = pt.Parameters.from_numpy(weights)
    on_card = pt.Inference(decode, params, device="cuda")
    on_cpu = pt.Inference(decode, params, device="cpu")
    requests = [[(words,) for words, _ in crf_batches(1, SEED + 9 + i)[0][:B]]
                for i, B in enumerate(CRF_REQUESTS)]
    for batch in requests:
        on_card.infer(batch)                  # warm-up of each shape
    torch.cuda.synchronize()
    dec_topo = pt.Topology(decode)

    def scores(inf, batch):
        feeds = {k: a.to(inf.device) for k, a in
                 DataFeeder(dec_topo.data_type())(batch).items()}
        with torch.inference_mode():
            _, ctx = dec_topo.forward(inf._params, feeds, return_ctx=True)
        return ctx.extras["crf_decode:score"].cpu().numpy()

    for batch in requests:
        t0 = time.perf_counter()
        tags = on_card.infer(batch)           # returns host numpy: synced
        ms = (time.perf_counter() - t0) * 1e3
        ref = on_cpu.infer(batch)
        c_scores, r_scores = scores(on_card, batch), scores(on_cpu, batch)
        s_err = float(np.abs(c_scores - r_scores).max())
        print(f"  request B={len(batch)}: {ms:.3f} ms on the card, "
              f"{int((tags != ref).sum())} tags differ from the CPU's, max "
              f"|score - cpu| = {s_err:.3e}", flush=True)
        if tags.shape != (len(batch), CRF_T) or tags.min() < 0 or \
                tags.max() >= CRF_LABELS:
            raise SystemExit(f"bad tags: shape {tags.shape}")
        if not np.array_equal(tags, ref):
            raise SystemExit("card and CPU Viterbi tags differ")
        if not np.isfinite(c_scores).all() or \
                not np.allclose(c_scores, r_scores, **LOGIT_TOL):
            raise SystemExit(f"card and CPU Viterbi scores differ by {s_err}")
    return counts


# --- the CTC slice ---------------------------------------------------------

def ctc_problem(B, T, S, lengths, kind, seed, C=CTC_CLASSES):
    """logits [B, T, C] and labels on the card for an S-state problem:
    U = (S-1)//2 label slots a row, row 0's labels the longest, the others
    1 up, each at most (length-1)//2 so every row can align. Labels fill
    the U slots, except for the kind "path": 1..CTC_U labels padded to U,
    as the feeder pads them, and row 1 repeating an id. The kind "labels"
    gives row 1 an empty label and row 2 one id repeated, "blank" takes
    blank = C-1. Returns (logits, labels [B, U], in_mask, label_mask,
    blank)."""
    r = np.random.RandomState(seed)
    U = (S - 1) // 2
    most = min(U, CTC_U) if kind == "path" else U
    blank = C - 1 if kind == "blank" else 0
    ids = np.asarray([c for c in range(C) if c != blank])
    labels = ids[r.randint(0, C - 1, size=(B, U))]
    ulens = np.minimum(r.randint(1, most + 1, size=B),
                       (np.asarray(lengths) - 1) // 2)
    ulens[0] = min(most, (lengths[0] - 1) // 2)
    if kind == "path" and B > 1:
        ulens[1] = max(ulens[1], min(2, (lengths[1] - 1) // 2))
        labels[1, 1] = labels[1, 0]
    if kind == "labels":
        ulens[1] = 0
        ulens[2] = min(U, (lengths[2] - 1) // 2)
        labels[2] = labels[2, 0]
    in_mask = np.arange(T)[None] < np.asarray(lengths)[:, None]
    label_mask = np.arange(U)[None] < ulens[:, None]
    logits = r.randn(B, T, C).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (
        logits, labels, in_mask.astype(np.float32),
        label_mask.astype(np.float32))] + [blank]


def ctc_inputs(B, T, S, lengths, kind, seed):
    """The kernels' inputs (em [T, B, S], mask [T, B], skip, ok,
    beta_init) built from a problem as ctc_nll_kernel builds them; an S
    above 2U+1 (even S) leaves the last state dead."""
    from paddle_tpu_torch.kernels.ctc import NEG, extended_labels

    logits, labels, in_mask, label_mask, blank = ctc_problem(
        B, T, S, lengths, kind, seed)
    U = labels.shape[1]
    ext, ok, skip, slen = extended_labels(labels, label_mask, blank,
                                          2 * U + 1)
    pad = S - (2 * U + 1)
    ext = torch.cat([ext, ext.new_full((B, pad), blank)], 1)
    ok = torch.cat([ok, ok.new_zeros(B, pad)], 1)
    skip = torch.cat([skip, skip.new_zeros(B, pad)], 1) & ok
    logp = torch.log_softmax(logits, -1)
    em = torch.gather(logp, 2, ext[:, None, :].expand(B, T, S))
    pos = torch.arange(S, device=em.device)[None, :]
    terminal = (pos == (slen - 1)[:, None]) | (
        (pos == (slen - 2)[:, None]) & (slen >= 2)[:, None])
    beta_init = torch.where(terminal, 0.0, NEG)
    return [em.transpose(0, 1).contiguous(),
            in_mask.t().contiguous(), skip.float(), ok.float(),
            beta_init.contiguous()]


def ctc_fwd_args(B, T, S, lengths, kind, seed):
    return ctc_inputs(B, T, S, lengths, kind, seed)[:4]


def ctc_bwd_args(B, T, S, lengths, kind, seed):
    """The backward kernel's inputs: the forward kernel's alphas (held
    against the plain forward's first) and ll from them."""
    from paddle_tpu_torch.kernels.ctc import (_loglik, ctc_alphas,
                                              ctc_alphas_plain)

    em, mask, skip, ok, beta_init = ctc_inputs(B, T, S, lengths, kind, seed)
    alphas = ctc_alphas(em, mask, skip, ok)
    want = ctc_alphas_plain(em, mask, skip, ok)
    err = (alphas - want).abs().max().item() / largest(want)
    if not err <= CTC_FWD_RTOL:
        raise SystemExit(f"ctc_fwd's alphas disagree with the plain forward "
                         f"at B={B} T={T} S={S}: {err:.3e} relative")
    return [em, mask, skip, ok, beta_init, alphas, _loglik(alphas, beta_init)]


def ctc_marginals_args(B, T, S, lengths, kind, seed):
    """The marginals kernel's inputs: the forward kernel's alphas and ll
    (ctc_bwd_args), the plain version's betas and a cotangent of both
    signs."""
    from paddle_tpu_torch.kernels.ctc import ctc_betas_plain

    em, mask, skip, ok, beta_init, alphas, ll = ctc_bwd_args(
        B, T, S, lengths, kind, seed)
    ct = torch.from_numpy(np.random.RandomState(seed + 1).randn(B).astype(
        np.float32)).cuda()
    return [alphas, ctc_betas_plain(em, mask, skip, ok, beta_init), mask, ll,
            ct]


def ctc_lane_line(B, T, S, ms):
    """A CTC recursion case's states a lane and us a time step."""
    from paddle_tpu_torch.kernels.ctc import ctc_states_per_lane

    return (f"N={ctc_states_per_lane(S)} states a lane, "
            f"{1e3 * ms / T:.3f} us a step")


def live_steps(mask, ok):
    """Valid (row, step) pairs times each row's live states: the states a
    run of the recursion updates."""
    return float((mask.sum(0) * ok.sum(1)).sum().item())


def ctc_fwd_bound(em, mask, skip, ok):
    """Some 14 operations a live state a valid step (three subtractions
    and exps, two adds, a log, the add of em, three maxima; each
    transcendental counted as one); em, the mask, skip and ok in, alphas
    out."""
    return crf_bound(14.0 * live_steps(mask, ok), [em, mask, skip, ok], [em])


def ctc_bwd_bound(em, mask, skip, ok, beta_init, alphas, ll):
    """Both backward kernels: the recursion's 14 operations and the
    posterior's 6 a live state a valid step; em, alphas, the mask, skip,
    ok, beta_init and ll in, d_em out."""
    return crf_bound(20.0 * live_steps(mask, ok),
                     [em, alphas, mask, skip, ok, beta_init, ll], [em])


def ctc_betas_bound(em, mask, skip, ok, beta_init):
    """The recursion's 14 operations a live state a valid step; em, the
    mask, skip, ok and beta_init in, betas out."""
    return crf_bound(14.0 * live_steps(mask, ok),
                     [em, mask, skip, ok, beta_init], [em])


def ctc_marginals_bound(alphas, betas, mask, ll, ct):
    """Some 7 operations an entry of the T B S it writes (two adds, the
    clip's two, the exp, two multiplies); alphas, betas, the mask, ll and
    ct in, d_em out."""
    return crf_bound(7.0 * alphas.numel(), [alphas, betas, mask, ll, ct],
                     [alphas])


def ctc_library_ms(B, T, S):
    """F.ctc_loss, the library call for the same NLL, at the training
    path's problem: its forward (on log_softmax output [T, B, C], the gather
    inside it) for row 8, its backward alone for row 9 (ctc_bwd's row: the
    recursion, whose posteriors are a second kernel); its values held
    against ctc_nll_kernel's (its gradient follows its own log-softmax
    convention, so it is not compared)."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.kernels.ctc import ctc_nll_kernel

    r = np.random.RandomState(0)
    lengths = np.maximum(1, r.randint(T // 4, T + 1, size=B))
    lengths[0] = T
    logits, labels, in_mask, label_mask, blank = ctc_problem(
        B, T, S, lengths, "path", SEED)
    logp = torch.log_softmax(logits, -1).transpose(0, 1).detach()
    logp.requires_grad_(True)
    in_lens, lab_lens = in_mask.sum(1).long(), label_mask.sum(1).long()

    def forward():
        return tf.ctc_loss(logp, labels, in_lens, lab_lens, blank=blank,
                           reduction="none")

    loss = forward()
    want = ctc_nll_kernel(logits, labels, in_mask, label_mask, blank)
    rel = ((loss - want).abs() / want.abs()).max().item()
    print(f"  F.ctc_loss against ctc_nll_kernel at (B, T, S) = {(B, T, S)}: "
          f"max relative difference of the NLLs {rel:.3e}", flush=True)
    if not rel <= CTC_FWD_RTOL:
        raise SystemExit(f"F.ctc_loss and ctc_nll_kernel differ by {rel:.3e}")
    fwd_ms = cuda_ms(forward, 20)
    ct = torch.ones_like(loss)
    bwd_ms = cuda_ms(lambda: loss.backward(ct, retain_graph=True), 20)
    return fwd_ms, bwd_ms


def ctc_gradient_check():
    """ctc_nll_kernel's whole gradient with respect to the logits (the
    kernels, the gather's and the log-softmax's backward) at the training
    path's problem against the same function's on the CPU, where it runs
    the plain versions, relative to its largest |value|."""
    from paddle_tpu_torch.kernels.ctc import ctc_nll_kernel

    B, T, S = CTC_REPORT
    r = np.random.RandomState(1)
    lengths = r.randint(CTC_S, T + 1, size=B)
    lengths[0] = T
    logits, labels, in_mask, label_mask, blank = ctc_problem(
        B, T, S, lengths, "path", SEED + 1)
    ct = torch.from_numpy(r.randn(B).astype(np.float32))
    grads, nlls = [], []
    for dev in ("cuda", "cpu"):
        x = logits.detach().to(dev, copy=True).requires_grad_(True)
        nll = ctc_nll_kernel(x, labels.to(dev), in_mask.to(dev),
                             label_mask.to(dev), blank)
        nll.backward(ct.to(dev))
        grads.append(x.grad.cpu())
        nlls.append(nll.detach().cpu())
    g_err = (grads[0] - grads[1]).abs().max().item() / largest(grads[1])
    n_err = ((nlls[0] - nlls[1]).abs() / nlls[1].abs()).max().item()
    print(f"  ctc_nll_kernel on the card against the CPU at {CTC_REPORT}: "
          f"NLL max relative difference {n_err:.3e}, gradient {g_err:.3e} "
          f"of its largest value", flush=True)
    if not (n_err <= CTC_FWD_RTOL and g_err <= CTC_BWD_RTOL):
        raise SystemExit(f"ctc_nll_kernel's NLL or gradient differs from "
                         f"the CPU's: {n_err:.3e}, {g_err:.3e}")


def ctc_crossover():
    """The CTC's forward + backward at B=32, C=128, U=20 (input lengths
    2U+1..T, as tools/ctc_bench.py bench_ctc): ctc_nll_kernel (the
    kernels) against the scan (autograd through the time loop) and
    F.ctc_loss, each from the logits, for each T of CTC_CROSSOVER_T."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.kernels.ctc import ctc_nll_kernel
    from paddle_tpu_torch.layers.crf_ctc import ctc_nll

    print(f"crossover of the CTC forward + backward at B={CTC_B}, "
          f"C={CTC_CLASSES}, U={CTC_U} (rows {CTC_S}..T long): ms kernels, "
          f"ms scan, ms F.ctc_loss")
    for T in CTC_CROSSOVER_T:
        r = np.random.RandomState(T)
        lengths = r.randint(CTC_S, T + 1, size=CTC_B)
        logits, labels, in_mask, label_mask, blank = ctc_problem(
            CTC_B, T, CTC_S, lengths, "ragged", T)
        label_mask = torch.ones_like(label_mask)
        x = logits.requires_grad_(True)
        ct = torch.ones(CTC_B, device=x.device)
        in_lens, lab_lens = in_mask.sum(1).long(), label_mask.sum(1).long()

        def library():
            tf.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1), labels,
                        in_lens, lab_lens, blank=blank,
                        reduction="none").backward(ct)

        kernel_ms = cuda_ms(lambda: ctc_nll_kernel(
            x, labels, in_mask, label_mask, blank).backward(ct), 20)
        scan_ms = cuda_ms(lambda: ctc_nll(
            x, labels, in_mask, label_mask, blank).backward(ct), 2)
        library_ms = cuda_ms(library, 20)
        print(f"  T={T}: kernels {kernel_ms:.4f} ms, scan {scan_ms:.4f} ms "
              f"({scan_ms / kernel_ms:.1f}x), F.ctc_loss {library_ms:.4f} ms "
              f"({library_ms / kernel_ms:.2f}x)", flush=True)


def ctc_batches(n, seed, repeat_row):
    """n batches of CTC_B (frames [len, 161] numpy on the 1/32 grid,
    labels) rows: frames 41..512 with one of 512 a batch, labels 1..20
    long with one of 20 a batch, ids 1..127; row ``repeat_row`` of every
    batch repeats an id, so the skip rule runs."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = r.randint(CTC_S, CTC_T + 1, size=CTC_B)
        lens[0] = CTC_T
        ulens = r.randint(1, CTC_U + 1, size=CTC_B)
        ulens[0] = CTC_U
        rows = []
        for i, (k, u) in enumerate(zip(lens, ulens)):
            lab = r.randint(1, CTC_CLASSES, size=u).tolist()
            if i == repeat_row:
                lab[:2] = [lab[0], lab[0]] if u >= 2 else lab[:1]
            frames = np.round(r.randn(k, CTC_FEATURES) * CRF_GRID) / CRF_GRID
            rows.append((frames.astype(np.float32), lab))
        out.append(rows)
    return out


def ctc_phase(pt, kernels):
    """The CTC model (161 -> fc 128 -> warp_ctc, a ctc_error evaluator on
    the fc output) trained on the card through SGD.train with CTC_IMPL =
    "kernel": Adam, then Momentum, each against the port's CPU run of its
    first CTC_CHECKED batches (costs; the first step's ctc_error equal;
    Momentum's parameters); every step must launch each CTC kernel once.
    ms per step and frames a second; one step under the profiler. Returns
    each run's launch counts."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.layers import crf_ctc
    from paddle_tpu_torch.trainer import make_train_step
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    torch.cuda.reset_peak_memory_stats()
    with layer_name_scope():
        frames = pt.layer.data(
            name="frames",
            type=pt.data_type.dense_vector_sequence(CTC_FEATURES))
        labels = pt.layer.data(
            name="labels",
            type=pt.data_type.integer_value_sequence(CTC_CLASSES))
        out = pt.layer.fc(input=frames, size=CTC_CLASSES,
                          act=pt.activation.Linear())
        cost = pt.layer.warp_ctc(input=out, label=labels, size=CTC_CLASSES,
                                 blank=0)
    topo = pt.Topology(cost)
    # on the 1/32 grid, as the features: the fc logits are then exact in
    # float32 in any order, so the first step decodes equally everywhere
    weights = on_grid(random_weights(topo))
    adam_batches = ctc_batches(CTC_ADAM_STEPS, SEED + 10, repeat_row=3)
    runs = [("adam", lambda: pt.optimizer.Adam(learning_rate=1e-3),
             adam_batches),
            ("momentum", lambda: pt.optimizer.Momentum(
                momentum=0.9, learning_rate=CTC_MOMENTUM_LR),
             ctc_batches(CTC_CHECKED, SEED + 11, repeat_row=5))]
    old_impl = crf_ctc.CTC_IMPL
    crf_ctc.CTC_IMPL = "kernel"
    try:
        counts, card_steps, metrics = training_runs(
            pt, kernels, cost, weights, runs, "ctc",
            {"ctc_fwd": 1, "ctc_bwd": 1, "ctc_bwd_marginals": 1},
            CTC_CHECKED, (CTC_B, CTC_T), CTC_FEEDING,
            lambda: {"cer": pt.evaluator.ctc_error(input=out,
                                                   label="labels")})
    finally:
        crf_ctc.CTC_IMPL = old_impl
    for (name, _, _), (card_metrics, cpu_metrics) in zip(runs, metrics):
        card_cer, cpu_cer = card_metrics[0]["cer"], cpu_metrics[0]["cer"]
        if card_cer != cpu_cer:
            raise SystemExit(f"ctc {name}: the first step's ctc_error "
                             f"{card_cer} differs from the CPU's {cpu_cer}")
    adam_steps = card_steps[0]
    step_ms = float(np.median([ms for _, ms, _ in adam_steps[-4:]]))
    n_frames = sum(len(row[0]) for row in adam_batches[-1])
    print(f"  ms per CTC Adam step (median of the last 4): {step_ms:.3f}; "
          f"{n_frames / step_ms * 1e3:.1f} frames/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)

    optimizer = pt.optimizer.Adam(learning_rate=1e-3)
    step = make_train_step(topo.loss_fn(cost), optimizer, topo.static_map(),
                           topo.lr_mults())
    params = {k: torch.from_numpy(v).cuda() for k, v in weights.items()}
    state = optimizer.init(params)
    feeds = {k: a.to("cuda") for k, a in
             DataFeeder(topo.data_type(), CTC_FEEDING)(
                 adam_batches[-1]).items()}

    def one_step():
        float(step(params, state, feeds)[2])

    crf_ctc.CTC_IMPL = "kernel"
    try:
        one_step()
        where_time_goes(one_step, f"one B={CTC_B} T={CTC_T} CTC Adam "
                        "training step (without the evaluator)", top=12)
    finally:
        crf_ctc.CTC_IMPL = old_impl
    return counts


# --- the library kernels ---------------------------------------------------

def xent_inputs(N, D, V, kind, seed):
    """x randn [N, D], w randn / sqrt(D) [D, V] (bench_nmt's output layer
    scale: logits near N(0, 1)), b randn * 0.1, labels uniform in [0, V)
    (int64) and the cotangent ct randn [N], on the card. The kind "labels
    out of range" gives rows 0..2 the labels -1, V and V + 5; "bias 100"
    every 97th column a bias of 100."""
    r = np.random.RandomState(seed)
    x = r.randn(N, D).astype(np.float32)
    w = (r.randn(D, V) / np.sqrt(D)).astype(np.float32)
    b = (r.randn(V) * 0.1).astype(np.float32)
    labels = r.randint(0, V, N)
    ct = r.randn(N).astype(np.float32)
    if kind == "labels out of range":
        labels[:3] = [-1, V, V + 5]
    if kind == "bias 100":
        b[::97] = 100.0
    return [torch.from_numpy(a).cuda() for a in (x, w, b, labels, ct)]


def xent_kernels(x, w, b, lab, ct, timed):
    """Each vocab_xent kernel as (name, kernel call, plain call, bound,
    library call or None), on these inputs: the kernels after the first
    take the plain forward's lse and the kernel outputs before them. The
    forward's partials are three outputs (max, sumexp, gold), each held
    relative to its own scale. The library calls are made only when
    ``timed`` (every label then in range)."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.kernels import vocab_xent as tv

    N, D = x.shape
    V = w.shape[1]
    S_fwd, S_dx = tv.fwd_slices(x, w), tv.dx_slices(x, w)
    # the sum's input: at least 2 slices, so that the sum is held and
    # timed also where the wrapper takes 1 slice and no sum
    S_sum = min(max(2, S_dx), -(-V // 128))
    lse = tv.vocab_xent_plain(x, w, b, lab)[1]
    part = tv.vocab_xent_fwd_partials(x, w, b, lab, S_fwd)
    dx_part = tv.vocab_xent_bwd_dx_partials(x, w, b, lab, lse, ct, S_sum)
    nv, row = float(N * V), [lab, ct]
    # the slices' log-sums, for the combine's library call: lse is their
    # logsumexp (nll subtracts the gold logit besides)
    log_sums = part[0] + torch.log(part[1]) if timed else None
    # the library's own gradient of the logits, for its dx and dW products
    dlogits = None
    if timed:
        logits = (x @ w + b).requires_grad_(True)
        dlogits = torch.autograd.grad(tf.cross_entropy(
            logits, lab, reduction="none"), logits, ct)[0]
        del logits
    # 2NDV for a product; some 4 operations a logit (bias, max, exp, sum)
    # and 5 for dlog (bias, exp, subtract, one-hot, multiply), 6 where db
    # adds it too.
    # every kernel runs its products on the tensor cores in three TF32
    # passes (the forward one product, dx and dW/db two each), the rest on
    # the CUDA cores
    return [
        ("vocab_xent_fwd",
         lambda: list(tv.vocab_xent_fwd_partials(x, w, b, lab, S_fwd)),
         lambda: list(tv.vocab_xent_fwd_partials_plain(x, w, b, lab, S_fwd)),
         tensor_core_bound(3 * 2.0 * N * D * V, 4 * nv, [x, w, b] + row[:1],
                           [part]),
         lambda: tf.cross_entropy(x @ w + b, lab, reduction="none")),
        ("vocab_xent_fwd_reduce",
         lambda: list(tv.vocab_xent_fwd_reduce(part)),
         lambda: list(tv.vocab_xent_fwd_reduce_plain(part)),
         crf_bound(6.0 * part[0].numel(), [part], [lse, lse]),
         lambda: torch.logsumexp(log_sums, 0)),
        ("vocab_xent_bwd_dx",
         lambda: [tv.vocab_xent_bwd_dx_partials(x, w, b, lab, lse, ct, S_dx)],
         lambda: [tv.vocab_xent_bwd_dx_partials_plain(x, w, b, lab, lse, ct,
                                                      S_dx)],
         tensor_core_bound(3 * 4.0 * N * D * V, 5 * nv, [x, w, b, lse] + row,
                           [x] * S_dx),
         lambda: dlogits @ w.T),
        ("vocab_xent_bwd_dx_reduce",
         lambda: [tv.vocab_xent_bwd_dx_reduce(dx_part)],
         lambda: [tv.vocab_xent_bwd_dx_reduce_plain(dx_part)],
         crf_bound(float(dx_part.numel()), [dx_part], [x]),
         lambda: dx_part.sum(0)),
        ("vocab_xent_bwd_dw",
         lambda: list(tv.vocab_xent_bwd_dw(x, w, b, lab, lse, ct)),
         lambda: list(tv.vocab_xent_bwd_dw_plain(x, w, b, lab, lse, ct)),
         tensor_core_bound(3 * 4.0 * N * D * V, 6 * nv, [x, w, b, lse] + row,
                           [w, b]),
         lambda: (x.T @ dlogits, dlogits.sum(0))),
    ]


def xent_dlog(x, w, b, lab, lse, ct):
    """The logits' gradient as PyTorch calls: x @ w + b, then the softmax
    gradient (exp(logits - lse) - onehot) * ct in place."""
    V = w.shape[1]
    dlog = torch.addmm(b, x, w).sub_(lse[:, None]).exp_()
    inside = ((lab >= 0) & (lab < V)).to(dlog.dtype)
    dlog.scatter_add_(1, lab.clamp(0, V - 1)[:, None], -inside[:, None])
    return dlog.mul_(ct[:, None])


# the tensor-core kernels' whole functions as PyTorch calls after
# xent_dlog, and the kernel's outputs in the same form (dx's partials
# summed)
XENT_COMPOSITES = {
    "vocab_xent_bwd_dx": ("dlog @ w.T", "dlog @ w.T",
                          lambda x, w, dlog: [dlog @ w.T],
                          lambda got: [got[0].sum(0)]),
    "vocab_xent_bwd_dw": ("x.T @ dlog, the sum", "x.T @ dlogits + sum",
                          lambda x, w, dlog: [x.T @ dlog, dlog.sum(0)],
                          lambda got: got),
}


def xent_library_check(x, w, b, lab):
    """vocab_xent's NLLs (the kernels) against F.cross_entropy of the
    materialized logits on the rows whose label is in range, and the
    composite (nll, lse) against the plain forward; the largest
    difference."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.kernels import vocab_xent as tv

    nll, lse = tv.vocab_xent_fwd(x, w, b, lab)
    want_nll, want_lse = tv.vocab_xent_plain(x, w, b, lab)
    inside = (lab >= 0) & (lab < w.shape[1])
    lib = tf.cross_entropy(x[inside] @ w + b, lab[inside], reduction="none")
    return max((nll - want_nll).abs().max().item(),
               (lse - want_lse).abs().max().item(),
               (nll[inside] - lib).abs().max().item())


def xent_tensor_core_extras(name, x, w, b, lab, ct, got, fn, library_ms):
    """At XENT_REPORT, for a tensor-core kernel: a second launch bit for
    bit equal to the first (``got``), and the PyTorch composite of its
    function (XENT_COMPOSITES) timed beside the one-call yardstick and
    held against the kernel."""
    from paddle_tpu_torch.kernels import vocab_xent as tv

    again = fn()
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise SystemExit(f"two launches of {name} at {XENT_REPORT} differ")
    what, yardstick, products, outputs = XENT_COMPOSITES[name]
    lse = tv.vocab_xent_plain(x, w, b, lab)[1]

    def composite():
        return products(x, w, xent_dlog(x, w, b, lab, lse, ct))

    comp = composite()
    err = max((c - g).abs().max().item() / largest(c)
              for c, g in zip(comp, outputs(got)))
    del comp
    comp_ms = cuda_ms(composite, 5)
    print(f"  {name}: two launches bit for bit equal; its function as "
          f"PyTorch calls (x @ w + b, the softmax gradient, {what}) "
          f"{comp_ms:.4f} ms, within {err:.2e} of its largest value; the "
          f"one-call yardstick ({yardstick}) {library_ms:.4f} ms",
          flush=True)
    if not err <= KERNEL_BWD_RTOL:
        raise SystemExit(f"{name} differs from the PyTorch composite by "
                         f"{err:.3e} of its largest value")


def xent_phase(kernels):
    """vocab_xent's five kernels against their plain versions at
    XENT_CASES (timed at XENT_REPORT, with the library calls, for the
    kernel rows; the tensor-core kernels' two launches bit-equal and their
    PyTorch composites; timed at XENT_SLICED too, the second main path's
    inputs, and printed), the composite against F.cross_entropy; then the
    main paths (xent_main_path) at XENT_REPORT and XENT_SLICED. Returns
    the kernel rows and the main paths' launch counts, summed."""
    from paddle_tpu_torch.kernels import vocab_xent as tv

    print("kernels vocab_xent_* vs their plain versions (pass: partials, "
          f"dx, dW and db within {KERNEL_BWD_RTOL} x max(1, max|plain|) per "
          f"output; nll and lse within {KERNEL_ATOL}, also against "
          "F.cross_entropy on in-range rows)")
    rows = {}
    for i, (N, D, V, kind) in enumerate(XENT_CASES):
        x, w, b, lab, ct = xent_inputs(N, D, V, kind, SEED + i)
        errs = []
        timed = (N, D, V) == XENT_REPORT
        sliced = (N, D, V) == XENT_SLICED
        for name, fn, plain, bound, library in xent_kernels(
                x, w, b, lab, ct, timed or sliced):
            got = fn()
            torch.cuda.synchronize()
            want = plain()
            diffs = [(g - p).abs().max().item() for g, p in zip(got, want)]
            if name == "vocab_xent_fwd_reduce":
                limit = max(diffs) / KERNEL_ATOL
            else:
                limit = max(d / largest(p) / KERNEL_BWD_RTOL
                            for d, p in zip(diffs, want))
            if not (np.isfinite(max(diffs)) and limit <= 1.0):
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"at (N, D, V) = {(N, D, V)} {kind}: "
                                 f"{diffs}")
            if name == "vocab_xent_bwd_dx_reduce" and not torch.equal(
                    got[0], want[0]):
                raise SystemExit(f"{name} is not bit-equal to its plain "
                                 f"version at (N, D, V) = {(N, D, V)} "
                                 f"{kind}")
            errs.append(f"{name[11:]} {max(diffs):.2e}")
            if timed or sliced:
                meas = dict(
                    max_abs_err=max(diffs), ms=cuda_ms(fn, 10),
                    plain_ms=cuda_ms(plain, 3), bound_ms=bound[0],
                    bound_by=bound[1],
                    library_ms=cuda_ms(library, 10) if library else None)
                # the dx sum's row is its path's, XENT_SLICED (16
                # slices); the other kernels' XENT_REPORT
                if sliced if name == "vocab_xent_bwd_dx_reduce" else timed:
                    rows[name] = meas
            if timed:
                peaks = bound[2] if len(bound) > 2 else \
                    f"float32 {F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s"
                print(f"  {name} at {XENT_REPORT}: ms={meas['ms']:.4f} "
                      f"plain_ms={meas['plain_ms']:.4f} bound_ms="
                      f"{bound[0]:.4f} ({bound[1]}, {peaks}) library_ms="
                      f"{meas['library_ms']}", flush=True)
            if sliced:
                print(f"  {name} at the second main path's {XENT_SLICED} "
                      f"({tv.dx_slices(x, w)} dx slices; the sum on all of "
                      f"them): ms={meas['ms']:.4f} plain_ms="
                      f"{meas['plain_ms']:.4f} bound_ms={bound[0]:.4f} "
                      f"({bound[1]}) library_ms={meas['library_ms']}",
                      flush=True)
            if timed and name in XENT_COMPOSITES:
                xent_tensor_core_extras(name, x, w, b, lab, ct, got, fn,
                                        meas["library_ms"])
            if (timed or sliced) and name == "vocab_xent_fwd":
                again = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    raise SystemExit(f"two launches of {name} at "
                                     f"{(N, D, V)} differ")
                print(f"  {name} at {(N, D, V)}: {tv.fwd_slices(x, w)} "
                      f"slices; two launches bit for bit equal", flush=True)
                del again
            del got, want
        lib_err = xent_library_check(x, w, b, lab)
        if not lib_err <= KERNEL_ATOL:
            raise SystemExit(f"vocab_xent's nll or lse at {(N, D, V)} {kind} "
                             f"differs from the plain version's or "
                             f"F.cross_entropy's by {lib_err}")
        print(f"  (N, D, V) = {(N, D, V)} {kind}: max_abs_err "
              + ", ".join(errs) + f"; nll vs plain and F.cross_entropy "
              f"{lib_err:.2e} ok", flush=True)
        del x, w, b, lab, ct

    # the main paths: the public function's forward + backward, once at
    # each shape; their launches summed
    counts = {name: 0 for name in rows}
    for shape in (XENT_REPORT, XENT_SLICED):
        for name, n in xent_main_path(kernels, shape).items():
            counts[name] += n
    return rows, counts


def xent_main_path(kernels, shape):
    """vocab_xent's forward + backward through autograd at ``shape``: its
    launches (each kernel once, the dx sum once where dx takes more than
    one slice and never else), its gradients against the library path's,
    its extra peak memory (held under XENT_MEMORY_SHARE of the logits at
    XENT_REPORT), and both timed. Returns the launch counts."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.kernels import vocab_xent as tv

    x, w, b, lab, ct = xent_inputs(*shape, "report", SEED)
    xs = [a.requires_grad_(True) for a in (x, w, b)]
    logits_bytes = 4 * shape[0] * shape[2]
    S = tv.dx_slices(x, w)
    want = {name: 1 for name in XENT_KERNELS}
    want["vocab_xent_bwd_dx_reduce"] = int(S > 1)

    def extra_peak(loss_fn):
        """Peak device memory of loss_fn's forward + backward less what
        was allocated before it and the loss, per-row losses and
        gradients it leaves."""
        for a in xs:
            a.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        per_row = loss_fn()
        (per_row * ct).sum().backward()
        torch.cuda.synchronize()
        kept = 4 * (2 * per_row.numel() + sum(a.grad.numel() for a in xs))
        return torch.cuda.max_memory_allocated() - base - kept

    def library_loss():
        return tf.cross_entropy(xs[0] @ xs[1] + xs[2], lab, reduction="none")

    kernels.reset_launch_counts()
    extra = extra_peak(lambda: tv.vocab_xent(*xs, lab))
    counts = {name: kernels.launches[name] for name in want}
    grads = [a.grad.clone() for a in xs]
    library_extra = extra_peak(library_loss)
    g_err = max((g - a.grad).abs().max().item() / largest(a.grad)
                for g, a in zip(grads, xs))
    print(f"  main path: vocab_xent forward + backward at {shape}, {S} dx "
          f"slice(s): launches {counts}; extra peak device memory "
          f"{extra / 2**20:.1f} MiB ({extra / logits_bytes:.3f} of the "
          f"{logits_bytes / 2**20:.1f} MiB [N, V] logits; the library "
          f"path's {library_extra / 2**20:.1f} MiB); gradients within "
          f"{g_err:.2e} of the library path's largest", flush=True)
    if counts != want:
        raise SystemExit(f"vocab_xent's forward + backward at {shape} "
                         f"launched {counts}, not {want}")
    if shape == XENT_SLICED and S == 1:
        raise SystemExit(f"dx takes one slice at {shape}: its sum is not "
                         "on a path")
    if shape == XENT_REPORT and not extra <= XENT_MEMORY_SHARE * logits_bytes:
        raise SystemExit(f"vocab_xent's forward + backward took {extra} "
                         f"bytes beyond its inputs and outputs")
    if not g_err <= KERNEL_BWD_RTOL:
        raise SystemExit(f"vocab_xent's gradients differ from the library "
                         f"path's by {g_err:.3e} of their largest value")
    kernel_ms = cuda_ms(lambda: torch.autograd.grad(
        tv.vocab_xent(*xs, lab), xs, ct), 5)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        library_loss(), xs, ct), 5)
    print(f"  forward + backward at {shape}: kernels {kernel_ms:.4f} "
          f"ms, matmul + F.cross_entropy {library_ms:.4f} ms "
          f"({library_ms / kernel_ms:.2f}x)", flush=True)
    return counts


def pool_inputs(B, H, W, C, kind, seed):
    """x [B, H, W, C] randn (or on the grid 0..3 for "ties", so most
    windows tie; one NaN for "nan"; for "misaligned" a view that starts
    one float into its buffer) and dy [B, H/2, W/2, C], drawn on the card
    from a generator seeded with ``seed`` (the report shape's 257 M values
    would take numpy seconds)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randint(0, 4, (B, H, W, C), generator=gen, device="cuda")
         .float() if kind == "ties"
         else torch.randn(B, H, W, C, generator=gen, device="cuda"))
    if kind == "nan":
        x[0, 3, 4, 1] = float("nan")
    if kind == "misaligned":
        buf = torch.empty(x.numel() + 1, device="cuda")
        x = buf[1:].view(B, H, W, C).copy_(x)
    dy = torch.randn(B, H // 2, W // 2, C, generator=gen, device="cuda")
    return x, dy


def copy_floor():
    """fn(x, dy) -> dx of the copy floor kernel (csrc/pool_copy_floor.cu,
    built beside the kernels): dx = x, plus dy over dy's first floats."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    fn = _build.load("pool_copy_floor").pool_copy_floor
    P, L = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [P, P, P, L, L, P]
    fn.restype = ctypes.c_int

    def run(x, dy):
        dx = torch.empty_like(x)
        err = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.numel(),
                 dy.numel(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"pool_copy_floor: launch failed: CUDA error "
                             f"{err}")
        return dx
    return run


def pool_phase(kernels):
    """maxpool_bwd against its plain version, bit for bit (the kernel sums
    each position's <= 4 terms in the plain version's order), at
    POOL_CASES, each with the plan the wrapper launched; timed at
    POOL_REPORT beside the thread kernel forced there, the copy floor
    (csrc/pool_copy_floor.cu: x and dy read and dx written once, in
    16-byte vectors) and max_pool2d's backward on the channels_last view
    as the yardstick (its tie rule differs: first argmax); then the main
    path: maxpool_3x3s2p1's forward + backward through autograd at
    POOL_REPORT, its launch and gradient. Returns the kernel row and the
    main path's launch count."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.kernels import pool as tp

    print("kernel maxpool_bwd vs maxpool_3x3s2p1_bwd_plain (pass: equal bit "
          "for bit)")
    row = None
    for i, (B, H, W, C, kind) in enumerate(POOL_CASES):
        x, dy = pool_inputs(B, H, W, C, kind, SEED + i)
        tp.last_plan = None
        got = tp.maxpool_3x3s2p1_bwd(x, dy)
        torch.cuda.synchronize()
        plan = tp.last_plan                  # the plan the wrapper launched
        want = tp.maxpool_3x3s2p1_bwd_plain(x, dy)
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise SystemExit(f"maxpool_bwd differs from its plain version at "
                             f"{(B, H, W, C)} {kind}: {err}")
        expected = (tp.THREAD if kind == "misaligned" or C % 4 != 0
                    else tp.STRIP)
        if plan != expected:
            raise SystemExit(f"maxpool_bwd launched plan {plan} at "
                             f"{(B, H, W, C)} {kind}, expected {expected}")
        line = (f"  {(B, H, W, C)} {kind}: plan {plan} ("
                + ("the strip kernel" if plan == tp.STRIP else
                   "the thread kernel") + f"), max_abs_err={err:.3e} equal")
        if (B, H, W, C) != POOL_REPORT:
            # the forward (max_pool2d on the card) against the CPU's, NaN
            # where the CPU has NaN
            if not np.array_equal(tp.maxpool_3x3s2p1_fwd(x).cpu().numpy(),
                                  tp.maxpool_3x3s2p1_fwd(x.cpu()).numpy(),
                                  equal_nan=True):
                raise SystemExit(f"maxpool_3x3s2p1's forward on the card "
                                 f"differs from the CPU's at {(B, H, W, C)}")
            line += ", forward equal to the CPU's"
        if (B, H, W, C) == POOL_REPORT:
            thread = tp.maxpool_3x3s2p1_bwd(x, dy, plan=tp.THREAD)
            if not torch.equal(thread, want):
                raise SystemExit("the thread kernel differs from the plain "
                                 f"version at {POOL_REPORT}")
            del thread
            run_floor = copy_floor()
            dx = run_floor(x, dy)
            n = dy.numel()
            if not (torch.equal(dx.view(-1)[n:], x.view(-1)[n:]) and
                    torch.equal(dx.view(-1)[:n], x.view(-1)[:n]
                                + dy.view(-1))):
                raise SystemExit("the copy floor kernel did not copy")
            del dx
            xl = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
            y = tf.max_pool2d(xl, kernel_size=3, stride=2, padding=1)
            gl = dy.permute(0, 3, 1, 2)
            bound = crf_bound(0.0, [x, dy], [x])
            row = dict(max_abs_err=err,
                       ms=cuda_ms(lambda: tp.maxpool_3x3s2p1_bwd(x, dy), 20),
                       plain_ms=cuda_ms(
                           lambda: tp.maxpool_3x3s2p1_bwd_plain(x, dy), 3),
                       bound_ms=bound[0], bound_by=bound[1],
                       library_ms=cuda_ms(lambda: torch.autograd.grad(
                           y, xl, gl, retain_graph=True), 20))
            thread_ms = cuda_ms(
                lambda: tp.maxpool_3x3s2p1_bwd(x, dy, plan=tp.THREAD), 20)
            floor_ms = cuda_ms(lambda: run_floor(x, dy), 20)
            line += (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                     f"bound_ms={bound[0]:.4f} ({bound[1]}); the thread "
                     f"kernel {thread_ms:.4f} ms; the copy floor "
                     f"{floor_ms:.4f} ms; max_pool2d backward "
                     f"(channels_last) {row['library_ms']:.4f} ms")
            del xl, y, gl
        print(line, flush=True)

    x, dy = pool_inputs(*POOL_REPORT, "randn", SEED)
    want = tp.maxpool_3x3s2p1_bwd_plain(x, dy)
    x.requires_grad_(True)
    tp.last_plan = None
    kernels.reset_launch_counts()
    tp.maxpool_3x3s2p1(x).backward(dy)
    torch.cuda.synchronize()
    count = kernels.launches["maxpool_bwd"]
    print(f"  main path: maxpool_3x3s2p1 forward + backward at {POOL_REPORT}"
          f": maxpool_bwd launched {count}x in plan {tp.last_plan}, gradient "
          f"equal to the plain version's: {torch.equal(x.grad, want)}",
          flush=True)
    if (count != 1 or tp.last_plan != tp.STRIP
            or not torch.equal(x.grad, want)):
        raise SystemExit("maxpool_3x3s2p1's backward did not go once "
                         "through maxpool_bwd's strip kernel to the plain "
                         "version's answer")
    return row, count


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.gru import (fused_gru_bwd_dw,
                                              fused_gru_bwd_plain,
                                              fused_gru_fwd, fused_gru_plain,
                                              gru_dw_db_plain, grid_plan)
    from paddle_tpu_torch.kernels.crf import (crf_alphas, crf_alphas_plain,
                                              crf_betas, crf_betas_plain,
                                              crf_bwd, crf_bwd_plain,
                                              crf_bwd_reduce, crf_dtrans_plain,
                                              crf_marginals,
                                              crf_marginals_plain)
    from paddle_tpu_torch.kernels.ctc import (ctc_alphas, ctc_alphas_plain,
                                              ctc_betas, ctc_betas_plain,
                                              ctc_bwd, ctc_bwd_plain,
                                              ctc_marginals,
                                              ctc_marginals_plain)
    from paddle_tpu_torch.kernels.lstm import (fused_lstm, fused_lstm_fwd,
                                               fused_lstm_plain,
                                               lstm_dw_splits)
    from paddle_tpu_torch.trainer.feeder import _bucket

    if CTC_PATH_S != 2 * _bucket(CTC_U, True) + 1:
        raise SystemExit(f"the feeder pads {CTC_U} labels to "
                         f"{_bucket(CTC_U, True)}: CTC_PATH_S is stale")

    # phase 1: the card and the build
    start = time.perf_counter()
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    # the kernels and the pool backward's copy floor, a yardstick
    _build.build([*kernels.SOURCES, "pool_copy_floor"])
    print(f"built {list(kernels.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in kernels.SOURCES:
        log = _build.library_path(name).with_suffix(".log").read_text()
        # ptxas's report of each entry function: its name, then its stack
        # frame and spills, then its registers
        parts = re.split(r"Compiling entry function '([^']+)'", log)
        for i in range(1, len(parts), 2):
            lines = [line.split("ptxas info    :")[-1].strip()
                     for line in parts[i + 1].splitlines()
                     if "registers" in line or "spill" in line]
            print(f"  {name} {parts[i]}: {'; '.join(lines)}")
    tensor_core_build_check()

    # phase 2: kernels against their plain versions
    from paddle_tpu_torch.kernels.lstm import (fused_lstm_bwd,
                                               fused_lstm_bwd_nodw,
                                               fused_lstm_bwd_plain,
                                               lstm_dw_partials,
                                               lstm_dw_partials_plain,
                                               lstm_dw_reduce,
                                               lstm_dw_reduce_plain,
                                               split_dw_db)

    lstm_reqs, lstm_shapes = lstm_requests(_bucket)
    nested_reqs = nested_requests()
    # the nested path's two lstms run (B, T) of the flattened paragraphs
    nested_shapes = [(len(b), _bucket(max(sum(map(len, p)) for p, in b),
                                      True)) for b in nested_reqs]
    nmt_reqs, nmt_shapes = nmt_requests(_bucket)
    batches = train_batches()
    train_shapes = sorted({(len(b), _bucket(max(len(s[0]) for s in b), True))
                           for b in batches})
    # the NMT training path's encoder shapes: the checked runs' ragged
    # batches (T=32) and bench_nmt's (256, 30), every step valid
    nmt_train_shapes = [(NMT_TRAIN_B, _bucket(NMT_BENCH_T, True)),
                        (NMT_BENCH_B, NMT_BENCH_T, "full")]
    # the packing-ready NMT model's three GRUs (phase 6c): the (B, T) of its
    # requests and training batches, encoder and decoder, less those above
    stream = packed_stream()
    known = {tuple(sh[:2]) for sh in nmt_train_shapes} | set(nmt_shapes)
    packed_train_shapes = sorted(set(packed_shapes(
        [stream[i:i + PACKED_TRAIN_B] for i in range(0, PACKED_B,
                                                      PACKED_TRAIN_B)]
        + [stream], _bucket)) - known)
    packed_serve_shapes = sorted(
        set(packed_shapes(packed_requests(stream), _bucket)) - known
        - set(packed_train_shapes))
    # the dW kernel's cases: the recurrent kernels' three, the NMT training
    # path's, and the RNN CRF tagger's width with bench_crf's rows and with
    # resets
    gru_dw_cases = [GRU_DW_REPORT + ("ragged",), (5, 37, 128, "reset"),
                    (1, 100, 512, "full")] + [
        (sh[0], sh[1], 512, sh[2] if len(sh) > 2 else "main path")
        for sh in nmt_train_shapes] + [GRU_DW_TAGGER + ("documents",),
                                       GRU_DW_TAGGER + ("reset",)] + [
        sh + (512, "main path") for sh in packed_train_shapes]
    # the backward's grid kernel: the recurrent kernels' three cases, the
    # NMT training path's, the tagger's shape, and H = 644, where H/4 blocks
    # co-reside only two an SM (at most 128 registers a thread)
    gru_bwd_grid_cases = [(64, 100, 512, "ragged"), (5, 37, 128, "reset"),
                          (1, 100, 512, "full")] + [
        (sh[0], sh[1], 512, sh[2] if len(sh) > 2 else "main path")
        for sh in nmt_train_shapes] + [GRU_DW_TAGGER + ("documents",),
                                       (64, 20, 644, "ragged")] + [
        sh + (512, "main path") for sh in packed_train_shapes]
    # the LSTM backward: the recurrent kernels' three cases, the training
    # path's, a block of four row tiles (R = 64), U = 8 with R = 1024, the
    # widest H at U = 16 (132 blocks) and U = 4 (H = 260)
    lstm_bwd_cases = [(64, 100, 512, "ragged"), (5, 37, 128, "reset"),
                      (1, 100, 512, "full")] + [
        (sh[0], sh[1], 512, "main path") for sh in train_shapes] + [
        (200, 30, 512, "ragged"), (2048, 8, 512, "ragged"),
        (64, 20, 528, "ragged"), (64, 20, 260, "reset")]
    # the dW kernel: gate boundaries inside a column tile at H = 100; its
    # sum wherever the pairs are split (S of 2 at H = 512, 6 at (5, 37,
    # 128))
    lstm_dw_cases = lstm_bwd_cases[:4] + [(3, 37, 100, "reset"),
                                          (2048, 8, 512, "ragged")]
    lstm_reduce_cases = lstm_bwd_cases[:2] + lstm_bwd_cases[3:4]
    # the LSTM forward: the recurrent kernels' three cases, the serving
    # and training paths' (B = 64, 1, 17 at T = 128), the bundles' (B =
    # 64, 1 at T = 128, and the artifact's B = 8, 3 at T = 16, every
    # step valid), a block of
    # four row tiles (R = 64), U = 8 (R = 512), the 4-unit kernel that
    # stages every row (B = 2048), U = 4 (H = 260)
    lstm_fwd_cases = [(64, 100, 512, "ragged"), (5, 37, 128, "reset"),
                      (1, 100, 512, "full")] + [
        (sh[0], sh[1], 512, "main path")
        for sh in sorted(set(lstm_shapes) | set(train_shapes)
                         | set(nested_shapes))] + [
        (B, BUNDLE_T, 512, "full") for B in BUNDLE_BATCHES] + [
        (B, EXPORT_T, 512, "full") for B in (EXPORT_BATCH, 3)] + [
        (200, 30, 512, "ragged"), (1024, 6, 512, "ragged"),
        (2048, 8, 512, "ragged"), (64, 20, 260, "reset")]
    rows = {
        "fused_lstm": kernel_phase(
            "fused_lstm", fused_lstm, fused_lstm_plain, lstm_args,
            lstm_bound, lambda out: out, (), cases=lstm_fwd_cases,
            bit_equal=True, describe=lstm_fwd_plan_line),
        # the default form: the recurrence, the dW kernel and its sum
        "fused_lstm_bwd": kernel_phase(
            "fused_lstm_bwd", fused_lstm_bwd, fused_lstm_bwd_plain,
            lstm_bwd_args, lstm_whole_bound, lambda out: list(out), (),
            rtol=KERNEL_BWD_RTOL, cases=lstm_bwd_cases, bit_equal=True),
        # the recurrence alone, the split form's kernel
        "fused_lstm_bwd_nodw": kernel_phase(
            "fused_lstm_bwd_nodw", fused_lstm_bwd_nodw,
            lambda *a: fused_lstm_bwd_plain(*a)[0], lstm_bwd_args,
            lstm_bwd_bound, lambda out: [out], (), rtol=KERNEL_BWD_RTOL,
            cases=lstm_bwd_cases, bit_equal=True, describe=lstm_plan),
        "fused_lstm_bwd_dw": kernel_phase(
            "fused_lstm_bwd_dw",
            lambda dx4, hs, cs, reset, S, mask: lstm_dw_partials(
                dx4, hs, cs, reset, S),
            lambda dx4, hs, cs, reset, S, mask: lstm_dw_partials_plain(
                dx4, hs, cs, reset, S),
            lstm_dw_args,
            lambda dx4, hs, cs, reset, S, mask: lstm_dw_bound(
                dx4, hs, cs, reset, mask),
            lambda out: [out], (), rtol=KERNEL_BWD_RTOL, cases=lstm_dw_cases,
            bit_equal=True,
            library=lambda dx4, hs, cs, reset, S, mask: split_dw_db(
                dx4, hs, cs, reset),
            describe=lambda B, T, H, ms: f"S={lstm_dw_splits(B * T, H)}"),
        "fused_lstm_bwd_dw_reduce": kernel_phase(
            "fused_lstm_bwd_dw_reduce", lstm_dw_reduce, lstm_dw_reduce_plain,
            lstm_reduce_args,
            lambda part: crf_bound(float(part.numel()), [part], [part[0]]),
            lambda out: [out], (), rtol=KERNEL_BWD_RTOL,
            cases=lstm_reduce_cases, bit_equal=True,
            library=lambda part: part.sum(0)),
        # the grid kernel, the plan's at the NMT shapes, at every case
        "fused_gru": kernel_phase(
            "fused_gru",
            lambda x3, *a: fused_gru_fwd(x3, *a,
                                         plan=grid_plan(x3.shape[2] // 3))[0],
            fused_gru_plain, gru_args, gru_bound, lambda out: [out],
            sorted(set(nmt_shapes)) + nmt_train_shapes
            + packed_serve_shapes + packed_train_shapes
            + [(B, STEP_SEQ_LEN, "main path") for B in GEN_BATCHES],
            describe=gru_path("grid")),
        # the cluster kernel, the plan's at the tagger's shape: hs and the
        # training stash
        "fused_gru_cluster": kernel_phase(
            "fused_gru_cluster", gru_cluster_fwd,
            lambda *a: list(fused_gru_plain(*a, with_gates=True)),
            gru_args, gru_bound, lambda out: out, (),
            cases=GRU_CLUSTER_CASES + [(B, EXPORT_T, RNN_CRF["hidden"],
                                        "full") for B in GEN_BATCHES],
            report_shape=GRU_DW_TAGGER, bit_equal=True,
            describe=gru_path("cluster")),
        # the backward's grid kernel, the plan's at the NMT shapes, at
        # every case (the tagger's shape too, forced there)
        "fused_gru_bwd": kernel_phase(
            "fused_gru_bwd", gru_grid_bwd,
            lambda *a: fused_gru_bwd_plain(*a)[0], gru_bwd_args,
            gru_bwd_bound, lambda out: [out], (), rtol=KERNEL_BWD_RTOL,
            cases=gru_bwd_grid_cases, describe=gru_path("grid", True)),
        # the cluster backward, the plan's at the tagger's shape
        "fused_gru_bwd_cluster": kernel_phase(
            "fused_gru_bwd_cluster", gru_cluster_bwd,
            lambda *a: fused_gru_bwd_plain(*a)[0], gru_bwd_args,
            gru_bwd_bound, lambda out: [out], (), rtol=KERNEL_BWD_RTOL,
            cases=GRU_CLUSTER_CASES, report_shape=GRU_DW_TAGGER,
            bit_equal=True, describe=gru_path("cluster", True)),
        "fused_gru_bwd_dw": kernel_phase(
            "fused_gru_bwd_dw",
            lambda dx3, gates, hs, reset, mask: fused_gru_bwd_dw(
                dx3, gates, hs, reset),
            lambda dx3, gates, hs, reset, mask: gru_dw_db_plain(
                dx3, gates, hs, reset),
            gru_dw_args, gru_dw_bound, lambda out: out, (),
            rtol=KERNEL_BWD_RTOL, cases=gru_dw_cases, bit_equal=True),
        "crf_fwd": kernel_phase(
            "crf_fwd", crf_alphas, crf_alphas_plain, crf_fwd_args,
            crf_fwd_bound, lambda out: [out], (), rtol=CRF_FWD_RTOL,
            cases=CRF_CASES, report_shape=CRF_REPORT, bit_equal=True,
            describe=crf_fwd_line),
        # the backward's two kernels apart, each on the plain version's
        # inputs: the beta recursion, then the marginals
        "crf_bwd": kernel_phase(
            "crf_bwd", crf_betas, crf_betas_plain, crf_betas_args,
            crf_betas_bound, lambda out: [out], (), rtol=CRF_FWD_RTOL,
            cases=CRF_CASES, report_shape=CRF_REPORT, bit_equal=True),
        "crf_bwd_marginals": kernel_phase(
            "crf_bwd_marginals", crf_marginals, crf_marginals_plain,
            crf_marginals_args, crf_marginals_bound, lambda out: list(out),
            (), rtol=CRF_BWD_RTOL, cases=CRF_CASES, report_shape=CRF_REPORT,
            bit_equal=True),
        "crf_bwd_reduce": kernel_phase(
            "crf_bwd_reduce", lambda p, tr, m: crf_bwd_reduce(p, tr),
            lambda p, tr, m: crf_dtrans_plain(p, tr), crf_reduce_args,
            crf_reduce_bound, lambda out: [out], (), rtol=CRF_BWD_RTOL,
            cases=CRF_CASES, report_shape=CRF_REPORT,
            # the rows' sum alone: exp(trans) is a second call
            library=lambda p, tr, m: p.sum(0)),
        "ctc_fwd": kernel_phase(
            "ctc_fwd", ctc_alphas, ctc_alphas_plain, ctc_fwd_args,
            ctc_fwd_bound, lambda out: [out], (), rtol=CTC_FWD_RTOL,
            cases=CTC_CASES, report_shape=CTC_REPORT, h_name="S",
            with_kind=True, bit_equal=True, describe=ctc_lane_line),
        # the backward's two kernels apart, each on the plain version's
        # inputs: the beta recursion, then the marginals
        "ctc_bwd": kernel_phase(
            "ctc_bwd", ctc_betas, ctc_betas_plain, ctc_inputs,
            ctc_betas_bound, lambda out: [out], (), rtol=CTC_FWD_RTOL,
            cases=CTC_CASES, report_shape=CTC_REPORT, h_name="S",
            with_kind=True, bit_equal=True, describe=ctc_lane_line),
        "ctc_bwd_marginals": kernel_phase(
            "ctc_bwd_marginals", ctc_marginals, ctc_marginals_plain,
            ctc_marginals_args, ctc_marginals_bound, lambda out: [out], (),
            rtol=CTC_BWD_RTOL, cases=CTC_CASES, report_shape=CTC_REPORT,
            h_name="S", with_kind=True, bit_equal=True),
    }
    # ... and together, against the TPU kernel's loop (no row of its own)
    kernel_phase("crf_bwd + crf_bwd_marginals", crf_bwd, crf_bwd_plain,
                 crf_bwd_args, crf_bwd_bound, lambda out: list(out), (),
                 rtol=CRF_BWD_RTOL, cases=CRF_CASES, report_shape=CRF_REPORT,
                 bit_equal=True)
    kernel_phase("ctc_bwd + ctc_bwd_marginals", ctc_bwd, ctc_bwd_plain,
                 ctc_bwd_args, ctc_bwd_bound, lambda out: [out], (),
                 rtol=CTC_BWD_RTOL, cases=CTC_CASES, report_shape=CTC_REPORT,
                 h_name="S", with_kind=True, bit_equal=True)
    rows["ctc_fwd"]["library_ms"], rows["ctc_bwd"]["library_ms"] = \
        ctc_library_ms(*CTC_REPORT)
    rows["fused_gru_bwd_dw_reduce"] = gru_dw_widths(rows)
    if rows["fused_gru_bwd_dw_reduce"] is None:
        raise SystemExit("fused_gru_bwd_dw takes one split at "
                         f"{GRU_DW_TAGGER}: its sum is not on a path")
    # ragged lengths at the reported shape, for the timings below
    r = np.random.RandomState(0)
    lengths = np.maximum(1, r.randint(25, 101, size=64))
    lengths[0] = 100
    # the GRU forward with its training stash (the row above is serving's
    # launch, without it)
    args = gru_args(64, 100, 512, lengths, False, SEED)
    print(f"  fused_gru with the stash at (64, 100, 512): "
          f"{cuda_ms(lambda: fused_gru_fwd(*args, stash=True), 20):.4f} ms, "
          f"without: {cuda_ms(lambda: fused_gru_fwd(*args), 20):.4f} ms",
          flush=True)
    # the LSTM forward with its training stash (the row above is serving's
    # launch, without it) at the reported and the training path's shapes
    for T in (100, 128):
        args = lstm_args(64, T, 512, np.minimum(lengths, T), False, SEED)
        print(f"  fused_lstm at (64, {T}, 512): with the stash "
              f"{cuda_ms(lambda: fused_lstm_fwd(*args, stash=True), 20):.4f} "
              f"ms, without: "
              f"{cuda_ms(lambda: fused_lstm_fwd(*args), 20):.4f} ms",
              flush=True)
    # the default form's dW function (the dW kernel and its sum) beside
    # the split form's (one matmul and the bias reductions)
    from paddle_tpu_torch.kernels.lstm import fused_lstm_bwd_dw

    args = lstm_bwd_args(64, 100, 512, lengths, False, SEED)
    dpre = fused_lstm_bwd_nodw(*args)
    hs, cs, reset = args[5], args[6], args[3]
    print(f"  at (64, 100, 512): the dW kernel with its sum "
          f"{cuda_ms(lambda: fused_lstm_bwd_dw(dpre, hs, cs, reset), 20):.4f}"
          f" ms; the split form's dW matmul and db reductions "
          f"{cuda_ms(lambda: split_dw_db(dpre, hs, cs, reset), 20):.4f} ms",
          flush=True)

    # phase 3: the LSTM slice's main path
    print(f"slice: lstm_text_classification {DICT}/{EMB}/{HIDDEN} x{LAYERS}"
          f" serving batches {list(REQUEST_BATCHES)}", flush=True)
    serving = lstm_slice_phase(pt, kernels, lstm_reqs)

    # phase 3b: bundle-backed serving
    print(f"slice: lstm_text_classification {DICT}/{EMB}/{HIDDEN} x{LAYERS}"
          f" from merged-model bundles (f32, bf16, int8) through "
          f"InferenceMachine, batches {list(BUNDLE_BATCHES)} of {BUNDLE_T} "
          f"ids, and the forward's torch.export artifact at {EXPORT_DICT} "
          f"words", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        serving["fused_lstm"] += bundle_phase(pt, kernels, Path(workdir))

    # phase 4: the training slice's main path, twice (each backward)
    print(f"slice: training lstm_text_classification {DICT}/{EMB}/{HIDDEN} "
          f"x{LAYERS} through SGD.train", flush=True)
    adam, momentum = training_phase(pt, kernels, batches)
    launches = {name: serving[name] + adam[name] + momentum[name]
                for name in LSTM_TRAIN_KERNELS}

    # phase 4b: the nested slice's main paths
    print(f"slice: nested sequences, the hierarchical classifier "
          f"{DICT}/{EMB}/{HIDDEN} (paragraphs of 1..{NESTED_SENTENCES} "
          f"sentences of 1..{NESTED_WORDS} words) serving batches "
          f"{list(REQUEST_BATCHES)} and training through SGD.train",
          flush=True)
    for run in nested_phase(pt, kernels, nested_reqs, lstm_reqs):
        for name in LSTM_TRAIN_KERNELS:
            launches[name] += run[name]

    # phase 5: the NMT slice's main path
    print(f"slice: nmt_decode_topology dense "
          f"{NMT['src_dict_dim']}/{NMT['trg_dict_dim']}/"
          f"{NMT['word_vector_dim']}/{NMT['encoder_size']}/"
          f"{NMT['decoder_size']}, beam {BEAM}, max_length {MAX_LEN}, "
          f"serving batches {list(NMT_BATCHES)}", flush=True)
    launches["fused_gru"] = nmt_phase(pt, kernels, nmt_reqs)["fused_gru"]

    # phase 5b: the selective and compact decodes
    print(f"slice: nmt_decode_topology selective and compact, cand_k "
          f"{CAND_K}, at the same widths and requests", flush=True)
    launches["fused_gru"] += nmt_select_phase(pt, kernels,
                                              nmt_reqs)["fused_gru"]

    # phase 5c: the per-slot step decode
    print(f"slice: nmt_decode_topology compact and dense through the "
          f"per-slot step export, {STEP_SLOTS} slots, {STEP_REQUESTS} "
          f"requests, continuous and drain", flush=True)
    launches["fused_gru"] += step_decode_phase(pt, kernels)

    # phase 5d: generation bundles
    print(f"slice: nmt_decode_topology from generation bundles at "
          f"{NMT['word_vector_dim']}/{NMT['encoder_size']}/"
          f"{NMT['decoder_size']} ({[b[:2] for b in GEN_BUNDLES]}, words "
          f"cut to JAX's 32 MiB cap), beam {BEAM}, max_length {MAX_LEN}, "
          f"{GEN_SLOTS} slots, through driver_from_bundle_meta and the "
          f"whole loop's artifact; rnn_crf_tagger's features from a bundle",
          flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        gru, cluster = gen_bundle_phase(pt, kernels, Path(workdir))
    launches["fused_gru"] += gru
    launches["fused_gru_cluster"] = cluster

    # phase 6: the NMT training slice's main path
    print(f"slice: training nmt_attention_cost {NMT['src_dict_dim']}/"
          f"{NMT['trg_dict_dim']}/{NMT['word_vector_dim']}/"
          f"{NMT['encoder_size']}/{NMT['decoder_size']} through SGD.train",
          flush=True)
    for run in nmt_training_phase(pt, kernels):
        for name in GRU_TRAIN_KERNELS:
            launches[name] = launches.get(name, 0) + run[name]

    # phase 6b: sparse-row training (no kernel: JAX runs it outside Pallas)
    print(f"slice: sparse-row training, selective_fc C={SPARSE_C}, "
          f"D={SPARSE_D}, K={SPARSE_K}, B={SPARSE_B} into square_error_cost",
          flush=True)
    sparse_train_phase(pt)

    # phase 6c: the packing-ready NMT model on padded feeds
    print(f"slice: nmt_packed_cost {PACKED} on bench_nmt_packed's stream, "
          f"serving requests {list(PACKED_REQUESTS)} through infer and "
          f"training through SGD.train", flush=True)
    for run in nmt_packed_phase(pt, kernels):
        for name in GRU_TRAIN_KERNELS:
            launches[name] = launches.get(name, 0) + run[name]

    # phase 6d: the sparse-input models (no kernel: JAX runs them outside
    # Pallas)
    print(f"slice: ctr_wide_deep {CTR} and ngram_lm (2000/32/128, context "
          f"4) on sparse and integer inputs through SGD.train", flush=True)
    sparse_inputs_phase(pt, kernels)

    # phase 7: the CRF tagging slice's main paths
    print(f"slice: CRF taggers at {CRF_WORDS} words, {CRF_LABELS} labels, "
          f"B={CRF_B}, T={CRF_T}", flush=True)
    crf_precision()
    crf_crossover()
    print(f"slice: training rnn_crf_tagger {RNN_CRF} through SGD.train",
          flush=True)
    crf_runs = rnn_crf_phase(pt, kernels)
    for run in crf_runs:
        for name in GRU_TRAIN_KERNELS:
            launches[name] += run[name]
    print(f"slice: training linear_crf_tagger {LINEAR_CRF} through "
          f"SGD.train, then serving request batches {list(CRF_REQUESTS)} "
          f"through infer on crf_decoding", flush=True)
    crf_runs += linear_crf_phase(pt, kernels)
    for name in CRF_KERNELS:
        launches[name] = sum(run[name] for run in crf_runs)

    # phase 8: the CTC slice's main path
    print(f"slice: CTC at {CTC_FEATURES} features, {CTC_CLASSES} classes, "
          f"U<={CTC_U}, B={CTC_B}, T={CTC_T}", flush=True)
    ctc_gradient_check()
    ctc_crossover()
    print(f"slice: training {CTC_FEATURES} -> fc {CTC_CLASSES} -> warp_ctc "
          f"through SGD.train", flush=True)
    ctc_runs = ctc_phase(pt, kernels)
    for name in ("ctc_fwd", "ctc_bwd", "ctc_bwd_marginals"):
        launches[name] = sum(run[name] for run in ctc_runs)

    # phase 9: the library kernels' main paths
    print(f"slice: vocab_xent at (N, D, V) = {XENT_REPORT} (bench_nmt's "
          f"output projection) and maxpool_3x3s2p1 at {POOL_REPORT} "
          f"(bench_resnet50's stem pool)", flush=True)
    xent_rows, xent_counts = xent_phase(kernels)
    rows.update(xent_rows)
    launches.update(xent_counts)
    rows["maxpool_bwd"], launches["maxpool_bwd"] = pool_phase(kernels)
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {name} never launched on its path")

    sources = {"fused_lstm": ("lstm_fwd.cu", "paddle_tpu/kernels/lstm.py:142"),
               "fused_lstm_bwd": ("lstm_bwd.cu",
                                  "paddle_tpu/kernels/lstm.py:178"),
               "fused_lstm_bwd_nodw": ("lstm_bwd.cu",
                                       "paddle_tpu/kernels/lstm.py:269"),
               "fused_lstm_bwd_dw": ("lstm_bwd.cu",
                                     "paddle_tpu/kernels/lstm.py:178"),
               "fused_lstm_bwd_dw_reduce": ("lstm_bwd.cu",
                                            "paddle_tpu/kernels/lstm.py:178"),
               "fused_gru": ("gru_fwd.cu", "paddle_tpu/kernels/gru.py:70"),
               "fused_gru_cluster": ("gru_fwd.cu",
                                     "paddle_tpu/kernels/gru.py:70"),
               "fused_gru_bwd": ("gru_bwd.cu",
                                 "paddle_tpu/kernels/gru.py:100"),
               "fused_gru_bwd_cluster": ("gru_bwd.cu",
                                         "paddle_tpu/kernels/gru.py:100"),
               "fused_gru_bwd_dw": ("gru_bwd.cu",
                                    "paddle_tpu/kernels/gru.py:100"),
               "fused_gru_bwd_dw_reduce": ("gru_bwd.cu",
                                           "paddle_tpu/kernels/gru.py:100"),
               "crf_fwd": ("crf.cu", "paddle_tpu/kernels/crf.py:46"),
               "crf_bwd": ("crf.cu", "paddle_tpu/kernels/crf.py:80"),
               "crf_bwd_marginals": ("crf.cu",
                                     "paddle_tpu/kernels/crf.py:80"),
               "crf_bwd_reduce": ("crf.cu", "paddle_tpu/kernels/crf.py:80"),
               "ctc_fwd": ("ctc.cu", "paddle_tpu/kernels/ctc.py:56"),
               "ctc_bwd": ("ctc.cu", "paddle_tpu/kernels/ctc.py:93"),
               "ctc_bwd_marginals": ("ctc.cu",
                                     "paddle_tpu/kernels/ctc.py:93"),
               "vocab_xent_fwd": ("vocab_xent.cu",
                                  "paddle_tpu/kernels/vocab_xent.py:56"),
               "vocab_xent_fwd_reduce": ("vocab_xent.cu",
                                         "paddle_tpu/kernels/vocab_xent.py:56"),
               "vocab_xent_bwd_dx": ("vocab_xent.cu",
                                     "paddle_tpu/kernels/vocab_xent.py:91"),
               "vocab_xent_bwd_dx_reduce": (
                   "vocab_xent.cu", "paddle_tpu/kernels/vocab_xent.py:91"),
               "vocab_xent_bwd_dw": ("vocab_xent.cu",
                                     "paddle_tpu/kernels/vocab_xent.py:116"),
               "maxpool_bwd": ("pool.cu", "paddle_tpu/kernels/pool.py:53")}
    print(f"chip_smoke ran its phases in {time.perf_counter() - start:.1f} s",
          flush=True)
    # the card again, so that the end of the output names it
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"paddle_tpu_torch/csrc/{sources[name][0]}",
        "replaces": sources[name][1], "launches": launches[name],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row.get("library_ms")}
        for name, row in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
