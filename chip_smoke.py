#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --cards   # on four cards: only [serve_mesh] (c)

Phases, each printing its lines; any failure exits non-zero:

  1. device: the card's name and ``nvidia-smi`` name and power limit;
  2. build: every CUDA kernel of ``src/repro_torch/kernels/csrc`` built with
     nvcc from the checkout, with the build seconds and ptxas's register and
     spill lines;
  3. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes and at edge cases (tolerances below), then its device
     time (calls captured in a CUDA graph, replayed between CUDA events)
     beside its plain version, its bound on the card and one PyTorch
     library call that computes the same function (a yardstick, never
     called by the port); the flash forward's bf16 kernel for each way it
     packs query heads (G = 1, 7, 16; Sq not a multiple of 128; q_offset;
     D 64), at chatglm3-6b's ragged batch-1 prefills (333 and 1764 tokens)
     and at the training shape, there also timed beside SDPA;
     flash-decode's tensor-core variant for G in {1, 4, 7, 16, 32}, D 64
     and 128, bf16 and fp8 caches, kv_len around its steps and splits and
     a 32768-slot cache, and both variants at the serving shape (which one
     ran is printed); the forward and flash-decode also at qwen2-vl-2b's
     and whisper-large-v3's serving shapes (G = 6, D 128; G = 1, D 64),
     and the forward at whisper's encoder (1500 x 1500) and
     cross-attention (128 x 1500) shapes, which the models run on the
     kernel at these ragged lengths, each beside SDPA; flash-decode with
     kv_len in device memory (as the captured decode step passes it)
     bitwise its int form for both variants and bf16 and fp8 caches, at
     1, around the steps and splits of its capacity-sized grid and at S,
     and one captured call replayed at
     several lengths; its time with a device kv_len beside the int form's
     and beside a grid sized by the live length; flash-decode's
     log-sum-exp (``with_lse``, what sharded serving merges by) from both
     variants against the plain version's at the int, device and per-row
     kv_len, o bitwise without it, kv_len 0 and below giving zero o and an
     lse of -1e30, two half-caches merged against the whole, and its time
     with lse beside the time without; flash-decode's host cost per call
     besides; the row gather bitwise at the prefill and decode
     shapes and at edge cases;
  4. slice: chatglm3-6b at full width (28 layers, d_model 4096, 32 query
     heads over 2 KV heads, vocab 65,024; random weights from seed 0) served
     by ``repro_torch.launch.serve.Server`` with ``attn_impl="pallas"``:
     B=4, prompt 512, 32 generated tokens.  First the head (``Model.logits``,
     a bf16 GEMM with f32 output) is held against the widened f32 product
     and both are timed.  ``Server.generate`` (the prefill, then one
     captured decode step replayed per token) and ``generate_eager`` (every
     step launched from the host) are timed in turns eager, graph, graph,
     eager, twice (prefill ms, decode ms per step, tokens/s, peak memory,
     the busy share of ``generate(8)`` under torch.profiler, the captured
     step's device time replayed back to back); their tokens must be equal
     and their logits bitwise equal.  The launch counters are zeroed just
     before the first graph run and read just after it (the eager run's
     counts must be the same): flash-attention must have
     launched once per layer (the prefill), flash-decode once per layer per
     decode step, all on the tensor cores, and the row gather once per
     prefill and once per decode step (the embedding).  Then the plain ``attn_impl="chunked"`` path,
     teacher-forced on the generated tokens, must give the kernel path's
     logits within the tolerances below, in bf16 and, with the same weights
     kept in f32, in f32 (whose decode must run flash-decode's CUDA-core
     variant, once per layer per step); and at a depth of 2 layers (full
     width) the plain naive path must give the bf16 kernel path's logits
     within a tighter limit;
  batcher: chatglm3-6b at full width and depth (bf16 weights from seed 0,
     ``attn_impl="pallas"``) behind ``runtime.scheduler.ContinuousBatcher``:
     24 requests from seed 0 (prompts uniform in 100-512 tokens, every
     batch-1 prefill on the flash forward; max_new_tokens
     uniform in 16-128, no EOS) through 8 slots of a 1024-slot cache.  The
     captured batcher (one per-slot decode step captured in a CUDA graph,
     flash-decode with one kv_len per row) and the eager one are timed in
     turns graph, eager, eager, graph: requests, tokens, engine ticks
     against the sum of max_new_tokens, admission ms (median, max), decode
     ms per tick with every slot busy, tokens/s, peak memory; the launch
     counters are zeroed just before the first captured run and read just
     after it (flash-decode 28 per tick, all on the tensor cores; the
     forward 28 per admission; the gather
     once per admission and per tick).  The captured batcher's logits must
     be bitwise the eager one's, tick by tick; the plain path (chunked
     prefill, masked decode) teacher-forced on the kernel path's tokens
     within LOGITS_REL_TOL_BF16; one captured tick without a host sync;
     the busy share of a captured run under torch.profiler; the replayed
     tick's device time against its byte bound (weights and live cache);
     per-row flash-decode at the live lengths beside SDPA given the same
     per-row mask; chatglm3's smoke config in f32 through the batcher,
     every request's tokens equal to its prompt served alone
     (``Server.generate_eager``).  Flash-decode with a kv_len per row is
     also held, in phase 3, against its plain version at mixed lengths
     (1 and S among them) for both variants and f32, bf16 and fp8 caches,
     and bitwise the scalar form with every row at one length;
  serve_mesh (right after the batcher): sharded serving,
     ``Server(mesh=)``.  (a) A 1x1 ("data", "model") NCCL mesh in the
     script's own process: chatglm3-6b at full width and depth, bf16, B=4,
     prompt 512, 32 tokens, cache 1024, the captured ``generate`` (the
     sharded step, its all-gathers inside the graph) against the unsharded
     captured ``generate``: tokens equal, logits bitwise; the counters
     zeroed just before the mesh run and read just after (28 flash, 868
     flash-decode on the tensor cores, 32 gathers); the replayed step's
     device time on and off the mesh in turns.  (b) Four ranks sharing the
     card over gloo (``launch/spawn.py:run_ranks``), a 2x2 mesh:
     chatglm3-6b and qwen3-moe-30b-a3b at depth 2 (``reduced``), full
     width, bf16, B=4, prompt 128, cache 512 (256 slots a ``model`` rank,
     so the ``model``-1 shard is empty for the first 128 decode steps and
     merges with rank 0's after), 160 tokens: each rank serves its data
     shard's rows unsharded (``generate_eager``), then the mesh's prefill
     and decode fed those tokens, eager (the moe config fed the
     reference's experts, its own differing choices counted); logits
     within LOGITS_REL_TOL_BF16_DEPTH2 of the unsharded ones, flash-decode
     twice a step on each rank, ms per step and the collectives' share of
     the last 8 steps; then, on a (2, 2, 1) ("pod", "data", "model") mesh
     of the same ranks, recurrentgemma-2b at depth 3 and batch 1 (the
     ``long`` layout: prompt 2048, cache 4096, the ring's 2048 slots over
     ("pod", "data"), 512 a rank, pod-major, wrapped from the first decode
     step; 64 tokens): each rank's slots against the unsharded prefill's,
     logits within LOGITS_REL_TOL_BF16_DEPTH2, 128 gated RG-LRU launches a
     rank.  A rank that fails or hangs past 240 s kills the
     others and fails the script.  (c), only with ``--cards`` (four cards,
     nothing else runs): a 2x2 NCCL mesh, one rank a card, chatglm3-6b at
     full width and depth served as (a), twice (NCCL's own algorithms,
     then ring and simple fixed): the captured ``generate``'s logits, fed
     its own tokens, against the mesh's eager steps (bitwise or not,
     printed) and the unsharded ``Server`` on each rank's rows, both within
     LOGITS_REL_TOL_BF16; the replayed step beside the unsharded one's;
     the other families likewise, and recurrentgemma-2b at full depth and
     batch 1 on a (2, 2, 1) NCCL mesh, bitwise its eager steps;
  stream: chatglm3-6b at full width, all 28 layers, random weights from
     seed 0, decode weights streamed from pinned host memory.  The access
     plan of one decode step (``Server.plan``, traced on the meta device)
     must have JAX's 15 records, 12 collections and 4 groups in JAX's order.
     The prefill (B=4, prompt 512) runs resident, then 4 resident decode
     steps give the reference.  One ``HostParamStore(device="cuda")`` pins
     the bf16 weights (the link's rate is measured on the largest leaf, and
     over all leaves with one copy lane and with eight); then, after a
     capre warm-up, for each mode (on demand, rop, capre, and markov-miner
     and hybrid warmed with capre's group log), 4 decode steps run through
     ``Server.stream_decode``, one ``WeightStreamer`` per step, the modes
     once in order and once in reverse.  Their tokens must equal the
     resident ones, their logits lie within 1e-5 of
     the largest logit, no fetch may time out, every plan record must be
     served, and each step must launch flash-decode once per layer and the
     gather once;
  5. flash backward: the dK/dV and dQ kernels against their plain version at
     the training shape (B=2, S=2048, 32 query heads over 2 KV heads,
     D=128, causal) in bf16 and f32, at edge cases (non-causal; ragged S
     with q_offset > 0; G = 1, 7, 16; whisper-large-v3's encoder, 1500 x
     1500, and cross-attention, 384 x 1500, at B=4) and at every head dim
     class the flash
     kernels take (D 8, 16, 64, 96, 128, bf16 and f32); dq, dk and dv equal
     bit for bit across two replays of a CUDA graph; the dK/dV launch's
     blocks per cluster and its per-SM (head, q tile) steps under a model
     of the block scheduler; then both timed beside the plain version, their
     bound and the backward of PyTorch's scaled_dot_product_attention (a
     yardstick);
  6. train: chatglm3-6b at full width.  (a) At depth 2, one step's gradient
     of every parameter on the kernel path, in bf16 and in f32, against the
     plain chunked path's f32 gradient (the plain path's own bf16 gradient
     measured beside it).  (b) At depth 16 (the depth whose f32 parameters,
     gradients and AdamW moments fit the card), B=2, S=2048, bf16 compute,
     ``remat="full"``: three ``repro_torch.launch.train.Trainer`` steps.
     The launch counters are zeroed just before that run and read just
     after it: per step, flash-attention twice per layer (the forward and
     its recomputation), dK/dV and dQ once per layer.  The first step's loss
     is held against the plain path's loss on the same batch and weights,
     and a fourth step under torch.profiler gives the device's busy share
     and the kernels with the most device time.  (c) The other families at
     full width, each after every earlier model is freed, trained as in
     (b) with every kernel counted (``TRAIN_FAMILIES``): whisper-large-v3
     (32 + 32 layers, B=4, decoder 384, 1500 frames: 192 flash forwards,
     96 dK/dV and 96 dQ a step, its decoder, encoder and cross-attention
     on the kernels; profiled), qwen3-moe-30b-a3b (depth 4
     of 48, ``reduced``; B=2, S=2048: 8, 4, 4; profiled),
     recurrentgemma-2b (depth 6 of 26, ``reduced``) and falcon-mamba-7b
     (depth 4 of 64, ``reduced``), B=2, S=2048: no kernel launch (windowed or no attention,
     the scans' plain loop under autograd).
  cost (right after (b)): the cost model (``launch.costmodel.step_cost``,
     on the meta device, the kernels priced) on chatglm3-6b's captured
     decode step, prefill and depth-16 train step: FLOPs, bytes and the
     bound beside the measured time; each kernel's calls must equal the
     launches of one real step on the card;
  mesh (right after cost): the multi-device layer.  (a) A 1x1 ("data",
     "model") NCCL mesh: chatglm3-6b at full width, the train phase's
     depth 16, B=2, S=2048, bf16: one step's loss and every gradient leaf
     on DTensors under ``activate_sharding`` bitwise the unsharded step's,
     with equal flash launches; then two ``Trainer(mesh=)`` steps beside
     two unsharded ones (losses bitwise, launches per step, ms per step).
     (b) Four processes sharing the card over gloo
     (``launch.spawn.run_ranks``), a 2x2 mesh with CUDA tensors:
     chatglm3-6b at full width, depth 2 (``reduced``: four ranks' f32
     state on one card), B=4, S=512: one step's loss and five gradient
     leaves against the unsharded step's (1e-4, 2e-2), three
     ``Trainer(mesh=)`` steps' losses against the unsharded Trainer's
     (1e-4), per rank its flash launches (> 0), peak memory, step ms and
     the collectives' share of a profiled third step; then
     qwen3-moe-30b-a3b's one layer (128 experts, 64 a rank) through
     ``moe_apply_ep`` and ``moe_apply_ep_a2a`` against ``moe_apply_dense``
     (f32 1e-5, bf16 2e-2 of the largest value; the routes equal in f32).
     A rank that fails or hangs past 240 s kills the others and fails the
     script;
  smoke: the chatglm3 and yi smoke configs (head_dim 16 and 8), unmodified,
     and chatglm3's with head_dim 256, 20 and 320 (which the flash kernels
     run on the CUDA cores, 320 in two pieces of the D = 256 build), the
     qwen3-moe and granite-moe smoke configs, whisper's (256 frames:
     encoder, decoder and cross-attention all on the flash kernels) and
     qwen2-vl's (the prompt as embeddings at an image's 3-stream
     positions), all with ``attn_impl="pallas"``: served (B=2, prompt 128,
     8 tokens) through the flash forward and flash-decode, the captured
     decode bitwise the eager loop, logits against the plain path in bf16
     (naive) and f32 (chunked); then each of them and the falcon-mamba and
     recurrentgemma smoke configs trained one step, every gradient on the
     kernel path, bf16 and f32, against the plain chunked path's f32
     gradient, with the path's launches (the moe configs' plain path fed the kernel path's
     expert choices, its own that differ counted: none in f32);
  scans: the materialised mamba and RG-LRU scan kernels (the TPU kernels'
     contracts) and the fused selective scan and gated RG-LRU kernels (the
     models' path) against their plain versions (outputs and last states)
     at S in {1, 7, 128, 512} with and without an initial state, in f32 and
     bf16, at the serving widths and at channel counts that are not a
     multiple of a block (the selective scan also with N < 16 and its state
     updated in place; the RG-LRU kernels' f32 outputs bitwise); then timed
     (CUDA graphs) at the serving shapes, prefill and decode, beside their
     plain versions and their bounds (no PyTorch call computes any scan);
  7. falcon-mamba-7b and 8. recurrentgemma-2b at full width and depth (64
     and 26 layers; random weights from seed 0), each served by
     ``Server.generate`` with ``attn_impl="pallas"``, B=4, prompt 512, 32
     generated tokens, bf16 weights, the captured and the eager decode
     side by side as in phase 4: prefill ms, decode ms per step,
     tokens/s, peak memory, the busy share of ``generate(8)``, tokens and
     logits bitwise equal, and the launch counts of the first graph run
     (the fused selective scan once per layer per
     prefill and per decode step, 2,048 in all; the gated RG-LRU scan once
     per recurrent layer, 576; the gather 32; no attention kernel and
     neither materialised scan).  Then the kernel path against the plain loop over time
     (``"chunked"``), teacher-forced on the generated tokens (prefill and 8
     steps), in bf16 (at full depth, and at depth 3 with a tighter limit)
     and, with the same weights drawn again in f32, in f32.
  9. qwen3-moe-30b-a3b (``[moe]``) and 10. granite-moe-1b-a400m
     (``[granite]``) at full width and depth (48 and 24 layers, 128 and 32
     experts, top-8), each after every earlier model is freed, bf16
     weights made on the card (61.07 and 2.67 GB), served by
     ``Server.generate`` as in phase 4 (B=4, prompt 512, 32 tokens, cache
     1024): prefill ms, decode ms per step and tokens/s captured and eager,
     busy share, the replayed step's device time and a profile of 8
     replays, peak memory, the step's byte bound (every expert's weights:
     capacity 1 at B=4); tokens and logits bitwise equal; launches 48 / 24
     flash, 1,488 / 744 flash-decode all on the tensor cores, 32 gathers;
     one eager decode step under ``torch.cuda.set_sync_debug_mode("error")``
     (no host sync).  Then at depth 2 and full width the kernel path
     against the plain path teacher-forced, with the plain path fed the
     kernel path's expert choices and the choices it would have made
     itself counted against them, call by call (prefill chunk or decode
     step, and layer): in f32 (chunked) no choice may differ and the
     logits agree within 1e-3; in bf16 (naive) the differing choices are
     printed with where they fall, the plain path's own routing is printed
     beside, and the logits on the kernel path's routes agree within 2e-2.
  11. whisper-large-v3 (``[whisper]``: 32 encoder and 32 decoder layers,
     audio frames [4, 1500, 1280], decoder prompt 128, 32 tokens, cache
     256) and 12. qwen2-vl-2b (``[qwen2vl]``: 28 layers, the prompt as
     embeddings [4, 512, 1536] at an image's 3-stream positions, 32
     tokens, cache 1024) at full width and depth, each after every
     earlier model is freed, weights from seed 0 in f32 cast to bf16,
     served as in phase 9: the access plan of a decode step (25 and 15
     records) and its byte bound (the weights it reads, the live self
     cache and whisper's cross cache); launches 96 / 28 flash (whisper's
     decoder, encoder and cross-attention: on the card every length takes
     the kernel), 992 / 868
     flash-decode on the tensor cores, 32 / 31 gathers (qwen2-vl's prompt
     is not gathered); tokens and logits bitwise; a profile of 8 replays;
     no host sync in an eager step; then at depth 2 (full width) the
     kernel path against the plain path teacher-forced, bf16 (naive) within
     2e-2 and f32 (chunked) within 1e-3 of the largest logit;
  13. analysis (``[analysis]``, on the host): CAPre's static analysis of
     the five benchmark apps (bank, wordcount, kmeans, oo7, pga) through
     the port's ``capre-lint --compare`` (``repro_torch.core.lint.main``)
     against the committed golden ``artifacts/analysis/hints.json``: each
     app's methods, hints, RFO and truncated hints, caller-shadowed hints
     and lint findings, and the seconds taken; any exit code but 0 (lint
     findings, a drifted or missing golden) fails the script;
  14. pos (``[pos]``, on the host): the object store CAPre prefetches
     into (``repro_torch.pos``), its predictors and the replay harness
     (``repro_torch.predict.{evaluate,loadsim,calibration}``,
     ``repro_torch.obs.export``).  (a) bank, kmeans and wordcount recorded
     by the port's ``record_workload`` (the catalog's ``_catalog()``: a
     zero-latency 4-service ``POSClient``, two prefetch-off cold-cache
     runs) into an empty trace cache in a temporary directory: each file
     it writes must equal the committed
     ``artifacts/predict/traces/*_r2_ds4_v2.2.json`` byte for byte.  (b)
     The paper's experiment in small: the bank app,
     300 transactions over 4 Data Services with ``examples/quickstart.py``'s
     latencies, 16 prefetch workers, both traversals (setAllTransCustomers,
     auditAll) with no prefetching, CAPre and ROP, each on a fresh store
     (after what one host sleep for each modelled latency takes):
     host ms, misses, hits, prefetch loads and recall printed (not
     checked); each mode's store after the run must equal no
     prefetching's, no prefetching must load nothing ahead, and CAPre's
     recall on auditAll must be at least 0.99.  (d) The paper's
     comparison on the replay's virtual clock: ``evaluate_apps`` over
     ``artifacts/predict/baseline.csv``'s grid (bank, bank_write,
     wordcount, kmeans; every predictor; capacities 0, 64, 256; lru and
     prefetch-aware; per-oid and batch dispatch), the trace cache off and
     the committed calibration passed in: ``write_csv``'s header and its
     192 rows must equal the file's, keyed by (app, workload, predictor,
     cache_capacity, policy, dispatch), in every column as text but
     train_seconds and obs_seconds (wall-clock cells); each predictor's
     timely coverage, stall and stall saved at capacity 0, lru, batch are
     printed in virtual seconds, with the host seconds the replay took.
     (e) ``run_loadsim`` at the arguments of
     ``artifacts/predict/loadgen.csv``'s virtual rows (128 tenants,
     poisson:2000, CAPre, batch, a 256-line shared LRU budget, 8
     outstanding, admission threshold 0.5): ``write_loadgen_csv``'s 129
     rows must equal those rows line for line; the ALL row is printed.
     (f) The virtual bank replay (static-capre warmed on the first run,
     batch dispatch) traced and written by ``write_chrome_trace``: both
     validators must return nothing for the file read back, every loaded
     prefetch span must show at least 4 phases, and a counter track must
     be there; the event count is printed.  (c) The phase's seconds.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import io
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# tolerances of a kernel against its plain version: f32 sums in another
# order; bf16: the plain version rounds normalised P and its PV product to
# bf16, the kernels round unnormalised P and keep f32 sums
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_ATOL = 1e-4
# the full-width model's logits, kernel path against the plain chunked path,
# as a fraction of the largest logit: in f32 only the order of sums differs;
# in bf16 the two paths round at different places (the plain chunked path
# keeps its accumulator in bf16, as the JAX code does) and 28 random layers
# compound that, so the bf16 limit catches only gross errors (both bf16
# paths sit ~6% from the f32 result).  The f32 check runs the CUDA-core
# flash kernel; the tensor-core one that bf16 serving runs is held tightly
# by the kernel checks (TOL) and, at model level, by the depth-2 check:
# full width, 2 layers, against the plain naive path, which rounds P to
# bf16 as the kernels do
LOGITS_REL_TOL_F32 = 1e-3
LOGITS_REL_TOL_BF16 = 0.1
LOGITS_REL_TOL_BF16_DEPTH2 = 2e-2
# the head on the card (one bf16 GEMM with f32 output) against widening both
# operands to f32: the products are exact in f32, only the order of the
# 4096-term f32 sums differs (5.5e-6 measured on an H100); relative to the
# largest logit
HEAD_REL_TOL = 5e-5
# gradients, kernel against plain, relative to each tensor's (leaf's)
# largest magnitude: f32 sums over up to 16 query heads and 2048 rows in
# another order; in bf16 both round P and dS before their products, the
# kernels keep the GQA group sum in f32
GRAD_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a model's bf16 gradient against the plain path's f32 gradient on the same
# parameters and batch (``check_grads``), relative to each leaf's largest
# magnitude: bf16 rounding in every product of the model, not the attention
# alone.  Over seeds 0-2 of every config ``check_grads`` takes
# (``benchmarks/torch_grad_bounds.py`` on an H100), the plain chunked path's
# own bf16 gradient sat up to 2.30e-2 from the f32 one on chatglm3-6b at
# depth 2 and 2.71e-2 on mamba-smoke (which runs no kernel under autograd,
# so its two paths are one), the kernel path's up to 2.07e-2 where it runs
# kernels; the bound sits above both paths' readings
GRAD_REL_TOL_BF16_F32 = 3e-2
# the depth-16 first step's loss against the plain chunked path's forward on
# the same batch and weights (bf16 rounding at different places)
LOSS_REL_TOL = 2e-2
# gradients that are zero in exact arithmetic: softmax is invariant to a
# constant added to all of a query's scores, which is what the key bias
# adds (the dense and moe stacks; whisper's encoder and decoder
# self-attention), so both paths compute rounding noise there; each is held
# to the largest gradient magnitude of the whole tree instead of its own
ZERO_GRAD_LEAVES = ("layers.attn.bk", "enc_layers.attn.bk", "dec_layers.attn.bk")
TRAIN_DEPTH = 16
# the recurrent models' bf16 logits, kernel path against the plain loop over
# time, as a fraction of the largest logit.  Both paths round at the same
# places (the scans' states and sums in f32, their outputs rounded once to
# bf16) and the RG-LRU kernel is bitwise its plain version; only the order
# of the mamba scan's 16-term f32 sum of y differs, which flips the bf16
# rounding of a few of y's elements by one unit (0.4%).  Random layers
# amplify a perturbation ~100x over falcon-mamba-7b's 64 (f32: ~1e-7 per
# scan output, 1.0e-5 at the logits), so at full depth those flips reach
# ~2e-2 (1.954e-2 measured on an H100), and the full-depth limit is the
# dense phase's, which catches gross errors only (both bf16 paths sit ~6.7%
# from f32).  The tight bf16 check is at depth 3 (full width, one of each
# kind of the hybrid's pattern), where little is amplified
RECURRENT_REL_TOL_BF16 = LOGITS_REL_TOL_BF16
RECURRENT_REL_TOL_BF16_DEPTH3 = 2e-2
RECURRENT = ("falcon_mamba_7b", "recurrentgemma_2b")
# the moe family's full configs and their phases' tags
MOE = (("qwen3_moe_30b_a3b", "moe"), ("granite_moe_1b_a400m", "granite"))
# the fused RG-LRU kernel's f32 outputs against its plain version, relative
# to the largest: both round every product and sum alike, so they are
# expected bitwise equal (printed); this limit allows only for the card's
# expf and torch's exp differing in the last place
RGLRU_FUSED_REL_TOL = 1e-6
# kernels kept for the TPU kernels' contracts (materialised dA, dBu; a, g),
# checked and timed in the scans phase; the serving path runs the fused
# kernels instead, so these must show no launch there
OFF_PATH = ("mamba_scan_fwd", "rglru_scan_fwd")
# streamed decode logits against the resident decode's, relative to the
# largest logit: the same kernels on the same bits, so expected equal
STREAM_REL_TOL = 1e-5
STREAM_STEPS = 4
# the committed golden hint sets of the five benchmark apps
GOLDEN = ROOT / "artifacts" / "analysis" / "hints.json"
# the committed recordings of three catalog workloads (record_workload, two
# cold-cache runs on four Data Services)
POS_TRACES = ROOT / "artifacts" / "predict" / "traces"
POS_GOLDEN = ("bank", "kmeans", "wordcount")
# the committed replay rows, the grid they were written from, what keys a
# row and the columns a wall clock fills; the fitted latency calibration
POS_BASELINE = ROOT / "artifacts" / "predict" / "baseline.csv"
POS_BASELINE_APPS = ("bank", "bank_write", "wordcount", "kmeans")
POS_BASELINE_GRID = dict(cache_capacities=(0, 64, 256), policies=("lru", "prefetch-aware"),
                         dispatch_modes=("per-oid", "batch"))
POS_ROW_KEY = ("app", "workload", "predictor", "cache_capacity", "policy", "dispatch")
POS_WALL_COLUMNS = ("train_seconds", "obs_seconds")
POS_CALIBRATION = ROOT / "artifacts" / "predict" / "calibration.csv"
# the committed load-simulator rows and the arguments of their virtual rows
POS_LOADGEN = ROOT / "artifacts" / "predict" / "loadgen.csv"
POS_LOADSIM_ARGS = dict(tenants=128, arrival="poisson:2000", jobs=1, seed=0, mode="capre",
                        dispatch="batch", cache_capacity=256, shared_budget=True,
                        policy="lru", max_outstanding=8, admission_threshold=0.5)
# the paper's experiment in small: examples/quickstart.py's latencies
# (seconds: disk load, remote hop, write back, think), its 300
# transactions and 16 prefetch workers; CAPre's recall floor on the
# read-only traversal (the JAX tests' own)
POS_LATENCY = (300e-6, 120e-6, 350e-6, 100e-6)
POS_TRANSACTIONS = 300
POS_WORKERS = 16
POS_RECALL_MIN = 0.99


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls between CUDA
    events: the larger of the device's time and the host's cost per call."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's cost
    of each call is left out.  A wrapper's launch counter moves once per
    captured call, never on a replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def host_us(torch, fn, n: int = 200) -> float:
    """Host cost of one ``fn()`` in us: ``n`` calls with no synchronisation
    between them (the device finishes each before the next is issued)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return us


def allclose(torch, got, want, tol: float) -> tuple[bool, float]:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= tol + tol * w.abs()).all()) and bool(torch.isfinite(g).all())
    return ok, float(err.max())


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}; {torch.cuda.device_count()} device(s)")
    print(f"[device] nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} libraries in {_build.build_dir()} "
          f"in {time.perf_counter() - t0:.3f} s")
    for name, rec in _build.BUILD_LOG.items():
        print(f"[build] {name}: nvcc {rec['seconds']:.3f} s")
        lines = [l.strip() for l in rec["log"].splitlines()
                 if "registers" in l or "spill" in l or "Compiling entry" in l]
        for l in lines:
            print(f"[build]   {l}")


def phase_analysis() -> None:
    """CAPre's static analysis on the host: the port's ``capre-lint
    --compare`` over the five catalog apps must reproduce the committed
    golden hint sets; its lines and the seconds taken are printed."""
    from repro_torch.core import lint

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = lint.main(["--compare", "--golden", str(GOLDEN)])
    seconds = time.perf_counter() - t
    for line in out.getvalue().splitlines():
        print(f"[analysis] {line}")
    print(f"[analysis] capre-lint --compare: rc {rc} in {seconds:.4f} s")
    check(rc == 0, f"capre-lint --compare exited {rc}")



def _masked_csv(path) -> list:
    """A replay CSV's rows (header first), the wall-clock cells blanked."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    cols = [rows[0].index(c) for c in POS_WALL_COLUMNS]
    for row in rows[1:]:
        for col in cols:
            row[col] = ""
    return rows


def _keyed(rows: list) -> dict:
    idx = [rows[0].index(c) for c in POS_ROW_KEY]
    return {tuple(row[i] for i in idx): row for row in rows[1:]}


def pos_virtual(tmp: Path) -> None:
    """(d) the replay on the virtual clock over baseline.csv's grid, (e) the
    load simulator at loadgen.csv's arguments, (f) the Chrome-trace export
    of the virtual bank replay."""
    from repro_torch.obs import Tracer
    from repro_torch.obs.export import (
        full_lifecycle_phase_counts,
        validate_chrome_trace,
        validate_flow_pairing,
        write_chrome_trace,
    )
    from repro_torch.pos.client import SessionConfig
    from repro_torch.predict import make_pos_predictor
    from repro_torch.predict.calibration import load_calibration
    from repro_torch.predict.evaluate import (
        _catalog,
        evaluate_apps,
        record_workload,
        replay,
        write_csv,
    )
    from repro_torch.predict.loadsim import run_loadsim, write_loadgen_csv

    calibration = load_calibration(str(POS_CALIBRATION))
    check(calibration.fitted, f"[pos] (d) {POS_CALIBRATION} gave no fitted scale")
    t = time.perf_counter()
    results = evaluate_apps(apps=POS_BASELINE_APPS, trace_cache=None,
                            calibration=calibration, **POS_BASELINE_GRID)
    seconds = time.perf_counter() - t
    got = _masked_csv(write_csv(results, str(tmp / "replay.csv")))
    want = _masked_csv(POS_BASELINE)
    check(got[0] == want[0], "[pos] (d) the replay's header differs from baseline.csv's")
    got_rows, want_rows = _keyed(got), _keyed(want)
    differ = sorted(k for k in want_rows if got_rows.get(k) != want_rows[k])
    print(f"[pos] (d) replay of {len(POS_BASELINE_APPS)} apps on the virtual clock: "
          f"{len(results)} rows in {seconds:.4f} host s; equal to baseline.csv's "
          f"{len(want) - 1} rows but {', '.join(POS_WALL_COLUMNS)}: "
          f"{len(got) == len(want) and set(got_rows) == set(want_rows) and not differ}")
    check(len(got) == len(want) == 193 and set(got_rows) == set(want_rows),
          f"[pos] (d) the replay's rows are not baseline.csv's: {len(got) - 1} rows")
    check(not differ, f"[pos] (d) {len(differ)} rows differ from baseline.csv's, "
                      f"first {differ[:1]}")
    for r in results:
        if (r.cache_capacity, r.policy, r.dispatch) != (0, "lru", "batch"):
            continue
        print(f"[pos] (d) {r.app} {r.workload} {r.predictor}: timely coverage "
              f"{r.timely_coverage:.4f}, stall {r.stall_seconds:.6f} virtual s "
              f"(none {r.baseline_stall_seconds:.6f} virtual s), saved "
              f"{r.stall_saved_pct:.2f}%")

    t = time.perf_counter()
    report = run_loadsim(**POS_LOADSIM_ARGS)
    seconds = time.perf_counter() - t
    write_loadgen_csv(str(tmp / "loadgen.csv"), report.rows())
    got = (tmp / "loadgen.csv").read_text().splitlines()
    lines = POS_LOADGEN.read_text().splitlines()
    want = [line for line in lines[1:] if line.startswith("virtual,")]
    same = got[0] == lines[0] and got[1:] == want
    print(f"[pos] (e) load simulator, {POS_LOADSIM_ARGS['tenants']} tenants at "
          f"{POS_LOADSIM_ARGS['arrival']}: {len(got) - 1} rows in {seconds:.4f} host s; "
          f"equal to loadgen.csv's {len(want)} virtual rows: {same}")
    print(f"[pos] (e) {got[-1]}")
    check(len(want) == 129 and same, "[pos] (e) the load simulator's rows are not "
                                     "loadgen.csv's virtual rows")

    wl = _catalog()["bank"]
    t = time.perf_counter()
    client, _root, traces = record_workload(wl, runs=2, cache_dir=None)
    predictor = make_pos_predictor("static-capre", config=SessionConfig(rop_depth=2))
    predictor.warm(traces[0].accesses)
    tracer = Tracer()
    replay(traces[-1], predictor, client.store, client.logic_module.registered[wl.name],
           dispatch="batch", tracer=tracer)
    spans = tracer.spans()
    path = tmp / "bank.trace.json"
    write_chrome_trace(str(path), spans, clock="virtual")
    seconds = time.perf_counter() - t
    back = json.loads(path.read_text())
    problems = validate_chrome_trace(back) + validate_flow_pairing(back)
    phases = full_lifecycle_phase_counts(back)
    loaded = [s for s in spans if s.kind == "prefetch" and s.load_done_t is not None]
    short = [s.oid for s in loaded if phases.get(s.oid, 0) < 4]
    counters = sum(1 for ev in back["traceEvents"] if ev["ph"] == "C")
    print(f"[pos] (f) Chrome trace of the virtual bank replay: {len(back['traceEvents'])} "
          f"events of {len(spans)} spans, {counters} counter events, "
          f"{path.stat().st_size} bytes in {seconds:.4f} host s; problems {problems}; "
          f"loaded prefetch spans {len(loaded)}, under 4 phases {len(short)}")
    check(not problems, f"[pos] (f) the trace is malformed: {problems[:3]}")
    check(loaded and not short, f"[pos] (f) loaded prefetch spans under 4 phases: {short[:5]}")
    check(counters > 0, "[pos] (f) the trace holds no counter track")


def phase_pos(smi: str) -> None:
    """The object store, its predictors and the replay harness on the
    host: (a) the committed traces reproduced by the port's recorder, (b)
    the bank app under no prefetching, CAPre and ROP at quickstart's
    latencies, (d)-(f) the virtual-clock replay, the load simulator and
    the trace export held to the committed artifacts, (c) the phase's
    seconds."""
    import tempfile

    from repro_torch.apps.bank import build_bank_app, populate_bank_store
    from repro_torch.pos.client import POSClient
    from repro_torch.pos.latency import LatencyModel
    from repro_torch.predict.evaluate import _catalog, _snapshot_store, record_workload

    t_phase = time.perf_counter()
    print(f"[pos] host times on the machine of: {smi}")
    catalog = _catalog()
    with tempfile.TemporaryDirectory() as tmp:
        for key in POS_GOLDEN:
            path = POS_TRACES / f"{key}_r2_ds4_v2.2.json"
            check(path.is_file(), f"[pos] committed trace {path} missing")
            cache = Path(tmp) / key
            t = time.perf_counter()
            _client, _root, traces = record_workload(catalog[key], runs=2, n_services=4,
                                                     cache_dir=str(cache))
            seconds = time.perf_counter() - t
            written = sorted(cache.iterdir())
            same = [p.name for p in written] == [path.name] and \
                written[0].read_bytes() == path.read_bytes()
            print(f"[pos] (a) {key}: {len(traces[0])} + {len(traces[1])} events recorded in "
                  f"{seconds:.4f} s; the file written equals {path.name} byte for byte: {same}")
            check(same, f"[pos] {key}'s recording differs from {path.name}")

    disk, hop, write_back, think = POS_LATENCY
    lat = LatencyModel(disk_load=disk, remote_hop=hop, write_back=write_back, think=think)
    # what the host's clock makes of each modelled latency: the store sleeps
    # for it, so the host ms below follow these, not the model's constants
    for name, seconds in zip(("disk load", "remote hop", "write back", "think"), POS_LATENCY):
        took = []
        for _ in range(50):
            t = time.perf_counter()
            lat.sleep(seconds)
            took.append(time.perf_counter() - t)
        print(f"[pos] (b) one sleep for the {name}, {seconds * 1e6:.0f} us: median "
              f"{statistics.median(took) * 1e6:.1f} us, max {max(took) * 1e6:.1f} us of 50")
    for traversal in ("setAllTransCustomers", "auditAll"):
        plain = None
        for mode in (None, "capre", "rop"):
            client = POSClient(n_services=4, latency=lat)
            client.register(build_bank_app())
            root = populate_bank_store(client.store, n_transactions=POS_TRANSACTIONS)
            with client.session("bank", mode=mode, parallel_workers=POS_WORKERS) as s:
                t = time.perf_counter()
                s.execute(root, traversal)
                wall = time.perf_counter() - t
                drained = s.drain(30.0)
            check(drained, f"[pos] {traversal} {mode}: prefetch work still running after 30 s")
            m = client.store.snapshot_metrics()
            acc = client.store.prefetch_accuracy()
            dump = _snapshot_store(client.store)
            recall = f"{acc['recall']:.4f}" if mode is not None else "-"
            print(f"[pos] (b) {traversal} {mode or 'none'}: {wall * 1e3:.3f} ms, "
                  f"misses {m['app_cache_misses']}, hits {m['app_cache_hits']}, "
                  f"prefetch loads {m['prefetch_loads']}, recall {recall}")
            if mode is None:
                plain = dump
                check(m["prefetch_loads"] == 0 and not client.store.prefetched_oids,
                      f"[pos] {traversal}: no prefetching loaded ahead")
            else:
                check(dump == plain, f"[pos] {traversal} {mode}: the store differs from "
                                     "the one of no prefetching")
            if mode == "capre" and traversal == "auditAll":
                check(acc["recall"] >= POS_RECALL_MIN,
                      f"[pos] CAPre's recall on auditAll {acc['recall']} < {POS_RECALL_MIN}")
    with tempfile.TemporaryDirectory() as tmp:
        pos_virtual(Path(tmp))
    print(f"[pos] (c) phase: {time.perf_counter() - t_phase:.3f} s")

def phase_flash(torch, ref, flash_fwd):
    """Check the flash kernel at the prefill shape and edge cases; time the
    prefill shape.  Returns its JSON record (launches filled in later)."""
    from repro_torch.kernels.flash_attention import route

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [  # B, S, H, KV, D, dtype, causal, q_offset, Sq
        (4, 512, 32, 2, 128, torch.bfloat16, True, 0, 512),   # serving prefill
        (4, 512, 32, 2, 128, torch.float32, False, 0, 512),
        (1, 256, 2, 2, 64, torch.float32, True, 192, 64),
        (2, 256, 8, 2, 64, torch.bfloat16, True, 0, 256),
        (1, 256, 2, 2, 128, torch.bfloat16, True, 192, 64),
        # the bf16 kernel's packings: G = 1 (one head, 128 rows a block), G = 7
        # (one head of the last pair idle), G = 16; Sq not a multiple of 128
        (2, 200, 2, 2, 128, torch.bfloat16, True, 0, 200),
        (1, 269, 14, 2, 128, torch.bfloat16, True, 192, 77),
        (1, 130, 7, 1, 64, torch.bfloat16, False, 0, 130),
        (2, 300, 32, 2, 64, torch.bfloat16, True, 0, 300),
        (2, 2048, 32, 2, 128, torch.bfloat16, True, 0, 2048),  # training shape
        # the CUDA-core kernel's head dims: a bf16 row not a multiple of 16
        # bytes, past the tensor-core builds, and its D = 256 build
        (1, 200, 8, 2, 20, torch.bfloat16, True, 0, 200),
        (1, 269, 14, 2, 136, torch.bfloat16, True, 192, 77),
        (2, 256, 8, 2, 256, torch.bfloat16, True, 0, 256),
        (1, 130, 4, 2, 256, torch.float32, False, 0, 130),
        # qwen2-vl-2b's prefill (G = 6, D 128) and whisper-large-v3's decoder
        # self-attention at prefill (G = 1, D 64): their models' main path
        (4, 512, 12, 2, 128, torch.bfloat16, True, 0, 512),
        (4, 128, 20, 20, 64, torch.bfloat16, True, 0, 128),
        # whisper's encoder (1500 x 1500) and cross-attention (128 x 1500),
        # not causal, at lengths that are not multiples of 128: the models'
        # main path on the card
        (4, 1500, 20, 20, 64, torch.bfloat16, False, 0, 1500),
        (4, 1500, 20, 20, 64, torch.bfloat16, False, 0, 128),
        # chatglm3-6b's batch-1 prefill at ragged prompt lengths (G = 16, D
        # 128, a masked last block): the serving batcher's main path
        (1, 333, 32, 2, 128, torch.bfloat16, True, 0, 333),
        (1, 1764, 32, 2, 128, torch.bfloat16, True, 0, 1764),
    ]
    main_err = None
    for B, S, H, KV, D, dt, causal, q_off, Sq in cases:
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dt)
        o, lse = flash_fwd(q, k, v, causal=causal, q_offset=q_off)
        o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_off,
                                                 return_lse=True)
        torch.cuda.synchronize()
        tol = TOL[str(dt).split(".")[-1]]
        ok_o, err_o = allclose(torch, o, o_ref, tol)
        err_l = float((lse - lse_ref).abs().max())
        print(f"[flash] B={B} Sq={Sq} Sk={S} H={H} KV={KV} D={D} {dt} causal={causal} "
              f"q_offset={q_off} ({route(D, dt)}): o max_abs_err {err_o:.3e} (tol {tol}), "
              f"lse max_abs_err {err_l:.3e} (tol {LSE_ATOL})")
        check(ok_o, "flash-attention output disagrees with its plain version")
        check(err_l <= LSE_ATOL, "flash-attention lse disagrees with its plain version")
        if main_err is None:
            main_err = err_o

    B, S, H, KV, D = 4, 512, 32, 2, 128
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    ms = graph_ms(torch, lambda: flash_fwd(q, k, v, causal=True))
    plain_ms = graph_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=True), iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = graph_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per head
    flops = 4 * B * H * D * pairs
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    rec = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "launches": None, "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }
    print(f"[flash] prefill shape B={B} S={S} H={H} KV={KV} D={D} bf16 causal: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device times, CUDA "
          f"graph); bound {rec['bound_ms'] * 1e3:.2f} us by {rec['bound_by']} ({nbytes} B, "
          f"{flops} FLOP)")

    for shape in FLASH_SHAPES:
        time_flash_shape(torch, flash_fwd, gen, *shape, ref=ref)
    return rec


# shapes the forward is timed at beside SDPA (the serving prefill is timed
# above): (label, B, Sq, Sk, H, KV, D, causal).  The training shape (the
# forward runs twice per layer per train step), and the two newest models'
# at their serving sizes
FLASH_SHAPES = (
    ("training shape", 2, 2048, 2048, 32, 2, 128, True),
    ("qwen2-vl-2b prefill", 4, 512, 512, 12, 2, 128, True),
    ("whisper-large-v3 decoder prefill", 4, 128, 128, 20, 20, 64, True),
    ("whisper-large-v3 encoder", 4, 1500, 1500, 20, 20, 64, False),
    ("whisper-large-v3 cross-attention", 4, 128, 1500, 20, 20, 64, False),
)


def time_flash_shape(torch, flash_fwd, gen, label: str, B: int, Sq: int, Sk: int, H: int,
                     KV: int, D: int, causal: bool, ref=None) -> None:
    """The bf16 flash forward at one shape beside SDPA (device times, CUDA
    graph of 10 calls) and its bound; at the training shape also its plain
    version (mean of 3 calls between CUDA events: it materialises the
    scores)."""
    dev = torch.device("cuda")
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Sk, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Sk, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    ms = graph_ms(torch, lambda: flash_fwd(q, k, v, causal=causal), iters=10)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = graph_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True),
                      iters=10)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * Sq
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk  # (query, key) pairs per head
    flops = 4 * B * H * D * pairs
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    plain = ""
    if label == "training shape":
        plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=causal),
                           iters=3, warmup=1)
        plain = f", plain {plain_ms:.5f} ms (CUDA events)"
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[flash] {label}: B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} bf16 causal={causal}: "
          f"kernel {ms:.5f} ms, sdpa {lib_ms:.5f} ms (device times, CUDA graph){plain}; bound "
          f"{max(t_bytes, t_ops) * 1e3:.2f} us by {'bytes' if t_bytes >= t_ops else 'operations'} "
          f"({nbytes} B, {flops} FLOP); {flops / ms / 1e9:.1f} TFLOP/s, sdpa "
          f"{flops / lib_ms / 1e9:.1f}")


DECODE_LENS = (1, 15, 16, 17, 63, 64, 65, 528, 1024)


def check_decode_variants(torch, ref, decode_fwd) -> None:
    """The tensor-core flash-decode for query groups that leave rows of its
    16-head tile empty (G = 1, 4, 7), fill it (16) or take two tiles (32),
    D 64 and 128, bf16 and fp8 caches, at lengths around its 16-key steps
    and splits, and one cache of 32768 slots; one line per (G, D, cache)
    with the worst error over the lengths."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    n_mma = decode_fwd.launches_mma
    n_checks = 0
    B, KV, S = 2, 2, 1024
    for G, D, kv_dt in itertools.product((1, 4, 7, 16, 32), (64, 128),
                                         (torch.bfloat16, torch.float8_e4m3fn)):
        q = torch.randn((B, KV * G, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        worst = 0.0
        for kv_len in DECODE_LENS:
            ok, err = allclose(torch, decode_fwd(q, k, v, kv_len),
                               ref.decode_attention_ref(q, k, v, kv_len), TOL["bfloat16"])
            check(ok, f"tensor-core flash-decode disagrees (G={G} D={D} {kv_dt} "
                      f"kv_len={kv_len})")
            worst = max(worst, err)
            n_checks += 1
        print(f"[decode] tensor cores G={G} D={D} cache {kv_dt}, kv_len {DECODE_LENS}: "
              f"max_abs_err {worst:.3e} (tol {TOL['bfloat16']})")
    S, H, D = 32768, 32, 128
    for kv_dt in (torch.bfloat16, torch.float8_e4m3fn):
        q = torch.randn((1, H, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((1, S, KV, D), generator=gen, device=dev).to(kv_dt)
        v = torch.randn((1, S, KV, D), generator=gen, device=dev).to(kv_dt)
        ok, err = allclose(torch, decode_fwd(q, k, v, S), ref.decode_attention_ref(q, k, v, S),
                           TOL["bfloat16"])
        print(f"[decode] tensor cores B=1 H={H} KV={KV} D={D} cache {kv_dt} kv_len={S}: "
              f"max_abs_err {err:.3e} (tol {TOL['bfloat16']})")
        check(ok, "tensor-core flash-decode disagrees on a 32768-slot cache")
        n_checks += 1
    torch.cuda.synchronize()
    check(decode_fwd.launches_mma - n_mma == n_checks,
          "the bf16 / fp8 decode checks did not all run on the tensor cores")


def check_device_kv_len(torch, ref, decode_fwd) -> None:
    """kv_len read from device memory, as the captured decode step passes
    it: bitwise the int form (which the wrapper writes to the device) and
    within the tolerance of the plain version, for both variants and bf16
    and fp8 caches, at 1, around the steps and the splits of the
    capacity-sized grid and at S; then one captured call replayed with the
    device int rewritten between replays, against fresh calls."""
    from repro_torch.kernels import decode_attention as dec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    B, S, H, KV = 4, 1024, 32, 2
    n_sm = dec._sm_count(0)
    for q_dt, kv_dt, D in ((torch.bfloat16, torch.bfloat16, 128),
                           (torch.bfloat16, torch.float8_e4m3fn, 128),
                           (torch.bfloat16, torch.float8_e4m3fn, 64),
                           (torch.float32, torch.bfloat16, 128),
                           (torch.float32, torch.float32, 64)):
        q = torch.randn((B, H, D), generator=gen, device=dev).to(q_dt)
        k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        kind = dec.variant(q_dt, kv_dt, D)
        split_len, n_split = (dec.mma_split_plan(B, KV, dec.n_head_tiles(H, KV), S, n_sm)
                              if kind == "mma" else dec.split_plan(B, KV, S, n_sm))
        lens = sorted({1, 15, 16, 17, split_len - 1, split_len, split_len + 1, 528, S - 1, S})
        tol = TOL[str(q_dt).split(".")[-1]]
        worst = 0.0
        for kv_len in lens:
            want = decode_fwd(q, k, v, kv_len)
            got = decode_fwd(q, k, v, torch.full((1,), kv_len, dtype=torch.int32, device=dev))
            ok, err = allclose(torch, got, ref.decode_attention_ref(q, k, v, kv_len), tol)
            check(torch.equal(got, want), f"flash-decode ({kind}) with a device kv_len={kv_len} "
                                          "is not bitwise its int form")
            check(ok, f"flash-decode ({kind}) with a device kv_len={kv_len} disagrees")
            worst = max(worst, err)
        print(f"[decode] device kv_len, {kind} q {q_dt} cache {kv_dt} D={D}: grid {n_split} "
              f"splits of {split_len} over S={S}; kv_len {lens} bitwise the int form, "
              f"max_abs_err {worst:.3e} (tol {tol})")
    q = torch.randn((B, H, 128), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KV, 128), generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.ones((1,), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_fwd(q, k, k, kv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_fwd(q, k, k, kv)
    lens = (1, 17, 528, 64, 1024, 2, 528)
    for kv_len in lens:
        kv.fill_(kv_len)
        graph.replay()
        check(torch.equal(out, decode_fwd(q, k, k, kv_len)),
              f"a captured flash-decode replayed at kv_len={kv_len} disagrees with a fresh call")
    check(int(dec._COUNTERS[0].abs().sum()) == 0, "flash-decode's tickets are not zero")
    print(f"[decode] one captured call replayed at kv_len {lens} (the device int rewritten "
          "between replays): bitwise fresh calls; tickets zero")


# flash-decode with a length per row: (q dtype, cache dtype, D), both
# variants, f32, bf16 and fp8 caches
PER_ROW_CASES = (("bfloat16", "bfloat16", 128), ("bfloat16", "float8_e4m3fn", 128),
                 ("bfloat16", "bfloat16", 96), ("float32", "float32", 128),
                 ("float32", "float8_e4m3fn", 64), ("float32", "bfloat16", 128))


def check_decode_per_row(torch, ref, decode_fwd) -> None:
    """kv_len as a [B] int32 in device memory, one length per row (as the
    continuous batcher passes it): at mixed lengths (1 and S among them,
    and around a split's edge) within the tolerance of the plain version
    given the same lengths, for both variants and f32, bf16 and fp8
    caches; with every row at one length, bitwise the scalar form."""
    from repro_torch.kernels import decode_attention as dec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    B, S, H, KV = 8, 1024, 32, 2
    n_sm = dec._sm_count(0)
    for q_name, kv_name, D in PER_ROW_CASES:
        q_dt, kv_dt = getattr(torch, q_name), getattr(torch, kv_name)
        q = torch.randn((B, H, D), generator=gen, device=dev).to(q_dt)
        k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        kind = dec.variant(q_dt, kv_dt, D)
        split_len = (dec.mma_split_plan(B, KV, dec.n_head_tiles(H, KV), S, n_sm)[0]
                     if kind == "mma" else dec.split_plan(B, KV, S, n_sm)[0])
        mixes = ([1, S, split_len, split_len + 1, 17, 528, S - 1, 16],
                 [S, 1, 1, 2, 64, 65, 1000, split_len - 1])
        worst = 0.0
        for mix in mixes:
            lens = torch.tensor(mix, dtype=torch.int32, device=dev)
            ok, err = allclose(torch, decode_fwd(q, k, v, lens),
                               ref.decode_attention_ref(q, k, v, lens), TOL[q_name])
            check(ok, f"flash-decode ({kind}) with a length per row {mix} disagrees")
            worst = max(worst, err)
        for L in (1, 17, 528, S):
            want = decode_fwd(q, k, v, L)
            got = decode_fwd(q, k, v, torch.full((B,), L, dtype=torch.int32, device=dev))
            check(torch.equal(got, want), f"flash-decode ({kind}) with every row at {L} is not "
                                          "bitwise the scalar form")
        check(int(dec._COUNTERS[0].abs().sum()) == 0, "flash-decode's tickets are not zero")
        print(f"[decode] a length per row, {kind} q {q_name} cache {kv_name} D={D}, B={B} S={S}: "
              f"mixes {mixes}: max_abs_err {worst:.3e} (tol {TOL[q_name]}); every row at 1, 17, "
              "528, S bitwise the scalar form")


# flash-decode's log-sum-exp (``with_lse``): (q dtype, cache dtype, D) for
# the tensor-core variant and the CUDA-core one in f32 and in bf16
LSE_CASES = (("bfloat16", "bfloat16", 128), ("bfloat16", "float8_e4m3fn", 64),
             ("float32", "float32", 128), ("bfloat16", "bfloat16", 96))


def check_decode_lse(torch, ref, decode_fwd) -> None:
    """Flash-decode's lse, which sharded serving merges the ranks' partials
    by: for both variants, at the int, device and per-row ``kv_len`` (at 1,
    around a split's edge and at S), lse against the plain version's
    within TOL and o with lse asked for bitwise o without it; a row of
    ``kv_len`` 0 or below gives zero o and lse <= -1e29; two half-caches
    merged (``merge_partials``) against the whole cache within TOL."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.models.layers import merge_partials

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    B, S, H, KV = 4, 1024, 32, 2
    n_sm = dec._sm_count(0)
    for q_name, kv_name, D in LSE_CASES:
        q_dt, kv_dt = getattr(torch, q_name), getattr(torch, kv_name)
        q = torch.randn((B, H, D), generator=gen, device=dev).to(q_dt)
        k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        kind = dec.variant(q_dt, kv_dt, D)
        split_len = (dec.mma_split_plan(B, KV, dec.n_head_tiles(H, KV), S, n_sm)[0]
                     if kind == "mma" else dec.split_plan(B, KV, S, n_sm)[0])
        tol = TOL[q_name]
        worst_o = worst_lse = 0.0
        for L in (1, 17, split_len, split_len + 1, 528, S):
            forms = (L, torch.full((1,), L, dtype=torch.int32, device=dev),
                     torch.tensor([L, 1, S, split_len], dtype=torch.int32, device=dev))
            for kv in forms:
                o, lse = decode_fwd(q, k, v, kv, with_lse=True)
                want_o, want_lse = ref.decode_attention_ref(q, k, v, kv, with_lse=True)
                check(torch.equal(o, decode_fwd(q, k, v, kv)),
                      f"flash-decode ({kind}) o with lse is not bitwise o without it (kv_len {L})")
                ok_o, err_o = allclose(torch, o, want_o, tol)
                ok_l, err_l = allclose(torch, lse, want_lse, tol)
                check(ok_o and ok_l, f"flash-decode ({kind}, {q_name}) o or lse disagrees with "
                                     f"the plain version (kv_len {L})")
                worst_o, worst_lse = max(worst_o, err_o), max(worst_lse, err_l)
        lens = torch.tensor([0, -3, 5, S], dtype=torch.int32, device=dev)
        o, lse = decode_fwd(q, k, v, lens, with_lse=True)
        torch.cuda.synchronize()
        empty_ok = (float(o[:2].abs().max()) == 0.0 and float(lse[:2].max()) <= -1e29)
        check(empty_ok, f"flash-decode ({kind}): kv_len 0 or below gives a nonzero o or an lse "
                        "above -1e29")
        h = S // 2
        worst_merge = 0.0
        for L in (1, h, h + 1, 700, S):
            parts = [decode_fwd(q, k[:, s:s + h], v[:, s:s + h],
                                torch.full((1,), L - s, dtype=torch.int32, device=dev),
                                with_lse=True) for s in (0, h)]
            got = merge_partials(torch.stack([p[0] for p in parts]),
                                 torch.stack([p[1] for p in parts]), q_dt)
            ok, err = allclose(torch, got, ref.decode_attention_ref(q, k, v, L), tol)
            check(ok, f"flash-decode ({kind}): two merged half-caches disagree with the whole "
                      f"cache (kv_len {L})")
            worst_merge = max(worst_merge, err)
        print(f"[decode] lse, {kind} q {q_name} cache {kv_name} D={D}: int, device and per-row "
              f"kv_len: o bitwise without lse, max_abs_err o {worst_o:.3e} lse {worst_lse:.3e} "
              f"(tol {tol}); kv_len 0 and -3: o zero, lse {float(lse[:2].max()):.3e}; two "
              f"half-caches merged vs the whole: max_abs_err {worst_merge:.3e}")


def phase_decode(torch, ref, decode_fwd, kv_len_main: int):
    """Check flash-decode at the decode shape for every cache dtype and
    several lengths, with kv_len as an int, in device memory and one per
    row, and its lse; time it at ``kv_len_main``, with and without lse."""
    from repro_torch.kernels.decode_attention import variant

    check_decode_variants(torch, ref, decode_fwd)
    check_device_kv_len(torch, ref, decode_fwd)
    check_decode_per_row(torch, ref, decode_fwd)
    check_decode_lse(torch, ref, decode_fwd)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, S, H, KV, D = 4, 1024, 32, 2, 128
    main_err = 0.0
    for kv_dt in (torch.bfloat16, torch.float32, torch.float8_e4m3fn):
        q_dt = torch.float32 if kv_dt == torch.float32 else torch.bfloat16
        q = torch.randn((B, H, D), generator=gen, device=dev).to(q_dt)
        k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(kv_dt)
        for kv_len in (1, 7, 513, 1024):
            got = decode_fwd(q, k, v, kv_len)
            want = ref.decode_attention_ref(q, k, v, kv_len)
            torch.cuda.synchronize()
            tol = TOL[str(q_dt).split(".")[-1]]
            ok, err = allclose(torch, got, want, tol)
            kind = variant(q_dt, kv_dt, D)
            print(f"[decode] B={B} S={S} H={H} KV={KV} D={D} q {q_dt} cache {kv_dt} "
                  f"kv_len={kv_len} ({kind}): max_abs_err {err:.3e} (tol {tol})")
            check(ok, "flash-decode disagrees with its plain version")
            if kv_dt == torch.bfloat16:
                main_err = max(main_err, err)

    print(f"[decode] serving shape B={B} H={H} KV={KV} D={D}, bf16 query and cache: "
          f"max_abs_err {main_err:.3e} over kv_len 1, 7, 513, 1024")
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    L = kv_len_main
    kv = torch.full((1,), L, dtype=torch.int32, device=dev)  # as the captured step passes it
    ms = graph_ms(torch, lambda: decode_fwd(q, k, v, kv), iters=50)
    lse_ms = graph_ms(torch, lambda: decode_fwd(q, k, v, kv, with_lse=True), iters=50)
    # the int form: the wrapper's fill of the device int, then the kernel
    int_ms = graph_ms(torch, lambda: decode_fwd(q, k, v, L), iters=50)
    # a grid sized by the live length, as when the host passed kv_len: the
    # same call on a cache whose capacity is L
    live_ms = graph_ms(torch, lambda: decode_fwd(q, k[:, :L], v[:, :L], kv), iters=50)
    plain_ms = graph_ms(torch, lambda: ref.decode_attention_ref(q, k, v, L))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = q[:, :, None]
    kt, vt = k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)
    lib_ms = graph_ms(torch, lambda: sdpa(q4, kt, vt, enable_gqa=True), iters=50)
    # what the serving loop pays per call on the host, beside the device time
    wrap_us = host_us(torch, lambda: decode_fwd(q, k, v, L))
    loop_ms = cuda_ms(torch, lambda: decode_fwd(q, k, v, L), iters=200, warmup=20)
    nbytes = 2 * (2 * q.numel() + 2 * B * L * KV * D)
    flops = 4 * B * H * L * D  # bf16 products on the tensor cores (the timed variant)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    rec = {
        "name": "decode_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:59",
        "launches": None, "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }
    print(f"[decode] decode shape B={B} S={S} kv_len={L} H={H} KV={KV} D={D} bf16: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device times, CUDA "
          f"graph); bound {rec['bound_ms'] * 1e3:.2f} us by {rec['bound_by']} ({nbytes} B, "
          f"{flops} FLOP)")
    print(f"[decode] with lse (sharded serving's form): {lse_ms:.4f} ms, without {ms:.4f} ms "
          "(device times, CUDA graph)")
    print(f"[decode] kv_len {L} of S={S} slots: device kv_len {ms:.4f} ms, int kv_len (fill + "
          f"kernel) {int_ms:.4f} ms, a grid sized by kv_len (the cache cut to {L} slots) "
          f"{live_ms:.4f} ms (device times, CUDA graph)")
    print(f"[decode] wrapper on the host: {wrap_us:.2f} us per call; back-to-back calls "
          f"between CUDA events {loop_ms:.4f} ms per call")
    for label, B, S, H, KV, D, L in DECODE_MODEL_SHAPES:
        time_decode_shape(torch, ref, decode_fwd, gen, label, B, S, H, KV, D, L)
    return rec


# the two newest models' decode at their serving sizes, halfway through the
# 32 generated tokens: (label, B, S, H, KV, D, kv_len)
DECODE_MODEL_SHAPES = (
    ("qwen2-vl-2b", 4, 1024, 12, 2, 128, 528),
    ("whisper-large-v3 decoder", 4, 256, 20, 20, 64, 144),
)


def time_decode_shape(torch, ref, decode_fwd, gen, label: str, B: int, S: int, H: int, KV: int,
                      D: int, L: int) -> None:
    """bf16 flash-decode at one shape: on the tensor cores, against its
    plain version at 1, ``L`` and S, then timed with a device kv_len beside
    SDPA over the live keys (device times, CUDA graph), and its bound."""
    from repro_torch.kernels.decode_attention import variant

    dev = torch.device("cuda")
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    check(variant(q.dtype, k.dtype, D) == "mma", f"{label}: flash-decode not on the tensor cores")
    worst = 0.0
    for length in (1, L, S):
        ok, err = allclose(torch, decode_fwd(q, k, v, length),
                           ref.decode_attention_ref(q, k, v, length), TOL["bfloat16"])
        check(ok, f"flash-decode disagrees with its plain version ({label}, kv_len {length})")
        worst = max(worst, err)
    kv = torch.full((1,), L, dtype=torch.int32, device=dev)
    ms = graph_ms(torch, lambda: decode_fwd(q, k, v, kv), iters=50)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, kt, vt = q[:, :, None], k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)
    lib_ms = graph_ms(torch, lambda: sdpa(q4, kt, vt, enable_gqa=True), iters=50)
    nbytes = 2 * (2 * q.numel() + 2 * B * L * KV * D)
    flops = 4 * B * H * L * D
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    print(f"[decode] {label}: B={B} S={S} kv_len={L} H={H} KV={KV} (G={H // KV}) D={D} bf16, "
          f"tensor cores: max_abs_err {worst:.3e} over kv_len 1, {L}, {S} (tol "
          f"{TOL['bfloat16']}); kernel {ms:.5f} ms, sdpa {lib_ms:.5f} ms (device times, CUDA "
          f"graph); bound {max(t_bytes, t_ops) * 1e3:.3f} us by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} ({nbytes} B, {flops} FLOP)")


def phase_gather(torch, ref, gather_fwd):
    """Check the row gather bitwise at the serving shapes and edge cases;
    time it at the prefill and decode shapes.  Returns its JSON record (the
    prefill shape's numbers)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    V, D = 65280, 4096  # chatglm3-6b's padded vocab and width
    table = torch.randn((V, D), generator=gen, device=dev).to(torch.bfloat16)
    cases = [  # label, table, idx
        ("prefill 2048 rows, int64", table, torch.randint(0, V, (2048,), generator=gen, device=dev)),
        ("decode 4 rows, int64", table, torch.randint(0, V, (4,), generator=gen, device=dev)),
        ("decode 4 rows, int32", table,
         torch.randint(0, V, (4,), generator=gen, device=dev, dtype=torch.int32)),
        ("repeated rows and the last row", table, torch.tensor([V - 1, 7, 7, 0, V - 1], device=dev)),
        ("f32 D=130, int64", torch.randn((16, 130), generator=gen, device=dev),
         torch.tensor([15, 3, 3, 0, 9], device=dev)),
        ("f32 D=130, int32", torch.randn((16, 130), generator=gen, device=dev),
         torch.tensor([15, 3, 3, 0, 9], device=dev, dtype=torch.int32)),
        ("bf16 D=1", torch.randn((7, 1), generator=gen, device=dev).to(torch.bfloat16),
         torch.tensor([6, 0, 6, 2], device=dev)),
    ]
    main_err = 0.0
    for label, tab, idx in cases:
        got = gather_fwd(tab, idx)
        want = ref.prefetch_gather_ref(tab, idx)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        same = got.dtype == want.dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        print(f"[gather] {label}: table {tuple(tab.shape)} {tab.dtype}, idx {idx.dtype}: "
              f"bitwise equal {same}, max_abs_err {err:.3e} (tol 0)")
        check(same, "the row gather disagrees with its plain version")
        main_err = max(main_err, err)

    out = {}
    for label, rows in (("prefill", 2048), ("decode", 4)):
        # a fresh index set for each of the 50 captured calls: their rows
        # (50 x 16.8 MB at the prefill shape) do not stay in the 50 MB L2,
        # so each call finds most of its rows cold, as a serving step does
        idxs = [torch.randint(0, V, (rows,), generator=gen, device=dev) for _ in range(50)]

        def cycling(f):
            it = itertools.cycle(idxs)
            return lambda: f(table, next(it))

        ms = graph_ms(torch, cycling(gather_fwd), iters=50)
        plain_ms = graph_ms(torch, cycling(ref.prefetch_gather_ref), iters=50)
        lib_ms = graph_ms(torch, cycling(lambda t, i: torch.index_select(t, 0, i)), iters=50)
        nbytes = 2 * rows * D * table.element_size() + rows * idxs[0].element_size()
        bound = nbytes / HBM_BPS * 1e3
        out[label] = (ms, plain_ms, lib_ms, bound)
        print(f"[gather] {label} shape: {rows} rows of {D} bf16 from {V}, a new index set per "
              f"call: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, index_select {lib_ms:.5f} ms "
              f"(device times, CUDA graph); bound {bound * 1e3:.3f} us by bytes ({nbytes} B)")
    ms, plain_ms, lib_ms, bound = out["prefill"]
    return {
        "name": "prefetch_gather_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prefetch_gather.cu",
        "replaces": "src/repro/kernels/prefetch_gather.py:30",
        "launches": None, "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
    }


def path_logits(torch, cfg, impl: str, params, batch, tokens, max_len: int):
    """Logits [B, T, vocab] of the path ``attn_impl=impl``, fed the prompt
    and then ``tokens[:, :-1]`` one decode step at a time."""
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    c = cfg.replace(attn_impl=impl)
    model, prefill_fn = make_prefill_step(c, "cuda")
    prompt = model.prompt_shape(batch)[1]
    _, decode_fn = make_decode_step(c, "cuda")
    logits, cache = prefill_fn(params, batch)
    cache = Server(c, "cuda", max_len)._pad_cache(cache)
    steps = [logits]
    for i in range(tokens.shape[1] - 1):
        logits, cache = decode_fn(params, cache, tokens[:, i : i + 1], prompt + i)
        steps.append(logits)
    return torch.cat(steps, dim=1)


def teacher_forced(torch, cfg, params, batch, tokens, max_len: int, plain: str = "chunked"):
    """Logits [B, T, vocab] of the kernel path (``attn_impl="pallas"``) and
    the plain path (``plain``), each fed the prompt and then
    ``tokens[:, :-1]`` one decode step at a time."""
    return tuple(path_logits(torch, cfg, impl, params, batch, tokens, max_len)
                 for impl in ("pallas", plain))


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want| / max |want|, rms(got - want) / rms(want))."""
    d = (got - want).float()
    return (float(d.abs().max() / want.abs().max()),
            float(d.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()))


def check_paths(torch, label, cfg, kern, plain, tol, plain_impl="chunked",
                tag="slice") -> None:
    B, T = kern.shape[:2]
    check(tuple(kern.shape) == (B, T, cfg.vocab_size), f"logits {tuple(kern.shape)}")
    check(bool(torch.isfinite(kern).all()), f"{label}: non-finite logits on the kernel path")
    check(bool(torch.isfinite(plain).all()), f"{label}: non-finite logits on the plain path")
    rel, rms = rel_err(torch, kern, plain)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"[{tag}] {label}: kernel path vs plain {plain_impl} path, prefill + {T - 1} steps "
          f"teacher-forced: max |logit diff| / max |logit| {rel:.4e} (tol {tol}), "
          f"relative rms {rms:.4e}, top-1 agreement {agree:.4f}")
    check(rel <= tol, f"{label}: kernel path logits disagree with the plain path")


def check_head(torch, model, params, B: int) -> None:
    """``Model.logits`` on the card against widening both operands to f32,
    at the serving loop's shape [B, 1, d_model]; both timed on the device."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = torch.randn((B, 1, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]

    def widened():
        return h.float() @ w.float()

    got, want = model.logits(params, h), widened()
    rel, _ = rel_err(torch, got, want)
    gemm_ms = graph_ms(torch, lambda: model.logits(params, h))
    wide_ms = graph_ms(torch, widened)
    print(f"[slice] head {tuple(w.shape)} {w.dtype} at B={B}: bf16 GEMM with f32 output "
          f"{gemm_ms:.4f} ms, widened to f32 {wide_ms:.4f} ms (device times, CUDA graph); "
          f"max |diff| / max |logit| {rel:.4e} (tol {HEAD_REL_TOL})")
    check(got.dtype == torch.float32, f"logits dtype {got.dtype}")
    check(rel <= HEAD_REL_TOL, "the head's bf16 GEMM disagrees with the widened f32 product")


def profile_run(torch, label: str, fn, watch: tuple = ()):
    """Device busy share over one ``fn()``: the CUDA kernel times
    torch.profiler records against the host clock (the profiler's own
    overhead lengthens the wall time), the ten kernels with the most
    device time, and any other kernel whose name contains one of
    ``watch``.  Returns the busy share (None if not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us, ev.count, ev.key))
    busy_us = sum(r[0] for r in rows)
    if busy_us == 0:
        print("[profile] device time: not measured (the profiler recorded no CUDA kernel)")
        return None
    print(f"[profile] {label} under torch.profiler: wall {wall_us / 1e3:.3f} ms, "
          f"CUDA kernels {busy_us / 1e3:.3f} ms, busy share {busy_us / wall_us:.4f}")
    for i, (dev_us, count, key) in enumerate(sorted(rows, reverse=True)):
        if i < 10 or any(w in key for w in watch):
            print(f"[profile]   {dev_us / 1e3:9.3f} ms  {count:6d} x  {key[:100]}")
    return busy_us / wall_us


# a wrapper's launch count, and flash-decode's per variant (tensor cores, CUDA cores)
LAUNCH_COUNTS = ("launches", "launches_mma", "launches_simt")


def time_serve(torch, server, params, batch, gen_tokens: int, counters: dict,
               tag: str) -> dict:
    """Serve ``batch`` as a user would, through ``server.generate`` (the
    prefill, then one captured decode step replayed per token: the main
    path) and, beside it in the same call, ``server.generate_eager`` (every
    decode step launched from the host).  A 4-token warm-up of each (the
    capture, cuBLAS handles, the allocator), the prefill alone three times,
    then ``gen_tokens`` tokens four times per path in the order eager,
    graph, graph, eager, eager, graph, graph, eager: the host moves the
    eager decode from call to call, hence the medians.  The launch counters
    are zeroed just before the first graph run and read just after it, and
    likewise around the first eager run, which must count the same; the
    peak memory is each first run's.  Then one run of each with the logits
    of every step (tokens and logits bitwise equal), each path's busy share
    of generate(8) under torch.profiler, and the captured step's device
    time, replayed back to back between CUDA events."""
    paths = {"eager": server.generate_eager, "graph": server.generate}
    B, S = server.model.prompt_shape(batch)
    name = server.cfg.name

    def timed(path: str, steps: int):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = paths[path](params, batch, steps)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    for p in paths:
        timed(p, 4)
    prefill_s = sorted(timed("eager", 1)[1] for _ in range(3))[1]
    totals = {p: [] for p in paths}
    launched, by_variant, peak = {}, {}, {}
    tokens = None
    for p in ("eager", "graph", "graph", "eager") * 2:
        first = p not in launched
        if first:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                for attr in LAUNCH_COUNTS:
                    if hasattr(c, attr):
                        setattr(c, attr, 0)
        out, secs = timed(p, gen_tokens)
        totals[p].append(secs)
        if first:
            launched[p] = {n: c.launches for n, c in counters.items()}
            by_variant[p] = {f"{n}.{a}": getattr(c, a) for n, c in counters.items()
                             for a in LAUNCH_COUNTS[1:] if hasattr(c, a)}
            peak[p] = torch.cuda.max_memory_allocated()
        if p == "graph" and tokens is None:
            tokens = out
    check(launched["graph"] == launched["eager"] and by_variant["graph"] == by_variant["eager"],
          f"{name}: the captured decode counted {launched['graph']}, the eager loop "
          f"{launched['eager']}")
    tg, lg = server.generate(params, batch, gen_tokens, with_logits=True)
    te, le = server.generate_eager(params, batch, gen_tokens, with_logits=True)
    check(torch.equal(tg, tokens), f"{name}: the captured decode's tokens change between runs")
    check(torch.equal(tg, te), f"{name}: the captured decode's tokens differ from the eager loop's")
    check(torch.equal(lg, le), f"{name}: the captured decode's logits are not bitwise the eager "
                               "loop's")
    print(f"[{tag}] captured decode against the eager loop, {gen_tokens} tokens: tokens equal, "
          f"logits [B, {gen_tokens}, vocab] bitwise equal; launches in each first run equal: "
          f"{launched['graph']}")
    del lg, le
    busy = {p: profile_run(torch, f"{name} {p} generate(8 tokens)",
                           lambda p=p: paths[p](params, batch, 8)) for p in paths}
    # the captured step alone: replays back to back (no host work between
    # them beyond the launch of the graph), from the prompt's position
    step = server.captured_decode(params, B)
    with torch.inference_mode():  # the static buffers are inference tensors
        step.pos.fill_(S)
    n = gen_tokens - 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        step.replay()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    print(f"[{tag}] B={B} prompt={S} generated={gen_tokens} max_len={server.max_len} "
          f"{server.cfg.compute_dtype}: prefill {prefill_s * 1e3:.3f} ms (median of 3)")
    decode = {}
    for p in ("eager", "graph"):
        ts = sorted(totals[p])
        total_s = statistics.median(ts)
        decode[p] = (total_s - prefill_s) / (gen_tokens - 1) * 1e3
        b = busy[p]
        print(f"[{tag}] {p}: decode {decode[p]:.3f} ms/token step, "
              f"{B * gen_tokens / total_s:.1f} tokens/s end to end ({total_s:.3f} s, median of "
              f"{', '.join(f'{t:.3f}' for t in totals[p])} s in the order run), peak memory "
              f"{peak[p]} B, busy share of generate(8) "
              f"{'not measured' if b is None else f'{b:.4f}'}")
    print(f"[{tag}] captured step replayed back to back: {step_ms:.4f} ms per step (device, "
          f"CUDA events); {step_ms / decode['graph']:.4f} of the graph path's decode step, "
          f"{step_ms / decode['eager']:.4f} of the eager one's; eager / graph decode "
          f"{decode['eager'] / decode['graph']:.3f}")
    return {"tokens": tokens, "launched": launched["graph"], "by_variant": by_variant["graph"],
            "prefill_ms": prefill_s * 1e3, "step_ms": step_ms}


def _launched_once(torch, fn) -> dict:
    """{kernel wrapper: launches} of one call of ``fn`` (the counters'
    ``since`` around it, the card synced)."""
    from repro_torch.kernels import counters

    before = counters.snapshot()
    fn()
    torch.cuda.synchronize()
    return {w.__name__: n for (w, attr), n in counters.since(before).items()
            if attr == "launches"}


def phase_slice(torch, flash_fwd, decode_fwd, gather_fwd, B: int, prompt: int,
                gen_tokens: int, max_len: int, cost_cells: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch

    dev = torch.device("cuda")
    cfg = get_config("chatglm3_6b").replace(attn_impl="pallas")
    server = Server(cfg, device="cuda", max_len=max_len)
    model = server.model
    t0 = time.perf_counter()
    params = model.compute_params(model.init_params(seed=0))  # bf16 weights, f32 dropped
    torch.cuda.synchronize()
    print(f"[slice] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, "
          f"{cfg.param_count()} params; f32 init and {cfg.compute_dtype} cast in "
          f"{time.perf_counter() - t0:.3f} s")
    batch = concrete_batch(cfg, B, prompt, device=dev)
    batch.pop("targets")
    check_head(torch, model, params, B)

    run = time_serve(torch, server, params, batch, gen_tokens,
                     {"flash": flash_fwd, "decode": decode_fwd, "gather": gather_fwd}, "slice")
    tokens = run["tokens"]
    n_flash, n_decode, n_gather = (run["launched"][k] for k in ("flash", "decode", "gather"))
    decode_steps = gen_tokens - 1
    n_mma, n_simt = (run["by_variant"][f"decode.{a}"] for a in LAUNCH_COUNTS[1:])
    print(f"[slice] launches in the first graph run: flash_attention_fwd {n_flash} "
          f"(want {cfg.n_layers}), decode_attention_fwd {n_decode} "
          f"(want {cfg.n_layers * decode_steps}; tensor cores {n_mma}, CUDA cores {n_simt}), "
          f"prefetch_gather_fwd {n_gather} (want {1 + decode_steps})")
    check(n_mma == cfg.n_layers * decode_steps,
          "the bf16 decode did not run the tensor-core flash-decode once per layer per step")
    check(tuple(tokens.shape) == (B, gen_tokens), f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token out of range")
    check(n_flash == cfg.n_layers, "the prefill did not run flash-attention once per layer")
    check(n_decode == cfg.n_layers * decode_steps,
          "the decode did not run flash-decode once per layer per step")
    check(n_gather == 1 + decode_steps,
          "the serve did not run the row gather once per prefill and once per decode step")
    # [cost]: the launches of one real step of each serving cell, and its time
    step = server.captured_decode(params, B)
    with torch.inference_mode():
        step.pos.fill_(prompt + gen_tokens // 2 - 1)  # kv_len 528, the kernel rows' length
        cost_cells["decode"] = {"launches": _launched_once(torch, step.replay),
                                "ms": run["step_ms"]}
        cost_cells["prefill"] = {"launches": _launched_once(
            torch, lambda: server.prefill_fn(params, batch)), "ms": run["prefill_ms"]}

    # the plain path, teacher-forced on the kernel path's tokens, in bf16
    # and (same weights from the same seed, not cast) in f32
    kern16, plain16 = teacher_forced(torch, cfg, params, batch, tokens, max_len)
    check(torch.equal(kern16.argmax(-1), tokens), "replayed kernel path disagrees with generate")
    check_paths(torch, "bf16 compute", cfg, kern16, plain16, LOGITS_REL_TOL_BF16)
    del params
    cfg2 = cfg.replace(n_layers=2)
    model2 = Server(cfg2, device="cuda", max_len=max_len).model
    kern2, plain2 = teacher_forced(torch, cfg2, model2.compute_params(model2.init_params(seed=0)),
                                   batch, tokens, max_len, plain="naive")
    check_paths(torch, "bf16 compute, depth 2", cfg2, kern2, plain2,
                LOGITS_REL_TOL_BF16_DEPTH2, plain_impl="naive")
    cfg32 = cfg.replace(compute_dtype="float32")
    decode_fwd.launches_mma = decode_fwd.launches_simt = 0
    kern32, plain32 = teacher_forced(torch, cfg32, model.init_params(seed=0), batch, tokens,
                                     max_len)
    n_f32 = cfg.n_layers * (tokens.shape[1] - 1)
    print(f"[slice] f32 check: flash-decode on the CUDA cores {decode_fwd.launches_simt} "
          f"(want {n_f32}), on the tensor cores {decode_fwd.launches_mma} (want 0)")
    check(decode_fwd.launches_simt == n_f32 and decode_fwd.launches_mma == 0,
          "the f32 decode did not run the CUDA-core flash-decode")
    check_paths(torch, "f32 compute", cfg32, kern32, plain32, LOGITS_REL_TOL_F32)
    for label, got in (("kernel", kern16), ("plain chunked", plain16)):
        rel, rms = rel_err(torch, got, kern32)
        print(f"[slice] bf16 {label} path vs the f32 kernel path: max |logit diff| / max "
              f"|logit| {rel:.4e}, relative rms {rms:.4e}")
    return {"flash_attention_fwd": n_flash, "decode_attention_fwd": n_decode,
            "prefetch_gather_fwd": n_gather}


# the continuous batcher's traffic on chatglm3-6b: slots, cache slots,
# requests; prompt lengths uniform in 100-512 (every batch-1 prefill on the
# flash forward, which masks ragged edges); max_new_tokens uniform in
# 16-128, no EOS; all from seed 0
BATCHER_SLOTS, BATCHER_MAX_LEN, BATCHER_REQUESTS = 8, 1024, 24


def batcher_traffic(vocab: int, n: int = BATCHER_REQUESTS, seed: int = 0) -> list:
    """[(prompt [S] int64, max_new_tokens)] in arrival order."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lens = [int(rng.randint(100, 513)) for _ in range(n)]
    return [(rng.randint(0, vocab, size=L).astype(np.int64), int(rng.randint(16, 129)))
            for L in lens]


def drive_batcher(torch, batcher, traffic, *, logits: bool = False, forced: dict = None) -> dict:
    """Submit ``traffic`` and step ``batcher`` until it drains, as
    ``run_until_drained`` does, timing on the host clock each admission
    (it ends in a read of its first token, which waits for the device) and
    each tick with every slot busy and no admission (it ends in the read of
    the next tokens).  With ``logits``, every tick's logits are kept; with
    ``forced`` ({rid: tokens}), every request is fed those tokens in place of
    its own (teacher forcing: the schedule depends on ``max_new_tokens``
    alone, so it is the same).  Returns the outputs by rid, the seconds,
    the ticks' logits and each full tick's (tokens, lens)."""
    from repro_torch.runtime.scheduler import Request

    reqs = [Request(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(traffic)]
    admit_s, full_s, full_at, ticks = [], [], [], []
    real = batcher._admit_one

    def admit_one(i, slot, req):
        t = time.perf_counter()
        real(i, slot, req)
        admit_s.append(time.perf_counter() - t)
        if forced is not None:
            req.output[:] = forced[req.rid][: len(req.output)]

    batcher._admit_one = admit_one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    while batcher.queue or any(s.busy for s in batcher.slots):
        n_admit = len(admit_s)
        full = all(s.busy for s in batcher.slots)
        if full:
            at = ([[s.req.output[-1]] for s in batcher.slots], [s.pos for s in batcher.slots])
        t = time.perf_counter()
        batcher.step()
        if full and len(admit_s) == n_admit:
            full_s.append(time.perf_counter() - t)
            full_at.append(at)
        if logits:
            ticks.append(batcher.logits.clone())
        if forced is not None:
            for r in reqs:
                r.output[:] = forced[r.rid][: len(r.output)]
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    del batcher._admit_one
    check(len(batcher.finished) == len(reqs), "the batcher did not finish every request")
    return {"outputs": {r.rid: list(r.output) for r in reqs}, "total_s": total,
            "admit_s": admit_s, "full_s": full_s, "full_at": full_at, "ticks": ticks,
            "steps": batcher.steps}


def check_batcher_sequential(torch) -> None:
    """chatglm3's smoke config in f32 through the batcher on the card (4
    slots, a 1024-slot cache: flash-decode's CUDA-core variant with a length
    per row), against each prompt served alone by ``Server.generate_eager``
    (batch 1, the scalar length): every request's tokens equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server
    from repro_torch.runtime.scheduler import ContinuousBatcher

    cfg = get_smoke_config("chatglm3_6b").replace(compute_dtype="float32", attn_impl="pallas")
    server = Server(cfg, device="cuda", max_len=BATCHER_MAX_LEN)
    params = server.model.compute_params(server.model.init_params(seed=0))
    traffic = [(p, n // 4) for p, n in batcher_traffic(cfg.vocab_size, n=8, seed=1)]
    batcher = ContinuousBatcher(server.model, params, batch_size=4, max_len=BATCHER_MAX_LEN)
    run = drive_batcher(torch, batcher, traffic)
    for rid, (p, _) in enumerate(traffic):
        got = run["outputs"][rid]
        alone = server.generate_eager(params, {"inputs": torch.from_numpy(p[None]).cuda()},
                                      len(got))
        check(alone[0].tolist() == got, f"batcher request {rid} (prompt {len(p)}) differs from "
                                        "its prompt served alone")
    print(f"[batcher] {cfg.name} f32, 4 slots, cache {BATCHER_MAX_LEN}, {len(traffic)} requests "
          f"(prompts {[len(p) for p, _ in traffic]}): every request's tokens equal its prompt "
          f"served alone by Server.generate_eager ({run['steps']} ticks)")


def phase_batcher(torch, counters: dict, smi: str) -> dict:
    """chatglm3-6b at full width and depth (bf16 weights from seed 0,
    ``attn_impl="pallas"``) behind ``runtime.scheduler.ContinuousBatcher``:
    BATCHER_REQUESTS requests through BATCHER_SLOTS slots of a
    BATCHER_MAX_LEN-slot cache (``batcher_traffic``).  The captured batcher
    (the main path) and the eager one are timed in turns graph, eager,
    eager, graph; the launch counters are zeroed just before the first
    captured run and read just after it, and must show flash-decode once per
    layer per tick, the flash forward once per layer per admission and the
    gather once per admission and per
    tick.  Then the captured run's logits bitwise the eager run's, tick by
    tick; the plain masked path (``attn_impl="chunked"``) teacher-forced on
    the kernel path's tokens within LOGITS_REL_TOL_BF16; no host sync in a
    captured tick; the busy share of a captured run; the replayed step's
    device time against its byte bound; per-row flash-decode at the live
    lengths beside SDPA with the same mask; and the smoke config in f32
    against each prompt served alone.  Returns the captured run's launch
    counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models.common import tree_items
    from repro_torch.models.model import Model
    from repro_torch.runtime.scheduler import ContinuousBatcher

    t_phase = time.perf_counter()
    B, max_len = BATCHER_SLOTS, BATCHER_MAX_LEN
    cfg = get_config("chatglm3_6b").replace(attn_impl="pallas")
    model = Model(cfg, device="cuda")
    params = model.compute_params(model.init_params(seed=0))
    traffic = batcher_traffic(cfg.vocab_size)
    prompts = [len(p) for p, _ in traffic]
    n_new = sum(n for _, n in traffic)
    print(f"[batcher] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {B} slots, cache "
          f"{max_len}, {len(traffic)} requests from seed 0: prompts {prompts}, max_new_tokens "
          f"{[n for _, n in traffic]} (sum {n_new}), no EOS")

    def zero():
        for c in counters.values():
            for attr in LAUNCH_COUNTS:
                if hasattr(c, attr):
                    setattr(c, attr, 0)

    runs = {"graph": [], "eager": []}
    launched = {}
    for kind in ("graph", "eager", "eager", "graph"):
        batcher = ContinuousBatcher(model, params, B, max_len, captured=kind == "graph")
        first = kind not in launched
        if first:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero()
        run = drive_batcher(torch, batcher, traffic)
        if first:
            launched[kind] = {f"{n}.{a}": getattr(c, a) for n, c in counters.items()
                              for a in LAUNCH_COUNTS if hasattr(c, a)}
            run["peak"] = torch.cuda.max_memory_allocated()
        runs[kind].append(run)
        del batcher
    g0 = runs["graph"][0]
    ticks, n_tokens = g0["steps"], sum(len(o) for o in g0["outputs"].values())
    for kind in ("graph", "eager"):
        for run in runs[kind]:
            check(run["outputs"] == g0["outputs"], f"the {kind} batcher's tokens differ")
            check(run["steps"] == ticks, f"the {kind} batcher took {run['steps']} ticks")
    check(launched["graph"] == launched["eager"],
          f"the captured batcher counted {launched['graph']}, the eager one {launched['eager']}")
    got = launched["graph"]
    want = {"decode_attention_fwd.launches": ticks * cfg.n_layers,
            "decode_attention_fwd.launches_mma": ticks * cfg.n_layers,
            "flash_attention_fwd.launches": len(traffic) * cfg.n_layers,
            "prefetch_gather_fwd.launches": len(traffic) + ticks}
    print(f"[batcher] launches in the first captured run: "
          f"{ {k: got.get(k) for k in want} } (want {want}) ({smi})")
    for k, n in want.items():
        check(got.get(k) == n, f"the batcher launched {k} {got.get(k)} times, want {n}")
    check(n_tokens == n_new, f"{n_tokens} tokens generated, {n_new} asked for")
    print(f"[batcher] {len(traffic)} requests, {n_tokens} tokens generated; {ticks} engine ticks "
          f"against {n_new} (the sum of max_new_tokens) ({smi})")
    admit = sorted(a for run in runs["graph"] + runs["eager"] for a in run["admit_s"])
    print(f"[batcher] admission (batch-1 prefill and slot hand-off): median "
          f"{statistics.median(admit) * 1e3:.3f} ms, max {admit[-1] * 1e3:.3f} ms over "
          f"{len(admit)} admissions ({smi})")
    out = {}
    for kind in ("graph", "eager"):
        full = [t for run in runs[kind] for t in run["full_s"]]
        totals = [run["total_s"] for run in runs[kind]]
        out[kind] = statistics.median(full) * 1e3
        print(f"[batcher] {kind}: decode {out[kind]:.3f} ms per tick (median of {len(full)} "
              f"ticks with all {B} slots busy), {n_tokens / statistics.median(totals):.1f} "
              f"tokens/s end to end ({', '.join(f'{t:.3f}' for t in totals)} s in the order "
              f"run), peak memory {runs[kind][0]['peak']} B ({smi})")
    print(f"[batcher] eager / graph decode per tick {out['eager'] / out['graph']:.3f}")

    # the captured run's logits bitwise the eager run's, tick by tick
    logs = {}
    for kind in ("graph", "eager"):
        batcher = ContinuousBatcher(model, params, B, max_len, captured=kind == "graph")
        logs[kind] = drive_batcher(torch, batcher, traffic, logits=True)
        del batcher
    check(logs["graph"]["outputs"] == g0["outputs"], "the captured batcher's tokens changed")
    check(all(torch.equal(a, b) for a, b in zip(logs["graph"]["ticks"], logs["eager"]["ticks"]))
          and len(logs["graph"]["ticks"]) == ticks,
          "the captured batcher's logits are not bitwise the eager batcher's")
    print(f"[batcher] captured against eager: logits [{B}, 1, vocab] of all {ticks} ticks bitwise "
          "equal, tokens equal")
    del logs["eager"]

    # the plain masked path, teacher-forced on the kernel path's tokens
    plain_model = Model(cfg.replace(attn_impl="chunked"), device="cuda")
    plain = drive_batcher(torch, ContinuousBatcher(plain_model, params, B, max_len, captured=False),
                          traffic, logits=True, forced=g0["outputs"])
    kern = torch.cat(logs["graph"]["ticks"], dim=1)
    want_l = torch.cat(plain["ticks"], dim=1)
    del logs, plain
    check(bool(torch.isfinite(kern).all()), "non-finite logits on the batcher's kernel path")
    check(bool(torch.isfinite(want_l).all()), "non-finite logits on the batcher's plain path")
    rel, rms = rel_err(torch, kern, want_l)
    agree = float((kern.argmax(-1) == want_l.argmax(-1)).float().mean())
    print(f"[batcher] kernel path (flash forward, flash-decode per row) vs the plain path "
          f"(chunked prefill, masked decode), {ticks} ticks teacher-forced: max |logit diff| / "
          f"max |logit| {rel:.4e} (tol {LOGITS_REL_TOL_BF16}), relative rms {rms:.4e}, top-1 "
          f"agreement {agree:.4f}")
    check(rel <= LOGITS_REL_TOL_BF16, "the batcher's kernel path disagrees with the plain path")
    del kern, want_l

    # no host sync in a captured tick; its device time replayed back to back
    batcher = ContinuousBatcher(model, params, B, max_len)
    toks, lens = g0["full_at"][len(g0["full_at"]) // 2]
    toks, lens = np.array(toks, np.int64), np.array(lens, np.int64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            batcher._replay(toks, lens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(batcher._graph.logits).all()), "non-finite batcher logits")
    print("[batcher] one captured tick (copies in, replay) under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync")
    g = batcher._graph
    n = 50
    with torch.inference_mode():
        g.pos.copy_(torch.from_numpy(lens))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            g.replay()  # each replay moves every slot on by one position
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    weights = sum(t.numel() * t.element_size() for p, t in tree_items(params) if p != "embed")
    weights += B * cfg.d_model * params["embed"].element_size()  # the gathered rows
    live = int(lens.sum()) + B * (1 + (n - 1) / 2)  # mean kv_len over the replays, summed
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * model.kv_dtype().itemsize * live
    bound_ms = (weights + kv_bytes) / HBM_BPS * 1e3
    print(f"[batcher] replayed tick at slot positions {lens.tolist()} (+0..{n - 1}): "
          f"{step_ms:.4f} ms per tick (device, CUDA events), {step_ms / out['graph']:.4f} of the "
          f"captured tick on the host clock; byte bound {bound_ms:.4f} ms ({weights} B of "
          f"weights, {kv_bytes:.0f} B of live cache at 3.35 TB/s) ({smi})")
    del batcher, g
    batcher = ContinuousBatcher(model, params, B, max_len)  # captured before the profile
    busy = profile_run(torch, f"{cfg.name} captured batcher, {len(traffic)} requests",
                       lambda: drive_batcher(torch, batcher, traffic))
    del batcher
    print(f"[batcher] busy share of a captured run: "
          f"{'not measured' if busy is None else f'{busy:.4f}'} ({smi})")

    # per-row flash-decode at the phase's live lengths, beside SDPA given the
    # same boolean per-row mask
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, max_len, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, max_len, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    kv_len = torch.from_numpy(lens + 1).to(device=dev, dtype=torch.int32)
    decode_fwd = counters["decode_attention_fwd"]
    ok, err = allclose(torch, decode_fwd(q, k, v, kv_len),
                       ref.decode_attention_ref(q, k, v, kv_len), TOL["bfloat16"])
    check(ok, "flash-decode with a length per row disagrees at the batcher's lengths")
    ms = graph_ms(torch, lambda: decode_fwd(q, k, v, kv_len), iters=50)
    plain_ms = graph_ms(torch, lambda: ref.decode_attention_ref(q, k, v, kv_len))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(max_len, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = graph_ms(torch, lambda: sdpa(q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
                      iters=50)
    nbytes = 2 * (2 * q.numel() + 2 * int(kv_len.sum()) * KV * D)
    flops = 4 * H * int(kv_len.sum()) * D
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    print(f"[batcher] flash-decode with a length per row, B={B} S={max_len} kv_len "
          f"{kv_len.tolist()} H={H} KV={KV} D={D} bf16: kernel {ms:.5f} ms, plain {plain_ms:.5f} "
          f"ms, sdpa with the per-row mask {lib_ms:.5f} ms (device times, CUDA graph); bound "
          f"{max(t_bytes, t_ops) * 1e3:.3f} us by {'bytes' if t_bytes >= t_ops else 'operations'} "
          f"({nbytes} B, {flops} FLOP); max_abs_err {err:.3e} ({smi})")
    del params, model, plain_model, q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    check_batcher_sequential(torch)
    print(f"[batcher] phase {time.perf_counter() - t_phase:.1f} s")
    return {n: got[f"{n}.launches"] for n in ("decode_attention_fwd", "flash_attention_fwd",
                                              "prefetch_gather_fwd")}


def _link_gbps(torch, store, paths, lanes: int) -> tuple[float, float]:
    """(host->device GB/s, mean fetches in flight) of one fetch of each of
    ``paths`` spread over ``lanes`` threads, each copying on its own stream
    and waiting on its own event.  Fetches in flight near ``lanes`` mean the
    waits overlap (the event wait releases the GIL); near 1, that the lanes
    ran one after another."""
    from concurrent.futures import ThreadPoolExecutor

    spans = []

    def fetch(p):
        t0 = time.perf_counter()
        out = store.fetch(p)
        spans.append(time.perf_counter() - t0)
        return out.nbytes

    with ThreadPoolExecutor(max_workers=lanes) as pool:
        list(pool.map(store.fetch, paths[:lanes]))  # each lane's stream, warmed
        torch.cuda.synchronize()
        spans.clear()
        t = time.perf_counter()
        nbytes = sum(pool.map(fetch, paths))
        dt = time.perf_counter() - t
    return nbytes / dt / 1e9, sum(spans) / dt


def phase_stream(torch, counters: dict, B: int, prompt: int, max_len: int) -> dict:
    """chatglm3-6b's decode weights streamed from pinned host memory, in
    every registered mode, against the resident decode.  Returns the
    numbers per mode."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch
    from repro_torch.runtime.prefetch import HostParamStore, WeightStreamer

    cfg = get_config("chatglm3_6b").replace(attn_impl="pallas")
    server = Server(cfg, device="cuda", max_len=max_len)
    t = time.perf_counter()
    plan = server.plan(B)
    plan_s = time.perf_counter() - t
    groups = [[r.path for r in g] for g in plan.groups()]
    colls = sorted(r.path for r in plan.collections())
    print(f"[stream] access plan of one decode step (B={B}, max_len {max_len}, traced on the "
          f"meta device in {plan_s:.3f} s): {len(plan.records)} records, {len(colls)} "
          f"collections, {len(groups)} groups {[len(g) for g in groups]}, "
          f"{plan.total_bytes} B predicted (f32 parameters)")
    print(f"[stream] hints: {plan.hints()}")
    check(len(plan.records) == 15 and len(colls) == 12 and len(groups) == 4,
          "the plan is not JAX's 15 records, 12 collections and 4 groups")
    check(groups[0] == ["embed"] and sorted(groups[1]) == colls
          and groups[2] == ["final_norm"] and groups[3] == ["lm_head"],
          f"the plan's groups are not JAX's order (embed, layers, final_norm, lm_head): {groups}")

    model = server.model
    params = model.compute_params(model.init_params(seed=0))  # bf16 weights
    batch = concrete_batch(cfg, B, prompt, device="cuda")
    batch.pop("targets")
    logits, cache = server.prefill_fn(params, batch)
    cache = server._pad_cache(cache)
    tok0 = torch.argmax(logits, dim=-1)

    def clone(c):
        return {k: v.clone() for k, v in c.items()}

    resident, res_cache, tok, res_ms = [], clone(cache), tok0, []
    for i in range(STREAM_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, res_cache = server.decode_fn(params, res_cache, tok, prompt + i)
        torch.cuda.synchronize()
        res_ms.append((time.perf_counter() - t) * 1e3)
        tok = torch.argmax(logits, dim=-1)
        resident.append((logits, tok))
    del res_cache
    print(f"[stream] resident decode, {STREAM_STEPS} steps from the prefill (B={B}, prompt "
          f"{prompt}): {', '.join(f'{m:.3f}' for m in res_ms)} ms per step")

    t = time.perf_counter()
    store = HostParamStore(params, device="cuda")
    pin_s = time.perf_counter() - t
    data = sum(store.nbytes(p) for p in store.arrays)
    print(f"[stream] HostParamStore(device='cuda'): {len(store.arrays)} leaves, {data} B of "
          f"{cfg.compute_dtype} weights in {store.pinned_bytes} B of pinned host memory, "
          f"copied and pinned in {pin_s:.3f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    largest = max(store.arrays, key=store.nbytes)
    one = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = store.fetch(largest)
        one.append(store.nbytes(largest) / (time.perf_counter() - t) / 1e9)
        del out
    paths = sorted(store.arrays, key=store.nbytes, reverse=True)
    lanes = {n: _link_gbps(torch, store, paths, n) for n in (1, 8)}
    link = max(one)
    print(f"[stream] link ceiling: one fetch of the largest leaf ({largest}, "
          f"{store.nbytes(largest)} B) {', '.join(f'{g:.3f}' for g in one)} GB/s host->device "
          f"from pinned memory; every leaf once: {lanes[1][0]:.3f} GB/s on 1 lane, "
          f"{lanes[8][0]:.3f} GB/s on 8 lanes ({lanes[8][1]:.2f} fetches in flight on average)")

    def run_mode(mode, warm, label):
        """STREAM_STEPS streamed decode steps from the prefill's cache, one
        streamer per step, each checked against the resident step."""
        c, tok = clone(cache), tok0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, logs = [], []
        tot = dict(stall_seconds=0.0, prefetch_hits=0, stalls=0, fetches=0, bytes_moved=0,
                   fetch_timeouts=0, wasted_bytes=0)
        worst = 0.0
        for i in range(STREAM_STEPS):
            ws = WeightStreamer(store, plan, mode=mode, k_ahead=3, workers=8,
                                warm_group_trace=warm)
            for ctr in counters.values():
                ctr.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, c = server.stream_decode(ws, c, tok, prompt + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            ws.close()
            launched = {n: ctr.launches for n, ctr in counters.items()}
            m = ws.metrics
            for k in tot:
                tot[k] += getattr(m, k)
            logs.append(list(ws.group_log))
            want_logits, want_tok = resident[i]
            tok = torch.argmax(logits, dim=-1)
            rel = float((logits - want_logits).abs().max() / want_logits.abs().max())
            worst = max(worst, rel)
            name = mode or "on-demand"
            check(torch.equal(tok, want_tok), f"stream {name}: step {i} tokens differ from resident")
            check(rel <= STREAM_REL_TOL, f"stream {name}: step {i} logits differ by {rel:.3e}")
            check(m.fetch_timeouts == 0, f"stream {name}: {m.fetch_timeouts} fetch timeouts")
            check(m.prefetch_hits + m.stalls == len(plan.records),
                  f"stream {name}: {m.prefetch_hits + m.stalls} of {len(plan.records)} records served")
            check(launched.get("decode_attention_fwd") == cfg.n_layers
                  and launched.get("prefetch_gather_fwd") == 1,
                  f"stream {name}: step {i} launches {launched}")
        peak = torch.cuda.max_memory_allocated()
        gbps = tot["bytes_moved"] / (sum(ms) / 1e3) / 1e9
        print(f"[stream] {label} {mode or 'on-demand':12s}: {', '.join(f'{x:.3f}' for x in ms)} "
              f"ms per step (median {statistics.median(ms):.3f}); stall "
              f"{tot['stall_seconds']:.4f} s, hits {tot['prefetch_hits']}, stalls {tot['stalls']}, "
              f"fetches {tot['fetches']}, {tot['bytes_moved']} B moved "
              f"({tot['bytes_moved'] / STREAM_STEPS / plan.total_bytes:.4f} of the plan's f32 "
              f"bytes per step), {gbps:.3f} GB/s effective, wasted {tot['wasted_bytes']} B, "
              f"fetch_timeouts {tot['fetch_timeouts']}, peak memory {peak} B; logits within "
              f"{worst:.3e} of the largest resident logit, tokens equal")
        return dict(ms=ms, gbps=gbps, peak=peak, logs=logs, **tot)

    # one pass of capre to warm the copy streams' allocator pools; its group
    # log is what the miners are warmed with
    capre_log = run_mode("capre", None, "warm-up")["logs"][0]
    modes = (None, "rop", "capre", "markov-miner", "hybrid")
    results = {m or "on-demand": [] for m in modes}
    # the modes in order, then in reverse: a drift over the run shows as a
    # difference between the two passes of one mode
    for label, order in (("pass 1", modes), ("pass 2", modes[::-1])):
        for mode in order:
            warm = capre_log if mode in ("markov-miner", "hybrid") else None
            results[mode or "on-demand"].append(run_mode(mode, warm, label))
    med = {name: statistics.median(x for r in runs for x in r["ms"])
           for name, runs in results.items()}
    print("[stream] median ms per streamed step over both passes: "
          + ", ".join(f"{name} {v:.3f}" for name, v in med.items())
          + f"; resident {statistics.median(res_ms):.3f}")
    gap = med["on-demand"] - med["capre"]
    print(f"[stream] capre against on-demand: {gap:.3f} ms per step "
          f"({gap / med['on-demand']:.4f} of on-demand); the link's ceiling "
          f"{link:.3f} GB/s puts {data / link / 1e6:.3f} ms per step under any mode")
    del store, cache
    gc.collect()
    torch.cuda.empty_cache()
    return results


def _bwd_cost(B, Sq, Sk, H, KV, D, causal, products: int, out_q: bool) -> tuple[int, int]:
    """(bytes, FLOP) a backward pass must move and do: q, do, k, v read once,
    lse and delta once, its outputs (dq, or dk and dv) written once, and
    ``products`` products over the (query, key) pairs the mask keeps."""
    pairs = Sq * (Sq + 1) // 2 if causal and Sq == Sk else Sq * Sk
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KV * D) + 2 * 4 * B * H * Sq
    nbytes += 2 * B * Sq * H * D if out_q else 2 * 2 * B * Sk * KV * D
    return nbytes, products * 2 * D * pairs * B * H


def sm_balance(steps: list, split: int, n_sm: int) -> int:
    """The largest per-SM count of the dK/dV launch's (head, q tile) steps
    under a model of the block scheduler: clusters of ``split`` blocks
    start in launch order, each on the group of ``split`` SMs that frees
    first (``n_sm // split`` groups), and a cluster lasts as long as its
    heaviest block."""
    import heapq

    groups = [(0, i) for i in range(n_sm // split)]
    per_sm = [0] * n_sm
    for c in range(0, len(steps), split):
        t, i = heapq.heappop(groups)
        cluster = steps[c:c + split]
        for r, n in enumerate(cluster):
            per_sm[i * split + r] += n
        heapq.heappush(groups, (t + max(cluster), i))
    return max(per_sm)


def check_bwd_replays(torch, flash_fwd, dkdv, dq) -> None:
    """dq, dk, dv of one backward captured in a CUDA graph, replayed twice:
    equal bit for bit (no atomics; the dK/dV clusters sum in rank order)."""
    from repro_torch.kernels.flash_attention_bwd import attention_delta

    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S, H, KV, D = 2, 2048, 32, 2, 128
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((B, S, KV, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, lse = flash_fwd(q, k, v, causal=True)
    delta = attention_delta(o, do)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dkdv(q, k, v, do, lse, delta)
        dq(q, k, v, do, lse, delta)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gk, gv = dkdv(q, k, v, do, lse, delta)
        gq = dq(q, k, v, do, lse, delta)
    graph.replay()
    torch.cuda.synchronize()
    first = [t.clone() for t in (gq, gk, gv)]
    for t in (gq, gk, gv):
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, (gq, gk, gv))]
    print(f"[flash_bwd] two replays of one captured backward at the training shape: dq, dk, dv "
          f"bitwise equal {same}")
    check(all(same), "the backward kernels are not bitwise repeatable")


def phase_flash_bwd(torch, ref, flash_fwd, dkdv, dq):
    """Check the backward kernels at the training shape, at edge cases and
    at every head dim class; check they repeat bit for bit; print the dK/dV
    launch's balance over the SMs; time them at the training shape.
    Returns their two JSON records."""
    from repro_torch.kernels import flash_attention_bwd as bwd
    from repro_torch.kernels.flash_attention import route
    from repro_torch.kernels.flash_attention_bwd import attention_delta

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [  # B, Sq, Sk, H, KV, D, dtype, causal, q_offset
        (2, 2048, 2048, 32, 2, 128, torch.bfloat16, True, 0),   # the training shape
        (2, 2048, 2048, 32, 2, 128, torch.float32, True, 0),
        (1, 512, 512, 32, 2, 128, torch.bfloat16, False, 0),
        (1, 333, 1000, 32, 2, 128, torch.bfloat16, True, 667),  # ragged, q_offset
        (1, 333, 1000, 8, 2, 64, torch.float32, True, 667),
        (2, 256, 256, 2, 2, 128, torch.bfloat16, True, 0),      # G = 1
        (1, 300, 300, 16, 1, 64, torch.bfloat16, False, 0),     # G = 16, ragged
        # whisper-large-v3's encoder (1500 x 1500) and cross-attention (384
        # x 1500) as its training step runs them (G = 1, D 64, not causal)
        (4, 1500, 1500, 20, 20, 64, torch.bfloat16, False, 0),
        (4, 384, 1500, 20, 20, 64, torch.bfloat16, False, 0),
    ] + [  # every head dim class, G = 7 over clusters of 4, ragged, q_offset
        (1, 77, 200, 14, 2, D, dt, True, 123)
        for D in (8, 16, 20, 64, 96, 128, 136, 256) for dt in (torch.bfloat16, torch.float32)
    ]
    errs = {}
    for B, Sq, Sk, H, KV, D, dt, causal, q_off in cases:
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Sk, KV, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Sk, KV, D), generator=gen, device=dev).to(dt)
        do = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        o, lse = flash_fwd(q, k, v, causal=causal, q_offset=q_off)
        delta = attention_delta(o, do)
        kw = dict(causal=causal, q_offset=q_off)
        got_dk, got_dv = dkdv(q, k, v, do, lse, delta, **kw)
        got_dq = dq(q, k, v, do, lse, delta, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        tol = GRAD_REL_TOL[str(dt).split(".")[-1]]
        line = []
        for name, got, w in zip(("dq", "dk", "dv"), (got_dq, got_dk, got_dv), want):
            rel, _ = rel_err(torch, got, w)
            check(bool(torch.isfinite(got).all()), f"flash backward {name}: non-finite values")
            check(got.dtype == w.dtype and got.shape == w.shape, f"flash backward {name} shape")
            line.append(f"{name} {rel:.3e}")
            check(rel <= tol, f"flash backward {name} disagrees with its plain version")
            errs.setdefault(name, float((got.float() - w.float()).abs().max()))
        print(f"[flash_bwd] B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} {dt} causal={causal} "
              f"q_offset={q_off} ({route(D, dt)}): max |err| / max |plain|: {', '.join(line)} (tol {tol})")
        del q, k, v, do, o, lse, delta, got_dk, got_dv, got_dq, want
    check_bwd_replays(torch, flash_fwd, dkdv, dq)

    B, S, H, KV, D = 2, 2048, 32, 2, 128
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    split = bwd.dkdv_split(B, KV, H // KV, S, n_sm)
    steps = bwd.dkdv_steps(B, KV, H // KV, S, S, True, 0, split)
    top, mean = sm_balance(steps, split, n_sm), sum(steps) / n_sm
    print(f"[flash_bwd] dK/dV at the training shape: {len(steps)} blocks of {bwd.KV_TILE} keys "
          f"in clusters of {split} (each block every {split}th query head), (head, 64-row q "
          f"tile) steps per block {max(steps)} .. {min(steps)}, {sum(steps)} in all; per SM "
          f"under greedy cluster dispatch (a model of the block scheduler, {n_sm} SMs): "
          f"largest {top}, mean {mean:.1f}, largest / mean {top / mean:.3f}")
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
    do = torch.randn((B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)
    o, lse = flash_fwd(q, k, v, causal=True)
    delta = attention_delta(o, do)
    ms_kv = graph_ms(torch, lambda: dkdv(q, k, v, do, lse, delta, causal=True))
    ms_q = graph_ms(torch, lambda: dq(q, k, v, do, lse, delta, causal=True))
    plain_ms = graph_ms(
        torch, lambda: ref.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal=True),
        iters=2, reps=3)
    # the yardstick: the backward of one SDPA call (dq, dk and dv together)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                        retain_graph=True), iters=20)
    recs = []
    for name, ms, products, out_q, line in (
        ("flash_attention_bwd_dkdv", ms_kv, 4, False, 44),
        ("flash_attention_bwd_dq", ms_q, 3, True, 74),
    ):
        nbytes, flops = _bwd_cost(B, S, S, H, KV, D, True, products, out_q)
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
        rec = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": f"src/repro/kernels/flash_attention_bwd.py:{line}",
            "launches": None, "max_abs_err": errs["dq"] if out_q else max(errs["dk"], errs["dv"]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
        }
        recs.append(rec)
        print(f"[flash_bwd] training shape B={B} S={S} H={H} KV={KV} D={D} bf16 causal: {name} "
              f"{ms:.4f} ms (device time, CUDA graph), {flops / ms / 1e9:.1f} TFLOP/s; bound "
              f"{rec['bound_ms'] * 1e3:.2f} us by {rec['bound_by']} ({nbytes} B, {flops} FLOP)")
    nbytes, flops = _bwd_cost(B, S, S, H, KV, D, True, 5, True)
    nbytes += 2 * 2 * B * S * KV * D
    print(f"[flash_bwd] both kernels {ms_kv + ms_q:.4f} ms; plain version (dq, dk, dv) "
          f"{plain_ms:.4f} ms (CUDA graph); SDPA backward (dq, dk, dv) {lib_ms:.4f} ms "
          f"(back-to-back calls between CUDA events); the fused five-product bound "
          f"{max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3:.4f} ms ({flops} FLOP)")
    return recs


def check_train_head(torch) -> None:
    """The head's forward and backward in training (``_HeadMatmul``: bf16
    GEMMs with f32 accumulation, the cotangent rounded once to bf16) against
    widening both operands to f32, at the training shape's 4096 tokens; both
    timed."""
    from repro_torch.models.model import _HeadMatmul

    gen = torch.Generator(device="cuda").manual_seed(4)
    h = (0.5 * torch.randn((4096, 4096), generator=gen, device="cuda")).to(torch.bfloat16)
    w = (0.01 * torch.randn((4096, 65280), generator=gen, device="cuda")).to(torch.bfloat16)
    g = 1e-6 * torch.randn((4096, 65280), generator=gen, device="cuda")
    h.requires_grad_()
    w.requires_grad_()

    def kernel():
        return torch.autograd.grad(_HeadMatmul.apply(h, w), (h, w), g)

    def widened():
        return torch.autograd.grad(h.float() @ w.float(), (h, w), g)

    got, want = kernel(), widened()
    rels = [rel_err(torch, a, b)[0] for a, b in zip(got, want)]
    k_ms, w_ms = cuda_ms(torch, kernel, iters=10, warmup=2), cuda_ms(torch, widened, iters=10,
                                                                    warmup=2)
    print(f"[train] head [4096 x 4096] @ [4096 x 65280] forward + backward: bf16 GEMMs "
          f"{k_ms:.4f} ms, widened to f32 {w_ms:.4f} ms (CUDA events); dh, dw max |diff| / "
          f"max |widened| {rels[0]:.3e}, {rels[1]:.3e} (tol {GRAD_REL_TOL['bfloat16']})")
    check(max(rels) <= GRAD_REL_TOL["bfloat16"], "the head's gradient disagrees with f32")


def image_positions(torch, B: int, text: int, rows: int, cols: int, tail: int):
    """[3, B, text + rows*cols + tail] (t, h, w) positions on the card, laid
    out as Qwen2-VL lays out an image in a text: ``text`` tokens at
    0..text-1 in all three streams, a rows x cols grid of image tokens at
    t = text, h = text + row, w = text + column, then ``tail`` text tokens
    from one past the grid's largest position."""
    dev = torch.device("cuda")
    r = torch.arange(rows * cols, device=dev)
    image = torch.stack([torch.full_like(r, text), text + r // cols, text + r % cols])
    start = text + max(rows, cols)
    pos = torch.cat([torch.arange(text, device=dev).expand(3, text), image,
                     (start + torch.arange(tail, device=dev)).expand(3, tail)], dim=1)
    return pos[:, None].expand(3, B, pos.shape[1]).contiguous()


def _device_batch(torch, cfg, B: int, S: int, step: int = 0) -> dict:
    """Batch ``step`` of the Trainer's synthetic source at seed 0 on the card
    (tokens; qwen2-vl's embeds at M-RoPE positions; whisper's frames)."""
    from repro_torch.launch.train import batch_to_device, synthetic_source

    return batch_to_device(synthetic_source(cfg, B, S, seed=0).batch_at(step), "cuda")


def flash_attentions(cfg) -> int:
    """The attentions of one forward (a prefill or a training step's) that
    take the flash kernels (no window; on the card any length): every
    layer's (dense, moe); whisper's decoder self-attention, encoder and
    cross-attention; none in the ssm family and the hybrid, whose attention
    is windowed."""
    if cfg.family in ("ssm", "hybrid"):
        return 0
    if cfg.family == "encdec":
        return cfg.n_layers + cfg.enc_layers + cfg.n_layers  # self, encoder, cross
    return cfg.n_layers


def train_launches(cfg, counters: dict) -> dict:
    """The launches of one train step on the kernel path, by counter: the
    flash forward twice per flash attention (the forward and its
    recomputation under remat), dK/dV and dQ once; nothing else (the scans
    take their plain loop under autograd, the embedding no gather)."""
    n = flash_attentions(cfg)
    want = {name: 0 for name in counters}
    want.update({"flash_attention_fwd": 2 * n, "flash_attention_bwd_dkdv": n,
                 "flash_attention_bwd_dq": n})
    return {name: want[name] for name in counters}


def check_grads(torch, counters: dict, cfg, B: int, S: int, tag: str = "train",
                seed: int = 0) -> None:
    """Every gradient leaf of one step on the kernel path, in bf16 and in
    f32, against the plain chunked path's f32 gradient on the same
    parameters (from ``seed``) and batch (the Trainer's step ``seed``); the plain chunked path's own bf16 gradient is
    measured against it beside the kernel path's, the yardstick of the bf16
    bound.  The kernel path's launches must be the path's
    (``train_launches``).  An moe config's plain path takes the kernel
    path's experts, call by call (forward, then the recomputation), and its
    own choices that differ are counted: none may in f32."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.common import tree_items
    from repro_torch.models.model import Model

    L = cfg.n_layers
    params = Model(cfg, "cuda").init_params(seed=seed)
    batch = _device_batch(torch, cfg, B, S, step=seed)
    if cfg.embeds_input:  # qwen2-vl: the prompt as embeddings at the image layout's positions
        gen = torch.Generator(device="cuda").manual_seed(6)
        batch["embeds"] = 0.02 * torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
        batch["positions"] = image_positions(torch, B, S // 4, S // 16, 8, S // 4)
    want = train_launches(cfg, counters)

    def grads(impl: str, dtype: str, force=None):
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        with routing(torch, force=force) as log:
            loss, g = loss_and_grads(
                Model(cfg.replace(attn_impl=impl, compute_dtype=dtype), "cuda"), params, batch)
        torch.cuda.synchronize()
        return (float(loss), dict(tree_items(g)), time.perf_counter() - t,
                {n: c.launches for n, c in counters.items()}, log)

    def worst_leaf(got: dict, ref: dict) -> tuple[float, str]:
        tree_max = max(float(g.abs().max()) for g in ref.values())
        worst, worst_path = 0.0, ""
        for path, want_g in ref.items():
            check(bool(torch.isfinite(got[path]).all()), f"{cfg.name}: non-finite grad {path}")
            scale = tree_max if path in ZERO_GRAD_LEAVES else float(want_g.abs().max())
            rel = float((got[path] - want_g).abs().max()) / max(scale, 1e-30)
            if rel > worst:
                worst, worst_path = rel, path
        return worst, worst_path

    for dtype in ("bfloat16", "float32"):
        kloss, kg, ks, kcount, routes = grads("pallas", dtype)
        force = routes if cfg.family == "moe" else None
        ploss, pg, ps, _, log = grads("chunked", "float32", force)
        worst, worst_path = worst_leaf(kg, pg)
        tol = GRAD_REL_TOL_BF16_F32 if dtype == "bfloat16" else GRAD_REL_TOL[dtype]
        yardstick = ""
        if dtype == "bfloat16":
            wloss, wg, _, _, _ = grads("chunked", dtype, force)
            w_worst, w_path = worst_leaf(wg, pg)
            yardstick = (f"; the plain chunked path in bf16 (loss {wloss:.6f}) at {w_worst:.3e} "
                         f"({w_path})")
            del wg
        flips = ""
        if force is not None:
            n_flips = sum(choices_differ(cfg, routes, log))
            flips = (f"; the plain path on the kernel path's routes ({len(routes)} router calls), "
                     f"its own choices that differ: {n_flips} of {sum(r.numel() for r in routes)}")
            if dtype == "float32":
                check(n_flips == 0, f"{cfg.name}: an f32 routing choice differs between the paths")
        print(f"[{tag}] {cfg.name} depth {L} head_dim {cfg.head_dim} {dtype}, B={B} S={S}: loss "
              f"kernel {kloss:.6f}, plain chunked f32 {ploss:.6f}; worst gradient leaf "
              f"{worst_path} at {worst:.3e} of its largest f32 magnitude (tol {tol}; {len(pg)} "
              f"leaves){yardstick}; step {ks:.3f} s kernel path, {ps:.3f} s plain f32; launches "
              f"{kcount}{flips}")
        check(kcount == want, f"{cfg.name} launches {kcount}, want {want}")
        check(worst <= tol, f"{cfg.name} {dtype}: kernel-path gradients disagree with the plain "
                            "path's f32 gradient")
        del kg, pg
        gc.collect()


def train_model(torch, counters: dict, cfg, B: int, S: int, tag: str,
                profile: bool = False, record: dict = None) -> dict:
    """Three ``repro_torch.launch.train.Trainer`` steps of ``cfg`` (weights
    from seed 0, bf16 compute, f32 parameters and AdamW state, remat=full)
    at B x S, the launch counters zeroed just before the run and read just
    after it; each step's launches held to the path's (``train_launches``)
    and the first loss to the plain chunked path's loss on the same weights
    and batch; with ``profile`` a fourth step under torch.profiler.  Prints
    ms per step (median of steps 1-2), tokens/s and peak memory; returns the
    run's launch counts; ``record``, when given, takes the second step's
    launches and the ms per step."""
    from repro_torch.launch.train import Trainer
    from repro_torch.models.model import Model

    plain = Model(cfg.replace(attn_impl="chunked"), "cuda")
    params = plain.init_params(seed=0)
    with torch.no_grad():
        plain_loss = float(plain.loss_fn(params, _device_batch(torch, cfg, B, S)))
    del params, plain
    gc.collect()
    torch.cuda.empty_cache()

    trainer = Trainer(cfg, device="cuda", global_batch=B, seq_len=S, total_steps=3, log_every=1)
    inner, steps = trainer.step_fn, []

    def step_fn(params, opt_state, batch):
        before = {n: c.launches for n, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(params, opt_state, batch)
        loss = float(out[2]["loss"])
        steps.append((time.perf_counter() - t, loss,
                      {n: c.launches - before[n] for n, c in counters.items()}))
        return out

    trainer.step_fn = step_fn
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    params, opt_state, losses = trainer.train(3, seed=0)
    launches = {n: c.launches for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if profile:
        batch = _device_batch(torch, cfg, B, S, step=3)
        profile_run(torch, f"one {cfg.name} train step at depth {cfg.n_layers}",
                    lambda: inner(params, opt_state, batch), watch=("flash_fwd", "dkdv_", "dq_"))
        del batch
    want = train_launches(cfg, counters)
    for i, (dt, loss, count) in enumerate(steps):
        print(f"[{tag}] {cfg.name} depth {cfg.n_layers} step {i}: loss {loss:.6f}, "
              f"{dt * 1e3:.3f} ms, {B * S / dt:.1f} tokens/s, launches {count}")
        check(count == want, f"{cfg.name}: a step's launches are not the path's {want}")
    check(len(losses) == 3 and all(map(math.isfinite, losses)), f"losses {losses}")
    check(int(opt_state["step"]) == 3 + profile,
          "the optimizer did not take three steps (and the profiled one)")
    loss_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    ms = statistics.median(dt for dt, _, _ in steps[1:]) * 1e3
    layers = (f"{cfg.enc_layers} encoder + {cfg.n_layers} decoder layers"
              if cfg.family == "encdec" else f"depth {cfg.n_layers}")
    frames = f" (audio frames {cfg.enc_positions})" if cfg.family == "encdec" else ""
    print(f"[{tag}] {cfg.name} ({cfg.family}) at full width, {layers} ({cfg.param_count()} "
          f"params), B={B} S={S}{frames}, bf16 compute, f32 params and AdamW state, "
          f"remat=full: {ms:.3f} ms/step (median of steps 1-2), {B * S / ms * 1e3:.1f} "
          f"tokens/s, peak memory {peak} B; first loss {losses[0]:.6f} against the plain "
          f"chunked path's {plain_loss:.6f} (relative {loss_rel:.3e}, tol {LOSS_REL_TOL}); "
          f"launches in the run {launches}")
    check(loss_rel <= LOSS_REL_TOL, f"{cfg.name}: the first step's loss disagrees with the "
                                    "plain path")
    if record is not None:
        record.update(launches={n: c for n, c in steps[1][2].items() if c}, ms=ms)
    del params, opt_state, trainer
    return launches


def phase_train(torch, counters: dict, cost_cells: dict) -> dict:
    """(a) depth-2 gradients, (b) three Trainer steps at depth 16; returns
    the launch counts of the Trainer run (one step's, and its ms, into
    ``cost_cells["train"]``)."""
    from repro_torch.configs import get_config

    B, S, L = 2, 2048, TRAIN_DEPTH
    check_train_head(torch)
    check_grads(torch, counters, get_config("chatglm3_6b").replace(n_layers=2), B, S)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("chatglm3_6b").replace(n_layers=L, attn_impl="pallas")
    cost_cells["train"] = {}
    return train_model(torch, counters, cfg, B, S, "train", profile=True,
                       record=cost_cells["train"])


# [cost]: the cost model's cells, chatglm3-6b at full width with the kernels:
# (kind, depth, B, S, cache slots, position of the decode's new token)
COST_CELLS = (("decode", 28, 4, 1, 1024, 527), ("prefill", 28, 4, 512, 0, 0),
              ("train", TRAIN_DEPTH, 2, 2048, 0, 0))


def phase_cost(torch, smi: str, cost_cells: dict) -> None:
    """The cost model (``launch.costmodel.step_cost``) on the cells the card
    ran: chatglm3-6b's captured decode step (B 4, cache 1024, kv_len 528),
    its prefill (B 4, prompt 512; both bf16 weights, as ``compute_params``
    casts them) and its train step at depth 16 (B 2, S 2048, f32 parameters
    and AdamW state, remat full), each traced on ``meta`` with the kernels
    priced.  Prints FLOPs, bytes, the bound max(F / 989 TFLOP/s, B / 3.35
    TB/s) beside the measured time; fails unless each kernel's calls in
    the cost model's list equal the launches of one real step on the card
    (``cost_cells``, counted in ``[slice]`` and ``[train]``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.costmodel import step_cost
    from repro_torch.launch.steps import (
        decode_input_specs,
        input_specs,
        make_decode_step,
        make_prefill_step,
        make_train_step,
    )

    base = get_config("chatglm3_6b").replace(attn_impl="pallas")
    for kind, depth, B, S, slots, pos in COST_CELLS:
        cfg = base.replace(n_layers=depth)
        t = time.perf_counter()
        if kind == "train":
            model, opt, fn = make_train_step(cfg, device="meta")
            params = model.abstract_params()
            args = (params, opt.init(params), input_specs(cfg, ShapeConfig(kind, kind, S, B)))
        elif kind == "prefill":
            model, fn = make_prefill_step(cfg, device="meta")
            batch = input_specs(cfg, ShapeConfig(kind, kind, S, B))
            args = (model.compute_params(model.abstract_params()), batch)
        else:
            model, fn = make_decode_step(cfg, device="meta")
            cache, tokens, _ = decode_input_specs(cfg, ShapeConfig(kind, kind, slots, B))
            at = torch.empty((), dtype=torch.int64, device="meta")  # the captured step's pos
            args = (model.compute_params(model.abstract_params()), cache, tokens, at)
        cost = step_cost(fn, *args)
        trace_s = time.perf_counter() - t
        measured = cost_cells[kind]
        bound_ms = max(cost.flops / 989e12, cost.bytes / HBM_BPS) * 1e3
        print(f"[cost] chatglm3-6b {kind} (depth {depth}, B {B}, "
              + (f"cache {slots}, kv_len {pos + 1}" if kind == "decode" else f"S {S}")
              + f"): FLOPs {cost.flops:.6e} (products {cost.dot_flops:.6e}), bytes "
              f"{cost.bytes:.6e}, bound max(F / 989 TFLOP/s, B / 3.35 TB/s) {bound_ms:.4f} ms "
              f"({'bytes' if cost.bytes / HBM_BPS > cost.flops / 989e12 else 'operations'}); "
              f"measured {measured['ms']:.4f} ms ({measured['ms'] / bound_ms:.3f} x the bound); "
              f"{smi}; traced on meta in {trace_s:.2f} s")
        print(f"[cost] {kind}: the cost model's kernel calls {cost.kernels}, one real step's "
              f"launches on the card {measured['launches']}")
        check(cost.kernels == measured["launches"],
              f"[cost] {kind}: the cost model's kernel calls are not the card's launches")


# the other families trained at full width after the dense one: (arch, depth
# or 0 for the published one, why the depth is cut, B, S, whether to profile
# a fourth step).  whisper's decoder takes 384 positions, under its 448; the scans'
# plain loops under autograd launch ~10^5-10^6 kernels a step, too many to
# trace
TRAIN_FAMILIES = (
    ("whisper_large_v3", 0, "", 4, 384, True),
    ("qwen3_moe_30b_a3b", 4, "the f32 parameters, gradient and AdamW moments of all 48 "
     "layers take ~490 GB", 2, 2048, True),
    ("recurrentgemma_2b", 6, "the plain time loop under autograd (11-16 s a step at its full "
     "26 layers, which took this script past half its time limit once sharded serving came "
     "in); two (rec, rec, attn) patterns keep both kinds of layer", 2, 2048, False),
    ("falcon_mamba_7b", 4, "memory (the f32 state of 64 layers takes ~116 GB) and the plain "
     "time loop under autograd (~50 s a step at depth 16, which took this script past half "
     "its time limit)", 2, 2048, False),
)


def phase_train_families(torch, counters: dict) -> dict:
    """whisper-large-v3, qwen3-moe-30b-a3b, recurrentgemma-2b and
    falcon-mamba-7b at full width (``TRAIN_FAMILIES``), each trained three
    ``Trainer`` steps (``train_model``) after every earlier model is freed;
    returns the launch counts summed over the runs."""
    from repro_torch.configs import get_config

    total = {n: 0 for n in counters}
    for arch, depth, why, B, S, profile in TRAIN_FAMILIES:
        cfg = get_config(arch).replace(attn_impl="pallas")
        if depth:
            print(f"[train] reduced: {cfg.name} depth {cfg.n_layers} -> {depth}: {why}")
            cfg = cfg.replace(n_layers=depth)
        run = train_model(torch, counters, cfg, B, S, "train", profile)
        total = {n: total[n] + run[n] for n in counters}
        gc.collect()
        torch.cuda.empty_cache()
    return total


# (arch, head_dim override or 0, whether to serve, whether to train): the
# chatglm3 and yi smoke configs as they are (head_dim 16 and 8), and
# chatglm3's with head_dim 256 (the largest of any config,
# recurrentgemma-2b's), 20 (a bf16 row that is not a multiple of 16 bytes)
# and 320 (past 256: the D = 256 build in two pieces), which the flash
# kernels run on the CUDA cores; the two moe smoke configs (head_dim 16);
# whisper's (head_dim 16, at 256 frames: encoder, decoder and
# cross-attention on the flash kernels); qwen2-vl's (head_dim 16, the prompt
# as embeddings at the image layout's positions); falcon-mamba's and
# recurrentgemma's, trained only (the full models are served in their own
# phases): no kernel runs under autograd, so both paths compute alike
SMOKE_CONFIGS = (("chatglm3_6b", 0, True, True), ("yi_34b", 0, True, True),
                 ("chatglm3_6b", 256, True, True), ("chatglm3_6b", 20, True, True),
                 ("chatglm3_6b", 320, True, True), ("qwen3_moe_30b_a3b", 0, True, True),
                 ("granite_moe_1b_a400m", 0, True, True), ("whisper_large_v3", 0, True, True),
                 ("qwen2_vl_2b", 0, True, True), ("falcon_mamba_7b", 0, False, True),
                 ("recurrentgemma_2b", 0, False, True))


def smoke_config(arch: str, head_dim: int):
    """``arch``'s smoke config on the kernel path, with ``head_dim`` where it
    is not 0; whisper's at 256 frames."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch).replace(attn_impl="pallas")
    if head_dim:
        cfg = cfg.replace(head_dim=head_dim, name=f"{cfg.name}-hd{head_dim}")
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_positions=256)
    return cfg


def phase_smoke_configs(torch, counters: dict) -> None:
    """The smoke configs of ``SMOKE_CONFIGS`` with ``attn_impl="pallas"``:
    (where the config serves) served through the flash forward and
    flash-decode (the captured step and the eager loop, tokens and logits
    bitwise), logits against the plain path; then (where it trains) one
    training step's gradients on the kernel path against the plain path,
    with the path's launches (``check_grads``)."""
    B, prompt, gen_tokens, max_len = 2, 128, 8, 256
    train_counters = {k: counters[k] for k in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                                               "flash_attention_bwd_dq", "selective_scan_fwd",
                                               "rglru_gated_fwd")}
    for arch, head_dim, serve, train in SMOKE_CONFIGS:
        cfg = smoke_config(arch, head_dim)
        n_flash = flash_attentions(cfg)  # one flash forward per attention of the prefill
        if serve:
            serve_smoke(torch, counters, cfg, n_flash, B, prompt, gen_tokens, max_len)
        if train:
            check_grads(torch, train_counters, cfg, B, prompt, tag="smoke")


def serve_smoke(torch, counters: dict, cfg, n_flash: int, B: int, prompt: int,
                gen_tokens: int, max_len: int) -> None:
    """One smoke config served (``phase_smoke_configs``)."""
    from repro_torch.kernels.flash_attention import padded_head_dim, route
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch

    server = Server(cfg, device="cuda", max_len=max_len)
    params = server.model.compute_params(server.model.init_params(seed=0))
    batch = concrete_batch(cfg, B, prompt, device="cuda")
    batch.pop("targets")
    if cfg.embeds_input:  # the prompt as embeddings only, at an image's positions
        batch.pop("inputs")
        batch["positions"] = image_positions(torch, B, 32, 8, 8, 32)
    server.captured_decode(params, B)  # the capture (and its warm-up) before the count
    for c in counters.values():
        c.launches = 0
    tokens, logits = server.generate(params, batch, gen_tokens, with_logits=True)
    torch.cuda.synchronize()
    n = {name: c.launches for name, c in counters.items()}
    eager_tokens, eager_logits = server.generate_eager(params, batch, gen_tokens,
                                                       with_logits=True)
    check(torch.equal(tokens, eager_tokens) and torch.equal(logits, eager_logits),
          f"{cfg.name}: the captured decode is not bitwise the eager loop")
    D = cfg.head_dim
    print(f"[smoke] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {D}: served B={B} prompt "
          f"{prompt} {gen_tokens} tokens, launches {n}; captured decode bitwise the eager "
          f"loop; flash kernels: bf16 on {route(D, torch.bfloat16)} (build D = "
          f"{padded_head_dim(D, torch.bfloat16)}, {-(-D // 256)} piece(s) of the head dim "
          f"past 128), f32 on {route(D, torch.float32)}")
    check(n["flash_attention_fwd"] == n_flash
          and n["decode_attention_fwd"] == cfg.n_layers * (gen_tokens - 1),
          f"{cfg.name}: the serve did not run the flash kernels")
    kern, plain = teacher_forced(torch, cfg, params, batch, tokens, max_len, plain="naive")
    check(torch.equal(kern.argmax(-1), tokens), "replayed kernel path disagrees with generate")
    check_paths(torch, f"{cfg.name} bf16 compute", cfg, kern, plain,
                LOGITS_REL_TOL_BF16_DEPTH2, plain_impl="naive", tag="smoke")
    cfg32 = cfg.replace(compute_dtype="float32")
    kern32, plain32 = teacher_forced(torch, cfg32, server.model.init_params(seed=0), batch,
                                     tokens, max_len)
    check_paths(torch, f"{cfg.name} f32 compute", cfg32, kern32, plain32, LOGITS_REL_TOL_F32,
                tag="smoke")


def _check_scan(torch, label: str, got, want, tol: float) -> float:
    ok, err = allclose(torch, got, want, tol)
    print(f"[scans] {label}: max_abs_err {err:.3e} (tol {tol})")
    check(ok and got.dtype == want.dtype and got.shape == want.shape,
          f"{label}: the kernel disagrees with its plain version")
    return err


def phase_scans(torch, ref, mamba_fwd, rglru_fwd) -> list:
    """Check both materialised scan kernels (the TPU kernels' contracts)
    against their plain versions; time them at the serving shapes.  Returns
    their two JSON records (the prefill shape's numbers; launches filled in
    later)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    errs = {"mamba_scan_fwd": 0.0, "rglru_scan_fwd": 0.0}
    cases = [(4, S, 8192, 16) for S in (1, 7, 128, 512)] + [(2, 7, 8200, 16), (3, 33, 300, 5)]
    for (B, S, Ch, N), dt, with_h0 in itertools.product(
            cases, (torch.float32, torch.bfloat16), (False, True)):
        dA = (0.3 + 0.69 * torch.rand((B, S, Ch, N), generator=gen, device=dev)).to(dt)
        dBu = (0.1 * torch.randn((B, S, Ch, N), generator=gen, device=dev)).to(dt)
        C = torch.randn((B, S, N), generator=gen, device=dev).to(dt)
        h0 = torch.randn((B, Ch, N), generator=gen, device=dev) if with_h0 else None
        y, h = mamba_fwd(dA, dBu, C, h0, with_state=True)
        y_ref, h_ref = ref.mamba_scan_ref(dA, dBu, C, h0, with_state=True)
        torch.cuda.synchronize()
        label = f"mamba B={B} S={S} Ch={Ch} N={N} {dt} h0={with_h0}"
        err = _check_scan(torch, label + " y", y, y_ref, TOL[str(dt).split(".")[-1]])
        _check_scan(torch, label + " h_S", h, h_ref, TOL["float32"])
        if dt == torch.float32:
            errs["mamba_scan_fwd"] = max(errs["mamba_scan_fwd"], err)
        del dA, dBu, C, h0, y, h, y_ref, h_ref
    cases = [(4, S, 2560) for S in (1, 7, 128, 512)] + [(2, 7, 2500), (3, 33, 300)]
    for (B, S, W), dt, with_h0 in itertools.product(
            cases, (torch.float32, torch.bfloat16), (False, True)):
        a = (0.5 + 0.49 * torch.rand((B, S, W), generator=gen, device=dev)).to(dt)
        g = (0.1 * torch.randn((B, S, W), generator=gen, device=dev)).to(dt)
        h0 = torch.randn((B, W), generator=gen, device=dev) if with_h0 else None
        y, y_ref = rglru_fwd(a, g, h0), ref.rglru_scan_ref(a, g, h0)
        torch.cuda.synchronize()
        label = f"rglru B={B} S={S} W={W} {dt} h0={with_h0}"
        err = _check_scan(torch, label, y, y_ref, TOL[str(dt).split(".")[-1]])
        if dt == torch.float32:
            check(torch.equal(y, y_ref), f"{label}: f32 output not bitwise its plain version")
            errs["rglru_scan_fwd"] = max(errs["rglru_scan_fwd"], err)

    # the serving shapes, in the calls the TPU kernels' contracts make:
    # prefill from zeros and decode (S = 1) from a state, f32 inputs, the
    # mamba scan's last state written out
    recs, f32 = [], 4  # bytes per f32 element
    B, Ch, N = 4, 8192, 16
    times = {}
    for label, S in (("prefill", 512), ("decode", 1)):
        dA = torch.rand((B, S, Ch, N), generator=gen, device=dev)
        dBu = torch.randn((B, S, Ch, N), generator=gen, device=dev)
        C = torch.randn((B, S, N), generator=gen, device=dev)
        h0 = torch.randn((B, Ch, N), generator=gen, device=dev) if S == 1 else None
        ms = graph_ms(torch, lambda: mamba_fwd(dA, dBu, C, h0, with_state=True), iters=20)
        plain_ms = graph_ms(torch, lambda: ref.mamba_scan_ref(dA, dBu, C, h0, with_state=True),
                            iters=2, reps=3)
        nbytes = f32 * (2 * B * S * Ch * N + B * S * N + B * S * Ch + B * Ch * N
                        + (B * Ch * N if h0 is not None else 0))
        flops = 4 * B * S * Ch * N  # h: a multiply and an add; y: a multiply and an add
        times[label] = (ms, plain_ms, max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3)
        print(f"[scans] mamba {label} shape B={B} S={S} Ch={Ch} N={N} f32: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms (device times, CUDA graph); bound "
              f"{times[label][2] * 1e3:.3f} us by bytes ({nbytes} B, {flops} FLOP); no library "
              f"call computes the scan")
        del dA, dBu, C, h0
    ms, plain_ms, bound = times["prefill"]
    recs.append({
        "name": "mamba_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:46",
        "launches": None, "max_abs_err": errs["mamba_scan_fwd"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
    })
    B, W = 4, 2560
    for label, S in (("prefill", 512), ("decode", 1)):
        a = torch.rand((B, S, W), generator=gen, device=dev)
        g = torch.randn((B, S, W), generator=gen, device=dev)
        h0 = torch.randn((B, W), generator=gen, device=dev) if S == 1 else None
        ms = graph_ms(torch, lambda: rglru_fwd(a, g, h0), iters=20)
        plain_ms = graph_ms(torch, lambda: ref.rglru_scan_ref(a, g, h0), iters=2, reps=3)
        nbytes = f32 * (3 * B * S * W + (B * W if h0 is not None else 0))
        flops = 2 * B * S * W
        times[label] = (ms, plain_ms, max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3)
        print(f"[scans] rglru {label} shape B={B} S={S} W={W} f32: kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms (device times, CUDA graph); bound {times[label][2] * 1e3:.3f} "
              f"us by bytes ({nbytes} B, {flops} FLOP); no library call computes the scan")
    ms, plain_ms, bound = times["prefill"]
    recs.append({
        "name": "rglru_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:42",
        "launches": None, "max_abs_err": errs["rglru_scan_fwd"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
    })
    return recs


def _bound(nbytes: int, flops: int) -> tuple[float, str, str]:
    """(bound ms, "bytes" or "operations", a description of both): bytes at
    the HBM rate against f32 operations at the CUDA cores' rate, whichever
    takes longer."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, (f"{nbytes} B: {t_bytes * 1e3:.3f} us; {flops} f32 "
                                     f"operations: {t_ops * 1e3:.3f} us")


def _mamba_inputs(torch, gen, B: int, S: int, Ch: int, N: int, dt, with_h0: bool,
                  R: int = 8) -> dict:
    """The fused mamba scan's inputs as the model makes them: dt =
    softplus(...), A = -exp(A_log) f32, B and C slices of one projection
    [B, S, R + 2N] (strided), D f32, h0 f32."""
    from repro_torch.kernels.ref import softplus

    dev = torch.device("cuda")
    proj = torch.randn((B, S, R + 2 * N), generator=gen, device=dev).to(dt)
    return {
        "u": torch.randn((B, S, Ch), generator=gen, device=dev).to(dt),
        "dt": softplus(torch.randn((B, S, Ch), generator=gen, device=dev) - 1.0).to(dt),
        "A": -torch.exp(0.5 * torch.randn((Ch, N), generator=gen, device=dev)),
        "B_ssm": proj[..., R:R + N], "C_ssm": proj[..., R + N:],
        "D": torch.randn((Ch,), generator=gen, device=dev),
        "h0": torch.randn((B, Ch, N), generator=gen, device=dev) if with_h0 else None,
    }


def _rel_check(torch, label: str, got, want, tol: float) -> float:
    """max |got - want| / max |want| within ``tol``, finite, same dtype and
    shape; returns max |got - want|."""
    check(got.dtype == want.dtype and got.shape == want.shape, f"{label}: dtype or shape")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite values")
    rel, _ = rel_err(torch, got, want)
    err = float((got.float() - want.float()).abs().max())
    print(f"[scans] {label}: max |err| / max |plain| {rel:.3e} (tol {tol}), max_abs_err "
          f"{err:.3e}")
    check(rel <= tol, f"{label}: the kernel disagrees with its plain version")
    return err


def phase_fused_scans(torch, ref, scan_fwd, gated_fwd) -> list:
    """The two fused scan kernels the recurrent models run: the selective
    scan (mamba's discretisation inside the kernel) and the gated RG-LRU,
    against their plain versions at S in {1, 7, 128, 512} at the serving
    widths and at odd widths and state sizes, with and without an initial
    state, in f32 and bf16 (the selective scan also updating its state in
    place, as the decode does); then timed at the serving shapes beside
    their plain versions and their bounds.  Returns their two JSON records
    (the prefill shape's numbers; launches filled in later)."""
    from repro_torch.kernels.selective_scan import scan_lanes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    errs = {"selective_scan_fwd": 0.0, "rglru_gated_fwd": 0.0}
    cases = ([(4, S, 8192, 16) for S in (1, 7, 128, 512)]
             + [(2, 7, 8200, 16), (3, 33, 300, 5), (1, 128, 97, 4), (2, 1, 301, 13)])
    for (B, S, Ch, N), dt, with_h0 in itertools.product(
            cases, (torch.float32, torch.bfloat16), (False, True)):
        x = _mamba_inputs(torch, gen, B, S, Ch, N, dt, with_h0)
        y, h = scan_fwd(**x)
        y_ref, h_ref = ref.selective_scan_ref(**x)
        torch.cuda.synchronize()
        label = f"selective_scan B={B} S={S} Ch={Ch} N={N} {dt} h0={with_h0}"
        err = _rel_check(torch, label + " y", y, y_ref, TOL[str(dt).split(".")[-1]])
        _rel_check(torch, label + " h_S", h, h_ref, TOL["float32"])
        if dt == torch.float32:
            errs["selective_scan_fwd"] = max(errs["selective_scan_fwd"], err)
        if with_h0:  # the decode's form: the state updated in place
            state = x["h0"].clone()
            y2, h2 = scan_fwd(**dict(x, h0=state), h_out=state)
            torch.cuda.synchronize()
            check(h2.data_ptr() == state.data_ptr() and torch.equal(h2, h)
                  and torch.equal(y2, y), f"{label}: the in-place update differs")
        del x, y, h, y_ref, h_ref
    cases = [(4, S, 2560) for S in (1, 7, 128, 512)] + [(2, 7, 2500), (3, 33, 300)]
    bitwise = True
    for (B, S, W), dt, with_h0 in itertools.product(
            cases, (torch.float32, torch.bfloat16), (False, True)):
        x = torch.randn((B, S, W), generator=gen, device=dev).to(dt)
        r = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev)).to(dt)
        i = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev)).to(dt)
        lam = torch.randn((W,), generator=gen, device=dev)
        h0 = torch.randn((B, W), generator=gen, device=dev) if with_h0 else None
        y, h = gated_fwd(x, r, i, ref.rglru_decay(lam), h0)
        y_ref, h_ref = ref.rglru_gated_scan_ref(x, r, i, lam, h0)
        torch.cuda.synchronize()
        label = f"rglru_gated B={B} S={S} W={W} {dt} h0={with_h0}"
        same = torch.equal(y, y_ref) and torch.equal(h, h_ref)
        err = _rel_check(torch, label + f" y (bitwise: {same})", y, y_ref,
                         RGLRU_FUSED_REL_TOL if dt == torch.float32 else TOL["bfloat16"])
        _rel_check(torch, label + " h_S", h, h_ref, RGLRU_FUSED_REL_TOL)
        if dt == torch.float32:
            bitwise = bitwise and same
            errs["rglru_gated_fwd"] = max(errs["rglru_gated_fwd"], err)
    print(f"[scans] rglru_gated f32 outputs bitwise their plain version's in every case: "
          f"{bitwise}")

    # the serving shapes, as the models call the kernels in bf16: prefill from
    # zeros, decode (S = 1) from a state (mamba: updated in place)
    recs, bf = [], 2  # bytes per bf16 element
    B, Ch, N, R = 4, 8192, 16, 256  # falcon-mamba-7b: d_inner 8192, N 16, dt_rank 256
    times = {}
    for label, S in (("prefill", 512), ("decode", 1)):
        x = _mamba_inputs(torch, gen, B, S, Ch, N, torch.bfloat16, S == 1, R=R)
        state = x["h0"]
        ms = graph_ms(torch, lambda: scan_fwd(**x, h_out=state), iters=20)
        plain_ms = graph_ms(torch, lambda: ref.selective_scan_ref(**x), iters=2, reps=3)
        nbytes = (bf * (3 * B * S * Ch + 2 * B * S * N) + 4 * (Ch * N + Ch + B * Ch * N)
                  + (4 * B * Ch * N if S == 1 else 0))
        # per state element and step: dt * A, exp, dA * h, dtu * B, + , h * C, + ;
        # per channel and step: dt * u, D * u, +
        flops = 7 * B * S * Ch * N + 3 * B * S * Ch
        bound, by, both = _bound(nbytes, flops)
        times[label] = (ms, plain_ms, bound, by)
        print(f"[scans] selective_scan {label} shape B={B} S={S} Ch={Ch} N={N} bf16 "
              f"(B, C strided slices of the projection){' h updated in place' if S == 1 else ''}"
              f": kernel {ms:.5f} ms (lanes {scan_lanes(B, Ch)}), plain {plain_ms:.5f} ms "
              f"(device times, CUDA graph); bound {bound * 1e3:.3f} us by {by} ({both}); no "
              f"library call computes the scan")
        if S > 1:
            lanes_ms = {n: graph_ms(torch, lambda: scan_fwd(**x, _lanes=n), iters=20)
                        for n in (1, 2, 4)}
            print(f"[scans] selective_scan prefill by threads per channel: "
                  + ", ".join(f"{n}: {t:.5f} ms" for n, t in lanes_ms.items()))
        del x, state
    ms, plain_ms, bound, by = times["prefill"]
    recs.append({
        "name": "selective_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:46",
        "launches": None, "max_abs_err": errs["selective_scan_fwd"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
    })
    B, W = 4, 2560
    for label, S in (("prefill", 512), ("decode", 1)):
        x = torch.randn((B, S, W), generator=gen, device=dev).to(torch.bfloat16)
        r = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev)).to(torch.bfloat16)
        i = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev)).to(torch.bfloat16)
        lam = torch.randn((W,), generator=gen, device=dev)
        c = ref.rglru_decay(lam)
        h0 = torch.randn((B, W), generator=gen, device=dev) if S == 1 else None
        ms = graph_ms(torch, lambda: gated_fwd(x, r, i, c, h0), iters=20)
        plain_ms = graph_ms(torch, lambda: ref.rglru_gated_scan_ref(x, r, i, lam, h0), iters=2,
                            reps=3)
        nbytes = bf * 4 * B * S * W + 4 * (W + B * W + (B * W if h0 is not None else 0))
        # per element: c * r, exp, i * x, a * a, 1 -, max, sqrt, g, a * h, +
        flops = 10 * B * S * W
        bound, by, both = _bound(nbytes, flops)
        times[label] = (ms, plain_ms, bound, by)
        print(f"[scans] rglru_gated {label} shape B={B} S={S} W={W} bf16: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms (device times, CUDA graph); bound {bound * 1e3:.3f} us "
              f"by {by} ({both}); no library call computes the scan")
    ms, plain_ms, bound, by = times["prefill"]
    recs.append({
        "name": "rglru_gated_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:42",
        "launches": None, "max_abs_err": errs["rglru_gated_fwd"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
    })
    return recs


def phase_recurrent(torch, arch: str, counters: dict, B: int, prompt: int,
                    gen_tokens: int, smi: str, mesh_launches: dict) -> dict:
    """One recurrent model (ssm or hybrid) at full width and depth, served
    through ``Server.generate``; the launch counts of that run; the same
    weights served on a 1x1 NCCL mesh (``[serve_mesh] (a)``); then the
    kernel path against the plain path in bf16 and f32.  Returns the
    launch counts of the unsharded run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch
    from repro_torch.models.transformer import block_kinds

    tag = arch.split("_")[0]
    cfg = get_config(arch).replace(attn_impl="pallas")
    max_len = prompt + gen_tokens
    server = Server(cfg, device="cuda", max_len=max_len)
    model = server.model
    t0 = time.perf_counter()
    # bf16 weights; A_log, D, lam and the norms stay f32; the f32 weights
    # are dropped (the f32 check below draws them again from the same seed)
    params = model.compute_params(model.init_params(seed=0))
    torch.cuda.synchronize()
    kinds = block_kinds(cfg) if cfg.family == "hybrid" else ["mamba"] * cfg.n_layers
    print(f"[{tag}] {cfg.name} ({cfg.family}): {cfg.n_layers} layers "
          f"({', '.join(f'{kinds.count(k)} {k}' for k in sorted(set(kinds)))}), d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.param_count()} params; f32 init and "
          f"{cfg.compute_dtype} cast in {time.perf_counter() - t0:.3f} s")
    batch = concrete_batch(cfg, B, prompt, device="cuda")
    batch.pop("targets")
    scan = "selective_scan_fwd" if cfg.family == "ssm" else "rglru_gated_fwd"
    per_call = cfg.n_layers if cfg.family == "ssm" else kinds.count("rec")
    decode_steps = gen_tokens - 1
    want = {n: 0 for n in counters}
    want[scan] = per_call * (1 + decode_steps)
    want["prefetch_gather_fwd"] = 1 + decode_steps

    run = time_serve(torch, server, params, batch, gen_tokens, counters, tag)
    tokens, launched = run["tokens"], run["launched"]
    print(f"[{tag}] launches in the first graph run: {launched} (want {want})")
    check(tuple(tokens.shape) == (B, gen_tokens), f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token out of range")
    check(launched == want, f"{cfg.name}: the serve's launch counts are not the path's")
    serve_mesh_one_rank(torch, server, params, batch, gen_tokens, counters, want, smi,
                        mesh_launches)

    # the plain path, teacher-forced on the first 9 generated tokens, in
    # bf16, in bf16 at depth 3, and (the same weights, not cast) in f32
    forced = tokens[:, :9]
    kern16, plain16 = teacher_forced(torch, cfg, params, batch, forced, max_len)
    check(torch.equal(kern16.argmax(-1), forced), "replayed kernel path disagrees with generate")
    check_paths(torch, "bf16 compute", cfg, kern16, plain16, RECURRENT_REL_TOL_BF16, tag=tag)
    del params, server, model
    gc.collect()
    torch.cuda.empty_cache()
    cfg3 = cfg.replace(n_layers=3)
    model3 = Server(cfg3, device="cuda", max_len=max_len).model
    kern3, plain3 = teacher_forced(torch, cfg3, model3.compute_params(model3.init_params(seed=0)),
                                   batch, forced, max_len)
    check_paths(torch, "bf16 compute, depth 3", cfg3, kern3, plain3,
                RECURRENT_REL_TOL_BF16_DEPTH3, tag=tag)
    cfg32 = cfg.replace(compute_dtype="float32")
    params32 = Server(cfg32, device="cuda", max_len=max_len).model.init_params(seed=0)
    kern32, plain32 = teacher_forced(torch, cfg32, params32, batch, forced, max_len)
    check_paths(torch, "f32 compute", cfg32, kern32, plain32, LOGITS_REL_TOL_F32, tag=tag)
    for label, got in (("kernel", kern16), ("plain chunked", plain16)):
        rel, rms = rel_err(torch, got, kern32)
        print(f"[{tag}] bf16 {label} path vs the f32 kernel path: max |logit diff| / max "
              f"|logit| {rel:.4e}, relative rms {rms:.4e}")
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return launched


@contextlib.contextmanager
def routing(torch, force=None):
    """Records, in a list it yields, the experts [T, k] every router call
    (``moe.router_topk``) inside the block chooses.  With ``force`` (a list
    of experts per call), each call takes ``force``'s experts with its own
    gates (its softmax at those experts, renormalised), and the list
    records the experts it would have taken itself."""
    from repro_torch.models import moe

    log = []
    topk = moe.router_topk

    def recording(x2d, router_w, n_experts, k, router_dtype=torch.float32):
        top_p, top_i = topk(x2d, router_w, n_experts, k, router_dtype)
        if force is not None:
            forced = force[len(log)]
            probs = torch.softmax(x2d.to(router_dtype) @ router_w.to(router_dtype), dim=-1)
            top_p = probs.gather(-1, forced)
            top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        log.append(top_i)
        return top_p, (top_i if force is None else forced)

    moe.router_topk = recording
    try:
        yield log
    finally:
        moe.router_topk = topk


def routed_logits(torch, cfg, impl: str, params, batch, tokens, max_len: int, force=None):
    """(logits [B, T, vocab] of one path teacher-forced as in
    ``teacher_forced``, [top-k [T, k] per router call]), under
    ``routing(force)``."""
    with routing(torch, force) as log:
        logits = path_logits(torch, cfg, impl, params, batch, tokens, max_len)
    return logits, log


def choices_differ(cfg, kern: list, other: list) -> list[int]:
    """Per router call, in order, each token's experts in ``other`` that
    ``kern`` did not take; both paths must have made the same calls."""
    check(len(kern) == len(other), f"{cfg.name}: router calls {len(kern)} and {len(other)}")
    return [int((~(b[:, :, None] == a[:, None, :]).any(-1)).sum()) for a, b in zip(kern, other)]


def route_flips(cfg, kern: list, plain: list, prompt_tokens: int) -> tuple[int, list]:
    """(choices on which the two paths differ, [(where, count)]), by router
    call (``choices_differ``).  Calls run layer by layer, the prefill's
    chunk by chunk first."""
    chunk = min(cfg.moe_chunk, prompt_tokens)
    while prompt_tokens % chunk:
        chunk //= 2
    n_chunks = prompt_tokens // chunk
    where = []
    for i, n in enumerate(choices_differ(cfg, kern, plain)):
        if n:
            if i < cfg.n_layers * n_chunks:
                at = f"prefill layer {i // n_chunks} chunk {i % n_chunks}"
            else:
                j = i - cfg.n_layers * n_chunks
                at = f"decode step {j // cfg.n_layers} layer {j % cfg.n_layers}"
            where.append((at, n))
    return sum(n for _, n in where), where


def check_no_host_sync(torch, server, params, batch, tag: str) -> None:
    """One eager decode step under ``torch.cuda.set_sync_debug_mode("error")``:
    any operation that waits for the device from the host raises."""
    logits, cache = server.prefill_fn(params, batch)
    cache = server._pad_cache(cache)
    tok = torch.argmax(logits, dim=-1)
    prompt = server.model.prompt_shape(batch)[1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = server.decode_fn(params, cache, tok, prompt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), f"{server.cfg.name}: non-finite decode logits")
    print(f"[{tag}] one eager decode step under torch.cuda.set_sync_debug_mode('error'): no "
          "host sync")


def phase_moe(torch, arch: str, tag: str, counters: dict, B: int, prompt: int,
              gen_tokens: int, max_len: int) -> dict:
    """One moe model at full width and depth, bf16 weights made on the card
    (``param_dtype="bfloat16"``: ``torch.randn`` in bf16 leaf by leaf; the
    router too, which is read in f32), served through ``Server.generate``
    beside ``generate_eager`` (``time_serve``); the launch counts of the
    first graph run; one eager decode step with no host sync; then, at
    depth 2 and full width, the kernel path against the plain path
    teacher-forced in bf16 and f32 with the router's choices of both paths
    compared layer by layer (f32: none may differ).  Returns the launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch
    from repro_torch.models.common import tree_items

    cfg = get_config(arch).replace(attn_impl="pallas", param_dtype="bfloat16")
    server = Server(cfg, device="cuda", max_len=max_len)
    model = server.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.compute_params(model.init_params(seed=0))  # bf16 as made: no copy
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict(tree_items(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    # what one decode step must read: every weight but the embedding table
    # (B rows of it), or all of it where the head is the tied table
    step_bytes = weight_bytes
    if not cfg.tie_embeddings:
        emb = leaves["embed"]
        step_bytes -= emb.numel() * emb.element_size() - B * emb[0].numel() * emb.element_size()
    bound_ms = step_bytes / HBM_BPS * 1e3
    print(f"[{tag}] {cfg.name} (moe): {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, {cfg.n_experts} experts "
          f"top-{cfg.experts_per_token} (d_ff {cfg.d_ff}), vocab {cfg.vocab_size}, "
          f"{cfg.param_count()} params ({cfg.active_param_count()} active per token), "
          f"{weight_bytes} B of bf16 weights made on the card in {init_s:.3f} s; "
          f"{torch.cuda.memory_allocated()} B allocated")
    print(f"[{tag}] a decode step reads {step_bytes} B of weights (every expert: capacity "
          f"{max(1, int(cfg.capacity_factor * B * cfg.experts_per_token / cfg.n_experts))} "
          f"at B={B}): byte bound {bound_ms:.3f} ms per step at {HBM_BPS / 1e12} TB/s")
    batch = concrete_batch(cfg, B, prompt, device="cuda")
    batch.pop("targets")
    check_no_host_sync(torch, server, params, batch, tag)

    decode_steps = gen_tokens - 1
    run = time_serve(torch, server, params, batch, gen_tokens, counters, tag)
    tokens, launched = run["tokens"], run["launched"]
    n_mma = run["by_variant"]["decode_attention_fwd.launches_mma"]
    want = {n: 0 for n in counters}
    want.update({"flash_attention_fwd": cfg.n_layers,
                 "decode_attention_fwd": cfg.n_layers * decode_steps,
                 "prefetch_gather_fwd": 1 + decode_steps})
    print(f"[{tag}] launches in the first graph run: {launched} (want {want}); flash-decode on "
          f"the tensor cores {n_mma}")
    check(tuple(tokens.shape) == (B, gen_tokens), f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token out of range")
    check(launched == want, f"{cfg.name}: the serve's launch counts are not the path's")
    check(n_mma == cfg.n_layers * decode_steps,
          f"{cfg.name}: the bf16 decode did not run the tensor-core flash-decode")
    # where the captured step's device time goes
    step = server.captured_decode(params, B)
    with torch.inference_mode():  # the static buffers are inference tensors
        step.pos.fill_(prompt)
    profile_run(torch, f"{cfg.name} 8 replays of the captured decode step",
                lambda: [step.replay() for _ in range(8)])
    del params, leaves, server, model, run, step
    gc.collect()
    torch.cuda.empty_cache()

    # depth 2, full width: the kernel path against the plain path, with the
    # router's choices compared (bf16 against the naive path, which rounds P
    # as the kernels do; f32 against the chunked path)
    cfg2 = cfg.replace(n_layers=2)
    for dtype, plain, tol in (("bfloat16", "naive", LOGITS_REL_TOL_BF16_DEPTH2),
                              ("float32", "chunked", LOGITS_REL_TOL_F32)):
        c = cfg2.replace(compute_dtype=dtype, param_dtype=dtype)
        m = Server(c, device="cuda", max_len=max_len).model
        p = m.compute_params(m.init_params(seed=0))
        kern, kern_routes = routed_logits(torch, c, "pallas", p, batch, tokens, max_len)
        # the plain path fed the kernel path's routes: ``own`` records the
        # experts it would have taken, given the same routes upstream
        forced, own = routed_logits(torch, c, plain, p, batch, tokens, max_len,
                                    force=kern_routes)
        flips, where = route_flips(c, kern_routes, own, B * prompt)
        n_choices = sum(r.numel() for r in kern_routes)
        print(f"[{tag}] depth 2 {dtype}: router choices on which the plain {plain} path, fed "
              f"the kernel path's routes, differs from it: {flips} of {n_choices} "
              f"({len(kern_routes)} router calls a path)"
              + (f"; by call: {where}" if where else ""))
        if dtype == "float32":
            # no choice differs, so the forced plain path is the free one
            check(flips == 0, f"{cfg.name}: an f32 routing choice differs between the paths")
            check_paths(torch, f"{dtype} compute, depth 2", c, kern, forced, tol,
                        plain_impl=plain, tag=tag)
        else:
            free, _ = routed_logits(torch, c, plain, p, batch, tokens, max_len)
            rel, rms = rel_err(torch, kern, free)
            print(f"[{tag}] depth 2 {dtype}: the plain {plain} path routing on its own "
                  f"(every flip above and what follows from it): max |logit diff| / max "
                  f"|logit| {rel:.4e}, relative rms {rms:.4e} (not checked)")
            check_paths(torch, f"{dtype} compute, depth 2, the plain path on the kernel "
                        "path's routes", c, kern, forced, tol, plain_impl=plain, tag=tag)
        del m, p, kern, forced, kern_routes, own
        gc.collect()
        torch.cuda.empty_cache()
    return launched


# the encoder-decoder and the M-RoPE model at full width and depth: (arch,
# tag, decoder prompt, cache slots).  whisper's decoder context is 448
# positions: a prompt of 128 and 32 tokens stay inside it
ENC_VLM = (("whisper_large_v3", "whisper", 128, 256), ("qwen2_vl_2b", "qwen2vl", 512, 1024))


def phase_enc_vlm(torch, arch: str, tag: str, counters: dict, B: int, prompt: int,
                  gen_tokens: int, max_len: int, smi: str, mesh_launches: dict) -> dict:
    """whisper-large-v3 (audio frames [B, 1500, d] through the encoder, the
    decoder prompted with tokens) or qwen2-vl-2b (the prompt as embeddings
    at the image layout's positions, no tokens) at full width and depth,
    weights from seed 0 in f32 cast to bf16, served through
    ``Server.generate`` beside ``generate_eager`` (``time_serve``); the
    launch counts of the first graph run, the step's byte bound, a profile
    of 8 replays, one eager decode step with no host sync; for whisper, the
    same weights served on a 1x1 NCCL mesh (``[serve_mesh] (a)``); then at
    depth 2
    (full width) the kernel path against the plain path teacher-forced, in
    bf16 (naive) and f32 (chunked).  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch
    from repro_torch.models.common import tree_items

    cfg = get_config(arch).replace(attn_impl="pallas")
    server = Server(cfg, device="cuda", max_len=max_len)
    model = server.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.compute_params(model.init_params(seed=0))  # bf16 weights, f32 dropped
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = concrete_batch(cfg, B, prompt, device="cuda")
    batch.pop("targets")
    if cfg.embeds_input:
        batch.pop("inputs")
        batch["positions"] = image_positions(torch, B, prompt // 8, 16, 24, prompt // 8)
    # what one decode step reads: the parameters of its access plan (the
    # embedding as B rows, unless it is the tied head), the live self cache
    # halfway through the run and (encdec) the whole cross cache
    t0 = time.perf_counter()
    plan = server.plan(B)
    plan_s = time.perf_counter() - t0
    leaves = dict(tree_items(params))
    nbytes = {p: t.numel() * t.element_size() for p, t in leaves.items()}
    weight_bytes = sum(nbytes[r.path] for r in plan.records)
    if not cfg.tie_embeddings:
        weight_bytes -= nbytes["embed"] - B * nbytes["embed"] // leaves["embed"].shape[0]
    kv_row = cfg.n_layers * B * cfg.n_kv_heads * cfg.head_dim * model.kv_dtype().itemsize
    self_bytes = 2 * kv_row * (prompt + gen_tokens // 2)
    cross_bytes = 2 * kv_row * cfg.enc_positions if cfg.family == "encdec" else 0
    step_bytes = weight_bytes + self_bytes + cross_bytes
    bound_ms = step_bytes / HBM_BPS * 1e3
    print(f"[{tag}] {cfg.name} ({cfg.family}): {cfg.n_layers} layers"
          + (f" + {cfg.enc_layers} encoder layers" if cfg.family == "encdec" else "")
          + f", d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, rope {cfg.rope}, "
          f"{cfg.param_count()} params; {sum(nbytes.values())} B of weights after the f32 init "
          f"and bf16 cast ({init_s:.3f} s); prompt "
          + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}" for k, v in batch.items()))
    print(f"[{tag}] decode step access plan: {len(plan.records)} records, "
          f"{len(plan.collections())} collections (traced in {plan_s:.3f} s); a step reads "
          f"{weight_bytes} B of weights, {self_bytes} B of live self cache, {cross_bytes} B of "
          f"cross cache: byte bound {bound_ms:.3f} ms per step at {HBM_BPS / 1e12} TB/s")
    check_no_host_sync(torch, server, params, batch, tag)

    decode_steps = gen_tokens - 1
    run = time_serve(torch, server, params, batch, gen_tokens, counters, tag)
    tokens, launched = run["tokens"], run["launched"]
    n_mma = run["by_variant"]["decode_attention_fwd.launches_mma"]
    want = {n: 0 for n in counters}
    want.update({"flash_attention_fwd": flash_attentions(cfg),
                 "decode_attention_fwd": cfg.n_layers * decode_steps,
                 "prefetch_gather_fwd": decode_steps + ("inputs" in batch)})
    print(f"[{tag}] launches in the first graph run: {launched} (want {want}); flash-decode on "
          f"the tensor cores {n_mma}")
    check(tuple(tokens.shape) == (B, gen_tokens), f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token out of range")
    check(launched == want, f"{cfg.name}: the serve's launch counts are not the path's")
    check(n_mma == cfg.n_layers * decode_steps,
          f"{cfg.name}: the bf16 decode did not run the tensor-core flash-decode")
    step = server.captured_decode(params, B)
    with torch.inference_mode():  # the static buffers are inference tensors
        step.pos.fill_(prompt)
    profile_run(torch, f"{cfg.name} 8 replays of the captured decode step",
                lambda: [step.replay() for _ in range(8)])
    del step
    if cfg.family == "encdec":
        serve_mesh_one_rank(torch, server, params, batch, gen_tokens, counters, want, smi,
                            mesh_launches)
    del params, leaves, server, model, run
    gc.collect()
    torch.cuda.empty_cache()

    # depth 2, full width: the kernel path against the plain path
    # (bf16 against the naive path, which rounds P as the kernels do; f32
    # against the chunked path)
    cfg2 = cfg.replace(n_layers=2, enc_layers=min(cfg.enc_layers, 2))
    for dtype, plain, tol in (("bfloat16", "naive", LOGITS_REL_TOL_BF16_DEPTH2),
                              ("float32", "chunked", LOGITS_REL_TOL_F32)):
        c = cfg2.replace(compute_dtype=dtype)
        m = Server(c, device="cuda", max_len=max_len).model
        kern, ref_logits = teacher_forced(torch, c, m.compute_params(m.init_params(seed=0)),
                                          batch, tokens, max_len, plain=plain)
        check_paths(torch, f"{dtype} compute, depth 2", c, kern, ref_logits, tol,
                    plain_impl=plain, tag=tag)
        del m, kern, ref_logits
        gc.collect()
        torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------------------
# [mesh]: the multi-device layer (launch/mesh.py, shardings.py, the
# DTensor train step, the MoE mesh paths) on the one card
# ---------------------------------------------------------------------------

# (a) the one-rank NCCL mesh runs chatglm3-6b at the train phase's depth,
# TRAIN_DEPTH.  One rank runs the same kernels on the same tensors in the
# same order as the unsharded step (the vocab-parallel loss gives
# logsumexp's gradient), so its loss and gradients are held bitwise
MESH_ONE_RANK_TOL = 0.0
# (b) four ranks sharing the card over gloo, a 2x2 ("data", "model") mesh:
# chatglm3-6b cut 28 -> 2 (four ranks' f32 state and activations on one
# card), B x S, Trainer steps (the last one profiled for the collectives'
# share); qwen3-moe-30b-a3b's one layer at B x S tokens
MESH_SHARED_DEPTH = 2
MESH_B, MESH_S, MESH_STEPS = 4, 512, 3
MESH_RANKS = 4
MESH_TIMEOUT = 240.0
# (b)'s Trainer losses against the unsharded Trainer's on the same weights
# and batches, relative: bf16 TP partial sums rounded and added in another
# order (read: 2.1e-05, 3.5e-05, 2.6e-05 over the three steps on the H100)
MESH_LOSS_TOL = 1e-4
# (b)'s gradient leaves held against the unsharded step's (bf16, relative to
# each leaf's largest value, the train phase's bound GRAD_REL_TOL; read:
# 8.1e-03 to 1.6e-02, bq's the largest, a sum over every token): the query
# heads' and kv heads' biases (a wrong head slice) and the norms' scales (a
# missing reduction over "model")
MESH_GRAD_LEAVES = ("layers.attn.bq", "layers.attn.bv", "layers.ln1", "layers.ln2",
                    "final_norm")
# the EP and a2a MoE paths against the dense path, relative to the largest
# value: f32 sums in another order; bf16 rounding of the expert products in
# another grouping
MESH_MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _flash_counters():
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
    )

    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq}


def _timed_trainer(torch, trainer, counters: dict, n_steps: int, profile_last: bool = False):
    """``trainer.train(n_steps)`` with each step timed (host clock, the card synced
    before and after) and its launches counted; with ``profile_last`` the
    last step runs under torch.profiler (CPU) and the time the host spent
    in collectives (the ``c10d`` and ``gloo`` events' self time) is summed.
    Returns (losses, [(ms, launches)], the profiled step's (collective ms,
    wall ms) or None, peak bytes)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import full

    inner, steps, coll = trainer.step_fn, [], []

    def step_fn(params, opt_state, batch):
        before = {n: c.launches for n, c in counters.items()}
        last = profile_last and len(steps) == n_steps - 1
        torch.cuda.synchronize()
        ctx = profile(activities=[ProfilerActivity.CPU]) if last else contextlib.nullcontext()
        t = time.perf_counter()
        with ctx as prof:
            out = inner(params, opt_state, batch)
            float(full(out[2]["loss"]))
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        steps.append((ms, {n: c.launches - before[n] for n, c in counters.items()}))
        if last:
            us = sum(ev.self_cpu_time_total for ev in prof.key_averages()
                     if "c10d" in ev.key or "gloo" in ev.key)
            coll.append((us / 1e3, ms))
        return out

    trainer.step_fn = step_fn
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    _, _, losses = trainer.train(n_steps, seed=0)
    return losses, steps, (coll[0] if coll else None), torch.cuda.max_memory_allocated()


def _rel_err(got, want, scale=None) -> float:
    """max |got - want| over ``scale`` (default: max |want|)."""
    scale = float(want.abs().max()) if scale is None else scale
    return float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)


def mesh_one_rank(torch, counters: dict) -> dict:
    """(a) A 1x1 ("data", "model") mesh over NCCL: chatglm3-6b at full width
    (depth TRAIN_DEPTH), bf16, B=2, S=2048.  One step's loss and every
    gradient leaf on the mesh (DTensor parameters and batch, under
    ``activate_sharding``) against the unsharded step on the same
    parameters and batch, within MESH_ONE_RANK_TOL, with equal flash
    launches; then two ``Trainer(mesh=)`` steps beside two unsharded
    ``Trainer`` steps: losses (MESH_ONE_RANK_TOL), launches per step, ms per
    step (the difference is DTensor's host cost).  Returns the mesh run's
    launches."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import batch_pspecs, logical_rules, named
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import Trainer, full
    from repro_torch.models.common import activate_sharding, tree_items
    from repro_torch.models.model import Model

    B, S, L = 2, 2048, TRAIN_DEPTH
    cfg = get_config("chatglm3_6b").replace(n_layers=L, attn_impl="pallas")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cuda", backend="nccl")
            shape = ShapeConfig("train", "train", S, B)
            model = Model(cfg, "cuda")
            params = model.init_params(seed=0)
            batch = _device_batch(torch, cfg, B, S)

            def grads(mesh_on: bool):
                for c in counters.values():
                    c.launches = 0
                if not mesh_on:
                    loss, g = loss_and_grads(model, params, batch)
                else:
                    rules = logical_rules(cfg, shape, mesh)
                    ps = named(mesh, model.param_pspecs(rules), params)
                    bs = named(mesh, batch_pspecs(cfg, shape, mesh), batch)
                    with activate_sharding(mesh, rules):
                        loss, g = loss_and_grads(model, ps, bs)
                    g = {p: full(t) for p, t in tree_items(g)}
                    loss = full(loss)
                torch.cuda.synchronize()
                return float(loss), dict(tree_items(g)), {n: c.launches
                                                          for n, c in counters.items()}

            uloss, ug, ucount = grads(False)
            mloss, mg, mcount = grads(True)
            tree_max = max(float(g.abs().max()) for g in ug.values())
            worst, worst_path = 0.0, ""
            for path, want in ug.items():
                rel = _rel_err(mg[path], want, tree_max if path in ZERO_GRAD_LEAVES else None)
                if rel > worst:
                    worst, worst_path = rel, path
            loss_rel = abs(mloss - uloss) / abs(uloss)
            tol = MESH_ONE_RANK_TOL
            print(f"[mesh] (a) 1x1 NCCL mesh, chatglm3-6b depth {L} (full width), B={B} S={S}, "
                  f"bf16: loss {mloss:.6f} on the mesh, {uloss:.6f} unsharded (relative "
                  f"{loss_rel:.3e}, tol {tol}); worst gradient leaf {worst_path or '(none)'} at "
                  f"{worst:.3e} (tol {tol}); launches mesh {mcount}, unsharded {ucount}")
            check(loss_rel <= tol, "[mesh] (a) the mesh loss disagrees")
            check(worst <= tol, "[mesh] (a) the mesh gradients disagree")
            check(mcount == ucount and mcount["flash_attention_fwd"] > 0,
                  "[mesh] (a) the mesh step's flash launches are not the unsharded step's")
            del params, batch, ug, mg
            gc.collect()
            torch.cuda.empty_cache()

            runs = {}
            for name, kw in (("unsharded", {}), ("mesh", {"mesh": mesh})):
                trainer = Trainer(cfg, device="cuda", global_batch=B, seq_len=S, total_steps=2,
                                  log_every=10**9, **kw)
                runs[name] = _timed_trainer(torch, trainer, counters, 2)
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
            (ul, us, _, upeak), (ml, ms, _, mpeak) = runs["unsharded"], runs["mesh"]
            print(f"[mesh] (a) Trainer 2 steps: losses mesh {ml}, unsharded {ul}; ms per step "
                  f"mesh {[round(t, 3) for t, _ in ms]}, unsharded "
                  f"{[round(t, 3) for t, _ in us]}; launches per step mesh {ms[-1][1]}, "
                  f"unsharded {us[-1][1]}; peak B mesh {mpeak}, unsharded {upeak}")
            check(len(ml) == len(ul) == 2
                  and all(abs(a - b) / abs(b) <= tol for a, b in zip(ml, ul)),
                  "[mesh] (a) Trainer(mesh=) losses disagree with the unsharded Trainer's")
            check(all(m[1] == u[1] for m, u in zip(ms, us)),
                  "[mesh] (a) Trainer(mesh=) launches differ from the unsharded Trainer's")
            return {n: sum(c[n] for _, c in ms) for n in counters}
        finally:
            dist.destroy_process_group()


def _mesh_grad_leaves(torch, cfg, mesh=None) -> tuple:
    """One step's loss and the MESH_GRAD_LEAVES of its gradient (full, as
    numpy arrays, which a rank can send back) at chatglm3-6b's seed-0
    weights on the Trainer's first batch: unsharded, or on ``mesh``
    (parameters and batch placed by the rules)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.shardings import batch_pspecs, logical_rules, named
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import full
    from repro_torch.models.common import activate_sharding, tree_items
    from repro_torch.models.model import Model

    model = Model(cfg, "cuda")
    params = model.init_params(seed=0)
    batch = _device_batch(torch, cfg, MESH_B, MESH_S)
    if mesh is None:
        loss, g = loss_and_grads(model, params, batch)
    else:
        shape = ShapeConfig("train", "train", MESH_S, MESH_B)
        rules = logical_rules(cfg, shape, mesh)
        params = named(mesh, model.param_pspecs(rules), params)
        batch = named(mesh, batch_pspecs(cfg, shape, mesh), batch)
        with activate_sharding(mesh, rules):
            loss, g = loss_and_grads(model, params, batch)
    g = dict(tree_items(g))
    return float(full(loss)), {k: full(g[k]).float().cpu().numpy() for k in MESH_GRAD_LEAVES}


def mesh_rank(rank: int, world: int) -> dict:
    """(b) One of four ranks sharing the card, a 2x2 mesh over gloo:
    chatglm3-6b at full width, depth MESH_SHARED_DEPTH, one step's loss
    and gradient leaves (``_mesh_grad_leaves``), then ``Trainer(mesh=)``
    for MESH_STEPS steps; then qwen3-moe-30b-a3b's one layer (128 experts,
    64 a rank) through ``moe_apply_ep`` and ``moe_apply_ep_a2a`` against
    ``moe_apply_dense``, f32 and bf16, the routes compared in f32.  Returns
    what the parent prints and checks."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import PSpec, named
    from repro_torch.launch.train import Trainer, full
    from repro_torch.models.common import init_from_template
    from repro_torch.models.model import _moe_tmpl
    from repro_torch.models.moe import moe_apply_dense, moe_apply_ep, moe_apply_ep_a2a

    counters = _flash_counters()
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda", backend="gloo")
    out = {"rank": rank}
    cfg = get_config("chatglm3_6b").replace(n_layers=MESH_SHARED_DEPTH, attn_impl="pallas")
    out["grad_loss"], out["grads"] = _mesh_grad_leaves(torch, cfg, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, mesh=mesh, global_batch=MESH_B, seq_len=MESH_S,
                      total_steps=MESH_STEPS, log_every=10**9)
    losses, steps, coll, peak = _timed_trainer(torch, trainer, counters, MESH_STEPS,
                                               profile_last=True)
    out.update(losses=losses, step_ms=[ms for ms, _ in steps], launches=steps[0][1],
               coll=coll, peak=peak)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = get_config("qwen3_moe_30b_a3b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = init_from_template(_moe_tmpl(mcfg), gen, torch.float32, "cuda")
    x = 0.1 * torch.randn((MESH_B, MESH_S, mcfg.d_model), generator=gen, device="cuda")
    bank = PSpec("model", None, None)
    lp = named(mesh, {"router": PSpec(None, None), "we_gate": bank, "we_up": bank,
                      "we_down": bank}, layer)
    every = ("data", "model")
    row = mesh.get_coordinate()[0] * 2 + mesh.get_coordinate()[1]  # this rank's a2a row
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        xd = x.to(dtype)
        with routing(torch) as ep_routes:
            ep = full(moe_apply_ep(named(mesh, PSpec("data", None, None), xd), lp, mcfg,
                                   dtype, mesh, "data", "model"))
        with routing(torch) as a2a_routes:
            a2a = full(moe_apply_ep_a2a(named(mesh, PSpec(every, None, None), xd), lp, mcfg,
                                        dtype, mesh, every, "model"))
        with routing(torch) as dense_routes:
            dense = moe_apply_dense(xd, layer, mcfg, dtype)
        with routing(torch) as row_routes:
            dense_rows = torch.cat([moe_apply_dense(xd[r:r + 1], layer, mcfg, dtype)
                                    for r in range(MESH_B)])
        scale = float(dense.float().abs().max())
        out[f"moe_ep_{tag}"] = float((ep.float() - dense.float()).abs().max()) / scale
        out[f"moe_a2a_{tag}"] = float((a2a.float() - dense_rows.float()).abs().max()) / scale
        if dtype == torch.float32:
            data = mesh.get_coordinate()[0]
            n_chunks = len(dense_routes) // 2  # the dense path's chunks of each data shard
            out["routes_equal"] = (
                all(torch.equal(a, b) for a, b in
                    zip(ep_routes, dense_routes[data * n_chunks:(data + 1) * n_chunks]))
                and len(a2a_routes) == 1 and torch.equal(a2a_routes[0], row_routes[row]))
    return out


def mesh_shared_card(torch) -> dict:
    """(b) in MESH_RANKS processes (``launch.spawn.run_ranks``, gloo, CUDA
    tensors): the parent runs the unsharded step's gradient leaves and the
    unsharded ``Trainer`` for MESH_STEPS steps on the same weights (seed 0)
    and batches, starts the ranks, and holds what they return to those; a
    rank that fails or hangs kills the others and fails the phase."""
    from repro_torch.configs import get_config
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.launch.train import Trainer

    cfg = get_config("chatglm3_6b").replace(n_layers=MESH_SHARED_DEPTH, attn_impl="pallas")
    ref_grad_loss, ref_grads = _mesh_grad_leaves(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, device="cuda", global_batch=MESH_B, seq_len=MESH_S,
                      total_steps=MESH_STEPS, log_every=10**9)
    _, _, ref = trainer.train(MESH_STEPS, seed=0)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        outs = run_ranks(mesh_rank, MESH_RANKS, backend="gloo", timeout=MESH_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"[mesh] (b) the four-rank run failed: {e}")
    print(f"[mesh] (b) 2x2 mesh, 4 ranks on one card over gloo, chatglm3-6b depth "
          f"{MESH_SHARED_DEPTH} (full width), B={MESH_B} S={MESH_S}, bf16, "
          f"{MESH_STEPS} Trainer steps; qwen3-moe-30b-a3b one layer, 128 experts, 64 a rank, "
          f"{MESH_B * MESH_S} tokens: {time.perf_counter() - t:.1f} s; unsharded Trainer "
          f"losses {ref}, step loss {ref_grad_loss}")
    gtol = GRAD_REL_TOL["bfloat16"]
    for o in outs:
        rels = [abs(a - b) / abs(b) for a, b in zip(o["losses"], ref)]
        grel = {k: _rel_err(torch.from_numpy(o["grads"][k]), torch.from_numpy(ref_grads[k]))
                for k in MESH_GRAD_LEAVES}
        coll_ms, wall_ms = o["coll"]
        print(f"[mesh] (b) rank {o['rank']}: losses {o['losses']} (vs unsharded "
              f"{[float(f'{r:.3e}') for r in rels]}, tol {MESH_LOSS_TOL}); step loss vs "
              f"unsharded {abs(o['grad_loss'] - ref_grad_loss) / abs(ref_grad_loss):.3e}, "
              f"gradient leaves vs unsharded "
              f"{ {k: float(f'{v:.3e}') for k, v in grel.items()} } (tol {gtol}); step ms "
              f"{[round(x, 3) for x in o['step_ms']]}; profiled step {wall_ms:.3f} ms, "
              f"collectives {coll_ms:.3f} ms (share {coll_ms / wall_ms:.4f}); flash launches "
              f"per step {o['launches']}; peak {o['peak']} B; moe ep vs dense f32 "
              f"{o['moe_ep_float32']:.3e} bf16 {o['moe_ep_bfloat16']:.3e}, a2a vs dense per "
              f"row f32 {o['moe_a2a_float32']:.3e} bf16 {o['moe_a2a_bfloat16']:.3e}, routes "
              f"equal in f32 {o['routes_equal']}")
        check(len(rels) == MESH_STEPS and all(r <= MESH_LOSS_TOL for r in rels),
              f"[mesh] (b) rank {o['rank']}: the Trainer's losses disagree with the unsharded "
              f"Trainer's")
        check(abs(o["grad_loss"] - ref_grad_loss) <= MESH_LOSS_TOL * abs(ref_grad_loss)
              and all(v <= gtol for v in grel.values()),
              f"[mesh] (b) rank {o['rank']}: the step's loss or gradients disagree with the "
              f"unsharded step's")
        check(all(o["launches"][n] > 0 for n in o["launches"]),
              f"[mesh] (b) rank {o['rank']}: a flash kernel was not launched")
        for key, tol in (("moe_ep", MESH_MOE_TOL), ("moe_a2a", MESH_MOE_TOL)):
            for tag in ("float32", "bfloat16"):
                check(o[f"{key}_{tag}"] <= tol[tag], f"[mesh] (b) rank {o['rank']}: {key} "
                                                     f"{tag} disagrees with the dense path")
        check(o["routes_equal"], f"[mesh] (b) rank {o['rank']}: an f32 route differs")
    return {n: sum(o["launches"][n] for o in outs) for n in outs[0]["launches"]}


def phase_mesh(torch) -> dict:
    """(a) then (b); returns the flash launches of (a)'s Trainer(mesh=) run."""
    t = time.perf_counter()
    counters = _flash_counters()
    launches = mesh_one_rank(torch, counters)
    gc.collect()
    torch.cuda.empty_cache()
    shared = mesh_shared_card(torch)
    print(f"[mesh] launches: (a) Trainer(mesh=) {launches}; (b) the ranks' first steps "
          f"{shared}; phase {time.perf_counter() - t:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# [serve_mesh]: sharded serving (``launch/serve.py:Server(mesh=)``)
# ---------------------------------------------------------------------------

# (a) chatglm3-6b at full width and depth on a 1x1 ("data", "model") NCCL
# mesh, served as the slice is (and falcon-mamba-7b, recurrentgemma-2b and
# whisper-large-v3 inside their own phases, on their weights);
# one rank runs the unsharded step's kernels on the same tensors and the
# merge of one (o, lse) part is that part, so the captured generate is held
# bitwise to the unsharded one.  (b) four ranks sharing the card over gloo
# (a 2x2 mesh): SERVE_MESH_CELLS at full width, cut in depth (four ranks'
# weights and the unsharded reference on one card), bf16 weights made on
# the card, B x prompt, the unsharded Server's tokens fed back
# (teacher-forced), eager (gloo's collectives run on the host: no capture);
# the ssm, hybrid and encdec weights drawn in f32 and cast (the scans read
# A_log, D and lam in f32).
# Per arch: (depth, cache slots, tokens).  The self caches and the hybrid's
# ring are 512 or 256 slots, 256 or 128 a model rank: flash-decode's route,
# rank 1's shard empty after the 128-token prompt and filled by the decode;
# the new families take 64 tokens (recurrentgemma's ring of min(2048, 256)
# slots and whisper's 256-slot cache hold 128 + 63 positions)
SERVE_MESH_CELLS = {
    "chatglm3_6b": (2, 512, 160),
    "qwen3_moe_30b_a3b": (2, 512, 160),
    "falcon_mamba_7b": (2, 512, 64),
    "recurrentgemma_2b": (3, 256, 64),  # one (rec, rec, attn) pattern
    "whisper_large_v3": (2, 256, 64),  # 2 decoder and 2 encoder layers
}
SERVE_MESH_B, SERVE_MESH_PROMPT = 4, 128
SERVE_MESH_PROFILED = 8  # the last decode steps, under torch.profiler
# the batch-1 ``long`` layout on a (2, 2, 1) ("pod", "data", "model") mesh:
# (arch, depth, cache slots, prompt, tokens); the ring's 2048 slots (the
# local window) lie over ("pod", "data"), 512 a rank, and the prompt fills
# them, so the first decode step wraps it
SERVE_POD = ("recurrentgemma_2b", 3, 4096, 2048, 64)


def _serving_counters() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.prefetch_gather import prefetch_gather_fwd
    from repro_torch.kernels.rglru_scan import rglru_gated_fwd
    from repro_torch.kernels.selective_scan import selective_scan_fwd

    return {"flash_attention_fwd": flash_attention_fwd,
            "decode_attention_fwd": decode_attention_fwd,
            "prefetch_gather_fwd": prefetch_gather_fwd,
            "selective_scan_fwd": selective_scan_fwd, "rglru_gated_fwd": rglru_gated_fwd}


def _serve_want(cfg, steps: int) -> dict:
    """The serving kernels' launches of a prefill and ``steps`` decode steps
    of ``cfg`` (bf16, ``attn_impl="pallas"``, cache shards): the flash
    forward once per attention of the prefill (whisper: its decoder, encoder
    and cross-attention; the hybrid's window takes the plain path),
    flash-decode once per layer per step, a scan once per recurrent layer
    per call, the gather once per call."""
    from repro_torch.models.transformer import block_kinds

    want = dict.fromkeys(_serving_counters(), 0)
    want["prefetch_gather_fwd"] = 1 + steps
    if cfg.family == "ssm":
        want["selective_scan_fwd"] = cfg.n_layers * (1 + steps)
    elif cfg.family == "hybrid":
        want["rglru_gated_fwd"] = block_kinds(cfg).count("rec") * (1 + steps)
    else:
        want["flash_attention_fwd"] = flash_attentions(cfg)
        want["decode_attention_fwd"] = cfg.n_layers * steps
    return want


def _zero_counters(counters: dict) -> None:
    for c in counters.values():
        for attr in LAUNCH_COUNTS:
            if hasattr(c, attr):
                setattr(c, attr, 0)


def _replayed_ms(torch, step, pos: int, n: int) -> float:
    """Device ms per replay of a captured decode step from ``pos``, ``n``
    replays back to back between CUDA events."""
    with torch.inference_mode():  # an unsharded step's buffers are inference tensors
        step.pos.fill_(pos)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        step.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _add_launches(total: dict, launched: dict) -> None:
    """``launched``'s kernel counts (not the per-variant ones) added into
    ``total``."""
    for n, v in launched.items():
        if "." not in n:
            total[n] = total.get(n, 0) + v


@contextlib.contextmanager
def one_rank_nccl(torch):
    """A one-rank NCCL process group (a ``FileStore`` in a temporary
    directory) and its 1x1 ("data", "model") mesh, torn down on exit."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            yield make_mesh((1, 1), ("data", "model"), device="cuda", backend="nccl")
        finally:
            dist.destroy_process_group()


def serve_mesh_one_rank(torch, plain, params, batch, gen_tokens: int, counters: dict,
                        want: dict, smi: str, mesh_launches: dict) -> None:
    """(a): ``Server(mesh=)`` on a 1x1 NCCL mesh against ``plain`` (an
    unsharded ``Server`` whose step is captured already) on the same
    full-width, full-depth weights and prompt (chatglm3-6b's here; the ssm,
    hybrid and encdec families' inside their own phases, on their
    weights), both captured (a 4-token warm-up of the mesh run: its
    capture); the counters zeroed just before the mesh ``generate`` and
    read just after, held to ``want`` exactly (flash-decode on the tensor
    cores); tokens equal and logits bitwise the unsharded ``generate``'s;
    the replayed step's device time on and off the mesh, in turns.  The
    mesh run's launches are added into ``mesh_launches``."""
    from repro_torch.launch.serve import Server

    cfg, B, S = plain.cfg, *plain.model.prompt_shape(batch)
    steps = gen_tokens - 1
    t0 = time.perf_counter()
    with one_rank_nccl(torch) as mesh:
        server = Server(cfg, device="cuda", max_len=plain.max_len, mesh=mesh)
        placed = server.place(params)
        t = time.perf_counter()
        server.generate(placed, batch, 4)  # the mesh step's capture
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t
        _zero_counters(counters)
        mt, ml = server.generate(placed, batch, gen_tokens, with_logits=True)
        torch.cuda.synchronize()
        launched = {n: c.launches for n, c in counters.items()}
        n_mma = counters["decode_attention_fwd"].launches_mma
        ut, ul = plain.generate(params, batch, gen_tokens, with_logits=True)
        torch.cuda.synchronize()
        mt, ml = mt.full_tensor(), ml.full_tensor()
        tokens_equal, bitwise = bool(torch.equal(mt, ut)), bool(torch.equal(ml, ul))
        del mt, ml, ut, ul
        ms = {"unsharded": [], "mesh": []}
        for name in ("unsharded", "mesh", "mesh", "unsharded"):
            srv, p = (plain, params) if name == "unsharded" else (server, placed)
            ms[name].append(_replayed_ms(torch, srv.captured_decode(p, B), S, steps))
        del server, placed
    print(f"[serve_mesh] (a) 1x1 NCCL mesh, {cfg.name} ({cfg.family}) full width and depth, "
          f"bf16, B={B} prompt={S} cache {plain.max_len}, {gen_tokens} tokens: first generate "
          f"(the capture) {capture_s:.3f} s; tokens equal {tokens_equal}, logits bitwise "
          f"{bitwise}; launches {launched} (want {want}; flash-decode on the tensor cores "
          f"{n_mma}); captured step replayed back to back, device ms per step (CUDA events, "
          f"{steps} replays, in turns unsharded, mesh, mesh, unsharded): mesh "
          f"{[round(x, 4) for x in ms['mesh']]}, unsharded "
          f"{[round(x, 4) for x in ms['unsharded']]}; {time.perf_counter() - t0:.1f} s; {smi}")
    check(tokens_equal, f"[serve_mesh] (a) {cfg.name}: the mesh's tokens differ from the "
                        "unsharded Server's")
    check(bitwise, f"[serve_mesh] (a) {cfg.name}: the mesh's logits are not bitwise the "
                   "unsharded Server's")
    check(launched == want, f"[serve_mesh] (a) {cfg.name}: the mesh run's launch counts are "
                            "not the path's")
    if want.get("decode_attention_fwd"):
        check(n_mma == want["decode_attention_fwd"],
              f"[serve_mesh] (a) {cfg.name}: flash-decode did not run on the tensor cores")
    _add_launches(mesh_launches, launched)
    gc.collect()
    torch.cuda.empty_cache()


def serve_mesh_rank(rank: int, world: int) -> dict:
    """(b) One of four ranks sharing the card, a 2x2 gloo mesh: for each of
    SERVE_MESH_CELLS, the unsharded ``Server`` on this rank's data shard's
    rows (``generate_eager``: the tokens and the reference logits), then
    ``Server(mesh=)``'s prefill and decode steps fed those tokens, eager,
    the counters zeroed just before and read just after; the logits of
    this rank's rows against the reference's, ms per step (host clock, the
    card synced), the collectives' share of the last SERVE_MESH_PROFILED
    steps, whether the model-1 shard of a k/v cache was empty after the
    prefill and holds keys at the end, and the MoE routes the mesh run
    would have chosen otherwise (it is fed the reference's, as the
    ``[moe]`` phase's plain path is)."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.shardings import PSpec, placements
    from repro_torch.launch.steps import concrete_batch

    counters = _serving_counters()
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda", backend="gloo")
    data, model_rank = mesh.get_coordinate()
    rows2 = placements(mesh, PSpec("data", None))
    rows3 = placements(mesh, PSpec("data", None, None))
    B, S = SERVE_MESH_B, SERVE_MESH_PROMPT
    mine = slice(data * B // 2, (data + 1) * B // 2)
    out = {"rank": rank, "coord": (data, model_rank)}
    for arch, (depth, max_len, T) in SERVE_MESH_CELLS.items():
        t_arch = time.perf_counter()
        cfg = get_config(arch).replace(n_layers=depth, attn_impl="pallas")
        if cfg.family in ("dense", "moe"):  # made in bf16 on the card
            cfg = cfg.replace(param_dtype="bfloat16")
        if cfg.family == "encdec":
            cfg = cfg.replace(enc_layers=depth)
        plain = Server(cfg, device="cuda", max_len=max_len)
        params = plain.model.compute_params(plain.model.init_params(seed=0))
        batch = concrete_batch(cfg, B, S, device="cuda")
        batch.pop("targets")
        with routing(torch) as ref_routes:
            ref_t, ref_l = plain.generate_eager(params, {k: v[mine] for k, v in batch.items()},
                                                T, with_logits=True)
        server = Server(cfg, device="cuda", max_len=max_len, mesh=mesh)
        placed = server.place(params)
        forced = DTensor.from_local(ref_t, mesh, rows2, run_check=False)
        scale = float(ref_l.abs().max())
        worst = [0.0, 0.0]  # prefill, decode
        step_ms, prof_ms, coll_ms = [], 0.0, 0.0
        torch.cuda.synchronize()
        _zero_counters(counters)
        # the moe family: the mesh run takes the reference's experts (bf16
        # rounding in another order flips near-tie router choices), and the
        # choices it would have made are counted against them
        with routing(torch, force=ref_routes or None) as mesh_routes, torch.no_grad():
            p, logits, cache, decoding = server._prefill(placed, batch)
            got = logits.redistribute(mesh, rows3).to_local()
            worst[0] = float((got - ref_l[:, :1]).abs().max()) / scale
            kv = "k" in cache
            empty_after_prefill = kv and float(cache["k"].to_local().abs().max()) == 0.0
            with decoding:
                for i in range(T - 1):
                    last = i == T - 1 - SERVE_MESH_PROFILED
                    if last:
                        prof = profile(activities=[ProfilerActivity.CPU])
                        prof.__enter__()
                        t_prof = time.perf_counter()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    logits, cache = server.decode_fn(p, cache, forced[:, i:i + 1], S + i)
                    got = logits.redistribute(mesh, rows3).to_local()
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t) * 1e3)
                    worst[1] = max(worst[1],
                                   float((got - ref_l[:, i + 1:i + 2]).abs().max()) / scale)
            prof.__exit__(None, None, None)
            prof_ms = (time.perf_counter() - t_prof) * 1e3
            coll_ms = sum(ev.self_cpu_time_total for ev in prof.key_averages()
                          if "c10d" in ev.key or "gloo" in ev.key) / 1e3
        launched = {n: c.launches for n, c in counters.items()}
        launched["decode_attention_fwd.launches_mma"] = counters[
            "decode_attention_fwd"].launches_mma
        differ = (sum(choices_differ(cfg, ref_routes, mesh_routes)),
                  sum(a.numel() for a in ref_routes))
        out[arch] = {
            "prefill_rel": worst[0], "decode_rel": worst[1],
            "step_ms": statistics.median(step_ms[:T - 1 - SERVE_MESH_PROFILED]),
            "profiled_ms": prof_ms, "coll_ms": coll_ms, "launched": launched,
            "want": _serve_want(cfg, T - 1), "kv": kv,
            "empty_after_prefill": empty_after_prefill,
            "filled_at_end": kv and float(cache["k"].to_local().abs().max()) > 0.0,
            "routes": (len(ref_routes), *differ),
            "peak": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t_arch,
        }
        del plain, server, params, placed, cache, p, ref_l
        gc.collect()
        torch.cuda.empty_cache()
    out["pod"] = serve_pod_rank(torch, counters)
    return out


def serve_pod_rank(torch, counters: dict) -> dict:
    """(b) on a (2, 2, 1) ("pod", "data", "model") mesh of the same four
    gloo ranks, SERVE_POD at batch 1: the decode rules' ``long`` layout, the
    states over all three axes, the ring over ("pod", "data") taken as one
    flattened axis, pod-major.  The unsharded ``Server``'s eager run on
    the whole prompt (the reference tokens and logits), then
    ``Server(mesh=)``'s prefill and eager decode steps fed those tokens,
    the counters zeroed just before and read just after; the logits against
    the reference's, ms per step (host clock, the card synced), the
    collectives' share of the last SERVE_MESH_PROFILED steps, and this
    rank's ring slots after the prefill against the slots [r n, (r + 1) n)
    of the unsharded prefill's ring, r = 2 pod + data (bitwise, and the
    largest difference relative to the largest key)."""
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import entry_rank, make_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.shardings import PSpec, placements
    from repro_torch.launch.steps import concrete_batch

    arch, depth, max_len, S, T = SERVE_POD
    t_arch = time.perf_counter()
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cuda", backend="gloo")
    cfg = get_config(arch).replace(n_layers=depth, attn_impl="pallas")
    plain = Server(cfg, device="cuda", max_len=max_len)
    params = plain.model.compute_params(plain.model.init_params(seed=0))
    batch = concrete_batch(cfg, 1, S, device="cuda")
    batch.pop("targets")
    ref_t, ref_l = plain.generate_eager(params, batch, T, with_logits=True)
    with torch.no_grad():
        _, _, ref_cache = plain._prefill(params, batch)[:3]
    server = Server(cfg, device="cuda", max_len=max_len, mesh=mesh)
    placed = server.place(params)
    forced = DTensor.from_local(ref_t, mesh, placements(mesh, PSpec(None, None)),
                                run_check=False)
    scale = float(ref_l.abs().max())
    worst, step_ms = [0.0, 0.0], []
    torch.cuda.synchronize()
    _zero_counters(counters)
    with torch.no_grad():
        p, logits, cache, decoding = server._prefill(placed, batch)
        worst[0] = float((logits.full_tensor() - ref_l[:, :1]).abs().max()) / scale
        ring = cache["k"].to_local()
        r, n = entry_rank(mesh, ("pod", "data")), ring.shape[2]
        want = ref_cache["k"][:, :, r * n:(r + 1) * n]
        slots = (bool(torch.equal(ring, want)),
                 float((ring.float() - want.float()).abs().max() / want.float().abs().max()))
        with decoding:
            for i in range(T - 1):
                if i == T - 1 - SERVE_MESH_PROFILED:
                    prof = profile(activities=[ProfilerActivity.CPU])
                    prof.__enter__()
                    t_prof = time.perf_counter()
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, cache = server.decode_fn(p, cache, forced[:, i:i + 1], S + i)
                got = logits.full_tensor()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                worst[1] = max(worst[1],
                               float((got - ref_l[:, i + 1:i + 2]).abs().max()) / scale)
        prof.__exit__(None, None, None)
        prof_ms = (time.perf_counter() - t_prof) * 1e3
        coll_ms = sum(ev.self_cpu_time_total for ev in prof.key_averages()
                      if "c10d" in ev.key or "gloo" in ev.key) / 1e3
    out = {"coord": tuple(mesh.get_coordinate()), "flat": r, "slots": (r * n, (r + 1) * n),
           "ring_equal": slots, "prefill_rel": worst[0], "decode_rel": worst[1],
           "step_ms": statistics.median(step_ms[:T - 1 - SERVE_MESH_PROFILED]),
           "profiled_ms": prof_ms, "coll_ms": coll_ms,
           "launched": {n: c.launches for n, c in counters.items()},
           "want": _serve_want(cfg, T - 1), "peak": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t_arch}
    del plain, server, params, placed, cache, p, ref_l, ref_cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_mesh_shared_card(torch) -> dict:
    """(b) in four processes (``launch.spawn.run_ranks``, gloo, CUDA
    tensors); a rank that fails or hangs kills the others and fails the
    phase.  Each rank's logits within LOGITS_REL_TOL_BF16_DEPTH2 of the
    unsharded reference's, each serving kernel launched exactly as the path
    says on each rank (``_serve_want``; flash-decode on the tensor cores),
    the model-1 shard of a k/v cache empty after the prefill (the prompt
    fills 128 slots of rank 0's) and holding keys at the end."""
    from repro_torch.launch.spawn import run_ranks

    t = time.perf_counter()
    try:
        outs = run_ranks(serve_mesh_rank, 4, backend="gloo", timeout=2 * MESH_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"[serve_mesh] (b) the four-rank run failed: {e}")
    tol = LOGITS_REL_TOL_BF16_DEPTH2
    print(f"[serve_mesh] (b) 2x2 mesh, 4 ranks on one card over gloo, full width, bf16, "
          f"B={SERVE_MESH_B} prompt={SERVE_MESH_PROMPT}, (depth, cache slots, tokens "
          f"teacher-forced) {SERVE_MESH_CELLS}, eager: {time.perf_counter() - t:.1f} s")
    total = {}
    for o in outs:
        for arch in SERVE_MESH_CELLS:
            r = o[arch]
            L = r["launched"]
            print(f"[serve_mesh] (b) rank {o['rank']} (data, model) {o['coord']} {arch}: logits "
                  f"vs the unsharded Server, max |diff| / max |logit|: prefill "
                  f"{r['prefill_rel']:.3e}, decode {r['decode_rel']:.3e} (tol {tol}); decode "
                  f"{r['step_ms']:.3f} ms per step (median, host clock); the last "
                  f"{SERVE_MESH_PROFILED} steps profiled {r['profiled_ms']:.3f} ms, collectives "
                  f"{r['coll_ms']:.3f} ms (share {r['coll_ms'] / r['profiled_ms']:.4f}); launches "
                  f"{L} (want {r['want']}); model-1 shard empty after the prefill "
                  f"{r['empty_after_prefill']}, holding keys at the end {r['filled_at_end']}; "
                  f"router calls, the mesh's own expert choices that the reference it was fed "
                  f"did not take, and all choices {r['routes']}; peak {r['peak']} B; "
                  f"{r['seconds']:.1f} s")
            check(r["prefill_rel"] <= tol and r["decode_rel"] <= tol,
                  f"[serve_mesh] (b) rank {o['rank']} {arch}: logits disagree with the unsharded "
                  "Server's")
            check({n: L[n] for n in r["want"]} == r["want"]
                  and L["decode_attention_fwd.launches_mma"] == L["decode_attention_fwd"],
                  f"[serve_mesh] (b) rank {o['rank']} {arch}: the serving kernels' launches are "
                  "not the path's (flash-decode on the tensor cores)")
            check(not r["kv"] or (r["filled_at_end"]
                                  and r["empty_after_prefill"] == (o["coord"][1] == 1)),
                  f"[serve_mesh] (b) rank {o['rank']} {arch}: the cache's shards are not filled "
                  "as the positions say")
            for n in r["want"]:
                total[n] = total.get(n, 0) + L[n]
    arch, depth, max_len, S, T = SERVE_POD
    print(f"[serve_mesh] (b) pod mesh (2, 2, 1) (pod, data, model), 4 ranks on one card over "
          f"gloo, {arch} full width, depth {depth}, bf16, B=1 prompt={S}, cache {max_len} "
          f"(ring of {min(max_len, 2048)} slots over (pod, data)), {T} tokens teacher-forced, "
          f"eager")
    for o in outs:
        r = o["pod"]
        L = r["launched"]
        print(f"[serve_mesh] (b) pod rank {o['rank']} (pod, data, model) {r['coord']}, flattened "
              f"(pod, data) index {r['flat']}: ring slots {r['slots']} after the prefill against "
              f"the unsharded prefill's (bitwise, max |diff| / max |key|) {r['ring_equal']}; "
              f"logits vs the unsharded Server, max "
              f"|diff| / max |logit|: prefill {r['prefill_rel']:.3e}, decode "
              f"{r['decode_rel']:.3e} (tol {tol}); decode {r['step_ms']:.3f} ms per step "
              f"(median, host clock); the last {SERVE_MESH_PROFILED} steps profiled "
              f"{r['profiled_ms']:.3f} ms, collectives {r['coll_ms']:.3f} ms (share "
              f"{r['coll_ms'] / r['profiled_ms']:.4f}); launches {L} (want {r['want']}); gated "
              f"RG-LRU launches on this rank {L['rglru_gated_fwd']}; peak {r['peak']} B; "
              f"{r['seconds']:.1f} s")
        check(r["prefill_rel"] <= tol and r["decode_rel"] <= tol,
              f"[serve_mesh] (b) pod rank {o['rank']}: logits disagree with the unsharded "
              "Server's")
        check(r["ring_equal"][0] and r["flat"] == 2 * r["coord"][0] + r["coord"][1],
              f"[serve_mesh] (b) pod rank {o['rank']}: its ring slots are not the pod-major "
              "shard of the prompt's keys")
        check({n: L[n] for n in r["want"]} == r["want"],
              f"[serve_mesh] (b) pod rank {o['rank']}: the serving kernels' launches are not "
              "the path's")
        for n in r["want"]:
            total[n] = total.get(n, 0) + L[n]
    return total


# (c), only with ``--cards``: one rank per card over NCCL (the production
# backend), a 2x2 mesh, at full width and depth, served as (a): chatglm3-6b
# twice, under NCCL's own choice of algorithm, then with ring and simple
# fixed for every collective, which tells a difference that the
# collectives' reduction order makes (NCCL may choose another algorithm for
# a captured launch than for an eager one) from a difference of the step
# itself; then the ssm, hybrid and encdec families under the default, in
# one process group.  Per arch: (B, prompt, tokens, cache slots), the
# cells of the unsharded phases
SERVE_CARDS = 4
SERVE_CARDS_NCCL = ({}, {"NCCL_ALGO": "Ring", "NCCL_PROTO": "Simple"})
SERVE_CARDS_CELLS = {
    "chatglm3_6b": (4, 512, 32, 1024),
    "falcon_mamba_7b": (4, 512, 32, 544),
    "recurrentgemma_2b": (4, 512, 32, 544),  # a ring of 544 slots, 272 a model rank
    "whisper_large_v3": (4, 128, 32, 256),
}
# and recurrentgemma-2b at full depth and batch 1 on a (2, 2, 1) ("pod",
# "data", "model") mesh: the ``long`` layout, its ring's 2048 slots over
# ("pod", "data"), wrapped from the first decode step
SERVE_CARDS_POD_CELLS = {"recurrentgemma_2b": (1, 2048, 64, 4096)}
SERVE_CARDS_RUNS = tuple((("chatglm3_6b",), env, (2, 2)) for env in SERVE_CARDS_NCCL) + (
    (("falcon_mamba_7b", "recurrentgemma_2b", "whisper_large_v3"), SERVE_CARDS_NCCL[0], (2, 2)),
    (("recurrentgemma_2b",), SERVE_CARDS_NCCL[0], (2, 2, 1)))


def _forced_mesh_logits(torch, server, params, batch, tokens):
    """This rank's rows of ``server``'s (a mesh's) logits [b, T, vocab] fed
    ``tokens`` (a DTensor [B, T] split over the batch): the prefill, then
    T - 1 eager decode steps, each given the next token of ``tokens``."""
    from repro_torch.launch.shardings import PSpec, placements

    mesh = server.mesh
    rows = placements(mesh, PSpec(server._rules("decode", tokens.shape[0],
                                                 server.max_len)["batch"], None, None))
    S = server.model.prompt_shape(batch)[1]
    with server._serving():
        p, logits, cache, decoding = server._prefill(params, batch)
        out = [logits.redistribute(mesh, rows).to_local()]
        with decoding:
            for i in range(tokens.shape[1] - 1):
                logits, cache = server.decode_fn(p, cache, tokens[:, i:i + 1], S + i)
                out.append(logits.redistribute(mesh, rows).to_local())
    return torch.cat(out, dim=1)


def serve_cards_rank(rank: int, world: int, archs: tuple, nccl_env: dict,
                     mesh_shape: tuple) -> dict:
    """(c) One rank of an NCCL mesh of ``mesh_shape`` (2x2 ("data",
    "model"), or (2, 2, 1) ("pod", "data", "model") with the
    SERVE_CARDS_POD_CELLS), one card each, under ``nccl_env``, for each of
    ``archs`` (its SERVE_CARDS_CELLS cell) in turn:
    ``Server(mesh=)``'s captured ``generate`` (the sharded step with its
    NCCL collectives inside the graph) and its launches; its logits against
    the mesh's eager steps and against the unsharded ``Server`` on this
    card over this rank's rows, both fed the captured run's tokens; the
    replayed step's device time beside the unsharded one's, in turns."""
    import os

    import torch

    os.environ.update(nccl_env)  # read when the communicators are made
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import entry_rank, entry_size, make_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch

    counters = _serving_counters()
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = make_mesh(mesh_shape, axes, device="cuda", backend="nccl")
    cells = SERVE_CARDS_CELLS if len(mesh_shape) == 2 else SERVE_CARDS_POD_CELLS
    out = {"rank": rank, "coord": tuple(mesh.get_coordinate())}
    for arch in archs:
        B, prompt, gen_tokens, max_len = cells[arch]
        cfg = get_config(arch).replace(attn_impl="pallas")
        server = Server(cfg, device="cuda", max_len=max_len, mesh=mesh)
        rows_rule = server._rules("decode", B, max_len)["batch"]  # None: rows whole
        n_rows, i_rows = entry_size(mesh, rows_rule), entry_rank(mesh, rows_rule)
        mine = slice(i_rows * B // n_rows, (i_rows + 1) * B // n_rows)
        plain = Server(cfg, device="cuda", max_len=max_len)
        params = plain.model.compute_params(plain.model.init_params(seed=0))
        placed = server.place(params)
        batch = concrete_batch(cfg, B, prompt, device="cuda")
        batch.pop("targets")
        rows = {k: v[mine] for k, v in batch.items()}
        t = time.perf_counter()
        server.generate(placed, batch, 4)  # the capture
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t
        plain.generate(params, rows, 4)
        torch.cuda.synchronize()
        _zero_counters(counters)
        mt, ml = server.generate(placed, batch, gen_tokens, with_logits=True)
        torch.cuda.synchronize()
        launched = {n: c.launches for n, c in counters.items()}
        launched["decode_attention_fwd.launches_mma"] = counters[
            "decode_attention_fwd"].launches_mma
        eager = _forced_mesh_logits(torch, server, placed, batch, mt)
        mt, ml = mt.to_local(), ml.to_local()
        unsharded = path_logits(torch, cfg, "pallas", params, rows, mt, max_len)
        ms = {"unsharded": [], "mesh": []}
        steps = gen_tokens - 1
        for name in ("unsharded", "mesh", "mesh", "unsharded"):
            srv, p, b = ((plain, params, B // n_rows) if name == "unsharded"
                         else (server, placed, B))
            ms[name].append(_replayed_ms(torch, srv.captured_decode(p, b), prompt, steps))
        out[arch] = {"capture_s": capture_s, "bitwise": bool(torch.equal(ml, eager)),
                     "eager_rel": rel_err(torch, ml, eager)[0],
                     "plain_rel": rel_err(torch, ml, unsharded)[0], "launched": launched,
                     "want": _serve_want(cfg, steps), "ms": ms,
                     "peak": torch.cuda.max_memory_allocated()}
        del server, plain, params, placed, batch, rows, mt, ml, eager, unsharded
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def phase_serve_cards(torch, smi: str) -> dict:
    """(c) in SERVE_CARDS processes, one a card, over NCCL
    (``launch.spawn.run_ranks``), once per SERVE_CARDS_RUNS; a rank that
    fails or hangs kills the others and fails the phase.  The captured
    run's logits, fed its own tokens, within LOGITS_REL_TOL_BF16 of the
    mesh's eager steps and of the unsharded ``Server`` (full depth), and
    bitwise the eager steps for the ssm, hybrid and encdec families (for
    chatglm3-6b whether they are is printed); each serving kernel launched
    exactly as the path says on each rank."""
    from repro_torch.launch.spawn import run_ranks

    tol = LOGITS_REL_TOL_BF16
    total = {}
    for archs, env, shape in SERVE_CARDS_RUNS:
        cells = SERVE_CARDS_CELLS if len(shape) == 2 else SERVE_CARDS_POD_CELLS
        t = time.perf_counter()
        try:
            outs = run_ranks(serve_cards_rank, SERVE_CARDS, archs, env, shape, backend="nccl",
                             timeout=2 * MESH_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            fail(f"[serve_mesh] (c) the {SERVE_CARDS}-card run failed: {e}")
        print(f"[serve_mesh] (c) {shape} {('pod', 'data', 'model')[-len(shape):]} NCCL mesh, "
              f"one rank a card ({SERVE_CARDS} cards), NCCL "
              f"settings {env or 'the library default'}, {', '.join(archs)} full width and "
              f"depth, bf16, (B, prompt, tokens, cache) "
              f"{ {a: cells[a] for a in archs} }: "
              f"{time.perf_counter() - t:.1f} s; {smi}")
        for o in outs:
            for arch in archs:
                r, B = o[arch], cells[arch][0]
                L = r["launched"]
                print(f"[serve_mesh] (c) rank {o['rank']} (data, model) {o['coord']} {arch}: "
                      f"captured generate's logits, fed its own tokens, against the mesh's eager "
                      f"steps: bitwise {r['bitwise']}, max |diff| / max |logit| "
                      f"{r['eager_rel']:.3e}; against the unsharded Server on this card over "
                      f"this data shard's rows {r['plain_rel']:.3e} (tol {tol}); first generate "
                      f"(the capture) {r['capture_s']:.3f} s; launches {L} (want {r['want']}); "
                      f"replayed step device ms (in turns unsharded B={max(1, B // 2)}, mesh "
                      f"B={B}, "
                      f"mesh, unsharded) mesh {[round(x, 4) for x in r['ms']['mesh']]}, "
                      f"unsharded {[round(x, 4) for x in r['ms']['unsharded']]}; peak "
                      f"{r['peak']} B")
                check(r["eager_rel"] <= tol and r["plain_rel"] <= tol,
                      f"[serve_mesh] (c) rank {o['rank']} {arch}: the captured sharded decode's "
                      "logits disagree")
                check(arch == "chatglm3_6b" or r["bitwise"],
                      f"[serve_mesh] (c) rank {o['rank']} {arch}: the captured sharded decode is "
                      "not bitwise its eager steps")
                check({n: L[n] for n in r["want"]} == r["want"]
                      and L["decode_attention_fwd.launches_mma"] == L["decode_attention_fwd"],
                      f"[serve_mesh] (c) rank {o['rank']} {arch}: the serving kernels' launches "
                      "are not the path's (flash-decode on the tensor cores)")
                for n in r["want"]:
                    total[n] = total.get(n, 0) + L[n]
    return total


def phase_serve_mesh(torch, smi: str, B: int, prompt: int, gen_tokens: int, max_len: int,
                     mesh_launches: dict) -> None:
    """(a) for chatglm3-6b at full width and depth (B x prompt, cache
    ``max_len``), then (b); the serving kernels' launches of both are
    added into ``mesh_launches``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch

    t = time.perf_counter()
    cfg = get_config("chatglm3_6b").replace(attn_impl="pallas")
    plain = Server(cfg, device="cuda", max_len=max_len)
    params = plain.model.compute_params(plain.model.init_params(seed=0))
    batch = concrete_batch(cfg, B, prompt, device="cuda")
    batch.pop("targets")
    plain.generate(params, batch, 4)  # its capture
    serve_mesh_one_rank(torch, plain, params, batch, gen_tokens, _serving_counters(),
                        _serve_want(cfg, gen_tokens - 1), smi, mesh_launches)
    del plain, params
    gc.collect()
    torch.cuda.empty_cache()
    shared = serve_mesh_shared_card(torch)
    print(f"[serve_mesh] launches: (b) the four ranks {shared}; phase "
          f"{time.perf_counter() - t:.1f} s")
    _add_launches(mesh_launches, shared)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", action="store_true",
                    help=f"run only [serve_mesh] (c), over {SERVE_CARDS} cards")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = phase_device(torch)
    phase_build()
    if args.cards:
        check(torch.cuda.device_count() >= SERVE_CARDS,
              f"--cards needs {SERVE_CARDS} cards, {torch.cuda.device_count()} found")
        launched = phase_serve_cards(torch, smi)
        print(f"[done] {time.perf_counter() - t_start:.1f} s; launches {launched}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_fwd
    from repro_torch.kernels.prefetch_gather import prefetch_gather_fwd
    from repro_torch.kernels.rglru_scan import rglru_gated_fwd, rglru_scan_fwd
    from repro_torch.kernels.selective_scan import selective_scan_fwd

    B, prompt, gen_tokens, max_len = 4, 512, 32, 1024
    recs = [
        phase_flash(torch, ref, flash_attention_fwd),
        phase_decode(torch, ref, decode_attention_fwd, kv_len_main=prompt + gen_tokens // 2),
        phase_gather(torch, ref, prefetch_gather_fwd),
        *phase_flash_bwd(torch, ref, flash_attention_fwd, flash_attention_bwd_dkdv,
                         flash_attention_bwd_dq),
        *phase_scans(torch, ref, mamba_scan_fwd, rglru_scan_fwd),
        *phase_fused_scans(torch, ref, selective_scan_fwd, rglru_gated_fwd),
    ]
    # each path's counts: serving for the forward, flash-decode and the
    # gather, the Trainer run for the backward kernels
    cost_cells: dict = {}
    launches = phase_slice(torch, flash_attention_fwd, decode_attention_fwd, prefetch_gather_fwd,
                           B, prompt, gen_tokens, max_len, cost_cells)
    gc.collect()
    torch.cuda.empty_cache()
    # the continuous batcher's serving path: its launches add to the slice's
    batched = phase_batcher(torch, {"flash_attention_fwd": flash_attention_fwd,
                                    "decode_attention_fwd": decode_attention_fwd,
                                    "prefetch_gather_fwd": prefetch_gather_fwd}, smi)
    for k, n in batched.items():
        launches[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    # sharded serving: a one-rank NCCL mesh, four gloo ranks on the card
    # (their launches, with those of the other families' one-rank meshes,
    # are added at the end)
    mesh_launches: dict = {}
    phase_serve_mesh(torch, smi, B, prompt, gen_tokens, max_len, mesh_launches)
    gc.collect()
    torch.cuda.empty_cache()
    phase_stream(torch, {"decode_attention_fwd": decode_attention_fwd,
                         "prefetch_gather_fwd": prefetch_gather_fwd}, B, prompt, max_len)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(torch, {"flash_attention_fwd": flash_attention_fwd,
                                "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv,
                                "flash_attention_bwd_dq": flash_attention_bwd_dq},
                        cost_cells)
    phase_cost(torch, smi, cost_cells)
    gc.collect()
    torch.cuda.empty_cache()
    # the multi-device layer: the Trainer on a one-rank NCCL mesh, four ranks
    # on the card over gloo; its flash launches are counted on their own
    phase_mesh(torch)
    gc.collect()
    torch.cuda.empty_cache()
    # the other families' training: every kernel counted, for the path's
    # flash launches and no other
    every = {"flash_attention_fwd": flash_attention_fwd,
             "decode_attention_fwd": decode_attention_fwd,
             "prefetch_gather_fwd": prefetch_gather_fwd,
             "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv,
             "flash_attention_bwd_dq": flash_attention_bwd_dq,
             "mamba_scan_fwd": mamba_scan_fwd, "rglru_scan_fwd": rglru_scan_fwd,
             "selective_scan_fwd": selective_scan_fwd, "rglru_gated_fwd": rglru_gated_fwd}
    families = phase_train_families(torch, every)
    # the backward kernels' launches: every Trainer run's (chatglm3-6b's and
    # the other families')
    launches.update({k: train[k] + families[k] for k in ("flash_attention_bwd_dkdv",
                                                        "flash_attention_bwd_dq")})
    print(f"[train] launches over the Trainer runs: chatglm3-6b {train}; the other families "
          f"{ {k: v for k, v in families.items() if v} }")
    gc.collect()
    torch.cuda.empty_cache()
    phase_smoke_configs(torch, every)
    # the recurrent families' serving paths; the scans' counts come from
    # these runs
    serve_counters = {"flash_attention_fwd": flash_attention_fwd,
                      "decode_attention_fwd": decode_attention_fwd,
                      "prefetch_gather_fwd": prefetch_gather_fwd,
                      "mamba_scan_fwd": mamba_scan_fwd, "rglru_scan_fwd": rglru_scan_fwd,
                      "selective_scan_fwd": selective_scan_fwd,
                      "rglru_gated_fwd": rglru_gated_fwd}
    scans = (*OFF_PATH, "selective_scan_fwd", "rglru_gated_fwd")
    launches.update({k: 0 for k in scans})
    for arch in RECURRENT:
        run = phase_recurrent(torch, arch, serve_counters, B, prompt, gen_tokens, smi,
                              mesh_launches)
        launches.update({k: v for k, v in run.items() if k in scans and v})
    gc.collect()
    torch.cuda.empty_cache()
    # the moe family at full width and depth, each after every earlier model
    # is freed (qwen3-moe-30b-a3b's bf16 weights take 61 GB of the 80)
    for arch, tag in MOE:
        phase_moe(torch, arch, tag, serve_counters, B, prompt, gen_tokens, max_len)
        gc.collect()
        torch.cuda.empty_cache()
    # the encoder-decoder and the M-RoPE model, each after every earlier one
    # is freed
    for arch, tag, dec_prompt, slots in ENC_VLM:
        phase_enc_vlm(torch, arch, tag, serve_counters, B, dec_prompt, gen_tokens, slots, smi,
                      mesh_launches)
        gc.collect()
        torch.cuda.empty_cache()
    phase_analysis()
    phase_pos(smi)
    # the sharded runs' launches: [serve_mesh] (a) and (b), and (a) of the
    # ssm, hybrid and encdec families in their phases
    print(f"[serve_mesh] launches of every sharded run: {mesh_launches}")
    _add_launches(launches, mesh_launches)
    for r in recs:
        r["launches"] = launches[r["name"]]
        if r["name"] in OFF_PATH:
            check(r["launches"] == 0, f"{r['name']} ran on the serving path")
        else:
            check(r["launches"] > 0, f"{r['name']} was not launched on its path")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
