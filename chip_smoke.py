#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py                 # the full run: exit 0 = all checks passed
    python3 chip_smoke.py --scale 40000   # a smaller database, for a quick look

Phases (any failure raises and the script exits non-zero, printing no
result line):

  0. lint     — the port's own figaro-lint (`repro_torch.analysis`, stdlib
                only) over ``src/repro_torch``: the count of findings, each
                finding, and a stop on any (no card time).
  1. card     — the card's name and power limit (nvidia-smi), torch and CUDA
                versions; TF32 off for matmuls and cuDNN.
  2. build    — builds every CUDA kernel from ``src/repro_torch/csrc`` (one
                nvcc per source, all started together) and prints the time,
                each kernel instance's registers and spills (ptxas), the
                tensor-core (HGMMA) and TMA (UTMALDG) instructions in the
                SASS of the bfloat16 flash kernel, and the TF32 tensor-core
                (HMMA or HGMMA ….TF32) and FP64 tensor-core (DMMA)
                instructions in that of the float32/float64 one (cuobjdump;
                each must hold its kind; without cuobjdump that is logged
                and not checked).
  3. kernels  — each kernel against its plain PyTorch version on the card:
                node_fused's node pass (``fused_node_pass``: slab, heads,
                norms) and its TPU-contract entry on random segments that
                straddle its tiles, every row a segment start, and one
                segment over hundreds of tiles, with dead rows and dead
                segment slots (exactly zero); panel_qr's cluster variant on random full-rank
                float64 panels [4, 1024, 32] and [2, 4096, 32] and its grid
                variant on [1, 8192, 32], [3, 5000, 32] and
                [1, 1,048,579, 32] in float64 and float32, elementwise, and
                on a rank-deficient [1, 6000, 32] panel (repeated columns,
                zero rows) held on RᵀR and `reflector_error`, each beside
                ``torch.geqrf``; then
                every node pass and panel_qr call of one ``qr`` dispatch of
                the configuration below, captured with its real inputs (each
                pass writing its slab as whole rows of R₀, zeros around its
                band's columns; the TSQR leaf panels [B, 256, 32], strided column
                blocks of the leaves, among them), each timed beside its
                plain version and, for panel_qr, beside ``torch.geqrf`` on
                the same panels; the node pass beside the bound of what it
                now reads and writes and the bound of the TPU kernel's contract.
                panel_qr is held to its plain version on RᵀR, for V and beta
                to the factorization they define (see `reflector_error`),
                and T to `_panel_to_wy` of its own V and beta.
                flash_attention at hd 32, 64 and 256, with a window, without
                causality, on two packed sequences whose positions restart
                mid-tile, and in float32 (hd 64 and 128) and float64 (hd 128
                and 256), against its plain version.
  4. main     — ``yelp_like(scale=4_000_000, cols=16)``: Review 8 M rows,
                N = 35 columns, R₀ ≈ 2.4·10⁷ rows at bucketed capacity. The
                plan is built on the host (timed), then
                ``Session(use_kernel=True, assembly="band", device="cuda")``
                runs qr (float32) and svd, pca(k=8), least_squares (float64),
                each timed as the median of 3 after one warm-up. The launch
                counters are zeroed just before and read just after; every
                kernel must have launched, panel_qr only as its one-block
                variant, and one ``qr`` must not call `_panel_to_wy` (T
                comes from the kernel). R is checked against the same
                session with ``use_kernel=False`` on the card (float64,
                after normalize_sign), and R₀ᵀR₀ against AᵀA of the
                materialized join of ``yelp_like(scale=400, cols=3)``.
                The engine captures one CUDA graph per R signature on its
                second dispatch (float32 R, float64 R: two captures,
                svd/pca/lsq replay the float64 one); the launch counts of a
                replay are the capture's. Last, eager (inside the engine's
                `eager_reference`, `eager_call`) against replay for one
                float32 and one float64 ``qr``: R bit for bit (if two eager
                runs differ, by how much, and the float64 replay within 1e-9
                of eager), and torch.profiler's device time by kernel for
                one call of each, with the device's busy share of the call,
                its count of kernels and copies (eager and replay each at
                most `MAX_KERNELS_PER_QR`), the median wall time of 3, and the
                device time of R₀'s assembly (the ``figaro.r0_assembly``
                range: its copies; none on the kernel path with band
                assembly). The phase's reserved memory is logged.
  4c. dataset — the same database through the dataset surface:
                ``Session(use_kernel=True, assembly="band").ingest(db)
                .join(edges, root="auto")``; the chosen root and
                ``explain()``'s ranking of all 5 roots, host seconds of
                ingest, join and the lazy plan build; ``ds.qr()``,
                ``ds.svd()``, ``ds.pca(k=8)``, ``ds.lsq("stars")`` (median
                of 3 after a warm-up, the counters zeroed around them);
                float64 R against phase 4's plan-level ``Session.qr`` of
                the same root at 1e-9 relative after normalize_sign; 4,096
                Review rows appended within capacity (no miss, no capture;
                host seconds of the append, the next ``qr``'s latency; R
                against a fresh plan over the grown tables at 1e-9); then
                250,000 CheckIn rows past its capacity (exactly one regrow,
                which frees the superseded spec's graphs; over the next two
                ``qr`` calls one miss and one capture; R against a fresh
                plan). The phase's graphs and reserved memory are logged.
  9. serving  — (run after 4c) 9a: ``ds.serve(kind="qr")`` over phase
                4c's dataset (float32, the kernels, band assembly,
                ``max_batch=2``, ``queue_depth=2``): buckets 1 and 2 warmed
                (each: an eager dispatch, then a capture, with the graphs,
                pool and reserved memory logged), then 16 requests (the
                dataset's data times a per-request column scale from
                ``--seed``) from two threads, 4,096 Review rows appended
                through ``server.append`` midway (0 misses, 0 captures);
                requests/s, p50/p99 latency from submit to answer, the batch
                sizes dispatched and the host ms of staging; each answer
                bit-equal to its batch dispatched synchronously
                (``engine.qr(..., batched=True, batch_capacity=cap)``, same
                engine, same graph) and its float32 RᵀR within 1e-4 of an
                eager float64 batch of one; one profiled window of four B = 2
                batches (the port kernels in the trace against the counters,
                kernels and copies per batch at most `MAX_KERNELS_PER_QR`,
                and how much of the host-to-device copy time ran beside
                kernels); the B = 2 node passes and panels of one eager
                dispatch against their plain versions and bounds. 9b: the
                same shapes at about 1/8 of the rows
                (``yelp_like(scale=500_000, cols=16)``): ``svd``,
                ``pca(k=8)`` and ``lsq("stars")`` in float64 with
                ``max_batch=8``, 24 requests each held and released as three
                B = 8 batches, the same checks at 1e-9 relative (vectors up
                to sign), one profiled B = 8 batch, one capture in all (pca
                and lsq replay svd's R graph). Each part's peak reserved
                memory must stay under 80 GB.
  10. distribution — (run after 9, its graphs released) 10a:
                ``Session(use_kernel=True, assembly="band")
                .partitioned_qr(tree, 4)`` on phase 4's tree in float64,
                without a mesh: `partition_fact_table` and the four plan
                builds timed on the host, the median of 3 wall times beside
                phase 4's float64 ``qr`` (replayed), launches (node_fused
                and panel_qr must launch) and captures, R against phase
                4's float64 ``qr`` at 1e-9 relative, peak reserved memory
                under 80 GB. 10b: a one-rank NCCL group on ``cuda:0`` (a
                `FileStore` in a temporary directory, a timeout) and its
                ``make_data_mesh()``: `distributed_postprocess_r0` of phase
                4's float64 R₀ (capacity rows) with ``use_kernel=True``
                (one block: ``panel_qr_grid`` must launch) against
                `postprocess_r0` of the same R₀, both timed;
                `distributed_qr_r` of a random float64 [2²², 32] from
                ``--seed`` against `postprocess_r0`; a B = 2 float64
                ``svd`` through ``Session(mesh=mesh)`` on 9b's
                configuration (eager, then captured) against the same
                session without a mesh; ``partitioned_qr(tree, 4,
                mesh=mesh)`` against 10a; each at 1e-9 relative (vectors
                up to sign). 10c, in the same group (10a's and 10b's
                graphs released first): 9b's configuration served through
                ``Session(mesh=mesh)`` for ``svd``, ``pca(k=3)`` and
                ``lsq("stars")`` (float64, ``max_batch=8``), each kind on
                two datasets of the same tables, one served over the mesh
                and one by the same session without a mesh: 24 held
                requests, 512 Review rows appended within capacity
                (``server.append``), CheckIn rows past its capacity
                (``ds.append``, a regrow), 24 more requests; every answer
                over the mesh bit-equal to the one without, no collective
                issued (`CountCollectives`), node_fused and panel_qr
                launched (counters zeroed around the meshed streams),
                requests/s beside 9b's, peak reserved memory under 80 GB.
                The group is destroyed at the end. A mesh of one rank
                issues no collective; nothing falls back to gloo or the
                CPU.
  5. wide     — a float64 ``qr`` over a star of three wide relations
                (N = 512 columns, a few thousand rows) through
                ``Session(use_kernel=True)``, timed as the median of 3
                replays after the first call: its TSQR panels [B, 288–1024,
                32] are taller than one block's 256 rows and go to
                panel_qr's cluster variant (counted apart as
                ``panel_qr_cluster``). R against ``use_kernel=False`` at
                1e-9 relative; the variant's calls of one eager dispatch
                against the plain version and ``torch.geqrf``; eager
                against replay as in phase 4.
  5b. tall    — a float64 ``qr`` with ``method="blocked"`` over the
                configuration of phase 4 (``--scale``): its two panels (32
                and 3 columns) are the whole R₀ (2.4·10⁷ rows at capacity),
                taller than the largest cluster, and go to panel_qr's grid
                variant (``panel_qr_grid``); R against ``use_kernel=False``
                at 1e-9 relative, the calls of one eager dispatch against
                the plain version and ``torch.geqrf``, a replay against the
                first (eager) call bit for bit (the cooperative launch is
                captured like any other), and the phase's peak device
                memory.
  6. tails    — ``segmented_head_tail(use_kernel=True)`` at the two largest
                node passes of the configuration above (Review's 8.4 M × 1
                and User's 524 k × 18 at capacity), float32 and float64,
                against ``use_kernel=False``; the segmented_tail and
                segmented_cumsum calls it makes, captured, against their
                plain versions.
  7. lm       — the qwen3-8b eval forward at full width (36 blocks,
                d_model 4096, 32/8 heads, hd 128, d_ff 12288, vocab 151,936;
                float32 parameters, bfloat16 compute) on a batch of
                2 × 4096 tokens through ``make_eval_step`` with
                ``use_flash_kernel=True``: one warm-up, then the median of 3
                (tokens/s, loss, peak memory). Every flash_attention call of
                one forward, captured, against the plain version (chunked
                over KV heads) and ``scaled_dot_product_attention``, with the
                kernel's TFLOP/s, share of its bound and ratio to SDPA; the
                logits of one forward against ``use_flash_kernel=False``
                (the ported ``_attend``) at 2e-2 of max |logits|; the device
                time by kernel of one eval step. Then the float32 eval path,
                which takes the float32/float64 flash kernel (``mma``): the
                same model cut to two blocks, ``compute_dtype="float32"``,
                one eval step with the counters zeroed, its flash calls
                against the plain version and SDPA, then the same calls cast
                to float64, against the plain version and SDPA in float64.
  7c. serve   — (run after 7, on its model) qwen3-8b prefill and decode
                (``make_prefill``, ``make_decode_step``, ``sample_loop``):
                8 prompts of 2,048 tokens (``decode_32k`` cut from 128 ×
                32,768) into a 2,113-slot cache; prefill ms (median of 3
                after a warm-up); greedy ``sample_loop`` for 64 steps (one
                eager decode step, then replays of one captured CUDA graph)
                with the counters zeroed around it (the cache branch reaches
                no port kernel: logged, not checked), its tokens equal to
                the same loop run eagerly; one replay against one eager step
                from the same cache and tokens (logits and every cache leaf
                bit for bit); decode ms a step eager and replayed (medians),
                tokens/s, the step's bound (parameters and cache read once)
                beside the bytes it moves as written (weights cast to
                bfloat16 every call); kernels and copies and the busy share
                of one profiled replay and one eager step; the graph's pool;
                prefill and 16 teacher-forced decode steps against the
                forward (``use_flash_kernel=False``) on 2 of the 8 sequences
                at 2e-2 of max |logits|; peak reserved memory under 80 GB.
                Then the model cut to 2 blocks in float32, 2 prompts of
                2,048 tokens, the same teacher-forced check at the JAX
                package's 2e-3 × max(max |logits|, 1), with a linear cache
                and with ``swa_window=512`` (prefill keeps the ring's last
                512 rows, decode wraps it).
  11. train   — (run after 7b) the LM's training path, the launch
                counters zeroed around the phase (the train step takes
                ``_attend``, which reaches no port kernel: logged, not
                checked). 11a: qwen3-8b at its published width cut to 4
                blocks (36 blocks need ≈ 131 GB of parameters, gradients
                and moments), float32 parameters and AdamW moments,
                bfloat16 compute, ``remat=True``, ``warmup_cosine``,
                `TokenPipeline` batches of 2 × 4096 tokens, `init_state`
                on the card: one warm-up step, then 6 steps timed by CUDA
                events (step ms median, tokens/s, loss and grad_norm each
                step, all finite), peak reserved memory under 80 GB, one
                profiled step (device time by kernel, busy share), and the
                step's FLOPs as run (blocks in bf16 with remat, the LM head
                in float32) against the dense bf16 peak and their bound.
                11b: the same width cut to 2 blocks, float32 compute, 4 ×
                512 tokens, every run from one initial state snapshotted on
                the host: ``microbatch=2`` against none and remat off
                against on (loss and grad_norm within 1e-6), each on the
                updated parameters at rtol 2e-4, atol 2e-6 plus the
                gradient's 1e-5 carried through Adam (`hold_first_step`).
                11c: qwen3's smoke configuration in float32, weights from a
                numpy seed, 3 steps on the card against the CPU with the
                orthogonal update off and on, each step from the CPU's
                state of the step before (`hold_adam_step`). 11d:
                `repro_torch.launch.train.main` on the card: 6 steps with a
                checkpoint every 3, the checkpoint restored bit for bit, a
                restart that resumes from step 6 and runs 6->10.
  12. moe/ssm — (run after 11) the mixture-of-experts and state-space
                configs at their published widths (`phase_lm_config`), each
                initialized on the card from ``--seed``, cut in depth only:
                12a mixtral-8x22b at 2 of 56 blocks (float32 parameters,
                ≈ 21.6 GB), 12b arctic-480b at 2 of 35 (bf16, ≈ 55 GB), 12c
                rwkv6-1.6b not cut (24 blocks, 1.6 B float32 parameters;
                ``param_count()`` says 2.20 B, counting the channel mix's
                2·d·ff twice and not its wr), 12d jamba-v0.1-52b at 1 of
                4 super-blocks (8 layers, ≈ 53 GB).
                Each: the eval step on 2 × 4096 tokens through
                ``make_eval_step`` with the flash kernel where it has
                attention (median of 3 after a warm-up, the counters zeroed
                around it: ``flash_attention_sm90`` once per attention layer
                a step), loss and aux finite, every MoE layer's share of
                dropped assignments, the step's FLOPs against the bf16 peak,
                one profiled step; every flash call of one forward against
                the plain version and SDPA (GQA groups 6 and 7 at hd 128 for
                mixtral and arctic); then prefill (12a: 2 prompts of 6,144
                tokens into the published 4,096-slot ring; 12b, 12c: 8 of
                2,048; 12d: 4 of 2,048) and greedy ``sample_loop`` (32
                steps, 12c 64: one eager step, then replays of one captured
                graph), one replay against one eager step bit for bit,
                timed and profiled replays, and the teacher-forced decode
                against the forward (float32 compute at the JAX
                package's 2e-3 × max(max |logits|, 1) for the float32
                configs; arctic in bf16 at 2e-2), held only where neither
                the forward nor the prefill dropped an assignment (each
                call's capacity is its own, as in JAX);
                then the train step, 12a on 1 block and 2 × 4096 tokens,
                12c at full depth on 2 × 1024 (one warm-up, the median of
                3 by CUDA events; loss, aux and grad_norm finite).
                arctic (≈ 109 GB for one block's state) and jamba (≈ 213 GB
                for one super-block's) do not train on one card. Peak
                reserved memory under 80 GB in each.
  13. enc-dec — (run after 12) the encoder-decoder and patch configs
                (`phase_enc_dec`, its cells in `ENC_DEC_CELLS`), through
                `phase_lm_config` as phase 12's, their frames and patch
                embeddings drawn on the card (the front ends are stubs, as
                in the JAX package). 13a whisper-tiny whole (4 encoder and
                4 decoder blocks, d 384, 6 heads): the eval step on 16
                utterances of 1,500 frames (30 s of audio) under 448 text
                positions, ``flash_attention_sm90`` once per layer a step,
                the encoder's 4 without causality, the decoder's 4 causal,
                each group of one forward's calls held to the plain version
                and SDPA apart; prefill of a 4-token prompt, 128 greedy
                decode steps replayed from one graph that reads the cross
                caches, the teacher-forced decode against the forward in
                float32 at 2e-3; the train step on the eval batch. 13b
                llava-next-34b at 4 of 60 blocks (d 7,168, 56/8 heads): the
                eval step on 2 sequences of 2,880 patch embeddings and
                1,216 tokens (4,096 positions, GQA group 7); prefill of
                all 4,096 positions, 32 decode steps, the same checks; the
                train step at 2 blocks on the eval batch. The eval FLOPs
                count the encoder over its frames, the cross-attention and
                the patch projection. Peak reserved under 80 GB in each.
  8. summary  — one ``{"kernels": [...]}`` line, then, last, the
                ``{"ok": true, "device": {...}}`` line.

Each of phases 4–7 (and 5b, 9a, 9b, 10a, 10b, 10c, 12, 13) drives one path of the port
with the launch counters zeroed just before and read just after, and fails
if a kernel of that path did not launch (in phase 9 the server's dispatch
thread launches them; the counts are process-wide). Every profiled ``qr`` (`profile_once`) also holds
the trace to the counters: each port kernel of the path (the node pass's
scan, panel_qr's three variants) ran as many times in the trace as the
counters grew over the call, and nf_prep at most once per node pass — on a
replay, the counts its capture recorded. After each phase the segmented-scan error word is
read (`kernels/_seg_scan.py`): a look-back that ran out of its spin bound
fails the run.

Tolerances (float64 against the plain version or the unfused path):
relative 1e-9 of the largest magnitude compared — the JAX package's own
kernel-vs-XLA bound (tests/test_kernel_path.py:30) scaled to these values;
float32: node_fused and segmented_tail 1e-5, panel_qr 1e-4 relative (the
JAX package's recorded float32 gaps are 9.5e-7 and 2.5e-5); flash_attention
in float32 and float64 2e-5 and 1e-12 absolute (the JAX package's
flash-vs-oracle bound, tests/test_flash_kernel.py, and float64 rounding). In
bfloat16 the kernel and its plain version both round one float32 result, so
each element is held to one bfloat16 step: |got − want| ≤ 2⁻⁷·|want| +
1e-3·rms(want) (`flash_compare`); the RMS of the plain output is printed
beside the error.

Bounds: ``bound_ms`` is the larger of the bytes each call must move (inputs
read once, outputs written once) over 3.35 TB/s and its floating-point
operations over the H100 SXM's peak for the type: without tensor cores for
the FiGaRo kernels (67 TFLOP/s float32, 34 TFLOP/s float64), and the dense
tensor-core peaks for flash_attention, counting the causal score pairs this
run's positions make visible: 989 TFLOP/s for bfloat16, 494.5 TFLOP/s
(TF32) paid three times for float32 (3xTF32 products), 67 TFLOP/s (FP64
tensor cores) for float64 (NVIDIA's data sheet). The float32/float64 flash
kernel also reports ``old_bound_ms``, the same work at the CUDA-core peaks.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
# The float32/float64 flash kernel's tensor-core peaks (dense TF32, FP64
# tensor cores) and the products each flop of the function costs there
# (3xTF32: three TF32 products per float32 product).
FLASH_MMA_PEAK = {"float32": (494.5e12, 3), "float64": (67e12, 1)}
TOL = {("node_fused", "float32"): 1e-5, ("node_fused", "float64"): 1e-9,
       ("panel_qr", "float32"): 1e-4, ("panel_qr", "float64"): 1e-9,
       ("segmented_tail", "float32"): 1e-5,
       ("segmented_tail", "float64"): 1e-9,
       ("segmented_cumsum", "float32"): 1e-5,
       ("segmented_cumsum", "float64"): 1e-9}
# flash_attention, per dtype: (share of |want|, share of rms(want), absolute)
# an element may differ by (`flash_compare`).
FLASH_TOL = {"bfloat16": (2.0 ** -7, 1e-3, 0.0), "float32": (0.0, 0.0, 2e-5),
             "float64": (0.0, 0.0, 1e-12)}
REPS = 3  # timed runs after one warm-up
# Kernels and copies one float32 qr of the main path may issue (2,765 while
# the node pass's wrapper scanned the weights eagerly; about 400 since).
MAX_KERNELS_PER_QR = 1300
# The port's kernels as torch.profiler names them, by the launch counter
# their wrapper adds to (`trace_launches`): the scan of seg_scan.cuh in its
# four modes (node pass, contract, segmented tail, cumsum), panel_qr's
# one-block, cluster and grid variants, and the two flash kernels.
TRACE_KERNELS = {
    "node_fused": r"segscan::seg_kernel<\w+, 0>",
    "node_fused_contract": r"segscan::seg_kernel<\w+, 1>",
    "segmented_tail": r"segscan::seg_kernel<\w+, 2>",
    "segmented_cumsum": r"segscan::seg_kernel<\w+, 3>",
    "panel_qr": r"panel_qr_(reg|grid)_kernel<",
    "panel_qr_reg": r"panel_qr_reg_kernel<[^>]*, false>",
    "panel_qr_cluster": r"panel_qr_reg_kernel<[^>]*, true>",
    "panel_qr_grid": r"panel_qr_grid_kernel<",
    "flash_attention": r"flash_fwd_(sm90|mma)<",
    "flash_attention_sm90": r"flash_fwd_sm90<",
    "flash_attention_mma": r"flash_fwd_mma<",
}
# Every CUDA kernel: (source, the TPU kernel it replaces).
KERNELS = {
    "node_fused": ("src/repro_torch/csrc/node_fused.cu",
                   "src/repro/kernels/node_fused/kernel.py:130"),
    # panel_qr: its one-block variant (panel_qr_reg) on the main path
    "panel_qr": ("src/repro_torch/csrc/panel_qr.cu",
                 "src/repro/kernels/panel_qr/kernel.py:71"),
    "panel_qr_cluster": ("src/repro_torch/csrc/panel_qr.cu",
                         "src/repro/kernels/panel_qr/kernel.py:71"),
    "panel_qr_grid": ("src/repro_torch/csrc/panel_qr.cu",
                      "src/repro/kernels/panel_qr/kernel.py:71"),
    "segmented_tail": ("src/repro_torch/csrc/head_tail.cu",
                       "src/repro/kernels/head_tail/kernel.py:68"),
    # the scan segmented_head_tail(use_kernel=True) forms its weight norms
    # with; the JAX package runs XLA's associative scan there
    "segmented_cumsum": ("src/repro_torch/csrc/head_tail.cu",
                         "src/repro/core/heads_tails.py:82"),
    "flash_attention_sm90": ("src/repro_torch/csrc/flash_attn_sm90.cu",
                             "src/repro/kernels/flash_attn/kernel.py:84"),
    "flash_attention_mma": ("src/repro_torch/csrc/flash_attn.cu",
                            "src/repro/kernels/flash_attn/kernel.py:84"),
}
# The dtypes each flash source serves (kernels/flash_attn/kernel.py:variant).
FLASH_DTYPES = {"flash_attention_sm90": ["bfloat16"],
                "flash_attention_mma": ["float32", "float64"]}
LM32_BLOCKS = 2  # depth of the float32 eval path (the mma flash kernel)
WIDE_COLS = (170, 171, 171)  # data columns of the wide star: N = 512
LM_BATCH, LM_SEQ = 2, 4096  # SHAPES["train_4k"]'s sequence, batch cut to 2


def log(*args) -> None:
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that over max(1, max |want|))."""
    err = float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0
    scale = max(1.0, float(want.double().abs().max())) if want.numel() \
        else 1.0
    return err, err / scale


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn, reps: int = 3):
    """(last output, median seconds, all seconds, warm-up seconds) of ``fn``
    after one warm-up, each run ended by a synchronize."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times), times, warm


# -- phase 0 ------------------------------------------------------------------

def phase_lint() -> None:
    """The port's figaro-lint over its tree, with no baseline: any finding
    stops the run."""
    from repro_torch.analysis import analyze_paths

    t0 = time.perf_counter()
    findings = analyze_paths([str(REPO / "src" / "repro_torch")],
                             root=str(REPO))
    for f in findings:
        log(f.render())
    log(f"lint: {len(findings)} finding(s) over src/repro_torch in "
        f"{time.perf_counter() - t0:.2f} s")
    check(not findings, "the port's figaro-lint reports no finding")


# -- phase 1 ------------------------------------------------------------------

def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


# -- phase 2 ------------------------------------------------------------------

def phase_build() -> dict:
    """Build every source; log ptxas's registers and spills per kernel and
    check both flash kernels' SASS for tensor-core instructions. Returns
    {"spill_bytes": {kernel: bytes}, "hgmma": count or None, "tf32_mma":
    count or None, "dmma": count or None}."""
    import os
    import re
    import shutil

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(_build.SOURCES)}")
    spills = {}
    for name, out in _build.BUILD_LOG.items():
        entry = name
        for line in out.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"flash_fwd_sm90ILi(\d+)E", line)
                pq = re.search(r"panel_qr_reg_kernelI([fd])Li(\d+)ELi(\d+)"
                               r"ELb([01])E", line)
                grid = re.search(r"panel_qr_grid_kernelI([fd])Li(\d+)E", line)
                mma = re.search(r"flash_fwd_mmaI([fd])Li(\d+)E", line)
                if m:
                    entry = f"flash_fwd_sm90<hd {m[1]}>"
                elif mma:
                    typ = "float" if mma[1] == "f" else "double"
                    entry = f"flash_fwd_mma<{typ}, hd {mma[2]}>"
                elif pq:
                    typ = "float" if pq[1] == "f" else "double"
                    cluster = ", cluster" if pq[4] == "1" else ""
                    entry = (f"panel_qr_reg_kernel<{typ}, nb {pq[2]}, "
                             f"{pq[3]} rows/thread{cluster}>")
                elif grid:
                    typ = "float" if grid[1] == "f" else "double"
                    entry = f"panel_qr_grid_kernel<{typ}, nb {grid[2]}>"
                else:
                    entry = line.split("'")[1][:60]
            if "registers" in line or "spill" in line:
                log(f"  {name} {entry}: {line.strip()}")
            sm = re.search(r"(\d+) bytes spill stores", line)
            if sm:
                spills[entry] = spills.get(entry, 0) + int(sm[1])
    hgmma = tf32 = dmma = None
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if os.path.exists(cuobjdump):
        def sass_of(source):
            sass = subprocess.run(
                [cuobjdump, "-sass", str(_build.library_path(source))],
                capture_output=True, text=True, timeout=300)
            check(sass.returncode == 0,
                  f"cuobjdump -sass: {sass.stderr[-500:]}")
            return sass.stdout

        sass = sass_of("flash_attn_sm90")
        hgmma = sass.count("HGMMA")
        log(f"  flash_attn_sm90 SASS: {hgmma} HGMMA, "
            f"{sass.count('UTMALDG')} UTMALDG, "
            f"{sass.count('SYNCS')} SYNCS (mbarrier) instructions")
        check(hgmma > 0, "flash_attn_sm90 runs on the tensor cores (HGMMA)")
        ops = re.findall(r"\b(H?G?MMA|DMMA)(\.[0-9A-Za-z.]+)?",
                         sass_of("flash_attn"))
        tf32 = sum(1 for op, sfx in ops if op in ("HMMA", "HGMMA")
                   and "TF32" in sfx)
        dmma = sum(1 for op, _ in ops if op == "DMMA")
        kinds = sorted({op + sfx for op, sfx in ops})
        log(f"  flash_attn SASS: {tf32} TF32 tensor-core instructions, "
            f"{dmma} DMMA ({kinds})")
        check(tf32 > 0, "flash_attn runs float32 on the TF32 tensor cores")
        check(dmma > 0, "flash_attn runs float64 on the FP64 tensor cores")
    else:
        log(f"  cuobjdump not found ({cuobjdump}): the SASS of the flash "
            "kernels is not checked for tensor-core instructions in this run")
    return {"spill_bytes": spills, "hgmma": hgmma, "tf32_mma": tf32,
            "dmma": dmma}


# -- phase 3 ------------------------------------------------------------------

def node_fused_cost(data, *rows) -> tuple[int, int]:
    """(bytes, flops) of the TPU kernel's contract (``kernel.node_fused``),
    which the node pass ran before it formed its coefficients: data and five
    row vectors (plus the 1-byte flags) read once, two outputs written once;
    ~8 flops per element (mask, weight, scan add, two coefficient products,
    a difference, a sum and the emit scale)."""
    m = data.shape[-2]
    item = data.element_size()
    return 3 * data.numel() * item + m * (5 * item + 1), 8 * data.numel()


def node_pass_cost(data, weights, pos, emit, last, live, ds, out, out_col=0):
    """(bytes, flops) of one node pass as the kernel now runs it
    (``kernel.fused_node_pass``): data, weights, emit_scale, data_scale
    (when given) and pos_in_seg read once, last_of_seg and seg_live read
    once, the destination rows (the slab and, with whole rows of R₀, the
    zeros around it), the heads and the norms written once (heads and norms
    of every slot); ~8 flops per element and ~8 per row (the squared
    weight, its scan, the two coefficients)."""
    item = data.element_size()
    m, k = data.shape[-2], last.numel()
    batch = data.numel() // max(data.shape[-2] * data.shape[-1], 1)
    written = (out.numel() if out is not None else data.numel()) * item
    rows = m * ((3 if ds is not None else 2) * item + pos.element_size())
    slots = k * (last.element_size() + 1 + item
                 + batch * data.shape[-1] * item)
    return (data.numel() * item + written + rows + slots,
            8 * data.numel() + 8 * m)


def node_pass_old_cost(data, weights, pos, emit, last, live, ds, out,
                       out_col=0):
    """The TPU contract's bound for the same pass: `node_fused_cost` of its
    shapes."""
    return node_fused_cost(data)


def panel_qr_cost(a) -> tuple[int, int]:
    """(bytes, flops) of one panel_qr_wy call: A read once, R (over A), V, T
    and beta written once; per Householder step k on an m×nb panel, the
    norm, the reflector and v'v (~5(m−k)), w = v'A and the rank-1 update
    (4(m−k)(nb−k)), z = V[:, :k]'v (2(m−k)k) and T's column (2k²)."""
    m, nb = a.shape[-2:]
    batch = a.numel() // max(m * nb, 1)
    item = a.element_size()
    flops = sum(5 * (m - k) + 4 * (m - k) * (nb - k) + 2 * (m - k) * k
                + 2 * k * k for k in range(min(m, nb)))
    return (3 * a.numel() + batch * (nb + nb * nb)) * item, batch * flops


def bound_ms(nbytes: int, flops: int, dtype: str,
             peak: tuple[float, int] | None = None) -> tuple[float, str]:
    """The larger of the bytes' time at HBM_BYTES_PER_S and the flops' at
    ``peak`` = (flop/s, passes each flop is paid), by default
    (PEAK_FLOPS[dtype], 1)."""
    rate, passes = peak if peak is not None else (PEAK_FLOPS[dtype], 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = passes * flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_mma_bound_ms(nbytes: int, flops: int,
                       dtype: str) -> tuple[float, str]:
    """`bound_ms` at the float32/float64 flash kernel's tensor-core peak,
    each float32 flop paid three times (3xTF32)."""
    return bound_ms(nbytes, flops, dtype, FLASH_MMA_PEAK[dtype])


def elementwise(args, got, want) -> dict:
    """`rel_err` over every output of one call."""
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    return {"max_abs_err": max(e[0] for e in errs),
            "max_rel_err": max(e[1] for e in errs)}


def flash_compare(args, got, want) -> dict:
    """flash_attention's output held elementwise: |got − want| ≤
    a·|want| + r·rms(want) + c, with (a, r, c) = FLASH_TOL of the dtype.
    ``bound_ratio`` is the largest |got − want| over that allowance (≤ 1
    passes); ``max_rel_err`` is max |got − want| over rms(want)."""
    a, r, c = FLASH_TOL[str(want.dtype).split(".")[1]]
    want = want.double()
    diff = (got.double() - want).abs()
    rms = float(want.square().mean().sqrt())
    allowed = a * want.abs() + (r * rms + c)
    return {"max_abs_err": float(diff.max()), "min_rms": rms,
            "max_rel_err": float(diff.max()) / rms,
            "bound_ratio": float((diff / allowed).max())}


def fold(acc: dict, errs: dict) -> None:
    """Keep the worst of each error over calls (the least for ``min_*``)."""
    for key, val in errs.items():
        pick = min if key.startswith("min_") else max
        acc[key] = pick(acc.get(key, val), val)


def measure(calls, kernel, plain, cost, compare, dtype: str, library=None,
            reps: int = 5, fresh=None, bound=bound_ms) -> dict:
    """A kernel against its plain version over captured calls ``[(args,
    kwargs), ...]``: the worst of each error ``compare(args, got, want)``
    gives, the summed device times of the kernel, the plain version and
    ``library`` (one PyTorch call of the same function, or None), and the
    summed ``bound`` (`bound_ms` unless given) of ``cost(*args, **kwargs)``
    -> (bytes, flops). For a kernel that works in place, ``fresh(args)``
    gives each of the kernel, the plain version and the timings its own
    copy of the inputs."""
    import torch

    def use(args):
        return fresh(args) if fresh is not None else args

    res = {}
    ms = plain_ms = lib_ms = b_ms = 0.0
    nbytes = flops = 0
    shapes = []
    for args, kw in calls:
        got = kernel(*use(args), **kw)
        want = plain(*use(args), **kw)
        torch.cuda.synchronize()
        fold(res, compare(args, got, want))
        del got, want
        k_args, p_args = use(args), use(args)
        ms += cuda_ms(lambda: kernel(*k_args, **kw), reps)
        plain_ms += cuda_ms(lambda: plain(*p_args, **kw), 1)
        del k_args, p_args
        if library is not None:
            lib_ms += cuda_ms(lambda: library(*args, **kw), reps)
        cb, cf = cost(*args, **kw)
        nbytes += cb
        flops += cf
        b_ms += bound(cb, cf, dtype)[0]
        shapes.append(list(args[0].shape))
        torch.cuda.empty_cache()
    res.update(calls=len(shapes), shapes=shapes, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms if library is not None else None,
               bound_ms=b_ms, bound_by=bound(nbytes, flops, dtype)[1],
               bytes=nbytes, flops=flops)
    return res


ERROR_KEYS = ("max_abs_err", "max_rel_err", "dead_max", "reflectors",
              "t_rel_err",
              "min_rms", "bound_ratio")


def report(label: str, res: dict, limits: dict, library: str = "") -> None:
    """Log one `measure` result and fail unless each error in ``limits`` is
    within its limit."""
    errs = ", ".join(f"{k} {res[k]:.3e}" + (f" (limit {limits[k]:g})"
                                           if k in limits else "")
                     for k in ERROR_KEYS if k in res)
    lib = (f", {library} {res['library_ms']:.3f} ms"
           if res["library_ms"] is not None else "")
    log(f"{label}: {res['calls']} calls, largest "
        f"{max(res['shapes'], key=math.prod)}; vs plain: {errs}; kernel "
        f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms{lib}, bound "
        f"{res['bound_ms']:.3f} ms ({res['bound_by']})")
    for key, limit in limits.items():
        check(res[key] <= limit, f"{label}: {key} {res[key]:.3e} > {limit:g}")


def random_segments(m, n, batch, dtype, seed):
    """node_fused inputs with random short segments and dead rows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    first = torch.rand(m, generator=g, device=dev) < 0.02
    first[0] = True
    dead = (torch.rand(m, generator=g, device=dev) < 0.1) & ~first
    w = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    w[dead] = 0
    ds = (~dead).to(dtype)
    ca = torch.rand(m, generator=g, device=dev, dtype=dtype)
    cb = -w * torch.rand(m, generator=g, device=dev, dtype=dtype)
    es = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    data = torch.rand(batch, m, n, generator=g, device=dev,
                      dtype=dtype) * 2 - 1
    return [data, ds, w, first, ca, cb, es], dead


def pass_case(m, n, batch, dtype, p_start, seed):
    """node pass inputs: random segments (p_start 1.0: every row a start;
    0.0: one segment), 10 % dead rows, the live slots' last rows and three
    dead slots pointing at row 0, the last row and past the end, and a
    destination like R₀'s rows (n + 7 wide, the slab at column 3). Returns
    (args as `pass_kernel` takes them, dead rows, dead slots)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    first = torch.rand(m, generator=g, device=dev) < p_start
    first[0] = True
    dead = (torch.rand(m, generator=g, device=dev) < 0.1) & ~first
    seg = torch.cumsum(first.long(), 0) - 1
    starts = torch.nonzero(first).squeeze(1)
    pos = torch.arange(m, device=dev) - starts[seg]
    last = torch.cat([starts[1:], torch.tensor([m], device=dev)]) - 1
    last = torch.cat([last, torch.tensor([0, m - 1, m + 5], device=dev)])
    live = torch.ones(last.numel(), dtype=torch.bool, device=dev)
    live[-3:] = False
    w = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    w[dead] = 0
    es = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    data = torch.rand(batch, m, n, generator=g, device=dev,
                      dtype=dtype) * 2 - 1
    out = torch.empty(batch, m, n + 7, device=dev, dtype=dtype)
    return ([data, w, pos, es, last, live, (~dead).to(dtype), out, 3], dead,
            ~live)


def pass_kernel(data, weights, pos, emit, last, live, ds, out, out_col=0):
    """`kernel.fused_node_pass` with its keywords as positions (so `measure`
    can give each call its own destination)."""
    from repro_torch.kernels.node_fused import kernel as nk

    return nk.fused_node_pass(data, weights, pos, emit, last, live,
                              data_scale=ds, out=out, out_col=out_col)


def pass_plain(data, weights, pos, emit, last, live, ds, out, out_col=0):
    """The plain version, `ref.fused_node_pass_ref`, the same way."""
    from repro_torch.kernels.node_fused import ref as nr

    return nr.fused_node_pass_ref(data, weights, pos, emit, last, live,
                                  data_scale=ds, out=out, out_col=out_col)


def fresh_out(out):
    """An empty tensor of ``out``'s shape and row stride."""
    buf = out.new_empty(out.shape[:-1] + (out.stride(-2),))
    return buf[..., :out.shape[-1]]


def pass_fresh(args):
    """The same inputs with a destination of their own (same strides)."""
    args = list(args)
    if args[7] is not None:
        args[7] = fresh_out(args[7])
    return args


def pass_compare(args, got, want) -> dict:
    """`elementwise` over slab, heads and norms; dead rows (data_scale 0)
    and dead slots (seg_live False) must come out exactly zero."""
    import torch

    errs = elementwise(args, got, want)
    slab, heads, norms = got
    ds, live = args[6], args[5]
    dead_rows = float(slab[..., ds == 0, :].abs().max()) \
        if ds is not None and bool((ds == 0).any()) else 0.0
    dead_slots = max(float(heads[..., ~live, :].abs().max()),
                     float(norms[~live].abs().max())) \
        if bool((~live).any()) else 0.0
    errs["dead_max"] = max(dead_rows, dead_slots)
    check(torch.isfinite(slab).all() and torch.isfinite(heads).all(),
          "node pass outputs finite")
    return errs


def check_random_segments() -> dict:
    """The node pass (`kernel.fused_node_pass`) and the TPU kernel's contract
    (`kernel.node_fused`) on random segments, against their plain versions;
    dead rows and dead slots exactly zero."""
    import torch
    from repro_torch.kernels import _seg_scan
    from repro_torch.kernels.node_fused import kernel as nk, ref as nr

    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        tol = TOL[("node_fused", name)]
        for (m, n, batch, p_start) in [(3_000_017, 1, 1, 0.02),
                                       (1_000_003, 3, 2, 0.02),
                                       (200_001, 35, 1, 0.02),
                                       (1_048_576, 1, 1, 1.0),
                                       (2_000_003, 1, 1, 0.0),
                                       (300_007, 18, 1, 0.0)]:
            args, dead, dead_slots = pass_case(m, n, batch, dtype, p_start,
                                               seed=m + n)
            res = measure([(args, {})], pass_kernel, pass_plain,
                          node_pass_cost, pass_compare, name, reps=3,
                          fresh=pass_fresh)
            label = (f"node pass random segments {name} [{batch}, {m}, {n}]"
                     f" starts {p_start:g}")
            report(label, res, {"max_rel_err": tol, "dead_max": 0.0})
            out[label] = res
    _seg_scan.check()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for (m, n, batch) in [(3_000_017, 1, 1), (1_000_003, 3, 2),
                              (200_001, 35, 1)]:
            args, dead = random_segments(m, n, batch, dtype, seed=m + n)
            e_k, s_k = nk.node_fused(*args)
            e_r, s_r = nr.node_fused_ref(*args)
            torch.cuda.synchronize()
            err = max(rel_err(e_k, e_r)[1], rel_err(s_k, s_r)[1])
            dead_max = float(e_k[:, dead].abs().max()) if bool(dead.any()) \
                else 0.0
            tol = TOL[("node_fused", name)]
            log(f"node_fused contract entry, random segments {name} "
                f"[{batch}, {m}, {n}]: rel err {err:.3e} (tol {tol:g}), dead "
                f"rows max {dead_max:g}")
            check(err <= tol, f"node_fused {name} random segments")
            check(dead_max == 0.0, "node_fused dead rows exactly zero")
    _seg_scan.check()
    return out


class Capture:
    """Records the inputs of every call of the named kernel wrappers while
    active (default: the FiGaRo main path's two, the node pass
    fused_node_pass and the in-place panel_qr_wy). A tensor argument is
    recorded as a copy with the same strides within its rows, so a column
    block of a wider matrix is replayed as one (`strided_copy`); a
    destination (``out=``) as an empty one of its strides."""

    def __init__(self, wrappers=None):
        if wrappers is None:
            from repro_torch.kernels.node_fused import ops as nf_ops
            from repro_torch.kernels.panel_qr import ops as pq_ops
            wrappers = [(nf_ops, "fused_node_pass"),
                        (pq_ops, "panel_qr_wy")]
        self._mods = wrappers
        self.calls: dict[str, list] = {name: [] for _, name in wrappers}

    def __enter__(self):
        self._saved = []
        for mod, name in self._mods:
            real = getattr(mod, name)
            self._saved.append((mod, name, real))

            def hook(*args, _real=real, _name=name, **kwargs):
                kept = {k: (fresh_out(v) if k == "out" else strided_copy(v))
                        if hasattr(v, "stride") else v
                        for k, v in kwargs.items()}
                self.calls[_name].append(([strided_copy(a) for a in args],
                                          kept))
                return _real(*args, **kwargs)

            setattr(mod, name, hook)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self._saved:
            setattr(mod, name, real)


def strided_copy(a):
    """A copy of ``a`` that keeps its row stride: a column block of a fresh
    [B, m, stride] buffer when ``a`` [B, m, nb] is one, else a clone."""
    if a.ndim != 3 or a.stride(-1) != 1 or a.stride(-2) <= a.shape[-1]:
        return a.clone()
    buf = a.new_empty(a.shape[:-1] + (a.stride(-2),))
    view = buf[..., :a.shape[-1]]
    view.copy_(a)
    return view


def reflector_error(a, v, beta, r, elems: int = 2 ** 26) -> float:
    """How far the kernel's reflectors are from a valid factorization of
    ``a``: the larger of max |Qᵀ·A − R| / max(1, max |A|), with Q = H₁…H_nb
    rebuilt from (V, beta) in compact-WY form, and max |β·vᵀv − 2| over the
    reflectors with β ≠ 0 (each H = I − β·v·vᵀ orthogonal). In float64, in
    chunks of panels and of rows of about ``elems`` elements, so a whole R₀
    needs no copy of its size."""
    from repro_torch.core.postprocess import _panel_to_wy

    m, nb = a.shape[-2:]
    a, v, r = (x.reshape(-1, m, nb) for x in (a, v, r))
    beta = beta.reshape(-1, nb)
    panels = max(1, min(8192, elems // (m * nb)))
    rows = max(1, elems // (panels * nb))
    worst = 0.0
    for lo in range(0, a.shape[0], panels):
        sl = slice(lo, lo + panels)
        bc = beta[sl].double()
        parts = [(a[sl, i:i + rows].double(), v[sl, i:i + rows].double(),
                  r[sl, i:i + rows]) for i in range(0, m, rows)]
        w = sum(vc.mT @ ac for ac, vc, _ in parts)  # VᵀA
        tw = _panel_to_wy(v[sl].double(), bc).mT @ w
        vv = sum((vc * vc).sum(dim=-2) for _, vc, _ in parts)
        scale = max(1.0, max(float(ac.abs().max()) for ac, _, _ in parts))
        err = max(float((ac - vc @ tw - rc.double()).abs().max())
                  for ac, vc, rc in parts)
        orth = (bc * vv - 2).abs() * (bc != 0)
        worst = max(worst, err / scale, float(orth.max()))
        del parts
    return worst


def gram(r):
    """RᵀR in float64: the part of a QR factorization that is unique."""
    r = r.double()
    return r.mT @ r


def wy_kernel(a):
    """panel_qr_wy on the card as (V, beta, R, T): R is ``a`` after the
    call."""
    from repro_torch.kernels.panel_qr import kernel as pk

    v, beta, t = pk.panel_qr_wy(a)
    return v, beta, a, t


def wy_plain(a):
    from repro_torch.kernels.panel_qr import ref as pr

    v, beta, t = pr.panel_qr_wy_ref(a)
    return v, beta, a, t


def wy_fresh(args):
    return [strided_copy(args[0])]


def geqrf(a):
    import torch

    return torch.geqrf(a)


def t_error(v, beta, t) -> float:
    """T against `_panel_to_wy` of the kernel's own V and beta (unique even
    where V and beta are not), in float64, relative to max(1, max |T|)."""
    from repro_torch.core.postprocess import _panel_to_wy

    m, nb = v.shape[-2:]
    want = _panel_to_wy(v.reshape(-1, m, nb).double(),
                        beta.reshape(-1, nb).double())
    return rel_err(t.reshape(-1, nb, nb), want)[1]


def panel_qr_compare(args, got, want) -> dict:
    """panel_qr_wy: RᵀR against the plain version's, V and beta by
    `reflector_error`, and T by `t_error`. R, V and beta are not compared
    elementwise at the main path's inputs: R is unique only for a panel of
    full column rank, and TSQR leaves are not (one user's carried head
    repeats over all of that user's review rows, so a leaf's user block has
    rank ≤ the users in it). There a reflector is formed from roundoff and
    two correct factorizations differ in V, beta and whole rows of R, while
    RᵀR = AᵀA holds for both, and T is a function of V and beta."""
    v, beta, r, t = got
    errs = elementwise(args, gram(r), gram(want[2]))
    errs["reflectors"] = reflector_error(args[0], v, beta, r)
    errs["t_rel_err"] = t_error(v, beta, t)
    return errs


def panel_qr_full_compare(args, got, want) -> dict:
    """On random full-rank panels V, beta and R are unique: elementwise
    against the plain version, and T by `t_error`."""
    errs = elementwise(args, got[:3], want[:3])
    errs["t_rel_err"] = t_error(got[0], got[1], got[3])
    return errs


def pass_calls(calls):
    """Captured fused_node_pass calls as `pass_kernel` arguments."""
    return [(list(args) + [kw.get("data_scale"), kw.get("out"),
                           kw.get("out_col", 0)], {})
            for args, kw in calls]


def measure_path_kernels(calls, dtype: str, label: str = "qr dispatch",
                         names=("node_fused", "panel_qr")) -> dict:
    """`measure` and `report` of the node pass and panel_qr (its in-place
    form, as the path calls it) over the captured calls of one dispatch; the
    node pass also beside the TPU contract's bound for the same passes."""
    from repro_torch.kernels import _seg_scan

    parts = {"node_fused": ("fused_node_pass", pass_kernel, pass_plain,
                            node_pass_cost, pass_compare, None, pass_fresh),
             "panel_qr": ("panel_qr_wy", wy_kernel, wy_plain, panel_qr_cost,
                          panel_qr_compare, geqrf, wy_fresh)}
    out = {}
    for name in names:
        key, kernel, plain, cost, compare, library, fresh = parts[name]
        mine = pass_calls(calls[key]) if name == "node_fused" else calls[key]
        out[name] = measure(mine, kernel, plain, cost, compare, dtype,
                            library=library, fresh=fresh)
        tol = TOL[(name, dtype)]
        limits = {"max_rel_err": tol}
        if name == "panel_qr":
            limits.update(reflectors=tol, t_rel_err=tol)
        if name == "node_fused":
            limits.update(dead_max=0.0)
            out[name]["old_bound_ms"] = sum(
                bound_ms(*node_pass_old_cost(*a), dtype)[0] for a, _ in mine)
            log(f"node pass {dtype}: the TPU contract's bound for the same passes "
                f"{out[name]['old_bound_ms']:.3f} ms")
        report(f"{name} {dtype} over one {label} (panel_qr: R'R)", out[name],
               limits, library="torch.geqrf")
    _seg_scan.check()
    return out


# -- phase 4 ------------------------------------------------------------------

def trace_launches(label: str, kernels, counted: dict) -> dict:
    """Hold the port kernels in one call's trace to the launch counters'
    growth over that call (on a replay: the counts its capture recorded,
    which the engine adds): each counter of `TRACE_KERNELS` names as many
    kernels in the trace as it grew, and nf_prep ran at most once per node
    pass. Returns the trace's counts."""
    seen = {name: sum(e.count for e in kernels if re.search(pat, e.key))
            for name, pat in TRACE_KERNELS.items()}
    prep = sum(e.count for e in kernels if "nf_prep" in e.key)
    unknown = sorted(set(counted) - set(TRACE_KERNELS))
    check(not unknown, f"{label}: counters {unknown} have no trace name")
    for name, n in seen.items():
        check(n == counted.get(name, 0),
              f"{label}: {name} ran {n} times in the trace, the counters "
              f"grew by {counted.get(name, 0)}")
    check(prep <= seen["node_fused"],
          f"{label}: nf_prep ran {prep} times over {seen['node_fused']} node "
          "passes")
    return dict(seen, nf_prep=prep)


def profile_once(label: str, fn, cpu: bool = True) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of that call's wall time (kernels and copies on
    the one stream, summed; they do not overlap). The trace's port kernels
    are held to the launch counters (`trace_launches`). ``cpu=False``
    traces the device alone (no host ops, so no R0 assembly range): a
    call of 10⁵ kernels then takes seconds to read, not minutes. Returns
    the wall and busy ms, the busy share and the count of kernels and
    copies."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _platform

    fn()
    torch.cuda.synchronize()
    before = _platform.launch_counts()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    counted = {k: v - before.get(k, 0)
               for k, v in _platform.launch_counts().items()
               if v != before.get(k, 0)}
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.key.startswith("Command Buffer")]
    attr = "self_device_time_total" if device and hasattr(
        device[0], "self_device_time_total") else "self_cuda_time_total"
    # R0's assembly (its copies): the device-side span of core/figaro.py's
    # figaro.r0_assembly range, which the profiler records as a device event
    # of its own (no kernel) when the range launched any kernel.
    ranges = [e for e in device if e.key == "figaro.r0_assembly"]
    kernels = [e for e in device if e.key != "figaro.r0_assembly"]
    r0_ms = sum(getattr(e, attr) for e in ranges) / 1e3
    device_us = sum(getattr(e, attr) for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"profile {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{device_us / 1e3:.1f} ms ({100 * device_us / wall_us:.1f}%) over "
        f"{launches} kernels and copies; R0 assembly {r0_ms:.3f} ms")
    for e in sorted(kernels, key=lambda e: -getattr(e, attr))[:12]:
        log(f"  {getattr(e, attr) / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    traced = trace_launches(label, kernels, counted)
    log(f"  port kernels in the trace {traced}; counters grew by {counted}")
    top = [[e.key[:90], getattr(e, attr) / 1e3, e.count]
           for e in sorted(kernels, key=lambda e: -getattr(e, attr))[:12]]
    return {"wall_ms": wall_us / 1e3, "busy_ms": device_us / 1e3,
            "busy_share": device_us / wall_us, "kernels_and_copies": launches,
            "r0_assembly_ms": r0_ms, "traced_launches": traced, "top": top}


def gram_check_small(torch_dtype):
    import torch
    from repro_torch import figaro
    from repro_torch.core.materialize import materialize_join
    from repro_torch.data.relational import yelp_like

    tree = yelp_like(scale=400, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band", device="cuda")
    r0 = sess.r0(tree, dtype=torch_dtype)
    a = torch.as_tensor(materialize_join(tree), device="cuda",
                        dtype=torch_dtype)
    gram = a.T @ a
    err, rel = rel_err(r0.T @ r0, gram)
    log(f"small tree yelp_like(400, cols=3): join {a.shape[0]} rows, "
        f"R0'R0 vs A'A max abs err {err:.3e}, relative {rel:.3e} (tol 1e-9)")
    check(rel <= 1e-9, "R0'R0 == A'A on the small tree")
    return rel


# -- the captured program: eager against replay --------------------------------

def eager_call(sess, tree_or_plan, kind: str = "qr", **opts):
    """``sess.<kind>(tree_or_plan, **opts)`` run eagerly: the dispatch a user
    makes, inside the engine's `eager_reference` (no signature, count or
    CUDA graph)."""
    with sess.engine.eager_reference():
        return getattr(sess, kind)(tree_or_plan, **opts)


def memory_log(label: str, engine=None) -> dict:
    """The caching allocator's reserved memory now and at its peak, and,
    given an engine, the memory its graphs' pool holds (the segments of
    that pool in `torch.cuda.memory_snapshot`; None where the snapshot does
    not name pools)."""
    import torch

    out = {"reserved_gib": torch.cuda.memory_reserved() / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    pool = ""
    if engine is not None and engine._pool is not None:
        segments = torch.cuda.memory_snapshot()
        if all("segment_pool_id" in s for s in segments):
            out["graph_pool_gib"] = sum(
                s["total_size"] for s in segments
                if tuple(s["segment_pool_id"]) == tuple(engine._pool)) / 2**30
            pool = (f", the engine's graph pool {out['graph_pool_gib']:.2f} "
                    f"GiB ({engine.graph_count()} graphs)")
        else:
            out["graph_pool_gib"] = None
    log(f"memory after {label}: reserved {out['reserved_gib']:.2f} GiB, "
        f"peak reserved {out['peak_reserved_gib']:.2f} GiB, peak allocated "
        f"{out['peak_allocated_gib']:.2f} GiB{pool}")
    return out


def graph_vs_eager(label: str, sess, plan, dtype) -> dict:
    """One ``qr`` of ``plan`` eager (`eager_call`: outside the graph)
    against its replay: R bit for bit, and per call the kernels and copies,
    the device's busy share and the wall time (median of 3). If two eager
    runs already differ, that difference is logged and the float64 replay is
    held to its eager run at 1e-9 relative instead."""
    import torch

    def replay():
        return sess.qr(plan, dtype=dtype)

    def eager():
        return eager_call(sess, plan, "qr", dtype=dtype)

    captures = sess.engine.capture_count()
    replay()
    replay()  # captured by now (on a signature's second dispatch)
    r_e1, r_e2, r_g = eager(), eager(), replay()
    torch.cuda.synchronize()
    same_eager = torch.equal(r_e1, r_e2)
    same = torch.equal(r_g, r_e1)
    out = {"eager_runs_equal": same_eager, "replay_equals_eager": same,
           "eager_vs_eager": rel_err(r_e1, r_e2)[1],
           "replay_vs_eager": rel_err(r_g, r_e1)[1]}
    log(f"{label}: two eager runs bit-equal {same_eager} (relative "
        f"{out['eager_vs_eager']:.3e}); replay bit-equal to eager {same} "
        f"(relative {out['replay_vs_eager']:.3e}); captures "
        f"{captures} -> {sess.engine.capture_count()}")
    if same_eager:
        check(same, f"{label}: replayed R equals eager R bit for bit")
    else:
        r64_g = sess.qr(plan, dtype=torch.float64)
        r64_e = eager_call(sess, plan, "qr", dtype=torch.float64)
        out["float64_replay_vs_eager"] = rel_err(r64_g, r64_e)[1]
        log(f"{label}: float64 replay vs eager relative "
            f"{out['float64_replay_vs_eager']:.3e} (tol 1e-9)")
        check(out["float64_replay_vs_eager"] <= 1e-9,
              f"{label}: float64 replay within 1e-9 of eager")
    out["eager"] = profile_once(f"{label} eager", eager)
    out["replay"] = profile_once(f"{label} replay", replay)
    for name in ("eager", "replay"):
        count = out[name]["kernels_and_copies"]
        check(count <= MAX_KERNELS_PER_QR,
              f"{label} {name}: {count} kernels and copies (at most "
              f"{MAX_KERNELS_PER_QR})")
    for name, fn in (("eager", eager), ("replay", replay)):
        _, med, times, _ = wall(fn, REPS)
        out[name]["median_wall_ms"] = med * 1e3
        out[name]["wall_ms_runs"] = [x * 1e3 for x in times]
    log(f"{label}: median wall eager {out['eager']['median_wall_ms']:.2f} ms"
        f", replay {out['replay']['median_wall_ms']:.2f} ms; kernels and "
        f"copies eager {out['eager']['kernels_and_copies']}, replay "
        f"{out['replay']['kernels_and_copies']}; busy share eager "
        f"{out['eager']['busy_share']:.3f}, replay "
        f"{out['replay']['busy_share']:.3f}")
    return out


# -- phase 4c: the dataset surface ----------------------------------------------

def phase_dataset(tree, r64_plan_level, seed: int):
    """``Session(use_kernel=True, assembly="band").ingest(db).join(edges,
    root="auto")`` at the main configuration's scale: the planner's root and
    ranking, host seconds of ingest / join / lazy plan build; qr, svd,
    pca(k=8) and lsq("stars") (median of 3 after a warm-up); float64 R
    against the plan-level ``Session.qr`` of a plan of the same root; an
    append of 4,096 Review rows within capacity (no miss, no capture; R
    against a fresh plan over the grown tables); an append of 250,000
    CheckIn rows past capacity (one regrow, one miss, one capture; R against
    a fresh plan)."""
    import numpy as np
    import torch
    from repro_torch import figaro
    from repro_torch.core.join_tree import build_plan
    from repro_torch.core.postprocess import normalize_sign
    from repro_torch.kernels import _platform, _seg_scan

    def r_check(what, got, want):
        err = rel_err(normalize_sign(got), normalize_sign(want))
        log(f"{what}: max abs err {err[0]:.3e}, relative {err[1]:.3e} "
            f"(tol 1e-9)")
        check(err[1] <= 1e-9, what)
        return err[1]

    out = {}
    # A donating engine: phase 9a serves this dataset through it.
    sess = figaro.Session(use_kernel=True, assembly="band", device="cuda",
                          donate_data=True)
    eng = sess.engine
    t0 = time.perf_counter()
    tables = sess.ingest(tree.db)
    out["ingest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = tables.join(tree.edges(), root="auto")
    out["join_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = ds.plan
    out["plan_build_s"] = time.perf_counter() - t0
    out["root"] = ds.tree.root
    log(f"dataset: ingest {out['ingest_s']:.2f} s, join (full reduction and "
        f"root choice) {out['join_s']:.2f} s, lazy capacity plan "
        f"{out['plan_build_s']:.2f} s; root {out['root']!r}")
    explain = ds.explain()
    log(explain)
    ranked = [ln for ln in explain.splitlines() if "root=" in ln
              and "cost=" in ln]
    check(len(ranked) == 5, "explain() ranks all five roots")
    cap_review = ds.stats()["nodes"]["Review"]

    _platform.reset_launch_counts()
    t0 = time.perf_counter()
    ds.qr()
    torch.cuda.synchronize()
    out["first_qr_s"] = time.perf_counter() - t0
    r32, t_qr, ts_qr, _ = wall(ds.qr, REPS)
    (s, vt), t_svd, ts_svd, w_svd = wall(ds.svd, REPS)
    pca, t_pca, ts_pca, _ = wall(lambda: ds.pca(k=8), REPS)
    (beta, resid), t_lsq, ts_lsq, _ = wall(lambda: ds.lsq("stars"), REPS)
    launches = _platform.launch_counts()
    log(f"dataset launch counts: {launches}")
    for kname in ("node_fused", "panel_qr", "panel_qr_reg"):
        check(launches.get(kname, 0) > 0, f"{kname} launched on the "
              "dataset path")
    n = plan.spec.num_cols
    check(r32.shape == (n, n) and bool(torch.isfinite(r32).all()),
          "ds.qr shape/finite")
    check(s.shape == (n,) and bool(torch.isfinite(s).all()),
          "ds.svd shape/finite")
    check(pca.components.shape == (8, n)
          and bool(torch.isfinite(pca.components).all()),
          "ds.pca shape/finite")
    check(beta.shape == (n - 1,) and bool(torch.isfinite(beta).all())
          and bool(torch.isfinite(resid)), "ds.lsq shape/finite")
    out["ms"] = {"first_qr_f32": out["first_qr_s"] * 1e3,
                 "qr_f32": t_qr * 1e3, "svd_f64": t_svd * 1e3,
                 "svd_f64_first": w_svd * 1e3, "pca_f64": t_pca * 1e3,
                 "lsq_f64": t_lsq * 1e3}
    for label, ts in (("ds.qr float32", ts_qr), ("ds.svd", ts_svd),
                      ("ds.pca(k=8)", ts_pca), ("ds.lsq('stars')", ts_lsq)):
        log(f"{label}: median {statistics.median(ts) * 1e3:.2f} ms of "
            f"{[round(x * 1e3, 2) for x in ts]} ms")
    log(f"first ds.qr (eager; the next one captures): "
        f"{out['first_qr_s'] * 1e3:.1f} ms")

    r64 = ds.qr(dtype=torch.float64)
    if out["root"] == tree.root:
        want = r64_plan_level
    else:
        want = eager_call(sess, build_plan(ds.tree), "qr",
                          dtype=torch.float64)
    out["r_vs_plan_level"] = r_check(
        "ds.qr float64 vs the plan-level Session.qr of the same root", r64,
        want)
    torch.cuda.empty_cache()

    # -- append within capacity: 4,096 Review rows over existing keys
    rng = np.random.default_rng(seed)
    rev = ds.tree.db["Review"]
    pick = rng.integers(0, rev.num_rows, 4096)
    keys = {a: rev.key_col(a)[pick].copy() for a in rev.key_attrs}
    misses, captures = ds.stats()["trace_count"], eng.capture_count()
    t0 = time.perf_counter()
    in_cap = ds.append("Review", keys, rng.uniform(-3, 3, (4096, 1)))
    out["append_in_capacity_s"] = time.perf_counter() - t0
    check(in_cap, "4,096 Review rows fit Review's capacity")
    t0 = time.perf_counter()
    r64 = ds.qr(dtype=torch.float64)
    torch.cuda.synchronize()
    out["qr_after_append_ms"] = (time.perf_counter() - t0) * 1e3
    _, t_next, _, _ = wall(lambda: ds.qr(dtype=torch.float64), REPS)
    out["qr_f64_ms"] = t_next * 1e3
    st = ds.stats()
    log(f"append 4,096 Review rows (capacity {cap_review['capacity_rows']}, "
        f"live {cap_review['live_rows']} -> "
        f"{st['nodes']['Review']['live_rows']}): refresh_plan "
        f"{out['append_in_capacity_s']:.2f} s; next float64 qr "
        f"{out['qr_after_append_ms']:.1f} ms (the refreshed plan to the "
        f"card and its index copied into the graph's buffers), then "
        f"{out['qr_f64_ms']:.2f} ms; misses {misses} -> "
        f"{st['trace_count']}, captures {captures} -> "
        f"{eng.capture_count()}")
    check(st["trace_count"] == misses, "an in-capacity append: no miss")
    check(eng.capture_count() == captures,
          "an in-capacity append: no capture")
    fresh = build_plan(ds.tree)
    out["r_after_append"] = r_check(
        "after the in-capacity append: ds.qr vs a fresh plan", r64,
        eager_call(sess, fresh, "qr", dtype=torch.float64))
    # The eager references leave their blocks cached outside the graphs'
    # pool; hand them back before the next capture.
    del fresh
    torch.cuda.empty_cache()

    # -- append past capacity: 250,000 CheckIn rows
    chk = ds.tree.db["CheckIn"]
    before = st["nodes"]["CheckIn"]
    keys = {a: rng.choice(chk.key_col(a), 250_000) for a in chk.key_attrs}
    misses, captures = st["trace_count"], eng.capture_count()
    regrows, graphs = st["regrows"], eng.graph_count()
    out["memory_before_regrow"] = memory_log("phase 4c before the regrow",
                                             eng)
    t0 = time.perf_counter()
    in_cap = ds.append("CheckIn", keys, rng.uniform(-3, 3, (250_000, 1)))
    out["append_regrow_s"] = time.perf_counter() - t0
    check(not in_cap, "250,000 CheckIn rows overflow CheckIn's capacity")
    released = eng.graph_count()
    torch.cuda.empty_cache()
    out["memory_after_release"] = memory_log(
        "phase 4c after the regrow released the old spec's graphs", eng)
    check(released == 0, f"the regrow released the superseded spec's "
          f"{graphs} graphs ({released} left)")
    t0 = time.perf_counter()
    ds.qr(dtype=torch.float64)
    torch.cuda.synchronize()
    out["qr_after_regrow_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    r64 = ds.qr(dtype=torch.float64)
    torch.cuda.synchronize()
    out["qr_capture_after_regrow_ms"] = (time.perf_counter() - t0) * 1e3
    st = ds.stats()
    after = st["nodes"]["CheckIn"]
    log(f"append 250,000 CheckIn rows (capacity {before['capacity_rows']}, "
        f"live {before['live_rows']} -> capacity {after['capacity_rows']}, "
        f"live {after['live_rows']}): refresh_plan "
        f"{out['append_regrow_s']:.2f} s, graphs {graphs} -> {released}; "
        f"next float64 qr (a miss, eager) {out['qr_after_regrow_ms']:.1f} "
        f"ms, the one after (the capture and its replay) "
        f"{out['qr_capture_after_regrow_ms']:.1f} ms; regrows {regrows} -> "
        f"{st['regrows']}, misses {misses} -> {st['trace_count']}, captures "
        f"{captures} -> {eng.capture_count()}, graphs {eng.graph_count()}")
    check(st["regrows"] == regrows + 1, "exactly one regrow")
    check(st["trace_count"] == misses + 1, "exactly one miss")
    check(eng.capture_count() == captures + 1, "exactly one capture")
    check(eng.graph_count() == 1, "one live graph after the regrow")
    out["r_after_regrow"] = r_check(
        "after the regrow: ds.qr vs a fresh plan", r64,
        eager_call(sess, build_plan(ds.tree), "qr", dtype=torch.float64))
    out["stats"] = {k: st[k] for k in ("appends", "regrows", "root",
                                       "trace_count", "traces",
                                       "cached_executables")}
    out["captures"] = eng.capture_count()
    out["graphs"] = eng.graph_count()
    _seg_scan.check()
    out["memory"] = memory_log("phase 4c", eng)
    return out, ds


# -- phase 9: serving ------------------------------------------------------------

def request_set(plan, n: int, dtype, rng) -> list:
    """``n`` requests: the plan's per-node data (capacity-shaped, dead rows
    zero) times a per-request scale of each column, drawn from ``rng``."""
    import numpy as np

    base = [np.asarray(d) for d in plan.data]
    return [tuple((d * rng.uniform(0.5, 2.0, d.shape[-1])).astype(dtype)
                  for d in base) for _ in range(n)]


class ServedRun:
    """Watches one server: the batches it dispatched (plan, live size,
    capacity) in order, the host ms of each batch's `stage`, and each
    future's submit and answer times; the futures in the order the
    completion thread resolved them (which is submission order)."""

    def __init__(self, server):
        import threading
        from repro_torch.train.async_serve import FigaroFuture

        self.server, self.batches, self.stage_ms = server, [], []
        self.order, self.t_submit, self.t_done = [], {}, {}
        self.rid = {}
        self._lock = threading.Lock()
        self.real_dispatch = server._dispatch_fn
        real_stage = server._engine_stage

        def dispatch(plan, batch, cap):
            self.batches.append((plan, int(batch[0].shape[0]), cap))
            return self.real_dispatch(plan, batch, cap)

        def stage(data):
            t0 = time.perf_counter()
            out = real_stage(data)
            self.stage_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        server._dispatch_fn = dispatch
        if real_stage is not None:  # None on the CPU: nothing is staged
            server._engine_stage = stage
        self._future_cls = FigaroFuture
        self._resolve = FigaroFuture._resolve
        run = self

        def resolve(fut, *args, **kwargs):
            with run._lock:
                run.order.append(fut)
                run.t_done[fut] = time.perf_counter()
            return run._resolve(fut, *args, **kwargs)

        FigaroFuture._resolve = resolve

    def close(self) -> None:
        self._future_cls._resolve = self._resolve

    def submit(self, rid, request):
        t0 = time.perf_counter()
        fut = self.server.submit(request)
        with self._lock:
            self.t_submit[fut] = t0
            self.rid[fut] = rid
        return fut

    def groups(self) -> list:
        """[(plan, capacity, [request ids])] per dispatched batch."""
        order = [self.rid[f] for f in self.order]
        out, at = [], 0
        for plan, b, cap in self.batches:
            out.append((plan, cap, order[at:at + b]))
            at += b
        check(at == len(order), f"{at} requests dispatched, {len(order)} "
              "answered")
        return out

    def latencies_ms(self, futures) -> list:
        return [(self.t_done[f] - self.t_submit[f]) * 1e3 for f in futures]

    def rate(self, *windows) -> float:
        """Requests per second over ``windows`` (lists of futures), each
        from its first submit to its last answer."""
        span = sum(max(self.t_done[f] for f in w) - min(
            self.t_submit[f] for f in w) for w in windows)
        return sum(len(w) for w in windows) / span


def percentile(xs, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs), q))


def bit_equal(a, b) -> bool:
    from repro_torch.core.engine import PCAResult

    if isinstance(a, tuple):
        return all(bit_equal(x, y) for x, y in zip(a, b, strict=True))
    if isinstance(a, PCAResult):
        return all(bit_equal(getattr(a, f), getattr(b, f)) for f in (
            "components", "explained_variance", "mean", "num_rows"))
    return bool(a.shape == b.shape and a.dtype == b.dtype
                and (a == b).all())


def sign_aligned(x, ref):
    """``x`` with each row's sign matched to ``ref``'s (singular vectors and
    principal components are unique only up to sign)."""
    s = (x.double() * ref.double()).sum(dim=-1, keepdim=True).sign()
    return x.double() * (s + (s == 0).double())


def served_vs_references(run, reqs, kind: str, single) -> dict:
    """Every answer of ``run`` against the same batch dispatched
    synchronously through the server's own dispatch (same engine, same
    graph): bit for bit; and against ``single(plan, request)``, an eager
    batch of one, within the §2 limits (float32 RᵀR 1e-4 of float64's;
    float64 1e-9 relative, vectors up to sign)."""
    import numpy as np
    import torch

    answers = {run.rid[f]: f.result(timeout=0) for f in run.order}
    worst = 0.0
    for plan, cap, rids in run.groups():
        batch = tuple(np.stack([reqs[r][j] for r in rids])
                      for j in range(len(reqs[rids[0]])))
        sync = run.real_dispatch(plan, batch, cap)
        for i, r in enumerate(rids):
            from repro_torch.core.engine import map_result

            want = map_result(lambda x: x[i], sync)
            check(bit_equal(answers[r], want), f"{kind} request {r}: the "
                  "served answer equals the synchronous batched dispatch "
                  "of its batch bit for bit")
            ref = single(plan, reqs[r])
            got = answers[r]
            if kind == "qr":
                err = rel_err(gram(got), gram(ref))[1]
                tol = 1e-4
            elif kind == "svd":
                err = max(rel_err(got[0], ref[0])[1],
                          rel_err(sign_aligned(got[1], ref[1]), ref[1])[1])
                tol = 1e-9
            elif kind == "pca":
                err = max(rel_err(got.explained_variance,
                                  ref.explained_variance)[1],
                          rel_err(got.mean, ref.mean)[1],
                          rel_err(sign_aligned(got.components,
                                               ref.components),
                                  ref.components)[1])
                tol = 1e-9
            else:
                err = max(rel_err(got[0], ref[0])[1],
                          rel_err(got[1], ref[1])[1])
                tol = 1e-9
            check(err <= tol, f"{kind} request {r}: {err:.3e} from the "
                  f"eager batch of one (limit {tol:g})")
            worst = max(worst, err)
        del batch, sync
        torch.cuda.empty_cache()
    return {"max_rel_err_vs_single": worst}


def device_events(prof):
    """(name, start µs, end µs) of every device activity in a trace."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("Command Buffer")]


def copy_overlap(events) -> dict:
    """How much of the trace's host-to-device copy time ran while a kernel
    ran: the copies of the next batch beside the current batch's kernels."""
    kernels = sorted((s, e) for n, s, e in events if not n.startswith(
        ("Memcpy", "Memset")))
    merged = []
    for s, e in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    h2d = [(s, e) for n, s, e in events if "HtoD" in n]
    total = sum(e - s for s, e in h2d)
    over = sum(max(0.0, min(e, me) - max(s, ms))
               for s, e in h2d for ms, me in merged)
    return {"h2d_copies": len(h2d), "h2d_ms": total / 1e3,
            "h2d_beside_kernels_ms": over / 1e3,
            "h2d_beside_kernels_share": over / total if total else 0.0,
            "copies_beside_kernels": sum(
                1 for s, e in h2d if any(min(e, me) > max(s, ms)
                                         for ms, me in merged))}


def profile_served(label: str, run, reqs, batches: int) -> dict:
    """One profiler trace over ``len(reqs)`` requests submitted while the
    coalescer is held, then released (``batches`` batches): the port kernels
    in the trace against the launch counters' growth (`trace_launches`),
    kernels and copies per batch (at most `MAX_KERNELS_PER_QR`), the device's
    busy share, and the staging copies' overlap with kernels
    (`copy_overlap`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _platform

    torch.cuda.synchronize()
    before = _platform.launch_counts()
    n_batches = len(run.batches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.server.pause()
        futures = [run.submit(("profile", i), r) for i, r in enumerate(reqs)]
        run.server.resume()
        for f in futures:
            f.result(timeout=600)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    counted = {k: v - before.get(k, 0)
               for k, v in _platform.launch_counts().items()
               if v != before.get(k, 0)}
    check(len(run.batches) - n_batches == batches,
          f"{label}: {len(run.batches) - n_batches} batches (expected "
          f"{batches})")
    from torch.autograd import DeviceType

    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.key.startswith("Command Buffer")
              and e.key != "figaro.r0_assembly"]
    attr = "self_device_time_total" if device and hasattr(
        device[0], "self_device_time_total") else "self_cuda_time_total"
    busy_us = sum(getattr(e, attr) for e in device)
    launches = sum(e.count for e in device)
    traced = trace_launches(label, device, counted)
    overlap = copy_overlap(device_events(prof))
    overlap["h2d_issued"] = batches * len(reqs[0])  # one per leaf a batch
    per_batch = launches / batches
    check(per_batch <= MAX_KERNELS_PER_QR,
          f"{label}: {per_batch:.0f} kernels and copies a batch (at most "
          f"{MAX_KERNELS_PER_QR})")
    log(f"profile {label}: {batches} batches of {len(reqs) // batches}, wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {per_batch:.0f} kernels and "
        f"copies a batch; host-to-device copies in the trace "
        f"{overlap['h2d_copies']} of {overlap['h2d_issued']} issued, "
        f"{overlap['h2d_ms']:.3f} ms, of which "
        f"{overlap['h2d_beside_kernels_ms']:.3f} ms "
        f"({100 * overlap['h2d_beside_kernels_share']:.1f}%, "
        f"{overlap['copies_beside_kernels']} copies) beside kernels; port "
        f"kernels in the trace {traced}")
    for e in sorted(device, key=lambda e: -getattr(e, attr))[:8]:
        log(f"  {getattr(e, attr) / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    return dict(overlap, wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                busy_share=busy_us / wall_us,
                kernels_and_copies_per_batch=per_batch,
                traced_launches=traced)


def warm_buckets(label: str, run, reqs, caps, eng) -> dict:
    """Two held batches per bucket (the eager first dispatch, then the
    capture): one capture each; the graphs, graph pool and reserved memory
    after each bucket."""
    import torch

    memory = {}
    for cap in caps:
        captures = eng.capture_count()
        for rnd in range(2):
            run.server.pause()
            futures = [run.submit(("warm", cap, rnd, i), reqs[i])
                       for i in range(cap)]
            run.server.resume()
            for f in futures:
                f.result(timeout=600)
        torch.cuda.synchronize()
        check(eng.capture_count() == captures + 1,
              f"{label}: bucket {cap} captured once")
        memory[cap] = memory_log(f"{label} bucket {cap} (eager, then "
                                 "captured)", eng)
        memory[cap]["graphs"] = eng.graph_count()
    return memory


def serve_summary(label, run, *windows) -> dict:
    """Requests/s over the windows (`ServedRun.rate`), latency percentiles,
    the batch sizes dispatched and the host ms of staging."""
    futures = [f for w in windows for f in w]
    lat = run.latencies_ms(futures)
    sizes = [b for _, b, _ in run.batches]
    out = {"requests": len(futures), "requests_per_s": run.rate(*windows),
           "p50_ms": percentile(lat, 50), "p99_ms": percentile(lat, 99),
           "batch_sizes": sizes, "stage_ms": list(run.stage_ms)}
    log(f"{label}: {len(futures)} requests, {out['requests_per_s']:.2f} "
        f"requests/s, latency p50 {out['p50_ms']:.1f} ms, p99 "
        f"{out['p99_ms']:.1f} ms; batches dispatched {sizes}; staging "
        f"{statistics.median(run.stage_ms or [0.0]):.2f} ms a batch (median "
        f"host ms of engine.stage)")
    return out


def phase_serve_full(ds, seed: int) -> dict:
    """9a: ``ds.serve(kind="qr")`` (float32, the kernels, band assembly,
    ``max_batch=2``, ``queue_depth=2``) over phase 4c's dataset, at the
    yelp scale: buckets 1 and 2 warmed (eager, then captured), then 16
    requests from two threads with 4,096 Review rows appended within
    capacity through ``server.append`` midway (no miss, no capture), each
    answer against the synchronous batched dispatch of its batch (bit for
    bit) and an eager float64 batch of one (RᵀR, 1e-4); one traced window of
    four B = 2 batches; then the B = 2 node passes and panels of one eager
    dispatch against their plain versions."""
    import gc
    import threading

    import numpy as np
    import torch
    from repro_torch.kernels import _platform, _seg_scan

    sess = ds._session
    eng = sess.engine
    eng.release_graphs(ds.plan.spec)  # phase 4c's float64 graph
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"memory_before": memory_log("phase 9a start", eng)}
    rng = np.random.default_rng(seed + 9)
    server = ds.serve(kind="qr", max_batch=2, queue_depth=2)
    run = ServedRun(server)
    try:
        warm = request_set(ds.plan, 2, np.float32, rng)
        out["buckets"] = warm_buckets("9a", run, warm, (1, 2), eng)
        del warm
        pre = request_set(ds.plan, 8, np.float32, rng)
        reqs = {("pre", i): r for i, r in enumerate(pre)}
        misses, captures = eng.trace_count(), eng.capture_count()
        n_warm = len(run.batches)
        post = []
        barrier = threading.Barrier(3, timeout=900)
        errors, futures = [], []

        def user(t):
            try:
                for i in range(t, 8, 2):
                    futures.append(run.submit(("pre", i), pre[i]))
                barrier.wait()  # the append
                barrier.wait()  # requests of the grown plan
                for i in range(t, 8, 2):
                    futures.append(run.submit(("post", i), post[i]))
            except Exception as exc:  # raised below
                errors.append(exc)

        _platform.reset_launch_counts()
        users = [threading.Thread(target=user, args=(t,)) for t in (0, 1)]
        for t in users:
            t.start()
        barrier.wait()
        rev = ds.tree.db["Review"]
        pick = rng.integers(0, rev.num_rows, 4096)
        keys = {a: rev.key_col(a)[pick].copy() for a in rev.key_attrs}
        t0 = time.perf_counter()
        in_cap = server.append("Review", (keys, rng.uniform(-3, 3,
                                                            (4096, 1))))
        out["append_s"] = time.perf_counter() - t0
        check(in_cap, "9a: 4,096 Review rows fit Review's capacity")
        post[:] = request_set(ds.plan, 8, np.float32, rng)
        reqs.update({("post", i): r for i, r in enumerate(post)})
        barrier.wait()
        for t in users:
            t.join(timeout=900)
        check(not errors and not any(t.is_alive() for t in users),
              f"9a users: {errors}")
        server.flush()
        launches = _platform.launch_counts()
        for f in futures:
            check(f.exception(timeout=0) is None,
                  f"9a: every future answered ({f.exception(timeout=0)!r})")
        log(f"9a launch counts over the served stream: {launches}")
        for kname in ("node_fused", "panel_qr", "panel_qr_reg"):
            check(launches.get(kname, 0) > 0, f"{kname} launched on the "
                  "served path")
        check(eng.trace_count() == misses and eng.capture_count() == captures,
              f"9a: the stream and its in-capacity append: misses {misses} "
              f"-> {eng.trace_count()}, captures {captures} -> "
              f"{eng.capture_count()} (0 and 0 expected)")
        stream = run.batches[n_warm:]
        check(any(b == 2 for _, b, _ in stream), "9a: a coalesced B = 2 "
              "batch")
        run.batches[:] = stream
        run.stage_ms[:] = run.stage_ms[n_warm:]
        halves = [[f for f in futures if run.rid[f][0] == h]
                  for h in ("pre", "post")]
        out["stream"] = serve_summary("9a served qr float32 (16 requests, "
                                      "2 threads; the append's drain and "
                                      "refresh not counted)", run, *halves)
        out["stream"]["requests_per_s_halves"] = [run.rate(h)
                                                  for h in halves]
        out["stream"]["launches"] = launches
        out["stream"]["misses"] = eng.trace_count() - misses
        out["stream"]["captures"] = eng.capture_count() - captures
        log(f"9a: append 4,096 Review rows {out['append_s']:.2f} s; "
            f"requests/s before / after it "
            f"{out['stream']['requests_per_s_halves']}; misses and captures "
            f"over the stream 0, 0")

        def single(plan, req):
            with eng.eager_reference():
                return sess.qr(plan, req, dtype=torch.float64)

        streamed = set(futures)
        run.order = [f for f in run.order if f in streamed]
        out["checks"] = served_vs_references(run, reqs, "qr", single)
        log(f"9a: 16 answers bit-equal to their batches' synchronous "
            f"dispatch; float32 R'R vs the eager float64 batch of one, worst "
            f"{out['checks']['max_rel_err_vs_single']:.3e} (limit 1e-4)")
        run.batches.clear()
        prof_reqs = request_set(ds.plan, 8, np.float32, rng)
        out["profile"] = profile_served("9a served qr, four B = 2 batches",
                                        run, prof_reqs, 4)
        out["memory"] = memory_log("phase 9a served stream", eng)
    finally:
        run.close()
        server.close()
    eng.release_graphs(ds.plan.spec)
    del server, run
    gc.collect()
    torch.cuda.empty_cache()
    # The B = 2 node passes and panels, captured from one eager dispatch.
    batch = tuple(np.stack([p, q]) for p, q in zip(*prof_reqs[:2]))
    with Capture() as cap:
        with eng.eager_reference():
            eng.qr(ds.plan, batch, batched=True, batch_capacity=2,
                   dtype=torch.float32, use_kernel=True, assembly="band",
                   device=sess.device)
        torch.cuda.synchronize()
    del batch, prof_reqs
    out["kernels_b2"] = measure_path_kernels(cap.calls, "float32",
                                             label="B = 2 served batch")
    del cap
    gc.collect()
    torch.cuda.empty_cache()
    _seg_scan.check()
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    log(f"phase 9a: peak reserved {out['peak_reserved_gib']:.2f} GiB")
    check(out["peak_reserved_gib"] < 80, "9a fits the 80 GB card")
    return out


SERVE_CUT_SCALE = 500_000  # 9b: yelp_like at about 1/8 of phase 4's rows


def phase_serve_cut(seed: int) -> dict:
    """9b: the float64 kinds on ``yelp_like(scale=500_000, cols=16)`` (the
    shapes of phase 4 at about 1/8 of the rows: a batch of 8 float64
    requests at the full scale would pin about 8 × 19 GiB of graph):
    ``svd``, ``pca(k=8)`` and ``lsq("stars")`` served with ``max_batch=8``,
    24 requests each submitted in one burst while the coalescer is held (3
    batches of 8; svd's first runs eagerly, its second captures, pca and
    lsq replay the same R graph), each answer against its batch's
    synchronous dispatch (bit for bit) and an eager batch of one (1e-9
    relative, vectors up to sign); one traced B = 8 svd window."""
    import gc

    import numpy as np
    import torch
    from repro_torch import figaro
    from repro_torch.data.relational import yelp_like
    from repro_torch.kernels import _platform, _seg_scan

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = yelp_like(scale=SERVE_CUT_SCALE, cols=16)
    sess = figaro.Session(use_kernel=True, assembly="band", device="cuda",
                          donate_data=True)
    ds = sess.from_tree(tree)
    plan = ds.plan
    eng = sess.engine
    out = {"setup_s": time.perf_counter() - t0,
           "r0_rows_capacity": plan.spec.r0_rows,
           "nodes": {sp.name: sp.m for sp in plan.spec.nodes}}
    log(f"9b: yelp_like(scale={SERVE_CUT_SCALE}, cols=16) and its capacity "
        f"plan in {out['setup_s']:.1f} s; capacity rows {out['nodes']}, R0 "
        f"{plan.spec.r0_rows} x {plan.spec.num_cols}")
    rng = np.random.default_rng(seed + 90)
    kinds = (("svd", {}), ("pca", {"k": 8}), ("lsq", {"label_col": "stars"}))
    for kind, kw in kinds:
        server = ds.serve(kind=kind, max_batch=8, **kw)
        run = ServedRun(server)
        try:
            reqs = {i: r for i, r in enumerate(
                request_set(plan, 24, np.float64, rng))}
            misses, captures = eng.trace_count(), eng.capture_count()
            _platform.reset_launch_counts()
            server.pause()
            futures = [run.submit(i, reqs[i]) for i in range(24)]
            server.resume()
            for f in futures:
                check(f.exception(timeout=900) is None,
                      f"9b {kind}: every future answered "
                      f"({f.exception(timeout=0)!r})")
            torch.cuda.synchronize()
            launches = _platform.launch_counts()
            for kname in ("node_fused", "panel_qr", "panel_qr_reg"):
                check(launches.get(kname, 0) > 0, f"{kname} launched on "
                      f"the served {kind} path")
            res = serve_summary(f"9b served {kind} float64 (24 requests, "
                                "max_batch 8)", run, futures)
            check(res["batch_sizes"] == [8, 8, 8],
                  f"9b {kind}: three B = 8 batches")
            res.update(launches=launches,
                       misses=eng.trace_count() - misses,
                       captures=eng.capture_count() - captures)
            if kind == "svd":
                res["memory"] = memory_log("9b bucket 8 (svd: eager, then "
                                           "captured)", eng)
                res["memory"]["graphs"] = eng.graph_count()

            def single(plan_, req, kind=kind):
                with eng.eager_reference():
                    if kind == "svd":
                        return ds.svd(req)
                    if kind == "pca":
                        return ds.pca(req, k=8)
                    return ds.lsq("stars", req)

            res["checks"] = served_vs_references(run, reqs, kind, single)
            log(f"9b {kind}: 24 answers bit-equal to their batches' "
                f"synchronous dispatch; vs the eager batch of one, worst "
                f"{res['checks']['max_rel_err_vs_single']:.3e} (limit 1e-9); "
                f"misses {res['misses']}, captures {res['captures']}")
            if kind == "svd":
                run.batches.clear()
                res["profile"] = profile_served(
                    "9b served svd, one B = 8 batch", run,
                    request_set(plan, 8, np.float64, rng), 1)
            out[kind] = res
        finally:
            run.close()
            server.close()
    check(eng.capture_count() == 1, "9b: one capture (svd's bucket 8); pca "
          "and lsq replay its R graph")
    _seg_scan.check()
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    out["memory"] = memory_log("phase 9b", eng)
    log(f"phase 9b: peak reserved {out['peak_reserved_gib']:.2f} GiB")
    check(out["peak_reserved_gib"] < 80, "9b fits the 80 GB card")
    del ds, sess, eng, plan
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 10: distribution ---------------------------------------------------

DIST_PARTS = 4  # fact partitions of phase 10
DIST_QR_SHAPE = (1 << 22, 32)  # 10b's random tall matrix (float64)
DIST_BATCH = 2  # 10b's sharded svd batch, on 9b's configuration


def phase_partitioned(tree, r64, qr64_ms: float) -> dict:
    """10a: ``Session(use_kernel=True, assembly="band").partitioned_qr(tree,
    4)`` in float64 on phase 4's tree, no mesh: the partitions run one after
    another on the card through the session's engine (a graph each from the
    second call) and their Rs are TSQR-combined there. Host seconds of
    `partition_fact_table` and of the four plan builds; the median of 3
    wall times beside phase 4's float64 ``qr``; the launches (counters
    zeroed around the timed calls) and captures; R against phase 4's
    float64 plan-level ``qr`` at 1e-9 relative; peak reserved memory."""
    import torch
    from repro_torch import figaro
    from repro_torch.core.distributed import partition_fact_table
    from repro_torch.core.join_tree import build_plan
    from repro_torch.kernels import _platform, _seg_scan

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    parts = partition_fact_table(tree, DIST_PARTS)
    out = {"partition_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    plans = [build_plan(t) for t in parts]
    out["plan_builds_s"] = time.perf_counter() - t0
    out["partitions"] = [{"rows": {sp.name: sp.m for sp in p.spec.nodes},
                          "r0_rows": p.spec.r0_rows} for p in plans]
    log(f"10a: partition_fact_table(tree, {DIST_PARTS}) "
        f"{out['partition_s']:.2f} s, the four plan builds "
        f"{out['plan_builds_s']:.2f} s; R0 rows "
        f"{[p['r0_rows'] for p in out['partitions']]}")
    del parts, plans
    sess = figaro.Session(use_kernel=True, assembly="band", device="cuda")
    _platform.reset_launch_counts()
    r, med, times, warm = wall(lambda: sess.partitioned_qr(tree, DIST_PARTS),
                               REPS)
    out["launches"] = _platform.launch_counts()
    calls = REPS + 1
    out["launches_per_call"] = {k: v / calls
                                for k, v in out["launches"].items()}
    for kname in ("node_fused", "panel_qr", "panel_qr_reg"):
        check(out["launches"].get(kname, 0) > 0,
              f"{kname} launched on the partitioned path")
    out.update(wall_ms=med * 1e3, wall_ms_runs=[x * 1e3 for x in times],
               first_call_ms=warm * 1e3, qr64_ms=qr64_ms,
               captures=sess.engine.capture_count(),
               misses=sess.engine.trace_count())
    err_abs, out["r_rel_err"] = rel_err(r, r64)
    log(f"10a partitioned_qr float64: median {out['wall_ms']:.1f} ms of "
        f"{[round(x, 1) for x in out['wall_ms_runs']]} (first call "
        f"{out['first_call_ms']:.1f} ms) against phase 4's float64 qr "
        f"{qr64_ms:.1f} ms; {out['misses']} misses, {out['captures']} "
        f"captures; launches over {calls} calls {out['launches']}; R vs "
        f"phase 4's float64 qr: max abs err {err_abs:.3e}, relative "
        f"{out['r_rel_err']:.3e} (tol 1e-9)")
    check(out["r_rel_err"] <= 1e-9, "10a: partitioned R matches the qr")
    _seg_scan.check()
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    out["memory"] = memory_log("phase 10a", sess.engine)
    check(out["peak_reserved_gib"] < 80, "10a fits the 80 GB card")
    return out, sess, r


def phase_nccl_mesh(tree, plan, sess, r_part, seed: int,
                    rates_9b: dict) -> dict:
    """10b: a one-rank NCCL group on ``cuda:0`` (a `FileStore` in a
    temporary directory, a timeout, the communicator made eagerly through
    ``device_id``) and its data mesh: `distributed_postprocess_r0` of phase
    4's float64 R₀ with the panel kernel (its one block, taller than 4,096
    rows, takes the grid variant) against `postprocess_r0` of the same R₀;
    `distributed_qr_r` of a random float64 [2²², 32] from ``--seed``; a
    sharded B = 2 float64 ``svd`` on 9b's configuration against the same
    session without a mesh; ``partitioned_qr`` over the mesh against 10a.
    Each at 1e-9 relative (vectors up to sign); the launch counters zeroed
    around each. Then, in the same group and with 10a's and 10b's graphs
    released, 10c (`phase_serve_mesh`). The group is destroyed at the end,
    whatever happened."""
    import datetime
    import gc
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import figaro
    from repro_torch.core.distributed import (distributed_postprocess_r0,
                                              distributed_qr_r)
    from repro_torch.core.join_tree import build_plan
    from repro_torch.core.postprocess import postprocess_r0
    from repro_torch.data.relational import yelp_like
    from repro_torch.kernels import _platform, _seg_scan
    from repro_torch.launch.mesh import make_data_mesh

    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(pathlib.Path(tmp) / "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300),
            device_id=torch.device("cuda", 0))
        try:
            mesh = make_data_mesh()
            check(mesh.size == 1 and mesh.backend == "nccl"
                  and mesh.device == torch.device("cuda", 0),
                  f"a one-rank NCCL mesh on cuda:0 ({mesh})")
            log(f"10b: NCCL {torch.cuda.nccl.version()} group of one rank; "
                f"mesh {mesh.shape} on {mesh.device}")

            # 1. the TSQR combine of phase 4's R0 (capacity rows)
            torch.cuda.reset_peak_memory_stats()
            r0 = sess.r0(plan, dtype=torch.float64)
            torch.cuda.synchronize()
            _platform.reset_launch_counts()
            r_d, t_d, ts_d, _ = wall(lambda: distributed_postprocess_r0(
                r0, mesh, use_kernel=True), REPS)
            launches = _platform.launch_counts()
            check(launches.get("panel_qr_grid", 0) > 0,
                  "10b: panel_qr_grid launched in distributed_postprocess_r0")
            r_t, t_t, ts_t, _ = wall(lambda: postprocess_r0(
                r0, use_kernel=True), REPS)
            r_p, t_p, ts_p, _ = wall(lambda: postprocess_r0(r0), REPS)
            err = rel_err(r_d, r_p)[1]
            out["postprocess"] = {
                "r0_rows": int(r0.shape[0]), "launches": launches,
                "distributed_ms": t_d * 1e3,
                "distributed_ms_runs": [x * 1e3 for x in ts_d],
                "postprocess_kernel_ms": t_t * 1e3,
                "postprocess_kernel_ms_runs": [x * 1e3 for x in ts_t],
                "postprocess_plain_ms": t_p * 1e3,
                "postprocess_plain_ms_runs": [x * 1e3 for x in ts_p],
                "r_rel_err": err,
                "r_rel_err_vs_kernel_tsqr": rel_err(r_d, r_t)[1],
                "peak_reserved_gib":
                    torch.cuda.max_memory_reserved() / 2**30}
            log(f"10b distributed_postprocess_r0 (R0 {tuple(r0.shape)} "
                f"float64, use_kernel=True): median {t_d * 1e3:.1f} ms; "
                f"postprocess_r0 TSQR with the kernel {t_t * 1e3:.1f} ms, "
                f"plain {t_p * 1e3:.1f} ms; launches {launches}; R vs the "
                f"plain postprocess_r0 relative {err:.3e} (tol 1e-9)")
            check(err <= 1e-9, "10b: distributed_postprocess_r0 matches "
                  "postprocess_r0")
            del r0, r_d, r_t, r_p
            torch.cuda.empty_cache()

            # 2. a random tall matrix
            gen = torch.Generator(device="cuda").manual_seed(seed)
            a = torch.randn(DIST_QR_SHAPE, dtype=torch.float64,
                            device="cuda", generator=gen)
            _platform.reset_launch_counts()
            r_a, t_a, _, _ = wall(lambda: distributed_qr_r(
                a, mesh, use_kernel=True), REPS)
            launches = _platform.launch_counts()
            check(launches.get("panel_qr_grid", 0) > 0,
                  "10b: panel_qr_grid launched in distributed_qr_r")
            err = rel_err(r_a, postprocess_r0(a))[1]
            out["tall"] = {"shape": list(DIST_QR_SHAPE), "ms": t_a * 1e3,
                           "launches": launches, "r_rel_err": err}
            log(f"10b distributed_qr_r {list(DIST_QR_SHAPE)} float64: median "
                f"{t_a * 1e3:.1f} ms; launches {launches}; R vs "
                f"postprocess_r0 relative {err:.3e} (tol 1e-9)")
            check(err <= 1e-9, "10b: distributed_qr_r matches postprocess_r0")
            del a, r_a
            torch.cuda.empty_cache()

            # 3. a sharded svd batch on 9b's configuration
            cut = build_plan(yelp_like(scale=SERVE_CUT_SCALE, cols=16))
            rng = np.random.default_rng(seed + 100)
            reqs = request_set(cut, DIST_BATCH, np.float64, rng)
            batch = tuple(np.stack([r[j] for r in reqs])
                          for j in range(len(reqs[0])))
            meshed = figaro.Session(mesh=mesh, use_kernel=True,
                                    assembly="band", device="cuda")
            lone = figaro.Session(use_kernel=True, assembly="band",
                                  device="cuda")
            _platform.reset_launch_counts()
            got = [meshed.svd(cut, batch, batched=True) for _ in range(2)]
            torch.cuda.synchronize()
            launches = _platform.launch_counts()
            for kname in ("node_fused", "panel_qr", "panel_qr_reg"):
                check(launches.get(kname, 0) > 0,
                      f"{kname} launched on the sharded svd")
            s_w, vt_w = lone.svd(cut, batch, batched=True)
            errs = [max(rel_err(s, s_w)[1],
                        rel_err(sign_aligned(vt, vt_w), vt_w)[1])
                    for s, vt in got]
            out["sharded_svd"] = {
                "batch": DIST_BATCH, "launches": launches,
                "captures": meshed.engine.capture_count(),
                "misses": meshed.engine.trace_count(),
                "max_rel_err": max(errs)}
            log(f"10b sharded svd B = {DIST_BATCH} float64 on "
                f"yelp_like(scale={SERVE_CUT_SCALE}): eager, then captured; "
                f"{out['sharded_svd']['misses']} misses, "
                f"{out['sharded_svd']['captures']} captures; launches "
                f"{launches}; vs the session without a mesh relative "
                f"{max(errs):.3e} (tol 1e-9)")
            check(max(errs) <= 1e-9, "10b: sharded svd matches unsharded")
            check(meshed.engine.capture_count() == 1,
                  "10b: the sharded svd's second call captured its graph")
            del got, meshed, lone, cut, batch, reqs
            gc.collect()
            torch.cuda.empty_cache()

            # 4. the partitions over the mesh, through 10a's engine
            _platform.reset_launch_counts()
            t0 = time.perf_counter()
            r_m = sess.partitioned_qr(tree, DIST_PARTS, mesh=mesh)
            torch.cuda.synchronize()
            t_m = time.perf_counter() - t0
            launches = _platform.launch_counts()
            for kname in ("node_fused", "panel_qr"):
                check(launches.get(kname, 0) > 0,
                      f"{kname} launched on the partitioned path over the "
                      f"mesh")
            err = rel_err(r_m, r_part)[1]
            out["partitioned_mesh"] = {"ms": t_m * 1e3, "launches": launches,
                                       "r_rel_err": err}
            log(f"10b partitioned_qr(tree, {DIST_PARTS}, mesh=mesh): "
                f"{t_m * 1e3:.1f} ms; launches {launches}; R vs 10a "
                f"relative {err:.3e} (tol 1e-9)")
            check(err <= 1e-9, "10b: partitions over the mesh match 10a")
            _seg_scan.check()
            out["memory"] = memory_log("phase 10b")

            # 10c: a served stream over the mesh, in the same group
            del r_m
            release_all_graphs(sess.engine)
            gc.collect()
            torch.cuda.empty_cache()
            out["served"] = phase_serve_mesh(mesh, seed, rates_9b)
        finally:
            dist.destroy_process_group()
    return out


def release_all_graphs(engine) -> None:
    """Free every captured graph of ``engine`` (its cache entries stay)."""
    for spec in {k[2] for k in list(engine._graphs)}:
        engine.release_graphs(spec)


class CountCollectives:
    """Counts calls of the collectives of `torch.distributed` the port can
    issue, while the block runs."""

    NAMES = ("all_gather", "all_reduce", "broadcast", "scatter",
             "broadcast_object_list", "all_gather_object",
             "batch_isend_irecv", "send", "recv")

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self._saved = [], {}
        for name in self.NAMES:
            fn = self._saved[name] = getattr(dist, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.calls.append(_name)
                return _fn(*args, **kwargs)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        return False


MESH_SERVE_REQUESTS = 24  # 10c: requests of each stream, as 9b's


def held_stream(server, reqs) -> tuple[list, float]:
    """``reqs`` submitted while the coalescer is held, then released: the
    answers in order and the requests/s from the first submit to the last
    answer."""
    server.pause()
    t0 = time.perf_counter()
    futures = [server.submit(r) for r in reqs]
    server.resume()
    answers = [f.result(timeout=900) for f in futures]
    return answers, len(reqs) / (time.perf_counter() - t0)


def phase_serve_mesh(mesh, seed: int, rates_9b: dict) -> dict:
    """10c, in 10b's one-rank NCCL group: 9b's configuration
    (``yelp_like(scale=500_000, cols=16)``, float64, the kernels, band
    assembly, ``max_batch=8``) served through ``Session(mesh=mesh)`` for
    ``svd``, ``pca(k=3)`` and ``lsq("stars")``. For each kind two datasets
    of the same tables: one served over the mesh, one through the same
    session without a mesh (``mesh=None``). Each gets 24 held requests (3
    batches of 8), an append within capacity (``server.append``: 512
    Review rows over existing keys), a regrowing one (``ds.append``:
    CheckIn rows past its capacity) and 24 more requests; every answer of
    the meshed server equals the unmeshed one bit for bit, the phase issues
    no collective, node_fused and panel_qr launch over each kind (counters
    zeroed around the meshed streams), requests/s beside 9b's, peak
    reserved memory under 80 GB."""
    import numpy as np
    import torch
    from repro_torch import figaro
    from repro_torch.data.relational import yelp_like
    from repro_torch.kernels import _platform, _seg_scan

    torch.cuda.reset_peak_memory_stats()
    tree = yelp_like(scale=SERVE_CUT_SCALE, cols=16)
    sess = figaro.Session(mesh=mesh, use_kernel=True, assembly="band",
                          device="cuda", donate_data=True)
    eng = sess.engine
    rng = np.random.default_rng(seed + 110)
    out = {}
    with CountCollectives() as counted:
        for kind, kw in (("svd", {}), ("pca", {"k": 3}),
                         ("lsq", {"label_col": "stars"})):
            meshed_ds, lone_ds = sess.from_tree(tree), sess.from_tree(tree)
            meshed = meshed_ds.serve(kind=kind, max_batch=8, **kw)
            lone = lone_ds.serve(kind=kind, max_batch=8, mesh=None, **kw)
            res = {"launches": {}, "requests_per_s": [],
                   "requests_per_s_no_mesh": []}
            equal = True
            try:
                # Before the appends the meshed server goes first (its
                # stream runs the new spec eagerly, then captures it; the
                # other replays), after them (the regrown spec) the other.
                for first in ("meshed", "lone"):
                    reqs = request_set(meshed_ds.plan, MESH_SERVE_REQUESTS,
                                       np.float64, rng)
                    answers = {}
                    for which in ((first, "lone") if first == "meshed"
                                  else (first, "meshed")):
                        _platform.reset_launch_counts()
                        answers[which], rate = held_stream(
                            meshed if which == "meshed" else lone, reqs)
                        torch.cuda.synchronize()
                        if which == "meshed":
                            for k, v in _platform.launch_counts().items():
                                res["launches"][k] = \
                                    res["launches"].get(k, 0) + v
                        res["requests_per_s" if which == "meshed"
                            else "requests_per_s_no_mesh"].append(rate)
                    equal &= all(bit_equal(a, b) for a, b in zip(
                        answers["meshed"], answers["lone"], strict=True))
                    del answers, reqs
                    if first == "meshed":
                        res["appends"] = serve_mesh_appends(
                            (meshed, lone), (meshed_ds, lone_ds), rng)
            finally:
                meshed.close()
                lone.close()
            for kname in ("node_fused", "panel_qr", "panel_qr_reg"):
                check(res["launches"].get(kname, 0) > 0,
                      f"10c {kname} launched on the served {kind} path over "
                      f"the mesh")
            check(equal, f"10c {kind}: every answer over the mesh equals "
                  f"the server's without a mesh bit for bit")
            log(f"10c served {kind} float64 over the one-rank NCCL mesh: "
                f"{MESH_SERVE_REQUESTS} requests before and after the "
                f"appends at {res['requests_per_s']} requests/s (without a "
                f"mesh {res['requests_per_s_no_mesh']}; 9b "
                f"{rates_9b[kind]}); answers bit-equal; launches "
                f"{res['launches']}")
            out[kind] = res
            release_all_graphs(eng)
            del meshed, lone, meshed_ds, lone_ds
            gc.collect()
            torch.cuda.empty_cache()
    out["collectives"] = len(counted.calls)
    check(not counted.calls, f"10c: a server over a one-rank mesh issues "
          f"no collective (it issued {counted.calls})")
    _seg_scan.check()
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    log(f"phase 10c: no collective; peak reserved "
        f"{out['peak_reserved_gib']:.2f} GiB")
    check(out["peak_reserved_gib"] < 80, "10c fits the 80 GB card")
    out["memory"] = memory_log("phase 10c", eng)
    return out


def serve_mesh_appends(servers, datasets, rng) -> dict:
    """10c's appends, the same on both datasets: 512 Review rows over
    existing keys through each ``server.append`` (within capacity), then
    CheckIn rows past its capacity through each ``ds.append`` (a regrow)."""
    import numpy as np

    nodes = datasets[0].stats()["nodes"]
    review = datasets[0].tree.db["Review"]
    checkin = datasets[0].tree.db["CheckIn"]
    grow = nodes["CheckIn"]["capacity_rows"] - nodes["CheckIn"][
        "live_rows"] + 1024
    pick = rng.integers(0, review.num_rows, 512)
    rows_review = ({a: review.key_col(a)[pick].copy()
                    for a in review.key_attrs},
                   rng.uniform(-3, 3, (512, review.data.shape[1])))
    pick = rng.integers(0, checkin.num_rows, grow)
    keys_checkin = {a: checkin.key_col(a)[pick].copy()
                    for a in checkin.key_attrs}
    data_checkin = rng.uniform(-3, 3, (grow, checkin.data.shape[1]))
    out = {"review_rows": 512, "checkin_rows": grow, "append_s": []}
    for server, ds in zip(servers, datasets, strict=True):
        t0 = time.perf_counter()
        check(server.append("Review", rows_review),
              "10c: 512 Review rows fit Review's capacity")
        check(not ds.append("CheckIn", keys_checkin, data_checkin),
              f"10c: {grow} CheckIn rows overflow CheckIn's capacity")
        out["append_s"].append(time.perf_counter() - t0)
    log(f"10c appends: 512 Review rows within capacity, then {grow} "
        f"CheckIn rows (a regrow), {[round(t, 2) for t in out['append_s']]} "
        f"s (over the mesh, without)")
    return out


# -- phase 3 (random panels, flash cases) --------------------------------------

def check_random_panels() -> dict:
    """panel_qr's cluster and grid variants on random full-rank panels,
    elementwise (V, beta, R) against the plain version and T against
    `_panel_to_wy` of the kernel's own V and beta (the cluster cases in
    float64, the grid ones in float64 and float32), and the grid variant on
    a rank-deficient panel (repeated columns, zero rows), held on RᵀR and
    `reflector_error`; each beside ``torch.geqrf``. Returns the `measure`
    result of each case by label."""
    import torch
    from repro_torch.kernels.panel_qr import kernel as pk

    f32, f64 = torch.float32, torch.float64
    cases = [((4, 1024, 32), f64, False), ((2, 4096, 32), f64, False)]
    cases += [(shape, dt, False) for dt in (f64, f32)
              for shape in ((1, 8192, 32), (3, 5000, 32), (1, 1_048_579, 32))]
    cases += [((1, 6000, 32), dt, True) for dt in (f64, f32)]
    out = {}
    for shape, dt, deficient in cases:
        g = torch.Generator(device="cuda").manual_seed(shape[1])
        a = torch.randn(*shape, generator=g, device="cuda", dtype=dt)
        if deficient:
            a[:, :, 16:] = a[:, :, :16]
            a[:, 100:300] = 0
        kind = pk.variant(shape[1])
        name = str(dt).split(".")[1]
        tol = TOL[("panel_qr", name)]
        compare, limits = panel_qr_full_compare, {"max_rel_err": tol,
                                                  "t_rel_err": tol}
        if deficient:
            compare = panel_qr_compare
            limits = dict(limits, reflectors=tol)
        res = measure([((a,), {})], wy_kernel, wy_plain, panel_qr_cost,
                      compare, name, library=geqrf, reps=3, fresh=wy_fresh)
        label = (f"panel_qr ({kind} variant) "
                 f"{'rank-deficient' if deficient else 'random'} {name} "
                 f"{list(shape)}")
        report(label + (", R'R, reflectors, T" if deficient
                        else ", V, beta, R, T"),
               res, limits, library="torch.geqrf")
        out[label] = {k: res[k] for k in ("max_rel_err", "t_rel_err",
                                          "reflectors", "ms", "library_ms")
                      if k in res}
        del a
        torch.cuda.empty_cache()
    return out


def visible_pairs(q_pos, k_pos, causal: bool, window) -> int:
    """Query-key pairs the mask lets through (per batch row and head)."""
    kp = k_pos[None, :].long()
    qp = q_pos[:, None].long()
    ok = (kp >= 0).expand(qp.shape[0], -1)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return int(ok.sum())


def flash_cost(q, k, v, q_pos, k_pos, causal=True,
               window=None) -> tuple[int, int]:
    """(bytes, flops) of one flash_attention call: q, k, v and the output
    (q's size) read or written once, the positions read once; two products
    of 2·hd flops per visible query-key pair and query head."""
    b, _, hq, hd = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + 4 * (q_pos.numel() + k_pos.numel())
    return nbytes, 4 * hd * b * hq * visible_pairs(q_pos, k_pos, causal,
                                                  window)


def flash_plain(q, k, v, q_pos, k_pos, causal=True, window=None):
    """The plain version one KV head (and its query group) at a time, so the
    materialized scores stay [B, 1, G, Tq, Tk]."""
    import torch
    from repro_torch.kernels.flash_attn import ref as fr

    hkv = k.shape[2]
    g = q.shape[2] // hkv
    return torch.cat([fr.flash_attention_ref(
        q[:, :, h * g:(h + 1) * g], k[:, :, h:h + 1], v[:, :, h:h + 1],
        q_pos, k_pos, causal=causal, window=window) for h in range(hkv)],
        dim=2)


def check_flash_cases() -> float:
    """flash_attention at hd 32, 64 and 256, with a window, without
    causality (float32, and bf16 at whisper-tiny's encoder: 1,500 keys,
    eleven full 128-key tiles and a tail of 92), on two packed sequences
    (positions restarting at 0 inside a 128-key tile) and in float32 and
    float64, against its plain version on random inputs; the worst
    `flash_compare` ratio (≤ 1 passes).
    float32/float64 cases are bounded at the tensor-core peaks."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as fk

    worst = 0.0
    for (b, t, hq, hkv, hd, causal, window, dt, packed) in (
            (1, 2048, 8, 2, 64, True, None, torch.bfloat16, False),
            (1, 1024, 4, 4, 256, True, None, torch.bfloat16, False),
            (2, 2048, 8, 2, 128, True, 512, torch.bfloat16, False),
            (1, 1000, 8, 8, 128, False, None, torch.float32, False),
            (1, 1500, 8, 2, 64, True, None, torch.float32, False),
            (1, 300, 4, 2, 128, True, 100, torch.float64, False),
            (1, 600, 4, 2, 256, True, None, torch.float64, False),
            (2, 1500, 8, 2, 32, True, None, torch.bfloat16, False),
            (2, 1500, 6, 6, 64, False, None, torch.bfloat16, False),
            (1, 2000, 8, 2, 128, True, 700, torch.bfloat16, True)):
        g = torch.Generator(device="cuda").manual_seed(t + hd)
        q = torch.randn(b, t, hq, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(b, t, hkv, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(b, t, hkv, hd, generator=g, device="cuda").to(dt)
        pos = torch.arange(t, device="cuda", dtype=torch.int32)
        if packed:  # sequences of 1,234 and 766 tokens in one row
            pos[1234:] -= 1234
        name = str(dt).split(".")[1]
        res = measure([((q, k, v, pos, pos),
                        {"causal": causal, "window": window})],
                      fk.flash_attention, flash_plain, flash_cost,
                      flash_compare, name, reps=3,
                      bound=bound_ms if dt == torch.bfloat16
                      else flash_mma_bound_ms)
        report(f"flash_attention ({fk.variant(dt)}) {name} [B={b}, T={t}, "
               f"Hq={hq}, Hkv={hkv}, hd={hd}] causal={causal} "
               f"window={window}{' packed' if packed else ''}", res,
               {"bound_ratio": 1.0})
        worst = max(worst, res["bound_ratio"])
    return worst


# -- phases 5 and 5b: wide N, and method="blocked" -----------------------------

def wide_tree(seed: int = 0):
    """A star of three relations whose data columns total N = 512: S1
    (keys e0, e1) joined to S2 on e0 and to S3 on e1, a few thousand rows
    (tests/helpers.py:random_acyclic_db's star3 shape with wide tables)."""
    import numpy as np
    from repro_torch.core.join_tree import JoinTree
    from repro_torch.core.relation import Database, full_reduce

    rng = np.random.default_rng(seed)
    rows = {"S1": 1200, "S2": 600, "S3": 600}
    keys = {"S1": ("e0", "e1"), "S2": ("e0",), "S3": ("e1",)}
    tables = {}
    for (name, m), nd in zip(rows.items(), WIDE_COLS):
        tables[name] = ({a: rng.integers(0, 24, size=m) for a in keys[name]},
                        rng.normal(size=(m, nd)),
                        [f"{name.lower()}y{j}" for j in range(nd)])
    edges = [("S1", "S2"), ("S1", "S3")]
    db = full_reduce(Database.from_arrays(tables), edges)
    return JoinTree.from_edges(db, "S1", edges)


class CountCalls:
    """Counts the calls of ``module.name`` while active."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counting(*args, **kwargs):
            self.calls += 1
            return self.real(*args, **kwargs)

        setattr(self.module, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def per_call_launches(label: str, fn) -> dict:
    """The launch counters over one call of ``fn``, and the calls of
    `_panel_to_wy` in it (0 on the card: T comes from the kernel)."""
    import torch
    from repro_torch.core import postprocess
    from repro_torch.kernels import _platform

    _platform.reset_launch_counts()
    with CountCalls(postprocess, "_panel_to_wy") as wy:
        fn()
        torch.cuda.synchronize()
    counts = _platform.launch_counts()
    log(f"launches per {label}: {counts}; _panel_to_wy calls {wy.calls}")
    check(wy.calls == 0, f"{label} forms T in the kernel, not _panel_to_wy")
    return counts


def phase_panels(label: str, plan, kind: str, compare_graph: bool = False,
                 **opts) -> dict:
    """A float64 ``qr`` whose panels take panel_qr's ``kind`` variant. First,
    eagerly (before the graph holds its memory): R of ``use_kernel=False``,
    and one kernel-path call with its panel_qr calls captured (held against
    the plain version and ``torch.geqrf``) and its launches counted (no
    `_panel_to_wy`). Then the dispatch as a user makes it: the first call
    (eager), the capture, timed replays (median of 3) with the
    counters zeroed around them, the first call's R against a replay's bit
    for bit and against ``use_kernel=False``, one profiled replay; with
    ``compare_graph``, eager against replay (`graph_vs_eager`)."""
    import torch
    from repro_torch import figaro
    from repro_torch.core import postprocess
    from repro_torch.core.postprocess import normalize_sign
    from repro_torch.kernels import _platform
    from repro_torch.kernels.panel_qr import kernel as pk
    from repro_torch.kernels.panel_qr import ops as pq_ops

    n = plan.spec.num_cols
    sess = figaro.Session(use_kernel=True, assembly="band", device="cuda",
                          **opts)
    plain = figaro.Session(use_kernel=False, device="cuda", **opts)
    r_p = eager_call(plain, plan, "qr", dtype=torch.float64)
    del plain
    torch.cuda.empty_cache()
    _platform.reset_launch_counts()
    with CountCalls(postprocess, "_panel_to_wy") as wy, \
            Capture([(pq_ops, "panel_qr_wy")]) as cap:
        eager_call(sess, plan, "qr", dtype=torch.float64)
        torch.cuda.synchronize()
    per_qr = _platform.launch_counts()
    log(f"launches per {label} qr: {per_qr}; _panel_to_wy calls {wy.calls}")
    check(wy.calls == 0, f"{label} forms T in the kernel, not _panel_to_wy")
    calls = cap.calls["panel_qr_wy"]
    mine = [(args, kw) for args, kw in calls
            if pk.variant(args[0].shape[-2]) == kind]
    del cap
    log(f"{label} qr: {len(calls)} panel_qr calls, {len(mine)} of them on "
        f"the {kind} variant")
    measured = measure_path_kernels(
        {"panel_qr_wy": mine}, "float64", names=("panel_qr",),
        label=f"{label} qr dispatch, {kind} variant")["panel_qr"]
    del calls, mine
    torch.cuda.empty_cache()

    _platform.reset_launch_counts()
    t0 = time.perf_counter()
    r_first = sess.qr(plan, dtype=torch.float64)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    r_k, t_qr, ts, _ = wall(lambda: sess.qr(plan, dtype=torch.float64),
                            REPS)
    launches = _platform.launch_counts()
    log(f"{label}: N = {n}, exact R0 rows {plan.spec.r0_rows}; float64 qr "
        f"(kernel path) replays median {t_qr * 1e3:.1f} ms of "
        f"{[round(x * 1e3, 2) for x in ts]} ms; first call (plan to the "
        f"card, eager) {t_first * 1e3:.1f} ms; launches "
        f"{launches} over {REPS + 2} calls; captures "
        f"{sess.engine.capture_count()}")
    check(launches.get(pk.kernel_name(kind), 0) > 0,
          f"{pk.kernel_name(kind)} launched on the {label} path")
    check(sess.engine.capture_count() == 1, f"{label}: one capture")
    check(torch.equal(r_first, r_k),
          f"{label}: a replay equals the first (eager) call bit for bit")
    err_abs, err_rel = rel_err(normalize_sign(r_k), normalize_sign(r_p))
    log(f"{label} R (kernel path) vs R (use_kernel=False), float64: max abs "
        f"err {err_abs:.3e}, relative {err_rel:.3e} (tol 1e-9)")
    check(r_k.shape == (n, n) and bool(torch.isfinite(r_k).all()),
          f"{label} qr shape/finite")
    check(err_rel <= 1e-9, f"{label} kernel-path R matches the unfused path")
    out = {"launches": launches, "per_qr": per_qr, "r_rel_err": err_rel,
           "qr_ms": t_qr * 1e3, "first_call_ms": t_first * 1e3,
           "panels": measured, "n": n}
    if compare_graph:
        out["graph"] = graph_vs_eager(f"{label} qr float64", sess, plan,
                                      torch.float64)
        out["profile"] = out["graph"]["replay"]
    else:
        out["profile"] = profile_once(
            f"{label} qr float64 (replay)",
            lambda: sess.qr(plan, dtype=torch.float64))
    out["memory"] = memory_log(label, sess.engine)
    return out


# -- phase 6: segmented tails --------------------------------------------------

def segment_layout(first):
    """(seg_id, pos_in_seg, K) of a segment-start vector."""
    import torch

    seg = torch.cumsum(first.long(), 0) - 1
    starts = torch.nonzero(first).squeeze(1)
    pos = torch.arange(first.numel(), device=first.device) - starts[seg]
    return seg, pos, int(seg[-1]) + 1


def segmented_tail_cost(data, *rows) -> tuple[int, int]:
    """(bytes, flops) of one segmented_tail call: data and wa read once,
    out written once, two [m] coefficients and the 1-byte flags; ~5 flops
    per element (scan add, difference, two products, a sum)."""
    m = data.shape[-2]
    item = data.element_size()
    return 3 * data.numel() * item + m * (2 * item + 1), 5 * data.numel()


def segmented_cumsum_cost(x, first) -> tuple[int, int]:
    """(bytes, flops) of one segmented_cumsum call: x read once, the 1-byte
    flags read once, the sums written once; one add per element."""
    item = x.element_size()
    return 2 * x.numel() * item + first.numel(), x.numel()


def phase_tails(passes) -> dict:
    """``segmented_head_tail(use_kernel=True)`` on the captured node passes
    (per dtype: [(data·data_scale, weights, first), ...])."""
    import torch
    from repro_torch.core.heads_tails import segmented_cumsum, \
        segmented_head_tail
    from repro_torch.kernels import _platform, _seg_scan
    from repro_torch.kernels.head_tail import kernel as hk, ops as ht_ops, \
        ref as hr

    layouts = {name: [segment_layout(first) for _, _, first in inputs]
               for name, inputs in passes.items()}
    _platform.reset_launch_counts()
    outs = {}
    with Capture([(ht_ops, "segmented_tail"),
                  (ht_ops, "segmented_cumsum")]) as cap:
        for name, inputs in passes.items():
            outs[name] = [segmented_head_tail(data, w, seg, pos, k,
                                              use_kernel=True)
                          for (data, w, _), (seg, pos, k)
                          in zip(inputs, layouts[name])]
        torch.cuda.synchronize()
    launches = _platform.launch_counts()
    log(f"segmented_head_tail(use_kernel=True) path: launches {launches}")
    for kname in ("segmented_tail", "segmented_cumsum"):
        check(launches.get(kname, 0) > 0, f"{kname} launched on its path")
    result = {"launches": launches}
    for name, inputs in passes.items():
        tol = TOL[("segmented_tail", name)]
        err_out = 0.0
        for (data, w, _), (seg, pos, k), got in zip(inputs, layouts[name],
                                                    outs[name]):
            want = segmented_head_tail(data, w, seg, pos, k)
            err_out = max(err_out, elementwise(None, got, want)["max_rel_err"])
            log(f"  {name} pass {list(data.shape)}: K = {k}")
        log(f"segmented_head_tail {name}: kernel path vs unfused relative "
            f"{err_out:.3e} (tol {tol:g})")
        check(err_out <= tol, f"segmented_head_tail {name} kernel path "
              "against the unfused path")
        calls = [(args, kw) for args, kw in cap.calls["segmented_tail"]
                 if str(args[0].dtype).split(".")[1] == name]
        result[name] = measure(calls, hk.segmented_tail,
                               hr.segmented_tail_ref, segmented_tail_cost,
                               elementwise, name)
        report(f"segmented_tail {name} over its path", result[name],
               {"max_rel_err": tol})
        calls = [(args, kw) for args, kw in cap.calls["segmented_cumsum"]
                 if str(args[0].dtype).split(".")[1] == name]
        result[f"cumsum_{name}"] = measure(
            calls, hk.segmented_cumsum, segmented_cumsum,
            segmented_cumsum_cost, elementwise, name)
        report(f"segmented_cumsum {name} over its path",
               result[f"cumsum_{name}"],
               {"max_rel_err": TOL[("segmented_cumsum", name)]})
    _seg_scan.check()
    return result


# -- phase 7: the LM eval forward ----------------------------------------------

def sdpa(q, k, v, q_pos, k_pos, causal=True, window=None):
    """``scaled_dot_product_attention`` on flash_attention's layout, for
    the LM path's two cases: causal self-attention whose window masks
    nothing, and attention without causality or window over keys that are
    all visible (an encoder's): the library yardstick."""
    import torch.nn.functional as F

    if causal:
        check((window is None or window >= q.shape[1])
              and q.shape[1] == k.shape[1],
              "sdpa times causal self-attention whose window masks nothing")
    else:
        check(window is None and bool((k_pos >= 0).all()),
              "sdpa times non-causal attention over visible keys")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True)


def phase_lm(seed: int) -> dict:
    import dataclasses

    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import _platform
    from repro_torch.kernels.flash_attn import kernel as fk, ops as fa_ops
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import make_eval_step

    check(SHAPES["train_4k"].seq_len == LM_SEQ, "train_4k's sequence length")
    cfg = dataclasses.replace(get_config("qwen3-8b"), use_flash_kernel=True)
    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Transformer(cfg, device="cuda").init(gen)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"qwen3-8b: {cfg.n_blocks} blocks, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params / 1e9:.3f} B parameters "
        f"({cfg.param_dtype}), compute {cfg.compute_dtype}; initialized on "
        f"the card in {time.perf_counter() - t0:.2f} s; batch "
        f"{LM_BATCH} x {LM_SEQ} tokens")
    batch = {"tokens": tokens}
    eval_fn = make_eval_step(cfg)
    _platform.reset_launch_counts()
    metrics, t_step, ts, warm = wall(lambda: eval_fn(model, batch), REPS)
    launches = _platform.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = float(metrics["loss"])
    tok_s = LM_BATCH * LM_SEQ / t_step
    log(f"eval step: median {t_step * 1e3:.1f} ms of "
        f"{[round(x * 1e3, 1) for x in ts]} ms (warm-up {warm * 1e3:.1f} ms); "
        f"{tok_s:.0f} tokens/s; loss {loss:.4f} (ce "
        f"{float(metrics['ce']):.4f}, zloss {float(metrics['zloss']):.3e}, "
        f"tokens {float(metrics['tokens']):.0f}); peak device memory "
        f"{peak:.2f} GiB; launches {launches} over {REPS + 1} steps")
    check(launches.get("flash_attention_sm90", 0) == (REPS + 1) * cfg.n_blocks
          and launches.get("flash_attention_mma", 0) == 0,
          "the bfloat16 flash kernel launched once per layer on the LM path")
    check(math.isfinite(loss), "LM loss finite")

    with torch.inference_mode():
        with Capture([(fa_ops, "flash_attention")]) as cap:
            logits_f, _, _ = model(batch, cfg)
            torch.cuda.synchronize()
        logits_p, _, _ = model(batch, plain_cfg)
        torch.cuda.synchronize()
        scale = float(logits_p.abs().max())
        err = float((logits_f - logits_p).abs().max())
    del logits_f, logits_p
    torch.cuda.empty_cache()
    log(f"logits (use_flash_kernel=True) vs (use_flash_kernel=False): max abs "
        f"err {err:.3e} of max |logits| {scale:.3e} (relative "
        f"{err / scale:.3e}, tol 2e-2)")
    check(err <= 2e-2 * scale,
          "logits with the flash kernel match the _attend path")
    calls = cap.calls["flash_attention"]
    del cap
    for args, kw in calls:
        qp = args[3]
        check(kw.get("causal", True) and kw.get("window") is None and bool(
            (qp == torch.arange(qp.numel(), device=qp.device)).all()),
            "the LM path's attention is plain causal self-attention")
    with torch.inference_mode():
        flash = measure(calls, fk.flash_attention, flash_plain, flash_cost,
                        flash_compare, "bfloat16", library=sdpa, reps=3)
    del calls
    report(f"flash_attention bfloat16 over one forward of [{LM_BATCH}, "
           f"{LM_SEQ}, {cfg.n_heads}, {cfg.resolved_head_dim}] (KV heads "
           f"{cfg.n_kv_heads})", flash, {"bound_ratio": 1.0},
           library="scaled_dot_product_attention")
    log(f"flash_attention bound: {flash['flops']:.3e} flops at 989 TFLOP/s, "
        f"{flash['bytes']:.3e} bytes at 3.35 TB/s")
    flash_rates(flash, "bfloat16")
    log(f"flash_attention_sm90 over one forward: {flash['ms']:.3f} ms, "
        f"{flash['tflops']:.1f} TFLOP/s (4·hd flops per visible pair), "
        f"{100 * flash['bound_share']:.1f}% of the bound, "
        f"{flash['vs_library']:.3f}x scaled_dot_product_attention "
        f"({flash['library_ms']:.3f} ms); eval step {tok_s:.0f} tokens/s, "
        f"peak device memory {peak:.2f} GiB")
    with torch.inference_mode():
        profile_once("qwen3-8b eval step (flash kernel)",
                     lambda: eval_fn(model, batch))
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB over the LM phase")
    torch.cuda.empty_cache()
    # The model goes on to phase 7c (serving), which frees it.
    return {"model": model, "launches": launches, "step_ms": t_step * 1e3,
            "tokens_per_s": tok_s, "loss": loss, "peak_gib": peak,
            "logits_rel_err": err / scale, "flash": flash,
            "launches_per_forward":
                launches.get("flash_attention_sm90", 0) // (REPS + 1)}


def flash_rates(res: dict, dtype: str) -> None:
    """Add to a flash `measure` result its TFLOP/s (4·hd flops per visible
    pair), its share of the bound, its ratio to the library call and, for
    the float32/float64 kernel, the bound at the CUDA-core peaks
    (``old_bound_ms``)."""
    res["tflops"] = res["flops"] / res["ms"] / 1e9
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["vs_library"] = res["ms"] / res["library_ms"]
    if dtype in FLASH_MMA_PEAK:
        res["old_bound_ms"] = bound_ms(res["bytes"], res["flops"], dtype)[0]


def phase_lm32(seed: int) -> dict:
    """The float32 eval path, which takes the float32/float64 flash kernel:
    qwen3-8b at full width cut to `LM32_BLOCKS` blocks,
    ``compute_dtype="float32"``, one eval step on 2 × 4096 tokens with the
    counters zeroed around it; then its flash calls, captured, against the
    plain version and SDPA, and the same calls cast to float64."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _platform
    from repro_torch.kernels.flash_attn import kernel as fk, ops as fa_ops
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import make_eval_step

    cfg = dataclasses.replace(get_config("qwen3-8b"), use_flash_kernel=True,
                              compute_dtype="float32", n_blocks=LM32_BLOCKS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Transformer(cfg, device="cuda").init(gen)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                           device="cuda")
    eval_fn = make_eval_step(cfg)
    _platform.reset_launch_counts()
    with Capture([(fa_ops, "flash_attention")]) as cap:
        t0 = time.perf_counter()
        metrics = eval_fn(model, {"tokens": tokens})
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
    launches = _platform.launch_counts()
    loss = float(metrics["loss"])
    log(f"float32 eval step, {cfg.n_blocks} blocks of qwen3-8b, "
        f"{LM_BATCH} x {LM_SEQ} tokens: {t_step * 1e3:.1f} ms (first call), "
        f"loss {loss:.4f}; launches {launches}")
    check(launches.get("flash_attention_mma", 0) == cfg.n_blocks
          and launches.get("flash_attention_sm90", 0) == 0,
          "the mma flash kernel launched once per layer on the float32 path")
    check(math.isfinite(loss), "float32 LM loss finite")
    del model, metrics
    torch.cuda.empty_cache()
    calls = cap.calls["flash_attention"]
    del cap
    shape = (f"[{LM_BATCH}, {LM_SEQ}, {cfg.n_heads}, "
             f"{cfg.resolved_head_dim}] (KV heads {cfg.n_kv_heads})")
    out = {"launches": launches, "step_ms": t_step * 1e3, "loss": loss}
    for dtype in ("float32", "float64"):
        if dtype == "float64":
            calls = [((*(x.double() for x in args[:3]), *args[3:]), kw)
                     for args, kw in calls]
        with torch.inference_mode():
            flash = measure(calls, fk.flash_attention, flash_plain,
                            flash_cost, flash_compare, dtype, library=sdpa,
                            reps=3, bound=flash_mma_bound_ms)
        torch.cuda.empty_cache()
        report(f"flash_attention_mma {dtype} over one {cfg.n_blocks}-block "
               f"forward of {shape}", flash, {"bound_ratio": 1.0},
               library="scaled_dot_product_attention")
        flash_rates(flash, dtype)
        log(f"flash_attention_mma {dtype}: {flash['ms']:.3f} ms, "
            f"{flash['tflops']:.1f} TFLOP/s (4·hd flops per visible pair), "
            f"{100 * flash['bound_share']:.1f}% of the tensor-core bound "
            f"{flash['bound_ms']:.3f} ms (CUDA-core bound "
            f"{flash['old_bound_ms']:.3f} ms), "
            f"{flash['vs_library']:.3f}x scaled_dot_product_attention "
            f"({flash['library_ms']:.3f} ms)")
        out[dtype] = flash
    del calls
    torch.cuda.empty_cache()
    return out


# -- phase 7c: LM serving ---------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 8, 2048, 64  # decode_32k, cut
SERVE_ROWS = 2  # sequences the teacher-forced decode is held to the forward on
SERVE_FORCED = 16  # teacher-forced decode steps
SERVE_TIMED = 56  # timed replays (the cache holds SERVE_STEPS + 1 positions)
SERVE_WINDOW = 512  # the float32 cut's sliding window (a ring of 512 slots)


def cache_leaves(cache) -> list:
    """The cache's tensors: the top-level position, then each sub-layer's
    leaves of every kind (``attn``'s ``k``, ``v`` and ``pos``; ``mamba``,
    ``rwkv`` and ``cmix`` states)."""
    return [cache["pos"]] + [leaf for sub in cache["blocks"].values()
                             for leaves in sub.values()
                             for leaf in leaves.values()]


def clone_cache(cache) -> dict:
    return {"pos": cache["pos"].clone(), "blocks": {
        j: {kind: {n: leaf.clone() for n, leaf in leaves.items()}
            for kind, leaves in sub.items()}
        for j, sub in cache["blocks"].items()}}


def caches_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(cache_leaves(a),
                                                  cache_leaves(b),
                                                  strict=True))


def pool_gib(pool):
    """GiB the caching allocator holds in the graph memory ``pool``, or
    None where the snapshot does not name pools."""
    import torch

    segments = torch.cuda.memory_snapshot()
    if not all("segment_pool_id" in s for s in segments):
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) == tuple(pool)) / 2**30


def decode_cost(model, cfg, cache) -> dict:
    """The least work of one decode step over ``cache``: every block and
    head parameter read once (the embedding only at the batch's rows),
    the whole cache read, the logits written; the products of the blocks
    (bfloat16, tensor cores), of attention over every slot, and of the
    float32 head (CUDA cores). ``written_bytes`` adds what the step moves
    as the port writes it: each block weight cast to bfloat16 on every
    call (written, then read)."""
    k = cache["blocks"]["pos0"]["attn"]["k"]
    b, slots = k.shape[1], k.shape[2]
    params = dict(model.named_parameters())
    block = sum(p.numel() for n, p in params.items() if n.startswith("blocks."))
    weights = sum(p.numel() * p.element_size() for n, p in params.items()
                  if n != "embed" or cfg.tie_embeddings)
    head = cfg.d_model * cfg.padded_vocab
    nbytes = (weights + b * cfg.d_model * params["embed"].element_size()
              + sum(t.numel() * t.element_size() for t in cache_leaves(cache))
              + b * cfg.padded_vocab * 4)
    attn = 4 * b * cfg.n_heads * cfg.resolved_head_dim * slots * cfg.n_blocks
    ops_ms = ((2 * b * block + attn) / PEAK_FLOPS["bfloat16"]
              + 2 * b * head / PEAK_FLOPS["float32"]) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bytes": nbytes, "written_bytes": nbytes + 4 * block,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "written_ms": (nbytes + 4 * block) / HBM_BYTES_PER_S * 1e3}


def decode_vs_forward(label: str, model, cfg, tokens, prompt: int,
                      rows: int, rel: float, floor: float,
                      moe: bool = False, extra=None) -> dict:
    """Prefill ``tokens[:, :prompt]`` and decode the rest teacher-forced
    (`make_prefill`, `make_decode_step`; ``max_len`` one past the tokens
    and a patch config's patches), each step's logits on the first
    ``rows`` sequences against ``Transformer.forward`` of those sequences
    with ``use_flash_kernel=False``: the largest |difference| at most
    ``rel`` × max(max |logits|, ``floor``). ``extra`` holds the sequences'
    ``frames`` or ``patches``, given to the forward and the prefill. With ``moe``, the share of assignments each MoE layer of
    the forward and of the prefill dropped is recorded, and the bound is
    held only where both are 0 everywhere: each call routes its own tokens
    under a capacity worked out for them (a decode step's B tokens never
    fill it), so a forward or a prefill that dropped computes another
    function than the decode steps, as in JAX."""
    import dataclasses

    import torch
    from repro_torch.train.serve import make_decode_step, make_prefill

    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    total = tokens.shape[1]
    extra = extra or {}
    with torch.inference_mode(), MoEDrops(model, plain) as drops:
        full, _, off = model({"tokens": tokens[:rows], **{
            k: v[:rows] for k, v in extra.items()}}, plain)
    with MoEDrops(model, plain) as pre_drops:
        logits, cache = make_prefill(plain, off + total + 1)(
            model, {"tokens": tokens[:, :prompt], **extra})
    shares = {"forward": drops.shares(), "prefill": pre_drops.shares()}
    slots = next((sub["attn"]["k"].shape[2] for sub in
                  cache["blocks"].values() if "attn" in sub), None)
    errs = [float((logits[:rows] - full[:, off + prompt - 1]).abs().max())]
    decode = make_decode_step(plain)
    for j in range(prompt, total):
        logits, cache = decode(model, cache, tokens[:, j:j + 1])
        errs.append(float((logits[:rows] - full[:, off + j]).abs().max()))
    # The vocab's padding rows hold float32's lowest value in both.
    scale = float(full[..., :cfg.vocab].abs().max())
    limit = rel * max(scale, floor)
    finite = bool(torch.isfinite(logits).all())
    del full, logits, cache
    torch.cuda.empty_cache()
    log(f"{label}: prefill of {prompt} tokens and {total - prompt} "
        f"teacher-forced decode steps ({slots} cache slots) against the "
        f"forward on {rows} of {tokens.shape[0]} sequences: max abs err "
        f"{max(errs):.3e} (prefill {errs[0]:.3e}) of max |logits| "
        f"{scale:.3e}, limit {limit:.3e} ({rel:g} x max(max |logits|, "
        f"{floor:g}))")
    held = not any(v for part in shares.values() for v in part.values())
    if moe:
        log(f"{label}: share of assignments dropped per MoE layer {shares}; "
            "the bound is " + ("held" if held else "not held (the forward "
                               "or the prefill dropped)"))
    check(finite, f"{label}: decode logits finite")
    check(not held or max(errs) <= limit,
          f"{label}: decode matches the forward")
    return {"max_abs_err": max(errs), "prefill_err": errs[0],
            "scale": scale, "limit": limit, "slots": slots,
            "drop_shares": shares, "held": held}


def phase_lm_serve(model, cfg, seed: int) -> dict:
    """qwen3-8b serving at full width on phase 7's model: prefill of
    ``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` tokens (median of 3 after a
    warm-up); greedy `sample_loop` for ``SERVE_STEPS`` steps (its first
    decode step eager, the rest replayed from one captured graph) with the
    counters zeroed around it; the same loop run eagerly step by step (the
    same tokens); one replay against one eager step from the same cache and
    tokens, bit for bit; ``SERVE_TIMED`` replays timed; one profiled replay
    and one profiled eager step; the teacher-forced decode against the
    forward; the peak reserved memory under 80 GB."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import _platform
    from repro_torch.train.serve import (DecodeGraph, make_decode_step,
                                         make_prefill, sample_loop)

    shape = SHAPES["decode_32k"]
    check(shape.kind == "decode" and shape.global_batch >= SERVE_BATCH
          and shape.seq_len >= SERVE_PROMPT + SERVE_STEPS,
          "the serving cell is a cut of decode_32k")
    torch.cuda.reset_peak_memory_stats()
    max_len = SERVE_PROMPT + SERVE_STEPS + 1
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH,
                                          SERVE_PROMPT + SERVE_FORCED),
                           generator=gen, device="cuda")
    prompt = {"tokens": tokens[:, :SERVE_PROMPT]}
    prefill = make_prefill(cfg, max_len)
    decode = make_decode_step(cfg)

    def greedy(logits):
        return logits.argmax(-1)[:, None].to(torch.int32)

    (logits, cache), t_pre, ts_pre, warm_pre = wall(
        lambda: prefill(model, prompt), REPS)
    check(logits.shape == (SERVE_BATCH, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits finite")
    cost = decode_cost(model, cfg, cache)
    del logits, cache
    log(f"prefill of {SERVE_BATCH} x {SERVE_PROMPT} tokens into a "
        f"{max_len}-slot cache: median {t_pre * 1e3:.1f} ms of "
        f"{[round(x * 1e3, 1) for x in ts_pre]} ms (warm-up "
        f"{warm_pre * 1e3:.1f} ms); "
        f"{SERVE_BATCH * SERVE_PROMPT / t_pre:.0f} prompt tokens/s")
    log(f"decode step bound: {cost['bytes'] / 1e9:.3f} GB (block and head "
        f"parameters read once, the cache read, the logits written) -> "
        f"{cost['bound_ms']:.3f} ms ({cost['bound_by']}); as the port "
        f"writes it (weights cast to bfloat16 every call) "
        f"{cost['written_bytes'] / 1e9:.3f} GB -> {cost['written_ms']:.3f}"
        " ms")

    # The main path: the user's entry point.
    _platform.reset_launch_counts()
    t0 = time.perf_counter()
    toks_r = sample_loop(model, cfg, prompt, steps=SERVE_STEPS,
                         max_len=max_len)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    launches = _platform.launch_counts()
    log(f"sample_loop (greedy, {SERVE_STEPS} steps; prefill, one eager "
        f"step, then replays): {t_loop * 1e3:.1f} ms; launch counts "
        f"{launches} (the cache branch reaches no port kernel)")
    check(toks_r.shape == (SERVE_BATCH, SERVE_STEPS)
          and int(toks_r.min()) >= 0 and int(toks_r.max()) < cfg.vocab,
          "sampled tokens in the vocabulary")

    # The same loop, eager step by step.
    logits, cache = prefill(model, prompt)
    tok = greedy(logits)
    toks_e, eager_ms = [], []
    for _ in range(SERVE_STEPS):
        toks_e.append(tok)
        t0 = time.perf_counter()
        logits, cache = decode(model, cache, tok)
        tok = greedy(logits)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    same_tokens = torch.equal(torch.cat(toks_e, dim=1), toks_r)
    del logits, cache, toks_e
    log(f"eager decode: median {statistics.median(eager_ms):.2f} ms a step "
        f"(min {min(eager_ms):.2f}, max {max(eager_ms):.2f}); greedy tokens "
        f"equal to sample_loop's: {same_tokens}")
    check(same_tokens, "greedy sample_loop gives the eager loop's tokens")

    # One replay against one eager step from the same cache and tokens.
    logits, cache = prefill(model, prompt)
    logits, cache = decode(model, cache, greedy(logits))  # warm-up
    tok = greedy(logits)
    snap = clone_cache(cache)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # as the capture does first
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    graph = DecodeGraph(model, cfg, cache, tok)
    t_capture = time.perf_counter() - t0
    pool = pool_gib(graph.graph.pool())
    grown = (torch.cuda.memory_reserved() - reserved0) / 2**30
    check(caches_equal(cache, snap), "capturing the decode step ran nothing")
    replayed = graph(tok).clone()
    eager, snap = decode(model, snap, tok)
    bit_equal = torch.equal(replayed, eager) and caches_equal(cache, snap)
    log(f"decode capture: {t_capture * 1e3:.1f} ms; graph pool "
        f"{'not named' if pool is None else f'{pool:.3f} GiB'}, reserved "
        f"grew {grown:.3f} GiB; launches recorded {graph.launches}; replay "
        f"vs eager step from the same cache and tokens: logits and every "
        f"cache leaf bit-equal: {bit_equal}")
    check(bit_equal, "a replayed decode step equals the eager step")
    del snap, eager
    tok = greedy(replayed)
    replay_ms = []
    for _ in range(SERVE_TIMED):
        t0 = time.perf_counter()
        tok = greedy(graph(tok))
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
    t_replay = statistics.median(replay_ms)
    t_eager = statistics.median(eager_ms)
    log(f"replayed decode: median {t_replay:.2f} ms a step (min "
        f"{min(replay_ms):.2f}, max {max(replay_ms):.2f}) over "
        f"{SERVE_TIMED} steps; {SERVE_BATCH * 1e3 / t_replay:.1f} tokens/s "
        f"(eager {SERVE_BATCH * 1e3 / t_eager:.1f}); "
        f"{cost['bound_ms'] / t_replay:.3f} of the bound")
    prof_replay = profile_once("qwen3-8b decode step (replay)",
                               lambda: graph(tok))
    prof_eager = profile_once("qwen3-8b decode step (eager)",
                              lambda: decode(model, cache, tok))
    graph.close()
    del graph, cache, replayed
    torch.cuda.empty_cache()

    forced = decode_vs_forward("qwen3-8b bfloat16", model, cfg, tokens,
                               SERVE_PROMPT, SERVE_ROWS, 2e-2, 0.0)
    peak = torch.cuda.max_memory_reserved() / 2**30
    log(f"phase 7c: peak reserved {peak:.2f} GiB, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(peak * 2**30 < 80e9, "phase 7c stays under 80 GB reserved")
    return {"prefill_ms": t_pre * 1e3, "prefill_ms_all": ts_pre,
            "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / t_pre,
            "sample_loop_ms": t_loop * 1e3, "launches": launches,
            "eager_step_ms": t_eager, "replay_step_ms": t_replay,
            "eager_step_ms_all": eager_ms, "replay_step_ms_all": replay_ms,
            "decode_tokens_per_s": SERVE_BATCH * 1e3 / t_replay,
            "eager_tokens_per_s": SERVE_BATCH * 1e3 / t_eager,
            "bound_ms": cost["bound_ms"], "bound_by": cost["bound_by"],
            "bound_bytes": cost["bytes"],
            "written_bytes": cost["written_bytes"],
            "written_ms": cost["written_ms"], "capture_ms": t_capture * 1e3,
            "graph_pool_gib": pool, "capture_reserved_gib": grown,
            "profile_replay": prof_replay, "profile_eager": prof_eager,
            "replay_bit_equal": bit_equal, "forced": forced,
            "peak_reserved_gib": peak}


def phase_lm_serve32(seed: int) -> dict:
    """The float32 cut: qwen3-8b at full width cut to `LM32_BLOCKS` blocks,
    ``compute_dtype="float32"``, ``SERVE_ROWS`` prompts of ``SERVE_PROMPT``
    tokens decoded teacher-forced against the forward at the JAX package's
    bound, with a linear cache and with ``swa_window=SERVE_WINDOW`` (prefill
    keeps the last 512 rows of the ring, decode wraps it)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_blocks=LM32_BLOCKS,
                              compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    model = Transformer(cfg, device="cuda").init(gen)
    tokens = torch.randint(0, cfg.vocab, (SERVE_ROWS,
                                          SERVE_PROMPT + SERVE_FORCED),
                           generator=gen, device="cuda")
    out = {"linear": decode_vs_forward(
        f"qwen3-8b float32, {LM32_BLOCKS} blocks", model, cfg, tokens,
        SERVE_PROMPT, SERVE_ROWS, 2e-3, 1.0)}
    window = dataclasses.replace(cfg, swa_window=SERVE_WINDOW)
    out["window"] = decode_vs_forward(
        f"qwen3-8b float32, {LM32_BLOCKS} blocks, swa_window "
        f"{SERVE_WINDOW}", model, window, tokens, SERVE_PROMPT, SERVE_ROWS,
        2e-3, 1.0)
    check(out["window"]["slots"] == SERVE_WINDOW,
          "the windowed cache is a ring of swa_window slots")
    del model
    torch.cuda.empty_cache()
    return out


# -- phase 11: LM training ------------------------------------------------------

TRAIN_BLOCKS = 4  # 11a: qwen3-8b cut to 4 of its 36 blocks (36 need ~131 GB)
TRAIN_TIMED = 6  # 11a: timed steps after one warm-up
CONSIST_BLOCKS, CONSIST_BATCH, CONSIST_SEQ = 2, 4, 512  # 11b
VS_CPU_STEPS, VS_CPU_BATCH, VS_CPU_SEQ = 3, 4, 32  # 11c (qwen3 smoke)


def train_flops(cfg, batch: int, seq: int) -> dict:
    """Floating-point operations of one train step as the port runs it (2
    per multiply-add): the blocks' GEMMs and attention in the compute dtype
    (forward, the forward again under remat, backward twice the forward;
    attention as `_attend` computes it, every key block, masked), and the
    LM head (``x.float() @ head.float()``) in float32. ``model`` is the
    usual 6 × tokens × matmul parameters plus causal attention, without
    remat: the work a step must do."""
    t = batch * seq
    d, hd = cfg.d_model, cfg.resolved_head_dim
    proj = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    mlp = 3 * d * cfg.d_ff
    keys = seq if seq <= cfg.attn_block_kv else \
        -(-seq // cfg.attn_block_kv) * cfg.attn_block_kv
    attn = 4 * batch * cfg.n_heads * seq * keys * hd
    block_fwd = cfg.n_blocks * (2 * t * (proj + mlp) + attn)
    head_fwd = 2 * t * d * cfg.padded_vocab
    causal = cfg.n_blocks * 2 * batch * cfg.n_heads * seq * (seq + 1) * hd
    return {"compute": (4 if cfg.remat else 3) * block_fwd,
            "float32": 3 * head_fwd,
            "model": 3 * (cfg.n_blocks * 2 * t * (proj + mlp) + head_fwd
                          + causal)}


def phase_train(seed: int) -> dict:
    """11a: qwen3-8b at its published width cut to `TRAIN_BLOCKS` blocks,
    float32 parameters and AdamW moments, bfloat16 compute, ``remat=True``,
    ``warmup_cosine``, `TokenPipeline` batches of 2 × 4096 tokens,
    `init_state` on the card from a seeded generator: one warm-up step, then
    `TRAIN_TIMED` steps timed by CUDA events (and the host clock), loss and
    grad_norm at each; peak reserved memory; one profiled step; one step
    split into its forward and backward and its AdamW update (CUDA
    events); the step's FLOPs against the dense bf16 peak."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _platform
    from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
    from repro_torch.train import init_state, make_train_step

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_blocks=TRAIN_BLOCKS,
                              remat=True)
    check(cfg.compute_dtype == "bfloat16" and cfg.param_dtype == "float32"
          and not cfg.use_flash_kernel, "11a's configuration")
    opt = AdamWConfig(lr=warmup_cosine(3e-4, 2, TRAIN_TIMED + 4))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(torch.Generator(device="cuda").manual_seed(seed), cfg,
                       opt)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.model.parameters())
    state_gb = 4 * n_params * 4 / 1e9  # parameters, gradients, mu, nu
    log(f"qwen3-8b train: {cfg.n_blocks} blocks of width d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, hd "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{n_params / 1e9:.4f} B parameters ({cfg.param_dtype}, moments "
        f"{opt.state_dtype}; parameters, gradients and moments "
        f"{state_gb:.2f} GB), compute {cfg.compute_dtype}, remat "
        f"{cfg.remat}; init_state on the card in {t_init:.2f} s")
    pipe = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, seed=seed)
    t0 = time.perf_counter()
    batches = [pipe.batch_at(s) for s in range(TRAIN_TIMED + 2)]
    log(f"TokenPipeline: {len(batches)} batches of {LM_BATCH} x {LM_SEQ} "
        f"in {time.perf_counter() - t0:.2f} s (host)")
    step = make_train_step(cfg, opt)
    _platform.reset_launch_counts()
    t0 = time.perf_counter()
    _, m = step(state, batches[0])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rows = []
    for s in range(1, TRAIN_TIMED + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        _, m = step(state, batches[s])
        end.record()
        torch.cuda.synchronize()
        rows.append({"step": s + 1, "ms": start.elapsed_time(end),
                     "wall_ms": (time.perf_counter() - t0) * 1e3,
                     **{k: float(m[k]) for k in ("loss", "ce", "grad_norm",
                                                 "lr")}})
        log(f"  step {s + 1}: {rows[-1]['ms']:.1f} ms (CUDA events; wall "
            f"{rows[-1]['wall_ms']:.1f}), loss {rows[-1]['loss']:.4f}, "
            f"grad_norm {rows[-1]['grad_norm']:.4f}, lr {rows[-1]['lr']:.3e}")
    launches = _platform.launch_counts()
    check(all(math.isfinite(r[k]) for r in rows for k in ("loss", "grad_norm")),
          "train loss and grad_norm finite at every step")
    step_ms = statistics.median(r["ms"] for r in rows)
    tok_s = LM_BATCH * LM_SEQ / (step_ms / 1e3)
    peak_res = torch.cuda.max_memory_reserved()
    peak_alloc = torch.cuda.max_memory_allocated()
    log(f"train step: median {step_ms:.1f} ms of "
        f"{[round(r['ms'], 1) for r in rows]} (warm-up {warm * 1e3:.1f} ms "
        f"wall); {tok_s:.0f} tokens/s; peak reserved {peak_res / 1e9:.2f} GB "
        f"({peak_res / 2**30:.2f} GiB), allocated {peak_alloc / 1e9:.2f} GB; "
        f"launch counts {launches} (the train step takes _attend: no port "
        f"kernel expected; logged, not checked)")
    check(peak_res < 80e9, "11a peak reserved memory under 80 GB")
    flops = train_flops(cfg, LM_BATCH, LM_SEQ)
    bound = (flops["compute"] / PEAK_FLOPS["bfloat16"]
             + flops["float32"] / PEAK_FLOPS["float32"]) * 1e3
    total = flops["compute"] + flops["float32"]
    share = total / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    log(f"step FLOPs as run: {flops['compute']:.3e} in bfloat16 (blocks, "
        f"remat) + {flops['float32']:.3e} in float32 (LM head) = "
        f"{total:.3e}; {total / (step_ms / 1e3) / 1e12:.1f} TFLOP/s, "
        f"{100 * share:.2f}% of the dense bf16 peak; bound "
        f"{bound:.1f} ms (bf16 at 989, float32 at 67 TFLOP/s), the head's "
        f"{flops['float32'] / PEAK_FLOPS['float32'] * 1e3:.1f} ms of it; "
        f"model FLOPs (6·N·tokens + causal attention) {flops['model']:.3e}, "
        f"{100 * flops['model'] / (step_ms / 1e3) / PEAK_FLOPS['bfloat16']:.2f}"
        f"% of the bf16 peak")
    prof = profile_once("qwen3-8b train step (4 blocks, remat)",
                        lambda: step(state, batches[TRAIN_TIMED + 1]))
    # One more step split where make_train_step's parts meet: the forward
    # and backward (autograd), then the AdamW update.
    tokens = torch.as_tensor(batches[TRAIN_TIMED + 1]["tokens"]).cuda()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    loss, _ = state.model.loss_fn({"tokens": tokens}, cfg)
    loss.backward()
    events[1].record()
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    adamw_update(grads, state.opt_state, state.model, opt)
    events[2].record()
    torch.cuda.synchronize()
    split = {"forward_backward_ms": events[0].elapsed_time(events[1]),
             "adamw_ms": events[1].elapsed_time(events[2])}
    del grads, loss
    state.model.zero_grad(set_to_none=True)
    log(f"one step split: forward and backward "
        f"{split['forward_backward_ms']:.1f} ms, AdamW update "
        f"{split['adamw_ms']:.1f} ms (CUDA events)")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"blocks": cfg.n_blocks, "params": n_params,
            "state_gb": state_gb, "steps": rows, "step_ms": step_ms,
            "warmup_wall_ms": warm * 1e3, "tokens_per_s": tok_s,
            "peak_reserved_gb": peak_res / 1e9,
            "peak_allocated_gb": peak_alloc / 1e9, "launches": launches,
            "flops": flops, "bound_ms": bound, "bf16_peak_share": share,
            "profile": prof, "split": split}


def hold_first_step(label, got, ref, lr, opt, tau) -> dict:
    """Two runs' parameters and first moments after one AdamW step from the
    same weights and zero moments, ``got`` against ``ref`` (dicts of
    tensors, ``ref``'s on the host): rtol 2e-4 and atol 2e-6 (the JAX package's bound between two
    float32 paths of one step), plus the gradient's own tolerance carried
    through the update. The runs' gradients agree to ``tau`` of each
    tensor's largest, δg; the first step moves an element by lr·g/(|g| +
    eps), flat in a large g and a whole step either way near 0, so an
    element with |g| ≤ δg may differ by 2·lr, the rest by
    lr·eps·δg/(|g| − δg + eps)². g is the clipped gradient, ``ref``'s
    mu / (1 − b1); mu is held by (1 − b1)·δg."""
    import torch

    b1, eps = opt.b1, opt.eps
    out = {"unresolved": 0, "zero_grad": 0, "unresolved_moved": 0,
           "max_abs_err": 0.0, "elements": 0}
    for name, want in ref["params"].items():
        want = want.to(got["params"][name].device)
        ref_mu = ref["mu"][name].to(want.device)
        g = ref_mu.float() / (1 - b1)
        dg = tau * float(g.abs().max())
        unresolved = g.abs() <= dg
        slack = torch.where(
            unresolved, torch.full_like(g, 2 * lr),
            lr * eps * dg / (g.abs() - dg + eps) ** 2)
        err = (got["params"][name].float() - want.float()).abs()
        base = 2e-6 + 2e-4 * want.float().abs()
        bad = int((err > base + slack).sum())
        check(bad == 0, f"{label}: {name}: {bad} parameters beyond the bound")
        mu_err = (got["mu"][name].float() - ref_mu.float()).abs()
        mu_bad = int((mu_err > 2e-6 + 2e-4 * ref_mu.float().abs()
                      + (1 - b1) * dg).sum())
        check(mu_bad == 0, f"{label}: {name}: {mu_bad} first moments beyond "
              "the bound")
        zero = int((g == 0).sum())
        out["zero_grad"] += zero
        out["unresolved"] += int(unresolved.sum()) - zero
        out["unresolved_moved"] += int((unresolved & (err > base)).sum())
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        out["elements"] += want.numel()
        del g, slack, err, base, mu_err, unresolved, want, ref_mu
    log(f"{label}: parameters and moments within rtol 2e-4, atol 2e-6 "
        f"(+ the gradient's {tau:g} carried through Adam) over "
        f"{out['elements']} elements; max |diff| {out['max_abs_err']:.3e}; "
        f"{out['zero_grad']} with a zero gradient (embedding rows of tokens "
        f"not in the batch), {out['unresolved']} with 0 < |g| ≤ δg, "
        f"{out['unresolved_moved']} beyond the plain bound")
    return out


def phase_train_consistency(seed: int) -> dict:
    """11b: the step's own consistency at full width, cut to
    `CONSIST_BLOCKS` blocks, float32 compute, `CONSIST_BATCH` ×
    `CONSIST_SEQ` tokens, every run from one initial state snapshotted on
    the host: ``microbatch=2`` against none, and ``remat`` off against on
    (loss and grad_norm within 1e-6 relative), each on the updated
    parameters (`hold_first_step`)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import init_state, make_train_step

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_blocks=CONSIST_BLOCKS,
                              compute_dtype="float32", remat=True)
    opt = AdamWConfig(lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(torch.Generator(device="cuda").manual_seed(seed + 3),
                       cfg, opt)
    t0 = time.perf_counter()
    snap = {n: p.detach().to("cpu", copy=True)
            for n, p in state.model.named_parameters()}
    log(f"11b: initial state ({sum(t.numel() for t in snap.values()) / 1e9:.3f}"
        f" B parameters) snapshotted on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (CONSIST_BATCH, CONSIST_SEQ))

    def run(microbatch, remat):
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(snap[n])
        state.opt_state = adamw_init(state.model, opt)
        state.step.zero_()
        c = dataclasses.replace(cfg, remat=remat)
        t0 = time.perf_counter()
        _, m = make_train_step(c, opt, microbatch=microbatch)(
            state, {"tokens": tokens})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        metrics = {k: float(v) for k, v in m.items()}
        log(f"11b run microbatch={microbatch}, remat={remat}: {ms:.1f} ms "
            f"(first call), loss {metrics['loss']:.6f}, grad_norm "
            f"{metrics['grad_norm']:.6f}")
        return metrics, {
            "params": {n: p.detach().clone()
                       for n, p in state.model.named_parameters()},
            "mu": {n: t.clone() for n, t in state.opt_state["mu"].items()}}

    def to_host(run_out):
        return {part: {n: t.to("cpu") for n, t in tensors.items()}
                for part, tensors in run_out.items()}

    m_ref, ref = run(None, True)
    ref = to_host(ref)  # the reference waits on the host: 13 GB less here
    out = {}
    m_mb, got = run(2, True)
    rel = abs(m_mb["loss"] - m_ref["loss"]) / abs(m_ref["loss"])
    log(f"11b microbatch=2 against none: loss relative {rel:.3e}, grad_norm "
        f"relative {abs(m_mb['grad_norm'] - m_ref['grad_norm']) / m_ref['grad_norm']:.3e}")
    check(rel <= 1e-5, "11b microbatched loss (mean of the micro-steps)")
    out["microbatch"] = hold_first_step("11b microbatch=2 vs none", got, ref,
                                        1e-3, opt, 1e-5)
    out["microbatch"]["loss_rel"] = rel
    del got
    m_nr, got = run(None, False)
    rels = {k: abs(m_nr[k] - m_ref[k]) / abs(m_ref[k])
            for k in ("loss", "grad_norm")}
    log(f"11b remat off against on: loss relative {rels['loss']:.3e}, "
        f"grad_norm relative {rels['grad_norm']:.3e} (tol 1e-6)")
    check(max(rels.values()) <= 1e-6, "11b remat on and off: loss and "
          "grad_norm within 1e-6")
    out["remat"] = hold_first_step("11b remat off vs on", got, ref, 1e-3,
                                   opt, 1e-5)
    out["remat"].update({f"{k}_rel": v for k, v in rels.items()})
    out["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    log(f"11b peak reserved {out['peak_reserved_gb']:.2f} GB")
    del got, ref, state, snap
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _stacked(model, opt_state) -> dict:
    """A port state as JAX's stacked trees, flat (``_adam_hold.flat``)."""
    from _adam_hold import flat
    from repro_torch.models.weights import opt_state_to_numpy, params_to_numpy

    mom = opt_state_to_numpy(opt_state, model)
    return {"params": flat(params_to_numpy(model)), "mu": flat(mom["mu"]),
            "nu": flat(mom["nu"])}


def phase_train_vs_cpu(seed: int) -> dict:
    """11c: qwen3's smoke configuration in float32 compute, the same weights
    (drawn with numpy from ``--seed``) on the card and on the CPU,
    `VS_CPU_STEPS` steps of `make_train_step` with the orthogonal update
    off and on. Each step starts on the card from the CPU's state of the
    step before; the metrics are held within 1e-5 relative and the
    parameters and moments at rtol 2e-4, atol 2e-6 plus the gradient's
    tolerance carried through Adam (``tests/_adam_hold.py``: the gradients
    agree to 1e-6 of each leaf's largest, the orthogonalized ones to
    4e-5)."""
    import dataclasses

    import numpy as np
    import torch
    from _adam_hold import hold_adam_step
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
    from repro_torch.train import TrainState, make_train_step

    cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True),
                              compute_dtype="float32")
    opt = AdamWConfig(lr=warmup_cosine(3e-3, 2, 10))
    rng = np.random.default_rng(seed)
    cpu = Transformer(cfg, device="cpu")
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if p.ndim == 1:
                w = 1.0 + 0.1 * rng.standard_normal(p.shape)
            else:
                w = rng.standard_normal(p.shape) * (
                    0.02 if name == "embed" else p.shape[0] ** -0.5)
            p.copy_(torch.from_numpy(w.astype(np.float32)))
    out = {}
    for orthogonal in (False, True):
        model_c = Transformer(cfg, device="cpu")
        model_c.load_state_dict(cpu.state_dict())
        st_c = TrainState(model_c, adamw_init(model_c, opt),
                          torch.zeros((), dtype=torch.int32))
        fn_c = make_train_step(cfg, opt, orthogonal_update=orthogonal,
                               device="cpu")
        fn_g = make_train_step(cfg, opt, orthogonal_update=orthogonal)
        toks = np.random.default_rng(seed + 1)
        flipped, worst = 0, 0.0
        for s in range(VS_CPU_STEPS):
            batch = {"tokens": toks.integers(0, cfg.vocab,
                                             (VS_CPU_BATCH, VS_CPU_SEQ))}
            before = _stacked(st_c.model, st_c.opt_state)
            model_g = Transformer(cfg, device="cuda")
            model_g.load_state_dict(st_c.model.state_dict())
            st_g = TrainState(model_g, {
                "mu": {k: v.cuda() for k, v in st_c.opt_state["mu"].items()},
                "nu": {k: v.cuda() for k, v in st_c.opt_state["nu"].items()},
                "step": st_c.opt_state["step"].cuda()}, st_c.step.cuda())
            _, m_g = fn_g(st_g, batch)
            _, m_c = fn_c(st_c, batch)
            for k in m_c:
                want = float(m_c[k])
                err = abs(float(m_g[k]) - want) / max(abs(want), 1e-30)
                worst = max(worst, err)
                check(err <= 1e-5, f"11c step {s + 1} (orthogonal "
                      f"{orthogonal}): {k} {float(m_g[k])} vs {want}")
            try:
                held = hold_adam_step(
                    _stacked(st_g.model, st_g.opt_state), before,
                    _stacked(st_c.model, st_c.opt_state), step=s + 1,
                    lr=float(m_c["lr"]), b1=opt.b1, b2=opt.b2, eps=opt.eps,
                    tau=4e-5 if orthogonal else 1e-6, orthogonal=orthogonal)
            except AssertionError as e:
                check(False, f"11c step {s + 1}, orthogonal {orthogonal}: {e}")
            flipped += held["flipped"]
            check(int(st_g.step) == int(st_c.step) == s + 1,
                  "11c steps count alike")
        log(f"11c orthogonal={orthogonal}: {VS_CPU_STEPS} steps, card "
            f"against CPU: metrics within {worst:.2e} relative (tol 1e-5), "
            f"parameters and moments within the bound; {flipped} elements "
            f"in Q columns of the other sign")
        out["orthogonal" if orthogonal else "plain"] = {
            "metrics_rel": worst, "flipped": flipped}
    return out


def phase_train_driver(seed: int) -> dict:
    """11d: `repro_torch.launch.train.main` on the card (its default
    device), qwen3's smoke configuration: 6 steps with a checkpoint every 3,
    the checkpoint of step 6 restored into a fresh state and held to the
    file bit for bit, then a restart to 10 steps, which must resume from
    step 6 and run 6->10."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_state

    with tempfile.TemporaryDirectory() as tmp:
        args = ["--arch", "qwen3-8b", "--smoke", "--batch", "4", "--seq",
                "32", "--ckpt-dir", tmp, "--log-every", "2", "--warmup", "2",
                "--seed", str(seed)]
        logs = []
        for steps, every in ((6, 3), (10, 100)):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_main(args + ["--steps", str(steps), "--ckpt-every",
                                        str(every)])
            logs.append(buf.getvalue())
            log(f"11d driver to {steps} steps: rc {rc} in "
                f"{time.perf_counter() - t0:.2f} s")
            for line in logs[-1].splitlines():
                log(f"    {line}")
            check(rc == 0, f"11d driver run to {steps} steps")
            if steps == 6:
                mgr = CheckpointManager(tmp)
                check(6 in mgr.all_steps(), "11d checkpoint of step 6")
                target = init_state(torch.Generator(device="cuda"),
                                    get_config("qwen3-8b", smoke=True),
                                    AdamWConfig())
                mgr.restore(6, target)
                restored = _stacked(target.model, target.opt_state)
                with np.load(f"{tmp}/step_00000006.npz") as data:
                    same = all(
                        np.array_equal(restored[part][key],
                                       data[f"{prefix}/{key}"])
                        for part, prefix in (("params", ".params"),
                                             ("mu", ".opt_state/mu"),
                                             ("nu", ".opt_state/nu"))
                        for key in restored[part])
                    same = same and int(target.step) == int(data[".step"])
                check(same, "11d restored state equals the checkpoint bit "
                      "for bit")
                check(target.model.embed.device.type == "cuda",
                      "11d restored onto the card")
    check("step     6" in logs[0], "11d first run logs step 6")
    check("resumed from step 6" in logs[1] and "steps 6->10" in logs[1],
          "11d restart resumes from step 6 and runs 6->10")
    return {"resumed": True, "bit_equal_restore": True}


# -- phase 12: mixture-of-experts and state-space configs ------------------------

MIXTRAL_PROMPT = 6144  # longer than mixtral's 4,096-slot ring
# (sub-phase, config, super-blocks (None: all), (prompts, prompt tokens,
# decode steps), (train blocks, batch, sequence) or None): mixtral trains
# one block on 2 x 4096 tokens (46.5 GB of state); rwkv6 all 24 blocks on
# 2 x 1024 (its chunked scan is host-bound: about 29 s a step at 2 x 4096 on
# an H100); arctic and jamba cannot train on one card.
MOE_SSM_CELLS = (
    ("12a", "mixtral-8x22b", 2, (2, MIXTRAL_PROMPT, 32),
     (1, LM_BATCH, LM_SEQ)),
    ("12b", "arctic-480b", 2, (8, 2048, 32), None),
    ("12c", "rwkv6-1.6b", None, (8, 2048, 64), (24, LM_BATCH, 1024)),
    ("12d", "jamba-v0.1-52b", 1, (4, 2048, 32), None))
# Phase 13, the same fields and the eval step's (batch, positions), which
# the train step takes too: whisper-tiny whole on 16 utterances of 30 s
# (1,500 frames, arXiv:2212.04356) under 448 text positions (its n_text_ctx);
# llava-next-34b at 4 of its 60 blocks on 2 sequences of 2,880 patch
# embeddings (5 anyres tiles x 576) and 1,216 tokens, the JAX dry-run's
# split of a 4,096 sequence (src/repro/launch/dryrun.py:56), its train step
# at 2 blocks (≈ 2.1 B parameters, ≈ 33 GB of state).
ENC_DEC_CELLS = (
    ("13a", "whisper-tiny", None, (16, 4, 128), (4, 16, 448), (16, 448)),
    ("13b", "llava-next-34b", 4, (2, 1216, 32), (2, 2, 4096), (2, 4096)))


class MoEDrops:
    """While active, records for each MoE layer of ``model`` the share of
    its assignments dropped past capacity (`MoE.dropped` on the layer's
    input, read after the forward)."""

    def __init__(self, model, cfg):
        self.model, self.cfg = model, cfg
        self.counts: dict = {}

    def __enter__(self):
        from repro_torch.models.moe import MoE

        def hook(mod, args, _out, name):
            x = args[0]
            self.counts.setdefault(name, []).append(
                (mod.dropped(x, self.cfg), x.shape[0] * x.shape[1]
                 * self.cfg.moe.top_k))

        self._handles = [m.register_forward_hook(
            lambda mod, args, out, _n=name: hook(mod, args, out, _n))
            for name, m in self.model.named_modules() if isinstance(m, MoE)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self.model = None  # the caller may free it

    def shares(self) -> dict:
        return {name: sum(int(d) for d, _ in v) / sum(n for _, n in v)
                for name, v in self.counts.items()}


def lm_eval_flops(cfg, batch: int, seq: int, frames: int = 0) -> dict:
    """Floating-point operations of one eval forward as the port runs it
    (2 per multiply-add): the blocks' products in the compute dtype (the
    experts over every capacity slot, empty ones included, as the batched
    products run them; ``useful`` counts top-k experts a token), attention
    over the pairs its window and causality make visible, and the float32
    LM head. Mamba and RWKV layers are counted by their projections.
    ``seq`` counts every decoder position, a patch config's patches too,
    whose projection adds 2·d² a patch. An encoder-decoder's encoder runs
    over ``frames`` positions a sequence (attention over every pair), and
    each cross-attention projects the queries and the output over the
    decoder's positions, K and V over the encoder's output, and attends
    over every (position, frame) pair."""
    from repro_torch.models.moe import capacity

    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    proj = d * (nq + 2 * nkv) * hd + nq * hd * d

    def stack(specs, n: int, length: int, pairs: int) -> tuple[int, int]:
        t = batch * length
        run = useful = 0
        for spec in specs:
            base = 0
            if spec.mixer == "attn":
                base += 2 * t * proj + 4 * batch * nq * pairs * hd
            elif spec.mixer == "mamba":
                di = (cfg.mamba.expand if cfg.mamba else 2) * d
                base += 2 * t * (d * 2 * di + di * d)
            elif spec.mixer == "rwkv6":
                base += 2 * t * 5 * d * d
            if spec.cross_attn:
                base += (2 * t * 2 * nq * hd * d
                         + 2 * batch * frames * d * 2 * nkv * hd
                         + 4 * batch * nq * length * frames * hd)
            if spec.mlp in ("dense", "dense+moe"):
                base += 2 * t * 3 * d * ff
            if spec.mlp == "rwkv_cmix":
                base += 2 * t * (2 * d * ff + d * d)
            run, useful = run + base, useful + base
            if spec.mlp in ("moe", "dense+moe"):
                grp, cap = capacity(cfg, t)
                e = cfg.moe.num_experts
                run += 2 * grp * e * cap * 3 * d * ff + 2 * t * d * e
                useful += 2 * t * cfg.moe.top_k * 3 * d * ff + 2 * t * d * e
        return n * run, n * useful

    w = cfg.swa_window or seq
    run, useful = stack(cfg.block, cfg.n_blocks, seq,
                        sum(min(i + 1, w) for i in range(seq)))
    extra = 2 * batch * cfg.patch_positions * d * d
    if cfg.is_enc_dec:
        enc = stack(cfg.encoder_block, cfg.encoder_blocks, frames,
                    frames * frames)
        extra += enc[0]
    return {"compute": run + extra, "useful": useful + extra,
            "float32": 2 * batch * seq * d * cfg.padded_vocab}


def merge_measures(parts: list, dtype: str) -> dict:
    """`measure` results of disjoint call sets as one: times, bounds,
    bytes, flops and calls summed, the worst of each error."""
    out: dict = {}
    for res in parts:
        fold(out, {k: res[k] for k in ERROR_KEYS if k in res})
    for key in ("calls", "ms", "plain_ms", "bound_ms", "bytes", "flops"):
        out[key] = sum(res[key] for res in parts)
    out["library_ms"] = None if any(res["library_ms"] is None
                                    for res in parts) else sum(
        res["library_ms"] for res in parts)
    out["shapes"] = [sh for res in parts for sh in res["shapes"]]
    out["bound_by"] = bound_ms(out["bytes"], out["flops"], dtype)[1]
    return out


def flash_at(label: str, model, cfg, batch) -> dict:
    """Every flash_attention call of one forward of ``model``, captured,
    against the plain version and SDPA (one bf16 step, `flash_compare`).
    Where the forward runs both, the causal calls (a decoder's) and the
    non-causal ones (an encoder's) are also reported apart, under
    ``groups``."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as fk, ops as fa_ops

    with torch.inference_mode():
        with Capture([(fa_ops, "flash_attention")]) as cap:
            model(batch, cfg)
            torch.cuda.synchronize()
        calls = cap.calls["flash_attention"]
        del cap
        groups = {}
        for name, causal in (("causal", True), ("non_causal", False)):
            part = [c for c in calls if c[1].get("causal", True) == causal]
            if part:
                groups[name] = measure(part, fk.flash_attention, flash_plain,
                                       flash_cost, flash_compare, "bfloat16",
                                       library=sdpa, reps=3)
    del calls, part
    torch.cuda.empty_cache()
    heads = (f"query heads {cfg.n_heads}, KV heads {cfg.n_kv_heads}: GQA "
             f"group {cfg.n_heads // cfg.n_kv_heads}")
    if len(groups) > 1:
        for name, res in groups.items():
            report(f"{label}: flash_attention bfloat16, the {name} calls of "
                   f"one forward ({heads})", res, {"bound_ratio": 1.0},
                   library="scaled_dot_product_attention")
            flash_rates(res, "bfloat16")
    flash = merge_measures(list(groups.values()), "bfloat16")
    report(f"{label}: flash_attention bfloat16 over one forward ({heads})",
           flash, {"bound_ratio": 1.0},
           library="scaled_dot_product_attention")
    flash_rates(flash, "bfloat16")
    if len(groups) > 1:
        flash["groups"] = groups
    return flash


def config_serve(label: str, model, cfg, seed: int, batch: int,
                 prompt: int, steps: int, forced_rows: int,
                 extra=None) -> dict:
    """Serving of one phase 12 or 13 config: prefill of ``batch`` prompts
    of ``prompt`` tokens (one warm-up, one timed), with ``extra``'s frames
    or patches (a patch config's cache holds its patches too); greedy
    `sample_loop` for ``steps`` steps (one eager decode step, then replays
    of one captured graph) with the counters zeroed around it; one replay
    against one eager step from the same cache and tokens, bit for bit;
    timed eager steps; timed and profiled replays; the teacher-forced
    decode against the forward on
    ``forced_rows`` sequences: with float32 parameters the model runs it
    in float32 compute, held at the JAX package's 2e-3 × max(max |logits|,
    1) (in bf16 the decode drifts from the forward by several percent over
    depth in the JAX package as in the port: each call rounds its own GEMMs,
    and the recurrences and the routing carry it); arctic's bf16 parameters
    in bf16 at 2e-2. MoE configs: held only where neither the forward nor
    the prefill dropped an assignment."""
    import dataclasses

    import torch
    from repro_torch.kernels import _platform
    from repro_torch.train.serve import (DecodeGraph, make_decode_step,
                                         make_prefill, sample_loop)

    extra = extra or {}
    max_len = cfg.patch_positions + prompt + steps + 1
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt + SERVE_FORCED),
                           generator=gen, device="cuda")
    first = {"tokens": tokens[:, :prompt], **extra}
    prefill = make_prefill(cfg, max_len)
    decode = make_decode_step(cfg)
    (logits, cache), t_pre, _, warm = wall(lambda: prefill(model, first), 1)
    check(bool(torch.isfinite(logits).all()), f"{label}: prefill finite")
    slots = {kind: tuple(leaf.shape) for sub in cache["blocks"].values()
             for kind, leaves in sub.items() for leaf in leaves.values()}
    del logits, cache
    log(f"{label}: prefill of {batch} x {prompt} tokens"
        f"{f' after {cfg.patch_positions} patches' * bool(cfg.patch_positions)}"
        f"{f' with {cfg.encoder_len} frames' * cfg.is_enc_dec} (max_len "
        f"{max_len}): {t_pre * 1e3:.1f} ms (warm-up {warm * 1e3:.1f} ms), "
        f"{batch * prompt / t_pre:.0f} prompt tokens/s; cache leaves by "
        f"kind {slots}")

    _platform.reset_launch_counts()
    t0 = time.perf_counter()
    toks = sample_loop(model, cfg, first, steps=steps, max_len=max_len)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    launches = _platform.launch_counts()
    check(toks.shape == (batch, steps) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"{label}: sampled tokens")
    log(f"{label}: sample_loop ({steps} steps: one eager step, then "
        f"replays) {t_loop * 1e3:.1f} ms; launch counts {launches} (the "
        "decode steps reach no port kernel; an encoder-decoder's prefill "
        "runs its encoder through the flash kernel)")

    logits, cache = prefill(model, first)
    logits, cache = decode(model, cache, logits.argmax(-1)[:, None])
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    snap = clone_cache(cache)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graph = DecodeGraph(model, cfg, cache, tok)
    check(caches_equal(cache, snap), f"{label}: capturing ran nothing")
    replayed = graph(tok).clone()
    eager, snap = decode(model, snap, tok)
    bit_equal = torch.equal(replayed, eager) and caches_equal(cache, snap)
    log(f"{label}: replay vs eager decode step from the same cache and "
        f"tokens, logits and every cache leaf bit-equal: {bit_equal}")
    check(bit_equal, f"{label}: a replayed decode step equals the eager "
          "step")
    check(bool(torch.isfinite(replayed).all()), f"{label}: decode finite")
    eager_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        eager, snap = decode(model, snap, tok)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    t_eager = statistics.median(eager_ms)
    log(f"{label}: eager decode median {t_eager:.2f} ms a step of "
        f"{[round(x, 2) for x in eager_ms]}")
    del snap, eager
    torch.cuda.empty_cache()
    tok = replayed.argmax(-1)[:, None].to(torch.int32)
    replay_ms = []
    for _ in range(steps - 4):
        t0 = time.perf_counter()
        tok = graph(tok).argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
    t_replay = statistics.median(replay_ms)
    log(f"{label}: replayed decode median {t_replay:.2f} ms a step (min "
        f"{min(replay_ms):.2f}, max {max(replay_ms):.2f}); "
        f"{batch * 1e3 / t_replay:.1f} tokens/s")
    prof = profile_once(f"{label} decode step (replay)", lambda: graph(tok),
                        cpu=False)
    graph.close()
    del graph, cache, replayed
    torch.cuda.empty_cache()
    rows = {k: v[:forced_rows] for k, v in extra.items()}
    if cfg.param_dtype == "float32":
        forced = decode_vs_forward(
            f"{label} float32", model, dataclasses.replace(
                cfg, compute_dtype="float32"), tokens[:forced_rows], prompt,
            forced_rows, 2e-3, 1.0, moe=cfg.moe is not None, extra=rows)
    else:
        forced = decode_vs_forward(label, model, cfg, tokens[:forced_rows],
                                   prompt, forced_rows, 2e-2, 0.0,
                                   moe=cfg.moe is not None, extra=rows)
    return {"prefill_ms": t_pre * 1e3,
            "prefill_tokens_per_s": batch * prompt / t_pre,
            "sample_loop_ms": t_loop * 1e3, "launches": launches,
            "eager_step_ms": t_eager, "replay_step_ms": t_replay,
            "decode_tokens_per_s": batch * 1e3 / t_replay,
            "replay_bit_equal": bit_equal, "profile_replay": prof,
            "forced": forced}


class ExpandableSegments:
    """While active, the caching allocator maps new memory as expandable
    segments (``expandable_segments:True``), so blocks freed by one part of
    a step serve another's larger requests; on exit the cache is emptied
    and fixed segments come back."""

    def __enter__(self):
        import torch

        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        return self

    def __exit__(self, *exc):
        import torch

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def config_train(label: str, cfg, seed: int, batch: int, seq: int,
                 fixed=None) -> dict:
    """One phase 12 or 13 config's train step: `init_state` on the card,
    one warm-up step, then `REPS` steps of ``batch`` × ``seq`` positions
    timed by CUDA events, the pipeline's tokens or, given, every step on
    the batch ``fixed`` (tokens with their frames or patches); loss, aux
    and grad_norm finite; peak reserved memory. The
    step runs on expandable segments: with fixed ones, mixtral's backward
    (bf16 weight casts, `_attend`'s float32 scores) keeps blocks the
    optimizer's 3.2 GB float32 temporaries cannot use, and one block on
    1 × 4096 tokens reserved 80.24 GB for 62.75 GB allocated on an H100."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import init_state, make_train_step

    opt = AdamWConfig(lr=warmup_cosine(3e-4, 2, REPS + 4))
    if fixed is None:
        pipe = TokenPipeline(cfg.vocab, seq, batch, seed=seed)
        batches = [pipe.batch_at(s) for s in range(REPS + 1)]
    else:
        batches = [fixed] * (REPS + 1)
    rows = []
    with ExpandableSegments():
        torch.cuda.reset_peak_memory_stats()
        state = init_state(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, opt)
        n_params = sum(p.numel() for p in state.model.parameters())
        step = make_train_step(cfg, opt)
        t0 = time.perf_counter()
        step(state, batches[0])
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        for s in range(1, REPS + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, m = step(state, batches[s])
            end.record()
            torch.cuda.synchronize()
            rows.append({"ms": start.elapsed_time(end),
                         **{k: float(m[k]) for k in ("loss", "aux", "ce",
                                                     "grad_norm")}})
        peak = torch.cuda.max_memory_reserved()
        peak_alloc = torch.cuda.max_memory_allocated()
        del state, step, m
    check(all(math.isfinite(r[k]) for r in rows
              for k in ("loss", "aux", "grad_norm")),
          f"{label}: train loss, aux and grad_norm finite")
    step_ms = statistics.median(r["ms"] for r in rows)
    log(f"{label} train ({cfg.n_blocks} blocks, {n_params / 1e9:.4f} B "
        f"parameters, state {16 * n_params / 1e9:.2f} GB): step median "
        f"{step_ms:.1f} ms of {[round(r['ms'], 1) for r in rows]} (warm-up "
        f"{warm * 1e3:.1f} ms wall); {batch} x {seq} positions, "
        f"{batch * seq / step_ms * 1e3:.0f} positions/s; loss "
        f"{[round(r['loss'], 4) for r in rows]}, aux "
        f"{[round(r['aux'], 5) for r in rows]}, grad_norm "
        f"{[round(r['grad_norm'], 4) for r in rows]}; peak reserved "
        f"{peak / 1e9:.2f} GB, allocated {peak_alloc / 1e9:.2f} GB")
    check(peak < 80e9, f"{label} train: peak reserved under 80 GB")
    return {"blocks": cfg.n_blocks, "params": n_params, "batch": batch,
            "seq": seq, "steps": rows, "step_ms": step_ms,
            "warmup_wall_ms": warm * 1e3,
            "tokens_per_s": batch * seq / step_ms * 1e3,
            "peak_reserved_gb": peak / 1e9,
            "peak_allocated_gb": peak_alloc / 1e9}


def modality_inputs(cfg, batch: int, gen) -> dict:
    """What the stubbed front ends give the backbone, standard normal on
    the card from ``gen`` in the parameters' dtype: an encoder-decoder's
    ``frames`` [batch, encoder_len, d], a patch config's ``patches``
    [batch, patch_positions, d]; nothing for another config."""
    import torch

    dt = getattr(torch, cfg.param_dtype)
    out = {}
    if cfg.is_enc_dec:
        out["frames"] = torch.randn(batch, cfg.encoder_len, cfg.d_model,
                                    generator=gen, device="cuda").to(dt)
    if cfg.patch_positions:
        out["patches"] = torch.randn(batch, cfg.patch_positions,
                                     cfg.d_model, generator=gen,
                                     device="cuda").to(dt)
    return out


def phase_lm_config(name: str, seed: int, *, blocks: int | None,
                    serve: tuple[int, int, int],
                    train: tuple[int, int, int] | None,
                    shape: tuple[int, int] = (LM_BATCH, LM_SEQ)) -> dict:
    """12a–12d and 13a–13b: one config at its published widths, ``blocks``
    of its super-blocks (None: all), initialized on the card from ``seed``:
    the eval step on ``shape`` = (batch, positions) through
    ``make_eval_step`` (median of `REPS` after a warm-up; the flash kernel
    where it has attention, encoder layers included, every call of one
    forward against the plain version and SDPA) with the counters zeroed
    around it, one profiled eval step, then serving (``serve`` = (prompts,
    prompt tokens, decode steps), `config_serve`), then, with ``train`` =
    (blocks, batch, seq), the train step at that depth on ``batch`` ×
    ``seq`` positions (`config_train`, after the eval model is freed). An
    encoder-decoder's batches hold frames of its encoder length, a patch
    config's its patches before the tokens (the positions count them), and
    its train step runs on the eval batch. Peak reserved memory under 80
    GB throughout."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _platform
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import make_eval_step

    t_phase = time.perf_counter()
    full = get_config(name)
    n_attn = sum(s.mixer == "attn" for s in full.block)
    cfg = dataclasses.replace(full, n_blocks=blocks or full.n_blocks,
                              use_flash_kernel=n_attn > 0)
    n_flash = cfg.n_blocks * n_attn + (cfg.encoder_blocks * sum(
        s.mixer == "attn" for s in cfg.encoder_block) if cfg.is_enc_dec
        else 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Transformer(cfg, device="cuda").init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    enc = (f"; encoder {cfg.encoder_blocks} blocks over {cfg.encoder_len} "
           f"frames" if cfg.is_enc_dec else "") + (
        f"; {cfg.patch_positions} patch positions" if cfg.patch_positions
        else "")
    log(f"{name}: {cfg.n_blocks} of {full.n_blocks} super-blocks of "
        f"{len(cfg.block)} layers ({[(s.mixer, s.mlp) for s in cfg.block]}"
        f"{enc}), d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, moe "
        f"{cfg.moe}, mamba {cfg.mamba}, rwkv {cfg.rwkv}, window "
        f"{cfg.swa_window}; {n_params / 1e9:.4f} B parameters "
        f"({cfg.param_dtype}; the full config {full.param_count() / 1e9:.2f}"
        f" B by param_count()), compute {cfg.compute_dtype}; initialized on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    b, seq = shape
    tokens = torch.randint(0, cfg.vocab, (b, seq - cfg.patch_positions),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens, **modality_inputs(cfg, b, gen)}
    eval_fn = make_eval_step(cfg)
    _platform.reset_launch_counts()
    metrics, t_step, ts, warm = wall(lambda: eval_fn(model, batch), REPS)
    launches = _platform.launch_counts()
    loss, aux = float(metrics["loss"]), float(metrics["aux"])
    tok_s = b * seq / t_step
    log(f"{name} eval step ({b} x {seq} positions"
        f"{f', {cfg.encoder_len} frames each' * cfg.is_enc_dec}): median "
        f"{t_step * 1e3:.1f} ms of {[round(x * 1e3, 1) for x in ts]} ms "
        f"(warm-up {warm * 1e3:.1f} ms); {tok_s:.0f} positions/s; loss "
        f"{loss:.4f}, aux {aux:.5f}; launches {launches} over {REPS + 1} "
        "steps")
    check(math.isfinite(loss) and math.isfinite(aux),
          f"{name}: eval loss and aux finite")
    check(launches.get("flash_attention_sm90", 0) == (REPS + 1) * n_flash,
          f"{name}: the bfloat16 flash kernel launched once per attention "
          "layer")
    out = {"blocks": cfg.n_blocks, "params": n_params, "launches": launches,
           "batch": b, "positions": seq, "step_ms": t_step * 1e3,
           "tokens_per_s": tok_s, "loss": loss, "aux": aux}
    with torch.inference_mode(), MoEDrops(model, cfg) as drops:
        logits, _, offset = model(batch, cfg)
    check(bool(torch.isfinite(logits).all()) and logits.shape[:2] == (b, seq)
          and offset == cfg.patch_positions,
          f"{name}: logits finite over every position, text after the "
          "patches")
    del logits
    out["eval_drop_shares"] = drops.shares()
    if cfg.moe is not None:
        log(f"{name}: share of assignments dropped per MoE layer, eval "
            f"forward: {out['eval_drop_shares']}")
    if n_attn:
        out["flash"] = flash_at(name, model, cfg, batch)
        out["flash"]["launches"] = launches.get("flash_attention_sm90", 0)
        out["flash"]["launches_per_forward"] = n_flash
    flops = lm_eval_flops(cfg, b, seq, cfg.encoder_len * cfg.is_enc_dec)
    total = flops["compute"] + flops["float32"]
    out["flops"] = flops
    out["bf16_peak_share"] = total / t_step / PEAK_FLOPS["bfloat16"]
    log(f"{name} eval FLOPs as run: {flops['compute']:.3e} in "
        f"{cfg.compute_dtype} ({flops['useful']:.3e} of them top-k work) + "
        f"{flops['float32']:.3e} in float32 (LM head); "
        f"{total / t_step / 1e12:.1f} TFLOP/s, "
        f"{100 * out['bf16_peak_share']:.2f}% of the dense bf16 peak")
    t0 = time.perf_counter()
    with torch.inference_mode():
        out["profile_eval"] = profile_once(f"{name} eval step",
                                           lambda: eval_fn(model, batch),
                                           cpu=False)
    log(f"{name}: profiling the eval step took "
        f"{time.perf_counter() - t0:.1f} s; eval phase so far "
        f"{time.perf_counter() - t_phase:.1f} s")
    del metrics
    torch.cuda.empty_cache()
    prompts, prompt, steps = serve
    out["serve"] = config_serve(name, model, cfg, seed, prompts, prompt,
                                steps, min(2, prompts),
                                extra=modality_inputs(cfg, prompts, gen))
    out["eval_peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    log(f"{name}: peak reserved {out['eval_peak_reserved_gb']:.2f} GB over "
        "eval and serving")
    check(out["eval_peak_reserved_gb"] < 80, f"{name}: peak reserved under "
          "80 GB")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{name}: eval and serving {time.perf_counter() - t_phase:.1f} s")
    if train is not None:
        fixed = batch if len(batch) > 1 else None
        out["train"] = config_train(name, dataclasses.replace(
            cfg, n_blocks=train[0], use_flash_kernel=False), seed, *train[1:],
            fixed=fixed)
        del fixed
    del batch
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"{name}: phase {out['wall_s']:.1f} s")
    return out


def phase_enc_dec(seed: int, t_start: float) -> dict:
    """Phase 13: whisper-tiny (its encoder's flash calls without causality)
    and llava-next-34b (GQA group 7 behind 2,880 patch positions), each
    through `phase_lm_config` at its `ENC_DEC_CELLS` entry."""
    out = {}
    for sub, name, blocks, serve, train, shape in ENC_DEC_CELLS:
        log(f"== phase {sub}: {name}")
        out[name] = phase_lm_config(name, seed, blocks=blocks, serve=serve,
                                    train=train, shape=shape)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    return out


MESH_STEPS, MESH_TIMED = 2, 3  # 14a: steps held to the mesh-less run, timed
# 14c's record before the model axis split compute (the dry run's qwen3-8b
# train_4k on 16 x 16 as this phase printed it then; PERF.md §6 keeps it):
# each model rank computed its data rank's rows whole.
UNSPLIT_14C = {"flops_per_device": 4.282e15,
               "useful_flops_fraction": 0.0470,
               "peak_memory_per_device": 19.63e9, "collective_bytes": 2.54e10}


def _dryrun_cmd(out_dir: pathlib.Path, *args) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            "qwen3-8b", "--shape", "train_4k", "--out", str(out_dir), *args]


def _dryrun_start(out_dir: pathlib.Path, args) -> tuple:
    """The dry run as a subprocess of its own (its fake world of ranks
    lives there), on the CPU: (process, start time, output dir)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out_dir.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(_dryrun_cmd(out_dir, *args), cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, time.perf_counter(), out_dir


def _dryrun_wait(run, label: str, timeout: float = 240.0) -> dict:
    proc, t0, out_dir = run
    try:
        text = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    secs = time.perf_counter() - t0
    for line in text.strip().splitlines()[-4:]:
        log(f"  [{label}] {line}")
    check(proc.returncode == 0, f"{label}: the dry run exited with "
          f"{proc.returncode}:\n{text[-3000:]}")
    (path,) = sorted(out_dir.glob("*.json"))
    rec = json.loads(path.read_text())
    check(rec.get("status") == "ok", f"{label}: record status "
          f"{rec.get('status')}: {rec.get('error')}")
    rec["seconds"] = secs
    return rec


def phase_train_mesh(seed: int, step_ms_11a: float) -> dict:
    """Phase 14: LM training through the mesh path (A14.6) and its compute
    split over ``model`` (A14.7).

    14a: qwen3-8b at 11a's cut (`TRAIN_BLOCKS` of 36 blocks, 2 × 4096
    tokens, float32 state, bf16 compute, remat) over a one-rank NCCL world
    and `make_host_mesh`, from the state the mesh-less step starts from
    (the same seed). The step runs the mesh path (each super-block's
    parameters installed through the gather, again under remat, every
    layer's split body on a model axis of one rank, the gradients through
    the gather's reduction, the norm over slices) with nothing to
    exchange: after `MESH_STEPS` steps the metrics, parameters and
    moments are held to the mesh-less run's bit for bit (the mesh-less
    run's are snapshotted to the host first: both states do not fit the
    card at once), and the mesh issues no collective; then `MESH_TIMED`
    steps are timed (CUDA events) beside 11a's, with the peak allocated
    memory, and one more step runs under ``FlopCounterMode``
    (`repro_torch.launch.dryrun.flop_counter`, whose module tracker is
    left out: it would keep every block's activations through remat).
    14b: the dry run of 14a's cell on a (1, 1) mesh (``--host-mesh 1,1
    --blocks 4 --batch 2 --micro 1``, fake tensors on the CPU, in a
    subprocess): its ``flops_per_device`` must equal 14a's count exactly
    and its ``peak_memory_per_device`` lie within [0.5, 2] of 14a's
    ``max_memory_allocated``; its roofline ``step_s`` over the measured
    step is printed. 14c: the full-size train_4k cell of qwen3-8b on the
    single-pod (16 × 16) mesh, in a subprocess, its compute split over the
    16-way model axis: every field of its record and its seconds, and its
    FLOPs, useful fraction, peak and collective bytes beside the record of
    the step that split no compute (`UNSPLIT_14C`). Both dry runs run while
    14a holds the card."""
    import dataclasses
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.dryrun import flop_counter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.sharding.collectives import recording
    from repro_torch.train import init_state, make_train_step

    out_root = REPO / "chiprun_out" / "dryrun"
    runs = {
        "14b": _dryrun_start(out_root / "14b", [
            "--host-mesh", "1,1", "--blocks", str(TRAIN_BLOCKS), "--batch",
            str(LM_BATCH), "--seq", str(LM_SEQ), "--micro", "1"]),
        "14c": _dryrun_start(out_root / "14c", ["--mesh", "single"])}

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_blocks=TRAIN_BLOCKS,
                              remat=True)
    opt = AdamWConfig(lr=warmup_cosine(3e-4, 2, MESH_STEPS + MESH_TIMED + 4))
    pipe = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, seed=seed)
    batches = [pipe.batch_at(s) for s in range(MESH_STEPS + MESH_TIMED + 1)]
    gen = lambda: torch.Generator(device="cuda").manual_seed(seed)  # noqa

    # The mesh-less run, snapshotted to the host.
    torch.cuda.empty_cache()
    state = init_state(gen(), cfg, opt)
    step = make_train_step(cfg, opt)
    ref_metrics = [{k: float(v) for k, v in step(state, b)[1].items()}
                   for b in batches[:MESH_STEPS]]
    ref = {"params": {n: p.detach().cpu() for n, p in
                      state.model.named_parameters()},
           **{k: {n: t.cpu() for n, t in state.opt_state[k].items()}
              for k in ("mu", "nu")}}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(pathlib.Path(tmp) / "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300),
            device_id=torch.device("cuda", 0))
        try:
            mesh = make_host_mesh()
            check(mesh.size == 1 and mesh.backend == "nccl"
                  and mesh.device == torch.device("cuda", 0),
                  f"14a: a one-rank NCCL mesh on cuda:0 ({mesh.shape})")
            state = init_state(gen(), cfg, opt, mesh=mesh)
            step = make_train_step(cfg, opt, mesh)
            with recording() as record:
                metrics = [{k: float(v) for k, v in step(state, b)[1].items()}
                           for b in batches[:MESH_STEPS]]
            check(record == [], "14a: a one-rank mesh issues no collective")
            unequal = []
            for key, named in (("params",
                                dict(state.model.named_parameters())),
                               ("mu", state.opt_state["mu"]),
                               ("nu", state.opt_state["nu"])):
                for n, t in named.items():
                    if not torch.equal(t.detach().cpu(), ref[key][n]):
                        unequal.append(f"{key}/{n}")
            bit_equal = not unequal and metrics == ref_metrics
            if bit_equal:
                log(f"14a: {MESH_STEPS} steps over the one-rank NCCL mesh "
                    f"bit-equal to the mesh-less steps (metrics, "
                    f"{len(ref['params'])} parameters and their moments)")
            else:
                # Held as 11c holds two runs of the card: the metrics within
                # 1e-5 relative, the state at rtol 2e-4, atol 2e-6.
                log(f"14a: NOT bit-equal ({len(unequal)} tensors differ, "
                    f"e.g. {unequal[:3]}; metrics {metrics} vs "
                    f"{ref_metrics}): held within 11c's tolerance")
                for a, b in zip(metrics, ref_metrics):
                    for k in b:
                        check(abs(a[k] - b[k]) <= 1e-5 * abs(b[k]),
                              f"14a: metric {k} {a[k]} vs {b[k]}")
                for name in unequal:
                    key, n = name.split("/", 1)
                    got = (dict(state.model.named_parameters()) if key ==
                           "params" else state.opt_state[key])[n]
                    check(torch.allclose(got.detach().cpu(), ref[key][n],
                                         rtol=2e-4, atol=2e-6),
                          f"14a: {name} beyond rtol 2e-4, atol 2e-6")
            del ref
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            rows = []
            for b in batches[MESH_STEPS:MESH_STEPS + MESH_TIMED]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _, m = step(state, b)
                end.record()
                torch.cuda.synchronize()
                rows.append(start.elapsed_time(end))
            peak_alloc = torch.cuda.max_memory_allocated()
            with flop_counter() as fc:  # FlopCounterMode's count
                step(state, batches[-1])
            torch.cuda.synchronize()
            flops = fc.get_total_flops()
            step_ms = statistics.median(rows)
            log(f"14a: mesh step median {step_ms:.1f} ms of "
                f"{[round(r, 1) for r in rows]} (CUDA events) against 11a's "
                f"{step_ms_11a:.1f} ms; peak allocated {peak_alloc / 1e9:.2f} "
                f"GB; FlopCounterMode {flops:.6e} FLOPs a step")
            out["14a"] = {"bit_equal": bit_equal, "unequal": len(unequal),
                          "step_ms": rows, "median_ms": step_ms,
                          "step_ms_11a": step_ms_11a,
                          "peak_allocated_gb": peak_alloc / 1e9,
                          "flops": flops,
                          "loss": float(m["loss"])}
            del state, step
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    rec = _dryrun_wait(runs["14b"], "14b")
    ratio = rec["peak_memory_per_device"] / out["14a"]["peak_allocated_gb"] \
        / 1e9
    log(f"14b: dry run of 14a's cell on (1, 1) in {rec['seconds']:.1f} s: "
        f"flops_per_device {rec['flops_per_device']:.6e} (14a "
        f"{out['14a']['flops']:.6e}); peak_memory_per_device "
        f"{rec['peak_memory_per_device'] / 1e9:.2f} GB, "
        f"{ratio:.3f} of 14a's max_memory_allocated; roofline step_s "
        f"{rec['step_s'] * 1e3:.1f} ms, {rec['step_s'] * 1e3 / step_ms:.3f} "
        f"of the measured step ({rec['dominant']}-bound)")
    check(rec["flops_per_device"] == out["14a"]["flops"],
          "14b: the dry run's FLOPs equal FlopCounterMode's count of 14a")
    check(0.5 <= ratio <= 2.0, f"14b: peak memory ratio {ratio:.3f} within "
          "[0.5, 2]")
    out["14b"] = {**rec, "memory_ratio": ratio,
                  "step_s_over_measured": rec["step_s"] * 1e3 / step_ms}

    rec = _dryrun_wait(runs["14c"], "14c")
    log(f"14c: qwen3-8b train_4k on the 16 x 16 mesh in {rec['seconds']:.1f} "
        f"s of dry run:")
    for key, value in rec.items():
        log(f"  {key}: {value}")
    coll = sum(rec["coll_breakdown"].values())
    log(f"14c against the step that split no compute (UNSPLIT_14C): "
        f"flops_per_device {rec['flops_per_device']:.4e} (was "
        f"{UNSPLIT_14C['flops_per_device']:.4e}, "
        f"{UNSPLIT_14C['flops_per_device'] / rec['flops_per_device']:.2f}"
        f"x); "
        f"useful_flops_fraction {rec['useful_flops_fraction']:.4f} (was "
        f"{UNSPLIT_14C['useful_flops_fraction']:.4f}); peak "
        f"{rec['peak_memory_per_device'] / 1e9:.2f} GB (was "
        f"{UNSPLIT_14C['peak_memory_per_device'] / 1e9:.2f}); collective "
        f"bytes {coll:.4e} (was {UNSPLIT_14C['collective_bytes']:.4e}); "
        f"dominant {rec['dominant']}")
    check(rec["useful_flops_fraction"]
          > UNSPLIT_14C["useful_flops_fraction"],
          "14c: the split raises useful_flops_fraction above the step that "
          "split no compute")
    out["14c"] = dict(rec, collective_bytes=coll, unsplit=UNSPLIT_14C)
    return out


# -- phase 15: prefill and decode over a mesh -----------------------------------

MESH_SERVE_BLOCKS = 4  # 15a/15b: qwen3-8b cut to 4 of its 36 blocks
MESH_SERVE_STEPS = 8  # 15a: decode steps held bit for bit
SERVE_CELLS_15C = (("qwen3-8b", "prefill_32k"), ("qwen3-8b", "decode_32k"),
                   ("mixtral-8x22b", "long_500k"))


def _serve_dryrun(out_dir: pathlib.Path, arch: str, shape: str, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out_dir.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out_dir), *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter(), out_dir


def phase_lm_serve_mesh(seed: int) -> dict:
    """Phase 15: prefill and decode through the mesh path (A14.8).

    15a: 7c's cut (qwen3-8b at full width, `MESH_SERVE_BLOCKS` of 36
    blocks, float32 weights, bf16 compute, 8 prompts of 2,048 tokens) over
    a one-rank NCCL world and `make_host_mesh`: the model sharded over it
    (`train.serve.shard_model`: every slice whole), prefill and
    `MESH_SERVE_STEPS` greedy decode steps through `make_prefill(mesh=)`
    and `make_decode_step(mesh=)`, held to the mesh-less run bit for bit
    (logits and every cache leaf), with no collective recorded; then one
    `DecodeGraph` replay on the mesh against one eager step from the same
    cache, bit for bit. 15b: the dry run of a cut prefill and a cut decode
    cell on a (1, 1) mesh (``--host-mesh 1,1 --blocks 4 --batch 8 --seq
    2048``, fake tensors on the CPU, subprocesses): each one's
    ``flops_per_device`` must equal ``FlopCounterMode``'s count of the same
    call on the card (the dry run's cell config: bf16 parameters, a decode
    step attending in one block) exactly, and its peak lie within [0.5, 2]
    of the call's ``max_memory_allocated``. 15c: the full-size 16 × 16
    records of `SERVE_CELLS_15C` (a model, not a run): peak, FLOPs,
    collective bytes and ``dominant``."""
    import dataclasses
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import cell_config, flop_counter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.collectives import recording
    from repro_torch.train.serve import (DecodeGraph, make_decode_step,
                                         make_prefill, shard_model)

    out_root = REPO / "chiprun_out" / "dryrun"
    cut = ["--host-mesh", "1,1", "--blocks", str(MESH_SERVE_BLOCKS),
           "--batch", str(SERVE_BATCH), "--seq", str(SERVE_PROMPT)]
    runs = {"15b_prefill": _serve_dryrun(out_root / "15b_prefill",
                                         "qwen3-8b", "prefill_32k", *cut),
            "15b_decode": _serve_dryrun(out_root / "15b_decode", "qwen3-8b",
                                        "decode_32k", *cut)}
    for arch, shape in SERVE_CELLS_15C:
        runs[f"15c_{shape}"] = _serve_dryrun(out_root / f"15c_{shape}", arch,
                                             shape, "--mesh", "single")

    cfg = dataclasses.replace(get_config("qwen3-8b"),
                              n_blocks=MESH_SERVE_BLOCKS)
    max_len = SERVE_PROMPT + MESH_SERVE_STEPS + 1
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    prompt = {"tokens": torch.randint(0, cfg.vocab,
                                      (SERVE_BATCH, SERVE_PROMPT),
                                      generator=gen, device="cuda")}

    def served(model, mesh):
        prefill = make_prefill(cfg, max_len, mesh=mesh)
        decode = make_decode_step(cfg, mesh=mesh)
        _, warm = prefill(model, {"tokens": prompt["tokens"][:, :16]})
        decode(model, warm, prompt["tokens"][:, :1].to(torch.int32))
        del warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(model, prompt)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        out = [logits.clone()]
        steps = []
        for _ in range(MESH_SERVE_STEPS):
            tok = out[-1].argmax(-1)[:, None].to(torch.int32)
            t0 = time.perf_counter()
            logits, cache = decode(model, cache, tok)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.clone())
        return out, cache, t_pre * 1e3, steps

    def fresh():
        g = torch.Generator(device="cuda").manual_seed(seed + 8)
        return Transformer(cfg, device="cuda").init(g)

    torch.cuda.empty_cache()
    model = fresh()
    ref_logits, ref_cache, ref_pre, ref_steps = served(model, None)
    ref_logits = [t.cpu() for t in ref_logits]
    ref_cache = {id_: t.cpu() for id_, t in enumerate(cache_leaves(
        ref_cache))}
    del model
    gc.collect()
    torch.cuda.empty_cache()

    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(pathlib.Path(tmp) / "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300),
            device_id=torch.device("cuda", 0))
        try:
            mesh = make_host_mesh()
            check(mesh.size == 1 and mesh.backend == "nccl",
                  f"15a: a one-rank NCCL mesh ({mesh.shape})")
            model = shard_model(fresh(), mesh)
            with recording() as record:
                logits, cache, t_pre, steps = served(model, mesh)
            check(record == [], "15a: a one-rank mesh issues no collective")
            leaves = cache_leaves(cache)
            bit_equal = all(torch.equal(a.cpu(), b) for a, b in
                            zip(logits, ref_logits, strict=True)) and all(
                torch.equal(t.cpu(), ref_cache[i])
                for i, t in enumerate(leaves))
            check(bit_equal, "15a: prefill, decode and the cache over the "
                  "one-rank mesh are the mesh-less ones bit for bit")
            tok = logits[-1].argmax(-1)[:, None].to(torch.int32)
            decode = make_decode_step(cfg, mesh=mesh)
            graph_cache = clone_cache(cache)
            decode(model, graph_cache, tok)  # the step before a capture
            graph = DecodeGraph(model, cfg, graph_cache, tok)
            eager_cache = clone_cache(graph_cache)
            replay = graph(tok).clone()
            eager, _ = decode(model, eager_cache, tok)
            torch.cuda.synchronize()
            replay_equal = torch.equal(replay, eager) and caches_equal(
                graph_cache, eager_cache)
            graph.close()
            check(replay_equal, "15a: a DecodeGraph replay on the one-rank "
                  "mesh equals an eager step bit for bit")
            log(f"15a: qwen3-8b {MESH_SERVE_BLOCKS} blocks, {SERVE_BATCH} x "
                f"{SERVE_PROMPT} prompt tokens over the one-rank NCCL mesh: "
                f"prefill {t_pre:.1f} ms (mesh-less {ref_pre:.1f}), decode "
                f"median {statistics.median(steps):.2f} ms a step "
                f"(mesh-less {statistics.median(ref_steps):.2f}; eager, host "
                f"clock); bit-equal {bit_equal}, replay bit-equal "
                f"{replay_equal}, no collective")
            out["15a"] = {"bit_equal": bit_equal,
                          "replay_equal": replay_equal,
                          "prefill_ms": t_pre, "prefill_ms_mesh_less": ref_pre,
                          "decode_ms": steps, "decode_ms_mesh_less": ref_steps}
            del model, cache, graph_cache, eager_cache, graph
        finally:
            dist.destroy_process_group()
    del ref_cache
    gc.collect()
    torch.cuda.empty_cache()

    # 15b: the cut cells on the card, in the dry run's cell config.
    card = {}
    for shape, kind in (("prefill_32k", "prefill"), ("decode_32k", "decode")):
        spec = ShapeSpec(shape, SERVE_PROMPT, SERVE_BATCH, kind)
        ccfg = cell_config(cfg, spec, {"data": 1, "model": 1})
        g = torch.Generator(device="cuda").manual_seed(seed + 9)
        model = Transformer(ccfg, device="cuda").init(g)
        prefill = make_prefill(ccfg, SERVE_PROMPT)
        if kind == "prefill":
            def call():
                return prefill(model, prompt)
        else:
            _, cache = prefill(model, {"tokens": prompt["tokens"][:, :16]})
            decode = make_decode_step(ccfg)
            tok = prompt["tokens"][:, :1].to(torch.int32)
            pos = cache["pos"].clone()

            def call():
                with torch.inference_mode():
                    cache["pos"].copy_(pos)
                return decode(model, cache, tok)
        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        result = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del result
        with flop_counter() as fc:
            call()
        torch.cuda.synchronize()
        card[kind] = {"flops": fc.get_total_flops(), "peak": peak}
        del model, prefill
        if kind == "decode":
            del cache, decode
        gc.collect()
        torch.cuda.empty_cache()
    for kind in ("prefill", "decode"):
        rec = _dryrun_wait(runs[f"15b_{kind}"], f"15b {kind}")
        ratio = rec["peak_memory_per_device"] / card[kind]["peak"]
        log(f"15b {kind}: dry run of the cut on (1, 1) in "
            f"{rec['seconds']:.1f} s: flops_per_device "
            f"{rec['flops_per_device']:.6e} (card "
            f"{card[kind]['flops']:.6e}); peak "
            f"{rec['peak_memory_per_device'] / 1e9:.3f} GB, {ratio:.3f} of "
            f"the card's max_memory_allocated "
            f"{card[kind]['peak'] / 1e9:.3f} GB")
        check(rec["flops_per_device"] == card[kind]["flops"],
              f"15b {kind}: the dry run's FLOPs equal FlopCounterMode's "
              f"count on the card")
        check(0.5 <= ratio <= 2.0, f"15b {kind}: peak ratio {ratio:.3f} "
              f"within [0.5, 2]")
        out[f"15b_{kind}"] = {**rec, "card_flops": card[kind]["flops"],
                              "card_peak": card[kind]["peak"],
                              "memory_ratio": ratio}
    for arch, shape in SERVE_CELLS_15C:
        rec = _dryrun_wait(runs[f"15c_{shape}"], f"15c {arch} {shape}")
        coll = sum(rec["coll_breakdown"].values())
        log(f"15c: {arch} x {shape} on 16 x 16 (a model, {rec['seconds']:.1f}"
            f" s of dry run): peak {rec['peak_memory_per_device'] / 1e9:.3f}"
            f" GB a device, flops_per_device {rec['flops_per_device']:.4e}, "
            f"collective bytes {coll:.4e}, dominant {rec['dominant']}, "
            f"model_flops {rec['model_flops']:.4e}, memory_analysis "
            f"{rec['memory_analysis']}")
        out[f"15c_{arch}_{shape}"] = dict(rec, collective_bytes=coll)
    return out


def flash_entry(res: dict) -> dict:
    """The kernels line's keys of one config's flash `measure` result."""
    return {k: res[k] for k in (
        "launches", "launches_per_forward", "calls", "shapes",
        "max_abs_err", "max_rel_err", "bound_ratio", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "tflops", "bound_share",
        "vs_library") if k in res}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=4_000_000,
                        help="yelp_like scale (default: 4,000,000)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the LM's random weights and tokens")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "tests"))  # _adam_hold (phase 11)
    from repro_torch import figaro
    from repro_torch.core.join_tree import build_plan
    from repro_torch.core.postprocess import normalize_sign
    from repro_torch.data.relational import yelp_like
    from repro_torch.kernels import _platform, _seg_scan

    t_start = time.perf_counter()
    log("== phase 0: lint")
    phase_lint()
    log("== phase 1: card")
    phase_card()
    log("== phase 2: build")
    build = phase_build()

    log("== phase 3: kernels against their plain versions")
    random_passes = check_random_segments()
    random_panels = check_random_panels()
    flash_case_err = check_flash_cases()
    t0 = time.perf_counter()
    tree = yelp_like(scale=args.scale, cols=16)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_plan(tree)
    t_plan = time.perf_counter() - t0
    spec = plan.spec
    log(f"host: yelp_like(scale={args.scale}, cols=16) generated in "
        f"{t_gen:.2f} s, plan built in {t_plan:.2f} s; N = {spec.num_cols}, "
        f"exact R0 rows {spec.r0_rows}")
    for sp in spec.nodes:
        log(f"  {sp.name}: m={sp.m} n={sp.n} K={sp.K} P={sp.P}")
    sess = figaro.Session(use_kernel=True, assembly="band", device="cuda")
    plain = figaro.Session(use_kernel=False, device="cuda")
    per_dtype = {}
    tail_passes = {}
    for torch_dtype in (torch.float32, torch.float64):
        name = str(torch_dtype).split(".")[1]
        t0 = time.perf_counter()
        with Capture() as cap:
            eager_call(sess, plan, "qr", dtype=torch_dtype)
            torch.cuda.synchronize()
        log(f"captured one eager {name} qr dispatch in "
            f"{time.perf_counter() - t0:.2f} s (first call: host bucketing "
            f"and H2D included for float32)")
        per_dtype[name] = measure_path_kernels(cap.calls, name)
        # The two largest node passes (the tallest, then the largest of the
        # rest), as segmented_head_tail inputs (data masked, weights, the
        # segment starts).
        nf = [a for a, _ in pass_calls(cap.calls["fused_node_pass"])]
        tallest = max(nf, key=lambda a: a[0].shape[-2])
        widest = max((a for a in nf if a is not tallest),
                     key=lambda a: a[0].numel())
        tail_passes[name] = [
            (a[0] * a[6][:, None] if a[6] is not None else a[0], a[1],
             a[2] == 0) for a in (tallest, widest)]
        del cap, nf, tallest, widest
        torch.cuda.empty_cache()
    cap_plan = plan.__dict__["_capacity_plan"]
    log(f"capacity R0: {cap_plan.spec.r0_rows} rows x {spec.num_cols}")

    log("== phase 4: main path")
    _platform.reset_launch_counts()
    r32, t_qr, ts_qr, w_qr = wall(lambda: sess.qr(plan), REPS)
    (s, vt), t_svd, ts_svd, w_svd = wall(lambda: sess.svd(plan), REPS)
    pca, t_pca, ts_pca, w_pca = wall(lambda: sess.pca(plan, k=8), REPS)
    (beta, resid), t_lsq, ts_lsq, w_lsq = wall(
        lambda: sess.least_squares(plan, 0), REPS)
    launches = _platform.launch_counts()
    log(f"launch counts over the main path: {launches}")
    for kname in ("node_fused", "panel_qr", "panel_qr_reg"):
        check(launches.get(kname, 0) > 0, f"{kname} launched on the path")
    check(launches["panel_qr"] == launches["panel_qr_reg"],
          "the main path's panels all take panel_qr's one-block variant")
    per_qr = per_call_launches("float32 qr dispatch (eager)",
                               lambda: eager_call(sess, plan, "qr"))
    captures = sess.engine.capture_count()
    log(f"main path: {sess.engine.trace_count()} misses, {captures} "
        f"captures (float32 R, float64 R)")
    check(captures == 2, "the main path captured one graph per R signature")
    n = spec.num_cols
    for label, tm, ts, w in (("qr float32", t_qr, ts_qr, w_qr),
                             ("svd float64", t_svd, ts_svd, w_svd),
                             ("pca(k=8) float64", t_pca, ts_pca, w_pca),
                             ("least_squares float64", t_lsq, ts_lsq,
                              w_lsq)):
        log(f"{label}: median {tm * 1e3:.1f} ms of "
            f"{[round(x * 1e3, 1) for x in ts]} ms (warm-up "
            f"{w * 1e3:.1f} ms)")
    check(r32.shape == (n, n) and r32.dtype == torch.float32,
          "qr shape/dtype")
    check(bool(torch.isfinite(r32).all()), "qr finite")
    check(s.shape == (n,) and vt.shape == (n, n) and
          bool(torch.isfinite(s).all()), "svd shape/finite")
    check(pca.components.shape == (8, n) and
          bool(torch.isfinite(pca.components).all()), "pca shape/finite")
    check(beta.shape == (n - 1,) and bool(torch.isfinite(beta).all())
          and bool(torch.isfinite(resid)), "lsq shape/finite")

    r_k = sess.qr(plan, dtype=torch.float64)
    t0 = time.perf_counter()
    r_p = eager_call(plain, plan, "qr", dtype=torch.float64)
    torch.cuda.synchronize()
    t_plain_qr = time.perf_counter() - t0
    err_abs, err_rel = rel_err(normalize_sign(r_k), normalize_sign(r_p))
    log(f"R (kernel path) vs R (use_kernel=False), float64 on the card: max "
        f"abs err {err_abs:.3e}, relative {err_rel:.3e} (tol 1e-9); the "
        f"unfused qr took {t_plain_qr * 1e3:.1f} ms")
    check(err_rel <= 1e-9, "kernel-path R matches the unfused path")
    err32 = rel_err(gram(r32), gram(r_k))[1]
    log(f"float32 R'R vs float64 R'R: relative {err32:.3e} (tol 1e-4)")
    check(err32 <= 1e-4, "float32 R within float32 accuracy of float64 R")
    s_p, _ = eager_call(plain, plan, "svd")
    s_rel = rel_err(s, s_p)[1]
    log(f"singular values vs unfused path: relative {s_rel:.3e}")
    check(s_rel <= 1e-9, "singular values match the unfused path")
    gram_rel = gram_check_small(torch.float64)
    graphs = {"yelp_qr_f32": graph_vs_eager("yelp qr float32", sess, plan,
                                            torch.float32),
              "yelp_qr_f64": graph_vs_eager("yelp qr float64", sess, plan,
                                            torch.float64)}
    prof_qr = graphs["yelp_qr_f32"]["eager"]
    prof_qr64 = graphs["yelp_qr_f64"]["eager"]
    check(prof_qr["kernels_and_copies"] <= MAX_KERNELS_PER_QR,
          f"a float32 qr issues {prof_qr['kernels_and_copies']} kernels and "
          f"copies (at most {MAX_KERNELS_PER_QR})")
    profile_once("svd float64 (replay, eager tail)", lambda: sess.svd(plan))
    profile_once("qr float64, use_kernel=False (eager)",
                 lambda: eager_call(plain, plan, "qr", dtype=torch.float64))
    _seg_scan.check()
    memory = {"phase 4": memory_log("phase 4", sess.engine)}
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    del sess, plain, cap_plan, r32, r_p
    torch.cuda.empty_cache()

    log("== phase 4c: dataset surface")
    torch.cuda.reset_peak_memory_stats()
    dataset, ds = phase_dataset(tree, r_k, args.seed)
    memory["phase 4c"] = dataset.pop("memory")
    torch.cuda.empty_cache()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    log("== phase 9: serving (9a: the yelp dataset, float32 qr; 9b: a cut "
        "yelp, the float64 kinds)")
    serving = {"full": phase_serve_full(ds, args.seed)}
    memory["phase 9a"] = serving["full"].pop("memory")
    del ds
    gc.collect()
    torch.cuda.empty_cache()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    serving["cut"] = phase_serve_cut(args.seed)
    memory["phase 9b"] = serving["cut"].pop("memory")
    gc.collect()
    torch.cuda.empty_cache()  # phase 9's graphs went with its engines
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    log("== phase 10: distribution (10a: partitioned_qr on the card; 10b: a "
        "one-rank NCCL mesh)")
    distribution = {}
    distribution["partitioned"], dist_sess, r_part = phase_partitioned(
        tree, r_k, graphs["yelp_qr_f64"]["replay"]["median_wall_ms"])
    memory["phase 10a"] = distribution["partitioned"].pop("memory")
    distribution["nccl"] = phase_nccl_mesh(
        tree, plan, dist_sess, r_part, args.seed,
        {k: serving["cut"][k]["requests_per_s"] for k in ("svd", "pca",
                                                          "lsq")})
    memory["phase 10b"] = distribution["nccl"].pop("memory")
    memory["phase 10c"] = distribution["nccl"]["served"].pop("memory")
    del dist_sess, r_part, tree, r_k
    gc.collect()
    torch.cuda.empty_cache()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    b2 = serving["full"].pop("kernels_b2")
    for kname in ("node_fused", "panel_qr"):
        one, two = per_dtype["float32"][kname], b2[kname]
        log(f"{kname} float32 over one qr: B = 1 {one['ms']:.3f} ms against "
            f"a {one['bound_ms']:.3f} ms bound ({one['calls']} calls); B = 2 "
            f"{two['ms']:.3f} ms against {two['bound_ms']:.3f} "
            f"({two['calls']} calls)")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    log("== phase 5: wide N")
    torch.cuda.reset_peak_memory_stats()
    wide = phase_panels("wide", build_plan(wide_tree()), "cluster",
                        compare_graph=True)
    graphs["wide_qr_f64"] = wide.pop("graph")
    memory["phase 5"] = wide.pop("memory")
    check(wide["n"] >= 512, "the wide tree has N >= 512 columns")
    torch.cuda.empty_cache()

    log("== phase 5b: method=\"blocked\" (tall panels)")
    torch.cuda.reset_peak_memory_stats()
    tall = phase_panels("tall", plan, "grid", method="blocked")
    tall["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"tall phase: peak device memory {tall['peak_gib']:.2f} GiB")
    memory["phase 5b"] = tall.pop("memory")
    del plan
    torch.cuda.empty_cache()

    log("== phase 6: segmented tails")
    tails = phase_tails(tail_passes)
    del tail_passes
    torch.cuda.empty_cache()

    log("== phase 7: qwen3-8b eval forward")
    lm = phase_lm(args.seed)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    log("== phase 7c: qwen3-8b prefill and decode")
    lm_model = lm.pop("model")
    serve_lm = phase_lm_serve(lm_model, lm_model.cfg, args.seed)
    del lm_model
    torch.cuda.empty_cache()
    serve_lm["float32"] = phase_lm_serve32(args.seed)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    log("== phase 7b: float32 eval forward (mma flash kernel)")
    lm32 = phase_lm32(args.seed)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    log("== phase 11: qwen3-8b training (11a full width, 4 blocks; 11b the "
        "step's own consistency; 11c the card against the CPU; 11d the "
        "driver)")
    _platform.reset_launch_counts()
    train = {"full": phase_train(args.seed)}
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    train["consistency"] = phase_train_consistency(args.seed)
    train["vs_cpu"] = phase_train_vs_cpu(args.seed)
    train["driver"] = phase_train_driver(args.seed)
    train["launches"] = _platform.launch_counts()
    log(f"launch counts over phase 11: {train['launches']} (no port kernel "
        f"lies on the training path; logged, not checked)")
    _seg_scan.check()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    log("== phase 12: mixture-of-experts and state-space configs (12a "
        "mixtral-8x22b, 12b arctic-480b, 12c rwkv6-1.6b, 12d jamba-v0.1-52b)")
    moe_ssm = {}
    for sub, name, blocks, serve, train_cut in MOE_SSM_CELLS:
        log(f"== phase {sub}: {name}")
        moe_ssm[name] = phase_lm_config(name, args.seed, blocks=blocks,
                                        serve=serve, train=train_cut)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    log("== phase 13: encoder-decoder and patch configs (13a whisper-tiny, "
        "13b llava-next-34b)")
    enc_dec = phase_enc_dec(args.seed, t_start)

    log("== phase 14: training through the mesh path (14a one-rank NCCL "
        "mesh against the mesh-less step; 14b the dry run of 14a's cell; 14c "
        "qwen3-8b train_4k on 16 x 16)")
    t14 = time.perf_counter()
    train_mesh = phase_train_mesh(args.seed, train["full"]["step_ms"])
    log(f"phase 14 took {time.perf_counter() - t14:.1f} s; elapsed "
        f"{time.perf_counter() - t_start:.1f} s")

    log("== phase 15: prefill and decode through the mesh path (15a "
        "one-rank NCCL mesh against the mesh-less run; 15b the dry run of "
        "cut serving cells; 15c the 16 x 16 serving records)")
    t15 = time.perf_counter()
    serve_mesh = phase_lm_serve_mesh(args.seed)
    log(f"phase 15 took {time.perf_counter() - t15:.1f} s; elapsed "
        f"{time.perf_counter() - t_start:.1f} s")

    log("== phase 8: summary")
    measured = {
        "node_fused": (launches, per_dtype["float32"]["node_fused"],
                       per_dtype["float64"]["node_fused"], "float32"),
        "panel_qr": (launches, per_dtype["float32"]["panel_qr"],
                     per_dtype["float64"]["panel_qr"], "float32"),
        "panel_qr_cluster": (wide["launches"], wide["panels"], None,
                             "float64"),
        "panel_qr_grid": (tall["launches"], tall["panels"], None, "float64"),
        "segmented_tail": (tails["launches"], tails["float32"],
                           tails["float64"], "float32"),
        "segmented_cumsum": (tails["launches"], tails["cumsum_float32"],
                             tails["cumsum_float64"], "float32"),
        "flash_attention_sm90": (lm["launches"], lm["flash"], None,
                                 "bfloat16"),
        "flash_attention_mma": (lm32["launches"], lm32["float32"],
                                lm32["float64"], "float32"),
    }
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        path_launches, main, f64, dt = measured[kname]
        entry = {"name": kname, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": path_launches.get(kname, 0), "dtype": dt,
                 "max_abs_err": main["max_abs_err"],
                 "max_rel_err": main["max_rel_err"],
                 "ms": main["ms"], "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "library_ms": main["library_ms"]}
        entry.update({k: main[k] for k in ("reflectors", "t_rel_err",
                                           "min_rms", "bound_ratio",
                                           "old_bound_ms", "dead_max")
                      if k in main})
        if kname in ("node_fused", "panel_qr"):
            entry["launches_per_qr"] = per_qr.get(kname, 0)
            two = b2[kname]
            entry["batch2"] = {
                "launches": serving["full"]["stream"]["launches"].get(
                    kname, 0),
                **{k: two[k] for k in (
                    "max_abs_err", "max_rel_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "calls",
                    "old_bound_ms", "reflectors", "t_rel_err") if k in two}}
        if kname == "panel_qr":
            entry["variant"] = "reg"
        if kname in ("panel_qr_cluster", "panel_qr_grid"):
            entry["launches_per_qr"] = (wide if kname == "panel_qr_cluster"
                                        else tall)["per_qr"].get(kname, 0)
        if kname in FLASH_DTYPES:
            entry["dtypes"] = FLASH_DTYPES[kname]
        if kname == "flash_attention_sm90":
            entry["launches_per_forward"] = lm["launches_per_forward"]
            # Phase 12's GQA groups: mixtral 48/8, arctic 56/8, jamba 32/8;
            # phase 13's whisper 6/6 (its encoder's calls non-causal) and
            # llava 56/8.
            for name, res in {**moe_ssm, **enc_dec}.items():
                if "flash" in res:
                    entry[name] = flash_entry(res["flash"])
                    for group, part in res["flash"].get("groups",
                                                        {}).items():
                        entry[name][group] = flash_entry(part)
        if kname in FLASH_DTYPES:
            entry.update({k: main[k] for k in (
                "tflops", "bound_share", "vs_library")})
        if f64 is not None:
            entry["float64"] = {k: f64[k] for k in (
                "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "old_bound_ms", "tflops",
                "bound_share", "vs_library", "bound_ratio") if k in f64}
        check(entry["launches"] > 0, f"{kname} launched on its path")
        kernels.append(entry)
    log(json.dumps({"main_path_ms": {"qr_f32": t_qr * 1e3,
                                     "svd_f64": t_svd * 1e3,
                                     "pca_f64": t_pca * 1e3,
                                     "lsq_f64": t_lsq * 1e3,
                                     "wide_qr_f64": wide["qr_ms"],
                                     "tall_blocked_qr_f64": tall["qr_ms"],
                                     "lm_eval_step": lm["step_ms"]},
                    "lm_tokens_per_s": lm["tokens_per_s"],
                    "lm_loss": lm["loss"], "lm_peak_gib": lm["peak_gib"],
                    "lm_serve": serve_lm,
                    "lm_logits_rel_err_vs_attend": lm["logits_rel_err"],
                    "plan_build_s": t_plan, "scale": args.scale,
                    "r_rel_err_vs_unfused": err_rel,
                    "wide_r_rel_err_vs_unfused": wide["r_rel_err"],
                    "tall_r_rel_err_vs_unfused": tall["r_rel_err"],
                    "launches_per_qr": {"qr_f32": per_qr,
                                        "wide_qr_f64": wide["per_qr"],
                                        "tall_blocked_qr_f64": tall["per_qr"]},
                    "tall_peak_gib": tall["peak_gib"],
                    "first_call_ms": {"wide_qr_f64": wide["first_call_ms"],
                                      "tall_blocked_qr_f64":
                                          tall["first_call_ms"]},
                    "graph_vs_eager": graphs,
                    "dataset": dataset,
                    "serving": serving,
                    "distribution": distribution,
                    "memory": memory,
                    "profile_per_qr": {"qr_f32": prof_qr, "qr_f64": prof_qr64,
                                       "wide_qr_f64": wide["profile"],
                                       "tall_blocked_qr_f64": tall["profile"]},
                    "random_panels": random_panels,
                    "random_passes": {k: {e: v[e] for e in (
                        "max_rel_err", "dead_max", "ms", "bound_ms")}
                        for k, v in random_passes.items()},
                    "flash_cases_bound_ratio": flash_case_err,
                    "lm_train": train,
                    "lm_train_mesh": train_mesh,
                    "lm_serve_mesh": serve_mesh,
                    "moe_ssm": {n: {k: v for k, v in r.items()
                                    if k != "flash"}
                                for n, r in moe_ssm.items()},
                    "enc_dec": {n: {k: v for k, v in r.items()
                                    if k != "flash"}
                                for n, r in enc_dec.items()},
                    "lm32_eval_step_ms": lm32["step_ms"],
                    "lm32_loss": lm32["loss"],
                    "build_spill_bytes": build["spill_bytes"],
                    "flash_sm90_hgmma": build["hgmma"],
                    "flash_mma_tf32_instructions": build["tf32_mma"],
                    "flash_mma_dmma_instructions": build["dmma"],
                    "small_gram_rel_err": gram_rel,
                    "elapsed_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
