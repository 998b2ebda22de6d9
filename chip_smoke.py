#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version (the integer kernels bit for bit,
the float kernels 9 and 10 within rtol 1e-5, atol 1e-5, kernel 6 within
2e-5 in float32 and 3e-2 in bfloat16, lse included, with k and v grouped
(GQA) or not, kernels 7 and 8 on the same grouped k, v within 2e-4 in
float32 and, in bfloat16, 3e-2 of the largest magnitude in each row of
head-dim values (one query row of dq, one key of dk, dv) plus 1e-5 of the
gradient's largest; kernels 6, 7 and 8 also bit for bit from one run to
the next), then drives the port's reachability serving path through
``repro_torch.reach.QuerySession``, its three model serving paths, the
GNN, recsys and LM training paths and the fault-tolerant Trainer on the
card:

  main     the default IndexSpec (k=2, FERRARI-G, c=4, 32 seeds: k_max ≤ 8,
           one seed word, ELL width ≤ 32 — the ferrari-web widths) over
           scale_free_digraph(4M, 4.0); 2^20 random + 2^17 positive
           queries in micro-batches of 16384 (kernel 1).
  wavefront  the device build (builder="wavefront", top-gap cover, the
           default widths: slab W = 8, merge chunk 64, m_cap 2049) of the
           main graph on the card (kernel 5 in every wave and every
           tree-reduction round), every kernel-5 call held against its
           plain version, then save_index → QuerySession.load and the
           main phase's queries, whose answers must equal the main
           phase's (kernel 1).
  distributed (gloo pair)  two gloo ranks sharing cuda:0 (subprocesses,
           a FileStore under build/) load the wavefront phase's artifact
           as a sharded 1x2 and then a replicated 2x1 ``QuerySession``
           (``IndexSpec(placement=..., mesh=...)``) and serve 2^17 random
           and 2^14 forward-walk pairs: every rank's answers and phase mix
           equal the one-device session's (the sharded one through kernel
           1's owned-rows entry and kernel 3's exchanged-rows entry).
  phase2   a weak index (k=1, no seeds) over 1M nodes with the sparse
           phase 2, at the default frontier cap and at cap 256, which
           forces the overflow retry (kernels 1, 3, 4). At the default
           cap each expansion call is one CUDA graph: kernels 3 and 4
           launch once a BFS step, set-up and clean-up once a call (as
           the kernels count their own launches on the device) and the
           host syncs once a call (checked); steps, syncs and launches a
           step are printed, the profiler's launches beside the
           kernels' counts, and one call is split by part on host clocks
           at the graph call's own marks.
  churn    live updates on the wavefront phase's loaded session, bound
           to its artifact: 4 insert batches of 1,024 edges (the default
           overlay_cap 4096; tails before the giant component in
           topological order, so the condensation stays a DAG), 2^17
           random queries after each over the union graph (kernels 1, 3,
           4 with kernel 4's overlay rule; one CUDA graph and one sync an
           expansion call, checked); each batch's largest and smallest
           overlay calls replayed and held word for word; a reload that
           replays the delta log, compact() (kernel 5 in every affected
           wave, each call held against its plain version; builder
           "compact", fewer waves than the schedule), the compacted index
           against the host DFS, a reload of epoch 1: the same answers
           throughout; every stage's seconds.
  seeds64  a weak index (k=1) with 64 seeds over 1M nodes: the 12-array
           layout, in phase 1 and in the sparse phase 2 (kernels 2, 3, 4;
           stepped from the host, a sync a step).
  dense    the dense phase 2 on a graph of ≤ 8192 condensed nodes, then
           one churn round (256 negative pairs inserted as edges; the
           answers held against the brute-force closure of the condensed
           union graph); steps, syncs and ms of the dense phase 2, base
           and overlay.
  recsys   MIND at its published widths (2^23-item table, D 64, 4
           interests, 3 routing rounds, history 50) through
           ``models.api.build_cell``: serve_p99 (512 users), serve_bulk
           (262,144 users) and retrieval_cand (1 user × 1,000,448
           candidates, kernel 10), held against the port's CPU run of the
           same cells on the same state (64 sampled users; every score and
           the top 100).
  gnn      ``models.gnn.forward_dense`` for gin-tu, gcn-cora,
           graphsage-reddit and gatedgcn at full width on the molecule
           shape (128 graphs × 30 nodes), and gin-tu on a bulk batch of
           65,536 molecules (kernel 9, each call's route printed), held
           against the CPU run; a profile of the bulk forward split into
           kernel 9, the SGEMMs and the rest.
  gnn_train  GNN training through ``models.api.build_cell`` at the
           published widths: BatchedMP's backward (kernel 9 on adjᵀ, dy,
           I_H, then the dx and dw GEMMs) against autograd of the plain
           einsums (rtol 1e-5, atol 1e-5 × max|want|); three steps each
           of gin-tu and gatedgcn on molecule (128 graphs; gin-tu also
           65,536), kernel 9 once a gin layer a step forward and once a
           layer but the first backward (the features take no gradient),
           counted; graphsage-reddit on minibatch_lg (169,984 ×
           168,960 padded subgraph, d_feat 602: one NeighborSampler batch
           over the reddit-like graph, then batches at the cell's shape)
           and on ogb_products at full size (2,449,408 nodes, 61,859,328
           edges from scale_free_digraph, d_feat 100), peak memory
           printed; each conv's step cut to 2 layers on a 20k-node graph
           and gin-tu's molecule step, two steps card against CPU.
  recsys_train  MIND's train cell at its published config (2^23 items,
           D 64, 255 negatives) on train_batch (B 65,536), uncut, three
           steps with finite loss and grad norm; the SMOKE config's step
           card against CPU for two steps.
  reach_service  ``data.graph_data.ReachabilityService`` over the
           products-like graph (244,902 nodes): 2^20 candidate pairs
           through ``filter_unreachable_pairs`` on the card (kernels 1,
           3, 4), the kept pairs of a 2^16 sample equal to the host
           QueryEngine's.
  lm       llama3-8b at its published widths and full depth (32 layers,
           bf16, random weights) through ``launch.serve.generate``: the
           prefill_32k prompt of 32,768 tokens (batch cut 32 -> 1; kernel
           6 once per layer) and 32 greedy decode steps from its cache;
           layer 0's attention call (k, v grouped: 8 kv heads) held
           against the plain version on its last 256 query rows and timed
           whole beside SDPA on the same tensors and on k, v expanded to
           32 heads; then the same widths cut to 2 layers in float32, a
           512-token prompt and 8 decode steps, card against CPU.
  moe      the MoE LMs with the int8 KV cache through
           ``launch.serve.generate``: moonshot-v1-16b-a3b at its published
           config (48 layers, 64 experts top 6, bf16, 56.1 GB of random
           weights) on one prompt of 16,384 tokens (prefill_32k's 32 x
           32,768 cut by the card's memory; kernel 6 once per layer), the
           cache re-encoded to int8, 32 greedy decode steps; the tokens
           each expert took and the share of assignments dropped by
           capacity, per prefill and per decode step; layer 0's attention
           call (16 heads over 16 kv heads) held against the plain version
           on its last 256 query rows and timed beside SDPA; the int8
           decode attention at layer 0 against the same step over the
           bf16 cache (rtol = atol = 5e-2); then phi3.5-moe-42b-a6.6b at
           full width with 24 of its 32 layers (62.9 GB): a 4,096-token
           prompt, 16 decode steps, its grouped (G 4) layer-0 call held
           and timed the same way; then moonshot's widths cut to 2 layers
           in float32, a 512-token prompt and 8 int8 decode steps, card
           against CPU: logits, the route and [E, C] token tables, the
           int8 caches.
  train    tinyllama-1.1b at its published widths and full depth (22
           layers, bf16, remat, 4 microbatches) through
           ``launch.train.Trainer`` on train_4k (seq 4096; batch cut 256
           -> 16): one warm-up step, then 3 timed steps, each with
           exactly 176 launches of kernel 6 (remat runs each layer's
           forward twice) and 88 of kernels 7 and 8; layer 0's backward
           call (k, v grouped: 4 kv heads) held against the plain version
           on its sequence 0 and timed whole beside SDPA's backward on the
           same grouped tensors and on k, v expanded to 32 heads; kernels
           7 and 8 at one llama3-8b layer call (q [1, 4096, 32, 128], k, v
           [1, 4096, 8, 128] bf16, random) held against the plain version
           and timed the same way; layer 0's forward call (kernel 6)
           timed beside SDPA; a profiled step; one
           ``CheckpointManager.save`` of the whole state and its
           ``restore_latest``, bit for bit, with the bytes and seconds;
           then the same widths cut to 2 layers in float32 (batch 2 x seq
           512, 2 microbatches), two steps, card against CPU, and the
           Trainer over 6 steps with a checkpoint every 2 and a
           WorkerFailure injected at step 5: its losses and state against
           an uninterrupted run's, bit for bit when two uninterrupted runs
           agree bit for bit.
  moe_train
           MoE training: moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b at
           their published widths (bf16, remat, 4 microbatches), depth
           cut to 2 layers, through ``launch.train.Trainer`` on train_4k
           (batch cut 256 -> 16): a warm-up step, then 3 timed steps with
           kernels 6, 7 and 8 in every layer (16 and 8 launches a step),
           the tokens each expert took and the share of assignments
           dropped a layer, peak memory; layer 0's backward call (G 1 and
           G 4, hd 128) held against the plain version on its sequence 0
           and timed whole beside SDPA's backward; expert parallelism at
           world 1 over NCCL (mesh 1x1): the MoE FFN on moonshot's
           full-width layer 0 against the gather path bit for bit, and a
           train step of the recovery cut through build_cell(mesh=)
           against the same without a mesh; then moonshot's widths cut to
           2 layers in float32 (batch 2 x seq 256), one step card against
           CPU (the CPU taking the card's routes, which may differ only
           within ROUTE_TIE of a tie): the loss, m (every leaf's
           gradient), v and the params; and the Trainer's recovery from a
           WorkerFailure at step 5 on moonshot's MoE spec at SMOKE widths
           (head dim 64), bit for bit.
  sharded_train
           sharded and elastic training of tinyllama-1.1b (one card, so in
           three ways): the Trainer on a world-1 NCCL mesh (1x1,
           ``launch.mesh.make_debug_mesh``) at the published config and
           full depth (22 layers, bf16, remat, 4 microbatches; train_4k's
           batch 256 -> 16), 2 steps, against the Trainer without a mesh,
           losses and every leaf bit for bit, no collective launched; then
           two gloo ranks sharing cuda:0 (subprocesses, a FileStore under
           build/) at the published widths, depth 22 -> 2: float32, batch
           2 x 512 (1 microbatch), meshes 1x2 (tensor parallel: 16 of
           the 32 heads and 2 of the 4 kv heads a rank, vocab-parallel
           embedding and loss) and 2x1 (data parallel, ZeRO-1), 2 steps
           each, every leaf's block of its spec's shape, the state
           gathered on rank 0 against the one-device steps on the card
           (loss rtol 1e-4; m, v rtol 1e-4, atol 1e-5 x max|want|; params
           atol 2 lr); bf16, batch 16 x 4096, 4 microbatches, remat, both
           meshes, a warm-up and 2 timed steps (s, tokens/s with the two
           ranks sharing the card, peak memory a rank, collectives and
           bytes a step by name, launches of kernels 6-8 a step, checked);
           rank 0's layer-0 call at 1x2 (q [4, 4096, 16, 64], k, v [4,
           4096, 2, 64]) held against the plain version on sequence 0 and
           timed beside SDPA (forward and backward); the elastic Trainer
           on the float32 cut from 2x1 (ElasticMeshManager(prefer_model=
           1), a checkpoint every 2 steps) with worker 1 failing at step
           5: rank 1 leaves, rank 0 re-meshes to one device, restores step
           4 and finishes 6 steps, its losses and state bit for bit those
           of a one-device Trainer resumed from that checkpoint;
           ``compressed_psum`` of 2^20 float32 a rank within 4 x scale of
           the exact sum and equal to the CPU tensors' bit for bit, and
           ``pipeline_forward`` over 2 stages against the sequential
           forward. Cuts: depth 22 -> 2 and batch 256 -> 16 on the pair
           (two ranks' state and activations on one card), batch 256 -> 2
           and seq 4096 -> 512 in the float32 parts.
  sharded_cells
           every other cell kind on a mesh (one card, so in two ways):
           world 1 over NCCL (mesh 1x1) at the published configs —
           llama3-8b's prefill of 32,768 tokens and 32 greedy decode
           steps at batch 1 (32 layers), graphsage-reddit's ogb_products
           train step uncut, MIND's retrieval_cand — each against the
           same without a mesh, bit for bit, with no collective (a step
           that two runs without a mesh do not repeat bit for bit, its
           segment sums' atomics, within the model phases' tolerance);
           then two gloo ranks sharing cuda:0 (subprocesses, a FileStore
           under build/) at the published widths, depth cut to 2 layers:
           llama3-8b at 1x2 (a float32 cut, prompt 1024 and 8 decode
           steps, held against one device at rtol 1e-4 / atol 1e-5 x
           max|want|: every step's logits and the cache gathered; then
           bf16, the prefill of 32,768 tokens with the heads and the
           vocab over 'model' and 32 decode steps with the cache's
           sequence split over the two ranks, timed; rank 0's layer-0
           call of kernel 6, q [1, 32768, 16, 128], k, v [1, 32768, 4,
           128], held against the plain version on its last rows and
           timed beside SDPA), moonshot-v1-16b-a3b at 1x2 (attention over
           'model', experts over the model ranks: a float32 cut at 1
           layer (memory), prompt 512 and a train step of 4 x 256, held;
           bf16, a prefill of 16,384 and a train step of 4 x 4096,
           timed), gin-tu's molecule
           cell at 2x1 (batch 128 -> 65,536, kernel 9 forward and
           backward on a rank's 32,768 graphs, timed beside the cuBLAS
           pair), graphsage-reddit's minibatch_lg at 2x1, MIND's
           train_batch at 1x2 (the table's rows over 'model'; batch
           65,536 -> 8,192) and retrieval_cand at 2x1 (kernel 10 on a
           rank's 500,224 candidates, timed beside the library pair; the
           top 100 items agreeing with one device), the train steps held
           against one device's at the train phases' tolerances; each
           step's seconds (the two ranks share one card: the collectives
           go through the host and say nothing of NVLink), peak memory a
           rank, and collectives and bytes by name.
  ferrari  ferrari-web (the paper's own system) at its published n =
           16,777,216, after every other phase is driven and timed and
           the card's cache emptied: a condensed DAG
           (scale_free_digraph(2^24, 4.0, back_p=0)) indexed at the arch's
           widths (IndexSpec.from_config, precondensed) through
           reach.build with the device builder (kernel 5; the host
           builder's sweep takes longer than the run may at this n),
           stage seconds from its trace spans, then a QuerySession over
           it; the classify_16m and classify_100k cells (kernel 1 on the
           fused tables, one launch each) held against the engine's
           classify of the same ids, 2^16 of them against kernel 1's plain
           version on the CPU and the host DFS (every POS reachable, every
           NEG not); kernel 1 timed at the classify_16m call; then 2^20
           pairs through the async frontend (8 tenants, 64-pair requests,
           the default deadline; one request in 16 of forward-walk pairs)
           over the session with tracing on (kernels 1, 3, 4): every
           ticket against QuerySession.query, every phase-2 answer and
           2,000 others against the host DFS, kernels 3 and 4 word for
           word on every step of the frontend's largest, smallest and
           first overflowing expansion calls, one slab span a slab in the
           Chrome trace under build/, the registry's reach_frontend,
           reach_session and reach_engine samples equal to their stats
           objects. Before the frontend, the distributed phase on this
           index: world 1 over NCCL (mesh 1x1, a FileStore under build/),
           the classify_16m cell's sharded step (kernel 1's owned-rows
           entry, one launch) against the replicated cell's verdicts and
           timed, a sharded QuerySession over 2^15 random pairs (phase 2
           stepped from the host: kernel 3's exchanged-rows entry, kernel
           4 as mark and emit) against the one-device session's answers
           and phase mix, with its steps, syncs and launches; the owned
           entry on the 2^16 sample against its plain version on the CPU;
           2^12 of the pairs served again with every exchanged-rows step
           held word for word against its plain version.

  dryrun   inside the train, lm, gnn_train, recsys and ferrari phases:
           ``repro_torch.launch.dryrun`` at --mesh none (the step on
           meta tensors, on the host) at the phase's own cut — tinyllama
           train_4k at batch 16, llama3-8b prefill_32k at batch 1, gin-tu
           molecule at 65,536 graphs, MIND retrieval_cand, ferrari-web
           classify_16m on the phase's tables — then one real step of the
           same cell: each kernel's launches must equal the prediction
           and the aten FLOPs that ``dryrun.flop_counter()`` counts over
           the real step the predicted ones; the peak device memory is
           held within 10% or 256 MiB of the prediction and a miss is
           printed, not fatal. A ``{"dryrun": ...}`` line before the
           card's line holds the five.

Every phase sets the launch counters to 0 just before it is driven and
reads them just after; the reachability phases hold their answers against
the host guided DFS (``core.query.QueryEngine``), and kernels 1 and 2
against their plain versions on each phase's largest and smallest calls;
the model phases against the CPU (rtol 1e-4, atol 1e-5 times the output's
largest magnitude, at least 1). Kernels 3 and 4 are held word for word
(the whole step state) against their plain versions on a random step of
2^20 candidates, on every step of the phase2, seeds64 and ferrari
frontend's largest and smallest expansion calls and first overflowing
one (each replayed step by step with the kernels' own wrappers, its
answers equal to the served call's), and on a call whose sources are the
phase2 index's hubs (the COO tail swept). Any mismatch or exception exits non-zero.
The main phase also splits one micro-batch of ``QuerySession.query`` by
part on host clocks. Each kernel is timed at its path's largest call
(kernels 3 and 4 at the phase2 step of most candidates); kernels 1 and 2
also at the 2^20-query parity calls (K 1, 8, 32) and kernel 1 at the
dense phase's largest call, and kernels 1 to 4 beside their launch floor
(``zero_()`` of an output as large, timed the same way).
``--ferrari-only`` runs the kernels' build and the ferrari phase alone
and prints no result lines; only with it, ``--ferrari-nodes`` cuts the
phase's graph. ``--moe-only``, ``--moe-train-only``,
``--sharded-train-only`` and ``--sharded-cells-only`` do the same for
the moe, moe_train, sharded_train and sharded_cells phases;
``--dryrun-only`` runs the dry run's check alone on the five cells
(after a warm-up step each; ferrari-web on random tables of the
published n) and prints its line.
The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": ...}``. Without a CUDA device,
or without the repository's ``src/`` beside this file, it exits 1 and
prints no result.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BUILD_DIR = ROOT / "build"     # gitignored: kernels, temporary index
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
ALU_OPS_PER_S = 67e12          # 32-bit non-tensor peak (H100 SXM)
BF16_TENSOR_OPS_PER_S = 989e12  # dense bf16 tensor-core peak (H100 SXM)
PARITY_ROWS = 1 << 20
MAIN_NODES = 4_000_000
SIDE_NODES = 1_000_000
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)    # float kernels vs plain
# model paths, card vs CPU: rtol 1e-4 and atol 1e-5 times the output's
# scale (its largest magnitude, at least 1), since a readout or a score
# near zero keeps the rounding of terms as large as that scale
FORWARD_RTOL, FORWARD_ATOL = 1e-4, 1e-5
GNN_ARCHS = ("gin-tu", "gcn-cora", "graphsage-reddit", "gatedgcn")
GNN_BULK_GRAPHS = 65_536
# kernel 6 vs plain: the reference tests' tolerances (the kernel rounds
# the softmax numerators to bfloat16 before the product with v, as the
# TPU kernel does; the plain version does not)
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}
FLASH_SHAPES = (
    # (b, sq, sk, h, kv, hd, causal, q_offset): the reference tests' sweep
    # (ragged S, cross shapes, q_offset 192, hd 64 and 128, one kv head a
    # query head), S = 70 with its short causal rows, a ragged
    # continuation, llama3-8b's 32 heads at hd 128; then grouped k, v read
    # in place: llama3-8b's G 4 at hd 128, tinyllama's G 8 at hd 64, a
    # ragged non-causal G 2 and G 2 at hd 128, G 8 at hd 128 and G 4 at hd
    # 64 (ragged, at an offset)
    (1, 128, 128, 2, 2, 64, True, 0), (2, 256, 256, 1, 1, 128, True, 0),
    (1, 130, 190, 2, 2, 64, True, 0), (1, 64, 512, 1, 1, 64, False, 0),
    (2, 64, 256, 2, 2, 64, True, 192), (1, 96, 96, 3, 3, 128, False, 0),
    (1, 70, 70, 1, 1, 64, True, 0), (1, 37, 300, 2, 2, 128, True, 100),
    (1, 2048, 2048, 32, 32, 128, True, 0),
    (1, 1000, 1000, 32, 8, 128, True, 0), (2, 700, 700, 32, 4, 64, True, 0),
    (1, 300, 333, 4, 2, 64, False, 0), (1, 300, 333, 4, 2, 128, True, 50),
    (1, 200, 260, 8, 1, 128, True, 3), (1, 257, 257, 8, 2, 64, True, 0))
LM_ARCH = "llama3-8b"
LM_DECODE = 32                 # greedy decode steps after the prefill
LM_PARITY_ROWS = 256           # last query rows of layer 0 vs plain
# kernel 6 on the path's own call: over 32,768 keys a typical |out| is
# ~0.01, so out is held at 3e-2 relative to the output's largest
# magnitude (lse keeps FLASH_TOL: its values are ~10)
LM_OUT_TOL = 3e-2
# bfloat16 decode attention vs the same inputs in float32: both take
# float32 scores; p and out are rounded to bfloat16 (2^-9 each)
DECODE_TOL = dict(rtol=1e-2, atol=1e-2)     # atol times max|want|
LM_CHECK = dict(layers=2, prompt=512, steps=8)   # card vs CPU, float32
# kernels 7 and 8 vs plain: float32 at the reference's tolerance against
# its oracle; bfloat16 relative to the largest magnitude in each row of the
# gradient (both round P and dS to bfloat16 before the products;
# bwd_row_atol)
FLASH_BWD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# ... plus this share of the tensor's largest magnitude: a row that is 0 in
# exact arithmetic (query row 0 of a causal call at q_offset 0 sees one
# key, so dS = P·(dP - delta) cancels) holds float32 rounding noise, well
# under this floor (flash_bwd_parity prints it)
BWD_NOISE_FLOOR = 1e-5
# the moe phase: moonshot at its published config on one prompt of 16,384
# tokens (prefill_32k's 32 x 32,768 cut: 56.1 GB of weights, a 6.5 GB
# bf16 prefill cache and its 3.3 GB int8 copy fit the card, 32,768 tokens
# do not); phi3.5-moe at full width, 24 of its 32 layers (83.7 GB at 32)
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_PROMPT = 16_384
MOE_DECODE = 32
MOE_PHI = dict(arch="phi3.5-moe-42b-a6.6b", layers=24, prompt=4096,
               steps=16)
MOE_CHECK = dict(layers=2, prompt=512, steps=8)   # card vs CPU, float32
# int8 decode attention vs the same step over the bf16 cache: the
# reference's own tolerance (tests/test_kv_int8.py)
INT8_DECODE_TOL = dict(rtol=5e-2, atol=5e-2)
ROUTE_TIE = 1e-6            # K-th minus (K+1)-th probability: a near tie
ROUTE_TIE_SHARE = 1e-3      # at most this share of tokens near a tie
INT8_OFF_SHARE = 1e-4       # int8 values one quantum apart, card vs CPU
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH = 16               # train_4k's batch 256 cut to 4 x 4 sequences
TRAIN_STEPS = 3                # timed, after one warm-up step
TRAIN_CHECK = dict(layers=2, batch=2, seq=512, microbatches=2)  # card vs CPU
# kernels 7 and 8 at hd 128, which no path runs at full width yet: one
# llama3-8b layer's backward call on train_4k's sequence (b, s, h, kv, hd)
BWD_HD128_CALL = (1, 4096, 32, 8, 128)

KERNELS = {
    "stab_packed": dict(
        source="src/repro_torch/csrc/interval_stab.cu",
        replaces="src/repro/kernels/interval_stab.py:117", phase="main"),
    "stab_naive": dict(
        source="src/repro_torch/csrc/interval_stab.cu",
        replaces="src/repro/kernels/interval_stab.py:149", phase="seeds64"),
    "probe": dict(
        source="src/repro_torch/csrc/frontier.cu",
        replaces="src/repro/kernels/frontier_fused.py:60", phase="phase2"),
    "classify_emit": dict(
        source="src/repro_torch/csrc/frontier.cu",
        replaces="src/repro/kernels/frontier_fused.py:78", phase="phase2"),
    "merge_cover": dict(
        source="src/repro_torch/csrc/merge_cover.cu",
        replaces="src/repro/kernels/merge_cover.py:153", phase="wavefront"),
    "retrieval_score": dict(
        source="src/repro_torch/csrc/retrieval_score.cu",
        replaces="src/repro/kernels/retrieval_score.py:32", phase="recsys",
        also=("sharded_cells",)),
    # the source of kernel 9's route at its largest call (set in main)
    "batched_mp": dict(
        source="src/repro_torch/csrc/batched_mp_mma.cu",
        replaces="src/repro/kernels/batched_mp.py:31", phase="gnn",
        also=("sharded_cells",)),
    # kernel 9 as its own backward (BatchedMP: adjᵀ, dy, I_H), in the
    # dense-batch train step, which the reference differentiates through
    # its plain einsums (use_pallas=False)
    "batched_mp_bwd": dict(
        source="src/repro_torch/csrc/batched_mp_mma.cu",
        replaces="src/repro/kernels/batched_mp.py:31",
        call="src/repro/models/api.py:278", phase="gnn_train",
        also=("sharded_cells",)),
    # also on the moe phase's prefills (moonshot, phi3.5-moe) and the
    # moe_train phase's steps
    "flash_fwd": dict(
        source="src/repro_torch/csrc/flash_fwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:101", phase="lm",
        also=("moe", "moe_train", "sharded_train", "sharded_cells")),
    "flash_bwd_dq": dict(
        source="src/repro_torch/csrc/flash_bwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:172",
        call="src/repro/kernels/flash_attention.py:207", phase="train",
        also=("moe_train", "sharded_train", "sharded_cells")),
    "flash_bwd_dkv": dict(
        source="src/repro_torch/csrc/flash_bwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:172",
        call="src/repro/kernels/flash_attention.py:224", phase="train",
        also=("moe_train", "sharded_train", "sharded_cells")),
    # the sharded placement's entries of kernels 1 and 3: the reference's
    # kernels on gathered rows inside its shard_map
    "stab_packed_owned": dict(
        source="src/repro_torch/csrc/interval_stab.cu",
        replaces="src/repro/kernels/interval_stab.py:117",
        call="src/repro/core/distributed.py:132", phase="distributed"),
    "probe_rows": dict(
        source="src/repro_torch/csrc/frontier.cu",
        replaces="src/repro/kernels/frontier_fused.py:60",
        call="src/repro/core/distributed.py:204", phase="distributed"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ inputs ----
def _seed_words(g, shape, dev):
    import torch
    bit = torch.randint(0, 32, shape, generator=g, device=dev,
                        dtype=torch.int32)
    word = torch.where(bit == 31, torch.iinfo(torch.int32).min,
                       torch.bitwise_left_shift(torch.ones_like(bit),
                                                bit.clamp(max=30)))
    on = torch.rand(shape, generator=g, device=dev) < 0.3
    return torch.where(on, word, 0).to(torch.int32)


def packed_tables(g, n, k, dev):
    """Random meta [n, 4] / slab [n, 2K] rows: levels across the sign bit
    and saturated at 255, exact flags in the begins' sign bit, INVALID
    pads, sparse seed words, intervals placed around other rows' π."""
    import torch
    i32 = dict(device=dev, dtype=torch.int32)
    pi = torch.randint(0, 1 << 24, (n,), generator=g, **i32)
    lvl = torch.tensor([0, 1, 5, 127, 128, 200, 254, 255], **i32)[
        torch.randint(0, 8, (n,), generator=g, device=dev)]
    # level byte over the sign bit: build the word in int64, wrap to int32
    word0 = (pi.long() | (lvl.long() << 24)).to(torch.int32)
    tau = torch.randint(0, 1000, (n,), generator=g, **i32)
    meta = torch.stack([word0, tau, _seed_words(g, (n,), dev),
                        _seed_words(g, (n,), dev)], dim=1).contiguous()
    near = pi[torch.randint(0, n, (n, k), generator=g, device=dev)]
    b = (near - torch.randint(0, 8, (n, k), generator=g, **i32)).clamp(min=0)
    e = near + torch.randint(0, 8, (n, k), generator=g, **i32)
    far = torch.rand((n, k), generator=g, device=dev) < 0.5
    b = torch.where(far, torch.randint(0, 1 << 24, (n, k), generator=g,
                                       **i32), b)
    e = torch.where(far, b + torch.randint(0, 1 << 20, (n, k), generator=g,
                                           **i32), e)
    invalid = torch.rand((n, k), generator=g, device=dev) < 0.2
    exact = (torch.rand((n, k), generator=g, device=dev) < 0.3) & ~invalid
    b = torch.where(invalid, 2**31 - 1, b)
    e = torch.where(invalid, -1, e)
    braw = torch.where(exact, b | torch.iinfo(torch.int32).min, b)
    return meta, torch.cat([braw, e], dim=1).contiguous()


def query_pairs(g, n, q, dev):
    import torch
    cs = torch.randint(0, n, (q,), generator=g, device=dev,
                       dtype=torch.int32)
    ct = torch.randint(0, n, (q,), generator=g, device=dev,
                       dtype=torch.int32)
    ct[: q // 8] = cs[: q // 8]                 # the cs == ct fold
    return cs, ct


def naive_tables(g, n, k, w, dev):
    import torch
    i32 = dict(device=dev, dtype=torch.int32)
    pi = torch.randint(0, 1 << 26, (n,), generator=g, **i32)
    tau = torch.randint(0, 1000, (n,), generator=g, **i32)
    lvl = torch.randint(0, 400, (n,), generator=g, **i32)
    near = pi[torch.randint(0, n, (n, k), generator=g, device=dev)]
    b = (near - torch.randint(0, 8, (n, k), generator=g, **i32)).clamp(min=0)
    e = near + torch.randint(0, 8, (n, k), generator=g, **i32)
    invalid = torch.rand((n, k), generator=g, device=dev) < 0.2
    b = torch.where(invalid, 2**31 - 1, b).contiguous()
    e = torch.where(invalid, -1, e).contiguous()
    x = ((torch.rand((n, k), generator=g, device=dev) < 0.3)
         & ~invalid).to(torch.int32)
    return (pi, tau, lvl, b, e, x, _seed_words(g, (n, w), dev),
            _seed_words(g, (n, w), dev))


def cover_rows(g, rows, m, dev):
    """Begin-sorted rows [rows, m] for kernel 5: a random number of valid
    slots per row (INVALID tails, some rows empty), begins drawn from a
    range of 4m so that intervals overlap, touch, nest and tie."""
    import torch
    i32 = dict(device=dev, dtype=torch.int32)
    b = torch.sort(torch.randint(0, 4 * m, (rows, m), generator=g, **i32),
                   dim=1).values
    e = b + torch.randint(0, 6, (rows, m), generator=g, **i32)
    x = (torch.rand((rows, m), generator=g, device=dev) < 0.5).to(
        torch.int32)
    n_valid = torch.randint(0, m + 1, (rows, 1), generator=g, device=dev)
    dead = torch.arange(m, device=dev)[None, :] >= n_valid
    return (torch.where(dead, 2**31 - 1, b).contiguous(),
            torch.where(dead, -1, e).contiguous(),
            torch.where(dead, 0, x).contiguous())


# ------------------------------------------------------------ parity ----
def close_stats(got, want, rtol: float, atol: float):
    """(max_abs_err, mismatches, max_rel_err) of float tensors: an element
    mismatches when |got - want| > atol + rtol·|want| or exactly one is
    NaN; the relative error is taken where |want| > atol."""
    import torch
    got, want = got.double(), want.to(got.device).double()
    diff = (got - want).abs()
    nan = torch.isnan(got) != torch.isnan(want)
    both = torch.isnan(got) & torch.isnan(want)
    diff = torch.where(both, 0.0, diff)
    bad = int(((diff > atol + rtol * want.abs()) & ~both).sum()
              + nan.sum())
    if not got.numel():
        return 0.0, bad, 0.0
    big = want.abs() > atol
    rel = float((diff[big] / want[big].abs()).max()) if big.any() else 0.0
    return float(diff.nan_to_num(0.0).max()), bad, rel


def _compare(name, got, want, tol=KERNEL_TOL):
    """Parity of a kernel's outputs with its plain version's: exact for
    integers, within ``tol`` for floats. Returns (max_abs_err,
    mismatches, max_rel_err)."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    if got[0].is_floating_point():
        stats = [close_stats(a, b, **tol) for a, b in zip(got, want)]
        err = max(s[0] for s in stats)
        bad = sum(s[1] for s in stats)
        rel = max(s[2] for s in stats)
        atol = tol["atol"]
        what = (f"max abs err {err:.3e}, max rel err {rel:.3e} (rtol "
                f"{tol['rtol']}, atol "
                f"{atol if isinstance(atol, float) else 'per row'})")
    else:
        bad = sum(int((a != b).sum()) for a, b in zip(got, want))
        err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                  for a, b in zip(got, want))
        rel, what = 0.0, "bit for bit"
    print(f"  parity {name}: {tuple(got[0].shape)}, {bad} mismatches, "
          f"{what}", flush=True)
    check(bad == 0, f"{name} disagrees with its plain version")
    return err, bad, rel


def _tally(total: dict, name: str, result) -> None:
    err, bad, rel = result
    total[name] = (max(total[name][0], err), total[name][1] + bad,
                   max(total[name][2], rel))


def stab_parity(g, dev, err: dict) -> dict:
    """Kernels 1 and 2 against their plain versions at 2^20 queries over
    2^22 rows, K 1, 8 and 32 (W 2), tallied into ``err``. Returns the
    calls, {(name, K): (rows, args)}, for timing."""
    from repro_torch.kernels import interval_stab as st
    n, kept = 1 << 22, {}
    for k in (1, 8, 32):
        meta, slab = packed_tables(g, n, k, dev)
        cs, ct = query_pairs(g, n, PARITY_ROWS, dev)
        print(f"  stab_packed K={k}: saturated-level rows "
              f"{int(((meta[cs.long(), 0] >> 24) & 0xFF).eq(255).sum())}, "
              f"exact-flag slots {int((slab[cs.long(), :k] < 0).sum())}",
              flush=True)
        _tally(err, "stab_packed", _compare(
            f"stab_packed K={k}", st.stab_packed(meta, slab, cs, ct),
            st.stab_packed_plain(meta, slab, cs, ct)))
        tables = naive_tables(g, n, k, 2, dev)
        _tally(err, "stab_naive", _compare(
            f"stab_naive K={k} W=2", st.stab_naive(*tables, cs, ct),
            st.stab_naive_plain(*tables, cs, ct)))
        kept[("stab_packed", k)] = (PARITY_ROWS, (meta, slab, cs, ct))
        kept[("stab_naive", k)] = (PARITY_ROWS, (*tables, cs, ct))
    return kept


def kernel_parity(dev):
    """Each kernel against its plain version on random inputs (≥ 2^20
    rows where a row is small): {name: (max_abs_err, mismatches,
    max_rel_err)}, and kernels 1 and 2's calls (``stab_parity``)."""
    import torch

    from repro_torch.kernels import frontier_fused as ff
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    err = {name: (0, 0, 0.0) for name in KERNELS}
    stab_calls = stab_parity(g, dev, err)
    # kernels 3 and 4: one step of 256 queries over 2^20 nodes, a front of
    # 16,384 entries by ELL width 64 (2^20 candidates), cap 16,384 (kernel
    # 4's one-block form at its largest), overflowing
    hold_step(random_step(g, dev), "random 2^20-candidate step", err)
    # the same with a live overlay's can_reach_tail (kernel 4's rule)
    hold_step(random_step(g, dev, gate=True), "random 2^20-candidate step "
              "with can_reach_tail", err)
    # kernel 5: the build's working widths, k = w_out as the build calls it
    from repro_torch.kernels import merge_cover as mc
    # (and rows that are no multiple of a block's 128, begins staged up to
    # m 32 and not beyond, outputs staged up to w_out 64 and not beyond)
    for m, k, w_out, rows in ((9, 2, 2, PARITY_ROWS),
                              (9, 8, 8, PARITY_ROWS), (513, 8, 8, 1 << 14),
                              (2049, 8, 8, 1 << 12),
                              (2049, 32, 32, 1 << 12),
                              (9, 8, 8, PARITY_ROWS + 77),
                              (32, 8, 8, 100_003), (33, 8, 8, 100_003),
                              (17, 32, 32, 20_001), (9, 8, 64, 5_000),
                              (9, 8, 65, 5_000)):
        rows_in = cover_rows(g, rows, m, dev)
        plan = mc.plan(m, w_out)
        _tally(err, "merge_cover", _compare(
            f"merge_cover rows={rows} m={m} k={k} w_out={w_out} (begins "
            f"{'staged' if plan['stage_cb'] else 'in device memory'}, "
            f"outputs {'staged' if plan['stage_out'] else 'direct'})",
            mc.merge_cover(*rows_in, k, w_out),
            mc.merge_cover_plain(*rows_in, k, w_out)))
    del rows_in
    # kernel 10: the retrieval widths (D 64, I 4, float4 rows), a scalar
    # path (D 30), more interests than one register pass (I 12), one row
    from repro_torch.kernels import retrieval_score as rs
    for c, d, i in ((PARITY_ROWS + 5, 64, 4), (1 << 16, 30, 5),
                    (1 << 16, 64, 12), (1, 64, 4)):
        cands = torch.randn((c, d), generator=g, device=dev)
        ints = torch.randn((i, d), generator=g, device=dev)
        _tally(err, "retrieval_score", _compare(
            f"retrieval_score C={c} D={d} I={i}",
            rs.retrieval_score(cands, ints),
            rs.retrieval_score_plain(cands, ints)))
    del cands
    # kernel 9: the molecule shape at the GNN widths, the gnn path's four
    # (F, H) at the bulk batch, a last group of pipelines short of graphs
    # (B 1, 3, 127), the tensor-core route's edge (N 64) and the tiled
    # route beyond it (N 65), F and H no multiple of 8, F tiles (N 128)
    # and H tiles (N 200); w glorot-scaled as in the models, and eye
    from repro_torch.kernels import batched_mp as bm
    for b, n, f, h in ((4096, 30, 64, 64), (4096, 30, 16, 128),
                       (1024, 30, 128, 128), (4096, 30, 70, 70),
                       (256, 128, 128, 128), (64, 200, 128, 128),
                       (GNN_BULK_GRAPHS, 30, 16, 16),
                       (GNN_BULK_GRAPHS, 30, 64, 64),
                       (GNN_BULK_GRAPHS, 30, 16, 128),
                       (GNN_BULK_GRAPHS, 30, 128, 128),
                       (1, 30, 64, 64), (3, 30, 64, 64), (127, 30, 64, 64),
                       (256, 64, 64, 64), (256, 65, 64, 64)):
        adj = (torch.rand((b, n, n), generator=g, device=dev) < 0.2).float()
        x = torch.randn((b, n, f), generator=g, device=dev)
        w = torch.randn((f, h), generator=g, device=dev) * (2 / (f + h)) ** 0.5
        label = f"batched_mp B={b} N={n} F={f} ({bm.route(n, f, h)} route)"
        eye = torch.eye(f, device=dev)
        for what, ww in ((f"H={h}", w), ("w=eye", eye)):
            first = bm.batched_mp(adj, x, ww)
            _tally(err, "batched_mp", _compare(
                f"{label} {what}", first, bm.batched_mp_plain(adj, x, ww)))
            check(torch.equal(bm.batched_mp(adj, x, ww), first),
                  f"{label} {what}: a repeat run gave other bits")
        del adj, x, first
    # kernel 6: out and lse, float32 and bfloat16, k and v grouped; the
    # same bits from a second call
    from repro_torch.kernels import flash_attention as fa
    for dtype in ("float32", "bfloat16"):
        for b, sq, sk, h, kv, hd, causal, qo in FLASH_SHAPES:
            q, k, v = (torch.randn((b, s, n, hd), generator=g, device=dev)
                       .to(getattr(torch, dtype))
                       for s, n in ((sq, h), (sk, kv), (sk, kv)))
            kw = dict(causal=causal, q_offset=qo)
            label = (f"{dtype} B={b} Sq={sq} Sk={sk} H={h} KV={kv} hd={hd} "
                     f"causal={causal} q_offset={qo}")
            first = fa.flash_fwd(q, k, v, **kw)
            _tally(err, "flash_fwd", _compare(
                f"flash_fwd {label}", first,
                fa.flash_attention_plain(q, k, v, **kw), FLASH_TOL[dtype]))
            out, lse = fa.flash_fwd(q, k, v, **kw)
            check(torch.equal(out, first[0]) and torch.equal(lse, first[1]),
                  f"flash_fwd {label}: a repeat run gave other bits")
            # kernels 7 and 8 on the forward's own out and lse, k and v
            # grouped (as the autograd backward hands them)
            dout = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
            for name, res in flash_bwd_parity(label, (q, k, v, out, lse, dout,
                                                      causal, qo)).items():
                _tally(err, name, res)
    print(f"  flash_fwd: {2 * len(FLASH_SHAPES)} calls and batched_mp: 30 "
          f"calls gave the same bits on a repeat run", flush=True)
    return err, stab_calls


# the largest |kernel - plain| of kernels 7 and 8 in bfloat16 as a share of
# its element's limit (atol of its row + rtol |want|): 1 is the limit
BWD_ROW_SHARE = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}


def bwd_row_atol(want, rel: float):
    """The bfloat16 atol of kernels 7 and 8: ``rel`` times the largest
    magnitude in each row of head-dim values of ``want`` (dq: one query
    row of one head; dk, dv: one key of one kv head), plus
    ``BWD_NOISE_FLOOR`` of the tensor's largest. Under the causal mask
    the key gradients fall from the first keys to the last, so a limit
    taken over the whole tensor would let a fault confined to late key or
    query tiles pass; a row's own magnitude does not."""
    mag = want.double().abs()
    return (rel * mag.amax(dim=-1, keepdim=True)
            + BWD_NOISE_FLOOR * mag.max())


def flash_bwd_parity(label, args) -> dict:
    """Kernels 7 and 8 on ``args`` = (q, k, v, out, lse, dout, causal,
    q_offset) against ``flash_bwd_plain`` (FLASH_BWD_TOL: float32 within
    2e-4, bfloat16 within rtol 3e-2 and atol ``bwd_row_atol``), and a
    second run that must give the same bits. {name: (max_abs_err,
    mismatches, max_rel_err)}."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, dout, causal, qo = args
    kw = dict(causal=causal, q_offset=qo)
    delta = fa.row_delta(out, dout)
    got = {"flash_bwd_dq": (fa.flash_bwd_dq(q, k, v, dout, lse, delta, **kw),),
           "flash_bwd_dkv": fa.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)}
    want = fa.flash_bwd_plain(q, k, v, out, lse, dout, **kw)
    want = {"flash_bwd_dq": want[:1], "flash_bwd_dkv": want[1:]}
    bf16 = q.dtype == torch.bfloat16
    rel = FLASH_BWD_TOL[str(q.dtype).split(".")[-1]]
    res = {}
    for name in got:
        parts = []
        for what, a, w in zip(("dq",) if name == "flash_bwd_dq" else
                              ("dk", "dv"), got[name], want[name]):
            atol = bwd_row_atol(w, rel) if bf16 else rel
            parts.append(_compare(f"{name} {label}: {what}", a.float(),
                                  w.float(), dict(rtol=rel, atol=atol)))
            if bf16:
                limit = atol + rel * w.double().abs()
                diff = (a.double() - w.double()).abs()
                share = float((diff / limit).masked_fill(diff == 0, 0.0)
                              .max())
                BWD_ROW_SHARE[name] = max(BWD_ROW_SHARE[name], share)
                rows = w.double().abs().amax(dim=-1, keepdim=True)
                top = float(rows.max())
                zero = (rows == 0).expand_as(diff)
                noise = float(diff[zero].max()) / top if zero.any() else 0.0
                print(f"    {what}: largest error {share:.4f} of its "
                      f"element's limit (rtol {rel}, atol {rel} x its "
                      f"row's max|want| + {BWD_NOISE_FLOOR} x max|want|); "
                      f"in rows that are 0 in the plain version, error up "
                      f"to {noise:.3g} x max|want|; the smallest row's max "
                      f"{float(rows.min()) / top:.3g} x max|want|",
                      flush=True)
        res[name] = (max(p[0] for p in parts), sum(p[1] for p in parts),
                     max(p[2] for p in parts))
    again = (fa.flash_bwd_dq(q, k, v, dout, lse, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw))
    first = (*got["flash_bwd_dq"], *got["flash_bwd_dkv"])
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"flash backward {label}: a repeat run gave other bits")
    return res


# ------------------------------------------------------------ timing ----
L2_FLUSH_BYTES = 256 << 20     # > the H100's 50 MB L2


def device_ms(fn, reps: int = 30, cold: bool = True, prep=None) -> float:
    """Median device time of one call from a pair of CUDA events around
    each of ``reps`` calls. All are queued behind a sleep kernel, so host
    launch overhead opens no gaps. With ``cold``, a 256 MiB write before
    each call evicts the L2, so the call reads its inputs from device
    memory, as the bound assumes; without it, repeated calls on the same
    inputs find them in the L2. ``prep`` (outside the events) restores
    what a call changes that the next one reads."""
    import torch
    if prep:
        prep()
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)           # ~50 ms of queued work
    for start, end in events:
        if prep:
            prep()
        if cold:                  # after prep: what prep wrote is evicted
            flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


class Recorder:
    """Wraps the kernel wrappers as the serving path calls them and keeps
    the inputs of the largest call of each (and of the smallest, in
    ``small``), for timing at the path's own shapes. Counting stays in the
    wrappers themselves."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.reset()
        self._orig = {}
        for mod, name in ((ops, "stab_packed"), (ops, "stab_naive"),
                          (ops, "retrieval_score"), (ops, "batched_mp")):
            fn = getattr(mod, name)
            self._orig[(mod, name)] = fn
            setattr(mod, name, self._wrap(name, fn))
        # expand_frontier_overlay goes through expand_frontier
        self._orig[(ops, "expand_frontier")] = ops.expand_frontier
        ops.expand_frontier = self._wrap_expand(ops.expand_frontier)

    ROWS_ARG = {"stab_packed": -2, "stab_naive": -2, "retrieval_score": 0,
                "batched_mp": 0}

    def _wrap_expand(self, fn):
        # kernels 3 and 4 run inside the sparse loop (a graph on the card):
        # keep each expansion call's inputs, its steps and its result, to
        # replay it step by step with the kernels' own wrappers; an
        # overlay call's can_reach_tail apart from the other args. The
        # union tables are rewritten in place by the next add batch:
        # replay a batch's calls before it.
        from repro_torch.kernels import frontier_fused as ff

        def wrapped(dev, *args, **kw):
            before = ff.STEPS["steps"]
            out = fn(dev, *args, **kw)
            if args[4].is_cuda:
                self.expansions.append(dict(
                    dev=dev, args=args, crt=kw.get("can_reach_tail"), kw=kw,
                    pos=out[0].numpy(), overflow=out[1],
                    steps=ff.STEPS["steps"] - before))
            return out
        return wrapped

    def _wrap(self, name, fn):
        # references, not copies: copying would add to the served time;
        # only the probe's visited/pos change afterwards (same shapes).
        # Kernel 9's size is its input elements; calls on CPU tensors (the
        # reference runs) are not kept.
        def wrapped(*args):
            rows = args[self.ROWS_ARG[name]].shape[0]
            size = (args[0].numel() + args[1].numel()
                    if name == "batched_mp" else rows)
            if args[0].is_cuda:
                if name == "batched_mp":
                    shape = tuple(args[1].shape) + (args[2].shape[1],)
                    self.mp_shapes[shape] += 1
                    self.mp_calls.setdefault(shape, (rows, args))
                if size > self.sizes.get(name, (0, 0))[1]:
                    self.calls[name] = (rows, args)
                if size < self.sizes.get(name, (size + 1, 0))[0]:
                    self.small[name] = (rows, args)
                lo, hi = self.sizes.get(name, (size, size))
                self.sizes[name] = (min(lo, size), max(hi, size))
            return fn(*args)
        return wrapped

    def reset(self):
        self.calls = {}
        self.small = {}
        self.sizes = {}
        self.expansions = []
        # kernel 9: calls of each (B, N, F, H), and the first one's inputs
        self.mp_shapes = collections.Counter()
        self.mp_calls = {}

    def close(self):
        for (mod, name), fn in self._orig.items():
            setattr(mod, name, fn)


class BuildRecorder:
    """Wraps kernel 5's wrapper and the prologue of ``merge_cover_rows``
    while the device build runs: keeps every kernel-5 call (inputs and
    the kernel's outputs, by reference) for the parity check, and the
    prologue inputs of the largest call for timing it. Counting stays in
    the wrapper."""

    def __init__(self):
        from repro_torch.core.build import merge_kernels as mk
        from repro_torch.kernels import merge_cover as mc
        self.calls = []
        self.prologue = (0, None)
        kernel, prologue = mc.merge_cover, mk.gather_sorted
        self._orig = [(mc, "merge_cover", kernel),
                      (mk, "gather_sorted", prologue)]

        def wrapped_kernel(cb, ce, cx, k, w_out):
            out = kernel(cb, ce, cx, k, w_out)
            self.calls.append(((cb, ce, cx, k, w_out), out))
            return out

        def wrapped_prologue(*args):
            slots = args[3].shape[0] * max(
                args[-1], args[3].shape[1] * args[0].shape[1] + 1)
            if slots > self.prologue[0]:
                self.prologue = (slots, args)
            return prologue(*args)
        mc.merge_cover = wrapped_kernel
        mk.gather_sorted = wrapped_prologue

    def close(self):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


def _distinct(*ids) -> int:
    import torch
    return int(torch.unique(torch.cat(ids)).numel())


def work_of(name, args):
    """(bytes, ops) the call must move and do on this call's data:
    ``repro_torch.kernels.work`` (int32 ops for the reachability kernels,
    flops, 2 per multiply-add, for kernels 6 to 10; each input element
    the result depends on read once, each output written once). Kernels
    3 and 4: ``step_work``."""
    from repro_torch.kernels.work import work
    return work(name, args)


# The yardstick of kernels 9 and 10: no single PyTorch call computes
# either function, so two calls are timed ("2 calls" in the output).
def _scores_pair(cands, interests):
    return (cands @ interests.T).amax(1)


def _mp_pair(adj, x, w):
    import torch
    return torch.bmm(adj, x) @ w


def _mp_bwd_library(adj_t, dy, eye):
    import torch
    return torch.bmm(adj_t, dy)


LIBRARY_PAIRS = {
    "retrieval_score": ("(cands @ interests.T).amax(1), 2 calls",
                        _scores_pair),
    "batched_mp": ("torch.bmm(adj, x) @ w, 2 calls", _mp_pair),
    # the backward call's w is I_H: one bmm computes the same function
    "batched_mp_bwd": ("torch.bmm(adjT, dy), 1 call (w = I_H)",
                       _mp_bwd_library),
}


# kernels timed beside their launch floor: the verdict kernels and the
# BFS step's two, whose path's calls move well under a microsecond of bytes
FLOOR_KERNELS = ("stab_packed", "stab_naive", "probe", "classify_emit",
                 "stab_packed_owned", "probe_rows")


def launch_floor(rows: int) -> tuple:
    """(L2-cold ms, L2-warm ms) of ``zero_()`` on an int32 output of
    ``rows``, through ``device_ms`` as a kernel is timed: what one launch
    between the event pair costs under that protocol, whatever it does."""
    import torch
    out = torch.empty(rows, dtype=torch.int32, device="cuda")
    return (device_ms(out.zero_), device_ms(out.zero_, cold=False))


def time_kernels(recorded: dict, extra: tuple = ()) -> dict:
    """Times each kernel at ``recorded[name]`` (the path's largest call),
    and at each ``(name, label, call)`` of ``extra``, which is printed and
    returned under ``label``. Kernels 1 and 2 also get their launch floor
    (``launch_floor``) on an output of the call's rows; kernels 3 and 4
    are timed by ``time_step_kernels``."""
    from repro_torch.kernels import batched_mp as bm
    from repro_torch.kernels import interval_stab as st
    from repro_torch.kernels import merge_cover as mc
    from repro_torch.kernels import retrieval_score as rs
    plain = {"stab_packed": st.stab_packed_plain,
             "stab_packed_owned": st.stab_packed_owned_plain,
             "stab_naive": st.stab_naive_plain,
             "merge_cover": mc.merge_cover_plain,
             "retrieval_score": rs.retrieval_score_plain,
             "batched_mp": bm.batched_mp_plain,
             "batched_mp_bwd": bm.batched_mp_plain}
    kernel = {"stab_packed": st.stab_packed,
              "stab_packed_owned": st.stab_packed_owned,
              "stab_naive": st.stab_naive,
              "merge_cover": mc.merge_cover,
              "retrieval_score": rs.retrieval_score,
              "batched_mp": bm.batched_mp,
              "batched_mp_bwd": lambda *a: bm._call(*a, "batched_mp_bwd")}
    out = {}
    for name, label, (rows, args) in ([(n, n, recorded[n]) for n in KERNELS
                                       if n in recorded] + list(extra)):
        err = _compare(f"{label} on the path's inputs", kernel[name](*args),
                       plain[name](*args))
        ms = device_ms(lambda: kernel[name](*args))
        warm_ms = device_ms(lambda: kernel[name](*args), cold=False)
        plain_ms = device_ms(lambda: plain[name](*args))
        library, library_ms = None, None
        if name in LIBRARY_PAIRS:
            library, pair = LIBRARY_PAIRS[name]
            library_ms = device_ms(lambda: pair(*args))
        nbytes, ops = work_of(name, args)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ALU_OPS_PER_S * 1e3
        out[label] = dict(rows=rows, ms=ms, warm_ms=warm_ms,
                          plain_ms=plain_ms,
                          library=library, library_ms=library_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else
                          "operations", bytes=nbytes, ops=ops, err=err)
        lib = ("" if library is None else
               f", library {library_ms:.4f} ms ({library})")
        if name in ("batched_mp", "batched_mp_bwd"):
            (_, n, f), h = args[1].shape, args[2].shape[1]
            out[label]["route"] = bm.route(n, f, h)
            lib += f"; {out[label]['route']} route"
        if name in FLOOR_KERNELS:
            floor = launch_floor(rows)
            out[label]["floor_ms"], out[label]["floor_warm_ms"] = floor
            lib += (f"; launch floor {floor[0]:.4f} ms cold, {floor[1]:.4f} "
                    f"ms warm (zero_ of {rows} int32)")
        shapes = " x ".join(str(tuple(a.shape)) for a in args
                            if hasattr(a, "shape"))
        print(f"  time {label}: {rows} rows ({shapes}), kernel {ms:.4f} ms "
              f"(L2 cold; {warm_ms:.4f} ms L2 warm), plain {plain_ms:.4f} "
              f"ms{lib}, bound {out[label]['bound_ms']:.6f} ms ({nbytes} B, "
              f"{ops} ops; {out[label]['bound_by']}), "
              f"{ms / max(rows, 1) * 1e6:.2f} ns/row", flush=True)
    return out


# ------------------------------------------------------------ phases ----
def counters():
    from repro_torch.kernels import _lib
    from repro_torch.kernels import frontier_fused as ff
    return _lib.LAUNCHES, ff.STEPS


def reset_counters():
    for c in counters():
        c.reset()


def read_counters() -> dict:
    launches, steps = counters()
    return {**dict(launches), **{f"sparse_{k}": v for k, v in steps.items()}}


def make_session(g, spec, dev, built=None):
    """Host build + pack (or reuse ``built``) and a session on ``dev``."""
    from repro_torch.core.packed import pack_index
    from repro_torch.reach import QuerySession, build
    t0 = time.perf_counter()
    if built is None:
        ix = build(g, spec)
        pk = pack_index(ix)
        p2 = spec.phase2_mode
        if p2 == "auto":
            p2 = "dense" if pk.n <= spec.n_dense_max else "sparse"
        ell = pk.ell_layout(width=spec.ell_width) if p2 == "sparse" else None
    else:
        ix, pk, ell = built
    sess = QuerySession(ix, spec, packed=pk, ell=ell, device=dev)
    dt = time.perf_counter() - t0
    tail = 0 if ell is None else ell[1].size
    print(f"  index: {g.n} nodes -> {pk.n} condensed, k_max {pk.k_max}, "
          f"seed words {0 if pk.s_plus is None else pk.s_plus.shape[1]}, "
          f"fused layout {'slab' in sess.engine.dev}, ELL width "
          f"{None if ell is None else ell[0].shape[1]}, COO tail {tail}, "
          f"max level {int(pk.blevel.max())}, phase 2 "
          f"{sess.engine.phase2_mode}; host build + pack {dt:.1f} s",
          flush=True)
    return ix, sess, (ix, pk, ell)


def serve(sess, qs, qt, label):
    import torch
    sess.reset_stats()
    t0 = time.perf_counter()
    ans = sess.query(qs, qt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = sess.stats
    eng = sess.engine
    print(f"  {label}: {qs.size} queries in {dt * 1e3:.1f} ms "
          f"({dt / qs.size * 1e9:.0f} ns/query), {int(ans.sum())} positive; "
          f"mix phase1 pos/neg {st.phase1_pos}/{st.phase1_neg}, phase 2 "
          f"{st.phase2_queries} (dense {st.phase2_dense}, sparse "
          f"{st.phase2_sparse}, host {st.phase2_host}), sparse retries "
          f"{st.sparse_retries}; last batch phase1 "
          f"{eng.last_phase1_s * 1e3:.3f} ms, phase2 "
          f"{eng.last_phase2_s * 1e3:.3f} ms", flush=True)
    return ans, st


def profile_window(fn, label, top: int = 6, wall=None):
    """Where the time goes: device time by kernel and copy (torch.profiler,
    device-side events only) over one call of ``fn``, against the wall
    time of the same call without the profiler (``wall`` seconds if the
    caller timed one already); their ratio is the device's busy share (one
    stream, so events do not overlap). Returns the (device us, count,
    name) rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if wall is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"  profile {label}: wall {wall * 1e3:.2f} ms unprofiled, device "
          f"busy {busy * 1e3:.3f} ms ({busy / wall:.1%}); top device time:",
          flush=True)
    for us, count, key in rows[:top]:
        print(f"    {us / 1e3:9.3f} ms  x{count:<5} {key[:70]}", flush=True)
    return rows


def hold_to_host(ix, sess, qs, qt, ans, n_sample, label):
    """The host guided DFS on a sample plus every phase-2 query."""
    from repro_torch.core.query import QueryEngine
    from repro_torch.kernels import ops
    v, _, _ = sess.engine.classify(qs, qt)
    unknown = np.flatnonzero(v.cpu().numpy() == ops.UNKNOWN)
    rng = np.random.default_rng(7)
    idx = np.union1d(rng.choice(qs.size, min(n_sample, qs.size),
                                replace=False), unknown)
    want = QueryEngine(ix).batch(qs[idx], qt[idx])
    bad = int((ans[idx] != want).sum())
    print(f"  host check {label}: {idx.size} answers ({unknown.size} from "
          f"phase 2), {bad} mismatches", flush=True)
    check(bad == 0, f"{label}: answers differ from the host engine")


def hold_stab_calls(rec, phase: str, err: dict) -> None:
    """Kernels 1 and 2 against their plain versions, bit for bit, on the
    largest and smallest calls the phase made of each (kept by ``rec``),
    tallied into ``err``."""
    from repro_torch.kernels import interval_stab as st
    kernel = {"stab_packed": (st.stab_packed, st.stab_packed_plain),
              "stab_naive": (st.stab_naive, st.stab_naive_plain)}
    for name, (fn, plain) in kernel.items():
        for which, calls in (("largest", rec.calls), ("smallest", rec.small)):
            if name in calls:
                rows, args = calls[name]
                _tally(err, name, _compare(
                    f"{name} on the {phase} phase's {which} call ({rows} "
                    f"rows)", fn(*args), plain(*args)))


# ------------------------------------------- kernels 3 and 4 (BFS step)
def random_step(g, dev, q: int = 256, n: int = 1 << 20, w: int = 64,
                cap: int = 16384, gate: bool = False):
    """A random step state: Q queries over n nodes with ELL width W (a
    fifth of the slots empty), a front of ~cap distinct keys, visited
    words of 1 bit in 8, a fifth of the queries answered, packed tables at
    K 8; with ``gate``, a live overlay's can_reach_tail on half the nodes
    (kernel 4's overlay rule). Returns (state, tables)."""
    import torch

    from repro_torch.kernels import frontier_fused as ff
    i32 = dict(device=dev, dtype=torch.int32)
    ell = torch.randint(0, n, (n, w), generator=g, **i32)
    ell[torch.rand((n, w), generator=g, device=dev) < 0.2] = -1
    meta, slab = packed_tables(g, n, 8, dev)
    st = ff.StepState(q=q, n_nodes=n, w=w, m_t=0, cap=cap, max_steps=2,
                      device=dev)
    keys = torch.unique((torch.randint(0, q, (cap,), generator=g, **i32)
                         << st.vbits)
                        | torch.randint(0, n, (cap,), generator=g, **i32))
    st.front[:keys.numel()] = keys
    st.visited.copy_(torch.randint(-2**31, 2**31 - 1, st.visited.shape,
                                   generator=g, **i32)
                     & torch.randint(-2**31, 2**31 - 1, st.visited.shape,
                                     generator=g, **i32)
                     & torch.randint(-2**31, 2**31 - 1, st.visited.shape,
                                     generator=g, **i32))
    st.pos.copy_((torch.rand(q, generator=g, device=dev) < 0.2).int())
    ct = torch.randint(0, n, (q,), generator=g, **i32)
    ff._put(st.ctl, {ff.RUN: 1, ff.N_FRONT: keys.numel(), ff.EPOCH: 1})
    empty = torch.zeros(0, **i32)
    tables = dict(ell=ell, tail_src=empty, tail_dst=empty,
                  is_hub=torch.zeros(n, dtype=torch.bool, device=dev),
                  meta=meta, slab=slab, ct=ct,
                  can_reach_tail=(torch.rand(n, generator=g, device=dev)
                                  < 0.5) if gate else None)
    return st, tables, None, False


def _plain_dedup(st, tables, classify, distinct):
    from repro_torch.kernels import frontier_fused as ff
    fetch_rows, classify = ff.plain_hooks(tables, classify)
    ff.dedup_classify_emit_plain(st, tables["ct"], tables["is_hub"],
                                 fetch_rows=fetch_rows, classify=classify,
                                 distinct_overflow=distinct,
                                 can_reach_tail=tables.get("can_reach_tail"))


def _state_words(st, after_probe=False):
    """The words of a state the step writes, for an exact comparison (the
    launch counters aside, which the plain versions leave alone, and the
    tile counter after kernel 3 alone: it counts tiles taken)."""
    from repro_torch.kernels import frontier_fused as ff
    words = st.state.clone()
    words[ff.LAUNCH_WORDS] = 0
    if after_probe:
        words[ff.TILE] = 0
    ctl = words.tolist()
    out = [words, st.slots, st.visited, st.front[:ctl[ff.N_FRONT]],
           st.log[:ctl[ff.LOG_N]]]
    return tuple(out + ([] if st.fbits is None else [st.fbits]))


def hold_step(call, label, err) -> None:
    """Kernel 3, then kernel 4, on a copy of a step state against their
    plain versions on another copy (on the card), every word compared;
    tallied into ``err``."""
    from repro_torch.kernels import frontier_fused as ff
    st, tables, classify, distinct = call
    got, want = st.clone(), st.clone()
    ff.expand_probe(got, tables)
    ff.expand_probe_plain(want, tables["ell"], tables["tail_src"],
                          tables["tail_dst"])
    _tally(err, "probe", _compare(
        f"probe {label} (raw {int(want.ctl[ff.RAW])}, cap {st.cap})",
        _state_words(got, True), _state_words(want, True)))
    ff.dedup_classify_emit(got, tables, classify=classify,
                           distinct_overflow=distinct)
    _plain_dedup(want, tables, classify, distinct)
    _tally(err, "classify_emit", _compare(
        f"classify_emit {label} (next front {int(want.ctl[ff.N_FRONT])}, "
        f"overflow {int(want.ctl[ff.OVF])})", _state_words(got),
        _state_words(want)))


def replay_call(call):
    """A recorded expansion call stepped from the host with kernels 3 and
    4's own wrappers (``frontier_fused._stepped_call``): [(state before
    the step, tables, classify, distinct)], and the call's (pos,
    overflow) that way."""
    from repro_torch.kernels import frontier_fused as ff
    from repro_torch.kernels import ops
    dev, (ell, tsrc, tdst, is_hub, cs, ct, pad) = call["dev"], call["args"]
    fused = "slab" in dev
    st = ff.StepState(q=cs.shape[0], n_nodes=ell.shape[0], w=ell.shape[1],
                      m_t=tsrc.shape[0], cap=call["kw"]["cap"],
                      max_steps=call["kw"]["max_steps"], device=cs.device)
    tables = ff._tables(ell, tsrc, tdst, is_hub, st.ct, {
        "meta": dev["meta"], "slab": dev["slab"]} if fused else None,
        call.get("crt"))
    classify = ops.frontier_classify(dev)
    states = []
    host = ff._stepped_call(
        st, tables, cs, ct, pad, classify=classify,
        distinct_overflow=not fused,
        on_step=lambda s: states.append((s.clone(), tables, classify,
                                         not fused)))
    return states, (host[ff.CTL_WORDS:] != 0, bool(host[ff.OVF]))


def _swept(st) -> int:
    """The (query, slot) pairs kernel 3 tests on a step: each front entry's
    W ELL slots and, with a hub in any front, every query's pass over the
    whole tail (q x m_t)."""
    from repro_torch.kernels import frontier_fused as ff
    ctl = st.ctl.tolist()
    return ctl[ff.N_FRONT] * st.w + (st.q * st.m_t if ctl[ff.HUB] else 0)


def _candidates(st, tables) -> int:
    """The candidates a step needs on this data: each front entry's W ELL
    slots, and the tail edges whose source is a hub in its own query's
    front (what the frontier bits let through), not the q x m_t pairs
    kernel 3 sweeps for them (``_swept``)."""
    import torch

    from repro_torch.kernels import frontier_fused as ff
    ctl = st.ctl.tolist()
    n = ctl[ff.N_FRONT] * st.w
    if not ctl[ff.HUB] or st.fbits is None:
        return n
    front = st.front[:ctl[ff.N_FRONT]]
    fv = (front[front != ff.SENTINEL] & ((1 << st.vbits) - 1)).long()
    hub = tables["is_hub"]
    deg = torch.bincount(tables["tail_src"].long(), minlength=hub.shape[0])
    return n + int((deg[fv] * hub[fv]).sum())


def hold_step_calls(rec, phase: str, err: dict, kept: dict) -> None:
    """Kernels 3 and 4 against their plain versions on every step of the
    phase's largest and smallest expansion calls (by steps) and of its
    first overflowing one, each replayed step by step; the replay's
    answers must equal the served call's. One step is kept in ``kept``
    for timing: the step of most (query, slot) pairs
    kernel 3 sweeps, with the candidates it needs beside them."""
    calls = [c for c in rec.expansions if c["steps"]]
    if not calls:
        return
    picks = {"largest": max(calls, key=lambda c: (c["steps"],
                                                  c["kw"]["cap"])),
             "smallest": min(calls, key=lambda c: c["steps"])}
    ovf = [c for c in calls if c["overflow"]]
    if ovf:
        picks["first overflowing"] = ovf[0]
    for which, call in picks.items():
        states, (pos, overflow) = replay_call(call)
        check(np.array_equal(pos, call["pos"])
              and overflow == call["overflow"],
              f"{phase}: the stepped replay of the {which} call differs "
              "from the served one")
        for i, state in enumerate(states):
            hold_step(state, f"{phase} {which} call (cap "
                      f"{call['kw']['cap']}), step {i}", err)
            rows = _swept(state[0])
            if rows > kept.get("rows", -1):
                kept.update(rows=rows, call=state, phase=phase,
                            candidates=_candidates(state[0], state[1]))


def step_work(call):
    """((bytes, ops) of kernel 3, (bytes, ops) of kernel 4) on a step
    state: what the step must read and write on this data. Kernel 3: each
    front key, the ELL rows of its distinct live nodes, with a hub the tail
    (8 B an edge) and the frontier words its queries' gates read, the
    visited word and answered flag of each distinct valid candidate, each
    kept survivor, a few control words; ~10 ops a candidate. A hub's tail
    edges count once a query whose front holds it (8 B an edge read once,
    ``_candidates``), not the q x m_t sweep kernel 3 makes. Kernel 4: the
    slots it sorts, the ct of each distinct query, the meta rows of each
    distinct node and target and the slab rows of each distinct node of
    the live uniques not their query's target (kernel 2's verdict, 4 B a
    key, on the 12-array layout), a read and a write of each visited word
    and answered flag, the log, the old front's hub words and the next
    front; n log2 n ops to sort, ~(6K + 30) a key."""
    import math

    from repro_torch.kernels import frontier_fused as ff
    st, tables, classify, distinct = call
    ctl = st.ctl.tolist()
    vbits, vmask = st.vbits, (1 << st.vbits) - 1
    b3, probe = probe_work(st, tables, distinct)
    pctl = probe.ctl.tolist()
    n = pctl[ff.RAW] if distinct else min(pctl[ff.RAW], st.cap + 1)
    done = probe.clone()
    _plain_dedup(done, tables, classify, distinct)
    dctl = done.ctl.tolist()
    keys = done.log[pctl[ff.LOG_N]:dctl[ff.LOG_N]].long()
    nq, nv = keys >> vbits, keys & vmask
    nt = tables["ct"].long()[nq]
    rows = nv != nt
    m = keys.numel()
    b4 = (4 * n + 12 * _distinct(nq) + 8 * _distinct(nq * st.n_words
                                                    + (nv >> 5))
          + 4 * m + 4 * dctl[ff.N_FRONT] + 32)
    if st.fbits is not None:
        b4 += 4 * ctl[ff.N_FRONT]
    if tables.get("can_reach_tail") is not None:
        b4 += _distinct(nv)                 # the overlay gate, 1 B a node
    if classify is None:
        k = tables["slab"].shape[1] // 2
        b4 += (16 * _distinct(nv[rows], nt[rows])
               + 8 * k * _distinct(nv[rows]))
    else:
        k = 0
        b4 += 4 * m
    ops4 = n * max(1, math.ceil(math.log2(max(n, 2)))) + m * (6 * k + 30)
    return (b3, 10 * _candidates(st, tables)), (b4, ops4)


def probe_work(st, tables, distinct: bool = False, rows=None):
    """Kernel 3's bytes on a step (``step_work``), and the state after its
    plain version. ``rows``: the exchanged-rows entry's [n_front, W]
    buffer, read once a front entry where the in-place kernel reads each
    distinct node's ELL row once."""
    import torch

    from repro_torch.kernels import frontier_fused as ff
    ctl = st.ctl.tolist()
    vbits, vmask = st.vbits, (1 << st.vbits) - 1
    front = st.front[:ctl[ff.N_FRONT]]
    front = front[front != 2**31 - 1]
    fq, fv = front >> vbits, front & vmask
    nbr = tables["ell"][fv.long()] if rows is None else rows
    ok = nbr >= 0
    cq = fq[:, None].expand_as(nbr)[ok].long()
    cv = nbr[ok].long()
    b3 = 4 * front.numel() + (_distinct(fv) if rows is None
                              else front.numel()) * 4 * st.w
    if ctl[ff.HUB] and st.fbits is not None:
        tsrc = tables["tail_src"].long()
        gate = ((st.fbits[:, tsrc >> 5] >> (tsrc & 31)) & 1) != 0
        qq, ee = gate.nonzero(as_tuple=True)
        cq = torch.cat([cq, qq])
        cv = torch.cat([cv, tables["tail_dst"].long()[ee]])
        b3 += 8 * _distinct(ee)
    probe = st.clone()
    if rows is None:
        ff.expand_probe_plain(probe, tables["ell"], tables["tail_src"],
                              tables["tail_dst"])
    else:
        ff.expand_probe_rows_plain(probe, rows, tables["tail_src"],
                                   tables["tail_dst"])
    pctl = probe.ctl.tolist()
    n = pctl[ff.RAW] if distinct else min(pctl[ff.RAW], st.cap + 1)
    b3 += (_distinct(cq * st.n_words + (cv >> 5)) * 4
           + _distinct(cq) * 4 + n * 4 + 32)
    return b3, probe


def time_step_kernels(kept: dict) -> dict:
    """Kernels 3 and 4 timed on the kept step (the path's step of most
    swept pairs) with ``device_ms``, each call's inputs restored outside the
    events (kernel 3: its tile counter and epoch; kernel 4: the state
    kernel 3 left), beside their plain versions, their bound and the
    launch floor (``zero_()`` of an int32 output of the step's swept pairs,
    of its slots for kernel 4)."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import frontier_fused as ff
    st, tables, classify, distinct = call = kept["call"]
    (b3, o3), (b4, o4) = step_work(call)
    out = {}
    probe_st = st.clone()
    args3 = probe_st.args(tables)

    def prep3():
        probe_st.state[ff.TILE].zero_()
        probe_st.state[ff.EPOCH].add_(1)

    def kernel3():
        _lib.launch(None, "reach_expand_probe", probe_st.device,
                    ctypes.addressof(args3))
    plain3 = st.clone()

    def run_plain3():
        ff.expand_probe_plain(plain3, tables["ell"], tables["tail_src"],
                              tables["tail_dst"])
    after = st.clone()
    ff.expand_probe(after, tables)
    step_st = after.clone()
    saved = (after.state, after.front, after.visited, after.fbits)

    def prep4():
        for dst, src in zip((step_st.state, step_st.front, step_st.visited,
                             step_st.fbits), saved):
            if src is not None:
                dst.copy_(src)

    def kernel4():
        ff.dedup_classify_emit(step_st, tables, classify=classify,
                               distinct_overflow=distinct)

    def run_plain4():
        _plain_dedup(step_st, tables, classify, distinct)
    rows3, cand3 = _swept(st), _candidates(st, tables)
    rows4 = int(after.ctl[ff.RAW])
    # each kernel's own launch shape returning at once (RUN 0): kernel 3's
    # resident grid, kernel 4's one block of 1024 threads with its
    # shared memory
    idle3, idle4 = st.clone(), after.clone()
    idle3.state[ff.RUN] = 0
    idle4.state[ff.RUN] = 0
    idle = {"probe": idle3.args(tables), "classify_emit": idle4.args(tables)}
    entry = {"probe": "reach_expand_probe",
             "classify_emit": "reach_dedup_classify_emit"}
    for name, fn, prep, plain, rows, nbytes, ops in (
            ("probe", kernel3, prep3, run_plain3, rows3, b3, o3),
            ("classify_emit", kernel4, prep4, run_plain4,
             min(rows4, st.cap + 1), b4, o4)):
        ms = device_ms(fn, prep=prep)
        warm_ms = device_ms(fn, cold=False, prep=prep)
        plain_ms = device_ms(plain, prep=prep if name != "probe" else None)
        floor = launch_floor(max(rows, 1))
        at_once = device_ms(lambda: _lib.launch(
            None, entry[name], st.device, ctypes.addressof(idle[name])))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ALU_OPS_PER_S * 1e3
        out[name] = dict(rows=rows, candidates=cand3, ms=ms, warm_ms=warm_ms,
                         plain_ms=plain_ms, library=None, library_ms=None,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else
                         "operations", bytes=nbytes, ops=ops,
                         err=(0, 0, 0.0), floor_ms=floor[0],
                         floor_warm_ms=floor[1], at_once_ms=at_once)
        print(f"  time {name} ({kept['phase']} step of {rows3} swept pairs, "
              f"{cand3} candidates, {rows4} survivors, cap {st.cap}, hub "
              f"{int(st.ctl[ff.HUB])}): kernel {ms:.6f} ms (L2 cold; "
              f"{warm_ms:.6f} ms L2 warm), plain {plain_ms:.4f} ms; launch "
              f"floor {floor[0]:.6f} ms cold, {floor[1]:.6f} ms warm (zero_ "
              f"of {max(rows, 1)} int32), its own launch returning at once "
              f"{at_once:.6f} ms, bound "
              f"{out[name]['bound_ms']:.7f} ms ({nbytes} B, {ops} ops; "
              f"{out[name]['bound_by']})", flush=True)
    torch.cuda.synchronize()
    return out


def sparse_host_split(sess, call, reps: int = 101) -> dict:
    """One expansion call of the served path (``call``, recorded, at its
    cap) split by part on host clocks: ``frontier_fused._graph_call``
    marks its own boundaries (``StepState.mark``), with a sync at each
    but the enqueue. Each part runs to the mark that ends it: the engine
    before the call (pad to the card, checks, workspace lookup), the three
    input copies, the graph launch (enqueue), the graph's run (final
    sync), the control words and pos back and numpy (read-back), the
    engine after. Median [quartiles] of ``reps``, the whole call unmarked
    beside it."""
    import torch
    eng = sess.engine
    cs, ct, pad = call["args"][4:7]
    cap = call["kw"]["cap"]
    pad_np = pad.cpu().numpy()
    st = next(v for v in eng._sparse_state.values()
              if v.cap == cap and v.graph is not None)
    times = collections.defaultdict(list)
    stamps = []

    def mark(label, sync=True):
        if sync:
            torch.cuda.synchronize()
        stamps.append((label, time.perf_counter()))
    parts = {"call": "engine before the call (pad to the card, checks, "
                     "workspace lookup)",
             "inputs": "input copies (3)", "enqueue": "enqueue (graph launch)",
             "run": "final sync (the graph's run)",
             "read": "read-back (control words and pos, numpy)",
             "end": "engine after the call"}
    for marked in (False, True):
        for _ in range(reps):
            stamps.clear()
            st.mark = mark if marked else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._expand_chunk(cs, ct, pad_np, cap)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st.mark = None
            times["whole" if marked else "unmarked"].append((t1 - t0) * 1e3)
            prev = t0
            for label, t in (stamps + [("end", t1)] if marked else []):
                times[parts[label]].append((t - prev) * 1e3)
                prev = t
    q1, med, q3 = ({key: float(np.percentile(v, p))
                    for key, v in times.items()} for p in (25, 50, 75))
    unmarked, whole = med.pop("unmarked"), med.pop("whole")
    print(f"  host split of one expansion call (cap {cap}, {cs.shape[0]} "
          f"queries; median [quartiles] of {reps}, host clocks): unmarked "
          f"{unmarked:.4f} ms [{q1['unmarked']:.4f}, {q3['unmarked']:.4f}]; "
          f"marked (a sync at each boundary) {whole:.4f} ms "
          f"[{q1['whole']:.4f}, {q3['whole']:.4f}] = " + ", ".join(
              f"{k} {v:.4f} ms ({v / whole:.1%}) [{q1[k]:.4f}, {q3[k]:.4f}]"
              for k, v in med.items()), flush=True)
    return dict(whole_ms=whole, unmarked_ms=unmarked, **med)


def host_split(sess, s, t, reps: int = 101) -> dict:
    """One batch of ``QuerySession.query`` (``s``, ``t``: original ids, one
    full micro-batch) split by part on host clocks, with a
    ``torch.cuda.synchronize()`` at each boundary: each part is run on its
    own as the path runs it (the ids written into one of the engine's
    reused pinned buffers and copied, the ``comp`` gather, kernel 1, the
    verdict's copy back), median and quartiles of
    ``reps``; the rest is the whole call's median less the parts'.
    Nothing on the served path changes."""
    import torch

    from repro_torch.kernels import interval_stab as st
    eng = sess.engine
    times = collections.defaultdict(list)

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()
    for _ in range(reps):
        t0 = clock()
        sess.query(s, t)
        t1 = clock()
        ps, pt = sess._pad(s, t, sess._bucket(s.size))
        t2 = clock()
        staged = eng._ids_to_device(ps, pt)
        t3 = clock()
        c = eng.comp[staged.ids]
        t4 = clock()
        verdict = st.stab_packed(eng.dev["meta"], eng.dev["slab"], c[0], c[1])
        t5 = time.perf_counter()          # the launch is queued, not done
        t6 = clock()
        verdict.cpu().numpy()
        t7 = clock()
        eng._pinned.give(staged.buf)
        for key, dt in (("whole", t1 - t0), ("pad and bucket", t2 - t1),
                        ("ids into a pinned buffer + copy", t3 - t2),
                        ("comp gather", t4 - t3),
                        ("kernel-1 wrapper (checks, empty, ctypes)",
                         t5 - t4), ("kernel-1 wait", t6 - t5),
                        ("verdict to the host + sync", t7 - t6)):
            times[key].append(dt * 1e3)
    q1, med, q3 = ({key: float(np.percentile(v, p))
                    for key, v in times.items()} for p in (25, 50, 75))
    whole = med.pop("whole")
    med["rest (stats, numpy, session, dispatch)"] = whole - sum(med.values())
    print(f"  host split of one {s.size}-query batch of QuerySession.query "
          f"(median [quartiles] of {reps}, host clocks, a sync at each "
          f"boundary): whole {whole:.4f} ms [{q1['whole']:.4f}, "
          f"{q3['whole']:.4f}] = " + ", ".join(
              f"{k} {v:.4f} ms ({v / whole:.1%})"
              + (f" [{q1[k]:.4f}, {q3[k]:.4f}]" if k in q1 else "")
              for k, v in med.items()), flush=True)
    return dict(whole_ms=whole, **med)


def main_phase(dev, rec):
    from repro_torch.core.workload import positive_queries, random_queries
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec
    print(f"main: scale_free_digraph({MAIN_NODES}, 4.0), default IndexSpec",
          flush=True)
    g = scale_free_digraph(MAIN_NODES, 4.0, seed=0)
    spec = IndexSpec()
    ix, sess, _ = make_session(g, spec, dev)
    check("slab" in sess.engine.dev and sess.engine.packed.k_max <= 8,
          "main index must take the fused layout with k_max <= 8")
    qs, qt = random_queries(g, 1 << 20, seed=1)
    ps, pt = positive_queries(g, 1 << 17, seed=2)
    sess.query(qs[:spec.max_batch], qt[:spec.max_batch])     # warm up
    reset_counters()
    rec.reset()
    ans, st_r = serve(sess, qs, qt, "random")
    ans_p, st_p = serve(sess, ps, pt, "positive")
    counts, calls = read_counters(), dict(rec.calls)
    print(f"  counts: {counts}; phase-1 batch shapes {sess.trace_count}",
          flush=True)
    check(bool(ans_p.all()), "main: a positive-workload answer is false")
    hold_to_host(ix, sess, qs, qt, ans, 10_000, "main random")
    profile_window(lambda: sess.query(qs[:1 << 18], qt[:1 << 18]),
                   f"main random, {1 << 18} queries")
    host_split(sess, qs[:spec.max_batch], qt[:spec.max_batch])
    return counts, calls, dict(g=g, queries=(qs, qt, ps, pt),
                               answers=(ans, ans_p))


def wavefront_phase(dev, rec, main, path):
    """The device build of the main graph, then save → load → serve; the
    artifact goes to ``path`` (removed by ``main``)."""
    import torch

    from repro_torch.core.build import pipeline
    from repro_torch.core.packed import pack_index
    from repro_torch.kernels import merge_cover as mc
    from repro_torch.reach import IndexSpec, QuerySession, build, save_index
    g = main["g"]
    qs, qt, ps, pt = main["queries"]
    spec = IndexSpec(builder="wavefront", cover_method="topgap")
    print(f"wavefront: device build of the main graph ({g.n} nodes), "
          f"k={spec.k}, {spec.variant}, c={spec.c}, merge_chunk "
          f"{spec.merge_chunk}", flush=True)
    drain_s = []
    drain = pipeline._drain_to_budget

    def timed_drain(*args):
        t0 = time.perf_counter()
        out = drain(*args)
        drain_s.append(time.perf_counter() - t0)
        return out
    pipeline._drain_to_budget = timed_drain
    build_rec = BuildRecorder()
    reset_counters()
    rec.reset()
    try:
        t0 = time.perf_counter()
        ix = build(g, spec, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    finally:
        build_rec.close()
        pipeline._drain_to_budget = drain
    t0 = time.perf_counter()
    pk = pack_index(ix)
    ell = pk.ell_layout(width=spec.ell_width)
    t_pack = time.perf_counter() - t0
    st = ix.stats
    waves = int(ix.tl.blevel[:ix.tl.n].max()) + 1
    t_drain = sum(drain_s)
    print(f"  build {t_build:.1f} s: condense {st.seconds_condense:.2f} s, "
          f"tree {st.seconds_tree:.2f} s, waves "
          f"{st.seconds_assign - t_drain:.2f} s, drain {t_drain:.2f} s "
          f"({st.heap_recover_count} nodes), seeds {st.seconds_seeds:.2f} "
          f"s, labels + rest {t_build - st.seconds_total:.2f} s; pack "
          f"{t_pack:.2f} s", flush=True)
    launches = read_counters()["merge_cover"]
    print(f"  {st.n_comp} condensed nodes, {waves} waves, hub_nodes "
          f"{st.hub_nodes}, merge_rounds {st.merge_rounds}, host_fallbacks "
          f"{st.host_fallbacks}, peak_slab_bytes {st.peak_slab_bytes}, "
          f"{st.total_intervals} intervals, merge_cover launches "
          f"{launches} ({len(build_rec.calls)} calls)", flush=True)
    check(st.hub_nodes >= 1, "wavefront: no hub took the tree reduction")
    check(st.merge_rounds >= 2, "wavefront: fewer than 2 merge rounds")
    check(st.host_fallbacks == 0, "wavefront: host fallbacks")
    check(launches == len(build_rec.calls) > 0,
          "wavefront: kernel 5 launches differ from the recorded calls")

    # every kernel-5 call of the build against its plain version
    bad = err = 0
    for args, out in build_rec.calls:
        want = mc.merge_cover_plain(*args)
        bad += sum(int((a != b).sum()) for a, b in zip(out, want))
        err = max([err] + [int((a.long() - b.long()).abs().max())
                           for a, b in zip(out, want) if a.numel()])
    torch.cuda.synchronize()
    print(f"  parity merge_cover on the build's {len(build_rec.calls)} "
          f"calls: {bad} mismatches", flush=True)
    check(bad == 0, "wavefront: kernel 5 disagrees with its plain version")
    shapes = [(a[0].shape[0], a[0].shape[1]) for a, _ in build_rec.calls]
    print(f"  kernel-5 calls (rows x m): {shapes}", flush=True)
    largest = max(build_rec.calls, key=lambda c: c[0][0].numel())[0]
    m_round = spec.merge_chunk * spec.c * spec.k + 1
    rounds = [a for a, _ in build_rec.calls if a[0].shape[1] == m_round]
    few = min(rounds, key=lambda a: a[0].shape[0]) if rounds else None
    prologue_args = build_rec.prologue[1]
    build_rec.calls = []

    t0 = time.perf_counter()
    save_index(path, ix, spec, packed=pk, ell=ell)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess = QuerySession.load(path, device=dev)
    t_load = time.perf_counter() - t0
    print(f"  save_index {t_save:.1f} s, QuerySession.load {t_load:.1f} s; "
          f"phase 2 {sess.engine.phase2_mode}", flush=True)
    sess.query(qs[:spec.max_batch], qt[:spec.max_batch])     # warm up
    ans, _ = serve(sess, qs, qt, "random (loaded)")
    ans_p, _ = serve(sess, ps, pt, "positive (loaded)")
    counts = read_counters()
    print(f"  counts: {counts}", flush=True)
    want, want_p = main["answers"]
    diff = int((ans != want).sum()) + int((ans_p != want_p).sum())
    print(f"  loaded answers against the main phase's: {diff} of "
          f"{ans.size + ans_p.size} differ", flush=True)
    check(diff == 0, "wavefront: answers after save/load differ from main")
    check(bool(ans_p.all()), "wavefront: a positive answer is false")

    # the prologue (gather + stable sort) of the largest call, and the
    # kernel at the tree round with the fewest rows
    from repro_torch.core.build import merge_kernels as mk
    print(f"  time prologue (gather + stable sort) of the largest call "
          f"({prologue_args[3].shape[0]} groups x {prologue_args[-1]} "
          f"slots): {device_ms(lambda: mk.gather_sorted(*prologue_args)):.4f}"
          f" ms (L2 cold)", flush=True)
    if few is not None:
        ms = device_ms(lambda: mc.merge_cover(*few))
        nbytes, ops = work_of("merge_cover", few)
        print(f"  time merge_cover at the tree round with the fewest rows "
              f"({few[0].shape[0]} x {few[0].shape[1]}): {ms:.4f} ms, "
              f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.3e} ms ({nbytes} B)",
              flush=True)
    return counts, (largest[0].shape[0], largest), dict(
        session=sess, path=path, g=g, seconds=dict(save=t_save, load=t_load))


def dag_inserts(ix, rng, count: int, before_giant: bool = True):
    """``count`` distinct original-id edges whose condensed ends follow the
    index's topological order (tau), so the condensation stays a DAG; each
    condensed node stands for one original member of its component. With
    ``before_giant`` the tails are drawn among the components before the
    largest one in that order, which therefore reaches none of them;
    without, from every component."""
    comp = ix.cond.comp
    n = ix.cond.n_comp
    tau = ix.tl.tau[:n]
    member = np.empty(n, np.int64)
    member[comp] = np.arange(comp.size)
    pool = (np.flatnonzero(tau < tau[np.argmax(ix.cond.comp_size)])
            if before_giant else np.arange(n))
    a = rng.choice(pool, 2 * count)
    b = rng.integers(0, n, 2 * count)
    fwd = tau[a] < tau[b]
    lo, hi = np.where(fwd, a, b), np.where(fwd, b, a)
    keep = lo != hi
    pairs = np.unique(np.stack([lo[keep], hi[keep]], 1), axis=0)
    pairs = pairs[rng.permutation(pairs.shape[0])[:count]]
    return member[pairs[:, 0]], member[pairs[:, 1]]


class Stopwatch:
    """Seconds spent in module functions while the run goes through them:
    ``watch(module, name)`` wraps one until ``close``."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self._orig = []

    def watch(self, mod, name, label=None, calls=None):
        """``calls``: a list that gets each call's positional args."""
        fn = getattr(mod, name)
        self._orig.append((mod, name, fn))
        label = label or name

        def timed(*args, **kw):
            if calls is not None:
                calls.append(args)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[label] += time.perf_counter() - t0
        setattr(mod, name, timed)

    def close(self):
        for mod, name, fn in reversed(self._orig):
            setattr(mod, name, fn)
        self._orig = []


CHURN_BATCHES = 4
CHURN_EDGES = 1024          # a batch; four fill the default overlay_cap
CHURN_OPEN_SECONDS = 20.0   # the unrestricted batch's reopened queries
CHURN_HOLD_SECONDS = 10.0   # ... and the host BFS holding their answers


def open_batch(sess, qs, qt, before, rng, rec, err) -> float:
    """One insert batch of the unrestricted draw (tails from every
    component, ``dag_inserts(before_giant=False)``) on a session with an
    empty overlay. The giant component then reaches delta tails, so the
    base-NEG queries from it reopen; one such query floods its front with
    the giant's ~1.5M tail edges, overflows every cap up to
    ``frontier_cap_max`` and falls back to the union-graph BFS on the host
    (``_phase2_host_overlay``: Python, one query at a time). The queries
    that stay closed are served in one batch, and must keep their
    answers (``before``: the session's, without an overlay; a source that
    reaches no delta tail reaches what it did); the reopened ones on their
    own, in groups of 1, 2, 4, ... until ``CHURN_OPEN_SECONDS`` would be
    passed. Prints the reopened share, the fallbacks and their seconds,
    and the whole sample's time at the measured rates; the answers the
    card resolved are held against the host BFS for up to
    ``CHURN_HOLD_SECONDS``, and kernels 3 and 4 on the groups' calls
    against their plain versions. Returns the seconds it took."""
    import torch

    from repro_torch.core import query_torch
    from repro_torch.kernels import ops
    t_start = time.perf_counter()
    eng = sess.engine
    src, dst = dag_inserts(sess.index, rng, CHURN_EDGES, before_giant=False)
    t0 = time.perf_counter()
    applied = sess.apply_updates(src, dst)
    t_apply = time.perf_counter() - t0
    ov = eng.overlay
    v, cs, _ = eng.classify(qs, qt)
    cs = cs.cpu().numpy()
    reopen = np.flatnonzero((v.cpu().numpy() == ops.NEG)
                            & ov.can_reach_tail[cs])
    giant = int(np.argmax(sess.index.cond.comp_size))
    print(f"  open batch (tails from every component, on the epoch-1 "
          f"session): {applied} new edges, apply_updates {t_apply:.3f} s, "
          f"can_reach_tail {int(ov.can_reach_tail.sum())} of {ov.n} nodes "
          f"(giant component {'in' if ov.can_reach_tail[giant] else 'not in'}"
          f" it); reopened {reopen.size} of {qs.size} "
          f"({reopen.size / qs.size:.2%})", flush=True)
    check(applied > 0 and reopen.size > 0,
          "churn open batch: no edge applied or no query reopened")
    closed = np.setdiff1d(np.arange(qs.size), reopen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = serve(sess, qs[closed], qt[closed], "open batch, the queries "
                   "not reopened")
    t_closed = time.perf_counter() - t0
    check(np.array_equal(got, before[closed]), "churn open batch: a query "
          "not reopened changed its answer")

    fallback = []
    watch = Stopwatch()
    watch.watch(query_torch.DeviceQueryEngine, "_phase2_host_overlay",
                "host", calls=fallback)
    sess.reset_stats()
    reset_counters()
    rec.reset()
    done, spent, size, answers = 0, 0.0, 1, []
    try:
        while done < reopen.size:
            idx = reopen[done:done + size]
            t0 = time.perf_counter()
            answers.append(sess.query(qs[idx], qt[idx]))
            torch.cuda.synchronize()
            spent += time.perf_counter() - t0
            done += idx.size
            size = min(2 * size, 256)
            if spent + spent / done * size > CHURN_OPEN_SECONDS:
                break
    finally:
        watch.close()
    counts = read_counters()
    st = sess.stats
    ans = np.concatenate(answers)
    rate = spent / done
    print(f"  open batch, reopened queries served: {done} of {reopen.size} "
          f"in {spent:.2f} s ({rate * 1e3:.1f} ms a query), "
          f"{int(ans.sum())} positive, n_overlay_hits {st.n_overlay_hits}; "
          f"phase 2 {st.phase2_queries} (sparse {st.phase2_sparse}, host "
          f"{st.phase2_host}), sparse retries {st.sparse_retries}; "
          f"{st.phase2_host} fell back to the host BFS, "
          f"{watch.seconds['host']:.2f} s there "
          f"({watch.seconds['host'] / max(st.phase2_host, 1):.3f} s a query);"
          f" {len(rec.expansions)} overlay expansion calls, "
          f"{counts['sparse_steps']} steps, kernels 3/4 {counts['probe']}/"
          f"{counts['classify_emit']}", flush=True)
    print(f"  open batch, the whole {qs.size}-query sample at these rates "
          f"(extrapolated, not served): {t_closed:.3f} s for the "
          f"{closed.size} not reopened + {reopen.size} x {rate:.3f} s = "
          f"{t_closed + reopen.size * rate:.0f} s, "
          f"{(t_closed + reopen.size * rate) / qs.size * 1e9:.0f} ns/query",
          flush=True)
    check(st.phase2_queries >= done, "churn open batch: a reopened query "
          "did not reach phase 2")

    # the card's answers (those that did not fall back) against the BFS
    on_host = {pair for _, cs_u, ct_u in fallback
               for pair in zip(cs_u.tolist(), ct_u.tolist())}
    comp = sess.index.cond.comp
    held = bad = 0
    t0 = time.perf_counter()
    for i, q in enumerate(reopen[:done]):
        a, b = int(comp[qs[q]]), int(comp[qt[q]])
        if (a, b) in on_host:
            continue
        bad += ov.host_reachable(a, b) != bool(ans[i])
        held += 1
        if time.perf_counter() - t0 > CHURN_HOLD_SECONDS:
            break
    print(f"  open batch: {held} answers the card resolved held against "
          f"the host BFS in {time.perf_counter() - t0:.1f} s, {bad} "
          f"mismatches", flush=True)
    check(bad == 0, "churn open batch: answers differ from the host BFS")
    step = {}
    hold_step_calls(rec, "churn open batch", err, step)
    print(f"  open batch: the step of most swept pairs held has "
          f"{step.get('rows', 0)} ({step.get('candidates', 0)} candidates)",
          flush=True)
    return time.perf_counter() - t_start


def churn_phase(dev, rec, err, wf):
    """Live updates on the wavefront phase's loaded session (the main
    graph at ferrari-web widths, bound to its artifact): four insert
    batches that keep the condensation a DAG and fill the overlay, each
    followed by 2^17 random queries over the union graph (kernels 1, 3,
    4; kernel 4's overlay rule); then a reload that replays the delta
    log, ``compact()`` (kernel 5 in every affected wave), and a reload of
    the compacted epoch, all with the same answers.

    The tails come before the giant component in topological order: a
    tail the giant component reaches puts it in can_reach_tail, and then
    every base-NEG query from it (most random sources) reopens and sweeps
    its whole out-list (~1.5M tail edges at 4M nodes) a step, which
    overflows every cap up to frontier_cap_max into the host fallback."""
    import torch

    from repro_torch.core import packed as packed_mod
    from repro_torch.core.workload import random_queries
    from repro_torch.kernels import frontier_fused as ff
    from repro_torch.kernels import merge_cover as mc
    from repro_torch.kernels import ops
    from repro_torch.reach import QuerySession, persist
    from repro_torch.reach.dynamic import overlay as overlay_mod
    from repro_torch.reach.dynamic import relabel
    sess, path, g = wf["session"], wf["path"], wf["g"]
    eng = sess.engine
    ix0 = sess.index
    ell, tsrc, _, _ = eng._ell()
    w, cap = ell.shape[1], eng.frontier_cap
    m_u = tsrc.shape[0] + eng.overlay_cap
    q = eng._phase2_chunk_size(w, m_u)
    worst = cap * w + q * m_u
    print(f"churn: {CHURN_BATCHES} insert batches of {CHURN_EDGES} edges "
          f"on the wavefront phase's loaded session ({eng.packed.n} "
          f"condensed nodes, bound to its artifact); union tail "
          f"{tsrc.shape[0]} + {eng.overlay_cap}; a step's swept pairs at most "
          f"{worst} (cap {cap} x W {w} + {q} queries x {m_u}; kernel 3 takes "
          f"< {ff.MAX_CANDIDATES})", flush=True)
    check(worst < ff.MAX_CANDIDATES, "churn: the union tail exceeds kernel "
          "3's candidate space")
    seconds = {}
    rng = np.random.default_rng(11)
    qs, qt = random_queries(g, 1 << 17, seed=12)
    giant = int(np.argmax(ix0.cond.comp_size))
    tau = ix0.tl.tau[:ix0.cond.n_comp]
    print(f"  giant component: {int(ix0.cond.comp_size[giant])} of "
          f"{g.n} nodes, {int(ix0.cond.dag.degrees()[giant])} condensed "
          f"out-edges, {int((tau < tau[giant]).sum())} components before "
          f"it in topological order (the tails' pool); "
          f"{float(np.mean(ix0.cond.comp[qs] == giant)):.2%} of the random "
          f"sources are in it", flush=True)
    v, cs, _ = eng.classify(qs, qt)
    base_neg = v.cpu().numpy() == ops.NEG
    cs = cs.cpu().numpy()
    served = collections.Counter()
    hits, kept = 0, {}
    watch = Stopwatch()
    watch.watch(overlay_mod.DeltaOverlay, "_mark_ancestors")
    try:
        for b in range(CHURN_BATCHES):
            src, dst = dag_inserts(ix0, rng, CHURN_EDGES)
            t0 = time.perf_counter()
            applied = sess.apply_updates(src, dst)
            t_apply = time.perf_counter() - t0
            ov = eng.overlay
            reopened = int((base_neg & ov.can_reach_tail[cs]).sum())
            reset_counters()
            rec.reset()
            ans, st = serve(sess, qs, qt, f"batch {b + 1}")
            counts = read_counters()
            calls = [c for c in rec.expansions if c["crt"] is not None]
            served.update({k: counts[k] for k in ("probe", "classify_emit",
                                                  "stab_packed")})
            print(f"  batch {b + 1}: {applied} new edges (overlay "
                  f"{ov.n_edges}/{ov.cap}), apply_updates {t_apply:.3f} s "
                  f"(ancestor marking {watch.seconds['_mark_ancestors']:.3f}"
                  f" s so far), can_reach_tail {int(ov.can_reach_tail.sum())}"
                  f" of {ov.n} nodes; {st.ns_per_query:.0f} ns/query, "
                  f"reopened {reopened} ({reopened / qs.size:.2%}), "
                  f"n_overlay_hits {st.n_overlay_hits}; {len(calls)} overlay "
                  f"expansion calls, {counts['sparse_steps']} steps, "
                  f"{counts['sparse_syncs']} syncs "
                  f"({counts['sparse_syncs'] / max(len(calls), 1):.2f} a "
                  f"call), kernels 3/4 {counts['probe']}/"
                  f"{counts['classify_emit']}", flush=True)
            check(applied > 0, "churn: no insert was new")
            check(len(calls) > 0 and len(calls) == len(rec.expansions),
                  "churn: phase 2 did not take the overlay path")
            check(counts["sparse_syncs"] == len(calls)
                  and counts["sparse_helpers"] == 2 * len(calls),
                  "churn: an overlay call was not one graph (one sync)")
            check(counts["probe"] == counts["classify_emit"]
                  == counts["sparse_steps"] > 0,
                  "churn: kernels 3 and 4 must launch once a step")
            hits += st.n_overlay_hits
            # the batch's largest and smallest overlay calls, replayed and
            # held word for word before the next batch rewrites the union
            # tables; the step of most swept pairs over all batches is kept
            step = {}
            hold_step_calls(rec, f"churn batch {b + 1}", err, step)
            print(f"  batch {b + 1}: the step of most swept pairs held has "
                  f"{step.get('rows', 0)} ({step.get('candidates', 0)} "
                  "candidates)", flush=True)
            if step.get("rows", -1) > kept.get("rows", -1):
                kept = step
        check(hits > 0, "churn: no overlay hit in four batches")
        states = [s for s in eng._sparse_state.values()
                  if s.tables["can_reach_tail"] is not None]
        print(f"  overlay loop states {len(states)} (caps "
              f"{sorted(s.cap for s in states)}), graphs captured "
              f"{sum(s.graph is not None for s in states)}", flush=True)
        check(len({s.cap for s in states}) == len(states),
              "churn: more than one overlay state for a cap")
    finally:
        watch.close()
    seconds["mark_ancestors"] = watch.seconds["_mark_ancestors"]

    t0 = time.perf_counter()
    replayed = QuerySession.load(path, device=dev)
    seconds["reload + replay"] = time.perf_counter() - t0
    got = replayed.query(qs, qt)
    print(f"  reload + replay of {len(persist.load_deltas(path, 0))} log "
          f"batches: {seconds['reload + replay']:.1f} s, overlay "
          f"{replayed.stats.overlay_edges} edges; answers differ in "
          f"{int((got != ans).sum())}", flush=True)
    check(np.array_equal(got, ans) and replayed.stats.overlay_edges
          == eng.overlay.n_edges, "churn: the replayed session differs")
    del replayed

    watch = Stopwatch()
    watch.watch(packed_mod, "pack_index")
    watch.watch(persist, "save_index")
    watch.watch(relabel, "union_dag")
    build_rec = BuildRecorder()
    reset_counters()
    try:
        t0 = time.perf_counter()
        cst = sess.compact()
        torch.cuda.synchronize()
        seconds["compact"] = time.perf_counter() - t0
    finally:
        build_rec.close()
        watch.close()
    launches = read_counters()["merge_cover"]
    bad = 0
    for args, out in build_rec.calls:
        want = mc.merge_cover_plain(*args)
        bad += sum(int((a != b).sum()) for a, b in zip(out, want))
    torch.cuda.synchronize()
    seconds.update({f"compact: {k}": v for k, v in watch.seconds.items()})
    print(f"  compact: {seconds['compact']:.1f} s = union_dag "
          f"{watch.seconds['union_dag']:.2f} s, topological order + levels "
          f"+ affected set {cst.seconds_condense - watch.seconds['union_dag']:.2f}"
          f" s, rebuild_affected {cst.seconds_assign:.2f} s, seeds "
          f"{cst.seconds_seeds:.2f} s, pack_index "
          f"{watch.seconds['pack_index']:.2f} s, save_index "
          f"{watch.seconds['save_index']:.2f} s, the rest "
          f"{seconds['compact'] - cst.seconds_total - watch.seconds['pack_index'] - watch.seconds['save_index']:.2f}"
          f" s; builder {cst.builder}, affected_nodes {cst.affected_nodes}, "
          f"waves {cst.waves_touched} of {cst.waves_total}, hub_nodes "
          f"{cst.hub_nodes}, merge_rounds {cst.merge_rounds}, "
          f"host_fallbacks {cst.host_fallbacks}; merge_cover launches "
          f"{launches} ({len(build_rec.calls)} calls), parity {bad} "
          f"mismatches", flush=True)
    check(cst.builder == "compact" and 0 < cst.waves_touched
          < cst.waves_total, "churn: compact was not the bounded path")
    check(launches == len(build_rec.calls) > 0 and bad == 0,
          "churn: kernel 5 under compaction disagrees with its plain "
          "version")
    _tally(err, "merge_cover", (0, bad, 0.0))
    served["merge_cover"] = launches
    build_rec.calls = []
    got, _ = serve(sess, qs, qt, "compacted")
    check(np.array_equal(got, ans), "churn: answers after compact differ "
          "from the overlay's")
    hold_to_host(sess.index, sess, qs, qt, got, 2000, "churn compacted")

    t0 = time.perf_counter()
    epoch1 = QuerySession.load(path, device=dev)
    seconds["reload epoch 1"] = time.perf_counter() - t0
    got = epoch1.query(qs, qt)
    print(f"  reload of epoch {epoch1.epoch}: "
          f"{seconds['reload epoch 1']:.1f} s, overlay "
          f"{epoch1.stats.overlay_edges} edges; answers differ in "
          f"{int((got != ans).sum())}", flush=True)
    check(epoch1.epoch == 1 and epoch1.stats.overlay_edges == 0
          and np.array_equal(got, ans), "churn: the epoch-1 reload differs")
    seconds["open batch"] = open_batch(epoch1, qs, qt, got, rng, rec, err)
    del epoch1
    print("  churn seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in seconds.items()), flush=True)
    return dict(served), kept


def _sparse_line(counts, rec) -> None:
    steps = counts["sparse_steps"]
    print(f"  sparse loop: {len(rec.expansions)} expansion calls, {steps} "
          f"steps, {counts['sparse_syncs']} syncs, "
          f"{counts['sparse_launches']} launches of kernels 3 and 4 "
          f"({counts['sparse_launches'] / max(steps, 1):.2f} a step), "
          f"{counts['sparse_helpers']} of set-up and clean-up", flush=True)


# the sparse loop's kernels as the profiler names them
STEP_KERNELS = {"probe": "expand_probe_kernel",
                "classify_emit": "dedup_classify_emit_kernel",
                "helpers": ("setup_kernel", "cleanup_kernel")}


def listed_step_kernels(rows) -> dict:
    """The profiler's launches of the sparse loop's kernels (rows of
    ``profile_window``), keyed as their counters."""
    out = dict.fromkeys(STEP_KERNELS, 0)
    for _, count, key in rows:
        for name, kernels in STEP_KERNELS.items():
            kernels = kernels if isinstance(kernels, tuple) else (kernels,)
            if any(f"::{k}(" in key for k in kernels):
                out[name] += count
    return out


def profile_launch_counts(fn, label):
    """Runs ``fn`` under the profiler (``profile_window``) and prints the
    profiler's launches of the loop's kernels beside the kernels' own
    counts in the same run."""
    _, wall = _timed(fn)
    reset_counters()
    listed = listed_step_kernels(profile_window(fn, label, wall=wall))
    c = read_counters()
    counted = {"probe": c["probe"], "classify_emit": c["classify_emit"],
               "helpers": c["sparse_helpers"]}
    print(f"  profiler lists {listed}; the kernels counted {counted} over "
          f"{c['sparse_steps']} steps", flush=True)
    return listed, counted


def profiler_loss(sess, rec, reps: int = 30) -> None:
    """Why the profiler lists fewer launches than the kernels count: the
    phase's largest call, each run under a profiler of its own, ``reps``
    times each way — served through the engine's graph (built before the
    profiler ran), through a graph built under the profiler (a fresh
    workspace each run), and stepped from the host (standalone launches,
    ``replay_call``): per run, the profiler's launches of kernels 3 and 4
    against their counters."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import frontier_fused as ff
    call = max(rec.expansions, key=lambda c: c["steps"])
    dev, (ell, tsrc, tdst, is_hub, cs, ct, pad) = call["dev"], call["args"]
    pad_np = pad.cpu().numpy()
    cap = call["kw"]["cap"]

    def fresh():
        ff.expand_frontier_loop_fused(
            ell, tsrc, tdst, is_hub, cs, ct, pad, n_nodes=ell.shape[0],
            max_steps=call["kw"]["max_steps"], cap=cap,
            tables={"meta": dev["meta"], "slab": dev["slab"]},
            workspaces={})
    for how, fn in (("engine's graph", lambda: sess.engine._expand_chunk(
            cs, ct, pad_np, cap)), ("a graph built under the profiler",
                                    fresh),
            ("stepped", lambda: replay_call(call))):
        runs = collections.Counter()
        for _ in range(reps):
            reset_counters()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            listed = listed_step_kernels(
                [(0, e.count, e.key) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA])
            c = read_counters()
            runs[(listed["probe"], c["probe"], listed["classify_emit"],
                  c["classify_emit"])] += 1
        print(f"  profiler vs counters, the largest call ({call['steps']} "
              f"steps) {how}, {reps} runs: " + ", ".join(
                  f"{n}x probe {a}/{b}, classify_emit {x}/{y}"
                  for (a, b, x, y), n in sorted(runs.items())), flush=True)


def hub_call(sess, q: int, cap: int):
    """An expansion call on ``sess``'s index whose Q sources are its hubs,
    in turn (the COO tail swept at the first step: Q x m_t candidates),
    and whose targets are random."""
    import torch
    eng = sess.engine
    ell, tsrc, tdst, is_hub = eng._ell()
    hubs = torch.nonzero(is_hub).flatten().int()
    hubs = hubs[torch.arange(q, device=hubs.device) % hubs.numel()]
    g = torch.Generator(device=hubs.device)
    g.manual_seed(1)
    ct = torch.randint(0, eng.packed.n, (q,), generator=g,
                       device=hubs.device, dtype=torch.int32)
    pad = torch.zeros(q, dtype=torch.bool, device=hubs.device)
    return dict(dev=eng.dev, args=(ell, tsrc, tdst, is_hub, hubs, ct, pad),
                kw=dict(max_steps=1, cap=cap))


def phase2_phase(dev, rec, err, gloo_work):
    """The weak 1M index's sparse phase 2 at the default cap and at 256
    (the overflow retry); the index at the default cap is also saved under
    ``gloo_work``, with 2^16 of the pairs, for the gloo pair
    (``gloo_artifact``)."""
    from repro_torch.core.workload import random_queries
    from repro_torch.kernels import frontier_fused as ff
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec, save_index
    print(f"phase2: scale_free_digraph({SIDE_NODES}, 4.0), k=1, no seeds, "
          "sparse phase 2", flush=True)
    g = scale_free_digraph(SIDE_NODES, 4.0, seed=3)
    qs, qt = random_queries(g, 1 << 18, seed=4)
    out, built, kept = {}, None, {}
    for cap in (IndexSpec.frontier_cap, 256):
        spec = IndexSpec(k=1, use_seeds=False, phase2_mode="sparse",
                         frontier_cap=cap)
        ix, sess, built = make_session(g, spec, dev, built)
        sess.query(qs[:spec.max_batch], qt[:spec.max_batch])  # warm up
        reset_counters()
        rec.reset()
        ans, st = serve(sess, qs, qt, f"frontier_cap={cap}")
        counts, calls = read_counters(), dict(rec.calls)
        print(f"  counts: {counts}", flush=True)
        _sparse_line(counts, rec)
        check(st.phase2_sparse > 0, "phase2: no sparse phase-2 traffic")
        if cap == IndexSpec.frontier_cap:
            # one graph a call: kernels 3 and 4 once a step, one sync a call
            check(counts["probe"] == counts["classify_emit"]
                  == counts["sparse_steps"] > 0, "phase2: kernels 3 and 4 "
                  "must launch once a BFS step")
            check(counts["sparse_syncs"] == len(rec.expansions),
                  "phase2: one host sync a call")
            check(counts["sparse_helpers"] == 2 * len(rec.expansions),
                  "phase2: set-up and clean-up must launch once a call")
        if cap == 256:
            check(st.sparse_retries > 0, "phase2: cap 256 did not retry")
            print(f"  sparse_retries > 0: {st.sparse_retries}", flush=True)
        hold_to_host(ix, sess, qs, qt, ans, 2000, f"cap={cap}")
        hold_step_calls(rec, f"phase2 cap {cap}", err,
                        kept if cap == IndexSpec.frontier_cap else {})
        if cap == IndexSpec.frontier_cap:
            largest = max(rec.expansions, key=lambda c: c["steps"])
            sparse_host_split(sess, largest)
            profiler_loss(sess, rec)
            states, _ = replay_call(hub_call(sess, 256, cap))
            check(int(states[0][0].ctl[ff.HUB]) == 1,
                  "phase2: the hub call's first front has no hub")
            for i, state in enumerate(states):
                hold_step(state, f"phase2 hub call (256 hub sources, cap "
                          f"{cap}, {_swept(state[0])} swept pairs, "
                          f"{_candidates(state[0], state[1])} candidates), "
                          f"step {i}", err)
            del states
        profile_launch_counts(lambda: sess.query(qs, qt),
                              f"cap={cap}, {qs.size} queries")
        if cap == IndexSpec.frontier_cap:
            path = gloo_work / "phase2"
            save_index(path, ix, spec, packed=built[1], ell=built[2])
            out["gloo"] = gloo_artifact(
                GLOO_WEAK, sess, path, qs[:GLOO_WEAK_PAIRS],
                qt[:GLOO_WEAK_PAIRS], gloo_work / "pairs_phase2.npz", True)
        out.setdefault("counts", counts)
        out.setdefault("calls", calls)
        out.setdefault("answers", ans)
        check(np.array_equal(out["answers"], ans),
              "phase2: answers differ between the two caps")
    return out["counts"], out["calls"], kept, out["gloo"]


def seeds64_phase(dev, rec, err):
    from repro_torch.core.workload import random_queries
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec
    print(f"seeds64: scale_free_digraph({SIDE_NODES}, 4.0), k=1, 64 seeds, "
          "sparse phase 2", flush=True)
    g = scale_free_digraph(SIDE_NODES, 4.0, seed=5)
    spec = IndexSpec(k=1, n_seeds=64, phase2_mode="sparse")
    ix, sess, _ = make_session(g, spec, dev)
    check("slab" not in sess.engine.dev, "seeds64 must use the 12-array "
          "layout")
    qs, qt = random_queries(g, 1 << 18, seed=6)
    sess.query(qs[:spec.max_batch], qt[:spec.max_batch])
    reset_counters()
    rec.reset()
    ans, st = serve(sess, qs, qt, "random")
    counts, calls = read_counters(), dict(rec.calls)
    print(f"  counts: {counts}", flush=True)
    _sparse_line(counts, rec)
    check(st.phase2_sparse > 0, "seeds64: no sparse phase-2 traffic")
    check(counts["probe"] > 0, "seeds64: phase 2 did not launch kernel 3")
    hold_to_host(ix, sess, qs, qt, ans, 2000, "seeds64")
    hold_step_calls(rec, "seeds64", err, {})
    return counts, calls


def dense_phase(dev, rec):
    """The dense phase 2, then one churn round: 256 negative query pairs
    inserted as edges in topological order (the condensation stays a
    DAG), and the union-graph answers held against the brute-force
    closure of the condensed union graph."""
    from repro_torch.core.query import QueryEngine, brute_force_closure
    from repro_torch.core.query_torch import DENSE
    from repro_torch.core.workload import random_queries
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec
    from repro_torch.reach.dynamic import union_dag
    print("dense: scale_free_digraph(16000, 4.0), k=1, no seeds, dense "
          "phase 2", flush=True)
    g = scale_free_digraph(16_000, 4.0, seed=7)
    spec = IndexSpec(k=1, use_seeds=False, phase2_mode="dense")
    ix, sess, _ = make_session(g, spec, dev)
    check(sess.engine.packed.n <= 8192, "dense graph over 8192 nodes")
    qs, qt = random_queries(g, 1 << 15, seed=8)
    eng = sess.engine
    driver, spent = eng._dense_driver, []

    def timed_driver(*args, **kw):
        t0 = time.perf_counter()
        out = driver(*args, **kw)          # ends in a copy to the host
        spent.append(time.perf_counter() - t0)
        return out
    eng._dense_driver = timed_driver

    def dense_line(label):
        print(f"  dense phase 2 {label}: {len(spent)} driver calls, "
              f"{DENSE['steps']} BFS steps, {DENSE['syncs']} syncs, "
              f"{sum(spent) * 1e3:.1f} ms", flush=True)
    reset_counters()
    DENSE.reset()
    rec.reset()
    ans, st = serve(sess, qs, qt, "random")
    counts, calls = read_counters(), dict(rec.calls)
    print(f"  counts: {counts}", flush=True)
    dense_line("(base)")
    check(st.phase2_dense > 0, "dense: no dense phase-2 traffic")
    want = QueryEngine(ix).batch(qs, qt)
    bad = int((ans != want).sum())
    print(f"  host check dense: {qs.size} answers, {bad} mismatches",
          flush=True)
    check(bad == 0, "dense: answers differ from the host engine")

    # 256 of the negative pairs, inserted as edges where they follow the
    # topological order (the condensation stays a DAG): each flips its
    # own query at least
    comp, tau = ix.cond.comp, ix.tl.tau
    neg = np.flatnonzero(~ans & (tau[comp[qs]] < tau[comp[qt]]))
    pick = np.random.default_rng(13).choice(neg, 256, replace=False)
    applied = sess.apply_updates(qs[pick], qt[pick])
    spent.clear()
    DENSE.reset()
    ans, st = serve(sess, qs, qt, "random after inserts")
    dense_line("(overlay)")
    esrc, edst = eng.overlay.edges()
    closure = brute_force_closure(union_dag(ix.cond.dag, esrc, edst))
    bad = int((ans != closure[comp[qs], comp[qt]]).sum())
    print(f"  churn round: {applied} new edges, n_overlay_hits "
          f"{st.n_overlay_hits}; brute-force closure check: {qs.size} "
          f"answers, {bad} mismatches", flush=True)
    check(st.n_overlay_hits > 0, "dense: no overlay hit")
    check(bad == 0, "dense: overlay answers differ from the closure")
    return counts, calls


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev, copy=True)


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_clone(v) for v in tree]
    return tree.clone()


def _timed(fn):
    """(result, wall seconds) of ``fn()`` ending in a device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def forward_atol(want) -> float:
    return FORWARD_ATOL * max(1.0, float(want.abs().max()))


def _hold(label, got, want) -> None:
    atol = forward_atol(want)
    err, bad, rel = close_stats(got, want, FORWARD_RTOL, atol)
    print(f"  card vs CPU {label}: {want.numel()} values, {bad} mismatches, "
          f"max abs err {err:.3e}, max rel err {rel:.3e} (rtol "
          f"{FORWARD_RTOL}, atol {atol:.3e})", flush=True)
    check(bad == 0, f"{label}: the card disagrees with the CPU run")


def _top_items_agree(ids, got, want, k: int = 100) -> int:
    """Items in the card's top k and not the CPU's, or the reverse, that
    do not tie with the CPU's k-th score within the forward tolerance."""
    import torch
    g_pos = torch.topk(got, k).indices.numpy()
    w_val, w_pos = torch.topk(want, k)
    cut = float(w_val[-1])
    score = {int(ids[p]): float(want[p]) for p in np.concatenate([g_pos,
                                                                  w_pos])}
    differ = set(ids[g_pos].tolist()) ^ set(ids[w_pos.numpy()].tolist())
    tol = forward_atol(want) + FORWARD_RTOL * abs(cut)
    bad = [it for it in differ if abs(score[it] - cut) > tol]
    print(f"  top {k}: {len(differ)} items differ between card and CPU, "
          f"{len(bad)} of them not tied at the cut-off ({cut:.6f}); card's "
          f"best: {[(int(ids[p]), round(float(got[p]), 6)) for p in g_pos[:3]]}",
          flush=True)
    return len(bad)


def recsys_phase(dev, rec, seed: int):
    """MIND at its published widths through build_cell: serve_p99,
    serve_bulk and retrieval_cand on the card, then the same cells on the
    CPU on the same state (64 sampled users; every retrieval score)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config("mind")
    print(f"recsys: mind, {cfg.n_items} items x D {cfg.embed_dim}, "
          f"{cfg.n_interests} interests, {cfg.capsule_iters} routing "
          f"rounds, history {cfg.hist_len}", flush=True)
    names = ("serve_p99", "serve_bulk", "retrieval_cand")
    cells = {name: api.build_cell(cfg, name, device=dev) for name in names}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state, dt = _timed(lambda: api.materialize_state(
        cells["serve_p99"], cfg, "serve_p99", gen))
    table = state["params"]["table"]
    print(f"  state: table {tuple(table.shape)} "
          f"{table.numel() * 4 / 1e9:.2f} GB on the card in {dt:.2f} s",
          flush=True)
    rng = np.random.default_rng(seed)
    batches = {}
    for name, cell in cells.items():
        batches[name] = {
            key: ((rng.random(shape) < 0.9).astype(np.float32)
                  if key == "hist_mask" else
                  rng.integers(0, cfg.n_items, shape).astype(np.int32))
            for key, (shape, _) in cell.batch_shapes.items()}
    on_card = {name: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for name, b in batches.items()}
    fig = dry_predict("recsys", cfg, "retrieval_cand",
                      cells["retrieval_cand"].shape)
    for name, cell in cells.items():              # warm up
        if name == "retrieval_cand":              # the dry run's check
            with DryrunHold("recsys", fig, dev):
                cell.step(state, on_card[name])
        else:
            cell.step(state, on_card[name])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    rec.reset()
    outs = {}
    for name, cell in cells.items():
        (_, outs[name]), dt = _timed(lambda: cell.step(state, on_card[name]))
        print(f"  {name}: {dict((k, tuple(v[0])) for k, v in cell.batch_shapes.items())}"
              f" -> {tuple(outs[name].shape)} in {dt * 1e3:.3f} ms",
              flush=True)
        check(bool(torch.isfinite(outs[name]).all()),
              f"recsys {name}: non-finite output")
    counts, calls = read_counters(), dict(rec.calls)
    print(f"  counts: {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    check(counts["retrieval_score"] > 0, "recsys: kernel 10 not launched")

    cpu_state = _tree_to(state, "cpu")
    for name in ("serve_p99", "serve_bulk"):
        shape = cells[name].shape
        idx = np.sort(rng.choice(shape.batch, 64, replace=False))
        cpu = api.build_cell(cfg, name, device="cpu",
                             shape_override=dataclasses.replace(shape,
                                                                batch=64))
        _, want = cpu.step(cpu_state, {k: torch.from_numpy(v[idx])
                                       for k, v in batches[name].items()})
        _hold(f"{name} interests of 64 sampled users",
              outs[name][torch.from_numpy(idx).to(dev)].cpu(), want)
    cpu = api.build_cell(cfg, "retrieval_cand", device="cpu")
    (_, want), dt = _timed(lambda: cpu.step(
        cpu_state, {k: torch.from_numpy(v)
                    for k, v in batches["retrieval_cand"].items()}))
    print(f"  retrieval_cand on the CPU: {dt:.2f} s", flush=True)
    got = outs["retrieval_cand"].cpu()
    _hold("retrieval_cand scores", got, want)
    bad = _top_items_agree(batches["retrieval_cand"]["cand_ids"], got, want)
    check(bad == 0, "recsys: the top 100 differ beyond ties")
    del cpu_state, want
    profile_window(lambda: cells["retrieval_cand"].step(
        state, on_card["retrieval_cand"]),
        "recsys retrieval_cand (1 user x 1,000,448 candidates)")
    return counts, calls


def gnn_phase(dev, rec, seed: int):
    """forward_dense at full config width on the molecule shape for the
    four GNN archs, and gin-tu on a bulk batch, held against the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import shapes_for_family
    from repro_torch.models import gnn
    shp = shapes_for_family("gnn")["molecule"]
    b_mol, n = shp.batch_graphs, shp.nodes_per_graph
    print(f"gnn: forward_dense on the molecule shape ({b_mol} graphs x {n} "
          f"nodes, d_feat {shp.d_feat}, {shp.n_classes} classes, ~20% "
          f"dense) for {', '.join(GNN_ARCHS)}; gin-tu on "
          f"{GNN_BULK_GRAPHS} graphs", flush=True)
    rng = np.random.default_rng(seed + 1)
    inputs = {}
    for b in (b_mol, GNN_BULK_GRAPHS):
        inputs[b] = ((rng.random((b, n, n)) < 0.2).astype(np.float32),
                     rng.standard_normal((b, n, shp.d_feat)).astype(
                         np.float32))
    on_card = {b: tuple(torch.from_numpy(a).to(dev) for a in inp)
               for b, inp in inputs.items()}
    models = {}
    for i, arch in enumerate(GNN_ARCHS):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + i)
        cfg = get_config(arch)
        models[arch] = (cfg, gnn.init_params(cfg, gen, shp.d_feat,
                                             shp.n_classes, dev))
    runs = [(arch, b_mol) for arch in GNN_ARCHS] + [("gin-tu",
                                                     GNN_BULK_GRAPHS)]
    for arch, b in runs:                          # warm up
        gnn.forward_dense(*models[arch], *on_card[b])
    reset_counters()
    rec.reset()
    logits = {}
    for arch, b in runs:
        cfg, params = models[arch]
        logits[(arch, b)], dt = _timed(
            lambda: gnn.forward_dense(cfg, params, *on_card[b]))
        print(f"  {arch} ({cfg.conv}, {cfg.n_layers} layers, d_hidden "
              f"{cfg.d_hidden}): {b} graphs in {dt * 1e3:.3f} ms", flush=True)
        check(bool(torch.isfinite(logits[(arch, b)]).all()),
              f"gnn {arch}: non-finite logits")
    counts = read_counters()
    calls = {"largest": dict(rec.calls), "smallest": dict(rec.small),
             "mp_shapes": dict(rec.mp_calls)}
    want_launches = sum(models[a][0].n_layers for a, _ in runs
                        if models[a][0].conv != "gatedgcn")
    print(f"  counts: {counts} (layers through kernel 9: {want_launches})",
          flush=True)
    check(counts["batched_mp"] == want_launches,
          "gnn: kernel 9 launches differ from the gin/gcn/sage layers")
    from repro_torch.kernels import batched_mp as bm
    for (b, n, f, h), times in sorted(rec.mp_shapes.items()):
        print(f"  kernel-9 call B={b} N={n} F={f} H={h} x{times}: "
              f"{bm.route(n, f, h)} route", flush=True)

    for (arch, b), out in logits.items():
        cfg, params = models[arch]
        idx = (np.arange(b) if b == b_mol else
               np.sort(rng.choice(b, 4096, replace=False)))
        adj, feats = inputs[b]
        want = gnn.forward_dense(cfg, _tree_to(params, "cpu"),
                                 torch.from_numpy(adj[idx]),
                                 torch.from_numpy(feats[idx]))
        _hold(f"{arch} logits, {idx.size} of {b} graphs",
              out[torch.from_numpy(idx).to(dev)].cpu(), want)
    rows = profile_window(lambda: gnn.forward_dense(
        *models["gin-tu"], *on_card[GNN_BULK_GRAPHS]),
        f"gnn gin-tu forward on {GNN_BULK_GRAPHS} graphs")
    parts = {"kernel 9": 0.0, "SGEMMs": 0.0, "rest": 0.0}
    for us, _, key in rows:
        low = key.lower()
        parts["kernel 9" if "batched_mp" in low else "SGEMMs"
              if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass"))
              else "rest"] += us / 1e3
    total = sum(parts.values())
    print("  split gnn gin-tu bulk forward: " + ", ".join(
        f"{k} {v:.3f} ms ({v / total:.1%})" for k, v in parts.items()),
        flush=True)
    return counts, calls

# ------------------------------------------------ GNN and recsys training --
GNN_TRAIN_STEPS = 3            # steps a train cell (the first one warms up)
GNN_TRAIN_MOLECULE = ("gin-tu", "gatedgcn")
PRODUCTS_NODES = 2_449_029     # ogb_products' graph before padding
PRODUCTS_EDGES = 61_859_140
GNN_CHECK = dict(nodes=20_000, edges=200_000, layers=2)   # card vs CPU
# BatchedMP's backward against autograd of the plain einsums: the gin
# layers' calls (F = H: I_F forward, I_H backward) at the molecule and the
# bulk batch, gcn/sage's (F 16 -> H 64, 64 -> 64), gatedgcn's width, and
# the tiled route (N 300)
MP_BWD_SHAPES = ((128, 30, 16, 16), (128, 30, 64, 64), (128, 30, 16, 64),
                 (GNN_BULK_GRAPHS, 30, 64, 64), (512, 30, 70, 70),
                 (16, 300, 64, 64))
RECSYS_TRAIN_STEPS = 3
RECSYS_CHECK_BATCH = 4096      # the SMOKE MIND train step, card vs CPU
REACH_DATASET = "products"     # synthetic_dataset's co-purchase graph
REACH_PAIRS = 1 << 20          # candidate pairs through the service
REACH_SAMPLE = 1 << 16         # of them, held against the host QueryEngine


def mp_bwd_parity(dev, err: dict) -> None:
    """``BatchedMP``'s dx and dw (kernel 9 forward, kernel 9 on adjᵀ, dy,
    I_H backward, then the two GEMMs) against autograd of the plain
    einsums on the same card tensors: rtol 1e-5, atol 1e-5 × the largest
    magnitude; tallied under ``batched_mp_bwd``."""
    import torch

    from repro_torch.kernels import batched_mp as bm
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for b, n, f, h in MP_BWD_SHAPES:
        adj = (torch.rand((b, n, n), generator=g, device=dev) < 0.2).float()
        x0 = torch.randn((b, n, f), generator=g, device=dev)
        w0 = torch.randn((f, h), generator=g, device=dev) * (2 / (f + h)) ** .5
        dy = torch.randn((b, n, h), generator=g, device=dev)
        grads = []
        for fn in (bm.BatchedMP.apply, bm.batched_mp_plain):
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            grads.append(torch.autograd.grad(fn(adj, x, w), (x, w), dy))
        for name, got, want in zip(("dx", "dw"), *grads):
            tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
            _tally(err, "batched_mp_bwd", _compare(
                f"BatchedMP backward {name} B={b} N={n} F={f} H={h} "
                f"({bm.route(n, h, h)} route) vs autograd of plain", got,
                want, tol))
    del adj, x0, dy, grads


class MpBwdRecorder:
    """Keeps the inputs of the largest kernel-9 call in ``BatchedMP``'s
    backward (adjᵀ, dy, I_H) while a phase runs; counting stays in the
    wrapper."""

    def __init__(self):
        from repro_torch.kernels import batched_mp as bm
        self.call, self.size, self._orig = None, 0, bm._call

        def wrapped(adj, x, w, counter):
            if counter == "batched_mp_bwd" and adj.is_cuda:
                size = adj.numel() + x.numel()
                if size > self.size:
                    self.call, self.size = (adj.shape[0], (adj, x, w)), size
            return self._orig(adj, x, w, counter)
        bm._call = wrapped

    def close(self):
        from repro_torch.kernels import batched_mp as bm
        bm._call = self._orig


def _card_batch(cell, n_classes: int, gen, dev) -> dict:
    """A batch at the cell's shape, drawn on the card from ``gen``."""
    import torch
    out = {}
    for key, (shape, _) in cell.batch_shapes.items():
        if key == "adj":
            out[key] = (torch.rand(shape, generator=gen, device=dev)
                        < 0.2).float()
        elif key == "feats":
            out[key] = torch.randn(shape, generator=gen, device=dev)
        else:
            top = (n_classes if key == "labels"
                   else cell.batch_shapes["feats"][0][0])
            out[key] = torch.randint(0, top, shape, generator=gen,
                                     device=dev, dtype=torch.int32)
    return out


def _train_steps(label, cell, state, batches, want=None, dry=None) -> dict:
    """Steps ``cell`` on each batch (a list, or a callable of the step
    index), printing each step's seconds, loss, grad_norm and the peak
    device memory; ``want``: the kernel launches each step must add;
    ``dry``: (phase, the dry run's figures) to hold the first step
    against (``DryrunHold``)."""
    import torch

    from repro_torch.kernels import _lib
    dev = cell.device
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"seconds": []}
    for i in range(GNN_TRAIN_STEPS):
        batch = batches(i) if callable(batches) else batches[i]
        before = dict(_lib.LAUNCHES)
        if dry is not None and i == 0:
            with DryrunHold(*dry, dev):
                (state, m), dt = _timed(lambda: cell.step(state, batch))
        else:
            (state, m), dt = _timed(lambda: cell.step(state, batch))
        step = {k: _lib.LAUNCHES[k] - before[k] for k in (want or {})}
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        out["seconds"].append(dt)
        print(f"  {label} step {i}: {dt:.4f} s, loss {loss:.4f}, grad_norm "
              f"{gnorm:.4f}, peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
              + (f"; launches {step}" if want else ""), flush=True)
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"{label}: non-finite loss or gradient")
        if want:
            check(step == want, f"{label}: launches per step {step}, "
                  f"expected {want}")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def _state_close(label, got, want) -> None:
    """Every leaf of a train state (params, m, v) on the card against the
    CPU's at the model tolerance: rtol 1e-4, atol 1e-5 × max|want| (at
    least 1e-5)."""
    import torch
    bad, worst = 0, 0.0
    for a, b in zip(_leaves(got), _leaves(want)):
        if b.dim() == 0 and b.dtype == torch.int32:
            check(int(a) == int(b), f"{label}: AdamW step counts differ")
            continue
        err, n_bad, _ = close_stats(a.cpu(), b, FORWARD_RTOL,
                                    forward_atol(b))
        bad, worst = bad + n_bad, max(worst, err)
    print(f"  card vs CPU {label}: params, m, v {bad} mismatches, max abs "
          f"err {worst:.3e}", flush=True)
    check(bad == 0, f"{label}: the card's train state differs from the CPU's")


def _card_vs_cpu_steps(label, cfg, shape_name, shp, batches, gen, dev):
    """The same steps of one train cell on the card and on the CPU from
    one state: loss and grad_norm at rtol 1e-4, then the whole state."""
    from repro_torch.models import api
    cells = {d: api.build_cell(cfg, shape_name, device=d, shape_override=shp)
             for d in (dev, "cpu")}
    card = api.materialize_state(cells[dev], cfg, shape_name, gen)
    host = _tree_to(card, "cpu")
    for i, batch in enumerate(batches):
        host, want = cells["cpu"].step(host, _tree_to(batch, "cpu"))
        card, got = cells[dev].step(card, batch)
        for key in ("loss", "grad_norm"):
            a, b = float(got[key]), float(want[key])
            check(abs(a - b) <= FORWARD_RTOL * abs(b),
                  f"{label} step {i}: {key} {a} on the card, {b} on the CPU")
        _state_close(f"{label} step {i} (loss {float(got['loss']):.6f})",
                     card, host)


def _padded_subgraph(g, feats, labels, shp, seed: int, dev):
    """One NeighborSampler batch of ``shp.batch_nodes`` targets over ``g``
    at ``shp.fanout``, padded to the minibatch cell's merged subgraph:
    pad edges on the last (unused) node, labels only on the targets."""
    import torch

    from repro_torch.data.graph_data import NeighborSampler
    from repro_torch.models.api import _gnn_subgraph_sizes
    n_sub, m_sub = _gnn_subgraph_sizes(shp)
    rng = np.random.default_rng(seed)
    targets = rng.choice(g.n, shp.batch_nodes, replace=False)
    (nodes, src, dst), dt = _timed(
        lambda: NeighborSampler(g, shp.fanout, seed=seed).sample(targets))
    check(len(nodes) < n_sub and len(src) <= m_sub,
          "minibatch: the sample exceeds the cell's subgraph")
    f = np.zeros((n_sub, feats.shape[1]), np.float32)
    f[:len(nodes)] = feats[nodes]
    lab = np.full(n_sub, -1, np.int32)
    lab[:len(targets)] = labels[targets]
    s = np.full(m_sub, n_sub - 1, np.int32)
    d = np.full(m_sub, n_sub - 1, np.int32)
    s[:len(src)], d[:len(dst)] = src, dst
    print(f"  NeighborSampler: {shp.batch_nodes} targets at fanout "
          f"{shp.fanout}: {len(nodes)} nodes, {len(src)} edges in {dt:.2f} s"
          f", padded to {n_sub} x {m_sub}", flush=True)
    return {k: torch.from_numpy(v).to(dev) for k, v in
            (("feats", f), ("src", s), ("dst", d), ("labels", lab))}


def gnn_train_phase(dev, seed: int, err: dict):
    """GNN training at the published widths through build_cell: gin-tu and
    gatedgcn on molecule (gin-tu also on 65,536 graphs; kernel 9 forward
    and backward), graphsage-reddit on minibatch_lg (one NeighborSampler
    batch over the reddit-like graph, then batches at the cell's shape)
    and on ogb_products at full size; BatchedMP's backward against the
    plain version; each conv's step cut to 2 layers on a 20k-node graph,
    card vs CPU. Returns (counts, the largest backward kernel-9 call)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import shapes_for_family
    from repro_torch.data.graph_data import synthetic_dataset
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.models import api
    t_phase = time.perf_counter()
    shapes = shapes_for_family("gnn")
    print("gnn_train: BatchedMP backward parity, then the train cells",
          flush=True)
    mp_bwd_parity(dev, err)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 40)
    rec = MpBwdRecorder()
    reset_counters()
    try:
        mol = shapes["molecule"]
        runs = [(arch, mol) for arch in GNN_TRAIN_MOLECULE] + [
            ("gin-tu", dataclasses.replace(mol, batch_graphs=GNN_BULK_GRAPHS))]
        for arch, shp in runs:
            cfg = get_config(arch)
            cell = api.build_cell(cfg, "molecule", device=dev,
                                  shape_override=shp)
            state = api.materialize_state(cell, cfg, "molecule", gen)
            # gin: kernel 9 once a layer forward, and once a layer
            # backward but the first, whose x (the features) and w (I_F)
            # take no gradient
            mp = 0 if cfg.conv == "gatedgcn" else cfg.n_layers
            dry = None
            if shp.batch_graphs == GNN_BULK_GRAPHS:   # the dry run's check
                dry = ("gnn_train", dry_predict("gnn_train", cfg,
                                                "molecule", shp))
            _train_steps(
                f"{arch} ({cfg.n_layers} layers, d {cfg.d_hidden}, remat "
                f"{cfg.remat}) molecule B {shp.batch_graphs}", cell, state,
                lambda i: _card_batch(cell, shp.n_classes, gen, dev),
                want={"batched_mp": mp, "batched_mp_bwd": max(mp - 1, 0)},
                dry=dry)
            del cell, state
        cfg = get_config("graphsage-reddit")
        shp = shapes["minibatch_lg"]
        cell = api.build_cell(cfg, "minibatch_lg", device=dev)
        state = api.materialize_state(cell, cfg, "minibatch_lg", gen)
        g, feats, labels, _ = synthetic_dataset("reddit", seed)
        first = _padded_subgraph(g, feats, labels, shp, seed, dev)
        del g, feats, labels
        _train_steps(f"graphsage-reddit minibatch_lg "
                     f"{cell.batch_shapes['feats'][0]}", cell, state,
                     lambda i: first if i == 0 else
                     _card_batch(cell, shp.n_classes, gen, dev))
        del cell, state, first
        torch.cuda.empty_cache()

        shp = shapes["ogb_products"]
        cell = api.build_cell(cfg, "ogb_products", device=dev)
        n = cell.batch_shapes["feats"][0][0]
        m = cell.batch_shapes["src"][0][0]
        gr, dt = _timed(lambda: scale_free_digraph(
            PRODUCTS_NODES, PRODUCTS_EDGES / PRODUCTS_NODES, seed=seed))
        src, dst = gr.edges()
        print(f"  ogb_products graph: scale_free_digraph({PRODUCTS_NODES}, "
              f"{PRODUCTS_EDGES / PRODUCTS_NODES:.4f}): {gr.m} edges in "
              f"{dt:.2f} s; padded to {n} nodes x {m} edges on the last "
              f"node", flush=True)
        pad = np.full(m - gr.m, n - 1, np.int32)
        edges = {k: torch.from_numpy(np.concatenate([a.astype(np.int32),
                                                     pad])).to(dev)
                 for k, a in (("src", src), ("dst", dst))}
        del gr, src, dst, pad
        labels = torch.randint(0, shp.n_classes, (n,), generator=gen,
                               device=dev, dtype=torch.int32)
        labels[PRODUCTS_NODES:] = -1
        batch = {"feats": torch.randn((n, shp.d_feat), generator=gen,
                                      device=dev),
                 "labels": labels, **edges}
        state = api.materialize_state(cell, cfg, "ogb_products", gen)
        prod = _train_steps(f"graphsage-reddit ogb_products ({n} nodes, {m} "
                            f"edges, d_feat {shp.d_feat})", cell, state,
                            [batch] * GNN_TRAIN_STEPS)
        del cell, state, batch, edges, labels
        torch.cuda.empty_cache()
    finally:
        rec.close()
    counts = read_counters()
    print(f"  counts: {counts}", flush=True)
    check(counts["batched_mp"] > 0 and counts["batched_mp_bwd"] > 0,
          "gnn_train: kernel 9 was not launched forward and backward")

    # card vs CPU: each conv cut to 2 layers on a 20k-node graph (the
    # ogb_products widths), and gin-tu's molecule step (kernel 9)
    c = GNN_CHECK
    small = dataclasses.replace(shapes["ogb_products"], n_nodes=c["nodes"],
                                n_edges=c["edges"])
    for arch in GNN_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=c["layers"])
        probe = api.build_cell(cfg, "ogb_products", device="cpu",
                               shape_override=small)
        batches = [_card_batch(probe, small.n_classes, gen, dev)
                   for _ in range(2)]
        _card_vs_cpu_steps(f"{arch} ({cfg.conv}, 2 layers, d "
                           f"{cfg.d_hidden}) on {c['nodes']} nodes", cfg,
                           "ogb_products", small, batches, gen, dev)
    cfg = get_config("gin-tu")
    probe = api.build_cell(cfg, "molecule", device="cpu")
    _card_vs_cpu_steps("gin-tu molecule (kernel 9 forward and backward)",
                       cfg, "molecule", mol,
                       [_card_batch(probe, mol.n_classes, gen, dev)
                        for _ in range(2)], gen, dev)
    print(f"  gnn_train: {time.perf_counter() - t_phase:.1f} s, "
          f"ogb_products peak {prod['peak_gb']:.2f} GB", flush=True)
    return counts, rec.call


def recsys_train_phase(dev, seed: int) -> dict:
    """MIND's train cell at the published config (2^23 items, D 64, 255
    negatives) on train_batch (B 65,536), uncut: three steps; then the
    SMOKE config's step, card vs CPU, for two steps."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import shapes_for_family
    from repro_torch.models import api
    t_phase = time.perf_counter()
    cfg = get_config("mind")
    cell = api.build_cell(cfg, "train_batch", device=dev)
    B = cell.shape.batch
    print(f"recsys_train: mind ({cfg.n_items} items x D {cfg.embed_dim}, "
          f"{cfg.n_negatives} negatives, history {cfg.hist_len}) on "
          f"train_batch B {B}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 50)
    state, dt = _timed(lambda: api.materialize_state(cell, cfg,
                                                     "train_batch", gen))
    print(f"  state: params and AdamW m, v "
          f"{sum(t.numel() * 4 for t in _leaves(state) if t.dim()) / 1e9:.2f}"
          f" GB on the card in {dt:.2f} s", flush=True)

    def batch(_):
        L = cfg.hist_len
        return {"hist_ids": torch.randint(0, cfg.n_items, (B, L),
                                          generator=gen, device=dev,
                                          dtype=torch.int32),
                "hist_mask": (torch.rand((B, L), generator=gen, device=dev)
                              < 0.9).float(),
                "target": torch.randint(0, cfg.n_items, (B,), generator=gen,
                                        device=dev, dtype=torch.int32),
                "negatives": torch.randint(0, cfg.n_items,
                                           (B, cfg.n_negatives),
                                           generator=gen, device=dev,
                                           dtype=torch.int32)}
    reset_counters()
    out = _train_steps(f"mind train_batch B {B}", cell, state, batch)
    del cell, state
    torch.cuda.empty_cache()
    small = get_smoke("mind")
    shp = dataclasses.replace(shapes_for_family("recsys")["train_batch"],
                              batch=RECSYS_CHECK_BATCH)
    probe_cfg = small

    def small_batch():
        L = probe_cfg.hist_len
        return {"hist_ids": torch.randint(0, small.n_items, (shp.batch, L),
                                          generator=gen, device=dev,
                                          dtype=torch.int32),
                "hist_mask": (torch.rand((shp.batch, L), generator=gen,
                                         device=dev) < 0.9).float(),
                "target": torch.randint(0, small.n_items, (shp.batch,),
                                        generator=gen, device=dev,
                                        dtype=torch.int32),
                "negatives": torch.randint(0, small.n_items,
                                           (shp.batch, small.n_negatives),
                                           generator=gen, device=dev,
                                           dtype=torch.int32)}
    _card_vs_cpu_steps(f"mind SMOKE ({small.n_items} items) train_batch B "
                       f"{shp.batch}", small, "train_batch", shp,
                       [small_batch() for _ in range(2)], gen, dev)
    print(f"  recsys_train: {time.perf_counter() - t_phase:.1f} s, peak "
          f"{out['peak_gb']:.2f} GB", flush=True)
    return read_counters()


def reach_service_phase(dev, seed: int) -> dict:
    """``ReachabilityService`` over the products-like graph (244,902
    nodes) on the card: 2^20 candidate pairs through
    ``filter_unreachable_pairs`` (kernel 1, kernels 3 and 4 where phase 2
    runs); the kept pairs of a 2^16 sample equal the host QueryEngine's."""
    import torch

    from repro_torch.data.graph_data import (ReachabilityService,
                                             synthetic_dataset)
    t_phase = time.perf_counter()
    g, *_ = synthetic_dataset(REACH_DATASET, seed)
    svc, dt = _timed(lambda: ReachabilityService(g, k=2, device=dev))
    print(f"reach_service: synthetic_dataset({REACH_DATASET!r}) n={g.n} "
          f"m={g.m}; ReachabilityService(k=2) built in {dt:.2f} s, phase 2 "
          f"{svc.engine.phase2_mode}", flush=True)
    rng = np.random.default_rng(seed + 60)
    s = rng.integers(0, g.n, REACH_PAIRS)
    t = rng.integers(0, g.n, REACH_PAIRS)
    svc.filter_unreachable_pairs(s[:4096], t[:4096])        # warm up
    svc.engine.stats.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    (ks, kt), dt = _timed(lambda: svc.filter_unreachable_pairs(s, t))
    counts = read_counters()
    st = svc.engine.stats
    print(f"  {REACH_PAIRS} candidate pairs: {len(ks)} kept (unreachable) "
          f"in {dt:.4f} s ({dt / REACH_PAIRS * 1e9:.1f} ns/pair); phase 1 "
          f"POS {st.phase1_pos}, NEG {st.phase1_neg}, phase 2 "
          f"{st.phase2_queries}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; counts "
          f"{counts}", flush=True)
    check(counts["stab_packed"] > 0, "reach_service: kernel 1 not launched")
    if st.phase2_sparse:
        check(counts["probe"] > 0 and counts["classify_emit"] > 0,
              "reach_service: phase 2 ran without kernels 3 and 4")
    idx = rng.choice(REACH_PAIRS, REACH_SAMPLE, replace=False)
    key = s.astype(np.int64) * g.n + t
    kept = np.isin(key[idx], ks.astype(np.int64) * g.n + kt)
    host, dt = _timed(lambda: svc.host.batch(s[idx], t[idx]))
    bad = int((kept != ~host).sum())
    print(f"  {REACH_SAMPLE} sampled pairs against the host QueryEngine "
          f"({dt:.2f} s): {int(kept.sum())} kept, {bad} mismatches; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(bad == 0, "reach_service: kept pairs differ from the host's")
    return counts


def _split(rows, label) -> dict:
    """Device ms of a profile's rows in three parts: kernel 6, the cuBLAS
    GEMMs and everything else."""
    parts = {"kernel 6": 0.0, "GEMMs": 0.0, "rest": 0.0}
    for us, _, key in rows:
        low = key.lower()
        part = ("kernel 6" if "flash_fwd" in low else "GEMMs"
                if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass"))
                else "rest")
        parts[part] += us / 1e3
    total = sum(parts.values())
    print(f"  split {label}: " + ", ".join(
        f"{k} {v:.3f} ms ({v / total:.1%})" for k, v in parts.items()),
        flush=True)
    return parts


def flash_tail_parity(tail, label: str):
    """Kernel 6 against its plain version on ``tail`` = (q, k, v, causal,
    q_offset), a path's call cut to its last query rows against all its
    (grouped) keys: out at ``LM_OUT_TOL`` relative to its largest
    magnitude, lse at ``FLASH_TOL``. Returns (max_abs_err, mismatches,
    max_rel_err)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, causal, q_offset = tail
    got = fa.flash_fwd(q, k, v, causal=causal, q_offset=q_offset)
    want = fa.flash_attention_plain(q, k, v, causal=causal,
                                    q_offset=q_offset)
    top = float(want[0].abs().max())
    label = (f"flash_fwd on {label} (q_offset {q_offset}, all {k.shape[1]} "
             f"keys, {k.shape[2]} kv heads)")
    parts = (_compare(f"{label}: out, max|want| {top:.3e}", got[0], want[0],
                      dict(rtol=LM_OUT_TOL, atol=LM_OUT_TOL * top)),
             _compare(f"{label}: lse", got[1], want[1],
                      FLASH_TOL[str(q.dtype).split(".")[-1]]))
    return (max(p[0] for p in parts), sum(p[1] for p in parts),
            max(p[2] for p in parts))


def time_flash(args, plain_args, label: str) -> dict:
    """Kernel 6 on the path's call ``args`` = (q, k, v, causal, q_offset),
    k and v grouped: its time beside its bound and SDPA's on the same
    tensors (``enable_gqa``), and SDPA's on k and v expanded to H heads;
    the plain version cannot hold the call's S² scores, so it is timed
    (with the kernel again) on ``plain_args``, the call's last query
    rows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    q, k, v, causal, q_offset = args
    h = q.shape[2]

    def kernel(a=args):
        return fa.flash_fwd(*a[:3], causal=a[3], q_offset=a[4])

    def sdpa(kk, vv):
        return lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            is_causal=causal, enable_gqa=kk.shape[2] != h)

    _, one = _timed(kernel)
    reps = 30 if one < 0.1 else 3
    ms = device_ms(kernel, reps=reps)
    library_ms = device_ms(sdpa(k, v))
    k_x, v_x = fa.expand_kv(k, h), fa.expand_kv(v, h)
    expanded_ms = device_ms(sdpa(k_x, v_x))
    del k_x, v_x
    slice_ms = device_ms(lambda: kernel(plain_args))
    plain_ms = device_ms(lambda: fa.flash_attention_plain(
        *plain_args[:3], causal=plain_args[3], q_offset=plain_args[4]))
    nbytes, ops = work_of("flash_fwd", args)
    peak = (BF16_TENSOR_OPS_PER_S if q.dtype == torch.bfloat16
            else ALU_OPS_PER_S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    rows = plain_args[0].shape[1]
    print(f"  time flash_fwd at {label} {tuple(q.shape)} x {tuple(k.shape)} "
          f"{str(q.dtype).split('.')[-1]}: kernel {ms:.4f} ms (median of "
          f"{reps}{'; one call > 100 ms' if reps < 30 else ''}), "
          f"{ops / ms / 1e9:.2f} TFLOP/s; library (SDPA, is_causal, "
          f"enable_gqa, the same tensors) {library_ms:.4f} ms, SDPA on k, v "
          f"expanded to {h} heads {expanded_ms:.4f} ms; bound "
          f"{max(t_bytes, t_ops):.4f} ms ({nbytes} B, {ops} flops at "
          f"{peak / 1e12:.0f} TFLOP/s; "
          f"{'bytes' if t_bytes >= t_ops else 'operations'}); its last "
          f"{rows} query rows: kernel {slice_ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms", flush=True)
    return dict(rows=q.shape[1], ms=ms, plain_ms=plain_ms,
                library="torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True, enable_gqa=True)",
                library_ms=library_ms, library_expanded_ms=expanded_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                plain_at=f"the last {rows} query rows (q_offset "
                         f"{plain_args[4]}) against all {k.shape[1]} keys",
                ms_at_plain_shape=slice_ms)


def decode_parity(q, k_cache, v_cache, pos: int) -> None:
    """The path's bfloat16 decode attention at ``pos`` against the same
    inputs widened to float32."""
    from repro_torch.models.attention import decode_attention
    got = decode_attention(q, k_cache, v_cache, pos)
    want = decode_attention(q.float(), k_cache.float(), v_cache.float(), pos)
    top = float(want.abs().max())
    atol = DECODE_TOL["atol"] * top
    err, bad, rel = close_stats(got.float(), want, DECODE_TOL["rtol"], atol)
    print(f"  parity decode attention {str(q.dtype).split('.')[-1]} vs "
          f"float32 at position {pos}, layer 0's cache: {bad} mismatches, "
          f"max abs err {err:.3e}, max|want| {top:.3e}, max rel err "
          f"{rel:.3e} (rtol {DECODE_TOL['rtol']}, atol {atol:.3e})",
          flush=True)
    check(bad == 0, "lm: bfloat16 decode attention disagrees with float32")


def lm_phase(dev, seed: int):
    """llama3-8b at full width and depth: the prefill_32k prompt at batch 1
    and greedy decode from its cache through ``launch.serve.generate``;
    kernel 6 on layer 0's call; then 2 layers in float32, card vs CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import shapes_for_family
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    cfg = get_config(LM_ARCH)
    shp = shapes_for_family("lm")["prefill_32k"]
    S = shp.seq_len
    print(f"lm: {cfg.arch_id} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}); prefill_32k: one "
          f"prompt of {S} tokens (batch cut {shp.batch} -> 1), then "
          f"{LM_DECODE} greedy decode steps from its cache", flush=True)
    cell = api.build_cell(cfg, "prefill_32k", device=dev,
                          shape_override=dataclasses.replace(shp, batch=1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state, dt = _timed(lambda: api.materialize_state(cell, cfg,
                                                     "prefill_32k", gen))
    params = state["params"]
    n_bytes = sum(t.numel() * t.element_size() for t in
                  [params["embed"], params["final_norm"], params["lm_head"],
                   *params["layers"].values()])
    print(f"  weights: {n_bytes / 1e9:.2f} GB on the card in {dt:.2f} s",
          flush=True)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=dev,
                         dtype=torch.int32)
    serve.generate(cfg, params, toks[:, :256], 2)          # warm up
    # the dry run's check: one step of the prefill cell, predicted first
    fig = dry_predict("lm", cfg, "prefill_32k", cell.shape)
    with DryrunHold("lm", fig, dev):
        out = cell.step(state, {"tokens": toks})
    del out

    captured = []
    attention = ops.attention

    def capture(q, k, v, **kw):
        if not captured:          # layer 0's call, by reference
            captured.append((q, k, v, kw["causal"], kw["q_offset"]))
        return attention(q, k, v, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    ops.attention = capture
    try:
        res = serve.generate(cfg, params, toks, LM_DECODE + 1)
    finally:
        ops.attention = attention
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    ms_tok = res["decode_s"] / res["decode_steps"] * 1e3
    print(f"  prefill {res['prefill_s']:.3f} s ({S / res['prefill_s']:.0f} "
          f"tokens/s), time to first token {res['ttft_s']:.3f} s; "
          f"{res['decode_steps']} decode steps in {res['decode_s']:.3f} s, "
          f"{ms_tok:.2f} ms per decoded token; peak device memory "
          f"{peak / 1e9:.2f} GB; tokens {res['tokens'][0, :8].tolist()}...",
          flush=True)
    print(f"  counts: {counts} (flash_fwd per prefill: {cfg.n_layers} "
          f"layers)", flush=True)
    check(counts["flash_fwd"] == cfg.n_layers,
          "lm: kernel 6 launches differ from the layers of one prefill")
    check(int(res["tokens"].min()) >= 0
          and int(res["tokens"].max()) < cfg.vocab, "lm: token out of range")

    max_seq = S + LM_DECODE + 1
    rows = profile_window(lambda: tf.prefill(cfg, params, toks, max_seq),
                          f"lm prefill of {S} tokens", top=8,
                          wall=res["prefill_s"])
    split = _split(rows, "prefill")
    logits, cache = tf.prefill(cfg, params, toks, max_seq)
    check(bool(torch.isfinite(logits).all()), "lm: non-finite logits")
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    profile_window(lambda: tf.decode_step(cfg, params, cache, nxt, S),
                   f"lm decode step at position {S}", top=8)
    q, k, v, causal, q_offset = captured[0]
    decode_parity(q[:, -1:], cache["k"][0], cache["v"][0], S - 1)
    del cache, logits

    n = LM_PARITY_ROWS
    tail = (q[:, -n:].contiguous(), k, v, causal, q_offset + S - n)
    err = flash_tail_parity(tail, f"layer 0's last {n} query rows")
    timing = time_flash(captured[0], tail, "the prefill's call")
    timing.update(err=err, prefill_split=split)
    del captured, tail, q, k, v, state, params, cell

    # card vs CPU: the same widths cut to 2 layers, float32
    small = dataclasses.replace(cfg, n_layers=LM_CHECK["layers"],
                                dtype="float32")
    gen.manual_seed(seed + 1)
    card = tf.init_params(small, gen, dev)
    host = _tree_to(card, "cpu")
    prompt = toks[:, :LM_CHECK["prompt"]]
    steps, p_len = LM_CHECK["steps"], LM_CHECK["prompt"]
    (want, cache_h), dt = _timed(lambda: tf.prefill(
        small, host, prompt.cpu(), p_len + steps))
    got, cache_d = tf.prefill(small, card, prompt, p_len + steps)
    print(f"  card vs CPU: {small.n_layers} layers, float32, a {p_len}-token "
          f"prompt and {steps} decode steps (CPU prefill {dt:.2f} s)",
          flush=True)
    _hold("prefill last-token logits", got.cpu(), want)
    for i in range(steps):
        tok = want.argmax(-1, keepdim=True).to(torch.int32)   # the CPU's
        want, cache_h = tf.decode_step(small, host, cache_h, tok, p_len + i)
        got, cache_d = tf.decode_step(small, card, cache_d, tok.to(dev),
                                      p_len + i)
        _hold(f"decode step {i} logits", got.cpu(), want)
    return counts, timing


class ExpertLoad:
    """Counts, per ``transformer.dispatch_tables`` call (one a layer), the
    assignments routed to each expert (a ``scatter_add_`` kept on the
    card: ``torch.bincount`` would sync for its length); an expert takes
    the first C of its queue and drops the rest. A context manager that
    wraps the module's function while it is open."""

    def __init__(self, tf):
        self.tf, self.fn, self.calls = tf, tf.dispatch_tables, []

    def __enter__(self):
        import torch

        def counted(gates, experts, n_experts, cap, *rest):
            flat = experts.reshape(-1)
            routed = torch.zeros(n_experts, dtype=torch.int64,
                                 device=flat.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            self.calls.append((routed, cap))
            return self.fn(gates, experts, n_experts, cap, *rest)
        self.tf.dispatch_tables = counted
        return self

    def __exit__(self, *exc):
        self.tf.dispatch_tables = self.fn

    def groups(self, n_layers: int) -> list:
        """Per group of ``n_layers`` calls (a prefill, a decode step): the
        slots C, the tokens each expert took summed over the layers, the
        assignments routed and dropped, and each layer's drop share."""
        import torch
        routed = torch.stack([c for c, _ in self.calls]).cpu()
        caps = torch.tensor([cap for _, cap in self.calls])
        taken = torch.minimum(routed, caps[:, None])
        out = []
        for g0 in range(0, routed.shape[0], n_layers):
            r, t = routed[g0:g0 + n_layers], taken[g0:g0 + n_layers]
            layer_drop = (r - t).sum(1).double() / r.sum(1)
            out.append(dict(cap=int(caps[g0]), taken=t.sum(0).tolist(),
                            routed=int(r.sum()), dropped=int((r - t).sum()),
                            layer_drop=layer_drop.tolist()))
        return out


def _load_lines(load, cfg) -> dict:
    """Prints and returns the expert load of a generate call: its prefill
    and each decode step."""
    import statistics
    prefill, *steps = load.groups(cfg.n_layers)
    E = cfg.moe.n_experts

    def spread(taken):
        return (f"min {min(taken)}, median {statistics.median(taken):g}, "
                f"max {max(taken)}")
    share = prefill["dropped"] / prefill["routed"]
    print(f"  expert load, prefill (C {prefill['cap']} slots an expert a "
          f"layer): tokens each of the {E} experts took, summed over "
          f"{cfg.n_layers} layers: {spread(prefill['taken'])}; "
          f"{prefill['dropped']} of {prefill['routed']} assignments dropped "
          f"by capacity ({share:.4%}; by layer "
          f"{[round(x, 4) for x in prefill['layer_drop']]})", flush=True)
    print(f"    by expert: {prefill['taken']}", flush=True)
    step_share = [s["dropped"] / s["routed"] for s in steps]
    decode_taken = [sum(s["taken"][e] for s in steps) for e in range(E)]
    print(f"  expert load, {len(steps)} decode steps (C {steps[0]['cap']}): "
          f"share dropped a step {[round(x, 4) for x in step_share]}; "
          f"tokens each expert took over the steps and layers: "
          f"{spread(decode_taken)}", flush=True)
    print(f"    by expert: {decode_taken}", flush=True)
    return dict(prefill_cap=prefill["cap"], prefill_taken=prefill["taken"],
                prefill_drop_share=share,
                prefill_layer_drop=prefill["layer_drop"],
                decode_cap=steps[0]["cap"], decode_drop_share=step_share,
                decode_taken=decode_taken)


def int8_decode_parity(q, k, v, pos: int, label: str) -> None:
    """The int8 decode attention at ``pos`` (layer 0's cache re-encoded
    by ``quantize_cache``) against the same step over the bf16 cache."""
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.transformer import quantize_cache
    c = quantize_cache({"k": k[None], "v": v[None]})
    want = decode_attention(q, k, v, pos)
    got = decode_attention(q, c["k"][0], c["v"][0], pos,
                           k_scale=c["k_scale"][0], v_scale=c["v_scale"][0])
    err, bad, rel = close_stats(got.float(), want.float(), **INT8_DECODE_TOL)
    print(f"  parity int8 decode attention vs the bf16 cache at position "
          f"{pos}, {label}: {bad} mismatches, max abs err {err:.3e}, "
          f"max|want| {float(want.abs().max()):.3e}, max rel err {rel:.3e} "
          f"(rtol {INT8_DECODE_TOL['rtol']}, atol {INT8_DECODE_TOL['atol']})",
          flush=True)
    check(bad == 0, "moe: the int8 decode attention is off the bf16 one")


def moe_serve(dev, cfg, prompt: int, steps: int, seed: int, cut: str,
              int8_check: bool) -> dict:
    """``cfg`` at full width through ``launch.serve.generate``: one prompt
    of ``prompt`` tokens, ``steps`` int8 decode steps; launches, memory,
    expert load; kernel 6 on layer 0's call against plain and timed."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params, dt = _timed(lambda: tf.init_params(cfg, gen, dev))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    moe = cfg.moe
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.hd}, "
          f"{moe.n_experts} experts top {moe.top_k} (d_ff {cfg.d_ff}, "
          f"capacity factor {moe.capacity_factor}), vocab {cfg.vocab}, "
          f"{cfg.dtype}, kv cache {cfg.kv_cache_dtype}; {cut}; weights "
          f"{n_bytes / 1e9:.2f} GB on the card in {dt:.2f} s", flush=True)
    toks = torch.randint(0, cfg.vocab, (1, prompt), generator=gen,
                         device=dev, dtype=torch.int32)
    serve.generate(cfg, params, toks[:, :256], 2)          # warm up

    captured = []
    attention = ops.attention

    def capture(q, k, v, **kw):
        if not captured:          # layer 0's call, by reference
            captured.append((q, k, v, kw["causal"], kw["q_offset"]))
        return attention(q, k, v, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    ops.attention = capture
    try:
        with ExpertLoad(tf) as load:
            res = serve.generate(cfg, params, toks, steps + 1)
    finally:
        ops.attention = attention
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    ms_tok = res["decode_s"] / res["decode_steps"] * 1e3
    print(f"  prefill {res['prefill_s']:.3f} s ({prompt / res['prefill_s']:.0f}"
          f" tokens/s), time to first token {res['ttft_s']:.3f} s, int8 "
          f"re-encode of the cache {res['quantize_s']:.3f} s; "
          f"{res['decode_steps']} decode steps in {res['decode_s']:.3f} s, "
          f"{ms_tok:.2f} ms per decoded token; peak device memory "
          f"{peak / 1e9:.2f} GB of {total / 1e9:.2f} GB; tokens "
          f"{res['tokens'][0, :8].tolist()}...", flush=True)
    print(f"  counts: {counts} (flash_fwd per prefill: {cfg.n_layers} "
          f"layers)", flush=True)
    check(counts["flash_fwd"] == cfg.n_layers,
          f"moe: kernel 6 launches differ from {cfg.arch_id}'s layers")
    check(peak < total, "moe: peak memory above the card's")
    check(int(res["tokens"].min()) >= 0
          and int(res["tokens"].max()) < cfg.vocab, "moe: token out of range")
    stats = _load_lines(load, cfg)
    del load

    # where the time goes: a prefill and a decode step profiled; then the
    # prefill's routes and [E, C] tables, every layer, against the CPU's
    # on the same inputs
    max_seq = prompt + steps + 1
    rows = profile_window(lambda: tf.prefill(cfg, params, toks, max_seq),
                          f"{cfg.arch_id} prefill of {prompt} tokens", top=8,
                          wall=res["prefill_s"])
    split = _split(rows, "prefill")
    with RouteLog(tf, inputs=True) as log:
        logits, cache = tf.prefill(cfg, params, toks, max_seq)
    routes = hold_routes(f"{cfg.arch_id} at full width, its prefill",
                         log.calls, log.on_host(), moe.n_experts)
    del log
    cache = tf.quantize_cache(cache)
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    profile_window(lambda: tf.decode_step(cfg, params, cache, nxt, prompt),
                   f"{cfg.arch_id} int8 decode step at position {prompt}",
                   top=8)
    del cache, logits

    q, k, v, causal, q_offset = captured.pop()
    if int8_check:
        int8_decode_parity(q[:, -1:], k, v, prompt - 1,
                           f"{cfg.arch_id} layer 0")
    n = LM_PARITY_ROWS
    tail = (q[:, -n:].contiguous(), k, v, causal, q_offset + prompt - n)
    err = flash_tail_parity(tail, f"{cfg.arch_id} layer 0's last {n} query "
                                  "rows")
    timing = time_flash((q, k, v, causal, q_offset), tail,
                        f"{cfg.arch_id}'s prefill call")
    timing.update(err=err, launches=counts["flash_fwd"])
    del q, k, v, tail, params
    return dict(counts=counts, timing=timing, load=stats, peak=peak,
                routes=routes, prefill_split=split,
                prefill_s=res["prefill_s"], ttft_s=res["ttft_s"],
                quantize_s=res["quantize_s"], ms_per_token=ms_tok,
                weights_gb=n_bytes / 1e9)


class RouteLog:
    """Records, while open, each MoE layer call's route (its experts) and
    its [E, C] token table, and with ``inputs`` its tokens ``xf`` and
    router, copied to the host, by wrapping ``transformer.route`` and
    ``dispatch_tables``. ``gaps`` are the K-th minus the (K+1)-th
    probabilities of each call's tokens."""

    def __init__(self, tf, inputs: bool = False):
        self.tf, self.route, self.tables = tf, tf.route, tf.dispatch_tables
        self.inputs, self.calls = inputs, []

    def __enter__(self):
        import torch

        def route(moe, router, xf):
            gates, experts = self.route(moe, router, xf)
            probs = torch.softmax(xf.float() @ router, dim=-1)
            top = torch.sort(probs, dim=-1, descending=True).values
            call = {"experts": experts.cpu(),
                    "gap": (top[:, moe.top_k - 1] - top[:, moe.top_k]).cpu()}
            if self.inputs:
                call.update(xf=xf.cpu(), router=router.cpu(), moe=moe)
            self.calls.append(call)
            return gates, experts

        def tables(gates, experts, n_experts, cap, *rest):
            out = self.tables(gates, experts, n_experts, cap, *rest)
            self.calls[-1].update(tokens=out[0].cpu(), cap=cap)
            return out
        self.tf.route, self.tf.dispatch_tables = route, tables
        return self

    def __exit__(self, *exc):
        self.tf.route, self.tf.dispatch_tables = self.route, self.tables

    def on_host(self) -> list:
        """The recorded calls' routes and tables recomputed on the CPU from
        their recorded inputs (the log closed)."""
        import torch
        out = []
        for call in self.calls:
            xf, router, moe = call["xf"], call["router"], call["moe"]
            gates, experts = self.tf.route(moe, router, xf)
            probs = torch.sort(torch.softmax(xf.float() @ router, dim=-1),
                               dim=-1, descending=True).values
            out.append({"experts": experts,
                        "gap": probs[:, moe.top_k - 1] - probs[:, moe.top_k],
                        "tokens": self.tf.dispatch_tables(
                            gates, experts, moe.n_experts, call["cap"])[0]})
        return out


def hold_routes(label, card: list, host: list, n_experts: int) -> tuple:
    """The card's routes and token tables against the CPU's, layer call by
    layer call: equal, but for tokens whose K-th and (K+1)-th
    probabilities (the CPU's) lie within ``ROUTE_TIE``, which are counted
    and not compared, and the table rows of the experts such a token
    went to on either side. Returns (routes, near ties)."""
    import torch
    check(len(card) == len(host), f"moe: {label}: MoE calls differ")
    tokens = ties = flipped = rows_skipped = 0
    for d, h in zip(card, host):
        tie = h["gap"] < ROUTE_TIE
        # a route is its set of K experts: the order within it (by
        # probability) moves no queue position and no table entry
        diff = (torch.sort(d["experts"], dim=-1).values
                != torch.sort(h["experts"], dim=-1).values).any(-1)
        tokens += len(tie)
        ties += int(tie.sum())
        flipped += int(diff.sum())
        bad = diff & ~tie
        if bool(bad.any()):
            g = int(bad.nonzero()[0, 0])
            print(f"  card vs CPU routes, {label}: token {g}: experts "
                  f"{d['experts'][g].tolist()} on the card, "
                  f"{h['experts'][g].tolist()} on the CPU; the CPU's gap "
                  f"{float(h['gap'][g]):.3e}", flush=True)
        check(not bool(bad.any()),
              f"moe: {label}: the card routes a token away from a near tie "
              "differently from the CPU")
        keep = torch.ones(n_experts, dtype=torch.bool)
        keep[torch.cat([d["experts"][diff], h["experts"][diff]]).reshape(
            -1)] = False
        rows_skipped += int((~keep).sum())
        check(torch.equal(d["tokens"][keep], h["tokens"][keep]),
              f"moe: {label}: the card's [E, C] token table differs from "
              "the CPU's")
    print(f"  card vs CPU routes, {label}: {len(card)} MoE layer calls, "
          f"{tokens} token routes; {ties} within {ROUTE_TIE} of a tie (not "
          f"compared), {flipped} of them routed differently ({rows_skipped} "
          f"table rows not compared); every other route and [E, C] token "
          f"table equal", flush=True)
    return tokens, ties


def hold_int8(label, got, want, where=None) -> tuple:
    """The card's int8 cache against the CPU's: equal or one quantum apart
    (returns the values compared and those apart), the scales at the
    model phases' tolerances."""
    n = off = bad = 0
    err = 0.0
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = got[name].cpu(), want[name]
        if where is not None:
            a, b = a[where], b[where]
        if name.endswith("_scale"):
            e, m, _ = close_stats(a, b, FORWARD_RTOL, forward_atol(b))
            err, bad = max(err, e), bad + m
            continue
        d = (a.int() - b.int()).abs()
        check(int(d.max()) <= 1, f"moe: {label}: int8 values more than one "
                                 "quantum apart")
        n += d.numel()
        off += int((d > 0).sum())
    print(f"  card vs CPU {label}: {n} int8 values, {off} one quantum apart, "
          f"the rest equal; scales {bad} mismatches, max abs err {err:.3e} "
          f"(rtol {FORWARD_RTOL})", flush=True)
    check(bad == 0, f"moe: {label}: the int8 cache's scales differ")
    return n, off


def moe_card_vs_cpu(dev, cfg, seed: int) -> tuple:
    """``cfg``'s widths cut to 2 layers in float32, card against CPU: a
    prompt, the cache re-encoded, int8 decode steps from the same cache on
    both sides (the CPU's, so that a value one quantum apart does not
    carry over), each step's logits, the routes and token tables of every
    MoE layer call (returns hold_routes'), and the int8 caches."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tf
    small = dataclasses.replace(cfg, n_layers=MOE_CHECK["layers"],
                                dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    card = tf.init_params(small, gen, dev)
    host = _tree_to(card, "cpu")
    p_len, steps = MOE_CHECK["prompt"], MOE_CHECK["steps"]
    prompt = torch.randint(0, small.vocab, (1, p_len), generator=gen,
                           device=dev, dtype=torch.int32)
    log_h, log_d = RouteLog(tf), RouteLog(tf)
    t0 = time.perf_counter()
    with log_h:
        want, cache_h = tf.prefill(small, host, prompt.cpu(), p_len + steps)
    dt = time.perf_counter() - t0
    with log_d:
        got, cache_d = tf.prefill(small, card, prompt, p_len + steps)
    print(f"  card vs CPU: {cfg.arch_id}'s widths cut to {small.n_layers} "
          f"layers, float32, a {p_len}-token prompt and {steps} int8 decode "
          f"steps (CPU prefill {dt:.2f} s)", flush=True)
    _hold("prefill last-token logits", got.cpu(), want)
    cache_h = tf.quantize_cache(cache_h)
    n, off = hold_int8("the prefill's cache re-encoded",
                       tf.quantize_cache(cache_d), cache_h)
    cache_d = _tree_to(cache_h, dev)
    for i in range(steps):
        tok = want.argmax(-1, keepdim=True).to(torch.int32)   # the CPU's
        with log_h:
            want, cache_h = tf.decode_step(small, host, cache_h, tok,
                                           p_len + i)
        with log_d:
            got, cache_d = tf.decode_step(small, card, cache_d, tok.to(dev),
                                          p_len + i)
        _hold(f"decode step {i} logits", got.cpu(), want)
        col = (slice(None), slice(None), p_len + i)
        n_i, off_i = hold_int8(f"decode step {i}'s int8 keys and values",
                               cache_d, cache_h, col)
        n, off = n + n_i, off + off_i
        for name, t in cache_d.items():       # the next step from the CPU's
            t.copy_(cache_h[name])
    print(f"  card vs CPU int8 caches: {off} of {n} values one quantum apart "
          f"(limit {INT8_OFF_SHARE:.2%})", flush=True)
    check(off <= INT8_OFF_SHARE * n, "moe: the int8 caches differ")
    return hold_routes(f"{small.n_layers}-layer cut", log_d.calls,
                       log_h.calls, small.moe.n_experts)


def moe_phase(dev, seed: int) -> dict:
    """moonshot-v1-16b-a3b at its published config and phi3.5-moe at full
    width on 24 layers through ``launch.serve.generate`` with the int8
    cache; then moonshot's widths cut to 2 layers, card against CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import shapes_for_family
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH)
    shp = shapes_for_family("lm")["prefill_32k"]
    held = torch.cuda.memory_allocated(dev)
    print(f"moe: the MoE LMs with the int8 KV cache ({held / 1e9:.2f} GB "
          f"left allocated on the card by earlier phases)", flush=True)
    out = {"moonshot": moe_serve(
        dev, cfg, MOE_PROMPT, MOE_DECODE, seed,
        f"prefill_32k's {shp.batch} x {shp.seq_len} tokens cut to one prompt "
        f"of {MOE_PROMPT} by the card's memory, then {MOE_DECODE} greedy "
        "int8 decode steps", int8_check=True)}
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(MOE_PHI["arch"])
    phi = dataclasses.replace(full, n_layers=MOE_PHI["layers"])
    out["phi"] = moe_serve(
        dev, phi, MOE_PHI["prompt"], MOE_PHI["steps"], seed + 1,
        f"depth cut {full.n_layers} -> {phi.n_layers} layers (bf16 weights "
        f"{full.param_count() * 2 / 1e9:.1f} GB at {full.n_layers}); one "
        f"prompt of {MOE_PHI['prompt']} tokens, then {MOE_PHI['steps']} "
        "greedy int8 decode steps", int8_check=False)
    gc.collect()
    torch.cuda.empty_cache()
    cut = moe_card_vs_cpu(dev, cfg, seed + 2)
    routes, ties = (sum(r) for r in zip(out["moonshot"]["routes"],
                                        out["phi"]["routes"], cut))
    print(f"  card vs CPU routes, all: {ties} of {routes} within {ROUTE_TIE} "
          f"of a tie ({ties / routes:.4%}; limit {ROUTE_TIE_SHARE:.1%})",
          flush=True)
    check(ties <= ROUTE_TIE_SHARE * routes, "moe: too many near ties")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  moe: {out['seconds']:.1f} s", flush=True)
    return out


def _train_split(rows, optimizer_ms: float, label) -> dict:
    """Device ms of a train step's profile in five parts: kernel 6,
    kernels 7-8, the cuBLAS GEMMs, the optimizer (``optimizer_ms``, from
    CUDA events around ``adamw_update``: its kernels are PyTorch's
    elementwise ones, not named apart) and the rest."""
    parts = {"kernel 6": 0.0, "kernels 7-8": 0.0, "GEMMs": 0.0,
             "optimizer": 0.0, "rest": 0.0}
    for us, _, key in rows:
        low = key.lower()
        part = ("kernel 6" if "flash_fwd" in low else "kernels 7-8"
                if "flash_bwd" in low else "GEMMs"
                if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass"))
                else "rest")
        parts[part] += us / 1e3
    parts["optimizer"] = min(optimizer_ms, parts["rest"])
    parts["rest"] -= parts["optimizer"]
    total = sum(parts.values())
    print(f"  split {label}: " + ", ".join(
        f"{k} {v:.3f} ms ({v / total:.1%})" for k, v in parts.items()),
        flush=True)
    return parts


def profile_train_step(tr, label: str, split_label: str, wall: float):
    """One more step of the Trainer ``tr`` profiled (``profile_window``),
    with the optimizer's device time from CUDA events around
    ``adamw_update``; returns ``_train_split``'s parts."""
    import torch

    from repro_torch.models import api
    events = []
    update = api.adamw_update

    def timed_update(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = update(*args, **kw)
        end.record()
        events.append((start, end))
        return out
    api.adamw_update = timed_update
    try:
        rows = profile_window(lambda: tr.run(tr.step_idx + 1), label, top=8,
                              wall=wall)
    finally:
        api.adamw_update = update
    torch.cuda.synchronize()
    opt_ms = events[-1][0].elapsed_time(events[-1][1])
    return _train_split(rows, opt_ms, split_label)


def time_flash_bwd(args, label: str, plain_args=None) -> dict:
    """Kernels 7 and 8 at the call ``args`` = (q, k, v, out, lse, dout,
    causal, q_offset), k and v grouped: each one's time beside its bound
    and beside SDPA's backward on the same grouped tensors
    (``enable_gqa``) and on k and v expanded to H heads (SDPA computes dq,
    dk and dv together: one time for both rows); the plain version (which
    also computes all three) on ``plain_args``, and the kernels again
    there, or the plain version on ``args`` when ``plain_args`` is
    None."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, dout, causal, qo = args
    h = q.shape[2]
    delta = fa.row_delta(out, dout)

    def kernels(a):
        d = fa.row_delta(a[3], a[5])
        kw = dict(causal=a[6], q_offset=a[7])
        return {"flash_bwd_dq": lambda: fa.flash_bwd_dq(
                    a[0], a[1], a[2], a[5], a[4], d, **kw),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(
                    a[0], a[1], a[2], a[5], a[4], d, **kw)}

    def sdpa_bwd(kk, vv):
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, kk, vv)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                           enable_gqa=kk.shape[2] != h)
        g = dout.transpose(1, 2)
        return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)

    library_ms = device_ms(sdpa_bwd(k, v), reps=10)
    k_x, v_x = fa.expand_kv(k, h), fa.expand_kv(v, h)
    expanded_ms = device_ms(sdpa_bwd(k_x, v_x), reps=10)
    del k_x, v_x
    sliced = plain_args is not None
    plain_args = plain_args if sliced else args
    plain_ms = device_ms(lambda: fa.flash_bwd_plain(
        *plain_args[:6], causal=plain_args[6], q_offset=plain_args[7]),
        reps=10)
    out_rows = {}
    whole, part = kernels(args), kernels(plain_args)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        _, one = _timed(whole[name])
        reps = 30 if one < 0.1 else 3
        ms = device_ms(whole[name], reps=reps)
        slice_ms = device_ms(part[name]) if sliced else ms
        nbytes, ops = work_of(name, (q, k, v, dout, lse, delta, causal, qo))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / BF16_TENSOR_OPS_PER_S * 1e3
        print(f"  time {name} at {label} {tuple(q.shape)} x "
              f"{tuple(k.shape)} {str(q.dtype).split('.')[-1]}: kernel "
              f"{ms:.4f} ms (median of {reps}), {ops / ms / 1e9:.2f} "
              f"TFLOP/s; library (SDPA backward, dq dk dv together, "
              f"enable_gqa, the same tensors) {library_ms:.4f} ms, on k, v "
              f"expanded to {h} heads {expanded_ms:.4f} ms; bound "
              f"{max(t_bytes, t_ops):.4f} ms ({nbytes} B, {ops} flops at "
              f"{BF16_TENSOR_OPS_PER_S / 1e12:.0f} TFLOP/s; "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}); "
              f"{tuple(plain_args[0].shape)}: kernel {slice_ms:.4f} ms, "
              f"plain (dq dk dv) {plain_ms:.4f} ms", flush=True)
        at_slice = dict(
            plain_at=f"q {tuple(plain_args[0].shape)} of the call's "
                     f"{tuple(q.shape)}; the plain version computes dq, dk "
                     f"and dv together", ms_at_plain_shape=slice_ms)
        out_rows[name] = dict(
            rows=q.shape[1], ms=ms, plain_ms=plain_ms,
            library="torch.autograd.grad of scaled_dot_product_attention"
                    "(is_causal=True, enable_gqa=True): dq, dk and dv "
                    "together",
            library_ms=library_ms, library_expanded_ms=expanded_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            **(at_slice if sliced else {}))
    return out_rows


def bwd_hd128_call(dev, seed: int):
    """Kernels 7 and 8 at one llama3-8b layer's backward call
    (``BWD_HD128_CALL``, causal, bf16, random q, k, v and cotangent from
    ``seed``; out and lse from kernel 6): held against the plain version
    on the whole call, timed beside their bounds and SDPA's backward.
    {name: timing row with "err"}."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    b, s, h, kv, hd = BWD_HD128_CALL
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    q, k, v, dout = (torch.randn((b, s, n, hd), generator=g, device=dev)
                     .to(torch.bfloat16) for n in (h, kv, kv, h))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    args = (q, k, v, out, lse, dout, True, 0)
    label = f"one llama3-8b layer's call ({s} tokens, {h} heads / {kv} kv)"
    res = flash_bwd_parity(label, args)
    timing = time_flash_bwd(args, label)
    for name in timing:
        timing[name]["err"] = res[name]
    return timing


def _leaves(tree):
    """The leaves of nested dicts (keys sorted) and lists."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, list):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


def _train_state_close(label, got, want, metrics, want_metrics,
                       loss_rtol: float = FORWARD_RTOL,
                       atol: float = FORWARD_ATOL,
                       what: str = "card vs CPU") -> None:
    """The card's train state and metrics against the CPU's (``what``
    names the two) at the CPU tests' tolerances: the loss at rtol
    ``loss_rtol``, grad_norm and lr at rtol 1e-4; m and v at rtol 1e-4,
    atol ``atol`` x max|want|; params at atol 2 lr. Compared on the card
    (each CPU leaf copied there in turn: a full-width cut's float32 leaves
    are slow to compare on the host)."""
    for key in ("loss", "grad_norm", "lr"):
        rtol = loss_rtol if key == "loss" else FORWARD_RTOL
        a, b = float(metrics[key]), float(want_metrics[key])
        print(f"  {what} {label} {key}: {a:.7f} vs {b:.7f}", flush=True)
        check(abs(a - b) <= rtol * abs(b),
              f"train {label}: {key} differs between card and CPU")
    two_lr = 2 * float(want_metrics["lr"])
    bad, worst = 0, 0.0
    for part in ("params", "m", "v"):
        g = got["params"] if part == "params" else got["opt"][part]
        w = want["params"] if part == "params" else want["opt"][part]
        for a, b in zip(_leaves(g), _leaves(w)):
            tol = ((0.0, two_lr) if part == "params" else
                   (FORWARD_RTOL, atol * float(b.abs().max())))
            err, n_bad, _ = close_stats(a, b, *tol)
            bad, worst = bad + n_bad, max(worst, err)
    print(f"  {what} {label} params, m, v: {bad} mismatches, max abs err "
          f"{worst:.3e} (params at atol 2 lr = {two_lr:.3e}; m, v at rtol "
          f"{FORWARD_RTOL}, atol {atol} x max|want|)", flush=True)
    check(bad == 0, f"train {label}: the card's state differs from the CPU's")


def ckpt_round_trip(tr) -> dict:
    """One ``CheckpointManager.save`` of the Trainer's state at full width
    under build/ (seconds until ``save`` returns, the host copy, and until
    ``wait``, the write), then ``restore_latest``: the restored state must
    equal the saved one bit for bit."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        free = shutil.disk_usage(work).free
        mgr = CheckpointManager(work, keep_last=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(tr.step_idx, tr.state,
                 extra={"data_state": tr.pipeline.state(tr.step_idx)})
        returned = time.perf_counter() - t0
        mgr.wait()
        written = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in work.rglob("*") if p.is_file())
        (restored, manifest), back = _timed(
            lambda: mgr.restore_latest(tr.state))
        same = all(a.dtype == b.dtype and a.device == b.device
                   and torch.equal(a, b)
                   for a, b in zip(_leaves(restored), _leaves(tr.state)))
        print(f"  checkpoint at full width (step {manifest['step']}, "
              f"{manifest['n_leaves']} leaves): {nbytes} bytes written "
              f"({free / 1e9:.1f} GB free before); save returned after "
              f"{returned:.2f} s (the host copy), written after {written:.2f}"
              f" s; restore_latest {back:.2f} s; restored state equal bit "
              f"for bit: {same}", flush=True)
        check(same, "train: the restored checkpoint differs from the state")
        del restored
        return dict(bytes=nbytes, save_return_s=returned, save_s=written,
                    restore_s=back)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def train_recovery(cfg, shp, dev, seed: int) -> None:
    """The Trainer on the 2-layer float32 cut: 6 steps, a checkpoint every
    2, a ``WorkerFailure`` injected at step 5 (rolled back to step 4);
    its losses and final state against an uninterrupted run's, and a
    second uninterrupted run against the first. Bit for bit when the two
    uninterrupted runs agree bit for bit; else (an op of the step is not
    deterministic on the card) at the model tolerance, naming the leaves
    that differ between the two uninterrupted runs."""
    import torch

    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.launch.train import Trainer
    from repro_torch.runtime.fault_tolerance import FaultInjector
    from repro_torch.kernels import _lib
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    runs = {}
    try:
        for name, inj in (("uninterrupted", None), ("repeat", None),
                          ("failed", FaultInjector.worker_failure_at(5))):
            tr = Trainer(TRAIN_ARCH, cfg_override=cfg, batch_override=shp[0],
                         seq_override=shp[1], ckpt_dir=str(work / name),
                         fault_injector=inj, seed=seed + 2, device=dev)
            tr.restore_or_init()
            before = dict(_lib.LAUNCHES)
            hist, dt = _timed(lambda: tr.run(6, ckpt_every=2, log_every=100))
            launched = {k: _lib.LAUNCHES[k] - before[k]
                        for k in ("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv")}
            runs[name] = (tr, {h["step"]: h["loss"] for h in hist})
            print(f"  recovery run {name}: {len(hist)} steps run for 6 "
                  f"({tr.recoveries} recoveries) in {dt:.2f} s; launches "
                  f"{launched}; losses "
                  f"{[round(v, 6) for v in runs[name][1].values()]}",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    flat = {k: dict(_flatten_with_paths(v[0].state)) for k, v in runs.items()}
    base = flat["uninterrupted"]

    def differ(other):
        return [p for p, t in base.items() if not torch.equal(t, other[p])]
    noisy = differ(flat["repeat"])
    moved = differ(flat["failed"])
    same_loss = runs["failed"][1] == runs["uninterrupted"][1]
    check(runs["failed"][0].recoveries == 1, "train: no recovery happened")
    if not noisy and runs["repeat"][1] == runs["uninterrupted"][1]:
        print(f"  recovery: two uninterrupted runs agree bit for bit; the "
              f"recovered run: losses equal {same_loss}, leaves that differ "
              f"{moved}", flush=True)
        check(same_loss and not moved,
              "train: the recovered run differs from the uninterrupted one")
        return
    print(f"  recovery: the uninterrupted runs differ between themselves in "
          f"{noisy} (an op of the step not deterministic on the card); the "
          f"recovered run held at the model tolerance", flush=True)
    for key in (1, 5):
        a, b = runs["failed"][1][key], runs["uninterrupted"][1][key]
        check(abs(a - b) <= FORWARD_RTOL * abs(b),
              f"train: the recovered run's loss at step {key} differs")
    _state_close("recovered run vs uninterrupted", runs["failed"][0].state,
                 runs["uninterrupted"][0].state)


def train_phase(dev, seed: int):
    """tinyllama-1.1b at full width and depth through the Trainer on
    train_4k (batch cut to 16): a warm-up step, 3 timed steps with their
    launch counts, kernels 7 and 8 on layer 0's backward call, a profiled
    step; then 2 layers in float32, card vs CPU."""
    import dataclasses

    import torch

    from repro_torch.configs.base import shapes_for_family
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer
    from repro_torch.models import api
    torch.cuda.empty_cache()
    shp = shapes_for_family("lm")["train_4k"]
    tr = Trainer(TRAIN_ARCH, smoke=False, batch_override=TRAIN_BATCH,
                 seed=seed, device=dev)
    cfg, S, opt_cfg = tr.cfg, tr.shape.seq_len, tr.opt_cfg
    mb = cfg.microbatches
    print(f"train: {cfg.arch_id} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, remat "
          f"{cfg.remat}); train_4k: seq {S}, batch cut {shp.batch} -> "
          f"{TRAIN_BATCH} ({mb} microbatches of {TRAIN_BATCH // mb}); "
          f"AdamW, warm-up {tr.opt_cfg.warmup_steps} steps", flush=True)
    _, dt = _timed(tr.init_state)
    state = tr.state
    n_params = sum(t.numel() for t in [
        state["params"]["embed"], state["params"]["final_norm"],
        state["params"]["lm_head"], *state["params"]["layers"].values()])
    print(f"  state: {n_params} params ({n_params * 2 / 1e9:.2f} GB bf16), "
          f"m and v {n_params * 8 / 1e9:.2f} GB float32, on the card in "
          f"{dt:.2f} s", flush=True)

    # warm-up step; layer 0's forward call kept (the step's first) and its
    # backward call (the last of the first microbatch's: the backward runs
    # the layers in reverse)
    captured, forward = [], []
    flash_bwd, attention = fa.flash_bwd, ops.attention

    def capture(*args, **kw):
        captured.append((*(t.detach() for t in args), kw["causal"],
                         kw["q_offset"]))
        return flash_bwd(*args, **kw)

    def capture_fwd(q, k, v, **kw):
        if not forward:
            forward.append((q.detach(), k.detach(), v.detach(), kw["causal"],
                            kw["q_offset"]))
        return attention(q, k, v, **kw)
    fa.flash_bwd, ops.attention = capture, capture_fwd
    try:
        tr.run(1)
    finally:
        fa.flash_bwd, ops.attention = flash_bwd, attention
    layer0 = captured[cfg.n_layers - 1]
    del captured
    print(f"  warm-up step: {tr.history[-1]['seconds']:.2f} s, loss "
          f"{tr.metrics['loss']:.4f}", flush=True)
    # the dry run's check: one more step, predicted on meta first
    fig = dry_predict("train", cfg, "train_4k", tr.shape)
    with DryrunHold("train", fig, dev):
        tr.run(tr.step_idx + 1)

    layers = state["params"]["layers"]
    sample = {k: v[:, :2].clone() for k, v in layers.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    want = {"flash_fwd": 2 * cfg.n_layers * mb if cfg.remat
            else cfg.n_layers * mb,
            "flash_bwd_dq": cfg.n_layers * mb,
            "flash_bwd_dkv": cfg.n_layers * mb}
    for _ in range(TRAIN_STEPS):
        before = dict(_lib.LAUNCHES)
        tr.run(tr.step_idx + 1)
        step = {k: _lib.LAUNCHES[k] - before[k] for k in want}
        h, m = tr.history[-1], tr.metrics
        print(f"  step {h['step']}: {h['seconds']:.3f} s, "
              f"{TRAIN_BATCH * S / h['seconds']:.0f} tokens/s, loss "
              f"{m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, lr "
              f"{m['lr']:.3e}, peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
              f"launches {step}", flush=True)
        check(step == want, f"train: launches per step {step}, expected "
              f"{want}")
        check(all(np.isfinite([m["loss"], m["grad_norm"]])),
              "train: non-finite loss or gradient")
    counts = read_counters()
    # every projection must move; the norms, all 1.0 at init, may not in
    # bfloat16 while lr is below its spacing there (2^-8)
    changed = sorted(k for k, v in layers.items()
                     if not torch.equal(v[:, :2], sample[k]))
    moved = all(k in changed for k, v in layers.items() if v.dim() >= 3)
    finite = all(bool(torch.isfinite(t).all()) for t in layers.values())
    print(f"  counts over {TRAIN_STEPS} steps: {counts}; layer leaves "
          f"changed: {changed}, all finite: {finite}", flush=True)
    check(moved and finite,
          "train: a projection did not change, or the params are not finite")
    del sample
    seconds = [h["seconds"] for h in tr.history[-TRAIN_STEPS:]]

    # kernels 7 and 8 on layer 0's call: sequence 0 against the plain
    # version, the whole call timed
    seq0 = tuple(t[:1].contiguous() for t in layer0[:6]) + layer0[6:]
    res = flash_bwd_parity(f"on layer 0's call, sequence 0 ({S} tokens, "
                           f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv)",
                           seq0)
    timing = time_flash_bwd(layer0, "the train step's layer-0 call", seq0)
    for name in timing:
        timing[name]["err"] = res[name]
    timing["hd128"] = bwd_hd128_call(dev, seed)
    # kernel 6 on layer 0's forward call of one microbatch, grouped k, v
    q, k, v, causal, qo = forward.pop()
    n = LM_PARITY_ROWS
    tail = (q[:1, -n:].contiguous(), k[:1].contiguous(),
            v[:1].contiguous(), causal, qo + S - n)
    err = flash_tail_parity(tail, f"layer 0's forward, sequence 0's last "
                                  f"{n} query rows")
    timing["flash_fwd"] = time_flash((q, k, v, causal, qo), tail,
                                     "the train step's layer-0 call")
    timing["flash_fwd"]["err"] = err
    del q, k, v, tail

    profile_train_step(tr, f"train step of {TRAIN_BATCH} x {S} tokens",
                       "train step", float(np.median(seconds)))
    ckpt_round_trip(tr)
    del layer0, seq0, tr, state, layers
    torch.cuda.empty_cache()

    # card vs CPU: the same widths cut to 2 layers, float32
    c = TRAIN_CHECK
    small = dataclasses.replace(cfg, n_layers=c["layers"], dtype="float32",
                                microbatches=c["microbatches"])
    check_shape = dataclasses.replace(shp, batch=c["batch"],
                                      seq_len=c["seq"])
    cells = {d: api.build_cell(small, "train_4k", device=d,
                               shape_override=check_shape, opt_cfg=opt_cfg)
             for d in (dev, "cpu")}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    card = api.materialize_state(cells[dev], small, "train_4k", gen)
    host = _tree_to(card, "cpu")
    pipe = TokenPipeline(small.vocab, c["batch"], c["seq"], seed=seed + 1)
    print(f"  card vs CPU: {small.n_layers} layers, float32, batch "
          f"{c['batch']} x seq {c['seq']}, {small.microbatches} "
          f"microbatches, two steps", flush=True)
    for i in range(2):
        toks, labs = (torch.from_numpy(a) for a in pipe.batch_at(i))
        (host, want_m), dt = _timed(lambda: cells["cpu"].step(
            host, {"tokens": toks, "labels": labs}))
        card, got_m = cells[dev].step(card, {"tokens": toks.to(dev),
                                             "labels": labs.to(dev)})
        print(f"  step {i}: CPU {dt:.2f} s", flush=True)
        _train_state_close(f"step {i}", card, host, got_m, want_m)
    del cells, card, host
    train_recovery(small, (c["batch"], c["seq"]), dev, seed)
    return counts, timing


# ------------------------------------------------------- moe_train ----
# the moe_train phase: both MoE archs at their published widths through
# the Trainer on train_4k (batch 256 -> 16 as the train phase cuts it: 4
# microbatches of 4 x 4,096), depth cut to MOE_TRAIN's layers: moonshot's
# 2 layers (570.6M params each) and 671.1M of embedding and head hold ~29
# GB of state (bf16 weights, float32 accumulators, m and v), and the
# checkpointed loss chunk of 16,384 rows x 163,840 vocab (the reference's
# chunk) takes ~40 GB more in its backward; phi3.5-moe's 2 layers (1.30B
# each) and 262.7M of embedding and head ~46 GB of state
MOE_TRAIN = (("moonshot-v1-16b-a3b", 2), ("phi3.5-moe-42b-a6.6b", 2))
MOE_AT = {"moonshot-v1-16b-a3b": "moonshot", "phi3.5-moe-42b-a6.6b": "phi35"}
MOE_TRAIN_CHECK = dict(layers=2, batch=2, seq=256, microbatches=2)  # float32
# card vs CPU at the CPU tests' tolerances (tests/test_torch_moe_train.py):
# the loss at rtol 1e-5; m (after one step, (1 - b1) times the clipped
# gradient: every leaf's gradient) and v at rtol 1e-4, atol 5e-4 x
# max|want|; grad_norm and lr at rtol 1e-4; params at atol 2 lr
MOE_LOSS_RTOL, MOE_GRAD_ATOL = 1e-5, 5e-4
# the Trainer's recovery on moonshot's MoE spec (64 experts top 6, remat)
# at its SMOKE widths with head dim 64 (kernels 6-8's smallest): the
# 2-layer full-width cut's float32 state is 21.7 GB a checkpoint, and the
# recovery check writes 9 of them
MOE_RECOVERY = dict(batch=4, seq=64)


class ForcedRoutes:
    """While open, ``transformer.route`` on the CPU takes the card's
    recorded routes (``card``, a ``RouteLog``'s calls, in call order): a
    token's K experts are the card's and its gates the CPU's
    probabilities at them, renormalised (the same differentiable
    function), so that a route the card took at a near tie is held as
    the card took it. ``calls`` record the CPU's own routes, gaps and
    token tables for ``hold_routes``."""

    def __init__(self, tf, card: list):
        self.tf, self.route, self.tables = tf, tf.route, tf.dispatch_tables
        self.card, self.calls = card, []

    def __enter__(self):
        import torch

        def route(moe, router, xf):
            _, own = self.route(moe, router, xf)
            probs = torch.softmax(xf.float() @ router, dim=-1)
            top = torch.sort(probs.detach(), dim=-1, descending=True).values
            self.calls.append({"experts": own, "gap": top[:, moe.top_k - 1]
                               - top[:, moe.top_k]})
            experts = self.card[len(self.calls) - 1]["experts"]
            gates = probs.gather(1, experts)
            return gates / gates.sum(dim=-1, keepdim=True), experts

        def tables(gates, experts, n_experts, cap, *rest):
            own = self.calls[-1]["experts"]
            self.calls[-1]["tokens"] = self.tables(gates, own, n_experts,
                                                   cap, *rest)[0]
            return self.tables(gates, experts, n_experts, cap, *rest)
        self.tf.route, self.tf.dispatch_tables = route, tables
        return self

    def __exit__(self, *exc):
        self.tf.route, self.tf.dispatch_tables = self.route, self.tables


def _train_load(load, cfg, steps: int) -> dict:
    """The expert load of ``steps`` train steps from an ``ExpertLoad``
    (one call a layer and microbatch, and again in the remat recompute):
    the forward calls' tokens each expert took, summed over the layers,
    microbatches and steps, and each layer's share of assignments
    dropped."""
    L, mb = cfg.n_layers, cfg.microbatches
    per = 2 if cfg.remat else 1
    check(len(load.calls) == per * L * mb * steps,
          f"moe_train: {len(load.calls)} dispatches, expected "
          f"{per * L * mb * steps}")
    fwd = load.groups(L)[::per]
    taken = [sum(g["taken"][e] for g in fwd)
             for e in range(cfg.moe.n_experts)]
    routed = sum(g["routed"] for g in fwd)
    dropped = sum(g["dropped"] for g in fwd)
    by_layer = [sum(g["layer_drop"][i] for g in fwd) / len(fwd)
                for i in range(L)]
    return dict(cap=fwd[0]["cap"], taken=taken, routed=routed,
                dropped=dropped, layer_drop=by_layer)


def moe_train_run(dev, arch: str, layers: int, seed: int,
                  ep_check: bool = False) -> dict:
    """``arch`` at its published widths cut to ``layers`` layers through
    the Trainer on train_4k (batch ``TRAIN_BATCH``): a warm-up step, then
    ``TRAIN_STEPS`` timed steps with their launches and expert load;
    kernels 7 and 8 on layer 0's backward call held against the plain
    version on sequence 0 and timed whole beside SDPA's backward; with
    ``ep_check`` the expert-parallel part at world 1 on this state."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import Trainer
    from repro_torch.models import transformer as tf
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    tr = Trainer(arch, cfg_override=cfg, batch_override=TRAIN_BATCH,
                 seed=seed, device=dev)
    S, mb, moe, L = tr.shape.seq_len, cfg.microbatches, cfg.moe, layers
    G = TRAIN_BATCH // mb * S
    print(f"  {arch}: d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv, hd {cfg.hd}, {moe.n_experts} experts top "
          f"{moe.top_k} (d_ff {cfg.d_ff}, capacity factor "
          f"{moe.capacity_factor}), vocab {cfg.vocab}, {cfg.dtype}, remat "
          f"{cfg.remat}; cuts: depth {full.n_layers} -> {L} layers, "
          f"train_4k's batch 256 -> {TRAIN_BATCH} ({mb} microbatches of "
          f"{TRAIN_BATCH // mb} x {S} = {G} tokens: C "
          f"{tf.capacity(moe, G)} slots an expert a layer), loss chunk "
          f"16,384 rows (the reference's); AdamW warm-up "
          f"{tr.opt_cfg.warmup_steps} steps", flush=True)
    _, dt = _timed(tr.init_state)
    n_params = sum(t.numel() for t in _leaves(tr.state["params"]))
    print(f"    state: {n_params} params ({n_params * 2 / 1e9:.2f} GB "
          f"{cfg.dtype}), m and v {n_params * 8 / 1e9:.2f} GB float32, on "
          f"the card in {dt:.2f} s", flush=True)

    # warm-up; layer 0's backward call kept (the first microbatch's last)
    layer0, n_calls = [], [0]
    flash_bwd = fa.flash_bwd

    def capture(*args, **kw):
        if n_calls[0] == L - 1:
            layer0.append((*(t.detach() for t in args), kw["causal"],
                           kw["q_offset"]))
        n_calls[0] += 1
        return flash_bwd(*args, **kw)
    fa.flash_bwd = capture
    try:
        tr.run(1)
    finally:
        fa.flash_bwd = flash_bwd
    layer0 = layer0[0]
    print(f"    warm-up step: {tr.history[-1]['seconds']:.2f} s, loss "
          f"{tr.metrics['loss']:.4f}", flush=True)

    router0 = tr.state["params"]["layers"]["router"].clone()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    want = {"flash_fwd": (2 if cfg.remat else 1) * L * mb,
            "flash_bwd_dq": L * mb, "flash_bwd_dkv": L * mb}
    with ExpertLoad(tf) as load:
        for _ in range(TRAIN_STEPS):
            before = dict(_lib.LAUNCHES)
            tr.run(tr.step_idx + 1)
            step = {k: _lib.LAUNCHES[k] - before[k] for k in want}
            h, m = tr.history[-1], tr.metrics
            print(f"    step {h['step']}: {h['seconds']:.3f} s, "
                  f"{TRAIN_BATCH * S / h['seconds']:.0f} tokens/s, loss "
                  f"{m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, lr "
                  f"{m['lr']:.3e}, peak device memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
                  f"launches {step}", flush=True)
            check(step == want, f"moe_train: launches per step {step}, "
                  f"expected {want}")
            check(all(np.isfinite([m["loss"], m["grad_norm"]])),
                  "moe_train: non-finite loss or gradient")
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    seconds = [h["seconds"] for h in tr.history[-TRAIN_STEPS:]]
    stats = _train_load(load, cfg, TRAIN_STEPS)
    del load
    share = stats["dropped"] / stats["routed"]
    print(f"    expert load over {TRAIN_STEPS} steps (C {stats['cap']}): "
          f"tokens each of the {moe.n_experts} experts took, summed over "
          f"layers, microbatches and steps: min {min(stats['taken'])}, "
          f"max {max(stats['taken'])}; {stats['dropped']} of "
          f"{stats['routed']} assignments dropped ({share:.4%}; by layer "
          f"{[round(x, 4) for x in stats['layer_drop']]})", flush=True)
    print(f"      by expert: {stats['taken']}", flush=True)
    moved = not torch.equal(tr.state["params"]["layers"]["router"], router0)
    print(f"    counts over {TRAIN_STEPS} steps: {counts}; peak "
          f"{peak / 1e9:.2f} GB; the router moved: {moved}", flush=True)
    check(moved, "moe_train: the router did not move")
    del router0
    split = profile_train_step(
        tr, f"{arch} train step of {TRAIN_BATCH} x {S} tokens",
        f"{arch} train step", float(np.median(seconds)))

    seq0 = tuple(t[:1].contiguous() for t in layer0[:6]) + layer0[6:]
    label = f"{arch}'s train call"
    res = flash_bwd_parity(f"{label}, layer 0, sequence 0 ({S} tokens, "
                           f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv)",
                           seq0)
    timing = time_flash_bwd(layer0, label, seq0)
    for name in timing:
        timing[name].update(err=res[name], launches=counts[name])
    del seq0, layer0
    if ep_check:
        moe_ep_world_one(dev, cfg, tr, seed)
    del tr
    return dict(counts=counts, timing=timing, load=stats, drop_share=share,
                peak=peak, step_s=seconds, split=split,
                tokens_per_s=[TRAIN_BATCH * S / s for s in seconds])


def moe_ep_world_one(dev, cfg, tr, seed: int) -> None:
    """Expert parallelism at world 1 over NCCL (mesh 1x1, a FileStore under
    build/): the MoE FFN through ``ExpertMesh`` on layer 0 of ``tr``'s
    full-width state and one microbatch's tokens, against the gather path
    bit for bit (one rank holds every expert); then one train step of
    the recovery cut through ``build_cell(..., mesh=)`` against the same
    without a mesh, with no collective launched."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import shapes_for_family
    from repro_torch.core.distributed import ServingMesh
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import CALLS
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(work / "store"), 1))
    try:
        mesh = ServingMesh("sharded", (1, 1), dev)
        ep = tf.ExpertMesh(mesh)
        lp = {k: v[0] for k, v in tr.state["params"]["layers"].items()}
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 5)
        x = torch.randn((TRAIN_BATCH // cfg.microbatches, tr.shape.seq_len,
                         cfg.d_model), generator=gen, device=dev).to(
            getattr(torch, cfg.dtype))
        CALLS.clear()
        with torch.no_grad():
            got = tf._moe_ffn(cfg, lp, x, ep)
            want = tf._moe_ffn(cfg, lp, x)
        same = torch.equal(got, want)
        print(f"  expert parallel at world 1 over NCCL (mesh 1x1): the MoE "
              f"FFN on layer 0 of {cfg.arch_id} at full width, "
              f"{tuple(x.shape)} {cfg.dtype}: equal to the gather path bit "
              f"for bit: {same}", flush=True)
        check(same, "moe_train: the expert-parallel FFN differs at world 1")
        del lp, x, got, want
        small = _moe_recovery_cut()
        shp = dataclasses.replace(shapes_for_family("lm")["train_4k"],
                                  batch=MOE_RECOVERY["batch"],
                                  seq_len=MOE_RECOVERY["seq"])
        cells = [api.build_cell(small, "train_4k", mesh=mesh,
                                shape_override=shp),
                 api.build_cell(small, "train_4k", device=dev,
                                shape_override=shp)]
        check(cells[0].expert_mesh is not None,
              "moe_train: the mesh cell has no expert mesh")
        gen.manual_seed(seed + 6)
        state = api.materialize_state(cells[0], small, "train_4k", gen)
        states = [state, _tree_clone(state)]
        toks = torch.randint(0, small.vocab, (shp.batch, shp.seq_len),
                             generator=gen, device=dev, dtype=torch.int32)
        out = []
        for cell, st in zip(cells, states):
            out.append(cell.step(st, {"tokens": toks, "labels": toks}))
        (st_m, m_m), (st_p, m_p) = out
        print(f"  expert parallel at world 1: one train step of the "
              f"recovery cut through build_cell(mesh=ServingMesh 1x1): "
              f"loss {float(m_m['loss']):.7f} vs {float(m_p['loss']):.7f} "
              f"without a mesh; collectives {dict(CALLS)}", flush=True)
        check(sum(CALLS.values()) == 0,
              "moe_train: a collective launched at world 1")
        _train_state_close("expert parallel (1x1) vs one device", st_m,
                           st_p, m_m, m_p, MOE_LOSS_RTOL, MOE_GRAD_ATOL)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)


def _moe_recovery_cut():
    """moonshot's SMOKE widths, head dim 64, its published MoE spec (64
    experts, top 6) and remat, float32."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    return dataclasses.replace(get_smoke(MOE_ARCH), head_dim=64, remat=True,
                               moe=get_config(MOE_ARCH).moe)


def moe_train_card_vs_cpu(dev, seed: int) -> tuple:
    """moonshot's widths cut to 2 layers in float32 (MOE_TRAIN_CHECK), one
    train step on the card and on the CPU from one state: routes held as
    the moe phase holds them (the CPU takes the card's routes, which may
    differ only within ``ROUTE_TIE`` of a tie), then the loss, every
    leaf's gradient (through m) and the AdamW step. Returns
    hold_routes'."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import shapes_for_family
    from repro_torch.data import TokenPipeline
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    c = MOE_TRAIN_CHECK
    small = dataclasses.replace(get_config(MOE_ARCH), n_layers=c["layers"],
                                dtype="float32",
                                microbatches=c["microbatches"])
    shp = dataclasses.replace(shapes_for_family("lm")["train_4k"],
                              batch=c["batch"], seq_len=c["seq"])
    cells = {d: api.build_cell(small, "train_4k", device=d,
                               shape_override=shp)
             for d in (dev, "cpu")}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    card = api.materialize_state(cells[dev], small, "train_4k", gen)
    host = _tree_to(card, "cpu")
    toks, labs = (torch.from_numpy(a) for a in TokenPipeline(
        small.vocab, c["batch"], c["seq"], seed=seed).batch_at(0))
    with RouteLog(tf) as log_d:
        card, got_m = cells[dev].step(card, {"tokens": toks.to(dev),
                                             "labels": labs.to(dev)})
    with ForcedRoutes(tf, log_d.calls) as log_h:
        (host, want_m), dt = _timed(lambda: cells["cpu"].step(
            host, {"tokens": toks, "labels": labs}))
    print(f"  card vs CPU: {MOE_ARCH}'s widths cut to {small.n_layers} "
          f"layers, float32, batch {c['batch']} x seq {c['seq']}, "
          f"{small.microbatches} microbatches, one step (CPU {dt:.2f} s)",
          flush=True)
    routes = hold_routes(f"{small.n_layers}-layer train step (forward and "
                         "remat recompute)", log_d.calls, log_h.calls,
                         small.moe.n_experts)
    _train_state_close("one MoE train step", card, host, got_m, want_m,
                       MOE_LOSS_RTOL, MOE_GRAD_ATOL)
    return routes


def moe_train_phase(dev, seed: int) -> dict:
    """MoE training: ``MOE_TRAIN``'s archs at full width (moonshot with the
    expert-parallel part at world 1), the 2-layer float32 cut card
    against CPU, and the Trainer's recovery on the MoE recovery cut."""
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    print(f"moe_train: MoE training ({held / 1e9:.2f} GB left allocated on "
          f"the card by earlier phases)", flush=True)
    out, parts = {}, {}
    for i, (arch, layers) in enumerate(MOE_TRAIN):
        t0 = time.perf_counter()
        out[arch] = moe_train_run(dev, arch, layers, seed + i,
                                  ep_check=arch == MOE_ARCH)
        gc.collect()
        torch.cuda.empty_cache()
        parts[arch] = time.perf_counter() - t0
    t0 = time.perf_counter()
    routes, ties = moe_train_card_vs_cpu(dev, seed + 2)
    check(ties <= ROUTE_TIE_SHARE * routes, "moe_train: too many near ties")
    gc.collect()
    torch.cuda.empty_cache()
    parts["card vs CPU"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = _moe_recovery_cut()
    print(f"  recovery on the MoE recovery cut ({small.moe.n_experts} "
          f"experts top {small.moe.top_k}, d_model {small.d_model}, hd "
          f"{small.hd}, {small.n_layers} layers, float32, remat; batch "
          f"{MOE_RECOVERY['batch']} x seq {MOE_RECOVERY['seq']}):",
          flush=True)
    train_recovery(small, (MOE_RECOVERY["batch"], MOE_RECOVERY["seq"]), dev,
                   seed + 3)
    parts["recovery"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  moe_train: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")", flush=True)
    return out


# ---------------------------------------------------- sharded_train ----
# the sharded_train phase (one card, so three ways, as the distributed
# phase holds serving): tinyllama-1.1b through the Trainer on a mesh at
# world 1 over NCCL at full width and depth (train_4k's batch 256 -> 16,
# 2 steps, against the same Trainer without a mesh, bit for bit); then
# two gloo ranks sharing cuda:0 at the published widths with depth 22 ->
# 2: a float32 cut (batch 2 x 512) on meshes 1x2 (tensor parallel) and
# 2x1 (data parallel + ZeRO-1) against the one-device step, the bf16
# config (batch 16 x 4096, 4 microbatches, remat) on both meshes timed,
# the elastic Trainer from 2x1 losing worker 1 at step 5, and the
# compressed sum and the 2-stage pipeline on CUDA tensors
SHARDED_BATCH = 16
SHARDED_STEPS = 2
SHARDED_MESHES = ((1, 2), (2, 1))
SHARDED_CHECK = dict(layers=2, batch=2, seq=512, microbatches=1, steps=2)
SHARDED_BF16 = dict(layers=2, batch=16, steps=2)    # + a warm-up step
SHARDED_ELASTIC = dict(steps=6, ckpt_every=2, fail_at=5)
SHARDED_PSUM = 1 << 20          # elements a rank, compressed_psum
SHARDED_PIPE = dict(d=1024, batch=256, microbatches=4)
SHARDED_TIMEOUT = 600           # seconds, each rank of the pair
TP_LABEL = "the 1x2 mesh's layer-0 call (tensor parallel)"

# One rank of the gloo pair that shares cuda:0 in the sharded_train
# phase; prints its lines (rank 0's the parity and timings) and writes
# its numbers as JSON.
SHARDED_RANK = r"""
import json, shutil, sys, time
from dataclasses import replace
from pathlib import Path
cfg = json.loads(sys.argv[1])
rank = int(sys.argv[2])
sys.path.insert(0, cfg["src"])
sys.path.insert(0, cfg["root"])
import numpy as np
import torch
import torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("gloo", rank=rank, world_size=2,
                        store=dist.FileStore(cfg["store"], 2))
import chip_smoke as cs
from repro_torch.checkpoint.checkpoint import _flatten_with_paths, gather_state
from repro_torch.configs import get_config
from repro_torch.configs.base import shapes_for_family
from repro_torch.data import TokenPipeline
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.launch.train import Trainer
from repro_torch.models import api
from repro_torch.optim.compression import compressed_psum
from repro_torch.optim.optimizer import OptConfig
from repro_torch.parallel import BYTES, CALLS, sharding as shd
from repro_torch.parallel.pipeline import demo_stage_fn, pipeline_forward
from repro_torch.runtime.elastic import ElasticMeshManager
from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                 HeartbeatMonitor)
dev = torch.device("cuda", 0)
seed, work = cfg["seed"], Path(cfg["work"])
base = get_config("tinyllama-1.1b")
lm = shapes_for_family("lm")
opt = OptConfig(warmup_steps=10)
out = {"float32": {}, "bf16": {}}

def say(line):
    print(f"  [rank {rank}] {line}", flush=True)

# ---- float32 cut: 1x2 and 2x1 against the one-device step
c = cfg["check"]
small = replace(base, n_layers=c["layers"], dtype="float32",
                microbatches=c["microbatches"])
shp = replace(lm["train_4k"], batch=c["batch"], seq_len=c["seq"])
pipe = TokenPipeline(small.vocab, c["batch"], c["seq"], seed=seed + 1)
batches = [{k: torch.from_numpy(a).to(dev) for k, a in
            zip(("tokens", "labels"), pipe.batch_at(i))}
           for i in range(c["steps"])]

def fresh(cell):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    return api.materialize_state(cell, small, "train_4k", gen)

if rank == 0:
    one = api.build_cell(small, "train_4k", device=dev, shape_override=shp,
                         opt_cfg=opt)
    want = fresh(one)
    for b in batches:
        want, want_m = one.step(want, b)
for d, m in cfg["meshes"]:
    mesh = make_debug_mesh(model=m, device=dev)
    cell = api.build_cell(small, "train_4k", mesh=mesh, shape_override=shp,
                          opt_cfg=opt)
    state, pl = fresh(cell), cell.state_shardings()
    CALLS.clear(); BYTES.clear()
    for b in batches:
        state, metrics = cell.step(state, b)
    calls, nbytes = dict(CALLS), dict(BYTES)
    whole = gather_state(state, pl)
    shapes_ok = all(
        tuple(leaf.shape) == shd.local_shape(w.shape, p.spec, mesh)
        for (_, leaf), (_, w), (_, p) in zip(_flatten_with_paths(state),
                                             _flatten_with_paths(whole),
                                             _flatten_with_paths(pl)))
    cs.check(shapes_ok, f"sharded_train: a leaf's block at {d}x{m} is not "
             "its spec's")
    say(f"float32 {d}x{m}: {c['steps']} steps of batch {c['batch']} x "
        f"{c['seq']}, loss {float(metrics['loss']):.7f}, grad_norm "
        f"{float(metrics['grad_norm']):.7f}; every leaf's block of its "
        f"spec's shape; collectives over the 2 steps {calls}, bytes {nbytes}")
    if rank == 0:
        cs._train_state_close(f"{d}x{m} gathered", whole, want, metrics,
                              want_m, what="gloo pair vs one device")
    out["float32"][f"{d}x{m}"] = dict(loss=float(metrics["loss"]),
                                      calls=calls, bytes=nbytes)
    del cell, state, whole
    dist.barrier()
if rank == 0:
    del one, want
torch.cuda.empty_cache()

# ---- bf16 at the published widths, depth cut: both meshes timed
b = cfg["bf16"]
cut = replace(base, n_layers=b["layers"])
mb = cut.microbatches
S = lm["train_4k"].seq_len
launch_want = {"flash_fwd": (2 if cut.remat else 1) * cut.n_layers * mb,
               "flash_bwd_dq": cut.n_layers * mb,
               "flash_bwd_dkv": cut.n_layers * mb}
launches_total = dict.fromkeys(launch_want, 0)
for d, m in cfg["meshes"]:
    mesh = make_debug_mesh(model=m, device=dev)
    tr = Trainer("tinyllama-1.1b", cfg_override=cut, mesh=mesh, seed=seed,
                 batch_override=b["batch"], seq_override=S)
    tr.init_state()
    captured, forward = [], []
    flash_bwd, attention = fa.flash_bwd, ops.attention
    tp = (d, m) == (1, 2) and rank == 0

    def capture(*args, **kw):
        captured.append((*(t.detach() for t in args), kw["causal"],
                         kw["q_offset"]))
        return flash_bwd(*args, **kw)

    def capture_fwd(q, k, v, **kw):
        if not forward:
            forward.append((q.detach(), k.detach(), v.detach(),
                            kw["causal"], kw["q_offset"]))
        return attention(q, k, v, **kw)
    if tp:
        fa.flash_bwd, ops.attention = capture, capture_fwd
    try:
        tr.run(1)                                  # warm-up
    finally:
        fa.flash_bwd, ops.attention = flash_bwd, attention
    torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    for _ in range(b["steps"]):
        before = dict(_lib.LAUNCHES)
        CALLS.clear(); BYTES.clear()
        tr.run(tr.step_idx + 1)
        step = {k: _lib.LAUNCHES[k] - before.get(k, 0) for k in launch_want}
        h = tr.history[-1]
        rows.append(dict(seconds=h["seconds"],
                         tokens_per_s=b["batch"] * S / h["seconds"],
                         loss=tr.metrics["loss"], calls=dict(CALLS),
                         bytes=dict(BYTES), launches=step))
        cs.check(step == launch_want, f"sharded_train: launches a step "
                 f"{step} at {d}x{m}, expected {launch_want}")
        cs.check(np.isfinite(tr.metrics["loss"]), "sharded_train: loss")
        for k in step:
            launches_total[k] += step[k]
    peak = torch.cuda.max_memory_allocated(dev)
    for i, r in enumerate(rows):
        say(f"bf16 {d}x{m} step {i}: {r['seconds']:.3f} s, "
            f"{r['tokens_per_s']:.0f} tokens/s (the two ranks share one "
            f"card), loss {r['loss']:.4f}, launches {r['launches']}; "
            f"collectives {r['calls']}, bytes {r['bytes']}")
    say(f"bf16 {d}x{m}: peak device memory {peak / 1e9:.2f} GB a rank")
    out["bf16"][f"{d}x{m}"] = dict(rows=rows, peak_bytes=peak)
    del tr
    torch.cuda.empty_cache()
    dist.barrier()               # rank 1 idle while rank 0 times the call
    if tp:
        layer0 = captured[cut.n_layers - 1]
        del captured
        seq0 = tuple(t[:1].contiguous() for t in layer0[:6]) + layer0[6:]
        res = cs.flash_bwd_parity(f"on {cs.TP_LABEL}, sequence 0", seq0)
        timing = cs.time_flash_bwd(layer0, cs.TP_LABEL, seq0)
        for name in timing:
            timing[name]["err"] = list(res[name])
        q, k, v, causal, qo = forward.pop()
        n = cs.LM_PARITY_ROWS
        tail = (q[:1, -n:].contiguous(), k[:1].contiguous(),
                v[:1].contiguous(), causal, qo + S - n)
        err = cs.flash_tail_parity(tail, f"{cs.TP_LABEL}, sequence 0's last "
                                         f"{n} query rows")
        timing["flash_fwd"] = cs.time_flash((q, k, v, causal, qo), tail,
                                            cs.TP_LABEL)
        timing["flash_fwd"]["err"] = list(err)
        timing["shapes"] = [list(q.shape), list(k.shape)]
        out["tp_call"] = timing
        del layer0, seq0, q, k, v, tail
        torch.cuda.empty_cache()
    dist.barrier()
out["launches"] = launches_total

# ---- elastic: 2x1 loses worker 1 (rank 1) at step 5
e = cfg["elastic"]
mgr = ElasticMeshManager(prefer_model=1, device=str(dev))

def elastic_trainer(**kw):
    return Trainer("tinyllama-1.1b", cfg_override=small, seed=seed,
                   batch_override=c["batch"], seq_override=c["seq"], **kw)
t0 = time.perf_counter()
tr = elastic_trainer(mesh=mgr.current_mesh(), elastic=mgr,
                     ckpt_dir=str(work / "ckpt_elastic"),
                     fault_injector=FaultInjector.worker_failure_at(
                         e["fail_at"], worker=1))
tr.monitor = HeartbeatMonitor(n_workers=2, timeout_s=3600)
start = dict(tr.mesh.sizes)
tr.restore_or_init()
hist = tr.run(e["steps"], ckpt_every=e["ckpt_every"], log_every=100)
el = dict(start=start, left=tr.left, step=tr.step_idx,
          generation=mgr.generation, recoveries=tr.recoveries,
          losses=[h["loss"] for h in hist],
          seconds=time.perf_counter() - t0)
say(f"elastic: mesh {start}, worker 1 fails at step {e['fail_at']}: "
    f"generation {el['generation']}, {'left' if tr.left else 'stayed'} at "
    f"step {tr.step_idx}, mesh after "
    f"{None if tr.mesh is None else dict(tr.mesh.sizes)}; losses "
    f"{el['losses']}; {el['seconds']:.1f} s")
cs.check(el["generation"] == 1 and tr.recoveries == 1,
         "sharded_train: the elastic Trainer did not re-mesh once")
cs.check(tr.left == (rank == 1), "sharded_train: the wrong rank left")
dist.barrier()
if rank == 0:
    cs.check(tr.mesh is None and tr.step_idx == e["steps"],
             "sharded_train: rank 0 did not finish on one device")
    last = (e["fail_at"] // e["ckpt_every"]) * e["ckpt_every"]
    resume = work / "ckpt_resume"
    shutil.copytree(work / "ckpt_elastic" / f"step_{last}",
                    resume / f"step_{last}")
    (resume / f"step_{last}.done").touch()
    again = elastic_trainer(ckpt_dir=str(resume), device=dev)
    cs.check(again.restore_or_init() and again.step_idx == last,
             "sharded_train: no checkpoint to resume from")
    again.ckpt = None                 # nothing to write: compared below
    h2 = again.run(e["steps"], log_every=100)
    after = el["losses"][-(e["steps"] - last):]
    same = after == [h["loss"] for h in h2] and all(
        torch.equal(a, b_) for (_, a), (_, b_) in zip(
            _flatten_with_paths(tr.state), _flatten_with_paths(again.state)))
    say(f"elastic: losses after the recovery {after} against a one-device "
        f"Trainer resumed from step {last}: "
        f"{[h['loss'] for h in h2]}; state bit for bit: {same}")
    cs.check(same, "sharded_train: the recovered run differs from the "
             "resumed one")
    el["bit_for_bit"] = same
    del again
out["elastic"] = el
del tr
torch.cuda.empty_cache()
dist.barrier()

# ---- compressed_psum and the 2-stage pipeline on CUDA tensors
mesh = Mesh((2,), ("data",), device=dev)
g = torch.Generator().manual_seed(seed + 3)
shards = torch.randn((2, cfg["psum"]), generator=g)
got = compressed_psum(shards[rank].to(dev), mesh.group("data"))
host = compressed_psum(shards[rank], mesh.group("data"))
exact = shards.sum(0)
scale = float(shards.abs().max()) / 127.0
err = float((got.cpu() - exact).abs().max())
same = bool(torch.equal(got.cpu(), host))
say(f"compressed_psum of {cfg['psum']} float32 a rank over the pair: max "
    f"error {err:.3e} against the exact sum (limit 4 x scale = "
    f"{4 * scale:.3e}); equal to the CPU tensors' bit for bit: {same}")
cs.check(err <= 4 * scale + 1e-6 and same, "sharded_train: compressed_psum")
p = cfg["pipe"]
pm = Mesh((2,), ("pod",), device=dev)
g = torch.Generator(device=dev)
g.manual_seed(seed + 4)
w, w2 = (torch.randn((2, p["d"], p["d"]), generator=g, device=dev)
         / p["d"] ** 0.5 for _ in range(2))
x = torch.randn((p["batch"], p["d"]), generator=g, device=dev)
i = pm.index("pod")
y = pipeline_forward(pm, demo_stage_fn, 2, p["microbatches"])(
    {"w": w[i:i + 1], "w2": w2[i:i + 1]}, x)
ref = x
for s in range(2):
    ref = demo_stage_fn({"w": w[s], "w2": w2[s]}, ref)
perr = float((y - ref).abs().max())
top = float(ref.abs().max())
say(f"pipeline_forward, 2 stages, {p['microbatches']} microbatches of "
    f"{p['batch'] // p['microbatches']} x {p['d']}: max error {perr:.3e} "
    f"against the sequential forward (limit 2e-4 x (1 + max|want| "
    f"{top:.3e}))")
cs.check(perr <= 2e-4 * (1 + top), "sharded_train: pipeline_forward")
out["psum"] = dict(err=err, scale=scale, bit_for_bit=same)
out["pipeline"] = dict(err=perr, top=top)
with open(cfg["out"] % rank, "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def sharded_world_one(dev, seed: int) -> dict:
    """The Trainer on a world-1 NCCL mesh (1x1, a FileStore under build/)
    at full width and depth against the Trainer without a mesh, bit for
    bit: losses and every leaf after ``SHARDED_STEPS`` steps. Returns the
    mesh run's launch counts."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.parallel import CALLS
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(work / "store"), 1))
    try:
        runs = {}
        for label, mesh in (("mesh 1x1", make_debug_mesh(device=dev)),
                            ("no mesh", None)):
            tr = Trainer(TRAIN_ARCH, smoke=False, mesh=mesh, device=dev,
                         batch_override=SHARDED_BATCH, seed=seed)
            tr.init_state()
            CALLS.clear()
            if mesh is not None:
                reset_counters()
            tr.run(SHARDED_STEPS)
            if mesh is not None:
                counts = read_counters()
                calls = dict(CALLS)
            runs[label] = tr
            print(f"  world 1 over NCCL, {label}: {tr.cfg.n_layers} layers, "
                  f"{tr.cfg.dtype}, batch {SHARDED_BATCH} x "
                  f"{tr.shape.seq_len}: losses "
                  f"{[h['loss'] for h in tr.history]}, "
                  f"{[round(h['seconds'], 3) for h in tr.history]} s",
                  flush=True)
        a, b = runs["mesh 1x1"], runs["no mesh"]
        same = [h["loss"] for h in a.history] == \
            [h["loss"] for h in b.history] and all(
                torch.equal(x, y) for x, y in zip(_leaves(a.state),
                                                  _leaves(b.state)))
        print(f"  world 1 over NCCL: the mesh Trainer's losses and state "
              f"equal the one-device Trainer's bit for bit: {same}; "
              f"collectives {calls}; launches {counts}", flush=True)
        check(same, "sharded_train: the 1x1 mesh differs from no mesh")
        check(not calls, "sharded_train: a collective launched at world 1")
        del runs, a, b
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    return counts


def sharded_pair(seed: int) -> tuple:
    """The gloo pair's parts of the sharded_train phase
    (``SHARDED_RANK``): every rank's JSON and wall seconds."""
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    cfg = {"src": str(SRC), "root": str(ROOT), "store": str(work / "store"),
           "work": str(work), "out": str(work / "rank%d.json"),
           "seed": seed, "meshes": [list(m) for m in SHARDED_MESHES],
           "check": SHARDED_CHECK, "bf16": SHARDED_BF16,
           "elastic": SHARDED_ELASTIC, "psum": SHARDED_PSUM,
           "pipe": SHARDED_PIPE}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARDED_RANK, json.dumps(cfg), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=SHARDED_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    try:
        for r, (proc, log) in enumerate(zip(procs, logs)):
            print("\n".join(line for line in log.splitlines()
                            if line.startswith("  ")), flush=True)
            check(proc.returncode == 0,
                  f"sharded_train rank {r} exited {proc.returncode}:\n"
                  f"{log[-4000:]}")
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ranks, wall


def sharded_train_phase(dev, seed: int) -> dict:
    """The sharded_train phase: world 1 over NCCL, then the gloo pair.
    Returns the launches of kernels 6-8 (the world-1 mesh run's and the
    pair's timed bf16 steps', both ranks) and rank 0's timings at the
    tensor-parallel call."""
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sharded_train: {TRAIN_ARCH} on a mesh (world 1 over NCCL at "
          f"full depth; two gloo ranks sharing cuda:0, depth 22 -> "
          f"{SHARDED_BF16['layers']})", flush=True)
    counts = sharded_world_one(dev, seed)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks, wall = sharded_pair(seed)
    launches = dict(counts)
    for r in ranks:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"  sharded_train: world 1 {t1 - t0:.1f} s, the gloo pair "
          f"{wall:.1f} s; launches of kernels 6-8 (world-1 mesh run and "
          f"the pair's timed steps) "
          f"{ {k: launches[k] for k in ranks[0]['launches']} }", flush=True)
    return dict(counts=launches, tp_call=ranks[0]["tp_call"],
                seconds=time.perf_counter() - t0)


# ----------------------------------------------------- sharded_cells ----
# the sharded_cells phase (one card, so two ways): every other cell kind
# on a mesh. World 1 over NCCL (mesh 1x1) at the published configs:
# llama3-8b's prefill of 32,768 tokens and 32 decode steps at batch 1,
# ogb_products' train step uncut and MIND's retrieval_cand, each against
# the same cell without a mesh, bit for bit, with no collective. Then two
# gloo ranks sharing cuda:0 at the published widths, depth cut to 2
# layers: llama3-8b at 1x2 (tensor-parallel prefill, decode over the
# cache's sequence split in two), moonshot-v1-16b-a3b at 1x2 (attention
# over 'model', experts over the model ranks), gin-tu's molecule cell and
# graphsage-reddit's minibatch_lg at 2x1, MIND's train_batch at 1x2 and
# retrieval_cand at 2x1: float32 cuts against the same cell on one device
# at the CPU tests' tolerances, the published dtype timed, and kernels 6,
# 9 and 10 held against their plain versions at a rank's calls and timed
SC_LLAMA = dict(layers=2, prompt=32768, steps=32,
                check=dict(prompt=1024, steps=8))
# moonshot's float32 cut holds 1 layer: the two ranks' blocks, the state
# gathered on each and rank 0's one-device step at 2 layers would not fit
# the card together
SC_MOE = dict(layers=2, prompt=16384, batch=4, seq=4096,
              check=dict(layers=1, prompt=512, batch=4, seq=256))
SC_MOLECULE = 65_536           # gin-tu's molecule batch 128 -> 65,536
SC_MIND_BATCH = 8192           # MIND's train_batch 65,536 -> 8,192
SC_BF16_TOL = dict(rtol=1e-2, atol=1e-2)    # atol times max|want|
SC_TIMEOUT = 600               # seconds, each rank of the pair
SC_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "batched_mp",
              "batched_mp_bwd", "retrieval_score")
SC_LABELS = {"flash_fwd": "the 1x2 llama3-8b prefill's layer-0 call "
                          "(tensor parallel)",
             "batched_mp": "batched_mp (gin-tu molecule, a 2x1 data rank's "
                           "graphs)",
             "batched_mp_bwd": "batched_mp_bwd (gin-tu molecule, a 2x1 data "
                               "rank's graphs)",
             "retrieval_score": "retrieval_score (MIND retrieval_cand, a 2x1"
                                " data rank's candidates)"}

# One rank of the gloo pair that shares cuda:0 in the sharded_cells phase;
# prints its lines (rank 0's the holds and timings) and writes its
# numbers as JSON.
SHARDED_CELLS_RANK = r"""
import json, sys, time
from dataclasses import replace
cfg = json.loads(sys.argv[1])
rank = int(sys.argv[2])
sys.path.insert(0, cfg["src"])
sys.path.insert(0, cfg["root"])
import numpy as np
import torch
import torch.distributed as dist
dev = torch.device(cfg["device"], 0) if cfg["device"] == "cuda" \
    else torch.device("cpu")
if dev.type == "cuda":
    torch.cuda.set_device(0)
dist.init_process_group("gloo", rank=rank, world_size=2,
                        store=dist.FileStore(cfg["store"], 2))
import chip_smoke as cs
from repro_torch.checkpoint.checkpoint import _flatten_with_paths, gather_state
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import shapes_for_family
from repro_torch.kernels import _lib, batched_mp as bm, ops
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import api, transformer as tf
from repro_torch.optim.optimizer import OptConfig, adamw_init
from repro_torch.parallel import BYTES, CALLS, sharding as shd
seed, cuda = cfg["seed"], dev.type == "cuda"
config = get_config if cuda else get_smoke
out = {"launches": dict.fromkeys(cfg["kernels"], 0), "runs": {},
       "holds": {}, "calls": {}}
opt = OptConfig(warmup_steps=10)

T0 = time.perf_counter()

def say(line):
    print(f"  [rank {rank}, {time.perf_counter() - T0:.1f} s] {line}",
          flush=True)

def sync():
    if cuda:
        torch.cuda.synchronize()

def gen(k):
    g = torch.Generator(device=dev)
    g.manual_seed(seed + k)
    return g

def run(label, fn):
    # fn() with its seconds, the peak memory a rank, the kernels it
    # launched and the collectives it made, and their bytes
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = dict(_lib.LAUNCHES)
    CALLS.clear(); BYTES.clear()
    t0 = time.perf_counter()
    res = fn()
    sync()
    row = dict(seconds=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda
               else 0, calls=dict(CALLS), bytes=dict(BYTES),
               launches={k: _lib.LAUNCHES.get(k, 0) - before.get(k, 0)
                         for k in cfg["kernels"]})
    for k, n in row["launches"].items():
        out["launches"][k] += n
    out["runs"][label] = row
    say(f"{label}: {row['seconds']:.3f} s (the two ranks share one card), "
        f"peak {row['peak_bytes'] / 1e9:.2f} GB a rank; launches "
        f"{ {k: n for k, n in row['launches'].items() if n} }; collectives "
        f"{row['calls']}, bytes {row['bytes']}")
    return res

def hold(label, got, want, rtol=cs.FORWARD_RTOL, atol=cs.FORWARD_ATOL):
    # got against want at rtol and atol times max|want| (at least 1)
    a = atol * max(1.0, float(want.abs().max()))
    err, bad, rel = cs.close_stats(got, want, rtol, a)
    say(f"mesh vs one device {label}: {want.numel()} values, {bad} "
        f"mismatches, max abs err {err:.3e}, max rel err {rel:.3e} (rtol "
        f"{rtol}, atol {a:.3e})")
    out["holds"][label] = dict(err=err, bad=bad, rel=rel)
    cs.check(bad == 0, f"sharded_cells: {label} differs from one device")

lm = shapes_for_family("lm")
tp_mesh = make_debug_mesh(model=2, device=dev)
dp_mesh = make_debug_mesh(model=1, device=dev)

def whole_cache(c, cache, shape):
    res = {}
    for k, v in cache.items():
        spec = shd.logical_to_spec(tf.cache_logical_axes(c)[k],
                                   tf.cache_shapes(c, *shape)[k], tp_mesh)
        res[k] = shd.gather(v, spec, tp_mesh)
    return res

def lm_run(c, P, T, label, hold_tol=None):
    # prefill P tokens and T greedy decode steps at batch 1 on the 1x2
    # mesh; with hold_tol, the same on one device (rank 0, teacher-forced
    # with the mesh's tokens): logits each step and the cache
    shp = replace(lm["decode_32k"], batch=1, seq_len=P + T)
    cell = api.build_cell(c, "decode_32k", mesh=tp_mesh, shape_override=shp)
    params = tf.init_params(c, gen(1), dev)
    state = api.shard_state(cell, {"params": params})
    if hold_tol is None:
        del params
    prompt = torch.randint(0, c.vocab, (1, P), generator=gen(2),
                           device=dev)

    def prefill():
        return tf.prefill(c, state["params"], prompt, P + T, tp=cell.tp,
                          shard=cell.cache_shard)
    logits, state["cache"] = run(f"{label} prefill of {P}", prefill)
    steps = [logits]
    toks = []

    def decode():
        nonlocal state
        lg = logits
        for i in range(T):
            tok = lg.argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
            state, lg = cell.step(state, {"token": tok, "pos": P + i})
            steps.append(lg)
    run(f"{label} {T} decode steps", decode)
    whole = whole_cache(c, state["cache"], (1, P + T))
    if hold_tol is not None and rank == 0:
        logits1, cache1 = tf.prefill(c, params, prompt, P + T)
        want = [logits1]
        for i, tok in enumerate(toks):
            lg, cache1 = tf.decode_step(c, params, cache1, tok, P + i)
            want.append(lg)
        for i, (g, w) in enumerate(zip(steps, want)):
            hold(f"{label} logits step {i}", g, w, **hold_tol)
        for k in cache1:
            hold(f"{label} cache {k}", whole[k], cache1[k], **hold_tol)
    return toks

# ---- llama3-8b at 1x2: float32 cut held, bf16 at 32k timed
L = cfg["llama"]
base = replace(config("llama3-8b"), n_layers=L["layers"])
lm_run(replace(base, dtype="float32"), L["check"]["prompt"],
       L["check"]["steps"], "llama3-8b float32", {})
captured = []
attention = ops.attention

def capture(q, k, v, **kw):
    if not captured:             # layer 0's call, by reference
        captured.append((q, k, v, kw["causal"], kw["q_offset"]))
    return attention(q, k, v, **kw)
if rank == 0:
    ops.attention = capture
try:
    toks = lm_run(base, L["prompt"], L["steps"], f"llama3-8b {base.dtype}")
finally:
    ops.attention = attention
out["llama_tokens"] = [int(t) for t in toks]
dist.barrier()
if rank == 0 and cuda:
    q, k, v, causal, qo = captured.pop()
    n = cs.LM_PARITY_ROWS
    tail = (q[:, -n:].contiguous(), k, v, causal, qo + q.shape[1] - n)
    err = cs.flash_tail_parity(tail, cs.SC_LABELS["flash_fwd"])
    out["flash_fwd"] = cs.time_flash((q, k, v, causal, qo), tail,
                                     cs.SC_LABELS["flash_fwd"])
    out["flash_fwd"]["err"] = list(err)
    out["flash_fwd"]["shapes"] = [list(q.shape), list(k.shape)]
    del q, k, v, tail
captured.clear()
dist.barrier()
if cuda:
    torch.cuda.empty_cache()

# ---- moonshot-v1-16b-a3b at 1x2: attention over 'model'
M = cfg["moe"]
mbase = replace(config("moonshot-v1-16b-a3b"), n_layers=M["layers"])

def moe_prefill(c, P, label, held):
    shp = replace(lm["prefill_32k"], batch=1, seq_len=P)
    cell = api.build_cell(c, "prefill_32k", mesh=tp_mesh, shape_override=shp)
    params = tf.init_params(c, gen(3), dev)
    state = api.shard_state(cell, {"params": params})
    prompt = torch.randint(0, c.vocab, (1, P), generator=gen(4), device=dev)
    _, res = run(f"{label} prefill of {P}",
                 lambda: cell.step(state, {"tokens": prompt}))
    if held and rank == 0:
        logits, cache = tf.prefill(c, params, prompt, P)
        hold(f"{label} prefill logits", res["logits"], logits)
    if held:
        whole = whole_cache(c, res["cache"], (1, P))
        if rank == 0:
            hold(f"{label} prefill cache k", whole["k"], cache["k"])

def moe_train(c, B, S, label, held):
    # the mesh's state drawn as one device draws it, its blocks kept; the
    # state gathered whole, then rank 0 steps one device beside it
    shp = replace(lm["train_4k"], batch=B, seq_len=S)
    cell = api.build_cell(c, "train_4k", mesh=tp_mesh, shape_override=shp,
                          opt_cfg=opt)
    state = api.materialize_state(cell, c, "train_4k", gen(5))
    toks = torch.randint(0, c.vocab, (B, S + 1), generator=gen(6),
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    state, m = run(f"{label} train step of {B} x {S}",
                   lambda: cell.step(state, batch))
    cs.check(np.isfinite(float(m["loss"])), "sharded_cells: moe loss")
    if held:
        got = gather_state(state, cell.state_shardings())
        del state
        if rank:
            del got
        if cuda:
            torch.cuda.empty_cache()
        if rank == 0:
            one = api.build_cell(c, "train_4k", device=dev,
                                 shape_override=shp, opt_cfg=opt)
            want, wm = one.step(api.materialize_state(
                one, c, "train_4k", gen(5)), batch)
            cs._train_state_close(label, got, want, m, wm,
                                  what="mesh vs one device")
            del got, want
        dist.barrier()
mcheck = replace(mbase, dtype="float32", n_layers=M["check"]["layers"])
moe_prefill(mcheck, M["check"]["prompt"], "moonshot float32", True)
moe_train(mcheck, M["check"]["batch"], M["check"]["seq"],
          f"moonshot float32 ({mcheck.n_layers} layer)", True)
if cuda:
    torch.cuda.empty_cache()
moe_prefill(mbase, M["prompt"], f"moonshot {mbase.dtype}", False)
moe_train(mbase, M["batch"], M["seq"], f"moonshot {mbase.dtype}", False)
dist.barrier()
if cuda:
    torch.cuda.empty_cache()

# ---- GNN at 2x1: gin-tu molecule (kernel 9 on a rank's graphs), sage
def gnn_train(arch, shape_name, over, label, record=False):
    c = config(arch)
    shp = replace(shapes_for_family("gnn")[shape_name], **over)
    cell = api.build_cell(c, shape_name, mesh=dp_mesh, shape_override=shp,
                          opt_cfg=opt)
    whole = api.materialize_state(api.build_cell(
        c, shape_name, device=dev, shape_override=shp), c, shape_name,
        gen(7))
    state = api.shard_state(cell, cs._tree_clone(whole))
    batch = cs._card_batch(cell, shp.n_classes, gen(8), dev)
    calls = {}
    if record and rank == 0:
        orig_fwd = ops.batched_mp
        orig_call = bm._call

        def fwd(adj, x, w):
            calls.setdefault("batched_mp", (adj.shape[0], (adj, x, w)))
            return orig_fwd(adj, x, w)

        def call(adj, x, w, counter):
            if counter == "batched_mp_bwd":
                calls.setdefault("batched_mp_bwd",
                                 (adj.shape[0], (adj, x, w)))
            return orig_call(adj, x, w, counter)
        ops.batched_mp, bm._call = fwd, call
    try:
        state, m = run(f"{label} train step", lambda: cell.step(state, batch))
    finally:
        if record and rank == 0:
            ops.batched_mp, bm._call = orig_fwd, orig_call
    cs.check(np.isfinite(float(m["loss"])), f"sharded_cells: {label} loss")
    got = gather_state(state, cell.state_shardings())
    if rank == 0:
        one = api.build_cell(c, shape_name, device=dev, shape_override=shp,
                             opt_cfg=opt)
        want, wm = one.step(whole, batch)
        cs._train_state_close(label, got, want, m, wm,
                              what="mesh vs one device")
    return calls
G = cfg["molecule"]
mp_calls = gnn_train("gin-tu", "molecule", dict(batch_graphs=G),
                     f"gin-tu molecule (batch 128 -> {G}) at 2x1", True)
gnn_train("graphsage-reddit", "minibatch_lg", {},
          "graphsage-reddit minibatch_lg at 2x1")
dist.barrier()
if rank == 0 and cuda:
    times = cs.time_kernels({}, extra=tuple(
        (name, cs.SC_LABELS[name], mp_calls[name])
        for name in ("batched_mp", "batched_mp_bwd")))
    for name in ("batched_mp", "batched_mp_bwd"):
        out[name] = times[cs.SC_LABELS[name]]
        out[name]["err"] = list(out[name]["err"])
mp_calls.clear()
dist.barrier()
if cuda:
    torch.cuda.empty_cache()

# ---- MIND: train_batch at 1x2 (the table's rows over 'model'),
# retrieval_cand at 2x1 (kernel 10 on a data rank's candidates)
c = config("mind")
rs = shapes_for_family("recsys")
shp = replace(rs["train_batch"], batch=cfg["mind_batch"])
cell = api.build_cell(c, "train_batch", mesh=tp_mesh, shape_override=shp,
                      opt_cfg=opt)
params = api.materialize_state(api.build_cell(c, "serve_p99", device=dev),
                               c, "serve_p99", gen(9))["params"]
whole = {"params": params, "opt": adamw_init(params)}
state = api.shard_state(cell, cs._tree_clone(whole))
B, Lh = shp.batch, c.hist_len
g = gen(10)
batch = {"hist_ids": torch.randint(0, c.n_items, (B, Lh), generator=g,
                                   device=dev, dtype=torch.int32),
         "hist_mask": (torch.rand((B, Lh), generator=g, device=dev)
                       < 0.9).float(),
         "target": torch.randint(0, c.n_items, (B,), generator=g, device=dev,
                                 dtype=torch.int32),
         "negatives": torch.randint(0, c.n_items, (B, c.n_negatives),
                                    generator=g, device=dev,
                                    dtype=torch.int32)}
state, m = run(f"MIND train_batch (batch 65536 -> {B}) at 1x2",
               lambda: cell.step(state, batch))
got = gather_state(state, cell.state_shardings())
if rank == 0:
    one = api.build_cell(c, "train_batch", device=dev, shape_override=shp,
                         opt_cfg=opt)
    want, wm = one.step(whole, batch)
    cs._train_state_close("MIND train_batch at 1x2", got, want, m, wm,
                          what="mesh vs one device")
    del one, want
del got, state, whole, batch
params = api.materialize_state(api.build_cell(c, "serve_p99", device=dev),
                               c, "serve_p99", gen(9))["params"]
cell = api.build_cell(c, "retrieval_cand", mesh=dp_mesh)
(C,), _ = cell.batch_shapes["cand_ids"]
g = gen(11)
batch = {"hist_ids": torch.randint(0, c.n_items, (1, Lh), generator=g,
                                   device=dev, dtype=torch.int32),
         "hist_mask": torch.ones((1, Lh), device=dev),
         "cand_ids": torch.randint(0, c.n_items, (C,), generator=g,
                                   device=dev, dtype=torch.int32)}
rec = {}
orig = ops.retrieval_score

def score(cands, ints):
    rec.setdefault("call", (cands.shape[0], (cands, ints)))
    return orig(cands, ints)
if rank == 0:
    ops.retrieval_score = score
try:
    _, scores = run("MIND retrieval_cand at 2x1",
                    lambda: cell.step({"params": params}, batch))
finally:
    ops.retrieval_score = orig
if rank == 0:
    one = api.build_cell(c, "retrieval_cand", device=dev)
    _, want = one.step({"params": params}, batch)
    hold("MIND retrieval_cand scores", scores, want)
    off = cs._top_items_agree(batch["cand_ids"].cpu().numpy(),
                              scores.cpu(), want.cpu())
    cs.check(off == 0, "sharded_cells: retrieval's top 100 differ")
    if cuda:
        label = cs.SC_LABELS["retrieval_score"]
        t = cs.time_kernels({}, extra=(("retrieval_score", label,
                                        rec["call"]),))[label]
        t["err"] = list(t["err"])
        out["retrieval_score"] = t
rec.clear()
with open(cfg["out"] % rank, "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def sharded_cells_world_one(dev, seed: int) -> dict:
    """World 1 over NCCL (mesh 1x1, a FileStore under build/): llama3-8b's
    prefill of 32,768 tokens and ``LM_DECODE`` greedy decode steps at
    batch 1, ogb_products' train step and MIND's retrieval_cand, each on
    the mesh and without it from the same state and batch, bit for bit,
    with no collective. Returns the mesh runs' launches."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import shapes_for_family
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import CALLS
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(work / "store"), 1))
    counts = collections.Counter()

    def gen(k):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + k)
        return g

    def both(label, fn):
        # fn(mesh) on the 1x1 mesh, counted, then without a mesh
        CALLS.clear()
        reset_counters()
        a, ta = _timed(lambda: fn(mesh))
        counts.update({k: v for k, v in read_counters().items()
                       if not k.startswith("sparse_")})
        calls = dict(CALLS)
        b, tb = _timed(lambda: fn(None))

        def equal(x, y):
            return all(torch.equal(u, w) for u, w in zip(_leaves(x),
                                                         _leaves(y)))
        same = equal(a, b)
        print(f"  world 1 over NCCL, {label}: mesh 1x1 {ta:.3f} s, no mesh "
              f"{tb:.3f} s; equal bit for bit: {same}; collectives {calls}",
              flush=True)
        if not same:
            # a step whose float sums take atomics (index_add_) gives
            # other bits on every run: then the mesh is held within the
            # model phases' tolerance of it, and its repeat shows it
            again = equal(b, fn(None))
            bad = sum(close_stats(u.float(), w.float(), FORWARD_RTOL,
                                  forward_atol(w.float()))[1]
                      for u, w in zip(_leaves(a), _leaves(b)))
            print(f"    without a mesh twice: equal bit for bit {again}; "
                  f"mesh vs no mesh {bad} mismatches at rtol "
                  f"{FORWARD_RTOL}, atol {FORWARD_ATOL} x max|want|",
                  flush=True)
            same = not again and bad == 0
        check(same, f"sharded_cells: {label} on the 1x1 mesh differs from "
                    "no mesh")
        check(not calls, f"sharded_cells: a collective at world 1 ({label})")

    try:
        mesh = make_debug_mesh(device=dev)
        cfg = get_config(LM_ARCH)
        S = shapes_for_family("lm")["prefill_32k"].seq_len
        params = tf.init_params(cfg, gen(20), dev)
        prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen(21),
                               device=dev)
        shp = dataclasses.replace(shapes_for_family("lm")["decode_32k"],
                                  batch=1, seq_len=S + LM_DECODE)

        def lm_run(m):
            cell = api.build_cell(cfg, "decode_32k", device=dev, mesh=m,
                                  shape_override=shp)
            logits, cache = tf.prefill(cfg, params, prompt, S + LM_DECODE,
                                       tp=cell.tp, shard=cell.cache_shard)
            state, out = {"params": params, "cache": cache}, [logits]
            for i in range(LM_DECODE):
                tok = out[-1].argmax(-1, keepdim=True).to(torch.int32)
                state, lg = cell.step(state, {"token": tok, "pos": S + i})
                out.append(lg)
            return out + [state["cache"]["k"][:, :, S:]]
        both(f"{LM_ARCH} prefill of {S} and {LM_DECODE} decode steps at "
             f"batch 1 ({cfg.n_layers} layers)", lm_run)
        del params, prompt
        torch.cuda.empty_cache()
        gcfg = get_config("graphsage-reddit")
        gshape = shapes_for_family("gnn")["ogb_products"]
        one = api.build_cell(gcfg, "ogb_products", device=dev)
        whole = api.materialize_state(one, gcfg, "ogb_products", gen(22))
        batch = _card_batch(one, gshape.n_classes, gen(23), dev)

        def gnn_step(m):
            cell = api.build_cell(gcfg, "ogb_products", device=dev, mesh=m)
            state = {"params": _tree_clone(whole["params"]),
                     "opt": _tree_clone(whole["opt"])}
            return list(cell.step(state, batch))
        both("graphsage-reddit ogb_products train step (uncut)", gnn_step)
        del whole, batch, one
        torch.cuda.empty_cache()
        rcfg = get_config("mind")
        one = api.build_cell(rcfg, "retrieval_cand", device=dev)
        params = api.materialize_state(one, rcfg, "retrieval_cand",
                                       gen(24))["params"]
        (C,), _ = one.batch_shapes["cand_ids"]
        g = gen(25)
        batch = {"hist_ids": torch.randint(0, rcfg.n_items,
                                           (1, rcfg.hist_len), generator=g,
                                           device=dev, dtype=torch.int32),
                 "hist_mask": torch.ones((1, rcfg.hist_len), device=dev),
                 "cand_ids": torch.randint(0, rcfg.n_items, (C,),
                                           generator=g, device=dev,
                                           dtype=torch.int32)}
        both("MIND retrieval_cand", lambda m: api.build_cell(
            rcfg, "retrieval_cand", device=dev, mesh=m).step(
            {"params": params}, batch)[1])
        del params, batch, one
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    return dict(counts)


def sharded_cells_pair(seed: int, device: str = "cuda") -> tuple:
    """The gloo pair's part of the sharded_cells phase
    (``SHARDED_CELLS_RANK``): every rank's JSON and wall seconds."""
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    cfg = {"src": str(SRC), "root": str(ROOT), "store": str(work / "store"),
           "out": str(work / "rank%d.json"), "seed": seed, "device": device,
           "llama": SC_LLAMA, "moe": SC_MOE, "molecule": SC_MOLECULE,
           "mind_batch": SC_MIND_BATCH, "kernels": list(SC_KERNELS)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARDED_CELLS_RANK, json.dumps(cfg), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=SC_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    try:
        for r, (proc, log) in enumerate(zip(procs, logs)):
            print("\n".join(line for line in log.splitlines()
                            if line.startswith("  ")), flush=True)
            check(proc.returncode == 0,
                  f"sharded_cells rank {r} exited {proc.returncode}:\n"
                  f"{log[-4000:]}")
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ranks, wall


def sharded_cells_phase(dev, seed: int) -> dict:
    """The sharded_cells phase: world 1 over NCCL, then the gloo pair.
    Returns the launches of its kernels (the world-1 mesh runs' and both
    ranks'), and rank 0's timings at the pair's calls of kernels 6, 9
    and 10."""
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sharded_cells: every cell kind on a mesh (world 1 over NCCL at "
          f"the published configs; two gloo ranks sharing cuda:0, depth "
          f"cut to {SC_LLAMA['layers']} layers, MIND's train batch 65536 -> "
          f"{SC_MIND_BATCH}, gin-tu's molecule batch 128 -> {SC_MOLECULE})",
          flush=True)
    counts = sharded_cells_world_one(dev, seed)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks, wall = sharded_cells_pair(seed)
    launches = {k: counts.get(k, 0) + sum(r["launches"][k] for r in ranks)
                for k in SC_KERNELS}
    print(f"  sharded_cells: world 1 {t1 - t0:.1f} s, the gloo pair "
          f"{wall:.1f} s; launches (world-1 mesh runs and both ranks) "
          f"{launches}", flush=True)
    times = {k: ranks[0][k] for k in ("flash_fwd", "batched_mp",
                                      "batched_mp_bwd", "retrieval_score")}
    return dict(counts=launches, times=times, runs=ranks[0]["runs"],
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------- ferrari ----
FERRARI_ARCH = "ferrari-web"
FERRARI_NODES = 1 << 24        # ferrari-web's published n
FERRARI_SAMPLE = 1 << 16       # verdicts held against plain and the host DFS
FERRARI_POSITIVE = 1 << 15     # of them, pairs from forward walks (positive)
FERRARI_CELL_REPS = 10         # timed classify_16m steps
FERRARI_TENANTS = 8
FERRARI_REQUEST = 64           # query pairs a frontend request
FERRARI_PAIRS = 1 << 20        # random pairs through the frontend
FERRARI_HOST_SAMPLE = 2000     # frontend answers, beside every phase-2 one,
                               # held against the host DFS
FERRARI_LABEL = "stab_packed (ferrari classify_16m call)"
OWNED_LABEL = "stab_packed_owned (sharded classify_16m call, mesh 1x1)"


def _ferrari_graph(n: int, seed: int):
    from repro_torch.graphs.generators import scale_free_digraph
    return scale_free_digraph(n, 4.0, seed=seed, back_p=0.0)


def _spans(tracer) -> dict:
    """Seconds of each span name, summed."""
    out = collections.defaultdict(float)
    for e in tracer.events():
        out[e["name"]] += e["dur"]
    return out


def ferrari_spec():
    """ferrari-web's spec (``IndexSpec.from_config``, a condensed graph),
    built by the device builder: the host builder's sweep takes longer
    than this run may at n = 2^24 (a Python step a node)."""
    from repro_torch.configs import get_config
    from repro_torch.reach import IndexSpec
    return IndexSpec.from_config(get_config(FERRARI_ARCH), precondensed=True,
                                 builder="wavefront", cover_method="topgap")


def ferrari_build(dev, n: int, seed: int):
    """ferrari-web's graph at ``n`` nodes, its index through the port's
    entry point (``reach.build``: the device builder, kernel 5), packed at
    k_max 8 with its ELL layout; the stages' seconds from the tracer's
    spans. Returns (index, spec, packed, ell)."""
    from repro_torch import obs, reach
    from repro_torch.configs import get_config
    from repro_torch.core.packed import pack_index
    cfg = get_config(FERRARI_ARCH)
    spec = ferrari_spec()
    tracer = obs.enable_tracing()
    tracer.clear()
    try:
        with obs.span("smoke.graph", n=n):
            g = _ferrari_graph(n, seed)
        reset_counters()
        with obs.span("smoke.build"):
            ix = reach.build(g, spec, device=dev)
        build_counts = read_counters()
        with obs.span("smoke.pack", k_max=cfg.k_max):
            pk = pack_index(ix, k_max=cfg.k_max)
        with obs.span("smoke.ell_layout"):
            ell = pk.ell_layout(width=spec.ell_width)
        spans = _spans(tracer)
    finally:
        obs.enable_tracing(False)
        tracer.clear()
    parts = ("build.condense", "build.tree", "build.plan", "build.waves",
             "build.drain", "build.seeds")
    st = ix.stats
    print(f"ferrari: {FERRARI_ARCH} (k_max {cfg.k_max}, {cfg.seed_words} "
          f"seed word) over scale_free_digraph({n}, 4.0, back_p=0), "
          "condensed, reach.build (device builder)", flush=True)
    print(f"  graph {spans['smoke.graph']:.2f} s, build "
          f"{spans['smoke.build']:.2f} s (tracer spans, host clock): "
          + ", ".join(f"{p.split('.', 1)[1]} {spans[p]:.2f} s"
                      for p in parts)
          + f", labels and the rest "
          f"{spans['smoke.build'] - sum(spans[p] for p in parts):.2f} s; "
          f"pack {spans['smoke.pack']:.2f} s, ELL "
          f"{spans['smoke.ell_layout']:.2f} s; {st.hub_nodes} hub nodes, "
          f"{st.merge_rounds} merge rounds, {st.host_fallbacks} host "
          f"fallbacks, {st.total_intervals} intervals; kernel 5 launched "
          f"{build_counts['merge_cover']} times", flush=True)
    check(build_counts["merge_cover"] > 0,
          "ferrari: the build did not launch kernel 5")
    return ix, spec, pk, ell


def _instance(owner) -> str:
    """The registry's instance label of ``owner``'s stats view."""
    from repro_torch import obs
    labels = [c.labels["instance"] for c in obs.get_registry()._collectors
              if c.ref() is owner]
    check(len(labels) == 1, f"{type(owner).__name__} has {len(labels)} "
          "registry views, not 1")
    return labels[0]


def _scalars(obj) -> dict:
    from dataclasses import fields
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (bool, int, float)):
            out[f.name] = int(v) if isinstance(v, bool) else v
    return out


def hold_registry(fe, sess) -> None:
    """The registry's export holds ``reach_frontend``, ``reach_session``
    and ``reach_engine``, each sample equal to its stats object."""
    from repro_torch import obs
    snap = obs.metrics_snapshot()["stats"]
    n_keys = 0
    for prefix, owner, values in (
            ("reach_frontend", fe, fe._flat_stats()),
            ("reach_session", sess, _scalars(sess.stats)),
            ("reach_engine", sess.engine, _scalars(sess.engine.stats))):
        inst = _instance(owner)
        for key, v in values.items():
            got = [s["value"] for s in snap.get(f"{prefix}_{key}", [])
                   if s["labels"]["instance"] == inst]
            check(got == [v], f"registry {prefix}_{key} {got} != {v}")
            n_keys += 1
    print(f"  registry export: reach_frontend, reach_session, reach_engine "
          f"present, {n_keys} samples equal to their stats objects",
          flush=True)


def ferrari_phase(dev, rec, err, n: int, seed: int):
    """ferrari-web at ``n`` condensed nodes (the published 16,777,216
    unless cut for a quick check): the index (``ferrari_build``), a
    ``QuerySession`` over it; the classify_16m and classify_100k cells on
    its fused tables (kernel 1), held against the engine's classify,
    kernel 1's plain version on the CPU and the host DFS; then the async
    frontend over the session with tracing on (kernels 1, 3, 4)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.query import QueryEngine
    from repro_torch.core.workload import positive_queries
    from repro_torch.kernels import interval_stab as st
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_cell
    from repro_torch.reach import QuerySession
    from dataclasses import replace
    cfg = replace(get_config(FERRARI_ARCH), n_nodes=n)
    ix, spec, pk, ell = ferrari_build(dev, n, seed)
    t0 = time.perf_counter()
    sess = QuerySession(ix, spec, packed=pk, ell=ell, device=dev)
    load_s = time.perf_counter() - t0
    eng = sess.engine
    m_t, width = int(ell[1].shape[0]), int(ell[0].shape[1])
    chunk = eng._phase2_chunk_size(width, m_t)
    print(f"  index: {pk.n} nodes, k_max {pk.k_max}, fused layout "
          f"{'slab' in eng.dev}, ELL width {width}, COO tail m_t {m_t}, "
          f"max level {int(pk.blevel.max())}, π up to {int(pk.pi.max())} "
          f"(bit 23 set on {int((pk.pi >= 1 << 23).sum())} nodes), phase 2 "
          f"{eng.phase2_mode}, chunk {chunk} (key packing "
          f"{min(eng.phase2_chunk, 2 ** (31 - max(1, (n - 1).bit_length())) - 1)}); "
          f"session on the card in {load_s:.1f} s", flush=True)
    check(pk.n == n and "slab" in eng.dev and pk.k_max == cfg.k_max,
          "ferrari: the index must take the fused layout at k_max 8")
    check(np.array_equal(ix.cond.comp, np.arange(n)),
          "ferrari: a condensed graph's ids are its own")

    # ------------------------------------------------- the cell (kernel 1)
    state = {"slab": eng.dev["slab"], "meta": eng.dev["meta"]}
    cell = build_cell(cfg, "classify_16m", device=dev)
    small = build_cell(cfg, "classify_100k", device=dev)
    check({k: (tuple(v.shape), v.dtype) for k, v in state.items()}
          == cell.state_shapes, "ferrari: state shapes differ from the cell's")
    (q,), _ = cell.batch_shapes["cs"]
    (q_small,), _ = small.batch_shapes["cs"]
    rng = np.random.default_rng(seed + 22)
    qs = rng.integers(0, n, q).astype(np.int32)
    qt = rng.integers(0, n, q).astype(np.int32)
    ps, pt = positive_queries(ix.cond.dag, FERRARI_POSITIVE, seed=seed + 23)
    qs[:FERRARI_POSITIVE], qt[:FERRARI_POSITIVE] = ps, pt
    batch = {"cs": torch.from_numpy(qs).to(dev),
             "ct": torch.from_numpy(qt).to(dev)}
    reset_counters()
    rec.reset()
    fig = dry_predict("ferrari", cfg, "classify_16m")
    with DryrunHold("ferrari", fig, dev):         # the dry run's check
        _, verdict = cell.step(state, batch)
    _, v_small = small.step(state, {k: v[:q_small] for k, v in batch.items()})
    torch.cuda.synchronize()
    counts, calls = read_counters(), dict(rec.calls)
    check(counts["stab_packed"] == 2 and calls["stab_packed"][0] == q,
          f"ferrari: the cells launched kernel 1 {counts['stab_packed']} "
          "times, not 2")
    check(bool((v_small == verdict[:q_small]).all()),
          "ferrari: classify_100k differs from classify_16m's rows")
    walls = []
    for _ in range(FERRARI_CELL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell.step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    v_eng, _, _ = eng.classify(qs, qt)
    n_bad = int((v_eng != verdict).sum())
    mix = torch.bincount(verdict, minlength=3).tolist()
    print(f"  cell classify_16m: {q} queries, step {wall * 1e3:.3f} ms "
          f"(wall to a sync, median of {FERRARI_CELL_REPS}; "
          f"{q / wall:.4g} queries/s); NEG/POS/UNKNOWN {mix}; "
          f"classify_100k ({q_small}) = its first rows; the engine's "
          f"classify of the same ids: {n_bad} mismatches", flush=True)
    check(n_bad == 0, "ferrari: the cell's verdicts differ from the "
          "engine's classify")
    idx = np.concatenate([np.arange(FERRARI_POSITIVE), FERRARI_POSITIVE
                          + rng.choice(q - FERRARI_POSITIVE,
                                       FERRARI_SAMPLE - FERRARI_POSITIVE,
                                       replace=False)])
    v = verdict[torch.from_numpy(idx).to(dev)].cpu()
    t_idx = torch.from_numpy(idx)
    plain = st.stab_packed(state["meta"].cpu(), state["slab"].cpu(),
                           batch["cs"].cpu()[t_idx], batch["ct"].cpu()[t_idx])
    _tally(err, "stab_packed", _compare(
        f"stab_packed on the ferrari sample of {idx.size} (plain on the "
        "CPU)", v, plain))
    t0 = time.perf_counter()
    want = QueryEngine(ix).batch(qs[idx], qt[idx])
    dfs_s = time.perf_counter() - t0
    v = v.numpy()
    bad_pos = int(((v == ops.POS) & ~want).sum())
    bad_neg = int(((v == ops.NEG) & want).sum())
    print(f"  sample of {idx.size} ({FERRARI_POSITIVE} forward-walk pairs) "
          f"against the host DFS ({dfs_s:.1f} s): POS "
          f"{int((v == ops.POS).sum())}, "
          f"{bad_pos} not reachable; NEG {int((v == ops.NEG).sum())}, "
          f"{bad_neg} reachable; UNKNOWN {int((v == ops.UNKNOWN).sum())}",
          flush=True)
    check(bad_pos == 0 and bad_neg == 0,
          "ferrari: the sample's verdicts differ from the host DFS")
    dist_out = ferrari_distributed(dev, sess, cfg, state, batch, verdict,
                                   idx, err, seed)
    del v_eng, v_small, verdict
    fe_counts, fe_out = ferrari_frontend(sess, rec, err, rng, n, chunk,
                                         seed)
    return dict(counts=counts, frontend_counts=fe_counts,
                call=calls["stab_packed"], cell_ms=wall * 1e3, qps=q / wall,
                m_t=m_t, chunk=chunk, distributed=dist_out, **fe_out)


def ferrari_frontend(sess, rec, err, rng, n: int, chunk: int, seed: int):
    """``FERRARI_PAIRS`` random pairs through a ``Frontend`` on ``sess``
    (``FERRARI_TENANTS`` tenants, ``FERRARI_REQUEST``-pair requests, the
    spec's deadline), tracing on; one request in 16 holds forward-walk
    pairs, so positives are served too (random pairs over 2^24 nodes are
    all but never reachable). Every ticket's answers are held against
    ``sess.query`` on the same pairs, the trace's slab spans against the
    slabs, the registry's export against the stats objects. Kernels 3
    and 4 are held word for word against their plain versions on every
    step of the frontend's largest, smallest and first overflowing
    expansion calls, and every phase-2 answer (with a sample of the
    rest) against the host DFS."""
    from repro_torch import obs
    from repro_torch.core.workload import positive_queries
    from repro_torch.reach import Frontend, Rejected
    qs = rng.integers(0, n, FERRARI_PAIRS)
    qt = rng.integers(0, n, FERRARI_PAIRS)
    walks = (np.arange(FERRARI_PAIRS) // FERRARI_REQUEST) % 16 == 0
    qs[walks], qt[walks] = positive_queries(
        sess.index.cond.dag, int(walks.sum()), seed=seed + 24)
    tracer = obs.enable_tracing(capacity=1 << 20)
    tracer.clear()
    sess.reset_stats()
    reset_counters()
    rec.reset()
    fe = Frontend(sess)
    tickets, stalls = {}, 0
    t0 = time.perf_counter()
    for i, lo in enumerate(range(0, FERRARI_PAIRS, FERRARI_REQUEST)):
        hi = lo + FERRARI_REQUEST
        while True:
            try:
                tickets[fe.submit(f"tenant-{i % FERRARI_TENANTS}",
                                  qs[lo:hi], qt[lo:hi])] = lo
                break
            except Rejected as e:
                check(e.reason == "queue_full", f"frontend: {e}")
                stalls += 1
                fe.poll()
    got = fe.drain()
    dt = time.perf_counter() - t0
    obs.enable_tracing(False)
    counts = read_counters()
    calls = len(rec.expansions)
    st, ss = fe.stats, sess.stats
    print(f"  frontend: {FERRARI_PAIRS} pairs over {FERRARI_TENANTS} "
          f"tenants ({FERRARI_REQUEST}/request, deadline "
          f"{sess.spec.deadline_us} us) in {dt * 1e3:.1f} ms "
          f"({dt / FERRARI_PAIRS * 1e9:.0f} ns/pair, tracing on), {stalls} "
          f"backpressure stalls; {st.n_batches} slabs, occupancy "
          f"{st.occupancy:.3f}, flushes deadline/full/forced "
          f"{st.deadline_flushes}/{st.full_flushes}/{st.forced_flushes}, "
          f"{st.deadline_misses} deadline misses; occupancy histogram "
          f"{dict(sorted(st.occupancy_hist.items()))}", flush=True)
    for name in sorted(st.tenants):
        t = st.tenants[name]
        print(f"    {name}: {t.completed}/{t.requests} requests, p50 "
              f"{t.p50_us:.0f} us, p99 {t.p99_us:.0f} us, misses "
              f"{t.deadline_misses}", flush=True)
    c = st.cache
    print(f"    cache: hit rate {c['hit_rate']:.4f} ({c['hits']} hits, "
          f"{c['misses']} misses); phase 2: {ss.phase2_queries} queries "
          f"(sparse {ss.phase2_sparse}, host {ss.phase2_host}), {calls} "
          f"expansion calls of chunk {chunk}, {ss.sparse_retries} retries; "
          f"launches {counts}", flush=True)
    print("    " + fe.slowlog.format_report().replace("\n", "\n    "),
          flush=True)
    hold_registry(fe, sess)
    trace = BUILD_DIR / "ferrari_frontend_trace.json"
    obs.export_chrome_trace(str(trace))
    slabs = sum(1 for e in json.loads(trace.read_text())["traceEvents"]
                if e.get("ph") == "X" and e["name"] == "slab")
    print(f"  trace {trace.relative_to(ROOT)}: {len(tracer.events())} "
          f"spans, {tracer.n_dropped} dropped, {slabs} slab spans for "
          f"{st.n_batches} slabs (spans are host time)", flush=True)
    check(slabs == st.n_batches and tracer.n_dropped == 0,
          "frontend: one slab span a slab")
    tracer.clear()
    check(set(got) == set(tickets), "frontend: a ticket was not answered")
    hold_step_calls(rec, "ferrari frontend", err, {})
    want = sess.query(qs, qt)
    bad = sum(not np.array_equal(a, want[tickets[t]:
                                         tickets[t] + FERRARI_REQUEST])
              for t, a in got.items())
    print(f"  frontend answers vs sess.query on the same pairs: {bad} of "
          f"{len(got)} tickets differ ({int(want.sum())} positive)",
          flush=True)
    check(bad == 0, "frontend: answers differ from QuerySession.query")
    hold_to_host(sess.index, sess, qs, qt, want, FERRARI_HOST_SAMPLE,
                 "ferrari frontend")
    check(counts["stab_packed"] > 0, "frontend: kernel 1 not launched")
    if ss.phase2_sparse:
        check(counts["probe"] > 0 and counts["classify_emit"] > 0,
              "frontend: kernels 3 and 4 not launched")
    return counts, dict(frontend_s=dt, slabs=st.n_batches,
                        occupancy=st.occupancy)


# ------------------------------------------------------- distributed ----
DIST_PAIRS = 1 << 15           # random pairs through the sharded 1x1 session
DIST_HOLD_PAIRS = 1 << 12      # of them, served again with every step held
DIST_CELL_REPS = 10
GLOO_PAIRS = 1 << 17           # random pairs through the two gloo ranks
GLOO_POSITIVE = 1 << 14        # and forward-walk pairs (4M artifact)
GLOO_WEAK_PAIRS = 1 << 16      # random pairs (phase2's weak 1M artifact)
GLOO_WAVEFRONT = "the wavefront phase's 4M artifact"
GLOO_WEAK = "the phase2 phase's 1M k=1 artifact"
GLOO_TIMEOUT = 400             # seconds, each gloo rank

# One rank of the gloo pair that shares cuda:0: loads each artifact as a
# sharded 1x2 session, then as a replicated 2x1 one, and serves that
# artifact's pairs through each; every rank writes its answers, and its
# stats, launch counts and seconds.
GLOO_RANK = r"""
import json, sys, time
from dataclasses import replace
cfg = json.loads(sys.argv[1])
rank = int(sys.argv[2])
sys.path.insert(0, cfg["src"])
import numpy as np
import torch
import torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("gloo", rank=rank, world_size=2,
                        store=dist.FileStore(cfg["store"], 2))
from repro_torch.kernels import _lib
from repro_torch.kernels import frontier_fused as ff
from repro_torch.reach import IndexSpec, QuerySession, load_manifest
out = {}
for i, art in enumerate(cfg["artifacts"]):
    base = IndexSpec.from_dict(load_manifest(art["path"])["extra"]["spec"])
    pairs = np.load(art["pairs"])
    qs, qt = pairs["qs"], pairs["qt"]
    for placement, mesh in (("sharded", "1x2"), ("replicated", "2x1")):
        t0 = time.perf_counter()
        sess = QuerySession.load(art["path"], replace(
            base, placement=placement, mesh=mesh), device="cuda:0")
        load_s = time.perf_counter() - t0
        sess.query(qs[:base.max_batch], qt[:base.max_batch])   # warm up
        sess.reset_stats()
        _lib.LAUNCHES.reset()
        ff.STEPS.reset()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ans = sess.query(qs, qt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        st = sess.stats.as_dict()
        out[f"{i} {placement}"] = dict(
            mesh=mesh, seconds=seconds, load_s=load_s,
            stats={k: v for k, v in st.items() if isinstance(v, int)},
            launches=dict(_lib.LAUNCHES), steps=dict(ff.STEPS),
            mesh_of=repr(sess.engine.mesh))
        np.save(cfg["out"] % (rank, f"{i}_{placement}"), ans)
        del sess
        torch.cuda.empty_cache()
with open(cfg["out"] % (rank, "json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def gloo_artifact(label, sess, path, qs, qt, pairs_file,
                  phase2: bool) -> dict:
    """An artifact for the gloo pair: its pairs (saved to ``pairs_file``)
    and the one-device session's answers and phase mix on them.
    ``phase2``: the pairs must reach the sparse phase 2."""
    sess.reset_stats()
    want = sess.query(qs, qt)
    mix = {k: sess.stats.as_dict()[k] for k in PHASE_MIX}
    np.savez(pairs_file, qs=qs, qt=qt)
    return dict(label=label, path=str(path), pairs=str(pairs_file),
                want=want, mix=mix, phase2=phase2)


def gloo_phase(arts, work) -> dict:
    """Artifacts served by two gloo ranks that share cuda:0
    (subprocesses, a FileStore under ``work`` in ``build/``): a sharded
    1x2 and a replicated 2x1 ``QuerySession.load`` of each serve its
    pairs; every rank's answers must equal the one-device session's,
    with its phase mix. Returns the ranks' stats, launches and seconds
    by "artifact placement"."""
    cfg = {"src": str(SRC), "store": str(work / "store"),
           "artifacts": [{k: a[k] for k in ("path", "pairs")}
                         for a in arts],
           "out": str(work / "rank%d_%s")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_RANK, json.dumps(cfg), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=GLOO_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for r, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0,
              f"gloo rank {r} exited {proc.returncode}:\n{log[-4000:]}")
    ranks = [json.loads((work / f"rank{r}_json").read_text())
             for r in range(2)]
    out = {}
    for i, art in enumerate(arts):
        for placement in ("sharded", "replicated"):
            key = f"{i} {placement}"
            bad = [int((np.load(work / f"rank{r}_{i}_{placement}.npy")
                        != art["want"]).sum()) for r in range(2)]
            got = ranks[0][key]
            mix = {k: got["stats"][k] for k in PHASE_MIX}
            n = got["stats"]["n_queries"]
            print(f"  gloo {placement} {got['mesh']}, {art['label']} (two "
                  f"ranks sharing cuda:0; {got['mesh_of']}): {n} pairs in "
                  f"{got['seconds'] * 1e3:.1f} ms "
                  f"({got['seconds'] / n * 1e9:.0f} ns/query), load "
                  f"{got['load_s']:.1f} s; answers against the one-device "
                  f"session: {bad[0]} / {bad[1]} differ (rank 0 / 1); mix "
                  f"{mix}; launches {got['launches']}; sparse "
                  f"{got['steps']}", flush=True)
            check(bad == [0, 0], f"gloo {placement}, {art['label']}: "
                  "answers differ from the one-device session's")
            check(mix == art["mix"]
                  and ranks[1][key]["stats"] == got["stats"],
                  f"gloo {placement}, {art['label']}: phase mix differs")
            own = placement == "sharded"
            check((got["launches"]["stab_packed_owned"] > 0) == own
                  and (got["launches"]["stab_packed"] > 0) != own,
                  f"gloo {placement}: phase 1 did not take its kernel")
            if art["phase2"]:
                check(got["stats"]["phase2_sparse"] > 0 and got["launches"][
                      "probe_rows" if own else "probe"] > 0,
                      f"gloo {placement}, {art['label']}: kernel 3 not "
                      "launched")
            out[f"{art['label']} {placement}"] = got
    print(f"  gloo pair: {wall:.1f} s for both processes (start, "
          f"{2 * len(arts)} loads and warm-ups each, serving)", flush=True)
    return out


PHASE_MIX = ("n_queries", "n_positive", "phase1_pos", "phase1_neg",
             "phase2_queries", "phase2_sparse", "phase2_host")


class RowsHolder:
    """Wraps ``frontier_fused.expand_probe`` while a sharded session
    serves: each launch of kernel 3's exchanged-rows entry is held word for
    word against its plain version on a copy of the state taken before it
    (``err``), and the step of most swept pairs is kept (state before, the
    tables and its exchanged rows) for timing."""

    def __init__(self, err):
        from repro_torch.kernels import frontier_fused as ff
        self.ff, self.err, self.kept, self.held = ff, err, {}, 0
        self.orig = ff.expand_probe
        ff.expand_probe = self.wrapped

    def wrapped(self, st, tables, *, gather_rows=None, n_front=None):
        ff = self.ff
        if gather_rows is None or gather_rows is ff._take \
                or st.device.type != "cuda":
            return self.orig(st, tables, gather_rows=gather_rows or ff._take,
                             n_front=n_front)
        before = st.clone()
        self.orig(st, tables, gather_rows=gather_rows, n_front=n_front)
        rows = ff.front_rows(before, tables["ell"], n_front, gather_rows)
        want = before.clone()
        ff.expand_probe_rows_plain(want, rows, tables["tail_src"],
                                   tables["tail_dst"])
        _tally(self.err, "probe_rows", _compare(
            f"probe_rows step {self.held} (front {n_front}, raw "
            f"{int(want.ctl[ff.RAW])}, hub {int(before.ctl[ff.HUB])})",
            _state_words(st, True), _state_words(want, True)))
        self.held += 1
        swept = _swept(before)
        if swept > self.kept.get("rows", -1):
            self.kept = dict(rows=swept, state=before, tables=tables,
                             exchanged=rows)

    def close(self):
        self.ff.expand_probe = self.orig


def time_probe_rows(kept) -> dict:
    """Kernel 3's exchanged-rows entry on the kept step: cold and warm
    beside the in-place kernel on the same step (at mesh 1x1 the rank's
    ELL is the whole slab), its plain version, the bound
    (``probe_work`` with the exchanged rows) and the launch floor."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import frontier_fused as ff
    st, tables, rows = kept["state"], kept["tables"], kept["exchanged"]
    nbytes, _ = probe_work(st, tables, rows=rows)
    ops = 10 * _candidates(st, tables)
    runs = {}
    for name, extra in (("rows", dict(rows=rows.data_ptr())),
                        ("in place", {})):
        probe_st = st.clone()
        args = probe_st.args(tables, **extra)
        entry = "reach_expand_probe_rows" if extra else "reach_expand_probe"

        def prep(t=probe_st):
            t.state[ff.TILE].zero_()
            t.state[ff.EPOCH].add_(1)

        def kernel(a=args, e=entry, t=probe_st):
            _lib.launch(None, e, t.device, ctypes.addressof(a))
        runs[name] = (device_ms(kernel, prep=prep),
                      device_ms(kernel, cold=False, prep=prep))
    plain_st = st.clone()
    plain_ms = device_ms(lambda: ff.expand_probe_rows_plain(
        plain_st, rows, tables["tail_src"], tables["tail_dst"]), reps=3)
    swept = _swept(st)
    floor = launch_floor(max(swept, 1))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    (ms, warm_ms), (in_ms, in_warm) = runs["rows"], runs["in place"]
    out = dict(rows=swept, ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
               library=None, library_ms=None, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, ops=ops, err=(0, 0, 0.0), floor_ms=floor[0],
               floor_warm_ms=floor[1], in_place_ms=in_ms,
               in_place_warm_ms=in_warm)
    print(f"  time probe_rows (the sharded session's step of {swept} swept "
          f"pairs, front {int(st.ctl[ff.N_FRONT])}, hub "
          f"{int(st.ctl[ff.HUB])}, cap {st.cap}): kernel {ms:.6f} ms (L2 "
          f"cold; {warm_ms:.6f} warm), the in-place kernel 3 on the same "
          f"step {in_ms:.6f} ms ({in_warm:.6f} warm), plain {plain_ms:.4f} "
          f"ms, launch floor {floor[0]:.6f} ms cold, bound "
          f"{out['bound_ms']:.7f} ms ({nbytes} B, {ops} ops; "
          f"{out['bound_by']})", flush=True)
    torch.cuda.synchronize()
    return out


def ferrari_distributed(dev, sess, cfg, state, batch, verdict, idx, err,
                        seed: int) -> dict:
    """World 1 over NCCL on ferrari-web's index (mesh 1x1, a FileStore under
    ``build/``): the classify_16m cell's sharded step (kernel 1's owned-rows
    entry) against the replicated cell's verdicts, timed; a sharded
    ``QuerySession`` over the same index serving random pairs, its phase 2
    stepped from the host (kernel 3's exchanged-rows entry, kernel 4 as
    mark and emit), against the one-device session's answers and phase mix;
    then the owned entry on a sample against its plain version, the first
    pairs again with every exchanged-rows step held. Returns the counts of
    the cell and the session (set to 0 just before, read just after) and
    the calls kept for timing."""
    import torch
    import torch.distributed as dist

    from dataclasses import replace

    from repro_torch.core.distributed import ServingMesh
    from repro_torch.kernels import frontier_fused as ff
    from repro_torch.kernels import interval_stab as st
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_cell
    from repro_torch.reach import QuerySession
    t_part = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(work / "store"), 1))
    owned_calls = []
    owned = ops.stab_packed_owned

    def recorded(*args):
        if args[3].shape[0] > (owned_calls[0][0] if owned_calls else -1):
            owned_calls[:] = [(args[3].shape[0], args)]
        return owned(*args)
    try:
        mesh = ServingMesh("sharded", (1, 1), dev)
        cell = build_cell(cfg, "classify_16m", mesh=mesh)
        # rank 0 of 1 holds every row: its shard is the replicated state
        check({k: (tuple(v.shape), v.dtype) for k, v in state.items()}
              == cell.state_shapes, "distributed: the 1x1 shard's shapes")
        eng = sess.engine
        spec = replace(sess.spec, placement="sharded", mesh="1x1")
        t0 = time.perf_counter()
        dsess = QuerySession(sess.index, spec, packed=eng.packed,
                             ell=eng._ell_host, device=dev)
        dsess.engine._ell()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 25)
        n = eng.packed.n
        qs, qt = rng.integers(0, n, DIST_PAIRS), rng.integers(0, n, DIST_PAIRS)
        sess.reset_stats()
        want = sess.query(qs, qt)
        want_st = sess.stats.as_dict()
        dsess.warmup(DIST_PAIRS)
        ops.stab_packed_owned = recorded
        reset_counters()
        _, v_sh = cell.step(state, batch)
        torch.cuda.synchronize()
        cell_counts = read_counters()
        dsess.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dsess.query(qs, qt)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counters()
        ops.stab_packed_owned = owned
        n_bad = int((v_sh != verdict).sum())
        walls = []
        for _ in range(DIST_CELL_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cell.step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        print(f"distributed: world 1 over NCCL ({mesh}), ferrari-web's "
              f"index ({n} nodes); the sharded session built in "
              f"{load_s:.1f} s", flush=True)
        print(f"  cell classify_16m sharded: step {wall * 1e3:.3f} ms (wall "
              f"to a sync, median of {DIST_CELL_REPS}; "
              f"{verdict.shape[0] / wall:.4g} queries/s); against the "
              f"replicated cell's verdicts: {n_bad} mismatches; launches "
              f"owned {cell_counts['stab_packed_owned']}, in place "
              f"{cell_counts['stab_packed']}", flush=True)
        check(n_bad == 0, "distributed: the sharded cell's verdicts differ")
        check(cell_counts["stab_packed_owned"] == 1
              and cell_counts["stab_packed"] == 0,
              "distributed: the sharded cell did not take the owned entry")
        ss = dsess.stats.as_dict()
        mix = {k: ss[k] for k in PHASE_MIX}
        d_bad = int((got != want).sum())
        steps = counts["sparse_steps"]
        print(f"  sharded session (1x1, stepped from the host): {qs.size} "
              f"random pairs in {dt * 1e3:.1f} ms ({dt / qs.size * 1e9:.0f} "
              f"ns/query), {int(got.sum())} positive; mix {mix}, retries "
              f"{ss['sparse_retries']} (one device: "
              f"{want_st['sparse_retries']}); steps / syncs / launches "
              f"{steps} / {counts['sparse_syncs']} / "
              f"{counts['sparse_launches']} "
              f"({counts['sparse_syncs'] / max(steps, 1):.2f} syncs a step); "
              f"launches owned {counts['stab_packed_owned']}, rows "
              f"{counts['probe_rows']}, kernel 4 {counts['classify_emit']}; "
              f"against the one-device session: {d_bad} answers differ",
              flush=True)
        check(d_bad == 0 and mix == {k: want_st[k] for k in PHASE_MIX},
              "distributed: the sharded session differs from the one-device"
              " session")
        check(counts["stab_packed_owned"] > 0 and counts["stab_packed"] == 0,
              "distributed: phase 1 did not take the owned entry")
        if ss["phase2_sparse"]:
            check(counts["probe_rows"] > 0 and counts["probe"] == 0
                  and counts["classify_emit"] > 0,
                  "distributed: phase 2 did not take the exchanged rows")
        # the owned entry on the sample against its plain version (CPU)
        rows, args = owned_calls[0]
        meta_t, meta, slab, cs, ct, base = args
        t_idx = torch.from_numpy(idx)
        sample = st.stab_packed_owned(meta_t[t_idx.to(dev)].contiguous(),
                                      meta, slab, cs[t_idx.to(dev)],
                                      ct[t_idx.to(dev)], base).cpu()
        _tally(err, "stab_packed_owned", _compare(
            f"stab_packed_owned on the ferrari sample of {idx.size} (plain "
            "on the CPU)", sample, st.stab_packed_owned_plain(
                meta_t.cpu()[t_idx], meta.cpu(), slab.cpu(), cs.cpu()[t_idx],
                ct.cpu()[t_idx], base)))
        holder = RowsHolder(err)
        try:
            again = dsess.query(qs[:DIST_HOLD_PAIRS], qt[:DIST_HOLD_PAIRS])
        finally:
            holder.close()
        print(f"  probe_rows held on {holder.held} steps ({DIST_HOLD_PAIRS} "
              f"pairs served again); the distributed part took "
              f"{time.perf_counter() - t_part:.1f} s", flush=True)
        check(np.array_equal(again, got[:DIST_HOLD_PAIRS]),
              "distributed: the held run's answers differ")
        return dict(counts=counts, cell_ms=wall * 1e3,
                    ns_per_query=dt / qs.size * 1e9,
                    owned_call=(rows, args), rows_kept=holder.kept,
                    cell_owned=cell_counts["stab_packed_owned"])
    finally:
        ops.stab_packed_owned = owned
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the model phases' data and weights")
    parser.add_argument("--ferrari-only", action="store_true",
                        help="build the kernels and run the ferrari phase "
                             "alone (a quick check; no result lines)")
    parser.add_argument("--ferrari-nodes", type=int, default=FERRARI_NODES,
                        help="with --ferrari-only: the ferrari phase's "
                             "graph (default: ferrari-web's published "
                             "16,777,216 nodes)")
    parser.add_argument("--moe-only", action="store_true",
                        help="build the kernels and run the moe phase "
                             "alone (a quick check; no result lines)")
    parser.add_argument("--moe-train-only", action="store_true",
                        help="build the kernels and run the moe_train "
                             "phase alone (a quick check; no result "
                             "lines)")
    parser.add_argument("--sharded-train-only", action="store_true",
                        help="build the kernels and run the sharded_train "
                             "phase alone (a quick check; no result "
                             "lines)")
    parser.add_argument("--sharded-cells-only", action="store_true",
                        help="build the kernels and run the sharded_cells "
                             "phase alone (a quick check; no result "
                             "lines)")
    parser.add_argument("--dryrun-only", action="store_true",
                        help="build the kernels and run the dry run's "
                             "check alone: its five cells predicted on "
                             "meta, then one real step each (no result "
                             "lines)")
    args = parser.parse_args()
    if args.ferrari_nodes != FERRARI_NODES and not args.ferrari_only:
        parser.error("--ferrari-nodes cuts the ferrari phase's width: "
                     "only with --ferrari-only")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return run(args, time.perf_counter())


# ------------------------------------------------------------ dryrun ----
# The dry run's check: ``launch.dryrun`` at --mesh none (meta tensors, on
# the host) at a phase's own cut, before one real step of the same cell
# on the card. Each kernel's launches must equal the prediction, and the
# aten FLOPs ``dryrun.flop_counter()`` counts over the real step the
# predicted ones (both checked); the peak is held within DRYRUN_PEAK_SHARE
# of the card's, or DRYRUN_PEAK_FLOOR where that is larger, and a miss is
# printed and recorded, not fatal. The card's peak of the step is what
# its arguments hold (the prediction's) plus what
# ``max_memory_allocated`` rose above the memory allocated before it.
DRYRUN_PEAK_SHARE = 0.10
DRYRUN_PEAK_FLOOR = 256 << 20
DRYRUN = {}          # label -> the predicted and measured figures
# the five cells at the phases' cuts: (label, arch, shape, shape cut)
DRYRUN_CELLS = (
    ("train", TRAIN_ARCH, "train_4k", dict(batch=TRAIN_BATCH)),
    ("lm", LM_ARCH, "prefill_32k", dict(batch=1)),
    ("gnn_train", "gin-tu", "molecule", dict(batch_graphs=GNN_BULK_GRAPHS)),
    ("recsys", "mind", "retrieval_cand", {}),
    ("ferrari", FERRARI_ARCH, "classify_16m", {}))


def dry_predict(phase: str, cfg, shape_name: str, shape=None) -> dict:
    """The dry run of ``cfg``'s cell ``shape_name`` (cut to ``shape``) on
    one device: its figures (``dryrun.measure``), with its seconds."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    _, fig = dryrun.dry_cell(cfg, shape_name, "none", shape_override=shape)
    fig["seconds"] = time.perf_counter() - t0
    cut = next(c[3] for c in DRYRUN_CELLS if c[0] == phase)
    fig["label"] = f"{cfg.arch_id} {shape_name}" + "".join(
        f", {k} {v}" for k, v in cut.items())
    return fig


class DryrunHold:
    """Around one real step of the cell ``fig`` predicted (``with
    DryrunHold(phase, fig, dev): step``): the kernels' launches in it,
    ``dryrun.flop_counter()`` over it, and the peak device memory it
    reached, held against the prediction (the section's comment)."""

    def __init__(self, phase: str, fig: dict, dev):
        self.phase, self.fig, self.dev = phase, fig, dev

    def __enter__(self):
        import torch

        from repro_torch.kernels import _lib
        from repro_torch.launch import dryrun
        torch.cuda.synchronize(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.before = torch.cuda.memory_allocated(self.dev)
        self.launches = dict(_lib.LAUNCHES)
        self.fc = dryrun.flop_counter()
        self.fc.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, kind, value, tb):
        import torch

        from repro_torch.kernels import _lib
        self.fc.__exit__(kind, value, tb)
        if kind is not None:
            return False
        torch.cuda.synchronize(self.dev)
        seconds = time.perf_counter() - self.t0
        fig, mem = self.fig, self.fig["memory"]
        launches = {k: v - self.launches[k] for k, v in _lib.LAUNCHES.items()
                    if v != self.launches[k]}
        want = {k: v["launches"] for k, v in fig["kernels"].items()}
        aten = int(self.fc.get_total_flops())
        temp = torch.cuda.max_memory_allocated(self.dev) - self.before
        live = mem["peak_bytes"] - mem["temp_bytes"]
        peak = live + temp
        tol = max(DRYRUN_PEAK_SHARE * peak, DRYRUN_PEAK_FLOOR)
        met = abs(mem["peak_bytes"] - peak) <= tol
        DRYRUN[self.phase] = dict(
            cell=fig["label"], launches=launches, launches_predicted=want,
            aten_flops=aten, aten_flops_predicted=fig["aten_flops"],
            kernel_flops_predicted={k: v["flops"]
                                    for k, v in fig["kernels"].items()},
            peak_bytes=peak, peak_bytes_predicted=mem["peak_bytes"],
            temp_bytes=temp, temp_bytes_predicted=mem["temp_bytes"],
            argument_bytes_predicted=mem["argument_bytes"],
            peak_met=met, predict_s=fig["seconds"], step_s=seconds)
        print(f"  dryrun {fig['label']} ({self.phase} phase; predicted on "
              f"meta in {fig['seconds']:.2f} s, the real step under the "
              f"FLOP counter {seconds:.2f} s): launches predicted {want}, "
              f"measured {launches}; aten FLOPs predicted "
              f"{fig['aten_flops']}, measured {aten}; peak predicted "
              f"{mem['peak_bytes'] / 1e9:.3f} GB (arguments "
              f"{mem['argument_bytes'] / 1e9:.3f}, temporaries "
              f"{mem['temp_bytes'] / 1e9:.3f}), measured "
              f"{peak / 1e9:.3f} GB (temporaries {temp / 1e9:.3f}): "
              f"{'met' if met else 'MISS'} (within "
              f"{tol / 1e9:.3f} GB)", flush=True)
        check(launches == want, f"dryrun {fig['label']}: launches "
              f"{launches}, predicted {want}")
        check(aten == fig["aten_flops"], f"dryrun {fig['label']}: aten "
              f"FLOPs {aten}, predicted {fig['aten_flops']}")
        return False


def dryrun_phase(dev, seed: int) -> None:
    """``--dryrun-only``: the five cells of the dry run's check at the
    phases' cuts, each predicted and then stepped once on the card under
    ``DryrunHold`` after a warm-up step; ferrari-web's tables are random
    int32 of the published n (the kernel's launches and the memory do not
    depend on their values)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import shapes_for_family
    from repro_torch.launch.train import Trainer
    from repro_torch.models import api
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for phase, arch, shape_name, cut in DRYRUN_CELLS:
        cfg = get_config(arch)
        shp = dataclasses.replace(shapes_for_family(cfg.family)[shape_name],
                                  **cut)
        fig = dry_predict(phase, cfg, shape_name, shp)
        if phase == "train":
            tr = Trainer(arch, smoke=False, batch_override=cut["batch"],
                         seed=seed, device=dev)
            tr.run(1)
            with DryrunHold(phase, fig, dev):
                tr.run(2)
            del tr
            torch.cuda.empty_cache()
            continue
        cell = api.build_cell(cfg, shape_name, device=dev,
                              shape_override=shp)
        if cfg.family == "ferrari":
            state = {k: torch.randint(0, 1 << 30, s, generator=gen,
                                      device=dev, dtype=d)
                     for k, (s, d) in cell.state_shapes.items()}
        else:
            state = api.materialize_state(cell, cfg, shape_name, gen)
        if cfg.family == "gnn":
            batch = _card_batch(cell, shp.n_classes, gen, dev)
        else:
            top = {"lm": getattr(cfg, "vocab", 0),
                   "recsys": getattr(cfg, "n_items", 0),
                   "ferrari": getattr(cfg, "n_nodes", 0)}[cfg.family]
            batch = {k: (torch.ones(s, device=dev) if k == "hist_mask" else
                         torch.randint(0, top, s, generator=gen, device=dev,
                                       dtype=d))
                     for k, (s, d) in cell.batch_shapes.items()}
        state, _ = cell.step(state, batch)          # warm up
        del _
        with DryrunHold(phase, fig, dev):
            out = cell.step(state, batch)
        del cell, state, batch, out
        torch.cuda.empty_cache()


def dryrun_line() -> str:
    """The dry run's check, one JSON object: per phase, the predicted and
    measured launches, aten FLOPs and peak."""
    return json.dumps({"dryrun": DRYRUN})


def run_ferrari(dev, err: dict, n: int, seed: int) -> dict:
    """The ferrari phase (``ferrari_phase``) with a recorder of its own,
    then kernel 1 timed at its classify_16m call; its counts, rates and
    that time (``"time"``, its parity tallied into ``err``)."""
    rec = Recorder()
    try:
        out = ferrari_phase(dev, rec, err, n, seed)
        dist_out = out["distributed"]
        times = time_kernels({}, extra=(
            ("stab_packed", FERRARI_LABEL, out.pop("call")),
            ("stab_packed_owned", OWNED_LABEL,
             dist_out.pop("owned_call"))))
        check(bool(dist_out["rows_kept"]),
              "distributed: no step of kernel 3's exchanged-rows entry")
        out["time_rows"] = time_probe_rows(dist_out.pop("rows_kept"))
    finally:
        rec.close()
    out["time"] = times[FERRARI_LABEL]
    out["time_owned"] = times[OWNED_LABEL]
    _tally(err, "stab_packed", out["time"]["err"])
    _tally(err, "stab_packed_owned", out["time_owned"]["err"])
    return out


def run(args, t_start: float) -> int:
    """Every phase after the kernels' build, then the result lines."""
    import torch

    from repro_torch.core.workload import positive_queries
    from repro_torch.kernels import _lib
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {kind}", flush=True)
    # the plain versions and the models' einsums in true float32: no TF32
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run at 'highest' precision (no TF32)")

    print("build:", flush=True)
    t0 = time.perf_counter()
    _lib.LIBRARY.get()
    print(f"  {_lib.LIBRARY.path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_lib.LIBRARY.build_seconds})", flush=True)
    for line in _lib.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    def done(phase):
        print(f"  [{phase} done at {time.perf_counter() - t_start:.0f} s]",
              flush=True)

    if args.ferrari_only:
        err = {name: (0, 0, 0.0) for name in KERNELS}
        run_ferrari(dev, err, args.ferrari_nodes, args.seed)
        done("ferrari")
        print("kernels: " + ", ".join(f"{k} {v[1]} mismatches"
                                      for k, v in err.items()), flush=True)
        check(all(v[1] == 0 for v in err.values()), "ferrari: mismatches")
        print(card_line(), flush=True)
        return 0

    if args.moe_only:
        moe_phase(dev, args.seed)
        done("moe")
        print(card_line(), flush=True)
        return 0

    if args.moe_train_only:
        moe_train_phase(dev, args.seed)
        done("moe_train")
        print(card_line(), flush=True)
        return 0

    if args.sharded_train_only:
        sharded_train_phase(dev, args.seed)
        done("sharded_train")
        print(card_line(), flush=True)
        return 0

    if args.sharded_cells_only:
        sharded_cells_phase(dev, args.seed)
        done("sharded_cells")
        print(card_line(), flush=True)
        return 0

    if args.dryrun_only:
        dryrun_phase(dev, args.seed)
        done("dryrun")
        print(dryrun_line(), flush=True)
        print(card_line(), flush=True)
        return 0

    print("parity (kernel vs plain; integer kernels bit for bit):",
          flush=True)
    err, stab_calls = kernel_parity(dev)
    done("parity")
    rec = Recorder()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))   # the 4M artifact
    gloo_work = Path(tempfile.mkdtemp(dir=BUILD_DIR))  # the gloo pair's
    try:
        main_counts, main_calls, main_out = main_phase(dev, rec)
        hold_stab_calls(rec, "main", err)
        done("main")
        wf_counts, wf_call, wf_out = wavefront_phase(dev, rec, main_out,
                                                     work)
        hold_stab_calls(rec, "wavefront (loaded index)", err)
        del main_out
        done("wavefront")
        # the 4M artifact for the gloo pair, before churn logs to it
        shutil.copytree(work, gloo_work / "wavefront")
        g4 = wf_out["g"]
        rng = np.random.default_rng(args.seed + 31)
        ps, pt = positive_queries(g4, GLOO_POSITIVE, seed=args.seed + 32)
        gloo_arts = [gloo_artifact(
            GLOO_WAVEFRONT, wf_out["session"], gloo_work / "wavefront",
            np.concatenate([rng.integers(0, g4.n, GLOO_PAIRS), ps]),
            np.concatenate([rng.integers(0, g4.n, GLOO_PAIRS), pt]),
            gloo_work / "pairs_wavefront.npz", False)]
        del g4, ps, pt
        churn_counts, churn_kept = churn_phase(dev, rec, err, wf_out)
        del wf_out
        done("churn")
        shutil.rmtree(work)
        p2_counts, p2_calls, p2_kept, weak = phase2_phase(dev, rec, err,
                                                          gloo_work)
        hold_stab_calls(rec, "phase2 (cap 256)", err)
        gloo_out = gloo_phase(gloo_arts + [weak], gloo_work)
        shutil.rmtree(gloo_work)
        done("distributed (gloo pair)")
        s64_counts, s64_calls = seeds64_phase(dev, rec, err)
        hold_stab_calls(rec, "seeds64", err)
        dense_counts, dense_calls = dense_phase(dev, rec)
        hold_stab_calls(rec, "dense", err)
        done("phase2, seeds64, dense")
        rs_counts, rs_calls = recsys_phase(dev, rec, args.seed)
        gnn_counts, gnn_calls = gnn_phase(dev, rec, args.seed)
        done("recsys, gnn")
        rec.close()
        gnn_train_counts, mp_bwd_call = gnn_train_phase(dev, args.seed, err)
        done("gnn_train")
        rs_train_counts = recsys_train_phase(dev, args.seed)
        done("recsys_train")
        reach_counts = reach_service_phase(dev, args.seed)
        done("reach_service")
        lm_counts, lm_time = lm_phase(dev, args.seed)
        done("lm")
        moe = moe_phase(dev, args.seed)
        done("moe")
        train_counts, train_time = train_phase(dev, args.seed)
        done("train")
        moe_train = moe_train_phase(dev, args.seed)
        done("moe_train")
        sharded = sharded_train_phase(dev, args.seed)
        done("sharded_train")
        cells = sharded_cells_phase(dev, args.seed)
        done("sharded_cells")
    finally:
        rec.close()
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(gloo_work, ignore_errors=True)
    phase_counts = {"main": main_counts, "wavefront": wf_counts,
                    "phase2": p2_counts, "seeds64": s64_counts,
                    "dense": dense_counts, "recsys": rs_counts,
                    "gnn": gnn_counts, "lm": lm_counts,
                    "moe": moe["moonshot"]["counts"],
                    "moe_train": {k: sum(moe_train[a]["counts"][k]
                                         for a, _ in MOE_TRAIN)
                                  for k in train_counts},
                    "train": train_counts, "gnn_train": gnn_train_counts,
                    "sharded_train": sharded["counts"],
                    "sharded_cells": cells["counts"],
                    "recsys_train": rs_train_counts,
                    "reach_service": reach_counts}
    for kname, meta in KERNELS.items():
        if meta["phase"] == "distributed":
            continue                      # on the ferrari index, below
        for phase in (meta["phase"], *meta.get("also", ())):
            n = phase_counts[phase][kname]
            print(f"  launches {kname} on its phase ({phase}): {n}",
                  flush=True)
            check(n > 0, f"{kname} was not launched on the {phase} phase")
    check(dense_counts["stab_packed"] > 0, "dense: kernel 1 not launched")
    print(f"  launches on the churn phase (4 batches served, then "
          f"compact): {churn_counts}", flush=True)
    check(all(churn_counts[k] > 0 for k in ("stab_packed", "probe",
                                            "classify_emit", "merge_cover")),
          "churn: a kernel of the live-update path was not launched")
    check(wf_counts["stab_packed"] > 0, "wavefront: the loaded index did "
          "not serve through kernel 1")
    print(f"  sparse steps/syncs/launches on phase2: "
          f"{p2_counts['sparse_steps']}/{p2_counts['sparse_syncs']}/"
          f"{p2_counts['sparse_launches']} (one graph a call: a sync a "
          "call, kernels 3 and 4 once a step)", flush=True)

    print("times (CUDA events, the path's own inputs):", flush=True)
    recorded = {"stab_packed": main_calls["stab_packed"],
                "stab_naive": s64_calls["stab_naive"],
                "merge_cover": wf_call,
                "retrieval_score": rs_calls["retrieval_score"],
                "batched_mp": gnn_calls["largest"]["batched_mp"],
                "batched_mp_bwd": mp_bwd_call}
    # kernel 9 also at its smallest call, and at every other shape the gnn
    # phase called it with
    largest = recorded["batched_mp"][1]
    smallest = gnn_calls["smallest"]["batched_mp"]
    times = time_kernels(recorded, extra=(
        *((name, f"{name} (2^20 parity call, K {k}"
           f"{', W 2' if name == 'stab_naive' else ''})", call)
          for (name, k), call in sorted(stab_calls.items())),
        ("stab_packed", "stab_packed (dense phase's largest call)",
         dense_calls["stab_packed"]),
        ("batched_mp", "batched_mp (smallest call)", smallest),
        *(("batched_mp", f"batched_mp (B={b} N={n} F={f} H={h})", call)
          for (b, n, f, h), call in sorted(gnn_calls["mp_shapes"].items())
          if call[1] is not largest and call[1] is not smallest[1])))
    times.update(time_step_kernels(p2_kept))
    overlay_times = time_step_kernels(churn_kept)
    times["flash_fwd"] = lm_time          # timed in the lm phase
    train_fwd = train_time.pop("flash_fwd")
    moe_fwd = {"at_moonshot_call": moe["moonshot"]["timing"],
               "at_phi35_call": moe["phi"]["timing"]}
    tp_call = sharded["tp_call"]          # rank 0 of the gloo pair, 1x2
    sc_times = cells["times"]             # rank 0 of the gloo pair
    for t in (train_fwd, *moe_fwd.values(), tp_call["flash_fwd"],
              sc_times["flash_fwd"]):
        # each held against plain
        a, b = lm_time["err"], t["err"]
        lm_time["err"] = (max(a[0], b[0]), a[1] + b[1], max(a[2], b[2]))
    bwd_hd128 = train_time.pop("hd128")
    moe_bwd = {f"at_{MOE_AT[a]}_train_call": moe_train[a]["timing"]
               for a, _ in MOE_TRAIN}
    tp_bwd = {k: tp_call[k] for k in ("flash_bwd_dq", "flash_bwd_dkv")}
    for at in (bwd_hd128, *moe_bwd.values(), tp_bwd):  # held against plain
        for kname, t in at.items():
            a, b = train_time[kname]["err"], t["err"]
            train_time[kname]["err"] = (max(a[0], b[0]), a[1] + b[1],
                                        max(a[2], b[2]))
    times.update(train_time)              # kernels 7 and 8: the train phase
    for kname in ("batched_mp", "batched_mp_bwd", "retrieval_score"):
        _tally(err, kname, tuple(sc_times[kname]["err"]))
    # every other phase is done and timed: let go of the inputs kept for
    # the timings and of the allocator's cache before the ferrari phase
    # (its device build peaks near 40 GB)
    del (rec, recorded, largest, smallest, stab_calls, main_calls, wf_call,
         p2_calls, p2_kept, s64_calls, dense_calls, rs_calls, gnn_calls,
         churn_kept, mp_bwd_call)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  left on the card here before the ferrari phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved",
          flush=True)
    fr = run_ferrari(dev, err, FERRARI_NODES, args.seed)
    done("ferrari")
    fr_counts, fe_counts = fr["counts"], fr["frontend_counts"]
    phase_counts["distributed"] = fr["distributed"]["counts"]
    for kname in ("stab_packed_owned", "probe_rows"):
        n = phase_counts["distributed"][kname]
        print(f"  launches {kname} on its phase (distributed, world 1 on "
              f"the ferrari index): {n}", flush=True)
        check(n > 0, f"{kname} was not launched on the distributed phase")
    times["stab_packed_owned"] = fr["time_owned"]
    times["probe_rows"] = fr["time_rows"]
    print(f"  launches on the ferrari phase: cells {fr_counts}; frontend "
          f"{fe_counts}", flush=True)
    check(fr_counts["stab_packed"] == 2 and fe_counts["stab_packed"] > 0,
          "ferrari: kernel 1 was not launched by the cells and the frontend")
    times[FERRARI_LABEL] = fr["time"]
    if times["batched_mp"]["route"] == "tiled":
        KERNELS["batched_mp"]["source"] = "src/repro_torch/csrc/batched_mp.cu"
    rows = []
    for kname, meta in KERNELS.items():
        t = times[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            **({"call": meta["call"]} if "call" in meta else {}),
            "launches": phase_counts[meta["phase"]][kname],
            "max_abs_err": max(err[kname][0], t["err"][0]),
            "max_rel_err": max(err[kname][2], t["err"][2]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            **{key: t[key] for key in ("plain_at", "ms_at_plain_shape",
                                       "library_expanded_ms", "warm_ms",
                                       "floor_ms", "floor_warm_ms",
                                       "at_once_ms", "in_place_ms",
                                       "in_place_warm_ms")
               if key in t}})
        if meta["phase"] == "distributed":
            # the same entry in the gloo pair's sharded 1x2 session
            gloo = gloo_out[f"{GLOO_WEAK} sharded"]
            rows[-1]["launches_on_gloo_1x2"] = gloo["launches"][kname]
            rows[-1]["gloo_1x2_ns_per_query"] = (
                gloo["seconds"] / gloo["stats"]["n_queries"] * 1e9)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_expanded_ms", "plain_at", "ms_at_plain_shape")
        if "also" in meta:
            rows[-1]["phases"] = [meta["phase"], *meta["also"]]
        if kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            # the 1x2 mesh's layer-0 call (half the heads a rank), rank 0
            # of the gloo pair, timed while rank 1 waits
            rows[-1]["launches_on_sharded_train"] = phase_counts[
                "sharded_train"][kname]
            rows[-1]["at_sharded_train_tp_call"] = {
                "q_shape": tp_call["shapes"][0],
                "kv_shape": tp_call["shapes"][1],
                **{key: tp_call[kname][key] for key in keys
                   if key in tp_call[kname]}}
        if kname in sc_times or kname in ("flash_bwd_dq", "flash_bwd_dkv"):
            rows[-1]["launches_on_sharded_cells"] = phase_counts[
                "sharded_cells"][kname]
        if kname in sc_times:
            # a gloo rank's call of the sharded_cells phase, rank 0, timed
            # while rank 1 waits
            t = sc_times[kname]
            rows[-1]["at_sharded_cells_call"] = {
                "label": SC_LABELS[kname],
                **({"q_shape": t["shapes"][0], "kv_shape": t["shapes"][1]}
                   if "shapes" in t else {"rows": t["rows"]}),
                **{key: t[key] for key in keys if key in t},
                **({"library": t["library"]} if "library" in t else {})}
        if kname == "flash_fwd":
            rows[-1]["at_train_call"] = {key: train_fwd[key] for key in keys}
            rows[-1]["launches_on_moe"] = phase_counts["moe"][kname]
            rows[-1]["launches_on_moe_train"] = phase_counts["moe_train"][
                kname]
            for at, t in moe_fwd.items():
                rows[-1][at] = {"launches": t["launches"],
                                **{key: t[key] for key in keys}}
        if kname in bwd_hd128:
            rows[-1]["at_llama3_8b_layer_call"] = {
                key: bwd_hd128[kname][key] for key in keys
                if key in bwd_hd128[kname]}
            rows[-1]["launches_on_moe_train"] = phase_counts["moe_train"][
                kname]
            for at, t in moe_bwd.items():
                rows[-1][at] = {"launches": t[kname]["launches"],
                                **{key: t[kname][key] for key in keys
                                   if key in t[kname]}}
            rows[-1]["bf16_error_share_of_row_limit"] = BWD_ROW_SHARE[kname]
        if kname in overlay_times:
            # the churn phase's step of most swept pairs, kernel 4 with a
            # live overlay's can_reach_tail
            rows[-1]["at_overlay_step"] = {
                key: overlay_times[kname][key]
                for key in ("rows", "candidates", "ms", "warm_ms",
                            "plain_ms", "bound_ms", "bound_by", "floor_ms",
                            "floor_warm_ms", "at_once_ms")}
            rows[-1]["launches_on_churn"] = churn_counts[kname]
        if kname == "merge_cover":
            rows[-1]["launches_on_churn_compact"] = churn_counts[kname]
        if kname == "batched_mp":
            # the dense-batch train steps' forwards (gin-tu, molecule)
            rows[-1]["launches_on_gnn_train"] = gnn_train_counts[kname]
        if kname in ("stab_packed", "probe", "classify_emit"):
            rows[-1]["launches_on_reach_service"] = reach_counts[kname]
        if kname == "stab_packed":
            # ferrari-web's classify_16m cell call, at the published n
            t = times[FERRARI_LABEL]
            rows[-1]["at_ferrari_classify_16m"] = {
                "rows": t["rows"], "launches": fr_counts[kname],
                "launches_on_frontend": fe_counts[kname],
                **{key: t[key] for key in ("ms", "warm_ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "floor_ms", "floor_warm_ms")},
                "cell_queries_per_s": fr["qps"],
                "frontend_s": fr["frontend_s"]}
    check(sorted(DRYRUN) == sorted(c[0] for c in DRYRUN_CELLS),
          f"dryrun: checked on {sorted(DRYRUN)} only")
    print(dryrun_line(), flush=True)
    bad = {k: err[k][1] + times[k]["err"][1] for k in KERNELS}
    print("kernels: " + ", ".join(f"{r['name']} {bad[r['name']]} "
                                  f"mismatches, {r['launches']} launches"
                                  for r in rows)
          + f"; total {time.perf_counter() - t_start:.0f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
