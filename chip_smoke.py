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
``repro_torch.reach.QuerySession``, its three model serving paths and LM
training on the card:

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
  phase2   a weak index (k=1, no seeds) over 1M nodes with the sparse
           phase 2, at the default frontier cap and at cap 256, which
           forces the overflow retry (kernels 1, 3, 4).
  seeds64  a weak index (k=1) with 64 seeds over 1M nodes: the 12-array
           layout, in phase 1 and in the sparse phase 2 (kernels 2, 3).
  dense    the dense phase 2 on a graph of ≤ 8192 condensed nodes.
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
           65,536 molecules (kernel 9), held against the CPU run.
  lm       llama3-8b at its published widths and full depth (32 layers,
           bf16, random weights) through ``launch.serve.generate``: the
           prefill_32k prompt of 32,768 tokens (batch cut 32 -> 1; kernel
           6 once per layer) and 32 greedy decode steps from its cache;
           layer 0's attention call (k, v grouped: 8 kv heads) held
           against the plain version on its last 256 query rows and timed
           whole beside SDPA on the same tensors and on k, v expanded to
           32 heads; then the same widths cut to 2 layers in float32, a
           512-token prompt and 8 decode steps, card against CPU.
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
           timed beside SDPA; a profiled step; then the same widths cut to
           2 layers in float32 (batch 2 x seq 512, 2 microbatches), two
           steps, card against CPU.

Every phase sets the launch counters to 0 just before it is driven and
reads them just after; the reachability phases hold their answers against
the host guided DFS (``core.query.QueryEngine``), the model phases against
the CPU (rtol 1e-4, atol 1e-5 times the output's largest magnitude, at
least 1). Any mismatch or exception exits non-zero.
The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": ...}``. Without a CUDA device,
or without the repository's ``src/`` beside this file, it exits 1 and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
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
        replaces="src/repro/kernels/retrieval_score.py:32", phase="recsys"),
    "batched_mp": dict(
        source="src/repro_torch/csrc/batched_mp.cu",
        replaces="src/repro/kernels/batched_mp.py:31", phase="gnn"),
    "flash_fwd": dict(
        source="src/repro_torch/csrc/flash_fwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:101", phase="lm"),
    "flash_bwd_dq": dict(
        source="src/repro_torch/csrc/flash_bwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:172",
        call="src/repro/kernels/flash_attention.py:207", phase="train"),
    "flash_bwd_dkv": dict(
        source="src/repro_torch/csrc/flash_bwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:172",
        call="src/repro/kernels/flash_attention.py:224", phase="train"),
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


def kernel_parity(dev) -> dict:
    """Each kernel against its plain version on random inputs (≥ 2^20
    rows where a row is small): {name: (max_abs_err, mismatches,
    max_rel_err)}."""
    import torch

    from repro_torch.kernels import frontier_fused as ff
    from repro_torch.kernels import interval_stab as st
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    err = {name: (0, 0, 0.0) for name in KERNELS}
    n = 1 << 22
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
        del meta, slab, tables
    # kernel 3: 2^20 candidates of 256 queries over a 2^20-node bitset
    q, nn, c = 256, 1 << 20, PARITY_ROWS
    i32 = dict(device=dev, dtype=torch.int32)
    cq = torch.randint(0, q, (c,), generator=g, **i32)
    cv = torch.randint(0, nn, (c,), generator=g, **i32)
    ok = (torch.rand(c, generator=g, device=dev) < 0.8).to(torch.int32)
    visited = torch.randint(-2**31, 2**31 - 1, (q, nn // 32), generator=g,
                            **i32)
    pos = (torch.rand(q, generator=g, device=dev) < 0.2).to(torch.int32)
    _tally(err, "probe", _compare(
        "probe", ff.probe(cq, cv, ok, visited, pos, 20),
        ff.probe_plain(cq, cv, ok, visited, pos, 20)))
    del visited
    # kernel 4: 2^20 survivors with their gathered rows, K = 8
    meta, slab = packed_tables(g, 1 << 20, 8, dev)
    cs, ct = query_pairs(g, 1 << 20, c, dev)
    keys = torch.randint(0, 2**30, (c,), generator=g, **i32)
    keys[::5] = 2**31 - 1
    args = (meta[cs.long()], meta[ct.long()], slab[cs.long()], keys,
            (cs == ct).to(torch.int32))
    _tally(err, "classify_emit", _compare(
        "classify_emit", ff.classify_emit(*args),
        ff.classify_emit_plain(*args)))
    del meta, slab, args
    # kernel 5: the build's working widths, k = w_out as the build calls it
    from repro_torch.kernels import merge_cover as mc
    for m, w_out, rows in ((9, 2, PARITY_ROWS), (9, 8, PARITY_ROWS),
                           (513, 8, 1 << 14), (2049, 8, 1 << 12),
                           (2049, 32, 1 << 12)):
        rows_in = cover_rows(g, rows, m, dev)
        _tally(err, "merge_cover", _compare(
            f"merge_cover m={m} w_out={w_out}",
            mc.merge_cover(*rows_in, w_out, w_out),
            mc.merge_cover_plain(*rows_in, w_out, w_out)))
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
    # kernel 9: the molecule shape at the GNN widths, the bulk-like batch,
    # F tiles (N 128) and H tiles (N 200); w glorot-scaled as in the models
    from repro_torch.kernels import batched_mp as bm
    for b, n, f, h in ((4096, 30, 64, 64), (4096, 30, 16, 128),
                       (1024, 30, 128, 128), (4096, 30, 70, 70),
                       (256, 128, 128, 128), (64, 200, 128, 128)):
        adj = (torch.rand((b, n, n), generator=g, device=dev) < 0.2).float()
        x = torch.randn((b, n, f), generator=g, device=dev)
        w = torch.randn((f, h), generator=g, device=dev) * (2 / (f + h)) ** 0.5
        _tally(err, "batched_mp", _compare(
            f"batched_mp B={b} N={n} F={f} H={h}", bm.batched_mp(adj, x, w),
            bm.batched_mp_plain(adj, x, w)))
        eye = torch.eye(f, device=dev)
        _tally(err, "batched_mp", _compare(
            f"batched_mp B={b} N={n} F={f} w=eye", bm.batched_mp(adj, x, eye),
            bm.batched_mp_plain(adj, x, eye)))
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
    print(f"  flash_fwd: {2 * len(FLASH_SHAPES)} calls gave the same bits on "
          f"a repeat run", flush=True)
    return err


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


def device_ms(fn, reps: int = 30, cold: bool = True) -> float:
    """Median device time of one call from a pair of CUDA events around
    each of ``reps`` calls. All are queued behind a sleep kernel, so host
    launch overhead opens no gaps. With ``cold``, a 256 MiB write before
    each call evicts the L2, so the call reads its inputs from device
    memory, as the bound assumes; without it, repeated calls on the same
    inputs find them in the L2."""
    import torch
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)           # ~50 ms of queued work
    for start, end in events:
        if cold:
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
        from repro_torch.kernels import frontier_fused as ff
        from repro_torch.kernels import ops
        self.reset()
        self._orig = {}
        for mod, name in ((ops, "stab_packed"), (ops, "stab_naive"),
                          (ff, "probe"), (ops, "classify_emit"),
                          (ops, "retrieval_score"), (ops, "batched_mp")):
            fn = getattr(mod, name)
            self._orig[(mod, name)] = fn
            setattr(mod, name, self._wrap(name, fn))

    ROWS_ARG = {"stab_packed": -2, "stab_naive": -2, "probe": 0,
                "classify_emit": -1, "retrieval_score": 0, "batched_mp": 0}

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
    """(bytes, ops) the call must move and do on this call's data: int32
    ops for the reachability kernels, float32 flops (2 per multiply-add)
    for kernels 9 and 10, whose work does not depend on the data.
    Each input element the result depends on is read once — a table row,
    bitset word or flag that several queries gather counts once — and
    each output is written once. Rows the result does not depend on are
    not counted: those of cs == ct pairs, of candidates with ok == 0 (and
    the answered flag of one already visited), of SENTINEL slots, and of
    slots that are their query's target."""
    if name == "stab_packed":
        meta, slab, cs, ct = args
        k = slab.shape[1] // 2
        live = cs != ct
        q, s, t = cs.shape[0], cs[live], ct[live]
        nbytes = q * 12 + _distinct(s, t) * 16 + _distinct(s) * 8 * k
        return nbytes, int(live.sum()) * (6 * k + 25) + q
    if name == "stab_naive":
        pi, tau, lvl, b, e, x, sp, sm, cs, ct = args
        k, w = b.shape[1], sp.shape[1]
        live = cs != ct
        q, s, t = cs.shape[0], cs[live], ct[live]
        nbytes = (q * 12 + _distinct(s, t) * (8 + 8 * w)
                  + _distinct(s) * 12 * k + _distinct(t) * 4)
        return nbytes, int(live.sum()) * (6 * k + 8 * w + 10) + q
    if name == "probe":
        cq, cv, ok, visited, pos, _ = args
        c, valid = cq.shape[0], ok != 0
        q, v = cq[valid].long(), cv[valid].long()
        word = visited[q, v >> 5]
        fresh = ((word >> (v & 31)) & 1) == 0
        nbytes = (c * 8 + int(valid.sum()) * 8
                  + _distinct(q * visited.shape[1] + (v >> 5)) * 4
                  + _distinct(q[fresh]) * 4)
        return nbytes, c * 2 + int(valid.sum()) * 10
    if name == "retrieval_score":
        cands, ints = args
        (c, d), i = cands.shape, ints.shape[0]
        return 4 * (c * d + i * d + c), 2 * c * i * d
    if name == "batched_mp":
        adj, x, w = args
        (b, n, f), h = x.shape, w.shape[1]
        return (4 * (b * n * n + b * n * f + f * h + b * n * h),
                2 * b * n * n * f + 2 * b * n * f * h)
    if name == "flash_fwd":
        # 4·hd flops for each unmasked (q, k) pair: q·k and p·v; k and v
        # read once at their KV heads (grouped, read in place)
        q, k, v, causal, q_offset = args
        b, sq, h, hd = q.shape
        sk = k.shape[1]
        seen = (np.minimum(q_offset + np.arange(sq, dtype=np.int64) + 1, sk)
                if causal else np.full(sq, sk, dtype=np.int64))
        nbytes = ((2 * q.numel() + k.numel() + v.numel()) * q.element_size()
                  + 4 * b * h * sq)
        return nbytes, 4 * hd * b * h * int(seen.sum())
    if name in ("flash_bwd_dq", "flash_bwd_dkv"):
        # 6·hd flops per unmasked pair for dq (q·k, do·v, dS·k), 8·hd for
        # dk, dv (q·k, do·v, Pᵀ·do, dSᵀ·q); q, k, v, do, lse and delta read
        # once, dq or dk and dv written once
        q, k, v, dout, lse, delta, causal, q_offset = args
        b, sq, h, hd = q.shape
        sk = k.shape[1]
        seen = (np.minimum(q_offset + np.arange(sq, dtype=np.int64) + 1, sk)
                if causal else np.full(sq, sk, dtype=np.int64))
        outs = q.numel() if name == "flash_bwd_dq" else 2 * k.numel()
        nbytes = ((2 * q.numel() + 2 * k.numel() + outs) * q.element_size()
                  + 8 * b * h * sq)
        per = 6 if name == "flash_bwd_dq" else 8
        return nbytes, per * hd * b * h * int(seen.sum())
    if name == "merge_cover":
        cb, ce, cx, k, w_out = args
        rows, m = cb.shape
        n_valid = (cb != 2**31 - 1).sum(1)
        valid = int(n_valid.sum())
        # 12 B per valid slot, the first INVALID begin of a row that has
        # one, the outputs; ~10 int32 ops per slot for the recurrence
        nbytes = (valid * 12 + int((n_valid < m).sum()) * 4
                  + rows * (12 * w_out + 4))
        return nbytes, valid * 10
    meta_s, meta_t, slab_s, keys, eq = args
    c, k = keys.shape[0], slab_s.shape[1] // 2
    live = keys != 2**31 - 1
    rows = int((live & (eq == 0)).sum())
    return (c * 12 + int(live.sum()) * 4 + rows * (32 + 8 * k),
            c * 2 + rows * (6 * k + 30))


# The yardstick of kernels 9 and 10: no single PyTorch call computes
# either function, so two calls are timed ("2 calls" in the output).
def _scores_pair(cands, interests):
    return (cands @ interests.T).amax(1)


def _mp_pair(adj, x, w):
    import torch
    return torch.bmm(adj, x) @ w


LIBRARY_PAIRS = {
    "retrieval_score": ("(cands @ interests.T).amax(1), 2 calls",
                        _scores_pair),
    "batched_mp": ("torch.bmm(adj, x) @ w, 2 calls", _mp_pair),
}


def time_kernels(recorded: dict, extra: tuple = ()) -> dict:
    """Times each kernel at ``recorded[name]`` (the path's largest call),
    and at each ``(name, label, call)`` of ``extra``, which is printed and
    returned under ``label``."""
    from repro_torch.kernels import batched_mp as bm
    from repro_torch.kernels import frontier_fused as ff
    from repro_torch.kernels import interval_stab as st
    from repro_torch.kernels import merge_cover as mc
    from repro_torch.kernels import retrieval_score as rs
    plain = {"stab_packed": st.stab_packed_plain,
             "stab_naive": st.stab_naive_plain,
             "probe": ff.probe_plain, "classify_emit": ff.classify_emit_plain,
             "merge_cover": mc.merge_cover_plain,
             "retrieval_score": rs.retrieval_score_plain,
             "batched_mp": bm.batched_mp_plain}
    kernel = {"stab_packed": st.stab_packed, "stab_naive": st.stab_naive,
              "probe": ff.probe, "classify_emit": ff.classify_emit,
              "merge_cover": mc.merge_cover,
              "retrieval_score": rs.retrieval_score,
              "batched_mp": bm.batched_mp}
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
        out[label] = dict(rows=rows, ms=ms, plain_ms=plain_ms,
                          library=library, library_ms=library_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else
                          "operations", bytes=nbytes, ops=ops, err=err)
        lib = ("" if library is None else
               f", library {library_ms:.4f} ms ({library})")
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
    return counts, calls, dict(g=g, queries=(qs, qt, ps, pt),
                               answers=(ans, ans_p))


def wavefront_phase(dev, rec, main):
    """The device build of the main graph, then save → load → serve."""
    import tempfile

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

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as path:
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
    return counts, (largest[0].shape[0], largest)


def phase2_phase(dev, rec):
    from repro_torch.core.workload import random_queries
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec
    print(f"phase2: scale_free_digraph({SIDE_NODES}, 4.0), k=1, no seeds, "
          "sparse phase 2", flush=True)
    g = scale_free_digraph(SIDE_NODES, 4.0, seed=3)
    qs, qt = random_queries(g, 1 << 18, seed=4)
    out, built = {}, None
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
        check(st.phase2_sparse > 0, "phase2: no sparse phase-2 traffic")
        if cap == 256:
            check(st.sparse_retries > 0, "phase2: cap 256 did not retry")
            print(f"  sparse_retries > 0: {st.sparse_retries}", flush=True)
        hold_to_host(ix, sess, qs, qt, ans, 2000, f"cap={cap}")
        profile_window(lambda: sess.query(qs, qt),
                       f"cap={cap}, {qs.size} queries")
        out.setdefault("counts", counts)
        out.setdefault("calls", calls)
        out.setdefault("answers", ans)
        check(np.array_equal(out["answers"], ans),
              "phase2: answers differ between the two caps")
    return out["counts"], out["calls"]


def seeds64_phase(dev, rec):
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
    check(st.phase2_sparse > 0, "seeds64: no sparse phase-2 traffic")
    check(counts["probe"] > 0, "seeds64: phase 2 did not launch kernel 3")
    hold_to_host(ix, sess, qs, qt, ans, 2000, "seeds64")
    return counts, calls


def dense_phase(dev, rec):
    from repro_torch.core.query import QueryEngine
    from repro_torch.core.workload import random_queries
    from repro_torch.graphs.generators import scale_free_digraph
    from repro_torch.reach import IndexSpec
    print("dense: scale_free_digraph(16000, 4.0), k=1, no seeds, dense "
          "phase 2", flush=True)
    g = scale_free_digraph(16_000, 4.0, seed=7)
    spec = IndexSpec(k=1, use_seeds=False, phase2_mode="dense")
    ix, sess, _ = make_session(g, spec, dev)
    check(sess.engine.packed.n <= 8192, "dense graph over 8192 nodes")
    qs, qt = random_queries(g, 1 << 15, seed=8)
    reset_counters()
    ans, st = serve(sess, qs, qt, "random")
    counts = read_counters()
    print(f"  counts: {counts}", flush=True)
    check(st.phase2_dense > 0, "dense: no dense phase-2 traffic")
    want = QueryEngine(ix).batch(qs, qt)
    bad = int((ans != want).sum())
    print(f"  host check dense: {qs.size} answers, {bad} mismatches",
          flush=True)
    check(bad == 0, "dense: answers differ from the host engine")
    return counts


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


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
    for name, cell in cells.items():              # warm up
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
    calls = {"largest": dict(rec.calls), "smallest": dict(rec.small)}
    want_launches = sum(models[a][0].n_layers for a, _ in runs
                        if models[a][0].conv != "gatedgcn")
    print(f"  counts: {counts} (layers through kernel 9: {want_launches})",
          flush=True)
    check(counts["batched_mp"] == want_launches,
          "gnn: kernel 9 launches differ from the gin/gcn/sage layers")

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
    profile_window(lambda: gnn.forward_dense(*models["gin-tu"],
                                             *on_card[GNN_BULK_GRAPHS]),
                   f"gnn gin-tu forward on {GNN_BULK_GRAPHS} graphs")
    return counts, calls



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
    """The leaves of a nested dict, keys sorted."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key])
        else:
            yield tree[key]


def _train_state_close(label, got, want, metrics, want_metrics) -> None:
    """The card's train state and metrics against the CPU's at the CPU
    tests' tolerances: loss, grad_norm, lr at rtol 1e-4; m and v at rtol
    1e-4, atol 1e-5 x max|want|; params at atol 2 lr."""
    for key in ("loss", "grad_norm", "lr"):
        a, b = float(metrics[key]), float(want_metrics[key])
        print(f"  card vs CPU {label} {key}: {a:.6f} vs {b:.6f}", flush=True)
        check(abs(a - b) <= FORWARD_RTOL * abs(b),
              f"train {label}: {key} differs between card and CPU")
    two_lr = 2 * float(want_metrics["lr"])
    bad, worst = 0, 0.0
    for part in ("params", "m", "v"):
        g = got["params"] if part == "params" else got["opt"][part]
        w = want["params"] if part == "params" else want["opt"][part]
        for a, b in zip(_leaves(g), _leaves(w)):
            tol = ((0.0, two_lr) if part == "params" else
                   (FORWARD_RTOL, FORWARD_ATOL * float(b.abs().max())))
            err, n_bad, _ = close_stats(a.cpu(), b, *tol)
            bad, worst = bad + n_bad, max(worst, err)
    print(f"  card vs CPU {label} params, m, v: {bad} mismatches, max abs err "
          f"{worst:.3e} (params at atol 2 lr = {two_lr:.3e}; m, v at rtol "
          f"{FORWARD_RTOL}, atol {FORWARD_ATOL} x max|want|)", flush=True)
    check(bad == 0, f"train {label}: the card's state differs from the CPU's")


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

    # one step profiled, with the optimizer's device time from CUDA events
    events = []
    update = api.adamw_update

    def timed_update(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = update(*args)
        end.record()
        events.append((start, end))
        return out
    api.adamw_update = timed_update
    try:
        rows = profile_window(lambda: tr.run(tr.step_idx + 1),
                              f"train step of {TRAIN_BATCH} x {S} tokens",
                              top=8, wall=float(np.median(seconds)))
    finally:
        api.adamw_update = update
    torch.cuda.synchronize()
    opt_ms = events[-1][0].elapsed_time(events[-1][1])
    _train_split(rows, opt_ms, "train step")
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
    return counts, timing


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the model phases' data and weights")
    args = parser.parse_args()
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
    from repro_torch.kernels import _lib
    t_start = time.perf_counter()
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

    print("parity (kernel vs plain; integer kernels bit for bit):",
          flush=True)
    err = kernel_parity(dev)

    def done(phase):
        print(f"  [{phase} done at {time.perf_counter() - t_start:.0f} s]",
              flush=True)

    done("parity")
    rec = Recorder()
    try:
        main_counts, main_calls, main_out = main_phase(dev, rec)
        done("main")
        wf_counts, wf_call = wavefront_phase(dev, rec, main_out)
        del main_out
        done("wavefront")
        p2_counts, p2_calls = phase2_phase(dev, rec)
        s64_counts, s64_calls = seeds64_phase(dev, rec)
        dense_counts = dense_phase(dev, rec)
        done("phase2, seeds64, dense")
        rs_counts, rs_calls = recsys_phase(dev, rec, args.seed)
        gnn_counts, gnn_calls = gnn_phase(dev, rec, args.seed)
        done("recsys, gnn")
        lm_counts, lm_time = lm_phase(dev, args.seed)
        done("lm")
        train_counts, train_time = train_phase(dev, args.seed)
        done("train")
    finally:
        rec.close()
    phase_counts = {"main": main_counts, "wavefront": wf_counts,
                    "phase2": p2_counts, "seeds64": s64_counts,
                    "dense": dense_counts, "recsys": rs_counts,
                    "gnn": gnn_counts, "lm": lm_counts,
                    "train": train_counts}
    for kname, meta in KERNELS.items():
        n = phase_counts[meta["phase"]][kname]
        print(f"  launches {kname} on its phase ({meta['phase']}): {n}",
              flush=True)
        check(n > 0, f"{kname} was not launched on the {meta['phase']} "
              "phase")
    check(dense_counts["stab_packed"] > 0, "dense: kernel 1 not launched")
    check(wf_counts["stab_packed"] > 0, "wavefront: the loaded index did "
          "not serve through kernel 1")
    print(f"  sparse steps/syncs on phase2: {p2_counts['sparse_steps']}/"
          f"{p2_counts['sparse_syncs']} (one host sync per BFS step, plus "
          "one per expansion call)", flush=True)

    print("times (CUDA events, the path's own inputs):", flush=True)
    recorded = {"stab_packed": main_calls["stab_packed"],
                "stab_naive": s64_calls["stab_naive"],
                "probe": p2_calls["probe"],
                "classify_emit": p2_calls["classify_emit"],
                "merge_cover": wf_call,
                "retrieval_score": rs_calls["retrieval_score"],
                "batched_mp": gnn_calls["largest"]["batched_mp"]}
    # kernel 9 also at its smallest call: a molecule-batch layer
    times = time_kernels(recorded, extra=(
        ("batched_mp", "batched_mp (smallest call)",
         gnn_calls["smallest"]["batched_mp"]),))
    times["flash_fwd"] = lm_time          # timed in the lm phase
    train_fwd = train_time.pop("flash_fwd")
    a, b = lm_time["err"], train_fwd["err"]   # both held against plain
    lm_time["err"] = (max(a[0], b[0]), a[1] + b[1], max(a[2], b[2]))
    bwd_hd128 = train_time.pop("hd128")
    for kname, t in bwd_hd128.items():    # held against plain there too
        a, b = train_time[kname]["err"], t["err"]
        train_time[kname]["err"] = (max(a[0], b[0]), a[1] + b[1],
                                    max(a[2], b[2]))
    times.update(train_time)              # kernels 7 and 8: the train phase
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
                                       "library_expanded_ms") if key in t}})
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_expanded_ms", "plain_at", "ms_at_plain_shape")
        if kname == "flash_fwd":
            rows[-1]["at_train_call"] = {key: train_fwd[key] for key in keys}
        if kname in bwd_hd128:
            rows[-1]["at_llama3_8b_layer_call"] = {
                key: bwd_hd128[kname][key] for key in keys
                if key in bwd_hd128[kname]}
            rows[-1]["bf16_error_share_of_row_limit"] = BWD_ROW_SHARE[kname]
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
