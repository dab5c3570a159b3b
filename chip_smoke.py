#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every kernel.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
``nvcc``:  ``python3 chip_smoke.py``

Phases (a failing phase raises and the script exits non-zero):

1. device — a CUDA device is present; the card's name and power limit.
2. build  — every kernel of ``src/repro_torch/kernels/csrc`` that has no
   library in ``build/kernels`` newer than its source (in a fresh
   checkout, all of them) is compiled, one ``nvcc`` per source, all
   started together.
3. kernels — each kernel against its plain-torch version on the card, at
   the main paths' shapes and at the edge cases: sort, gather, ``set``,
   the DMA copy and the cache probe must be bit-equal (the probe over its
   whole trajectory: hits, ways, tags, valid bits, ages, clock), ``add``
   within float32 reassociation (rtol = atol = 1e-5) for float32 and
   float64 tables; an ``add`` into a bf16 or f16 table is held by
   ``check_mixed_add``; B3's span route (runs longer than its span) also
   on one run of 32768 slots and on runs of one span, one span and one
   slot and two spans, every case repeating its bits in a second call;
   flash attention (B6) by ``check_attention``: float32 inputs (the
   CUDA-core kernel) within the reference's rtol = atol = 3e-5; bf16 and
   f16 inputs (the tensor-core kernel) bit-equal to the same kernel's
   float32 output (``out_dtype=torch.float32``) rounded once, and that
   within 3e-5 of the plain float32 result (at the serve path's shape,
   windows, bidirectional hd 80, MQA, ragged S, S = 1, and the encoder
   path's own float32 bidirectional shape, 8 x 1024, 16/16 heads of 80).
   The sort also at N equal to its default chunk, twice it and eight
   times it, G > 1. The
   probe also with one hot set at the Table I shape, from tied ages and
   with 32768 sets (int32 sort keys in its grouping). The read/write
   probe (``cache_probe_rw``, the set-parallel cache engine's tag walk)
   bit-equal to its plain version over all 13 outputs (the walk's nine
   and the value sources), under write-back
   and write-through, on the cache_trace path's read/write trace from an
   empty and from a dirty state, with one hot set, from tied ages, from
   dirty lines past the table and on a stream that leaves no dirty way.
   The row resolve bit-equal to its plain version on 16-byte words and
   on bytes (12-byte rows, a misaligned view). The
   gather also at the serve lookup's shape, one run of 40000, runs across
   its spans, each access width and a misaligned table view; the DMA copy
   at one to eight channels, ragged totals, chunks under 16 bytes and of
   256 KB and a bulk write at an odd bf16 offset. Both kernels pick a
   route by alignment, and each checked call's route is named from the
   profiler's kernel names and held to the one its alignment calls for.
4. slice — five main paths, each through the entry points a user calls,
   with every launch counter zeroed just before it and read just after;
   each of its kernels must have run:
   - scheduler: the controller's data plane at the yi-34b embedding table
     (vocab 64000 x d_model 7168, bf16, random from a seed) under a
     prefill batch of 8 x 4096 Zipf(1.1) token ids:
     ``MemoryController.gather``, ``cached_gather`` (4096 hottest ids
     pinned), ``scatter`` set and add (the embedding-gradient write, in
     bf16 and in float32), ``cached_scatter``, and ``sort_requests`` as
     64 x 512 scheduler batches and as one 1-D row. Outputs are held to
     ``table[idx]`` and the plain paths, and a small case to a numpy
     oracle. Then each plain ``add`` of this batch (``coalesce_add_runs``
     and the controller with kernels off, scheduler on and off, bf16 and
     float32 values) is called twice and must give the same bits.
   - bulk: ``bulk_read`` of one yi-34b FFN weight (7168 x 20480 bf16) and
     ``bulk_write`` of one layer's prefill K and V into one sequence's
     KV cache (60 x 2 x 4096 x 8 x 128 bf16) at layer 30, held to the
     source, the plain path and a flat slice assignment.
   - cache: ``cache_service`` of the embedding table as 512-byte lines
     through the Table I maximum cache (32768 lines, 16-way), for the
     28 lines of each token of sequence 0 of the prefill batch; lines
     held to ``table[line_ids]``, hits to the numpy ``hit_rate_oracle``,
     the new state to the plain probe and a plain last-writer scatter.
   - cache_trace: the set-parallel cache engine, ``simulate_trace`` and
     ``simulate_trace_rw`` with ``engine="parallel"`` and ``"auto"``, at the
     same cache over the same lines: sequence 0's token lines read from
     ``init_cache`` (B5), then 229,376 beats from the state that left --
     sequence 1's lines read, interleaved beat for beat with sequence 0's
     lines written (bf16 payloads from seed 0) -- under write-back and
     write-through (``cache_probe_rw``, then ``row_resolve`` for the served
     lines, the Data RAM and the new table: winner rows only). Each
     result bit-equal to the same call on CPU copies of the inputs (the
     plain engine) and ``"auto"`` to ``"parallel"``, which launched the
     probe once and the row resolve once (read) or three times
     (read/write); on this trace the probe's value sources and the three
     row resolves bit-equal to their plain versions, and the read/write
     call's profiler trace free of ``cummax``, ``index_put`` and
     ``nonzero``; hits held to
     ``hit_rate_oracle`` and ``filter_trace_rw``, the new table to a numpy
     last-writer oracle of the victims ``filter_trace_rw`` lists (and,
     flushed, of the in-order write stream); a 4096-beat prefix of each
     trace also to the sequential walk on the CPU. It prints each call's
     host seconds and host syncs and the longest per-set chains.
   - serve: ``repro_torch.launch.serve.Server("yi-34b")`` at the full
     configuration (60 layers, 68.78 GB of bf16 weights, random from
     seed 0) serving the reference CLI's mix: 12 requests of 1024 uniform
     token ids, 16 new tokens each, arriving every 3 cycles (batches of 8
     and 4). Flash attention must launch once per layer per batch, every
     time through its tensor-core route, and the scheduler's sort and
     gather from the embedding lookups. Held to
     itself with kernels off (last-token prefill logits, greedy tokens)
     and a decode step to the cache-free forward of its prefix, and B6's
     attention block at every layer within two bf16 ulps of the plain
     block's largest magnitude; before those checks, ``serve_drift``
     prints where their differences arise, layer by layer. ``serve`` ends
     with the modeled KV replay (``Server.model_memory``), whose fields
     must equal ``SERVE_MODELED`` (the reference's for the same request
     shapes); its host seconds are printed apart. Runs after every
     earlier phase's tensors are freed.
   After the cache path, the simulate phase runs the port's
   modeled-timing simulator (numpy, on the host; no kernel may launch):
   Fig. 7 and Fig. 7-write at the benchmarks' size, every field equal to
   ``BENCH_fig7.json`` and ``BENCH_fig7_write.json`` read from disk; then
   the scheduler path's 8 x 4096 Zipf ids as row reads of 14336 bytes
   (yi-34b's bf16 row) through ``MemoryController.simulate`` and
   ``modeled_gather_time``, each twice with the same result, and on the
   batch's scheduled trace the FIFO command model and the MIG-like
   windowed model each equal to its ``*_seq`` oracle. Lifecycle tracing:
   ``simulate(..., trace=TraceRecorder())`` on that batch, on Fig. 7's GCN
   adjacency reads and on a two-tenant hog/victim stream equal to the
   untraced call field for field; on the hog/victim stream the cycle
   attribution's components sum to each request's sojourn bit for bit,
   and its Chrome trace, written to a temporary directory, passes the
   validator. It prints the makespan, the stage breakdown, the hit rate
   and each call's host seconds.
5. timing — per kernel at the main paths' shapes: the CUDA-event median
   of the kernel's wrapper, its plain version and one PyTorch library
   call computing the same function (none for the cache probe: no
   PyTorch call runs an LRU), beside the least time the card could take
   (bytes over 3.35 TB/s, or operations over the peak rate). For every
   kernel also its and the library call's device time per call from
   ``torch.profiler`` (the wrapper's time includes the host's) and the
   device launches per call counted in that trace; the sort's held to its
   launch plan, and also at three other chunks; the gather's and the DMA
   copy's routes, which must be the TMA ones at these shapes; the
   scatter's route (the span route for ``add`` at this batch) and its own
   kernels' device time without the table's clone; the cache probe's
   kernel alone. The cache path also counts the probe's and
   ``cache_service``'s host syncs (the probe must make one). The
   read/write probe at the cache_trace path's shape, each engine call's
   device time with its kernels' own in it beside the call's byte bound,
   and the row resolve at the engine's three calls.

6. after the serve path, its 68.78 GB freed:
   - autotune (host only; no kernel may launch): ``tune(engine=
     "batched")`` over ``FULL_GRID`` (benchmarks/perf_model_traces.py's)
     on each of the six pinned family traces (8 ports, 4096-byte rows)
     must give ``BENCH_model_traces.json``'s ``families`` entry, read from
     disk: the geometry, and ``tuned_cycles`` to 0.1; over ``SMALL_GRID``
     the batched engine and the oracle the same argmin and table, scores
     within C6_ULPS (ROADMAP C6). Host seconds of each call per trace.
   - serve_moe and serve_ssm: ``Server("qwen2-moe-a2.7b")`` (24 layers,
     60 routed experts top-4 and 4 shared, 28.63 GB bf16) and
     ``Server("mamba2-2.7b")`` (64 layers, 80 SSD heads, 5.66 GB), neither
     cut, random from seed 0, serving the yi-34b serve's mix with counters
     zeroed just before ``serve``: flash attention once per attention
     layer per batch on its tensor-core route (none for Mamba), the
     scheduler's sort and gather in every embedding lookup, no other
     kernel; the modeled replay equal to ``SERVE_MODELED``. MoE, on the
     served bf16 weights: B6's block within SERVE_ATTN_ULPS at each of
     the 24 layers (a walk of the layers through ``LM._run_block`` that
     must give the prefill's logits bit for bit), the prefill's dropped
     assignments and route flips, and the logit comparisons printed;
     then on a float32 copy (``check_moe_serve`` says why), through
     ``prefill``, ``decode_step`` and ``forward``: last-token prefill
     logits kernels on against off, with greedy tokens, and a decode step
     against the cache-free forward on a copy whose capacity factor makes
     capacity equal the tokens, each within SERVE_F32_REL_BOUND. SSM:
     kernels on against off and greedy tokens on the served weights,
     within SERVE_REL_BOUND; on a float32 copy a decode step against the
     cache-free forward and the chunked forward against a stepwise decode
     over 300 tokens (a chunk boundary and a ragged tail), each within
     SERVE_F32_REL_BOUND, the bf16 readings printed. Each prints parameter
     bytes, prefill seconds, decode seconds a step and tokens a second.

7. the rest of the zoo, each after the earlier paths' memory is freed,
   random weights from seed 0, counters zeroed just before the path and
   read just after; each prints its parameter bytes, its seconds and the
   card's ``nvidia-smi`` name and power limit:
   - serve_hybrid: jamba-v0.1-52b cut to 16 of its 32 layers (two periods
     of 8: attention at position 4, Mamba elsewhere, MoE 16 experts top-2
     at the odd positions; 52.00 GB bf16, uncut 102.92 GB), through
     ``CutServer`` (the cut is this script's), serving the yi-34b serve's
     mix: flash attention once per attention layer per batch (4), all on
     its tensor-core route, the sort and gather in every lookup, no other
     kernel, the modeled replay equal to ``SERVE_MODELED``. On the bf16
     weights B6's block within SERVE_ATTN_ULPS at both attention layers
     (``prefill_layers``, whose walk must give the prefill's logits bit
     for bit, with each MoE layer's drops), the logit readings printed
     (routes swap in bf16, ROADMAP C18); then on a float32 copy cut to
     one period (8 layers, 53 GB) the MoE serve's gates at
     SERVE_F32_REL_BOUND (``check_moe_serve`` with the cut).
   - encoder: hubert-xlarge uncut (48 layers, 2.52 GB), ``forward`` and
     ``loss`` on ``make_batch``'s 8 x 1024 float32 frames: the frames keep
     the residual stream float32, as in the reference, so 48 flash
     attention launches a call, all on the float32 (CUDA-core) route, and
     no sort, gather or other kernel; logits and loss kernels on against
     off within SERVE_F32_REL_BOUND (B6 on this route at this shape is
     held to its plain version at 3e-5 in phase 3's attention cases).
   - vlm: internvl2-76b cut to 24 of its 80 layers (45.33 GB, uncut
     141.16 GB): ``LM.prefill`` of 4 sequences of 256 patches and 1024
     text tokens from ``make_batch``, then 16 greedy ``decode_step``s:
     flash attention 24 times on its tensor-core route, the sort and the
     gather 17 times each (every text lookup), no other kernel. On the
     bf16 weights greedy tokens kernels on against off (``check_greedy``)
     and B6's block within SERVE_ATTN_ULPS at every layer; the logits
     printed beside a reordered-sums control; on a float32 copy cut to 8
     layers, prefill kernels on against off and a decode step against
     the cache-free forward within SERVE_F32_REL_BOUND (``check_vlm``).
   - capture: ``capture_model_trace`` on the card for the six family
     representatives at their smoke configs, on the port's seeded
     params; every value-independent request equal to the same capture on
     CPU copies of the params, as many value-dependent ones (decode
     tokens, MoE routes; their differing rows printed). The sort, the
     gather, B3's ``add`` (the embedding-gradient update) and flash
     attention must each have run.

The line before the last is ``{"kernels": [...]}`` (each kernel's
launches on its own path, and ``launches_by_path`` on every path); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import collections
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import (CacheConfig, CacheState, DMAConfig,  # noqa: E402
                              HotRowCache, MemoryController,
                              PAPER_EVAL_CONFIG, dma_engine,
                              filter_trace_rw, flush, hit_rate_oracle,
                              init_cache, simulate_trace, simulate_trace_rw)
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core.config import (DRAMSchedConfig,  # noqa: E402
                                     SchedulerConfig)
from repro_torch.core.controller import scatter_set_last  # noqa: E402
from repro_torch.core.telemetry import (COMPONENTS,  # noqa: E402
                                        CycleAttribution, TraceRecorder)
from repro_torch.core.scheduler import (READ, WRITE, schedule_trace,  # noqa: E402
                                        schedule_trace_rw, sort_requests)
from repro_torch.core.timing import (DDR4_2400, simulate_dram_access,  # noqa: E402
                                     simulate_dram_access_windowed,
                                     simulate_dram_access_windowed_seq,
                                     simulate_dram_sched,
                                     simulate_dram_sched_seq)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import model_traces  # noqa: E402
from repro_torch.data.synthetic import (hog_victim_workload,  # noqa: E402
                                        make_batch)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import tracing  # noqa: E402
from repro_torch.kernels.bitonic_sort import kernel as bs_kernel  # noqa: E402
from repro_torch.kernels.bitonic_sort import ops as bs_ops  # noqa: E402
from repro_torch.kernels.cache_lookup import kernel as cl_kernel  # noqa: E402
from repro_torch.kernels.cache_lookup import ops as cl_ops  # noqa: E402
from repro_torch.kernels.dma_copy import kernel as dc_kernel  # noqa: E402
from repro_torch.kernels.dma_copy import ops as dc_ops  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.sorted_gather import kernel as sg_kernel  # noqa: E402
from repro_torch.kernels.sorted_scatter import kernel as ss_kernel  # noqa: E402
from repro_torch.kernels.sorted_scatter.coalesce import coalesce_add_runs  # noqa: E402
from repro_torch.launch.serve import Request, Server, ServeStats  # noqa: E402
from repro_torch.models import blocks, build_lm, layers  # noqa: E402
from repro_torch.models.params import leaves, map_tree  # noqa: E402

LIBS = {"bitonic_sort": bs_kernel.LIB, "sorted_gather": sg_kernel.LIB,
        "sorted_scatter": ss_kernel.LIB, "dma_copy": dc_kernel.LIB,
        "cache_lookup": cl_kernel.LIB, "flash_attention": fa_kernel.LIB,
        "cache_probe_rw": cl_kernel.RW_LIB,
        "row_resolve": cl_kernel.RESOLVE_LIB}
REPLACES = {"bitonic_sort": "src/repro/kernels/bitonic_sort/kernel.py:85",
            "sorted_gather": "src/repro/kernels/sorted_gather/kernel.py:34",
            "sorted_scatter": "src/repro/kernels/sorted_scatter/kernel.py:38",
            "dma_copy": "src/repro/kernels/dma_copy/kernel.py:69",
            "cache_lookup": "src/repro/kernels/cache_lookup/kernel.py:63",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:92",
            # No Pallas kernel: the reference's XLA lax.scan step.
            "cache_probe_rw": "src/repro/core/trace_engine.py:104",
            # New, no Pallas kernel: the copies that the reference's
            # set-parallel engine makes with numpy gathers and last-writer
            # scatters.
            "row_resolve": "new: src/repro/core/trace_engine.py:418"}
# The main path that drives each kernel (phase 4); its launches are the
# ones reported.
PATH_OF = {"bitonic_sort": "scheduler", "sorted_gather": "scheduler",
           "sorted_scatter": "scheduler", "dma_copy": "bulk",
           "cache_lookup": "cache", "flash_attention": "serve",
           "cache_probe_rw": "cache_trace", "row_resolve": "cache_trace"}
SEED = 0
VOCAB, D_MODEL = 64000, 7168     # yi-34b (src/repro/configs/yi_34b.py), bf16
BATCH, SEQ = 8, 4096             # one prefill batch of token ids
ZIPF_S = 1.1
HOT_ROWS = 4096
SCHED_BATCH = 512                # the scheduler's largest batch (Table I)
FFN_SHAPE = (D_MODEL, 20480)     # one yi-34b FFN weight (d_model x d_ff)
# One sequence's yi-34b KV cache: layers x (K, V) x seq x kv heads x
# head_dim; a prefill flushes one layer's K and V at a time.
KV_SHAPE = (60, 2, SEQ, 8, 128)
KV_LAYER = 30
# The cache engine at the Table I maximum: 32768 lines of 512 bytes (256
# bf16), 16-way; a token's embedding row is 28 lines.
CACHE_CFG = CacheConfig(line_width_bits=4096, num_lines=32768,
                        associativity=16)
# The cache_trace path's sequential-walk check replays this many beats of
# each trace on the CPU.
SEQ_PREFIX = 4096
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
NONTENSOR_OPS_PER_S = 67e12      # H100 SXM float32 rate outside tensor cores
TENSOR_BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# The serve path: the reference CLI's request mix (src/repro/launch/serve.py
# main()) at 1024-token prompts and 16 new tokens.
SERVE_ARCH, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = "yi-34b", 12, 1024, 16
# Prefill attention at the serve path: B x S tokens, 56 query heads over 8
# KV heads, head_dim 128, bf16, causal.
ATTN_SHAPE = (8, SERVE_PROMPT, 56, 8, 128)
# B6 against its plain version: name, (B, S, H, KV, hd), dtype, causal,
# window.
ATTN_CASES = [
    ("serve prefill", ATTN_SHAPE, torch.bfloat16, True, None),
    ("h2o-danube window 4096 at S 8192", (1, 8192, 32, 8, 80),
     torch.bfloat16, True, 4096),
    ("window 20 < one tile", (2, 300, 8, 2, 64), torch.bfloat16, True, 20),
    ("hubert bidirectional hd 80", (2, 512, 16, 16, 80), torch.bfloat16,
     False, None),
    ("granite MQA group 48, ragged S 1000", (1, 1000, 48, 1, 128),
     torch.bfloat16, True, None),
    ("float32 ragged S 1000, group 7", (2, 1000, 14, 2, 80), torch.float32,
     True, None),
    ("float32 S 1", (3, 1, 56, 8, 128), torch.float32, True, None),
    ("float32 bidirectional window 40", (1, 520, 4, 2, 64), torch.float32,
     False, 40),
    ("hubert encoder float32 bidirectional hd 80", (8, 1024, 16, 16, 80),
     torch.float32, False, None),
    ("f16 window 3", (1, 200, 4, 2, 128), torch.float16, True, 3),
]
# Relative bound of the serve path's self-consistency (max |diff| over the
# largest reference logit magnitude).
SERVE_REL_BOUND = 2e-2
# The same on a float32 copy of the served weights (the MoE and SSM serves'
# gates: ``check_moe_serve``, ``check_ssm_serve``), as the CPU parity tests
# hold float32 logits.
SERVE_F32_REL_BOUND = 1e-4
# B6's own error in the serve model: at every layer its attention block
# within this many bf16 ulps of the plain block's largest magnitude, on the
# same input.
SERVE_ATTN_ULPS = 2.0
# The serve mix's modeled KV replay (``Server.model_memory``: the mix's
# ``kv_trace`` through ``MemoryController.simulate`` open loop, the
# default controller config, no SLO), as the reference's
# ``repro.launch.serve.Server.model_memory`` gives it for the same request
# shapes; the replay depends on them alone, not on the model.
SERVE_MODELED = dict(
    modeled_p50_cycles=35455.98784878488,
    modeled_p95_cycles=67395.73598859886,
    modeled_p99_cycles=72181.29864686467,
    modeled_makespan_cycles=74489.15451545155,
    modeled_per_tenant={0: {
        "n": 12864, "p50_sojourn": 35455.98784878488,
        "p95_sojourn": 67395.73598859886, "p99_sojourn": 72181.29864686467,
        "mean_sojourn": 35507.548829229934,
        "worst_sojourn": 73432.15451545155}},
    modeled_slo_attainment={})
# The two serves after yi-34b's (same mix): the MoE family at
# qwen2-moe-a2.7b's full configuration (24 layers, 60 routed experts top-4
# and 4 shared, 28.63 GB bf16) and the SSM family at mamba2-2.7b's (64
# layers, 80 SSD heads of 64, state 128, chunk 256, 5.66 GB); neither cut.
SERVE_MOE_ARCH, SERVE_SSM_ARCH = "qwen2-moe-a2.7b", "mamba2-2.7b"
# The SSM serve's stepwise check: a prompt past one 256-token chunk with a
# ragged tail, for two sequences.
SSM_STEP_PROMPT, SSM_STEP_BATCH = 300, 2
# The MoE serve's float32 checks: the first prompts of its first batch.
MOE_F32_BATCH = 2
# The rest of the zoo on the card, each at full width. The hybrid serve:
# jamba-v0.1-52b cut to 16 of its 32 layers (two periods, 52.00 GB of bf16
# weights; uncut it is 102.92 GB, past the card's 80 GB), serving the
# yi-34b serve's mix; its float32 gates on a copy cut to one period (8
# layers, 53 GB in float32).
SERVE_HYBRID_ARCH, SERVE_HYBRID_LAYERS = "jamba-v0.1-52b", 16
SERVE_HYBRID_F32_LAYERS = 8
# The encoder: hubert-xlarge uncut (48 layers, 2.52 GB), forward and loss
# on make_batch's frames: 8 clips of 1024 frames (about 20 s of audio at
# 50 frames a second).
ENCODER_ARCH, ENCODER_BATCH, ENCODER_FRAMES = "hubert-xlarge", 8, 1024
# The VLM: internvl2-76b cut to 24 of its 80 layers (45.33 GB; uncut
# 141.16 GB), a prefill of 4 sequences of its 256 patches and 1024 text
# tokens from make_batch, then SERVE_NEW greedy decode steps.
VLM_ARCH, VLM_LAYERS, VLM_BATCH, VLM_TEXT = "internvl2-76b", 24, 4, 1024
# Its float32 gates on a copy of the served weights cut to 8 layers
# (35.8 GB in float32).
VLM_F32_LAYERS = 8
# The autotune phase: benchmarks/perf_model_traces.py's two grids (that
# module imports the reference package, so they are copied here). The full
# grid on the six pinned family traces reproduces BENCH_model_traces.json's
# ``families``; the small one holds the batched engine to the oracle.
FULL_GRID = dict(
    batch_sizes=(16, 64, 256),
    associativities=(1, 4),
    num_lines=(1024, 4096, 16384),
    dma_channels=(4,),
    num_channels=(1, 2, 4),
    mapping_policies=("row_interleave", "xor"),
    dram_sched_policies=("fifo", "frfcfs"),
    reorder_windows=(1, 16, 64),
)
SMALL_GRID = dict(
    batch_sizes=(16, 64),
    associativities=(1, 4),
    num_lines=(1024, 4096),
    dma_channels=(4,),
    num_channels=(1, 4),
    mapping_policies=("row_interleave", "xor"),
    dram_sched_policies=("fifo", "frfcfs"),
    reorder_windows=(1, 16),
)
# The two engines' scores may differ in the last digit (ROADMAP C6): held
# within this many ulps of the larger.
C6_ULPS = 4
# The routes of the kernels that choose one by alignment, by the names of
# their CUDA kernels in a profiler trace.
ROUTES = {"sorted_gather": {"gather_rows_tma_kernel": "tma",
                            "gather_rows_vec_kernel": "vec"},
          "dma_copy": {"dma_copy_tma_kernel": "tma",
                       "dma_copy_cp_async_kernel": "cp_async"},
          # B3's add: a batch with a run longer than SPAN takes the span
          # route (its short runs still go one pass); any other, one pass.
          "sorted_scatter": {"scatter_add_span_kernel": "span",
                             "scatter_add_fold_kernel": "span",
                             "scatter_add_runs_kernel": "one_pass"}}
WARMUP, REPS = 3, 20
# The name of the marker kernel that ``torch.cuda._sleep`` launches, and
# how many ``device_trace`` launches first.
TRACE_MARKER = "spin_kernel"
TRACE_MARKERS = 8


def say(**fields) -> None:
    print(json.dumps(fields), flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(min(WARMUP, reps)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_trace(fn, reps: int = 10, tries: int = 3) -> dict:
    """What ``torch.profiler`` records on the card over ``reps`` calls,
    after warm-up, per call: ``ms``, the kernels' summed durations (None
    where it records no device time), ``launches``, the device events,
    ``by_kernel``, those launches by kernel name (its part before any
    argument list), and ``ms_by_kernel``, their durations by the same
    names. A trace with no device event at all is taken again,
    up to ``tries`` times: the profiler has returned an empty trace for
    calls that did launch (once in about 30 traces on the H100).

    Each trace starts with ``TRACE_MARKERS`` marker kernels
    (``torch.cuda._sleep``), run to their end before ``fn``'s calls and
    left out of every count: in some states of a long process the
    profiler loses the first kernel events of a trace on the H100, trace
    after trace, and the markers take that loss. A trace in which no marker survives may have lost more, and is
    taken again too."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_MARKERS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        events = [e for e in on_card if TRACE_MARKER not in e.name]
        if events and len(events) < len(on_card):
            break
    us = sum(e.device_time_total for e in events)
    by_kernel = collections.Counter(e.name.split("(")[0] for e in events)
    us_by_kernel = collections.Counter()
    for e in events:
        us_by_kernel[e.name.split("(")[0]] += e.device_time_total
    return dict(ms=us / reps / 1e3 if us > 0 else None,
                launches=len(events) / reps,
                by_kernel={k: n / reps for k, n in by_kernel.items()},
                ms_by_kernel={k: t / reps / 1e3
                              for k, t in us_by_kernel.items()})


def kernels_ms(trace: dict, prefix: str):
    """Device ms per call of the kernels in ``trace`` whose names start
    with ``prefix`` (a kernel's own launches, without the wrapper's clone
    or checks), or None where the trace holds none."""
    ms = [t for k, t in trace["ms_by_kernel"].items()
          if k.removeprefix("void ").startswith(prefix)]
    return sum(ms) if ms else None


def routes_taken(kernel: str, trace: dict) -> list:
    """The routes of ``kernel`` whose CUDA kernels ran in ``trace`` (a
    ``device_trace`` result)."""
    return sorted({route for name in trace["by_kernel"]
                   for pattern, route in ROUTES[kernel].items()
                   if pattern in name})


def route_of(kernel: str, fn, tries: int = 3) -> str:
    """The one route that ``fn``'s launches of ``kernel`` took. A trace
    that names none of the kernel's routes is taken again, up to ``tries``
    times: the profiler has dropped the one kernel of a trace on the
    H100. B3's ``add`` is on the span route where a span kernel ran, its
    short runs going one pass beside it."""
    for _ in range(tries):
        trace = device_trace(fn, reps=1)
        taken = routes_taken(kernel, trace)
        if taken:
            break
    if kernel == "sorted_scatter" and "span" in taken:
        taken = ["span"]
    assert len(taken) == 1, f"{kernel}: routes {taken} in {trace}"
    return taken[0]


def host_syncs(fn) -> list:
    """Where ``fn`` makes a synchronizing CUDA call (a host wait on the
    device), as torch's sync debug mode reports them: one ``file:line``
    each. Other warnings (the mode announces itself as a prototype once a
    process) are not counted."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| in units of one ulp (of a's dtype, bf16 or f16) of the
    larger magnitude."""
    bits, floor = {torch.bfloat16: (8, -133), torch.float16: (11, -24)}[a.dtype]
    a, b = a.float(), b.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), (exp - bits).clamp(min=floor))
    return float(((a - b).abs() / ulp).max())


def block_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| in ulps (of want's dtype) of want's largest
    magnitude: one number for a whole block."""
    bits = {torch.bfloat16: 8, torch.float16: 11,
            torch.float32: 24}[want.dtype]
    top = want.float().abs().max()
    _, exp = torch.frexp(top)
    ulp = torch.ldexp(torch.ones_like(top), exp - bits)
    return float((got.float() - want.float()).abs().max() / ulp)


@contextlib.contextmanager
def deterministic():
    """Run a plain version's float sums in one order. B3's plain ``add``
    folds each run with ``index_add_``, which on CUDA adds with atomics in
    an order that changes from run to run; the kernel sums each run in
    arrival order, the same on every run. The checks hold the two within
    float32 reassociation, so the plain side is computed with
    deterministic algorithms (its duplicates summed in index order)."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def check_mixed_add(got, want, got32, want32) -> dict:
    """Hold an ``add`` of float32 values into a bf16 or f16 table.

    ``got`` and ``want`` are the kernel's and the plain version's results;
    ``got32`` and ``want32`` are theirs for the same values added into the
    table converted to float32 (exact), where the kernel sums each run in
    the same order. The kernel's result must be its float32 sum rounded
    once, bit for bit, and that sum must agree with the plain version's
    within float32 reassociation (rtol = atol = 1e-5, as for float32
    tables). Where a row and its run cancel to near zero one bf16 ulp is
    far below that reassociation, so ``got`` and ``want`` are not held to
    each other in ulps; their raw disagreement is returned, with the
    plain result's magnitude where it is largest."""
    assert same_bits(got, got32.to(got.dtype)), \
        f"add into {got.dtype}: not the kernel's float32 sum rounded once"
    assert torch.allclose(got32, want32, rtol=1e-5, atol=1e-5), \
        f"add into {got.dtype}: float32 sums differ beyond reassociation"
    diff = (got.double() - want.double()).abs().reshape(-1)
    at = int(diff.argmax())
    return dict(max_abs_err=float(diff[at]),
                plain_there=float(want.reshape(-1)[at]),
                ulps=ulps(got, want),
                f32_sum_max_abs_err=float(
                    (got32.double() - want32.double()).abs().max()))


def zipf_ids(rng: np.random.Generator, shape) -> np.ndarray:
    """Zipf(ZIPF_S) token ids over the vocabulary, ranks scattered over
    the table by a random permutation."""
    p = np.arange(1, VOCAB + 1, dtype=np.float64) ** -ZIPF_S
    token_of_rank = rng.permutation(VOCAB)
    return token_of_rank[rng.choice(VOCAB, size=shape, p=p / p.sum())]


def prefill_ids() -> np.ndarray:
    """The main path's prefill batch of token ids, (BATCH, SEQ)."""
    return zipf_ids(np.random.default_rng(SEED), (BATCH, SEQ))


def line_elems() -> int:
    return CACHE_CFG.line_bytes // 2             # bf16 elements of a line


def token_lines(tokens: np.ndarray) -> np.ndarray:
    """Each token's embedding row as its consecutive cache lines, in
    order: the line ids the cache engine serves for a token sequence."""
    per_row = D_MODEL // line_elems()
    return (tokens[:, None] * per_row + np.arange(per_row)).reshape(-1)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def probe_bytes(n: int, sets: int, ways: int) -> int:
    """Bytes the cache probe must move: the line ids read, the state
    (tags, valid bits, ages, clock) read and written, hits and ways
    written."""
    return 4 * n + 2 * (3 * 4 * sets * ways + 4) + 8 * n


def probe_rw_bytes(n: int, sets: int, ways: int, rows: int) -> int:
    """Bytes the read/write probe must move: the line ids and write flags
    read, the state (tags, valid bits, ages, dirty bits, clock) read and
    written, hits, ways, evictions and victim tags written, and the int64
    value sources written: two a beat, one a way and one a row of the
    ``rows``-row table."""
    return 5 * n + 2 * (4 * 4 * sets * ways + 4) + 16 * n \
        + 8 * (2 * n + sets * ways + rows)


def engine_bytes(ct, name: str) -> int:
    """Bytes one cache_trace engine call must move, each input read once
    and each output written once: the ids (and write flags and payloads),
    the state in and out (its Data RAM included), the hits and the served
    lines out; the read call the table rows its ids name, the read/write
    call the whole table in and its new copy out."""
    state = ct["state0"] if name.startswith("read") else ct["warm"]
    state_bytes = sum(t.numel() * t.element_size() for t in (
        state.tags, state.valid, state.age, state.dirty, state.data,
        state.clock))
    tab = ct["lines_tab"]
    row = tab.shape[1] * tab.element_size()
    if name.startswith("read"):
        ids = ct["ids"]
        n = ids.numel()
        return n * ids.element_size() + 2 * state_bytes + n \
            + n * row + int(torch.unique(ids).numel()) * row
    ids, rw, payload = ct["rw_ids"], ct["rw"], ct["payload"]
    n = ids.numel()
    return n * (ids.element_size() + rw.element_size()) \
        + payload.numel() * payload.element_size() + 2 * state_bytes + n \
        + n * row + 2 * tab.numel() * tab.element_size()


def rw_trace() -> tuple[np.ndarray, np.ndarray]:
    """The cache_trace path's read/write trace: sequence 1's token lines
    read, interleaved beat for beat with sequence 0's lines written (its
    embedding-gradient write-back). Returns (line ids, rw flags)."""
    ids = prefill_ids()
    reads, writes = token_lines(ids[1]), token_lines(ids[0])
    return (np.stack([reads, writes], axis=1).reshape(-1),
            np.tile(np.array([READ, WRITE], np.int32), reads.size))


def check_dma(dev, gen) -> dict:
    """B4, the staged copy, bit for bit against its plain version; each
    call's route (``tma`` or ``cp_async``) named from the profiler's kernel
    names and held to the one its alignment calls for. Returns the number
    of checked calls per route."""
    taken = collections.Counter()

    def rand(dtype, shape):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        hi = 256 if dtype == torch.uint8 else 1 << 30
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def both(src, chunk, channels, route):
        call = lambda: dc_kernel.staged_copy(
            torch.empty_like(src), src, chunk_elems=chunk, channels=channels)
        want = dc_kernel.staged_copy_plain(torch.empty_like(src), src)
        what = f"dma_copy {src.dtype} n={src.numel()} chunk={chunk} " \
               f"channels={channels}"
        assert same_bits(call(), want), what
        got_route = route_of("dma_copy", call)
        assert got_route == route, f"{what}: route {got_route}"
        taken[route] += 1

    # Dtypes x channels x transaction sizes (256 B to the Table I maximum
    # of 256 KB). 1,000,000 elements: every total 16-byte aligned, the TMA
    # ring, a ragged last chunk; 1,000,003: 1-, 2- or 4-byte aligned
    # totals, the cp.async route.
    for dtype in (torch.bfloat16, torch.float32, torch.int32, torch.uint8):
        for n, route in ((1_000_000, "tma"), (1_000_003, "cp_async")):
            src = rand(dtype, (n,))
            for channels in (1, 4, 8):
                for txn in (256, 16384, 262144):
                    both(src, dc_ops.chunk_elems(DMAConfig(
                        max_transaction_bytes=txn), src.element_size()),
                        channels, route)
    # More channels than chunks: 100 elements, one chunk, eight slots.
    both(rand(torch.float32, (100,)), 65536, 8, "tma")
    # Chunks under 16 bytes: 1, 6 and 8 bytes.
    both(rand(torch.uint8, (100_000,)), 1, 1, "cp_async")
    both(rand(torch.bfloat16, (100_003,)), 3, 4, "cp_async")
    both(rand(torch.float32, (100_000,)), 2, 8, "cp_async")
    # The main path's shape: one FFN weight at PAPER_EVAL_CONFIG.
    w = rand(torch.bfloat16, FFN_SHAPE)
    cfg = PAPER_EVAL_CONFIG.dma
    assert same_bits(dc_ops.dma_copy(w, config=cfg), w), \
        "dma_copy at the FFN weight"
    assert route_of("dma_copy", lambda: dc_ops.dma_copy(w, config=cfg)) \
        == "tma", "dma_copy at the FFN weight: not the TMA ring"
    # A bulk write at an odd bf16 offset: a 2-byte aligned destination,
    # and a float32 source cast to bf16 first; the cp.async route.
    dst, src = rand(torch.bfloat16, (3, 1000, 7)), rand(torch.float32, (5001,))
    for offset in (777, 15_998):
        call = lambda: dma_engine.bulk_write(
            dst, src, config=cfg, offset_elems=offset, use_kernels=True)
        want = dma_engine.bulk_write(dst, src, config=cfg,
                                     offset_elems=offset, use_kernels=False)
        assert same_bits(call(), want), f"bulk_write at offset {offset}"
        assert route_of("dma_copy", call) == "cp_async", \
            f"bulk_write at offset {offset}: not the cp.async route"
        taken["cp_async"] += 1
    return dict(taken)


def check_cache(dev) -> None:
    """B5, the cache probe, against its plain version over the whole
    trajectory: hits, ways, tags', valid', age' and clock'; at the Table I
    shape also with one hot set and from states whose ages tie."""
    rng = np.random.default_rng(SEED + 3)
    names = ("hits", "ways", "tags", "valid", "age", "clock")

    def both(ids_np, state):
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
        got = cl_kernel.cache_probe(ids, *state)
        want = cl_kernel.cache_probe_plain(ids, *state)
        for name, g, w in zip(names, got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), \
                f"cache_probe {name}, {state[0].shape}, n={ids.numel()}"
        return got[2:]                  # the new state, to go on from

    def empty(cfg):
        st0 = init_cache(cfg, 1, device=dev)
        return st0.tags, st0.valid.to(torch.int32), st0.age, \
            st0.clock.reshape(1)

    main = token_lines(prefill_ids()[0])
    other = token_lines(prefill_ids()[1])
    for cfg in (PAPER_EVAL_CONFIG.cache, CACHE_CFG):
        # The main path's stream, then a second sequence from the state it
        # left (a non-empty starting state).
        both(other, both(main, empty(cfg)))
        # A stream that hammers one set: 40 tags of set 7, in random order.
        sets = cfg.num_sets
        both(7 + sets * rng.integers(0, 40, 6000), empty(cfg))
    # The Table I stream with one hot set: every 16th beat goes to set 5
    # (one of 40 tags), 7168 beats on one warp. Then ties: the stream from
    # a state whose ages are all INT_MAX (as the lanes past the ways are),
    # and from one whose ages repeat among 0, 1 and 2.
    sets = CACHE_CFG.num_sets
    hot = main.copy()
    hot[::16] = 5 + sets * rng.integers(0, 40, hot[::16].size)
    both(hot, empty(CACHE_CFG))
    tags, valid, age, clock = empty(CACHE_CFG)
    tags = torch.from_numpy(rng.integers(0, 40, tuple(tags.shape)).astype(
        np.int32)).to(dev)
    valid = torch.from_numpy(rng.integers(0, 2, tuple(tags.shape)).astype(
        np.int32)).to(dev)
    both(main, (tags, valid, torch.full_like(age, np.iinfo(np.int32).max),
                clock))
    both(main, (tags, valid, torch.from_numpy(rng.integers(
        0, 3, tuple(tags.shape)).astype(np.int32)).to(dev), clock + 5))
    check_cache_rw(dev, rng)
    # 32768 sets (Table I's most lines, direct-mapped): more than int16
    # sort keys hold, so the grouping sorts int32 keys.
    many = CacheConfig(line_width_bits=512, num_lines=32768,
                       associativity=1)
    both(rng.integers(0, 4 * many.num_sets, 20000), empty(many))


def check_cache_rw(dev, rng) -> None:
    """``cache_probe_rw`` against its plain version over the whole
    trajectory (hits, ways, evictions, victim tags, the new state and,
    over the embedding table's lines, the value sources)
    at the Table I shape, under write-back and write-through: the
    cache_trace path's read/write trace from an empty state, then again
    from the dirty state it left; a stream with one hot set; from tied
    ages (all INT_MAX, and repeats of 0, 1 and 2) with random valid and
    dirty bits, which hold a line in two ways of a set; from dirty ways
    whose lines lie past the table or below it (clipped); and a read-only
    stream that leaves no dirty way."""
    names = ("hits", "ways", "evict", "vic_tag", "tags", "valid", "age",
             "dirty", "clock", "src", "flush_src", "last", "row_src")
    rows = VOCAB * D_MODEL // line_elems()

    def both(ids_np, rw_np, state, write_back):
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
        rw = torch.from_numpy(rw_np.astype(np.int32)).to(dev)
        got = cl_kernel.cache_probe_rw(ids, rw, *state,
                                       write_back=write_back, rows=rows)
        want = cl_kernel.cache_probe_rw_plain(ids, rw, *state,
                                              write_back=write_back,
                                              rows=rows)
        for name, g, w in zip(names, got, want, strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w), \
                f"cache_probe_rw {name}, write_back={write_back}, " \
                f"n={ids.numel()}"
        return got[4:9]

    st0 = init_cache(CACHE_CFG, 1, device=dev)
    empty = (st0.tags, st0.valid.to(torch.int32), st0.age,
             st0.dirty.to(torch.int32), st0.clock.reshape(1))
    ids, rw = rw_trace()
    sets = CACHE_CFG.num_sets
    for write_back in (True, False):
        left = both(ids, rw, empty, write_back)
        both(ids[::-1].copy(), 1 - rw, left, write_back)
        hot = ids.copy()
        hot[::16] = 5 + sets * rng.integers(0, 40, hot[::16].size)
        both(hot, rw, empty, write_back)
        shape = tuple(st0.tags.shape)
        tags = torch.from_numpy(rng.integers(0, 40, shape).astype(
            np.int32)).to(dev)
        flags = [torch.from_numpy(rng.integers(0, 2, shape).astype(
            np.int32)).to(dev) for _ in range(2)]
        for age in (torch.full_like(st0.age, np.iinfo(np.int32).max),
                    torch.from_numpy(rng.integers(0, 3, shape).astype(
                        np.int32)).to(dev)):
            both(ids, rw, (tags, flags[0], age, flags[1],
                           st0.clock.reshape(1) + 5), write_back)
        far = torch.from_numpy(rng.integers(-3, 2 * rows // sets, shape)
                               .astype(np.int32)).to(dev)
        both(ids, rw, (far, flags[0], age, flags[1], st0.clock.reshape(1)),
             write_back)
        both(ids, np.zeros_like(rw), empty, write_back)


def check_row_resolve(dev, gen) -> None:
    """``row_resolve`` bit-equal to its plain version: 4096 bf16 lines of
    512 bytes from each kind of source (a payload row, an old way, the
    fallback's own row or one that ``fallback_rows`` names), on 16-byte
    words; float32 rows of 12 bytes and a view one element off 16-byte
    alignment, on bytes; no extra rows; and no rows at all. The main
    path's three calls are held in the cache_trace phase."""
    rng = np.random.default_rng(SEED + 3)

    def both(n_out, n, n_extra, n_fb, width, dtype, fb_rows, shift=0):
        def rand(k):
            base = torch.randn((k * width + shift,), generator=gen,
                               device=dev).to(dtype)
            return base[shift:].view(k, width)
        payload, extra, fallback = rand(n), rand(n_extra), rand(n_fb)
        src = torch.from_numpy(rng.integers(-1, n + n_extra, n_out)).to(dev)
        rows = torch.from_numpy(rng.integers(0, n_fb, n_out)).to(dev) \
            if fb_rows else None
        got = cl_kernel.row_resolve(src, payload, extra, fallback, rows)
        want = cl_kernel.row_resolve_plain(src, payload, extra, fallback,
                                           rows)
        assert same_bits(got, want), \
            f"row_resolve {n_out} rows of {width} {dtype}, fb_rows={fb_rows}"

    for fb_rows in (False, True):
        both(4096, 3000, 500, 4096 if not fb_rows else 9000, 256,
             torch.bfloat16, fb_rows)
    both(999, 300, 40, 999, 3, torch.float32, True)
    both(1000, 700, 200, 1000, 256, torch.bfloat16, False, shift=1)
    both(2048, 1500, 0, 2048, 256, torch.bfloat16, False)
    both(0, 5, 1, 0, 256, torch.bfloat16, False)


def check_kernels(dev, gen):
    """Phase 3: every kernel against its plain version, on the card.
    Returns each kernel's max_abs_err and the mixed-dtype adds' readings."""
    errs = {"bitonic_sort": 0.0, "sorted_gather": 0.0, "sorted_scatter": 0.0}
    mixed = {}
    rng = np.random.default_rng(SEED + 1)
    i32max = torch.iinfo(torch.int32).max

    def ints(lo, hi, shape):
        if hi == "zipf":        # the main path's token ids
            return torch.from_numpy(zipf_ids(rng, shape).astype(
                np.int32)).to(dev)
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int32)).to(dev)

    n_main = BATCH * SEQ
    # B1: the network, kernel vs the plain stage loop and torch's stable
    # sort, at the main paths' shapes and at N equal to the default chunk,
    # twice it and eight times it (G > 1: several launches, local and
    # global); then the padded op vs torch's stable sort (duplicates, real
    # INT32_MAX keys, odd N).
    c = bs_kernel.DEFAULT_CHUNK
    for shape, hi in [((n_main // SCHED_BATCH, SCHED_BATCH), "zipf"),
                      ((BATCH, SERVE_PROMPT), "zipf"), ((1, n_main), "zipf"),
                      ((3, 1024), 4), ((1, 2), 2), ((2, c), 4),
                      ((3, 2 * c), 4), ((4, 8 * c), 1000)]:
        keys, vals = ints(0, hi, shape), ints(0, 1 << 30, shape)
        keys[:, ::7] = i32max
        ids = torch.arange(shape[1], dtype=torch.int32,
                           device=dev).expand(shape).contiguous()
        got = bs_kernel.bitonic_sort_batched(keys, vals)
        want = bs_kernel.sort_network(keys, ids, vals)
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"bitonic_sort {shape} != plain"
        ref_keys, ref_perm = torch.sort(keys, dim=-1, stable=True)
        assert torch.equal(got[0], ref_keys) and torch.equal(
            got[1].long(), ref_perm), f"bitonic_sort {shape} != torch.sort"
    for n in (1000, 32768 - 5, 1):
        keys = ints(0, 8, (n,))
        keys[rng.integers(0, n, max(1, n // 10))] = i32max
        skeys, perm = bs_ops.sort_with_indices(keys)
        ref_keys, ref_perm = torch.sort(keys, stable=True)
        assert torch.equal(skeys, ref_keys), f"sort keys n={n}"
        assert torch.equal(perm.long(), ref_perm), f"sort perm n={n}"

    # B2: the gather, bit-equal to index_select, each call's route named
    # from the profiler's kernel names: the main path's shape (the full
    # table, the prefill batch's sorted Zipf ids), the serve lookup's (8 x
    # 1024 uniform ids, short runs), one run of 40000, runs that cross span
    # boundaries with an odd n, then row pitches whose widest aligned
    # access is 16, 8, 4, 2 and 1 bytes (rows of two column tiles too) and
    # a table view two bytes into its buffer.
    big = torch.randn((VOCAB, D_MODEL), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    runs = torch.from_numpy(np.repeat(
        np.sort(rng.choice(VOCAB, 200, replace=False)),
        rng.choice([1, 2, 5, 15, 16, 17, 33, 100], 200)).astype(
            np.int32)).to(dev)
    if runs.numel() % 2 == 0:
        runs = runs[1:]
    gathers = [("scheduler batch", big, ints(0, "zipf", (n_main,)), "tma"),
               ("serve lookup", big, ints(0, VOCAB, (BATCH * SERVE_PROMPT,)),
                "tma"),
               ("one run of 40000", big,
                torch.full((40000,), VOCAB // 3, dtype=torch.int32, device=dev),
                "tma"),
               ("runs across spans", big, runs, "tma")]
    for dtype, rows, d, n, route in [
            (torch.bfloat16, 300, 64, 5000, "tma"),
            (torch.float32, 100, 5000, 3001, "tma"),
            (torch.bfloat16, 500, 4, 5000, "vec"),
            (torch.float32, 1000, 33, 5000, "vec"),
            (torch.bfloat16, 300, 7, 5000, "vec"),
            (torch.int32, 200, 3, 5000, "vec"),
            (torch.uint8, 50, 5, 5000, "vec"),
            (torch.uint8, 100, 20001, 999, "vec")]:
        if dtype.is_floating_point:
            table = torch.randn((rows, d), generator=gen, device=dev,
                                dtype=dtype)
        else:
            table = ints(0, 100, (rows, d)).to(dtype)
        gathers.append((f"{dtype} {rows}x{d}", table, ints(0, rows, (n,)),
                        route))
    flat = torch.randn((1 + 300 * 64,), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    gathers.append(("table view at a 2-byte offset", flat[1:].view(300, 64),
                    ints(0, 300, (5000,)), "vec"))
    gather_routes = {}
    for name, table, idx, route in gathers:
        sidx = torch.sort(idx).values
        call = lambda: sg_kernel.gather_rows(table, sidx)
        assert same_bits(call(), sg_kernel.gather_rows_plain(table, sidx)), \
            f"gather {name}"
        gather_routes[name] = route_of("sorted_gather", call)
        assert gather_routes[name] == route, \
            f"gather {name}: route {gather_routes[name]}"
    del big, gathers

    # B3: set bit-equal; add within the stated tolerance; first at the main
    # path's shape, where a hot token's run is thousands of rows long. The
    # span route sums a long run in another order than the plain version's
    # slot-order sum, so a bf16 or f16 table is held by check_mixed_add.
    for dtype, rows, d, n, hi in [(torch.bfloat16, VOCAB, D_MODEL, n_main,
                                   "zipf"),
                                  (torch.bfloat16, 4096, D_MODEL, 8192, 512),
                                  (torch.float32, 2048, 256, 8192, 64),
                                  (torch.float64, 64, 33, 2000, 8),
                                  (torch.float16, 128, 70, 500, 16),
                                  (torch.int32, 100, 3, 300, 10)]:
        if dtype.is_floating_point:
            table = torch.randn((rows, d), generator=gen, device=dev,
                                dtype=dtype)
            vals = torch.randn((n, d), generator=gen, device=dev,
                               dtype=dtype)
        else:
            table = ints(0, 100, (rows, d))
            vals = ints(0, 100, (n, d))
        sidx = torch.sort(ints(0, hi, (n,))).values
        got = ss_kernel.scatter_rows(table, sidx, vals, mode="set")
        want = ss_kernel.scatter_rows_plain(table, sidx, vals, mode="set")
        assert torch.equal(got, want), f"scatter set {dtype}"
        if not dtype.is_floating_point:
            continue
        got = ss_kernel.scatter_rows(table, sidx, vals, mode="add")
        with deterministic():
            want = ss_kernel.scatter_rows_plain(table, sidx, vals, mode="add")
        err = float((got.double() - want.double()).abs().max())
        if dtype in (torch.bfloat16, torch.float16):
            t32 = table.float()
            with deterministic():
                want32 = ss_kernel.scatter_rows_plain(t32, sidx, vals,
                                                      mode="add")
            mixed[f"{dtype} -> {dtype} {rows}x{d} n={n}"] = check_mixed_add(
                got, want, ss_kernel.scatter_rows(t32, sidx, vals,
                                                  mode="add"), want32)
        else:
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), \
                f"scatter add {dtype}"
        errs["sorted_scatter"] = max(errs["sorted_scatter"], err)
    # B3 add with values of another dtype than the table (the repaired
    # path): float32 gradients into bf16 and f16 tables, int32 and float32
    # values into an int32 table (integer-valued, so every sum is exact
    # and the truncation toward zero is the same on both).
    for tdtype, vdtype, rows, d, n, hi in [
            (torch.bfloat16, torch.float32, VOCAB, D_MODEL, n_main, "zipf"),
            (torch.float16, torch.float32, 128, 70, 500, 16),
            (torch.int32, torch.int32, 100, 3, 300, 10),
            (torch.int32, torch.float32, 100, 3, 300, 10)]:
        if tdtype.is_floating_point:
            table = torch.randn((rows, d), generator=gen, device=dev,
                                dtype=tdtype)
            vals = (torch.randn((n, d), generator=gen, device=dev)
                    * 1e-2).to(vdtype)
        else:
            table = ints(-100, 100, (rows, d))
            vals = ints(-100, 100, (n, d)).to(vdtype)
        sidx = torch.sort(ints(0, hi, (n,))).values
        got = ss_kernel.scatter_rows(table, sidx, vals, mode="add")
        with deterministic():
            want = ss_kernel.scatter_rows_plain(table, sidx, vals, mode="add")
        if tdtype == torch.int32:
            assert torch.equal(got, want), f"scatter add {vdtype} -> int32"
        else:
            t32 = table.float()
            with deterministic():
                want32 = ss_kernel.scatter_rows_plain(t32, sidx, vals,
                                                      mode="add")
            mixed[f"{vdtype} -> {tdtype} {rows}x{d} n={n}"] = check_mixed_add(
                got, want, ss_kernel.scatter_rows(t32, sidx, vals, mode="add"),
                want32)
        errs["sorted_scatter"] = max(errs["sorted_scatter"], float(
            (got.double() - want.double()).abs().max()))
    dma_routes = check_dma(dev, gen)
    errs["dma_copy"] = errs["cache_lookup"] = 0.0   # bit-equal, asserted
    errs["cache_probe_rw"] = 0.0                     # check_cache_rw
    check_row_resolve(dev, gen)
    errs["row_resolve"] = 0.0                        # bit-equal, asserted
    torch.cuda.synchronize()
    return errs, mixed, dict(sorted_gather=gather_routes, dma_copy=dma_routes)


def check_scatter_spans(dev, gen) -> dict:
    """B3 ``add`` on its span route: the main path's Zipf batch (hot run
    4566 slots), one run of all 32768 slots, and runs of SPAN, SPAN + 1,
    2 SPAN slots among short runs, each with bf16 and float32 values into
    a bf16 table, float64 values into a float64 table and int32 values
    into an int32 table. Each result is held to the plain version (bf16:
    ``check_mixed_add``; float64: rtol = atol = 1e-5; int32: equal), gives
    the same bits in a second call, and comes from the span route, named
    in the profiler's trace; the plan the kernel read is ``span_plan_plain``'s.
    The single run's values are multiples of 1/16 below 8 in magnitude, so
    every float32 sum of it is exact in any order: the plain version sums
    32768 rows one after another, whose float32 rounding alone exceeds the
    tolerance; its error and the kernel's against float64 on normal values
    are reported. The other batches' float values are normal, at the
    main path's gradient scale (1e-2). Also counts the wrapper's host
    syncs (one)."""
    rng = np.random.default_rng(SEED + 5)
    span, n_main = ss_kernel.SPAN, BATCH * SEQ
    lengths = rng.permutation(np.concatenate([
        np.repeat([span, span + 1, 2 * span, 2 * span + 1, 3 * span + 5], 4),
        rng.integers(1, span, 60)]))
    batches = [
        ("zipf", VOCAB, D_MODEL, torch.sort(torch.from_numpy(
            zipf_ids(rng, (n_main,))).to(dev)).values, False),
        ("one run of 32768", 1024, D_MODEL,
         torch.full((n_main,), 333, dtype=torch.int32, device=dev), True),
        ("runs of S, S+1, 2S among short runs", 300, 1000, torch.from_numpy(
            np.repeat(np.sort(rng.choice(300, lengths.size, replace=False)),
                      lengths)).to(dev), False)]
    out = {}
    for name, rows, d, sidx, exact in batches:
        idx32, plan = ss_kernel.plan_on_card(sidx, rows, runs=True)
        want_plan = ss_kernel.span_plan_plain(sidx)
        for field, got_f, want_f in zip(ss_kernel.SpanPlan._fields, plan,
                                        want_plan):
            assert torch.equal(got_f, want_f), f"span plan {name}: {field}"
        assert torch.equal(idx32, sidx.to(torch.int32)), f"idx32 {name}"
        for tdtype, vdtype in ((torch.bfloat16, torch.bfloat16),
                               (torch.bfloat16, torch.float32),
                               (torch.float64, torch.float64),
                               (torch.int32, torch.int32)):
            if tdtype == torch.int32:
                table = torch.randint(-100, 100, (rows, d), generator=gen,
                                      device=dev, dtype=torch.int32)
                vals = torch.randint(-100, 100, (sidx.numel(), d),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
            else:
                table = torch.randn((rows, d), generator=gen, device=dev,
                                    dtype=tdtype)
                if exact:
                    vals = (torch.randint(-128, 128, (sidx.numel(), d),
                                          generator=gen, device=dev)
                            / 16).to(vdtype)
                else:           # gradients, at the main path's scale
                    vals = (torch.randn((sidx.numel(), d), generator=gen,
                                        device=dev) * 1e-2).to(vdtype)
            call = lambda: ss_kernel.scatter_rows(table, sidx, vals,
                                                  mode="add")
            got = call()
            assert same_bits(got, call()), \
                f"add {name} {vdtype}->{tdtype}: other bits on a second call"
            route = route_of("sorted_scatter", call)
            assert route == "span", f"add {name}: route {route}"
            with deterministic():
                want = ss_kernel.scatter_rows_plain(table, sidx, vals,
                                                    mode="add")
            key = f"{name}: {vdtype} -> {tdtype}"
            if tdtype == torch.int32:
                assert torch.equal(got, want), f"add {key}"
                out[key] = dict(route=route, max_abs_err=0.0)
            elif tdtype == torch.float64:
                assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), \
                    f"add {key}"
                out[key] = dict(route=route, max_abs_err=float(
                    (got - want).abs().max()))
            else:
                t32 = table.float()
                with deterministic():
                    want32 = ss_kernel.scatter_rows_plain(t32, sidx, vals,
                                                          mode="add")
                out[key] = dict(route=route, **check_mixed_add(
                    got, want, ss_kernel.scatter_rows(t32, sidx, vals,
                                                      mode="add"), want32))
            del table, vals, got, want
        out[name] = dict(spans=want_plan.span_first.numel(),
                         long_runs=want_plan.long_first.numel(),
                         short_runs=want_plan.short_first.numel())
    # The single run on normal values: each float32 sum's largest error
    # against the float64 sum of the same values (reported, not held).
    sidx = batches[1][3]
    table = torch.randn((1024, D_MODEL), generator=gen, device=dev)
    vals = torch.randn((n_main, D_MODEL), generator=gen, device=dev)
    exact64 = ss_kernel.scatter_rows_plain(table.double(), sidx, vals,
                                           mode="add")
    with deterministic():
        plain = ss_kernel.scatter_rows_plain(table, sidx, vals, mode="add")
    kernel = ss_kernel.scatter_rows(table, sidx, vals, mode="add")
    out["one run of 32768, normal float32 values: error vs float64"] = dict(
        kernel=float((kernel.double() - exact64).abs().max()),
        plain=float((plain.double() - exact64).abs().max()))
    sidx = batches[0][3]
    table = torch.randn((VOCAB, D_MODEL), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    vals = torch.randn((n_main, D_MODEL), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    out["host_syncs"] = {
        mode: host_syncs(lambda: ss_kernel.scatter_rows(table, sidx, vals,
                                                        mode=mode))
        for mode in ("add", "set")}
    assert all(len(at) == 1 for at in out["host_syncs"].values()), \
        out["host_syncs"]
    return out


def run_slice(dev, gen) -> dict:
    """Phase 4: the main path at full width, through the user's entry
    points, with every launch counter zeroed before and read after."""
    ids_np = prefill_ids()
    idx = torch.from_numpy(ids_np).to(dev)
    uniq, counts = np.unique(ids_np, return_counts=True)
    hot_ids = uniq[np.argsort(-counts, kind="stable")[:HOT_ROWS]]
    table = torch.randn((VOCAB, D_MODEL), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    vals = torch.randn((BATCH, SEQ, D_MODEL), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    grads32 = torch.randn((BATCH, SEQ, D_MODEL), generator=gen,
                          device=dev) * 1e-2
    grads = grads32.to(torch.bfloat16)
    mc = MemoryController(PAPER_EVAL_CONFIG, device=dev)   # kernels on
    hot = HotRowCache.build(table, hot_ids)
    torch.cuda.synchronize()

    zero_launches()
    t0 = time.perf_counter()
    out = mc.gather(table, idx)
    cached = mc.cached_gather(table, idx, hot)
    t_set = mc.scatter(table, idx, vals)
    t_add = mc.scatter(table, idx, grads, mode="add")
    t_cached, hot2 = mc.cached_scatter(table, idx, grads, hot, mode="add")
    t_add32 = mc.scatter(table, idx, grads32, mode="add")
    batches = sort_requests(idx.reshape(-1, SCHED_BATCH))
    stream = sort_requests(idx.reshape(-1))
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = read_launches("scheduler")

    ref = table[idx]
    assert out.shape == (BATCH, SEQ, D_MODEL) and torch.equal(out, ref), \
        "gather != table[idx]"
    assert torch.equal(cached, ref), "cached_gather != table[idx]"
    assert bool(torch.isfinite(out).all()), "gather: non-finite rows"
    plain = MemoryController(PAPER_EVAL_CONFIG, use_kernels=False, device=dev)
    assert torch.equal(t_set, plain.scatter(table, idx, vals)), \
        "scatter set != plain path"
    with deterministic():
        add_ref = plain.scatter(table, idx, grads, mode="add")
    add_ulps = ulps(t_add, add_ref)
    assert add_ulps <= 1.0, f"scatter add off by {add_ulps} bf16 ulp"
    assert torch.equal(t_cached, t_add), "cached_scatter != scatter"
    table32 = table.float()
    with deterministic():
        want = plain.scatter(table, idx, grads32, mode="add")
        want32 = plain.scatter(table32, idx, grads32, mode="add")
    add32 = check_mixed_add(t_add32, want,
                            mc.scatter(table32, idx, grads32, mode="add"),
                            want32)
    del table32
    assert torch.equal(hot2.hot_data, t_add[hot.hot_ids.long()]), \
        "cached_scatter did not re-pin"
    assert bool(torch.isfinite(t_add.float()).all()), "scatter add: non-finite"
    for (skeys, perm, inv), keys in [(batches, idx.reshape(-1, SCHED_BATCH)),
                                     (stream, idx.reshape(-1))]:
        want_keys, want_perm = torch.sort(keys, stable=True)
        assert torch.equal(skeys.long(), want_keys), "sort_requests keys"
        assert torch.equal(perm.long(), want_perm), "sort_requests perm"
        assert torch.equal(torch.gather(perm, -1, inv.long()).long(),
                           torch.arange(keys.shape[-1], device=dev).expand(
                               keys.shape)), "inv_perm is not the inverse"

    # A small case against a numpy oracle of the in-order write stream.
    small = np.random.default_rng(SEED + 2)
    tab = small.standard_normal((50, 6)).astype(np.float32)
    ix = small.integers(0, 50, 200)
    vx = small.standard_normal((200, 6)).astype(np.float32)
    want_set, want_add = tab.copy(), tab.astype(np.float64)
    for i, r in enumerate(ix):
        want_set[r] = vx[i]
        want_add[r] += vx[i]
    tt, it, vt = (torch.from_numpy(a).to(dev) for a in (tab, ix, vx))
    assert np.array_equal(mc.gather(tt, it).cpu().numpy(), tab[ix])
    assert np.array_equal(mc.scatter(tt, it, vt).cpu().numpy(), want_set)
    np.testing.assert_allclose(mc.scatter(tt, it, vt, mode="add").cpu().numpy(),
                               want_add, rtol=1e-5, atol=1e-5)

    sidx, perm = torch.sort(idx.reshape(-1), stable=True)
    return dict(table=table, idx=idx, sidx=sidx, svals=vals.reshape(-1, D_MODEL)[perm],
                grads=grads, grads32=grads32,
                sgrads=grads.reshape(-1, D_MODEL)[perm],
                sgrads32=grads32.reshape(-1, D_MODEL)[perm], launches=launches,
                slice_s=slice_s, add_ulps=add_ulps, add32=add32,
                distinct=int(uniq.size), hot_hits=int(
                    hot.hit_mask(idx).sum()))


def check_plain_add(dev, s) -> dict:
    """The plain ``add`` repeats its bits on the card: each plain ``add``
    of the main path, called twice outside ``deterministic()``, at the
    scheduler path's batch (32768 Zipf slots into the 64000 x 7168 bf16
    table; the hot token's run is thousands of rows long), with bf16 and
    with float32 values, through ``coalesce_add_runs`` on the sorted batch
    and through the controller with kernels off, scheduled and with the
    scheduler disabled."""
    table, idx, sidx = s["table"], s["idx"], s["sidx"]
    unscheduled = MemoryController(dataclasses.replace(
        PAPER_EVAL_CONFIG, scheduler=dataclasses.replace(
            PAPER_EVAL_CONFIG.scheduler, enabled=False)), device=dev)
    scheduled = MemoryController(PAPER_EVAL_CONFIG, use_kernels=False,
                                 device=dev)
    out = {"longest_run": int(torch.unique_consecutive(
        sidx, return_counts=True)[1].max())}
    for name, grads, sgrads in (("bf16", s["grads"], s["sgrads"]),
                                ("float32", s["grads32"], s["sgrads32"])):
        calls = {
            "coalesce_add_runs": lambda: coalesce_add_runs(table, sidx,
                                                           sgrads),
            "scheduled": lambda: scheduled.scatter(table, idx, grads,
                                                   mode="add"),
            "unscheduled": lambda: unscheduled.scatter(table, idx, grads,
                                                       mode="add")}
        results = {}
        for path, fn in calls.items():
            first = fn()
            torch.cuda.synchronize()
            assert same_bits(first, fn()), \
                f"plain add ({path}, {name} values): other bits on a second call"
            results[path] = first
        out[f"{name}_values_same_bits_twice"] = sorted(results)
        out[f"{name}_values_unscheduled_is_scheduled"] = same_bits(
            results["unscheduled"], results["scheduled"])
        del results
    return out


def zero_launches() -> None:
    for lib in LIBS.values():
        lib.reset_launches()


def read_launches(path: str) -> dict:
    """Every kernel's count since ``zero_launches``; each kernel of
    ``path`` must have run."""
    launches = {name: lib.launches for name, lib in LIBS.items()}
    for name, of in PATH_OF.items():
        assert of != path or launches[name] > 0, \
            f"kernel {name} did not run on the {path} path"
    return launches


def run_bulk(dev, gen) -> dict:
    """Phase 4, bulk path: ``bulk_read`` of an FFN weight and
    ``bulk_write`` of one layer's prefill K and V into a KV cache."""
    w = torch.randn(FFN_SHAPE, generator=gen, device=dev, dtype=torch.bfloat16)
    kv = torch.randn(KV_SHAPE, generator=gen, device=dev, dtype=torch.bfloat16)
    layer_kv = torch.randn(KV_SHAPE[1:], generator=gen, device=dev,
                           dtype=torch.bfloat16)
    offset = KV_LAYER * layer_kv.numel()
    mc = MemoryController(PAPER_EVAL_CONFIG, device=dev)
    torch.cuda.synchronize()

    zero_launches()
    t0 = time.perf_counter()
    w_out = mc.bulk_read(w)
    kv_out = mc.bulk_write(kv, layer_kv, offset_elems=offset)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches("bulk")

    assert same_bits(w_out, w) and w_out.data_ptr() != w.data_ptr(), \
        "bulk_read != its source"
    plain = MemoryController(PAPER_EVAL_CONFIG, use_kernels=False, device=dev)
    assert same_bits(kv_out, plain.bulk_write(kv, layer_kv,
                                              offset_elems=offset)), \
        "bulk_write != plain path"
    flat = kv.clone()
    flat.view(-1)[offset:offset + layer_kv.numel()] = layer_kv.view(-1)
    assert same_bits(kv_out, flat), "bulk_write != flat slice assignment"
    assert same_bits(kv_out[KV_LAYER], layer_kv), "layer not written"
    return dict(w=w, kv=kv, layer_kv=layer_kv, offset=offset,
                launches=launches, seconds=seconds)


def run_cache(dev, table) -> dict:
    """Phase 4, cache path: ``cache_service`` of the embedding table's
    lines for sequence 0 of the prefill batch."""
    lines_tab = table.view(-1, line_elems())
    ids_np = token_lines(prefill_ids()[0])
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
    state = init_cache(CACHE_CFG, line_elems(), torch.bfloat16, device=dev)
    torch.cuda.synchronize()

    zero_launches()
    t0 = time.perf_counter()
    lines, hits, new = cl_ops.cache_service(lines_tab, ids, state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches("cache")

    ids64 = ids.long()
    assert same_bits(lines, lines_tab[ids64]), "lines != table[line_ids]"
    want_hits, rate = hit_rate_oracle(CACHE_CFG, ids_np)
    assert np.array_equal(hits.cpu().numpy(), want_hits), \
        "hits != hit_rate_oracle"
    p = cl_kernel.cache_probe_plain(ids, state.tags,
                                    state.valid.to(torch.int32), state.age,
                                    state.clock)
    assert torch.equal(hits, p[0] != 0) and torch.equal(new.tags, p[2]) \
        and torch.equal(new.valid, p[3] != 0) and torch.equal(new.age, p[4]) \
        and int(new.clock) == int(p[5]) == ids.numel(), \
        "cache state != the plain probe's"
    sets, ways = state.tags.shape
    slot = (ids64 % sets) * ways + p[1].long()
    data = scatter_set_last(state.data.view(sets * ways, -1), slot,
                            lines_tab[ids64]).view(state.data.shape)
    assert same_bits(new.data, data), "Data RAM != last-writer scatter"
    assert not bool(new.dirty.any()), "a read stream left a dirty way"
    per_set = np.bincount(ids_np % sets, minlength=sets)
    # Host syncs of one call each: the probe makes one (its id-range
    # check), and so does each of cache_service's two set scatters.
    assert len(host_syncs(lambda: torch.ones(1, device=dev).item())) == 1, \
        "the sync counter does not see a sync"
    syncs = dict(
        probe=host_syncs(lambda: cl_kernel.cache_probe(
            ids, state.tags, state.valid.to(torch.int32), state.age,
            state.clock)),
        cache_service=host_syncs(lambda: cl_ops.cache_service(
            lines_tab, ids, state)))
    assert len(syncs["probe"]) == 1, f"cache_probe host syncs: {syncs}"
    return dict(lines_tab=lines_tab, ids=ids, state=state, launches=launches,
                seconds=seconds, hit_rate=rate, host_syncs=syncs,
                max_beats_per_set=int(per_set.max()))


def cpu_state(state: CacheState) -> CacheState:
    return CacheState(**{f.name: getattr(state, f.name).cpu()
                         for f in dataclasses.fields(state)})


def same_run(got, want, what: str) -> None:
    """Two engine results (a state, then tensors) bit for bit, on any
    devices."""
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, CacheState):
            for f in dataclasses.fields(g):
                assert same_bits(getattr(g, f.name).cpu(),
                                 getattr(w, f.name).cpu()), \
                    f"{what}: state.{f.name}"
        else:
            assert same_bits(g.cpu(), w.cpu()), f"{what}: output {i}"


def table_after(lines_tab, payload, lines, before, rw_lines, rw) -> \
        torch.Tensor:
    """``lines_tab`` with each of ``lines`` holding the payload of the last
    write to it before position ``before`` (one position, or one for each
    line) of the read/write trace (``rw_lines``, ``rw``): a numpy
    last-writer oracle."""
    w_pos = np.flatnonzero(rw == WRITE)
    key = rw_lines[w_pos] * (rw.size + 1) + w_pos
    order = np.argsort(key, kind="stable")
    at = np.searchsorted(key[order], lines * (rw.size + 1) + before) - 1
    assert (at >= 0).all() and (rw_lines[w_pos[order[at]]] == lines).all(), \
        "a line with no write before it"
    out = lines_tab.clone()
    dev = lines_tab.device
    out[torch.from_numpy(lines).to(dev)] = payload[
        torch.from_numpy(w_pos[order[at]]).to(dev)]
    return out


PROBE_RW_OUTPUTS = ("hits", "ways", "evict", "vic_tag", "tags", "valid",
                    "age", "dirty", "clock", "src", "flush_src", "last",
                    "row_src")
# Aten ops and kernel-name parts of the plain value reconstruction (a
# per-line fill by cummax, last-writer scatters by index_put, nonzero's
# host syncs) that the read/write engine's winner route runs none of.
PLAIN_RESOLVE_OPS = ("cummax", "index_put", "nonzero")


def profiled_names(fn) -> tuple[set, set]:
    """The aten ops that one call of ``fn`` runs on the host and the
    kernels it launches (names before any argument list), from one
    ``torch.profiler`` trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = {e.name.split("(")[0] for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    return ops, kernels


def check_value_sources(dev, lines_tab, warm, rw_ids, rw, payload, configs,
                        runs) -> None:
    """The cache_trace path's read/write trace from its warm state, under
    each policy: ``cache_probe_rw`` with ``rows`` bit-equal to its plain
    version over all 13 outputs; ``row_resolve``'s three calls (served
    lines, Data RAM, table) bit-equal to its plain version and to the
    engine's own results in ``runs``; and the engine's call free of the
    plain reconstruction's ops (``PLAIN_RESOLVE_OPS``), on the host and
    on the card."""
    rows, elems = lines_tab.shape
    args = (rw_ids, rw, warm.tags, warm.valid.to(torch.int32), warm.age,
            warm.dirty.to(torch.int32), warm.clock)
    data0 = warm.data.reshape(-1, elems)
    for policy, cfg in configs.items():
        wb = policy == "write_back"
        got = cl_kernel.cache_probe_rw(*args, write_back=wb, rows=rows)
        want = cl_kernel.cache_probe_rw_plain(*args, write_back=wb,
                                              rows=rows)
        for name, g, w in zip(PROBE_RW_OUTPUTS, got, want, strict=True):
            assert same_bits(g, w), f"cache_probe_rw {name}, {policy}"
        src, _, last, row_src = got[9:]
        final, table, _, lines = runs[f"rw {policy} parallel"]
        for what, call, engine in (
                ("lines", (src, payload, data0, lines_tab, rw_ids.long()),
                 lines),
                ("data", (last, lines, data0[:0], data0),
                 final.data.reshape(-1, elems)),
                ("table", (row_src, payload, data0, lines_tab), table)):
            out = cl_kernel.row_resolve(*call)
            assert same_bits(out, cl_kernel.row_resolve_plain(*call)), \
                f"row_resolve {what}, {policy}"
            assert same_bits(out, engine), f"row_resolve {what}, {policy}: " \
                "not the engine's"
        ops, kernels = profiled_names(lambda: simulate_trace_rw(
            warm, rw_ids, rw, payload, lines_tab, config=cfg,
            engine="parallel"))
        assert "aten::sort" in ops, f"{policy}: no host ops traced"
        for part in PLAIN_RESOLVE_OPS:
            assert not any(part in x for x in ops | kernels), \
                f"rw {policy}: {part} ran: {sorted(ops | kernels)}"


def cache_trace_inputs(dev, table) -> dict:
    """The cache_trace path's inputs on ``dev``: ``table`` (the embedding
    table) as 512-byte lines, sequence 0's token lines (``ids``), the
    read/write trace of ``rw_trace`` (``rw_ids``, ``rw``) with bf16
    payloads from seed 0, the empty state at the Table I maximum cache
    and that cache under each write policy."""
    rw_ids, rw = (torch.from_numpy(a).to(dev) for a in rw_trace())
    return dict(
        lines_tab=table.view(-1, line_elems()),
        ids=torch.from_numpy(token_lines(prefill_ids()[0])).to(dev),
        rw_ids=rw_ids, rw=rw,
        payload=torch.randn((rw_ids.numel(), line_elems()), device=dev,
                            dtype=torch.bfloat16, generator=torch.Generator(
                                device=dev).manual_seed(SEED)),
        state0=init_cache(CACHE_CFG, line_elems(), torch.bfloat16,
                          device=dev),
        configs={policy: dataclasses.replace(CACHE_CFG, write_policy=policy)
                 for policy in ("write_back", "write_through")})


def run_cache_trace(dev, table) -> dict:
    """Phase 4, cache_trace path: the set-parallel cache engine on the card
    (``simulate_trace`` and ``simulate_trace_rw``, ``engine="parallel"``
    and ``"auto"``) at the Table I maximum cache over the embedding table
    as 512-byte lines: sequence 0's token lines read from ``init_cache``,
    then the read/write trace of ``rw_trace`` from the state that left,
    under write-back and write-through. Held to the same calls on CPU
    copies of the inputs (the plain engine), to ``hit_rate_oracle`` and
    ``filter_trace_rw`` (hits and victim write-backs), to the sequential
    walk on the CPU over a prefix, and ``"auto"`` to ``"parallel"``."""
    inputs = cache_trace_inputs(dev, table)
    lines_tab, ids, rw_ids, rw, payload, state0, configs = (
        inputs[k] for k in ("lines_tab", "ids", "rw_ids", "rw", "payload",
                            "state0", "configs"))
    ids_np, rw_ids_np, rw_np = (a.cpu().numpy() for a in (ids, rw_ids, rw))
    sets = CACHE_CFG.num_sets
    kernels = ("cache_lookup", "cache_probe_rw", "row_resolve")
    runs, seconds, launched = {}, {}, {}

    def drive(name, fn):
        before = {k: LIBS[k].launches for k in kernels}
        t0 = time.perf_counter()
        runs[name] = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launched[name] = {k: LIBS[k].launches - before[k] for k in kernels}

    torch.cuda.synchronize()
    zero_launches()
    for engine in ("parallel", "auto"):
        drive(f"read {engine}", lambda: simulate_trace(
            state0, ids, lines_tab, engine=engine))
    warm = runs["read parallel"][0]
    for policy, cfg in configs.items():
        for engine in ("parallel", "auto"):
            drive(f"rw {policy} {engine}", lambda: simulate_trace_rw(
                warm, rw_ids, rw, payload, lines_tab, config=cfg,
                engine=engine))
    launches = read_launches("cache_trace")
    assert launches["cache_lookup"] > 0, "B5 did not run on the read trace"
    assert launched["read auto"] == {"cache_lookup": 1, "cache_probe_rw": 0,
                                     "row_resolve": 1}
    for policy in configs:
        assert launched[f"rw {policy} auto"] == {"cache_lookup": 0,
                                                 "cache_probe_rw": 1,
                                                 "row_resolve": 3}
        same_run(runs[f"rw {policy} auto"], runs[f"rw {policy} parallel"],
                 f"rw {policy}: auto against parallel")
    same_run(runs["read auto"], runs["read parallel"],
             "read: auto against parallel")

    check_value_sources(dev, lines_tab, warm, rw_ids, rw, payload, configs,
                        runs)

    # The plain engine on CPU copies of the same inputs.
    tab_cpu, st0_cpu = lines_tab.cpu(), cpu_state(state0)
    read_cpu = simulate_trace(st0_cpu, ids.cpu(), tab_cpu, engine="parallel")
    same_run(runs["read parallel"], read_cpu, "read: card against the CPU")
    want_hits, hit_rate = hit_rate_oracle(CACHE_CFG, ids_np)
    assert np.array_equal(runs["read parallel"][1].cpu().numpy(),
                          want_hits), "read hits != hit_rate_oracle"
    warm_cpu = read_cpu[0]
    both_ids = np.concatenate([ids_np, rw_ids_np])
    both_rw = np.concatenate([np.zeros_like(ids_np), rw_np]).astype(np.int32)
    rw_hit_rate, writebacks = {}, {}
    written = (np.unique(rw_ids_np[rw_np == WRITE]), rw_ids_np.size)
    for policy, cfg in configs.items():
        got = runs[f"rw {policy} parallel"]
        same_run(got, simulate_trace_rw(
            warm_cpu, rw_ids.cpu(), rw.cpu(), payload.cpu(), tab_cpu,
            config=cfg, engine="parallel"), f"rw {policy}: card against CPU")
        # The filter sees the read trace first: it starts from no state.
        f = filter_trace_rw(cfg, both_ids, both_rw)
        assert np.array_equal(got[2].cpu().numpy(), f.hits[ids_np.size:]), \
            f"rw {policy}: hits != filter_trace_rw"
        assert f.n_writebacks == 0 or int(f.wb_pos.min()) >= ids_np.size
        # The table: each line the filter lists as a victim holds the last
        # write to it before its last eviction (write-back), each written
        # line its last write (write-through); every other row is as it
        # was. After a flush of the final state, the in-order write stream.
        if policy == "write_back":
            victims = np.stack([f.wb_line, f.wb_pos - ids_np.size])
            victims = victims[:, np.lexsort(victims[::-1])]
            last = np.append(victims[0, 1:] != victims[0, :-1], True)
            victims = victims[:, last]
            assert same_bits(got[1], table_after(
                lines_tab, payload, *victims, rw_ids_np, rw_np)), \
                f"rw {policy}: table != filter_trace_rw's write-backs"
            got = flush(got[0], got[1])
        assert same_bits(got[1], table_after(lines_tab, payload, *written,
                                             rw_ids_np, rw_np)), \
            f"rw {policy}: table != the in-order write stream"
        got = runs[f"rw {policy} parallel"]
        rw_hit_rate[policy] = float(got[2].float().mean())
        writebacks[policy] = f.n_writebacks

    # The sequential walk on the CPU over a prefix of each trace.
    k = SEQ_PREFIX
    same_run(simulate_trace(state0, ids[:k], lines_tab, engine="parallel"),
             simulate_trace(st0_cpu, ids.cpu()[:k], tab_cpu,
                            engine="sequential"), "read prefix")
    for policy, cfg in configs.items():
        same_run(simulate_trace_rw(warm, rw_ids[:k], rw[:k], payload[:k],
                                   lines_tab, config=cfg,
                                   engine="parallel"),
                 simulate_trace_rw(warm_cpu, rw_ids.cpu()[:k], rw.cpu()[:k],
                                   payload.cpu()[:k], tab_cpu, config=cfg,
                                   engine="sequential"),
                 f"rw {policy} prefix")
    del read_cpu, tab_cpu

    syncs = {"read parallel": host_syncs(lambda: simulate_trace(
        state0, ids, lines_tab, engine="parallel")),
        "read auto": host_syncs(lambda: simulate_trace(
            state0, ids, lines_tab, engine="auto"))}
    for policy, cfg in configs.items():
        for engine in ("parallel", "auto"):
            syncs[f"rw {policy} {engine}"] = host_syncs(
                lambda: simulate_trace_rw(warm, rw_ids, rw, payload,
                                          lines_tab, config=cfg,
                                          engine=engine))
    return dict(
        lines_tab=lines_tab, ids=ids, rw_ids=rw_ids, rw=rw, payload=payload,
        state0=state0, warm=warm, configs=configs, launches=launches,
        seconds=seconds, host_syncs={k: len(v) for k, v in syncs.items()},
        hit_rate=hit_rate, rw_hit_rate=rw_hit_rate, writebacks=writebacks,
        beats={"read": ids.numel(), "rw": rw_ids.numel()},
        max_beats_per_set={
            "read": int(np.bincount(ids_np % sets).max()),
            "rw": int(np.bincount(rw_ids_np % sets).max())})


def timings_engine(ct, reps: int = 3) -> dict:
    """Each cache_trace engine call (``engine="parallel"``: the read trace
    from ``state0``, the read/write trace from ``warm`` under each
    policy): its device time and launches from a profiler trace of
    ``reps`` calls, the probes' and the row resolve's own device time in
    it, the kernels that took most, the host time (median of ``reps``
    calls, each ended by a synchronize), the host syncs and the call's
    byte bound. Public entry points only, so ``kernel_repeat.py`` runs it
    on another version of the package too."""
    lines_tab, warm, state0 = ct["lines_tab"], ct["warm"], ct["state0"]
    ids, rw_ids, rw, payload = ct["ids"], ct["rw_ids"], ct["rw"], \
        ct["payload"]
    calls = {"read parallel": lambda: simulate_trace(
        state0, ids, lines_tab, engine="parallel")}
    for policy, cfg in ct["configs"].items():
        calls[f"rw {policy} parallel"] = lambda cfg=cfg: simulate_trace_rw(
            warm, rw_ids, rw, payload, lines_tab, config=cfg,
            engine="parallel")
    engine = {}
    for name, call in calls.items():
        trace = device_trace(call, reps=reps)
        host = []
        for _ in range(reps):
            _, seconds = timed(lambda: (call(), torch.cuda.synchronize()))
            host.append(seconds * 1e3)
        engine[name] = dict(
            device_ms=trace["ms"], device_launches_per_call=trace["launches"],
            bound_ms=engine_bytes(ct, name) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes",
            probe_device_ms=kernels_ms(trace, "cache_probe_kernel"),
            probe_rw_device_ms=kernels_ms(trace, "cache_probe_rw_kernel"),
            row_resolve_device_ms=kernels_ms(trace, "row_resolve_kernel"),
            top_kernels_ms=dict(collections.Counter(
                trace["ms_by_kernel"]).most_common(6)),
            host_ms=statistics.median(host),
            host_syncs=len(host_syncs(call)))
    return engine


def timings_cache_trace(dev, ct) -> dict:
    """Phase 5 at the cache_trace path: each engine call's device time and
    its kernels' own (from a profiler trace), and ``cache_probe_rw``
    alone: its wrapper, device time, plain version and bound."""
    lines_tab, warm = ct["lines_tab"], ct["warm"]
    rw_ids, rw = ct["rw_ids"], ct["rw"]
    engine = timings_engine(ct)
    sets, ways = warm.tags.shape
    n = rw_ids.numel()
    rows = lines_tab.shape[0]
    args = (rw_ids, rw, warm.tags, warm.valid.to(torch.int32), warm.age,
            warm.dirty.to(torch.int32), warm.clock)
    call = lambda: cl_kernel.cache_probe_rw(*args, write_back=True,
                                            rows=rows)
    trace = device_trace(call)
    row = dict(
        ms=time_ms(call), device_ms=trace["ms"],
        device_launches_per_call=trace["launches"],
        kernel_device_ms=kernels_ms(trace, "cache_probe_rw_kernel"),
        keys_device_ms=kernels_ms(trace, "row_keys_to_src_kernel"),
        library_ms=None,
        bound_ms=probe_rw_bytes(n, sets, ways, rows) / HBM_BYTES_PER_S
        * 1e3,
        bound_by="bytes", host_syncs=len(host_syncs(call)),
        max_beats_per_set=ct["max_beats_per_set"]["rw"],
        plain_ms=time_ms(lambda: cl_kernel.cache_probe_rw_plain(
            *args, write_back=True, rows=rows), reps=3),
        engine=engine)
    return {f"probe_rw {n} beats, {sets} sets x {ways} ways": row}


def timings_row_resolve(dev, ct) -> dict:
    """Phase 5, ``row_resolve`` at the cache_trace path's three calls
    under write-back (the new table, the served lines, the Data RAM):
    the wrapper's CUDA-event median, its device time and launches from a
    profiler trace, the kernel's own, the plain version and the bound
    (each output row written once, each row it copies and each index
    read once). The table's call comes first: it is the engine's bound."""
    lines_tab, warm = ct["lines_tab"], ct["warm"]
    rows, elems = lines_tab.shape
    row_bytes = elems * lines_tab.element_size()
    rw_ids, payload = ct["rw_ids"], ct["payload"]
    src, _, last, row_src = cl_kernel.cache_probe_rw(
        rw_ids, ct["rw"], warm.tags, warm.valid.to(torch.int32), warm.age,
        warm.dirty.to(torch.int32), warm.clock, write_back=True,
        rows=rows)[9:]
    data0 = warm.data.reshape(-1, elems)
    lines = cl_kernel.row_resolve(src, payload, data0, lines_tab,
                                  rw_ids.long())
    calls = {
        f"table {rows} x {row_bytes} B": ((row_src, payload, data0,
                                           lines_tab), 8),
        f"lines {src.numel()} x {row_bytes} B": (
            (src, payload, data0, lines_tab, rw_ids.long()), 16),
        f"data RAM {last.numel()} x {row_bytes} B": (
            (last, lines, data0[:0], data0), 8)}
    out = {}
    for shape, (args, index_bytes) in calls.items():
        call = lambda args=args: cl_kernel.row_resolve(*args)
        trace = device_trace(call)
        k = args[0].numel()
        out[shape] = dict(
            ms=time_ms(call), device_ms=trace["ms"],
            device_launches_per_call=trace["launches"],
            kernel_device_ms=kernels_ms(trace, "row_resolve_kernel"),
            library_ms=None,
            bound_ms=k * (2 * row_bytes + index_bytes) / HBM_BYTES_PER_S
            * 1e3, bound_by="bytes",
            plain_ms=time_ms(lambda args=args: cl_kernel.row_resolve_plain(
                *args), reps=3))
    # A yardstick, not the same function: the table's plain copy.
    out[next(iter(calls))]["clone_ms"] = time_ms(lines_tab.clone)
    return out


# ---------------------------------------------------------------------------
# The simulate phase: the port's modeled-timing simulator, numpy on the host
# ---------------------------------------------------------------------------
# Fig. 7's method, copied from benchmarks/fig7_workloads.py and
# benchmarks/fig7_write_workloads.py (which import the reference package)
# onto the port's simulator, with their Zipf draws made by zipf_draws;
# BENCH_fig7.json and BENCH_fig7_write.json hold the reference's records
# of it.
FIG7_NUM_PES = 8                 # concurrent PE request streams
# The scheduler path's batch as row reads of yi-34b's bf16 embedding row.
SIM_ROW_BYTES = D_MODEL * 2


def _interleave(streams):
    """Round-robin interleave request streams (parallel PEs)."""
    maxlen = max(len(s) for s in streams)
    out = []
    for i in range(maxlen):
        for s in streams:
            if i < len(s):
                out.append(s[i])
    return np.asarray(out, np.int64)


def zipf_draws(rng, a: float, n: int) -> np.ndarray:
    """``rng.zipf(a, n)`` as numpy 2.0's ``Generator`` draws it (the
    rejection loop of its ``random_zipf``), from ``rng.random()`` alone.
    Later numpy releases draw another stream for the same seed, and the
    BENCH files hold numpy 2.0's; the bit generator's own stream is
    stable across releases. Scalar ``math.pow`` is the C library's
    ``pow``, as in numpy's C loop (for ``a`` above about 1.06)."""
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    out = np.empty(n, np.int64)
    i = 0
    while i < n:
        u = 1.0 - rng.random()
        v = rng.random()
        x = float(math.floor(math.pow(u, -1.0 / am1)))
        if x > 2.0 ** 63 or x < 1.0:        # (double) INT64_MAX
            continue
        t = math.pow(1.0 + 1.0 / x, am1)
        if v * x * (t - 1.0) / (b - 1.0) <= t / b:
            out[i] = int(x)
            i += 1
    return out


def fig7_gcn_trace(rng):
    n_vertices = 1600
    n_edges = 240_000 // 4          # edge visits sampled
    feat_bytes = 4096               # 1024 features x 4B
    adj_bytes = 256
    feat_base = 1 << 26
    # adjacency reads: Zipf-popular vertices (reusable across PEs)
    adj_v = (zipf_draws(rng, 1.2, n_edges) - 1) % n_vertices
    adj_addrs = adj_v * adj_bytes
    # feature fetches: destination vertices of edges (random)
    feat_v = rng.integers(0, n_vertices, n_edges // 16)
    feat_addrs = feat_base + feat_v * feat_bytes
    return adj_addrs, feat_addrs, feat_bytes


def fig7_cnn_trace(rng):
    """ResNet input layer, 227x227 images (paper §V-C): the cache engine
    serves image-window reads and the DMA engine streams kernel
    weights."""
    img, k, stride = 227, 7, 2
    row_bytes = img * 4             # one image row, one channel
    img_base = 0
    w_base = 1 << 26
    w_transfer = 16 * 1024          # filter-bank stream per output tile
    cache_reqs = []
    for y in range(0, img - k, stride):         # full output grid
        for x in range(0, img - k, stride):
            for ky in range(k):                 # one line read per kernel row
                cache_reqs.append(img_base + (y + ky) * row_bytes + x * 4)
    cache_addrs = np.asarray(cache_reqs, np.int64)
    n_tiles = 220                               # filter re-streams
    w_addrs = w_base + (np.arange(n_tiles) % 8) * w_transfer
    return cache_addrs, w_addrs, w_transfer


def fig7_workload(cache_addrs, bulk_addrs, bulk_bytes) -> dict:
    """One Fig. 7 workload: the MIG-like and FIFO baselines against the
    controller (cache engine, scheduled misses, DMA streams)."""
    cfg = PAPER_EVAL_CONFIG
    t = DDR4_2400
    bulk_expanded = [a + np.arange(0, bulk_bytes, 64) for a in bulk_addrs]
    streams = []
    for pe in range(FIG7_NUM_PES - 1):
        streams.append(np.concatenate(bulk_expanded[pe::FIG7_NUM_PES - 1])
                       if bulk_expanded[pe::FIG7_NUM_PES - 1] else
                       np.empty(0, np.int64))
    streams.append(cache_addrs)
    base_stream = _interleave(streams)
    base_fifo = simulate_dram_access_windowed(base_stream, t,
                                              window=1).total_fpga_cycles
    base = simulate_dram_access_windowed(base_stream, t,
                                         window=4).total_fpga_cycles
    line_ids = cache_addrs // cfg.cache.line_bytes
    hits, hit_rate = hit_rate_oracle(cfg.cache, line_ids)
    misses = cache_addrs[~hits]
    served = schedule_trace(misses, np.zeros(len(misses), np.int32),
                            config=cfg.scheduler, timings=t)
    cache_cycles = (simulate_dram_access(served, t).total_fpga_cycles
                    + hits.sum() * 1.0 + cfg.ctrl_overhead_cycles)
    dma_cycles = simulate_dram_access(
        np.concatenate(bulk_expanded) if bulk_expanded
        else np.empty(0, np.int64), t).total_fpga_cycles
    ctrl = cache_cycles + dma_cycles
    improvement = 1 - ctrl / base
    improvement_fifo = 1 - ctrl / base_fifo
    return {
        "improvement_vs_mig": round(improvement, 4),
        "improvement_vs_fifo": round(improvement_fifo, 4),
        "controller_cycles": round(ctrl),
        "baseline_mig_cycles": round(base),
        "baseline_fifo_cycles": round(base_fifo),
        "cache_hit_rate": round(hit_rate, 4),
        "dma_share": round(dma_cycles / ctrl, 4),
    }


def fig7w_embedding_grad_trace(rng, vocab=50_000, n_tokens=20_000,
                               row_bytes=4096, num_pes=8):
    """Read-modify-write per token over a Zipf vocabulary, issued by
    ``num_pes`` workers whose streams interleave at the controller."""
    tok = (zipf_draws(rng, 1.3, n_tokens) - 1) % vocab
    addrs = tok * row_bytes
    per_a = [np.repeat(addrs[p::num_pes], 2) for p in range(num_pes)]
    per_rw = [np.tile(np.array([READ, WRITE], np.int32), a.shape[0] // 2)
              for a in per_a]
    keys = np.concatenate([np.sort(rng.random(a.shape[0])) for a in per_a])
    order = np.argsort(keys, kind="stable")
    return (np.concatenate(per_a)[order].astype(np.int64),
            np.concatenate(per_rw)[order])


def fig7w_kv_append_trace(rng, batch=32, steps=256, page_bytes=2048,
                          reads_per_step=4):
    """Interleaved per-sequence appends + strided cache read sweeps."""
    seq_base = (np.arange(batch, dtype=np.int64) << 24)
    addrs, rw = [], []
    for t in range(steps):
        for b in range(batch):
            if t:
                pages = rng.integers(0, t, min(reads_per_step, t))
                for p in pages:
                    addrs.append(seq_base[b] + p * page_bytes)
                    rw.append(READ)
            addrs.append(seq_base[b] + t * page_bytes)
            rw.append(WRITE)
    return (np.asarray(addrs, np.int64),
            np.asarray(rw, np.int32))


def fig7w_workload(addrs: np.ndarray, rw: np.ndarray) -> dict:
    """One Fig. 7-write workload: the scheduler on against off."""
    cfg = PAPER_EVAL_CONFIG
    t = DDR4_2400
    off = simulate_dram_access(addrs, t, rw=rw)
    served, served_rw = schedule_trace_rw(
        addrs, rw, config=cfg.scheduler, timings=t, coalesce_writes=True)
    on = simulate_dram_access(served, t, rw=served_rw)
    improvement = 1 - on.total_fpga_cycles / off.total_fpga_cycles
    n_flips = int((rw[1:] != rw[:-1]).sum())
    n_flips_served = int((served_rw[1:] != served_rw[:-1]).sum())
    return {
        "improvement_sched_on_vs_off": round(improvement, 4),
        "on_cycles": round(on.total_fpga_cycles),
        "off_cycles": round(off.total_fpga_cycles),
        "writes_coalesced": int(addrs.shape[0] - served.shape[0]),
        "row_hit_rate_on": round(on.hit_rate, 4),
        "row_hit_rate_off": round(off.hit_rate, 4),
        "bus_turnarounds_before": n_flips,
        "bus_turnarounds_after": n_flips_served,
    }


def fig7_records() -> tuple[dict, dict]:
    """The records of ``BENCH_fig7.json`` and ``BENCH_fig7_write.json``,
    computed by the port's simulator."""
    rng = np.random.default_rng(0)
    adj, feat, fb = fig7_gcn_trace(rng)
    gcn = fig7_workload(adj, feat, fb)
    w, inp, ib = fig7_cnn_trace(rng)
    cnn = fig7_workload(w, inp, ib)
    fig7 = {"benchmark": "fig7_modeled_access_time",
            "paper_claim": {"gcn_inference": 0.27, "cnn_inference": 0.58},
            "workloads": {"gcn_inference": gcn, "cnn_inference": cnn}}
    rng = np.random.default_rng(0)
    eg = fig7w_workload(*fig7w_embedding_grad_trace(rng))
    kv = fig7w_workload(*fig7w_kv_append_trace(rng))
    fig7w = {"benchmark": "fig7_write_modeled_access_time",
             "workloads": {"embedding_grad": eg, "kv_append": kv}}
    return fig7, fig7w


def same_result(a, b, where="result") -> None:
    """Two simulator results equal field for field (``==``; arrays by
    dtype and value)."""
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            same_result(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same_result(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_result(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# Lifecycle tracing's two-tenant case: a latency tenant's bursts of Zipf
# reads against a sequential hog, weighted 4:1 arbitration, FR-FCFS with a
# starvation cap and refresh, scheduler and cache off (the reference's
# ``serving_hog_victim_weighted`` golden case).
HOG_VICTIM_CONFIG = dataclasses.replace(
    PAPER_EVAL_CONFIG, num_pes=2,
    scheduler=SchedulerConfig(enabled=False),
    cache=CacheConfig(enabled=False),
    dram_sched=DRAMSchedConfig(policy="frfcfs_cap", reorder_window=32,
                               starvation_cap=8, t_rfc=420, t_refi=9363))


# A traced run's DRAM stage goes through the event-emitting command model
# even where the untraced one takes the FIFO model (the reference's does
# too): its per-channel results are then the command model's subclass of
# the FIFO result, and its info also names the policy, the window and the
# refreshes.
TRACED_INFO = {"sched_policy", "reorder_window", "n_refreshes"}


def same_traced(a, b, where: str = "result") -> None:
    """A traced ``simulate`` result ``a`` equal to the untraced ``b`` field
    for field (``==``), on ``b``'s fields: where ``a`` holds a subclass of
    ``b``'s result type, its added fields are not compared, and a stage's
    info may add ``TRACED_INFO``."""
    if dataclasses.is_dataclass(b):
        assert isinstance(a, type(b)), (where, type(a), type(b))
        for f in dataclasses.fields(b):
            same_traced(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(b, dict):
        assert b.keys() <= a.keys() and a.keys() - b.keys() <= TRACED_INFO, \
            (where, a.keys() ^ b.keys())
        for k in b:
            same_traced(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_traced(x, y, f"{where}[{i}]")
    else:
        same_result(a, b, where)


def check_tracing(ids: np.ndarray) -> dict:
    """Lifecycle tracing on the simulator: ``simulate(..., trace=...)`` on
    the scheduler path's batch, on Fig. 7's GCN adjacency reads and on the
    hog/victim stream equals the untraced call field for field
    (``same_traced``); on the hog/victim stream the cycle
    attribution's components sum, left to right, to each request's
    sojourn bit for bit, and its Chrome trace passes the validator.
    Returns host seconds and counts."""
    mc = MemoryController(PAPER_EVAL_CONFIG)
    adj = fig7_gcn_trace(np.random.default_rng(0))[0] // 256
    out = {}
    for name, rows, row_bytes in (("batch", ids, SIM_ROW_BYTES),
                                  ("gcn", adj, 256)):
        rec = TraceRecorder()
        traced, traced_s = timed(lambda: mc.simulate(
            None, rows, None, row_bytes=row_bytes, trace=rec))
        same_traced(traced, mc.simulate(None, rows, None,
                                        row_bytes=row_bytes), name)
        assert rec.n_events > 0, f"{name}: no event recorded"
        out[name] = dict(traced_s=traced_s, events=rec.n_events)
    rows, rw, pe, arr = hog_victim_workload(
        np.random.default_rng(4), n_victim=600, n_hog=2400,
        victim_rate=0.01, hog_rate=0.12)
    hog = MemoryController(HOG_VICTIM_CONFIG)
    rec = TraceRecorder()
    res, res_s = timed(lambda: hog.simulate(
        pe, rows, rw, 4096, arbiter_policy="weighted", weights=(4, 1),
        arrival_cycle=arr, trace=rec))
    same_traced(res, hog.simulate(pe, rows, rw, 4096,
                                  arbiter_policy="weighted", weights=(4, 1),
                                  arrival_cycle=arr), "hog_victim")
    att = CycleAttribution.from_pipeline(res, rec)
    assert np.array_equal(att.ltr_sum(), res.serving.sojourn_fpga_cycles), \
        "attribution components do not sum to the sojourns"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hog_victim.trace.json")
        counts = tracing.write_chrome_trace(path, rec)
        with open(path) as f:
            assert tracing.validate_chrome_trace(json.load(f)) == counts
    tot = att.totals()
    out["hog_victim"] = dict(
        traced_s=res_s, events=rec.n_events, chrome_trace=counts,
        requests=att.n, dominant=max(COMPONENTS, key=tot.get),
        totals=tot)
    return out


def run_simulate() -> dict:
    """The simulate phase: Fig. 7 and Fig. 7-write at the benchmark's
    size, held to the BENCH files on disk, then the scheduler path's own
    batch (8 x 4096 Zipf ids) as row reads of yi-34b's row through
    ``simulate`` and ``modeled_gather_time``, each called twice, and the
    DRAM models on its scheduled trace held to their ``*_seq`` oracles.
    Host work only: no kernel may launch."""
    zero_launches()
    (fig7, fig7w), fig7_s = timed(fig7_records)
    for got, name in ((fig7, "BENCH_fig7.json"),
                      (fig7w, "BENCH_fig7_write.json")):
        with open(os.path.join(ROOT, name)) as f:
            want = json.load(f)
        assert got == want, f"{name}: {got} != {want}"

    mc = MemoryController(PAPER_EVAL_CONFIG)
    ids = prefill_ids()
    sim, sim_s = timed(lambda: mc.simulate(None, ids, None,
                                           row_bytes=SIM_ROW_BYTES))
    sim2, sim2_s = timed(lambda: mc.simulate(None, ids, None,
                                             row_bytes=SIM_ROW_BYTES))
    same_result(sim, sim2, "simulate")
    gat, gat_s = timed(lambda: mc.modeled_gather_time(ids, SIM_ROW_BYTES))
    gat2, gat2_s = timed(lambda: mc.modeled_gather_time(ids, SIM_ROW_BYTES))
    same_result(gat, gat2, "modeled_gather_time")

    t = DDR4_2400
    addrs = ids.reshape(-1).astype(np.int64) * SIM_ROW_BYTES
    served = schedule_trace(addrs, np.zeros(addrs.size, np.int32),
                            config=PAPER_EVAL_CONFIG.scheduler, timings=t)
    sched, sched_s = timed(lambda: simulate_dram_sched(
        served, t, PAPER_EVAL_CONFIG.dram_sched))
    sched_seq, sched_seq_s = timed(lambda: simulate_dram_sched_seq(
        served, t, PAPER_EVAL_CONFIG.dram_sched))
    same_result(sched, sched_seq, "simulate_dram_sched")
    win, win_s = timed(lambda: simulate_dram_access_windowed(served, t))
    win_seq, win_seq_s = timed(
        lambda: simulate_dram_access_windowed_seq(served, t))
    same_result(win, win_seq, "simulate_dram_access_windowed")
    traced = check_tracing(ids)
    launches = {name: lib.launches for name, lib in LIBS.items()}
    assert not any(launches.values()), f"a kernel launched: {launches}"
    return dict(
        fig7={k: v["controller_cycles"] for k, v in
              fig7["workloads"].items()},
        fig7_improvement_vs_mig={k: v["improvement_vs_mig"] for k, v in
                                 fig7["workloads"].items()},
        fig7_write_on_off={k: [v["on_cycles"], v["off_cycles"]] for k, v in
                           fig7w["workloads"].items()},
        fig7_s=fig7_s, numpy=np.__version__, requests=int(ids.size),
        row_bytes=SIM_ROW_BYTES,
        makespan_fpga_cycles=sim.makespan_fpga_cycles,
        breakdown=sim.breakdown(), cache_hit_rate=sim.cache_hit_rate,
        gather_fpga_cycles=gat.total_fpga_cycles,
        gather_row_hit_rate=gat.hit_rate,
        simulate_s=[sim_s, sim2_s], modeled_gather_time_s=[gat_s, gat2_s],
        dram_sched_s=sched_s, dram_sched_seq_s=sched_seq_s,
        windowed_s=win_s, windowed_seq_s=win_seq_s, tracing=traced,
        launches=launches)


def attention_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the mask leaves live in one (batch, head): the
    work the attention function needs on these inputs."""
    q = np.arange(S)
    hi = q + 1 if causal else np.full(S, S)
    lo = np.zeros(S, np.int64) if window is None else np.maximum(
        0, q - window + 1)
    return int((hi - lo).sum())


def attention_inputs(gen, dev, shape, dtype):
    B, S, H, KV, hd = shape
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def check_attention(dev, gen) -> dict:
    """B6 against its plain version on the card. float32 inputs (the
    CUDA-core kernel): within the reference's rtol = atol = 3e-5. bf16 and
    f16 inputs (the tensor-core kernel): it computes in float32 and rounds
    once, so its result must be bit-equal to its own float32 output on the
    same inputs (``out_dtype=torch.float32``) rounded once, and that
    within 3e-5 of the plain version's result on the inputs converted to
    float32 (exact); the raw disagreement with the plain low-precision
    result is reported in ulps (one ulp where the error is largest; many
    ulps of a result that cancels to near zero, where float32 summation
    order alone decides the last bits)."""
    out = {}
    for name, shape, dtype, causal, window in ATTN_CASES:
        q, k, v = attention_inputs(gen, dev, shape, dtype)
        kw = dict(causal=causal, window=window)
        got = fa_kernel.flash_attention_fwd(q, k, v, **kw)
        want = fa_kernel.flash_attention_plain(q, k, v, **kw)
        assert got.shape == want.shape and got.dtype == dtype, name
        assert bool(torch.isfinite(got).all()), f"attention {name}: non-finite"
        row = dict(max_abs_err=float((got.double() - want.double()).abs()
                                     .max()))
        if dtype == torch.float32:
            assert torch.allclose(got, want, rtol=3e-5, atol=3e-5), \
                f"attention {name}: beyond 3e-5"
        else:
            got32 = fa_kernel.flash_attention_fwd(
                q, k, v, out_dtype=torch.float32, **kw)
            want32 = fa_kernel.flash_attention_plain(q.float(), k.float(),
                                                     v.float(), **kw)
            assert same_bits(got, got32.to(dtype)), \
                f"attention {name}: not its float32 result rounded once"
            assert torch.allclose(got32, want32, rtol=3e-5, atol=3e-5), \
                f"attention {name}: float32 results beyond 3e-5"
            diff = (got.double() - want.double()).abs().reshape(-1)
            at = int(diff.argmax())
            ulps_at = ulps(got.reshape(-1)[at:at + 1],
                           want.reshape(-1)[at:at + 1])
            assert ulps_at <= 1.0, f"attention {name}: {ulps_at} ulps"
            row.update(plain_there=float(want.reshape(-1)[at]),
                       ulps_there=ulps_at, max_ulps=ulps(got, want),
                       f32_max_abs_err=float((got32.double() - want32.double())
                                             .abs().max()))
        out[name] = row
        del q, k, v, got, want
    # bf16 rows that do not start 16-byte aligned (views at a 2-byte
    # offset) are copied for the tensor-core kernel: the same result.
    q, k, v = attention_inputs(gen, dev, (2, 130, 8, 2, 64), torch.bfloat16)
    views = [torch.cat([t[..., :1], t], dim=-1)[..., 1:] for t in (q, k, v)]
    assert not any(fa_kernel._aligned(t) for t in views)
    assert same_bits(fa_kernel.flash_attention_fwd(*views),
                     fa_kernel.flash_attention_fwd(q, k, v)), \
        "attention of misaligned views"
    torch.cuda.synchronize()
    return out


def timings_attention(dev, gen) -> dict:
    """Phase 5, B6 at the serve path's prefill shape: the kernel, its plain
    version and ``scaled_dot_product_attention`` (in its (B, H, S, hd)
    layout), beside the bound: the two products' FLOPs over the bf16
    tensor-core rate, or q, k, v and o over the memory rate."""
    B, S, H, KV, hd = ATTN_SHAPE
    q, k, v = attention_inputs(gen, dev, ATTN_SHAPE, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    flops = 4 * B * H * hd * attention_pairs(S, True, None)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = flops / TENSOR_BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    call = lambda: fa_kernel.flash_attention_fwd(q, k, v)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    row = dict(
        ms=time_ms(call), device_ms=device_trace(call)["ms"],
        plain_ms=time_ms(lambda: fa_kernel.flash_attention_plain(q, k, v)),
        library_ms=time_ms(lib), library_device_ms=device_trace(lib)["ms"],
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        flops=flops, bytes=nbytes)
    return {f"{B}x{S} tokens, {H}/{KV} heads, hd {hd}, bf16, causal": row}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def serve_drift(lm, params, prompts, tok, max_len, full, step) -> dict:
    """Where the serve checks' differences come from, layer by layer, on
    the prompts and the greedy token. Four walks of the layers: the
    cache-free forward with kernels off (``plain``), on (``kernels``), and
    off with the plain attention's key blocks a quarter as long
    (``reordered``: the same function with its float32 sums in another
    order, a control), and the decode step after a prefill with kernels
    on (``decode``, one position). Per layer, max |diff| over max
    |reference|: ``attn_b6`` B6's attention block against the plain one on
    the same input (the plain walk's), ``attn_decode`` the decode step's
    attention block against B6's at the last position on the same input
    (the kernels walk's), ``resid_kernels`` and ``resid_reordered`` the
    residual stream after the layer against the plain walk's (all
    positions; ``resid_kernels_last`` the last one), ``resid_decode`` the
    decode step's against the kernels walk's last position;
    ``attn_b6_ulps`` is ``attn_b6`` counted as max |diff| in bf16 ulps of
    the plain block's largest magnitude, with its worst layer. ``logits_*``
    compare the last position's logits the same way, and the two
    ``*_is_*`` flags say whether the walks reproduce the entry points'
    bits: ``full``, the last position of ``forward``, and ``step``, the
    decode step's logits."""
    cfg = lm.cfg
    cfgs = {"plain": dataclasses.replace(cfg, use_kernels=False),
            "kernels": cfg,
            "reordered": dataclasses.replace(
                cfg, use_kernels=False, attn_kv_block=cfg.attn_kv_block // 4)}
    tokens = torch.cat([prompts, tok[:, None]], dim=1)
    x0, _ = lm._embed_inputs(params, {"tokens": tokens})
    pos = lm._positions(x0)
    xs = dict.fromkeys(cfgs, x0)
    _, cache, cur = lm.prefill(params, {"tokens": prompts}, max_len)
    kvs = cache["pos0"]["attn"]
    xd = layers.mc_embed(params["embed"]["table"], tok, cfg.mc,
                         use_kernels=cfg.use_kernels)
    out = collections.defaultdict(list)
    for l in range(cfg.num_layers):
        bp = map_tree(lambda t: t[l], params["layers"]["pos0"])
        c = type(kvs)(*(t[l] for t in kvs))
        attn = {n: blocks.attn_forward(bp["attn"], xs[n], cf, pos)[0]
                for n, cf in cfgs.items()}
        b6 = blocks.attn_forward(bp["attn"], xs["plain"], cfg, pos)[0]
        out["attn_b6"].append(rel_err(b6, attn["plain"]))
        out["attn_b6_ulps"].append(block_ulps(b6, attn["plain"]))
        del b6
        # The same input's K/V goes into the cache's slot cur first; the
        # decode walk's own then overwrites it.
        last = xs["kernels"][:, -1]
        one = blocks.attn_decode(bp["attn"], last, c, cur, cfg)[0]
        out["attn_decode"].append(rel_err(one, attn["kernels"][:, -1]))
        one = blocks.attn_decode(bp["attn"], xd, c, cur, cfg)[0]
        for n in cfgs:
            x = xs[n] + attn[n]
            xs[n] = x + blocks.mlp_forward(bp["mlp"], x)
        del attn
        x = xd + one
        xd = x + blocks.mlp_forward(bp["mlp"], x[:, None, :])[:, 0]
        out["resid_kernels"].append(rel_err(xs["kernels"], xs["plain"]))
        out["resid_kernels_last"].append(
            rel_err(xs["kernels"][:, -1], xs["plain"][:, -1]))
        out["resid_reordered"].append(rel_err(xs["reordered"], xs["plain"]))
        out["resid_decode"].append(rel_err(xd, xs["kernels"][:, -1]))
    del cache, kvs, c

    def head(x):    # as forward and decode_step compute it
        return (layers.rms_norm(x, params["final_norm"])
                @ params["lm_head"])[..., :cfg.vocab_size]

    logits = {n: head(x)[:, -1] for n, x in xs.items()}
    logits["decode"] = head(xd)
    worst = int(np.argmax(out["attn_b6_ulps"]))
    return dict(
        out, attn_b6_worst_layer=worst,
        attn_b6_worst_ulps=out["attn_b6_ulps"][worst],
        logits_kernels=rel_err(logits["kernels"], logits["plain"]),
        logits_reordered=rel_err(logits["reordered"], logits["plain"]),
        logits_decode=rel_err(logits["decode"], logits["kernels"]),
        kernels_walk_is_forward=same_bits(logits["kernels"], full),
        decode_walk_is_decode_step=same_bits(logits["decode"], step))


def plain_and_kernels(lm, params, batch, max_len):
    """Prefill ``batch`` (``{"tokens": ...}``, with the VLM's patches too)
    and take one decode step, kernels off (``plain``) then on
    (``kernels``); the step's token is the plain prefill's greedy one.
    Returns ({name: (prefill logits, step logits)}, token)."""
    plain = dataclasses.replace(lm, cfg=dataclasses.replace(
        lm.cfg, use_kernels=False))
    res, tok = {}, None
    for name, m in (("plain", plain), ("kernels", lm)):
        logits, cache, cur = m.prefill(params, batch, max_len)
        if tok is None:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        step, cache = m.decode_step(params, tok, cache, cur)
        res[name] = (logits, step)
        del cache
        torch.cuda.empty_cache()
    return res, tok


def check_greedy(res, out: dict) -> None:
    """Greedy tokens of the prefill and of the decode step, kernels on
    against off, equal wherever the plain path's top two logits are
    further apart than SERVE_REL_BOUND of its largest magnitude."""
    res = {k: tuple(x.float() for x in r) for k, r in res.items()}
    for i, what in enumerate(("prefill", "decode")):
        want, got = res["plain"][i], res["kernels"][i]
        top2 = torch.topk(want, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > SERVE_REL_BOUND * float(
            want.abs().max())
        same = torch.argmax(got, -1) == torch.argmax(want, -1)
        assert bool(same[sure].all()), f"greedy {what} tokens differ"
        out[f"{what}_greedy_checked"] = int(sure.sum())
        out[f"{what}_greedy_equal"] = int(same.sum())


def check_serve(server, batch) -> dict:
    """The serve path held to itself: the same params with kernels off
    (last-token prefill logits within SERVE_REL_BOUND, greedy tokens of
    the prefill and of the first decode step equal wherever the plain
    path's top two logits are further apart than that bound), and that
    decode step's logits to the cache-free forward of the same prefix; and
    B6's own error: at every layer, B6's attention block within
    SERVE_ATTN_ULPS bf16 ulps of the plain block's largest magnitude on the
    same input (``serve_drift``'s ``attn_b6_ulps``). ``serve_drift`` is
    printed first, so that a failing check shows which layers moved."""
    lm, params = server.lm, server.params
    prompts = torch.from_numpy(np.stack([r.prompt for r in batch])).to(
        server.device)
    max_len = prompts.shape[1] + SERVE_NEW + 8
    res, tok = plain_and_kernels(lm, params, {"tokens": prompts}, max_len)
    full = lm.forward(params, {"tokens": torch.cat(
        [prompts, tok[:, None]], dim=1)})[0][:, -1, :lm.cfg.vocab_size]
    out = dict(prefill_rel_err=rel_err(res["kernels"][0], res["plain"][0]),
               decode_vs_forward_rel_err=rel_err(res["kernels"][1], full))
    drift = serve_drift(lm, params, prompts, tok, max_len, full,
                        res["kernels"][1])
    say(phase="serve_drift", **out, **drift)
    torch.cuda.empty_cache()
    out.update(attn_b6_worst_layer=drift["attn_b6_worst_layer"],
               attn_b6_worst_ulps=drift["attn_b6_worst_ulps"])
    assert drift["attn_b6_worst_ulps"] <= SERVE_ATTN_ULPS, \
        f"B6's attention block {drift['attn_b6_worst_ulps']} bf16 ulps " \
        f"from the plain one at layer {drift['attn_b6_worst_layer']}"
    assert out["prefill_rel_err"] <= SERVE_REL_BOUND, out
    check_greedy(res, out)
    assert out["decode_vs_forward_rel_err"] <= SERVE_REL_BOUND, out
    assert bool(torch.isfinite(full).all()), "forward: non-finite logits"
    return out


def head_logits(cfg, params, x) -> torch.Tensor:
    """Final norm and LM head on the last position of x (B, S, D), as
    ``prefill`` computes them."""
    return (layers.rms_norm(x[:, -1], params["final_norm"])
            @ params["lm_head"])[:, :cfg.vocab_size]


def same_routes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per token, whether two (T, k) route tables pick the same experts."""
    return (a.sort(-1).values == b.sort(-1).values).all(-1)


def prefill_layers(lm, params, batch, prefill_logits) -> dict:
    """The prefill's layers on ``batch``, each run by ``lm``'s own
    ``_run_block`` (kernels on), layer ``l`` at period position ``l % P``
    of group ``l // P``. At each attention layer, on that layer's input:
    B6's attention block against the plain one (``attn_b6``, max |diff|
    over max |plain|; ``attn_b6_ulps`` in bf16 ulps of the plain block's
    largest magnitude). At each MoE layer: the assignments its routes drop
    past capacity (``dropped``), and where the layer's mixer is attention,
    ``route_flips``, the tokens whose router picks other experts when that
    attention is the plain block. A route is discrete: where two experts'
    router logits lie closer than the bf16 differences between B6 and the
    plain attention, the token goes to other experts and its output moves
    by tens of percent. The walk must give the prefill's logits bit for
    bit."""
    cfg = lm.cfg
    P = cfg.scan_period
    plain = dataclasses.replace(cfg, use_kernels=False)
    x, _ = lm._embed_inputs(params, batch)
    pos = lm._positions(x)
    T = x.shape[0] * x.shape[1]
    capacity = blocks.moe_capacity(cfg, T) if cfg.moe else None
    out = collections.defaultdict(list)
    for l in range(cfg.num_layers):
        bp = map_tree(lambda t: t[l // P], params["layers"][f"pos{l % P}"])
        mixed = {}
        if "attn" in bp:
            b6 = blocks.attn_forward(bp["attn"], x, cfg, pos)[0]
            ref = blocks.attn_forward(bp["attn"], x, plain, pos)[0]
            out["attn_layers"].append(l)
            out["attn_b6"].append(rel_err(b6, ref))
            out["attn_b6_ulps"].append(block_ulps(b6, ref))
            if "moe" in bp:
                mixed = {"kernels": x + b6, "plain": x + ref}
            del b6, ref
        elif "moe" in bp:
            mixed = {"kernels": x + blocks.mamba_forward(bp["mamba"], x,
                                                         cfg)[0]}
        if "moe" in bp:
            routes = {n: blocks.moe_route(bp["moe"], v, cfg)[4]
                      for n, v in mixed.items()}
            if "plain" in routes:
                out["route_flips"].append(int((~same_routes(
                    routes["plain"], routes["kernels"])).sum()))
            keep = blocks.moe_slots(routes["kernels"], 1,
                                    cfg.moe.num_experts, capacity,
                                    cfg.moe_dispatch)[1]
            out["dropped"].append(int((~keep).sum()))
            del mixed, routes
        x = lm._run_block(bp, x, pos, "prefill")[0]
    assert same_bits(head_logits(cfg, params, x), prefill_logits), \
        "the layer walk does not give the prefill's logits"
    worst = int(np.argmax(out["attn_b6_ulps"]))
    res = dict(out, attn_b6_worst_layer=out["attn_layers"][worst],
               attn_b6_worst_ulps=out["attn_b6_ulps"][worst])
    if cfg.moe:
        assignments = len(out["dropped"]) * T * cfg.moe.top_k
        res.update(capacity=capacity, assignments=assignments,
                   dropped_share=sum(out["dropped"]) / assignments,
                   route_flips=out["route_flips"])
    return res


def float32_in_place(tree, groups=None, layer=False) -> None:
    """Replace each leaf of a parameter tree by its float32 copy, one leaf
    at a time, so that the two copies never coexist whole (qwen2-moe's
    float32 copy alone is 57.3 GB); below ``layers``, only the first
    ``groups`` groups of each leaf (all when None)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            float32_in_place(v, groups, layer or k == "layers")
        else:
            tree[k] = (v[:groups] if layer else v).float()
            del v


def float32_copy(lm, params, layers=None):
    """``lm`` on float32 parameters, cut to its first ``layers`` layers
    (whole periods; all when None); ``params`` become their float32 copy
    in place, and the bf16 weights are freed as the copy grows."""
    layers = layers or lm.cfg.num_layers
    float32_in_place(params, layers // lm.cfg.scan_period)
    return dataclasses.replace(lm, cfg=dataclasses.replace(
        lm.cfg, num_layers=layers, param_dtype="float32"))


def no_drop(lm):
    """``lm`` with a capacity factor that makes every expert's capacity
    equal the tokens, so that nothing drops (the reference's consistency
    tests raise it to 8.0 for the same reason; 60 experts top-4 need
    15)."""
    m = lm.cfg.moe
    return dataclasses.replace(lm, cfg=dataclasses.replace(
        lm.cfg, moe=dataclasses.replace(
            m, capacity_factor=float(m.num_experts))))


def decode_vs_forward(lm, params, batch, tok, max_len) -> float:
    """``lm``'s decode step of ``tok`` after a prefill of ``batch``
    (``{"tokens": ...}``, with the VLM's patches too) against the
    cache-free forward of both, at the last position."""
    _, cache, cur = lm.prefill(params, batch, max_len)
    step, cache = lm.decode_step(params, tok, cache, cur)
    del cache
    full = lm.forward(params, {**batch, "tokens": torch.cat(
        [batch["tokens"], tok[:, None]], dim=1)})[0][:, -1,
                                                    :lm.cfg.vocab_size]
    assert bool(torch.isfinite(full).all()), "forward: non-finite logits"
    return rel_err(step, full)


def check_moe_serve(server, batch, f32_layers=None) -> dict:
    """The MoE serve (and the hybrid's), through ``prefill``,
    ``decode_step`` and ``forward``. On the served bf16 weights: B6's
    block within SERVE_ATTN_ULPS at each attention layer, the prefill's
    drops and route flips (``prefill_layers``), and the logit comparisons
    printed (``*_bf16``): bf16 swaps the routes of hundreds of tokens a
    layer between two paths, which moves their logits by tens of percent
    (ROADMAP C18). Gated on a float32 copy of the same weights (cut to
    ``f32_layers`` layers when given; it replaces them), for
    MOE_F32_BATCH prompts, within SERVE_F32_REL_BOUND: last-token prefill
    logits kernels on against off, with greedy tokens, and a decode step
    against the cache-free forward on ``no_drop``."""
    lm, params = server.lm, server.params
    prompts = torch.from_numpy(np.stack([r.prompt for r in batch])).to(
        server.device)
    max_len = prompts.shape[1] + SERVE_NEW + 8
    res, tok = plain_and_kernels(lm, params, {"tokens": prompts}, max_len)
    walk = prefill_layers(lm, params, {"tokens": prompts}, res["kernels"][0])
    torch.cuda.empty_cache()
    nd = no_drop(lm)
    n = prompts.numel() + tok.numel()
    assert blocks.moe_capacity(nd.cfg, n) == n
    out = dict(prefill_rel_err_bf16=rel_err(res["kernels"][0],
                                            res["plain"][0]),
               decode_vs_forward_rel_err_bf16=decode_vs_forward(
                   nd, params, {"tokens": prompts}, tok, max_len))
    say(phase="serve_moe_layers", **out, **walk)
    assert walk["attn_b6_worst_ulps"] <= SERVE_ATTN_ULPS, \
        f"B6's attention block {walk['attn_b6_worst_ulps']} bf16 ulps " \
        f"from the plain one at layer {walk['attn_b6_worst_layer']}"
    out.update({k: walk[k] for k in ("attn_b6_worst_layer",
                                     "attn_b6_worst_ulps", "dropped_share",
                                     "capacity")},
               prefill_route_flips_bf16=sum(walk["route_flips"]))
    del res
    torch.cuda.empty_cache()

    lm32 = float32_copy(lm, params, f32_layers)
    out.update(float32_layers=lm32.cfg.num_layers,
               float32_param_bytes=param_bytes(params))
    batch32 = {"tokens": prompts[:MOE_F32_BATCH]}
    res, tok = plain_and_kernels(lm32, params, batch32, max_len)
    out["prefill_rel_err"] = rel_err(res["kernels"][0], res["plain"][0])
    check_greedy(res, out)
    out["decode_vs_forward_rel_err"] = decode_vs_forward(
        no_drop(lm32), params, batch32, tok, max_len)
    say(phase="serve_moe_float32", **out)
    assert out["prefill_rel_err"] <= SERVE_F32_REL_BOUND, out
    assert out["decode_vs_forward_rel_err"] <= SERVE_F32_REL_BOUND, out
    return out


def ssm_stepwise(lm, params, tokens) -> dict:
    """The chunked forward of ``tokens`` against ``decode_step`` from a
    zero cache, one token at a time (each step ``mamba_decode`` in every
    layer): per position, max |diff| of the logits over the forward's
    largest magnitude there."""
    V = lm.cfg.vocab_size
    fwd = lm.forward(params, {"tokens": tokens})[0][..., :V]
    cache = lm.init_cache(tokens.shape[0], tokens.shape[1])
    errs = []
    for t in range(tokens.shape[1]):
        step, cache = lm.decode_step(params, tokens[:, t].contiguous(),
                                     cache, t)
        errs.append(rel_err(step, fwd[:, t]))
    worst = int(np.argmax(errs))
    return dict(positions=len(errs), worst_position=worst,
                rel_err=errs[worst],
                rel_err_at_chunk_ends=[errs[i] for i in range(
                    lm.cfg.ssm.chunk - 1, len(errs), lm.cfg.ssm.chunk)])


def check_ssm_serve(server, batch) -> dict:
    """The SSM serve: last-token prefill logits and greedy tokens, kernels
    on against off, as for yi-34b (only the embedding lookups differ, bit
    for bit). A decode step against the cache-free forward of its prefix,
    and the chunked forward against a stepwise decode over
    SSM_STEP_PROMPT tokens of SSM_STEP_BATCH prompts (a chunk boundary and
    a ragged tail), each within SERVE_F32_REL_BOUND on a float32 copy of
    the served weights (which replaces them): in bf16 every one of the
    64 layers rounds its residual add, and the two paths' different
    products round differently, which alone moves bf16 logits by a few
    percent; the reference package drifts as far on the same weights
    (ROADMAP C19, tests/test_torch_bf16_witness.py). The bf16 readings
    are printed (``*_bf16``)."""
    lm, params = server.lm, server.params
    cfg = lm.cfg
    prompts = torch.from_numpy(np.stack([r.prompt for r in batch])).to(
        server.device)
    max_len = prompts.shape[1] + SERVE_NEW + 8
    res, tok = plain_and_kernels(lm, params, {"tokens": prompts}, max_len)
    short = prompts[:SSM_STEP_BATCH, :SSM_STEP_PROMPT]
    out = dict(prefill_rel_err=rel_err(res["kernels"][0], res["plain"][0]))
    check_greedy(res, out)
    out["decode_vs_forward_rel_err_bf16"] = decode_vs_forward(
        lm, params, {"tokens": prompts}, tok, max_len)
    steps = ssm_stepwise(lm, params, short)
    out["stepwise_rel_err_bf16"] = steps["rel_err"]
    torch.cuda.empty_cache()
    lm32 = float32_copy(lm, params)
    out["decode_vs_forward_rel_err"] = decode_vs_forward(
        lm32, params, {"tokens": prompts}, tok, max_len)
    steps32 = ssm_stepwise(lm32, params, short)
    out["stepwise_rel_err"] = steps32["rel_err"]
    torch.cuda.empty_cache()
    say(phase="serve_ssm_stepwise", **out, bf16=steps, float32=steps32)
    assert out["prefill_rel_err"] <= SERVE_REL_BOUND, out
    assert out["decode_vs_forward_rel_err"] <= SERVE_F32_REL_BOUND, out
    assert out["stepwise_rel_err"] <= SERVE_F32_REL_BOUND, out
    return out


def serve_requests(cfg) -> list:
    """The serve mix: SERVE_REQUESTS prompts of SERVE_PROMPT uniform token
    ids from seed SEED, SERVE_NEW new tokens each, every 3 cycles."""
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32),
                max_new_tokens=SERVE_NEW, arrival_cycle=i * 3)
            for i in range(SERVE_REQUESTS)]


def check_outputs(stats, reqs, cfg) -> int:
    """Both batches served, every request's SERVE_NEW tokens in the
    vocabulary, and the modeled replay equal to SERVE_MODELED. Returns
    the tokens generated."""
    assert stats.batches == 2 and stats.requests == SERVE_REQUESTS
    for r in reqs:
        assert len(r.output) == SERVE_NEW and all(
            0 <= t < cfg.vocab_size for t in r.output), f"request {r.rid}"
    for field, want in SERVE_MODELED.items():
        assert getattr(stats, field) == want, \
            f"{field}: {getattr(stats, field)} != {want}"
    return sum(len(r.output) for r in reqs)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class CutServer(Server):
    """``Server(arch)`` with its configuration cut to ``layers`` layers,
    random weights from seed 0 (the cut is this script's: ``Server`` takes
    no depth). The smoke model that ``Server.__init__`` builds first is a
    few MB and is replaced at once."""

    def __init__(self, arch: str, layers: int, device):
        super().__init__(arch, smoke=True, device=device)
        self.cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        self.lm = build_lm(self.cfg, device=self.device)
        self.params = self.lm.init(
            torch.Generator(self.device).manual_seed(0))


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(params))


def run_family_serve(dev, arch: str, check, layers=None) -> dict:
    """Phase 4, serve_moe, serve_ssm and serve_hybrid: ``Server(arch)`` at
    its full configuration on the card (cut to ``layers`` layers when
    given, by ``CutServer``; random weights from seed 0) serving the
    yi-34b serve's mix, counters zeroed just before ``serve``. Flash
    attention must launch once per attention layer per batch, all on its
    tensor-core route, the scheduler's sort and gather in every embedding
    lookup, and no other kernel. Then ``check(server, first batch)``."""
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    server = Server(arch, device=dev) if layers is None else \
        CutServer(arch, layers, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = server.cfg
    reqs = serve_requests(cfg)

    zero_launches()
    stats = server.serve(reqs)
    torch.cuda.synchronize()
    launches = {name: lib.launches for name, lib in LIBS.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9

    routes = dict(fa_kernel.LIB.entry_launches)
    attn_layers = sum(cfg.layer_kinds(l)[0] == "attn"
                      for l in range(cfg.num_layers))
    assert launches["flash_attention"] == attn_layers * stats.batches \
        == routes["flash_attention_fwd_tc"], \
        f"flash attention ran {routes} times"
    assert launches["bitonic_sort"] > 0 and launches["sorted_gather"] > 0, \
        "the embedding lookups did not go through the scheduler's kernels"
    off_path = {n: c for n, c in launches.items() if n not in (
        "bitonic_sort", "sorted_gather", "flash_attention")}
    assert not any(off_path.values()), f"off-path launches {off_path}"
    generated = check_outputs(stats, reqs, cfg)
    weight_bytes = param_bytes(server.params)
    # the check may replace the served weights by a float32 copy
    consistency = check(server, server.admit(reqs)[0])
    return dict(
        arch=cfg.name, layers=cfg.num_layers, params=cfg.param_count(),
        param_bytes=weight_bytes, init_s=init_s, batches=stats.batches,
        batch_sizes=[len(b) for b in server.admit(reqs)],
        prefill_tokens=stats.prefill_tokens, generated_tokens=generated,
        decode_steps=stats.decode_steps, wall_s=stats.wall_s,
        prefill_s=stats.prefill_s,
        prefill_tokens_per_s=stats.prefill_tokens / stats.prefill_s,
        decode_s_per_step=stats.decode_s / stats.decode_steps,
        tokens_per_s=(stats.prefill_tokens + generated) / stats.wall_s,
        launches=launches, flash_attention_routes=routes, peak_mem_gb=peak,
        sample_output=reqs[0].output, card=card(), **consistency)


def run_encoder(dev) -> dict:
    """Phase 4, encoder: hubert-xlarge uncut on the card (random weights
    from seed 0), ``forward`` and ``loss`` on make_batch's ENCODER_BATCH x
    ENCODER_FRAMES float32 frames, counters zeroed just before each. The
    frames keep the residual stream float32 on bf16 weights, as in the
    reference, so flash attention must launch once per layer a call, all
    on its float32 (CUDA-core) route; the audio path makes no embedding
    lookup, so no sort or gather, and no other kernel. Kernels on against
    off: logits and loss within SERVE_F32_REL_BOUND, as every float32
    gate (B6 on this route and shape is held at 3e-5 in ATTN_CASES)."""
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_arch(ENCODER_ARCH)
    lm = build_lm(cfg, device=dev)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, ShapeConfig("encoder", ENCODER_FRAMES, ENCODER_BATCH, "train"),
        step=0, seed=SEED).items()}
    out, launches = {}, {}
    for call in ("forward", "loss"):
        zero_launches()
        t0 = time.perf_counter()
        res = getattr(lm, call)(params, batch)
        torch.cuda.synchronize()
        out[f"{call}_s"] = time.perf_counter() - t0
        launches[call] = {name: lib.launches for name, lib in LIBS.items()}
        routes = dict(fa_kernel.LIB.entry_launches)
        assert launches[call]["flash_attention"] == cfg.num_layers == \
            routes["flash_attention_fwd"], f"{call}: B6 ran {routes} times"
        off_path = {n: c for n, c in launches[call].items()
                    if n != "flash_attention"}
        assert not any(off_path.values()), f"{call}: launches {off_path}"
        out[call] = res[0]
    logits, loss = out.pop("forward"), out.pop("loss")
    assert logits.dtype == torch.float32 and logits.shape == (
        ENCODER_BATCH, ENCODER_FRAMES, cfg.padded_vocab), logits.shape
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(loss))
    plain = dataclasses.replace(lm, cfg=dataclasses.replace(
        cfg, use_kernels=False))
    out["logits_rel_err"] = rel_err(logits, plain.forward(params, batch)[0])
    plain_loss = plain.loss(params, batch)[0]
    out["loss_rel_err"] = float((loss - plain_loss).abs() / plain_loss.abs())
    assert out["logits_rel_err"] <= SERVE_F32_REL_BOUND, out
    assert out["loss_rel_err"] <= SERVE_F32_REL_BOUND, out
    return dict(
        arch=cfg.name, layers=cfg.num_layers, params=cfg.param_count(),
        param_bytes=param_bytes(params), init_s=init_s,
        frames=ENCODER_BATCH * ENCODER_FRAMES, loss=float(loss),
        frames_per_s=ENCODER_BATCH * ENCODER_FRAMES / out["forward_s"],
        launches=launches["forward"], launches_by_call=launches,
        flash_attention_routes=routes,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        card=card(), **out)


def run_vlm(dev) -> dict:
    """Phase 4, vlm: internvl2-76b cut to VLM_LAYERS layers on the card
    (random weights from seed 0): ``LM.prefill`` of make_batch's VLM_BATCH
    sequences of 256 patches and VLM_TEXT text tokens, then SERVE_NEW
    greedy ``decode_step``s, counters zeroed just before. Flash attention
    must launch once per layer in the prefill, all on its tensor-core
    route; the sort and the gather once in each text lookup (the prefill's
    and every step's), and no other kernel. Then ``check_vlm``."""
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = dataclasses.replace(get_arch(VLM_ARCH), num_layers=VLM_LAYERS)
    lm = build_lm(cfg, device=dev)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    seq = cfg.num_vision_tokens + VLM_TEXT
    data = make_batch(cfg, ShapeConfig("vlm", seq, VLM_BATCH, "train"),
                      step=0, seed=SEED)
    batch = {k: torch.from_numpy(data[k]).to(dev)
             for k in ("vision_embeds", "tokens")}
    max_len = seq + SERVE_NEW + 8

    zero_launches()
    t0 = time.perf_counter()
    logits, cache, cur = lm.prefill(params, batch, max_len)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    outs = [tok.tolist()]
    prefill_s = time.perf_counter() - t0
    first = logits
    for _ in range(SERVE_NEW):
        logits, cache = lm.decode_step(params, tok, cache, cur)
        cur += 1
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        outs.append(tok.tolist())
    decode_s = time.perf_counter() - t0 - prefill_s
    launches = {name: lib.launches for name, lib in LIBS.items()}
    routes = dict(fa_kernel.LIB.entry_launches)
    del cache
    assert launches["flash_attention"] == VLM_LAYERS == \
        routes["flash_attention_fwd_tc"], f"B6 ran {routes} times"
    assert launches["bitonic_sort"] == launches["sorted_gather"] == \
        1 + SERVE_NEW, f"lookups: {launches}"
    off_path = {n: c for n, c in launches.items() if n not in (
        "bitonic_sort", "sorted_gather", "flash_attention")}
    assert not any(off_path.values()), f"off-path launches {off_path}"
    assert all(0 <= t < cfg.vocab_size for step in outs for t in step)
    weight_bytes = param_bytes(params)
    out = check_vlm(lm, params, batch, max_len, first)
    generated = VLM_BATCH * SERVE_NEW
    return dict(
        arch=cfg.name, layers=cfg.num_layers, params=cfg.param_count(),
        param_bytes=weight_bytes, init_s=init_s,
        prefill_tokens=VLM_BATCH * seq, patches=VLM_BATCH *
        cfg.num_vision_tokens, generated_tokens=generated,
        prefill_s=prefill_s, decode_s_per_step=decode_s / SERVE_NEW,
        prefill_tokens_per_s=VLM_BATCH * seq / prefill_s,
        launches=launches, flash_attention_routes=routes,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        sample_output=[step[0] for step in outs], card=card(), **out)


def check_vlm(lm, params, batch, max_len, served_logits) -> dict:
    """The VLM prefill held to itself, through ``prefill``, ``decode_step``
    and ``forward``. On the served bf16 weights: greedy tokens of the
    prefill and of a decode step, kernels on against off, equal wherever
    the plain path's top two logits are further apart than
    SERVE_REL_BOUND (``check_greedy``), and B6's block within
    SERVE_ATTN_ULPS at every layer (``prefill_layers``); the last-token
    logits kernels on against off are printed (``*_bf16``) beside the
    plain path against itself with its float32 sums in another order
    (``reordered``, a control: bf16 rounds both alike, ROADMAP C19).
    Gated on a float32 copy of the served weights cut to VLM_F32_LAYERS
    layers (``float32_copy``, which replaces them), for
    MOE_F32_BATCH sequences, within SERVE_F32_REL_BOUND: last-token
    prefill logits kernels on against off, with greedy tokens, and a
    decode step against the cache-free forward."""
    cfg = lm.cfg
    res, _ = plain_and_kernels(lm, params, batch, max_len)
    greedy = {}
    check_greedy(res, greedy)
    reordered = dataclasses.replace(lm, cfg=dataclasses.replace(
        cfg, use_kernels=False, attn_kv_block=cfg.attn_kv_block // 4))
    out = dict(prefill_rel_err_bf16=rel_err(res["kernels"][0],
                                            res["plain"][0]),
               prefill_rel_err_reordered_bf16=rel_err(
                   reordered.prefill(params, batch, max_len)[0],
                   res["plain"][0]),
               prefill_repeats_its_bits=same_bits(res["kernels"][0],
                                                  served_logits),
               **{f"{k}_bf16": v for k, v in greedy.items()})
    walk = prefill_layers(lm, params, batch, res["kernels"][0])
    say(phase="vlm_layers", **out, **walk)
    assert walk["attn_b6_worst_ulps"] <= SERVE_ATTN_ULPS, \
        f"B6's attention block {walk['attn_b6_worst_ulps']} bf16 ulps " \
        f"from the plain one at layer {walk['attn_b6_worst_layer']}"
    out.update({k: walk[k] for k in ("attn_b6_worst_layer",
                                     "attn_b6_worst_ulps")})
    del res
    torch.cuda.empty_cache()

    lm32 = float32_copy(lm, params, VLM_F32_LAYERS)
    torch.cuda.empty_cache()
    out.update(float32_layers=lm32.cfg.num_layers,
               float32_param_bytes=param_bytes(params))
    small = {k: v[:MOE_F32_BATCH] for k, v in batch.items()}
    res, tok = plain_and_kernels(lm32, params, small, max_len)
    out["prefill_rel_err"] = rel_err(res["kernels"][0], res["plain"][0])
    check_greedy(res, out)
    out["decode_vs_forward_rel_err"] = decode_vs_forward(
        lm32, params, small, tok, max_len)
    say(phase="vlm_float32", **out)
    assert out["prefill_rel_err"] <= SERVE_F32_REL_BOUND, out
    assert out["decode_vs_forward_rel_err"] <= SERVE_F32_REL_BOUND, out
    return out


def run_capture(dev) -> dict:
    """Phase 4, capture: ``capture_model_trace`` on the card for the six
    family representatives at their smoke configs, on the port's seeded
    params (``torch.Generator`` of the card, seed 0), counters zeroed
    before the six. The same capture on CPU copies of those params: every
    value-independent request equal in all six columns, and as many
    value-dependent ones (decode tokens and MoE routes, which the two
    devices' arithmetic may pick apart; their differing rows printed).
    The embedding-gradient update runs B3 here, the lookups B1 and B2,
    attention B6; each must have run."""
    zero_launches()
    out = {}
    cols = ("pe_id", "row_id", "rw", "nbytes", "op", "arrival_cycle")
    t0 = time.perf_counter()
    caps = {}
    for fam, arch in sorted(model_traces.FAMILY_REPRESENTATIVE.items()):
        cfg = get_arch(arch, smoke=True)
        params = build_lm(cfg, device=dev).init(
            torch.Generator(dev).manual_seed(SEED))
        caps[fam] = (arch, model_traces.capture_model_trace(
            arch, params=params, device=dev), map_tree(
                lambda t: t.cpu(), params))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {name: lib.launches for name, lib in LIBS.items()}
    for name in ("bitonic_sort", "sorted_gather", "sorted_scatter",
                 "flash_attention"):
        assert launches[name] > 0, f"{name} did not run in the capture"
    for fam, (arch, got, cpu_params) in caps.items():
        want = model_traces.capture_model_trace(arch, params=cpu_params,
                                                device="cpu")
        assert got.to_dict()["regions"] == want.to_dict()["regions"], fam
        assert got.op_labels == want.op_labels and len(got) == len(want)
        g, w = got.rows(), want.rows()
        vd = model_traces.value_dependent(got)
        assert np.array_equal(vd, model_traces.value_dependent(want)), fam
        for c in cols:
            assert np.array_equal(g[c][~vd], w[c][~vd]), (fam, c)
        diff = np.nonzero((g["row_id"] != w["row_id"])
                          | (g["pe_id"] != w["pe_id"]))[0]
        labels = np.asarray(got.op_labels)
        out[fam] = dict(
            arch=arch, requests=len(got), op_counts=got.op_counts(),
            value_dependent=int(vd.sum()), differing=int(diff.size),
            differing_ops=dict(collections.Counter(
                labels[g["op"][diff]].tolist())),
            differing_rows=[(int(i), int(w["row_id"][i]), int(g["row_id"][i]),
                             int(w["pe_id"][i]), int(g["pe_id"][i]))
                            for i in diff[:8]])
    return dict(families=out, card_s=card_s, launches=launches, card=card())


def tuned_geometry(cfg) -> dict:
    """The tuned controller geometry, flattened as perf_model_traces
    records it."""
    return {
        "sched_batch": cfg.scheduler.batch_size,
        "cache_ways": cfg.cache.associativity,
        "cache_lines": cfg.cache.num_lines,
        "num_channels": cfg.channels.num_channels,
        "mapping": cfg.channels.policy,
        "dram_sched": cfg.dram_sched.policy,
        "reorder_window": cfg.dram_sched.reorder_window,
        "dma_channels": cfg.dma.num_parallel_dma,
    }


def run_autotune() -> dict:
    """The autotune phase (host only; no kernel may launch): on each of
    the six pinned family traces (8 ports, 4096-byte rows), the batched
    engine over FULL_GRID must give ``BENCH_model_traces.json``'s
    ``families`` entry (read from disk): the geometry, and ``tuned_cycles``
    to 0.1; over SMALL_GRID the batched engine and the oracle must give
    the same argmin, and the same table but for C6's last digit. Host
    seconds of each call per trace."""
    zero_launches()
    with open(os.path.join(ROOT, "BENCH_model_traces.json")) as f:
        bench = json.load(f)["families"]
    rb = model_traces.REPLAY_ROW_BYTES
    out = {}
    for fam, arch in sorted(model_traces.FAMILY_REPRESENTATIVE.items()):
        want = bench[fam]
        assert want["representative"] == arch, (fam, want)
        _, rows, _ = model_traces.load_pinned_trace(arch).replay_arrays(8)
        full, full_s = timed(lambda: autotune.tune(
            rows, rb, engine="batched", **FULL_GRID))
        geom = tuned_geometry(full.config)
        assert geom == want["geometry"], (fam, geom, want)
        assert round(full.modeled_cycles, 1) == want["tuned_cycles"], \
            (fam, full.modeled_cycles, want)
        small, small_s = timed(lambda: autotune.tune(
            rows, rb, engine="batched", **SMALL_GRID))
        oracle, oracle_s = timed(lambda: autotune.tune(
            rows, rb, engine="oracle", **SMALL_GRID))
        assert small.config == oracle.config, fam
        assert [d for d, _ in small.table] == [d for d, _ in oracle.table]
        for (d, a), (_, b) in zip(small.table, oracle.table):
            assert abs(a - b) <= C6_ULPS * math.ulp(max(abs(a), abs(b))), \
                (fam, d, a, b)
        out[fam] = dict(
            arch=arch, requests=int(rows.size), geometry=geom,
            tuned_cycles=full.modeled_cycles,
            candidates=full.candidates_evaluated, full_grid_s=full_s,
            small_grid_s=small_s, small_grid_oracle_s=oracle_s,
            small_argmin=tuned_geometry(small.config),
            last_digit_differences=sum(a != b for (_, a), (_, b) in zip(
                small.table, oracle.table)))
    launches = {name: lib.launches for name, lib in LIBS.items()}
    assert not any(launches.values()), f"a kernel launched: {launches}"
    return dict(families=out, numpy=np.__version__, launches=launches)


def run_serve(dev) -> dict:
    """Phase 4, serve path: build ``Server("yi-34b")`` on the card and
    serve the request mix, counters zeroed just before ``serve``."""
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    server = Server(SERVE_ARCH, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = server.cfg
    reqs = serve_requests(cfg)

    zero_launches()
    stats = server.serve(reqs)
    torch.cuda.synchronize()
    launches = read_launches("serve")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9

    routes = dict(fa_kernel.LIB.entry_launches)
    assert launches["flash_attention"] == cfg.num_layers * stats.batches \
        == routes["flash_attention_fwd_tc"], \
        f"flash attention ran {routes} times"
    assert launches["bitonic_sort"] > 0 and launches["sorted_gather"] > 0, \
        "the embedding lookups did not go through the scheduler's kernels"
    assert stats.batches == 2 and stats.requests == SERVE_REQUESTS
    for r in reqs:
        assert len(r.output) == SERVE_NEW and all(
            0 <= t < cfg.vocab_size for t in r.output), f"request {r.rid}"
    generated = sum(len(r.output) for r in reqs)
    # ``serve`` ends with the modeled replay; its host seconds apart.
    replay = ServeStats()
    t0 = time.perf_counter()
    server.model_memory(server.admit(reqs), replay)
    model_memory_s = time.perf_counter() - t0
    for field, want in SERVE_MODELED.items():
        assert getattr(stats, field) == getattr(replay, field) == want, \
            f"{field}: {getattr(stats, field)} != {want}"
    first = server.admit(reqs)[0]
    consistency = check_serve(server, first)
    return dict(
        arch=cfg.name, layers=cfg.num_layers, params=cfg.param_count(),
        weight_gb=sum(t.numel() * t.element_size() for t in
                      leaves(server.params)) / 1e9,
        init_s=init_s, batches=stats.batches,
        batch_sizes=[len(b) for b in server.admit(reqs)],
        prefill_tokens=stats.prefill_tokens, generated_tokens=generated,
        decode_steps=stats.decode_steps, wall_s=stats.wall_s,
        prefill_s=stats.prefill_s,
        prefill_tokens_per_s=stats.prefill_tokens / stats.prefill_s,
        decode_s_per_step=stats.decode_s / stats.decode_steps,
        tokens_per_s=(stats.prefill_tokens + generated) / stats.wall_s,
        model_memory_s=model_memory_s,
        modeled={k: getattr(stats, k) for k in SERVE_MODELED},
        launches=launches, flash_attention_routes=routes, peak_mem_gb=peak,
        sample_output=reqs[0].output, **consistency)


def timings(dev, s) -> dict:
    """Phase 5: kernel, plain and library medians beside the bound."""
    table, sidx, svals, sgrads = s["table"], s["sidx"], s["svals"], s["sgrads"]
    res = {}

    sort = {}
    # The scheduler's batches, the serve path's prefill lookup, the 1-D
    # stream at the wrapper's chunk and, through the kernels' launcher,
    # at three others (the readings behind DEFAULT_CHUNK).
    for shape, chunk in [((BATCH * SEQ // SCHED_BATCH, SCHED_BATCH), None),
                         ((BATCH, SERVE_PROMPT), None),
                         ((1, BATCH * SEQ), None), ((1, BATCH * SEQ), 1024),
                         ((1, BATCH * SEQ), 4096),
                         ((1, BATCH * SEQ), bs_kernel.MAX_CHUNK)]:
        g, m = shape
        keys = s["idx"].to(torch.int32).reshape(-1)[:g * m].reshape(
            shape).contiguous()
        vals = torch.arange(g * m, dtype=torch.int32,
                            device=dev).reshape(shape).contiguous()
        ids = torch.arange(m, dtype=torch.int32,
                           device=dev).expand(shape).contiguous()
        stages = (m.bit_length() - 1) * m.bit_length() // 2
        bytes_moved = 4 * g * m * 5
        ops = g * (m // 2) * stages
        bound = max(bytes_moved / HBM_BYTES_PER_S,
                    ops / NONTENSOR_OPS_PER_S) * 1e3
        c = bs_kernel.default_chunk(m) if chunk is None else chunk
        call = lambda: bs_kernel.bitonic_sort_batched(keys, vals)
        if chunk is not None:     # another chunk than the wrapper's, same bits
            call = lambda: bs_kernel._sort_on_card(keys, vals, chunk)
            for g_, w in zip(call(), bs_kernel.bitonic_sort_batched(keys,
                                                                    vals)):
                assert torch.equal(g_, w), f"bitonic_sort chunk {chunk}"
        lib = lambda: torch.sort(keys, dim=-1, stable=True)
        name = f"{g}x{m}" + ("" if chunk is None else f" chunk {c}")
        # The device launches of a call, counted in the profiler's trace,
        # must be the plan's: its local and global kernels, and nothing
        # else. A trace that counts otherwise is taken again, up to three
        # times: the profiler drops a kernel event now and then.
        plan = bs_kernel.stage_plan(m, c)
        local = sum(kind == "local" for kind, _, _ in plan)
        want = {"local": local, "stage": len(plan) - local}
        for _ in range(3):
            trace = device_trace(call)
            got = {kind: sum(x for k, x in trace["by_kernel"].items()
                             if f"bitonic_{kind}_kernel" in k)
                   for kind in want}
            if got == want and trace["launches"] == len(plan):
                break
        assert got == want and trace["launches"] == len(plan), \
            f"bitonic_sort {name}: launched {trace['by_kernel']}, plan {want}"
        if chunk is None and m <= bs_kernel.DEFAULT_CHUNK:
            assert trace["launches"] == 1, f"bitonic_sort {name}"
        sort[name] = dict(
            ms=time_ms(call), device_ms=trace["ms"],
            plain_ms=time_ms(lambda: bs_kernel.sort_network(keys, ids, vals)),
            library_ms=time_ms(lib),
            library_device_ms=device_trace(lib)["ms"],
            bound_ms=bound,
            bound_by=("bytes" if bytes_moved / HBM_BYTES_PER_S
                      >= ops / NONTENSOR_OPS_PER_S else "operations"),
            stages=stages, chunk=c,
            device_launches_per_call=trace["launches"],
            device_launches_by_kernel=trace["by_kernel"])
    res["bitonic_sort"] = sort

    sidx32 = sidx.to(torch.int32)
    res["sorted_gather"] = timings_gather(table, sidx32)

    res["sorted_scatter"] = timings_scatter(
        table, sidx32, svals, sgrads, s["sgrads32"], s["distinct"])
    return res


def timing_row(kernel, call, lib, reps: int = REPS, trace=None) -> dict:
    """A kernel's wrapper call and the library call computing the same
    function: CUDA-event medians (``ms``, ``library_ms``), and from a
    ``torch.profiler`` trace (``trace``, or one taken here) the device
    time per call, the device launches per call and the kernels by name,
    with the route they name."""
    trace = trace or device_trace(call)
    lib_trace = device_trace(lib)
    return dict(
        ms=time_ms(call, reps), device_ms=trace["ms"],
        device_launches_per_call=trace["launches"],
        device_kernels=trace["by_kernel"], route=routes_taken(kernel, trace),
        library_ms=time_ms(lib, reps), library_device_ms=lib_trace["ms"],
        library_device_launches_per_call=lib_trace["launches"])


def timings_gather(table, sidx32) -> dict:
    """Phase 5, B2 at the scheduler path's batch (the sorted Zipf ids) and
    at the serve path's embedding lookup (8 x 1024 uniform ids, sorted):
    the wrapper, its launch alone (``kernel_only_ms``: the wrapper's range
    check, one host sync, is the difference), its plain version and
    ``index_select``, beside the bound: the indices read, each distinct
    row read once, every slot's row written once; and a fill of the
    output's bytes (``output_fill_ms``), the card's time for the writes
    alone."""
    rows, d = table.shape
    rb = d * table.element_size()
    gen = torch.Generator(device=table.device).manual_seed(SEED + 4)
    lookup = torch.sort(torch.randint(0, rows, (BATCH * SERVE_PROMPT,),
                                      generator=gen, device=table.device,
                                      dtype=torch.int32)).values
    stream = torch.cuda.current_stream(table.device).cuda_stream
    res = {}
    for name, idx in ((f"{sidx32.numel()}x{d}", sidx32),
                      (f"{lookup.numel()}x{d} uniform (serve lookup)",
                       lookup)):
        n = idx.numel()
        distinct = int(torch.unique_consecutive(idx).numel())
        out = torch.empty((n, d), dtype=table.dtype, device=table.device)
        raw = lambda: sg_kernel.LIB.launch(
            "gather_rows", table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            n, rb, stream)
        res[name] = dict(
            timing_row("sorted_gather",
                       lambda: sg_kernel.gather_rows(table, idx),
                       lambda: torch.index_select(table, 0, idx)),
            kernel_only_ms=time_ms(raw),
            output_fill_ms=time_ms(lambda: out.zero_()),
            plain_ms=time_ms(lambda: sg_kernel.gather_rows_plain(table, idx)),
            bound_ms=(4 * n + (distinct + n) * rb) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", distinct_rows=distinct)
    return res


def timings_bulk(dev, b) -> dict:
    """Phase 5, B4: ``bulk_read`` and ``bulk_write`` (the whole function,
    which returns a new KV cache, and its in-place staged copy), each with
    its library call: ``clone()``, and ``clone()`` then ``copy_``."""
    cfg = PAPER_EVAL_CONFIG.dma
    w, kv, layer_kv, offset = b["w"], b["kv"], b["layer_kv"], b["offset"]
    n = layer_kv.numel()
    w_bytes, kv_bytes = w.numel() * 2, kv.numel() * 2
    layer_bytes = n * 2

    def library_write():
        out = kv.clone()
        out.view(-1)[offset:offset + n].copy_(layer_kv.view(-1))
        return out

    region = kv.clone().view(-1)[offset:offset + n]
    src = layer_kv.reshape(-1)
    chunk = dc_ops.chunk_elems(cfg, 2)
    inplace = lambda: dc_kernel.staged_copy(
        region, src, chunk_elems=chunk, channels=cfg.num_parallel_dma)
    inplace_trace = device_trace(inplace)
    write = dict(
        timing_row("dma_copy", lambda: dma_engine.bulk_write(
            kv, layer_kv, config=cfg, offset_elems=offset, use_kernels=True),
            library_write),
        plain_ms=time_ms(lambda: dma_engine.bulk_write(
            kv, layer_kv, config=cfg, offset_elems=offset,
            use_kernels=False)),
        # The cache outside the region and the layer read once, the new
        # cache written once: twice the cache's bytes.
        bound_ms=2 * kv_bytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        inplace_ms=time_ms(inplace), inplace_device_ms=inplace_trace["ms"],
        inplace_route=routes_taken("dma_copy", inplace_trace),
        inplace_plain_ms=time_ms(lambda: dc_kernel.staged_copy_plain(
            region, src)),
        inplace_bound_ms=2 * layer_bytes / HBM_BYTES_PER_S * 1e3)
    read = dict(
        timing_row("dma_copy", lambda: dma_engine.bulk_copy(
            w, config=cfg, use_kernels=True), lambda: w.clone()),
        plain_ms=time_ms(lambda: dma_engine.bulk_copy(w, config=cfg,
                                                      use_kernels=False)),
        bound_ms=2 * w_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return {f"bulk_read {'x'.join(map(str, FFN_SHAPE))}": read,
            f"bulk_write {'x'.join(map(str, KV_SHAPE[1:]))} into "
            f"{'x'.join(map(str, KV_SHAPE))}": write}


def timings_scatter(table, sidx32, svals, sgrads, sgrads32, distinct,
                    full: bool = True) -> dict:
    """Phase 5, B3 at the scheduler path's batch: ``set``, ``add`` of bf16
    and of float32 gradients into the bf16 table. Each wrapper call's
    CUDA-event median, its device time and launches per call from a
    profiler trace, the device time of B3's own kernels in it
    (``kernel_device_ms``: without the table's clone), the route, the
    plain version's and the library call's time, beside the bound: the
    function returns a new table, so the table read and written once,
    plus the indices, plus the winning rows (``set``) or every row
    (``add``). With ``full``, also the kernels in place without the clone
    (``inplace_ms``: the plan, its host sync and the writes); that needs
    this version's ``plan_on_card``, so ``kernel_repeat.py`` leaves it out
    when it times another version."""
    n, rows = sidx32.shape[0], table.shape[0]
    rb = table.shape[1] * table.element_size()
    sidx = sidx32.long()
    keep = ss_kernel.last_of_run(sidx32)
    last_rows, last_vals = sidx[keep], svals[keep]
    work = table.clone() if full else None
    res = {}
    for name, mode, v in (("set", "set", svals), ("add", "add", sgrads),
                          ("add_f32", "add", sgrads32)):
        val_bytes = distinct * rb if mode == "set" else n * v.shape[1] * \
            v.element_size()
        if name == "set":
            lib = lambda: table.clone().index_copy_(0, last_rows, last_vals)
        elif name == "add":
            lib = lambda: table.clone().index_add_(0, sidx, sgrads)
        else:   # float32 gradients: the same function at float32, rounded once
            lib = lambda: table.float().index_add_(0, sidx, sgrads32).to(
                table.dtype)
        call = lambda: ss_kernel.scatter_rows(table, sidx32, v, mode=mode)
        trace = device_trace(call)
        row = dict(
            timing_row("sorted_scatter", call, lib, trace=trace),
            kernel_device_ms=kernels_ms(trace, "scatter_"),
            kernels_ms={k.removeprefix("void ").split("<")[0]: t
                        for k, t in trace["ms_by_kernel"].items()
                        if "scatter_" in k},
            plain_ms=time_ms(lambda: ss_kernel.scatter_rows_plain(
                table, sidx32, v, mode=mode)),
            bound_ms=(2 * rows * rb + 4 * n + val_bytes)
            / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        if "span" in row["route"]:
            row["route"] = ["span"]
        if full:
            def inplace():
                idx32, plan = ss_kernel.plan_on_card(sidx32, rows,
                                                     runs=mode == "add")
                ss_kernel.scatter_in_place(work, idx32, v, plan)
            row["inplace_ms"] = time_ms(inplace)
            row["inplace_bound_ms"] = (4 * n + val_bytes + (
                2 if mode == "add" else 1) * distinct * rb) \
                / HBM_BYTES_PER_S * 1e3
        res[name] = row
    return res


def timings_cache(dev, c, full: bool = True) -> dict:
    """Phase 5, B5 at the cache path: the probe's wrapper (grouping by set
    on the device, the id-range check's host sync and the kernel), its
    device time and launches per call from a profiler trace, the kernel's
    own device time in it (``kernel_device_ms``), and ``cache_service``.
    With ``full``, also the plain version and the kernel launched alone
    (``kernel_only_ms``), which takes this version's grouping, so
    ``kernel_repeat.py`` leaves them out when it times another version."""
    ids, state, lines_tab = c["ids"], c["state"], c["lines_tab"]
    args = (ids, state.tags, state.valid.to(torch.int32), state.age,
            state.clock)
    sets, ways = state.tags.shape
    n = ids.numel()
    call = lambda: cl_kernel.cache_probe(*args)
    service = lambda: cl_ops.cache_service(lines_tab, ids, state)
    trace, service_trace = device_trace(call), device_trace(service)
    row = dict(
        ms=time_ms(call), device_ms=trace["ms"],
        device_launches_per_call=trace["launches"],
        device_kernels=trace["by_kernel"],
        kernel_device_ms=kernels_ms(trace, "cache_probe_kernel"),
        library_ms=None,
        bound_ms=probe_bytes(n, sets, ways) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        service_ms=time_ms(service), service_device_ms=service_trace["ms"],
        max_beats_per_set=c["max_beats_per_set"])
    if full:
        order, start = cl_kernel.group_by_set_on_card(ids % sets, sets)
        outs = [torch.empty(n, dtype=torch.int32, device=dev)
                for _ in range(2)] \
            + [torch.empty_like(state.tags) for _ in range(3)] \
            + [torch.empty(1, dtype=torch.int32, device=dev)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        raw = (ids.data_ptr(), order.data_ptr(), start.data_ptr(),
               *(a.data_ptr() for a in args[1:4]), args[4].data_ptr(),
               *(o.data_ptr() for o in outs), sets, ways, n, stream)
        row["kernel_only_ms"] = time_ms(lambda: cl_kernel.LIB.launch(
            "cache_probe", *raw))
        row["plain_ms"] = time_ms(lambda: cl_kernel.cache_probe_plain(*args),
                                  reps=3)
    return {f"probe {n} beats, {sets} sets x {ways} ways": row}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    print(card(), flush=True)
    say(phase="device", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    run(torch.device("cuda", 0))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev) -> None:
    """Phases 2-5 on ``dev``; prints the ``{"kernels": [...]}`` line."""
    t0 = time.perf_counter()
    reports = _build.build()
    say(phase="build", seconds=time.perf_counter() - t0,
        kernels_built=sorted(reports))
    for name, text in reports.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "error" in line.lower()):
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs, mixed, routes = check_kernels(dev, gen)
    check_cache(dev)
    say(phase="scatter_spans", **check_scatter_spans(dev, gen))
    attn = check_attention(dev, gen)
    errs["flash_attention"] = max(r["max_abs_err"] for r in attn.values())
    say(phase="kernels_vs_plain", max_abs_err=errs, mixed_add=mixed,
        routes=routes, flash_attention=attn)

    s = run_slice(dev, gen)
    say(phase="slice", path="scheduler", seconds=s["slice_s"],
        launches=s["launches"], distinct_rows=s["distinct"],
        hot_hits=s["hot_hits"], add_max_bf16_ulps=s["add_ulps"],
        add_f32=s["add32"],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    say(phase="plain_add_repeats", **check_plain_add(dev, s))
    b = run_bulk(dev, gen)
    say(phase="slice", path="bulk", seconds=b["seconds"],
        launches=b["launches"],
        bytes_read=b["w"].numel() * 2, bytes_written=b["layer_kv"].numel() * 2)
    c = run_cache(dev, s["table"])
    say(phase="slice", path="cache", seconds=c["seconds"],
        launches=c["launches"], beats=c["ids"].numel(),
        hit_rate=c["hit_rate"], max_beats_per_set=c["max_beats_per_set"],
        host_syncs=c["host_syncs"],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    ct = run_cache_trace(dev, s["table"])
    say(phase="slice", path="cache_trace", seconds=ct["seconds"],
        launches=ct["launches"], beats=ct["beats"], hit_rate=ct["hit_rate"],
        rw_hit_rate=ct["rw_hit_rate"], writebacks=ct["writebacks"],
        max_beats_per_set=ct["max_beats_per_set"],
        host_syncs=ct["host_syncs"],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    launches = {"scheduler": s["launches"], "bulk": b["launches"],
                "cache": c["launches"], "cache_trace": ct["launches"]}
    say(phase="simulate", **run_simulate())

    t = timings(dev, s)
    t["dma_copy"] = timings_bulk(dev, b)
    # The TMA routes ran at the scheduler and bulk paths' shapes.
    for name in ("sorted_gather", "dma_copy"):
        for shape, row in t[name].items():
            for key in ("route", "inplace_route"):
                assert row.get(key, ["tma"]) == ["tma"], \
                    f"{name} {shape}: {key} {row[key]}"
    t["cache_lookup"] = timings_cache(dev, c)
    t["cache_probe_rw"] = timings_cache_trace(dev, ct)
    t["row_resolve"] = timings_row_resolve(dev, ct)
    t["flash_attention"] = timings_attention(dev, gen)
    for name, shapes in t.items():
        if name == "flash_attention":
            continue                     # its launches come from serve
        for shape, row in shapes.items():
            say(phase="timing", kernel=name, shape=shape,
                kernel_ms=row["ms"],
                **{k: v for k, v in row.items() if k != "ms"},
                launches=launches[PATH_OF[name]][name])

    # The serve path holds 69 GB of weights: free every earlier phase's
    # tensors first.
    main_row = {"bitonic_sort": t["bitonic_sort"][f"1x{BATCH * SEQ}"],
                "sorted_gather": t["sorted_gather"][f"{BATCH * SEQ}x{D_MODEL}"],
                "sorted_scatter": t["sorted_scatter"]["add"],
                "dma_copy": next(iter(t["dma_copy"].values())),
                "cache_lookup": next(iter(t["cache_lookup"].values())),
                "cache_probe_rw": next(iter(t["cache_probe_rw"].values())),
                "row_resolve": next(iter(t["row_resolve"].values())),
                "flash_attention": next(iter(
                    t["flash_attention"].values()))}
    del s, b, c, ct
    gc.collect()
    torch.cuda.empty_cache()
    say(phase="freed", allocated_gb=torch.cuda.memory_allocated(dev) / 1e9)
    v = run_serve(dev)
    say(phase="slice", path="serve", **v)
    launches["serve"] = v["launches"]
    for shape, row in t["flash_attention"].items():
        say(phase="timing", kernel="flash_attention", shape=shape,
            kernel_ms=row["ms"], **{k: x for k, x in row.items() if k != "ms"},
            launches=launches["serve"]["flash_attention"])

    # The yi-34b server's 68.78 GB are freed before the next serves.
    gc.collect()
    torch.cuda.empty_cache()
    say(phase="freed", allocated_gb=torch.cuda.memory_allocated(dev) / 1e9)
    say(phase="autotune", **run_autotune())
    for path, arch, check in (("serve_moe", SERVE_MOE_ARCH, check_moe_serve),
                              ("serve_ssm", SERVE_SSM_ARCH, check_ssm_serve)):
        v = run_family_serve(dev, arch, check)
        say(phase="slice", path=path, **v)
        launches[path] = v["launches"]
        del v
        gc.collect()
        torch.cuda.empty_cache()
    for path, run_path in (
            ("serve_hybrid", lambda: run_family_serve(
                dev, SERVE_HYBRID_ARCH, lambda server, batch:
                check_moe_serve(server, batch, SERVE_HYBRID_F32_LAYERS),
                layers=SERVE_HYBRID_LAYERS)),
            ("encoder", lambda: run_encoder(dev)),
            ("vlm", lambda: run_vlm(dev)),
            ("capture", lambda: run_capture(dev))):
        t0 = time.perf_counter()
        v = run_path()
        say(phase="slice", path=path, seconds=time.perf_counter() - t0, **v)
        launches[path] = v["launches"]
        del v
        gc.collect()
        torch.cuda.empty_cache()

    kernels = []
    for name in LIBS:
        row = main_row[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{LIBS[name].name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[PATH_OF[name]][name],
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "variants": t[name]})
    print(json.dumps({"kernels": kernels}), flush=True)

if __name__ == "__main__":
    sys.exit(main())
