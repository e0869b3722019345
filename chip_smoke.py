#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and nothing is caught:

1. Device and build: the card's name and power limit (``nvidia-smi``), the
   TF32 settings (the port needs full float32 matmuls), and the nvcc build
   of every kernel in ``src/repro_torch/kernels/csrc`` with its time.
2. The main path at SIFT1M's shape (1,000,000 × 128 float32 from the
   seeded generator ``clustered_vectors``; ε for ≈20 neighbours;
   1,000 buckets, the paper's 1‰; a cache of 10% of the data):
   ``DiskJoinIndex.build`` → ``self_join`` (device mode) →
   ``query_batch`` of 1,000 queries in host and device mode. The kernels'
   launch counts are zeroed just before and read just after; every kernel
   must have launched, every verify launch (batched and E = 1) must have
   taken the tensor-core route (``pairwise_l2_sm90.cu``), and every assign
   launch of the build too (``bucket_assign_sm90.cu``); the build's
   timings give the assign scan's share of it. The tensor-core routes'
   re-checks are tallied over the same run (verify's pairs recomputed in
   the CUDA-core arithmetic, assign's rows rescanned). Recall
   against brute force (float64, on the card) for 2,000 rows must reach
   0.88; every float64 pair touching those rows whose d² lies within the
   re-check band of ε², in buckets the join compared, must be in the
   join's pairs exactly where the CUDA-core kernel's mask has it; query
   memberships of the two modes must agree except on ε-boundary pairs.
3. Every kernel against its plain PyTorch version at the shapes the main
   path gave it, then timed beside its plain version, a library call where
   one exists, and its bound: device time from CUDA graphs, with the eager
   loop's time (launch latency included) beside it. The verify kernel's
   CUDA-core route (``pairwise_l2.cu``) is checked and timed at the
   batched shape too: the tensor-core route's mask must be its bytes on
   every pair, and its d² within the re-check band of it; both routes
   and the plain version are held against float64 on the same lanes (d²
   bias near ε², ε-pairs missed and kept: the same counts for both
   routes). Both assign routes (``bucket_assign_sm90.cu``,
   ``bucket_assign.cu``) are checked and timed at one scan block of the
   build (8,192 × 1,000 centers) and against 65,536 centers (the
   reference's center-index crossover), beside the center index's own
   matmul + argmin, and on near-ties (duplicated centers; centers moved
   by a few ulps; rows with three and four centers within the tensor
   cores' error of each other, where the tensor-core route must give the
   CUDA-core route's index and d² bytes).
4. ``[io]``, on the main path's 1M index (graph and node order cached):
   ``self_join`` with prefetch I/O (``io_mode="prefetch"``,
   ``io_batch_reads``): byte-identical to the main path's sync join (pairs
   and distances), ``execute``/``io_wait``/``compute`` and the
   prefetcher's counters logged beside the sync join's (the join with the
   planner runs in phase 7, at 100k). ``query_batch`` of the 1,000 queries with prefetch and
   the planner in host and device mode: the sync waves' memberships but
   for ε-boundary pairs. A cross-join against a second corpus of 100,000
   near-duplicates (rows of the data + N(0, 1e-3)), built striped over 4
   devices with coalescing and a spatial layout: sync and prefetch
   byte-identical, recall against float64 ≥ 0.88 on 2,000 rows of the
   second side. Every verify launch of each path (counts zeroed just
   before it) must take the tensor-core route. Then the planner's CUDA
   coefficients (copy rates, each verify engine's flush at the verify
   shape and its fixed cost; ``plan/cost_model.py``) and the IVF center
   index's assign above the crossover (8,192 rows × 65,537 centers) on the
   card against the CPU.
5. ``[serve]``, on the same 1M index (launch counts zeroed just before):
   the first 250 of the 1,000 queries through ``VectorQueryService`` one
   at a time, then the first 125 again under ``attach_live`` with a p95
   latency objective (warm hits; the rollup must count each query;
   ``query_batch``'s memberships but for ε-boundary rows; the dashboard
   logged); fig22's burst (4,096
   requests at t = 0 from 8 threads, 70% near 16 hot anchors, N(0, 0.01)
   noise, a 30 s deadline) through ``QueryScheduler`` with and without
   probe sharing (sharing must save reads; reads a request logged), then
   its first 128 requests through both policies without a deadline
   (sharing must read less on the same requests, all answered); every
   answer holds the query contract against ``query_batch``; an
   ``IndexRouter`` over two replica sessions of the 1M workdir, one
   killed (the same answers, byte for byte, through the other) and
   restarted by ``ReplicaSupervisor`` on the card; 4 spatial
   shards of 250,000 rows behind one router (the first 500 queries;
   recall against float64
   ≥ 0.88, no member outside ε beyond the boundary band); a residency
   snapshot and a warm ``reopen`` (the snapshot's buckets warm, each a
   hit for the first 64 queries, the cold session's bytes). Every verify
   launch of the phase takes the tensor-core route.
6. ``[dist]`` (launch counts zeroed just before): the superstep join
   (``core.distributed.DistributedJoin``) at 100,000 × 128
   (``[parity]``'s data and config) in host and device mode (device mode:
   the single-box join's distance computations, no E = 1 tile), with a ``JoinCheckpointer`` (every supersteps /
   16, fig25's interval), and killed by a ``FaultInjector`` at 60% of its
   supersteps and resumed from the checkpoints: every run the 100k
   single-box join's bytes, the resumed one's raw-row watermark the
   uninterrupted run's; checkpoint overhead and goodput logged beside
   fig25's gates. Then ``semantic_dedup`` on 25,000 rows and 25,000
   planted near-duplicates (rows + N(0, 1e-3)), ε = 0.05: recall of the
   planted pairs against float64 ≥ 0.88 and at least 0.88 × 25,000
   rows dropped. Every verify and assign launch takes the tensor-core
   route.
7. Byte parity of ``self_join`` at 100,000 × 128: host and device mode,
   sync and prefetch I/O, and a second build striped over 4 devices with
   coalescing; every join (device mode in each I/O × striping corner)
   gives the plain sync host join's bytes. The prefetch join again under
   ``trace_session``: its bytes, exported as a Chrome trace
   (``hidden_fraction(io.read, io.wait)`` logged beside the untraced
   join's time). A device join with every verify launch forced onto
   the CUDA-core route (``pairwise_l2.cu``): the tensor-core join's pair
   set. A resumable build killed after its assign
   scan, then resumed: no rescan, and the uninterrupted build's bucket
   files and join bytes. The join with the planner (prefetch,
   ``plan_mode="on"``, ``compute_mode="auto"``; at 100k to fit the run's
   time limit, PERF.md §4): the sync join's
   bytes, the cost model and the plan logged (routes, ``pair_cap``,
   verify batches), no compaction overflow, every verify launch on the
   tensor-core route.
8. ``[lm]``: LM serving at qwen3-0.6b's full width (28 layers, bf16
   weights from a seeded generator on the card): ``ServeEngine(slots=4,
   max_seq=512)`` serves 8 random prompts (4 of 64 tokens, 4 of 128;
   32 new tokens each, no EOS: two waves), then ``prefill`` runs on
   (4, 2048) tokens. The flash-attention launch count, zeroed just before,
   must be 28 × decode steps + 28 per prefill, every decode call served by
   the split-KV kernel (``flash_decode.cu``) and every prefill call by the
   tensor-core kernel (``flash_prefill_sm90.cu``). The kernels are held
   against their plain version at the prefill and decode shapes in bf16
   and float32 (float32 prefill runs the float32 tensor-core kernel,
   ``flash_prefill_sm90_f32.cu``, with the CUDA-core one,
   ``flash_attention.cu``, checked and timed beside it), and timed (device
   time, from CUDA graphs) beside their bound and
   ``scaled_dot_product_attention``. In float32,
   decode must reproduce the teacher-forced forward over a 64-token
   prompt, B = 4 (tests/test_models.py's tolerance).
   Then every other family at its published widths (``FAMILIES``):
   olmoe-1b-7b (6.92 B parameters), mamba2-1.3b, recurrentgemma-2b and
   whisper-small at full depth, deepseek-moe-16b cut to 4 layers and
   internvl2-26b to 2. Each (counts zeroed just before, read just after)
   serves one wave of 4 prompts of 32 tokens, 8 new tokens each,
   through ``ServeEngine`` (whisper: 1,500 stub frames encoded at batch
   4, then 8 greedy decode steps), then one (1, 2048) prefill (internvl2:
   1,024 patches, then tokens; whisper: the frames and 64 tokens). Every
   decode-step flash call must take the split-KV route and every prefill
   call the tensor-core route, attention layers x calls in all; logits
   finite; MoE prefill drops per layer logged. In float32 at full width,
   mamba2 (2 layers) and recurrentgemma (3) hold decode against the
   teacher-forced forward (rtol 2e-2, atol 2e-3); olmoe, deepseek,
   internvl2 and whisper (2 layers) hold the card's logits against the
   port's CPU path on the same weights (``CARD_CPU_TOL``), with the same
   top-k experts wherever the router's k-th and (k+1)-th probabilities
   differ by more than ``ROUTER_TOL``. The families' new attention shapes
   are held against the plain version and timed beside it, SDPA and the
   bound.
9. ``[train]``: training at qwen3-0.6b's full width and depth (28 layers,
   seeded bf16 weights made on the card): 10 steps of
   ``repro_torch.train.train`` on ``TokenPipeline`` batches of
   (4, 2048), AdamW (lr 3e-4, warmup 1, total 10), remat on; every loss
   finite and the last below the first; warm step ms, tokens/s and peak
   memory logged. Counts zeroed just before, read just after: every
   forward flash call on the tensor-core route, 28 × 2 a step (remat
   recomputes each once), and 28 backward calls a step, every one on the
   tensor-core backward (``csrc/flash_backward_sm90.cu``; none on the
   CUDA-core ``csrc/flash_backward.cu``). Then examples/train_lm.py's
   float32 model (``hundred_m_config``: 12 layers, d_model 640, 10/5
   heads of 64, vocab 32,768) at its batch of 8 x 256 tokens, 10 steps
   instead of 300, the same optimizer: the loss falls, and every forward
   and backward flash call takes the float32 tensor-core routes
   (``csrc/flash_prefill_sm90_f32.cu``, ``csrc/flash_backward_sm90_f32.cu``;
   none on a CUDA-core or bf16 route); warm step ms, tokens/s and peak
   memory logged. float32 at full width, 2 layers,
   (2, 64): the loss, every gradient and the parameters after one AdamW
   step on the card against the port's CPU path on the same weights
   (loss 1e-5 relative, gradients ‖Δ‖ ≤ 1e-4 ‖g‖). bf16, 2 layers,
   (2, 256): 6 steps checkpointed every 2 (async), the same run killed
   from ``on_step`` at step 4 and resumed, its losses the uninterrupted
   run's bit for bit; save seconds logged; 2 steps with the int8
   compressor (finite loss, nonzero error). One bf16 step each of
   olmoe-1b-7b (2 layers), recurrentgemma-2b (3), whisper-small (2 + 2,
   1,500 stub frames) and mamba2-1.3b (2) at full width: loss and
   gradients finite, every parameter moved but an untied ``lm_head``,
   flash forward and backward calls attention layers × calls. Every
   backward shape of these paths (tallied by shape while they run; qwen3's
   in float32 too) is held against ``ref.gqa_attention_bwd`` and timed
   beside the plain version, SDPA's backward and the bound, its route
   logged, and the CUDA-core backward held to the same limits and timed
   beside it (the ``kernels`` line lists both routes); training's
   forward shapes that no ``[lm]`` row covers get forward rows (the 100M
   path's in float32, the CUDA-core forward timed beside them).
10. ``[census]``: the census of one card (``repro_torch.launch.census``)
   for qwen3-0.6b × train_4k, prefill_32k and decode_32k at the per-card
   batch (one sequence; decode against a full 32,768-slot cache), and the
   join superstep (``launch/census_join.py``: E 4,096, cap 1,024, d 128,
   W 512) through ``verify_edges``; counts zeroed just before each, read
   just after. Every record ``ok``; 0 < useful FLOP ratio ≤ 1; 0 < work
   FLOPs (attention over the pairs its mask lets through) ≤ the dense
   count; the measured step no faster than its compute term (priced from
   the work count) or than one pass over its live arguments (weights,
   optimizer state, caches) at 3.35 TB/s;
   every flash forward, backward and verify launch that ``op_cost``
   counted, times the steps run, equal to the launch counters, each on
   the ``tc`` or ``split`` route. The smoke config's train, prefill and
   decode steps count the same FLOPs on the card as on the port's CPU
   path. Each record's line and the four's roofline table are logged.
   Then a kernel row for each new shape: the (1, 32,768) prefill (held on
   its last 256 query rows against the plain version over all keys), the
   T 32,768 decode (whole), the (1, 4,096) train forward and backward
   (the backward under its three limits) and the superstep's verify (held
   on 32 lanes), each timed beside its plain version, SDPA or
   ``torch.cdist`` and its bound (``roofline.kernel_cost``).

11. ``[mesh]`` (last, the parent's CUDA cache emptied first; it reads
   ``[dist]``'s 100k index, kept till then): the mesh paths. One process
   trains qwen3-0.6b at full width cut to 4 of its 28 layers (bf16, 3
   steps of (4, 2048), ``train``) for the comparisons. NCCL at world size
   1, in this process (a file rendezvous): ``DistributedJoin(mesh)`` on
   ``[dist]``'s 100k device-mode configuration (the one-card superstep
   join's bytes) and one ``train(mesh)`` step (the one process's loss).
   Then two ranks share the card under gloo (``repro_torch.launch.mesh.
   spawn``, ``Mesh({"data": 2, "model": 1})``, CUDA tensors through host
   copies): the join, its pairs and distances the one-card join's bytes,
   every verify launch of each rank on the tensor-core route, each rank's
   launches, edges and loads logged; ``train(mesh, fsdp=True)`` on the
   same 4 layers and batches, checkpointing after step 2: losses within
   1e-2 of the one process's, every flash call on the tensor-core routes
   (2 forward and 1 backward a layer a step), per-rank step ms and peak
   memory beside one card's; the checkpoint restored onto the two ranks
   (parts) and onto one process (whole), each part that rank's share of
   the whole, byte for byte; one float32 step at 2 layers, (2, 64), on a
   (1, 2) mesh against the same step in one process (loss 1e-5 relative,
   parameters as ``[train]``'s card-vs-CPU rule); GPipe over 2 stages of
   2 qwen3 blocks (float32, 4 microbatches) against the 4 blocks in order
   (1e-5); one olmoe-1b-7b MoE layer at full width (64 experts, top-8,
   float32, capacity factor 8) under the all-to-all dispatch over the
   model axis against the one-process layer (``ATTN_TOL``'s float32
   bound, the same top-k experts). The ``kernels`` rows of the verify and
   flash kernels get ``mesh_launches``, all ranks' launches in the phase.
   ``--nccl-two-ranks`` instead tries NCCL with two ranks on the one card
   and stops (the record of why the phase runs two ranks under gloo).

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA it exits nonzero
before printing any result. The sizes are fixed (``N_MAIN`` …).
``--profile`` adds a traced repeat of the device-mode join, profiled
point queries one at a time, traced LM decode steps and two traced
training steps; ``--nccl-two-ranks`` runs only its probe (phase 11).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import json
import multiprocessing
import multiprocessing.forkserver
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import list_checkpoints  # noqa: E402
from repro_torch.checkpoint import restore_latest  # noqa: E402
from repro_torch.compute import (DeviceVerifyEngine,  # noqa: E402
                                  HostVerifyEngine)
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.core import center_index  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core.index import RESIDENCY_NAME  # noqa: E402
from repro_torch.core.bucketize import sample_centers  # noqa: E402
from repro_torch.data import (clustered_vectors,  # noqa: E402
                              epsilon_for_avg_neighbors)
from repro_torch.data import dedup as dedup_mod  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist.pipeline import gpipe_forward  # noqa: E402
from repro_torch.dist.pipeline import make_pp_mesh  # noqa: E402
from repro_torch.ft import (FaultInjector, InjectedKill,  # noqa: E402
                            JoinCheckpointer)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import bucket_assign as assign  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import pairwise_l2 as verify  # noqa: E402
from repro_torch.launch import census as census_mod  # noqa: E402
from repro_torch.launch import census_join  # noqa: E402
from repro_torch.launch import dryrun as dryrun_mod  # noqa: E402
from repro_torch.launch import dryrun_join  # noqa: E402
from repro_torch.launch.collectives import COLLECTIVES  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402
from repro_torch.launch.roofline import (PEAK_BYTES,  # noqa: E402
                                         attention_counts, kernel_bound,
                                         kernel_cost)
from repro_torch.launch.mesh import (Mesh, init_distributed,  # noqa: E402
                                     spawn, stop_fork_server)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.steps import opt_state_shardings  # noqa: E402
from repro_torch.launch.steps import prepare_cell  # noqa: E402
from repro_torch.models import build_model, encdec  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import moe_a2a as moe_a2a_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.obs import Slo, dash, trace_session  # noqa: E402
from repro_torch.plan import cost_model  # noqa: E402
from repro_torch.serve import (DOWN, HEALTHY,  # noqa: E402
                               DeadlineExceeded, IndexRouter,
                               QueryScheduler, ReplicaSupervisor,
                               ServeEngine, VectorQueryService,
                               order_result)
from repro_torch.store.vector_store import BucketedVectorStore  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402
from repro_torch.train import (AdamW, AdamWConfig, TrainConfig,  # noqa: E402
                               make_int8_compressor, train)
from repro_torch.train import train_loop as train_loop_mod  # noqa: E402
from repro_torch.train.optimizer import global_norm  # noqa: E402

IMPORTED_AT = time.time()   # [mesh]: when a spawned rank has its imports

D2_RTOL, D2_ATOL = 1e-4, 1e-3   # tests/test_kernels.py's d² tolerance
MASK_BAND = 1e-2                # mask may differ only this close to ε²
DIM = 128
N_MAIN = 1_000_000      # SIFT1M's 1,000,000 x 128
N_PARITY = 100_000      # host mode fetches whole d²/mask batches: cut here
N_QUERIES = 1_000
N_RECALL_ROWS = 2_000
N_CROSS = 50_000        # the cross-join's second side: near-duplicates
N_SERVICE_QUERIES = 250  # [serve]: queries to the service, one at a time
N_LIVE_QUERIES = 125    # [serve]: the service's repeat under attach_live
N_SERVE_REQUESTS = 512  # fig22's burst: every request at t = 0
N_SAME_REQUESTS = 128   # its head, served by both policies, none dropped
SERVE_SUBMITTERS = 8
N_HOT_ANCHORS = 16
N_REPLICA_ANSWERS = 64
N_SHARDS = 4            # 250,000 rows each
N_ROUTER_QUERIES = 500  # [serve]: queries through the sharded router
N_PROFILE_QUERIES = 50  # --profile: point queries per profiled pass
N_DEDUP = 25_000        # [dist]: dedup rows, each with a planted duplicate
DEDUP_EPS = 0.05        # tests/test_system.py's dedup threshold
JOIN_KERNELS = ("pairwise_l2_threshold", "verify_pairs_batch",
                "bucket_assign")
LM_ARCH = "qwen3-0.6b"
LM_SLOTS, LM_MAX_SEQ = 4, 512
LM_PROMPT_LENS = (64, 128) * 4     # interleaved: the engine forms 2 waves
LM_NEW_TOKENS = 32
LM_PREFILL_SHAPE = (4, 2048)
LM_TF_SHAPE = (4, 64)              # decode vs teacher forcing, float32
LM_DECODE_POS = 300                # decode check: cache slots >= 301 empty
# the other families: arch → layers served (0: its published depth; the
# cuts are PERF.md §4's), each at its published widths
FAMILIES = {"olmoe-1b-7b": 0, "deepseek-moe-16b": 4, "mamba2-1.3b": 0,
            "recurrentgemma-2b": 0, "internvl2-26b": 2, "whisper-small": 0}
# one wave; 8 new tokens (16 until a run went over budget: PERF.md §4)
FAM_PROMPTS, FAM_PROMPT_LEN, FAM_NEW_TOKENS = 4, 32, 8
FAM_MAX_SEQ = 2048      # recurrentgemma's local caches hold its whole window
FAM_PREFILL = 2048      # (1, 2048): a VLM's 1,024 patches, then tokens
WHISPER_PREFILL_TOKENS = 64
# float32 decode vs teacher-forced forward at full width: (layers, (B, S));
# mamba2's S spans two SSD chunks of 256 with a ragged tail
TF_CHECKS = {"mamba2-1.3b": (2, (2, 320)), "recurrentgemma-2b": (3, (2, 64))}
# the rest: float32 card vs the port's CPU plain path at full width
CPU_CHECK_LAYERS, CPU_CHECK_TOKENS, CPU_CHECK_DECODE = 2, (2, 16), 4
CPU_CHECK_PATCHES = 32
CARD_CPU_TOL = 1e-3     # as ATTN_TOL: |card - cpu| <= tol * (1 + |cpu|)
ROUTER_TOL = 1e-6       # top-k ids agree where the k-th and (k+1)-th router
                        # probabilities differ by more (float32 probs ~1/64)
# rtol = atol, as |got - want| <= tol * (1 + |want|). bf16: one bf16 ulp
# (2^-8 relative) of the output, since a kernel whose float32 result
# differs from the plain version's in the last bits may round to the
# neighbouring bf16 value
ATTN_TOL = {torch.bfloat16: 4e-3, torch.float32: 2e-4}
VERIFY_SOURCES = {
    "tc": "src/repro_torch/kernels/csrc/pairwise_l2_sm90.cu",
    "simt": "src/repro_torch/kernels/csrc/pairwise_l2.cu"}
ASSIGN_SOURCES = {
    "tc": "src/repro_torch/kernels/csrc/bucket_assign_sm90.cu",
    "simt": "src/repro_torch/kernels/csrc/bucket_assign.cu"}
CROSSOVER_CENTERS = 65_536   # the reference's center-index crossover
FLASH_SOURCES = {
    "tc": "src/repro_torch/kernels/csrc/flash_prefill_sm90.cu",
    "tc32": "src/repro_torch/kernels/csrc/flash_prefill_sm90_f32.cu",
    "split": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"}
FLASH_BWD_SOURCES = {
    "tc": "src/repro_torch/kernels/csrc/flash_backward_sm90.cu",
    "tc32": "src/repro_torch/kernels/csrc/flash_backward_sm90_f32.cu",
    "simt": "src/repro_torch/kernels/csrc/flash_backward.cu"}
# [train]: qwen3-0.6b at full width and depth, 10 AdamW steps on
# TokenPipeline batches, remat on
TRAIN_SHAPE, TRAIN_STEPS = (4, 2048), 10
TRAIN_OPT = dict(learning_rate=3e-4, warmup_steps=1, total_steps=10)
TRAIN_CPU = (2, (2, 64))      # float32 card vs CPU: layers, (B, S)
TRAIN_RESUME = (2, (2, 256))  # kill/resume, bf16: layers, (B, S)
TRAIN_RESUME_STEPS, TRAIN_KILL_AT, TRAIN_CKPT_EVERY = 6, 4, 2
# [train]: examples/train_lm.py's float32 model (hundred_m_config) at the
# example's batch (8 x 256 tokens), 10 steps (its --tiny count) instead of
# its 300; TRAIN_OPT is the example's optimizer at 10 steps
HUNDRED_M = "qwen3-100m"
TRAIN_100M_SHAPE, TRAIN_100M_STEPS = (8, 256), 10
# one bf16 step each at full width: arch → (layers, (B, S)); whisper's S
# is its decoder's tokens over its 1,500 stub frames
TRAIN_FAMILIES = {"olmoe-1b-7b": (2, (1, 512)),
                  "recurrentgemma-2b": (3, (1, 512)),
                  "whisper-small": (2, (1, 64)),
                  "mamba2-1.3b": (2, (1, 512))}
# the families' step takes lr 1e-2: Adam's first step moves an element by
# about lr, and at 3e-4 a bf16 norm scale of 1.0 (ulp 2^-7) would not move
TRAIN_FAMILY_LR = 1e-2
# backward kernel vs its plain version, three limits a gradient, as
# tests/test_torch_cuda.py's: max |Δ| ≤ tol · max |plain| (bf16: one
# rounding of each output, in either, plus float32 sums in another order;
# float32: the sums' order); element by element |Δ| ≤ atol · max |plain| +
# rtol · |plain| (a bf16 output one ulp, ≤ 2^-7 relative, from the plain
# one: a small element, a late key's dK or dV, is held to its own size;
# the worst element read 0.63 of its limit on the tensor-core route, 0.53
# on the CUDA-core one, on an H100 80GB HBM3); ‖Δ‖ ≤ norm · ‖plain‖ (read
# there: bf16 ≤ 2.8e-4 tensor-core, ≤ 7.3e-5 CUDA-core; float32 ≤ 1.3e-6)
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
BWD_ELEM_TOL = {torch.bfloat16: (1e-3, 1e-2), torch.float32: (2e-5, 1e-4)}
BWD_NORM_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
TRAIN_CPU_LOSS_RTOL, TRAIN_CPU_GRAD_RTOL = 1e-5, 1e-4
# [census]: qwen3-0.6b's cells of one card (launch/census.py) and the join
# superstep at the reference's sizes (launch/census_join.py); each cell's
# kernels, with the route each must take
CENSUS_SHAPES = {"train_4k": ("flash_attention", "flash_attention_bwd"),
                 "prefill_32k": ("flash_attention",),
                 "decode_32k": ("flash_attention",)}
CENSUS_ROUTES = {"flash_attention": {"tc", "split"},
                 "flash_attention_bwd": {"tc"}, "verify_pairs_batch": {"tc"}}
CENSUS_SMOKE = (2, 64)       # the smoke config's steps, card vs CPU: (B, S)
CENSUS_CHECK_ROWS = 256      # the 32k prefill is held on its last rows
CENSUS_PLAIN_ROWS = 2048     # the plain 32k prefill runs in row blocks
CENSUS_VERIFY_LANES = 32     # the join's verify is held on its first lanes
CENSUS_PLAIN_LANES = 512     # the plain verify runs in lane blocks


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """Fail the run (a raise, so ``python -O`` cannot drop it)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------
def phase_device() -> None:
    log(gpu_name_and_power())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    t0 = time.perf_counter()
    _build.load()
    built = ("none, library already built in this checkout"
             if _build.build_seconds is None
             else f"{_build.build_seconds:.2f} s")
    log(f"[build] nvcc build {built}, load {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():  # per kernel: name, then use
        if ("entry function" in line or "registers" in line
                or "spill" in line or "Performance" in line):
            log(f"[build] {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: the main path at SIFT1M shape
# ---------------------------------------------------------------------------
def brute_force_recall(x: np.ndarray, eps: float, pairs: np.ndarray,
                       rows: np.ndarray) -> tuple[float, int]:
    """Recall of ``pairs`` on every true ε-pair touching ``rows``; the
    truth is float64 distances on the card."""
    xd = torch.from_numpy(x).cuda().double()
    sq = (xd * xd).sum(1)
    eps2 = float(eps) * float(eps)
    truth = []
    for i0 in range(0, rows.size, 250):
        r = torch.from_numpy(rows[i0:i0 + 250]).cuda()
        q = xd[r]
        d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ xd.T) + sq[None, :]
        qi, j = torch.nonzero(d2 <= eps2, as_tuple=True)
        i = r[qi]
        keep = i != j
        lo = torch.minimum(i[keep], j[keep])
        hi = torch.maximum(i[keep], j[keep])
        truth.append(lo * x.shape[0] + hi)
    truth = torch.unique(torch.cat(truth))
    got = torch.from_numpy(pairs[:, 0] * x.shape[0] + pairs[:, 1]).cuda()
    hit = torch.isin(truth, got)
    return hit.double().mean().item(), int(truth.numel())


def boundary_check(index, x: np.ndarray, eps: float, pairs: np.ndarray,
                   rows: np.ndarray) -> dict:
    """The ε test at the main path's size, over the whole boundary: every
    pair touching ``rows`` that the tensor-core and CUDA-core routes could
    decide differently, and whose buckets the join compared (one bucket,
    or an edge of its bucket graph), is among the join's ``pairs`` exactly
    where the CUDA-core kernel (``pairwise_l2.cu``, one lane a pair) puts
    it in its mask. Two routes can differ only where the CUDA-core d² lies
    within the re-check band of ε² (``csrc/l2_sm90.cuh``), and that d²
    lies within (2d + 4)·2⁻²³·(‖a‖² + ‖b‖²) of float64's (three float32
    FMA chains of d terms, two roundings): pairs are selected by float64
    d² within the sum of the two, with a 1e-4 margin, of the float32 ε²
    the kernels compare against."""
    n, d = x.shape
    xd = torch.from_numpy(x).cuda()
    x64 = xd.double()
    sq = (x64 * x64).sum(1)
    eps2 = ops.eps2_f32(eps)
    ku = (verify.band_scale(d) + (2 * d + 4) * 2.0 ** -23) * (1 + 1e-4)
    near = []
    for i0 in range(0, rows.size, 250):
        r = torch.from_numpy(rows[i0:i0 + 250]).cuda()
        d2 = sq[r][:, None] - 2.0 * (x64[r] @ x64.T) + sq[None, :]
        w = ku * (sq[r][:, None] + sq[None, :]) + 2.0 ** -100
        qi, j = torch.nonzero((d2 - eps2).abs() <= w, as_tuple=True)
        keep = r[qi] != j
        near.append(torch.stack([r[qi][keep], j[keep]], 1))
    near = torch.cat(near)
    bucket_of = np.empty(n, np.int64)
    for b in range(index.num_buckets):
        bucket_of[index.store.read_bucket(b)[1]] = b
    bucket_of = torch.from_numpy(bucket_of).cuda()
    graph = index._graph_for(index._resolve({}))[0]
    nb = index.num_buckets
    edges = torch.from_numpy(graph.edges[:, 0] * nb + graph.edges[:, 1])
    bi, bj = bucket_of[near[:, 0]], bucket_of[near[:, 1]]
    compared = (bi == bj) | torch.isin(
        torch.minimum(bi, bj) * nb + torch.maximum(bi, bj), edges.cuda())
    near = near[compared]
    simt = []
    for k0 in range(0, near.shape[0], 32_768):  # lanes: a grid's z extent
        p = near[k0:k0 + 32_768]
        _, m = verify.pairwise_l2_threshold_batched(
            xd[p[:, 0]][:, None], xd[p[:, 1]][:, None], ops.eps2_f32(eps),
            verify.LaunchPlan("simt"))
        simt.append(m.view(-1).bool())
    simt = torch.cat(simt) if simt else torch.zeros(0, dtype=torch.bool)
    key = (torch.minimum(near[:, 0], near[:, 1]) * n
           + torch.maximum(near[:, 0], near[:, 1]))
    got = torch.from_numpy(pairs[:, 0] * n + pairs[:, 1]).cuda()
    in_join = torch.isin(key, got)
    differ = int((in_join != simt.to(in_join.device)).sum().item())
    out = dict(band_pairs=int(compared.numel()),
               compared=int(near.shape[0]), simt_in=int(simt.sum().item()),
               join_in=int(in_join.sum().item()), differ=differ)
    log(f"[main] boundary: {out['band_pairs']} float64 pairs touching "
        f"{rows.size} rows lie within the re-check band of eps^2 widened "
        f"by the CUDA-core kernel's float32 error, "
        f"{out['compared']} in buckets the join compared; the CUDA-core "
        f"kernel keeps {out['simt_in']}, the join {out['join_in']}; they "
        f"decide {differ} differently")
    check(differ == 0, f"the join decides {differ} pairs in the band "
          f"otherwise than the CUDA-core kernel")
    return out


def check_join_output(x: np.ndarray, eps: float, res) -> None:
    p, d = res.pairs, res.distances
    check(p.ndim == 2 and p.shape[1] == 2 and p.shape[0] == d.shape[0] > 0,
          f"pairs {p.shape} / distances {d.shape}")
    check(d.dtype == np.float32 and np.isfinite(d).all(), "distances")
    check((p[:, 0] < p[:, 1]).all() and p.min() >= 0
          and p.max() < x.shape[0], "pair ids")
    # distances agree with float64 on a sample, and all lie within ε
    rng = np.random.default_rng(0)
    s = rng.choice(p.shape[0], size=min(20_000, p.shape[0]), replace=False)
    d64 = np.sqrt(((x[p[s, 0]].astype(np.float64) - x[p[s, 1]]) ** 2)
                  .sum(1))
    err = np.abs(d[s] - d64).max()
    check(err <= 1e-3, f"distance error {err} vs float64")
    check(d.max() <= eps * (1 + 1e-5) + 1e-6, "a distance exceeds eps")


def ordered(answers) -> list:
    """(ids, distances) pairs in the scheduler's order: distance, then id."""
    return [order_result(i, d, None) for i, d in answers]


def check_query_agreement(x, Q, src, eps, a, b, what: str = "query"):
    """The query contract between two answer lists of the same queries:
    finite distances within ε; the same members except ε-boundary rows
    (float64 d² within 1e-4 of ε²); distances of common members within
    1e-3; and, where ``src`` is given, (nearly) every query finds the row
    it was drawn next to (the pruning is probabilistic). Counts members
    (of ``a``), boundary differences, queries that found their row (None
    without ``src``) and answers whose bytes differ after ordering."""
    members = boundary = found = byte_diff = 0
    eps2 = float(eps) * float(eps)
    for qi, ((ai, ad), (bi, bd)) in enumerate(zip(ordered(a), ordered(b))):
        check(np.isfinite(ad).all() and np.isfinite(bd).all(),
              f"{what} {qi} distances")
        check((ad <= eps * (1 + 1e-5) + 1e-6).all(), f"{what} {qi} > eps")
        if not (np.array_equal(ai, bi) and np.array_equal(ad, bd)):
            byte_diff += 1
        if src is not None:
            found += int(src[qi] in set(ai.tolist()))
        q64 = Q[qi].astype(np.float64)
        for v in set(ai.tolist()) ^ set(bi.tolist()):
            d2 = ((x[v].astype(np.float64) - q64) ** 2).sum()
            check(abs(d2 - eps2) <= 1e-4 * max(1.0, eps2),
                  f"{what} {qi} member {v} off the boundary (d2 {d2})")
            boundary += 1
        da, db = dict(zip(ai.tolist(), ad)), dict(zip(bi.tolist(), bd))
        check(all(abs(da[k] - db[k]) <= 1e-3 for k in da if k in db),
              f"{what} {qi}: distances of common members differ")
        members += ai.size
    if src is None:
        found = None
    else:
        check(found >= 0.99 * len(a), f"{found} queries found their row")
    return dict(members=members, boundary=boundary, found=found,
                byte_diff=byte_diff)


def phase_main_path(workdir: str) -> dict:
    n, n_queries, n_recall = N_MAIN, N_QUERIES, N_RECALL_ROWS
    t = {}
    t0 = time.perf_counter()
    x = clustered_vectors(n, DIM, seed=1)
    t["data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eps = epsilon_for_avg_neighbors(x, 20)
    t["calibrate_eps"] = time.perf_counter() - t0
    store = FlatVectorStore.from_array(os.path.join(workdir, "x.bin"), x)
    cfg = JoinConfig(epsilon=eps, num_buckets=n // 1000,
                     memory_budget_bytes=x.nbytes // 10, pad_align=128,
                     compute_mode="device")
    rng = np.random.default_rng(7)
    src = rng.choice(n, size=n_queries, replace=False)
    Q = (x[src] + rng.normal(scale=1e-3, size=(n_queries, DIM))
         ).astype(np.float32)
    log(f"[main] {n} x {DIM} float32, eps={eps!r}, cfg: "
        f"num_buckets={cfg.num_buckets} memory_budget_bytes="
        f"{cfg.memory_budget_bytes} pad_align={cfg.pad_align} "
        f"verify_batch={cfg.verify_batch}")

    # --- the main path: counts zeroed just before, read just after -------
    ops.reset_launches()
    torch.cuda.synchronize()
    with verify.counting_rechecks(torch.device("cuda")) as rechecks:
        t0 = time.perf_counter()
        index = DiskJoinIndex.build(store, cfg,
                                    os.path.join(workdir, "index"))
        t["build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = index.self_join()
        torch.cuda.synchronize()
        t["self_join"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        q_host = index.query_batch(Q, compute_mode="host")
        t["query_host"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        q_dev = index.query_batch(Q, compute_mode="device")
        torch.cuda.synchronize()
        t["query_device"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # -----------------------------------------------------------------------
    inband, rescanned = (int(v) for v in rechecks.tolist())
    log(f"[main] launches {launches}")
    check(all(launches[k] > 0 for k in JOIN_KERNELS),
          f"a kernel never launched on the main path: {launches}")
    verify_launches = (launches["verify_pairs_batch"]
                       + launches["pairwise_l2_threshold"])
    check(launches["verify_simt"] == 0
          and launches["verify_tc"] == verify_launches,
          f"a verify launch left the tensor-core route: {launches}")
    check(launches["assign_simt"] == 0
          and launches["assign_tc"] == launches["bucket_assign"],
          f"an assign launch left the tensor-core route: {launches}")
    log(f"[main] re-checks: {inband} verify pairs within the band of eps^2 "
        f"recomputed in the CUDA-core arithmetic over {verify_launches} "
        f"launches ({inband / verify_launches:.2f} a launch); {rescanned} "
        f"assign rows rescanned over {launches['bucket_assign']} launches "
        f"({rescanned / launches['bucket_assign']:.2f} a launch of "
        f"{cfg.block_rows} rows)")

    check_join_output(x, eps, res)
    t0 = time.perf_counter()
    rows = np.random.default_rng(3).choice(n, size=n_recall,
                                           replace=False)
    rec, n_truth = brute_force_recall(x, eps, res.pairs, rows)
    t["recall_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    boundary = boundary_check(index, x, eps, res.pairs, rows)
    t["boundary_check"] = time.perf_counter() - t0
    agree = check_query_agreement(x, Q, src, eps, q_host, q_dev)
    pipe = res.io_stats["pipeline"]
    bt = index.build_timings
    log(f"[main] build timings {bt}; the assign scan {bt['assign']:.3f} s "
        f"of the {t['build']:.3f} s build ({bt['assign'] / t['build']:.3f})")
    log(f"[main] buckets {index.num_buckets} capacity "
        f"{index.bucket_capacity}; pairs {res.pairs.shape[0]} "
        f"distance computations {res.num_distance_computations} "
        f"candidate pairs {res.num_candidate_pairs}")
    log(f"[main] join timings "
        f"{ {k: round(v, 4) for k, v in res.timings.items()} }; outside "
        f"them (first join's node ordering): "
        f"{t['self_join'] - res.timings['execute'] - res.timings['orchestration']:.3f} s")
    log(f"[main] cache hits {res.cache_hits} misses {res.cache_misses} "
        f"bucket loads {res.bucket_loads}")
    log("[main] pipeline " + json.dumps({k: pipe[k] for k in (
        "h2d_transfers", "h2d_transfers_saved", "device_slab_hits",
        "device_batches", "device_compact_overflows", "h2d_bytes",
        "d2h_bytes", "d2h_overlap_s", "loads", "io_wait_s", "compute_s")}))
    log(f"[main] recall {rec!r} on {n_truth} true pairs touching "
        f"{n_recall} rows (need >= 0.88)")
    log(f"[main] queries {n_queries}: {agree['members']} members, "
        f"{agree['boundary']} host/device differences, all on the eps "
        f"boundary; {agree['found']} found their source row")
    log(f"[main] phase seconds {json.dumps(t)}")
    check(rec >= 0.88, f"recall {rec} < 0.88")

    per_q = index.plan_probes(Q)
    probes = np.bincount(np.concatenate(per_q),
                         minlength=index.num_buckets)
    q_rows = int(1 << max(0, int(round(probes[probes > 0].mean())) - 1)
                 .bit_length())
    shapes = dict(x=x, eps=eps, cap=index.bucket_capacity,
                  E=cfg.verify_batch, Q=Q, q_rows=q_rows,
                  centers=sample_centers(store, n // 1000, cfg.seed,
                                         cfg.block_rows),
                  block_rows=cfg.block_rows, index=index, store=store)
    return dict(launches=launches, shapes=shapes, recall=rec, res=res,
                q_host=q_host, q_dev=q_dev, src=src, cfg=cfg,
                rechecks=dict(verify_inband_pairs=inband,
                              assign_rescanned_rows=rescanned),
                boundary=boundary)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, timed
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` calls captured in
    a CUDA graph, replayed ``replays`` times between CUDA events after a
    warm replay, so the host's launch cost (tens of µs a call) does not
    set the reading of a kernel shorter than it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def check_d2(d2k, d2r, mk, mr, eps) -> tuple[float, int]:
    over = (d2k - d2r).abs() - (D2_ATOL + D2_RTOL * d2r.abs())
    check(over.max().item() <= 0, f"d2 outside tolerance by "
          f"{over.max().item()}")
    dis = mk != mr
    n_dis = int(dis.sum().item())
    if n_dis:
        band = (d2r[dis] - ops.eps2_f32(eps)).abs().max().item()
        check(band < MASK_BAND, f"mask differs {band} from eps^2")
    return (d2k - d2r).abs().max().item(), n_dis


def bucket_lanes(index, E: int) -> torch.Tensor:
    """E real buckets as (E, cap, d) slabs, rows cycled to the capacity
    (the verify kernel's intra-bucket shape with real data, no pad rows)."""
    lanes = []
    for b in range(E):
        vecs, _ = index.store.read_bucket(b % index.num_buckets)
        lanes.append(np.resize(vecs, (index.bucket_capacity, vecs.shape[1])))
    return torch.from_numpy(np.stack(lanes)).cuda()


def f64_agreement(u, v, eps, outs: dict) -> dict:
    """Each version's (d², mask) against float64 truth on the same lanes:
    the mean signed d² error where the truth lies within 0.02 of ε², and
    the true ε-pairs missed and false ones kept."""
    u64, v64 = u.double(), v.double()
    t64 = ((u64 * u64).sum(-1)[..., :, None]
           + (v64 * v64).sum(-1)[..., None, :]
           - 2.0 * (u64 @ v64.transpose(1, 2))).clamp_min(0.0)
    eps2 = float(eps) * float(eps)
    truth = t64 <= eps2
    near = (t64 - eps2).abs() < 0.02
    res = {}
    for name, (d2, mask) in outs.items():
        res[name] = dict(
            bias_near_eps=(d2.double() - t64)[near].mean().item(),
            missed=int((truth & ~mask).sum().item()),
            extra=int((mask & ~truth).sum().item()))
    res["true_pairs"] = int(truth.sum().item())
    return res


def verify_bound(e: int, m: int, n: int, d: int) -> tuple[float, str]:
    """Least time of float32-accurate verify on the card: its products as
    three TF32 tensor-core passes (the 3×TF32 split; one pass keeps too few
    digits), or each operand read once and d² + mask written once
    (``roofline.kernel_cost``)."""
    return kernel_bound(kernel_cost("verify", (e, m, n, d)))


def assign_bound(m: int, b: int, d: int) -> tuple[float, str]:
    """Least time of float32-accurate assign on the card: its products as
    three TF32 tensor-core passes (the 3×TF32 split), or X and the centers
    read once and (d², index) written once (``roofline.kernel_cost``)."""
    return kernel_bound(kernel_cost("bucket_assign", (m, b, d)))


def assign_row(xb: torch.Tensor, c: torch.Tensor) -> dict:
    """Both assign routes at (M, B, d) against the plain version: argmin
    equal, d² within tolerance, the tc route's bytes against simt's;
    device times beside the plain version, the center index's own
    matmul + argmin (context, not a yardstick) and the bound."""
    m, d = xb.shape
    b = c.shape[0]
    plan = assign.launch_plan(m, b, d)
    check(plan.route == "tc", f"assign ({m}, {b}, {d}) routed to {plan}")
    simt = assign.LaunchPlan("simt")
    dk, ik = ops.bucket_assign(xb, c)
    ds, is_ = assign.bucket_assign(xb, c, simt)
    dr, ir = ref.bucket_assign(xb, c)
    torch.cuda.synchronize()
    for route, (dv, iv) in (("tc", (dk, ik)), ("simt", (ds, is_))):
        check(torch.equal(iv, ir), f"{route} argmin differs from plain on "
              f"{int((iv != ir).sum().item())} rows at ({m}, {b}, {d})")
        over = (dv - dr).abs() - (D2_ATOL + D2_RTOL * dr.abs())
        check(over.max().item() <= 0, f"{route} assign d2 outside tolerance")
    err = (dk - dr).abs().max().item()
    err_simt = (ds - dr).abs().max().item()
    differ = int(((ik != is_) | (dk != ds)).sum().item())
    del dr, ir
    many = b > 10_000   # one call takes milliseconds: fewer in a graph
    ms = graph_ms(lambda: ops.bucket_assign(xb, c))
    simt_ms = graph_ms(lambda: assign.bucket_assign(xb, c, simt),
                       reps=5 if many else 20)
    eager = cuda_ms(lambda: ops.bucket_assign(xb, c), reps=10 if many else 50)
    plain = graph_ms(lambda: ref.bucket_assign(xb, c), reps=2 if many else 20)
    csq = torch.sum(c * c, dim=1)
    index_ms = graph_ms(lambda: center_index._nearest(xb, c, csq),
                        reps=2 if many else 20)
    bms, by = assign_bound(m, b, d)
    f32_bms, _ = kernel_bound(kernel_cost("bucket_assign", (m, b, d),
                                          route="simt"))
    log(f"[kernel] bucket_assign ({m}, {b}, {d}): route tc (block "
        f"{plan.block_m}, {plan.splits} splits); argmin equal to plain on "
        f"both routes, max abs err tc {err!r}, simt {err_simt!r}; tc bytes "
        f"differ from simt on {differ} rows; device ms tc {ms:.4f}, simt "
        f"{simt_ms:.4f} (tc {simt_ms / ms:.2f}x faster), plain {plain:.4f}, "
        f"center index matmul + argmin {index_ms:.4f} (context); eager tc "
        f"{eager:.4f}; bound {bms:.4f} ({by}; float32 CUDA-core pricing "
        f"{f32_bms:.4f}), share {bms / ms:.3f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager,
                simt_ms=simt_ms, simt_max_abs_err=err_simt,
                simt_bytes_differ=differ, f32_bound_ms=f32_bms,
                center_index_ms=index_ms, splits=plan.splits,
                shape=[m, b, d])


def assign_near_ties(xb: torch.Tensor, c: torch.Tensor) -> dict:
    """The tc route on near-ties, rows = 64 centers then the scan block.
    Centers twice (split sub-buckets share theirs): argmin equal to the
    plain version's, the lowest index wins. Each center beside a copy moved
    by 3 ulps: the result is the CUDA-core kernel's, byte for byte (both
    decide in float32 FMAs); a row that is a center gets it, at d² 0; where
    the plain version (another float32 order) picks the other of a pair,
    the pair's exact d² must lie within float32 rounding of each other."""
    rows = torch.cat([c[:64], xb[: xb.shape[0] - 64]])
    own = torch.arange(64, device=rows.device, dtype=torch.int32)
    dups = torch.cat([c, c])
    dk, ik = ops.bucket_assign(rows, dups)
    dr, ir = ref.bucket_assign(rows, dups)
    check(torch.equal(ik, ir), "near-ties: argmin differs from plain on "
          f"duplicated centers ({int((ik != ir).sum().item())} rows)")
    check(torch.equal(ik[:64], own), "near-ties: a duplicated center "
          "did not go to the lower index")
    moved = c
    for _ in range(3):
        moved = torch.nextafter(moved, torch.full_like(moved, float("inf")))
    pairs = torch.cat([c, moved])
    dk, ik = ops.bucket_assign(rows, pairs)
    ds, is_ = assign.bucket_assign(rows, pairs, assign.LaunchPlan("simt"))
    _, ir = ref.bucket_assign(rows, pairs)
    check(torch.equal(ik, is_) and torch.equal(dk, ds),
          "near-ties: tc bytes differ from simt on moved centers")
    check(torch.equal(ik[:64], own) and (dk[:64] == 0).all().item(),
          "near-ties: a row that is a center did not get it at d2 0")
    differ = ik != ir
    r64 = rows[differ].double()
    gap = ((r64 - pairs[ik[differ].long()].double()) ** 2).sum(1) \
        - ((r64 - pairs[ir[differ].long()].double()) ** 2).sum(1)
    check((gap.abs() <= 2.0 ** -20 * (r64 * r64).sum(1)).all().item(),
          "near-ties: tc and plain differ on a row that is no float32 tie")
    out = dict(rows=rows.shape[0], centers=pairs.shape[0],
               plain_differs=int(differ.sum().item()))
    for k in (3, 4):
        t0 = time.perf_counter()
        x, ck = (torch.from_numpy(a).cuda()
                 for a in tied_centers(64, c.shape[1], k, k))
        with verify.counting_rechecks(x.device) as rechecks:
            dk, ik = ops.bucket_assign(x, ck)
        ds, is_ = assign.bucket_assign(x, ck, assign.LaunchPlan("simt"))
        check(torch.equal(ik, is_) and torch.equal(dk, ds),
              f"near-ties: tc bytes differ from simt on {k}-way ties")
        out[f"{k}_way"] = dict(rows=x.shape[0], centers=ck.shape[0],
                               rescanned=int(rechecks[1].item()),
                               seconds=time.perf_counter() - t0)
    return out


def tied_centers(m: int, d: int, seed: int, k: int):
    """Rows each with k centers of their own at distance 0.3 along
    orthonormal directions, the k radii apart by a relative 1e-9 .. 1e-5
    (log-uniform): the k nearest d² lie within the tensor cores' error of
    each other (a copy of ``tests/tc_emulation.py::_tied_centers``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d))
    c = []
    for row in x:
        q, _ = np.linalg.qr(rng.normal(size=(d, k)))
        tau = (np.exp(rng.uniform(np.log(1e-9), np.log(1e-5), size=k))
               * rng.choice([-1.0, 1.0], size=k))
        c.append(row[None] + (0.3 * (1 + tau))[:, None] * q.T)
    return (np.ascontiguousarray(x, np.float32),
            np.ascontiguousarray(np.concatenate(c), np.float32))


def verify_recheck(u, v, eps2: float, tc, simt, inband: int) -> dict:
    """The tensor-core route against the CUDA-core route on the same
    lanes: mask bytes equal on every pair; d² bytes equal or within the
    re-check band (``csrc/l2_sm90.cuh``; norms summed in float32 here, so
    with a 1e-4 margin)."""
    (d2t, mt), (d2s, ms) = tc, simt
    check(torch.equal(mt, ms), f"tc mask differs from simt's on "
          f"{int((mt != ms).sum().item())} pairs")
    nu, nv = (torch.sum(t * t, dim=-1) for t in (u, v))
    w = (verify.band_scale(u.shape[-1]) * (1 + 1e-4)
         * (nu[..., :, None] + nv[..., None, :]) + 2.0 ** -100)
    share = ((d2t - d2s).abs() / w).max().item()
    check(share <= 1.0, f"tc d2 outside the band of simt's ({share})")
    return dict(inband=inband, pairs=mt.numel(),
                d2_equal=int((d2t == d2s).sum().item()),
                max_band_share=share)


def phase_kernels(main: dict) -> list[dict]:
    s = main["shapes"]
    eps, cap, E, d = s["eps"], s["cap"], s["E"], DIM
    eps2 = ops.eps2_f32(eps)
    out = []

    # verify, batched: (E, cap, d) x (E, cap, d), both routes
    u = bucket_lanes(s["index"], E)
    v = torch.roll(u, shifts=1, dims=0)   # lane e: bucket e vs bucket e-1
    v[: E // 2] = u[: E // 2]             # half the lanes intra-bucket
    plan = verify.launch_plan(cap, cap, d)
    check(plan.route == "tc", f"main verify shape routed to {plan}")
    with verify.counting_rechecks(u.device) as rechecks:
        d2k, mk = ops.verify_pairs_batch(u, v, eps)
    d2r, mr = ref.pairwise_l2_threshold(u, v, eps2)
    torch.cuda.synchronize()
    err, n_dis = check_d2(d2k, d2r, mk, mr, eps)
    n_pairs = int(mk.sum().item())
    simt = verify.LaunchPlan("simt")
    d2s, ms_ = verify.pairwise_l2_threshold_batched(u, v, eps2, simt)
    ms_ = ms_.view(torch.bool)
    torch.cuda.synchronize()
    err_simt, n_dis_simt = check_d2(d2s, d2r, ms_, mr, eps)
    t0 = time.perf_counter()
    recheck = verify_recheck(u, v, eps2, (d2k, mk), (d2s, ms_),
                             int(rechecks[0].item()))
    f64 = f64_agreement(u, v, eps, {"tc": (d2k, mk), "simt": (d2s, ms_),
                                    "plain": (d2r, mr)})
    check(all(f64["tc"][k] == f64["simt"][k] for k in ("missed", "extra")),
          f"tc and simt differ against float64: {f64}")
    recheck["seconds"] = time.perf_counter() - t0
    del d2k, mk, d2s, ms_, d2r, mr
    ms = graph_ms(lambda: ops.verify_pairs_batch(u, v, eps))
    simt_ms = graph_ms(lambda: verify.pairwise_l2_threshold_batched(
        u, v, eps2, simt))
    eager = cuda_ms(lambda: ops.verify_pairs_batch(u, v, eps))
    plain = graph_ms(lambda: ref.pairwise_l2_threshold(u, v, eps2), reps=5)
    lib = graph_ms(lambda: torch.cdist(u, v), reps=5)
    bms, by = verify_bound(E, cap, cap, d)
    log(f"[kernel] verify_pairs_batch ({E}, {cap}, {cap}, {d}): route "
        f"{plan.route} (block {plan.block_m}); max abs err {err!r}, mask "
        f"disagreements {n_dis} (all within {MASK_BAND} of eps^2), pairs in "
        f"mask {n_pairs}; simt route max abs err {err_simt!r}, mask "
        f"disagreements {n_dis_simt}; device ms tc {ms:.4f}, simt "
        f"{simt_ms:.4f} (tc {simt_ms / ms:.2f}x faster); eager tc "
        f"{eager:.4f}")
    log(f"[kernel] verify re-check on the {E} lanes: {recheck['inband']} "
        f"pairs within the band of eps^2 recomputed; tc mask bytes == "
        f"simt's on all {recheck['pairs']} pairs; tc d2 == simt's bytes on "
        f"{recheck['d2_equal']} pairs, within the band elsewhere (max "
        f"|tc - simt| / band {recheck['max_band_share']:.3e}); checks and "
        f"the float64 comparison {recheck['seconds']:.1f} s")
    log(f"[kernel] verify_pairs_batch vs float64 on the same lanes "
        f"({f64['true_pairs']} true pairs): " + "; ".join(
            f"{k} mean d2 error near eps^2 {f64[k]['bias_near_eps']:+.3e}, "
            f"missed {f64[k]['missed']}, extra {f64[k]['extra']}"
            for k in ("tc", "simt", "plain")))
    out.append(dict(
        name="pairwise_l2_threshold_batched", route="cuda",
        source=VERIFY_SOURCES["tc"],
        replaces="src/repro/kernels/pairwise_l2.py:86",
        launches=main["launches"]["verify_pairs_batch"], max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        kernel_route=plan.route, simt_ms=simt_ms, simt_max_abs_err=err_simt,
        simt_source=VERIFY_SOURCES["simt"], eager_ms=eager, f64=f64,
        recheck=recheck, main_rechecks=main["rechecks"],
        shape=[E, cap, cap, d], ok=True))

    # verify, unbatched (E = 1): the device query path's (q_rows, cap) tile
    qr = s["q_rows"]
    q = torch.from_numpy(s["Q"][:qr]).cuda()
    slab = u[0]
    plan1 = verify.launch_plan(qr, cap, d)
    check(plan1.route == "tc", f"query tile routed to {plan1}")
    d2k, mk = ops.pairwise_l2_threshold(q, slab, eps)
    d2r, mr = ref.pairwise_l2_threshold(q, slab, eps2)
    torch.cuda.synchronize()
    err1, n_dis1 = check_d2(d2k, d2r, mk, mr, eps)
    ms = graph_ms(lambda: ops.pairwise_l2_threshold(q, slab, eps))
    eager = cuda_ms(lambda: ops.pairwise_l2_threshold(q, slab, eps),
                    reps=100)
    plain = graph_ms(lambda: ref.pairwise_l2_threshold(q, slab, eps2))
    lib = graph_ms(lambda: torch.cdist(q, slab))
    bms, by = verify_bound(1, qr, cap, d)
    # lane independence: the E = 1 launch gives the batched launch's bytes,
    # and the query tile's bytes do not depend on the tile shape
    d2a, _ = ops.verify_pairs_batch(u[:2], v[:2], eps)
    d2b, _ = ops.pairwise_l2_threshold(u[1], v[1], eps)
    check(torch.equal(d2a[1], d2b), "E=1 launch differs from its lane")
    d2t, _ = verify.pairwise_l2_threshold_batched(
        q[None], slab[None], eps2, verify.LaunchPlan("tc", 128))
    check(torch.equal(d2t[0], d2k), "query tile bytes depend on the tile")
    log(f"[kernel] pairwise_l2_threshold ({qr}, {cap}, {d}): route "
        f"{plan1.route} (block {plan1.block_m}); max abs err {err1!r}, mask "
        f"disagreements {n_dis1}; E=1 launch bytes == batched lane bytes; "
        f"64- and 128-row tiles give the same bytes; device ms {ms:.4f}, "
        f"eager {eager:.4f}")
    out.append(dict(
        name="pairwise_l2_threshold", route="cuda",
        source=VERIFY_SOURCES["tc"],
        replaces="src/repro/kernels/pairwise_l2.py:128",
        launches=main["launches"]["pairwise_l2_threshold"],
        max_abs_err=err1, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib, kernel_route=plan1.route, eager_ms=eager,
        main_rechecks=main["rechecks"], shape=[qr, cap, d], ok=True))
    del u, v, d2a, d2b, d2t

    # assign: one scan-2 block against the sampled centers, then against
    # the reference's center-index crossover count, on both routes
    xb = torch.from_numpy(s["x"][: s["block_rows"]]).cuda()
    c = torch.from_numpy(s["centers"]).cuda()
    m, b = xb.shape[0], c.shape[0]
    row = assign_row(xb, c)
    c_big = torch.from_numpy(sample_centers(
        s["store"], CROSSOVER_CENTERS, 1, s["block_rows"])).cuda()
    big = assign_row(xb, c_big)
    del c_big
    ties = assign_near_ties(xb, c)
    log(f"[kernel] bucket_assign near-ties ({m} rows incl. 64 centers): "
        f"duplicated centers {b} x 2: argmin equal to plain, lowest index "
        f"wins; centers moved by 3 ulps: tc bytes == simt bytes, rows that "
        f"are centers get their own index at d2 0, plain's argmin differs "
        f"on {ties['plain_differs']} rows, each a tie within float32 "
        f"rounding (exact d2 gap <= 2^-20 |x|^2); " + "; ".join(
            f"{k}-way ties ({ties[f'{k}_way']['rows']} rows, "
            f"{ties[f'{k}_way']['centers']} centers): tc index and mind2 "
            f"bytes == simt's on every row, "
            f"{ties[f'{k}_way']['rescanned']} rows rescanned, "
            f"{ties[f'{k}_way']['seconds']:.2f} s" for k in (3, 4)))
    out.append(dict(
        name="bucket_assign", route="cuda", source=ASSIGN_SOURCES["tc"],
        replaces="src/repro/kernels/bucket_assign.py:49",
        launches=main["launches"]["bucket_assign"], **row,
        main_rechecks=main["rechecks"],
        kernel_route="tc", simt_source=ASSIGN_SOURCES["simt"],
        crossover={k: big[k] for k in (
            "shape", "max_abs_err", "ms", "simt_ms", "plain_ms", "bound_ms",
            "bound_by", "f32_bound_ms", "center_index_ms", "splits",
            "simt_bytes_differ", "simt_max_abs_err")},
        near_ties=ties, ok=True))
    for k in out:
        log(f"[kernel] {k['name']}: kernel {k['ms']:.4f} ms (eager "
            f"{k['eager_ms']:.4f}), plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), roofline share "
            f"{k['bound_ms'] / k['ms']:.3f}")
    return out


def phase_profile(index) -> None:
    """One more device-mode self_join (graph and node order cached) under
    torch.profiler: device time by kernel and copy, and the device's busy
    share of the join's wall time. Only with ``--profile``: tracing slows
    the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.self_join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    log(f"[profile] self_join wall {wall:.3f} s, device kernels + copies "
        f"{busy:.3f} s (busy share {busy / wall:.3f}, one stream)")
    for key, us, n in rows[:10]:
        log(f"[profile] {us / 1e3:10.2f} ms  {n:6d} x  {key[:90]}")


def profile_queries(index, Q: np.ndarray) -> None:
    """Where a point query's time goes, one query at a time (the query
    service's pattern): probes a query and ms a query in device and host
    mode; then, for the device mode, the host's own time by function
    (cProfile) and the kernel launches and device time a probed bucket
    (torch.profiler). Only with ``--profile``."""
    import cProfile
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = N_PROFILE_QUERIES
    probes = [len(p) for p in index.plan_probes(Q[:n])]
    ms = {}
    for mode in ("device", "host"):
        index.drop_warm_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in Q[:n]:
            index.query_batch(q[None], compute_mode=mode)
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) / n * 1e3
    log(f"[profile] point queries one at a time ({n}): {np.mean(probes):.2f} "
        f"probed buckets a query (p50 {np.percentile(probes, 50):.0f}, p95 "
        f"{np.percentile(probes, 95):.0f}); device mode {ms['device']:.2f} "
        f"ms a query, host mode {ms['host']:.2f} ms")
    index.drop_warm_cache()
    prof = cProfile.Profile()
    prof.enable()
    for q in Q[n:2 * n]:
        index.query_batch(q[None], compute_mode="device")
    prof.disable()
    st = pstats.Stats(prof)
    total = sum(v[2] for v in st.stats.values())
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:10]
    log(f"[profile] host time by function, device mode ({n} queries, "
        f"{total:.3f} s under cProfile):")
    for (path, line, fn), (_, calls, tot, cum, _) in top:
        log(f"[profile] {tot:8.3f} s own {cum:8.3f} s cum {calls:7d} x  "
            f"{os.path.basename(path)}:{line}({fn})")
    index.drop_warm_cache()
    buckets = sum(len(p) for p in index.plan_probes(Q[2 * n:3 * n]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        for q in Q[2 * n:3 * n]:
            index.query_batch(q[None], compute_mode="device")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = tprof.key_averages()
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    busy = sum(e.self_device_time_total for e in ev
               if e.device_type == DeviceType.CUDA) / 1e6
    log(f"[profile] device mode, {n} queries, {buckets} probed buckets: "
        f"{launches / buckets:.1f} kernel launches and "
        f"{busy / buckets * 1e3:.4f} ms of device time a bucket; busy "
        f"share {busy / wall:.3f} of {wall:.3f} s (traced)")


# ---------------------------------------------------------------------------
# phase 4: the I/O pipeline, the planner, the cross-join (1M index)
# ---------------------------------------------------------------------------
def verify_launches_all_tc(launches: dict, what: str) -> int:
    n = launches["verify_pairs_batch"] + launches["pairwise_l2_threshold"]
    check(n > 0, f"{what}: no verify launch")
    check(launches["verify_simt"] == 0 and launches["verify_tc"] == n,
          f"{what}: a verify launch left the tensor-core route: {launches}")
    return n


def assign_launches_all_tc(launches: dict, what: str) -> None:
    check(launches["assign_simt"] == 0
          and launches["assign_tc"] == launches["bucket_assign"] > 0,
          f"{what}: an assign launch left the tensor cores: {launches}")


def check_identical(a, b, what: str) -> None:
    check(np.array_equal(a.pairs, b.pairs), f"{what}: pairs differ")
    check(np.array_equal(a.distances, b.distances),
          f"{what}: distances differ")


def pipeline_line(r) -> dict:
    p = r.io_stats["pipeline"]
    out = {k: round(r.timings[k], 4) for k in ("execute", "io_wait",
                                                "compute")}
    out.update({k: p[k] for k in (
        "loads", "stalls", "flush_on_stall", "blocked_acquires",
        "max_queue_depth", "max_slabs_in_use", "pool_slabs",
        "batched_submissions", "coalesced_reads", "coalesced_buckets",
        "device_compact_overflows")})
    out["read_s"] = round(p["read_s"], 4)
    out["overlap_efficiency"] = round(p["overlap_efficiency"], 4)
    return out


class _Slabs:
    """A verify engine's cache surface over fixed host slabs."""

    def __init__(self, slabs: np.ndarray):
        self.slabs = slabs
        self.ids = np.arange(slabs.shape[1], dtype=np.int64)

    def checkout(self, b: int):
        return (self.slabs[b], self.ids, self.slabs.shape[1], None)

    def release(self, entry) -> None:
        pass


def engine_flush_s(kind: str, slabs: np.ndarray, eps: float, edges: int,
                   reps: int = 5) -> float:
    """Median wall time of one flush of ``edges`` edges (lane e: slab e vs
    slab e + 1) through a real verify engine, results fetched to the host.
    The device engine's operands are resident from a warm pass, so a flush
    pays verify, compaction and the compacted readback, not slab copies."""
    cache = _Slabs(slabs)
    cap, dim = slabs.shape[1], slabs.shape[2]
    kw = dict(epsilon=eps, capacity_rows=cap, dim=dim, verify_batch=edges,
              device=torch.device("cuda"))
    eng = (HostVerifyEngine(cache, **kw) if kind == "host"
           else DeviceVerifyEngine(cache, **kw))
    times = []
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(edges):
            eng.enqueue(e, e + 1, False)
        eng.finish()
        torch.cuda.synchronize()
        if rep:  # the first pass warms the kernels and the slab pool
            times.append(time.perf_counter() - t0)
        eng.pairs_out.clear()
        eng.dists_out.clear()
    eng.abort()
    return float(np.median(times))


def copy_gb_s(nbytes: int, direction: str, pinned: bool) -> float:
    """Host↔device copy rate of one ``nbytes`` copy (median of 5)."""
    n = nbytes // 4
    host = torch.empty(n, dtype=torch.float32, pin_memory=pinned)
    host.numpy()[:] = 1.0
    dev = torch.empty(n, dtype=torch.float32, device="cuda")
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if direction == "h2d":
            dev.copy_(host, non_blocking=pinned)
            torch.cuda.synchronize()
        else:
            if pinned:
                host.copy_(dev, non_blocking=True)
                torch.cuda.synchronize()
            else:
                dev.cpu()   # the host engine's fetch: a fresh pageable copy
        times.append(time.perf_counter() - t0)
    return nbytes / float(np.median(times[1:])) / 1e9


def calibrate_cost_model(index, eps: float, E: int) -> dict:
    """The planner's CUDA coefficients on this card (``CostModel``'s
    static tier): copy rates at a slab-sized and a batch-sized copy, each
    engine's flush at the verify shape (E, cap, cap, d), and each engine's
    fixed cost (a flush of one 64-row lane). The per-cell costs are what
    is left of the measured flush once the model's link and dispatch terms
    are taken out, so ``CostModel`` reproduces the measured flush."""
    cap, d = index.bucket_capacity, index.dim
    slab_bytes = cap * d * 4
    batch_bytes = E * slab_bytes
    fetch_bytes = E * cap * cap * 5   # the host engine's d² + mask fetch
    rates = {
        "h2d_pinned_slab": copy_gb_s(slab_bytes, "h2d", True),
        "h2d_pinned_batch": copy_gb_s(batch_bytes, "h2d", True),
        "d2h_pinned_slab": copy_gb_s(slab_bytes, "d2h", True),
        "d2h_pageable_fetch": copy_gb_s(fetch_bytes, "d2h", False),
    }
    lanes = bucket_lanes(index, E + 1).cpu().numpy()
    t_host = engine_flush_s("host", lanes, eps, E)
    t_dev = engine_flush_s("device", lanes, eps, E)
    small = np.ascontiguousarray(lanes[:2, :64])
    t_host_fixed = engine_flush_s("host", small, eps, 1, reps=20)
    t_dev_fixed = engine_flush_s("device", small, eps, 1, reps=20)
    cells = E * cap * cap
    h2d, d2h = rates["h2d_pinned_batch"], rates["d2h_pageable_fetch"]
    # the device engine's readback: compacted triples of its pair_cap
    dev_fetch = E * (8 * cap * 12 + 4)
    link_host = (E * 2 * slab_bytes / h2d + fetch_bytes / d2h) / 1e9
    link_dev = dev_fetch / d2h / 1e9
    coef = dict(
        h2d_gb_s=h2d, d2h_gb_s=d2h,
        host_cell_ns=(t_host - link_host - t_host_fixed) / cells * 1e9,
        device_cell_ns=(t_dev - link_dev - t_dev_fixed) / cells * 1e9,
        host_dispatch_s=t_host_fixed, device_dispatch_s=t_dev_fixed)
    check(coef["host_cell_ns"] > 0 and coef["device_cell_ns"] > 0,
          f"cost model: a per-cell cost came out <= 0: {coef}")
    log(f"[io] cost model, measured on this card: copy rates GB/s "
        f"{json.dumps({k: round(v, 3) for k, v in rates.items()})}; flush "
        f"at ({E}, {cap}, {cap}, {d}): host {t_host * 1e3:.3f} ms, device "
        f"{t_dev * 1e3:.3f} ms; one 64-row lane: host "
        f"{t_host_fixed * 1e3:.4f} ms, device {t_dev_fixed * 1e3:.4f} ms")
    log("[io] cost model coefficients measured "
        + json.dumps({k: float(f"{v:.6g}") for k, v in coef.items()})
        + "; in code " + json.dumps(cost_model._CUDA_STATIC))
    return dict(rates=rates, coef=coef, flush_host_s=t_host,
                flush_device_s=t_dev)


def cross_recall(x: np.ndarray, y: np.ndarray, eps: float,
                 pairs: np.ndarray, rows: np.ndarray) -> tuple[float, int]:
    """Recall of a cross-join's pairs (x id, len(x) + y id) on every true
    ε-pair of the sampled ``rows`` of y; the truth is float64 on the card."""
    xd = torch.from_numpy(x).cuda().double()
    sq = (xd * xd).sum(1)
    eps2 = float(eps) * float(eps)
    n_x = x.shape[0]
    truth = []
    for i0 in range(0, rows.size, 250):
        r = torch.from_numpy(rows[i0:i0 + 250]).cuda()
        q = torch.from_numpy(y[rows[i0:i0 + 250]]).cuda().double()
        d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ xd.T) + sq[None, :]
        qi, j = torch.nonzero(d2 <= eps2, as_tuple=True)
        truth.append(j * (n_x + y.shape[0]) + n_x + r[qi])
    truth = torch.unique(torch.cat(truth))
    got = torch.from_numpy(pairs[:, 0] * (n_x + y.shape[0])
                           + pairs[:, 1]).cuda()
    return (torch.isin(truth, got).double().mean().item(),
            int(truth.numel()))


def ivf_assign_timing(store) -> dict:
    """Scan 2 above the reference's crossover: the IVF center index's
    assign of one scan block (8,192 rows) against 65,537 centers sampled
    from the smoke data, on the card and on the CPU; the two must agree
    except on float32 ties (two centers whose float64 d² lie within
    2^-20 |x|² of each other)."""
    centers = sample_centers(store, CROSSOVER_CENTERS + 1, 5, 8192)
    x = np.ascontiguousarray(store.read_rows(np.arange(8192)),
                             dtype=np.float32)
    t0 = time.perf_counter()
    on_card = center_index.make_center_index(centers, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(isinstance(on_card, center_index.IVFCenterIndex),
          "65,537 centers did not select the IVF index")
    t0 = time.perf_counter()
    d_card, i_card = on_card.assign(x)
    t_assign = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = center_index.make_center_index(centers, device="cpu")
    d_cpu, i_cpu = on_cpu.assign(x)
    t_cpu = time.perf_counter() - t0
    same = i_card == i_cpu
    over = (np.abs(d_card[same] - d_cpu[same])
            - (D2_ATOL + D2_RTOL * np.abs(d_cpu[same])))
    check((over <= 0).all(), "IVF assign d2 on the card outside tolerance")
    x64, c64 = x[~same].astype(np.float64), centers.astype(np.float64)
    gap = (((x64 - c64[i_card[~same]]) ** 2).sum(1)
           - ((x64 - c64[i_cpu[~same]]) ** 2).sum(1))
    check((np.abs(gap) <= 2.0 ** -20 * (x64 * x64).sum(1)).all(),
          f"IVF assign: {int((~same).sum())} rows differ from the CPU's "
          f"off float32 ties")
    log(f"[io] IVF assign above the crossover (8192 rows x "
        f"{centers.shape[0]} centers, nprobe {on_card.nprobe}, "
        f"{on_card.ncoarse} cells): card build {t_build:.3f} s, assign "
        f"{t_assign:.3f} s ({t_assign / 8192 * 1e6:.1f} us a row, one "
        f".cpu() a row); CPU build + assign {t_cpu:.3f} s; ids equal on "
        f"{int(same.sum())} rows, {int((~same).sum())} float32 ties")
    return dict(build_s=t_build, assign_s=t_assign, cpu_s=t_cpu,
                tie_rows=int((~same).sum()))


AUTO = dict(io_mode="prefetch", plan_mode="on", compute_mode="auto")


def planned_join(index, ref, tag: str) -> dict:
    """The join with the planner (prefetch, ``compute_mode="auto"``):
    byte-identical to ``ref``, every verify launch on the tensor-core
    route, no compaction overflow; logs the plan. Returns its launches."""
    cost = index._planner_for(index._resolve(dict(AUTO))).cost
    log(f"[{tag}] cost model: {cost.describe()}")
    ops.reset_launches()
    t0 = time.perf_counter()
    planned = index.self_join(**AUTO)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches_snapshot()
    verify_launches_all_tc(launches, "planned join")
    check_identical(ref, planned, "planned auto vs sync join")
    plan = planned.plan
    routes = {r: sum(1 for rt, _ in plan.unit_params if rt == r)
              for r in ("host", "device")}
    batches = sorted({b for _, b in plan.unit_params})
    overflows = planned.io_stats["pipeline"]["device_compact_overflows"]
    log(f"[{tag}] planned join (prefetch, plan on, compute auto) "
        f"{wall:.3f} s: byte-identical to the sync join; plan "
        f"{plan.compute_mode}, units {plan.num_units} (host "
        f"{routes['host']}, device {routes['device']}), pair_cap "
        f"{plan.pair_cap}, verify batches {batches[0]}..{batches[-1]} "
        f"({len(batches)} distinct), est pairs {plan.est_total:.4g} [hi "
        f"{plan.hi_total:.4g}], device compaction overflows {overflows}; "
        f"verify launches {launches['verify_pairs_batch']}, all tc")
    log(f"[{tag}] planned  " + json.dumps(pipeline_line(planned)))
    log(f"[{tag}] " + plan.explain().replace("\n", f"\n[{tag}] "))
    check(overflows == 0, f"the planned join overflowed its pair_cap "
          f"{overflows} times")
    return launches


def phase_io(main: dict, workdir: str) -> dict:
    """Prefetch I/O on the 1M index that the main path built (graph and
    node order cached), the prefetched and planned query waves, a
    cross-join against a striped near-duplicate corpus, the cost model's
    coefficients, and the IVF assign's time. Each driven path has its
    launch counts zeroed just before and read just after."""
    s = main["shapes"]
    index, x, eps, Q = s["index"], s["x"], s["eps"], s["Q"]
    res = main["res"]
    out = {}
    t = {}

    # 1. prefetch join: byte-identical to the main path's sync join
    ops.reset_launches()
    t0 = time.perf_counter()
    pre = index.self_join(io_mode="prefetch", io_batch_reads=True)
    torch.cuda.synchronize()
    t["prefetch_join"] = time.perf_counter() - t0
    launches_pre = ops.launches_snapshot()
    verify_launches_all_tc(launches_pre, "prefetch join")
    check_identical(res, pre, "prefetch vs sync join")
    out["sync"], out["prefetch"] = pipeline_line(res), pipeline_line(pre)
    log(f"[io] prefetch join (1M, device mode, io_batch_reads): "
        f"byte-identical to the sync join; verify launches "
        f"{launches_pre['verify_pairs_batch']}, all tc")
    log("[io] sync     " + json.dumps(out["sync"]))
    log("[io] prefetch " + json.dumps(out["prefetch"]))

    # (the planned join, compute_mode="auto", runs in [parity] at 100k:
    # PERF.md §4's cuts)

    # 2. prefetched, planned query waves: the sync waves' memberships
    ops.reset_launches()
    qt = {}
    q_out = {}
    for mode in ("host", "device"):
        index.drop_warm_cache()
        t0 = time.perf_counter()
        q_out[mode] = index.query_batch(Q, io_mode="prefetch",
                                        plan_mode="on", compute_mode=mode)
        torch.cuda.synchronize()
        qt[mode] = time.perf_counter() - t0
    launches_q = dict(ops.LAUNCHES)
    verify_launches_all_tc(launches_q, "prefetched query waves")
    for mode, sync in (("host", main["q_host"]), ("device", main["q_dev"])):
        agree = check_query_agreement(x, Q, main["src"], eps, sync,
                                      q_out[mode])
        log(f"[io] query_batch {len(Q)} (prefetch, plan on, {mode}): "
            f"{qt[mode]:.3f} s; {agree['members']} members, "
            f"{agree['boundary']} differences from the sync {mode} wave, "
            f"all on the eps boundary")
    check_query_agreement(x, Q, main["src"], eps, q_out["host"],
                          q_out["device"])
    out["query_s"] = qt

    # 3. cross-join against a striped near-duplicate corpus
    n_y = N_CROSS
    rng = np.random.default_rng(17)
    y = (x[rng.choice(x.shape[0], size=n_y, replace=False)]
         + rng.normal(scale=1e-3, size=(n_y, DIM))).astype(np.float32)
    ystore = FlatVectorStore.from_array(os.path.join(workdir, "y.bin"), y)
    ycfg = dataclasses.replace(main["cfg"], num_buckets=n_y // 1000,
                               io_devices=4, io_coalesce=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    other = DiskJoinIndex.build(ystore, ycfg, os.path.join(workdir, "yidx"),
                                layout="spatial")
    t["cross_build"] = time.perf_counter() - t0
    check(other.store.num_devices == 4, "the second side is not striped")
    t0 = time.perf_counter()
    c_sync = index.cross_join(other)
    torch.cuda.synchronize()
    t["cross_sync"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_pre = index.cross_join(other, io_mode="prefetch", io_batch_reads=True)
    torch.cuda.synchronize()
    t["cross_prefetch"] = time.perf_counter() - t0
    launches_x = dict(ops.LAUNCHES)
    verify_launches_all_tc(launches_x, "cross-join")
    assign_launches_all_tc(launches_x, "the striped build")
    check_identical(c_sync, c_pre, "cross-join sync vs prefetch")
    n_x = x.shape[0]
    p = c_sync.pairs
    check(p.shape[0] > 0 and (p[:, 0] < n_x).all()
          and (p[:, 1] >= n_x).all() and (p[:, 1] < n_x + n_y).all(),
          "cross-join pair ids")
    d64 = np.sqrt(((x[p[:5000, 0]].astype(np.float64)
                    - y[p[:5000, 1] - n_x]) ** 2).sum(1))
    check(np.abs(c_sync.distances[:5000] - d64).max() <= 1e-3,
          "cross-join distances vs float64")
    rows = np.random.default_rng(4).choice(n_y, size=N_RECALL_ROWS,
                                           replace=False)
    rec, n_truth = cross_recall(x, y, eps, p, rows)
    pipe = c_pre.io_stats["pipeline"]
    out["cross"] = dict(pairs=int(p.shape[0]), recall=rec,
                        sync=pipeline_line(c_sync),
                        prefetch=pipeline_line(c_pre),
                        device_loads=pipe["device_loads"])
    log(f"[io] cross-join {n_x} x {n_y} (striped side: 4 devices, coalesced, "
        f"spatial layout; built in {t['cross_build']:.3f} s): "
        f"{p.shape[0]} pairs, sync and prefetch byte-identical; recall "
        f"{rec!r} on {n_truth} true pairs of {N_RECALL_ROWS} rows of the "
        f"second side (need >= 0.88); verify launches "
        f"{launches_x['verify_pairs_batch']}, all tc")
    log(f"[io] cross-join prefetch: per-device loads {pipe['device_loads']} "
        f"(device 0: the 1M side), coalesced reads {pipe['coalesced_reads']}"
        f" of {pipe['coalesced_buckets']} buckets, batched submissions "
        f"{pipe['batched_submissions']}")
    log("[io] cross sync     " + json.dumps(out["cross"]["sync"]))
    log("[io] cross prefetch " + json.dumps(out["cross"]["prefetch"]))
    check(rec >= 0.88, f"cross-join recall {rec} < 0.88")
    other.close()

    # 4. the planner's CUDA coefficients, and the IVF assign's time
    t0 = time.perf_counter()
    out["cost_model"] = calibrate_cost_model(index, eps, s["E"])
    t["calibrate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ivf"] = ivf_assign_timing(s["store"])
    t["ivf"] = time.perf_counter() - t0
    log(f"[io] phase seconds {json.dumps({k: round(v, 3) for k, v in t.items()})}")
    out["launches"] = dict(prefetch=launches_pre, queries=launches_q,
                           cross=launches_x)
    return out


# ---------------------------------------------------------------------------
# phase 5: serving over the 1M index (scheduler, service, live, replicas)
# ---------------------------------------------------------------------------
def fig22_requests(x: np.ndarray, n: int, rng) -> np.ndarray:
    """fig22's request stream (``benchmarks/fig22_scheduler.py:47-57``):
    70% of queries near one of 16 hot anchors, 30% roaming, plus
    N(0, 0.01) noise."""
    anchors = x[rng.choice(x.shape[0], N_HOT_ANCHORS, replace=False)]
    hot = anchors[rng.integers(0, N_HOT_ANCHORS, n)]
    roam = x[rng.choice(x.shape[0], n)]
    pick = rng.random(n) < 0.7
    q = np.where(pick[:, None], hot, roam)
    return (q + rng.normal(scale=0.01, size=q.shape)).astype(np.float32)


def serve_burst(index, reqs: np.ndarray, share: bool,
                deadline_s: float | None) -> dict:
    """All of ``reqs`` submitted at t = 0 from ``SERVE_SUBMITTERS``
    threads to a fresh scheduler (fig22's wave settings), traced; returns
    the answers (None for a request its deadline dropped, which is
    counted, not an error), latencies, reads and waves."""
    index.drop_warm_cache()
    base = index.pipeline_snapshot()
    answers = [None] * len(reqs)
    lat = np.zeros(len(reqs))
    go = threading.Barrier(SERVE_SUBMITTERS + 1)
    with trace_session(ring_capacity=1 << 20) as tr:
        sched = QueryScheduler(index, wave_size=32, max_wait_s=0.005,
                               max_queue=len(reqs), share_probes=share)

        def submitter(k):
            go.wait()
            futs = [(i, sched.submit(reqs[i], deadline_s=deadline_s))
                    for i in range(k, len(reqs), SERVE_SUBMITTERS)]
            for i, f in futs:
                try:
                    answers[i] = f.result(timeout=120)
                except DeadlineExceeded:
                    pass
                lat[i] = f.latency_s

        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(SERVE_SUBMITTERS)]
        for th in threads:
            th.start()
        go.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        sched.close()
        snap = sched.snapshot()
    pipe = index.pipeline_snapshot()
    reads = sum(pipe[k] - base[k] for k in ("query_reads",
                                            "query_fallback_reads"))
    spans = sum(1 for e in tr.events() if e.get("name") == "serve.wave")
    dropped = sum(a is None for a in answers)
    check(dropped == snap["deadline_drops"], f"{dropped} requests without "
          f"an answer, {snap['deadline_drops']} deadline drops")
    answered = len(reqs) - dropped
    check(answered > 0, "the burst answered no request")
    return dict(answers=answers, wall_s=wall, waves=snap["waves"],
                wave_spans=spans, reads=reads, answered=answered,
                reads_per_query=reads / len(reqs),
                reads_per_answer=reads / answered,
                saved=pipe["reads_saved_by_sharing"]
                - base["reads_saved_by_sharing"],
                drops=snap["deadline_drops"],
                p50_ms=float(np.percentile(lat, 50)) * 1e3,
                p95_ms=float(np.percentile(lat, 95)) * 1e3)


def pc1_split(x: np.ndarray, parts: int) -> list[np.ndarray]:
    """Row ids of ``parts`` equal spatial slabs: sorted along the data's
    first principal axis (float64 covariance on the card) and cut."""
    xd = torch.from_numpy(x).cuda().double()
    xc = xd - xd.mean(0)
    _, vecs = torch.linalg.eigh(xc.T @ xc)
    key = (xc @ vecs[:, -1]).cpu().numpy()
    order = np.argsort(key, kind="stable")
    return np.array_split(order, parts)


def brute_force_members(x: np.ndarray, Q: np.ndarray, eps: float) -> list:
    """Every row within ε of each query (float64 on the card)."""
    xd = torch.from_numpy(x).cuda().double()
    sq = (xd * xd).sum(1)
    eps2 = float(eps) * float(eps)
    out = []
    for i0 in range(0, Q.shape[0], 250):
        q = torch.from_numpy(Q[i0:i0 + 250]).cuda().double()
        d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ xd.T) + sq[None, :]
        qi, j = torch.nonzero(d2 <= eps2, as_tuple=True)
        qi, j = qi.cpu().numpy(), j.cpu().numpy()
        for k in range(q.shape[0]):
            out.append(set(j[qi == k].tolist()))
    return out


def phase_serve(main: dict, workdir: str) -> dict:
    """The serving layer over the 1M index the main path built: the query
    service (its repeat under live observability), the wave scheduler
    under fig22's burst, a replicated router with a killed replica and a
    supervised restart, a 4-shard scatter/gather, and a residency snapshot
    with a warm reopen. Launch counts are zeroed just before the phase and
    read just after."""
    s = main["shapes"]
    index, x, eps, Q = s["index"], s["x"], s["eps"], s["Q"]
    out, t = {}, {}
    ops.reset_launches()
    t_phase = time.perf_counter()

    # 1. the query service: one request at a time, then the same again
    # under live observability (a p95 latency objective)
    index.drop_warm_cache()
    svc = VectorQueryService(index)
    t0 = time.perf_counter()
    first = [svc.query(q) for q in Q[:N_SERVICE_QUERIES]]
    t["service_first"] = time.perf_counter() - t0
    hits0 = index.pipeline_snapshot()["query_warm_hits"]
    live = index.attach_live(window_s=0.2, windows=3000, slos=(
        Slo.latency("query_p95", "query.execute", threshold_s=0.05,
                    objective=0.9),))
    t0 = time.perf_counter()
    again = [svc.query(q) for q in Q[:N_LIVE_QUERIES]]
    t["service_repeat_live"] = time.perf_counter() - t0
    warm_hits = index.pipeline_snapshot()["query_warm_hits"] - hits0
    svc.close()
    time.sleep(0.25)
    live.poll()
    n_exec = index.metrics_snapshot()["live"]["spans"]["query.execute"][
        "count"]
    board = dash.render(index)
    consts = live.live_constants()
    index.detach_live()
    check(warm_hits > 0, "the repeated service queries never hit warm")
    check(n_exec == N_LIVE_QUERIES, f"live rollup counted {n_exec} "
          f"query.execute spans for {N_LIVE_QUERIES} queries")
    vs_batch = check_query_agreement(
        x, Q[:N_SERVICE_QUERIES], main["src"][:N_SERVICE_QUERIES], eps,
        first, main["q_dev"][:N_SERVICE_QUERIES], "service query")
    vs_again = check_query_agreement(x, Q[:N_LIVE_QUERIES], None, eps,
                                     first[:N_LIVE_QUERIES], again,
                                     "service repeat")
    out["service"] = dict(first_s=t["service_first"],
                          repeat_s=t["service_repeat_live"],
                          warm_hits=warm_hits, vs_batch=vs_batch,
                          repeat_byte_diff=vs_again["byte_diff"])
    out["live"] = dict(count=n_exec, constants=consts)
    log(f"[serve] VectorQueryService {N_SERVICE_QUERIES} queries one at a "
        f"time: "
        f"{t['service_first']:.3f} s, the first {N_LIVE_QUERIES} repeated "
        f"under attach_live {t['service_repeat_live']:.3f} s ({warm_hits} "
        f"warm hits); "
        f"against query_batch: {vs_batch['members']} members, "
        f"{vs_batch['boundary']} differences, all on the eps boundary, "
        f"{vs_batch['byte_diff']} answers differ in their bytes; repeat "
        f"differs in {vs_again['byte_diff']}; live rollup query.execute "
        f"count {n_exec}")
    log("[serve] " + board.replace("\n", "\n[serve] "))
    log("[serve] live cost constants " + json.dumps(consts, default=str))

    # 2. the wave scheduler under fig22's burst, with and without sharing;
    # then both policies on the same requests, all answered
    reqs = fig22_requests(x, N_SERVE_REQUESTS, np.random.default_rng(22))
    t0 = time.perf_counter()
    truth = index.query_batch(reqs)
    t["burst_query_batch"] = time.perf_counter() - t0
    burst = {}
    for n_reqs, deadline in ((N_SERVE_REQUESTS, 30.0), (N_SAME_REQUESTS,
                                                        None)):
        for share in (True, False):
            key = ("shared" if share else "naive") + (
                "" if deadline else "_same")
            b = serve_burst(index, reqs[:n_reqs], share, deadline)
            got = b.pop("answers")
            kept = [i for i, a in enumerate(got) if a is not None]
            b["vs_batch"] = check_query_agreement(
                x, reqs[kept], None, eps, [got[i] for i in kept],
                [truth[i] for i in kept], f"scheduler ({key}) request")
            burst[key] = b
            t[f"burst_{key}"] = b["wall_s"]
            log(f"[serve] scheduler {key} ({n_reqs} requests at t=0 from "
                f"{SERVE_SUBMITTERS} threads, wave 32, max_wait 5 ms, "
                f"deadline {deadline} s): wall {b['wall_s']:.3f} s, waves "
                f"{b['waves']} (serve.wave spans {b['wave_spans']}), p50 "
                f"{b['p50_ms']:.1f} ms, p95 {b['p95_ms']:.1f} ms, reads "
                f"{b['reads']} ({b['reads_per_query']:.3f} a request, "
                f"{b['reads_per_answer']:.3f} an answer), saved by sharing "
                f"{b['saved']}, deadline drops {b['drops']} (answered "
                f"{b['answered']}, {b['answered'] / b['wall_s']:.1f} a "
                f"second); against query_batch: "
                f"{b['vs_batch']['boundary']} boundary differences, "
                f"{b['vs_batch']['byte_diff']} answers differ in their "
                f"bytes")
    # the 30 s deadline drops most of the burst before any read, and the
    # two policies answer different requests: their reads a request are
    # logged, and held against each other on the same requests, all
    # answered
    shared, naive = burst["shared"], burst["naive"]
    log(f"[serve] burst reads a request (deadline 30 s): shared "
        f"{shared['reads_per_query']:.3f}, naive "
        f"{naive['reads_per_query']:.3f} (answered {shared['answered']} "
        f"and {naive['answered']}); the same {N_SAME_REQUESTS} requests, "
        f"no deadline: shared "
        f"{burst['shared_same']['reads_per_query']:.3f}, naive "
        f"{burst['naive_same']['reads_per_query']:.3f}")
    check(shared["saved"] > 0, "probe sharing saved no read")
    check(burst["shared_same"]["answered"] == N_SAME_REQUESTS
          and burst["naive_same"]["answered"] == N_SAME_REQUESTS,
          "a request without a deadline went unanswered")
    check(burst["shared_same"]["reads"] < burst["naive_same"]["reads"],
          "shared waves read no less than the naive policy on the same "
          "requests")
    check(shared["wave_spans"] > 0, "no serve.wave span traced")
    out["burst"] = burst

    # 3. replicas and failover: two sessions of the 1M workdir on the card
    reps = [DiskJoinIndex.open(index.workdir) for _ in range(2)]
    for r in reps:      # first-use costs before any deadline applies
        r.query_batch(Q[:8])
    router = IndexRouter([reps], epsilon=eps, close_shards=True,
                         scheduler=dict(max_wait_s=0.001))
    rset = router.replica_sets[0]
    qs = Q[:N_REPLICA_ANSWERS]
    t0 = time.perf_counter()
    before = [router.query(q, timeout=120) for q in qs]
    dead = rset.replicas[0]
    FaultInjector().kill_replica(dead)
    for r in rset.replicas:     # both in the rotation: the kill is met
        r.service_ewma = 0.001
    after = [router.query(q, timeout=120) for q in qs]
    failovers = rset.snapshot()["counters"]["failovers"]
    state_dead = dead.health.state
    sup = ReplicaSupervisor(router)
    restarted = sup.poll_once()
    restarted_answers = [dead.scheduler.query(q, timeout=120) for q in qs]
    t["replicas"] = time.perf_counter() - t0
    same_after = sum(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                     for a, b in zip(before, after))
    same_restart = sum(np.array_equal(a[0], b[0])
                       and np.array_equal(a[1], b[1])
                       for a, b in zip(before, restarted_answers))
    pool = dead.index._pool
    warm_pins = pool.in_use
    n_warm = len(dead.index.warm_buckets())
    dead.index.drop_warm_cache()
    pins_left = pool.in_use
    device = str(dead.index.device)
    router.close()
    check(same_after == len(qs), f"failover answers: {same_after} of "
          f"{len(qs)} byte-identical")
    check(failovers > 0 and state_dead == DOWN,
          f"the kill: failovers {failovers}, state {state_dead}")
    check(restarted == 1 and dead.health.state == HEALTHY
          and device == str(index.device),
          f"restart: {restarted}, {dead.health.state}, {device}")
    check(same_restart == len(qs), f"restarted answers: {same_restart} of "
          f"{len(qs)} byte-identical")
    check(warm_pins == n_warm and pins_left == 0,
          f"pins after the restart: {warm_pins} for {n_warm} warm, "
          f"{pins_left} left")
    out["replicas"] = dict(failovers=failovers, restarted=restarted,
                           device=device, pins_left=pins_left)
    log(f"[serve] replicas: 2 sessions of the 1M index on {device}; "
        f"{len(qs)} answers; replica 0 killed: the same {same_after} "
        f"answers byte-identical through replica 1, failovers {failovers}, "
        f"replica 0 {state_dead}; supervisor restart on {device}: "
        f"{dead.health.state}, the same {same_restart} answers; pool pins "
        f"{warm_pins} (= {n_warm} warm), 0 after dropping them; "
        f"{t['replicas']:.3f} s")

    # 4. scatter and gather over 4 spatial shards of 250,000 rows
    t0 = time.perf_counter()
    parts = pc1_split(x, N_SHARDS)
    shards = []
    for si, rows in enumerate(parts):
        part = np.ascontiguousarray(x[rows])
        st = FlatVectorStore.from_array(
            os.path.join(workdir, f"shard{si}.bin"), part)
        scfg = dataclasses.replace(main["cfg"],
                                   num_buckets=len(rows) // 1000,
                                   memory_budget_bytes=part.nbytes // 10)
        shards.append(DiskJoinIndex.build(
            st, scfg, os.path.join(workdir, f"shard{si}"), layout="spatial"))
    t["shard_builds"] = time.perf_counter() - t0
    gid = np.concatenate(parts)     # router id -> row of x
    # the queries arrive as one batch, so each shard's waves take up to
    # 256 of them and share their probe reads
    Q = Q[:N_ROUTER_QUERIES]
    router = IndexRouter(shards, epsilon=eps, close_shards=True,
                         scheduler=dict(wave_size=256, max_wait_s=0.005,
                                        max_queue=len(Q)))
    for sh in shards:
        sh.query_batch(Q[:8])
    t0 = time.perf_counter()
    got = router.query_batch(Q, timeout=120)
    t["router_queries"] = time.perf_counter() - t0
    fanout = router.snapshot()["fanout_mean"]
    router.close()
    truth_sets = brute_force_members(x, Q, eps)
    eps2 = float(eps) * float(eps)
    hit = total = outside = 0
    for qi, (ids, dists) in enumerate(got):
        rows = gid[ids]
        d64 = ((x[rows].astype(np.float64) - Q[qi]) ** 2).sum(1)
        outside += int((d64 > eps2 + 1e-4 * max(1.0, eps2)).sum())
        check(np.abs(dists - np.sqrt(d64)).max(initial=0.0) <= 1e-3,
              f"router query {qi} distances vs float64")
        hit += len(set(rows.tolist()) & truth_sets[qi])
        total += len(truth_sets[qi])
    rec = hit / max(total, 1)
    out["router"] = dict(recall=rec, truth=total, outside=outside,
                         fanout=fanout, sizes=[len(p) for p in parts])
    log(f"[serve] router over {N_SHARDS} spatial shards "
        f"{[len(p) for p in parts]} (built in {t['shard_builds']:.3f} s, "
        f"spatial layout; waves of up to 256): {len(Q)} queries in "
        f"{t['router_queries']:.3f} s, "
        f"fan-out {fanout:.3f}; recall {rec!r} on {total} true members "
        f"(need >= 0.88), {outside} returned outside eps beyond the "
        f"boundary band")
    check(rec >= 0.88, f"router recall {rec} < 0.88")
    check(outside == 0, f"{outside} router members outside eps")

    # 5. a residency snapshot, then a warm reopen
    qs = Q[:N_REPLICA_ANSWERS]
    index.drop_warm_cache()
    base = index.pipeline_snapshot()
    cold = index.query_batch(qs)
    after = index.pipeline_snapshot()
    cold_reads = sum(after[k] - base[k] for k in ("query_reads",
                                                  "query_fallback_reads"))
    saved = index.save_residency_snapshot()
    with open(os.path.join(index.workdir, RESIDENCY_NAME)) as f:
        snap_ids = json.load(f)["buckets"]
    t0 = time.perf_counter()
    warm = index.reopen()
    t["reopen"] = time.perf_counter() - t0
    warm_ids = warm.warm_buckets()
    base = warm.pipeline_snapshot()
    warm_answers = warm.query_batch(qs)
    after = warm.pipeline_snapshot()
    same_warm = sum(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    for a, b in zip(cold, warm_answers))
    warm.close()
    reads = sum(after[k] - base[k] for k in ("query_reads",
                                             "query_fallback_reads"))
    hits = after["query_warm_hits"] - base["query_warm_hits"]
    check(saved == len(snap_ids) > 0, "empty residency snapshot")
    check(sorted(warm_ids) == sorted(snap_ids)
          and base["warm_prefaults"] == len(snap_ids),
          "the reopened session's warm buckets are not the snapshot's")
    # the same wave probes the same buckets: every snapshotted one is a
    # warm hit, and only the rest (past the warm quota) is read
    check(hits == len(snap_ids) and reads == cold_reads - hits,
          f"warm reopen: {hits} warm hits and {reads} reads for "
          f"{len(snap_ids)} snapshotted buckets, {cold_reads} cold reads")
    check(same_warm == len(qs), f"warm answers: {same_warm} of {len(qs)} "
          f"byte-identical to the cold session's")
    out["residency"] = dict(buckets=len(snap_ids), reopen_s=t["reopen"],
                            warm_hits=hits, reads=reads,
                            cold_reads=cold_reads)
    log(f"[serve] residency: {len(snap_ids)} buckets snapshotted (the warm "
        f"quota's worth of {cold_reads} read cold); reopen "
        f"{t['reopen']:.3f} s pre-faulted {base['warm_prefaults']}; the "
        f"first {len(qs)} queries: {hits} warm hits, {reads} reads, "
        f"answers byte-identical to the cold session's")

    launches = ops.launches_snapshot()
    verify_launches_all_tc(launches, "[serve]")
    assign_launches_all_tc(launches, "[serve] shard builds")
    out["launches"] = launches
    t["phase"] = time.perf_counter() - t_phase
    log(f"[serve] launches {launches}")
    log(f"[serve] phase seconds "
        f"{json.dumps({k: round(v, 3) for k, v in t.items()})}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the superstep join, join checkpoints, semantic dedup
# ---------------------------------------------------------------------------
def timed_plan(t: dict):
    """Patch ``plan_supersteps`` in this process so each call adds its
    seconds (the node ordering and the window cut) to ``t["plan"]``;
    returns the function that restores it."""
    plan = dist_mod.plan_supersteps

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return plan(*a, **k)
        finally:
            t["plan"] = t.get("plan", 0.0) + time.perf_counter() - t0

    dist_mod.plan_supersteps = timed
    return lambda: setattr(dist_mod, "plan_supersteps", plan)


def superstep_run(index, cfg, graph, **kw) -> tuple:
    """A fresh ``DistributedJoin`` (cold caches, as after a restart) over
    the index's bucket store → (result with ``pairs`` and ``distances``,
    info, wall seconds)."""
    t0 = time.perf_counter()
    join = dist_mod.DistributedJoin(index.store, index.meta, cfg)
    pairs, info = join.run(graph, **kw)
    torch.cuda.synchronize()
    res = types.SimpleNamespace(pairs=pairs, distances=info["dists"])
    return res, info, time.perf_counter() - t0


def dist_line(info: dict) -> dict:
    return {k: info[k] for k in (
        "supersteps", "host_loads", "host_hits", "prefetched_buckets",
        "h2d_transfers", "device_slab_hits", "distance_computations")
        if k in info}


def dist_100k(workdir: str, out: dict, t: dict) -> None:
    """At [parity]'s 100k data and config: the superstep join in host and
    device mode, checkpointed, and killed and resumed, each the single-box
    join's bytes; the device-mode run also the single-box join's distance
    computations, every verify launch on the tensor-core route and no
    E = 1 tile. (The device-mode checks once also ran on the 1M index;
    that run was cut to keep the script inside its time budget.)"""
    n = N_PARITY
    x = clustered_vectors(n, DIM, seed=2)
    eps = epsilon_for_avg_neighbors(x, 20)
    store = FlatVectorStore.from_array(os.path.join(workdir, "d.bin"), x)
    cfg = JoinConfig(epsilon=eps, num_buckets=n // 1000,
                     memory_budget_bytes=x.nbytes // 10, pad_align=128)
    with DiskJoinIndex.build(store, cfg,
                             os.path.join(workdir, "didx")) as index:
        single = index.self_join(compute_mode="device")
        dcfg = index._resolve(dict(compute_mode="device"))
        hcfg = index._resolve(dict(compute_mode="host"))
        graph, _, _ = index._graph_for(dcfg)
        # what [mesh] shards over ranks, and the bytes it must give
        out["mesh_job"] = dict(store=index.store.path, meta=index.meta,
                               graph=graph, cfg=dcfg,
                               single_digest=digest(single.pairs,
                                                    single.distances))
        runs = {}
        for name, c in (("host", hcfg), ("device", dcfg)):
            before = ops.launches_snapshot()
            res, info, wall = superstep_run(index, c, graph)
            launches = {k: v - before[k]
                        for k, v in ops.launches_snapshot().items()}
            check_identical(res, single, f"100k superstep join ({name})")
            runs[name] = dict(dist_line(info), wall_s=wall)
            t[f"superstep_100k_{name}"] = wall
            if name == "device":
                verify_launches_all_tc(launches, "100k superstep join")
                check(launches["pairwise_l2_threshold"] == 0,
                      "the 100k superstep join launched the E = 1 tile")
                check(info["distance_computations"]
                      == single.num_distance_computations,
                      "100k superstep join: distance computations differ")
        steps = runs["device"]["supersteps"]
        every = max(1, steps // 16)
        ck = JoinCheckpointer(os.path.join(workdir, "ck_full"), every=every)
        res, base, t_ckpt = superstep_run(index, dcfg, graph,
                                          checkpointer=ck)
        ck.close()
        check_identical(res, single, "100k checkpointed superstep join")
        kill_at = int(0.6 * steps)
        ckdir = os.path.join(workdir, "ck_kill")
        ck = JoinCheckpointer(ckdir, every=every)
        t0 = time.perf_counter()
        try:
            dist_mod.DistributedJoin(index.store, index.meta, dcfg).run(
                graph, checkpointer=ck,
                fault=FaultInjector(kill_at_superstep=kill_at))
        except InjectedKill:
            t_a1 = time.perf_counter() - t0
        else:
            check(False, "the fault injector did not kill the join")
        ck.finish()   # a real crash skips this; restore reaps torn writes
        ck.close()
        ck = JoinCheckpointer(ckdir, every=every)
        res, info, t_a2 = superstep_run(index, dcfg, graph,
                                        checkpointer=ck, resume_from=ckdir)
        ck.close()
        check_identical(res, single, "100k resumed superstep join")
        check(info["watermark_rows"] == base["watermark_rows"],
              "resumed join: raw-row watermark differs")
        check(0 < info["resumed_at"] <= kill_at,
              f"resumed at {info['resumed_at']}, killed at {kill_at}")
    t_dev = runs["device"]["wall_s"]
    overhead = t_ckpt / t_dev - 1.0
    goodput = t_ckpt / (t_a1 + t_a2)
    out["superstep_100k"] = dict(
        runs=runs, every=every, ckpt=base["ckpt"], ckpt_s=t_ckpt,
        overhead=overhead, kill_at=kill_at, resumed_at=info["resumed_at"],
        attempt1_s=t_a1, attempt2_s=t_a2, restore_s=info["restore_s"],
        goodput=goodput, watermark=info["watermark_rows"])
    t["superstep_100k_ckpt"] = t_ckpt
    t["superstep_100k_kill_resume"] = t_a1 + t_a2
    log(f"[dist] 100k superstep joins: host and device mode "
        f"byte-identical to the single-box join ({single.pairs.shape[0]} "
        f"pairs); host " + json.dumps(runs["host"]) + "; device "
        + json.dumps(runs["device"]))
    log(f"[dist] 100k checkpointed (every {every} of {steps} supersteps): "
        f"byte-identical, {t_ckpt:.3f} s against {t_dev:.3f} s, overhead "
        f"{overhead:.4f} (fig25's gate < 0.05); " + json.dumps(base["ckpt"]))
    log(f"[dist] 100k killed at superstep {kill_at} after {t_a1:.3f} s, "
        f"resumed at {info['resumed_at']} in {t_a2:.3f} s (restore "
        f"{info['restore_s']:.4f} s): byte-identical, watermark "
        f"{info['watermark_rows']} rows as uninterrupted; goodput "
        f"{goodput:.4f} (fig25's gate >= 0.8)")


def dist_dedup(workdir: str, out: dict, t: dict) -> None:
    """``semantic_dedup`` at 2 · N_DEDUP × 128: half the rows are planted
    near duplicates of the other half; the join's pairs (recorded through
    a patch of the module's join in this process) must find ≥ 0.88 of the
    planted pairs that lie within ε in float64."""
    base = clustered_vectors(N_DEDUP, DIM, seed=11)
    rng = np.random.default_rng(0)
    emb = np.concatenate([base, base + rng.normal(
        scale=1e-3, size=base.shape).astype(np.float32)])
    join = dedup_mod.similarity_self_join
    joined = {}

    def recording(*a, **k):
        joined["res"] = join(*a, **k)
        return joined["res"]

    dedup_mod.similarity_self_join = recording
    t0 = time.perf_counter()
    try:
        rep = dedup_mod.semantic_dedup(
            emb, epsilon=DEDUP_EPS, recall_target=0.9,
            workdir=os.path.join(workdir, "dedup"), device=None)
    finally:
        dedup_mod.similarity_self_join = join
    t["dedup"] = time.perf_counter() - t0
    res = joined["res"]
    n = 2 * N_DEDUP
    xd = torch.from_numpy(emb).cuda().double()
    near = ((xd[:N_DEDUP] - xd[N_DEDUP:]) ** 2).sum(1) \
        <= DEDUP_EPS * DEDUP_EPS
    i = torch.arange(N_DEDUP, device=xd.device)[near]
    truth = i * n + (i + N_DEDUP)
    got = torch.from_numpy(res.pairs[:, 0] * n + res.pairs[:, 1]).cuda()
    rec = torch.isin(truth, got).double().mean().item()
    out["dedup"] = dict(num_pairs=rep.num_pairs, num_dropped=rep.num_dropped,
                        dedup_rate=rep.dedup_rate, recall=rec,
                        planted_within_eps=int(truth.numel()),
                        wall_s=t["dedup"])
    log(f"[dist] semantic_dedup {n} x {DIM} ({N_DEDUP} planted near "
        f"duplicates, eps {DEDUP_EPS}): {rep.num_pairs} pairs, "
        f"{rep.num_dropped} dropped, dedup_rate {rep.dedup_rate!r}; "
        f"planted-pair recall {rec!r} on {truth.numel()} within eps in "
        f"float64 (need >= 0.88); {t['dedup']:.3f} s, join timings "
        + json.dumps({k: round(v, 4) for k, v in res.timings.items()}))
    check(rec >= 0.88, f"dedup planted-pair recall {rec} < 0.88")
    check(rep.num_dropped >= 0.88 * N_DEDUP,
          f"dedup dropped {rep.num_dropped} < 0.88 x {N_DEDUP}")


def phase_dist(workdir: str) -> dict:
    """The superstep join at 100k (checkpoints, kill/resume), then
    semantic dedup. Launch counts are zeroed just before the phase and
    read just after."""
    out, t = {}, {}
    ops.reset_launches()
    t_phase = time.perf_counter()
    dist_100k(workdir, out, t)
    dist_dedup(workdir, out, t)
    launches = ops.launches_snapshot()
    verify_launches_all_tc(launches, "[dist]")
    assign_launches_all_tc(launches, "[dist] builds")
    out["launches"] = launches
    t["phase"] = time.perf_counter() - t_phase
    log(f"[dist] launches {launches}")
    log(f"[dist] phase seconds "
        f"{json.dumps({k: round(v, 3) for k, v in t.items()})}")
    return out


# ---------------------------------------------------------------------------
# [mesh]: the mesh paths in several processes sharing the card
# ---------------------------------------------------------------------------
MESH_WORLD = 2                   # ranks sharing the one card under gloo
MESH_DEADLINE_S = 300            # a spawned world's deadline
MESH_TRAIN_LAYERS = 4            # qwen3-0.6b cut to 4 of its 28 layers
MESH_TRAIN_SHAPE = (4, 2048)     # the global batch, split over data
MESH_TRAIN_STEPS = 3
MESH_F32 = (2, (2, 64))          # float32 check: layers, (B, S); (1, 2) mesh
MESH_GPIPE = dict(layers=4, M=4, mb=1, seq=128)   # 2 stages of 2 blocks
MESH_MOE_TOKENS = (2, 128)       # one olmoe layer, full width, float32
MESH_LOSS_TOL = 1e-2             # bf16 losses against one process
FWD_COUNTERS = {"tc": "flash_prefill_tc", "tc32": "flash_prefill_tc32",
                "split": "flash_decode_split", "simt": "flash_simt"}


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def tallying_mesh(tally: collections.Counter):
    """Tally the flash launches by (route counter, shape), the key of the
    kernel row of that kernel, route and shape (``row_counter_key``)."""
    fwd, bwd = collections.Counter(), collections.Counter()
    try:
        with tallying_flash(fwd), tallying_flash_bwd(bwd):
            yield
    finally:
        for (route, *shape, _, _), n in fwd.items():
            tally[(FWD_COUNTERS[route], tuple(shape))] += n
        for (dtype, *shape, _, _), n in bwd.items():
            route = flash.bwd_launch_plan(*shape, getattr(torch, dtype)).route
            tally[("flash_bwd_" + route, tuple(shape))] += n


def row_counter_key(row: dict):
    """A flash kernel row's (route counter, shape); None for other rows."""
    if not row["name"].startswith("flash_attention"):
        return None
    route = row["kernel_route"]
    counter = ("flash_bwd_" + route if row["name"].startswith(
        "flash_attention backward") else FWD_COUNTERS[route])
    return (counter, tuple(row["shape"]))


def check_tally(tally: dict, launches: dict, what: str) -> None:
    """The tally's sum for each route counter is that counter's count."""
    for counter in set(FWD_COUNTERS.values()) | {
            "flash_bwd_tc", "flash_bwd_tc32", "flash_bwd_simt"}:
        n = sum(v for (c, _), v in tally.items() if c == counter)
        check(n == launches[counter], f"{what}: {counter} tallied {n}, "
              f"counted {launches[counter]}")


def mesh_train_cfg(layers: int, dtype: str = "bfloat16"):
    return dataclasses.replace(get_config(LM_ARCH), n_layers=layers,
                               param_dtype=dtype)


def mesh_train_tcfg(ckdir=None) -> TrainConfig:
    b, s = MESH_TRAIN_SHAPE
    return TrainConfig(steps=MESH_TRAIN_STEPS, log_every=10 ** 6,
                       checkpoint_every=2, checkpoint_dir=ckdir,
                       global_batch=b, seq_len=s,
                       optimizer=AdamWConfig(**TRAIN_OPT))


def timed_train(cfg, tcfg, **kw) -> dict:
    """``train`` with its step times (end to end, from ``on_step``), peak
    memory and launch counts (zeroed just before), and its flash launches
    by route counter and shape."""
    stamps = []
    tally = collections.Counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with tallying_mesh(tally):
        out = train(cfg, tcfg, on_step=lambda s, m: stamps.append(
            time.perf_counter()), **kw)
    torch.cuda.synchronize()
    ends = np.array([t0] + stamps)
    return dict(losses=out["loss_history"],
                step_ms=(np.diff(ends) * 1e3).tolist(),
                peak=torch.cuda.max_memory_allocated(),
                launches=ops.launches_snapshot(), tally=dict(tally))


def mesh_join(job: dict, mesh) -> dict:
    """The superstep join on ``mesh`` at [dist]'s 100k device-mode config
    → its bytes' digest, launches (zeroed just before), per-rank edges and
    loads, wall seconds."""
    store = BucketedVectorStore(job["store"])
    ops.reset_launches()
    t0 = time.perf_counter()
    pairs, info = dist_mod.DistributedJoin(store, job["meta"], job["cfg"],
                                           mesh).run(job["graph"])
    torch.cuda.synchronize()
    return dict(digest=digest(pairs, info["dists"]), pairs=len(pairs),
                wall_s=time.perf_counter() - t0,
                launches=ops.launches_snapshot(),
                rank_edges=info["rank_edges"], rank_loads=info["rank_loads"])


def mesh_restore_check(cfg, ckdir: str, mesh) -> dict:
    """The newest checkpoint under ``ckdir`` restored onto ``mesh`` (this
    rank's parts, ``restore_latest(..., shardings=...)``) and onto one
    process (whole tensors, no shardings): each part must be its
    sharding's share of the whole, byte for byte → {"step", "leaves"}."""
    params = shd.ShardedParams(build_model(cfg, device=mesh.device).init(0),
                               mesh, fsdp=True)
    opt = AdamW(AdamWConfig(**TRAIN_OPT))
    state = opt.init(params)
    example = train_loop_mod._state(params, state)
    shardings = {"params": params.shardings,
                 "opt": opt_state_shardings(mesh, state, params.shardings)}
    step, parts, _ = restore_latest(ckdir, example, shardings=shardings)
    whole_step, whole, _ = restore_latest(ckdir, example)
    check(step == whole_step, f"[mesh] restored steps {step}, {whole_step}")
    leaves = 0
    for group in ("params", "opt.mu", "opt.nu"):
        head, _, key = group.partition(".")
        got = parts[head][key] if key else parts[head]
        ref = whole[head][key] if key else whole[head]
        for n, part in got.items():
            want = params.shardings[n].shard(ref[n])
            check(part.dtype == want.dtype and torch.equal(part, want),
                  f"[mesh] rank {mesh.rank}: restored {group}.{n} is not "
                  f"its share of the one-process restore")
            leaves += 1
    return {"step": step, "leaves": leaves}


def mesh_f32_step(mesh) -> dict:
    """float32, MESH_F32's layers and batch: one step on ``mesh`` (model
    axis 2), then, on rank 0 alone, the same step in one process (no
    mesh) → loss error (relative) and the largest parameter difference."""
    layers, (b, s) = MESH_F32
    cfg = mesh_train_cfg(layers, "float32")
    bundle = build_model(cfg, device=mesh.device)
    g = torch.Generator(device="cuda").manual_seed(7)
    batch = train_batch(cfg, b, s, g)
    lr = TRAIN_OPT["learning_rate"]
    tally = collections.Counter()
    shd.set_mesh(mesh)
    try:
        opt = AdamW(AdamWConfig(**TRAIN_OPT))
        store = shd.ShardedParams(bundle.init(0), mesh)
        ops.reset_launches()
        with tallying_mesh(tally):
            store, _, m = make_train_step(bundle, opt, mesh)(
                store, opt.init(store), batch)
            loss = float(m["loss"])
        launches = ops.launches_snapshot()
        full = store.full(dict(store.named_parameters()))
    finally:
        shd.set_mesh(None)
    mesh.barrier()
    out = {"loss": loss, "launches": launches, "tally": dict(tally)}
    if mesh.rank == 0:
        params, _, m1, grads = step_with_grads(bundle, bundle.init(0),
                                               batch, lr)
        out["loss_one"] = float(m1["loss"])
        out["step_err"], out["noisy"], out["total"] = check_step_params(
            "[mesh] float32 step", full,
            {n: p.detach() for n, p in params.named_parameters()},
            {n: g for n, g in grads.items() if g is not None},
            float(m1["grad_norm"]), lr)
        out["lr_bound"] = 1e-3 * lr
    mesh.barrier()
    return out


def mesh_gpipe(mesh) -> dict:
    """GPipe over 2 stages of qwen3 blocks at full width, float32, against
    the 4 blocks run in order in this process → the largest |difference|
    and its bound, 1e-5 + 1e-5·|sequential|."""
    g = MESH_GPIPE
    cfg = mesh_train_cfg(g["layers"], "float32")
    model = build_model(cfg, device=mesh.device).init(0)
    per = g["layers"] // mesh.size
    rope = transformer._rope(cfg, torch.arange(g["seq"],
                                               device="cuda")[None])
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((g["M"], g["mb"], g["seq"], cfg.d_model), device="cuda",
                    generator=gen)

    def stage_fn(block, h):
        for i in range(int(block["first"]), int(block["first"]) + per):
            h, _ = model.layers[i](h, rope, None)
        return h

    tally = collections.Counter()
    with torch.no_grad():
        ops.reset_launches()
        with tallying_mesh(tally):
            y = gpipe_forward(stage_fn, mesh, g["M"])(
                {"first": torch.arange(0, g["layers"], per)}, x)
            torch.cuda.synchronize()
        launches = ops.launches_snapshot()
        seq = torch.stack([_sequential(model, xm, rope) for xm in x])
    err = (y - seq).abs()
    return dict(max_err=float(err.max()),
                excess=float((err - 1e-5 - 1e-5 * seq.abs()).max()),
                launches=launches, tally=dict(tally))


def _sequential(model, x, rope):
    for block in model.layers:
        x, _ = block(x, rope, None)
    return x


def mesh_moe(mesh) -> dict:
    """One olmoe-1b-7b MoE layer at full width (float32, capacity factor
    8) under the all-to-all dispatch over the model axis, against the
    same layer in this process → the largest |difference| beside its
    bound (ATTN_TOL's float32 form) and whether every token's top-k
    experts agree."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                              param_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    moe = moe_mod.MoE(torch.Generator(device="cuda").manual_seed(5), cfg,
                      mesh.device)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(MESH_MOE_TOKENS + (cfg.d_model,), device="cuda",
                    generator=gen)
    picked = []   # each path's top-k expert ids, recorded as it routes
    top_k = moe_a2a_mod.top_k

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        picked.append(idx)
        return vals, idx

    moe_a2a_mod.top_k = moe_mod.top_k = recording
    shd.set_mesh(mesh)
    try:
        with torch.no_grad():
            with shd.axis_rules(moe_a2a=True):
                t0 = time.perf_counter()
                y, aux = moe(x)
                torch.cuda.synchronize()
                a2a_ms = (time.perf_counter() - t0) * 1e3
            shd.set_mesh(None)
            y1, _ = moe(x)
    finally:
        shd.set_mesh(None)
        moe_a2a_mod.top_k = moe_mod.top_k = top_k
    tol = ATTN_TOL[torch.float32]
    err = (y - y1).abs()
    return dict(max_err=float(err.max()),
                excess=float((err - tol * (1 + y1.abs())).max()),
                same_topk=len(picked) == 2 and bool(torch.equal(*picked)),
                a2a_ms=a2a_ms, aux=float(aux))


def mesh_paths(mesh, job: dict) -> dict:
    """This rank's share of the mesh paths: the join, sharded training
    with checkpoints and, with ``job["all"]``, the checkpoint restored
    onto the mesh, training with the compute split over ``model`` (the
    same steps on a (1, world) mesh), the float32 step (split over
    ``model`` too), GPipe and the MoE layer; each path's seconds."""
    t = {}
    t0 = time.perf_counter()
    out = {"describe": mesh.describe(), "join": mesh_join(job, mesh)}
    t["join"] = time.perf_counter() - t0
    cfg = mesh_train_cfg(MESH_TRAIN_LAYERS)
    tcfg = mesh_train_tcfg(job["ckdir"])
    if not job["all"]:
        tcfg = dataclasses.replace(tcfg, steps=1)
    t0 = time.perf_counter()
    out["train"] = timed_train(cfg, tcfg, mesh=mesh, fsdp=True)
    t["train"] = time.perf_counter() - t0
    if job["all"]:
        world = mesh.size
        mesh.barrier()   # rank 0's checkpoint writer has drained
        for name, fn in (
                ("restored", lambda: mesh_restore_check(
                    cfg, job["ckdir"], mesh)),
                ("tp", lambda: timed_train(
                    cfg, mesh_train_tcfg(),
                    mesh=Mesh({"data": 1, "model": world}))),
                ("f32", lambda: mesh_f32_step(
                    Mesh({"data": 1, "model": world}))),
                ("gpipe", lambda: mesh_gpipe(make_pp_mesh(world))),
                ("moe", lambda: mesh_moe(Mesh({"data": 1,
                                               "model": world})))):
            t0 = time.perf_counter()
            out[name] = fn()
            t[name] = time.perf_counter() - t0
    out["peak"] = torch.cuda.max_memory_allocated()
    out["seconds"] = t
    return out


def mesh_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of the [mesh] world that shares the card under gloo."""
    started = time.time() - job["spawned_at"]   # start, imports, group
    imports = IMPORTED_AT - job["spawned_at"]
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    _build.load()
    mesh = Mesh({"data": world, "model": 1})
    start = time.perf_counter() - t0
    out = mesh_paths(mesh, job)
    out["seconds"].update(spawn_to_imports=imports, spawn_to_rank=started,
                          rank_start=start,
                          returned_at=time.time() - job["spawned_at"])
    return out


def mesh_collectives(mesh) -> list[str]:
    """Each collective of ``mesh`` (a one-rank NCCL mesh) once over every
    axis, the default group, on card tensors in float32 and bfloat16, each
    held to the identity a group of one rank gives → the names run. (send
    and recv need a second rank.)"""
    axes = mesh.axis_names
    check(mesh.size == 1 and mesh.transport == "device"
          and mesh._group(axes) is not None,
          f"[mesh] no NCCL group over every axis: {mesh.describe()}")
    g = torch.Generator(device="cuda").manual_seed(11)
    ran = []
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.randn((8, 6), device="cuda", generator=g).to(dtype)
        for name, got in (
                ("all_reduce", mesh.all_reduce(t, axes)),
                ("all_reduce max", mesh.all_reduce(t, axes, op="max")),
                ("all_gather", mesh.all_gather(t, axes, dim=1)),
                ("all_gather_list", mesh.all_gather_list(t, axes)[0]),
                ("reduce_scatter", mesh.reduce_scatter(t, axes)),
                ("reduce", mesh.reduce(t, axes, 0)),
                ("broadcast", mesh.broadcast(t.clone(), axes, 0)),
                ("all_to_all", mesh.all_to_all(t, axes))):
            check(got.device == t.device and got.dtype == t.dtype
                  and torch.equal(got, t), f"[mesh] NCCL {name} ({dtype}) "
                  f"at world size 1 is not the identity")
            if name not in ran:
                ran.append(name)
    torch.cuda.synchronize()
    return ran


def nccl_probe(rank: int, world: int) -> list:
    """One all-reduce of a CUDA tensor on card 0."""
    torch.cuda.set_device(0)
    t = torch.full((4,), float(rank + 1), device="cuda")
    torch.distributed.all_reduce(t)
    torch.cuda.synchronize()
    return t.tolist()


def phase_mesh(job: dict, workdir: str) -> dict:
    """[mesh]: one process of qwen3 training for the comparison, then one
    rank under NCCL (each collective over the default group, the join,
    one training step), then two ranks sharing the card under gloo (join,
    training with checkpoints, the float32 step, GPipe, the MoE
    all-to-all). Launch counts per rank, each zeroed just before its path
    → the verify launches of the joins and the flash launches of the
    paths by (route counter, shape)."""
    t_phase = time.perf_counter()
    cfg = mesh_train_cfg(MESH_TRAIN_LAYERS)
    one = timed_train(cfg, mesh_train_tcfg())
    log(f"[mesh] one process: {LM_ARCH} {MESH_TRAIN_LAYERS} layers, bf16, "
        f"{MESH_TRAIN_STEPS} steps of {MESH_TRAIN_SHAPE}: losses "
        f"{one['losses']!r}, step ms {np.round(one['step_ms'], 1).tolist()}, "
        f"peak {one['peak'] / 2 ** 30:.2f} GiB")
    del one["launches"]
    torch.cuda.empty_cache()
    single = job.pop("single_digest")
    runs = {}
    # NCCL at world size 1, in this process (a file rendezvous)
    t0 = time.perf_counter()
    init_distributed(0, 1, backend="nccl", init_method="file://" +
                     os.path.join(workdir, "mesh_rendezvous"))
    try:
        nccl = Mesh({"data": 1, "model": 1})
        ran = mesh_collectives(nccl)
        runs["nccl"] = [mesh_paths(nccl, dict(
            job, ckdir=os.path.join(workdir, "mesh_ck_nccl"), all=False))]
    finally:
        torch.distributed.destroy_process_group()
    log(f"[mesh] nccl: 1 rank (this process), "
        f"{time.perf_counter() - t0:.1f} s; {runs['nccl'][0]['describe']}; "
        f"over the default group, float32 and bfloat16, each the identity: "
        f"{', '.join(ran)} (send/recv need two ranks)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs["gloo"] = spawn(mesh_rank, MESH_WORLD, backend="gloo",
                         deadline_s=MESH_DEADLINE_S, args=(dict(
                             job, ckdir=os.path.join(workdir,
                                                     "mesh_ck_gloo"),
                             all=True, spawned_at=time.time()),))
    log(f"[mesh] gloo: {MESH_WORLD} ranks sharing the card, "
        f"{time.perf_counter() - t0:.1f} s with start-up; "
        f"{runs['gloo'][0]['describe']}")
    for backend in ("nccl", "gloo"):
        for rank, r in enumerate(runs[backend]):
            j, tr = r["join"], r["train"]
            check(j["digest"] == single,
                  f"[mesh] {backend} rank {rank}: the sharded join's bytes "
                  f"are not the one-card superstep join's")
            n = verify_launches_all_tc(j["launches"],
                                       f"[mesh] {backend} rank {rank} join")
            check(j["launches"]["pairwise_l2_threshold"] == 0,
                  "[mesh] the sharded join launched the E = 1 tile")
            steps = len(tr["losses"])
            la = tr["launches"]
            check_tally(tr["tally"], la, f"[mesh] {backend} rank {rank}")
            layers = MESH_TRAIN_LAYERS
            check(la["flash_attention"] == la["flash_prefill_tc"]
                  == 2 * layers * steps and la["flash_attention_bwd"]
                  == la["flash_bwd_tc"] == layers * steps,
                  f"[mesh] {backend} rank {rank}: every flash call on the "
                  f"tensor-core routes expected, got {la}")
            diff = max(abs(a - b) for a, b in zip(tr["losses"],
                                                  one["losses"]))
            check(diff <= MESH_LOSS_TOL,
                  f"[mesh] {backend} rank {rank}: losses {tr['losses']} vs "
                  f"one process {one['losses']}")
            log(f"[mesh] {backend} rank {rank}: join {j['pairs']} pairs, "
                f"byte-identical, {j['wall_s']:.3f} s, verify launches {n} "
                f"(all tc), edges by rank {j['rank_edges']}, loads by rank "
                f"{j['rank_loads']}; train losses {tr['losses']!r} (max "
                f"|diff| {diff:.3g} vs one process), step ms "
                f"{np.round(tr['step_ms'], 1).tolist()}, peak "
                f"{tr['peak'] / 2 ** 30:.2f} GiB (one card "
                f"{one['peak'] / 2 ** 30:.2f}), flash {la['flash_attention']}"
                f" fwd / {la['flash_attention_bwd']} bwd; seconds "
                + json.dumps({k: round(v, 2)
                              for k, v in r["seconds"].items()}))
    gloo = runs["gloo"]
    h, hkv = get_config(LM_ARCH).n_heads, get_config(LM_ARCH).n_kv_heads
    for rank, r in enumerate(gloo):
        tp, la = r["tp"], r["tp"]["launches"]
        steps, layers = len(tp["losses"]), MESH_TRAIN_LAYERS
        check_tally(tp["tally"], la, f"[mesh] tp rank {rank}")
        check(la["flash_attention"] == la["flash_prefill_tc"]
              == 2 * layers * steps and la["flash_attention_bwd"]
              == la["flash_bwd_tc"] == layers * steps,
              f"[mesh] tp rank {rank}: every flash call on the tensor-core "
              f"routes expected, got {la}")
        heads = {shape[3:5] for _, shape in tp["tally"]}
        check(heads == {(h // MESH_WORLD, hkv // MESH_WORLD)},
              f"[mesh] tp rank {rank}: attention ran at (H, Hkv) {heads}, "
              f"not the rank's {h // MESH_WORLD}, {hkv // MESH_WORLD}")
        diff = max(abs(a - b) for a, b in zip(tp["losses"], one["losses"]))
        check(diff <= MESH_LOSS_TOL, f"[mesh] tp rank {rank}: losses "
              f"{tp['losses']} vs one process {one['losses']}")
        log(f"[mesh] tp rank {rank} (1, {MESH_WORLD}), the compute split "
            f"over model: losses {tp['losses']!r} (max |diff| {diff:.3g} "
            f"vs one process), step ms "
            f"{np.round(tp['step_ms'], 1).tolist()}, peak "
            f"{tp['peak'] / 2 ** 30:.2f} GiB (one card "
            f"{one['peak'] / 2 ** 30:.2f}), attention at (H, Hkv) "
            f"{sorted(heads)}, flash {la['flash_attention']} fwd / "
            f"{la['flash_attention_bwd']} bwd")
    ref = gloo[0]["restored"]
    r0 = gloo[0]
    f32 = r0["f32"]   # its parameters were checked on rank 0
    check(abs(f32["loss"] - f32["loss_one"]) <= 1e-5 * abs(f32["loss_one"]),
          f"[mesh] float32 step on (1, {MESH_WORLD}): {f32}")
    for rank, r in enumerate(gloo):
        for path, want_bwd in (("f32", True), ("gpipe", False)):
            la = r[path]["launches"]
            check_tally(r[path]["tally"], la, f"[mesh] {path} rank {rank}")
            check(la["flash_attention"] == la["flash_prefill_tc32"] > 0
                  and la["flash_attention_bwd"] == la["flash_bwd_tc32"]
                  and (la["flash_bwd_tc32"] > 0) == want_bwd,
                  f"[mesh] {path} rank {rank}: every float32 flash call on "
                  f"tc32 expected, got {la}")
        check(r["gpipe"]["excess"] <= 0, f"[mesh] GPipe rank {rank}: "
              f"{r['gpipe']}")
        check(r["moe"]["excess"] <= 0 and r["moe"]["same_topk"],
              f"[mesh] MoE all-to-all rank {rank}: {r['moe']}")
    log(f"[mesh] checkpoint: step {ref['step']}, {ref['leaves']} leaves a "
        f"rank restored onto the {MESH_WORLD} ranks, each part its share "
        f"of the one-process restore; float32 (1, {MESH_WORLD}) step: loss "
        f"{f32['loss']!r} vs {f32['loss_one']!r}, max |param diff| "
        f"{f32['step_err']:.3g} where the gradient is above the floor "
        f"(bound {f32['lr_bound']:.3g}), {f32['noisy']} of {f32['total']} "
        f"elements below it past 1e-3 lr (each within 2 lr); GPipe "
        f"{MESH_GPIPE}: max |diff| "
        f"{max(r['gpipe']['max_err'] for r in gloo):.3g}; MoE a2a "
        f"olmoe-1b-7b {MESH_MOE_TOKENS}: max |diff| "
        f"{max(r['moe']['max_err'] for r in gloo):.3g}, top-k equal, "
        f"{r0['moe']['a2a_ms']:.1f} ms; peaks by rank "
        f"{[round(r['peak'] / 2 ** 30, 2) for r in gloo]} GiB")
    paths = ("join", "train", "tp", "f32", "gpipe")
    launches = {k: sum(r[p]["launches"][k] for b in runs.values()
                       for r in b for p in paths if p in r)
                for k in ops.LAUNCHES}
    tally = collections.Counter()
    for b in runs.values():
        for r in b:
            for p in paths[1:]:
                if p in r:
                    tally.update(r[p]["tally"])
    log(f"[mesh] launches (all ranks; join, training, split training, "
        f"float32 step, GPipe) "
        f"{launches}")
    log("[mesh] flash launches by (route counter, shape): " + "; ".join(
        f"{c} {list(shape)}: {n}" for (c, shape), n in sorted(tally.items())))
    log(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, tally=tally, one=one, runs=runs)


def attach_mesh_launches(kernels: list[dict], mesh: dict) -> None:
    """The [mesh] phase's launches, all ranks together, as ``mesh_launches``
    on the rows: the joins' verify launches on the join's row (as [dist]'s
    are), each flash launch on the row of its kernel, route and shape."""
    unrowed = dict(mesh["tally"])
    for k in kernels:
        key = row_counter_key(k)
        if k["name"] == "pairwise_l2_threshold_batched":
            k["mesh_launches"] = mesh["launches"]["verify_tc"]
        elif key in mesh["tally"]:
            k["mesh_launches"] = mesh["tally"][key]
            unrowed.pop(key, None)
    log("[mesh] flash launches at a shape no kernel row has: " + "; ".join(
        f"{c} {list(shape)}: {n}" for (c, shape), n in sorted(
            unrowed.items())))


def simt_difference(index, tc_res, x: np.ndarray, eps: float,
                    what: str) -> dict:
    """One more device join with every verify launch forced onto the
    CUDA-core route (``pairwise_l2.cu``) by patching ``launch_plan`` in
    this process; the pairs that differ from the tensor-core join's, each
    of which must have a float64 d² within ``MASK_BAND`` of ε²."""
    plan = verify.launch_plan
    verify.launch_plan = lambda m, n, d: verify.LaunchPlan("simt")
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        simt = index.self_join(compute_mode="device")
        torch.cuda.synchronize()
    finally:
        verify.launch_plan = plan
    wall = time.perf_counter() - t0
    launches = ops.launches_snapshot()
    n = launches["verify_pairs_batch"] + launches["pairwise_l2_threshold"]
    check(n > 0 and launches["verify_simt"] == n
          and launches["verify_tc"] == 0,
          f"{what}: the simt join left the CUDA-core route: {launches}")
    key = x.shape[0]
    a = tc_res.pairs[:, 0] * key + tc_res.pairs[:, 1]
    b = simt.pairs[:, 0] * key + simt.pairs[:, 1]
    only_tc = np.setdiff1d(a, b)
    only_simt = np.setdiff1d(b, a)
    diff = np.concatenate([only_tc, only_simt])
    i, j = diff // key, diff % key
    d2 = ((x[i].astype(np.float64) - x[j]) ** 2).sum(1)
    eps2 = float(eps) * float(eps)
    band = np.abs(d2 - eps2).max(initial=0.0)
    check(band <= MASK_BAND, f"{what}: a tc/simt difference lies "
          f"{band} from eps^2 (band {MASK_BAND})")
    check(only_tc.size == 0 and only_simt.size == 0,
          f"{what}: the tc and simt joins differ on {only_tc.size} + "
          f"{only_simt.size} pairs")
    out = dict(tc_pairs=int(a.size), simt_pairs=int(b.size),
               only_tc=int(only_tc.size), only_simt=int(only_simt.size),
               max_from_eps2=float(band), simt_s=wall)
    log(f"[{what}] tc vs simt join: tc {a.size} pairs, simt {b.size}; "
        f"|tc - simt| {only_tc.size}, |simt - tc| {only_simt.size}; every "
        f"difference within {band:.3e} of eps^2 (band {MASK_BAND}); simt "
        f"join {wall:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phase 7: byte parity at 100k: host/device x sync/prefetch x striping
# ---------------------------------------------------------------------------
def traced_join(index, untraced, workdir: str) -> dict:
    """The prefetch device join again under ``trace_session``: the
    untraced one's bytes; its spans exported as a Chrome trace, and
    ``hidden_fraction(io.read, io.wait)`` logged beside both times."""
    t0 = time.perf_counter()
    with trace_session(ring_capacity=1 << 20) as tr:
        traced = index.self_join(compute_mode="device", io_mode="prefetch")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_identical(untraced, traced, "traced vs untraced prefetch join")
    path = tr.export(os.path.join(workdir, "prefetch_join.trace.json"))
    hidden = tr.analysis().hidden_fraction("io.read", "io.wait")
    ring = tr.ring_stats()
    check(ring["events"] > 0 and ring["dropped"] == 0,
          f"the traced join's ring: {ring}")
    log(f"[parity] prefetch join traced ({wall:.3f} s; execute "
        f"{traced.timings['execute']:.3f} s against "
        f"{untraced.timings['execute']:.3f} s untraced): byte-identical; "
        f"{ring['events']} trace events, Chrome trace "
        f"{os.path.getsize(path)} bytes, hidden_fraction(io.read, io.wait) "
        f"{hidden!r}")
    return dict(events=ring["events"], hidden=hidden, wall_s=wall,
                execute_s=traced.timings["execute"])


def resumed_build(store, cfg, workdir: str, plain_dir: str, plain):
    """A build killed after its assign scan (the write scan raises, by a
    patch in this process), then resumed: no sample or assign scan and no
    assign launch on the resume; its bucket files and device self_join
    bytes are those of the uninterrupted build at ``plain_dir``."""
    bz = sys.modules["repro_torch.core.bucketize"]
    write = bz.write_buckets

    def killed(*a, **k):
        bz.write_buckets = write
        raise InjectedKill("kill after the assign scan")

    bz.write_buckets = killed
    rdir = os.path.join(workdir, "ridx")
    t0 = time.perf_counter()
    try:
        DiskJoinIndex.build(store, cfg, rdir)
    except InjectedKill:
        t_killed = time.perf_counter() - t0
    else:
        check(False, "the patched write scan did not kill the build")
    finally:
        bz.write_buckets = write
    phases = sorted(os.listdir(os.path.join(rdir, "build_phases")))
    ops.reset_launches()
    t0 = time.perf_counter()
    with DiskJoinIndex.build(store, cfg, rdir) as resumed:
        t_resume = time.perf_counter() - t0
        launches = ops.launches_snapshot()
        bt = resumed.build_timings
        check(bt["sample"] == 0.0 and bt["assign"] == 0.0
              and launches["bucket_assign"] == 0,
              f"the resumed build rescanned: {bt}, {launches}")
        files = sorted(f for f in os.listdir(plain_dir)
                       if f.startswith("buckets")
                       and os.path.isfile(os.path.join(plain_dir, f)))
        for f in files:
            with open(os.path.join(plain_dir, f), "rb") as a, \
                    open(os.path.join(rdir, f), "rb") as b:
                check(a.read() == b.read(), f"resumed build: {f} differs")
        check_identical(plain, resumed.self_join(compute_mode="device"),
                        "resumed build's join vs the uninterrupted build's")
    log(f"[parity] resumable build killed after assign "
        f"({t_killed:.3f} s; committed phases {phases}) and resumed in "
        f"{t_resume:.3f} s: sample and assign 0 s, 0 assign launches; "
        f"{len(files)} bucket files and the device self_join "
        f"byte-identical to the uninterrupted build's")


def phase_parity(workdir: str) -> dict:
    n = N_PARITY
    x = clustered_vectors(n, DIM, seed=2)
    eps = epsilon_for_avg_neighbors(x, 20)
    store = FlatVectorStore.from_array(os.path.join(workdir, "p.bin"), x)
    cfg = JoinConfig(epsilon=eps, num_buckets=n // 1000,
                     memory_budget_bytes=x.nbytes // 10, pad_align=128)
    runs = {}
    with DiskJoinIndex.build(store, cfg,
                             os.path.join(workdir, "pidx")) as index:
        t0 = time.perf_counter()
        host = index.self_join(compute_mode="host")
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = index.self_join(compute_mode="device")
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        runs[("plain", "prefetch", "device")] = index.self_join(
            compute_mode="device", io_mode="prefetch")
        trace = traced_join(index, runs[("plain", "prefetch", "device")],
                            workdir)
        simt = simt_difference(index, dev, x, eps, "parity")
        resumed_build(store, cfg, workdir, index.workdir, dev)
        t0 = time.perf_counter()
        planned = planned_join(index, dev, "parity")
        log(f"[parity] planned join phase {time.perf_counter() - t0:.3f} s")
    check_join_output(x, eps, host)
    check(np.array_equal(host.pairs, dev.pairs), "host/device pairs differ")
    check(np.array_equal(host.distances, dev.distances),
          "host/device distances differ")
    check(host.num_distance_computations == dev.num_distance_computations,
          "host/device distance computations differ")
    log(f"[parity] {n} x {DIM}: {host.pairs.shape[0]} pairs, host "
        f"and device byte-identical (pairs and distances); self_join host "
        f"{t_host:.3f} s, device {t_dev:.3f} s")
    t0 = time.perf_counter()
    scfg = dataclasses.replace(cfg, io_devices=4, io_coalesce=True)
    with DiskJoinIndex.build(store, scfg,
                             os.path.join(workdir, "psidx")) as striped:
        t_build = time.perf_counter() - t0
        check(striped.store.num_devices == 4, "parity: not striped")
        # host mode fetches whole d²/mask batches (about a minute a join
        # here): it runs once, device mode in every I/O × striping corner
        for io_mode in ("sync", "prefetch"):
            runs[("striped", io_mode, "device")] = striped.self_join(
                compute_mode="device", io_mode=io_mode)
    for key, r in runs.items():
        check_identical(host, r, f"parity {key} vs plain sync host")
    log(f"[parity] striped build (4 devices, coalesced) {t_build:.3f} s; "
        f"byte-identical to plain sync host (pairs and distances): "
        + ", ".join("/".join(k) for k in runs))
    log("[parity] execute / io_wait / compute s: " + "; ".join(
        "/".join(k) + " " + "/".join(f"{r.timings[t]:.3f}" for t in (
            "execute", "io_wait", "compute"))
        for k, r in [(("plain", "sync", "host"), host),
                     (("plain", "sync", "device"), dev), *runs.items()]))
    return dict(simt=simt, trace=trace, planned=planned)


# ---------------------------------------------------------------------------
# phase 8: LM serving at qwen3-0.6b's full width
# ---------------------------------------------------------------------------
def host_ms(fn, reps: int = 3) -> float:
    """Host clock around ``reps`` calls that end in a synchronise (after one
    warm call): for work of many launches, such as a whole prefill."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def rolling_positions(steps: int, written: int) -> torch.Tensor:
    """kpos of a rolling decode cache of ``steps`` slots after positions
    0..written-1: slot i holds the latest position ≡ i (mod steps), −1 if
    none."""
    slot = torch.arange(steps, dtype=torch.int32)
    last = slot + steps * torch.div(written - 1 - slot, steps,
                                    rounding_mode="floor")
    return torch.where(slot < written, last, -1).to(torch.int32).cuda()


def attn_inputs(cfg, b, sq, t, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, sq, cfg.n_heads, cfg.head_dim, device="cuda",
                    generator=g).to(dtype)
    k, v = (torch.randn(b, t, cfg.n_kv_heads, cfg.head_dim, device="cuda",
                        generator=g).to(dtype) for _ in range(2))
    return q, k, v


def check_attention(q, k, v, kw) -> float:
    """Kernel vs plain version on the same inputs; → max abs error."""
    got = ops.gqa_attention(q, k, v, **kw).float()
    want = ref.gqa_attention(q, k, v, **kw).float()
    torch.cuda.synchronize()
    tol = ATTN_TOL[q.dtype]
    over = (got - want).abs() - tol * (1.0 + want.abs())
    check(torch.isfinite(got).all().item(), "flash output not finite")
    check(over.max().item() <= 0, f"flash {q.dtype} {tuple(q.shape)} x "
          f"{tuple(k.shape)} outside tolerance by {over.max().item()}")
    return (got - want).abs().max().item()


def simt_attention(q, k, v, kw) -> tuple[float, float]:
    """The CUDA-core forward (``simt``) forced on a call the tensor-core
    route takes: held to the same limit; → (max abs err, device ms)."""
    pos = kw.get("kv_positions")
    args = dict(causal=kw["causal"], window=kw.get("window", 0),
                q_offset=kw.get("q_offset", 0), scale=q.shape[-1] ** -0.5,
                kv_positions=None if pos is None else pos.to(torch.int32),
                plan=flash.LaunchPlan("simt", 4))
    got = flash.flash_attention(q, k, v, **args).float()
    want = ref.gqa_attention(q, k, v, **kw).float()
    over = (got - want).abs() - ATTN_TOL[q.dtype] * (1.0 + want.abs())
    check(torch.isfinite(got).all().item() and over.max().item() <= 0,
          f"simt flash {q.dtype} {tuple(q.shape)} outside tolerance")
    return ((got - want).abs().max().item(),
            graph_ms(lambda: flash.flash_attention(q, k, v, **args)))


def route_bound(kernel: str, shape: tuple, dtype, route: str, **kw
                ) -> tuple[float, str]:
    """The bound of one attention call (``kernel`` "flash_attention" or
    "flash_attention_bwd", ``roofline.kernel_cost``'s shape and counts)
    on ``dtype`` operands: bf16 at the bf16 tensor-core rate; float32 on
    the tc32 route as its three TF32 products each (3×TF32, as the verify
    and assign rows count it), on the CUDA cores at their float32 rate."""
    return kernel_bound(kernel_cost(kernel, shape, ops.dtype_name(dtype),
                                    route, **kw))


def attention_row(name, cfg, sq, t, kw, launches, b=LM_SLOTS,
                  dtypes=(torch.float32, torch.bfloat16),
                  main=torch.bfloat16) -> dict:
    """One shape of the path (batch ``b``): checked in each of ``dtypes``,
    each through the route ``launch_plan`` gives it; timed beside the plain
    version, SDPA and the bound. ``main`` is the path's dtype, and
    ``launches`` the path's count of its route; a bf16 row's float32 call
    is logged beside it (``f32_*``). Where a float32 call takes the
    tensor-core route (``tc32``), the CUDA-core kernel (``simt``) is held to
    the same limit and timed beside it, and both bounds are given: the
    route's (3×TF32) and the CUDA cores' float32 one."""
    errs, routes, ms, plain, lib, simt = {}, {}, {}, {}, {}, {}
    kw = dict(kw)
    kw.setdefault("causal", True)
    mask = ref.gqa_mask(sq, kw.get("kv_positions",
                                   torch.arange(t, device="cuda")),
                        causal=kw["causal"], window=kw.get("window", 0),
                        q_offset=kw.get("q_offset", 0))
    lib_errs = {}
    for dtype in dtypes:
        q, k, v = attn_inputs(cfg, b, sq, t, dtype, seed=sq + t)
        routes[dtype] = flash.launch_plan(
            b, sq, t, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype).route
        errs[dtype] = check_attention(q, k, v, kw)
        ms[dtype] = graph_ms(lambda: ops.gqa_attention(q, k, v, **kw))
        if routes[dtype] == "tc32":
            simt[dtype] = simt_attention(q, k, v, kw)
        plain[dtype] = graph_ms(lambda: ref.gqa_attention(q, k, v, **kw),
                                reps=5)
        lib_fn = lambda: sdpa_call(q, k, v, kw, mask)  # noqa: E731
        lib[dtype] = graph_ms(lib_fn)
        if dtype == main:
            want = ref.gqa_attention(q, k, v, **kw).float()
            lib_errs[dtype] = (lib_fn().transpose(1, 2).float()
                               - want).abs().max().item()
    # every product at its route's rate (Q·Kᵀ and P·V: 2 x matmul FLOPs;
    # the prefill kernel's split of P into two bf16 products is its
    # design's cost, not the work's). Bytes: Q and O, the K/V rows some
    # query sees, and the positions if given.
    pos = kw.get("kv_positions")
    counts = attention_counts(
        sq, t, causal=kw["causal"], window=kw.get("window", 0),
        q_offset=kw.get("q_offset", 0),
        positions=None if pos is None else pos.cpu().numpy())
    shape = (b, sq, t, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)

    def bounds(dtype):
        return (route_bound("flash_attention", shape, dtype, routes[dtype],
                            **counts),
                route_bound("flash_attention", shape, dtype, "simt",
                            **counts)[0])

    (bms, by), cuda_core = bounds(main)
    route = routes[main]
    tag = str(main).removeprefix("torch.")
    msg = (f"[lm] flash {name} ({b}, {sq}, {cfg.n_heads}, {cfg.head_dim}) "
           f"x ({b}, {t}, {cfg.n_kv_heads}, {cfg.head_dim}): route {tag} "
           f"{route}, max abs err {errs[main]!r}; kernel {ms[main]:.4f} ms")
    if main in simt:
        msg += (f", simt kernel {simt[main][1]:.4f} ms (max abs err "
                f"{simt[main][0]!r})")
    msg += (f", plain {plain[main]:.4f} ms, sdpa {lib[main]:.4f} ms (vs "
            f"plain max abs {lib_errs[main]:.3g}), bound {bms:.4f} ms "
            f"({by}), share {bms / ms[main]:.3f}")
    if main in simt:
        msg += f", CUDA-core float32 bound {cuda_core:.4f} ms"
    msg += f"; launches {launches}"
    row = dict(
        name=f"flash_attention ({name})", route="cuda",
        source=FLASH_SOURCES[route],
        replaces="src/repro/kernels/flash_attention.py:77",
        launches=launches, max_abs_err=errs[main], ms=ms[main],
        plain_ms=plain[main], bound_ms=bms, bound_by=by,
        library_ms=lib[main], library_max_abs_err=lib_errs[main],
        kernel_route=route,
        shape=[b, sq, t, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
        dtype=tag, ok=True)
    if main in simt:
        row.update(simt_ms=simt[main][1], simt_max_abs_err=simt[main][0],
                   simt_source=FLASH_SOURCES["simt"],
                   cuda_core_bound_ms=cuda_core)
    f32 = torch.float32
    if main != f32 and f32 in dtypes:
        (bms32, by32), cuda_core32 = bounds(f32)
        msg += (f"; f32 route {routes[f32]}, max abs err {errs[f32]!r}, "
                f"kernel {ms[f32]:.4f} ms")
        if f32 in simt:
            msg += (f", simt kernel {simt[f32][1]:.4f} ms (max abs err "
                    f"{simt[f32][0]!r})")
        msg += (f", plain {plain[f32]:.4f} ms, sdpa {lib[f32]:.4f} ms, "
                f"bound {bms32:.4f} ms ({by32}), share "
                f"{bms32 / ms[f32]:.3f}")
        if f32 in simt:
            msg += f", CUDA-core float32 bound {cuda_core32:.4f} ms"
        row.update(max_abs_err_f32=errs[f32], f32_ms=ms[f32],
                   f32_plain_ms=plain[f32], f32_bound_ms=bms32,
                   f32_bound_by=by32, f32_library_ms=lib[f32],
                   f32_route=routes[f32],
                   f32_source=FLASH_SOURCES[routes[f32]],
                   f32_cuda_core_bound_ms=cuda_core32)
        if f32 in simt:
            row.update(f32_simt_ms=simt[f32][1],
                       f32_simt_max_abs_err=simt[f32][0])
    log(msg)
    return row


def check_decode_vs_forward(cfg, shape) -> float:
    """float32 at full width: decode step by step from fresh caches
    reproduces the teacher-forced forward's logits over ``shape`` (B, S)
    tokens (tests/test_models.py:88-109's contract)."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    bundle = build_model(cfg32)
    params = bundle.init(1)
    b, s = shape
    g = torch.Generator(device="cuda").manual_seed(5)
    tok = torch.randint(0, cfg.vocab, (b, s), device="cuda", generator=g)
    with torch.inference_mode():
        hidden, _ = transformer.forward(params, tok)
        tf = transformer.lm_logits(params, hidden)
        caches = bundle.init_cache(b, s)
        steps = torch.stack([bundle.decode(params, tok[:, i:i + 1],
                                           caches)[0] for i in range(s)], 1)
    over = (steps - tf).abs() - (2e-3 + 2e-2 * tf.abs())
    check(torch.isfinite(steps).all().item(), "decode logits not finite")
    check(over.max().item() <= 0, f"{cfg.name} float32 decode vs forward "
          f"outside rtol 2e-2 / atol 2e-3 by {over.max().item()}")
    return (steps - tf).abs().max().item()


def phase_lm(profile: bool) -> list[dict]:
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    bundle = build_model(cfg)
    params = bundle.init(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    engine = ServeEngine(cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                         params=params)
    rng = np.random.default_rng(11)
    for n in LM_PROMPT_LENS:
        engine.submit(rng.integers(0, cfg.vocab, n),
                      max_new_tokens=LM_NEW_TOKENS)
    finite = []
    inner = engine._decode

    def decode(p, t, c):  # every step's logits checked, read once at the end
        logits, c = inner(p, t, c)
        finite.append(torch.isfinite(logits).all())
        return logits, c
    engine._decode = decode
    g = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, LM_PREFILL_SHAPE, device="cuda",
                           generator=g)

    # --- the main path: counts zeroed just before, read just after -------
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        pre = bundle.prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill_first = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # -----------------------------------------------------------------------
    steps = engine.stats["steps"]
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, vocab "
        f"{cfg.vocab}, {n_params} params in {cfg.param_dtype}, made on the "
        f"card in {t_init:.2f} s")
    log(f"[lm] launches {launches}; engine stats {engine.stats}")
    check(launches["flash_attention"] == cfg.n_layers * (steps + 1) > 0,
          f"flash launches {launches['flash_attention']} != "
          f"{cfg.n_layers} x ({steps} steps + 1 prefill)")
    check(launches["flash_decode_split"] == cfg.n_layers * steps
          and launches["flash_prefill_tc"] == cfg.n_layers
          and launches["flash_simt"] == 0,
          f"flash routes: {cfg.n_layers * steps} split-KV decode and "
          f"{cfg.n_layers} tensor-core prefill calls expected, got {launches}")
    check(sorted(results) == list(range(1, len(LM_PROMPT_LENS) + 1)),
          f"answered {sorted(results)}")
    check(all(len(r) == LM_NEW_TOKENS for r in results.values()),
          "a request got the wrong number of tokens")
    check(engine.stats["waves"] == 2, f"waves {engine.stats['waves']}")
    check(torch.stack(finite).all().item(), "non-finite decode logits")
    check(pre.shape == (LM_PREFILL_SHAPE[0], cfg.vocab)
          and torch.isfinite(pre).all().item(), "prefill logits")
    generated = sum(len(r) for r in results.values())
    log(f"[lm] served {len(results)} requests, {generated} tokens, {steps} "
        f"decode steps in {t_serve:.3f} s: {t_serve * 1e3 / steps:.3f} "
        f"ms/step, {generated / t_serve:.1f} generated tokens/s "
        f"({LM_SLOTS * steps / t_serve:.1f} slot-tokens/s)")
    with torch.inference_mode():
        prefill_ms = host_ms(lambda: bundle.prefill(params,
                                                    {"tokens": prompt}))
        caches = bundle.init_cache(LM_SLOTS, LM_MAX_SEQ)
        tok = prompt[:, :1]
        step_ms = host_ms(lambda: bundle.decode(params, tok, caches),
                          reps=20)
    log(f"[lm] prefill {LM_PREFILL_SHAPE}: first {t_prefill_first * 1e3:.1f}"
        f" ms, warm {prefill_ms:.1f} ms; warm decode step (4 slots) "
        f"{step_ms:.3f} ms")
    if profile:
        profile_lm_decode(bundle, params, tok)
    del engine, caches, pre

    rows = []
    s, t = LM_PREFILL_SHAPE[1], LM_PREFILL_SHAPE[1]
    rows.append(attention_row("prefill", cfg, s, t, dict(causal=True),
                              launches["flash_prefill_tc"]))
    kw = dict(causal=True, q_offset=LM_DECODE_POS,
              kv_positions=rolling_positions(LM_MAX_SEQ, LM_DECODE_POS + 1))
    rows.append(attention_row("decode", cfg, 1, LM_MAX_SEQ, kw,
                              launches["flash_decode_split"]))
    check(rows[0]["kernel_route"] == "tc"
          and rows[1]["kernel_route"] == "split",
          "the smoke shapes' bf16 routes are not tensor-core prefill and "
          "split-KV decode")
    del params, bundle
    torch.cuda.empty_cache()
    err = check_decode_vs_forward(cfg, LM_TF_SHAPE)
    log(f"[lm] float32 decode vs forward {LM_TF_SHAPE}: max abs err "
        f"{err!r} (rtol 2e-2, atol 2e-3)")
    share = cfg.n_layers * rows[1]["ms"] / step_ms
    log(f"[lm] flash decode kernels per step {cfg.n_layers} x "
        f"{rows[1]['ms']:.4f} ms = {share:.3f} of a warm decode step")
    return rows


# ---------------------------------------------------------------------------
# phase 8, continued: every other model family, served on the card
# ---------------------------------------------------------------------------
def family_config(arch: str, layers: int = 0, **kw):
    """The arch at its published widths, cut to ``layers`` (0: its own
    depth; an enc-dec cut cuts the encoder too)."""
    cfg = get_config(arch)
    if layers:
        kw["n_layers"] = layers
        if cfg.enc_dec:
            kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=layers)
    return dataclasses.replace(cfg, **kw)


def attention_layers(cfg) -> int:
    return (cfg.n_layers if cfg.enc_dec else
            sum(k in transformer.ATTN_KINDS
                for k in transformer.layer_kinds(cfg)))


def family_batch(cfg, b: int, g: torch.Generator) -> dict:
    """Seeded prefill inputs: (b, FAM_PREFILL) tokens; a VLM's patches take
    its n_patches of those positions; whisper gets its n_frames stub
    frames and WHISPER_PREFILL_TOKENS tokens."""
    n_tok = FAM_PREFILL
    batch = {}
    if cfg.family == "vlm":
        enc = cfg.encoder
        batch["patches"] = torch.randn(
            (b, enc.n_patches, enc.frontend_dim or cfg.d_model),
            device="cuda", generator=g).to(torch.bfloat16)
        n_tok -= enc.n_patches
    if cfg.enc_dec:
        batch["frames"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.d_model), device="cuda",
            generator=g).to(torch.bfloat16)
        n_tok = WHISPER_PREFILL_TOKENS
    batch["tokens"] = torch.randint(0, cfg.vocab, (b, n_tok), device="cuda",
                                    generator=g)
    return batch


def flash_key(route: str, b: int, sq: int, t: int, h: int, hkv: int,
              d: int, causal: bool, window: int) -> tuple:
    """What tells one flash call's shape from another's on the paths."""
    return (route, b, sq, t, h, hkv, d, bool(causal), window > 0)


@contextlib.contextmanager
def tallying_flash(tally: collections.Counter):
    """Tally every flash launch by ``flash_key``, beside the route counters
    the wrapper keeps (their sums per route are checked against them)."""
    inner = ops._launch_flash

    def launch(q, k, v, **kw):
        out = inner(q, k, v, **kw)
        b, sq, h, d = q.shape
        t, hkv = k.shape[1], k.shape[2]
        route = flash.launch_plan(b, sq, t, h, hkv, d, q.dtype).route
        tally[flash_key(route, b, sq, t, h, hkv, d, kw["causal"],
                        kw["window"])] += 1
        return out
    ops._launch_flash = launch
    try:
        yield
    finally:
        ops._launch_flash = inner


def family_path(arch: str, layers: int) -> dict:
    """The family's main path on the card (counts zeroed just before it,
    read just after): one wave of FAM_PROMPTS prompts of FAM_PROMPT_LEN
    tokens through ``ServeEngine`` (4 slots), FAM_NEW_TOKENS new tokens
    each (whisper: its stub frames encoded at batch 4, then FAM_NEW_TOKENS
    greedy decode steps), then one prefill of (1, FAM_PREFILL). Every flash
    call of a decode step takes the split-KV route and every prefill call
    the tensor-core route."""
    cfg = family_config(arch, layers)
    t0 = time.perf_counter()
    bundle = build_model(cfg)
    params = bundle.init(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    g = torch.Generator(device="cuda").manual_seed(23)
    batch = family_batch(cfg, 1, g)
    finite = []
    if cfg.enc_dec:
        frames = torch.randn((FAM_PROMPTS, cfg.encoder.n_frames,
                              cfg.d_model), device="cuda",
                             generator=g).to(torch.bfloat16)
        first = torch.randint(0, cfg.vocab, (FAM_PROMPTS, 1), device="cuda",
                              generator=g)

        def serve():
            enc = encdec.encode(params, frames)
            caches = bundle.init_cache(FAM_PROMPTS, FAM_MAX_SEQ,
                                       params=params, enc_out=enc)
            tok, out = first, []
            for _ in range(FAM_NEW_TOKENS):
                logits, caches = bundle.decode(params, tok, caches)
                finite.append(torch.isfinite(logits).all())
                tok = torch.argmax(logits, -1)[:, None]
                out.append(tok)
            return torch.cat(out, 1).cpu().numpy()
    else:
        engine = ServeEngine(cfg, slots=FAM_PROMPTS, max_seq=FAM_MAX_SEQ,
                             params=params)
        rng = np.random.default_rng(13)
        for _ in range(FAM_PROMPTS):
            engine.submit(rng.integers(0, cfg.vocab, FAM_PROMPT_LEN),
                          max_new_tokens=FAM_NEW_TOKENS)
        inner = engine._decode

        def decode(p, t, c):  # every step's logits checked, read at the end
            logits, c = inner(p, t, c)
            finite.append(torch.isfinite(logits).all())
            return logits, c
        engine._decode = decode

        def serve():
            return engine.run()

    tally = collections.Counter()
    # --- the family's main path: counts zeroed just before, read after ---
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode(), tallying_flash(tally):
        results = serve()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode(), tallying_flash(tally):
        pre = bundle.prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill_first = time.perf_counter() - t0
    launches = ops.launches_snapshot()
    # -----------------------------------------------------------------------
    n_attn = attention_layers(cfg)
    if cfg.enc_dec:
        steps = FAM_NEW_TOKENS
        generated = FAM_PROMPTS * FAM_NEW_TOKENS
        # decode: self and cross attention a layer a step; prefill: the
        # encoder's layers (at batch 4 and 1), the decoder's self and cross
        want_split = 2 * n_attn * steps
        want_tc = 2 * cfg.encoder.n_layers + 2 * n_attn
        check(results.shape == (FAM_PROMPTS, FAM_NEW_TOKENS), "tokens")
    else:
        steps = engine.stats["steps"]
        generated = sum(len(r) for r in results.values())
        want_split, want_tc = n_attn * steps, n_attn
        check(sorted(results) == list(range(1, FAM_PROMPTS + 1))
              and all(len(r) == FAM_NEW_TOKENS for r in results.values())
              and engine.stats["waves"] == 1, f"{arch}: served {results}, "
              f"stats {engine.stats}")
    check(launches["flash_decode_split"] == want_split
          and launches["flash_prefill_tc"] == want_tc
          and launches["flash_simt"] == 0
          and launches["flash_attention"] == want_split + want_tc,
          f"{arch}: flash routes: {want_split} split-KV and {want_tc} "
          f"tensor-core calls expected, got {launches}")
    for route, counter in flash.ROUTE_COUNTERS.items():
        check(sum(n for key, n in tally.items() if key[0] == route)
              == launches[counter], f"{arch}: the shape tally of route "
              f"{route} disagrees with its counter: {dict(tally)}")
    check(all(launches[k] == 0 for k in JOIN_KERNELS), "join kernels ran")
    check(torch.stack(finite).all().item(), f"{arch}: non-finite logits")
    check(pre.shape == (1, cfg.vocab) and torch.isfinite(pre).all().item(),
          f"{arch}: prefill logits")
    drops = []
    if cfg.moe is not None:  # the same prefill again, its routing recorded
        calls = []
        with torch.inference_mode(), recording_routes(calls):
            bundle.prefill(params, batch)
        drops = [int((~keep).sum()) for _, _, keep in calls]
    with torch.inference_mode():
        prefill_ms = host_ms(lambda: bundle.prefill(params, batch), reps=1)
    shape = {k: tuple(v.shape) for k, v in batch.items()}
    log(f"[lm] {arch}: {cfg.n_layers} layers ({n_attn} attention), "
        f"d_model {cfg.d_model}, {n_params} params in "
        f"{cfg.param_dtype}, made on the card in {t_init:.2f} s")
    log(f"[lm] {arch}: {steps} decode steps at batch {FAM_PROMPTS} in "
        f"{t_serve:.3f} s: {t_serve * 1e3 / steps:.3f} ms/step, "
        f"{generated / t_serve:.1f} generated tokens/s; prefill {shape}: "
        f"first {t_prefill_first * 1e3:.1f} ms, warm {prefill_ms:.1f} ms; "
        f"flash launches split {launches['flash_decode_split']}, tc "
        f"{launches['flash_prefill_tc']}, simt {launches['flash_simt']}; by "
        f"shape (route, B, Sq, T, H, Hkv, D, causal, windowed): "
        f"{sorted(tally.items())}")
    if drops:
        m = cfg.moe
        log(f"[lm] {arch}: MoE assignments dropped per MoE layer in the "
            f"prefill ({FAM_PREFILL} tokens x top-{m.top_k}, capacity "
            f"{moe_mod.capacity(m, FAM_PREFILL)} of {m.num_experts} "
            f"experts): {drops}")
    return dict(arch=arch, cfg=cfg, launches=launches, tally=tally,
                steps=steps,
                ms_step=t_serve * 1e3 / steps,
                tokens_s=generated / t_serve, prefill_ms=prefill_ms,
                prefill_first_ms=t_prefill_first * 1e3, drops=drops,
                params=n_params, init_s=t_init)


@contextlib.contextmanager
def recording_routes(calls: list):
    """Record (probs, expert ids, keep) of every MoE routing call."""
    inner = moe_mod.route

    def route(logits, m, shared=None):
        out = inner(logits, m, shared)
        calls.append((out[0], out[2], out[4]))
        return out
    moe_mod.route = route
    try:
        yield
    finally:
        moe_mod.route = inner


def family_logits(bundle, params, batch: dict, n_decode: int):
    """float32 logits of a forward over every position (VLM: patches
    first; enc-dec: the decoder over the encoded frames), then of
    ``n_decode`` decode steps over the first tokens from fresh caches."""
    tok = batch["tokens"]
    b = tok.shape[0]
    if bundle.cfg.enc_dec:
        enc = encdec.encode(params, batch["frames"])
        fwd = encdec.logits(params, encdec.decode_train(params, tok, enc))
        caches = bundle.init_cache(b, n_decode, params=params, enc_out=enc)
    else:
        hidden, _ = transformer.forward(params, tok,
                                        patch_embeds=batch.get("patches"))
        fwd = transformer.lm_logits(params, hidden)
        caches = bundle.init_cache(b, n_decode)
    steps = [bundle.decode(params, tok[:, i:i + 1], caches)[0]
             for i in range(n_decode)]
    return fwd, torch.stack(steps, 1)


def card_vs_cpu(arch: str) -> dict:
    """float32 at full width and CPU_CHECK_LAYERS layers: the logits on the
    card (the kernels) against the port's CPU plain path on the same
    weights and inputs, |card − cpu| ≤ CARD_CPU_TOL · (1 + |cpu|). MoE: the
    top-k expert ids of every routing call agree wherever the CPU's k-th
    and (k+1)-th router probabilities differ by more than ROUTER_TOL; a
    token routed otherwise (only inside that band) changes every later
    position of its sequence, so those positions are left out of the
    logits check and counted."""
    cfg = family_config(arch, CPU_CHECK_LAYERS, param_dtype="float32")
    b, s = CPU_CHECK_TOKENS
    g = torch.Generator(device="cuda").manual_seed(21)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), device="cuda",
                                     generator=g)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(
            (b, CPU_CHECK_PATCHES, cfg.encoder.frontend_dim), device="cuda",
            generator=g)
    if cfg.enc_dec:
        batch["frames"] = torch.randn((b, cfg.encoder.n_frames, cfg.d_model),
                                      device="cuda", generator=g)
    params = build_model(cfg).init(2)
    out, routes = {}, {}
    for device in ("cuda", "cpu"):
        if device == "cpu":
            params = params.to("cpu")
            batch = {k: v.cpu() for k, v in batch.items()}
        routes[device] = []
        with torch.inference_mode(), recording_routes(routes[device]):
            out[device] = family_logits(build_model(cfg, device=device),
                                        params, batch, CPU_CHECK_DECODE)
    p = batch.get("patches")
    n_fwd = s + (0 if p is None else p.shape[1])
    # positions (b, forward position) and (b, decode step) downstream of a
    # token the two devices routed to different experts
    dirty_fwd = torch.zeros((b, n_fwd), dtype=torch.bool)
    dirty_dec = torch.zeros((b, CPU_CHECK_DECODE), dtype=torch.bool)
    checked = near = 0
    k = cfg.moe.top_k if cfg.moe is not None else 0
    n_moe = len(routes["cpu"]) // (1 + CPU_CHECK_DECODE) if k else 0
    for i, ((_, ic, _), (pr, ir, _)) in enumerate(
            zip(routes["cuda"], routes["cpu"], strict=True)):
        ranked = torch.sort(pr, dim=-1, descending=True).values
        margin = ranked[:, k - 1] - ranked[:, k]
        flip = (torch.sort(ic.cpu(), -1).values
                != torch.sort(ir, -1).values).any(-1)
        check(not (flip & (margin > ROUTER_TOL)).any().item(),
              f"{arch}: top-{k} expert ids differ where the router's "
              f"margin exceeds {ROUTER_TOL}")
        checked += int((margin > ROUTER_TOL).sum())
        near += int((margin <= ROUTER_TOL).sum())
        if i < n_moe:
            dirty_fwd |= flip.reshape(b, n_fwd)
        else:
            dirty_dec[:, (i - n_moe) // n_moe] |= flip
    dirty_fwd = dirty_fwd.cummax(1).values
    dirty_dec = dirty_dec.cummax(1).values
    errs = []
    for got, want, dirty in zip(out["cuda"], out["cpu"],
                                (dirty_fwd, dirty_dec)):
        got, keep = got.cpu()[~dirty], want[~dirty]
        check(torch.isfinite(got).all().item(), f"{arch}: card logits")
        over = (got - keep).abs() - CARD_CPU_TOL * (1.0 + keep.abs())
        check(over.numel() == 0 or over.max().item() <= 0,
              f"{arch}: card vs CPU float32 logits outside {CARD_CPU_TOL} "
              f"by {over.max().item()}")
        errs.append((got - keep).abs().max().item() if got.numel() else 0.0)
    log(f"[lm] {arch} float32, {CPU_CHECK_LAYERS} layers at full width, "
        f"card vs CPU: forward {tuple(out['cpu'][0].shape)} max abs err "
        f"{errs[0]!r}, {CPU_CHECK_DECODE} decode steps {errs[1]!r} (tol "
        f"{CARD_CPU_TOL}); positions left out after a router flip: "
        f"{int(dirty_fwd.sum())} + {int(dirty_dec.sum())}"
        + (f"; routing calls {len(routes['cpu'])}, top-{k} ids checked on "
           f"{checked} tokens, {near} inside the {ROUTER_TOL} band"
           if k else ""))
    return dict(forward_err=errs[0], decode_err=errs[1],
                left_out=int(dirty_fwd.sum() + dirty_dec.sum()))


def family_rows(fams: dict) -> list[dict]:
    """Every flash shape of the families' paths against the plain version,
    timed (bf16, the paths' dtype). A row's launches: the main paths' calls
    of its shape, from the tally ``family_path`` took; every shape a path
    launched must have its row."""
    moe_cfg = fams["olmoe-1b-7b"]["cfg"]
    rg = fams["recurrentgemma-2b"]["cfg"]
    vlm = fams["internvl2-26b"]["cfg"]
    wh = fams["whisper-small"]["cfg"]
    frames = wh.encoder.n_frames
    moe_archs = ("olmoe-1b-7b", "deepseek-moe-16b")
    written = FAM_PROMPT_LEN + FAM_NEW_TOKENS - 1  # the last step's cache
    dec = dict(q_offset=written - 1,
               kv_positions=rolling_positions(FAM_MAX_SEQ, written))
    # whisper's decoder starts with no prompt: its last step's cache
    wh_dec = dict(q_offset=FAM_NEW_TOKENS - 1,
                  kv_positions=rolling_positions(FAM_MAX_SEQ,
                                                 FAM_NEW_TOKENS))
    # decode past recurrentgemma's window: every slot written, wrapped
    wrapped = FAM_MAX_SEQ + 53
    rg_t = min(FAM_MAX_SEQ, rg.window)
    rg_dec = dict(window=rg.window, q_offset=wrapped - 1,
                  kv_positions=rolling_positions(rg_t, wrapped))
    nc = dict(causal=False)
    p = FAM_PROMPTS
    # (name, arch(s), cfg, b, sq, t, kw)
    specs = [
        ("moe prefill (MHA, D 128)", moe_archs, moe_cfg, 1, FAM_PREFILL,
         FAM_PREFILL, {}),
        ("moe decode (MHA, D 128)", moe_archs, moe_cfg, p, 1, FAM_MAX_SEQ,
         dec),
        ("recurrentgemma prefill (D 256, g 10, window 2048)",
         ("recurrentgemma-2b",), rg, 1, FAM_PREFILL, FAM_PREFILL,
         dict(window=rg.window)),
        ("recurrentgemma decode (rolling window, wrapped)",
         ("recurrentgemma-2b",), rg, p, 1, rg_t, rg_dec),
        ("internvl2 prefill (g 6)", ("internvl2-26b",), vlm, 1, FAM_PREFILL,
         FAM_PREFILL, {}),
        ("internvl2 decode (g 6)", ("internvl2-26b",), vlm, p, 1,
         FAM_MAX_SEQ, dec),
        ("whisper encoder, served (non-causal, T 1500)", ("whisper-small",),
         wh, p, frames, frames, nc),
        ("whisper encoder, prefill (non-causal, T 1500)",
         ("whisper-small",), wh, 1, frames, frames, nc),
        ("whisper self decode (D 64)", ("whisper-small",), wh, p, 1,
         FAM_MAX_SEQ, wh_dec),
        ("whisper cross decode (non-causal, T 1500)", ("whisper-small",),
         wh, p, 1, frames, nc),
        ("whisper self prefill (D 64)", ("whisper-small",), wh, 1,
         WHISPER_PREFILL_TOKENS, WHISPER_PREFILL_TOKENS, {}),
        ("whisper cross prefill (non-causal, T 1500)", ("whisper-small",),
         wh, 1, WHISPER_PREFILL_TOKENS, frames, nc),
    ]
    covered, rows = set(), []
    for name, archs, cfg, b, sq, t, kw in specs:
        route = flash.launch_plan(b, sq, t, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, torch.bfloat16).route
        key = flash_key(route, b, sq, t, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, kw.get("causal", True),
                        kw.get("window", 0))
        n = sum(fams[a]["tally"][key] for a in archs)
        check(n > 0, f"flash {name}: no call of shape {key} on "
              f"{', '.join(archs)}'s path")
        covered |= {(a, key) for a in archs}
        rows.append(attention_row(name, cfg, sq, t, kw, n, b,
                                  (torch.bfloat16,)))
    missed = [(a, key) for a, f in fams.items() for key in f["tally"]
              if (a, key) not in covered]
    check(not missed, f"flash shapes on the paths with no row: {missed}")
    return rows


def phase_lm_families() -> list[dict]:
    fams = {}
    for arch, layers in FAMILIES.items():
        t0 = time.perf_counter()
        fams[arch] = family_path(arch, layers)
        torch.cuda.empty_cache()
        if arch in TF_CHECKS:
            n_layers, shape = TF_CHECKS[arch]
            err = check_decode_vs_forward(family_config(arch, n_layers),
                                          shape)
            log(f"[lm] {arch} float32, {n_layers} layers at full width: "
                f"decode vs forward {shape} max abs err {err!r} (rtol 2e-2, "
                f"atol 2e-3)")
            fams[arch]["tf_err"] = err
        else:
            fams[arch].update(card_vs_cpu(arch))
        torch.cuda.empty_cache()
        log(f"[lm] {arch} {time.perf_counter() - t0:.1f} s")
    return family_rows(fams)


# ---------------------------------------------------------------------------
# phase 9: [train] — training on the card
# ---------------------------------------------------------------------------
class TrainKill(Exception):
    """Raised from ``on_step`` to kill a training run at a chosen step."""


class RecordingAdamW(AdamW):
    """AdamW that keeps the gradients ``make_train_step`` hands it."""

    def update(self, grads, state, params):
        self.grads = grads
        return super().update(grads, state, params)


def bwd_key(q, k, kw) -> tuple:
    """What tells one backward call's shape from another's on the paths:
    (dtype, B, Sq, T, H, Hkv, D, causal, windowed)."""
    b, sq, h, d = q.shape
    return (str(q.dtype).removeprefix("torch."), b, sq, k.shape[1], h,
            k.shape[2], d, bool(kw["causal"]), kw.get("window", 0) > 0)


@contextlib.contextmanager
def tallying_flash_bwd(tally: collections.Counter):
    """Tally every backward call (the autograd Function's backward calls
    ``ops.gqa_attention_bwd`` by its module name) by ``bwd_key``."""
    inner = ops.gqa_attention_bwd

    def bwd(q, k, v, out, dout, **kw):
        tally[bwd_key(q, k, kw)] += 1
        return inner(q, k, v, out, dout, **kw)
    ops.gqa_attention_bwd = bwd
    try:
        yield
    finally:
        ops.gqa_attention_bwd = inner


def train_batch(cfg, b: int, s: int, g: torch.Generator) -> dict:
    tok = torch.randint(0, cfg.vocab, (b, s), device="cuda", generator=g)
    batch = {"tokens": tok, "labels": tok}
    if cfg.enc_dec:
        batch["frames"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.d_model), device="cuda",
            generator=g).to(getattr(torch, cfg.param_dtype))
    return batch


def train_main(fwd_tally, bwd_tally) -> dict:
    """qwen3-0.6b at full width and depth (28 layers, seeded bf16 weights
    made on the card by ``train``): TRAIN_STEPS steps of
    ``repro_torch.train.train`` on TokenPipeline batches of TRAIN_SHAPE,
    AdamW (TRAIN_OPT), remat on. Counts zeroed just before, read just
    after: every forward flash call on the tensor-core route, two a layer
    a step (the forward and its recomputation), one backward call a layer
    a step."""
    cfg = get_config(LM_ARCH)
    b, s = TRAIN_SHAPE
    tcfg = TrainConfig(steps=TRAIN_STEPS, log_every=1,
                       checkpoint_every=TRAIN_STEPS, global_batch=b,
                       seq_len=s, optimizer=AdamWConfig(**TRAIN_OPT))
    stamps = []

    def on_step(step, metrics):
        stamps.append((time.perf_counter(), metrics))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: counts zeroed just before, read just after -------
    ops.reset_launches()
    t0 = time.perf_counter()
    with tallying_flash(fwd_tally), tallying_flash_bwd(bwd_tally):
        out = train(cfg, tcfg, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches_snapshot()
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    losses = out["loss_history"]
    n = cfg.n_layers
    check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
          f"[train] losses {losses}")
    check(losses[-1] < losses[0], f"[train] loss did not fall: {losses}")
    check(launches["flash_attention"] == launches["flash_prefill_tc"]
          == 2 * n * TRAIN_STEPS and launches["flash_simt"] == 0
          and launches["flash_decode_split"] == 0,
          f"[train] forward flash calls: {2 * n * TRAIN_STEPS} tensor-core "
          f"calls expected, got {launches}")
    check(launches["flash_attention_bwd"] == launches["flash_bwd_tc"]
          == n * TRAIN_STEPS and launches["flash_bwd_simt"] == 0,
          f"[train] backward calls: {n} x {TRAIN_STEPS} on the tensor-core "
          f"route expected, got {launches}")
    check(all(launches[k] == 0 for k in JOIN_KERNELS), "join kernels ran")
    ends = np.array([t for t, _ in stamps])
    steps_ms = np.diff(ends) * 1e3          # step i ≥ 1: end to end
    warm_ms = float(np.median(steps_ms[1:]))
    tokens_s = b * s / (warm_ms / 1e3)
    log(f"[train] {LM_ARCH}: {n} layers at full width, bf16, {TRAIN_STEPS} "
        f"steps of {TRAIN_SHAPE} tokens, remat on, AdamW {TRAIN_OPT}: "
        f"losses {losses!r}")
    log(f"[train] first step (model made on the card, first batch, "
        f"first launches) {(ends[0] - t0) * 1e3:.1f} ms; warm step median "
        f"{warm_ms:.1f} ms (steps {np.round(steps_ms, 1).tolist()} ms), "
        f"{tokens_s:.1f} tokens/s; StepTimer mean "
        f"{out['mean_step_ms']:.1f} ms; peak memory allocated "
        f"{peak / 2 ** 30:.2f} GiB; run {wall:.2f} s")
    log(f"[train] launches: forward flash {launches['flash_attention']} "
        f"(tc {launches['flash_prefill_tc']}), backward "
        f"{launches['flash_attention_bwd']} (tc {launches['flash_bwd_tc']}, "
        f"simt {launches['flash_bwd_simt']}); by backward shape "
        f"{sorted(bwd_tally.items())}")
    return dict(losses=losses, warm_ms=warm_ms, tokens_s=tokens_s,
                peak=peak, launches=launches)


def hundred_m_config():
    """examples/train_lm.py's ``hundred_m_config``, built as it builds it:
    qwen3-0.6b with 12 layers, d_model 640, 10 heads / 5 KV heads of 64,
    d_ff 1792, vocab 32,768, float32."""
    return dataclasses.replace(
        get_config(LM_ARCH), name=HUNDRED_M, n_layers=12, d_model=640,
        n_heads=10, n_kv_heads=5, head_dim=64, d_ff=1792, vocab=32768,
        param_dtype="float32")


def train_100m(fwd_tally, bwd_tally) -> dict:
    """examples/train_lm.py's float32 path on the card: ``hundred_m_config``
    (seeded weights made on the card by ``train``), TRAIN_100M_STEPS steps
    of ``repro_torch.train.train`` on TokenPipeline batches of
    TRAIN_100M_SHAPE, AdamW at the example's lr 3e-4 (TRAIN_OPT), remat on,
    no checkpoints. Counts zeroed just before, read just after: every
    forward flash call on the float32 tensor-core route (tc32), two a layer
    a step, and every backward call on tc32, one a layer a step; none on a
    CUDA-core or bf16 route. The loss falls (the example's own assert)."""
    cfg = hundred_m_config()
    b, s = TRAIN_100M_SHAPE
    steps = TRAIN_100M_STEPS
    tcfg = TrainConfig(steps=steps, log_every=1, checkpoint_every=steps,
                       global_batch=b, seq_len=s,
                       optimizer=AdamWConfig(**TRAIN_OPT))
    stamps = []

    def on_step(step, metrics):
        stamps.append((time.perf_counter(), metrics))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: counts zeroed just before, read just after -------
    ops.reset_launches()
    t0 = time.perf_counter()
    with tallying_flash(fwd_tally), tallying_flash_bwd(bwd_tally):
        out = train(cfg, tcfg, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches_snapshot()
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    losses = out["loss_history"]
    n = cfg.n_layers
    check(len(losses) == steps and np.isfinite(losses).all(),
          f"[train] {HUNDRED_M} losses {losses}")
    check(losses[-1] < losses[0], f"[train] {HUNDRED_M} loss did not fall: "
          f"{losses}")
    check(launches["flash_attention"] == launches["flash_prefill_tc32"]
          == 2 * n * steps and launches["flash_simt"] == 0
          and launches["flash_prefill_tc"] == 0
          and launches["flash_decode_split"] == 0,
          f"[train] {HUNDRED_M} forward flash calls: {2 * n * steps} float32 "
          f"tensor-core calls expected, got {launches}")
    check(launches["flash_attention_bwd"] == launches["flash_bwd_tc32"]
          == n * steps and launches["flash_bwd_simt"] == 0
          and launches["flash_bwd_tc"] == 0,
          f"[train] {HUNDRED_M} backward calls: {n} x {steps} on the float32 "
          f"tensor-core route expected, got {launches}")
    check(all(launches[k] == 0 for k in JOIN_KERNELS), "join kernels ran")
    ends = np.array([t for t, _ in stamps])
    steps_ms = np.diff(ends) * 1e3
    warm_ms = float(np.median(steps_ms[1:]))
    tokens_s = b * s / (warm_ms / 1e3)
    log(f"[train] {HUNDRED_M} (examples/train_lm.py's float32 model, "
        f"{cfg.param_count()} params): {n} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, vocab "
        f"{cfg.vocab}, {steps} steps of {TRAIN_100M_SHAPE} tokens, remat "
        f"on, AdamW {TRAIN_OPT}: losses {losses!r}")
    log(f"[train] {HUNDRED_M} first step {(ends[0] - t0) * 1e3:.1f} ms; warm "
        f"step median {warm_ms:.2f} ms (steps "
        f"{np.round(steps_ms, 2).tolist()} ms), {tokens_s:.1f} tokens/s; "
        f"peak memory allocated {peak / 2 ** 30:.2f} GiB; run {wall:.2f} s")
    log(f"[train] {HUNDRED_M} launches: forward flash "
        f"{launches['flash_attention']} (tc32 "
        f"{launches['flash_prefill_tc32']}), backward "
        f"{launches['flash_attention_bwd']} (tc32 "
        f"{launches['flash_bwd_tc32']}, simt {launches['flash_bwd_simt']})")
    return dict(cfg=cfg, losses=losses, warm_ms=warm_ms, tokens_s=tokens_s,
                peak=peak, launches=launches)


def step_with_grads(bundle, params, batch, lr: float, grad_transform=None,
                    state=None):
    """One ``make_train_step`` → (params, state, metrics, the gradients
    the optimizer was handed)."""
    opt = RecordingAdamW(AdamWConfig(**dict(TRAIN_OPT, learning_rate=lr)),
                         grad_transform=grad_transform)
    if state is None:
        state = opt.init(params)
    params, state, metrics = make_train_step(bundle, opt)(params, state,
                                                          batch)
    return params, state, metrics, opt.grads


def check_step_params(what: str, got: dict, want: dict, grads: dict,
                      gnorm: float, lr: float) -> tuple[float, int, int]:
    """Parameters after one AdamW step (by name) against the reference
    step's: |Δ| ≤ 1e-3·lr wherever the reference's gradient is at least
    1e-4 of its tensor's largest and 100·eps of Adam's eps after the clip;
    below that floor Adam's first step is sign(g)·lr whatever |g|, so an
    element may differ by up to 2·lr there, and at most 1 in 1,000
    elements may pass 1e-3·lr → (the largest |Δ| above the floor, the
    elements past 1e-3·lr, all elements)."""
    scale = min(1.0, 1.0 / gnorm)
    noisy = total = 0
    step_err = 0.0
    for name, ref in want.items():
        diff = (got[name] - ref).abs()
        ga = grads[name].abs() if name in grads else torch.zeros_like(ref)
        big = (ga >= 1e-4 * ga.max()) & (ga * scale >= 100 * 1e-8)
        check(diff.max().item() <= 2.01 * lr, f"{what} {name} after the "
              f"step: {diff.max().item()} > 2 lr")
        if big.any():
            step_err = max(step_err, diff[big].max().item())
        check(not big.any() or diff[big].max().item() <= 1e-3 * lr,
              f"{what} {name} after the step off by "
              f"{diff[big].max().item()}")
        noisy += int((diff > 1e-3 * lr).sum())
        total += diff.numel()
    check(noisy <= total // 1000, f"{what} {noisy} of {total} elements "
          f"past 1e-3 lr after the step")
    return step_err, noisy, total


def train_vs_cpu() -> dict:
    """float32, qwen3 at full width cut to TRAIN_CPU's layers: the loss,
    every gradient and every parameter after one AdamW step on the card
    (the kernels) against the port's CPU plain path from the same weights
    and batch. Loss within TRAIN_CPU_LOSS_RTOL; each gradient ‖Δ‖ ≤
    TRAIN_CPU_GRAD_RTOL ‖g_cpu‖; parameters |Δ| ≤ 1e-3·lr except where the
    CPU's gradient is below 1e-4 of its tensor's largest or within 100·eps
    of Adam's eps after the clip (counted, each within 2·lr: see
    tests/test_torch_train_families.py)."""
    layers, (b, s) = TRAIN_CPU
    cfg = family_config(LM_ARCH, layers, param_dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(31)
    batch = train_batch(cfg, b, s, g)
    card = build_model(cfg).init(4)
    cpu = build_model(cfg, device="cpu").init(4)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    lr = TRAIN_OPT["learning_rate"]
    res = {}
    for device, params in (("cuda", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        bundle = build_model(cfg, device=device)
        dev_batch = {k: v.to(device) for k, v in batch.items()}
        params, _, met, grads = step_with_grads(bundle, params, dev_batch,
                                                lr)
        # both sides compared on the card (the CPU's tensors copied there)
        res[device] = (float(met["loss"]), float(met["grad_norm"]),
                       {n: x.detach().to("cuda") for n, x in grads.items()
                        if x is not None},
                       {n: p.detach().to("cuda")
                        for n, p in params.named_parameters()})
        log(f"[train] float32 step on {device}: "
            f"{time.perf_counter() - t0:.2f} s")
    (lc, nc, gc, pc), (lh, nh, gh, ph) = res["cuda"], res["cpu"]
    loss_rel = abs(lc - lh) / abs(lh)
    check(loss_rel <= TRAIN_CPU_LOSS_RTOL, f"[train] card vs CPU loss "
          f"{lc!r} vs {lh!r}")
    check(sorted(gc) == sorted(gh), "[train] gradient names differ")
    worst = 0.0
    for name, want in gh.items():
        got = gc[name]
        check(torch.isfinite(got).all().item(), f"[train] {name} grad")
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        check(rel <= TRAIN_CPU_GRAD_RTOL, f"[train] card vs CPU gradient "
              f"{name}: relative error {rel}")
        worst = max(worst, rel)
    step_err, noisy, total = check_step_params("[train]", pc, ph, gh, nh,
                                               lr)
    log(f"[train] float32 card vs CPU, {layers} layers at full width, "
        f"({b}, {s}): loss {lc!r} vs {lh!r} (rel {loss_rel:.3g}, tol "
        f"{TRAIN_CPU_LOSS_RTOL}); worst gradient ‖Δ‖/‖g‖ {worst:.3g} (tol "
        f"{TRAIN_CPU_GRAD_RTOL}) over {len(gh)} tensors; after one AdamW "
        f"step max |Δ| {step_err:.3g} where the gradient is above the "
        f"floor (tol {1e-3 * lr:.3g}), {noisy} of {total} elements below "
        f"it past 1e-3 lr (each within 2 lr)")
    return dict(loss_rel=loss_rel, grad_rel=worst, noisy=noisy)


@contextlib.contextmanager
def timing_checkpoints(saves: list, writes: list):
    """Record the seconds of each ``CheckpointManager.save`` (the host
    snapshot on the training thread) and of each write (on its thread)."""
    cls = train_loop_mod.CheckpointManager
    save, write = cls.save, cls._write

    def timed_save(self, *a, **k):
        t0 = time.perf_counter()
        save(self, *a, **k)
        saves.append(time.perf_counter() - t0)

    def timed_write(self, *a, **k):
        t0 = time.perf_counter()
        write(self, *a, **k)
        writes.append(time.perf_counter() - t0)
    cls.save, cls._write = timed_save, timed_write
    try:
        yield
    finally:
        cls.save, cls._write = save, write


def train_resume(workdir: str) -> dict:
    """qwen3 at full width cut to TRAIN_RESUME's layers, bf16: an
    uninterrupted run of TRAIN_RESUME_STEPS steps with a checkpoint every
    TRAIN_CKPT_EVERY (async), then the same run killed by an exception from
    ``on_step`` at TRAIN_KILL_AT and resumed by calling ``train`` again:
    the resumed losses must be the uninterrupted run's, bit for bit. Then
    two steps with the int8 compressor: finite loss, nonzero error."""
    layers, (b, s) = TRAIN_RESUME
    cfg = family_config(LM_ARCH, layers)

    def tcfg(name):
        return TrainConfig(steps=TRAIN_RESUME_STEPS, log_every=100,
                           checkpoint_every=TRAIN_CKPT_EVERY,
                           checkpoint_dir=os.path.join(workdir, name),
                           global_batch=b, seq_len=s,
                           optimizer=AdamWConfig(**TRAIN_OPT))

    def kill(step, metrics):
        if step == TRAIN_KILL_AT:
            raise TrainKill(step)

    saves, writes = [], []
    ops.reset_launches()
    with timing_checkpoints(saves, writes):
        whole = train(cfg, tcfg("whole"))
        killed = False
        try:
            train(cfg, tcfg("killed"), on_step=kill)
        except TrainKill:
            killed = True
        check(killed, "[train] the killed run was not killed")
        restart = list_checkpoints(
            os.path.join(workdir, "killed"))[-1][0]
        resumed = train(cfg, tcfg("killed"))
    launches = ops.launches_snapshot()
    check(launches["flash_bwd_tc"] > 0 and launches["flash_bwd_simt"] == 0,
          f"[train] kill/resume backward routes {launches}")
    want = whole["loss_history"][restart:]
    got = resumed["loss_history"]
    check(len(got) == len(want) == TRAIN_RESUME_STEPS - restart,
          f"[train] resumed {len(got)} steps from step {restart}")
    check(np.isfinite(got).all(), "[train] resumed losses not finite")
    diff = max(abs(a - w) / abs(w) for a, w in zip(got, want))
    bitwise = got == want
    check(bitwise or diff <= 1e-5, f"[train] resumed losses {got!r} vs "
          f"uninterrupted {want!r}")
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(os.path.join(workdir, "whole"))
               for f in fs) / max(1, len(list_checkpoints(
                   os.path.join(workdir, "whole"))))
    log(f"[train] kill/resume, {layers} layers at full width, bf16, "
        f"({b}, {s}), {TRAIN_RESUME_STEPS} steps, checkpoint every "
        f"{TRAIN_CKPT_EVERY} (async): killed at step {TRAIN_KILL_AT}, "
        f"resumed from step {restart}: losses "
        + ("bitwise equal" if bitwise else
           f"NOT bitwise equal (max rel diff {diff!r}; the backward's "
           f"scatter of the embedding gradient, index_put_ with "
           f"accumulate, is the one op here whose order may vary)")
        + f" {got!r}; checkpoint {size / 2 ** 20:.1f} MiB, host snapshot "
        f"on the training thread {np.round(saves, 3).tolist()} s, writes "
        f"{np.round(writes, 3).tolist()} s")
    # int8 gradient compression with error feedback, two steps
    bundle = build_model(cfg)
    params = bundle.init(0)
    g = torch.Generator(device="cuda").manual_seed(37)
    state, losses = None, []
    for _ in range(2):
        params, state, met, _ = step_with_grads(
            bundle, params, train_batch(cfg, b, s, g),
            TRAIN_OPT["learning_rate"], make_int8_compressor(cfg), state)
        losses.append(float(met["loss"]))
    err = float(global_norm(state["error"].values()))
    check(np.isfinite(losses).all() and np.isfinite(err) and err > 0,
          f"[train] int8 compression: losses {losses}, error norm {err}")
    log(f"[train] int8 gradient compression, 2 steps: losses {losses!r}, "
        f"error-feedback norm {err!r}")
    return dict(bitwise=bitwise, diff=diff, saves=saves, writes=writes)


def train_family(arch: str, layers: int, shape: tuple, fwd_tally,
                 bwd_tally) -> dict:
    """One bf16 ``make_train_step`` of ``arch`` at its published widths cut
    to ``layers`` (counts zeroed just before, read just after): the loss
    and every gradient finite, every parameter moved but an untied
    ``lm_head`` (the reference's loss reads the embedding table), the flash
    forward and backward calls attention layers x calls (remat recomputes
    each forward once; enc-dec: no remat, self and cross a decoder
    layer)."""
    cfg = family_config(arch, layers)
    b, s = shape
    bundle = build_model(cfg)
    params = bundle.init(0)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    batch = train_batch(cfg, b, s,
                        torch.Generator(device="cuda").manual_seed(41))
    torch.cuda.synchronize()
    # --- the family's path: counts zeroed just before, read after --------
    ops.reset_launches()
    t0 = time.perf_counter()
    with tallying_flash(fwd_tally), tallying_flash_bwd(bwd_tally):
        params, _, met, grads = step_with_grads(bundle, params, batch,
                                                TRAIN_FAMILY_LR)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = ops.launches_snapshot()
    # -----------------------------------------------------------------------
    untied = None if cfg.tie_embeddings or cfg.enc_dec else "lm_head"
    check(np.isfinite(float(met["loss"])), f"[train] {arch} loss")
    for name, grad in grads.items():
        if grad is None:
            check(name == untied, f"[train] {arch}: {name} has no gradient")
            continue
        check(torch.isfinite(grad).all().item(), f"[train] {arch}: {name} "
              f"gradient not finite")
    still = [n for n, p in params.named_parameters()
             if torch.equal(p.detach(), before[n]) and n != untied]
    check(not still, f"[train] {arch}: parameters that did not move {still}")
    if cfg.enc_dec:
        fwd = cfg.encoder.n_layers + 2 * cfg.n_layers
        bwd = fwd
    else:
        bwd = attention_layers(cfg)
        fwd = 2 * bwd
    check(launches["flash_attention"] == fwd
          and launches["flash_attention_bwd"] == launches["flash_bwd_tc"]
          == bwd,
          f"[train] {arch}: {fwd} forward and {bwd} backward flash calls "
          f"(all on the tensor-core backward) expected, got {launches}")
    log(f"[train] {arch}: {cfg.n_layers} layers"
        + (f" + {cfg.encoder.n_layers} encoder" if cfg.enc_dec else "")
        + f" at full width, bf16, ({b}, {s}) tokens: one step "
        f"{step_s * 1e3:.1f} ms (first, launches included), loss "
        f"{float(met['loss'])!r}, grad norm {float(met['grad_norm'])!r}; "
        f"flash forward {launches['flash_attention']}, backward "
        f"{launches['flash_attention_bwd']}; every gradient finite, every "
        f"parameter moved" + (f" but {untied}" if untied else ""))
    return dict(cfg=cfg, loss=float(met["loss"]), step_s=step_s)


def sdpa_call(q, k, v, kw, mask):
    """The library call that computes the same function, on the
    (B, H, S, D) views of q, k, v: no mask for full attention, is_causal
    (top-left aligned) for S == T from position 0, the boolean key mask
    otherwise (decode, windows)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    plain_keys = "kv_positions" not in kw and not kw.get("window")
    if plain_keys and not kw["causal"]:
        return sdpa(qt, kt, vt, enable_gqa=True)
    if plain_keys and q.shape[1] == k.shape[1]:
        return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def bwd_errors(what: str, dtype, got, want) -> tuple[float, float, float]:
    """A backward's gradients against the plain version's under the three
    limits (BWD_TOL, BWD_ELEM_TOL, BWD_NORM_TOL); → the worst max |Δ|, the
    worst element's |Δ| as a share of its limit, and the worst ‖Δ‖/‖plain‖
    over dq, dk, dv."""
    err = elem = norm = 0.0
    atol, rtol = BWD_ELEM_TOL[dtype]
    for gname, x, w in zip("qkv", got, want):
        check(torch.isfinite(x).all().item(), f"{what} d{gname} not finite")
        x, w = x.float(), w.float()
        diff = (x - w).abs()
        e, top = diff.max().item(), w.abs().max().item()
        check(e <= BWD_TOL[dtype] * top, f"{what} {dtype} d{gname}: max "
              f"|Δ| {e} > {BWD_TOL[dtype]} x {top}")
        el = (diff / (atol * top + rtol * w.abs()).clamp_min(1e-30)
              ).max().item()
        check(el <= 1.0, f"{what} {dtype} d{gname}: an element past {atol} "
              f"max|plain| + {rtol} |plain| ({el:.3g} of its limit)")
        nr = diff.norm().item() / max(w.norm().item(), 1e-30)
        check(nr <= BWD_NORM_TOL[dtype], f"{what} {dtype} d{gname}: "
              f"‖Δ‖/‖plain‖ {nr} > {BWD_NORM_TOL[dtype]}")
        err, elem, norm = max(err, e), max(elem, el), max(norm, nr)
    return err, elem, norm


def attention_bwd_row(name: str, key: tuple, window: int, launches: int,
                      dtypes=(torch.bfloat16,),
                      main=torch.bfloat16, few_reps: bool = False) -> dict:
    """One backward shape of the paths: the kernel of the route
    ``bwd_launch_plan`` picks against ``ref.gqa_attention_bwd`` on the same
    inputs (the three limits), in each of ``dtypes`` (``main`` the path's;
    a bf16 row's float32 call is logged beside it, ``f32_*``); timed (CUDA
    graphs) beside the plain version and SDPA's backward (its forward +
    backward less its forward), and the bound: five products (S, dP, dV,
    dK, dQ) at the route's rate (``route_bound``), against each input read
    once (q, k, v, O, dO) and each gradient written once. Where the route is
    a tensor-core one, the CUDA-core backward (``simt``) is held to the
    same limits and timed beside it; a float32 row gives the CUDA cores'
    bound too. ``few_reps`` times every version in fewer calls, as a
    shape with more than 2^24 (query, key) pairs is timed."""
    t_row = time.perf_counter()
    _, b, sq, t, h, hkv, d, causal, _ = key
    kw = dict(causal=causal, window=window)
    mask = ref.gqa_mask(sq, torch.arange(t, device="cuda"), causal=causal,
                        window=window, q_offset=0)
    cfg = types.SimpleNamespace(n_heads=h, n_kv_heads=hkv, head_dim=d)
    stats, routes = {}, {}
    for dtype in dtypes:
        plan = flash.bwd_launch_plan(b, sq, t, h, hkv, d, dtype)
        routes[dtype] = plan.route
        q, k, v = attn_inputs(cfg, b, sq, t, dtype, seed=sq + 3 * t)
        dout = torch.randn(q.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(sq + t)).to(dtype)
        out = ops.gqa_attention(q, k, v, **kw)
        want = ref.gqa_attention_bwd(q, k, v, out, dout, **kw)
        err, elem, norm = bwd_errors(f"flash backward {name}", dtype,
                                     ops.gqa_attention_bwd(q, k, v, out,
                                                           dout, **kw), want)
        big = few_reps or b * sq * t > 2 ** 24
        reps = dict(reps=5, replays=2) if big else {}
        ms = graph_ms(lambda: ops.gqa_attention_bwd(q, k, v, out, dout,
                                                    **kw), **reps)
        simt = None
        if plan.route != "simt":  # the CUDA-core backward on the same inputs
            simt_plan = flash.BwdLaunchPlan("simt", 4, 1, plan.stats_shape,
                                            plan.delta_shape)
            args = dict(kw, q_offset=0, scale=d ** -0.5, kv_positions=None,
                        plan=simt_plan)
            simt_err = bwd_errors(f"flash backward (simt) {name}", dtype,
                                  flash.flash_attention_bwd(
                                      q, k, v, out, dout, **args), want)
            simt = dict(err=simt_err[0], elem=simt_err[1], norm=simt_err[2],
                        ms=graph_ms(lambda: flash.flash_attention_bwd(
                            q, k, v, out, dout, **args), **reps))
        del want
        plain = graph_ms(lambda: ref.gqa_attention_bwd(q, k, v, out, dout,
                                                       **kw),
                         reps=2 if big else 5, replays=2)
        qg, kg, vg = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        dt = dout.transpose(1, 2)

        def fwd():
            return sdpa_call(qg, kg, vg, kw, mask)

        def fwd_bwd():
            return torch.autograd.grad(fwd(), (qg, kg, vg), dt)

        lib_both = graph_ms(fwd_bwd, **reps)
        lib_fwd = graph_ms(fwd, **reps)
        lib_grads = fwd_bwd()
        lib_err = max((x.float() - w.float()).abs().max().item()
                      for x, w in zip(lib_grads, ref.gqa_attention_bwd(
                          q, k, v, out, dout, **kw)))
        stats[dtype] = dict(err=err, elem=elem, norm=norm, ms=ms,
                            plain=plain, simt=simt,
                            lib=lib_both - lib_fwd, lib_both=lib_both,
                            lib_fwd=lib_fwd, lib_err=lib_err)
        del q, k, v, out, dout, qg, kg, vg, lib_grads
        torch.cuda.empty_cache()
    counts = attention_counts(sq, t, causal=causal, window=window)
    shape = (b, sq, t, h, hkv, d)

    def bounds(dtype):
        return (route_bound("flash_attention_bwd", shape, dtype,
                            routes[dtype], **counts),
                route_bound("flash_attention_bwd", shape, dtype, "simt",
                            **counts)[0])

    (bms, by), cuda_core = bounds(main)
    st, route = stats[main], routes[main]
    tag = str(main).removeprefix("torch.")
    msg = (f"[train] flash backward {name} ({b}, {sq}, {h}, {d}) x ({b}, "
           f"{t}, {hkv}, {d}): {tag} route {route}, max abs err "
           f"{st['err']!r} (worst element {st['elem']:.3g} of its limit, "
           f"‖Δ‖/‖plain‖ {st['norm']:.3g}); kernel {st['ms']:.4f} ms")
    if st["simt"] is not None:
        msg += (f", simt kernel {st['simt']['ms']:.4f} ms (worst element "
                f"{st['simt']['elem']:.3g}, ‖Δ‖/‖plain‖ "
                f"{st['simt']['norm']:.3g})")
    msg += (f", plain {st['plain']:.4f} ms, sdpa backward "
            f"{st['lib']:.4f} ms (fwd+bwd {st['lib_both']:.4f}, fwd "
            f"{st['lib_fwd']:.4f}; grads vs plain max abs "
            f"{st['lib_err']:.3g}), bound {bms:.4f} ms ({by}), share "
            f"{bms / st['ms']:.3f}")
    if main == torch.float32 and route != "simt":
        msg += f", CUDA-core float32 bound {cuda_core:.4f} ms"
    msg += f"; launches {launches}"
    t_row = time.perf_counter() - t_row
    row = dict(
        name=f"flash_attention backward ({name})", route="cuda",
        kernel_route=route, source=FLASH_BWD_SOURCES[route],
        replaces="src/repro/kernels/flash_attention.py:77",
        port_only="backward of flash_attention; the JAX package "
                  "differentiates its plain attention "
                  "(src/repro/models/layers.py:134)",
        launches=launches, max_abs_err=st["err"],
        elem_share_of_tol=st["elem"], norm_rel_err=st["norm"], ms=st["ms"],
        plain_ms=st["plain"], bound_ms=bms, bound_by=by,
        library_ms=st["lib"], library_max_abs_err=st["lib_err"],
        shape=[b, sq, t, h, hkv, d], dtype=tag, ok=True)
    if st["simt"] is not None:
        row.update(simt_ms=st["simt"]["ms"], simt_max_abs_err=st["simt"]["err"],
                   simt_elem_share_of_tol=st["simt"]["elem"],
                   simt_norm_rel_err=st["simt"]["norm"])
    if main == torch.float32 and route != "simt":
        row.update(cuda_core_bound_ms=cuda_core,
                   simt_source=FLASH_BWD_SOURCES["simt"])
    f32 = torch.float32
    if main != f32 and f32 in stats:
        st = stats[f32]
        (bms32, by32), cuda_core32 = bounds(f32)
        msg += (f"; f32 route {routes[f32]}, max abs err {st['err']!r} "
                f"(worst element {st['elem']:.3g} of its limit, ‖Δ‖/‖plain‖ "
                f"{st['norm']:.3g}), kernel {st['ms']:.4f} ms")
        if st["simt"] is not None:
            msg += (f", simt kernel {st['simt']['ms']:.4f} ms (worst element "
                    f"{st['simt']['elem']:.3g}, ‖Δ‖/‖plain‖ "
                    f"{st['simt']['norm']:.3g})")
        msg += (f", plain {st['plain']:.4f} ms, sdpa backward "
                f"{st['lib']:.4f} ms, bound {bms32:.4f} ms ({by32}), share "
                f"{bms32 / st['ms']:.3f}, CUDA-core float32 bound "
                f"{cuda_core32:.4f} ms")
        row.update(max_abs_err_f32=st["err"],
                   elem_share_of_tol_f32=st["elem"],
                   norm_rel_err_f32=st["norm"], f32_ms=st["ms"],
                   f32_plain_ms=st["plain"], f32_bound_ms=bms32,
                   f32_bound_by=by32, f32_library_ms=st["lib"],
                   f32_route=routes[f32],
                   f32_source=FLASH_BWD_SOURCES[routes[f32]],
                   f32_cuda_core_bound_ms=cuda_core32)
        if st["simt"] is not None:
            row.update(f32_simt_ms=st["simt"]["ms"],
                       f32_simt_max_abs_err=st["simt"]["err"],
                       f32_simt_elem_share_of_tol=st["simt"]["elem"],
                       f32_simt_norm_rel_err=st["simt"]["norm"])
    log(msg + f"; row {t_row:.1f} s")
    return row


def simt_bwd_entry(row: dict, launches: int) -> dict:
    """The CUDA-core backward's own ``kernels`` entry at ``row``'s shape
    (bf16), from the numbers that row measured; ``launches`` is its count
    on the main path."""
    return dict(
        name=row["name"].replace("backward (", "backward, simt route ("),
        route="cuda", kernel_route="simt", source=FLASH_BWD_SOURCES["simt"],
        replaces=row["replaces"], port_only=row["port_only"],
        launches=launches, max_abs_err=row["simt_max_abs_err"],
        elem_share_of_tol=row["simt_elem_share_of_tol"],
        norm_rel_err=row["simt_norm_rel_err"], ms=row["simt_ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=row["shape"], dtype="bfloat16", ok=True)


def profile_train_step() -> None:
    """qwen3-0.6b at full width and depth, TRAIN_SHAPE: the first step's
    wall time (warm-up included), then two warm steps under torch.profiler:
    wall time, device busy share and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(LM_ARCH)
    bundle = build_model(cfg)
    params = bundle.init(0)
    opt = AdamW(AdamWConfig(**TRAIN_OPT))
    state = opt.init(params)
    step = make_train_step(bundle, opt)
    g = torch.Generator(device="cuda").manual_seed(43)
    batch = train_batch(cfg, *TRAIN_SHAPE, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, met = step(params, state, batch)
    float(met["loss"])
    first = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            params, state, met = step(params, state, batch)
        float(met["loss"])
        wall = (time.perf_counter() - t0) / 2
    rows = [(e.key, e.self_device_time_total / 2e3, e.count // 2)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[profile-train] first step {first * 1e3:.1f} ms; warm step under "
        f"the profiler {wall * 1e3:.1f} ms, device kernels {busy:.1f} ms "
        f"(busy share {busy / (wall * 1e3):.3f})")
    for key, ms, n in rows[:14]:
        log(f"[profile-train] {ms:9.3f} ms  {n:5d} x  {key[:90]}")
    # the attention backward's launches, by kernel (both routes' names)
    split = {k: (ms, n) for k, ms, n in rows
             if "bwd_" in k and "_kernel" in k}
    log("[profile-train] flash backward a step: " + ", ".join(
        f"{k[k.index('bwd_'):].split('(')[0]} {ms:.3f} ms ({n} x)"
        for k, (ms, n) in sorted(split.items(), key=lambda r: -r[1][0]))
        + f"; {sum(ms for ms, _ in split.values()):.3f} ms in all")


def phase_train(prev_rows: list[dict], profile: bool = False) -> list[dict]:
    """[train]: the qwen3 main path, float32 card vs CPU, kill/resume and
    int8 compression, one step of each other family; then a backward row
    for every backward shape the paths launched (qwen3's also in float32)
    and a forward row for every forward shape no earlier row covers.
    ``profile``: two traced training steps after the main path."""
    fwd_tally, bwd_tally = collections.Counter(), collections.Counter()
    t0 = time.perf_counter()
    main = train_main(fwd_tally, bwd_tally)
    log(f"[train] main path {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ftally, btally = collections.Counter(), collections.Counter()
    small = train_100m(ftally, btally)
    windows = {key: (HUNDRED_M, small["cfg"].window) for key in btally}
    fwd_arch = dict.fromkeys(fwd_tally, LM_ARCH)
    fwd_arch.update(dict.fromkeys(ftally, HUNDRED_M))
    fwd_tally.update(ftally)
    bwd_tally.update(btally)
    log(f"[train] {HUNDRED_M} path {time.perf_counter() - t1:.1f} s")
    if profile:
        torch.cuda.empty_cache()
        profile_train_step()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    train_vs_cpu()
    log(f"[train] card vs CPU {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train_resume(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"[train] kill/resume and int8 {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    for arch, (layers, shape) in TRAIN_FAMILIES.items():
        t1 = time.perf_counter()
        ftally, btally = collections.Counter(), collections.Counter()
        fam = train_family(arch, layers, shape, ftally, btally)
        for key in btally:
            windows[key] = (arch, fam["cfg"].window)
        for key in ftally:
            fwd_arch.setdefault(key, arch)
        fwd_tally.update(ftally)
        bwd_tally.update(btally)
        torch.cuda.empty_cache()
        log(f"[train] {arch} {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    qwen = get_config(LM_ARCH)
    names = {}
    for key in bwd_tally:
        arch, window = windows.get(key, (LM_ARCH, qwen.window))
        _, b, sq, t, h, hkv, d, causal, windowed = key
        kind = ("causal" if causal else "non-causal") + (
            f", window {window}" if windowed else "")
        label = arch if arch == HUNDRED_M else arch.split("-")[0]
        names[key] = (f"{label} train ({b}, {sq}) x {t}, H {h}/{hkv}, "
                      f"D {d}, {kind}", window if windowed else 0)
    rows = []
    for key in sorted(bwd_tally, key=str):
        name, window = names[key]
        qwen_main = key[1:7] == (*TRAIN_SHAPE, TRAIN_SHAPE[1],
                                 qwen.n_heads, qwen.n_kv_heads,
                                 qwen.head_dim)
        main_dtype = getattr(torch, key[0])
        rows.append(attention_bwd_row(
            name, key, window, bwd_tally[key],
            (torch.bfloat16, torch.float32) if qwen_main
            else (main_dtype,), main_dtype))
    main_rows = [r for r in rows
                 if r["launches"] == main["launches"]["flash_attention_bwd"]]
    check(main_rows, "[train] no backward row for the main path")
    rows.append(simt_bwd_entry(main_rows[0],
                               main["launches"]["flash_bwd_simt"]))
    log(f"[train] backward rows {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    # forward shapes of the training paths that no earlier row covers
    covered = {(r.get("kernel_route"), *r["shape"]) for r in prev_rows
               if r["name"].startswith("flash_attention (")}
    for key, n in sorted(fwd_tally.items(), key=str):
        route, b, sq, t, h, hkv, d, causal, windowed = key
        if (route, b, sq, t, h, hkv, d) in covered:
            continue
        arch = fwd_arch[key]
        cfg = (small["cfg"] if arch == HUNDRED_M else
               family_config(arch, TRAIN_FAMILIES.get(arch, (0,))[0]))
        kw = dict(causal=causal, window=cfg.window if windowed else 0)
        dtype = torch.float32 if route == "tc32" else torch.bfloat16
        rows.append(attention_row(f"{arch} train forward", cfg, sq, t, kw,
                                  n, b, (dtype,), dtype))
        covered.add((route, b, sq, t, h, hkv, d))
    log(f"[train] forward rows {time.perf_counter() - t1:.1f} s")
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 10: the census of one card
# ---------------------------------------------------------------------------
def census_check(rec: dict, launches: dict, kernels: tuple) -> None:
    """One census record against the rules: ``ok``; 0 < useful ratio ≤ 1;
    0 < work FLOPs ≤ the dense count; the measured step no faster than its
    compute term (the work count's) or than one pass over its live
    arguments at HBM's rate; every launch of ``kernels``
    counted by ``op_cost`` (per step, × the steps run) equal to the launch
    counters over the cell, each on its census route."""
    what = f"[census] {rec['arch']} {rec['shape']}"
    check(rec["status"] == "ok", f"{what}: {rec['status']}")
    r = rec["roofline"]
    check(0 < r["useful_flops_ratio"] <= 1,
          f"{what}: useful flops ratio {r['useful_flops_ratio']}")
    c = rec["op_cost"]
    check(0 < c["work_flops"] <= c["flops"], f"{what}: work flops "
          f"{c['work_flops']} against the dense {c['flops']}")
    check(rec["step_s"] >= r["compute_s"], f"{what}: step {rec['step_s']} s "
          f"beats its compute term {r['compute_s']} s")
    live_s = rec["live_bytes"] / PEAK_BYTES
    check(rec["step_s"] >= live_s, f"{what}: step {rec['step_s']} s beats "
          f"one pass over its live arguments {live_s} s")
    counted = rec["op_cost"]["kernels"]
    check(set(counted) == set(kernels), f"{what}: kernels {sorted(counted)}")
    for name in kernels:
        k = counted[name]
        check(k["launches"] > 0 and launches[name] == rec["steps_run"]
              * k["launches"], f"{what}: {name} counted {k['launches']} a "
              f"step, launched {launches[name]} in {rec['steps_run']} steps")
        check(set(k["routes"]) <= CENSUS_ROUTES[name],
              f"{what}: {name} routes {k['routes']}")
    check(launches["flash_prefill_tc"] + launches["flash_decode_split"]
          == launches["flash_attention"]
          and launches["flash_bwd_tc"] == launches["flash_attention_bwd"]
          and launches["verify_tc"] == launches["verify_pairs_batch"],
          f"{what}: a launch off its census route: {launches}")


def census_smoke_flops() -> dict:
    """The smoke config's train, prefill and decode steps at CENSUS_SMOKE
    count the same FLOPs under ``OpCost`` on the card (the kernels' from
    their launch sites) as on the port's CPU path (the plain versions)."""
    cfg = smoke_config(get_config(LM_ARCH))
    b, s = CENSUS_SMOKE
    out = {}
    for name in CENSUS_SHAPES:
        shape = dataclasses.replace(SHAPES[name], seq_len=s,
                                    global_batch=b * 256)
        flops = {}
        for dev in ("cpu", "cuda"):
            step, args, _ = prepare_cell(
                build_model(cfg, device=dev), shape, device=dev,
                generator=torch.Generator().manual_seed(0))
            with OpCost() as oc:
                step(*args)
            flops[dev] = oc.summary()["flops"]
        check(flops["cuda"] == flops["cpu"], f"[census] smoke {name}: card "
              f"counts {flops['cuda']} FLOPs, CPU {flops['cpu']}")
        out[name] = flops["cuda"]
    return out


def census_prefill_row(cfg, s: int, launches: int) -> dict:
    """The (1, s) bf16 prefill of the census: the kernel on all s rows,
    held on its last CENSUS_CHECK_ROWS against the plain version over all
    keys (through ``q_offset``); timed (CUDA events: one call takes
    milliseconds) beside the plain version run in row blocks of
    CENSUS_PLAIN_ROWS (the whole would need (s, s) float32 scores), SDPA
    (is_causal) and the bound."""
    t_row = time.perf_counter()
    kw = dict(causal=True)
    q, k, v = attn_inputs(cfg, 1, s, s, torch.bfloat16, seed=s)
    route = flash.launch_plan(1, s, s, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, torch.bfloat16).route
    check(route == "tc", f"[census] prefill ({s}) routed {route}")
    r0 = s - CENSUS_CHECK_ROWS
    got = ops.gqa_attention(q, k, v, **kw)[:, r0:].float()
    want = ref.gqa_attention(q[:, r0:], k, v, causal=True,
                             q_offset=r0).float()
    over = (got - want).abs() - ATTN_TOL[torch.bfloat16] * (1 + want.abs())
    check(torch.isfinite(got).all().item() and over.max().item() <= 0,
          f"[census] flash prefill ({s}) outside tolerance by "
          f"{over.max().item()}")
    err = (got - want).abs().max().item()
    del got, want

    def plain():
        for r in range(0, s, CENSUS_PLAIN_ROWS):
            ref.gqa_attention(q[:, r:r + CENSUS_PLAIN_ROWS], k, v,
                              causal=True, q_offset=r)

    ms = cuda_ms(lambda: ops.gqa_attention(q, k, v, **kw), reps=5, warm=1)
    plain_ms = cuda_ms(plain, reps=1, warm=1)
    lib_ms = cuda_ms(lambda: sdpa_call(q, k, v, kw, None), reps=5, warm=1)
    shape = (1, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    bms, by = route_bound("flash_attention", shape, torch.bfloat16, route,
                          **attention_counts(s, s, causal=True))
    log(f"[census] flash prefill (1, {s}, {cfg.n_heads}, {cfg.head_dim}) x "
        f"(1, {s}, {cfg.n_kv_heads}, {cfg.head_dim}): route bfloat16 {route}, "
        f"max abs err {err!r} on the last {CENSUS_CHECK_ROWS} rows; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms (rows of "
        f"{CENSUS_PLAIN_ROWS}), sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms "
        f"({by}), share {bms / ms:.3f}; launches {launches}; row "
        f"{time.perf_counter() - t_row:.1f} s")
    return dict(
        name=f"flash_attention (qwen3 census prefill ({s}))", route="cuda",
        source=FLASH_SOURCES[route],
        replaces="src/repro/kernels/flash_attention.py:77",
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms, kernel_route=route,
        checked_rows=CENSUS_CHECK_ROWS,
        shape=[1, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
        dtype="bfloat16", ok=True)


def census_verify_row(superstep, eps: float, launches: int) -> dict:
    """The join superstep's verify at its census shape (E, cap, cap, d):
    the kernel on all E lanes, held on the first CENSUS_VERIFY_LANES
    against the plain version (the d² tolerance, the mask but on the ε²
    band); timed (CUDA events) beside the plain version run in blocks of
    CENSUS_PLAIN_LANES lanes (the whole at once would hold several (E,
    cap, cap) float32 temporaries), ``torch.cdist`` and the bound."""
    t_row = time.perf_counter()
    slab, eidx = superstep
    u, v = dist_mod._lanes(slab, eidx[:, 0]), dist_mod._lanes(slab,
                                                               eidx[:, 1])
    e, cap, d = u.shape
    plan = verify.launch_plan(cap, cap, d)
    check(plan.route == "tc", f"[census] verify routed {plan}")
    eps2 = ops.eps2_f32(eps)
    n = CENSUS_VERIFY_LANES
    d2k, mk = ops.verify_pairs_batch(u, v, eps)
    d2r, mr = ref.pairwise_l2_threshold(u[:n], v[:n], eps2)
    err, n_dis = check_d2(d2k[:n], d2r, mk[:n], mr, eps)
    del d2k, mk, d2r, mr

    def plain():
        for i in range(0, e, CENSUS_PLAIN_LANES):
            j = i + CENSUS_PLAIN_LANES
            ref.pairwise_l2_threshold(u[i:j], v[i:j], eps2)

    ms = cuda_ms(lambda: ops.verify_pairs_batch(u, v, eps), reps=5, warm=1)
    plain_ms = cuda_ms(plain, reps=1, warm=1)
    lib_ms = cuda_ms(lambda: torch.cdist(u, v), reps=2, warm=1)
    bms, by = verify_bound(e, cap, cap, d)
    log(f"[census] verify_pairs_batch ({e}, {cap}, {cap}, {d}): route "
        f"{plan.route}; max abs err {err!r}, mask disagreements {n_dis} on "
        f"the first {n} lanes; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(lanes of {CENSUS_PLAIN_LANES}), cdist {lib_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}), share {bms / ms:.3f}; launches {launches}; "
        f"row {time.perf_counter() - t_row:.1f} s")
    return dict(
        name="pairwise_l2_threshold_batched (census join superstep)",
        route="cuda", source=VERIFY_SOURCES["tc"],
        replaces="src/repro/kernels/pairwise_l2.py:86", launches=launches,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, kernel_route=plan.route,
        checked_lanes=n, shape=[e, cap, cap, d], ok=True)


def phase_census() -> list[dict]:
    """[census]: ``census.run_cell`` for qwen3-0.6b × train_4k,
    prefill_32k and decode_32k and ``census_join.run`` at its defaults
    (counts zeroed just before each, read just after; ``census_check``);
    the smoke config's card FLOPs against its CPU FLOPs; each record's
    line and the four's roofline table; a kernel row for each new shape
    of the cells: the 32k prefill, the 32k decode, the (1, 4096) train
    forward and backward, and the join's verify."""
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    recs, cell_launches = [], {}
    for name, kernels in CENSUS_SHAPES.items():
        ops.reset_launches()
        rec = census_mod.run_cell(LM_ARCH, name)
        launches = ops.launches_snapshot()
        census_mod.free_device_memory()
        log(census_mod.record_line(rec))
        census_check(rec, launches, kernels)
        recs.append(rec)
        cell_launches[name] = launches
    superstep = census_join.make_superstep(4096, 1024, 128, 512)
    ops.reset_launches()
    join = census_join.run(superstep=superstep)
    launches = ops.launches_snapshot()
    log(census_mod.record_line(join) + f", pairs {join['pairs']}")
    census_check(join, launches, ("verify_pairs_batch",))
    recs.append(join)
    cell_launches["join"] = launches
    log(f"[census] cells {time.perf_counter() - t0:.1f} s")
    smoke = census_smoke_flops()
    log(f"[census] smoke config FLOPs, card = CPU: {smoke}")
    for line in roofline.to_markdown(
            [r["roofline"] for r in recs]).splitlines():
        log(f"[census] {line}")
    t1 = time.perf_counter()
    train = cell_launches["train_4k"]
    s_train = SHAPES["train_4k"].seq_len
    s_pre = SHAPES["prefill_32k"].seq_len
    t_dec = SHAPES["decode_32k"].seq_len
    rows = [census_prefill_row(cfg, s_pre,
                               cell_launches["prefill_32k"]["flash_attention"])]
    rows.append(attention_row(
        f"qwen3 census decode, T {t_dec}", cfg, 1, t_dec,
        dict(q_offset=t_dec - 1, kv_positions=torch.arange(
            t_dec, dtype=torch.int32, device="cuda")),
        cell_launches["decode_32k"]["flash_attention"], 1,
        (torch.bfloat16,), torch.bfloat16))
    rows.append(attention_row(
        f"qwen3 census train forward ({s_train})", cfg, s_train, s_train,
        {}, train["flash_attention"], 1, (torch.bfloat16,), torch.bfloat16))
    rows.append(attention_bwd_row(
        f"qwen3 census train (1, {s_train})",
        ("bfloat16", 1, s_train, s_train, cfg.n_heads, cfg.n_kv_heads,
         cfg.head_dim, True, False), 0, train["flash_attention_bwd"],
        few_reps=True))
    rows.append(census_verify_row(superstep, census_join.EPS,
                                  cell_launches["join"]["verify_pairs_batch"]))
    del superstep
    torch.cuda.empty_cache()
    log(f"[census] kernel rows {time.perf_counter() - t1:.1f} s")
    log(f"[census] phase {time.perf_counter() - t0:.1f} s")
    return rows


DRYRUN_CELLS = {"train_4k": ("flash_attention", "flash_attention_bwd"),
                "decode_32k": ("flash_attention", "flash_decode_merge")}
DRYRUN_ROUTES = {"flash_attention": {"tc", "split"},
                 "flash_attention_bwd": {"tc"},
                 "flash_decode_merge": {"split"},
                 "verify_pairs_batch": {"tc"}}
DRYRUN_DEADLINE_S = 300


def dryrun_cells(out_path: str) -> None:
    """[dryrun]'s child process: qwen3-0.6b × DRYRUN_CELLS and the join
    superstep as rank 0 of 16×16 in a fake world of 256 ranks (counts
    zeroed just before each, read just after) → pickled to ``out_path``:
    each record, its launch counts and its tally."""
    import pickle
    torch.cuda.set_device(0)
    _build.load()
    ops_dir = os.path.join(os.path.dirname(out_path), "ops")
    out = {}
    for shape in DRYRUN_CELLS:
        ops.reset_launches()
        rec = dryrun_mod.run_cell(LM_ARCH, shape, False, ops_dir=ops_dir)
        out[shape] = (rec, ops.launches_snapshot(), dryrun_tally(
            ops_dir, rec))
        census_mod.free_device_memory()
    superstep = census_join.make_superstep(4096, 1024, 128, 512)
    ops.reset_launches()
    rec = dryrun_join.run(superstep=superstep)
    out["join"] = (rec, ops.launches_snapshot(), [])
    torch.distributed.destroy_process_group()
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".tmp", out_path)


def dryrun_tally(ops_dir: str, rec: dict) -> list:
    import gzip
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['tag']}"
    with gzip.open(os.path.join(ops_dir, name + ".json.gz"), "rt") as f:
        return json.load(f)["tally"]


def dryrun_check(rec: dict, launches: dict, tally: list,
                 kernels: tuple) -> None:
    """One dry-run record against the rules: ``ok``; the step no faster
    than its compute term; the tally's traffic, reckoned here op by op,
    equal to ``collective_bytes``'s, kind by kind; every launch of
    ``kernels`` that ``op_cost`` counted (a step, × the steps run) equal to
    the launch counters over the cell, each on its route."""
    what = f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']}"
    check(rec["status"] == "ok", f"{what}: {rec['status']} "
          f"{rec.get('error', '')}")
    r = rec["roofline"]
    check(rec["step_s"] >= r["compute_s"], f"{what}: step {rec['step_s']} s "
          f"beats its compute term {r['compute_s']} s")
    mine = {k: 0 for k in COLLECTIVES}
    for e in tally:
        n, b = e["n"], e["bytes"]
        mine[e["kind"]] += (b if e["kind"] == "collective-permute" else
                            int((2 if e["kind"] == "all-reduce" else 1)
                                * b * (n - 1) / n))
    coll = rec["collectives"]
    check(all(coll[k]["traffic_bytes"] == mine[k] for k in COLLECTIVES)
          and coll["total_traffic_bytes"] == sum(mine.values())
          == rec["op_cost"]["collective_traffic_bytes"]
          and len(tally) == rec["collective_ops"],
          f"{what}: tally {mine} vs collective_bytes {coll}")
    counted = rec["op_cost"]["kernels"]
    check(set(counted) == set(kernels), f"{what}: kernels {sorted(counted)}")
    for name in kernels:
        k = counted[name]
        check(k["launches"] > 0 and launches[name] == rec["steps_run"]
              * k["launches"], f"{what}: {name} counted {k['launches']} a "
              f"step, launched {launches[name]} in {rec['steps_run']} steps")
        check(set(k["routes"]) <= DRYRUN_ROUTES[name],
              f"{what}: {name} routes {k['routes']}")
    check(launches["flash_prefill_tc"] + launches["flash_decode_split"]
          == launches["flash_attention"]
          and launches["flash_bwd_tc"] == launches["flash_attention_bwd"]
          and launches["verify_tc"] == launches["verify_pairs_batch"],
          f"{what}: a launch off its route: {launches}")


def decode_slice_row(cfg, b: int, t_slice: int, n: int,
                     launches: int) -> dict:
    """The decode step of a cache split over n ranks, at the shape one
    rank runs: its slice (B, 1, H, D) × (B, T/n, Hkv, D) through the split
    route with its log-sum-exp, then the merge launch over n slices' parts.
    Held whole: n slices of a full cache, each through the kernel, merged
    by the merge kernel, against the plain attention over the whole cache
    (ATTN_TOL); the merge against its plain version. Timed (CUDA graphs):
    one slice's launch plus one merge, beside the plain slice and merge,
    SDPA over the slice, and the bound of the two launches' work."""
    t_row = time.perf_counter()
    t = t_slice * n
    pos = t - 1
    q, k, v = attn_inputs(cfg, b, 1, t, torch.bfloat16, seed=t_slice + n)
    kpos = torch.arange(t, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, q_offset=pos)
    parts = [ops.gqa_attention_lse(q, k_, v_, kv_positions=p_, **kw)
             for k_, v_, p_ in zip(k.chunk(n, 1), v.chunk(n, 1),
                                   kpos.chunk(n))]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([x for _, x in parts])
    got = ops.decode_merge(outs, lses, q.dtype, cfg.n_kv_heads).float()
    want = ref.gqa_attention(q, k, v, kv_positions=kpos, **kw).float()
    tol = ATTN_TOL[q.dtype]
    over = (got - want).abs() - tol * (1 + want.abs())
    check(torch.isfinite(got).all().item() and over.max().item() <= 0,
          f"[dryrun] merged decode slices outside tolerance by "
          f"{over.max().item()}")
    err = (got - want).abs().max().item()
    plain_merge = ref.decode_merge(outs, lses)
    merge_err = (got - plain_merge).abs().max().item()
    check(merge_err <= tol * (1 + plain_merge.abs().max().item()),
          f"[dryrun] merge vs its plain version {merge_err}")
    k0, v0, p0 = k[:, :t_slice], v[:, :t_slice], kpos[:t_slice]
    kw0 = dict(kv_positions=p0, **kw)

    def rank_step():
        o, x = ops.gqa_attention_lse(q, k0, v0, **kw0)
        return ops.decode_merge(outs, lses, q.dtype, cfg.n_kv_heads)

    def plain_step():
        ref.gqa_attention_lse(q, k0, v0, **kw0)
        return ref.decode_merge(outs, lses)

    ms = graph_ms(rank_step)
    plain_ms = graph_ms(plain_step, reps=5)
    mask = ref.gqa_mask(1, p0, causal=True, window=0, q_offset=pos)
    lib_ms = graph_ms(lambda: sdpa_call(q, k0, v0, kw0, mask))
    counts = attention_counts(1, t_slice, causal=True, q_offset=pos,
                              positions=p0.cpu().numpy())
    slice_cost = kernel_cost("flash_attention", (b, 1, t_slice, cfg.n_heads,
                                                 cfg.n_kv_heads,
                                                 cfg.head_dim),
                             "bfloat16", "split", **counts)
    merge_cost = kernel_cost("flash_decode_merge", (n, b, 1, cfg.n_heads,
                                                    cfg.head_dim),
                             "bfloat16", "split")
    flops = dict(slice_cost["flops"])
    for c, f in merge_cost["flops"].items():
        flops[c] = flops.get(c, 0) + f
    bms, by = kernel_bound({"flops": flops, "bytes": slice_cost["bytes"]
                            + merge_cost["bytes"]})
    log(f"[dryrun] flash decode slice + merge ({b}, 1, {cfg.n_heads}, "
        f"{cfg.head_dim}) x ({b}, {t_slice}, {cfg.n_kv_heads}, "
        f"{cfg.head_dim}), {n} slices: {n} merged against the whole "
        f"{t}-row cache max abs err {err!r}, merge vs plain {merge_err!r}; "
        f"a rank's slice + merge {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"(slice) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), share "
        f"{bms / ms:.3f}; launches {launches}; row "
        f"{time.perf_counter() - t_row:.1f} s")
    return dict(
        name="flash_attention (dry-run decode slice + merge, 16x16 rank)",
        route="cuda", source=FLASH_SOURCES["split"],
        replaces="src/repro/kernels/flash_attention.py:77",
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms, kernel_route="split",
        merge_max_abs_err=merge_err, slices=n,
        shape=[b, 1, t_slice, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
        dtype="bfloat16", ok=True)


def phase_dryrun() -> list[dict]:
    """[dryrun]: ``dryrun_cells`` in a child process (a process holds one
    default group; the fake world's must not meet [mesh]'s), each record
    checked (``dryrun_check``) and logged; then a kernel row for each new
    shape the cells ran: the train_4k rank's forward and backward at its
    local head (B 16, S = T 4,096, H 1, Hkv 1), the decode_32k rank's
    slice and merge (B 8, T 2,048, H 16, Hkv 8, 16 slices) and the join's
    16 edges a rank."""
    import pickle
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    path = os.path.join(tmp, "cells.pkl")
    try:
        proc = multiprocessing.get_context("forkserver").Process(
            target=dryrun_cells, args=(path,), daemon=True)
        proc.start()
        proc.join(DRYRUN_DEADLINE_S)
        if proc.is_alive():
            proc.kill()
            proc.join(10)
        check(os.path.exists(path), f"[dryrun] the child process left no "
              f"result (exit code {proc.exitcode})")
        with open(path, "rb") as f:
            cells = pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for shape, kernels in DRYRUN_CELLS.items():
        rec, launches, tally = cells[shape]
        log(dryrun_mod.record_line(rec))
        dryrun_check(rec, launches, tally, kernels)
    join, jl, _ = cells["join"]
    log(dryrun_mod.record_line(join) + f", pairs {join['pairs']}")
    dryrun_check(join, jl, [], ("verify_pairs_batch",))
    check(join["rank_edges"] == 16, f"[dryrun] join edges {join}")
    log(f"[dryrun] cells {time.perf_counter() - t0:.1f} s (a child process)")
    t1 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    train = cells["train_4k"][1]
    rec = cells["train_4k"][0]
    b, s = rec["rank_rows"], SHAPES["train_4k"].seq_len
    one = dataclasses.replace(cfg, n_heads=cfg.n_heads // 16,
                              n_kv_heads=max(1, cfg.n_kv_heads // 16))
    rows = [attention_row(
        f"qwen3 dry-run train forward, 16x16 rank ({b}, {s}), "
        f"{one.n_heads} head", one, s, s, {}, train["flash_attention"], b,
        (torch.bfloat16,), torch.bfloat16)]
    rows.append(attention_bwd_row(
        f"qwen3 dry-run train, 16x16 rank ({b}, {s}), {one.n_heads} head",
        ("bfloat16", b, s, s, one.n_heads, one.n_kv_heads, cfg.head_dim,
         True, False), 0, train["flash_attention_bwd"], few_reps=True))
    dec = cells["decode_32k"][0]
    t_slice = SHAPES["decode_32k"].seq_len // 16
    rows.append(decode_slice_row(cfg, dec["rank_rows"], t_slice, 16,
                                 cells["decode_32k"][1][
                                     "flash_decode_split"]))
    superstep = census_join.make_superstep(4096, 1024, 128, 512)
    row = census_verify_row((superstep[0], superstep[1][:16]),
                            census_join.EPS, jl["verify_pairs_batch"])
    row["name"] = ("pairwise_l2_threshold_batched (dry-run join superstep, "
                   "16 edges a 16x16 rank)")
    rows.append(row)
    del superstep
    torch.cuda.empty_cache()
    log(f"[dryrun] kernel rows {time.perf_counter() - t1:.1f} s")
    log(f"[dryrun] phase {time.perf_counter() - t0:.1f} s")
    return rows


def profile_lm_decode(bundle, params, tok) -> None:
    """Eight warm decode steps under torch.profiler: device time by kernel
    and the device's busy share of the steps' wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    caches = bundle.init_cache(LM_SLOTS, LM_MAX_SEQ)
    bundle.decode(params, tok, caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            bundle.decode(params, tok, caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    log(f"[profile-lm] 8 decode steps wall {wall * 1e3:.2f} ms, device "
        f"kernels {busy * 1e3:.2f} ms (busy share {busy / wall:.3f})")
    for key, us, n in rows[:10]:
        log(f"[profile-lm] {us / 1e3:9.3f} ms  {n:5d} x  {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one more device-mode self_join, point "
                    "queries one at a time (host functions, launches a "
                    "probed bucket), eight LM decode steps and two "
                    "training steps with torch.profiler: device busy "
                    "share and top kernels")
    ap.add_argument("--nccl-two-ranks", action="store_true",
                    help="only try one NCCL all-reduce between two ranks "
                    "on the one card, and stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.nccl_two_ranks:
        log(gpu_name_and_power())
        log(f"[nccl] two ranks on one card: "
            f"{spawn(nccl_probe, 2, backend='nccl', deadline_s=120)}")
        return 0
    # [mesh]'s ranks fork from a server started now, while this process
    # is small, with this script's imports done there once (and
    # torch._dynamo's, which remat's checkpoint imports at its first call)
    multiprocessing.set_forkserver_preload(["chip_smoke", "torch._dynamo"])
    multiprocessing.forkserver.ensure_running()
    t_all = time.perf_counter()
    phase_device()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        main_path = phase_main_path(workdir)
        kernels = phase_kernels(main_path)
        t_io = time.perf_counter()
        io = phase_io(main_path, workdir)
        log(f"[io] phase {time.perf_counter() - t_io:.1f} s")
        # the [io] paths' own launch counts beside the main path's
        wrapper = {"pairwise_l2_threshold_batched": "verify_pairs_batch",
                   "pairwise_l2_threshold": "pairwise_l2_threshold",
                   "bucket_assign": "bucket_assign"}
        for k in kernels:
            k["io_launches"] = {path: n[wrapper[k["name"]]]
                                for path, n in io["launches"].items()}
        t_serve = time.perf_counter()
        serve = phase_serve(main_path, workdir)
        log(f"[serve] phase {time.perf_counter() - t_serve:.1f} s")
        for k in kernels:   # the [serve] phase's own launch counts
            k["serve_launches"] = serve["launches"][wrapper[k["name"]]]
        t_dist = time.perf_counter()
        dist = phase_dist(workdir)
        log(f"[dist] phase {time.perf_counter() - t_dist:.1f} s")
        for k in kernels:   # the [dist] phase's own launch counts
            k["dist_launches"] = dist["launches"][wrapper[k["name"]]]
        t_parity = time.perf_counter()
        parity = phase_parity(workdir)
        for k in kernels:   # the planned join's own launch counts (100k)
            k["parity_launches"] = {
                "planned": parity["planned"][wrapper[k["name"]]]}
        log(f"[parity] phase {time.perf_counter() - t_parity:.1f} s")
        if args.profile:
            phase_profile(main_path["shapes"]["index"])
            profile_queries(main_path["shapes"]["index"],
                            main_path["shapes"]["Q"])
        main_path["shapes"]["index"].close()
        del main_path
        torch.cuda.empty_cache()
        t_lm = time.perf_counter()
        kernels += phase_lm(args.profile)
        kernels += phase_lm_families()
        log(f"[lm] phase {time.perf_counter() - t_lm:.1f} s")
        torch.cuda.empty_cache()
        kernels += phase_train(kernels, args.profile)
        torch.cuda.empty_cache()
        kernels += phase_census()
        torch.cuda.empty_cache()
        kernels += phase_dryrun()
        torch.cuda.empty_cache()
        # last: it needs [dist]'s 100k index, kept in the workdir till now
        mesh = phase_mesh(dist["mesh_job"], workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        stop_fork_server()
    attach_mesh_launches(kernels, mesh)
    log(f"[done] total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
