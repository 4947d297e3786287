#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, from the repository root

Phases, each printing one JSON line:

1. card — ``nvidia-smi`` name and power limit;
2. build — nvcc builds every kernel of ``src/repro_torch/kernels/csrc``;
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card, at the stated tolerances, on a grid that holds every shape (and
   kind of W) that the later phases run it at; the two-route kernels on
   both routes — B5, B6 and B7 (tensor cores, CUDA cores), B2 (a cluster
   per client, a block per client), B1 (unrolled, tiled), B4 (stripe,
   row-block) and B8 (chunked, walk) — each call on the route its rule
   gives it and every call of the new route repeated on the old one (bit
   for bit for B1, B2's wire and B4; B8's walk bit for bit the plain
   version), B8 also on a and u drawn as the model draws them at the
   served shape (TOL_SERVE_F32), and the gossip pair calls (x and y in one
   launch) against two plain single calls; B1's and B4's row blocks of the
   decentralized mesh on both routes (B1: a rank's 4 of 8 rows of W over
   all 8 rows of Δ and θ; B4: a rank's 1024 of 4096 rows of the exp lists
   remapped onto its own rows and its halo; both also at the mesh
   phase's own shape, a rank's 2 of 4 rows over the packed qwen2-0.5b at
   MESH_LAYERS layers, B4 on the ring's halo), each against its plain
   version and bit for bit the whole call's rows;
4. main — K-GT-Minimax and its three baselines through ``engine.run`` at
   the full round geometry (n = 8, K = 8, dx = 384, dy = 128, ring,
   σ = 0.1), 50 rounds per (algorithm, mixing_impl); the packed and
   whole-round lowerings must match ``dense``, and the kernels' launch
   counts must be what the path implies (one gossip pair launch a round),
   every whole-round launch on the cluster route and every gossip launch
   on the unrolled route;
5. quickstart — at the quickstart geometry (fused_round) K-GT-Minimax
   must end below local SGDA, with one whole-round launch a round, on the
   cluster route;
6. scale — the sparse path at n = 4096 clients on the exponential graph
   (dx = 384, dy = 128, K = 8): ``sparse_packed`` against ``dense`` on the
   same W for the four algorithms, the neighbor-gather kernel's launch
   counts (one pair launch a round, all on the stripe route), the four
   churn families under 70 % participation (Σc ≈ 0,
   inactive clients frozen bit for bit), churn at n = 512 through all three
   kernels on the same per-round W and mask, and rounds/s (of captured
   chunks);
7. graph — the engine's CUDA graphs (every chunk of the phases above and
   below is captured and replayed) against eager chunks
   (``capture=False``) from the same state: the four algorithms at the
   main geometry on dense, pallas_packed and fused_round, sparse_packed
   and dense at n = 4096, one churn family at n = 4096 under 70 %
   participation — final states and histories bit for bit (dense within
   TOL_GRAPH_DENSE should cuBLAS pick another algorithm under capture),
   launches by route equal; a checkpoint saved at a ``boundary_every``
   multiple, restored into a fresh template and run on, bit for bit an
   uninterrupted run; rounds/s of both (an eager turn, then a graph
   turn), the capture seconds and the draws' host seconds;
8. sweep — ``run_sweep`` on the card: ``convergence`` (4 algorithms ×
   SWEEP_SEEDS of its 8 seeds) on dense, fused_round and pallas_packed,
   each point again
   through ``run_point`` (rounds-to-ε and final ‖∇Φ‖ equal), B1 and B2
   launched inside the captured cells on the routes ``ops.ROUTED``
   names, kgt_minimax hitting ε at least as often as local_sgda; wall,
   capture and run seconds, trajectory-rounds/s, ``summarize`` per
   algorithm; ``churn`` on dense beside the committed
   ``results/sweeps/churn.json`` (statistical, not a check);
9. serve — ``launch.serve.serve`` at full width in bf16 on
   recurrentgemma-9b (a batched prefill of 4 prompts of 4096 tokens
   through the flash-attention and RG-LRU scan kernels) and on mamba2-1.3b
   (8 prompts of 4096 tokens through the SSD scan kernel), then 16 decode
   steps each; the prefill's logits and caches against the same prefill
   through the plain versions, prefill + decode against the plain
   full-sequence forward, the kernels' launches (one a layer in the
   prefill: 12 and 26, and 48; none in decode; every attention and SSD
   scan launch on the tensor-core route, every RG-LRU scan launch on the
   route its rule gives, no backward launch), prefill s, decode
   ms/token, tokens/s, peak memory, and a profile of a warm prefill and of
   decode steps; the decode step is a CUDA graph (``DecodeStep``), and the
   same prompts decoded again eagerly and captured from one seed must
   agree bit for bit, with the ms/token of both;
10. evaluate — ``launch.evaluate.evaluate`` on mamba2-1.3b at full width:
   ``group_metrics`` on one batch of 4 × 4096 tokens for each of 4
   clients, through the SSD scan (48 launches a call) and the fused
   cross-entropy (1), both on the tensor-core route; group losses against
   the plain route, finiteness, seconds and tokens/s a client batch, peak
   memory, a profile;
11. times — device times of each kernel, its plain version and, where one
   exists, a PyTorch library call, beside the bounds (the two-route
   kernels on both routes; B4's L2 bytes by design); the gossip pairs at
   the paths' shapes, the dense epilogue at D ≈ 1e8 and the neighbor-
   gather epilogue at D = 16384, the model kernels at the served shapes
   and at S = 32768 (B8 also at the train and mesh-rank shapes, with its
   backward kernel), B1's and B4's row blocks at the kernels phase's
   shapes, the mesh phase's included (B4's beside ``torch.sparse.mm`` of
   the rank's CSR rows), and
   rounds/s per mixing_impl.

12. compress — error-feedback compression at the main geometry on
   pallas_packed and fused_round, bf16 and int8, kgt_minimax and gt_gda,
   50 rounds: every transmit of an eager run checked on the card's own v
   (q == Q(v), q + e' == v bit for bit, inactive rows keep e; on
   fused_round through the kernel's wire, v against the plain K steps),
   the same runs through captured chunks bit for bit, with B1's and B2's
   launches by route and B2's compressed launches by route, Σc = 0; int8
   against the exact trajectory over 100 rounds within 1e-3; the freeze
   of θ, c and the residual under 70 % participation; a checkpoint resume
   of a compressed state; rounds/s exact, bf16 and int8, eager and
   captured in turns;
13. adversary — one round per attack and lowering at n = 8 (dense,
   pallas_packed, coord_median, trimmed_mean): an honest adversary is the
   plain step bit for bit, Σc = 0 under attack on dense and pallas_packed,
   every robust aggregation against ``robust_agg_ref``; captured chunks
   bit for bit eager under attack (robust and pallas_packed);
   sparse_trimmed_mean and sparse_coord_median at n = 4096 on the
   exponential graph, 20 rounds eager and captured; rounds/s; then the
   ``adversary`` sweep (ADV_SWEEP_SEEDS of its 2 seeds) through
   ``run_sweep``, every point again
   through ``run_point``, hit rates and rounds-to-ε beside the committed
   ``results/sweeps/adversary.json`` (statistical, not a check);
14. obs — ``obs.health_gauges`` on a compressed state and one
   ``obs.Profiler`` window over 10 captured rounds (a non-empty trace).

15. train — federated DRO training of qwen2-0.5b at full width (d_model
   896, V = 151 936; bf16 compute, f32 state), cut to TRAIN_LAYERS of its
   24 layers, through
   ``launch.train`` at the reference's train defaults (n = 4, K = 4,
   batch 4 × 128 tokens a client, 8 groups): one local step's per-client
   gradients (``vmap(grad)``) through B5 and B6 against the plain route in
   f32 compute (the CUDA-core routes, within 1e-4·(1 + max)) and bf16 (the
   tensor-core routes); the main path, three rounds at n = 4 in one
   captured chunk (the state donated to it) with B5's and B6's launches by
   route, bit for bit the same rounds eager; a checkpoint resume of a
   captured run at n = 2; rounds/s eager and captured in turns, capture s,
   tokens/s, peak memory; one round of each baseline; B5 and B6 at the
   train shapes, held against their plain versions, with forward, plain
   and backward times.
15b. mesh — the decentralized training mesh (``launch.train --mesh
   decentralized``) at the train phase's geometry (qwen2-0.5b cut to
   MESH_LAYERS, n = 4, K = 4, 4 × 128 tokens a client) over a world of
   2 ranks (``dist.launch.run_world``: NCCL with a card a rank where the
   machine has two, else both ranks on cuda:0 over gloo), 2 clients a
   rank: MESH_ROUNDS (2) rounds of dense through ``--engine host`` and
   through ``--engine scan`` (eager chunks) and of fused_ring (the
   neighbour exchange); MESH_LOWERING_ROUNDS (1) of sparse_packed (the halo exchange, B4 on a rank's
   remapped table), pallas_packed with int8 compression (B1 on a rank's
   row block, on q) and sparse_trimmed_mean (the halo, the plain order
   statistic), each held to its host path run here from the same seed
   (TOL_MESH_X / TOL_MESH_Y, printed before the reading), Σc = 0 but for
   the robust rule, B5's, B6's, B1's and B4's launches by route on every
   rank, no collective in the local steps, the gossip's collectives and
   bytes a round against the formula (a halo's rows by the rank's plan);
   a world of 1 over NCCL bit for bit the host path; rounds/s, tokens/s,
   communication s a round and peak memory per rank.  Then a
   ``topology_cycle`` (ring, exp) of pallas_packed for twice its length
   in rounds through ``--engine scan`` with ``--telemetry-out`` (B1 on a
   rank's rows of each round's W), held to its host path, its stream's
   rows and health gauges (summed over the clients axis) to the host
   path's stream; and one round with traced stepsizes
   (``point_etas``' bundle) bit for bit the round with them baked in.
15b'. fsdp_mesh — a client's weights over the mesh's fsdp and model axes
   (``launch.steps.build_train_round`` on ``launch.mesh.train_mesh(2, 2,
   2)``, ``dist.tensor_parallel.ClientShard``): 8 gloo ranks on cuda:0
   running FSDP_MESH_RUNS in one world: qwen2-0.5b at full width cut to
   FSDP_MESH_LAYERS (2) layers, FSDP_MESH_ROUNDS (2) rounds; mamba2-1.3b
   and granite-moe-1b-a400m (experts split over model) at full width,
   2 layers, and the reduced recurrentgemma-9b, one round each, then
   granite again in bf16 replaying the host path's expert choices; every
   run under MeshConfig's default remat (each unit checkpointed: B5, B7
   and B8 twice a layer and local step) but qwen2-0.5b once more without
   it, held to the remat run bit for bit where the kernels are
   deterministic; then, in a world of its own of 4 ranks on (2, 1, 2),
   qwen2-0.5b at full width (2 layers, bf16) with its weights whole on
   every rank (``param_mode="replicated"``: the whole-vocabulary B6, the
   gossip on the whole client), held to its host path; then at one rank a
   client qwen2-0.5b at full depth (24 layers), n = 2, one eager round
   with remat off and one with it on, both peaks and seconds printed;
   n = 2, K = 4, 4 × 128 tokens a client, pallas_packed, each rank
   holding its (fsdp, model) quarter of its client's x and cx, the
   residual's sequence split over model (``residual_mode="batch_seq"``,
   the default: its gathers and reduce-scatters as many); each run
   held to its host path run here from the same seed (bf16: TOL_MESH_X /
   TOL_MESH_Y; f32: TOL_TRAIN_F32), granite's expert choices against the
   host path's (no flip in f32; counted in bf16); per rank and run the
   state's bytes, peak memory, the seconds and bytes a round of the fsdp
   gathers, the reduce-scatters, the model sums, the sequence's gathers
   and reduce-scatters, the RG-LRU gate input's gathers and the gossip,
   rounds/s, and B1's, B5's, B6's
   vocab-parallel, B7's and B8's launches by route, B8's backward
   launches (the whole-vocabulary B6 launches no time); each kernel at a
   rank's shape in each run against its plain version.  The kernels
   phase holds B6's vocab-parallel form (``ce_partials``) against its
   plain version at a rank's shape on both routes and the merged NLL of
   two pieces against whole-vocabulary B6 (TOL_CE_MERGED).
15c. serve_mesh — the serving mesh (``launch.steps.build_prefill_step``
   and ``build_decode_step`` on a ``(data, model)`` mesh, tensor
   parallelism from ``dist.tensor_parallel``): qwen2-0.5b at full width
   (24 layers, bf16) prefilling 4 × 4096 tokens and decoding 16, over a
   world of 2 ranks (NCCL with a card a rank, else both on cuda:0 over
   gloo) at (data 1, model 2) and (data 2, model 1), a prefill's residual
   split over model by sequence (2048 positions a rank at model 2), a
   decode step's whole, held to the single
   process (``serve_single_process``, run here first) at
   TOL_SERVE: the last logits, the caches gathered over heads and rows,
   16 teacher-forced decode steps' logits; the model ranks' logits and
   samples alike; B5 24 launches a prefill on every rank on tensor cores
   (at (4, 4096, 7, 1, 64) on a model rank, held against its plain version
   and timed beside SDPA and its bound); the collectives and bytes a rank
   against the printed formula; a 2-layer f32 prefill at (1, 2) at
   TOL_SERVE_F32; a world of 1 over NCCL bit for bit the single process;
   then on the same world at (data 1, model 2) (SERVE_SCAN) mamba2-1.3b
   at full width cut to 24 of its 48 layers (2 × 4096 prompt tokens, B7
   on 32 of the 64 SSM heads a rank, 24 launches a prefill on tensor
   cores) and
   recurrentgemma-9b at full width and depth (38 layers, 1 × 4096 tokens,
   past its 2048 window; B8 on 2048 of the 4096 LRU channels, 26 launches
   a prefill on the route B8's rule gives the rank's shard, B5 on 8 query
   heads over the KV head both ranks hold, 12 on tensor cores; the single
   process's launches by route alike), each rank drawing only its shard
   (``tp.init_shard``),
   8 teacher-forced decode steps each, held to the single process at the
   arch's TOL_SERVE_BF16 and in f32 (2 and 3 layers) at TOL_SERVE_F32, B7,
   B8 (both routes) and B5 at a rank's shapes against their plain
   versions with their times and bounds; prefill s, decode ms a token,
   tokens/s, communication s, staged GB and peak GB a rank.  The mesh's decode runs
   eagerly (a gloo collective cannot be captured).
16. train_ssm — federated DRO training of the other block kinds:
   mamba2-1.3b at full width (d_model 2048, V = 50 280; bf16 compute, f32
   state) at the reference's train defaults but n = 2, cut in depth
   (SSM_LAYERS_GRADS, SSM_LAYERS_EAGER, SSM_LAYERS_CAPTURED): per-client
   gradients through B7 and B6 against the plain route (f32 and bf16) at
   the gradients' depth, eager rounds/s and peak memory at the eager depth; the main
   path captured at the captured
   depth with B7's and B6's launches by route (B7 one launch a layer and
   local step, the clients folded), bit for bit the host loop, and eager
   and captured rounds/s in turns; the reduced recurrentgemma-9b's
   gradients and one round through B5, B8 and B6 against the plain route
   (B8 on the route its rule gives, its backward kernel launched once a
   forward launch); B8's autograd Function at a full-width layer (forward
   against its plain version, the backward kernel against autograd
   through it) and B7 at the train shape, with forward, plain and
   backward times (B8's both routes, its backward kernel and the plain
   backward).
17. moe — granite-moe-1b-a400m at full width (24 layers, 32 experts top
   8, V = 49 155; bf16): a prefill server on 4 prompts of 4096 tokens
   through B5 (24 launches, tensor cores) against the plain prefill (the
   expert routings of both routes recorded, the flips counted; logits held
   at the prompts whose last token routed alike) and in f32 (no flip);
   16 decode steps from position 0 against the dropless full forward;
   ``group_metrics`` on 4 clients × 4 × 4096 tokens through B5 and B6;
   DRO training at n = 2: per-client gradients through B5 and B6 against
   the plain route (f32: no flip; bf16: flips counted), the main path
   captured bit for bit the host loop, and an eager and a captured rate
   turn, cut in depth (MOE_LAYERS_GRADS, MOE_LAYERS_CAPTURED).
18. frontends — musicgen-medium at full width (4 codebooks; bf16): a
   prefill server on 4 × 1500 frames through B5, ``group_metrics`` with
   B6 launched once a codebook, per-client gradients at
   MUSIC_LAYERS_GRADS layers; internvl2-76b's prefix path at full width
   cut to VLM_LAYERS layers through B5 against plain; the reduced
   internvl2-76b's gradients and one round through B5 and B6.
19. scheduler — the continuous-batching engine
   (``repro_torch.serving.ServingEngine``: every slot at its own
   position, one CUDA graph a tick) at full width on qwen2-0.5b (16 slots,
   caches of 1024, 17 requests of 32–128 prompt and 16–32 new tokens),
   granite-moe-1b-a400m, musicgen-medium and mamba2-1.3b
   (SCHED_CASES), eagerly and captured with the same noise: every tick's
   samples, the outputs, the final caches and logits bit for bit, no
   kernel launched; ticks, ms a tick, generated and prompt tokens/s,
   capture s, peak memory, a replay's device ms; then 8 requests through
   4 slots in f32 compute, each request's logits at every tick against
   the plain full forward of its prompt and outputs within TOL_SERVE_F32
   (granite's at the dropless capacity, run eagerly, no expert set
   differing; mamba2-1.3b's held for requests in a fresh slot only,
   ROADMAP §C quirk 6).

Phases 12–14 run after the sweep phase, before serve; phase 19 right
after serve; phases 15 to 18 (15b, mesh, right after train, and 15c,
serve_mesh, right after mesh) after evaluate, before times.

``--phases card,build,profile`` adds a torch.profiler pass over a few
engine rounds per lowering, eager and captured (device busy share, top
kernels).

Then the ``nvidia-smi`` line, one ``{"kernels": [...]}`` line, and the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the script exits non-zero and prints no ok-line; without CUDA it exits
non-zero at once.  ``--phases`` runs a subset (for debugging).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

PHASES = ("card", "build", "kernels", "main", "quickstart", "scale", "graph",
          "sweep", "compress", "adversary", "obs", "serve", "scheduler",
          "evaluate", "train", "mesh", "fsdp_mesh", "serve_mesh",
          "train_ssm", "moe",
          "frontends", "times")
# not part of the default run: torch.profiler over a few engine rounds
EXTRA_PHASES = ("profile",)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor), dense
# bf16 and dense TF32 (tensor-core) flop/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
TF32_FLOP_S = 494.7e12

# main-path geometry (the round rows of benchmarks/bench_gossip.py, ring)
N, K, DX, DY, SIGMA, ROUNDS = 8, 8, 384, 128, 0.1, 50
ALGOS = ("kgt_minimax", "gt_gda", "dsgda", "local_sgda")
TRACKING = ("kgt_minimax", "gt_gda")

# the sparse path: the largest client count of benchmarks/bench_scale.py,
# on the exponential graph (23 neighbors + self at n = 4096)
SCALE_N, SCALE_ROUNDS, CHURN_ROUNDS = 4096, 20, 10
# B4's check grid: these client counts and SCALE_N
SPARSE_CHECK_NS = (1, 8, 9, 64, 1024)
# the row blocks of B1 and B4 on the decentralized mesh, checked at the main
# path's n over B1_ROW_RANKS ranks (4 rows a rank) and at SCALE_N over
# B4_ROW_RANKS ranks (1024 rows a rank, with its halo)
B1_ROW_RANKS, B4_ROW_RANKS = 2, 4
CHURN_DENSE_N = 512      # the dense samplers' limit (DENSE_MATERIALIZATION_LIMIT)
CHURN_DENSE_ROUNDS = 5
PARTICIPATION = 0.7
# the graph phase: captured chunks against eager ones (chunks of 10 rounds,
# metrics every 5), and a checkpoint every 10 rounds of 30
GRAPH_ROUNDS, GRAPH_CHUNK, GRAPH_LOG = 50, 10, 5
GRAPH_CKPT_ROUNDS, GRAPH_CKPT_EVERY = 30, 10
# compressed gossip: the quantizers on the two lowerings that take them,
# and the rounds of int8 against the exact trajectory
COMPRESS_METHODS = ("bf16", "int8")
COMPRESS_IMPLS = ("pallas_packed", "fused_round")
COMPRESS_DIVERGENCE_ROUNDS = 100
# the adversary: attackers at n = 8 and the attack scale (the adversary
# sweep's), and the lowerings of the one-round checks
ADV_BYZANTINE, ADV_SCALE = 2, 3.0
ADV_IMPLS = ("dense", "pallas_packed", "coord_median", "trimmed_mean")
# the sweeps' seed axes cut for the script's time limit (PERF.md §4): the
# convergence sweep's 8 seeds to SWEEP_SEEDS, the adversary sweep's 2 to
# ADV_SWEEP_SEEDS; every point of the cut grids is checked as before
SWEEP_SEEDS, ADV_SWEEP_SEEDS = 2, 1
# the times phase's rounds/s per mixing_impl: one captured chunk of this
# many rounds (cut from ROUNDS for the script's time limit: PERF.md §4)
TIMES_RATE_ROUNDS = 20

# tolerances (max |kernel − plain|); see PERF.md for the reasons
TOL_GOSSIP = 1e-5        # θ' for O(1) operands; c' gets |s|× this
TOL_ROUND = 1e-6         # Δ, z' (the JAX package's own kernel tolerance)
TOL_ROUND_C = 4e-6       # c' (4× as in tests/test_fused_round.py)
TOL_SPARSE = 1e-6        # θ', c' × (1 + max|plain|), f32 and bf16 alike
TOL_STATE = 1e-4         # R-round states vs dense, × (1 + max|dense|)
TOL_SIGMA_C = 1e-5       # max_j |mean_i c_ij| × (1 + max|c|): Σ_i c_i = 0
# int8 against exact after 100 rounds, max|Δθ| / max|θ| (the JAX package's
# test_compressed_vs_exact_divergence_bounded)
TOL_COMPRESS_DIVERGENCE = 1e-3
TOL_ROBUST = 1e-6        # a robust aggregation vs its oracle, × (1 + max)
# dense under capture, × (1 + max|eager|), used only if it is not bit for
# bit: cuBLAS may pick another GEMM algorithm on the capture stream
TOL_GRAPH_DENSE = 1e-6
TOL_ATTN_F32 = 2e-5      # attention, f32 operands, × (1 + max|plain|)
TOL_ATTN_BF16 = 1e-2     # bf16 output: one bf16 ulp, × (1 + max|plain|)
TOL_SCAN = 1e-6          # RG-LRU scan, × (1 + max|plain|) (same step order)
TOL_SERVE = 3e-2         # bf16 logits and caches, × (1 + max|reference|)
# mamba2-1.3b's bf16 checks: its 48 layers amplify bf16 rounding (its own
# bf16 logits miss its f32 ones by about as much, ``plain_bf16_vs_f32``);
# the f32 checks below hold the kernels and caches at TOL_SERVE_F32
TOL_SERVE_BF16 = {"recurrentgemma-9b": TOL_SERVE, "mamba2-1.3b": 8e-2}
TOL_SERVE_F32 = 1e-4     # the same checks in f32 compute, × (1 + max)
TOL_SSD = 1e-5           # SSD scan y and final state, × (1 + max|plain|)
TOL_CE = 1e-5            # fused cross-entropy NLL, × (1 + max|plain|)
TOL_EVAL = 1e-3          # group losses, kernel vs plain route, × (1 + max)
TOL_TRAIN_F32 = 1e-4     # per-client gradients, kernels vs plain, f32 compute
# the same in bf16 (B5's accumulation order, B6's f32 logits: quirk 4), x and
# y apart, each × (1 + max|plain|): read 2.18e-3 to 2.38e-3 (x) and 3.14e-5
# to 3.25e-5 (y) at two random ȳ (PERF.md); B5's and B6's bf16 outputs at
# the train shapes are held at TOL_ATTN_BF16 and TOL_CE (``train_kernel_times``)
TOL_TRAIN_BF16_X = 1e-2
TOL_TRAIN_BF16_Y = 2e-4
# mamba2-1.3b's per-client gradients in bf16, kernels vs plain: B7 runs in
# f32 on both routes (3xTF32 against f32), so B6's f32 logits (quirk 4) make
# the difference, as in qwen2-0.5b's; stated before the first reading
TOL_TRAIN_SSM_BF16_X, TOL_TRAIN_SSM_BF16_Y = 1e-2, 2e-4
# granite-moe-1b-a400m's per-client gradients in bf16, kernels vs plain,
# stated before the first reading: B5's and B6's bf16 differences flip
# near-tie top-8 routings and, through the capacity slots of the tokens
# after them, the routings of many more (PERF.md §6: over half the tokens
# of a full-width prefill); a token sent to other experts moves the
# gradient by a step, not by rounding.  So the limits, qwen2-0.5b's, hold
# the kernel route against the plain route replaying its expert choices
# (``routing_replay``); the plain route's own routing is compared too,
# its flips counted and its error printed; in f32 it must route alike
TOL_TRAIN_MOE_BF16_X, TOL_TRAIN_MOE_BF16_Y = 1e-2, 2e-4
# B8's backward (``ref.rglru_bwd_ref``) against autograd through the plain
# recurrence, f32, × (1 + max): the same sums, maybe in another order
TOL_SCAN_BWD = 1e-5

# the serving path: recurrentgemma-9b at full width in bf16, 4 prompts of two
# windows (4096 tokens), 16 new tokens each
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN = "recurrentgemma-9b", 4, 4096, 16
LONG_S = 32768           # configs/shapes.py PREFILL_32K's length, batch 1
# the second served model: mamba2-1.3b at full width in bf16, 8 prompts of
# 4096 tokens, 16 new tokens each
MAMBA_ARCH, MAMBA_B, MAMBA_PROMPT, MAMBA_GEN = "mamba2-1.3b", 8, 4096, 16
# evaluation: group_metrics on mamba2-1.3b, one batch of 4 × 4096 tokens
# (train_4k's length) for each of 4 clients, 8 groups (the reference's
# make_data_model defaults)
EVAL_CLIENTS, EVAL_B, EVAL_S, EVAL_GROUPS = 4, 4, 4096, 8
# federated DRO training (the reference's train defaults): qwen2-0.5b at
# full width, n = 4 clients, K = 4, batch 4 × 128 tokens, 8 groups; the
# checkpoint resume at n = 2 (half the checkpoint written to disk)
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_N, TRAIN_K, TRAIN_B, TRAIN_S, TRAIN_G = 4, 4, 4, 128, 8
TRAIN_RESUME_N, TRAIN_ROUNDS = 2, 3
# the depth the train and mesh phases cut qwen2-0.5b to, so that the whole
# script keeps within its time limit (PERF.md §4 lists the cuts); its width
# and the paths it drives are the full model's
TRAIN_LAYERS = 2
# the rate turns of both train phases: an eager chunk, then a captured one
RATE_TURNS = (False, True)
# the decentralized mesh (phase mesh): the train phase's geometry over a
# world of MESH_WORLD ranks (2 clients a rank), held to the host path from
# the same seed at the train phase's bf16 limits, stated before the first
# reading: a rank's vmapped local steps batch 2 clients where the host
# path batches 4, so batched GEMMs may round otherwise
MESH_WORLD = 2
TOL_MESH_X, TOL_MESH_Y = TOL_TRAIN_BF16_X, TOL_TRAIN_BF16_Y
# every mesh run: qwen2-0.5b cut to MESH_LAYERS layers (cut from
# TRAIN_LAYERS to pay for the lowerings below: PERF.md §4), each round
# logged (a logged row all-reduces x̄ and c̄x: GBs through gloo on one
# card); dense (host and scan engines), fused_ring and the world of 1 run
# MESH_ROUNDS rounds, so that a local step reads the tracking correction
# and the scan chunk carries its state from one round to the next; each
# of MESH_LOWERINGS runs MESH_LOWERING_ROUNDS (its Σc and its state after
# the round's gossip hold it to the host path)
MESH_LAYERS = 2
# a client's weights over the mesh's fsdp and model axes (phase
# fsdp_mesh): a world of 8 ranks on the card as (clients 2, fsdp 2, model
# 2), qwen2-0.5b at full width cut to FSDP_MESH_LAYERS layers, n = 2, the
# train phase's K, batch and groups, FSDP_MESH_ROUNDS rounds of
# pallas_packed (a local step of the second reads the tracking
# correction), held to the host path from the same seed at the train
# phase's bf16 limits (TOL_MESH_X / TOL_MESH_Y), stated before the first
# reading
FSDP_MESH = (2, 2, 2)
FSDP_MESH_LAYERS = 2
FSDP_MESH_ROUNDS = 2
# the phase's runs in its one world, in order: (name, arch, layers — None
# for the reduced config —, rounds, compute dtype, moe_expert_parallel,
# replay — whether the ranks replay the host path's expert choices).
# qwen2-0.5b as above; mamba2-1.3b (B7 on a rank's 32 SSM heads, B6's
# partials on half its 50 280 tokens) and granite-moe-1b-a400m (its 32
# experts split over model, as the reference's smoke sets it; B5 on 8
# query and 4 KV heads, B6's partials on uneven pieces of 49 155) at full
# width cut to FSDP_MESH_LAYERS layers; recurrentgemma-9b's reduced config
# (B8 and its backward on a rank's LRU channels, B5 over the one KV head
# both model ranks hold): its untied 256 000 × 4096 embedding and head
# alone are 2.1 B parameters, ~34 GB of x and cx for two clients in f32,
# past one card shared by 8 ranks.  A run after the first starts from the
# host path's initial state and runs one round (its own init_state is the
# first run's check).  The limits against the host path, stated before the
# first reading (``fsdp_run_tols``): bf16 compute TOL_MESH_X (x, cx) and
# TOL_MESH_Y (y, cy); f32 compute TOL_TRAIN_F32 on every field — granite
# in f32 (its expert choices on its first batch against the host path's
# counted, and none may differ), and the reduced recurrentgemma-9b, whose
# bf16 round misses TOL_MESH_X on cx (2.67e-2) in a CPU rehearsal of this
# geometry.  granite runs again in bf16, the compute that training uses:
# there B5's and B6's bf16 roundings flip near-tie top-8 choices (~3 %,
# ROADMAP §C) and a token sent to other experts moves the state by a step,
# so its ranks replay the host path's expert choices of every MoE layer
# and local step (``routing_replay``, recorded by ``routing_recorder``),
# their own choices on the first batch against the host path's counted
# and printed; it runs last, so that the host path has recorded them by
# the time the ranks reach it
#
# The eighth field of a run: more MeshConfig fields.  Every run trains
# under MeshConfig's default remat=True (each unit checkpointed: B5, B7
# and B8 launch twice a layer and local step, B8's backward once) but
# qwen2-0.5b-no-remat, which starts from the first run's initial state
# drawn on the mesh in the same way and runs one round, held to that
# run's state after its first round bit for bit where the kernels are
# deterministic, else at TOL_MESH_X / TOL_MESH_Y with the reason printed
# (it has no host path of its own);
# qwen2-0.5b-replicated keeps every weight whole on each rank of the
# block (param_mode="replicated": the block data-parallel over the
# client's rows and positions, the whole-vocabulary B6, B1 on the whole
# client's row), at full width in bf16, held to its host path at
# TOL_MESH_X / TOL_MESH_Y.  It runs last, on a world of its own of 4
# ranks, (clients 2, fsdp 1, model 2) (a run's ninth field, "mesh"): each
# rank holds a whole client through the gossip's buffers (~9 GB), and the
# 8 ranks of (2, 2, 2) ran out of the card's 80 GB; model 2 keeps the
# sequence split over model that "batch_seq" runs, and the ranks start
# once the first world has ended and every host path has run
FSDP_NO_REMAT = {"remat": False, "compare_to": 0}
FSDP_REPLICATED_MESH = (2, 1, 2)
FSDP_MESH_RUNS = (
    ("qwen2-0.5b", TRAIN_ARCH, FSDP_MESH_LAYERS, FSDP_MESH_ROUNDS,
     "bfloat16", False, False, {}),
    ("qwen2-0.5b-no-remat", TRAIN_ARCH, FSDP_MESH_LAYERS, 1, "bfloat16",
     False, False, FSDP_NO_REMAT),
    ("mamba2-1.3b", "mamba2-1.3b", FSDP_MESH_LAYERS, 1, "bfloat16", False,
     False, {}),
    ("granite-moe-1b-a400m", "granite-moe-1b-a400m", FSDP_MESH_LAYERS, 1,
     "float32", True, False, {}),
    ("recurrentgemma-9b-reduced", "recurrentgemma-9b", None, 1, "float32",
     False, False, {}),
    ("granite-moe-1b-a400m-bf16", "granite-moe-1b-a400m", FSDP_MESH_LAYERS,
     1, "bfloat16", True, True, {}),
    ("qwen2-0.5b-replicated", TRAIN_ARCH, FSDP_MESH_LAYERS, FSDP_MESH_ROUNDS,
     "bfloat16", False, False, {"param_mode": "replicated",
                                "mesh": FSDP_REPLICATED_MESH}))
# remat's memory where it matters: qwen2-0.5b at full depth, n = 2, one
# eager round of the host path's DRO problem (what build_train_round runs
# at one rank a client) with remat off, then on; both peaks and the
# seconds a round printed, the two final states compared (bit for bit
# where the kernels are deterministic, else at TOL_MESH_X / TOL_MESH_Y)
REMAT_MEMORY_LAYERS, REMAT_MEMORY_N = 24, 2
# B6's vocab-parallel form (phase kernels) at a rank's shape on that mesh:
# a client's 4 × 128 tokens over fsdp 2, d_model, and the vocabulary over
# model 2; the merged NLL of the two pieces against the whole vocabulary's
# B6 at TOL_CE_MERGED·(1 + max), the partials against their plain version
# at TOL_CE
CE_PARTIALS_SHAPE = (TRAIN_B * TRAIN_S // 2, 896, 151936 // 2)
TOL_CE_MERGED = 1e-6
MESH_ROUNDS = 2
MESH_LOWERING_ROUNDS = 1
# a topology_cycle on the mesh (pallas_packed, B1 on a rank's rows of the
# round's W), twice its length in rounds through the scan engine, with
# --telemetry-out: held to the host path's rounds at TOL_MESH_X /
# TOL_MESH_Y and its stream's rows and health gauges to the host path's
# at TOL_MESH_X (mesh_telemetry_check)
MESH_CYCLE = ("ring", "exp")
MESH_CYCLE_ROUNDS = 2 * len(MESH_CYCLE)
# chunks of two rounds on both sides, eager (the mesh's chunks are), so
# that both streams carry two gauge sets; the host path's captured chunk
# of this round ran out of the card's 80 GB in its capture (76 GB
# allocated, a chunk of one round or of four; 26.6 GB eager)
MESH_CYCLE_CHUNK = 2
MESH_LOG_EVERY = 1
# the mesh's other lowerings on --engine host: (name, mixing_impl,
# gossip_compress)
MESH_LOWERINGS = (("sparse_packed", "sparse_packed", None),
                  ("pallas_packed+int8", "pallas_packed", "int8"),
                  ("sparse_trimmed_mean", "sparse_trimmed_mean", None))
# the gossip kernels whose launches the mesh's runs count by route
GOSSIP_KERNELS = ("fused_gossip", "sparse_gossip")
# the serving mesh (phase serve_mesh): qwen2-0.5b at full width (24 layers,
# bf16) serving SERVE_MESH_B prompts of SERVE_MESH_PROMPT tokens and
# SERVE_MESH_GEN new tokens over a world of SERVE_MESH_WORLD ranks at each
# (data, model) of SERVE_MESH_SHAPES, held to the single process at
# TOL_SERVE; the f32 prefill at SERVE_MESH_F32_LAYERS layers at
# TOL_SERVE_F32; each step's samples drawn from SERVE_MESH_SAMPLE_SEED
SERVE_MESH_ARCH, SERVE_MESH_WORLD = "qwen2-0.5b", 2
# (16 new tokens, cut from 32 for the script's time limit: PERF.md §4)
SERVE_MESH_B, SERVE_MESH_PROMPT, SERVE_MESH_GEN = 4, 4096, 16
SERVE_MESH_SHAPES = ((1, 2), (2, 1))
SERVE_MESH_F32_LAYERS, SERVE_MESH_SAMPLE_SEED = 2, 1
# the scan archs on the same world, at full width and (data 1, model 2):
# SERVE_SCAN[arch] = (rows, layers, f32 layers) of SERVE_SCAN_PROMPT tokens
# and SERVE_SCAN_GEN teacher-forced new tokens (8: a decode step makes
# ~100 small collectives over gloo; cut from 16 for the script's time
# limit, PERF.md §4), held to the single process at
# the arch's TOL_SERVE_BF16 (mamba2-1.3b's 48 layers amplify bf16 rounding:
# PERF.md §2); mamba2-1.3b at 24 of its 48 layers (cut from 48 for the
# script's time limit, PERF.md §4; B7 at (2, 4096, 32, 64, 128) a rank),
# recurrentgemma-9b at its 38 (B8 at (1, 4096, 2048), B5 at
# 8 query heads over the one KV head both ranks hold); the f32 prefill
# at 2 layers, recurrentgemma-9b's at 3 (one whole 2:1 unit, so its
# replicated KV head is held in f32 too)
SERVE_SCAN_SHAPE = (1, 2)
SERVE_SCAN = {"mamba2-1.3b": (2, 24, 2), "recurrentgemma-9b": (1, 38, 3)}
SERVE_SCAN_PROMPT, SERVE_SCAN_GEN = 4096, 8
# federated DRO training of the other block kinds: mamba2-1.3b at full
# width through B7 and B6, at the reference's train defaults but n = 2 (its
# state at n = 4 does not leave the working set room on the card: PERF.md
# §4): the gradient checks cut to SSM_LAYERS_GRADS layers, the eager host
# loop to SSM_LAYERS_EAGER and the captured chunks (held bit for bit to
# eager ones) to SSM_LAYERS_CAPTURED (at most 48, 40 and 24, the depths
# whose peaks fit the card; cut below them for the script's time limit:
# PERF.md §4, §5)
SSM_TRAIN_ARCH, SSM_TRAIN_N = "mamba2-1.3b", 2
SSM_LAYERS_GRADS, SSM_LAYERS_EAGER, SSM_LAYERS_CAPTURED = 4, 4, 4
# recurrentgemma-9b's state does not fit the card even at n = 1: its reduced
# config trains here, and B8 is held at a full-width layer's (n·B, S, W)
RG_TRAIN_ARCH = "recurrentgemma-9b"
RG_SCAN_TRAIN_SHAPE = (SSM_TRAIN_N * TRAIN_B, TRAIN_S, 4096)
# the MoE block (phase moe): granite-moe-1b-a400m at full width (24 layers,
# d_model 1024, 32 experts top 8, V = 49 155, tied), served as a prefill
# server on 4 prompts of its 4096-token context, decoded MOE_DECODE_STEPS
# steps from position 0 against its full forward without capacity drops
# (capacity factor MOE_DROPLESS_FACTOR, as tests/test_decode_consistency.py
# holds the reference), evaluated as the evaluate phase evaluates mamba2,
# and trained at the reference's train defaults but n = MOE_TRAIN_N (its
# f32 state is 21.4 GB at n = 2, and n = 4's 43 GB leave the working set no
# room): the gradient checks at MOE_LAYERS_GRADS layers, the captured
# chunks (held bit for bit to the host loop) and the rate turns at
# MOE_LAYERS_CAPTURED (cut for the script's time limit: PERF.md §4)
MOE_ARCH, MOE_TRAIN_N = "granite-moe-1b-a400m", 2
MOE_SERVE_B, MOE_SERVE_PROMPT, MOE_DECODE_STEPS = 4, 4096, 16
MOE_DROPLESS_FACTOR = 8.0
MOE_LAYERS_GRADS, MOE_LAYERS_CAPTURED = 4, 2
# the modality frontends (phase frontends): musicgen-medium at full width
# (4 codebooks of V = 2048, untied), 4 prompts of 1500 frames (30 s at
# EnCodec's 50 Hz), evaluated on 4 clients × 4 × 1500 frames, its gradient
# checks cut to MUSIC_LAYERS_GRADS of its 48 layers (n = 2: its 29.4 GB of
# state leave a full-depth working set no room; cut further for the
# script's time limit, PERF.md §4); internvl2-76b's prefix
# path at full width cut to VLM_LAYERS layers (76 B parameters fit no
# card), VLM_B prompts of 256 prefix embeddings and VLM_PROMPT tokens
MUSIC_ARCH, MUSIC_B, MUSIC_FRAMES, MUSIC_LAYERS_GRADS = (
    "musicgen-medium", 4, 1500, 12)
VLM_ARCH, VLM_LAYERS, VLM_B, VLM_PROMPT = "internvl2-76b", 2, 2, 2048
# continuous batching (phase scheduler): each model at full width behind
# serving.ServingEngine, SCHED_CASES' slots, cache length, requests, prompt
# lengths and new tokens (inclusive ranges) drawn from SCHED_SEED, the
# temperatures SCHED_TEMPS in turn, eagerly and through the captured tick;
# then SCHED_F32's requests in f32 compute, 4 slots so that slots are
# reused.  Cut for the phase's 150 s (PERF.md §6): eager ticks are
# host-bound at 48–102 ms, so qwen2-0.5b serves 17 requests on 16 slots
# and the others 9 on 8, with short prompts and few new tokens (cut for
# the script's time limit: PERF.md §4; every model admits a request into
# a reused slot), and the f32 requests are short and captured (a MoE
# model's run eagerly)
SCHED_SEED, SCHED_TEMPS = 0, (1.0, 0.7)
SCHED_CASES = (
    ("qwen2-0.5b", dict(slots=16, max_len=1024, requests=17,
                        prompt=(32, 128), new=(16, 32))),
    ("granite-moe-1b-a400m", dict(slots=8, max_len=512, requests=9,
                                  prompt=(16, 32), new=(8, 16))),
    ("musicgen-medium", dict(slots=8, max_len=512, requests=9,
                             prompt=(16, 32), new=(8, 16))),
    ("mamba2-1.3b", dict(slots=8, max_len=512, requests=9,
                         prompt=(16, 32), new=(8, 16))),
)
SCHED_F32 = dict(slots=4, max_len=160, requests=8, prompt=(8, 32),
                 new=(4, 16))
# each two-route kernel's first-port route (the others': "cuda_core")
OLD_ROUTE = {"fused_round": "block", "fused_gossip": "tiled",
             "sparse_gossip": "row_block", "rglru_scan": "walk"}
# the serve and churn paths launch no kernel of the other's
NO_MODEL_KERNELS = {"flash_attention": 0, "rglru_scan": 0, "ssd_scan": 0,
                    "fused_cross_entropy": 0, "ce_partials": 0}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since
    the script started (the time limit's account)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def graph_ms(fn, *, reps: int = 21, inner: int = 100) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph,
    replayed ``reps`` times, median of CUDA-event times (no host launch
    gaps between the calls)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, reps=reps) / inner


def cuda_ms(fn, *, reps: int = 21, inner: int = 1, warmup: int = 3) -> float:
    """Median over ``reps`` of the per-call time of ``inner`` back-to-back
    calls, from CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def gossip_bound_ms(n: int, d: int):
    byts = 4 * (n * n + 5 * n * d)
    flops = 4 * n * n * d + 6 * n * d
    return _bound(byts, flops)


def round_bound_ms(n: int, dz: int, k: int):
    byts = 4 * (n * n + n * dz * dz + k * n * dz + 7 * n * dz + 3 * n * dz)
    flops = k * (2 * n * dz * dz + 4 * n * dz) + 4 * n * n * dz + 6 * n * dz
    return _bound(byts, flops)


def sparse_bound_ms(n: int, d: int, m: int):
    byts = 4 * (5 * n * d + n * (2 * m + 1))
    flops = 4 * n * (m + 1) * d + 4 * n * d
    return _bound(byts, flops)


def gossip_rows_bound_ms(n: int, n_out: int, d: int):
    """B1's row block: W's n_out rows, Δ and θ of all n rows and c read
    once, θ' and c' of the n_out rows written once."""
    byts = 4 * (n_out * n + 2 * n * d + 3 * n_out * d)
    flops = 4 * n_out * n * d + 6 * n_out * d
    return _bound(byts, flops)


def sparse_rows_bound_ms(n_out: int, n_src: int, d: int, m: int):
    """B4's row block: the n_out rows' table, Δ and θ of the n_src
    sources and c read once, θ' and c' of the n_out rows written once."""
    byts = 4 * (2 * n_src * d + 3 * n_out * d + n_out * (2 * m + 1))
    flops = 4 * n_out * (m + 1) * d + 4 * n_out * d
    return _bound(byts, flops)


def _bound(byts, flops, flop_s=F32_FLOP_S):
    t_b, t_f = byts / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def gossip_operands(n, d, gen, dev):
    import torch

    w = torch.rand((n, n), generator=gen, device=dev)
    w = w / w.sum(1, keepdim=True)
    delta, theta, c = (torch.randn((n, d), generator=gen, device=dev)
                       for _ in range(3))
    return w, delta, theta, c


def bitwise_equal(a, b) -> bool:
    """a and b bit for bit, NaNs included (the NaN contract's rows)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def mesh_packed_dims() -> tuple:
    """(dx, dy) a client in the mesh phase's run: qwen2-0.5b's parameters
    at MESH_LAYERS layers, packed, and its TRAIN_G group weights."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.models import model as model_lib

    with arch_depth(TRAIN_ARCH, MESH_LAYERS) as cfg:
        leaves = tree_lib.leaves(model_lib.param_dict(
            model_lib.skeleton(cfg)))
    return sum(t.numel() for t in leaves), TRAIN_G


def check_gossip(gen, dev):
    """B1 against its plain version over (n, D) from one client to the
    churn path's 512, the main path's shapes and the churn path's masked
    W, f32 and bf16, on both routes: each call takes the route
    ``gossip.route`` gives it (unrolled for n ≤ 8, tiled past it), and
    every unrolled call is repeated on the tiled route and must equal it
    bit for bit.  The main path's pair call (x and y in one launch) is
    held against two plain single calls and, bitwise, against the tiled
    route's two launches.  The decentralized mesh's row blocks: each
    rank's rows of W at the main path's shapes and at the mesh phase's
    own and at each fsdp_mesh rank's (one row of W at n = 2 over its
    piece of the packed state), against the plain version at the block's
    row0 and bit for bit the whole pair's rows.  Returns the largest
    error, the cases by route and the row-block cases by shape."""
    import torch

    from repro_torch.kernels import gossip, ref

    from repro_torch.core import sparse_topology as sp_lib

    worst = 0.0
    by_route = dict.fromkeys(gossip.ROUTES, 0)
    bitwise = 0
    shapes = [(n, d) for n in (1, 6, 8, 64, 512) for d in (1, 300, 4097)]
    # the main path's shapes, and the churn path's at the dense limit
    shapes += [(N, DX), (N, DY), (CHURN_DENSE_N, DX), (CHURN_DENSE_N, DY)]
    eta_s, corr = 0.5, 12.5

    def held(got, want, scales, what):
        """θ' within TOL_GOSSIP, c' within |s|·TOL_GOSSIP."""
        err = 0.0
        for (kt, kc), (pt, pc), s in zip(got, want, scales):
            et, ec = max_err(kt, pt), max_err(kc, pc)
            if et > TOL_GOSSIP or ec > TOL_GOSSIP * abs(s):
                fail(f"fused_gossip {what}: θ err {et}, c err {ec}")
            err = max(err, et, ec / abs(s))
        return err

    for n, d in shapes:
        args = gossip_operands(n, d, gen, dev)
        ws = [("random", args[0])]
        if n == CHURN_DENSE_N and d in (DX, DY):
            # the churn path's W: each family's draw under a mask
            ws += [(label, sp_lib.densify(sp))
                   for label, sp, _ in churn_topologies(n, gen, dev)]
        rt = gossip.route(n)
        for label, w in ws:
            for gd in (None, "bfloat16"):
                plain = ref.fused_gossip_ref(w, *args[1:], eta_s, corr,
                                             gossip_dtype=gd)
                outs = {}
                for want in dict.fromkeys((rt, "tiled")):
                    force = None if want == rt else want
                    outs[want] = routed_call(
                        lambda: gossip.fused_gossip_nd(
                            w, *args[1:], eta_s, corr, gossip_dtype=gd,
                            force_route=force),
                        "fused_gossip", want)
                    worst = max(worst, held(
                        [outs[want]], [plain], [corr],
                        f"n={n} D={d} W={label} {gd} {want}"))
                    by_route[want] += 1
                if rt != "tiled":
                    if not all(map(bitwise_equal, outs[rt], outs["tiled"])):
                        fail(f"fused_gossip n={n} D={d} W={label} {gd}: the "
                             f"{rt} route differs from the tiled route")
                    bitwise += 1
    # the pair, as the main path calls it: x and y of one round
    w, dxv, txv, cxv = gossip_operands(N, DX, gen, dev)
    _, dyv, tyv, cyv = gossip_operands(N, DY, gen, dev)
    x, y = (dxv, txv, cxv, eta_s, corr), (dyv, tyv, cyv, 1.0, -3.0)
    pairs = 0
    for gd in (None, "bfloat16"):
        before = gossip.fused_gossip_nd.launches
        got = routed_call(lambda: gossip.fused_gossip_pair_nd(
            w, x, y, gossip_dtype=gd), "fused_gossip", gossip.route(N))
        if gossip.fused_gossip_nd.launches - before != 1:
            fail("fused_gossip pair: not one launch")
        plain = (ref.fused_gossip_ref(w, *x, gossip_dtype=gd),
                 ref.fused_gossip_ref(w, *y, gossip_dtype=gd))
        worst = max(worst, held([got[:2], got[2:]], plain, [corr, -3.0],
                                f"pair {gd}"))
        old = gossip.fused_gossip_pair_nd(w, x, y, gossip_dtype=gd,
                                          force_route="tiled")
        if not all(map(bitwise_equal, got, old)):
            fail(f"fused_gossip pair {gd}: differs from the tiled route")
        pairs += 1
    def row_blocks(w, x, y, ranks):
        """Each of ``ranks`` ranks' rows of W over the gathered Δ and θ of
        all n rows, x and y in one call, on both routes, bit for bit the
        whole pair's rows on the same route and against the plain version
        at the block's row0; returns the cases."""
        nonlocal worst
        n = w.shape[0]
        k, cases = n // ranks, 0
        for gd in (None, "bfloat16"):
            for rt in gossip.ROUTES:
                force = None if rt == gossip.route(n) else rt
                whole = gossip.fused_gossip_pair_nd(
                    w, x, y, gossip_dtype=gd, force_route=force)
                for lo in range(0, n, k):
                    rows = slice(lo, lo + k)
                    wr = w[rows].contiguous()
                    xr = (*x[:2], x[2][rows].contiguous(), *x[3:])
                    yr = (*y[:2], y[2][rows].contiguous(), *y[3:])
                    got = routed_call(
                        lambda: gossip.fused_gossip_pair_nd(
                            wr, xr, yr, gossip_dtype=gd, row0=lo,
                            force_route=force),
                        "fused_gossip", rt)
                    what = (f"rows [{lo}, {lo + k}) of n={n} "
                            f"D={x[0].shape[1]} {gd} {rt}")
                    if not all(bitwise_equal(a, b[rows])
                               for a, b in zip(got, whole)):
                        fail(f"fused_gossip {what}: differs from the whole "
                             "epilogue's rows")
                    plain = (ref.fused_gossip_ref(wr, *xr, gossip_dtype=gd,
                                                  row0=lo),
                             ref.fused_gossip_ref(wr, *yr, gossip_dtype=gd,
                                                  row0=lo))
                    worst = max(worst, held([got[:2], got[2:]], plain,
                                            [x[4], y[4]], what))
                    by_route[rt] += 1
                    cases += 1
                    del got, plain, xr, yr
                del whole
        return cases

    # the mesh's row blocks: each of B1_ROW_RANKS ranks' rows at the main
    # path's shapes, then each of MESH_WORLD ranks' rows at the mesh
    # phase's own (n = TRAIN_N, the packed qwen2-0.5b at MESH_LAYERS
    # layers and its group weights), as its pallas_packed run launches B1
    k = N // B1_ROW_RANKS
    row_cases = row_blocks(w, x, y, B1_ROW_RANKS)
    del w, x, y, dxv, txv, cxv, dyv, tyv, cyv
    mdx, mdy = mesh_packed_dims()
    w, dxv, txv, cxv = gossip_operands(TRAIN_N, mdx, gen, dev)
    _, dyv, tyv, cyv = gossip_operands(TRAIN_N, mdy, gen, dev)
    mesh_cases = row_blocks(w, (dxv, txv, cxv, eta_s, corr),
                            (dyv, tyv, cyv, 1.0, -3.0), MESH_WORLD)
    del w, dxv, txv, cxv, dyv, tyv, cyv
    # each fsdp_mesh rank's one row of W (n = 2 clients, one a rank of its
    # clients axis) over its piece of the packed qwen2-0.5b at
    # FSDP_MESH_LAYERS layers and the group weights, as its pallas_packed
    # round and the phase's host path launch B1
    nf = FSDP_MESH[0]
    with arch_depth(TRAIN_ARCH, FSDP_MESH_LAYERS) as cfg:
        fdx, fdy = fsdp_packed_dims(cfg)
    w, dxv, txv, cxv = gossip_operands(nf, fdx, gen, dev)
    _, dyv, tyv, cyv = gossip_operands(nf, fdy, gen, dev)
    fsdp_cases = row_blocks(w, (dxv, txv, cxv, eta_s, corr),
                            (dyv, tyv, cyv, 1.0, -3.0), nf)
    del w, dxv, txv, cxv, dyv, tyv, cyv
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "fused_gossip",
          "cases": sum(by_route.values()), "cases_by_route": by_route,
          "bitwise_equal_to_tiled": bitwise, "pair_cases": pairs,
          "row_block_cases": row_cases,
          "row_block_shape": {"n": N, "rows_a_rank": k, "D": [DX, DY]},
          "mesh_rank_cases": mesh_cases,
          "mesh_rank_shape": {"n": TRAIN_N, "rows_a_rank": TRAIN_N
                              // MESH_WORLD, "D": [mdx, mdy]},
          "fsdp_mesh_rank_cases": fsdp_cases,
          "fsdp_mesh_rank_shape": {"n": nf, "rows_a_rank": 1,
                                   "D": [fdx, fdy]},
          "max_abs_err_theta_or_c_over_s": worst, "tol": TOL_GOSSIP})
    return worst, by_route, {"main": row_cases, "mesh": mesh_cases,
                             "fsdp_mesh": fsdp_cases}


def round_operands(n, dz, k, gen, dev, *, corr_zero=False, mask_rows=None,
                   w=None):
    """The JAX package's kernel-test operands (tests/test_fused_round.py);
    ``w`` defaults to the ring's."""
    import torch

    from repro_torch.core.topology import mixing_matrix

    def rn(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    if w is None:
        w = torch.as_tensor(mixing_matrix("ring", n), dtype=torch.float32,
                            device=dev)
    z0, c, ef = rn(n, dz, scale=0.3), rn(n, dz, scale=0.1), rn(n, dz,
                                                               scale=0.01)
    g = rn(n, dz, dz, scale=0.1 / dz)
    h = rn(k, n, dz, scale=0.05)
    mask = torch.ones((n, dz), device=dev)
    if mask_rows is not None:
        mask[mask_rows] = 0.0
    step = 0.05 * mask
    etas = torch.full((n, dz), 0.5, device=dev)
    corr = (torch.zeros((n, dz), device=dev) if corr_zero
            else rn(dz, scale=0.3).expand(n, dz).contiguous())
    return w, z0, c, ef, g, h, step, etas, corr, mask


def check_round(gen, dev):
    """B2 against its plain version over the JAX package's kernel-test
    shape, the main path's and the quickstart's round geometries and the
    churn path's, on both routes: each call takes the route
    ``fused_round.route`` gives it (the cluster route at every one of these
    shapes), and each is repeated on the block route.  Returns the largest
    absolute error and the cases by route."""
    import torch

    from repro_torch.core.mixing import gossip_torch_dtype, narrow
    from repro_torch.kernels import fused_round, quantize, ref

    from repro_torch.core import sparse_topology as sp_lib

    worst = full_q = full_flip = 0.0
    flips = same_bits = 0
    by_route = {r: 0 for r in fused_round.ROUTES}
    # (6, 150, 3): the JAX package's kernel-test shape; then the main
    # path's and the quickstart's round geometries, and the churn path's
    # at the dense limit, with each family's masked W and that mask
    churn = [(label, dict(w=sp_lib.densify(sp),
                          mask_rows=(~mask).nonzero().flatten()))
             for label, sp, mask in churn_topologies(CHURN_DENSE_N, gen,
                                                      dev)]
    for (n, dz, k) in ((6, 150, 3), (N, DX + DY, K), (N, 10 + 5, K),
                       (CHURN_DENSE_N, DX + DY, K)):
        rt = fused_round.route(dz)
        if rt != "cluster":
            fail(f"fused_round: dz = {dz} takes the {rt} route")
        variants = ([("ring", dict()), ("ring, corr 0", dict(corr_zero=True)),
                     ("ring, rows 1 3 out", dict(mask_rows=[1, 3]))]
                    if n != CHURN_DENSE_N else churn)
        for var, kw in variants:
            args = round_operands(n, dz, k, gen, dev, **kw)
            w, z0, c, ef, g, h, step, etas, corr, mask = args
            act = mask > 0
            for compress in (None, "bf16", "int8"):
                # local steps against the plain K steps
                _, _, pd = ref.local_steps_ref(z0, c, ef, g, h, step, mask,
                                               compress=compress)
                for gd in (None, "bfloat16"):
                    fz, fc, fe = ref.fused_round_ref(
                        *args, compress=compress, gossip_dtype=gd)
                    wire = {}
                    for want_route in (rt, "block"):
                        force = None if want_route == rt else want_route
                        kz, kc, ke, kq = routed_call(
                            lambda: fused_round.fused_round_wire(
                                *args, compress=compress, gossip_dtype=gd,
                                force_route=force),
                            "fused_round", want_route)
                        wire[want_route] = (kq, ke)
                        what = (f"fused_round {n},{dz},{k} {var} {compress} "
                                f"{gd} {want_route}")
                        # q is Δ without compression, and q + e' is
                        # v = mask ⊙ (Δ + e) with it
                        if compress is None:
                            errs = {"delta": max_err(kq, pd)}
                            if not torch.equal(ke, ef):
                                fail(f"{what}: e' != e without compression")
                        else:
                            v = torch.where(act, kq + ke,
                                            torch.zeros_like(kq))
                            errs = {"v": max_err(v, mask * (pd + ef))}
                            # the wire, bit for bit: the quantizer applied
                            # to the kernel's v gives its q, e' is v − q
                            # exactly, and inactive rows keep their e
                            pq = quantize.quantize_dequant(v, compress)
                            pe = torch.where(act, v - pq, ef)
                            if not (torch.equal(kq, pq)
                                    and torch.equal(ke, pe)):
                                fail(f"{what}: kernel q/e' differ from the "
                                     f"quantizer")
                        # the epilogue on the kernel's q
                        gdt = gossip_torch_dtype(gd)
                        wg = narrow(w, gdt)
                        wq = wg @ narrow(kq, gdt)
                        pz = wg @ narrow(z0, gdt) + etas * wq
                        pc = c + corr * (kq - wq)
                        errs["z"] = max_err(kz, pz)
                        errs["c"] = max_err(kc, pc)
                        # and the whole round against the plain whole round
                        # (informational under compression, where a ulp of
                        # Δ can move a value across a rounding boundary of
                        # Q).  A bf16 gossip rounds Δ too: there, the
                        # entries of z' and c' that mix a Δ entry whose
                        # kernel and plain values round to different bf16
                        # values are informational, and every other entry
                        # is checked
                        full = max(max_err(kz, fz), max_err(kc, fc),
                                   max_err(ke, fe))
                        full_kept = full
                        if compress is None and gd is not None:
                            flip = narrow(kq, gdt) != narrow(pd, gdt)
                            kept = ((w != 0).float() @ flip.float()) == 0
                            full_kept = max(max_err(kz[kept], fz[kept]),
                                            max_err(kc[kept], fc[kept]),
                                            max_err(ke, fe))
                            flips += int(flip.sum())
                            full_flip = max(full_flip, full)
                        if (max(errs.get("delta", 0.0), errs.get("v", 0.0),
                                errs["z"]) > TOL_ROUND
                                or errs["c"] > TOL_ROUND_C
                                or (compress is None
                                    and full_kept > TOL_ROUND_C)):
                            fail(f"{what}: {errs}, whole round {full_kept}")
                        worst = max(worst, *errs.values(),
                                    full_kept if compress is None else 0.0)
                        if compress is not None:
                            full_q = max(full_q, full)
                        by_route[want_route] += 1
                    same_bits += all(torch.equal(x, y) for x, y in
                                     zip(wire[rt], wire["block"]))
    emit({"phase": "kernels", "kernel": "fused_round",
          "cases": sum(by_route.values()), "cases_by_route": by_route,
          "max_abs_err": worst, "tol": [TOL_ROUND, TOL_ROUND_C],
          "whole_round_err_compressed": full_q,
          "bf16_gossip_delta_flips": flips,
          "whole_round_err_bf16_gossip_all_entries": full_flip,
          "wire_bitwise_equal_across_routes": same_bits,
          "bitwise": "e' == e (no compression); with v = q + e': "
                     "q == Q(v), e' == v - q"})
    return worst, by_route


def churn_topologies(n, gen, dev):
    """(label, SparseTopology on dev, mask) at n clients: one draw of each
    churn family on the exp support, under a participation mask — the W
    the churn paths mix with."""
    from repro_torch.core import sparse_topology as sp_lib
    from repro_torch.core import stochastic_topology as st_lib

    exp = sp_lib.sparse_exp(n)
    out = []
    for family in st_lib.TOPOLOGY_FAMILIES:
        w_fn = sp_lib.make_sparse_w_sampler(family, exp, seed=n,
                                            edge_prob=0.5, device=dev)
        mask = st_lib.bernoulli_mask(gen, n, PARTICIPATION)
        out.append((f"{family}+mask", sp_lib.sparse_masked_w(w_fn(1), mask),
                    mask))
    return out


def sparse_topologies(n, gen, dev):
    """(label, SparseTopology on dev) at n clients: ring, torus (square n),
    exp, hierarchical, one draw of each churn family on the exp support,
    and each such draw under a participation mask."""
    from repro_torch.core import sparse_topology as sp_lib
    from repro_torch.core import stochastic_topology as st_lib

    exp = sp_lib.sparse_exp(n)
    out = [("ring", sp_lib.sparse_ring(n)), ("exp", exp)]
    if round(n ** 0.5) ** 2 == n:
        out.append(("torus", sp_lib.sparse_torus(n)))
    cluster = next(c for c in (16, 8, 4, 3, 2, 1) if n % c == 0)
    out.append(("hierarchical", sp_lib.sparse_hierarchical(n, cluster)))
    out = [(label, sp.to(dev)) for label, sp in out]
    for family in st_lib.TOPOLOGY_FAMILIES:
        w_fn = sp_lib.make_sparse_w_sampler(family, exp, seed=n,
                                            edge_prob=0.5, device=dev)
        out.append((family, w_fn(1)))
    out += [(label, sp) for label, sp, _ in churn_topologies(n, gen, dev)]
    return out


def gather_wavefronts(neighbor_idx, bf16: bool) -> float:
    """Shared-memory wavefronts of the stripe route's gathers on this table
    over the conflict-free count (1.0: none).  A warp holds 32 consecutive
    rows, one a lane; each slot's gather is one 16-byte (f32) or 8-byte
    (bf16) read a lane, served 8 (16) lanes a wavefront, and lanes whose
    rows fall in one bank group (j mod 8, or mod 16) and differ take one
    wavefront each.  Counted from the table, not timed."""
    import torch

    lanes = 16 if bf16 else 8
    idx = neighbor_idx.to("cpu", torch.int64)
    n, m = idx.shape
    n_full = n // lanes * lanes
    j = idx[:n_full].reshape(-1, lanes, m)            # (phases, lanes, m)
    same = j[:, :, None, :] == j[:, None, :, :]       # lane a, earlier b
    earlier = torch.ones(lanes, lanes, dtype=torch.bool).tril(-1)
    dup = (same & earlier[None, :, :, None]).any(2)   # (phases, lanes, m)
    onehot = torch.nn.functional.one_hot(j % lanes, lanes)
    per_group = (onehot * (~dup)[..., None]).sum(1)   # (phases, m, groups)
    waves = per_group.max(-1).values
    return float(waves.sum()) / float(waves.numel())


def check_sparse_gossip(gen, dev):
    """B4 against its plain version over every topology kind and churn
    draw, n from 1 to 4096, f32 and bf16, on both routes: each call takes
    the route ``neighbor_gossip.route`` gives it (the stripe route at every
    one of these shapes), and every stripe call is repeated on the
    row-block route and must equal it bit for bit.  The scale path's pair
    (x and y in one launch) is held against two plain single calls and the
    row-block route; an index outside [0, n) must turn its
    row, and only its row, to NaN on both routes.  Also counts the stripe
    gathers' bank conflicts on the scale path's tables.  Returns the
    largest absolute error and the cases by route."""
    import torch

    from repro_torch.core import sparse_topology as sp_lib
    from repro_torch.dist import collectives
    from repro_torch.kernels import neighbor_gossip, ref

    worst = {}
    worst_abs = 0.0
    by_route = dict.fromkeys(neighbor_gossip.ROUTES, 0)
    bitwise = 0
    eta_s, corr = 0.5, 12.5          # the path's η_s and 1/(K·η_cx)
    grid = {n: [1, 128, 300, 4097] for n in SPARSE_CHECK_NS + (SCALE_N,)}
    # the paths' own shapes: the scale path's x at n = 4096, and the churn
    # path's x and y at the dense limit
    grid[SCALE_N].append(DX)
    grid[CHURN_DENSE_N] = [DX, DY]

    def held(got, want, what, key):
        nonlocal worst_abs
        for (kt, kc), (pt, pc) in zip(got, want):
            at, ac = max_err(kt, pt), max_err(kc, pc)
            et = at / (1.0 + float(pt.abs().max()))
            ec = ac / (1.0 + float(pc.abs().max()))
            worst_abs = max(worst_abs, at, ac)
            if not (et <= TOL_SPARSE and ec <= TOL_SPARSE):
                fail(f"sparse_gossip {what}: θ err {et}, c err {ec} "
                     f"(× (1 + max|ref|))")
            worst[key] = max(worst.get(key, 0.0), et, ec)

    for n, ds in grid.items():
        tops = sparse_topologies(n, gen, dev)
        for d in ds:
            delta, theta, c = (torch_randn(gen, dev, n, d) for _ in range(3))
            for label, sp in tops:
                tab = (sp.neighbor_idx, sp.neighbor_w.contiguous(),
                       sp.self_w.contiguous())
                for gd in (None, "bfloat16"):
                    rt = neighbor_gossip.route(n, tab[0].shape[1],
                                               gd is not None)
                    if rt != "stripe":
                        fail(f"sparse_gossip n={n} {label}: route {rt}")
                    plain = ref.sparse_gossip_ref(*tab, delta, theta, c,
                                                  eta_s, corr,
                                                  gossip_dtype=gd)
                    outs = {}
                    for want in (rt, "row_block"):
                        force = None if want == rt else want
                        outs[want] = routed_call(
                            lambda: neighbor_gossip.sparse_gossip_nd(
                                *tab, delta, theta, c, eta_s, corr,
                                gossip_dtype=gd, force_route=force),
                            "sparse_gossip", want)
                        held([outs[want]], [plain],
                             f"n={n} D={d} {label} {gd} {want}",
                             f"{label}/{gd or 'float32'}")
                        by_route[want] += 1
                    if not all(map(bitwise_equal, outs[rt],
                                   outs["row_block"])):
                        fail(f"sparse_gossip n={n} D={d} {label} {gd}: the "
                             f"stripe route differs from the row-block "
                             f"route")
                    bitwise += 1
            del delta, theta, c

    # the scale path's pair, on the exp table and one churn draw
    n = SCALE_N
    exp = [(label, sp) for label, sp in sparse_topologies(n, gen, dev)
           if label in ("exp", "erdos_renyi+mask")]
    x = (*(torch_randn(gen, dev, n, DX) for _ in range(3)), eta_s, corr)
    y = (*(torch_randn(gen, dev, n, DY) for _ in range(3)), 1.0, -3.0)
    pairs = 0
    for label, sp in exp:
        tab = (sp.neighbor_idx, sp.neighbor_w.contiguous(),
               sp.self_w.contiguous())
        for gd in (None, "bfloat16"):
            plain = (ref.sparse_gossip_ref(*tab, *x, gossip_dtype=gd),
                     ref.sparse_gossip_ref(*tab, *y, gossip_dtype=gd))
            old = neighbor_gossip.sparse_gossip_pair_nd(
                *tab, x, y, gossip_dtype=gd, force_route="row_block")
            before = neighbor_gossip.sparse_gossip_nd.launches
            got = routed_call(
                lambda: neighbor_gossip.sparse_gossip_pair_nd(
                    *tab, x, y, gossip_dtype=gd),
                "sparse_gossip", "stripe")
            if neighbor_gossip.sparse_gossip_nd.launches - before != 1:
                fail("sparse_gossip pair: not one launch")
            what = f"pair {label} {gd}"
            held([got[:2], got[2:]], plain, what, f"pair/{gd or 'float32'}")
            if not all(map(bitwise_equal, got, old)):
                fail(f"sparse_gossip {what}: differs from the row-block "
                     f"route")
            pairs += 1

    def row_blocks(sp, x, y, ranks, label):
        """Each of ``ranks`` ranks' rows of ``sp``'s lists, remapped onto
        its own rows and its halo (its HaloPlan), over those n_src
        sources, x and y in one call, on the route the rule gives n_src
        and on the row-block route, bit for bit the whole pair's rows on
        the same route and against the plain version; returns the cases
        and each rank's halo rows."""
        n = sp.n
        k, cases, halos = n // ranks, 0, []
        tab_n = (sp.neighbor_idx, sp.neighbor_w.contiguous(),
                 sp.self_w.contiguous())
        for r in range(ranks):
            plan = collectives.halo_plan(sp, collectives.ClientsAxis(
                n=n, rank=r, size=ranks), dev)
            halos.append(plan.n_halo)
            rows, src = slice(r * k, (r + 1) * k), plan.cols
            tab = (plan.table.neighbor_idx, plan.table.neighbor_w,
                   plan.table.self_w)
            xr = (x[0][src], x[1][src], x[2][rows].contiguous(), *x[3:])
            yr = (y[0][src], y[1][src], y[2][rows].contiguous(), *y[3:])
            for gd in (None, "bfloat16"):
                rt_rule = neighbor_gossip.route(len(src), tab[0].shape[1],
                                                gd is not None)
                rt_whole = neighbor_gossip.route(n, tab_n[0].shape[1],
                                                 gd is not None)
                for rt in dict.fromkeys((rt_rule, "row_block")):
                    whole = neighbor_gossip.sparse_gossip_pair_nd(
                        *tab_n, x, y, gossip_dtype=gd,
                        force_route=None if rt == rt_whole else rt)
                    got = routed_call(
                        lambda: neighbor_gossip.sparse_gossip_pair_nd(
                            *tab, xr, yr, gossip_dtype=gd,
                            force_route=None if rt == rt_rule else rt),
                        "sparse_gossip", rt)
                    what = (f"{label} rows [{r * k}, {(r + 1) * k}) of "
                            f"n={n} over {len(src)} sources, "
                            f"D={x[0].shape[1]} {gd} {rt}")
                    if not all(bitwise_equal(a, b[rows])
                               for a, b in zip(got, whole)):
                        fail(f"sparse_gossip {what}: differs from the "
                             "whole call's rows")
                    del whole
                    plain = (ref.sparse_gossip_ref(*tab, *xr,
                                                   gossip_dtype=gd),
                             ref.sparse_gossip_ref(*tab, *yr,
                                                   gossip_dtype=gd))
                    held([got[:2], got[2:]], plain, what,
                         f"row_block/{gd or 'float32'}")
                    by_route[rt] += 1
                    cases += 1
                    del got, plain
            del xr, yr
        return cases, halos

    # the mesh's row blocks: each of B4_ROW_RANKS ranks' rows of the exp
    # lists at the scale path's pair; then each of MESH_WORLD ranks' rows
    # of the mesh phase's support (its topology at n = TRAIN_N) at its
    # own D (the packed qwen2-0.5b at MESH_LAYERS layers and its group
    # weights), as its sparse_packed run launches B4
    row_cases, halo_rows_by_rank = row_blocks(exp[0][1], x, y,
                                              B4_ROW_RANKS, "exp")
    del x, y
    mdx, mdy = mesh_packed_dims()
    msp = sp_lib.sparse_mixing_matrix(train_args().topology, TRAIN_N).to(dev)
    mx = (*(torch_randn(gen, dev, TRAIN_N, mdx) for _ in range(3)), eta_s,
          corr)
    my = (*(torch_randn(gen, dev, TRAIN_N, mdy) for _ in range(3)), 1.0,
          -3.0)
    mesh_cases, mesh_halos = row_blocks(msp, mx, my, MESH_WORLD,
                                        train_args().topology)
    del mx, my
    torch.cuda.empty_cache()

    # the NaN contract: out-of-range indices in two rows, at n = 9 (a
    # table chunk of 9·m words, not whole 16-byte pieces) and n = 4096
    nan_cases = 0
    for n in (9, SCALE_N):
        rows = (5, 3 * n // 4 + 1)
        sp = dict(sparse_topologies(n, gen, dev))["exp"]
        idx = sp.neighbor_idx.clone()
        idx[rows[0], 2], idx[rows[1], 0] = n, -1
        v = (*(torch_randn(gen, dev, n, 12) for _ in range(3)), eta_s, corr)
        outs = [neighbor_gossip.sparse_gossip_pair_nd(
            idx, sp.neighbor_w, sp.self_w, v, force_route=r)
            for r in ("stripe", "row_block")]
        for out in outs:
            for t in out:
                nan_rows = t.isnan().any(1).nonzero().flatten().tolist()
                if nan_rows != sorted(rows) or not t[list(rows)].isnan().all():
                    fail(f"sparse_gossip NaN contract n={n}: NaN rows "
                         f"{nan_rows}, expected {sorted(rows)}")
        if not all(map(bitwise_equal, *outs)):
            fail(f"sparse_gossip NaN contract n={n}: routes differ")
        nan_cases += 1

    # bank conflicts of the stripe gathers on the scale path's tables
    conflicts = {f"{label}/{'bfloat16' if bf16 else 'float32'}":
                 gather_wavefronts(sp.neighbor_idx, bf16)
                 for label, sp in sparse_topologies(SCALE_N, gen, dev)
                 if label in ("exp",) or "+mask" in label
                 for bf16 in (False, True)}
    emit({"phase": "kernels", "kernel": "sparse_gossip",
          "cases": sum(by_route.values()), "cases_by_route": by_route,
          "bitwise_equal_to_row_block": bitwise, "pair_cases": pairs,
          "nan_contract_cases": nan_cases, "row_block_cases": row_cases,
          "row_block_shape": {"n": SCALE_N, "rows_a_rank": SCALE_N
                              // B4_ROW_RANKS, "D": [DX, DY],
                              "halo_rows_by_rank": halo_rows_by_rank},
          "mesh_rank_cases": mesh_cases,
          "mesh_rank_shape": {"n": TRAIN_N, "topology":
                              train_args().topology, "rows_a_rank": TRAIN_N
                              // MESH_WORLD, "D": [mdx, mdy],
                              "halo_rows_by_rank": mesh_halos},
          "max_abs_err": worst_abs,
          "max_err_over_1_plus_max_ref_by_group": worst, "tol": TOL_SPARSE,
          f"stripe_gather_wavefronts_over_conflict_free_n{SCALE_N}":
              conflicts})
    return worst_abs, by_route


# (B, Sq, Sk, H, KV, D, window, causal): one key, ragged tiles, GQA 4/1 and
# 14/2 and MHA, head_dim 32 to 256 (80: padded inside the kernel; 33, and 36
# in bf16: rows not whole 16-byte chunks, so the element-wise loads),
# windows shorter and longer than a tile, non-causal with Sq ≠ Sk
FLASH_CASES = [
    (1, 50, 50, 4, 2, 33, 0, True),
    (2, 70, 70, 4, 1, 36, 16, True),
    (1, 1, 1, 1, 1, 64, 0, True),
    (2, 37, 37, 4, 1, 64, 16, True),
    (1, 100, 100, 14, 2, 64, 0, True),
    (2, 130, 130, 4, 4, 256, 16, True),
    (1, 200, 200, 8, 2, 128, 64, True),
    (2, 65, 65, 2, 1, 80, 0, True),
    (1, 129, 129, 4, 2, 32, 7, True),
    (1, 1000, 1000, 4, 1, 256, 300, True),
    (1, 70, 100, 4, 1, 64, 0, False),
    (2, 37, 50, 4, 2, 256, 16, False),
    (1, 100, 37, 4, 4, 128, 0, False),
]


def served_attention_shape():
    """(B, S, H, KV, D, window) of the served attn_local layers."""
    from repro_torch.configs import registry

    cfg = registry.get_model_config(SERVE_ARCH)
    return (SERVE_B, SERVE_PROMPT, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.rglru.local_window)


def served_scan_shape():
    from repro_torch.configs import registry

    return (SERVE_B, SERVE_PROMPT,
            registry.get_model_config(SERVE_ARCH).rglru.lru_width)


def served_scan_shard():
    """B8's (B, S, W/2) on a model rank of the serving mesh."""
    from repro_torch.configs import registry

    return (SERVE_SCAN[SERVE_ARCH][0], SERVE_SCAN_PROMPT,
            registry.get_model_config(SERVE_ARCH).rglru.lru_width
            // SERVE_SCAN_SHAPE[1])


def attn_operands(b, sq, sk, h, kv, d, dtype, gen, dev):
    import torch

    return (torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, sk, kv, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, sk, kv, d), generator=gen, device=dev).to(dtype))


# bf16 cases for the tensor-core route's edges: one query row (against one
# key and against 100), S not a multiple of the 64-key tile or the 128-row
# query tile, window edges inside key tiles (40, 100, 300), KV 1 and 2,
# head_dim 64, 128 and 256 (and 80 and 32 in FLASH_CASES, padded)
FLASH_TC_CASES = [
    (2, 1, 1, 4, 1, 64, 0, True),
    (1, 1, 100, 8, 2, 128, 0, False),
    (1, 300, 300, 4, 2, 64, 40, True),
    (2, 333, 333, 16, 1, 256, 100, True),
    (1, 257, 257, 8, 1, 128, 0, True),
    (1, 640, 640, 4, 2, 256, 300, True),
]
# the shapes of the moe and frontends phases: granite-moe-1b-a400m's
# (16/8 heads of 64) vmapped train step at n = 2 and its prefill; musicgen's
# 24/24 heads of 64 at 1500 frames; internvl2-76b's 64/8 heads of 128 over
# 256 prefix embeddings and 2048 tokens; the prefills on a model rank of
# the serving mesh: qwen2-0.5b's (7 query heads over 1 KV head) and
# recurrentgemma-9b's attn_local layers (8 query heads over the one KV head
# both ranks hold, window 2048)
MODEL_FLASH_CASES = [
    (8, 128, 128, 16, 8, 64, 0, True),
    (4, 4096, 4096, 7, 1, 64, 0, True),
    (1, 4096, 4096, 8, 1, 256, 2048, True),
    (4, 4096, 4096, 16, 8, 64, 0, True),
    (4, 1500, 1500, 24, 24, 64, 0, True),
    (2, 2304, 2304, 64, 8, 128, 0, True),
]


def routed_call(fn, kernel, want_route):
    """``fn()`` through a two-route wrapper, failing unless it took
    ``want_route`` (the route counts before and after)."""
    from repro_torch.kernels import ops

    before = ops.route_counts()[kernel]
    out = fn()
    after = ops.route_counts()[kernel]
    took = [r for r in after if after[r] != before[r]]
    if took != [want_route]:
        fail(f"{kernel}: the call took route {took}, expected {want_route}")
    return out


def check_flash_attention(gen, dev):
    """B5 against ``ref.attention_ref`` in f32 and bf16, over FLASH_CASES,
    FLASH_TC_CASES and the served shape, on both routes: each call takes
    the route ``flash_attention.route`` gives it, and every bf16 call that
    takes the tensor-core route is repeated on the CUDA-core route.
    Returns the largest absolute error and the cases by route."""
    import torch

    from repro_torch.kernels import flash_attention, ref

    b, s, h, kv, d, window = served_attention_shape()
    cases = (FLASH_CASES + FLASH_TC_CASES + MODEL_FLASH_CASES
             + [(b, s, s, h, kv, d, window, True)])
    worst = 0.0
    worst_rel = {}  # by route and dtype
    by_route = {"tensor_core": 0, "cuda_core": 0}

    def run(q, k, v, causal, window, tol, what, want_route, force=None):
        nonlocal worst
        got = routed_call(lambda: flash_attention.flash_attention_bshd(
            q, k, v, causal=causal, window=window, force_route=force),
            "flash_attention", want_route)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        if got.dtype != q.dtype or got.shape != q.shape:
            fail(f"flash_attention: {got.dtype} {tuple(got.shape)}")
        err = max_err(got.float(), want.float())
        scale = 1 + float(want.float().abs().max())
        name = f"{want_route}/{str(q.dtype).split('.')[1]}"
        worst = max(worst, err)
        worst_rel[name] = max(worst_rel.get(name, 0.0), err / scale)
        by_route[want_route] += 1
        if not err <= tol * scale:
            fail(f"flash_attention {what} {want_route}: err {err}")

    for b, sq, sk, h, kv, d, window, causal in cases:
        for dtype, tol in ((torch.float32, TOL_ATTN_F32),
                           (torch.bfloat16, TOL_ATTN_BF16)):
            q, k, v = attn_operands(b, sq, sk, h, kv, d, dtype, gen, dev)
            what = f"{(b, sq, sk, h, kv, d, window)} causal={causal} {dtype}"
            rt = flash_attention.route(
                dtype, d, (q.stride(), k.stride(), v.stride()), True)
            run(q, k, v, causal, window, tol, what, rt)
            if rt == "tensor_core":
                run(q, k, v, causal, window, tol, what, "cuda_core",
                    force="cuda_core")
            del q, k, v
    # a k that is contiguous but not 16-byte aligned: the CUDA-core route
    # with its element-wise loads
    q, k, v = attn_operands(2, 100, 100, 4, 1, 64, torch.bfloat16, gen, dev)
    k_off = torch.empty(k.numel() + 1, dtype=k.dtype, device=dev)[1:]
    k_off = k_off.view(k.shape).copy_(k)
    run(q, k_off, v, True, 16, TOL_ATTN_BF16, "with a misaligned k",
        "cuda_core")
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "flash_attention",
          "cases": sum(by_route.values()), "cases_by_route": by_route,
          "max_abs_err": worst,
          "max_err_over_1_plus_max_by_route_and_dtype": worst_rel,
          "tol": {"float32": TOL_ATTN_F32, "bfloat16": TOL_ATTN_BF16},
          "served_shape": list(served_attention_shape())})
    return worst, by_route


def rglru_operands(shape, gen, dev, *, model=False):
    """B8's (a, u) at ``shape``: a ∈ [0.5, 1] and u ~ N(0, 1); with
    ``model``, as the RG-LRU block draws them at its seed-0 init
    (``models.rglru``): a = exp(−8·softplus(Λ)·r) over Λ = linspace(0.5, 4,
    W) with a recurrence gate r = σ(N(0, 1)), and u = √(1 − a²)·i·x with
    i = σ(N(0, 1)), x ~ N(0, 1)."""
    import torch
    import torch.nn.functional as F

    b, s, w = shape
    if not model:
        return (torch.rand(shape, generator=gen, device=dev) * 0.5 + 0.5,
                torch.randn(shape, generator=gen, device=dev))
    lam = torch.linspace(0.5, 4.0, w, device=dev)
    r = torch.sigmoid(torch.randn(shape, generator=gen, device=dev))
    log_a = -8.0 * F.softplus(lam) * r
    a = torch.exp(log_a)
    i = torch.sigmoid(torch.randn(shape, generator=gen, device=dev))
    x = torch.randn(shape, generator=gen, device=dev)
    u = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * i * x
    return a, u


def rglru_scan_shapes():
    """Every (B, S, W) of B8 in the later phases, and ragged ones: one
    chunk and less (the walk), S of two chunks or more with ragged W and S
    (the chunked route); the served, 32k, train and mesh-rank shapes."""
    from repro_torch.configs import registry

    w = registry.get_model_config(SERVE_ARCH).rglru.lru_width
    return [(1, 1, 1), (2, 17, 5), (3, 300, 130), (2, 33, 257), (2, 129, 5),
            (1, 257, 33), (1, 1000, 4096), served_scan_shape(),
            (1, LONG_S, w), RG_SCAN_TRAIN_SHAPE,
            (SSM_TRAIN_N * TRAIN_B, TRAIN_S, 256), served_scan_shard()]


def check_rglru_scan(gen, dev):
    """B8 against ``ref.rglru_ref``, without and with a carried h0 (folded
    into u_0 as the model folds it; at 32k without), over
    ``rglru_scan_shapes``, on both routes: each call takes the route ``rglru_scan.route`` gives it (held
    at TOL_SCAN on the chunked route), and every call is repeated on the
    walk, forced (bit for bit: any error fails).  Then a and u drawn as
    the model draws them (``rglru_operands(model=True)``) at the served
    shape, on both routes at TOL_SERVE_F32.  Returns the largest absolute
    error and the cases by route."""
    import torch

    from repro_torch.kernels import ref, rglru_scan

    worst = 0.0
    worst_rel = dict.fromkeys(rglru_scan.ROUTES, 0.0)
    by_route = dict.fromkeys(rglru_scan.ROUTES, 0)

    def run(a, uk, want, what, tol):
        nonlocal worst
        rt = rglru_scan.route(*a.shape)
        errs = {}
        for r in dict.fromkeys((rt, "walk")):
            got = routed_call(lambda: rglru_scan.rglru_scan_bsw(
                a, uk, force_route=r), "rglru_scan", r)
            err = max_err(got, want)
            rel = err / (1 + float(want.abs().max()))
            worst = max(worst, err)
            worst_rel[r] = max(worst_rel[r], rel)
            by_route[r] += 1
            errs[r] = rel
            if r == "walk" and err != 0.0:
                fail(f"rglru_scan {what} walk: err {err}, not bit for bit")
            if not rel <= tol:
                fail(f"rglru_scan {what} {r}: {rel} > {tol} × (1 + max)")
            del got
        return errs

    for b, s, w in rglru_scan_shapes():
        a, u = rglru_operands((b, s, w), gen, dev)
        h0 = torch.randn((b, w), generator=gen, device=dev)
        # at 32k without h0 only: a plain loop of its S steps takes 1.1–1.5 s
        # beside an H100
        for with_h0 in (False, True) if s < LONG_S else (False,):
            uk = u
            if with_h0:
                uk = u.clone()
                uk[:, 0] = uk[:, 0] + a[:, 0] * h0
            want = ref.rglru_ref(a, u, h0 if with_h0 else None)
            run(a, uk, want, f"{(b, s, w)} h0={with_h0}", TOL_SCAN)
            del uk, want
        del a, u, h0
        torch.cuda.empty_cache()
    shape = served_scan_shape()
    a, u = rglru_operands(shape, gen, dev, model=True)
    model_case = {"shape": list(shape), "tol": TOL_SERVE_F32,
                  "a_mean": float(a.mean()), "a_max": float(a.max()),
                  "a_share_above_0.9": float((a > 0.9).float().mean()),
                  "rel_err_by_route": run(a, u, ref.rglru_ref(a, u),
                                          f"{shape} as the model draws it",
                                          TOL_SERVE_F32)}
    del a, u
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "rglru_scan",
          "cases": sum(by_route.values()), "cases_by_route": by_route,
          "max_abs_err": worst, "max_err_over_1_plus_max_by_route": worst_rel,
          "tol": TOL_SCAN, "shapes": rglru_scan_shapes(),
          "model_drawn_case": model_case})
    return worst, by_route


def rglru_chunked_direct(a, u):
    """B8's chunked kernel through its C entry, at a shape the wrapper's
    rule keeps on the walk (a single chunk): for its time only."""
    import torch

    from repro_torch.kernels import _build, rglru_scan

    b, s, w = a.shape
    h = torch.empty_like(a)
    work = torch.empty((rglru_scan.work_bytes(b, s, w),), dtype=torch.uint8,
                       device=a.device)
    _build.check(_build.library("rglru_scan").rglru_chunked_launch(
        a.data_ptr(), u.data_ptr(), h.data_ptr(), work.data_ptr(), b, s, w,
        torch.cuda.current_stream(a.device).cuda_stream),
        "rglru_chunked_launch")
    return h


# operand sets of the B8 timings rotate over at least this many bytes (3×
# an H100's 50 MB L2), so that every call reads device memory
COLD_BYTES = 150e6


def rotating(fn, sets):
    """A call of ``fn`` on the next of ``sets`` (argument tuples) each time."""
    turn = [0]

    def go():
        turn[0] = (turn[0] + 1) % len(sets)
        return fn(*sets[turn[0]])
    return go


def b8_times(gen, dev, shape, *, plain_reps=3) -> dict:
    """B8 at ``shape``: the device ms of both routes (the chunked one through
    ``rglru_chunked_direct`` where the rule keeps the shape on the walk),
    of the backward kernel and of the plain version, beside the bounds
    (12·B·S·W bytes forward, 20·B·S·W backward).  Kernel times from CUDA
    graphs of back-to-back calls (``graph_ms``) over enough operand sets
    that they exceed COLD_BYTES; the plain version's from CUDA events."""
    import torch

    from repro_torch.kernels import ops, ref, rglru_scan

    b, s, w = shape
    sets = [rglru_operands(shape, gen, dev)
            for _ in range(max(1, math.ceil(COLD_BYTES / (12 * b * s * w))))]
    inner = len(sets) * max(1, 8 // len(sets))
    rt = rglru_scan.route(b, s, w)
    out = {"shape": [b, s, w], "route": rt, "operand_sets": len(sets)}
    with ops.uncounted():
        for r in rglru_scan.ROUTES:
            fn = (rglru_chunked_direct if r == "chunked" and rt == "walk"
                  else lambda a, u, r=r: rglru_scan.rglru_scan_bsw(
                      a, u, force_route=r))
            out[f"{r}_ms"] = graph_ms(rotating(fn, sets), reps=11,
                                      inner=inner)
        back = [(a, rglru_scan.rglru_scan_bsw(a, u),
                 torch.randn(shape, generator=gen, device=dev))
                for a, u in sets]
        out["backward_ms"] = graph_ms(rotating(
            rglru_scan.RglruScanFn.backward_launch, back), reps=11,
            inner=inner)
    out["ms"] = out[f"{rt}_ms"]
    a, u = sets[0]
    # the plain version is a loop of S steps (over a second at 32k beside
    # an H100): one warm-up
    out["plain_ms"] = cuda_ms(lambda: ref.rglru_ref(a, u), reps=plain_reps,
                              warmup=1)
    out["bound_ms"], out["bound_by"] = scan_bound_ms(b, s, w)
    out["library_ms"] = None
    out["backward_bound_ms"], out["backward_bound_by"] = _bound(
        20 * b * s * w, 3 * b * s * w)
    del sets, back, a, u
    torch.cuda.empty_cache()
    return out


def served_ssd_shapes():
    """(B, S, H, P, N, chunk) of the SSD scan in the mamba2 serve prefill,
    in evaluation (state0 None there), at prefill_32k's length and on a
    model rank of the serving mesh (H/2 heads)."""
    from repro_torch.configs import registry

    s = registry.get_model_config(MAMBA_ARCH).ssm
    cfg = registry.get_model_config(MAMBA_ARCH)
    h = s.expand * cfg.d_model // s.d_head
    m = SERVE_SCAN_SHAPE[1]
    return [(b, sl, hh, s.d_head, s.d_state, s.chunk)
            for b, sl, hh in ((MAMBA_B, MAMBA_PROMPT, h), (EVAL_B, EVAL_S, h),
                              (1, LONG_S, h),
                              (SERVE_SCAN[MAMBA_ARCH][0], SERVE_SCAN_PROMPT,
                               h // m))]


def train_ssd_shape():
    """(B, S, H, P, N, chunk) of the SSD scan in mamba2-1.3b's training:
    the clients folded into the batch."""
    from repro_torch.configs import registry

    cfg = registry.get_model_config(SSM_TRAIN_ARCH)
    s = cfg.ssm
    return (SSM_TRAIN_N * TRAIN_B, TRAIN_S, s.expand * cfg.d_model // s.d_head,
            s.d_head, s.d_state, s.chunk)


def ssd_operands(b, s, h, p, n, gen, dev):
    """xdt, loga (< 0, as −exp(A_log)·dt in the model), B, C and a state0."""
    import torch

    return (torch.randn((b, s, h, p), generator=gen, device=dev) * 0.5,
            -torch.rand((b, s, h), generator=gen, device=dev),
            torch.randn((b, s, n), generator=gen, device=dev),
            torch.randn((b, s, n), generator=gen, device=dev),
            torch.randn((b, h, p, n), generator=gen, device=dev))


# (B, S, H, P, N, chunk): S = 1 and S < chunk, ragged last chunks, H from 1
# to 64, P 32 and 64, N 16 and 128, chunk 16 and 64; then the reduced
# mamba2's shape (CPU tests)
SSD_CASES = [
    (1, 1, 1, 32, 16, 16), (2, 10, 3, 32, 16, 16), (2, 37, 4, 32, 16, 16),
    (1, 100, 1, 64, 128, 64), (2, 130, 8, 64, 128, 64),
    (3, 64, 2, 32, 128, 64), (1, 257, 64, 64, 128, 64),
    (2, 48, 5, 64, 16, 64), (2, 40, 16, 32, 16, 16),
]


def check_ssd_scan(gen, dev):
    """B7 against ``ref.ssd_chunked`` (y and final state), with and without
    state0, over SSD_CASES, operands read through strides (rows of whole
    16-byte pieces, and rows that are not), and the shapes of the serve,
    evaluate and times phases, on both routes: each call takes the route
    ``ssd_scan.route`` gives it (the tensor-core route at every served
    shape), and every tensor-core call is repeated on the CUDA-core route.
    Returns the largest absolute error and the cases by route."""
    import torch

    from repro_torch.kernels import ref, ssd_scan

    worst = 0.0
    worst_rel = {r: 0.0 for r in ssd_scan.ROUTES}
    by_route = {r: 0 for r in ssd_scan.ROUTES}

    def run(xdt, loga, bm, cm, state0, chunk, what):
        nonlocal worst
        py, pfin = ref.ssd_chunked(xdt, loga, bm, cm, chunk, state0)
        ops = [x for x in (xdt, bm, cm, state0) if x is not None]
        rt = ssd_scan.route(xdt.shape[-1], bm.shape[-1],
                            (xdt.stride(), bm.stride(), cm.stride()),
                            all(x.data_ptr() % 16 == 0 for x in ops))
        for want_route in dict.fromkeys((rt, "cuda_core")):
            force = None if want_route == rt else want_route
            y, fin = routed_call(lambda: ssd_scan.ssd_scan_bshp(
                xdt, loga, bm, cm, state0, chunk=chunk, force_route=force),
                "ssd_scan", want_route)
            for name, got, want in (("y", y, py), ("state", fin, pfin)):
                err = max_err(got, want)
                rel = err / (1 + float(want.abs().max()))
                worst = max(worst, err)
                worst_rel[want_route] = max(worst_rel[want_route], rel)
                if not rel <= TOL_SSD:
                    fail(f"ssd_scan {what} state0={state0 is not None} "
                         f"{want_route}: {name} err {err}")
            by_route[want_route] += 1
            del y, fin
        return rt

    served = served_ssd_shapes() + [train_ssd_shape()]
    for b, s, h, p, n, chunk in SSD_CASES + served:
        xdt, loga, bm, cm, s0 = ssd_operands(b, s, h, p, n, gen, dev)
        for state0 in (None, s0):
            rt = run(xdt, loga, bm, cm, state0, chunk, (b, s, h, p, n, chunk))
            if (b, s, h, p, n, chunk) in served and rt != "tensor_core":
                fail(f"ssd_scan: served shape {(b, s, h, p, n)} takes the "
                     f"{rt} route")
        del xdt, loga, bm, cm, s0
        torch.cuda.empty_cache()
    # strided operands: xdt, B and C as slices of wider tensors, loga a
    # transposed view; B and C rows 260 floats apart (whole 16-byte pieces:
    # tensor cores), then 259 (CUDA cores)
    b, s, h, p, n = 2, 100, 4, 64, 128
    wide = torch.randn((b, s, h, p + 8), generator=gen, device=dev)
    loga = -torch.rand((b, h, s), generator=gen, device=dev).transpose(1, 2)
    for pad, want_rt in ((4, "tensor_core"), (3, "cuda_core")):
        bc = torch.randn((b, s, 2 * n + pad), generator=gen, device=dev)
        xdt, bm, cm = wide[..., :p], bc[..., :n], bc[..., n:2 * n]
        if run(xdt, loga, bm, cm, None, 64, f"strided, pad {pad}") != want_rt:
            fail(f"ssd_scan: strided operands (pad {pad}) off {want_rt}")
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "ssd_scan",
          "cases": sum(by_route.values()), "cases_by_route": by_route,
          "max_abs_err": worst, "max_err_over_1_plus_max_by_route": worst_rel,
          "tol": TOL_SSD, "served_shapes": served})
    return worst, by_route


def ce_operands(n, d, v, dtype, gen, dev, *, tied=True):
    """hidden (N, d); the head as a (V, d) operand — contiguous (tied) or
    the transposed view of a contiguous (d, V) head (untied); labels with
    0 and V − 1 among them."""
    import torch

    hidden = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    scale = 3.0 / d ** 0.5
    if tied:
        w = (torch.randn((v, d), generator=gen, device=dev) * scale).to(dtype)
    else:
        w = (torch.randn((d, v), generator=gen, device=dev)
             * scale).to(dtype).T
    labels = torch.randint(0, v, (n,), generator=gen, device=dev)
    labels[0] = 0
    labels[-1] = v - 1
    return hidden, w, labels


def eval_ce_shape():
    """(N, d, V) of B6 in evaluation: all tokens of a client batch."""
    from repro_torch.configs import registry

    cfg = registry.get_model_config(MAMBA_ARCH)
    return EVAL_B * EVAL_S, cfg.d_model, cfg.vocab_size


# (N, d, V): one token and one class, ragged N, d and V (V past and short of
# a 128 tile), mamba2's d and V with few tokens, the reduced model's shape
CE_CASES = [(1, 16, 1), (5, 33, 7), (100, 64, 1000), (130, 256, 50280),
            (257, 2048, 5000), (64, 2048, 50280), (80, 256, 512)]
# bf16 cases for the tensor-core route's edges: N = 1, 130 and 257 (short of
# and past a 128-token tile), V = 1000 and 50280 (ragged last 256-entry
# tile, with label V − 1 in it), d = 64 to 2048 (whole k-slices of 64) and
# 200 (a last k-slice of 8)
CE_TC_CASES = [(1, 2048, 50280), (130, 2048, 1000), (257, 256, 50280),
               (257, 2048, 1000), (130, 64, 50280), (1, 512, 1000),
               (130, 200, 1000),
               # granite-moe-1b-a400m's train client batch (V odd: the
               # vocab tail), musicgen's evaluate batch against one
               # codebook's head
               (512, 1024, 49155), (6000, 1536, 2048)]


def check_cross_entropy(gen, dev):
    """B6 against ``ref.fused_ce_ref`` in f32 and bf16, tied and untied
    layouts, over CE_CASES, CE_TC_CASES (bf16) and the evaluate shape (bf16,
    tied), on both routes: each call takes the route ``cross_entropy.route``
    gives it, and every call that takes the tensor-core route is repeated on
    the CUDA-core route.  Returns the largest absolute error and the cases
    by route."""
    import torch

    from repro_torch.kernels import cross_entropy, ref

    worst = 0.0
    worst_rel = {}  # by route and dtype
    by_route = {"tensor_core": 0, "cuda_core": 0}

    def run(hidden, w, labels, what, want_route, force=None):
        nonlocal worst
        got = routed_call(lambda: cross_entropy.fused_ce_nd(
            hidden, w, labels, force_route=force), "fused_cross_entropy",
            want_route)
        want = ref.fused_ce_ref(hidden, w, labels)
        err = max_err(got, want)
        rel = err / (1 + float(want.abs().max()))
        name = f"{want_route}/{str(hidden.dtype).split('.')[1]}"
        worst = max(worst, err)
        worst_rel[name] = max(worst_rel.get(name, 0.0), rel)
        by_route[want_route] += 1
        if not rel <= TOL_CE:
            fail(f"fused_cross_entropy {what} {want_route}: err {err}")

    grid = [(c, dt, tied) for c in CE_CASES
            for dt in (torch.float32, torch.bfloat16) for tied in (True, False)]
    grid += [(c, torch.bfloat16, tied) for c in CE_TC_CASES
             for tied in (True, False)]
    grid.append((eval_ce_shape(), torch.bfloat16, True))
    for (n, d, v), dtype, tied in grid:
        hidden, w, labels = ce_operands(n, d, v, dtype, gen, dev, tied=tied)
        what = f"{(n, d, v)} {dtype} tied={tied}"
        rt = cross_entropy.route(dtype, hidden.stride(), w.stride(), True)
        run(hidden, w, labels, what, rt)
        if rt == "tensor_core":
            run(hidden, w, labels, what, "cuda_core", force="cuda_core")
        del hidden, w, labels
    # hidden that is not 16-byte aligned: the CUDA-core route
    hidden, w, labels = ce_operands(130, 256, 1000, torch.bfloat16, gen, dev)
    h_off = torch.empty(hidden.numel() + 1, dtype=hidden.dtype,
                        device=dev)[1:].view(hidden.shape).copy_(hidden)
    run(h_off, w, labels, "with a misaligned hidden", "cuda_core")
    del hidden, h_off, w, labels
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "fused_cross_entropy",
          "cases": sum(by_route.values()), "cases_by_route": by_route,
          "max_abs_err": worst,
          "max_err_over_1_plus_max_by_route_and_dtype": worst_rel,
          "tol": TOL_CE, "eval_shape": list(eval_ce_shape())})
    return worst, by_route


def ce_partials_bound_ms(n, d, v):
    """2·N·V·d operations at the bf16 tensor-core peak against hidden,
    the piece and the labels read once and (m, l, z) written once."""
    return _bound(2 * (n * d + v * d) + 8 * n + 12 * n, 2 * n * v * d,
                  BF16_FLOP_S)


def check_ce_partials(gen, dev):
    """B6's vocab-parallel form (``cross_entropy.fused_ce_partials_nd``)
    against ``ref.ce_partials_ref``: m, the piece's log-sum-exp m + log l
    and z, each within TOL_CE·(1 + max|plain|), at CE_PARTIALS_SHAPE (bf16, a contiguous piece, labels
    over the whole vocabulary, so that most fall outside the piece) and
    at ragged shapes in f32 and bf16, each call on the route
    ``cross_entropy.route`` gives it and every tensor-core call again on
    the CUDA-core route; then the two pieces of the whole vocabulary
    (2 × CE_PARTIALS_SHAPE's V) merged as the model ranks merge them
    against whole-vocabulary B6, on each route, at TOL_CE_MERGED·(1 +
    max).  Times at the rank's shape: the kernel on each route, the plain
    version, and the nearest library calls (``torch.mm`` to f32 logits,
    then ``F.cross_entropy`` on the piece).  Returns (the largest absolute
    error, cases by route, times)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cross_entropy, ops, ref

    worst = 0.0
    by_route = {"tensor_core": 0, "cuda_core": 0}
    errs = {}

    def operands(n, d, v, dtype, lo):
        hidden, w, labels = ce_operands(n, d, 2 * v, dtype, gen, dev)
        return hidden, w[lo:lo + v], labels - lo

    def run(hidden, w, labels, what, want_route, force=None):
        nonlocal worst
        got = routed_call(lambda: cross_entropy.fused_ce_partials_nd(
            hidden, w, labels, force_route=force), "ce_partials",
            want_route)
        want = ref.ce_partials_ref(hidden, w, labels)
        # l through the piece's log-sum-exp m + log l (what the merge
        # reads): a sum of V_r f32 exponentials in another order (and
        # exp2 on the tensor-core route) misses 1e-5 of l itself
        # (1.4e-5 at the rank's shape)
        got = (got[0], got[0] + torch.log(got[1]), got[2])
        want = (want[0], want[0] + torch.log(want[1]), want[2])
        for name, g, p in zip(("m", "lse", "z"), got, want):
            err = max_err(g, p)
            rel = err / (1 + float(p.abs().max()))
            worst = max(worst, err)
            key = f"{want_route}/{str(hidden.dtype).split('.')[1]}/{name}"
            errs[key] = max(errs.get(key, 0.0), rel)
            if not rel <= TOL_CE:
                fail(f"ce_partials {what} {want_route} {name}: err {err}")
        by_route[want_route] += 1
        return got

    cases = [(CE_PARTIALS_SHAPE, torch.bfloat16, 0),
             ((130, 200, 1000), torch.bfloat16, 1000),
             ((257, 256, 777), torch.bfloat16, 3),
             ((5, 33, 7), torch.float32, 7), ((100, 64, 1000),
                                              torch.float32, 0)]
    for (n, d, v), dtype, lo in cases:
        hidden, w, labels = operands(n, d, v, dtype, lo)
        what = f"{(n, d, v)} {dtype} from {lo}"
        rt = cross_entropy.route(dtype, hidden.stride(), w.stride(),
                                 hidden.data_ptr() % 16 == 0
                                 and w.data_ptr() % 16 == 0)
        run(hidden, w, labels, what, rt)
        if rt == "tensor_core":
            run(hidden, w, labels, what, "cuda_core", force="cuda_core")
        del hidden, w, labels
    # the merge: two pieces of the whole vocabulary against B6 on it
    n, d, v = CE_PARTIALS_SHAPE
    hidden, w_all, labels = ce_operands(n, d, 2 * v, torch.bfloat16, gen, dev)
    merged_err = {}
    for force in (None, "cuda_core"):
        route = force or "tensor_core"
        parts = [routed_call(lambda lo=lo: cross_entropy.fused_ce_partials_nd(
            hidden, w_all[lo:lo + v], labels - lo, force_route=force),
            "ce_partials", route) for lo in (0, v)]
        big = torch.maximum(parts[0][0], parts[1][0])
        nll = ref.merge_nll(big, sum(p[1] * torch.exp(p[0] - big)
                                     for p in parts),
                            parts[0][2] + parts[1][2])
        whole = routed_call(lambda: cross_entropy.fused_ce_nd(
            hidden, w_all, labels, force_route=force), "fused_cross_entropy",
            route)
        by_route[route] += 2
        rel = max_err(nll, whole) / (1 + float(whole.abs().max()))
        merged_err[route] = rel
        if not rel <= TOL_CE_MERGED:
            fail(f"ce_partials: the merged pieces miss whole-vocabulary B6 "
                 f"on the {route} route by {rel} of (1 + max)")
    del w_all
    # times at the rank's shape
    hidden, w, labels = operands(n, d, v, torch.bfloat16, 0)
    lab_in = torch.where((labels >= 0) & (labels < v), labels,
                         torch.full_like(labels, -100))

    try:  # f32 logits straight from the bf16 GEMM, where the build has it
        torch.mm(hidden[:1], w[:1].T, out_dtype=torch.float32)

        def logits():
            return torch.mm(hidden, w.T, out_dtype=torch.float32)

        library_form = "torch.mm(out_dtype=float32) + F.cross_entropy"
    except TypeError:
        def logits():
            return torch.mm(hidden, w.T).float()

        library_form = "torch.mm (bf16 logits) .float() + F.cross_entropy"

    def library():
        return F.cross_entropy(logits(), lab_in, reduction="none",
                               ignore_index=-100)
    with ops.uncounted():
        times = {
            "shape": list(CE_PARTIALS_SHAPE),
            "ms": cuda_ms(lambda: cross_entropy.fused_ce_partials_nd(
                hidden, w, labels)),
            "cuda_core_ms": cuda_ms(
                lambda: cross_entropy.fused_ce_partials_nd(
                    hidden, w, labels, force_route="cuda_core"), reps=5),
            "plain_ms": cuda_ms(lambda: ref.ce_partials_ref(
                hidden, w, labels), reps=5),
            "library_ms": cuda_ms(library, reps=5),
            "library_form": library_form}
    times["bound_ms"], times["bound_by"] = ce_partials_bound_ms(n, d, v)
    del hidden, w, labels
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "ce_partials",
          "cases": sum(by_route.values()), "cases_by_route": by_route,
          "max_abs_err": worst,
          "max_err_over_1_plus_max_by_route_dtype_output": errs,
          "merged_err_over_1_plus_max_by_route": merged_err,
          "tol": TOL_CE, "tol_merged": TOL_CE_MERGED, **times})
    return worst, by_route, times


def torch_randn(gen, dev, *shape):
    import torch

    return torch.randn(shape, generator=gen, device=dev)


# ---------------------------------------------------------------------------
# phase 4/5: the main path through the engine
# ---------------------------------------------------------------------------

def main_setup(dev, *, dx=DX, dy=DY, n=N, k=K, sigma=SIGMA, seed=0):
    import torch

    from repro_torch.core import make_quadratic_data, quadratic_problem

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = make_quadratic_data(gen, n, dx=dx, dy=dy, heterogeneity=1.0)
    problem = quadratic_problem(data, sigma=sigma)
    client_batch = {key: v for key, v in data.items() if key != "mu"}
    batches = {key: v.unsqueeze(0).expand(k, *v.shape)
               for key, v in client_batch.items()}
    return problem, client_batch, batches


def main_cfg(algo, impl, n=N, k=K, topology="ring", **cfg_kw):
    from repro_torch.configs import AlgorithmConfig

    return AlgorithmConfig(
        algorithm=algo, num_clients=n, local_steps=k, eta_cx=0.01,
        eta_cy=0.05, eta_sx=0.5 if algo == "kgt_minimax" else 1.0,
        eta_sy=0.5 if algo == "kgt_minimax" else 1.0, topology=topology,
        mixing_impl=impl, **cfg_kw)


def prepare(problem, client_batch, batches, algo, impl, dev, *,
            log_every=10, n=N, k=K, topology="ring", w=None, w_fn=None,
            mask_fn=None, attack_fn=None, capture=None, cfg_kw=None):
    """init_state and the engine's chunk builder: (state, build).  ``w``
    is the static mixing matrix (default: the topology's); ``w_fn`` /
    ``mask_fn`` / ``attack_fn`` draw a per-round W / participation mask /
    Byzantine adversary; ``cfg_kw`` sets further config fields
    (``gossip_compress``).  The builder captures each chunk as a CUDA
    graph; ``capture=False`` runs it eagerly."""
    import torch

    from repro_torch import engine as engine_lib
    from repro_torch.core import init_state, make_round_step

    cfg = main_cfg(algo, impl, n, k, topology, **(cfg_kw or {}))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = init_state(problem, cfg, gen, init_batch=client_batch)
    sampler = engine_lib.make_fixed_batch_sampler(
        batches, local_steps=k, num_clients=n, noise_dim=problem.noise_dim,
        seed=0, device=dev)
    if w_fn is not None or mask_fn is not None or attack_fn is not None:
        sampler = engine_lib.with_topology(sampler, w_fn=w_fn,
                                           mask_fn=mask_fn,
                                           attack_fn=attack_fn)
    step = make_round_step(problem, cfg, w, traced_w=w_fn is not None,
                           participation=mask_fn is not None,
                           byzantine=attack_fn is not None, device=dev)
    build = engine_lib.make_chunk_builder(
        step, sampler, engine_lib.quadratic_metrics_fn(problem),
        log_every=log_every, capture=capture)
    return state, build


def steady_rounds_per_s(state, build, rounds: int) -> float:
    """rounds/s of ``engine.run`` over one chunk of ``rounds``, host clock
    to a synchronize, after a first run with the same builder (kernels
    built, the chunk captured)."""
    import torch

    from repro_torch import engine as engine_lib

    engine_lib.run(state, build, total_rounds=rounds, chunk_rounds=rounds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine_lib.run(state, build, total_rounds=rounds, chunk_rounds=rounds)
    torch.cuda.synchronize()
    return rounds / (time.perf_counter() - t0)


def drive(problem, client_batch, batches, algo, impl, dev, rounds, **kw):
    """init_state → engine.run; returns (state, history)."""
    from repro_torch import engine as engine_lib

    state, build = prepare(problem, client_batch, batches, algo, impl, dev,
                           **kw)
    return engine_lib.run(state, build, total_rounds=rounds,
                          chunk_rounds=rounds)


def phase_main(dev) -> dict:
    problem, client_batch, batches = main_setup(dev)
    # the launch counts of the main path: set to 0 just before, read after
    zero_launch_counts()
    finals = {}
    for algo in ALGOS:
        for impl in ("dense", "pallas_packed", "fused_round"):
            finals[algo, impl] = drive(problem, client_batch, batches, algo,
                                       impl, dev, ROUNDS)
    launches = launch_counts()
    routes = route_counts()
    # one pair launch a round (x and y) per tracking algorithm
    expect = {"fused_gossip": ROUNDS * len(TRACKING),
              "fused_round": ROUNDS * len(ALGOS), "sparse_gossip": 0,
              **NO_MODEL_KERNELS}
    if launches != expect:
        fail(f"main path launches {launches}, expected {expect}")
    check_routes(routes, expect, "main path")
    for algo in ALGOS:
        ref_state, ref_hist = finals[algo, "dense"]
        worst = max(compare_states(finals[algo, impl][0], ref_state,
                                   f"{algo}/{impl} vs dense")
                    for impl in ("pallas_packed", "fused_round"))
        emit({"phase": "main", "algorithm": algo, "rounds": ROUNDS,
              "phi_grad_norm_first": ref_hist[0]["phi_grad_norm"],
              "phi_grad_norm_last": ref_hist[-1]["phi_grad_norm"],
              "phi_grad_norm_last_by_impl": {
                  impl: finals[algo, impl][1][-1]["phi_grad_norm"]
                  for impl in ("dense", "pallas_packed", "fused_round")},
              "max_state_err_vs_dense": worst})
    emit({"phase": "main", "launches": launches, "expected": expect,
          "launches_by_route": routes, "tol_state": TOL_STATE})
    return launches, routes


def phase_quickstart(dev) -> dict:
    from repro_torch.launch import quickstart

    algos = ("kgt_minimax", "local_sgda")
    g = {}
    # this path's launch counts: set to 0 just before, read just after
    zero_launch_counts()
    for algo in algos:
        _, hist = quickstart.run(algo, mixing_impl="fused_round",
                                 device=dev, verbose=False)
        g[algo] = hist[-1]["phi_grad_norm"]
    launches = launch_counts()
    routes = route_counts()
    expect = {"fused_gossip": 0,
              "fused_round": quickstart.ROUNDS * len(algos),
              "sparse_gossip": 0, **NO_MODEL_KERNELS}
    emit({"phase": "quickstart", "mixing_impl": "fused_round",
          "phi_grad_norm_final": g, "launches": launches,
          "launches_by_route": routes, "expected": expect})
    if launches != expect:
        fail(f"quickstart launches {launches}, expected {expect}")
    check_routes(routes, expect, "quickstart")
    if not g["kgt_minimax"] < g["local_sgda"]:
        fail(f"quickstart: kgt_minimax {g['kgt_minimax']} is not below "
             f"local_sgda {g['local_sgda']}")
    return launches, routes


# ---------------------------------------------------------------------------
# phase 6: the sparse path at scale, and churn
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    """Launches of every kernel wrapper (``kernels.ops.KERNELS``)."""
    from repro_torch.kernels import ops

    return ops.launch_counts()


def route_counts() -> dict:
    """Launches of each two-route kernel by route (``ops.route_counts``)."""
    from repro_torch.kernels import ops

    return ops.route_counts()


def compressed_counts() -> dict:
    """B2's launches with compression, by route
    (``ops.compressed_route_counts``), under the key
    ``fused_round_compressed``."""
    from repro_torch.kernels import ops

    return {"fused_round_compressed":
            ops.compressed_route_counts()["fused_round"]}


def zero_launch_counts() -> None:
    """Every launch count and every count by route to 0."""
    from repro_torch.kernels import ops

    ops.zero_launch_counts()


def check_routes(routes, want, what, route_of=None) -> None:
    """Fail unless every launch of each two-route kernel in ``routes`` went
    through the route the main paths take (``ops.ROUTED``: tensor cores,
    B2's cluster, B1's unrolled or B4's stripe route; ``route_of``
    overrides it per kernel), ``want[kernel]`` launches of it."""
    from repro_torch.kernels import ops

    for kernel, by in routes.items():
        new = (route_of or {}).get(kernel, ops.ROUTED[kernel])
        expect = {r: want.get(kernel, 0) if r == new else 0 for r in by}
        if by != expect:
            fail(f"{what}: {kernel} launches by route {by}, expected "
                 f"{expect} (every launch on the {new} route)")


def compare_states(state, ref_state, what) -> float:
    check_finite(state, what)
    worst = 0.0
    for name in ("x", "y", "cx", "cy"):
        a, b = getattr(state, name), getattr(ref_state, name)
        err = max_err(a, b)
        tol = TOL_STATE * (1.0 + float(b.abs().max()))
        if err > tol:
            fail(f"{what}: {name} differs by {err} > {tol}")
        worst = max(worst, err)
    return worst


def sigma_c(state) -> float:
    """max_j |mean_i c_ij| / (1 + max|c|) over cx and cy (f64 means)."""
    return max(float(c.double().mean(0).abs().max())
               / (1.0 + float(c.abs().max())) for c in (state.cx, state.cy))


def state_fields(state) -> tuple:
    """The state's tensor fields: x, y, cx, cy, and the EF residuals under
    compression."""
    return ("x", "y", "cx", "cy") + tuple(
        f for f in ("ef_x", "ef_y") if getattr(state, f, None) is not None)


def freeze_hook(mask_fn, state0, frozen: list, inactive: list):
    """Engine hook (one round a chunk): whether the inactive clients of the
    round just run kept x, y, cx, cy (and the EF residuals) bit for bit,
    and how many there were."""
    import torch

    prev = {"state": state0}

    def hook(state, records, prev_round):
        keep = ~mask_fn(prev_round)
        old = prev["state"]
        frozen.extend(torch.equal(getattr(state, name)[keep],
                                  getattr(old, name)[keep])
                      for name in state_fields(state))
        inactive.append(int(keep.sum()))
        prev["state"] = state

    return hook


def check_finite(state, what) -> None:
    for name in ("x", "y", "cx", "cy"):
        if not bool(getattr(state, name).isfinite().all()):
            fail(f"{what}: {name} not finite")


def phase_scale(dev) -> dict:
    import torch

    from repro_torch import engine as engine_lib
    from repro_torch.core import sparse_topology as sp_lib
    from repro_torch.core import stochastic_topology as st_lib
    from repro_torch.kernels import gossip

    n = SCALE_N
    problem, client_batch, batches = main_setup(dev, n=n)
    support = sp_lib.sparse_exp(n)
    # the dense reference on the same W (equal to mixing_matrix("exp", n),
    # built here without its O(n²) host loops)
    w_dense = sp_lib.densify(support.to(dev))
    common = dict(n=n, topology="exp", log_every=10)

    # 1-2. sparse_packed against dense, and the kernel's launches
    out = {"launches": {}, "max_state_err_vs_dense": {}}
    zero_launch_counts()
    finals = {}
    for algo in ALGOS:
        before = launch_counts()
        finals[algo, "sparse_packed"] = drive(
            problem, client_batch, batches, algo, "sparse_packed", dev,
            SCALE_ROUNDS, **common)
        after = launch_counts()
        out["launches"][algo] = {k: after[k] - before[k] for k in after}
    scale_launches = launch_counts()
    for algo in ALGOS:
        finals[algo, "dense"] = drive(problem, client_batch, batches, algo,
                                      "dense", dev, SCALE_ROUNDS, w=w_dense,
                                      **common)
    scale_routes = route_counts()
    for algo in ALGOS:
        # one pair launch a round (x and y) per tracking algorithm
        want = SCALE_ROUNDS if algo in TRACKING else 0
        got = out["launches"][algo]
        if got != {"fused_gossip": 0, "fused_round": 0,
                   "sparse_gossip": want, **NO_MODEL_KERNELS}:
            fail(f"scale {algo}: launches {got}, expected {want} of "
                 f"sparse_gossip and none of the others")
        (s_state, s_hist), (d_state, d_hist) = (finals[algo, "sparse_packed"],
                                                finals[algo, "dense"])
        out["max_state_err_vs_dense"][algo] = compare_states(
            s_state, d_state, f"scale {algo} sparse_packed vs dense")
        emit({"phase": "scale", "n": n, "algorithm": algo,
              "rounds": SCALE_ROUNDS, "topology": "exp",
              "max_degree": support.max_degree,
              "phi_grad_norm_first": d_hist[0]["phi_grad_norm"],
              "phi_grad_norm_last": {"dense": d_hist[-1]["phi_grad_norm"],
                                     "sparse_packed":
                                         s_hist[-1]["phi_grad_norm"]},
              "max_state_err_vs_dense":
                  out["max_state_err_vs_dense"][algo],
              "launches": out["launches"][algo]})
    del finals
    # every launch at n = 4096 on the stripe route
    check_routes(scale_routes, scale_launches, "scale path")
    out["sparse_gossip_launches"] = scale_launches["sparse_gossip"]
    out["launches_by_route"] = scale_routes

    # 3. every churn family under partial participation, n = 4096
    churn = {}
    for i, family in enumerate(st_lib.TOPOLOGY_FAMILIES):
        w_fn = sp_lib.make_sparse_w_sampler(family, support, seed=10 + i,
                                            edge_prob=0.5, device=dev)
        mask_fn = st_lib.make_participation_sampler(n, 10 + i, PARTICIPATION,
                                                    device=dev)
        frozen, inactive = [], []
        state0, build = prepare(problem, client_batch, batches,
                                "kgt_minimax", "sparse_packed", dev,
                                w_fn=w_fn, mask_fn=mask_fn, **common)
        zero_launch_counts()
        state, _ = engine_lib.run(
            state0, build, total_rounds=CHURN_ROUNDS, chunk_rounds=1,
            hooks=[freeze_hook(mask_fn, state0, frozen, inactive)])
        launched = launch_counts()["sparse_gossip"]
        check_routes(route_counts(), launch_counts(), f"churn {family}")
        sc = sigma_c(state)
        churn[family] = {"sigma_c": sc, "frozen_checks": len(frozen),
                         "inactive_client_rounds": sum(inactive),
                         "sparse_gossip_launches": launched}
        emit({"phase": "scale", "n": n, "churn": family,
              "participation": PARTICIPATION, "rounds": CHURN_ROUNDS,
              **churn[family], "tol_sigma_c": TOL_SIGMA_C})
        if not all(frozen) or len(frozen) != 4 * CHURN_ROUNDS:
            fail(f"churn {family}: an inactive client moved")
        if sum(inactive) == 0:
            fail(f"churn {family}: no client was ever inactive")
        if not sc <= TOL_SIGMA_C:
            fail(f"churn {family}: Σc/n = {sc} × (1 + max|c|)")
        if launched != CHURN_ROUNDS:
            fail(f"churn {family}: {launched} sparse_gossip launches")
        check_finite(state, f"churn {family}")
    out["churn"] = churn

    # 5. rounds/s, host clock around one captured engine chunk
    rps = {}
    for impl, w in (("sparse_packed", None), ("dense", w_dense)):
        state, build = prepare(problem, client_batch, batches, "kgt_minimax",
                               impl, dev, w=w, **{**common,
                                                  "log_every": SCALE_ROUNDS})
        rps[impl] = steady_rounds_per_s(state, build, SCALE_ROUNDS)
    emit({"phase": "scale", "n": n, "rounds_per_s": rps,
          "algorithm": "kgt_minimax", "rounds": SCALE_ROUNDS,
          "note": "host clock around engine.run, one chunk replayed as a "
                  "CUDA graph after a first run captured it, metrics on "
                  "rounds 0 and 19"})
    out["rounds_per_s"] = rps
    del problem, client_batch, batches, w_dense
    torch.cuda.empty_cache()

    # 4. churn at the dense limit through all three kernels, on the same
    # per-round W (densified for the dense kernels) and mask
    n = CHURN_DENSE_N
    problem, client_batch, batches = main_setup(dev, n=n)
    support = sp_lib.sparse_exp(n)
    small = {}
    for i, family in enumerate(st_lib.TOPOLOGY_FAMILIES):
        w_fn = sp_lib.make_sparse_w_sampler(family, support, seed=20 + i,
                                            edge_prob=0.5, device=dev)
        mask_fn = st_lib.make_participation_sampler(n, 20 + i, PARTICIPATION,
                                                    device=dev)
        res = {}
        zero_launch_counts()
        for impl in ("sparse_packed", "pallas_packed", "fused_round"):
            fn = (w_fn if impl == "sparse_packed"
                  else (lambda r, f=w_fn: sp_lib.densify(f(r))))
            before = launch_counts()
            state, _ = drive(problem, client_batch, batches, "kgt_minimax",
                             impl, dev, CHURN_DENSE_ROUNDS, n=n,
                             topology="exp", w_fn=fn, mask_fn=mask_fn)
            after = launch_counts()
            res[impl] = (state, {k: after[k] - before[k] for k in after})
        errs = {impl: compare_states(res[impl][0], res["sparse_packed"][0],
                                     f"churn n={n} {family} {impl} vs "
                                     "sparse_packed")
                for impl in ("pallas_packed", "fused_round")}
        # a round is one pair call: one stripe launch (sparse_packed), or
        # two launches of B1's tiled route, its route past n = 8
        # (pallas_packed)
        want = {"sparse_packed": {"fused_gossip": 0, "fused_round": 0,
                                  "sparse_gossip": CHURN_DENSE_ROUNDS},
                "pallas_packed": {"fused_gossip": 2 * CHURN_DENSE_ROUNDS,
                                  "fused_round": 0, "sparse_gossip": 0},
                "fused_round": {"fused_gossip": 0,
                                "fused_round": CHURN_DENSE_ROUNDS,
                                "sparse_gossip": 0}}
        want = {impl: {**w, **NO_MODEL_KERNELS} for impl, w in want.items()}
        got = {impl: res[impl][1] for impl in res}
        if got != want:
            fail(f"churn n={n} {family}: launches {got}, expected {want}")
        total = {k: sum(w[k] for w in want.values())
                 for k in want["fused_round"]}
        check_routes(route_counts(), total, f"churn n={n} {family}",
                     route_of={"fused_gossip": gossip.route(n)})
        small[family] = errs
        emit({"phase": "scale", "n": n, "churn": family,
              "participation": PARTICIPATION, "rounds": CHURN_DENSE_ROUNDS,
              "max_state_err_vs_sparse_packed": errs, "launches": got})
    out["churn_dense_limit"] = small
    del problem, client_batch, batches
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: captured chunks against eager ones, checkpoint resume
# ---------------------------------------------------------------------------

def strip_stamps(history) -> list:
    """History records without their clock stamps."""
    return [{k: v for k, v in rec.items()
             if k not in ("wall_s", "build_s", "capture_s", "run_s")}
            for rec in history]


def graph_case(problem, client_batch, batches, algo, impl, dev, *, rounds,
               chunk, what, smi, phase="graph", **kw) -> dict:
    """One case run eagerly (``capture=False``) and captured, from the same
    state: final states and histories bit for bit (``dense``, whose cuBLAS
    GEMMs may take another algorithm under capture, within
    TOL_GRAPH_DENSE × (1 + max|eager|) if not), launches by route equal."""
    import torch

    from repro_torch import engine as engine_lib

    runs = {}
    for capture in (False, True):
        state, build = prepare(problem, client_batch, batches, algo, impl,
                               dev, log_every=GRAPH_LOG, capture=capture, **kw)
        zero_launch_counts()
        final, hist = engine_lib.run(state, build, total_rounds=rounds,
                                     chunk_rounds=chunk)
        torch.cuda.synchronize()
        runs[capture] = (final, strip_stamps(hist), launch_counts(),
                         {**route_counts(), **compressed_counts()},
                         dict(build.stats))
    (s0, h0, l0, r0, _), (s1, h1, l1, r1, stats) = runs[False], runs[True]
    if (l0, r0) != (l1, r1):
        fail(f"graph {what}: launches {l1} by route {r1}, eager {l0} {r0}")
    check_finite(s1, f"graph {what}")
    exact = (s0.round == s1.round and h0 == h1
             and all(bitwise_equal(getattr(s0, k), getattr(s1, k))
                     for k in state_fields(s0)))
    rel = max([rel_err(getattr(s1, k), getattr(s0, k))
               for k in ("x", "y", "cx", "cy")]
              + [abs(a[m] - b[m]) / (1 + abs(b[m]))
                 for a, b in zip(h1, h0) for m in a if m != "round"])
    if not exact and (impl != "dense" or len(h0) != len(h1)
                      or rel > TOL_GRAPH_DENSE):
        fail(f"graph {what}: captured differs from eager (rel {rel})")
    out = {"phase": phase, "case": what, "algorithm": algo,
           "mixing_impl": impl, "rounds": rounds, "chunk_rounds": chunk,
           "bit_for_bit": exact, "max_rel_err": rel,
           "launches": l1, "launches_by_route": r1,
           "captures": stats["captures"], "replays": stats["replays"],
           "capture_s": stats["capture_s"], "draw_s": stats["draw_s"],
           "nvidia_smi": smi}
    emit(out)
    return out


def graph_rates(problem, client_batch, batches, impl, dev, rounds, **kw):
    """rounds/s of one chunk of ``rounds`` (kgt_minimax), eager and
    captured (an eager turn, then a graph turn: one of each, for the
    script's time limit), each builder run once
    first; the capture seconds, and the draws' host seconds a round."""
    import torch

    from repro_torch import engine as engine_lib

    builders = {}
    for capture in (False, True):
        state, build = prepare(problem, client_batch, batches, "kgt_minimax",
                               impl, dev, log_every=rounds, capture=capture,
                               **kw)
        engine_lib.run(state, build, total_rounds=rounds, chunk_rounds=rounds)
        builders[capture] = (state, build)
    capture_s = builders[True][1].stats["capture_s"]
    rates = {False: [], True: []}
    draw0 = builders[True][1].stats["draw_s"]
    for capture in (False, True):
        state, build = builders[capture]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine_lib.run(state, build, total_rounds=rounds, chunk_rounds=rounds)
        torch.cuda.synchronize()
        rates[capture].append(rounds / (time.perf_counter() - t0))
    draw_s = (builders[True][1].stats["draw_s"] - draw0) / rounds
    return {"eager": rates[False], "graph": rates[True],
            "capture_s": capture_s, "draw_host_s_per_round": draw_s}


def checkpoint_case(problem, client_batch, batches, impl, dev, what, smi,
                    phase="graph", **kw) -> dict:
    """Run GRAPH_CKPT_ROUNDS rounds with checkpoints every
    GRAPH_CKPT_EVERY (``boundary_every``), restore the first into a fresh
    template and run on, in chunks that do not align: the final state must
    be the uninterrupted one bit for bit."""
    import tempfile

    import torch

    from repro_torch import engine as engine_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.core import tree as tree_lib

    state, build = prepare(problem, client_batch, batches, "kgt_minimax",
                           impl, dev, **kw)
    with tempfile.TemporaryDirectory() as d:
        hook = engine_lib.checkpoint_hook(d, every=GRAPH_CKPT_EVERY)
        full, _ = engine_lib.run(state, build,
                                 total_rounds=GRAPH_CKPT_ROUNDS,
                                 chunk_rounds=4, hooks=[hook],
                                 boundary_every=GRAPH_CKPT_EVERY)
        names = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
        path = os.path.join(d, f"round_{GRAPH_CKPT_EVERY:06d}.npz")
        template = tree_lib.tree_map(
            lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor)
            else 0, state)
        restored = ckpt_lib.restore(path, template)
    if restored.round != GRAPH_CKPT_EVERY:
        fail(f"checkpoint {what}: restored round {restored.round}")
    resumed, _ = engine_lib.run(restored, build,
                                total_rounds=GRAPH_CKPT_ROUNDS,
                                chunk_rounds=7)
    exact = resumed.round == full.round and all(
        bitwise_equal(getattr(resumed, k), getattr(full, k))
        for k in state_fields(full))
    out = {"phase": phase, "checkpoint": what, "mixing_impl": impl,
           "files": names, "resumed_bit_for_bit": exact,
           "captures": build.stats["captures"], "nvidia_smi": smi}
    emit(out)
    if not exact:
        fail(f"checkpoint {what}: the resumed run differs")
    return out


def phase_graph(dev, smi) -> dict:
    import torch

    from repro_torch.core import sparse_topology as sp_lib
    from repro_torch.core import stochastic_topology as st_lib

    out = {"cases": [], "rates": {}}
    problem, client_batch, batches = main_setup(dev)
    for algo in ALGOS:
        for impl in ("dense", "pallas_packed", "fused_round"):
            out["cases"].append(graph_case(
                problem, client_batch, batches, algo, impl, dev,
                rounds=GRAPH_ROUNDS, chunk=GRAPH_CHUNK,
                what=f"n={N} {algo}/{impl}", smi=smi))
    for impl in ("dense", "pallas_packed", "fused_round"):
        out["rates"][f"n={N} {impl}"] = graph_rates(
            problem, client_batch, batches, impl, dev, ROUNDS)
    for impl, kw in (("fused_round", {}),
                     ("pallas_packed", dict(
                         w_fn=st_lib.make_w_sampler("erdos_renyi", N, 5,
                                                    device=dev),
                         mask_fn=st_lib.make_participation_sampler(
                             N, 5, PARTICIPATION, device=dev)))):
        checkpoint_case(problem, client_batch, batches, impl, dev,
                        f"n={N} {impl}{' churn' if kw else ''}", smi, **kw)
    del problem, client_batch, batches

    n = SCALE_N
    problem, client_batch, batches = main_setup(dev, n=n)
    support = sp_lib.sparse_exp(n)
    w_dense = sp_lib.densify(support.to(dev))
    common = dict(n=n, topology="exp")
    for impl, w in (("sparse_packed", None), ("dense", w_dense)):
        out["cases"].append(graph_case(
            problem, client_batch, batches, "kgt_minimax", impl, dev,
            rounds=SCALE_ROUNDS, chunk=GRAPH_CHUNK, w=w,
            what=f"n={n} exp {impl}", smi=smi, **common))
        out["rates"][f"n={n} {impl}"] = graph_rates(
            problem, client_batch, batches, impl, dev, SCALE_ROUNDS, w=w,
            **common)
    del w_dense
    family = "erdos_renyi"
    w_fn = sp_lib.make_sparse_w_sampler(family, support, seed=30,
                                        edge_prob=0.5, device=dev)
    mask_fn = st_lib.make_participation_sampler(n, 30, PARTICIPATION,
                                                device=dev)
    out["cases"].append(graph_case(
        problem, client_batch, batches, "kgt_minimax", "sparse_packed", dev,
        rounds=CHURN_ROUNDS, chunk=5, w_fn=w_fn, mask_fn=mask_fn,
        what=f"n={n} churn {family} p={PARTICIPATION}", smi=smi,
        **common))
    for what, r in out["rates"].items():
        emit({"phase": "graph", "rounds_per_s": what, **r,
              "nvidia_smi": smi,
              "note": "kgt_minimax, one chunk, host clock to a synchronize, "
                      "an eager turn, then a graph turn"})
    del problem, client_batch, batches
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: the sweep driver on the card
# ---------------------------------------------------------------------------

def sweep_launch_check(impl, launches, routes) -> None:
    """A convergence sweep on ``impl``: the kernel of its lowering launched
    (replays of captured cells), every launch on the route ``ops.ROUTED``
    names, and no other kernel."""
    want = {"fused_round": "fused_round", "pallas_packed": "fused_gossip"}
    kernel = want.get(impl)
    for name, k in launches.items():
        if (name == kernel) != (k > 0):
            fail(f"sweep {impl}: {name} launched {k} times")
    if kernel is not None:
        check_routes(routes, launches, f"sweep {impl}")


def same_result(a, b) -> bool:
    """(rounds to ε, final ‖∇Φ‖) pairs equal, a NaN final (a diverged
    trajectory) equal to a NaN."""
    return a[0] == b[0] and (a[1] == b[1] or (math.isnan(a[1])
                                              and math.isnan(b[1])))


def cut_seeds(spec, seeds: int):
    """``spec`` with its ``seed`` axis cut to its first ``seeds`` values."""
    import dataclasses

    from repro_torch.sweep import grid as grid_lib

    axes = tuple(grid_lib.batch_axis("seed", *a.values[:seeds])
                 if a.name == "seed" else a for a in spec.axes)
    return dataclasses.replace(spec, axes=axes)


def phase_sweep(dev, smi) -> dict:
    import dataclasses
    import tempfile

    from repro_torch.sweep import defs
    from repro_torch.sweep import grid as grid_lib
    from repro_torch.sweep import run as sweep_run

    out = {}
    base = cut_seeds(defs.SWEEPS["convergence"], SWEEP_SEEDS)
    for impl in ("dense", "fused_round", "pallas_packed"):
        spec = dataclasses.replace(base, base={**base.base,
                                               "mixing_impl": impl})
        zero_launch_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            res = sweep_run.run_sweep(spec, device=dev, store_dir=d)
        wall = time.perf_counter() - t0
        launches, routes = launch_counts(), route_counts()
        sweep_launch_check(impl, launches, routes)
        # every point again, sequentially
        t1 = time.perf_counter()
        mismatched = []
        for cell in spec.cells():
            for p in cell.points:
                hit, final, _, _ = sweep_run.run_point(p, device=dev)
                rec = res["points"][grid_lib.point_key(p)]
                if (hit, final) != (rec["rounds_to_eps"], rec["final_grad"]):
                    mismatched.append([grid_lib.point_key(p), hit, final,
                                       rec["rounds_to_eps"],
                                       rec["final_grad"]])
        point_wall = time.perf_counter() - t1
        summary = {a: sweep_run.summarize(sweep_run.points_where(
            res, algorithm=a)) for a in ALGOS}
        cells = {key: {k: c[k] for k in ("wall_s", "build_s", "capture_s",
                                         "setup_s", "run_s",
                                         "trajectory_rounds")}
                 for key, c in res["cells"].items()}
        traj_rounds = sum(c["trajectory_rounds"] for c in cells.values())
        run_s = sum(c["run_s"] for c in cells.values())
        out[impl] = {"summary": summary, "wall_s": wall}
        emit({"phase": "sweep", "sweep": "convergence", "mixing_impl": impl,
              "points": len(res["points"]), "wall_s": wall,
              "capture_s": sum(c["capture_s"] for c in cells.values()),
              "run_s": run_s, "trajectory_rounds": traj_rounds,
              "trajectory_rounds_per_s": traj_rounds / run_s,
              "cells": cells, "summary": summary,
              "run_point_wall_s": point_wall,
              "run_cell_vs_run_point_mismatches": mismatched,
              "launches": launches, "launches_by_route": routes,
              "nvidia_smi": smi})
        if mismatched:
            fail(f"sweep {impl}: run_cell and run_point differ at "
                 f"{len(mismatched)} points")
        if not (summary["kgt_minimax"]["hit_rate"]
                >= summary["local_sgda"]["hit_rate"]):
            fail(f"sweep {impl}: kgt_minimax hits ε less often than "
                 f"local_sgda ({summary})")

    # churn on dense, n = 8, beside the reference's committed results
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        res = sweep_run.run_sweep(defs.SWEEPS["churn"], device=dev,
                                  store_dir=d)
    wall = time.perf_counter() - t0
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "results", "sweeps", "churn.json")) as f:
        ref = json.load(f)
    by_family = {}
    for family in ("static", "erdos_renyi", "pairwise", "dropout"):
        by_family[family] = {
            "port": sweep_run.summarize(sweep_run.points_where(
                res, topology_family=family)),
            "reference": sweep_run.summarize(sweep_run.points_where(
                ref, topology_family=family))}
    emit({"phase": "sweep", "sweep": "churn", "mixing_impl": "dense",
          "points": len(res["points"]), "wall_s": wall,
          "by_family": by_family, "nvidia_smi": smi,
          "note": "the port's data and draws are its own: a statistical "
                  "comparison, not a check"})
    out["churn"] = by_family
    return out


# ---------------------------------------------------------------------------
# phase 12: compressed gossip (error feedback) at the main geometry
# ---------------------------------------------------------------------------

def wire_spy(impl, seen: list):
    """Context: every transmit of a round step on ``impl`` is checked on
    the card's own v = mask ⊙ (Δ + e): q == Q(v), q + e' == v bit for bit,
    inactive rows keep e.  On ``pallas_packed`` it wraps
    ``core.compression.ef_transmit``; on ``fused_round`` it runs the
    whole-round kernel through ``fused_round_wire`` (the same launch, with
    q returned), and holds v against the plain K steps.  ``seen`` gets one
    record a transmit."""
    import contextlib

    import torch

    from repro_torch.core import compression
    from repro_torch.kernels import fused_round, ops, quantize, ref

    def check(v, q, e_new, e_old, act, method, what):
        if not (torch.equal(q, quantize.quantize_dequant(v, method))
                and torch.equal(torch.where(act, q + e_new, v), v)
                and torch.equal(torch.where(act, e_new, e_old), e_new)):
            fail(f"compress wire {what}: q + e' != v or q != Q(v)")

    @contextlib.contextmanager
    def spy():
        if impl == "pallas_packed":
            orig = compression.ef_transmit

            def transmit(d, e, method, mask=None):
                q, e_new = orig(d, e, method, mask)
                act = (torch.ones(d.shape[0], dtype=torch.bool,
                                  device=d.device) if mask is None
                       else mask.to(torch.bool))[:, None]
                v = (d.float() + e.float()) * act.float()
                check(v, q, e_new, e, act, method, impl)
                seen.append({"max_abs_q": float(q.abs().max()),
                             "max_abs_e": float(e_new.abs().max())})
                return q, e_new

            compression.ef_transmit = transmit
            try:
                yield
            finally:
                compression.ef_transmit = orig
        else:
            orig = ops.fused_round

            def whole_round(w, z0, c, ef, g, h, step, etas, corr, mask, *,
                            backend="auto", compress=None,
                            gossip_dtype=None):
                args = [t.float().contiguous() for t in
                        (w, z0, c, ef, g, h, step, etas, corr, mask)]
                kz, kc, ke, kq = fused_round.fused_round_wire(
                    *args, compress=compress, gossip_dtype=gossip_dtype)
                act = args[-1] > 0
                v = torch.where(act, kq + ke, torch.zeros_like(kq))
                check(v, kq, ke, args[3], act, compress, impl)
                _, _, pd = ref.local_steps_ref(*args[1:4], args[4], args[5],
                                               args[6], args[9],
                                               compress=compress)
                plain_v = args[9] * (pd + args[3])
                err = rel_err(v, plain_v)
                if err > TOL_ROUND:
                    fail(f"compress wire {impl}: v misses the plain K "
                         f"steps by {err}")
                seen.append({"max_abs_q": float(kq.abs().max()),
                             "max_abs_e": float(ke.abs().max()),
                             "v_rel_err_vs_plain": err})
                return kz, kc, ke

            ops.fused_round = whole_round
            try:
                yield
            finally:
                ops.fused_round = orig

    return spy()


def phase_compress(dev, smi) -> dict:
    """Compressed gossip at the main geometry on the two lowerings that take
    it: the wire per round (eager), the same runs through captured chunks
    with B2's compressed launches counted by route, Σc = 0, int8 against
    the exact trajectory, the freeze under participation, a checkpoint
    resume, and rounds/s."""
    import torch

    from repro_torch import engine as engine_lib
    from repro_torch.core import stochastic_topology as st_lib

    problem, client_batch, batches = main_setup(dev)
    cases = [(a, i, m) for a in TRACKING for i in COMPRESS_IMPLS
             for m in COMPRESS_METHODS]

    # 1. eager rounds with every transmit checked on the card
    eager = {}
    for algo, impl, method in cases:
        seen: list = []
        with wire_spy(impl, seen):
            eager[algo, impl, method] = drive(
                problem, client_batch, batches, algo, impl, dev, ROUNDS,
                capture=False, cfg_kw={"gossip_compress": method})
        per_round = 2 if impl == "pallas_packed" else 1
        if len(seen) != ROUNDS * per_round:
            fail(f"compress {algo}/{impl}/{method}: {len(seen)} transmits "
                 f"checked, expected {ROUNDS * per_round}")
        emit({"phase": "compress", "wire": f"{algo}/{impl}/{method}",
              "rounds": ROUNDS, "transmits_checked_bitwise": len(seen),
              "max_abs_e": max(r["max_abs_e"] for r in seen),
              "max_v_rel_err_vs_plain": max(
                  (r.get("v_rel_err_vs_plain", 0.0) for r in seen)),
              "bitwise": "q == Q(v), q + e' == v, inactive rows keep e"})

    # 2. the compressed path through captured chunks, counted
    zero_launch_counts()
    captured = {c: drive(problem, client_batch, batches, c[0], c[1], dev,
                         ROUNDS, cfg_kw={"gossip_compress": c[2]})
                for c in cases}
    launches, routes = launch_counts(), route_counts()
    comp = compressed_counts()
    per_impl = ROUNDS * len(TRACKING) * len(COMPRESS_METHODS)
    expect = {"fused_gossip": per_impl, "fused_round": per_impl,
              "sparse_gossip": 0, **NO_MODEL_KERNELS}
    if launches != expect:
        fail(f"compress launches {launches}, expected {expect}")
    check_routes(routes, expect, "compress")
    want_comp = {"fused_round_compressed": {"cluster": per_impl, "block": 0}}
    if comp != want_comp:
        fail(f"compress: B2's compressed launches by route {comp}, "
             f"expected {want_comp}")
    results = {}
    for c in cases:
        (se, he), (sg, hg) = eager[c], captured[c]
        what = "/".join(c)
        check_finite(sg, f"compress {what}")
        exact = (strip_stamps(he) == strip_stamps(hg) and all(
            bitwise_equal(getattr(se, k), getattr(sg, k))
            for k in state_fields(se)))
        sc = sigma_c(sg)
        results[what] = {"captured_bit_for_bit_eager": exact,
                         "sigma_c": sc,
                         "phi_grad_norm_last": hg[-1]["phi_grad_norm"],
                         "ef_norms": [float(sg.ef_x.norm()),
                                      float(sg.ef_y.norm())]}
        if not exact:
            fail(f"compress {what}: the captured run differs from eager")
        if not sc <= TOL_SIGMA_C:
            fail(f"compress {what}: Σc = {sc} > {TOL_SIGMA_C}")
    emit({"phase": "compress", "cases": results, "launches": launches,
          "expected": expect, "launches_by_route": routes,
          "compressed_launches_by_route": comp["fused_round_compressed"],
          "tol_sigma_c": TOL_SIGMA_C})

    # 3. int8 against the exact trajectory (the reference's
    # test_compressed_vs_exact_divergence_bounded), both lowerings
    divergence = {}
    for impl in COMPRESS_IMPLS:
        ex, _ = drive(problem, client_batch, batches, "kgt_minimax", impl,
                      dev, COMPRESS_DIVERGENCE_ROUNDS)
        q8, _ = drive(problem, client_batch, batches, "kgt_minimax", impl,
                      dev, COMPRESS_DIVERGENCE_ROUNDS,
                      cfg_kw={"gossip_compress": "int8"})
        divergence[impl] = {k: float((getattr(ex, k) - getattr(q8, k)).abs()
                                     .max() / (getattr(ex, k).abs().max()
                                               + 1e-12))
                            for k in ("x", "y")}
        if max(divergence[impl].values()) >= TOL_COMPRESS_DIVERGENCE:
            fail(f"compress {impl}: int8 drifts from the exact trajectory "
                 f"by {divergence[impl]}")
    emit({"phase": "compress", "rounds": COMPRESS_DIVERGENCE_ROUNDS,
          "int8_vs_exact_rel": divergence, "tol": TOL_COMPRESS_DIVERGENCE})

    # 4. participation: inactive clients keep θ, c and the residual
    freeze = {}
    for impl in COMPRESS_IMPLS:
        mask_fn = st_lib.make_participation_sampler(N, 7, PARTICIPATION,
                                                    device=dev)
        state, build = prepare(problem, client_batch, batches,
                               "kgt_minimax", impl, dev, mask_fn=mask_fn,
                               cfg_kw={"gossip_compress": "int8"})
        frozen, inactive = [], []
        final, _ = engine_lib.run(
            state, build, total_rounds=CHURN_ROUNDS, chunk_rounds=1,
            hooks=[freeze_hook(mask_fn, state, frozen, inactive)])
        sc = sigma_c(final)
        freeze[impl] = {"inactive_client_rounds": sum(inactive),
                        "frozen_bit_for_bit": all(frozen), "sigma_c": sc}
        if not all(frozen) or not sum(inactive):
            fail(f"compress {impl}: inactive clients moved ({freeze})")
        if not sc <= TOL_SIGMA_C:
            fail(f"compress {impl} under participation: Σc = {sc}")
    emit({"phase": "compress", "participation": PARTICIPATION,
          "rounds": CHURN_ROUNDS, "freeze": freeze})

    # 5. a checkpoint resume of a compressed state
    for impl in COMPRESS_IMPLS:
        checkpoint_case(problem, client_batch, batches, impl, dev,
                        f"n={N} {impl} int8", smi, phase="compress",
                        cfg_kw={"gossip_compress": "int8"})

    # 6. rounds/s, exact and compressed, eager and captured in turns
    rates = {}
    for impl in COMPRESS_IMPLS:
        for method in (None, *COMPRESS_METHODS):
            rates[f"{impl} {method or 'exact'}"] = graph_rates(
                problem, client_batch, batches, impl, dev, ROUNDS,
                cfg_kw={"gossip_compress": method})
    for what, r in rates.items():
        emit({"phase": "compress", "rounds_per_s": what, **r,
              "nvidia_smi": smi,
              "note": "kgt_minimax, one 50-round chunk, host clock to a "
                      "synchronize, an eager turn, then a graph turn"})
    del problem, client_batch, batches
    torch.cuda.empty_cache()
    return {"launches": launches, "routes": routes,
            "compressed": comp["fused_round_compressed"], "rates": rates}


# ---------------------------------------------------------------------------
# phase 13: the adversary axis and robust aggregation
# ---------------------------------------------------------------------------

def attack_fn(n, attack, dev, *, num_byzantine=ADV_BYZANTINE, seed=0):
    """The engine's per-round adversary: ``num_byzantine`` attackers,
    ``attack`` at ADV_SCALE, noise shaped as the main geometry's x, y."""
    import torch

    from repro_torch.core import adversary

    like = (torch.empty((n, DX), device="meta"),
            torch.empty((n, DY), device="meta"))
    return adversary.make_attack_sampler(
        n, seed, num_byzantine=num_byzantine, attack=attack,
        scale=ADV_SCALE, like=like, device=dev)


def robust_spy(seen: list):
    """Context: each robust aggregation a round step makes is held against
    ``kernels.ref.robust_agg_ref`` on the same candidates, within
    TOL_ROBUST × (1 + max|oracle|)."""
    import contextlib

    import torch

    from repro_torch.core import mixing
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import gossip_torch_dtype, narrow

    dense, sparse = mixing.robust_mix_dense, mixing.robust_mix_sparse

    def held(vals, valid, out, rule, trim, what):
        want = ref.robust_agg_ref(vals, valid, rule=rule, trim=trim)
        fin = torch.isfinite(want)
        if not torch.equal(torch.isfinite(out), fin):
            fail(f"robust {what} {rule}: non-finite entries differ")
        err = rel_err(out[fin], want[fin])
        seen.append(err)
        if err > TOL_ROBUST:
            fail(f"robust {what} {rule}: {err} from robust_agg_ref")

    def robust_dense(buf, w, *, rule, trim=1, gossip_dtype=None):
        out = dense(buf, w, rule=rule, trim=trim, gossip_dtype=gossip_dtype)
        n = w.shape[0]
        valid = (w > 0) | torch.eye(n, dtype=torch.bool, device=w.device)
        b = narrow(buf, gossip_torch_dtype(gossip_dtype))
        held(b[None].expand(n, n, b.shape[1]), valid, out, rule, trim,
             "dense")
        return out

    def robust_sparse(buf, sp, *, rule, trim=1, gossip_dtype=None):
        out = sparse(buf, sp, rule=rule, trim=trim,
                     gossip_dtype=gossip_dtype)
        b = narrow(buf, gossip_torch_dtype(gossip_dtype))
        vals = torch.cat([b[:, None], b[sp.neighbor_idx.long()]], 1)
        valid = torch.cat([torch.ones_like(sp.neighbor_w[:, :1],
                                           dtype=torch.bool),
                           sp.neighbor_w > 0], 1)
        held(vals, valid, out, rule, trim, "sparse")
        return out

    @contextlib.contextmanager
    def spy():
        mixing.robust_mix_dense = robust_dense
        mixing.robust_mix_sparse = robust_sparse
        try:
            yield
        finally:
            mixing.robust_mix_dense, mixing.robust_mix_sparse = dense, sparse

    return spy()


def one_round(problem, client_batch, batches, algo, impl, dev, adv=None,
              n=N, topology="ring"):
    """One round step from ``init_state`` on fixed noise, with the
    adversary ``adv`` (or the plain step without one)."""
    import torch

    from repro_torch.core import init_state, make_round_step

    cfg = main_cfg(algo, impl, n, K, topology)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = init_state(problem, cfg, gen, init_batch=client_batch)
    gen.manual_seed(2)
    noise = torch.randn((K, n, problem.noise_dim), generator=gen,
                        device=dev)
    step = make_round_step(problem, cfg, byzantine=adv is not None,
                           device=dev)
    extras = () if adv is None else (adv,)
    return step(state, batches, noise, *extras)


def phase_adversary(dev, smi) -> dict:
    """The Byzantine adversary and the robust aggregations: one round per
    attack and lowering at n = 8 (an honest adversary is the plain step bit
    for bit, Σc = 0 under attack on the linear lowerings, every robust
    aggregation against its oracle), captured chunks against eager ones
    under attack, the sparse robust forms at n = 4096 on the exponential
    graph, then the ``adversary`` sweep beside the reference's results."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.core import adversary
    from repro_torch.sweep import defs
    from repro_torch.sweep import grid as grid_lib
    from repro_torch.sweep import run as sweep_run

    problem, client_batch, batches = main_setup(dev)
    # 1. one round per attack and lowering
    agg_errs: list = []
    rounds = {}
    with robust_spy(agg_errs):
        for impl in ADV_IMPLS:
            plain = one_round(problem, client_batch, batches, "kgt_minimax",
                              impl, dev)
            honest = attack_fn(N, "random_noise", dev, num_byzantine=0)(0)
            same = one_round(problem, client_batch, batches, "kgt_minimax",
                             impl, dev, honest)
            if not all(torch.equal(getattr(plain, k), getattr(same, k))
                       for k in ("x", "y", "cx", "cy")):
                fail(f"adversary {impl}: an honest adversary is not the "
                     "plain step bit for bit")
            for attack in adversary.ATTACKS[1:]:
                st = one_round(problem, client_batch, batches, "kgt_minimax",
                               impl, dev, attack_fn(N, attack, dev)(0))
                rec = {"sigma_c": sigma_c(st),
                       "max_abs_x": float(st.x.abs().max())}
                rounds[f"{impl}/{attack}"] = rec
                if impl in ("dense", "pallas_packed") and not (
                        rec["sigma_c"] <= TOL_SIGMA_C):
                    fail(f"adversary {impl}/{attack}: Σc = "
                         f"{rec['sigma_c']}")
    emit({"phase": "adversary", "n": N, "one_round": rounds,
          "honest_adversary_bit_for_bit_plain": True,
          "robust_aggregations_checked": len(agg_errs),
          "robust_max_rel_err_vs_oracle": max(agg_errs),
          "tol_robust": TOL_ROBUST, "tol_sigma_c": TOL_SIGMA_C})
    if not agg_errs:
        fail("adversary: no robust aggregation was checked")

    # 2. captured chunks against eager ones under attack
    for impl in ("coord_median", "trimmed_mean", "pallas_packed"):
        for attack in ("sign_flip", "random_noise"):
            graph_case(problem, client_batch, batches, "kgt_minimax", impl,
                       dev, rounds=GRAPH_ROUNDS, chunk=GRAPH_CHUNK,
                       what=f"n={N} {impl} {attack}", smi=smi,
                       phase="adversary", attack_fn=attack_fn(N, attack,
                                                              dev))
    rates = {}
    for impl in ("dense", "coord_median", "trimmed_mean"):
        rates[f"n={N} {impl} sign_flip"] = graph_rates(
            problem, client_batch, batches, impl, dev, ROUNDS,
            attack_fn=attack_fn(N, "sign_flip", dev))
    del problem, client_batch, batches

    # 3. the sparse robust forms at n = 4096 on the exponential graph
    n = SCALE_N
    problem, client_batch, batches = main_setup(dev, n=n)
    common = dict(n=n, topology="exp")
    fn = attack_fn(n, "sign_flip", dev, num_byzantine=n // 64)
    for impl in ("sparse_trimmed_mean", "sparse_coord_median"):
        case = graph_case(problem, client_batch, batches, "kgt_minimax",
                          impl, dev, rounds=SCALE_ROUNDS, chunk=GRAPH_CHUNK,
                          what=f"n={n} exp {impl} sign_flip", smi=smi,
                          phase="adversary", attack_fn=fn, **common)
        if any(case["launches"].values()):
            fail(f"adversary {impl}: launched kernels {case['launches']}")
    for impl in ("sparse_trimmed_mean", "sparse_coord_median",
                 "sparse_packed"):
        rates[f"n={n} {impl} sign_flip"] = graph_rates(
            problem, client_batch, batches, impl, dev, SCALE_ROUNDS,
            attack_fn=fn, **common)
    for what, r in rates.items():
        emit({"phase": "adversary", "rounds_per_s": what, **r,
              "nvidia_smi": smi,
              "note": "kgt_minimax, one chunk, host clock to a "
                      "synchronize, an eager turn, then a graph turn"})
    del problem, client_batch, batches
    torch.cuda.empty_cache()

    # 4. the adversary sweep (its seeds cut), every point again by run_point
    spec = cut_seeds(defs.SWEEPS["adversary"], ADV_SWEEP_SEEDS)
    zero_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        res = sweep_run.run_sweep(spec, device=dev, store_dir=d)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if any(launches.values()):
        fail(f"adversary sweep: launched kernels {launches} (dense and the "
             "robust rules run none)")
    mismatched = []
    t1 = time.perf_counter()
    for cell in spec.cells():
        for p in cell.points:
            hit, final, _, _ = sweep_run.run_point(p, device=dev)
            rec = res["points"][grid_lib.point_key(p)]
            if not same_result((hit, final),
                               (rec["rounds_to_eps"], rec["final_grad"])):
                mismatched.append([grid_lib.point_key(p), hit, final,
                                   rec["rounds_to_eps"], rec["final_grad"]])
    point_wall = time.perf_counter() - t1
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "results", "sweeps", "adversary.json")) as f:
        ref = json.load(f)
    groups = {}
    for impl in ("dense", "coord_median", "trimmed_mean"):
        for attack in adversary.ATTACKS:
            sel = dict(mixing_impl=impl, attack=attack)
            port = sweep_run.points_where(res, **sel)
            if not port:
                continue
            refs = sweep_run.points_where(ref, **sel)
            groups[f"{impl}/{attack}"] = {
                "port": sweep_run.summarize(port),
                "reference": sweep_run.summarize(refs),
                "port_rounds_to_eps": [p["rounds_to_eps"] for p in port],
                "reference_rounds_to_eps": [p["rounds_to_eps"]
                                            for p in refs]}
    cells = {key: {k: c[k] for k in ("wall_s", "capture_s", "run_s",
                                     "trajectory_rounds")}
             for key, c in res["cells"].items()}
    traj_rounds = sum(c["trajectory_rounds"] for c in cells.values())
    run_s = sum(c["run_s"] for c in cells.values())
    emit({"phase": "adversary", "sweep": "adversary",
          "points": len(res["points"]), "wall_s": wall, "run_s": run_s,
          "trajectory_rounds": traj_rounds,
          "trajectory_rounds_per_s": traj_rounds / run_s, "cells": cells,
          "by_impl_attack": groups, "run_point_wall_s": point_wall,
          "run_cell_vs_run_point_mismatches": mismatched,
          "nvidia_smi": smi,
          "note": "the port's data and draws are its own: beside the "
                  "reference's results/sweeps/adversary.json a statistical "
                  "comparison, a miss is printed, not failed"})
    if mismatched:
        fail(f"adversary sweep: run_cell and run_point differ at "
             f"{len(mismatched)} points")
    return {"rates": rates, "groups": groups}


# ---------------------------------------------------------------------------
# phase 14: health gauges and a profiler window
# ---------------------------------------------------------------------------

def phase_obs(dev, smi) -> dict:
    """``obs.health_gauges`` on a compressed state, and one ``obs.Profiler``
    window over 10 captured rounds (of 20, in chunks of 5) that must write
    a non-empty trace."""
    import tempfile

    from repro_torch import engine as engine_lib
    from repro_torch import obs

    problem, client_batch, batches = main_setup(dev)
    state, build = prepare(problem, client_batch, batches, "kgt_minimax",
                           "fused_round", dev, log_every=5,
                           cfg_kw={"gossip_compress": "int8"})
    with tempfile.TemporaryDirectory() as d:
        prof = obs.Profiler(os.path.join(d, "trace"), num_rounds=10)
        closed = []

        def watch(st, records, prev_round):
            if not prof.active and not closed:
                closed.append(int(st.round))

        prof.start()
        final, _ = engine_lib.run(state, build, total_rounds=20,
                                  chunk_rounds=5, hooks=[prof.hook, watch])
        prof.stop()
        if len(prof.paths) != 1:
            fail(f"obs: the profiler wrote {prof.paths}")
        size = os.path.getsize(prof.paths[0])
        with open(prof.paths[0]) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    gauges = obs.health_gauges(final)
    out = {"phase": "obs", "trace_bytes": size, "trace_events": len(events),
           "trace_kernel_events": len(kernels),
           "trace_kernel_names": sorted({e.get("name", "")[:40]
                                         for e in kernels})[:8],
           "window_closed_at_round": closed, "health_gauges": gauges,
           "nvidia_smi": smi}
    emit(out)
    if not events or closed != [10]:
        fail(f"obs: empty trace or a window closed at {closed}")
    if not ({"ef_x_norm", "ef_y_norm"} <= set(gauges)
            and all(math.isfinite(v) for v in gauges.values())):
        fail(f"obs: health gauges {gauges}")
    return out


# ---------------------------------------------------------------------------
# phase 9: serving recurrentgemma-9b and mamba2-1.3b at full width
# ---------------------------------------------------------------------------

def rel_err(got, want) -> float:
    """max |got − want| / (1 + max |want|), in f32."""
    got, want = got.float(), want.float()
    return max_err(got, want) / (1 + float(want.abs().max()))


def kernel_category(name: str) -> str:
    """The profiles' buckets: the model kernels, f32 GEMMs (the RG-LRU
    gates), the other (bf16) GEMMs, dtype copies, everything else."""
    for kernel, cat in (("flash_attention_kernel", "flash_attention"),
                        ("flash_attention_tc_kernel", "flash_attention"),
                        ("rglru_scan_kernel", "rglru_scan"),
                        ("rglru_chunked_kernel", "rglru_scan"),
                        ("ssd_scan_kernel", "ssd_scan"),
                        ("ssd_tc_kernel", "ssd_scan"),
                        ("ssd_cb_kernel", "ssd_scan"),
                        ("fused_ce_kernel", "fused_cross_entropy"),
                        ("fused_ce_tc_kernel", "fused_cross_entropy")):
        if kernel in name:
            return cat
    low = name.lower()
    if "sgemm" in low or "f32f32" in low:
        return "gemm_f32"
    if any(t in low for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "gemm_bf16"
    if "copy" in low:
        return "copy"
    return "other"


def profile_device(fn) -> dict:
    """torch.profiler around ``fn()``: wall µs, device busy µs (kernel
    events), and busy µs by kernel category."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    by = {}
    for e in events:
        cat = kernel_category(e.key)
        by[cat] = by.get(cat, 0.0) + e.self_device_time_total
    busy = sum(by.values())
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    return {"wall_us": wall_us, "device_busy_us": busy,
            "device_busy_share": busy / wall_us, "busy_us_by_kind": by,
            "kernels": sum(e.count for e in events),
            "top": [[e.key[:90], e.self_device_time_total, e.count]
                    for e in top]}


def serve_launches(cfg) -> dict:
    """Each model kernel's launches in one prefill of ``cfg``: one a layer
    that runs it."""
    from repro_torch.models import transformer as tf

    kinds = cfg.blocks()
    return {**NO_MODEL_KERNELS,
            "flash_attention": sum(kinds.count(k) for k in tf.ATTN_KINDS),
            "rglru_scan": kinds.count("rglru"),
            "ssd_scan": kinds.count("ssm")}


def serve_one(dev, arch, batch, prompt_len, gen_tokens) -> dict:
    """``launch.serve.serve`` on ``arch`` at full width in bf16, then its
    checks: the prefill against the same prefill through the plain versions
    (logits and every cache), prefill + decode against the plain full
    forward (``kernels=False``), the kernels' launches (one a layer in the
    prefill, none in decode), and finiteness; then a profile of a warm
    prefill and of decode steps."""
    import torch

    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib

    torch.cuda.reset_peak_memory_stats()
    # the serve path's launch counts: set to 0 just before, read just after
    zero_launch_counts()
    res = serve_lib.serve(arch, batch=batch, prompt_len=prompt_len,
                          gen_tokens=gen_tokens, device=dev, seed=0)
    launches = launch_counts()
    routes = route_counts()
    check_backward_launches(0, f"serve {arch}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model, cfg = res.model, res.model.cfg
    zeros = {k: 0 for k in launches}
    want_prefill = {**zeros, **serve_launches(cfg)}
    if res.launches["prefill"] != want_prefill or launches != want_prefill:
        fail(f"serve {arch} launches {res.launches}, total {launches}; "
             f"expected {want_prefill} in the prefill")
    if res.launches["decode"] != zeros:
        fail(f"serve {arch}: kernels launched during decode: "
             f"{res.launches}")
    # the bf16 prefill's attention launches all on the tensor-core route
    check_routes(routes, want_prefill, f"serve {arch}")
    if not torch.isfinite(res.logits.float()).all():
        fail(f"serve {arch}: non-finite logits")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        fail(f"serve {arch}: a token outside the vocabulary")

    errs = {}
    total = prompt_len + gen_tokens
    with torch.no_grad():
        # the same prefill through the plain versions of the kernels
        caches = model_lib.init_cache(cfg, batch, total, device=dev)
        plain, plain_caches, _ = model_lib.forward(
            model, {"tokens": res.prompt}, mode="prefill", caches=caches,
            last_only=True, kernels=False)
        errs["prefill_logits_vs_plain"] = rel_err(res.logits[:, :1], plain)
        cache_errs = {}
        for c, p in zip(res.prefill_caches, plain_caches):
            for name in c:
                cache_errs[name] = max(cache_errs.get(name, 0.0),
                                       rel_err(c[name], p[name]))
        errs["prefill_caches_vs_plain"] = max(cache_errs.values())
        errs["prefill_caches_vs_plain_by_name"] = cache_errs
        del plain_caches, caches
        # prefill + decode against the plain forward over prompt + new
        # tokens
        seq = torch.cat([res.prompt, res.tokens], dim=1)
        hidden, _, _ = model_lib.backbone(model, {"tokens": seq},
                                          mode="prefill", kernels=False)
        full = model_lib.lm_head(model, hidden[:, prompt_len - 1:],
                                 torch.bfloat16)
        del hidden
        errs["decode_logits_vs_full_forward"] = rel_err(res.logits, full)
        errs["decode_logits_vs_full_forward_by_position"] = [
            rel_err(res.logits[:, i], full[:, i])
            for i in range(full.shape[1])]
        diff = (res.logits.float() - full.float()).norm(dim=-1)
        errs["decode_logits_rel_l2_max"] = float(
            (diff / full.float().norm(dim=-1)).max())
        errs["argmax_agreement"] = float(
            (res.logits.argmax(-1) == full.argmax(-1)).float().mean())
        # the bf16 noise floor without any kernel: the plain prefill's last
        # logits against the same position of the plain forward over the
        # longer sequence (the same math on GEMMs of other shapes)
        errs["plain_vs_plain_other_length"] = rel_err(plain, full[:, :1])
        del full
        f32_errs, plain_f32 = serve_f32_checks(model, res.prompt[:2], dev)
        errs.update(f32_errs)
        decode_graph = decode_capture_check(model, res.prompt, gen_tokens,
                                            dev, what=f"serve {arch}")
        # the model's own bf16 error: the bf16 prefills (plain, kernel)
        # against the plain f32 prefill, first two prompts
        errs["plain_bf16_vs_f32"] = rel_err(plain[:2], plain_f32)
        errs["kernel_bf16_vs_f32"] = rel_err(res.logits[:2, :1], plain_f32)
        del plain, plain_f32
    tol = TOL_SERVE_BF16[arch]
    for key in ("prefill_logits_vs_plain", "prefill_caches_vs_plain",
                "decode_logits_vs_full_forward"):
        if not errs[key] <= tol:
            emit({"phase": "serve", "arch": arch, "failed": key, **errs})
            fail(f"serve {arch}: {key} = {errs[key]} > {tol}")
    for key in ("prefill_logits_vs_plain_f32",
                "decode_logits_vs_full_forward_f32"):
        if not errs[key] <= TOL_SERVE_F32:
            emit({"phase": "serve", "arch": arch, "failed": key, **errs})
            fail(f"serve {arch}: {key} = {errs[key]} > {TOL_SERVE_F32}")

    # a warm prefill and a few decode steps under the profiler
    def prefill():
        c = model_lib.init_cache(cfg, batch, total, device=dev)
        return model_lib.forward(model, {"tokens": res.prompt},
                                 mode="prefill", caches=c, last_only=True)

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, warm_caches, _ = prefill()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        prof_prefill = profile_device(prefill)
        toks = res.tokens

        def decode4():
            c = warm_caches
            for i in range(4):
                _, c = model_lib.decode_step(model, c, toks[:, i:i + 1],
                                             prompt_len + i)

        prof_decode = profile_device(decode4)
    n_params = model_lib.param_count(model)
    weight_gb = 2 * n_params / 1e9
    # a decode step reads every weight once but the embedding, of which it
    # gathers B rows — unless the embedding is also the (tied) head
    gathered_gb = (0.0 if cfg.tie_embeddings
                   else 2 * cfg.vocab_size * cfg.d_model / 1e9)
    out = {"prefill_s": res.prefill_s, "prefill_warm_s": warm_s,
           "decode_ms_per_token": 1e3 * res.decode_s / gen_tokens,
           "tokens_per_s": batch * gen_tokens / res.decode_s,
           "prefill_tokens_per_s": batch * prompt_len / warm_s,
           "peak_memory_gb": peak_gb, "params": n_params,
           "weights_gb_bf16": weight_gb,
           "decode_bound_ms": (weight_gb - gathered_gb) / HBM_BYTES_S * 1e12,
           **decode_graph,
           "launches": res.launches, "launches_by_route": routes, **errs,
           "tol": tol,
           "tol_f32": TOL_SERVE_F32}
    emit({"phase": "serve", "arch": arch, "batch": batch,
          "prompt_len": prompt_len, "gen_tokens": gen_tokens, **out})
    emit({"phase": "serve", "arch": arch, "profile": "prefill (warm)",
          **prof_prefill})
    emit({"phase": "serve", "arch": arch, "profile": "4 decode steps",
          "per_step_us": prof_decode["wall_us"] / 4, **prof_decode})
    del res, model, warm_caches
    torch.cuda.empty_cache()
    return out


def decode_capture_check(model, prompt, gen_tokens: int, dev, *,
                         what: str) -> dict:
    """``launch.serve.generate`` on ``prompt`` eagerly and through its
    captured decode step (``capture=False`` / ``True``), each from a
    generator seeded alike: the logits and tokens bit for bit, and the
    decode ms/token of both (the captured step's capture apart)."""
    import torch

    from repro_torch.launch import serve as serve_lib

    runs = {}
    for capture in (False, True):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        runs[capture] = serve_lib.generate(model, prompt, gen_tokens,
                                           generator=gen, capture=capture)
    eager, graph = runs[False], runs[True]
    if not (torch.equal(eager.logits, graph.logits)
            and torch.equal(eager.tokens, graph.tokens)):
        fail(f"{what}: the captured decode differs from the eager one by "
             f"{max_err(graph.logits.float(), eager.logits.float())}")
    return {"decode_ms_per_token_eager": 1e3 * eager.decode_s / gen_tokens,
            "decode_ms_per_token_captured":
                1e3 * graph.decode_s / gen_tokens,
            "decode_capture_s": graph.capture_s,
            "decode_captured_equals_eager": True}


def serve_f32_checks(model, prompt, dev, gen_tokens: int = 8) -> dict:
    """The serve path's kernels and caches computed in f32 (bf16 weights,
    f32 activations), where rounding cannot hide a fault: the greedy
    prefill + decode of ``prompt`` against the plain full forward, and the
    kernel prefill against the plain prefill.  Returns (errors, the plain
    f32 prefill's last logits)."""
    import torch

    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib

    f32 = torch.float32
    b, prompt_len = prompt.shape
    res = serve_lib.generate(model, prompt, gen_tokens, temperature=0.0,
                             compute_dtype=f32)
    seq = torch.cat([prompt, res.tokens], dim=1)
    with torch.no_grad():
        hidden, _, _ = model_lib.backbone(model, {"tokens": seq},
                                          mode="prefill", compute_dtype=f32,
                                          kernels=False)
        full = model_lib.lm_head(model, hidden[:, prompt_len - 1:], f32)
        del hidden
        plain, _, _ = model_lib.forward(
            model, {"tokens": prompt}, mode="prefill", compute_dtype=f32,
            caches=model_lib.init_cache(model.cfg, b, prompt_len + gen_tokens,
                                        dtype=f32, device=dev),
            last_only=True, kernels=False)
    return ({"prefill_logits_vs_plain_f32": rel_err(res.logits[:, :1], plain),
             "decode_logits_vs_full_forward_f32": rel_err(res.logits, full),
             "f32_check_shape": [b, prompt_len, gen_tokens]}, plain)


def phase_serve(dev) -> dict:
    """The serving path on both served models: recurrentgemma-9b (4 prompts
    of 4096 tokens, through B5 and B8) and mamba2-1.3b (8 prompts of 4096
    tokens, through B7), SERVE_GEN and MAMBA_GEN (16) new tokens each."""
    return {SERVE_ARCH: serve_one(dev, SERVE_ARCH, SERVE_B, SERVE_PROMPT,
                                  SERVE_GEN),
            MAMBA_ARCH: serve_one(dev, MAMBA_ARCH, MAMBA_B, MAMBA_PROMPT,
                                  MAMBA_GEN)}


# ---------------------------------------------------------------------------
# phase 19 (right after serve): continuous batching at full width
# ---------------------------------------------------------------------------

def sched_requests(cfg, *, requests, prompt, new, seed=SCHED_SEED) -> list:
    """``requests`` requests drawn from a numpy seed: prompt lengths in
    ``prompt``, new tokens in ``new`` (both inclusive), random tokens
    ((P, C) codebook rows for an audio model), the temperatures
    SCHED_TEMPS in turn; as keyword dicts of ``serving.Request``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    out = []
    for uid in range(requests):
        p = int(rng.integers(prompt[0], prompt[1] + 1))
        out.append(dict(uid=uid,
                        prompt=rng.integers(0, cfg.vocab_size, (p, *cb)),
                        max_new_tokens=int(rng.integers(new[0], new[1] + 1)),
                        temperature=SCHED_TEMPS[uid % len(SCHED_TEMPS)]))
    return out


def sched_engine(model, reqs, *, slots, max_len, capture,
                 compute_dtype=None):
    import torch

    from repro_torch.serving import Request, ServingEngine

    eng = ServingEngine(model, num_slots=slots, max_len=max_len,
                        seed=SCHED_SEED, capture=capture,
                        compute_dtype=compute_dtype or torch.bfloat16)
    for r in reqs:
        eng.submit(Request(**r))
    return eng


def sched_serve(model, reqs, *, slots, max_len, capture) -> dict:
    """``reqs`` through a ServingEngine run to its end (as ``run`` does),
    every tick's samples kept: the engine, the samples, the run's seconds
    (host clock to a synchronize; the capture apart) and its ticks."""
    import torch

    eng = sched_engine(model, reqs, slots=slots, max_len=max_len,
                       capture=capture)
    sampled = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        n = eng.tick()
        if not n and not eng.queue:
            break
        sampled.append(eng.step.sampled.clone())
    torch.cuda.synchronize()
    return {"engine": eng, "sampled": sampled,
            "s": time.perf_counter() - t0, "ticks": eng._tick}


def sched_captured_against_eager(model, reqs, case, *, what) -> dict:
    """The same requests and noise (the engine's seed) eagerly and through
    the captured tick: every tick's samples, the outputs in retirement
    order, the final caches and logits bit for bit; ms a tick, tokens/s,
    capture s and peak memory of both, launches of the captured run."""
    import torch

    kw = dict(slots=case["slots"], max_len=case["max_len"])
    runs, peaks, final = {}, {}, {}
    for capture in (False, True):
        torch.cuda.reset_peak_memory_stats()
        # the scheduler path's launch counts: set to 0 just before, read
        # just after
        zero_launch_counts()
        run = sched_serve(model, reqs, capture=capture, **kw)
        run["launches"] = launch_counts()
        peaks[capture] = torch.cuda.max_memory_allocated() / 1e9
        eng = run.pop("engine")
        run["capture_s"] = eng.step.capture_s
        run["done"] = {uid: r.output for uid, r in eng.done.items()}
        final[capture] = ([{k: v.clone() for k, v in c.items()}
                           for c in eng.caches], eng.step.logits.clone())
        if capture:
            # the device's time a tick: the graph replayed alone (CUDA
            # events), on the finished engine's buffers
            run["replay_ms"] = cuda_ms(eng.step, reps=11)
        runs[capture] = run
        del eng
    eager, graph = runs[False], runs[True]
    same = (eager["ticks"] == graph["ticks"]
            and list(eager["done"]) == list(graph["done"])
            and all((eager["done"][u] == graph["done"][u]).all()
                    for u in eager["done"])
            and all(torch.equal(a, b) for a, b in zip(eager["sampled"],
                                                      graph["sampled"]))
            and torch.equal(final[False][1], final[True][1])
            and all(torch.equal(a[k], b[k])
                    for a, b in zip(final[False][0], final[True][0])
                    for k in a))
    if not same:
        fail(f"{what}: the captured ticks differ from the eager ones")
    if graph["launches"] != {k: 0 for k in graph["launches"]}:
        fail(f"{what}: kernels launched on the decode path: "
             f"{graph['launches']}")
    gen = sum(len(o) for o in graph["done"].values())
    prompt = sum(len(r["prompt"]) for r in reqs)
    if len(graph["done"]) != len(reqs):
        fail(f"{what}: {len(graph['done'])} of {len(reqs)} requests done")
    return {"ticks": graph["ticks"], "requests": len(reqs),
            "generated_tokens": gen, "prompt_tokens": prompt,
            "ms_a_tick_eager": 1e3 * eager["s"] / eager["ticks"],
            "ms_a_tick_captured": 1e3 * graph["s"] / graph["ticks"],
            "generated_tokens_per_s_eager": gen / eager["s"],
            "generated_tokens_per_s_captured": gen / graph["s"],
            "prompt_tokens_per_s_eager": prompt / eager["s"],
            "prompt_tokens_per_s_captured": prompt / graph["s"],
            "run_s_eager": eager["s"], "run_s_captured": graph["s"],
            "capture_s": graph["capture_s"],
            "replay_device_ms": graph["replay_ms"],
            "peak_memory_gb_eager": peaks[False],
            "peak_memory_gb_captured": peaks[True],
            "launches": graph["launches"],
            "captured_equals_eager": True}


def sched_f32_check(model, arch) -> dict:
    """SCHED_F32's requests through a ServingEngine in f32 compute (bf16
    weights; captured, or for a MoE model eagerly, so that its expert
    choices are recorded: the captured tick is the eager one bit for
    bit), every request's
    logits at each of its ticks against the plain full forward of its
    prompt and outputs from position 0 (a MoE model's at capacity factor
    MOE_DROPLESS_FACTOR, its expert sets compared too): the errors of
    requests admitted into a fresh slot and of those in a reused one
    apart (a recurrent state carries over: ROADMAP §C quirk 6)."""
    import torch

    from repro_torch.models import model as model_lib

    f32 = torch.float32
    cfg = model.cfg
    case = SCHED_F32
    reqs = sched_requests(cfg, requests=case["requests"],
                          prompt=case["prompt"], new=case["new"])
    moe = "moe" in cfg.blocks()
    eng = sched_engine(model, reqs, slots=case["slots"],
                       max_len=case["max_len"], capture=not moe,
                       compute_dtype=f32)
    seen = []     # per tick: ({slot: (uid, position)}, logits (S, [C,] V))
    fresh, used = {}, set()
    with (routing_recorder() if moe else contextlib.nullcontext([])) as dec:
        while True:
            eng._admit()
            who = {}
            for i, slot in enumerate(eng.slots):
                if slot.request is not None:
                    uid = slot.request.uid
                    who[i] = (uid, slot.pos)
                    fresh.setdefault(uid, i not in used)
                    used.add(i)
            n = eng.tick()
            if not n and not eng.queue:
                break
            seen.append((who, eng.step.logits[:, 0].clone()))
    n_moe = cfg.blocks().count("moe")
    errs, flips = {}, 0
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_DROPLESS_FACTOR)) if moe else cfg
    model.cfg = dropless
    try:
        with torch.no_grad():
            for uid, req in eng.done.items():
                seq = torch.cat([torch.as_tensor(reqs[uid]["prompt"]),
                                 torch.as_tensor(req.output[:-1])])
                with (routing_recorder() if moe
                      else contextlib.nullcontext([])) as full_routes:
                    full, _, _ = model_lib.forward(
                        model, {"tokens": seq[None].to(model.embed.device)},
                        mode="prefill", compute_dtype=f32, kernels=False)
                err, top = 0.0, 1 + float(full.abs().max())
                for t, (who, logits) in enumerate(seen):
                    for i, (u, p) in who.items():
                        if u != uid:
                            continue
                        err = max(err, max_err(logits[i], full[0, p]) / top)
                        for layer in range(n_moe):
                            got = dec[t * n_moe + layer][i, 0].sort().values
                            want = full_routes[layer][0, p].sort().values
                            flips += int(not torch.equal(got, want))
                errs[uid] = err
    finally:
        model.cfg = cfg
    fresh_errs = [e for u, e in errs.items() if fresh[u]]
    reused_errs = [e for u, e in errs.items() if not fresh[u]]
    return {"requests": len(reqs), "slots": case["slots"],
            "ticks": eng._tick, "err_fresh_slot": max(fresh_errs),
            "err_reused_slot": max(reused_errs, default=None),
            "err_by_request": errs,
            "fresh_slot": [u for u in errs if fresh[u]],
            "routing_flips": flips if moe else None}


def scheduler_case(dev, arch, case, *, smi) -> dict:
    """``arch`` at full width (bf16 weights from seed 0) behind the
    continuous-batching engine: captured against eager, then the f32
    check (held at TOL_SERVE_F32 for every request, or, where a recurrent
    state carries over, for those admitted into a fresh slot)."""
    import gc

    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model as model_lib

    cfg = registry.get_model_config(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = model_lib.init_params(cfg, generator=gen, device=dev,
                                  dtype=torch.bfloat16)
    what = f"scheduler {arch}"
    if case["requests"] <= case["slots"]:
        # FIFO admission: every request past the slots' count enters a
        # slot that another request left
        fail(f"{what}: {case['requests']} requests on {case['slots']} "
             "slots admit none into a reused slot")
    reqs = sched_requests(cfg, requests=case["requests"],
                          prompt=case["prompt"], new=case["new"])
    with torch.no_grad():
        out = sched_captured_against_eager(model, reqs, case, what=what)
        f32 = sched_f32_check(model, arch)
    carries = any(k in cfg.blocks() for k in ("ssm", "rglru"))
    held = f32["err_fresh_slot"] if carries else max(
        f32["err_fresh_slot"], f32["err_reused_slot"] or 0.0)
    res = {"phase": "scheduler", "arch": arch, "nvidia_smi": smi,
           "slots": case["slots"], "max_len": case["max_len"],
           "prompt_len": list(case["prompt"]), "new_tokens": list(case["new"]),
           "reused_slot_admissions": case["requests"] - case["slots"],
           **out, "f32": f32, "f32_held": held,
           "f32_held_requests": "fresh slots only" if carries else "all",
           "tol_f32": TOL_SERVE_F32}
    emit(res)
    if not held <= TOL_SERVE_F32:
        fail(f"{what}: f32 logits against the full forward {held} > "
             f"{TOL_SERVE_F32}")
    if f32["routing_flips"]:
        fail(f"{what}: {f32['routing_flips']} expert sets differ from the "
             f"full forward's in f32")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_scheduler(dev, smi) -> dict:
    """The continuous-batching engine at full width on SCHED_CASES."""
    return {arch: scheduler_case(dev, arch, case, smi=smi)
            for arch, case in SCHED_CASES}


# ---------------------------------------------------------------------------
# phase 10: evaluating mamba2-1.3b at full width
# ---------------------------------------------------------------------------

def phase_evaluate(dev) -> dict:
    """``launch.evaluate.evaluate`` on mamba2-1.3b at full width in bf16:
    ``group_metrics`` on one batch of 4 × 4096 tokens for each of 4 clients,
    through B7 (48 a call) and B6 (1 a call); each client's group losses
    against the plain route (the plain scan and the reference's bf16-logit
    cross-entropy), finiteness, seconds and tokens/s a client batch, peak
    memory, and a profile of one warm call."""
    import torch

    from repro_torch.evaluation.metrics import group_metrics
    from repro_torch.launch import evaluate as eval_lib

    torch.cuda.reset_peak_memory_stats()
    # the evaluate path's launch counts: set to 0 just before, read after
    zero_launch_counts()
    res = eval_lib.evaluate(MAMBA_ARCH, clients=EVAL_CLIENTS, batch=EVAL_B,
                            seq_len=EVAL_S, num_groups=EVAL_GROUPS,
                            device=dev, seed=0)
    launches = launch_counts()
    routes = route_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = res.model
    n_ssm = model.cfg.blocks().count("ssm")
    want = {**{k: 0 for k in launches}, "ssd_scan": n_ssm,
            "fused_cross_entropy": 1}
    total = {k: v * EVAL_CLIENTS for k, v in want.items()}
    if any(got != want for got in res.launches) or launches != total:
        fail(f"evaluate launches {res.launches}, total {launches}; expected "
             f"{want} a client")
    # every cross-entropy launch of group_metrics on the tensor-core route
    check_routes(routes, total, "evaluate")
    errs, worst_same = [], []
    for i, (b, m) in enumerate(zip(res.batches, res.metrics)):
        for key in ("group_loss", "mean_loss", "worst_group_loss"):
            if not bool(torch.isfinite(m[key]).all()):
                fail(f"evaluate client {i}: {key} not finite")
        plain = group_metrics(model, b, num_groups=EVAL_GROUPS,
                              kernels=False)
        err = rel_err(m["group_loss"], plain["group_loss"])
        errs.append(err)
        worst_same.append(int(m["worst_group"]) == int(plain["worst_group"]))
        if not err <= TOL_EVAL:
            fail(f"evaluate client {i}: group losses differ from the plain "
                 f"route by {err} > {TOL_EVAL} × (1 + max)")
        emit({"phase": "evaluate", "client": i,
              "group_loss": m["group_loss"].tolist(),
              "group_loss_plain": plain["group_loss"].tolist(),
              "groups_present": int(m["groups_present"]),
              "mean_loss": float(m["mean_loss"]),
              "worst_group": int(m["worst_group"]),
              "worst_group_loss": float(m["worst_group_loss"]),
              "err_vs_plain": err, "seconds": res.seconds[i],
              "tokens_per_s": EVAL_B * EVAL_S / res.seconds[i],
              "launches": res.launches[i]})
    warm_s = time_host(lambda: group_metrics(
        model, res.batches[0], num_groups=EVAL_GROUPS))
    plain_s = time_host(lambda: group_metrics(
        model, res.batches[0], num_groups=EVAL_GROUPS, kernels=False))
    prof = profile_device(lambda: group_metrics(
        model, res.batches[0], num_groups=EVAL_GROUPS))
    out = {"seconds": res.seconds, "warm_s": warm_s, "plain_route_s": plain_s,
           "tokens_per_s_warm": EVAL_B * EVAL_S / warm_s,
           "peak_memory_gb": peak_gb, "max_err_vs_plain": max(errs),
           "worst_group_same_as_plain": worst_same, "launches": launches,
           "launches_by_route": routes, "tol": TOL_EVAL}
    emit({"phase": "evaluate", "arch": MAMBA_ARCH, "clients": EVAL_CLIENTS,
          "batch": EVAL_B, "seq_len": EVAL_S, "groups": EVAL_GROUPS, **out})
    emit({"phase": "evaluate", "profile": "group_metrics (warm)", **prof})
    del res, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 15: federated DRO training of qwen2-0.5b at full width
# ---------------------------------------------------------------------------

def train_args(**over):
    """``launch.train``'s flags at the reference's train defaults (n = 4
    on a ring, K = 4, batch 4 × 128 tokens a client, 8 groups,
    kgt_minimax on dense) on qwen2-0.5b at full width, with ``over``."""
    from repro_torch.launch import train as train_lib

    args = train_lib.parser().parse_args(["--arch", TRAIN_ARCH])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def tree_rel_err(got, want) -> float:
    """max |got − want| / (1 + max |want|) over every tensor leaf of two
    trees."""
    from repro_torch.core import tree as tree_lib

    import torch

    err = top = 0.0
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(want)):
        if not isinstance(a, torch.Tensor):
            continue
        err = max(err, max_err(a.float(), b.float()))
        top = max(top, float(b.float().abs().max()))
    return err / (1.0 + top)


def to_host(tree):
    """Every tensor leaf of a tree copied to host memory."""
    import torch

    from repro_torch.core import tree as tree_lib

    return tree_lib.tree_map(
        lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, tree)


def trees_equal(a, b) -> bool:
    """Every leaf bit for bit (host values equal)."""
    import torch

    from repro_torch.core import tree as tree_lib

    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(
        bitwise_equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def train_launches(cfg, *, n, k, rounds, logged) -> dict:
    """The model kernels' launches of ``rounds`` rounds of the DRO training
    path: the initial corrections' gradient and each local step's vmapped
    gradient launch each layer's kernel once (B5, B7 or B8: the clients
    folded into its batch) and B6 once a client (each client's own head);
    each logged row runs three forwards of x̄ (f(x̄, ȳ), the train groups,
    the held-out groups), each once a layer and once."""
    grads = 1 + rounds * k
    per_layer = serve_launches(cfg)
    return {**{name: per_layer[name] * (grads + 3 * logged)
               for name in per_layer},
            "fused_cross_entropy": ce_launches(cfg) * (n * grads
                                                       + 3 * logged)}


def ce_launches(cfg) -> int:
    """B6's launches for one batch: one a codebook (one with none)."""
    return max(1, cfg.num_codebooks)


def model_routes(compute_dtype, args=None, cfg=None) -> dict:
    """The route each routed model kernel takes in training: B5 and B6 on
    tensor cores in bf16 and on CUDA cores in f32; B7's f32 operands on
    tensor cores either way; B8's, where ``args`` trains ``cfg``, by its
    rule at the clients folded into the batch, (n·B, S, W)."""
    import torch

    from repro_torch.kernels import rglru_scan

    route = "tensor_core" if compute_dtype == torch.bfloat16 else "cuda_core"
    out = {"flash_attention": route, "fused_cross_entropy": route,
           "ssd_scan": "tensor_core"}
    if args is not None:
        out["rglru_scan"] = rglru_scan.route(
            args.clients * args.batch, args.seq_len,
            cfg.rglru.channels(cfg.d_model))
    return out


def check_backward_launches(want, what) -> dict:
    """Fail unless B8's backward kernel launched ``want`` times (one a
    forward launch under a gradient; none without)."""
    from repro_torch.kernels import ops

    got = ops.backward_launch_counts()
    if got != {"rglru_scan": want}:
        fail(f"{what}: backward launches {got}, expected {want} of "
             "rglru_scan")
    return got


def grad_checks(dev, smi, args, *, phase, tol_bf16) -> dict:
    """One local step's per-client gradients (``vmap(grad)`` of the DRO
    value at the initial parameters and a random positive ȳ — at the
    initial ȳ = 0 the x-gradient is 0 —, the first round's k = 0 batch) of
    the run ``args`` builds, through the kernels and through the plain
    route, in f32 compute (within TOL_TRAIN_F32) and in bf16 (within
    ``tol_bf16``, x and y), with the kernels' launches by route.  A MoE
    model's plain route runs twice: routing itself (its flips against the
    kernel route's routings counted; in f32 there must be none, and its
    gradients are held too) and replaying the kernel route's expert
    choices (``routing_replay``), which the limits hold in both dtypes."""
    import torch

    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.core import objectives
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib

    trainer = train_lib.build(args)
    batches, noise = trainer.sampler(0)[:2]
    batch = {key: v[0] for key, v in batches.items()}
    x, cfg = trainer.state.x, trainer.cfg
    moe = cfg.arch_type == "moe"
    # ȳ from a generator of its own, so that a check reads the same
    # whichever phases ran before it
    y_gen = torch.Generator(device=dev)
    y_gen.manual_seed(0)
    y = torch.rand(trainer.state.y.shape, generator=y_gen, device=dev)
    del trainer, batches         # the corrections: GBs the check needs not
    out = {}
    runs = ("kernel", "plain") + (("replayed",) if moe else ())
    held = "replayed" if moe else "plain"
    for dt, tol in ((torch.float32, (TOL_TRAIN_F32, TOL_TRAIN_F32)),
                    (torch.bfloat16, tol_bf16)):
        peaks, secs, seen, errs = {}, {}, {}, {}
        kern = None
        for run in runs:
            problem = objectives.dro_problem(
                cfg, num_groups=args.groups, mu=args.mu, compute_dtype=dt,
                kernels=run == "kernel")
            zero_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with (routing_replay(seen["kernel"]) if run == "replayed"
                  else routing_recorder()) as seen[run]:
                g = kgt._vgrads(problem, x, y, batch, noise[0])
            torch.cuda.synchronize()
            secs[run] = time.perf_counter() - t0
            peaks[run] = torch.cuda.max_memory_allocated() / 1e9
            if run == "kernel":
                launches, routes = launch_counts(), route_counts()
                backward = check_backward_launches(
                    launches["rglru_scan"], f"{phase} grads ({dt})")
            elif any(launch_counts().values()):
                fail(f"{phase} grads ({dt}): the plain route launched "
                     f"{launch_counts()}")
            else:
                check_backward_launches(0, f"{phase} grads ({dt}, {run})")
            for leaf in tree_lib.leaves(g):
                if not bool(leaf.isfinite().all()):
                    fail(f"{phase} grads ({dt}, {run}): not finite")
            if run == "kernel":
                # waits in host memory while the plain route runs
                kern = to_host(g)
                del g
                continue
            if kern[1].device.type == "cpu":
                kern = tree_lib.tree_map(
                    lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    else t, kern)
            errs[run] = (tree_rel_err(kern[0], g[0]),
                         tree_rel_err(kern[1], g[1]))
            if run == held:
                max_x = max(float(t.abs().max())
                            for t in tree_lib.leaves(g[0]))
                max_y = float(g[1].abs().max())
            del g
        del kern
        want = {**dict.fromkeys(launches, 0), **serve_launches(cfg),
                "fused_cross_entropy": args.clients * ce_launches(cfg)}
        if launches != want:
            fail(f"{phase} grads ({dt}): launches {launches}, expected "
                 f"{want}")
        routed = {k: v for k, v in model_routes(dt, args, cfg).items()
                  if want[k]}
        check_routes({k: routes[k] for k in routed}, want,
                     f"{phase} grads ({dt})", route_of=routed)
        err_x, err_y = errs[held]
        res = {"compute_dtype": str(dt).split(".")[-1],
               "routes": routed, "rel_err_x": err_x, "rel_err_y": err_y,
               "tol_x": tol[0], "tol_y": tol[1],
               "launches": launches, "backward_launches": backward,
               "launches_by_route": {k: routes[k] for k in ops.ROUTED
                                     if k in routed},
               "kernel_route_s": secs["kernel"],
               "plain_route_s": secs["plain"],
               "peak_memory_gb_kernel_route": peaks["kernel"],
               "peak_memory_gb_plain_route": peaks["plain"],
               "max_abs_grad_x": max_x, "max_abs_grad_y": max_y}
        if moe:
            res.update(held_against="the plain route replaying the kernel "
                       "route's expert choices",
                       rel_err_x_own_routing=errs["plain"][0],
                       rel_err_y_own_routing=errs["plain"][1],
                       routing_flips=routing_flips(
                           seen["kernel"], seen["plain"], cfg))
        emit({"phase": phase, "check": "per-client gradients",
              "arch": cfg.name, "layers": len(cfg.blocks()),
              "clients": args.clients, "nvidia_smi": smi, **res})
        if not (err_x <= tol[0] and err_y <= tol[1]):
            fail(f"{phase} grads ({dt}): kernels vs plain {err_x}, {err_y} "
                 f"> {tol} × (1 + max)")
        if moe and dt == torch.float32 and (
                res["routing_flips"]["choices"]
                or res["routing_flips"]["tokens"]
                or not max(errs["plain"]) <= TOL_TRAIN_F32):
            fail(f"{phase} grads (f32): the routes routed differently or "
                 f"their gradients differ: {res}")
        out[res["compute_dtype"]] = res
        torch.cuda.empty_cache()
    return out


def train_kernel_times(gen, dev) -> dict:
    """B5 and B6 at the train path's shapes in bf16: B5 on the vmapped
    local step's (n·B, S, 14, 2, 64) causal, B6 on one client's (B·S, 896)
    hidden states against the tied (151 936, 896) head.  Each kernel's
    output, on its tensor-core route, is held against its plain version
    (TOL_ATTN_BF16, TOL_CE); then its forward, its plain forward, its
    backward (the plain version's gradient, what the autograd Functions
    run), the PyTorch call beside it, and the forward's bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import registry
    from repro_torch.kernels import cross_entropy, flash_attention, ref

    cfg = registry.get_model_config(TRAIN_ARCH)
    b, s = TRAIN_N * TRAIN_B, TRAIN_S
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = attn_operands(b, s, s, h, kv, d, torch.bfloat16, gen, dev)
    got = routed_call(lambda: flash_attention.flash_attention_bshd(
        q, k, v, causal=True), "flash_attention", "tensor_core")
    attn_err = rel_err(got, ref.attention_ref(q, k, v, causal=True))
    if not attn_err <= TOL_ATTN_BF16:
        fail(f"flash_attention at the train shape: {attn_err} > "
             f"{TOL_ATTN_BF16} × (1 + max)")
    del got
    do = torch.randn_like(q)
    ms = cuda_ms(lambda: flash_attention.flash_attention_bshd(
        q, k, v, causal=True), reps=21)
    pms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), reps=11)
    bwd_ms = cuda_ms(lambda: ref.attention_bwd_ref(q, k, v, do, causal=True),
                     reps=11)
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1)
              for x in (k, v))
    lms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=21)
    bound, by = attn_bound_ms(b, s, s, h, kv, d, 0, 2, BF16_FLOP_S)
    fa = dict(ms=ms, plain_ms=pms, backward_plain_ms=bwd_ms, library_ms=lms,
              bound_ms=bound, bound_by=by, shape=[b, s, h, kv, d],
              rel_err=attn_err, tol=TOL_ATTN_BF16)
    emit({"phase": "train", "kernel": "flash_attention", **fa,
          "library": "F.scaled_dot_product_attention(is_causal=True), k/v "
                     "expanded to 14 heads"})
    del q, k, v, do, qt, kt, vt
    n, dm, vocab = TRAIN_B * TRAIN_S, cfg.d_model, cfg.vocab_size
    hidden, w, labels = ce_operands(n, dm, vocab, torch.bfloat16, gen, dev)
    got = routed_call(lambda: cross_entropy.fused_ce_nd(hidden, w, labels),
                      "fused_cross_entropy", "tensor_core")
    ce_err = rel_err(got, ref.fused_ce_ref(hidden, w, labels))
    if not ce_err <= TOL_CE:
        fail(f"fused_cross_entropy at the train shape: {ce_err} > {TOL_CE} "
             "× (1 + max)")
    del got
    g = torch.rand((n,), generator=gen, device=dev)
    ms = cuda_ms(lambda: cross_entropy.fused_ce_nd(hidden, w, labels),
                 reps=21)
    pms = cuda_ms(lambda: ref.fused_ce_ref(hidden, w, labels), reps=11)
    bwd_ms = cuda_ms(lambda: ref.fused_ce_bwd_ref(hidden, w, labels, g),
                     reps=11)

    def lib():
        try:
            logits = torch.mm(hidden, w.T, out_dtype=torch.float32)
        except (TypeError, NotImplementedError, RuntimeError):
            logits = torch.mm(hidden, w.T).float()
        return F.cross_entropy(logits, labels, reduction="none")

    lms = cuda_ms(lib, reps=11)
    (bound, by), _ = ce_bound_ms(n, dm, vocab, 2)
    ce = dict(ms=ms, plain_ms=pms, backward_plain_ms=bwd_ms, library_ms=lms,
              bound_ms=bound, bound_by=by, shape=[n, dm, vocab],
              rel_err=ce_err, tol=TOL_CE)
    emit({"phase": "train", "kernel": "fused_cross_entropy", **ce,
          "library": "two calls: torch.mm(h, w.T, out_dtype=float32), then "
                     "F.cross_entropy(reduction='none')"})
    del hidden, w, labels, g
    torch.cuda.empty_cache()
    return {"flash_attention": fa, "fused_cross_entropy": ce}


def captured_against_eager(args_of, cfg, *, phase, smi) -> dict:
    """The main path of a training phase: ``launch.train`` at the flags
    ``args_of(...)`` gives, TRAIN_ROUNDS rounds in one captured chunk
    (``--engine scan``: one CUDA graph, the state donated to it), with the
    kernels' launches by route, finite rows and parameters; then the same
    rounds through the host loop (``--engine host``), bit for bit."""
    import gc

    import torch

    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import train as train_lib

    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    res = train_lib.train(args_of(rounds=TRAIN_ROUNDS, chunk=TRAIN_ROUNDS,
                                  log_every=1))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, routes = launch_counts(), route_counts()
    peak_graph = torch.cuda.max_memory_allocated() / 1e9
    n = res["state"].y.shape[0]
    want = train_launches(cfg, n=n, k=TRAIN_K, rounds=TRAIN_ROUNDS,
                          logged=TRAIN_ROUNDS)
    if launches != {**{k: 0 for k in launches}, **want}:
        fail(f"{phase}: launches {launches}, expected {want}")
    routed = {k: v for k, v in model_routes(torch.bfloat16).items()
              if want[k]}
    check_routes({k: routes[k] for k in routed}, want, phase,
                 route_of=routed)
    hist = res["history"]
    for rec in hist:
        for key in ("f_bar", "mean_loss", "eval_loss"):
            if not math.isfinite(rec[key]):
                fail(f"{phase} round {rec['round']}: {key} not finite")
        g = rec["eval_group_loss"]
        if len(g) != TRAIN_G or not all(math.isfinite(v) for v in g):
            fail(f"{phase} round {rec['round']}: eval_group_loss {g}")
    for leaf in tree_lib.leaves(res["state"].x):
        if not bool(leaf.isfinite().all()):
            fail(f"{phase}: a parameter is not finite")
    n_params = sum(p.numel() for p in tree_lib.leaves(res["state"].x))
    # the captured state waits in host memory while the eager run holds
    # the card
    graph_state = to_host(res["state"])
    graph_hist, capture_main_s = strip_stamps(hist), hist[-1]["capture_s"]
    del res, hist
    gc.collect()
    torch.cuda.empty_cache()

    # the eager reference: the host loop from the same seed
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    res = train_lib.train(args_of(engine="host", rounds=TRAIN_ROUNDS,
                                  log_every=1))
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated() / 1e9
    if (launch_counts(), route_counts()) != (launches, routes):
        fail(f"{phase}: eager launches {launch_counts()} {route_counts()}, "
             f"captured {launches} {routes}")
    eager_state, eager_hist = to_host(res["state"]), strip_stamps(
        res["history"])
    del res
    gc.collect()
    torch.cuda.empty_cache()
    exact = graph_hist == eager_hist and trees_equal(graph_state,
                                                     eager_state)
    rel = 0.0 if exact else max(tree_rel_err(graph_state, eager_state), max(
        abs(a[m] - b[m]) / (1 + abs(b[m]))
        for a, b in zip(graph_hist, eager_hist)
        for m in a if m not in ("round", "eval_group_loss")))
    if not exact and not rel <= TOL_GRAPH_DENSE:
        fail(f"{phase} capture: captured differs from eager (rel {rel})")
    del graph_state, eager_state
    per_layer = serve_launches(cfg)
    main = {"arch": cfg.name, "layers": len(cfg.blocks()), "clients": n,
            "rounds": TRAIN_ROUNDS, "engine": "scan",
            "bit_for_bit_with_eager": exact, "max_rel_err": rel,
            "capture_s": capture_main_s,
            "launches_a_round": {
                **{k: v * TRAIN_K for k, v in per_layer.items() if v},
                "fused_cross_entropy": n * TRAIN_K * ce_launches(cfg)},
            "launches_a_logged_row": {
                **{k: 3 * v for k, v in per_layer.items() if v},
                "fused_cross_entropy": 3 * ce_launches(cfg)},
            "seconds_incl_build": main_s,
            "peak_memory_gb_captured": peak_graph,
            "peak_memory_gb_eager": peak_eager,
            "client_stacked_params": n_params,
            "allocated_gb_after": torch.cuda.memory_allocated() / 1e9,
            "launches": launches, "launches_by_route": routes,
            "history": graph_hist}
    emit({"phase": phase, "case": f"main, n = {n}, --engine scan against "
          "--engine host", "nvidia_smi": smi, **main})
    return main


def train_rates(args, cfg, *, phase, smi, turns) -> dict:
    """rounds/s of ``args``'s run in ``turns`` (True: a captured chunk,
    False: an eager one) of TRAIN_ROUNDS rounds, each turn going on from
    the state the last one left; a captured chunk's pool and an eager
    chunk's working set need not fit the card together, so each captured
    turn captures afresh (untimed), times a replay and frees.  With the
    peak memory over the turns, and the launches of the first turn (every
    turn launches the same)."""
    import gc

    import torch

    from repro_torch import engine as engine_lib
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import train as train_lib

    torch.cuda.reset_peak_memory_stats()
    trainer = train_lib.build(args)
    # the state lives in this list alone, so that no frame holds the old
    # one (GBs) while a chunk advances it
    box, trainer.state = [trainer.state], None
    rates = {False: [], True: []}
    capture_s, draw_s = [], []
    launches = logged = None
    for c in turns:
        if c:
            # an eager chunk's new state lies in segments shared with the
            # blocks it freed (the capture's pool found no room beside
            # them); moved out and back it is compact
            host = to_host(box.pop())
            gc.collect()
            torch.cuda.empty_cache()
            box.append(tree_lib.tree_map(
                lambda x: x.to(args.device) if isinstance(x, torch.Tensor)
                else x, host))
            del host
        build = trainer.build_chunk(args, capture=c)

        def advance():
            total = box[0].round + TRAIN_ROUNDS
            new, hist = engine_lib.run(box.pop(), build, total_rounds=total,
                                       chunk_rounds=TRAIN_ROUNDS)
            box.append(new)
            return hist

        if c:
            advance()
            capture_s.append(build.stats["capture_s"])
            draw0 = build.stats["draw_s"]
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        hist = advance()
        torch.cuda.synchronize()
        rates[c].append(TRAIN_ROUNDS / (time.perf_counter() - t0))
        if launches is None:
            launches, logged = launch_counts(), len(hist)
        if c:
            if build.stats["captures"] != 1:
                fail(f"{phase} rates: {build.stats['captures']} captures")
            draw_s.append((build.stats["draw_s"] - draw0) / TRAIN_ROUNDS)
        del build, advance
        gc.collect()
        torch.cuda.empty_cache()
    n = args.clients
    per_layer = serve_launches(cfg)
    want = {**dict.fromkeys(launches, 0),
            **{k: v * (TRAIN_ROUNDS * TRAIN_K + 3 * logged)
               for k, v in per_layer.items()},
            "fused_cross_entropy": ce_launches(cfg) * (
                n * TRAIN_ROUNDS * TRAIN_K + 3 * logged)}
    if launches != want:
        fail(f"{phase} rates: a turn launched {launches}, expected {want}")
    tokens = n * TRAIN_K * TRAIN_B * TRAIN_S
    out = {"arch": cfg.name, "layers": len(cfg.blocks()), "clients": n,
           "rounds_a_turn": TRAIN_ROUNDS,
           "turns": ["captured" if c else "eager" for c in turns],
           "rounds_per_s_eager": rates[False],
           "rounds_per_s_captured": rates[True],
           "tokens_per_s_eager": [r * tokens for r in rates[False]],
           "tokens_per_s_captured": [r * tokens for r in rates[True]],
           "capture_s": capture_s, "draw_host_s_per_round": draw_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_a_turn": launches, "logged_rows_a_turn": logged}
    emit({"phase": phase, "case": f"n = {n}, "
          + ", ".join(out["turns"]), "nvidia_smi": smi, **out})
    del trainer, box
    gc.collect()
    torch.cuda.empty_cache()
    return out


def host_loop_run(args, cfg, *, phase, smi) -> dict:
    """``launch.train`` at ``args`` through its host loop (``--engine
    host``, which hands the state over round by round, where an eager
    engine chunk holds the state it was given until the chunk ends),
    TRAIN_ROUNDS rounds logged at the first and the last: the kernels'
    launches by route, finite rows, peak memory, and rounds/s over the
    rounds after the first (the last row's metrics included)."""
    import gc

    import torch

    from repro_torch.launch import train as train_lib

    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    res = train_lib.train(args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches, routes = launch_counts(), route_counts()
    hist = strip_stamps(res["history"])
    walls = [r["wall_s"] for r in res["history"]]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    n = args.clients
    want = train_launches(cfg, n=n, k=TRAIN_K, rounds=TRAIN_ROUNDS,
                          logged=len(hist))
    if launches != {**dict.fromkeys(launches, 0), **want}:
        fail(f"{phase} host loop: launches {launches}, expected {want}")
    routed = {k: v for k, v in model_routes(torch.bfloat16).items()
              if want[k]}
    check_routes({k: routes[k] for k in routed}, want,
                 f"{phase} host loop", route_of=routed)
    for rec in hist:
        if not all(math.isfinite(rec[k]) for k in ("f_bar", "mean_loss",
                                                   "eval_loss")):
            fail(f"{phase} host loop round {rec['round']}: not finite")
    rate = (hist[-1]["round"] - hist[0]["round"]) / (walls[-1] - walls[0])
    out = {"arch": cfg.name, "layers": len(cfg.blocks()), "clients": n,
           "rounds": TRAIN_ROUNDS, "engine": "host",
           "rounds_per_s": rate,
           "tokens_per_s": rate * n * TRAIN_K * TRAIN_B * TRAIN_S,
           "peak_memory_gb": peak, "launches": launches,
           "launches_by_route": {k: routes[k] for k in routed}}
    emit({"phase": phase, "case": f"host loop, n = {n}",
          "nvidia_smi": smi, **out})
    return out


def phase_train(dev, gen, smi) -> dict:
    """Federated DRO training of qwen2-0.5b at full width (d_model 896,
    14/2 heads, V = 151 936, tied head; bf16 compute, f32 state), cut to
    TRAIN_LAYERS of its 24 layers, through ``launch.train`` at the
    reference's train defaults (n = 4, K = 4, batch 4 × 128 a client, 8
    groups), weights from seed 0:
    per-client gradients through B5 and B6 against the plain route (f32
    and bf16); the main path, three rounds at n = 4 captured (``--engine
    scan``, one CUDA graph a chunk), with B5's and B6's launches by route,
    bit for bit the same rounds eager (``--engine host``); a checkpoint
    resume of a captured run at n = 2; rounds/s eager and captured in
    turns, capture s, tokens/s, peak memory; one round of each baseline;
    B5 and B6 at the train shapes."""
    import gc
    import tempfile

    import torch

    from repro_torch import engine as engine_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.launch import train as train_lib

    with arch_depth(TRAIN_ARCH, TRAIN_LAYERS) as cfg:
        gc.collect()            # what the earlier phases left in cycles
        torch.cuda.empty_cache()
        out = {"grads": grad_checks(dev, smi, train_args(device=dev),
                                    phase="train",
                                    tol_bf16=(TOL_TRAIN_BF16_X,
                                              TOL_TRAIN_BF16_Y))}
        torch.cuda.empty_cache()
        out["main"] = captured_against_eager(
            lambda **kw: train_args(device=dev, **kw), cfg, phase="train",
            smi=smi)

        # a checkpoint resume of a captured run, at n = 2 (half the
        # checkpoint written to disk)
        with tempfile.TemporaryDirectory() as d:
            args = train_args(device=dev, clients=TRAIN_RESUME_N,
                              rounds=TRAIN_ROUNDS, chunk=TRAIN_ROUNDS,
                              log_every=1, checkpoint_every=2,
                              checkpoint_dir=d)
            full = train_lib.train(args)["state"]
            gc.collect()
            trainer = train_lib.build(args)
            restored = ckpt_lib.restore(os.path.join(d, "round_000002.npz"),
                                        trainer.state)
            trainer.state = None
            build = trainer.build_chunk(args)
            resumed, _ = engine_lib.run(restored, build,
                                        total_rounds=TRAIN_ROUNDS,
                                        chunk_rounds=TRAIN_ROUNDS)
        resumed_exact = resumed.round == full.round and trees_equal(resumed,
                                                                     full)
        if not resumed_exact:
            fail("train: the checkpoint resume of the captured run differs")
        out["resume"] = {"clients": TRAIN_RESUME_N, "rounds": TRAIN_ROUNDS,
                         "checkpoint_round": 2, "bit_for_bit": resumed_exact}
        emit({"phase": "train", "case": "checkpoint resume, captured",
              **out["resume"]})
        del full, resumed, restored, trainer, build
        gc.collect()
        torch.cuda.empty_cache()

        # rounds/s at n = 4, eager and captured in turns
        out["rates"] = train_rates(train_args(device=dev,
                                              log_every=TRAIN_ROUNDS), cfg,
                                   phase="train", smi=smi, turns=RATE_TURNS)

        # one round of each baseline at n = 4
        out["baselines"] = {}
        for algo in ALGOS[1:]:
            r = train_lib.train(train_args(device=dev, engine="host",
                                           algorithm=algo, rounds=1))
            rec = r["history"][-1]
            if not all(math.isfinite(rec[k]) for k in ("f_bar", "mean_loss",
                                                       "eval_loss")):
                fail(f"train {algo}: not finite")
            out["baselines"][algo] = {k: rec[k] for k in ("f_bar", "mean_loss",
                                                          "eval_loss")}
            del r
            gc.collect()
            torch.cuda.empty_cache()
        emit({"phase": "train", "baselines": out["baselines"],
              "clients": TRAIN_N})
        out["times"] = train_kernel_times(gen, dev)
        out["launches"] = out["main"]["launches"]
        out["launches_by_route"] = out["main"]["launches_by_route"]
        return out


# ---------------------------------------------------------------------------
# phase mesh: the decentralized training mesh
# ---------------------------------------------------------------------------

def state_fingerprints(state) -> dict:
    """Two 64-bit sums of each tensor leaf's bit patterns (plain, and
    weighted by position) per field of a training state: equal
    fingerprints stand for bit-for-bit equal leaves."""
    import torch

    from repro_torch.core import tree as tree_lib

    def one(t):
        t = t.detach().contiguous()
        bits = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                       1: torch.int8}[t.element_size()]).reshape(-1)
        bits = bits.to(torch.int64)
        pos = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        return (int(bits.sum()), int((bits * pos).sum()))

    return {name: [one(t) for t in tree_lib.leaves(getattr(state, name))]
            for name in ("x", "y", "cx", "cy")}


def save_rows(state, directory) -> None:
    """Each tensor leaf of x, y, cx and cy as an .npy file, for the ranks
    to read their rows of (``numpy.load`` with ``mmap_mode``)."""
    import numpy as np

    from repro_torch.core import tree as tree_lib

    os.makedirs(directory, exist_ok=True)
    for name in ("x", "y", "cx", "cy"):
        for i, t in enumerate(tree_lib.leaves(getattr(state, name))):
            np.save(os.path.join(directory, f"{name}_{i:04d}.npy"),
                    t.detach().float().cpu().numpy())


def rows_rel_err(state, lo, hi, directory) -> dict:
    """max |mesh − host| / (1 + max |host|) per field, the host path's rows
    [lo, hi) read from ``save_rows``' files."""
    import numpy as np
    import torch

    from repro_torch.core import tree as tree_lib

    out = {}
    for name in ("x", "y", "cx", "cy"):
        err = top = 0.0
        for i, t in enumerate(tree_lib.leaves(getattr(state, name))):
            want = torch.from_numpy(np.array(np.load(
                os.path.join(directory, f"{name}_{i:04d}.npy"),
                mmap_mode="r")[lo:hi])).to(t.device)
            err = max(err, max_err(t.float(), want))
            top = max(top, float(want.abs().max()))
            del want
        out[name] = err / (1.0 + top)
    return out


def mesh_sigma_c(state, n) -> float:
    """max_j |Σ_i c_ij| / n / (1 + max|c|) over cx and cy, the sums (f64)
    all-reduced over the world, max|c| this rank's."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import tree as tree_lib
    from repro_torch.dist import collectives

    axis = collectives.axis_of_group(dist.group.WORLD, n)
    worst = 0.0
    with collectives.phase("check"):
        for name in ("cx", "cy"):
            for c in tree_lib.leaves(getattr(state, name)):
                s = collectives.all_reduce_sum(c.double().sum(0), axis)
                worst = max(worst, float(s.abs().max()) / n
                            / (1.0 + float(c.abs().max())))
    return worst


def mesh_rank(rank, world, layers, runs, traced=None):
    """One rank of the mesh phase: ``launch.train --mesh decentralized``
    for each run of ``runs`` (engine, rounds, mixing_impl, a
    ``topology_cycle``, a ``--telemetry-out`` path, the host path's rows
    or fingerprints to hold it to), with the kernels' launches by route,
    the collectives by phase, the host seconds and the peak memory of
    each run; then, with ``traced`` (a mixing_impl), one round with traced
    stepsizes against the static round (:func:`mesh_traced_etas`)."""
    import gc

    import torch

    from repro_torch.dist import collectives
    from repro_torch.launch import train as train_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    with arch_depth(TRAIN_ARCH, layers):
        for run in runs:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_launch_counts()
            collectives.zero_collective_counts()
            t0 = time.perf_counter()
            res = train_lib.train(train_args(
                device="cuda", mesh="decentralized", engine=run["engine"],
                rounds=run["rounds"], chunk=run.get("chunk", run["rounds"]),
                log_every=MESH_LOG_EVERY, mixing_impl=run["impl"],
                gossip_compress=run.get("compress"),
                topology_cycle=run.get("cycle", ()),
                telemetry_out=run.get("telemetry")))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rec = {"name": run["name"], "rank": rank,
                   "device": str(torch.cuda.current_device()),
                   "clients": res["clients"], "seconds": seconds,
                   "launches": launch_counts(), "routes": route_counts(),
                   "collectives": collectives.collective_counts(),
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "history": res["history"]}
            state = res["state"]
            del res
            rec["finite"] = all(bool(t.isfinite().all()) for t in
                                state_leaves(state))
            if run.get("sigma_c"):
                rec["sigma_c"] = mesh_sigma_c(state, TRAIN_N)
            if run.get("rows_dir"):
                lo, hi = rec["clients"]
                rec["rel_err"] = rows_rel_err(state, lo, hi, run["rows_dir"])
            if run.get("fingerprints") is not None:
                rec["bit_for_bit"] = (state_fingerprints(state)
                                      == run["fingerprints"])
            out.append(rec)
            del state
        if traced:
            out.append(mesh_traced_etas(rank, traced))
    return out


def mesh_traced_etas(rank, impl) -> dict:
    """One round of ``impl`` on the mesh from the train flags' initial
    state and first batches, built with ``traced_etas`` (the stepsizes
    fed as ``kgt.point_etas``' bundle) against the same round with them
    baked in (the train CLI's), bit for bit on this rank's rows; the
    kernels' launches of each."""
    import torch

    from repro_torch import engine as engine_lib
    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.launch import train as train_lib

    args = train_args(device="cuda", mesh="decentralized", engine="host",
                      rounds=1, mixing_impl=impl)
    trainer = train_lib.build(args)
    traced, _ = train_lib.mesh_round(args, trainer.cfg, trainer.algo,
                                     trainer.problem, "cuda",
                                     traced_etas=True)
    batches, noise, _ = engine_lib.split_sampled(trainer.sampler(0))
    state = trainer.state
    out = {"name": "traced_etas", "rank": rank, "impl": impl}
    for name, fn in (("static", lambda: trainer.round_step(
            state, batches, noise)), ("traced", lambda: traced(
                state, batches, noise, kgt.point_etas(trainer.algo)))):
        zero_launch_counts()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        out[f"{name}_seconds"] = time.perf_counter() - t0
        out[f"{name}_launches"] = launch_counts()
    a, b = out.pop("static"), out.pop("traced")
    out["bit_for_bit"] = all(torch.equal(x, y) for x, y in zip(
        state_leaves(a), state_leaves(b)))
    out["finite"] = all(bool(t.isfinite().all()) for t in state_leaves(b))
    del a, b, state, trainer
    return out


def state_leaves(state):
    from repro_torch.core import tree as tree_lib

    return [t for name in ("x", "y", "cx", "cy")
            for t in tree_lib.leaves(getattr(state, name))]


def mesh_telemetry_check(host_path, mesh_path, store) -> dict:
    """The mesh's ``--telemetry-out`` stream (rank 0's; the other rank
    writes none) against the host path's of the same run: the meta record
    and the ledger events equal, the metric rows and the health gauges
    (Σc drift, consensus, summed over the clients axis) at TOL_MESH_X·(1
    + max), the mesh's rows at R = 2 rounding otherwise in bf16 (the CPU
    tests hold them at 1e-5 in the port's test geometry)."""
    def read(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    def of(events, kind):
        return [{k: v for k, v in e.items()
                 if k not in ("v", "t", "wall_s", "build_s", "capture_s",
                              "run_s")}
                for e in events if e["type"] == kind]

    host, mesh = read(host_path), read(mesh_path)
    others = [p for p in os.listdir(store) if p.endswith(".jsonl")
              and p not in (os.path.basename(host_path),
                            os.path.basename(mesh_path))]
    if others:
        fail(f"mesh telemetry: other ranks wrote {others}")
    if of(mesh, "meta") != of(host, "meta"):
        fail("mesh telemetry: the meta record differs from the host path's")
    if of(mesh, "ledger") != of(host, "ledger"):
        fail("mesh telemetry: the ledger events differ from the host path's")
    worst = {}
    for kind, value_keys in (("metrics", None), ("gauge", ("value",))):
        got, want = of(mesh, kind), of(host, kind)
        if [(e.get("name"), e.get("round")) for e in got] != [
                (e.get("name"), e.get("round")) for e in want] or not got:
            fail(f"mesh telemetry: the {kind} events differ in number or "
                 "order from the host path's")
        for g, w in zip(got, want):
            keys = value_keys or [k for k in w if k not in (
                "type", "round", "eval_group_loss")]
            for k in keys:
                err = abs(g[k] - w[k]) / (1 + abs(w[k]))
                worst[f"{kind}.{g.get('name', k)}"] = max(
                    worst.get(f"{kind}.{g.get('name', k)}", 0.0), err)
    if not max(worst.values()) <= TOL_MESH_X:
        fail(f"mesh telemetry: rows or gauges differ by {worst}")
    return {"events_host": len(host), "events_mesh": len(mesh),
            "gauges": sorted({e["name"] for e in of(mesh, "gauge")}),
            "rel_err": worst, "tolerance": TOL_MESH_X}


def mesh_gossip_formula(cfg, n, world, impl, rank=0) -> dict:
    """The gossip collectives of one tracking round at n clients over
    ``world`` ranks on the train flags' topology, on rank ``rank``, all
    f32: dense, two all-gathers a leaf of x and y (Δ and θ), each
    receiving (R − 1)·(n/R) client rows; fused_ring, one exchange a leaf
    (Δ and θ stacked), 2 rows of both received; pallas_packed, one
    all-gather a variable of its stacked (Δ, θ); and the halo term:
    sparse_packed, one halo exchange a variable of its stacked (Δ, θ),
    receiving the rank's ``HaloPlan`` rows (n_halo), and the robust rules,
    R(θ + η_sΔ) and R(Δ) a variable, one exchange of the n_halo rows
    each."""
    from repro_torch.core import sparse_topology as sparse_lib
    from repro_torch.core import topology as topo_lib
    from repro_torch.core import tree as tree_lib
    from repro_torch.dist import collectives
    from repro_torch.models import model as model_lib

    leaves = tree_lib.leaves(model_lib.param_dict(model_lib.skeleton(cfg)))
    lx, dx = len(leaves), sum(t.numel() for t in leaves)
    ly, dy = 1, TRAIN_G
    gathered = (world - 1) * (n // world) * 2 * (dx + dy) * 4
    if impl == "dense":
        return {"all_gather": {"calls": 2 * (lx + ly), "bytes": gathered}}
    if impl == "pallas_packed":
        return {"all_gather": {"calls": 2, "bytes": gathered}}
    if impl.endswith("ring"):
        return {"exchange": {"calls": lx + ly,
                             "bytes": 2 * 2 * (dx + dy) * 4}}
    topology = train_args().topology
    support = (sparse_lib.sparse_mixing_matrix(topology, n)
               if impl.startswith("sparse_") else sparse_lib.from_dense(
                   topo_lib.mixing_matrix(topology, n)))
    plan = collectives.halo_plan(support, collectives.ClientsAxis(
        n=n, rank=rank, size=world))
    return {"halo": {"calls": 2 if impl == "sparse_packed" else 4,
                     "bytes": plan.n_halo * 2 * (dx + dy) * 4}}


def phase_mesh(dev, smi) -> dict:
    """The decentralized training mesh (``launch.train --mesh
    decentralized``) at the train phase's geometry: qwen2-0.5b at full
    width cut to MESH_LAYERS layers, n = 4, K = 4, 4 × 128 tokens a
    client, 8 groups, kgt_minimax on a ring, over a world of MESH_WORLD
    ranks started by ``dist.launch.run_world`` (NCCL, one card a rank,
    where the machine has two cards; else both ranks on ``cuda:0`` over
    gloo), MESH_ROUNDS rounds of dense and fused_ring and
    MESH_LOWERING_ROUNDS of each lowering.  The host path runs first in this
    process from the same seed (``--engine host``: dense and each of
    MESH_LOWERINGS); then on the mesh dense through ``--engine host`` and
    through ``--engine scan`` (eager chunks), held to the host path's
    state at TOL_MESH_X / TOL_MESH_Y (printed before the reading), Σc = 0
    (the scan run); fused_ring (the neighbour exchange); each of
    MESH_LOWERINGS (sparse_packed: the halo exchange and B4 on a rank's
    remapped table; pallas_packed with int8 compression: B1 on a rank's
    row block, on q; sparse_trimmed_mean: the halo and the plain order
    statistic), each held to its host path at the same limits, Σc = 0 but
    for the robust rule; on every run B5's, B6's, B1's and B4's launches on
    every rank by route, no collective in the local steps, the gossip's
    collectives and bytes a round against ``mesh_gossip_formula``; and a
    world of 1 over NCCL in this process, bit for bit the host path.  Rates: rounds/s, tokens/s, communication s a round, peak
    memory per rank."""
    import gc
    import tempfile

    import torch

    from repro_torch.dist import launch as dist_launch
    from repro_torch.launch import train as train_lib

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= MESH_WORLD else "gloo"
    t_phase = time.perf_counter()
    out = {"world": MESH_WORLD, "backend": backend, "cards": cards}
    with arch_depth(TRAIN_ARCH, MESH_LAYERS) as cfg, \
            tempfile.TemporaryDirectory() as store:
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "mesh", "case": "plan", "world": MESH_WORLD,
              "backend": backend, "cards": cards,
              "placement": ("one card a rank" if backend == "nccl"
                            else "both ranks on cuda:0"),
              "lowerings": [name for name, _, _ in MESH_LOWERINGS],
              "tolerance_x_cx": TOL_MESH_X, "tolerance_y_cy": TOL_MESH_Y,
              "tolerance_rows": TOL_MESH_X,
              "sigma_c_limit": TOL_SIGMA_C})
        # the host path from the same seed, in this process, each state's
        # rows saved for the ranks
        ref = {}
        for name, impl, comp in (("dense", "dense", None),
                                 *MESH_LOWERINGS):
            res = train_lib.train(train_args(
                device=dev, engine="host", rounds=(
                    MESH_ROUNDS if name == "dense" else MESH_LOWERING_ROUNDS),
                log_every=MESH_LOG_EVERY, mixing_impl=impl,
                gossip_compress=comp))
            ref[name] = {"history": strip_stamps(res["history"]),
                         "fingerprints": state_fingerprints(res["state"])}
            save_rows(res["state"], os.path.join(store, name))
            del res
            gc.collect()
            torch.cuda.empty_cache()
        # the cycle, through the scan engine (its health gauges ride the
        # engine's chunk boundaries) in eager chunks, as the mesh runs
        # them, with --telemetry-out
        tel_host = os.path.join(store, "cycle_host.jsonl")
        res = train_lib.train(train_args(
            device=dev, engine="scan", rounds=MESH_CYCLE_ROUNDS,
            chunk=MESH_CYCLE_CHUNK, log_every=MESH_LOG_EVERY,
            mixing_impl="pallas_packed", topology_cycle=MESH_CYCLE,
            telemetry_out=tel_host), capture=False)
        ref["cycle"] = {"history": strip_stamps(res["history"]),
                        "fingerprints": state_fingerprints(res["state"])}
        save_rows(res["state"], os.path.join(store, "cycle"))
        del res
        gc.collect()
        torch.cuda.empty_cache()
        host_s = time.perf_counter() - t_phase
        tel_mesh = os.path.join(store, "cycle_mesh.jsonl")
        runs = [dict(name="host", engine="host", rounds=MESH_ROUNDS,
                     impl="dense", ref="dense",
                     rows_dir=os.path.join(store, "dense")),
                dict(name="scan", engine="scan", rounds=MESH_ROUNDS,
                     impl="dense", ref="dense",
                     rows_dir=os.path.join(store, "dense"), sigma_c=True),
                dict(name="fused_ring", engine="host", rounds=MESH_ROUNDS,
                     impl="fused_ring", ref="dense")]
        runs += [dict(name=name, engine="host", rounds=MESH_LOWERING_ROUNDS,
                      impl=impl,
                      compress=comp, ref=name,
                      rows_dir=os.path.join(store, name),
                      sigma_c=impl not in ("coord_median", "trimmed_mean",
                                           "sparse_coord_median",
                                           "sparse_trimmed_mean"))
                 for name, impl, comp in MESH_LOWERINGS]
        runs.append(dict(name="cycle", engine="scan",
                         rounds=MESH_CYCLE_ROUNDS, chunk=MESH_CYCLE_CHUNK,
                         impl="pallas_packed",
                         cycle=MESH_CYCLE, ref="cycle",
                         rows_dir=os.path.join(store, "cycle"),
                         sigma_c=True, telemetry=tel_mesh))
        t0 = time.perf_counter()
        ranks = dist_launch.run_world(
            MESH_WORLD, mesh_rank, MESH_LAYERS, runs, "pallas_packed",
            backend=backend, store_dir=store, device="cuda")
        world_s = time.perf_counter() - t0
        telemetry = mesh_telemetry_check(tel_host, tel_mesh, store)
        # a world of 1 over NCCL, in this process (the card is free again)
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        dist_launch.init_from_env("nccl", "cuda")
        try:
            one, = mesh_rank(0, 1, MESH_LAYERS, [dict(
                name="world of 1", engine="host", rounds=MESH_ROUNDS,
                impl="dense", fingerprints=ref["dense"]["fingerprints"])])
        finally:
            torch.distributed.destroy_process_group()
        one_s = time.perf_counter() - t0

    n_local = TRAIN_N // MESH_WORLD
    routed = {k: v for k, v in model_routes(torch.bfloat16).items()
              if k in ("flash_attention", "fused_cross_entropy")}
    tokens = TRAIN_N * TRAIN_K * TRAIN_B * TRAIN_S
    gossip_kernels = {}
    for i, run in enumerate(runs):
        recs = [r[i] for r in ranks]
        name = run["name"]
        want_launches = {
            **train_launches(cfg, n=n_local, k=TRAIN_K, rounds=run["rounds"],
                             logged=len(ref[run["ref"]]["history"])),
            # B1 (pallas_packed) and B4 (sparse_packed) once a round
            "fused_gossip": run["rounds"] * (run["impl"] == "pallas_packed"),
            "sparse_gossip": run["rounds"] * (run["impl"]
                                              == "sparse_packed")}
        for rec in recs:
            what = f"mesh {name} rank {rec['rank']}"
            if not rec["finite"]:
                fail(f"{what}: a state leaf is not finite")
            if "sigma_c" in rec and not rec["sigma_c"] <= TOL_SIGMA_C:
                fail(f"{what}: Σc = {rec['sigma_c']} > {TOL_SIGMA_C}")
            if "local_steps" in rec["collectives"]:
                fail(f"{what}: collectives in the local steps "
                     f"{rec['collectives']['local_steps']}")
            gossip = {k: {m: v[m] for m in ("calls", "bytes")}
                      for k, v in rec["collectives"].get("gossip",
                                                         {}).items()}
            want = {k: {m: v * run["rounds"] for m, v in c.items()}
                    for k, c in mesh_gossip_formula(
                        cfg, TRAIN_N, MESH_WORLD, run["impl"],
                        rec["rank"]).items()}
            if gossip != want:
                fail(f"{what}: gossip collectives {gossip}, expected {want}")
            if rec["launches"] != {**dict.fromkeys(rec["launches"], 0),
                                   **want_launches}:
                fail(f"{what}: launches {rec['launches']}, expected "
                     f"{want_launches}")
            check_routes({k: rec["routes"][k] for k in routed},
                         want_launches, what, route_of=routed)
            check_routes({k: rec["routes"][k] for k in GOSSIP_KERNELS},
                         want_launches, what)
            rows_err = max(
                abs(a[m] - b[m]) / (1 + abs(b[m]))
                for a, b in zip(strip_stamps(rec["history"]),
                                ref[run["ref"]]["history"])
                for m in a if m not in ("round", "eval_group_loss"))
            rec["rows_rel_err"] = rows_err
            if not rows_err <= TOL_MESH_X:
                fail(f"{what}: history rows differ by {rows_err}")
            if "rel_err" in rec:
                e = rec["rel_err"]
                if not (e["x"] <= TOL_MESH_X and e["cx"] <= TOL_MESH_X
                        and e["y"] <= TOL_MESH_Y and e["cy"] <= TOL_MESH_Y):
                    fail(f"{what}: the state differs from the host path "
                         f"{e}")
        for k in GOSSIP_KERNELS:
            if want_launches[k]:
                gossip_kernels[k] = {
                    "run": name,
                    "launches_by_rank": [r["launches"][k] for r in recs],
                    "launches_by_route_by_rank": [r["routes"][k]
                                                  for r in recs]}
        # rounds/s on rank 0: a host run's rounds between its first and last
        # rows (as host_loop_run); a scan run's one chunk, or a host run of
        # one row, by the last row's stamp (its logged row included)
        hist = recs[0]["history"]
        walls = [r["wall_s"] for r in hist]
        rate = ((hist[-1]["round"] - hist[0]["round"])
                / (walls[-1] - walls[0])
                if run["engine"] == "host" and len(walls) > 1
                else run["rounds"] / walls[-1])
        comm = [r["collectives"]["gossip"] for r in recs]
        comm_s = [sum(v["seconds"] for v in c.values()) / run["rounds"]
                  for c in comm]
        metrics_s = [sum(v["seconds"] for v in r["collectives"].get(
            "metrics", {}).values()) / run["rounds"] for r in recs]
        line = {"run": name, "engine": run["engine"], "impl": run["impl"],
                "compress": run.get("compress"),
                "rounds": run["rounds"], "clients_by_rank":
                [r["clients"] for r in recs],
                "devices_by_rank": [r["device"] for r in recs],
                "rel_err_by_rank": [r.get("rel_err") for r in recs],
                "rows_rel_err_by_rank": [r["rows_rel_err"] for r in recs],
                "sigma_c_by_rank": [r.get("sigma_c") for r in recs],
                "rounds_per_s": rate,
                "tokens_per_s": rate * tokens if rate else None,
                "seconds_by_rank": [r["seconds"] for r in recs],
                "gossip_s_a_round_by_rank": comm_s,
                "metrics_comm_s_a_round_by_rank": metrics_s,
                "collectives_by_rank": [r["collectives"] for r in recs],
                "staged_bytes_by_rank": [r["collectives"]["staged_bytes"]
                                         for r in recs],
                "peak_memory_gb_by_rank": [r["peak_memory_gb"]
                                           for r in recs],
                "launches_by_rank": [r["launches"] for r in recs],
                "launches_by_route_by_rank": [
                    {k: r["routes"][k] for k in (*routed, *GOSSIP_KERNELS)}
                    for r in recs]}
        out[name] = line
        emit({"phase": "mesh", "case": f"{name}, world of {MESH_WORLD} "
              f"over {backend}", "nvidia_smi": smi, **line})
    if not one["bit_for_bit"] or strip_stamps(one["history"]) != \
            ref["dense"]["history"]:
        fail("mesh: the world of 1 differs from the host path")
    if any(k != "staged_bytes" and k != "check" and v
           for k, v in one["collectives"].items()):
        fail(f"mesh: the world of 1 made collectives {one['collectives']}")
    traced = [r[len(runs)] for r in ranks]
    for rec in traced:
        what = f"mesh traced_etas rank {rec['rank']}"
        if not rec["finite"]:
            fail(f"{what}: a state leaf is not finite")
        if not rec["bit_for_bit"]:
            fail(f"{what}: the round with traced stepsizes differs from "
                 "the round with them baked in")
        if rec["traced_launches"] != rec["static_launches"]:
            fail(f"{what}: launches {rec['traced_launches']} against the "
                 f"static round's {rec['static_launches']}")
    out["traced_etas"] = traced
    out["cycle_telemetry"] = telemetry
    emit({"phase": "mesh", "case": "traced_etas, one round of "
          "pallas_packed", "nvidia_smi": smi, "ranks": traced})
    emit({"phase": "mesh", "case": "cycle --telemetry-out against the host "
          "path's", "nvidia_smi": smi, **telemetry})
    out["world_of_1"] = {"backend": "nccl", "bit_for_bit": True,
                         "seconds": one["seconds"],
                         "peak_memory_gb": one["peak_memory_gb"]}
    out["seconds"] = {"host_path": host_s, "world": world_s,
                      "world_of_1": one_s,
                      "phase": time.perf_counter() - t_phase}
    emit({"phase": "mesh", "case": "world of 1 over nccl",
          "nvidia_smi": smi, **out["world_of_1"],
          "phase_seconds": out["seconds"]})
    # the scan run's, on rank 0 (every rank launches as many); B1's and
    # B4's on every rank of the run that launches them
    out["launches"] = dict(ranks[0][1]["launches"])
    out["launches_by_route"] = {k: ranks[0][1]["routes"][k] for k in routed}
    out["gossip_kernels"] = gossip_kernels
    return out


# ---------------------------------------------------------------------------
# phase 15b: a client's weights over the mesh's fsdp and model axes
# ---------------------------------------------------------------------------

def fsdp_mesh_algo():
    """The fsdp_mesh phase's round: kgt_minimax on pallas_packed at the
    train CLI's stepsizes and topology, n = 2, K = 4."""
    from repro_torch.configs.base import AlgorithmConfig

    args = train_args()
    return AlgorithmConfig(algorithm="kgt_minimax",
                           num_clients=FSDP_MESH[0],
                           local_steps=TRAIN_K, eta_cx=args.eta_cx,
                           eta_cy=args.eta_cy, eta_sx=args.eta_s,
                           eta_sy=args.eta_s, topology=args.topology,
                           mixing_impl="pallas_packed")


def fsdp_run_cfg(run):
    """The config of an FSDP_MESH_RUNS entry: the arch at full width cut
    to its layers, or its reduced config."""
    from repro_torch.configs import registry

    cfg = registry.get_model_config(run[1])
    if run[2] is None:
        return registry.reduced(cfg)
    return dataclasses.replace(cfg, num_layers=run[2])


def fsdp_opts(run) -> dict:
    """A run's MeshConfig fields (``remat``, ``param_mode``), its
    ``compare_to`` (the run it is held to in place of a host path) and its
    ``mesh``, where it is not FSDP_MESH."""
    return run[7]


def fsdp_mesh_of(run) -> tuple:
    """The (clients, fsdp, model) mesh of a run's world."""
    return tuple(fsdp_opts(run).get("mesh", FSDP_MESH))


def fsdp_mesh_kw(run) -> dict:
    """The MeshConfig fields of a run."""
    return {k: v for k, v in fsdp_opts(run).items()
            if k in ("remat", "param_mode")}


def fsdp_remat(run) -> bool:
    return fsdp_opts(run).get("remat", True)


def fsdp_replicated(run) -> bool:
    return fsdp_opts(run).get("param_mode") == "replicated"


def fsdp_run_tols(run) -> tuple:
    """(x and cx, y and cy) limits of a run against its host path."""
    return ((TOL_MESH_X, TOL_MESH_Y) if run[4] == "bfloat16"
            else (TOL_TRAIN_F32, TOL_TRAIN_F32))


def fsdp_want_launches(run, cfg) -> dict:
    """A rank's launches of each model and gossip kernel in a run's
    rounds: B5 once an attention layer and local step, B7 once an ``ssm``
    layer, B8 once an ``rglru`` layer, each twice under remat (the
    forward, then the recompute in the backward); B8's backward kernel
    once a layer and local step (:func:`fsdp_backward_launches`); B6's
    partials once a local step, B1 once a round; the whole-vocabulary B6
    no time, but under ``param_mode="replicated"`` (the whole vocabulary
    on every rank) once a local step in place of the partials."""
    kinds = cfg.blocks()
    steps_ = run[3] * TRAIN_K
    units = steps_ * (2 if fsdp_remat(run) else 1)
    head = "fused_cross_entropy" if fsdp_replicated(run) else "ce_partials"
    return {"flash_attention": units * sum(
        k in ("attn", "sliding", "attn_local", "moe") for k in kinds),
        "ssd_scan": units * kinds.count("ssm"),
        "rglru_scan": units * kinds.count("rglru"),
        head: steps_, "fused_gossip": run[3]}


def fsdp_backward_launches(run, cfg) -> int:
    """B8's backward kernel: once an ``rglru`` layer and local step."""
    return run[3] * TRAIN_K * cfg.blocks().count("rglru")


def fsdp_route_of(run, cfg) -> dict:
    """The route each two-route kernel of a run takes: B5 and B6's
    partials on tensor cores in bf16, on CUDA cores in f32; B7 on tensor
    cores; B8 by its rule at a rank's (B/F, S, W/M); B1 unrolled."""
    from repro_torch.kernels import rglru_scan

    _, f, m = fsdp_mesh_of(run)
    core = "tensor_core" if run[4] == "bfloat16" else "cuda_core"
    out = {"flash_attention": core, "ce_partials": core,
           "fused_cross_entropy": core}
    if "rglru" in cfg.blocks():
        width = cfg.rglru.channels(cfg.d_model)
        out["rglru_scan"] = rglru_scan.route(
            TRAIN_B // f, TRAIN_S,
            width if fsdp_replicated(run) else width // m)
    return out


def fsdp_mesh_batches(cfg, dev, rounds):
    """A run's initial batch and each round's (K, n, B, S) batches, drawn
    from the port's data model (the host path draws them and saves them
    for the ranks)."""
    import torch

    from repro_torch.data import synthetic as data_lib

    n = FSDP_MESH[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    dm = data_lib.make_data_model(gen, vocab_size=cfg.vocab_size,
                                  num_groups=TRAIN_G, num_clients=n,
                                  device=dev)
    draw = [data_lib.round_batches(dm, gen, local_steps=k, num_clients=n,
                                   per_client_batch=TRAIN_B,
                                   seq_len=TRAIN_S, cfg=cfg)
            for k in [1] + [TRAIN_K] * rounds]
    init_batch = {k: v[0] for k, v in draw[0].items()}
    return init_batch, draw[1:]


@contextlib.contextmanager
def expert_choices():
    """Records the expert choices (``models.moe.route``'s (…, k) gate
    indices, on the host) of every MoE layer called while the block
    runs, in call order."""
    from repro_torch.models import moe as moe_lib

    got, orig = [], moe_lib.route

    def spy(params, x, cfg):
        r = orig(params, x, cfg)
        got.append(r.gate_idx.detach().cpu())
        return r

    moe_lib.route = spy
    try:
        yield got
    finally:
        moe_lib.route = orig


def count_flips(got, want) -> int:
    """(layer, token) pairs whose sets of chosen experts differ."""
    return sum(int((g.sort(-1).values != w.sort(-1).values).any(-1).sum())
               for g, w in zip(got, want))


def fsdp_save_pieces(state, cfg, ep, directory, prefix,
                     whole=False) -> None:
    """Each block position's pieces of each client's x and cx and its
    y and cy, on the host, as ``{prefix}_{client}_{fsdp}_{model}.pt``;
    ``whole`` (``param_mode="replicated"``, every position holds the
    whole client): each client's once, as ``{prefix}_{client}_whole.pt``."""
    import torch

    from repro_torch.dist import collectives
    from repro_torch.dist import tensor_parallel as tp

    if whole:
        for i in range(FSDP_MESH[0]):
            torch.save({name: (getattr(state, name)[i].cpu()
                               if name in ("y", "cy") else
                               {k: v[i].cpu() for k, v in getattr(
                                   state, name).items()})
                        for name in ("x", "cx", "y", "cy")},
                       os.path.join(directory, f"{prefix}_{i}_whole.pt"))
        return
    _, f, m = FSDP_MESH
    for fr in range(f):
        for mr in range(m):
            shard = tp.ClientShard(cfg, collectives.MeshAxis(fr, f),
                                   collectives.MeshAxis(mr, m),
                                   expert_parallel=ep)
            for i in range(FSDP_MESH[0]):
                torch.save({name: (getattr(state, name)[i].cpu()
                                   if name in ("y", "cy") else
                                   {k: v.cpu() for k, v in shard.take(
                                       {k: v[i] for k, v in getattr(
                                           state, name).items()}).items()})
                            for name in ("x", "cx", "y", "cy")},
                           os.path.join(directory,
                                        f"{prefix}_{i}_{fr}_{mr}.pt"))


def fsdp_host_path(index, run, cfg, dev, directory, init_batch,
                   rounds) -> dict:
    """The host path of run ``index`` of the fsdp_mesh phase in this
    process (while the ranks run): the initial state (x0 drawn from a
    generator seeded 0, the corrections from the initial batch) and the
    run's rounds of pallas_packed on both clients' whole weights.  Every
    run but the first (whose ranks draw their own initial state) saves
    each block position's pieces of that state for the ranks
    (``init_{index}``, then the marker ``init_done_{index}``); a MoE run
    saves the expert choices of each client's first batch on it, and a
    run that the ranks replay saves the expert choices of every MoE layer
    and local step of its rounds (``replay_{index}``, one (n, B, S, k)
    tensor a call).  Then each position's pieces of the final state
    (``host_{index}``) and the marker ``host_done_{index}`` that the ranks
    wait for."""
    import torch

    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.core import objectives
    from repro_torch.models import model as model_lib

    algo = fsdp_mesh_algo()
    n, ep, dtype = FSDP_MESH[0], run[5], getattr(torch, run[4])
    problem = objectives.dro_problem(cfg, num_groups=TRAIN_G,
                                     compute_dtype=dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = kgt.init_state(problem, algo, gen, init_batch=init_batch)
    whole = fsdp_replicated(run)
    if index:
        fsdp_save_pieces(state, cfg, ep, directory, f"init_{index}",
                         whole=whole)
        open(os.path.join(directory, f"init_done_{index}"), "w").close()
    if cfg.moe.num_experts:
        skel = model_lib.skeleton(cfg)
        choices = []
        for i in range(n):
            with torch.no_grad(), expert_choices() as got:
                model_lib.call(skel, {k: v[i] for k, v in state.x.items()},
                               model_lib.per_group_loss,
                               {k: v[0, i] for k, v in rounds[0].items()},
                               num_groups=TRAIN_G, compute_dtype=dtype)
            choices.append(got)
        torch.save(choices, os.path.join(directory, f"routing_{index}.pt"))
    step = kgt.make_round_step(problem, algo, device=dev)
    t0 = time.perf_counter()
    with (routing_recorder() if run[6] else contextlib.nullcontext(
            [])) as seen:
        for batches in rounds:
            state = step(state, batches, torch.zeros((TRAIN_K, n, 0),
                                                     device=dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if run[6]:
        torch.save([t.cpu() for t in seen],
                   os.path.join(directory, f"replay_{index}.pt"))
    fsdp_save_pieces(state, cfg, ep, directory, f"host_{index}",
                     whole=whole)
    open(os.path.join(directory, f"host_done_{index}"), "w").close()
    client_bytes = sum(t[0].numel() * t[0].element_size()
                       for t in state.x.values())
    del state
    return {"seconds": seconds, "client_x_bytes": client_bytes}


def wait_for(path, what, limit=600) -> None:
    """Waits for the parent's marker ``path``; fails at once where the
    parent's host path failed (its marker ``host_failed`` beside it)."""
    t0 = time.perf_counter()
    failed = os.path.join(os.path.dirname(path), "host_failed")
    while not os.path.exists(path):
        if os.path.exists(failed):
            raise RuntimeError(f"{what}: the host path failed")
        if time.perf_counter() - t0 > limit:
            raise TimeoutError(f"{what} did not finish")
        time.sleep(0.05)


def fsdp_mesh_rank(rank, world, directory, dev, mesh):
    """One rank of the fsdp_mesh phase's world on ``mesh``: each of
    FSDP_MESH_RUNS on that mesh in order (:func:`fsdp_mesh_run`; None
    in the place of another mesh's run)."""
    entered = time.time()
    t_enter = time.perf_counter()
    runs, kept = [], {}
    # the runs another is held to, and after how many of their rounds
    held = {fsdp_opts(r)["compare_to"]: r[3] for r in FSDP_MESH_RUNS
            if "compare_to" in fsdp_opts(r)}
    for index, run in enumerate(FSDP_MESH_RUNS):
        if fsdp_mesh_of(run) != tuple(mesh):
            runs.append(None)
            continue
        runs.append(fsdp_mesh_run(index, run, directory, dev, t_enter,
                                  kept=kept, keep=held.get(index)))
        t_enter = None
    return {"rank": rank, "device": rank_device(), "entered": entered,
            "runs": runs}


def fsdp_remat_replay(recorded, units: int) -> list:
    """The host path's expert choices (one a MoE layer and local step, in
    call order) in the order a remat round calls the router: each local
    step's forward through the ``units`` MoE units, then their recompute
    in the backward, last unit first."""
    out = []
    for i in range(0, len(recorded), units):
        block = list(recorded[i:i + units])
        out += block + block[::-1]
    return out


def fsdp_mesh_run(index, run, directory, dev, t_enter=None, kept=None,
                  keep=None):
    """Run ``index`` on this rank: its pieces of its client on the
    ``(clients, fsdp, model)`` mesh over ``launch.steps.
    build_train_round``, the run's rounds of pallas_packed from the
    initial state (the first run draws it on the mesh from the host
    path's seed, the others load the host path's pieces of it); its
    state's bytes, peak memory, the collectives by phase and kind, the
    kernels' launches by route (B8's backward launches too), the seconds,
    the relative error of each field against the host path's pieces and,
    for a MoE run, its expert choices on the client's first batch against
    the host path's.  A run that replays the host path's expert choices
    (``run[6]``) waits for the host path's rounds, then runs its own under
    ``routing_replay`` of its client's and fsdp rank's rows of them (in
    a remat round's order, :func:`fsdp_remat_replay`).  A run with a
    ``compare_to`` (``fsdp_opts``) draws its initial state on the mesh as
    the first run does and is compared with that run's state after as
    many rounds (``kept``), bit for
    bit, in place of a host path (``keep``: the rounds after which the
    run named keeps its state, a copy on the host).  Under
    ``param_mode="replicated"`` the
    rank loads and compares its whole clients."""
    import gc

    import torch

    from repro_torch.configs.base import InputShape, MeshConfig, MinimaxConfig
    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.core import tree as tree_lib
    from repro_torch.dist import collectives
    from repro_torch.dist import context as dist_ctx
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib

    t_enter = t_enter or time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c, f, m = fsdp_mesh_of(run)
    cfg, ep, dtype = fsdp_run_cfg(run), run[5], getattr(torch, run[4])
    algo = fsdp_mesh_algo()
    saved = torch.load(os.path.join(directory, f"batches_{index}.pt"))
    init_batch = {k: v.to(dev) for k, v in saved["init"].items()}
    rounds = [{k: v.to(dev) for k, v in b.items()} for b in saved["rounds"]]
    mesh = mesh_lib.train_mesh(c, f, m, device_type=dev)
    step, axis = steps.build_train_round(
        cfg, InputShape("fsdp_mesh", TRAIN_S, TRAIN_B * c, "train"),
        mesh, MeshConfig(num_clients=c, fsdp=f, model=m,
                         moe_expert_parallel=ep, **fsdp_mesh_kw(run)),
        algo=algo, minimax=MinimaxConfig(num_groups=TRAIN_G), device=dev,
        compute_dtype=dtype)
    shard, block = step.shard, (step.axes.fsdp.rank, step.axes.model.rank)
    whole = fsdp_replicated(run)
    compare_to = fsdp_opts(run).get("compare_to")

    def saved_piece(prefix, i):
        return torch.load(os.path.join(
            directory, f"{prefix}_{i}_whole.pt" if whole else
            f"{prefix}_{i}_{block[0]}_{block[1]}.pt"), weights_only=False)

    t0 = time.perf_counter()
    setup_s = t0 - t_enter
    if index == 0 or compare_to is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = kgt.init_state(step.problem, algo, gen,
                               init_batch=init_batch, axis=axis)
    else:
        wait_for(os.path.join(directory, f"init_done_{index}"),
                 f"run {index}'s initial state")
        init = [saved_piece(f"init_{index}", i)
                for i in range(axis.lo, axis.hi)]
        state = kgt.KGTState(**{
            name: (torch.stack([p[name] for p in init]).to(dev)
                   if name in ("y", "cy") else
                   {k: torch.stack([p[name][k] for p in init]).to(dev)
                    for k in init[0][name]})
            for name in ("x", "cx", "y", "cy")}, round=0)
        del init
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows = slice(axis.lo, axis.hi)
    flips = None
    if cfg.moe.num_experts:
        # the expert choices of the client's first batch on the initial
        # weights, this rank's rows of them, against the host path's
        with torch.no_grad(), expert_choices() as got, \
                dist_ctx.residual_constraint(**shard.slots()):
            model_lib.per_group_loss(
                shard.model_of({k: v[0] for k, v in state.x.items()}),
                shard.batch({k: v[0, axis.lo] for k, v in
                             rounds[0].items()}),
                num_groups=TRAIN_G, compute_dtype=dtype)
    mine = [{k: v[:, rows] for k, v in b.items()} for b in rounds]
    del rounds
    replay = contextlib.nullcontext()
    if run[6]:
        wait_for(os.path.join(directory, f"host_done_{index}"),
                 f"run {index}'s host path")
        b = TRAIN_B // f
        recorded = [
            t[axis.lo:axis.hi, block[0] * b:(block[0] + 1) * b].to(dev)
            for t in torch.load(os.path.join(directory,
                                             f"replay_{index}.pt"))]
        if fsdp_remat(run):
            recorded = fsdp_remat_replay(recorded,
                                         cfg.blocks().count("moe"))
        replay = routing_replay(recorded)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    collectives.zero_collective_counts()
    t0 = time.perf_counter()
    err = dict.fromkeys(("x", "cx", "y", "cy"), 0.0)

    def on_host():
        return {name: (getattr(state, name).cpu() if name in ("y", "cy")
                       else {k: v.cpu() for k, v in
                             getattr(state, name).items()})
                for name in err}

    with replay:
        for r, batches in enumerate(mine):
            state = step(state, batches, torch.zeros(
                (TRAIN_K, axis.n_local, 0), device=dev))
            if keep == r + 1:
                kept[index] = on_host()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, routes = launch_counts(), route_counts()
    backward = ops.backward_launch_counts()
    counts = collectives.collective_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_lib.leaves(
                          (state.x, state.cx, state.y, state.cy)))
    t0 = time.perf_counter()
    if compare_to is None:
        # the host path runs in the parent while the ranks run
        wait_for(os.path.join(directory, f"host_done_{index}"),
                 f"run {index}'s host path")
    if cfg.moe.num_experts:
        want = torch.load(os.path.join(directory, f"routing_{index}.pt"),
                          weights_only=False)[axis.lo]
        b = TRAIN_B // f
        flips = count_flips(got, [w[block[0] * b:(block[0] + 1) * b]
                                  for w in want])
    bit_for_bit = None
    if compare_to is not None:
        final, other = on_host(), kept[compare_to]
        bit_for_bit = all(
            torch.equal(final[name], other[name]) if name in ("y", "cy")
            else all(torch.equal(final[name][k], other[name][k])
                     for k in other[name]) for name in err)
    for i in range(axis.lo, axis.hi):
        if compare_to is None:
            host = saved_piece(f"host_{index}", i)
        else:
            j = i - axis.lo
            host = {name: (kept[compare_to][name][j]
                           if name in ("y", "cy") else
                           {k: v[j] for k, v in
                            kept[compare_to][name].items()})
                    for name in err}
        for name in err:
            got_s = getattr(state, name)
            pairs = ([(got_s[i - axis.lo], host[name])]
                     if name in ("y", "cy") else
                     [(got_s[k][i - axis.lo], w)
                      for k, w in host[name].items()])
            for g, w in pairs:
                if w.numel():   # an empty fsdp piece
                    err[name] = max(err[name], rel_err(g.cpu(), w))
    finite = all(bool(t.isfinite().all()) for t in tree_lib.leaves(
        (state.x, state.cx, state.y, state.cy)))
    check_s = time.perf_counter() - t0
    shared = sorted(shard.shared)
    del state, step, mine, shard
    gc.collect()
    torch.cuda.empty_cache()
    return {"setup_s": setup_s, "check_s": check_s,
            "clients": [axis.lo, axis.hi], "block": list(block),
            "state_bytes": state_bytes, "peak_memory_gb": peak,
            "init_s": init_s, "seconds": seconds,
            "rounds_per_s": run[3] / seconds,
            "launches": launches, "routes": routes,
            "backward_launches": backward, "collectives": counts,
            "rel_err": err, "finite": finite, "expert_flips": flips,
            "bit_for_bit": bit_for_bit, "compare_to": compare_to,
            "shared_leaves": len(shared)}


def fsdp_packed_dims(cfg, ep=False) -> tuple:
    """(dx, dy) of a run's gossip on rank (fsdp 0, model 0) of a client's
    block: its pieces of the model's parameters, packed, and the TRAIN_G
    group weights."""
    from repro_torch.dist import collectives
    from repro_torch.dist import tensor_parallel as tp

    _, f, m = FSDP_MESH
    shard = tp.ClientShard(cfg, collectives.MeshAxis(0, f),
                           collectives.MeshAxis(0, m), expert_parallel=ep)
    dx = 0
    for name, p in shard.skel.named_parameters():
        rows = collectives.fsdp_widths(shard.rows[name], f)[0]
        dx += rows * (p.numel() // max(1, p.shape[0]))
    return dx, TRAIN_G


def ce_piece_times(gen, dev, n, d, v) -> dict:
    """B6's partials at a rank's piece (n tokens, d, a vocabulary piece of
    v, bf16, labels over twice the piece): m, m + log l and z against the
    plain version at TOL_CE·(1 + max) on the tensor-core route, with the
    kernel's time on each route, the plain version's, the library calls'
    (``torch.mm`` to f32 logits, then ``F.cross_entropy`` on the piece)
    and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cross_entropy, ops, ref

    hidden, w, labels = ce_operands(n, d, 2 * v, torch.bfloat16, gen, dev)
    w = w[:v]
    got = routed_call(lambda: cross_entropy.fused_ce_partials_nd(
        hidden, w, labels), "ce_partials", "tensor_core")
    want = ref.ce_partials_ref(hidden, w, labels)
    rel = 0.0
    for g, p in zip((got[0], got[0] + torch.log(got[1]), got[2]),
                    (want[0], want[0] + torch.log(want[1]), want[2])):
        rel = max(rel, max_err(g, p) / (1 + float(p.abs().max())))
    del got, want
    if not rel <= TOL_CE:
        fail(f"ce_partials at {(n, d, v)}: {rel} > {TOL_CE} × (1 + max)")
    lab_in = torch.where(labels < v, labels, torch.full_like(labels, -100))

    def library():
        return F.cross_entropy(torch.mm(hidden, w.T).float(), lab_in,
                               reduction="none", ignore_index=-100)

    with ops.uncounted():
        out = {"shape": [n, d, v], "rel_err": rel, "tol": TOL_CE,
               "ms": cuda_ms(lambda: cross_entropy.fused_ce_partials_nd(
                   hidden, w, labels)),
               "cuda_core_ms": cuda_ms(
                   lambda: cross_entropy.fused_ce_partials_nd(
                       hidden, w, labels, force_route="cuda_core"), reps=3),
               "plain_ms": cuda_ms(lambda: ref.ce_partials_ref(
                   hidden, w, labels), reps=5),
               "library_ms": cuda_ms(library, reps=5),
               "library": "torch.mm (bf16 logits) .float() + "
                          "F.cross_entropy"}
    out["bound_ms"], out["bound_by"] = ce_partials_bound_ms(n, d, v)
    del hidden, w, labels, lab_in
    torch.cuda.empty_cache()
    return out


def fsdp_kernel_times(gen, dev) -> dict:
    """The model and gossip kernels at a rank's shapes in the fsdp_mesh
    phase (PERF.md rows 1f, 4f, 5f, 6f, 7f): B1's pair at n = 2 clients,
    a rank's one row of W over its piece of each run's packed state (both
    routes, the plain version; CUDA events around single calls); B5 on a
    rank's heads of its fsdp rank's batch rows, bf16 causal, for qwen2-0.5b
    (2, 128, 7, 1, 64), granite-moe-1b-a400m (2, 128, 8, 4, 64) and the
    reduced recurrentgemma-9b with its KV head shared (2, 128, 2, 1, 64),
    window 32; B6's partials at mamba2-1.3b's and granite's pieces; B7 at
    mamba2-1.3b's (2, 128, 32, 64, 128) with no state0; B8 and its
    backward at the reduced recurrentgemma-9b's (2, 128, 128): each
    against its plain version, with SDPA's time for B5."""
    from repro_torch.kernels import ops
    from repro_torch.dist import tensor_parallel as tp

    n, f, m = FSDP_MESH
    b = TRAIN_B // f
    events = functools.partial(cuda_ms, reps=5, warmup=1)
    out = {"fused_gossip": {}, "flash_attention": {}, "ce_partials": {},
           "ssd_scan": {}, "rglru_scan": {}}
    timed = set()
    with ops.uncounted():
        for run in FSDP_MESH_RUNS:
            if run[1:3] + run[5:6] in timed or fsdp_replicated(run):
                # the pieces of an earlier run, in another dtype; or whole
                # clients, no rank's piece
                continue
            timed.add(run[1:3] + run[5:6])
            cfg = fsdp_run_cfg(run)
            dx, dy = fsdp_packed_dims(cfg, run[5])
            w, dxv, txv, cxv = gossip_operands(n, dx, gen, dev)
            _, dyv, tyv, cyv = gossip_operands(n, dy, gen, dev)
            xv, yv = (dxv, txv, cxv, 0.5, 12.5), (dyv, tyv, cyv, 1.0, -3.0)
            out["fused_gossip"][run[0]] = time_gossip_rows(
                w, xv, yv, n, events, phase="fsdp_mesh")
            del w, xv, yv, dxv, txv, cxv, dyv, tyv, cyv
            kinds = set(cfg.blocks())
            if kinds & {"attn", "moe", "attn_local"}:
                window = cfg.rglru.local_window if "attn_local" in kinds \
                    else 0
                out["flash_attention"][run[0]] = b5_shard_times(
                    gen, dev, cfg, m, b=b, s=TRAIN_S, window=window)
            if run[0] != FSDP_MESH_RUNS[0][0] and run[2] is not None:
                v = tp.pieces(cfg.vocab_size, m, "vocab_size")[0]
                out["ce_partials"][run[0]] = ce_piece_times(
                    gen, dev, b * TRAIN_S, cfg.d_model, v)
            if "ssm" in kinds:
                out["ssd_scan"][run[0]] = b7_shard_times(
                    gen, dev, cfg, m, b, s=TRAIN_S, state0=False)
            if "rglru" in kinds:
                out["rglru_scan"][run[0]] = b8_shard_times(
                    gen, dev, cfg, m, b, s=TRAIN_S)
    emit({"phase": "fsdp_mesh", "case": "kernels at a rank's shapes",
          "nvidia_smi": nvidia_smi(), **out})
    return out


def remat_memory(dev, smi) -> dict:
    """Remat's memory where it matters, at one rank a client: qwen2-0.5b
    at full width and REMAT_MEMORY_LAYERS layers, n = REMAT_MEMORY_N, K =
    4, 4 × 128 tokens a client, bf16 compute, one eager round of
    pallas_packed on the DRO problem with ``remat`` off, then on, from
    copies of one initial state on the same batches (the round
    ``build_train_round`` runs where the block is one rank).  Each
    round's peak memory, above the memory it starts from (the initial
    state, its copy and, for the second, the first's final state), and
    seconds; one local step's vmapped gradient's peak above the memory
    it starts from; the two final states compared, bit for bit
    where the kernels are deterministic, else at TOL_MESH_X / TOL_MESH_Y
    with the reason printed; B5's launches twice a layer and local step
    under remat, once without."""
    import gc

    import torch

    from repro_torch.configs import registry
    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.core import objectives
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import ops

    t_case = time.perf_counter()
    cfg = dataclasses.replace(registry.get_model_config(TRAIN_ARCH),
                              num_layers=REMAT_MEMORY_LAYERS)
    n = REMAT_MEMORY_N
    algo = dataclasses.replace(fsdp_mesh_algo(), num_clients=n)
    init_batch, (batches,) = fsdp_mesh_batches(cfg, dev, 1)
    init_batch = {k: v[:n] for k, v in init_batch.items()}
    batches = {k: v[:, :n] for k, v in batches.items()}
    noise = torch.zeros((TRAIN_K, n, 0), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state0 = kgt.init_state(
        objectives.dro_problem(cfg, num_groups=TRAIN_G,
                               compute_dtype=torch.bfloat16),
        algo, gen, init_batch=init_batch)
    out, finals = {}, {}
    for remat in (False, True):
        problem = objectives.dro_problem(cfg, num_groups=TRAIN_G,
                                         compute_dtype=torch.bfloat16,
                                         remat=remat)
        step = kgt.make_round_step(problem, algo, device=dev)
        state = tree_lib.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            state0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated() / 1e9
        # one local step's vmapped gradient: where the activations live
        torch.cuda.reset_peak_memory_stats()
        with ops.uncounted():
            grads = kgt._vgrads(problem, state.x, state.y,
                                {k: v[0] for k, v in batches.items()},
                                noise[0])
            torch.cuda.synchronize()
        grad_peak = torch.cuda.max_memory_allocated() / 1e9 - start
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t0 = time.perf_counter()
        state = step(state, batches, noise)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()["flash_attention"]
        want = TRAIN_K * REMAT_MEMORY_LAYERS * (2 if remat else 1)
        if launches != want:
            fail(f"remat memory (remat={remat}): B5 launched {launches} "
                 f"times, expected {want}")
        if not all(bool(t.isfinite().all()) for t in tree_lib.leaves(
                (state.x, state.cx, state.y, state.cy))):
            fail(f"remat memory (remat={remat}): a state leaf is not "
                 "finite")
        key = "remat_on" if remat else "remat_off"
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[key] = {"peak_memory_gb": peak, "state_at_start_gb": start,
                    "round_peak_above_state_gb": peak - start,
                    "gradient_peak_above_state_gb": grad_peak,
                    "seconds_a_round": seconds,
                    "flash_attention_launches": launches}
        finals[key] = (state.x, state.cx, state.y, state.cy)
        del state, step, problem
    del state0
    on, off = finals["remat_on"], finals["remat_off"]
    bitwise = all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(on), tree_lib.leaves(off)))
    err = {name: tree_rel_err(a, b)
           for name, a, b in zip(("x", "cx", "y", "cy"), on, off)}
    del finals, on, off
    gc.collect()
    torch.cuda.empty_cache()
    if not bitwise and not (err["x"] <= TOL_MESH_X and err["cx"] <= TOL_MESH_X
                            and err["y"] <= TOL_MESH_Y
                            and err["cy"] <= TOL_MESH_Y):
        fail(f"remat memory: remat on differs from remat off by {err}")
    out.update(arch=TRAIN_ARCH, layers=REMAT_MEMORY_LAYERS, n=n,
               bit_for_bit=bitwise, rel_err=err,
               reason=None if bitwise else
               "not bit for bit: a kernel or GEMM is not deterministic on "
               "this card; held at TOL_MESH_X / TOL_MESH_Y",
               peak_saved_gb=(out["remat_off"]["peak_memory_gb"]
                              - out["remat_on"]["peak_memory_gb"]),
               gradient_peak_saved_gb=(
                   out["remat_off"]["gradient_peak_above_state_gb"]
                   - out["remat_on"]["gradient_peak_above_state_gb"]),
               seconds=time.perf_counter() - t_case)
    emit({"phase": "fsdp_mesh", "case": "remat memory at one rank a "
          "client", "nvidia_smi": smi, **out})
    return out


def phase_fsdp_mesh(dev, smi) -> dict:
    """A client's weights over the decentralized mesh's fsdp and model
    axes: a world of 8 gloo ranks on this card as (clients 2, fsdp 2,
    model 2) (``launch.mesh.train_mesh``, ``launch.steps.
    build_train_round``), running FSDP_MESH_RUNS in order: qwen2-0.5b
    (under remat, the default; without it, held to that run),
    mamba2-1.3b and granite-moe-1b-a400m (its experts split over model)
    at full width cut to FSDP_MESH_LAYERS layers, the reduced
    recurrentgemma-9b, and granite in bf16 with the host path's expert
    choices replayed; then qwen2-0.5b with its weights whole on every
    rank (``param_mode="replicated"``) in a second world of 4 ranks on
    FSDP_REPLICATED_MESH; n = 2, K = 4, 4 × 128 tokens a client, 8 groups,
    pallas_packed: each rank its (fsdp, model) pieces of its client's x
    and cx, ZeRO-3 gathers over fsdp, tensor parallelism over model, B6's
    vocab-parallel form on its vocabulary piece (the whole-vocabulary B6
    launches no time), B5 on its heads (recurrentgemma-9b's one KV head on
    both model ranks), B7 on its SSM heads, B8 and its backward on its LRU
    channels, B1 on its shard of the packed state.  Each run held to its
    host path, run in this process from the same seed while the ranks run,
    at its limits (``fsdp_run_tols``), printed before the reading; a MoE
    run's expert choices on its first batch counted against the host
    path's (none may differ in f32).  No fallback: a failure fails the phase.  Per rank and run:
    the state's bytes against a client's, peak memory, the seconds and
    bytes a round of the fsdp gathers, the reduce-scatters, the model
    sums, the sequence's gathers and reduce-scatters (as many calls), the
    RG-LRU gate input's gathers, the gradients' sums (``"replicated"``)
    and the gossip, rounds/s and seconds a round, the launches by route.
    Then remat's memory at one rank a client (:func:`remat_memory`)."""
    import gc
    import tempfile

    import torch

    from repro_torch.dist import launch as dist_launch

    t_phase = time.perf_counter()
    c, f, m = FSDP_MESH
    world = c * f * m
    emit({"phase": "fsdp_mesh", "case": "plan", "mesh": list(FSDP_MESH),
          "world": world, "backend": "gloo", "placement": "every rank on "
          "cuda:0", "impl": "pallas_packed",
          "runs": [{"name": r[0], "arch": r[1], "mesh": list(fsdp_mesh_of(r)),
                    "layers": r[2] if r[2] is not None else "reduced",
                    "rounds": r[3], "compute_dtype": r[4],
                    "moe_expert_parallel": r[5],
                    "routing_replayed": r[6],
                    "remat": fsdp_remat(r),
                    "param_mode": fsdp_opts(r).get("param_mode", "fsdp2d"),
                    "held_to": (f"run {fsdp_opts(r)['compare_to']}, bit for "
                                "bit where the kernels are deterministic"
                                if "compare_to" in fsdp_opts(r)
                                else "its host path"),
                    "tolerance_x_cx": fsdp_run_tols(r)[0],
                    "tolerance_y_cy": fsdp_run_tols(r)[1]}
                   for r in FSDP_MESH_RUNS]})
    cfgs = [fsdp_run_cfg(r) for r in FSDP_MESH_RUNS]
    with tempfile.TemporaryDirectory() as store:
        gc.collect()
        torch.cuda.empty_cache()
        drawn = []
        for index, (run, cfg) in enumerate(zip(FSDP_MESH_RUNS, cfgs)):
            init_batch, rounds_b = fsdp_mesh_batches(cfg, dev, run[3])
            torch.save({"init": {k: v.cpu() for k, v in init_batch.items()},
                        "rounds": [{k: v.cpu() for k, v in b.items()}
                                   for b in rounds_b]},
                       os.path.join(store, f"batches_{index}.pt"))
            drawn.append((init_batch, rounds_b))
        # the world on FSDP_MESH starts while the host paths run here, one
        # a run in the ranks' order; the ranks wait for each one's pieces.
        # A world on another mesh starts after it, the host paths done
        got = {}

        def start_world():
            try:
                got["ranks"] = dist_launch.run_world(
                    world, fsdp_mesh_rank, store, dev, FSDP_MESH,
                    backend="gloo", store_dir=store, device=dev)
            except BaseException as e:  # raised again below
                got["error"] = e

        t0, spawned = time.perf_counter(), time.time()
        thread = threading.Thread(target=start_world)
        thread.start()
        host, host_s = [], []
        try:
            for index, (run, cfg) in enumerate(zip(FSDP_MESH_RUNS, cfgs)):
                if "compare_to" in fsdp_opts(run):
                    # held to another run of the mesh: no host path
                    host.append(None)
                    host_s.append(None)
                    continue
                t1 = time.perf_counter()
                host.append(fsdp_host_path(index, run, cfg, dev, store,
                                           *drawn[index]))
                host_s.append(time.perf_counter() - t1)
                gc.collect()
                torch.cuda.empty_cache()
            del drawn
        except BaseException:
            # the ranks waiting for a host path fail at once
            open(os.path.join(store, "host_failed"), "w").close()
            raise
        finally:
            thread.join()
        world_s = time.perf_counter() - t0
        if "error" in got:
            raise got["error"]
        ranks = got["ranks"]
        ranks_of, worlds_s = {FSDP_MESH: ranks}, {str(FSDP_MESH): world_s}
        for mesh in dict.fromkeys(fsdp_mesh_of(r) for r in FSDP_MESH_RUNS):
            if mesh in ranks_of:
                continue
            gc.collect()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            ranks_of[mesh] = dist_launch.run_world(
                math.prod(mesh), fsdp_mesh_rank, store, dev, mesh,
                backend="gloo", store_dir=store, device=dev)
            worlds_s[str(mesh)] = time.perf_counter() - t1
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        shapes = fsdp_kernel_times(gen, dev)
    memory = remat_memory(dev, smi)
    kinds = {"fsdp_gathers": ("local_steps", "fsdp_gather"),
             "grad_sums": ("local_steps", "grad_sum"),
             "reduce_scatters": ("local_steps", "reduce_scatter"),
             "model_sums": ("local_steps", "model_sum"),
             "seq_gathers": ("local_steps", "seq_gather"),
             "seq_scatters": ("local_steps", "seq_scatter"),
             "model_gathers": ("local_steps", "model_gather"),
             "model_scatters": ("local_steps", "model_scatter"),
             "model_maxes": ("local_steps", "all_reduce_max"),
             "batch_sums": ("local_steps", "batch_sum"),
             "gossip": ("gossip", "all_gather")}
    routed = ("flash_attention", "ce_partials", "fused_cross_entropy",
              "ssd_scan", "rglru_scan", "fused_gossip")
    runs_out = []
    for index, (run, cfg) in enumerate(zip(FSDP_MESH_RUNS, cfgs)):
        want = fsdp_want_launches(run, cfg)
        route_of = fsdp_route_of(run, cfg)
        tol_x, tol_y = fsdp_run_tols(run)
        held = host[index] or host[fsdp_opts(run)["compare_to"]]
        lines = []
        for rank in ranks_of[fsdp_mesh_of(run)]:
            rec = rank["runs"][index]
            what = f"fsdp_mesh {run[0]} rank {rank['rank']}"
            if not rec["finite"]:
                fail(f"{what}: a state leaf is not finite")
            e = rec["rel_err"]
            if not (e["x"] <= tol_x and e["cx"] <= tol_x
                    and e["y"] <= tol_y and e["cy"] <= tol_y):
                fail(f"{what}: the state differs from the host path {e}")
            if rec["launches"] != {**dict.fromkeys(rec["launches"], 0),
                                   **want}:
                fail(f"{what}: launches {rec['launches']}, expected {want}")
            bwd = fsdp_backward_launches(run, cfg)
            if rec["backward_launches"]["rglru_scan"] != bwd:
                fail(f"{what}: B8's backward launched "
                     f"{rec['backward_launches']['rglru_scan']} times, "
                     f"expected {bwd}")
            check_routes({k: rec["routes"][k] for k in routed}, want, what,
                         route_of=route_of)
            if rec["compare_to"] is not None:
                # the kernels and GEMMs of both runs take the same inputs
                # in the same order; a difference is a nondeterministic
                # kernel, held at the bf16 limits above
                emit({"phase": "fsdp_mesh", "case": f"{run[0]} rank "
                      f"{rank['rank']} against run {rec['compare_to']}",
                      "bit_for_bit": rec["bit_for_bit"], "rel_err": e,
                      "reason": None if rec["bit_for_bit"] else
                      "not bit for bit: a kernel or GEMM of the round is "
                      "not deterministic on this card; held at TOL_MESH_X "
                      "/ TOL_MESH_Y"})
            by_kind = {}
            for name, (ph, kind) in kinds.items():
                v = rec["collectives"].get(ph, {}).get(kind)
                by_kind[name] = None if v is None else {
                    "calls_a_round": v["calls"] / run[3],
                    "bytes_a_round": v["bytes"] / run[3],
                    "seconds_a_round": v["seconds"] / run[3]}
            if fsdp_replicated(run):
                # whole weights: no gather; each gradient summed over the
                # block; a mixer's input gathered (again in the recompute)
                # and its gradient reduce-scattered once
                needed = ["grad_sums", "batch_sums", "seq_gathers",
                          "seq_scatters", "gossip"]
                seq_ratio = 2 if fsdp_remat(run) else 1
                for name in ("fsdp_gathers", "reduce_scatters"):
                    if by_kind[name] is not None:
                        fail(f"{what}: {name} under param_mode="
                             "'replicated'")
            else:
                needed = ["fsdp_gathers", "reduce_scatters", "model_sums",
                          "seq_gathers", "seq_scatters", "gossip"]
                seq_ratio = 1
            if "rglru" in cfg.blocks():
                needed += ["model_gathers", "model_scatters"]
            for name in needed:
                if by_kind[name] is None:
                    fail(f"{what}: no {name} in the round")
            if (by_kind["seq_gathers"]["calls_a_round"]
                    != seq_ratio * by_kind["seq_scatters"]["calls_a_round"]):
                fail(f"{what}: {by_kind['seq_gathers']['calls_a_round']} "
                     "sequence gathers a round against "
                     f"{by_kind['seq_scatters']['calls_a_round']} "
                     f"reduce-scatters, not {seq_ratio}:1")
            line = {"run": run[0], "rank": rank["rank"],
                    "device": rank["device"], "clients": rec["clients"],
                    "block_fsdp_model": rec["block"],
                    "state_gb": rec["state_bytes"] / 1e9,
                    "client_x_gb": held["client_x_bytes"] / 1e9,
                    "x_cx_share_of_a_client": (
                        (rec["state_bytes"] - 2 * 4 * TRAIN_G)
                        / (2 * held["client_x_bytes"])),
                    "remat": fsdp_remat(run),
                    "param_mode": fsdp_opts(run).get("param_mode",
                                                     "fsdp2d"),
                    "bit_for_bit_with_run": (None if rec["compare_to"] is None
                                             else [rec["compare_to"],
                                                   rec["bit_for_bit"]]),
                    "peak_memory_gb": rec["peak_memory_gb"],
                    "setup_s": rec["setup_s"], "init_s": rec["init_s"],
                    "check_s": rec["check_s"], "seconds": rec["seconds"],
                    "seconds_a_round": rec["seconds"] / run[3],
                    "rounds_per_s": rec["rounds_per_s"],
                    "collectives_a_round": by_kind,
                    "staged_bytes_a_round":
                        rec["collectives"]["staged_bytes"] / run[3],
                    "rel_err": e, "expert_flips": rec["expert_flips"],
                    "routing_replayed": run[6],
                    "shared_leaves": rec["shared_leaves"],
                    "launches": {k: rec["launches"][k] for k in want},
                    "backward_launches": rec["backward_launches"],
                    "launches_by_route": {k: rec["routes"][k]
                                          for k in routed}}
            if (cfg.moe.num_experts and run[4] == "float32"
                    and rec["expert_flips"]):
                fail(f"{what}: {rec['expert_flips']} expert choices differ "
                     "from the host path's in f32")
            emit({"phase": "fsdp_mesh", "case": f"{run[0]} rank "
                  f"{rank['rank']}", "nvidia_smi": smi, **line})
            lines.append(line)
        runs_out.append({"name": run[0], "mesh": list(fsdp_mesh_of(run)),
                         "ranks": lines,
                         "host_path_s": host_s[index],
                         "host_round_s": (None if host[index] is None else
                                          host[index]["seconds"] / run[3]),
                         "remat": fsdp_remat(run),
                         "param_mode": fsdp_opts(run).get("param_mode",
                                                          "fsdp2d"),
                         "peak_memory_gb_by_rank": [
                             ln["peak_memory_gb"] for ln in lines],
                         "seconds_a_round_by_rank": [
                             ln["seconds_a_round"] for ln in lines],
                         "launches": lines[0]["launches"],
                         "launches_by_route": lines[0]["launches_by_route"],
                         "backward_launches": lines[0]["backward_launches"],
                         "expert_flips": [ln["expert_flips"]
                                          for ln in lines]})
    out = {"runs": runs_out, "world_s": world_s, "worlds_s": worlds_s,
           "spawn_to_ranks_s": [r["entered"] - spawned for r in ranks],
           "kernel_times": shapes, "remat_memory": memory,
           "phase_s": time.perf_counter() - t_phase,
           "launches": dict(ranks[0]["runs"][0]["launches"]),
           "launches_by_route": {k: ranks[0]["runs"][0]["routes"][k]
                                 for k in routed}}
    emit({"phase": "fsdp_mesh", "case": "summary", "nvidia_smi": smi,
          **{k: v for k, v in out.items() if k not in ("kernel_times",)},
          "runs": [{k: v for k, v in r.items() if k != "ranks"}
                   for r in runs_out]})
    return out


# ---------------------------------------------------------------------------
# phase 15c: the serving mesh
# ---------------------------------------------------------------------------

def serve_mesh_inputs(cfg, dev, dtype, seed=0, rows=None, prompt_len=None):
    """``launch.serve.serve``'s draws: the weights in ``dtype``, then
    ``rows`` prompts (SERVE_MESH_B) of ``prompt_len`` tokens
    (SERVE_MESH_PROMPT), from one generator seeded with ``seed`` (every
    rank draws the same)."""
    import torch

    from repro_torch.models import model as model_lib

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = model_lib.init_params(cfg, generator=gen, device=dev, dtype=dtype)
    prompt = torch.randint(0, cfg.vocab_size,
                           (rows or SERVE_MESH_B,
                            prompt_len or SERVE_MESH_PROMPT),
                           generator=gen, device=dev)
    return model, prompt


def shard_inputs(cfg, m, rank, dev, dtype, seed, rows, prompt_len):
    """:func:`serve_mesh_inputs` on a model rank: the same draws, the
    weights kept as the rank's shard only (``tp.init_shard``)."""
    import torch

    from repro_torch.dist import tensor_parallel as tp

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shard = tp.init_shard(cfg, m, rank, generator=gen, device=dev,
                          dtype=dtype)
    prompt = torch.randint(0, cfg.vocab_size, (rows, prompt_len),
                           generator=gen, device=dev)
    return shard, prompt


def serve_single_process(model, prompt, gen_tokens, generator) -> dict:
    """The serving mesh's single-process reference in bf16: one prefill
    (``models.model.forward``) into caches of the prompt's length, grown
    for the new tokens (``grow_caches``), then ``gen_tokens`` eager
    ``decode_step`` calls at (B,) positions, each fed the token sampled
    (``launch.serve.sample``) from the step before.  Returns the last
    logits then each step's, the fed tokens, the prefill's caches and the
    seconds."""
    import torch

    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib

    cfg, dt = model.cfg, torch.bfloat16
    b, p = prompt.shape[:2]
    with torch.no_grad():
        caches = model_lib.init_cache(cfg, b, p, dtype=dt,
                                      device=prompt.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, _ = model_lib.forward(
            model, {"tokens": prompt}, mode="prefill", compute_dtype=dt,
            caches=caches, last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_caches = caches
        caches = [{k: v.clone() for k, v in c.items()}
                  for c in model_lib.grow_caches(cfg, caches, p + gen_tokens)]
        outs, toks = [logits], []
        t0 = time.perf_counter()
        for i in range(gen_tokens):
            tok = serve_lib.sample(logits, 1.0, generator)
            toks.append(tok)
            logits, caches = model_lib.decode_step(
                model, caches, tok,
                torch.full((b,), p + i, device=prompt.device),
                compute_dtype=dt)
            outs.append(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    return {"logits": torch.cat(outs, dim=1), "tokens": torch.cat(toks, dim=1),
            "prefill_caches": prefill_caches, "prefill_s": prefill_s,
            "decode_s": decode_s}


def weights_fingerprint(model) -> list:
    """Each parameter's f64 sum: what the ranks' own draws must give."""
    return [float(p.double().sum()) for p in model.parameters()]


def shard_fingerprints(model, m) -> list:
    """Each model rank's f64 sum of each leaf of its shard, by name: what
    ``tp.init_shard`` must give there."""
    from repro_torch.dist import tensor_parallel as tp

    the_plan = tp.plan(model.cfg, m)
    return [{n: float((p if the_plan[n] is None else the_plan[n].take(p, r))
                      .double().sum()) for n, p in model.named_parameters()}
            for r in range(m)]


def serve_mesh_formula(cfg, nb, s, t, m, elt, model_rank=0) -> dict:
    """The collectives of model rank ``model_rank`` of m: a prefill splits
    the residual's sequence of S positions over the model ranks in pieces
    of k = ⌈S/m⌉ and makes, in the compute dtype, a reduce-scatter after
    each layer's mixer (its out-projection) and MLP and of the embedding
    rows, each receiving (m − 1)·nb·k·d; an all-gather of the pieces
    before each of those mixers and MLPs, as many bytes; one broadcast of
    the last position's hidden row (nb·d, received by every rank but the
    last); an ``ssm`` layer's f32 all-reduce of its gated norm's sums of
    squares (nb·S); and all-gathers of the last logits' vocab pieces
    ((m − 1)·nb·⌈V/m⌉) and of each ``rglru`` layer's gate input ((m −
    1)·nb·S·W/m).  A decode step keeps the residual whole: 2L + 1 f32
    all-reduces — after each layer's mixer and MLP, of nb·d, or for an
    ``ssm`` layer after its out-projection and of its gated norm's sums of
    squares, nb·d and nb; and of the embedding rows, nb·d — and the same
    all-gathers at S = 1.  None at m = 1."""
    if m == 1:
        return {}
    from repro_torch.dist import collectives
    from repro_torch.dist import tensor_parallel as tp

    kinds, d = cfg.blocks(), cfg.d_model
    n_ssm, n_lru = kinds.count("ssm"), kinds.count("rglru")
    w = cfg.rglru.channels(cfg.d_model)
    vmax = max(tp.pieces(cfg.vocab_size, m, "vocab_size"))
    n = 2 * len(kinds) - n_ssm

    def gathers(seq, k):
        return {"calls": k * (1 + n_lru),
                "bytes": k * (m - 1) * elt * (nb * vmax
                                              + n_lru * nb * seq * (w // m))}

    piece = (m - 1) * nb * -(-s // m) * d * elt
    widths = collectives.fsdp_widths(s, m)
    last = max(r for r, width in enumerate(widths) if width)
    prefill = {"seq_scatter": {"calls": n + 1, "bytes": (n + 1) * piece},
               "seq_gather": {"calls": n, "bytes": n * piece},
               "broadcast": {"calls": 1, "bytes": 0 if model_rank == last
                             else nb * d * elt},
               "all_gather": gathers(s, 1)}
    if n_ssm:
        prefill["all_reduce"] = {"calls": n_ssm, "bytes": 4 * nb * s * n_ssm}
    decode = {"all_reduce": {"calls": t * (2 * len(kinds) + 1),
                             "bytes": t * 4 * nb * (
                                 (2 * len(kinds) - n_ssm + 1) * d + n_ssm)},
              "all_gather": gathers(1, t)}
    return {"prefill": prefill, "decode": decode}


def rank_device() -> str:
    """The card a spawned rank runs on (``dist.launch.run_world`` set
    it)."""
    import torch

    return f"cuda:{torch.cuda.current_device()}"


def mesh_serve_record(res, mesh, rank, dev, launches, routes, peak, smp):
    """What a rank of the serve_mesh phase returns of one
    ``generate_on_mesh`` run (``smp``: each step's sample, compared over
    the model ranks first)."""
    from repro_torch.dist import collectives

    with collectives.phase("check"):
        every = collectives.all_gather_rows(smp[None], mesh.model_axis)
    return {"rank": rank, "device": dev, "batch_rank": mesh.batch_axis.rank,
            "model_rank": mesh.model_axis.rank,
            "rows": (res.rows.start, res.rows.stop),
            "logits": res.logits.cpu(),
            "caches": [{k: v.cpu() for k, v in c.items()}
                       for c in res.prefill_caches],
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "collectives": res.collectives, "launches": launches,
            "routes": routes, "launches_prefill": res.launches["prefill"],
            "launches_decode": res.launches["decode"],
            "peak_memory_gb": peak, "same_tokens": res.same_tokens,
            "same_samples": bool((every == smp[None]).all())}


def step_samples(logits, dev):
    """Each step's sample of ``logits`` (B, steps, V) from a generator
    seeded with SERVE_MESH_SAMPLE_SEED, as every rank draws them."""
    import torch

    from repro_torch.launch import serve as serve_lib

    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_MESH_SAMPLE_SEED)
    return torch.cat([serve_lib.sample(logits[:, i:i + 1], 1.0, gen)
                      for i in range(logits.shape[1])], dim=1)


def serve_scan_rank(rank, dev, mesh, arch, spec) -> list:
    """The scan arch ``arch`` on this rank of the (1, 2) mesh: the rank's
    shard drawn piece by piece (``tp.init_shard``; its fingerprint and the
    prompts checked against the parent's), the bf16 prefill and
    SERVE_SCAN_GEN decode steps fed the parent's tokens (the process warm
    from qwen2-0.5b's runs), then the f32 prefill at the arch's f32
    depth."""
    import gc

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import serve as serve_lib

    rows, layers, f32_layers = SERVE_SCAN[arch]
    cfg = dataclasses.replace(registry.get_model_config(arch),
                              num_layers=layers)
    m, r = mesh.model_axis.size, mesh.model_axis.rank
    shard, prompt = shard_inputs(cfg, m, r, dev, torch.bfloat16, 0, rows,
                                 SERVE_SCAN_PROMPT)
    if not torch.equal(prompt.cpu(), spec["prompt"]):
        raise AssertionError(f"rank {rank} drew other {arch} prompts")
    if {n: float(t.double().sum()) for n, t in shard.items()} != \
            spec["fingerprints"][r]:
        raise AssertionError(f"rank {rank} drew another {arch} shard")
    forced = spec["tokens"].to(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    res = serve_lib.generate_on_mesh(mesh, cfg, shard, prompt,
                                     SERVE_SCAN_GEN, forced=forced)
    launches, routes = launch_counts(), route_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = mesh_serve_record(res, mesh, rank, dev, launches, routes, peak,
                            step_samples(res.logits, dev))
    out = [{"arch": arch, "shape": SERVE_SCAN_SHAPE, **rec}]
    del res, shard, prompt
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, num_layers=f32_layers)
    shard32, prompt32 = shard_inputs(cfg32, m, r, dev, torch.float32, 0,
                                     rows, SERVE_SCAN_PROMPT)
    res = serve_lib.generate_on_mesh(mesh, cfg32, shard32, prompt32, 0,
                                     compute_dtype=torch.float32)
    out.append({"arch": arch, "shape": "f32", "rank": rank,
                "model_rank": r, "logits": res.logits.cpu(),
                "caches": [{k: v.cpu() for k, v in c.items()}
                           for c in res.prefill_caches]})
    del res, shard32, prompt32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_mesh_rank(rank, world, spec):
    """One rank of the serve_mesh phase: the serving meshes
    SERVE_MESH_SHAPES over this world, qwen2-0.5b drawn here from the
    parent's seed (its prompts and weights' fingerprint checked against
    the parent's), a short warm-up, then on each mesh one prefill of the
    parent's prompts and SERVE_MESH_GEN decode steps fed the parent's
    tokens (``launch.serve.generate_on_mesh``), the kernels' launches by
    route and the collectives counted around each; the model ranks'
    samples from every step's logits compared; the f32 prefill at
    SERVE_MESH_F32_LAYERS layers on (1, 2); then each arch of SERVE_SCAN
    on (1, 2) (:func:`serve_scan_rank`)."""
    import gc

    import torch

    from repro_torch.configs import registry
    from repro_torch.dist import collectives
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device()
    meshes = {shape: mesh_lib.serve_mesh(*shape)
              for shape in SERVE_MESH_SHAPES}
    cfg = registry.get_model_config(SERVE_MESH_ARCH)
    model, prompt = serve_mesh_inputs(cfg, dev, torch.bfloat16)
    if not torch.equal(prompt.cpu(), spec["prompt"]):
        raise AssertionError(f"rank {rank} drew other prompts")
    if weights_fingerprint(model) != spec["fingerprint"]:
        raise AssertionError(f"rank {rank} drew other weights")
    params = model_lib.param_dict(model)
    del model
    forced = spec["tokens"].to(dev)
    # whether the backend sums bf16 itself (the partial sums cross in f32)
    probe = torch.tensor([1.0, 2.0 ** -8], dtype=torch.bfloat16,
                         device=dev) * (rank + 1)
    try:
        bf16_sum = collectives.all_reduce_sum(
            probe, meshes[(1, 2)].model_axis).float().tolist()
    except Exception as e:  # a probe: its failure is the answer
        bf16_sum = f"{type(e).__name__}: {e}"
    # a short warm-up on the first mesh: library loads, cuBLAS handles
    def shard(params, cfg, mesh):
        m, r = mesh.model_axis.size, mesh.model_axis.rank
        return tp.shard_params(params, tp.plan(cfg, m), r)

    first = meshes[SERVE_MESH_SHAPES[0]]
    serve_lib.generate_on_mesh(first, cfg, shard(params, cfg, first),
                               prompt[:, :256], 1, forced=forced[:, :1])
    out = []
    for shape in SERVE_MESH_SHAPES:
        mesh = meshes[shape]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        res = serve_lib.generate_on_mesh(mesh, cfg, shard(params, cfg, mesh),
                                         prompt, SERVE_MESH_GEN,
                                         forced=forced)
        launches, routes = launch_counts(), route_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        rec = mesh_serve_record(res, mesh, rank, dev, launches, routes, peak,
                                step_samples(res.logits, dev))
        out.append({"arch": SERVE_MESH_ARCH, "shape": shape, **rec,
                    "gloo_bf16_sum": bf16_sum})
        del res
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, num_layers=SERVE_MESH_F32_LAYERS)
    model32, prompt32 = serve_mesh_inputs(cfg32, dev, torch.float32)
    res = serve_lib.generate_on_mesh(
        meshes[(1, 2)], cfg32, shard(model_lib.param_dict(model32), cfg32,
                                     meshes[(1, 2)]), prompt32, 0,
        compute_dtype=torch.float32)
    out.append({"arch": SERVE_MESH_ARCH, "shape": "f32", "rank": rank,
                "model_rank": meshes[(1, 2)].model_axis.rank,
                "logits": res.logits.cpu(),
                "caches": [{k: v.cpu() for k, v in c.items()}
                           for c in res.prefill_caches]})
    del res, model32, prompt32
    gc.collect()
    torch.cuda.empty_cache()
    for arch in SERVE_SCAN:
        out += serve_scan_rank(rank, dev, meshes[SERVE_SCAN_SHAPE], arch,
                               spec["scan"][arch])
    return out


def gather_mesh_serve(recs, cfg):
    """The mesh's logits (B, steps, V) and prefill caches (per layer) from
    its ranks: every model rank's logits bit for bit alike (else None), the
    rows in batch-rank order, each batch shard's caches joined over its
    model ranks (``tp.gather_caches``: KV heads, SSM heads and channels,
    LRU channels; a replicated piece equal on every rank that holds it)."""
    import torch

    from repro_torch.dist import tensor_parallel as tp

    by_b = {}
    for r in recs:
        by_b.setdefault(r.get("batch_rank", 0), []).append(r)
    logits, caches, alike = [], None, True
    for b in sorted(by_b):
        group = sorted(by_b[b], key=lambda r: r["model_rank"])
        alike &= all(torch.equal(r["logits"], group[0]["logits"])
                     for r in group[1:])
        logits.append(group[0]["logits"])
        layers = tp.gather_caches([r["caches"] for r in group], cfg)
        caches = layers if caches is None else [
            {k: torch.cat([c[k], lay[k]]) for k in c}
            for c, lay in zip(caches, layers)]
    return torch.cat(logits), caches, alike


def caches_rel_err(got, want) -> float:
    return max(rel_err(g[k], w[k].cpu()) for g, w in zip(got, want)
               for k in g)


def b5_shard_times(gen, dev, cfg, m, b=None, s=None, window=0) -> dict:
    """B5 at a model rank's shard of a served prefill, bf16 causal (with
    ``window``): (b, s, H/m, the rank's KV heads, D) on its tensor-core
    route against its plain version (TOL_ATTN_BF16), with the kernel's,
    the plain version's and SDPA's times (k and v expanded to the query
    heads; a banded bool mask with a window) and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.kernels import flash_attention, ref

    b, s = b or SERVE_MESH_B, s or SERVE_MESH_PROMPT
    rank_cfg = tp.shard_config(cfg, m, 0)
    h, kv = rank_cfg.num_heads, rank_cfg.num_kv_heads
    d = cfg.resolved_head_dim
    q, k, v = attn_operands(b, s, s, h, kv, d, torch.bfloat16, gen, dev)
    got = routed_call(lambda: flash_attention.flash_attention_bshd(
        q, k, v, causal=True, window=window), "flash_attention",
        "tensor_core")
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    err, rel = max_err(got.float(), want.float()), rel_err(got, want)
    del want
    if not rel <= TOL_ATTN_BF16:
        fail(f"flash_attention at the shard shape {(b, s, h, kv, d)}: "
             f"{rel} > {TOL_ATTN_BF16} × (1 + max)")
    del got
    ms = cuda_ms(lambda: flash_attention.flash_attention_bshd(
        q, k, v, causal=True, window=window), reps=21)
    pms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True,
                                            window=window), reps=5)
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1)
              for x in (k, v))
    if window:
        i = torch.arange(s, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), reps=21)
        lib = f"banded bool mask (window {window})"
    else:
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=21)
        lib = "is_causal=True"
    bound, by = attn_bound_ms(b, s, s, h, kv, d, window, 2, BF16_FLOP_S)
    torch.cuda.empty_cache()
    return dict(shape=[b, s, h, kv, d], window=window, ms=ms, plain_ms=pms,
                library_ms=lms, bound_ms=bound, bound_by=by,
                max_abs_err=err, rel_err=rel, tol=TOL_ATTN_BF16,
                route="tensor_core",
                library=f"F.scaled_dot_product_attention({lib}), k/v "
                        f"expanded to {h} heads")


def b7_shard_times(gen, dev, cfg, m, b, s=None, state0=True) -> dict:
    """B7 at a model rank's shard of mamba2-1.3b's served prefill, (b,
    SERVE_SCAN_PROMPT, H/m, P, N) with a zero state0 (the prefill's zero
    cache), or at ``s`` tokens without one (training), on its tensor-core
    route against its plain version (TOL_SSD), with the kernel's and the
    plain version's times and the bound (no PyTorch call computes it)."""
    import torch

    from repro_torch.kernels import ref, ssd_scan

    s_cfg = cfg.ssm
    h = s_cfg.heads(cfg.d_model) // m
    s, p, n, chunk = s or SERVE_SCAN_PROMPT, s_cfg.d_head, s_cfg.d_state, \
        s_cfg.chunk
    xdt, loga, bm, cm, _ = ssd_operands(b, s, h, p, n, gen, dev)
    s0 = torch.zeros((b, h, p, n), device=dev) if state0 else None
    y, fin = routed_call(lambda: ssd_scan.ssd_scan_bshp(
        xdt, loga, bm, cm, s0, chunk=chunk), "ssd_scan", "tensor_core")
    py, pfin = ref.ssd_chunked(xdt, loga, bm, cm, chunk, s0)
    err = max(max_err(y, py), max_err(fin, pfin))
    rel = max(rel_err(y, py), rel_err(fin, pfin))
    del y, fin, py, pfin
    if not rel <= TOL_SSD:
        fail(f"ssd_scan at the shard shape {(b, s, h, p, n)}: {rel} > "
             f"{TOL_SSD} × (1 + max)")
    ms = cuda_ms(lambda: ssd_scan.ssd_scan_bshp(
        xdt, loga, bm, cm, s0, chunk=chunk), reps=11)
    pms = cuda_ms(lambda: ref.ssd_chunked(xdt, loga, bm, cm, chunk, s0),
                  reps=3)
    bound, by = ssd_bound_ms(b, s, h, p, n, chunk, with_state0=state0,
                             tensor_cores=True)
    del xdt, loga, bm, cm, s0
    torch.cuda.empty_cache()
    return dict(shape=[b, s, h, p, n], chunk=chunk, ms=ms, plain_ms=pms,
                library_ms=None, bound_ms=bound, bound_by=by,
                max_abs_err=err, rel_err=rel, tol=TOL_SSD,
                route="tensor_core",
                segments=ssd_scan.segments(b, h, -(-s // chunk))[0])


def b8_shard_times(gen, dev, cfg, m, b, s=None) -> dict:
    """B8 at a model rank's shard of recurrentgemma-9b's served prefill,
    (b, SERVE_SCAN_PROMPT or ``s``, W/m), against its plain version on
    both routes (the rule's at TOL_SCAN, the walk bit for bit), with both
    routes' times, the backward kernel's, the plain version's and the
    bounds (``b8_times``; no PyTorch call computes it)."""
    import torch

    from repro_torch.kernels import ref, rglru_scan

    shape = (b, s or SERVE_SCAN_PROMPT, cfg.rglru.channels(cfg.d_model) // m)
    a, u = rglru_operands(shape, gen, dev)
    want = ref.rglru_ref(a, u)
    rt = rglru_scan.route(*shape)
    errs = {}
    for r in dict.fromkeys((rt, "walk")):
        got = rglru_scan.rglru_scan_bsw(a, u, force_route=r)
        errs[r] = (max_err(got, want), rel_err(got, want))
        del got
    del a, u, want
    torch.cuda.empty_cache()
    if errs["walk"][0] != 0.0:
        fail(f"rglru_scan at the shard shape {shape}: the walk is off the "
             f"plain version by {errs['walk'][0]}")
    if not errs[rt][1] <= TOL_SCAN:
        fail(f"rglru_scan at the shard shape {shape}: {errs[rt][1]} > "
             f"{TOL_SCAN} × (1 + max) on the {rt} route")
    return dict(**b8_times(gen, dev, shape), max_abs_err=errs[rt][0],
                rel_err=errs[rt][1], rel_err_by_route={
                    r: e[1] for r, e in errs.items()}, tol=TOL_SCAN)


def scan_kernel_routes(cfg, rows, channels) -> dict:
    """The route of each two-route model kernel in a bf16 prefill of
    ``rows`` prompts of SERVE_SCAN_PROMPT tokens over ``channels`` LRU
    channels: B5 and B7 on tensor cores, B8 by its rule."""
    from repro_torch.kernels import rglru_scan

    return {"flash_attention": "tensor_core", "ssd_scan": "tensor_core",
            "rglru_scan": rglru_scan.route(rows, SERVE_SCAN_PROMPT,
                                           channels)}


def scan_kernel_launches(cfg) -> dict:
    """The model kernels' launches of one prefill of ``cfg`` (one a
    layer of its kind: B5 an attention layer, B7 an ``ssm`` layer, B8 an
    ``rglru`` layer); none in decode."""
    kinds = cfg.blocks()
    return {"flash_attention": sum(k in ("attn", "sliding", "attn_local",
                                         "moe") for k in kinds),
            "ssd_scan": kinds.count("ssm"),
            "rglru_scan": kinds.count("rglru")}


def scan_single_process(dev, gen, arch, smi) -> tuple:
    """The parent's side of SERVE_SCAN[arch]: the bf16 single process at
    the arch's depth (:func:`serve_single_process`, its launches), the
    f32 prefill at its f32 depth, each rank's shard fingerprints and the
    kernels at a model rank's shapes; returns (what the ranks are given,
    what they are held to), everything on the host."""
    import gc

    import torch

    from repro_torch.configs import registry
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.models import model as model_lib

    rows, layers, f32_layers = SERVE_SCAN[arch]
    m = SERVE_SCAN_SHAPE[1]
    cfg = dataclasses.replace(registry.get_model_config(arch),
                              num_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, prompt = serve_mesh_inputs(cfg, dev, torch.bfloat16, rows=rows,
                                      prompt_len=SERVE_SCAN_PROMPT)
    gen_s = torch.Generator(device=dev)
    gen_s.manual_seed(SERVE_MESH_SAMPLE_SEED)
    zero_launch_counts()
    ref = serve_single_process(model, prompt, SERVE_SCAN_GEN, gen_s)
    launches, routes = launch_counts(), route_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = scan_kernel_launches(cfg)
    for name, n in want.items():
        if launches[name] != n:
            fail(f"serve_mesh {arch} single process: {launches[name]} "
                 f"{name} launches, expected {n}")
    check_routes({k: routes[k] for k in want}, want,
                 f"serve_mesh {arch} single process",
                 route_of=scan_kernel_routes(
                     cfg, rows, cfg.rglru.channels(cfg.d_model)))
    spec = {"prompt": prompt.cpu(), "tokens": ref["tokens"].cpu(),
            "fingerprints": shard_fingerprints(model, m)}
    held = {"cfg": cfg, "logits": ref["logits"].cpu(),
            "caches": [{k: v.cpu() for k, v in c.items()}
                       for c in ref["prefill_caches"]],
            "single_process": {"prefill_s": ref["prefill_s"],
                               "decode_s": ref["decode_s"],
                               "decode_ms_a_token": 1e3 * ref["decode_s"]
                               / SERVE_SCAN_GEN,
                               "peak_memory_gb": peak,
                               "launches": {k: launches[k] for k in want},
                               "launches_by_route": {
                                   k: routes[k] for k in routes
                                   if k in want}}}
    del ref, model, prompt
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, num_layers=f32_layers)
    model32, prompt32 = serve_mesh_inputs(cfg32, dev, torch.float32,
                                          rows=rows,
                                          prompt_len=SERVE_SCAN_PROMPT)
    with torch.no_grad():
        logits32, caches32, _ = model_lib.forward(
            model32, {"tokens": prompt32}, mode="prefill",
            compute_dtype=torch.float32, last_only=True,
            caches=model_lib.init_cache(cfg32, rows, SERVE_SCAN_PROMPT,
                                        dtype=torch.float32, device=dev))
    held.update(cfg32=cfg32, logits32=logits32.cpu(),
                caches32=[{k: v.cpu() for k, v in c.items()}
                          for c in caches32])
    del model32, prompt32, logits32, caches32
    gc.collect()
    torch.cuda.empty_cache()
    shards = {}
    if want["ssd_scan"]:
        shards["ssd_scan"] = b7_shard_times(gen, dev, cfg, m, rows)
    if want["rglru_scan"]:
        shards["rglru_scan"] = b8_shard_times(gen, dev, cfg, m, rows)
    if want["flash_attention"]:
        shards["flash_attention"] = b5_shard_times(
            gen, dev, cfg, m, rows, SERVE_SCAN_PROMPT, cfg.rglru.local_window)
    for name, t in shards.items():
        emit({"phase": "serve_mesh", "kernel": name,
              "case": f"a model rank's shard of {arch}'s served prefill",
              "nvidia_smi": smi, **t})
    held["shards"] = shards
    return spec, held


def check_scan_mesh(arch, held, recs, recs32, backend, smi) -> dict:
    """The (1, 2) run of SERVE_SCAN[arch] held to the single process at
    the arch's TOL_SERVE_BF16 (the last logits, the caches gathered over
    heads, channels and rows, each teacher-forced decode step's logits),
    the model ranks' logits and samples alike, each rank's kernel launches
    (every one a prefill, each on its route — B5 and B7 on tensor cores,
    B8 by its rule at the rank's shard —, none in decode) and collectives
    against ``serve_mesh_formula``; the f32 prefill at TOL_SERVE_F32."""
    cfg = held["cfg"]
    rows = SERVE_SCAN[arch][0]
    what = f"serve_mesh {arch} {SERVE_SCAN_SHAPE}"
    tol = TOL_SERVE_BF16[arch]
    logits, caches, alike = gather_mesh_serve(recs, cfg)
    if not alike:
        fail(f"{what}: the model ranks' logits differ")
    if not all(r["same_tokens"] and r["same_samples"] for r in recs):
        fail(f"{what}: the ranks of a model group sampled apart")
    ref_logits = held["logits"]
    errs = {"prefill logits": rel_err(logits[:, :1], ref_logits[:, :1]),
            "decode logits": max(rel_err(logits[:, i:i + 1],
                                         ref_logits[:, i:i + 1])
                                 for i in range(1, logits.shape[1])),
            "caches": caches_rel_err(caches, held["caches"])}
    for name, e in errs.items():
        if not e <= tol:
            fail(f"{what}: {name} differ by {e} > {tol} × (1 + max)")
    nb = rows // SERVE_SCAN_SHAPE[0]
    want_by_rank = [serve_mesh_formula(cfg, nb, SERVE_SCAN_PROMPT,
                                       SERVE_SCAN_GEN, SERVE_SCAN_SHAPE[1], 2,
                                       r["model_rank"]) for r in recs]
    want_l = scan_kernel_launches(cfg)
    rank_routes = scan_kernel_routes(
        cfg, nb, cfg.rglru.channels(cfg.d_model) // SERVE_SCAN_SHAPE[1])
    for r, want_comm in zip(recs, want_by_rank):
        got = {ph: {k: {f: v[f] for f in ("calls", "bytes")}
                    for k, v in kinds.items()}
               for ph, kinds in r["collectives"].items()
               if ph in ("prefill", "decode")}
        if got != want_comm:
            fail(f"{what} rank {r['rank']}: collectives {got}, expected "
                 f"{want_comm}")
        full = {**dict.fromkeys(r["launches"], 0), **want_l}
        routed = {k: r["routes"][k] for k in want_l if k in r["routes"]}
        if (r["launches"] != full or r["launches_prefill"] != full
                or any(c.get(rank_routes[k]) != want_l[k]
                       for k, c in routed.items())):
            fail(f"{what} rank {r['rank']}: launches {r['launches']} "
                 f"(prefill {r['launches_prefill']}), routes {routed}; "
                 f"expected {full}, each on its route {rank_routes}")
    logits32, caches32, alike32 = gather_mesh_serve(recs32, held["cfg32"])
    f32 = {"rel_err_logits": rel_err(logits32, held["logits32"]),
           "rel_err_caches": caches_rel_err(caches32, held["caches32"])}
    if not (alike32 and max(f32.values()) <= TOL_SERVE_F32):
        fail(f"{what} f32: {f32} > {TOL_SERVE_F32}")
    tokens = rows * SERVE_SCAN_GEN
    decode_s = max(r["decode_s"] for r in recs)
    line = {"arch": arch, "layers": cfg.num_layers, "rows": rows,
            "prompt": SERVE_SCAN_PROMPT, "new_tokens": SERVE_SCAN_GEN,
            "mesh": list(SERVE_SCAN_SHAPE), "tolerance_bf16": tol,
            "rows_by_rank": [r["rows"] for r in recs],
            "devices_by_rank": [r["device"] for r in recs],
            "rel_err_prefill_logits": errs["prefill logits"],
            "rel_err_decode_logits": errs["decode logits"],
            "rel_err_caches": errs["caches"],
            "f32_layers": held["cfg32"].num_layers, "f32": f32,
            "tolerance_f32": TOL_SERVE_F32,
            "prefill_s_by_rank": [r["prefill_s"] for r in recs],
            "decode_ms_a_token_by_rank": [1e3 * r["decode_s"]
                                          / SERVE_SCAN_GEN for r in recs],
            "tokens_per_s": tokens / decode_s,
            "comm_s_by_rank": [sum(v["seconds"] for ph in ("prefill",
                                                           "decode")
                                   for v in r["collectives"].get(ph,
                                                                 {}).values())
                               for r in recs],
            "collectives_by_rank": [r["collectives"] for r in recs],
            "formula_by_rank": want_by_rank,
            "staged_gb_by_rank": [r["collectives"]["staged_bytes"] / 1e9
                                  for r in recs],
            "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in recs],
            "launches_by_rank": [{k: r["launches"][k] for k in want_l}
                                 for r in recs],
            "launches_by_route_by_rank": [
                {k: r["routes"][k] for k in want_l if k in r["routes"]}
                for r in recs],
            "single_process": held["single_process"]}
    emit({"phase": "serve_mesh", "case": f"{arch} {SERVE_SCAN_SHAPE} over "
          f"{backend}", "nvidia_smi": smi, **line})
    return line


def phase_serve_mesh(dev, gen, smi) -> dict:
    """The serving mesh (``launch.steps.build_prefill_step`` /
    ``build_decode_step`` through ``launch.serve.generate_on_mesh``):
    qwen2-0.5b at full width (24 layers, seed-0 bf16 weights) prefilling
    SERVE_MESH_B × SERVE_MESH_PROMPT tokens, then decoding SERVE_MESH_GEN.
    The single-process path first, in this process
    (:func:`serve_single_process`, its decode eager), and B5 at a model rank's
    shard shape against its plain version, timed beside SDPA and its
    bound; then the same for each arch of SERVE_SCAN
    (:func:`scan_single_process`: B7 or B8 and B5 at a model rank's
    shapes); then a world of SERVE_MESH_WORLD ranks (NCCL with a card a
    rank where the machine has two, else both on ``cuda:0`` over gloo) on
    ``(data 1, model 2)`` and ``(data 2, model 1)``: the last logits, the
    caches gathered over heads and rows, and every teacher-forced decode
    step's logits held to the single process at TOL_SERVE, the model
    ranks' logits and samples alike, B5 24 launches a prefill on every
    rank on tensor cores and none in decode, the collectives and bytes a
    rank against ``serve_mesh_formula``; the f32 prefill at
    SERVE_MESH_F32_LAYERS layers on (1, 2) at TOL_SERVE_F32; each arch of
    SERVE_SCAN on (1, 2) (:func:`check_scan_mesh`); and a world of 1 over
    NCCL in this process, bit for bit the single process."""
    import gc
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.dist import launch as dist_launch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= SERVE_MESH_WORLD else "gloo"
    t_phase = time.perf_counter()
    cfg = registry.get_model_config(SERVE_MESH_ARCH)
    emit({"phase": "serve_mesh", "case": "plan", "arch": SERVE_MESH_ARCH,
          "world": SERVE_MESH_WORLD, "backend": backend, "cards": cards,
          "placement": ("one card a rank" if backend == "nccl"
                        else "both ranks on cuda:0, every byte staged "
                             "through pinned host memory"),
          "meshes": [list(s) for s in SERVE_MESH_SHAPES],
          "batch": SERVE_MESH_B, "prompt": SERVE_MESH_PROMPT,
          "new_tokens": SERVE_MESH_GEN, "reduce_dtype": "float32",
          "tolerance_bf16": TOL_SERVE, "tolerance_f32": TOL_SERVE_F32,
          "f32_layers": SERVE_MESH_F32_LAYERS,
          "scan_archs": {a: {"rows": v[0], "layers": v[1], "f32_layers": v[2],
                             "tolerance_bf16": TOL_SERVE_BF16[a]}
                         for a, v in SERVE_SCAN.items()},
          "scan_mesh": list(SERVE_SCAN_SHAPE),
          "scan_prompt": SERVE_SCAN_PROMPT, "scan_new_tokens": SERVE_SCAN_GEN,
          "decode": "eager (a gloo collective cannot be captured)"})
    # the single process: bf16 at full depth, then f32 at 2 layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, prompt = serve_mesh_inputs(cfg, dev, torch.bfloat16)
    gen_s = torch.Generator(device=dev)
    gen_s.manual_seed(SERVE_MESH_SAMPLE_SEED)
    zero_launch_counts()
    ref = serve_single_process(model, prompt, SERVE_MESH_GEN, gen_s)
    ref_launches = launch_counts()
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    fingerprint = weights_fingerprint(model)
    cfg32 = dataclasses.replace(cfg, num_layers=SERVE_MESH_F32_LAYERS)
    model32, prompt32 = serve_mesh_inputs(cfg32, dev, torch.float32)
    with torch.no_grad():
        logits32, caches32, _ = model_lib.forward(
            model32, {"tokens": prompt32}, mode="prefill",
            compute_dtype=torch.float32, last_only=True,
            caches=model_lib.init_cache(cfg32, SERVE_MESH_B,
                                        SERVE_MESH_PROMPT,
                                        dtype=torch.float32, device=dev))
    logits32 = logits32.cpu()
    caches32 = [{k: v.cpu() for k, v in c.items()} for c in caches32]
    del model32, prompt32
    b5 = b5_shard_times(gen, dev, cfg, 2)
    emit({"phase": "serve_mesh", "kernel": "flash_attention",
          "case": "a model rank's shard of the served prefill",
          "nvidia_smi": smi, **b5})
    want_b5 = cfg.blocks().count("attn")
    if ref_launches["flash_attention"] != want_b5:
        fail(f"serve_mesh single process: {ref_launches['flash_attention']} "
             f"B5 launches, expected {want_b5}")
    spec = {"prompt": prompt.cpu(), "tokens": ref["tokens"].cpu(),
            "fingerprint": fingerprint, "scan": {}}
    ref_logits = ref["logits"].cpu()
    ref_caches = [{k: v.cpu() for k, v in c.items()}
                  for c in ref["prefill_caches"]]
    ref_times = {"prefill_s": ref["prefill_s"], "decode_s": ref["decode_s"]}
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    held = {}
    for arch in SERVE_SCAN:
        spec["scan"][arch], held[arch] = scan_single_process(dev, gen, arch,
                                                             smi)
    single_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        ranks = dist_launch.run_world(
            SERVE_MESH_WORLD, serve_mesh_rank, spec, backend=backend,
            store_dir=store, device="cuda")
    world_s = time.perf_counter() - t0
    out = {"world": SERVE_MESH_WORLD, "backend": backend,
           "single_process": {**ref_times, "peak_memory_gb": ref_peak,
                              "launches": ref_launches},
           "b5_shard": b5}
    tokens = SERVE_MESH_B * SERVE_MESH_GEN
    launches_by_rank = {}
    for shape in SERVE_MESH_SHAPES:
        recs = [r for rk in ranks for r in rk
                if r["arch"] == SERVE_MESH_ARCH and r["shape"] == shape]
        logits, caches, alike = gather_mesh_serve(recs, cfg)
        what = f"serve_mesh {shape}"
        if not alike:
            fail(f"{what}: the model ranks' logits differ")
        if not all(r["same_tokens"] and r["same_samples"] for r in recs):
            fail(f"{what}: the ranks of a model group sampled apart")
        err_prefill = rel_err(logits[:, :1], ref_logits[:, :1])
        err_decode = max(rel_err(logits[:, i:i + 1], ref_logits[:, i:i + 1])
                         for i in range(1, logits.shape[1]))
        err_caches = caches_rel_err(caches, ref_caches)
        for name, e in (("prefill logits", err_prefill),
                        ("decode logits", err_decode),
                        ("caches", err_caches)):
            if not e <= TOL_SERVE:
                fail(f"{what}: {name} differ by {e} > {TOL_SERVE} × (1 + max)")
        nb = SERVE_MESH_B // shape[0]
        want_by_rank = [serve_mesh_formula(cfg, nb, SERVE_MESH_PROMPT,
                                           SERVE_MESH_GEN, shape[1], 2,
                                           r["model_rank"]) for r in recs]
        for r, want_comm in zip(recs, want_by_rank):
            got = {ph: {k: {f: v[f] for f in ("calls", "bytes")}
                        for k, v in kinds.items()}
                   for ph, kinds in r["collectives"].items()
                   if ph in ("prefill", "decode")}
            if got != want_comm:
                fail(f"{what} rank {r['rank']}: collectives {got}, "
                     f"expected {want_comm}")
            want_l = {**dict.fromkeys(r["launches"], 0),
                      "flash_attention": want_b5}
            if (r["launches"] != want_l
                    or r["launches_prefill"] != want_l
                    or r["routes"]["flash_attention"]["tensor_core"]
                    != want_b5):
                fail(f"{what} rank {r['rank']}: launches {r['launches']} "
                     f"(prefill {r['launches_prefill']}), routes "
                     f"{r['routes']['flash_attention']}; expected {want_l}, "
                     "all on tensor cores")
        comm_s = [sum(v["seconds"] for ph in ("prefill", "decode")
                      for v in r["collectives"].get(ph, {}).values())
                  for r in recs]
        decode_s = max(r["decode_s"] for r in recs)
        line = {"mesh": list(shape), "rows_by_rank": [r["rows"] for r in recs],
                "devices_by_rank": [r["device"] for r in recs],
                "rel_err_prefill_logits": err_prefill,
                "rel_err_decode_logits": err_decode,
                "rel_err_caches": err_caches,
                "prefill_s_by_rank": [r["prefill_s"] for r in recs],
                "decode_ms_a_token_by_rank": [1e3 * r["decode_s"]
                                              / SERVE_MESH_GEN for r in recs],
                "tokens_per_s": tokens / decode_s,
                "comm_s_by_rank": comm_s,
                "collectives_by_rank": [r["collectives"] for r in recs],
                "formula_by_rank": want_by_rank,
                "staged_gb_by_rank": [r["collectives"]["staged_bytes"] / 1e9
                                      for r in recs],
                "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in recs],
                "launches_by_route_by_rank": [r["routes"]["flash_attention"]
                                              for r in recs],
                "bf16_sum_probe_by_rank": [r["gloo_bf16_sum"] for r in recs]}
        launches_by_rank["x".join(map(str, shape))] = \
            line["launches_by_route_by_rank"]
        out["x".join(map(str, shape))] = line
        emit({"phase": "serve_mesh", "case": f"{shape} over {backend}",
              "nvidia_smi": smi, **line})
    recs = [r for rk in ranks for r in rk
            if r["arch"] == SERVE_MESH_ARCH and r["shape"] == "f32"]
    logits, caches, alike = gather_mesh_serve(recs, cfg32)
    f32 = {"rel_err_logits": rel_err(logits, logits32),
           "rel_err_caches": caches_rel_err(caches, caches32)}
    if not (alike and max(f32.values()) <= TOL_SERVE_F32):
        fail(f"serve_mesh f32 at (1, 2): {f32} > {TOL_SERVE_F32}")
    out["f32"] = f32
    emit({"phase": "serve_mesh", "case": f"f32 prefill, "
          f"{SERVE_MESH_F32_LAYERS} layers, (1, 2)", **f32})
    # the scan archs at (1, 2): each kernel's shard times and launches
    out["scan"], kernels = {}, {}
    for arch in SERVE_SCAN:
        recs = [r for rk in ranks for r in rk
                if r["arch"] == arch and r["shape"] == SERVE_SCAN_SHAPE]
        recs32 = [r for rk in ranks for r in rk
                  if r["arch"] == arch and r["shape"] == "f32"]
        line = check_scan_mesh(arch, held[arch], recs, recs32, backend, smi)
        out["scan"][arch] = line
        for name, t in held[arch]["shards"].items():
            k = kernels.setdefault(name, {"shards": {},
                                          "launches_by_rank": {}})
            k["shards"][arch] = t
            k["launches_by_rank"][arch] = [
                r["routes"].get(name, r["launches"][name]) for r in recs]
    out["kernels"] = kernels
    del ranks, held
    # a world of 1 over NCCL, in this process: bit for bit the single one
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dist_launch.init_from_env("nccl", "cuda")
    try:
        mesh = mesh_lib.serve_mesh(1, 1)
        res = serve_lib.generate_on_mesh(   # one rank: its shard is all
            mesh, cfg, model_lib.param_dict(model), prompt, SERVE_MESH_GEN,
            forced=spec["tokens"].to(dev))
    finally:
        torch.distributed.destroy_process_group()
    same = (torch.equal(res.logits.cpu(), ref_logits) and all(
        torch.equal(g[k].cpu(), w[k]) for g, w in zip(res.prefill_caches,
                                                      ref_caches) for k in g))
    if not same:
        fail("serve_mesh: the world of 1 differs from the single process")
    if set(res.collectives) != {"staged_bytes"}:
        fail(f"serve_mesh: the world of 1 made collectives "
             f"{res.collectives}")
    out["world_of_1"] = {"backend": "nccl", "bit_for_bit": True,
                         "prefill_s": res.prefill_s,
                         "decode_s": res.decode_s}
    del res, model, prompt
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = {"single_process": single_s, "world": world_s,
                      "world_of_1": time.perf_counter() - t0,
                      "phase": time.perf_counter() - t_phase}
    emit({"phase": "serve_mesh", "case": "world of 1 over nccl",
          "nvidia_smi": smi, **out["world_of_1"],
          "single_process": out["single_process"],
          "phase_seconds": out["seconds"]})
    out["launches_by_route_by_rank"] = launches_by_rank
    return out


# ---------------------------------------------------------------------------
# phase 16: federated DRO training of the other block kinds
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def arch_depth(arch, layers):
    """``arch`` cut to its first ``layers`` layers in the registry while
    the block runs (``launch.train.build`` looks the config up by name);
    yields the cut config."""
    from repro_torch.configs import registry

    full = registry.ARCHS[arch]
    registry.ARCHS[arch] = dataclasses.replace(full, num_layers=layers)
    try:
        yield registry.ARCHS[arch]
    finally:
        registry.ARCHS[arch] = full


def ssm_args(**over):
    """``launch.train``'s flags at the reference's train defaults but
    n = SSM_TRAIN_N, on SSM_TRAIN_ARCH, with ``over``."""
    return train_args(arch=SSM_TRAIN_ARCH, clients=SSM_TRAIN_N, **over)


def reduced_checks(dev, smi, arch, *, phase) -> dict:
    """The reduced ``arch`` (recurrentgemma-9b: 3 layers, two RG-LRU blocks
    and a local-attention block, d_model 256; internvl2-76b: 2 attention
    layers and 4 prefix embeddings a sequence) at the train defaults but
    n = SSM_TRAIN_N: per-client gradients through its kernels (B5, B8,
    B6) against the plain route (f32 and bf16, as ``grad_checks``), and
    one round from the initial state in f32 compute, through the kernels
    against the plain route, within TOL_TRAIN_F32 · (1 + max)."""
    import torch

    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.core import objectives
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import train as train_lib

    args = train_args(device=dev, arch=arch, reduced=True,
                      clients=SSM_TRAIN_N)
    out = {"grads": grad_checks(dev, smi, args, phase=phase,
                                tol_bf16=(TOL_TRAIN_BF16_X,
                                          TOL_TRAIN_BF16_Y))}
    trainer = train_lib.build(args)
    batches, noise = trainer.sampler(0)[:2]
    rounds = {}
    for kernels in (True, False):
        problem = objectives.dro_problem(
            trainer.cfg, num_groups=args.groups, mu=args.mu,
            compute_dtype=torch.float32, kernels=kernels)
        step = kgt.make_round_step(problem, trainer.algo, device=dev)
        state = tree_lib.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            trainer.state)
        zero_launch_counts()
        rounds[kernels] = step(state, batches, noise)
        if kernels:
            launches, routes = launch_counts(), route_counts()
            backward = check_backward_launches(
                launches["rglru_scan"], f"{phase} {arch} round")
        elif any(launch_counts().values()):
            fail(f"{phase} {arch} round: the plain route "
                 f"launched {launch_counts()}")
    per_layer = serve_launches(trainer.cfg)
    want = {**dict.fromkeys(launches, 0),
            **{k: v * TRAIN_K for k, v in per_layer.items()},
            "fused_cross_entropy": SSM_TRAIN_N * TRAIN_K * ce_launches(
                trainer.cfg)}
    if launches != want:
        fail(f"{phase} {arch} round: launches {launches}, "
             f"expected {want}")
    routed = {k: v for k, v in model_routes(
        torch.float32, args, trainer.cfg).items() if want[k]}
    check_routes({k: routes[k] for k in routed}, want,
                 f"{phase} {arch} round", route_of=routed)
    err = max(tree_rel_err(getattr(rounds[True], f),
                           getattr(rounds[False], f))
              for f in ("x", "y", "cx", "cy"))
    out["round"] = {"arch": trainer.cfg.name, "clients": SSM_TRAIN_N,
                    "compute_dtype": "float32", "rel_err": err,
                    "tol": TOL_TRAIN_F32, "launches": launches,
                    "backward_launches": backward,
                    "launches_by_route": {k: routes[k] for k in routed}}
    emit({"phase": phase, "check": "one round, kernels against plain",
          "nvidia_smi": smi, **out["round"]})
    if not err <= TOL_TRAIN_F32:
        fail(f"{phase} {arch} round: kernels vs plain {err} > "
             f"{TOL_TRAIN_F32} × (1 + max)")
    return out


def rglru_train_times(gen, dev) -> dict:
    """``RglruScanFn`` at a full-width recurrentgemma-9b layer's training
    shape, RG_SCAN_TRAIN_SHAPE (n·B, S, W) f32: the kernel forward (the
    rule's route, the walk: one chunk) against ``ref.rglru_ref`` (bit for
    bit), the Function's backward — the backward kernel, one launch —
    against autograd through the plain version (TOL_SCAN_BWD); both
    routes', the backward kernel's and the plain forward's times
    (``b8_times``), the plain backward's (``ref.rglru_bwd_ref``) beside
    them, and the bounds."""
    import torch

    from repro_torch.kernels import ops, ref, rglru_scan

    b, s, w = RG_SCAN_TRAIN_SHAPE
    a, u = (x.requires_grad_(True) for x in rglru_operands(
        RG_SCAN_TRAIN_SHAPE, gen, dev))
    wts = torch.randn((b, s, w), generator=gen, device=dev)
    zero_launch_counts()
    h = rglru_scan.rglru_scan_bsw(a, u)
    want = ref.rglru_ref(a, u)
    fwd_err = max_err(h.detach(), want.detach())
    got_g = torch.autograd.grad((h * wts).sum(), (a, u))
    backward_launches = ops.backward_launch_counts()["rglru_scan"]
    want_g = torch.autograd.grad((want * wts).sum(), (a, u))
    bwd_rel = max(max_err(g, wg) / (1 + float(wg.abs().max()))
                  for g, wg in zip(got_g, want_g))
    rt = rglru_scan.route(b, s, w)
    if not (fwd_err == 0.0 if rt == "walk" else
            fwd_err <= TOL_SCAN * (1 + float(want.detach().abs().max()))):
        fail(f"rglru_scan at {RG_SCAN_TRAIN_SHAPE}: the forward on the "
             f"{rt} route is off the plain version by {fwd_err}")
    if backward_launches != 1:
        fail(f"rglru_scan at {RG_SCAN_TRAIN_SHAPE}: {backward_launches} "
             "backward launches, expected 1")
    if not bwd_rel <= TOL_SCAN_BWD:
        fail(f"rglru_scan at {RG_SCAN_TRAIN_SHAPE}: backward {bwd_rel} > "
             f"{TOL_SCAN_BWD} × (1 + max)")
    a, u, h = a.detach(), u.detach(), h.detach()
    del got_g, want_g, want
    bwd_plain_ms = cuda_ms(lambda: ref.rglru_bwd_ref(a, h, wts), reps=5,
                           warmup=1)
    del a, u, h, wts
    torch.cuda.empty_cache()
    out = dict(**b8_times(gen, dev, RG_SCAN_TRAIN_SHAPE, plain_reps=5),
               backward_plain_ms=bwd_plain_ms,
               forward_max_abs_err=fwd_err,
               forward_bit_for_bit=fwd_err == 0.0, forward_tol=TOL_SCAN,
               backward_rel_err=bwd_rel, backward_tol=TOL_SCAN_BWD,
               backward_launches=backward_launches)
    emit({"phase": "train_ssm", "kernel": "rglru_scan", **out})
    return out


def ssd_train_times(gen, dev) -> dict:
    """B7 at the mamba2 train path's shape (the clients folded into B:
    (SSM_TRAIN_N·B, S, 64, 64, 128), chunk 64, no state0) on its
    tensor-core route, held against ``ref.ssd_chunked`` (TOL_SSD); its
    forward, the plain forward, and the backward the Function runs
    (``ref.ssd_bwd_ref``), beside the bound of ``ssd_work``."""
    import torch

    from repro_torch.kernels import ref, ssd_scan

    b, s, h, p, n, chunk = train_ssd_shape()
    xdt, loga, bm, cm, _ = ssd_operands(b, s, h, p, n, gen, dev)
    y, fin = routed_call(lambda: ssd_scan.ssd_scan_bshp(
        xdt, loga, bm, cm, chunk=chunk), "ssd_scan", "tensor_core")
    py, pfin = ref.ssd_chunked(xdt, loga, bm, cm, chunk)
    err = max(max_err(y, py) / (1 + float(py.abs().max())),
              max_err(fin, pfin) / (1 + float(pfin.abs().max())))
    if not err <= TOL_SSD:
        fail(f"ssd_scan at the train shape: {err} > {TOL_SSD} × (1 + max)")
    gy, gfin = torch.randn_like(py), torch.zeros_like(pfin)
    del y, fin, py, pfin
    ms = cuda_ms(lambda: ssd_scan.ssd_scan_bshp(
        xdt, loga, bm, cm, chunk=chunk), reps=21)
    pms = cuda_ms(lambda: ref.ssd_chunked(xdt, loga, bm, cm, chunk),
                  reps=11)
    bwd_ms = cuda_ms(lambda: ref.ssd_bwd_ref(xdt, loga, bm, cm, chunk,
                                             None, gy, gfin), reps=11)
    bound, by = ssd_bound_ms(b, s, h, p, n, chunk, tensor_cores=True)
    out = dict(ms=ms, plain_ms=pms, backward_plain_ms=bwd_ms,
               library_ms=None, bound_ms=bound, bound_by=by,
               shape=[b, s, h, p, n], chunk=chunk, rel_err=err,
               tol=TOL_SSD)
    emit({"phase": "train_ssm", "kernel": "ssd_scan", **out})
    del xdt, loga, bm, cm, gy, gfin
    torch.cuda.empty_cache()
    return out


def phase_train_ssm(dev, gen, smi) -> dict:
    """Federated DRO training of mamba2-1.3b at full width (d_model 2048,
    expand 2, d_head 64, d_state 128, chunk 64, V = 50 280, tied head;
    bf16 compute, f32 state; weights from seed 0) through ``launch.train``
    at the reference's train defaults but n = SSM_TRAIN_N, with B7 (one
    launch a layer and local step, the clients folded) and B6 (one a
    client) under ``vmap(grad)``: at SSM_LAYERS_CAPTURED layers, the main
    path captured with its launches by route, bit for bit the host loop,
    then eager and captured rates in turns; at SSM_LAYERS_GRADS layers,
    per-client gradients against the plain route (f32 and bf16); at
    SSM_LAYERS_EAGER layers, the host loop's rounds/s and peak memory.
    Then the
    reduced
    recurrentgemma-9b (``reduced_checks``), B8's Function at a
    full-width layer (``rglru_train_times``) and B7 at the train shape
    (``ssd_train_times``)."""
    import gc

    import torch

    gc.collect()            # what the earlier phases left in cycles
    torch.cuda.empty_cache()
    out = {}
    with arch_depth(SSM_TRAIN_ARCH, SSM_LAYERS_CAPTURED) as cfg:
        out["main"] = captured_against_eager(
            lambda **kw: ssm_args(device=dev, **kw), cfg, phase="train_ssm",
            smi=smi)
        out["rates"] = train_rates(
            ssm_args(device=dev, log_every=TRAIN_ROUNDS), cfg,
            phase="train_ssm", smi=smi, turns=RATE_TURNS)
    with arch_depth(SSM_TRAIN_ARCH, SSM_LAYERS_GRADS):
        out["grads"] = grad_checks(
            dev, smi, ssm_args(device=dev), phase="train_ssm",
            tol_bf16=(TOL_TRAIN_SSM_BF16_X, TOL_TRAIN_SSM_BF16_Y))
    gc.collect()
    torch.cuda.empty_cache()
    with arch_depth(SSM_TRAIN_ARCH, SSM_LAYERS_EAGER) as cfg:
        out["eager"] = host_loop_run(
            ssm_args(device=dev, engine="host", rounds=TRAIN_ROUNDS,
                     log_every=TRAIN_ROUNDS - 1), cfg,
            phase="train_ssm", smi=smi)
    out["recurrentgemma_reduced"] = reduced_checks(dev, smi, RG_TRAIN_ARCH,
                                                   phase="train_ssm")
    out["times"] = {"ssd_scan": ssd_train_times(gen, dev),
                    "rglru_scan": rglru_train_times(gen, dev)}
    out["launches"] = out["main"]["launches"]
    out["launches_by_route"] = out["main"]["launches_by_route"]
    return out


# ---------------------------------------------------------------------------
# phases 17 and 18: the MoE block and the modality frontends
# ---------------------------------------------------------------------------

def _unwrapped(t):
    """A tensor made under ``torch.func`` transforms: its value (the vmap
    dimension moved to the front) and its wrappers, outermost first."""
    from torch._C import _functorch as ft

    chain = []
    while ft.is_functorch_wrapped_tensor(t):
        if ft.is_batchedtensor(t):
            chain.append(("vmap", ft.maybe_get_level(t)))
            t = ft.get_unwrapped(t).movedim(ft.maybe_get_bdim(t), 0)
        else:
            chain.append(("grad", ft.maybe_get_level(t)))
            t = ft.get_unwrapped(t)
    if sum(kind == "vmap" for kind, _ in chain) > 1:
        fail("routing: nested vmap levels")
    return t, chain


def _batched_like(value, chain):
    """Integer ``value`` (its front dimension the vmapped one) batched at
    the vmap level of the wrappers ``_unwrapped`` read; indices carry no
    gradient, so the grad levels lift it as they lift any tensor made
    outside them."""
    from torch._C import _functorch as ft

    for kind, level in reversed(chain):
        if kind == "vmap":
            value = ft._add_batch_dim(value, 0, level)
    return value


@contextlib.contextmanager
def routing_recorder():
    """Every ``models.moe.route`` call's expert choices (…, S, k), in call
    order (one a ``moe`` layer a forward; under ``vmap`` the clients
    first), while the block runs."""
    from repro_torch.models import moe as moe_lib

    seen, real = [], moe_lib.route

    def route(params, x, cfg):
        r = real(params, x, cfg)
        seen.append(_unwrapped(r.gate_idx)[0].detach().clone())
        return r

    moe_lib.route = route
    try:
        yield seen
    finally:
        moe_lib.route = real


@contextlib.contextmanager
def routing_replay(recorded):
    """``models.moe.route`` with the expert choices of another run of the
    same tokens (``recorded``, a ``routing_recorder``'s list): each call
    takes the next recorded choices, and its gates and aux from its own
    router probabilities at them (``moe.routing``).  So a plain route
    replaying the kernel route's choices differs from it by rounding
    alone, where a near-tie top-k or a capacity boundary would otherwise
    send a token to other experts."""
    import torch

    from repro_torch.models import moe as moe_lib

    used, real = [], moe_lib.route

    def route(params, x, cfg):
        probs = moe_lib.router_probs(params, x)
        own = torch.topk(probs, cfg.moe.top_k, dim=-1).indices
        gate_idx = _batched_like(recorded[len(used)], _unwrapped(own)[1])
        used.append(1)
        return moe_lib.routing(probs, gate_idx, cfg)

    moe_lib.route = route
    try:
        yield used
    finally:
        moe_lib.route = real
    if len(used) != len(recorded):
        fail(f"routing replay: {len(used)} MoE layers ran, "
             f"{len(recorded)} recorded")


def routing_flips(got, want, cfg) -> dict:
    """The routings of two runs of the same tokens compared layer by
    layer (lists of (…, S, k) expert choices, as ``routing_recorder``
    gives): ``choices``, (layer, token, choice) triples whose expert
    differs (two experts trading places within a token's top k count
    here, and change nothing); ``expert_sets``, (layer, token) pairs whose
    set of experts differs; ``kept``, (layer, token, expert) triples that
    one run computes and the other does not (another set, or another
    capacity decision); ``tokens``, tokens with such a triple in some
    layer."""
    import torch

    from repro_torch.models import moe as moe_lib

    if len(got) != len(want):
        fail(f"routing: {len(got)} against {len(want)} MoE layers")
    m = cfg.moe
    counts = {"layers": len(got), "choices": 0, "expert_sets": 0,
              "kept": 0, "tokens": 0, "tokens_a_layer": 0}
    mask = None
    for a, b in zip(got, want):
        s, k = a.shape[-2:]
        a, b = a.reshape(-1, s, k), b.reshape(-1, s, k)
        cap = moe_lib.capacity(s, m.num_experts, m.top_k, m.capacity_factor)

        def kept(idx):
            keep = moe_lib.capacity_slots(idx, m.num_experts, cap)[1]
            return torch.zeros(idx.shape[:-1] + (m.num_experts,),
                               dtype=torch.bool, device=idx.device).scatter(
                -1, idx, keep)

        diff = kept(a) != kept(b)
        counts["choices"] += int((a != b).sum())
        counts["expert_sets"] += int(
            (a.sort(-1).values != b.sort(-1).values).any(-1).sum())
        counts["kept"] += int(diff.sum())
        token = diff.any(-1)
        mask = token if mask is None else mask | token
        counts["tokens_a_layer"] = int(token.numel())
    if mask is not None:
        counts["tokens"] = int(mask.sum())
    return counts


def prefill_server(dev, arch, batch, prompt_len, *, phase, smi) -> dict:
    """``launch.serve.serve`` as a prefill server (``gen_tokens=0``: its
    layers attend globally) on ``arch`` at full width in bf16: the
    kernels' launches (B5 once a layer, on tensor cores), prefill s and
    peak memory; then a warm prefill and the plain prefill
    (``kernels=False``): the served logits within TOL_SERVE of the plain
    ones, and the first prompt's in f32 compute within TOL_SERVE_F32.  A
    MoE model's plain prefill replays the kernel route's expert choices
    for those checks (``routing_replay``); its own routing's flips and
    error are printed beside them."""
    import torch

    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib

    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    res = serve_lib.serve(arch, batch=batch, prompt_len=prompt_len,
                          gen_tokens=0, device=dev, seed=0)
    launches, routes = launch_counts(), route_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model, cfg = res.model, res.model.cfg
    moe = cfg.arch_type == "moe"
    want = {**dict.fromkeys(launches, 0), **serve_launches(cfg)}
    if res.launches["prefill"] != want or launches != want:
        fail(f"{phase} {arch} prefill launches {res.launches}, total "
             f"{launches}; expected {want}")
    check_routes(routes, want, f"{phase} {arch} prefill")
    if not bool(torch.isfinite(res.logits.float()).all()):
        fail(f"{phase} {arch}: non-finite logits")

    def prefills(tokens, dt):
        """{run: (last logits, seconds)}, and the routings seen."""
        out, seen = {}, {}
        for run in ("kernel", "plain") + (("replayed",) if moe else ()):
            caches = model_lib.init_cache(cfg, tokens.shape[0], prompt_len,
                                          dtype=dt, device=dev)
            with (routing_replay(seen["kernel"]) if run == "replayed"
                  else routing_recorder()) as seen[run]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = model_lib.forward(
                    model, {"tokens": tokens}, mode="prefill", caches=caches,
                    last_only=True, kernels=run == "kernel",
                    compute_dtype=dt)[0]
                torch.cuda.synchronize()
            out[run] = (logits, time.perf_counter() - t0)
            del caches
        return out, seen

    held = "replayed" if moe else "plain"
    with torch.no_grad():
        bf16, seen = prefills(res.prompt, torch.bfloat16)
        errs = {"prefill_logits_vs_plain": rel_err(res.logits,
                                                   bf16[held][0]),
                "warm_equals_served": bool(torch.equal(bf16["kernel"][0],
                                                       res.logits)),
                "prefill_warm_s": bf16["kernel"][1],
                "prefill_plain_s": bf16["plain"][1]}
        if moe:
            errs.update(held_against="the plain prefill replaying the "
                        "kernel route's expert choices",
                        prefill_logits_vs_plain_own_routing=rel_err(
                            res.logits, bf16["plain"][0]),
                        routing_flips=routing_flips(seen["kernel"],
                                                    seen["plain"], cfg))
        del bf16, seen
        f32, seen = prefills(res.prompt[:1], torch.float32)
        errs["prefill_logits_vs_plain_f32"] = rel_err(f32["kernel"][0],
                                                      f32[held][0])
        if moe:
            errs.update(prefill_logits_vs_plain_f32_own_routing=rel_err(
                f32["kernel"][0], f32["plain"][0]),
                routing_flips_f32=routing_flips(seen["kernel"],
                                                seen["plain"], cfg))
        del f32, seen
    out = {"arch": cfg.name, "layers": len(cfg.blocks()), "batch": batch,
           "prompt_len": prompt_len, "prefill_s": res.prefill_s,
           "peak_memory_gb": peak_gb,
           "params": model_lib.param_count(model),
           "prefill_tokens_per_s": batch * prompt_len / res.prefill_s,
           "launches": res.launches["prefill"], "launches_by_route": routes,
           **errs, "tol": TOL_SERVE, "tol_f32": TOL_SERVE_F32}
    emit({"phase": phase, "case": "prefill server", "nvidia_smi": smi,
          **out})
    if not errs["prefill_logits_vs_plain"] <= TOL_SERVE:
        fail(f"{phase} {arch}: prefill vs plain "
             f"{errs['prefill_logits_vs_plain']} > {TOL_SERVE}")
    if not errs["prefill_logits_vs_plain_f32"] <= TOL_SERVE_F32:
        fail(f"{phase} {arch}: f32 prefill vs plain "
             f"{errs['prefill_logits_vs_plain_f32']} > {TOL_SERVE_F32}")
    return out, res


def moe_decode_check(model, dev, gen, *, smi) -> dict:
    """MOE_DECODE_STEPS decode steps from position 0 (the cold cache's
    validity mask), one prompt token each, on MOE_SERVE_B prompts,
    against the plain full forward over the same tokens, both with
    capacity factor MOE_DROPLESS_FACTOR (a decode step's one token never
    overflows; the full forward's tokens may): in f32 compute within
    TOL_SERVE_F32 with no routing differing; in bf16 the error and the
    flips are printed, not held (a decode step and the full forward round
    in other places, enough to flip near-tie routings)."""
    import torch

    from repro_torch.models import model as model_lib

    cfg = model.cfg
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_DROPLESS_FACTOR))
    steps = MOE_DECODE_STEPS
    toks = torch.randint(0, cfg.vocab_size, (MOE_SERVE_B, steps),
                         generator=gen, device=dev)
    out = {}
    model.cfg = dropless
    try:
        with torch.no_grad():
            for dt in (torch.float32, torch.bfloat16):
                caches = model_lib.init_cache(dropless, MOE_SERVE_B, steps,
                                              dtype=dt, device=dev)
                logits = []
                with routing_recorder() as dec:
                    for t in range(steps):
                        lg, caches = model_lib.decode_step(
                            model, caches, toks[:, t:t + 1], t,
                            compute_dtype=dt)
                        logits.append(lg)
                with routing_recorder() as full_routes:
                    full, _, _ = model_lib.forward(
                        model, {"tokens": toks}, mode="prefill",
                        compute_dtype=dt, kernels=False)
                n_layers = len(full_routes)
                by_layer = [torch.cat(dec[l::n_layers], dim=1)
                            for l in range(n_layers)]
                flips = routing_flips(by_layer, full_routes, dropless)
                name = str(dt).split(".")[-1]
                out[name] = {"err": rel_err(torch.cat(logits, dim=1), full),
                             "routing_flips": flips}
    finally:
        model.cfg = cfg
    res = {"steps": steps, "batch": MOE_SERVE_B,
           "capacity_factor": MOE_DROPLESS_FACTOR, **out,
           "tol_f32": TOL_SERVE_F32}
    emit({"phase": "moe", "check": "decode from position 0 against the "
          "full forward", "nvidia_smi": smi, **res})
    f32 = out["float32"]
    if f32["routing_flips"]["choices"] or not f32["err"] <= TOL_SERVE_F32:
        fail(f"moe decode (f32): {f32}")
    return res


def evaluate_check(dev, arch, seq_len, *, phase, smi) -> dict:
    """``launch.evaluate.evaluate`` on ``arch`` at full width in bf16:
    ``group_metrics`` on one batch of EVAL_B × ``seq_len`` tokens for each
    of EVAL_CLIENTS clients, B5 once a layer and B6 once a codebook (once
    without codebooks) a client batch, on tensor cores; each client's
    group losses against the plain route within TOL_EVAL, finite; seconds
    and tokens/s a client batch, peak memory.  A MoE model's plain route
    replays the kernel route's expert choices for the check; its own
    routing's flips and error are printed beside it."""
    import torch

    from repro_torch.evaluation.metrics import group_metrics
    from repro_torch.launch import evaluate as eval_lib

    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    with routing_recorder() as kernel_routes:
        res = eval_lib.evaluate(arch, clients=EVAL_CLIENTS, batch=EVAL_B,
                                seq_len=seq_len, num_groups=EVAL_GROUPS,
                                device=dev, seed=0, verbose=False)
    launches, routes = launch_counts(), route_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = res.model
    cfg = model.cfg
    want = {**dict.fromkeys(launches, 0), **serve_launches(cfg),
            "fused_cross_entropy": ce_launches(cfg)}
    total = {k: v * EVAL_CLIENTS for k, v in want.items()}
    if any(got != want for got in res.launches) or launches != total:
        fail(f"{phase} {arch} evaluate launches {res.launches}, total "
             f"{launches}; expected {want} a client")
    check_routes(routes, total, f"{phase} {arch} evaluate")
    moe = cfg.arch_type == "moe"
    per_client = len(kernel_routes) // EVAL_CLIENTS
    errs, own, flips, plain_s = [], [], [], []
    for i, (b, m) in enumerate(zip(res.batches, res.metrics)):
        if not all(bool(torch.isfinite(m[k]).all())
                   for k in ("group_loss", "mean_loss")):
            fail(f"{phase} {arch} evaluate client {i}: not finite")
        seen = {True: kernel_routes[i * per_client:(i + 1) * per_client]}
        with routing_recorder() as seen[False]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = group_metrics(model, b, num_groups=EVAL_GROUPS,
                                  kernels=False)
            torch.cuda.synchronize()
            plain_s.append(time.perf_counter() - t0)
        if moe:
            flips.append(routing_flips(seen[True], seen[False], cfg))
            own.append(rel_err(m["group_loss"], plain["group_loss"]))
            with routing_replay(seen[True]):
                plain = group_metrics(model, b, num_groups=EVAL_GROUPS,
                                      kernels=False)
        errs.append(rel_err(m["group_loss"], plain["group_loss"]))
    out = {"arch": cfg.name, "clients": EVAL_CLIENTS, "batch": EVAL_B,
           "seq_len": seq_len, "seconds": res.seconds,
           "plain_route_s": plain_s,
           "tokens_per_s": [EVAL_B * seq_len / t for t in res.seconds],
           "peak_memory_gb": peak_gb, "err_vs_plain": errs,
           "launches": launches,
           "launches_a_client": want, "launches_by_route": routes,
           "mean_loss": [float(m["mean_loss"]) for m in res.metrics],
           "tol": TOL_EVAL}
    if moe:
        out.update(held_against="the plain route replaying the kernel "
                   "route's expert choices", err_vs_plain_own_routing=own,
                   routing_flips=flips)
    emit({"phase": phase, "case": "evaluate", "nvidia_smi": smi, **out})
    if not max(errs) <= TOL_EVAL:
        fail(f"{phase} {arch} evaluate: group losses vs plain {errs} > "
             f"{TOL_EVAL} × (1 + max)")
    del res, model
    torch.cuda.empty_cache()
    return out


def moe_args(**over):
    """``launch.train``'s flags at the reference's train defaults but
    n = MOE_TRAIN_N, on MOE_ARCH, with ``over``."""
    return train_args(arch=MOE_ARCH, clients=MOE_TRAIN_N, **over)


def phase_moe(dev, gen, smi) -> dict:
    """granite-moe-1b-a400m at full width (bf16 weights and compute; seed-0
    weights): a prefill server on MOE_SERVE_B × MOE_SERVE_PROMPT tokens
    through B5 (``prefill_server``), decode from position 0 against the
    dropless full forward (``moe_decode_check``), ``group_metrics`` through
    B5 and B6 (``evaluate_check``); then DRO training at n = MOE_TRAIN_N
    (f32 state): per-client gradients through B5 and B6 against the plain
    route at MOE_LAYERS_GRADS layers with the routing flips counted, and
    at MOE_LAYERS_CAPTURED layers the main path captured, bit for bit the
    host loop, and an eager and a captured rate turn."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    out["prefill"], res = prefill_server(dev, MOE_ARCH, MOE_SERVE_B,
                                         MOE_SERVE_PROMPT, phase="moe",
                                         smi=smi)
    out["decode"] = moe_decode_check(res.model, dev, gen, smi=smi)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    out["evaluate"] = evaluate_check(dev, MOE_ARCH, EVAL_S, phase="moe",
                                     smi=smi)
    with arch_depth(MOE_ARCH, MOE_LAYERS_GRADS):
        out["grads"] = grad_checks(
            dev, smi, moe_args(device=dev), phase="moe",
            tol_bf16=(TOL_TRAIN_MOE_BF16_X, TOL_TRAIN_MOE_BF16_Y))
    gc.collect()
    torch.cuda.empty_cache()
    with arch_depth(MOE_ARCH, MOE_LAYERS_CAPTURED) as cfg:
        out["main"] = captured_against_eager(
            lambda **kw: moe_args(device=dev, **kw), cfg, phase="moe",
            smi=smi)
        out["rates"] = train_rates(
            moe_args(device=dev, log_every=TRAIN_ROUNDS), cfg, phase="moe",
            smi=smi, turns=RATE_TURNS)
    out["launches_prefill"] = out["prefill"]["launches"]
    out["launches_evaluate"] = out["evaluate"]["launches"]
    out["launches"] = out["main"]["launches"]
    out["launches_by_route"] = out["main"]["launches_by_route"]
    return out


def vlm_prefix_prefill(dev, smi) -> dict:
    """internvl2-76b's prefix path at full width (d_model 8192, 64/8 heads
    of 128, V = 128 256, untied) cut to VLM_LAYERS layers, bf16: a prefill
    of VLM_B prompts, each 256 prefix embeddings (0.02·N(0, 1), as the
    data layer draws them) and VLM_PROMPT tokens, through B5 (one launch a
    layer, tensor cores) against the plain prefill within TOL_SERVE; the
    prefix must move the logits."""
    import torch

    from repro_torch.data import synthetic as data_lib
    from repro_torch.models import model as model_lib

    with arch_depth(VLM_ARCH, VLM_LAYERS) as cfg:
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        model = model_lib.init_params(cfg, generator=g, device=dev,
                                      dtype=torch.bfloat16)
        tokens = torch.randint(0, cfg.vocab_size, (VLM_B, VLM_PROMPT),
                               generator=g, device=dev)
        batch = {"tokens": tokens,
                 "prefix": data_lib.prefix_embeddings(g, VLM_B, cfg)}
        total = cfg.num_prefix_tokens + VLM_PROMPT

        def prefill(b, kernels):
            return model_lib.forward(
                model, b, mode="prefill", last_only=True, kernels=kernels,
                caches=model_lib.init_cache(cfg, VLM_B, total, device=dev))

        with torch.no_grad():
            zero_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches, _ = prefill(batch, True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches, routes = launch_counts(), route_counts()
            plain, plain_caches, _ = prefill(batch, False)
            bare, _, _ = prefill({"tokens": tokens}, True)
        want = {**dict.fromkeys(launches, 0), **serve_launches(cfg)}
        if launches != want:
            fail(f"frontends {VLM_ARCH} prefill launches {launches}, "
                 f"expected {want}")
        check_routes(routes, want, f"frontends {VLM_ARCH} prefill")
        err = rel_err(logits, plain)
        cache_err = max(rel_err(c[k], p[k]) for c, p in
                        zip(caches, plain_caches) for k in c)
        out = {"arch": cfg.name, "layers": VLM_LAYERS, "batch": VLM_B,
               "prefix_tokens": cfg.num_prefix_tokens,
               "prompt_len": VLM_PROMPT, "cache_len": int(
                   caches[0]["k"].shape[1]),
               "params": model_lib.param_count(model), "prefill_s": secs,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "prefill_logits_vs_plain": err,
               "prefill_caches_vs_plain": cache_err,
               "logits_without_prefix_vs_with": rel_err(bare, logits),
               "launches": launches, "launches_by_route": routes,
               "tol": TOL_SERVE}
        emit({"phase": "frontends", "case": "prefix prefill",
              "nvidia_smi": smi, **out})
        if not (err <= TOL_SERVE and cache_err <= TOL_SERVE):
            fail(f"frontends {VLM_ARCH} prefill vs plain: {err}, caches "
                 f"{cache_err} > {TOL_SERVE}")
        if not bool(torch.isfinite(logits.float()).all()) or \
                out["logits_without_prefix_vs_with"] == 0.0:
            fail(f"frontends {VLM_ARCH}: the prefix did not reach the "
                 "logits, or they are not finite")
        del model, logits, caches, plain, plain_caches, bare
        torch.cuda.empty_cache()
        return out


def phase_frontends(dev, gen, smi) -> dict:
    """musicgen-medium at full width (48 layers, d_model 1536, 4 codebooks
    of V = 2048, untied; bf16): a prefill server on MUSIC_B × MUSIC_FRAMES
    frames through B5, ``group_metrics`` through B5 and B6 (one launch a
    codebook a client batch), per-client DRO gradients through B5 and B6
    at MUSIC_LAYERS_GRADS layers; internvl2-76b's prefix path through B5
    at VLM_LAYERS layers (``vlm_prefix_prefill``); the reduced
    internvl2-76b's gradients and one round through B5 and B6
    (``reduced_checks``)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    out["prefill"], res = prefill_server(dev, MUSIC_ARCH, MUSIC_B,
                                         MUSIC_FRAMES, phase="frontends",
                                         smi=smi)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    out["evaluate"] = evaluate_check(dev, MUSIC_ARCH, MUSIC_FRAMES,
                                     phase="frontends", smi=smi)
    with arch_depth(MUSIC_ARCH, MUSIC_LAYERS_GRADS):
        out["grads"] = grad_checks(
            dev, smi, train_args(device=dev, arch=MUSIC_ARCH,
                                 clients=MOE_TRAIN_N), phase="frontends",
            tol_bf16=(TOL_TRAIN_BF16_X, TOL_TRAIN_BF16_Y))
    gc.collect()
    torch.cuda.empty_cache()
    out["prefix"] = vlm_prefix_prefill(dev, smi)
    out["internvl2_reduced"] = reduced_checks(dev, smi, VLM_ARCH,
                                              phase="frontends")
    out["launches_prefill"] = out["prefill"]["launches"]
    out["launches_evaluate"] = out["evaluate"]["launches"]
    return out


def time_host(fn) -> float:
    """Host seconds of one call that ends in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def attn_bound_ms(b, sq, sk, h, kv, d, window, elem_bytes, flop_s):
    """4·B·H·(keys seen)·D flops against q, k, v, o moved once."""
    import numpy as np

    i = np.arange(sq)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    keys = int(np.maximum(0, np.minimum(i, sk - 1) - lo + 1).sum())
    flops = 4 * b * h * keys * d
    byts = elem_bytes * (2 * b * sq * h * d + 2 * b * sk * kv * d)
    t_b, t_f = byts / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def scan_bound_ms(b, s, w):
    return _bound(12 * b * s * w, 2 * b * s * w)


# the 3xTF32 split (csrc/ssd_scan.cu): three TF32 products for each f32 one
SPLIT_TF32_PRODUCTS = 3


def ssd_work(b, s, h, p, n, chunk, with_state0=False):
    """(bytes, flops) of the chunked SSD's least work: per (chunk, head)
    L(L+1)/2·P multiply-adds for the intra-chunk product, L·P·N for C·Sᵀ
    and L·P·N (+ P·N) for the state update, and C·Bᵀ, L(L+1)/2·N, once per
    (batch row, chunk) — it is the same for every head.  Bytes: xdt and y,
    loga, B and C, the final state (and state0) moved once, f32."""
    full, rest = divmod(s, chunk)
    lens = [chunk] * full + ([rest] if rest else [])
    tri = sum(l_ * (l_ + 1) // 2 for l_ in lens)
    flops = 2 * b * (h * (tri * p + 2 * s * p * n + len(lens) * p * n)
                     + tri * n)
    byts = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n
                + (2 if with_state0 else 1) * b * h * p * n)
    return byts, flops


def ssd_bound_ms(b, s, h, p, n, chunk, with_state0=False, tensor_cores=False):
    """:func:`ssd_work` at the f32 CUDA-core peak or (``tensor_cores``, the
    tensor-core route) three times its operations at the dense TF32 peak."""
    byts, flops = ssd_work(b, s, h, p, n, chunk, with_state0)
    if tensor_cores:
        return _bound(byts, SPLIT_TF32_PRODUCTS * flops, TF32_FLOP_S)
    return _bound(byts, flops)


def ce_bound_ms(n, d, v, elem_bytes):
    """2·N·V·d operations at the operands' peak (bf16 tensor cores, or f32
    CUDA cores) against hidden, weight, labels and the NLL moved once;
    also the bound at the f32 CUDA-core peak."""
    flops = 2 * n * v * d
    byts = elem_bytes * (n * d + v * d) + 8 * n + 4 * n
    peak = BF16_FLOP_S if elem_bytes == 2 else F32_FLOP_S
    t_b, t_f = byts / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return ((t_b, "bytes") if t_b >= t_f else (t_f, "operations"),
            flops / F32_FLOP_S * 1e3)


def time_mamba_kernels(gen, dev) -> dict:
    """B7 at the mamba2 serve prefill's shape (state0 zeros, as the prefill
    passes its zero cache) and at prefill_32k's length, batch 1, on both
    routes; B6 at the evaluate shape in bf16 (tied layout).  Each beside
    its plain version, its bounds and, for B6, the nearest PyTorch calls:
    ``torch.mm`` of the bf16 operands to f32 logits, then
    ``F.cross_entropy(reduction="none")`` (two calls; B7 has none).
    CUDA-event times of eager calls."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cross_entropy, ref, ssd_scan

    out = {}
    for b, s, h, p, n, chunk in served_ssd_shapes():
        # evaluate's shape is the served one's but for B; a model rank's
        # shard is timed in the serve_mesh phase
        if (b, s) in ((EVAL_B, EVAL_S),
                      (SERVE_SCAN[MAMBA_ARCH][0], SERVE_SCAN_PROMPT)):
            continue
        xdt, loga, bm, cm, _ = ssd_operands(b, s, h, p, n, gen, dev)
        s0 = torch.zeros((b, h, p, n), device=dev)
        # the route the served shapes take (tensor cores), then the
        # CUDA-core route on the same operands
        ms = cuda_ms(lambda: ssd_scan.ssd_scan_bshp(  # noqa: E731
            xdt, loga, bm, cm, s0, chunk=chunk), reps=11)
        cc_ms = cuda_ms(lambda: ssd_scan.ssd_scan_bshp(  # noqa: E731
            xdt, loga, bm, cm, s0, chunk=chunk, force_route="cuda_core"),
            reps=5)
        pms = cuda_ms(lambda: ref.ssd_chunked(  # noqa: E731
            xdt, loga, bm, cm, chunk, s0), reps=3)
        bound, by = ssd_bound_ms(b, s, h, p, n, chunk, with_state0=True,
                                 tensor_cores=True)
        f32_bound, f32_by = ssd_bound_ms(b, s, h, p, n, chunk,
                                         with_state0=True)
        flops = ssd_work(b, s, h, p, n, chunk, with_state0=True)[1]
        emit({"phase": "times", "kernel": "ssd_scan",
              "shape": [b, s, h, p, n], "chunk": chunk,
              "segments": ssd_scan.segments(b, h, -(-s // chunk))[0],
              "ms": ms, "route": "tensor_core", "cuda_core_ms": cc_ms,
              "plain_ms": pms, "library_ms": None, "bound_ms": bound,
              "bound_by": by, "bound_ms_at_f32_cuda_core_peak": f32_bound,
              "f32_bound_by": f32_by, "tflop_s": flops / ms / 1e9,
              "cuda_core_tflop_s": flops / cc_ms / 1e9})
        if (b, s) == (MAMBA_B, MAMBA_PROMPT):
            out["ssd_scan"] = dict(ms=ms, plain_ms=pms, bound_ms=bound,
                                   bound_by=by, library_ms=None,
                                   cuda_core_ms=cc_ms,
                                   bound_ms_at_f32_cuda_core_peak=f32_bound)
        del xdt, loga, bm, cm, s0
        torch.cuda.empty_cache()
    n, d, v = eval_ce_shape()
    hidden, w, labels = ce_operands(n, d, v, torch.bfloat16, gen, dev)
    # the route the evaluate path takes (tensor cores), then the CUDA-core
    # route on the same operands
    ms = cuda_ms(lambda: cross_entropy.fused_ce_nd(  # noqa: E731
        hidden, w, labels), reps=11)
    cc_ms = cuda_ms(lambda: cross_entropy.fused_ce_nd(  # noqa: E731
        hidden, w, labels, force_route="cuda_core"), reps=3)
    pms = cuda_ms(lambda: ref.fused_ce_ref(hidden, w, labels),  # noqa: E731
                  reps=5)
    # the untied layout (an untied head's transposed view), tensor cores
    _, w_untied, _ = ce_operands(1, d, v, torch.bfloat16, gen, dev,
                                 tied=False)
    untied_ms = cuda_ms(lambda: cross_entropy.fused_ce_nd(  # noqa: E731
        hidden, w_untied, labels), reps=11)
    del w_untied

    def lib():
        try:
            logits = torch.mm(hidden, w.T, out_dtype=torch.float32)
        except (TypeError, NotImplementedError, RuntimeError):
            # a torch without mm's out_dtype: bf16 logits, then a cast
            logits = torch.mm(hidden, w.T).float()
        return F.cross_entropy(logits, labels, reduction="none")

    lib_err = max_err(lib(), cross_entropy.fused_ce_nd(hidden, w, labels))
    lms = cuda_ms(lib, reps=5)
    (bound, by), f32_bound = ce_bound_ms(n, d, v, 2)
    emit({"phase": "times", "kernel": "fused_cross_entropy",
          "shape": [n, d, v], "dtype": "bfloat16", "ms": ms,
          "route": "tensor_core", "cuda_core_ms": cc_ms,
          "untied_tensor_core_ms": untied_ms, "plain_ms": pms,
          "library_ms": lms, "library_max_abs_err_vs_kernel": lib_err,
          "library": "two calls: torch.mm(h, w.T, out_dtype=float32), then "
                     "F.cross_entropy(reduction='none')",
          "bound_ms": bound, "bound_by": by,
          "bound_ms_at_f32_cuda_core_peak": f32_bound,
          "tflop_s": 2 * n * v * d / ms / 1e9,
          "cuda_core_tflop_s": 2 * n * v * d / cc_ms / 1e9})
    out["fused_cross_entropy"] = dict(ms=ms, plain_ms=pms, bound_ms=bound,
                                      bound_by=by, library_ms=lms,
                                      cuda_core_ms=cc_ms)
    del hidden, w, labels
    torch.cuda.empty_cache()
    return out


def time_model_kernels(gen, dev) -> dict:
    """B5 (bf16) at the served shape and at prefill_32k's length (S =
    32768, batch 1): the kernel, its plain version and
    ``scaled_dot_product_attention`` with the same banded boolean mask (k
    and v expanded to the query heads before the timed call), each beside
    its bound, from CUDA events of eager calls (a call is milliseconds);
    B8 at the served, 32k, train and mesh-rank shapes: both routes, the
    backward kernel and the plain version (``b8_times``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    out = {}
    b, s, h, kv, d, window = served_attention_shape()
    for bb, ss in ((b, s), (1, LONG_S)):
        q, k, v = attn_operands(bb, ss, ss, h, kv, d, torch.bfloat16, gen,
                                dev)
        kern = lambda: flash_attention.flash_attention_bshd(  # noqa: E731
            q, k, v, causal=True, window=window)
        kern_cc = lambda: flash_attention.flash_attention_bshd(  # noqa: E731
            q, k, v, causal=True, window=window, force_route="cuda_core")
        plain = lambda: ref.attention_ref(  # noqa: E731
            q, k, v, causal=True, window=window)
        ms, pms = cuda_ms(kern, reps=11), cuda_ms(plain, reps=3)
        cc_ms = cuda_ms(kern_cc, reps=5)
        i = torch.arange(ss, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        qt = q.transpose(1, 2)
        kt, vt = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1)
                  for x in (k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask)
        try:
            lib_err = max_err(lib().transpose(1, 2).float(), kern().float())
            lms = cuda_ms(lib, reps=7)
        except torch.cuda.OutOfMemoryError:
            lib_err = lms = None
        bound, by = attn_bound_ms(bb, ss, ss, h, kv, d, window, 2,
                                  BF16_FLOP_S)
        f32_bound, _ = attn_bound_ms(bb, ss, ss, h, kv, d, window, 2,
                                     F32_FLOP_S)
        emit({"phase": "times", "kernel": "flash_attention",
              "shape": [bb, ss, h, kv, d], "window": window,
              "dtype": "bfloat16", "ms": ms, "route": "tensor_core",
              "cuda_core_ms": cc_ms, "plain_ms": pms,
              "library_ms": lms, "library_max_abs_err_vs_kernel": lib_err,
              "library": "F.scaled_dot_product_attention, banded bool mask",
              "bound_ms": bound, "bound_by": by,
              "bound_ms_at_f32_cuda_core_peak": f32_bound,
              "tflop_s": bound * BF16_FLOP_S / ms / 1e12
              if by == "operations" else None})
        if bb == b:
            out["flash_attention"] = dict(ms=ms, plain_ms=pms, bound_ms=bound,
                                          bound_by=by, library_ms=lms,
                                          cuda_core_ms=cc_ms)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    b, s, w = served_scan_shape()
    shapes = {"served": (b, s, w), "32k": (1, LONG_S, w),
              "train": RG_SCAN_TRAIN_SHAPE, "mesh_rank": served_scan_shard()}
    out["rglru_scan"] = {}
    for case, shape in shapes.items():
        # the plain version's loop of 32768 steps timed once (1.1–1.5 s a
        # call beside an H100)
        t = b8_times(gen, dev, shape, plain_reps=1 if case == "32k" else 3)
        emit({"phase": "times", "kernel": "rglru_scan", "case": case, **t,
              "GB_per_s": 12 * math.prod(shape) / t["ms"] / 1e6})
        if case == "served":
            out["rglru_scan"].update(t)
        out["rglru_scan"][f"shape_{case}"] = t
    return out


# ---------------------------------------------------------------------------
# phase 11: times
# ---------------------------------------------------------------------------

def phase_times(dev, gen) -> dict:
    import torch

    from repro_torch.core import MIXING_IMPLS
    from repro_torch.core import sparse_topology as sp_lib
    from repro_torch.kernels import fused_round, gossip, ref

    # At the main path's shapes a call is a few µs of device work behind
    # tens of µs of host work (the wrapper, the allocator, the launch):
    # ``ms`` is the device time (calls back to back in a CUDA graph),
    # ``call_ms`` the eager rate of calls from Python (host-bound).
    out = {}
    # the fused gossip pair at the main path's shapes (one launch a round
    # on the unrolled route; the tiled route launches once a variable)
    w, dxv, txv, cxv = gossip_operands(N, DX, gen, dev)
    _, dyv, tyv, cyv = gossip_operands(N, DY, gen, dev)
    xv, yv = (dxv, txv, cxv, 0.5, 12.5), (dyv, tyv, cyv, 1.0, -3.0)
    kern = lambda: gossip.fused_gossip_pair_nd(w, xv, yv)  # noqa: E731
    tiled = lambda: gossip.fused_gossip_pair_nd(  # noqa: E731
        w, xv, yv, force_route="tiled")
    plain = lambda: (ref.fused_gossip_ref(w, *xv),  # noqa: E731
                     ref.fused_gossip_ref(w, *yv))
    ms, tms, pms = graph_ms(kern), graph_ms(tiled), graph_ms(plain)
    b = gossip_bound_ms(N, DX)[0] + gossip_bound_ms(N, DY)[0]
    emit({"phase": "times", "kernel": "fused_gossip", "pair": True, "n": N,
          "D": [DX, DY], "route": gossip.route(N), "ms": ms,
          "tiled_ms": tms, "plain_ms": pms, "bound_ms": b,
          "bound_by": "bytes", "call_ms": cuda_ms(kern, inner=100),
          "tiled_call_ms": cuda_ms(tiled, inner=100),
          "plain_call_ms": cuda_ms(plain, inner=100)})
    out["fused_gossip"] = dict(ms=ms, tiled_ms=tms, plain_ms=pms,
                               bound_ms=b, bound_by="bytes")
    # the row block of the decentralized mesh at the same shapes: rank 1 of
    # B1_ROW_RANKS, its rows of W over all N rows of Δ and θ
    out["fused_gossip"]["rows"] = time_gossip_rows(
        w, xv, yv, B1_ROW_RANKS, graph_ms)
    del w, xv, yv, dxv, txv, cxv, dyv, tyv, cyv

    # whole round at the main-path shape
    # (the route the main path takes, a cluster per client, then the block
    # route on the same operands)
    args = round_operands(N, DX + DY, K, gen, dev)
    kern = lambda: fused_round.fused_round_nd(*args)  # noqa: E731
    block = lambda: fused_round.fused_round_nd(  # noqa: E731
        *args, force_route="block")
    plain = lambda: ref.fused_round_ref(*args)        # noqa: E731
    ms, pms = graph_ms(kern, inner=20), graph_ms(plain, inner=20)
    block_ms = graph_ms(block, inner=20)
    b, by = round_bound_ms(N, DX + DY, K)
    emit({"phase": "times", "kernel": "fused_round", "n": N, "dz": DX + DY,
          "K": K, "ms": ms, "route": "cluster",
          "cluster_size": fused_round.cluster_size(DX + DY),
          "block_ms": block_ms, "plain_ms": pms, "bound_ms": b,
          "bound_by": by, "call_ms": cuda_ms(kern, inner=20),
          "block_call_ms": cuda_ms(block, inner=20),
          "plain_call_ms": cuda_ms(plain, inner=20)})
    out["fused_round"] = dict(ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                              block_ms=block_ms)
    del args

    out["sparse_gossip"] = time_sparse_gossip(gen, dev)
    # both row blocks at the mesh phase's own shape: rank 1 of MESH_WORLD
    # at n = TRAIN_N, x the packed qwen2-0.5b at MESH_LAYERS layers, y its
    # group weights; a call moves GBs, so CUDA events around single calls
    mdx, mdy = mesh_packed_dims()
    w, dxv, txv, cxv = gossip_operands(TRAIN_N, mdx, gen, dev)
    _, dyv, tyv, cyv = gossip_operands(TRAIN_N, mdy, gen, dev)
    xv, yv = (dxv, txv, cxv, 0.5, 12.5), (dyv, tyv, cyv, 1.0, -3.0)
    events = functools.partial(cuda_ms, reps=5, warmup=1)
    out["fused_gossip"]["rows"]["mesh_rank"] = time_gossip_rows(
        w, xv, yv, MESH_WORLD, events)
    msp = sp_lib.sparse_mixing_matrix(train_args().topology, TRAIN_N)
    out["sparse_gossip"]["rows"]["mesh_rank"] = time_sparse_rows(
        msp.to(dev), xv, yv, dev, ranks=MESH_WORLD, timed=events)
    del w, xv, yv, dxv, txv, cxv, dyv, tyv, cyv
    torch.cuda.empty_cache()
    out.update(time_model_kernels(gen, dev))
    out.update(time_mamba_kernels(gen, dev))

    # the epilogue at a paper-toy-sized packed state, on both routes
    d_big = 100_000_000
    args = gossip_operands(N, d_big, gen, dev)
    kt, kc = gossip.fused_gossip_nd(*args, 0.5, 12.5)
    pt, pc = ref.fused_gossip_ref(*args, 0.5, 12.5)
    err = max(max_err(kt, pt), max_err(kc, pc) / 12.5)
    del pt, pc
    tt, tc = gossip.fused_gossip_nd(*args, 0.5, 12.5, force_route="tiled")
    same = bitwise_equal(kt, tt) and bitwise_equal(kc, tc)
    del kt, kc, tt, tc
    torch.cuda.empty_cache()
    if err > TOL_GOSSIP or not same:
        fail(f"fused_gossip at D={d_big}: err {err}, routes equal {same}")
    ms = cuda_ms(lambda: gossip.fused_gossip_nd(*args, 0.5, 12.5), reps=21)
    tms = cuda_ms(lambda: gossip.fused_gossip_nd(
        *args, 0.5, 12.5, force_route="tiled"), reps=21)
    pms = cuda_ms(lambda: ref.fused_gossip_ref(*args, 0.5, 12.5), reps=21)
    b, _ = gossip_bound_ms(N, d_big)
    emit({"phase": "times", "kernel": "fused_gossip", "n": N, "D": d_big,
          "route": gossip.route(N), "ms": ms, "tiled_ms": tms,
          "plain_ms": pms, "bound_ms": b, "max_abs_err": err,
          "GB_per_s": 4 * 5 * N * d_big / ms / 1e6,
          "tiled_GB_per_s": 4 * 5 * N * d_big / tms / 1e6})
    del args
    torch.cuda.empty_cache()

    # rounds/s per mixing_impl at the main-path shape (kgt_minimax)
    from repro_torch import engine as engine_lib

    problem, client_batch, batches = main_setup(dev)
    rps = {}
    for impl in MIXING_IMPLS:
        state, build = prepare(problem, client_batch, batches, "kgt_minimax",
                               impl, dev, log_every=TIMES_RATE_ROUNDS)
        rps[impl] = steady_rounds_per_s(state, build, TIMES_RATE_ROUNDS)
    emit({"phase": "times", "rounds_per_s": rps, "algorithm": "kgt_minimax",
          "rounds": TIMES_RATE_ROUNDS, "note": "host clock around "
          "engine.run, one chunk replayed as a CUDA graph after a first run "
          "captured it, metrics on its first and last rounds"})
    return out


def sparse_l2_bytes(n, dx, dy, m, route):
    """L2 bytes of Δ, θ and the table that one call moves by the design of
    its route: the row-block route gathers every Δ and θ row m+1 times; the
    stripe route stages Δ and θ once and reads the (n, m) table once a
    stripe."""
    from repro_torch.kernels import neighbor_gossip

    if route == "row_block":
        return (m + 1) * 2 * n * (dx + dy) * 4
    w = neighbor_gossip.STRIPE_WIDTH
    stripes = -(-dx // w) + -(-dy // w)
    return 2 * n * (dx + dy) * 4 + n * (2 * m + 1) * 4 * stripes


def time_sparse_gossip(gen, dev) -> dict:
    """The neighbor-gather epilogue on the exponential graph, on both
    routes: at benchmarks/bench_scale.py's client counts (D = 256), as the
    scale path calls it (the pair at n = 4096, D = 384 and 128, one launch;
    also on a churn draw and in bf16), and at D = 16384, where each (n, D)
    array (268 MB) is far past the 50 MB L2.  Beside it: the row-block
    route (one launch a variable), the plain version, ``torch.sparse.mm``
    of the CSR W (self loop included) on [Δ | θ] (the gather half only, not
    the epilogue; one call on all four operands for the pair), the bound
    and each route's L2 bytes by design."""
    import torch

    from repro_torch.core import sparse_topology as sp_lib
    from repro_torch.kernels import neighbor_gossip, ref

    points = [(n, 256, 0) for n in (64, 256, 1024, SCALE_N)]
    points += [(SCALE_N, DX, DY), (SCALE_N, 16384, 0)]
    path = {}
    tables = {}
    for n, dx, dy in points:
        if n not in tables:
            sp = sp_lib.sparse_exp(n).to(dev)
            tables[n] = (sp, sp_lib.densify(sp).to_sparse_csr())
        sp, csr = tables[n]
        m = sp.max_degree
        tab = (sp.neighbor_idx, sp.neighbor_w, sp.self_w)
        x = (*(torch_randn(gen, dev, n, dx) for _ in range(3)), 0.5, 12.5)
        y = ((*(torch_randn(gen, dev, n, dy) for _ in range(3)), 1.0, -3.0)
             if dy else None)
        both = torch.cat([x[0], x[1]] + ([y[0], y[1]] if dy else []), dim=1)
        kern = lambda: neighbor_gossip.sparse_gossip_pair_nd(  # noqa: E731
            *tab, x, y)
        old = lambda: neighbor_gossip.sparse_gossip_pair_nd(  # noqa: E731
            *tab, x, y, force_route="row_block")
        plain = lambda: [ref.sparse_gossip_ref(*tab, *v)  # noqa: E731
                         for v in (x, y) if v is not None]
        lib = lambda: torch.sparse.mm(csr, both)  # noqa: E731
        inner, reps = (100, 21) if dx + dy <= 4096 else (5, 11)
        ms = graph_ms(kern, inner=inner, reps=reps)
        oms = graph_ms(old, inner=inner, reps=reps)
        pms = graph_ms(plain, inner=inner, reps=reps)
        lms = graph_ms(lib, inner=inner, reps=reps)
        b, by = sparse_bound_ms(n, dx + dy, m)
        byts = 4 * (5 * n * (dx + dy) + n * (2 * m + 1))
        row = {"phase": "times", "kernel": "sparse_gossip", "n": n,
               "D": [dx, dy] if dy else dx, "pair": bool(dy),
               "max_degree": m, "route": neighbor_gossip.route(n, m, False),
               "ms": ms, "row_block_ms": oms,
               "plain_ms": pms, "bound_ms": b, "bound_by": by,
               "library_ms": lms,
               "library": "torch.sparse.mm(CSR W, [Δ|θ]): gather half only",
               "GB_per_s": byts / ms / 1e6,
               "l2_bytes_by_design": sparse_l2_bytes(n, dx, dy, m, "stripe"),
               "row_block_l2_bytes_by_design": sparse_l2_bytes(
                   n, dx, dy, m, "row_block")}
        if (n, dx, dy) == (SCALE_N, DX, DY):
            # a churn draw's slot pattern, and bf16 stripes
            churn = dict(sparse_topologies(n, gen, dev))["erdos_renyi+mask"]
            ctab = (churn.neighbor_idx, churn.neighbor_w.contiguous(),
                    churn.self_w.contiguous())
            row["churn_draw_ms"] = graph_ms(
                lambda: neighbor_gossip.sparse_gossip_pair_nd(*ctab, x, y),
                inner=inner, reps=reps)
            row["bf16_ms"] = graph_ms(
                lambda: neighbor_gossip.sparse_gossip_pair_nd(
                    *tab, x, y, gossip_dtype="bfloat16"),
                inner=inner, reps=reps)
            path = dict(ms=ms, row_block_ms=oms, plain_ms=pms, bound_ms=b,
                        bound_by=by, library_ms=lms,
                        rows=time_sparse_rows(
                                            sp, x, y, dev, ranks=B4_ROW_RANKS,
                                            timed=functools.partial(
                                                graph_ms, inner=inner,
                                                reps=reps)))
        emit(row)
        del x, y, both
    torch.cuda.empty_cache()
    return path


def time_gossip_rows(w, x, y, ranks, timed, phase="times") -> dict:
    """B1's row block on the decentralized mesh: rank 1 of ``ranks``, its
    rows of W over all n rows of the pair (x, y)'s Δ and θ, on both
    routes, beside the plain version, each timed by ``timed(fn)``; its
    line under ``phase``."""
    from repro_torch.kernels import gossip, ref

    n = w.shape[0]
    k = n // ranks
    wr = w[k:2 * k].contiguous()
    xr = (*x[:2], x[2][k:2 * k].contiguous(), *x[3:])
    yr = (*y[:2], y[2][k:2 * k].contiguous(), *y[3:])
    rt = gossip.route(n)
    fns = {r: functools.partial(
        gossip.fused_gossip_pair_nd, wr, xr, yr, row0=k,
        force_route=None if r == rt else r) for r in gossip.ROUTES}
    fns["plain"] = lambda: (ref.fused_gossip_ref(wr, *xr, row0=k),
                            ref.fused_gossip_ref(wr, *yr, row0=k))
    ms = {name: timed(fn) for name, fn in fns.items()}
    dx, dy = x[0].shape[1], y[0].shape[1]
    bx, by = gossip_rows_bound_ms(n, k, dx), gossip_rows_bound_ms(n, k, dy)
    rows = dict(n=n, rows_a_rank=k, row0=k, D=[dx, dy], route=rt,
                ms=ms[rt], **{f"{r}_ms": ms[r] for r in gossip.ROUTES
                              if r != rt},
                plain_ms=ms["plain"], bound_ms=bx[0] + by[0],
                bound_by=bx[1], library_ms=None)
    emit({"phase": phase, "kernel": "fused_gossip", "pair": True,
          "row_block": True, **rows})
    return rows


def time_sparse_rows(sp, x, y, dev, *, ranks, timed) -> dict:
    """B4's row block on the decentralized mesh: rank 1 of ``ranks``, its
    rows of ``sp`` remapped onto its own rows and its halo, over those
    sources, the pair (x, y); beside it the row-block route, the plain
    version and ``torch.sparse.mm`` of the rank's CSR rows (self loop
    included) on the sources' [Δx|θx|Δy|θy] (the gather half only), each
    timed by ``timed(fn)``."""
    import torch

    from repro_torch.dist import collectives
    from repro_torch.kernels import neighbor_gossip, ref

    n = sp.n
    k = n // ranks
    plan = collectives.halo_plan(sp, collectives.ClientsAxis(
        n=n, rank=1, size=ranks), dev)
    src, rows = plan.cols, slice(k, 2 * k)
    n_src, m = len(src), sp.max_degree
    tab = (plan.table.neighbor_idx, plan.table.neighbor_w,
           plan.table.self_w)
    xr = (x[0][src], x[1][src], x[2][rows].contiguous(), *x[3:])
    yr = (y[0][src], y[1][src], y[2][rows].contiguous(), *y[3:])
    dense = torch.zeros((k, n_src), device=dev)
    dense.index_put_((torch.arange(k, device=dev)[:, None].expand(k, m),
                      tab[0].long()), tab[1], accumulate=True)
    dense[torch.arange(k), torch.arange(k)] += tab[2]
    csr = dense.to_sparse_csr()
    both = torch.cat([xr[0], xr[1], yr[0], yr[1]], dim=1)
    rt = neighbor_gossip.route(n_src, m, False)
    kern = lambda: neighbor_gossip.sparse_gossip_pair_nd(  # noqa: E731
        *tab, xr, yr)
    old = lambda: neighbor_gossip.sparse_gossip_pair_nd(  # noqa: E731
        *tab, xr, yr, force_route="row_block")
    plain = lambda: (ref.sparse_gossip_ref(*tab, *xr),  # noqa: E731
                     ref.sparse_gossip_ref(*tab, *yr))
    lib = lambda: torch.sparse.mm(csr, both)  # noqa: E731
    d = x[0].shape[1] + y[0].shape[1]
    b, by = sparse_rows_bound_ms(k, n_src, d, m)
    out = dict(n=n, rows_a_rank=k, n_src=n_src, max_degree=m, D=[
        x[0].shape[1], y[0].shape[1]], route=rt,
        ms=timed(kern), row_block_ms=timed(old), plain_ms=timed(plain),
        library_ms=timed(lib),
        library="torch.sparse.mm(the rank's CSR rows, [Δ|θ] of its "
                "sources): gather half only", bound_ms=b, bound_by=by)
    emit({"phase": "times", "kernel": "sparse_gossip", "pair": True,
          "row_block": True, **out})
    return out


def phase_profile(dev) -> None:
    """torch.profiler over 10 engine rounds per lowering, eager and
    replayed as a CUDA graph, at the main path's shape and at the scale
    path's (n = 4096, exp), compressed (int8) and robust under attack
    (sign_flip) beside the exact lowerings: device busy time against the
    wall clock, and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import engine as engine_lib
    from repro_torch.core import sparse_topology as sp_lib

    rounds = 10
    int8 = {"cfg_kw": {"gossip_compress": "int8"}}
    main_attack = {"attack_fn": attack_fn(N, "sign_flip", dev)}
    scale_attack = {"attack_fn": attack_fn(SCALE_N, "sign_flip", dev,
                                           num_byzantine=SCALE_N // 64)}
    cells = [("main", {}, [("dense", {}), ("pallas_packed", {}),
                           ("fused_round", {}), ("pallas_packed", int8),
                           ("fused_round", int8),
                           ("trimmed_mean", main_attack),
                           ("coord_median", main_attack)])]
    cells.append(("scale", dict(n=SCALE_N, topology="exp"),
                  [("dense", {}), ("sparse_packed", {}),
                   ("sparse_trimmed_mean", scale_attack),
                   ("sparse_coord_median", scale_attack)]))
    for cell, kw, impls in cells:
        problem, client_batch, batches = main_setup(dev, n=kw.get("n", N))
        if cell == "scale":
            # the same static W for dense as sparse_packed builds
            kw = dict(kw, w=sp_lib.densify(sp_lib.sparse_exp(SCALE_N).to(dev)))
        for (impl, extra), capture in ((i, c) for i in impls
                                       for c in (False, True)):
            w_kw = kw if impl == "dense" else {
                key: v for key, v in kw.items() if key != "w"}
            state, build = prepare(problem, client_batch, batches,
                                   "kgt_minimax", impl, dev, log_every=rounds,
                                   capture=capture, **w_kw, **extra)
            # a first run builds the kernels and captures the chunk
            engine_lib.run(state, build, total_rounds=rounds,
                           chunk_rounds=rounds)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                engine_lib.run(state, build, total_rounds=rounds,
                               chunk_rounds=rounds)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            # kernels are the device-side events; the CPU ops that launched
            # them carry the same device time again
            avgs = prof.key_averages()
            events = [e for e in avgs if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0]
            busy_us = sum(e.self_device_time_total for e in events)
            top = sorted(events, key=lambda e: e.self_device_time_total,
                         reverse=True)[:6]
            emit({"phase": "profile", "cell": cell, "mixing_impl": impl,
                  "option": ("int8" if "cfg_kw" in extra else "sign_flip"
                             if "attack_fn" in extra else None),
                  "cuda_graph": capture, "n": kw.get("n", N),
                  "rounds": rounds,
                  "wall_us_per_round": wall_us / rounds,
                  "device_busy_us_per_round": busy_us / rounds,
                  "device_busy_share": busy_us / wall_us,
                  "kernels_per_round": sum(e.count for e in events) / rounds,
                  "top": [[e.key[:60], e.self_device_time_total / rounds,
                           e.count / rounds] for e in top]})
        del problem, client_batch, batches, kw
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    phases = set(ap.parse_args(argv).phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from repro_torch.dist import launch as dist_launch
    from repro_torch.kernels import _build

    if phases & {"mesh", "fsdp_mesh", "serve_mesh"}:
        # the fork server the mesh phases' ranks fork from imports torch
        # and the port while the kernels build
        dist_launch.start_forkserver()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    smi = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: [ln for ln in log.splitlines() if "registers" in ln
                           or "spill" in ln or "arning" in ln]
                    for name, log in _build.stats["log"].items()}})
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    names = ("fused_gossip", "fused_round", "sparse_gossip",
             "flash_attention", "rglru_scan", "ssd_scan",
             "fused_cross_entropy", "ce_partials")
    errs = dict.fromkeys(names)
    cases_by_route = {}
    gossip_row_cases = None
    ce_partials_times = {}
    if "kernels" in phases:
        errs = {}
        errs["fused_gossip"], cases_by_route["fused_gossip"], \
            gossip_row_cases = check_gossip(gen, dev)
        errs["fused_round"], cases_by_route["fused_round"] = \
            check_round(gen, dev)
        errs["sparse_gossip"], cases_by_route["sparse_gossip"] = \
            check_sparse_gossip(gen, dev)
        errs["flash_attention"], cases_by_route["flash_attention"] = \
            check_flash_attention(gen, dev)
        errs["rglru_scan"], cases_by_route["rglru_scan"] = \
            check_rglru_scan(gen, dev)
        errs["ssd_scan"], cases_by_route["ssd_scan"] = \
            check_ssd_scan(gen, dev)
        errs["fused_cross_entropy"], cases_by_route["fused_cross_entropy"] = \
            check_cross_entropy(gen, dev)
        errs["ce_partials"], cases_by_route["ce_partials"], \
            ce_partials_times = check_ce_partials(gen, dev)
        torch.cuda.synchronize()
    launches = dict.fromkeys(names)
    launches_by_route = {}
    if "main" in phases:
        main_launches, main_routes = phase_main(dev)
        launches.update(main_launches)
        launches_by_route["fused_round"] = main_routes["fused_round"]
        launches_by_route["fused_gossip"] = main_routes["fused_gossip"]
    qs_launches = dict.fromkeys(names)
    qs_routes = {}
    if "quickstart" in phases:
        qs_counts, qs_routes = phase_quickstart(dev)
        qs_launches.update(qs_counts)
    scale = {}
    if "scale" in phases:
        scale = phase_scale(dev)
        launches["sparse_gossip"] = scale["sparse_gossip_launches"]
        launches_by_route["sparse_gossip"] = \
            scale["launches_by_route"]["sparse_gossip"]
    if "graph" in phases:
        phase_graph(dev, smi)
    if "sweep" in phases:
        phase_sweep(dev, smi)
    compressed = {}
    if "compress" in phases:
        compressed = phase_compress(dev, smi)
    if "adversary" in phases:
        phase_adversary(dev, smi)
    if "obs" in phases:
        phase_obs(dev, smi)
    launches_eval = dict.fromkeys(names)
    eval_routes = {}
    if "serve" in phases:
        serve = phase_serve(dev)
        for name, arch in (("flash_attention", SERVE_ARCH),
                           ("rglru_scan", SERVE_ARCH),
                           ("ssd_scan", MAMBA_ARCH)):
            launches[name] = serve[arch]["launches"]["prefill"][name]
        launches_by_route["flash_attention"] = \
            serve[SERVE_ARCH]["launches_by_route"]["flash_attention"]
        launches_by_route["ssd_scan"] = \
            serve[MAMBA_ARCH]["launches_by_route"]["ssd_scan"]
        launches_by_route["rglru_scan"] = \
            serve[SERVE_ARCH]["launches_by_route"]["rglru_scan"]
    if "scheduler" in phases:
        phase_scheduler(dev, smi)
    if "evaluate" in phases:
        evaluated = phase_evaluate(dev)
        launches_eval.update(evaluated["launches"])
        launches["fused_cross_entropy"] = launches_eval["fused_cross_entropy"]
        eval_routes = evaluated["launches_by_route"]
        launches_by_route["fused_cross_entropy"] = \
            eval_routes["fused_cross_entropy"]
    launches_train = dict.fromkeys(names)
    train_routes, train_times = {}, {}
    if "train" in phases:
        trained = phase_train(dev, gen, smi)
        launches_train.update(trained["launches"])
        train_routes = trained["launches_by_route"]
        train_times.update(trained["times"])
    launches_mesh = dict.fromkeys(names)
    mesh_routes, mesh_gossip = {}, {}
    if "mesh" in phases:
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        meshed = phase_mesh(dev, smi)
        launches_mesh.update(meshed["launches"])
        mesh_routes = meshed["launches_by_route"]
        mesh_gossip = meshed["gossip_kernels"]
    fsdp_launches, fsdp_routes, fsdp_shapes = dict.fromkeys(names), {}, {}
    fsdp_runs = []
    if "fsdp_mesh" in phases:
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        fsdp = phase_fsdp_mesh(dev, smi)
        fsdp_launches.update(fsdp["launches"])
        fsdp_routes = fsdp["launches_by_route"]
        fsdp_shapes = fsdp["kernel_times"]
        fsdp_runs = fsdp["runs"]
        launches["ce_partials"] = fsdp["launches"]["ce_partials"]
        launches_by_route["ce_partials"] = fsdp_routes["ce_partials"]
    serve_mesh = {}
    if "serve_mesh" in phases:
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        serve_mesh = phase_serve_mesh(dev, gen, smi)
    launches_train_ssm = dict.fromkeys(names)
    train_ssm_routes, backward_train_ssm = {}, {}
    if "train_ssm" in phases:
        trained = phase_train_ssm(dev, gen, smi)
        launches_train_ssm.update(trained["launches"])
        train_ssm_routes = trained["launches_by_route"]
        train_times.update(trained["times"])
        reduced = trained["recurrentgemma_reduced"]
        backward_train_ssm = {
            **{f"grads_{dt}": reduced["grads"][dt]["backward_launches"][
                "rglru_scan"] for dt in reduced["grads"]},
            "round": reduced["round"]["backward_launches"]["rglru_scan"]}
    # the moe and frontends phases' launches: {path: {kernel: launches}}
    launches_moe, moe_routes = {}, {}
    if "moe" in phases:
        moe = phase_moe(dev, gen, smi)
        launches_moe = {"prefill": moe["launches_prefill"],
                        "evaluate": moe["launches_evaluate"],
                        "train": moe["launches"]}
        moe_routes = moe["launches_by_route"]
    launches_frontends = {}
    if "frontends" in phases:
        front = phase_frontends(dev, gen, smi)
        launches_frontends = {"prefill": front["launches_prefill"],
                              "evaluate": front["launches_evaluate"]}
    times = {name: {} for name in names}
    if "times" in phases:
        times = phase_times(dev, gen)
    times["ce_partials"] = ce_partials_times
    if "profile" in phases:
        phase_profile(dev)
    torch.cuda.synchronize()
    from repro_torch.kernels import ops

    kernels = [
        {"name": "fused_gossip", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gossip.cu",
         "replaces": "src/repro/kernels/gossip.py:59"},
        {"name": "fused_round", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_round.cu",
         "replaces": "src/repro/kernels/fused_round.py:99"},
        {"name": "sparse_gossip", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/neighbor_gossip.cu",
         "replaces": "src/repro/kernels/neighbor_gossip.py:75"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:72"},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:43"},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:63"},
        {"name": "fused_cross_entropy", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cross_entropy.cu",
         "replaces": "src/repro/kernels/cross_entropy.py:66"},
        # B6's vocab-parallel form: the pieces GSPMD's vocab-sharded head
        # gives the reference's fused_ce_nd
        {"name": "ce_partials", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cross_entropy.cu",
         "replaces": "src/repro/kernels/cross_entropy.py:66"},
    ]
    for k in kernels:
        t = times[k["name"]]
        if k["name"] in train_times:
            # forward, plain forward, backward (plain) and bound at the
            # train paths' shapes
            k["train_shapes"] = train_times[k["name"]]
        k.update(launches=launches[k["name"]],
                 launches_quickstart=qs_launches[k["name"]],
                 launches_evaluate=launches_eval[k["name"]],
                 launches_train=launches_train[k["name"]],
                 launches_mesh=launches_mesh[k["name"]],
                 launches_fsdp_mesh=fsdp_launches[k["name"]],
                 launches_fsdp_mesh_by_run={
                     r["name"]: r["launches"].get(k["name"])
                     for r in fsdp_runs} or None,
                 fsdp_mesh_shapes=fsdp_shapes.get(k["name"]),
                 launches_train_ssm=launches_train_ssm[k["name"]],
                 launches_moe={path: c.get(k["name"]) for path, c
                               in launches_moe.items()} or None,
                 launches_frontends={path: c.get(k["name"]) for path, c
                                     in launches_frontends.items()} or None,
                 max_abs_err=errs[k["name"]],
                 ms=t.get("ms"), plain_ms=t.get("plain_ms"),
                 bound_ms=t.get("bound_ms"), bound_by=t.get("bound_by"),
                 library_ms=t.get("library_ms"))
        if k["name"] in GOSSIP_KERNELS:
            # the decentralized mesh's row block (PERF.md rows 1m, 3m): its
            # time at the checked shapes, and its launches on every rank of
            # the mesh phase's run through it
            k["mesh_rows"] = {**t.get("rows", {}),
                              **mesh_gossip.get(k["name"], {})}
        if k["name"] == "fused_gossip":
            # B1's row blocks held in the kernels phase: at the main
            # path's shape, the mesh phase's and the fsdp_mesh phase's
            k["row_block_cases"] = gossip_row_cases
        scan_mesh = serve_mesh.get("kernels", {}).get(k["name"])
        if scan_mesh:
            # the serve_mesh phase's scan archs at (1, 2): each rank's
            # launches (by route where the kernel has two) and the kernel
            # at a model rank's shard shape
            k.update(launches_serve_mesh_scan_by_rank=scan_mesh[
                "launches_by_rank"], serve_mesh_scan_shards=scan_mesh[
                    "shards"])
        if k["name"] in ops.ROUTED:
            # two routes: ms is the time of the route the main paths take
            # (tensor cores, or B2's cluster); the other route's beside it
            k.update(launches_by_route=launches_by_route.get(k["name"]),
                     launches_by_route_quickstart=qs_routes.get(k["name"]),
                     launches_by_route_evaluate=eval_routes.get(k["name"]),
                     launches_by_route_train=train_routes.get(k["name"]),
                     launches_by_route_mesh=mesh_routes.get(k["name"]),
                     launches_by_route_fsdp_mesh=fsdp_routes.get(k["name"]),
                     launches_by_route_fsdp_mesh_by_run={
                         r["name"]: r["launches_by_route"].get(k["name"])
                         for r in fsdp_runs} or None,
                     launches_by_route_train_ssm=train_ssm_routes.get(
                         k["name"]),
                     launches_by_route_moe=moe_routes.get(k["name"]),
                     cases_by_route=cases_by_route.get(k["name"]))
            old = OLD_ROUTE.get(k["name"], "cuda_core")
            k[f"{old}_ms"] = t.get(f"{old}_ms")
            if k["name"] == "ssd_scan":
                k["bound_ms_at_f32_cuda_core_peak"] = t.get(
                    "bound_ms_at_f32_cuda_core_peak")
            if k["name"] == "rglru_scan":
                # the routes at each timed shape, and the backward kernel
                # (the chunked kernel in reverse time): its launches in the
                # train_ssm phase's reduced recurrentgemma-9b and its time
                k.update(route_ms_by_shape={
                    case: {f: t[f"shape_{case}"].get(f) for f in (
                        "shape", "route", "walk_ms", "chunked_ms",
                        "backward_ms", "bound_ms", "backward_bound_ms",
                        "plain_ms")}
                    for case in ("served", "32k", "train", "mesh_rank")
                    if f"shape_{case}" in t},
                    backward_launches_train_ssm=backward_train_ssm or None,
                    backward_launches_fsdp_mesh_by_run={
                        r["name"]: r["backward_launches"]["rglru_scan"]
                        for r in fsdp_runs} or None,
                    backward_ms=t.get("backward_ms"),
                    backward_bound_ms=t.get("backward_bound_ms"))
            if k["name"] == "flash_attention" and serve_mesh:
                # the serve_mesh phase: each rank's prefill launches by
                # route on each mesh, and B5 at a model rank's shard shape
                k.update(launches_by_route_serve_mesh_by_rank=serve_mesh[
                    "launches_by_route_by_rank"],
                         serve_mesh_shard=serve_mesh["b5_shard"])
            if k["name"] == "fused_round":
                # the compress phase: B2's compress branch (B3 inside) on
                # the round path, by route
                k.update(launches_compress=compressed.get(
                    "launches", {}).get("fused_round"),
                         launches_compressed_by_route=compressed.get(
                             "compressed"))
    print(smi, flush=True)
    emit({"kernels": kernels,
          "launches_note": "ce_partials (B6's vocab-parallel form) and "
                           "launches_fsdp_mesh: rank 0 of the fsdp_mesh "
                           "phase (qwen2-0.5b at "
                           f"{FSDP_MESH_LAYERS} layers on (clients 2, "
                           f"fsdp 2, model 2), {FSDP_MESH_ROUNDS} rounds "
                           "of K = 4 under autograd and remat: B6's "
                           "partials once a local step, B5 twice a layer "
                           "and local step (the forward and the "
                           "recompute), B1 once a round; every rank "
                           "launches as many); "
                           "launches_fsdp_mesh_by_run: rank 0 of each of "
                           "the phase's runs (qwen2-0.5b without remat, B5 "
                           "once a layer and local step, and with its "
                           "weights whole on (clients 2, fsdp 1, model 2), "
                           "the whole-vocabulary B6 in place of the "
                           "partials; mamba2-1.3b and "
                           "granite-moe-1b-a400m at full width, "
                           f"{FSDP_MESH_LAYERS} layers, and the reduced "
                           "recurrentgemma-9b, one round each: B7 and B8 "
                           "twice a layer of their kind and local step "
                           "under remat, B8's backward once); "
                           "fsdp_mesh_shapes: each "
                           "kernel at a rank's shape in each run; "
                           "fused_gossip, fused_round: the main phase "
                           "(n = 8; fused_gossip one pair launch a round "
                           "of the 2 tracking algorithms; like "
                           "sparse_gossip's, replayed launches of captured "
                           "chunks, each replay adding what its capture "
                           "recorded); sparse_gossip: "
                           "the scale phase (n = 4096, 20 rounds × 4 "
                           "algorithms, one pair launch a round of the 2 "
                           "tracking ones); fused_round's "
                           "launches_compress: the compress phase (50 "
                           "rounds × 2 tracking algorithms × {bf16, int8}, "
                           "every one with compression); "
                           "flash_attention, rglru_scan: the serve phase's "
                           "prefill (recurrentgemma-9b, 4 × 4096 tokens); "
                           "rglru_scan's backward_launches_train_ssm: the "
                           "reduced recurrentgemma-9b's gradient checks "
                           "and round in the train_ssm phase (one a "
                           "forward launch under a gradient); "
                           "ssd_scan: the serve phase's prefill "
                           "(mamba2-1.3b, 8 × 4096 tokens); "
                           "fused_cross_entropy: the evaluate phase (4 "
                           "clients × 4 × 4096 tokens), where ssd_scan "
                           "launches too (launches_evaluate); "
                           "launches_train: the train phase's main run "
                           "(qwen2-0.5b, n = 4, one captured chunk of 3 "
                           "rounds of K = 4 local steps under autograd, 3 "
                           "logged rows); launches_mesh: rank 0 of the "
                           "mesh phase's scan run (qwen2-0.5b at "
                           f"{MESH_LAYERS} layers, n = 4 over "
                           f"2 ranks, 2 clients a rank, {MESH_ROUNDS} "
                           "rounds in one eager chunk, a logged row a "
                           "round on every rank); "
                           "launches_train_ssm: "
                           "the "
                           "train_ssm phase's main run (mamba2-1.3b at "
                           f"{SSM_LAYERS_CAPTURED} layers, n = "
                           f"{SSM_TRAIN_N}, the same chunk); "
                           "launches_moe: granite-moe-1b-a400m's prefill "
                           "(4 × 4096 tokens), evaluate (4 clients) and "
                           f"train main run ({MOE_LAYERS_CAPTURED} layers, "
                           f"n = {MOE_TRAIN_N}, the same chunk); "
                           "launches_by_route_serve_mesh_by_rank: B5 on "
                           "each rank of the serve_mesh phase's worlds "
                           "(qwen2-0.5b, a 4 × 4096 prefill and 32 decode "
                           "steps on (data 1, model 2) and (data 2, model "
                           "1)), serve_mesh_shard B5 at a model rank's "
                           "shard shape (4, 4096, 7, 1, 64); "
                           "launches_serve_mesh_scan_by_rank: B5, B7 and "
                           "B8 on each rank of the serve_mesh phase's "
                           "(data 1, model 2) runs of mamba2-1.3b ("
                           f"{SERVE_SCAN['mamba2-1.3b'][1]} "
                           "layers, a 2 × 4096 prefill) and "
                           "recurrentgemma-9b (38 layers, 1 × 4096), "
                           "serve_mesh_scan_shards each at a model rank's "
                           "shard shape; "
                           "launches_frontends: musicgen-medium's prefill "
                           "(4 × 1500 frames) and evaluate (4 clients, B6 "
                           "once a codebook); train_shapes: "
                           "each model kernel at its training shape",
          "ms_note": "ce_partials: at a rank's shape on the "
                     "fsdp_mesh phase's block (256 tokens, d 896, a "
                     "vocabulary piece of 75 968), bf16; "
                     "fused_gossip: the pair at (8, 384 + 128); "
                     "sparse_gossip: the pair at (4096, 384 + 128); "
                     "mesh_rows: the row block of a rank of the "
                     "decentralized mesh, B1 4 of the 8 rows, B4 1024 of "
                     "the 4096 over its own rows and its halo; "
                     "mesh_rows.mesh_rank: the same at the mesh phase's "
                     "own shape (n = 4 over 2 ranks, 2 rows a rank, D = "
                     "qwen2-0.5b's packed parameters at "
                     f"{MESH_LAYERS} layers and its 8 group "
                     "weights), each route, device time by CUDA events "
                     "around single calls; with its launches on every rank of the mesh phase's "
                     "pallas_packed+int8 and sparse_packed runs (one a "
                     "round); "
                     "rglru_scan: the served (4, 4096, 4096) on the "
                     "route its rule gives, device time over operand "
                     "sets past the L2, route_ms_by_shape the same at "
                     "the four timed shapes; "
                     "<old route>_ms: the same work on the first port's "
                     "kernel (two launches for a pair)",
          "library_ms_note": "ce_partials: torch.mm to f32 logits "
                             "(its out_dtype where the build has it) and "
                             "F.cross_entropy on the piece; "
                             "fused_gossip, fused_round, rglru_scan, "
                             "ssd_scan: no single PyTorch call computes the "
                             "function; sparse_gossip: torch.sparse.mm of "
                             "the CSR W on [Δx|θx|Δy|θy], the gather half "
                             "only, at the scale path's pair; "
                             "flash_attention: "
                             "scaled_dot_product_attention with the banded "
                             "bool mask at the served shape (bf16); "
                             "fused_cross_entropy: the nearest, two calls "
                             "(torch.mm to f32 logits, then "
                             "F.cross_entropy) at the evaluate shape"})
    if set(PHASES) - phases:
        print(f"chip_smoke: only ran {sorted(phases)}", file=sys.stderr)
        return 2
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
