#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of PowerWalk (``src/repro_torch``).

    python3 chip_smoke.py        # one CUDA GPU; nvcc under PATH or CUDA_HOME

Phases, each timed and printed:

1. build the eight CUDA kernels (``walk_step``, ``frontier_push``,
   ``index_combine_sparse``, ``ell_spmm``, ``index_combine``,
   ``sharded_frontier_push``, ``embedding_bag``, and
   ``embedding_bag_backward``, which has no TPU kernel: the lookups'
   table gradient, the transpose of the reference's gather) from
   ``src/repro_torch/kernels/csrc`` with nvcc, one process per source, all
   started together;
2a. hold each kernel against its plain PyTorch version on the card, on
   synthetic inputs whose masses are multiples of 2**-10 (and power-of-two
   degrees or weights, and embedding masks in {0, 0.5, 1}), so every f32
   sum is exact in any order and the outputs must be bit-equal, indices
   included; the cases include ``sharded_frontier_push`` rows of more
   than 300,000 edges (its wide-row path, ``csrc/wide_row.cuh``),
   ``ell_spmm`` from one-hot, all-zero and fully dense frontiers, the
   streamed ``frontier_push``'s one-slot chunks over the column-sorted
   view (hub rows of 4,096 edges, rows out of column order, rows that
   repeat a column, ``degree_cap`` below a row's degree), and the dense
   ``index_combine`` on split columns and two q tiles, whose non-dyadic
   case must give the same bytes on two launches and the plain version's
   CPU bits on every column summed in one run, and the sparse
   ``index_combine`` on both of its paths (the hash path up to ``k_out``
   1,024, the sort path above): at the main path's shape with a column in
   every live slot, with every column in one hash part (more than one
   block's table holds), with ties at the ``k_out`` edge and with
   ``k_out`` above a row's distinct columns, the hash path's output the
   same bytes on two launches; ``embedding_bag`` at 1, 31, 33, 1,000,
   70,001 and 1,000,003 bags of 1 and 32 slots, D = 16, 17, 32, 48, 64
   and 128, and apart at D = 50 (SASRec's width) and D = 576
   (smollm-135m's: 4.5 passes of a warp's 128 columns), tables 4 and 8
   bytes past alignment, with a mask and with none, two launches the same
   bytes; ``embedding_bag_backward`` at D = 16, 50, 64 and 576, bags of 1
   and 8 with one row hit 10,000 (2,000) times, negative and outside ids,
   with a mask and none, f32 and bf16 rows and gradients, and its fused
   zero fill (``embedding_bag_backward_fill``: 24,000 slots into 10^6
   rows, the first and last rows untouched, a prime number of rows, every
   row touched, no live id, rows hit 10,000 times at a tile's first and
   last row, D = 17 and 50, gradients 4 and 8 bytes past alignment), each
   launched into a NaN-filled gradient, against the plain version bit for
   bit, rows no id hits +0.0, and two launches the same bytes; the GCN's
   bag layout and both kernels at D = 1,433, 602, 100 and 16
   (``embedding_bag_gcn``: zero-weight padding at each row's own id,
   exact sums against float64); and, plain
   PyTorch on the card against the
   CPU, bit-equal: ``rng.randint`` (spans 1, 2, 3, 2**16 + 1 and 2**31 -
   1, one ``maxval`` per draw) and the dense walk engine
   ``walks.simulate_walks``;
3. the sparse main path: ``rmat(20, avg_deg=10)`` (n = 1,048,576),
   ``build_index`` over every source (3b), then ``PPRService`` on the
   sparse route (``hub_split_degree=64``) answering 16,384 requests closed
   loop, 64 batches of 256 (3c).  The launch counters are zeroed just
   before the build and read just after the serve; the path's three
   kernels must have launched.  Then, outside that count, one sparse batch
   of 256 and one build chunk of 4,096 sources are split by kernel
   (``torch.profiler``), each with the device's idle share, the chunk with
   ``walk_step``'s time per launch;
3d. the dense main path on the same graph and index: ``PPRService`` at the
   default ``hub_split_degree=0``, which routes dense on this hub-heavy
   graph, serving the same 16,384 requests with the counters zeroed just
   before and read just after: ``ell_spmm`` must launch twice per batch
   and ``index_combine`` once; the ELL view and the index's transposed
   view (``PPRIndex.columns``, its build time and bytes printed) are
   built first, outside the serve and its peak memory; times one batch
   and its top-k, and splits one batch's device time by kernel
   (``torch.profiler``);
3e. the first 64 requests through ``pi`` (100 iterations, the ground
   truth), ``fppr``, dense ``verd``, dense and sparse ``powerwalk``:
   prints mean RAG and precision at k = 50 against ``pi`` and the time of
   the ``pi`` batch, whose last push is kept as ``ell_spmm``'s ``dense``
   variant; the ``pi`` rows must be stochastic, each summing to 1 within
   1e-4, and every answer finite and non-negative;
3f. the distributed engine on the same graph, with the counters zeroed
   just before and read just after: ``build_index_sharded`` (r = 100,
   respawn mode) on a 2 x 4 ``ShardMesh``, whose first chunk of every
   shard must equal the single-device ``r_splits=2`` build of that chunk
   bit for bit; then the sparse-exchange VERD tile step on four stacked
   shards with 3b's index, answering the same 16,384 requests in 64 tiles
   of 256: ``sharded_frontier_push`` must launch ``t * ep`` = 8 times per
   tile and every answer be finite, non-negative, of mass at most 1 +
   1e-4; prints ms per tile, requests per second, peak memory, the
   device time by kernel over four more tiles (``torch.profiler``) with
   the push's share of it, the
   computed wire bytes per iteration, and RAG and precision at k = 50
   against 3e's ``pi``; then, as 3q's yardsticks, each model shard's rows
   digested, the same tile step answering the same 64 tiles from the
   sharded build's rows and a ``PPRService`` on them serving 3c's first
   4,096 requests;
3q. the rank mesh: 8 processes spawned on the one card, a ``RankMesh(2,
   4)`` over gloo (collectives staged through host memory), each
   regenerating 3a's graph (its fingerprint the parent's) and running
   3f's build one shard a process, its launch counters zeroed just before
   the build and read after its tiles: each rank's rows the same bytes as
   3f's rows of its model shard, on both data replicas; ranks 0-3 (a
   ``RankMesh(1, 4)`` of the first replica) then answer 3c's 16,384
   requests in 64 tiles of 256 from the rows they built, the answers the
   same bytes on every rank and as 3f's stacked tile step on the same
   rows; ``walk_step`` launched on every rank and ``sharded_frontier_push``
   ``t`` = 2 times a tile on each tile rank.  Then NCCL: with one card, a
   1 x 1 ``RankMesh`` over NCCL answers 4 tiles at ``ep = 1`` on 3b's
   index, the same bytes as ``ShardMesh(1, 1)``; with four cards or more,
   the 1 x 4 tile step over NCCL, a rank a card, the same bytes as the
   gloo ranks'.  Prints the spawn seconds, each rank's build seconds, ms
   a tile and requests/s (8 processes time-sliced on one card, collectives
   through gloo and host memory: not a multi-card figure) and the phase's
   seconds.  Then, on the same spawned ranks: (i) ranks 0-3 serve the
   first 4,096 of 3c's requests in batches of 256 through ``PPRService``
   over the rows they built (rank 0 leads, gathering each batch's touched
   rows from their owners; ranks 1-3 run ``serve_follower``), the answers
   the same bytes as 3f's stacked ``PPRService`` on the assembled index,
   ``frontier_push`` and ``index_combine_sparse`` counted on the leader
   (zeroed just before, read just after), every rank's index its own
   ``[n_shard, L]`` rows; it prints qps, p50 / p99, the row bytes a batch
   that crossed and its seconds; (ii) rmat(14)'s checkpointed maintainable
   build on the ``RankMesh(2, 4)``, crashed by a ``FaultPlan`` after its
   one partial commit and resumed, one update batch through the leader's
   ``apply_updates`` with ``SMALL_REQUESTS`` served after it, and a
   ``from_checkpoint`` boot serving them: rows, filters, report and both
   answers' bytes equal to the same on ``ShardMesh(2, 4)`` in this
   process; (iii) the NCCL ranks also serve through the rank service,
   1,024 requests on 3b's index on one card (the same bytes as a
   one-device ``PPRService``), 3q (i)'s 4,096 with four cards (the gloo
   ranks' bytes);
3g. the recsys zoo at full width, each model with the counters zeroed
   just before its forwards and read just after, its parameters from the
   port's ``init`` (seed 0) on the card, bf16 compute, the card's name and
   power limit printed first.  DLRM RM2 (arXiv:1906.00091) through
   ``steps.build("dlrm-rm2", ...)``, the 26 x 10^6-row f32 table (6.66 GB)
   included: 520 closed-loop ``serve_p99`` forwards of 512 (latency
   p50/p99 from CUDA events over the last 512), 17 ``serve_bulk`` forwards
   of 262,144, 5 ``retrieval_cand`` forwards of 10^6 candidates, each with
   examples/s and model TFLOP/s, peak memory, the device time of one
   ``serve_p99`` and one ``serve_bulk`` forward by kernel
   (``torch.profiler``), and one ``serve_p99`` batch in f32 on the card
   and through the plain CPU path from the same parameters (max abs
   difference within 1e-4 of max(1, max |output|)).  Then DCN-v2
   (arXiv:2008.13535; a 26 x 10^6 x 16 table, 1.66 GB), SASRec
   (arXiv:1808.09781; 10^6 x 50) and MIND (arXiv:1904.08030; 10^6 x 64)
   the same way, each with 128 ``serve_p99`` forwards (p50/p99 over the
   last 120), 5 ``serve_bulk``, 3 ``retrieval_cand`` and one ``serve_bulk``
   forward split by kernel; serving is DCN-v2's ``forward``, SASRec's
   ``user_embedding`` and MIND's ``user_interests``.  ``embedding_bag``
   must launch ``ZOO_LOOKUPS`` times a forward (one a gather: SASRec's
   items and positions, and in retrieval its candidates), and every
   output be finite and of its shape.  Each model's ``embedding_bag``
   launches are replayed (2b) before its table is freed and the next
   model built;
3h. the Monte-Carlo path on 3a's graph, with the counters zeroed just
   before and read just after (``walk_step`` must launch): for 3e's 64
   sources, the sparse MCFP at r = 1,000 (l = 8,192, which covers r / c),
   the sparse MCEP at r = 1,000 and at ``theory.mcep_equivalent_walks(1000)``
   = 6,667, the dense MCFP and MCEP at r = 1,000 (f32[64, 2^20] each), each
   with its seconds, peak memory and RAG and precision at k = 50 against
   3e's ``pi``, gated finite, non-negative and of row and top-50 mass at
   most 1 + 1e-4, with the paper's ordering MCFP(1000) >= MCEP(6667) >
   MCEP(1000) printed, not gated; ``PPRService`` in ``mcfp`` mode
   (``r_online=2000``, batches of 256) serving 1,024 requests closed loop
   at pipeline depth 4 and again at depth 1, with qps, p50 and p99, whose
   answers must be the same bytes; the legacy build (r = 100, l = 256,
   chunks of 256) over the first 16,384 sources, seconds a chunk; and
   ``plan_for_budget`` and ``preprocessing_cost_model`` at n = 2^20 and
   the budget of 3b's index, printed;
3i. maintenance and crash safety on 3a's graph, with the counters zeroed
   just before and read just after (the sparse path's three kernels must
   launch), the card's name and power limit printed first.  (a) 3b's
   build with ``checkpoint_dir`` in a fresh temporary directory (removed
   at the end), a commit every 64 chunks and a ``FaultPlan`` raising
   before chunk 160, which must raise ``InjectedFault``; then resumed,
   which must start at chunk 128 and give 3b's index and kept and dropped
   totals bit for bit; ``PPRService.from_checkpoint`` then answers 1,024
   of 3c's requests in the same bytes as a service over 3b's index;
   prints each commit's step, bytes and seconds and both runs' seconds.
   (b) the walks of the reference update benchmark
   (``benchmarks/bench_updates.py``: r = 16, l = 32, c = 0.25,
   ``max_steps`` 64, respawn mode) over all 2^20 sources in 1,024 chunks
   of 1,024 (the benchmark's grid of 8 would be 131,072 chunks), with a
   4 GiB touch sketch (4,096 bits a row): ``build_maintainable_index``,
   a ``PPRService`` with its maintainer (sparse route, the sparse
   combine, an answer cache) serving 4,096 requests, ``UPD_BATCHES`` edge
   batches through ``apply_updates`` (4 fresh uniform edges each, the
   previous batch's 4 deleted, the benchmark's pool from seed 5), each
   printed with its seconds, edges/s, dirty rows, repaired chunks,
   resample ratio and cache entries invalidated, the requests served
   again, and a
   rebuild on the final graph: the maintained index and sketch must
   equal the rebuild's bit for bit, the answers computed after the
   updates a fresh service's on the rebuilt index byte for byte, and the
   answers still cached none of a repaired row;
3j. load generation: ``run_open_loop`` of 16,384 requests at 50% and 90%
   of 3c's captured qps, and ``bench_cache.py``'s Zipf seed-set stream;
3k. smollm-135m (hf:HuggingFaceTB/SmolLM-135M) at full width through
   ``steps.build``: 30 layers, d = 576, 9 heads over 3 KV heads, vocab
   49,152, parameters from the port's ``init`` (seed 0) on the card, bf16
   compute, the card's name and power limit printed first, the counters
   zeroed just before its forwards and steps and read just after:
   ``prefill_32k`` at B = 1 (the reference's 32: one f32 score chunk is
   77 GB at 32), S = 32,768, one warm-up and two timed forwards (ms,
   tokens/s, model TFLOP/s by ``2 N B S`` and the plain f32 attention's
   FLOPs beside it, peak memory), one forward traced by kernel with the
   device's idle share; ``decode_32k`` at B = 64 (the reference's 128: its
   bf16 cache is 96.6 GB) and ``long_500k`` at B = 1, each cache filled
   from a seeded generator with ``length`` at S - 1 - 19, two warm-up and
   16 timed steps (p50 / p99 from CUDA events, tokens/s, cache GB, peak
   memory) and one traced step; then a prefill of [2, 64] and 4 decode
   steps from an empty cache in f32, card against the plain CPU path
   (max abs logit difference within 1e-4 of max(1, max |logit|)).
   ``embedding_bag`` must launch ``LM_LOOKUPS`` times (once a forward or
   step), and every logit be finite; the prefill's token lookup (32,768
   ids into the [49,152, 576] f32 table, bf16 out) is replayed (2b)
   before the parameters are freed;
3l. training at full width, each cell with the counters zeroed just
   before its steps and read just after, the card's name and power limit
   printed first: DLRM RM2, DCN-v2, SASRec and MIND ``train_batch`` (B =
   65,536) and smollm-135m ``train_4k`` at B = 8 (the reference's 256: its
   f32 logits are 206 GB), S = 4,096, each through ``steps.build`` under
   its ``DEFAULT_OPT`` (bf16 moments), one warm-up step and 3 timed steps
   on one batch (CUDA events; examples or tokens/s, model TFLOP/s, peak
   memory); the second step's loss must be below 1.5x the first's, every
   loss finite, and ``embedding_bag`` and ``embedding_bag_backward`` each
   launch ``TRAIN_LOOKUPS`` times a step; on DLRM, rows the batch does not
   touch must be updated by weight decay alone, bit for bit, and one more
   step is split by kernel (``torch.profiler``).  Then one step of each
   architecture in f32 at full widths card against the plain CPU path
   (DLRM's and DCN-v2's ``vocab_per_field`` at 10^4, the first 256 rows of
   a batch, the LM one row of 256 tokens): the loss within 1e-5, each
   gradient within 1e-3 of its leaf's norm (``TRAIN_CHECK_GRAD``: a ReLU
   input within rounding of 0 may take the other branch on one side),
   the parameters within the tests' rule, and two controls from the same
   parameters and batch, the step in bf16 and the backward dropping one
   slot, each more than 1e-3 from the CPU's gradients; then
   ``launch/train.py``'s loop on DLRM at
   ``vocab_per_field`` 10^5: 6 steps with a commit every 2 and a failure
   at step 3 must end with the bytes of an uninterrupted run.  After each
   cell, its parameters freed, the backward's replay (2b) at the cell's
   own ids and gradient: the warm-up step's last backward launch (DLRM's
   and DCN-v2's fields, SASRec's ``item_seq``, MIND's history, the LM's
   tokens), whose inputs wait on the host meanwhile;
3m. gcn-cora (arXiv:1609.02907) at full width through ``steps.build``
   under ``DEFAULT_OPT``, the card's name and power limit printed first:
   ``full_graph_sm`` (cora: 2,708 nodes, d_feat 1,433), ``minibatch_lg``
   (1,024 seeds, fanout 15-10, 180,224 block nodes, d_feat 602),
   ``ogb_products`` (2,449,029 nodes, 61,859,140 edges, d_feat 100) and
   ``molecule`` (128 graphs of 30 nodes), nothing cut, each counted from
   zero: the bag layouts' ms (``segment_bags``, CUDA events) and padded
   share, one warm-up and 3 timed steps on one batch (ms, nodes/s,
   edges/s, model TFLOP/s, peak memory), ``embedding_bag`` and its
   backward launched ``GNN_LOOKUPS`` times a step, every loss finite and
   the second below 1.5x the first, two steps from one state the same
   bytes; one f32 step of each card against the plain path (loss 1e-5,
   gradients ``TRAIN_CHECK_GRAD``): the CPU for three shapes,
   ``ogb_products`` against the same step on the card through the
   kernels' plain versions (``plain_kernels``: its plain step would take
   the CPU minutes); ``ogb_products``' warm-up launches (layer 0 at D =
   100, layer 1 at D = 16, the backward at D = 16 over 2,449,408 rows)
   replayed as 2b, each also against its bound on the real edges alone;
   then ``loss_ppr`` on 3b's index (``examples/gnn_ppr.py``'s path):
   4,096 seeds through ``ppr_importance_sample`` (budget 32), 3 SGD steps
   card against CPU within 1e-5, one launch of each kernel a step;
3n. the contract auditor (``repro_torch.analysis``) on the card, every
   rule of its catalog: ``dense-state-bound`` and ``no-replicated-index``
   on the CUDA path, ``retrace-guard`` on the engine's real captures,
   ``hbm-residency`` over the four kernels' sources and, on rmat(12) and
   on 3b's graph and index, each kernel's static shared bytes (read from
   the built library) plus its planners' dynamic bytes at the main path's
   shapes, the same on both graphs and within the opt-in limit, and the
   operands the caller's own storage; every rule PASS with a target
   audited, none SKIP, no unsuppressed finding, and the phase's seconds;
3o. the dry-run (``repro_torch.launch.dryrun``) on meta on the card's
   host: every registry cell at its published size on one card and the
   four PPR engine cells on the ``pod`` (16 x 16) and ``multipod``
   (32 x 16) meshes, against ``Hardware.from_device()``, with its seconds
   and its report; every record ``ok`` and every cell an earlier phase ran
   uncut predicted to fit (gated); then each cell that 3g, 3k, 3l and 3m
   ran, traced again as run (its batch, f32 parameters), its predicted
   peak beside the measured ``max_memory_allocated`` above the phase's
   base and its roofline time beside the measured p50 ms (printed, not
   gated);
2b. replay the inputs of each kernel's first launch on its path (and of
   ``ell_spmm``'s second, a batch's push of a spread-out frontier, and
   its ``dense`` variant, the last push of 3e's ``pi``, of
   ``sharded_frontier_push``'s first second-iteration launch, of
   ``embedding_bag``'s first at DLRM's ``serve_p99``, ``serve_bulk`` and
   ``retrieval_cand`` and at each zoo model's ``serve_bulk`` and its
   candidate gather at ``retrieval_cand`` (variants ``<arch>.<shape>``;
   these are replayed in 3g) and at smollm-135m's ``prefill_32k``
   (replayed in 3k), of ``embedding_bag_backward``'s last in each train
   cell's warm-up step (replayed in 3l; its library call is
   ``index_add_`` into a zero table, its bound counts the whole gradient
   written once, and PR 24's, the touched rows only, is printed beside it
   with a memset of the gradient and each of its two kernels' times),
   and of ``walk_step``'s first in 3h, variant ``mc``)
   through the kernel and its plain version: top-k outputs' sorted values
   within 1e-5 relative and at least 99% of indices equal (summation order
   may differ, which can swap ties at the top-k edge), dense outputs
   within 1e-5 L1 per row and 1e-5 relative per entry, or, for an entry of many terms,
   within the f32 bound on two summation orders of its own count of terms
   (:func:`dense_agree`), ``walk_step``, ``embedding_bag`` and
   ``embedding_bag_backward`` bit-equal (the backward also the same bytes
   on a second launch);
   the dense and the sparse ``index_combine`` launched a second time must
   give the same bytes (the sparse one printing each row's live slots,
   candidates ``w`` and distinct columns ``d``, :func:`combine_counts`).
   Times each kernel (and ``walk_step``'s and ``embedding_bag``'s kernel
   alone, from ``torch.profiler``, since back-to-back calls of a short
   launch time its wrapper's host work; where the trace holds no launch of
   a kernel of a millisecond or more, the back-to-back CUDA-event time,
   labelled so; each printed with its share of its bound), its plain
   version and, where one exists, one PyTorch
   call of the same function (a sparse product,
   ``torch.nn.functional.embedding_bag``), with CUDA events; prints the
   share of ``f``'s columns that hold a non-zero for every ``ell_spmm``
   variant, and the most and the mean gathered edges per row for the
   pushes;
4. a small reference check: ``rmat(14)`` built and served on the card and
   through the plain CPU path from the same key, on the sparse and on the
   dense route: the index bit-equal, the answers within 1e-5 L1 on
   densified rows (one sparse row with ``combine_path="sparse"``, whose
   served path must go through ``index_combine_sparse``); and on the
   distributed engine: the sharded build
   bit-equal, the sparse tile step within 1e-5 L1, and on the card the
   dense exchange within 1e-4 L1 of the sparse exchange at covering
   widths; and the reduced configs of DLRM RM2, DCN-v2, SASRec and MIND
   in f32 (``serve_p99`` and ``retrieval_cand``), card against CPU,
   outputs within 1e-5 of their largest, and smollm-135m's (G = 1 and
   G = 3) in f32, a prefill and 8 decode steps, logits and caches within
   1e-5 of their largest; one train step of each of the five train
   cells' reduced configs in f32, card against CPU (loss within 1e-5,
   gradients within 1e-5 of each leaf's norm, parameters within the
   tests' rule), and of gcn-cora's four shapes; and the Monte-Carlo
   path, card against CPU, bit-equal: the legacy build of every fourth
   source, the dense and sparse MCFP and MCEP estimates of 64 sources, ``mcfp``-mode answers at dispatch keys
   0-3, and ``randint``; and maintenance at ``rmat(14)``, bit-equal: the
   repair on the card against the CPU's and against the card's rebuild,
   on one device and on a stacked 2 x 2 mesh, and a checkpointed build
   crashed and resumed on the card against an uninterrupted one.

The checks of phases 2a and 4 are also the ``cuda``-marked tests of
``tests/test_torch_cuda.py``, which call the functions here.

Prints one JSON line with each kernel's numbers (``launches`` summed over
the paths that run it, each counted from zero, and split in
``launches_by_path``), the card's name and power limit, and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result line, if there is no GPU or any phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM f32 peak outside the tensor cores
MAIN_N_LOG2 = 20
MAIN_R = 100
MAIN_L = 256
MAIN_SOURCE_BATCH = 4096
MAIN_REQUESTS = 16384
E_ROWS = 64                    # requests scored against pi in phase 3e
KERNEL_SOURCES = {
    "walk_step": ("src/repro_torch/kernels/csrc/walk_step.cu",
                  "src/repro/kernels/walk_step.py:63"),
    "frontier_push": ("src/repro_torch/kernels/csrc/frontier_push.cu",
                      "src/repro/kernels/frontier_push.py:168"),
    "index_combine_sparse": ("src/repro_torch/kernels/csrc/index_combine.cu",
                             "src/repro/kernels/index_combine.py:136"),
    "ell_spmm": ("src/repro_torch/kernels/csrc/ell_spmm.cu",
                 "src/repro/kernels/ell_spmm.py:56"),
    "index_combine": ("src/repro_torch/kernels/csrc/index_combine_dense.cu",
                      "src/repro/kernels/index_combine.py:52"),
    "sharded_frontier_push": (
        "src/repro_torch/kernels/csrc/sharded_frontier_push.cu",
        "src/repro/kernels/frontier_push.py:265"),
    "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag.py:40"),
    # no TPU kernel: the transpose of the reference's gather (a scatter-add
    # XLA emits), which every train step's lookups need
    "embedding_bag_backward": (
        "src/repro_torch/kernels/csrc/embedding_bag_backward.cu",
        "src/repro/models/recsys/embedding.py:56"),
}
SPARSE_PATH = ("walk_step", "frontier_push", "index_combine_sparse")
DENSE_PATH = ("ell_spmm", "index_combine")
DIST_PATH = ("walk_step", "sharded_frontier_push")
RANK_DATA = 2                  # phase 3q: the rank mesh is RANK_DATA x DIST_EP
RANK_NCCL_TILES = 4            # phase 3q's NCCL check, tiles at ep = 1
RANK_TIMEOUT_S = 300.0         # phase 3q: a collective's timeout, each run's
RANK_JOIN_S = 420.0            # ...and the spawned ranks' deadline
RANK_SERVE_REQUESTS = 4096     # 3q (i): 3c's first requests, rank service
RANK_NCCL_REQUESTS = 1024      # 3q (iii): the 1 x 1 NCCL service's
RANK_SERVE_PATH = ("frontier_push", "index_combine_sparse")  # its leader's
SMALL_N_LOG2 = 14              # 3q (ii): the small stack on the same ranks
SMALL_STACK = dict(r=16, l=64, source_batch=1024, touch_bits=4096)
SMALL_CKPT_EVERY = 2           # of 4 chunks a shard: one partial commit
SMALL_REQUESTS = 512           # served after the update, and after a boot
RECSYS_PATH = ("embedding_bag",)   # phase 3g: each recsys model's forwards
# embedding_bag launches one forward makes, one a gather: the one-hot
# fields (DLRM, DCN-v2; field 0 holds the candidates in retrieval),
# SASRec's items and positions (and its candidates), MIND's history (and
# its candidates)
ZOO_LOOKUPS = {("dlrm-rm2", "rec_serve"): 1, ("dlrm-rm2", "rec_retrieval"): 1,
               ("dcn-v2", "rec_serve"): 1, ("dcn-v2", "rec_retrieval"): 1,
               ("sasrec", "rec_serve"): 2, ("sasrec", "rec_retrieval"): 3,
               ("mind", "rec_serve"): 1, ("mind", "rec_retrieval"): 2}
# embedding_bag launches an LM step makes: one token lookup a prefill
# forward and one a decode step (phase 3k)
LM_LOOKUPS = {(arch, kind): 1 for arch in (
    "smollm-135m", "qwen1.5-32b", "command-r-plus-104b", "dbrx-132b",
    "grok-1-314b") for kind in ("lm_prefill", "lm_decode")}
# embedding_bag launches a train step makes, each with one launch of its
# backward (phase 3l): the lookups of the forward above, and SASRec's
# positives and negatives, MIND's target and negatives in the loss
TRAIN_LOOKUPS = {("dlrm-rm2", "rec_train"): 1, ("dcn-v2", "rec_train"): 1,
                 ("sasrec", "rec_train"): 4, ("mind", "rec_train"): 2,
                 ("smollm-135m", "lm_train"): 1}
TRAIN_PATH = ("embedding_bag", "embedding_bag_backward")   # phase 3l
TRAIN_CELLS = {"dlrm-rm2": "train_batch", "dcn-v2": "train_batch",
               "sasrec": "train_batch", "mind": "train_batch",
               "smollm-135m": "train_4k"}
TRAIN_SEED = 0
TRAIN_PLAN = (1, 3)            # warm-up, timed steps a cell (one batch)
# phase 3l's card-vs-CPU gradient gate at full width, of each leaf's norm:
# a ReLU (or max) input within rounding of 0 can take the other branch on
# one side, and that one element moves every leaf upstream of it (one of
# SASRec's 2.56M feed-forward pre-activations, |z| = 2.2e-7, moved them by
# 2.2e-4); two steps wrong on purpose (bf16 compute, a dropped slot in the
# backward: ``dropped_slot``) read 5.8e-3 and more, and must stay above
# the gate, which sits between the two; the reduced configs are held to 1e-5
TRAIN_CHECK_GRAD = 1e-3
# phase 3l's cuts: train_4k at B = 8 of the reference's 256 (its f32
# logits alone are 206 GB at 256; the step's peak at B = 4 was 18.1 GB),
# S = 4,096, width, depth and vocabulary uncut; the card-vs-CPU step at full widths with DLRM's and DCN-v2's
# vocab_per_field at 10^4, on the first 256 rows of a batch (the LM: one
# row of 256 tokens); the crash-and-resume run on DLRM at vocab_per_field
# 10^5 (a commit is about 1.3 GB)
LM_TRAIN_BATCH = 8
TRAIN_CHECK_VOCAB = 10_000
TRAIN_CHECK_ROWS = 256
TRAIN_CHECK_LM = (1, 256)
TRAIN_CKPT_VOCAB = 100_000
TRAIN_CKPT_PLAN = (6, 2, 3)    # steps, a commit every 2, failure at step 3
GNN_ARCH = "gcn-cora"           # phase 3m: the GCN's four train shapes
GNN_CELLS = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
GNN_PATH = ("embedding_bag", "embedding_bag_backward")
# (embedding_bag, embedding_bag_backward) launches a GCN train step makes:
# one aggregation a layer (layer 0's table is the features, which take no
# gradient), the molecules' per-graph readout with its backward, and
# loss_ppr's one PPR aggregation
GNN_LOOKUPS = {"gnn_full": (2, 1), "gnn_minibatch": (2, 1),
               "gnn_batched": (3, 2), "ppr": (1, 1)}
GNN_SEED = 0
GNN_PLAN = (1, 3)              # warm-up, timed steps a shape (one batch)
GNN_REPLAY = "ogb_products"    # its warm-up step's launches are replayed
GNN_UNPADDED_WIDTH = 25        # ogb_products' mean in-degree is 25.3
# loss_ppr on 3b's index: seeds, the PPR sampler's budget, SGD steps, lr
GNN_PPR = (4096, 32, 3, 0.05)
REC_SEED = 0                   # the recsys models' parameters (3g)
ZOO = ("dcn-v2", "sasrec", "mind")
# phase 3g's forwards a shape: (distinct batches, warm-up forwards, timed
# forwards); serve_p99 is B = 512, serve_bulk 262,144, retrieval_cand one
# user against 10^6 candidates
DLRM_PLAN = {"serve_p99": (512, 8, 512), "serve_bulk": (4, 1, 16),
             "retrieval_cand": (1, 1, 4)}
ZOO_PLAN = {"serve_p99": (128, 8, 120), "serve_bulk": (2, 1, 4),
            "retrieval_cand": (1, 1, 2)}
LM_ARCH = "smollm-135m"        # phase 3k: the LM a single card holds whole
LM_PATH = ("embedding_bag",)   # its token lookups
LM_SEED = 0
# phase 3k's cuts, batch only (width, depth, vocabulary and sequence
# lengths are the published ones): prefill_32k at B = 1 of the
# reference's 32 (one f32 score chunk [32, 3, 3, 32768, 2048] is 77 GB),
# decode_32k at B = 64 of 128 (the bf16 cache 96.6 -> 48.3 GB); long_500k
# is the reference's B = 1
LM_BATCH = {"prefill_32k": 1, "decode_32k": 64, "long_500k": 1}
LM_PREFILL_PLAN = (1, 2)       # warm-up, timed forwards
LM_DECODE_PLAN = (2, 16)       # warm-up, timed steps
LM_CHECK = (2, 64, 4)          # card vs CPU at full width: B, S, decode steps
# phase 3p: the four large LMs at full width with the depth cut, so that
# one card holds each (f32 parameters: 14.6, 37.7, 31.0 and 45.8 GB)
BIG_LMS = {"qwen1.5-32b": 4, "command-r-plus-104b": 2, "dbrx-132b": 2,
           "grok-1-314b": 2}           # arch -> layers run
BIG_SEED = 0
BIG_PREFILL = (1, 4096)        # B, S: cut from the reference's 32 x 32,768
BIG_PREFILL_PLAN = (1, 3)      # warm-up, timed forwards
# decode: (B, cache length), cut from 128 x 32,768 and 1 x 524,288; each
# in the cache its published shape takes (int8 where the bf16 cache would
# pass 0.5 TB)
BIG_DECODE = {"decode_32k": (8, 4096), "long_500k": (1, 16384)}
BIG_DECODE_PLAN = (2, 8)       # warm-up, timed steps
BIG_MOE_TOKENS = 32            # the full-width MoE layer, card vs CPU (f32)
BIG_MOE_GATE = 1e-4            # of max(1, max |y|), phase 3k's gate
BIG_DECODE_CHECK = (2, 6, 8)   # decode vs forward: B, S, cache length
BIG_SHARDMAP_MESH = (2, 2)
BIG_SHARDMAP_PREFILL = (2, 16)  # the expert-parallel forward's [B, S]
BIG_SHARDMAP_DECODE = 3        # its decode steps at B = 2 and at B = 1
BIG_REPLAY = "command-r-plus-104b"   # its prefill lookup is replayed (2b)
DIST_EP = 4                    # model shards of phase 3f's tile step
DIST_DATA = 2                  # data replicas of phase 3f's build
MC_PATH = ("walk_step",)       # the sparse estimators of phase 3h
MC_R = 1000                    # walks a source of phase 3h's estimators
MC_L = 8192                    # their sketch width: covers r / c = 6,667
MC_REQUESTS = 1024             # phase 3h's mcfp-mode requests, each depth
MC_R_ONLINE = 2000             # walks a request in mcfp mode
MC_LEGACY_SOURCES = 16384      # sources of phase 3h's legacy build
MC_LEGACY_R = 100
MC_LEGACY_BATCH = 256
RANDINT_SPANS = (1, 2, 3, (1 << 16) + 1, 2**31 - 1)
MAINT_PATH = SPARSE_PATH       # phase 3i: builds, repairs and serving
CKPT_EVERY = 64                # 3i(a): a commit every 64 chunks of 4,096
CKPT_CRASH_CHUNK = 160         # of 256: the resume starts at step 128
CKPT_REQUESTS = 1024           # requests to the checkpoint-booted service
UPD_R, UPD_L, UPD_C, UPD_MAX_STEPS = 16, 32, 0.25, 64  # bench_updates.py:41
UPD_SOURCE_BATCH = 1024        # 1,024 chunks at n = 2^20 (the bench: 8)
# live edge batches of 3i(b) (the bench: 8; cut to 2 in PR 29 to pay for
# 3p, to 1 in PR 30 for 3q: a run on a slow host took 1,150 s of 1,200)
UPD_BATCHES = 1
UPD_EDGES = 4                  # fresh edges a batch, the previous 4 deleted
UPD_SEED = 5                   # the bench's seed: edge pool and key
UPD_REQUESTS = 4096
LOADGEN_REQUESTS = 16384       # phase 3j: each open-loop run and the stream
LOADGEN_SEED = 3
# phase 3o: each cell 3g, 3k, 3l and 3m ran, (arch, shape) -> its batch,
# p50 ms and peak device memory (what its run allocated over what was held
# before it, plus the arguments it held then), set beside the dry-run's
# prediction for the same batch
MEASURED = {}


def measured(arch, shape, batch, ms, peak_above):
    MEASURED[(arch, shape)] = dict(batch=int(batch), ms=float(ms),
                                   peak=int(peak_above))


def card_name_and_power_limit():
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(torch, fn, budget_ms=300.0, max_reps=50):
    """Mean milliseconds of ``fn`` on the current stream (CUDA events,
    after one warm-up call; the repetition count fills ``budget_ms``)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    reps = max(1, min(max_reps, int(budget_ms / once)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def warm_profile(torch):
    """``torch.profiler`` over CPU and CUDA activity, recording only after a
    warm-up step of a few small kernels, which the trace does not hold.
    Traces opened cold late in this script dropped the first launches made
    in them (3 of 20 or 50 back-to-back ``embedding_bag`` launches on an
    H100), so a forward whose first kernel is its only lookup (MIND's)
    showed none.  The step's own span (``ProfilerStep*``) is not a kernel:
    readers of the trace skip it (``traced_kernel``)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        x = torch.zeros(1024, device="cuda")
        for _ in range(8):
            x.add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        yield prof


def traced_kernel(e):
    """Whether a ``key_averages()`` entry is device work of the trace."""
    return (str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep"))


def device_time_split(torch, fn, top=8):
    """Device time of one call of ``fn`` by kernel name (``torch.profiler``
    over CPU and CUDA activity): ``(wall_ms, device_ms, [(name, ms), ...])``
    with the ``top`` kernels by time (all with ``top=None``), or
    ``device_ms`` 0.0 where the trace shows no device time.  The wall time includes the profiler's own
    overhead."""
    with warm_profile(torch) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages() if traced_kernel(e)]
    kernels.sort(key=lambda x: -x[1])
    return wall_ms, sum(ms for _, ms in kernels), kernels[:top]


def batch_profile(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: wall and device-busy
    milliseconds, the device's idle share of the wall, and the trace's
    device activities (kernels, memcpys, memsets) by kind and count."""
    with warm_profile(torch) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = dict(wall_ms=wall_ms, device_ms=0.0, kernels=0, memcpys=0,
               memsets=0)
    for e in prof.key_averages():
        if not traced_kernel(e):
            continue
        out["device_ms"] += e.self_device_time_total / 1e3
        kind = ("memcpys" if e.key.startswith("Memcpy") else "memsets"
                if e.key.startswith("Memset") else "kernels")
        out[kind] += e.count
    out["idle_share"] = 1.0 - out["device_ms"] / wall_ms
    return out


def eager_async(eng):
    """``eng.query_topk_async`` without its graphs: the private eager query
    (the body every graph records) on the same inputs, for the A/B."""
    def query(sources, *, key=None, weights=None, out=None):
        return eng._query_eager(sources, weights,
                                eng._base_key if key is None else key)
    return query


def host_split(torch, np, svc, verts, captured):
    """One batch of ``verts`` through ``svc``'s engine in the pipeline's
    stages, each ending in a synchronize: ``[(stage, host_ms, wall_ms)]``,
    ``host_ms`` until the stage's calls return, ``wall_ms`` until the card
    has finished them too.  First the closed loop's client work (a submit
    and a poll a request, nothing in flight); then, eager: drain and pad,
    the pinned copy of the
    inputs, the route's steps (the ``t`` pushes and the combine, or the
    walks), the result copies and the event; captured: drain and pad, the
    copy into the graph's static inputs, the replay, the result copies
    and the event."""
    from repro_torch.core import verd as verd_mod
    from repro_torch.core import walks
    from repro_torch.core.frontier import topk_dense
    from repro_torch.core.query import MCFP_MAX_STEPS, normalize_seed_weights

    eng = svc.engine
    cfg = eng.config
    g = eng.graph
    k = eng.effective_top_k
    st = {}
    torch.cuda.synchronize()

    def submits():
        for v in verts[:-1]:
            svc.submit(int(v))
            svc.poll()
        svc.submit(int(verts[-1]))

    def drain():
        requests, padded = svc.buffer.drain()
        st["verts"], st["weights"] = svc.pipeline._batch_arrays(requests,
                                                                padded)
        st["key"] = eng.dispatch_key(0) if eng.uses_key else None

    def h2d():
        st["src"], st["w"] = eng._inputs_raw(st["verts"], st["weights"])
        st["words"] = (walks.step_key_words(st["key"], MCFP_MAX_STEPS,
                                            eng.device)
                       if eng.uses_key else None)

    def static_inputs():
        shape = ((len(st["verts"]),), None)
        cap = eng.graphs[shape]
        st["cap"] = cap
        eng._write((cap.sources, cap.weights, cap.words), (
            eng._host_tensor(st["verts"], torch.int32), None,
            walks.host_step_key_words(st["key"], MCFP_MAX_STEPS).pin_memory()
            if eng.uses_key else None))

    def replay():
        st["vals"], st["idx"] = st["cap"].replay()

    def pushes():
        seed_w = (None if st["w"] is None
                  else normalize_seed_weights(st["w"]))
        st["s"], st["f"] = verd_mod.verd_iterate_sparse(
            g, st["src"], seed_w, t=cfg.t_iterations, k=eng.frontier_k,
            c=cfg.c, threshold=cfg.threshold, degree_cap=eng.degree_cap(),
            hub_split_degree=cfg.hub_split_degree)

    def combine():
        if eng.uses_scatter_combine(len(st["verts"])):
            st["vals"], st["idx"] = verd_mod.combine_with_index_scatter(
                st["s"], st["f"], eng.index, out_k=k)
        else:
            sf = verd_mod.combine_with_index_sparse(st["s"], st["f"],
                                                    eng.index, out_k=k)
            st["vals"], st["idx"] = sf.values, sf.indices

    def dense_pushes():
        st["s"], st["f"] = verd_mod.verd_iterate(
            g, st["src"], None, t=cfg.t_iterations, c=cfg.c,
            threshold=cfg.threshold)

    def dense_combine():
        st["dense"] = verd_mod.combine_with_index(st["s"], st["f"], eng.index)

    def walk():
        from repro_torch.core import mcfp

        st["dense"] = mcfp.estimate_ppr(g, st["src"], cfg.r_online, None,
                                        c=cfg.c, max_steps=MCFP_MAX_STEPS,
                                        words=st["words"])

    def top_k():
        st["vals"], st["idx"] = topk_dense(st["dense"], k)

    def results():
        hv = torch.empty(st["vals"].shape, dtype=torch.float32,
                         pin_memory=True).copy_(st["vals"], non_blocking=True)
        hi = torch.empty(st["idx"].shape, dtype=torch.int32,
                         pin_memory=True).copy_(st["idx"], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        st["answer"] = (hv, hi)

    if captured:
        stages = [("drain and pad", drain),
                  ("inputs into the graph's static inputs", static_inputs),
                  ("graph replay", replay)]
    elif cfg.mode == "mcfp":
        stages = [("drain and pad", drain),
                  ("key words and pinned copy of the sources", h2d),
                  ("walks (estimate_ppr)", walk), ("top-k", top_k)]
    elif eng.uses_sparse_path():
        stages = [("drain and pad", drain),
                  ("pinned copy of the sources", h2d),
                  (f"{cfg.t_iterations} pushes (sparse_push_compact)", pushes),
                  ("combine", combine)]
    else:
        stages = [("drain and pad", drain),
                  ("pinned copy of the sources", h2d),
                  (f"{cfg.t_iterations} pushes (ell_spmm)", dense_pushes),
                  ("combine (index_combine)", dense_combine),
                  ("top-k", top_k)]
    stages.insert(0, (f"{len(verts)} submits and polls (the closed loop's "
                      f"client)", submits))
    stages.append(("result copies and the event", results))
    out = []
    for name, fn in stages:
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.append((name, (t1 - t0) * 1e3, (t2 - t0) * 1e3))
    return out, st["answer"]


SERVE_KEYS = ("served", "batches", "wall_s", "qps", "qps_excl_first_batch",
              "latency_p50",
              "latency_p99", "first_batch_service_s", "pad_fraction",
              "combine_path", "pipeline_in_flight_peak", "batch_hist",
              "graphs_captured", "capture_s", "pipeline_buffers_allocated",
              "pipeline_buffers_reused")


def captured_vs_eager(torch, np, make_service, work, label, failures,
                      depth1_requests):
    """The A/B of a route: ``make_service(depth)`` serves ``work`` closed
    loop through its graphs and through the eager query (depth 4), then
    through its graphs at depth 1 (the first ``depth1_requests``), each
    service after one warm-up batch and ``reset_stats``; prints
    each run's numbers, the host split of one batch of 256 both ways, the
    trace of one such batch both ways (idle share, kernels and memcpys)
    and the graphs' capture seconds and pool bytes.  Fails unless every
    answer is the same bytes in every run.  Returns the captured run's
    ``(answers, stats, service)``."""
    runs = {}
    kept = None
    for name, depth, eager, n_req in (
            ("captured, depth 4", 4, False, len(work)),
            ("eager, depth 4", 4, True, len(work)),
            ("captured, depth 1", 1, False, depth1_requests)):
        svc = make_service(depth)
        if eager:
            svc.engine.query_topk_async = eager_async(svc.engine)
        # one batch first (the capture; the eager path's allocations),
        # then the counters zeroed: both sides measured in steady state
        svc.run_closed_loop(work[:256])
        svc.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        answers, st = svc.run_closed_loop(work[:n_req])
        torch.cuda.synchronize()
        st["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        runs[name] = (answers, st)
        print(f"  {label} {name}: " + json.dumps(
            {k: st[k] for k in SERVE_KEYS + ("peak_gib",)}))
        if name == "captured, depth 4":
            eng = svc.engine
            print(f"  {label} graphs: {len(eng.graphs)} captured in "
                  f"{eng.capture_s:.3f} s, pool "
                  f"{eng.graph_pool_bytes()} bytes; launches a replay: "
                  + json.dumps({f"{k[0]}": dict(c.launches)
                                for k, c in eng.graphs.items()}))
            kept = svc
        del svc
        torch.cuda.empty_cache()
    base = served_bytes(runs["captured, depth 4"][0])
    for name, (answers, _) in runs.items():
        got = served_bytes(answers)
        same = all(got[v][:2] == base[v][:2] for v in got)
        print(f"  {label} {name}: answers the same bytes as captured at "
              f"depth 4: {same}")
        if not same or len(answers) != (depth1_requests
                                        if name.endswith("1")
                                        else len(work)):
            failures.append(f"{label} {name}: answers differ or missing")
    # one batch of 256, both ways: the host split and the trace
    svc = kept
    verts = work[:256]
    split_e, ans_e = host_split(torch, np, svc, verts, captured=False)
    split_c, ans_c = host_split(torch, np, svc, verts, captured=True)
    if not all(bits_equal(torch, a, b) for a, b in zip(ans_e, ans_c)):
        failures.append(f"{label}: host-split batch differs eager vs "
                        f"captured")
    eng = svc.engine
    src = np.asarray(verts, np.int32)
    key = eng.dispatch_key(0) if eng.uses_key else None
    for name, split, fn in (("eager", split_e, eager_async(eng)),
                            ("captured", split_c, eng.query_topk_async)):
        print(f"  {label} host split of a batch of 256, {name} "
              f"(host ms until the calls return / wall ms until the card "
              f"is done): total {sum(x[1] for x in split):.3f} / "
              f"{sum(x[2] for x in split):.3f}")
        for stage, host_ms, wall_ms in split:
            print(f"    {host_ms:9.3f} / {wall_ms:9.3f} ms  {stage}")
        prof = batch_profile(torch, lambda: fn(src, key=key))
        # the dispatch's untraced wall, drain to event (the profiler
        # slows the host): the device's idle share of it
        wall = sum(x[2] for x in split[1:])
        prof["idle_share_untraced"] = 1.0 - prof["device_ms"] / wall
        print(f"  {label} one batch of 256, {name}, traced: " + json.dumps(
            prof))
    return runs["captured, depth 4"] + (kept,)


def traced_kernels(torch, fn, name):
    """``[(kernel, traced ms, launches)]`` of the kernels whose name holds
    ``name`` over one call of ``fn`` under ``torch.profiler``."""
    with warm_profile(torch) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if traced_kernel(e) and name in e.key]


def traced_launch_ms(torch, fn, name):
    """Device milliseconds a wrapper call of the kernels whose name holds
    ``name``, over one call of ``fn`` under ``torch.profiler``: their
    traced time over the calls the trace holds (the launches of the most
    launched kernel: ``embedding_bag_backward`` launches two, its pre-pass
    and its tiles, a call; a trace may hold fewer launches than were made,
    or none), and that count; ``(None, 0)`` where it holds none."""
    hits = traced_kernels(torch, fn, name)
    count = max((n for _, _, n in hits), default=0)
    if not count:
        return None, 0
    return sum(ms for _, ms, _ in hits) / count, count


def bits_equal(torch, a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


# -- phase 2a: synthetic inputs with exact sums -------------------------------

def dyadic(np_rng, shape, top=1024, zero_frac=0.0):
    """Masses ``j / 1024`` (``j < top``) with a share of exact zeros."""
    import numpy as np

    v = np_rng.integers(1, top, shape).astype(np.float32) / 1024.0
    v[np_rng.random(shape) < zero_frac] = 0.0
    return v


def synthetic_walk_step(torch, np, dev):
    """Random walks on an ER graph with a few dangling vertices, with one
    source per walk and with one per row of walks."""
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import walk_step as walk_k

    r = np.random.default_rng(7)
    g = synthetic.erdos_renyi(1 << 16, 6.0, seed=1, device=dev)
    rows, w = 1024, 1024
    cur = torch.from_numpy(r.integers(0, g.n, (rows, w)).astype(np.int32))
    u = r.random((rows, w)).astype(np.float32)
    u[0, :16] = np.float32(1.0) - np.float32(2.0 ** -24)  # clip at deg - 1
    cur, u = cur.to(dev), torch.from_numpy(u).to(dev)
    ok = True
    for shape in ((rows, w), (rows,)):
        src = torch.from_numpy(
            r.integers(0, g.n, shape).astype(np.int32)).to(dev)
        args = (cur, src, u, g.row_ptr, g.out_deg, g.col_idx)
        ok &= bits_equal(torch, walk_k.walk_step_cuda(*args),
                         walk_k.walk_step_plain(*args))
    return ok


def synthetic_frontier_push(torch, np, dev):
    """Power-of-two degrees (hubs of 4096 edges, beyond the kernel's
    shared-memory width), multi-edges and dangling vertices; one-shot and
    streamed folds, ranked by radix select and by full sorts."""
    from repro_torch.core import frontier as F
    from repro_torch.core import verd as verd_mod
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import frontier_push as push_k

    r = np.random.default_rng(8)
    n = 8192
    degs = r.choice([0, 1, 2, 4, 8, 16, 32], n).astype(np.int64)
    degs[r.choice(n, 6, replace=False)] = 4096
    srcs = np.repeat(np.arange(n), degs)
    dsts = r.integers(0, n, srcs.shape[0])
    gp = Graph.from_edges(srcs, dsts, n=n, device=dev)
    cap = int(degs.max())
    q, k = 64, 32
    hubs = np.nonzero(degs == 4096)[0]
    fi_np = r.integers(0, n, (q, k)).astype(np.int32)
    fi_np[:, :2] = r.choice(hubs, (q, 2))
    fv = torch.from_numpy(dyadic(r, (q, k), zero_frac=0.2)).to(dev)
    fi = torch.from_numpy(fi_np).to(dev)
    sources = torch.from_numpy(r.integers(0, n, q).astype(np.int32)).to(dev)
    c = 0.5
    deg = gp.out_deg[fi.long()]
    dm = torch.where(deg == 0, fv, 0.0).sum(dim=1)
    dang_v, dang_i = verd_mod.dangling_seed_candidates(dm, sources, None, c=c)
    cases = []
    for k_out in (64, 2048, 4096):
        cases.append((k, dang_v, dang_i, k_out, False))        # one-shot
        run_v, run_i = F.topk_compact(dang_v, dang_i, k_out)
        cases.append((4, run_v, run_i, k_out, True))           # streamed
    ok = True
    for slots, rv, ri, k_out, run_first in cases:
        kw = dict(c=c, degree_cap=cap, hub_split_degree=0, slots=slots,
                  k_out=k_out, run_first=run_first)
        args = (fv, fi, rv.contiguous(), ri.contiguous(), gp.row_ptr,
                gp.out_deg, gp.col_idx)
        a = push_k.frontier_push_cuda(*args, **kw)
        b = push_k.frontier_push_plain(*args, **kw)
        ok &= bits_equal(torch, a[0], b[0]) and bits_equal(torch, a[1], b[1])
    return ok and one_slot_frontier_push(torch, np, dev)


def one_slot_frontier_push(torch, np, dev):
    """Streamed one-slot chunks (``slots = 1``, as the plain chunk plan
    gives a hub-heavy graph) over the column-sorted view, where the kernel
    folds without sorting: hub rows of 4,096 distinct columns (beyond 2,048
    edges) and small rows, all stored out of column order; hub and small
    rows that repeat a column (the general path, between sort-free folds);
    dangling vertices and zero slots; ``k_out`` 64 (rows far wider than
    ``k_out`` plus the running state), 256, 1,024 and 2,048 (past the
    sort-free fold's width); and ``degree_cap`` 3,000 below the hubs'
    degree (their chunk is the first 3,000 edges in CSR order)."""
    from repro_torch.core import frontier as F
    from repro_torch.core import verd as verd_mod
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import frontier_push as push_k

    r = np.random.default_rng(15)
    n = 8192
    degs = r.choice([0, 1, 2, 4, 8, 16, 32], n).astype(np.int64)
    hubs = r.choice(n, 16, replace=False)
    degs[hubs] = 4096
    repeats = np.zeros(n, bool)
    repeats[r.choice(n, n // 8, replace=False)] = True
    repeats[hubs[:4]] = True
    dsts = [r.integers(0, n, d) if rep else r.permutation(n)[:d]
            for d, rep in zip(degs, repeats)]
    srcs = np.repeat(np.arange(n), degs)
    gp = Graph.from_edges(srcs, np.concatenate(dsts), n=n, device=dev)
    view = gp.col_sorted()
    q, k = 64, 32
    fi_np = r.integers(0, n, (q, k)).astype(np.int32)
    fi_np[:, :6] = r.choice(hubs, (q, 6))
    fv = torch.from_numpy(dyadic(r, (q, k), zero_frac=0.2)).to(dev)
    fi = torch.from_numpy(fi_np).to(dev)
    sources = torch.from_numpy(r.integers(0, n, q).astype(np.int32)).to(dev)
    c = 0.5
    deg = gp.out_deg[fi.long()]
    dm = torch.where(deg == 0, fv, 0.0).sum(dim=1)
    dang_v, dang_i = verd_mod.dangling_seed_candidates(dm, sources, None, c=c)
    ok = True
    for k_out, cap in ((64, 4096), (256, 4096), (1024, 4096), (2048, 4096),
                       (256, 3000)):
        run_v, run_i = F.topk_compact(dang_v, dang_i, k_out)
        kw = dict(c=c, degree_cap=cap, hub_split_degree=0, slots=1,
                  k_out=k_out, run_first=True)
        args = (fv, fi, run_v.contiguous(), run_i.contiguous(), gp.row_ptr,
                gp.out_deg, gp.col_idx)
        a = push_k.frontier_push_cuda(*args, sorted_view=view, **kw)
        b = push_k.frontier_push_plain(*args, **kw)
        ok &= bits_equal(torch, a[0], b[0]) and bits_equal(torch, a[1], b[1])
    return ok


def synthetic_index_combine(torch, np, dev):
    """Each case bit-equal to the plain version, indices included, on the
    path the wrapper picks (the hash path up to ``k_out`` 1,024, the sort
    path above it) and on the sort path forced at a narrow ``k_out``; the
    hash path's output must be the same bytes on a second launch.  Cases:
    zero-padded index rows that repeat columns, zero-mass slots, an
    all-zero frontier row, rows narrow enough for the sort path's shared
    memory and wide enough for its global scratch and radix select; the
    main path's shape (S = 257, K = L = 256) at Q = 37, not a multiple of
    its 12 parts, with a column in every live slot; every column hashing
    to one part, more than one table holds (its passes merge); ties at the
    ``k_out`` edge; ``k_out`` above a row's distinct columns; index rows of
    two units, by bulk copies (300 wide) and by 4-byte copies (301); and
    batches of ``s`` units alone beside index rows of 301 (4-byte copies
    everywhere), every column distinct, so an entry read before its copy
    lands changes the answer.  Each case lists ``(k_out, path)`` pairs,
    ``path`` None for the wrapper's pick."""
    from repro_torch.kernels import index_combine as comb_k

    r = np.random.default_rng(9)

    def index_rows(n, l, cols=None, padded=True):
        vals = dyadic(r, (n, l), top=256)
        if padded:
            vals[np.arange(l)[None, :]
                 >= r.integers(0, l + 1, n)[:, None]] = 0.0
        idx = (r.integers(0, n, (n, l)) if cols is None
               else r.choice(cols, (n, l))).astype(np.int32)
        idx[:, 1] = idx[:, 0]                     # a repeat in one round
        idx[:, 40] = idx[:, 2]                    # and across rounds
        idx[vals == 0] = 0
        return vals, idx

    def frontier(q, k, s_w, n, top=256, zero_frac=0.3, cols=None):
        pick = (lambda shape: r.integers(0, n, shape)) if cols is None else (
            lambda shape: r.choice(cols, shape))
        return (dyadic(r, (q, s_w), top=256), pick((q, s_w)).astype(np.int32),
                dyadic(r, (q, k), top=top, zero_frac=zero_frac),
                r.integers(0, n, (q, k)).astype(np.int32))

    cases = []
    # narrow rows (the sort path in shared memory), wide ones, a dead row
    vals, idx = index_rows(16384, 128)
    sv, si, fv, fi = frontier(32, 96, 16, 16384)
    fv[: 32 // 4, 8:] = 0.0
    fv[-1] = 0.0
    cases.append(("mixed", (sv, si, fv, fi, vals, idx),
                  ((50, None), (100, None), (2048, None), (4096, None),
                   (100, "sort"))))
    # the main path's shape, a column (7) in every live slot
    vals, idx = index_rows(1 << 15, 256)
    idx[:, 0], vals[:, 0] = 7, 1.0 / 64.0
    sv, si, fv, fi = frontier(37, 256, 257, 1 << 15, top=64, zero_frac=0.6)
    cases.append(("main shape", (sv, si, fv, fi, vals, idx), ((50, None),)))
    # every column in part 0: ~11k distinct a row, twice what a table holds
    parts = comb_k.combine_plan(16, 192, 128, 50).parts
    cols = np.arange(1 << 16)
    cols = cols[comb_k.hash_part(torch.from_numpy(cols), parts).numpy() == 0]
    vals, idx = index_rows(1 << 16, 128, cols, padded=False)
    sv, si, fv, fi = frontier(8, 192, 16, 1 << 16, zero_frac=0.0, cols=cols)
    cases.append(("one part", (sv, si, fv, fi, vals, idx),
                  ((50, None), (1000, None))))
    # ties: equal masses and values; one live slot (k_out above d)
    vals, idx = index_rows(4096, 64)
    vals[vals > 0] = 1.0 / 64.0
    sv, si, fv, fi = frontier(20, 64, 8, 4096)
    sv[:], fv[fv > 0] = 1.0 / 512.0, 1.0 / 8.0
    cases.append(("ties", (sv, si, fv, fi, vals, idx),
                  ((50, None), (137, None))))
    fv1 = np.zeros_like(fv)
    fv1[:, 3] = 0.25
    cases.append(("one slot", (sv, si, fv1, fi, vals, idx), ((100, None),)))
    # index rows of two units each: 300 wide (bulk copies) and 301 (rows
    # not 16-byte aligned: 4-byte copies a thread)
    for width in (300, 301):
        vals, idx = index_rows(8192, width)
        sv, si, fv, fi = frontier(9, 24, 20, 8192)
        cases.append((f"l = {width}", (sv, si, fv, fi, vals, idx),
                      ((50, None), (600, None))))
    # s of 2,100 distinct columns (9 units: two batches of s alone, then s
    # beside index rows of 301), each index row's columns distinct too and
    # none in s; k_out 1,024 takes about half of a row's positive sums, so
    # a candidate dropped or counted twice moves the answer
    n = 1 << 16
    q, s_w, k, width = 13, 2100, 24, 301
    sv = dyadic(r, (q, s_w), top=4096)
    si = np.stack([r.permutation(n // 2)[:s_w] for _ in range(q)])
    vals = dyadic(r, (n, width), top=4096)
    idx = np.stack([n // 2 + r.permutation(n // 2)[:width] for _ in range(n)])
    fv = dyadic(r, (q, k), top=64, zero_frac=0.2)
    fi = r.integers(0, n, (q, k))
    cases.append(("s batches", (sv, si.astype(np.int32), fv,
                                fi.astype(np.int32), vals,
                                idx.astype(np.int32)),
                  ((1024, None), (50, None))))

    ok = True
    for label, arrays, runs in cases:
        args = [torch.from_numpy(x).to(dev) for x in arrays]
        for k_out, path in runs:
            a = comb_k.index_combine_sparse_cuda(*args, k_out=k_out, path=path)
            b = comb_k.index_combine_sparse_plain(*args, k_out=k_out)
            same = bits_equal(torch, a[0], b[0]) and bits_equal(torch, a[1],
                                                                  b[1])
            if comb_k.combine_plan(args[0].shape[1], args[2].shape[1],
                                   args[4].shape[1], k_out,
                                   path=path).path == "hash":
                again = comb_k.index_combine_sparse_cuda(*args, k_out=k_out)
                same &= bits_equal(torch, a[0], again[0]) and bits_equal(
                    torch, a[1], again[1])
            if not same:
                print(f"  index_combine_sparse: case {label!r}, k_out "
                      f"{k_out}, path {path or 'auto'} differs")
            ok &= same
    return ok


def synthetic_ell_spmm(torch, np, dev):
    """The push over a graph's ELL view (a star's hub of 3,000 in-edges
    spanning several row blocks, a second hub, vertices without in-edges,
    padding rows) with weights ``2**-p`` in place of ``1/out_deg``, at a Q
    that is not a multiple of the kernel's 128 columns, from a frontier
    with 30% zeros, a one-hot one (a batch's first push), an all-zero one
    and one with every column live; and raw partials of random rows (one
    row per vertex, the TPU kernel's output)."""
    from repro_torch.graphs import formats
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import ell_spmm as ell_k

    r = np.random.default_rng(10)
    n = 16384
    src = [np.arange(1, 3001), r.integers(0, n, 2500),
           r.integers(0, n, 4 * n)]
    dst = [np.zeros(3000, np.int64), np.full(2500, 9000),
           r.integers(0, n, 4 * n)]
    g = Graph.from_edges(np.concatenate(src), np.concatenate(dst), n=n,
                         device=dev)
    ell = formats.to_ell_chunks(g, k=16, pad_rows_to=256)
    w = (0.5 ** torch.randint(1, 5, ell.weight.shape, device=dev)).where(
        ell.weight > 0, 0.0).to(torch.float32)
    q = 200
    one_hot = np.zeros((q, n), np.float32)              # a batch's first push
    one_hot[np.arange(q), r.integers(0, n, q)] = dyadic(r, q, top=256)
    one_hot[:3, 0] = 0.5                                # the star's hub too
    ok = True
    for f_np in (dyadic(r, (q, n), top=256, zero_frac=0.3), one_hot,
                 np.zeros((q, n), np.float32),          # nothing live
                 dyadic(r, (q, n), top=256)):           # every column live
        f = torch.from_numpy(f_np).to(dev)
        args = (f, ell.nbr, w.contiguous(), ell.row2vertex, ell.vertex_rows)
        ok &= bits_equal(
            torch, ell_k.ell_spmm_cuda(*args, rows_used=ell.rows_used),
            ell_k.ell_spmm_plain(*args, rows_used=ell.rows_used))
    rows, k, nf = 768, 32, 200
    nbr = torch.from_numpy(r.integers(0, nf, (rows, k)).astype(np.int32))
    w = torch.from_numpy(0.5 ** r.integers(1, 5, (rows, k))).float()
    f = torch.from_numpy(dyadic(r, (24, nf), top=256))
    args = [t.to(dev) for t in (f, nbr, w)]
    ident = torch.arange(rows + 1, dtype=torch.int32, device=dev)
    a = ell_k.ell_spmm_cuda(*args, ident[:-1], ident, rows_used=rows)
    return ok and bits_equal(torch, a, ell_k.ell_spmm_partial_plain(*args))


def synthetic_index_combine_dense(torch, np, dev):
    """Unaligned shapes, all-zero rows of ``f``, zero-padded index rows,
    columns outside ``[0, n)``, duplicate columns within and across index
    rows, columns of more than ``COLUMN_SEGMENT`` entries (summed in
    several tasks) and more query rows than one q tile.  Dyadic inputs:
    bit-equal to the plain version.  Non-dyadic ones, colliding in the
    same columns: two launches give the same bytes, and every column of at
    most ``COLUMN_SEGMENT`` entries is bit-equal to the plain version on
    the CPU (the same order of the same rounded products)."""
    from repro_torch.kernels import index_combine as comb_k

    r = np.random.default_rng(11)
    n, l = 4099, 61
    ok = True
    for q, exact in ((37, True), (300, True), (300, False)):
        if exact:
            vals = r.integers(0, 16, (n, l)).astype(np.float32) / 64.0
            f = dyadic(r, (q, n), top=256, zero_frac=0.5)
            s_ = dyadic(r, (q, n))
        else:
            vals = r.random((n, l)).astype(np.float32)
            vals[r.random((n, l)) < 0.2] = 0.0
            f = r.random((q, n)).astype(np.float32)
            f[r.random((q, n)) < 0.5] = 0.0
            s_ = r.random((q, n)).astype(np.float32)
        idx = r.integers(0, n, (n, l)).astype(np.int32)
        idx[vals == 0] = 0
        idx[:10] = 7                              # ten rows onto one column
        idx[10:20, : l // 2] = idx[10:20, l // 2: 2 * (l // 2)]  # repeats
        idx[100:200, :45] = 11                    # 4,500 entries: split
        if exact:                                 # sums stay exact
            vals[100:200, :45] = 1.0 / 64.0
        idx[300:310, 50:] = n + 5                 # outside [0, n)
        idx[310:320, 50:] = -3
        f[:5] = 0.0
        args = [torch.from_numpy(x).to(dev) for x in (s_, f, vals, idx)]
        a = comb_k.index_combine_cuda(*args)
        if exact:
            ok &= bits_equal(torch, a, comb_k.index_combine_plain(*args))
            continue
        ok &= bits_equal(torch, a, comb_k.index_combine_cuda(*args))
        cols = comb_k.index_columns(args[2], args[3], n)
        one_task = (cols.col_ptr[1:] - cols.col_ptr[:-1]) <= cols.seg
        want = comb_k.index_combine_plain(*(x.cpu() for x in args))
        ok &= bits_equal(torch, a[:, one_task].cpu(),
                         want[:, one_task.cpu()])
    return ok


def synthetic_sharded_frontier_push(torch, np, dev):
    """Four shards of a graph with power-of-two degrees: hubs of 4096 edges
    in every shard (a slot spanning many sub-slots, rows beyond the
    kernel's shared memory), dangling vertices and pad rows, slabs padded
    past their last edge, zero slots and empty rows; ``wire_k`` 8 (ties at
    the cut), 64 and 2048 = ``n_shard`` (owners with fewer entries)."""
    from repro_torch.core.distributed_engine import (DistConfig,
                                                     build_sharded_graph)
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import frontier_push as push_k

    r = np.random.default_rng(12)
    n, ep = 8000, 4
    ns = 2048                                   # n pads to 8192
    degs = r.choice([0, 1, 2, 4, 8, 16, 32], n).astype(np.int64)
    hubs = np.array([s * ns + j for s in range(ep) for j in (5, 9)])
    degs[hubs] = 4096
    srcs = np.repeat(np.arange(n), degs)
    g = Graph.from_edges(srcs, r.integers(0, n, srcs.shape[0]), n=n,
                         device=dev)
    cap = int(degs.max())
    slabs = build_sharded_graph(g, DistConfig(n=ep * ns, ep=ep), device=dev)
    q, k = 64, 32
    ok = True
    for s in range(ep):
        fi_np = r.integers(0, ns, (q, k)).astype(np.int32)
        fi_np[q // 2:, :2] = [5, 9]                 # hub slots, half the rows
        fi_np[:, 2] = ns - 1                        # a pad row in shard 3
        fv_np = dyadic(r, (q, k), zero_frac=0.2)
        fv_np[:4] = 0.0                             # empty rows
        fv, fi = (torch.from_numpy(x).to(dev) for x in (fv_np, fi_np))
        for wire_k in (8, 64, ns):
            kw = dict(c=0.5, degree_cap=cap, ep=ep, n_shard=ns,
                      wire_k=wire_k, hub_split_degree=64)
            args = (fv, fi, slabs.row_ptr[s], slabs.col_idx[s])
            a = push_k.sharded_frontier_push_cuda(*args, **kw)
            b = push_k.sharded_frontier_push_plain(*args, **kw)
            ok &= bits_equal(torch, a[0], b[0]) and bits_equal(torch, a[1], b[1])
    return ok and sharded_wide_rows(torch, np, dev)


def sharded_wide_rows(torch, np, dev):
    """Rows too wide for one block, on one shard of a graph with four
    owners of 32,768 columns: hubs of 16,384 edges (a tile each), twenty
    of them with the same 16,384 columns, 4,096 in every owner, so a row
    of those twenty at one mass ties at every cut; a row of 327,680
    random edges with two hubs in two slots each (duplicates across
    slots) and ~30,000 survivors per owner (more than one select round at
    ``wire_k = n_shard``); rows of 2 and 6 tiles; narrow and empty rows
    beside them; ``wire_k`` 8, 256 and ``n_shard`` (owners with fewer
    survivors than ``wire_k``)."""
    from repro_torch.core.distributed_engine import (DistConfig,
                                                     build_sharded_graph)
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import frontier_push as push_k

    r = np.random.default_rng(14)
    ep, ns = 4, 32768
    n, hub_deg = ep * ns, 16384
    degs = r.choice([0, 1, 2, 4, 8], n).astype(np.int64)
    hubs = ns + 100 + np.arange(40)                 # in shard 1
    degs[hubs] = hub_deg
    srcs = np.repeat(np.arange(n), degs)
    dsts = r.integers(0, n, srcs.shape[0])
    for h in hubs[:20]:                             # the same columns
        dsts[srcs == h] = 8 * np.arange(hub_deg)
    g = Graph.from_edges(srcs, dsts, n=n, device=dev)
    slabs = build_sharded_graph(g, DistConfig(n=n, ep=ep), device=dev)
    q, k = 8, 32
    local = hubs - ns
    fi_np = r.integers(0, ns, (q, k)).astype(np.int32)
    fv_np = dyadic(r, (q, k), zero_frac=0.2)
    fi_np[0, :20] = local[:20]                      # ties at every cut
    fv_np[0, :20], fv_np[0, 20:] = 0.5, 0.0
    fi_np[1, :20] = np.concatenate([local[20:38], local[20:22]])
    fv_np[1, :20] = dyadic(r, 20)
    fi_np[2, 5] = local[30]                         # two tiles
    fv_np[2, 5] = 0.25
    fi_np[3, 3:8] = local[21:26]                    # six tiles
    fv_np[3, 3:8] = dyadic(r, 5)
    fv_np[7] = 0.0                                  # an empty row
    fv, fi = (torch.from_numpy(x).to(dev) for x in (fv_np, fi_np))
    args = (fv, fi, slabs.row_ptr[1], slabs.col_idx[1])
    ok = True
    for wire_k in (8, 256, ns):
        kw = dict(c=0.5, degree_cap=hub_deg, ep=ep, n_shard=ns,
                  wire_k=wire_k, hub_split_degree=64)
        a = push_k.sharded_frontier_push_cuda(*args, **kw)
        b = push_k.sharded_frontier_push_plain(*args, **kw)
        ok &= bits_equal(torch, a[0], b[0]) and bits_equal(torch, a[1], b[1])
    return ok


def same_bits_or_nan(torch, a, b):
    """Bit-equal where ``b`` is not NaN, NaN where it is (the card's NaN
    payloads differ from one operation to another)."""
    nan = torch.isnan(b)
    if not torch.equal(torch.isnan(a), nan):
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return bool(torch.equal(a.view(view[a.dtype])[~nan],
                            b.view(view[b.dtype])[~nan]))


def synthetic_embedding_bag(torch, np, dev, widths=(16, 17, 32, 48, 64, 128),
                            wide=(17, 64, 128), shifted=64,
                            rows_list=(1, 31, 33, 1000, 70001), vocab=5000):
    """Bags of 1 and 32 slots over tables of D = ``widths``: 16, 32, 64
    (rows packed several to a warp instruction), 48, 128 (a warp across a
    row) and 17 (one float a lane), for 1, 31, 33, 1,000 and 70,001 bags
    (none a multiple of the kernel's chunk of 32 rows or of the smaller
    chunks of a small launch) and, one slot a bag, 1,000,003 (full chunks
    over a grid stride) at D = ``wide``; tables of D = ``shifted`` whose
    storage starts 4 or 8 bytes past an aligned address (the float and
    float2 loads at D = 64).  ``SYNTHETIC_CHECKS`` also runs it at D = 50
    alone (SASRec's width: float2 loads, a warp across a row; float loads
    4 bytes past alignment) and at D = 576 alone (smollm-135m's width:
    4.5 passes of a warp's 128 columns a row), and at the large LMs'
    widths D = 5,120, 6,144 and 12,288 up to 1,000 bags
    (``embedding_bag_large_lm``: 40, 48 and 96 passes a row; the
    1,000,003-bag case would write 49 GB).  Values ``j / 1024``
    with |x| <= 1 and masks in {0, 0.5, 1}, so every f32 sum is exact, and
    no mask (every weight one, against the plain version with no mask);
    ids from the whole table, negative ones counting from its end, and a
    few outside it (NaN rows); all three dtype contracts: f32 rows to f32,
    bf16-rounded rows to f32 (``bag_lookup`` at bf16) and to bf16
    (``lookup`` at bf16).  A second launch must give the same bytes."""
    from repro_torch.kernels import embedding_bag as bag_k

    r = np.random.default_rng(13)
    cases = [(rows, d, bag, 0) for rows in rows_list
             for d in widths for bag in (1, 32)]
    cases += [(1000003, d, 1, 0) for d in wide]
    cases += [(1000, shifted, bag, shift) for shift in (1, 2)
              for bag in (1, 32)]
    ok = True
    for rows, d, bag, shift in cases:
        flat = r.integers(-1024, 1025, vocab * d + shift).astype(
            np.float32) / 1024.0
        table = torch.from_numpy(flat).to(dev)[shift:].view(vocab, d)
        ids = r.integers(-vocab, vocab, (rows, bag)).astype(np.int32)
        if rows >= 1000:
            ids[:3, 0] = [vocab, vocab + 7, -vocab - 1]        # NaN rows
        mask = r.choice(np.float32([0.0, 0.5, 1.0]), (rows, bag))
        ids_t, mask_t = (torch.from_numpy(x).to(dev) for x in (ids, mask))
        for m in (mask_t, None):
            for row_dt, out_dt in ((torch.float32, torch.float32),
                                   (torch.bfloat16, torch.float32),
                                   (torch.bfloat16, torch.bfloat16)):
                kw = dict(row_dtype=row_dt, out_dtype=out_dt)
                a = bag_k.embedding_bag_cuda(ids_t, m, table, **kw)
                again = bag_k.embedding_bag_cuda(ids_t, m, table, **kw)
                same = (same_bits_or_nan(
                    torch, a, bag_k.embedding_bag_plain(ids_t, m, table, **kw))
                    and bits_equal(torch, a.view(torch.int16),
                                   again.view(torch.int16)))
                if not same:
                    print(f"  embedding_bag differs: {rows} bags of {bag}, "
                          f"D = {d}, table {4 * shift} B past aligned, mask "
                          f"{m is not None}, {row_dt} rows to {out_dt}")
                ok &= same
    return ok


def synthetic_embedding_bag_far_rows(torch, np, dev, d=12288,
                                     vocab=175_000):
    """``embedding_bag`` over a ``[175,000, 12,288]`` table (8.6 GB, made on
    the card): its last rows start past element 2**31, as
    command-r-plus-104b's ``[256,000, 12,288]`` table's do from row
    174,763, so their offsets need 64 bits.  4,096 one-slot bags, half of
    them from the table's last 1,000 rows, and 64 bags of 8 with a mask;
    f32 and bf16 contracts, bit-equal to the plain version."""
    from repro_torch.kernels import embedding_bag as bag_k

    gen = torch.Generator(device=dev).manual_seed(17)
    table = torch.empty((vocab, d), dtype=torch.float32, device=dev)
    for i in range(0, vocab, 25_000):               # j / 1024, |x| <= 1
        part = table[i:i + 25_000]
        part.copy_(torch.randint(-1024, 1025, part.shape, generator=gen,
                                 device=dev, dtype=torch.int32))
        part.div_(1024.0)
    assert vocab * d > 2**31
    ids = torch.randint(0, vocab, (4096, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[::2] = torch.randint(vocab - 1000, vocab, (2048, 1), generator=gen,
                             device=dev, dtype=torch.int32)
    ids[1, 0] = -1                                     # the last row
    multi = torch.randint(vocab - 1000, vocab, (64, 8), generator=gen,
                          device=dev, dtype=torch.int32)
    mask = torch.randint(0, 3, (64, 8), generator=gen, device=dev).float() / 2
    ok = True
    for i, m in ((ids, None), (multi, mask)):
        for row_dt, out_dt in ((torch.float32, torch.float32),
                               (torch.bfloat16, torch.bfloat16)):
            kw = dict(row_dtype=row_dt, out_dtype=out_dt)
            a = bag_k.embedding_bag_cuda(i, m, table, **kw)
            same = same_bits_or_nan(
                torch, a, bag_k.embedding_bag_plain(i, m, table, **kw))
            if not same:
                print(f"  embedding_bag differs past element 2**31: bags of "
                      f"{i.shape[1]}, {row_dt} rows to {out_dt}")
            ok &= same
    del table
    torch.cuda.empty_cache()
    return ok


def synthetic_embedding_bag_backward(torch, np, dev,
                                     widths=(16, 50, 64, 576)):
    """The table gradient of ``embedding_bag`` (``embedding_bag_backward``)
    at D = 16, 50, 64 and 576, bags of 1 and 8: one row hit 10,000 times
    (bags of one; 2,000 times in bags of 8), ids from the whole table,
    negative ones counting from its end and a few outside it (no
    gradient); gradients ``j / 1024`` in [-1, 1] and masks in {0, 0.5, 1},
    and no mask; f32 rows with f32 gradients, bf16 rows with f32 and with
    bf16 gradients (the bf16 runs round every partial sum).  Each launch
    writes into a NaN-filled gradient, so a row the kernel skips shows
    (:func:`backward_matches`)."""
    r = np.random.default_rng(21)
    vocab = 3000
    ok = True
    for d in widths:
        for bag, heavy in ((1, 10_000), (8, 2_000)):
            rows = 24_000 // bag
            ids = r.integers(-vocab, vocab, (rows, bag)).astype(np.int32)
            ids.flat[r.choice(ids.size, heavy, replace=False)] = 7
            ids.flat[:5] = [vocab, vocab + 3, -vocab - 1, 2**31 - 1, -2**31]
            g = r.integers(-1024, 1025, (rows, d)).astype(np.float32) / 1024.0
            mask = r.choice(np.float32([0.0, 0.5, 1.0]), (rows, bag))
            ids_t, g_t, mask_t = (torch.from_numpy(x).to(dev)
                                  for x in (ids, g, mask))
            for m in (mask_t, None):
                for row_dt, g_dt in ((torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)):
                    ok &= backward_matches(
                        torch, ids_t, m, g_t.to(g_dt), vocab, row_dt,
                        f"{rows} bags of {bag}, D = {d}, mask "
                        f"{m is not None}, {row_dt} rows, {g_dt} gradient")
    return ok


def backward_matches(torch, ids, mask, g, vocab, row_dt, label):
    """One case of ``embedding_bag_backward`` on the card: launched into a
    NaN-filled gradient through the wrapper's ``out``, bit-equal to the
    plain version (run on the CPU copies: its one pass a position in a run
    is 10,000 small launches on the card), rows no id hits +0.0 (not -0.0,
    not NaN), and a second launch into a fresh gradient the same bytes."""
    from repro_torch.kernels import embedding_bag as bag_k

    out = torch.full((vocab, g.shape[1]), float("nan"), device=g.device)
    a = bag_k.embedding_bag_backward_cuda(ids, mask, g, vocab,
                                          row_dtype=row_dt, out=out)
    again = bag_k.embedding_bag_backward_cuda(ids, mask, g, vocab,
                                              row_dtype=row_dt)
    want = bag_k.embedding_bag_backward_plain(
        ids.cpu(), None if mask is None else mask.cpu(), g.cpu(), vocab,
        row_dtype=row_dt)
    keys = bag_k.sort_slots(ids.cpu(), vocab)[0]
    untouched = ~torch.isin(torch.arange(vocab), keys)
    same = (a is out and bits_equal(torch, a.cpu(), want)
            and bits_equal(torch, a, again)
            and not bool(a[untouched.to(a.device)].view(torch.int32).any()))
    if not same:
        print(f"  embedding_bag_backward differs: {label}")
    return same


def synthetic_embedding_bag_backward_fill(torch, np, dev):
    """``embedding_bag_backward``'s fused zero fill: sparse touches (24,000
    slots into 10^6 rows: long runs of rows no id hits), the first and last
    rows untouched, a table of a prime number of rows (no multiple of any
    tile), every row touched, no live id (every id outside the table), a
    row hit 10,000 times at a tile's first row and another at the row
    before (the last of the tile before: the tile from the launch's own
    plan, ``cuda_backward_plan``), D = 17 and 50 (no 16-byte load), and a
    gradient 4 and 8 bytes past 16-byte alignment; bf16 and f32 gradients
    and rows, bags of 1 (and of 4 with a mask).  Each case as
    :func:`backward_matches` holds it."""
    from repro_torch.kernels import embedding_bag as bag_k

    r = np.random.default_rng(23)
    ok = True
    dyad = lambda n, d: r.integers(  # noqa: E731
        -1024, 1025, (n, d)).astype(np.float32) / 1024.0
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    cases.append(("sparse", r.integers(0, 10**6, (24_000, 1)), 10**6, 64,
                  None, 0))
    cases.append(("ends untouched", r.integers(1, 2999, (24_000, 1)), 3000,
                  64, None, 0))
    cases.append(("prime rows", r.integers(-100_003, 100_003, (20_000, 4)),
                  100_003, 16, "mask", 0))
    every = np.concatenate([r.permutation(3000),
                            r.integers(0, 3000, 21_000)])[:, None]
    cases.append(("every row", every, 3000, 64, None, 0))
    dead = np.where(r.random((24_000, 1)) < 0.5, 3000 + 5, -3000 - 7)
    cases.append(("no live id", dead, 3000, 64, None, 0))
    for d in (17, 50):
        cases.append((f"D = {d}", r.integers(-3000, 3000, (24_000, 1)), 3000,
                      d, None, 0))
    for shift in (4, 8):
        cases.append((f"{shift} B past aligned",
                      r.integers(0, 3000, (24_000, 1)), 3000, 64, None, shift))
    for name, ids, vocab, d, m, shift in cases:
        ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
        mask = (torch.from_numpy(r.choice(np.float32([0.0, 0.5, 1.0]),
                                          ids.shape)).to(dev)
                if m else None)
        g = torch.from_numpy(dyad(ids.shape[0], d)).to(dev)
        for row_dt, g_dt in ((f32, f32), (bf, bf)):
            gg = g.to(g_dt)
            if shift:   # a view `shift` bytes into a 16-byte aligned buffer
                k = shift // gg.element_size()
                buf = torch.empty(gg.numel() + k, dtype=g_dt, device=dev)
                buf[k:] = gg.reshape(-1)
                gg = buf[k:].view(gg.shape)
            ok &= backward_matches(torch, ids_t, mask, gg, vocab, row_dt,
                                   f"{name}, D = {d}, {g_dt} gradient")
    # hot rows at a tile's edges, from the plan the launch uses
    vocab = 5000
    for d, g_dt in ((64, bf), (16, bf), (50, f32)):
        g = torch.from_numpy(dyad(24_000, d)).to(dev).to(g_dt)
        rows = bag_k.cuda_backward_plan(g, vocab).rows_per_tile
        edge = rows * max(1, 1500 // rows)
        ids = r.integers(0, vocab, (24_000, 1))
        hot = r.choice(ids.size, 20_000, replace=False)
        ids.flat[hot[:10_000]] = edge
        ids.flat[hot[10_000:]] = edge - 1
        ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
        ok &= backward_matches(torch, ids_t, None, g, vocab, bf,
                               f"hot rows {edge - 1} and {edge}, tiles of "
                               f"{rows}, D = {d}, {g_dt} gradient")
    return ok


def synthetic_gcn_bags(torch, np, dev, widths=(1433, 602, 100, 16)):
    """The GCN's aggregation on the card (``models.gcn.segment_bags``, then
    ``ops.embedding_bag`` and ``ops.embedding_bag_backward``) at the
    widths its shapes give the kernel: d_feat 1,433 (cora, odd: one float
    a load), 602 (float2), 100 and d_hidden 16 (float4).  3,000 rows, 2,000
    of them destinations of 20,000 edges with duplicates, self loops and
    masked (zero-weight) edges, the other 1,000 of in-degree 0; weights
    ``j / 64`` and values ``j / 1024``, so every sum is exact: each launch
    bit-equal to its plain version and the forward to the float64 segment
    sum, every padding slot weight 0 at its own row, one launch a call."""
    from repro_torch.kernels import embedding_bag as bag_k
    from repro_torch.kernels import ops
    from repro_torch.models import gcn

    r = np.random.default_rng(17)
    n, m = 3000, 20000
    src = r.integers(0, n, m).astype(np.int32)
    dst = r.integers(0, 2000, m).astype(np.int32)
    src[:64], dst[:64] = 5, 5
    w = (r.integers(0, 65, m) / 64.0).astype(np.float32)
    w[r.random(m) < 0.1] = 0.0
    ids, wb = gcn.segment_bags(*(torch.from_numpy(x).to(dev)
                                 for x in (src, dst, w)), n)
    counts = torch.from_numpy(np.bincount(dst, minlength=n)).to(dev)
    pad = torch.arange(ids.shape[1], device=dev)[None, :] >= counts[:, None]
    rows = torch.arange(n, device=dev, dtype=torch.int32)[:, None]
    ok = bool((wb[pad] == 0).all()) and torch.equal(
        ids[pad], rows.expand_as(ids)[pad])
    for d in widths:
        h = torch.from_numpy(r.integers(-1024, 1025, (n, d)).astype(
            np.float32) / 1024.0).to(dev)
        g = torch.from_numpy(r.integers(-1024, 1025, (n, d)).astype(
            np.float32) / 1024.0).to(dev)
        exact = np.zeros((n, d))
        np.add.at(exact, dst, h.cpu().numpy()[src] * w[:, None])
        ops.reset_launch_counts()
        out = ops.embedding_bag(ids, wb, h)
        grad = ops.embedding_bag_backward(ids, wb, g, n)
        launched = ops.launch_counts()
        same = (bits_equal(torch, out, bag_k.embedding_bag_plain(ids, wb, h))
                and np.array_equal(out.cpu().numpy(), exact)
                and bits_equal(torch, grad, bag_k.embedding_bag_backward_plain(
                    ids, wb, g, n))
                and launched["embedding_bag"] == 1
                and launched["embedding_bag_backward"] == 1)
        if not same:
            print(f"  GCN bags differ or did not launch: D = {d}, "
                  f"{json.dumps(launched)}")
        ok &= same
    return ok


def synthetic_randint(torch, np, dev):
    """``rng.randint`` on the card against the CPU, bit-equal: spans 1, 2,
    3, 2**16 + 1 (the uint32 product wraps) and 2**31 - 1 from 0, a
    negative ``minval``, ``maxval <= minval``, and one ``maxval`` per draw
    (``max(deg, 1)`` of an rmat graph, as a walk move draws)."""
    from repro_torch import rng

    key = rng.fold_in(rng.prng_key(17), 3)
    cases = [(0, span) for span in RANDINT_SPANS] + [(-70000, 5), (9, 9),
                                                    (9, -3)]
    deg = np.random.default_rng(16).zipf(1.5, 1 << 18) % (1 << 20)
    cases.append((0, torch.clamp(torch.from_numpy(deg), min=1)))
    ok = True
    for lo, hi in cases:
        shape = (1 << 18,)
        got = rng.randint(key, shape, lo,
                          hi.to(dev) if torch.is_tensor(hi) else hi, dev)
        want = rng.randint(key, shape, lo, hi, "cpu")
        same = bool(torch.equal(got.cpu(), want))
        if not same:
            print(f"  randint [{lo}, {hi if isinstance(hi, int) else 'deg'})"
                  f" differs card vs CPU")
        ok &= same
    return ok


def synthetic_simulate_walks(torch, np, dev):
    """The dense walk engine on the card against the CPU, bit-equal in all
    four ``WalkCounts`` fields: rmat(12) (hubs, dangling vertices) with 32
    sources of 64 walks, and a graph whose last vertices are dangling (a
    move's CSR slot past the last edge)."""
    from repro_torch import rng
    from repro_torch.core.graph import Graph
    from repro_torch.core.walks import simulate_walks, walks_for_sources
    from repro_torch.graphs import synthetic

    cases = [(lambda d: synthetic.rmat(12, avg_deg=8.0, seed=5, device=d),
              np.random.default_rng(18).integers(0, 1 << 12, 32), 64),
             (lambda d: Graph.from_edges([0, 0, 1, 2, 2, 3], [1, 4, 2, 0, 5, 1],
                                         n=6, device=d), np.arange(6), 50)]
    ok = True
    for make, sources, r in cases:
        got = {}
        for d in (dev, "cpu"):
            ws, wr = walks_for_sources(
                torch.from_numpy(sources.astype(np.int32)).to(d), r)
            got[d] = simulate_walks(make(d), ws, wr, rng.prng_key(19),
                                    n_rows=len(sources))
        for field in ("fp_counts", "ep_counts", "moves", "walks"):
            ok &= bits_equal(torch, getattr(got[dev], field).cpu(),
                             getattr(got["cpu"], field))
    return ok


SYNTHETIC_CHECKS = {
    "walk_step": synthetic_walk_step,
    "frontier_push": synthetic_frontier_push,
    "index_combine_sparse": synthetic_index_combine,
    "ell_spmm": synthetic_ell_spmm,
    "index_combine": synthetic_index_combine_dense,
    "sharded_frontier_push": synthetic_sharded_frontier_push,
    "embedding_bag": synthetic_embedding_bag,
    "embedding_bag_d50": lambda torch, np, dev: synthetic_embedding_bag(
        torch, np, dev, widths=(50,), wide=(50,), shifted=50),
    "embedding_bag_d576": lambda torch, np, dev: synthetic_embedding_bag(
        torch, np, dev, widths=(576,), wide=(576,), shifted=576),
    "embedding_bag_large_lm": lambda torch, np, dev: synthetic_embedding_bag(
        torch, np, dev, widths=(5120, 6144, 12288), wide=(), shifted=6144,
        rows_list=(1, 31, 33, 1000), vocab=1000),
    "embedding_bag_far_rows": synthetic_embedding_bag_far_rows,
    "embedding_bag_backward": synthetic_embedding_bag_backward,
    "embedding_bag_backward_fill": synthetic_embedding_bag_backward_fill,
    "embedding_bag_gcn": synthetic_gcn_bags,
    "randint": synthetic_randint,
    "simulate_walks": synthetic_simulate_walks,
}


# -- phase 2b: the main path's own inputs -------------------------------------

def bytes_and_ops(torch, name, args, kwargs):
    """Least bytes the call must move (each input read once, each output
    written once, gathers counted per element this run's data touches) and
    the f32 operations it must do."""
    if name == "walk_step":
        cur, src, _, row_ptr, out_deg, _ = args
        w = cur.numel()
        live = int((out_deg[cur.long()] > 0).sum())
        # cursors, u, out_deg[cur], output + sources + row_ptr, col_idx
        return 16 * w + 4 * src.numel() + 8 * live, w
    if name == "frontier_push":
        fv, fi, run_v, _, row_ptr, out_deg, _ = args
        q, k = fv.shape
        live = fv > 0
        budget = torch.clamp(out_deg[fi.long()], max=kwargs["degree_cap"])
        edges = int(budget[live].sum())
        n_live = int(live.sum())
        nbytes = (8 * q * k + 8 * run_v.numel() + 8 * n_live + 4 * edges
                  + 8 * q * kwargs["k_out"])
        return nbytes, 2 * n_live + edges
    if name == "ell_spmm":
        f, nbr, w, r2v, vertex_rows = args
        q, n_in = f.shape
        used = kwargs["rows_used"]
        nnz = int((w[:used] != 0).sum())
        nbytes = (4 * q * n_in + 8 * used * nbr.shape[1] + 4 * used
                  + 4 * vertex_rows.numel() + 4 * q * (vertex_rows.numel() - 1))
        return nbytes, 2 * q * nnz
    if name == "index_combine":
        s_, f, vals, _ = args
        live = f != 0
        touched = live.any(dim=0)
        row_nnz = (vals != 0).sum(dim=1)
        nbytes = (8 * s_.numel() + 4 * f.numel()
                  + 8 * vals.shape[1] * int(touched.sum()))
        ops = 2 * int((live.sum(dim=0) * row_nnz).sum())
        return nbytes, ops
    if name == "embedding_bag":
        ids, mask, table = args
        d = table.shape[1]
        out_bytes = torch.empty((), dtype=kwargs["out_dtype"]).element_size()
        # ids once (4 B a slot) and the mask, where the call passes one,
        # once (4 B more), each distinct row gathered once, the output
        # written once
        slot_bytes = 4 if mask is None else 8
        distinct = int(torch.unique(ids).numel())
        return (slot_bytes * ids.numel() + 4 * d * distinct
                + out_bytes * ids.shape[0] * d), 2 * ids.numel() * d
    if name == "embedding_bag_backward":
        # ids once (4 B a slot) and the mask, where there is one (4 B
        # more), grad_out once, the whole f32 gradient written once (the
        # function's output: autograd takes it dense)
        ids, mask, g = args
        d = g.shape[1]
        return (backward_input_bytes(ids, mask, g)
                + 4 * d * kwargs["vocab"]), 2 * ids.numel() * d
    if name == "sharded_frontier_push":
        fv, fi, row_ptr, _ = args
        q, k = fv.shape
        deg = row_ptr[1:] - row_ptr[:-1]
        live = fv > 0
        budget = torch.clamp(deg[fi.long()], max=kwargs["degree_cap"])
        edges = int(budget[live].sum())
        # 4 B per real edge gathered, 8 B per slot, 8 B per output entry
        nbytes = 4 * edges + 8 * q * k + 8 * q * kwargs["ep"] * kwargs[
            "wire_k"]
        return nbytes, 2 * int(live.sum()) + edges
    sv, _, fv, _, vals, _ = args
    q, k = fv.shape
    l = vals.shape[1]
    n_live = int((fv > 0).sum())
    nbytes = 8 * sv.numel() + 8 * q * k + 8 * l * n_live + 8 * q * kwargs[
        "k_out"]
    return nbytes, 2 * l * n_live


def backward_input_bytes(ids, mask, g):
    """The bytes ``embedding_bag_backward`` must read: ids (4 B a slot),
    the mask where there is one (4 B more) and ``grad_out``, once each."""
    slot_bytes = 4 if mask is None else 8
    return slot_bytes * ids.numel() + g.numel() * g.element_size()


def backward_touched_bytes(torch, args, kwargs):
    """PR 24's bound of ``embedding_bag_backward``: its inputs once and
    only the gradient's touched rows written (the untouched rows' zeros not
    counted), to hold the kernel against its earlier share."""
    from repro_torch.kernels.embedding_bag import sort_slots

    ids, mask, g = args
    keys, _ = sort_slots(ids, kwargs["vocab"])
    touched = int(torch.unique(keys[keys < kwargs["vocab"]]).numel())
    return backward_input_bytes(ids, mask, g) + 4 * g.shape[1] * touched


def combine_counts(torch, args):
    """Per query row of a sparse combine's inputs: the live slots, the
    candidates the kernel merges (w: nonzero ``s`` entries and positive
    entries of the live slots' index rows) and the distinct columns of
    positive sum (d); max and mean of each."""
    from repro_torch.core import frontier as F
    from repro_torch.core import verd as verd_mod

    sv, si, fv, fi, vals, idx = args
    live = fv > 0
    rows = torch.clamp(fi.long(), 0, vals.shape[0] - 1)
    per_slot = (vals[rows] > 0).sum(dim=2)
    w = (sv != 0).sum(dim=1) + torch.where(live, per_slot, 0).sum(dim=1)
    cv, ci = verd_mod.gather_combine_candidates(sv, si, fv, fi, vals, idx)
    d = (F.merge_duplicates(cv, ci)[0] > 0).sum(dim=1)
    del cv, ci
    out = {}
    for key, x in (("live_slots", live.sum(dim=1)), ("w", w), ("d", d)):
        out[f"{key}_max"] = int(x.max())
        out[f"{key}_mean"] = float(x.float().mean())
    return out


def library_call(torch, name, args, kwargs):
    """One PyTorch call computing the same function as the kernel on the
    same inputs (a sparse product), or None where there is none; used only
    as a yardstick.  Its operands are built here, outside the timing."""
    if name == "ell_spmm":
        f, nbr, w, r2v, vertex_rows = args
        used = kwargs["rows_used"]
        # A0^T in CSR: row v holds v's in-edges (the ELL rows, unpadded)
        keep = w[:used] != 0
        counts = torch.zeros(vertex_rows.numel() - 1, dtype=torch.int64,
                             device=f.device).index_add_(
            0, r2v[:used].long(), keep.sum(dim=1))
        crow = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                           device=f.device)
        torch.cumsum(counts, 0, out=crow[1:])
        at = torch.sparse_csr_tensor(
            crow, nbr[:used][keep].long(), w[:used][keep],
            size=(counts.numel(), f.shape[1]))
        return lambda: torch.sparse.mm(at, f.t())
    if name == "embedding_bag":
        ids, mask, table = args
        return lambda: torch.nn.functional.embedding_bag(
            ids, table, per_sample_weights=mask, mode="sum")
    if name == "embedding_bag_backward":
        # index_add_ of each slot's f32 row gradient into a zero table (float
        # atomics: its sums' order is not fixed)
        from repro_torch.kernels.embedding_bag import sort_slots

        ids, mask, g = args
        vocab, bag = kwargs["vocab"], ids.shape[1]
        keys, order = sort_slots(ids, vocab)
        src = g.float().repeat_interleave(bag, dim=0)
        if mask is not None:
            src = src * mask.reshape(-1, 1)
        valid = keys < vocab
        idx, src = keys[valid].long(), src[order[valid]]
        return lambda: torch.zeros((vocab, g.shape[1]), dtype=torch.float32,
                                   device=g.device).index_add_(0, idx, src)
    if name == "index_combine":
        s_, f, vals, idx = args
        nv, n = f.shape[1], s_.shape[1]
        # P [nv, n] in CSR, columns sorted within each row
        col = torch.where(vals > 0, idx.long(), n)
        col, order = torch.sort(col, dim=1)
        val = torch.gather(vals, 1, order)
        keep = col < n
        crow = torch.zeros(nv + 1, dtype=torch.int64, device=f.device)
        torch.cumsum(keep.sum(dim=1), 0, out=crow[1:])
        p_csr = torch.sparse_csr_tensor(crow, col[keep], val[keep],
                                        size=(nv, n))
        return lambda: torch.addmm(s_, f, p_csr)
    return None


F32_UNIT = 2.0 ** -24           # f32 unit roundoff
F32_TINY = 2.0 ** -126          # smallest normal f32


def dense_terms(torch, name, args, kwargs, q, cols):
    """Number of nonzero f32 terms each entry ``(q, cols[j])`` of a dense
    kernel's output sums: ``s`` plus the touched index entries for the
    combine, the nonzero products of a vertex's ELL rows for the push."""
    if name == "index_combine":
        s_, f, vals, idx = args
        live = f[q].nonzero().squeeze(1)
        sub = idx[live][vals[live] != 0].long()
        sub = sub[(sub >= 0) & (sub < s_.shape[1])]
        counts = torch.bincount(sub, minlength=s_.shape[1])
        return counts[cols] + (s_[q, cols] != 0).long()
    f, nbr, w, r2v, vertex_rows = args
    used = kwargs["rows_used"]
    per_row = ((w[:used] != 0) & (f[q][nbr[:used].long()] != 0)).sum(dim=1)
    counts = torch.zeros(vertex_rows.numel() - 1, dtype=torch.int64,
                         device=f.device).index_add_(
        0, r2v[:used].long(), per_row)
    return counts[cols]


def dense_agree(torch, name, a, b, args, kwargs):
    """Gate a dense ``[Q, n]`` kernel output ``a`` against its plain version
    ``b`` when both sum the same non-negative terms in different orders:
    each row's L1 difference within 1e-5, and each entry within
    ``max(1e-5, 2 g / (1 - g)) |b| + m * 2**-126``, ``g = m u / (1 - m u)``
    for its ``m`` terms.  Two f32 sums of ``m`` non-negative terms in any
    order each lie within ``g`` of the exact sum (plus one flushed
    subnormal per term), so only an entry of many terms is allowed more
    than 1e-5 of itself, and only by what its own count of terms allows.
    Returns ``(ok, max_abs_err)``."""
    diff = (a - b).abs()
    err = float(diff.max())
    row_l1 = diff.sum(dim=1)
    over = (diff > 1e-5 * b.abs()).nonzero()
    worst_m, beyond = 0, 0
    for q in over[:, 0].unique().tolist():
        cols = over[over[:, 0] == q, 1]
        m = dense_terms(torch, name, args, kwargs, q, cols).double()
        g = m * F32_UNIT / (1.0 - m * F32_UNIT)
        allowed = (torch.clamp(2.0 * g / (1.0 - g), min=1e-5)
                   * b[q, cols].double().abs() + m * F32_TINY)
        beyond += int((diff[q, cols].double() > allowed).sum())
        worst_m = max(worst_m, int(m.max()))
    ok = bool(torch.all(row_l1 <= 1e-5)) and beyond == 0
    print(f"  {name}: max abs error {err:.3e}, max row L1 "
          f"{float(row_l1.max()):.3e}; {over.shape[0]} of {b.numel()} entries "
          f"differ by more than 1e-5 of themselves (most terms summed by one "
          f"of them: {worst_m}), {beyond} beyond their f32 order bound")
    del diff, row_l1, over
    return ok, err


def replay(torch, name, variant, args, kwargs):
    from repro_torch.kernels import ell_spmm as ell_k
    from repro_torch.kernels import embedding_bag as bag_k
    from repro_torch.kernels import frontier_push as push_k
    from repro_torch.kernels import index_combine as comb_k
    from repro_torch.kernels import walk_step as walk_k

    kernel, plain = {
        "walk_step": (walk_k.walk_step_cuda, walk_k.walk_step_plain),
        "frontier_push": (push_k.frontier_push_cuda,
                          push_k.frontier_push_plain),
        "index_combine_sparse": (comb_k.index_combine_sparse_cuda,
                                 comb_k.index_combine_sparse_plain),
        "ell_spmm": (ell_k.ell_spmm_cuda, ell_k.ell_spmm_plain),
        "index_combine": (comb_k.index_combine_cuda,
                          comb_k.index_combine_plain),
        "sharded_frontier_push": (push_k.sharded_frontier_push_cuda,
                                  push_k.sharded_frontier_push_plain),
        "embedding_bag": (bag_k.embedding_bag_cuda,
                          bag_k.embedding_bag_plain),
        "embedding_bag_backward": (bag_k.embedding_bag_backward_cuda,
                                   bag_k.embedding_bag_backward_plain),
    }[name]
    a = kernel(*args, **kwargs)
    b = plain(*args, **kwargs)
    torch.cuda.synchronize()
    if name in ("walk_step", "embedding_bag", "embedding_bag_backward"):
        ok = (same_bits_or_nan(torch, a, b) if name == "embedding_bag"
              else bits_equal(torch, a, b))
        if name == "embedding_bag_backward":   # no atomics: the same bytes
            again = bits_equal(torch, a, kernel(*args, **kwargs))
            print(f"  {name}/{variant}: a second launch gives the same "
                  f"bytes: {again}")
            ok &= again
        err = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
        agree = 1.0 if ok else float((a == b).float().mean())
    elif name in DENSE_PATH:
        ok, err = dense_agree(torch, name, a, b, args, kwargs)
        agree = 1.0
        if name == "index_combine":  # no atomics: the same bytes again
            again = bits_equal(torch, a, kernel(*args, **kwargs))
            print(f"  {name}/{variant}: a second launch gives the same "
                  f"bytes: {again}")
            ok &= again
            # the pull's work: the view's entries, those of a live vertex,
            # and the terms f[q, v] * vals[v, j] they add
            cols = kwargs["columns"]
            per_v = (args[1] != 0).sum(dim=0)
            hits = per_v[cols.ent_v.long()]
            print(f"  {name}/{variant}: f holds {int(per_v.sum())} nonzeros "
                  f"in {int((per_v > 0).sum())} live columns; the view's "
                  f"{cols.ent_v.numel()} entries, {int((hits > 0).sum())} of "
                  f"a live vertex, add {int(hits.sum())} terms")
            del per_v, hits
    else:
        # per query row (and per owner bucket of the sharded push)
        sa = torch.sort(a[0].reshape(-1, a[0].shape[-1]), dim=1).values
        sb = torch.sort(b[0].reshape(-1, b[0].shape[-1]), dim=1).values
        err = float((sa - sb).abs().max())
        rel_ok = bool(torch.all((sa - sb).abs() <= 1e-5 * sb.abs() + 1e-30))
        agree = float((a[1] == b[1]).float().mean())
        ok = rel_ok and agree >= 0.99
        if name == "index_combine_sparse":  # no atomics: the same bytes
            again = kernel(*args, **kwargs)
            same = (bits_equal(torch, a[0], again[0])
                    and bits_equal(torch, a[1], again[1]))
            print(f"  {name}/{variant}: a second launch gives the same "
                  f"bytes: {same}; per row: {json.dumps(combine_counts(torch, args))}")
            ok &= same
            del again
    if name == "ell_spmm":
        # the kernel gathers only the columns of f that hold a non-zero
        live = int((args[0] != 0).any(dim=0).sum())
        print(f"  {name}/{variant}: non-zero columns of f: {live} of "
              f"{args[0].shape[1]} ({100.0 * live / args[0].shape[1]:.3f}%), "
              f"Q = {args[0].shape[0]}")
    if name in ("frontier_push", "sharded_frontier_push"):
        # the row with the most gathered edges sets the streamed push's
        # time (one block per row) and the sharded push's widest tile sort
        fv, fi = args[0], args[1]
        deg = (args[5] if name == "frontier_push"
               else args[2][1:] - args[2][:-1])
        budget = torch.clamp(deg[fi.long()], max=kwargs["degree_cap"])
        edges = torch.where(fv > 0, budget, 0).sum(dim=1)
        print(f"  {name}/{variant}: gathered edges per row: max "
              f"{int(edges.max())}, mean {float(edges.float().mean()):.1f}")
    del a, b
    ms = cuda_ms(torch, lambda: kernel(*args, **kwargs))
    device_ms = device_source = None
    if name in ("walk_step", "embedding_bag", "embedding_bag_backward"):
        # a short launch is shorter than its wrapper's host work, so
        # cuda_ms's back-to-back calls time the host: read the kernel's own
        # time.  A trace has been seen to hold none of the launches, or
        # fewer than were made: divide by the launches it holds, try again
        # where it holds none, and report none rather than 0
        reps = 50 if ms < 1.0 else 20

        def launches():  # each output freed before the next launch
            for _ in range(reps):
                kernel(*args, **kwargs)

        for _ in range(3):
            device_ms, traced = traced_launch_ms(torch, launches, name)
            if traced:
                break
        print(f"  {name}/{variant}: {ms:.4f} ms a wrapper call back to back "
              f"(CUDA events), kernel time a launch (torch.profiler, "
              f"{traced} of {reps} launches traced): "
              + (f"{device_ms:.4f} ms" if device_ms
                 else "not measured (no launch traced)"))
        if device_ms is None and ms >= 1.0:
            # a launch of a millisecond or more outlasts its wrapper's host
            # work, so the back-to-back time is the kernel's
            device_ms, device_source = ms, "CUDA events, back to back"
        elif device_ms is not None:
            device_source = "torch.profiler"
    plain_ms = cuda_ms(torch, lambda: plain(*args, **kwargs),
                       max_reps=1 if name == "sharded_frontier_push" else 5)
    library_ms = None
    try:
        lib_fn = library_call(torch, name, args, kwargs)
        if lib_fn is not None:
            library_ms = cuda_ms(torch, lib_fn, max_reps=5)
        del lib_fn
    except (RuntimeError, NotImplementedError) as exc:
        print(f"  {name}: no library time ({type(exc).__name__}: "
              f"{str(exc).splitlines()[0][:160]})")
    nbytes, ops = bytes_and_ops(torch, name, args, kwargs)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    if device_ms:
        print(f"  {name}/{variant}: kernel {device_ms:.5f} ms a launch "
              f"({device_source}), bound {max(by_bytes, by_ops):.5f} ms: "
              f"{100 * max(by_bytes, by_ops) / device_ms:.1f}% of the bound")
    extra = {}
    if name == "embedding_bag_backward":
        extra = backward_extras(torch, variant, args, kwargs, launches,
                                device_ms)
    shape = {k: None if v is None else list(v.shape) for k, v in zip(
        ("a0", "a1", "a2", "a3"), args[:4])}
    return dict(
        ok=ok, variant=variant, max_abs_err=err, index_agreement=agree,
        ms=ms, device_ms=device_ms, device_ms_from=device_source,
        plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(by_bytes, by_ops),
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        bytes=nbytes, shapes=shape, **extra,
    )


def backward_extras(torch, variant, args, kwargs, launches, device_ms):
    """``embedding_bag_backward``'s replay beyond the common numbers: each
    of its kernels' traced time a call (the pre-pass, the tiles), a memset
    of the gradient's bytes (``Tensor.zero_``, CUDA events: the card's
    store rate on them), and PR 24's bound (touched rows only) with the
    kernel's share of it beside the share of the bound with the fill."""
    ids, _, g = args
    parts = {key: ms / max(n, 1) for key, ms, n in traced_kernels(
        torch, launches, "embedding_bag_backward")}
    sink = torch.empty((kwargs["vocab"], g.shape[1]), dtype=torch.float32,
                       device=g.device)
    memset_ms = cuda_ms(torch, sink.zero_, max_reps=20)
    del sink
    touched_ms = (backward_touched_bytes(torch, args, kwargs)
                  / HBM_BYTES_PER_S * 1e3)
    fill_ms = bytes_and_ops(torch, "embedding_bag_backward", args,
                            kwargs)[0] / HBM_BYTES_PER_S * 1e3
    print(f"  embedding_bag_backward/{variant}: {ids.numel()} slots, "
          f"vocab {kwargs['vocab']}, D = {g.shape[1]}, {g.dtype} gradient; "
          f"by kernel a call (torch.profiler): "
          + "; ".join(f"{k[:60]} {v:.5f} ms" for k, v in parts.items())
          + f"; a memset of the [vocab, D] f32 gradient {memset_ms:.5f} ms; "
          f"bound with the fill {fill_ms:.5f} ms, touched rows only "
          f"{touched_ms:.5f} ms"
          + (f": {100 * fill_ms / device_ms:.1f}% and "
             f"{100 * touched_ms / device_ms:.1f}% of the kernel's time"
             if device_ms else ""))
    return dict(bound_touched_ms=touched_ms, memset_ms=memset_ms,
                kernel_parts_ms=parts)


# -- phases 3c-3e: answer checks ---------------------------------------------

def bad_answers(np, answers, n, k=50):
    """Request ids of answers that are shed, of the wrong width, not finite,
    negative, of mass above 1 (+1e-4), or pointing outside the graph."""
    return [a.request_id for a in answers if a.rejected
            or a.top_scores.shape != (k,)
            or not np.all(np.isfinite(a.top_scores))
            or np.any(a.top_scores < 0)
            or float(a.top_scores.sum()) > 1.0 + 1e-4
            or np.any((a.top_vertices < 0) | (a.top_vertices >= n))]


def densify(torch, vals, idx, n):
    out = torch.zeros((vals.shape[0], n), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_add_(1, idx.long(), vals)


# -- phase 4: small reference check -------------------------------------------

def densified_l1(np, a, b, n):
    """Max over rows of the L1 distance of two top-k answers, densified."""
    rows = []
    for v, i in (a, b):
        v, i = v.cpu().numpy(), i.cpu().numpy()
        row = np.zeros((v.shape[0], n), np.float64)
        np.add.at(row, (np.arange(v.shape[0])[:, None], i), v)
        rows.append(row)
    return float(np.abs(rows[0] - rows[1]).sum(axis=1).max())


def check_small_reference(torch, np, dev):
    """``rmat(14)`` built and served on the card and through the plain CPU
    path from one key: (index bit-equal?, max L1 of the sparse route's
    answers, of the dense route's).  The sparse rows include one with
    ``combine_path="sparse"``, whose ``query_topk_async`` (the served
    path) must launch ``index_combine_sparse`` too: by default it combines
    by the scatter at this size."""
    from repro_torch import rng
    from repro_torch.core.index import build_index
    from repro_torch.core.query import BatchQueryEngine, QueryConfig
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import ops

    graphs = {d: synthetic.rmat(14, avg_deg=10.0, seed=3, device=d)
              for d in (dev, "cpu")}
    built = {d: build_index(g, r=32, l=64, key=rng.prng_key(5),
                            source_batch=1024, device=d)[0]
             for d, g in graphs.items()}
    index_equal = (
        bits_equal(torch, built[dev].values.cpu(), built["cpu"].values)
        and bits_equal(torch, built[dev].indices.cpu(), built["cpu"].indices))
    n = graphs["cpu"].n
    sources = np.random.default_rng(11).integers(0, n, 64).astype(np.int32)
    worst = {}
    # hub splitting at 64 routes sparse; without it the hubs route dense.
    # At Q = 64 the served path's final combine is the scatter, unless
    # combine_path="sparse" sends it through index_combine_sparse
    for route, cfg in (
        ("sparse", QueryConfig(t_iterations=2, top_k=50, hub_split_degree=64)),
        ("sparse", QueryConfig(t_iterations=2, top_k=50, hub_split_degree=64,
                               combine_path="sparse")),
        ("dense", QueryConfig(t_iterations=2, top_k=50)),
        ("dense", QueryConfig(mode="verd", t_iterations=2, top_k=50)),
    ):
        engines = {d: BatchQueryEngine(graphs[d], built[d], cfg, device=d)
                   for d in (dev, "cpu")}
        if engines[dev].uses_sparse_path() != (route == "sparse"):
            raise AssertionError(f"{cfg} does not route {route}")
        ops.reset_launch_counts()
        l1 = 0.0
        for fn in ("query_topk", "query_topk_async"):
            got = [getattr(engines[d], fn)(sources) for d in (dev, "cpu")]
            l1 = max(l1, densified_l1(np, *got, n))
        combines = ops.launch_counts()["index_combine_sparse"]
        if cfg.combine_path == "sparse" and combines < 2:
            raise AssertionError(f"{cfg}: index_combine_sparse launched "
                                 f"{combines} times, want one per call")
        print(f"  small reference, {route} route, combine_path "
              f"{cfg.combine_path!r}, mode {cfg.mode!r}: max L1 {l1:.3e}, "
              f"index_combine_sparse launches {combines}")
        worst[route] = max(worst.get(route, 0.0), l1)
    return index_equal, worst["sparse"], worst["dense"]


def check_small_distributed(torch, np, dev):
    """The distributed engine at ``rmat(14)`` from one key: the sharded
    build on the card against the plain CPU path (bit-equal?), the sparse
    tile step likewise (max L1), and on the card the dense exchange
    against the sparse one at covering widths (max L1)."""
    from repro_torch import rng
    from repro_torch.core.distributed_engine import (
        DistConfig, build_sharded_graph, make_verd_tile_step)
    from repro_torch.core.index import build_index_sharded
    from repro_torch.core.verd import resolve_degree_cap
    from repro_torch.distributed import ShardMesh
    from repro_torch.graphs import synthetic

    graphs = {d: synthetic.rmat(14, avg_deg=10.0, seed=3, device=d)
              for d in (dev, "cpu")}
    built = {d: build_index_sharded(
        g, r=32, l=64, key=rng.prng_key(5),
        mesh=ShardMesh(data=2, model=2, device=d), source_batch=1024)[0]
        for d, g in graphs.items()}
    build_equal = (
        bits_equal(torch, built[dev].values.cpu(), built["cpu"].values)
        and bits_equal(torch, built[dev].indices.cpu(), built["cpu"].indices))
    n = graphs["cpu"].n
    sources = np.random.default_rng(12).integers(0, n, 32).astype(np.int32)
    cap = resolve_degree_cap(graphs["cpu"])

    def answers(d, **kw):
        cfg = DistConfig(n=n, ep=DIST_EP, q_tile=len(sources),
                         t_iterations=2, index_l=64, degree_cap=cap, **kw)
        slabs = build_sharded_graph(graphs[d], cfg, device=d)
        index = built[d]
        shape = (DIST_EP, n // DIST_EP, index.l)
        step = make_verd_tile_step(cfg, ShardMesh(1, DIST_EP, device=d))
        return step(slabs, torch.from_numpy(sources).to(d),
                    index.values.reshape(shape), index.indices.reshape(shape))

    main = dict(top_k=50, hub_split_degree=64)
    l1_sparse = densified_l1(np, answers(dev, **main),
                             answers("cpu", **main), n)
    cover = dict(top_k=n, frontier_k=n)
    l1_dense = densified_l1(np, answers(dev, exchange="dense", **cover),
                            answers(dev, **cover), n)
    return build_equal, l1_sparse, l1_dense


def tree_to(tree, dev):
    """A parameter tree (nested dicts of tensors) copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def check_small_recsys(torch, np, dev, arch):
    """A recsys model at its reduced config in f32: ``serve_p99`` and
    ``retrieval_cand`` on the card and through the plain CPU path from the
    same parameters and batch.  Returns the worst ``max |card - cpu| /
    max |cpu|`` over the two."""
    from repro_torch.launch import steps

    worst = 0.0
    for shape in ("serve_p99", "retrieval_cand"):
        cpu = steps.build(arch, shape, reduced=True, device="cpu")
        card = steps.build(arch, shape, reduced=True, device=dev)
        params = cpu.init_fn(3)
        batch = cpu.make_batch(torch.Generator().manual_seed(4))
        want = cpu.step_fn(params, batch)
        got = card.step_fn(tree_to(params, dev), tree_to(batch, dev)).cpu()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            return float("inf")
        worst = max(worst, float((got - want).abs().max())
                    / max(float(want.abs().max()), 1e-30))
    return worst


def replay_all(torch, captured, results, failures):
    """Phase 2b's replay of each captured launch (``"name/variant" ->
    (args, kwargs)``), each result appended to ``results[name]``."""
    for tag in sorted(captured):
        name, variant = tag.split("/")
        args, kwargs = captured[tag]
        res = replay(torch, name, variant, args, kwargs)
        print(f"replay {tag}:", json.dumps(res))
        if not res["ok"]:
            failures.append(f"replay {tag}")
        results.setdefault(name, []).append(res)


def rec_output_shape(arch, cfg, kind, n):
    """The serve step's output shape for ``n`` examples or candidates."""
    if kind == "rec_retrieval" or arch in ("dlrm-rm2", "dcn-v2"):
        return (n,)
    if arch == "sasrec":
        return (n, cfg.embed_dim)                  # user embeddings
    return (n, cfg.n_interests, cfg.embed_dim)     # MIND's interests


def phase_recsys(torch, np, dev, arch, plan, profiled, failures):
    """Phase 3g for one recsys model at full width on the card, with the
    launch counters zeroed just before and read just after its forwards:
    ``plan``'s forwards, ``profiled``'s forward split by kernel, peak
    memory, and a ``serve_p99`` batch in f32 card against CPU.  Then, its
    parameters still held, phase 2b's replays of ``embedding_bag`` on this
    path: at each shape's first launch (DLRM: all three shapes; the zoo:
    ``serve_bulk``), and at ``retrieval_cand``'s candidate gather (the
    first launch where a forward makes one, else the last), so each table
    is freed before the next model is built.  Returns the launch counts
    and the replays' results."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    spec = get_arch(arch)
    cfg = spec.config
    dlrm = arch == "dlrm-rm2"
    print(f"{arch} ({spec.source}): {card_name_and_power_limit()}")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    forwards = lookups = 0
    t1 = time.perf_counter()
    bundles = {name: steps.build(arch, name, device=dev) for name in plan}
    params = bundles["serve_p99"].init_fn(REC_SEED)
    table = (params["embedding"] if "embedding" in params
             else params["item_embed"])["table"]
    torch.cuda.synchronize()
    print(f"{arch}: table {list(table.shape)} "
          f"{table.numel() * table.element_size() / 1e9:.2f} GB, "
          f"{cfg.param_count()} parameters, compute bf16, params made in "
          f"{time.perf_counter() - t1:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(REC_SEED + 1)
    finite = []
    captured = {}

    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    model_peak = torch.cuda.max_memory_allocated()
    for name, (n_batches, warm, reps) in plan.items():
        # each shape's own peak, its batches included, for phase 3o
        torch.cuda.synchronize()
        shape_base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        b = bundles[name]
        kind = spec.shape(name).kind
        per_forward = ZOO_LOOKUPS[(arch, kind)]
        first_spec = next(iter(b.batch_spec.values()))
        examples = (b.batch_spec["candidates"] if "candidates" in b.batch_spec
                    else first_spec)[0][0]
        batches = [b.make_batch(gen) for _ in range(n_batches)]
        # the candidate gather is a retrieval forward's last launch
        ops.capture_first_launches(
            True, last=kind == "rec_retrieval" and per_forward > 1)
        ms = []
        for j in range(warm + reps):       # closed loop: one in flight
            ev0.record()
            out = b.step_fn(params, batches[j % n_batches])
            ev1.record()
            ev1.synchronize()
            forwards += 1
            lookups += per_forward
            if j >= warm:
                ms.append(ev0.elapsed_time(ev1))
            finite.append(bool(torch.isfinite(out).all()))
        if dlrm or name != "serve_p99":
            variant = name if dlrm else f"{arch}.{name}"
            captured[f"embedding_bag/{variant}"] = (
                ops.captured_launches()["embedding_bag/main"])
        ops.capture_first_launches(False)
        want_shape = rec_output_shape(arch, cfg, kind, examples)
        if tuple(out.shape) != want_shape:
            failures.append(f"{arch} {name}: output shape "
                            f"{tuple(out.shape)}, want {want_shape}")
        ms = np.array(ms)
        shape_peak = torch.cuda.max_memory_allocated()
        model_peak = max(model_peak, shape_peak)
        measured(arch, name, spec.shape(name).global_batch,
                 np.percentile(ms, 50),
                 shape_peak - shape_base + tree_bytes(params))
        tflops = b.model_flops_per_step / (np.median(ms) / 1e3) / 1e12
        print(f"  {name}: {reps} forwards of {examples}: p50 "
              f"{np.percentile(ms, 50):.4f} ms, p99 "
              f"{np.percentile(ms, 99):.4f} ms, mean {ms.mean():.4f} ms; "
              f"{examples / (ms.mean() / 1e3):.1f} examples/s; model "
              f"{b.model_flops_per_step / examples / 1e6:.4f} MFLOP per "
              f"example, {tflops:.3f} TFLOP/s at the median")
        if name in profiled:
            wall_ms, device_ms, split = device_time_split(
                torch, lambda: b.step_fn(params, batches[0]), top=None)
            forwards += 1
            lookups += per_forward
            bag_ms = sum(kms for kname, kms in split
                         if "embedding_bag" in kname)
            print(f"  {name}, one forward by kernel (torch.profiler): wall "
                  f"{wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
                  f"({100 * device_ms / wall_ms:.1f}% of the wall); "
                  f"embedding_bag {bag_ms:.3f} ms "
                  f"({100 * bag_ms / max(device_ms, 1e-9):.1f}%)"
                  + ("" if bag_ms else ", no launch of it in the trace"))
            for kname, kms in split[:8]:
                print(f"  {kms:9.3f} ms  "
                      f"{100 * kms / max(device_ms, 1e-9):5.1f}%  "
                      f"{kname[:110]}")
        if name != "serve_p99":
            del batches
        else:
            p99_batch = batches[0]
    del out
    peak = max(model_peak, torch.cuda.max_memory_allocated())
    print(f"  peak device memory in 3g ({arch}): {peak / 1e9:.2f} GB "
          f"({(peak - base) / 1e9:.2f} GB above the {base / 1e9:.2f} GB "
          f"held before it)")

    # the full width in f32, on the card and through the plain CPU path
    over = dict(compute_dtype=torch.float32)
    t1 = time.perf_counter()
    got = steps.build(arch, "serve_p99", device=dev,
                      config_overrides=over).step_fn(params, p99_batch)
    forwards += 1
    lookups += ZOO_LOOKUPS[(arch, "rec_serve")]
    finite.append(bool(torch.isfinite(got).all()))
    want = steps.build(arch, "serve_p99", device="cpu",
                       config_overrides=over).step_fn(
        tree_to(params, "cpu"), tree_to(p99_batch, "cpu"))
    err = float((got.cpu() - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    print(f"  full width f32, card vs CPU: max abs output difference "
          f"{err:.3e} (limit {1e-4 * scale:.3e}), "
          f"{time.perf_counter() - t1:.3f} s")
    if not err <= 1e-4 * scale:
        failures.append(f"{arch} full-width card vs CPU: {err:.3e}")
    del got, want
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"  {arch} path launches: {json.dumps(counts)} over {forwards} "
          f"forwards ({lookups} embedding_bag launches stated)")
    if counts["embedding_bag"] != lookups:
        failures.append(f"{arch} path: embedding_bag launched "
                        f"{counts['embedding_bag']} times in {forwards} "
                        f"forwards, {lookups} stated")
    if not all(finite):
        failures.append(f"{arch}: {finite.count(False)} outputs not finite")
    results = {}
    replay_all(torch, captured, results, failures)
    del params, table, p99_batch, captured
    torch.cuda.empty_cache()
    return counts, results.get("embedding_bag", [])


def print_split(label, wall_ms, device_ms, split, top=8):
    """One traced call's device time by kernel (``device_time_split``),
    with the device's idle share of the wall and ``embedding_bag``'s
    share of the busy time."""
    bag_ms = sum(ms for name, ms in split if "embedding_bag" in name)
    print(f"  {label} by kernel (torch.profiler): wall {wall_ms:.3f} ms, "
          f"device busy {device_ms:.3f} ms, idle "
          f"{100 * (1 - device_ms / wall_ms):.1f}% of the wall; "
          f"embedding_bag {bag_ms:.4f} ms "
          f"({100 * bag_ms / max(device_ms, 1e-9):.2f}%)"
          + ("" if bag_ms else ", no launch of it in the trace"))
    for name, ms in split[:top]:
        print(f"  {ms:9.3f} ms  {100 * ms / max(device_ms, 1e-9):5.1f}%  "
              f"{name[:110]}")


def fill_cache(cache, gen):
    """``cache``'s K and V filled from ``gen``, a layer at a time (no f32
    copy of the whole cache): ``N(0, 1)`` in a bf16 or f32 cache; int8
    values in [-127, 127] with bf16 scales of ``U(0.005, 0.02)`` in an
    int8 one (``kv_quant``).  No view of them outlives the call."""
    for name in ("k", "v"):
        for i in range(cache[name].shape[0]):
            if cache[name].is_floating_point():
                cache[name][i].normal_(generator=gen)
            else:
                cache[name][i].random_(-127, 128, generator=gen)
                cache[f"{name}_scale"][i].uniform_(0.005, 0.02,
                                                   generator=gen)
    return cache


def tree_bytes(tree):
    """Bytes of a parameter tree's tensors."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def check_small_lm(torch, np, dev, steps_n=8):
    """``smollm-135m``'s reduced config in f32, and with 6 heads over 2 KV
    heads (G = 3, smollm's grouping), on the card and through the plain CPU
    path from the same parameters: ``prefill_32k``'s logits, then
    ``steps_n`` ``decode_32k`` steps from empty caches, each step's logits
    and the caches after them.  Returns the worst ``max |card - cpu| /
    max |cpu|``."""
    from repro_torch.launch import steps

    worst = 0.0
    for over in ({}, dict(n_heads=6, n_kv_heads=2)):
        kw = dict(reduced=True, config_overrides=over or None)
        pre_cpu = steps.build(LM_ARCH, "prefill_32k", device="cpu", **kw)
        pre_card = steps.build(LM_ARCH, "prefill_32k", device=dev, **kw)
        dec_cpu = steps.build(LM_ARCH, "decode_32k", device="cpu", **kw)
        dec_card = steps.build(LM_ARCH, "decode_32k", device=dev, **kw)
        params = pre_cpu.init_fn(3)
        on_card = tree_to(params, dev)
        batch = pre_cpu.make_batch(torch.Generator().manual_seed(4))
        pairs = [(pre_card.step_fn(on_card, tree_to(batch, dev)),
                  pre_cpu.step_fn(params, batch))]
        c_cpu, c_card = dec_cpu.make_cache(), dec_card.make_cache()
        gen = torch.Generator().manual_seed(5)
        for _ in range(steps_n):
            tok = dec_cpu.make_batch(gen)
            want, c_cpu = dec_cpu.step_fn(params, c_cpu, tok)
            got, c_card = dec_card.step_fn(on_card, c_card, tree_to(tok, dev))
            pairs.append((got, want))
        if not int(c_card["length"]) == int(c_cpu["length"]) == steps_n:
            return float("inf")
        pairs += [(c_card[n], c_cpu[n]) for n in ("k", "v")]
        for got, want in pairs:
            got = got.cpu()
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                return float("inf")
            worst = max(worst, float((got - want).abs().max())
                        / max(float(want.abs().max()), 1e-30))
    return worst


def check_small_moe(torch, np, dev, steps_n=4):
    """The large LMs' reduced configs in f32 on the card and through the
    plain CPU path from the same parameters: ``prefill_32k``'s logits and
    ``steps_n`` ``decode_32k`` steps from empty caches (the int8 cache
    too); for the MoE archs also ``_moe_ffn`` of layer 0 on 64 tokens
    (routing, drops and queue places equal; capacity 1.0, so slots drop)
    and ``_moe_ffn_shardmap`` on a stacked 2 x 2 mesh against the CPU's.
    Returns the worst ``max |card - cpu| / max |cpu|`` (inf on a routing
    difference)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import ShardMesh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm

    worst = 0.0

    def rel(got, want):
        got = got.cpu()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            return float("inf")
        return float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)

    for arch in BIG_LMS:
        pre_cpu = steps.build(arch, "prefill_32k", reduced=True, device="cpu")
        pre_card = steps.build(arch, "prefill_32k", reduced=True, device=dev)
        params = pre_cpu.init_fn(3)
        on_card = tree_to(params, dev)
        batch = pre_cpu.make_batch(torch.Generator().manual_seed(4))
        worst = max(worst, rel(pre_card.step_fn(on_card, tree_to(batch, dev)),
                               pre_cpu.step_fn(params, batch)))
        for quant in (False, True):
            over = dict(kv_quant=quant)
            dec_cpu = steps.build(arch, "decode_32k", reduced=True,
                                  device="cpu", config_overrides=over)
            dec_card = steps.build(arch, "decode_32k", reduced=True,
                                   device=dev, config_overrides=over)
            c_cpu, c_card = dec_cpu.make_cache(), dec_card.make_cache()
            gen = torch.Generator().manual_seed(5)
            for _ in range(steps_n):
                tok = dec_cpu.make_batch(gen)
                want, c_cpu = dec_cpu.step_fn(params, c_cpu, tok)
                got, c_card = dec_card.step_fn(on_card, c_card,
                                               tree_to(tok, dev))
                worst = max(worst, rel(got, want))
        cfg = get_arch(arch).reduced
        if not cfg.moe:
            continue
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
        x = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (64, cfg.d_model)).astype(np.float32))
        lay_cpu, lay_card = moe_layer(params), moe_layer(on_card)
        r_cpu = tfm._moe_route(cfg.moe, lay_cpu["router"]["w"], x)
        r_card = tfm._moe_route(cfg.moe, lay_card["router"]["w"], x.to(dev))
        if not all(torch.equal(getattr(r_card, n).cpu(), getattr(r_cpu, n))
                   for n in ("top_e", "se", "stok", "pos", "keep")):
            return float("inf")
        worst = max(worst, rel(tfm._moe_ffn(cfg, lay_card, x.to(dev))[0],
                               tfm._moe_ffn(cfg, lay_cpu, x)[0]))
        want, _ = tfm._moe_ffn_shardmap(cfg, lay_cpu, x,
                                        ShardMesh(2, 2, device="cpu"))
        got, _ = tfm._moe_ffn_shardmap(cfg, lay_card, x.to(dev),
                                       ShardMesh(2, 2, device=dev))
        worst = max(worst, rel(got, want))
    return worst


def phase_lm(torch, np, dev, failures):
    """Phase 3k: ``smollm-135m`` at full width on the card through
    ``steps.build``, with the launch counters zeroed just before its
    forwards and steps and read just after: ``prefill_32k`` and the decode
    shapes at ``LM_BATCH``'s rows (each cut printed), each timed with CUDA
    events, one of each traced by kernel, then a prefill and
    ``LM_CHECK``'s decode steps in f32 on the card and through the plain
    CPU path.  Then, its parameters still held, phase 2b's replay of the
    prefill's token lookup.  Returns the launch counts and the replay's
    results."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm

    spec = get_arch(LM_ARCH)
    cfg = spec.config
    print(f"{LM_ARCH} ({spec.source}): {card_name_and_power_limit()}")
    if torch.backends.cuda.matmul.allow_tf32:
        failures.append("3k: TF32 is allowed in the attention's f32 products")
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    stated = 0                         # LM_LOOKUPS: one a forward or step
    finite = []
    t1 = time.perf_counter()
    prefill = steps.build(LM_ARCH, "prefill_32k", device=dev)
    params = prefill.init_fn(LM_SEED)
    torch.cuda.synchronize()
    print(f"  {cfg.param_count()} parameters, {tree_bytes(params) / 1e9:.3f} "
          f"GB in f32, made in {time.perf_counter() - t1:.3f} s; compute "
          f"bf16; {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} KV heads, ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"attention chunk {cfg.attn_chunk}")
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    captured = {}

    # -- prefill_32k -----------------------------------------------------
    (b_ref, s), _ = prefill.batch_spec["tokens"]
    b = LM_BATCH["prefill_32k"]
    chunk_gb = b_ref * cfg.n_heads * s * cfg.attn_chunk * 4 / 1e9
    print(f"  prefill_32k: B = {b}, cut from the reference's {b_ref} (one f32 "
          f"score chunk [{b_ref}, {cfg.n_kv_heads}, "
          f"{cfg.n_heads // cfg.n_kv_heads}, {s}, {cfg.attn_chunk}] is "
          f"{chunk_gb:.1f} GB at B = {b_ref}); S = {s} uncut")
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     dtype=torch.int32, device=dev)}
    flops = 2.0 * cfg.active_param_count() * b * s      # the reference's
    # the plain attention's products as run: QK and PV over every chunk
    attn_flops = 4.0 * b * cfg.n_heads * s * s * cfg.hd * cfg.n_layers
    warm, reps = LM_PREFILL_PLAN
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for j in range(warm + reps):
        ops.capture_first_launches(j == 0)
        ev0.record()
        out = prefill.step_fn(params, batch)
        ev1.record()
        ev1.synchronize()
        if j == 0:
            captured[f"embedding_bag/{LM_ARCH}.prefill_32k"] = (
                ops.captured_launches()["embedding_bag/main"])
            ops.capture_first_launches(False)
        stated += 1
        finite.append(bool(torch.isfinite(out).all()))
        if j >= warm:
            ms.append(ev0.elapsed_time(ev1))
    if tuple(out.shape) != (b, 1, cfg.vocab):
        failures.append(f"3k prefill: logits {tuple(out.shape)}")
    ms = np.array(ms)
    sec = np.median(ms) / 1e3
    measured(LM_ARCH, "prefill_32k", b, np.percentile(ms, 50),
             torch.cuda.max_memory_allocated() - base)
    print(f"  prefill_32k: {reps} forwards of [{b}, {s}]: "
          f"{', '.join(f'{x:.1f}' for x in ms)} ms; "
          f"{b * s / sec:.1f} tokens/s; model {flops / 1e12:.3f} TFLOP "
          f"(2 N B S), {flops / sec / 1e12:.3f} TFLOP/s; the plain f32 "
          f"attention's products {attn_flops / 1e12:.1f} TFLOP, "
          f"{attn_flops / sec / 1e12:.2f} TFLOP/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above "
          f"the {base / 1e9:.2f} GB held before 3k)")
    wall_ms, device_ms, split = device_time_split(
        torch, lambda: prefill.step_fn(params, batch), top=None)
    stated += 1
    print_split("prefill_32k, one forward", wall_ms, device_ms, split)
    del out, batch

    # -- decode_32k, long_500k -------------------------------------------
    warm, reps = LM_DECODE_PLAN
    for shape in ("decode_32k", "long_500k"):
        dec = steps.build(LM_ARCH, shape, device=dev)
        (b_ref, _), _ = dec.batch_spec["tokens"]
        b = LM_BATCH[shape]
        s = dec.cache_spec["k"][0][2]
        torch.cuda.synchronize()
        shape_base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        cache = fill_cache(dec.make_cache(b), gen)
        n_steps = warm + reps + 1                # the last one traced
        cache["length"].fill_(s - 1 - n_steps)
        torch.cuda.synchronize()
        cache_gb = sum(cache[n].numel() * cache[n].element_size()
                       for n in ("k", "v")) / 1e9
        print(f"  {shape}: B = {b}" + (
            f", cut from the reference's {b_ref} (its bf16 cache "
            f"{cache_gb * b_ref / b:.1f} GB)" if b != b_ref else
            " (the reference's)") + f"; S = {s} uncut; cache "
            f"{cache['k'].dtype} {cache_gb:.2f} GB, filled from a seeded "
            f"generator in {time.perf_counter() - t1:.3f} s, length "
            f"{s - 1 - n_steps}")
        toks = torch.randint(0, cfg.vocab, (n_steps, b, 1), generator=gen,
                             dtype=torch.int32, device=dev)
        ms = []
        for j in range(warm + reps):
            ev0.record()
            logits, cache = dec.step_fn(params, cache, {"tokens": toks[j]})
            ev1.record()
            ev1.synchronize()
            stated += 1
            finite.append(bool(torch.isfinite(logits).all()))
            if j >= warm:
                ms.append(ev0.elapsed_time(ev1))
        if tuple(logits.shape) != (b, 1, cfg.vocab):
            failures.append(f"3k {shape}: logits {tuple(logits.shape)}")
        ms = np.array(ms)
        state = {"cache": cache}

        def one_step():
            state["logits"], state["cache"] = dec.step_fn(
                params, state["cache"], {"tokens": toks[-1]})

        wall_ms, device_ms, split = device_time_split(torch, one_step,
                                                      top=None)
        stated += 1
        finite.append(bool(torch.isfinite(state["logits"]).all()))
        if int(state["cache"]["length"]) != s - 1:
            failures.append(f"3k {shape}: length "
                            f"{int(state['cache']['length'])}, want {s - 1}")
        p50 = np.percentile(ms, 50)
        measured(LM_ARCH, shape, b, p50, torch.cuda.max_memory_allocated()
                 - shape_base + tree_bytes(params))
        print(f"  {shape}: {reps} steps: p50 {p50:.3f} ms, p99 "
              f"{np.percentile(ms, 99):.3f} ms, mean {ms.mean():.3f} ms; "
              f"{b / (ms.mean() / 1e3):.1f} tokens/s; the cache read at "
              f"{cache_gb / (p50 / 1e3):.1f} GB/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
              f"({(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB "
              f"above 3k's start)")
        print_split(f"{shape}, one step", wall_ms, device_ms, split)
        del cache, state, logits, toks
        torch.cuda.empty_cache()

    # -- the full width in f32, card against the plain CPU path ------------
    t1 = time.perf_counter()
    b, s, n = LM_CHECK
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    over = dict(compute_dtype=torch.float32)
    host = tree_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab, (b, s + n), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    pairs = []
    for where, p in ((dev, params), ("cpu", host)):
        pre = steps.build(LM_ARCH, "prefill_32k", device=where,
                          config_overrides=over)
        dec = steps.build(LM_ARCH, "decode_32k", device=where,
                          config_overrides=over)
        outs = [pre.step_fn(p, {"tokens": toks[:, :s].to(where)})]
        cache = tfm.init_cache(f32, b, s, torch.float32, device=where)
        for j in range(n):
            logits, cache = dec.step_fn(
                p, cache, {"tokens": toks[:, s + j:s + j + 1].to(where)})
            outs.append(logits)
        pairs.append([x.cpu() for x in outs])
    stated += 1 + n
    err = max(float((g - w).abs().max()) for g, w in zip(*pairs))
    scale = max(1.0, max(float(w.abs().max()) for w in pairs[1]))
    finite += [bool(torch.isfinite(x).all()) for x in pairs[0]]
    print(f"  full width f32, B = {b}, a prefill of {s} then {n} decode steps "
          f"from an empty cache, card vs CPU: max abs logit difference "
          f"{err:.3e} (limit {1e-4 * scale:.3e}), "
          f"{time.perf_counter() - t1:.3f} s")
    if not err <= 1e-4 * scale:
        failures.append(f"3k full-width card vs CPU: {err:.3e}")
    del host, pairs

    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"  {LM_ARCH} path launches: {json.dumps(counts)} ({stated} "
          f"embedding_bag launches stated: one a forward or step)")
    if counts["embedding_bag"] != stated:
        failures.append(f"3k: embedding_bag launched "
                        f"{counts['embedding_bag']} times, {stated} stated")
    if not all(finite):
        failures.append(f"3k: {finite.count(False)} outputs not finite")
    results = {}
    replay_all(torch, captured, results, failures)
    del params, captured
    torch.cuda.empty_cache()
    return counts, results.get("embedding_bag", [])


# -- phase 3p: the four large LMs at full width ---------------------------------

def moe_layer(params, i=0):
    """Layer ``i``'s MoE parameters (router and expert stacks), views."""
    lay = params["layers"]
    return {"router": {"w": lay["router"]["w"][i]},
            **{n: lay[n][i] for n in ("w_gate", "w_up", "w_down")}}


def lm_prefill_flops(cfg, b, s):
    """The FLOPs a ``serve_prefill`` of ``[b, s]`` runs: each layer's
    projections and FFN over the ``b s`` tokens (a MoE's router, and its
    expert products over every queue's ``cap`` slots, the empty ones
    too), the plain attention's QK and PV over every chunk (the masked
    ones too), and the head at the last position only; the embedding is a
    lookup.  Returns ``(total, attention)``."""
    t, d, hd = b * s, cfg.d_model, cfg.hd
    proj = 2.0 * t * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    attn = 4.0 * b * cfg.n_heads * s * s * hd
    if cfg.moe:
        m = cfg.moe
        e_virt = m.n_experts * m.ep_split
        cap = max(int(t * m.top_k * m.ep_split * m.capacity_factor / e_virt), 1)
        ffn = (6.0 * e_virt * cap * d * (cfg.d_ff // m.ep_split)
               + 2.0 * t * d * m.n_experts)
    else:
        ffn = 6.0 * t * d * cfg.d_ff
    return (cfg.n_layers * (proj + attn + ffn) + 2.0 * b * d * cfg.vocab,
            cfg.n_layers * attn)


def big_moe_card_vs_cpu(torch, np, cfg, layer, label, failures):
    """``_moe_ffn`` of one full-width layer in f32 on ``BIG_MOE_TOKENS``
    tokens, on the card and through the CPU from the same parameters:
    routing, kept slots and queue places equal, outputs within
    ``BIG_MOE_GATE`` of max(1, max |y|)."""
    from repro_torch.models import transformer as tfm

    t1 = time.perf_counter()
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(BIG_SEED + 7).standard_normal(
        (BIG_MOE_TOKENS, cfg.d_model)).astype(np.float32))
    host = tree_to(layer, "cpu")
    outs, routes = [], []
    for p, xx in ((layer, x.to(layer["w_gate"].device)), (host, x)):
        routes.append(tfm._moe_route(f32.moe, p["router"]["w"], xx))
        outs.append(tfm._moe_ffn(f32, p, xx))
    same_route = all(torch.equal(getattr(routes[0], n).cpu(),
                                 getattr(routes[1], n))
                     for n in ("top_e", "se", "stok", "pos", "keep"))
    y_card, y_cpu = outs[0][0].cpu(), outs[1][0]
    err = float((y_card - y_cpu).abs().max())
    limit = BIG_MOE_GATE * max(1.0, float(y_cpu.abs().max()))
    aux_err = abs(float(outs[0][1]) - float(outs[1][1]))
    dropped = int((~routes[1].keep).sum())
    e = cfg.moe.n_experts * cfg.moe.ep_split
    flops = 2.0 * e * routes[1].cap * cfg.d_model * (cfg.d_ff
                                                     // cfg.moe.ep_split) * 3
    print(f"  {label}: _moe_ffn of one full-width layer in f32, "
          f"{BIG_MOE_TOKENS} tokens ({e} experts, capacity {routes[1].cap}, "
          f"{dropped} slots dropped, {flops / 1e9:.1f} GFLOP of expert "
          f"products), card vs CPU: routing and drops equal {same_route}; "
          f"max |y| difference {err:.3e} (limit {limit:.3e}); aux "
          f"difference {aux_err:.3e}; {time.perf_counter() - t1:.3f} s")
    if not same_route or not err <= limit or not aux_err <= 1e-6 * max(
            1.0, abs(float(outs[1][1]))):
        failures.append(f"3p {label}: MoE card vs CPU")
    del host


def big_decode_vs_forward(torch, np, dev, arch, cfg, params, failures):
    """The reference's ``test_moe_decode_matches_forward`` at full width:
    f32, ``capacity_factor`` 4.0 (no token drops), ``BIG_DECODE_CHECK``'s
    rows, positions and cache; token by token decode against the forward's
    logits at every position, within 5e-3 (relative and absolute)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm

    t1 = time.perf_counter()
    b, s, max_seq = BIG_DECODE_CHECK
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32, moe=(
        dataclasses.replace(cfg.moe, capacity_factor=4.0)), kv_quant=False)
    toks = torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(9)).to(dev)
    h, _ = tfm.forward(f32, params, toks)
    full = L.dense_apply(params["lm_head"], h)
    cache = tfm.init_cache(f32, b, max_seq, torch.float32, device=dev)
    outs = []
    for t in range(s):
        logits, cache = tfm.decode_step(f32, params, cache, toks[:, t:t + 1])
        outs.append(logits[:, 0])
    got = torch.stack(outs, dim=1)
    err = float(((got - full).abs() - 5e-3 * full.abs()).max())
    print(f"  {arch}: decode vs forward at full width in f32, capacity 4.0, "
          f"[{b}, {s}]: max(|decode - forward| - 5e-3 |forward|) {err:.3e} "
          f"(limit 5e-3), max |logit| {float(full.abs().max()):.3e}; "
          f"{time.perf_counter() - t1:.3f} s")
    if not err <= 5e-3:
        failures.append(f"3p {arch}: decode differs from the forward")


def big_shardmap(torch, cfg, params, failures):
    """The expert-parallel path through the model's entry points:
    ``forward`` and ``decode_step`` with ``mesh=`` a stacked
    ``BIG_SHARDMAP_MESH`` ``ShardMesh`` (``_moe_ffn_shardmap`` in the
    layer) against the same calls without it (``_moe_ffn``), on a
    one-layer full-width model in f32 at a capacity where nothing drops
    (``capacity_factor`` = experts / top_k, so a data shard's capacity is
    its token count): the forward's hidden states on ``BIG_SHARDMAP_PREFILL``
    tokens, then ``BIG_SHARDMAP_DECODE``'s steps from an empty cache at
    B = 2 (one token a data shard) and B = 1 (replicated), each within
    1e-5 of its largest value."""
    from repro_torch.distributed import ShardMesh
    from repro_torch.models import transformer as tfm

    t1 = time.perf_counter()
    moe = cfg.moe
    f32 = dataclasses.replace(cfg, n_layers=1, compute_dtype=torch.float32,
                              kv_quant=False, moe=dataclasses.replace(
                                  moe, capacity_factor=moe.n_experts
                                  / moe.top_k))
    dev = params["lm_head"]["w"].device
    mesh = ShardMesh(*BIG_SHARDMAP_MESH, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, cfg.vocab, BIG_SHARDMAP_PREFILL, generator=gen,
                         dtype=torch.int32, device=dev)
    want, _ = tfm.forward(f32, params, toks)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, _ = tfm.forward(f32, params, toks, mesh=mesh)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    errs = [float((got - want).abs().max()) / float(want.abs().max())]
    for b in (2, 1):
        steps = torch.randint(0, cfg.vocab, (BIG_SHARDMAP_DECODE, b, 1),
                              generator=gen, dtype=torch.int32, device=dev)
        caches = [tfm.init_cache(f32, b, BIG_SHARDMAP_DECODE, torch.float32,
                                 device=dev) for _ in range(2)]
        for j in range(BIG_SHARDMAP_DECODE):
            want, caches[0] = tfm.decode_step(f32, params, caches[0], steps[j])
            got, caches[1] = tfm.decode_step(f32, params, caches[1], steps[j],
                                             mesh=mesh)
            errs.append(float((got - want).abs().max())
                        / float(want.abs().max()))
    torch.cuda.synchronize()
    print(f"  expert-parallel path on a {mesh.data} x {mesh.model} stacked "
          f"ShardMesh through forward(mesh=) and decode_step(mesh=) against "
          f"the same calls without a mesh (one full-width layer of dbrx, "
          f"f32, nothing dropped): forward on {list(BIG_SHARDMAP_PREFILL)} "
          f"tokens, then {BIG_SHARDMAP_DECODE} decode steps at B = 2 and "
          f"B = 1: largest difference {max(errs):.3e} of the largest value "
          f"(limit 1e-5; the forward's {errs[0]:.3e}); the mesh forward's "
          f"peak {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
          f"model); {time.perf_counter() - t1:.3f} s")
    if not max(errs) <= 1e-5:
        failures.append("3p: the expert-parallel forward or decode differs")


def big_lm(torch, np, dev, arch, n_layers, replays, failures):
    """One large LM of phase 3p at full width with ``n_layers`` layers:
    prefill and the two decode shapes through ``steps.build``, timed; the
    MoE checks (card vs CPU, decode vs forward) on its own parameters; for
    ``BIG_REPLAY``, its prefill lookup replayed (2b, into ``replays``)
    before its table is freed; for dbrx, once the model is freed, the
    expert-parallel check on a one-layer copy of it.  The launch counters
    are zeroed just before the prefill and read just after the last decode
    step, so the checks do not count.  Returns ``(the launch counts of
    those runs, embedding_bag launches stated, outputs finite)``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map

    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.config, n_layers=n_layers)
    stated, finite = 0, []
    t1 = time.perf_counter()
    prefill = steps.build(arch, "prefill_32k", device=dev,
                          config_overrides=dict(n_layers=n_layers))
    params = prefill.init_fn(BIG_SEED)
    torch.cuda.synchronize()
    n_active = cfg.active_param_count()
    moe = (f"; MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
           f"ep_split {cfg.moe.ep_split}, capacity factor "
           f"{cfg.moe.capacity_factor}" if cfg.moe else "")
    print(f"  {arch} ({spec.source}): {n_layers} of {spec.config.n_layers} "
          f"layers at full width: d {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads, ff {cfg.d_ff}, vocab {cfg.vocab}{moe}; "
          f"{cfg.param_count()} parameters ({n_active} active a token), "
          f"{tree_bytes(params) / 1e9:.3f} GB in f32, made in "
          f"{time.perf_counter() - t1:.3f} s; compute bf16")
    gen = torch.Generator(device=dev).manual_seed(BIG_SEED + 1)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    captured = {}

    # -- prefill ---------------------------------------------------------
    b, s = BIG_PREFILL
    (b_ref, s_ref), _ = prefill.batch_spec["tokens"]
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     dtype=torch.int32, device=dev)}
    warm, reps = BIG_PREFILL_PLAN
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms, outs = [], []
    ops.reset_launch_counts()
    for j in range(warm + reps):
        ops.capture_first_launches(j == 0 and arch == BIG_REPLAY)
        ev0.record()
        out = prefill.step_fn(params, batch)
        ev1.record()
        ev1.synchronize()
        if j == 0 and arch == BIG_REPLAY:
            captured[f"embedding_bag/{arch}.prefill_32k"] = (
                ops.captured_launches()["embedding_bag/main"])
            ops.capture_first_launches(False)
        stated += 1
        finite.append(bool(torch.isfinite(out).all()))
        outs.append(out)
        if j >= warm:
            ms.append(ev0.elapsed_time(ev1))
    if tuple(out.shape) != (b, 1, cfg.vocab):
        failures.append(f"3p {arch} prefill: logits {tuple(out.shape)}")
    same = all(torch.equal(o.view(torch.int16), outs[0].view(torch.int16))
               for o in outs[1:])
    if not same:
        failures.append(f"3p {arch}: two prefills differ")
    ms = np.array(ms)
    p50 = np.percentile(ms, 50)
    nominal = 2.0 * n_active * b * s
    flops, attn = lm_prefill_flops(cfg, b, s)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {arch} prefill_32k: [{b}, {s}], cut from the reference's "
          f"[{b_ref}, {s_ref}]; {reps} forwards: p50 {p50:.3f} ms, p99 "
          f"{np.percentile(ms, 99):.3f} ms; {b * s / (p50 / 1e3):.1f} "
          f"tokens/s; executed {flops / 1e12:.3f} TFLOP (of them the plain "
          f"f32 attention's {attn / 1e12:.3f}; the head at the last "
          f"position, a MoE's empty slots counted), "
          f"{flops / (p50 / 1e3) / 1e12:.2f} TFLOP/s; nominal 2 N_active B S "
          f"{nominal / 1e12:.3f} TFLOP; peak device memory "
          f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
          f"parameters); {warm + reps} prefills the same bytes: {same}")
    del out, outs, batch

    # -- decode ----------------------------------------------------------
    warm, reps = BIG_DECODE_PLAN
    for shape, (b, s) in BIG_DECODE.items():
        published = steps.build(arch, shape, device="meta")
        quant = "k_scale" in published.cache_spec
        (b_ref, _), _ = published.batch_spec["tokens"]
        s_ref = published.cache_spec["k"][0][2]
        dec = steps.build(arch, shape, device=dev, config_overrides=dict(
            n_layers=n_layers, kv_quant=quant))
        ccfg = dataclasses.replace(cfg, kv_quant=quant)
        cache = fill_cache(tfm.init_cache(ccfg, b, s, torch.bfloat16,
                                          device=dev), gen)
        n_steps = warm + reps
        cache["length"].fill_(s - 1 - n_steps)
        toks = torch.randint(0, cfg.vocab, (n_steps, b, 1), generator=gen,
                             dtype=torch.int32, device=dev)
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for j in range(n_steps):
            ev0.record()
            logits, cache = dec.step_fn(params, cache, {"tokens": toks[j]})
            ev1.record()
            ev1.synchronize()
            stated += 1
            finite.append(bool(torch.isfinite(logits).all()))
            if j >= warm:
                ms.append(ev0.elapsed_time(ev1))
        if tuple(logits.shape) != (b, 1, cfg.vocab) or int(
                cache["length"]) != s - 1:
            failures.append(f"3p {arch} {shape}: logits "
                            f"{tuple(logits.shape)}, length "
                            f"{int(cache['length'])}")
        ms = np.array(ms)
        p50 = np.percentile(ms, 50)
        cache_gb = sum(t.numel() * t.element_size()
                       for n, t in cache.items() if n != "length") / 1e9
        print(f"  {arch} {shape}: B = {b}, cache {s} tokens ({cache['k'].dtype}"
              f", the published shape's; {cache_gb:.2f} GB), cut from "
              f"{b_ref} x {s_ref}; {reps} steps: p50 {p50:.3f} ms, p99 "
              f"{np.percentile(ms, 99):.3f} ms; {b / (p50 / 1e3):.1f} "
              f"tokens/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del cache, logits, toks
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    # -- the MoE checks --------------------------------------------------
    one = None
    if cfg.moe:
        big_moe_card_vs_cpu(torch, np, cfg, moe_layer(params), arch,
                            failures)
        if arch == "dbrx-132b":
            big_decode_vs_forward(torch, np, dev, arch, cfg, params,
                                  failures)
            one = {**params, "layers": tree_map(lambda t: t[:1].clone(),
                                                params["layers"])}
    replay_all(torch, captured, replays, failures)
    del params, captured
    torch.cuda.empty_cache()
    if one is not None:
        big_shardmap(torch, spec.config, one, failures)
        del one
        torch.cuda.empty_cache()
    return counts, stated, finite


def phase_big_lms(torch, np, dev, failures):
    """Phase 3p: ``BIG_LMS`` at full width, each with its depth cut, in
    bf16 through ``steps.build``, one after another (each freed before the
    next), the launch counts of each one's prefill and decode runs added
    up.  Returns the launch counts and the prefill lookup's replay results
    (2b)."""
    print(f"3p: {card_name_and_power_limit()}")
    counts, stated, finite, replays = {}, 0, [], {}
    for arch, n_layers in BIG_LMS.items():
        t1 = time.perf_counter()
        cts, st, fin = big_lm(torch, np, dev, arch, n_layers, replays,
                              failures)
        counts = {k: counts.get(k, 0) + v for k, v in cts.items()}
        stated += st
        finite += fin
        print(f"  {arch}: {time.perf_counter() - t1:.3f} s")
    print(f"  3p path launches: {json.dumps(counts)} ({stated} embedding_bag "
          f"launches stated: one a forward or step)")
    if counts["embedding_bag"] != stated:
        failures.append(f"3p: embedding_bag launched "
                        f"{counts['embedding_bag']} times, {stated} stated")
    if not all(finite):
        failures.append(f"3p: {finite.count(False)} outputs not finite")
    return counts, replays.get("embedding_bag", [])


# -- phase 3l: training ---------------------------------------------------------

def tree_bits_equal(torch, a, b):
    """Two trees of tensors hold the same dtypes, shapes and bytes."""
    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def train_loss_fn(arch, cfg):
    """``loss_fn(params, batch)`` of ``arch`` at config ``cfg``."""
    import functools

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.recsys import dcn, dlrm, mind, sasrec

    mod = {"transformer": transformer, "dlrm": dlrm, "dcn": dcn,
           "sasrec": sasrec, "mind": mind}[get_arch(arch).model_kind]
    return functools.partial(mod.loss_fn, cfg)


@contextlib.contextmanager
def dropped_slot(ops):
    """A control fault for phase 3l's gradient gate: within the block, the
    first launch of the lookups' backward drops one slot, the first in
    slot order whose row gradient is not zero (its id is set outside the
    table, which the kernel skips, as the reference's fill mode drops such
    an id).  Later launches are sound."""
    real = ops.embedding_bag_backward
    armed = [True]

    def faulty(ids, mask, grad_out, vocab, **kwargs):
        if armed[0]:
            armed[0] = False
            live = grad_out.float().abs().amax(dim=1)[:, None] != 0
            if mask is not None:
                live = live & (mask != 0)
            pick = int(live.expand(ids.shape).reshape(-1).nonzero()[0])
            ids = ids.contiguous().clone()
            ids.view(-1)[pick] = vocab
        return real(ids, mask, grad_out, vocab, **kwargs)

    ops.embedding_bag_backward = faulty
    try:
        yield
    finally:
        ops.embedding_bag_backward = real


@contextlib.contextmanager
def plain_kernels(ops):
    """Within the block every kernel wrapper takes its plain PyTorch
    version, on the card's tensors too (the oracle of a step too large for
    the CPU); ``embedding_bag``'s plain version holds ``[R, D]`` at a time,
    its backward's a run position's slots."""
    real = ops._route
    ops._route = lambda name, tensor: False
    try:
        yield
    finally:
        ops._route = real


def train_card_vs_cpu(torch, np, dev, arch, *, reduced, shape=None,
                      overrides=None, rows=None, seq=None, seed=3,
                      controls=False, plain_on_card=False):
    """One train step of ``arch`` (its ``shape``, ``TRAIN_CELLS``' by
    default) in f32 (``compute_dtype`` overridden) on
    the card and through the plain CPU path from the same parameters and
    batch (its first ``rows`` rows and ``seq`` positions where given),
    under the bundle's own optimizer config; with ``plain_on_card`` the
    second run is on the card too, through the kernels' plain versions
    (``plain_kernels``).  Returns the loss's relative
    difference, the worst gradient leaf's ``||card - cpu|| / ||cpu||``,
    and the parameters' largest difference beyond the tests' rule (1e-5,
    or 2 lr where the CPU gradient is below 1e-6 of its leaf's largest:
    Adam turns such an element's rounding noise into a full step).  With
    ``controls``, also the gradients' worst leaf of two card runs that are
    wrong on purpose, against the same CPU gradients: ``control_bf16``
    computes in bf16, ``control_dropped_slot`` drops one slot in the
    backward (``dropped_slot``)."""
    import dataclasses as dc

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_leaves, tree_map

    shape = shape or TRAIN_CELLS[arch]
    over = dict(compute_dtype=torch.float32, **(overrides or {}))
    spec = get_arch(arch)
    base = spec.reduced if reduced else spec.config
    cpu = steps.build(arch, shape, reduced=reduced, device="cpu",
                      config_overrides=over)
    card = steps.build(arch, shape, reduced=reduced, device=dev,
                       config_overrides=over)
    loss = cpu.loss_fn
    params = cpu.init_fn(seed)
    batch = cpu.make_batch(torch.Generator().manual_seed(seed + 1))
    if rows:
        batch = {k: v[:rows] for k, v in batch.items()}
    if seq:
        batch = {k: v[:, :seq] for k, v in batch.items()}
    wrong = {}  # the controls' gradients, taken before the CPU step below
    if controls:                          # updates params in place
        for name, how, fault in (
                ("control_bf16", dict(over, compute_dtype=torch.bfloat16),
                 contextlib.nullcontext()),
                ("control_dropped_slot", over, dropped_slot(ops))):
            with fault:
                _, _, grads = train_loop.value_and_grad(
                    train_loss_fn(arch, dc.replace(base, **how)))(
                        tree_map(lambda x: x.to(dev, copy=True), params),
                        tree_to(batch, dev))
            wrong[name] = [g.cpu() for g in tree_leaves(grads)]
            del grads
    runs = []
    on_card = tree_map(lambda x: x.to(dev, copy=True), params)  # the step
    second = (cpu, params, batch, contextlib.nullcontext())      # is in place
    if plain_on_card:
        second = (card, tree_map(lambda x: x.to(dev, copy=True), params),
                  tree_to(batch, dev), plain_kernels(ops))
    for bundle, p, b, route in ((card, on_card, tree_to(batch, dev),
                                 contextlib.nullcontext()), second):
        with route:
            value, _, grads = train_loop.value_and_grad(loss)(p, b)
            state = train_loop.init_state(bundle.opt_cfg, p)
            p, state, metrics = bundle.step_fn(p, state, b)
        runs.append((float(value), [g.cpu() for g in tree_leaves(grads)],
                     [x.cpu() for x in tree_leaves(p)],
                     float(metrics["lr"])))
        del grads, p, state, b
    (l_card, g_card, p_card, _), (l_cpu, g_cpu, p_cpu, lr) = runs

    def grad_rel(gs):
        return max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                   for a, b in zip(gs, g_cpu))

    loss_rel = abs(l_card - l_cpu) / max(abs(l_cpu), 1e-30)
    beyond = 0.0
    for a, b, g in zip(p_card, p_cpu, g_cpu):
        noisy = g.abs() < 1e-6 * float(g.abs().max())
        limit = torch.where(noisy, 1e-5 + 2 * lr, 1e-5)
        beyond = max(beyond, float(((a - b).abs() - limit).max()))
    finite = np.isfinite(l_card) and all(bool(torch.isfinite(x).all())
                                         for x in p_card)
    res = dict(loss_rel=loss_rel if finite else float("inf"),
               grad_rel=grad_rel(g_card), param_beyond=max(beyond, 0.0))
    res.update({name: grad_rel(g) for name, g in wrong.items()})
    return res


def train_cell(torch, np, dev, arch, failures):
    """One train cell of phase 3l at full width: ``TRAIN_PLAN``'s steps on
    one batch with CUDA events, one more traced by kernel (DLRM), the peak
    memory, the lookups' and their backward's launches against
    ``TRAIN_LOOKUPS``, and on DLRM the decay-only update of rows the batch
    does not touch, bit for bit.  Then, the cell's parameters freed, phase
    2b's replay of ``embedding_bag_backward``'s last launch in the warm-up
    step (the forward's first lookup: DLRM's and DCN-v2's fields, SASRec's
    ``item_seq``, MIND's history, the LM's tokens), whose inputs wait on
    the host meanwhile, so neither the timed steps nor the peak hold them.
    Returns the launch counts, the replay's results and the timed steps'
    milliseconds."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.training import train_loop

    spec = get_arch(arch)
    cfg = spec.config
    shape = TRAIN_CELLS[arch]
    kind = spec.shape(shape).kind
    lm = kind == "lm_train"
    dlrm = arch == "dlrm-rm2"
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    bundle = steps.build(arch, shape, device=dev)
    params = bundle.init_fn(TRAIN_SEED)
    state = train_loop.init_state(bundle.opt_cfg, params)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)
    opt = bundle.opt_cfg
    if lm:
        (b_ref, s), _ = bundle.batch_spec["tokens"]
        b = LM_TRAIN_BATCH
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                             dtype=torch.int32, device=dev)
        batch = dict(tokens=toks, labels=torch.roll(toks, -1, dims=1),
                     mask=torch.ones((b, s), dtype=torch.float32, device=dev))
        examples = b * s
        flops = 6.0 * cfg.active_param_count() * b * s
        cut = (f"B = {b}, cut from the reference's {b_ref} (its f32 logits "
               f"are {b_ref * s * cfg.vocab * 4 / 1e9:.0f} GB); S = {s}")
    else:
        batch = bundle.make_batch(gen)
        examples = next(iter(bundle.batch_spec.values()))[0][0]
        flops = bundle.model_flops_per_step
        cut = f"B = {examples} (the reference's)"
    torch.cuda.synchronize()
    print(f"  {arch} {shape}: {cut}; {cfg.param_count()} parameters, moments "
          f"{opt.mu_dt} / {opt.nu_dt}, warm-up {opt.warmup_steps} steps; "
          f"made in {time.perf_counter() - t1:.3f} s")
    probe = None
    if dlrm:   # rows no slot of the batch touches: their update is decay
        table = params["embedding"]["table"]
        offs = (torch.arange(cfg.n_sparse, device=dev, dtype=torch.int64)
                * cfg.vocab_per_field)
        hit = (batch["sparse_ids"].long() + offs).reshape(-1)
        probe = torch.randint(0, table.shape[0], (1 << 20,), generator=gen,
                              device=dev)
        probe = probe[~torch.isin(probe, hit)]
        before = table[probe].clone()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    warm, reps = TRAIN_PLAN
    losses, ms, stated = [], [], 0
    for j in range(warm + reps):
        ops.capture_first_launches(j == 0, last=True)
        ev0.record()
        params, state, metrics = bundle.step_fn(params, state, batch)
        ev1.record()
        ev1.synchronize()
        stated += TRAIN_LOOKUPS[(arch, kind)]
        losses.append(float(metrics["loss"]))
        if j >= warm:
            ms.append(ev0.elapsed_time(ev1))
        if j == 0:
            args, kwargs = ops.captured_launches()[
                "embedding_bag_backward/main"]
            held = (tuple(None if x is None else x.cpu() for x in args),
                    kwargs)
            ops.capture_first_launches(False)
            del args
        if dlrm and j == 0:
            # p - lr (0 + wd p), as the optimizer computes it
            lr = metrics["lr"]
            want = before - lr * (torch.zeros_like(before)
                                  + opt.weight_decay * before)
            decay_ok = bits_equal(torch, table[probe], want)
            print(f"  {arch}: {probe.numel()} rows the batch does not touch "
                  f"updated by weight decay alone, bit for bit: {decay_ok}")
            if not decay_ok:
                failures.append(f"3l {arch}: untouched rows not decay-only")
            del before, want
    peak = torch.cuda.max_memory_allocated()
    ms = np.array(ms)
    sec = np.median(ms) / 1e3
    measured(arch, shape, b if lm else examples, np.percentile(ms, 50),
             peak - base)
    print(f"  {arch}: losses {', '.join(f'{x:.6f}' for x in losses)}; "
          f"{reps} timed steps {', '.join(f'{x:.3f}' for x in ms)} ms "
          f"(p50 {np.percentile(ms, 50):.3f}); "
          + (f"{examples / sec:.1f} tokens/s; " if lm else
             f"{examples / sec:.1f} examples/s; ")
          + f"model {flops / sec / 1e12:.3f} TFLOP/s; peak device memory "
          f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
          f"{base / 1e9:.2f} GB held before)")
    if not all(np.isfinite(losses)):
        failures.append(f"3l {arch}: a loss is not finite: {losses}")
    if not losses[1] < 1.5 * losses[0]:
        failures.append(f"3l {arch}: second step's loss {losses[1]} not "
                        f"below 1.5x the first's {losses[0]}")
    if dlrm:
        wall_ms, device_ms, split = device_time_split(
            torch, lambda: bundle.step_fn(params, state, batch), top=None)
        stated += TRAIN_LOOKUPS[(arch, kind)]
        bwd = sum(x for n, x in split if "embedding_bag_backward" in n)
        fwd = sum(x for n, x in split if "embedding_bag" in n) - bwd
        print(f"  {arch}, one train step by kernel (torch.profiler): wall "
              f"{wall_ms:.3f} ms, device busy {device_ms:.3f} ms, idle "
              f"{100 * (1 - device_ms / wall_ms):.1f}%; embedding_bag "
              f"{fwd:.3f} ms, embedding_bag_backward {bwd:.3f} ms")
        for name, kms in split[:12]:
            print(f"  {kms:9.3f} ms  {100 * kms / max(device_ms, 1e-9):5.1f}%"
                  f"  {name[:110]}")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"  {arch} train path launches: {json.dumps(counts)} ({stated} "
          f"lookups and as many backward launches stated)")
    for name in TRAIN_PATH:
        if counts[name] != stated:
            failures.append(f"3l {arch}: {name} launched {counts[name]} "
                            f"times, {stated} stated")
    del params, state, batch, metrics
    torch.cuda.empty_cache()
    args, kwargs = held
    del held
    results = {}
    replay_all(torch, {f"embedding_bag_backward/{arch}.{shape}": (
        tuple(None if x is None else x.to(dev) for x in args), kwargs)},
        results, failures)
    del args
    torch.cuda.empty_cache()
    return counts, results["embedding_bag_backward"], ms.tolist()


def train_crash_resume(torch, np, dev, failures):
    """``launch/train.py``'s loop on DLRM RM2 at full widths with
    ``vocab_per_field`` at ``TRAIN_CKPT_VOCAB``: ``TRAIN_CKPT_PLAN``'s steps
    with a commit every 2 and a simulated failure, against an
    uninterrupted run with no commits; the final parameters and optimizer
    state must be the same bytes."""
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod

    n, every, fail = TRAIN_CKPT_PLAN
    bundle = steps.build("dlrm-rm2", "train_batch", device=dev,
                         config_overrides=dict(vocab_per_field=TRAIN_CKPT_VOCAB))
    root = tempfile.mkdtemp(prefix="pw_train_ckpt_")
    try:
        t1 = time.perf_counter()
        pa, sa, info = train_mod.run(
            bundle, steps=n, ckpt_dir=os.path.join(root, "a"),
            ckpt_every=every, simulate_failure=fail,
            log=lambda s: print(f"  [train] {s}"))
        crashed_s = time.perf_counter() - t1
        ck = info["ckpt"]
        sizes = {s: sum(os.path.getsize(os.path.join(ck.root, f"step_{s}", f))
                        for f in os.listdir(os.path.join(ck.root, f"step_{s}")))
                 for s in ck.all_steps()}
        t1 = time.perf_counter()
        pb, sb, _ = train_mod.run(
            bundle, steps=n, ckpt_dir=os.path.join(root, "b"),
            ckpt_every=10**9, log=lambda s: None)
        plain_s = time.perf_counter() - t1
        same = tree_bits_equal(torch, (pa, sa), (pb, sb))
        print(f"  crash and resume (DLRM RM2, vocab_per_field "
              f"{TRAIN_CKPT_VOCAB}): {n} steps, a commit every {every}, "
              f"failure at step {fail}, restored from step "
              f"{info['restored_at_failure']}; commits "
              f"{json.dumps({s: round(b / 1e9, 3) for s, b in sizes.items()})}"
              f" GB; {crashed_s:.3f} s against {plain_s:.3f} s uninterrupted;"
              f" final parameters and optimizer state bit-equal: {same}")
        if not same or info["restored_at_failure"] != fail:
            failures.append("3l: the resumed training run differs from the "
                            "uninterrupted one")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_train(torch, np, dev, failures):
    """Phase 3l: every train cell at full width (``train_cell``, which
    replays its backward as phase 2b, at the cell's own ids and gradient),
    each counted from zero; one step of each architecture card against CPU
    at full widths (``train_card_vs_cpu``, the cuts of ``TRAIN_CHECK_*``);
    ``launch/train.py``'s crash and resume (``train_crash_resume``).
    Returns the launch counts by architecture and the replays' results."""
    print(f"3l training: {card_name_and_power_limit()}")
    counts, replays = {}, []
    for arch in TRAIN_CELLS:
        counts[arch], res, _ = train_cell(torch, np, dev, arch, failures)
        replays += res
    for arch in TRAIN_CELLS:
        t1 = time.perf_counter()
        lm = arch == LM_ARCH
        over = (dict(vocab_per_field=TRAIN_CHECK_VOCAB)
                if arch in ("dlrm-rm2", "dcn-v2") else None)
        res = train_card_vs_cpu(
            torch, np, dev, arch, reduced=False, overrides=over,
            rows=TRAIN_CHECK_LM[0] if lm else TRAIN_CHECK_ROWS,
            seq=TRAIN_CHECK_LM[1] if lm else None, controls=True)
        print(f"  {arch} full width f32, one step card vs CPU"
              + (f" (vocab_per_field {TRAIN_CHECK_VOCAB})" if over else "")
              + f": {json.dumps(res)} (limits: loss 1e-5, gradients "
              f"{TRAIN_CHECK_GRAD} of each leaf's norm, parameters 0 beyond "
              f"the rule; each control's gradients above "
              f"{TRAIN_CHECK_GRAD}), {time.perf_counter() - t1:.3f} s")
        if not (res["loss_rel"] <= 1e-5
                and res["grad_rel"] <= TRAIN_CHECK_GRAD
                and res["param_beyond"] == 0.0):
            failures.append(f"3l {arch} card vs CPU: {res}")
        blind = [k for k in res if k.startswith("control_")
                 and not res[k] > TRAIN_CHECK_GRAD]
        if blind:
            failures.append(f"3l {arch}: the gradient gate does not see "
                            f"{blind}: {res}")
    train_crash_resume(torch, np, dev, failures)
    return counts, replays


@contextlib.contextmanager
def every_launch(ops):
    """Within the block, each kernel launch's ``(name, args, kwargs)`` in
    order (a phase 2b replay of launches that share a kernel and a
    variant: the GCN's two layers)."""
    real, seen = ops._launched, []

    def record(name, args, kwargs, variant="main"):
        seen.append((name, args, kwargs))
        real(name, args, kwargs, variant)

    ops._launched = record
    try:
        yield seen
    finally:
        ops._launched = real


def gnn_layouts(torch, shape, batch):
    """The bag layouts a GCN step builds (``segment_bags``: an edge set's
    destination rows, or the molecules' graphs), each timed alone with CUDA
    events: ``[dict(label, ms, rows, width, real, share)]``, ``real`` the
    slots of edges whose mask is not 0, ``share`` the padded slots' share
    of the layout."""
    from repro_torch.configs import get_arch
    from repro_torch.models import gcn

    x = get_arch(GNN_ARCH).shape(shape).extra
    kind = get_arch(GNN_ARCH).shape(shape).kind
    if kind == "gnn_minibatch":
        seeds = x["batch_nodes"]
        n1 = seeds * (1 + x["fanout"][0])
        sets = [("e2", "e2_src", "e2_dst", "e2_mask", n1),
                ("e1", "e1_src", "e1_dst", "e1_mask", seeds)]
    else:
        sets = [("edges", "edge_src", "edge_dst", "edge_mask",
                 batch["features"].shape[0])]
    out = []
    for label, s_key, d_key, m_key, n in sets:
        args = (batch[s_key], batch[d_key], batch[m_key], n)
        real = int((batch[m_key] != 0).sum())
        out.append((label, lambda a=args: gcn.segment_bags(*a), n, real))
    if kind == "gnn_batched":
        gid = batch["graph_ids"]
        nodes = torch.arange(gid.numel(), device=gid.device)
        n_graphs = x["batch"]
        out.append(("readout", lambda: gcn.segment_bags(
            nodes, gid, None, n_graphs, n_src=gid.numel()), n_graphs,
            gid.numel()))
    res = []
    for label, fn, rows, real in out:
        width = fn()[0].shape[1]
        ms = cuda_ms(torch, fn, budget_ms=100.0, max_reps=5)
        res.append(dict(label=label, ms=ms, rows=rows, width=width,
                        real=real, share=1.0 - real / (rows * width)))
    return res


def unpadded_launch_ms(torch, name, args, kwargs):
    """A padded GCN launch's live slots alone (weight not 0, in slot
    order), cut to bags of ``GNN_UNPADDED_WIDTH`` (about the mean
    in-degree at ogb_products) with no padding, through the same wrapper
    (CUDA events, back to back): what the layout's padding costs.
    Returns ``(ms, slots)``."""
    from repro_torch.kernels import embedding_bag as bag_k

    ids, w, table = args
    live = w != 0
    k = int(live.sum()) // GNN_UNPADDED_WIDTH * GNN_UNPADDED_WIDTH
    ids = ids[live][:k].reshape(-1, GNN_UNPADDED_WIDTH).contiguous()
    w = w[live][:k].reshape(-1, GNN_UNPADDED_WIDTH).contiguous()
    if name == "embedding_bag":
        ms = cuda_ms(torch, lambda: bag_k.embedding_bag_cuda(
            ids, w, table, **kwargs), max_reps=10)
    else:
        rows = torch.arange(ids.shape[0], device=ids.device)
        g = table[rows % table.shape[0]]
        ms = cuda_ms(torch, lambda: bag_k.embedding_bag_backward_cuda(
            ids, w, g, **kwargs), max_reps=10)
    return ms, ids.numel()


def gnn_step_twice(torch, bundle, params, batch):
    """Two train steps from copies of the same parameters and a fresh
    optimizer state on the same batch give the same bytes (parameters,
    moments, loss and gradient norm)."""
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_map

    outs = []
    for _ in range(2):
        p = tree_map(lambda t: t.clone(), params)
        state = train_loop.init_state(bundle.opt_cfg, p)
        p, state, metrics = bundle.step_fn(p, state, batch)
        outs.append((p, state.mu, state.nu, metrics["loss"],
                     metrics["grad_norm"]))
    torch.cuda.synchronize()
    return tree_bits_equal(torch, outs[0], outs[1])


def gnn_cell(torch, np, dev, shape, results, failures):
    """One gcn-cora shape of phase 3m at full width through
    ``steps.build``: the bag layouts' cost and padding, ``GNN_PLAN``'s
    steps on one batch (CUDA events), nodes and edges a second, model
    TFLOP/s, peak memory, the launches against ``GNN_LOOKUPS``, the losses
    (finite, the second below 1.5x the first) and two steps from the same
    state the same bytes.  At ``GNN_REPLAY`` the warm-up step's launches
    (layer 0's and layer 1's ``embedding_bag``, layer 1's backward) wait on
    the host and are replayed as phase 2b once the cell is freed, each
    printed beside its bound on the real edges alone.  Returns the launch
    counts of the counted steps."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_leaves

    kind = get_arch(GNN_ARCH).shape(shape).kind
    fwd, bwd = GNN_LOOKUPS[kind]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    bundle = steps.build(GNN_ARCH, shape, device=dev)
    params = bundle.init_fn(GNN_SEED)
    state = train_loop.init_state(bundle.opt_cfg, params)
    batch = bundle.make_batch(
        torch.Generator(device=dev).manual_seed(GNN_SEED + 1))
    torch.cuda.synchronize()
    edges = int(sum(int((batch[k] != 0).sum()) for k in batch
                    if k.endswith("mask") and k != "label_mask"))
    nodes = (int(batch["label_mask"].sum()) if kind == "gnn_full"
             else batch.get("features", batch.get("feats")).shape[0])
    print(f"  {shape} ({kind}): "
          + ", ".join(f"{k} {list(v[0])}" for k, v in
                      bundle.batch_spec.items())
          + f"; {nodes} nodes, {edges} edges (mask 1); "
          f"{sum(p.numel() for p in tree_leaves(params))} parameters; "
          f"made in {time.perf_counter() - t1:.3f} s")
    for lay in gnn_layouts(torch, shape, batch):
        print(f"  {shape} bag layout {lay['label']}: {lay['ms']:.4f} ms "
              f"(CUDA events), [{lay['rows']}, {lay['width']}] = "
              f"{lay['rows'] * lay['width']} slots for {lay['real']} real "
              f"edges ({lay['rows'] * lay['width'] / max(lay['real'], 1):.3f}"
              f"x), padded share {100 * lay['share']:.2f}%")
    ops.reset_launch_counts()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    warm, reps = GNN_PLAN
    losses, ms, held = [], [], []
    for j in range(warm + reps):
        if j == warm:  # phase 3o's peak: the timed steps', none recorded
            torch.cuda.synchronize()
            pre_peak = torch.cuda.max_memory_allocated()
            step_base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        rec = (every_launch(ops) if j == 0 and shape == GNN_REPLAY
               else contextlib.nullcontext([]))
        with rec as seen:
            ev0.record()
            params, state, metrics = bundle.step_fn(params, state, batch)
            ev1.record()
            ev1.synchronize()
        held = held or [(name, tuple(None if t is None else t.detach().cpu()
                                     for t in args), kwargs)
                        for name, args, kwargs in seen]
        del seen
        losses.append(float(metrics["loss"]))
        if j >= warm:
            ms.append(ev0.elapsed_time(ev1))
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    peak = max(pre_peak, step_peak)
    counts = ops.launch_counts()
    ms = np.array(ms)
    sec = np.median(ms) / 1e3
    measured(GNN_ARCH, shape, 0, np.percentile(ms, 50),
             step_peak - step_base + sum(
                 t.numel() * t.element_size()
                 for t in tree_leaves((params, state, batch))))
    print(f"  {shape}: losses {', '.join(f'{v:.6f}' for v in losses)}; "
          f"{reps} timed steps {', '.join(f'{v:.3f}' for v in ms)} ms (p50 "
          f"{np.percentile(ms, 50):.3f}); {nodes / sec:.1f} nodes/s, "
          f"{edges / sec:.1f} edges/s; model "
          f"{bundle.model_flops_per_step / sec / 1e12:.4f} TFLOP/s; peak "
          f"device memory {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB "
          f"above the {base / 1e9:.2f} GB held before)")
    steps_run = warm + reps
    print(f"  {shape} launches: {json.dumps(counts)} ({fwd} embedding_bag "
          f"and {bwd} embedding_bag_backward a step stated, {steps_run} "
          f"steps)")
    for name, per_step in zip(GNN_PATH, (fwd, bwd)):
        if counts[name] != per_step * steps_run:
            failures.append(f"3m {shape}: {name} launched {counts[name]} "
                            f"times, {per_step * steps_run} stated")
    if not all(np.isfinite(losses)):
        failures.append(f"3m {shape}: a loss is not finite: {losses}")
    if not losses[1] < 1.5 * losses[0]:
        failures.append(f"3m {shape}: second step's loss {losses[1]} not "
                        f"below 1.5x the first's {losses[0]}")
    same = gnn_step_twice(torch, bundle, params, batch)
    print(f"  {shape}: two steps from the same parameters and batch give "
          f"the same bytes: {same}")
    if not same:
        failures.append(f"3m {shape}: two steps from one state differ")
    real_slots = int((batch["edge_mask"] != 0).sum()) if held else 0
    del params, state, batch, metrics
    torch.cuda.empty_cache()
    layer = 0
    for name, args, kwargs in held:
        variant = f"gcn.{shape}" + (f".layer{layer}"
                                    if name == "embedding_bag" else "")
        layer += name == "embedding_bag"
        args = tuple(None if t is None else t.to(dev) for t in args)
        before = len(results.get(name, []))
        replay_all(torch, {f"{name}/{variant}": (args, kwargs)}, results,
                   failures)
        res = results[name][before]
        # the same bound with only the real edges' slots (4 B of id and 4
        # of weight each) in place of the padded layout's
        real_bytes = res["bytes"] - 8 * (args[0].numel() - real_slots)
        real_ms = real_bytes / HBM_BYTES_PER_S * 1e3
        kernel_ms = res["device_ms"] or res["ms"]
        unpadded_ms, unpadded_slots = unpadded_launch_ms(torch, name, args,
                                                         kwargs)
        print(f"  {name}/{variant}: D = {args[2].shape[1]}, "
              f"{args[0].numel()} slots ({real_slots} real); kernel "
              f"{kernel_ms:.5f} ms, bound {res['bound_ms']:.5f} ms as "
              f"launched ({100 * res['bound_ms'] / kernel_ms:.1f}%), "
              f"{real_ms:.5f} ms on the real edges "
              f"({100 * real_ms / kernel_ms:.1f}%); plain "
              f"{res['plain_ms']:.3f} ms, library {res['library_ms']} ms; "
              f"the wrapper call {res['ms']:.5f} ms against "
              f"{unpadded_ms:.5f} ms for the same edges unpadded "
              f"({unpadded_slots} slots in bags of {GNN_UNPADDED_WIDTH}): "
              f"padding {100 * (1 - unpadded_ms / res['ms']):.1f}% of the "
              f"call")
        del args
    torch.cuda.empty_cache()
    return counts


def gnn_ppr(torch, np, dev, index, failures):
    """``loss_ppr`` on the path of ``examples/gnn_ppr.py`` over 3b's index:
    ``GNN_PPR``'s seeds (distinct, from a numpy seed) through
    ``sampler.ppr_importance_sample`` (the index rows read to the host),
    their neighbours' random features (the MLP runs on the distinct
    neighbours only), ogb_products' widths, then SGD steps on the card and
    through the plain CPU path from the same parameters: the losses
    within 1e-5 relative, every parameter leaf within 1e-5 of its norm,
    and one ``embedding_bag`` and one backward launch a step.  Returns the
    card's launch counts."""
    import functools

    from repro_torch.configs import get_arch
    from repro_torch.graphs import sampler
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import gcn
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import sgd_update
    from repro_torch.tree import tree_leaves

    n_seeds, budget, n_steps, lr = GNN_PPR
    spec = get_arch(GNN_ARCH)
    cfg = steps._gnn_cfg(spec.config, spec.shape("ogb_products"))
    t1 = time.perf_counter()
    r = np.random.default_rng(GNN_SEED)
    seeds = torch.from_numpy(r.choice(index.n, n_seeds, replace=False)).to(
        dev)
    nbr, w = sampler.ppr_importance_sample(
        index.values[seeds].cpu().numpy(), index.indices[seeds].cpu().numpy(),
        np.arange(n_seeds), budget)
    uniq, pos = np.unique(nbr, return_inverse=True)
    gen = torch.Generator().manual_seed(GNN_SEED + 2)
    batch = dict(
        feats=torch.randn((len(uniq), cfg.d_feat), generator=gen),
        ppr_vals=torch.from_numpy(w),
        ppr_idx=torch.from_numpy(pos.reshape(nbr.shape).astype(np.int32)),
        labels=torch.randint(0, cfg.n_classes, (n_seeds,), generator=gen,
                             dtype=torch.int32))
    print(f"  ppr: {n_seeds} seeds of rmat({MAIN_N_LOG2})'s index (l = "
          f"{index.l}), budget {budget}: {len(uniq)} distinct neighbours, "
          f"sampled in {time.perf_counter() - t1:.3f} s; d_feat {cfg.d_feat}"
          f", {cfg.n_classes} classes, {n_steps} SGD steps at lr {lr}")
    loss = functools.partial(gcn.loss_ppr, cfg)
    params = gcn.init(cfg, GNN_SEED, device="cpu")
    runs = {}
    for where in (dev, "cpu"):
        p, b = tree_to(params, where), tree_to(batch, where)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        losses = []
        for _ in range(n_steps):
            value, _, grads = train_loop.value_and_grad(loss)(p, b)
            p = sgd_update(p, grads, lr)
            losses.append(float(value))
        seconds = time.perf_counter() - t1
        runs[where] = (losses, [t.cpu() for t in tree_leaves(p)],
                       ops.launch_counts(), seconds)
    (l_card, p_card, counts, s_card), (l_cpu, p_cpu, _, s_cpu) = (
        runs[dev], runs["cpu"])
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(l_card, l_cpu))
    param_rel = max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                    for a, b in zip(p_card, p_cpu))
    print(f"  ppr: losses card {', '.join(f'{v:.6f}' for v in l_card)} "
          f"({s_card:.3f} s), CPU {', '.join(f'{v:.6f}' for v in l_cpu)} "
          f"({s_cpu:.3f} s); worst loss {loss_rel:.3e} relative, worst "
          f"parameter leaf {param_rel:.3e} of its norm (limits 1e-5); "
          f"launches {json.dumps(counts)}")
    if not (loss_rel <= 1e-5 and param_rel <= 1e-5
            and all(np.isfinite(l_card))):
        failures.append(f"3m ppr card vs CPU: loss {loss_rel}, parameters "
                        f"{param_rel}")
    fwd, bwd = GNN_LOOKUPS["ppr"]
    for name, per_step in zip(GNN_PATH, (fwd, bwd)):
        if counts[name] != per_step * n_steps:
            failures.append(f"3m ppr: {name} launched {counts[name]} times, "
                            f"{per_step * n_steps} stated")
    return counts


def phase_gnn(torch, np, dev, index, results, failures):
    """Phase 3m: gcn-cora's four shapes at full width (``gnn_cell``, each
    counted from zero; ``GNN_REPLAY``'s launches replayed into
    ``results``), one f32 step of each card against the plain path
    (``train_card_vs_cpu``: full_graph_sm, minibatch_lg and molecule
    against the CPU; ogb_products, whose plain step is too large for the
    CPU's time, against the same step on the card through the kernels'
    plain versions), and ``loss_ppr`` on 3b's index (``gnn_ppr``).
    Returns the launch counts by shape, and ``ppr``'s."""
    print(f"3m gcn-cora: {card_name_and_power_limit()}")
    counts = {}
    for shape in GNN_CELLS:
        t1 = time.perf_counter()
        counts[shape] = gnn_cell(torch, np, dev, shape, results, failures)
        print(f"  {shape}: {time.perf_counter() - t1:.3f} s")
    for shape in GNN_CELLS:
        t1 = time.perf_counter()
        plain_on_card = shape == GNN_REPLAY
        res = train_card_vs_cpu(torch, np, dev, GNN_ARCH, reduced=False,
                                shape=shape, plain_on_card=plain_on_card)
        print(f"  {shape} full width f32, one step card vs "
              + ("the plain versions on the card" if plain_on_card
                 else "CPU")
              + f": {json.dumps(res)} (limits: loss 1e-5, gradients "
              f"{TRAIN_CHECK_GRAD} of each leaf's norm, parameters 0 beyond "
              f"the rule), {time.perf_counter() - t1:.3f} s")
        if not (res["loss_rel"] <= 1e-5
                and res["grad_rel"] <= TRAIN_CHECK_GRAD
                and res["param_beyond"] == 0.0):
            failures.append(f"3m {shape} card vs reference: {res}")
    t1 = time.perf_counter()
    counts["ppr"] = gnn_ppr(torch, np, dev, index, failures)
    print(f"  ppr: {time.perf_counter() - t1:.3f} s")
    return counts


# -- phase 3n: the contract auditor --------------------------------------------

def contract_audit_failures(results, rule_ids):
    """What keeps a run of the auditor from passing on the card: a rule of
    ``rule_ids`` missing, not PASS (a finding, or a SKIP), or with no
    target audited."""
    got = {r.rule: r for r in results}
    bad = [f"{rule} not run" for rule in rule_ids if rule not in got]
    bad += [f"{r.rule} {r.status} ({len(r.audited)} audited, "
            f"{len(r.unsuppressed)} findings, skipped {r.skipped})"
            for r in results if r.status != "PASS" or not r.audited]
    return bad


def phase_contract_auditor(torch, dev, g, index, failures):
    """Phase 3n: every rule of ``repro_torch.analysis`` on the card, with
    3b's rmat(20) graph and index as hbm-residency's main graph; prints
    the report, whose notes hold each kernel's shared bytes a block."""
    from repro_torch.analysis import report, rules

    results = rules.run_rules(device=dev, main_graph=(g, index))
    torch.cuda.synchronize()
    print(report.render_text(results))
    failures += [f"3n contract auditor: {x}"
                 for x in contract_audit_failures(results, rules.RULES)]


# -- phase 3o: the dry-run and the roofline ------------------------------------

def phase_dryrun(torch, failures):
    """Phase 3o: the whole dry-run on meta (nothing allocated on the card)
    against ``Hardware.from_device()``: every registry cell on one card
    and the PPR engine cells on both production meshes, its seconds and
    its report.  Gates: every record ``ok``; every cell an earlier phase
    ran at its published batch (``MEASURED``) predicted to fit.  Then each
    measured cell traced again as it ran (its batch, the f32 parameters
    the phases hold), its peak and roofline time beside the measurement.
    Every trace runs in one pool of ``min(8, cores)`` spawned processes,
    the slowest cells first: the large LMs' ``train_4k`` take 30–110 s
    each (printed), where the other 36 model cells take 0–15 s."""
    from repro_torch.configs import all_cells, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import analysis as roof
    from repro_torch.roofline import report

    hw = roof.Hardware.from_device()
    print(f"3o: {card_name_and_power_limit()}; the roofline's rates are the "
          f"datasheet's at {hw.power_limit_w:.0f} W: "
          f"{hw.peak_flops_tensor / 1e12:.1f} TFLOP/s bf16 tensor cores, "
          f"{hw.peak_flops_other / 1e12:.1f} f32, "
          f"{hw.hbm_bw / 1e12:.2f} TB/s HBM, {hw.link_bw / 1e9:.0f} GB/s "
          f"NVLink a direction; capacity {hw.hbm_bytes / 1e9:.2f} GB "
          f"(total_memory)")
    out_dir = tempfile.mkdtemp(prefix="dryrun-")
    t1 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    cells = sorted(all_cells(), key=dryrun.cost_rank)
    ppr = [(name, make_production_mesh(multi_pod=multi), tag)
           for tag, multi in (("pod", False), ("multipod", True))
           for name in dryrun.PPR_CELLS]
    as_run = sorted(MEASURED.items())
    # one pool: the slowest cells first, then the PPR cells and each cell
    # an earlier phase ran, traced again as it ran
    out = dryrun.run_jobs(
        [(dryrun.run_cell, (a, s, out_dir, "card"), dict(hw=hw))
         for a, s in cells]
        + [(dryrun.run_ppr_cell, (name, mesh, out_dir, tag), dict(hw=hw))
           for name, mesh, tag in ppr]
        + [(dryrun.trace_cell, (arch, shape), dict(
            batch=m["batch"] or None, serve_dtype=None))
           for (arch, shape), m in as_run], workers)
    recs, traced = out[:len(cells) + len(ppr)], out[len(cells) + len(ppr):]
    failures += [f"3o: {r}" for r in recs if isinstance(r, Exception)]
    recs = [r for r in recs if not isinstance(r, Exception)]
    print(f"3o: {len(recs)} records ({len(cells)} model cells, "
          f"{len(ppr)} PPR cells) and {len(traced)} cells traced as run in "
          f"{time.perf_counter() - t1:.3f} s in {workers} processes; the "
          f"slowest: " + ", ".join(
              f"{r['arch']} {r['shape']} {r['seconds']} s" for r in sorted(
                  recs, key=lambda r: -r["seconds"])[:4]))
    for r in recs:
        if "mesh_16x16" in r:
            m = r["mesh_16x16"]
            print(f"3o: {r['arch']} {r['shape']}: a device of the 16 x 16 "
                  f"mesh holds {m['param_bytes'] / 1e9:.3f} GB of its "
                  f"parameters" + (f" and {m['opt_bytes'] / 1e9:.3f} GB of "
                                   f"its optimizer state" if "opt_bytes" in m
                                   else "") + " under sharding's specs")
    print(report.render(report.load(out_dir)))
    shutil.rmtree(out_dir, ignore_errors=True)
    failures += [f"3o: {r['arch']} {r['shape']} {r['mesh_tag']}: "
                 f"{r['error'][:120]}" for r in recs if not r.get("ok")]
    fits = {(r["arch"], r["shape"]): r.get("hbm_fits") for r in recs
            if r.get("mesh_tag") == "card"}
    for ((arch, shape), m), res in zip(as_run, traced):
        uncut = m["batch"] == get_arch(arch).shape(shape).global_batch
        if uncut and not fits.get((arch, shape)):
            failures.append(f"3o: {arch} {shape} ran uncut in its phase but "
                            "is predicted not to fit")
        if isinstance(res, Exception):     # printed, not gated
            print(f"3o as run: {arch} {shape}: {type(res).__name__}: {res}")
            continue
        cost, ctx = res
        terms = roof.roofline_from_counts(
            cost, hw=hw, model_flops_total=ctx["model_flops"])
        used = roof.fit_check(terms, hw)[1]
        bound = max(terms.compute_s, terms.memory_s, terms.collective_s)
        print(f"3o as run: {arch} {shape} B = {ctx['global_batch']}"
              f"{'' if uncut else ' (cut)'}: peak predicted "
              f"{used / 1e9:.2f} GB, measured {m['peak'] / 1e9:.2f} GB "
              f"(max_memory_allocated over its run above what was held "
              f"before, plus its arguments); roofline "
              f"{bound * 1e3:.3f} ms ({terms.dominant}: compute "
              f"{terms.compute_s * 1e3:.3f}, memory "
              f"{terms.memory_s * 1e3:.3f}), measured p50 {m['ms']:.3f} ms")


def check_small_gnn(torch, np, dev, shape):
    """One train step of gcn-cora's reduced ``shape`` in f32, card against
    the plain CPU path (``train_card_vs_cpu``): loss within 1e-5,
    gradients within 1e-5 of each leaf's norm, parameters within the
    rule."""
    res = train_card_vs_cpu(torch, np, dev, GNN_ARCH, reduced=True,
                            shape=shape)
    return (res["loss_rel"] <= 1e-5 and res["grad_rel"] <= 1e-5
            and res["param_beyond"] == 0.0), res


def check_small_train(torch, np, dev, arch):
    """One train step of ``arch``'s reduced config in f32, card against the
    plain CPU path (``train_card_vs_cpu``): loss within 1e-5, gradients
    within 1e-5 of each leaf's norm, parameters within the rule."""
    res = train_card_vs_cpu(torch, np, dev, arch, reduced=True)
    return (res["loss_rel"] <= 1e-5 and res["grad_rel"] <= 1e-5
            and res["param_beyond"] == 0.0), res


def check_small_montecarlo(torch, np, dev):
    """The Monte-Carlo path at ``rmat(14)`` on the card and through the
    plain CPU path from one key, each bit-equal: the legacy build's index
    (every fourth source), the dense and the sparse MCFP and MCEP
    estimates of 64 sources, ``mcfp``-mode top-k answers at dispatch keys
    0-3, and ``randint`` (2a's spans).  Returns ``{check: equal}``."""
    from repro_torch import rng
    from repro_torch.core import mcep, mcfp
    from repro_torch.core.index import build_index
    from repro_torch.core.query import BatchQueryEngine, QueryConfig
    from repro_torch.graphs import synthetic

    devs = (dev, "cpu")
    graphs = {d: synthetic.rmat(14, avg_deg=10.0, seed=3, device=d)
              for d in devs}
    n = graphs["cpu"].n
    key = rng.prng_key(6)
    src = np.random.default_rng(13).integers(0, n, 64).astype(np.int32)
    out = {}

    def same(name, make):
        got = {d: make(d) for d in devs}
        pairs = list(zip(*(x if isinstance(x, tuple) else (x,)
                           for x in (got[dev], got["cpu"]))))
        out[name] = all(bits_equal(torch, a.cpu(), b) for a, b in pairs)

    same("legacy build", lambda d: (lambda ix: (ix.values, ix.indices))(
        build_index(graphs[d], r=32, l=64, key=key, source_batch=1024,
                    sources=np.arange(0, n, 4), engine="legacy",
                    device=d)[0]))
    for label, mod in (("mcfp", mcfp), ("mcep", mcep)):
        same(f"{label} dense", lambda d: mod.estimate_ppr(
            graphs[d], torch.from_numpy(src), 100, key))
        same(f"{label} sparse", lambda d: (lambda sf: (sf.values, sf.indices))(
            mod.estimate_ppr_sparse(graphs[d], torch.from_numpy(src), 100,
                                    key, l=512)))
    engines = {d: BatchQueryEngine(graphs[d], None, QueryConfig(
        mode="mcfp", r_online=200, top_k=50), device=d) for d in devs}
    for seq in range(4):
        same(f"mcfp mode, dispatch key {seq}",
             lambda d: engines[d].query_topk_async(
                 src, key=engines[d].dispatch_key(seq)))
    out["randint"] = synthetic_randint(torch, np, dev)
    return out


def phase_montecarlo(torch, np, dev, g, sources, truth, work, failures):
    """Phase 3h: the Monte-Carlo path on the main graph, with the launch
    counters zeroed just before and read just after.  Returns the counts
    and the captured first ``walk_step`` launch (of the sparse MCFP)."""
    from repro_torch import rng
    from repro_torch.core import mcep, mcfp, theory
    from repro_torch.core.frontier import topk_dense
    from repro_torch.core.index import (build_index, plan_for_budget,
                                        preprocessing_cost_model)
    from repro_torch.core.metrics import mean_rag, precision_at_k
    from repro_torch.core.query import QueryConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import PPRService, ServiceConfig
    from repro_torch.serving.batching import BatchingConfig
    from repro_torch.serving.pipeline import PipelineConfig

    key = rng.prng_key(1)
    r_ep = theory.mcep_equivalent_walks(MC_R)
    q = int(sources.shape[0])
    ops.reset_launch_counts()
    ops.capture_first_launches(True)
    runs = {
        f"mcfp sparse r={MC_R}": lambda: mcfp.estimate_ppr_sparse(
            g, sources, MC_R, key, l=MC_L),
        f"mcep sparse r={MC_R}": lambda: mcep.estimate_ppr_sparse(
            g, sources, MC_R, key, l=MC_L),
        f"mcep sparse r={r_ep}": lambda: mcep.estimate_ppr_sparse(
            g, sources, r_ep, key, l=MC_L),
        f"mcfp dense r={MC_R}": lambda: mcfp.estimate_ppr(
            g, sources, MC_R, key),
        f"mcep dense r={MC_R}": lambda: mcep.estimate_ppr(
            g, sources, MC_R, key),
    }
    quality = {}
    for label, fn in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        est = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        dense = est if torch.is_tensor(est) else densify(
            torch, est.values, est.indices, g.n)
        top_v, _ = topk_dense(dense, 50)
        row_mass = dense.sum(dim=1)
        if (dense.shape != (q, g.n) or not bool(torch.isfinite(dense).all())
                or bool((dense < 0).any())
                or float(top_v.sum(dim=1).max()) > 1.0 + 1e-4
                or float(row_mass.max()) > 1.0 + 1e-4):
            failures.append(f"{label}: estimates not finite, non-negative "
                            f"and of mass <= 1")
        quality[label] = dict(
            seconds=secs, peak_gib_above_base=peak,
            mean_rag=mean_rag(truth, dense, 50),
            precision=float(precision_at_k(truth, dense, 50).mean()),
            row_mass_min=float(row_mass.min()))
        print(f"  {label}: {secs:.3f} s, peak {peak:.3f} GiB above the "
              f"{base / 2**30:.2f} GiB held, " + json.dumps(
                  {k: quality[label][k] for k in (
                      "mean_rag", "precision", "row_mass_min")}))
        del est, dense, top_v
    rag = {k: v["mean_rag"] for k, v in quality.items()}
    fp, ep1, ep2 = (rag[f"mcfp sparse r={MC_R}"], rag[f"mcep sparse r={MC_R}"],
                    rag[f"mcep sparse r={r_ep}"])
    print(f"  the paper's ordering in RAG@50, MCFP({MC_R}) >= MCEP({r_ep}) > "
          f"MCEP({MC_R}): {fp:.5f} >= {ep2:.5f} > {ep1:.5f}: "
          f"{fp >= ep2 > ep1} (printed, not gated)")
    captured = ops.captured_launches().get("walk_step/main")
    ops.capture_first_launches(False)

    # the mcfp serving mode, closed loop: through its graphs at depths 4
    # and 1 and eagerly at depth 4, the same bytes
    print("  mcfp mode, captured against eager on the same requests:")
    _, _, svc = captured_vs_eager(
        torch, np, lambda depth: PPRService(g, None, ServiceConfig(
            query=QueryConfig(mode="mcfp", r_online=MC_R_ONLINE, top_k=50),
            batching=BatchingConfig(max_batch=256, max_wait_s=10.0),
            pipeline=PipelineConfig(depth=depth)), device=dev),
        work[:MC_REQUESTS], "mcfp", failures, depth1_requests=MC_REQUESTS)
    eng = svc.engine
    src256 = torch.tensor(work[:256], dtype=torch.int32, device=dev)
    wall_ms, device_ms, split = device_time_split(
        torch, lambda: eng.query_topk(src256, key=eng.dispatch_key(0)))
    print(f"  mcfp batch of 256, device time by kernel (torch.profiler): "
          f"wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms, idle "
          f"{100 * (1 - device_ms / wall_ms):.1f}% of the wall")
    for name, ms in split:
        print(f"  {ms:9.3f} ms  {100 * ms / max(device_ms, 1e-9):5.1f}%  "
              f"{name[:110]}")
    del svc, eng

    # the legacy (dense-accumulator) build over the first sources
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    legacy, lstats = build_index(
        g, r=MC_LEGACY_R, l=MAIN_L, key=key, source_batch=MC_LEGACY_BATCH,
        sources=np.arange(MC_LEGACY_SOURCES), engine="legacy", device=dev)
    torch.cuda.synchronize()
    legacy_s = time.perf_counter() - t1
    chunks = -(-MC_LEGACY_SOURCES // MC_LEGACY_BATCH)
    rows = legacy.values[:MC_LEGACY_SOURCES]
    if (not bool(torch.isfinite(rows).all()) or bool((rows < 0).any())
            or float(rows.sum(dim=1).max()) > 1.0 + 1e-4):
        failures.append("legacy build rows not finite, non-negative and of "
                        "mass <= 1")
    print(f"  legacy build: {MC_LEGACY_SOURCES} sources, r={MC_LEGACY_R}, "
          f"l={MAIN_L}, {chunks} chunks of {MC_LEGACY_BATCH}: {legacy_s:.3f} "
          f"s, {legacy_s / chunks:.4f} s a chunk, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; " + json.dumps(
              {k: lstats[k] for k in ("kept_mass", "dropped_mass",
                                      "drop_fraction", "pad_rows")}))
    del legacy, rows
    counts = ops.launch_counts()
    print("monte-carlo-path launches:", json.dumps(counts))
    failures += [f"kernel {k} never launched on the monte-carlo path"
                 for k in MC_PATH if counts[k] <= 0]

    # the planner at the budget of 3b's index
    budget = g.n * MAIN_L * 8
    plan = plan_for_budget(g.n, budget)
    print(f"  plan_for_budget(n={g.n}, {budget} bytes): {plan}")
    for r in (plan.r, MAIN_R):
        print(f"  preprocessing_cost_model(n={g.n}, r={r}): "
              + json.dumps(preprocessing_cost_model(g.n, r)))
    return counts, captured


# -- captured CUDA graphs at rmat(14) (phase 4 and the cuda tests) ----------

CAPTURE_CONFIGS = {   # label -> QueryConfig keywords; rmat(14), l = 64
    "sparse, scatter combine": dict(hub_split_degree=64),
    "sparse, sparse combine": dict(hub_split_degree=64,
                                   combine_path="sparse"),
    "dense": dict(),
    "mcfp": dict(mode="mcfp", r_online=200),
    # four seeds widen K past the auto route's n / 64 here: forced sparse
    "sparse, seed sets of 4": dict(hub_split_degree=64, max_seeds=4,
                                   frontier_path="sparse"),
    "dense, seed sets of 4": dict(max_seeds=4),
}
_small_capture_setup = {}


def small_capture_setup(torch, dev):
    """rmat(14) and its index (r = 32, l = 64) on ``dev``, built once."""
    if dev not in _small_capture_setup:
        from repro_torch import rng
        from repro_torch.core.index import build_index
        from repro_torch.graphs import synthetic

        g = synthetic.rmat(14, avg_deg=10.0, seed=3, device=dev)
        index, _ = build_index(g, r=32, l=64, key=rng.prng_key(5),
                               source_batch=1024, device=dev)
        _small_capture_setup[dev] = (g, index)
    return _small_capture_setup[dev]


def small_capture_engine(torch, dev, label):
    from repro_torch.core.query import BatchQueryEngine, QueryConfig

    g, index = small_capture_setup(torch, dev)
    cfg = QueryConfig(t_iterations=2, top_k=50, **CAPTURE_CONFIGS[label])
    return BatchQueryEngine(g, None if cfg.mode == "mcfp" else index, cfg,
                            device=dev)


def check_captured_equals_eager(torch, np, dev, label):
    """At every padded width of ``max_batch=256``, the captured query of
    the config ``label`` (``CAPTURE_CONFIGS``) answers in the same bytes
    as the eager query on the same inputs, each width one graph, and the
    width's second dispatch (new inputs into the same graph) too."""
    from repro_torch.core import walks
    from repro_torch.core.query import MCFP_MAX_STEPS
    from repro_torch.serving.batching import BatchingConfig

    eng = small_capture_engine(torch, dev, label)
    widths = BatchingConfig(max_batch=256).padded_shapes()
    r = np.random.default_rng(21)
    s_w = eng.config.max_seeds
    ok = eng.uses_sparse_path() == label.startswith("sparse")
    for w in widths:
        for rep in range(2):
            if s_w > 1:
                src = r.integers(0, eng.graph.n, (w, s_w)).astype(np.int32)
                wts = (r.random((w, s_w)) * (r.random((w, s_w)) > 0.3)
                       ).astype(np.float32)
            else:
                src = r.integers(0, eng.graph.n, w).astype(np.int32)
                wts = None
            key = eng.dispatch_key(w + rep)
            got = [x.clone() for x in eng.query_topk_async(
                src, key=key, weights=wts)]
            words = (walks.step_key_words(key, MCFP_MAX_STEPS, dev)
                     if eng.uses_key else None)
            want = eng._topk_eager(
                torch.from_numpy(src).to(dev),
                None if wts is None else torch.from_numpy(wts).to(dev),
                words)
            ok &= all(bits_equal(torch, a, b) for a, b in zip(got, want))
    return ok and len(eng.graphs) == len(widths)


def check_captured_shapes(torch, np, dev):
    """The retrace guard's counterpart: an np array, a tensor on the card
    and a list of one width replay one graph, so the graphs captured are
    the widths."""
    from repro_torch.serving.batching import BatchingConfig

    eng = small_capture_engine(torch, dev, "sparse, scatter combine")
    widths = BatchingConfig(max_batch=64).padded_shapes()
    answers = []
    for w in widths:
        spellings = (np.zeros(w, np.int32),
                     torch.zeros(w, dtype=torch.int32, device=dev),
                     [0] * w)
        got = [[x.clone() for x in eng.query_topk_async(
            x, key=eng.dispatch_key(0))] for x in spellings]
        answers.append(all(bits_equal(torch, a, b)
                           for g in got[1:] for a, b in zip(got[0], g)))
    return all(answers) and sorted(k[0][0] for k in eng.graphs) == widths


def check_captured_launch_counts(torch, np, dev):
    """``launch_counts`` grows by the graph's recorded kernels on every
    replay, and a capture counts only its eager warm-up."""
    from repro_torch.kernels import ops

    ok = True
    for label in ("sparse, sparse combine", "dense"):
        eng = small_capture_engine(torch, dev, label)
        src = np.arange(64, dtype=np.int32)
        eng.query_topk_async(src)          # warm-up, capture, replay
        graph = eng.graphs[((64,), None)]
        want = {k: v for k, v in graph.launches.items() if v}
        ok &= bool(want) and set(want) <= set(ops.KERNELS)
        ops.reset_launch_counts()
        for reps in (1, 2, 3):
            eng.query_topk_async(src + reps)
            got = {k: v for k, v in ops.launch_counts().items() if v}
            ok &= got == {k: reps * v for k, v in want.items()}
    return ok


def check_captured_into_given_buffers(torch, np, dev):
    """``out=`` on the card: the answer lands in the given tensors (the
    same memory, returned), equal to the graph's own, not the donor's."""
    eng = small_capture_engine(torch, dev, "sparse, sparse combine")
    src = np.arange(64, dtype=np.int32)
    v0, i0 = (x.clone() for x in eng.query_topk_async(src))
    donor = v0.clone()
    ptrs = (v0.data_ptr(), i0.data_ptr())
    v1, i1 = eng.query_topk_async(src + 1, out=(v0, i0))
    ok = (v1.data_ptr(), i1.data_ptr()) == ptrs
    want = [x.clone() for x in eng.query_topk_async(src + 1)]
    return (ok and bits_equal(torch, v1, want[0])
            and bits_equal(torch, i1, want[1])
            and not bits_equal(torch, v1, donor))


def check_captured_after_updates(torch, np, dev):
    """A service serving through graphs answers, after ``apply_updates``,
    like a fresh service on the new graph and index (the graphs of the new
    engine are captured inside ``apply_updates``)."""
    from repro_torch import rng
    from repro_torch.core.query import QueryConfig
    from repro_torch.core.updates import build_maintainable_index
    from repro_torch.serving import PPRService, ServiceConfig
    from repro_torch.serving.batching import BatchingConfig

    g, _ = small_capture_setup(torch, dev)
    m, _ = build_maintainable_index(g, UPD_R, UPD_L, rng.prng_key(7),
                                    source_batch=1024, device=dev, c=UPD_C,
                                    max_steps=UPD_MAX_STEPS, respawn=True,
                                    touch_bits=1024)
    cfg = ServiceConfig(
        query=QueryConfig(t_iterations=2, top_k=50, c=UPD_C,
                          hub_split_degree=64, combine_path="sparse"),
        batching=BatchingConfig(max_batch=64))
    svc = PPRService(g, None, cfg, device=dev, maintainer=m)
    work = np.random.default_rng(22).integers(0, g.n, 300).tolist()
    svc.run_closed_loop(work)
    shapes = set(svc.engine.graphs)
    ok = bool(shapes)
    ins = np.random.default_rng(23).integers(0, g.n, (UPD_EDGES, 2))
    for b in range(2):
        rep = svc.apply_updates(inserts=ins + b)
        ok &= set(svc.engine.graphs) == shapes and rep["graphs_captured"] \
            == len(shapes)
        got, _ = svc.run_closed_loop(work)
        fresh = PPRService(svc.graph, svc.maintainer.index, cfg, device=dev)
        want, _ = fresh.run_closed_loop(work)
        ok &= served_bytes(got) == served_bytes(want)
    return ok


CAPTURE_CHECKS = {
    **{f"captured equals eager, {label}": (
        lambda torch, np, dev, label=label: check_captured_equals_eager(
            torch, np, dev, label)) for label in CAPTURE_CONFIGS},
    "one graph per width whatever the spelling": check_captured_shapes,
    "launch counts include replays": check_captured_launch_counts,
    "out= writes into the given tensors": check_captured_into_given_buffers,
    "captured service after apply_updates": check_captured_after_updates,
}


def check_small_maintenance(torch, np, dev):
    """Maintenance and crash safety at ``rmat(14)`` from one key: the
    single-device repair on the card against the plain CPU path and
    against the card's own rebuild, the sharded repair on a stacked 2 x 2
    mesh on the card against the CPU and against the card's sharded
    rebuild, and a checkpointed build on the card, crashed and resumed,
    against an uninterrupted one (index, filters and totals).  Returns
    ``{check: bit-equal}``."""
    from repro_torch import rng
    from repro_torch.core.index import build_index, build_index_sharded
    from repro_torch.core.updates import (apply_updates,
                                          build_maintainable_index)
    from repro_torch.distributed import ShardMesh
    from repro_torch.graphs import synthetic
    from repro_torch.testing import FaultPlan, InjectedFault

    devs = (dev, "cpu")
    graphs = {d: synthetic.rmat(14, avg_deg=10.0, seed=3, device=d)
              for d in devs}
    n = graphs["cpu"].n
    key = rng.prng_key(7)
    kw = dict(c=UPD_C, max_steps=UPD_MAX_STEPS, respawn=True,
              touch_bits=1024)
    ins = np.random.default_rng(14).integers(0, n, (UPD_EDGES, 2))
    dels = np.array([[int(graphs["cpu"].src[-1]),
                      int(graphs["cpu"].col_idx[-1])]])
    out = {}

    def same(*pairs):
        return all(bits_equal(torch, a.cpu(), b.cpu()) for a, b in pairs)

    def state(m):
        return (m.index.values, m.index.indices, m.touch.bits)

    for label, sharded in (("repair", False), ("sharded repair", True)):
        meshes = {d: ShardMesh(data=2, model=2, device=d) if sharded
                  else None for d in devs}
        repaired, reports = {}, {}
        for d in devs:
            m, _ = build_maintainable_index(
                graphs[d], UPD_R, UPD_L, key, source_batch=256,
                mesh=meshes[d], device=d, **kw)
            g2, m2, rep = apply_updates(m, graphs[d], inserts=ins,
                                        deletes=dels)
            repaired[d], reports[d] = (g2, m2), rep
        ok = same(*zip(state(repaired[dev][1]), state(repaired["cpu"][1])))
        ok &= (reports[dev]["dirty_row_ids"].tobytes()
               == reports["cpu"]["dirty_row_ids"].tobytes())
        out[f"{label}, card vs CPU"] = ok
        if sharded:
            rebuilt, rstats = build_index_sharded(
                repaired[dev][0], UPD_R, UPD_L, key, source_batch=256,
                mesh=meshes[dev], **kw)
        else:
            rebuilt, rstats = build_index(
                repaired[dev][0], UPD_R, UPD_L, key, source_batch=256,
                device=dev, **kw)
        out[f"{label} vs rebuild, card"] = same(
            (repaired[dev][1].index.values, rebuilt.values),
            (repaired[dev][1].index.indices, rebuilt.indices),
            (repaired[dev][1].touch.bits, rstats["touch"]))
        print(f"  small reference, {label}: {reports[dev]['dirty_rows']} "
              f"dirty rows, {reports[dev]['repaired_chunks']} of "
              f"{reports[dev]['total_chunks']} chunks")

    d = tempfile.mkdtemp(prefix="powerwalk_ckpt_small_")
    try:
        ck = dict(r=UPD_R, l=UPD_L, key=key, source_batch=1024, device=dev,
                  **kw)
        want, wstats = build_index(graphs[dev], **ck)
        try:
            build_index(graphs[dev], checkpoint_dir=d, checkpoint_every=2,
                        fault_plan=FaultPlan(raise_at_chunks=(5,)), **ck)
            crashed = False
        except InjectedFault:
            crashed = True
        got, gstats = build_index(graphs[dev], checkpoint_dir=d,
                                  checkpoint_every=2, resume=True, **ck)
        out["checkpointed build resumed on the card"] = (
            crashed and gstats["resumed_at_chunk"] == 4
            and same((got.values, want.values), (got.indices, want.indices),
                     (gstats["touch"], wstats["touch"]))
            and (gstats["kept_mass"], gstats["dropped_mass"])
            == (wstats["kept_mass"], wstats["dropped_mass"]))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


@contextlib.contextmanager
def timed_commits():
    """Log every ``Checkpointer.save`` while the block runs: step,
    seconds and the bytes of its arrays (a save that raises is not
    logged)."""
    from repro_torch.distributed.checkpoint import Checkpointer

    log = []
    save = Checkpointer.save

    def timed(self, step, tree, extra=None, **kw):
        t = time.perf_counter()
        save(self, step, tree, extra, **kw)
        log.append(dict(step=step, seconds=time.perf_counter() - t, bytes=sum(
            v.numel() * v.element_size() if hasattr(v, "element_size")
            else v.nbytes for v in tree.values())))

    Checkpointer.save = timed
    try:
        yield log
    finally:
        Checkpointer.save = save


def served_bytes(answers):
    """``{vertex: (score bytes, vertex bytes, cached)}`` of each vertex's
    first answer by request id."""
    out = {}
    for a in sorted(answers, key=lambda a: a.request_id):
        out.setdefault(a.vertex, (a.top_scores.tobytes(),
                                  a.top_vertices.tobytes(), a.cached))
    return out


def phase_maintenance(torch, np, dev, g, index, stats, cfg, work, failures):
    """Phase 3i on 3a's graph, with the launch counters zeroed just before
    and read just after.  (a) 3b's build with checkpoints, crashed at a
    chunk and resumed, against 3b's index, then a service booted from the
    checkpoint against one over 3b's index; (b) the reference update
    benchmark's walks at n = 2^20: a maintainable build, a service with
    its maintainer serving, edge batches applied live, a rebuild on the
    final graph against the repaired index.  Returns the counts."""
    from repro_torch import rng
    from repro_torch.core.graph import apply_edge_updates
    from repro_torch.core.index import build_index
    from repro_torch.core.query import QueryConfig
    from repro_torch.core.updates import (build_maintainable_index,
                                          default_touch_bits)
    from repro_torch.distributed.checkpoint import Checkpointer
    from repro_torch.kernels import ops
    from repro_torch.serving import CacheConfig, PPRService, ServiceConfig
    from repro_torch.serving.batching import BatchingConfig
    from repro_torch.serving.pipeline import PipelineConfig
    from repro_torch.testing import FaultPlan, InjectedFault

    print(f"  card: {card_name_and_power_limit()}")
    ops.reset_launch_counts()
    # -- (a) the crash-safe build at 3b's own arguments ----------------------
    main = dict(r=MAIN_R, l=MAIN_L, key=rng.prng_key(0),
                source_batch=MAIN_SOURCE_BATCH, device=dev,
                checkpoint_every=CKPT_EVERY)
    d = tempfile.mkdtemp(prefix="powerwalk_ckpt_")
    try:
        with timed_commits() as commits:
            t1 = time.perf_counter()
            try:
                build_index(g, checkpoint_dir=d, fault_plan=FaultPlan(
                    raise_at_chunks=(CKPT_CRASH_CHUNK,)), **main)
                failures.append("checkpointed build: no InjectedFault")
            except InjectedFault:
                pass
            torch.cuda.synchronize()
            crashed_s = time.perf_counter() - t1
            steps_left = Checkpointer(d).all_steps()
            t1 = time.perf_counter()
            got, gstats = build_index(g, checkpoint_dir=d, resume=True,
                                      **main)
            torch.cuda.synchronize()
            resumed_s = time.perf_counter() - t1
        equal = (bits_equal(torch, got.values, index.values)
                 and bits_equal(torch, got.indices, index.indices)
                 and (gstats["kept_mass"], gstats["dropped_mass"])
                 == (stats["kept_mass"], stats["dropped_mass"]))
        print(f"  crash-safe build: {MAIN_SOURCE_BATCH}-source chunks, a "
              f"commit every {CKPT_EVERY}; crashed before chunk "
              f"{CKPT_CRASH_CHUNK} after {crashed_s:.3f} s, committed steps "
              f"{steps_left}; resumed at chunk {gstats['resumed_at_chunk']} "
              f"in {resumed_s:.3f} s; index and kept/dropped totals "
              f"bit-equal to 3b's: {equal}")
        for c in commits:
            print(f"  commit step {c['step']}: {c['bytes']} bytes in "
                  f"{c['seconds']:.3f} s ({c['bytes'] / c['seconds'] / 1e9:.3f}"
                  f" GB/s)")
        print(f"  commits: {len(commits)}, {sum(c['bytes'] for c in commits)}"
              f" bytes, {sum(c['seconds'] for c in commits):.3f} s")
        if not equal or gstats["resumed_at_chunk"] != 2 * CKPT_EVERY:
            failures.append("resumed checkpointed build differs from 3b's")
        del got
        t1 = time.perf_counter()
        booted = PPRService.from_checkpoint(g, d, cfg, device=dev)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(d, ignore_errors=True)
    reqs = work[:CKPT_REQUESTS]
    a_boot, _ = booted.run_closed_loop(reqs)
    a_main, _ = PPRService(g, index, cfg, device=dev).run_closed_loop(reqs)
    same = served_bytes(a_boot) == served_bytes(a_main)
    print(f"  from_checkpoint: booted in {boot_s:.3f} s; {len(a_boot)} "
          f"answers the same bytes as a service over 3b's index: {same}")
    if not same or len(a_boot) != CKPT_REQUESTS:
        failures.append("checkpoint-booted service answers differ")
    del booted

    # -- (b) maintenance at the update benchmark's walks ----------------------
    np_rng = np.random.default_rng(UPD_SEED)
    pool = np_rng.integers(0, g.n, size=(UPD_EDGES, 2), dtype=np.int64)
    g0, _ = apply_edge_updates(g, inserts=pool)
    key = rng.prng_key(UPD_SEED)
    bits = default_touch_bits(UPD_R)
    walk = dict(c=UPD_C, max_steps=UPD_MAX_STEPS, source_batch=UPD_SOURCE_BATCH,
                respawn=True, touch_bits=bits)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m, bstats = build_maintainable_index(g0, UPD_R, UPD_L, key, device=dev,
                                         **walk)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    print(f"  maintainable build: r={UPD_R} l={UPD_L} c={UPD_C} "
          f"source_batch={UPD_SOURCE_BATCH} ({m.n_chunks} chunks), touch "
          f"sketch {m.touch.nbytes / 2**30:.2f} GiB ({bits} bits a row): "
          f"{build_s:.3f} s; " + json.dumps({k: bstats[k] for k in (
              "kept_mass", "dropped_mass", "drop_fraction")}))
    ucfg = ServiceConfig(
        query=QueryConfig(t_iterations=2, top_k=50, c=UPD_C,
                          hub_split_degree=64, combine_path="sparse"),
        batching=BatchingConfig(max_batch=256, max_wait_s=0.05),
        pipeline=PipelineConfig(depth=4),
        cache=CacheConfig(capacity=2 * UPD_REQUESTS))
    svc = PPRService(g0, None, ucfg, device=dev, maintainer=m)
    if svc.frontier_path != "sparse":
        failures.append(f"3i service routes {svc.frontier_path}")
    reqs = work[:UPD_REQUESTS]
    first, st = svc.run_closed_loop(reqs)
    print("  serve: " + json.dumps({k: st[k] for k in (
        "served", "batches", "wall_s", "qps", "latency_p50", "latency_p99",
        "combine_path", "cache_size", "graphs_captured", "capture_s")}))
    dirty_all = set()
    for b in range(UPD_BATCHES):
        ins = np_rng.integers(0, g.n, size=(UPD_EDGES, 2), dtype=np.int64)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rep = svc.apply_updates(inserts=ins, deletes=pool)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        pool = ins
        dirty_all |= set(rep["dirty_row_ids"].tolist())
        edges = rep["edges_inserted"] + rep["edges_deleted"]
        print(f"  update batch {b}: {wall:.3f} s, {edges / wall:.2f} edges/s, "
              f"{rep['dirty_rows']} dirty rows, {rep['repaired_chunks']} of "
              f"{rep['total_chunks']} chunks repaired, resample ratio "
              f"{rep['resample_ratio']:.3f}, {rep['cache_invalidated']} cache "
              f"entries invalidated, {rep['graphs_captured']} graphs of the "
              f"new engine captured in {rep['capture_s']:.3f} s of it")
    again, st = svc.run_closed_loop(reqs)
    print(f"  serve again: {len(again)} answers, "
          f"{sum(a.cached for a in again)} from the cache; " + json.dumps(
              {k: st[k] for k in ("wall_s", "qps", "latency_p50",
                                  "latency_p99", "updates_applied",
                                  "rows_repaired", "update_rollbacks",
                                  "graphs_captured")}))
    t1 = time.perf_counter()
    rebuilt, rstats = build_index(svc.graph, UPD_R, UPD_L, key, device=dev,
                                  **walk)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t1
    index_equal = (bits_equal(torch, svc.maintainer.index.values, rebuilt.values)
                   and bits_equal(torch, svc.maintainer.index.indices,
                                  rebuilt.indices)
                   and bool(torch.equal(svc.maintainer.touch.bits,
                                        rstats["touch"])))
    fresh, _ = PPRService(svc.graph, rebuilt, ucfg, device=dev).run_closed_loop(
        reqs)
    # each vertex's first answer after the updates: a cache hit there is
    # an entry from before them, which the repair left valid
    before, after, want = (served_bytes(a) for a in (first, again, fresh))
    cached = {v for v, x in after.items() if x[2]}
    computed_ok = all(after[v][:2] == want[v][:2]
                      for v in after if v not in cached)
    cached_ok = (not cached & dirty_all
                 and all(after[v][:2] == before[v][:2] for v in cached))
    stale = sum(after[v][:2] != want[v][:2] for v in cached)
    print(f"  rebuild on the final graph: {rebuild_s:.3f} s; maintained index "
          f"and touch sketch bit-equal to it: {index_equal}; answers computed "
          f"after the updates ({len(after) - len(cached)}) the same bytes as a "
          f"fresh service's on the rebuilt index: {computed_ok}; cached "
          f"answers ({len(cached)}) none of a repaired row and unchanged: "
          f"{cached_ok}, of which {stale} differ from the fresh service's "
          f"(the cache invalidates repaired rows only)")
    if not (index_equal and computed_ok and cached_ok):
        failures.append("maintained index or its answers differ from the "
                        "rebuild's")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print("maintenance-path launches:", json.dumps(counts))
    failures += [f"kernel {k} never launched on the maintenance path"
                 for k in MAINT_PATH if counts[k] <= 0]
    del svc, m, rebuilt, rstats
    return counts


def phase_loadgen(torch, np, dev, g, index, cfg, closed_qps, failures):
    """Phase 3j: the load generator on 3c's service and 3b's index.
    ``run_open_loop`` offers 16,384 uniform requests at 50% and at 90% of
    3c's captured closed-loop qps; then ``bench_cache.py``'s stream
    (``zipf_seed_workload``: seed sets of up to 4, skew 1.1, a pool of
    1,024, a quarter single vertices) closed loop against a sparse-route
    service with ``max_seeds=4`` and an answer cache of 512.  Each
    service captures its widths first (``BatchingConfig.padded_shapes``)
    and then zeroes its counters (``reset_stats``), as the reference's
    benchmarks warm up."""
    from repro_torch.core.query import QueryConfig
    from repro_torch.serving import (CacheConfig, PPRService, ServiceConfig,
                                     run_closed_loop, run_open_loop,
                                     zipf_seed_workload)
    from repro_torch.serving.batching import BatchingConfig
    from repro_torch.serving.pipeline import PipelineConfig

    keys = ("served", "batches", "offered_qps", "qps", "qps_excl_first_batch",
            "latency_p50", "latency_p99", "pad_fraction", "batch_hist",
            "graphs_captured")

    def warmed(svc, seeds):
        t1 = time.perf_counter()
        widths = svc.cfg.batching.padded_shapes()
        svc.engine.capture_shapes([
            ((w, seeds), (w, seeds)) if seeds > 1 else ((w,), None)
            for w in widths])
        torch.cuda.synchronize()
        print(f"  {len(widths)} widths captured in "
              f"{time.perf_counter() - t1:.3f} s, pool "
              f"{svc.engine.graph_pool_bytes()} bytes")
        svc.reset_stats()
        return svc

    work = np.random.default_rng(LOADGEN_SEED).integers(
        0, g.n, LOADGEN_REQUESTS).tolist()
    svc = warmed(PPRService(g, index, cfg, device=dev), 1)
    for share in (0.5, 0.9):
        answers, st = run_open_loop(svc, work, share * closed_qps)
        print(f"  open loop at {share:.0%} of {closed_qps:.1f} qps: "
              + json.dumps({k: st[k] for k in keys}))
        if len(answers) != LOADGEN_REQUESTS or bad_answers(np, answers, g.n):
            failures.append(f"3j open loop at {share:.0%}: answers bad")
        svc.reset_stats()
    del svc
    zcfg = ServiceConfig(
        query=QueryConfig(t_iterations=2, top_k=50, hub_split_degree=64,
                          max_seeds=4),
        batching=BatchingConfig(max_batch=256, min_pad=64, max_wait_s=0.010),
        pipeline=PipelineConfig(depth=2),
        cache=CacheConfig(capacity=512))
    zsvc = warmed(PPRService(g, index, zcfg, device=dev), 4)
    stream = zipf_seed_workload(g.n, LOADGEN_REQUESTS, skew=1.1, max_seeds=4,
                                pool=1024, singles_fraction=0.25,
                                seed=LOADGEN_SEED)
    answers, st = run_closed_loop(zsvc, stream)
    print("  zipf seed-set stream (bench_cache.py's), closed loop: "
          + json.dumps({k: st[k] for k in keys + ("cache_hit_rate",
                                                  "cache_served")}))
    if (len(answers) != LOADGEN_REQUESTS or bad_answers(np, answers, g.n)
            or zsvc.frontier_path != "sparse"):
        failures.append("3j zipf seed-set stream: answers bad")


# -- phase 3q: the rank mesh ------------------------------------------------

def digest(*tensors):
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def rank_tile_config(n, ep, max_deg):
    """3f's tile-step configuration at ``ep`` model shards."""
    from repro_torch.core.distributed_engine import DistConfig

    return DistConfig(n=n, ep=ep, q_tile=256, t_iterations=2,
                      index_l=MAIN_L, top_k=50, degree_cap=max_deg,
                      hub_split_degree=64)


def rank_tiles(torch, np, mesh, cfg, slabs, rows, work, n_tiles):
    """``n_tiles`` tiles of 256 of ``work`` with the sparse tile step of
    ``cfg`` on ``mesh`` from ``slabs`` and ``rows`` (values, indices) of
    the local model shard: ``(tiles, seconds)``."""
    from repro_torch.core.distributed_engine import make_verd_tile_step

    dev = mesh.device
    step = make_verd_tile_step(cfg, mesh)
    work_t = torch.as_tensor(np.asarray(work[:256 * n_tiles]),
                             dtype=torch.int32, device=dev)
    iv, ii = rows[0][None], rows[1][None]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tiles = [step(slabs, work_t[j:j + 256], iv, ii)
             for j in range(0, work_t.shape[0], 256)]
    torch.cuda.synchronize(dev)
    return tiles, time.perf_counter() - t0


def save_shard(path, slabs, rows):
    """A model shard's slabs and index rows, for the NCCL ranks."""
    import numpy as np

    np.savez(path, values=rows[0].cpu().numpy(),
             indices=rows[1].cpu().numpy(),
             **{k: getattr(slabs, k).cpu().numpy()
                for k in ("row_ptr", "col_idx", "edge_w", "dangling")})


def rank_service(torch, mesh, g, index, work):
    """3q's rank service: ``work`` through ``PPRService`` over the rank's
    ``index`` on the ``1 x ep`` ``mesh`` (the leader), or this shard's
    rows to the leader until it closes (a follower); a record of it."""
    from repro_torch.kernels import ops
    from repro_torch.launch.ranks import (service_answers_digest,
                                          service_config)
    from repro_torch.serving import PPRService
    from repro_torch.serving.engine import serve_follower

    t0 = time.perf_counter()
    if not index.is_leader:
        res = serve_follower(g, index, mesh)
        return dict(row_requests=res["row_requests"],
                    shard_rows=index.n_shard,
                    seconds=time.perf_counter() - t0)
    svc = PPRService(g, index, service_config(256), device=mesh.device,
                     mesh=mesh)
    ops.reset_launch_counts()
    answers, st = svc.run_closed_loop(work)
    torch.cuda.synchronize(mesh.device)
    counts = ops.launch_counts()
    svc.close()
    return dict(answers=service_answers_digest(answers), served=len(answers),
                qps=st["qps"], p50_ms=1e3 * st["latency_p50"],
                p99_ms=1e3 * st["latency_p99"], batches=st["batches"],
                exchange_rows=st["exchange_rows"],
                exchange_rows_crossed=st["exchange_rows_crossed"],
                exchange_bytes=st["exchange_bytes_crossed"],
                graphs_captured=st["graphs_captured"],
                shard_rows=index.n_shard, launches=counts,
                seconds=time.perf_counter() - t0)


def small_stack_inputs(g):
    """3q (ii)'s service, requests and update batch on rmat(14), from a
    seed: 4 fresh edges and 4 of the graph's deleted, all out of vertices
    no edge enters, so few rows' walks pass them and the repair resamples
    some chunks of each shard, not all."""
    import numpy as np

    from repro_torch.launch.ranks import service_config

    r = np.random.default_rng(UPD_SEED)
    src, dst = g.src.cpu().numpy(), g.col_idx.cpu().numpy()
    unreached = np.bincount(dst, minlength=g.n) == 0
    gone = r.choice(np.flatnonzero(unreached[src]), UPD_EDGES,
                    replace=False)
    ins = np.stack([r.choice(np.flatnonzero(unreached), UPD_EDGES),
                    r.integers(0, g.n, UPD_EDGES)], axis=1)
    cfg = service_config(256)
    cfg.query.combine_path = "sparse"
    return (cfg, r.integers(0, g.n, SMALL_REQUESTS).tolist(), ins,
            np.stack([src[gone], dst[gone]], axis=1))


def report_summary(report):
    """A repair report's JSON fields, its dirty rows digested (not its
    times, nor the cache's)."""
    out = {k: v for k, v in report.items() if k not in (
        "dirty_row_ids", "capture_s", "graphs_captured",
        "cache_invalidated")}
    out["dirty_row_ids"] = hashlib.sha256(
        report["dirty_row_ids"].tobytes()).hexdigest()
    return out


def small_stack_rank(torch, mesh, service_mesh, out_dir):
    """3q (ii) on a rank: rmat(14)'s checkpointed maintainable build on
    the ``RANK_DATA x DIST_EP`` mesh, crashed after its one partial commit
    and resumed; then on the first data replica (``service_mesh``, else
    ``None``) one update batch through the leader's ``apply_updates`` and
    ``SMALL_REQUESTS`` served, and a service booted from the checkpoint
    serving them.  Returns a record of digests."""
    from repro_torch import rng
    from repro_torch.core.updates import build_maintainable_index
    from repro_torch.graphs import synthetic
    from repro_torch.launch.ranks import service_answers_digest
    from repro_torch.serving import PPRService
    from repro_torch.serving.engine import serve_follower
    from repro_torch.testing import FaultPlan, InjectedFault

    t0 = time.perf_counter()
    dev = mesh.device
    g = synthetic.rmat(SMALL_N_LOG2, avg_deg=10.0, seed=0, device=dev)
    ckpt = os.path.join(out_dir, "small-ckpt")
    kw = dict(SMALL_STACK, key=rng.prng_key(0), mesh=mesh,
              checkpoint_dir=ckpt, checkpoint_every=SMALL_CKPT_EVERY)
    try:
        build_maintainable_index(g, fault_plan=FaultPlan(
            raise_at_chunks=(SMALL_CKPT_EVERY,)), **kw)
        crashed = False
    except InjectedFault:
        crashed = True
    m, stats = build_maintainable_index(g, resume=True, **kw)
    torch.cuda.synchronize(dev)
    rec = dict(crashed=crashed, resumed_at=stats["resumed_at_chunk"],
               rows=digest(m.index.values, m.index.indices),
               touch=digest(m.touch.bits), kept_mass=stats["kept_mass"],
               build_s=time.perf_counter() - t0)
    if service_mesh is None:
        return rec
    t0 = time.perf_counter()
    cfg, work, ins, dele = small_stack_inputs(g)
    if m.index.is_leader:
        svc = PPRService(g, None, cfg, device=dev, mesh=service_mesh,
                         maintainer=m)
        rec["report"] = report_summary(svc.apply_updates(inserts=ins,
                                                         deletes=dele))
        answers, _ = svc.run_closed_loop(work)
        rec["answers"] = service_answers_digest(answers)
        svc.close()
        final = svc.maintainer
    else:
        final = serve_follower(g, None, service_mesh,
                               maintainer=m)["maintainer"]
    rec["repaired"] = digest(final.index.values, final.index.indices,
                             final.touch.bits)
    rec["update_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if m.index.is_leader:
        svc = PPRService.from_checkpoint(g, ckpt, cfg, device=dev,
                                         mesh=service_mesh)
        answers, _ = svc.run_closed_loop(work)
        rec["booted"] = service_answers_digest(answers)
        svc.close()
    else:
        serve_follower(g, None, service_mesh, checkpoint_dir=ckpt)
    rec["boot_s"] = time.perf_counter() - t0
    return rec


def small_stack_stacked(torch, dev, ckpt):
    """3q (ii)'s yardsticks on ``ShardMesh(RANK_DATA, DIST_EP)`` in this
    process: each model shard's rows and filters after the crash and the
    resume and after the update, the report, and the answers after the
    update and of the booted service."""
    import numpy as np

    from repro_torch import rng
    from repro_torch.core.updates import build_maintainable_index
    from repro_torch.distributed import ShardMesh
    from repro_torch.graphs import synthetic
    from repro_torch.launch.ranks import service_answers_digest
    from repro_torch.serving import PPRService
    from repro_torch.testing import FaultPlan, InjectedFault

    t0 = time.perf_counter()
    g = synthetic.rmat(SMALL_N_LOG2, avg_deg=10.0, seed=0, device=dev)
    kw = dict(SMALL_STACK, key=rng.prng_key(0),
              mesh=ShardMesh(RANK_DATA, DIST_EP, device=dev),
              checkpoint_dir=ckpt, checkpoint_every=SMALL_CKPT_EVERY)
    try:
        build_maintainable_index(g, fault_plan=FaultPlan(
            raise_at_chunks=(SMALL_CKPT_EVERY,)), **kw)
    except InjectedFault:
        pass
    m, stats = build_maintainable_index(g, resume=True, **kw)
    ns = m.index.n // DIST_EP

    def shards(m, touch):
        return [digest(m.index.values[j * ns:(j + 1) * ns],
                       m.index.indices[j * ns:(j + 1) * ns],
                       *((m.touch.bits[j * ns:(j + 1) * ns],) if touch
                         else ()))
                for j in range(DIST_EP)]

    yard = dict(rows=shards(m, False), kept_mass=stats["kept_mass"],
                resumed_at=stats["resumed_at_chunk"],
                touch=[digest(m.touch.bits[j * ns:(j + 1) * ns])
                       for j in range(DIST_EP)])
    cfg, work, ins, dele = small_stack_inputs(g)
    svc = PPRService(g, None, cfg, device=dev, maintainer=m)
    report = svc.apply_updates(inserts=ins, deletes=dele)
    yard["report"] = report_summary(report)
    yard["answers"] = service_answers_digest(svc.run_closed_loop(work)[0])
    yard["repaired"] = shards(svc.maintainer, True)
    # a selective repair: some chunks resampled, the others' rows kept
    sb = SMALL_STACK["source_batch"]
    kept = torch.ones(m.index.n, dtype=torch.bool, device=dev)
    for c in np.unique(report["dirty_row_ids"] // sb):
        kept[c * sb:(c + 1) * sb] = False
    after = svc.maintainer.index
    yard["selective"] = bool(
        0 < report["repaired_chunks"] < report["total_chunks"]
        and torch.equal(after.values[kept], m.index.values[kept])
        and torch.equal(after.indices[kept], m.index.indices[kept]))
    boot = PPRService.from_checkpoint(g, ckpt, cfg, device=dev)
    yard["booted"] = service_answers_digest(boot.run_closed_loop(work)[0])
    del svc, boot
    torch.cuda.synchronize(dev)
    yard["seconds"] = time.perf_counter() - t0
    return yard


def rank_mesh_rank(rank, world, out_dir, work, fingerprint, max_deg,
                   spawn_t0, save_rows):
    """One process of phase 3q's gloo run (spawned): a shard of the
    ``RANK_DATA x DIST_EP`` mesh on ``cuda:0``; writes ``rank{r}.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import rng
    from repro_torch.core.distributed_engine import build_sharded_graph
    from repro_torch.core.graph import graph_fingerprint
    from repro_torch.core.index import build_index_sharded
    from repro_torch.distributed import RankMesh
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.ranks import answers_digest

    mesh = make_rank_mesh(
        RANK_DATA, DIST_EP, backend="gloo", device="cuda:0",
        timeout_s=RANK_TIMEOUT_S, rank=rank, world_size=world,
        init_method="file://" + os.path.join(out_dir, "store"))
    dev = mesh.device
    rec = dict(rank=rank, shard=[mesh.local_data[0], mesh.local_model[0]],
               ready_s=time.time() - spawn_t0)
    t0 = time.perf_counter()
    g = synthetic.rmat(MAIN_N_LOG2, avg_deg=10.0, seed=0, device=dev)
    rec["graph_s"] = time.perf_counter() - t0
    rec["fingerprint_equal"] = graph_fingerprint(g) == fingerprint
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    index, stats = build_index_sharded(
        g, r=MAIN_R, l=MAIN_L, key=rng.prng_key(0), mesh=mesh,
        source_batch=MAIN_SOURCE_BATCH, respawn=True)
    torch.cuda.synchronize(dev)
    rec.update(build_s=time.perf_counter() - t0,
               rows=digest(index.values, index.indices),
               row_offset=stats["row_offset"], kept_mass=stats["kept_mass"],
               dropped_mass=stats["dropped_mass"])
    if mesh.local_data[0] == 0:     # the first replica answers the tiles
        tile_mesh = RankMesh(1, DIST_EP, dev, ranks=range(DIST_EP),
                             timeout_s=RANK_TIMEOUT_S)
        cfg = rank_tile_config(g.n, DIST_EP, max_deg)
        slabs = build_sharded_graph(g, cfg, device=dev,
                                    shards=tile_mesh.local_model)
        rows = (index.values, index.indices)
        tiles, tiles_s = rank_tiles(torch, np, tile_mesh, cfg, slabs, rows,
                                    work, len(work) // 256)
        rec.update(tiles_s=tiles_s, n_tiles=len(tiles),
                   answers=answers_digest(tiles),
                   answers_sane=all(bool(torch.isfinite(v).all())
                                    and not bool((v < 0).any())
                                    for v, _ in tiles))
        if save_rows:               # the NCCL ranks' shards on four cards
            save_shard(os.path.join(out_dir, f"shard{rank}.npz"), slabs,
                       rows)
        del slabs
    rec["launches"] = ops.launch_counts()
    if mesh.local_data[0] == 0:     # (i) the rank service from these rows
        rec["serve"] = rank_service(
            torch, tile_mesh, g, index,
            [int(v) for v in work[:RANK_SERVE_REQUESTS]])
    del g, index
    torch.cuda.empty_cache()
    rec["small"] = small_stack_rank(                  # (ii)
        torch, mesh, tile_mesh if mesh.local_data[0] == 0 else None,
        out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def rank_mesh_nccl_rank(rank, world, out_dir, work, max_deg, n, n_tiles,
                        n_serve):
    """One process of phase 3q's NCCL run (spawned): a ``1 x world``
    ``RankMesh`` over NCCL, rank ``r`` on ``cuda:r``, answering
    ``n_tiles`` tiles from the slabs and rows in ``shard{r}.npz``, then
    serving ``n_serve`` requests through the rank service over those rows
    (the graph from ``graph.npz``); writes ``nccl{r}.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed_engine import ShardedGraph
    from repro_torch.core.graph import Graph
    from repro_torch.core.index import PPRIndex, RankIndex
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.ranks import answers_digest

    mesh = make_rank_mesh(
        1, world, backend="nccl", device=f"cuda:{rank}",
        timeout_s=RANK_TIMEOUT_S, rank=rank, world_size=world,
        init_method="file://" + os.path.join(out_dir, "nccl-store"))
    dev = mesh.device
    shard = {k: torch.from_numpy(v).to(dev) for k, v in np.load(
        os.path.join(out_dir, f"shard{rank}.npz")).items()}
    slabs = ShardedGraph(**{k: shard[k] for k in (
        "row_ptr", "col_idx", "edge_w", "dangling")})
    ops.reset_launch_counts()
    tiles, tiles_s = rank_tiles(
        torch, np, mesh, rank_tile_config(n, world, max_deg), slabs,
        (shard["values"], shard["indices"]), work, n_tiles)
    rec = dict(rank=rank, backend=mesh.backend, tiles_s=tiles_s,
               n_tiles=len(tiles), answers=answers_digest(tiles),
               launches=ops.launch_counts())
    del slabs, tiles
    arrays = {k: torch.from_numpy(v).to(dev) for k, v in np.load(
        os.path.join(out_dir, "graph.npz")).items()}
    g = Graph(n=n, m=int(arrays["col_idx"].shape[0]), **arrays)
    rows = shard["values"].shape[0]
    index = RankIndex(rows=PPRIndex(values=shard["values"],
                                    indices=shard["indices"], l=MAIN_L,
                                    n=rows * world),
                      row_offset=rank * rows, mesh=mesh)
    rec["serve"] = rank_service(torch, mesh, g, index,
                                [int(v) for v in work[:n_serve]])
    with open(os.path.join(out_dir, f"nccl{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_rank_mesh(torch, np, dev, g, index, work, max_deg, yard,
                    failures):
    """Phase 3q: 3f's build, tile step and service one shard a process,
    and the small stack's checkpointed build, repair and boot (the module
    docstring), against ``yard``: 3f's rows digested by model shard, its
    totals, its stacked answers over the same tiles and its stacked
    service's.  Returns the gloo ranks' summed launch counts and the rank
    service leader's."""
    from repro_torch.core.distributed_engine import build_sharded_graph
    from repro_torch.core.graph import graph_fingerprint
    from repro_torch.distributed import ShardMesh
    from repro_torch.launch.ranks import (answers_digest,
                                          service_answers_digest,
                                          service_config, spawn)
    from repro_torch.serving import PPRService

    world = RANK_DATA * DIST_EP
    cards = torch.cuda.device_count()
    out_dir = tempfile.mkdtemp(prefix="rank-mesh-")
    label = ("8 processes time-sliced on one card, collectives through "
             "gloo and host memory")
    try:
        t0 = time.perf_counter()
        small = small_stack_stacked(torch, dev, os.path.join(
            out_dir, "small-stacked-ckpt"))
        print(f"3q (ii) yardsticks: the small stack on ShardMesh("
              f"{RANK_DATA}, {DIST_EP}) at rmat({SMALL_N_LOG2}) in "
              f"{time.perf_counter() - t0:.3f} s")
        t0 = time.time()
        try:
            seconds = spawn(rank_mesh_rank, world, (
                world, out_dir, np.asarray(work, np.int32),
                graph_fingerprint(g), max_deg, t0, cards >= DIST_EP),
                join_timeout_s=RANK_JOIN_S)
        except Exception as e:  # noqa: BLE001 - a failure of the phase
            failures.append(f"3q: the gloo ranks failed: {e!r}"[-3000:])
            print(f"3q: the gloo ranks failed: {e}", flush=True)
            return {}, {}
        recs = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        ns = g.n // DIST_EP
        print(f"3q: {card_name_and_power_limit()}; {world} ranks "
              f"({RANK_DATA} x {DIST_EP}) over gloo on cuda:0, run in "
              f"{seconds:.3f} s; spawned and joined in "
              f"{min(x['ready_s'] for x in recs):.3f}.."
              f"{max(x['ready_s'] for x in recs):.3f} s; the graph made in "
              f"{min(x['graph_s'] for x in recs):.3f}.."
              f"{max(x['graph_s'] for x in recs):.3f} s")
        for x in recs:
            d, m = x["shard"]
            ok = dict(
                graph=x["fingerprint_equal"],
                rows=x["rows"] == yard["rows"][m],
                offset=x["row_offset"] == m * ns,
                totals=all(abs(x[k] - yard[k]) <= 1e-6 * max(abs(yard[k]),
                                                               1.0)
                           for k in ("kept_mass", "dropped_mass")),
                walk_step=x["launches"]["walk_step"] > 0,
                push=x["launches"]["sharded_frontier_push"] == (
                    2 * x["n_tiles"] if d == 0 else 0))
            print(f"3q: rank {x['rank']} (data {d}, model {m}): build "
                  f"{x['build_s']:.3f} s, rows bit-equal to 3f's "
                  f"{ok['rows']}, totals {x['kept_mass']!r} / "
                  f"{x['dropped_mass']!r} (3f {yard['kept_mass']!r} / "
                  f"{yard['dropped_mass']!r}), launches "
                  f"{json.dumps(x['launches'])}")
            failures += [f"3q rank {x['rank']}: {k}"
                         for k, v in ok.items() if not v]
        tile_recs = [x for x in recs if x["shard"][0] == 0]
        answers = {x["answers"] for x in tile_recs}
        same = answers == {yard["answers"]}
        tiles_s = max(x["tiles_s"] for x in tile_recs)
        n_tiles = tile_recs[0]["n_tiles"]
        print(f"3q: tile step on ranks 0-{DIST_EP - 1}: {MAIN_REQUESTS} "
              f"requests in {n_tiles} tiles of 256, {tiles_s:.3f} s: "
              f"{1e3 * tiles_s / n_tiles:.3f} ms a tile, "
              f"{MAIN_REQUESTS / tiles_s:.1f} requests/s ({label}); answers "
              f"the same bytes on every rank and as 3f's stacked step on "
              f"the same rows: {same}")
        if not same or not all(x["answers_sane"] for x in tile_recs):
            failures.append("3q: rank tile answers differ from the stacked "
                            "step's or are not finite and non-negative")
        counts = {}
        for x in recs:
            for k, v in x["launches"].items():
                counts[k] = counts.get(k, 0) + v

        # (i) the rank service over the rows the ranks built
        lead = recs[0]["serve"]
        same = lead["answers"] == yard["service"]
        ok = dict(
            answers=same,
            launched=all(lead["launches"][k] > 0 for k in RANK_SERVE_PATH),
            uncaptured=lead["graphs_captured"] == 0,
            shard_rows=all(x["serve"]["shard_rows"] == ns
                           for x in tile_recs),
            followers=all(x["serve"]["row_requests"] == lead["batches"]
                          for x in tile_recs[1:]))
        print(f"3q (i): rank service on ranks 0-{DIST_EP - 1} "
              f"(RankMesh(1, {DIST_EP}), {label}): "
              f"{lead['served']} of 3c's requests in {lead['batches']} "
              f"batches of up to 256, {lead['seconds']:.3f} s: "
              f"{lead['qps']:.1f} qps, p50 {lead['p50_ms']:.3f} ms, p99 "
              f"{lead['p99_ms']:.3f} ms; rows crossed "
              f"{lead['exchange_bytes'] / max(lead['batches'], 1):.0f} bytes "
              f"a batch, the followers' blocks padded to the longest ("
              f"{lead['exchange_rows'] / max(lead['batches'], 1):.0f} rows "
              f"gathered a batch, "
              f"{lead['exchange_rows_crossed'] / max(lead['batches'], 1):.0f}"
              f" of them the followers', each of {MAIN_L * 8} bytes); every "
              f"rank's index {ns} rows; answers the same bytes as 3f's "
              f"stacked PPRService on the assembled index: {same}; leader "
              f"launches {json.dumps(lead['launches'])}")
        failures += [f"3q (i) rank service: {k}" for k, v in ok.items()
                     if not v]

        # (ii) the small stack
        bad = []
        for x in recs:
            d, m = x["shard"]
            got = x["small"]
            ok = dict(crashed=got["crashed"],
                      resumed=got["resumed_at"] == small["resumed_at"],
                      rows=got["rows"] == small["rows"][m],
                      touch=got["touch"] == small["touch"][m],
                      kept=got["kept_mass"] == small["kept_mass"])
            if d == 0:
                ok["repaired"] = got["repaired"] == small["repaired"][m]
            if x["rank"] == 0:
                ok.update(selective=small["selective"],
                          report=got["report"] == small["report"],
                          answers=got["answers"] == small["answers"],
                          booted=got["booted"] == small["booted"])
            bad += [f"rank {x['rank']} {k}" for k, v in ok.items() if not v]
        lead = recs[0]["small"]
        build_s = max(x["small"]["build_s"] for x in recs)
        print(f"3q (ii): the small stack at rmat({SMALL_N_LOG2}) on the "
              f"same ranks, {build_s + lead['update_s'] + lead['boot_s']:.3f}"
              f" s (build, crash and resume {build_s:.3f} s; update and "
              f"{SMALL_REQUESTS} requests {lead['update_s']:.3f} s; boot and "
              f"{SMALL_REQUESTS} requests {lead['boot_s']:.3f} s): crashed "
              f"after its partial commit, resumed at chunk "
              f"{lead['resumed_at']}; report {json.dumps(lead['report'])}; "
              f"rows, filters, report and answers bit-equal to ShardMesh("
              f"{RANK_DATA}, {DIST_EP})'s: {not bad}")
        failures += [f"3q (ii) small stack: {b}" for b in bad]

        # (iii) NCCL: one rank a card
        t0 = time.perf_counter()
        np.savez(os.path.join(out_dir, "graph.npz"),
                 **{k: getattr(g, k).cpu().numpy()
                    for k in ("row_ptr", "col_idx", "src", "out_deg")})
        nccl_world = DIST_EP if cards >= DIST_EP else 1
        if nccl_world == 1:
            cfg = rank_tile_config(g.n, 1, max_deg)
            slabs = build_sharded_graph(g, cfg, device=dev)
            rows = (index.values, index.indices)
            save_shard(os.path.join(out_dir, "shard0.npz"), slabs, rows)
            stacked, _ = rank_tiles(torch, np, ShardMesh(1, 1, device=dev),
                                    cfg, slabs, rows, work, RANK_NCCL_TILES)
            want, n_nccl = answers_digest(stacked), RANK_NCCL_TILES
            del stacked, slabs
            n_serve = RANK_NCCL_REQUESTS
            want_serve = service_answers_digest(PPRService(
                g, index, service_config(256), device=dev).run_closed_loop(
                    work[:n_serve])[0])
            what = f"ShardMesh(1, 1) on 3b's index, {n_nccl} tiles"
            what_serve = "a one-device PPRService on 3b's index"
        else:
            want, n_nccl = yard["answers"], n_tiles
            n_serve, want_serve = RANK_SERVE_REQUESTS, recs[0]["serve"][
                "answers"]
            what = f"the gloo ranks, {n_nccl} tiles"
            what_serve = "the gloo ranks' service"
        try:
            nccl_s = spawn(rank_mesh_nccl_rank, nccl_world, (
                nccl_world, out_dir, np.asarray(work, np.int32), max_deg,
                g.n, n_nccl, n_serve), join_timeout_s=RANK_JOIN_S)
        except Exception as e:  # noqa: BLE001 - a failure of the phase
            failures.append(f"3q: the NCCL ranks failed: {e!r}"[-3000:])
            print(f"3q: the NCCL ranks failed: {e}", flush=True)
            return counts, recs[0]["serve"]["launches"]
        nccl = []
        for r in range(nccl_world):
            with open(os.path.join(out_dir, f"nccl{r}.json")) as f:
                nccl.append(json.load(f))
        same = {x["answers"] for x in nccl} == {want}
        push_ok = all(x["launches"]["sharded_frontier_push"]
                      == 2 * n_nccl for x in nccl)
        print(f"3q: 1 x {nccl_world} RankMesh over {nccl[0]['backend']} "
              f"({nccl_world} card{'s' if nccl_world > 1 else ''}), run in "
              f"{nccl_s:.3f} s: {n_nccl} tiles in "
              f"{max(x['tiles_s'] for x in nccl):.3f} s; the same bytes as "
              f"{what}: {same}; sharded_frontier_push 2 a tile: {push_ok}")
        if not same or not push_ok:
            failures.append(f"3q: the NCCL tiles differ from {what}")
        lead = nccl[0]["serve"]
        same = lead["answers"] == want_serve
        print(f"3q (iii): rank service over {nccl[0]['backend']} (1 x "
              f"{nccl_world}): {lead['served']} requests in "
              f"{lead['seconds']:.3f} s, {lead['qps']:.1f} qps, p50 "
              f"{lead['p50_ms']:.3f} ms, p99 {lead['p99_ms']:.3f} ms; the "
              f"same bytes as {what_serve}: {same}; step "
              f"{time.perf_counter() - t0:.3f} s")
        if not same:
            failures.append(f"3q (iii): the NCCL service differs from "
                            f"{what_serve}")
        return counts, recs[0]["serve"]["launches"]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import rng
    from repro_torch.core.distributed_engine import (
        DistConfig, build_sharded_graph, exchange_bytes_per_iteration,
        make_verd_tile_step)
    from repro_torch.core.frontier import topk_dense
    from repro_torch.core.index import (build_index, build_index_sharded,
                                        sparse_chunk_estimates)
    from repro_torch.core.metrics import (is_stochastic, mean_rag,
                                          precision_at_k)
    from repro_torch.core.query import BatchQueryEngine, QueryConfig
    from repro_torch.distributed import ShardMesh
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import build, ops
    from repro_torch.launch.ranks import (answers_digest,
                                          service_answers_digest,
                                          service_config)
    from repro_torch.serving import PPRService, ServiceConfig
    from repro_torch.serving.batching import BatchingConfig
    from repro_torch.serving.pipeline import PipelineConfig

    print(card_name_and_power_limit(), flush=True)
    run_t0 = time.perf_counter()
    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0], flush=True)
    failures = []

    t0 = time.perf_counter()
    build.build()
    for name, log in sorted(build.build_log.items()):
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"nvcc {name}: {' | '.join(regs)}")
    phase("1 build kernels", t0)

    t0 = time.perf_counter()
    synth = {name: check(torch, np, dev)
             for name, check in SYNTHETIC_CHECKS.items()}
    torch.cuda.synchronize()
    print("synthetic bit-equal:", json.dumps(synth))
    failures += [f"synthetic {k}" for k, v in synth.items() if not v]
    phase("2a kernel vs plain, synthetic", t0)

    t0 = time.perf_counter()
    g = synthetic.rmat(MAIN_N_LOG2, avg_deg=10.0, seed=0, device=dev)
    max_deg = int(g.out_deg.max())
    print(f"graph rmat({MAIN_N_LOG2}): n={g.n} m={g.m} max_out_degree="
          f"{max_deg}")
    phase("3a graph", t0)

    ops.reset_launch_counts()
    ops.capture_first_launches(True)
    t0 = time.perf_counter()
    index, stats = build_index(
        g, r=MAIN_R, l=MAIN_L, key=rng.prng_key(0),
        source_batch=MAIN_SOURCE_BATCH, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print("index:", json.dumps({k: stats[k] for k in (
        "r", "l", "sketch_l", "source_batch", "kept_mass", "dropped_mass",
        "drop_fraction", "nbytes")}))
    print(f"build seconds: {build_s:.3f}")
    phase("3b build_index", t0)

    t0 = time.perf_counter()
    cfg = ServiceConfig(
        query=QueryConfig(t_iterations=2, top_k=50, hub_split_degree=64),
        batching=BatchingConfig(max_batch=256, max_wait_s=0.05),
        pipeline=PipelineConfig(depth=4),
    )
    svc = PPRService(g, index, cfg, device=dev)
    eng = svc.engine
    route = dict(frontier_path=svc.frontier_path, frontier_k=eng.frontier_k,
                 scatter_combine_at_256=eng.uses_scatter_combine(256))
    print("route:", json.dumps(route))
    if route["frontier_path"] != "sparse" or route["scatter_combine_at_256"]:
        failures.append(f"route {route}")
    work = np.random.default_rng(1).integers(0, g.n, MAIN_REQUESTS).tolist()
    answers, sstats = svc.run_closed_loop(work)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    captured_s = ops.captured_launches()
    ops.capture_first_launches(False)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("serve:", json.dumps({k: sstats[k] for k in SERVE_KEYS}))
    print("main-path launches:", json.dumps(counts))
    failures += [f"kernel {k} never launched on the sparse main path"
                 for k in SPARSE_PATH if counts[k] <= 0]
    bad = bad_answers(np, answers, g.n)
    if len(answers) != MAIN_REQUESTS or bad:
        failures.append(f"answers: {len(answers)} served, {len(bad)} bad")
    mass = np.array([a.top_scores.sum() for a in answers])
    print(f"answer mass: min {mass.min():.6f} mean {mass.mean():.6f} "
          f"max {mass.max():.6f}")
    src256 = torch.tensor(work[:256], dtype=torch.int32, device=dev)
    for how, fn in (("eager", lambda: eng.query_topk(src256)),
                    ("captured", lambda: eng.query_topk_async(src256))):
        wall_ms, device_ms, split = device_time_split(torch, fn)
        print(f"sparse batch of 256, {how}, device time by kernel "
              f"(torch.profiler): wall {wall_ms:.3f} ms, device busy "
              f"{device_ms:.3f} ms, idle "
              f"{100 * (1 - device_ms / wall_ms):.1f}% of the wall")
        for name, ms in split:
            print(f"  {ms:9.3f} ms  {100 * ms / max(device_ms, 1e-9):5.1f}%  "
                  f"{name[:110]}")
    print("sparse route, captured against eager on the same requests:")
    _, sparse_ab, _ = captured_vs_eager(
        torch, np, lambda depth: PPRService(g, index, ServiceConfig(
            query=cfg.query, batching=cfg.batching,
            pipeline=PipelineConfig(depth=depth)), device=dev),
        work, "sparse", failures, depth1_requests=MAIN_REQUESTS // 4)
    phase("3c serve", t0)

    # -- 3b's breakdown, outside the counted run: one build chunk ---------
    t0 = time.perf_counter()
    chunk = torch.arange(MAIN_SOURCE_BATCH, dtype=torch.int32, device=dev)
    walks0 = ops.launch_counts()["walk_step"]
    wall_ms, device_ms, split = device_time_split(
        torch, lambda: sparse_chunk_estimates(
            g, chunk, rng.fold_in(rng.prng_key(0), 0), r=MAIN_R, l=MAIN_L,
            sketch_l=stats["sketch_l"]), top=None)
    walk_launches = ops.launch_counts()["walk_step"] - walks0
    walk_ms = sum(ms for name, ms in split if "walk_step" in name)
    print(f"build chunk of {MAIN_SOURCE_BATCH} sources, device time by "
          f"kernel (torch.profiler): wall {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms, idle {100 * (1 - device_ms / wall_ms):.1f}% "
          f"of the wall; walk_step {walk_ms:.3f} ms in {walk_launches} "
          f"launches ({walk_ms / max(walk_launches, 1):.4f} ms a launch, "
          f"{100 * walk_ms / max(device_ms, 1e-9):.1f}% of the busy time)")
    for name, ms in split[:10]:
        print(f"  {ms:9.3f} ms  {100 * ms / max(device_ms, 1e-9):5.1f}%  "
              f"{name[:110]}")
    phase("3b' build chunk breakdown", t0)

    # -- 3d: the dense route on the same graph and index ---------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dcfg = ServiceConfig(
        query=QueryConfig(t_iterations=2, top_k=50),
        batching=BatchingConfig(max_batch=256, max_wait_s=0.05),
        pipeline=PipelineConfig(depth=4),
    )
    svc_d = PPRService(g, index, dcfg, device=dev)
    eng_d = svc_d.engine
    t1 = time.perf_counter()
    ell = eng_d.graph.ell()
    torch.cuda.synchronize()
    print(f"ELL view: rows {ell.rows_used} x {ell.k}, built in "
          f"{time.perf_counter() - t1:.3f} s")
    t1 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cols = eng_d.index.columns(g.n, g.n)
    torch.cuda.synchronize()
    print(f"index column view: {cols.ent_v.numel()} entries, "
          f"{cols.tasks.shape[0]} split tasks in {cols.heavy.shape[0]} "
          f"columns, {cols.nbytes / 2**30:.3f} GiB, built in "
          f"{time.perf_counter() - t1:.3f} s, its build's peak "
          f"{(torch.cuda.max_memory_allocated() - before) / 2**30:.2f} GiB "
          f"above the {before / 2**30:.2f} GiB allocated before it")
    del cols
    torch.cuda.reset_peak_memory_stats()
    route_d = dict(frontier_path=svc_d.frontier_path,
                   hub_split_degree=dcfg.query.hub_split_degree,
                   gather_width=eng_d.effective_gather_width(),
                   frontier_k=eng_d.frontier_k)
    print("dense route:", json.dumps(route_d))
    if route_d["frontier_path"] != "dense":
        failures.append(f"dense route {route_d}")
    ops.reset_launch_counts()
    ops.capture_first_launches(True)
    answers_d, dstats = svc_d.run_closed_loop(work)
    torch.cuda.synchronize()
    counts_d = ops.launch_counts()
    captured = ops.captured_launches()
    ops.capture_first_launches(False)
    print(f"peak device memory (dense route, serving with its views "
          f"built): {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("serve dense:", json.dumps({k: dstats[k] for k in SERVE_KEYS}))
    print("dense-path launches:", json.dumps(counts_d))
    # every batch is a replay of its width's graph, and every graph's
    # capture made one eager warm-up batch
    batches = int(dstats["batches"]) + len(eng_d.graphs)
    want = {"ell_spmm": 2 * batches, "index_combine": batches}
    failures += [f"dense path: {k} launched {counts_d[k]} times, want {v}"
                 for k, v in want.items() if counts_d[k] != v]
    bad = bad_answers(np, answers_d, g.n)
    if len(answers_d) != MAIN_REQUESTS or bad:
        failures.append(f"dense answers: {len(answers_d)} served, "
                        f"{len(bad)} bad")
    mass = np.array([a.top_scores.sum() for a in answers_d])
    print(f"dense answer mass: min {mass.min():.6f} mean {mass.mean():.6f} "
          f"max {mass.max():.6f}")
    batch_ms = cuda_ms(torch, lambda: eng_d.query_topk(src256), max_reps=5)
    out256 = eng_d.query_dense(src256)
    topk_ms = cuda_ms(torch, lambda: topk_dense(out256, 50), max_reps=10)
    sort_ms = cuda_ms(torch, lambda: torch.sort(
        out256, dim=1, descending=True, stable=True), max_reps=3)
    print(f"dense batch of 256: query_topk {batch_ms:.3f} ms, of which "
          f"top-50 of [256, {g.n}] {topk_ms:.3f} ms "
          f"({100 * topk_ms / batch_ms:.1f}%); a stable sort of the same "
          f"rows {sort_ms:.3f} ms")
    del out256
    wall_ms, device_ms, split = device_time_split(
        torch, lambda: eng_d.query_topk(src256))
    print(f"dense batch of 256, device time by kernel (torch.profiler): "
          f"wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms")
    for name, ms in split:
        print(f"  {ms:9.3f} ms  {100 * ms / max(device_ms, 1e-9):5.1f}%  "
              f"{name[:110]}")
    eng_d.graphs.clear()     # 3e queries eng_d eagerly: free its pool
    torch.cuda.empty_cache()
    print("dense route, captured against eager on the same requests:")
    captured_vs_eager(
        torch, np, lambda depth: PPRService(g, index, ServiceConfig(
            query=dcfg.query, batching=dcfg.batching,
            pipeline=PipelineConfig(depth=depth)), device=dev),
        work[:MAIN_REQUESTS // 4], "dense", failures,
        depth1_requests=MAIN_REQUESTS // 16)
    phase("3d serve, dense route", t0)

    # -- 3e: the baselines against power iteration ---------------------------
    t0 = time.perf_counter()
    src64 = src256[:E_ROWS]
    eng_pi = BatchQueryEngine(g, None, QueryConfig(
        mode="pi", top_k=50, pi_iterations=100), device=dev)
    # the last push of pi is ell_spmm's input at its densest: keep it
    ops.reset_launch_counts()
    ops.capture_first_launches(True, last=True)
    truth = eng_pi.query_dense(src64)
    captured_e = {"ell_spmm/dense": ops.captured_launches()["ell_spmm/later"]}
    ops.capture_first_launches(False)
    pi_ms = cuda_ms(torch, lambda: eng_pi.query_dense(src64), max_reps=3)
    print(f"pi batch of {E_ROWS} ({eng_pi.config.pi_iterations} iterations, "
          f"as many ell_spmm launches): {pi_ms:.3f} ms")
    stochastic = is_stochastic(truth, atol=1e-4)
    print(f"pi: {int(stochastic.sum())} of {E_ROWS} rows stochastic; row "
          f"mass {float(truth.sum(1).min()):.7f}.."
          f"{float(truth.sum(1).max()):.7f}")
    mass_off = float((truth.sum(1) - 1.0).abs().max())
    if not stochastic.all() or not mass_off <= 1e-4:
        failures.append(f"pi rows not stochastic (|mass - 1| {mass_off:.3e})")
    candidates = {
        "pi": eng_pi,
        "fppr": BatchQueryEngine(g, index, QueryConfig(mode="fppr", top_k=50),
                                 device=dev),
        "verd (dense)": BatchQueryEngine(g, None, QueryConfig(
            mode="verd", t_iterations=2, top_k=50), device=dev),
        "powerwalk (dense)": eng_d,
        "powerwalk (sparse)": eng,
    }
    quality = {}
    for label, e in candidates.items():
        v, i = e.query_topk(src64)
        if not bool(torch.isfinite(v).all()) or bool((v < 0).any()):
            failures.append(f"{label}: answers not finite and non-negative")
        approx = densify(torch, v, i, g.n)
        quality[label] = dict(
            mean_rag=mean_rag(truth, approx, 50),
            precision=float(precision_at_k(truth, approx, 50).mean()))
        del approx
    print("accuracy at k=50 against pi (first 64 requests):",
          json.dumps(quality))
    del candidates
    phase("3e baselines", t0)

    # -- 3f: the distributed engine on the same graph --------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    key = rng.prng_key(0)
    dcfg_f = DistConfig(n=g.n, ep=DIST_EP, q_tile=256, t_iterations=2,
                        index_l=MAIN_L, top_k=50, degree_cap=max_deg,
                        hub_split_degree=64)
    slabs = build_sharded_graph(g, dcfg_f, device=dev)
    step = make_verd_tile_step(dcfg_f, ShardMesh(1, DIST_EP, device=dev))
    shape = (DIST_EP, g.n // DIST_EP, MAIN_L)
    iv, ii = index.values.reshape(shape), index.indices.reshape(shape)
    work_t = torch.tensor(work, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    print(f"sharded slabs: col_idx {list(slabs.col_idx.shape)}, built in "
          f"{time.perf_counter() - t0:.3f} s")
    ops.reset_launch_counts()
    ops.capture_first_launches(True)
    t1 = time.perf_counter()
    sh_index, sh_stats = build_index_sharded(
        g, r=MAIN_R, l=MAIN_L, key=key,
        mesh=ShardMesh(data=DIST_DATA, model=DIST_EP, device=dev),
        source_batch=MAIN_SOURCE_BATCH, respawn=True)
    torch.cuda.synchronize()
    sharded_build_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    tiles = [step(slabs, work_t[j:j + 256], iv, ii)
             for j in range(0, MAIN_REQUESTS, 256)]
    torch.cuda.synchronize()
    tiles_s = time.perf_counter() - t1
    counts_f = ops.launch_counts()
    captured_f = ops.captured_launches()
    ops.capture_first_launches(False)
    peak_f = torch.cuda.max_memory_allocated() / 2**30
    print("sharded index:", json.dumps({k: sh_stats[k] for k in (
        "r", "l", "sketch_l", "r_splits", "respawn", "shards", "n_pad",
        "source_batch", "kept_mass", "dropped_mass", "drop_fraction")}))
    print(f"sharded build seconds: {sharded_build_s:.3f}")
    n_tiles = len(tiles)
    print(f"tile step: {MAIN_REQUESTS} requests in {n_tiles} tiles of 256, "
          f"{tiles_s:.3f} s: {1e3 * tiles_s / n_tiles:.3f} ms per tile, "
          f"{MAIN_REQUESTS / tiles_s:.1f} requests/s; peak device memory "
          f"{peak_f:.2f} GiB")
    print("computed wire bytes per shard and iteration (not a measured "
          "transfer; the stacked exchange is a device-local permute):",
          json.dumps(exchange_bytes_per_iteration(dcfg_f)))
    print("distributed-path launches:", json.dumps(counts_f))
    want_push = dcfg_f.t_iterations * DIST_EP * n_tiles
    if counts_f["sharded_frontier_push"] != want_push:
        failures.append(f"distributed path: sharded_frontier_push launched "
                        f"{counts_f['sharded_frontier_push']} times, want "
                        f"{want_push}")
    failures += [f"kernel {k} never launched on the distributed path"
                 for k in DIST_PATH if counts_f[k] <= 0]
    split_tiles = min(4, n_tiles)
    wall_ms, device_ms, split = device_time_split(torch, lambda: [
        step(slabs, work_t[j:j + 256], iv, ii)
        for j in range(0, split_tiles * 256, 256)], top=None)
    print(f"tile step, device time by kernel over {split_tiles} tiles "
          f"(torch.profiler): wall {wall_ms / split_tiles:.3f} ms per tile, "
          f"device busy {device_ms / split_tiles:.3f} ms per tile "
          f"({100 * device_ms / wall_ms:.1f}% of the wall)")
    for name, ms in split[:8]:
        print(f"  {ms / split_tiles:9.3f} ms per tile  "
              f"{100 * ms / max(device_ms, 1e-9):5.1f}%  {name[:110]}")
    push_ms = sum(ms for name, ms in split if any(
        tag in name for tag in ("sharded_push", "sharded_wide", "wr::")))
    print(f"  sharded_frontier_push, all its kernels: "
          f"{push_ms / split_tiles:.3f} ms per tile "
          f"({100 * push_ms / max(device_ms, 1e-9):.1f}%)")
    top_v = torch.cat([v for v, _ in tiles])
    top_i = torch.cat([i for _, i in tiles])
    mass = top_v.sum(dim=1)
    if (top_v.shape != (MAIN_REQUESTS, 50)
            or not bool(torch.isfinite(top_v).all())
            or bool((top_v < 0).any()) or float(mass.max()) > 1.0 + 1e-4):
        failures.append("distributed answers not finite, non-negative and "
                        "of mass <= 1")
    print(f"distributed answer mass: min {float(mass.min()):.6f} mean "
          f"{float(mass.mean()):.6f} max {float(mass.max()):.6f}")
    approx = densify(torch, top_v[:E_ROWS], top_i[:E_ROWS], g.n)
    print("accuracy at k=50 against pi (first 64 requests):", json.dumps({
        "powerwalk (4-shard sparse exchange)": dict(
            mean_rag=mean_rag(truth, approx, 50),
            precision=float(precision_at_k(truth, approx, 50).mean()))}))
    del approx, tiles
    # the first chunk of every shard against the single-device build
    ns_f = sh_stats["n_pad"] // DIST_EP
    chunk_equal = True
    for shard in range(DIST_EP):
        off = shard * ns_f
        rows = slice(off, off + MAIN_SOURCE_BATCH)
        vals, idxs, _, _ = sparse_chunk_estimates(
            g, torch.arange(off, off + MAIN_SOURCE_BATCH, dtype=torch.int32,
                            device=dev),
            rng.fold_in(key, off), r=MAIN_R, l=MAIN_L,
            sketch_l=sh_stats["sketch_l"], r_splits=DIST_DATA, respawn=True)
        chunk_equal &= (bits_equal(torch, vals, sh_index.values[rows])
                        and bits_equal(torch, idxs, sh_index.indices[rows]))
    print(f"sharded build, first chunk of every shard bit-equal to the "
          f"single-device r_splits={DIST_DATA} build: {chunk_equal}")
    if not chunk_equal:
        failures.append("sharded build differs from the single-device build")
    # phase 3q's yardsticks: each model shard's rows, the totals, and this
    # tile step's answers from these rows over the same tiles
    t1 = time.perf_counter()
    sh_shape = (DIST_EP, ns_f, MAIN_L)
    sh_tiles = [step(slabs, work_t[j:j + 256],
                     sh_index.values.reshape(sh_shape),
                     sh_index.indices.reshape(sh_shape))
                for j in range(0, MAIN_REQUESTS, 256)]
    yard_q = dict(
        rows=[digest(sh_index.values[m * ns_f:(m + 1) * ns_f],
                     sh_index.indices[m * ns_f:(m + 1) * ns_f])
              for m in range(DIST_EP)],
        answers=answers_digest(sh_tiles), kept_mass=sh_stats["kept_mass"],
        dropped_mass=sh_stats["dropped_mass"])
    svc_q = PPRService(g, sh_index, service_config(256), device=dev)
    yard_q["service"] = service_answers_digest(svc_q.run_closed_loop(
        work[:RANK_SERVE_REQUESTS])[0])
    del svc_q
    print(f"3q's yardsticks: rows digested by model shard, the stacked tile "
          f"step on the sharded build's rows ({len(sh_tiles)} tiles) and "
          f"the stacked PPRService on them ({RANK_SERVE_REQUESTS} requests) "
          f"in {time.perf_counter() - t1:.3f} s")
    del sh_index, slabs, iv, ii, sh_tiles
    phase("3f distributed engine", t0)

    t0 = time.perf_counter()
    counts_q, counts_q_serve = phase_rank_mesh(
        torch, np, dev, g, index, work, max_deg, yard_q, failures)
    phase("3q rank mesh", t0)

    t0 = time.perf_counter()
    counts_g, replays_g = phase_recsys(torch, np, dev, "dlrm-rm2", DLRM_PLAN,
                                       ("serve_p99", "serve_bulk"), failures)
    counts_zoo = {}
    for arch in ZOO:
        counts_zoo[arch], res = phase_recsys(
            torch, np, dev, arch, ZOO_PLAN, ("serve_bulk",), failures)
        replays_g += res
    phase("3g the recsys zoo at full width", t0)

    t0 = time.perf_counter()
    counts_h, captured_walk = phase_montecarlo(
        torch, np, dev, g, src64, truth, work, failures)
    captured_h = {} if captured_walk is None else {
        "walk_step/mc": captured_walk}
    del truth
    phase("3h monte-carlo path", t0)

    t0 = time.perf_counter()
    counts_i = phase_maintenance(torch, np, dev, g, index, stats, cfg, work,
                                 failures)
    phase("3i maintenance and crash safety", t0)

    t0 = time.perf_counter()
    phase_loadgen(torch, np, dev, g, index, cfg, sparse_ab["qps"], failures)
    phase("3j load generation", t0)

    t0 = time.perf_counter()
    counts_k, replays_k = phase_lm(torch, np, dev, failures)
    phase("3k smollm-135m at full width", t0)

    t0 = time.perf_counter()
    counts_l, replays_l = phase_train(torch, np, dev, failures)
    phase("3l training at full width", t0)

    t0 = time.perf_counter()
    replays_m = {}
    counts_m = phase_gnn(torch, np, dev, index, replays_m, failures)
    phase("3m gcn-cora at full width", t0)

    t0 = time.perf_counter()
    phase_contract_auditor(torch, dev, g, index, failures)
    phase("3n contract auditor", t0)

    t0 = time.perf_counter()
    phase_dryrun(torch, failures)
    phase("3o dry-run and roofline", t0)

    t0 = time.perf_counter()
    counts_p, replays_p = phase_big_lms(torch, np, dev, failures)
    phase("3p the large LMs at full width", t0)

    t0 = time.perf_counter()
    # 3g's, 3k's and 3p's embedding_bag launches were replayed there,
    # before each table was freed, and 3l's embedding_bag_backward after each cell
    results = {"embedding_bag": replays_g + replays_k + replays_p
               + replays_m["embedding_bag"],
               "embedding_bag_backward": replays_l
               + replays_m["embedding_bag_backward"]}
    captured_f = {tag: v for tag, v in captured_f.items()
                  if tag.startswith("sharded_frontier_push/")}
    captured.update(captured_e)
    for batch in (captured_s, captured, captured_f, captured_h):
        replay_all(torch, batch, results, failures)
    del captured, captured_s, captured_e, captured_f, captured_h
    phase("2b kernel vs plain, main-path inputs", t0)

    t0 = time.perf_counter()
    index_equal, l1, l1_dense = check_small_reference(torch, np, dev)
    print(f"small reference: index bit-equal {index_equal}, answers max L1 "
          f"{l1:.3e} (sparse route), {l1_dense:.3e} (dense route)")
    if not index_equal or not l1 <= 1e-5 or not l1_dense <= 1e-5:
        failures.append("small reference check")
    build_equal, l1_dist, l1_exchange = check_small_distributed(
        torch, np, dev)
    print(f"small reference, distributed: sharded build bit-equal "
          f"{build_equal}, tile step max L1 {l1_dist:.3e} (card vs CPU), "
          f"dense exchange vs sparse at covering widths {l1_exchange:.3e}")
    if not build_equal or not l1_dist <= 1e-5 or not l1_exchange <= 1e-4:
        failures.append("small distributed reference check")
    for arch in ("dlrm-rm2",) + ZOO:
        rel = check_small_recsys(torch, np, dev, arch)
        print(f"small reference, {arch} reduced in f32: outputs card vs CPU "
              f"within {rel:.3e} of their largest (limit 1e-5)")
        if not rel <= 1e-5:
            failures.append(f"small {arch} reference check")
    rel = check_small_lm(torch, np, dev)
    print(f"small reference, {LM_ARCH} reduced in f32 (G = 1 and G = 3): "
          f"prefill and 8 decode steps' logits and caches card vs CPU within "
          f"{rel:.3e} of their largest (limit 1e-5)")
    if not rel <= 1e-5:
        failures.append(f"small {LM_ARCH} reference check")
    rel = check_small_moe(torch, np, dev)
    print(f"small reference, the large LMs reduced in f32: prefill and 4 "
          f"decode steps (bf16 and int8 caches), and dbrx's and grok's "
          f"_moe_ffn (routing equal) and 2 x 2 stacked _moe_ffn_shardmap, "
          f"card vs CPU within {rel:.3e} of their largest (limit 1e-5)")
    if not rel <= 1e-5:
        failures.append("small large-LM / MoE reference check")
    for arch in TRAIN_CELLS:
        ok, res = check_small_train(torch, np, dev, arch)
        print(f"small reference, {arch} reduced in f32: one train step card "
              f"vs CPU: {json.dumps(res)}")
        if not ok:
            failures.append(f"small {arch} train check")
    for shape in GNN_CELLS:
        ok, res = check_small_gnn(torch, np, dev, shape)
        print(f"small reference, {GNN_ARCH} {shape} reduced in f32: one "
              f"train step card vs CPU: {json.dumps(res)}")
        if not ok:
            failures.append(f"small {GNN_ARCH} {shape} train check")
    mc_equal = check_small_montecarlo(torch, np, dev)
    print("small reference, monte-carlo path, card vs CPU bit-equal:",
          json.dumps(mc_equal))
    failures += [f"small monte-carlo reference: {k}"
                 for k, v in mc_equal.items() if not v]
    maint_equal = check_small_maintenance(torch, np, dev)
    print("small reference, maintenance, bit-equal:", json.dumps(maint_equal))
    failures += [f"small maintenance reference: {k}"
                 for k, v in maint_equal.items() if not v]
    t1 = time.perf_counter()
    capture_ok = {k: fn(torch, np, dev) for k, fn in CAPTURE_CHECKS.items()}
    print(f"small reference, captured graphs at rmat(14) "
          f"({time.perf_counter() - t1:.3f} s):", json.dumps(capture_ok))
    failures += [f"small captured-graph check: {k}"
                 for k, v in capture_ok.items() if not v]
    phase("4 small reference", t0)

    paths = {"sparse (3b, 3c)": (SPARSE_PATH, counts),
             "dense (3d)": (DENSE_PATH, counts_d),
             "distributed (3f)": (DIST_PATH, counts_f),
             "rank mesh (3q)": (DIST_PATH, counts_q),
             "rank service (3q)": (RANK_SERVE_PATH, counts_q_serve),
             "dlrm (3g)": (RECSYS_PATH, counts_g),
             **{f"{arch} (3g)": (RECSYS_PATH, counts_zoo[arch])
                for arch in ZOO},
             "monte-carlo (3h)": (MC_PATH, counts_h),
             "maintenance (3i)": (MAINT_PATH, counts_i),
             f"{LM_ARCH} (3k)": (LM_PATH, counts_k),
             "large LMs (3p)": (LM_PATH, counts_p),
             **{f"train {arch} (3l)": (TRAIN_PATH, counts_l[arch])
                for arch in TRAIN_CELLS},
             **{f"{GNN_ARCH} {shape} (3m)": (GNN_PATH, c)
                for shape, c in counts_m.items()}}
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        runs = results.get(name)
        if not runs:
            failures.append(f"no main-path inputs captured for {name}")
            continue
        # the streamed fold and the later dense push are the steady-state
        # push (every iteration after the first); report it, with the
        # other variants beside it
        main = next((x for x in runs if x["variant"] in (
            "streamed", "later", "second", "serve_bulk")), runs[0])
        # every path that runs the kernel, each counted from zero
        by_path = {path: c.get(name, 0)
                   for path, (kernels_of, c) in paths.items()
                   if name in kernels_of}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(x["max_abs_err"] for x in runs),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], device_ms=main["device_ms"],
            variant=main["variant"],
            variants={x["variant"]: dict(
                ms=x["ms"], device_ms=x["device_ms"], plain_ms=x["plain_ms"],
                bound_ms=x["bound_ms"], library_ms=x["library_ms"],
                **{k: x[k] for k in ("bound_touched_ms", "memset_ms")
                   if k in x})
                for x in runs},
        ))
    print(f"chip_smoke total: {time.perf_counter() - run_t0:.3f} s")
    if failures:
        print("FAILED:", "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card_name_and_power_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
