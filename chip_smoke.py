#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. build   — print the card (``nvidia-smi``) and build the four CUDA
             kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
2. kernels — hold decompress_maxsim and fused_rerank, and their B=1
             launches, against their plain PyTorch versions on the card
             at full width (B=32, Lq=32, C=200, Ld=180, d=128, K=131072;
             nbits 4 and 2; ragged valid and cmask, k < C and k > C,
             empty C); fused must equal split bit for bit, and a B=1
             launch its batch row. Then MaxSim over fp32
             embeddings at the same width (ragged validity, an
             all-invalid doc) and at its edges (C 1, 7, 200; Lq 5, 32,
             33, 128; d 64, 128, 256; masks that are not a prefix, a
             row with every doc invalid), with B=1 launches: against its
             plain version, and bit for bit against decompress_maxsim on
             the decoded embeddings, against a second launch and, at
             B=1, against its batch row;
3. index   — write a synthetic index at full width (d=128, nbits=4,
             doc_maxlen=180, K=131072, SPLADE vocab 30522) with
             ``write_index`` and ``SpladeIndex.save``, 100,000 docs; then
             hold the SPLADE kernel's two entry points (scores, per-block
             top-k) on the cache's pid-sorted rows against their plain
             versions on the index's ``as_padded`` layout (32 queries of
             12 terms; k = 200 and around the top-k block size), with
             ``max_df=64`` truncation (the layout unsorted, the copy
             sorted), the cache's top-200 and whole ranking against the
             host scorer bit for bit, and the edge cases (unsorted rows
             with repeated pids, all-zero weights, k > n_docs, a ragged
             last doc block, an out-of-vocabulary id);
3b. build  — the ColBERTv2 index build on the card (no kernel of its
             own: k-means, the assignment and the encode are PyTorch ops
             on the card; the sample and the codec fit on the host).
             (a) a synthetic corpus at the serve config's widths (10,000
             docs, d=128, doc_maxlen=180, ~0.96 M tokens) built with
             ``build_colbert_index`` at nbits 4 and 2 (heuristic K =
             16,384, 8 Lloyd iterations on a 65,536-token sample), each
             step timed with CUDA events beside its bound; (b) the
             nbits=4 build again from the same seed, timed as well:
             every file byte for byte; (c) 300 of its docs built on the
             card and on the CPU pinned to (a)'s centroids and codec:
             every file byte for byte, unless a token's id differs at
             a tie (top-2 sims within 1e-6; counted, and then only those
             tokens differ);
             (d) the benchmarks' in-domain profile (4,000 docs) built
             freely on the card and on the CPU from one seed, the four
             methods served on the card: hybrid ≥ rerank − 0.01, hybrid
             > splade, colbert > splade, and the card build's colbert
             MRR@10 within 0.01 of the CPU build's; (e) 64 mixed
             colbert/hybrid/rerank requests of the corpus's own queries
             on (a)'s index through ``RetrievalServer`` at max_batch=32,
             fused tail: every answer held to the CPU engine, the run's
             launches the tail's two kernels and no other. Its figures
             go on a ``build`` line;
4. serve   — serve mixed splade/rerank/hybrid requests through
             ``RetrievalServer`` on ``cuda``: 64 at max_batch=32, once
             with the host stage 1 and once with
             ``splade_backend="device"`` (in turns, twice each); 24 at
             the server's default max_batch=1 and 32 with the split
             rerank tail, both with the device stage 1. Every answer is
             held to an engine built with ``device="cpu"`` over the same
             directory, each run's launch counts must show the kernels of
             its path and no other, and the device stage 1 must equal the
             host's bit for bit on the requests' terms. Then PLAID
             ``colbert`` at the serve_plaid shape (nprobe=4,
             candidate_cap=4096, ndocs=256; 32-token unit random
             queries, k ∈ {10, 100}): 64 requests at max_batch=32 on the
             mmap pool with the fused tail, 32 with the split tail, 32
             with the pool resident on the card, 16 at max_batch=1. Each
             run must launch its tail's kernel and no SPLADE kernel, the
             mmap runs' codes gather must touch no residual page, every
             answer is held to the CPU engine (through a tie at the
             probe's or the approximate stage's boundary where they
             differ), the split and resident runs equal the mmap fused
             run bit for bit, and stages 1-3 of one batch are held to the
             CPU's;
4c. front door — caches (``CacheHierarchy(exact_entries=256,
             stage1_entries=256)``), admission and the adaptive batch cap
             on the phase-3 index, device stage 1, fused tail. A: a cold
             mixed batch of 32 (8 of each method, k ∈ {10, 100}, a
             quarter with their own α) and the same batch again: 32 exact
             hits equal to the cold answers bit for bit, no launch, no
             stage run. B: hybrid and rerank on the terms the batch's
             splade requests scored, at another α or k: all stage-1
             hits, no SPLADE launch, one launch of each tail kernel. C:
             the batch's colbert requests at the other k, mmap and
             resident pools: all survivor hits, no probe or approximate
             stage, no codes read, one fused_rerank launch. D: a batch
             of 32 with 16 exact hits. B-D equal an engine without caches
             bit for bit. E: ``bump_index_generation()`` purges every
             entry; the batch then misses everything and gives the same
             bits. F: ``RetrievalServer`` admission at an SLO between the
             predicted cheap and full costs (from the warm stage EWMAs)
             degrades hybrid/rerank to the splade plan (its bits, not
             stored). G: a request with ``deadline_ms=0.001`` is shed
             before it is queued. H: an SLO below a request's service
             time halves ``batch_cap`` to 1, a slack one grows it back.
             Then a trace: 256 requests drawn with Zipf s=1.1 from 64
             distinct ones (16 queries × the four methods), served in
             waves of 32, caches off and on in turns, twice each; every
             repeat equals its first answer bit for bit. Every distinct
             answer of the phase is held to the CPU engine;
4d. pipelined — the stage executor (``ServeEngine(pipeline_depth=2)``,
             one CUDA stream per executor, an event per async window)
             through ``RetrievalServer`` at max_batch=32 on the phase-3
             index, device stage 1, fused tail: 64 mixed SPLADE-method
             requests, 64 mmap ``colbert`` requests and 32 resident
             ones, each at depth 1 and at depth 2 with ``single`` and
             ``kind`` workers in turns (1, single, kind, kind, single,
             1). Every answer equals the first depth-1 run's bit for
             bit, whose answers are held to the CPU engine; each run's
             launch counts show its path's kernels and no other; the
             codes gather touches 0 residual pages; no pipeline thread
             outlives its run. QPS, p50, p99, ``overlap_fraction``, the
             stage walls and queue waits per run go on a ``pipelined``
             line;
4e. tcp    — the TCP front (``RetrievalServer.serve_tcp`` on
             ``127.0.0.1:0``, ``serve_forever`` on a thread) on the
             phase-3 index, device stage 1, fused tail, max_batch=32: at
             depth 1, then at ``pipeline_depth=2`` with ``kind``
             workers, 64 mixed SPLADE-method and 32 mmap ``colbert``
             requests (the serve_plaid retriever of phase 4) from 8
             client threads, each on one persistent connection, in turns
             with the same requests submitted in process (in process,
             TCP, TCP, in process). Every reply equals the first
             in-process answer of its request bit for bit (where one
             does not, the request is served alone and the error says
             whether the row changed with its batch); each turn launches
             its path's kernels and no other; the admin lines give the
             JAX package's replies on a frozen index and ``health``
             reports the bound port; four one-shot ``tcp_query`` calls
             too. Then 32 requests on connections of their own and a
             drain started while they are in flight, by
             ``shutdown_gracefully()`` at depth 1 and by SIGTERM through
             ``install_sigterm_handler()`` at depth 2: every one is
             answered, ``serve_forever`` returns, no worker, executor or
             drain thread is left, and the port refuses connections.
             QPS, p50 and p99 per turn (at the client, and from submit
             to the answer as the server measures it), its batches and
             stage walls, bytes a line and the host's ``json.loads`` +
             ``np.asarray`` time a request go on a ``tcp`` line;
4f. live   — the live index (``enable_live``). (a) On phase 3b's corpus
             at the serve widths, the base a pinned card build of all
             but its last 256 docs (3b (a)'s K=16,384 geometry), first_k
             =200, the device stage 1, the fused tail, PLAID at nprobe=4,
             ndocs=256 with a candidate cap above every corpus size (it
             never binds): a clean live retriever equals the frozen one
             bit for bit, with the same launches. Round 1 upserts the
             256 docs and tombstones 64 base and 8 delta pids; round 2
             updates 128 docs (tombstones each, upserts a changed copy)
             and tombstones 8 of those. In each round the corpus's 256
             queries in batches of 32, the four methods at k 10 and 100,
             dirty and after ``compact_live()``, equal a pinned card
             rebuild of the survivors bit for bit (pids mapped by
             ``map_global_to_ref``); the delta's codes and residual rows
             equal the rebuild's rows (0 differ); each dirty batch
             launches decompress_maxsim (the splade method nothing) and
             no other kernel. Rows that are exact ties between two of the
             base's centroids get the same id and sim bits assigned
             alone (L = 1..180, as an upsert) as inside a full and a
             partial last chunk (as the rebuild), every matmul padded
             to ``kmeans.CHUNK`` rows. (d) A live ``RetrievalServer`` over TCP on
             a copy of (a)'s base: every upsert, delete, compact,
             ``live_stats`` and ``health`` reply equal to the same call
             on an in-process twin; the query replies after each
             mutation equal to their in-process answers bit for bit.
             (b) Phase 3's index: 64 mixed requests at max_batch=32
             clean, then after 256 upserts of unit-random documents and
             64 deletes, every answer held to a ``device="cpu"`` live
             engine fed the same trace; QPS, p50/p99, upsert ms. (c) A
             compaction under 3 reader threads serving 32 SPLADE-method
             requests (every answer unchanged, every thread joined; the
             readers' calls before, during and over the swap), then 64
             more upserts and a compaction alone; each compaction's
             steps (the concatenation, the pool's write, the IVF, the
             SPLADE CSR, the load, the gate, the swap) and the device
             memory after each (flat); an upsert's assignment, by CUDA
             events. The figures go on a ``live``
             line;
4g. load   — the load generators (``repro_torch.serving.loadgen``) on
             the phase-3 index, device stage 1, fused tail,
             ``RetrievalServer(max_batch=32, batch_timeout_ms=5)``: 512
             mixed SPLADE-method requests and 128 mmap ``colbert``
             requests, each answer held bit for bit to a depth-1
             reference run of the same requests (one burst), whose
             answers are held to the CPU engine. Each run gets a new
             engine, warmed first by as many full batches of its own
             traffic as it has pipeline slots, in flight at once, so
             that executors, streams and the allocator's blocks are set
             up outside the timed window. (a) The service rate:
             ``run_closed_loop`` at concurrency 1 and 32 (256 and 128
             requests); μ is the concurrency-32 rate. (b) The open-loop
             sweep: ``run_open_loop`` at 0.25-1.25 × μ, each rate at
             depth 1, then depth 2 with single and kind workers; the
             first depth-1 run of each traffic launches its path's
             kernels and no other (colbert's codes gather 0 residual
             pages). (c) ``run_poisson_load`` with bursts of 8 at 0.75 ×
             μ, the answers through ``on_result``. (d) A Zipf trace (s
             1.1 over 64 distinct requests) written to a file and read
             back by ``load_trace``, served at 0.75 × μ with the exact
             and stage-1 caches: the cache hits equal the exact-hit
             counter's growth, the trace's unique and repeat counts
             hold, every repeat its first answer. (e) ``run_open_loop``
             at 1.25 × μ with an admission SLO between the cheap and
             the full plan's cost: served + shed + failed = 512, the
             sheds the server's, the degraded answers the admission's
             count and their splade plan's bits. A thin proxy keeps
             each future and the submitter's lateness against its
             schedule (its largest, the scheduled instant where it
             fell and how much of it the garbage collector took) and
             the run's collections; before the runs, the heap's tracked
             objects and the time of two full collections; no server,
             executor or client thread outlives a run. One ``load``
             line per run;
4h. launcher — ``python -m repro_torch.launch.serve`` and
             ``examples/serve_concurrent_torch.py`` as child processes
             on the card, each killed in a ``finally``. (a) The launcher
             on the phase-3 index (``--splade-backend device --max-batch
             32 --batch-timeout-ms 5 --pipeline-depth 2
             --pipeline-workers kind --port 0``): its start-up time to
             ``RETRIEVAL_PORT=``; 32 connections opened at once, each
             ``connect`` timed; phase 4e's kind of traffic (64 mixed
             SPLADE-method and 32 colbert lines) over them twice, every
             reply equal bit for bit to an in-process twin (the port's
             ``build_or_load`` behind ``RetrievalServer`` with the same
             settings), whose answers are held to ``build_or_load(...,
             device="cpu")`` (the launcher's cap of 1,024 binds: through
             a tie at a stage boundary where they differ) and whose run
             launches the path's three kernels and no other; then one
             request on each connection and SIGTERM: every one answered,
             exit 0 within 60 s, the port refused; the child's
             ``health`` after each turn names the twin's stages, the
             device stage 1 and the depth-2 pipeline. In process, 32
             connections at once to a front with the port's backlog and
             to one with socketserver's 5, one turn each. (b) ``--live
             --live-compact-every 8 --port 0`` on a copy of the
             launcher's built-in index: queries, a delete of a pid in a
             top-k, 8 upserts, the background compaction (``health``
             polled until the generation bumps), each admin and query
             reply equal to an in-process live twin fed the same
             operations and one ``compact_live()``; SIGTERM, exit 0. (c)
             Bounded load on the built-in corpus (3,000 docs, dim 64,
             built on the card): at the launcher's defaults (hybrid,
             max_batch 1, host stage 1; 64 requests at 200 QPS), and
             with the device stage 1, max_batch 32, 256 requests
             open-loop at 0.75 × phase 4g's μ_s, Zipf s=1.1, both
             caches and an admission SLO between the cheap and the full
             plan's warm cost: exit 0, 0 failed, every request accounted
             for, the trace's unique and repeat counts ``zipf_trace``'s;
             in process, the max_batch=1 run again with each stage 1,
             for its launches and answers, held to the CPU engine, and
             its two B=1 kernels on one request's inputs at this
             corpus's shapes (d=64, K=256), held to their plain
             versions and timed. (d) The example at ``--max-batch 32 --n
             128 --tcp``: exit 0, its capacity line, four rate rows, the
             TCP reply and "drained + stopped cleanly." The figures go
             on a ``launcher`` line;
4i. sharded — frozen in-process shard groups on phase 3's index. (a)
             ``split_index_tree`` into 2 and 4 shards under a temporary
             directory of its own, each split timed. (b) 64 mixed
             SPLADE-method requests (a third each, k ∈ {10, 100}, a
             quarter with their own α) at 1, 2 and 4 shards (one shard:
             a ``ShardedRetriever`` over the index itself), with the host
             and the device stage 1: in batches of 32 through the
             synchronous engine (tokens read and pages touched, the
             tokens equal at every shard count), then through
             ``RetrievalServer`` at max_batch=32, depth 1 and depth 2
             with kind workers, the shard counts in turns (1, 2, 4, 4,
             2, 1); every answer equal to the unsharded card engine's
             bit for bit. Each run's launches against its stage
             records: one shard launches as unsharded; more launch, per
             method group, the SPLADE top-k entry once a shard (device
             stage 1), decompress_maxsim once a shard per rerank or
             hybrid group, and fused_rerank never. Then the depth-2
             kind turns of 1 and 4 shards with the device stage 1 again,
             at the interpreter's switch interval and at a twentieth of
             it, each with the wall inside the host syncs summed (the
             stage-1 copy to the host, the tail's event, the copies to
             the card): a device stage that waits for the stream keeps
             its wall at the shorter interval, one that waits for the
             GIL held by the gather threads loses it. (c) colbert, mmap,
             one batch of 32 at nprobe 4, ndocs 256: at a cap that
             cannot bind (query tokens × nprobe × the longest IVF list;
             no query capped), 2 and 4 shards equal 1 (ids up to
             exact-score ties, which the group breaks by pid); at phase
             4's cap of 4,096, which binds, each card group is held to
             the port's CPU group over the same shard directories; the
             codes gather touches no residual page. (d) The path's two
             kernels at 4 shards, on one batch's merged stage-1 rows:
             decompress_maxsim at each shard's candidate width held to
             its plain version and, scattered back, equal to one launch
             over the unsharded (32, 200) candidates bit for bit; the
             SPLADE top-k entry on each shard's postings equal to its
             plain version; shard 0's launches timed. The shards'
             SPLADE device caches, the centroid table a shard, and
             ``torch.cuda.max_memory_allocated`` since the phase began.
             The figures go on a ``sharded`` line;
4j. sharded live — the live index of in-process shard groups. (a)
             Phase 4f (a)'s base (the serve widths, K=16,384) split into
             2 and 4 shards under a temporary directory of its own; each
             group fed 4f (a)'s two rounds of mutations, each round
             ending in ``compact_live()``; the first 64 of its queries,
             the four methods at k 10 and 100, dirty and compacted:
             equal to 4f (a)'s pinned card rebuild of the survivors and
             to the unsharded live retriever's answers bit for bit, each
             dirty batch launching decompress_maxsim alone (the splade
             method nothing). (b) Phase 3's index split into 2 and 4
             shards and served live at 1, 2 and 4 shards (one shard: a
             group over the index itself): 64 mixed SPLADE-method
             requests through ``RetrievalServer`` at max_batch=32 with
             the device stage 1, the shard counts in turns (1, 2, 4, 4,
             2, 1), clean and then after 256 upserts and 64 deletes (15
             in each shard of the 4-shard group, 4 of the delta), every
             answer equal to the unsharded card live engine fed the same
             trace bit for bit. A clean run's launches as phase 4i's; a
             dirty run's, per rerank or hybrid group, decompress_maxsim
             once a shard and once for the delta where the group has
             delta candidates (``LiveIndexState.exact_scores`` counted),
             and no other kernel; the first dirty 4-shard run's widest
             delta launch replayed, held to its plain version and timed
             at its own (B, C). Then colbert: a 4-shard group and the
             unsharded retriever at phase 4i (c)'s open cap, fed the
             same trace, 32 requests (every other one made from an
             upserted doc) through ``RetrievalServer``, every answer
             equal to the unsharded live engine's, ids up to exact-score
             ties; decompress_maxsim 4 × ``device_score:exact`` plus the
             delta's launches, no other kernel. (c) The 4-shard group
             compacts under 3 reader threads (every answer unchanged,
             every thread joined), takes 64 more upserts and compacts
             alone, the device memory after each equal (no collection
             forced before the read); the one-shard group then compacts
             under the readers; each compaction's steps. The figures go
             on a ``sharded_live`` line;
4k. transport — the socket half of the shard transport
             (``repro_torch.serving.transport``; host code, no kernel).
             What shard 0's process worker of phase 4i's 4-shard group
             would send for one served batch of 32, in the JAX worker's
             message shapes: its stage-1 pids and scores (rerank, device
             stage 1), the ``score_tokens`` request (its residual
             selection, the batch's query embeddings and mask), colbert's
             candidates and approximate scores, colbert's exact scores.
             With every codec the host has (``HAVE_MSGPACK`` printed):
             each message 20 times through a pair of ``StreamChannel``
             over a socketpair with a reader thread, 64 frames back to
             back in FIFO order, one frame of 64 MiB (the JAX client's
             arena size) in more than one ``sendmsg`` call; every array
             bit for bit, ``bytes_copied`` equal to the bytes of the
             arrays of 64 bytes or more. ms a message, MB/s and the
             counters go on a ``transport`` line;
4l. workers — the shard worker processes (``repro_torch.serving.worker``
             behind ``ShardWorkerClient``; host code, no kernel of their
             own). Phase 3's index split anew into phase 4i's 4 shards;
             one worker a shard, the four spawned at once on the card
             over the socket channel: each one's seconds from spawn to
             its first ping, the card's bytes in use before and after,
             ``nvidia-smi``'s list of compute processes one longer a
             worker (in a container whose pids the GPU driver does not
             see, every process shows as pid 1, so the list is
             counted, not matched to pids), each worker's
             ``health``, ``warm`` with the device stage 1. For one batch
             of 32 of each method (``splade``, ``rerank``, ``hybrid``
             with both stage-1 backends, and ``colbert``) phase 4i's
             in-process group runs stage by stage and each shard's
             inputs go to its worker, as single ops and as one ``multi``
             frame: every reply bit for bit against the shard's
             in-process state. Each op is then timed once more against
             the worker's op body run in this process on the same
             shard. SIGTERM on one worker 100 ms after a ``multi`` frame
             of 32 ``colbert_exact`` ops went out whole (its reply bit for
             bit, exit 0), SIGKILL on another with the frame pending
             (``ShardWorkerDied``), ``terminate`` on the rest (exit 0);
             the card's bytes released at each exit; at the end no
             worker pid alive and the process list as before. The
             figures go on a ``workers`` line;
5. time    — time each kernel with CUDA events at the serve shapes, and
             each at B=1, in an eager loop (the rerank tail's two
             kernels, MaxSim, the SPLADE kernel's two entry points and
             ``index_add_`` also by CUDA-graph replay, as ``graph_ms``
             and ``library_graph_ms``); and one
             device stage-1 dispatch in its parts (host padding, the
             copy in, the top-k launch, the copy out, the whole
             dispatch, and the full sort the launch replaced). One
             colbert batch in its device parts (the probe's matmul and
             top-nprobe selection, stage 2, stage 3, and the tail's two
             kernels at C = ndocs on its survivors, where they are also
             held to their plain versions; fused_rerank also at B=1),
             eager and by replay, each against its bound.

The ``{"kernels": [...]}`` line lists each kernel once per main path
(``path``): the SPLADE methods served with the device stage 1, each
colbert run with its tail's kernel, and the front door's cold mixed
batch (``front_door``) with the three kernels of its path, phase 4d's
first single-worker runs (``pipelined_splade``, ``pipelined_colbert``,
``pipelined_colbert_resident``), phase 3b's serve on the card-built
index (``built_index``), phase 4e's first TCP turn at each depth
(``tcp``, ``tcp_pipelined``) with the three kernels of its path, and
phase 4f (b)'s dirty run (``live``) with decompress_maxsim, the only
kernel of the overlay path, and phase 4g's first depth-1 open-loop run
of each traffic (``load``, ``load_colbert``) with its path's kernels,
and phase 4h's in-process twin of the launcher (``launcher``) and its
in-process max_batch=1 bounded loads (``launcher_b1`` with the host
stage 1, ``launcher_b1_device``), whose B=1 kernels are held to their
plain versions and timed at the built-in corpus's shapes (d=64,
K=256), and phase 4i's run of 4 shards with the device stage 1 at depth
1 (``sharded``) with the SPLADE top-k entry and decompress_maxsim, timed
at shard 0's shapes, and phase 4j (b)'s first dirty run of 4 shards
(``sharded_live``) with decompress_maxsim, timed at shard 0's width,
its ``delta`` the coordinator's delta launch timed at its own width;
``launches`` is that path's own run's count, and the times are at that path's candidate width (``C``).

Arithmetic is IEEE fp32: TF32 is switched off for matmuls and cuDNN.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import queue
import re
import select
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks (NVIDIA data sheets): fp32 on the CUDA cores, HBM rate
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}


@dataclasses.dataclass(frozen=True)
class Shapes:
    B: int = 32            # micro-batch (max_batch)
    Lq: int = 32           # query tokens
    C: int = 200           # first_k candidates
    Ld: int = 180          # doc_maxlen
    d: int = 128           # embedding width
    K: int = 131072        # centroids
    n_docs: int = 100_000  # cut from MS MARCO's 8.84 M
    vocab: int = 30522     # SPLADE (BERT) vocabulary
    # SPLADE traffic after the repo's synthetic corpus generator
    # (src/repro/data/synth.py, SynthCfg defaults); no public source
    # fixes these, so stage-1 cost under this traffic is not MS MARCO's
    doc_terms: int = 24        # nonzero terms per SPLADE doc vector
    query_terms: int = 12      # nonzero terms per SPLADE query vector
    terms_per_topic: int = 96  # a topic's vocabulary, drawn Zipf(1/rank)
    n_requests: int = 64
    # PLAID colbert at the serve_plaid shape
    # (src/repro/configs/colbert_serve.py:73-75)
    nprobe: int = 4
    candidate_cap: int = 4096
    ndocs: int = 256


FULL = Shapes()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def kernel_inputs(rng, s: Shapes, nbits: int, C: int | None = None):
    """Numpy inputs of the tile kernels at the serve shapes: ragged doc
    lengths (some docs empty), ragged query lengths, ~10% of the
    candidates masked and a masked tail on some rows."""
    C = s.C if C is None else C
    B, Lq, Ld, d = s.B, s.Lq, s.Ld, s.d
    q = unit(rng.normal(size=(B, Lq, d)))
    packed = rng.integers(0, 256, (B, C, Ld, d * nbits // 8), dtype=np.uint8)
    cids = rng.integers(0, s.K, (B, C, Ld), dtype=np.int32)
    lens = rng.integers(0, Ld + 1, (B, C))
    valid = np.arange(Ld)[None, None, :] < lens[..., None]
    cmask = rng.random((B, C)) < 0.9
    for b in range(0, B, 4):          # short candidate lists
        cmask[b, C - C // 4:] = False
    qlen = rng.integers(Lq // 2, Lq + 1, B)
    q_valid = np.arange(Lq)[None, :] < qlen[:, None]
    centroids = unit(rng.normal(size=(s.K, d)))
    bw = np.sort(rng.normal(scale=0.05, size=2 ** nbits)).astype(np.float32)
    return dict(q=q, packed=packed, cids=cids, valid=valid, cmask=cmask,
                q_valid=q_valid, centroids=centroids, bw=bw)


def to_dev(arrs: dict, device) -> dict:
    import torch
    return {k: torch.as_tensor(v, device=device) for k, v in arrs.items()}


def sub_rng(seed: int, phase: str):
    """A generator of its own for a phase added after the first slice,
    so the earlier phases keep drawing the same inputs from ``--seed``."""
    return np.random.default_rng([seed, sum(map(ord, phase))])


def maxsim_inputs(rng, s: Shapes, device):
    """The tile kernels' inputs at the serve shapes (nbits=4) plus their
    decoded fp32 embeddings (B, C, Ld, d), and one all-invalid doc."""
    from repro_torch.index.residual import decode_embeddings
    x = to_dev(kernel_inputs(rng, s, 4), device)
    x["valid"][1, 5] = False
    x["emb"] = decode_embeddings(x["packed"], x["cids"], x["centroids"],
                                 x["bw"], 4)
    return x


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(rng, s: Shapes, device) -> dict:
    """Returns the largest |kernel - plain| score difference per kernel."""
    import torch
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores, decompress_maxsim_scores_batch)
    from repro_torch.kernels.decompress_maxsim.ref import (
        decompress_maxsim_ref)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk, fused_rerank_topk_batch)
    from repro_torch.kernels.fused_rerank.ref import (fused_rerank_ref,
                                                      stable_topk)
    from repro_torch.testing import ATOL, REF_MARGIN, RTOL, assert_topk_match

    err = {"decompress_maxsim": 0.0, "fused_rerank": 0.0}
    for nbits in (4, 2):
        x = to_dev(kernel_inputs(rng, s, nbits), device)
        tile = (x["q"], x["packed"], x["cids"], x["valid"])
        tables = (x["centroids"], x["bw"])
        got = decompress_maxsim_scores_batch(*tile, *tables, nbits=nbits,
                                             q_valid=x["q_valid"])
        want = decompress_maxsim_ref(*tile, *tables, nbits, x["q_valid"])
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        err["decompress_maxsim"] = max(err["decompress_maxsim"], e)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"decompress_maxsim nbits={nbits}")
        log(f"decompress_maxsim nbits={nbits}: max |err| {e:.3g}")

        for k in (100, s.C + 56):                      # k < C and k > C
            vals, idx = fused_rerank_topk_batch(
                *tile, x["cmask"], *tables, nbits=nbits, k=k,
                q_valid=x["q_valid"])
            wv, wi = fused_rerank_ref(*tile, x["cmask"], *tables, nbits,
                                      k + REF_MARGIN, x["q_valid"])
            assert_topk_match(wv.cpu().numpy(), wi.cpu().numpy(),
                              vals.cpu().numpy(), idx.cpu().numpy(),
                              what=f"fused_rerank nbits={nbits} k={k}")
            fin = torch.isfinite(wv[:, :k])
            e = (vals[fin] - wv[:, :k][fin]).abs().max().item()
            err["fused_rerank"] = max(err["fused_rerank"], e)
            # fused == split, bit for bit: the split tail is the scoring
            # kernel, -inf at masked candidates, a stable sort
            kk = min(k, s.C)
            sv, si = stable_topk(
                got.masked_fill(~x["cmask"], float("-inf")), kk)
            assert torch.equal(idx[:, :kk].long(), si), "fused != split ids"
            assert torch.equal(vals[:, :kk].view(torch.int32),
                               sv.view(torch.int32)), "fused != split bits"
            if k > s.C:
                assert torch.all(idx[:, s.C:] == -1)
                assert torch.all(vals[:, s.C:] == float("-inf"))
            log(f"fused_rerank nbits={nbits} k={k}: max |err| {e:.3g}, "
                "fused == split")

        # B=1 launches (the single-query entry points) at full width:
        # against their plain versions, and bit for bit against their
        # batch row
        for b in (0, 3):
            row = tuple(t[b] for t in tile)
            one = decompress_maxsim_scores(*row, *tables, nbits=nbits,
                                           q_valid=x["q_valid"][b])
            want1 = decompress_maxsim_ref(*row, *tables, nbits,
                                          x["q_valid"][b])
            np.testing.assert_allclose(
                one.cpu().numpy(), want1.cpu().numpy(), rtol=RTOL,
                atol=ATOL, err_msg=f"B=1 decompress_maxsim nbits={nbits}")
            assert torch.equal(one.view(torch.int32),
                               got[b].view(torch.int32)), \
                "B=1 decompress_maxsim != batch row"
            kk = min(100, s.C)
            v1, i1 = fused_rerank_topk(*row, x["cmask"][b], *tables,
                                       nbits=nbits, k=kk,
                                       q_valid=x["q_valid"][b])
            wv, wi = fused_rerank_ref(*row, x["cmask"][b], *tables, nbits,
                                      kk + REF_MARGIN, x["q_valid"][b])
            assert_topk_match(wv.cpu().numpy(), wi.cpu().numpy(),
                              v1.cpu().numpy(), i1.cpu().numpy(),
                              what=f"B=1 fused_rerank nbits={nbits}")
            sv, si = stable_topk(got[b].masked_fill(~x["cmask"][b],
                                                    float("-inf")), kk)
            assert torch.equal(i1.long(), si) and torch.equal(
                v1.view(torch.int32), sv.view(torch.int32)), \
                "B=1 fused_rerank != split row"
        log(f"B=1 launches nbits={nbits}: match plain, == batch row")

    # empty candidate set
    x = to_dev(kernel_inputs(rng, s, 4, C=0), device)
    tile = (x["q"], x["packed"], x["cids"], x["valid"])
    vals, idx = fused_rerank_topk_batch(*tile, x["cmask"], x["centroids"],
                                        x["bw"], nbits=4, k=10,
                                        q_valid=x["q_valid"])
    assert vals.shape == (s.B, 10) and torch.all(idx == -1)
    assert torch.all(vals == float("-inf"))
    sc = decompress_maxsim_scores_batch(*tile, x["centroids"], x["bw"],
                                        nbits=4, q_valid=x["q_valid"])
    assert sc.shape == (s.B, 0)
    torch.cuda.synchronize()
    return err


# MaxSim's edge batches: (B, C, Lq, d) at Ld = doc_maxlen, each with a
# mask that is not a prefix and a row whose docs are all invalid; the
# last two leave the least shared memory to spare
MAXSIM_EDGES = tuple((4, C, Lq, 128) for C in (1, 7, 200)
                     for Lq in (5, 32, 33, 128)) + (
    (4, 200, 33, 64), (4, 7, 128, 256), (4, 7, 112, 480), (4, 7, 120, 448))


def maxsim_edge_inputs(rng, B: int, C: int, Ld: int, Lq: int, d: int,
                       device) -> dict:
    """Decoded embeddings of random codes on a 4,096-row codebook,
    valid positions drawn at 0.7 (not a prefix), row 1 all invalid,
    ragged query lengths with a hole in the first row's mask."""
    from repro_torch.index.residual import decode_embeddings
    K = 4096
    x = dict(q=unit(rng.normal(size=(B, Lq, d))),
             packed=rng.integers(0, 256, (B, C, Ld, d // 2), dtype=np.uint8),
             cids=rng.integers(0, K, (B, C, Ld), dtype=np.int32),
             valid=rng.random((B, C, Ld)) < 0.7,
             q_valid=np.arange(Lq)[None, :] < rng.integers(
                 max(1, Lq // 2), Lq + 1, B)[:, None],
             centroids=unit(rng.normal(size=(K, d))),
             bw=np.sort(rng.normal(scale=0.05, size=16)).astype(np.float32))
    x["valid"][1 % B] = False
    x["q_valid"][0, Lq // 3] = False
    x = to_dev(x, device)
    x["emb"] = decode_embeddings(x["packed"], x["cids"], x["centroids"],
                                 x["bw"], 4)
    return x


def hold_maxsim(x: dict, what: str, b1_rows=()) -> float:
    """One batch through the MaxSim kernel: against its plain version
    (tolerance: the plain version sums through cuBLAS), bit for bit
    against decompress_maxsim on the embeddings it decodes and against a
    second launch, and each row of ``b1_rows`` as a B=1 launch against
    its plain version and, bit for bit, its batch row. Returns the
    largest |kernel - plain|."""
    import torch
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores, decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.maxsim.ops import (maxsim_scores,
                                                maxsim_scores_batch)
    from repro_torch.kernels.maxsim.ref import maxsim_scores_ref
    from repro_torch.testing import ATOL, RTOL

    args = (x["q"], x["emb"], x["valid"], x["q_valid"])
    got = maxsim_scores_batch(*args)
    want = maxsim_scores_ref(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL, err_msg=what)
    none = ~x["valid"].any(dim=-1)
    assert torch.all(got[none] == 0.0), \
        f"{what}: an all-invalid doc must score 0"
    tile = (x["packed"], x["cids"], x["valid"], x["centroids"], x["bw"])
    split = dms(x["q"], *tile, nbits=4, q_valid=x["q_valid"])
    assert torch.equal(got.view(torch.int32), split.view(torch.int32)), \
        f"{what}: maxsim on decoded embeddings != decompress_maxsim"
    again = maxsim_scores_batch(*args)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
        f"{what}: two launches differ"
    for b in b1_rows:
        row = tuple(t[b] for t in args)
        one = maxsim_scores(*row)
        np.testing.assert_allclose(
            one.cpu().numpy(), maxsim_scores_ref(*row).cpu().numpy(),
            rtol=RTOL, atol=ATOL, err_msg=f"{what}: B=1 row {b}")
        assert torch.equal(one.view(torch.int32), got[b].view(torch.int32)),\
            f"{what}: B=1 maxsim != batch row {b}"
        one_split = decompress_maxsim_scores(
            x["q"][b], *(t[b] for t in tile[:3]), *tile[3:], nbits=4,
            q_valid=x["q_valid"][b])
        assert torch.equal(one.view(torch.int32),
                           one_split.view(torch.int32)), \
            f"{what}: B=1 maxsim != B=1 decompress_maxsim, row {b}"
    return err


def check_maxsim(rng, s: Shapes, device) -> float:
    """MaxSim over fp32 embeddings: at full width (ragged prefix masks,
    an all-invalid doc) with B=1 launches of three rows, then the edge
    batches of ``MAXSIM_EDGES`` with B=1 launches of every row; each
    held by ``hold_maxsim``. Returns the largest |kernel - plain|."""
    x = maxsim_inputs(rng, s, device)
    err = hold_maxsim(x, "maxsim full width", b1_rows=(0, 1, 3))
    del x
    log(f"maxsim full width: max |err| {err:.3g}, == decompress_maxsim "
        "and a second launch bit for bit, B=1 rows == batch rows")
    for B, C, Lq, d in MAXSIM_EDGES:
        x = maxsim_edge_inputs(rng, B, C, s.Ld, Lq, d, device)
        e = hold_maxsim(x, f"maxsim B={B} C={C} Lq={Lq} d={d}",
                        b1_rows=range(B))
        err = max(err, e)
    log(f"maxsim edges {MAXSIM_EDGES}: max |err| {err:.3g}, every bit as "
        "above")
    return err


# ---------------------------------------------------------------------------
# phase 3: a synthetic index at full width
# ---------------------------------------------------------------------------

def splade_topics(rng, s: Shapes) -> np.ndarray:
    """(vocab // terms_per_topic, terms_per_topic) topic vocabularies,
    each of distinct term ids, as the repo's synthetic generator draws
    them."""
    return np.stack([rng.choice(s.vocab, s.terms_per_topic, replace=False)
                     for _ in range(s.vocab // s.terms_per_topic)])


def topic_terms(rng, topics: np.ndarray, n: int, n_terms: int):
    """n sparse vectors, each of n_terms distinct terms of one random
    topic drawn without replacement with weight 1/rank (Gumbel top-k)
    → (term ids (n, n_terms) i32, weights (n, n_terms) f32)."""
    m = topics.shape[1]
    keys = rng.gumbel(size=(n, m)) - np.log(np.arange(1, m + 1))
    slots = np.argpartition(-keys, n_terms - 1, axis=1)[:, :n_terms]
    topic = rng.integers(0, len(topics), n)
    ids = topics[topic[:, None], slots].astype(np.int32)
    return ids, (1.0 + rng.exponential(0.5, (n, n_terms))).astype(np.float32)


def write_synthetic_index(rng, s: Shapes, out: pathlib.Path, nbits: int = 4):
    from repro_torch.index.builder import write_index
    from repro_torch.index.splade_index import build_splade_index

    # MS MARCO passages average 67 tokens (configs/colbert_serve.py)
    doclens = np.clip(rng.normal(67, 30, s.n_docs).round(), 8, s.Ld)
    doclens = doclens.astype(np.int64)
    doclens[rng.integers(0, s.n_docs, s.n_docs // 50)] = s.Ld
    n_tokens = int(doclens.sum())
    cids = rng.integers(0, s.K, n_tokens, dtype=np.int32)
    packed = rng.integers(0, 256, (n_tokens, s.d * nbits // 8),
                          dtype=np.uint8)
    centroids = unit(rng.normal(size=(s.K, s.d)))
    cutoffs = np.sort(rng.normal(scale=0.05, size=2 ** nbits - 1))
    weights = np.sort(rng.normal(scale=0.05, size=2 ** nbits))
    write_index(out / "colbert", cids, packed, centroids, cutoffs, weights,
                doclens, s.K, doc_maxlen=s.Ld)
    topics = splade_topics(rng, s)
    term_ids, term_w = topic_terms(rng, topics, s.n_docs, s.doc_terms)
    build_splade_index(term_ids, term_w, s.vocab, s.n_docs).save(
        out / "splade")
    return n_tokens, topics


def kernel_rows(cache, tids, tw):
    """The SPLADE kernel's (term rows, scaled weights) for a batch of
    queries, on the cache's device — what ``score_topk`` launches on."""
    return cache.upload(*cache.scaled_weights(
        *cache.pad_queries(list(tids), list(tw))))


def check_splade(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
                 device) -> dict:
    """The SPLADE kernel's two entry points on the index's own postings,
    read from the cache's pid-sorted rows: the scores against the plain
    version on the card (atomics there: a tolerance) and, bit for bit,
    on the CPU over the unsorted ``as_padded`` layout; the per-block
    top-k candidates and the merged top-k bit for bit against theirs;
    the cache's top-k against the host scorer bit for bit. Returns the
    largest |kernel - plain| of each entry point."""
    import torch
    from repro_torch.index.splade_device import SpladeDeviceCache
    from repro_torch.index.splade_index import SpladeIndex
    from repro_torch.kernels.splade_score.ops import (
        SCORE_BLOCK_DOCS, TOPK_BLOCK_DOCS, splade_block_scores,
        splade_block_scores_batch, splade_block_topk_batch,
        splade_row_block_candidates, splade_row_scores_batch,
        splade_row_topk_batch)
    from repro_torch.kernels.splade_score.ref import (
        block_topk_ref, splade_row_scores_batch_ref)
    from repro_torch.testing import ATOL, RTOL

    index = SpladeIndex.load(path / "splade", mmap=True)
    cache = SpladeDeviceCache(index, device=device)
    log(f"splade cache: max_df {cache.max_df}, truncated_terms "
        f"{cache.truncated_terms}, nbytes {cache.nbytes()}, n_docs "
        f"{cache.n_docs}, in blocks of {SCORE_BLOCK_DOCS} (scores; the "
        f"last of {cache.n_docs % SCORE_BLOCK_DOCS}) and {TOPK_BLOCK_DOCS} "
        f"(top-k; the last of {cache.n_docs % TOPK_BLOCK_DOCS})")
    assert cache.truncated_terms == 0 and cache.row_pids is cache.pids
    assert cache.n_docs % SCORE_BLOCK_DOCS and cache.n_docs % TOPK_BLOCK_DOCS
    tids, tw = (list(a) for a in topic_terms(rng, topics, s.B,
                                              s.query_terms))
    tw[5] = np.zeros_like(tw[5])                     # an all-zero query
    rows, w = kernel_rows(cache, tids, tw)
    err = {"splade_score": 0.0, "splade_topk": 0.0}

    def against_plain(c, what):
        """Both entry points on the sorted copy against the plain version
        on the as_padded layout, which is unsorted where rows are
        truncated."""
        got = splade_row_scores_batch(c.row_pids, c.row_imps, rows, w,
                                      n_docs=c.n_docs)
        on_card = splade_row_scores_batch_ref(c.pids, c.imps, rows, w,
                                              c.n_docs)
        torch.cuda.synchronize()
        e = (got - on_card).abs().max().item()
        err["splade_score"] = max(err["splade_score"], e)
        np.testing.assert_allclose(got.cpu().numpy(), on_card.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=what)
        cpu = (c.pids.cpu(), c.imps.cpu(), rows.cpu(), w.cpu())
        ordered = splade_row_scores_batch_ref(*cpu, c.n_docs)
        assert torch.equal(got.cpu().view(torch.int32),
                           ordered.view(torch.int32)), \
            f"{what}: kernel != ordered plain version"
        for k in (s.C, TOPK_BLOCK_DOCS - 1, TOPK_BLOCK_DOCS,
                  TOPK_BLOCK_DOCS + 1):
            cs, cp = splade_row_block_candidates(c.row_pids, c.row_imps,
                                                 rows, w, n_docs=c.n_docs,
                                                 k=k)
            ws, wp = block_topk_ref(ordered, k, TOPK_BLOCK_DOCS)
            fin = torch.isfinite(ws)
            err["splade_topk"] = max(err["splade_topk"], (
                cs.cpu()[fin] - ws[fin]).abs().max().item())
            assert torch.equal(cp.cpu(), wp) and torch.equal(
                cs.cpu().view(torch.int32), ws.view(torch.int32)), \
                f"{what}: top-{k} candidates != plain"
            tp, ts = splade_row_topk_batch(c.row_pids, c.row_imps, rows, w,
                                           n_docs=c.n_docs, k=k)
            hp, hs = splade_row_topk_batch(*cpu, n_docs=c.n_docs, k=k)
            assert torch.equal(tp.cpu(), hp) and torch.equal(
                ts.cpu().view(torch.int32), hs.view(torch.int32)), \
                f"{what}: top-{k} != plain"
        return got

    got = against_plain(cache, "splade serve batch")
    assert torch.all(got[5] == 0), "an all-zero query must score 0"
    one = splade_row_scores_batch(cache.row_pids, cache.row_imps, rows[2:3],
                                  w[2:3], n_docs=cache.n_docs)
    assert torch.equal(one[0], got[2]), "B=1 splade != batch row"
    for k in (FULL.C, cache.n_docs + 5):             # k > n_docs pads
        dp, ds = cache.score_topk(tids, tw, k)
        hp, hs = index.score_batch_host(tids, tw, k)
        assert np.array_equal(dp, hp), f"splade top-{k} pids != host"
        assert np.array_equal(ds.view(np.uint32), hs.view(np.uint32)), \
            f"splade top-{k} scores != host bits"
    log(f"splade: max |err| {err}; both entry points == their ordered "
        f"plain versions; top-{FULL.C} and the whole ranking equal the "
        "host scorer bit for bit")

    trunc = SpladeDeviceCache(index, max_df=64, device=device)
    assert trunc.truncated_terms > 0 and trunc.row_pids is not trunc.pids
    against_plain(trunc, "splade max_df=64")
    log(f"splade max_df=64: {trunc.truncated_terms} truncated terms; the "
        "kernel on the sorted copy == the ordered plain version on the "
        "unsorted layout")

    # unsorted gathered rows: repeated pids inside a row, -1 pads, f32
    # impacts, a B=1 launch
    pids = torch.as_tensor(rng.integers(-1, 40, (5, 16, 16), dtype=np.int32))
    imps = torch.as_tensor(rng.random((5, 16, 16), np.float32))
    pw = torch.as_tensor(rng.random((5, 16), np.float32))
    dev = (pids.to(device), imps.to(device), pw.to(device))
    got = splade_block_scores_batch(*dev, n_docs=700)
    want = splade_block_scores_batch(pids, imps, pw, n_docs=700)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    one = splade_block_scores(*(t[1] for t in dev), n_docs=700)
    assert torch.equal(one, got[1])
    for k in (1, 50, 700):
        tp, ts = splade_block_topk_batch(*dev, n_docs=700, k=k)
        hp, hs = splade_block_topk_batch(pids, imps, pw, n_docs=700, k=k)
        assert torch.equal(tp.cpu(), hp) and torch.equal(ts.cpu(), hs)
    try:
        cache.score_topk([np.array([s.vocab + 3])], [np.ones(1, np.float32)],
                         5)
    except IndexError:
        pass
    else:
        raise AssertionError("an out-of-vocabulary id must raise")
    log("splade edge cases: unsorted rows with repeated pids, all-zero "
        "weights, k around the block size, k > n_docs, ragged last block, "
        "truncation, out-of-vocabulary id")
    return err


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def plaid_params(s: Shapes):
    from repro_torch.core.plaid import PlaidParams
    return PlaidParams(nprobe=s.nprobe, candidate_cap=s.candidate_cap,
                       ndocs=s.ndocs, k=100)


def make_searcher(path: pathlib.Path, device, resident: bool = False):
    """The index's searcher on ``device``: the mmap pool, or with
    ``resident`` the pool held on the device."""
    from repro_torch.core.plaid import PLAIDSearcher
    from repro_torch.index.builder import ColBERTIndex
    return PLAIDSearcher(ColBERTIndex(path / "colbert", mode="mmap"),
                         plaid_params(FULL), device_resident=resident,
                         device=device)


def make_retriever(path: pathlib.Path, device, resident: bool = False):
    from repro_torch.core.multistage import (MultiStageParams,
                                             MultiStageRetriever)
    from repro_torch.index.splade_index import SpladeIndex
    return MultiStageRetriever(
        SpladeIndex.load(path / "splade", mmap=True),
        make_searcher(path, device, resident),
        MultiStageParams(first_k=FULL.C, k=100), device=device)


def counted_kernels() -> dict:
    """Every kernel wrapper with a launch count, by name."""
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk_batch as frk)
    from repro_torch.kernels.maxsim.ops import maxsim_scores_batch
    from repro_torch.kernels.splade_score.ops import (splade_row_scores_batch,
                                                      splade_row_topk_batch)
    return {"decompress_maxsim": dms, "fused_rerank": frk,
            "splade_score": splade_row_scores_batch,
            "splade_topk": splade_row_topk_batch,
            "maxsim": maxsim_scores_batch}


def check_launches(label: str, launches: dict, path_kernels) -> None:
    """Each kernel of the run's path launched, and no other."""
    for name in path_kernels:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was never launched in the "
                               f"{label} run")
    for name in set(launches) - set(path_kernels):
        if launches[name]:
            raise RuntimeError(f"the {label} run launched {name}, which is "
                               "not on its path")


def make_requests(rng, s: Shapes, topics: np.ndarray, n: int,
                  qid0: int = 0):
    from repro_torch.serving.engine import Request
    methods = ("rerank", "hybrid", "splade")
    term_ids, term_w = topic_terms(rng, topics, n, s.query_terms)
    reqs = []
    for i in range(n):
        m = methods[i % 3]
        alpha = None if i % 4 else float(rng.uniform(0.1, 0.9))
        reqs.append(Request(
            qid=qid0 + i, method=m, q_emb=unit(rng.normal(size=(s.Lq, s.d))),
            term_ids=term_ids[i], term_weights=term_w[i],
            k=(10, 100)[(i // 3) % 2], alpha=alpha))
    return reqs


def serve_run(engine, warm, reqs, max_batch: int, counted: dict,
              on_start=None):
    """Serve ``reqs`` through a ``RetrievalServer`` over ``engine`` after
    a warm-up batch, with every counter of ``counted`` (name → wrapper)
    set to 0 just before the requests and read just after;
    ``on_start()``, if given, is called just before the requests."""
    from repro_torch.serving.server import RetrievalServer

    if engine.pipelined:     # the executors start in the warm-up
        engine.process_batch_async(warm).result(timeout=600)
    else:
        engine.process_batch(warm)
    server = RetrievalServer(engine, max_batch=max_batch,
                             batch_timeout_ms=5.0)
    server.start()
    try:
        engine.retriever.reset_stage_stats()
        for fn in counted.values():
            fn.launches = 0
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        futs = [server.submit(r) for r in reqs]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counted.items()}
        health = server.health()
    finally:
        server.stop()
    if health["failed"] or health["served"] != len(reqs) + len(warm):
        raise RuntimeError(f"server health: {health}")
    lat = np.array([r.latency for r in results]) * 1e3
    stages = {n: r["wall_s"] for n, r in health["stages"].items()}
    return results, {
        "requests": len(results), "max_batch": max_batch,
        "batches": health["batches"],
        "qps": len(results) / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "splade_stage1_s": stages.get("splade_stage1"),
        "stage_wall_s": stages,
        "stage_queue_wait_s": {n: r["queue_wait_s"]
                               for n, r in health["stages"].items()},
        "overlap_fraction": health["overlap_fraction"],
        "stage_pages": {n: r["pages_touched"]
                        for n, r in health["stages"].items()},
        "launches": launches,
        "launches_per_batch": {n: c / health["batches"]
                               for n, c in launches.items()}}


def serve_runs(s: Shapes):
    """Phase 4's runs: (label, stage-1 backend, rerank tail, max_batch,
    number of requests). The host/device pairs at max_batch=B run in
    turns so that the two backends are compared inside one call; then
    the server's default max_batch=1 and the split tail, each on fewer
    requests."""
    full = (s.B, s.n_requests)
    return (("host", "host", "fused", *full),
            ("device", "device", "fused", *full),
            ("device", "device", "fused", *full),
            ("host", "host", "fused", *full),
            ("device_b1", "device", "fused", 1, min(24, s.n_requests)),
            ("device_split", "device", "split", s.B,
             min(32, s.n_requests)))


def serve(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
          device) -> dict:
    """Serve the runs of :func:`serve_runs` (each a prefix of the same 64
    requests); every run's answers are held to one CPU reference, and
    each run's launch counts must show the kernels of its path. →
    {label: [run line, ...]}."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.testing import REF_MARGIN, assert_topk_match

    counted = counted_kernels()
    # the kernels each (stage-1 backend, rerank tail) must launch; the
    # device stage 1 runs the SPLADE kernel's top-k entry point
    stage1 = {"host": (), "device": ("splade_topk",)}
    tail = {"fused": ("decompress_maxsim", "fused_rerank"),
            "split": ("decompress_maxsim",)}
    retriever = make_retriever(path, device)
    warm = make_requests(rng, s, topics, 6, qid0=10_000)
    reqs = make_requests(rng, s, topics, s.n_requests)
    runs = []
    try:
        for label, backend, rerank, max_batch, n in serve_runs(s):
            retriever.set_rerank_backend(rerank)
            engine = ServeEngine(retriever, splade_backend=backend)
            results, line = serve_run(engine, warm, reqs[:n], max_batch,
                                      counted)
            line.update(splade_backend=backend, rerank_backend=rerank)
            runs.append((label, results, line))
            launches = line["launches"]
            log(f"served {len(results)} requests ({label}: {backend} stage "
                f"1, {rerank} tail, max_batch {max_batch}) in "
                f"{line['requests'] / line['qps']:.3f} s, {line['batches']} "
                f"batches; launches {launches}")
            check_launches(label, launches, stage1[backend] + tail[rerank])
    finally:
        retriever.set_rerank_backend("fused")

    # the reference answers REF_MARGIN places deeper, so that ties at
    # each answer's last place are visible
    ref_engine = ServeEngine(make_retriever(path, "cpu"))
    deeper = [dataclasses.replace(r, k=r.k + REF_MARGIN) for r in reqs]
    want = []
    for lo in range(0, len(deeper), s.B):
        want += ref_engine.process_batch(deeper[lo:lo + s.B])
    for label, results, _ in runs:
        for res, ref, req in zip(results, want, reqs):
            assert res.qid == ref.qid == req.qid
            assert_topk_match(ref.scores, ref.pids, res.scores, res.pids,
                              what=f"{label}: qid {req.qid} {req.method} "
                                   f"k={req.k}")
    log(f"every answer of all {len(runs)} runs matches the CPU engine")

    tids = [r.term_ids for r in reqs]
    tw = [r.term_weights for r in reqs]
    dp, ds = retriever.run_splade_batch(tids, tw, backend="device")
    hp, hs = retriever.run_splade_batch(tids, tw, backend="host")
    assert np.array_equal(dp, hp) and np.array_equal(
        ds.view(np.uint32), hs.view(np.uint32)), \
        "device stage 1 != host stage 1 on the served requests"
    log(f"device stage 1 == host stage 1 bit for bit on the {len(reqs)} "
        "requests")
    return {lb: [line for lb2, _, line in runs if lb2 == lb]
            for lb in dict.fromkeys(r[0] for r in serve_runs(s))}


# ---------------------------------------------------------------------------
# phase 4: serve colbert (PLAID)
# ---------------------------------------------------------------------------

def colbert_requests(rng, s: Shapes, n: int, qid0: int = 0):
    """n colbert requests: unit random queries of ``s.Lq`` tokens,
    k ∈ {10, 100}."""
    from repro_torch.serving.engine import Request
    return [Request(qid=qid0 + i, method="colbert",
                    q_emb=unit(rng.normal(size=(s.Lq, s.d))),
                    k=(10, 100)[i % 2]) for i in range(n)]


def colbert_runs(s: Shapes):
    """The colbert runs of phase 4: (label, pool resident on the card,
    rerank tail, max_batch, number of requests), each a prefix of the
    same requests."""
    n = s.n_requests
    return (("colbert", False, "fused", s.B, n),
            ("colbert_split", False, "split", s.B, min(32, n)),
            ("colbert_resident", True, "fused", s.B, min(32, n)),
            ("colbert_b1", False, "fused", 1, min(16, n)))


def candidate_counts(searcher, q_embs, B: int) -> dict:
    """Real candidates per query: the union of its probed lists, and
    what stage 2 keeps of it under the cap."""
    import torch
    before, after = [], []
    for lo in range(0, len(q_embs), B):
        st = searcher.probe_batch(q_embs[lo:lo + B])
        n = st["cids"].shape[0]
        union = searcher.ivf_padded[st["cids"].reshape(n, -1).long()]
        before += [int(torch.unique(r[r >= 0]).numel())
                   for r in union.reshape(n, -1)]
        after += (st["cand"] >= 0).sum(dim=1).tolist()
    cap = searcher.params.candidate_cap

    def summary(x):
        return {"min": int(np.min(x)), "median": float(np.median(x)),
                "max": int(np.max(x))}

    return {"before_cap": summary(before), "after_cap": summary(after),
            "queries_capped": int(sum(b > cap for b in before)),
            "queries": len(before), "ivf_longest_list": int(
                searcher.ivf_padded.shape[1])}


def check_colbert_stages(cpu, dev, q_embs, device) -> dict:
    """Stages 1-3 of one batch on the card against the CPU: probe scores
    allclose (and a B=1 probe equal to its batch row bit for bit); the
    stage-2 candidates from the CPU's probed centroids equal exactly;
    the approximate scores of the CPU's candidates allclose. Returns the
    largest differences."""
    import torch
    from repro_torch.core.plaid import (stage2_candidates_batch,
                                        stage3_approx_score_batch)
    from repro_torch.testing import ATOL, RTOL

    g, c = dev.probe_batch(q_embs), cpu.probe_batch(q_embs)
    want = c["scores_c"].to(device)
    diff = (g["scores_c"] - want).abs()
    probe_err = diff.max().item()
    if not bool((diff <= ATOL + RTOL * want.abs()).all()):
        raise AssertionError(f"probe scores differ by up to {probe_err}")
    del want, diff
    nprobe = dev.params.nprobe
    moved = sum(set(a) != set(b) for a, b in zip(
        g["cids"].cpu().numpy().reshape(-1, nprobe),
        c["cids"].numpy().reshape(-1, nprobe)))
    one = dev.probe_batch(q_embs[3:4])
    if not torch.equal(one["scores_c"][0], g["scores_c"][3]):
        raise AssertionError("a B=1 probe != its batch row")
    cand = stage2_candidates_batch(dev.ivf_padded, c["cids"].to(device),
                                   dev.params.candidate_cap)
    if not torch.equal(cand.cpu(), c["cand"]):
        raise AssertionError("stage-2 candidates from equal probes differ")
    codes, valid = cpu.gather_codes_batch(c["cand"].numpy())
    got = stage3_approx_score_batch(g["scores_c"], *dev.to_device(
        codes, valid), g["q_valid"]).cpu().numpy()
    ref = stage3_approx_score_batch(c["scores_c"], *cpu.to_device(
        codes, valid), c["q_valid"]).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                               err_msg="approximate scores")
    out = {"probe_max_abs_err": probe_err, "probe_tokens_moved": moved,
           "probe_tokens": len(q_embs) * len(q_embs[0]),
           "approx_max_abs_err": float(np.abs(got - ref).max())}
    log(f"colbert stages 1-3 vs CPU on {len(q_embs)} queries: {out}; "
        "B=1 probe == batch row, stage 2 equal")
    return out


def serve_colbert(rng, s: Shapes, path: pathlib.Path, device):
    """Serve the runs of :func:`colbert_runs` through ``RetrievalServer``
    on the card. Each run must launch its tail's kernel and no other;
    the mmap runs' codes gather must touch no residual page. Every
    answer is held to a ``device="cpu"`` engine, under the tie rule
    (``repro_torch.testing.assert_colbert_match``); the resident and the
    split runs equal the mmap fused run bit for bit. → ({label: run
    line}, stage check, candidate counts)."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.testing import REF_MARGIN, assert_colbert_match

    counted = counted_kernels()
    tail = {"fused": ("fused_rerank",), "split": ("decompress_maxsim",)}
    pools = {False: make_retriever(path, device),
             True: make_retriever(path, device, resident=True)}
    warm = colbert_requests(rng, s, 4, qid0=20_000)
    reqs = colbert_requests(rng, s, s.n_requests)
    runs = []
    for label, resident, rerank, max_batch, n in colbert_runs(s):
        retriever = pools[resident]
        retriever.set_rerank_backend(rerank)
        try:
            results, line = serve_run(ServeEngine(retriever), warm,
                                      reqs[:n], max_batch, counted)
        finally:
            retriever.set_rerank_backend("fused")
        line.update(method="colbert", rerank_backend=rerank,
                    pool="resident" if resident else "mmap")
        check_launches(label, line["launches"], tail[rerank])
        pages = line["stage_pages"]
        if not resident and (pages["host_gather:codes"] != 0
                             or pages["host_gather:residuals"] == 0):
            raise RuntimeError(f"{label}: residual pages touched by the "
                               f"codes / residual gathers: {pages}")
        log(f"served {n} colbert requests ({label}: {line['pool']} pool, "
            f"{rerank} tail, max_batch {max_batch}) at {line['qps']:.1f} "
            f"QPS, p50 {line['p50_ms']:.1f} ms, p99 {line['p99_ms']:.1f} "
            f"ms; stage walls {line['stage_wall_s']}; residual pages "
            f"{pages}; launches {line['launches']}")
        runs.append((label, results, line, retriever.searcher))

    cpu = make_retriever(path, "cpu")
    ref_engine = ServeEngine(cpu)
    deeper = [dataclasses.replace(r, k=r.k + REF_MARGIN) for r in reqs]
    want = []
    for lo in range(0, len(deeper), s.B):
        want += ref_engine.process_batch(deeper[lo:lo + s.B])
    for label, results, line, searcher in runs:
        routes = {}
        for res, ref, req in zip(results, want, reqs):
            assert res.qid == ref.qid == req.qid
            route = assert_colbert_match(
                cpu.searcher, searcher, req.q_emb, (ref.scores, ref.pids),
                (res.scores, res.pids),
                what=f"{label}: qid {req.qid} k={req.k}")
            if route:
                routes[route] = routes.get(route, 0) + 1
        line["tie_routes"] = routes
        log(f"{label}: all {len(results)} answers match the CPU engine; "
            f"through a tie at a stage boundary: {routes or 'none'}")
    by_label = {label: results for label, results, _, _ in runs}
    for label in ("colbert_split", "colbert_resident"):
        for a, b in zip(by_label[label], by_label["colbert"]):
            if not (np.array_equal(a.pids, b.pids) and np.array_equal(
                    a.scores.view(np.uint32), b.scores.view(np.uint32))):
                raise AssertionError(f"{label} qid {a.qid} != the mmap "
                                     "fused run")
    log("colbert: the split and the resident runs equal the mmap fused "
        "run bit for bit")
    stages = check_colbert_stages(cpu.searcher, pools[False].searcher,
                                  [r.q_emb for r in reqs[:s.B]], device)
    counts = candidate_counts(pools[False].searcher,
                              [r.q_emb for r in reqs], s.B)
    log(f"colbert candidates per query: {counts}")
    return {label: line for label, _, line, _ in runs}, stages, counts


# ---------------------------------------------------------------------------
# phase 4c: the front door (caches, admission, the adaptive batch cap)
# ---------------------------------------------------------------------------

DOOR_METHODS = ("splade", "rerank", "hybrid", "colbert")
DOOR_KERNELS = ("splade_topk", "fused_rerank", "decompress_maxsim")


def door_requests(rng, s: Shapes, topics: np.ndarray, n: int,
                  methods=DOOR_METHODS, qid0: int = 0):
    """n requests of distinct random queries (a unit query of ``s.Lq``
    tokens and ``s.query_terms`` topic terms each), the methods in turn,
    k ∈ {10, 100}, a quarter with their own α."""
    from repro_torch.serving.engine import Request
    term_ids, term_w = topic_terms(rng, topics, n, s.query_terms)
    reqs = []
    for i in range(n):
        alpha = None if i % 4 else float(rng.uniform(0.1, 0.9))
        reqs.append(Request(
            qid=qid0 + i, method=methods[i % len(methods)],
            q_emb=unit(rng.normal(size=(s.Lq, s.d))), term_ids=term_ids[i],
            term_weights=term_w[i], k=(10, 100)[(i // len(methods)) % 2],
            alpha=alpha))
    return reqs


def fresh(reqs, **kw):
    """Copies of requests without their lifecycle record (``ctx``), so
    that an engine resolves each anew; ``kw`` replaces fields."""
    return [dataclasses.replace(r, ctx=None, **kw) for r in reqs]


def same_bits(want, got, what: str) -> None:
    """Each result of ``got`` equals its result in ``want`` bit for bit."""
    for a, b in zip(want, got, strict=True):
        if not (np.array_equal(a.pids, b.pids) and np.array_equal(
                np.asarray(a.scores).view(np.uint32),
                np.asarray(b.scores).view(np.uint32))):
            raise AssertionError(f"{what}: qid {b.qid} differs from its "
                                 "cold answer")


def reset_counts(retriever, counted: dict) -> None:
    """Set the stage records and every launch count to 0."""
    retriever.reset_stage_stats()
    for fn in counted.values():
        fn.launches = 0


def read_counts(counted: dict) -> dict:
    return {n: fn.launches for n, fn in counted.items()}


def expect_launches(what: str, launches: dict, want: dict) -> None:
    """The run launched exactly ``want`` (name → count; others 0)."""
    got = {n: c for n, c in launches.items() if c}
    if got != {n: c for n, c in want.items() if c}:
        raise RuntimeError(f"{what}: launches {launches}, expected {want}")


class ProbeCalls:
    """Counts a searcher's probe (stages 1-2) and approximate-stage calls
    while in use: a survivor hit makes neither."""

    def __init__(self, searcher):
        self.searcher, self.calls = searcher, 0

    def _counted(self, fn):
        def call(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        return call

    def __enter__(self):
        s = self.searcher
        s.probe_batch = self._counted(s.probe_batch)
        s.approx_select_batch = self._counted(s.approx_select_batch)
        return self

    def __exit__(self, *exc):
        del self.searcher.probe_batch, self.searcher.approx_select_batch


def hold_to_cpu(cpu, searchers: dict, held: list, s: Shapes) -> dict:
    """Hold each (request, card result, pool) of ``held`` to the CPU
    engine's answer ``REF_MARGIN`` places deeper; ``colbert`` through the
    tie rule against that pool's searcher. → {tie route: count}."""
    from repro_torch.testing import (REF_MARGIN, assert_colbert_match,
                                     assert_topk_match)
    deeper = [dataclasses.replace(r, ctx=None, k=r.k + REF_MARGIN)
              for r, _, _ in held]
    want = []
    for lo in range(0, len(deeper), s.B):
        want += cpu.process_batch(deeper[lo:lo + s.B])
    routes = {}
    for (req, res, pool), ref in zip(held, want, strict=True):
        what = f"front door: qid {req.qid} {req.method} k={req.k}"
        if req.method != "colbert":
            assert_topk_match(ref.scores, ref.pids, res.scores, res.pids,
                              what=what)
            continue
        route = assert_colbert_match(
            cpu.retriever.searcher, searchers[pool], req.q_emb,
            (ref.scores, ref.pids), (res.scores, res.pids), what=what)
        if route:
            routes[route] = routes.get(route, 0) + 1
    return routes


def door_exact(cached, counted, batch) -> tuple:
    """A: a cold mixed batch, then the same batch again: every answer an
    exact hit equal to the cold one bit for bit, with no launch and no
    stage run."""
    retriever = cached.retriever
    reset_counts(retriever, counted)
    t0 = time.perf_counter()
    cold = cached.process_batch(fresh(batch))
    cold_s = time.perf_counter() - t0
    launches = read_counts(counted)
    check_launches("front door cold batch", launches, DOOR_KERNELS)
    if any(r.cache_hit for r in cold):
        raise AssertionError("A: a hit in the cold batch")
    reset_counts(retriever, counted)
    t0 = time.perf_counter()
    warm = cached.process_batch(fresh(batch))
    hit_s = time.perf_counter() - t0
    stages = retriever.pipeline_stats.snapshot()["stages"]
    if not all(r.cache_hit for r in warm):
        raise AssertionError("A: the repeated batch missed the exact cache")
    same_bits(cold, warm, "A: exact hit")
    expect_launches("A: exact hits", read_counts(counted), {})
    if stages:
        raise AssertionError(f"A: exact hits ran stages {list(stages)}")
    if any(r.pids.flags.writeable or r.scores.flags.writeable for r in warm):
        raise AssertionError("A: a hit's arrays are writeable")
    return cold, {"requests": len(batch), "cold_s": cold_s, "hit_s": hit_s,
                  "hits": len(warm), "launches_cold": launches,
                  "launches_hit": 0}


def door_stage1(cached, plain, counted, batch, rng) -> tuple:
    """B: hybrid and rerank requests on the terms the cold batch's splade
    requests scored, at another α or k: every row a stage-1 hit, no
    SPLADE launch, one launch of each tail; equal to the engine without
    caches bit for bit."""
    retriever = cached.retriever
    sp = [r for r in batch if r.method == "splade"]
    reqs = ([dataclasses.replace(r, ctx=None, qid=r.qid + 1000,
                                 method="hybrid",
                                 alpha=float(rng.uniform(0.1, 0.9)))
             for r in sp]
            + [dataclasses.replace(r, ctx=None, qid=r.qid + 2000,
                                   method="rerank", k=110 - r.k)
               for r in sp])
    reset_counts(retriever, counted)
    got = cached.process_batch(fresh(reqs))
    launches = read_counts(counted)
    counters = retriever.pipeline_stats.snapshot()["counters"]
    if any(r.cache_hit for r in got):
        raise AssertionError("B: an exact hit")
    if counters != {"cache_stage1_hits": len(reqs),
                    "cache_stage1_misses": 0, "cache_exact_stores":
                    len(reqs)}:
        raise AssertionError(f"B: counters {counters}")
    expect_launches("B: stage-1 hits", launches,
                    {"fused_rerank": 1, "decompress_maxsim": 1})
    same_bits(plain.process_batch(fresh(reqs)), got, "B: stage-1 hit")
    return reqs, got, {"requests": len(reqs), "counters": counters,
                       "launches": launches}


def door_survivors(cached, plain, counted, batch) -> tuple:
    """C: the cold batch's colbert requests at the other k: every row a
    survivor hit (no probe or approximate stage, no codes read), one
    fused_rerank launch; equal to the engine without caches bit for
    bit."""
    retriever = cached.retriever
    reqs = [dataclasses.replace(r, ctx=None, k=110 - r.k)
            for r in batch if r.method == "colbert"]
    reset_counts(retriever, counted)
    with ProbeCalls(retriever.searcher) as calls:
        got = cached.process_batch(fresh(reqs))
    snap = retriever.pipeline_stats.snapshot()
    codes = snap["stages"]["host_gather:codes"]
    launches = read_counts(counted)
    if calls.calls or snap["counters"].get("cache_stage1_hits") != len(reqs):
        raise AssertionError(f"C: probe calls {calls.calls}, counters "
                             f"{snap['counters']}")
    if codes["pages_touched"] or codes["tokens_read"]:
        raise AssertionError(f"C: the codes gather read {codes}")
    expect_launches("C: survivor hits", launches, {"fused_rerank": 1})
    same_bits(plain.process_batch(fresh(reqs)), got, "C: survivor hit")
    return reqs, got, {"requests": len(reqs), "probe_calls": calls.calls,
                       "counters": snap["counters"],
                       "codes_gather": {n: codes[n] for n in (
                           "pages_touched", "tokens_read")},
                       "launches": launches}


def front_door(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
               device) -> tuple:
    """Phase 4c: checks A-H and the Zipf trace (see the module docstring)
    on the phase-3 index, with the device stage 1 and the fused tail. →
    (the phase's figures, the cold batch's launches)."""
    from repro_torch.serving.context import CacheHierarchy
    from repro_torch.serving.engine import ServeEngine

    counted = counted_kernels()
    retr = make_retriever(path, device)
    plain = ServeEngine(retr, splade_backend="device")
    caches = CacheHierarchy(exact_entries=256, stage1_entries=256)
    cached = ServeEngine(retr, caches=caches)
    out = {}
    plain.process_batch(door_requests(rng, s, topics, 8, qid0=30_000))

    batch = door_requests(rng, s, topics, s.B, qid0=31_000)
    cold, out["A"] = door_exact(cached, counted, batch)
    held = [(r, res, "mmap") for r, res in zip(batch, cold)]
    log(f"front door A: {s.B} exact hits equal their cold answers bit for "
        f"bit, no launch, no stage; cold {out['A']['cold_s']:.3f} s, hits "
        f"{out['A']['hit_s'] * 1e3:.3f} ms")

    reqs, got, out["B"] = door_stage1(cached, plain, counted, batch, rng)
    held += [(r, res, "mmap") for r, res in zip(reqs, got)]
    log(f"front door B: {len(reqs)} stage-1 hits equal the engine without "
        f"caches bit for bit; launches {out['B']['launches']}")

    reqs, got, out["C"] = door_survivors(cached, plain, counted, batch)
    held += [(r, res, "mmap") for r, res in zip(reqs, got)]
    resident = make_retriever(path, device, resident=True)
    r_cached = ServeEngine(resident, caches=CacheHierarchy(256, 256))
    r_cached.process_batch(fresh([r for r in batch
                                  if r.method == "colbert"]))
    _, r_got, out["C_resident"] = door_survivors(
        r_cached, ServeEngine(resident), counted, batch)
    same_bits(got, r_got, "C: resident survivor hit vs mmap")
    log(f"front door C: {len(reqs)} colbert survivor hits at the other k, "
        "mmap and resident, no probe, no codes read, one fused_rerank "
        "launch each; equal to the engine without caches and resident == "
        "mmap bit for bit")

    new = door_requests(rng, s, topics, s.B // 2, qid0=32_000)
    mixed = [x for pair in zip(batch[:s.B // 2], new) for x in pair]
    reset_counts(retr, counted)
    got = cached.process_batch(fresh(mixed))
    if [r.cache_hit for r in got] != [True, False] * (s.B // 2):
        raise AssertionError("D: hits are not the cached half")
    same_bits(plain.process_batch(fresh(mixed)), got, "D: partial hits")
    held += [(r, res, "mmap") for r, res in zip(mixed[1::2], got[1::2])]
    out["D"] = {"requests": len(mixed), "hits": s.B // 2,
                "launches": read_counts(counted)}
    log(f"front door D: a batch of {len(mixed)} with {s.B // 2} exact hits "
        "equals the engine without caches bit for bit")

    sizes = (len(caches.exact), len(caches.stage1))
    before = (caches.exact.invalidations, caches.stage1.invalidations)
    gen = retr.bump_index_generation()
    purged = (caches.exact.invalidations - before[0],
              caches.stage1.invalidations - before[1])
    if purged != sizes or len(caches.exact) or len(caches.stage1):
        raise AssertionError(f"E: purged {purged} of {sizes}")
    reset_counts(retr, counted)
    again = cached.process_batch(fresh(batch))
    counters = retr.pipeline_stats.snapshot()["counters"]
    if any(r.cache_hit for r in again) or counters.get("cache_stage1_hits"):
        raise AssertionError(f"E: a hit after the bump: {counters}")
    same_bits(cold, again, "E: after the generation bump")
    out["E"] = {"generation": gen, "purged": purged,
                "launches": read_counts(counted)}
    log(f"front door E: generation {gen} purged {purged} entries (exact, "
        "stage 1); the batch misses everything and gives the same bits")

    as_splade, f_res, out["F"], out["G"] = door_admission(
        cached, plain, rng, s, topics)
    held += [(r, res, "mmap") for r, res in zip(as_splade, f_res)]
    log(f"front door F: at an SLO of {out['F']['slo_ms']:.3f} ms (stage 1 "
        f"{out['F']['stage1_ms']:.3f} ms, tail {out['F']['tail_ms']:.3f} "
        f"ms) {len(f_res)} hybrid/rerank requests came back degraded "
        "(slo_tail), equal to the splade plan bit for bit and not stored; "
        "G: the request past its deadline was shed before it was queued")

    out["H"] = door_batch_cap(plain, rng, s, topics)
    log(f"front door H: batch_cap {out['H']}")

    out["trace"], t_held = door_trace(retr, plain, counted, rng, s, topics)
    held += t_held
    searchers = {"mmap": retr.searcher, "resident": resident.searcher}
    cpu = ServeEngine(make_retriever(path, "cpu"))
    out["tie_routes"] = hold_to_cpu(cpu, searchers, held, s)
    log(f"front door: {len(held)} distinct answers match the CPU engine; "
        f"through a tie at a stage boundary: {out['tie_routes'] or 'none'}")
    return out, out["A"]["launches_cold"]


def door_admission(cached, plain, rng, s: Shapes, topics) -> tuple:
    """F: through ``RetrievalServer`` admission at an SLO between the
    predicted cheap and full costs (from the stage EWMAs of a warm batch)
    degrades hybrid/rerank requests, one at a time (the queue empty at
    each decision), to the splade plan: its bits, flagged ``slo_tail``,
    never stored. G: a request with ``deadline_ms=0.001`` is shed before
    it is queued. → (the requests as splade requests, their results, F's
    figures, G's figures)."""
    from repro_torch.serving.admission import (AdmissionController,
                                               RequestShed)
    from repro_torch.serving.server import RetrievalServer
    retr, caches = cached.retriever, cached.caches
    retr.reset_stage_stats()
    plain.process_batch(door_requests(rng, s, topics, s.B,
                                      ("hybrid", "rerank", "splade"),
                                      qid0=33_000))
    stage1_ms, tail_ms, _ = AdmissionController.stage_costs(
        retr.pipeline_stats.snapshot()["stages"])
    # the splade plan's own dispatches move the stage-1 EWMA, by less
    # than half the tail when the tail is over twice stage 1
    if not tail_ms > 2 * stage1_ms:
        raise RuntimeError(f"F: tail {tail_ms} ms is not over twice stage "
                           f"1's {stage1_ms} ms")
    slo = stage1_ms + tail_ms / 2
    f_reqs = door_requests(rng, s, topics, 8, ("hybrid", "rerank"),
                           qid0=34_000)
    g_req = door_requests(rng, s, topics, 1, ("hybrid",), qid0=35_000)[0]
    g_req.deadline_ms = 0.001
    n_exact = len(caches.exact)
    srv = RetrievalServer(cached, max_batch=s.B, batch_timeout_ms=5.0,
                          admission=AdmissionController(slo))
    srv.start()
    try:
        f_res = [srv.submit(r).result(timeout=600) for r in f_reqs]
        depth = srv.queue.qsize()
        try:
            srv.submit(g_req).result(timeout=60)
        except RequestShed as e:
            shed = e.reason
        else:
            raise AssertionError("G: the request past its deadline was "
                                 "served")
        health = srv.health()
    finally:
        srv.stop()
    if any((r.degraded, r.degrade_reason) != (True, "slo_tail")
           for r in f_res):
        raise AssertionError("F: " + str([(r.degraded, r.degrade_reason)
                                          for r in f_res]))
    if len(caches.exact) != n_exact or any(
            caches.exact.get(r.ctx.cache_key, count_miss=False) is not None
            for r in f_reqs):
        raise AssertionError("F: a degraded answer was stored")
    as_splade = fresh(f_reqs, method="splade")
    same_bits(plain.process_batch(as_splade), f_res, "F: degraded answer")
    if (shed, health["sheds"], health["queue_depth"]) != ("deadline", 1,
                                                         depth):
        raise AssertionError(f"G: shed {shed}, health {health}")
    return as_splade, f_res, {
        "slo_ms": slo, "stage1_ms": stage1_ms, "tail_ms": tail_ms,
        "degraded": len(f_res), "admission": health["admission"]}, {
        "shed_reason": shed, "sheds": health["sheds"],
        "queue_depth": health["queue_depth"]}


def door_batch_cap(engine, rng, s: Shapes, topics) -> dict:
    """H: an SLO below one request's service time halves the batch cap to
    1; a slack one grows it back to ``max_batch`` after
    ``grow_patience`` batches that fill the cap. Requests are queued
    before the workers start, so that every batch fills."""
    from repro_torch.serving.server import RetrievalServer
    reqs = door_requests(rng, s, topics, 6 * s.B, ("splade",), qid0=36_000)
    one_ms = min(engine.process(r).service_time for r in reqs[:3]) * 1e3
    srv = RetrievalServer(engine, max_batch=s.B, batch_timeout_ms=5.0,
                          latency_slo_ms=one_ms / 4)
    out = {"slo_tight_ms": one_ms / 4}
    for label, part, slo in (("tight", reqs[:2 * s.B], one_ms / 4),
                             ("slack", reqs[2 * s.B:], 1e6)):
        srv.latency_slo_ms = slo
        futs = [srv.submit(r) for r in part]
        b0 = srv.batches
        srv.start()
        try:
            for f in futs:
                f.result(timeout=600)
        finally:
            srv.stop()
        out[label] = {"requests": len(part), "batches": srv.batches - b0,
                      "batch_cap": srv.batch_cap,
                      "ewma_latency_ms": srv.ewma_latency_ms}
    if out["tight"]["batch_cap"] != 1 or out["slack"]["batch_cap"] != s.B:
        raise AssertionError(f"H: {out}")
    return out


def door_trace(retr, plain, counted, rng, s: Shapes, topics,
               n_queries: int = 16, n: int = 256, zipf_s: float = 1.1):
    """The trace: ``n`` requests drawn with Zipf(``zipf_s``) over
    ``4 * n_queries`` distinct requests (each query asked by the four
    methods), served at max_batch=B in waves of B (a wave is submitted
    when the last one is answered), caches off and on in turns, twice
    each. Every repeat equals the distinct request's first answer of
    the first run bit for bit. → (figures, that run's distinct answers
    for the CPU check)."""
    from repro_torch.serving.context import CacheHierarchy
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.server import RetrievalServer

    distinct = []
    for q in door_requests(rng, s, topics, n_queries, ("splade",),
                           qid0=40_000):
        for m in DOOR_METHODS:
            alpha = (float(rng.uniform(0.1, 0.9)) if rng.random() < 0.25
                     else None)
            distinct.append(dataclasses.replace(
                q, method=m, qid=len(distinct), k=int(rng.choice([10, 100])),
                alpha=alpha))
    weight = np.arange(1, len(distinct) + 1, dtype=np.float64) ** -zipf_s
    weight = weight[rng.permutation(len(distinct))]
    order = rng.choice(len(distinct), size=n, p=weight / weight.sum())

    runs, first = [], {}
    for label in ("off", "on", "on", "off"):
        caches = CacheHierarchy(256, 256) if label == "on" else None
        retr.attach_caches(None)
        engine = plain if caches is None else ServeEngine(retr,
                                                          caches=caches)
        reset_counts(retr, counted)
        srv = RetrievalServer(engine, max_batch=s.B, batch_timeout_ms=5.0)
        srv.start()
        results, at_submit = [], []
        t0 = time.perf_counter()
        try:
            for lo in range(0, n, s.B):
                futs = []
                for j in order[lo:lo + s.B]:
                    futs.append(srv.submit(dataclasses.replace(
                        distinct[j], ctx=None)))
                    at_submit.append(futs[-1].done())
                results += [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            health = srv.health()
        finally:
            srv.stop()
        for j, res in zip(order, results):
            if j not in first:
                first[j] = res
            else:
                same_bits([first[j]], [res], f"trace ({label}): a repeat")
        lat = np.array([r.latency for r in results]) * 1e3
        sub = lat[np.array(at_submit)]
        c = health["counters"]
        s1 = c.get("cache_stage1_hits", 0) + c.get("cache_stage1_misses", 0)
        runs.append({
            "caches": label, "requests": n, "qps": n / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "exact_hits": int(sum(r.cache_hit for r in results)),
            "exact_hit_share": sum(r.cache_hit for r in results) / n,
            "submit_hits": int(len(sub)),
            "submit_hit_p50_ms": (float(np.percentile(sub, 50))
                                  if len(sub) else None),
            "stage1_lookups": s1,
            "stage1_hit_share": (c.get("cache_stage1_hits", 0) / s1
                                 if s1 else None),
            "batches": health["batches"], "counters": c,
            "stage_wall_s": {m: r["wall_s"]
                             for m, r in health["stages"].items()},
            "launches": read_counts(counted)})
        log(f"front door trace, caches {label}: {runs[-1]}")
    retr.attach_caches(None)
    held = [(distinct[j], first[j], "mmap") for j in sorted(first)]
    return {"distinct": len(distinct), "drawn": len(first),
            "zipf_s": zipf_s, "wave": s.B, "runs": runs}, held


# ---------------------------------------------------------------------------
# phase 4d: the pipelined executor
# ---------------------------------------------------------------------------

def pipelined_workloads(s: Shapes):
    """Phase 4d's workloads: (name, pool resident on the card, number of
    requests, the kernels of its path)."""
    return (("splade", False, s.n_requests,
             ("splade_topk", "decompress_maxsim", "fused_rerank")),
            ("colbert", False, s.n_requests, ("fused_rerank",)),
            ("colbert_resident", True, min(32, s.n_requests),
             ("fused_rerank",)))


# depth 1, then the executor with each worker mode, in turns
PIPELINED_TURNS = ((1, None), (2, "single"), (2, "kind"), (2, "kind"),
                   (2, "single"), (1, None))


def join_pipeline_threads(label: str) -> None:
    """Join the executor and retry threads a run left; fail if one
    outlives the join."""
    left = [t for t in threading.enumerate()
            if t.name.startswith(("pipe-", "pipeline-retry"))]
    for t in left:
        t.join(timeout=30)
    if any(t.is_alive() for t in left):
        raise RuntimeError(f"{label}: pipeline threads left running: "
                           f"{[t.name for t in left]}")


def pipelined(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
              device) -> dict:
    """Phase 4d: serve each workload of :func:`pipelined_workloads`
    through ``RetrievalServer`` at depth 1 and with the engine at
    ``pipeline_depth=2``, single and kind workers, in the turns of
    ``PIPELINED_TURNS`` (device stage 1, fused tail). Every answer
    equals the first depth-1 run's bit for bit, whose answers are held
    to the CPU engine; each run's launch counts show its path's kernels
    and no other; the mmap codes gather touches no residual page; no
    pipeline thread outlives its run. → {workload: [run line, ...]}."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.testing import REF_MARGIN, assert_colbert_match, \
        assert_topk_match

    counted = counted_kernels()
    splade_reqs = make_requests(rng, s, topics, s.n_requests)
    colbert_reqs = colbert_requests(rng, s, s.n_requests)
    warm = {"splade": make_requests(rng, s, topics, 6, qid0=50_000),
            "colbert": colbert_requests(rng, s, 4, qid0=50_100)}
    pools = {False: make_retriever(path, device),
             True: make_retriever(path, device, resident=True)}
    out, first = {}, {}
    for name, resident, n, kernels in pipelined_workloads(s):
        retriever = pools[resident]
        reqs = (splade_reqs if name == "splade" else colbert_reqs)[:n]
        lines = out[name] = []
        for depth, workers in PIPELINED_TURNS:
            engine = ServeEngine(retriever, splade_backend="device",
                                 pipeline_depth=depth,
                                 pipeline_workers=workers or "single")
            results, line = serve_run(
                engine, warm["splade" if name == "splade" else "colbert"],
                fresh(reqs), s.B, counted)
            label = f"pipelined {name} depth {depth}" + (
                f" {workers}" if workers else "")
            join_pipeline_threads(label)
            check_launches(label, line["launches"], kernels)
            pages = line["stage_pages"]
            if not resident and name == "colbert" and (
                    pages["host_gather:codes"] != 0
                    or pages["host_gather:residuals"] == 0):
                raise RuntimeError(f"{label}: residual pages touched by "
                                   f"the codes / residual gathers: {pages}")
            if name not in first:
                first[name] = results
            else:
                same_bits(first[name], results, label)
            line.update(workload=name, depth=depth, workers=workers,
                        pool="resident" if resident else "mmap")
            lines.append(line)
            log(f"{label}: {line['qps']:.1f} QPS, p50 "
                f"{line['p50_ms']:.1f} ms, p99 {line['p99_ms']:.1f} ms, "
                f"overlap {line['overlap_fraction']:.3f}, {line['batches']} "
                f"batches; stage walls {line['stage_wall_s']}; launches "
                f"{line['launches']}; equal to depth 1 bit for bit")

    cpu = make_retriever(path, "cpu")
    ref_engine = ServeEngine(cpu)
    for name, resident, n, _ in pipelined_workloads(s):
        if name == "colbert_resident":
            continue          # the prefix of the colbert draws, held below
        deeper = [dataclasses.replace(r, k=r.k + REF_MARGIN)
                  for r in (splade_reqs if name == "splade"
                            else colbert_reqs)[:n]]
        want = []
        for lo in range(0, len(deeper), s.B):
            want += ref_engine.process_batch(deeper[lo:lo + s.B])
        for res, ref, req in zip(first[name], want, deeper):
            what = f"pipelined {name}: qid {req.qid} {req.method}"
            if req.method == "colbert":
                assert_colbert_match(cpu.searcher, pools[False].searcher,
                                     req.q_emb, (ref.scores, ref.pids),
                                     (res.scores, res.pids), what=what)
            else:
                assert_topk_match(ref.scores, ref.pids, res.scores,
                                  res.pids, what=what)
    same_bits(first["colbert"][:len(first["colbert_resident"])],
              first["colbert_resident"], "pipelined: resident vs mmap")
    log("pipelined: every depth-1 answer matches the CPU engine, the "
        "resident colbert answers equal the mmap ones bit for bit")
    return out


# ---------------------------------------------------------------------------
# phase 4e: the TCP front
# ---------------------------------------------------------------------------

TCP_CLIENTS = 8        # client threads, one persistent connection each
TCP_ONCE = (0, 1, -2, -1)   # requests asked again in one-shot tcp_query
TCP_DRAIN = 32         # requests in flight when a drain starts
# (label, pipeline depth, executor workers, how the drain starts)
TCP_RUNS = (("tcp", 1, "single", "shutdown_gracefully"),
            ("tcp_pipelined", 2, "kind", "sigterm"))
# in process and over TCP, in turns
TCP_TURNS = ("in_process", "tcp", "tcp", "in_process")
# the port's refusal of a mutation on a frozen index (the JAX package's)
LIVE_OFF = "live index not enabled (enable_live / --live)"


def wire_line(req) -> bytes:
    """A request as a client sends it: one line of JSON. The wire has
    no α, so each request takes the retriever's."""
    msg = {"qid": req.qid, "method": req.method, "k": req.k,
           "q_emb": np.asarray(req.q_emb, np.float32).tolist()}
    if req.term_ids is not None:
        msg["term_ids"] = np.asarray(req.term_ids).tolist()
        msg["term_weights"] = np.asarray(req.term_weights,
                                         np.float32).tolist()
    return (json.dumps(msg) + "\n").encode()


class Conn:
    """A client's persistent connection: a line out, its reply in.

    Opening one waits for an admin line's reply, so that the server has
    accepted it before the next is opened: the front listened with
    ``socketserver``'s backlog of 5 until phase 4h's repair, and a burst
    of connections beyond it had its SYNs dropped and retried after a
    second."""

    def __init__(self, port: int, live: bool = False):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=600)
        self.rfile = self.sock.makefile("rb")
        reply = self.ask(b'{"op": "live_stats"}\n')
        if not reply.get("ok") or isinstance(reply["live"], dict) != live:
            raise RuntimeError(f"live_stats over TCP: {reply}")

    def ask(self, line: bytes) -> dict:
        self.sock.sendall(line)
        return json.loads(self.rfile.readline())

    def close(self):
        self.rfile.close()
        self.sock.close()


def closed_loop(calls, items) -> tuple:
    """Serve ``items`` ((qid, x) pairs) from ``len(calls)`` client
    threads, client i asking for items[i::n] one after another through
    ``calls[i]``. → ({qid: answer}, client latencies in ms, wall s)."""
    n = len(calls)
    out, lat, errors = {}, [], []
    lock = threading.Lock()

    def client(i):
        try:
            for qid, x in items[i::n]:
                t0 = time.perf_counter()
                ans = calls[i](x)
                dt = (time.perf_counter() - t0) * 1e3
                with lock:
                    out[qid] = ans
                    lat.append(dt)
        except Exception as e:            # reported below, on the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,),
                                name=f"tcp-client-{i}", daemon=True)
               for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"clients failed: {errors[:3]}")
    return out, lat, wall


def answer_bits(pids, scores) -> tuple:
    return (np.asarray(pids).tolist(),
            np.asarray(scores, np.float32).view(np.uint32).tolist())


def hold_reply(label: str, reply: dict, want, engine, req) -> None:
    """A TCP reply equals the in-process answer of its request bit for
    bit. Where it does not, the request is served alone, and the error
    says whether the row changed with its batch."""
    if "error" in reply or reply.get("qid") != want.qid:
        raise RuntimeError(f"{label}: qid {want.qid}: reply {reply}")
    got = answer_bits(reply["pids"], reply["scores"])
    if got == answer_bits(want.pids, want.scores):
        return
    alone = engine.process(fresh([req])[0])
    verdict = ("the row changes with its batch"
               if answer_bits(alone.pids, alone.scores) == got
               else "served alone it gives neither")
    raise AssertionError(
        f"{label}: qid {want.qid} {req.method}: TCP reply "
        f"{reply['pids']} {reply['scores']} != in process "
        f"{want.pids.tolist()} {want.scores.tolist()}; served alone "
        f"{alone.pids.tolist()} {alone.scores.tolist()}: {verdict}")


def check_admin(conn: Conn, port: int) -> None:
    """The admin lines' replies on a frozen index, the JAX package's."""
    h = conn.ask(b'{"op": "health"}\n')
    if not h.get("ok") or h["health"]["port"] != port:
        raise RuntimeError(f"health over TCP: {h}")
    want = {b'{"op": "live_stats"}\n': {"ok": True, "live": None},
            b'{"op": "upsert", "doc_emb": [[0.5, 0.5]]}\n':
                {"error": LIVE_OFF},
            b'{"op": "delete", "pid": 3}\n': {"error": LIVE_OFF},
            b'{"op": "compact"}\n': {"error": LIVE_OFF},
            b'{"op": "nope", "qid": 7}\n':
                {"error": "unknown op 'nope'", "qid": 7}}
    for line, reply in want.items():
        got = conn.ask(line)
        if got != reply:
            raise RuntimeError(f"admin line {line!r}: {got} != {reply}")


def live_threads(prefixes=("pipe-", "worker-", "sigterm-drain",
                           "tcp-")) -> list:
    """Threads of the server, its executors, its drain, its front and
    its clients (connection handlers included) that outlive a bounded
    join."""
    left = [t for t in threading.enumerate()
            if t.name.startswith(prefixes)
            or "process_request_thread" in t.name]
    for t in left:
        t.join(timeout=60)
    return [t.name for t in left if t.is_alive()]


def tcp_run(retriever, warm, reqs, lines, s: Shapes, label: str,
            depth: int, workers: str, drain: str, counted: dict) -> dict:
    """One server configuration behind the TCP front (see
    :func:`tcp_front`). → its line of the ``tcp`` JSON."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.server import RetrievalServer, tcp_query

    engine = ServeEngine(retriever, splade_backend="device",
                         pipeline_depth=depth, pipeline_workers=workers)
    if engine.pipelined:     # the executors start in the warm-up
        engine.process_batch_async(fresh(warm)).result(timeout=600)
    else:
        engine.process_batch(fresh(warm))
    server = RetrievalServer(engine, max_batch=s.B, batch_timeout_ms=5.0)
    submitted, cond = [], threading.Condition()
    submit = server.submit

    def counted_submit(req):
        fut = submit(req)
        with cond:
            submitted.append(fut)
            cond.notify_all()
        return fut

    server.submit = counted_submit
    server.start()
    tcp = server.serve_tcp("127.0.0.1", 0)
    port = server.tcp_port
    serving = threading.Thread(target=tcp.serve_forever, name="tcp-serve",
                               daemon=True)
    serving.start()
    conns, old_handler = [], None
    line = {"label": label, "depth": depth, "workers": workers,
            "drain": drain, "clients": TCP_CLIENTS, "turns": []}
    try:
        conns = [Conn(port) for _ in range(TCP_CLIENTS)]
        by_qid = {r.qid: r for r in reqs}
        want = None
        for turn in TCP_TURNS:
            reset_counts(retriever, counted)
            batches = server.health()["batches"]
            if turn == "tcp":
                got, lat, wall = closed_loop(
                    [c.ask for c in conns],
                    [(r.qid, ln) for r, ln in zip(reqs, lines)])
            else:
                got, lat, wall = closed_loop(
                    [lambda r: server.submit(fresh([r])[0]).result(
                        timeout=600)] * TCP_CLIENTS,
                    [(r.qid, r) for r in reqs])
            launches = read_counts(counted)
            what = f"{label} {turn}"
            check_launches(what, launches, DOOR_KERNELS)
            if want is None:
                want = got
            for qid, ans in got.items():
                if turn == "tcp":
                    hold_reply(what, ans, want[qid], engine, by_qid[qid])
                else:
                    same_bits([want[qid]], [ans], what)
            lat = np.array(lat)
            # from submit to the answer, as the server measures it
            served = np.array([a["latency"] if turn == "tcp" else a.latency
                               for a in got.values()]) * 1e3
            health = server.health()
            line["turns"].append({
                "turn": turn, "requests": len(got), "qps": len(got) / wall,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "server_p50_ms": float(np.percentile(served, 50)),
                "server_p99_ms": float(np.percentile(served, 99)),
                "batches": health["batches"] - batches,
                "stage_wall_s": {n: r["wall_s"]
                                 for n, r in health["stages"].items()},
                "launches": launches})
            log(f"{what}: {len(got)} requests from {TCP_CLIENTS} clients "
                f"at {len(got) / wall:.1f} QPS, p50 "
                f"{np.percentile(lat, 50):.2f} ms, p99 "
                f"{np.percentile(lat, 99):.2f} ms; launches {launches}; "
                "every answer equal to the first in-process turn's")
        check_admin(conns[0], port)
        for i in TCP_ONCE:
            reply = tcp_query("127.0.0.1", port, json.loads(lines[i]))
            hold_reply(f"{label} one-shot", reply, want[reqs[i].qid],
                       engine, reqs[i])
        log(f"{label}: admin lines as on a frozen index, health.port "
            f"{port}; {len(TCP_ONCE)} one-shot tcp_query replies equal")

        # the drain: TCP_DRAIN requests on connections of their own, the
        # drain started once every one of them is submitted
        half = TCP_DRAIN // 2
        idx = list(range(half)) + list(range(len(reqs) - half, len(reqs)))
        drain_conns = [Conn(port) for _ in idx]
        conns += drain_conns
        replies = [None] * len(idx)
        base = len(submitted)

        def ask(j):
            replies[j] = drain_conns[j].ask(lines[idx[j]])

        askers = [threading.Thread(target=ask, args=(j,),
                                   name=f"tcp-drain-client-{j}",
                                   daemon=True) for j in range(len(idx))]
        for t in askers:
            t.start()
        with cond:
            if not cond.wait_for(lambda: len(submitted) - base == len(idx),
                                 600):
                raise RuntimeError(f"{label}: drain requests not submitted")
            in_flight = sum(not f.done() for f in submitted[base:])
        if not in_flight:
            raise RuntimeError(f"{label}: every drain request was answered "
                               "before the drain started")
        t0 = time.perf_counter()
        if drain == "sigterm":
            old_handler = server.install_sigterm_handler()
            os.kill(os.getpid(), signal.SIGTERM)
        else:
            server.shutdown_gracefully()
        for t in askers:
            t.join(timeout=600)
        serving.join(timeout=600)
        for t in threading.enumerate():
            if t.name == "sigterm-drain":
                t.join(timeout=600)
        drain_s = time.perf_counter() - t0
        if serving.is_alive():
            raise RuntimeError(f"{label}: serve_forever did not return")
        for j, i in enumerate(idx):
            hold_reply(f"{label} drain", replies[j] or {}, want[reqs[i].qid],
                       engine, reqs[i])
        health = server.health()
        if health["workers"] or health["failed"]:
            raise RuntimeError(f"{label}: after the drain: {health}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=10).close()
            raise RuntimeError(f"{label}: the port takes connections after "
                               "the drain")
        except ConnectionRefusedError:
            pass
        line.update(in_flight_at_drain=in_flight, drain_s=drain_s)
        log(f"{label}: drain by {drain} with {in_flight} of {len(idx)} "
            f"requests in flight: every one answered, in {drain_s:.3f} s; "
            "serve_forever returned, 0 workers, new connections refused")
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
        for c in conns:
            c.close()
        server.shutdown_gracefully()
        serving.join(timeout=60)
    left = live_threads()
    if left:
        raise RuntimeError(f"{label}: threads left running: {left}")
    return line


def tcp_front(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
              device) -> tuple:
    """Phase 4e (see the module docstring). → (the ``tcp`` line's
    figures, {run label: launches of its first TCP turn})."""
    counted = counted_kernels()
    reqs = (make_requests(rng, s, topics, s.n_requests)
            + colbert_requests(rng, s, min(32, s.n_requests), qid0=1000))
    warm = (make_requests(rng, s, topics, 6, qid0=60_000)
            + colbert_requests(rng, s, 4, qid0=60_100))
    from repro_torch.serving.server import wire_request

    lines = [wire_line(r) for r in reqs]
    t0 = time.perf_counter()     # the handler's parse: the same requests
    reqs = [wire_request(json.loads(ln)) for ln in lines]
    parse_ms = (time.perf_counter() - t0) * 1e3 / len(lines)
    n_splade = s.n_requests
    out = {"requests": len(reqs), "splade_methods": n_splade,
           "colbert": len(reqs) - n_splade, "max_batch": s.B,
           "bytes_per_line": {
               "splade_methods": float(np.mean(
                   [len(ln) for ln in lines[:n_splade]])),
               "colbert": float(np.mean(
                   [len(ln) for ln in lines[n_splade:]]))},
           "parse_ms_per_request": parse_ms, "runs": []}
    retriever = make_retriever(path, device)
    launches = {}
    for label, depth, workers, drain in TCP_RUNS:
        line = tcp_run(retriever, warm, reqs, lines, s, label, depth,
                       workers, drain, counted)
        out["runs"].append(line)
        launches[label] = next(t["launches"] for t in line["turns"]
                               if t["turn"] == "tcp")
    log(f"tcp: {out['bytes_per_line']} bytes a line, json.loads + "
        f"np.asarray {parse_ms:.3f} ms a request on the host")
    return out, launches


# ---------------------------------------------------------------------------
# phase 4f: the live index
# ---------------------------------------------------------------------------

# (a): phase 3b's corpus; its last LIVE_HOLD docs are upserted into a
# pinned base of the rest, then round 1 tombstones LIVE_TOMB (base,
# delta) pids; round 2 updates LIVE_UPDATES docs (tombstone, upsert a
# changed copy) and tombstones LIVE_TOMB[1] of its own upserts
LIVE_HOLD = 256
LIVE_TOMB = (64, 8)
LIVE_UPDATES = 128
LIVE_KS = (10, 100)
# (b): phase 3's index, LIVE_UPSERTS unit-random documents upserted and
# LIVE_DELETES pids tombstoned; LIVE_MORE more upserts before the second
# compaction
LIVE_UPSERTS, LIVE_DELETES, LIVE_MORE = 256, 64, 64
LIVE_READERS = 3


def live_parity_params(cap: int) -> tuple:
    """(PLAID, multi-stage) parameters at the serve widths: first_k=200,
    the device stage 1, the fused tail, PLAID at serve_plaid's nprobe and
    ndocs with the candidate cap ``cap``."""
    from repro_torch.core.multistage import MultiStageParams
    from repro_torch.core.plaid import PlaidParams
    return (PlaidParams(nprobe=FULL.nprobe, candidate_cap=cap,
                        ndocs=FULL.ndocs, k=100),
            MultiStageParams(first_k=FULL.C, k=100, splade_backend="device",
                             rerank_backend="fused"))


def live_parity_retriever(path: pathlib.Path, device, cap: int):
    """A retriever over ``path``'s ``colbert`` and ``splade`` with
    :func:`live_parity_params` (``cap`` at or above every corpus size
    here, so that it never binds)."""
    from repro_torch.core.multistage import MultiStageRetriever
    from repro_torch.core.plaid import PLAIDSearcher
    from repro_torch.index.builder import ColBERTIndex
    from repro_torch.index.splade_index import SpladeIndex
    plaid, ms = live_parity_params(cap)
    searcher = PLAIDSearcher(ColBERTIndex(path / "colbert"), plaid,
                             device=device)
    if searcher.index.n_docs >= cap:
        raise AssertionError(f"the candidate cap {cap} could bind on "
                             f"{searcher.index.n_docs} docs")
    return MultiStageRetriever(
        SpladeIndex.load(path / "splade", mmap=True), searcher, ms,
        device=device)


def live_answers(retr, corpus, counted: dict, dirty: bool) -> tuple:
    """The corpus's queries in batches of ``FULL.B`` with each method at
    each k of ``LIVE_KS`` → ({(method, k): (pids, scores)}, launches).
    A dirty live index's batches launch decompress_maxsim (the SPLADE
    method none) and no other kernel; a group's a launch a shard and
    the delta's at the coordinator."""
    out, total = {}, dict.fromkeys(counted, 0)
    n = len(corpus["q_embs"])
    for method in DOOR_METHODS:
        for k in LIVE_KS:
            pids, scores = [], []
            for lo in range(0, n, FULL.B):
                reset_counts(retr, counted)
                p, sc = retr.search_batch(
                    method, q_embs=list(corpus["q_embs"][lo:lo + FULL.B]),
                    term_ids=list(corpus["q_term_ids"][lo:lo + FULL.B]),
                    term_weights=list(
                        corpus["q_term_weights"][lo:lo + FULL.B]), k=k)
                got = read_counts(counted)
                if dirty:
                    others = any(c for name, c in got.items()
                                 if name != "decompress_maxsim")
                    if others or (method != "splade") != bool(
                            got["decompress_maxsim"]):
                        raise RuntimeError(f"live {method} k={k}: a dirty "
                                           f"batch launched {got}")
                total = {nm: total[nm] + c for nm, c in got.items()}
                pids.append(p)
                scores.append(sc)
            out[(method, k)] = (np.concatenate(pids), np.concatenate(scores))
    return out, total


def same_answers(got: dict, want: dict, what: str, survivors=None) -> None:
    """Every answer of ``got`` equals ``want``'s bit for bit, the pids
    mapped to the rebuild's through ``survivors`` where given."""
    from repro_torch.index.live import map_global_to_ref
    for key, (p, sc) in got.items():
        if survivors is not None:
            p = map_global_to_ref(p, survivors)
        wp, ws = want[key]
        bad = np.nonzero(~((p == wp).all(1) & (sc.view(np.uint32)
                                               == ws.view(np.uint32)).all(1)))
        if len(bad[0]):
            b = int(bad[0][0])
            raise AssertionError(
                f"{what}: {key} differs in {len(bad[0])} queries; query "
                f"{b}: {p[b][:12].tolist()} {sc[b][:12].tolist()} != "
                f"{wp[b][:12].tolist()} {ws[b][:12].tolist()}")


def rebuild_oracle(root: pathlib.Path, docs: dict, survivors: np.ndarray,
                   geometry: pathlib.Path, quantum: float, vocab: int,
                   device, cap: int) -> tuple:
    """A pinned card rebuild of the surviving docs (``docs``: the
    corpus's arrays indexed by global pid) → (its retriever, the build's
    seconds)."""
    from repro_torch.index.live import build_reference_indexes
    pin = {n: np.load(geometry / f"{n}.npy")
           for n in ("centroids", "bucket_cutoffs", "bucket_weights")}
    t0 = time.perf_counter()
    build_reference_indexes(
        root / "colbert", root / "splade", docs["doc_embs"][survivors],
        docs["doc_lens"][survivors], docs["doc_term_ids"][survivors],
        docs["doc_term_weights"][survivors], vocab, nbits=4,
        quantum=quantum, device=device, **pin)
    return live_parity_retriever(root, device, cap), time.perf_counter() - t0


def delta_code_diffs(live, oracle, survivors: np.ndarray) -> dict:
    """The delta docs' centroid ids and packed residuals against the
    rebuild's rows of the same docs (the surviving ones) → counts."""
    idx = oracle.searcher.index
    codes, res = np.asarray(idx.store.codes), np.asarray(idx.store.residuals)
    out = {"docs": 0, "tokens": 0, "codes_differ": 0, "residual_rows_differ": 0}
    for j in range(live.n_delta):
        g = live.base_n + j
        r = int(np.searchsorted(survivors, g))
        if r == len(survivors) or survivors[r] != g:
            continue
        lo, hi = idx.doc_offsets[r], idx.doc_offsets[r + 1]
        out["docs"] += 1
        out["tokens"] += int(hi - lo)
        out["codes_differ"] += int((live._cids[j] != codes[lo:hi]).sum())
        out["residual_rows_differ"] += int(
            (live._packed[j] != res[lo:hi]).any(axis=1).sum())
    return out


def near_tie_counts(centroids: np.ndarray, device) -> dict:
    """Rows that are exact ties in real arithmetic between two of the
    base's centroids, assigned as an upsert assigns a document (its
    L = 1..Ld rows alone) and as the rebuild does (inside a full and a
    partial last chunk, ``testing.assign_placements``): with every
    matmul padded to ``kmeans.CHUNK`` rows no id or sim bit may differ.
    → {"padded": counts}."""
    import torch
    from repro_torch.index import kmeans
    from repro_torch.testing import assign_placements, near_tie_rows
    cent = torch.as_tensor(centroids, device=device)
    rows = near_tie_rows(cent, FULL.Ld, seed=21)
    out = {"padded": assign_placements(rows, cent, chunk=kmeans.CHUNK,
                                       seed=22)}
    if out["padded"]["ids_differ"] or out["padded"]["sims_differ"]:
        raise AssertionError(f"near-tie rows alone differ from the "
                             f"chunked rows: {out}")
    log(f"live (a): near-tie rows alone == inside a chunk ({out})")
    return out


def live_parity(rng, corpus, root: pathlib.Path, geometry: pathlib.Path,
                device, counted: dict) -> tuple:
    """(a): live == a pinned card rebuild of the survivors, bit for bit,
    dirty and after each of two compactions; clean live == frozen. →
    (the figures, what phase 4j replays: the cap, each round's
    mutations, survivors and the rebuild's and the live retriever's
    answers on the first ``SHARDED_LIVE_QUERIES`` queries)."""
    from repro_torch.index.splade_index import build_splade_index
    cfg = corpus["cfg"]
    n_base = cfg.n_docs - LIVE_HOLD
    cap = -(-(cfg.n_docs + LIVE_UPDATES + 1) // 1024) * 1024
    pin = {n: np.load(geometry / f"{n}.npy")
           for n in ("centroids", "bucket_cutoffs", "bucket_weights")}
    from repro_torch.index.builder import build_colbert_index
    t0 = time.perf_counter()
    build_colbert_index(root / "base" / "colbert",
                        corpus["doc_embs"][:n_base],
                        corpus["doc_lens"][:n_base], nbits=4, device=device,
                        **pin)
    base_splade = build_splade_index(
        corpus["doc_term_ids"][:n_base], corpus["doc_term_weights"][:n_base],
        cfg.vocab, n_base)
    base_splade.save(root / "base" / "splade")
    out = {"base_docs": n_base, "upserted": LIVE_HOLD, "candidate_cap": cap,
           "base_build_s": time.perf_counter() - t0, "queries":
           len(corpus["q_embs"]), "ks": list(LIVE_KS),
           "near_ties": near_tie_counts(pin["centroids"], device)}

    frozen_ans, frozen_l = live_answers(
        live_parity_retriever(root / "base", device, cap), corpus, counted,
        False)
    retr = live_parity_retriever(root / "base", device, cap)
    retr.enable_live()
    clean_ans, clean_l = live_answers(retr, corpus, counted, False)
    same_answers(clean_ans, frozen_ans, "clean live vs frozen")
    if clean_l != frozen_l:
        raise AssertionError(f"clean live launched {clean_l}, the frozen "
                             f"retriever {frozen_l}")
    out["clean_launches"] = clean_l
    log(f"live (a): a clean live retriever == the frozen one bit for bit "
        f"on {out['queries']} queries × 4 methods × k {LIVE_KS}; launches "
        f"{clean_l}")

    nq = SHARDED_LIVE_QUERIES
    replay = {"cap": cap, "rounds": [], "queries": {
        name: corpus[name][:nq]
        for name in ("q_embs", "q_term_ids", "q_term_weights")}}
    ops = []        # this round's mutations, in order, for phase 4j

    def upsert(*doc):
        ops.append(("upsert", doc))
        return retr.live_upsert(*doc)

    def delete(g):
        ops.append(("delete", g))
        return retr.live_delete(g)

    # round 1: upsert the held-out docs, tombstone base and delta pids
    for j in range(n_base, cfg.n_docs):
        upsert(corpus["doc_embs"][j], corpus["doc_term_ids"][j],
               corpus["doc_term_weights"][j], corpus["doc_lens"][j])
    dead = set(rng.choice(n_base, LIVE_TOMB[0], replace=False).tolist())
    dead |= set((n_base + rng.choice(LIVE_HOLD, LIVE_TOMB[1],
                                     replace=False)).tolist())
    for g in sorted(dead):
        assert delete(g)
    docs = {name: corpus[name] for name in ("doc_embs", "doc_lens",
                                            "doc_term_ids",
                                            "doc_term_weights")}
    rounds = []
    for rnd in (1, 2):
        if rnd == 2:
            # update docs: tombstone each and upsert a changed copy
            # (its tokens moved and renormalised, its terms kept)
            live_pids = np.setdiff1d(np.arange(retr.live.base_n
                                               + retr.live.n_delta),
                                     sorted(dead))
            upd = rng.choice(live_pids, LIVE_UPDATES, replace=False)
            first = retr.live.base_n + retr.live.n_delta
            new = {name: arr[upd].copy() for name, arr in docs.items()}
            new["doc_embs"] = unit(new["doc_embs"] + 0.05 * rng.normal(
                size=new["doc_embs"].shape)).astype(np.float32)
            for i, g in enumerate(upd.tolist()):
                assert delete(g)
                dead.add(g)
                assert upsert(new["doc_embs"][i], new["doc_term_ids"][i],
                              new["doc_term_weights"][i],
                              new["doc_lens"][i]) == first + i
            late = first + rng.choice(LIVE_UPDATES, LIVE_TOMB[1],
                                      replace=False)
            for g in late.tolist():
                assert delete(g)
                dead.add(g)
            docs = {name: np.concatenate([docs[name], new[name]])
                    for name in docs}
        n_all = len(docs["doc_lens"])
        survivors = np.setdiff1d(np.arange(n_all), sorted(dead))
        oracle, oracle_s = rebuild_oracle(
            root / f"rebuild{rnd}", docs, survivors, geometry,
            base_splade.quantum, cfg.vocab, device, cap)
        want, _ = live_answers(oracle, corpus, counted, False)
        diffs = delta_code_diffs(retr.live, oracle, survivors)
        if diffs["codes_differ"] or diffs["residual_rows_differ"]:
            raise AssertionError(f"round {rnd}: delta rows differ from the "
                                 f"rebuild's: {diffs}")
        t0 = time.perf_counter()
        dirty, dirty_l = live_answers(retr, corpus, counted, True)
        dirty_s = time.perf_counter() - t0
        same_answers(dirty, want, f"round {rnd} dirty vs rebuild", survivors)
        reply = retr.compact_live()
        compacted, compacted_l = live_answers(retr, corpus, counted, True)
        same_answers(compacted, want, f"round {rnd} compacted vs rebuild",
                     survivors)

        def head(answers):
            return {key: (p[:nq], sc[:nq]) for key, (p, sc) in
                    answers.items()}

        replay["rounds"].append({
            "ops": ops, "survivors": survivors, "rebuild": head(want),
            "dirty": head(dirty), "compacted": head(compacted)})
        ops = []
        rounds.append({
            "docs": n_all, "survivors": len(survivors),
            "tombstones": len(dead), "rebuild_s": oracle_s,
            "delta_rows_vs_rebuild": diffs, "dirty_launches": dirty_l,
            "dirty_serve_s": dirty_s, "compacted_launches": compacted_l,
            "compaction": {"compacted": reply["compacted"],
                           "seconds": reply["seconds"]}})
        log(f"live (a) round {rnd}: dirty and compacted answers == the "
            f"pinned card rebuild of {len(survivors)} survivors bit for "
            f"bit; delta rows vs rebuild {diffs}; dirty launches "
            f"{dirty_l}; compaction {reply['seconds']}")
    out["rounds"] = rounds
    return out, replay


def reader_loop(retr, batch: dict, want, stop: threading.Event,
                walls: list, errors: list) -> None:
    """Serve ``batch`` until ``stop``; each answer must be ``want`` bit
    for bit; each call's (start, wall s) goes to ``walls``."""
    try:
        while not stop.is_set():
            t0 = time.perf_counter()
            got = retr.search_batch(**batch)
            walls.append((t0, time.perf_counter() - t0))
            if answer_bits(*got) != answer_bits(*want):
                raise AssertionError("a reader's answer changed during "
                                     "a compaction")
    except Exception as e:              # reported on the caller
        errors.append(e)


class HostSteps:
    """While in use, sums the wall seconds of the calls to each wrapped
    function (``targets``: (owner, attribute name) pairs; a staticmethod
    stays one) by its name."""

    def __init__(self, targets):
        self.targets, self.seconds = targets, {}

    def _timed(self, name: str, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t0)
        return call

    def __enter__(self):
        self.saved = [(owner, name, vars(owner)[name])
                      for owner, name in self.targets]
        for owner, name, fn in self.saved:
            if isinstance(fn, staticmethod):
                setattr(owner, name,
                        staticmethod(self._timed(name, fn.__func__)))
            else:
                setattr(owner, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def compact_measured(retr, batch: dict, device, readers: int) -> dict:
    """(c): ``readers`` threads serve ``batch`` before, during and after
    ``compact_live()``, every answer the one before it, each thread
    joined with a bound. → the compaction's steps (``colbert_dir`` split
    into the concatenation, the pool's write, the IVF's build and the
    other files), the readers' calls before and during it and over the
    swap, and the device memory after it, less the padded IVF the
    readers may have made the new searcher build. ``retr`` may be a
    shard group: the searcher it rewrites is its last shard's."""
    import torch
    from repro_torch.core.store import PagedStore
    from repro_torch.index import ivf as ivf_mod
    from repro_torch.index import live as live_mod
    want = retr.search_batch(**batch)
    stop, walls, errors = threading.Event(), [], []
    threads = [threading.Thread(target=reader_loop, name=f"live-reader-{i}",
                                args=(retr, batch, want, stop, walls,
                                      errors), daemon=True)
               for i in range(readers)]
    for t in threads:
        t.start()
    while len(walls) < 2 * readers and not errors:     # all reading
        stop.wait(0.01)
    with HostSteps(((live_mod, "write_index"), (PagedStore, "write"),
                    (ivf_mod, "build_ivf"))) as host:
        t0 = time.perf_counter()
        reply = retr.compact_live()
        t1 = time.perf_counter()
    n_after = len(walls) + readers
    while len(walls) < n_after and not errors:         # read after it
        stop.wait(0.01)
    stop.set()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"readers: {errors[:2]}, alive "
                           f"{[t.name for t in threads if t.is_alive()]}")
    if answer_bits(*retr.search_batch(**batch)) != answer_bits(*want):
        raise AssertionError("the answer after the compaction changed")
    sec = reply["seconds"]
    swap_lo = t0 + sec["colbert_dir"] + sec["splade_dir"] + sec["load"]
    swap_hi = swap_lo + sec["gate_wait"] + sec["swap"]

    def overlapping(lo, hi):
        return [w for start, w in walls if start < hi and start + w > lo]

    before = [w for start, w in walls if start + w <= t0]
    during = overlapping(t0, t1)
    over_swap = overlapping(swap_lo, swap_hi)
    if device.type == "cuda":
        torch.cuda.synchronize()
    searcher = getattr(retr, "shards", [retr])[-1].searcher
    ivf = vars(searcher).get("ivf_padded")
    allocated = (torch.cuda.memory_allocated() if device.type == "cuda"
                 else 0)
    ivf_bytes = 0 if ivf is None else -(-ivf.numel() * 4 // 512) * 512
    wi = host.seconds["write_index"]
    steps = dict(sec, colbert_concat=sec["colbert_dir"] - wi,
                 pool_write=host.seconds["write"],
                 ivf_build=host.seconds["build_ivf"],
                 other_files=wi - host.seconds["write"]
                 - host.seconds["build_ivf"])
    return {"compacted": reply["compacted"],
            "pool_tokens": int(searcher.index.store.n_tokens),
            "seconds": steps, "readers": readers,
            "reader_calls": len(walls),
            "reader_p50_before_s": (float(np.median(before)) if before
                                    else None),
            "reader_calls_during": len(during),
            "reader_p50_during_s": (float(np.median(during)) if during
                                    else None),
            "longest_reader_during_s": max(during) if during else None,
            "longest_reader_over_swap_s": (max(over_swap) if over_swap
                                           else None),
            "memory_allocated": allocated, "ivf_padded_bytes": ivf_bytes,
            "memory_less_ivf": allocated - ivf_bytes}


def unit_docs(rng, s: Shapes, topics: np.ndarray, n: int) -> list:
    """n documents of unit-random token embeddings (lengths as phase 3's
    docs) with topic terms: (doc_emb, term_ids, term_weights)."""
    lens = np.clip(rng.normal(67, 30, n).round(), 8, s.Ld).astype(int)
    tids, tw = topic_terms(rng, topics, n, s.doc_terms)
    return [(unit(rng.normal(size=(L, s.d))), tids[i], tw[i])
            for i, L in enumerate(lens)]


def assign_times(centroids, docs) -> dict:
    """An upsert's assignment of the median-length document's rows
    (padded to ``kmeans.CHUNK`` rows), by CUDA events."""
    import torch
    from repro_torch.index import kmeans
    emb = sorted((d[0] for d in docs), key=len)[len(docs) // 2]
    x = torch.as_tensor(np.asarray(emb, np.float32), device=centroids.device)
    return {"rows": len(emb), "K": int(centroids.shape[0]),
            "chunk": kmeans.CHUNK,
            "padded": cuda_time_ms(lambda: kmeans.assign(x, centroids), 50)}


def live_cost(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
              device, counted: dict) -> tuple:
    """(b) and (c) on phase 3's index. → (figures, the dirty run's
    launches)."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.testing import REF_MARGIN, assert_topk_match
    retr = make_retriever(path, device)
    retr.enable_live()
    engine = ServeEngine(retr, splade_backend="device")
    cpu = make_retriever(path, "cpu")
    cpu.enable_live()
    cpu_engine = ServeEngine(cpu)
    reqs = door_requests(rng, s, topics, s.n_requests, qid0=70_000)
    warm = door_requests(rng, s, topics, 8, qid0=71_000)
    out = {"requests": len(reqs), "max_batch": s.B}

    clean, line = serve_run(engine, warm, reqs, s.B, counted)
    check_launches("live clean", line["launches"], DOOR_KERNELS)
    line["tie_routes"] = hold_to_cpu(
        cpu_engine, {"mmap": retr.searcher},
        [(r, res, "mmap") for r, res in zip(reqs, clean)], s)
    out["clean"] = line

    docs = unit_docs(rng, s, topics, LIVE_UPSERTS)
    upsert_ms = []
    for emb, tids, tw in docs:
        t0 = time.perf_counter()
        g = engine.live_upsert(emb, tids, tw)
        upsert_ms.append((time.perf_counter() - t0) * 1e3)
        if cpu_engine.live_upsert(emb, tids, tw) != g:
            raise AssertionError("the CPU engine gave another pid")
    n_all = s.n_docs + LIVE_UPSERTS
    for g in rng.choice(n_all, LIVE_DELETES, replace=False).tolist():
        if not (engine.live_delete(g) and cpu_engine.live_delete(g)):
            raise AssertionError(f"delete {g} refused")
    out["upsert_ms"] = {"p50": float(np.percentile(upsert_ms, 50)),
                        "p99": float(np.percentile(upsert_ms, 99)),
                        "mean": float(np.mean(upsert_ms))}
    out["assign_ms"] = assign_times(retr.live._centroids, docs)
    # a fresh engine: serve_run checks the engine's count of served
    engine = ServeEngine(retr, splade_backend="device")
    dirty, line = serve_run(engine, fresh(warm), fresh(reqs), s.B, counted)
    check_launches("live dirty", line["launches"], ("decompress_maxsim",))
    deeper = [dataclasses.replace(r, ctx=None, k=r.k + REF_MARGIN)
              for r in reqs]
    ref = []
    for lo in range(0, len(deeper), s.B):
        ref += cpu_engine.process_batch(deeper[lo:lo + s.B])
    for req, res, want in zip(reqs, dirty, ref, strict=True):
        assert_topk_match(want.scores, want.pids, res.scores, res.pids,
                          what=f"live dirty qid {req.qid} {req.method}")
    out["dirty"] = line
    launches = line["launches"]
    log(f"live (b): clean {out['clean']['qps']:.1f} QPS, dirty "
        f"{line['qps']:.1f} QPS (p50 {out['clean']['p50_ms']:.1f} → "
        f"{line['p50_ms']:.1f} ms); upsert {out['upsert_ms']} ms; every "
        "answer matches the CPU live engine")

    # the readers ask for the SPLADE methods: colbert's cap binds on this
    # index, so a compaction, which moves the delta's docs under the
    # cap, changes colbert's candidates (the rebuild bar holds only
    # while the cap does not bind)
    sp = [r for r in reqs if r.method != "colbert"][:s.B]
    batch = {"method": [r.method for r in sp],
             "q_embs": [r.q_emb for r in sp],
             "term_ids": [r.term_ids for r in sp],
             "term_weights": [r.term_weights for r in sp],
             "alpha": [r.alpha for r in sp], "k": 100}
    # the first compaction under readers, the second alone: its steps
    # without the readers' host work beside them
    out["compactions"] = [compact_measured(retr, batch, retr.device,
                                           LIVE_READERS)]
    for emb, tids, tw in unit_docs(rng, s, topics, LIVE_MORE):
        engine.live_upsert(emb, tids, tw)
    out["compactions"].append(compact_measured(retr, batch, retr.device, 0))
    mem = [c["memory_less_ivf"] for c in out["compactions"]]
    if mem[0] != mem[1]:
        raise AssertionError(f"device memory grew across compactions: "
                             f"{out['compactions']}")
    log(f"live (c): a compaction under {LIVE_READERS} readers, every "
        f"answer unchanged, and one alone: {out['compactions']}")
    for c in (retr.searcher.index.path.parent.glob("*.g*")):
        shutil.rmtree(c)
    return out, launches


def live_tcp(corpus, base: pathlib.Path, root: pathlib.Path, device) -> dict:
    """(d): a live ``RetrievalServer`` over TCP against an in-process twin
    on a copy of the same index: every admin reply equal to the twin's
    same call, and the query replies after each mutation equal to the
    served engine's in-process answers bit for bit."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.server import RetrievalServer, wire_request
    cap = -(-(corpus["cfg"].n_docs + 1) // 1024) * 1024
    engines = []
    for name in ("tcp", "twin"):
        for part in ("colbert", "splade"):
            shutil.copytree(base / part, root / name / part)
        r = live_parity_retriever(root / name, device, cap)
        r.enable_live()
        engines.append(ServeEngine(r))
    engine, twin = engines
    server = RetrievalServer(engine, max_batch=FULL.B)
    server.start()
    tcp = server.serve_tcp("127.0.0.1", 0)
    serving = threading.Thread(target=tcp.serve_forever, name="tcp-serve-live",
                               daemon=True)
    serving.start()
    n = corpus["cfg"].n_docs
    checked = {"admin": 0, "queries": 0}
    conn = None
    try:
        conn = Conn(server.tcp_port, live=True)

        def admin(msg: dict, in_process):
            got = conn.ask((json.dumps(msg) + "\n").encode())
            if got != in_process:
                raise AssertionError(f"{msg['op']}: over TCP {got}, in "
                                     f"process {in_process}")
            checked["admin"] += 1

        def health():
            got = conn.ask(b'{"op": "health"}\n')["health"]
            want = {"live": twin.live_stats(),
                    "index_generation": twin.retriever.index_generation}
            if {k: got[k] for k in want} != want:
                raise AssertionError(f"health: {got} against {want}")
            checked["admin"] += 1

        def queries(first: int):
            for i, method in enumerate(DOOR_METHODS):
                msg = json.loads(wire_line(corpus_request(corpus, first + i,
                                                          method)))
                got = conn.ask((json.dumps(msg) + "\n").encode())
                want = engine.process(wire_request(msg))
                hold_reply("live tcp", got, want, engine, wire_request(msg))
                checked["queries"] += 1

        def upsert(j: int):
            doc = {"doc_emb": corpus["doc_embs"][j][:corpus["doc_lens"][j]],
                   "term_ids": corpus["doc_term_ids"][j],
                   "term_weights": corpus["doc_term_weights"][j]}
            pid = twin.live_upsert(**doc)
            admin({"op": "upsert", **{k: np.asarray(v).tolist()
                                      for k, v in doc.items()}},
                  {"ok": True, "pid": pid})

        queries(0)
        for j in range(4):
            upsert(j)
        queries(4)
        for g in (7, n + 1, n + 1, n + 50):
            admin({"op": "delete", "pid": g},
                  {"ok": twin.live_delete(g)})
        queries(8)
        admin({"op": "live_stats"}, {"ok": True, "live": twin.live_stats()})
        health()
        out = twin.live_compact()
        admin({"op": "compact"}, {"ok": True, "compacted": out["compacted"]})
        admin({"op": "compact"}, {"ok": True, "compacted": 0})
        twin.live_compact()
        queries(12)
        admin({"op": "live_stats"}, {"ok": True, "live": twin.live_stats()})
        health()
    finally:
        if conn is not None:
            conn.close()
        server.shutdown_gracefully()
        serving.join(timeout=600)
    if serving.is_alive() or live_threads():
        raise RuntimeError("the live TCP front left threads running")
    log(f"live (d): over TCP {checked['admin']} admin replies equal the "
        f"in-process twin's, {checked['queries']} query replies their "
        "in-process answers bit for bit")
    return checked


def corpus_request(corpus, i: int, method: str):
    """The corpus's query ``i`` as a request of ``method`` at k=10."""
    from repro_torch.serving.engine import Request
    return Request(qid=80_000 + i, method=method, q_emb=corpus["q_embs"][i],
                   term_ids=corpus["q_term_ids"][i],
                   term_weights=corpus["q_term_weights"][i], k=10)


def live_phase(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
               corpus, device) -> tuple:
    """Phase 4f (see the module docstring). → (the ``live`` line's
    figures, the launches of (b)'s dirty run, what phase 4j replays of
    (a))."""
    counted = counted_kernels()
    root = path / "live"
    t0 = time.perf_counter()
    parity, replay = live_parity(rng, corpus, root,
                                 path / "build" / "colbert", device, counted)
    out = {"parity": parity}
    out["parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["tcp"] = live_tcp(corpus, root / "base", root, device)
    out["tcp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cost"], launches = live_cost(rng, s, path, topics, device, counted)
    out["cost_s"] = time.perf_counter() - t0
    return out, launches, replay


# ---------------------------------------------------------------------------
# phase 4g: the load generators
# ---------------------------------------------------------------------------

# the open-loop sweep: offered rates as shares of the traffic's service
# rate μ, each at depth 1, then with the executor's single and kind
# workers
LOAD_SHARES = (0.25, 0.5, 0.75, 1.0, 1.25)
LOAD_MODES = ((1, None), (2, "single"), (2, "kind"))
# requests per run: (the closed-loop probe, every other run)
LOAD_N = {"splade": (256, 512), "colbert": (128, 128)}
LOAD_KERNELS = {"splade": DOOR_KERNELS, "colbert": ("fused_rerank",)}
LOAD_ZIPF = (64, 1.1)          # distinct requests, skew


class LoadProxy:
    """The server as a load generator sees it: ``submit`` delegates to
    the server and keeps each request's future (``run_open_loop`` and
    ``run_closed_loop`` return no results) with the instant the
    generator called it."""

    def __init__(self, server):
        self.server = server
        self.sent = []      # (request, future, perf_counter at the call)

    def submit(self, req):
        t = time.perf_counter()
        fut = self.server.submit(req)
        self.sent.append((req, fut, t))
        return fut


# the two schedules below repeat the generators' draws (the same
# ``default_rng(seed).exponential`` calls in the same order);
# tests/test_torch_loadgen.py holds them to the submit instants of
# ``run_open_loop`` and ``run_poisson_load`` under a fake clock


def open_loop_schedule(n: int, rate: float, seed: int) -> np.ndarray:
    """Each request's due instant, as ``run_open_loop`` draws it."""
    return np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate, n))


def poisson_schedule(n: int, qps: float, seed: int, burst: int = 1):
    """Each request's due instant, as ``run_poisson_load`` draws it
    (``time_scale`` 1): its burst's arrival."""
    k = -(-n // burst)
    due = np.cumsum(np.random.default_rng(seed).exponential(burst / qps, k))
    return np.repeat(due, burst)[:n]


def finite(x):
    """JSON-safe: ``nan`` (a run with no answer) becomes None."""
    return None if isinstance(x, float) and x != x else x


class GCPauses:
    """While in use, each garbage collection (any generation) as its
    (start, end) on ``time.perf_counter``, from ``gc.callbacks``."""

    def __init__(self):
        self.spans, self._t = [], None

    def _hook(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.spans.append((self._t, time.perf_counter()))
            self._t = None

    @property
    def ms(self) -> list:
        return [(b - a) * 1e3 for a, b in self.spans]

    def within_ms(self, lo: float, hi: float) -> float:
        """The collections' time inside [lo, hi], in ms."""
        return sum(max(0.0, min(b, hi) - max(a, lo))
                   for a, b in self.spans) * 1e3

    def __enter__(self):
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._hook)


def heap_census() -> dict:
    """The objects the garbage collector tracks, the most common types,
    and the time of two full collections: the first frees what earlier
    phases left in cycles, the second only walks the heap."""
    import collections

    def collect_ms() -> float:
        t0 = time.perf_counter()
        gc.collect()
        return (time.perf_counter() - t0) * 1e3

    first, second = collect_ms(), collect_ms()
    objs = gc.get_objects()
    top = collections.Counter(type(o).__name__ for o in objs)
    out = {"tracked": len(objs), "full_collection_ms": first,
           "walk_only_ms": second, "types": dict(top.most_common(8))}
    del objs
    return out


def load_run(engine, warm, reqs, drive, counted: dict, schedule=None,
             admission=None) -> tuple:
    """Serve ``reqs`` by ``drive(proxy, reqs)`` (a load generator → its
    ``LoadResult``) through a ``RetrievalServer(max_batch=32,
    batch_timeout_ms=5)`` over ``engine``. Unless ``warm`` (a full
    batch of the run's traffic) is None, ``engine.pipeline_depth``
    copies of it are served first, in flight together, so that the
    executors, their streams and the allocator's blocks for full
    batches exist before the run. Then the stage records and launch
    counts are set to 0 (only the counts when ``admission`` needs the
    warm stage costs) just before the generator and read just after. No
    server, executor or client thread may outlive the run. ``schedule``
    (due instants from the generator's call) gives the submitter's
    lateness. → (the proxy's (request, future) pairs, the run's
    line)."""
    from repro_torch.serving.server import RetrievalServer
    if warm is not None and engine.pipelined:
        for fut in [engine.process_batch_async(fresh(warm))
                    for _ in range(engine.pipeline_depth)]:
            fut.result(timeout=600)
    elif warm is not None:
        engine.process_batch(fresh(warm))
    server = RetrievalServer(engine, max_batch=FULL.B, batch_timeout_ms=5.0,
                             admission=admission)
    server.start()
    proxy = LoadProxy(server)
    try:
        if admission is None:
            engine.retriever.reset_stage_stats()
        for fn in counted.values():
            fn.launches = 0
        with GCPauses() as pauses:
            t_call = time.perf_counter()
            res = drive(proxy, reqs)
        launches = read_counts(counted)
        health = server.health()
    finally:
        server.stop()
    left = live_threads(("pipe-", "pipeline-retry", "worker-")) + [
        t.name for t in threading.enumerate()
        if t.name.endswith("(client)") and t.is_alive()]
    if left:
        raise RuntimeError(f"threads outlived a load run: {left}")
    if len(proxy.sent) != len(reqs) or not all(
            f.done() for _, f, _ in proxy.sent):
        raise RuntimeError("a load run left a request unsubmitted or "
                           "unanswered")
    line = {k: finite(v) for k, v in res.summary().items()}
    line.update(batches=health["batches"], launches=launches,
                server_sheds=health["sheds"],
                stage_wall_s={n: r["wall_s"]
                              for n, r in health["stages"].items()},
                stage_pages={n: r["pages_touched"]
                             for n, r in health["stages"].items()},
                counters=health.get("counters", {}),
                gc_pauses=len(pauses.ms),
                gc_max_ms=max(pauses.ms, default=0.0))
    if schedule is not None:
        late = np.array([t - t_call for _, _, t in proxy.sent]) - schedule
        worst = int(late.argmax())
        due = t_call + schedule[worst]
        line.update(max_lateness_ms=float(late[worst] * 1e3),
                    max_lateness_at_s=float(schedule[worst]),
                    # how much of the largest lateness the collector took
                    max_lateness_gc_ms=pauses.within_ms(
                        due, due + late[worst]),
                    p50_lateness_ms=float(np.percentile(late, 50) * 1e3))
    return [(r, f) for r, f, _ in proxy.sent], line


def hold_bits(label: str, sent, want: dict, key=lambda r: r.qid) -> dict:
    """Each answer of ``sent`` equals ``want[key(request)]`` bit for bit;
    a shed is counted, any other failure raises. → {"answered", "shed",
    "degraded": [(request, result), ...]} (degraded answers are held by
    the caller)."""
    from repro_torch.serving.admission import RequestShed
    out = {"answered": 0, "shed": 0, "degraded": []}
    for req, fut in sent:
        err = fut.exception()
        if isinstance(err, RequestShed):
            out["shed"] += 1
            continue
        if err is not None:
            raise RuntimeError(f"{label}: qid {req.qid} failed") from err
        res = fut.result()
        if res.degraded:
            out["degraded"].append((req, res))
            continue
        same_bits([want[key(req)]], [res], f"{label} (vs the depth-1 "
                                           "reference)")
        out["answered"] += 1
    return out


def load_phase(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
               device) -> tuple:
    """Phase 4g (see the module docstring). → (the ``load`` lines, the
    launches of each traffic's first depth-1 open-loop run)."""
    from repro_torch.serving.admission import AdmissionController
    from repro_torch.serving.context import CacheHierarchy
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.loadgen import (load_trace, run_closed_loop,
                                             run_open_loop, run_poisson_load,
                                             zipf_trace)

    counted = counted_kernels()
    retr = make_retriever(path, device)
    heap = heap_census()
    log(f"load: the heap before the runs: {heap}")
    reqs = {"splade": make_requests(rng, s, topics, LOAD_N["splade"][1]),
            "colbert": colbert_requests(rng, s, LOAD_N["colbert"][1])}
    warm = {"splade": make_requests(rng, s, topics, s.B, qid0=80_000),
            "colbert": colbert_requests(rng, s, s.B, qid0=80_100)}

    def engine(depth=1, workers=None, caches=None):
        return ServeEngine(retr, splade_backend="device", caches=caches,
                           pipeline_depth=depth,
                           pipeline_workers=workers or "single")

    def seed():
        return int(rng.integers(2 ** 31))

    # the depth-1 reference: every request in one burst, held to the CPU
    ref, held = {}, []
    for kind, rs in reqs.items():
        results, _ = serve_run(engine(), fresh(warm[kind]), fresh(rs),
                               s.B, counted)
        ref[kind] = {r.qid: r for r in results}
        held += [(r, res, "mmap") for r, res in zip(rs, results)]
    cpu = ServeEngine(make_retriever(path, "cpu"))
    routes = hold_to_cpu(cpu, {"mmap": retr.searcher}, held, s)
    log(f"load: the depth-1 reference answers ({len(held)}) match the CPU "
        f"engine; through a tie at a stage boundary: {routes or 'none'}")

    lines, mu, first = [], {}, {}

    def record(kind, run, mode, line, **kw):
        line.update(traffic=kind, run=run, mode=mode, **kw)
        lines.append(line)
        log(f"load {kind} {run} {mode} {kw}: offered {line['offered_qps']:.1f}"
            f", achieved {line['achieved_qps']:.1f} QPS, p50/p95/p99 "
            f"{line['p50']}/{line['p95']}/{line['p99']} s, n {line['n']}, "
            f"shed {line['shed']}, degraded {line['degraded']}, "
            f"{line['batches']} batches, lateness max "
            f"{line.get('max_lateness_ms')} ms at "
            f"{line.get('max_lateness_at_s')} s ("
            f"{line.get('max_lateness_gc_ms')} ms of it collecting), gc "
            f"max {line['gc_max_ms']:.1f} ms; launches {line['launches']}")

    # (a) the service-rate probe: closed loops at depth 1
    for kind, rs in reqs.items():
        part = rs[:LOAD_N[kind][0]]
        for c in (1, s.B):
            sent, line = load_run(
                engine(), warm[kind], fresh(part),
                lambda p, r, c=c: run_closed_loop(p, r, concurrency=c),
                counted)
            hold_bits(f"load probe {kind} c={c}", sent, ref[kind])
            record(kind, "probe", "depth1", line, concurrency=c)
        mu[kind] = lines[-1]["achieved_qps"]

    # (b) the open-loop sweep
    for kind, rs in reqs.items():
        for share in LOAD_SHARES:
            rate = share * mu[kind]
            for depth, workers in LOAD_MODES:
                sd = seed()
                mode = "depth1" if depth == 1 else workers
                sent, line = load_run(
                    engine(depth, workers), warm[kind], fresh(rs),
                    lambda p, r, rate=rate, sd=sd: run_open_loop(
                        p, r, arrival_rate=rate, seed=sd),
                    counted, open_loop_schedule(len(rs), rate, sd))
                hold_bits(f"load sweep {kind} {mode} x{share}", sent,
                          ref[kind])
                if kind not in first:
                    first[kind] = line["launches"]
                    check_launches(f"load {kind}", line["launches"],
                                   LOAD_KERNELS[kind])
                    pages = line["stage_pages"]
                    if kind == "colbert" and (
                            pages["host_gather:codes"] != 0
                            or pages["host_gather:residuals"] == 0):
                        raise RuntimeError(f"load colbert: residual pages "
                                           f"of the gathers: {pages}")
                record(kind, "sweep", mode, line, share=share)

    # (c) bursty Poisson arrivals, the answers handed to on_result
    rs, rate, sd = reqs["splade"], 0.75 * mu["splade"], seed()
    got = []
    sent, line = load_run(
        engine(), warm["splade"], fresh(rs),
        lambda p, r: run_poisson_load(p, r, qps=rate, seed=sd, burst=8,
                                      on_result=got.append),
        counted, poisson_schedule(len(rs), rate, sd, burst=8))
    hold_bits("load burst", sent, ref["splade"])
    if [r.qid for r in got] != [r.qid for r in rs]:
        raise AssertionError("load burst: on_result did not see every "
                             "answer in submission order")
    same_bits([ref["splade"][r.qid] for r in got], got, "load burst "
                                                        "on_result")
    record("splade", "burst", "depth1", line, share=0.75, burst=8)

    # (d) a Zipf trace, replayed from a file, with the exact cache
    n_unique, skew = LOAD_ZIPF
    trace = zipf_trace(len(rs), n_unique, skew=skew, seed=seed())
    trace_file = path / "load_zipf.trace"
    trace_file.write_text(f"# zipf s={skew} over {n_unique} requests\n\n"
                          + "\n".join(map(str, trace.tolist())) + "\n")
    if not np.array_equal(load_trace(trace_file), trace):
        raise AssertionError("load_trace did not read back the trace")
    distinct = rs[:n_unique]
    zreqs = [dataclasses.replace(distinct[j], qid=90_000 + i, trace_id=j,
                                 ctx=None)
             for i, j in enumerate(trace.tolist())]
    rate, sd = 0.75 * mu["splade"], seed()
    try:
        sent, line = load_run(
            engine(caches=CacheHierarchy(exact_entries=256,
                                         stage1_entries=256)),
            warm["splade"], zreqs,
            lambda p, r: run_poisson_load(p, r, qps=rate, seed=sd),
            counted, poisson_schedule(len(zreqs), rate, sd))
    finally:
        retr.attach_caches(None)
    hold_bits("load zipf", sent, ref["splade"],
              key=lambda r: distinct[r.trace_id].qid)
    unique = len(set(trace.tolist()))
    hits = line["counters"].get("cache_exact_hits", 0)
    if (line["cache_hits"], line["unique_queries"],
            line["repeat_queries"]) != (hits, unique, len(trace) - unique):
        raise AssertionError(f"load zipf: cache hits {line['cache_hits']} "
                             f"against the counter's {hits}, trace "
                             f"{unique} unique: {line}")
    record("splade", "zipf", "depth1", line, share=0.75, zipf_s=skew,
           distinct=n_unique)

    # (e) overload with admission: the SLO between the cheap and the
    # full plan's predicted costs, from the warm stage costs (phase 4c F)
    eng = engine()
    retr.reset_stage_stats()
    eng.process_batch(fresh(rs[:s.B]))
    stage1_ms, tail_ms, _ = AdmissionController.stage_costs(
        retr.pipeline_stats.snapshot()["stages"])
    if not tail_ms > 2 * stage1_ms:
        raise RuntimeError(f"load admission: tail {tail_ms} ms is not over "
                           f"twice stage 1's {stage1_ms} ms")
    adm = AdmissionController(stage1_ms + tail_ms / 2)
    rate, sd = 1.25 * mu["splade"], seed()
    sent, line = load_run(
        eng, None, fresh(rs),
        lambda p, r: run_open_loop(p, r, arrival_rate=rate, seed=sd),
        counted, open_loop_schedule(len(rs), rate, sd), admission=adm)
    held = hold_bits("load admission", sent, ref["splade"])
    stats = adm.stats()
    if (line["n"] + line["shed"] + line["failed"] != len(rs)
            or line["shed"] != line["server_sheds"]
            or line["degraded"] != stats["degraded_admits"]):
        raise AssertionError(f"load admission accounting: {line}, "
                             f"admission {stats}")
    if held["degraded"]:
        twins = fresh([r for r, _ in held["degraded"]], method="splade")
        want, _ = serve_run(engine(), fresh(warm["splade"]), twins, s.B,
                            counted)
        same_bits(want, [res for _, res in held["degraded"]],
                  "load admission: a degraded answer vs its splade plan")
    record("splade", "admission", "depth1", line, share=1.25,
           slo_ms=stats["latency_slo_ms"], admission=stats)

    for line in lines:
        line.update(mu_s=mu["splade"], mu_c=mu["colbert"])
    lines[0]["heap"] = heap
    return lines, first


# ---------------------------------------------------------------------------
# phase 4h: the launcher and the example
# ---------------------------------------------------------------------------

LAUNCH_CONNS = 32        # connections opened at once
LAUNCH_WAIT = 600        # seconds: the bound on every wait for a child
LAUNCH_EXIT = 60         # seconds: a SIGTERM'd launcher must exit within
# (a)'s turns over TCP: the launcher's first requests pay its cold start
LAUNCH_TURNS = ("cold", "warm", "warm")
# the in-process fronts timed against each other: the port's backlog
# and socketserver's 5 (the JAX front's), one turn each; a turn at 5
# waits out the SYN retries, about 7 s
BACKLOG_TURNS = ("port", "five")
# (c): the bounded loads on the launcher's built-in corpus
LAUNCH_B1_N, LAUNCH_B1_QPS = 64, 200.0
LAUNCH_LOAD_N, LAUNCH_LOAD_SKEW = 256, 1.1
LAUNCH_EXAMPLE_N = 128
REPORT_LINES = {
    "offered": re.compile(
        r"^offered (\S+) QPS → achieved (\S+); p50 (\S+) ms, p95 (\S+) "
        r"ms, p99 (\S+) ms$"),
    "trace": re.compile(
        r"^trace: (\d+) unique / (\d+) repeats; outcomes: (\d+) cache "
        r"hits, (\d+) degraded, (\d+) shed, (\d+) failed$"),
    "caches": re.compile(
        r"^caches: exact (\d+)h/(\d+)m \(size (\d+)/(\d+)\), stage1 "
        r"(\d+)h/(\d+)m \(size (\d+)/(\d+)\)$"),
    "admission": re.compile(
        r"^admission: (\d+) full, (\d+) degraded, (\d+) shed \(SLO (\S+) "
        r"ms\)$"),
    "working_set": re.compile(r"^mmap working set: (\S+)% of pool$"),
}
EXAMPLE_LINES = {
    "capacity": re.compile(r"^service time (\S+) ms → capacity ≈ (\S+) QPS "),
    "rate": re.compile(r"^\s*(\S+)/s\s+(\S+)ms\s+(\S+)ms\s+(\S+)ms\s+(\S+)/s$"),
    "response": re.compile(r"^response: \{'qid': 0, 'pids': \[[\d, ]+\], "),
    "drained": re.compile(r"^drained \+ stopped cleanly\.$"),
}


class Child:
    """A launcher or example process of the port: its standard output
    read line by line on a thread, its standard error into a file.
    ``kill`` in a ``finally`` ends it whatever happened."""

    def __init__(self, label: str, argv: list, tmp: pathlib.Path):
        self.label = label
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   TMPDIR=str(tmp))
        tmp.mkdir(parents=True, exist_ok=True)
        self.err_path = tmp / f"{label}.stderr"
        self._err = open(self.err_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=self._err)
        self.lines, self._cond = [], threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name=f"child-{label}-stdout")
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append(line.rstrip("\n"))
                self._cond.notify_all()
        with self._cond:
            self.lines.append(None)        # end of the output
            self._cond.notify_all()

    def fail(self, msg: str):
        self.kill()
        err = self.err_path.read_text()[-3000:]
        out = "\n".join(ln for ln in self.lines[-20:] if ln is not None)
        raise RuntimeError(f"{self.label}: {msg} (exit {self.proc.poll()})"
                           f"\n--- stdout\n{out}\n--- stderr\n{err}")

    def wait_line(self, prefix: str) -> str:
        """The first output line starting with ``prefix``."""
        deadline = time.perf_counter() + LAUNCH_WAIT
        with self._cond:
            while True:
                for line in self.lines:
                    if line is None:
                        break
                    if line.startswith(prefix):
                        return line
                if None in self.lines:
                    break
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                self._cond.wait(left)
        self.fail(f"no line {prefix!r}")

    def finish(self, timeout: float = LAUNCH_WAIT) -> int:
        """Wait for the exit; → the exit code (a timeout fails)."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.fail(f"still running after {timeout} s")
        self._reader.join(timeout=LAUNCH_WAIT)
        self._err.close()
        return rc

    def output(self) -> list:
        return [ln for ln in self.lines if ln is not None]

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=LAUNCH_WAIT)
        self._err.close()


def device_flags(device) -> list:
    """A child's device flags: none on the card (the default), ``--device
    cpu`` in a rehearsal on the CPU."""
    return [] if device.type == "cuda" else ["--device", "cpu"]


def launch_argv(*flags, device) -> list:
    """``python -m repro_torch.launch.serve`` with ``flags``."""
    return ["-m", "repro_torch.launch.serve", *map(str, flags),
            *device_flags(device)]


class OpenConn(Conn):
    """A :class:`Conn` over a socket already connected."""

    def __init__(self, sock):
        self.sock = sock
        self.rfile = sock.makefile("rb")


def connect_burst(port: int, n: int = LAUNCH_CONNS) -> tuple:
    """Open ``n`` connections at once (threads behind a barrier), each
    ``connect`` timed. → (the sockets, each connect's ms)."""
    barrier = threading.Barrier(n)
    socks, ms, errors = [None] * n, [0.0] * n, []

    def connect(i):
        try:
            barrier.wait(timeout=LAUNCH_WAIT)
            t0 = time.perf_counter()
            socks[i] = socket.create_connection(("127.0.0.1", port),
                                                timeout=LAUNCH_WAIT)
            ms[i] = (time.perf_counter() - t0) * 1e3
        except Exception as e:            # reported below, on the caller
            errors.append(e)

    threads = [threading.Thread(target=connect, args=(i,), daemon=True,
                                name=f"tcp-connect-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=LAUNCH_WAIT)
    if errors or any(t.is_alive() for t in threads):
        for sk in socks:
            if sk is not None:
                sk.close()
        raise RuntimeError(f"connect burst: {errors[:3]}")
    return socks, ms


def connect_figures(ms) -> dict:
    ms = np.asarray(ms)
    return {"p50_ms": float(np.percentile(ms, 50)),
            "max_ms": float(ms.max()), "over_1s": int((ms >= 1000).sum())}


def backlog_turns(retrieval) -> dict:
    """32 connections at once to an in-process front that accepts on a
    thread, with the port's backlog and with socketserver's 5, in turns
    (:data:`BACKLOG_TURNS`). → {"port" | "five": [figures per turn]}."""
    from repro_torch.serving.server import TCPRetrievalServer

    class FiveBacklog(TCPRetrievalServer):
        request_queue_size = 5          # socketserver's, the JAX front's

    out = {"port": [], "five": []}
    for turn in BACKLOG_TURNS:
        cls = TCPRetrievalServer if turn == "port" else FiveBacklog
        tcp = cls(("127.0.0.1", 0), retrieval)
        serving = threading.Thread(target=tcp.serve_forever, daemon=True,
                                   name="tcp-serve-backlog")
        serving.start()
        socks = []
        try:
            socks, ms = connect_burst(tcp.server_address[1])
        finally:
            for sk in socks:
                sk.close()
            tcp.stop_accepting()
            serving.join(timeout=LAUNCH_WAIT)
        out[turn].append(dict(connect_figures(ms),
                              backlog=cls.request_queue_size))
    left = live_threads()
    if left:
        raise RuntimeError(f"backlog turns left threads running: {left}")
    return out


def report_figures(child: Child, n: int) -> dict:
    """The bounded load's report lines, parsed; fails unless every line
    has the JAX launcher's words, nothing failed and every request is
    accounted for."""
    found = {}
    for line in child.output():
        for name, pat in REPORT_LINES.items():
            m = pat.match(line)
            if m:
                found[name] = [float(g) for g in m.groups()]
    for name in ("offered", "trace", "working_set"):
        if name not in found:
            child.fail(f"no {name} line in the report")
    off, ach, p50, p95, p99 = found["offered"]
    unique, repeats, hits, degraded, shed, failed = map(
        int, found["trace"])
    if failed or unique + repeats != n:
        child.fail(f"{failed} failed, {unique} + {repeats} submitted of {n}")
    out = {"offered_qps": off, "achieved_qps": ach, "p50_ms": p50,
           "p95_ms": p95, "p99_ms": p99, "unique": unique,
           "repeats": repeats, "cache_hits": hits, "degraded": degraded,
           "shed": shed, "failed": failed, "served": n - shed - failed,
           "working_set_pct": found["working_set"][0]}
    if "caches" in found:
        out["exact_hits"], out["exact_misses"] = map(
            int, found["caches"][:2])
    if "admission" in found:
        full, deg, sheds, slo = found["admission"]
        out["admission"] = {"full": int(full), "degraded": int(deg),
                            "shed": int(sheds), "slo_ms": slo}
        if int(sheds) != shed or degraded > int(deg):
            child.fail(f"outcomes {out} against admission {out['admission']}")
    return out


def child_turn_stages(child: Child, turn: str, before: dict, after: dict,
                      twin: dict) -> dict:
    """The launcher's own records of a turn, from its ``health`` before
    and after: micro-batches formed, the pipeline at depth 2 for each
    method, and the stages that ran — the twin's stages, each launching
    where the twin's launches, the SPLADE stage 1 on the card. A child
    that ignored ``--splade-backend device`` or the pipeline flags fails
    here, whichever route its answers took. → {stage: wall s in the
    turn}."""
    ran = {}
    for name, r in after["stages"].items():
        was = before["stages"].get(name, {})
        d = {k: r[k] - was.get(k, 0) for k in ("dispatches",
                                               "device_dispatches",
                                               "wall_s")}
        if d["dispatches"]:
            ran[name] = d
    pipe = after.get("pipeline", {})
    faults = []
    if after["batches"] <= before["batches"]:
        faults.append("no micro-batch")
    if pipe.get("depth") != 2 or set(pipe.get("queues", ())) != set(
            DOOR_METHODS):
        faults.append(f"pipeline {pipe}")
    if {n: r["device_dispatches"] > 0 for n, r in ran.items()} != twin:
        faults.append(f"stages {ran} against the twin's {twin}")
    if not ran.get("splade_stage1", {}).get("device_dispatches"):
        faults.append("the SPLADE stage 1 ran on the host")
    if faults:
        child.fail(f"{turn} turn: {'; '.join(faults)}")
    return {n: r["wall_s"] for n, r in ran.items()}


def builtin_requests(corpus, trace, method: str, k: int = 20) -> list:
    """The launcher's bounded-load requests for ``trace``."""
    from repro_torch.serving.engine import Request
    return [Request(qid=i, method=method, q_emb=corpus["q_embs"][q],
                    term_ids=corpus["q_term_ids"][q],
                    term_weights=corpus["q_term_weights"][q], k=k,
                    trace_id=int(q)) for i, q in enumerate(trace)]


def launcher_full(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
                  root: pathlib.Path, device, counted: dict) -> tuple:
    """(a): the launcher on the phase-3 index at full width, against an
    in-process twin. → (figures, the twin run's launches)."""
    from repro_torch.launch.serve import build_or_load
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.server import RetrievalServer, wire_request

    reqs = (make_requests(rng, s, topics, s.n_requests)
            + colbert_requests(rng, s, min(32, s.n_requests), qid0=1000))
    lines = {r.qid: wire_line(r) for r in reqs}
    reqs = [wire_request(json.loads(ln)) for ln in lines.values()]
    by_qid = {r.qid: r for r in reqs}

    # the twin: the launcher's retriever and server settings, in process
    _, _, retr = build_or_load(str(path), "mmap", splade_backend="device",
                               device=device)
    engine = ServeEngine(retr, pipeline_depth=2, pipeline_workers="kind")
    server = RetrievalServer(engine, max_batch=s.B, batch_timeout_ms=5.0)
    server.start()
    try:
        warm = [server.submit(r) for r in fresh(reqs)]
        for f in warm:
            f.result(timeout=LAUNCH_WAIT)
        # as the TCP clients below ask: 32 closed-loop clients
        reset_counts(retr, counted)
        want, lat, wall = closed_loop(
            [lambda r: server.submit(fresh([r])[0]).result(
                timeout=LAUNCH_WAIT)] * LAUNCH_CONNS,
            [(r.qid, r) for r in reqs])
        launches = read_counts(counted)
        # the stages the twin ran, each with whether it launches
        twin_stages = {n: r["device_dispatches"] > 0 for n, r in
                       retr.pipeline_stats.snapshot()["stages"].items()
                       if r["dispatches"]}
    finally:
        server.shutdown_gracefully()
    check_launches("launcher twin", launches, DOOR_KERNELS)
    in_process = {"turn": "in_process", "qps": len(want) / wall,
                  "p50_ms": float(np.percentile(lat, 50)),
                  "p99_ms": float(np.percentile(lat, 99))}
    _, _, cpu_retr = build_or_load(str(path), "mmap", device="cpu")
    routes = hold_to_cpu(ServeEngine(cpu_retr), {"mmap": retr.searcher},
                         [(r, want[r.qid], "mmap") for r in reqs], s)
    log(f"launcher (a): the twin's {len(reqs)} answers match the CPU "
        f"engine (through a tie at a stage boundary: {routes or 'none'}); "
        f"its launches {launches}")
    figures = {"requests": len(reqs), "twin_launches": launches,
               "tie_routes": routes,
               "backlog": backlog_turns(server)}
    log(f"launcher: 32 connections at once, in process: "
        f"{figures['backlog']}")

    child = Child("launcher_full", launch_argv(
        "--index-dir", path, "--splade-backend", "device", "--max-batch",
        s.B, "--batch-timeout-ms", 5, "--pipeline-depth", 2,
        "--pipeline-workers", "kind", "--port", 0, device=device),
        root / "full")
    conns = []
    try:
        port = int(child.wait_line("RETRIEVAL_PORT=").split("=")[1])
        figures["startup_s"] = time.perf_counter() - child.t0
        socks, ms = connect_burst(port)
        conns = [OpenConn(sk) for sk in socks]
        figures["connect"] = connect_figures(ms)
        turns = [in_process]
        before = conns[0].ask(b'{"op": "health"}\n')["health"]
        for turn in LAUNCH_TURNS:
            got, lat, wall = closed_loop(
                [c.ask for c in conns],
                [(r.qid, lines[r.qid]) for r in reqs])
            for qid, reply in got.items():
                hold_reply(f"launcher {turn}", reply, want[qid], engine,
                           by_qid[qid])
            # the child's own records of the turn: batches, stage walls
            after = conns[0].ask(b'{"op": "health"}\n')["health"]
            walls = child_turn_stages(child, turn, before, after,
                                      twin_stages)
            turns.append({"turn": turn, "qps": len(got) / wall,
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p99_ms": float(np.percentile(lat, 99)),
                          "batches": after["batches"] - before["batches"],
                          "stage_wall_s": walls})
            before = after
        figures["turns"] = turns
        log(f"launcher (a): started in {figures['startup_s']:.2f} s; 32 "
            f"connects {figures['connect']}; over TCP {turns}; every "
            "reply equal to the twin's bit for bit")

        # the drain: one request on each connection, then SIGTERM
        drain = reqs[:LAUNCH_CONNS // 2] + reqs[-(LAUNCH_CONNS // 2):]
        for c, r in zip(conns, drain):
            c.sock.sendall(lines[r.qid])
        ready, _, _ = select.select([c.sock for c in conns], [], [], 0)
        in_flight = len(conns) - len(ready)
        t0 = time.perf_counter()
        child.proc.send_signal(signal.SIGTERM)
        replies = [c.rfile.readline() for c in conns]
        replies_s = time.perf_counter() - t0
        rc = child.finish(LAUNCH_EXIT)
        drain_s = time.perf_counter() - t0
        if rc != 0:
            child.fail("exit after SIGTERM")
        if not in_flight:
            raise RuntimeError("launcher (a): every drain request was "
                               "answered before SIGTERM")
        for r, raw in zip(drain, replies):
            hold_reply("launcher drain", json.loads(raw or b"{}"),
                       want[r.qid], engine, r)
        try:
            socket.create_connection(("127.0.0.1", port), timeout=10).close()
            raise RuntimeError("launcher (a): the port takes connections "
                               "after the drain")
        except ConnectionRefusedError:
            pass
        figures.update(in_flight_at_sigterm=in_flight, replies_s=replies_s,
                       drain_s=drain_s, exit_code=rc)
        log(f"launcher (a): SIGTERM with {in_flight} of {len(drain)} in "
            f"flight: every one answered, exit {rc} in {drain_s:.3f} s, "
            "the port refuses connections")
    finally:
        for c in conns:
            c.close()
        child.kill()
    return figures, launches


def launcher_live(corpus, built: pathlib.Path, root: pathlib.Path,
                  device) -> dict:
    """(b): ``--live --live-compact-every 8`` on a copy of the built-in
    index, against an in-process live twin on another copy, whose
    answers are held to a live twin on the CPU fed the same operations
    (colbert's only while the index is clean: the tie rule knows no
    delta or tombstone)."""
    from repro_torch.launch.serve import build_or_load
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.server import wire_request

    for name in ("child", "twin", "cpu"):
        shutil.copytree(built, root / "live" / name)
    _, _, retr = build_or_load(str(root / "live" / "twin"), "mmap",
                               device=device)
    retr.enable_live()
    twin = ServeEngine(retr)
    _, _, cpu_retr = build_or_load(str(root / "live" / "cpu"), "mmap",
                                   device="cpu")
    cpu_retr.enable_live()
    cpu = ServeEngine(cpu_retr)
    child = Child("launcher_live", launch_argv(
        "--index-dir", root / "live" / "child", "--live",
        "--live-compact-every", 8, "--port", 0, device=device),
        root / "live_tmp")
    checked = {"admin": 0, "queries": 0, "held_to_cpu": 0}
    conn = None
    try:
        port = int(child.wait_line("RETRIEVAL_PORT=").split("=")[1])
        conn = Conn(port, live=True)

        def admin(msg: dict, in_process):
            got = conn.ask((json.dumps(msg) + "\n").encode())
            if got != in_process:
                raise AssertionError(f"launcher live {msg['op']}: over TCP "
                                     f"{got}, in process {in_process}")
            checked["admin"] += 1

        def health(gen: int):
            for _ in range(int(LAUNCH_WAIT / 0.05)):
                got = conn.ask(b'{"op": "health"}\n')["health"]
                if got["index_generation"] >= gen:
                    break
                time.sleep(0.05)
            want = {"live": twin.live_stats(),
                    "index_generation": retr.index_generation}
            if {k: got[k] for k in want} != want:
                raise AssertionError(f"launcher live health: {got} against "
                                     f"{want}")
            checked["admin"] += 1

        def queries(first: int) -> dict:
            out, held = {}, []
            stats = retr.live_stats()
            clean = not (stats["delta_docs"] or stats["tombstones"])
            for i, method in enumerate(DOOR_METHODS):
                msg = json.loads(wire_line(corpus_request(corpus, first + i,
                                                          method)))
                got = conn.ask((json.dumps(msg) + "\n").encode())
                want = twin.process(wire_request(msg))
                hold_reply("launcher live", got, want, twin,
                           wire_request(msg))
                if method != "colbert" or clean:
                    held.append((wire_request(msg), want, "mmap"))
                out[method] = got
                checked["queries"] += 1
            hold_to_cpu(cpu, {"mmap": retr.searcher}, held, FULL)
            checked["held_to_cpu"] += len(held)
            return out

        def upsert(j: int):
            doc = {"doc_emb": corpus["doc_embs"][j][:corpus["doc_lens"][j]],
                   "term_ids": corpus["doc_term_ids"][j],
                   "term_weights": corpus["doc_term_weights"][j]}
            pid = twin.live_upsert(**doc)
            if cpu.live_upsert(**doc) != pid:
                raise AssertionError("launcher live: the CPU twin's pid")
            admin({"op": "upsert", **{k: np.asarray(v).tolist()
                                      for k, v in doc.items()}},
                  {"ok": True, "pid": pid})

        victim = queries(0)["hybrid"]["pids"][0]
        cpu.live_delete(victim)
        admin({"op": "delete", "pid": victim},
              {"ok": twin.live_delete(victim)})
        if victim in queries(0)["hybrid"]["pids"]:
            raise AssertionError(f"launcher live: deleted pid {victim} "
                                 "still answered")
        queries(4)
        for j in range(4):
            upsert(j)
        queries(8)
        for j in range(4, 8):
            upsert(j)
        compacted = twin.live_compact()["compacted"]
        cpu.live_compact()
        health(retr.index_generation)
        queries(12)
        admin({"op": "live_stats"}, {"ok": True, "live": twin.live_stats()})
        conn.close()
        conn = None
        child.proc.send_signal(signal.SIGTERM)
        rc = child.finish(LAUNCH_EXIT)
        if rc != 0:
            child.fail("exit after SIGTERM")
    finally:
        if conn is not None:
            conn.close()
        child.kill()
    log(f"launcher (b): --live: {checked['admin']} admin replies equal the "
        f"twin's, {checked['queries']} query replies bit for bit, "
        f"{checked['held_to_cpu']} of the twin's answers held to the CPU "
        f"twin's, the "
        f"AutoCompactor's generation {retr.index_generation} ({compacted} "
        f"docs) the twin's; exit {rc} after SIGTERM")
    return dict(checked, generation=retr.index_generation,
                compacted=compacted, exit_code=rc)


def builtin_b1_kernels(corpus, retr, device, peaks) -> dict:
    """The max_batch=1 hybrid path's two kernels at the built-in corpus's
    own shapes (d=64, K=256, nbits=4; one request's query and its
    first_k stage-1 candidates, as the path gathers them), which phase
    2 and 5's d=128 inputs do not reach (the tile shape follows d):
    decompress_maxsim held to its plain version on the card (allclose),
    the SPLADE top-k entry to the CPU's plain version bit for bit; each
    timed as phase 5 times it, against its bound. → {kernel: timing
    dict with ``max_abs_err``}."""
    import torch
    from repro_torch.core.plaid import pad_query_batch_host
    from repro_torch.kernels.fused_rerank.ref import stable_topk
    from repro_torch.kernels.splade_score.ops import splade_row_topk_batch
    from repro_torch.kernels.splade_score.ref import (
        splade_row_scores_batch_ref)

    searcher, k = retr.searcher, retr.params.first_k
    tids, tw = [corpus["q_term_ids"][0]], [corpus["q_term_weights"][0]]
    cache = retr.splade_device_cache()
    pids, _ = cache.score_topk(tids, tw, k)
    q, q_valid = pad_query_batch_host([corpus["q_embs"][0]])
    codes, packed, valid = searcher.gather_tokens_batch(pids)
    q, q_valid, codes, packed, valid, cmask = searcher.to_device(
        q, q_valid, codes, packed, valid, pids >= 0)
    x = dict(q=q, packed=packed, cids=codes, valid=valid, cmask=cmask,
             q_valid=q_valid, centroids=searcher.centroids,
             bw=searcher.bucket_weights)
    s = dataclasses.replace(FULL, B=1, Lq=q.shape[1], C=k,
                            d=searcher.centroids.shape[1],
                            K=searcher.centroids.shape[0])
    out = {"shapes": {"B": 1, "Lq": s.Lq, "C": k, "Ld": valid.shape[-1],
                      "d": s.d, "K": s.K, "n_docs": cache.n_docs}}
    out["decompress_maxsim"] = dict(
        measure(tile_fns(x, False), lambda: bound(x, s, peaks, False),
                graph=True),
        max_abs_err=tail_errors(x)["decompress_maxsim"])

    rows, w = kernel_rows(cache, tids, tw)
    args = (cache.row_pids, cache.row_imps, rows, w)
    tp, ts = splade_row_topk_batch(*args, n_docs=cache.n_docs, k=k)
    hp, hs = splade_row_topk_batch(*(a.cpu() for a in args),
                                   n_docs=cache.n_docs, k=k)
    if not (torch.equal(tp.cpu(), hp) and torch.equal(
            ts.cpu().view(torch.int32), hs.view(torch.int32))):
        raise AssertionError("built-in corpus: splade top-k != plain")
    fin = torch.isfinite(hs)
    out["splade_topk"] = dict(
        measure({"ms": lambda: splade_row_topk_batch(
                    *args, n_docs=cache.n_docs, k=k),
                 "plain": lambda: stable_topk(splade_row_scores_batch_ref(
                    *args, cache.n_docs), k)},
                lambda: splade_bound(cache, rows, w, peaks, k), graph=True),
        max_abs_err=(ts.cpu()[fin] - hs[fin]).abs().max().item())
    log(f"launcher (c): the B=1 kernels at the built-in corpus's shapes "
        f"{out}")
    return out


def launcher_bounded(corpus, built: pathlib.Path, root: pathlib.Path,
                     device, mu_s: float, counted: dict, peaks) -> tuple:
    """(c): the bounded load at the launcher's defaults and at full
    options, each in a child on the built-in corpus; in process, the
    same index's stage costs for the admission SLO, the max_batch=1
    run's launches and answers (held to the CPU engine) with either
    stage 1, and its kernels at this corpus's shapes. → (figures,
    {path: launches})."""
    from repro_torch.launch.serve import build_or_load
    from repro_torch.serving.admission import AdmissionController
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.loadgen import run_poisson_load, zipf_trace
    from repro_torch.serving.server import RetrievalServer

    n_unique = len(corpus["q_embs"])
    rr = np.arange(LAUNCH_B1_N) % n_unique
    launches, warm_b1 = {}, {}
    _, _, retr = build_or_load(str(built), "mmap", splade_backend="device",
                               device=device)
    _, _, cpu_retr = build_or_load(str(built), "mmap", device="cpu")
    cpu = ServeEngine(cpu_retr)
    for label, backend in (("launcher_b1", "host"),
                           ("launcher_b1_device", "device")):
        retr.set_splade_backend(backend)
        server = RetrievalServer(ServeEngine(retr))    # max_batch=1
        server.start()
        reqs, got = builtin_requests(corpus, rr, "hybrid"), []
        try:
            run_poisson_load(server, builtin_requests(corpus, rr[:8],
                                                      "hybrid"), qps=1e6)
            reset_counts(retr, counted)
            res = run_poisson_load(server, fresh(reqs), qps=LAUNCH_B1_QPS,
                                   seed=0, on_result=got.append)
            launches[label] = read_counts(counted)
        finally:
            server.shutdown_gracefully()
        expect_launches(label, launches[label], {
            "decompress_maxsim": LAUNCH_B1_N,
            "splade_topk": LAUNCH_B1_N if backend == "device" else 0})
        if res.failed or sorted(r.qid for r in got) != list(range(len(rr))):
            raise RuntimeError(f"{label}: {res.failed} failed, "
                               f"{len(got)} of {len(rr)} answered")
        hold_to_cpu(cpu, {"mmap": retr.searcher},
                    [(reqs[r.qid], r, "mmap") for r in got], FULL)
        # warm, as the child is not: the same load after 8 requests
        warm_b1[label] = {k: finite(v) for k, v in res.summary().items()}
    log(f"launcher (c): the max_batch=1 answers with each stage 1 match "
        f"the CPU engine")
    b1_kernels = builtin_b1_kernels(corpus, retr, device, peaks)

    # the SLO between the cheap and the full plan's cost, warm, at the
    # child's batch
    eng = ServeEngine(retr)
    batch = builtin_requests(corpus, np.arange(32), "hybrid")
    eng.process_batch(fresh(batch))
    retr.reset_stage_stats()
    eng.process_batch(fresh(batch))
    stage1_ms, tail_ms, _ = AdmissionController.stage_costs(
        retr.pipeline_stats.snapshot()["stages"])
    slo_ms = stage1_ms + tail_ms / 2
    rate = 0.75 * mu_s
    runs = {}
    for label, flags, trace in (
            ("defaults", ("--n", LAUNCH_B1_N, "--qps", LAUNCH_B1_QPS), rr),
            ("options", ("--splade-backend", "device", "--max-batch", 32,
                         "--n", LAUNCH_LOAD_N, "--arrival-rate", rate,
                         "--skew", LAUNCH_LOAD_SKEW, "--cache-exact", 256,
                         "--cache-stage1", 256, "--admission-slo-ms",
                         slo_ms),
             zipf_trace(LAUNCH_LOAD_N, n_unique, skew=LAUNCH_LOAD_SKEW,
                        seed=0))):
        child = Child(f"launcher_{label}", launch_argv(*flags,
                                                       device=device),
                      root / f"bounded_{label}")
        try:
            rc = child.finish()
            if rc != 0:
                child.fail("bounded load")
            fig = report_figures(child, len(trace))
        finally:
            child.kill()
        unique = len(set(trace.tolist()))
        if (fig["unique"], fig["repeats"]) != (unique, len(trace) - unique):
            raise AssertionError(f"launcher {label}: trace {fig} against "
                                 f"{unique} unique of {len(trace)}")
        fig.update(exit_code=rc, wall_s=time.perf_counter() - child.t0,
                   flags=[str(f) for f in flags])
        runs[label] = fig
        log(f"launcher (c) {label}: exit {rc}, {fig}")
    log(f"launcher (c): in process, warm, max_batch=1: {warm_b1}")
    return {"stage1_ms": stage1_ms, "tail_ms": tail_ms, "slo_ms": slo_ms,
            "arrival_rate": rate, "runs": runs,
            "in_process_b1": warm_b1, "b1_kernels": b1_kernels}, launches


def example_run(root: pathlib.Path, device) -> dict:
    """(d): ``examples/serve_concurrent_torch.py --max-batch 32 --n 128
    --tcp``."""
    child = Child("example", [
        "examples/serve_concurrent_torch.py", "--max-batch", "32", "--n",
        str(LAUNCH_EXAMPLE_N), "--tcp", *device_flags(device)],
        root / "example")
    try:
        rc = child.finish()
        if rc != 0:
            child.fail("example")
        found = {name: [] for name in EXAMPLE_LINES}
        for line in child.output():
            for name, pat in EXAMPLE_LINES.items():
                m = pat.match(line)
                if m:
                    found[name].append([float(g) for g in m.groups()])
        want = {"capacity": 1, "rate": 4, "response": 1, "drained": 1}
        if {n: len(v) for n, v in found.items()} != want:
            child.fail(f"example output: {found}")
    finally:
        child.kill()
    out = {"exit_code": rc, "wall_s": time.perf_counter() - child.t0,
           "service_ms": found["capacity"][0][0],
           "capacity_qps": found["capacity"][0][1],
           "rates": [dict(zip(("offered_qps", "p50_ms", "p95_ms", "p99_ms",
                               "achieved_qps"), row))
                     for row in found["rate"]]}
    log(f"launcher (d): the example: exit {rc}, {out}")
    return out


def launcher_phase(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
                   device, mu_s: float, peaks) -> tuple:
    """Phase 4h (see the module docstring). → (the ``launcher`` line's
    figures, {path: launches})."""
    from repro_torch.launch.serve import build_or_load
    counted = counted_kernels()
    root = path / "launcher"
    t0 = time.perf_counter()
    corpus, _, _ = build_or_load(str(root / "builtin"), "mmap",
                                 device=device)
    out = {"builtin_build_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["full"], twin = launcher_full(rng, s, path, topics, root, device,
                                      counted)
    out["full_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["live"] = launcher_live(corpus, root / "builtin", root, device)
    out["live_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["bounded"], launches = launcher_bounded(
        corpus, root / "builtin", root, device, mu_s, counted, peaks)
    out["bounded_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["example"] = example_run(root, device)
    out["example_s"] = time.perf_counter() - t0
    launches["launcher"] = twin
    out["exit_codes"] = {
        "full": out["full"]["exit_code"], "live": out["live"]["exit_code"],
        **{f"bounded_{k}": v["exit_code"]
           for k, v in out["bounded"]["runs"].items()},
        "example": out["example"]["exit_code"]}
    return out, launches


# ---------------------------------------------------------------------------
# phase 4i: frozen in-process shards
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4)
# the served runs' shard counts, in turns, so that drift on the card and
# its host favours none of them; each at depth 1, then at depth 2 with
# kind workers
SHARD_ORDER = (1, 2, 4, 4, 2, 1)
SHARD_TURNS = ((1, None), (2, "kind"))
# the traced depth-2 turns' switch intervals, as fractions of the
# interpreter's own
TRACE_INTERVALS = (1.0, 0.05)


class SyncClock:
    """While in use, sums the wall time spent inside the port's host
    syncs, from whatever thread calls them: ``finalize_topk`` (stage 1's
    copy to the host, which waits for the stream), ``HostCopy.wait`` (a
    tail's event) and ``PLAIDSearcher.to_device`` (a copy from pageable
    host memory, which waits for the stream too). The waits include the
    time a thread then takes to get the GIL back."""

    def __init__(self):
        from repro_torch.common import HostCopy
        from repro_torch.core.plaid import PLAIDSearcher
        from repro_torch.index.splade_device import SpladeDeviceCache
        self.targets = ((SpladeDeviceCache, "finalize_topk"),
                        (HostCopy, "wait"), (PLAIDSearcher, "to_device"))
        self.lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.walls = {n: 0.0 for _, n in self.targets}
            self.calls = {n: 0 for _, n in self.targets}

    def _timed(self, name: str, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                with self.lock:
                    self.walls[name] += dt
                    self.calls[name] += 1
        return call

    def __enter__(self):
        self.saved = [(cls, n, cls.__dict__[n]) for cls, n in self.targets]
        for cls, n, raw in self.saved:
            if isinstance(raw, staticmethod):
                setattr(cls, n, staticmethod(self._timed(n, raw.__func__)))
            else:
                setattr(cls, n, self._timed(n, raw))
        return self

    def __exit__(self, *exc):
        for cls, n, raw in self.saved:
            setattr(cls, n, raw)


def shard_retriever(path: pathlib.Path, groups: dict, n_shards: int, device,
                    plaid):
    """The group of ``n_shards`` over phase 3's index with PLAID at
    ``plaid``: one shard wraps a retriever over the index itself (the
    one-shard group); more load the group ``split_index_tree`` wrote
    (``groups``: n_shards → (shard dirs, boundaries))."""
    from repro_torch.core.multistage import (MultiStageParams,
                                             MultiStageRetriever)
    from repro_torch.core.plaid import PLAIDSearcher
    from repro_torch.core.sharded import (ShardedRetriever,
                                          build_sharded_retriever)
    from repro_torch.index.builder import ColBERTIndex
    from repro_torch.index.splade_index import SpladeIndex
    ms = MultiStageParams(first_k=FULL.C, k=100)
    if n_shards == 1:
        one = MultiStageRetriever(
            SpladeIndex.load(path / "splade", mmap=True),
            PLAIDSearcher(ColBERTIndex(path / "colbert", mode="mmap"), plaid,
                          device=device), ms, device=device)
        return ShardedRetriever([one], [0, one.splade.n_docs])
    dirs, bounds = groups[n_shards]
    return build_sharded_retriever(dirs, bounds, plaid_params=plaid,
                                   multistage_params=ms, device=device)


def group_access(retr):
    from repro_torch.core.sharded import CombinedAccessStats
    return CombinedAccessStats([sh.searcher.index.store.stats
                                for sh in retr.shards])


def stage_dispatches(retr) -> dict:
    return {n: r["dispatches"]
            for n, r in retr.pipeline_stats.snapshot()["stages"].items()}


def check_shard_launches(label: str, n_shards: int, backend: str,
                         launches: dict, disp: dict) -> None:
    """A run's launches against its stage records: one shard is the
    unsharded path (per method group one stage-1 launch with the device
    stage 1, one tail launch: fused_rerank for rerank, decompress_maxsim
    for hybrid); more shards launch, per method group, the SPLADE top-k
    entry once per shard with the device stage 1, decompress_maxsim once
    per shard per rerank or hybrid group, and fused_rerank never."""
    s1 = disp.get("splade_stage1", 0) if backend == "device" else 0
    if n_shards == 1:
        tail = disp.get("fused_rerank", 0)
        ok = (launches["splade_topk"] == s1 and launches["fused_rerank"] > 0
              and launches["decompress_maxsim"] > 0
              and launches["fused_rerank"] + launches["decompress_maxsim"]
              == tail)
    else:
        ok = (launches["splade_topk"] == n_shards * s1
              and launches["decompress_maxsim"]
              == n_shards * disp.get("device_score:maxsim", 0)
              and launches["fused_rerank"] == 0)
    ok = ok and launches["splade_score"] == launches["maxsim"] == 0
    if not ok:
        raise RuntimeError(f"{label}: launches {launches} against the stage "
                           f"records {disp}")


def sharded_splade(rng, s: Shapes, path: pathlib.Path, groups: dict,
                   topics: np.ndarray, device, counted: dict) -> dict:
    """Phase 4i (b): the SPLADE methods at 1, 2 and 4 shards, each stage
    1, synchronously in fixed batches, then through ``RetrievalServer``
    at depth 1 and 2 (kind) with the shard counts in the turns of
    ``SHARD_ORDER``: every answer equal to the unsharded card engine's
    bit for bit."""
    from repro_torch.serving.engine import ServeEngine
    reqs = make_requests(rng, s, topics, s.n_requests)
    warm = make_requests(rng, s, topics, 6, qid0=60_000)
    chunks = [reqs[lo:lo + s.B] for lo in range(0, len(reqs), s.B)]
    plain = make_retriever(path, device)
    runs, reads, by_path = [], {}, {}
    for backend in ("host", "device"):
        ref = ServeEngine(plain, splade_backend=backend)
        want = [r for c in chunks for r in ref.process_batch(fresh(c))]
        retrs = {}
        for n_shards in SHARD_COUNTS:
            retr = retrs[n_shards] = shard_retriever(
                path, groups, n_shards, device, plaid_params(s))
            engine = ServeEngine(retr, splade_backend=backend)
            access = group_access(retr)
            access.reset()
            got = [r for c in chunks for r in engine.process_batch(fresh(c))]
            snap = access.snapshot()
            same_bits(want, got, f"sharded S={n_shards} {backend} in "
                                 "batches of 32")
            reads[f"{backend}_S{n_shards}"] = {
                "tokens_read": snap["tokens_read"],
                "pages_touched": snap["pages_touched"]}
        for n_shards in SHARD_ORDER:
            retr = retrs[n_shards]
            for depth, workers in SHARD_TURNS:
                label = (f"sharded S={n_shards} {backend} depth {depth}"
                         + (f" {workers}" if workers else ""))
                eng = ServeEngine(retr, splade_backend=backend,
                                  pipeline_depth=depth,
                                  pipeline_workers=workers or "single")
                results, line = serve_run(eng, warm, fresh(reqs), s.B,
                                          counted)
                disp = stage_dispatches(retr)
                eng.close()
                join_pipeline_threads(label)
                check_shard_launches(label, n_shards, backend,
                                     line["launches"], disp)
                same_bits(want, results, label)
                walls = line["stage_wall_s"]
                line.update(shards=n_shards, splade_backend=backend,
                            depth=depth, workers=workers,
                            stage_dispatches=disp,
                            residual_gather_s=walls.get(
                                "host_gather:residuals"))
                runs.append(line)
                if depth == 1 and backend == "device":
                    by_path.setdefault(n_shards, line["launches"])
                log(f"{label}: {line['qps']:.1f} QPS, p50 "
                    f"{line['p50_ms']:.1f} ms, p99 {line['p99_ms']:.1f} ms; "
                    f"stage walls {walls}; launches {line['launches']}; "
                    "equal to the unsharded engine bit for bit")
        if backend == "device":
            trace = sync_trace(retrs, warm, reqs, want, s, counted)
        del retrs, retr, engine
    tokens = {v["tokens_read"] for v in reads.values()}
    if len(tokens) != 1:
        raise RuntimeError(f"sharded: tokens read differ across shard "
                           f"counts: {reads}")
    log(f"sharded: tokens read and pages touched in batches of 32 {reads}")
    return {"runs": runs, "reads": reads, "launches": by_path,
            "trace": trace}


def sync_trace(retrs: dict, warm, reqs, want, s: Shapes,
               counted: dict) -> list:
    """Phase 4i (b), the trace of depth 2: the depth-2 kind turns of 1
    and 4 shards with the device stage 1, at each switch interval of
    ``TRACE_INTERVALS``, with the wall inside the host syncs summed
    (:class:`SyncClock`) over the same requests as the stage walls.
    Every answer equal to the unsharded engine's bit for bit."""
    from repro_torch.serving.engine import ServeEngine
    default = sys.getswitchinterval()
    lines = []
    for frac in TRACE_INTERVALS:
        for n_shards in (1, 4):
            label = (f"sharded trace S={n_shards} depth 2 kind, switch "
                     f"interval {default * frac * 1e3:g} ms")
            clock = SyncClock()
            sys.setswitchinterval(default * frac)
            try:
                with clock:
                    eng = ServeEngine(retrs[n_shards], splade_backend="device",
                                      pipeline_depth=2,
                                      pipeline_workers="kind")
                    try:
                        results, line = serve_run(eng, warm, fresh(reqs),
                                                  s.B, counted,
                                                  on_start=clock.reset)
                    finally:
                        eng.close()
            finally:
                sys.setswitchinterval(default)
            join_pipeline_threads(label)
            same_bits(want, results, label)
            line.update(shards=n_shards, switch_interval_s=default * frac,
                        sync_wall_s=dict(clock.walls),
                        sync_calls=dict(clock.calls))
            lines.append(line)
            log(f"{label}: {line['qps']:.1f} QPS; stage walls "
                f"{line['stage_wall_s']}; inside the syncs {clock.walls} "
                f"over {clock.calls} calls")
    return lines


def sharded_colbert(rng, s: Shapes, path: pathlib.Path, groups: dict,
                    device, counted: dict) -> dict:
    """Phase 4i (c): colbert, mmap, one batch of 32 at nprobe 4, ndocs
    256. At a cap that cannot bind (the query tokens × nprobe × the
    longest IVF list), 2 and 4 shards equal the unsharded engine (ids up
    to exact-score ties); at phase 4's binding cap each card group is
    held to the port's CPU group over the same shard directories."""
    from repro_torch.core.plaid import PlaidParams
    from repro_torch.index.builder import ColBERTIndex
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.testing import (REF_MARGIN,
                                     assert_same_up_to_exact_ties,
                                     assert_topk_match)
    reqs = colbert_requests(rng, s, s.B)
    warm = colbert_requests(rng, s, 4, qid0=61_000)
    longest = ColBERTIndex(path / "colbert").ivf.max_list_len()
    open_cap = s.Lq * s.nprobe * longest
    caps = {"open": PlaidParams(nprobe=s.nprobe, candidate_cap=open_cap,
                                ndocs=s.ndocs, k=100),
            "binding": plaid_params(s)}
    out = {"open_cap": open_cap, "binding_cap": s.candidate_cap,
           "ivf_longest_list": longest, "runs": []}
    want = None
    for cap, n_shards in (("open", 1), ("open", 2), ("open", 4),
                          ("binding", 2), ("binding", 4)):
        label = f"sharded colbert S={n_shards} cap {cap}"
        retr = shard_retriever(path, groups, n_shards, device, caps[cap])
        access = group_access(retr)
        access.reset()
        results, line = serve_run(ServeEngine(retr), warm, fresh(reqs), s.B,
                                  counted)
        disp = stage_dispatches(retr)
        launches = line["launches"]
        tail = ({"fused_rerank": disp["fused_rerank"]} if n_shards == 1 else
                {"decompress_maxsim": n_shards
                 * disp["device_score:exact"]})
        expect_launches(label, launches, tail)
        snap = access.snapshot()
        pages = line["stage_pages"]
        if pages["host_gather:codes"] != 0 \
                or pages["host_gather:residuals"] == 0:
            raise RuntimeError(f"{label}: residual pages touched by the "
                               f"codes / residual gathers: {pages}")
        line.update(shards=n_shards, cap=caps[cap].candidate_cap,
                    stage_dispatches=disp,
                    tokens_read=snap["tokens_read"],
                    pages_touched=snap["pages_touched"])
        if cap == "open" and n_shards == 1:
            counts = candidate_counts(retr.shards[0].searcher,
                                      [r.q_emb for r in reqs], s.B)
            if counts["queries_capped"]:
                raise RuntimeError(f"{label}: the cap binds: {counts}")
            out["open_candidates"] = counts
            want = results
        elif cap == "open":
            for a, b in zip(want, results, strict=True):
                assert_same_up_to_exact_ties(
                    (a.pids, a.scores), (b.pids, b.scores),
                    what=f"{label} qid {b.qid}")
        else:
            cpu = ServeEngine(shard_retriever(path, groups, n_shards, "cpu",
                                              caps[cap]))
            ref = cpu.process_batch([dataclasses.replace(
                r, ctx=None, k=r.k + REF_MARGIN) for r in reqs])
            for req, a, b in zip(reqs, ref, results, strict=True):
                assert_topk_match(a.scores, a.pids, b.scores, b.pids,
                                  what=f"{label} qid {b.qid} k={req.k}")
            del cpu
        out["runs"].append(line)
        log(f"{label}: {line['qps']:.1f} QPS, p50 {line['p50_ms']:.1f} ms; "
            f"stage walls {line['stage_wall_s']}; tokens read "
            f"{snap['tokens_read']}, pages {snap['pages_touched']}; "
            f"launches {launches}; "
            + ("the reference" if want is results else
               "equal to unsharded bit for bit, ids up to exact-score ties"
               if cap == "open" else "held to the port's CPU group"))
        del retr
    return out


def sharded_kernels(rng, s: Shapes, path: pathlib.Path, groups: dict,
                    topics: np.ndarray, device, peaks) -> dict:
    """The sharded path's two kernels at the shapes it launches them, on
    one batch of 32 queries and 4 shards: decompress_maxsim on each
    shard's own candidates of the merged stage-1 rows (C = the shard's
    width), held to its plain version, and every candidate's score
    equal bit for bit to a launch over the unsharded (B, first_k)
    candidates; the SPLADE top-k entry on each shard's postings, equal
    to its plain version bit for bit. Shard 0's launches are timed as
    phase 5 times them, against their bounds."""
    import torch
    from repro_torch.core.plaid import pad_query_batch_host
    from repro_torch.core.sharded import compact_owned, scatter_scores
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.decompress_maxsim.ref import (
        decompress_maxsim_ref)
    from repro_torch.kernels.fused_rerank.ref import stable_topk
    from repro_torch.kernels.splade_score.ops import splade_row_topk_batch
    from repro_torch.kernels.splade_score.ref import (
        splade_row_scores_batch_ref)
    from repro_torch.testing import ATOL, RTOL

    retr = shard_retriever(path, groups, 4, device, plaid_params(s))
    tids, tw = topic_terms(rng, topics, s.B, s.query_terms)
    tids, tw = list(tids), list(tw)
    pids_b, _ = retr.run_splade_batch(tids, tw)
    q_host = pad_query_batch_host([unit(rng.normal(size=(s.Lq, s.d)))
                                   for _ in range(s.B)])

    def tile_inputs(searcher, pids):
        q, q_valid, codes, packed, valid, cmask = searcher.to_device(
            *q_host, *searcher.gather_tokens_batch(pids), pids >= 0)
        return dict(q=q, packed=packed, cids=codes, valid=valid,
                    cmask=cmask, q_valid=q_valid,
                    centroids=searcher.centroids,
                    bw=searcher.bucket_weights)

    def launch(x):
        return dms(x["q"], x["packed"], x["cids"], x["valid"],
                   x["centroids"], x["bw"], nbits=4, q_valid=x["q_valid"])

    full = launch(tile_inputs(make_searcher(path, device), pids_b))
    full = full.cpu().numpy()
    scattered = np.full(pids_b.shape, np.nan, np.float32)
    out = {"C": [], "n_docs": [], "max_abs_err": 0.0}
    for i, sh in enumerate(retr.shards):
        cols, sel = compact_owned(pids_b, retr.offsets[i],
                                  retr.offsets[i + 1])
        x = tile_inputs(sh.searcher, sel)
        got = launch(x)
        want = decompress_maxsim_ref(x["q"], x["packed"], x["cids"],
                                     x["valid"], x["centroids"], x["bw"], 4,
                                     x["q_valid"])
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        np.testing.assert_allclose(got_np, want_np, rtol=RTOL, atol=ATOL,
                                   err_msg=f"shard {i} decompress_maxsim")
        real = sel >= 0
        out["max_abs_err"] = max(out["max_abs_err"], float(
            np.abs(got_np[real] - want_np[real]).max()))
        scatter_scores(scattered, cols, got_np)
        out["C"].append(int(sel.shape[1]))
        if i == 0:
            shape = dataclasses.replace(s, C=int(sel.shape[1]))
            out["decompress_maxsim"] = dict(measure(
                tile_fns(x, False), lambda: bound(x, shape, peaks, False),
                graph=True), C=int(sel.shape[1]))
        cache = sh.splade_device_cache()
        rows, w = kernel_rows(cache, tids, tw)
        args = (cache.row_pids, cache.row_imps, rows, w)
        tp, ts = splade_row_topk_batch(*args, n_docs=cache.n_docs, k=s.C)
        hp, hs = splade_row_topk_batch(*(a.cpu() for a in args),
                                       n_docs=cache.n_docs, k=s.C)
        if not (torch.equal(tp.cpu(), hp) and torch.equal(
                ts.cpu().view(torch.int32), hs.view(torch.int32))):
            raise AssertionError(f"shard {i}: splade top-k != plain")
        out["n_docs"].append(int(cache.n_docs))
        if i == 0:
            out["splade_topk"] = dict(measure(
                {"ms": lambda: splade_row_topk_batch(
                    *args, n_docs=cache.n_docs, k=s.C),
                 "plain": lambda: stable_topk(splade_row_scores_batch_ref(
                    *args, cache.n_docs), s.C)},
                lambda: splade_bound(cache, rows, w, peaks, s.C),
                graph=True), n_docs=int(cache.n_docs), max_abs_err=0.0)
    real = pids_b >= 0
    if not np.array_equal(scattered[real].view(np.uint32),
                          full[real].view(np.uint32)):
        raise AssertionError("a shard's decompress_maxsim scores differ "
                             "from the unsharded launch's")
    out["decompress_maxsim"]["max_abs_err"] = out["max_abs_err"]
    log(f"sharded kernels at the shards' widths {out['C']}: "
        f"decompress_maxsim held to plain (max |err| "
        f"{out['max_abs_err']:.3g}) and equal to the unsharded width-"
        f"{s.C} launch bit for bit; splade top-k on {out['n_docs']} docs "
        f"equal to plain; shard 0 timed: {out}")
    return out


def sharded_phase(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
                  device, peaks) -> tuple:
    """Phase 4i (see the module docstring). → (the ``sharded`` line's
    figures, {n_shards: the device-stage-1 depth-1 run's launches}, the
    kernels at the shards' shapes)."""
    import torch
    from repro_torch.index.sharding import load_group, split_index_tree
    torch.cuda.reset_peak_memory_stats(device)
    counted = counted_kernels()
    out = {"split": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        groups = {}
        for n_shards in SHARD_COUNTS[1:]:
            t0 = time.perf_counter()
            group = split_index_tree(path, n_shards,
                                     group_dir=pathlib.Path(tmp)
                                     / f"S{n_shards}")
            seconds = time.perf_counter() - t0
            groups[n_shards] = load_group(group)
            written = sum(f.stat().st_size for f in group.rglob("*")
                          if f.is_file())
            out["split"][n_shards] = {
                "seconds": seconds, "bytes_written": written,
                "boundaries": groups[n_shards][1].tolist()}
            log(f"sharded (a): split into {n_shards} shards in "
                f"{seconds:.2f} s, {written} bytes written")
        t0 = time.perf_counter()
        splade = sharded_splade(rng, s, path, groups, topics, device,
                                counted)
        out["splade_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["colbert"] = sharded_colbert(rng, s, path, groups, device,
                                         counted)
        out["colbert_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kernels = sharded_kernels(rng, s, path, groups, topics, device,
                                  peaks)
        out["kernels_s"] = time.perf_counter() - t0
        retr = shard_retriever(path, groups, 4, device, plaid_params(s))
        out["memory"] = {
            "splade_device_cache_bytes": [
                c.nbytes() for c in retr.splade_device_cache()],
            "centroid_bytes_per_shard": [
                sh.searcher.centroids.numel() * 4 for sh in retr.shards],
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}
        del retr
    out["runs"], out["reads"] = splade["runs"], splade["reads"]
    out["trace"] = splade["trace"]
    out["kernels"] = kernels
    log(f"sharded: memory {out['memory']}")
    return out, splade["launches"], kernels


# ---------------------------------------------------------------------------
# phase 4j: the sharded live index
# ---------------------------------------------------------------------------

# (a) holds the first SHARDED_LIVE_QUERIES of phase 3b's queries (phase
# 4f (a) serves all of them); (b) deletes SHARDED_LIVE_DELETES[0] base
# pids in each shard of the 4-shard group and SHARDED_LIVE_DELETES[1]
# delta pids
SHARDED_LIVE_QUERIES = 64
SHARDED_LIVE_DELETES = (15, 4)


class DeltaLaunches:
    """While in use, counts the calls of ``LiveIndexState.exact_scores``:
    each launches decompress_maxsim once, over the delta's candidates.
    ``widest`` keeps the arguments of the call with the most rows, for
    :func:`delta_kernel`."""

    def __enter__(self):
        from repro_torch.index.live import LiveIndexState
        self.raw, self.calls = LiveIndexState.exact_scores, 0
        self.widest = None

        def counted(state, q, q_valid, pids_mat):
            self.calls += 1
            pids_mat = np.asarray(pids_mat)
            if self.widest is None or pids_mat.shape[0] \
                    > self.widest[3].shape[0]:
                self.widest = (state, q, q_valid, pids_mat.copy())
            return self.raw(state, q, q_valid, pids_mat)
        LiveIndexState.exact_scores = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.index.live import LiveIndexState
        LiveIndexState.exact_scores = self.raw


def sharded_live_parity(replay: dict, base: pathlib.Path,
                        root: pathlib.Path, device, counted: dict) -> list:
    """4j (a): phase 4f (a)'s base split into 2 and 4 shards, each group
    fed 4f (a)'s two rounds of mutations, each round ending in
    ``compact_live()``; the four methods at each k of ``LIVE_KS``, dirty
    and compacted, equal 4f (a)'s pinned card rebuild bit for bit and
    the unsharded live retriever's answers in that round. → a line per
    group."""
    from repro_torch.core.sharded import build_sharded_retriever
    from repro_torch.index.sharding import load_group, split_index_tree
    plaid, ms = live_parity_params(replay["cap"])
    queries = replay["queries"]
    out = []
    for n_shards in SHARD_COUNTS[1:]:
        t0 = time.perf_counter()
        dirs, bounds = load_group(split_index_tree(
            base, n_shards, group_dir=root / f"S{n_shards}"))
        line = {"shards": n_shards, "split_s": time.perf_counter() - t0,
                "boundaries": bounds.tolist(), "rounds": []}
        retr = build_sharded_retriever(dirs, bounds, plaid_params=plaid,
                                       multistage_params=ms, device=device)
        retr.enable_live()
        for rnd, r in enumerate(replay["rounds"], 1):
            for op, arg in r["ops"]:
                if op == "upsert":
                    retr.live_upsert(*arg)
                elif not retr.live_delete(arg):
                    raise AssertionError(f"delete {arg} refused")
            label = f"sharded live (a) S={n_shards} round {rnd}"
            t0 = time.perf_counter()
            dirty, dirty_l = live_answers(retr, queries, counted, True)
            dirty_s = time.perf_counter() - t0
            same_answers(dirty, r["rebuild"], f"{label} dirty vs rebuild",
                         r["survivors"])
            same_answers(dirty, r["dirty"], f"{label} dirty vs unsharded")
            reply = retr.compact_live()
            compacted, compacted_l = live_answers(retr, queries, counted,
                                                  True)
            same_answers(compacted, r["rebuild"],
                         f"{label} compacted vs rebuild", r["survivors"])
            same_answers(compacted, r["compacted"],
                         f"{label} compacted vs unsharded")
            line["rounds"].append({
                "mutations": len(r["ops"]), "dirty_serve_s": dirty_s,
                "dirty_launches": dirty_l,
                "compacted_launches": compacted_l,
                "tombstones_per_shard": [len(sh.live.tombstones)
                                         for sh in retr.shards],
                "compaction": {"compacted": reply["compacted"],
                               "seconds": reply["seconds"]}})
            log(f"{label}: dirty and compacted answers == the pinned card "
                f"rebuild of {len(r['survivors'])} survivors and == the "
                f"unsharded live retriever bit for bit "
                f"({len(queries['q_embs'])} queries × 4 methods × k "
                f"{LIVE_KS}); dirty launches {dirty_l}; compaction "
                f"{reply['seconds']}")
        out.append(line)
        del retr
    return out


def check_live_launches(label: str, n_shards: int, launches: dict,
                        disp: dict, delta: int) -> None:
    """A dirty run's launches against its stage records: per rerank or
    hybrid group decompress_maxsim once a shard (``device_score:maxsim``)
    and once more where the group has delta candidates (``delta``: the
    calls of ``exact_scores``, at most one a group); no other kernel."""
    groups = disp.get("device_score:maxsim", 0)
    ok = (launches["decompress_maxsim"] == n_shards * groups + delta
          and 0 < delta <= groups and groups > 0
          and not any(c for name, c in launches.items()
                      if name != "decompress_maxsim"))
    if n_shards > 1:
        ok = ok and disp.get("device_score:delta") == groups
    if not ok:
        raise RuntimeError(f"{label}: launches {launches}, {delta} delta "
                           f"launches, against the stage records {disp}")


def delta_kernel(call: tuple, s: Shapes, peaks) -> dict:
    """The coordinator's delta launch of a dirty group, replayed from
    ``call`` (``DeltaLaunches.widest``: the live state, the batch's
    device query and mask, the (B, W) delta pid matrix, -1 padded):
    decompress_maxsim on the tile inputs ``LiveIndexState.exact_scores``
    builds, held to its plain version (allclose everywhere, the largest
    error over the real candidates) and timed at that shape, against
    the bound of its real candidates."""
    from repro_torch.testing import ATOL, RTOL
    state, q, q_valid, pids_mat = call
    if state.nbits != 4:
        raise AssertionError(f"delta nbits {state.nbits}, timed at 4")
    mask_np = pids_mat >= 0
    codes, packed, valid, cmask = state._to_device(
        *state._gather_delta(pids_mat, with_packed=True), mask_np)
    x = {"q": q, "packed": packed, "cids": codes, "valid": valid,
         "q_valid": q_valid, "cmask": cmask, "centroids": state._centroids,
         "bw": state._bweights}
    fns = tile_fns(x, False)
    got, want = fns["ms"]().cpu().numpy(), fns["plain"]().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg="the delta's decompress_maxsim")
    B, W = pids_mat.shape
    shape = dataclasses.replace(s, C=W)
    return dict(measure(fns, lambda: bound(x, shape, peaks, False),
                        graph=True),
                B=int(B), C=int(W), real=int(mask_np.sum()),
                max_abs_err=float(np.abs(got[mask_np]
                                         - want[mask_np]).max()))


def sharded_live_colbert(rng, s: Shapes, path: pathlib.Path, groups: dict,
                         device, counted: dict, docs: list,
                         dels: np.ndarray) -> dict:
    """4j (b), colbert: a 4-shard group and the unsharded retriever at a
    cap that cannot bind (phase 4i (c)'s open cap), live, fed (b)'s
    upserts and deletes; 32 colbert requests (every other one made from
    an upserted doc's tokens, so the delta's candidates reach both
    device stages of the delta) through ``RetrievalServer`` at
    max_batch=32: every answer equal to the unsharded live engine's,
    ids up to exact-score ties (phase 4i (c)'s group-to-single bar for
    colbert); the launches, decompress_maxsim 4 × ``device_score:exact``
    plus the delta's (``device_score:exact:delta`` once a batch), no
    other kernel. → the run's line."""
    from repro_torch.core.plaid import PlaidParams
    from repro_torch.index.builder import ColBERTIndex
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.testing import assert_same_up_to_exact_ties
    longest = ColBERTIndex(path / "colbert").ivf.max_list_len()
    plaid = PlaidParams(nprobe=s.nprobe, candidate_cap=s.Lq * s.nprobe
                        * longest, ndocs=s.ndocs, k=100)
    ref = shard_retriever(path, groups, 1, device, plaid).shards[0]
    group = shard_retriever(path, groups, 4, device, plaid)
    for r in (ref, group):
        r.enable_live()
        for i, (emb, tids, tw) in enumerate(docs):
            if r.live_upsert(emb, tids, tw) != s.n_docs + i:
                raise AssertionError("an upsert got another pid")
        for g in dels.tolist():
            if not r.live_delete(g):
                raise AssertionError(f"delete {g} refused")
    reqs = colbert_requests(rng, s, s.B, qid0=92_000)
    for i in range(0, len(reqs), 2):
        emb = docs[int(rng.integers(len(docs)))][0]
        rows = emb[rng.integers(0, len(emb), s.Lq)]
        reqs[i] = dataclasses.replace(reqs[i], q_emb=unit(
            rows + 0.05 * rng.normal(size=rows.shape)))
    warm = colbert_requests(rng, s, 4, qid0=93_000)
    want = ServeEngine(ref).process_batch(fresh(reqs))
    label = "sharded live S=4 dirty colbert"
    with DeltaLaunches() as delta:
        results, line = serve_run(
            ServeEngine(group), warm, fresh(reqs), s.B, counted,
            on_start=lambda: setattr(delta, "calls", 0))
    disp = stage_dispatches(group)
    launches = line["launches"]
    exact = disp.get("device_score:exact", 0)
    if not (launches["decompress_maxsim"] == 4 * exact + delta.calls
            and 0 < delta.calls <= exact
            and disp.get("device_score:approx:delta") == exact
            and disp.get("device_score:exact:delta") == exact
            and not any(c for name, c in launches.items()
                        if name != "decompress_maxsim")):
        raise RuntimeError(f"{label}: launches {launches}, {delta.calls} "
                           f"delta launches, against the stage records "
                           f"{disp}")
    bitwise = 0
    for a, b in zip(want, results, strict=True):
        assert_same_up_to_exact_ties((a.pids, a.scores), (b.pids, b.scores),
                                     what=f"{label} qid {b.qid}")
        bitwise += bool(np.array_equal(a.pids, b.pids) and np.array_equal(
            np.asarray(a.scores).view(np.uint32),
            np.asarray(b.scores).view(np.uint32)))
    in_delta = sum(int((r.pids >= s.n_docs).any()) for r in results)
    line.update(shards=4, state="dirty", method="colbert",
                cap=plaid.candidate_cap, stage_dispatches=disp,
                delta_launches=delta.calls, answers_with_delta=in_delta,
                bitwise=bitwise)
    log(f"{label}: {line['qps']:.1f} QPS, p50 {line['p50_ms']:.1f} ms; "
        f"stage walls {line['stage_wall_s']}; launches {launches} "
        f"({delta.calls} for the delta); {in_delta} of {len(reqs)} answers "
        f"hold a delta doc; equal to the unsharded live engine, ids up to "
        f"exact-score ties ({bitwise} bit for bit)")
    return line


def sharded_live_serve(rng, s: Shapes, path: pathlib.Path,
                       topics: np.ndarray, groups: dict, device,
                       counted: dict, peaks) -> tuple:
    """4j (b): phase 3's index at 1, 2 and 4 shards, live, the SPLADE
    methods through ``RetrievalServer`` at max_batch=32 with the device
    stage 1 in the turns of ``SHARD_ORDER``, clean and then after
    ``LIVE_UPSERTS`` upserts and the deletes of ``SHARDED_LIVE_DELETES``:
    every answer equal to the unsharded card live engine fed the same
    trace bit for bit; that run's widest delta launch replayed and timed
    (:func:`delta_kernel`); then colbert on a dirty 4-shard group
    (:func:`sharded_live_colbert`). → (figures, the first dirty 4-shard
    run's launches, the live groups, the requests)."""
    from repro_torch.serving.engine import ServeEngine
    reqs = make_requests(rng, s, topics, s.n_requests, qid0=90_000)
    warm = make_requests(rng, s, topics, 6, qid0=91_000)
    chunks = [reqs[lo:lo + s.B] for lo in range(0, len(reqs), s.B)]
    ref = make_retriever(path, device)
    retrs = {n: shard_retriever(path, groups, n, device, plaid_params(s))
             for n in SHARD_COUNTS}
    for r in (ref, *retrs.values()):
        r.enable_live()
    ref_engine = ServeEngine(ref, splade_backend="device")
    docs = unit_docs(rng, s, topics, LIVE_UPSERTS)
    bounds = groups[4][1]
    per_shard, in_delta = SHARDED_LIVE_DELETES
    dels = np.concatenate(
        [rng.choice(np.arange(lo, hi), per_shard, replace=False)
         for lo, hi in zip(bounds[:-1], bounds[1:])]
        + [s.n_docs + rng.choice(LIVE_UPSERTS, in_delta, replace=False)])
    out = {"requests": len(reqs), "max_batch": s.B,
           "upserts": LIVE_UPSERTS, "deletes": dels.tolist(), "runs": []}
    launches = None
    for state in ("clean", "dirty"):
        if state == "dirty":
            for r in (ref, *retrs.values()):
                for i, (emb, tids, tw) in enumerate(docs):
                    if r.live_upsert(emb, tids, tw) != s.n_docs + i:
                        raise AssertionError("an upsert got another pid")
                for g in dels.tolist():
                    if not r.live_delete(g):
                        raise AssertionError(f"delete {g} refused")
            out["views"] = [len(sh.live.tombstones)
                            for sh in retrs[4].shards]
        want = [x for c in chunks
                for x in ref_engine.process_batch(fresh(c))]
        for n_shards in SHARD_ORDER:
            retr = retrs[n_shards]
            label = f"sharded live S={n_shards} {state}"
            engine = ServeEngine(retr, splade_backend="device")
            if engine.pipelined:
                raise AssertionError(f"{label}: a live engine pipelines")
            with DeltaLaunches() as delta:
                results, line = serve_run(
                    engine, warm, fresh(reqs), s.B, counted,
                    on_start=lambda d=delta: setattr(d, "calls", 0))
            disp = stage_dispatches(retr)
            if state == "clean":
                check_shard_launches(label, n_shards, "device",
                                     line["launches"], disp)
            else:
                check_live_launches(label, n_shards, line["launches"], disp,
                                    delta.calls)
                if n_shards == 4 and launches is None:
                    launches = line["launches"]
                    out["delta_kernel"] = dict(
                        delta_kernel(delta.widest, s, peaks),
                        launches=delta.calls)
            same_bits(want, results, label)
            line.update(shards=n_shards, state=state, stage_dispatches=disp,
                        delta_launches=delta.calls)
            out["runs"].append(line)
            log(f"{label}: {line['qps']:.1f} QPS, p50 {line['p50_ms']:.1f} "
                f"ms, p99 {line['p99_ms']:.1f} ms; stage walls "
                f"{line['stage_wall_s']}; launches {line['launches']} "
                f"({delta.calls} for the delta); equal to the unsharded "
                "live engine bit for bit")
    log(f"sharded live S=4 dirty, the delta's decompress_maxsim at "
        f"(B, C) = ({out['delta_kernel']['B']}, "
        f"{out['delta_kernel']['C']}), {out['delta_kernel']['real']} real "
        f"candidates, held to plain: {out['delta_kernel']}")
    out["colbert"] = sharded_live_colbert(rng, s, path, groups, device,
                                          counted, docs, dels)
    return out, launches, retrs, reqs


def sharded_live_compaction(rng, s: Shapes, path: pathlib.Path,
                            topics: np.ndarray, retrs: dict, reqs,
                            device) -> dict:
    """4j (c): the 4-shard group compacts under ``LIVE_READERS`` reader
    threads (every answer unchanged), takes ``LIVE_MORE`` more upserts
    and compacts alone: the device memory after each equal (less the
    padded IVF); then the one-shard group compacts under the readers,
    the steps of a compaction that rewrites the whole pool."""
    sp = [r for r in reqs if r.method != "colbert"][:s.B]
    batch = {"method": [r.method for r in sp],
             "q_embs": [r.q_emb for r in sp],
             "term_ids": [r.term_ids for r in sp],
             "term_weights": [r.term_weights for r in sp],
             "alpha": [r.alpha for r in sp], "k": 100}
    four = retrs[4]
    out = {"S4": [compact_measured(four, batch, device, LIVE_READERS)]}
    for emb, tids, tw in unit_docs(rng, s, topics, LIVE_MORE):
        four.live_upsert(emb, tids, tw)
    out["S4"].append(compact_measured(four, batch, device, 0))
    mem = [c["memory_less_ivf"] for c in out["S4"]]
    if mem[0] != mem[1]:
        raise AssertionError(f"device memory moved across the 4-shard "
                             f"group's compactions: {out['S4']}")
    out["S1"] = compact_measured(retrs[1], batch, device, LIVE_READERS)
    for c in path.glob("*.g*"):
        shutil.rmtree(c)
    log(f"sharded live (c): 4 shards compacted under {LIVE_READERS} readers "
        f"and alone, every answer unchanged, memory flat: {out['S4']}; one "
        f"shard: {out['S1']}")
    return out


def sharded_live_phase(rng, s: Shapes, path: pathlib.Path,
                       topics: np.ndarray, replay: dict, device,
                       peaks) -> tuple:
    """Phase 4j (see the module docstring). → (the ``sharded_live``
    line's figures, the launches of (b)'s first dirty run at 4
    shards)."""
    from repro_torch.index.sharding import load_group, split_index_tree
    counted = counted_kernels()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_live_") \
            as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        out["parity"] = sharded_live_parity(replay, path / "live" / "base",
                                            tmp / "parity", device, counted)
        out["parity_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        groups = {n: load_group(split_index_tree(path, n,
                                                 group_dir=tmp / f"S{n}"))
                  for n in SHARD_COUNTS[1:]}
        out["split_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["serve"], launches, retrs, reqs = sharded_live_serve(
            rng, s, path, topics, groups, device, counted, peaks)
        out["serve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["compaction"] = sharded_live_compaction(rng, s, path, topics,
                                                    retrs, reqs, device)
        out["compaction_s"] = time.perf_counter() - t0
        del retrs
    return out, launches


# ---------------------------------------------------------------------------
# phase 4k: the shard transport
# ---------------------------------------------------------------------------

TRANSPORT_REPS = 20       # round trips timed per message kind and codec
TRANSPORT_BURST = 64      # frames sent back to back before any is read
# one frame of the JAX client's shared-memory arena size
# (src/repro/serving/transport/client.py:50, DEFAULT_ARENA_BYTES)
TRANSPORT_BIG = 64 << 20
TRANSPORT_WAIT = 120      # seconds: the bound on every send and receive


class CountingSocket:
    """A stream socket whose ``sendmsg`` calls are counted: a frame that
    took more than one call went out in parts (partial writes)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.sendmsg_calls = 0

    def sendmsg(self, bufs):
        self.sendmsg_calls += 1
        return self.sock.sendmsg(bufs)

    def fileno(self) -> int:
        return self.sock.fileno()

    def close(self) -> None:
        self.sock.close()


class Receiver:
    """A reader thread: pumps ``channel`` and queues each decoded message
    with the ``perf_counter`` instant it was decoded; a failure of the
    channel is queued too and raised by :meth:`get`."""

    def __init__(self, channel):
        self.channel = channel
        self.got = queue.Queue()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.run, name="transport-rx",
                                       daemon=True)
        self.thread.start()

    def run(self) -> None:
        try:
            while not self.stop.is_set():
                msg = self.channel.pump(0.2)
                if msg is not None:
                    self.got.put((time.perf_counter(), msg))
        except BaseException as e:       # handed to the caller of get()
            self.got.put((None, e))

    def get(self) -> tuple:
        t, msg = self.got.get(timeout=TRANSPORT_WAIT)
        if t is None:
            raise msg
        return t, msg

    def close(self) -> None:
        self.stop.set()
        self.thread.join(TRANSPORT_WAIT)
        if self.thread.is_alive():
            raise RuntimeError("transport: the reader thread did not stop")


@contextlib.contextmanager
def transport_codec(name: str):
    """Encode with ``name`` (``msgpack`` or ``fallback``) while in use:
    the port's codec takes msgpack whenever the host has it, so on such
    a host the fallback is held by hiding msgpack from the encoder."""
    from repro_torch.serving.transport import codec
    saved = codec.HAVE_MSGPACK
    codec.HAVE_MSGPACK = name == "msgpack"
    try:
        yield
    finally:
        codec.HAVE_MSGPACK = saved


def host_codecs() -> tuple:
    from repro_torch.serving.transport import HAVE_MSGPACK
    return ("msgpack", "fallback") if HAVE_MSGPACK else ("fallback",)


def same_message(sent, got, what: str) -> None:
    """``got`` is ``sent`` as it crossed: the same dict keys and list
    lengths, every array of the same dtype, shape and bytes (and
    writable: a copy of its own, not a view of the receive buffer),
    every float of the same bits, every other value equal."""
    if isinstance(sent, np.ndarray):
        if not (isinstance(got, np.ndarray) and got.dtype == sent.dtype
                and got.shape == sent.shape
                and got.tobytes() == sent.tobytes()
                and got.flags.writeable):
            raise AssertionError(f"transport: {what}: an array differs")
    elif isinstance(sent, dict):
        if not isinstance(got, dict) or list(got) != list(sent):
            raise AssertionError(f"transport: {what}: keys differ")
        for key in sent:
            same_message(sent[key], got[key], f"{what}.{key}")
    elif isinstance(sent, (list, tuple)):
        if not isinstance(got, list) or len(got) != len(sent):
            raise AssertionError(f"transport: {what}: a list differs")
        for i, (x, y) in enumerate(zip(sent, got)):
            same_message(x, y, f"{what}[{i}]")
    elif isinstance(sent, float):
        if not (isinstance(got, float)
                and struct.pack(">d", sent) == struct.pack(">d", got)):
            raise AssertionError(f"transport: {what}: {sent!r} != {got!r}")
    elif sent != got:
        raise AssertionError(f"transport: {what}: {sent!r} != {got!r}")


def message_arrays(msg) -> list:
    """The message's arrays, in the order the codecs walk it."""
    if isinstance(msg, np.ndarray):
        return [msg]
    if isinstance(msg, dict):
        msg = list(msg.values())
    if isinstance(msg, (list, tuple)):
        return [a for x in msg for a in message_arrays(x)]
    return []


def segment_bytes(msg, min_bytes: int = 64) -> int:
    """The bytes of the message's arrays of ``min_bytes`` or more: what a
    ``SegmentSink`` takes out of the control message and copies."""
    return sum(a.nbytes for a in message_arrays(msg)
               if a.nbytes >= min_bytes)


def transport_roundtrips(messages: dict, big_bytes: int = TRANSPORT_BIG,
                         burst: int = TRANSPORT_BURST,
                         reps: int = TRANSPORT_REPS, seed: int = 0) -> dict:
    """Phase 4k's round trips, with every codec the host has: each of
    ``messages`` (kind → message) ``reps`` times through a pair of the
    port's ``StreamChannel`` over a socketpair, a reader thread decoding
    on the far end (ms from the send's start to the decode's end: encode,
    send, receive, decode); ``burst`` frames sent back to back and read
    after, in FIFO order; one frame of ``big_bytes``. The sending socket
    has a timeout (``TRANSPORT_WAIT``), so the kernel takes a frame
    larger than the socket's buffer in parts: the big frame must take
    more than one ``sendmsg`` call. Every message must arrive bit for
    bit; the sender's ``bytes_copied`` must equal the bytes of the
    arrays of 64 bytes or more that it sent, ``bytes_zero_copy`` 0, and
    the receiver must have read every byte sent."""
    from repro_torch.serving.transport import HAVE_MSGPACK, StreamChannel
    rng = np.random.default_rng(seed)
    big = {"ok": True, "result": {
        "blob": rng.integers(0, 256, big_bytes, dtype=np.uint8)}}
    kinds = list(messages)
    out = {"have_msgpack": HAVE_MSGPACK, "codecs": {}}
    for name in host_codecs():
        a, b = socket.socketpair()
        a.settimeout(TRANSPORT_WAIT)
        counting = CountingSocket(a)
        tx, rx = StreamChannel(counting), StreamChannel(b)
        reader = Receiver(rx)
        fig = {"messages": {}}
        tensor = 0
        try:
            with transport_codec(name):
                for kind, msg in messages.items():
                    ms = []
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        frame = tx.send(msg)
                        t1, got = reader.get()
                        ms.append((t1 - t0) * 1e3)
                        same_message(msg, got, f"{name} {kind}")
                        tensor += segment_bytes(msg)
                    fig["messages"][kind] = {
                        "ms_median": float(np.median(ms)), "ms_min": min(ms),
                        "ms_max": max(ms), "frame_bytes": frame,
                        "tensor_bytes": segment_bytes(msg, 0)}
                sent = [{"seq": i, **messages[kinds[i % len(kinds)]]}
                        for i in range(burst)]
                t0 = time.perf_counter()
                for msg in sent:
                    tx.send(msg)
                    tensor += segment_bytes(msg)
                got = [reader.get() for _ in range(burst)]
                seqs = [g["seq"] for _, g in got]
                if seqs != list(range(burst)):
                    raise AssertionError(f"transport: {name} burst out of "
                                         f"order: {seqs}")
                for msg, (_, g) in zip(sent, got):
                    same_message(msg, g, f"{name} burst {msg['seq']}")
                fig["burst"] = {"frames": burst, "fifo": True,
                                "ms": (got[-1][0] - t0) * 1e3}
                calls = counting.sendmsg_calls
                t0 = time.perf_counter()
                frame = tx.send(big)
                t1, g = reader.get()
                calls = counting.sendmsg_calls - calls
                same_message(big, g, f"{name} big frame")
                del g
                tensor += segment_bytes(big)
                if calls < 2:
                    raise AssertionError(f"transport: {name} big frame went "
                                         f"out in {calls} sendmsg call")
                fig["big"] = {"bytes": big_bytes, "frame_bytes": frame,
                              "ms": (t1 - t0) * 1e3,
                              "mb_per_s": big_bytes / 1e6 / (t1 - t0),
                              "sendmsg_calls": calls}
        finally:
            reader.close()
            tx.close()
            rx.close()
        fig["sender"], received = tx.stats(), rx.stats()
        fig["tensor_bytes_64_or_more"] = tensor
        if (fig["sender"]["bytes_copied"] != tensor
                or fig["sender"]["bytes_zero_copy"] != 0
                or received["bytes_recv"] != fig["sender"]["bytes_sent"]):
            raise AssertionError(f"transport: {name} counters "
                                 f"{fig['sender']}, receiver {received}, "
                                 f"tensor bytes {tensor}")
        out["codecs"][name] = fig
        log(f"transport ({name}): "
            + ", ".join(f"{k} {v['ms_median']:.3f} ms"
                        for k, v in fig["messages"].items())
            + f"; burst of {burst} in {fig['burst']['ms']:.1f} ms; "
            f"{big_bytes >> 20} MiB in {fig['big']['ms']:.1f} ms "
            f"({fig['big']['mb_per_s']:.0f} MB/s, "
            f"{fig['big']['sendmsg_calls']} sendmsg calls)")
    return out


def stage_states(retr, method: str, **inputs) -> dict:
    """One batch through ``retr``'s plan of ``method``, stage by stage:
    stage name → the batch after that stage."""
    cb = retr.build_batch(method, **inputs)
    plan = retr.compile_plan(method)
    out = {}
    for stage in plan.stages:
        cb = plan.run_stage(stage, cb)
        out[stage.name] = cb
    return out


def transport_messages(rng, s: Shapes, path: pathlib.Path,
                       topics: np.ndarray, device) -> dict:
    """What shard 0's process worker of phase 4i's 4-shard group (phase
    3's index split anew: the same bytes) would send for one served
    batch of ``s.B`` requests, in the JAX worker's message shapes
    (src/repro/serving/worker.py:121-170, replies wrapped as
    ``{"ok": True, "result": ...}``): its stage-1 ``pids`` and
    ``scores`` (rerank, device stage 1), the ``score_tokens`` request
    the coordinator sends it (its residual selection and the batch's
    query embeddings and mask), colbert's candidates and approximate
    scores, and colbert's exact scores."""
    from repro_torch.index.sharding import load_group, split_index_tree
    reqs = make_requests(rng, s, topics, s.B)
    q_colbert = [r.q_emb for r in colbert_requests(rng, s, s.B)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_transport_") as tmp:
        group = split_index_tree(path, 4,
                                 group_dir=pathlib.Path(tmp) / "S4")
        retr = shard_retriever(path, {4: load_group(group)}, 4, device,
                               plaid_params(s))
        retr.set_splade_backend("device")
        rerank = stage_states(retr, "rerank",
                              q_embs=[r.q_emb for r in reqs],
                              term_ids=[r.term_ids for r in reqs],
                              term_weights=[r.term_weights for r in reqs])
        colbert = stage_states(retr, "colbert", q_embs=q_colbert)
        del retr
    stage1 = rerank["splade_stage1"].shard_states[0]
    merged = rerank["merge_topk:stage1"].state
    approx = colbert["device_score:approx"].shard_states[0]

    def reply(**result):
        return {"ok": True, "result": result}

    return {
        "splade": reply(pids=stage1["pids"], scores=stage1["scores"]),
        "score_tokens": {"op": "score_tokens", "payload": {
            "sel": rerank["host_gather:residuals"].shard_states[0]["sel"],
            "q": merged["q"], "q_valid": merged["q_valid"]}},
        "colbert_candidates": reply(
            cand=approx["cand_np"], approx=approx["approx_np"],
            n_real=(approx["cand_np"] >= 0).sum(axis=1)),
        "colbert_exact": reply(
            scores=colbert["device_score:exact"].shard_states[0]["exact"]),
    }


def transport_phase(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
                    device) -> dict:
    """Phase 4k (see the module docstring). → the ``transport`` line's
    figures."""
    from repro_torch.serving.transport import HAVE_MSGPACK
    log(f"transport: HAVE_MSGPACK {HAVE_MSGPACK}, codecs {host_codecs()}")
    messages = transport_messages(rng, s, path, topics, device)
    out = transport_roundtrips(messages)
    out["shapes"] = {kind: {k: [str(v.dtype), list(v.shape)]
                            for k, v in (msg.get("result")
                                         or msg["payload"]).items()}
                     for kind, msg in messages.items()}
    return out


# ---------------------------------------------------------------------------
# phase 4l: the shard workers
# ---------------------------------------------------------------------------

WORKER_SHARDS = 4
# (method, stage-1 backend) of the batches whose shard stages are sent
WORKER_RUNS = (("splade", "host"), ("rerank", "host"), ("hybrid", "host"),
               ("splade", "device"), ("rerank", "device"),
               ("hybrid", "device"), ("colbert", None))
WORKER_DRAIN = 32         # colbert_exact ops in the frame a SIGTERM drains
WORKER_WAIT = 300         # seconds: the bound on every spawn, reply and exit


def worker_ops(retr, method: str, backend, **inputs) -> list:
    """What an in-process group's shard stages take and give for one
    batch of ``method`` (stage 1 on ``backend``), as the ops a worker of
    each shard would get: ``retr``'s plan runs stage by stage and each
    shard's inputs become the JAX coordinator's payloads
    (src/repro/core/sharded.py:1767-1929; for colbert, the group's probe
    copied to the host). → per shard, a list of dicts: ``op``,
    ``payload``, ``local`` (the same inputs as the in-process stage holds
    them: the probe's device tensors for colbert), ``want`` (the reply
    that the shard's state after its stage makes) and ``offset`` (what
    the reply's ``pids`` take to be global, or None)."""
    if backend is not None:
        retr.set_splade_backend(backend)
    n = len(inputs.get("q_embs") or inputs["term_ids"])
    st = stage_states(retr, method, alphas=retr._alpha_array(None, n),
                      **inputs)

    def op(name, payload, want, local=None, offset=None):
        return {"op": name, "payload": payload, "want": want,
                "local": payload if local is None else local,
                "offset": offset}

    out = []
    for i in range(retr.n_shards):
        sel = st["host_gather:residuals"].shard_states[i]["sel"] \
            if "host_gather:residuals" in st else None
        if method == "colbert":
            probe = st["plaid_probe"].state
            cand = ("scores_c", "cids", "q_valid")
            a = st["device_score:approx"].shard_states[i]
            out.append([
                op("colbert_candidates",
                   {k: probe[k].cpu().numpy() for k in cand},
                   {"cand": a["cand_np"], "approx": a["approx_np"],
                    "n_real": (a["cand_np"] >= 0).sum(axis=1)},
                   local={k: probe[k] for k in cand}),
                op("colbert_exact",
                   {"q": probe["q"].cpu().numpy(),
                    "q_valid": probe["q_valid"].cpu().numpy(), "sel": sel},
                   {"scores": st["device_score:exact"].shard_states[i]
                    ["exact"]},
                   local={"q": probe["q"], "q_valid": probe["q_valid"],
                          "sel": sel})])
            continue
        s1 = st["splade_stage1"].shard_states[i]
        ops = [op("splade", {"term_ids": list(inputs["term_ids"]),
                             "term_weights": list(inputs["term_weights"]),
                             "k": retr.params.first_k, "backend": backend},
                  {"pids": s1["pids"], "scores": s1["scores"]},
                  offset=int(retr.offsets[i]))]
        if method != "splade":
            merged = st["merge_topk:stage1"].state
            (c,) = st["device_score:maxsim"].shard_states[i]["c"].wait()
            ops.append(op("score_tokens", {"q": merged["q"],
                                           "q_valid": merged["q_valid"],
                                           "sel": sel}, {"scores": c}))
        out.append(ops)
    return out


def hold_worker_reply(what: str, got: dict, want: dict, offset) -> None:
    """``got`` (a worker's reply) is ``want`` bit for bit: the same keys
    in order and every array of the same dtype, shape and bytes; a
    shard-local ``pids`` is made global with ``offset`` first, as the
    coordinator does."""
    if offset is not None:
        got = dict(got, pids=np.where(got["pids"] >= 0,
                                      got["pids"] + offset, -1))
    if list(got) != list(want):
        raise AssertionError(f"workers: {what}: keys {list(got)} != "
                             f"{list(want)}")
    for key, w in want.items():
        g = got[key]
        if not (isinstance(g, np.ndarray) and g.dtype == w.dtype
                and g.shape == w.shape and g.tobytes() == w.tobytes()):
            raise AssertionError(f"workers: {what}: {key} differs")


def worker_parity(clients, retr, batches: dict) -> dict:
    """Phase 4l's parity: for each of ``WORKER_RUNS`` (``batches``:
    method → its inputs), every shard's stage inputs sent to that
    shard's worker (``clients``, in shard order) once as single ops and
    once as one ``multi`` frame, every reply held bit for bit to the
    in-process group's (``retr``) shard state. Each op is then sent once
    more and timed (ms a round trip, request and reply
    bytes) beside the worker's own op body run in this process on the
    group's shard with the stage's own inputs (``serving.worker._handle``
    on ``local``: the in-process stage's wall; its reply held too). →
    {run: {op: figures in shard order}}."""
    from repro_torch.serving.worker import _handle, _WorkerState
    out = {}
    for method, backend in WORKER_RUNS:
        run = method if backend is None else f"{method}/{backend}"
        ops = worker_ops(retr, method, backend, **batches[method])
        for i, cli in enumerate(clients):
            for o in ops[i]:
                hold_worker_reply(f"{run} {o['op']} shard {i}",
                                  cli.call(o["op"], o["payload"],
                                           timeout=WORKER_WAIT),
                                  o["want"], o["offset"])
            got = cli.call("multi", {"ops": [
                {"op": o["op"], "payload": o["payload"]} for o in ops[i]]},
                timeout=WORKER_WAIT)["replies"]
            if len(got) != len(ops[i]) or not all(r["ok"] for r in got):
                raise AssertionError(f"workers: {run} multi shard {i}: "
                                     f"{[r.get('error') for r in got]}")
            for r, o in zip(got, ops[i]):
                hold_worker_reply(f"{run} multi {o['op']} shard {i}",
                                  r["result"], o["want"], o["offset"])
        figs = out[run] = {}
        for i, cli in enumerate(clients):
            state = _WorkerState(retr.shards[i], i)
            for o in ops[i]:
                sent, recv = cli.bytes_sent, cli.bytes_recv
                t0 = time.perf_counter()
                got = cli.call(o["op"], o["payload"], timeout=WORKER_WAIT)
                worker_ms = (time.perf_counter() - t0) * 1e3
                hold_worker_reply(f"{run} {o['op']} shard {i} timed", got,
                                  o["want"], o["offset"])
                t0 = time.perf_counter()
                local = _handle(state, o["op"], o["local"])
                local_ms = (time.perf_counter() - t0) * 1e3
                hold_worker_reply(f"{run} {o['op']} shard {i} in process",
                                  local, o["want"], o["offset"])
                f = figs.setdefault(o["op"], {
                    "worker_ms": [], "in_process_ms": [],
                    "request_bytes": [], "reply_bytes": []})
                f["worker_ms"].append(worker_ms)
                f["in_process_ms"].append(local_ms)
                f["request_bytes"].append(cli.bytes_sent - sent)
                f["reply_bytes"].append(cli.bytes_recv - recv)
        log(f"workers: {run}: " + ", ".join(
            f"{op} {np.median(f['worker_ms']):.2f} ms a round trip "
            f"against {np.median(f['in_process_ms']):.2f} in process, "
            f"{max(f['request_bytes'])} B out"
            for op, f in figs.items()))
    return out


def device_used(device) -> int:
    """Bytes in use on the whole card (every process's), from
    ``cudaMemGetInfo``."""
    import torch
    free, total = torch.cuda.mem_get_info(device)
    return total - free


def compute_apps() -> list:
    """The card's compute processes as ``nvidia-smi`` lists them, one
    line each. In a container whose pids the GPU driver does not see,
    every process shows as pid 1 with the card's total memory, so a line
    is matched to no pid: the count of lines is what says how many
    processes hold a context."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return [line for line in out.stdout.splitlines() if line.strip()]


def released_bytes(device, before: int, settle_s: float = 10.0) -> int:
    """The device bytes released since ``before`` (``device_used``) once
    the count stops falling: a reaped process's context is freed by the
    driver a moment after the exit."""
    last, t_end = before, time.monotonic() + settle_s
    while time.monotonic() < t_end:
        time.sleep(0.2)
        now = device_used(device)
        if now == last and now < before:
            break
        last = now
    return before - last


def spawn_workers(dirs, plaid: dict, ms: dict, device) -> tuple:
    """One port worker a shard directory, all spawned at once on
    ``device`` over the socket channel. → (the clients in shard order,
    each one's seconds from spawn to its first ping). A failed spawn
    terminates every worker and raises."""
    from repro_torch.serving.transport import ShardWorkerClient
    clients = [ShardWorkerClient(i, d, plaid_params=plaid, ms_params=ms,
                                 transport="socket", device=str(device),
                                 spawn_timeout_s=WORKER_WAIT,
                                 call_timeout_s=WORKER_WAIT)
               for i, d in enumerate(dirs)]
    seconds = [None] * len(clients)
    failed = []

    def start(i):
        t0 = time.perf_counter()
        try:
            clients[i].spawn()
        except BaseException as e:     # re-raised below, after the reap
            failed.append(e)
            return
        seconds[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=start, args=(i,), name=f"spawn-{i}")
               for i in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WORKER_WAIT + 60)
    if failed or any(t.is_alive() for t in threads):
        for cli in clients:
            cli.terminate()
        raise RuntimeError(f"workers: spawn failed: {failed}")
    return clients, seconds


def worker_lifecycle(clients, drain_op: dict, device) -> dict:
    """Phase 4l's lifecycle on four workers: SIGTERM the last one 100 ms
    after a ``multi`` frame of ``WORKER_DRAIN`` copies of ``drain_op``
    (one of ``worker_ops``'s, for the last shard) has been sent whole
    (its reply arrives bit for bit, the worker exits 0); SIGKILL the one
    before it with the same frame pending (``ShardWorkerDied`` arrives);
    ``terminate`` the rest (exit 0). After each exit the device bytes it
    released. → the figures; the caller checks the process list."""
    from repro_torch.serving.transport import ShardWorkerDied
    op, want = drain_op["op"], drain_op["want"]
    frame = {"ops": [{"op": op, "payload": drain_op["payload"]}]
             * WORKER_DRAIN}
    out = {"released_bytes": {}}
    pids = [c.pid for c in clients]
    term, kill = clients[-1], clients[-2]

    used = device_used(device)
    rep = term.call_async("multi", frame)
    t0 = time.perf_counter()
    time.sleep(0.1)
    os.kill(term.pid, signal.SIGTERM)
    got = term.wait(rep, timeout=WORKER_WAIT)["replies"]
    reply_s = time.perf_counter() - t0
    if len(got) != WORKER_DRAIN or not all(r["ok"] for r in got):
        raise AssertionError("workers: the drained frame failed")
    for j, r in enumerate(got):
        hold_worker_reply(f"drain {op} {j}", r["result"], want, None)
    code = term.proc.wait(timeout=WORKER_WAIT)
    if code != 0:
        raise AssertionError(f"workers: SIGTERM exit code {code}")
    out["sigterm"] = {"exit_code": code, "reply_s": reply_s,
                      "exit_s": time.perf_counter() - t0}
    out["released_bytes"][term.shard_index] = released_bytes(device, used)
    term.terminate()

    used = device_used(device)
    rep = kill.call_async("multi", frame)
    t0 = time.perf_counter()
    os.kill(kill.pid, signal.SIGKILL)
    try:
        kill.wait(rep, timeout=WORKER_WAIT)
    except ShardWorkerDied as e:
        died_ms = (time.perf_counter() - t0) * 1e3
        why = str(e)
    else:
        raise AssertionError("workers: a SIGKILLed worker answered")
    code = kill.terminate()
    if code != -signal.SIGKILL or kill.alive():
        raise AssertionError(f"workers: SIGKILL exit code {code}")
    out["sigkill"] = {"exit_code": code, "died_ms": died_ms, "error": why}
    out["released_bytes"][kill.shard_index] = released_bytes(device, used)

    codes = {}
    for cli in clients[:-2]:
        used = device_used(device)
        codes[cli.shard_index] = cli.terminate()
        out["released_bytes"][cli.shard_index] = released_bytes(device, used)
    if any(c != 0 for c in codes.values()):
        raise AssertionError(f"workers: terminate exit codes {codes}")
    out["terminate_exit_codes"] = codes
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        raise AssertionError(f"workers: pid {pid} is still alive")
    return out


def workers_phase(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
                  device) -> dict:
    """Phase 4l (see the module docstring). → the ``workers`` line's
    figures."""
    import torch
    from repro_torch.index.sharding import load_group, split_index_tree
    reqs = make_requests(rng, s, topics, s.B)
    splade_in = dict(q_embs=[r.q_emb for r in reqs],
                     term_ids=[r.term_ids for r in reqs],
                     term_weights=[r.term_weights for r in reqs])
    batches = {m: splade_in for m in ("splade", "rerank", "hybrid")}
    batches["colbert"] = dict(
        q_embs=[r.q_emb for r in colbert_requests(rng, s, s.B)])
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_workers_") as tmp:
        dirs, bounds = load_group(split_index_tree(
            path, WORKER_SHARDS, group_dir=pathlib.Path(tmp) / "S4"))
        retr = shard_retriever(path, {WORKER_SHARDS: (dirs, bounds)},
                               WORKER_SHARDS, device, plaid_params(s))
        plaid = dataclasses.asdict(retr.shards[0].searcher.params)
        ms = dataclasses.asdict(retr.params)
        apps = len(compute_apps())
        used = device_used(device)
        t0 = time.perf_counter()
        clients, seconds = spawn_workers(dirs, plaid, ms, device)
        out["spawn"] = {"wall_s": time.perf_counter() - t0,
                        "seconds": seconds}
        try:
            listed = len(compute_apps())
            out["spawn"]["device_bytes"] = device_used(device) - used
            out["spawn"]["compute_apps"] = {"before": apps, "up": listed}
            if listed != apps + len(clients):
                raise AssertionError(f"workers: nvidia-smi lists {listed} "
                                     f"processes, {apps} before the spawn")
            out["warm_ms"] = []
            for c in clients:
                t0 = time.perf_counter()
                c.call("warm", {"backend": "device"}, timeout=WORKER_WAIT)
                out["warm_ms"].append((time.perf_counter() - t0) * 1e3)
            # nvidia-smi's lines name no pid here, so each worker also
            # shows itself on the card: its own context and allocations
            # (and on a CPU rehearsal neither)
            out["health"] = [c.call("health", {}, timeout=WORKER_WAIT)
                             for c in clients]
            on_card = torch.device(device).type == "cuda"
            for c, h in zip(clients, out["health"]):
                if (h["pid"] != c.pid or h["device"] != str(device)
                        or h["cuda_initialized"] != on_card
                        or (h["device_allocated_bytes"] > 0) != on_card):
                    raise AssertionError(f"workers: worker {c.shard_index} "
                                         f"is not on the card: {h}")
            t0 = time.perf_counter()
            out["ops"] = worker_parity(clients, retr, batches)
            out["parity_s"] = time.perf_counter() - t0
            out["transport"] = [c.transport_stats() for c in clients]
            exact = worker_ops(retr, "colbert", None,
                               **batches["colbert"])[-1][1]
            out["lifecycle"] = worker_lifecycle(clients, exact, device)
        finally:
            for c in clients:
                c.terminate()
        out["compute_apps_after"] = len(compute_apps())
        if out["compute_apps_after"] != apps:
            raise AssertionError(f"workers: nvidia-smi lists "
                                 f"{out['compute_apps_after']} processes "
                                 f"after the exits, {apps} before")
        del retr
    out["bounds"] = bounds.tolist()
    log(f"workers: spawned in {out['spawn']['seconds']} s, "
        f"{out['spawn']['device_bytes']} device bytes for "
        f"{WORKER_SHARDS}; released at exit "
        f"{out['lifecycle']['released_bytes']}; SIGKILL seen in "
        f"{out['lifecycle']['sigkill']['died_ms']:.1f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 3b: the index build on the card
# ---------------------------------------------------------------------------

# the serve config's widths (src/repro/configs/colbert_serve.py:26-34:
# d=128, doc_maxlen=180, query_maxlen=32) and BERT's vocabulary; 10,000
# docs of the synthetic generator (mean length 96) are ~0.96 M tokens
BUILD_CORPUS = dict(n_docs=10_000, n_queries=256, dim=128, doc_maxlen=180,
                    query_maxlen=32, vocab=30522)
# the benchmarks' in-domain profile (benchmarks/common.py:26), built as
# they build it (benchmarks/common.py:43-46: nbits=4, 6 iterations) and
# served at their parameters
QUALITY_CORPUS = dict(n_docs=4000, n_queries=300, n_topics=96, seed=11)
QUALITY_ITERS = 6
PINNED_DOCS = 300
BUILD_REQUESTS = 64
INDEX_FILES = ("residuals.bin", "codes.bin", "meta.json", "centroids.npy",
               "bucket_cutoffs.npy", "bucket_weights.npy", "doclens.npy",
               "doc_offsets.npy", "ivf_pids.bin", "ivf_offsets.npy")
# the files that follow from the tokens' centroid ids
CID_FILES = ("codes.bin", "residuals.bin", "ivf_pids.bin", "ivf_offsets.npy")


class BuildSteps:
    """While in use, marks a free build's steps with CUDA events at the
    call and the return of ``kmeans.train_kmeans``, ``assign`` and
    ``update``, ``residual.fit_codec`` and ``encode_residuals`` and
    ``builder.write_index``, each after a synchronise, so that the host's
    steps and the card's read alike as wall time on the card's clock."""

    WRAPPED = (("kmeans", "train_kmeans"), ("kmeans", "assign"),
               ("kmeans", "update"), ("residual", "fit_codec"),
               ("residual", "encode_residuals"), ("builder", "write_index"))

    def __init__(self):
        self.marks = []

    def mark(self, label: str) -> None:
        import torch
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((label, ev))

    def _wrapped(self, name: str, fn):
        def call(*a, **kw):
            self.mark(name + ">")
            out = fn(*a, **kw)
            self.mark(name + "<")
            return out
        return call

    def __enter__(self):
        from repro_torch.index import builder, kmeans, residual
        mods = {"kmeans": kmeans, "residual": residual, "builder": builder}
        self.saved = [(mods[m], n, getattr(mods[m], n))
                      for m, n in self.WRAPPED]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrapped(name, fn))
        self.mark("build>")
        return self

    def __exit__(self, *exc):
        self.mark("build<")
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def steps(self) -> dict:
        """→ ms of each step: the flatten, the sample and their copies to
        the card; the initial draw; each Lloyd iteration (assign +
        update on the sample); assigning every token; assigning the
        sample for the fit; the fit; the encode; the copy of the codes
        to the host; the write; the whole build."""
        labels = [lb for lb, _ in self.marks]
        ev = [e for _, e in self.marks]

        def ms(a: int, b: int) -> float:
            return ev[a].elapsed_time(ev[b])

        t0, t1 = labels.index("train_kmeans>"), labels.index("train_kmeans<")
        lloyd, j = [], labels.index("assign>", t0)
        out = {"sample_ms": ms(0, t0), "init_ms": ms(t0, j)}
        while j < t1:
            end = labels.index("update<", j)
            lloyd.append(ms(j, end))
            j = end + 1
        out["lloyd_ms"] = lloyd
        a = labels.index("assign>", t1)
        b = labels.index("assign>", a + 1)
        f = labels.index("fit_codec>")
        e = labels.index("encode_residuals>")
        w = labels.index("write_index>")
        out.update(assign_all_ms=ms(a, a + 1), assign_sample_ms=ms(b, b + 1),
                   fit_ms=ms(f, f + 1), encode_ms=ms(e, e + 1),
                   copy_out_ms=ms(e + 1, w), write_ms=ms(w, w + 1),
                   total_ms=ms(0, len(ev) - 1))
        return out


def build_bounds(n_tokens: int, n_sample: int, K: int, d: int, nbits: int,
                 peaks) -> dict:
    """The least time of the build's device steps: the larger of their
    fp32 operations over the fp32 peak and the bytes they must move
    (each input read once, each output written once) over HBM. →
    {step: (ms, "operations" | "bytes")}."""
    flops, hbm = peaks

    def least(ops: float, nbytes: float):
        t_ops, t_bytes = ops / flops, nbytes / hbm
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    return {
        # (N, d) · (d, K) and the row max; in: points, centroids; out:
        # ids and sims
        "assign_all": least(2 * n_tokens * K * d,
                            4 * (n_tokens * d + K * d + 2 * n_tokens)),
        # assign on the sample, then the sums; in: sample, centroids;
        # out: centroids
        "lloyd_iteration": least(2 * n_sample * K * d + n_sample * d,
                                 4 * (n_sample * d + 2 * K * d)),
        # in: tokens, their ids, centroids, cutoffs; out: packed codes
        "encode": least(n_tokens * d * (1 + nbits),
                        4 * (n_tokens * d + n_tokens + K * d
                             + 2 ** nbits - 1)
                        + n_tokens * d * nbits // 8)}


def same_index_files(a: pathlib.Path, b: pathlib.Path, what: str,
                     skip=()) -> None:
    for name in INDEX_FILES:
        if name not in skip and (a / name).read_bytes() != \
                (b / name).read_bytes():
            raise AssertionError(f"{what}: {name} differs")


def tie_ids(tokens: np.ndarray, centroids: np.ndarray, a: np.ndarray,
            b: np.ndarray) -> np.ndarray:
    """The tokens whose ids differ between two assignments; each must be
    a tie, its two best sims (fp32, on the CPU) within 1e-6."""
    import torch
    diff = np.nonzero(a != b)[0]
    if len(diff):
        top2 = torch.topk(torch.from_numpy(tokens[diff])
                          @ torch.from_numpy(centroids).T, 2).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        if (gap > 1e-6).any():
            raise AssertionError(f"{int((gap > 1e-6).sum())} ids differ "
                                 "between the card and the CPU without a "
                                 f"tie (largest gap {gap.max()})")
    return diff


def check_pinned(corpus, geometry: pathlib.Path, root: pathlib.Path,
                 device) -> dict:
    """(c): the first ``PINNED_DOCS`` docs built on the card and on the
    CPU, pinned to ``geometry``'s centroids and codec: every file byte
    for byte, except where a token's id differs at a tie (then the ids
    differ only there, and the residual rows only at those tokens)."""
    from repro_torch.index.builder import build_colbert_index
    embs = corpus["doc_embs"][:PINNED_DOCS]
    lens = corpus["doc_lens"][:PINNED_DOCS]
    pin = {n: np.load(geometry / f"{n}.npy")
           for n in ("centroids", "bucket_cutoffs", "bucket_weights")}
    card, host = (build_colbert_index(root / f"pinned_{dev}", embs, lens,
                                      nbits=4, device=dev, **pin)
                  for dev in (device, "cpu"))
    codes = [np.fromfile(p / "codes.bin", np.int32) for p in (card, host)]
    tokens = embs[np.arange(embs.shape[1])[None] < lens[:, None]]
    ties = tie_ids(tokens, pin["centroids"], *codes)
    same_index_files(card, host, "pinned build, card vs CPU",
                     skip=CID_FILES if len(ties) else ())
    if len(ties):
        res = [np.fromfile(p / "residuals.bin", np.uint8).reshape(
            len(codes[0]), -1) for p in (card, host)]
        moved = np.nonzero((res[0] != res[1]).any(axis=1))[0]
        if not np.isin(moved, ties).all():
            raise AssertionError("pinned build: residual rows differ at "
                                 "tokens whose ids agree")
    out = {"docs": PINNED_DOCS, "tokens": len(codes[0]),
           "tie_ids": len(ties), "files_byte_equal": not len(ties)}
    log(f"build (c): pinned card build == CPU build on {PINNED_DOCS} docs "
        f"({len(codes[0])} tokens): {out}")
    return out


def quality(corpus, path: pathlib.Path, methods, device) -> dict:
    """Each method's MRR@10, nDCG@10, R@5, R@50 and S@5 over the
    corpus's queries, served on ``device`` through ``ServeEngine`` at
    the benchmarks' parameters (benchmarks/common.py:51-56)."""
    from repro_torch.core.multistage import (MultiStageParams,
                                             MultiStageRetriever)
    from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
    from repro_torch.eval import metrics
    from repro_torch.index.builder import ColBERTIndex
    from repro_torch.index.splade_index import build_splade_index
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = corpus["cfg"]
    retr = MultiStageRetriever(
        build_splade_index(corpus["doc_term_ids"],
                           corpus["doc_term_weights"], cfg.vocab,
                           cfg.n_docs),
        PLAIDSearcher(ColBERTIndex(path), PlaidParams(
            nprobe=4, candidate_cap=1024, ndocs=256, k=100), device=device),
        MultiStageParams(first_k=200, k=100, alpha=0.3), device=device)
    engine, qrels, out = ServeEngine(retr), corpus["qrels"], {}
    for m in methods:
        reqs = [Request(qid=i, method=m, q_emb=corpus["q_embs"][i],
                        term_ids=corpus["q_term_ids"][i],
                        term_weights=corpus["q_term_weights"][i], k=100)
                for i in range(cfg.n_queries)]
        ranked = np.stack([r.pids for lo in range(0, len(reqs), FULL.B)
                           for r in engine.process_batch(
                               reqs[lo:lo + FULL.B])])
        out[m] = {"MRR@10": metrics.mrr_at_k(ranked, qrels, 10),
                  "nDCG@10": metrics.ndcg_at_k(ranked, qrels, 10),
                  "R@5": metrics.recall_at_k(ranked, qrels, 5),
                  "R@50": metrics.recall_at_k(ranked, qrels, 50),
                  "S@5": metrics.success_at_k(ranked, qrels, 5)}
    return out


def check_quality(root: pathlib.Path, device) -> dict:
    """(d): the in-domain profile built freely on the card and on the
    CPU from one seed; the four methods of the card build served on the
    card, and colbert of the CPU build. The quality benchmark's
    relationships hold (benchmarks/bench_quality.py:67-69), and the
    card build's colbert MRR@10 is within 0.01 of the CPU build's."""
    from repro_torch.data.synth import SynthCfg, make_corpus
    from repro_torch.index.builder import build_colbert_index
    corpus = make_corpus(SynthCfg(**QUALITY_CORPUS))
    dirs = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        dirs[str(dev)] = build_colbert_index(
            root / f"quality_{dev}", corpus["doc_embs"], corpus["doc_lens"],
            nbits=4, kmeans_iters=QUALITY_ITERS, seed=0, device=dev)
        log(f"build (d): in-domain profile built on {dev} in "
            f"{time.perf_counter() - t0:.2f} s")
    card, host = dirs[str(device)], dirs["cpu"]
    codes = [np.fromfile(p / "codes.bin", np.int32) for p in (card, host)]
    agree = float(np.mean(codes[0] == codes[1]))
    q = quality(corpus, card, ("colbert", "splade", "rerank", "hybrid"),
                device)
    q_cpu = quality(corpus, host, ("colbert",), device)
    mrr = {m: r["MRR@10"] for m, r in q.items()}
    log(f"build (d): card build {q}; CPU build colbert {q_cpu['colbert']}; "
        f"cid agreement {agree:.6f}")
    if not (mrr["hybrid"] >= mrr["rerank"] - 0.01
            and mrr["hybrid"] > mrr["splade"]
            and mrr["colbert"] > mrr["splade"]):
        raise AssertionError(f"quality relationships broken: {mrr}")
    gap = abs(mrr["colbert"] - q_cpu["colbert"]["MRR@10"])
    if gap > 0.01:
        raise AssertionError(f"colbert MRR@10 of the card build is {gap} "
                             "from the CPU build's")
    return {"card_build": q, "cpu_build": q_cpu, "cid_agreement": agree,
            "colbert_mrr_gap": gap,
            "tokens": len(codes[0]),
            "n_centroids": int(np.load(card / "centroids.npy").shape[0])}


def built_requests(corpus, n: int, first: int = 0, qid0: int = 0):
    """n requests of the corpus's own queries from ``first``: colbert,
    hybrid and rerank in turn, k ∈ {10, 100}, a quarter with their own
    α."""
    from repro_torch.serving.engine import Request
    methods = ("colbert", "hybrid", "rerank")
    return [Request(qid=qid0 + i, method=methods[i % 3],
                    q_emb=corpus["q_embs"][first + i],
                    term_ids=corpus["q_term_ids"][first + i],
                    term_weights=corpus["q_term_weights"][first + i],
                    k=(10, 100)[(i // 3) % 2],
                    alpha=None if i % 4 else 0.1 + 0.8 * (i % 7) / 6)
            for i in range(n)]


def serve_built(corpus, root: pathlib.Path, s: Shapes, device) -> dict:
    """(e): ``BUILD_REQUESTS`` mixed requests on the card-built index
    through ``RetrievalServer`` at max_batch=B with the fused tail, held
    to the CPU engine on the same directory; the run launches the
    tail's two kernels and no other."""
    from repro_torch.serving.engine import ServeEngine
    counted = counted_kernels()
    retr = make_retriever(root, device)
    reqs = built_requests(corpus, BUILD_REQUESTS)
    warm = built_requests(corpus, 6, first=BUILD_REQUESTS, qid0=40_000)
    results, line = serve_run(ServeEngine(retr), warm, reqs, s.B, counted)
    check_launches("built_index", line["launches"],
                   ("fused_rerank", "decompress_maxsim"))
    routes = hold_to_cpu(ServeEngine(make_retriever(root, "cpu")),
                         {"mmap": retr.searcher},
                         [(r, res, "mmap") for r, res in zip(reqs, results)],
                         s)
    line["tie_routes"] = routes
    log(f"build (e): served {len(reqs)} requests on the card-built index "
        f"at {line['qps']:.1f} QPS; every answer matches the CPU engine "
        f"(tie routes: {routes or 'none'}); launches {line['launches']}")
    return line


def build_phase(seed: int, s: Shapes, root: pathlib.Path, device,
                peaks) -> tuple:
    """Phase 3b (see the module docstring): (a) the free build at full
    width, nbits 4 and 2, each step timed; (b) the nbits=4 build again,
    byte for byte; (c) pinned card == CPU; (d) quality, card and CPU
    builds; (e) serving the card-built index. → (the phase's figures,
    the corpus, which phase 4f serves live)."""
    from repro_torch.data.synth import SynthCfg, make_corpus
    from repro_torch.index.builder import build_colbert_index
    from repro_torch.index.splade_index import build_splade_index

    t0 = time.perf_counter()
    cfg = SynthCfg(**BUILD_CORPUS, seed=seed)
    corpus = make_corpus(cfg)
    embs, lens = corpus["doc_embs"], corpus["doc_lens"]
    n_tokens = int(lens.sum())
    build_splade_index(corpus["doc_term_ids"], corpus["doc_term_weights"],
                       cfg.vocab, cfg.n_docs).save(root / "splade")
    out = {"corpus": dict(BUILD_CORPUS, seed=seed, tokens=n_tokens),
           "corpus_s": time.perf_counter() - t0, "builds": {}}
    log(f"build (a): corpus of {cfg.n_docs} docs, {n_tokens} tokens in "
        f"{out['corpus_s']:.1f} s")

    # the first build pays the card's first calls (cuBLAS, the sort);
    # the repeat of (b) is timed too
    for nbits, name, label in ((4, "colbert", "nbits4"),
                               (2, "nbits2", "nbits2"),
                               (4, "again", "nbits4_again")):
        with BuildSteps() as steps:
            build_colbert_index(root / name, embs, lens, nbits=nbits,
                                seed=seed, device=device)
        meta = json.loads((root / name / "meta.json").read_text())
        K = meta["n_centroids"]
        n_sample = min(65536, n_tokens)
        bounds = build_bounds(n_tokens, n_sample, K, cfg.dim, nbits, peaks)
        out["builds"][label] = {
            "nbits": nbits, "n_centroids": K, "sample": n_sample,
            "steps": steps.steps(),
            "bounds": {k: {"ms": v[0], "bound_by": v[1]}
                       for k, v in bounds.items()}}
        log(f"build (a): {label}, K={K}: {out['builds'][label]}")

    same_index_files(root / "colbert", root / "again",
                     "two card builds from one seed")
    out["reproducible"] = True
    log("build (b): a second card build from the same seed writes the "
        "same bytes in every file")

    out["pinned"] = check_pinned(corpus, root / "colbert", root, device)
    out["quality"] = check_quality(root, device)
    out["serve"] = serve_built(corpus, root, s, device)
    return out, corpus


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """CUDA-event ms per call of ``fn`` with the host's enqueue taken out:
    ``iters`` calls captured in one CUDA graph, replayed ``reps`` times.
    An eager loop of a kernel that is shorter than its wrapper's Python
    times the host, not the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(x: dict, s: Shapes, peaks, fused: bool) -> tuple[float, str]:
    """The least time the card could take: bytes the function must move
    (each input read once, each output written once; packed codes and
    ids only of the valid tokens of the candidates it scores, centroid
    rows only those those tokens use) over the memory rate, against the
    FLOPs (2·d per real query token per scored doc token) over the fp32
    peak."""
    import torch
    flops_peak, bw_peak = peaks
    scored = x["valid"] & x["cmask"][..., None] if fused else x["valid"]
    n_tok = scored.sum(dim=(1, 2)).double()                  # (B,)
    q_real = x["q_valid"].sum(dim=1).double()
    n_cent = torch.unique(x["cids"][scored]).numel()
    pd = x["packed"].shape[-1]
    B, C = x["cmask"].shape
    n_bytes = (n_tok.sum().item() * (pd + 4) + x["valid"].numel()
               + x["q"].numel() * 4 + x["q_valid"].numel()
               + n_cent * s.d * 4 + x["bw"].numel() * 4)
    n_bytes += B * C + B * 100 * 8 if fused else B * C * 4
    flops = (n_tok * q_real).sum().item() * 2 * s.d
    t_bytes, t_ops = n_bytes / bw_peak, flops / flops_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rows_of(x: dict, b: int) -> dict:
    """Batch row ``b`` of the tile inputs as a batch of one (the tables
    stay whole)."""
    return {k: v if k in ("centroids", "bw") else v[b:b + 1]
            for k, v in x.items()}


def splade_bound(cache, rows, w, peaks, k: int | None = None
                 ) -> tuple[float, str]:
    """Bytes: the real postings of the queried rows (4-byte pid and
    1-byte impact each, padding not counted), the (rows, weights) slots
    and the function's output: the (B, n_docs) f32 scores, or with ``k``
    the (B, k) pids and scores, 8 bytes a place (the launch's per-block
    candidates are its own intermediate); operations: one multiply and
    one add per real posting, at the fp32 peak."""
    flops_peak, bw_peak = peaks
    live = (rows >= 0) & (w > 0)
    r = rows[live].long()
    entries = (cache.pids[r] >= 0).sum().item()
    B = rows.shape[0]
    written = B * (cache.n_docs * 4 if k is None else k * 8)
    n_bytes = entries * 5 + rows.numel() * 8 + written
    t_bytes, t_ops = n_bytes / bw_peak, 2 * entries / flops_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def maxsim_bound(x: dict, s: Shapes, peaks) -> tuple[float, str]:
    """Bytes: the fp32 rows of the valid doc tokens, the valid flags,
    the query and its flags, the (B, C) output; operations: 2·d FLOPs
    per (real query token, valid doc token) pair, at the fp32 peak."""
    flops_peak, bw_peak = peaks
    n_tok = x["valid"].sum(dim=(1, 2)).double()
    q_real = x["q_valid"].sum(dim=1).double()
    B, C = x["valid"].shape[:2]
    n_bytes = (n_tok.sum().item() * s.d * 4 + x["valid"].numel()
               + x["q"].numel() * 4 + x["q_valid"].numel() + B * C * 4)
    flops = (n_tok * q_real).sum().item() * 2 * s.d
    t_bytes, t_ops = n_bytes / bw_peak, flops / flops_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host-clock ms of ``fn`` followed by a device synchronize, the mean
    over ``iters`` calls after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def stage1_breakdown(cache, tids, tw, k: int) -> dict:
    """One device stage-1 dispatch of ``cache.score_topk`` in its parts:
    padding and scaling on the host, the host-to-device copy (host
    clock, synchronized), the top-k launch, which selects and merges on
    the card (CUDA events: eager, and by graph replay for its device
    time), the device-to-host copy, and the whole dispatch (host clock,
    synchronized). ``select_full_ms`` times what the selection was
    before the top-k launch: one stable sort of the (B, n_docs) scores
    of the scores launch."""
    from repro_torch.kernels.fused_rerank.ref import stable_topk
    from repro_torch.kernels.splade_score.ops import (splade_row_scores_batch,
                                                      splade_row_topk_packed)

    def host():
        return cache.scaled_weights(*cache.pad_queries(tids, tw))

    rows_np, w_np = host()
    rows, w = cache.upload(rows_np, w_np)
    k_eff = min(k, cache.n_docs)
    args = (cache.row_pids, cache.row_imps, rows, w)

    def kernel():
        return splade_row_topk_packed(*args, n_docs=cache.n_docs, k=k_eff)

    packed = kernel()
    scores = splade_row_scores_batch(*args, n_docs=cache.n_docs)
    return {"B": len(tids), "k": k,
            "host_ms": wall_ms(host),
            "h2d_ms": wall_ms(lambda: cache.upload(rows_np, w_np)),
            "kernel_ms": cuda_time_ms(kernel, 20),
            "kernel_graph_ms": graph_time_ms(kernel),
            "d2h_ms": wall_ms(lambda: cache.finalize_topk(
                (packed, k_eff, len(tids), k))),
            "dispatch_ms": wall_ms(lambda: cache.score_topk(tids, tw, k)),
            "select_full_ms": cuda_time_ms(
                lambda: stable_topk(scores, k_eff), 20)}


def tile_fns(x: dict, fused: bool) -> dict:
    """The rerank tail's kernel on tile inputs ``x`` (nbits=4, k=100)
    and its plain version, as timing closures."""
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.decompress_maxsim.ref import (
        decompress_maxsim_ref)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk_batch as frk)
    from repro_torch.kernels.fused_rerank.ref import fused_rerank_ref

    t = (x["q"], x["packed"], x["cids"], x["valid"])
    tables = (x["centroids"], x["bw"])
    if fused:
        return {
            "ms": lambda: frk(*t, x["cmask"], *tables, nbits=4, k=100,
                              q_valid=x["q_valid"]),
            "plain": lambda: fused_rerank_ref(*t, x["cmask"], *tables, 4,
                                              100, x["q_valid"])}
    return {"ms": lambda: dms(*t, *tables, nbits=4, q_valid=x["q_valid"]),
            "plain": lambda: decompress_maxsim_ref(*t, *tables, 4,
                                                   x["q_valid"])}


def tail_errors(x: dict) -> dict:
    """The rerank tail's two kernels against their plain versions on tile
    inputs ``x`` (nbits=4, k=100): scores allclose, the fused top-k's ids
    equal up to tie groups. → the largest |kernel - plain| per kernel."""
    import torch
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.decompress_maxsim.ref import (
        decompress_maxsim_ref)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk_batch as frk)
    from repro_torch.kernels.fused_rerank.ref import fused_rerank_ref
    from repro_torch.testing import ATOL, REF_MARGIN, RTOL, assert_topk_match

    t = (x["q"], x["packed"], x["cids"], x["valid"])
    tables = (x["centroids"], x["bw"])
    got = dms(*t, *tables, nbits=4, q_valid=x["q_valid"])
    want = decompress_maxsim_ref(*t, *tables, 4, x["q_valid"])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL,
                               err_msg="decompress_maxsim")
    vals, idx = frk(*t, x["cmask"], *tables, nbits=4, k=100,
                    q_valid=x["q_valid"])
    wv, wi = fused_rerank_ref(*t, x["cmask"], *tables, 4, 100 + REF_MARGIN,
                              x["q_valid"])
    assert_topk_match(wv.cpu().numpy(), wi.cpu().numpy(), vals.cpu().numpy(),
                      idx.cpu().numpy(), what="fused_rerank")
    fin = torch.isfinite(wv[:, :100])
    return {"decompress_maxsim": (got - want).abs().max().item(),
            "fused_rerank": (vals[fin] - wv[:, :100][fin]).abs().max().item()}


def measure(fns, bound_fn, library=None, graph=False) -> dict:
    """Time ``fns["ms"]`` (and ``fns["plain"]``, where given, and
    ``library``) in turns — plain, kernel, library, library, kernel,
    plain — so that drift on the card does not favour one of them; each
    number is the mean of its two turns, both turns are kept. ``ms`` and
    ``library_ms`` are eager loops, every kernel's yardstick; with
    ``graph`` the kernel and the library call are also timed by
    CUDA-graph replay (graph_ms, library_graph_ms: their device time
    without the host's enqueue)."""
    order = ([("plain_ms", fns["plain"], cuda_time_ms, 10)]
             if "plain" in fns else [])
    timed = [("ms", fns["ms"])]
    if library is not None:
        timed.append(("library_ms", library))
    for name, fn in timed:
        order.append((name, fn, cuda_time_ms, 20))
        if graph:
            order.append((name.replace("ms", "graph_ms"), fn,
                          graph_time_ms, 20))
    turns = {name: [] for name, _, _, _ in order}
    for name, fn, timer, iters in order + order[::-1]:
        turns[name].append(timer(fn, iters))
    out = {name: sum(t) / len(t) for name, t in turns.items()}
    out.setdefault("library_ms", None)
    return dict(out, turns=turns, bound=bound_fn())


def time_kernels(rng, s: Shapes, device, peaks, path: pathlib.Path,
                 topics: np.ndarray, seed: int) -> dict:
    """CUDA-event times of each kernel, its plain version and (where one
    PyTorch call computes the same function) that call, at the serve
    shapes (batch) and for one query of them (b1)."""
    import torch
    from repro_torch.index.splade_device import SpladeDeviceCache
    from repro_torch.index.splade_index import SpladeIndex
    from repro_torch.kernels.maxsim.ops import maxsim_scores_batch
    from repro_torch.kernels.maxsim.ref import maxsim_scores_ref
    from repro_torch.kernels.fused_rerank.ref import stable_topk
    from repro_torch.kernels.splade_score.ops import (splade_row_scores_batch,
                                                      splade_row_topk_batch)
    from repro_torch.kernels.splade_score.ref import (
        splade_row_scores_batch_ref)

    out = {}
    x = to_dev(kernel_inputs(rng, s, 4), device)
    x1 = rows_of(x, 3)
    out["decompress_maxsim"] = {
        "batch": measure(tile_fns(x, False), lambda: bound(x, s, peaks, False),
                         graph=True),
        "b1": measure(tile_fns(x1, False), lambda: bound(x1, s, peaks, False),
                      graph=True)}
    out["fused_rerank"] = {
        "batch": measure(tile_fns(x, True), lambda: bound(x, s, peaks, True),
                         graph=True),
        "b1": measure(tile_fns(x1, True), lambda: bound(x1, s, peaks, True),
                      graph=True)}
    del x, x1

    m = maxsim_inputs(sub_rng(seed, "maxsim timing"), s, device)
    m1 = rows_of(m, 3)

    def maxsim_fns(m):
        args = (m["q"], m["emb"], m["valid"], m["q_valid"])
        return {"ms": lambda: maxsim_scores_batch(*args),
                "plain": lambda: maxsim_scores_ref(*args)}

    out["maxsim"] = {
        "batch": measure(maxsim_fns(m), lambda: maxsim_bound(m, s, peaks),
                         graph=True),
        "b1": measure(maxsim_fns(m1), lambda: maxsim_bound(m1, s, peaks),
                      graph=True)}
    del m, m1

    cache = SpladeDeviceCache(SpladeIndex.load(path / "splade", mmap=True),
                              device=device)
    srng = sub_rng(seed, "splade timing")
    rows, w = kernel_rows(cache, *topic_terms(srng, topics, s.B,
                                              s.query_terms))

    def splade_fns(rows, w):
        args = (cache.row_pids, cache.row_imps, rows, w)
        # the single PyTorch call that computes the same function: one
        # index_add_ of the masked entries into the flattened scores
        B = rows.shape[0]
        live = (rows >= 0) & (w > 0)
        safe = torch.where(live, rows, 0).long()
        pids = cache.pids[safe].long()
        keep = live[..., None] & (pids >= 0)
        target = (torch.arange(B, device=device).view(B, 1, 1)
                  * cache.n_docs + pids)[keep]
        vals = (w[..., None] * cache.imps[safe].float())[keep]
        scores = torch.zeros(B * cache.n_docs, device=device)
        return ({"ms": lambda: splade_row_scores_batch(
                    *args, n_docs=cache.n_docs),
                 "plain": lambda: splade_row_scores_batch_ref(
                    *args, cache.n_docs)},
                lambda: scores.index_add_(0, target, vals))

    stids, stw = (list(a) for a in topic_terms(
        sub_rng(seed, "splade breakdown"), topics, s.B, s.query_terms))
    out["stage1"] = {"batch": stage1_breakdown(cache, stids, stw, s.C),
                     "b1": stage1_breakdown(cache, stids[:1], stw[:1], s.C)}
    log(f"stage-1 breakdown: {out['stage1']}")
    fns, lib = splade_fns(rows, w)
    fns1, lib1 = splade_fns(rows[2:3], w[2:3])
    out["splade_score"] = {
        "batch": measure(fns, lambda: splade_bound(cache, rows, w, peaks),
                         library=lib, graph=True),
        "b1": measure(fns1, lambda: splade_bound(cache, rows[2:3], w[2:3],
                                                 peaks), library=lib1,
                      graph=True)}

    def topk_fns(rows, w):
        # the top-k launch (per-block candidates and their merge); its
        # plain version: the scores and one stable sort of them; no
        # single PyTorch call does either
        args = (cache.row_pids, cache.row_imps, rows, w)
        kw = dict(n_docs=cache.n_docs, k=s.C)
        return {"ms": lambda: splade_row_topk_batch(*args, **kw),
                "plain": lambda: stable_topk(splade_row_scores_batch_ref(
                    *args, cache.n_docs), s.C)}

    out["splade_topk"] = {
        at: measure(topk_fns(r, ww), lambda r=r, ww=ww: splade_bound(
            cache, r, ww, peaks, s.C), graph=True)
        for at, (r, ww) in (("batch", (rows, w)),
                            ("b1", (rows[2:3], w[2:3])))}
    return out


def time_colbert(rng, s: Shapes, device, peaks, path: pathlib.Path) -> dict:
    """One colbert batch at the serve_plaid shape in its device parts —
    the probe's matmul, its top-nprobe selection, stage 2, stage 3 — and
    the exact tail's two kernels on the batch's real survivors (C =
    ndocs; fused_rerank also for one of its queries, B=1), each eager and
    by CUDA-graph replay, against its bound; the tail's kernels also
    held to their plain versions on those survivors (``max_abs_err``)."""
    import torch
    from repro_torch.core.plaid import (stage2_candidates_batch,
                                        stage3_approx_score_batch,
                                        topk_ordered)
    searcher = make_searcher(path, device)
    p = searcher.params
    st = searcher.probe_batch([unit(rng.normal(size=(s.Lq, s.d)))
                               for _ in range(s.B)])
    q2, cent = st["q"].reshape(-1, s.d), searcher.centroids
    B, Lq, K, d = s.B, s.Lq, s.K, s.d
    flops_peak, bw_peak = peaks

    def bound_of(n_bytes, ops):
        t_bytes, t_ops = n_bytes / bw_peak, ops / flops_peak
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    out = {"B": B, "Lq": Lq, "K": K, "d": d, "nprobe": p.nprobe,
           "candidate_cap": p.candidate_cap, "ndocs": p.ndocs}
    # bytes: the centroid table, the queries and the (B, Lq, K) scores
    # written once; operations: 2·d per (query token, centroid)
    out["probe_matmul"] = measure(
        {"ms": lambda: torch.matmul(q2, cent.T)},
        lambda: bound_of((K * d + B * Lq * d + B * Lq * K) * 4,
                         2 * B * Lq * K * d), graph=True)
    # the scores read once, (value, index) pairs written; a compare each
    out["probe_select"] = measure(
        {"ms": lambda: topk_ordered(st["scores_c"], p.nprobe)},
        lambda: bound_of(B * Lq * K * 4 + B * Lq * p.nprobe * 12,
                         B * Lq * K), graph=True)
    P = searcher.ivf_padded.shape[1]
    # the probed ids, their padded lists, the (B, cap) candidates
    out["stage2"] = measure(
        {"ms": lambda: stage2_candidates_batch(searcher.ivf_padded,
                                               st["cids"], p.candidate_cap)},
        lambda: bound_of(B * Lq * p.nprobe * (4 + P * 4)
                         + B * p.candidate_cap * 4, 0), graph=True)
    codes, valid = searcher.to_device(*searcher.gather_codes_batch(
        st["cand"].cpu().numpy()))
    # the scores, the codes and flags read once, (B, C) written; a max
    # per (query token, candidate token)
    out["stage3"] = measure(
        {"ms": lambda: stage3_approx_score_batch(st["scores_c"], codes,
                                                 valid, st["q_valid"])},
        lambda: bound_of(B * Lq * K * 4 + codes.numel() * 5 + B * Lq
                         + B * p.candidate_cap * 4, codes.numel() * Lq),
        graph=True)
    final = searcher.approx_select_batch(st["scores_c"], codes, valid,
                                         st["q_valid"], st["cand"])
    del codes, valid
    f_codes, f_packed, f_valid = searcher.to_device(
        *searcher.gather_tokens_batch(final.cpu().numpy()))
    x = dict(q=st["q"], packed=f_packed, cids=f_codes, valid=f_valid,
             cmask=final >= 0, q_valid=st["q_valid"], centroids=cent,
             bw=searcher.bucket_weights)
    x1 = rows_of(x, 3)
    err, err1 = tail_errors(x), tail_errors(x1)
    out["fused_rerank"] = dict(measure(tile_fns(x, True),
                                       lambda: bound(x, s, peaks, True),
                                       graph=True),
                               max_abs_err=err["fused_rerank"])
    out["decompress_maxsim"] = dict(measure(tile_fns(x, False),
                                            lambda: bound(x, s, peaks, False),
                                            graph=True),
                                    max_abs_err=err["decompress_maxsim"])
    out["fused_rerank_b1"] = dict(measure(tile_fns(x1, True),
                                          lambda: bound(x1, s, peaks, True),
                                          graph=True),
                                  max_abs_err=err1["fused_rerank"])
    log(f"colbert timing: {out}")
    return out


# ---------------------------------------------------------------------------

# each kernel's source and the TPU kernel it replaces
SOURCES = {
    "decompress_maxsim": (
        "src/repro_torch/kernels/csrc/decompress_maxsim.cu",
        "src/repro/kernels/decompress_maxsim/decompress_maxsim.py:132"),
    "fused_rerank": (
        "src/repro_torch/kernels/csrc/fused_rerank.cu",
        "src/repro/kernels/fused_rerank/fused_rerank.py:144"),
    "splade_score": (
        "src/repro_torch/kernels/csrc/splade_score.cu",
        "src/repro/kernels/splade_score/splade_score.py:97"),
    "splade_topk": (
        "src/repro_torch/kernels/csrc/splade_score.cu",
        "src/repro/kernels/splade_score/splade_score.py:97"),
    "maxsim": (
        "src/repro_torch/kernels/csrc/maxsim.cu",
        "src/repro/kernels/maxsim/maxsim.py:83"),
}


def kernel_entries(served: dict, colbert: dict, door: dict, times: dict,
                   ctimes: dict, err: dict, s: Shapes, piped: dict,
                   built: dict, tcp: dict, live: dict, load: dict,
                   launcher: dict, builtin: dict, sharded: dict,
                   shard_kernels: dict, sharded_live: dict,
                   delta: dict) -> list:
    """The ``{"kernels": [...]}`` line's entries: one per main path and
    kernel, with that path's launches from its own run (counts set to 0
    just before it, read just after) and the kernel timed at that path's
    shape: the SPLADE methods served with the device stage 1 (C =
    first_k; every kernel, those off this path at 0 launches), and each
    colbert run's tail kernel on real survivors (C = ndocs); the front
    door's cold mixed batch with the kernels of its path, timed at the
    serve shape; phase 4d's first single-worker run of each workload
    with the kernels of its path; phase 3b's serve on the card-built
    index (``built``: its launches) with the tail's two kernels, timed
    at the serve shape; phase 4e's first TCP turn of each run (``tcp``:
    label → its launches) with the three kernels of its path, timed at
    the serve shape; phase 4f's dirty run on phase 3's index (``live``:
    its launches) with the one kernel of the overlay path, timed at the
    serve shape; phase 4g's first depth-1 open-loop run of each traffic
    (``load``: traffic → its launches) with the kernels of its path, the
    SPLADE methods' timed at the serve shape and colbert's at C =
    ndocs; phase 4h's twin of the launcher at full width (``launcher``:
    path → its launches) with the three kernels of its path, timed at
    the serve shape, and its in-process runs of the max_batch=1 bounded
    load with the host and the device stage 1 (``launcher_b1``,
    ``launcher_b1_device``) with their B=1 kernels, held to their plain
    versions and timed at the built-in corpus's own shapes (``builtin``:
    kernel → its timing dict, C = first_k); phase 4i's run of 4 shards
    with the device stage 1 at depth 1 (``sharded``: its launches) with
    the two kernels of its path, held to their plain versions and timed
    at a shard's shapes (``shard_kernels``: decompress_maxsim at shard
    0's candidate width, the SPLADE top-k entry on its postings); phase
    4j (b)'s first dirty run of 4 shards (``sharded_live``: its
    launches) with decompress_maxsim, the one kernel of a dirty group,
    timed at shard 0's width, and under ``delta`` the coordinator's
    delta launch of that run (its launches, and its time, error and
    bound at the (B, C) that run gave its widest call)."""
    paths = [("serve_device", served["device"][0]["launches"], kname,
              times[kname]["batch"], err[kname], s.C) for kname in SOURCES]
    paths += [("front_door", door, kname, times[kname]["batch"], err[kname],
               s.C) for kname in DOOR_KERNELS]
    paths += [(label, colbert[label]["launches"], kname, ctimes[t_key],
               ctimes[t_key]["max_abs_err"], s.ndocs)
              for label, kname, t_key in (
                  ("colbert", "fused_rerank", "fused_rerank"),
                  ("colbert_split", "decompress_maxsim", "decompress_maxsim"),
                  ("colbert_resident", "fused_rerank", "fused_rerank"),
                  ("colbert_b1", "fused_rerank", "fused_rerank_b1"))]
    single = {name: next(ln for ln in lines if ln["workers"] == "single")
              for name, lines in piped.items()}
    paths += [("pipelined_splade", single["splade"]["launches"], kname,
               times[kname]["batch"], err[kname], s.C)
              for kname in DOOR_KERNELS]
    paths += [(f"pipelined_{name}", single[name]["launches"], "fused_rerank",
               ctimes["fused_rerank"], ctimes["fused_rerank"]["max_abs_err"],
               s.ndocs) for name in ("colbert", "colbert_resident")]
    paths += [("built_index", built, kname, times[kname]["batch"],
               err[kname], s.C) for kname in ("fused_rerank",
                                              "decompress_maxsim")]
    paths += [(label, launches, kname, times[kname]["batch"], err[kname],
               s.C) for label, launches in tcp.items()
              for kname in DOOR_KERNELS]
    paths += [("live", live, "decompress_maxsim",
               times["decompress_maxsim"]["batch"], err["decompress_maxsim"],
               s.C)]
    paths += [("load", load["splade"], kname, times[kname]["batch"],
               err[kname], s.C) for kname in DOOR_KERNELS]
    paths += [("load_colbert", load["colbert"], "fused_rerank",
               ctimes["fused_rerank"], ctimes["fused_rerank"]["max_abs_err"],
               s.ndocs)]
    paths += [("launcher", launcher["launcher"], kname,
               times[kname]["batch"], err[kname], s.C)
              for kname in DOOR_KERNELS]
    paths += [(label, launcher[label], kname, builtin[kname],
               builtin[kname]["max_abs_err"], builtin["shapes"]["C"])
              for label, knames in (
                  ("launcher_b1", ("decompress_maxsim",)),
                  ("launcher_b1_device", ("splade_topk",
                                          "decompress_maxsim")))
              for kname in knames]
    paths += [("sharded", sharded, kname, shard_kernels[kname],
               shard_kernels[kname]["max_abs_err"],
               shard_kernels[kname].get("C", s.C))
              for kname in ("splade_topk", "decompress_maxsim")]
    paths += [("sharded_live", sharded_live, "decompress_maxsim",
               shard_kernels["decompress_maxsim"],
               shard_kernels["decompress_maxsim"]["max_abs_err"],
               shard_kernels["decompress_maxsim"]["C"])]
    out = []
    for path_name, launches, kname, t, max_err, C in paths:
        src, replaces = SOURCES[kname]
        bound_ms, bound_by = t["bound"]
        out.append({
            "name": kname, "path": path_name, "C": C, "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t["library_ms"]})
        if path_name == "sharded_live":
            out[-1]["delta"] = {
                key: delta[key] for key in ("launches", "B", "C", "real",
                                            "max_abs_err", "ms", "plain_ms",
                                            "library_ms")}
            out[-1]["delta"].update(zip(("bound_ms", "bound_by"),
                                        delta["bound"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only "
              "on a GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN: IEEE fp32 throughout")
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    peaks = PEAKS["pcie" if "PCIe" in card else "sxm"]
    rng = np.random.default_rng(args.seed)
    s = FULL

    t_all = t0 = time.perf_counter()
    _build.load()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path().name})")
    ptxas = _build.library_path().with_suffix(".log").read_text()
    for line in ptxas.splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            log("  ptxas: " + line.strip())

    t0 = time.perf_counter()
    err = check_kernels(rng, s, device)
    err["maxsim"] = check_maxsim(sub_rng(args.seed, "maxsim"), s, device)
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = pathlib.Path(tmp)
        t0 = time.perf_counter()
        n_tokens, topics = write_synthetic_index(rng, s, path)
        log(f"phase 3 index: {s.n_docs} docs, {n_tokens} tokens, "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        err.update(check_splade(sub_rng(args.seed, "splade"), s, path,
                                topics, device))
        log(f"phase 3 splade kernel vs plain: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        built, build_corpus = build_phase(args.seed, s, path / "build",
                                          device, peaks)
        log(f"phase 3b build: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        served = serve(rng, s, path, topics, device)
        log(f"phase 4 serve: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        colbert, colbert_stages, colbert_counts = serve_colbert(
            sub_rng(args.seed, "colbert"), s, path, device)
        log(f"phase 4 colbert: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        door, door_launches = front_door(sub_rng(args.seed, "front door"),
                                         s, path, topics, device)
        log(f"phase 4c front door: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        piped = pipelined(sub_rng(args.seed, "pipelined"), s, path, topics,
                          device)
        log(f"phase 4d pipelined: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tcp, tcp_launches = tcp_front(sub_rng(args.seed, "tcp"), s, path,
                                      topics, device)
        log(f"phase 4e tcp front: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        live, live_launches, live_replay = live_phase(
            sub_rng(args.seed, "live"), s, path, topics, build_corpus, device)
        del build_corpus
        log(f"phase 4f live index: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        load, load_launches = load_phase(sub_rng(args.seed, "load"), s, path,
                                         topics, device)
        log(f"phase 4g load: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launcher, launcher_launches = launcher_phase(
            sub_rng(args.seed, "launcher"), s, path, topics, device,
            load[0]["mu_s"], peaks)
        log(f"phase 4h launcher: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sharded, sharded_launches, shard_times = sharded_phase(
            sub_rng(args.seed, "sharded"), s, path, topics, device, peaks)
        log(f"phase 4i sharded: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sharded_live, sharded_live_launches = sharded_live_phase(
            sub_rng(args.seed, "sharded live"), s, path, topics, live_replay,
            device, peaks)
        del live_replay
        log(f"phase 4j sharded live: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        transport = transport_phase(sub_rng(args.seed, "transport"), s, path,
                                    topics, device)
        log(f"phase 4k transport: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        workers = workers_phase(sub_rng(args.seed, "workers"), s, path,
                                topics, device)
        log(f"phase 4l workers: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        times = time_kernels(rng, s, device, peaks, path, topics, args.seed)
        ctimes = time_colbert(sub_rng(args.seed, "colbert timing"), s,
                              device, peaks, path)
        log(f"phase 5 timing: {time.perf_counter() - t0:.1f} s")

    name, limit = (p.strip() for p in card.split(",", 1))
    per_batch = {b: lines[0]["launches_per_batch"]
                 for b, lines in served.items()}
    per_batch.update({b: line["launches_per_batch"]
                      for b, line in colbert.items()})
    for kname in SOURCES:
        for at in ("batch", "b1"):
            t = times[kname][at]
            bound_ms, bound_by = t["bound"]
            print(json.dumps({
                "kernel": kname, "at": at, "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": t["library_ms"],
                "turns_ms": t["turns"],
                **{n: t[n] for n in ("graph_ms", "library_graph_ms")
                   if n in t},
                "launches_per_batch": {b: n[kname]
                                       for b, n in per_batch.items()},
                "shapes": dataclasses.asdict(s) if at == "batch"
                else dict(dataclasses.asdict(s), B=1),
                "card": name, "power_limit": limit}), flush=True)
    kernels = kernel_entries(served, colbert, door_launches, times, ctimes,
                             err, s, piped, built["serve"]["launches"],
                             tcp_launches, live_launches, load_launches,
                             launcher_launches,
                             launcher["bounded"]["b1_kernels"],
                             sharded_launches[4], shard_times,
                             sharded_live_launches,
                             sharded_live["serve"]["delta_kernel"])
    print(json.dumps({"phase": "build", **built, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "stage1_breakdown", **times["stage1"],
                      "card": name, "power_limit": limit}), flush=True)
    for backend, lines in served.items():
        print(json.dumps({"phase": "serve", "splade_backend": backend,
                          "runs": lines, "card": name,
                          "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "serve_colbert", "runs": colbert,
                      "stages_vs_cpu": colbert_stages,
                      "candidates": colbert_counts, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "colbert_timing", **ctimes, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "front_door", **door, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "pipelined", "runs": piped, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "tcp", **tcp, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "live", **live, "card": name,
                      "power_limit": limit}), flush=True)
    for line in load:
        print(json.dumps({"phase": "load", **line, "card": name,
                          "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "launcher", **launcher, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "sharded", **sharded, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "sharded_live", **sharded_live, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "transport", **transport, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "workers", **workers, "card": name,
                      "power_limit": limit}), flush=True)
    log(f"chip_smoke wall, build included: "
        f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
